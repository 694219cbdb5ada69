// Hand-written Hopper kernels for the sketched token bucket's step.
//
// They replace the two Pallas kernels of the JAX package's bucket step
// (ratelimiter_tpu/ops/pallas_sketch.py):
//
//   bucket_estimate  <- bucket_estimate / _bucket_estimate_kernel
//   bucket_update    <- bucket_update / _bucket_update_kernel
//
// The Pallas kernels grid sequentially over the d sketch rows and keep a
// whole (w,) row in VMEM. Here blocks run in parallel and in no order:
// one thread per key walks its rows (estimate); one thread per two cells
// decays the slab densely, then one thread per (key, row) scatters with
// 64-bit atomics (update). The wrappers, their plain PyTorch versions and
// the bounds that limit each kernel are in
// ratelimiter_tpu_torch/ops/bucket_cuda.py.
//
// All arithmetic is int64 and exact: any order gives the reference's
// result. Debt and acc cells are micro-tokens in [0, 2^61]; one step adds
// less than 2^62 to a cell (each admitted request consumes < 2^42 by the
// admission gate, and a batch holds at most 2^20), so no sum overflows.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success). Columns are (h1 + r*h2) & (w-1) in
// uint32 arithmetic; h1/h2 arrive as int64 holding 0..2^32-1. The decay
// arrives by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kCap = 1LL << 61;

__device__ __forceinline__ uint32_t column(const int64_t* h1,
                                           const int64_t* h2, int i, int r,
                                           uint32_t mask) {
  uint32_t a = static_cast<uint32_t>(h1[i]);
  uint32_t b = static_cast<uint32_t>(h2[i]);
  return (a + static_cast<uint32_t>(r) * b) & mask;
}

// One thread per key: walk the d rows in order, min-fold the decayed debt.
__global__ void bucket_estimate_kernel(const long long* __restrict__ debt,
                                       long long decay,
                                       const int64_t* __restrict__ h1,
                                       const int64_t* __restrict__ h2,
                                       long long* __restrict__ est, int B,
                                       int d, int w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t mask = static_cast<uint32_t>(w - 1);
  long long acc = 0;
  for (int r = 0; r < d; ++r) {
    const size_t cell = static_cast<size_t>(r) * w + column(h1, h2, i, r, mask);
    long long e = debt[cell] - decay;
    e = e > 0 ? e : 0;
    acc = (r == 0 || e < acc) ? e : acc;
  }
  est[i] = acc;
}

__device__ __forceinline__ long long decayed(long long x, long long decay) {
  const long long y = x - decay;
  return y <= 0 ? 0 : (y < kCap ? y : kCap);
}

// Dense pass over EVERY cell (the decay reaches untouched cells too), two
// cells per thread, 16-byte accesses: debt = min(max(0, debt - decay), CAP).
// acc is clamped to CAP here as well, but written only where it exceeds
// CAP (no state either package produces does), so it costs reads only.
__global__ void bucket_decay_kernel(longlong2* __restrict__ debt,
                                    longlong2* __restrict__ acc,
                                    long long decay, int n2) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n2) return;
  longlong2 v = debt[k];
  v.x = decayed(v.x, decay);
  v.y = decayed(v.y, decay);
  debt[k] = v;
  const longlong2 a = acc[k];
  if (a.x > kCap || a.y > kCap) {
    acc[k] = make_longlong2(a.x < kCap ? a.x : kCap, a.y < kCap ? a.y : kCap);
  }
}

// Add v (> 0) to a cell holding at most CAP, leaving min(total, CAP) once
// every adder is done. Why this is exact in any order: a cell's value
// only leaves [0, CAP] through an add, and after the first add that takes
// it past CAP it never drops below CAP again (the only other write is a
// min to CAP). So the LAST adder of a cell whose total passes CAP always
// sees its own sum pass CAP and issues the min after every add: the final
// value is CAP. If the total stays within CAP, no adder sees it pass and
// no min is issued. Either way the result is min(x + h, CAP).
__device__ __forceinline__ void add_capped(long long* cell, long long v) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(cell);
  const unsigned long long old =
      atomicAdd(p, static_cast<unsigned long long>(v));
  if (old + static_cast<unsigned long long>(v) >
      static_cast<unsigned long long>(kCap)) {
    atomicMin(p, static_cast<unsigned long long>(kCap));
  }
}

// One thread per (key, row): the histogram of consumed, into debt and acc.
__global__ void bucket_scatter_kernel(long long* __restrict__ debt,
                                      long long* __restrict__ acc,
                                      const int64_t* __restrict__ h1,
                                      const int64_t* __restrict__ h2,
                                      const long long* __restrict__ consumed,
                                      int B, int d, int w) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B * d) return;
  const int i = j / d;
  const int r = j - i * d;
  const long long v = consumed[i];
  if (v == 0) return;
  const size_t cell = static_cast<size_t>(r) * w +
                      column(h1, h2, i, r, static_cast<uint32_t>(w - 1));
  add_capped(debt + cell, v);
  add_capped(acc + cell, v);
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int rl_bucket_estimate(const void* debt, long long decay, const void* h1,
                       const void* h2, void* est, int B, int d, int w,
                       void* stream) {
  if (B > 0) {
    bucket_estimate_kernel<<<blocks_for(B), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(debt), decay,
        static_cast<const int64_t*>(h1), static_cast<const int64_t*>(h2),
        static_cast<long long*>(est), B, d, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int rl_bucket_update(void* debt, void* acc, long long decay, const void* h1,
                     const void* h2, const void* consumed, int B, int d,
                     int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n2 = static_cast<int>(static_cast<long long>(d) * w / 2);
  bucket_decay_kernel<<<blocks_for(n2), kThreads, 0, s>>>(
      static_cast<longlong2*>(debt), static_cast<longlong2*>(acc), decay, n2);
  if (B > 0) {
    bucket_scatter_kernel<<<blocks_for(static_cast<long long>(B) * d),
                            kThreads, 0, s>>>(
        static_cast<long long*>(debt), static_cast<long long*>(acc),
        static_cast<const int64_t*>(h1), static_cast<const int64_t*>(h2),
        static_cast<const long long*>(consumed), B, d, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
