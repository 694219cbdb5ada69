// Hand-written Hopper kernels for the windowed count-min sketch step.
//
// They replace the three Pallas kernels of the JAX package's decision step
// (ratelimiter_tpu/ops/pallas_sketch.py):
//
//   window_estimate  <- window_estimate / _window_estimate_kernel
//   cu_update        <- cu_update / _cu_update_kernel
//   add_update       <- add_update / _add_update_kernel
//
// The Pallas kernels grid sequentially over the d sketch rows and keep a
// whole (w,) row in VMEM. Here blocks run in parallel and in no order, so
// each kernel is re-cut for that: one thread per key (estimate), one
// thread per (key, row) with atomics (the two scatters), one thread per
// four cells (the dense conservative-update pass). The wrappers, their
// plain PyTorch versions and the bounds that limit each kernel are in
// ratelimiter_tpu_torch/ops/sketch_cuda.py.
//
// Rounding: the JAX reference computes the boundary-weighted window read
// t + frac * b as ONE fused multiply-add (XLA contracts it when jitting on
// the CPU). The kernels spell it __fmaf_rn(frac, b, t), and the library is
// built with -fmad=false so that nvcc contracts nothing else.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success). Columns are (h1 + r*h2) & (w-1) in
// uint32 arithmetic; h1/h2 arrive as int64 holding 0..2^32-1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t column(const int64_t* h1,
                                           const int64_t* h2, int i, int r,
                                           uint32_t mask) {
  uint32_t a = static_cast<uint32_t>(h1[i]);
  uint32_t b = static_cast<uint32_t>(h2[i]);
  return (a + static_cast<uint32_t>(r) * b) & mask;
}

// One thread per key: walk the d rows in order, min-fold the window read.
__global__ void window_estimate_kernel(const int32_t* __restrict__ totals,
                                       const int32_t* __restrict__ boundary,
                                       const float* __restrict__ frac_ptr,
                                       const int64_t* __restrict__ h1,
                                       const int64_t* __restrict__ h2,
                                       float* __restrict__ est, int B, int d,
                                       int w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t mask = static_cast<uint32_t>(w - 1);
  const float frac = boundary != nullptr ? *frac_ptr : 0.0f;
  float acc = 0.0f;
  for (int r = 0; r < d; ++r) {
    const size_t cell = static_cast<size_t>(r) * w + column(h1, h2, i, r, mask);
    const float t = static_cast<float>(totals[cell]);
    const float e = boundary != nullptr
                        ? __fmaf_rn(frac, static_cast<float>(boundary[cell]), t)
                        : t;
    acc = r == 0 ? e : fminf(acc, e);
  }
  est[i] = acc;
}

// One thread per (key, row): per-column max of the targets into m, which
// the caller zeroed. Targets are >= 0, so the int order of their bit
// patterns is the float order; zeros (denied requests, padding, and any
// -0.0) are skipped, since m already holds +0.0.
__global__ void cu_scatter_max_kernel(const float* __restrict__ target,
                                      const int64_t* __restrict__ h1,
                                      const int64_t* __restrict__ h2,
                                      int* __restrict__ m_bits, int B, int d,
                                      int w) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B * d) return;
  const int i = j / d;
  const int r = j - i * d;
  const float v = target[i];
  if (!(v > 0.0f)) return;
  const uint32_t c = column(h1, h2, i, r, static_cast<uint32_t>(w - 1));
  atomicMax(m_bits + static_cast<size_t>(r) * w + c, __float_as_int(v));
}

__device__ __forceinline__ int cu_delta(float m, int32_t t, int32_t b,
                                        float frac, bool weighted) {
  const float tf = static_cast<float>(t);
  const float read = weighted ? __fmaf_rn(frac, static_cast<float>(b), tf) : tf;
  return static_cast<int>(ceilf(fmaxf(m - read, 0.0f)));
}

// Dense pass over EVERY cell (not only the touched ones: after a reset a
// cell may read below zero, and then an untouched cell gets delta > 0,
// exactly as in the reference). Four cells per thread, 16-byte accesses.
__global__ void cu_dense_kernel(int32_t* __restrict__ totals,
                                int32_t* __restrict__ cur,
                                const int32_t* __restrict__ boundary,
                                const float* __restrict__ frac_ptr,
                                const float* __restrict__ m, int n4) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n4) return;
  const bool weighted = boundary != nullptr;
  const float frac = weighted ? *frac_ptr : 0.0f;
  int4 t = reinterpret_cast<const int4*>(totals)[k];
  int4 c = reinterpret_cast<const int4*>(cur)[k];
  const float4 mv = reinterpret_cast<const float4*>(m)[k];
  int4 b = make_int4(0, 0, 0, 0);
  if (weighted) b = reinterpret_cast<const int4*>(boundary)[k];
  const int dx = cu_delta(mv.x, t.x, b.x, frac, weighted);
  const int dy = cu_delta(mv.y, t.y, b.y, frac, weighted);
  const int dz = cu_delta(mv.z, t.z, b.z, frac, weighted);
  const int dw = cu_delta(mv.w, t.w, b.w, frac, weighted);
  t.x += dx; t.y += dy; t.z += dz; t.w += dw;
  c.x += dx; c.y += dy; c.z += dz; c.w += dw;
  reinterpret_cast<int4*>(totals)[k] = t;
  reinterpret_cast<int4*>(cur)[k] = c;
}

// One thread per (key, row): integer scatter-add into totals and cur.
// Integer adds commute, so the atomics equal the reference's histogram.
__global__ void add_update_kernel(int32_t* __restrict__ totals,
                                  int32_t* __restrict__ cur,
                                  const int64_t* __restrict__ h1,
                                  const int64_t* __restrict__ h2,
                                  const int32_t* __restrict__ add, int B,
                                  int d, int w) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B * d) return;
  const int i = j / d;
  const int r = j - i * d;
  const int32_t a = add[i];
  if (a == 0) return;
  const size_t cell = static_cast<size_t>(r) * w +
                      column(h1, h2, i, r, static_cast<uint32_t>(w - 1));
  atomicAdd(totals + cell, a);
  atomicAdd(cur + cell, a);
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int rl_window_estimate(const void* totals, const void* boundary,
                       const void* frac, const void* h1, const void* h2,
                       void* est, int B, int d, int w, void* stream) {
  if (B > 0) {
    window_estimate_kernel<<<blocks_for(B), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(totals),
        static_cast<const int32_t*>(boundary),
        static_cast<const float*>(frac), static_cast<const int64_t*>(h1),
        static_cast<const int64_t*>(h2), static_cast<float*>(est), B, d, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int rl_cu_update(void* totals, void* cur, const void* boundary,
                 const void* frac, const void* h1, const void* h2,
                 const void* target, void* m_scratch, int B, int d, int w,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(d) * w;
  cudaError_t err = cudaMemsetAsync(m_scratch, 0, cells * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    cu_scatter_max_kernel<<<blocks_for(static_cast<long long>(B) * d),
                            kThreads, 0, s>>>(
        static_cast<const float*>(target), static_cast<const int64_t*>(h1),
        static_cast<const int64_t*>(h2), static_cast<int*>(m_scratch), B, d,
        w);
  }
  const int n4 = static_cast<int>(cells / 4);
  cu_dense_kernel<<<blocks_for(n4), kThreads, 0, s>>>(
      static_cast<int32_t*>(totals), static_cast<int32_t*>(cur),
      static_cast<const int32_t*>(boundary), static_cast<const float*>(frac),
      static_cast<const float*>(m_scratch), n4);
  return static_cast<int>(cudaGetLastError());
}

int rl_add_update(void* totals, void* cur, const void* h1, const void* h2,
                  const void* add, int B, int d, int w, void* stream) {
  if (B > 0) {
    add_update_kernel<<<blocks_for(static_cast<long long>(B) * d), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(totals), static_cast<int32_t*>(cur),
        static_cast<const int64_t*>(h1), static_cast<const int64_t*>(h2),
        static_cast<const int32_t*>(add), B, d, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
