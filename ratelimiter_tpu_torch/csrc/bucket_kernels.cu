// Hand-written Hopper kernels for the sketched token bucket's step.
//
// They replace the two Pallas kernels of the JAX package's bucket step
// (ratelimiter_tpu/ops/pallas_sketch.py):
//
//   bucket_estimate  <- bucket_estimate / _bucket_estimate_kernel
//   bucket_update    <- bucket_update / _bucket_update_kernel
//
// The Pallas kernels grid sequentially over the d sketch rows and keep a
// whole (w,) row in VMEM. Here blocks run in parallel and in no order.
// bucket_estimate: one thread per key walks its rows in order.
// bucket_update: one launch in which each block owns a tile of T cells of
// one row (tile_owner.cuh): it bulk-copies its debt tile into shared
// memory, builds the tile's exact int64 histogram of `consumed` in shared
// memory (two 32-bit halves, native atomics) while the copy is in flight,
// then writes every cell
//   debt = min(min(max(0, debt - decay), CAP) + h, CAP)
// and, only where h != 0, acc = min(min(acc, CAP) + h, CAP). No global
// atomics, no scratch. Bound on an H100: debt read and written at every
// cell (the decay reaches them all), acc at the touched cells and the key
// operands, ~4.4 MB at d=4, w=65536, B=4096, ~1.3 us at 3.35 TB/s; this
// design moves that plus the keys' re-reads from L2 (every cluster reads
// them all). The wrappers, their plain PyTorch versions and the tile
// choice are in ratelimiter_tpu_torch/ops/bucket_cuda.py.
//
// acc is not read densely: every state the step writes holds acc <= CAP,
// and a restored state that does not (only a restore can bring one) is
// clamped once, densely, by a call with clamp_acc set (the limiter marks
// such a restore; the JAX kernel clamps every acc cell on every call).
//
// All arithmetic is int64 and exact: any order gives the reference's
// result. Debt and acc cells are micro-tokens in [0, 2^61]; one step adds
// less than 2^62 to a cell (each admitted request consumes < 2^42 by the
// admission gate, and a batch holds at most 2^20), so neither a histogram
// entry nor CAP + h overflows.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// the launch's cudaError_t (0 on success). Columns are (h1 + r*h2) & (w-1)
// in uint32 arithmetic; h1/h2 arrive as int64 holding 0..2^32-1. The decay
// arrives by value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_owner.cuh"

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

__device__ __forceinline__ long long capped(long long x) {
  return x < kCap ? x : kCap;
}

// min(min(max(0, x - decay), CAP) + h, CAP) for h in [0, 2^62).
__device__ __forceinline__ long long debt_cell(long long x, long long decay,
                                               unsigned long long h) {
  const long long y = x - decay;
  return capped((y <= 0 ? 0 : capped(y)) + static_cast<long long>(h));
}

__device__ __forceinline__ long long acc_cell(long long a,
                                              unsigned long long h) {
  return capped(capped(a) + static_cast<long long>(h));
}

// Block (k, r) owns cells [k*T, (k+1)*T) of row r. Dynamic shared memory:
// the debt tile (T int64), then the histogram as two uint32 halves, lo[T]
// and hi[T]: 64-bit shared-memory atomics are compare-and-swap loops,
// 32-bit adds are native. A key adds the low word of its amount to lo
// and, to hi, the high word plus 1 when its own add wrapped lo. Each wrap
// of lo is one add's carry, so after every add, hi * 2^32 + lo is the
// exact int64 sum, in any order (hi stays below 2^32: each amount is
// below 2^42 and a batch holds at most 2^20).
template <bool kCluster>
__global__ void __launch_bounds__(rl_tile::kThreads)
    bucket_update_kernel(long long* __restrict__ debt,
                         long long* __restrict__ acc, long long decay,
                         const int64_t* __restrict__ h1,
                         const int64_t* __restrict__ h2,
                         const long long* __restrict__ consumed, int B, int w,
                         int tile_shift, int clamp_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int T = 1 << tile_shift;
  long long* tile = reinterpret_cast<long long*>(smem);
  uint32_t* hist_lo = reinterpret_cast<uint32_t*>(tile + T);
  uint32_t* hist_hi = hist_lo + T;
  const uint32_t r = blockIdx.y;
  const size_t base = static_cast<size_t>(r) * w +
                      static_cast<size_t>(blockIdx.x) * T;

  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(T) * 8;
    rl_tile::mbar_init(&bar);
    rl_tile::mbar_expect_tx(&bar, bytes);
    rl_tile::bulk_load(tile, debt + base, bytes, &bar);
  }
  for (int j = threadIdx.x; j < T / 2; j += blockDim.x)
    reinterpret_cast<uint4*>(hist_lo)[j] = make_uint4(0, 0, 0, 0);
  rl_tile::arrive_owners<kCluster>();

  // Key scan while the tile is in flight.
  rl_tile::scan_keys<kCluster>(
      h1, h2, consumed, B, r, w, tile_shift, [&](uint32_t off, long long c) {
        if (c == 0) return;
        const unsigned long long v = static_cast<unsigned long long>(c);
        const uint32_t v_lo = static_cast<uint32_t>(v);
        const uint32_t v_hi = static_cast<uint32_t>(v >> 32);
        const uint32_t old = atomicAdd(
            rl_tile::owner_entry<kCluster>(hist_lo, off, tile_shift), v_lo);
        const uint32_t carry = old + v_lo < old ? 1u : 0u;
        if (v_hi + carry != 0) {
          atomicAdd(rl_tile::owner_entry<kCluster>(hist_hi, off, tile_shift),
                    v_hi + carry);
        }
      });
  rl_tile::tile_arrived(&bar);
  rl_tile::sync_owners<kCluster>();

  // Dense pass over EVERY cell of the tile: the decay reaches untouched
  // cells too. Two cells per thread and step, 16-byte stores.
  longlong2* out = reinterpret_cast<longlong2*>(debt + base);
  longlong2* acc2 = reinterpret_cast<longlong2*>(acc + base);
  for (int j = threadIdx.x; j < T / 2; j += blockDim.x) {
    longlong2 x = reinterpret_cast<const longlong2*>(tile)[j];
    const uint2 lo = reinterpret_cast<const uint2*>(hist_lo)[j];
    const uint2 hi = reinterpret_cast<const uint2*>(hist_hi)[j];
    const unsigned long long hx =
        (static_cast<unsigned long long>(hi.x) << 32) | lo.x;
    const unsigned long long hy =
        (static_cast<unsigned long long>(hi.y) << 32) | lo.y;
    x.x = debt_cell(x.x, decay, hx);
    x.y = debt_cell(x.y, decay, hy);
    out[j] = x;
    if (clamp_acc) {
      longlong2 a = acc2[j];
      a.x = acc_cell(a.x, hx);
      a.y = acc_cell(a.y, hy);
      acc2[j] = a;
    } else {
      long long* a = acc + base + 2 * j;
      if (hx != 0) a[0] = acc_cell(a[0], hx);
      if (hy != 0) a[1] = acc_cell(a[1], hy);
    }
  }
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

// One launch of (w / tile, d) blocks in clusters of `cluster` tiles; runs
// its dense pass when B == 0 too. clamp_acc != 0 clamps every acc cell.
int rl_bucket_update(void* debt, void* acc, long long decay, const void* h1,
                     const void* h2, const void* consumed, int B, int d,
                     int w, int tile, int cluster, int clamp_acc,
                     void* stream) {
  if (!rl_tile::valid_tiling(d, w, tile, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile) * 16;
  auto kernel = cluster > 1 ? bucket_update_kernel<true>
                            : bucket_update_kernel<false>;
  return static_cast<int>(rl_tile::launch_tiles(
      kernel, d, w, tile, cluster, smem, static_cast<cudaStream_t>(stream),
      static_cast<long long*>(debt), static_cast<long long*>(acc), decay,
      static_cast<const int64_t*>(h1), static_cast<const int64_t*>(h2),
      static_cast<const long long*>(consumed), B, w,
      rl_tile::tile_shift_of(tile), clamp_acc));
}

}  // extern "C"
