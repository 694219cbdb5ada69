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
// thread per (key, row) with atomics (add_update's scatter), and for
// cu_update one launch in which each block owns a tile of T cells of one
// row (tile_owner.cuh): it bulk-copies its totals, cur and boundary tiles
// into shared memory, builds the tile's per-column max of the targets in
// shared memory while the copies are in flight, then writes every cell of
// totals and cur. Bound on an H100 (cu_update): totals and cur read and
// written and boundary read at every cell, 20 bytes a cell, plus the key
// operands, ~5.3 MB at d=4, w=65536, B=4096, ~1.6 us at 3.35 TB/s; this
// design moves that plus the keys' re-reads from L2 (every cluster reads
// them all), and no scratch. The wrappers, their plain PyTorch versions
// and the tile choice are in ratelimiter_tpu_torch/ops/sketch_cuda.py.
//
// Rounding: the JAX reference computes the boundary-weighted window read
// t + frac * b as ONE fused multiply-add (XLA contracts it when jitting on
// the CPU). The kernels spell it __fmaf_rn(frac, b, t), and the library is
// built with -fmad=false so that nvcc contracts nothing else.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// the launch's cudaError_t (0 on success). Columns are (h1 + r*h2) &
// (w-1) in uint32 arithmetic; h1/h2 arrive as int64 holding 0..2^32-1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_owner.cuh"

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

__device__ __forceinline__ int cu_delta(float m, int32_t t, int32_t b,
                                        float frac, bool weighted) {
  const float tf = static_cast<float>(t);
  const float read = weighted ? __fmaf_rn(frac, static_cast<float>(b), tf) : tf;
  return static_cast<int>(ceilf(fmaxf(m - read, 0.0f)));
}

// Block (k, r) owns cells [k*T, (k+1)*T) of row r. Dynamic shared memory:
// the totals, cur and (sliding) boundary tiles, then the histogram of
// per-column max targets as int bits (T each, 4 bytes a cell).
template <bool kCluster>
__global__ void __launch_bounds__(rl_tile::kThreads)
    cu_update_kernel(int32_t* __restrict__ totals, int32_t* __restrict__ cur,
                     const int32_t* __restrict__ boundary,
                     const float* __restrict__ frac_ptr,
                     const int64_t* __restrict__ h1,
                     const int64_t* __restrict__ h2,
                     const float* __restrict__ target, int B, int w,
                     int tile_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int T = 1 << tile_shift;
  const bool weighted = boundary != nullptr;
  int32_t* t_tile = reinterpret_cast<int32_t*>(smem);
  int32_t* c_tile = t_tile + T;
  int32_t* b_tile = c_tile + T;
  int* hist = reinterpret_cast<int*>(b_tile + T);
  const uint32_t r = blockIdx.y;
  const size_t base = static_cast<size_t>(r) * w +
                      static_cast<size_t>(blockIdx.x) * T;

  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(T) * 4;
    rl_tile::mbar_init(&bar);
    rl_tile::mbar_expect_tx(&bar, (weighted ? 3 : 2) * bytes);
    rl_tile::bulk_load(t_tile, totals + base, bytes, &bar);
    rl_tile::bulk_load(c_tile, cur + base, bytes, &bar);
    if (weighted) rl_tile::bulk_load(b_tile, boundary + base, bytes, &bar);
  }
  for (int j = threadIdx.x; j < T / 4; j += blockDim.x)
    reinterpret_cast<int4*>(hist)[j] = make_int4(0, 0, 0, 0);
  rl_tile::arrive_owners<kCluster>();

  // Key scan while the tiles are in flight: per-column max of the targets.
  // Targets are >= 0, so the int order of their bit patterns is the float
  // order; zeros (denied requests, padding, and any -0.0) are skipped,
  // since the histogram already holds +0.0. A key whose target does not
  // beat the entry's current value skips the atomic (entries only grow).
  rl_tile::scan_keys<kCluster>(
      h1, h2, target, B, r, w, tile_shift, [&](uint32_t off, float v) {
        if (!(v > 0.0f)) return;
        int* e = rl_tile::owner_entry<kCluster>(hist, off, tile_shift);
        const int bits = __float_as_int(v);
        if (bits > *reinterpret_cast<volatile int*>(e)) atomicMax(e, bits);
      });
  rl_tile::tile_arrived(&bar);
  rl_tile::sync_owners<kCluster>();

  // Dense pass over EVERY cell of the tile (not only the touched ones:
  // after a reset a cell may read below zero, and then an untouched cell
  // gets delta > 0, exactly as in the reference). Four cells per thread
  // and step, 16-byte stores.
  const float frac = weighted ? *frac_ptr : 0.0f;
  int4* t_out = reinterpret_cast<int4*>(totals + base);
  int4* c_out = reinterpret_cast<int4*>(cur + base);
  for (int j = threadIdx.x; j < T / 4; j += blockDim.x) {
    int4 t = reinterpret_cast<const int4*>(t_tile)[j];
    int4 c = reinterpret_cast<const int4*>(c_tile)[j];
    const int4 m = reinterpret_cast<const int4*>(hist)[j];
    int4 b = make_int4(0, 0, 0, 0);
    if (weighted) b = reinterpret_cast<const int4*>(b_tile)[j];
    const int dx = cu_delta(__int_as_float(m.x), t.x, b.x, frac, weighted);
    const int dy = cu_delta(__int_as_float(m.y), t.y, b.y, frac, weighted);
    const int dz = cu_delta(__int_as_float(m.z), t.z, b.z, frac, weighted);
    const int dw = cu_delta(__int_as_float(m.w), t.w, b.w, frac, weighted);
    t.x += dx; t.y += dy; t.z += dz; t.w += dw;
    c.x += dx; c.y += dy; c.z += dz; c.w += dw;
    t_out[j] = t;
    c_out[j] = c;
  }
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

// One launch of (w / tile, d) blocks in clusters of `cluster` tiles; runs
// its dense pass when B == 0 too. boundary == nullptr: fixed window.
int rl_cu_update(void* totals, void* cur, const void* boundary,
                 const void* frac, const void* h1, const void* h2,
                 const void* target, int B, int d, int w, int tile,
                 int cluster, void* stream) {
  if (!rl_tile::valid_tiling(d, w, tile, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile) * 16;
  auto kernel = cluster > 1 ? cu_update_kernel<true> : cu_update_kernel<false>;
  return static_cast<int>(rl_tile::launch_tiles(
      kernel, d, w, tile, cluster, smem, static_cast<cudaStream_t>(stream),
      static_cast<int32_t*>(totals), static_cast<int32_t*>(cur),
      static_cast<const int32_t*>(boundary), static_cast<const float*>(frac),
      static_cast<const int64_t*>(h1), static_cast<const int64_t*>(h2),
      static_cast<const float*>(target), B, w, rl_tile::tile_shift_of(tile)));
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
