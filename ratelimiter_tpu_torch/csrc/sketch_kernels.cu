// Hand-written Hopper kernels for the windowed count-min sketch step.
//
// They replace the three Pallas kernels of the JAX package's decision step
// (ratelimiter_tpu/ops/pallas_sketch.py), and the step's ops around them:
//
//   window_front     <- window_estimate / _window_estimate_kernel, with
//                       the step's hashing, boundary weight, policy lookup
//                       and available quota around it
//   cu_update        <- cu_update / _cu_update_kernel
//   add_back         <- add_update / _add_update_kernel, with the step's
//                       admission (ops/segment.admit), add amounts and
//                       remaining around it: the vanilla step's back
//   add_update       <- add_update / _add_update_kernel alone (the reset,
//                       and batches above the admission capacity)
//   window_admit     <- the CU step's admission, targets and remaining
//                       (ahead of cu_update; replaces no TPU kernel)
//
// The Pallas kernels grid sequentially over the d sketch rows and keep a
// whole (w,) row in VMEM. Here blocks run in parallel and in no order, so
// each kernel is re-cut for that. window_front: one thread per key
// (front.cuh) hashes it, issues its 2*d cell loads (totals and boundary),
// searches the policy table while they are in flight, folds the min over
// rows in row order and writes est, avail and n_f. It needs ~0.25 MB at
// B=4096, d=4 (bound ~0.07 us at 3.35 TB/s), so it is launch-bound, and
// its design is about the launches it saves: the estimate alone used to
// be one of ~50 launches that fed admission. add_back and window_admit:
// ONE block holds the whole batch and runs the admission routine
// (admit.cuh: keys to group ids through a shared-memory hash table, a
// block radix sort of the ids, then iters + 2 segmented block scans),
// then an epilogue in batch order (coalesced) that writes the results;
// add_back also scatter-adds the admitted amounts into totals and cur with
// global atomics, one per run of one (h1, h2) in the sorted batch, row and
// slab, carrying the run's admitted total (integer adds commute, so any
// order gives the reference's histogram; at 4096 keys over 65536 columns
// a shared-memory histogram would not help). Their bound is ~0.2 MB at
// B=4096 (~0.06 us), far below one launch: the design replaces the ~85
// launches of the plain admission and epilogue with one, on one SM.
// add_update: one thread per (key, row) with atomics. cu_update: one
// launch in which each block owns a tile of T cells of one row
// (tile_owner.cuh): it bulk-copies its totals, cur and boundary tiles into
// shared memory, builds the tile's per-column max of the targets in
// shared memory while the copies are in flight, then writes every cell of
// totals and cur. Bound on an H100 (cu_update): totals and cur read and
// written and boundary read at every cell, 20 bytes a cell, plus the key
// operands, ~5.3 MB at d=4, w=65536, B=4096, ~1.6 us at 3.35 TB/s; this
// design moves that plus the keys' re-reads from L2 (every cluster reads
// them all), and no scratch. The wrappers, their plain PyTorch versions
// and the launch shapes are in ratelimiter_tpu_torch/ops/sketch_cuda.py.
//
// Rounding: the JAX reference computes the boundary-weighted window read
// t + frac * b as ONE fused multiply-add (XLA contracts it when jitting on
// the CPU), and frac = clip(1 - e/sub_us, 0, 1) as clip(fma(-e, rcp, 1))
// with rcp the f32 reciprocal of sub_us. The kernels spell both with
// __fmaf_rn, and the library is built with -fmad=false so that nvcc
// contracts nothing else: the CU target (est + (avail - seen)) + n_f and
// remaining floor(seen - used) are separate f32 roundings, as in the
// reference (ratelimiter_tpu/ops/sketch_kernels.py:432,534-535).
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// the launch's cudaError_t (0 on success). Columns are (h1 + r*h2) &
// (w-1) in uint32 arithmetic; h1/h2 are int64 holding 0..2^32-1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "front.cuh"
#include "tile_owner.cuh"

namespace {

constexpr int kThreads = 256;

struct WindowFront {
  const int32_t* totals;
  const int32_t* boundary;       // nullptr: fixed window
  const long long* slab_period;  // the boundary is valid when
  long long want;                // slab_period[slot] == want (p - SW)
  int slot;                      // p % S
  float e;                       // f32(now_us - p*sub_us)
  float rcp;                     // f32(1) / f32(sub_us)
  rl_front::Keys keys;
  const int32_t* n;              // nullptr: est and frac only (the reset)
  rl_front::Policy policy;
  float* est;                    // clamped at 0
  float* frac;                   // 0-d; written with a boundary
  float* avail;
  float* n_f;
  int B, d, w;
};

// clip(1 - e/sub_us, 0, 1) as XLA computes it, when the boundary slab
// holds period p - SW (``held``); 0 when it is stale.
__device__ __forceinline__ float boundary_weight(const WindowFront& a,
                                                 long long held) {
  const float f = fminf(fmaxf(__fmaf_rn(-a.e, a.rcp, 1.0f), 0.0f), 1.0f);
  return held == a.want ? f : 0.0f;
}

template <int kTable, int kDepth>
__global__ void __launch_bounds__(rl_front::kMaxThreads)
    window_front_kernel(const WindowFront a) {
  constexpr int kRows = kDepth != 0 ? kDepth : rl_front::kMaxDepth;
  extern __shared__ __align__(16) long long table[];
  __shared__ __align__(8) uint64_t bar;
  const long long* keys = rl_front::stage_table<kTable>(a.policy, table, &bar);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool weighted = a.boundary != nullptr;
  if (i >= a.B) {
    // B = 0: thread 0 still writes frac.
    if (i == 0 && weighted)
      *a.frac = boundary_weight(a, a.slab_period[a.slot]);
    rl_front::drain_table<kTable>(&bar);
    return;
  }
  uint32_t h1, h2;
  rl_front::halves(a.keys, i, h1, h2);
  // Every load is issued before the policy search and the fold: the 2*d
  // cells, n and the boundary slab's period (which only the fold needs).
  int32_t t[kRows], b[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDepth != 0 || r < a.d) {
      const size_t c = rl_front::cell(h1, h2, r, a.w);
      t[r] = __ldg(a.totals + c);
      b[r] = weighted ? __ldg(a.boundary + c) : 0;
    }
  }
  const int32_t n = a.n != nullptr ? __ldg(a.n + i) : 0;
  const long long held = weighted ? __ldg(a.slab_period + a.slot) : 0;
  const long long lim =
      rl_front::policy_limit<kTable>(a.policy, keys, &bar, h1, h2);
  const float frac = weighted ? boundary_weight(a, held) : 0.0f;
  if (i == 0 && weighted) *a.frac = frac;
  // Min over rows in row order, then the clamp at 0.
  float est = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDepth != 0 || r < a.d) {
      const float tf = static_cast<float>(t[r]);
      const float e =
          weighted ? __fmaf_rn(frac, static_cast<float>(b[r]), tf) : tf;
      est = r == 0 ? e : fminf(est, e);
    }
  }
  est = est < 0.0f ? 0.0f : est;
  a.est[i] = est;
  if (a.n != nullptr) {
    // Limits are < 2^24, exact in f32.
    const float avail = static_cast<float>(lim) - est;
    a.avail[i] = avail < 0.0f ? 0.0f : avail;
    a.n_f[i] = static_cast<float>(n);
  }
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
  const size_t c = rl_front::cell(static_cast<uint32_t>(h1[i]),
                                  static_cast<uint32_t>(h2[i]), r, w);
  atomicAdd(totals + c, a);
  atomicAdd(cur + c, a);
}

// The vanilla step's back (rl_add_back): admission, then each key's
// admitted amount scatter-added into totals and cur at each row's column,
// and allowed and remaining.
struct AddBack {
  int32_t* totals;
  int32_t* cur;
  const int64_t* h1;
  const int64_t* h2;
  const int32_t* n;      // the request counts; the amounts added
  const float* n_f;      // f32(n), as the front wrote it: admission's n
  const float* avail;
  bool* allowed;
  int32_t* remaining;
  int B, d, w, iters;
};

// int32(max(floor(seen - used), 0)), used = n_f where allowed else 0.
__device__ __forceinline__ int32_t remaining_of(float seen, float used) {
  return static_cast<int32_t>(fmaxf(floorf(seen - used), 0.0f));
}

template <class S>
__global__ void __launch_bounds__(S::kThreads)
    add_back_kernel(const AddBack a) {
  constexpr int kBlock = S::kThreads, kItems = S::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  rl_admit::Sorted<float, kItems> s;
  rl_admit::admit<S>(tmp, a.h1, a.n_f, a.avail, a.B, a.iters, s);
  // The scatter, in sorted order. Admission groups on h1 alone, but the
  // columns take (h1, h2), and two keys may share h1: so a run is a
  // stretch of one segment with one h2. Each run's admitted n is summed
  // (int32 adds wrap, so the sum's low 32 bits are what the reference's
  // adds leave) and added by one atomic per row and slab at the run's
  // last request. Runs meet across threads through the neighbours' h2.
  __shared__ unsigned long long edge_h2[2][kBlock];  // first, last
  unsigned long long h2[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    h2[k] = i < a.B ? static_cast<unsigned long long>(__ldg(a.h2 + i)) : 0ull;
  }
  edge_h2[0][threadIdx.x] = h2[0];
  edge_h2[1][threadIdx.x] = h2[kItems - 1];
  __syncthreads();
  const unsigned long long before =
      threadIdx.x > 0 ? edge_h2[1][threadIdx.x - 1] : h2[0];
  const unsigned long long after = threadIdx.x + 1 < kBlock
                                       ? edge_h2[0][threadIdx.x + 1]
                                       : h2[kItems - 1];
  rl_admit::Seg seg[kItems];
  bool last[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    const unsigned long long prev = k > 0 ? h2[k - 1] : before;
    const unsigned long long next = k + 1 < kItems ? h2[k + 1] : after;
    last[k] = s.tail[k] || h2[k] != next;
    seg[k].v = i < a.B && s.allowed[k]
                   ? static_cast<unsigned long long>(
                         static_cast<long long>(__ldg(a.n + i)))
                   : 0ull;
    seg[k].head = s.head[k] || h2[k] != prev;
  }
  typename S::Scan(tmp.scan).InclusiveScan(seg, seg, rl_admit::SegSum());
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    const int32_t add = static_cast<int32_t>(static_cast<uint32_t>(seg[k].v));
    if (!last[k] || i >= a.B || add == 0) continue;
    const uint32_t h1 = static_cast<uint32_t>(__ldg(a.h1 + i));
    for (int r = 0; r < a.d; ++r) {
      const size_t c =
          rl_front::cell(h1, static_cast<uint32_t>(h2[k]), r, a.w);
      atomicAdd(a.totals + c, add);
      atomicAdd(a.cur + c, add);
    }
  }
  // In batch order: coalesced reads and writes.
  for (int i = threadIdx.x; i < a.B; i += kBlock) {
    const bool ok = tmp.u.out.allowed[i];
    a.allowed[i] = ok;
    a.remaining[i] =
        remaining_of(tmp.u.out.seen[i], ok ? __ldg(a.n_f + i) : 0.0f);
  }
}

// The CU step's admission (rl_window_admit): admission, then per key the
// CU target where((est + (avail - seen)) + n_f, 0), allowed and remaining.
struct WindowAdmit {
  const int64_t* h1;
  const float* est;
  const float* n_f;
  const float* avail;
  float* target;
  bool* allowed;
  int32_t* remaining;
  int B, iters;
};

template <class S>
__global__ void __launch_bounds__(S::kThreads)
    window_admit_kernel(const WindowAdmit a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  rl_admit::Sorted<float, S::kItems> s;
  rl_admit::admit<S>(tmp, a.h1, a.n_f, a.avail, a.B, a.iters, s);
  for (int i = threadIdx.x; i < a.B; i += S::kThreads) {
    const bool ok = tmp.u.out.allowed[i];
    const float seen = tmp.u.out.seen[i];
    const float n_f = __ldg(a.n_f + i);
    a.allowed[i] = ok;
    a.remaining[i] = remaining_of(seen, ok ? n_f : 0.0f);
    a.target[i] =
        ok ? (__ldg(a.est + i) + (__ldg(a.avail + i) - seen)) + n_f : 0.0f;
  }
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// front.cuh's launch() picks the table mode and the depth build.
struct WindowFrontKernel {
  template <int kTable, int kDepth>
  static void run(dim3 grid, int threads, size_t smem, cudaStream_t s,
                  const WindowFront& a) {
    window_front_kernel<kTable, kDepth><<<grid, threads, smem, s>>>(a);
  }
};

// admit.cuh's launch() picks the block shape.
struct AddBackKernel {
  using Q = float;
  template <class S>
  static auto fn() { return &add_back_kernel<S>; }
};

struct WindowAdmitKernel {
  using Q = float;
  template <class S>
  static auto fn() { return &window_admit_kernel<S>; }
};

}  // namespace

extern "C" {

// One launch of ceil(B / threads) blocks (one at B = 0). lane: 0 raw
// ids (premix), 1 hashed, 2 halves given. pkey == nullptr: no policy
// table; a key column of at most 4096 rows is staged in shared memory.
int rl_window_front(const void* totals, const void* boundary,
                    const void* slab_period, long long want, int slot,
                    float e, float rcp, const void* h64, void* h1, void* h2,
                    unsigned long long seed, int lane, const void* n,
                    const void* pkey, const void* plimit, int P,
                    long long limit, void* est, void* frac, void* avail,
                    void* n_f, int B, int d, int w, int threads,
                    void* stream) {
  WindowFront a;
  a.totals = static_cast<const int32_t*>(totals);
  a.boundary = static_cast<const int32_t*>(boundary);
  a.slab_period = static_cast<const long long*>(slab_period);
  a.want = want;
  a.slot = slot;
  a.e = e;
  a.rcp = rcp;
  a.keys = {static_cast<const int64_t*>(h64), static_cast<int64_t*>(h1),
            static_cast<int64_t*>(h2), seed, lane};
  a.n = static_cast<const int32_t*>(n);
  a.policy = {static_cast<const long long*>(pkey),
              static_cast<const long long*>(plimit), P, limit};
  a.est = static_cast<float*>(est);
  a.frac = static_cast<float*>(frac);
  a.avail = static_cast<float*>(avail);
  a.n_f = static_cast<float*>(n_f);
  a.B = B;
  a.d = d;
  a.w = w;
  return rl_front::launch<WindowFrontKernel>(
      a, threads, static_cast<cudaStream_t>(stream));
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

// One launch of one block (admit.cuh's shape for B, up to kMaxCapacity
// keys; one block at B = 0 too).
int rl_add_back(void* totals, void* cur, const void* h1, const void* h2,
                const void* n, const void* n_f, const void* avail,
                void* allowed, void* remaining, int B, int d, int w,
                int iters, void* stream) {
  if (d < 1 || w < 16 || (w & (w - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  AddBack a;
  a.totals = static_cast<int32_t*>(totals);
  a.cur = static_cast<int32_t*>(cur);
  a.h1 = static_cast<const int64_t*>(h1);
  a.h2 = static_cast<const int64_t*>(h2);
  a.n = static_cast<const int32_t*>(n);
  a.n_f = static_cast<const float*>(n_f);
  a.avail = static_cast<const float*>(avail);
  a.allowed = static_cast<bool*>(allowed);
  a.remaining = static_cast<int32_t*>(remaining);
  a.B = B;
  a.d = d;
  a.w = w;
  a.iters = iters;
  return rl_admit::launch<AddBackKernel>(a,
                                         static_cast<cudaStream_t>(stream));
}

int rl_window_admit(const void* h1, const void* est, const void* n_f,
                    const void* avail, void* target, void* allowed,
                    void* remaining, int B, int iters, void* stream) {
  WindowAdmit a;
  a.h1 = static_cast<const int64_t*>(h1);
  a.est = static_cast<const float*>(est);
  a.n_f = static_cast<const float*>(n_f);
  a.avail = static_cast<const float*>(avail);
  a.target = static_cast<float*>(target);
  a.allowed = static_cast<bool*>(allowed);
  a.remaining = static_cast<int32_t*>(remaining);
  a.B = B;
  a.iters = iters;
  return rl_admit::launch<WindowAdmitKernel>(
      a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
