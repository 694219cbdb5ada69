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
//   add_update       <- add_update / _add_update_kernel alone (batches
//                       above the admission capacity, and resets of more
//                       keys than one window_reset block takes)
//   window_reset     <- the per-key reset's estimate and add_update
//                       (ratelimiter_tpu/ops/sketch_kernels.py:539-593):
//                       the front's estimate-only form, floored, then
//                       subtracted, in one launch
//   window_admit     <- the CU step's admission, targets and remaining
//                       (ahead of cu_update; replaces no TPU kernel)
//   hh_update        <- the heavy-hitter side table's update (owned
//                       counts, promotion claims, idle clock), which the
//                       reference computes with jnp ops
//                       (ratelimiter_tpu/ops/sketch_kernels.py:487-532;
//                       replaces no TPU kernel): hh.cuh's routine, run as
//                       the tail of the backs' side-table builds, and
//                       alone for the composed back above the capacity
//
// With the side table on (hh_slots > 0), window_front, add_back and
// window_admit run a compile-time variant (a kHH template flag): the front
// also reads each key's slot (mine = owner == h1; the owned part of the
// estimate), the backs leave owned keys out of the sketch writes, write
// the promotion targets and, given the table, run its update (hh.cuh) as
// a tail after their batch-order loop. With the hierarchy cascade (tenants > 0),
// add_back and window_admit run another (kCasc): cascade.cuh's routine in
// the same block after admission, then everything after reads the final
// mask and the scope counters take the histogram. The builds without the
// flags are the code the step ran before either was ported.
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
#include "cascade.cuh"
#include "front.cuh"
#include "hh.cuh"
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
  float* est;                    // clamped at 0 (plus the owned part)
  float* frac;                   // 0-d; written with a boundary
  float* avail;
  float* n_f;
  // The side table (kHH builds): slot owners (int64 holding a u32 h1, 0
  // free), in-window totals and the boundary column (nullptr in fixed
  // mode) of K slots (a power of two); per key mine and the estimate's
  // two parts.
  const long long* hh_owner;
  const int32_t* hh_totals;
  const int32_t* hh_slab;
  int K;
  bool* mine;
  float* est_cms;
  float* est_hh;
  int B, d, w;
};

// clip(1 - e/sub_us, 0, 1) as XLA computes it, when the boundary slab
// holds period p - SW (``held``); 0 when it is stale.
__device__ __forceinline__ float boundary_weight(const WindowFront& a,
                                                 long long held) {
  const float f = fminf(fmaxf(__fmaf_rn(-a.e, a.rcp, 1.0f), 0.0f), 1.0f);
  return held == a.want ? f : 0.0f;
}

// A key's estimate-side loads, issued together: its 2*d cells of totals
// and the boundary, and with the side table its slot's owner, total and
// boundary cell. The front and the reset share them and the fold below.
template <int kRows>
struct KeyCells {
  int32_t t[kRows], b[kRows];
  long long owner;
  int32_t hh_t, hh_b;
};

template <int kDepth, bool kHH, int kRows>
__device__ __forceinline__ void load_cells(const WindowFront& a, uint32_t h1,
                                           uint32_t h2, KeyCells<kRows>& k) {
  const bool weighted = a.boundary != nullptr;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDepth != 0 || r < a.d) {
      const size_t c = rl_front::cell(h1, h2, r, a.w);
      k.t[r] = __ldg(a.totals + c);
      k.b[r] = weighted ? __ldg(a.boundary + c) : 0;
    }
  }
  k.owner = 0;
  k.hh_t = k.hh_b = 0;
  if constexpr (kHH) {
    const uint32_t sid = h1 & static_cast<uint32_t>(a.K - 1);
    k.owner = __ldg(a.hh_owner + sid);
    k.hh_t = __ldg(a.hh_totals + sid);
    k.hh_b = weighted ? __ldg(a.hh_slab + sid) : 0;
  }
}

// The estimate: the min over rows in row order, clamped at 0; with the
// side table, plus the owned part where(mine, max(est_hh, 0), 0), est_hh
// = fma(frac, f32(hh_b), f32(hh_t)) as XLA fuses it (f32(hh_t) in fixed
// mode). ``est_cms`` and ``part`` are the two parts.
template <int kDepth, bool kHH, int kRows>
__device__ __forceinline__ float fold_cells(const WindowFront& a,
                                            const KeyCells<kRows>& k,
                                            float frac, uint32_t h1,
                                            bool& mine, float& est_cms,
                                            float& part) {
  const bool weighted = a.boundary != nullptr;
  float est = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDepth != 0 || r < a.d) {
      const float tf = static_cast<float>(k.t[r]);
      const float e =
          weighted ? __fmaf_rn(frac, static_cast<float>(k.b[r]), tf) : tf;
      est = r == 0 ? e : fminf(est, e);
    }
  }
  est = est < 0.0f ? 0.0f : est;
  est_cms = est;
  mine = false;
  part = 0.0f;
  if constexpr (kHH) {
    mine = k.owner == static_cast<long long>(h1);
    const float tf = static_cast<float>(k.hh_t);
    const float raw =
        weighted ? __fmaf_rn(frac, static_cast<float>(k.hh_b), tf) : tf;
    part = mine ? fmaxf(raw, 0.0f) : 0.0f;
    est = est + part;
  }
  return est;
}

template <int kTable, int kDepth, bool kHH>
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
  // cells and the key's slot, n and the boundary slab's period (which only
  // the fold needs).
  KeyCells<kRows> k;
  load_cells<kDepth, kHH>(a, h1, h2, k);
  const int32_t n = a.n != nullptr ? __ldg(a.n + i) : 0;
  const long long held = weighted ? __ldg(a.slab_period + a.slot) : 0;
  const long long lim =
      rl_front::policy_limit<kTable>(a.policy, keys, &bar, h1, h2);
  const float frac = weighted ? boundary_weight(a, held) : 0.0f;
  if (i == 0 && weighted) *a.frac = frac;
  bool mine;
  float est_cms, part;
  const float est =
      fold_cells<kDepth, kHH>(a, k, frac, h1, mine, est_cms, part);
  if constexpr (kHH) {
    a.mine[i] = mine;
    a.est_cms[i] = est_cms;
    a.est_hh[i] = part;
  }
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

// The per-key reset (rl_window_reset): ONE block, a thread a key. Each
// key's estimate is the front's estimate-only form (load_cells,
// boundary_weight, fold_cells: ops/sketch_kernels.py _sketch_reset read
// it from window_front), floored to int32: the sketch's part (clamped at
// 0) and, with the side table, the owned part. One barrier: every
// estimate is read before any cell is written, as the reference's
// histograms subtract estimates all read first (two reset keys may share
// a column). Then each key's floor is subtracted at each row's cell of
// totals and cur, and the owned part at its slot of hh_totals and hh_cur
// (int32 atomics, wrapping).
struct WindowReset {
  WindowFront f;       // the estimate's operands, keys on the halves lane
  int32_t* totals;     // f.totals, written after the barrier
  int32_t* cur;
  int32_t* hh_totals;  // kHH: f.hh_totals, written after the barrier
  int32_t* hh_cur;
};

constexpr int kResetThreads = 1024;

__device__ __forceinline__ int32_t negated(int32_t x) {
  return static_cast<int32_t>(0u - static_cast<uint32_t>(x));
}

template <bool kHH>
__global__ void __launch_bounds__(kResetThreads)
    window_reset_kernel(const WindowReset a) {
  const WindowFront& f = a.f;
  const int i = threadIdx.x;
  const bool key = i < f.B;
  uint32_t h1 = 0, h2 = 0;
  int32_t sub = 0, sub_hh = 0;
  if (key) {
    rl_front::halves(f.keys, i, h1, h2);
    KeyCells<rl_front::kMaxDepth> k;
    load_cells<0, kHH>(f, h1, h2, k);
    const float frac = f.boundary != nullptr
                           ? boundary_weight(f, __ldg(f.slab_period + f.slot))
                           : 0.0f;
    bool mine;
    float est_cms, part;
    const float est = fold_cells<0, kHH>(f, k, frac, h1, mine, est_cms, part);
    sub = static_cast<int32_t>(floorf(kHH ? est_cms : est));
    sub_hh = static_cast<int32_t>(floorf(part));
  }
  __syncthreads();
  if (!key) return;
  if (sub != 0) {
    for (int r = 0; r < f.d; ++r) {
      const size_t c = rl_front::cell(h1, h2, r, f.w);
      atomicAdd(a.totals + c, negated(sub));
      atomicAdd(a.cur + c, negated(sub));
    }
  }
  if constexpr (kHH) {
    if (sub_hh != 0) {
      const uint32_t sid = h1 & static_cast<uint32_t>(f.K - 1);
      atomicAdd(a.hh_totals + sid, negated(sub_hh));
      atomicAdd(a.hh_cur + sid, negated(sub_hh));
    }
  }
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
  const float* est;      // kHH: the front's estimate
  const bool* mine;      // kHH: owned by the side table (not scattered)
  bool* allowed;
  int32_t* remaining;
  float* target_pr;      // kHH: the promotion targets
  int B, d, w, iters;
  rl_hh::Table hh;       // kHH: the side table for the tail (K = 0: none)
};

// A bool the launch only reads, through the read-only cache.
__device__ __forceinline__ bool ldg_bool(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}

// int32(max(floor(seen - used), 0)), used = n_f where allowed else 0.
__device__ __forceinline__ int32_t remaining_of(float seen, float used) {
  return static_cast<int32_t>(fmaxf(floorf(seen - used), 0.0f));
}

// A request's post-batch target (est + (avail - seen)) + n_f: the CU
// target where allowed, and the side table's promotion target
// where(allowed, ..., est) (ratelimiter_tpu/ops/sketch_kernels.py:496).
__device__ __forceinline__ float post_batch(float est, float avail,
                                            float seen, float n_f) {
  return (est + (avail - seen)) + n_f;
}

// A back's items after admission: the packed form in the cascade builds
// (admit.cuh admit_packed), the register form in the others.
template <class S, bool kCasc>
using Items = std::conditional_t<kCasc, rl_admit::Packed<S::kItems>,
                                 rl_admit::Sorted<float, S::kItems>>;

// Where a back's launch keeps the side-table tail's shared scratch: after
// the results in batch order (tmp.u.out, at the start of the union, which
// starts the storage), which the tail reads. Everything else of the
// launch's shared memory is dead by the time the tail opens (hh.cuh).
template <class S>
__host__ __device__ constexpr size_t tail_offset() {
  return rl_cascade::align16(
      sizeof(std::declval<typename S::Storage&>().u.out));
}

// The tail's shared memory: its scratch (shared mode), then the
// candidates' masses by batch index.
template <class S>
__device__ __forceinline__ rl_hh::Tail back_tail(const rl_hh::Table& t,
                                                 unsigned char* smem) {
  unsigned char* scratch = smem + tail_offset<S>();
  return rl_hh::Tail(t, scratch,
                     reinterpret_cast<uint32_t*>(
                         scratch + rl_hh::scratch_bytes(t.K)));
}

// The bytes a back's launch at shape S needs beyond the admission's
// storage for a tail over K slots (0: none): 0 where the union has room.
template <class S>
size_t tail_extra(int K) {
  if (K == 0) return 0;
  const size_t need = tail_offset<S>() + rl_hh::scratch_bytes(K) +
                      rl_hh::mass_bytes(S::kCapacity);
  if (need <= sizeof(typename S::Storage)) return 0;
  const size_t have = rl_admit::storage_bytes<S>();
  return need > have ? need - have : 16;
}

template <class S, bool kHH, bool kCasc>
__global__ void __launch_bounds__(S::kThreads, 1)
    add_back_kernel(const rl_cascade::Operands<kCasc, AddBack> a) {
  constexpr int kBlock = S::kThreads, kItems = S::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  // The cascade build: its map's copy lands while stage 1 (in the packed
  // form) runs; stages 2 and 3 in this block, then everything below
  // reads the final mask.
  Items<S, kCasc> s;
  if constexpr (kCasc) {
    rl_cascade::stage_map<S>(smem, a.casc);
    rl_admit::admit_packed<S>(tmp, a.h1, a.n_f, a.avail, a.B, a.iters, s);
    rl_cascade::in_back<S, float>(tmp, smem, s, a.casc, a.h1, a.B, a.iters,
                                  {a.n_f, a.avail});
  } else {
    rl_admit::admit<S>(tmp, a.h1, a.n_f, a.avail, a.B, a.iters, s);
  }
  // The scatter, in sorted order. Admission groups on h1 alone, but the
  // columns take (h1, h2), and two keys may share h1: so a run is a
  // stretch of one segment with one h2. Each run's admitted n is summed
  // (int32 adds wrap, so the sum's low 32 bits are what the reference's
  // adds leave) and added by one atomic per row and slab at the run's
  // last request. Runs meet across threads through the neighbours' h2.
  // The cascade builds hold h2 (< 2^32) and the run sums (read modulo
  // 2^32) in 32-bit words: they run with more items a thread.
  using H = std::conditional_t<kCasc, uint32_t, unsigned long long>;
  using SegT = std::conditional_t<kCasc, rl_admit::Seg32, rl_admit::Seg>;
  __shared__ H edge_h2[2][kBlock];  // first, last
  H h2[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    h2[k] = i < a.B ? static_cast<H>(__ldg(a.h2 + i)) : H(0);
  }
  edge_h2[0][threadIdx.x] = h2[0];
  edge_h2[1][threadIdx.x] = h2[kItems - 1];
  __syncthreads();
  const H before = threadIdx.x > 0 ? edge_h2[1][threadIdx.x - 1] : h2[0];
  const H after =
      threadIdx.x + 1 < kBlock ? edge_h2[0][threadIdx.x + 1] : h2[kItems - 1];
  SegT seg[kItems];
  bool last[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    const H prev = k > 0 ? h2[k - 1] : before;
    const H next = k + 1 < kItems ? h2[k + 1] : after;
    last[k] = s.is_tail(k) || h2[k] != next;
    bool written = i < a.B && s.is_allowed(k);
    if constexpr (kHH) written = written && !a.mine[i];
    seg[k].v = written ? static_cast<decltype(seg[k].v)>(
                             static_cast<long long>(__ldg(a.n + i)))
                       : 0;
    seg[k].head = s.is_head(k) || h2[k] != prev;
  }
  rl_admit::inclusive<S>(tmp, seg);
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
  // In batch order: coalesced reads and writes. With the side table's
  // tail, its pass A on each request's final verdict and promotion
  // target (a thread's candidates: bits of ``cands``), then passes B-C.
  const bool tail_on = kHH && a.hh.K != 0;
  rl_hh::Tail tail = back_tail<S>(a.hh, smem);
  if (tail_on) tail.open();
  unsigned cands = 0;
  for (int i = threadIdx.x, k = 0; i < a.B; i += kBlock, ++k) {
    const bool ok = tmp.u.out.allowed[i];
    a.allowed[i] = ok;
    a.remaining[i] =
        remaining_of(tmp.u.out.seen[i], ok ? __ldg(a.n_f + i) : 0.0f);
    if constexpr (kHH) {
      const float est = __ldg(a.est + i);
      const float tp = ok ? post_batch(est, __ldg(a.avail + i),
                                       tmp.u.out.seen[i], __ldg(a.n_f + i))
                          : est;
      a.target_pr[i] = tp;
      if (tail_on &&
          tail.count(i, static_cast<uint32_t>(__ldg(a.h1 + i)),
                     ldg_bool(a.mine + i), ok, __ldg(a.n + i), tp))
        cands |= 1u << k;
    }
  }
  if (tail_on) {
    tail.finish(
        cands, [&](int i) { return static_cast<uint32_t>(__ldg(a.h1 + i)); },
        [&](int i) { return static_cast<uint32_t>(__ldg(a.h2 + i)); }, a.B);
  }
}

// The CU step's admission (rl_window_admit): admission, then per key the
// CU target where((est + (avail - seen)) + n_f, 0), allowed and remaining.
struct WindowAdmit {
  const int64_t* h1;
  const float* est;
  const float* n_f;
  const float* avail;
  const bool* mine;      // kHH: owned keys target 0
  float* target;
  bool* allowed;
  int32_t* remaining;
  float* target_pr;      // kHH: the promotion targets
  int B, iters;
  const int64_t* h2;     // kHH with the tail: the batch's h2 and n
  const int32_t* n;
  rl_hh::Table hh;       // kHH: the side table for the tail (K = 0: none)
};

template <class S, bool kHH, bool kCasc>
__global__ void __launch_bounds__(S::kThreads, 1)
    window_admit_kernel(const rl_cascade::Operands<kCasc, WindowAdmit> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  Items<S, kCasc> s;
  if constexpr (kCasc) {
    rl_cascade::stage_map<S>(smem, a.casc);
    rl_admit::admit_packed<S>(tmp, a.h1, a.n_f, a.avail, a.B, a.iters, s);
    rl_cascade::in_back<S, float>(tmp, smem, s, a.casc, a.h1, a.B, a.iters,
                                  {a.n_f, a.avail});
  } else {
    rl_admit::admit<S>(tmp, a.h1, a.n_f, a.avail, a.B, a.iters, s);
  }
  // In batch order; the side table's tail as in add_back_kernel.
  const bool tail_on = kHH && a.hh.K != 0;
  rl_hh::Tail tail = back_tail<S>(a.hh, smem);
  if (tail_on) tail.open();
  unsigned cands = 0;
  for (int i = threadIdx.x, k = 0; i < a.B; i += S::kThreads, ++k) {
    const bool ok = tmp.u.out.allowed[i];
    const float seen = tmp.u.out.seen[i];
    const float n_f = __ldg(a.n_f + i);
    a.allowed[i] = ok;
    a.remaining[i] = remaining_of(seen, ok ? n_f : 0.0f);
    if constexpr (kHH) {
      const float est = __ldg(a.est + i);
      const float v = post_batch(est, __ldg(a.avail + i), seen, n_f);
      const bool mine = ldg_bool(a.mine + i);
      const float tp = ok ? v : est;
      a.target[i] = ok && !mine ? v : 0.0f;
      a.target_pr[i] = tp;
      if (tail_on && tail.count(i, static_cast<uint32_t>(__ldg(a.h1 + i)),
                                mine, ok, __ldg(a.n + i), tp))
        cands |= 1u << k;
    } else {
      a.target[i] =
          ok ? (__ldg(a.est + i) + (__ldg(a.avail + i) - seen)) + n_f : 0.0f;
    }
  }
  if (tail_on) {
    tail.finish(
        cands, [&](int i) { return static_cast<uint32_t>(__ldg(a.h1 + i)); },
        [&](int i) { return static_cast<uint32_t>(__ldg(a.h2 + i)); }, a.B);
  }
}

// The side table's update alone (rl_hh_update), for the composed back
// above the admission capacity: ONE block runs hh.cuh's routine on the
// operands the composed back left in global memory. Pass B re-derives
// each request's candidacy and claim (the batch may hold 2^20 requests,
// more than shared memory holds masses for); the owners it reads stand
// until pass C.
struct HHUpdate {
  rl_hh::Table hh;
  const int64_t* h1;
  const int64_t* h2;
  const int32_t* n;
  const bool* allowed;
  const bool* mine;
  const float* target_pr;
  int B;
};

constexpr int kHHThreads = 1024;

__global__ void __launch_bounds__(kHHThreads)
    hh_update_kernel(const HHUpdate a) {
  extern __shared__ __align__(16) unsigned char smem[];
  rl_hh::Tail tail(a.hh, smem);
  auto h1 = [&](int i) { return static_cast<uint32_t>(a.h1[i]); };
  tail.open();
  for (int i = threadIdx.x; i < a.B; i += blockDim.x)
    tail.count(i, h1(i), a.mine[i], a.allowed[i], a.n[i], a.target_pr[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < a.B; i += blockDim.x) {
    const float tp = a.target_pr[i];
    if (tail.candidate(h1(i), a.mine[i], tp))
      tail.win(h1(i), rl_hh::packed_of(rl_hh::mass_of(tp), h1(i)),
               [&] { return static_cast<uint32_t>(a.h2[i]); });
  }
  __syncthreads();
  tail.close(h1, a.B);
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// front.cuh's launch() picks the table mode and the depth build; the
// side table's operands pick the kHH build.
struct WindowFrontKernel {
  template <int kTable, int kDepth>
  static void run(dim3 grid, int threads, size_t smem, cudaStream_t s,
                  const WindowFront& a) {
    if (a.hh_owner != nullptr) {
      window_front_kernel<kTable, kDepth, true><<<grid, threads, smem, s>>>(
          a);
    } else {
      window_front_kernel<kTable, kDepth, false>
          <<<grid, threads, smem, s>>>(a);
    }
  }
};

// admit.cuh's launch() picks the block shape.
template <bool kHH, bool kCasc>
struct AddBackKernel {
  using Q = float;
  template <class S>
  static auto fn() { return &add_back_kernel<S, kHH, kCasc>; }
};

template <bool kHH, bool kCasc>
struct WindowAdmitKernel {
  using Q = float;
  template <class S>
  static auto fn() { return &window_admit_kernel<S, kHH, kCasc>; }
};

// A back's launch: the kHH and kCasc builds picked from its operands
// (the builds without the cascade take the base operands alone); a kHH
// build with the tail gets the shared memory its scratch needs.
template <template <bool, bool> class Kernel, class Base>
int launch_back(const rl_cascade::With<Base>& a, bool hh, cudaStream_t s) {
  const int K = a.hh.K;
  auto tail = [K](auto shape) { return tail_extra<decltype(shape)>(K); };
  if (a.casc.limit != nullptr) {
    if (!rl_cascade::valid(a.casc))
      return static_cast<int>(cudaErrorInvalidValue);
    return hh ? rl_cascade::launch<Kernel<true, true>>(a, s, tail)
              : rl_cascade::launch<Kernel<false, true>>(a, s);
  }
  const Base& b = a;
  return hh ? rl_admit::launch_with<Kernel<true, false>>(b, s, tail)
            : rl_admit::launch<Kernel<false, false>>(b, s);
}

// The tail's operands (the same nine in each entry point that takes
// them); owner == nullptr: no tail (K = 0).
rl_hh::Table hh_table(void* owner, void* owner2, void* cur, void* totals,
                      void* last, void* claims, float thresh, long long p,
                      int K) {
  rl_hh::Table t;
  t.owner = static_cast<long long*>(owner);
  t.owner2 = static_cast<long long*>(owner2);
  t.cur = static_cast<int32_t*>(cur);
  t.totals = static_cast<int32_t*>(totals);
  t.last = static_cast<long long*>(last);
  t.claims = static_cast<unsigned long long*>(claims);
  t.thresh = thresh;
  t.p = p;
  t.K = owner != nullptr ? K : 0;
  return t;
}

bool valid_table(const rl_hh::Table& t) {
  return t.K >= 1 && (t.K & (t.K - 1)) == 0 && t.owner2 != nullptr &&
         t.cur != nullptr && t.totals != nullptr && t.last != nullptr &&
         (rl_hh::shared_mode(t.K) || t.claims != nullptr);
}

}  // namespace

extern "C" {

// One launch of ceil(B / threads) blocks (one at B = 0). lane: 0 raw
// ids (premix), 1 hashed, 2 halves given. pkey == nullptr: no policy
// table; a key column of at most 4096 rows is staged in shared memory.
// hh_owner == nullptr: no side table.
int rl_window_front(const void* totals, const void* boundary,
                    const void* slab_period, long long want, int slot,
                    float e, float rcp, const void* h64, void* h1, void* h2,
                    unsigned long long seed, int lane, const void* n,
                    const void* pkey, const void* plimit, int P,
                    long long limit, void* est, void* frac, void* avail,
                    void* n_f, const void* hh_owner, const void* hh_totals,
                    const void* hh_slab, int K, void* mine, void* est_cms,
                    void* est_hh, int B, int d, int w, int threads,
                    void* stream) {
  if (hh_owner != nullptr && (K < 1 || (K & (K - 1)) ||
                              (hh_slab == nullptr) != (boundary == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.hh_owner = static_cast<const long long*>(hh_owner);
  a.hh_totals = static_cast<const int32_t*>(hh_totals);
  a.hh_slab = static_cast<const int32_t*>(hh_slab);
  a.K = K;
  a.mine = static_cast<bool*>(mine);
  a.est_cms = static_cast<float*>(est_cms);
  a.est_hh = static_cast<float*>(est_hh);
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
// keys; one block at B = 0 too). mine == nullptr: no side table (est and
// target_pr unused). limit == nullptr: no cascade (its operands unused).
// hh_owner == nullptr: no tail; else (with mine) the side table's update
// runs as the launch's tail (hh.cuh; hh_claims: the (2, K) zeroed global
// scratch, needed above rl_hh::kSharedSlots slots).
int rl_add_back(void* totals, void* cur, const void* h1, const void* h2,
                const void* n, const void* n_f, const void* avail,
                const void* est, const void* mine, void* allowed,
                void* remaining, void* target_pr, int B, int d, int w,
                int iters, const void* map_key, const void* map_tid, int P,
                const void* limit, const void* weight, int T, void* counts,
                void* tn_cur, const void* slab, const void* frac,
                void* hh_owner, void* hh_owner2, void* hh_cur,
                void* hh_totals, void* hh_last, void* hh_claims, float thresh,
                long long p, int K, void* stream) {
  const rl_hh::Table hh = hh_table(hh_owner, hh_owner2, hh_cur, hh_totals,
                                   hh_last, hh_claims, thresh, p, K);
  // (An empty batch's operands may be null: nothing reads them.)
  if (d < 1 || w < 16 || (w & (w - 1)) ||
      (hh.K != 0 && (!valid_table(hh) || (B > 0 && mine == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  rl_cascade::With<AddBack> a;
  a.totals = static_cast<int32_t*>(totals);
  a.cur = static_cast<int32_t*>(cur);
  a.h1 = static_cast<const int64_t*>(h1);
  a.h2 = static_cast<const int64_t*>(h2);
  a.n = static_cast<const int32_t*>(n);
  a.n_f = static_cast<const float*>(n_f);
  a.avail = static_cast<const float*>(avail);
  a.est = static_cast<const float*>(est);
  a.mine = static_cast<const bool*>(mine);
  a.allowed = static_cast<bool*>(allowed);
  a.remaining = static_cast<int32_t*>(remaining);
  a.target_pr = static_cast<float*>(target_pr);
  a.B = B;
  a.d = d;
  a.w = w;
  a.iters = iters;
  a.hh = hh;
  a.casc = rl_cascade::make_args(h2, n, map_key, map_tid, P, limit, weight,
                                 T, counts, tn_cur, slab, frac, 0, 0);
  return launch_back<AddBackKernel, AddBack>(
      a, mine != nullptr || hh.K != 0, static_cast<cudaStream_t>(stream));
}

// mine == nullptr: no side table (target_pr unused). limit == nullptr:
// no cascade (its operands unused; h2 and n unused without the tail
// either). hh_owner == nullptr: no tail; else as rl_add_back's.
int rl_window_admit(const void* h1, const void* est, const void* n_f,
                    const void* avail, const void* mine, void* target,
                    void* allowed, void* remaining, void* target_pr, int B,
                    int iters, const void* h2, const void* n,
                    const void* map_key, const void* map_tid, int P,
                    const void* limit, const void* weight, int T,
                    void* counts, void* tn_cur, const void* slab,
                    const void* frac, void* hh_owner, void* hh_owner2,
                    void* hh_cur, void* hh_totals, void* hh_last,
                    void* hh_claims, float thresh, long long p, int K,
                    void* stream) {
  const rl_hh::Table hh = hh_table(hh_owner, hh_owner2, hh_cur, hh_totals,
                                   hh_last, hh_claims, thresh, p, K);
  if (hh.K != 0 &&
      (!valid_table(hh) ||
       (B > 0 && (mine == nullptr || h2 == nullptr || n == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  rl_cascade::With<WindowAdmit> a;
  a.h1 = static_cast<const int64_t*>(h1);
  a.est = static_cast<const float*>(est);
  a.n_f = static_cast<const float*>(n_f);
  a.avail = static_cast<const float*>(avail);
  a.mine = static_cast<const bool*>(mine);
  a.target = static_cast<float*>(target);
  a.allowed = static_cast<bool*>(allowed);
  a.remaining = static_cast<int32_t*>(remaining);
  a.target_pr = static_cast<float*>(target_pr);
  a.B = B;
  a.iters = iters;
  a.h2 = static_cast<const int64_t*>(h2);
  a.n = static_cast<const int32_t*>(n);
  a.hh = hh;
  a.casc = rl_cascade::make_args(h2, n, map_key, map_tid, P, limit, weight,
                                 T, counts, tn_cur, slab, frac, 0, 0);
  return launch_back<WindowAdmitKernel, WindowAdmit>(
      a, mine != nullptr || hh.K != 0, static_cast<cudaStream_t>(stream));
}

// One launch of one block (kHHThreads threads, fewer for a small batch;
// one warp at B = 0), with rl_hh::scratch_bytes(K) of dynamic shared
// memory (shared mode, K <= rl_hh::kSharedSlots); above, claims is the
// (2, K) global scratch, zero on entry and on return.
int rl_hh_update(void* owner, void* owner2, void* cur, void* totals,
                 void* last, void* claims, const void* h1, const void* h2,
                 const void* n, const void* allowed, const void* mine,
                 const void* target_pr, float thresh, long long p, int B,
                 int K, void* stream) {
  HHUpdate a;
  a.hh = hh_table(owner, owner2, cur, totals, last, claims, thresh, p, K);
  if (B < 0 || owner == nullptr || !valid_table(a.hh))
    return static_cast<int>(cudaErrorInvalidValue);
  a.h1 = static_cast<const int64_t*>(h1);
  a.h2 = static_cast<const int64_t*>(h2);
  a.n = static_cast<const int32_t*>(n);
  a.allowed = static_cast<const bool*>(allowed);
  a.mine = static_cast<const bool*>(mine);
  a.target_pr = static_cast<const float*>(target_pr);
  a.B = B;
  const int threads =
      B >= kHHThreads ? kHHThreads : (B > 32 ? (B + 31) / 32 * 32 : 32);
  const size_t smem = rl_hh::scratch_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hh_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hh_update_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// The per-key reset in one launch of one block, a thread a key (at most
// kResetThreads keys; one warp at B = 0). Keys on the halves lane;
// boundary == nullptr: fixed window; hh_owner == nullptr: no side table.
int rl_window_reset(void* totals, void* cur, const void* boundary,
                    const void* slab_period, long long want, int slot,
                    float e, float rcp, const void* h1, const void* h2,
                    const void* hh_owner, void* hh_totals, void* hh_cur,
                    const void* hh_slab, int K, int B, int d, int w,
                    void* stream) {
  if (B < 0 || B > kResetThreads || d < 1 || d > rl_front::kMaxDepth ||
      w < 16 || (w & (w - 1)) ||
      (hh_owner != nullptr &&
       (K < 1 || (K & (K - 1)) || hh_totals == nullptr ||
        hh_cur == nullptr || (hh_slab == nullptr) != (boundary == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  WindowReset a;
  WindowFront& f = a.f;
  f = WindowFront{};
  f.totals = static_cast<const int32_t*>(totals);
  f.boundary = static_cast<const int32_t*>(boundary);
  f.slab_period = static_cast<const long long*>(slab_period);
  f.want = want;
  f.slot = slot;
  f.e = e;
  f.rcp = rcp;
  f.keys = {nullptr, static_cast<int64_t*>(const_cast<void*>(h1)),
            static_cast<int64_t*>(const_cast<void*>(h2)), 0,
            rl_front::kHalves};
  f.hh_owner = static_cast<const long long*>(hh_owner);
  f.hh_totals = static_cast<const int32_t*>(hh_totals);
  f.hh_slab = static_cast<const int32_t*>(hh_slab);
  f.K = K;
  f.B = B;
  f.d = d;
  f.w = w;
  a.totals = static_cast<int32_t*>(totals);
  a.cur = static_cast<int32_t*>(cur);
  a.hh_totals = static_cast<int32_t*>(hh_totals);
  a.hh_cur = static_cast<int32_t*>(hh_cur);
  const int threads = B > 32 ? (B + 31) / 32 * 32 : 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hh_owner != nullptr) {
    window_reset_kernel<true><<<1, threads, 0, s>>>(a);
  } else {
    window_reset_kernel<false><<<1, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
