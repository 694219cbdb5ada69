// The hierarchical cascade (ADR-020) as one block-level routine: stages 2
// and 3 of the admission (tenant scope, then the global scope with the
// weighted fair share), with the tenant ids and the scopes' availability.
//
// It computes what ops/hier_kernels.py computes (the JAX package's
// ratelimiter_tpu/ops/hier_kernels.py: derive_tids :60-70, scope_avail
// :194-197, cascade_admit :119-191), which are jnp there, not Pallas: so it
// replaces no TPU kernel. It runs inside the cascade builds of the three
// backs of the step (a kCasc template flag of rl_add_back, rl_window_admit
// in sketch_kernels.cu and rl_bucket_admit in bucket_kernels.cu), in the
// block that has just run stage 1 (admit.cuh). For measurement it also
// runs alone as rl_cascade_bench (cascade_bench.cu), which chip_smoke.py
// holds to the plain version and times beside the backs' builds.
//
// Design. The block holds the batch; a request's tenant id is its group.
// What bounds the routine is latency on one SM (dependent loads, block
// barriers, block scans), not bytes, so each step takes the fewest of
// them (chip_smoke.py times each step with the bench build's SM clock
// marks; PERF.md):
//   0. at kernel entry (stage_map), before stage 1, one thread issues a
//      bulk asynchronous copy of the key->tenant map's key and tid
//      columns into shared memory, completing on an mbarrier (front.cuh's
//      kShared staging, tile_owner.cuh's barriers); stage 1 runs while it
//      lands. Maps of at most kSmemMapRows (4096) rows are staged (the
//      default is 1024); a larger map is searched in global memory, a
//      mode chosen at launch from P, like the front's kGlobal;
//   1. tenant ids in batch order: for a staged map, an index of its
//      sorted keys by their top log2(P) bits, built without atomics (the
//      first row of each of P buckets), so that a query reads its
//      bucket's ~1 row, where a binary search takes ~12 dependent loads a
//      request, its top levels on one bank; for a larger map a two-level
//      descent (32 block tops, then the block) in global memory. Either finds the last row holding the key, as the
//      reference's search does; misses on tenant 0; clamped to [0, T-1];
//   2. per scope, once a launch: its availability (scope_avail) into a
//      shared (T+1) array;
//   3. the stage-1 survivors' demand per tenant, a histogram by native
//      32-bit shared atomics (hist_of: two limb sums; one add a request,
//      or one a run of one tenant among a thread's sorted items), its
//      total and the uncontended test by block reductions. The sums are
//      modulo 2^64 of int32 counts, so the order of adds cannot change
//      them. When every tenant's demand fits its availability and the
//      total fits the global one, the final mask is the stage-1 mask (the
//      reference's uncontended branch) and the histogram is the result:
//      no sort and no scan, and the back keeps stage 1's results as they
//      are;
//   4. otherwise a stable block radix sort of (tid, batch index | stage-1
//      verdict) on log2(T) + 1 bits, the tid segments' heads, and stage 2
//      and stage 3 each the greedy fixpoint of admit.cuh (iters rounds,
//      fewer at a fixed point, then the safety intersection) over the tid
//      segments, against the tenant's availability, then against its cap
//      min(demand, G*weight // sum of active weights) when the survivors'
//      total exceeds G. The demand after stage 2 is a histogram again,
//      and the caps are computed once per tenant into the same (T+1)
//      array (weights read once a tenant from global memory; no division
//      for a tenant without demand). With every n >= 0, a stage whose
//      scopes all fit (no tenant over its availability; the total within
//      G) is the identity and is skipped. Up to 64 scopes the scans are
//      32-bit (the reference's sums there are int32);
//   5. the admitted mass per tenant, a last histogram, and the final mask
//      in batch order; the back then recounts the key scope's consumption
//      under it (one scan over the h1 segments).
// Block scans: at most 2*(iters+1) in the cascade, +1 for the back's
// recount, and none on an uncontended batch.
//
// Registers. admit.cuh's 1024 x 8 shape leaves 64 registers a thread,
// and the builds without the flag already spill there (PERF.md); the
// cascade builds take 512 x 16 above 4096 requests (128 registers a
// thread; ``launch``). Their stage 1 is admit.cuh's admit_packed (n and
// avail in shared memory, striped; heads, tails and verdicts bit masks),
// and the routine stashes those items in shared memory while it runs:
// batch index, head, tail and verdict as one uint16 an item (n and avail
// are read again from the back's operands where the recount needs them).
// The cascade's own items keep their tenants two to a register, their n,
// batch indices and segment heads in shared memory, and their verdicts
// as a bit mask.
//
// Shared memory beyond stage 1's storage (admit.cuh ``storage_bytes``):
// a 16-byte header (the mbarrier), then one region that holds the staged
// map (16 bytes a row) and its bucket index (2 bytes a row) until the ids
// are found, and then the histogram's limbs and the availability/cap
// array (16 bytes a scope); the uint16 ids and stash (2 bytes a request
// each) sit at the end of stage 1's union when it has room after what the
// sort and the results take (the 512 x 8 and 512 x 16 shapes), otherwise
// after the region. At B = 8192 (512 x 16) with T = 4096 and a 4096-row
// map staged: 205,120 bytes dynamic (the 128 KB union, the scan storage,
// 16 + 73,744 bytes of region), 213,312 with add_back's 8 KB of static
// edges, of the 232,448 a block may take (chip_smoke.py prints the
// figure from the build).
//
// Integers as the reference has them. All quantities are int64 request
// counts. Up to 64 scopes (T + 1 <= 64) the reference's per-tenant prefix
// sums are int32 cumsums (_admit_dense), compared in int64 after the
// wrap; above, int64 (segment.admit). The scans here are 32-bit in the
// dense case (each exclusive sum's low 32 bits, sign-extended: the same
// value, since the int32 cumsum wraps modulo 2^32 in any order) and
// 64-bit above. The fair share is floor((G * weight) / sum) with the
// product wrapping modulo 2^64, as torch's. The windowed tenant boundary
// term is ceil(frac * f32(max(b, 0))) in f32 (one multiply; the library
// is built with -fmad=false), taken as int64.
//
// Bound on an H100: each request's h1, h2, n and stage-1 verdict read and
// its verdict written, the map read, and a few int64s per tenant present:
// ~0.1 MB at B = 4096 (~0.03 us at 3.35 TB/s), far below one launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "admit.cuh"
#include "front.cuh"
#include "tile_owner.cuh"

namespace rl_cascade {

// The scopes' operands. Windowed (cur != nullptr): counts is tn_totals
// int32 (T+1), cur tn_cur, both folded with the histogram; slab the tenant
// boundary sub-window (nullptr in fixed mode) weighted by *frac. Bucket
// (cur == nullptr): counts is tn_counts int64 (T+1), read as 0 and
// replaced when ``rolled``; retry_us is the time to the next window for
// rows the cascade denied. limit/weight int64 (T+1), the map's key/tid
// columns int64 (P, sorted, PAD_KEY-padded, 16-byte aligned).
struct Args {
  const int64_t* h2;
  const int32_t* n;
  const long long* map_key;
  const long long* map_tid;
  int P;
  const long long* limit;
  const long long* weight;
  int T;
  void* counts;
  int32_t* cur;
  const int32_t* slab;
  const float* frac;
  int rolled;
  long long retry_us;
};

// A back's operands with the cascade's. The builds without the flag take
// ``Base`` alone, so their parameters, and their machine code, stay what
// they were before the cascade.
template <class Base>
struct With : Base {
  Args casc;
};

template <bool kCasc, class Base>
using Operands = std::conditional_t<kCasc, With<Base>, Base>;

// Maps of at most this many rows are staged in shared memory.
constexpr int kSmemMapRows = 4096;

// The map's padding key (ops/policy_kernels.py PAD_KEY): int64 max.
constexpr long long kPadKey = 0x7FFFFFFFFFFFFFFFll;

// A batch index takes 13 bits (kMaxCapacity = 8192); the stash and the
// sort's values carry flags above it.
constexpr uint32_t kIdxMask = 0x1FFF;
constexpr uint32_t kHeadBit = 1u << 13, kTailBit = 1u << 14,
                   kVerdictBit = 1u << 15;
static_assert(rl_admit::kMaxCapacity <= kIdxMask + 1, "13-bit indices");

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Where the uint16 ids and stash go for shape S: at the end of stage 1's
// union when it has room after the sort's, the heads' and the results'
// storage (which are live while they are), else after the region.
template <class S>
struct Layout {
  using Storage = typename S::Storage;
  static constexpr size_t kUnion = sizeof(std::declval<Storage&>().u);
  static constexpr size_t kOut = sizeof(std::declval<Storage&>().u.out);
  static constexpr size_t kSort = sizeof(typename S::Sort::TempStorage);
  static constexpr size_t kHeads = sizeof(typename S::Heads::TempStorage);
  static constexpr size_t kArray = 2 * static_cast<size_t>(S::kCapacity);
  static constexpr size_t kBusy =
      kSort > kHeads ? (kSort > kOut ? kSort : kOut)
                     : (kHeads > kOut ? kHeads : kOut);
  static constexpr bool kInUnion = kUnion >= 2 * kArray &&
                                   kUnion - 2 * kArray >= kOut &&
                                   kUnion - kArray >= kBusy;
};

__host__ __device__ inline size_t region_bytes(int T, int P) {
  const size_t map =
      P <= kSmemMapRows ? static_cast<size_t>(P) * 18 + 2 : 0;
  const size_t scopes = static_cast<size_t>(T + 1) * 16;
  return align16(map > scopes ? map : scopes);
}

// Shared memory the cascade takes beyond admit.cuh's storage_bytes<S>().
template <class S>
size_t extra_bytes(int T, int P) {
  return 16 + region_bytes(T, P) +
         (Layout<S>::kInUnion ? 0 : 2 * Layout<S>::kArray);
}

// The start of the cascade's shared memory in a launch's dynamic smem.
template <class S>
__device__ __forceinline__ unsigned char* extra_base(unsigned char* smem) {
  return smem + rl_admit::storage_bytes<S>();
}

// The routine's shared arrays.
struct View {
  uint64_t* bar;
  long long* map_key;  // staged map (until the ids are found)
  long long* map_tid;
  uint16_t* start;     // its bucket index, P + 1 rows (decide)
  uint32_t* lo;        // then the histogram's two limb sums, and the
  uint32_t* hi;        // availability, (T+1) each (hist_of)
  long long* avail;
  uint16_t* ids;    // tenant ids in batch order
  uint16_t* stash;  // stage 1's items in sorted order
};

template <class S>
__device__ __forceinline__ View view(typename S::Storage& tmp,
                                     unsigned char* smem, const Args& c) {
  using L = Layout<S>;
  unsigned char* ex = extra_base<S>(smem);
  View v;
  v.bar = reinterpret_cast<uint64_t*>(ex);
  unsigned char* region = ex + 16;
  v.map_key = reinterpret_cast<long long*>(region);
  v.map_tid = v.map_key + c.P;
  v.start = reinterpret_cast<uint16_t*>(v.map_tid + c.P);
  v.lo = reinterpret_cast<uint32_t*>(region);
  v.hi = v.lo + (c.T + 1);
  v.avail = reinterpret_cast<long long*>(region) + (c.T + 1);
  unsigned char* arrays;
  if constexpr (L::kInUnion) {
    arrays = reinterpret_cast<unsigned char*>(&tmp.u) + L::kUnion -
             2 * L::kArray;
  } else {
    arrays = region + region_bytes(c.T, c.P);
  }
  v.ids = reinterpret_cast<uint16_t*>(arrays);
  v.stash = reinterpret_cast<uint16_t*>(arrays + L::kArray);
  return v;
}

// The C interface's cascade operands (the same fourteen in every entry
// point that takes them); limit == nullptr: no cascade.
inline Args make_args(const void* h2, const void* n, const void* map_key,
                      const void* map_tid, int P, const void* limit,
                      const void* weight, int T, void* counts, void* cur,
                      const void* slab, const void* frac, int rolled,
                      long long retry_us) {
  Args c;
  c.h2 = static_cast<const int64_t*>(h2);
  c.n = static_cast<const int32_t*>(n);
  c.map_key = static_cast<const long long*>(map_key);
  c.map_tid = static_cast<const long long*>(map_tid);
  c.P = P;
  c.limit = static_cast<const long long*>(limit);
  c.weight = static_cast<const long long*>(weight);
  c.T = T;
  c.counts = counts;
  c.cur = static_cast<int32_t*>(cur);
  c.slab = static_cast<const int32_t*>(slab);
  c.frac = static_cast<const float*>(frac);
  c.rolled = rolled;
  c.retry_us = retry_us;
  return c;
}

// (An empty batch's h2 and n may be null: nothing reads them.)
inline bool valid(const Args& c) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(c.map_key) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(c.map_tid) & 15) == 0;
  return c.T >= 2 && c.T <= 4096 && (c.T & (c.T - 1)) == 0 && c.P >= 2 &&
         (c.P & (c.P - 1)) == 0 && c.map_key != nullptr &&
         c.map_tid != nullptr && aligned && c.limit != nullptr &&
         c.weight != nullptr && c.counts != nullptr &&
         (c.slab == nullptr || c.frac != nullptr);
}

// The launch of a cascade build with its shared memory, at admit.cuh's
// shapes up to 4096 requests and at 512 threads x 16 above (admit.cuh's
// 1024 x 8 leaves 64 registers a thread, and the cascade builds spill
// there; 512 x 16 leaves 128 for twice the items). ``more(S())``: the
// bytes the kernel needs beyond admit.cuh's storage at shape S, when
// more than the cascade's (the side table's tail, sketch_kernels.cu).
template <class Kernel, class A, class More>
int launch(const A& a, cudaStream_t stream, More more) {
  using Q = typename Kernel::Q;
  if (a.B < 0 || a.B > rl_admit::kMaxCapacity || a.iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = a.casc.T, P = a.casc.P;
  auto go = [&](auto shape) {
    using S = decltype(shape);
    const size_t extra = extra_bytes<S>(T, P), tail = more(shape);
    return rl_admit::launch_block<S>(Kernel::template fn<S>(), a, stream,
                                     extra > tail ? extra : tail);
  };
  if (a.B <= 256) return go(rl_admit::Shape<64, 4, Q>());
  if (a.B <= 1024) return go(rl_admit::Shape<256, 4, Q>());
  if (a.B <= 4096) return go(rl_admit::Shape<512, 8, Q>());
  return go(rl_admit::Shape<512, 16, Q>());
}

template <class Kernel, class A>
int launch(const A& a, cudaStream_t stream) {
  return launch<Kernel>(a, stream, [](auto) { return size_t(0); });
}

// At kernel entry, before stage 1: thread 0 starts the map's copy into
// shared memory (a staged map), completing on the header's mbarrier. The
// thread waits for it in ``decide``; stage 1's barriers order nothing
// here, since the copy's target is the cascade's own region.
template <class S>
__device__ __forceinline__ void stage_map(unsigned char* smem,
                                          const Args& c) {
  if (threadIdx.x != 0 || c.P > kSmemMapRows) return;
  unsigned char* ex = extra_base<S>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ex);
  long long* key = reinterpret_cast<long long*>(ex + 16);
  const uint32_t bytes = static_cast<uint32_t>(c.P) * 8;
  rl_tile::mbar_init(bar);
  rl_tile::mbar_expect_tx(bar, 2 * bytes);
  rl_tile::bulk_load(key, c.map_key, bytes, bar);
  rl_tile::bulk_load(key + c.P, c.map_tid, bytes, bar);
}

// Scope t's availability max(limit - max(est, 0), 0). Plain loads: a
// back folds into the counters after the routine.
__device__ __forceinline__ long long scope_avail(const Args& c, int t,
                                                 float frac) {
  long long est;
  if (c.cur != nullptr) {
    est = static_cast<const int32_t*>(c.counts)[t];
    if (c.slab != nullptr) {
      const int32_t b = c.slab[t];
      est += static_cast<long long>(
          ceilf(frac * static_cast<float>(b > 0 ? b : 0)));
    }
    est = est > 0 ? est : 0;
  } else {
    est = c.rolled ? 0 : static_cast<const long long*>(c.counts)[t];
  }
  const long long v = c.limit[t] - est;
  return v > 0 ? v : 0;
}

// The histogram keeps each scope's sum of int32 request counts x as two
// 32-bit limb sums, of x's low 16 bits (unsigned) and of x >> 16
// (signed), each added by a native 32-bit shared atomic (a 64-bit shared
// atomic add is a compare-and-swap loop). A scope takes at most
// kMaxCapacity = 8192 adds, so neither limb sum overflows (< 2^29 and
// within +-2^28), and lo + hi * 2^16 is the exact sum.
__device__ __forceinline__ long long hist_of(const View& v, int t) {
  return static_cast<long long>(static_cast<int32_t>(v.hi[t])) * 65536 +
         static_cast<long long>(v.lo[t]);
}

// A total of up to 8192 request counts (|x| < 2^44) in the limbs' form.
__device__ __forceinline__ void hist_set(const View& v, int t, long long x) {
  v.lo[t] = static_cast<uint32_t>(x) & 0xFFFFu;
  v.hi[t] = static_cast<uint32_t>(static_cast<int32_t>(x >> 16));
}

// hist[t] += x for t < T (x a sum of int32 counts whose limbs lo, hi the
// caller summed).
__device__ __forceinline__ void hist_add(const View& v, uint32_t t,
                                         uint32_t lo, int32_t hi,
                                         uint32_t T) {
  if (t >= T) return;
  if (lo != 0) atomicAdd(v.lo + t, lo);
  if (hi != 0) atomicAdd(v.hi + t, static_cast<uint32_t>(hi));
}

// hist[t] += x[k] for the thread's items, sorted by tenant (``tid(k)``):
// each run of one tenant among them is summed first and added once.
template <int kItems, class Tid, class X>
__device__ __forceinline__ void hist_runs(const View& v, Tid tid, X x,
                                          uint32_t T) {
  uint32_t lo = 0;
  int32_t hi = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int32_t xk = x(k);
    lo += static_cast<uint32_t>(xk) & 0xFFFFu;
    hi += xk >> 16;
    if (k + 1 == kItems || tid(k + 1) != tid(k)) {
      hist_add(v, tid(k), lo, hi, T);
      lo = 0;
      hi = 0;
    }
  }
}

// The block-wide sum (modulo 2^64) of every thread's ``part``, returned
// to every thread; ``partials`` holds a word a warp. Two barriers.
template <int kThreads>
__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long part, unsigned long long* partials) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xFFFFFFFFu, part, off);
  if ((threadIdx.x & 31) == 0) partials[threadIdx.x >> 5] = part;
  __syncthreads();
  unsigned long long total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partials[w];
  __syncthreads();
  return total;
}

// Greedy admission of n (0 for items out of the stage; item k of this
// thread at ns[k * kThreads + threadIdx.x], so that a warp's reads take
// one wavefront) against avail[tid] within each tid segment (``tp`` the
// items' tenants, two to a word; bit 15 of hs[...] at the same place
// marks a segment's head): the reference's _admit_dense (dense: int32
// sums) or segment.admit. Returns the verdicts as a bit mask.
template <class S>
__device__ __forceinline__ unsigned stage(typename S::Storage& tmp,
                                          const uint32_t (&tp)[(S::kItems + 1) /
                                                               2],
                                          const int32_t* ns,
                                          const uint16_t* hs,
                                          const long long* avail, bool dense,
                                          int iters) {
  constexpr int kThreads = S::kThreads, kItems = S::kItems;
  auto n = [&](int k) -> long long {
    return ns[k * kThreads + threadIdx.x];
  };
  auto tid = [&](int k) { return (tp[k / 2] >> (k % 2 * 16)) & 0xFFFFu; };
  auto head = [&](int k) { return hs[k * kThreads + threadIdx.x] >> 15; };
  // Which items fit under mask m: cons (the segment-exclusive sum of n
  // over m) + n <= avail. Up to 64 scopes the reference's sums are int32
  // (dense): a 32-bit scan gives their low 32 bits. Every call follows a
  // barrier (the scan storage's last use is over).
  auto fits = [&](unsigned m) {
    unsigned f = 0;
    if (dense) {
      rl_admit::Seg32 seg[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        seg[k].v = (m >> k) & 1u ? static_cast<uint32_t>(n(k)) : 0u;
        seg[k].head = head(k);
      }
      rl_admit::scan32<S>(tmp, seg);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long nk = n(k);
        const uint32_t e =
            seg[k].v - ((m >> k) & 1u ? static_cast<uint32_t>(nk) : 0u);
        const long long cons = static_cast<int32_t>(e);
        f |= static_cast<unsigned>(cons + nk <= avail[tid(k)]) << k;
      }
    } else {
      rl_admit::Seg seg[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        seg[k].v = (m >> k) & 1u ? static_cast<unsigned long long>(n(k))
                                 : 0ull;
        seg[k].head = head(k);
      }
      typename S::Scan(tmp.scan).InclusiveScan(seg, seg,
                                               rl_admit::SegSum());
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long nk = n(k);
        const unsigned long long e =
            seg[k].v - ((m >> k) & 1u ? static_cast<unsigned long long>(nk)
                                       : 0ull);
        f |= static_cast<unsigned>(static_cast<long long>(e) + nk <=
                                   avail[tid(k)])
             << k;
      }
    }
    return f;
  };
  __syncthreads();  // the scan storage's last use is over
  unsigned ok = (1u << kItems) - 1;
  bool fixed = false;
  for (int round = 0; round < iters && !fixed; ++round) {
    const unsigned f = fits(ok);
    const bool changed = f != ok;
    ok = f;
    fixed = !__syncthreads_or(changed);
  }
  if (!fixed) ok &= fits(ok);  // after the last round's barrier
  return ok;
}

// A decide() probe that records nothing (the products' builds).
struct NoProbe {
  NoProbe() = default;
  __device__ __forceinline__ explicit NoProbe(long long*) {}
  __device__ __forceinline__ void operator()(int) const {}
};

// The rows of the sorted key column ``key`` (P a power of two) for the
// queries q[k], as front.cuh's policy_row finds each: the largest row
// with key <= q if its key equals q, else -1. With ``top`` (P >= 64, the
// last key of each of 32 equal blocks) the descent first finds the block
// among the 32 (all keys of the blocks before it are <= q, the block's
// last key is > q), then descends within it; the kItems descents are
// interleaved so that their loads overlap.
template <int kItems, class KeyAt>
__device__ __forceinline__ void rows_of(KeyAt key, const long long* top,
                                        int P, const long long (&q)[kItems],
                                        int (&row)[kItems]) {
  int base[kItems];
  int span = P;
#pragma unroll
  for (int k = 0; k < kItems; ++k) base[k] = 0;
  if (top != nullptr) {
    span = P / 32;
#pragma unroll
    for (int k = 0; k < kItems; ++k) row[k] = -1;
    for (int step = 32; step >= 1; step >>= 1) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int cand = row[k] + step;
        const long long probe = top[cand < 32 ? cand : 31];
        row[k] = (cand < 32 && probe <= q[k]) ? cand : row[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) base[k] = (row[k] + 1) * span;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) row[k] = base[k] - 1;
  for (int step = span; step >= 1; step >>= 1) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int end = base[k] + span < P ? base[k] + span : P;
      const int cand = row[k] + step;
      const long long probe = key(cand < end ? cand : P - 1);
      row[k] = (cand < end && probe <= q[k]) ? cand : row[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int safe = row[k] > 0 ? row[k] : 0;
    row[k] = (row[k] >= 0 && key(safe) == q[k]) ? safe : -1;
  }
}

// Every thread of the block calls it, after stage 1 (tmp.u.out.allowed[i]
// holds request i's verdict, behind a barrier) and after stage_map at
// kernel entry. On return, after a barrier, hist_of(view, t) is the
// admitted mass of tenant t and of index T the total. Returns whether the
// batch was contended: then tmp.u.out.allowed holds the final mask (the
// union's other storage is spent), else it is unchanged and so is the
// union. ``probe(m)`` runs after each of its steps' barriers (the bench
// build times them).
template <class S, class Probe = NoProbe>
__device__ bool decide(typename S::Storage& tmp, unsigned char* smem,
                       const Args& c, const int64_t* h1, int B, int iters,
                       Probe probe = Probe()) {
  constexpr int kThreads = S::kThreads, kItems = S::kItems;
  __shared__ unsigned long long partials[32];
  __shared__ long long top[32];
  const View v = view<S>(tmp, smem, c);
  const int T = c.T, P = c.P;
  const bool staged = P <= kSmemMapRows;
  // 1. Tenant ids in batch order, request k * kThreads + threadIdx.x for
  //    the thread's k (coalesced loads). A staged map is searched through
  //    an index built here from its sorted keys: the first row of each of
  //    P buckets of the key's top bits, so that a query reads its
  //    bucket's ~1 row (a binary search's ~12 dependent loads a request
  //    on one SM hit one bank at its top levels); a larger map by a
  //    two-level descent in global memory.
  if (threadIdx.x == 0 && staged) rl_tile::mbar_wait(v.bar, 0);
  __syncthreads();
  const int pbits = __ffs(P) - 1;  // P a power of two
  // A key's bucket: its top log2(P) bits in signed order (PAD_KEY, the
  // padding's, past every bucket).
  auto bucket_of = [pbits, P](long long key) {
    return key == kPadKey
               ? P
               : static_cast<int>((static_cast<unsigned long long>(key) ^
                                   (1ull << 63)) >>
                                  (64 - pbits));
  };
  if (staged) {
    // start[b] = the first row of bucket b or after it; row P stands for
    // the end. Each row fills the buckets from its predecessor's up to
    // its own: every entry is written once, with no atomics.
    for (int r = threadIdx.x; r <= P; r += kThreads) {
      const int b = r < P ? bucket_of(v.map_key[r]) : P;
      const int a = r > 0 ? bucket_of(v.map_key[r - 1]) + 1 : 0;
      for (int x = a; x <= b; ++x) v.start[x] = static_cast<uint16_t>(r);
    }
  } else if (threadIdx.x < 32) {
    top[threadIdx.x] = __ldg(c.map_key + (threadIdx.x + 1) * (P / 32) - 1);
  }
  __syncthreads();
  probe(0);
  // In chunks of up to eight requests a thread (registers).
  constexpr int kIds = kItems < 8 ? kItems : 8;
#pragma unroll
  for (int k0 = 0; k0 < kItems; k0 += kIds) {
    long long q[kIds];
    int row[kIds];
#pragma unroll
    for (int k = 0; k < kIds; ++k) {
      const int i = (k0 + k) * kThreads + threadIdx.x;
      q[k] = i < B ? static_cast<long long>(
                         (static_cast<uint64_t>(static_cast<uint32_t>(
                              __ldg(h1 + i))) << 32) |
                         static_cast<uint32_t>(__ldg(c.h2 + i)))
                   : 0;
    }
    if (staged) {
      int first[kIds], end[kIds];
#pragma unroll
      for (int k = 0; k < kIds; ++k) {
        const int b = bucket_of(q[k]);
        end[k] = b < P ? v.start[b + 1] : P;
        first[k] = b < P ? v.start[b] : P - 1;
      }
      // The bucket's last row first (most buckets hold one), for every
      // query at once; then the rest of a longer bucket, downwards.
#pragma unroll
      for (int k = 0; k < kIds; ++k)
        row[k] = end[k] > first[k] && v.map_key[end[k] - 1] == q[k]
                     ? end[k] - 1
                     : -1;
#pragma unroll
      for (int k = 0; k < kIds; ++k) {
        for (int r = end[k] - 2; row[k] < 0 && r >= first[k]; --r)
          if (v.map_key[r] == q[k]) row[k] = r;
      }
    } else {
      constexpr int kChunk = kIds < 4 ? kIds : 4;
      const long long* gkey = c.map_key;
#pragma unroll
      for (int c0 = 0; c0 < kIds; c0 += kChunk) {
        long long qc[kChunk];
        int rc[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) qc[k] = q[c0 + k];
        rows_of<kChunk>([gkey](int j) { return __ldg(gkey + j); }, top, P,
                        qc, rc);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) row[c0 + k] = rc[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kIds; ++k) {
      const int i = (k0 + k) * kThreads + threadIdx.x;
      if (i >= B) continue;
      long long t = 0;
      if (row[k] >= 0)
        t = staged ? v.map_tid[row[k]] : __ldg(c.map_tid + row[k]);
      t = t < 0 ? 0 : (t > T - 1 ? T - 1 : t);
      v.ids[i] = static_cast<uint16_t>(t);
    }
  }
  __syncthreads();  // the map is spent: its region takes the scope arrays
  probe(1);
  // 2. Per scope, once: the availability, the histogram's limbs zeroed.
  const float frac = c.slab != nullptr ? *c.frac : 0.0f;
  for (int t = threadIdx.x; t <= T; t += kThreads) {
    v.avail[t] = scope_avail(c, t, frac);
    v.lo[t] = v.hi[t] = 0;
  }
  __syncthreads();
  probe(2);
  // 3. The stage-1 survivors' demand per tenant and in all; the
  //    uncontended test.
  bool negative = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int32_t x = i < B && tmp.u.out.allowed[i] ? __ldg(c.n + i) : 0;
    negative = negative || x < 0;
    if (i < B)
      hist_add(v, v.ids[i], static_cast<uint32_t>(x) & 0xFFFFu, x >> 16, T);
  }
  __syncthreads();
  bool over = false;
  unsigned long long part = 0;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const long long d = hist_of(v, t);
    over = over || d > v.avail[t];
    part += static_cast<unsigned long long>(d);
  }
  over = __syncthreads_or(over);
  // With every n >= 0, a tenant whose demand fits its availability admits
  // every survivor at every prefix (and so does the global scope): a
  // stage whose scopes all fit is the identity.
  negative = __syncthreads_or(negative);
  const long long total2 =
      static_cast<long long>(block_sum<kThreads>(part, partials));
  if (threadIdx.x == 0) hist_set(v, T, total2);
  const long long G = v.avail[T];
  probe(3);
  if (!over && total2 <= G) {
    __syncthreads();
    return false;
  }

  // 4. Contended: the batch sorted stably by tenant.
  uint32_t key[kItems];
  int val[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    const bool valid = j < B;
    key[k] = valid ? v.ids[j] : static_cast<uint32_t>(T);
    val[k] = j | (valid && tmp.u.out.allowed[j] ? kVerdictBit : 0);
  }
  int bits = 1;
  while ((1 << bits) <= T) ++bits;
  __syncthreads();  // ids and verdicts read: the sort may take their space
  typename S::Sort(tmp.u.sort).Sort(key, val, 0, bits);
  __syncthreads();
  probe(4);
  unsigned alive = 0;
  // The items' tenants, two to a word; their batch indices and segment
  // heads (bit 15) wait in the spent ids array and their n (0 unless
  // alive) in the union, both striped (item k of thread t at
  // k * kThreads + t).
  uint32_t tp[(kItems + 1) / 2];
  int32_t* ns = reinterpret_cast<int32_t*>(&tmp.u);
  {
    int head[kItems];
    typename S::Heads(tmp.u.heads).FlagHeads(head, key, rl_admit::Differ());
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k % 2 == 0) tp[k / 2] = key[k];
      else tp[k / 2] |= key[k] << 16;
      alive |= static_cast<unsigned>((val[k] & kVerdictBit) != 0) << k;
      val[k] = (val[k] & kIdxMask) | (head[k] ? kVerdictBit : 0);
    }
  }
  __syncthreads();  // the heads' storage is spent
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t idx = static_cast<uint32_t>(val[k]) & kIdxMask;
    v.ids[k * kThreads + threadIdx.x] = static_cast<uint16_t>(val[k]);
    ns[k * kThreads + threadIdx.x] =
        (alive >> k) & 1u ? __ldg(c.n + idx) : 0;
  }
  // The thread's own slots: read and written by it alone from here on.
  auto nk = [&](int k) { return ns[k * kThreads + threadIdx.x]; };
  auto keep = [&](unsigned ok) {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (!((ok >> k) & 1u)) ns[k * kThreads + threadIdx.x] = 0;
  };
  auto tid = [&](int k) { return (tp[k / 2] >> (k % 2 * 16)) & 0xFFFFu; };
  const bool dense = T + 1 <= 64;
  //    Stage 2: tenant scope among the survivors (skipped when every
  //    tenant's demand fits).
  if (over || negative) {
    const unsigned ok = stage<S>(tmp, tp, ns, v.ids, v.avail, dense, iters);
    alive &= ok;
    keep(ok);
  }
  probe(5);
  //    The demand after stage 2 (every thread has read the histogram:
  //    block_sum's barriers).
  for (int t = threadIdx.x; t <= T; t += kThreads) v.lo[t] = v.hi[t] = 0;
  __syncthreads();
  hist_runs<kItems>(v, tid, nk, T);
  __syncthreads();
  probe(6);
  //    Stage 3's caps, per tenant: the fair share of the global scope.
  unsigned long long wpart = 0, dpart = 0;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const long long d = hist_of(v, t);
    dpart += static_cast<unsigned long long>(d);
    if (d > 0) wpart += static_cast<unsigned long long>(__ldg(c.weight + t));
  }
  const long long total =
      static_cast<long long>(block_sum<kThreads>(dpart, partials));
  const unsigned long long wsum = block_sum<kThreads>(wpart, partials);
  const long long ws = wsum > 0 ? static_cast<long long>(wsum) : 1;
  if (total > G) {
    for (int t = threadIdx.x; t < T; t += kThreads) {
      const long long d = hist_of(v, t);
      const long long w = __ldg(c.weight + t);
      const unsigned long long uprod =
          static_cast<unsigned long long>(G) *
          static_cast<unsigned long long>(w);
      // G >= 0: with w > 0 and G * w below 2^63 the share is >= 0, so a
      // tenant without demand gets min(0, share) = 0 with no division.
      const bool small = w > 0 &&
                         __umul64hi(static_cast<unsigned long long>(G),
                                    static_cast<unsigned long long>(w)) ==
                             0 &&
                         (uprod >> 63) == 0;
      long long cap = 0;
      if (d != 0 || !small) {
        const long long prod = static_cast<long long>(uprod);
        long long share = prod / ws;
        share -= (prod % ws != 0 && prod < 0) ? 1 : 0;  // floor, as torch
        cap = d < share ? d : share;
      }
      v.avail[t] = cap;
    }
  } else {
    for (int t = threadIdx.x; t < T; t += kThreads) v.avail[t] = hist_of(v, t);
  }
  __syncthreads();
  probe(7);
  //    Stage 3 (skipped when the total fits: every cap is the demand).
  if (total > G || negative) {
    const unsigned ok = stage<S>(tmp, tp, ns, v.ids, v.avail, dense, iters);
    alive &= ok;
    keep(ok);
  }
  probe(8);
  // 5. The admitted mass per tenant and in all, and the final mask in
  //    batch order.
  for (int t = threadIdx.x; t <= T; t += kThreads) v.lo[t] = v.hi[t] = 0;
  __syncthreads();
  hist_runs<kItems>(v, tid, nk, T);
  unsigned long long mine = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    mine += static_cast<unsigned long long>(static_cast<long long>(nk(k)));
    const int i = v.ids[k * kThreads + threadIdx.x] & kIdxMask;
    if (i < B) tmp.u.out.allowed[i] = (alive >> k) & 1u;
  }
  const long long admitted =
      static_cast<long long>(block_sum<kThreads>(mine, partials));
  if (threadIdx.x == 0) hist_set(v, T, admitted);
  __syncthreads();
  probe(9);
  return true;
}

// A back's admission operands, read again for the recount.
template <class Q>
struct Reread {
  const Q* n;
  const Q* avail;
  __device__ __forceinline__ Q n_of(int i) const { return __ldg(n + i); }
  __device__ __forceinline__ Q avail_of(int i) const {
    return __ldg(avail + i);
  }
};

// The cascade inside a back, after stage 1 (rl_admit::admit_packed,
// whose items ``p`` hold the key scope's verdicts and tmp.u.out its
// results in batch order): ``decide``, then, if it changed the mask, the
// key scope's consumption recomputed under the final mask (one more
// segmented scan over the h1 segments, with n and avail read again
// through ``ops``), so that tmp.u.out holds the final allowed and seen in
// batch order and ``p`` the final mask, exactly as rl_admit::admit_packed
// leaves them; then the histogram folded into the scope counters.
// ``smem`` is the launch's dynamic shared memory.
template <class S, class Q>
__device__ void in_back(typename S::Storage& tmp, unsigned char* smem,
                        rl_admit::Packed<S::kItems>& p, const Args& c,
                        const int64_t* h1, int B, int iters,
                        const Reread<Q>& ops) {
  constexpr int kItems = S::kItems;
  const View v = view<S>(tmp, smem, c);
  // Stage 1's items wait in shared memory while the routine runs: only
  // this thread reads its own back, after ``decide``'s barriers.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v.stash[threadIdx.x * kItems + k] = static_cast<uint16_t>(
        static_cast<uint32_t>(p.idx[k]) | (p.is_head(k) ? kHeadBit : 0) |
        (p.is_tail(k) ? kTailBit : 0) | (p.is_allowed(k) ? kVerdictBit : 0));
  }
  const bool contended = decide<S>(tmp, smem, c, h1, B, iters);
  p.head = p.tail = p.allowed = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t w = v.stash[threadIdx.x * kItems + k];
    const int i = static_cast<int>(w & kIdxMask);
    p.idx[k] = i;
    p.head |= static_cast<unsigned>((w & kHeadBit) != 0) << k;
    p.tail |= static_cast<unsigned>((w & kTailBit) != 0) << k;
    const bool ok = contended ? i < B && tmp.u.out.allowed[i]
                              : (w & kVerdictBit) != 0;
    p.allowed |= static_cast<unsigned>(ok) << k;
  }
  if (contended) {
    rl_admit::exclusive_each<S, Q>(
        tmp, p,
        [&](int k) {
          const int i = p.idx[k];
          return i < B ? ops.n_of(i) : Q(0);
        },
        [&](int k, Q cons) {
          const int i = p.idx[k];
          if (i < B) {
            tmp.u.out.seen[i] = rl_admit::sub(ops.avail_of(i), cons);
            tmp.u.out.allowed[i] = p.is_allowed(k);
          }
        });
  }
  // The fold: int32 adds wrap (the reference casts the histogram to
  // int32); the bucket's counters restart from 0 in a new window.
  for (int t = threadIdx.x; t <= c.T; t += S::kThreads) {
    const long long x = hist_of(v, t);
    if (c.cur != nullptr) {
      if (x != 0) {
        const uint32_t x32 = static_cast<uint32_t>(x);
        int32_t* tot = static_cast<int32_t*>(c.counts);
        c.cur[t] = static_cast<int32_t>(static_cast<uint32_t>(c.cur[t]) + x32);
        tot[t] = static_cast<int32_t>(static_cast<uint32_t>(tot[t]) + x32);
      }
    } else {
      long long* cnt = static_cast<long long*>(c.counts);
      const long long base = c.rolled ? 0 : cnt[t];
      cnt[t] = static_cast<long long>(static_cast<unsigned long long>(base) +
                                      static_cast<unsigned long long>(x));
    }
  }
  __syncthreads();
}

}  // namespace rl_cascade
