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
// Design. The block holds the batch; a request's tenant id is its group:
//   1. tids: each thread binary-searches its requests' packed (h1, h2) key
//      in the sorted key->tenant map (front.cuh's policy search, from
//      global memory; misses land on tenant 0; clamped to [0, T-1]);
//   2. a stable block radix sort of (tid, batch index) on log2(T) + 1 bits
//      (padding past the batch takes key T, after every tenant), then the
//      segment heads and tails (admit.cuh's CUB building blocks, in the
//      storage admit.cuh's stage 1 no longer needs);
//   3. the stage-2 demand per tenant is a segmented scan of the stage-1
//      survivors' n: each segment's tail holds its tenant's total and
//      writes it to a shared (T+1,) int64 array. When every tenant's
//      demand fits its availability and the total fits the global one,
//      the final mask is the stage-1 mask (the reference's uncontended
//      branch) and the demand is the histogram;
//   4. otherwise stage 2 and stage 3 are each the greedy fixpoint of
//      admit.cuh (iters rounds, fewer at a fixed point, then the safety
//      intersection) over the tid segments, against the tenant's
//      availability, then against its cap min(demand, G*weight // sum of
//      active weights) when the survivors' total exceeds G;
//   5. the admitted mass per tenant, a last segmented scan, leaves the
//      histogram in the shared array (global total at index T) and the
//      final mask in the shared per-request flags.
// Limits, weights and the scope counters are read from global memory (a
// few per tenant present); only the flags (one byte a request) and the
// (T+1,) array take shared memory beyond stage 1's, 41 KB at T = 4096:
// at B = 8192 (1024 threads x 8) the stage-1 storage's 128 KB table
// union, the scan storage and these 41 KB come to ~170 KB of the 227 KB
// a block may take (add_back's 16 KB of static edges included, ~186 KB).
//
// Integers as the reference has them. All quantities are int64 request
// counts. Up to 64 scopes (T + 1 <= 64) the reference's per-tenant prefix
// sums are int32 cumsums (_admit_dense), compared in int64 after the
// wrap; above, int64 (segment.admit). The scans here are 64-bit, and in
// the dense case each exclusive sum keeps its low 32 bits, sign-extended:
// the same value, since the int32 cumsum wraps modulo 2^32 in any order.
// The windowed tenant boundary term is ceil(frac * f32(max(b, 0))) in f32
// (one multiply; the library is built with -fmad=false), taken as int64.
//
// Bound on an H100: each request's h1, h2, n and stage-1 verdict read and
// its verdict written, the map searched, and a few int64s per tenant
// present: ~0.1 MB at B = 4096 (~0.03 us at 3.35 TB/s), far below one
// launch. Inside a back it adds one sort and a handful of block scans to
// the launch; alone it is one block on one SM.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "admit.cuh"

namespace rl_cascade {

// The scopes' operands. Windowed (cur != nullptr): counts is tn_totals
// int32 (T+1), cur tn_cur, both folded with the histogram; slab the tenant
// boundary sub-window (nullptr in fixed mode) weighted by *frac. Bucket
// (cur == nullptr): counts is tn_counts int64 (T+1), read as 0 and
// replaced when ``rolled``; retry_us is the time to the next window for
// rows the cascade denied. limit/weight int64 (T+1), the map's key/tid
// columns int64 (P, sorted, PAD_KEY-padded).
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

// Shared memory beyond the stage-1 routine's storage: one flag a request
// (sized for the largest shape), then the (T+1,) int64 array.
constexpr size_t kFlagBytes = rl_admit::kMaxCapacity;

inline size_t extra_bytes(int T) {
  return kFlagBytes + static_cast<size_t>(T + 1) * 8;
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
  return c.T >= 2 && c.T <= 4096 && (c.T & (c.T - 1)) == 0 && c.P >= 2 &&
         (c.P & (c.P - 1)) == 0 && c.map_key != nullptr &&
         c.map_tid != nullptr &&
         c.limit != nullptr && c.weight != nullptr && c.counts != nullptr &&
         (c.slab == nullptr || c.frac != nullptr);
}

// The request's tenant: the largest map row <= the packed key, if equal.
__device__ __forceinline__ uint32_t tid_of(const Args& c, uint32_t h1,
                                           uint32_t h2) {
  const long long q =
      static_cast<long long>((static_cast<uint64_t>(h1) << 32) | h2);
  int idx = -1;
  for (int step = c.P; step >= 1; step >>= 1) {
    const int cand = idx + step;
    const long long probe = __ldg(c.map_key + (cand < c.P ? cand : c.P - 1));
    idx = (cand < c.P && probe <= q) ? cand : idx;
  }
  long long t = 0;
  if (idx >= 0 && __ldg(c.map_key + idx) == q) t = __ldg(c.map_tid + idx);
  t = t < 0 ? 0 : (t > c.T - 1 ? c.T - 1 : t);
  return static_cast<uint32_t>(t);
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

// incl = the segmented inclusive sum of x (>= 0) over the tid segments,
// modulo 2^64.
template <class S>
__device__ __forceinline__ void seg_sum(typename S::Storage& tmp,
                                        const long long (&x)[S::kItems],
                                        const int (&head)[S::kItems],
                                        unsigned long long (&incl)[S::kItems]) {
  rl_admit::Seg seg[S::kItems];
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) {
    seg[k].v = static_cast<unsigned long long>(x[k]);
    seg[k].head = head[k];
  }
  __syncthreads();  // the scan storage's last use is over
  typename S::Scan(tmp.scan).InclusiveScan(seg, seg, rl_admit::SegSum());
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) incl[k] = seg[k].v;
}

// Greedy admission of n against avail within each tid segment: the
// reference's _admit_dense (dense: int32 sums) or segment.admit.
template <class S>
__device__ __forceinline__ void stage(typename S::Storage& tmp,
                                      const long long (&n)[S::kItems],
                                      const long long (&avail)[S::kItems],
                                      const int (&head)[S::kItems],
                                      bool dense, int iters,
                                      bool (&ok)[S::kItems]) {
  constexpr int kItems = S::kItems;
  long long x[kItems];
  unsigned long long incl[kItems];
  long long cons[kItems];
  auto exclusive = [&]() {
#pragma unroll
    for (int k = 0; k < kItems; ++k) x[k] = ok[k] ? n[k] : 0;
    seg_sum<S>(tmp, x, head, incl);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned long long e =
          incl[k] - static_cast<unsigned long long>(x[k]);
      cons[k] = dense ? static_cast<long long>(static_cast<int32_t>(
                            static_cast<uint32_t>(e)))
                      : static_cast<long long>(e);
    }
  };
#pragma unroll
  for (int k = 0; k < kItems; ++k) ok[k] = true;
  bool fixed = false;
  for (int round = 0; round < iters && !fixed; ++round) {
    exclusive();
    bool changed = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool fits = cons[k] + n[k] <= avail[k];
      changed = changed || fits != ok[k];
      ok[k] = fits;
    }
    fixed = !__syncthreads_or(changed);
  }
  if (!fixed) {
    exclusive();
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      ok[k] = ok[k] && cons[k] + n[k] <= avail[k];
  }
}

// Every thread of the block calls it, with tmp.u free (behind a barrier)
// and flag[i] the stage-1 verdict of request i < B. On return (after a
// barrier) flag[i] is the final verdict and hist[t] the admitted mass of
// tenant t, hist[T] the total.
template <class S>
__device__ void cascade(typename S::Storage& tmp, unsigned char* flag,
                        long long* hist, const Args& c, const int64_t* h1,
                        int B, int iters) {
  constexpr int kThreads = S::kThreads, kItems = S::kItems;
  __shared__ unsigned long long total2, total3, wsum, admitted;
  const int T = c.T;
  const bool dense = T + 1 <= 64;
  const float frac = c.slab != nullptr ? *c.frac : 0.0f;
  for (int t = threadIdx.x; t <= T; t += kThreads) hist[t] = 0;
  if (threadIdx.x == 0) total2 = total3 = wsum = admitted = 0;

  // 1-2. Tenant ids in batch order, sorted stably.
  uint32_t key[kItems];
  int idx[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    idx[k] = j;
    key[k] = j < B ? tid_of(c, static_cast<uint32_t>(__ldg(h1 + j)),
                            static_cast<uint32_t>(__ldg(c.h2 + j)))
                   : static_cast<uint32_t>(T);
  }
  int bits = 1;
  while ((1 << bits) <= T) ++bits;
  __syncthreads();
  typename S::Sort(tmp.u.sort).Sort(key, idx, 0, bits);
  __syncthreads();
  int head[kItems], tail[kItems];
  typename S::Heads(tmp.u.heads).FlagHeadsAndTails(head, tail, key,
                                                   rl_admit::Differ());
  long long n[kItems], x[kItems];
  bool alive[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = idx[k];
    const bool valid = i < B;
    n[k] = valid ? static_cast<long long>(__ldg(c.n + i)) : 0;
    alive[k] = valid && flag[i];
    x[k] = alive[k] ? n[k] : 0;
  }

  // 3. The stage-1 survivors' demand per tenant; the uncontended test.
  unsigned long long incl[kItems];
  seg_sum<S>(tmp, x, head, incl);
  bool over = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (tail[k] && key[k] < static_cast<uint32_t>(T)) {
      const long long d = static_cast<long long>(incl[k]);
      hist[key[k]] = d;
      atomicAdd(&total2, incl[k]);
      over = over || d > scope_avail(c, key[k], frac);
    }
  }
  over = __syncthreads_or(over);
  const long long G = scope_avail(c, T, frac);
  if (!over && static_cast<long long>(total2) <= G) {
    if (threadIdx.x == 0) hist[T] = static_cast<long long>(total2);
    __syncthreads();
    return;
  }

  // 4. Stage 2: tenant scope among the survivors.
  long long avail[kItems];
  bool ok[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    avail[k] = key[k] < static_cast<uint32_t>(T) ? scope_avail(c, key[k], frac)
                                                 : 0;
  stage<S>(tmp, x, avail, head, dense, iters, ok);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    alive[k] = alive[k] && ok[k];
    x[k] = alive[k] ? n[k] : 0;
  }
  //    Stage 3: the global scope's fair share of the survivors' demand.
  seg_sum<S>(tmp, x, head, incl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (tail[k] && key[k] < static_cast<uint32_t>(T)) {
      hist[key[k]] = static_cast<long long>(incl[k]);
      atomicAdd(&total3, incl[k]);
      if (static_cast<long long>(incl[k]) > 0)
        atomicAdd(&wsum, static_cast<unsigned long long>(
                             __ldg(c.weight + key[k])));
    }
  }
  __syncthreads();
  const long long total = static_cast<long long>(total3);
  const long long ws = wsum > 0 ? static_cast<long long>(wsum) : 1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (key[k] < static_cast<uint32_t>(T)) {
      const long long d = hist[key[k]];
      const long long share = G * __ldg(c.weight + key[k]) / ws;
      avail[k] = total > G ? (d < share ? d : share) : d;
    } else {
      avail[k] = 0;
    }
  }
  stage<S>(tmp, x, avail, head, dense, iters, ok);

  // 5. The final mask and the admitted mass per tenant.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    alive[k] = alive[k] && ok[k];
    x[k] = alive[k] ? n[k] : 0;
  }
  seg_sum<S>(tmp, x, head, incl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (tail[k] && key[k] < static_cast<uint32_t>(T)) {
      hist[key[k]] = static_cast<long long>(incl[k]);
      atomicAdd(&admitted, incl[k]);
    }
    if (idx[k] < B) flag[idx[k]] = alive[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) hist[T] = static_cast<long long>(admitted);
  __syncthreads();
}

// The cascade inside a back, after stage 1 (rl_admit::admit, whose
// sorted items ``s`` hold the key scope's verdicts): the cascade, then
// the key scope's consumption recomputed under the final mask (one more
// segmented scan over the h1 segments, sorted in registers), so that
// tmp.u.out holds the final allowed and seen in batch order and s the
// final mask, exactly as rl_admit::admit leaves them; then the histogram
// folded into the scope counters. ``smem`` is the dynamic shared memory
// past S::Storage (extra_bytes(T)).
template <class S, class Q>
__device__ void in_back(typename S::Storage& tmp, unsigned char* smem,
                        rl_admit::Sorted<Q, S::kItems>& s, const Args& c,
                        const int64_t* h1, int B, int iters) {
  unsigned char* flag = smem;
  long long* hist = reinterpret_cast<long long*>(smem + kFlagBytes);
#pragma unroll
  for (int k = 0; k < S::kItems; ++k)
    if (s.idx[k] < B) flag[s.idx[k]] = s.allowed[k];
  __syncthreads();
  cascade<S>(tmp, flag, hist, c, h1, B, iters);
#pragma unroll
  for (int k = 0; k < S::kItems; ++k)
    s.allowed[k] = s.idx[k] < B && flag[s.idx[k]];
  Q cons[S::kItems];
  rl_admit::exclusive<S>(tmp, s, cons);
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) {
    const int i = s.idx[k];
    if (i < B) {
      tmp.u.out.seen[i] = rl_admit::sub(s.avail[k], cons[k]);
      tmp.u.out.allowed[i] = s.allowed[k];
    }
  }
  // The fold: int32 adds wrap (the reference casts the histogram to
  // int32); the bucket's counters restart from 0 in a new window.
  for (int t = threadIdx.x; t <= c.T; t += S::kThreads) {
    const long long v = hist[t];
    if (c.cur != nullptr) {
      if (v != 0) {
        const uint32_t v32 = static_cast<uint32_t>(v);
        int32_t* tot = static_cast<int32_t*>(c.counts);
        c.cur[t] = static_cast<int32_t>(static_cast<uint32_t>(c.cur[t]) + v32);
        tot[t] = static_cast<int32_t>(static_cast<uint32_t>(tot[t]) + v32);
      }
    } else {
      long long* cnt = static_cast<long long*>(c.counts);
      const long long base = c.rolled ? 0 : cnt[t];
      cnt[t] = static_cast<long long>(static_cast<unsigned long long>(base) +
                                      static_cast<unsigned long long>(v));
    }
  }
  __syncthreads();
}

}  // namespace rl_cascade
