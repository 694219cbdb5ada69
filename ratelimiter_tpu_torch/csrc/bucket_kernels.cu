// Hand-written Hopper kernels for the sketched token bucket's step.
//
// They replace the two Pallas kernels of the JAX package's bucket step
// (ratelimiter_tpu/ops/pallas_sketch.py):
//
//   bucket_front     <- bucket_estimate / _bucket_estimate_kernel, with
//                       the step's hashing, policy lookup, available quota
//                       and request units around it
//   bucket_update    <- bucket_update / _bucket_update_kernel
//   bucket_admit     <- the step's admission (ops/segment.admit, int64),
//                       consumed, remaining and retry_us (ahead of
//                       bucket_update; replaces no TPU kernel)
//
// The Pallas kernels grid sequentially over the d sketch rows and keep a
// whole (w,) row in VMEM. Here blocks run in parallel and in no order.
// bucket_front: one thread per key (front.cuh) hashes it, issues its d
// debt loads, searches the policy table while they are in flight, folds
// the decayed min over rows in row order and writes est, avail and the
// request's micro-token units; launch-bound (~0.3 MB at B=4096, d=4), it
// replaces ~50 launches of the step around the estimate with one.
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
// bucket_admit: without the cascade (the main path's), ONE cluster of
// blocks partitions the batch's keys over its blocks through distributed
// shared memory and each block admits the keys it owns
// (admit_cluster.cuh; one block at and below the entry's small-batch
// size); with it, ONE block holds the whole batch and runs the admission
// routine of admit.cuh in int64 (group ids through a shared-memory hash
// table, a block radix sort of the ids, then iters + 2 segmented block
// scans). Either then writes in batch order allowed, consumed, remaining =
// floor((seen - used) / 10^6) and retry_us = where(allowed, 0,
// -floor(-deficit * rate_den / rate_num)) with deficit = max(n_units -
// seen, 0) (ratelimiter_tpu_torch/ops/bucket_kernels.py; the JAX package's
// ops/bucket_kernels.py). Both divisions are torch's floor division, not
// C's truncation, and every product and difference wraps modulo 2^64 as
// torch's int64 does: the kernel multiplies and subtracts in uint64_t. Its
// bound is ~0.2 MB at B=4096 (~0.06 us), far below one launch: the design
// replaces the ~90 launches of the plain admission and epilogue with one,
// on one SM (or a cluster's few).
//
// With the hierarchy cascade (tenants > 0), bucket_admit runs a
// compile-time variant (kCasc): cascade.cuh's routine in the same block
// after admission (the tenant and global scopes are fixed-window request
// counters, tn_counts, zeroed when the step's window is later than
// theirs), then the epilogue reads the final mask, and a row the key
// scope admits but the cascade denies retries at the scope window's end.
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
// in uint32 arithmetic; h1/h2 are int64 holding 0..2^32-1. The decay
// arrives by value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "admit_cluster.cuh"
#include "cascade.cuh"
#include "front.cuh"
#include "tile_owner.cuh"

namespace {

constexpr long long kCap = 1LL << 61;
constexpr long long kMicros = 1000000;

struct BucketFront {
  const long long* debt;
  long long decay;
  rl_front::Keys keys;
  const int32_t* n;       // nullptr: est only (the reset)
  rl_front::Policy policy;
  long long* est;         // min over rows of max(0, debt - decay)
  long long* avail;       // max(limit * 10^6 - est, 0)
  long long* n_units;     // n * 10^6
  int B, d, w;
};

// Integers stay integers: every quantity is an exact int64 (limits are
// below 2^42 / 10^6, debts in [0, 2^61], decay below 2^63).
template <int kTable, int kDepth>
__global__ void __launch_bounds__(rl_front::kMaxThreads)
    bucket_front_kernel(const BucketFront a) {
  constexpr int kRows = kDepth != 0 ? kDepth : rl_front::kMaxDepth;
  extern __shared__ __align__(16) long long table[];
  __shared__ __align__(8) uint64_t bar;
  const long long* keys = rl_front::stage_table<kTable>(a.policy, table, &bar);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) {
    rl_front::drain_table<kTable>(&bar);
    return;
  }
  uint32_t h1, h2;
  rl_front::halves(a.keys, i, h1, h2);
  // Every cell load is issued before the policy search and the fold.
  long long x[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDepth != 0 || r < a.d)
      x[r] = __ldg(a.debt + rl_front::cell(h1, h2, r, a.w));
  }
  const int32_t n = a.n != nullptr ? __ldg(a.n + i) : 0;
  const long long lim =
      rl_front::policy_limit<kTable>(a.policy, keys, &bar, h1, h2);
  long long est = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDepth != 0 || r < a.d) {
      long long e = x[r] - a.decay;
      e = e > 0 ? e : 0;
      est = (r == 0 || e < est) ? e : est;
    }
  }
  a.est[i] = est;
  if (a.n != nullptr) {
    const long long avail = lim * kMicros - est;
    a.avail[i] = avail > 0 ? avail : 0;
    a.n_units[i] = static_cast<long long>(n) * kMicros;
  }
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

// floor(a / b) for b > 0, as torch's int64 floor division.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Division by a divisor fixed for a launch (the rate's numerator) as a
// multiply: libdivide's branch-free unsigned scheme (ridiculousfish's
// libdivide, ``libdivide_u64_branchfree``), exact for every 64-bit
// dividend; shift < 0 (d == 1) divides by itself. The host wrapper
// computes magic and shift once a launch (ops/bucket_cuda.py,
// ``divider``, checked against exact floor division on the CPU): a 64-bit
// division on the card is a long dependent sequence, and one block may
// hold a hot key's thousands of denied requests.
struct Divider {
  unsigned long long magic;
  int shift;
};

__device__ __forceinline__ unsigned long long udiv(unsigned long long n,
                                                   const Divider& v) {
  if (v.shift < 0) return n;
  const unsigned long long q = __umul64hi(v.magic, n);
  return (((n - q) >> 1) + q) >> v.shift;
}

// floor(a / d), as torch's int64 floor division: for a < 0,
// -((-a - 1) / d) - 1, with -a - 1 taken as ~a (no overflow at INT64_MIN).
__device__ __forceinline__ long long floor_div(long long a,
                                              const Divider& v) {
  if (a >= 0)
    return static_cast<long long>(udiv(static_cast<unsigned long long>(a), v));
  const unsigned long long u = ~static_cast<unsigned long long>(a);
  return -static_cast<long long>(udiv(u, v)) - 1;
}

struct BucketAdmit {
  const int64_t* h1;
  const long long* n_units;
  const long long* avail;
  bool* allowed;
  long long* consumed;
  long long* remaining;
  long long* retry_us;
  long long rate_den;  // > 0
  Divider by_num;      // the rate's numerator (> 0)
  int B, iters;
};

// Request i's results from its verdict ``ok``, ``seen`` and n_units
// ``n``: allowed, consumed, remaining and retry_us; with the cascade
// (kCasc), a row the key scope admits (no deficit) but the cascade denied
// retries at ``casc_retry``, when the tenant/global window resets.
template <bool kCasc>
__device__ __forceinline__ void write_results(const BucketAdmit& a, int i,
                                              bool ok, long long seen,
                                              long long n,
                                              long long casc_retry) {
  const long long used = ok ? n : 0;
  a.allowed[i] = ok;
  a.consumed[i] = used;
  a.remaining[i] = floor_div(rl_admit::sub(seen, used), kMicros);
  // An admitted request retries at 0; only a denied one pays the division.
  long long retry = 0;
  if (!ok) {
    long long deficit = rl_admit::sub(n, seen);
    deficit = deficit > 0 ? deficit : 0;
    // -((-deficit * rate_den) // rate_num), wrapping as torch's int64.
    const long long prod = static_cast<long long>(
        (0ull - static_cast<unsigned long long>(deficit)) *
        static_cast<unsigned long long>(a.rate_den));
    const long long q = floor_div(prod, a.by_num);
    retry = static_cast<long long>(0ull - static_cast<unsigned long long>(q));
    if constexpr (kCasc) retry = deficit <= 0 ? casc_retry : retry;
  }
  a.retry_us[i] = retry;
}

template <class S, bool kCasc>
__global__ void __launch_bounds__(S::kThreads, 1)
    bucket_admit_kernel(const rl_cascade::Operands<kCasc, BucketAdmit> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  // The cascade build: its map's copy lands while stage 1 (in the packed
  // form) runs; stages 2 and 3 in this block (the tenant counters are
  // fixed-window request counts), then the epilogue reads the final mask.
  if constexpr (kCasc) {
    rl_admit::Packed<S::kItems> p;
    rl_cascade::stage_map<S>(smem, a.casc);
    rl_admit::admit_packed<S>(tmp, a.h1, a.n_units, a.avail, a.B, a.iters,
                              p);
    rl_cascade::in_back<S, long long>(tmp, smem, p, a.casc, a.h1, a.B,
                                      a.iters, {a.n_units, a.avail});
  } else {
    rl_admit::Sorted<long long, S::kItems> s;
    rl_admit::admit<S>(tmp, a.h1, a.n_units, a.avail, a.B, a.iters, s);
  }
  // In batch order: coalesced reads and writes.
  for (int i = threadIdx.x; i < a.B; i += S::kThreads) {
    long long casc_retry = 0;
    if constexpr (kCasc) casc_retry = a.casc.retry_us;
    write_results<kCasc>(a, i, tmp.u.out.allowed[i], tmp.u.out.seen[i],
                         __ldg(a.n_units + i), casc_retry);
  }
}

// The bucket's admission across a thread-block cluster (rl_bucket_admit
// without the cascade, above the one-block size rule; admit_cluster.cuh):
// bucket_admit_kernel<S, false>'s results, written from each key's owner
// block.
struct BucketAdmitResults {
  BucketAdmit a;
  using Operands = long long;  // n_units
  __device__ __forceinline__ long long load(int i) const {
    return __ldg(a.n_units + i);
  }
  __device__ __forceinline__ void write(int i, long long n, bool ok,
                                        long long seen) const {
    write_results<false>(a, i, ok, seen, n, 0);
  }
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    bucket_admit_cluster_kernel(const BucketAdmit a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using St = rl_admit_cluster::Storage<kThreads, long long>;
  auto& st = *reinterpret_cast<St*>(smem);
  rl_admit_cluster::admit<kThreads, long long>(
      st, a.h1, a.n_units, a.avail, a.B, a.iters, BucketAdmitResults{a});
}

// front.cuh's launch() picks the table mode and the depth build.
struct BucketFrontKernel {
  template <int kTable, int kDepth>
  static void run(dim3 grid, int threads, size_t smem, cudaStream_t s,
                  const BucketFront& a) {
    bucket_front_kernel<kTable, kDepth><<<grid, threads, smem, s>>>(a);
  }
};

// admit.cuh's launch() picks the block shape.
template <bool kCasc>
struct BucketAdmitKernel {
  using Q = long long;
  template <class S>
  static auto fn() { return &bucket_admit_kernel<S, kCasc>; }
};

// admit_cluster.cuh's launch_sized() picks the thread count.
struct BucketAdmitClusterKernel {
  using Q = long long;
  template <int kThreads>
  static auto fn() { return &bucket_admit_cluster_kernel<kThreads>; }
};

}  // namespace

extern "C" {

// One launch of ceil(B / threads) blocks (one at B = 0). lane: 0 raw
// ids (premix), 1 hashed, 2 halves given. pkey == nullptr: no policy
// table; a key column of at most 4096 rows is staged in shared memory.
int rl_bucket_front(const void* debt, long long decay, const void* h64,
                    void* h1, void* h2, unsigned long long seed, int lane,
                    const void* n, const void* pkey, const void* plimit,
                    int P, long long limit, void* est, void* avail,
                    void* n_units, int B, int d, int w, int threads,
                    void* stream) {
  BucketFront a;
  a.debt = static_cast<const long long*>(debt);
  a.decay = decay;
  a.keys = {static_cast<const int64_t*>(h64), static_cast<int64_t*>(h1),
            static_cast<int64_t*>(h2), seed, lane};
  a.n = static_cast<const int32_t*>(n);
  a.policy = {static_cast<const long long*>(pkey),
              static_cast<const long long*>(plimit), P, limit};
  a.est = static_cast<long long*>(est);
  a.avail = static_cast<long long*>(avail);
  a.n_units = static_cast<long long*>(n_units);
  a.B = B;
  a.d = d;
  a.w = w;
  return rl_front::launch<BucketFrontKernel>(
      a, threads, static_cast<cudaStream_t>(stream));
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

// One launch of one block (admit.cuh's shape for B, up to kMaxCapacity
// keys; one block at B = 0 too); without the cascade, above
// rl_admit_cluster::kClusterBatch requests, one cluster
// (admit_cluster.cuh) instead. The rate's numerator comes as its
// Divider (num_magic, num_shift in [-1, 63]); rate_den > 0. limit ==
// nullptr: no cascade (h2, n and the cascade's operands unused).
int rl_bucket_admit(const void* h1, const void* n_units, const void* avail,
                    void* allowed, void* consumed, void* remaining,
                    void* retry_us, unsigned long long num_magic,
                    int num_shift, long long rate_den, int B, int iters,
                    const void* h2, const void* n, const void* map_key,
                    const void* map_tid, int P, const void* limit,
                    const void* weight, int T, void* tn_counts, int rolled,
                    long long cascade_retry_us, void* stream) {
  if (num_shift < -1 || num_shift > 63 || rate_den < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rl_cascade::With<BucketAdmit> a;
  a.h1 = static_cast<const int64_t*>(h1);
  a.n_units = static_cast<const long long*>(n_units);
  a.avail = static_cast<const long long*>(avail);
  a.allowed = static_cast<bool*>(allowed);
  a.consumed = static_cast<long long*>(consumed);
  a.remaining = static_cast<long long*>(remaining);
  a.retry_us = static_cast<long long*>(retry_us);
  a.rate_den = rate_den;
  a.by_num = Divider{num_magic, num_shift};
  a.B = B;
  a.iters = iters;
  a.casc = rl_cascade::make_args(h2, n, map_key, map_tid, P, limit, weight,
                                 T, tn_counts, nullptr, nullptr, nullptr,
                                 rolled, cascade_retry_us);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limit == nullptr) {
    const BucketAdmit& b = a;
    if (rl_admit_cluster::uses_cluster(B))
      return rl_admit_cluster::launch_sized<BucketAdmitClusterKernel>(
          b, rl_admit_cluster::kCluster, s);
    return rl_admit::launch<BucketAdmitKernel<false>>(b, s);
  }
  if (!rl_cascade::valid(a.casc))
    return static_cast<int>(cudaErrorInvalidValue);
  return rl_cascade::launch<BucketAdmitKernel<true>>(a, s);
}

}  // extern "C"
