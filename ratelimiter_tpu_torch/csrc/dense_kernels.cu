// Hand-written Hopper kernel for the dense backend's decision step.
//
// rl_dense_step replaces the JAX package's jitted dense step
// (ratelimiter_tpu/ops/dense_kernels.py: _fixed_window_step,
// _sliding_window_step, _token_bucket_step), which is jnp and no Pallas
// kernel, but whose in-batch sequencing is the same segment.admit the
// sketch's backs run here as one block. One launch of ONE block does the
// whole step for a batch of B <= kMaxCapacity (8192) requests:
//
//   A. one thread per request (strided): gather its slot's state row,
//      resolve its (limit, window, refill fraction) by binary search over
//      the sorted override table (front.cuh's policy_row, in global
//      memory), roll a stale window or refill the bucket, and compute the
//      request's units and available units; the effective state and the
//      per-request quantities the epilogue needs go to a scratch array the
//      wrapper allocates (7 int64 a request);
//   B. admission (admit.cuh's admit_by, int64), grouped on the slot id,
//      reading the operands phase A wrote (plain loads: this block wrote
//      them, so the read-only cache may not serve them);
//   C. in batch order: allowed, remaining, retry_us, reset_us; and from
//      each slot's segment tail in sorted order, the slot's new state row,
//      written once (no atomics): the segment's consumption is the tail's
//      exclusive sum (avail - seen) plus its own units when admitted.
//
// Semantics are the JAX step's, bit for bit, including the padding row C
// (padding requests carry slot C and n = 0: its row gets the effective
// values and the window start as every touched row does). Integer rules:
// every product, sum and difference wraps modulo 2^64 as torch's and
// XLA's int64 ops do (computed in uint64_t, never signed overflow); every
// division is floor division and every remainder a floor remainder, as
// jnp's and torch's // and % (C++ / and % truncate: free_scaled is
// negative after a limit decrease or a window update, so the difference
// shows); the bucket's retry is the ceiling -((-deficit*den) // num).
// Precondition (the limiter's): requests of one slot carry one policy
// query, so every request of a segment computes the same effective row;
// slot ids lie in [0, C].
//
// Bound on an H100: B requests read their slot rows (2-3 int64 columns),
// their n and query, and write four results and their rows: ~0.5 MB at
// B = 8192, ~0.15 us at 3.35 TB/s; the launch is one SM for tens of
// microseconds, like the sketch's backs (latency of the block's sort and
// scans, not bytes). Nothing in this design makes it fast yet: it
// replaces the plain step's ~90 torch launches with one.
//
// Interface: plain C, loaded with ctypes. The function launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for B outside
// [0, 8192], iters < 1 or an unknown algorithm).

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "front.cuh"

namespace {

constexpr long long kMicros = 1000000;

enum Algo : int { kFixed = 0, kSliding = 1, kBucket = 2 };

// The scratch rows, each [B] in batch order.
enum Row : int {
  kUnits = 0,  // n * 10^6
  kAvail = 1,  // available units
  kE0 = 2,     // count_eff / curr_eff / tokens_eff
  kE1 = 3,     // prev_eff (sliding) / rem_eff (bucket)
  kStart = 4,  // the window start (windowed)
  kWin = 5,    // the request's window, us
  kNum = 6,    // the request's rate numerator (bucket; den in kStart)
  kRows = 7,
};

__device__ __forceinline__ long long wmul(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

// floor(a / b) and a - b * floor(a / b) for b > 0, as torch and jnp.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  const long long r = a % b;
  return (r != 0 && r < 0) ? r + b : r;
}

// floor(x * 10^6 / W) without overflow, as _scale_to_micro.
__device__ __forceinline__ long long scale_to_micro(long long x,
                                                    long long W) {
  const long long q = floor_div(x, W);
  const long long r = floor_mod(x, W);
  return wadd(wmul(q, kMicros), floor_div(wmul(r, kMicros), W));
}

struct DenseStep {
  long long* s0;  // count / curr / tokens            (C+1,)
  long long* s1;  // win_start / prev / rem           (C+1,)
  long long* s2;  // - / win_start / last             (C+1,)
  const int32_t* sid;
  const long long* n;
  const long long* keyq;  // nullptr without a table
  const long long* pkey;  // sorted, PAD_KEY-padded; nullptr: no table
  const long long* plimit;
  const long long* pwindow;
  const long long* pnum;
  const long long* pden;
  int P;
  long long limit, window_us, rate_num, rate_den, now_us;
  long long* scratch;  // kRows x B
  bool* allowed;
  long long* remaining;
  long long* retry_us;
  long long* reset_us;
  int B, iters;
};

template <int kAlgo>
__device__ __forceinline__ void front(const DenseStep& a, int i) {
  long long lim = a.limit, W = a.window_us, num = a.rate_num,
            den = a.rate_den;
  if (a.pkey != nullptr) {
    const long long* keys = a.pkey;
    const int row = rl_front::policy_row(
        [keys](int j) { return __ldg(keys + j); }, a.P, __ldg(a.keyq + i));
    if (row >= 0) {
      lim = __ldg(a.plimit + row);
      W = __ldg(a.pwindow + row);
      if constexpr (kAlgo == kBucket) {
        num = __ldg(a.pnum + row);
        den = __ldg(a.pden + row);
      }
    }
  }
  const int slot = __ldg(a.sid + i);
  const long long now = a.now_us;
  long long* x = a.scratch;
  const int B = a.B;
  x[kUnits * B + i] = wmul(__ldg(a.n + i), kMicros);
  x[kWin * B + i] = W;
  if constexpr (kAlgo == kFixed) {
    const long long cur_ws = wmul(floor_div(now, W), W);
    const long long count = a.s0[slot];
    const long long eff = a.s1[slot] != cur_ws ? 0 : count;
    x[kAvail * B + i] = wmul(wsub(lim, eff), kMicros);
    x[kE0 * B + i] = eff;
    x[kStart * B + i] = cur_ws;
  } else if constexpr (kAlgo == kSliding) {
    const long long cur_ws = wmul(floor_div(now, W), W);
    const long long ws = a.s2[slot];
    const long long curr = a.s0[slot];
    const long long prev = a.s1[slot];
    const bool current = ws == cur_ws;
    const bool rolled_one = ws == wsub(cur_ws, W);
    const long long curr_eff = current ? curr : 0;
    const long long prev_eff = current ? prev : (rolled_one ? curr : 0);
    const long long elapsed = wsub(now, cur_ws);
    const long long free_scaled =
        wsub(wsub(wmul(lim, W), wmul(prev_eff, wsub(W, elapsed))),
             wmul(curr_eff, W));
    x[kAvail * B + i] = scale_to_micro(free_scaled, W);
    x[kE0 * B + i] = curr_eff;
    x[kE1 * B + i] = prev_eff;
    x[kStart * B + i] = cur_ws;
  } else {
    const long long cap = wmul(lim, kMicros);
    const long long tokens = a.s0[slot];
    const long long rem = a.s1[slot];
    const long long last = a.s2[slot];
    long long elapsed = wsub(now, last);
    elapsed = elapsed > 0 ? elapsed : 0;
    const bool full = elapsed >= W;
    const long long acc = wadd(wmul(full ? 0 : elapsed, num), rem);
    const long long tokens_r = wadd(tokens, floor_div(acc, den));
    const long long rem_r = floor_mod(acc, den);
    const bool capped = full || tokens_r >= cap;
    const long long tokens_eff = capped ? cap : tokens_r;
    x[kAvail * B + i] = tokens_eff;
    x[kE0 * B + i] = tokens_eff;
    x[kE1 * B + i] = capped ? 0 : rem_r;
    x[kStart * B + i] = den;
    x[kNum * B + i] = num;
  }
}

template <class S, int kAlgo>
__global__ void __launch_bounds__(S::kThreads)
    dense_step_kernel(const DenseStep a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  const int B = a.B;
  for (int i = threadIdx.x; i < B; i += S::kThreads) front<kAlgo>(a, i);
  // admit_by's first barrier orders these writes before its loads.
  const long long* x = a.scratch;
  const int32_t* sid = a.sid;
  rl_admit::Sorted<long long, S::kItems> s;
  rl_admit::admit_by<S, long long>(
      tmp,
      [sid](int j) {
        return static_cast<unsigned long long>(
            static_cast<uint32_t>(__ldg(sid + j)));
      },
      [x, B](int i, long long& n, long long& av) {
        n = x[kUnits * B + i];
        av = x[kAvail * B + i];
      },
      B, a.iters, s);
  // The slots' new rows, from each segment's tail (one writer a slot).
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) {
    const int i = s.idx[k];
    if (i >= B || !s.tail[k]) continue;
    const int slot = __ldg(sid + i);
    const long long used = s.allowed[k] ? s.n[k] : 0;
    const long long total =
        wadd(wsub(s.avail[k], tmp.u.out.seen[i]), used);
    const long long e0 = x[kE0 * B + i];
    if constexpr (kAlgo == kFixed) {
      a.s0[slot] = wadd(e0, floor_div(total, kMicros));
      a.s1[slot] = x[kStart * B + i];
    } else if constexpr (kAlgo == kSliding) {
      a.s0[slot] = wadd(e0, floor_div(total, kMicros));
      a.s1[slot] = x[kE1 * B + i];
      a.s2[slot] = x[kStart * B + i];
    } else {
      a.s0[slot] = wsub(e0, total);
      a.s1[slot] = x[kE1 * B + i];
      a.s2[slot] = a.now_us;
    }
  }
  // The results in batch order: coalesced reads and writes.
  for (int i = threadIdx.x; i < B; i += S::kThreads) {
    const bool ok = tmp.u.out.allowed[i];
    const long long seen = tmp.u.out.seen[i];
    const long long n = x[kUnits * B + i];
    const long long W = x[kWin * B + i];
    a.allowed[i] = ok;
    a.remaining[i] = floor_div(wsub(seen, ok ? n : 0), kMicros);
    if constexpr (kAlgo == kBucket) {
      long long deficit = wsub(n, seen);
      deficit = deficit > 0 ? deficit : 0;
      // -((-deficit * den) // num), wrapping as torch's int64.
      const long long q = floor_div(
          wmul(wsub(0, deficit), x[kStart * B + i]), x[kNum * B + i]);
      a.retry_us[i] = ok ? 0 : wsub(0, q);
      a.reset_us[i] = wadd(a.now_us, W);
    } else {
      const long long reset = wadd(x[kStart * B + i], W);
      a.reset_us[i] = reset;
      a.retry_us[i] = ok ? 0 : wsub(reset, a.now_us);
    }
  }
}

// admit.cuh's launch() picks the block shape.
template <int kAlgo>
struct DenseKernel {
  using Q = long long;
  template <class S>
  static auto fn() { return &dense_step_kernel<S, kAlgo>; }
};

}  // namespace

extern "C" {

// One launch of one block (admit.cuh's shape for B; one block at B = 0
// too). algo: 0 fixed window (s0 count, s1 win_start), 1 sliding window
// (s0 curr, s1 prev, s2 win_start), 2 token bucket (s0 tokens, s1 rem,
// s2 last). pkey == nullptr: no policy table (keyq and the value columns
// unused); otherwise P is a power of two and window, rate_num and
// rate_den are > 0 in every row. scratch holds 7 * B int64.
int rl_dense_step(void* s0, void* s1, void* s2, const void* sid,
                  const void* n, const void* keyq, const void* pkey,
                  const void* plimit, const void* pwindow, const void* pnum,
                  const void* pden, int P, long long limit,
                  long long window_us, long long rate_num,
                  long long rate_den, long long now_us, void* scratch,
                  void* allowed, void* remaining, void* retry_us,
                  void* reset_us, int B, int iters, int algo, void* stream) {
  if (window_us < 1 || rate_num < 1 || rate_den < 1 ||
      (pkey != nullptr && (P < 1 || (P & (P - 1)))))
    return static_cast<int>(cudaErrorInvalidValue);
  DenseStep a;
  a.s0 = static_cast<long long*>(s0);
  a.s1 = static_cast<long long*>(s1);
  a.s2 = static_cast<long long*>(s2);
  a.sid = static_cast<const int32_t*>(sid);
  a.n = static_cast<const long long*>(n);
  a.keyq = static_cast<const long long*>(keyq);
  a.pkey = static_cast<const long long*>(pkey);
  a.plimit = static_cast<const long long*>(plimit);
  a.pwindow = static_cast<const long long*>(pwindow);
  a.pnum = static_cast<const long long*>(pnum);
  a.pden = static_cast<const long long*>(pden);
  a.P = P;
  a.limit = limit;
  a.window_us = window_us;
  a.rate_num = rate_num;
  a.rate_den = rate_den;
  a.now_us = now_us;
  a.scratch = static_cast<long long*>(scratch);
  a.allowed = static_cast<bool*>(allowed);
  a.remaining = static_cast<long long*>(remaining);
  a.retry_us = static_cast<long long*>(retry_us);
  a.reset_us = static_cast<long long*>(reset_us);
  a.B = B;
  a.iters = iters;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case kFixed:
      return rl_admit::launch<DenseKernel<kFixed>>(a, st);
    case kSliding:
      return rl_admit::launch<DenseKernel<kSliding>>(a, st);
    case kBucket:
      return rl_admit::launch<DenseKernel<kBucket>>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
