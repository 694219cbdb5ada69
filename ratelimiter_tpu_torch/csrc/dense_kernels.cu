// Hand-written Hopper kernels for the dense backend's decision step
// (dense.cuh has the step's device code and its integer rules).
//
// The step replaces the JAX package's jitted dense step
// (ratelimiter_tpu/ops/dense_kernels.py: _fixed_window_step :124,
// _sliding_window_step :153, _token_bucket_step :189), which is jnp and no
// Pallas kernel. A batch of B <= kMaxCapacity (8192) requests takes two
// launches on one stream, with no host sync between them:
//
//   rl_dense_front (phase A): ceil(B / 256) blocks, one request a
//     thread, across the card. Each block stages the override table's
//     sorted key column in its shared memory with one bulk asynchronous
//     copy (front.cuh's kShared mode, tables of at most 4096 rows; larger
//     ones are searched in global memory), and each thread gathers its
//     slot's row and its table row while the copy lands, then writes its
//     scratch rows;
//   rl_dense_back (phase B): ONE block (admit.cuh's shape for B) runs the
//     admission grouped on the slot id over the scratch rows and the
//     epilogue: the four results in batch order and each touched slot's
//     new row, written once from its segment's tail.
//
// Design. Phase A is independent per request, so it runs on all 132 SMs
// instead of the admission's one; the search probes shared memory instead
// of issuing ~10 dependent global loads a request. What stays on one SM is
// the admission, which needs the whole batch in one block (ROADMAP B6
// would spread it). Bound on an H100: B requests read their slot rows (2-3
// int64 columns), their n and query and the table's columns, and write
// four results and their rows: ~0.3 MB at B = 4096, ~0.1 us at 3.35 TB/s;
// the step is the admission block's latency (its sort and scans), not
// bytes. ``python3 chip_smoke.py --dense`` times the split
// (csrc/dense_bench.cu) and the step (PERF.md).
//
// Interface: plain C, loaded with ctypes. rl_dense_step makes both
// launches (one host call a step); rl_dense_front and rl_dense_back make
// one each, for measuring and checking the parts. Each function launches
// on the given stream, does not synchronise, allocates nothing, and
// returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue for B outside
// [0, 8192], iters < 1, a non-positive window or rate, a table capacity
// that is not a power of two, or an unknown algorithm).

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "dense.cuh"
#include "front.cuh"

namespace {

using rl_dense::Step;

template <int kTable, int kAlgo>
__global__ void __launch_bounds__(rl_dense::kFrontThreads)
    dense_front_kernel(const Step a) {
  extern __shared__ __align__(16) long long skey[];
  __shared__ __align__(8) uint64_t bar;
  rl_front::Policy p;
  p.key = a.pkey;
  p.P = a.P;
  const long long* keys = rl_front::stage_table<kTable>(p, skey, &bar);
  const int i = blockIdx.x * rl_dense::kFrontThreads + threadIdx.x;
  if (i >= a.B) {
    rl_front::drain_table<kTable>(&bar);  // B = 0: thread 0 of block 0
    return;
  }
  // The slot row's loads are independent of the search: issue them first.
  const rl_dense::Gathered g = rl_dense::gather<kAlgo>(a, i);
  int row = -1;
  if constexpr (kTable != rl_front::kNoTable) {
    const long long q = __ldg(a.keyq + i);
    if constexpr (kTable == rl_front::kShared) {
      rl_tile::mbar_wait(&bar, 0);
      row = rl_front::policy_row([keys](int j) { return keys[j]; }, a.P, q);
    } else {
      row = rl_front::policy_row([keys](int j) { return __ldg(keys + j); },
                                 a.P, q);
    }
  }
  rl_dense::front<kAlgo>(a, i, row, g);
}

template <class S, int kAlgo>
__global__ void __launch_bounds__(S::kThreads)
    dense_back_kernel(const Step a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  rl_dense::back<S, kAlgo>(tmp, a);
}

// admit.cuh's launch() picks the block shape.
template <int kAlgo>
struct DenseBack {
  using Q = long long;
  template <class S>
  static auto fn() { return &dense_back_kernel<S, kAlgo>; }
};

template <int kAlgo>
int launch_front(const Step& a, cudaStream_t stream) {
  // A one-row table is below the bulk copy's 16 bytes: searched in place.
  const int mode = a.pkey != nullptr && a.P < 2
                       ? static_cast<int>(rl_front::kGlobal)
                       : rl_front::table_mode(a.pkey, a.P);
  const dim3 grid(rl_front::front_blocks(a.B, rl_dense::kFrontThreads));
  const dim3 block(rl_dense::kFrontThreads);
  if (mode == rl_front::kShared) {
    dense_front_kernel<rl_front::kShared, kAlgo>
        <<<grid, block, static_cast<size_t>(a.P) * 8, stream>>>(a);
  } else if (mode == rl_front::kGlobal) {
    dense_front_kernel<rl_front::kGlobal, kAlgo><<<grid, block, 0, stream>>>(
        a);
  } else {
    dense_front_kernel<rl_front::kNoTable, kAlgo>
        <<<grid, block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Phase A over a batch of B requests into ``scratch`` (kRows x B int64).
// algo: 0 fixed window (s0 count, s1 win_start), 1 sliding window (s0
// curr, s1 prev, s2 win_start), 2 token bucket (s0 tokens, s1 rem, s2
// last). pkey == nullptr: no policy table (keyq and the value columns
// unused); otherwise P is a power of two and window, rate_num and rate_den
// are > 0 in every row. The state is only read.
int rl_dense_front(const void* s0, const void* s1, const void* s2,
                   const void* sid, const void* n, const void* keyq,
                   const void* pkey, const void* plimit, const void* pwindow,
                   const void* pnum, const void* pden, int P, long long limit,
                   long long window_us, long long rate_num,
                   long long rate_den, long long now_us, void* scratch, int B,
                   int algo, void* stream) {
  if (B < 0 || B > rl_admit::kMaxCapacity ||
      !rl_dense::valid_params(window_us, rate_num, rate_den, pkey, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const Step a = rl_dense::make_step(
      const_cast<void*>(s0), const_cast<void*>(s1), const_cast<void*>(s2),
      sid, n, keyq, pkey, plimit, pwindow, pnum, pden, P, limit, window_us,
      rate_num, rate_den, now_us, scratch, nullptr, nullptr, nullptr,
      nullptr, B, 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rl_dense::with_algo(algo, [&](auto algo_c) {
    return launch_front<decltype(algo_c)::value>(a, st);
  });
}

// Phase B of the same batch after rl_dense_front on the same stream: one
// block (admit.cuh's shape for B; one block at B = 0 too) reads the
// scratch rows, writes the four results and each touched slot's row.
int rl_dense_back(void* s0, void* s1, void* s2, const void* sid,
                  long long now_us, const void* scratch, void* allowed,
                  void* remaining, void* retry_us, void* reset_us, int B,
                  int iters, int algo, void* stream) {
  const Step a = rl_dense::make_step(
      s0, s1, s2, sid, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, 0, 0, 1, 1, 1, now_us, const_cast<void*>(scratch), allowed,
      remaining, retry_us, reset_us, B, iters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rl_dense::with_algo(algo, [&](auto algo_c) {
    return rl_admit::launch<DenseBack<decltype(algo_c)::value>>(a, st);
  });
}

// The whole step: rl_dense_front's launch, then rl_dense_back's, on
// ``stream``; the operands are the union of theirs.
int rl_dense_step(void* s0, void* s1, void* s2, const void* sid,
                  const void* n, const void* keyq, const void* pkey,
                  const void* plimit, const void* pwindow, const void* pnum,
                  const void* pden, int P, long long limit,
                  long long window_us, long long rate_num, long long rate_den,
                  long long now_us, void* scratch, void* allowed,
                  void* remaining, void* retry_us, void* reset_us, int B,
                  int iters, int algo, void* stream) {
  const int err = rl_dense_front(s0, s1, s2, sid, n, keyq, pkey, plimit,
                                 pwindow, pnum, pden, P, limit, window_us,
                                 rate_num, rate_den, now_us, scratch, B, algo,
                                 stream);
  if (err) return err;
  return rl_dense_back(s0, s1, s2, sid, now_us, scratch, allowed, remaining,
                       retry_us, reset_us, B, iters, algo, stream);
}

}  // extern "C"
