// The dense step's parts alone, for measurement: where the step's time
// goes (ROADMAP B11). It times, at the config-3 batch, what the product's
// two launches (dense_kernels.cu) do in parts:
//
//   mode 0: phase A on one block, as the step's previous one-launch
//           design ran it: strided over the block's threads, the override
//           table searched in global memory (the scratch rows, no more);
//   mode 1: the admission alone over the scratch rows (admit.cuh's
//           admit_by grouped on the slot id), writing allowed and seen in
//           batch order, no epilogue.
//
// With the product's rl_dense_front (phase A across the card) and
// rl_dense_back (admission and epilogue), ``python3 chip_smoke.py
// --dense`` derives the split: phase A old and new, the admission, and
// the epilogue as rl_dense_back less mode 1 (PERF.md). No path of the
// limiter calls it.
//
// Interface: plain C, loaded with ctypes, like the step kernels' sources:
// rl_dense_bench takes rl_dense_front's and rl_dense_back's operands
// (``seen`` is mode 1's second output) and returns the launch's
// cudaError_t, or cudaErrorInvalidValue for operands it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "dense.cuh"
#include "front.cuh"

namespace {

using rl_dense::Step;

// admit.cuh's launch() reads the batch size and rounds from the operands.
struct Args {
  Step step;
  long long* seen;  // mode 1
  int B, iters;
};

// Request i's override row, searched in the global key column.
__device__ __forceinline__ int global_row(const Step& a, int i) {
  if (a.pkey == nullptr) return -1;
  const long long* keys = a.pkey;
  return rl_front::policy_row([keys](int j) { return __ldg(keys + j); },
                              a.P, __ldg(a.keyq + i));
}

template <class S, int kAlgo>
__global__ void __launch_bounds__(S::kThreads) phase_a(const Args g) {
  for (int i = threadIdx.x; i < g.step.B; i += S::kThreads)
    rl_dense::front<kAlgo>(g.step, i, global_row(g.step, i),
                           rl_dense::gather<kAlgo>(g.step, i));
}

template <class S>
__global__ void __launch_bounds__(S::kThreads) admission(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  const Step& a = g.step;
  const int B = a.B;
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
        n = __ldg(x + rl_dense::kUnits * B + i);
        av = __ldg(x + rl_dense::kAvail * B + i);
      },
      B, a.iters, s);
  for (int i = threadIdx.x; i < B; i += S::kThreads) {
    a.allowed[i] = tmp.u.out.allowed[i];
    g.seen[i] = tmp.u.out.seen[i];
  }
}

template <int kMode, int kAlgo>
struct Kernel {
  using Q = long long;
  template <class S>
  static auto fn() {
    if constexpr (kMode == 0) {
      return &phase_a<S, kAlgo>;
    } else {
      return &admission<S>;
    }
  }
};

}  // namespace

extern "C" {

int rl_dense_bench(int mode, void* s0, void* s1, void* s2, const void* sid,
                   const void* n, const void* keyq, const void* pkey,
                   const void* plimit, const void* pwindow, const void* pnum,
                   const void* pden, int P, long long limit,
                   long long window_us, long long rate_num,
                   long long rate_den, long long now_us, void* scratch,
                   void* allowed, void* remaining, void* retry_us,
                   void* reset_us, void* seen, int B, int iters, int algo,
                   void* stream) {
  if (!rl_dense::valid_params(window_us, rate_num, rate_den, pkey, P))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.step = rl_dense::make_step(s0, s1, s2, sid, n, keyq, pkey, plimit,
                               pwindow, pnum, pden, P, limit, window_us,
                               rate_num, rate_den, now_us, scratch, allowed,
                               remaining, retry_us, reset_us, B, iters);
  g.seen = static_cast<long long*>(seen);
  g.B = B;
  g.iters = iters;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rl_dense::with_algo(algo, [&](auto algo_c) {
    constexpr int kAlgo = decltype(algo_c)::value;
    switch (mode) {
      case 0:
        return rl_admit::launch<Kernel<0, kAlgo>>(g, st);
      case 1:
        return rl_admit::launch<Kernel<1, kAlgo>>(g, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // extern "C"
