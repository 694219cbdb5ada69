// The hierarchy cascade's routine of cascade.cuh alone, for measurement:
// the key scope's verdicts in, the final mask and the histogram out, no
// fold into the scope counters. The step never launches it: the cascade
// runs inside the cascade builds of its backs (sketch_kernels.cu's
// add_back and window_admit, bucket_kernels.cu's bucket_admit). It times
// the composed form of those backs (the build without the cascade, then
// this launch) beside the fused one, and holds the routine to the plain
// version (sketch_cuda.cascade_admit_plain) apart from the stage-1 code
// around it (``python3 chip_smoke.py --cascade`` builds, checks and times
// it; PERF.md). No path of the limiter calls it.
//
// Interface: plain C, loaded with ctypes, like the step kernels' sources.
// rl_cascade_bench launches one block (admit.cuh's shape for B, up to
// kMaxCapacity requests) with the windowed operands (tn_cur != nullptr)
// or the bucket's, and returns the launch's cudaError_t, or
// cudaErrorInvalidValue for operands the routine does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "cascade.cuh"

namespace {

struct Args {
  const int64_t* h1;
  const bool* allowed_key;
  bool* allowed;
  long long* hist;
  rl_cascade::Args casc;
  int B, iters;
};

template <class S>
__global__ void __launch_bounds__(S::kThreads)
    cascade_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  unsigned char* flag = smem + sizeof(typename S::Storage);
  long long* hist =
      reinterpret_cast<long long*>(flag + rl_cascade::kFlagBytes);
  for (int i = threadIdx.x; i < a.B; i += S::kThreads)
    flag[i] = a.allowed_key[i];
  __syncthreads();
  rl_cascade::cascade<S>(tmp, flag, hist, a.casc, a.h1, a.B, a.iters);
  for (int i = threadIdx.x; i < a.B; i += S::kThreads)
    a.allowed[i] = flag[i];
  for (int t = threadIdx.x; t <= a.casc.T; t += S::kThreads)
    a.hist[t] = hist[t];
}

struct CascadeKernel {
  using Q = float;
  template <class S>
  static auto fn() { return &cascade_kernel<S>; }
};

}  // namespace

extern "C" {

int rl_cascade_bench(const void* h1, const void* allowed_key, void* allowed,
                     void* hist, const void* h2, const void* n,
                     const void* map_key, const void* map_tid, int P,
                     const void* limit, const void* weight, int T,
                     void* counts, void* tn_cur, const void* slab,
                     const void* frac, int rolled, int B, int iters,
                     void* stream) {
  Args a;
  a.h1 = static_cast<const int64_t*>(h1);
  a.allowed_key = static_cast<const bool*>(allowed_key);
  a.allowed = static_cast<bool*>(allowed);
  a.hist = static_cast<long long*>(hist);
  a.casc = rl_cascade::make_args(h2, n, map_key, map_tid, P, limit, weight,
                                 T, counts, tn_cur, slab, frac, rolled, 0);
  a.B = B;
  a.iters = iters;
  if (!rl_cascade::valid(a.casc))
    return static_cast<int>(cudaErrorInvalidValue);
  return rl_admit::launch<CascadeKernel>(
      a, static_cast<cudaStream_t>(stream),
      rl_cascade::extra_bytes(a.casc.T));
}

}  // extern "C"
