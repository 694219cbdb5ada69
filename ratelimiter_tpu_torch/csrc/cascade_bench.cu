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
// cudaErrorInvalidValue for operands the routine does not take; with
// ``marks`` (11 int64, or null) thread 0 records the SM clock at entry
// and after each of the routine's steps (``decide``'s probe).

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
  long long* marks;  // nullptr, or the SM clock at each step's end
};

// Thread 0 records the SM clock after decide()'s steps: marks[0] at
// entry, marks[1 + m] after step m (rl_cascade_bench's ``marks``).
struct Clock {
  long long* marks;
  __device__ __forceinline__ explicit Clock(long long* m) : marks(m) {}
  __device__ __forceinline__ void operator()(int m) const {
    if (threadIdx.x == 0) marks[1 + m] = clock64();
  }
};

template <class S, class Probe>
__global__ void __launch_bounds__(S::kThreads, 1)
    cascade_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  if constexpr (!std::is_same_v<Probe, rl_cascade::NoProbe>) {
    if (threadIdx.x == 0) a.marks[0] = clock64();
  }
  rl_cascade::stage_map<S>(smem, a.casc);
  // The key scope's verdicts where stage 1 leaves them.
  for (int i = threadIdx.x; i < a.B; i += S::kThreads)
    tmp.u.out.allowed[i] = a.allowed_key[i];
  __syncthreads();
  rl_cascade::decide<S>(tmp, smem, a.casc, a.h1, a.B, a.iters,
                        Probe{a.marks});
  const rl_cascade::View v = rl_cascade::view<S>(tmp, smem, a.casc);
  for (int i = threadIdx.x; i < a.B; i += S::kThreads)
    a.allowed[i] = tmp.u.out.allowed[i];
  for (int t = threadIdx.x; t <= a.casc.T; t += S::kThreads)
    a.hist[t] = rl_cascade::hist_of(v, t);
}

template <class Probe>
struct CascadeKernel {
  using Q = float;
  template <class S>
  static auto fn() { return &cascade_kernel<S, Probe>; }
};

}  // namespace

extern "C" {

int rl_cascade_bench(const void* h1, const void* allowed_key, void* allowed,
                     void* hist, const void* h2, const void* n,
                     const void* map_key, const void* map_tid, int P,
                     const void* limit, const void* weight, int T,
                     void* counts, void* tn_cur, const void* slab,
                     const void* frac, int rolled, int B, int iters,
                     void* marks, void* stream) {
  Args a;
  a.h1 = static_cast<const int64_t*>(h1);
  a.allowed_key = static_cast<const bool*>(allowed_key);
  a.allowed = static_cast<bool*>(allowed);
  a.hist = static_cast<long long*>(hist);
  a.casc = rl_cascade::make_args(h2, n, map_key, map_tid, P, limit, weight,
                                 T, counts, tn_cur, slab, frac, rolled, 0);
  a.B = B;
  a.iters = iters;
  a.marks = static_cast<long long*>(marks);
  if (!rl_cascade::valid(a.casc))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.marks != nullptr
             ? rl_cascade::launch<CascadeKernel<Clock>>(a, st)
             : rl_cascade::launch<CascadeKernel<rl_cascade::NoProbe>>(a, st);
}

// The dynamic shared memory of a windowed cascade build at the shape for
// B: the routine's storage and the cascade's extra bytes (the bucket's
// int64 storage is the same size; add_back adds 8 KB of static edges at
// 512 threads), for the record (PERF.md).
long long rl_cascade_smem_bytes(int B, int T, int P) {
  long long total = -1;
  auto of = [&](auto shape) {
    using S = decltype(shape);
    total = static_cast<long long>(rl_admit::storage_bytes<S>() +
                                   rl_cascade::extra_bytes<S>(T, P));
  };
  if (B <= 256) {
    of(rl_admit::Shape<64, 4, float>());
  } else if (B <= 1024) {
    of(rl_admit::Shape<256, 4, float>());
  } else if (B <= 4096) {
    of(rl_admit::Shape<512, 8, float>());
  } else {
    of(rl_admit::Shape<512, 16, float>());
  }
  return total;
}

}  // extern "C"
