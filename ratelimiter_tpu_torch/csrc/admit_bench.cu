// The admission routine of admit.cuh alone, for measurement: at block
// shapes and sort digit widths beside the ones the step kernels take, and
// beside the routine's first design, which sorted the 64-bit keys
// themselves. It backs admit.cuh's shapes, kRadixBits and capacity
// (``python3 chip_smoke.py --admit-sweep`` builds, checks and times it;
// PERF.md). No path of the limiter calls it.
//
// Interface: plain C, loaded with ctypes, like the step kernels' sources.
// rl_admit_bench launches one block over the batch and writes, in batch
// order, allowed and seen (the routine's results); it returns the
// launch's cudaError_t, or cudaErrorInvalidValue for a combination this
// file does not build.

#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"

namespace {

struct Args {
  const int64_t* h1;
  const void* n;      // f32 counts or int64 units
  const void* avail;  // the same type
  void* seen;
  bool* allowed;
  int B, iters;
};

// The routine as the step kernels run it.
template <class S>
__global__ void __launch_bounds__(S::kThreads)
    routine_kernel(const Args a) {
  using Q = typename S::Quantity;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  rl_admit::Sorted<Q, S::kItems> s;
  rl_admit::admit<S>(tmp, a.h1, static_cast<const Q*>(a.n),
                     static_cast<const Q*>(a.avail), a.B, a.iters, s);
  for (int i = threadIdx.x; i < a.B; i += S::kThreads) {
    static_cast<Q*>(a.seen)[i] = tmp.u.out.seen[i];
    a.allowed[i] = tmp.u.out.allowed[i];
  }
}

// The routine in the cascade builds' packed form (admit_packed).
template <class S>
__global__ void __launch_bounds__(S::kThreads)
    packed_kernel(const Args a) {
  using Q = typename S::Quantity;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename S::Storage*>(smem);
  rl_admit::Packed<S::kItems> p;
  rl_admit::admit_packed<S>(tmp, a.h1, static_cast<const Q*>(a.n),
                            static_cast<const Q*>(a.avail), a.B, a.iters, p);
  for (int i = threadIdx.x; i < a.B; i += S::kThreads) {
    static_cast<Q*>(a.seen)[i] = tmp.u.out.seen[i];
    a.allowed[i] = tmp.u.out.allowed[i];
  }
}

template <class Q>
int packed(int threads, int items, const Args& a, cudaStream_t s) {
  using rl_admit::Shape;
  if (threads == 512 && items == 8 && a.B <= 4096)
    return rl_admit::launch_block<Shape<512, 8, Q>>(
        &packed_kernel<Shape<512, 8, Q>>, a, s);
  if (threads == 1024 && items == 8 && a.B <= 8192)
    return rl_admit::launch_block<Shape<1024, 8, Q>>(
        &packed_kernel<Shape<1024, 8, Q>>, a, s);
  return cudaErrorInvalidValue;
}

// The first design, f32: a stable block radix sort of the 64-bit keys
// (4-bit digits over the low 32 bits, or all 64 when a key has a high bit
// set), heads on the keys, the operands gathered from global memory in
// sorted order, all iters + 2 scans, the results scattered to global
// memory.
template <int kThreadsV, int kItemsV>
struct KeySort {
  static constexpr int kThreads = kThreadsV;
  static constexpr int kItems = kItemsV;
  using Sort =
      cub::BlockRadixSort<unsigned long long, kThreads, kItems, int>;
  using Heads = cub::BlockDiscontinuity<unsigned long long, kThreads>;
  using Scan =
      cub::BlockScan<rl_admit::Seg, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  struct Storage {
    union {
      typename Sort::TempStorage sort;
      typename Heads::TempStorage heads;
    } u;
    typename Scan::TempStorage scan;
  };
};

struct KeyDiffer {
  __device__ __forceinline__ bool operator()(
      const unsigned long long& a, const unsigned long long& b) const {
    return a != b;
  }
};

template <class K>
__global__ void __launch_bounds__(K::kThreads)
    key_sort_kernel(const Args a) {
  constexpr int kItems = K::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& tmp = *reinterpret_cast<typename K::Storage*>(smem);
  const float* n = static_cast<const float*>(a.n);
  const float* avail = static_cast<const float*>(a.avail);
  unsigned long long key[kItems];
  int idx[kItems], head[kItems];
  float nn[kItems], av[kItems], cons[kItems];
  bool allowed[kItems];
  bool high = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    const bool valid = j < a.B;
    key[k] = valid ? static_cast<unsigned long long>(a.h1[j]) : ~0ull;
    idx[k] = j;
    high = high || (valid && (key[k] >> 32) != 0);
  }
  const int end_bit = __syncthreads_or(high) ? 64 : 32;
  typename K::Sort(tmp.u.sort).Sort(key, idx, 0, end_bit);
  __syncthreads();
  typename K::Heads(tmp.u.heads).FlagHeads(head, key, KeyDiffer());
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = idx[k] < a.B;
    nn[k] = valid ? n[idx[k]] : 0.0f;
    av[k] = valid ? avail[idx[k]] : 0.0f;
    allowed[k] = true;
  }
  for (int round = 0; round <= a.iters + 1; ++round) {
    unsigned long long x[kItems];
    rl_admit::Seg seg[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      x[k] = allowed[k] ? rl_admit::units(nn[k]) : 0ull;
      seg[k].v = x[k];
      seg[k].head = head[k];
    }
    __syncthreads();
    typename K::Scan(tmp.scan).InclusiveScan(seg, seg,
                                             rl_admit::SegSum());
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      rl_admit::from_units(seg[k].v - x[k], cons[k]);
      const bool fits = cons[k] + nn[k] <= av[k];
      if (round < a.iters) {
        allowed[k] = fits;
      } else if (round == a.iters) {
        allowed[k] = allowed[k] && fits;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (idx[k] < a.B) {
      static_cast<float*>(a.seen)[idx[k]] = av[k] - cons[k];
      a.allowed[idx[k]] = allowed[k];
    }
  }
}

template <class S>
int run(const Args& a, cudaStream_t stream) {
  if (a.B > S::kCapacity) return cudaErrorInvalidValue;
  return rl_admit::launch_block<S>(&routine_kernel<S>, a, stream);
}

template <class K>
int run_key_sort(const Args& a, cudaStream_t stream) {
  if (a.B > K::kThreads * K::kItems) return cudaErrorInvalidValue;
  return rl_admit::launch_block<K>(&key_sort_kernel<K>, a, stream);
}

// Shapes timed with the routine: (threads, keys a thread), int64 or f32,
// at 5-bit sort digits; the two largest the step kernels take also at 4.
template <class Q>
int routine(int threads, int items, int bits, const Args& a,
            cudaStream_t s) {
  using rl_admit::Shape;
  const int shape = threads * 100 + items;
  if (bits == 5) {
    switch (shape) {
      case 6404: return run<Shape<64, 4, Q, 5>>(a, s);
      case 25604: return run<Shape<256, 4, Q, 5>>(a, s);
      case 102404: return run<Shape<1024, 4, Q, 5>>(a, s);
      case 51208: return run<Shape<512, 8, Q, 5>>(a, s);
      case 25616: return run<Shape<256, 16, Q, 5>>(a, s);
      case 102408: return run<Shape<1024, 8, Q, 5>>(a, s);
      case 51216: return run<Shape<512, 16, Q, 5>>(a, s);
    }
  } else if (bits == 4) {
    switch (shape) {
      case 51208: return run<Shape<512, 8, Q, 4>>(a, s);
      case 102408: return run<Shape<1024, 8, Q, 4>>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// design 0: the routine (quantity int64 when int64 != 0, else f32);
// design 1: the first design (f32, 4-bit digits; 1024x4 and 512x8);
// design 2: the routine's packed form (5-bit digits; 512x8, 1024x8).
int rl_admit_bench(int design, int threads, int items, int bits, int int64,
                   const void* h1, const void* n, const void* avail,
                   void* seen, void* allowed, int B, int iters,
                   void* stream) {
  if (B < 0 || iters < 1) return cudaErrorInvalidValue;
  const Args a{static_cast<const int64_t*>(h1), n, avail, seen,
               static_cast<bool*>(allowed), B, iters};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    return int64 ? routine<long long>(threads, items, bits, a, s)
                 : routine<float>(threads, items, bits, a, s);
  }
  if (design == 2 && bits == 5) {
    return int64 ? packed<long long>(threads, items, a, s)
                 : packed<float>(threads, items, a, s);
  }
  if (design == 1 && !int64 && bits == 4) {
    if (threads == 1024 && items == 4)
      return run_key_sort<KeySort<1024, 4>>(a, s);
    if (threads == 512 && items == 8)
      return run_key_sort<KeySort<512, 8>>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
