// Hand-written Hopper kernel for the collective mesh router's prologue.
//
//   route_bins  <- the routing prologue of the JAX package's collective
//                  router (ratelimiter_tpu/ops/route_kernels.py _route,
//                  :89-131), which is jnp code (a one-hot cumsum and a
//                  scatter), not a Pallas kernel
//
// One launch per source shard of L rows. For each row it computes the
// owner (h % n, after splitmix64 when the lane carries raw ids), the row's
// stable exclusive rank among the shard's VALID rows (global index < b)
// with the same owner, keep = valid & rank < C, the bin position
// owner * C + rank, and scatters the kept rows' (raw h, ns) into the
// (n, C) send bins, whose empty slots hold 0 and the -1 sentinel. One
// overflow flag per shard says a valid row found its bin full.
//
// Design: ONE block (the shard is at most a serving frame's pad bucket,
// and the rank is a scan that the scatter depends on). The block fills
// the bins with their empty values, then walks the rows in chunks of its
// width, in order. In a chunk each warp groups its lanes by owner with
// __match_any_sync, masks the valid ones with a ballot and ranks each
// lane among the same-owner valid lanes before it (popc); each group's
// count goes to a shared (warps x n) table, which one thread per owner
// scans over the warps into per-warp offsets on top of the running count
// of earlier chunks. So the rank is a block-wide exclusive prefix count
// per destination, in row order: the stable rank of the reference's
// one-hot cumsum, with no sort. The scatter writes distinct bin slots, so
// it needs no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// The most slices (destinations) one launch routes to: the shared
// (warps x n) count table is kWarps * kMaxSlices ints (8 KB).
constexpr int kMaxSlices = 64;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(kThreads)
route_bins_kernel(const int64_t* __restrict__ h64,
                  const int32_t* __restrict__ ns, int L, long long n_valid,
                  int n, int C, int premix, int64_t* __restrict__ send_h,
                  int32_t* __restrict__ send_ns,
                  int32_t* __restrict__ binpos, bool* __restrict__ keep,
                  int32_t* __restrict__ ovf) {
  __shared__ int counts[kWarps][kMaxSlices];
  __shared__ int offsets[kWarps][kMaxSlices];
  __shared__ int running[kMaxSlices];
  __shared__ int overflow;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bins = n * C;
  for (int i = tid; i < bins; i += kThreads) {
    send_h[i] = 0;
    send_ns[i] = -1;
  }
  if (tid < n) running[tid] = 0;
  if (tid == 0) overflow = 0;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = 0; base < L; base += kThreads) {
    for (int i = tid; i < kWarps * n; i += kThreads) {
      counts[i / n][i % n] = 0;
    }
    __syncthreads();
    const int row = base + tid;
    const bool live = row < L;
    const bool valid = live && row < n_valid;
    uint64_t h = 0;
    int owner = 0;
    if (live) {
      h = static_cast<uint64_t>(h64[row]);
      const uint64_t fin = premix ? splitmix64(h) : h;
      owner = static_cast<int>(fin % static_cast<uint64_t>(n));
    }
    // Lanes past L take owner n (no bin) so they never group with a row.
    const int key = live ? owner : n;
    const unsigned same = __match_any_sync(0xffffffffu, key) &
                          __ballot_sync(0xffffffffu, valid);
    const int in_warp = __popc(same & lt);
    if (valid && in_warp == 0) counts[warp][owner] = __popc(same);
    __syncthreads();
    if (tid < n) {
      int acc = running[tid];
      for (int w = 0; w < kWarps; ++w) {
        offsets[w][tid] = acc;
        acc += counts[w][tid];
      }
      running[tid] = acc;
    }
    __syncthreads();
    if (live) {
      const int rank = offsets[warp][owner] + in_warp;
      const bool kept = valid && rank < C;
      const int pos = owner * C + rank;
      binpos[row] = pos;
      keep[row] = kept;
      if (kept) {
        send_h[pos] = static_cast<int64_t>(h);
        send_ns[pos] = ns[row];
      } else if (valid) {
        overflow = 1;
      }
    }
    __syncthreads();
  }
  if (tid == 0) ovf[0] = overflow;
}

}  // namespace

extern "C" {

int rl_route_max_slices() { return kMaxSlices; }

// One launch of one block for a source shard of L rows of which the first
// `n_valid` (clamped to [0, L]) are frame rows; the rest are padding.
int rl_route_bins(const void* h64, const void* ns, int L, long long n_valid,
                  int n, int C, int premix, void* send_h, void* send_ns,
                  void* binpos, void* keep, void* ovf, void* stream) {
  if (n < 1 || n > kMaxSlices || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  route_bins_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(h64), static_cast<const int32_t*>(ns), L,
      n_valid, n, C, premix, static_cast<int64_t*>(send_h),
      static_cast<int32_t*>(send_ns), static_cast<int32_t*>(binpos),
      static_cast<bool*>(keep), static_cast<int32_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
