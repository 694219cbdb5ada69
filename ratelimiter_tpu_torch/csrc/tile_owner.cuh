// Tile ownership for the dense update kernels (cu_update, bucket_update).
//
// Both kernels update every cell of a row-major (d, w) state slab from a
// per-row histogram of the batch. One launch covers the slab with a grid
// of (w / T, d) blocks: block (k, r) OWNS cells [k*T, (k+1)*T) of row r
// and is the only block that writes them. On entry one thread starts a
// bulk asynchronous copy (Hopper's cp.async.bulk, no tensor map) of the
// block's tile of each state slab into shared memory, completing on an
// mbarrier; while it is in flight the block's threads stride over the B
// keys (h1, h2 and the key's amount loaded together, 8 keys a thread at a
// time) and accumulate the keys that fall in the tile into a
// shared-memory histogram of T entries. After a barrier, the dense pass
// computes every cell of the tile from shared memory and stores it with
// 16-byte writes. No global scratch, no memset, no second launch.
//
// Clusters. Every block of a plain launch reads all B keys, so the scan
// grows with B. In a cluster of C blocks (C neighbouring tiles of one
// row, C in {2, 4, 8}) each block scans B/C of the keys and adds each hit
// into the OWNING block's histogram through distributed shared memory, so
// the cluster reads the keys once instead of C times; a cluster launch
// costs more, so the wrappers choose clusters for large batches only
// (ops/sketch_cuda.py, tiling).
//
// Each state tile is T cells of 4 or 8 bytes with T a power of two >= 16
// dividing w, so every copy is a multiple of 16 bytes at a 16-byte aligned
// offset of a 16-byte aligned slab (the wrappers check the slabs'
// alignment).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rl_tile {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival (the issuing thread's expect_tx) completes the phase once
// every byte announced has landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// Thread 0 waits for the tile's copies; the barrier that follows (an
// arrival and wait below) hands the tile to the block's other threads, so
// they do not all poll the mbarrier.
__device__ __forceinline__ void tile_arrived(uint64_t* bar) {
  if (threadIdx.x == 0) mbar_wait(bar, 0);
}

// The block-wide (C = 1) or cluster-wide barrier, split into its arrival
// and its wait so that a block can issue its key loads in between. The
// cluster form also orders remote shared-memory accesses: the first one
// (after the histograms are zeroed) comes before any block writes
// another's histogram, the second one (after the scan) after the last
// such write. Every thread reaches each arrival and each wait once, at
// the same point of the code.
template <bool kCluster>
__device__ __forceinline__ void arrive_owners() {
  if constexpr (kCluster) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
}

template <bool kCluster>
__device__ __forceinline__ void wait_owners() {
  if constexpr (kCluster) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

template <bool kCluster>
__device__ __forceinline__ void sync_owners() {
  arrive_owners<kCluster>();
  wait_owners<kCluster>();
}

// The histogram entry of cell ``off`` (an offset into the cluster's cells,
// < span): this block's own, or the owner's through distributed shared
// memory. ``hist`` is at the same offset in every block.
template <bool kCluster, typename V>
__device__ __forceinline__ V* owner_entry(V* hist, uint32_t off,
                                          int tile_shift) {
  if constexpr (kCluster) {
    const uint32_t T = 1u << tile_shift;
    return cg::this_cluster().map_shared_rank(hist, off >> tile_shift) +
           (off & (T - 1));
  } else {
    return hist + off;
  }
}

// The key scan of row r. Calls hit(off, v) for every key j of this
// block's share (every key when C = 1, one C-th of them in a cluster)
// whose column falls in the cells the block or its cluster owns, off
// being the column's offset into them and v = vals[j]. Each thread loads
// kBatch keys' h1, h2 and value before it tests any, so that one round
// trip to L2 serves them all. Every block (or cluster) starts at its own
// point of the key list and wraps around. The first barrier (arrived at
// by the caller) is waited for after the first batch is loaded, before
// any hit writes a histogram.
template <bool kCluster, typename V, typename Hit>
__device__ __forceinline__ void scan_keys(const int64_t* __restrict__ h1,
                                          const int64_t* __restrict__ h2,
                                          const V* __restrict__ vals, int B,
                                          uint32_t r, int w, int tile_shift,
                                          Hit hit) {
  constexpr int kBatch = 8;
  const uint32_t T = 1u << tile_shift;
  uint32_t lo = blockIdx.x * T, span = T, cs = 1;
  int first = threadIdx.x, stride = blockDim.x;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    const uint32_t rank = cluster.block_rank();
    cs = cluster.num_blocks();
    lo = (blockIdx.x - rank) * T;
    span = cs * T;
    first = static_cast<int>(rank * blockDim.x + threadIdx.x);
    stride = static_cast<int>(cs * blockDim.x);
  }
  // The starting key of this block's cluster, a multiple of 32 (a warp
  // still reads consecutive keys); the same for every block of a cluster,
  // whose shares then stay disjoint.
  const uint32_t groups = gridDim.x / cs * gridDim.y;
  const uint32_t group = blockIdx.y * (gridDim.x / cs) + blockIdx.x / cs;
  const int rot = static_cast<int>(group * (static_cast<uint32_t>(B) /
                                             groups) & ~31u);
  const uint32_t mask = static_cast<uint32_t>(w - 1);
  uint32_t col[kBatch];
  V v[kBatch];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      const int j = i + rot < B ? i + rot : i + rot - B;
      col[u] = 0;
      v[u] = V(0);
      if (i < B) {
        col[u] = (static_cast<uint32_t>(__ldg(h1 + j)) +
                  r * static_cast<uint32_t>(__ldg(h2 + j))) &
                 mask;
        v[u] = __ldg(vals + j);
      }
    }
  };
  auto test = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const uint32_t off = col[u] - lo;
      if (i0 + u * stride < B && off < span) hit(off, v[u]);
    }
  };
  load(first);
  wait_owners<kCluster>();
  test(first);
  for (int i0 = first + kBatch * stride; i0 < B; i0 += kBatch * stride) {
    load(i0);
    test(i0);
  }
}

inline bool valid_tiling(int d, int w, int tile, int cluster) {
  if (d < 1 || tile < 16 || (tile & (tile - 1)) || tile > w || w % tile)
    return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return false;
  return (w / tile) % cluster == 0;
}

inline int tile_shift_of(int tile) {
  int s = 0;
  while ((1 << s) < tile) ++s;
  return s;
}

// A refused call's error, cleared from the thread's last-error state so
// that no later call reports it again.
inline cudaError_t refused(cudaError_t err) {
  cudaGetLastError();
  return err;
}

// Launch ``kernel`` over the (w / tile, d) grid with ``smem`` bytes of
// dynamic shared memory, in clusters of ``cluster`` blocks along a row.
// A tile whose shared memory does not fit a block is refused here.
template <typename... Params, typename... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), int d, int w, int tile,
                         int cluster, size_t smem, cudaStream_t stream,
                         Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return refused(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(w / tile),
                     static_cast<unsigned>(d), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return refused(err);
  return cudaGetLastError();
}

}  // namespace rl_tile
