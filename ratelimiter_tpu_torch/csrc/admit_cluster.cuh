// In-batch admission across a thread-block cluster, for the two backs
// whose launch does nothing after admission but write each request's
// results: rl_window_admit (sketch_kernels.cu) and rl_bucket_admit
// (bucket_kernels.cu), in their builds without the side table and the
// cascade. It computes what admit.cuh's one-block routine computes (the
// JAX package's ratelimiter_tpu/ops/segment.py:90-156, admit) with the
// same rounding rules (admit.cuh), on C blocks of one cluster instead of
// one block.
//
// A key's requests only ever meet requests of the same key, so the keys
// are partitioned over the cluster's blocks and each block admits its own
// keys alone:
//
//   1. Split: block r reads the r-th contiguous C-th of the batch (its
//      share, coalesced) and gives each request an owner block from bits
//      of h1 that the owner's hash table does not use (owner_of: the top
//      bits of h1 times another odd constant; the table takes the top
//      bits of h1 times the golden ratio). Every request of a key has one
//      owner, so no segment crosses a block. Each block ranks its requests
//      per owner, stably (a warp's __match_any_sync, then the warps'
//      counts scanned per owner).
//   2. Move: each block stores its requests' batch indices into a run of
//      its own in each owner's shared memory (at rank * share, through
//      map_shared_rank: st.shared::cluster), and its counts beside them;
//      one cluster barrier, after which no block touches another's shared
//      memory. The owner joins the runs in block order into one list,
//      which is then in batch order. The list is padded (one spare word
//      every 32) so that the blocked reads of the next step take no bank
//      conflicts.
//   3. Admit: each block runs admit.cuh's steps over the m requests it
//      owns, at the smallest of five shapes (kThreads x 1, 2, 4, 8 or 16
//      items) that holds m, picked at run time: the hash table, the sort
//      and the scans scale with m, not with B. The table's occupied slots
//      are numbered densely before the sort, so that it sorts only the
//      bits the number of keys needs (one pass for one key, where the
//      slots take three). A block's fixpoint stops at its own
//      fixed point: a segment's rounds do not depend on other segments
//      (admit.cuh's fixpoint). h1, n and avail are gathered from global
//      memory through the list (L2: the batch is ~0.1-0.2 MB).
//   4. Write: the owner stages each request's verdict and seen in list
//      order and writes its results (the caller's epilogue, ``Epi``) with
//      the list striped over its threads, so that a hot key's run of
//      consecutive batch indices writes coalesced. (Handing the results
//      back to the block whose share holds the request, through
//      distributed shared memory, spreads the writes over the cluster
//      but took 1.4-6 us more on an H100: PERF.md.)
//
// Capacity: one key may send the whole batch to one block, so each block
// holds kThreads * 16 requests: the list and the largest shape's storage,
// ~166 KB at 512 threads in int64 (8192 requests), ~82 KB at 256 (4096);
// one block per SM. The launch takes
// 256 threads a block up to 4096 requests and 512 above (launch_sized).
// The step entries (rl_window_admit, rl_bucket_admit) launch kCluster
// blocks above kClusterBatch requests and admit.cuh's one block at and
// below it (uses_cluster; ops/sketch_cuda.py mirrors the rule as
// admit_cluster for its logs). ``python3 chip_smoke.py --admit-sweep``
// times the cluster sizes and thread counts against the one-block
// routine, with the clock after each step, and both launches across the
// small batches (csrc/admit_bench.cu, PERF.md); both numbers come from it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "admit.cuh"
#include "tile_owner.cuh"

namespace rl_admit_cluster {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
// The step entries' cluster size (16: the card's non-portable size) and
// the largest batch they admit on one block (--admit-sweep on an H100,
// PERF.md).
constexpr int kCluster = 16;
constexpr int kClusterBatch = 128;
// Items a thread at the largest shape; the most rounds of the split.
constexpr int kMaxItems = 16;
// The owner's multiplier (odd; not the table's golden ratio).
constexpr unsigned long long kOwnerMix = 0xD6E8FEB86659FD93ull;

// The owner block of a key among 2^bits (bits >= 1).
__host__ __device__ __forceinline__ uint32_t owner_of(unsigned long long h1,
                                                      int bits) {
  return static_cast<uint32_t>((h1 * kOwnerMix) >> (64 - bits));
}

// A list position's index in the padded layout: one spare word every 32,
// so that a thread's blocked run of 1-16 positions and its neighbours'
// fall in 32 different banks.
__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

template <int kThreadsV, class Q>
struct Storage {
  static constexpr int kThreads = kThreadsV;
  static constexpr int kCapacity = kThreads * kMaxItems;
  static constexpr int kWarps = kThreads / 32;
  int list[kCapacity + kCapacity / 32];  // batch indices, dense, padded
  int sent[kMaxCluster];                 // requests block s sent here
  int start[kMaxCluster + 1];            // where block s's run starts
  int warp_count[kWarps][kMaxCluster];
  int count[kMaxCluster];                // this block's requests per owner
  union {
    int raw[kCapacity];  // block s's run at [s * share, ...), as received
    typename rl_admit::Shape<kThreads, 1, Q>::Storage s1;
    typename rl_admit::Shape<kThreads, 2, Q>::Storage s2;
    typename rl_admit::Shape<kThreads, 4, Q>::Storage s4;
    typename rl_admit::Shape<kThreads, 8, Q>::Storage s8;
    typename rl_admit::Shape<kThreads, 16, Q>::Storage s16;
  } u;
};

// No phase marks (the step kernels); csrc/admit_bench.cu passes one that
// records the clock after each step.
struct NoMarks {
  __device__ __forceinline__ void operator()(int) const {}
};

// Steps 3-4 at shape S over the m requests of the (padded) ``list``.
// ``epi.load(i)`` reads what request i's results need (a thread's loads
// are all issued before its writes), ``epi.write(i, operands, allowed,
// seen)`` writes them.
template <class S, class Q, class Epi, class Marks>
__device__ __forceinline__ void admit_block(typename S::Storage& tmp,
                                            const int* list,
                                            const int64_t* __restrict__ h1,
                                            const Q* __restrict__ n,
                                            const Q* __restrict__ avail,
                                            int m, int iters, const Epi& epi,
                                            const Marks& mark) {
  constexpr int kThreads = S::kThreads, kItems = S::kItems;
  constexpr int kPer = S::kSlots / kThreads;
  rl_admit::Sorted<Q, kItems> s;
  // The keys at the blocked positions the sort ranks, all loads issued
  // while the table clears.
  unsigned long long key[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = threadIdx.x * kItems + k;
    key[k] = p < m
                 ? static_cast<unsigned long long>(__ldg(h1 + list[pad(p)]))
                 : rl_admit::kEmpty;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    tmp.u.table[r * kThreads + threadIdx.x] = rl_admit::kEmpty;
  __syncthreads();
  uint32_t id[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = threadIdx.x * kItems + k;
    id[k] = rl_admit::group_id<S>(tmp, key[k], p < m);
    s.idx[k] = p;
  }
  __syncthreads();
  // Dense group ids: the occupied slots numbered 0 .. G-1 (in any order:
  // only equality matters), a batch key equal to the empty mark G and the
  // padding G + 1, so that the sort takes only the bits G + 1 needs (one
  // pass for one key, where the slots take three).
  int c = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    c += tmp.u.table[r * kThreads + threadIdx.x] != rl_admit::kEmpty;
  using IntScan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  static_assert(sizeof(typename IntScan::TempStorage) <=
                    sizeof(typename S::Scan::TempStorage),
                "the count scan fits the scans' storage");
  int next, groups;
  IntScan(*reinterpret_cast<typename IntScan::TempStorage*>(&tmp.scan))
      .ExclusiveSum(c, next, groups);
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    unsigned long long& slot = tmp.u.table[r * kThreads + threadIdx.x];
    if (slot != rl_admit::kEmpty) slot = next++;
  }
  __syncthreads();
  const uint32_t G = static_cast<uint32_t>(groups);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    id[k] = id[k] < static_cast<uint32_t>(S::kSlots)
                ? static_cast<uint32_t>(tmp.u.table[id[k]])
                : G + (id[k] == S::kPast ? 1u : 0u);
  }
  const int end_bit = 32 - __clz(G + 1);
  __syncthreads();  // the table is dead; its storage takes the sort
  mark(4);
  typename S::Sort(tmp.u.sort).Sort(id, s.idx, 0, end_bit);
  __syncthreads();
  typename S::Heads(tmp.u.heads).FlagHeadsAndTails(s.head, s.tail, id,
                                                   rl_admit::Differ());
  // The operands in sorted order, gathered through the list.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = s.idx[k];
    const int i = p < m ? list[pad(p)] : 0;
    s.n[k] = p < m ? __ldg(n + i) : Q(0);
    s.avail[k] = p < m ? __ldg(avail + i) : Q(0);
    s.allowed[k] = true;
  }
  mark(5);
  Q cons[kItems];
  rl_admit::fixpoint<S>(tmp, s, iters, cons);
  mark(6);
  // Step 4: the results staged in list order (the union's last use, the
  // heads, is behind the scans' barriers), then written with the list
  // striped over the threads: a run of consecutive batch indices (a hot
  // key's) writes coalesced.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = s.idx[k];
    if (p < m) {
      tmp.u.out.seen[p] = rl_admit::sub(s.avail[k], cons[k]);
      tmp.u.out.allowed[p] = s.allowed[k];
    }
  }
  __syncthreads();
  typename Epi::Operands x[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = k * kThreads + threadIdx.x;
    if (p < m) x[k] = epi.load(list[pad(p)]);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = k * kThreads + threadIdx.x;
    if (p < m)
      epi.write(list[pad(p)], x[k], tmp.u.out.allowed[p],
                tmp.u.out.seen[p]);
  }
  mark(7);
}

// Every thread of every block of the cluster calls it (a cluster of C
// blocks, C a power of two in [2, kMaxCluster]; B <= Storage::kCapacity).
// Returns the number of requests this block admitted. ``mark(step)`` is
// called after each step, 0 to 7.
template <int kThreads, class Q, class Epi, class Marks = NoMarks>
__device__ __forceinline__ int admit(Storage<kThreads, Q>& st,
                                     const int64_t* __restrict__ h1,
                                     const Q* __restrict__ n,
                                     const Q* __restrict__ avail, int B,
                                     int iters, const Epi& epi,
                                     const Marks& mark = Marks()) {
  using St = Storage<kThreads, Q>;
  constexpr int kShare = kMaxItems / 2;  // rounds of a share (C >= 2)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int bits = __ffs(C) - 1;
  const int rank = static_cast<int>(cluster.block_rank());
  mark(0);
  // The first barrier: every block of the cluster has started before any
  // block stores into another's shared memory (waited for below).
  rl_tile::arrive_owners<true>();
  const int share = (B + C - 1) / C;
  const int lo = min(B, rank * share), hi = min(B, lo + share);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < kMaxCluster) st.count[threadIdx.x] = 0;
  // Step 1 within the block, kThreads requests a round: each request's
  // owner and its rank among the block's requests for that owner.
  const int rounds = (hi - lo + kThreads - 1) / kThreads;
  uint32_t own[kShare];
  int pos[kShare];
#pragma unroll
  for (int r = 0; r < kShare; ++r) {
    own[r] = C;
    pos[r] = 0;
    if (r < rounds) {
      const int j = lo + r * kThreads + threadIdx.x;
      const bool valid = j < hi;
      const uint32_t o =
          valid ? owner_of(static_cast<unsigned long long>(__ldg(h1 + j)),
                           bits)
                : static_cast<uint32_t>(C);
      const unsigned same = __match_any_sync(0xffffffffu, o);
      const int before = __popc(same & ((1u << lane) - 1u));
      if (lane < kMaxCluster) st.warp_count[warp][lane] = 0;
      __syncwarp();
      if (valid && before == 0) st.warp_count[warp][o] = __popc(same);
      __syncthreads();
      if (threadIdx.x < C) {
        int run = st.count[threadIdx.x];
        for (int w = 0; w < St::kWarps; ++w) {
          const int c = st.warp_count[w][threadIdx.x];
          st.warp_count[w][threadIdx.x] = run;
          run += c;
        }
        st.count[threadIdx.x] = run;
      }
      __syncthreads();
      if (valid) {
        own[r] = o;
        pos[r] = st.warp_count[warp][o] + before;
      }
      __syncthreads();  // read before the next round clears the counts
    }
  }
  mark(1);
  rl_tile::wait_owners<true>();
  // Step 2: each request's batch index into its owner's run for this
  // block, and this block's counts into every owner; one cluster barrier,
  // after which no block touches another's shared memory.
#pragma unroll
  for (int r = 0; r < kShare; ++r) {
    if (own[r] < static_cast<uint32_t>(C)) {
      int* raw = cluster.map_shared_rank(st.u.raw, static_cast<int>(own[r]));
      raw[rank * share + pos[r]] = lo + r * kThreads + threadIdx.x;
    }
  }
  if (threadIdx.x < C)
    *cluster.map_shared_rank(&st.sent[rank], static_cast<int>(threadIdx.x)) =
        st.count[threadIdx.x];
  rl_tile::sync_owners<true>();
  mark(2);
  // The runs joined in block order into one dense list, in batch order
  // (block s's share precedes block s + 1's).
  if (threadIdx.x == 0) {
    int at = 0;
    for (int s = 0; s < C; ++s) {
      st.start[s] = at;
      at += st.sent[s];
    }
    st.start[C] = at;
  }
  __syncthreads();
  const int m = st.start[C];
  for (int j = threadIdx.x; j < C * share; j += kThreads) {
    const int s = j / share, q = j - s * share;
    if (q < st.sent[s]) st.list[pad(st.start[s] + q)] = st.u.raw[j];
  }
  __syncthreads();
  mark(3);
  if (m == 0) return 0;
  if (m <= kThreads) {
    admit_block<rl_admit::Shape<kThreads, 1, Q>, Q>(
        st.u.s1, st.list, h1, n, avail, m, iters, epi, mark);
  } else if (m <= 2 * kThreads) {
    admit_block<rl_admit::Shape<kThreads, 2, Q>, Q>(
        st.u.s2, st.list, h1, n, avail, m, iters, epi, mark);
  } else if (m <= 4 * kThreads) {
    admit_block<rl_admit::Shape<kThreads, 4, Q>, Q>(
        st.u.s4, st.list, h1, n, avail, m, iters, epi, mark);
  } else if (m <= 8 * kThreads) {
    admit_block<rl_admit::Shape<kThreads, 8, Q>, Q>(
        st.u.s8, st.list, h1, n, avail, m, iters, epi, mark);
  } else {
    admit_block<rl_admit::Shape<kThreads, 16, Q>, Q>(
        st.u.s16, st.list, h1, n, avail, m, iters, epi, mark);
  }
  return m;
}

inline bool valid_cluster(int cluster) {
  return cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
}

// Whether a step entry's build without the side table and the cascade
// launches the cluster (kCluster blocks) for B requests, not one block.
inline bool uses_cluster(int B) { return B > kClusterBatch; }

// One cluster of ``cluster`` blocks of ``kernel`` (a __global__ function
// taking ``a`` by value, whose blocks run admit<kThreads, Q>) with the
// routine's storage as dynamic shared memory; 16 blocks only with the
// non-portable size allowed. Returns the launch's cudaError_t: a cluster
// the card cannot place is refused, never run some other way.
template <int kThreads, class Q, class Args>
int launch(void (*kernel)(Args), const Args& a, int cluster,
           cudaStream_t stream) {
  if (!valid_cluster(cluster) || a.B < 0 ||
      a.B > Storage<kThreads, Q>::kCapacity || a.iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Storage<kThreads, Q>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(rl_tile::refused(e));
  if (cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(rl_tile::refused(e));
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(rl_tile::refused(e));
  return static_cast<int>(cudaGetLastError());
}

// The launch at the thread count for ``a.B``: ``Kernel::fn<kThreads>()``
// returns the __global__ function (its quantity type ``Kernel::Q``).
template <class Kernel, class Args>
int launch_sized(const Args& a, int cluster, cudaStream_t stream) {
  using Q = typename Kernel::Q;
  if (a.B <= Storage<256, Q>::kCapacity)
    return launch<256, Q>(Kernel::template fn<256>(), a, cluster, stream);
  return launch<512, Q>(Kernel::template fn<512>(), a, cluster, stream);
}

}  // namespace rl_admit_cluster
