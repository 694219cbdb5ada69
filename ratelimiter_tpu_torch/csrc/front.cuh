// Device helpers for the two front kernels (rl_window_front in
// sketch_kernels.cu, rl_bucket_front in bucket_kernels.cu).
//
// A front kernel is the one launch that turns a batch's staged keys into
// the operands of admission: one thread per key hashes it (or reads its
// halves), issues all of its sketch cell loads, looks its limit up in the
// policy table while those loads are in flight, then folds the estimate
// and writes est, the available quota and the request units. The JAX
// package jits the same chain (hashing, estimate, lookup, quota) into a
// few XLA fusions around the Pallas estimate; the port used to launch
// each of its ~50 ops separately.
//
// What is shared here: splitmix64 and the seeded split
// (ops/hashing.py), the column rule (h1 + r*h2) & (w-1), and the policy
// lookup (ops/policy_kernels.py::lookup_i64), with the table's sorted key
// column staged in shared memory by one bulk asynchronous copy when it is
// small enough. The dense step (dense_kernels.cu) searches its table with
// policy_row too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_owner.cuh"

namespace rl_front {

// SketchParams.depth is at most 16 (core/config.py). The front kernels
// are compiled for one depth exactly, kDepth = 4 (the default and every
// configuration the repo ships), and for any depth up to kMaxDepth
// (kDepth = 0), whose unrolled row loops test r < d at every row: in a
// launch this short those tests show in its time (PERF.md).
constexpr int kMaxDepth = 16;
constexpr int kShippedDepth = 4;

// Key columns of at most this many bytes (4096 keys) are staged in shared
// memory, within a block's default 48 KB; larger ones (up to 2^20 keys)
// are searched in global memory.
constexpr int kSmemTableBytes = 48 * 1024;

// The launch shapes the wrappers may ask for (threads per block).
constexpr int kMaxThreads = 256;

// Where a key's halves come from.
enum Lane : int {
  kPremix = 0,  // raw u64 ids: splitmix64, then the seeded split
  kHashed = 1,  // finalized 64-bit hashes: the seeded split
  kHalves = 2,  // h1 and h2 given (resets, build_steps' steps)
};

// Where the policy table's key column is searched.
enum Table : int { kNoTable = 0, kShared = 1, kGlobal = 2 };

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Keys {
  const int64_t* h64;  // the staged keys (premix and hashed lanes)
  int64_t* h1;         // read in the halves lane, written in the others,
  int64_t* h2;         // as int64 holding 0..2^32-1
  uint64_t seed;       // split_hash's remix seed (0: none)
  int lane;
};

// Key i's halves, as split_hash computes them: h = splitmix64(h ^ seed)
// when seeded, h1 = the low 32 bits, h2 = the high 32 bits | 1.
__device__ __forceinline__ void halves(const Keys& k, int i, uint32_t& h1,
                                       uint32_t& h2) {
  if (k.lane == kHalves) {
    h1 = static_cast<uint32_t>(k.h1[i]);
    h2 = static_cast<uint32_t>(k.h2[i]);
    return;
  }
  uint64_t h = static_cast<uint64_t>(k.h64[i]);
  if (k.lane == kPremix) h = splitmix64(h);
  if (k.seed != 0) h = splitmix64(h ^ k.seed);
  h1 = static_cast<uint32_t>(h);
  h2 = static_cast<uint32_t>(h >> 32) | 1u;
  k.h1[i] = h1;
  k.h2[i] = h2;
}

__device__ __forceinline__ size_t cell(uint32_t h1, uint32_t h2, int r,
                                       int w) {
  const uint32_t col =
      (h1 + static_cast<uint32_t>(r) * h2) & static_cast<uint32_t>(w - 1);
  return static_cast<size_t>(r) * w + col;
}

struct Policy {
  const long long* key;    // sorted, PAD_KEY-padded; nullptr: no table
  const long long* limit;  // each row's limit (pad rows: the default)
  int P;                   // a power of two
  long long dflt;          // the limit of a key with no override
};

// Start staging the key column (kShared: thread 0 starts one bulk copy
// into ``smem``, completing on ``bar``). Returns the column to search.
// Every thread of the block calls it: it ends in a barrier, so that the
// initialised mbarrier is visible before any thread waits on it.
template <int kTable>
__device__ __forceinline__ const long long* stage_table(const Policy& p,
                                                        long long* smem,
                                                        uint64_t* bar) {
  if constexpr (kTable == kShared) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(p.P) * 8;
      rl_tile::mbar_init(bar);
      rl_tile::mbar_expect_tx(bar, bytes);
      rl_tile::bulk_load(smem, p.key, bytes, bar);
    }
    __syncthreads();
    return smem;
  } else {
    return p.key;
  }
}

// A block none of whose threads holds a key (B = 0) must not exit before
// its copy has landed in its shared memory.
template <int kTable>
__device__ __forceinline__ void drain_table(uint64_t* bar) {
  if constexpr (kTable == kShared) {
    if (threadIdx.x == 0) rl_tile::mbar_wait(bar, 0);
  }
}

// The row of query q in the sorted key column (``key(j)`` reads row j of
// P, a power of two), exactly as lookup_i64 finds it: idx = the largest i
// with key[i] <= q (the descent starts at step P, so the last row of a
// full table is reachable; -1 when every key is greater); the row is idx
// when idx >= 0 and key[idx] == q, else -1. A query equal to PAD_KEY
// lands on the last pad row, which holds the defaults. Branchless: each
// step's probe is clamped into the column and its result selected.
template <class KeyAt>
__device__ __forceinline__ int policy_row(KeyAt key, int P, long long q) {
  int idx = -1;
  for (int step = P; step >= 1; step >>= 1) {
    const int cand = idx + step;
    const long long probe = key(cand < P ? cand : P - 1);
    idx = (cand < P && probe <= q) ? cand : idx;
  }
  const int safe = idx > 0 ? idx : 0;
  return (idx >= 0 && key(safe) == q) ? safe : -1;
}

// The limit of the key with halves (h1, h2), exactly as lookup_i64 and
// the step's where() give it: its row's limit for q = (h1 << 32) | h2 as
// int64 (policy_row), the default when it has none.
template <int kTable>
__device__ __forceinline__ long long policy_limit(const Policy& p,
                                                  const long long* keys,
                                                  uint64_t* bar, uint32_t h1,
                                                  uint32_t h2) {
  if constexpr (kTable == kNoTable) {
    return p.dflt;
  } else {
    if constexpr (kTable == kShared) rl_tile::mbar_wait(bar, 0);
    const long long q =
        static_cast<long long>((static_cast<uint64_t>(h1) << 32) | h2);
    auto key = [&](int j) {
      if constexpr (kTable == kShared) {
        return keys[j];
      } else {
        return __ldg(keys + j);
      }
    };
    const int row = policy_row(key, p.P, q);
    return row >= 0 ? __ldg(p.limit + row) : p.dflt;
  }
}

inline int table_mode(const void* key, int P) {
  if (key == nullptr) return kNoTable;
  return static_cast<long long>(P) * 8 <= kSmemTableBytes ? kShared : kGlobal;
}

inline bool valid_front(int B, int d, int w, int P, const void* key,
                        int threads) {
  if (B < 0 || d < 1 || d > kMaxDepth || w < 16 || (w & (w - 1))) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  return key == nullptr || (P >= 2 && (P & (P - 1)) == 0);
}

// One block at least, so that thread 0 of block 0 writes the 0-d outputs
// even for an empty batch.
inline int front_blocks(int B, int threads) {
  return B > 0 ? (B + threads - 1) / threads : 1;
}

// A front launches through Kernel::run<kTable, kDepth>(grid, threads,
// smem, stream, a), a struct wrapping its kernel template (a __global__
// function cannot be a member). d == kShippedDepth takes the exact build,
// any other depth the generic one.
template <class Kernel, int kTable, class Args>
void launch_depth(dim3 grid, int threads, size_t smem, cudaStream_t s,
                  const Args& a) {
  if (a.d == kShippedDepth) {
    Kernel::template run<kTable, kShippedDepth>(grid, threads, smem, s, a);
  } else {
    Kernel::template run<kTable, 0>(grid, threads, smem, s, a);
  }
}

// One launch of a front over the arguments ``a`` (fields B, d, w and
// policy): the table mode picks where the key column is searched and the
// shared memory its staging takes. Returns the launch's cudaError_t.
template <class Kernel, class Args>
int launch(const Args& a, int threads, cudaStream_t s) {
  const Policy& p = a.policy;
  if (!valid_front(a.B, a.d, a.w, p.P, p.key, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(front_blocks(a.B, threads));
  switch (table_mode(p.key, p.P)) {
    case kShared:
      launch_depth<Kernel, kShared>(grid, threads,
                                    static_cast<size_t>(p.P) * 8, s, a);
      break;
    case kGlobal:
      launch_depth<Kernel, kGlobal>(grid, threads, 0, s, a);
      break;
    default:
      launch_depth<Kernel, kNoTable>(grid, threads, 0, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rl_front
