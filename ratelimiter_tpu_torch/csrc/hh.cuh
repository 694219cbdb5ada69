// The heavy-hitter side table's update as one block-level routine. It is
// written once and run in two places:
//
//   - the fused tail of the two windowed backs' side-table builds
//     (sketch_kernels.cu add_back_kernel and window_admit_kernel, kHH,
//     with and without the cascade), after their batch-order loop, on the
//     block's own final mask and promotion targets: the side-table step
//     launches no update of its own up to the admission capacity;
//   - the standalone rl_hh_update (one block), for the composed back of a
//     batch above that capacity.
//
// It computes ops/sketch_cuda.py hh_update_plain's function (the JAX
// step's jnp ops at ratelimiter_tpu/ops/sketch_kernels.py:487-532; it
// replaces no TPU kernel):
//   - owned keys' admitted counts added to hh_cur and hh_totals (int32,
//     wrapping: the reference's int32 histogram);
//   - candidates (not owned, the slot free BEFORE the step, target_pr >=
//     f32(thresh)) claim their slot by a max of the packed
//     (ceil(clip(target_pr, 0, 2^30)) << 32) | h1;
//   - the winners' h2 (candidates whose packed value is their slot's
//     claim; equal claims mean equal h1) by a second max;
//   - a slot whose claim names a non-zero h1 takes it as its owner and the
//     winners' h2 as owner2 (a claim exists only on a free slot);
//   - hh_last = p at every slot an owned key or a candidate named.
//
// Two modes, by the table's size K (a power of two):
//
//   shared, K <= kSharedSlots (4096): a scratch of 26 bytes a slot in
//   shared memory (the claim as u64, the winners' h2 as u32, the owned
//   sum as i32, a touched flag, a free flag: the slot's owner before the
//   step is 0, and the slot's hh_cur and hh_totals), at most 106,496
//   bytes, zeroed, and the rest read coalesced in one round trip, by a
//   sweep when the routine opens: no request reads an owner from global
//   memory, and the last sweep only stores. Pass A (each request): the
//   owned sum by a native 32-bit shared atomicAdd, the touched flag (a
//   plain store of 1), and a candidate's claim by a 64-bit shared
//   atomicMax, skipped when a read shows the slot's claim already at
//   least as large (64-bit shared atomics are compare-and-swap loops).
//   Barrier (the block skips pass B and its barrier when no thread holds
//   a candidate). Pass B (each candidate): its h2 by a 32-bit shared
//   atomicMax where its packed value is the claim. Barrier. Pass C sweeps
//   the K slots, one thread a slot: hh_cur and hh_totals written (their
//   prefetched values plus the sum) where the sum is non-zero, the owner
//   pair where a claim landed, hh_last where the slot was touched. No
//   global atomics, and no pass to clear anything.
//
//   global, above (up to the config's 2^22): the scratch is the caller's
//   (2, K) int64 in global memory (the claims, then the winners' h2),
//   zero on entry and on return. Pass A: global atomicAdd on hh_cur and
//   hh_totals, hh_last written per request, the claim by a 64-bit global
//   atomicMax (a reduction the request does not wait on); pass B the same
//   on the second row; pass C walks the batch again and writes the owner
//   pair at each slot with a claim; pass D clears the scratch at the
//   slots the batch named (a sweep of 2^22 slots would cost more than the
//   batch).
//
// In a back (``Tail`` with ``masses``), pass A also keeps each
// candidate's claimed mass in shared memory (4 bytes a request, by batch
// index), and a thread remembers its candidates as bits: pass B rebuilds
// each claim from its mass and h1 and reads nothing else again. The
// standalone launch, whose batch may hold 2^20 requests, re-derives each
// request's candidacy in pass B instead.
//
// Where the scratch lives in a back's launch: after the results in batch
// order (rl_admit's tmp.u.out), which the tail reads; by then the rest of
// the launch's shared memory (the admission's table, sort and scans, the
// cascade's region and stash) is dead. The launch grows its dynamic
// shared memory where the union has no room (the small block shapes, and
// K = 4096 without the cascade): every shape stays below the cascade
// builds' largest, 205,120 bytes.
//
// h2 is a 32-bit half (0..2^32-1 in int64, as the fronts write it), so
// its max fits the shared scratch's u32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rl_hh {

// Tables of at most this many slots keep the scratch in shared memory.
constexpr int kSharedSlots = 4096;

// The side table's state and the step's scalars.
struct Table {
  long long* owner;             // int64 holding a u32 h1; 0 free
  long long* owner2;            // the owner's h2
  int32_t* cur;
  int32_t* totals;
  long long* last;              // the slot's last touched period
  unsigned long long* claims;   // global mode: the (2, K) scratch
  float thresh;                 // f32(thresh)
  long long p;                  // the step's period
  int K;                        // 0: no tail
};

__host__ __device__ constexpr bool shared_mode(int K) {
  return K <= kSharedSlots;
}

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The shared scratch of K slots (0 in global mode): claims (8 bytes a
// slot), winners' h2 (4), owned sums (4) and touched flags (1), zeroed
// together; then, from 16-byte boundaries, the free flags (1) and the
// prefetched hh_cur and hh_totals (4 each).
__host__ __device__ constexpr size_t zeroed_bytes(int K) {
  return round16(static_cast<size_t>(K) * 17);
}
__host__ __device__ constexpr size_t scratch_bytes(int K) {
  return shared_mode(K)
             ? zeroed_bytes(K) + round16(K) + static_cast<size_t>(K) * 8
             : 0;
}

// The claimed masses of a back's batch of ``capacity`` requests.
__host__ __device__ constexpr size_t mass_bytes(int capacity) {
  return static_cast<size_t>(capacity) * 4;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// A claim: ceil(clip(target_pr, 0, 2^30)) above the zero-extended h1.
__device__ __forceinline__ uint32_t mass_of(float tp) {
  return static_cast<uint32_t>(ceilf(fminf(fmaxf(tp, 0.0f), 1073741824.0f)));
}

__device__ __forceinline__ unsigned long long packed_of(uint32_t mass,
                                                        uint32_t h1) {
  return (static_cast<unsigned long long>(mass) << 32) | h1;
}

class Tail {
 public:
  // ``scratch``: the shared scratch (scratch_bytes(K), 16-byte aligned)
  // in shared mode; ``masses``: a back's per-request masses in shared
  // memory, or nullptr (the standalone launch).
  __device__ __forceinline__ Tail(const Table& t, unsigned char* scratch,
                                  uint32_t* masses = nullptr)
      : t_(t), mask_(static_cast<uint32_t>(t.K - 1)), masses_(masses) {
    if (shared_mode(t.K)) {
      claim_ = reinterpret_cast<unsigned long long*>(scratch);
      h2s_ = reinterpret_cast<uint32_t*>(claim_ + t.K);
      sum_ = reinterpret_cast<int32_t*>(h2s_ + t.K);
      touched_ = reinterpret_cast<uint8_t*>(sum_ + t.K);
      free_ = scratch + zeroed_bytes(t.K);
      cur_ = reinterpret_cast<int32_t*>(free_ + round16(t.K));
      tot_ = cur_ + t.K;
    } else {
      claim_ = t.claims;
    }
  }

  // Every thread of the block: behind a barrier (the scratch's earlier
  // tenants are dead), the shared scratch to zero, and each slot's owner,
  // hh_cur and hh_totals read (loads issued together), then a barrier.
  __device__ __forceinline__ void open() {
    if (!shared_mode(t_.K)) return;
    __syncthreads();
    int4* z = reinterpret_cast<int4*>(claim_);
    const int words = static_cast<int>(zeroed_bytes(t_.K) / 16);
    for (int j = threadIdx.x; j < words; j += blockDim.x)
      z[j] = make_int4(0, 0, 0, 0);
    for (int j = threadIdx.x; j < t_.K; j += blockDim.x) {
      const long long owner = t_.owner[j];
      const int32_t cur = t_.cur[j], tot = t_.totals[j];
      free_[j] = owner == 0;
      cur_[j] = cur;
      tot_[j] = tot;
    }
    __syncthreads();
  }

  // Whether a request is a candidate: not owned, its slot free before
  // the step (ownership is written only in close()), target_pr >=
  // f32(thresh).
  __device__ __forceinline__ bool candidate(uint32_t h1, bool mine,
                                            float tp) const {
    if (mine || !(tp >= t_.thresh)) return false;
    const uint32_t sid = h1 & mask_;
    return shared_mode(t_.K) ? free_[sid] != 0 : t_.owner[sid] == 0;
  }

  // Pass A for request i; returns whether it is a candidate.
  __device__ __forceinline__ bool count(int i, uint32_t h1, bool mine,
                                        bool allowed, int32_t n, float tp) {
    const uint32_t sid = h1 & mask_;
    const bool shared = shared_mode(t_.K);
    if (mine && allowed && n != 0) {
      if (shared) {
        atomicAdd(sum_ + sid, n);
      } else {
        atomicAdd(t_.cur + sid, n);
        atomicAdd(t_.totals + sid, n);
      }
    }
    const bool cand = candidate(h1, mine, tp);
    if (mine || cand) {
      if (shared) {
        touched_[sid] = 1;
      } else {
        t_.last[sid] = t_.p;
      }
    }
    if (cand) {
      const uint32_t mass = mass_of(tp);
      if (masses_ != nullptr) masses_[i] = mass;
      const unsigned long long packed = packed_of(mass, h1);
      if (!shared) {
        atomicMax(claim_ + sid, packed);
      } else if (packed > *reinterpret_cast<volatile unsigned long long*>(
                              claim_ + sid)) {
        atomicMax(claim_ + sid, packed);
      }
    }
    return cand;
  }

  // Pass B for one candidate (after a barrier), its claim ``packed``:
  // its h2 (``h2()``, read only for a winner) where it won.
  template <class H2>
  __device__ __forceinline__ void win(uint32_t h1, unsigned long long packed,
                                      H2 h2) {
    const uint32_t sid = h1 & mask_;
    if (shared_mode(t_.K)) {
      if (packed == claim_[sid]) atomicMax(h2s_ + sid, h2());
    } else if (packed == __ldcg(claim_ + sid)) {
      atomicMax(claim_ + t_.K + sid, static_cast<unsigned long long>(h2()));
    }
  }

  // A back's pass B for a thread's candidates (from the masses kept in
  // pass A), then pass C (and D), each behind a barrier. ``cands`` bit k:
  // the request at threadIdx.x + k * blockDim.x is a candidate; ``h1(i)``
  // and ``h2(i)`` read request i's halves again.
  template <class H1, class H2>
  __device__ __forceinline__ void finish(unsigned cands, H1 h1, H2 h2,
                                         int B) {
    if (__syncthreads_or(cands != 0)) {
      for (; cands != 0; cands &= cands - 1) {
        const int i = threadIdx.x + (__ffs(cands) - 1) * blockDim.x;
        const uint32_t k1 = h1(i);
        win(k1, packed_of(masses_[i], k1), [&] { return h2(i); });
      }
      __syncthreads();
    }
    close(h1, B);
  }

  // Pass C (after pass B's barrier). Shared mode sweeps the slots; global
  // mode walks the batch (``h1(i)``, i < B) for the owners, then clears
  // the scratch.
  template <class H1>
  __device__ __forceinline__ void close(H1 h1, int B) {
    if (shared_mode(t_.K)) {
      for (int j = threadIdx.x; j < t_.K; j += blockDim.x) {
        const int32_t s = sum_[j];
        if (s != 0) {
          t_.cur[j] = wrap_add(cur_[j], s);
          t_.totals[j] = wrap_add(tot_[j], s);
        }
        const unsigned long long c = claim_[j];
        if ((c & 0xFFFFFFFFull) != 0) {
          t_.owner[j] = static_cast<long long>(c & 0xFFFFFFFFull);
          t_.owner2[j] = static_cast<long long>(h2s_[j]);
        }
        if (touched_[j]) t_.last[j] = t_.p;
      }
      return;
    }
    unsigned long long* h2w = claim_ + t_.K;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const uint32_t sid = h1(i) & mask_;
      const unsigned long long c = __ldcg(claim_ + sid);
      if ((c & 0xFFFFFFFFull) != 0) {
        t_.owner[sid] = static_cast<long long>(c & 0xFFFFFFFFull);
        t_.owner2[sid] = static_cast<long long>(__ldcg(h2w + sid));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const uint32_t sid = h1(i) & mask_;
      claim_[sid] = 0;
      h2w[sid] = 0;
    }
  }

 private:
  Table t_;
  uint32_t mask_;
  uint32_t* masses_;
  unsigned long long* claim_;
  uint32_t* h2s_ = nullptr;
  int32_t* sum_ = nullptr;
  uint8_t* touched_ = nullptr;
  uint8_t* free_ = nullptr;
  int32_t* cur_ = nullptr;
  int32_t* tot_ = nullptr;
};

}  // namespace rl_hh
