// In-batch admission as one block-level routine, shared by the three backs
// of the decision step: rl_add_back and rl_window_admit
// (sketch_kernels.cu) and rl_bucket_admit (bucket_kernels.cu), and by the
// dense backend's step, rl_dense_step (dense_kernels.cu), which groups on
// the slot id and reads operands its own block computed (admit_by).
//
// It computes what ops/segment.py::admit computes (the JAX package's
// ratelimiter_tpu/ops/segment.py:90-156, admit): greedy-in-batch-order
// admission by a bounded fixpoint, for f32 request counts (windowed) or
// int64 micro-units (bucket). The plain version runs ~77 torch ops on the
// card (one sort, six cumsums, six cummaxes, gathers, index_put, ~60
// elementwise ops); here ONE block of the launch holds the whole batch in
// registers and shared memory:
//
//   1. Group: each key's h1 (the full 64-bit value the plain version
//      groups on; the front writes 32-bit halves, the halves lane takes
//      h1 from a caller) is inserted into an open-addressing hash table in
//      shared memory (64-bit compare-and-swap after a read, so a key whose
//      slot is already visible costs no atomic; electing one lane per key
//      with __match_any_sync was slower on Zipf batches). A key's slot is
//      its group id: equal ids iff equal keys, in at most log2(2 *
//      capacity) + 1 bits. A stable block radix sort of (group id, batch
//      index) (CUB's cub::BlockRadixSort, a building block inside this
//      kernel, which launches nothing of its own) then takes 2-3 passes of
//      5 bits where the keys themselves would take 8-16 of 4 bits. Only
//      equality matters across groups, and within a group the batch
//      order, which a stable sort keeps.
//   2. Segment heads and tails: id[j] != id[j-1], id[j] != id[j+1]
//      (cub::BlockDiscontinuity).
//   3. iters fixpoint rounds, the safety intersection and the final
//      consumption: iters + 2 segmented exclusive sums (fewer when a
//      round finds a fixed point, with the same result), each one
//      cub::BlockScan of (value, head) pairs under the segmented-sum
//      operator, in 64-bit integers, minus the item's own value. This is
//      the same integer as the plain version's global exclusive cumsum
//      less its segment head's value (segment.py:38-48), modulo 2^64 in
//      both. The segment-relative sum is cast back to the quantity's type.
//   4. Each item keeps its batch index from the sort, so the caller's
//      epilogue writes every result back in batch order.
//
// Rounding and integer traps:
//   - f32 (windowed): the sums are taken over int64(n_f), the f32 counts
//     the front wrote (NOT the int32 n: f32(n) rounds above 2^24, and the
//     reference sums the rounded value), and cast back with __ll2float_rn,
//     as torch's int64 -> f32 cast rounds. cons + n <= avail is one f32
//     add and compare, seen = avail - cons one f32 subtract; the library
//     is built with -fmad=false, so nothing contracts. The JAX package
//     sums in f32 while the batch total is below 2^24 and otherwise
//     exactly in int32 limbs (segment.py:133-147); both give these
//     integers (tests/test_torch_ops.py pins it).
//   - int64 (bucket): everything stays int64. Sums, adds and subtracts
//     wrap modulo 2^64 as torch's int64 ops do (unsigned arithmetic here,
//     never signed overflow).
//   - Padding: n = 0 is an ordinary item, exactly as in the plain version.
//     Slots past B take the largest group id and n = 0: they sort after
//     every batch item, add nothing to any sum that a batch item reads,
//     and nothing is written for them. The table's empty mark is the
//     all-ones key; a batch key equal to it takes a group id of its own.
//
// Capacity: a launch takes the smallest block shape (threads, keys per
// thread) that holds B keys, up to kMaxCapacity = 8192, the largest power
// of two whose table (two 8-byte slots a key, 128 KB) fits the 227 KB of
// shared memory a block may take; the wrappers run the plain composition
// on the card above it, the hierarchy cascade and the dense step included
// (ops/sketch_cuda.py, ADMIT_CAPACITY; ops/dense_cuda.py). The shapes
// come from ``python3 chip_smoke.py --admit-sweep`` on an H100
// (csrc/admit_bench.cu, PERF.md): 64x4 up to 256 keys, 256x4 up to 1024, 512x8 up to 4096
// (1024x4 and 256x16 were slower on Zipf ids and on one key), 1024x8 up
// to 8192 (512x16 was faster on Zipf ids and far slower on distinct
// keys, whose table inserts each thread issues one after another).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_discontinuity.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace rl_admit {

constexpr int kMaxCapacity = 8192;

// Bits per radix sort pass over the group ids: 5 (3 passes over the
// 14-15 bit ids) was ~1 us faster than CUB's default of 4 (4 passes) on an
// H100 at 4096 and 8192 keys (PERF.md).
constexpr int kRadixBits = 5;

// A partial segmented sum: the sum since the last head, and whether a head
// was seen. Associative, so a block scan may combine in any grouping.
struct Seg {
  unsigned long long v;
  int head;
};

struct SegSum {
  __device__ __forceinline__ Seg operator()(const Seg& a, const Seg& b) const {
    Seg s;
    s.v = b.head ? b.v : a.v + b.v;
    s.head = a.head | b.head;
    return s;
  }
};

// The same over 32-bit sums (modulo 2^32), for quantities whose sums
// are read modulo 2^32: half the words a scan moves.
struct Seg32 {
  uint32_t v;
  int head;
};

struct SegSum32 {
  __device__ __forceinline__ Seg32 operator()(const Seg32& a,
                                              const Seg32& b) const {
    Seg32 s;
    s.v = b.head ? b.v : a.v + b.v;
    s.head = a.head | b.head;
    return s;
  }
};

struct Differ {
  __device__ __forceinline__ bool operator()(const uint32_t& a,
                                             const uint32_t& b) const {
    return a != b;
  }
};

constexpr unsigned long long kEmpty = ~0ull;

// The quantity's integer value for the sums (torch's .to(int64): both
// quantities are integer-valued), and back.
__device__ __forceinline__ unsigned long long units(float x) {
  return static_cast<unsigned long long>(static_cast<long long>(x));
}
__device__ __forceinline__ unsigned long long units(long long x) {
  return static_cast<unsigned long long>(x);
}
__device__ __forceinline__ void from_units(unsigned long long u, float& q) {
  q = __ll2float_rn(static_cast<long long>(u));
}
__device__ __forceinline__ void from_units(unsigned long long u,
                                           long long& q) {
  q = static_cast<long long>(u);
}

// a + b and a - b as torch computes them in the quantity's type.
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ long long add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ long long sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

constexpr int log2_ceil(int x) {
  int b = 0;
  while ((1 << b) < x) ++b;
  return b;
}

// A block shape: kThreads threads holding kItems keys each, the quantity
// type Q (f32 counts or int64 micro-units), kBits per sort pass.
template <int kThreadsV, int kItemsV, class Q, int kBits = kRadixBits>
struct Shape {
  using Quantity = Q;
  static constexpr int kThreads = kThreadsV;
  static constexpr int kItems = kItemsV;
  static constexpr int kCapacity = kThreads * kItems;
  // The hash table: twice the capacity (load factor <= 1/2). Group ids
  // are its slots, then kAllOnes (a batch key equal to the empty mark)
  // and kPast (the slots past the batch), the largest.
  static constexpr int kTableBits = log2_ceil(2 * kCapacity);
  static constexpr int kSlots = 1 << kTableBits;
  static constexpr uint32_t kAllOnes = kSlots;
  static constexpr uint32_t kPast = kSlots + 1;
  static constexpr int kIdBits = kTableBits + 1;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, int, kBits>;
  using Heads = cub::BlockDiscontinuity<uint32_t, kThreads>;
  using Scan = cub::BlockScan<Seg, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  using Scan32 =
      cub::BlockScan<Seg32, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  // One use at a time, each reuse behind a barrier: the table, the sort,
  // the heads, the operands in batch order (read coalesced, gathered from
  // shared memory in sorted order) and the results in batch order
  // (scattered into shared memory, written out coalesced). The scans'
  // storage is apart, so that a back may scan again while the results
  // are held.
  struct Storage {
    union {
      unsigned long long table[kSlots];
      typename Sort::TempStorage sort;
      typename Heads::TempStorage heads;
      struct {
        Q n[kCapacity];
        Q avail[kCapacity];
      } in;
      struct {
        Q seen[kCapacity];
        bool allowed[kCapacity];
      } out;
    } u;
    typename Scan::TempStorage scan;
  };
};

// A block scan of 32-bit segmented sums in the storage of the 64-bit
// one (which is larger: its words are).
template <class S>
__device__ __forceinline__ void scan32(typename S::Storage& tmp,
                                       Seg32 (&seg)[S::kItems]) {
  static_assert(sizeof(typename S::Scan32::TempStorage) <=
                    sizeof(typename S::Scan::TempStorage),
                "the 32-bit scan fits the 64-bit scan's storage");
  typename S::Scan32(
      *reinterpret_cast<typename S::Scan32::TempStorage*>(&tmp.scan))
      .InclusiveScan(seg, seg, SegSum32());
}

// An inclusive block scan of segmented sums, 64- or 32-bit.
template <class S>
__device__ __forceinline__ void inclusive(typename S::Storage& tmp,
                                          Seg (&seg)[S::kItems]) {
  typename S::Scan(tmp.scan).InclusiveScan(seg, seg, SegSum());
}
template <class S>
__device__ __forceinline__ void inclusive(typename S::Storage& tmp,
                                          Seg32 (&seg)[S::kItems]) {
  scan32<S>(tmp, seg);
}

// A thread's kItems consecutive items in sorted order.
template <class Q, int kItems>
struct Sorted {
  int idx[kItems];                 // batch index; >= B past the batch
  int head[kItems];                // first item of its key's segment
  int tail[kItems];                // last item of its key's segment
  Q n[kItems];                     // n_f or n_units (0 past the batch)
  Q avail[kItems];
  bool allowed[kItems];
  __device__ __forceinline__ bool is_head(int k) const { return head[k]; }
  __device__ __forceinline__ bool is_tail(int k) const { return tail[k]; }
  __device__ __forceinline__ bool is_allowed(int k) const {
    return allowed[k];
  }
};

// The same items in fewer registers (the cascade builds, whose block
// runs more after admission): the batch index, and the segment heads,
// tails and the mask as one bit an item; n and avail stay in shared
// memory (admit_packed).
template <int kItems>
struct Packed {
  int idx[kItems];
  unsigned head, tail, allowed;  // bit k: item k
  __device__ __forceinline__ bool is_head(int k) const {
    return (head >> k) & 1u;
  }
  __device__ __forceinline__ bool is_tail(int k) const {
    return (tail >> k) & 1u;
  }
  __device__ __forceinline__ bool is_allowed(int k) const {
    return (allowed >> k) & 1u;
  }
};

// cons[k] = the segment-exclusive sum of n over allowed items, in Q.
template <class S, class Q = typename S::Quantity>
__device__ __forceinline__ void exclusive(
    typename S::Storage& tmp, const Sorted<Q, S::kItems>& s,
    Q (&cons)[S::kItems]) {
  unsigned long long x[S::kItems];
  Seg seg[S::kItems];
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) {
    x[k] = s.allowed[k] ? units(s.n[k]) : 0ull;
    seg[k].v = x[k];
    seg[k].head = s.head[k];
  }
  __syncthreads();  // the storage's last use is over
  typename S::Scan(tmp.scan).InclusiveScan(seg, seg, SegSum());
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) from_units(seg[k].v - x[k], cons[k]);
}

// The group id of ``key`` (kEmpty past the batch): its slot in the table,
// found or claimed by linear probing from a Fibonacci hash. A slot that
// already holds the key is read, not claimed, so a hot key's atomics stop
// once its slot is visible.
template <class S>
__device__ __forceinline__ uint32_t group_id(typename S::Storage& tmp,
                                             unsigned long long key,
                                             bool valid) {
  if (key == kEmpty) return valid ? S::kAllOnes : S::kPast;
  uint32_t slot = static_cast<uint32_t>((key * 0x9E3779B97F4A7C15ull) >>
                                        (64 - S::kTableBits));
  for (;;) {
    unsigned long long held =
        *reinterpret_cast<volatile unsigned long long*>(&tmp.u.table[slot]);
    if (held == kEmpty) held = atomicCAS(&tmp.u.table[slot], kEmpty, key);
    if (held == kEmpty || held == key) return slot;
    slot = (slot + 1) & (S::kSlots - 1);
  }
}

// Every thread of the block calls it. ``key(j)`` is request j's group
// key (any 64-bit value; only equality matters) and ``load(i, n, avail)``
// reads request i's operands, for j, i < B in batch order. On return
// (after a barrier) tmp.u.out.allowed[i] and tmp.u.out.seen[i] hold
// request i's results, for every i < B, in batch order, and ``s`` the
// thread's items in sorted order with their segment heads and tails and
// final mask.
// Steps 1-2 for every thread of the block, then the operands in batch
// order into tmp.u.in (``load``); returns, after a barrier, the thread's
// items in sorted order: batch indices, segment heads and tails.
template <class S, class Key, class Load>
__device__ __forceinline__ void group(typename S::Storage& tmp, Key key,
                                      Load load, int B,
                                      int (&idx)[S::kItems],
                                      int (&head)[S::kItems],
                                      int (&tail)[S::kItems]) {
  constexpr int kThreads = S::kThreads, kItems = S::kItems;
  for (int j = threadIdx.x; j < S::kSlots; j += kThreads)
    tmp.u.table[j] = kEmpty;
  __syncthreads();
  uint32_t id[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    const bool valid = j < B;
    id[k] = group_id<S>(tmp, valid ? key(j) : kEmpty, valid);
    idx[k] = j;
  }
  __syncthreads();  // the table is dead; its storage takes the sort
  typename S::Sort(tmp.u.sort).Sort(id, idx, 0, S::kIdBits);
  __syncthreads();
  typename S::Heads(tmp.u.heads).FlagHeadsAndTails(head, tail, id,
                                                   Differ());
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += kThreads)
    load(i, tmp.u.in.n[i], tmp.u.in.avail[i]);
  __syncthreads();
}

// Step 3 over the thread's sorted items ``s`` (operands, heads and tails
// in place, every mask bit set): on return s.allowed is the final mask and
// cons[k] item k's consumption under it, so that seen = avail - cons.
template <class S, class Q>
__device__ __forceinline__ void fixpoint(typename S::Storage& tmp,
                                         Sorted<Q, S::kItems>& s, int iters,
                                         Q (&cons)[S::kItems]) {
  constexpr int kItems = S::kItems;
  // Rounds 0 .. iters-1: the fixpoint; round iters: the safety
  // intersection (a subset of the last mask, checked against that mask's
  // own consumption); round iters+1: the consumption under the final mask.
  // A fixpoint round that leaves the mask as it was (anywhere in the
  // block) has found a fixed point M with cons = cons(M): every later
  // round would give M again, the intersection M & M, and the final
  // consumption cons, so seen follows at once, with the same bits.
  bool fixed = false;
  for (int round = 0; round < iters && !fixed; ++round) {
    exclusive<S>(tmp, s, cons);
    bool changed = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool fits = add(cons[k], s.n[k]) <= s.avail[k];
      changed = changed || fits != s.allowed[k];
      s.allowed[k] = fits;
    }
    fixed = !__syncthreads_or(changed);
  }
  if (!fixed) {
    exclusive<S>(tmp, s, cons);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      s.allowed[k] = s.allowed[k] && add(cons[k], s.n[k]) <= s.avail[k];
    exclusive<S>(tmp, s, cons);
  }
}

template <class S, class Q, class Key, class Load>
__device__ __forceinline__ void admit_by(typename S::Storage& tmp, Key key,
                                         Load load, int B, int iters,
                                         Sorted<Q, S::kItems>& s) {
  constexpr int kItems = S::kItems;
  group<S>(tmp, key, load, B, s.idx, s.head, s.tail);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    const bool valid = i < B;
    s.n[k] = valid ? tmp.u.in.n[i] : Q(0);
    s.avail[k] = valid ? tmp.u.in.avail[i] : Q(0);
    s.allowed[k] = true;
  }
  Q cons[kItems];
  fixpoint<S>(tmp, s, iters, cons);
  // The results in batch order: the union's last use (the operands) is
  // over for every thread since the last scan's barrier.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = s.idx[k];
    if (i < B) {
      tmp.u.out.seen[i] = sub(s.avail[k], cons[k]);
      tmp.u.out.allowed[i] = s.allowed[k];
    }
  }
  __syncthreads();
}

// The segment-exclusive sum of n over the allowed items of ``p``, in Q,
// handed to ``each(k, cons)`` item by item as the scan leaves them; nq(k)
// is item k's n, read again after the scan rather than held across it.
template <class S, class Q, class N, class Each>
__device__ __forceinline__ void exclusive_each(typename S::Storage& tmp,
                                               const Packed<S::kItems>& p,
                                               N nq, Each each) {
  Seg seg[S::kItems];
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) {
    seg[k].v = p.is_allowed(k) ? units(nq(k)) : 0ull;
    seg[k].head = p.is_head(k);
  }
  __syncthreads();  // the storage's last use is over
  typename S::Scan(tmp.scan).InclusiveScan(seg, seg, SegSum());
#pragma unroll
  for (int k = 0; k < S::kItems; ++k) {
    Q cons;
    from_units(seg[k].v - (p.is_allowed(k) ? units(nq(k)) : 0ull), cons);
    each(k, cons);
  }
}

// cons[k] = exclusive_each's sum of item k.
template <class S, class Q, class N>
__device__ __forceinline__ void exclusive_packed(
    typename S::Storage& tmp, const Packed<S::kItems>& p, N nq,
    Q (&cons)[S::kItems]) {
  exclusive_each<S, Q>(tmp, p, nq, [&](int k, Q c) { cons[k] = c; });
}

// admit_by's function with the items in ``Packed`` form: the same
// grouping, rounds and results (tmp.u.out in batch order, behind a
// barrier), but n and avail wait in shared memory instead of registers:
// gathered once into sorted order, striped (item k of thread t at
// k * kThreads + t, so that a warp's reads take one wavefront), and read
// there by every round; the results wait in registers until every thread
// has read its operands (tmp.u.out takes tmp.u.in's place).
template <class S, class Q, class Key, class Load>
__device__ __forceinline__ void admit_packed_by(typename S::Storage& tmp,
                                                Key key, Load load, int B,
                                                int iters,
                                                Packed<S::kItems>& p) {
  constexpr int kThreads = S::kThreads, kItems = S::kItems;
  {
    int head[kItems], tail[kItems];
    group<S>(tmp, key, load, B, p.idx, head, tail);
    p.head = p.tail = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      p.head |= static_cast<unsigned>(head[k] != 0) << k;
      p.tail |= static_cast<unsigned>(tail[k] != 0) << k;
    }
  }
  {
    Q n[kItems], av[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = p.idx[k];
      n[k] = i < B ? tmp.u.in.n[i] : Q(0);
      av[k] = i < B ? tmp.u.in.avail[i] : Q(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      tmp.u.in.n[k * kThreads + threadIdx.x] = n[k];
      tmp.u.in.avail[k * kThreads + threadIdx.x] = av[k];
    }
    __syncthreads();
  }
  auto nq = [&](int k) -> Q { return tmp.u.in.n[k * kThreads + threadIdx.x]; };
  auto aq = [&](int k) -> Q {
    return tmp.u.in.avail[k * kThreads + threadIdx.x];
  };
  p.allowed = (1u << kItems) - 1;
  Q cons[kItems];
  bool fixed = false;
  for (int round = 0; round < iters && !fixed; ++round) {
    exclusive_packed<S>(tmp, p, nq, cons);
    unsigned f = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      f |= static_cast<unsigned>(add(cons[k], nq(k)) <= aq(k)) << k;
    const bool changed = f != p.allowed;
    p.allowed = f;
    fixed = !__syncthreads_or(changed);
  }
  if (!fixed) {
    exclusive_packed<S>(tmp, p, nq, cons);
    unsigned f = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      f |= static_cast<unsigned>(add(cons[k], nq(k)) <= aq(k)) << k;
    p.allowed &= f;
    exclusive_packed<S>(tmp, p, nq, cons);
  }
  // seen = avail - cons, read before tmp.u.out overwrites tmp.u.in.
#pragma unroll
  for (int k = 0; k < kItems; ++k) cons[k] = sub(aq(k), cons[k]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = p.idx[k];
    if (i < B) {
      tmp.u.out.seen[i] = cons[k];
      tmp.u.out.allowed[i] = p.is_allowed(k);
    }
  }
  __syncthreads();
}

// admit_packed_by over operands the launch only reads (admit's).
template <class S, class Q = typename S::Quantity>
__device__ __forceinline__ void admit_packed(
    typename S::Storage& tmp, const int64_t* __restrict__ h1,
    const Q* __restrict__ n, const Q* __restrict__ avail, int B, int iters,
    Packed<S::kItems>& p) {
  admit_packed_by<S, Q>(
      tmp,
      [h1](int j) { return static_cast<unsigned long long>(__ldg(h1 + j)); },
      [n, avail](int i, Q& nn, Q& av) {
        nn = __ldg(n + i);
        av = __ldg(avail + i);
      },
      B, iters, p);
}

// admit_by over operands the launch only reads: h1 is int64[B] (the
// group key); n and avail are the quantity's [B] arrays in batch order,
// read through the read-only cache.
template <class S, class Q = typename S::Quantity>
__device__ __forceinline__ void admit(typename S::Storage& tmp,
                                      const int64_t* __restrict__ h1,
                                      const Q* __restrict__ n,
                                      const Q* __restrict__ avail, int B,
                                      int iters, Sorted<Q, S::kItems>& s) {
  admit_by<S, Q>(
      tmp,
      [h1](int j) { return static_cast<unsigned long long>(__ldg(h1 + j)); },
      [n, avail](int i, Q& nn, Q& av) {
        nn = __ldg(n + i);
        av = __ldg(avail + i);
      },
      B, iters, s);
}

// The routine's storage rounded up to 16 bytes: where the extra shared
// memory of a launch starts.
template <class S>
__host__ __device__ constexpr size_t storage_bytes() {
  return (sizeof(typename S::Storage) + 15) & ~static_cast<size_t>(15);
}

// Launches ONE block of ``kernel`` (a __global__ function taking ``a`` by
// value, over the block shape S) with the routine's storage, then
// ``extra`` bytes more (the cascade's, cascade.cuh, from a 16-byte
// boundary), as dynamic shared memory (above 48 KB only after the
// opt-in). Returns the launch's cudaError_t.
template <class S, class Args>
int launch_block(void (*kernel)(Args), const Args& a, cudaStream_t stream,
                 size_t extra = 0) {
  const size_t smem =
      extra ? storage_bytes<S>() + extra : sizeof(typename S::Storage);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<1, S::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch at the smallest shape holding ``a.B`` keys (fields B,
// iters): ``Kernel::fn<S>()`` returns the __global__ function for shape S
// (its quantity type ``Kernel::Q``); ``extra(S())`` shared-memory bytes
// follow the routine's storage.
template <class Kernel, class Args, class Extra>
int launch_with(const Args& a, cudaStream_t stream, Extra extra) {
  using Q = typename Kernel::Q;
  if (a.B < 0 || a.B > kMaxCapacity || a.iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 256) {
    using S = Shape<64, 4, Q>;
    return launch_block<S>(Kernel::template fn<S>(), a, stream, extra(S()));
  }
  if (a.B <= 1024) {
    using S = Shape<256, 4, Q>;
    return launch_block<S>(Kernel::template fn<S>(), a, stream, extra(S()));
  }
  if (a.B <= 4096) {
    using S = Shape<512, 8, Q>;
    return launch_block<S>(Kernel::template fn<S>(), a, stream, extra(S()));
  }
  using S = Shape<1024, 8, Q>;
  return launch_block<S>(Kernel::template fn<S>(), a, stream, extra(S()));
}

// launch_with, ``extra`` bytes at every shape.
template <class Kernel, class Args>
int launch(const Args& a, cudaStream_t stream, size_t extra = 0) {
  return launch_with<Kernel>(a, stream, [extra](auto) { return extra; });
}

}  // namespace rl_admit
