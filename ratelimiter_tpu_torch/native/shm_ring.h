// Shared-memory SPSC wire rings (ADR-025): the zero-syscall same-host
// transport. One mapping per connection holds a request ring (client ->
// server) and a reply ring (server -> client); records carry UNMODIFIED
// wire frames (serving/protocol.py framing, byte-for-byte), so every
// frame parser on either side works unchanged.
//
// The port's copy of ratelimiter_tpu/native/shm_ring.h, the same byte
// layout, so the JAX package's and the port's clients and doors speak to
// each other over one lane. It is included by native/server.cpp (the
// C++ front door's drain/emit side) and native/loadgen.cpp (the GIL-free
// load generator); the Python mirror is
// ratelimiter_tpu_torch/serving/shm.py, whose layout constants MUST match
// these (tests/test_torch_shm.py pins clients of either package against
// either door, so drift fails loudly).
//
// Layout (little-endian, all offsets in bytes):
//
//   FileHeader @ 0 (256 B):
//     u64 magic "RLTPSHM1" | u32 version | u32 header_bytes
//     u32 req_capacity | u32 rep_capacity
//     u64 req_ctrl_off | u64 rep_ctrl_off | u64 req_data_off
//     u64 rep_data_off | zero pad
//   RingCtrl per ring (128 B = two cache lines):
//     consumer line: u64 head | u32 consumer_sleeping | pad to 64
//     producer line: u64 tail | u32 producer_waiting  | pad to 128
//   data regions follow (capacities are powers of two).
//
// head/tail are MONOTONIC byte positions (never wrapped); occupancy is
// tail - head and the slot index is pos & (capacity - 1).
//
// Record: 8-byte header [u32 size | u32 commit] + payload + pad to 8.
//   commit == size ^ COMMIT_XOR   committed data record
//   commit == COMMIT_WRAP         wrap pad: skip 8 + size bytes (the
//                                 producer emits one when a record
//                                 would straddle the ring end, so
//                                 payloads are always CONTIGUOUS —
//                                 frombuffer/pointer views need no
//                                 reassembly)
//   anything else                 torn/corrupt (a crashed or byzantine
//                                 producer): the consumer must stop
//                                 trusting the ring and reclaim via the
//                                 control socket, never spin on it.
//
// Publication order (torn-write safety): payload, then the commit word
// (release), then tail (release). A producer killed mid-record leaves
// tail unmoved — the consumer simply never observes the torn bytes.
// The commit word is second-line defence: it self-checks against the
// size field, so a record that IS visible but inconsistent (only
// possible through corruption, not through any crash point) reads as
// poison instead of a garbage frame length.
//
// Doorbell: bounded spin, then eventfd. The consumer advertises
// `consumer_sleeping` before blocking on its eventfd and re-checks the
// ring after the store (store-then-load, SeqCst) so a concurrent
// publish cannot be missed; the producer dings the eventfd only when
// the flag is set — the steady-state hot path makes ZERO syscalls.
// `producer_waiting` is the mirror-image flag for ring-full
// backpressure: the consumer dings the opposite eventfd after freeing
// space.

#pragma once

#include <stdint.h>
#include <string.h>

#include <atomic>

namespace rlshm {

constexpr uint64_t MAGIC = 0x314D485350544C52ULL;  // "RLTPSHM1" LE
constexpr uint32_t VERSION = 1;
constexpr uint32_t FILE_HEADER_BYTES = 256;
constexpr uint32_t CTRL_BYTES = 128;
constexpr uint32_t COMMIT_XOR = 0x52494E47;  // "RING"
constexpr uint32_t COMMIT_WRAP = 0xFFFFFFFFu;
constexpr uint32_t MIN_RING = 1u << 16;
constexpr uint32_t MAX_RING = 1u << 26;

struct FileHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t header_bytes;
  uint32_t req_capacity;
  uint32_t rep_capacity;
  uint64_t req_ctrl_off;
  uint64_t rep_ctrl_off;
  uint64_t req_data_off;
  uint64_t rep_data_off;
};

struct RingCtrl {
  // Consumer-owned cache line.
  std::atomic<uint64_t> head;
  std::atomic<uint32_t> consumer_sleeping;
  char _pad0[64 - 12];
  // Producer-owned cache line.
  std::atomic<uint64_t> tail;
  std::atomic<uint32_t> producer_waiting;
  char _pad1[64 - 12];
};
static_assert(sizeof(RingCtrl) == CTRL_BYTES, "ring ctrl layout");

inline uint32_t align8(uint32_t n) { return (n + 7u) & ~7u; }

inline uint64_t total_bytes(uint32_t req_cap, uint32_t rep_cap) {
  return (uint64_t)FILE_HEADER_BYTES + 2 * CTRL_BYTES + req_cap + rep_cap;
}

// Initialize a freshly-truncated (zeroed) mapping. Returns the header.
inline FileHeader* init_file(uint8_t* base, uint32_t req_cap,
                             uint32_t rep_cap) {
  FileHeader* h = reinterpret_cast<FileHeader*>(base);
  h->magic = MAGIC;
  h->version = VERSION;
  h->header_bytes = FILE_HEADER_BYTES;
  h->req_capacity = req_cap;
  h->rep_capacity = rep_cap;
  h->req_ctrl_off = FILE_HEADER_BYTES;
  h->rep_ctrl_off = FILE_HEADER_BYTES + CTRL_BYTES;
  h->req_data_off = FILE_HEADER_BYTES + 2 * CTRL_BYTES;
  h->rep_data_off = h->req_data_off + req_cap;
  return h;
}

// One directional ring view (producer or consumer role is by usage).
struct Ring {
  RingCtrl* ctrl = nullptr;
  uint8_t* data = nullptr;
  uint32_t capacity = 0;

  uint64_t used() const {
    return ctrl->tail.load(std::memory_order_acquire) -
           ctrl->head.load(std::memory_order_acquire);
  }

  // ---- producer side ----

  // Try to append one frame as a committed record; false = no space
  // (caller decides: overflow queue server-side, typed backpressure
  // error client-side). Never blocks, never syscalls (the doorbell is
  // the caller's job via `want_doorbell` so batched publishes can
  // coalesce the ding).
  bool try_push(const uint8_t* frame, uint32_t len) {
    uint32_t need = 8 + align8(len);
    uint64_t tail = ctrl->tail.load(std::memory_order_relaxed);
    uint64_t head = ctrl->head.load(std::memory_order_acquire);
    uint64_t free_b = capacity - (tail - head);
    uint32_t off = (uint32_t)(tail & (capacity - 1));
    uint32_t to_end = capacity - off;
    uint64_t total = need + (need > to_end ? to_end : 0);
    if (total > free_b) return false;
    if (need > to_end) {
      // Wrap pad: record payloads stay contiguous.
      memcpy(data + off, &to_end, 0);  // no-op, keeps layout explicit
      uint32_t pad_size = to_end - 8;
      memcpy(data + off, &pad_size, 4);
      reinterpret_cast<std::atomic<uint32_t>*>(data + off + 4)
          ->store(COMMIT_WRAP, std::memory_order_release);
      tail += to_end;
      off = 0;
    }
    memcpy(data + off + 8, frame, len);
    memcpy(data + off, &len, 4);
    reinterpret_cast<std::atomic<uint32_t>*>(data + off + 4)
        ->store(len ^ COMMIT_XOR, std::memory_order_release);
    ctrl->tail.store(tail + need, std::memory_order_release);
    return true;
  }

  bool consumer_sleeping() const {
    return ctrl->consumer_sleeping.load(std::memory_order_acquire) != 0;
  }

  // ---- consumer side ----

  enum PopResult { POP_EMPTY = 0, POP_RECORD = 1, POP_TORN = 2 };

  // Peek the next committed record. POP_RECORD fills (*payload, *len);
  // the caller must copy/consume the bytes BEFORE calling advance().
  PopResult pop(const uint8_t** payload, uint32_t* len) {
    for (;;) {
      uint64_t head = ctrl->head.load(std::memory_order_relaxed);
      uint64_t tail = ctrl->tail.load(std::memory_order_acquire);
      if (head == tail) return POP_EMPTY;
      uint32_t off = (uint32_t)(head & (capacity - 1));
      uint32_t size;
      memcpy(&size, data + off, 4);
      uint32_t commit =
          reinterpret_cast<std::atomic<uint32_t>*>(data + off + 4)
              ->load(std::memory_order_acquire);
      if (commit == COMMIT_WRAP) {
        if (8ull + size > capacity) return POP_TORN;
        ctrl->head.store(head + 8 + size, std::memory_order_release);
        continue;
      }
      if (commit != (size ^ COMMIT_XOR) || 8ull + align8(size) > capacity)
        return POP_TORN;
      *payload = data + off + 8;
      *len = size;
      return POP_RECORD;
    }
  }

  // Release the record returned by the last pop().
  void advance(uint32_t len) {
    uint64_t head = ctrl->head.load(std::memory_order_relaxed);
    ctrl->head.store(head + 8 + align8(len), std::memory_order_release);
  }

  bool producer_waiting() const {
    return ctrl->producer_waiting.load(std::memory_order_acquire) != 0;
  }
  void clear_producer_waiting() {
    ctrl->producer_waiting.store(0, std::memory_order_release);
  }
  void set_producer_waiting() {
    ctrl->producer_waiting.store(1, std::memory_order_seq_cst);
  }
  void set_sleeping() {
    // SeqCst store-then-load: the re-check of tail after this store is
    // ordered after it, so a producer that published before reading the
    // flag is always seen by the re-check (no lost wakeup).
    ctrl->consumer_sleeping.store(1, std::memory_order_seq_cst);
  }
  void clear_sleeping() {
    ctrl->consumer_sleeping.store(0, std::memory_order_release);
  }
  bool empty() const {
    return ctrl->head.load(std::memory_order_acquire) ==
           ctrl->tail.load(std::memory_order_acquire);
  }
};

// Attach rings to a mapped file. `server` selects which ring is the
// inbound one (server consumes req, produces rep; client the reverse).
struct LaneView {
  Ring inbound;   // this side consumes
  Ring outbound;  // this side produces
};

inline bool attach(uint8_t* base, bool server, LaneView* v) {
  FileHeader* h = reinterpret_cast<FileHeader*>(base);
  if (h->magic != MAGIC || h->version != VERSION) return false;
  Ring req{reinterpret_cast<RingCtrl*>(base + h->req_ctrl_off),
           base + h->req_data_off, h->req_capacity};
  Ring rep{reinterpret_cast<RingCtrl*>(base + h->rep_ctrl_off),
           base + h->rep_data_off, h->rep_capacity};
  v->inbound = server ? req : rep;
  v->outbound = server ? rep : req;
  return true;
}

}  // namespace rlshm
