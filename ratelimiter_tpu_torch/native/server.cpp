// Native front door for the rate-limit service: the port's copy of
// ratelimiter_tpu/native/server.cpp.
//
// It moves the serving hot path into C++ threads; Python is entered once
// per batched dispatch (the launch callback), the cadence at which the
// card is entered. Protocol and semantics are those of
// ratelimiter_tpu_torch/serving/protocol.py (the port's), so the port's clients and
// its asyncio door (serving/server.py) speak to it unchanged, and the
// reply bytes equal the JAX package's native door on the same frames.
//
// Threading model:
//   io threads           N sharded rings (epoll, or io_uring where the
//                        kernel allows) over the listener, connections,
//                        shared-memory lanes and eventfds; frame
//                        assembly; C++-side validation (empty key, n==0,
//                        UTF-8, oversized frames) answers ERROR inline;
//                        ALLOW work is hash-routed to a dispatch shard;
//                        HEALTH answered inline from atomics; writes
//                        flushed from per-conn output queues.
//   dispatcher thread(s) one per shard: waits up to max_delay_us for
//                        work, drains up to max_batch keys, builds the
//                        contiguous (blob, offsets, lengths, ns) buffers
//                        WITH the key prefix prepended (so Python hashes
//                        ready-made bytes), or the finalized ids of the
//                        hashed lane. Pipelined mode (launch + resolve
//                        callbacks): calls the non-blocking LAUNCH
//                        callback and pushes the returned ticket onto a
//                        bounded in-flight queue (blocking when full =
//                        backpressure). The SLO mode calls the blocking
//                        decide callback.
//   completer thread(s)  one per shard (pipelined mode): drains every
//                        in-flight ticket per wake, calls the Python
//                        RESOLVE callback on each oldest-first (it waits
//                        for the card with the GIL released) and hands
//                        results to the responder.
//   responder thread     encodes RESULT / RESULT_BATCH / RESULT_HASHED
//                        frames and queues them on connections. Split
//                        batches (keys spanning shards) reassemble via
//                        BatchJoin; the last shard sends the frame.
//
// Dispatch shards (num_shards > 1) decide on separate Python-side
// limiters; keys are routed by FNV-1a (strings) or the finalized hash
// (the hashed lane), so per-key semantics are exact.
//
// Where this copy differs from the JAX package's door:
//   * every thread's exit and the shutdown take the waiting thread's
//     mutex between the state change and the notify (the JAX door's
//     dispatcher decrements live_dispatchers and notifies the responder
//     without holding rmx, so the responder can miss its last wake-up
//     and shutdown joins it forever);
//   * a string Pending carved at max_batch keeps its forward hint on
//     both halves;
//   * a fleet member serves T_FLEET_MAP (the JAX door answers it as an
//     unknown type, as this one does outside a fleet);
//   * no quarantine state (set_shard_health) and no lease lane;
//   * its own ABI number (rl_server_abi_version).
//
// The Python side (serving/native_server.py) supplies the callbacks:
//   launch(shard, blob, offsets, lengths, ns, trace) -> ticket
//   launch_hashed(shard, ids, ns, trace) -> ticket
//   resolve(shard, ticket) -> (flags, remaining, retry, reset_at, limit)
//   decide / decide_hashed: the blocking forms (SLO mode)
//   reset(shard, key_bytes) -> None
//   metrics() -> bytes
//   spans(shard, count, trace, t_io, t_d0, t_d1, t_v0, t_v1)
//   dcn(body) -> None: a T_DCN_PUSH body, on shard 0's dispatcher (None:
//     pushes are refused and keep the 1 MiB frame bound)
//   fleet_map() -> bytes: the fleet map's JSON for T_FLEET_MAP, on shard
//     0's dispatcher (None: the frame is an unknown type)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 on first use
// (ratelimiter_tpu_torch/native/__init__.py, build_server).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <limits.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

#include "shm_ring.h"

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---- protocol constants (serving/protocol.py (the port's)) ----
constexpr uint8_t T_ALLOW_N = 1, T_RESET = 2, T_HEALTH = 3, T_METRICS = 4,
                  T_ALLOW_BATCH = 5, T_DCN_PUSH = 6, T_ALLOW_HASHED = 11,
                  T_FLEET_MAP = 12;
constexpr uint8_t T_RESULT = 129, T_OK = 130, T_HEALTH_R = 131,
                  T_METRICS_R = 132, T_RESULT_BATCH = 133,
                  T_RESULT_HASHED = 136, T_FLEET_MAP_R = 137,
                  T_ERROR = 255;
// Shm lane upgrade (ADR-025): 16 aliases FORWARD_FLAG | 0 on the type
// byte, so the hello is matched EXACTLY on the raw byte before any flag
// stripping (base type 0 is invalid, making the exact match unambiguous;
// the hello never composes with the trace/deadline/forward extensions).
constexpr uint8_t T_SHM_HELLO = 16, T_SHM_HELLO_R = 141;

// splitmix64 finalizer — BIT-IDENTICAL to ops/hashing.splitmix64 (and
// its device twin): the hashed wire lane's raw u64 ids are finalized
// HERE, on the io threads, so the Python launch callback receives
// ready-made hashes and stages them with one memcpy (ADR-011).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}
constexpr uint16_t E_INVALID_N = 1, E_INVALID_KEY = 2,
                   E_STORAGE_UNAVAILABLE = 3, E_INVALID_CONFIG = 5,
                   E_INTERNAL = 7, E_DEADLINE = 8;
constexpr uint32_t MAX_FRAME = 1u << 20;
// DCN pushes carry whole slabs or debt deltas; the larger cap holds only
// on a server created with a dcn callback, so a plain deployment keeps
// the 1 MiB bound on every frame (protocol.py MAX_DCN_FRAME).
constexpr uint32_t MAX_DCN_FRAME = 96u << 20;
constexpr uint32_t MAX_KEY_LEN = 4096;
// Trace-context extension (ADR-014, serving/protocol.py (the port's) TRACE_FLAG):
// request frames with bit 6 set on the type byte prefix their body with
// a u64 trace id. Stripped here at parse; the id rides each Pending to
// the spans callback so the Python flight recorder can attribute every
// pipeline stage of the dispatch that served the frame.
constexpr uint8_t TRACE_FLAG = 0x40;
// Deadline extension (ADR-015, serving/protocol.py (the port's) DEADLINE_FLAG):
// request frames with bit 5 set prefix their body with an f64 RELATIVE
// deadline budget in seconds (after the trace id when both flags are
// set). Anchored to frame arrival on the local monotonic clock; the
// dispatcher SHEDS work whose deadline expired before its dispatch ran,
// answering per the fail-open policy instead of burning a dispatch
// slot.
constexpr uint8_t DEADLINE_FLAG = 0x20;
// Forward-lane hint (serving/protocol.py FORWARD_FLAG): request frames
// with bit 4 set are fleet forward windows — every row is owned by THIS
// host, and the frame must never share a dispatch with client frames
// whose resolve waits on our own forward legs (coupling the two builds
// an unbounded cross-host dependency chain). Pure hint, no body prefix;
// the dispatcher cuts its drain at forward/non-forward boundaries.
constexpr uint8_t FORWARD_FLAG = 0x10;

// Span clock: CLOCK_MONOTONIC ns — the SAME domain as Python's
// time.monotonic_ns(), so C++ io/dispatch stamps and Python device-side
// spans interleave on one timeline in the dump.
inline uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Keys are UTF-8 strings at the protocol level (the asyncio server
// decodes them and rejects invalid byte sequences); validate here so
// both front doors accept exactly the same key space instead of the
// native path silently hashing raw bytes reset() could never name.
bool utf8_valid(const char* s, size_t n) {
  const unsigned char* p = (const unsigned char*)s;
  const unsigned char* end = p + n;
  while (p < end) {
    if (*p < 0x80) { ++p; continue; }
    int len;
    uint32_t cp;
    if ((*p & 0xE0) == 0xC0) { len = 2; cp = *p & 0x1Fu; }
    else if ((*p & 0xF0) == 0xE0) { len = 3; cp = *p & 0x0Fu; }
    else if ((*p & 0xF8) == 0xF0) { len = 4; cp = *p & 0x07u; }
    else return false;
    if (end - p < len) return false;
    for (int i = 1; i < len; ++i) {
      if ((p[i] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (p[i] & 0x3Fu);
    }
    if (len == 2 && cp < 0x80) return false;                  // overlong
    if (len == 3 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)))
      return false;                                           // overlong/surrogate
    if (len == 4 && (cp < 0x10000 || cp > 0x10FFFF)) return false;
    p += len;
  }
  return true;
}

void put_u32(std::string& b, uint32_t v) { b.append((char*)&v, 4); }
void put_u16(std::string& b, uint16_t v) { b.append((char*)&v, 2); }
void put_u64(std::string& b, uint64_t v) { b.append((char*)&v, 8); }
void put_i64(std::string& b, int64_t v) { b.append((char*)&v, 8); }
void put_f64(std::string& b, double v) { b.append((char*)&v, 8); }

void frame_header(std::string& b, uint8_t type, uint64_t req_id,
                  uint32_t body_len) {
  put_u32(b, 1 + 8 + body_len);
  b.push_back((char)type);
  put_u64(b, req_id);
}

std::string make_error(uint64_t req_id, uint16_t code, const std::string& msg) {
  std::string out;
  frame_header(out, T_ERROR, req_id, 4 + (uint32_t)msg.size());
  put_u16(out, code);
  put_u16(out, (uint16_t)msg.size());
  out += msg;
  return out;
}

// Shm lane state for one upgraded connection (ADR-025; io thread only
// except the ring ctrl words, which the client process shares). The
// socket stays open as the liveness channel: its EOF/HUP reclaims the
// mapping deterministically, so a kill -9'd client can never wedge the
// server. Spin budget before re-arming the doorbell: cheap C++
// iterations, so a deeper spin than the Python mirror's.
constexpr int SHM_SPIN_ITERS = 4096;

struct ShmLane {
  uint8_t* base = nullptr;
  size_t map_len = 0;
  rlshm::LaneView lane;
  int efd_server = -1;   // server reads (request doorbell)
  int efd_client = -1;   // client reads (reply doorbell)
  int ctrl_listen_fd = -1;
  std::string shm_path, ctrl_path;
  bool handshaken = false;   // eventfds delivered; replies ride the ring
  bool unlinked = false;
  ~ShmLane() {
    if (ctrl_listen_fd >= 0) close(ctrl_listen_fd);
    if (efd_server >= 0) close(efd_server);
    if (efd_client >= 0) close(efd_client);
    if (base != nullptr) munmap(base, map_len);
    if (!unlinked) {
      unlink(ctrl_path.c_str());
      unlink(shm_path.c_str());
    }
  }
};

// ---- network engine (ADR-026) ----------------------------------
//
// One readiness interface, two backends. Both backends share the SAME
// recv/sendmsg data path (ring_main / flush_writes below), so wire bytes
// are byte-identical per frame no matter which engine armed the fd —
// the engine only answers "which fds are ready".
//
//   epoll  portable default; what CI measures. Gets the full multi-ring
//          + vectored-I/O work.
//   uring  io_uring in poll-readiness mode: oneshot IORING_OP_POLL_ADD
//          SQEs, re-armed in batch and submitted + waited with ONE
//          io_uring_enter per wait round (epoll pays one epoll_wait
//          PLUS one epoll_ctl per interest change; here interest
//          changes ride the same enter). Raw syscalls, no liburing, no
//          kernel uapi headers — the minimal ABI subset is restated
//          below so the backend COMPILES everywhere (CI build gate)
//          and degrades at runtime via the startup probe where the
//          kernel/seccomp refuses io_uring_setup.

struct NetEvent {
  int fd;
  bool rd, wr, err;
};

class NetEngine {
 public:
  virtual ~NetEngine() = default;
  virtual bool add(int fd, bool want_write) = 0;
  virtual bool mod(int fd, bool want_write) = 0;
  virtual void del(int fd) = 0;
  virtual int wait(NetEvent* out, int max, int timeout_ms) = 0;
  virtual const char* name() const = 0;
};

class EpollEngine : public NetEngine {
 public:
  EpollEngine() { epfd_ = epoll_create1(0); }
  ~EpollEngine() override {
    if (epfd_ >= 0) close(epfd_);
  }
  bool ok() const { return epfd_ >= 0; }
  bool add(int fd, bool want_write) override {
    struct epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
    ev.data.fd = fd;
    return epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev) == 0;
  }
  bool mod(int fd, bool want_write) override {
    struct epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
    ev.data.fd = fd;
    return epoll_ctl(epfd_, EPOLL_CTL_MOD, fd, &ev) == 0;
  }
  void del(int fd) override { epoll_ctl(epfd_, EPOLL_CTL_DEL, fd, nullptr); }
  int wait(NetEvent* out, int max, int timeout_ms) override {
    if ((int)evs_.size() < max) evs_.resize((size_t)max);
    int n = epoll_wait(epfd_, evs_.data(), max, timeout_ms);
    if (n < 0) return 0;
    for (int i = 0; i < n; ++i) {
      out[i].fd = evs_[i].data.fd;
      out[i].rd = (evs_[i].events & EPOLLIN) != 0;
      out[i].wr = (evs_[i].events & EPOLLOUT) != 0;
      out[i].err = (evs_[i].events & (EPOLLHUP | EPOLLERR)) != 0;
    }
    return n;
  }
  const char* name() const override { return "epoll"; }

 private:
  int epfd_ = -1;
  std::vector<struct epoll_event> evs_;
};

// Minimal io_uring ABI (uapi linux/io_uring.h subset, layout-stable
// since 5.1). Restated locally so the build never depends on kernel
// headers being present or recent.
struct RlUringSqe {
  uint8_t opcode;
  uint8_t flags;
  uint16_t ioprio;
  int32_t fd;
  uint64_t off;
  uint64_t addr;
  uint32_t len;
  uint32_t op_flags;  // poll_events / timeout_flags / ...
  uint64_t user_data;
  uint64_t pad[3];
};
static_assert(sizeof(RlUringSqe) == 64, "io_uring sqe ABI");
struct RlUringCqe {
  uint64_t user_data;
  int32_t res;
  uint32_t flags;
};
struct RlSqOffsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array, resv1;
  uint64_t user_addr;
};
struct RlCqOffsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes, flags, resv1;
  uint64_t user_addr;
};
struct RlUringParams {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle;
  uint32_t features, wq_fd, resv[3];
  RlSqOffsets sq_off;
  RlCqOffsets cq_off;
};
constexpr uint8_t RL_IORING_OP_NOP = 0, RL_IORING_OP_POLL_ADD = 6,
                  RL_IORING_OP_POLL_REMOVE = 7, RL_IORING_OP_TIMEOUT = 11;
constexpr uint32_t RL_IORING_ENTER_GETEVENTS = 1u;
constexpr uint64_t RL_IORING_OFF_SQ_RING = 0, RL_IORING_OFF_CQ_RING = 0x8000000,
                   RL_IORING_OFF_SQES = 0x10000000;
constexpr uint32_t RL_IORING_FEAT_SINGLE_MMAP = 1u;
constexpr uint64_t RL_UD_TIMEOUT = ~0ull, RL_UD_IGNORE = ~1ull;
#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_enter
#define __NR_io_uring_enter 426
#endif
struct RlKernelTimespec {
  int64_t tv_sec;
  long long tv_nsec;
};

inline int rl_io_uring_setup(unsigned entries, RlUringParams* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
inline int rl_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                             unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      nullptr, 0);
}

class UringEngine : public NetEngine {
 public:
  explicit UringEngine(unsigned entries) {
    RlUringParams p{};
    ring_fd_ = rl_io_uring_setup(entries, &p);
    if (ring_fd_ < 0) {
      err_ = std::string("io_uring_setup: ") + strerror(errno);
      return;
    }
    sq_map_len_ = p.sq_off.array + p.sq_entries * sizeof(uint32_t);
    cq_map_len_ = p.cq_off.cqes + p.cq_entries * sizeof(RlUringCqe);
    bool single = (p.features & RL_IORING_FEAT_SINGLE_MMAP) != 0;
    if (single && cq_map_len_ > sq_map_len_) sq_map_len_ = cq_map_len_;
    sq_ptr_ = (uint8_t*)mmap(nullptr, sq_map_len_, PROT_READ | PROT_WRITE,
                             MAP_SHARED | MAP_POPULATE, ring_fd_,
                             RL_IORING_OFF_SQ_RING);
    if (sq_ptr_ == MAP_FAILED) {
      sq_ptr_ = nullptr;
      err_ = std::string("io_uring sq mmap: ") + strerror(errno);
      return;
    }
    if (single) {
      cq_ptr_ = sq_ptr_;
    } else {
      cq_ptr_ = (uint8_t*)mmap(nullptr, cq_map_len_, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_POPULATE, ring_fd_,
                               RL_IORING_OFF_CQ_RING);
      if (cq_ptr_ == MAP_FAILED) {
        cq_ptr_ = nullptr;
        err_ = std::string("io_uring cq mmap: ") + strerror(errno);
        return;
      }
    }
    sqes_len_ = p.sq_entries * sizeof(RlUringSqe);
    sqes_ = (RlUringSqe*)mmap(nullptr, sqes_len_, PROT_READ | PROT_WRITE,
                              MAP_SHARED | MAP_POPULATE, ring_fd_,
                              RL_IORING_OFF_SQES);
    if (sqes_ == MAP_FAILED) {
      sqes_ = nullptr;
      err_ = std::string("io_uring sqes mmap: ") + strerror(errno);
      return;
    }
    sq_head_ = (std::atomic<uint32_t>*)(sq_ptr_ + p.sq_off.head);
    sq_tail_ = (std::atomic<uint32_t>*)(sq_ptr_ + p.sq_off.tail);
    sq_mask_ = *(uint32_t*)(sq_ptr_ + p.sq_off.ring_mask);
    sq_array_ = (uint32_t*)(sq_ptr_ + p.sq_off.array);
    cq_head_ = (std::atomic<uint32_t>*)(cq_ptr_ + p.cq_off.head);
    cq_tail_ = (std::atomic<uint32_t>*)(cq_ptr_ + p.cq_off.tail);
    cq_mask_ = *(uint32_t*)(cq_ptr_ + p.cq_off.ring_mask);
    cqes_ = (RlUringCqe*)(cq_ptr_ + p.cq_off.cqes);
    ready_ = true;
  }
  ~UringEngine() override {
    if (sqes_ != nullptr) munmap(sqes_, sqes_len_);
    if (cq_ptr_ != nullptr && cq_ptr_ != sq_ptr_) munmap(cq_ptr_, cq_map_len_);
    if (sq_ptr_ != nullptr) munmap(sq_ptr_, sq_map_len_);
    if (ring_fd_ >= 0) close(ring_fd_);
  }
  bool ok() const { return ready_; }
  const std::string& error() const { return err_; }

  bool add(int fd, bool want_write) override {
    FdState& st = fds_[fd];
    st.mask = (uint16_t)(POLLIN | (want_write ? POLLOUT : 0));
    st.gen = ++gen_ctr_;
    st.armed = false;
    return true;
  }
  bool mod(int fd, bool want_write) override {
    auto it = fds_.find(fd);
    if (it == fds_.end()) return false;
    uint16_t mask = (uint16_t)(POLLIN | (want_write ? POLLOUT : 0));
    if (mask == it->second.mask) return true;
    // Retire the armed oneshot for the OLD interest set: bump the
    // generation (its eventual CQE is ignored) and reap it promptly so
    // a stale POLLIN-only arm can't delay the new POLLOUT interest.
    if (it->second.armed)
      push_sqe_remove(((uint64_t)it->second.gen << 32) | (uint32_t)fd);
    it->second.mask = mask;
    it->second.gen = ++gen_ctr_;
    it->second.armed = false;
    return true;
  }
  void del(int fd) override {
    auto it = fds_.find(fd);
    if (it == fds_.end()) return;
    if (it->second.armed)
      push_sqe_remove(((uint64_t)it->second.gen << 32) | (uint32_t)fd);
    fds_.erase(it);
  }
  int wait(NetEvent* out, int max, int timeout_ms) override {
    // Re-arm every unarmed fd (oneshot POLL_ADD), append the timeout
    // SQE, submit + wait in ONE enter.
    for (auto& kv : fds_) {
      if (kv.second.armed) continue;
      RlUringSqe* sqe = get_sqe();
      if (sqe == nullptr) break;
      memset(sqe, 0, sizeof(*sqe));
      sqe->opcode = RL_IORING_OP_POLL_ADD;
      sqe->fd = kv.first;
      sqe->op_flags = kv.second.mask;  // poll_events (low 16 bits)
      sqe->user_data = ((uint64_t)kv.second.gen << 32) | (uint32_t)kv.first;
      kv.second.armed = true;
    }
    ts_.tv_sec = timeout_ms / 1000;
    ts_.tv_nsec = (long long)(timeout_ms % 1000) * 1000000ll;
    RlUringSqe* tsq = get_sqe();
    if (tsq != nullptr) {
      memset(tsq, 0, sizeof(*tsq));
      tsq->opcode = RL_IORING_OP_TIMEOUT;
      tsq->fd = -1;
      tsq->addr = (uint64_t)(uintptr_t)&ts_;
      tsq->len = 1;
      tsq->user_data = RL_UD_TIMEOUT;
    }
    int r = rl_io_uring_enter(ring_fd_, pending_, 1,
                              RL_IORING_ENTER_GETEVENTS);
    if (r >= 0) pending_ = 0;
    int n = 0;
    uint32_t head = cq_head_->load(std::memory_order_acquire);
    uint32_t tail = cq_tail_->load(std::memory_order_acquire);
    while (head != tail && n < max) {
      const RlUringCqe& cqe = cqes_[head & cq_mask_];
      ++head;
      if (cqe.user_data == RL_UD_TIMEOUT || cqe.user_data == RL_UD_IGNORE)
        continue;
      int fd = (int)(uint32_t)cqe.user_data;
      uint32_t gen = (uint32_t)(cqe.user_data >> 32);
      auto it = fds_.find(fd);
      if (it == fds_.end() || it->second.gen != gen) continue;  // stale
      it->second.armed = false;  // oneshot fired: re-arm next round
      if (cqe.res < 0) {
        if (cqe.res == -ECANCELED) continue;
        out[n++] = NetEvent{fd, false, false, true};
        continue;
      }
      uint32_t rev = (uint32_t)cqe.res;
      out[n].fd = fd;
      out[n].rd = (rev & POLLIN) != 0;
      out[n].wr = (rev & POLLOUT) != 0;
      out[n].err = (rev & (POLLERR | POLLHUP)) != 0;
      ++n;
    }
    cq_head_->store(head, std::memory_order_release);
    return n;
  }
  const char* name() const override { return "uring"; }

 private:
  struct FdState {
    uint16_t mask = POLLIN;
    uint32_t gen = 0;
    bool armed = false;
  };
  RlUringSqe* get_sqe() {
    uint32_t head = sq_head_->load(std::memory_order_acquire);
    uint32_t tail = sq_tail_->load(std::memory_order_relaxed);
    if (tail - head >= sq_mask_ + 1) {
      // SQ full: flush what is queued without waiting, then retry once.
      if (rl_io_uring_enter(ring_fd_, pending_, 0, 0) >= 0) pending_ = 0;
      head = sq_head_->load(std::memory_order_acquire);
      if (tail - head >= sq_mask_ + 1) return nullptr;
    }
    uint32_t idx = tail & sq_mask_;
    sq_array_[idx] = idx;
    sq_tail_->store(tail + 1, std::memory_order_release);
    ++pending_;
    return &sqes_[idx];
  }
  void push_sqe_remove(uint64_t target_ud) {
    RlUringSqe* sqe = get_sqe();
    if (sqe == nullptr) return;
    memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = RL_IORING_OP_POLL_REMOVE;
    sqe->fd = -1;
    sqe->addr = target_ud;
    sqe->user_data = RL_UD_IGNORE;
  }

  int ring_fd_ = -1;
  bool ready_ = false;
  std::string err_;
  uint8_t *sq_ptr_ = nullptr, *cq_ptr_ = nullptr;
  size_t sq_map_len_ = 0, cq_map_len_ = 0, sqes_len_ = 0;
  RlUringSqe* sqes_ = nullptr;
  std::atomic<uint32_t>*sq_head_ = nullptr, *sq_tail_ = nullptr;
  std::atomic<uint32_t>*cq_head_ = nullptr, *cq_tail_ = nullptr;
  uint32_t sq_mask_ = 0, cq_mask_ = 0;
  uint32_t* sq_array_ = nullptr;
  RlUringCqe* cqes_ = nullptr;
  std::map<int, FdState> fds_;
  uint32_t gen_ctr_ = 0;
  unsigned pending_ = 0;
  RlKernelTimespec ts_{};
};

// Startup probe (ADR-026): a full setup + NOP round trip, not just a
// syscall-exists check — seccomp policies that allow io_uring_setup but
// kill io_uring_enter, and kernels with the interface compiled out,
// both fail HERE and the server falls back to epoll with the reason
// recorded in stats()/healthz/logs. Never fatal, even under an explicit
// --net-engine uring: tests assert the probe-miss record instead of
// skipping.
bool uring_probe(std::string& err) {
  RlUringParams p{};
  int fd = rl_io_uring_setup(8, &p);
  if (fd < 0) {
    err = std::string("io_uring_setup: ") + strerror(errno);
    return false;
  }
  size_t sq_len = p.sq_off.array + p.sq_entries * sizeof(uint32_t);
  size_t cq_len = p.cq_off.cqes + p.cq_entries * sizeof(RlUringCqe);
  bool single = (p.features & RL_IORING_FEAT_SINGLE_MMAP) != 0;
  if (single && cq_len > sq_len) sq_len = cq_len;
  uint8_t* sqp = (uint8_t*)mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                                MAP_SHARED | MAP_POPULATE, fd,
                                RL_IORING_OFF_SQ_RING);
  RlUringSqe* sqes = (RlUringSqe*)mmap(
      nullptr, p.sq_entries * sizeof(RlUringSqe), PROT_READ | PROT_WRITE,
      MAP_SHARED | MAP_POPULATE, fd, RL_IORING_OFF_SQES);
  bool ok = false;
  if (sqp != MAP_FAILED && sqes != MAP_FAILED) {
    uint8_t* cqp = single ? sqp
                          : (uint8_t*)mmap(nullptr, cq_len,
                                           PROT_READ | PROT_WRITE,
                                           MAP_SHARED | MAP_POPULATE, fd,
                                           RL_IORING_OFF_CQ_RING);
    if (cqp != MAP_FAILED) {
      uint32_t tail = *(uint32_t*)(sqp + p.sq_off.tail);
      uint32_t idx = tail & *(uint32_t*)(sqp + p.sq_off.ring_mask);
      memset(&sqes[idx], 0, sizeof(RlUringSqe));
      sqes[idx].opcode = RL_IORING_OP_NOP;
      sqes[idx].user_data = 42;
      ((uint32_t*)(sqp + p.sq_off.array))[idx] = idx;
      std::atomic_thread_fence(std::memory_order_release);
      *(uint32_t*)(sqp + p.sq_off.tail) = tail + 1;
      int r = rl_io_uring_enter(fd, 1, 1, RL_IORING_ENTER_GETEVENTS);
      if (r < 0) {
        err = std::string("io_uring_enter: ") + strerror(errno);
      } else {
        uint32_t chead = *(uint32_t*)(cqp + p.cq_off.head);
        uint32_t ctail = *(volatile uint32_t*)(cqp + p.cq_off.tail);
        RlUringCqe* cqes = (RlUringCqe*)(cqp + p.cq_off.cqes);
        uint32_t cmask = *(uint32_t*)(cqp + p.cq_off.ring_mask);
        ok = chead != ctail && cqes[chead & cmask].user_data == 42;
        if (!ok) err = "io_uring NOP did not complete";
      }
      if (!single) munmap(cqp, cq_len);
    } else {
      err = std::string("io_uring cq mmap: ") + strerror(errno);
    }
  } else {
    err = std::string("io_uring mmap: ") + strerror(errno);
  }
  if (sqes != MAP_FAILED) munmap(sqes, p.sq_entries * sizeof(RlUringSqe));
  if (sqp != MAP_FAILED) munmap(sqp, sq_len);
  close(fd);
  return ok;
}

struct IoRing;

struct Conn {
  int fd = -1;
  std::string rbuf;                 // partial frames (ring thread only)
  std::deque<std::string> wq;       // outgoing frames
  size_t woff = 0;                  // offset into wq.front()
  size_t wq_bytes = 0;              // guarded by wmx (shm slow-reader cut)
  std::mutex wmx;
  std::atomic<bool> closed{false};
  bool want_write = false;          // ring thread only
  // Queued on its ring's dirty list (flush pending): lets N replies to
  // one connection cost ONE eventfd wake + one vectored flush.
  std::atomic<bool> dirty{false};
  // Shm lane after a T_SHM_HELLO upgrade (null = plain socket conn).
  std::unique_ptr<ShmLane> shm;
  // This connection holds a DCN-sized receive-buffer grant (ring thread
  // only; counted in Server::dcn_conns).
  bool dcn_big = false;
  // Owning io ring : fixed at accept by round-robin pin; all
  // readiness state for this fd (and its shm lane fds) lives there.
  IoRing* ring = nullptr;
};

using ConnPtr = std::shared_ptr<Conn>;

// One sharded io event loop : its own engine, eventfd
// doorbell, and fd-ownership maps. Connections are pinned at accept and
// never migrate, so `conns`/`shm_fds` stay single-threaded (ring thread
// only) exactly like the old single io thread's maps — the inbox +
// dirty list (mutex-guarded) are the only cross-thread entry points.
struct IoRing {
  uint32_t idx = 0;
  int event_fd = -1;
  std::unique_ptr<NetEngine> engine;
  std::thread thread;
  std::map<int, ConnPtr> conns;    // ring thread only
  std::map<int, ConnPtr> shm_fds;  // ctrl/efd fd -> conn (ring thread)
  std::mutex imx;                  // guards inbox + dirty
  std::vector<int> inbox;          // accepted fds awaiting adoption
  std::vector<ConnPtr> dirty;      // conns with queued replies to flush
  // True only while the ring thread is parked inside engine->wait().
  // Producers (conn_send, accept handover) ding the eventfd ONLY when
  // this is set: a busy ring re-checks inbox+dirty at the top of every
  // loop iteration, so work queued while it is awake needs no syscall
  // at all. Dekker pairing with the pre-wait emptiness re-check (both
  // seq_cst, producer pushes then loads; ring stores then checks)
  // guarantees no lost wakeup.
  std::atomic<bool> sleeping{false};
  // Engine-maintained syscall ledger : the numerator of the
  // syscalls-per-decision metric the conn sweep divides by decisions.
  std::atomic<uint64_t> recv_calls{0};
  std::atomic<uint64_t> writev_calls{0};
  std::atomic<uint64_t> wait_calls{0};
  std::atomic<uint64_t> wake_calls{0};
  std::atomic<uint64_t> writev_frames{0};
};

// Reassembly of one ALLOW_BATCH / ALLOW_HASHED frame split across
// dispatch units: each contributor writes its results at the original
// positions; the LAST one to finish encodes and sends the single
// response frame. `remaining` counts SEGMENTS, not shards (ADR-013):
// besides the io thread's per-shard split of a mixed frame, the
// dispatcher may carve a hashed segment at the max_batch boundary so a
// coalesced run never overshoots the largest prewarmed pad shape — the
// continuation registers itself with a fetch_add BEFORE its first half
// can deposit, so the count can never hit zero early.
struct BatchJoin {
  std::atomic<uint32_t> remaining;
  ConnPtr conn;
  uint64_t req_id;
  uint32_t count;
  std::vector<uint8_t> flags;
  std::vector<int64_t> rem;
  std::vector<double> retry, reset;
  std::atomic<int64_t> limit{0};
  std::atomic<uint16_t> err{0};
  std::mutex emx;  // guards err_msg only
  std::string err_msg;
  bool hashed = false;  // respond with T_RESULT_HASHED (columnar)
  BatchJoin(uint32_t nsh, ConnPtr c, uint64_t rid, uint32_t cnt)
      : remaining(nsh), conn(std::move(c)), req_id(rid), count(cnt),
        flags(cnt), rem(cnt), retry(cnt), reset(cnt) {}
};
using JoinPtr = std::shared_ptr<BatchJoin>;

// One queued decision unit: a scalar ALLOW_N, a whole ALLOW_BATCH frame,
// one shard's slice of a split batch (join != null; pos holds each
// key's index in the original frame), or — hashed lane (ADR-011) — an
// ALLOW_HASHED frame/slice whose keys are finalized u64 hashes in `ids`
// (keys stays empty; responses are columnar T_RESULT_HASHED).
struct Pending {
  ConnPtr conn;
  uint64_t req_id;
  bool is_batch;
  std::vector<std::string> keys;
  std::vector<int64_t> ns;
  JoinPtr join;
  std::vector<uint32_t> pos;
  bool hashed = false;
  std::vector<uint64_t> ids;
  // Flight-recorder stamps (ADR-014): io-thread enqueue time and
  // the frame's wire-propagated trace id (0 = unsampled).
  uint64_t t_io = 0;
  uint64_t trace_id = 0;
  // Wire-propagated absolute deadline, CLOCK_MONOTONIC ns (ADR-015;
  // 0 = none): anchored at frame arrival from the frame's
  // relative budget. Expired items are shed at the dispatch boundary.
  uint64_t deadline_ns = 0;
  // Fleet forward-lane window (FORWARD_FLAG): the dispatcher never
  // mixes forward and non-forward Pendings in one drained run.
  bool fwd = false;
};

inline size_t pending_count(const Pending& p) {
  return p.hashed ? p.ids.size() : p.keys.size();
}

// The dispatch currently being decided, shared between the dispatcher
// and the SLO watcher. Whoever flips `answered` first owns the response.
struct InFlight {
  std::vector<Pending> items;
  std::atomic<bool> answered{false};
  std::chrono::steady_clock::time_point deadline;
  bool active = false;
};

struct Server {
  int listen_fd = -1;
  uint16_t port = 0;
  // Multi-ring network engine (ADR-026): N sharded io event
  // loops; connections pinned round-robin by accept order. io_rings==0
  // at create time means auto (min(4, hardware threads)); resolved at
  // start(). net_engine_req: 0 auto, 1 epoll (probe skipped), 2 uring
  // (probe still decides — a refusing kernel downgrades to epoll with
  // the reason recorded, never a hard failure).
  uint32_t io_rings = 0;
  uint32_t net_engine_req = 0;
  bool uring_active = false;
  std::string uring_probe_err;
  std::vector<std::unique_ptr<IoRing>> rings;
  std::atomic<uint64_t> accept_ctr{0};  // round-robin pin (ring 0 only)
  // UDS listener (--listen unix:/path): host strings beginning "unix:".
  bool uds = false;
  std::string uds_path;
  // Shm wire lane (ADR-025). Off by default: T_SHM_HELLO answers
  // E_INVALID_CONFIG and every other wire byte is identical to a server
  // built before the lane existed.
  bool shm_enabled = false;
  std::string shm_dir = "/dev/shm";
  uint32_t shm_ring_bytes = 0;
  std::atomic<uint32_t> lane_ctr{0};      // lane-file names (any ring)
  // Transport observability (scrape-time, mirrors the asyncio door's
  // transport_stats()): cumulative accepts + live/cumulative lane and
  // ring counters.
  std::atomic<uint64_t> conns_tcp{0}, conns_uds{0}, conns_shm{0};
  std::atomic<uint64_t> shm_lanes_active{0};
  std::atomic<uint64_t> shm_doorbell_wakes{0};
  std::atomic<uint64_t> shm_spin_hits{0};
  std::atomic<uint64_t> shm_records_in{0}, shm_records_out{0};
  std::atomic<uint64_t> shm_ring_full_stalls{0};
  std::atomic<uint64_t> shm_req_highwater{0}, shm_rep_highwater{0};
  uint32_t max_batch = 4096;
  uint32_t max_delay_us = 200;
  // Dispatch SLO (0 = disabled): when one batched decide exceeds this,
  // waiters are answered immediately per fail_open policy while the
  // Python call completes in the background (state still converges) —
  // parity with the asyncio batcher's dispatch_timeout (ADR-003).
  uint32_t slo_us = 0;
  bool fail_open = false;
  // Live limit/window for fail-open RESULT frames: refreshed from every
  // successful decide/resolve result AND pushable from Python
  // (set_limits), so responses stamped without a completed dispatch —
  // SLO breaches, draining — carry the CURRENT limit, not the
  // construction-time one.
  std::atomic<int64_t> limit{0};
  std::atomic<double> window_s{60.0};
  // Bumped by every explicit set_limits push: a dispatch that STARTED
  // before the push must not overwrite the fresher value when it
  // completes (each refresh is gated on the epoch it captured at start).
  // limit_mx serializes the check-then-store against the push itself —
  // a lock-free gate would leave a load/store window where a racing
  // push is still clobbered. Reads stay lock-free (atomics).
  std::atomic<uint64_t> limit_epoch{0};
  std::mutex limit_mx;
  std::atomic<bool> stop{false};

  // Per-dispatch limit refresh, gated on the epoch captured when the
  // dispatch started.
  void refresh_limit(int64_t lim, uint64_t started_epoch) {
    std::lock_guard<std::mutex> g(limit_mx);
    if (limit_epoch.load() == started_epoch) limit.store(lim);
  }
  std::atomic<bool> draining{false};
  std::atomic<uint64_t> decisions{0};
  // Per-shard decision counts (mesh mode: per-DEVICE; bounded by the
  // num_shards <= 64 cap). Routing-balance observability for the
  // slice-parallel serving tier (ADR-012).
  std::atomic<uint64_t> shard_decisions[64]{};
  std::atomic<uint64_t> slo_breaches{0};
  // Decisions shed because their propagated deadline expired before
  // dispatch (ADR-015).
  std::atomic<uint64_t> deadline_shed{0};
  // Cumulative per-stage wall time (ns) across batched dispatches
  // (ADR-014): io (enqueue -> drain), dispatch (drain -> launch
  // or blocking decide returned), device + complete (pipelined resolve
  // split), respond (responder encode+send). stats()["stage_ns"]
  // surfaces them; per-ticket resolution goes through the spans
  // callback instead.
  std::atomic<uint64_t> stage_io_ns{0};
  std::atomic<uint64_t> stage_dispatch_ns{0};
  std::atomic<uint64_t> stage_device_ns{0};
  std::atomic<uint64_t> stage_complete_ns{0};
  std::atomic<uint64_t> stage_respond_ns{0};
  std::atomic<uint64_t> stage_batches{0};
  double started_at = 0.0;

  std::thread slo_thread;
  std::vector<std::thread> dispatch_threads;

  // Dispatch shards (default 1): keys are routed by hash, each shard has
  // its own queue, dispatcher thread, and (Python-side) limiter shard —
  // per-key semantics are exact because a key always lands on the same
  // shard; shards decide concurrently (the in-process analog of the
  // reference's Redis-Cluster keyspace sharding, and the per-chip layout
  // on a multi-chip serving deployment).
  struct ShardQ {
    std::mutex qmx;
    std::condition_variable qcv;
    std::deque<Pending> queue;
    size_t queued_keys = 0;
  };
  uint32_t num_shards = 1;
  std::vector<std::unique_ptr<ShardQ>> shardqs;
  //: Dispatchers still alive — the responder must outlive them (a
  //: dispatcher inside a long Python decide will enqueue its Reply
  //: AFTER stop is set; exiting on stop+empty alone would drop it).
  std::atomic<uint32_t> live_dispatchers{0};

  // Pipelined dispatch (launch/resolve callbacks set, SLO off): one
  // bounded in-flight ticket queue + completer thread per shard. The
  // dispatcher blocks on cv_space when `inflight` tickets are pending —
  // that is the pipeline's backpressure, upstream of the socket reads.
  struct InflightEntry {
    std::vector<Pending> items;
    PyObject* ticket = nullptr;
    size_t total = 0;
    uint64_t limit_epoch = 0;  // epoch observed at launch time
    bool hashed = false;       // respond columnar (T_RESULT_HASHED)
    // Per-ticket stage stamps (ADR-014): earliest io-thread
    // enqueue over the run's items, dispatch window (drain -> launch
    // callback returned), and the run's first sampled trace id.
    uint64_t t_io = 0;
    uint64_t t_d0 = 0;
    uint64_t t_d1 = 0;
    uint64_t trace_id = 0;
  };
  struct PipeQ {
    std::mutex mx;
    std::condition_variable cv_items, cv_space;
    std::deque<InflightEntry> entries;
    // Tickets the completer has swapped out of `entries` but not yet
    // resolved (the batched-drain window). Counts toward the
    // `inflight` bound — a swapped-out ticket is still a
    // launched-but-unresolved device dispatch, so the dispatcher may
    // not reuse its slot until the resolve lands — and graceful
    // shutdown must wait on these too: the queue alone looks empty
    // mid-batch. Guarded by `mx` (NOT atomic — every reader and writer
    // must hold the lock anyway: the increment pairs with the swap,
    // the decrement avoids the cv_space lost-wakeup race, and the
    // readers need entries+resolving as one consistent sum).
    uint64_t resolving = 0;
  };
  uint32_t inflight_window = 8;
  bool pipelined = false;  // resolved at start(): launch+resolve, no SLO
  std::vector<std::unique_ptr<PipeQ>> pipeqs;
  std::vector<std::thread> completer_threads;
  std::atomic<uint32_t> live_completers{0};

  std::mutex ifmx;
  std::condition_variable ifcv;
  InFlight inflight;

  // DCN receive-buffer accounting (the pre-screen): connections holding
  // a slab-sized receive buffer, at most max_dcn_conns of them.
  bool dcn_auth_required = false;
  uint32_t max_dcn_conns = 4;
  std::atomic<uint32_t> dcn_conns{0};

  //: Key namespace prepended in C++ while building the decide blob, so
  //: the Python fast path hashes ready-made "prefix:key" bytes instead
  //: of re-packing the blob per dispatch (measured 7 ms/4096 keys in
  //: numpy — the single largest serving cost before this).
  std::string key_prefix;

  // Responder thread (non-SLO path): encoding + send of one batch's
  // responses overlaps the NEXT batch's Python decide.
  struct Reply {
    std::vector<Pending> items;
    std::vector<uint8_t> flags;
    std::vector<int64_t> remaining;
    std::vector<double> retry, reset_at;
    size_t total = 0;
    int64_t limit = 0;
    uint16_t err_code = 0;
    std::string err_msg;
    bool hashed = false;
  };
  std::mutex rmx;
  std::condition_variable rcv;
  std::deque<Reply> rqueue;
  std::thread resp_thread;

  PyObject* cb_decide = nullptr;
  PyObject* cb_reset = nullptr;
  PyObject* cb_metrics = nullptr;
  // Pipelined-mode callbacks (None = legacy blocking decide):
  //   launch(shard, blob, offsets, lengths, ns) -> opaque ticket
  //   resolve(shard, ticket) -> (flags, remaining, retry, reset_at, limit)
  PyObject* cb_launch = nullptr;
  PyObject* cb_resolve = nullptr;
  // Hashed-lane callbacks (None = T_ALLOW_HASHED answered
  // E_INVALID_CONFIG — non-sketch backends have no raw-id path):
  //   decide_hashed(shard, ids, ns) -> result tuple  [blocking]
  //   launch_hashed(shard, ids, ns) -> opaque ticket [pipelined]
  PyObject* cb_decide_hashed = nullptr;
  PyObject* cb_launch_hashed = nullptr;
  bool hashed_enabled = false;
  // DCN merge callback (None = T_DCN_PUSH refused and the frame cap
  // stays MAX_FRAME), called with the raw push body; the Python side
  // checks the envelope and merges into every shard limiter.
  PyObject* cb_dcn = nullptr;
  bool dcn_enabled = false;
  // Fleet map callback (None = not a fleet member): T_FLEET_MAP's JSON.
  PyObject* cb_fleet_map = nullptr;
  // Spans callback (ADR-014; None = per-ticket spans off):
  //   spans(shard, count, trace_id, t_io, t_d0, t_d1, t_v0, t_v1)
  // called from the completer (GIL already held for the resolve) with
  // the ticket's CLOCK_MONOTONIC ns stamps — the Python side records
  // io/dispatch/device/complete spans into the flight recorder.
  // Pipelined mode only; the blocking decide path feeds the aggregate
  // stage_ns counters instead.
  PyObject* cb_spans = nullptr;
  bool spans_enabled = false;
};

// FNV-1a over the raw key bytes: deterministic shard routing (need not
// match the limiter's own key hashing — only stability per key).
uint32_t key_shard(const Server* s, const std::string& k) {
  if (s->num_shards == 1) return 0;
  uint64_t h = 1469598103934665603ull;
  for (unsigned char ch : k) {
    h ^= ch;
    h *= 1099511628211ull;
  }
  return (uint32_t)(h % s->num_shards);
}

// Extract (code, message) from the pending Python exception: message =
// str(exc), code = exc.rl_code when present (the bridge's typed wire
// code), else `fallback_code`. Clears the error. GIL must be held.
uint16_t fetch_py_error(std::string& msg, const char* fallback_msg,
                        uint16_t fallback_code) {
  uint16_t code = fallback_code;
  PyObject *t, *v, *tb;
  PyErr_Fetch(&t, &v, &tb);
  PyObject* str = v ? PyObject_Str(v) : nullptr;
  const char* u =
      (str && PyUnicode_Check(str)) ? PyUnicode_AsUTF8(str) : nullptr;
  msg = u ? u : fallback_msg;
  if (v != nullptr) {
    PyObject* codeattr = PyObject_GetAttrString(v, "rl_code");
    if (codeattr && PyLong_Check(codeattr))
      code = (uint16_t)PyLong_AsLong(codeattr);
    Py_XDECREF(codeattr);
    if (PyErr_Occurred()) PyErr_Clear();
  }
  Py_XDECREF(str);
  Py_XDECREF(t);
  Py_XDECREF(v);
  Py_XDECREF(tb);
  return code;
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

void conn_send(Server* s, const ConnPtr& c, std::string frame) {
  (void)s;
  if (c->closed.load()) return;
  {
    std::lock_guard<std::mutex> g(c->wmx);
    c->wq_bytes += frame.size();
    c->wq.push_back(std::move(frame));
  }
  IoRing* r = c->ring;
  if (r == nullptr) return;
  // Wake the OWNING ring, once per flush round: further replies queued
  // while the conn is already on the dirty list ride the same wake and
  // the same vectored flush (the old path paid one eventfd write per
  // frame and one send per frame).
  bool was_dirty = c->dirty.exchange(true);
  if (!was_dirty) {
    std::lock_guard<std::mutex> g(r->imx);
    r->dirty.push_back(c);
  }
  // Ding only a PARKED ring (see IoRing::sleeping): an awake ring
  // drains the dirty list on its next loop pass without any syscall.
  // exchange(false) elects ONE producer per park — the burst of
  // replies a decide batch fans out pays a single eventfd write, not
  // one per connection (the ring clears the flag itself on wake, so a
  // false winner can't strand a later park).
  if (!was_dirty && r->sleeping.exchange(false)) {
    r->wake_calls.fetch_add(1, std::memory_order_relaxed);
    uint64_t one = 1;
    ssize_t w = write(r->event_fd, &one, 8);
    (void)w;
  }
}

// Columnar T_RESULT_HASHED frame: bit-packed allow mask + three column
// memcpys (the response shape the device packs, serving/protocol.py (the port's)).
void encode_hashed_frame(std::string& out, uint64_t req_id, int64_t limit,
                         const uint8_t* flags, const int64_t* rem,
                         const double* retry, const double* reset,
                         uint32_t count) {
  uint32_t nb = (count + 7) / 8;
  frame_header(out, T_RESULT_HASHED, req_id, 13 + nb + 24 * count);
  // Batch fail_open = OR over the items: a split (multi-shard) frame
  // whose slices disagree — one shard failed open, another decided —
  // must still report that SOME answers are fabricated.
  uint8_t bflags = 0;
  for (uint32_t i = 0; i < count; ++i) bflags |= (uint8_t)(flags[i] & 2);
  out.push_back((char)bflags);
  put_i64(out, limit);
  put_u32(out, count);
  std::string bits(nb, '\0');
  for (uint32_t i = 0; i < count; ++i)
    if (flags[i] & 1) bits[i >> 3] |= (char)(1u << (i & 7));
  out += bits;
  out.append((const char*)rem, (size_t)count * 8);
  out.append((const char*)retry, (size_t)count * 8);
  out.append((const char*)reset, (size_t)count * 8);
}

// Notify every waiter of `cv` after taking `mx` once: a waiter that
// tested its predicate before the caller's state change is then either
// still before its test (and sees the change) or already blocked (and
// gets the notify) -- never in between, where the notify would be lost.
void notify_locked(std::mutex& mx, std::condition_variable& cv) {
  { std::lock_guard<std::mutex> g(mx); }
  cv.notify_all();
}

// Set `stop` and wake every thread that waits on it, each through its
// own mutex (notify_locked).
void stop_and_wake(Server* s) {
  s->stop.store(true);
  for (auto& q : s->shardqs) notify_locked(q->qmx, q->qcv);
  for (auto& pq : s->pipeqs) {
    notify_locked(pq->mx, pq->cv_items);
    notify_locked(pq->mx, pq->cv_space);
  }
  notify_locked(s->ifmx, s->ifcv);
  notify_locked(s->rmx, s->rcv);
}

// ---- SLO watcher ---------------------------------------------------------

void send_policy_answers(Server* s, const std::vector<Pending>& items) {
  // Fail-open: allowed Result with the fail_open flag; fail-closed:
  // typed storage_unavailable error — ADR-003's SLO-breach policy.
  for (const auto& p : items) {
    if (s->fail_open) {
      // Live limit/window (atomics refreshed by every completed
      // dispatch + Python pushes): a breach after update_limit stamps
      // the CURRENT limit.
      int64_t lim = s->limit.load();
      double reset_at = now_s() + s->window_s.load();
      if (p.hashed) {
        uint32_t count = (uint32_t)p.ids.size();
        std::vector<uint8_t> fl(count, 3);  // allowed | fail_open
        std::vector<int64_t> rem(count, 0);
        std::vector<double> retry(count, 0.0), reset(count, reset_at);
        std::string out;
        encode_hashed_frame(out, p.req_id, lim, fl.data(), rem.data(),
                            retry.data(), reset.data(), count);
        conn_send(s, p.conn, std::move(out));
        s->decisions.fetch_add(count);
        s->shard_decisions[0].fetch_add(count);  // SLO => single shard
        continue;
      }
      if (!p.is_batch) {
        std::string out;
        frame_header(out, T_RESULT, p.req_id, 33);
        out.push_back((char)3);  // allowed | fail_open
        put_i64(out, lim);
        put_i64(out, 0);
        put_f64(out, 0.0);
        put_f64(out, reset_at);
        conn_send(s, p.conn, std::move(out));
      } else {
        uint32_t count = (uint32_t)p.keys.size();
        std::string out;
        frame_header(out, T_RESULT_BATCH, p.req_id, 12 + 25 * count);
        put_i64(out, lim);
        put_u32(out, count);
        for (uint32_t i = 0; i < count; ++i) {
          out.push_back((char)3);
          put_i64(out, 0);
          put_f64(out, 0.0);
          put_f64(out, reset_at);
        }
        conn_send(s, p.conn, std::move(out));
      }
      s->decisions.fetch_add(p.keys.size());
      s->shard_decisions[0].fetch_add(p.keys.size());  // SLO => one shard
    } else {
      conn_send(s, p.conn,
                make_error(p.req_id, E_STORAGE_UNAVAILABLE,
                           "dispatch exceeded SLO"));
    }
  }
}

void slo_main(Server* s) {
  std::unique_lock<std::mutex> lk(s->ifmx);
  while (!s->stop.load()) {
    s->ifcv.wait(lk, [&] { return s->stop.load() || s->inflight.active; });
    if (s->stop.load()) return;
    // Wait until the deadline or until the dispatcher deactivates.
    s->ifcv.wait_until(lk, s->inflight.deadline,
                       [&] { return s->stop.load() || !s->inflight.active; });
    if (s->stop.load()) return;
    if (s->inflight.active &&
        std::chrono::steady_clock::now() >= s->inflight.deadline &&
        !s->inflight.answered.exchange(true)) {
      s->slo_breaches.fetch_add(1);
      send_policy_answers(s, s->inflight.items);
      // Leave `active` set: the dispatcher clears it when the (late)
      // decide lands; its responses are discarded via `answered`.
    }
    // Avoid a hot loop while the late dispatch is still running.
    if (s->inflight.active)
      s->ifcv.wait(lk, [&] { return s->stop.load() || !s->inflight.active; });
  }
}

// ---- dispatcher ----------------------------------------------------------

// Build the contiguous (blob, offsets, lengths, ns) decide buffers for a
// drained run; returns the total key count.
size_t build_buffers(Server* s, const std::vector<Pending>& items,
                     std::string& blob, std::vector<int64_t>& offsets,
                     std::vector<int64_t>& lengths,
                     std::vector<int64_t>& ns) {
  size_t total = 0;
  for (auto& p : items) total += p.keys.size();
  const std::string& prefix = s->key_prefix;
  offsets.reserve(total);
  lengths.reserve(total);
  ns.reserve(total);
  for (auto& p : items) {
    for (size_t i = 0; i < p.keys.size(); ++i) {
      offsets.push_back((int64_t)blob.size());
      lengths.push_back((int64_t)(prefix.size() + p.keys[i].size()));
      blob += prefix;
      blob += p.keys[i];
      ns.push_back(p.ns[i]);
    }
  }
  return total;
}

// Parse the (flags, remaining, retry, reset_at, limit) result tuple into
// `r` (buffer protocol); sets r.err_* on malformed results. GIL held.
void parse_result_tuple(PyObject* res, size_t total, Server::Reply& r,
                        const char* what) {
  PyObject *o_fl, *o_rem, *o_ret, *o_rst;
  long long o_lim = 0;
  if (!PyArg_ParseTuple(res, "OOOOL", &o_fl, &o_rem, &o_ret, &o_rst,
                        &o_lim)) {
    r.err_code = E_INTERNAL;
    r.err_msg = std::string(what) + " returned a malformed tuple";
    PyErr_Clear();
    return;
  }
  r.limit = (int64_t)o_lim;
  r.flags.resize(total);
  r.remaining.resize(total);
  r.retry.resize(total);
  r.reset_at.resize(total);
  Py_buffer bufs[4];
  PyObject* objs[4] = {o_fl, o_rem, o_ret, o_rst};
  int acquired = 0;  // bufs[0..acquired) hold views needing release
  while (acquired < 4 &&
         PyObject_GetBuffer(objs[acquired], &bufs[acquired],
                            PyBUF_SIMPLE) == 0)
    ++acquired;
  bool ok = acquired == 4;
  if (!ok || (size_t)bufs[0].len < total ||
      (size_t)bufs[1].len < total * 8 ||
      (size_t)bufs[2].len < total * 8 ||
      (size_t)bufs[3].len < total * 8) {
    r.err_code = E_INTERNAL;
    r.err_msg = std::string(what) + " returned short buffers";
    PyErr_Clear();
  } else {
    memcpy(r.flags.data(), bufs[0].buf, total);
    memcpy(r.remaining.data(), bufs[1].buf, total * 8);
    memcpy(r.retry.data(), bufs[2].buf, total * 8);
    memcpy(r.reset_at.data(), bufs[3].buf, total * 8);
  }
  for (int i = 0; i < acquired; ++i) PyBuffer_Release(&bufs[i]);
}

// Calls the Python decide callback for a drained run of Pending items,
// filling `r` with per-request results (or an error). Returns false if
// the callback raised.
bool decide_core(Server* s, uint32_t shard, std::vector<Pending>& items,
                 Server::Reply& r, uint64_t trace_id) {
  std::string blob;
  std::vector<int64_t> offsets, lengths, ns;
  size_t total = build_buffers(s, items, blob, offsets, lengths, ns);
  if (total == 0) {
    // Only empty ALLOW_BATCH frames: nothing to decide (and empty
    // buffers would reach Python as None through Py_BuildValue y#).
    r.limit = s->limit.load();
    return true;
  }

  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Iy#y#y#y#K)", (unsigned int)shard,
        blob.data(), (Py_ssize_t)blob.size(),
        (const char*)offsets.data(), (Py_ssize_t)(offsets.size() * 8),
        (const char*)lengths.data(), (Py_ssize_t)(lengths.size() * 8),
        (const char*)ns.data(), (Py_ssize_t)(ns.size() * 8),
        (unsigned long long)trace_id);
    PyObject* res = args ? PyObject_CallObject(s->cb_decide, args) : nullptr;
    Py_XDECREF(args);
    if (res == nullptr) {
      // Python-side mapping: the bridge returns a typed code via the
      // exception's .rl_code when it can; default storage_unavailable.
      r.err_code = fetch_py_error(r.err_msg, "decide callback failed",
                                  E_STORAGE_UNAVAILABLE);
    } else {
      parse_result_tuple(res, total, r, "decide");
      Py_DECREF(res);
    }
    PyGILState_Release(g);
  }

  r.total = total;
  // decisions accounting is the CALLER's job: the SLO path must not
  // double-count a breached batch the watcher already counted.
  return r.err_code == 0;
}

// Launch phase (pipelined mode): stage + enqueue via the non-blocking
// Python launch callback. Returns the ticket (new reference), or null
// with r.err_* set when the callback raised.
PyObject* launch_core(Server* s, uint32_t shard, std::vector<Pending>& items,
                      Server::Reply& r, size_t* total_out,
                      uint64_t trace_id) {
  std::string blob;
  std::vector<int64_t> offsets, lengths, ns;
  size_t total = build_buffers(s, items, blob, offsets, lengths, ns);
  *total_out = total;
  if (total == 0) {
    r.limit = s->limit.load();
    return nullptr;  // err_code == 0: empty frame, answered directly
  }
  PyObject* ticket = nullptr;
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Iy#y#y#y#K)", (unsigned int)shard,
        blob.data(), (Py_ssize_t)blob.size(),
        (const char*)offsets.data(), (Py_ssize_t)(offsets.size() * 8),
        (const char*)lengths.data(), (Py_ssize_t)(lengths.size() * 8),
        (const char*)ns.data(), (Py_ssize_t)(ns.size() * 8),
        (unsigned long long)trace_id);
    ticket = args ? PyObject_CallObject(s->cb_launch, args) : nullptr;
    Py_XDECREF(args);
    if (ticket == nullptr)
      r.err_code = fetch_py_error(r.err_msg, "launch callback failed",
                                  E_STORAGE_UNAVAILABLE);
    PyGILState_Release(g);
  }
  return ticket;
}

// Hashed-lane buffers: finalized u64 ids + ns, contiguous per drained
// run — two memcpy-built arrays, no blob, no offsets/lengths.
size_t build_hashed_buffers(const std::vector<Pending>& items,
                            std::vector<uint64_t>& ids,
                            std::vector<int64_t>& ns) {
  size_t total = 0;
  for (auto& p : items) total += p.ids.size();
  ids.reserve(total);
  ns.reserve(total);
  for (auto& p : items) {
    ids.insert(ids.end(), p.ids.begin(), p.ids.end());
    ns.insert(ns.end(), p.ns.begin(), p.ns.end());
  }
  return total;
}

// Blocking decide for a hashed run (legacy / SLO modes).
bool decide_hashed_core(Server* s, uint32_t shard,
                        std::vector<Pending>& items, Server::Reply& r,
                        uint64_t trace_id) {
  std::vector<uint64_t> ids;
  std::vector<int64_t> ns;
  size_t total = build_hashed_buffers(items, ids, ns);
  r.hashed = true;
  if (total == 0) {
    r.limit = s->limit.load();
    return true;
  }
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Iy#y#K)", (unsigned int)shard,
        (const char*)ids.data(), (Py_ssize_t)(ids.size() * 8),
        (const char*)ns.data(), (Py_ssize_t)(ns.size() * 8),
        (unsigned long long)trace_id);
    PyObject* res =
        args ? PyObject_CallObject(s->cb_decide_hashed, args) : nullptr;
    Py_XDECREF(args);
    if (res == nullptr) {
      r.err_code = fetch_py_error(r.err_msg, "decide_hashed callback failed",
                                  E_STORAGE_UNAVAILABLE);
    } else {
      parse_result_tuple(res, total, r, "decide_hashed");
      Py_DECREF(res);
    }
    PyGILState_Release(g);
  }
  r.total = total;
  return r.err_code == 0;
}

// Non-blocking launch for a hashed run (pipelined mode).
PyObject* launch_hashed_core(Server* s, uint32_t shard,
                             std::vector<Pending>& items, Server::Reply& r,
                             size_t* total_out, uint64_t trace_id) {
  std::vector<uint64_t> ids;
  std::vector<int64_t> ns;
  size_t total = build_hashed_buffers(items, ids, ns);
  *total_out = total;
  r.hashed = true;
  if (total == 0) {
    r.limit = s->limit.load();
    return nullptr;  // err_code == 0: empty frame, answered directly
  }
  PyObject* ticket = nullptr;
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* args = Py_BuildValue(
        "(Iy#y#K)", (unsigned int)shard,
        (const char*)ids.data(), (Py_ssize_t)(ids.size() * 8),
        (const char*)ns.data(), (Py_ssize_t)(ns.size() * 8),
        (unsigned long long)trace_id);
    ticket = args ? PyObject_CallObject(s->cb_launch_hashed, args) : nullptr;
    Py_XDECREF(args);
    if (ticket == nullptr)
      r.err_code = fetch_py_error(r.err_msg, "launch_hashed callback failed",
                                  E_STORAGE_UNAVAILABLE);
    PyGILState_Release(g);
  }
  return ticket;
}

// Completer (pipelined mode): resolve in-flight tickets OLDEST FIRST and
// hand results to the responder. Outlives the dispatchers (a dispatcher
// mid-launch at stop time pushes its ticket afterward) and drains the
// queue fully before exiting, so every launched batch is answered and
// every ticket reference released.
void completer_main(Server* s, uint32_t shard) {
  Server::PipeQ& q = *s->pipeqs[shard];
  s->live_completers.fetch_add(1);
  struct Depart {
    Server* s;
    ~Depart() {
      s->live_completers.fetch_sub(1);
      // The responder tests live_completers under rmx (see dispatcher).
      notify_locked(s->rmx, s->rcv);
    }
  } depart{s};
  while (true) {
    // Completion batching (ADR-013): drain EVERY in-flight ticket in one
    // wake — resolve order stays oldest-first (FIFO state threading),
    // the whole batch leaves the queue in one cv_items acquisition, and
    // a multi-segment frame whose slices resolved back-to-back finishes
    // its BatchJoin within one wake instead of straddling several.
    // Window slots free ONE PER RESOLVE below, not at swap time: a
    // swapped-out ticket is still a launched-but-unresolved device
    // dispatch, and releasing the whole window here would let the
    // dispatcher run the outstanding depth to 2x the documented
    // `inflight` bound.
    std::deque<Server::InflightEntry> batch;
    {
      std::unique_lock<std::mutex> lk(q.mx);
      q.cv_items.wait(lk, [&] {
        return !q.entries.empty() ||
               (s->stop.load() && s->live_dispatchers.load() == 0);
      });
      if (q.entries.empty()) return;  // stopped, launchers gone, drained
      batch.swap(q.entries);
      q.resolving += batch.size();
    }
    for (auto& e : batch) {
      Server::Reply r;
      r.hashed = e.hashed;
      uint64_t t_v0 = mono_ns(), t_v1 = t_v0;
      {
        PyGILState_STATE g = PyGILState_Ensure();
        PyObject* res = PyObject_CallFunction(
            s->cb_resolve, "IO", (unsigned int)shard, e.ticket);
        Py_DECREF(e.ticket);
        t_v1 = mono_ns();
        if (res == nullptr) {
          r.err_code = fetch_py_error(r.err_msg, "resolve callback failed",
                                      E_STORAGE_UNAVAILABLE);
        } else {
          parse_result_tuple(res, e.total, r, "resolve");
          Py_DECREF(res);
        }
        if (s->spans_enabled) {
          // Per-ticket stage stamps into the Python flight recorder
          // (ADR-014) — the GIL is already held for the resolve,
          // so the callback costs no extra acquisition. Failures must
          // never break serving: clear and move on.
          PyObject* sres = PyObject_CallFunction(
              s->cb_spans, "IKKKKKKK", (unsigned int)shard,
              (unsigned long long)e.total,
              (unsigned long long)e.trace_id, (unsigned long long)e.t_io,
              (unsigned long long)e.t_d0, (unsigned long long)e.t_d1,
              (unsigned long long)t_v0, (unsigned long long)t_v1);
          if (sres == nullptr) PyErr_Clear();
          else Py_DECREF(sres);
        }
        PyGILState_Release(g);
      }
      r.total = e.total;
      if (r.err_code == 0) {
        s->decisions.fetch_add(r.total);
        s->shard_decisions[shard].fetch_add(r.total);
        // Gated on the launch-time epoch: this dispatch's limit is stale
        // relative to any set_limits push issued since it launched.
        s->refresh_limit(r.limit, e.limit_epoch);
      }
      if (e.t_io && e.t_d0 >= e.t_io) s->stage_io_ns.fetch_add(e.t_d0 - e.t_io);
      s->stage_dispatch_ns.fetch_add(e.t_d1 - e.t_d0);
      s->stage_device_ns.fetch_add(t_v1 - t_v0);
      s->stage_complete_ns.fetch_add(mono_ns() - t_v1);
      s->stage_batches.fetch_add(1);
      r.items = std::move(e.items);
      {
        std::lock_guard<std::mutex> g(s->rmx);
        s->rqueue.push_back(std::move(r));
      }
      s->rcv.notify_one();
      {
        // Decrement under the lock so a dispatcher mid-predicate on
        // cv_space can't miss the wakeup (the lost-notify race of
        // signalling between its check and its block).
        std::lock_guard<std::mutex> lk(q.mx);
        q.resolving -= 1;
      }
      q.cv_space.notify_one();
    }
  }
}

// Finalize one split batch: called by the LAST shard to contribute.
// Failure semantics across shards are NOT transactional (the same
// contract as any keyspace-sharded store, e.g. a multi-key op spanning
// Redis Cluster slots): if one shard's decide fails, the whole frame
// answers ERROR, but keys on shards that succeeded HAVE consumed quota.
// The error direction is toward denying on retry, never over-admission.
void finish_join(Server* s, const JoinPtr& j) {
  uint16_t err = j->err.load();
  if (err != 0) {
    std::string msg;
    {
      std::lock_guard<std::mutex> g(j->emx);
      msg = j->err_msg;
    }
    conn_send(s, j->conn, make_error(j->req_id, err, msg));
    return;
  }
  std::string out;
  if (j->hashed) {
    encode_hashed_frame(out, j->req_id, j->limit.load(), j->flags.data(),
                        j->rem.data(), j->retry.data(), j->reset.data(),
                        j->count);
    conn_send(s, j->conn, std::move(out));
    return;
  }
  frame_header(out, T_RESULT_BATCH, j->req_id, 12 + 25 * j->count);
  put_i64(out, j->limit.load());
  put_u32(out, j->count);
  for (uint32_t i = 0; i < j->count; ++i) {
    out.push_back((char)j->flags[i]);
    put_i64(out, j->rem[i]);
    put_f64(out, j->retry[i]);
    put_f64(out, j->reset[i]);
  }
  conn_send(s, j->conn, std::move(out));
}

// Encode and queue one batch's responses from filled results.
void emit_reply(Server* s, std::vector<Pending>& items,
                const Server::Reply& r) {
  size_t idx = 0;
  for (auto& p : items) {
    if (p.join) {
      // One shard's slice of a split batch: deposit results at the
      // original positions; the last contributor sends the frame.
      JoinPtr j = p.join;
      if (r.err_code != 0) {
        uint16_t zero = 0;
        if (j->err.compare_exchange_strong(zero, r.err_code)) {
          std::lock_guard<std::mutex> g(j->emx);
          j->err_msg = r.err_msg;
        }
      } else {
        for (size_t i = 0; i < p.pos.size(); ++i) {
          uint32_t at = p.pos[i];
          j->flags[at] = r.flags[idx];
          j->rem[at] = r.remaining[idx];
          j->retry[at] = r.retry[idx];
          j->reset[at] = r.reset_at[idx];
          ++idx;
        }
        j->limit.store(r.limit);
      }
      if (r.err_code != 0) idx += pending_count(p);
      if (j->remaining.fetch_sub(1) == 1) finish_join(s, j);
      continue;
    }
    if (r.err_code != 0) {
      conn_send(s, p.conn, make_error(p.req_id, r.err_code, r.err_msg));
      continue;
    }
    std::string out;
    if (p.hashed) {
      // Columnar hashed response: three slice memcpys straight out of
      // the resolve buffers (ADR-011).
      uint32_t count = (uint32_t)p.ids.size();
      encode_hashed_frame(out, p.req_id, r.limit, r.flags.data() + idx,
                          r.remaining.data() + idx, r.retry.data() + idx,
                          r.reset_at.data() + idx, count);
      idx += count;
      conn_send(s, p.conn, std::move(out));
      continue;
    }
    if (!p.is_batch) {
      frame_header(out, T_RESULT, p.req_id, 33);
      out.push_back((char)r.flags[idx]);
      put_i64(out, r.limit);
      put_i64(out, r.remaining[idx]);
      put_f64(out, r.retry[idx]);
      put_f64(out, r.reset_at[idx]);
      ++idx;
    } else {
      uint32_t count = (uint32_t)p.keys.size();
      frame_header(out, T_RESULT_BATCH, p.req_id, 12 + 25 * count);
      put_i64(out, r.limit);
      put_u32(out, count);
      for (uint32_t i = 0; i < count; ++i) {
        out.push_back((char)r.flags[idx]);
        put_i64(out, r.remaining[idx]);
        put_f64(out, r.retry[idx]);
        put_f64(out, r.reset_at[idx]);
        ++idx;
      }
    }
    conn_send(s, p.conn, std::move(out));
  }
}

// SLO-path wrapper (single-shard only): decide, then answer inline
// unless the watcher beat us to it.
bool run_decide(Server* s, std::vector<Pending>& items,
                std::atomic<bool>* gate, bool hashed = false) {
  Server::Reply r;
  uint64_t ep = s->limit_epoch.load();
  uint64_t trace = 0;
  for (const auto& p : items)
    if (p.trace_id) { trace = p.trace_id; break; }
  bool ok = hashed ? decide_hashed_core(s, 0, items, r, trace)
                   : decide_core(s, 0, items, r, trace);
  if (gate != nullptr && gate->exchange(true)) {
    // SLO watcher already answered (and counted) these waiters; the
    // (late) state update above still landed in the limiter — drop the
    // responses.
    return ok;
  }
  if (ok) {
    s->decisions.fetch_add(r.total);
    s->shard_decisions[0].fetch_add(r.total);  // SLO path: single shard
    if (r.total) s->refresh_limit(r.limit, ep);
  }
  emit_reply(s, items, r);
  return ok;
}

// Non-SLO responder: encoding + socket handoff for batch k runs here
// while the dispatcher's batch k+1 is already inside the Python decide.
// Exits only once every dispatcher has exited AND the queue is drained —
// a dispatcher still inside a Python decide at stop time will enqueue
// its Reply afterward, and those waiters must still be answered.
void responder_main(Server* s) {
  while (true) {
    Server::Reply r;
    {
      std::unique_lock<std::mutex> lk(s->rmx);
      s->rcv.wait(lk, [&] {
        return !s->rqueue.empty() ||
               (s->stop.load() && s->live_dispatchers.load() == 0 &&
                s->live_completers.load() == 0);
      });
      if (s->rqueue.empty()) return;  // stopped, producers gone, drained
      r = std::move(s->rqueue.front());
      s->rqueue.pop_front();
    }
    uint64_t t0 = mono_ns();
    emit_reply(s, r.items, r);
    // Respond stage aggregate (ADR-014): encode + socket handoff time —
    // per-ticket span resolution stops at the completer (this thread is
    // deliberately GIL-free), so the responder reports in stats() only.
    s->stage_respond_ns.fetch_add(mono_ns() - t0);
  }
}

// Dispatch one drained group (string or hashed) via the mode-appropriate
// non-SLO path: pipelined launch when the matching launch callback is
// installed, blocking decide handed to the responder otherwise. String
// and hashed runs dispatch separately — their Python entry points (and
// response encodings) differ — but share the shard's in-flight window.
void dispatch_group(Server* s, uint32_t shard, std::vector<Pending>&& group,
                    bool hashed) {
  bool pipelined =
      s->pipelined &&
      (!hashed ||
       (s->cb_launch_hashed != nullptr && s->cb_launch_hashed != Py_None));
  // Per-run stage stamps (ADR-014): earliest io enqueue and the first
  // sampled trace id over the drained items.
  uint64_t run_io = 0, run_trace = 0;
  for (const auto& p : group) {
    if (p.t_io && (run_io == 0 || p.t_io < run_io)) run_io = p.t_io;
    if (run_trace == 0 && p.trace_id) run_trace = p.trace_id;
  }
  uint64_t t_d0 = mono_ns();
  if (pipelined) {
    Server::Reply r;
    size_t total = 0;
    uint64_t ep = s->limit_epoch.load();
    PyObject* ticket =
        hashed ? launch_hashed_core(s, shard, group, r, &total, run_trace)
               : launch_core(s, shard, group, r, &total, run_trace);
    if (ticket == nullptr) {
      // Launch failed (typed error for every waiter) or the run held
      // only empty frames — answer via the responder directly.
      r.total = total;
      r.items = std::move(group);
      {
        std::lock_guard<std::mutex> g(s->rmx);
        s->rqueue.push_back(std::move(r));
      }
      s->rcv.notify_one();
      return;
    }
    Server::PipeQ& pq = *s->pipeqs[shard];
    {
      std::unique_lock<std::mutex> lk(pq.mx);
      // Bounded window: block HERE (backpressure) when `inflight`
      // tickets are unresolved — queued PLUS swapped out for the
      // completer's batched drain, which are still unresolved device
      // dispatches; on stop, push anyway — the completer drains
      // everything before exiting.
      pq.cv_space.wait(lk, [&] {
        return pq.entries.size() + pq.resolving <
                   s->inflight_window ||
               s->stop.load();
      });
      pq.entries.push_back({std::move(group), ticket, total, ep, hashed,
                            run_io, t_d0, mono_ns(), run_trace});
    }
    pq.cv_items.notify_one();
    return;
  }
  // Throughput path: decide here, hand encode+send to the responder so
  // the next batch's decide starts immediately.
  Server::Reply r;
  r.hashed = hashed;
  uint64_t dep = s->limit_epoch.load();
  bool ok = hashed ? decide_hashed_core(s, shard, group, r, run_trace)
                   : decide_core(s, shard, group, r, run_trace);
  if (ok) {
    s->decisions.fetch_add(r.total);
    s->shard_decisions[shard].fetch_add(r.total);
    if (r.total) s->refresh_limit(r.limit, dep);
  }
  // Blocking path: decide covers dispatch+device in one span — feed the
  // aggregates (per-ticket spans are a pipelined-mode surface).
  if (run_io && t_d0 >= run_io) s->stage_io_ns.fetch_add(t_d0 - run_io);
  s->stage_dispatch_ns.fetch_add(mono_ns() - t_d0);
  s->stage_batches.fetch_add(1);
  r.items = std::move(group);
  {
    std::lock_guard<std::mutex> g(s->rmx);
    s->rqueue.push_back(std::move(r));
  }
  s->rcv.notify_one();
}

// Deadline shedding (ADR-015): answer the items of `group`
// whose propagated deadline expired BEFORE their dispatch ran, per the
// fail-open policy — fail-open rows stamped allowed|fail_open with the
// LIVE limit/window, fail-closed a typed E_DEADLINE error — and remove
// them from the group so the dispatch slot is never burned on them.
// Join-split segments deposit through emit_reply's normal paths, so a
// partially-shed multi-shard frame still answers as ONE frame.
void shed_expired(Server* s, uint32_t shard, std::vector<Pending>& group,
                  bool hashed) {
  uint64_t now = mono_ns();
  bool any = false;
  for (const auto& p : group)
    if (p.deadline_ns != 0 && now >= p.deadline_ns) { any = true; break; }
  if (!any) return;
  std::vector<Pending> live, dead;
  live.reserve(group.size());
  for (auto& p : group) {
    if (p.deadline_ns != 0 && now >= p.deadline_ns)
      dead.push_back(std::move(p));
    else
      live.push_back(std::move(p));
  }
  size_t total = 0;
  for (const auto& p : dead) total += pending_count(p);
  s->deadline_shed.fetch_add(total);
  Server::Reply r;
  r.hashed = hashed;
  r.total = total;
  if (s->fail_open) {
    r.limit = s->limit.load();
    double reset_at = now_s() + s->window_s.load();
    r.flags.assign(total, 3);  // allowed | fail_open
    r.remaining.assign(total, 0);
    r.retry.assign(total, 0.0);
    r.reset_at.assign(total, reset_at);
    s->decisions.fetch_add(total);
    s->shard_decisions[shard].fetch_add(total);
  } else {
    r.err_code = E_DEADLINE;
    r.err_msg = "request deadline expired before dispatch";
  }
  emit_reply(s, dead, r);
  group = std::move(live);
}

void handle_reset(Server* s, uint32_t shard, const Pending& p) {
  uint16_t err_code = 0;
  std::string err_msg;
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* res = PyObject_CallFunction(
        s->cb_reset, "Iy#", (unsigned int)shard, p.keys[0].data(),
        (Py_ssize_t)p.keys[0].size());
    if (res == nullptr) {
      err_code = fetch_py_error(err_msg, "reset failed",
                                E_STORAGE_UNAVAILABLE);
    } else {
      Py_DECREF(res);
    }
    PyGILState_Release(g);
  }
  std::string out;
  if (err_code) {
    out = make_error(p.req_id, err_code, err_msg);
  } else {
    frame_header(out, T_OK, p.req_id, 0);
  }
  conn_send(s, p.conn, std::move(out));
}

void handle_dcn(Server* s, const Pending& p) {
  // One T_DCN_PUSH body (keys[0] holds it). It rides shard 0's queue, so
  // merges serialize with that dispatcher; the Python callback merges
  // into every shard's limiter itself.
  uint16_t err_code = 0;
  std::string err_msg;
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* res = PyObject_CallFunction(
        s->cb_dcn, "y#", p.keys[0].data(), (Py_ssize_t)p.keys[0].size());
    if (res == nullptr) {
      err_code = fetch_py_error(err_msg, "DCN merge failed", E_INTERNAL);
    } else {
      Py_DECREF(res);
    }
    PyGILState_Release(g);
  }
  std::string out;
  if (err_code) {
    out = make_error(p.req_id, err_code, err_msg);
  } else {
    frame_header(out, T_OK, p.req_id, 0);
  }
  conn_send(s, p.conn, std::move(out));
}

void handle_fleet_map(Server* s, const Pending& p) {
  // T_FLEET_MAP on shard 0's dispatcher: the map's JSON from Python,
  // framed as T_FLEET_MAP_R (u32 len + JSON).
  std::string json;
  uint16_t err_code = 0;
  std::string err_msg;
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* res = PyObject_CallNoArgs(s->cb_fleet_map);
    if (res == nullptr) {
      err_code = fetch_py_error(err_msg, "fleet map failed", E_INTERNAL);
    } else {
      if (PyBytes_Check(res))
        json.assign(PyBytes_AsString(res), PyBytes_Size(res));
      Py_DECREF(res);
    }
    PyGILState_Release(g);
  }
  std::string out;
  if (err_code) {
    out = make_error(p.req_id, err_code, err_msg);
  } else {
    frame_header(out, T_FLEET_MAP_R, p.req_id, 4 + (uint32_t)json.size());
    put_u32(out, (uint32_t)json.size());
    out += json;
  }
  conn_send(s, p.conn, std::move(out));
}

void handle_metrics(Server* s, const Pending& p) {
  std::string text;
  {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* res = s->cb_metrics && s->cb_metrics != Py_None
                        ? PyObject_CallNoArgs(s->cb_metrics)
                        : nullptr;
    if (res != nullptr) {
      if (PyBytes_Check(res))
        text.assign(PyBytes_AsString(res), PyBytes_Size(res));
      else if (PyUnicode_Check(res)) {
        Py_ssize_t n = 0;
        const char* u = PyUnicode_AsUTF8AndSize(res, &n);
        if (u != nullptr) text.assign(u, n);
        else PyErr_Clear();
      }
      Py_DECREF(res);
    } else if (PyErr_Occurred()) {
      PyErr_Clear();
    }
    PyGILState_Release(g);
  }
  std::string out;
  frame_header(out, T_METRICS_R, p.req_id, 4 + (uint32_t)text.size());
  put_u32(out, (uint32_t)text.size());
  out += text;
  conn_send(s, p.conn, std::move(out));
}

void dispatcher_main(Server* s, uint32_t shard) {
  Server::ShardQ& q = *s->shardqs[shard];
  s->live_dispatchers.fetch_add(1);
  struct Depart {
    Server* s;
    ~Depart() {
      s->live_dispatchers.fetch_sub(1);
      // The responder and the completers test live_dispatchers in their
      // wait predicates: take each one's mutex between the decrement
      // and the notify, so none can test the old count and then block
      // after this notify has gone.
      notify_locked(s->rmx, s->rcv);
      for (auto& pq : s->pipeqs) notify_locked(pq->mx, pq->cv_items);
    }
  } depart{s};
  while (true) {
    std::vector<Pending> run;
    size_t run_keys = 0;
    {
      std::unique_lock<std::mutex> lk(q.qmx);
      if (q.queue.empty()) {
        q.qcv.wait(lk, [&] { return s->stop.load() || !q.queue.empty(); });
      } else {
        // First item already waiting: coalesce for up to max_delay.
        q.qcv.wait_for(lk, std::chrono::microseconds(s->max_delay_us),
                       [&] {
                         return s->stop.load() ||
                                q.queued_keys >= s->max_batch;
                       });
      }
      if (s->stop.load() && q.queue.empty()) return;
      while (!q.queue.empty() && run_keys < s->max_batch) {
        // RESET/METRICS ride the same queue (keys empty or kind marker).
        Pending& front = q.queue.front();
        // Forward-lane boundary: never mix forward windows (all rows
        // local) with client frames (whose bridge resolve may wait on
        // OUR forward legs) in one dispatch.
        if (!run.empty() && front.fwd != run.back().fwd) break;
        size_t nk = pending_count(front);
        size_t room = s->max_batch - run_keys;
        // Cut BEFORE crossing max_batch (never overshoot the largest
        // prewarmed pad shape). Mid-run, string Pendings cut whole
        // (the next run takes them); an oversized Pending — hashed
        // anywhere in a run, string opening one — is carved at the
        // boundary below. Only SLO mode still dispatches an oversized
        // Pending whole: the SLO watcher answers per-Pending with no
        // join awareness, and prewarm covers one pad shape past
        // max_batch, so only an SLO-mode frame past 2*max_batch pays
        // a hot-path compile.
        if (nk > room && run_keys > 0 &&
            (!front.hashed || s->slo_us > 0)) break;
        if (nk > room && s->slo_us == 0) {
          // Never let a dispatch overshoot max_batch: the Python side
          // prewarms every pad shape up to max_batch, so a run of
          // max_batch+1 items pads to the NEXT power of two and pays a
          // full jit compile on the hot path — the multi-second stalls
          // behind a mixed-traffic collapse (ADR-013). Segments
          // are position-indexed (`pos`), so carve off exactly `room`
          // items and leave a continuation that reassembles through
          // the same (extended) BatchJoin — the string lane rides the
          // shard-split deposit path verbatim. (room >= 1 here: the
          // loop condition guarantees run_keys < max_batch; a string
          // Pending only reaches the carve opening a run — the
          // whole-Pending cut above breaks first — so room is the
          // full max_batch there.)
          JoinPtr j = front.join;
          if (j == nullptr) {
            // Whole frame about to be segmented: wrap it in a join so
            // the response still goes out as ONE frame.
            uint32_t cnt = (uint32_t)pending_count(front);
            j = std::make_shared<BatchJoin>(1, front.conn, front.req_id,
                                            cnt);
            j->hashed = front.hashed;
            front.join = j;
            front.pos.resize(cnt);
            for (uint32_t i = 0; i < cnt; ++i) front.pos[i] = i;
          }
          // Register the continuation BEFORE the first half can ever
          // deposit (both still belong to this thread here), so
          // remaining cannot reach zero while a segment is outstanding.
          j->remaining.fetch_add(1);
          Pending head{front.conn, front.req_id, front.is_batch, {}, {}};
          head.hashed = front.hashed;
          head.join = j;
          head.t_io = front.t_io;
          head.trace_id = front.trace_id;
          head.deadline_ns = front.deadline_ns;
          head.fwd = front.fwd;
          if (front.hashed) {
            head.ids.assign(front.ids.begin(), front.ids.begin() + room);
            front.ids.erase(front.ids.begin(), front.ids.begin() + room);
          } else {
            head.keys.assign(
                std::make_move_iterator(front.keys.begin()),
                std::make_move_iterator(front.keys.begin() + room));
            front.keys.erase(front.keys.begin(),
                             front.keys.begin() + room);
          }
          head.ns.assign(front.ns.begin(), front.ns.begin() + room);
          head.pos.assign(front.pos.begin(), front.pos.begin() + room);
          front.ns.erase(front.ns.begin(), front.ns.begin() + room);
          front.pos.erase(front.pos.begin(), front.pos.begin() + room);
          run_keys += room;
          run.push_back(std::move(head));
          break;  // run is exactly full
        }
        run_keys += nk;
        run.push_back(std::move(front));
        q.queue.pop_front();
      }
      q.queued_keys -= std::min(q.queued_keys, run_keys);
    }
    // Split control items (req_id flag via ns sentinel) from decisions;
    // hashed frames dispatch as their own group (different Python entry
    // point + columnar response encoding, ADR-011).
    std::vector<Pending> decisions, hashed;
    for (auto& p : run) {
      if (!p.hashed && p.ns.size() == 1 && p.ns[0] == -1) {
        handle_reset(s, shard, p);
      } else if (!p.hashed && p.ns.size() == 1 && p.ns[0] == -2) {
        handle_metrics(s, p);
      } else if (!p.hashed && p.ns.size() == 1 && p.ns[0] == -3) {
        handle_dcn(s, p);
      } else if (!p.hashed && p.ns.size() == 1 && p.ns[0] == -4) {
        handle_fleet_map(s, p);
      } else if (p.hashed) {
        hashed.push_back(std::move(p));
      } else {
        decisions.push_back(std::move(p));
      }
    }
    // Deadline shedding BEFORE the dispatch fork (ADR-015):
    // both the pipelined/throughput and SLO paths skip expired work.
    if (!decisions.empty()) shed_expired(s, shard, decisions, false);
    if (!hashed.empty()) shed_expired(s, shard, hashed, true);
    if (decisions.empty() && hashed.empty()) continue;
    if (s->slo_us == 0) {
      // Pipelined (ADR-010) or legacy throughput path, per group.
      if (!decisions.empty())
        dispatch_group(s, shard, std::move(decisions), false);
      if (!hashed.empty())
        dispatch_group(s, shard, std::move(hashed), true);
      continue;
    }
    // SLO path (single shard): one group at a time through the
    // single-deadline watcher.
    for (int grp = 0; grp < 2; ++grp) {
      std::vector<Pending>& g = grp == 0 ? decisions : hashed;
      if (g.empty()) continue;
      {
        std::lock_guard<std::mutex> lk(s->ifmx);
        s->inflight.items = std::move(g);
        s->inflight.answered.store(false);
        s->inflight.deadline = std::chrono::steady_clock::now() +
                               std::chrono::microseconds(s->slo_us);
        s->inflight.active = true;
      }
      s->ifcv.notify_all();
      run_decide(s, s->inflight.items, &s->inflight.answered, grp == 1);
      {
        std::lock_guard<std::mutex> lk(s->ifmx);
        s->inflight.active = false;
        s->inflight.items.clear();
      }
      s->ifcv.notify_all();
    }
  }
}

// ---- io thread -----------------------------------------------------------

void close_conn(Server* s, const ConnPtr& c) {
  if (c->closed.exchange(true)) return;
  IoRing* r = c->ring;
  if (c->dcn_big) {
    c->dcn_big = false;
    s->dcn_conns.fetch_sub(1);
  }
  if (c->shm) {
    // Deterministic reclaim (ADR-025): drop the doorbell/control fds
    // from the owning ring's engine, then let the lane destructor unmap
    // + unlink. Records the client pushed but we never drained are
    // abandoned with the mapping — exactly the TCP contract for bytes
    // in a dead socket.
    ShmLane* L = c->shm.get();
    for (int fd : {L->ctrl_listen_fd, L->efd_server}) {
      if (fd >= 0 && r != nullptr) {
        r->engine->del(fd);
        r->shm_fds.erase(fd);
      }
    }
    if (L->handshaken) s->shm_lanes_active.fetch_sub(1);
    c->shm.reset();
  }
  if (r != nullptr) {
    r->engine->del(c->fd);
    r->conns.erase(c->fd);
  }
  close(c->fd);
}

void ding_efd(int fd) {
  uint64_t one = 1;
  ssize_t r = write(fd, &one, 8);
  (void)r;
}

// Reply producer for an upgraded conn: push queued frames into the
// reply ring (every reply funnels through conn_send -> wq, so ALL
// encodings — results, errors, metrics, health — ride unchanged).
// Ring full leaves the residue in wq with producer_waiting raised; the
// client's consumer dings efd_server after freeing space and the drain
// path re-flushes. A peer further behind than the slow-reader cut
// (mirrors the asyncio door's WRITE_BUFFER_LIMIT) is disconnected.
void flush_shm_writes(Server* s, const ConnPtr& c) {
  ShmLane* L = c->shm.get();
  rlshm::Ring& ring = L->lane.outbound;
  bool pushed = false, cut = false;
  {
    std::lock_guard<std::mutex> g(c->wmx);
    while (!c->wq.empty()) {
      const std::string& f = c->wq.front();
      if (8 + rlshm::align8((uint32_t)f.size()) >= ring.capacity) {
        cut = true;  // frame can never fit: fatal for this lane
        break;
      }
      if (!ring.try_push((const uint8_t*)f.data(), (uint32_t)f.size())) {
        ring.set_producer_waiting();
        // Re-check after the SeqCst store: the consumer may have freed
        // space between the failed push and the flag store.
        if (!ring.try_push((const uint8_t*)f.data(), (uint32_t)f.size())) {
          s->shm_ring_full_stalls.fetch_add(1);
          break;
        }
        ring.clear_producer_waiting();
      }
      pushed = true;
      s->shm_records_out.fetch_add(1);
      c->wq_bytes -= f.size();
      c->wq.pop_front();
    }
    if (c->wq_bytes > 8ul * 1024 * 1024) cut = true;
    uint64_t used = ring.used();
    uint64_t hw = s->shm_rep_highwater.load();
    while (used > hw && !s->shm_rep_highwater.compare_exchange_weak(hw, used)) {
    }
  }
  if (pushed && ring.consumer_sleeping()) ding_efd(L->efd_client);
  if (cut) close_conn(s, c);
}

void flush_writes(Server* s, const ConnPtr& c) {
  if (c->shm && c->shm->handshaken) {
    // Upgraded conn: replies ride the reply ring, not the socket (the
    // socket is the liveness channel only past this point).
    flush_shm_writes(s, c);
    return;
  }
  IoRing* r = c->ring;
  std::lock_guard<std::mutex> g(c->wmx);
  // Vectored flush : EVERY queued frame rides one sendmsg
  // per iteration (capped well under IOV_MAX), replacing the old
  // write-per-frame loop. writev_frames / writev_calls is the batch
  // factor the rate_limiter_net_writev_frames metric proves.
  constexpr int kMaxIov = 64;
  static_assert(kMaxIov <= IOV_MAX, "iov cap must respect IOV_MAX");
  while (!c->wq.empty()) {
    struct iovec iov[kMaxIov];
    int cnt = 0;
    size_t total = 0;
    for (auto it = c->wq.begin(); it != c->wq.end() && cnt < kMaxIov; ++it) {
      size_t off = (cnt == 0) ? c->woff : 0;
      iov[cnt].iov_base = (void*)(it->data() + off);
      iov[cnt].iov_len = it->size() - off;
      total += iov[cnt].iov_len;
      ++cnt;
    }
    struct msghdr msg{};
    msg.msg_iov = iov;
    msg.msg_iovlen = (size_t)cnt;
    ssize_t w = sendmsg(c->fd, &msg, MSG_NOSIGNAL);
    if (r != nullptr) r->writev_calls.fetch_add(1, std::memory_order_relaxed);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      close_conn(s, c);
      return;
    }
    size_t left = (size_t)w;
    while (left > 0 && !c->wq.empty()) {
      size_t avail = c->wq.front().size() - c->woff;
      if (left >= avail) {
        left -= avail;
        c->wq_bytes -= c->wq.front().size();
        c->wq.pop_front();
        c->woff = 0;
        if (r != nullptr)
          r->writev_frames.fetch_add(1, std::memory_order_relaxed);
      } else {
        c->woff += left;
        left = 0;
      }
    }
    if ((size_t)w < total) break;  // kernel buffer full: wait for EPOLLOUT
  }
  bool want = !c->wq.empty();
  if (want != c->want_write) {
    c->want_write = want;
    if (r != nullptr) r->engine->mod(c->fd, want);
  }
}

bool process_rbuf(Server* s, const ConnPtr& c);

uint32_t clamp_ring_bytes(uint32_t n) {
  // Mirrors serving/shm.py clamp_ring_bytes: 0 -> default 2 MiB, else a
  // power of two in [MIN_RING, MAX_RING].
  if (n == 0) return 1u << 21;
  if (n < rlshm::MIN_RING) n = rlshm::MIN_RING;
  if (n > rlshm::MAX_RING) n = rlshm::MAX_RING;
  uint32_t p = rlshm::MIN_RING;
  while (p < n) p <<= 1;
  return p;
}

// T_SHM_HELLO on the io thread (ADR-025): create the per-connection
// mapping + eventfds + one-shot control listener, answer T_SHM_HELLO_R
// over the socket. Returns false on a malformed body (protocol error:
// the caller closes the connection, matching parse_shm_hello's raise).
bool handle_shm_hello(Server* s, const ConnPtr& c, uint64_t req_id,
                      const char* body, uint32_t blen) {
  if (blen != 12) return false;
  if (!s->shm_enabled) {
    conn_send(s, c, make_error(req_id, E_INVALID_CONFIG,
                               "shm lane not enabled on this server "
                               "(--shm)"));
    return true;
  }
  if (c->shm) {
    conn_send(s, c, make_error(req_id, E_INVALID_CONFIG,
                               "shm lane already active on this "
                               "connection"));
    return true;
  }
  uint32_t version, req_b, rep_b;
  memcpy(&version, body, 4);
  memcpy(&req_b, body + 4, 4);
  memcpy(&rep_b, body + 8, 4);
  if (version != rlshm::VERSION) {
    conn_send(s, c, make_error(req_id, E_INVALID_CONFIG,
                               "unsupported shm lane version"));
    return true;
  }
  uint32_t req_cap = clamp_ring_bytes(req_b ? req_b : s->shm_ring_bytes);
  uint32_t rep_cap = clamp_ring_bytes(rep_b ? rep_b : s->shm_ring_bytes);
  auto L = std::make_unique<ShmLane>();
  int sfd = -1;
  char path[512];
  for (int attempt = 0; attempt < 64 && sfd < 0; ++attempt) {
    snprintf(path, sizeof(path), "%s/rltpu-shm-%d-n%u-%d",
             s->shm_dir.c_str(), (int)getpid(),
             s->lane_ctr.fetch_add(1) + 1, attempt);
    sfd = open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  }
  if (sfd < 0) {
    conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                               "could not allocate shm lane file"));
    return true;
  }
  L->shm_path = path;
  L->ctrl_path = L->shm_path + ".ctrl";
  L->map_len = (size_t)rlshm::total_bytes(req_cap, rep_cap);
  if (ftruncate(sfd, (off_t)L->map_len) != 0 ||
      (L->base = (uint8_t*)mmap(nullptr, L->map_len,
                                PROT_READ | PROT_WRITE, MAP_SHARED, sfd,
                                0)) == MAP_FAILED) {
    L->base = nullptr;
    close(sfd);
    unlink(path);
    L->unlinked = true;
    conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                               "could not map shm lane file"));
    return true;
  }
  close(sfd);
  rlshm::init_file(L->base, req_cap, rep_cap);
  rlshm::attach(L->base, /*server=*/true, &L->lane);
  // Armed from birth: the client's very first push must ding the
  // doorbell (the drain path re-arms after each empty spin).
  L->lane.inbound.set_sleeping();
  L->efd_server = eventfd(0, EFD_NONBLOCK);
  L->efd_client = eventfd(0, EFD_NONBLOCK);
  L->ctrl_listen_fd =
      socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
  struct sockaddr_un sun{};
  sun.sun_family = AF_UNIX;
  if (L->efd_server < 0 || L->efd_client < 0 || L->ctrl_listen_fd < 0 ||
      L->ctrl_path.size() >= sizeof(sun.sun_path)) {
    conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                               "could not set up shm lane doorbells"));
    return true;  // ~ShmLane cleans up
  }
  memcpy(sun.sun_path, L->ctrl_path.c_str(), L->ctrl_path.size() + 1);
  unlink(L->ctrl_path.c_str());
  if (bind(L->ctrl_listen_fd, (struct sockaddr*)&sun, sizeof(sun)) != 0 ||
      chmod(L->ctrl_path.c_str(), 0600) != 0 ||
      listen(L->ctrl_listen_fd, 1) != 0) {
    conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                               "could not bind shm control socket"));
    return true;
  }
  // The lane's ctrl socket rides the conn's OWN ring, so
  // handshake and doorbell traffic shard with the connection.
  c->ring->engine->add(L->ctrl_listen_fd, false);
  c->ring->shm_fds[L->ctrl_listen_fd] = c;
  std::string sp = L->shm_path, cp = L->ctrl_path;
  c->shm = std::move(L);
  s->conns_shm.fetch_add(1);
  std::string out;
  frame_header(out, T_SHM_HELLO_R, req_id,
               9 + 2 + (uint32_t)sp.size() + 2 + (uint32_t)cp.size());
  out.push_back((char)1);  // ok
  put_u32(out, req_cap);
  put_u32(out, rep_cap);
  put_u16(out, (uint16_t)sp.size());
  out += sp;
  put_u16(out, (uint16_t)cp.size());
  out += cp;
  conn_send(s, c, std::move(out));  // lane not handshaken: rides the socket
  return true;
}

// Control-socket accept: ship the eventfd pair via SCM_RIGHTS, then
// unlink both filesystem artifacts (the peer holds them open) and start
// watching the request doorbell.
void shm_ctrl_accept(Server* s, const ConnPtr& c) {
  ShmLane* L = c->shm.get();
  int cfd = accept4(L->ctrl_listen_fd, nullptr, nullptr, 0);
  if (cfd < 0) return;
  char data = 'x';
  struct iovec iov {
    &data, 1
  };
  char cbuf[CMSG_SPACE(2 * sizeof(int))];
  memset(cbuf, 0, sizeof(cbuf));
  struct msghdr msg{};
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  msg.msg_control = cbuf;
  msg.msg_controllen = sizeof(cbuf);
  struct cmsghdr* cm = CMSG_FIRSTHDR(&msg);
  cm->cmsg_level = SOL_SOCKET;
  cm->cmsg_type = SCM_RIGHTS;
  cm->cmsg_len = CMSG_LEN(2 * sizeof(int));
  int fds[2] = {L->efd_server, L->efd_client};
  memcpy(CMSG_DATA(cm), fds, sizeof(fds));
  msg.msg_controllen = cm->cmsg_len;
  ssize_t w = sendmsg(cfd, &msg, 0);
  close(cfd);
  IoRing* r = c->ring;
  r->engine->del(L->ctrl_listen_fd);
  r->shm_fds.erase(L->ctrl_listen_fd);
  close(L->ctrl_listen_fd);
  L->ctrl_listen_fd = -1;
  unlink(L->ctrl_path.c_str());
  unlink(L->shm_path.c_str());
  L->unlinked = true;
  if (w < 0) {
    close_conn(s, c);
    return;
  }
  L->handshaken = true;
  s->shm_lanes_active.fetch_add(1);
  r->engine->add(L->efd_server, false);
  r->shm_fds[L->efd_server] = c;
  // Replies queued during the handshake window move to the ring now.
  flush_shm_writes(s, c);
}

// Request-doorbell wake: drain every committed record into rbuf (records
// ARE wire frames, so the normal parser consumes them unchanged), with
// the same cleared-while-draining / re-arm / missed-wake-recheck
// protocol as the Python ServerLane. A torn record poisons the lane —
// reclaim through the liveness socket, never spin on corrupt memory.
void shm_drain(Server* s, const ConnPtr& c) {
  ShmLane* L = c->shm.get();
  uint64_t junk;
  ssize_t r = read(L->efd_server, &junk, 8);
  (void)r;
  s->shm_doorbell_wakes.fetch_add(1);
  rlshm::Ring& ring = L->lane.inbound;
  uint64_t used = ring.used();
  uint64_t hw = s->shm_req_highwater.load();
  while (used > hw && !s->shm_req_highwater.compare_exchange_weak(hw, used)) {
  }
  ring.clear_sleeping();
  bool dead = false;
  for (;;) {
    const uint8_t* payload;
    uint32_t len;
    rlshm::Ring::PopResult pr = ring.pop(&payload, &len);
    if (pr == rlshm::Ring::POP_EMPTY) {
      // Dispatch what is buffered BEFORE burning the spin budget — the
      // spin exists to catch back-to-back pushes cheaply, not to delay
      // work already in hand.
      if (!c->rbuf.empty() && !process_rbuf(s, c)) {
        dead = true;
        break;
      }
      for (int i = 0; i < SHM_SPIN_ITERS; ++i) {
        pr = ring.pop(&payload, &len);
        if (pr != rlshm::Ring::POP_EMPTY) {
          s->shm_spin_hits.fetch_add(1);
          break;
        }
      }
      if (pr == rlshm::Ring::POP_EMPTY) {
        ring.set_sleeping();
        pr = ring.pop(&payload, &len);  // missed-wake recheck
        if (pr == rlshm::Ring::POP_EMPTY) break;
        ring.clear_sleeping();
      }
    }
    if (pr == rlshm::Ring::POP_TORN) {
      dead = true;
      break;
    }
    c->rbuf.append((const char*)payload, len);
    ring.advance(len);
    s->shm_records_in.fetch_add(1);
  }
  if (!dead && !c->rbuf.empty() && !process_rbuf(s, c)) dead = true;
  if (dead) {
    close_conn(s, c);
    return;
  }
  if (ring.producer_waiting()) {
    ring.clear_producer_waiting();
    ding_efd(L->efd_client);
  }
  // Space may have been freed on the reply ring by the client too;
  // retry any residue the last flush left queued.
  flush_shm_writes(s, c);
}

// Parse complete frames out of c->rbuf; enqueue work.
bool process_rbuf(Server* s, const ConnPtr& c) {
  size_t off = 0;
  while (c->rbuf.size() - off >= 13) {
    uint32_t length;
    memcpy(&length, c->rbuf.data() + off, 4);
    if (length < 9) return false;  // protocol error
    // The trace-context flag (ADR-014) and the deadline flag (ADR-015)
    // are stripped first: flagged requests prefix their body with a u64
    // trace id and an f64 budget.
    uint8_t rawtype = (uint8_t)c->rbuf[off + 4];
    if (rawtype == T_SHM_HELLO) {
      // Shm lane upgrade (ADR-025): EXACT match on the raw type byte
      // BEFORE any flag stripping — 16 aliases FORWARD_FLAG | 0, and
      // base type 0 is invalid, so this cannot shadow a real frame.
      if (length > MAX_FRAME) return false;
      if (c->rbuf.size() - off < 4 + length) break;
      uint64_t rid;
      memcpy(&rid, c->rbuf.data() + off + 5, 8);
      const char* hbody = c->rbuf.data() + off + 13;
      uint32_t hlen = length - 9;
      off += 4 + length;
      if (!handle_shm_hello(s, c, rid, hbody, hlen)) return false;
      continue;
    }
    bool traced = (rawtype & TRACE_FLAG) != 0 && rawtype < 0x80;
    uint8_t type = traced ? (uint8_t)(rawtype & ~TRACE_FLAG) : rawtype;
    bool deadlined = (type & DEADLINE_FLAG) != 0 && rawtype < 0x80;
    if (deadlined) type = (uint8_t)(type & ~DEADLINE_FLAG);
    bool fwd_hint = (type & FORWARD_FLAG) != 0 && rawtype < 0x80;
    if (fwd_hint) type = (uint8_t)(type & ~FORWARD_FLAG);
    uint64_t req_id;
    memcpy(&req_id, c->rbuf.data() + off + 5, 8);
    // The per-frame cap is type-aware: a DCN push gets the slab-sized cap
    // on a DCN-enabled server alone (protocol.parse_header's allow_dcn).
    uint32_t cap =
        (s->dcn_enabled && type == T_DCN_PUSH) ? MAX_DCN_FRAME : MAX_FRAME;
    if (length > cap) return false;  // protocol error
    size_t tskip = (traced ? 8 : 0) + (deadlined ? 8 : 0);
    if (s->dcn_enabled && type == T_DCN_PUSH && !c->dcn_big &&
        (size_t)4 + length > c->rbuf.size() - off) {
      // An incomplete push that will need slab-sized buffering is
      // screened before it is granted: where the server requires push
      // auth the body must open with the RLA envelope's magic, so an
      // oversized garbage stream labelled T_DCN_PUSH dies 4 bytes in
      // instead of buffering up to MAX_DCN_FRAME. A traced or deadlined
      // push moves the envelope past its extensions.
      if (c->rbuf.size() - off < 17 + tskip)
        break;  // need the first 4 body bytes
      const char* bm = c->rbuf.data() + off + 13 + tskip;
      if (s->dcn_auth_required &&
          !(bm[0] == 'R' && bm[1] == 'L' && bm[2] == 'A' &&
            (bm[3] == '1' || bm[3] == '2')))
        return false;
      // Bound the connections holding DCN-sized buffers.
      if (s->dcn_conns.fetch_add(1) >= s->max_dcn_conns) {
        s->dcn_conns.fetch_sub(1);
        // A direct send: returning false closes the connection at once,
        // which would drop a queued refusal before the peer read it.
        std::string err = make_error(req_id, E_STORAGE_UNAVAILABLE,
                                     "too many concurrent DCN transfers "
                                     "(raise max_dcn_conns)");
        ssize_t w = send(c->fd, err.data(), err.size(), MSG_NOSIGNAL);
        (void)w;
        return false;
      }
      c->dcn_big = true;
    }
    if (c->rbuf.size() - off < 4 + length) break;
    const char* body = c->rbuf.data() + off + 13;
    uint32_t blen = length - 9;
    off += 4 + length;
    uint64_t trace_id = 0;
    if (traced) {
      if (blen < 8) return false;  // short trace-id extension
      memcpy(&trace_id, body, 8);
      body += 8;
      blen -= 8;
    }
    uint64_t deadline_ns = 0;
    if (deadlined) {
      if (blen < 8) return false;  // short deadline extension
      double budget;
      memcpy(&budget, body, 8);
      body += 8;
      blen -= 8;
      // Relative budget anchored at arrival (wall clocks need not
      // agree across machines); non-positive budgets are already
      // expired and shed at the next dispatch boundary.
      if (budget > 0.0 && budget < 86400.0 * 365)
        deadline_ns = mono_ns() + (uint64_t)(budget * 1e9);
      else if (budget <= 0.0)
        deadline_ns = 1;  // any past instant: expired on arrival
    }

    auto enqueue = [&](Pending&& p, size_t nkeys, uint32_t shard) {
      Server::ShardQ& q = *s->shardqs[shard];
      std::lock_guard<std::mutex> g(q.qmx);
      q.queue.push_back(std::move(p));
      q.queued_keys += nkeys;
      q.qcv.notify_one();
    };

    if (type == T_ALLOW_N) {
      if (blen < 6) return false;
      uint32_t n;
      uint16_t klen;
      memcpy(&n, body, 4);
      memcpy(&klen, body + 4, 2);
      if (blen != 6u + klen || klen > MAX_KEY_LEN) return false;
      if (s->draining.load()) {
        conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                                   "server is shutting down"));
      } else if (klen == 0 || !utf8_valid(body + 6, klen)) {
        // Key before n: the asyncio server decodes the key during frame
        // parsing, so a frame bad in both ways answers E_INVALID_KEY
        // there — the two front doors must agree on the code.
        conn_send(s, c, make_error(req_id, E_INVALID_KEY,
                                   "key must be a non-empty UTF-8 string"));
      } else if (n == 0) {
        conn_send(s, c, make_error(req_id, E_INVALID_N,
                                   "n must be a positive integer, got 0"));
      } else {
        std::string key(body + 6, klen);
        uint32_t shard = key_shard(s, key);
        Pending p{c, req_id, false, {std::move(key)}, {(int64_t)n}};
        p.t_io = mono_ns();
        p.trace_id = trace_id;
        p.deadline_ns = deadline_ns;
        enqueue(std::move(p), 1, shard);
      }
    } else if (type == T_ALLOW_BATCH) {
      if (blen < 4) return false;
      uint32_t count;
      memcpy(&count, body, 4);
      // Untrusted count: every item needs >= 6 body bytes, so anything
      // larger is malformed — reject BEFORE reserving (alloc bound).
      if (count > (blen - 4) / 6) return false;
      Pending p{c, req_id, true, {}, {}};
      p.t_io = mono_ns();
      p.trace_id = trace_id;
      p.deadline_ns = deadline_ns;
      p.fwd = fwd_hint;
      p.keys.reserve(count);
      p.ns.reserve(count);
      size_t pos = 4;
      // Error precedence mirrors the asyncio server exactly: it decodes
      // every key at parse time (any undecodable key anywhere answers
      // E_INVALID_KEY), then validates pairs in order, key before n.
      bool bad_utf8 = false;
      uint16_t first_err = 0;
      for (uint32_t i = 0; i < count; ++i) {
        if (pos + 6 > blen) return false;
        uint32_t n;
        uint16_t klen;
        memcpy(&n, body + pos, 4);
        memcpy(&klen, body + pos + 4, 2);
        pos += 6;
        if (klen > MAX_KEY_LEN || pos + klen > blen) return false;
        if (klen != 0 && !utf8_valid(body + pos, klen)) bad_utf8 = true;
        if (first_err == 0) {
          if (klen == 0) first_err = E_INVALID_KEY;
          else if (n == 0) first_err = E_INVALID_N;
        }
        p.keys.emplace_back(body + pos, klen);
        p.ns.push_back((int64_t)n);
        pos += klen;
      }
      if (pos != blen) return false;
      if (s->draining.load()) {
        conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                                   "server is shutting down"));
      } else if (bad_utf8 || first_err == E_INVALID_KEY) {
        conn_send(s, c, make_error(req_id, E_INVALID_KEY,
                                   "key must be a non-empty UTF-8 string"));
      } else if (first_err == E_INVALID_N) {
        conn_send(s, c, make_error(req_id, E_INVALID_N,
                                   "n must be a positive integer"));
      } else if (s->num_shards == 1 || p.keys.empty()) {
        // count==0 frames are valid (empty RESULT_BATCH): route whole to
        // shard 0 — the mixed-shard splitter below indexes keys[0].
        size_t nk = p.keys.size();
        enqueue(std::move(p), nk, 0);
      } else {
        // Route each key to its shard. Single-shard frames go whole;
        // mixed frames split into per-shard slices joined for the one
        // response (BatchJoin).
        std::vector<uint32_t> shards_of(p.keys.size());
        uint32_t first_shard = key_shard(s, p.keys[0]);
        bool mixed = false;
        shards_of[0] = first_shard;
        for (size_t i = 1; i < p.keys.size(); ++i) {
          shards_of[i] = key_shard(s, p.keys[i]);
          mixed |= shards_of[i] != first_shard;
        }
        if (!mixed) {
          size_t nk = p.keys.size();
          enqueue(std::move(p), nk, first_shard);
        } else {
          std::vector<std::vector<uint32_t>> per(s->num_shards);
          for (size_t i = 0; i < p.keys.size(); ++i)
            per[shards_of[i]].push_back((uint32_t)i);
          uint32_t involved = 0;
          for (auto& v : per) involved += !v.empty();
          JoinPtr j = std::make_shared<BatchJoin>(
              involved, c, req_id, (uint32_t)p.keys.size());
          for (uint32_t sh = 0; sh < s->num_shards; ++sh) {
            if (per[sh].empty()) continue;
            Pending part{c, req_id, true, {}, {}};
            part.t_io = p.t_io;
            part.trace_id = p.trace_id;
            part.deadline_ns = p.deadline_ns;
            part.fwd = p.fwd;
            part.join = j;
            part.pos = std::move(per[sh]);
            part.keys.reserve(part.pos.size());
            part.ns.reserve(part.pos.size());
            for (uint32_t at : part.pos) {
              part.keys.push_back(std::move(p.keys[at]));
              part.ns.push_back(p.ns[at]);
            }
            size_t nk = part.keys.size();
            enqueue(std::move(part), nk, sh);
          }
        }
      }
    } else if (type == T_ALLOW_HASHED) {
      // Zero-copy bulk lane (ADR-011): columnar u64 ids + u32 ns. The
      // splitmix64 finalizer runs HERE (io thread, GIL-free) so the
      // dispatcher's launch hands Python ready-made hashes.
      if (blen < 4) return false;
      uint32_t count;
      memcpy(&count, body, 4);
      if (count > (blen - 4) / 12 || blen != 4 + 12ull * count)
        return false;
      if (!s->hashed_enabled) {
        conn_send(s, c, make_error(req_id, E_INVALID_CONFIG,
                                   "the hashed bulk lane requires a "
                                   "sketch-family backend"));
      } else if (s->draining.load()) {
        conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                                   "server is shutting down"));
      } else {
        const char* idp = body + 4;
        const char* npp = body + 4 + 8ull * count;
        bool bad_n = false;
        Pending p{c, req_id, true, {}, {}};
        p.t_io = mono_ns();
        p.trace_id = trace_id;
        p.deadline_ns = deadline_ns;
        p.fwd = fwd_hint;
          p.hashed = true;
        p.ids.reserve(count);
        p.ns.reserve(count);
        for (uint32_t i = 0; i < count; ++i) {
          uint64_t raw;
          uint32_t n;
          memcpy(&raw, idp + 8ull * i, 8);
          memcpy(&n, npp + 4ull * i, 4);
          if (n == 0) bad_n = true;
          p.ids.push_back(splitmix64(raw));
          p.ns.push_back((int64_t)n);
        }
        if (bad_n) {
          conn_send(s, c, make_error(req_id, E_INVALID_N,
                                     "n must be a positive integer"));
        } else if (s->num_shards == 1 || count == 0) {
          enqueue(std::move(p), count, 0);
        } else {
          // Per-id shard routing on the FINALIZED hash (well mixed);
          // Python mirror: NativeRateLimitServer.shard_of_id.
          std::vector<uint32_t> shards_of(count);
          uint32_t first_shard = (uint32_t)(p.ids[0] % s->num_shards);
          bool mixed = false;
          shards_of[0] = first_shard;
          for (uint32_t i = 1; i < count; ++i) {
            shards_of[i] = (uint32_t)(p.ids[i] % s->num_shards);
            mixed |= shards_of[i] != first_shard;
          }
          if (!mixed) {
            enqueue(std::move(p), count, first_shard);
          } else {
            std::vector<std::vector<uint32_t>> per(s->num_shards);
            for (uint32_t i = 0; i < count; ++i)
              per[shards_of[i]].push_back(i);
            uint32_t involved = 0;
            for (auto& v : per) involved += !v.empty();
            JoinPtr j = std::make_shared<BatchJoin>(involved, c, req_id,
                                                    count);
            j->hashed = true;
            for (uint32_t sh = 0; sh < s->num_shards; ++sh) {
              if (per[sh].empty()) continue;
              Pending part{c, req_id, true, {}, {}};
              part.t_io = p.t_io;
              part.trace_id = p.trace_id;
              part.deadline_ns = p.deadline_ns;
              part.fwd = p.fwd;
                part.hashed = true;
              part.join = j;
              part.pos = std::move(per[sh]);
              part.ids.reserve(part.pos.size());
              part.ns.reserve(part.pos.size());
              for (uint32_t at : part.pos) {
                part.ids.push_back(p.ids[at]);
                part.ns.push_back(p.ns[at]);
              }
              size_t nk = part.ids.size();
              enqueue(std::move(part), nk, sh);
            }
          }
        }
      }
    } else if (type == T_RESET) {
      if (blen < 2) return false;
      uint16_t klen;
      memcpy(&klen, body, 2);
      if (blen != 2u + klen || klen > MAX_KEY_LEN) return false;
      if (klen == 0 || !utf8_valid(body + 2, klen)) {
        conn_send(s, c, make_error(req_id, E_INVALID_KEY,
                                   "key must be a non-empty UTF-8 string"));
      } else {
        std::string key(body + 2, klen);
        uint32_t shard = key_shard(s, key);
        Pending p{c, req_id, false, {std::move(key)}, {-1}};
        enqueue(std::move(p), 0, shard);
      }
    } else if (type == T_HEALTH) {
      std::string out;
      frame_header(out, T_HEALTH_R, req_id, 17);
      out.push_back(s->draining.load() ? 0 : 1);
      put_f64(out, now_s() - s->started_at);
      uint64_t d = s->decisions.load();
      out.append((char*)&d, 8);
      conn_send(s, c, std::move(out));
    } else if (type == T_METRICS) {
      Pending p{c, req_id, false, {std::string()}, {-2}};
      enqueue(std::move(p), 0, 0);
    } else if (type == T_DCN_PUSH) {
      if (c->dcn_big) {
        // The whole frame is in hand: release the slab-sized grant.
        c->dcn_big = false;
        s->dcn_conns.fetch_sub(1);
      }
      if (!s->dcn_enabled) {
        conn_send(s, c, make_error(req_id, E_INVALID_CONFIG,
                                   "DCN exchange not enabled on this server"));
      } else if (s->draining.load()) {
        conn_send(s, c, make_error(req_id, E_STORAGE_UNAVAILABLE,
                                   "server is shutting down"));
      } else {
        Pending p{c, req_id, false, {std::string(body, blen)}, {-3}};
        enqueue(std::move(p), 0, 0);
      }
    } else if (type == T_FLEET_MAP && s->cb_fleet_map != Py_None) {
      // A fleet member's map; outside a fleet the frame stays an
      // unknown type, as on the JAX door.
      Pending p{c, req_id, false, {std::string()}, {-4}};
      enqueue(std::move(p), 0, 0);
    } else {
      conn_send(s, c, make_error(req_id, E_INTERNAL, "unknown request type"));
    }
  }
  if (off) c->rbuf.erase(0, off);
  return true;
}

// Adopt an accepted socket onto this ring (ring thread only).
void ring_adopt(Server* s, IoRing* r, int cfd) {
  (void)s;
  auto c = std::make_shared<Conn>();
  c->fd = cfd;
  c->ring = r;
  r->conns[cfd] = c;
  r->engine->add(cfd, false);
}

// Per-connection fairness budget : the read drain
// still runs until EAGAIN, but one firehose connection may consume at
// most this many bytes per wakeup — the engine's level-triggered wait
// re-reports the fd immediately, AFTER every other ready connection on
// the ring got its turn.
constexpr size_t FAIR_READ_BUDGET = 1ul << 19;  // 512 KiB / conn / wakeup

// Adopt handed-over fds and flush reply-dirty conns. Runs at the top
// of every ring loop pass AND on an eventfd wakeup, so producers only
// pay the eventfd syscall when the ring is parked (IoRing::sleeping).
void ring_drain_pending(Server* s, IoRing* r) {
  std::vector<int> inbox;
  std::vector<ConnPtr> dirty;
  {
    std::lock_guard<std::mutex> g(r->imx);
    inbox.swap(r->inbox);
    dirty.swap(r->dirty);
  }
  for (int cfd : inbox) ring_adopt(s, r, cfd);
  // Flush exactly the conns with queued replies: the dirty flag
  // clears BEFORE the flush so a racing conn_send re-queues.
  for (auto& c : dirty) {
    c->dirty.store(false);
    if (!c->closed.load()) flush_writes(s, c);
  }
}

void ring_main(Server* s, IoRing* r) {
  std::vector<NetEvent> events(128);
  char buf[65536];
  while (!s->stop.load()) {
    ring_drain_pending(s, r);
    // Park only when no work arrived during the drain (Dekker with the
    // producers: sleeping is set BEFORE the emptiness re-check; a
    // producer pushes BEFORE it loads sleeping — one of the two always
    // sees the other).
    r->sleeping.store(true);
    bool pending;
    {
      std::lock_guard<std::mutex> g(r->imx);
      pending = !r->inbox.empty() || !r->dirty.empty();
    }
    if (pending || s->stop.load()) {
      r->sleeping.store(false);
      if (s->stop.load()) break;
      continue;
    }
    int n = r->engine->wait(events.data(), (int)events.size(), 100);
    r->sleeping.store(false);
    r->wait_calls.fetch_add(1, std::memory_order_relaxed);
    for (int i = 0; i < n; ++i) {
      int fd = events[i].fd;
      if (fd == s->listen_fd && r->idx == 0) {
        // Ring 0 owns the listener; connections are pinned to rings
        // round-robin by accept order . Foreign fds travel
        // through the target ring's inbox + eventfd ding so each
        // ring's conn map stays single-threaded.
        while (true) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          if (s->uds) {
            s->conns_uds.fetch_add(1);
          } else {
            int one = 1;
            setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
            s->conns_tcp.fetch_add(1);
          }
          uint32_t k =
              (uint32_t)(s->accept_ctr.fetch_add(1) % s->rings.size());
          if (k == r->idx) {
            ring_adopt(s, r, cfd);
          } else {
            IoRing* t = s->rings[k].get();
            {
              std::lock_guard<std::mutex> g(t->imx);
              t->inbox.push_back(cfd);
            }
            if (t->sleeping.exchange(false)) ding_efd(t->event_fd);
          }
        }
      } else if (fd == r->event_fd) {
        uint64_t drain;
        ssize_t rr = read(r->event_fd, &drain, 8);
        (void)rr;
        ring_drain_pending(s, r);
      } else {
        // Shm lane fds first: the one-shot control listener and, after
        // the handshake, the request doorbell (ADR-025).
        auto sit = r->shm_fds.find(fd);
        if (sit != r->shm_fds.end()) {
          ConnPtr sc = sit->second;
          if (sc->shm && fd == sc->shm->ctrl_listen_fd)
            shm_ctrl_accept(s, sc);
          else if (sc->shm)
            shm_drain(s, sc);
          continue;
        }
        auto it = r->conns.find(fd);
        if (it == r->conns.end()) continue;
        ConnPtr c = it->second;
        if (events[i].err) {
          close_conn(s, c);
          continue;
        }
        if (events[i].rd) {
          // Backpressure bound on unparsed bytes: four whole frames, or
          // one DCN push beside them on a connection process_rbuf has
          // granted a slab-sized buffer (after its pre-screen: the push
          // header, the RLA magic where auth is required, at most
          // max_dcn_conns holders), so a garbage stream dies at 4 MiB.
          const size_t small_cap = 4ul * MAX_FRAME;
          const size_t big_cap = 4ul + MAX_DCN_FRAME + 4ul * MAX_FRAME;
          bool dead = false;
          size_t budget = FAIR_READ_BUDGET;
          while (true) {
            ssize_t rd = recv(fd, buf, sizeof(buf), 0);
            r->recv_calls.fetch_add(1, std::memory_order_relaxed);
            if (rd > 0) {
              c->rbuf.append(buf, (size_t)rd);
              if (c->rbuf.size() > (c->dcn_big ? big_cap : small_cap)) {
                // Parse what is buffered (it grants dcn_big when a push
                // passes the pre-screen), then re-check.
                if (!process_rbuf(s, c)) { dead = true; break; }
                if (c->rbuf.size() > (c->dcn_big ? big_cap : small_cap)) {
                  dead = true;
                  break;
                }
              }
              budget -= (budget < (size_t)rd) ? budget : (size_t)rd;
              if (budget == 0) break;  // fairness cut: wait re-reports
              // Short read = the kernel handed over everything it had
              // buffered; skip the EAGAIN probe that would otherwise
              // end every drain cycle (halves recv syscalls at high
              // conn counts — bytes landing after this instant re-arm
              // the level-triggered wait).
              if ((size_t)rd < sizeof(buf)) break;
            } else if (rd == 0) {
              dead = true;
              break;
            } else {
              if (errno == EAGAIN || errno == EWOULDBLOCK) break;
              dead = true;
              break;
            }
          }
          if (!dead && !process_rbuf(s, c)) dead = true;
          if (dead) {
            close_conn(s, c);
            continue;
          }
        }
        if (events[i].wr) flush_writes(s, c);
      }
    }
  }
  // Teardown: close everything (pending writes were flushed by drain).
  for (auto& kv : std::map<int, ConnPtr>(r->conns)) close_conn(s, kv.second);
}

// ---- Python object -------------------------------------------------------

struct PyServer {
  PyObject_HEAD
  Server* s;
};

PyObject* server_start(PyObject* self, PyObject* args) {
  PyServer* ps = (PyServer*)self;
  Server* s = ps->s;
  const char* host;
  int port;
  if (!PyArg_ParseTuple(args, "si", &host, &port)) return nullptr;

  if (strncmp(host, "unix:", 5) == 0) {
    // UDS listener (ADR-025 transport ladder): host is "unix:/path".
    const char* upath = host + 5;
    struct sockaddr_un sun{};
    if (strlen(upath) >= sizeof(sun.sun_path)) {
      PyErr_SetString(PyExc_ValueError, "unix socket path too long");
      return nullptr;
    }
    s->uds = true;
    s->uds_path = upath;
    s->listen_fd = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
    sun.sun_family = AF_UNIX;
    memcpy(sun.sun_path, upath, strlen(upath) + 1);
    unlink(upath);  // stale socket from a previous run
    if (bind(s->listen_fd, (struct sockaddr*)&sun, sizeof(sun)) != 0 ||
        listen(s->listen_fd, 512) != 0) {
      PyErr_SetFromErrno(PyExc_OSError);
      return nullptr;
    }
    s->port = 0;
  } else {
    s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    int one = 1;
    setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    struct sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (bind(s->listen_fd, (struct sockaddr*)&addr, sizeof(addr)) != 0 ||
        listen(s->listen_fd, 512) != 0) {
      PyErr_SetFromErrno(PyExc_OSError);
      return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(s->listen_fd, (struct sockaddr*)&addr, &alen);
    s->port = ntohs(addr.sin_port);
  }

  // Network engine resolution (ADR-026): ring count, then the
  // io_uring startup probe. The probe runs for auto AND for an explicit
  // uring request — a refusing kernel (seccomp, CONFIG_IO_URING off)
  // downgrades to epoll with the reason recorded in stats()/healthz,
  // never a hard failure, so parity tests can always start the server
  // and assert the probe-miss record instead of silently skipping.
  if (s->io_rings == 0) {
    unsigned hc = std::thread::hardware_concurrency();
    s->io_rings = hc == 0 ? 1 : (hc < 4 ? hc : 4);
  }
  if (s->io_rings > 64) s->io_rings = 64;
  s->uring_active = false;
  s->uring_probe_err.clear();
  if (s->net_engine_req != 1) {
    s->uring_active = uring_probe(s->uring_probe_err);
  }
  s->rings.clear();
  for (uint32_t i = 0; i < s->io_rings; ++i) {
    auto ring = std::make_unique<IoRing>();
    ring->idx = i;
    ring->event_fd = eventfd(0, EFD_NONBLOCK);
    if (s->uring_active) {
      auto u = std::make_unique<UringEngine>(1024);
      if (u->ok()) {
        ring->engine = std::move(u);
      } else {
        // Probe passed but this ring's setup failed (fd/memlock
        // limits): record and fall back — every ring must serve.
        s->uring_probe_err = u->error();
        s->uring_active = false;
      }
    }
    if (!ring->engine) ring->engine = std::make_unique<EpollEngine>();
    ring->engine->add(ring->event_fd, false);
    if (i == 0) ring->engine->add(s->listen_fd, false);
    s->rings.push_back(std::move(ring));
  }

  s->started_at = now_s();
  s->shardqs.clear();
  for (uint32_t i = 0; i < s->num_shards; ++i)
    s->shardqs.push_back(std::make_unique<Server::ShardQ>());
  // Pipelined mode needs both callbacks and no SLO (the watcher's
  // single-deadline contract assumes one dispatch in flight).
  s->pipelined = s->cb_launch != nullptr && s->cb_launch != Py_None &&
                 s->cb_resolve != nullptr && s->cb_resolve != Py_None &&
                 s->slo_us == 0 && s->inflight_window > 1;
  s->pipeqs.clear();
  if (s->pipelined)
    for (uint32_t i = 0; i < s->num_shards; ++i)
      s->pipeqs.push_back(std::make_unique<Server::PipeQ>());
  for (auto& ring : s->rings)
    ring->thread = std::thread(ring_main, s, ring.get());
  for (uint32_t i = 0; i < s->num_shards; ++i)
    s->dispatch_threads.emplace_back(dispatcher_main, s, i);
  if (s->pipelined)
    for (uint32_t i = 0; i < s->num_shards; ++i)
      s->completer_threads.emplace_back(completer_main, s, i);
  if (s->slo_us > 0) s->slo_thread = std::thread(slo_main, s);
  else s->resp_thread = std::thread(responder_main, s);
  return PyLong_FromLong(s->port);
}

PyObject* server_shutdown(PyObject* self, PyObject* Py_UNUSED(ignored)) {
  PyServer* ps = (PyServer*)self;
  Server* s = ps->s;
  if (s->listen_fd >= 0) {
    // Graceful: stop new work, let the dispatchers drain their queues.
    s->draining.store(true);
    Py_BEGIN_ALLOW_THREADS;
    for (int i = 0; i < 200; ++i) {  // up to ~2 s of drain
      bool empty = true;
      for (auto& q : s->shardqs) {
        std::lock_guard<std::mutex> g(q->qmx);
        empty = empty && q->queue.empty();
      }
      if (empty) break;
      usleep(10000);
    }
    // Let the completers resolve every in-flight ticket (pipelined
    // mode) — an unresolved launch is an unanswered client. A ticket a
    // completer has swapped out for its batched drain counts too
    // (`resolving`): the queue alone looks empty mid-batch. Read both
    // under the queue's lock — the completer's swap and its
    // resolving increment happen atomically under that lock, so an
    // empty queue observed here implies any swapped batch is already
    // counted (checking the counter before the lock could miss the
    // transition and proceed mid-resolve).
    for (int i = 0; i < 200; ++i) {
      bool empty = true;
      for (auto& pq : s->pipeqs) {
        std::lock_guard<std::mutex> g(pq->mx);
        empty = empty && pq->entries.empty() && pq->resolving == 0;
      }
      if (empty) break;
      usleep(10000);
    }
    // Let the responder drain queued replies before stopping.
    for (int i = 0; i < 200; ++i) {
      {
        std::lock_guard<std::mutex> g(s->rmx);
        if (s->rqueue.empty()) break;
      }
      usleep(10000);
    }
    usleep(20000);  // let final responses flush
    stop_and_wake(s);
    for (auto& ring : s->rings) ding_efd(ring->event_fd);
    for (auto& ring : s->rings)
      if (ring->thread.joinable()) ring->thread.join();
    for (auto& t : s->dispatch_threads)
      if (t.joinable()) t.join();
    s->dispatch_threads.clear();
    for (auto& t : s->completer_threads)
      if (t.joinable()) t.join();
    s->completer_threads.clear();
    if (s->slo_thread.joinable()) s->slo_thread.join();
    if (s->resp_thread.joinable()) s->resp_thread.join();
    Py_END_ALLOW_THREADS;
    close(s->listen_fd);
    for (auto& ring : s->rings) {
      if (ring->event_fd >= 0) close(ring->event_fd);
      ring->event_fd = -1;
      ring->engine.reset();  // closes the epoll/uring fd
    }
    s->listen_fd = -1;
    if (s->uds && !s->uds_path.empty()) unlink(s->uds_path.c_str());
  }
  Py_RETURN_NONE;
}

PyObject* server_stats(PyObject* self, PyObject* Py_UNUSED(ignored)) {
  PyServer* ps = (PyServer*)self;
  size_t depth = 0;
  for (auto& pq : ps->s->pipeqs) {
    std::lock_guard<std::mutex> g(pq->mx);
    // Queued plus swapped out for the completer's batched drain — both
    // are launched-but-unresolved.
    depth += pq->entries.size() + (size_t)pq->resolving;
  }
  PyObject* per_shard = PyList_New(ps->s->num_shards);
  if (per_shard == nullptr) return nullptr;
  for (uint32_t i = 0; i < ps->s->num_shards; ++i) {
    PyObject* v = PyLong_FromUnsignedLongLong(
        (unsigned long long)ps->s->shard_decisions[i].load());
    if (v == nullptr) {
      Py_DECREF(per_shard);
      return nullptr;
    }
    PyList_SET_ITEM(per_shard, i, v);
  }
  // Cumulative per-stage wall time (ADR-014): ns each pipeline
  // stage has consumed across batched dispatches, plus the dispatch
  // count — enough to derive mean per-stage cost without any Python
  // callback in the loop.
  PyObject* stage_ns = Py_BuildValue(
      "{s:K,s:K,s:K,s:K,s:K,s:K}",
      "io", (unsigned long long)ps->s->stage_io_ns.load(),
      "dispatch", (unsigned long long)ps->s->stage_dispatch_ns.load(),
      "device", (unsigned long long)ps->s->stage_device_ns.load(),
      "complete", (unsigned long long)ps->s->stage_complete_ns.load(),
      "respond", (unsigned long long)ps->s->stage_respond_ns.load(),
      "batches", (unsigned long long)ps->s->stage_batches.load());
  if (stage_ns == nullptr) {
    Py_DECREF(per_shard);
    return nullptr;
  }
  // Per-transport accepts + shm lane counters (ADR-025): the same
  // shape the asyncio door's transport_stats() reports, so the metrics
  // collect hook and bench tooling read one schema from either door.
  PyObject* transport = Py_BuildValue(
      "{s:K,s:K,s:K}",
      "tcp", (unsigned long long)ps->s->conns_tcp.load(),
      "uds", (unsigned long long)ps->s->conns_uds.load(),
      "shm", (unsigned long long)ps->s->conns_shm.load());
  PyObject* shm_stats = Py_BuildValue(
      "{s:K,s:K,s:K,s:K,s:K,s:K,s:K,s:K}",
      "lanes_active", (unsigned long long)ps->s->shm_lanes_active.load(),
      "doorbell_wakes",
      (unsigned long long)ps->s->shm_doorbell_wakes.load(),
      "spin_hits", (unsigned long long)ps->s->shm_spin_hits.load(),
      "ring_full_stalls",
      (unsigned long long)ps->s->shm_ring_full_stalls.load(),
      "records_in", (unsigned long long)ps->s->shm_records_in.load(),
      "records_out", (unsigned long long)ps->s->shm_records_out.load(),
      "req_ring_highwater_bytes",
      (unsigned long long)ps->s->shm_req_highwater.load(),
      "rep_ring_highwater_bytes",
      (unsigned long long)ps->s->shm_rep_highwater.load());
  // Network-engine ledger (ADR-026): which backend the probe
  // selected, the ring count, and the engine-maintained syscall
  // counters — the numerator of syscalls-per-decision. uring_probe is
  // "pass" / "fail" / "off" (off = --net-engine epoll skipped it);
  // uring_probe_err carries the recorded downgrade reason.
  uint64_t net_recv = 0, net_writev = 0, net_wait = 0, net_wake = 0,
           net_wframes = 0;
  for (auto& ring : ps->s->rings) {
    net_recv += ring->recv_calls.load();
    net_writev += ring->writev_calls.load();
    net_wait += ring->wait_calls.load();
    net_wake += ring->wake_calls.load();
    net_wframes += ring->writev_frames.load();
  }
  PyObject* net = Py_BuildValue(
      "{s:s,s:I,s:s,s:s,s:K,s:K,s:K,s:K,s:K}",
      "engine", ps->s->uring_active ? "uring" : "epoll",
      "rings", (unsigned int)ps->s->rings.size(),
      "uring_probe",
      ps->s->net_engine_req == 1 ? "off"
                                 : (ps->s->uring_active ? "pass" : "fail"),
      "uring_probe_err", ps->s->uring_probe_err.c_str(),
      "recv_calls", (unsigned long long)net_recv,
      "writev_calls", (unsigned long long)net_writev,
      "wait_calls", (unsigned long long)net_wait,
      "wake_calls", (unsigned long long)net_wake,
      "writev_frames", (unsigned long long)net_wframes);
  if (transport == nullptr || shm_stats == nullptr || net == nullptr) {
    Py_DECREF(per_shard);
    Py_DECREF(stage_ns);
    Py_XDECREF(transport);
    Py_XDECREF(shm_stats);
    Py_XDECREF(net);
    return nullptr;
  }
  PyObject* out = Py_BuildValue(
      "{s:K,s:K,s:K,s:d,s:K,s:I,s:O,s:I,s:O,s:O,s:O,s:O,s:O}",
      "decisions_total",
      (unsigned long long)ps->s->decisions.load(), "slo_breaches_total",
      (unsigned long long)ps->s->slo_breaches.load(),
      // Deadline shedding (ADR-015).
      "deadline_shed_total",
      (unsigned long long)ps->s->deadline_shed.load(), "uptime_s",
      now_s() - ps->s->started_at, "inflight_depth",
      (unsigned long long)depth, "inflight_window", ps->s->inflight_window,
      "pipelined", ps->s->pipelined ? Py_True : Py_False,
      // Shard routing observability (mesh mode: one shard == one
      // device, so this is the per-device decision balance, ADR-012).
      "num_shards", ps->s->num_shards, "shard_decisions", per_shard,
      "stage_ns", stage_ns,
      "transport", transport, "shm", shm_stats, "net", net);
  Py_DECREF(per_shard);  // Py_BuildValue "O" took its own reference
  Py_DECREF(stage_ns);
  Py_DECREF(transport);
  Py_DECREF(shm_stats);
  Py_DECREF(net);
  return out;
}

PyObject* server_set_limits(PyObject* self, PyObject* args) {
  // Python push for the fail-open stamp fields (update_limit /
  // update_window on the bridge): responses stamped WITHOUT a completed
  // dispatch must carry the live limit.
  PyServer* ps = (PyServer*)self;
  long long limit;
  double window_s;
  if (!PyArg_ParseTuple(args, "Ld", &limit, &window_s)) return nullptr;
  {
    std::lock_guard<std::mutex> g(ps->s->limit_mx);
    ps->s->limit.store((int64_t)limit);
    ps->s->window_s.store(window_s);
    // Invalidate the per-batch refresh of every dispatch already
    // started: their limit predates this push.
    ps->s->limit_epoch.fetch_add(1);
  }
  Py_RETURN_NONE;
}

void server_dealloc(PyObject* self) {
  PyServer* ps = (PyServer*)self;
  if (ps->s != nullptr) {
    if (ps->s->listen_fd >= 0) {
      stop_and_wake(ps->s);
      for (auto& ring : ps->s->rings) ding_efd(ring->event_fd);
      // The dispatcher may be blocked in PyGILState_Ensure for a decide;
      // joining while holding the GIL would deadlock.
      Py_BEGIN_ALLOW_THREADS;
      for (auto& ring : ps->s->rings)
        if (ring->thread.joinable()) ring->thread.join();
      for (auto& t : ps->s->dispatch_threads)
        if (t.joinable()) t.join();
      ps->s->dispatch_threads.clear();
      for (auto& t : ps->s->completer_threads)
        if (t.joinable()) t.join();
      ps->s->completer_threads.clear();
      if (ps->s->slo_thread.joinable()) ps->s->slo_thread.join();
      if (ps->s->resp_thread.joinable()) ps->s->resp_thread.join();
      Py_END_ALLOW_THREADS;
      close(ps->s->listen_fd);
      for (auto& ring : ps->s->rings) {
        if (ring->event_fd >= 0) close(ring->event_fd);
        ring->event_fd = -1;
        ring->engine.reset();
      }
    }
    Py_XDECREF(ps->s->cb_decide);
    Py_XDECREF(ps->s->cb_reset);
    Py_XDECREF(ps->s->cb_metrics);
    Py_XDECREF(ps->s->cb_launch);
    Py_XDECREF(ps->s->cb_resolve);
    Py_XDECREF(ps->s->cb_decide_hashed);
    Py_XDECREF(ps->s->cb_launch_hashed);
    Py_XDECREF(ps->s->cb_spans);
    Py_XDECREF(ps->s->cb_dcn);
    Py_XDECREF(ps->s->cb_fleet_map);
    delete ps->s;
  }
  Py_TYPE(self)->tp_free(self);
}

PyMethodDef server_methods[] = {
    {"start", server_start, METH_VARARGS, "start(host, port) -> bound port"},
    {"shutdown", server_shutdown, METH_NOARGS, "graceful drain + stop"},
    {"stats", server_stats, METH_NOARGS,
     "{decisions_total, uptime_s, inflight_depth, ...}"},
    {"set_limits", server_set_limits, METH_VARARGS,
     "set_limits(limit, window_s): refresh the fail-open stamp fields"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PyServerType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyObject* create_server(PyObject* Py_UNUSED(mod), PyObject* args,
                        PyObject* kwargs) {
  static const char* kwlist[] = {"decide",    "reset",        "metrics",
                                 "max_batch", "max_delay_us", "slo_us",
                                 "fail_open", "limit",        "window_s",
                                 "key_prefix", "num_shards",
                                 "launch",    "resolve",      "inflight",
                                 "decide_hashed", "launch_hashed",
                                 "spans",
                                 "shm", "shm_dir", "shm_ring_bytes",
                                 "net_engine", "io_rings",
                                 "dcn", "dcn_auth_required", "max_dcn_conns",
                                 "fleet_map", nullptr};
  PyObject *decide, *reset, *metrics = Py_None;
  PyObject *launch = Py_None, *resolve = Py_None;
  PyObject *decide_hashed = Py_None, *launch_hashed = Py_None;
  PyObject *spans = Py_None, *dcn = Py_None, *fleet_map = Py_None;
  unsigned int max_batch = 4096, max_delay_us = 200, slo_us = 0;
  int fail_open = 0;
  long long limit = 0;
  double window_s = 60.0;
  const char* key_prefix = nullptr;
  Py_ssize_t key_prefix_len = 0;
  unsigned int num_shards = 1, inflight = 8;
  int shm = 0;
  const char* shm_dir = nullptr;
  unsigned int shm_ring_bytes = 0;
  const char* net_engine = nullptr;
  unsigned int io_rings = 0;
  int dcn_auth_required = 0;
  unsigned int max_dcn_conns = 4;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "OO|OIIIpLdy#IOOIOOOpsIsIOpIO",
                                   (char**)kwlist,
                                   &decide, &reset, &metrics, &max_batch,
                                   &max_delay_us, &slo_us, &fail_open, &limit,
                                   &window_s, &key_prefix, &key_prefix_len,
                                   &num_shards, &launch, &resolve,
                                   &inflight, &decide_hashed,
                                   &launch_hashed, &spans, &shm, &shm_dir,
                                   &shm_ring_bytes, &net_engine, &io_rings,
                                   &dcn, &dcn_auth_required,
                                   &max_dcn_conns, &fleet_map))
    return nullptr;
  uint32_t net_engine_req = 0;  // auto
  if (net_engine != nullptr && net_engine[0] != '\0') {
    if (strcmp(net_engine, "auto") == 0) net_engine_req = 0;
    else if (strcmp(net_engine, "epoll") == 0) net_engine_req = 1;
    else if (strcmp(net_engine, "uring") == 0) net_engine_req = 2;
    else {
      PyErr_SetString(PyExc_ValueError,
                      "net_engine must be 'auto', 'epoll' or 'uring'");
      return nullptr;
    }
  }
  if (num_shards < 1 || num_shards > 64) {
    PyErr_SetString(PyExc_ValueError, "num_shards must be in [1, 64]");
    return nullptr;
  }
  if (num_shards > 1 && slo_us > 0) {
    PyErr_SetString(PyExc_ValueError,
                    "dispatch_timeout (SLO) requires num_shards == 1");
    return nullptr;
  }
  PyServer* ps = PyObject_New(PyServer, &PyServerType);
  if (ps == nullptr) return nullptr;
  ps->s = new Server();
  ps->s->max_batch = max_batch;
  ps->s->max_delay_us = max_delay_us;
  ps->s->slo_us = slo_us;
  ps->s->fail_open = fail_open != 0;
  ps->s->limit.store((int64_t)limit);
  ps->s->window_s.store(window_s);
  ps->s->num_shards = num_shards;
  ps->s->inflight_window = inflight < 1 ? 1 : inflight;
  ps->s->shm_enabled = shm != 0;
  if (shm_dir != nullptr && shm_dir[0] != '\0') ps->s->shm_dir = shm_dir;
  ps->s->shm_ring_bytes = shm_ring_bytes;
  ps->s->net_engine_req = net_engine_req;
  ps->s->io_rings = io_rings;
  ps->s->dcn_auth_required = dcn_auth_required != 0;
  ps->s->max_dcn_conns = max_dcn_conns;
  if (key_prefix != nullptr && key_prefix_len > 0)
    ps->s->key_prefix.assign(key_prefix, (size_t)key_prefix_len);
  Py_INCREF(decide);
  Py_INCREF(reset);
  Py_INCREF(metrics);
  Py_INCREF(launch);
  Py_INCREF(resolve);
  Py_INCREF(decide_hashed);
  Py_INCREF(launch_hashed);
  Py_INCREF(spans);
  Py_INCREF(dcn);
  Py_INCREF(fleet_map);
  ps->s->cb_decide = decide;
  ps->s->cb_reset = reset;
  ps->s->cb_metrics = metrics;
  ps->s->cb_launch = launch;
  ps->s->cb_resolve = resolve;
  ps->s->cb_decide_hashed = decide_hashed;
  ps->s->cb_launch_hashed = launch_hashed;
  ps->s->cb_spans = spans;
  ps->s->cb_dcn = dcn;
  ps->s->cb_fleet_map = fleet_map;
  ps->s->dcn_enabled = dcn != Py_None;
  ps->s->hashed_enabled = decide_hashed != Py_None;
  ps->s->spans_enabled = spans != Py_None;
  return (PyObject*)ps;
}

PyMethodDef module_methods[] = {
    {"create_server", (PyCFunction)create_server,
     METH_VARARGS | METH_KEYWORDS,
     "create_server(decide, reset, metrics=None, max_batch=4096, "
     "max_delay_us=200) -> Server"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef server_module = {
    PyModuleDef_HEAD_INIT, "_server",
    "Native multi-ring front door for the rate-limit service", -1,
    module_methods,
};

}  // namespace

extern "C" {

// C ABI probe so the loader can verify the build (native/__init__ pattern).
// The port's own numbering (1), apart from the JAX door's.
int64_t rl_server_abi_version() { return 1; }

PyMODINIT_FUNC PyInit__server(void) {
  PyServerType.tp_name = "ratelimiter_tpu_torch.native._server.Server";
  PyServerType.tp_basicsize = sizeof(PyServer);
  PyServerType.tp_dealloc = server_dealloc;
  PyServerType.tp_flags = Py_TPFLAGS_DEFAULT;
  PyServerType.tp_methods = server_methods;
  if (PyType_Ready(&PyServerType) < 0) return nullptr;
  return PyModule_Create(&server_module);
}

}  // extern "C"
