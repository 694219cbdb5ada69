"""Shared-memory SPSC wire lane (ADR-025): Python side of the zero-syscall
same-host transport, a copy of ``ratelimiter_tpu/serving/shm.py``.

This module mirrors — byte for byte — the layout defined in
``ratelimiter_tpu_torch/native/shm_ring.h`` (the C++ single source of
truth, included by both the native door and the C++ load generator; the
same layout as the JAX package's, so either package's client speaks to
either package's door).  One mapping per
connection carries a request ring (client -> server) and a reply ring
(server -> client); records hold UNMODIFIED wire frames exactly as they
would appear on a TCP socket, so every parser, the audit tap and the
flight recorder work unchanged and the bit-identical pins in
tests/test_torch_shm.py can diff shm decisions against TCP decisions at
the byte level.

Layout (little-endian, offsets in bytes):

* file header @0 (256 B): ``<QIIIIQQQQ`` =
  magic "RLTPSHM1" | version | header_bytes | req_capacity |
  rep_capacity | req_ctrl_off | rep_ctrl_off | req_data_off |
  rep_data_off
* ring ctrl (128 B = two cache lines): consumer line ``u64 head`` +
  ``u32 consumer_sleeping``; producer line at +64 ``u64 tail`` +
  ``u32 producer_waiting``.  head/tail are MONOTONIC byte positions,
  slot index is ``pos & (capacity - 1)``.
* record: 8-byte header ``u32 size | u32 commit`` + payload + pad to 8.
  ``commit == size ^ 0x52494E47`` ("RING") marks committed data;
  ``commit == 0xFFFFFFFF`` marks a wrap pad (skip ``8 + size``); any
  other value is torn/corrupt and poisons the lane — the consumer stops
  trusting the mapping and reclaims via the control socket.

Publication order: payload, then commit word, then tail.  A producer
killed mid-record leaves tail unmoved, so the torn bytes are never
observed (kill -9 chaos test).  The commit word self-checks against the
size field as second-line defence against corruption.

Memory-model note: CPython has no release/acquire intrinsics for mmap
stores.  We rely on (a) x86-64 TSO — stores from one process become
visible to another in program order — and (b) the CPython eval loop
acting as a compiler barrier between bytecodes, the same assumptions
the mmap-backed WAL makes.  The 8-byte head/tail words (and the 4-byte
flags) are read and written through memoryview casts of the ctrl block:
an item access is one aligned memcpy of its width, a single load or
store, so the other process sees each position whole.  ``struct``'s
``pack_into``/``unpack_from`` move the bytes one at a time, so a reader
racing them can see a torn position (C17: a head or tail read as 0 or
as a mix of two values, after which the C++ client read past the
published tail and spun in its pop).  TSO does NOT order a store before a later
load, and the doorbell is a Dekker pair: the producer stores ``tail``
then loads ``consumer_sleeping``, the consumer stores
``consumer_sleeping`` then loads ``tail`` (and likewise ``head`` against
``producer_waiting``).  Both sides need a full fence between the two,
so every flag read and every arming store here goes through ``_fence``
(an uncontended lock round trip: a locked instruction), as
``native/shm_ring.h`` does with ``std::atomic_thread_fence``.

A peer that does not fence (an older client) can still lose a wake, so
the door never trusts the doorbell alone: ``ServerLane.recheck`` runs on
a ``RECHECK_S`` timer and drains what a lost ding left in the request
ring or in the reply overflow.  A lost wake costs at most that period,
never a stall.

Doorbell: bounded spin, then eventfd.  Each lane owns two eventfds —
``efd_server`` (read by the server, written by the client) and
``efd_client`` (the reverse).  A producer dings the consumer's eventfd
only when the consumer has advertised ``consumer_sleeping``; a consumer
that frees space dings the producer's eventfd only when
``producer_waiting`` is set.  Steady-state traffic makes zero syscalls.

Negotiation rides the normal socket (T_SHM_HELLO / T_SHM_HELLO_R under
the door's existing auth); the socket then stays open as the
control/liveness channel so a client crash or hangup reclaims the rings
deterministically.  The eventfd pair travels over a one-shot unix
control socket via SCM_RIGHTS; both the control socket path and the
/dev/shm file are unlinked as soon as the handshake completes, so
nothing leaks on crash.
"""

from __future__ import annotations

import mmap
import os
import select
import socket
import struct
import threading
import time

from ratelimiter_tpu_torch.core.errors import (
    RateLimiterError,
    StorageUnavailableError,
)

# ---------------------------------------------------------------------------
# Layout constants — MUST match native/shm_ring.h.
# ---------------------------------------------------------------------------

MAGIC = 0x314D485350544C52  # "RLTPSHM1" little-endian
VERSION = 1
FILE_HEADER_BYTES = 256
CTRL_BYTES = 128
COMMIT_XOR = 0x52494E47  # "RING"
COMMIT_WRAP = 0xFFFFFFFF
MIN_RING = 1 << 16
MAX_RING = 1 << 26
DEFAULT_RING = 1 << 21  # 2 MiB per direction

_FILE_HDR = struct.Struct("<QIIIIQQQQ")
_REC_HDR = struct.Struct("<II")

# Bounded spin before arming the doorbell.  Python iterations are ~100x
# costlier than the C++ loop's, so the count is much smaller for a
# similar wall-clock budget.
SPIN_ITERS = 200

#: Period of the door's lost-wake recheck (``ServerLane.recheck``): the
#: most a doorbell lost by either side delays a lane.
RECHECK_S = 0.005

_FENCE_LOCK = threading.Lock()


def _fence() -> None:
    """A full memory fence: the uncontended lock round trip executes a
    locked read-modify-write, which orders every earlier store before
    every later load."""
    with _FENCE_LOCK:
        pass


class RingFullError(StorageUnavailableError):
    """The shm request ring stayed full past the backpressure deadline.

    Subclasses StorageUnavailableError so existing retry/fail-open
    policies treat it as transient server pressure — never a silent
    drop.
    """


class ShmProtocolError(RateLimiterError):
    """Torn/corrupt ring record or bad mapping — the lane is poisoned."""


def align8(n: int) -> int:
    return (n + 7) & ~7


def clamp_ring_bytes(n: int) -> int:
    """Clamp a requested ring size to a power of two in [MIN, MAX]."""
    if n <= 0:
        return DEFAULT_RING
    n = max(MIN_RING, min(MAX_RING, n))
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


def total_bytes(req_cap: int, rep_cap: int) -> int:
    return FILE_HEADER_BYTES + 2 * CTRL_BYTES + req_cap + rep_cap


# ---------------------------------------------------------------------------
# Ring
# ---------------------------------------------------------------------------


def _word(mm, off: int, fmt: str) -> int:
    """The ctrl word at ``off`` (``fmt`` "Q" or "I"), read with one
    aligned load: a memoryview cast's item is one memcpy of its width.
    ``struct.unpack_from`` reads the bytes one at a time, so it could
    see a word the other process is storing half old, half new (C17).
    The views live for the call alone, so the mapping stays closable."""
    size = 8 if fmt == "Q" else 4
    return memoryview(mm)[off:off + size].cast(fmt)[0]


def _set_word(mm, off: int, fmt: str, v: int) -> None:
    """Store the ctrl word at ``off`` with one aligned store (as
    ``_word`` reads it; ``struct.pack_into`` writes byte by byte)."""
    size = 8 if fmt == "Q" else 4
    memoryview(mm)[off:off + size].cast(fmt)[0] = v


class ShmRing:
    """One direction of the lane over a shared mmap.

    The same class serves producer and consumer roles; each process only
    ever calls one side's methods on a given ring (SPSC).
    """

    __slots__ = ("_mm", "_ctrl", "_data", "cap", "_mask", "highwater")

    def __init__(self, mm: mmap.mmap, ctrl_off: int, data_off: int, cap: int):
        self._mm = mm
        self._ctrl = ctrl_off
        self._data = data_off
        self.cap = cap
        self._mask = cap - 1
        self.highwater = 0

    # ctrl-word accessors (offsets per shm_ring.h RingCtrl: head @0,
    # consumer_sleeping @8, tail @64, producer_waiting @72), each one
    # aligned load or store (_word, _set_word).
    def _head(self) -> int:
        return _word(self._mm, self._ctrl, "Q")

    def _set_head(self, v: int) -> None:
        _set_word(self._mm, self._ctrl, "Q", v)

    def _tail(self) -> int:
        return _word(self._mm, self._ctrl + 64, "Q")

    def _set_tail(self, v: int) -> None:
        _set_word(self._mm, self._ctrl + 64, "Q", v)

    # The flag reads follow a publish (tail or head) and the arming
    # stores precede a recheck of the ring: both halves of the Dekker
    # pair are fenced (module docstring).
    def consumer_sleeping(self) -> bool:
        _fence()
        return _word(self._mm, self._ctrl + 8, "I") != 0

    def set_sleeping(self, flag: bool) -> None:
        _set_word(self._mm, self._ctrl + 8, "I", 1 if flag else 0)
        if flag:
            _fence()

    def producer_waiting(self) -> bool:
        _fence()
        return _word(self._mm, self._ctrl + 72, "I") != 0

    def set_producer_waiting(self, flag: bool) -> None:
        _set_word(self._mm, self._ctrl + 72, "I", 1 if flag else 0)
        if flag:
            _fence()

    def used(self) -> int:
        return self._tail() - self._head()

    def empty(self) -> bool:
        return self._head() == self._tail()

    # -- producer side ------------------------------------------------------

    def try_push(self, frame: bytes) -> bool:
        """Append one wire frame as a committed record; False = no space."""
        size = len(frame)
        need = 8 + align8(size)
        tail = self._tail()
        head = self._head()
        free_b = self.cap - (tail - head)
        off = tail & self._mask
        to_end = self.cap - off
        total = need + (to_end if need > to_end else 0)
        if total > free_b:
            return False
        if need > to_end:
            # Wrap pad so the payload stays contiguous.
            _REC_HDR.pack_into(
                self._mm, self._data + off, to_end - 8, COMMIT_WRAP
            )
            tail += to_end
            off = 0
        base = self._data + off
        self._mm[base + 8 : base + 8 + size] = frame
        # Commit word AFTER the payload (TSO keeps the order), tail last.
        _REC_HDR.pack_into(self._mm, base, size, size ^ COMMIT_XOR)
        self._set_tail(tail + need)
        used = tail + need - head
        if used > self.highwater:
            self.highwater = used
        return True

    # -- consumer side ------------------------------------------------------

    def pop(self) -> bytes | None:
        """Return the next committed frame (copied out), or None if empty.

        Raises ShmProtocolError on a torn/poisoned record.  The copy is
        the lane's single memcpy into staging: downstream parsers
        (np.frombuffer in parse_allow_hashed etc.) view the returned
        bytes zero-copy, same contract as the TCP recv buffer.
        """
        while True:
            head = self._head()
            tail = self._tail()
            if head == tail:
                return None
            off = head & self._mask
            base = self._data + off
            size, commit = _REC_HDR.unpack_from(self._mm, base)
            if commit == COMMIT_WRAP:
                if 8 + size > self.cap:
                    raise ShmProtocolError("shm ring: bad wrap pad")
                self._set_head(head + 8 + size)
                continue
            if commit != (size ^ COMMIT_XOR) or 8 + align8(size) > self.cap:
                raise ShmProtocolError(
                    "shm ring: torn or corrupt record (size=%d commit=0x%x)"
                    % (size, commit)
                )
            frame = bytes(self._mm[base + 8 : base + 8 + size])
            self._set_head(head + 8 + align8(size))
            return frame


# ---------------------------------------------------------------------------
# File creation / attach
# ---------------------------------------------------------------------------


def create_lane_file(
    shm_dir: str, req_cap: int, rep_cap: int, tag: str = ""
) -> tuple[str, int]:
    """Create + size the per-connection shm file (0600, O_EXCL).

    Returns (path, fd).  The caller mmaps the fd and later unlinks the
    path the moment the peer has it open.
    """
    for attempt in range(64):
        path = os.path.join(
            shm_dir,
            "rltpu-shm-%d-%s%d" % (os.getpid(), tag, attempt),
        )
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        except FileExistsError:
            continue
        os.ftruncate(fd, total_bytes(req_cap, rep_cap))
        return path, fd
    raise OSError("could not allocate shm lane file in %s" % shm_dir)


def init_header(mm: mmap.mmap, req_cap: int, rep_cap: int) -> None:
    req_data = FILE_HEADER_BYTES + 2 * CTRL_BYTES
    _FILE_HDR.pack_into(
        mm,
        0,
        MAGIC,
        VERSION,
        FILE_HEADER_BYTES,
        req_cap,
        rep_cap,
        FILE_HEADER_BYTES,
        FILE_HEADER_BYTES + CTRL_BYTES,
        req_data,
        req_data + req_cap,
    )


def attach(mm: mmap.mmap, server: bool) -> tuple[ShmRing, ShmRing]:
    """Attach (inbound, outbound) rings for this side of the lane."""
    (
        magic,
        version,
        _hdr,
        req_cap,
        rep_cap,
        req_ctrl,
        rep_ctrl,
        req_data,
        rep_data,
    ) = _FILE_HDR.unpack_from(mm, 0)
    if magic != MAGIC or version != VERSION:
        raise ShmProtocolError("shm lane: bad magic/version")
    if req_cap & (req_cap - 1) or rep_cap & (rep_cap - 1):
        raise ShmProtocolError("shm lane: non-power-of-two capacity")
    req = ShmRing(mm, req_ctrl, req_data, req_cap)
    rep = ShmRing(mm, rep_ctrl, rep_data, rep_cap)
    return (req, rep) if server else (rep, req)


def _eventfd() -> int:
    fd = os.eventfd(0, os.EFD_NONBLOCK)
    return fd


def _drain_eventfd(fd: int) -> None:
    try:
        os.eventfd_read(fd)
    except BlockingIOError:
        pass


def _ding(fd: int) -> None:
    try:
        os.eventfd_write(fd, 1)
    except (BlockingIOError, OSError):
        pass


# ---------------------------------------------------------------------------
# Lane stats (shared by both roles; scrape-time reads only)
# ---------------------------------------------------------------------------


class LaneStats:
    __slots__ = (
        "doorbell_wakes",
        "spin_hits",
        "ring_full_stalls",
        "records_in",
        "records_out",
        "recheck_hits",
    )

    def __init__(self) -> None:
        self.doorbell_wakes = 0
        self.spin_hits = 0
        self.ring_full_stalls = 0
        self.records_in = 0
        self.records_out = 0
        #: Rechecks that found work a lost doorbell had left behind (the
        #: door's own count; not one of the JAX door's gauges).
        self.recheck_hits = 0


# ---------------------------------------------------------------------------
# Server side (asyncio door)
# ---------------------------------------------------------------------------


class ServerLane:
    """Server half of one shm connection, driven by the asyncio door.

    Built on T_SHM_HELLO: creates the file + eventfds + one-shot unix
    control listener, then (after the client's control connect) passes
    the eventfd pair via SCM_RIGHTS and unlinks everything.  The asyncio
    door registers ``efd_server`` with ``loop.add_reader``; records
    drain on the loop thread straight into the MicroBatcher staging
    submit paths (the loop thread IS the staging thread for that door).
    """

    def __init__(self, shm_dir: str, req_cap: int, rep_cap: int, tag: str = ""):
        self.req_cap = req_cap
        self.rep_cap = rep_cap
        self.path, self._fd = create_lane_file(shm_dir, req_cap, rep_cap, tag)
        self.ctrl_path = self.path + ".ctrl"
        self.mm = mmap.mmap(self._fd, total_bytes(req_cap, rep_cap))
        init_header(self.mm, req_cap, rep_cap)
        self.inbound, self.outbound = attach(self.mm, server=True)
        self.efd_server = _eventfd()
        self.efd_client = _eventfd()
        self.ctrl_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(self.ctrl_path)
        except FileNotFoundError:
            pass
        self.ctrl_sock.bind(self.ctrl_path)
        os.chmod(self.ctrl_path, 0o600)
        self.ctrl_sock.listen(1)
        self.ctrl_sock.setblocking(False)
        self.stats = LaneStats()
        self.overflow: list[bytes] = []
        self.overflow_bytes = 0
        self.handshaken = False
        self.closed = False
        self.req_highwater = 0
        # Armed from birth: the client's very first push must ding the
        # doorbell (the drain loop re-arms after each empty spin).
        self.inbound.set_sleeping(True)

    def complete_handshake(self, conn: socket.socket) -> None:
        """Ship the eventfd pair over the accepted control socket, then
        unlink the filesystem artifacts (the peer holds them open)."""
        socket.send_fds(conn, [b"x"], [self.efd_server, self.efd_client])
        conn.close()
        self.ctrl_sock.close()
        for p in (self.ctrl_path, self.path):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        self.handshaken = True

    def send(self, frame: bytes) -> bool:
        """Producer path for all replies (including rid=0 revoke pushes).

        Ring-full spills to a bounded overflow list flushed on the next
        doorbell; returns False when the peer is so far behind that the
        slow-reader cut should fire (mirrors WRITE_BUFFER_LIMIT).
        """
        if self.closed:
            return False
        if self.overflow or not self.outbound.try_push(frame):
            self.overflow.append(frame)
            self.overflow_bytes += len(frame)
            self.outbound.set_producer_waiting(True)
            self.flush_overflow()
            if self.overflow_bytes > 8 * 1024 * 1024:
                return False
        else:
            self.stats.records_out += 1
        if self.outbound.consumer_sleeping():
            _ding(self.efd_client)
        return True

    def flush_overflow(self) -> None:
        while self.overflow:
            if not self.outbound.try_push(self.overflow[0]):
                self.outbound.set_producer_waiting(True)
                return
            f = self.overflow.pop(0)
            self.overflow_bytes -= len(f)
            self.stats.records_out += 1
        self.outbound.set_producer_waiting(False)
        if self.outbound.consumer_sleeping():
            _ding(self.efd_client)

    def drain(self, handle_frame) -> None:
        """Pop every committed request record and hand it to the door's
        frame dispatcher.  Runs on the event-loop thread (add_reader
        callback for efd_server).

        The consumer-sleeping flag is cleared for the whole drain — a
        pipelining client sees it down and skips the eventfd syscall —
        then re-armed after a bounded empty spin, with a missed-wake
        recheck after the re-arm (a push that raced the flag store is
        picked up here, not lost)."""
        _drain_eventfd(self.efd_server)
        self.stats.doorbell_wakes += 1
        self._serve(handle_frame)

    def recheck(self, handle_frame) -> bool:
        """The lost-wake backstop, run on the door's ``RECHECK_S`` timer
        on the loop thread: request records waiting with no doorbell
        rung, or reply overflow whose space-freed wake never came, are
        served as a doorbell would have served them. Returns whether it
        found work."""
        if self.closed or not (self.overflow or not self.inbound.empty()):
            return False
        self.stats.recheck_hits += 1
        self._serve(handle_frame)
        return True

    def _serve(self, handle_frame) -> None:
        ring = self.inbound
        used = ring.used()
        if used > self.req_highwater:
            self.req_highwater = used
        ring.set_sleeping(False)
        self.flush_overflow()
        while True:
            frame = ring.pop()
            if frame is None:
                for _ in range(SPIN_ITERS):
                    frame = ring.pop()
                    if frame is not None:
                        self.stats.spin_hits += 1
                        break
            if frame is None:
                ring.set_sleeping(True)
                frame = ring.pop()
                if frame is None:
                    break
                ring.set_sleeping(False)
            self.stats.records_in += 1
            handle_frame(frame)
        if ring.producer_waiting():
            ring.set_producer_waiting(False)
            _ding(self.efd_client)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for p in (self.ctrl_path, self.path):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        try:
            self.ctrl_sock.close()
        except OSError:
            pass
        for fd in (self.efd_server, self.efd_client):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass
        try:
            os.close(self._fd)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------


class ClientLane:
    """Client half of one shm connection (used by Client/AsyncClient).

    The caller completes the T_SHM_HELLO exchange on the normal socket
    first; this class then maps the announced file, connects the
    control socket, and receives the eventfd pair.  Mapping happens
    BEFORE the control connect — the server unlinks both paths the
    moment it accepts, so this order is what keeps the /dev/shm
    namespace clean without a race.
    """

    def __init__(self, shm_path: str, ctrl_path: str):
        fd = os.open(shm_path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.inbound, self.outbound = attach(self.mm, server=False)
        ctrl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            ctrl.settimeout(5.0)
            ctrl.connect(ctrl_path)
            _msg, fds, _flags, _addr = socket.recv_fds(ctrl, 1, 2)
            if len(fds) != 2:
                raise ShmProtocolError("shm handshake: expected 2 eventfds")
            self.efd_server, self.efd_client = fds
        finally:
            ctrl.close()
        os.set_blocking(self.efd_client, False)
        self.stats = LaneStats()
        self.closed = False

    # -- producer (requests) ------------------------------------------------

    def send_frame(self, frame: bytes, timeout: float = 5.0) -> None:
        """Push one request frame; RingFullError after `timeout` of
        sustained backpressure (never a silent drop)."""
        ring = self.outbound
        if ring.try_push(frame):
            self.stats.records_out += 1
            if ring.consumer_sleeping():
                _ding(self.efd_server)
            return
        self.stats.ring_full_stalls += 1
        deadline = time.monotonic() + timeout
        while True:
            for _ in range(SPIN_ITERS):
                if ring.try_push(frame):
                    self.stats.records_out += 1
                    if ring.consumer_sleeping():
                        _ding(self.efd_server)
                    return
            ring.set_producer_waiting(True)
            if ring.try_push(frame):
                ring.set_producer_waiting(False)
                self.stats.records_out += 1
                if ring.consumer_sleeping():
                    _ding(self.efd_server)
                return
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise RingFullError(
                    "shm request ring full for %.1fs (%d bytes queued)"
                    % (timeout, ring.used())
                )
            select.select([self.efd_client], [], [], min(remain, 0.05))
            _drain_eventfd(self.efd_client)

    # -- consumer (replies) -------------------------------------------------

    def recv_frame(self, timeout: float | None = 5.0) -> bytes | None:
        """Pop the next reply frame, honouring the spin-then-eventfd
        doorbell.  None on timeout."""
        ring = self.inbound
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for _ in range(SPIN_ITERS):
                frame = ring.pop()
                if frame is not None:
                    self.stats.spin_hits += 1
                    self._after_pop(ring)
                    return frame
            ring.set_sleeping(True)
            frame = ring.pop()
            if frame is not None:
                ring.set_sleeping(False)
                self._after_pop(ring)
                return frame
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    ring.set_sleeping(False)
                    return None
                wait = min(remain, 0.05)
            else:
                wait = 0.05
            r, _w, _x = select.select([self.efd_client], [], [], wait)
            ring.set_sleeping(False)
            if r:
                _drain_eventfd(self.efd_client)
                self.stats.doorbell_wakes += 1

    def _after_pop(self, ring: ShmRing) -> None:
        self.stats.records_in += 1
        if ring.producer_waiting():
            ring.set_producer_waiting(False)
            _ding(self.efd_server)

    def try_recv(self) -> bytes | None:
        """Non-blocking pop (AsyncClient add_reader drain path)."""
        frame = self.inbound.pop()
        if frame is not None:
            self._after_pop(self.inbound)
        return frame

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for fd in (self.efd_server, self.efd_client):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass
