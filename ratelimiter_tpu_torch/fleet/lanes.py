"""Coalesced columnar peer lanes — the fleet forwarding hot path, a port
of ``ratelimiter_tpu/fleet/lanes.py`` (ADR-019).

A forwarder that proxies mis-routed rows over one blocking connection
per peer, one wire round-trip per inbound frame fragment, drained by a
single FIFO worker, serializes every frame's forward leg behind every
other frame's RTT under mixed fleet traffic (the JAX package's
FLEET_r01: 2-host mixed throughput at 0.34x affine with frame p99 13x
affine). This module is the cross-host twin of the ADR-013 scatter-gather
scheduler: carve, coalesce per destination, pipeline, and reassemble by
row-range views.

One :class:`PeerLane` per peer, each owning ``conns`` pipelined
connections driven from a single background event loop
(:class:`ForwardRuntime`, one daemon thread per :class:`FleetCore`):

* **Coalescing.** Foreign-row fragments from MANY inbound frames queue
  per connection; whenever an in-flight window slot is free the sender
  merges every queued fragment (up to ``coalesce`` rows) into ONE
  ``T_ALLOW_HASHED`` wire frame. There is deliberately no timer: at low
  load a fragment flushes immediately (no added latency), under load
  the window backpressure IS the coalescing window — the same
  slot-availability batching as the micro-batcher's adaptive delay and
  the continuous-batching literature's.
* **Pipelining.** Each connection keeps up to ``inflight`` wire frames
  outstanding (the batcher's bounded in-flight window, one level up), so the
  peer's door coalesces our windows with its direct traffic instead of
  ping-ponging one frame per RTT.
* **Per-key connection affinity.** A row rides connection
  ``h64 % conns``: the same key always takes the same connection, and
  each connection's frames are sent — and decided by the receiver's
  FIFO door — in submit order, so same-key send order survives
  multi-connection links (the cross-host half of the in-batch
  sequencing contract; pinned by tests/test_fleet_forward.py).
* **Zero-copy reassembly.** The coalesced reply parses into ONE
  columnar :class:`BatchResult`; each member fragment's future resolves
  to ``reply.rows(off, count)`` — numpy VIEWS over the reply buffers
  (the ADR-013 seam), no per-row Python objects anywhere on the path.

Failure attribution: one failed wire frame fails exactly its member
fragments' futures (other windows, other connections, other peers are
untouched); the caller degrades those rows per fail-open/closed policy
(forwarder.collect_jobs). Backpressure: at most ``queue_cap`` fragments
may be outstanding per peer beyond the one being written — overflow
raises the typed StorageUnavailableError at submit, never buffers
unbounded.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import itertools
import socket
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np

from ratelimiter_tpu_torch.core.errors import StorageUnavailableError
from ratelimiter_tpu_torch.observability import tracing


class ForwardRuntime:
    """One background event loop driving every peer lane of a FleetCore.
    Lazily started on the first forward; submissions cross threads via
    ``call_soon_threadsafe`` only (all lane state is loop-confined)."""

    def __init__(self, name: str = "rl-fleet-forward"):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._loop.is_closed()

    def call_soon(self, fn, *args) -> None:
        self._loop.call_soon_threadsafe(fn, *args)

    def stop(self) -> None:
        if self._loop.is_closed():
            return

        async def _shutdown() -> None:
            # A few ticks first: lane close already failed the waiting
            # reply futures — let their completion handlers finish
            # naturally before cancelling what remains.
            for _ in range(3):
                await asyncio.sleep(0)
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(
                lambda: self._loop.create_task(_shutdown()))
        except RuntimeError:  # loop already closing
            return
        self._thread.join(timeout=10)
        if not self._thread.is_alive():
            self._loop.close()


class _Frag:
    """One forwarded fragment: a contiguous run of one inbound frame's
    rows bound for one peer connection. ``fut`` resolves to the
    BatchResult row-range VIEW of the coalesced reply. ``trace`` is the
    originating frame's trace id (0 = unsampled): the sender links it
    to the coalesced window's WINDOW-level id so the receiving host's
    spans stitch back to the client frame (ADR-021)."""

    __slots__ = ("ids", "ns", "b", "fut", "trace")

    def __init__(self, ids: np.ndarray, ns: np.ndarray,
                 fut: "concurrent.futures.Future", trace: int = 0):
        self.ids = ids
        self.ns = ns
        self.b = int(ids.shape[0])
        self.fut = fut
        self.trace = trace


class _Call:
    """A scalar/control op riding the lane (allow_n, reset, string-batch
    fallback): sent FIFO with the row fragments on its affinity
    connection, so a key's scalar calls and batch rows stay ordered."""

    __slots__ = ("build", "parse", "fut", "rows")

    def __init__(self, build, parse, fut, rows: int = 1):
        self.build = build      # fn(req_id) -> wire frame bytes
        self.parse = parse      # fn(type_, body) -> result
        self.fut = fut
        self.rows = rows


class _PeerConn:
    """One pipelined connection to a peer: a FIFO work queue (fragments
    + calls), a sender task that coalesces fragment runs under the
    in-flight window, and a reader task matching responses by request
    id. Everything here runs on the forward loop — no locks."""

    def __init__(self, lane: "PeerLane", idx: int):
        self.lane = lane
        self.idx = idx
        self._loop = lane.runtime.loop
        self._work: Deque = collections.deque()
        self._wake = asyncio.Event()
        self._sem = asyncio.Semaphore(lane.inflight)
        self._ids = itertools.count(1)
        self._waiting: Dict[int, asyncio.Future] = {}
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._closed = False
        self._sender = self._loop.create_task(self._run())

    # ------------------------------------------------------------ intake

    def enqueue(self, item) -> None:
        """Loop-side: append work and wake the sender."""
        if self._closed:
            self._fail_item(item, StorageUnavailableError(
                f"fleet forward lane to {self.lane.label} is closed"))
            return
        self._work.append(item)
        self._wake.set()

    # ------------------------------------------------------------ sender

    async def _run(self) -> None:
        while not self._closed:
            if not self._work:
                self._wake.clear()
                await self._wake.wait()
                continue
            await self._sem.acquire()
            if self._closed or not self._work:
                self._sem.release()
                continue
            head = self._work[0]
            if isinstance(head, _Call):
                self._work.popleft()
                await self._send_call(head)
            else:
                # Coalesce: merge every queued fragment (submit order)
                # up to the coalesce cap into ONE wire frame. A lone
                # oversized fragment still sends alone — the receiver's
                # dispatcher carves past max_batch (ADR-013).
                frags = [self._work.popleft()]
                rows = frags[0].b
                while (self._work and isinstance(self._work[0], _Frag)
                       and rows + self._work[0].b <= self.lane.coalesce):
                    f = self._work.popleft()
                    frags.append(f)
                    rows += f.b
                await self._send_window(frags, rows)

    async def _ensure_conn(self) -> None:
        dead = (self._writer is None or self._writer.is_closing()
                or self._reader_task is None or self._reader_task.done())
        if not dead:
            return
        self._drop_conn()
        host, port = self.lane.host, self.lane.port
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(host, port),
            timeout=min(self.lane.deadline, 5.0))
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader_task = self._loop.create_task(self._read_loop())

    def _drop_conn(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            self._writer = None
        for rf in self._waiting.values():
            if not rf.done():
                rf.set_exception(ConnectionError(
                    f"forward connection to {self.lane.label} dropped"))
        self._waiting.clear()

    async def _read_loop(self) -> None:
        from ratelimiter_tpu_torch.serving import protocol as p

        try:
            while True:
                hdr = await self._reader.readexactly(p.HEADER_SIZE)
                length, type_, rid = p.parse_header(hdr)
                body = await self._reader.readexactly(length - 9)
                rf = self._waiting.pop(rid, None)
                if rf is not None and not rf.done():
                    rf.set_result((type_, body))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError, OSError) as exc:
            for rf in self._waiting.values():
                if not rf.done():
                    rf.set_exception(ConnectionError(
                        f"forward connection to {self.lane.label} lost: "
                        f"{exc!r}"))
            self._waiting.clear()

    async def _send_window(self, frags: List[_Frag], rows: int) -> None:
        from ratelimiter_tpu_torch.serving import protocol as p

        lane = self.lane
        req_id = 0
        try:
            await self._ensure_conn()
            req_id = next(self._ids)
            if len(frags) == 1:
                ids, ns = frags[0].ids, frags[0].ns
            else:
                ids = np.concatenate([f.ids for f in frags])
                ns = np.concatenate([f.ns for f in frags])
            frame = p.with_deadline(
                p.encode_allow_hashed(req_id, ids, ns), lane.deadline)
            # Cross-host trace stitching (ADR-021): when the flight
            # recorder is on, the coalesced window gets ONE fresh
            # WINDOW-level trace id on the wire (TRACE_FLAG) — the
            # receiver's io/coalesce/launch/device spans record under
            # it — and each member fragment's client trace id links to
            # it host-side, so the stitcher (fleet/tower.py) can join
            # the hop back to the client frame. Recorder off: no flag,
            # wire bytes unchanged.
            rec = tracing.RECORDER
            wid = 0
            if rec is not None:
                wid = tracing.new_trace_id()
                frame = p.with_trace(frame, wid)
                for f in frags:
                    if f.trace:
                        rec.link(f.trace, wid)
            # FORWARD_FLAG (ADR-019): the receiver dispatches this
            # window standalone — its reply must never wait on the
            # receiver's own forward legs (the cross-host dependency
            # chain behind FLEET_r01's p99). Outermost, after the trace
            # extension.
            frame = p.with_forward(frame)
            rfut = self._loop.create_future()
            self._waiting[req_id] = rfut
            self._writer.write(frame)
            await self._writer.drain()
        except BaseException as exc:  # degrade the members — including
            # on CancelledError (sender cancelled by close mid-send):
            # the frags are already popped from the work queue, so
            # nothing else can ever resolve their futures.
            self._waiting.pop(req_id, None)
            self._fail_frags(frags, exc if isinstance(exc, Exception)
                             else StorageUnavailableError(
                                 f"fleet forward lane to "
                                 f"{lane.label} shut down"))
            self._drop_conn()
            self._sem.release()
            if not isinstance(exc, Exception):
                raise
            return
        # Counted only once actually on the wire (a failed connect /
        # write above must not skew occupancy or the wire totals).
        lane.note_window(len(frags), rows)
        t0 = time.perf_counter()
        self._loop.create_task(
            self._complete_window(req_id, rfut, frags, rows, t0, wid,
                                  tracing.now() if wid else 0))

    async def _complete_window(self, req_id: int, rfut, frags: List[_Frag],
                               rows: int, t0: float, wid: int = 0,
                               t_send_ns: int = 0) -> None:
        from ratelimiter_tpu_torch.serving import protocol as p

        lane = self.lane
        try:
            try:
                type_, body = await asyncio.wait_for(
                    rfut, lane.deadline + 1.0)
            except asyncio.TimeoutError:
                # The reply may still arrive later: this connection is
                # desynchronized for every frame behind it — drop it.
                self._drop_conn()
                raise StorageUnavailableError(
                    f"fleet forward to {lane.label} timed out after "
                    f"{lane.deadline:.1f}s") from None
            if type_ == p.T_ERROR:
                code, msg = p.parse_error(body)
                raise p.exception_for(code, msg)
            if type_ != p.T_RESULT_HASHED:
                self._drop_conn()
                raise p.ProtocolError(
                    f"unexpected forward response type {type_}")
            res = p.parse_result_hashed(body)
            if len(res) != rows:
                self._drop_conn()
                raise p.ProtocolError(
                    f"forward reply carries {len(res)} rows for a "
                    f"{rows}-row window")
            lane.note_rtt(time.perf_counter() - t0)
            if wid:
                rec = tracing.RECORDER
                if rec is not None:
                    # The sender-side wire span of this coalesced
                    # window, under its window-level id — the hop's
                    # envelope on the stitched timeline (ADR-021).
                    rec.record("forward", t_send_ns, tracing.now(),
                               trace_id=wid, batch=rows)
            off = 0
            for f in frags:
                if not f.fut.done():
                    f.fut.set_result(res.rows(off, f.b))
                off += f.b
        except BaseException as exc:  # noqa: BLE001 — degrade the members
            self._fail_frags(frags, exc if isinstance(exc, Exception)
                             else StorageUnavailableError(
                                 f"fleet forward lane to "
                                 f"{lane.label} shut down"))
            if not isinstance(exc, Exception):
                raise
        finally:
            self._waiting.pop(req_id, None)
            self._sem.release()

    async def _send_call(self, call: _Call) -> None:
        req_id = 0
        try:
            await self._ensure_conn()
            req_id = next(self._ids)
            frame = call.build(req_id)
            rfut = self._loop.create_future()
            self._waiting[req_id] = rfut
            self._writer.write(frame)
            await self._writer.drain()
        except BaseException as exc:  # future carries it — including on
            # CancelledError mid-send (see _send_window).
            self._waiting.pop(req_id, None)
            self._fail_item(call, exc if isinstance(exc, Exception)
                            else StorageUnavailableError(
                                f"fleet forward lane to "
                                f"{self.lane.label} shut down"))
            self._drop_conn()
            self._sem.release()
            if not isinstance(exc, Exception):
                raise
            return
        t0 = time.perf_counter()
        self._loop.create_task(self._complete_call(req_id, rfut, call, t0))

    async def _complete_call(self, req_id: int, rfut, call: _Call,
                             t0: float) -> None:
        from ratelimiter_tpu_torch.serving import protocol as p

        lane = self.lane
        try:
            try:
                type_, body = await asyncio.wait_for(
                    rfut, lane.deadline + 1.0)
            except asyncio.TimeoutError:
                self._drop_conn()
                raise StorageUnavailableError(
                    f"fleet forward to {lane.label} timed out after "
                    f"{lane.deadline:.1f}s") from None
            if type_ == p.T_ERROR:
                code, msg = p.parse_error(body)
                raise p.exception_for(code, msg)
            lane.note_rtt(time.perf_counter() - t0)
            out = call.parse(type_, body)
            if not call.fut.done():
                call.fut.set_result(out)
        except BaseException as exc:  # noqa: BLE001 — future carries it
            self._fail_item(call, exc if isinstance(exc, Exception)
                            else StorageUnavailableError(
                                f"fleet forward lane to "
                                f"{lane.label} shut down"))
            if not isinstance(exc, Exception):
                raise
        finally:
            self._waiting.pop(req_id, None)
            self._sem.release()

    # ------------------------------------------------------------ teardown

    def _fail_frags(self, frags: List[_Frag], exc: BaseException) -> None:
        for f in frags:
            if not f.fut.done():
                f.fut.set_exception(exc)

    @staticmethod
    def _fail_item(item, exc: BaseException) -> None:
        if not item.fut.done():
            item.fut.set_exception(exc)

    def close(self) -> None:
        """Loop-side: stop the sender, drop the socket, fail all work."""
        self._closed = True
        self._wake.set()
        self._sender.cancel()
        exc = StorageUnavailableError(
            f"fleet forward lane to {self.lane.label} is closed")
        while self._work:
            self._fail_item(self._work.popleft(), exc)
        self._drop_conn()


class PeerLane:
    """All forwarding to ONE peer: ``conns`` pipelined connections with
    per-key affinity, a shared outstanding-fragment bound, and the
    per-peer coalescing/occupancy metrics. Thread-safe submit surface;
    connection state is confined to the forward loop."""

    def __init__(self, runtime: ForwardRuntime, host: str, port: int, *,
                 label: str, deadline: float, inflight: int, conns: int,
                 coalesce: int, queue_cap: int, metrics=None):
        self.runtime = runtime
        self.host, self.port = host, port
        self.label = label
        self.deadline = float(deadline)
        self.inflight = max(1, int(inflight))
        self.conns = max(1, int(conns))
        self.coalesce = max(1, int(coalesce))
        self.queue_cap = int(queue_cap)
        self._metrics = metrics  # LaneMetrics (forwarder.py) or None
        self._lock = threading.Lock()
        self._outstanding = 0
        self._closed = False
        self._conns: List[Optional[_PeerConn]] = [None] * self.conns
        # Lifetime wire-frame/row counters (status surface; the metric
        # registry counters are the operational view).
        self.wire_frames = 0
        self.wire_rows = 0

    # ------------------------------------------------------------ submit

    def _admit(self, fut: "concurrent.futures.Future") -> None:
        with self._lock:
            if self._closed or not self.runtime.alive:
                raise StorageUnavailableError(
                    f"fleet forward lane to {self.label} is closed")
            if self._outstanding > self.queue_cap:
                raise StorageUnavailableError(
                    f"fleet forward queue to {self.host}:{self.port} is "
                    f"full ({self.queue_cap} fragments) — peer slow or "
                    f"dead")
            self._outstanding += 1
        fut.add_done_callback(self._release)

    def _release(self, _fut) -> None:
        with self._lock:
            self._outstanding -= 1

    def _dispatch(self, conn_idx: int, item) -> None:
        self.runtime.call_soon(self._loop_enqueue, conn_idx, item)

    def _loop_enqueue(self, conn_idx: int, item) -> None:
        conn = self._conns[conn_idx]
        if conn is None:
            if self._closed:
                _PeerConn._fail_item(item, StorageUnavailableError(
                    f"fleet forward lane to {self.label} is closed"))
                return
            conn = _PeerConn(self, conn_idx)
            self._conns[conn_idx] = conn
        conn.enqueue(item)

    def conn_of(self, h64: np.ndarray) -> np.ndarray:
        """Per-key connection affinity: same finalized hash, same
        connection — always, across frames and lanes — so same-key send
        order survives the multi-connection link."""
        return (np.asarray(h64, np.uint64)
                % np.uint64(self.conns)).astype(np.int64)

    def submit_rows(self, ids: np.ndarray, ns: np.ndarray,
                    conn_idx: int = 0, *,
                    trace: int = 0) -> "concurrent.futures.Future":
        """Queue one columnar fragment (raw u64 ids + ns) on a
        connection; resolves to the BatchResult row-range view of the
        coalesced reply. ``trace`` is the originating frame's trace id
        — linked to the window-level wire id at send (ADR-021)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._admit(fut)
        self._dispatch(int(conn_idx), _Frag(
            np.ascontiguousarray(ids, dtype=np.uint64),
            np.ascontiguousarray(ns, dtype=np.uint32), fut, trace))
        return fut

    def submit_call(self, build, parse, conn_idx: int = 0,
                    rows: int = 1) -> "concurrent.futures.Future":
        """Queue a scalar/control op (FIFO with the fragments on its
        connection: the op acts as a window boundary)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._admit(fut)
        self._dispatch(int(conn_idx), _Call(build, parse, fut, rows))
        return fut

    # ----------------------------------------------------------- metrics

    def note_window(self, frames: int, rows: int) -> None:
        self.wire_frames += 1
        self.wire_rows += rows
        m = self._metrics
        if m is not None:
            m.window(self.label, frames, rows)

    def note_rtt(self, seconds: float) -> None:
        m = self._metrics
        if m is not None:
            m.rtt(seconds)

    # ------------------------------------------------------------- close

    def close(self) -> None:
        with self._lock:
            self._closed = True
        if not self.runtime.alive:
            return

        def _close_all() -> None:
            for conn in self._conns:
                if conn is not None:
                    conn.close()

        self.runtime.call_soon(_close_all)
