"""Clients for the rate-limit service: the port's copy of
``ratelimiter_tpu/serving/client.py`` (``Client`` and ``AsyncClient``),
over the binary protocol (serving/protocol.py), TCP, a unix socket or the
shared-memory lane, against either of the port's doors (or the JAX
package's: the frames and the ring layout are the same):

* ``Client`` — blocking, one outstanding request per call; the simple
  integration surface (HTTP-middleware style usage, ``docs/EXAMPLES.md``).
* ``AsyncClient`` — pipelined: many in-flight requests per connection,
  matched by request id. This is what makes the micro-batcher's coalescing
  reachable from a single process, and what the e2e benchmark drives.

Both re-raise server-side errors as the same exception types the library
raises locally (core/errors.py), so "local limiter" and "remote limiter"
are drop-in interchangeable.

Resilience (ADR-015):

* **Separate connect vs per-call read timeouts.** ``Client``'s connect
  ``timeout`` used to become the permanent socket timeout; now
  ``connect_timeout`` bounds connection establishment and
  ``call_timeout`` bounds each call's reads.
* **Typed mid-stream timeouts.** A read timing out mid-call raises
  :class:`~ratelimiter_tpu_torch.core.errors.RequestTimeoutError` naming the
  pending request, and marks the connection DESYNCHRONIZED — the next
  call reconnects instead of reading the stale frame as its own result.
* **Bounded retries with exponential backoff + full jitter.** Connection
  errors (refused/reset/closed) retry up to ``retries`` times with
  ``sleep = random() * min(backoff_max, backoff * 2**attempt)`` and an
  automatic reconnect. Mid-stream timeouts are NEVER auto-retried: the
  server may have applied the decision, and a blind retry double-spends
  quota — the typed error hands that call to the caller's policy.
* **Per-call deadlines.** ``deadline=`` (seconds of budget) on the
  decision calls bounds the whole call INCLUDING retries, and rides the
  wire as the protocol's deadline extension so the server sheds the
  work if the budget expires in its queue (answering per its
  fail-open/fail-closed policy).

Quota leases, as in the JAX clients: ``enable_leases()`` turns on the
client-embedded tier (leases/): a key holding a live lease with budget
answers ``allow``/``allow_n`` from a local counter without the wire,
hot keys are asked for in the background (``Client`` through a
``LeaseDriver`` thread on its own connection, to ``lease_port`` on the
native door's sidecar; ``AsyncClient`` pipelined on its own connection),
and rid-0 LEASE_REVOKE pushes drop the leases they name in both read
loops. The JAX package's ``FleetClient`` is not ported (ROADMAP A13d).
"""

from __future__ import annotations

import asyncio
import itertools
import random
import socket
import threading
import time
from typing import Dict, Optional, Sequence

from ratelimiter_tpu_torch.core.errors import (
    DeadlineExceededError,
    RequestTimeoutError,
)
from ratelimiter_tpu_torch.core.types import Result
from ratelimiter_tpu_torch.serving import protocol as p
from ratelimiter_tpu_torch.serving import shm as shm_lane


def _jitter_delay(attempt: int, backoff: float, backoff_max: float) -> float:
    """Full-jitter exponential backoff (AWS architecture blog shape):
    uniform in [0, min(backoff_max, backoff * 2**attempt)] — decorrelates
    a thundering herd of reconnecting clients."""
    return random.random() * min(backoff_max, backoff * (2.0 ** attempt))


def _stamp(frame: bytes, trace_id: int, budget_s: Optional[float]) -> bytes:
    """Apply the frame extensions in canonical order: deadline first
    (innermost), trace id last (outermost on the wire)."""
    if budget_s is not None:
        frame = p.with_deadline(frame, max(0.0, budget_s))
    if trace_id:
        frame = p.with_trace(frame, trace_id)
    return frame


class Client:
    """Blocking client, thread-safe (a lock serializes request/response).

    Args:
        host/port: server address.
        timeout: legacy single knob — default for BOTH connect_timeout
            and call_timeout when they are not given.
        connect_timeout: bound on connection establishment (connect +
            reconnects), seconds.
        call_timeout: bound on each call's socket reads, seconds. A
            breach raises RequestTimeoutError (typed, names the pending
            request) and desynchronizes the connection — the next call
            reconnects.
        retries: connection-error retries per call (0 disables).
        backoff/backoff_max: exponential backoff base/cap, seconds;
            actual sleeps are full-jitter uniform draws.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = 10.0, *,
                 connect_timeout: Optional[float] = None,
                 call_timeout: Optional[float] = None,
                 retries: int = 2, backoff: float = 0.05,
                 backoff_max: float = 2.0,
                 transport: str = "tcp",
                 shm_ring_bytes: int = 0):
        """``transport`` selects the wire (ADR-025 ladder): "tcp"
        (default), "uds" (``host`` is ``unix:/path``, or pass the bare
        path), or "shm" — connect normally (tcp or uds per the host
        string), then upgrade via T_SHM_HELLO to per-connection shared
        rings; the socket stays open as the liveness channel. A ``host``
        beginning ``unix:`` implies uds even when transport is "tcp"."""
        self._host, self._port = host, port
        if transport not in ("tcp", "uds", "shm"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "uds" and not host.startswith("unix:"):
            host = "unix:" + host
            self._host = host
        self._transport = transport
        self._shm_ring_bytes = int(shm_ring_bytes)
        self._lane: Optional[shm_lane.ClientLane] = None
        self._connect_timeout = (connect_timeout if connect_timeout
                                 is not None else timeout)
        self._call_timeout = (call_timeout if call_timeout is not None
                              else timeout)
        self.retries = int(retries)
        self._backoff = float(backoff)
        self._backoff_max = float(backoff_max)
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._desynced = False
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._lease_cache = None
        self._lease_driver = None
        self._connect_locked()

    # ------------------------------------------------------------ plumbing

    def _connect_locked(self) -> None:
        if self._host.startswith("unix:"):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(self._connect_timeout)
            self._sock.connect(self._host[len("unix:"):])
        else:
            self._sock = socket.create_connection(
                (self._host, self._port), timeout=self._connect_timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        # Per-call READ timeout, deliberately not the connect timeout.
        self._sock.settimeout(self._call_timeout)
        self._buf = b""
        self._desynced = False
        if self._transport == "shm":
            self._upgrade_shm_locked()

    def _upgrade_shm_locked(self) -> None:
        """T_SHM_HELLO on the fresh socket (ADR-025): the reply names a
        /dev/shm file + control socket; map the file FIRST, then collect
        the eventfd pair (the server unlinks both paths on accept)."""
        req_id = next(self._ids)
        self._sock.sendall(p.encode_shm_hello(
            req_id, self._shm_ring_bytes, self._shm_ring_bytes))
        hdr = self._recv_exact(p.HEADER_SIZE, None, req_id,
                               p.T_SHM_HELLO)
        length, type_, rid = p.parse_header(hdr)
        body = self._recv_exact(length - 9, None, req_id, p.T_SHM_HELLO)
        if type_ == p.T_ERROR:
            code, msg = p.parse_error(body)
            raise p.exception_for(code, msg)
        if type_ != p.T_SHM_HELLO_R or rid != req_id:
            raise p.ProtocolError(
                f"unexpected SHM_HELLO response type {type_}")
        _req_cap, _rep_cap, shm_path, ctrl_path = p.parse_shm_hello_r(
            body)
        self._lane = shm_lane.ClientLane(shm_path, ctrl_path)

    def _reconnect_locked(self) -> None:
        if self._lane is not None:
            self._lane.close()
            self._lane = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._connect_locked()

    def _recv_exact(self, n: int, deadline_at: Optional[float],
                    req_id: int, req_type: int) -> bytes:
        while len(self._buf) < n:
            if deadline_at is not None:
                rem = deadline_at - time.monotonic()
                if rem <= 0:
                    self._desynced = True
                    raise RequestTimeoutError(
                        f"deadline expired awaiting response to request "
                        f"{req_id} (type {req_type}); connection will "
                        f"reconnect", request_id=req_id,
                        request_type=req_type)
                if self._call_timeout is None or rem < self._call_timeout:
                    self._sock.settimeout(rem)
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                # Mid-stream read timeout: the response may still arrive
                # later — reading on would hand THIS request the NEXT
                # frame. Mark desynced so the next call reconnects.
                self._desynced = True
                raise RequestTimeoutError(
                    f"timed out awaiting response to request {req_id} "
                    f"(type {req_type}); connection will reconnect",
                    request_id=req_id, request_type=req_type) from None
            finally:
                if deadline_at is not None:
                    self._sock.settimeout(self._call_timeout)
            if not chunk:
                raise ConnectionError("server closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _shm_roundtrip_locked(self, frame: bytes, req_id: int,
                              req_type: int,
                              deadline_at: Optional[float]):
        """One request/response over the shm lane: zero syscalls when
        both sides keep up (the doorbell only fires out of the bounded
        spin)."""
        self._lane.send_frame(frame)
        while True:
            if deadline_at is not None:
                rem = deadline_at - time.monotonic()
                if rem <= 0:
                    self._desynced = True
                    raise RequestTimeoutError(
                        f"deadline expired awaiting response to request "
                        f"{req_id} (type {req_type}); connection will "
                        f"reconnect", request_id=req_id,
                        request_type=req_type)
                timeout = (rem if self._call_timeout is None
                           else min(rem, self._call_timeout))
            else:
                timeout = self._call_timeout
            reply = self._lane.recv_frame(timeout)
            if reply is None:
                self._desynced = True
                raise RequestTimeoutError(
                    f"timed out awaiting response to request {req_id} "
                    f"(type {req_type}); connection will reconnect",
                    request_id=req_id, request_type=req_type)
            length, type_, rid = p.parse_header(reply)
            body = reply[p.HEADER_SIZE:]
            if len(body) != length - 9:
                self._desynced = True
                raise p.ProtocolError("shm reply record length mismatch")
            if rid == 0 and type_ == p.T_LEASE_REVOKE:
                lc = self._lease_cache
                if lc is not None:
                    try:
                        reason, _, ids = p.parse_lease_revoke(body)
                        lc.invalidate_ids(
                            ids, p.LEASE_REASONS.get(reason, "revoked"))
                    except Exception:  # noqa: BLE001 — keep reading
                        pass
                continue
            if rid != req_id:
                self._desynced = True
                raise p.ProtocolError(
                    f"response id {rid} != request id {req_id}")
            return type_, body

    def _roundtrip_once(self, frame: bytes, req_id: int, req_type: int,
                        deadline_at: Optional[float]):
        with self._lock:
            if self._desynced or self._sock is None:
                self._reconnect_locked()
            if self._lane is not None:
                type_, body = self._shm_roundtrip_locked(
                    frame, req_id, req_type, deadline_at)
                if type_ == p.T_ERROR:
                    code, msg = p.parse_error(body)
                    raise p.exception_for(code, msg)
                return type_, body
            self._sock.sendall(frame)
            hdr = self._recv_exact(p.HEADER_SIZE, deadline_at, req_id,
                                   req_type)
            length, type_, rid = p.parse_header(hdr)
            body = self._recv_exact(length - 9, deadline_at, req_id,
                                    req_type)
            if rid != req_id:
                # A stale frame (e.g. the answer to a request a caller
                # abandoned on timeout) must never be returned as this
                # call's result; drop the connection state.
                self._desynced = True
                raise p.ProtocolError(
                    f"response id {rid} != request id {req_id}")
        if type_ == p.T_ERROR:
            code, msg = p.parse_error(body)
            raise p.exception_for(code, msg)
        return type_, body

    def _roundtrip(self, frame: bytes, req_id: int, *,
                   trace_id: int = 0, deadline: Optional[float] = None):
        """One request/response with bounded connection-error retries.
        ``deadline`` (seconds of budget) bounds the WHOLE call including
        retries and rides the wire so the server can shed expired work;
        RequestTimeoutError is never auto-retried (the decision may have
        been applied — retrying double-spends quota)."""
        req_type = frame[4] if len(frame) > 4 else 0
        deadline_at = (time.monotonic() + deadline
                       if deadline is not None else None)
        attempt = 0
        while True:
            budget = (None if deadline_at is None
                      else deadline_at - time.monotonic())
            if budget is not None and budget <= 0:
                raise DeadlineExceededError(
                    f"deadline expired before request {req_id} was sent")
            wire = _stamp(frame, trace_id,
                          budget if deadline is not None else None)
            try:
                return self._roundtrip_once(wire, req_id, req_type,
                                            deadline_at)
            except RequestTimeoutError:
                raise
            except (ConnectionError, OSError) as exc:
                attempt += 1
                if attempt > self.retries:
                    raise
                delay = _jitter_delay(attempt - 1, self._backoff,
                                      self._backoff_max)
                if (deadline_at is not None
                        and time.monotonic() + delay >= deadline_at):
                    raise DeadlineExceededError(
                        f"deadline expired during retry backoff "
                        f"(attempt {attempt}): {exc}") from exc
                time.sleep(delay)
                with self._lock:
                    try:
                        self._reconnect_locked()
                    except OSError:
                        pass  # next loop iteration retries the connect

    @property
    def desynced(self) -> bool:
        """True when the previous call left an unread response on the
        wire (mid-stream timeout); the next call reconnects."""
        return self._desynced

    # ------------------------------------------------------------- surface

    def allow(self, key: str, *, trace_id: int = 0,
              deadline: Optional[float] = None) -> Result:
        return self.allow_n(key, 1, trace_id=trace_id, deadline=deadline)

    def allow_n(self, key: str, n: int, *, trace_id: int = 0,
                deadline: Optional[float] = None) -> Result:
        """``trace_id`` (nonzero) samples this request into the server's
        flight recorder via the wire trace extension (ADR-014); pair it
        with a client-side ``tracing.record("client", ...)`` span to get
        the full client → door → device tree in one dump. ``deadline``
        (seconds) bounds the call including retries and propagates to
        the server (ADR-015). With leases enabled, a key holding a live
        local lease with budget answers WITHOUT the wire."""
        lc = self._lease_cache
        if lc is not None:
            res = lc.try_acquire(key, n)
            if res is not None:
                return res
        req_id = next(self._ids)
        type_, body = self._roundtrip(p.encode_allow_n(req_id, key, n),
                                      req_id, trace_id=trace_id,
                                      deadline=deadline)
        if type_ != p.T_RESULT:
            raise p.ProtocolError(f"unexpected response type {type_}")
        if lc is not None:
            lc.note_wire(key)
        return p.parse_result(body)

    def allow_batch(self, keys: Sequence[str],
                    ns: Optional[Sequence[int]] = None, *,
                    trace_id: int = 0,
                    deadline: Optional[float] = None) -> list:
        """One ALLOW_BATCH frame; results in request order."""
        if ns is None:
            ns = [1] * len(keys)
        req_id = next(self._ids)
        type_, body = self._roundtrip(
            p.encode_allow_batch(req_id, keys, ns), req_id,
            trace_id=trace_id, deadline=deadline)
        if type_ != p.T_RESULT_BATCH:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_result_batch(body)

    def allow_hashed(self, ids, ns=None, *, trace_id: int = 0,
                     deadline: Optional[float] = None):
        """One ALLOW_HASHED frame of raw u64 key ids (the zero-copy bulk
        lane, ADR-011): columnar on the wire, hashed on device server-side;
        returns the frame's BatchResult (frombuffer-view columns). The id
        keyspace is disjoint from string keys; sketch-family servers only."""
        req_id = next(self._ids)
        type_, body = self._roundtrip(
            p.encode_allow_hashed(req_id, ids, ns), req_id,
            trace_id=trace_id, deadline=deadline)
        if type_ != p.T_RESULT_HASHED:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_result_hashed(body)

    def reset(self, key: str) -> None:
        req_id = next(self._ids)
        type_, _ = self._roundtrip(p.encode_reset(req_id, key), req_id)
        if type_ != p.T_OK:
            raise p.ProtocolError(f"unexpected response type {type_}")

    def health(self) -> tuple[bool, float, int]:
        """(serving, uptime_seconds, decisions_total)."""
        req_id = next(self._ids)
        type_, body = self._roundtrip(
            p.encode_simple(p.T_HEALTH, req_id), req_id)
        if type_ != p.T_HEALTH_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_health(body)

    def metrics(self) -> str:
        req_id = next(self._ids)
        type_, body = self._roundtrip(
            p.encode_simple(p.T_METRICS, req_id), req_id)
        if type_ != p.T_METRICS_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_metrics(body)

    def snapshot(self) -> tuple[int, int, float]:
        """Trigger a durability snapshot now (persistence must be enabled
        server-side; asyncio front door only: under --native use HTTP
        POST /v1/snapshot, as for the policy frames); returns
        (snapshot_id, wal_seq, duration_s)."""
        req_id = next(self._ids)
        type_, body = self._roundtrip(
            p.encode_simple(p.T_SNAPSHOT, req_id), req_id)
        if type_ != p.T_SNAPSHOT_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_snapshot_r(body)

    # ------------------------------------------- policy overrides (tiers)

    def _policy_roundtrip(self, frame: bytes, req_id: int):
        type_, body = self._roundtrip(frame, req_id)
        if type_ != p.T_POLICY_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_policy_r(body)

    def set_override(self, key: str, limit=None,
                     window_scale: float = 1.0) -> tuple[int, float]:
        """Store a tiered override for key; returns the stored
        (limit, window_scale)."""
        req_id = next(self._ids)
        _, limit, scale = self._policy_roundtrip(
            p.encode_policy_set(req_id, key, limit, window_scale), req_id)
        return limit, scale

    def get_override(self, key: str):
        """(limit, window_scale) of key's override, or None (default tier)."""
        req_id = next(self._ids)
        found, limit, scale = self._policy_roundtrip(
            p.encode_policy_key(p.T_POLICY_GET, req_id, key), req_id)
        return (limit, scale) if found else None

    def delete_override(self, key: str) -> bool:
        """Return key to the default tier; True iff an override existed."""
        req_id = next(self._ids)
        found, _, _ = self._policy_roundtrip(
            p.encode_policy_key(p.T_POLICY_DEL, req_id, key), req_id)
        return found

    # ------------------------------------------------------ quota leases

    def enable_leases(self, *, lease_port: Optional[int] = None,
                      interval: float = 0.1, cache=None, **cache_kw):
        """Turn on the client-embedded lease tier: hot keys get a local
        token budget and ``allow``/``allow_n`` answer them at memory
        speed. ``lease_port`` targets the native door's sidecar listener
        (default: the main port — the asyncio door serves lease frames
        itself). Remaining kwargs configure the
        :class:`~ratelimiter_tpu_torch.leases.cache.LeaseCache`
        (hot_after, want, low_water, ...). Returns the cache."""
        from ratelimiter_tpu_torch.leases.cache import LeaseCache
        from ratelimiter_tpu_torch.leases.driver import LeaseDriver

        if self._lease_driver is not None:
            return self._lease_cache
        self._lease_cache = (cache if cache is not None
                             else LeaseCache(**cache_kw))
        addr = (self._host, lease_port if lease_port is not None
                else self._port)
        self._lease_driver = LeaseDriver(self._lease_cache,
                                         lambda key: addr,
                                         interval=interval)
        self._lease_driver.start()
        return self._lease_cache

    def disable_leases(self) -> None:
        """Hand every lease back and return to pure wire decisions."""
        drv, self._lease_driver = self._lease_driver, None
        self._lease_cache = None
        if drv is not None:
            drv.close()

    @property
    def lease_cache(self):
        return self._lease_cache

    def close(self) -> None:
        self.disable_leases()
        if self._lane is not None:
            self._lane.close()
            self._lane = None
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncClient:
    """Pipelined asyncio client: unlimited in-flight requests, responses
    matched by id. One reader task per connection. Connection errors
    auto-reconnect with bounded full-jitter retries (decision calls only
    resend when the frame never completed its write cycle — after a
    response-wait is interrupted by connection loss the call is retried
    like the blocking client's connection-error class, not its
    mid-stream-timeout class, because a dead connection can never hand
    back a misaligned frame). Per-call ``deadline`` bounds the wait and
    rides the wire (ADR-015)."""

    def __init__(self):
        self._host: str = "127.0.0.1"
        self._port: int = 0
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ids = itertools.count(1)
        self._waiting: Dict[int, asyncio.Future] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self.retries = 2
        self._backoff = 0.05
        self._backoff_max = 2.0
        self._conn_lock: Optional[asyncio.Lock] = None
        self._transport = "tcp"
        self._shm_ring_bytes = 0
        self._lane: Optional[shm_lane.ClientLane] = None
        self._lease_cache = None
        self._lease_task: Optional[asyncio.Task] = None

    @classmethod
    async def connect(cls, host: str = "127.0.0.1", port: int = 0, *,
                      retries: int = 2, backoff: float = 0.05,
                      backoff_max: float = 2.0,
                      transport: str = "tcp",
                      shm_ring_bytes: int = 0) -> "AsyncClient":
        """``transport``: "tcp", "uds" (``host`` is ``unix:/path``) or
        "shm" (connect, then upgrade to shared rings via T_SHM_HELLO —
        ADR-025; replies arrive through the lane's eventfd doorbell on
        this loop). A ``unix:`` host implies uds regardless."""
        self = cls()
        if transport not in ("tcp", "uds", "shm"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "uds" and not host.startswith("unix:"):
            host = "unix:" + host
        self._host, self._port = host, port
        self._transport = transport
        self._shm_ring_bytes = int(shm_ring_bytes)
        self.retries = int(retries)
        self._backoff = float(backoff)
        self._backoff_max = float(backoff_max)
        self._conn_lock = asyncio.Lock()
        await self._open()
        return self

    async def _open(self) -> None:
        if self._host.startswith("unix:"):
            self._reader, self._writer = (
                await asyncio.open_unix_connection(
                    self._host[len("unix:"):]))
        else:
            self._reader, self._writer = await asyncio.open_connection(
                self._host, self._port)
            self._writer.get_extra_info("socket").setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._transport == "shm":
            # Upgrade BEFORE the read loop exists, so the hello reply
            # is read inline here rather than raced by _read_loop.
            await self._upgrade_shm()
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _upgrade_shm(self) -> None:
        req_id = next(self._ids)
        self._writer.write(p.encode_shm_hello(
            req_id, self._shm_ring_bytes, self._shm_ring_bytes))
        await self._writer.drain()
        hdr = await self._reader.readexactly(p.HEADER_SIZE)
        length, type_, rid = p.parse_header(hdr)
        body = await self._reader.readexactly(length - 9)
        if type_ == p.T_ERROR:
            code, msg = p.parse_error(body)
            raise p.exception_for(code, msg)
        if type_ != p.T_SHM_HELLO_R or rid != req_id:
            raise p.ProtocolError(
                f"unexpected SHM_HELLO response type {type_}")
        _rq, _rp, shm_path, ctrl_path = p.parse_shm_hello_r(body)
        loop = asyncio.get_running_loop()
        # The control-socket connect + SCM_RIGHTS receive block briefly;
        # keep them off the loop.
        self._lane = await loop.run_in_executor(
            None, shm_lane.ClientLane, shm_path, ctrl_path)
        # This client consumes replies via the event loop, not a spin:
        # keep the consumer-sleeping flag permanently up so the server
        # dings the doorbell for every reply burst (one eventfd write
        # per drain, not per frame — the batching still amortizes).
        self._lane.inbound.set_sleeping(True)
        loop.add_reader(self._lane.efd_client, self._lane_drain)

    def _lane_drain(self) -> None:
        """efd_client doorbell: pop every committed reply record and
        dispatch it exactly as the socket read loop would."""
        lane = self._lane
        if lane is None:
            return
        shm_lane._drain_eventfd(lane.efd_client)
        lane.stats.doorbell_wakes += 1
        try:
            while True:
                frame = lane.try_recv()
                if frame is None:
                    break
                _len, type_, rid = p.parse_header(frame)
                self._dispatch_reply(type_, rid, frame[p.HEADER_SIZE:])
        except shm_lane.ShmProtocolError as exc:
            # Poisoned ring: fail the in-flight calls and drop the
            # connection through the liveness socket.
            for fut in self._waiting.values():
                if not fut.done():
                    fut.set_exception(
                        ConnectionError(f"shm lane poisoned: {exc}"))
            self._waiting.clear()
            self._teardown_lane()
            if self._writer is not None:
                self._writer.close()

    def _teardown_lane(self) -> None:
        lane, self._lane = self._lane, None
        if lane is None:
            return
        try:
            asyncio.get_running_loop().remove_reader(lane.efd_client)
        except (OSError, RuntimeError):
            pass
        lane.close()

    def _dispatch_reply(self, type_: int, rid: int, body: bytes) -> None:
        if rid == 0 and type_ == p.T_LEASE_REVOKE:
            # Unsolicited server push: the leases it names stop
            # answering locally NOW.
            lc = self._lease_cache
            if lc is not None:
                try:
                    reason, _, ids = p.parse_lease_revoke(body)
                    lc.invalidate_ids(
                        ids, p.LEASE_REASONS.get(reason, "revoked"))
                except Exception:  # noqa: BLE001 — keep reading
                    pass
            return
        fut = self._waiting.pop(rid, None)
        if fut is not None and not fut.done():
            fut.set_result((type_, body))

    async def _ensure_open(self) -> None:
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            # A peer-closed connection may leave the writer LOOKING open
            # (is_closing() flips only after a failed write); the reader
            # task exiting is the reliable death signal — without this
            # check a resent request would wait on a future nobody will
            # ever complete.
            dead = (self._writer is None or self._writer.is_closing()
                    or self._reader_task is None
                    or self._reader_task.done())
            if dead:
                self._teardown_lane()
                if self._reader_task is not None:
                    self._reader_task.cancel()
                    try:
                        await self._reader_task
                    except (asyncio.CancelledError, Exception):
                        pass
                if self._writer is not None:
                    self._writer.close()
                await self._open()

    async def _read_loop(self) -> None:
        try:
            while True:
                hdr = await self._reader.readexactly(p.HEADER_SIZE)
                length, type_, rid = p.parse_header(hdr)
                body = await self._reader.readexactly(length - 9)
                self._dispatch_reply(type_, rid, body)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError, OSError) as exc:
            for fut in self._waiting.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"connection lost: {exc!r}"))
            self._waiting.clear()
            # On an shm connection the socket is the liveness channel:
            # its death invalidates the rings too.
            self._teardown_lane()

    async def _request_once(self, frame: bytes, req_id: int):
        fut = asyncio.get_running_loop().create_future()
        self._waiting[req_id] = fut
        try:
            if self._lane is not None:
                # Ring write: zero syscalls unless the server sleeps
                # (doorbell) or the ring backs up (typed RingFullError,
                # a StorageUnavailableError — never a silent drop).
                self._lane.send_frame(frame)
            else:
                self._writer.write(frame)
                await self._writer.drain()
            type_, body = await fut
        finally:
            self._waiting.pop(req_id, None)
        if type_ == p.T_ERROR:
            code, msg = p.parse_error(body)
            raise p.exception_for(code, msg)
        return type_, body

    async def _request(self, frame: bytes, req_id: int, *,
                       trace_id: int = 0,
                       deadline: Optional[float] = None):
        """Request/response with auto-reconnect + bounded full-jitter
        retries on connection errors; ``deadline`` bounds the whole call
        and propagates on the wire (a deadline breach while the
        connection is HEALTHY raises DeadlineExceededError without
        retrying — the server may still apply the decision)."""
        loop = asyncio.get_running_loop()
        deadline_at = (loop.time() + deadline
                       if deadline is not None else None)
        attempt = 0
        while True:
            budget = (None if deadline_at is None
                      else deadline_at - loop.time())
            if budget is not None and budget <= 0:
                raise DeadlineExceededError(
                    f"deadline expired before request {req_id} was sent")
            wire = _stamp(frame, trace_id,
                          budget if deadline is not None else None)
            try:
                await self._ensure_open()
                if budget is not None:
                    return await asyncio.wait_for(
                        self._request_once(wire, req_id), budget)
                return await self._request_once(wire, req_id)
            except asyncio.TimeoutError:
                raise DeadlineExceededError(
                    f"deadline expired awaiting response to request "
                    f"{req_id}") from None
            except (ConnectionError, asyncio.IncompleteReadError,
                    OSError) as exc:
                attempt += 1
                if attempt > self.retries:
                    raise
                delay = _jitter_delay(attempt - 1, self._backoff,
                                      self._backoff_max)
                if (deadline_at is not None
                        and loop.time() + delay >= deadline_at):
                    raise DeadlineExceededError(
                        f"deadline expired during retry backoff "
                        f"(attempt {attempt}): {exc}") from exc
                await asyncio.sleep(delay)

    async def allow(self, key: str, *, trace_id: int = 0,
                    deadline: Optional[float] = None) -> Result:
        return await self.allow_n(key, 1, trace_id=trace_id,
                                  deadline=deadline)

    async def allow_n(self, key: str, n: int, *, trace_id: int = 0,
                      deadline: Optional[float] = None) -> Result:
        lc = self._lease_cache
        if lc is not None:
            res = lc.try_acquire(key, n)
            if res is not None:
                return res
        req_id = next(self._ids)
        type_, body = await self._request(
            p.encode_allow_n(req_id, key, n), req_id, trace_id=trace_id,
            deadline=deadline)
        if type_ != p.T_RESULT:
            raise p.ProtocolError(f"unexpected response type {type_}")
        if lc is not None:
            lc.note_wire(key)
        return p.parse_result(body)

    async def allow_many(self, keys: Sequence[str],
                         ns: Optional[Sequence[int]] = None) -> list:
        """Fire a pipelined burst and gather results in order — the load
        shape that exercises the server's micro-batching."""
        if ns is None:
            ns = [1] * len(keys)
        return await asyncio.gather(
            *(self.allow_n(k, n) for k, n in zip(keys, ns)),
            return_exceptions=True)

    async def allow_batch(self, keys: Sequence[str],
                          ns: Optional[Sequence[int]] = None, *,
                          trace_id: int = 0,
                          deadline: Optional[float] = None) -> list:
        """One ALLOW_BATCH frame for the whole sequence (amortized framing;
        decisions still coalesce with other connections server-side).
        Returns results in request order."""
        if ns is None:
            ns = [1] * len(keys)
        req_id = next(self._ids)
        type_, body = await self._request(
            p.encode_allow_batch(req_id, keys, ns), req_id,
            trace_id=trace_id, deadline=deadline)
        if type_ != p.T_RESULT_BATCH:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_result_batch(body)

    async def allow_hashed(self, ids, ns=None, *, trace_id: int = 0,
                           deadline: Optional[float] = None):
        """One ALLOW_HASHED frame of raw u64 key ids (the zero-copy bulk
        lane, ADR-011); returns the frame's BatchResult. Pipelines with
        every other in-flight request on this connection."""
        req_id = next(self._ids)
        type_, body = await self._request(
            p.encode_allow_hashed(req_id, ids, ns), req_id,
            trace_id=trace_id, deadline=deadline)
        if type_ != p.T_RESULT_HASHED:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_result_hashed(body)

    async def reset(self, key: str) -> None:
        req_id = next(self._ids)
        type_, _ = await self._request(p.encode_reset(req_id, key), req_id)
        if type_ != p.T_OK:
            raise p.ProtocolError(f"unexpected response type {type_}")

    async def health(self) -> tuple[bool, float, int]:
        req_id = next(self._ids)
        type_, body = await self._request(
            p.encode_simple(p.T_HEALTH, req_id), req_id)
        if type_ != p.T_HEALTH_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_health(body)

    async def metrics(self) -> str:
        req_id = next(self._ids)
        type_, body = await self._request(
            p.encode_simple(p.T_METRICS, req_id), req_id)
        if type_ != p.T_METRICS_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_metrics(body)

    async def snapshot(self) -> tuple[int, int, float]:
        """Trigger a durability snapshot now; returns
        (snapshot_id, wal_seq, duration_s)."""
        req_id = next(self._ids)
        type_, body = await self._request(
            p.encode_simple(p.T_SNAPSHOT, req_id), req_id)
        if type_ != p.T_SNAPSHOT_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_snapshot_r(body)

    # ------------------------------------------- policy overrides (tiers)

    async def _policy_request(self, frame: bytes, req_id: int):
        type_, body = await self._request(frame, req_id)
        if type_ != p.T_POLICY_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_policy_r(body)

    async def set_override(self, key: str, limit=None,
                           window_scale: float = 1.0) -> tuple[int, float]:
        req_id = next(self._ids)
        _, limit, scale = await self._policy_request(
            p.encode_policy_set(req_id, key, limit, window_scale), req_id)
        return limit, scale

    async def get_override(self, key: str):
        req_id = next(self._ids)
        found, limit, scale = await self._policy_request(
            p.encode_policy_key(p.T_POLICY_GET, req_id, key), req_id)
        return (limit, scale) if found else None

    async def delete_override(self, key: str) -> bool:
        req_id = next(self._ids)
        found, _, _ = await self._policy_request(
            p.encode_policy_key(p.T_POLICY_DEL, req_id, key), req_id)
        return found

    # ------------------------------------------------------ quota leases

    async def enable_leases(self, *, interval: float = 0.1, cache=None,
                            **cache_kw):
        """Turn on the lease tier: maintenance (grant/renew/return)
        pipelines on THIS connection like any other request, and
        revocation pushes are consumed by the read loop. Returns the
        :class:`~ratelimiter_tpu_torch.leases.cache.LeaseCache`.
        Asyncio-door servers only (the native door's lease sidecar
        speaks to the blocking clients' driver)."""
        from ratelimiter_tpu_torch.leases.cache import LeaseCache

        if self._lease_task is not None:
            return self._lease_cache
        self._lease_cache = (cache if cache is not None
                             else LeaseCache(**cache_kw))
        self._lease_task = asyncio.ensure_future(
            self._lease_loop(float(interval)))
        return self._lease_cache

    async def disable_leases(self) -> None:
        task, self._lease_task = self._lease_task, None
        cache, self._lease_cache = self._lease_cache, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        if cache is not None:
            for act in cache.drain():
                _, key, lease_id, delta = act
                try:
                    req_id = next(self._ids)
                    await self._request(
                        p.encode_lease_return(req_id, cache.client_id,
                                              lease_id, key, delta),
                        req_id)
                except Exception:  # noqa: BLE001 — TTL reaps it anyway
                    pass

    @property
    def lease_cache(self):
        return self._lease_cache

    async def _lease_loop(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            cache = self._lease_cache
            if cache is None:
                return
            for act in cache.actions():
                await self._lease_action(cache, act)

    async def _lease_action(self, cache, act: tuple) -> None:
        kind = act[0]
        if kind == "grant":
            _, key, want = act
            try:
                req_id = next(self._ids)
                type_, body = await self._request(
                    p.encode_lease_grant(req_id, cache.client_id, key,
                                         want), req_id)
                if type_ != p.T_LEASE_R:
                    raise p.ProtocolError(
                        f"unexpected lease response type {type_}")
                granted, lease_id, budget, ttl, limit, epoch = \
                    p.parse_lease_r(body)
                cache.on_grant(key, granted, lease_id, budget, ttl,
                               limit, epoch)
            except Exception:  # noqa: BLE001 — wire path covers
                cache.grant_failed(key)
        elif kind == "renew":
            _, key, lease_id, delta, want = act
            try:
                req_id = next(self._ids)
                type_, body = await self._request(
                    p.encode_lease_renew(req_id, cache.client_id,
                                         lease_id, key, delta, want),
                    req_id)
                if type_ != p.T_LEASE_R:
                    raise p.ProtocolError(
                        f"unexpected lease response type {type_}")
                granted, lease_id, top_up, ttl, limit, epoch = \
                    p.parse_lease_r(body)
                cache.on_renew(lease_id, granted, top_up, ttl, limit,
                               epoch)
            except Exception:  # noqa: BLE001
                cache.renew_failed(lease_id, delta)

    async def close(self) -> None:
        await self.disable_leases()
        self._teardown_lane()
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
