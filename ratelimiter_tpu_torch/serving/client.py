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
loops.

The fleet clients, as in the JAX package: ``FleetClient`` and
``AsyncFleetClient`` hold one pooled client per fleet member, partition
each frame by owner (the same hash rule as the servers) and fan the
legs out concurrently; a failed leg alone is retried after a map
refresh, and a stale map heals off the typed E_NOT_OWNER redirect.
``fleet_map()`` on either client fetches a member's map.
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

    def fleet_map(self) -> dict:
        """Fetch the server's fleet ownership map (E_INVALID_CONFIG on a
        server outside a fleet)."""
        req_id = next(self._ids)
        type_, body = self._roundtrip(p.encode_fleet_map(req_id), req_id)
        if type_ != p.T_FLEET_MAP_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_fleet_map_r(body)

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

    async def fleet_map(self) -> dict:
        """Fetch the server's fleet ownership map."""
        req_id = next(self._ids)
        type_, body = await self._request(p.encode_fleet_map(req_id),
                                          req_id)
        if type_ != p.T_FLEET_MAP_R:
            raise p.ProtocolError(f"unexpected response type {type_}")
        return p.parse_fleet_map_r(body)

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


# ====================================================================
#                      fleet clients (ADR-017)
# ====================================================================
#
# Client-side consistent-hash routing: the shard-affine loadgen mode
# (benchmarks/e2e.py spread knob, ADR-013) promoted to first-class
# client behavior. Every allow_batch / allow_hashed frame partitions by
# keyspace owner (the SAME splitmix64 / h64 % buckets rule the servers
# and mesh slices apply), fans out over per-host pooled connections
# with the clients' retry/deadline machinery, and reassembles per-frame
# answers in request order. Affine routing means a frame's rows arrive
# at servers that own them — the zero-forwarding fast path; a stale map
# self-heals off the typed E_NOT_OWNER redirect or a connection error
# (refresh from any live member, retry once).


def _fleet_map_of(obj):
    from ratelimiter_tpu_torch.fleet.config import FleetMap

    if isinstance(obj, FleetMap):
        return obj
    if isinstance(obj, dict):
        return FleetMap.from_dict(obj)
    if isinstance(obj, str):
        return FleetMap.load(obj)
    raise TypeError(f"fleet map must be FleetMap/dict/path, got {obj!r}")


class FleetClient:
    """Blocking fleet client: one pooled :class:`Client` per member,
    frames partitioned by owner and fanned out concurrently.

    Args:
        fleet_map: FleetMap | dict | path to the ``--fleet-config``
            JSON. Optional when ``seed`` is given (the map bootstraps
            via T_FLEET_MAP from the seed server).
        seed: (host, port) of any asyncio-door fleet member, used to
            bootstrap and refresh the map.
        prefix: the servers' key prefix (Config.prefix) — the client
            must hash strings exactly as the servers do. ``None`` uses
            the library default.
        deadline: default per-call deadline (seconds) riding the wire
            on every fan-out leg; None disables.
        map_max_age: refresh the ownership map from any live member
            once it is older than this many seconds (default 3.0;
            None disables). Errors and E_NOT_OWNER redirects already
            self-heal the map, but a REBALANCE is silent — the old
            owner keeps answering via server-side forwarding — so a
            long-lived client would otherwise pay the forwarding hop
            forever after an elastic resharding (ADR-018).
        Remaining kwargs configure each underlying Client (retries,
        backoff, timeouts).

    Same-key ordering: one connection per host (the default pool) and
    sequential use per thread means a key's frames reach its owner in
    issue order — the property tests/test_fleet.py pins across a
    forwarding hop as well.
    """

    def __init__(self, fleet_map=None, *, seed: Optional[tuple] = None,
                 prefix: Optional[str] = None,
                 deadline: Optional[float] = None,
                 map_max_age: Optional[float] = 3.0,
                 retries: int = 2, **client_kw):
        from ratelimiter_tpu_torch.core.config import DEFAULT_PREFIX

        if fleet_map is None:
            if seed is None:
                raise ValueError("FleetClient needs fleet_map or seed")
            with Client(seed[0], seed[1], retries=retries,
                        **client_kw) as c:
                fleet_map = c.fleet_map()
        self.map = _fleet_map_of(fleet_map)
        self.prefix = DEFAULT_PREFIX if prefix is None else prefix
        self.deadline = deadline
        self.map_max_age = map_max_age
        self._map_fetched_at = time.monotonic()
        self._retries = retries
        self._client_kw = client_kw
        self._clients: Dict[int, Client] = {}
        self._lock = threading.Lock()
        self._pool = None
        self._lease_cache = None
        self._lease_driver = None

    # ------------------------------------------------------------ plumbing

    def _executor(self):
        import concurrent.futures

        with self._lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(2, len(self.map.hosts)),
                    thread_name_prefix="rl-fleet-client")
            return self._pool

    def _client(self, ordinal: int) -> Client:
        with self._lock:
            c = self._clients.get(ordinal)
            host = self.map.hosts[ordinal]
            if c is None or (c._host, c._port) != (host.host, host.port):
                if c is not None:
                    c.close()
                c = Client(host.host, host.port, retries=self._retries,
                           **self._client_kw)
                self._clients[ordinal] = c
        return c

    def _hash(self, keys: Sequence[str]):
        from ratelimiter_tpu_torch.ops.hashing import hash_prefixed_u64

        return hash_prefixed_u64(list(keys), self.prefix)

    def refresh_map(self) -> bool:
        """Re-fetch the ownership map from the first live member; True
        iff a newer epoch was installed. Called automatically on typed
        redirects, connection failures, and (``map_max_age``) staleness."""
        for ordinal in range(len(self.map.hosts)):
            try:
                d = self._client(ordinal).fleet_map()
            except Exception:  # noqa: BLE001 — try the next member
                continue
            self._map_fetched_at = time.monotonic()
            m = _fleet_map_of(d)
            if m.epoch > self.map.epoch:
                with self._lock:
                    self.map = m
                if self._lease_cache is not None:
                    # Ownership moved (ADR-022): leases granted under
                    # the old epoch may name ranges their grantor no
                    # longer owns — stop answering from them.
                    self._lease_cache.on_epoch(m.epoch)
                return True
            return False
        return False

    def _maybe_refresh(self) -> None:
        """Age-based refresh (see ``map_max_age``): rebalances are
        silent to a routing-only client, so poll the epoch at a bounded
        cadence instead of paying the forwarding hop indefinitely."""
        if (self.map_max_age is not None
                and time.monotonic() - self._map_fetched_at
                > self.map_max_age):
            self._map_fetched_at = time.monotonic()  # backoff on failure
            self.refresh_map()

    def _refresh_from_error(self, exc: Exception) -> bool:
        from ratelimiter_tpu_torch.core.errors import NotOwnerError

        if isinstance(exc, NotOwnerError):
            return self.refresh_map() or True  # owner named: retry anyway
        if isinstance(exc, (ConnectionError, OSError)):
            return self.refresh_map()
        return False

    # ------------------------------------------------------------- scalar

    def allow(self, key: str, **kw) -> Result:
        return self.allow_n(key, 1, **kw)

    def allow_n(self, key: str, n: int = 1, *,
                deadline: Optional[float] = None) -> Result:
        lc = self._lease_cache
        if lc is not None:
            res = lc.try_acquire(key, n)
            if res is not None:
                return res
        self._maybe_refresh()
        dl = deadline if deadline is not None else self.deadline
        owner = int(self.map.owner_of_hash(self._hash([key]))[0])
        try:
            res = self._client(owner).allow_n(key, n, deadline=dl)
        except Exception as exc:
            if not self._refresh_from_error(exc):
                raise
            owner = int(self.map.owner_of_hash(self._hash([key]))[0])
            res = self._client(owner).allow_n(key, n, deadline=dl)
        if lc is not None:
            lc.note_wire(key)
        return res

    # ------------------------------------------------------------- frames

    def _fan_out_rows(self, n_rows, owners_of, call):
        """Shared frame fan-out: partition rows by owner
        (FleetMap.partition — the one partition rule), run one call per
        owner concurrently, and on a redirect/connection error refresh
        the map ONCE and retry ONLY the failed rows, re-partitioned
        under the fresh owner table (a failed-over range's rows re-route
        to the successor; healthy owners' rows are never re-sent, which
        would double-charge their quota). Returns
        ``[(row_positions, leg_result)]``; bounded to one retry."""
        import numpy as np

        pending = np.arange(n_rows)
        parts = []
        for attempt in (0, 1):
            groups = self.map.partition(owners_of(pending))
            ex = self._executor()
            futs = [(pos, ex.submit(call, o, pending[pos]))
                    for o, pos in groups.items()]
            failed = []
            first_exc = None
            for pos, fut in futs:
                try:
                    parts.append((pending[pos], fut.result()))
                except Exception as exc:  # noqa: BLE001 — retried below
                    if first_exc is None:
                        first_exc = exc
                    failed.append(pending[pos])
            if not failed:
                return parts
            if attempt == 1 or not self._refresh_from_error(first_exc):
                raise first_exc
            pending = np.concatenate(failed)
            pending.sort()
        return parts

    def allow_batch(self, keys: Sequence[str],
                    ns: Optional[Sequence[int]] = None, *,
                    deadline: Optional[float] = None) -> list:
        """One logical frame routed across the fleet: results in
        request order (list of Result, like Client.allow_batch)."""
        keys = list(keys)
        self._maybe_refresh()
        ns = [1] * len(keys) if ns is None else list(ns)
        dl = deadline if deadline is not None else self.deadline
        h64 = self._hash(keys)

        def owners_of(rows):
            return self.map.owner_of_hash(h64[rows])

        def call(o, rows):
            return self._client(o).allow_batch(
                [keys[i] for i in rows], [int(ns[i]) for i in rows],
                deadline=dl)

        parts = self._fan_out_rows(len(keys), owners_of, call)
        results = [None] * len(keys)
        for rows, out in parts:
            for i, r in zip(rows.tolist(), out):
                results[i] = r
        return results

    def allow_hashed(self, ids, ns=None, *,
                     deadline: Optional[float] = None):
        """One raw-u64-id frame routed across the fleet (the zero-copy
        bulk lane); returns the frame's BatchResult in request order."""
        import numpy as np

        from ratelimiter_tpu_torch.fleet.forwarder import scatter_merge
        from ratelimiter_tpu_torch.ops.hashing import splitmix64

        self._maybe_refresh()
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        ns_arr = (np.ones(ids.shape[0], dtype=np.int64) if ns is None
                  else np.asarray(ns, dtype=np.int64))
        dl = deadline if deadline is not None else self.deadline
        h64 = splitmix64(ids)

        def owners_of(rows):
            return self.map.owner_of_hash(h64[rows])

        def call(o, rows):
            return self._client(o).allow_hashed(ids[rows], ns_arr[rows],
                                                deadline=dl)

        if not ids.shape[0]:
            return scatter_merge(0, 0, [])
        parts = self._fan_out_rows(int(ids.shape[0]), owners_of, call)
        if len(parts) == 1:
            return parts[0][1]
        limit = parts[0][1].limit
        return scatter_merge(int(ids.shape[0]), limit, parts)

    # -------------------------------------------------------- control plane

    def reset(self, key: str) -> None:
        owner = int(self.map.owner_of_hash(self._hash([key]))[0])
        self._client(owner).reset(key)

    def set_override(self, key: str, limit=None,
                     window_scale: float = 1.0):
        """Tiered override applied on EVERY member (the cross-host form
        of set_override_all: keys hash-route, non-owners' copies are
        idempotent and make later failovers/reshards safe)."""
        out = None
        for o in range(len(self.map.hosts)):
            out = self._client(o).set_override(key, limit,
                                               window_scale=window_scale)
        return out

    def get_override(self, key: str):
        owner = int(self.map.owner_of_hash(self._hash([key]))[0])
        return self._client(owner).get_override(key)

    def delete_override(self, key: str) -> bool:
        existed = False
        for o in range(len(self.map.hosts)):
            existed = self._client(o).delete_override(key) or existed
        return existed

    # -------------------------------------------- quota leases (ADR-022)

    def enable_leases(self, *, interval: float = 0.1, cache=None,
                      **cache_kw):
        """Lease tier over the fleet: grants route to the key's OWNER
        (the driver resolves per key on the current map), and an epoch
        bump from refresh_map retires leases granted under old
        ownership. Returns the LeaseCache."""
        from ratelimiter_tpu_torch.leases.cache import LeaseCache
        from ratelimiter_tpu_torch.leases.driver import LeaseDriver

        if self._lease_driver is not None:
            return self._lease_cache
        self._lease_cache = (cache if cache is not None
                             else LeaseCache(**cache_kw))

        def resolve(key: str):
            owner = int(self.map.owner_of_hash(self._hash([key]))[0])
            host = self.map.hosts[owner]
            return host.host, host.port

        self._lease_driver = LeaseDriver(self._lease_cache, resolve,
                                         interval=interval)
        self._lease_driver.start()
        return self._lease_cache

    def disable_leases(self) -> None:
        drv, self._lease_driver = self._lease_driver, None
        self._lease_cache = None
        if drv is not None:
            drv.close()

    @property
    def lease_cache(self):
        return self._lease_cache

    def close(self) -> None:
        self.disable_leases()
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
            pool = self._pool
            self._pool = None
        for c in clients:
            c.close()
        if pool is not None:
            pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncFleetClient:
    """Pipelined fleet client: one :class:`AsyncClient` per member,
    frames partitioned by owner and fanned out with ``asyncio.gather``
    — the loadgen-grade surface (benchmarks/fleet.py drives it)."""

    def __init__(self):
        self.map = None
        self.prefix = ""
        self.deadline: Optional[float] = None
        self.map_max_age: Optional[float] = 3.0
        self._map_fetched_at = time.monotonic()
        self._clients: Dict[int, AsyncClient] = {}
        self._client_kw: dict = {}
        self._lease_cache = None
        self._lease_task: Optional[asyncio.Task] = None

    @classmethod
    async def connect(cls, fleet_map=None, *,
                      seed: Optional[tuple] = None,
                      prefix: Optional[str] = None,
                      deadline: Optional[float] = None,
                      map_max_age: Optional[float] = 3.0,
                      **client_kw) -> "AsyncFleetClient":
        from ratelimiter_tpu_torch.core.config import DEFAULT_PREFIX

        self = cls()
        if fleet_map is None:
            if seed is None:
                raise ValueError("AsyncFleetClient needs fleet_map or seed")
            c = await AsyncClient.connect(seed[0], seed[1], **client_kw)
            try:
                fleet_map = await c.fleet_map()
            finally:
                await c.close()
        self.map = _fleet_map_of(fleet_map)
        self.prefix = DEFAULT_PREFIX if prefix is None else prefix
        self.deadline = deadline
        self.map_max_age = map_max_age
        self._map_fetched_at = time.monotonic()
        self._client_kw = client_kw
        return self

    async def _client(self, ordinal: int) -> AsyncClient:
        c = self._clients.get(ordinal)
        host = self.map.hosts[ordinal]
        if c is None or (c._host, c._port) != (host.host, host.port):
            if c is not None:
                await c.close()
            c = await AsyncClient.connect(host.host, host.port,
                                          **self._client_kw)
            # Sub-clients share the fleet cache so a revocation push on
            # ANY member connection invalidates locally (ADR-022); the
            # fleet client owns the maintenance task, so the sub-client
            # never starts its own.
            c._lease_cache = self._lease_cache
            self._clients[ordinal] = c
        return c

    def _hash(self, keys):
        from ratelimiter_tpu_torch.ops.hashing import hash_prefixed_u64

        return hash_prefixed_u64(list(keys), self.prefix)

    async def refresh_map(self) -> bool:
        for ordinal in range(len(self.map.hosts)):
            try:
                c = await self._client(ordinal)
                d = await c.fleet_map()
            except Exception:  # noqa: BLE001 — try the next member
                continue
            self._map_fetched_at = time.monotonic()
            m = _fleet_map_of(d)
            if m.epoch > self.map.epoch:
                self.map = m
                if self._lease_cache is not None:
                    # Ownership moved: retire leases granted under the
                    # old epoch (ADR-022).
                    self._lease_cache.on_epoch(m.epoch)
                return True
            return False
        return False

    async def _maybe_refresh(self) -> None:
        """Age-based refresh — the FleetClient twin: a rebalance is
        silent behind server-side forwarding, so poll the epoch at a
        bounded cadence (``map_max_age``; None disables)."""
        if (self.map_max_age is not None
                and time.monotonic() - self._map_fetched_at
                > self.map_max_age):
            self._map_fetched_at = time.monotonic()  # backoff on failure
            await self.refresh_map()

    async def _refresh_from_error(self, exc: Exception) -> bool:
        from ratelimiter_tpu_torch.core.errors import NotOwnerError

        if isinstance(exc, NotOwnerError):
            await self.refresh_map()
            return True
        if isinstance(exc, (ConnectionError, OSError)):
            return await self.refresh_map()
        return False

    async def allow(self, key: str, **kw) -> Result:
        return await self.allow_n(key, 1, **kw)

    async def allow_n(self, key: str, n: int = 1, *,
                      deadline: Optional[float] = None) -> Result:
        await self._maybe_refresh()
        dl = deadline if deadline is not None else self.deadline
        owner = int(self.map.owner_of_hash(self._hash([key]))[0])
        try:
            c = await self._client(owner)
            return await c.allow_n(key, n, deadline=dl)
        except Exception as exc:
            if not await self._refresh_from_error(exc):
                raise
            owner = int(self.map.owner_of_hash(self._hash([key]))[0])
            c = await self._client(owner)
            return await c.allow_n(key, n, deadline=dl)

    async def _fan_out_rows(self, n_rows, owners_of, call):
        """Async twin of FleetClient._fan_out_rows: one leg per owner
        gathered concurrently; a failed leg refreshes the map ONCE and
        retries ONLY its rows, re-partitioned under the fresh owner
        table — successful legs are never re-sent (a whole-frame retry
        would double-charge quota at healthy owners). Bounded to one
        retry; returns ``[(row_positions, leg_result)]``."""
        import numpy as np

        pending = np.arange(n_rows)
        parts = []
        for attempt in (0, 1):
            groups = self.map.partition(owners_of(pending))
            items = list(groups.items())
            outs = await asyncio.gather(
                *(call(o, pending[pos]) for o, pos in items),
                return_exceptions=True)
            failed = []
            first_exc = None
            for (o, pos), out in zip(items, outs):
                if isinstance(out, BaseException):
                    if first_exc is None:
                        first_exc = out
                    failed.append(pending[pos])
                else:
                    parts.append((pending[pos], out))
            if not failed:
                return parts
            if (attempt == 1
                    or not await self._refresh_from_error(first_exc)):
                raise first_exc
            pending = np.concatenate(failed)
            pending.sort()
        return parts

    async def allow_batch(self, keys, ns=None, *,
                          deadline: Optional[float] = None) -> list:
        await self._maybe_refresh()
        keys = list(keys)
        ns = [1] * len(keys) if ns is None else list(ns)
        dl = deadline if deadline is not None else self.deadline
        h64 = self._hash(keys)

        def owners_of(rows):
            return self.map.owner_of_hash(h64[rows])

        async def call(o, rows):
            c = await self._client(o)
            return await c.allow_batch([keys[i] for i in rows],
                                       [int(ns[i]) for i in rows],
                                       deadline=dl)

        parts = await self._fan_out_rows(len(keys), owners_of, call)
        results = [None] * len(keys)
        for rows, out in parts:
            for i, r in zip(rows.tolist(), out):
                results[i] = r
        return results

    async def allow_hashed(self, ids, ns=None, *,
                           deadline: Optional[float] = None):
        import numpy as np

        from ratelimiter_tpu_torch.fleet.forwarder import scatter_merge
        from ratelimiter_tpu_torch.ops.hashing import splitmix64

        await self._maybe_refresh()
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        ns_arr = (np.ones(ids.shape[0], dtype=np.int64) if ns is None
                  else np.asarray(ns, dtype=np.int64))
        dl = deadline if deadline is not None else self.deadline
        h64 = splitmix64(ids)

        def owners_of(rows):
            return self.map.owner_of_hash(h64[rows])

        async def call(o, rows):
            c = await self._client(o)
            return await c.allow_hashed(ids[rows], ns_arr[rows],
                                        deadline=dl)

        if not ids.shape[0]:
            return scatter_merge(0, 0, [])
        parts = await self._fan_out_rows(int(ids.shape[0]), owners_of,
                                         call)
        if len(parts) == 1:
            return parts[0][1]
        return scatter_merge(int(ids.shape[0]), parts[0][1].limit, parts)

    async def reset(self, key: str) -> None:
        owner = int(self.map.owner_of_hash(self._hash([key]))[0])
        c = await self._client(owner)
        await c.reset(key)

    async def set_override(self, key: str, limit=None,
                           window_scale: float = 1.0):
        out = None
        for o in range(len(self.map.hosts)):
            c = await self._client(o)
            out = await c.set_override(key, limit,
                                       window_scale=window_scale)
        return out

    async def get_override(self, key: str):
        owner = int(self.map.owner_of_hash(self._hash([key]))[0])
        c = await self._client(owner)
        return await c.get_override(key)

    async def delete_override(self, key: str) -> bool:
        existed = False
        for o in range(len(self.map.hosts)):
            c = await self._client(o)
            existed = await c.delete_override(key) or existed
        return existed

    async def fleet_map(self) -> dict:
        """This client's CURRENT ownership map as a dict (refreshes
        ride :meth:`refresh_map`)."""
        return self.map.to_dict()

    # -------------------------------------------- quota leases (ADR-022)

    async def enable_leases(self, *, interval: float = 0.1, cache=None,
                            **cache_kw):
        """Lease tier over the async fleet: ONE cache shared by every
        member connection (any member's revocation push invalidates),
        with this client's maintenance task routing grants/renews to
        each key's owner. Returns the LeaseCache."""
        from ratelimiter_tpu_torch.leases.cache import LeaseCache

        if self._lease_task is not None:
            return self._lease_cache
        self._lease_cache = (cache if cache is not None
                             else LeaseCache(**cache_kw))
        for c in self._clients.values():
            c._lease_cache = self._lease_cache
        self._lease_task = asyncio.ensure_future(
            self._lease_loop(float(interval)))
        return self._lease_cache

    async def disable_leases(self) -> None:
        task, self._lease_task = self._lease_task, None
        cache, self._lease_cache = self._lease_cache, None
        for c in self._clients.values():
            c._lease_cache = None
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
                    owner = int(self.map.owner_of_hash(
                        self._hash([key]))[0])
                    c = await self._client(owner)
                    req_id = next(c._ids)
                    await c._request(
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
                # Route each action to the key's owner; the sub-client's
                # action handler applies results to the SHARED cache.
                try:
                    key = act[1]
                    owner = int(self.map.owner_of_hash(
                        self._hash([key]))[0])
                    c = await self._client(owner)
                except Exception:  # noqa: BLE001 — degrade to wire
                    if act[0] == "grant":
                        cache.grant_failed(act[1])
                    elif act[0] == "renew":
                        cache.renew_failed(act[2], act[3])
                    continue
                await c._lease_action(cache, act)

    async def close(self) -> None:
        await self.disable_leases()
        clients = list(self._clients.values())
        self._clients.clear()
        for c in clients:
            await c.close()
