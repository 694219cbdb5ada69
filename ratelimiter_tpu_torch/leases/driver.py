"""Background lease maintenance for the blocking clients, a copy of
``ratelimiter_tpu/leases/driver.py``.

The decision path never touches the wire — ``LeaseCache.try_acquire``
is a lock and an integer. Everything wire-shaped funnels here: a
:class:`LeaseDriver` thread ticks the cache's :meth:`actions` queue,
sends grant/renew/return frames over dedicated raw-socket connections
(:class:`_LeaseConn`), applies the answers back to the cache, and
consumes unsolicited ``T_LEASE_REVOKE`` pushes (req_id 0) inline —
the server pushes revocations down the same connection that granted.

The driver is ROUTED: ``resolve(key)`` maps a key to the (host, port)
that owns it — a constant for the port's single server (the JAX
package's fleet client routes by its ownership map; the port has no
fleet yet) — so one driver serves both shapes. Connections are lazy
per address and reconnect on the next tick after an error; a tick's
failures degrade to the wire path (the cache simply keeps answering
"no lease"), never to an exception on anyone's decision.
"""

from __future__ import annotations

import itertools
import logging
import select
import socket
import threading
from typing import Callable, Dict, Optional, Tuple

from ratelimiter_tpu_torch.serving import protocol as p

log = logging.getLogger("ratelimiter_tpu_torch.leases")


class _LeaseConn:
    """One raw frame connection to a lease door (main asyncio port or
    the native door's --lease-port sidecar)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._buf = b""
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    # ------------------------------------------------------------ framing

    def _recv_frame(self, sk: socket.socket):
        while len(self._buf) < p.HEADER_SIZE:
            chunk = sk.recv(65536)
            if not chunk:
                raise ConnectionError("lease server closed the connection")
            self._buf += chunk
        length, type_, rid = p.parse_header(self._buf[:p.HEADER_SIZE])
        need = p.HEADER_SIZE + (length - 9)
        while len(self._buf) < need:
            chunk = sk.recv(65536)
            if not chunk:
                raise ConnectionError("lease server closed the connection")
            self._buf += chunk
        body = self._buf[p.HEADER_SIZE:need]
        self._buf = self._buf[need:]
        return type_, rid, body

    def request(self, frame: bytes, req_id: int,
                on_push: Callable[[bytes], None]):
        """Send one lease frame, return ``(type, body)`` of the matching
        response. Unsolicited revocation pushes (req_id 0) that arrive
        interleaved are handed to ``on_push`` — never dropped, never
        mistaken for the answer. Raises on transport errors (the caller
        re-credits / retries per the cache's exactly-once rules)."""
        try:
            sk = self._connect()
            sk.sendall(frame)
            while True:
                type_, rid, body = self._recv_frame(sk)
                if rid == 0:
                    on_push(body)
                    continue
                if rid == req_id:
                    return type_, body
                # A stale answer (abandoned request): skip it.
        except Exception:
            self.close()
            raise

    def poll_pushes(self, on_push: Callable[[bytes], None]) -> int:
        """Drain any revocation pushes waiting on the socket without
        blocking; returns pushes handled."""
        sk = self._sock
        if sk is None:
            return 0
        handled = 0
        try:
            while True:
                ready, _, _ = select.select([sk], [], [], 0)
                if not ready and len(self._buf) < p.HEADER_SIZE:
                    return handled
                if ready:
                    chunk = sk.recv(65536)
                    if not chunk:
                        raise ConnectionError("lease server closed")
                    self._buf += chunk
                while len(self._buf) >= p.HEADER_SIZE:
                    length, _, _ = p.parse_header(
                        self._buf[:p.HEADER_SIZE])
                    if len(self._buf) < p.HEADER_SIZE + (length - 9):
                        break
                    type_, rid, body = self._recv_frame(sk)
                    if rid == 0:
                        on_push(body)
                        handled += 1
                    # rid != 0 here is an orphaned answer: drop it.
        except Exception:
            self.close()
            return handled


class LeaseDriver:
    """Maintenance thread: ticks the cache, routes lease frames.

    Args:
        cache: the client's :class:`~ratelimiter_tpu_torch.leases.cache.
            LeaseCache`.
        resolve: ``key -> (host, port)`` of the lease door that owns
            the key. Must be cheap (called per action per tick).
        interval: tick period, seconds. The renew cadence — and with
            it the audit mirror's freshness — rides this.
    """

    def __init__(self, cache,
                 resolve: Callable[[str], Tuple[str, int]], *,
                 interval: float = 0.1):
        self.cache = cache
        self.resolve = resolve
        self.interval = float(interval)
        self._conns: Dict[Tuple[str, int], _LeaseConn] = {}
        # Renews/returns go to the address that GRANTED the lease even
        # if the map has since moved the key (the grant lives there;
        # the epoch machinery retires it if ownership truly moved).
        self._granted_at: Dict[int, Tuple[str, int]] = {}
        self._ids = itertools.count(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ pushes

    def _on_push(self, body: bytes) -> None:
        try:
            reason, epoch, ids = p.parse_lease_revoke(body)
        except Exception:  # noqa: BLE001 — a bad push must not kill us
            log.warning("dropping malformed lease revocation push")
            return
        self.cache.invalidate_ids(
            ids, p.LEASE_REASONS.get(reason, "revoked"))

    def _conn(self, addr: Tuple[str, int]) -> _LeaseConn:
        c = self._conns.get(addr)
        if c is None:
            c = self._conns[addr] = _LeaseConn(addr[0], addr[1])
        return c

    # -------------------------------------------------------------- tick

    def tick(self) -> None:
        """One maintenance pass (public so tests and the drain path can
        drive it synchronously)."""
        with self._lock:
            for conn in list(self._conns.values()):
                conn.poll_pushes(self._on_push)
            for act in self.cache.actions():
                self._do_action(act)

    def _do_action(self, act: tuple) -> None:
        kind = act[0]
        if kind == "grant":
            _, key, want = act
            try:
                addr = self.resolve(key)
                req_id = next(self._ids)
                type_, body = self._conn(addr).request(
                    p.encode_lease_grant(req_id, self.cache.client_id,
                                         key, want),
                    req_id, self._on_push)
                if type_ != p.T_LEASE_R:
                    raise p.ProtocolError(
                        f"unexpected lease response type {type_}")
                granted, lease_id, budget, ttl, limit, epoch = \
                    p.parse_lease_r(body)
                self.cache.on_grant(key, granted, lease_id, budget, ttl,
                                    limit, epoch)
                if granted:
                    self._granted_at[lease_id] = addr
            except Exception as exc:  # noqa: BLE001 — wire path covers
                log.debug("lease grant for %r failed: %s", key, exc)
                self.cache.grant_failed(key)
        elif kind == "renew":
            _, key, lease_id, delta, want = act
            try:
                addr = self._granted_at.get(lease_id) or self.resolve(key)
                req_id = next(self._ids)
                type_, body = self._conn(addr).request(
                    p.encode_lease_renew(req_id, self.cache.client_id,
                                         lease_id, key, delta, want),
                    req_id, self._on_push)
                if type_ != p.T_LEASE_R:
                    raise p.ProtocolError(
                        f"unexpected lease response type {type_}")
                granted, lease_id, top_up, ttl, limit, epoch = \
                    p.parse_lease_r(body)
                self.cache.on_renew(lease_id, granted, top_up, ttl,
                                    limit, epoch)
                if not granted:
                    self._granted_at.pop(lease_id, None)
            except Exception as exc:  # noqa: BLE001
                log.debug("lease renew %d failed: %s", lease_id, exc)
                self.cache.renew_failed(lease_id, delta)
        elif kind == "return":
            _, key, lease_id, delta = act
            addr = self._granted_at.pop(lease_id, None)
            if addr is None:
                try:
                    addr = self.resolve(key)
                except Exception:  # noqa: BLE001
                    return
            try:
                req_id = next(self._ids)
                self._conn(addr).request(
                    p.encode_lease_return(req_id, self.cache.client_id,
                                          lease_id, key, delta),
                    req_id, self._on_push)
            except Exception as exc:  # noqa: BLE001 — best effort: the
                # server-side TTL reaps an unreturned grant anyway.
                log.debug("lease return %d failed: %s", lease_id, exc)

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001 — keep ticking
                    log.warning("lease maintenance tick failed: %s", exc)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rl-lease-driver")
        self._thread.start()

    def close(self) -> None:
        """Stop the thread, hand every lease back (best effort), close
        the connections. Local answers stop the moment drain() empties
        the cache."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            for act in self.cache.drain():
                self._do_action(act)
            for conn in self._conns.values():
                conn.close()
            self._conns.clear()
            self._granted_at.clear()
