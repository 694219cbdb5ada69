"""Cross-process DCN exchange over the serving protocol — the port of
``ratelimiter_tpu/serving/dcn_peer.py``.

``parallel/dcn.py`` defines the exchange (completed sub-window slabs for
windowed limiters, accumulated debt deltas for token buckets) over plain
NumPy payloads; ``DcnMirrorGroup`` runs it in one process. This module is
the transport: each server process runs a ``DcnPusher`` per limiter (a
shard or a slice) that exports its new local history on a timer and
pushes it to every peer server as a ``T_DCN_PUSH`` frame; the receiving
door merges it into its limiters (``merge_push_payload``, called by both
of the port's doors).

Push-only and symmetric: every pod pushes to every peer on its own
cadence and nobody pulls. Slab watermarks are per peer and advance on
delivery, so a missed push is re-sent the next cycle (a period stays in
the ring for a whole window); a debt delta that no peer took is given
back to the accumulator, so a partition loses at most the interval of
a peer that failed while another took it. The JAX binary's wire
(serving/protocol.py, in the RLA2 envelope under a shared secret), so a
port pod and a JAX pod peer with each other. The chaos injector's
``dcn_frame`` hook drops or corrupts a push on its send path (the
dcn-partition and dcn-corrupt scenarios), as in the JAX module.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
from typing import List, Optional, Sequence, Tuple

from ratelimiter_tpu_torch.algorithms.sketch import (
    SketchLimiter,
    SketchTokenBucketLimiter,
)
from ratelimiter_tpu_torch.core.clock import to_micros
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.ops.sketch_kernels import sketch_geometry
from ratelimiter_tpu_torch.serving import protocol as p

log = logging.getLogger("ratelimiter_tpu_torch.serving.dcn")


def merge_push_payload(limiters: Sequence[SketchLimiter], body: bytes,
                       secret: Optional[str] = None,
                       guard: Optional[p.DcnReplayGuard] = None,
                       on_fleet=None, on_lease=None) -> None:
    """Check one T_DCN_PUSH body's envelope and merge its payload into
    every given limiter: the receive path of both doors (the asyncio
    door's one limiter or its mesh's slices, the native door's shards).

    ``guard`` refuses a stale or repeated sequenced envelope before any
    mass merges (a replayed push is a counter-mass injection, i.e.
    targeted false denies). Lease gossip (DCN_KIND_LEASE) goes to
    ``on_lease`` (the LeaseManager's ``on_gossip``), or is acknowledged
    and dropped without one. A fleet announce (DCN_KIND_FLEET) goes to
    ``on_fleet`` (the membership's ``handle_announce``) after its
    envelope verifies: an announce can move keyspace ownership, so it
    gets the same protection as counter mass. Without ``on_fleet`` it is
    refused: a server outside a fleet must not swallow ownership gossip.

    With several shards or slices the whole payload merges into each: a
    key is read on its owner alone, where the foreign mass is then
    present once; the copies elsewhere only add collision noise there
    (over-estimates, toward denying)."""
    from ratelimiter_tpu_torch.observability.decorators import undecorated
    from ratelimiter_tpu_torch.parallel.dcn import (
        merge_completed,
        merge_debt,
    )

    body = p.unwrap_dcn_auth(body, secret, guard)
    if body[:1] and body[0] == p.DCN_KIND_FLEET:
        if on_fleet is None:
            raise InvalidConfigError(
                "fleet announce received but this server is not a fleet "
                "member (--fleet-config)")
        on_fleet(p.parse_dcn_fleet(body[1:]))
        return
    if body[:1] and body[0] == p.DCN_KIND_LEASE:
        if on_lease is not None:
            on_lease(p.parse_dcn_lease(body[1:]))
        return
    lims = [undecorated(lim) for lim in limiters]
    lim0 = lims[0]
    if not isinstance(lim0, SketchLimiter):
        raise InvalidConfigError("DCN exchange needs a sketch-family backend")
    d, w = lim0.config.sketch.depth, lim0.config.sketch.width
    sub_us = (0 if isinstance(lim0, SketchTokenBucketLimiter)
              else sketch_geometry(lim0.config)[1])
    kind, a, b = p.parse_dcn(body, d, w, sub_us)
    for lim in lims:
        if kind == p.DCN_KIND_SLABS:
            merge_completed(lim, a, b)
        else:
            merge_debt(lim, a)


class _PeerConn:
    """One lazy, reconnecting frame connection to a peer server."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def push(self, frame: bytes, req_id: int) -> None:
        """Send one frame and wait for T_OK; raises on an error answer or
        a disconnect (the caller decides what the payload's loss costs)."""
        from ratelimiter_tpu_torch import chaos

        if chaos.INJECTOR is not None:
            # The dcn-partition scenario drops the frame here (raising,
            # so the pusher's retry and loss accounting see a real
            # delivery failure); corruption mutates it so the receiver's
            # HMAC path fires.
            mutated = chaos.INJECTOR.dcn_frame(frame)
            if mutated is None:
                raise ConnectionError("chaos: DCN frame dropped "
                                      "(injected partition)")
            frame = mutated
        try:
            sk = self._connect()
            sk.sendall(frame)
            buf = b""
            while len(buf) < p.HEADER_SIZE:
                chunk = sk.recv(65536)
                if not chunk:
                    raise ConnectionError("peer closed the connection")
                buf += chunk
            length, type_, rid = p.parse_header(buf[:p.HEADER_SIZE])
            body = buf[p.HEADER_SIZE:]
            while len(body) < length - 9:
                chunk = sk.recv(65536)
                if not chunk:
                    raise ConnectionError("peer closed the connection")
                body += chunk
            if rid != req_id:
                raise p.ProtocolError(f"response id {rid} != {req_id}")
            if type_ == p.T_ERROR:
                code, msg = p.parse_error(body)
                raise p.exception_for(code, msg)
        except Exception:
            self.close()   # reconnect next cycle
            raise


class DcnPusher:
    """Export the limiter's new local history every ``interval`` seconds
    and push it to every peer (host, port). A thread, so it serves both
    doors' processes alike."""

    def __init__(self, limiter: SketchLimiter,
                 peers: Sequence[Tuple[str, int]], *,
                 interval: float = 1.0,
                 secret: Optional[str] = None):
        self.limiter = limiter
        self.secret = secret
        self.peers: List[_PeerConn] = [_PeerConn(h, pt) for h, pt in peers]
        self.interval = float(interval)
        self._bucket = isinstance(limiter, SketchTokenBucketLimiter)
        # Per peer, advanced on delivery only: a peer that missed a cycle
        # is sent the same periods again, one that merged them never is
        # (a second merge of a period would count it twice).
        self._watermarks: List[int] = [-(1 << 62)] * len(self.peers)
        self._sub_us = (0 if self._bucket
                        else sketch_geometry(limiter.config)[1])
        sk = limiter.config.sketch
        self._slab_bytes = sk.depth * sk.width * 4
        self._payload_budget = (p.MAX_DCN_FRAME - 4096) // 2
        if not self._bucket and self._slab_bytes > self._payload_budget:
            raise ValueError(
                f"sketch geometry too large for the DCN transport: one "
                f"slab is {self._slab_bytes >> 20} MiB vs the "
                f"{self._payload_budget >> 20} MiB frame budget")
        if self._bucket and sk.depth * sk.width * 8 > p.MAX_DCN_FRAME - 4096:
            raise ValueError(
                "sketch geometry too large for the DCN debt transport "
                f"(delta is {(sk.depth * sk.width * 8) >> 20} MiB)")
        # The RLA2 envelope's sender id: random per incarnation, so no
        # receiver's watermark can block a restarted pusher; the guard's
        # freshness window covers the previous one.
        import secrets as _secrets

        self._sender = _secrets.randbits(64)
        self._last_seq = 0
        self._ids = itertools.count(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pushes_ok = 0
        self.pushes_failed = 0

    def _next_seq(self) -> int:
        """A strictly increasing sequence that tracks wall-clock
        microseconds: receivers read it as a coarse timestamp for the
        first-contact freshness check, so a mere counter would fall
        behind and a restarted receiver would refuse a long-running
        sender as stale."""
        import time as _time

        self._last_seq = max(self._last_seq + 1, int(_time.time() * 1e6))
        return self._last_seq

    def _seq(self):
        return self._next_seq() if self.secret is not None else None

    # ------------------------------------------------------------- cycle

    def sync_once(self) -> int:
        """One export and push cycle; returns the peers delivered to.
        Never raises: each peer's failure is counted and logged."""
        from ratelimiter_tpu_torch.parallel import dcn

        req_id = next(self._ids)
        delivered = 0
        # With the flight recorder on, a cycle mints one trace id and
        # sends it in the frame's trace extension (outside the HMAC), so
        # the sender's push span and the receiver's merge share an id.
        rec = tracing.RECORDER
        cycle_trace = tracing.new_trace_id() if rec is not None else 0

        def traced(frame: bytes) -> bytes:
            return p.with_trace(frame, cycle_trace) if cycle_trace else frame

        def push_span(peer, frame) -> None:
            t0 = tracing.now() if rec is not None else 0
            peer.push(frame, req_id)
            if rec is not None:
                rec.record("dcn", t0, tracing.now(), trace_id=cycle_trace)

        if self._bucket:
            delta = dcn.export_debt(self.limiter)
            if not delta.any():
                return 0
            frame = traced(p.encode_dcn_debt(
                req_id, delta, secret=self.secret, sender=self._sender,
                seq=self._seq()))
            for peer in self.peers:
                try:
                    push_span(peer, frame)
                    delivered += 1
                    self.pushes_ok += 1
                except Exception as exc:
                    self.pushes_failed += 1
                    log.warning("DCN push to %s:%d failed: %s",
                                peer.host, peer.port, exc)
            if delivered == 0 and self.peers:
                # Every push failed (a partition): the next cycle ships
                # it again. On a partial failure it is not given back:
                # the peers that took it must not take it twice.
                dcn.restore_debt(self.limiter, delta)
            return delivered
        # Roll the ring on the export's cadence too: a quiet limiter
        # would otherwise never complete its sub-window, and a burst
        # followed by silence would never ship.
        with self.limiter._lock:
            self.limiter._sync_period(to_micros(self.limiter.clock.now()))
        # A window change renumbers periods: the stored watermarks mean
        # nothing after it, so they restart at "everything before now"
        # (at most one window skipped, the migration's loss); peers
        # refuse frames of the other sub-window until they migrate too.
        epoch_sub = sketch_geometry(self.limiter.config)[1]
        if epoch_sub != self._sub_us:
            log.warning("DCN pusher: window changed (sub %dus -> %dus); "
                        "resetting peer watermarks", self._sub_us, epoch_sub)
            self._sub_us = epoch_sub
            with self.limiter._lock:
                last_now = int(self.limiter._state["last_period"])
            self._watermarks = [last_now - 1] * len(self.peers)
        # One export a cycle, at the laggiest watermark, sliced per peer.
        periods, slabs, last = dcn.export_completed(
            self.limiter, min(self._watermarks))
        if periods.shape[0] == 0:
            return 0
        # Chunked so no frame exceeds the DCN cap (at least one slab a
        # frame; a geometry too big for that was refused above).
        per_frame = max(1, self._payload_budget // self._slab_bytes)
        for i, peer in enumerate(self.peers):
            sel = periods > self._watermarks[i]
            if not sel.any():
                continue
            pp, ss = periods[sel], slabs[sel]
            ok = True
            sent_up_to = self._watermarks[i]
            for s0 in range(0, pp.shape[0], per_frame):
                frame = traced(p.encode_dcn_slabs(
                    req_id, pp[s0:s0 + per_frame], ss[s0:s0 + per_frame],
                    self._sub_us, secret=self.secret, sender=self._sender,
                    seq=self._seq()))
                try:
                    push_span(peer, frame)
                    self.pushes_ok += 1
                    # Periods ascend: the watermark follows the last
                    # delivered chunk, so a partial failure never sends
                    # (or merges) a delivered chunk twice.
                    sent_up_to = int(pp[min(s0 + per_frame, len(pp)) - 1])
                except Exception as exc:
                    self.pushes_failed += 1
                    ok = False
                    log.warning("DCN push to %s:%d failed: %s",
                                peer.host, peer.port, exc)
                    break
            if ok:
                delivered += 1
                sent_up_to = last - 1
            self._watermarks[i] = max(self._watermarks[i], sent_up_to)
        return delivered

    # ------------------------------------------------------- lease gossip

    def push_lease(self, payload: dict) -> int:
        """Send a lease revocation to every peer now (a revocation cannot
        wait for the next cycle). Best effort: failures are counted and
        logged, never raised (the holders' TTL bounds a lost one).
        Returns the peers reached."""
        req_id = next(self._ids)
        frame = p.encode_dcn_lease(req_id, payload, secret=self.secret,
                                   sender=self._sender, seq=self._seq())
        delivered = 0
        for peer in self.peers:
            try:
                peer.push(frame, req_id)
                delivered += 1
                self.pushes_ok += 1
            except Exception as exc:
                self.pushes_failed += 1
                log.warning("lease gossip to %s:%d failed: %s",
                            peer.host, peer.port, exc)
        return delivered

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.sync_once()
                except Exception as exc:  # an export must never kill it
                    log.error("DCN cycle failed: %s", exc)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rl-dcn-pusher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for peer in self.peers:
            peer.close()


def parse_peer(spec: str) -> Tuple[str, int]:
    """'host:port' -> (host, port), refusing anything else."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"peer must be host:port, got {spec!r}")
    return host or "127.0.0.1", int(port)
