"""The port's rate-limit service: an asyncio TCP door over a micro-batcher.

A copy of the socket door of ``ratelimiter_tpu/serving/server.py``,
trimmed to the frames this slice serves:

* every decision frame from every connection funnels into ONE
  MicroBatcher (serving/batcher.py), so concurrent clients share device
  dispatches, with up to ``inflight`` launches in flight;
* ALLOW_N, ALLOW_HASHED and ALLOW_BATCH take the zero-task path: the
  frame is queued into the batcher and its reply is written from the
  future's done callback. Replies carry request ids and may return out
  of order: clients pipeline, the server coalesces;
* RESET, HEALTH, METRICS (Prometheus text of the door's registry: the
  batcher's families, and whatever the decorator stack around the
  limiter registers there, e.g. ``MetricsDecorator``'s, with the side
  table's top-K consumer gauges), the policy frames (POLICY_SET/GET/DEL, answered with POLICY_R) and SNAPSHOT
  run as one task each. Reset and the policy mutations are not batched:
  they are rare, and their semantics are "take effect before any later
  decision", which the limiter's lock gives; they run in the loop's
  default executor, and so does SNAPSHOT (``snapshot=``, the persistence
  manager's ``snapshot_now``: its capture takes the limiter lock and its
  write fsyncs). Without ``snapshot`` SNAPSHOT is answered with
  E_INVALID_CONFIG;
* a connection whose write buffer passes WRITE_BUFFER_LIMIT is dropped.

Every request frame goes through ``protocol.split_request``: the trace
extension's id samples the frame into the flight recorder (the door
records its ``io`` span, parse to enqueue, and its ``encode`` span; the
batcher the stages between), and the deadline extension's relative
budget, anchored to the frame's arrival, lets the batcher shed the
frame once it expires. RESET and the policy mutations are journaled
(observability/events.py, ``actor="binary"``, keys as ``key_token``s).
Every decision the door serves goes through the batcher, whose audit
tap mirrors it to the shadow auditor when one is enabled
(serving/batcher.py), as in the JAX asyncio door.

Transports, as in the JAX door: TCP, a unix socket (``host`` given as
``unix:/path``), and with ``shm=True`` the shared-memory lane
(serving/shm.py): a connected client sends SHM_HELLO, matched on the raw
type byte, and its connection is upgraded to a pair of rings in
``shm_dir`` carrying the same frames; the socket stays open as the
liveness channel, and its close reclaims the rings. ``transport_stats()``
and the transport gauges it feeds at scrape time
(``rate_limiter_transport_connections``, the shared-memory lane's and
``rate_limiter_net_writev_frames``) are the JAX door's.

Quota leases, as in the JAX door: with ``leases=`` (a
``leases.LeaseManager``) LEASE_GRANT/RENEW/RETURN are served on this
port (``leases.listener.serve_lease_frame`` in the executor: a grant's
debit goes through the binary's thread-safe batcher bridge), a policy
set/delete and a RESET revoke the key's leases, revocations are pushed
as rid-0 LEASE_REVOKE frames down the granting connection (TCP, the
unix socket or the reply ring), and shutdown pushes a revoke-all while
the connections are still open. Without ``leases`` the lease frames
are answered E_INVALID_CONFIG. ``--backend mesh`` serves the composite
limiter (the sliced mesh with either router) through this door.

Cross-pod DCN pushes, as in the JAX door: with ``dcn=True`` a DCN_PUSH
frame may be up to ``protocol.MAX_DCN_FRAME`` long (every other frame,
and every frame of a server without it, keeps ``MAX_FRAME``) and is
merged in the executor into every dispatch unit of the limiter
(``sub_limiters()``: the one limiter, or the mesh's slices) through
``dcn_peer.merge_push_payload``; with ``dcn_secret`` a push must carry a
valid RLA2 envelope whose (sender, seq) the door's replay guard has not
seen. Lease gossip in a push goes to ``leases``. Without ``dcn`` a push
is answered E_INVALID_CONFIG.

The fleet, as in the JAX door: with ``fleet=`` (a ``fleet.FleetCore``)
FLEET_MAP answers the member's ownership map; with forwarding off
(redirect-only mode) a decision frame holding a row this member does not
own is answered E_NOT_OWNER at the door; a hashed frame carrying the
forward hint (a peer's forward window) coalesces apart from client
frames (serving/batcher.py); and a fleet announce in a DCN push goes to
``fleet_announce`` (``FleetMembership.handle_announce``). The serving
limiter is then a ``fleet.FleetForwarder``.

The native door is serving/native_server.py, and the HTTP gateway and
gRPC run beside either door in the binary (serving/http_gateway.py,
serving/grpc_server.py, serving/__main__.py).
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import time
from functools import partial
from typing import Callable, Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.observability import events
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.ops.hashing import key_token, splitmix64
from ratelimiter_tpu_torch.serving import protocol as p
from ratelimiter_tpu_torch.serving import shm as shm_lane
from ratelimiter_tpu_torch.serving.batcher import MicroBatcher

log = logging.getLogger("ratelimiter_tpu_torch")

# A connection whose transport write buffer grows past this is a slow
# reader that keeps pipelining: drop it rather than buffer without bound
# (the read side is already frame-capped by the protocol).
WRITE_BUFFER_LIMIT = 8 * 1024 * 1024


class RateLimitServer:
    def __init__(self, limiter: RateLimiter, host: str = "127.0.0.1",
                 port: int = 0, *, max_batch: int = 4096,
                 max_delay: float = 200e-6,
                 dispatch_timeout: Optional[float] = None,
                 inflight: int = 8,
                 registry: Optional[m.Registry] = None,
                 snapshot: Optional[Callable[[], dict]] = None,
                 max_window: Optional[int] = None, shm: bool = False,
                 shm_dir: str = "/dev/shm", shm_ring_bytes: int = 0,
                 leases=None, dcn: bool = False,
                 dcn_secret: Optional[str] = None,
                 fleet=None, fleet_announce: Optional[Callable] = None):
        self.limiter = limiter
        #: Fleet routing core: answers FLEET_MAP and, with forwarding
        #: off, checks decision frames at the door so a foreign frame
        #: gets its typed E_NOT_OWNER redirect.
        self.fleet = fleet
        #: Fleet announce sink (FleetMembership.handle_announce).
        self.fleet_announce = fleet_announce
        #: Take DCN pushes (and their larger frame cap); off by default,
        #: so that a plain deployment keeps the 1 MiB bound on every
        #: frame. With ``dcn_secret`` a push must carry a valid RLA2
        #: envelope.
        self.dcn = dcn
        self.dcn_secret = dcn_secret
        #: Per-sender sequence watermarks of the RLA2 envelope.
        self._dcn_guard = p.DcnReplayGuard() if dcn else None
        #: LeaseManager; None answers the lease frames E_INVALID_CONFIG.
        self.leases = leases
        #: The shared-memory lane: off by default, and then SHM_HELLO
        #: answers E_INVALID_CONFIG. ``host`` may be ``unix:/path`` for
        #: a unix-socket listener on either setting.
        self.shm = shm
        self.shm_dir = shm_dir
        self.shm_ring_bytes = shm_ring_bytes
        self._shm_lanes: set = set()
        self._lane_ctr = 0
        self._uds_path: Optional[str] = None
        #: Counters carried over from closed lanes, so scrapes stay
        #: monotonic across disconnects.
        self._shm_totals = {"doorbell_wakes": 0, "spin_hits": 0,
                            "ring_full_stalls": 0, "records_in": 0,
                            "records_out": 0}
        #: Durability trigger (the persistence manager's snapshot_now);
        #: None answers SNAPSHOT with E_INVALID_CONFIG.
        self.snapshot = snapshot
        self.host = host
        self.port = port
        self.registry = registry if registry is not None else m.DEFAULT
        self.batcher = MicroBatcher(
            limiter, max_batch=max_batch, max_delay=max_delay,
            dispatch_timeout=dispatch_timeout, inflight=inflight,
            registry=self.registry, max_window=max_window)
        self._server: Optional[asyncio.AbstractServer] = None
        self._started_at = time.time()
        self._serving = False
        self._conn_tasks: set = set()
        #: Connections accepted per transport (cumulative).
        self._transport_conns = {"tcp": 0, "uds": 0, "shm": 0}
        #: Hashed and batch replies flushed as several buffers (the JAX
        #: door's rate_limiter_net_writev_frames).
        self._writev_frames = 0

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self.host.startswith("unix:"):
            path = self.host[len("unix:"):]
            try:
                os.unlink(path)
            except OSError:
                pass
            self._server = await asyncio.start_unix_server(
                self._handle_conn, path)
            self._uds_path = path
            self.port = 0
        else:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        self._started_at = time.time()
        self._serving = True
        self.registry.add_collect_hook(self._collect_transport_metrics)

    async def shutdown(self) -> None:
        """Graceful: stop accepting, answer what is in flight (drain the
        batcher), then close the connections and the batcher. The
        listener's ``wait_closed`` comes after the connections are
        closed: since Python 3.12 it waits for every open connection,
        and a client that keeps its connection (a DCN peer's pusher)
        would hold the shutdown forever."""
        self._serving = False
        if self._server is not None:
            self._server.close()
        if self.leases is not None:
            # Push revoke-all while the granting connections are still
            # open: holders stop answering locally instead of spending
            # leased budget against a server that is gone.
            await asyncio.get_running_loop().run_in_executor(
                None, self.leases.revoke_all, p.LEASE_REV_SHUTDOWN)
        await self.batcher.drain()
        for t in list(self._conn_tasks):
            t.cancel()
        await asyncio.gather(*list(self._conn_tasks), return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
        self.batcher.close()
        self.registry.remove_collect_hook(self._collect_transport_metrics)
        for lane in list(self._shm_lanes):
            lane.close()
        self._shm_lanes.clear()
        if self._uds_path is not None:
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.serve_forever()

    def transport_stats(self) -> dict:
        """Per-transport counters and the shared-memory lanes' gauges,
        the JAX door's shape. Snapshot reads only, never called from the
        decide path (the registry's collect hook and /healthz read
        it)."""
        agg = dict(self._shm_totals)
        active = req_used = rep_used = req_hw = rep_hw = 0
        for lane in list(self._shm_lanes):
            st = lane.stats
            agg["doorbell_wakes"] += st.doorbell_wakes
            agg["spin_hits"] += st.spin_hits
            agg["ring_full_stalls"] += st.ring_full_stalls
            agg["records_in"] += st.records_in
            agg["records_out"] += st.records_out
            if lane.closed:
                continue
            active += 1
            try:
                req_used += lane.inbound.used()
                rep_used += lane.outbound.used()
                req_hw = max(req_hw, lane.req_highwater)
                rep_hw = max(rep_hw, lane.outbound.highwater)
            except ValueError:
                pass
        return {
            "connections": dict(self._transport_conns),
            "shm": {"lanes_active": active,
                    "req_ring_used_bytes": int(req_used),
                    "rep_ring_used_bytes": int(rep_used),
                    "req_ring_highwater_bytes": int(req_hw),
                    "rep_ring_highwater_bytes": int(rep_hw),
                    **agg},
        }

    def _collect_transport_metrics(self) -> None:
        st = self.transport_stats()
        g = self.registry.gauge(
            "rate_limiter_transport_connections",
            "Connections accepted per transport (cumulative)")
        for k, v in st["connections"].items():
            g.set(v, transport=k)
        sh = st["shm"]
        self.registry.gauge(
            "rate_limiter_shm_lanes_active",
            "Live shared-memory lanes (ADR-025)").set(sh["lanes_active"])
        self.registry.gauge(
            "rate_limiter_shm_doorbell_wakes",
            "eventfd wakeups taken by shm ring consumers").set(
                sh["doorbell_wakes"])
        self.registry.gauge(
            "rate_limiter_shm_spin_hits",
            "shm records claimed during the bounded spin (no syscall)"
        ).set(sh["spin_hits"])
        self.registry.gauge(
            "rate_limiter_shm_ring_full_stalls",
            "shm ring-full backpressure stalls").set(
                sh["ring_full_stalls"])
        rg = self.registry.gauge(
            "rate_limiter_shm_records",
            "Frames carried over shm rings, by direction")
        rg.set(sh["records_in"], direction="in")
        rg.set(sh["records_out"], direction="out")
        ug = self.registry.gauge(
            "rate_limiter_shm_ring_used_bytes",
            "Current shm ring occupancy, summed over lanes")
        ug.set(sh["req_ring_used_bytes"], ring="req")
        ug.set(sh["rep_ring_used_bytes"], ring="rep")
        hg = self.registry.gauge(
            "rate_limiter_shm_ring_highwater_bytes",
            "High-water shm ring occupancy across lanes")
        hg.set(sh["req_ring_highwater_bytes"], ring="req")
        hg.set(sh["rep_ring_highwater_bytes"], ring="rep")
        self.registry.gauge(
            "rate_limiter_net_writev_frames",
            "Reply frames flushed through a vectored write "
            "(writev/writelines batch factor)").set(
                self._writev_frames)

    async def _shm_accept(self, lane, writer: asyncio.StreamWriter,
                          drain_cb, recheck_cb) -> None:
        """Second half of the hello: wait for the client's control-socket
        connect, ship the eventfd pair (SCM_RIGHTS), unlink the
        filesystem artifacts, then register the server doorbell with the
        event loop. A client that never connects forfeits the lane. Then,
        for the lane's life, run ``recheck_cb`` every ``shm.RECHECK_S``:
        a doorbell lost by either side (a client that does not fence its
        publish against its flag read) costs one period, never a stall."""
        loop = asyncio.get_running_loop()
        try:
            conn, _ = await asyncio.wait_for(
                loop.sock_accept(lane.ctrl_sock), timeout=10.0)
            lane.complete_handshake(conn)
        except Exception as exc:
            log.warning("shm handshake failed: %s", exc)
            lane.close()
            return
        if lane.closed or writer.is_closing():
            return
        loop.add_reader(lane.efd_server, drain_cb)
        while not lane.closed and not writer.is_closing():
            await asyncio.sleep(shm_lane.RECHECK_S)
            recheck_cb()

    # ---------------------------------------------------------- connection

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        write_lock = asyncio.Lock()
        req_tasks: set = set()
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        sock = writer.get_extra_info("socket")
        self._transport_conns["uds" if sock is not None
                              and sock.family == socket.AF_UNIX
                              else "tcp"] += 1
        # The shared-memory lane, once SHM_HELLO upgraded the
        # connection; the socket this coroutine reads stays open as the
        # liveness channel, so its finally block reclaims the rings.
        lane_box: list = []
        lane_tasks: set = set()

        def check_backpressure() -> None:
            transport = writer.transport
            if transport.get_write_buffer_size() > WRITE_BUFFER_LIMIT:
                log.warning(
                    "dropping slow-reader connection (%d bytes buffered)",
                    transport.get_write_buffer_size())
                transport.abort()

        def write_vec(bufs, vec: bool = False) -> None:
            # Done-callback writer: never blocks the loop; broken pipes
            # surface in the reader loop, which owns teardown. Callbacks
            # cannot await drain(), so a client that pipelines but reads
            # slowly is cut off past WRITE_BUFFER_LIMIT instead. ``vec``
            # marks the frames the JAX door writes vectored (hashed and
            # batch results), which its writev counter counts.
            if writer.is_closing():
                return  # the connection is gone (its reader owns teardown)
            try:
                writer.writelines(bufs)
                if vec:
                    self._writev_frames += 1
                check_backpressure()
            except (ConnectionResetError, BrokenPipeError, RuntimeError):
                pass

        def shm_abort(reason: str) -> None:
            log.warning("dropping shm connection: %s", reason)
            if lane_box:
                try:
                    asyncio.get_running_loop().remove_reader(
                        lane_box[0].efd_server)
                except (OSError, RuntimeError):
                    pass
            if writer.transport is not None:
                writer.transport.abort()

        def shm_vec(bufs, vec: bool = False) -> None:
            # Every reply of an upgraded connection rides the reply ring
            # as one record (the columnar views joined: the lane's one
            # reply copy). A peer that stops draining gets the socket
            # path's slow-reader cut.
            if not lane_box[0].send(b"".join(bytes(b) for b in bufs)):
                shm_abort("shm reply overflow (slow reader)")

        def complete_allow(out, req_id: int, trace_id: int,
                           fut: asyncio.Future) -> None:
            exc = fut.exception()
            if exc is not None:
                out([p.encode_error(req_id, p.code_for(exc), str(exc))])
                return
            rec = tracing.RECORDER
            t0 = tracing.now() if rec is not None else 0
            out([p.encode_result(req_id, fut.result())])
            if rec is not None:
                rec.record("encode", t0, tracing.now(), trace_id=trace_id)

        def complete_hashed(out, req_id: int, trace_id: int,
                            fut: asyncio.Future) -> None:
            exc = fut.exception()
            if exc is not None:
                out([p.encode_error(req_id, p.code_for(exc), str(exc))])
                return
            rec = tracing.RECORDER
            t0 = tracing.now() if rec is not None else 0
            res = fut.result()
            out(p.encode_result_hashed_views(req_id, res), vec=True)
            if rec is not None:
                rec.record("encode", t0, tracing.now(), trace_id=trace_id,
                           batch=len(res))

        def complete_batch(out, req_id: int, trace_id: int,
                           agg: asyncio.Future) -> None:
            exc = agg.exception()
            if exc is not None:
                out([p.encode_error(req_id, p.code_for(exc), str(exc))])
                return
            rec = tracing.RECORDER
            t0 = tracing.now() if rec is not None else 0
            results = agg.result()
            out(p.encode_result_batch_views(
                req_id, self.limiter.config.limit, results), vec=True)
            if rec is not None:
                rec.record("encode", t0, tracing.now(), trace_id=trace_id,
                           batch=len(results))

        def dispatch(type_: int, req_id: int, trace_id: int, budget,
                     body: bytes, out, frame_out) -> None:
            """One request frame, its extensions stripped, answered
            through ``out`` (a buffer list writer: the socket's or the
            reply ring's)."""
            # The forward hint: a peer's forward window, dispatched
            # apart from client frames so its reply never waits on this
            # member's own forward legs.
            type_, fwd_hint = p.split_forward(type_)
            redirect = (self.fleet is not None
                        and not self.fleet.forward_enabled)
            # None = no deadline; a budget <= 0 anchors in the past
            # (expired on arrival: shed at the first check).
            deadline = (time.monotonic() + budget
                        if budget is not None else 0.0)
            rec = tracing.RECORDER
            t_io = tracing.now() if rec is not None else 0
            if type_ == p.T_ALLOW_N:
                try:
                    key, n = p.parse_allow_n(body)
                    if redirect:
                        self.fleet.check_frame_owned(
                            self.fleet.hash_keys([key]))
                    fut = self.batcher.submit_nowait(key, n, trace_id,
                                                     deadline)
                except Exception as exc:
                    out([p.encode_error(req_id, p.code_for(exc), str(exc))])
                    return
                if rec is not None:
                    rec.record("io", t_io, tracing.now(), trace_id=trace_id)
                fut.add_done_callback(
                    partial(complete_allow, out, req_id, trace_id))
                return
            if type_ == p.T_ALLOW_HASHED:
                try:
                    ids, ns = p.parse_allow_hashed(body)
                    if redirect:
                        self.fleet.check_frame_owned(splitmix64(ids))
                    fut = self.batcher.submit_hashed_nowait(
                        ids, ns, trace_id, deadline, standalone=fwd_hint)
                except Exception as exc:
                    out([p.encode_error(req_id, p.code_for(exc), str(exc))])
                    return
                if rec is not None:
                    rec.record("io", t_io, tracing.now(), trace_id=trace_id,
                               batch=int(ids.shape[0]))
                fut.add_done_callback(
                    partial(complete_hashed, out, req_id, trace_id))
                return
            if type_ == p.T_ALLOW_BATCH:
                try:
                    keys, ns = p.parse_allow_batch(body)
                    if redirect:
                        self.fleet.check_frame_owned(
                            self.fleet.hash_keys(keys))
                    futs = self.batcher.submit_many_nowait(
                        zip(keys, ns), trace_id, deadline)
                except Exception as exc:
                    out([p.encode_error(req_id, p.code_for(exc), str(exc))])
                    return
                if rec is not None:
                    rec.record("io", t_io, tracing.now(), trace_id=trace_id,
                               batch=len(keys))
                agg = asyncio.gather(*futs)
                agg.add_done_callback(
                    partial(complete_batch, out, req_id, trace_id))
                return
            # Control frames (rare): one task each.
            t = asyncio.ensure_future(self._handle_frame(
                type_, req_id, body, writer, write_lock, out_fn=frame_out))
            req_tasks.add(t)
            t.add_done_callback(req_tasks.discard)

        def shm_dispatch(frame: bytes) -> None:
            # One committed ring record is one wire frame, byte-identical
            # to what the socket loop below would read; replies go back
            # through the reply ring.
            try:
                length, rtype, req_id = p.parse_header(
                    frame, allow_dcn=self.dcn)
                if len(frame) != length + 4:
                    raise p.ProtocolError("ring record length mismatch")
                body = frame[p.HEADER_SIZE:]
                if rtype == p.T_SHM_HELLO:
                    shm_vec([p.encode_error(req_id, p.E_INVALID_CONFIG,
                                            "shm lane already active")])
                    return
                type_, trace_id, budget, body = p.split_request(rtype, body)
            except p.ProtocolError as exc:
                shm_abort(f"shm protocol error: {exc}")
                return
            dispatch(type_, req_id, trace_id, budget, body, shm_vec,
                     lambda frame: shm_vec([frame]))

        def shm_drain(recheck: bool = False) -> None:
            lane = lane_box[0]
            try:
                if recheck:
                    lane.recheck(shm_dispatch)
                else:
                    lane.drain(shm_dispatch)
            except shm_lane.ShmProtocolError as exc:
                # A torn or poisoned record: stop trusting the mapping
                # and reclaim through the liveness socket (a client
                # killed mid-write never stalls the door).
                shm_abort(f"shm lane poisoned: {exc}")

        def shm_hello(req_id: int, body: bytes) -> None:
            if not self.shm:
                write_vec([p.encode_error(
                    req_id, p.E_INVALID_CONFIG,
                    "shm lane not enabled on this server (--shm)")])
                return
            if lane_box:
                write_vec([p.encode_error(
                    req_id, p.E_INVALID_CONFIG,
                    "shm lane already active on this connection")])
                return
            try:
                _ver, req_bytes, rep_bytes = p.parse_shm_hello(body)
                req_cap = shm_lane.clamp_ring_bytes(
                    req_bytes or self.shm_ring_bytes)
                rep_cap = shm_lane.clamp_ring_bytes(
                    rep_bytes or self.shm_ring_bytes)
                self._lane_ctr += 1
                lane = shm_lane.ServerLane(
                    self.shm_dir, req_cap, rep_cap,
                    tag="a%d-" % self._lane_ctr)
            except Exception as exc:
                write_vec([p.encode_error(req_id, p.code_for(exc),
                                          str(exc))])
                return
            lane_box.append(lane)
            self._shm_lanes.add(lane)
            self._transport_conns["shm"] += 1
            t = asyncio.ensure_future(
                self._shm_accept(lane, writer, shm_drain,
                                 partial(shm_drain, recheck=True)))
            lane_tasks.add(t)
            t.add_done_callback(lane_tasks.discard)
            write_vec([p.encode_shm_hello_r(
                req_id, lane.req_cap, lane.rep_cap, lane.path,
                lane.ctrl_path)])

        try:
            while True:
                try:
                    hdr = await reader.readexactly(p.HEADER_SIZE)
                    length, type_, req_id = p.parse_header(
                        hdr, allow_dcn=self.dcn)
                    body = await reader.readexactly(length - 9)
                    # The lane's upgrade: an exact match on the raw type
                    # byte, before any flag is stripped.
                    if type_ == p.T_SHM_HELLO:
                        shm_hello(req_id, body)
                        continue
                    # Frame extensions: the trace id and the deadline's
                    # relative budget, anchored to arrival on the local
                    # monotonic clock.
                    type_, trace_id, budget, body = p.split_request(
                        type_, body)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                except p.ProtocolError as exc:
                    log.warning("protocol error, dropping connection: %s", exc)
                    break
                dispatch(type_, req_id, trace_id, budget, body, write_vec,
                         None)
        finally:
            for t in list(lane_tasks):
                t.cancel()
            if lane_tasks:
                await asyncio.gather(*list(lane_tasks),
                                     return_exceptions=True)
            if lane_box:
                # The liveness socket closed (or the lane was poisoned):
                # unmap, close the eventfds and drop any files left now.
                lane = lane_box[0]
                try:
                    asyncio.get_running_loop().remove_reader(
                        lane.efd_server)
                except (OSError, RuntimeError):
                    pass
                for k in self._shm_totals:
                    self._shm_totals[k] += getattr(lane.stats, k)
                self._shm_lanes.discard(lane)
                lane.close()
            if req_tasks:
                await asyncio.gather(*list(req_tasks), return_exceptions=True)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            self._conn_tasks.discard(task)

    async def _handle_policy(self, type_: int, req_id: int,
                             body: bytes) -> bytes:
        """Tiered-override management: SET stores an override, GET reads
        it, DEL returns the key to the default tier. All answer POLICY_R.
        Mutations run off the event loop, like reset (they take the
        limiter lock and, with persistence, append to the WAL)."""
        loop = asyncio.get_running_loop()
        if type_ == p.T_POLICY_SET:
            key, limit, scale = p.parse_policy_set(body)
            ov = await loop.run_in_executor(
                None, lambda: self.limiter.set_override(
                    key, limit, window_scale=scale))
            events.emit("policy", "set-override", actor="binary",
                        payload={"key_hash": key_token(key),
                                 "limit": int(ov.limit),
                                 "window_scale": float(ov.window_scale)})
            if self.leases is not None:
                # Outstanding grants were budgeted under the old limit:
                # revoke, so holders re-lease under the new one.
                await loop.run_in_executor(
                    None, self.leases.revoke_key, key, p.LEASE_REV_POLICY)
            return p.encode_policy_r(req_id, True, ov.limit,
                                     ov.window_scale)
        key = p.parse_reset(body)
        if type_ == p.T_POLICY_GET:
            ov = self.limiter.get_override(key)
            if ov is None:
                return p.encode_policy_r(
                    req_id, False, self.limiter.config.limit, 1.0)
            return p.encode_policy_r(req_id, True, ov.limit,
                                     ov.window_scale)
        existed = await loop.run_in_executor(
            None, self.limiter.delete_override, key)
        events.emit("policy", "delete-override", actor="binary",
                    payload={"key_hash": key_token(key),
                             "deleted": bool(existed)})
        if existed and self.leases is not None:
            await loop.run_in_executor(
                None, self.leases.revoke_key, key, p.LEASE_REV_POLICY)
        return p.encode_policy_r(req_id, bool(existed),
                                 self.limiter.config.limit, 1.0)

    async def _handle_lease(self, type_: int, req_id: int, body: bytes,
                            writer: asyncio.StreamWriter, out_fn) -> bytes:
        """One lease frame, served in the executor (a grant's debit
        waits for its dispatch). The manager keeps ``push``, the
        granting connection's writer, for the revocation pushes."""
        if self.leases is None:
            return p.encode_error(
                req_id, p.E_INVALID_CONFIG,
                "leases not enabled on this server (--leases)")
        from ratelimiter_tpu_torch.leases.listener import serve_lease_frame

        loop = asyncio.get_running_loop()

        def push(frame: bytes) -> None:
            # Called from any thread: marshalled onto the loop. A closed
            # connection raises, and the manager counts the failed push
            # (the holder's TTL still bounds it). On a lane the push
            # rides the reply ring like every other frame.
            if writer.is_closing():
                raise ConnectionError("lease push: connection closed")
            loop.call_soon_threadsafe(
                out_fn if out_fn is not None else writer.write, frame)

        return await loop.run_in_executor(
            None, serve_lease_frame, self.leases, type_, req_id, body, push)

    async def _handle_dcn(self, req_id: int, body: bytes) -> bytes:
        """Merge one push into every dispatch unit (a sliced mesh's
        slices: keys hash-route across them), in the executor: the merge
        takes each unit's lock and copies to its device."""
        from ratelimiter_tpu_torch.observability.decorators import undecorated
        from ratelimiter_tpu_torch.serving.dcn_peer import merge_push_payload

        lims = undecorated(self.limiter).sub_limiters()
        on_lease = self.leases.on_gossip if self.leases is not None else None

        def merge() -> None:
            merge_push_payload(lims, body, self.dcn_secret,
                               self._dcn_guard, on_fleet=self.fleet_announce,
                               on_lease=on_lease)
            if self.leases is not None and self.fleet is not None:
                # A fleet announce may have installed a newer epoch:
                # revoke grants over ranges this member no longer owns
                # before the next local answer spends them.
                self.leases.check_epoch()

        await asyncio.get_running_loop().run_in_executor(None, merge)
        return p.encode_ok(req_id)

    async def _handle_frame(self, type_: int, req_id: int, body: bytes,
                            writer: asyncio.StreamWriter,
                            write_lock: asyncio.Lock,
                            out_fn=None) -> None:
        try:
            if type_ == p.T_RESET:
                key = p.parse_reset(body)
                # Off the event loop: reset takes the limiter lock.
                await asyncio.get_running_loop().run_in_executor(
                    None, self.limiter.reset, key)
                events.emit("policy", "reset", actor="binary",
                            payload={"key_hash": key_token(key)})
                if self.leases is not None:
                    # The reset zeroes the counter the grants' mass
                    # lives in; leased tokens spent after it would not
                    # show there, so the key's leases are revoked.
                    await asyncio.get_running_loop().run_in_executor(
                        None, self.leases.revoke_key, key,
                        p.LEASE_REV_MANUAL)
                out = p.encode_ok(req_id)
            elif type_ in (p.T_POLICY_SET, p.T_POLICY_GET, p.T_POLICY_DEL):
                out = await self._handle_policy(type_, req_id, body)
            elif type_ == p.T_SNAPSHOT:
                if self.snapshot is None:
                    out = p.encode_error(
                        req_id, p.E_INVALID_CONFIG,
                        "persistence not enabled on this server "
                        "(--snapshot-dir)")
                else:
                    # Off the event loop: capture takes the limiter lock
                    # and the write fsyncs.
                    entry = await asyncio.get_running_loop(
                        ).run_in_executor(None, self.snapshot)
                    out = p.encode_snapshot_r(
                        req_id, int(entry.get("id", 0)),
                        int(entry.get("wal_seq", 0)),
                        float(entry.get("duration_s", 0.0)))
            elif type_ == p.T_HEALTH:
                out = p.encode_health(
                    req_id, self._serving, time.time() - self._started_at,
                    self.batcher.decisions_total)
            elif type_ == p.T_METRICS:
                # Off the event loop: a collect hook (the side table's
                # gauges, the debt slab's) takes the limiter lock and
                # reads the device.
                text = await asyncio.get_running_loop().run_in_executor(
                    None, self.registry.render)
                out = p.encode_metrics(req_id, text)
            elif type_ == p.T_FLEET_MAP:
                if self.fleet is None:
                    out = p.encode_error(
                        req_id, p.E_INVALID_CONFIG,
                        "this server is not a fleet member "
                        "(--fleet-config)")
                else:
                    out = p.encode_fleet_map_r(req_id,
                                               self.fleet.map_payload())
            elif type_ == p.T_DCN_PUSH:
                if not self.dcn:
                    out = p.encode_error(req_id, p.E_INVALID_CONFIG,
                                         "DCN exchange not enabled on this "
                                         "server")
                else:
                    out = await self._handle_dcn(req_id, body)
            elif type_ in (p.T_LEASE_GRANT, p.T_LEASE_RENEW,
                           p.T_LEASE_RETURN):
                out = await self._handle_lease(type_, req_id, body,
                                               writer, out_fn)
            else:
                out = p.encode_error(req_id, p.E_INTERNAL,
                                     f"unknown request type {type_}")
        except Exception as exc:  # answered on the wire, connection lives
            out = p.encode_error(req_id, p.code_for(exc), str(exc))
        if out_fn is not None:
            # The reply ring's writer (on the loop thread; the lane
            # handles its own backpressure).
            out_fn(out)
            return
        async with write_lock:
            try:
                writer.write(out)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass


async def run_server(limiter: RateLimiter, host: str = "127.0.0.1",
                     port: int = 0, **kw) -> RateLimitServer:
    """Start and return a server (test/embedding convenience)."""
    srv = RateLimitServer(limiter, host, port, **kw)
    await srv.start()
    return srv
