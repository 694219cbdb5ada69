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
Frames carrying the JAX protocol's forward hint are answered with
E_INVALID_CONFIG. Every decision the door serves goes through the
batcher, whose audit tap mirrors it to the shadow auditor when one is
enabled (serving/batcher.py), as in the JAX asyncio door.
``transport_stats()`` and the transport gauges it feeds at scrape time
(``rate_limiter_transport_connections``, the shared-memory lane's and
``rate_limiter_net_writev_frames``) are the JAX door's: the port has TCP
only, so the UDS and shared-memory counts are what the JAX door shows
with no such connection open, zero. gRPC, the
shared-memory lane, the native door, leases and the fleet are not ported
(ROADMAP A13c, A13d, A8); the HTTP gateway runs beside the door in the
binary (serving/http_gateway.py, serving/__main__.py).
"""

from __future__ import annotations

import asyncio
import logging
import time
from functools import partial
from typing import Callable, Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.observability import events
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.ops.hashing import key_token
from ratelimiter_tpu_torch.serving import protocol as p
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
                 max_window: Optional[int] = None):
        self.limiter = limiter
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
        #: Connections accepted per transport (cumulative), the JAX
        #: door's keys; only TCP is served here.
        self._transport_conns = {"tcp": 0, "uds": 0, "shm": 0}
        #: Hashed and batch replies flushed as several buffers (the JAX
        #: door's rate_limiter_net_writev_frames).
        self._writev_frames = 0

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started_at = time.time()
        self._serving = True
        self.registry.add_collect_hook(self._collect_transport_metrics)

    async def shutdown(self) -> None:
        """Graceful: stop accepting, answer what is in flight (drain the
        batcher), then close the connections and the batcher."""
        self._serving = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.batcher.drain()
        for t in list(self._conn_tasks):
            t.cancel()
        await asyncio.gather(*list(self._conn_tasks), return_exceptions=True)
        self.batcher.close()
        self.registry.remove_collect_hook(self._collect_transport_metrics)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.serve_forever()

    def transport_stats(self) -> dict:
        """Per-transport counters and the shared-memory lane's gauges in
        the JAX door's shape; the lane is not ported, so its block is the
        JAX door's with no lane open. Never called from the decide path
        (the registry's collect hook and /healthz read it)."""
        return {
            "connections": dict(self._transport_conns),
            "shm": {"lanes_active": 0,
                    "req_ring_used_bytes": 0, "rep_ring_used_bytes": 0,
                    "req_ring_highwater_bytes": 0,
                    "rep_ring_highwater_bytes": 0,
                    "doorbell_wakes": 0, "spin_hits": 0,
                    "ring_full_stalls": 0, "records_in": 0,
                    "records_out": 0},
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

    # ---------------------------------------------------------- connection

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        write_lock = asyncio.Lock()
        req_tasks: set = set()
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self._transport_conns["tcp"] += 1

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
            try:
                writer.writelines(bufs)
                if vec:
                    self._writev_frames += 1
                check_backpressure()
            except (ConnectionResetError, BrokenPipeError, RuntimeError):
                pass

        def complete_allow(req_id: int, trace_id: int,
                           fut: asyncio.Future) -> None:
            exc = fut.exception()
            if exc is not None:
                write_vec([p.encode_error(req_id, p.code_for(exc), str(exc))])
                return
            rec = tracing.RECORDER
            t0 = tracing.now() if rec is not None else 0
            write_vec([p.encode_result(req_id, fut.result())])
            if rec is not None:
                rec.record("encode", t0, tracing.now(), trace_id=trace_id)

        def complete_hashed(req_id: int, trace_id: int,
                            fut: asyncio.Future) -> None:
            exc = fut.exception()
            if exc is not None:
                write_vec([p.encode_error(req_id, p.code_for(exc), str(exc))])
                return
            rec = tracing.RECORDER
            t0 = tracing.now() if rec is not None else 0
            res = fut.result()
            write_vec(p.encode_result_hashed_views(req_id, res), vec=True)
            if rec is not None:
                rec.record("encode", t0, tracing.now(), trace_id=trace_id,
                           batch=len(res))

        def complete_batch(req_id: int, trace_id: int,
                           agg: asyncio.Future) -> None:
            exc = agg.exception()
            if exc is not None:
                write_vec([p.encode_error(req_id, p.code_for(exc), str(exc))])
                return
            rec = tracing.RECORDER
            t0 = tracing.now() if rec is not None else 0
            results = agg.result()
            write_vec(p.encode_result_batch_views(
                req_id, self.limiter.config.limit, results), vec=True)
            if rec is not None:
                rec.record("encode", t0, tracing.now(), trace_id=trace_id,
                           batch=len(results))

        try:
            while True:
                try:
                    hdr = await reader.readexactly(p.HEADER_SIZE)
                    length, type_, req_id = p.parse_header(hdr)
                    body = await reader.readexactly(length - 9)
                    # Frame extensions: the trace id and the deadline's
                    # relative budget, anchored below to arrival on the
                    # local monotonic clock.
                    type_, trace_id, budget, body = p.split_request(
                        type_, body)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                except p.ProtocolError as exc:
                    log.warning("protocol error, dropping connection: %s", exc)
                    break
                if type_ < 128 and type_ & p.REQUEST_FLAGS:
                    write_vec([p.encode_error(
                        req_id, p.E_INVALID_CONFIG,
                        f"request type {type_:#x} carries the forward hint, "
                        f"which this server does not serve")])
                    continue
                # None = no deadline; a budget <= 0 anchors in the past
                # (expired on arrival: shed at the first check).
                deadline = (time.monotonic() + budget
                            if budget is not None else 0.0)
                rec = tracing.RECORDER
                t_io = tracing.now() if rec is not None else 0
                if type_ == p.T_ALLOW_N:
                    try:
                        key, n = p.parse_allow_n(body)
                        fut = self.batcher.submit_nowait(key, n, trace_id,
                                                         deadline)
                    except Exception as exc:
                        write_vec([p.encode_error(req_id, p.code_for(exc),
                                                  str(exc))])
                        continue
                    if rec is not None:
                        rec.record("io", t_io, tracing.now(),
                                   trace_id=trace_id)
                    fut.add_done_callback(
                        partial(complete_allow, req_id, trace_id))
                    continue
                if type_ == p.T_ALLOW_HASHED:
                    try:
                        ids, ns = p.parse_allow_hashed(body)
                        fut = self.batcher.submit_hashed_nowait(
                            ids, ns, trace_id, deadline)
                    except Exception as exc:
                        write_vec([p.encode_error(req_id, p.code_for(exc),
                                                  str(exc))])
                        continue
                    if rec is not None:
                        rec.record("io", t_io, tracing.now(),
                                   trace_id=trace_id,
                                   batch=int(ids.shape[0]))
                    fut.add_done_callback(
                        partial(complete_hashed, req_id, trace_id))
                    continue
                if type_ == p.T_ALLOW_BATCH:
                    try:
                        keys, ns = p.parse_allow_batch(body)
                        futs = self.batcher.submit_many_nowait(
                            zip(keys, ns), trace_id, deadline)
                    except Exception as exc:
                        write_vec([p.encode_error(req_id, p.code_for(exc),
                                                  str(exc))])
                        continue
                    if rec is not None:
                        rec.record("io", t_io, tracing.now(),
                                   trace_id=trace_id, batch=len(keys))
                    agg = asyncio.gather(*futs)
                    agg.add_done_callback(
                        partial(complete_batch, req_id, trace_id))
                    continue
                # Control frames (rare): one task each.
                t = asyncio.ensure_future(self._handle_frame(
                    type_, req_id, body, writer, write_lock))
                req_tasks.add(t)
                t.add_done_callback(req_tasks.discard)
        finally:
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
        return p.encode_policy_r(req_id, bool(existed),
                                 self.limiter.config.limit, 1.0)

    async def _handle_frame(self, type_: int, req_id: int, body: bytes,
                            writer: asyncio.StreamWriter,
                            write_lock: asyncio.Lock) -> None:
        try:
            if type_ == p.T_RESET:
                key = p.parse_reset(body)
                # Off the event loop: reset takes the limiter lock.
                await asyncio.get_running_loop().run_in_executor(
                    None, self.limiter.reset, key)
                events.emit("policy", "reset", actor="binary",
                            payload={"key_hash": key_token(key)})
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
            else:
                out = p.encode_error(req_id, p.E_INTERNAL,
                                     f"unknown request type {type_}")
        except Exception as exc:  # answered on the wire, connection lives
            out = p.encode_error(req_id, p.code_for(exc), str(exc))
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
