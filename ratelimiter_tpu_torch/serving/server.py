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
* RESET, HEALTH, METRICS (Prometheus text of the door's registry; a
  limiter with the heavy-hitter side table adds its top-K consumer
  gauges, ``observability.metrics.ConsumerGauges``), the
  policy frames (POLICY_SET/GET/DEL, answered with POLICY_R) and SNAPSHOT
  run as one task each. Reset and the policy mutations are not batched:
  they are rare, and their semantics are "take effect before any later
  decision", which the limiter's lock gives; they run in the loop's
  default executor, and so does SNAPSHOT (``snapshot=``, the persistence
  manager's ``snapshot_now``: its capture takes the limiter lock and its
  write fsyncs). Without ``snapshot`` SNAPSHOT is answered with
  E_INVALID_CONFIG;
* a connection whose write buffer passes WRITE_BUFFER_LIMIT is dropped.

Frames carrying the JAX protocol's trace, deadline or forward extension
bits are answered with E_INVALID_CONFIG. HTTP, gRPC, the shared-memory
lane, the native door, leases and the fleet are not ported (ROADMAP
A13, A8); neither are the JAX door's audit events.
"""

from __future__ import annotations

import asyncio
import logging
import time
from functools import partial
from typing import Callable, Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.observability import metrics as m
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
        self._consumers = (m.ConsumerGauges(limiter, self.registry)
                           if getattr(limiter, "has_hh", False) else None)
        self._server: Optional[asyncio.AbstractServer] = None
        self._started_at = time.time()
        self._serving = False
        self._conn_tasks: set = set()

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started_at = time.time()
        self._serving = True

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
        if self._consumers is not None:
            self._consumers.close()

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.serve_forever()

    # ---------------------------------------------------------- connection

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        write_lock = asyncio.Lock()
        req_tasks: set = set()
        task = asyncio.current_task()
        self._conn_tasks.add(task)

        def check_backpressure() -> None:
            transport = writer.transport
            if transport.get_write_buffer_size() > WRITE_BUFFER_LIMIT:
                log.warning(
                    "dropping slow-reader connection (%d bytes buffered)",
                    transport.get_write_buffer_size())
                transport.abort()

        def write_vec(bufs) -> None:
            # Done-callback writer: never blocks the loop; broken pipes
            # surface in the reader loop, which owns teardown. Callbacks
            # cannot await drain(), so a client that pipelines but reads
            # slowly is cut off past WRITE_BUFFER_LIMIT instead.
            try:
                writer.writelines(bufs)
                check_backpressure()
            except (ConnectionResetError, BrokenPipeError, RuntimeError):
                pass

        def complete_allow(req_id: int, fut: asyncio.Future) -> None:
            exc = fut.exception()
            if exc is not None:
                write_vec([p.encode_error(req_id, p.code_for(exc), str(exc))])
            else:
                write_vec([p.encode_result(req_id, fut.result())])

        def complete_hashed(req_id: int, fut: asyncio.Future) -> None:
            exc = fut.exception()
            if exc is not None:
                write_vec([p.encode_error(req_id, p.code_for(exc), str(exc))])
            else:
                write_vec(p.encode_result_hashed_views(req_id, fut.result()))

        def complete_batch(req_id: int, agg: asyncio.Future) -> None:
            exc = agg.exception()
            if exc is not None:
                write_vec([p.encode_error(req_id, p.code_for(exc), str(exc))])
            else:
                write_vec(p.encode_result_batch_views(
                    req_id, self.limiter.config.limit, agg.result()))

        try:
            while True:
                try:
                    hdr = await reader.readexactly(p.HEADER_SIZE)
                    length, type_, req_id = p.parse_header(hdr)
                    body = await reader.readexactly(length - 9)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                except p.ProtocolError as exc:
                    log.warning("protocol error, dropping connection: %s", exc)
                    break
                if type_ < 128 and type_ & p.REQUEST_FLAGS:
                    write_vec([p.encode_error(
                        req_id, p.E_INVALID_CONFIG,
                        f"request type {type_:#x} carries a frame extension "
                        f"(trace, deadline or forward) that this server "
                        f"does not serve")])
                    continue
                if type_ == p.T_ALLOW_N:
                    try:
                        key, n = p.parse_allow_n(body)
                        fut = self.batcher.submit_nowait(key, n)
                    except Exception as exc:
                        write_vec([p.encode_error(req_id, p.code_for(exc),
                                                  str(exc))])
                        continue
                    fut.add_done_callback(partial(complete_allow, req_id))
                    continue
                if type_ == p.T_ALLOW_HASHED:
                    try:
                        ids, ns = p.parse_allow_hashed(body)
                        fut = self.batcher.submit_hashed_nowait(ids, ns)
                    except Exception as exc:
                        write_vec([p.encode_error(req_id, p.code_for(exc),
                                                  str(exc))])
                        continue
                    fut.add_done_callback(partial(complete_hashed, req_id))
                    continue
                if type_ == p.T_ALLOW_BATCH:
                    try:
                        keys, ns = p.parse_allow_batch(body)
                        futs = self.batcher.submit_many_nowait(zip(keys, ns))
                    except Exception as exc:
                        write_vec([p.encode_error(req_id, p.code_for(exc),
                                                  str(exc))])
                        continue
                    agg = asyncio.gather(*futs)
                    agg.add_done_callback(partial(complete_batch, req_id))
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
                # gauges) takes the limiter lock and reads the device.
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
