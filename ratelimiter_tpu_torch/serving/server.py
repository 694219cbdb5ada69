"""A minimal asyncio TCP front door for the port's limiter.

It speaks the frame subset of serving/protocol.py. Each decision frame is
one ``launch_*`` and one ``resolve`` of the limiter, run back to back in
the loop's default thread executor so the event loop never blocks on the
card; frames on one connection are answered in order, connections run
concurrently. There is no micro-batcher, native door, HTTP, gRPC, DCN,
fleet, audit or tracing in this slice (the JAX package's server has
them); frames that carry the JAX protocol's trace, deadline or forward
extension bits are answered with E_INVALID_CONFIG.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import numpy as np

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.errors import InvalidNError
from ratelimiter_tpu_torch.serving import protocol as p

log = logging.getLogger("ratelimiter_tpu_torch")


class RateLimitServer:
    def __init__(self, limiter: RateLimiter, host: str = "127.0.0.1",
                 port: int = 0):
        self.limiter = limiter
        self.host = host
        self.port = port
        self.decisions_total = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._started_at = time.time()
        self._serving = False
        self._conns: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started_at = time.time()
        self._serving = True

    async def shutdown(self) -> None:
        self._serving = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------ frames

    def _decide_hashed(self, ids: np.ndarray, ns: np.ndarray):
        lim = self.limiter
        return lim.resolve(lim.launch_ids(ids, ns.astype(np.int64),
                                          wire=True))

    def _decide_keys(self, keys, ns):
        lim = self.limiter
        return lim.resolve(lim.launch_batch(keys, ns))

    async def _answer(self, type_: int, req_id: int, body: bytes) -> bytes:
        loop = asyncio.get_running_loop()
        if type_ < 128 and type_ & p.REQUEST_FLAGS:
            return p.encode_error(
                req_id, p.E_INVALID_CONFIG,
                f"request type {type_:#x} carries a frame extension (trace, "
                f"deadline or forward) that this server does not serve")
        try:
            if type_ == p.T_ALLOW_HASHED:
                ids, ns = p.parse_allow_hashed(body)
                if ids.shape[0] and int(ns.min()) <= 0:
                    raise InvalidNError("n must be a positive integer")
                res = await loop.run_in_executor(None, self._decide_hashed,
                                                 ids, ns)
                self.decisions_total += len(res)
                return p.encode_result_hashed(req_id, res)
            if type_ == p.T_ALLOW_BATCH:
                keys, ns = p.parse_allow_batch(body)
                res = await loop.run_in_executor(None, self._decide_keys,
                                                 keys, ns)
                self.decisions_total += len(res)
                return p.encode_result_batch(req_id, self.limiter.config.limit,
                                             res.results())
            if type_ == p.T_ALLOW_N:
                key, n = p.parse_allow_n(body)
                res = await loop.run_in_executor(None, self._decide_keys,
                                                 [key], [n])
                self.decisions_total += 1
                return p.encode_result(req_id, res.result(0))
            if type_ == p.T_RESET:
                key = p.parse_reset(body)
                await loop.run_in_executor(None, self.limiter.reset, key)
                return p.encode_ok(req_id)
            if type_ == p.T_HEALTH:
                return p.encode_health(req_id, self._serving,
                                       time.time() - self._started_at,
                                       self.decisions_total)
            return p.encode_error(req_id, p.E_INTERNAL,
                                  f"unknown request type {type_}")
        except Exception as exc:  # answered on the wire, connection lives
            return p.encode_error(req_id, p.code_for(exc), str(exc))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
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
                writer.write(await self._answer(type_, req_id, body))
                await writer.drain()
        finally:
            self._conns.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass


async def run_server(limiter: RateLimiter, host: str = "127.0.0.1",
                     port: int = 0) -> RateLimitServer:
    """Start and return a server (test/embedding convenience)."""
    srv = RateLimitServer(limiter, host, port)
    await srv.start()
    return srv
