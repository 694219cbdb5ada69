"""Lease control-plane serving glue, a copy of
``ratelimiter_tpu/leases/listener.py``.

:func:`serve_lease_frame` is the ONE dispatch for the three lease
request frames — the asyncio front door calls it from its slow path,
and :class:`LeaseListener` wraps it in a tiny standalone asyncio
listener for the native C++ door (whose compiled fast path knows
nothing of leases; lease traffic is low-rate control plane, so a
Python sidecar socket is the right cost). The listener lives on its
own port (``--lease-port``), printed in the binary's serving line, and
pushes revocations down whichever connection granted.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Callable, Optional

from ratelimiter_tpu_torch.serving import protocol as p

log = logging.getLogger("ratelimiter_tpu_torch.leases")


def serve_lease_frame(mgr, base_type: int, req_id: int, body: bytes,
                      push: Optional[Callable[[bytes], None]]) -> bytes:
    """Answer one lease request frame (may block on the debit dispatch —
    run off the event loop). ``push`` is the granting connection's
    write callable; the manager keeps it for revocation pushes."""
    if base_type == p.T_LEASE_GRANT:
        client, key, want, ttl_want = p.parse_lease_grant(body)
        granted, lease_id, budget, ttl, limit, epoch = mgr.grant(
            client, key, want, ttl_want, push=push)
        return p.encode_lease_r(req_id, granted, lease_id, budget, ttl,
                                limit, epoch)
    if base_type == p.T_LEASE_RENEW:
        client, lease_id, key, consumed, want = p.parse_lease_renew(body)
        granted, lease_id, top_up, ttl, limit, epoch = mgr.renew(
            client, lease_id, key, consumed, want)
        return p.encode_lease_r(req_id, granted, lease_id, top_up, ttl,
                                limit, epoch)
    if base_type == p.T_LEASE_RETURN:
        client, lease_id, key, consumed = p.parse_lease_return(body)
        granted, lease_id, _, _, _, epoch = mgr.release(
            client, lease_id, key, consumed)
        return p.encode_lease_r(req_id, granted, lease_id, 0, 0.0, 0,
                                epoch)
    return p.encode_error(req_id, p.E_INTERNAL,
                          f"not a lease frame: {base_type}")


class LeaseListener:
    """Standalone lease control listener for the native front door.

    Runs its own asyncio loop on a daemon thread; each connection may
    issue any number of lease requests and receives unsolicited
    T_LEASE_REVOKE pushes (req_id=0) for grants it holds."""

    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0):
        self.manager = manager
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    # ---------------------------------------------------------- serving

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        write_lock = asyncio.Lock()

        async def _send(frame: bytes) -> None:
            async with write_lock:
                writer.write(frame)
                await writer.drain()

        def push(frame: bytes) -> None:
            # Called from revocation paths on arbitrary threads; a dead
            # loop/conn raises and the manager counts the failed push.
            asyncio.run_coroutine_threadsafe(_send(frame),
                                             loop).result(timeout=5.0)

        try:
            while True:
                hdr = await reader.readexactly(p.HEADER_SIZE)
                length, type_, req_id = p.parse_header(hdr)
                body = await reader.readexactly(length - 9)
                base = type_ & ~(p.TRACE_FLAG | p.DEADLINE_FLAG
                                 | p.FORWARD_FLAG)
                if base not in (p.T_LEASE_GRANT, p.T_LEASE_RENEW,
                                p.T_LEASE_RETURN):
                    await _send(p.encode_error(
                        req_id, p.E_INTERNAL,
                        f"lease listener: unknown request type {type_}"))
                    continue
                try:
                    out = await loop.run_in_executor(
                        None, serve_lease_frame, self.manager, base,
                        req_id, body, push)
                except Exception as exc:  # noqa: BLE001 — keep serving
                    log.exception("lease frame failed")
                    out = p.encode_error(req_id, p.E_INTERNAL, str(exc))
                await _send(out)
        except (asyncio.IncompleteReadError, ConnectionError,
                p.ProtocolError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except asyncio.CancelledError:
            pass
        finally:
            try:
                self._loop.close()
            except Exception:  # noqa: BLE001
                pass

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rl-lease-listener")
        self._thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError("lease listener failed to start")

    def close(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():

            def _shutdown() -> None:
                if self._server is not None:
                    self._server.close()
                for task in asyncio.all_tasks(loop):
                    task.cancel()

            loop.call_soon_threadsafe(_shutdown)
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
