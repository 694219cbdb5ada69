"""The port's clients (``serving/client.py``: Client and AsyncClient)
against the JAX package's.

On the same door (each of the port's two, over fresh identical
limiters) the port's clients and the JAX clients get the same results
for the same calls: ALLOW_N, ALLOW_BATCH, ALLOW_HASHED, RESET, HEALTH,
METRICS and the typed errors. The resilience contract of
``tests/test_client_resilience.py`` (separate connect and call timeouts,
a typed mid-stream timeout that desynchronizes the connection, bounded
full-jitter retries with reconnect, deadlines that bound the call and
ride the wire) holds for both packages' clients against the same
misbehaving scripted server, with the same outcome.
"""

from __future__ import annotations

import asyncio
import contextlib
import socket
import threading
import time

import numpy as np
import pytest

import ratelimiter_tpu_torch as T
from ratelimiter_tpu.core import errors as jerrors
from ratelimiter_tpu.serving import client as jclient
from ratelimiter_tpu_torch.core import errors as terrors
from ratelimiter_tpu_torch.core.types import Result
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.serving import client as tclient
from ratelimiter_tpu_torch.serving import protocol as p
from ratelimiter_tpu_torch.serving.native_server import NativeRateLimitServer
from ratelimiter_tpu_torch.serving.server import RateLimitServer

T0 = 1_700_000_000.0
PACKAGES = {"jax": (jclient, jerrors), "port": (tclient, terrors)}


def _limiter():
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=6,
                   window=60.0, sketch=T.SketchParams(depth=2, width=256,
                                                      sub_windows=5))
    return T.create_limiter(cfg, backend="sketch", clock=T.ManualClock(T0),
                            device="cpu")


@contextlib.contextmanager
def _door(kind: str):
    """One of the port's doors over a fresh limiter; yields its port."""
    lim = _limiter()
    if kind == "native":
        srv = NativeRateLimitServer(lim, "127.0.0.1", 0, registry=Registry())
        srv.start()
        try:
            yield srv.port
        finally:
            srv.shutdown()
            lim.close()
        return
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    srv = RateLimitServer(lim, "127.0.0.1", 0, registry=Registry())
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(timeout=10)
    try:
        yield srv.port
    finally:
        asyncio.run_coroutine_threadsafe(srv.shutdown(),
                                         loop).result(timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
        lim.close()


def _calls(c) -> list:
    """The same sequence of calls through a blocking client; results as
    plain tuples (errors as (type name, message))."""
    out = []

    def rec(fn):
        try:
            r = fn()
        except Exception as exc:  # noqa: BLE001 — the typed error is the result
            out.append((type(exc).__name__, str(exc)))
            return
        if hasattr(r, "allowed") and hasattr(r, "remaining") and \
                not isinstance(r.allowed, (bool, np.bool_)):
            out.append((r.allowed.tolist(), r.remaining.tolist(),
                        r.reset_at.tolist(), r.fail_open, r.limit))
        elif isinstance(r, list):
            out.append([(x.allowed, x.remaining, x.reset_at) for x in r])
        elif hasattr(r, "allowed"):
            out.append((r.allowed, r.remaining, r.retry_after, r.reset_at,
                        r.limit, r.fail_open))
        else:
            out.append(r)

    for i in range(8):
        rec(lambda: c.allow_n("k", 1 + i % 3))
    rec(lambda: c.allow("ключ", trace_id=77, deadline=5.0))
    rec(lambda: c.allow_batch(["a", "b", "a"], [2, 1, 3]))
    rec(lambda: c.allow_hashed(np.arange(6, dtype=np.uint64), [1, 2] * 3))
    rec(lambda: c.reset("k"))
    rec(lambda: c.allow_n("k", 2))
    rec(lambda: c.allow_n("", 1))
    rec(lambda: c.allow_n("z", 0))
    rec(lambda: c.health()[::2])
    rec(lambda: "rate_limiter_server_batch_size" in c.metrics())
    return out


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_blocking_clients_get_the_same_results(door):
    got = {}
    for name, (mod, _) in PACKAGES.items():
        with _door(door) as port:
            with mod.Client(port=port) as c:
                got[name] = _calls(c)
    assert got["port"] == got["jax"]
    assert any(r[0] == "InvalidKeyError" for r in got["port"]
               if isinstance(r, tuple) and isinstance(r[0], str))


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_async_clients_get_the_same_results(door):
    async def run(mod, port):
        c = await mod.AsyncClient.connect(port=port)
        try:
            res = await c.allow_many(["x", "y", "x", "x"] * 3)
            batch = await c.allow_batch(["p", "q"], [3, 9])
            hashed = await c.allow_hashed(np.arange(4, dtype=np.uint64))
            await c.reset("x")
            again = await c.allow_n("x", 2, deadline=5.0)
            return ([(r.allowed, r.remaining) for r in res],
                    [(r.allowed, r.remaining) for r in batch],
                    hashed.allowed.tolist(), (again.allowed, again.remaining),
                    (await c.health())[0])
        finally:
            await c.close()

    got = {}
    for name, (mod, _) in PACKAGES.items():
        with _door(door) as port:
            got[name] = asyncio.run(run(mod, port))
    assert got["port"] == got["jax"]


# ------------------------------------------------- the resilience contract


def _result_frame(req_id: int, allowed=True) -> bytes:
    return p.encode_result(req_id, Result(
        allowed=allowed, limit=10, remaining=5, retry_after=0.0,
        reset_at=T0, fail_open=False))


class _ScriptedServer:
    """A frame server driven by a per-request handler: the misbehaviour
    (answers held back, dropped connections) the real doors never show
    on purpose."""

    def __init__(self, handler):
        self.handler = handler
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.connections = 0
        self._conns = []
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.connections += 1
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        buf = b""
        try:
            while True:
                while len(buf) < 4 or len(buf) < 4 + int.from_bytes(
                        buf[:4], "little"):
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                length, type_, rid = p.parse_header(buf[:p.HEADER_SIZE])
                body = buf[p.HEADER_SIZE:4 + length]
                buf = buf[4 + length:]
                out = self.handler(type_, rid, body, conn)
                if out is not None:
                    conn.sendall(out)
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self.sock.close()
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


@contextlib.contextmanager
def _scripted(handler):
    srv = _ScriptedServer(handler)
    try:
        yield srv
    finally:
        srv.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_connect_timeout_is_not_the_read_timeout(pkg):
    mod, _ = PACKAGES[pkg]
    with _scripted(lambda t, rid, b, c: _result_frame(rid)) as srv:
        c = mod.Client(port=srv.port, connect_timeout=5.0,
                       call_timeout=0.75, retries=0)
        assert c._sock.gettimeout() == pytest.approx(0.75)
        assert c.allow("k").allowed
        c.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_late_answer_is_never_the_next_calls(pkg):
    """Request 1 times out (typed, naming it; the connection is marked
    desynchronized), its answer comes late, and request 2 must get its
    own answer over a new connection."""
    mod, errs = PACKAGES[pkg]
    lock = threading.Lock()
    state = {"first": None}

    def handler(type_, rid, body, conn):
        with lock:
            if state["first"] is None:
                state["first"] = rid

                def late():
                    time.sleep(0.5)
                    try:
                        conn.sendall(_result_frame(rid, allowed=False))
                    except OSError:
                        pass

                threading.Thread(target=late, daemon=True).start()
                return None
        return _result_frame(rid, allowed=True)

    with _scripted(handler) as srv:
        c = mod.Client(port=srv.port, call_timeout=0.25, retries=0)
        with pytest.raises(errs.RequestTimeoutError) as ei:
            c.allow("k")
        assert (ei.value.request_id, ei.value.request_type) == (
            1, p.T_ALLOW_N)
        assert c.desynced
        assert c.allow("k2").allowed is True
        assert srv.connections == 2
        c.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_connection_errors_retry_with_reconnect(pkg):
    mod, _ = PACKAGES[pkg]
    calls = []

    def handler(type_, rid, body, conn):
        calls.append(rid)
        if len(calls) == 1:
            conn.close()
            return None
        return _result_frame(rid)

    with _scripted(handler) as srv:
        c = mod.Client(port=srv.port, retries=2, backoff=0.01,
                       call_timeout=5.0)
        assert c.allow("k").allowed
        assert srv.connections >= 2
        c.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_midstream_timeout_is_never_retried(pkg):
    mod, errs = PACKAGES[pkg]
    seen = []
    with _scripted(lambda t, rid, b, conn: seen.append(rid)) as srv:
        c = mod.Client(port=srv.port, call_timeout=0.2, retries=5)
        with pytest.raises(errs.RequestTimeoutError):
            c.allow("k")
        time.sleep(0.1)
        assert len(seen) == 1
        c.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_deadline_bounds_the_call_and_rides_the_wire(pkg):
    mod, errs = PACKAGES[pkg]
    got = {}

    def handler(type_, rid, body, conn):
        base, tid, budget, _ = p.split_request(type_, body)
        got.update(type=base, trace=tid, budget=budget)
        return _result_frame(rid) if tid else None

    with _scripted(handler) as srv:
        c = mod.Client(port=srv.port, retries=0, call_timeout=30.0)
        c.allow("k", deadline=1.5, trace_id=42)
        assert (got["type"], got["trace"]) == (p.T_ALLOW_N, 42)
        assert 0.0 < got["budget"] <= 1.5
        t0 = time.perf_counter()
        with pytest.raises((errs.RequestTimeoutError,
                            errs.DeadlineExceededError)):
            c.allow("k", deadline=0.3)
        assert time.perf_counter() - t0 < 2.0
        with pytest.raises(errs.DeadlineExceededError):
            c.allow("k", deadline=-0.1)
        c.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_async_client_reconnects_and_bounds_its_deadline(pkg):
    mod, errs = PACKAGES[pkg]
    calls = []

    def handler(type_, rid, body, conn):
        calls.append(rid)
        if len(calls) == 1:
            conn.close()
            return None
        if len(calls) == 2:
            return _result_frame(rid)
        return None  # never answers again

    async def main(port):
        c = await mod.AsyncClient.connect(port=port, retries=2,
                                          backoff=0.01)
        try:
            assert (await c.allow("k")).allowed
            t0 = time.perf_counter()
            with pytest.raises(errs.DeadlineExceededError):
                await c.allow("k", deadline=0.3)
            assert time.perf_counter() - t0 < 2.0
        finally:
            await c.close()

    with _scripted(handler) as srv:
        asyncio.run(main(srv.port))
        assert srv.connections >= 2


def test_jitter_backoff_is_the_jax_clients():
    for attempt in range(8):
        cap = min(2.0, 0.05 * 2 ** attempt)
        for _ in range(20):
            assert 0.0 <= tclient._jitter_delay(attempt, 0.05, 2.0) <= cap


def test_error_codes_map_to_the_same_exceptions():
    from ratelimiter_tpu.serving import protocol as jp

    # 9 is the fleet's typed redirect (E_NOT_OWNER): no fleet in the
    # port (ROADMAP A13d), so it stays a plain RateLimiterError there.
    for code in (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11):
        a = p.exception_for(code, "m")
        b = jp.exception_for(code, "m")
        assert type(a).__name__ == type(b).__name__, code
