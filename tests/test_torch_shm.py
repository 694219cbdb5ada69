"""The port's transports: the unix-socket listener and the shared-memory
lane, on both of the port's doors, against the JAX package's.

* the ring layout is the JAX one: the port's ``shm.py`` constants and
  header equal the JAX module's, and a ring initialized by one package
  is read by the other;
* the bit-identical pins (``tests/test_shm_transport.py``): the same
  request frames (the extensions, batch, hashed, reset) against fresh
  identical limiters give the same reply bytes over TCP, the unix
  socket and the lane, on the asyncio door and the native door, and the
  two doors agree with each other and with the JAX asyncio door;
* the record-format fuzz cases, ring-full backpressure, and a client
  killed with ``kill -9`` mid-write stalling neither door;
* across packages: the port's Client over the lane to the JAX asyncio
  door, and the JAX Client to both of the port's doors;
* ``transport_stats`` and the transport gauges of both doors.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import mmap
import os
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.serving import shm as jshm
from ratelimiter_tpu.serving.client import Client as JaxClient
from ratelimiter_tpu.serving.server import RateLimitServer as JaxServer
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.serving import protocol as p
from ratelimiter_tpu_torch.serving import shm as shm_lane
from ratelimiter_tpu_torch.serving.client import AsyncClient, Client
from ratelimiter_tpu_torch.serving.native_server import NativeRateLimitServer
from ratelimiter_tpu_torch.serving.server import RateLimitServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0


def _cfg(M, limit=1000, **sk):
    return M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=limit,
                    window=60.0, sketch=M.SketchParams(
                        depth=3, width=256, sub_windows=5, **sk))


def _port_limiter(limit=1000):
    return T.create_limiter(_cfg(T, limit), backend="sketch",
                            clock=T.ManualClock(T0), device="cpu")


def _jax_limiter(limit=1000):
    return R.create_limiter(_cfg(R, limit, kernels="jnp"), backend="sketch",
                            clock=R.ManualClock(T0))


@contextlib.contextmanager
def _loop_server(cls, limiter, host="127.0.0.1", **kw):
    """An asyncio door (``cls``) on a background event loop."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server = cls(limiter, host, 0, **kw)
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=10)
    try:
        yield server, loop
    finally:
        asyncio.run_coroutine_threadsafe(
            server.shutdown(), loop).result(timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()


@contextlib.contextmanager
def _native(limiter, host="127.0.0.1", **kw):
    srv = NativeRateLimitServer(limiter, host, 0, registry=Registry(), **kw)
    srv.start()
    try:
        yield srv
    finally:
        srv.shutdown()


def _wait_until(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _recv_frame(sock: socket.socket) -> bytes:
    buf = b""
    while len(buf) < 4 or len(buf) < 4 + struct.unpack_from("<I", buf)[0]:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _pin_frames() -> list:
    """Every decision lane with the trace and deadline extensions, a
    reset, HEALTH-free (its uptime differs); fixed request ids."""
    ids = np.arange(11, 19, dtype=np.uint64)
    return [
        p.encode_allow_n(10, "pin:a", 1),
        p.with_trace(p.encode_allow_n(11, "pin:a", 2), 0xDECAF123),
        p.with_deadline(p.encode_allow_n(12, "pin:b", 1), 5.0),
        p.with_trace(p.with_deadline(p.encode_allow_n(13, "pin:b", 1),
                                     2.5), 0xABCD),
        p.encode_allow_batch(14, ["x", "y", "x"], [1, 2, 3]),
        p.encode_allow_hashed(15, ids),
        p.with_trace(p.encode_allow_hashed(16, ids), 0x5150),
        p.encode_reset(18, "pin:a"),
        p.encode_allow_n(19, "pin:a", 1),
        p.encode_simple(p.T_DCN_PUSH, 20),
    ]


def _roundtrip_socket(sock, frames) -> list:
    out = []
    for f in frames:
        sock.sendall(f)
        out.append(_recv_frame(sock))
    return out


def _connect(host: str, port: int) -> socket.socket:
    if host.startswith("unix:"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(host[len("unix:"):])
        return s
    return socket.create_connection((host, port))


def _roundtrip_shm(host: str, port: int, frames, lane_mod=shm_lane) -> list:
    """The hello by hand, then the lane's client side driven directly, so
    the replies are the raw ring records."""
    sock = _connect(host, port)
    try:
        sock.sendall(p.encode_shm_hello(1, 0, 0))
        raw = _recv_frame(sock)
        assert p.parse_header(raw[:p.HEADER_SIZE])[1] == p.T_SHM_HELLO_R
        _rq, _rp, shm_path, ctrl_path = p.parse_shm_hello_r(
            raw[p.HEADER_SIZE:])
        lane = lane_mod.ClientLane(shm_path, ctrl_path)
        try:
            out = []
            for f in frames:
                lane.send_frame(f)
                got = lane.recv_frame(timeout=10.0)
                assert got is not None, "shm reply timeout"
                out.append(got)
            return out
        finally:
            lane.close()
    finally:
        sock.close()


def _run(door: str, transport: str, tmp_path, frames=None) -> list:
    """One capture: a fresh limiter and door, ``frames`` over
    ``transport`` ("tcp", "uds", "shm" or "uds+shm")."""
    frames = frames if frames is not None else _pin_frames()
    host = "127.0.0.1"
    if transport.startswith("uds"):
        host = f"unix:{tmp_path / (door + '-' + transport + '.sock')}"
    if door == "jax":
        lim, ctx = _jax_limiter(), None
        ctx = _loop_server(JaxServer, lim, host=host, shm=True)
    else:
        lim = _port_limiter()
        ctx = (_native(lim, host=host, shm=True) if door == "native"
               else _loop_server(RateLimitServer, lim, host=host, shm=True))
    try:
        with ctx as got:
            port = got.port if door == "native" else got[0].port
            if transport.endswith("shm"):
                return _roundtrip_shm(host, port, frames)
            s = _connect(host, port)
            try:
                return _roundtrip_socket(s, frames)
            finally:
                s.close()
    finally:
        lim.close()


# ------------------------------------------------------------ the layout


def test_ring_layout_is_the_jax_one():
    for name in ("MAGIC", "VERSION", "FILE_HEADER_BYTES", "CTRL_BYTES",
                 "COMMIT_XOR", "COMMIT_WRAP", "MIN_RING", "MAX_RING",
                 "DEFAULT_RING"):
        assert getattr(shm_lane, name) == getattr(jshm, name), name
    cap = shm_lane.MIN_RING
    for a, b in ((shm_lane, jshm), (jshm, shm_lane)):
        mm = mmap.mmap(-1, a.total_bytes(cap, cap))
        a.init_header(mm, cap, cap)
        _, prod = a.attach(mm, server=False)
        cons, _ = b.attach(mm, server=True)
        frames = [p.encode_allow_n(i, "k" * i, 1) for i in range(1, 40)]
        for f in frames:
            assert prod.try_push(f)
            assert cons.pop() == f
        mm.close()
    for n in (0, 1, 70000, 1 << 30):
        assert shm_lane.clamp_ring_bytes(n) == jshm.clamp_ring_bytes(n)


# ------------------------------------------------------------- the lanes


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_tcp_uds_shm_give_identical_bytes(door, tmp_path):
    tcp = _run(door, "tcp", tmp_path)
    assert len(tcp) == len(_pin_frames())
    for transport in ("uds", "shm", "uds+shm"):
        assert _run(door, transport, tmp_path) == tcp, transport


def test_the_doors_agree_with_each_other_and_with_jax(tmp_path):
    """Over the lane, the port's asyncio and native doors and the JAX
    asyncio door give the same bytes (JAX over its jnp limiter)."""
    a = _run("asyncio", "shm", tmp_path)
    assert _run("native", "shm", tmp_path) == a
    assert _run("jax", "shm", tmp_path) == a


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_unix_bind_and_bare_path(door, tmp_path):
    lim = _port_limiter(limit=5)
    path = str(tmp_path / "rl.sock")
    ctx = (_native(lim, host=f"unix:{path}") if door == "native"
           else _loop_server(RateLimitServer, lim, host=f"unix:{path}"))
    with ctx as got:
        srv = got if door == "native" else got[0]
        with Client(host=f"unix:{path}", transport="uds") as c:
            assert [c.allow("u").allowed for _ in range(6)] == [True] * 5 \
                + [False]
        with Client(host=path, transport="uds") as c:
            assert c.health()[0]
        assert srv.transport_stats()["connections"]["uds"] == 2
    assert not os.path.exists(path)
    lim.close()


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_shm_off_is_a_typed_error(door):
    lim = _port_limiter()
    ctx = _native(lim) if door == "native" else _loop_server(
        RateLimitServer, lim)
    with ctx as got:
        port = got.port if door == "native" else got[0].port
        with pytest.raises(InvalidConfigError, match="--shm"):
            Client(port=port, transport="shm")
        with Client(port=port) as c:
            assert c.allow("k").allowed
    lim.close()


def test_duplicate_hello_rejected():
    lim = _port_limiter()
    with _loop_server(RateLimitServer, lim, shm=True) as (server, _loop):
        with Client(port=server.port, transport="shm") as c:
            with c._lock:
                c._sock.sendall(p.encode_shm_hello(99, 0, 0))
                raw = _recv_frame(c._sock)
            assert p.parse_header(raw[:p.HEADER_SIZE])[1] == p.T_ERROR
            code, msg = p.parse_error(raw[p.HEADER_SIZE:])
            assert code == p.E_INVALID_CONFIG and "already" in msg
    lim.close()


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_stats_and_gauges_track_lanes(door, tmp_path):
    lim = _port_limiter(limit=100000)
    reg = Registry()
    ctx = (_native(lim, shm=True, shm_dir=str(tmp_path))
           if door == "native" else _loop_server(
               RateLimitServer, lim, shm=True, shm_dir=str(tmp_path),
               registry=reg))
    with ctx as got:
        srv = got if door == "native" else got[0]
        reg = srv.registry
        with Client(port=srv.port, transport="shm") as c:
            for _ in range(32):
                assert c.allow("k").allowed
            st = srv.transport_stats()
            assert st["connections"]["shm"] == 1
            assert st["shm"]["records_in"] >= 32
            assert st["shm"]["records_out"] >= 32
            text = reg.render()
            for fam in ("rate_limiter_transport_connections",
                        "rate_limiter_shm_lanes_active",
                        "rate_limiter_shm_doorbell_wakes",
                        "rate_limiter_shm_records",
                        "rate_limiter_shm_ring_highwater_bytes",
                        "rate_limiter_net_writev_frames"):
                assert fam in text, fam
        _wait_until(lambda: srv.transport_stats()["shm"]["lanes_active"]
                    == 0, what="lane retirement")
        assert srv.transport_stats()["shm"]["records_in"] >= 32
    assert not os.listdir(tmp_path)
    lim.close()


def test_async_client_burst_over_the_lane():
    lim = _port_limiter(limit=100000)
    with _loop_server(RateLimitServer, lim, shm=True) as (server, _loop):
        async def go():
            c = await AsyncClient.connect(port=server.port, transport="shm")
            try:
                res = await asyncio.gather(
                    *(c.allow(f"k{i % 7}") for i in range(64)))
                assert all(r.allowed for r in res)
                hashed = await c.allow_hashed(np.arange(8, dtype=np.uint64))
                assert hashed.allowed.all()
            finally:
                await c.close()

        asyncio.run(go())
    lim.close()


# --------------------------------------------------------- across packages


def test_port_client_over_the_lane_to_the_jax_asyncio_door():
    jlim, tlim = _jax_limiter(limit=5), _port_limiter(limit=5)
    with _loop_server(JaxServer, jlim, shm=True) as (jsrv, _l):
        with _loop_server(RateLimitServer, tlim, shm=True) as (tsrv, _l2):
            with Client(port=jsrv.port, transport="shm") as cj, \
                    Client(port=tsrv.port, transport="shm") as ct:
                for i in range(7):
                    a, b = cj.allow_n("k", 1 + i % 2), ct.allow_n(
                        "k", 1 + i % 2)
                    assert (a.allowed, a.remaining, a.reset_at) == (
                        b.allowed, b.remaining, b.reset_at)
                ids = np.arange(5, dtype=np.uint64)
                ra, rb = cj.allow_hashed(ids), ct.allow_hashed(ids)
                assert (ra.allowed == rb.allowed).all()
    jlim.close()
    tlim.close()


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_jax_client_to_the_ports_doors(door):
    lim = _port_limiter(limit=5)
    ctx = (_native(lim, shm=True) if door == "native"
           else _loop_server(RateLimitServer, lim, shm=True))
    with ctx as got:
        port = got.port if door == "native" else got[0].port
        for transport in ("tcp", "shm"):
            with JaxClient(port=port, transport=transport) as c:
                r = [c.allow(f"j-{transport}").remaining for _ in range(5)]
                assert r == [4, 3, 2, 1, 0]
                assert not c.allow(f"j-{transport}").allowed
                batch = c.allow_batch([f"a-{transport}", f"b-{transport}"],
                                      [1, 2])
                assert [x.remaining for x in batch] == [4, 3]
    lim.close()


# ----------------------------------------------------------- crash safety


def test_ring_full_is_typed_backpressure():
    """Wedge the asyncio door's loop, flood a tiny ring: the producer
    raises RingFullError (a StorageUnavailableError), never drops or
    deadlocks, and the same connection works afterwards."""
    lim = _port_limiter(limit=10 ** 6)
    with _loop_server(RateLimitServer, lim, shm=True) as (server, loop):
        with Client(port=server.port, transport="shm",
                    shm_ring_bytes=shm_lane.MIN_RING) as c:
            assert c.allow("warm").allowed
            loop.call_soon_threadsafe(time.sleep, 1.5)
            time.sleep(0.05)
            frame = p.encode_allow_n(12345, "x" * 200, 1)
            with pytest.raises(shm_lane.RingFullError):
                for _ in range(shm_lane.MIN_RING // 64):
                    c._lane.send_frame(frame, timeout=0.2)
            assert c._lane.stats.ring_full_stalls > 0
            time.sleep(1.6)
            while c._lane.recv_frame(timeout=0.5) is not None:
                pass
            assert c.allow("after").allowed
    lim.close()


# ------------------------------------------------ C16: lost doorbells


def _pop_within(ring, seconds: float):
    """Pop one reply record straight off ``ring``, ringing no doorbell
    (a client that never tells the door it freed space)."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        frame = ring.pop()
        if frame is not None:
            return frame
        time.sleep(0.001)
    return None


def test_c16_a_request_with_no_doorbell_is_served_by_the_recheck():
    """C16: a client whose doorbell is lost (it publishes, but its
    unfenced read of the door's flag misses the arming store) leaves a
    request in the ring with the door asleep. The door's recheck serves
    it within a period: the reply comes, equal to a rung request's."""
    lim = _port_limiter(limit=10 ** 6)
    with _loop_server(RateLimitServer, lim, shm=True) as (server, loop):
        with Client(port=server.port, transport="shm") as c:
            assert c.allow("warm").allowed
            lane = c._lane
            _wait_until(lambda: lane.outbound.consumer_sleeping(),
                        what="the door to arm its doorbell")
            hits = [ln.stats.recheck_hits for ln in server._shm_lanes]
            for i in range(3):
                frame = p.encode_allow_n(100 + i, f"silent-{i}", 2)
                assert lane.outbound.try_push(frame)  # no ding
                reply = _pop_within(lane.inbound, 2.0)
                assert reply is not None, "the lane stalled"
                _, type_, rid = p.parse_header(reply)
                assert (type_, rid) == (p.T_RESULT, 100 + i)
                res = p.parse_result(reply[p.HEADER_SIZE:])
                assert res.allowed and res.remaining == 10 ** 6 - 2
            assert [ln.stats.recheck_hits for ln in server._shm_lanes] \
                != hits
            assert c.allow("after").allowed
    lim.close()


def test_c16_reply_overflow_with_no_wake_is_flushed_by_the_recheck():
    """C16, the reply side: replies past a full reply ring wait in the
    door's overflow for the client's space-freed doorbell. A client that
    frees the space without ringing still gets every reply."""
    lim = _port_limiter(limit=10 ** 6)
    with _loop_server(RateLimitServer, lim, shm=True) as (server, loop):
        with Client(port=server.port, transport="shm",
                    shm_ring_bytes=shm_lane.MIN_RING) as c:
            assert c.allow("warm").allowed
            lane = c._lane
            ids = np.arange(512, dtype=np.uint64)
            frames = 12  # ~12.4 KB a reply: past a 64 KiB reply ring
            for rid in range(1, frames + 1):
                lane.send_frame(p.encode_allow_hashed(rid, ids + rid))
            _wait_until(lambda: any(ln.overflow
                                    for ln in server._shm_lanes),
                        what="replies to overflow the reply ring")
            got = []
            for _ in range(frames):
                reply = _pop_within(lane.inbound, 2.0)
                assert reply is not None, f"stalled after {len(got)}"
                got.append(p.parse_header(reply)[2])
            assert sorted(got) == list(range(1, frames + 1))
            assert c.allow("after").allowed
    lim.close()


_LOADGEN_RUNS = [("port", i) for i in range(7)] + [("jax", i)
                                                    for i in range(3)]


@pytest.fixture(scope="module")
def loadgens(tmp_path_factory):
    """The port's C++ load generator and the JAX package's unchanged one
    (clients/cpp/loadgen.cpp, which does not fence its publish against
    its flag read)."""
    from ratelimiter_tpu_torch import native

    out = str(tmp_path_factory.mktemp("jax_loadgen") / "rltpu_loadgen")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-pthread",
         "-I" + os.path.join(REPO, "clients", "cpp"),
         "-I" + os.path.join(REPO, "ratelimiter_tpu", "native"),
         os.path.join(REPO, "clients", "cpp", "loadgen.cpp"), "-o", out],
        check=True, capture_output=True, timeout=120)
    return {"port": native.build_loadgen(), "jax": out}


@pytest.mark.parametrize("gen,run", _LOADGEN_RUNS)
def test_c16_loadgen_over_the_asyncio_doors_lane_completes(loadgens, gen,
                                                           run):
    """C16's input: the C++ load generator at ``0.5 8 8 512 1000000
    hashed --transport shm`` against the asyncio door with the lane on,
    over a config-3-shaped limiter (d=2, w=1024). Where two of six runs
    completed nothing (and one hung), every run must complete frames,
    under its own timeout: ten runs, seven with the port's generator and
    three with the JAX one."""
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=100,
                   window=60.0, sketch=T.SketchParams(
                       depth=2, width=1024, sub_windows=60))
    lim = T.create_limiter(cfg, backend="sketch", device="cpu")
    with _loop_server(RateLimitServer, lim, registry=Registry(),
                      shm=True) as (server, loop):
        proc = subprocess.run(
            [loadgens[gen], "127.0.0.1", str(server.port), "0.5", "8", "8",
             "512", "1000000", "hashed", "--transport", "shm"],
            capture_output=True, text=True, timeout=30)
    lim.close()
    assert proc.returncode == 0, proc.stderr[-500:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["completed"] > 0, out


_TEAR_READER = r"""
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>
int main(int argc, char** argv) {
  int fd = open(argv[1], O_RDONLY);
  size_t len = (size_t)atol(argv[2]), off = (size_t)atol(argv[3]);
  void* m = mmap(nullptr, len, PROT_READ, MAP_SHARED, fd, 0);
  auto* w = reinterpret_cast<std::atomic<uint64_t>*>((char*)m + off);
  auto stop = std::chrono::steady_clock::now() + std::chrono::milliseconds(
      atoi(argv[4]));
  uint64_t last = 0, tears = 0, reads = 0;
  printf("ready\n");
  fflush(stdout);
  while (std::chrono::steady_clock::now() < stop) {
    uint64_t x = w->load(std::memory_order_acquire);
    ++reads;
    if (x < last) ++tears; else last = x;
  }
  printf("%llu %llu\n", (unsigned long long)reads, (unsigned long long)tears);
}
"""


def test_c17_ring_positions_are_stored_whole(tmp_path):
    """C17: the ring's tail, stored by the Python side while a C++ reader
    in another process loads it as one 8-byte word, never reads smaller
    than a value it read before (the tail only grows). Stored through
    ``struct.pack_into`` (byte by byte) it read torn, some millions of
    times a second; stored whole it reads torn never."""
    src, exe = tmp_path / "tear.cpp", str(tmp_path / "tear")
    src.write_text(_TEAR_READER)
    subprocess.run(["g++", "-O2", "-std=c++17", str(src), "-o", exe],
                   check=True, capture_output=True, timeout=120)
    cap = shm_lane.MIN_RING
    path = tmp_path / "lane"
    size = shm_lane.total_bytes(cap, cap)
    path.write_bytes(b"\0" * size)
    with open(path, "r+b") as f:
        mm = mmap.mmap(f.fileno(), size)
    shm_lane.init_header(mm, cap, cap)
    _, ring = shm_lane.attach(mm, server=False)
    reader = subprocess.Popen(
        [exe, str(path), str(size), str(ring._ctrl + 64), "700"],
        stdout=subprocess.PIPE, text=True)
    try:
        assert reader.stdout.readline().strip() == "ready"
        v, deadline = 0, time.monotonic() + 0.5
        while time.monotonic() < deadline:
            for _ in range(2000):
                v += 0xFF                 # carries across byte boundaries
                ring._set_tail(v)
        reads, tears = map(int, reader.communicate(timeout=30)[0].split())
    finally:
        if reader.poll() is None:
            reader.kill()
            reader.wait()
    assert ring._tail() == v
    mm.close()
    assert reads > 0 and tears == 0, (reads, tears)


_KILL9 = """
import os, struct, sys
sys.path.insert(0, {repo!r})
from ratelimiter_tpu_torch.serving.client import Client
from ratelimiter_tpu_torch.serving import shm as shm_lane
c = Client("127.0.0.1", {port}, transport="shm")
assert c.allow("warm").allowed
ring = c._lane.outbound
tail = ring._tail()
base = ring._data + (tail & ring._mask)
# A torn publish: the size says 64 bytes, the commit word is junk, the
# tail is published, as a crash mid-copy leaves it.
struct.pack_into("<II", ring._mm, base, 64, 0xDEADBEEF)
ring._set_tail(tail + 8 + 64)
shm_lane._ding(c._lane.efd_server)
print("POISONED", flush=True)
os.kill(os.getpid(), 9)
"""


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_kill9_mid_write_never_stalls_the_door(door, tmp_path):
    lim = _port_limiter(limit=10 ** 6)
    ctx = (_native(lim, shm=True, shm_dir=str(tmp_path))
           if door == "native" else _loop_server(
               RateLimitServer, lim, shm=True, shm_dir=str(tmp_path)))
    with ctx as got:
        srv = got if door == "native" else got[0]
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_KILL9).format(
                repo=REPO, port=srv.port)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            assert "POISONED" in proc.stdout.readline()
            proc.wait(timeout=20)
            assert proc.returncode == -signal.SIGKILL
            _wait_until(lambda: srv.transport_stats()["shm"][
                "lanes_active"] == 0, what="poisoned lane teardown")
            with Client(port=srv.port) as c:
                assert c.allow("alive").allowed
            with Client(port=srv.port, transport="shm") as c:
                assert c.allow("alive-shm").allowed
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()
    assert not os.listdir(tmp_path)
    lim.close()


# ------------------------------------------------------- record-level fuzz


def _fresh_ring():
    cap = shm_lane.MIN_RING
    mm = mmap.mmap(-1, shm_lane.total_bytes(cap, cap))
    shm_lane.init_header(mm, cap, cap)
    req, _rep = shm_lane.attach(mm, server=True)
    return mm, req


class TestRecordFuzz:
    """pop() returns bytes or raises ShmProtocolError: never a hang, an
    out-of-bounds read or a silent spin (the JAX module's cases)."""

    PAYLOAD = p.encode_allow_n(7, "fuzz-key", 3)

    def test_clean_roundtrip_baseline(self):
        mm, ring = _fresh_ring()
        assert ring.try_push(self.PAYLOAD)
        assert ring.pop() == self.PAYLOAD
        assert ring.pop() is None
        mm.close()

    def test_truncated_publish_every_length(self):
        rec_len = 8 + shm_lane.align8(len(self.PAYLOAD))
        for cut in range(rec_len):
            mm, ring = _fresh_ring()
            assert ring.try_push(self.PAYLOAD)
            base = ring._data
            keep = bytes(mm[base:base + cut])
            mm[base:base + rec_len] = b"\x00" * rec_len
            mm[base:base + cut] = keep
            try:
                got = ring.pop()
                if got is not None:
                    assert len(got) == len(self.PAYLOAD)
            except shm_lane.ShmProtocolError:
                pass
            mm.close()

    def test_bitflip_every_header_bit(self):
        for bit in range(64):
            mm, ring = _fresh_ring()
            assert ring.try_push(self.PAYLOAD)
            mm[ring._data + bit // 8] ^= 1 << (bit % 8)
            try:
                assert ring.pop() is not None
            except shm_lane.ShmProtocolError:
                pass
            mm.close()

    def test_bitflip_payload_is_framing_safe(self):
        for byte in range(len(self.PAYLOAD)):
            mm, ring = _fresh_ring()
            assert ring.try_push(self.PAYLOAD)
            assert ring.try_push(self.PAYLOAD)
            mm[ring._data + 8 + byte] ^= 0xFF
            first = ring.pop()
            assert first is not None and len(first) == len(self.PAYLOAD)
            assert ring.pop() == self.PAYLOAD
            mm.close()

    def test_giant_size_rejected_not_overread(self):
        mm, ring = _fresh_ring()
        assert ring.try_push(self.PAYLOAD)
        size = shm_lane.MAX_RING * 4
        struct.pack_into("<II", mm, ring._data, size,
                         size ^ shm_lane.COMMIT_XOR)
        with pytest.raises(shm_lane.ShmProtocolError):
            ring.pop()
        mm.close()

    def test_wrap_pad_fuzz(self):
        mm, ring = _fresh_ring()
        assert ring.try_push(self.PAYLOAD)
        struct.pack_into("<II", mm, ring._data, shm_lane.MAX_RING * 8,
                         shm_lane.COMMIT_WRAP)
        with pytest.raises(shm_lane.ShmProtocolError):
            ring.pop()
        mm.close()
