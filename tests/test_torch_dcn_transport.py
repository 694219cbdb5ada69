"""DCN pushes over a real transport in the port: T_DCN_PUSH frames
between the port's doors (serving/dcn_peer.py, serving/server.py,
serving/native_server.py), on the CPU.

The counterparts of tests/test_dcn_transport.py's classes: the frames
(byte-identical to the JAX encoders' for a fixed sender and sequence),
pushes over TCP to the asyncio door, the RLA2 envelope's auth and its
replay guard, the native door's receive path, and two port binaries
peered as processes. Across the packages: a port pusher feeding a JAX
door and a JAX pusher feeding a port door, on both doors, leave the two
receivers in equal states. Every socket carries a timeout and every
child process a wait limit.
"""

from __future__ import annotations

import asyncio
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.serving import protocol as JP
from ratelimiter_tpu_torch.parallel import dcn
from ratelimiter_tpu_torch.serving import Client
from ratelimiter_tpu_torch.serving import protocol as p
from ratelimiter_tpu_torch.serving.dcn_peer import (
    DcnPusher,
    _PeerConn,
    merge_push_payload,
    parse_peer,
)
from ratelimiter_tpu_torch.serving.native_server import NativeRateLimitServer
from ratelimiter_tpu_torch.serving.server import RateLimitServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
WINDOWED, BUCKET = "TPU_SKETCH", "TOKEN_BUCKET"


def _cfg(M, algo=WINDOWED, *, depth=3, width=256):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=10,
                    window=6.0,
                    sketch=M.SketchParams(depth=depth, width=width,
                                          sub_windows=6, **extra))


def _pod(algo=WINDOWED, M=T, **kw):
    opt = {} if M is R else {"device": "cpu"}
    return M.create_limiter(_cfg(M, algo, **kw), backend="sketch",
                            clock=M.ManualClock(T0), **opt)


def _roll(*pods):
    """Complete the current sub-window on every pod."""
    for x in pods:
        x.clock.advance(1.0)
        x.allow("warm")


def _free_port() -> int:
    """A port free when probed: nobody listens on it."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class AsyncDoor:
    """An asyncio door (either package's) on a loop of its own thread."""

    def __init__(self, limiter, server_cls=RateLimitServer, **kw):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.srv = server_cls(limiter, "127.0.0.1", 0, **kw)
        asyncio.run_coroutine_threadsafe(self.srv.start(),
                                         self.loop).result(30)
        self.port = self.srv.port

    def close(self):
        asyncio.run_coroutine_threadsafe(self.srv.shutdown(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


def _push(port, frame, req_id):
    peer = _PeerConn("127.0.0.1", port)
    try:
        peer.push(frame, req_id)
    finally:
        peer.close()


# ------------------------------------------------------------- frames


def test_frames_roundtrip_and_equal_the_jax_encoders():
    periods = np.array([5, 9], dtype=np.int64)
    slabs = np.arange(2 * 3 * 16, dtype=np.int32).reshape(2, 3, 16)
    delta = np.arange(3 * 16, dtype=np.int64).reshape(3, 16) - 7
    lease = {"scope": "key", "key_hash": "00ff", "reason": "policy",
             "epoch": 3}
    for kw in ({}, {"secret": "s"},
               {"secret": "s", "sender": 0xFEED, "seq": 1 << 50}):
        assert (p.encode_dcn_slabs(7, periods, slabs, 1_000_000, **kw)
                == JP.encode_dcn_slabs(7, periods, slabs, 1_000_000, **kw))
        assert (p.encode_dcn_debt(9, delta, **kw)
                == JP.encode_dcn_debt(9, delta, **kw))
        assert (p.encode_dcn_lease(4, lease, **kw)
                == JP.encode_dcn_lease(4, lease, **kw))
    frame = p.encode_dcn_slabs(7, periods, slabs, 1_000_000)
    _, type_, rid = p.parse_header(frame[:p.HEADER_SIZE])
    assert type_ == p.T_DCN_PUSH and rid == 7
    kind, got_p, got_s = p.parse_dcn(frame[p.HEADER_SIZE:], 3, 16,
                                     1_000_000)
    assert kind == p.DCN_KIND_SLABS
    np.testing.assert_array_equal(got_p, periods)
    np.testing.assert_array_equal(got_s, slabs)
    kind, got, _ = p.parse_dcn(p.encode_dcn_debt(9, delta)[13:], 3, 16, 0)
    assert kind == p.DCN_KIND_DEBT
    np.testing.assert_array_equal(got, delta)
    body = p.unwrap_dcn_auth(p.encode_dcn_lease(4, lease, "s", sender=1,
                                                seq=2)[13:], "s")
    assert p.parse_dcn_lease(body[1:]) == lease


def test_geometry_and_subwindow_mismatch_rejected():
    frame = p.encode_dcn_debt(1, np.zeros((3, 16), dtype=np.int64))
    with pytest.raises(p.ProtocolError, match="geometry"):
        p.parse_dcn(frame[p.HEADER_SIZE:], 4, 16, 0)
    frame = p.encode_dcn_slabs(1, np.array([5], np.int64),
                               np.zeros((1, 3, 16), np.int32), 1_000_000)
    with pytest.raises(T.InvalidConfigError, match="sub-window"):
        p.parse_dcn(frame[p.HEADER_SIZE:], 3, 16, 500_000)
    with pytest.raises(p.ProtocolError, match="unknown DCN kind"):
        p.parse_dcn(b"\x09", 3, 16, 0)


def test_dcn_frames_may_exceed_request_cap_where_allowed():
    frame = p.encode_dcn_debt(1, np.zeros((4, 65536), dtype=np.int64))
    length, type_, _ = p.parse_header(frame[:p.HEADER_SIZE], allow_dcn=True)
    assert length > p.MAX_FRAME and type_ == p.T_DCN_PUSH
    traced = p.with_trace(frame, 5)
    assert p.parse_header(traced[:13], allow_dcn=True)[1] == (
        p.T_DCN_PUSH | p.TRACE_FLAG)
    with pytest.raises(p.ProtocolError):
        p.parse_header(frame[:p.HEADER_SIZE])
    with pytest.raises(p.ProtocolError):
        p.parse_header(struct.pack("<IBQ", p.MAX_DCN_FRAME + 1,
                                   p.T_DCN_PUSH, 1), allow_dcn=True)


def test_parse_peer_and_fleet_frames_refused():
    assert parse_peer("10.0.0.2:9000") == ("10.0.0.2", 9000)
    assert parse_peer(":9000") == ("127.0.0.1", 9000)
    with pytest.raises(ValueError):
        parse_peer("nohost")
    lim = _pod()
    try:
        fleet = bytes([p.DCN_KIND_FLEET]) + b"\x02\x00\x00\x00{}"
        with pytest.raises(T.InvalidConfigError, match="fleet"):
            merge_push_payload([lim], fleet)
        got = []
        merge_push_payload([lim], p.encode_dcn_lease(
            1, {"scope": "all", "reason": "manual"})[13:],
            on_lease=got.append)
        assert got == [{"scope": "all", "reason": "manual"}]
        merge_push_payload([lim], p.encode_dcn_lease(1, {"x": 1})[13:])
    finally:
        lim.close()


# ------------------------------------------------------- push over TCP


def test_windowed_slabs_push():
    a, b = _pod(), _pod()
    door = AsyncDoor(b, dcn=True)
    try:
        assert a.allow_n("k", 10).allowed
        _roll(a, b)
        pusher = DcnPusher(a, [("127.0.0.1", door.port)])
        assert pusher.sync_once() == 1
        assert not b.allow("k").allowed
        assert pusher.sync_once() == 0
        pusher.stop()
    finally:
        door.close()
        a.close()


def test_bucket_debt_push():
    a, b = _pod(BUCKET), _pod(BUCKET)
    door = AsyncDoor(b, dcn=True)
    try:
        assert a.allow_n("k", 10).allowed
        pusher = DcnPusher(a, [("127.0.0.1", door.port)])
        assert pusher.sync_once() == 1
        assert not b.allow("k").allowed
        assert pusher.sync_once() == 0
        pusher.stop()
    finally:
        door.close()
        a.close()


def test_dcn_frames_rejected_when_not_enabled():
    a, b = _pod(BUCKET), _pod(BUCKET)
    door = AsyncDoor(b)
    try:
        a.allow_n("k", 5)
        with pytest.raises(T.InvalidConfigError, match="not enabled"):
            _push(door.port, p.encode_dcn_debt(1, dcn.export_debt(a)), 1)
        with socket.create_connection(("127.0.0.1", door.port),
                                      timeout=10) as sk:
            sk.sendall(struct.pack("<IBQ", 48 << 20, p.T_DCN_PUSH, 2))
            assert sk.recv(16) == b""
        assert b.allow("k").allowed
    finally:
        door.close()
        a.close()


def test_no_echo_of_foreign_slabs():
    a, b = _pod(), _pod()
    door_a, door_b = AsyncDoor(a, dcn=True), AsyncDoor(b, dcn=True)
    try:
        a.allow_n("k", 4)
        _roll(a, b)
        push_a = DcnPusher(a, [("127.0.0.1", door_b.port)])
        push_b = DcnPusher(b, [("127.0.0.1", door_a.port)])
        assert push_a.sync_once() == 1
        assert push_b.sync_once() == 1
        assert a.allow_n("k", 6).allowed
        assert not a.allow("k").allowed
        push_a.stop()
        push_b.stop()
    finally:
        door_a.close()
        door_b.close()


def test_debt_delta_restored_on_total_push_failure():
    a, b = _pod(BUCKET), _pod(BUCKET)
    pusher = DcnPusher(a, [("127.0.0.1", _free_port())])
    a.allow_n("k", 10)
    assert pusher.sync_once() == 0 and pusher.pushes_failed == 1
    door = AsyncDoor(b, dcn=True)
    try:
        pusher.peers[0].port = door.port
        assert pusher.sync_once() == 1
        assert not b.allow("k").allowed
        pusher.stop()
    finally:
        door.close()
        a.close()


def test_slab_pushes_chunk_under_frame_cap():
    a, b = _pod(), _pod()
    door = AsyncDoor(b, dcn=True)
    try:
        pusher = DcnPusher(a, [("127.0.0.1", door.port)])
        pusher._payload_budget = pusher._slab_bytes
        for i in range(4):
            a.allow_n(f"k{i}", 10)
            a.clock.advance(1.0)
            b.clock.advance(1.0)
        a.allow("warm")
        b.allow("warm")
        assert pusher.sync_once() == 1
        assert pusher.pushes_ok >= 4
        for i in range(4):
            assert not b.allow(f"k{i}").allowed
        pusher.stop()
    finally:
        door.close()
        a.close()


def test_oversized_geometry_rejected_at_construction():
    cfg = T.Config(algorithm=T.Algorithm.TPU_SKETCH, limit=10, window=6.0,
                   sketch=T.SketchParams(depth=16, width=1 << 21,
                                         sub_windows=6))
    lim = T.create_limiter(cfg, backend="sketch", clock=T.ManualClock(T0),
                           device="cpu")
    with pytest.raises(ValueError, match="too large"):
        DcnPusher(lim, [("127.0.0.1", 1)])
    lim.close()


def test_window_change_resets_the_watermarks():
    a, b = _pod(), _pod()
    door = AsyncDoor(b, dcn=True)
    try:
        pusher = DcnPusher(a, [("127.0.0.1", door.port)])
        a.allow_n("k", 4)
        _roll(a, b)
        assert pusher.sync_once() == 1
        a.update_window(12.0)
        assert pusher.sync_once() == 0
        assert pusher._sub_us == 2_000_000
        assert pusher._watermarks == [int(a._state["last_period"]) - 1]
        pusher.stop()
    finally:
        door.close()
        a.close()


def test_traced_cycle_records_the_dcn_span():
    from ratelimiter_tpu_torch.observability import tracing

    a, b = _pod(BUCKET), _pod(BUCKET)
    door = AsyncDoor(b, dcn=True)
    rec = tracing.enable(capacity=64)
    try:
        a.allow_n("k", 10)
        pusher = DcnPusher(a, [("127.0.0.1", door.port)])
        assert pusher.sync_once() == 1
        spans = [s for s in rec.dump() if s["stage"] == "dcn"]
        assert len(spans) == 1 and spans[0]["trace_id"] != 0
        assert not b.allow("k").allowed
        pusher.stop()
    finally:
        tracing.disable()
        door.close()
        a.close()


# ----------------------------------------------------------- auth, replay


@pytest.mark.parametrize("pusher_secret,door_secret,ok", [
    ("s3cret", "s3cret", True), (None, "s3cret", False),
    ("wrong", "s3cret", False), ("s3cret", None, True)])
def test_auth_envelope(pusher_secret, door_secret, ok):
    a, b = _pod(BUCKET), _pod(BUCKET)
    door = AsyncDoor(b, dcn=True, dcn_secret=door_secret)
    try:
        a.allow_n("k", 10)
        pusher = DcnPusher(a, [("127.0.0.1", door.port)],
                           secret=pusher_secret)
        assert pusher.sync_once() == int(ok)
        assert pusher.pushes_failed == int(not ok)
        assert b.allow("k").allowed != ok
        pusher.stop()
    finally:
        door.close()
        a.close()


@pytest.mark.parametrize("native", [False, True])
def test_replays_refused_before_any_merge(native):
    """A byte-identical replay, an older sequence, a stale first contact
    and a legacy RLA1 envelope are refused by a secret-bearing door, and
    none of them moves the receiver's state."""
    a, b = _pod(BUCKET), _pod(BUCKET)
    if native:
        door = NativeRateLimitServer(b, "127.0.0.1", 0, dcn=True,
                                     dcn_secret="s3cret")
        door.start()
        guard = door._dcn_guard
    else:
        door = AsyncDoor(b, dcn=True, dcn_secret="s3cret")
        guard = door.srv._dcn_guard
    try:
        a.allow_n("k", 5)
        delta = dcn.export_debt(a)
        seq = int(time.time() * 1e6)
        frame = p.encode_dcn_debt(1, delta, "s3cret", sender=7777, seq=seq)
        _push(door.port, frame, 1)
        debt = b._state["debt"].clone()
        bad = [(frame, "replayed"),
               (p.encode_dcn_debt(2, delta, "s3cret", sender=7777,
                                  seq=seq - 10), "replayed"),
               (p.encode_dcn_debt(3, delta, "s3cret", sender=99,
                                  seq=int((time.time() - 3600) * 1e6)),
                "stale"),
               (p.encode_dcn_debt(4, delta, "s3cret"), "RLA1")]
        for i, (f, why) in enumerate(bad):
            with pytest.raises(T.InvalidConfigError, match=why):
                _push(door.port, f, [1, 2, 3, 4][i])
        assert guard.rejected == 3
        assert b._state["debt"].equal(debt)
    finally:
        if native:
            door.shutdown()
        else:
            door.close()
        a.close()


def test_pusher_sequences_track_the_clock_and_pass_the_guard():
    a = _pod(BUCKET)
    pusher = DcnPusher(a, [], secret="s3cret")
    for _ in range(50):
        pusher._next_seq()
    guard = p.DcnReplayGuard(max_age_s=300.0)
    guard.check(pusher._sender, pusher._next_seq())
    s1, s2 = pusher._next_seq(), pusher._next_seq()
    assert s2 > s1 and guard.rejected == 0
    b = _pod(BUCKET)
    door = AsyncDoor(b, dcn=True, dcn_secret="s3cret")
    try:
        pusher.peers = [_PeerConn("127.0.0.1", door.port)]
        a.allow_n("k", 4)
        assert pusher.sync_once() == 1
        a.allow_n("k2", 3)
        assert pusher.sync_once() == 1
        assert pusher.pushes_failed == 0 and door.srv._dcn_guard.rejected == 0
        assert pusher.push_lease({"scope": "all", "reason": "manual"}) == 1
    finally:
        pusher.stop()
        door.close()
        a.close()


def test_lease_gossip_revokes_on_the_receiver():
    from ratelimiter_tpu_torch.leases import LeaseManager

    b = _pod()
    got = []

    class Leases:
        def on_gossip(self, payload):
            got.append(payload)

        def revoke_all(self, reason):
            return 0

    door = AsyncDoor(b, dcn=True, dcn_secret="s", leases=Leases())
    a = _pod()
    pusher = DcnPusher(a, [("127.0.0.1", door.port)], secret="s")
    try:
        mgr = LeaseManager(a, gossip=pusher.push_lease)
        assert mgr.revoke_all(p.LEASE_REV_MANUAL) == 0   # nothing to tell
        mgr.grant(1, "hot", 2)
        assert mgr.revoke_all(p.LEASE_REV_MANUAL) == 1
        assert got == [{"scope": "all", "reason": "manual", "epoch": 0}]
        assert pusher.pushes_ok == 1
        mgr.close()
    finally:
        pusher.stop()
        door.close()
        a.close()


# ------------------------------------------------------- the native door


def test_native_door_receives_pushes():
    a, b = _pod(), _pod()
    srv = NativeRateLimitServer(b, "127.0.0.1", 0, dcn=True)
    srv.start()
    try:
        assert a.allow_n("k", 10).allowed
        _roll(a, b)
        pusher = DcnPusher(a, [("127.0.0.1", srv.port)])
        assert pusher.sync_once() == 1
        assert not b.allow("k").allowed
        pusher.stop()
    finally:
        srv.shutdown()
        a.close()


def test_debt_push_to_native_door_with_secret():
    a, b = _pod(BUCKET), _pod(BUCKET)
    srv = NativeRateLimitServer(b, "127.0.0.1", 0, dcn=True,
                                dcn_secret="s3cret")
    srv.start()
    try:
        a.allow_n("k", 10)
        bad = DcnPusher(a, [("127.0.0.1", srv.port)])
        assert bad.sync_once() == 0
        bad.stop()
        good = DcnPusher(a, [("127.0.0.1", srv.port)], secret="s3cret")
        assert good.sync_once() == 1
        assert not b.allow("k").allowed
        good.stop()
        # Garbage labelled as a slab-sized push dies at the pre-screen:
        # no RLA magic where auth is required.
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=10) as sk:
            sk.sendall(struct.pack("<IBQ", 8 << 20, p.T_DCN_PUSH, 9)
                       + b"XXXX")
            assert sk.recv(16) == b""
    finally:
        srv.shutdown()
        a.close()


def test_native_door_without_dcn_refuses_pushes():
    a, b = _pod(BUCKET), _pod(BUCKET)
    srv = NativeRateLimitServer(b, "127.0.0.1", 0)
    srv.start()
    try:
        a.allow_n("k", 5)
        with pytest.raises(T.InvalidConfigError, match="not enabled"):
            _push(srv.port, p.encode_dcn_debt(1, dcn.export_debt(a)), 1)
        assert b.allow("k").allowed
    finally:
        srv.shutdown()
        a.close()


def test_large_frame_exceeding_request_cap_accepted():
    a = _pod(BUCKET, depth=4, width=1 << 18)
    b = _pod(BUCKET, depth=4, width=1 << 18)
    srv = NativeRateLimitServer(b, "127.0.0.1", 0, dcn=True)
    srv.start()
    try:
        a.allow_n("k", 10)
        pusher = DcnPusher(a, [("127.0.0.1", srv.port)])
        assert pusher.sync_once() == 1
        assert not b.allow("k").allowed
        pusher.stop()
    finally:
        srv.shutdown()
        a.close()


def test_push_merges_into_every_shard():
    a, b = _pod(BUCKET), _pod(BUCKET)
    srv = NativeRateLimitServer(b, "127.0.0.1", 0, shards=4, dcn=True)
    srv.start()
    try:
        keys = [f"user:{i}" for i in range(8)]
        assert len({srv.shard_of(k) for k in keys}) > 1
        for k in keys:
            a.allow_n(k, 10)
        pusher = DcnPusher(a, [("127.0.0.1", srv.port)])
        assert pusher.sync_once() == 1
        with Client(port=srv.port, timeout=30.0) as c:
            for k in keys:
                assert not c.allow(k).allowed
            assert c.allow("fresh").allowed
        pusher.stop()
    finally:
        srv.shutdown()
        a.close()


# ----------------------------------------------------- across the packages


def _jax_door(lim, native, secret):
    from ratelimiter_tpu.serving import RateLimitServer as JaxServer

    if native:
        from ratelimiter_tpu.serving.native_server import (
            NativeRateLimitServer as JaxNative,
        )

        srv = JaxNative(lim, "127.0.0.1", 0, dcn=True, dcn_secret=secret)
        srv.start()
        return srv, srv.port, srv.shutdown
    door = AsyncDoor(lim, JaxServer, dcn=True, dcn_secret=secret)
    return door, door.port, door.close


def _port_door(lim, native, secret):
    if native:
        srv = NativeRateLimitServer(lim, "127.0.0.1", 0, dcn=True,
                                    dcn_secret=secret)
        srv.start()
        return srv, srv.port, srv.shutdown
    door = AsyncDoor(lim, dcn=True, dcn_secret=secret)
    return door, door.port, door.close


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("algo", [WINDOWED, BUCKET])
def test_port_and_jax_pods_peer_both_ways(native, algo):
    """A JAX pod and a port pod with the same seeded traffic push, with a
    shared secret, the port's to a JAX door and the JAX one's to a port
    door: the two receivers end in equal states and answer equally."""
    from ratelimiter_tpu.serving.dcn_peer import DcnPusher as JaxPusher

    ja, ta = _pod(algo, R), _pod(algo, T)
    jb, tb = _pod(algo, R), _pod(algo, T)
    jdoor, jport, jclose = _jax_door(jb, native, "x")
    tdoor, tport, tclose = _port_door(tb, native, "x")
    rng = np.random.default_rng(5)
    try:
        t_push = DcnPusher(ta, [("127.0.0.1", jport)], secret="x")
        j_push = JaxPusher(ja, [("127.0.0.1", tport)], secret="x")
        for _ in range(3):
            keys = [f"u{int(k)}" for k in rng.integers(0, 6, 24)]
            for x in (ja, ta):
                x.allow_batch(keys)
            _roll(ja, ta, jb, tb)
            assert t_push.sync_once() == j_push.sync_once() == 1
        _, sj, _ = jb.capture_state()
        _, st, _ = tb.capture_state()
        assert set(sj) == set(st)
        for k in sj:
            np.testing.assert_array_equal(np.asarray(sj[k]),
                                          np.asarray(st[k]), err_msg=k)
        keys = [f"u{i}" for i in range(12)]
        x, y = jb.allow_batch(keys), tb.allow_batch(keys)
        np.testing.assert_array_equal(x.allowed, y.allowed)
        np.testing.assert_array_equal(x.remaining, y.remaining)
        assert not y.allowed.all()
        t_push.stop()
        j_push.stop()
    finally:
        jclose()
        tclose()
        for x in (ja, ta):
            x.close()


# ------------------------------------------------------- two processes


def _binary(args, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ratelimiter_tpu_torch.serving", "--device",
         "cpu", *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    ready = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                ready.set()
        ready.set()

    threading.Thread(target=read, daemon=True).start()
    if not ready.wait(120) or not any(x.startswith("serving")
                                      for x in lines):
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError("binary did not start: " + "".join(lines[-20:]))
    return proc


def _stop_all(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    rcs = []
    for proc in procs:
        try:
            rcs.append(proc.wait(timeout=30))
        except subprocess.TimeoutExpired:
            proc.kill()
            rcs.append(proc.wait(timeout=30))
    return rcs


@pytest.mark.parametrize("native", [False, True])
def test_two_port_binaries_converge(native):
    """Two port binaries peered with ``--dcn-peer`` and the secret in
    ``RATELIMITER_TPU_DCN_SECRET``: keys spent on A are denied on B within
    a few cycles (at most 8 probes on B, fewer than the limit of 10, so
    a deny proves A's traffic landed), fresh keys stay allowed. The
    asyncio pair runs the token bucket; the native pair the sliding
    window with two shards on A (one pusher a shard)."""
    env = dict(os.environ, RATELIMITER_TPU_DCN_SECRET="two-proc-secret")
    pa, pb = _free_port(), _free_port()
    common = (["--algorithm", "token_bucket", "--limit", "10", "--window",
               "60"] if not native else
              ["--algorithm", "sliding_window", "--limit", "10",
               "--window", "30", "--sub-windows", "30", "--native"])
    common += ["--sketch-depth", "3", "--sketch-width", "256",
               "--dcn-interval", "0.2"]
    procs = [_binary(common + ["--port", str(pa), "--dcn-peer",
                               f"127.0.0.1:{pb}"]
                     + (["--shards", "2"] if native else []), env)]
    try:
        procs.append(_binary(common + ["--port", str(pb), "--dcn-peer",
                                       f"127.0.0.1:{pa}"], env))
        keys = [f"user:{i}" for i in range(4)]
        with Client(port=pa, timeout=30.0) as ca, \
                Client(port=pb, timeout=30.0) as cb:
            for k in keys:
                assert ca.allow_n(k, 10).allowed
            converged = False
            for _ in range(8):
                ca.allow("warm-a")
                cb.allow("warm-b")
                time.sleep(1.0)
                if all(not cb.allow(k).allowed for k in keys):
                    converged = True
                    break
            assert converged, "A's traffic never became visible on B"
            assert cb.allow("fresh").allowed
    finally:
        rcs = _stop_all(procs)
    assert rcs == [0, 0]


# ------------------------------- chip_smoke.py's phase dcn, on the CPU


def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


#: Phase dcn (b)'s binaries at a narrow width: config 3's limit, window
#: and sub-windows (so the probe budget and the cycle are the card's).
_SMOKE_BINARY = ("--algorithm", "sliding_window", "--limit", "100",
                 "--window", "60", "--sketch-depth", "4", "--sketch-width",
                 "4096", "--sub-windows", "60", "--hh-slots", "256",
                 "--flight-recorder")


def _smoke_pod(cs, flags):
    """A pod of the binaries' config with a few completed sub-windows,
    behind the wall clock as phase dcn's are."""
    from ratelimiter_tpu_torch.serving.__main__ import build_config, parse_args

    pod = T.create_limiter(build_config(parse_args(list(flags))),
                           clock=T.ManualClock(float(int(time.time()) - 600)),
                           device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        pod.allow_ids(cs.zipf_ids(rng, 1024))
        pod.clock.advance(1.0)
    return pod


@pytest.mark.parametrize("algo", ["windowed", "bucket"])
def test_smoke_dcn_group_on_cpu(algo):
    """chip_smoke.py's phase dcn (a) at a narrow width, both pods on the
    CPU: every decision, sync count and pod state equal to the twins'."""
    import dataclasses

    cs = _chip_smoke()
    base = cs.config3_hh() if algo == "windowed" else cs.config2_bucket()
    sk = dataclasses.replace(base.sketch, width=4096,
                             **({"sub_windows": 8} if algo == "windowed"
                                else {}))
    cfg = dataclasses.replace(base, sketch=sk, **(
        {"window": 8.0} if algo == "windowed" else {}))
    warm, advance = (8, 1.0) if algo == "windowed" else (1, cs.C2_ADVANCE)
    out = cs.check_dcn_group(torch, algo, cfg, 3,
                             float(int(time.time()) - 600), warm, 2,
                             advance, device="cpu")
    for pod in out["pods"]:
        pod.close()
    assert len(out["syncs"]) == 3
    assert all(s["applied"] for s in out["syncs"])


def test_smoke_dcn_binaries_on_cpu():
    """chip_smoke.py's phase dcn (b) at a narrow width on the CPU: the
    asyncio and native binaries peered with the secret, each one's spend
    denied on the other within the probe budget, equal to the replay,
    both binaries' push spans counted, replayed and unsigned frames
    refused, a pod's pusher delivering every cycle."""
    cs = _chip_smoke()
    pod = _smoke_pod(cs, _SMOKE_BINARY)
    try:
        out = cs.check_dcn_binaries(pod, 0, device="cpu",
                                    flags=_SMOKE_BINARY
                                    + ("--dcn-interval", "1"))
    finally:
        pod.close()
    assert out["refused"] == ["replayed", "unauthenticated"]
    assert all(v["pushes"] for v in out["binary_push_spans"].values())
    assert out["pusher_cycles"][0]["frames"] >= 1


def test_smoke_dcn_binaries_fail_without_pushes():
    """The same check with both binaries' pushers idle (a cycle of 1000
    s): neither spend reaches the other binary, and the probes alone,
    a quarter of the limit, never deny a key, so the check fails."""
    cs = _chip_smoke()
    pod = _smoke_pod(cs, _SMOKE_BINARY)
    try:
        with pytest.raises(AssertionError, match="never reached"):
            cs.check_dcn_binaries(pod, 0, device="cpu",
                                  flags=_SMOKE_BINARY
                                  + ("--dcn-interval", "1000"))
    finally:
        pod.close()


def test_smoke_dcn_mesh_restart_on_cpu(tmp_path):
    """chip_smoke.py's phase dcn (c) at a narrow width on the CPU: the
    mesh binary killed at 4 slices and restarted at 2 re-buckets its
    snapshot, and answers as a 2-slice CPU mesh restored from it."""
    cs = _chip_smoke()
    flags = list(cs.DCN_MESH)
    flags[flags.index("--sketch-width") + 1] = "4096"
    out = cs.check_dcn_mesh_restart(0, str(tmp_path), device="cpu",
                                    flags=flags)
    assert out["recovered"].startswith("recovered:")
