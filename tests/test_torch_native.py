"""The port's native C++ door against the JAX package's.

Both doors run on the CPU over limiters fed the same seeded frames one
at a time on one manual clock, so each dispatch holds one frame: the
JAX door over the JAX ``kernels="jnp"`` limiter, the port's over its
CPU limiter. Their reply bytes must be equal for ALLOW_N, ALLOW_BATCH,
ALLOW_HASHED, RESET, the frames the C++ door answers inline (an empty
key, n = 0, invalid UTF-8, DCN, an unknown type) and the trace and
deadline extensions; HEALTH and METRICS (the families and the shard
gauges) compare field by field; an oversized frame closes the
connection on both. Frames with the forward hint (0x10) are served by
both doors alike, and a fleet member on the native door forwards the
rows it does not own (equal to JAX replays of each owner's rows). With
two
dispatch shards each key is decided on its FNV shard in both packages.
Pipelined traffic (several connections, 8 frames in flight, string
frames carved at the ``max_batch`` boundary) is held to replays of the
recorded windows (``chip_smoke.check_native_door`` on the CPU), a reset
replayed from the WAL lands on its key's shard, the door starts and
stops 200 times with dispatchers busy (the lost wake-up of the JAX
door), a failed build raises with the compiler's message, and the
binary serves with ``--native`` and recovers after a kill.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.observability.decorators import (
    MetricsDecorator as JaxMetrics,
)
from ratelimiter_tpu.observability.metrics import Registry as JaxRegistry
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu.serving.native_server import (
    NativeRateLimitServer as JaxNative,
)
from ratelimiter_tpu_torch import native
from ratelimiter_tpu_torch.observability.decorators import MetricsDecorator
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.native_server import (
    NativeRateLimitServer,
    fnv_shard,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its native door check, run on the CPU)

T0 = 1_000_000.0


def _cfg(M, kind: str, *, kernels=None):
    sk = dict(depth=2, width=256, sub_windows=6)
    if kernels is not None:
        sk["kernels"] = kernels
    algo = "TOKEN_BUCKET" if kind == "bucket" else "SLIDING_WINDOW"
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=7,
                    window=6.0, sketch=M.SketchParams(**sk))


def _limiters(kind: str):
    """(JAX limiter, port CPU limiter), each on its own ManualClock: the
    sketch (the JAX one on ``kernels="jnp"``), or with ``kind`` "exact"
    the host backends (the door's blocking string lane)."""
    if kind == "exact":
        return (R.create_limiter(_cfg(R, kind), backend="exact",
                                 clock=R.ManualClock(T0)),
                T.create_limiter(_cfg(T, kind), backend="exact",
                                 clock=T.ManualClock(T0)))
    j = R.create_limiter(_cfg(R, kind, kernels="jnp"), backend="sketch",
                         clock=R.ManualClock(T0))
    t = T.create_limiter(_cfg(T, kind), backend="sketch",
                         clock=T.ManualClock(T0), device="cpu")
    return j, t


def _recv(sock: socket.socket) -> bytes:
    """One reply frame (the caller sends one request at a time)."""
    buf = b""
    while len(buf) < 4 or len(buf) < 4 + struct.unpack_from("<I", buf)[0]:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    assert len(buf) == 4 + struct.unpack_from("<I", buf)[0]
    return buf


#: Seconds the JAX door's shutdown may take before its test goes on.
REFERENCE_SHUTDOWN_S = 30.0


def _shutdown_reference(door) -> None:
    """The JAX door's shutdown on a thread of its own (it releases the
    GIL): the JAX door's lost wake-up (ROADMAP.md §C; its ``server.cpp``
    is not edited) can leave it joining its responder forever, which
    held a whole xdist worker until the run's time limit. Past
    ``REFERENCE_SHUTDOWN_S`` the test goes on with a warning, the
    reference door's threads left behind; the port's door is shut down
    on the test's own thread as before."""
    t = threading.Thread(target=door.shutdown, daemon=True,
                         name="jax-door-shutdown")
    t.start()
    t.join(REFERENCE_SHUTDOWN_S)
    if t.is_alive():
        import warnings

        warnings.warn(f"the JAX native door's shutdown did not return in "
                      f"{REFERENCE_SHUTDOWN_S} s (its lost wake-up)")


@contextlib.contextmanager
def _doors(kind: str, shards: int = 1, **kw):
    """Both packages' native doors over fresh limiters, each shard under
    MetricsDecorator(shard=i) in its package's registry, as the binaries
    build them (``kw``: more door arguments for both); yields ((jax door,
    jax limiter), (port door, port limiter))."""
    jlim, tlim = _limiters(kind)
    jreg, treg = JaxRegistry(), Registry()
    jdoor = JaxNative(JaxMetrics(jlim, registry=jreg), "127.0.0.1", 0,
                      registry=jreg, shards=shards,
                      shard_decorate=lambda lim, i: JaxMetrics(
                          lim, registry=jreg, shard=str(i)), **kw)
    tdoor = NativeRateLimitServer(
        MetricsDecorator(tlim, registry=treg), "127.0.0.1", 0,
        registry=treg, shards=shards,
        shard_decorate=lambda lim, i: MetricsDecorator(
            lim, registry=treg, shard=str(i)), **kw)
    jdoor.start()
    tdoor.start()
    try:
        yield (jdoor, jlim), (tdoor, tlim)
    finally:
        _shutdown_reference(jdoor)
        tdoor.shutdown()
        jlim.close()
        tlim.close()


def _bad_utf8_allow(rid: int) -> bytes:
    key = b"\xff\xfe"
    body = struct.pack("<IH", 1, len(key)) + key
    return struct.pack("<IBQ", 9 + len(body), tp.T_ALLOW_N, rid) + body


def _seeded_frames(seed: int) -> list:
    """One frame a step: decisions on a few keys and ids (so counters
    collide and cross the limit), resets, the inline-answered frames
    and the frame extensions."""
    rng = np.random.default_rng(seed)
    keys = [f"u:{i}" for i in range(6)] + ["ключ"]
    frames = []
    rid = 0
    for step in range(48):
        rid += 1
        k = step % 12
        if k in (0, 4, 9):
            frames.append(tp.encode_allow_n(
                rid, keys[rng.integers(len(keys))], int(rng.integers(1, 4))))
        elif k == 1:
            pick = rng.integers(len(keys), size=5)
            frames.append(tp.encode_allow_batch(
                rid, [keys[i] for i in pick],
                rng.integers(1, 3, size=5).tolist()))
        elif k in (2, 7):
            frames.append(tp.encode_allow_hashed(
                rid, rng.integers(0, 12, size=9).astype(np.uint64),
                rng.integers(1, 3, size=9)))
        elif k == 3:
            frames.append(tp.encode_reset(rid, keys[rng.integers(len(keys))]))
        elif k == 5:
            frames.append(tp.with_trace(tp.encode_allow_n(
                rid, keys[rng.integers(len(keys))], 1), 0xABC0 + step))
        elif k == 6:
            frames.append(tp.with_trace(tp.with_deadline(
                tp.encode_allow_hashed(
                    rid, rng.integers(0, 12, size=4).astype(np.uint64)),
                5.0), 0x5150))
        elif k == 8:
            frames.append(tp.with_deadline(tp.encode_allow_batch(
                rid, keys[:3], [1, 1, 1]), 5.0))
        elif k == 10 and step == 22:
            # The frames the C++ door answers inline, all at once.
            frames += [
                tp.encode_allow_n(rid, "", 1),
                tp.encode_allow_n(rid + 1, "u:1", 0),
                _bad_utf8_allow(rid + 2),
                tp.encode_allow_batch(rid + 3, ["a", ""], [1, 1]),
                tp.encode_allow_batch(rid + 4, ["a", "b"], [1, 0]),
                tp.encode_simple(tp.T_DCN_PUSH, rid + 5),
                tp.encode_simple(12, rid + 6),
                tp.encode_policy_key(tp.T_POLICY_GET, rid + 7, "u:1"),
                tp.encode_allow_hashed(rid + 8,
                                       np.arange(3, dtype=np.uint64),
                                       [1, 0, 1])]
            rid += 8
        else:
            # An expired deadline: shed before dispatch (fail-closed).
            frames.append(tp.with_deadline(tp.encode_allow_n(rid, "u:2", 1),
                                           0.0))
    return frames


@pytest.mark.parametrize("kind,shards,slo", [
    ("window", 1, None), ("bucket", 1, None), ("window", 2, None),
    ("window", 1, 5.0), ("exact", 1, None)])
def test_native_door_replies_equal_jax_native_door(kind, shards, slo):
    """The pipelined launch/resolve path (sketch), the blocking lane
    under an SLO (``dispatch_timeout``) and the string lane of a backend
    without the hashed surface (exact), one frame at a time."""
    with _doors(kind, shards, dispatch_timeout=slo) as (
            (jdoor, jlim), (tdoor, tlim)):
        js = socket.create_connection(("127.0.0.1", jdoor.port))
        ts = socket.create_connection(("127.0.0.1", tdoor.port))
        try:
            for frame in _seeded_frames(7 + shards):
                js.sendall(frame)
                ts.sendall(frame)
                assert _recv(ts) == _recv(js), frame[:16]
                jlim.clock.advance(0.37)
                tlim.clock.advance(0.37)
            replies = []
            for frame in (tp.encode_simple(tp.T_HEALTH, 90),
                          tp.encode_simple(tp.T_METRICS, 91)):
                for sock in (js, ts):
                    sock.sendall(frame)
                    replies.append(_recv(sock))
            jh, th, jm, tm = replies
        finally:
            js.close()
            ts.close()
        jstats, tstats = jdoor.stats(), tdoor.stats()
    assert jstats["shard_decisions"] == tstats["shard_decisions"]
    assert tstats["pipelined"] == (slo is None and kind != "exact")
    if shards > 1:
        assert min(tstats["shard_decisions"]) > 0
    # HEALTH: the same status and decision count (uptimes differ).
    jst, _, jdec = jp.parse_health(jh[13:])
    tst, _, tdec = tp.parse_health(th[13:])
    assert (tst, tdec) == (jst, jdec) and tdec > 0
    # METRICS: the same families, and the shard-labelled envelope
    # gauges (and batch-size histogram counts) equal.
    jt, tt = jp.parse_metrics(jm[13:]), tp.parse_metrics(tm[13:])

    def lines(text, prefix):
        return sorted(line for line in text.splitlines()
                      if line.startswith(prefix))

    assert lines(tt, "# TYPE") == lines(jt, "# TYPE")
    for fam in ("rate_limiter_sketch_", "rate_limiter_server_batch_size_count",
                "rate_limiter_decisions_", "rate_limiter_requests_total"):
        assert lines(tt, fam) == lines(jt, fam), fam
    if kind == "window":
        for s in range(shards):
            assert f'rate_limiter_sketch_mass_budget{{shard="{s}"}}' in tt


def test_forward_hint_is_served_and_forwarding_works_natively():
    """Frames with the forward hint are served by the port's native door
    as by the JAX door (same replies, the connection lives on); and a
    fleet member on the native door forwards what it does not own: its
    string, raw-id and scalar frames, mixed across two owners, equal JAX
    limiters replaying each owner's rows (the peer a port asyncio
    server on one manual clock), and FLEET_MAP answers its map."""
    import asyncio

    from ratelimiter_tpu_torch.fleet import (
        FleetCore,
        FleetMap,
    )
    from ratelimiter_tpu_torch.serving.client import Client
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    with _doors("window") as ((jdoor, _), (tdoor, _t)):
        replies = []
        for door in (jdoor, tdoor):
            s = socket.create_connection(("127.0.0.1", door.port))
            try:
                got = []
                for frame in (tp.encode_allow_n(3, "k", 1),
                              tp.with_trace(tp.encode_allow_n(4, "k", 1), 9),
                              tp.encode_allow_hashed(
                                  5, np.arange(9, dtype=np.uint64),
                                  np.ones(9, dtype=np.int64))):
                    s.sendall(tp.with_forward(frame))
                    got.append(_recv(s))
                s.sendall(tp.encode_allow_n(6, "k", 1))
                got.append(_recv(s))
                replies.append(got)
            finally:
                s.close()
        assert [tp.parse_header(r[:13])[1] for r in replies[1]] == [
            tp.T_RESULT, tp.T_RESULT, tp.T_RESULT_HASHED, tp.T_RESULT]
        assert replies[0] == replies[1]

    clock = T.ManualClock(T0)
    cfg = _cfg(T, "window")
    jcfg = _cfg(R, "window", kernels="jnp")
    lim_a = T.create_limiter(cfg, backend="sketch", clock=clock,
                             device="cpu")
    lim_b = T.create_limiter(cfg, backend="sketch", clock=clock,
                             device="cpu")
    oracles = [R.create_limiter(jcfg, backend="sketch",
                                clock=R.ManualClock(T0)) for _ in range(2)]
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    peer = RateLimitServer(lim_b, "127.0.0.1", 0)
    asyncio.run_coroutine_threadsafe(peer.start(), loop).result(10)
    fmap = FleetMap.from_dict({"buckets": 32, "epoch": 1, "hosts": [
        {"id": "a", "host": "127.0.0.1", "port": 1, "ranges": [[0, 16]]},
        {"id": "b", "host": "127.0.0.1", "port": peer.port,
         "ranges": [[16, 32]]}]})
    core = FleetCore(fmap, "a", prefix=cfg.prefix, forward_deadline=30.0,
                     registry=Registry())
    door = NativeRateLimitServer(lim_a, "127.0.0.1", 0, registry=Registry(),
                                 fleet=core, inflight=4)
    door.start()
    rng = np.random.default_rng(12)
    try:
        with Client(port=door.port, timeout=30) as c:
            for i in range(8):
                if i % 3 == 0:
                    ids = rng.integers(0, 60, 40).astype(np.uint64)
                    got = c.allow_hashed(ids)
                    owners = core.owners_of_ids(ids)
                    sub = lambda o, pos: o.allow_ids(ids[pos])  # noqa
                    b = 40
                elif i % 3 == 1:
                    keys = [f"n:{k}" for k in rng.integers(0, 30, 20)]
                    got = c.allow_batch(keys)
                    owners = core.owners_of_hash(core.hash_keys(keys))
                    sub = lambda o, pos: o.allow_batch(  # noqa
                        [keys[k] for k in pos])
                    b = 20
                else:
                    key = f"n:{int(rng.integers(0, 30))}"
                    got = [c.allow(key)]
                    owners = core.owners_of_hash(core.hash_keys([key]))
                    sub = lambda o, pos: o.allow_batch([key])  # noqa
                    b = 1
                allowed = np.asarray([r.allowed for r in got]) if isinstance(
                    got, list) else got.allowed
                remaining = np.asarray([r.remaining for r in got]) if \
                    isinstance(got, list) else got.remaining
                want_a = np.zeros(b, dtype=bool)
                want_r = np.zeros(b, dtype=np.int64)
                for host in (0, 1):
                    pos = np.nonzero(owners == host)[0]
                    if pos.shape[0]:
                        out = sub(oracles[host], pos)
                        want_a[pos] = out.allowed
                        want_r[pos] = out.remaining
                np.testing.assert_array_equal(allowed, want_a)
                np.testing.assert_array_equal(remaining, want_r)
            assert FleetMap.from_dict(c.fleet_map()).to_dict() == \
                fmap.to_dict()
        assert core.status()["forwarded_total"] > 0
    finally:
        door.shutdown()
        asyncio.run_coroutine_threadsafe(peer.shutdown(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=10)
        loop.close()
        core.close()
        lim_b.close()
        for o in oracles:
            o.close()


def test_oversized_frame_closes_the_connection_on_both_doors():
    with _doors("window") as ((jdoor, _), (tdoor, _t)):
        for door in (jdoor, tdoor):
            s = socket.create_connection(("127.0.0.1", door.port))
            s.settimeout(10)
            try:
                s.sendall(struct.pack("<IBQ", tp.MAX_FRAME + 1,
                                      tp.T_ALLOW_N, 1) + b"\0" * 64)
                assert s.recv(64) == b""
            finally:
                s.close()


def test_shard_router_matches_the_jax_door():
    """``shard_of``/``shard_of_id`` (and ``fnv_shard``) give the JAX
    door's shard for every key and id."""
    with _doors("window", shards=2) as ((jdoor, _), (tdoor, _t)):
        for i in range(200):
            key = f"k:{i}-ü"
            assert tdoor.shard_of(key) == jdoor.shard_of(key) \
                == fnv_shard(key, 2)
            assert tdoor.shard_of_id(i * 7919) == jdoor.shard_of_id(i * 7919)


def test_side_doors_route_to_the_keys_shard():
    """decide_one, reset_one, decide_many and the override fan-out land
    on the key's FNV shard, as the JAX door's."""
    with _doors("window", shards=2) as ((jdoor, jlim), (tdoor, tlim)):
        keys = [f"s:{i}" for i in range(12)]
        for _ in range(3):
            for k in keys:
                jr, tr = jdoor.decide_one(k, 2), tdoor.decide_one(k, 2)
                assert (tr.allowed, tr.remaining, tr.reset_at) == (
                    jr.allowed, jr.remaining, jr.reset_at)
        tdoor.reset_one("s:3")
        jdoor.reset_one("s:3")
        many = [(k, 1) for k in keys]
        assert [(r.allowed, r.remaining) for r in tdoor.decide_many(many)] \
            == [(r.allowed, r.remaining) for r in jdoor.decide_many(many)]
        tdoor.set_override_all("s:5", 50)
        jdoor.set_override_all("s:5", 50)
        assert tdoor.get_override_one("s:5").limit == 50
        assert tdoor.delete_override_all("s:5")
        tdoor.update_limit(9)
        jdoor.update_limit(9)
        assert all(lim.config.limit == 9 for lim in tdoor.shard_limiters)
        for s, (jl, tl) in enumerate(zip(jdoor.shard_limiters,
                                         tdoor.shard_limiters)):
            from ratelimiter_tpu.observability.decorators import (
                undecorated as jund,
            )
            from ratelimiter_tpu_torch.observability.decorators import (
                undecorated,
            )

            ja = jund(jl).capture_state()[1]
            ta = undecorated(tl).capture_state()[1]
            for k in ("cur", "slabs", "totals"):
                np.testing.assert_array_equal(np.asarray(ta[k]),
                                              np.asarray(ja[k]), err_msg=k)


@pytest.mark.parametrize("transport,shards,max_batch,kind", [
    ("tcp", 1, None, "window"), ("uds", 1, None, "bucket"),
    ("shm", 2, 100, "window")])
def test_pipelined_frames_equal_replays_of_the_windows(transport, shards,
                                                       max_batch, kind):
    """chip_smoke.check_native_door at a small size on the CPU: 4
    connections pipelining 16 frames 8 deep; every frame's answer equal
    to CPU replays of each shard's recorded windows (with max_batch 100,
    hashed frames carved across two windows)."""
    cfg = _cfg(T, kind)
    out = chip_smoke.check_native_door(
        None, cfg, "small", device="cpu", seed=3, conns=4, frames=16,
        n_ids=64, n_keys=16, shards=shards, transport=transport,
        space="c2" if kind == "bucket" else "zipf",
        server_kw={"max_batch": max_batch} if max_batch else None)
    assert out["frames"] == 64 and out["windows"] > 1
    assert len(out["shard_decisions"]) == shards
    chip_smoke.check_no_children()


def test_wal_reset_replays_onto_the_owning_shard(tmp_path):
    """Two shards under the persistence manager with the door's router:
    a reset logged after the snapshot is replayed onto its key's FNV
    shard in both packages (the other shard untouched), and every
    shard's recovered state is the JAX package's."""
    from ratelimiter_tpu.persistence import PersistenceManager as JaxPM
    from ratelimiter_tpu_torch.persistence import PersistenceManager

    def run(M, PM, d, make):
        spec = M.PersistenceSpec(dir=str(d), snapshot_interval=3600.0)
        mgr = PM(spec)
        lims = [mgr.wrap(make()) for _ in range(2)]
        mgr.attach(lims, shard_of=lambda k: fnv_shard(k, 2))
        mgr.recover()
        keys = [f"w:{i}" for i in range(16)]
        for lim_i, k in ((fnv_shard(k, 2), k) for k in keys * 3):
            lims[lim_i].allow_n(k, 2)
        mgr.snapshot_now()
        victim = keys[5]
        lims[fnv_shard(victim, 2)].reset(victim)
        mgr.wal.close()
        mgr2 = PM(spec)
        fresh = [mgr2.wrap(make()) for _ in range(2)]
        mgr2.attach(fresh, shard_of=lambda k: fnv_shard(k, 2))
        report = mgr2.recover()
        mgr2.wal.close()
        return report, fresh, victim

    jreport, jl, victim = run(
        R, JaxPM, tmp_path / "j",
        lambda: R.create_limiter(_cfg(R, "window", kernels="jnp"),
                                 backend="sketch", clock=R.ManualClock(T0)))
    treport, tl, _ = run(
        T, PersistenceManager, tmp_path / "t",
        lambda: T.create_limiter(_cfg(T, "window"), backend="sketch",
                                 clock=T.ManualClock(T0), device="cpu"))
    assert treport.replayed == jreport.replayed == 1
    owner = fnv_shard(victim, 2)
    other = next(f"w:{i}" for i in range(16)
                 if fnv_shard(f"w:{i}", 2) != owner)
    for lims in (tl, jl):
        assert lims[owner].allow_n(victim, 7).allowed
        assert not lims[1 - owner].allow_n(other, 7).allowed
    for a, b in zip(jl, tl):
        ja, ta = a.capture_state()[1], b.capture_state()[1]
        for k in ("cur", "slabs", "totals"):
            np.testing.assert_array_equal(np.asarray(ta[k]),
                                          np.asarray(ja[k]), err_msg=k)
        a.close()
        b.close()


def test_start_and_shutdown_200_times_with_dispatchers_busy():
    """The JAX door's lost wake-up: a dispatcher's exit notified the
    responder without its mutex, and shutdown could join it forever.
    Each shutdown of the port's door, with frames still in flight on
    two shards, must end within 5 s (a watchdog thread, not a plugin)."""
    lim = T.create_limiter(_cfg(T, "window"), backend="sketch",
                           clock=T.ManualClock(T0), device="cpu")
    frames = b"".join(tp.encode_allow_hashed(i, np.arange(
        i, i + 32, dtype=np.uint64)) for i in range(1, 9))
    try:
        for cycle in range(200):
            door = NativeRateLimitServer(lim, "127.0.0.1", 0,
                                         registry=Registry(), shards=2,
                                         max_delay=50e-6, io_rings=1)
            door.start()
            s = socket.create_connection(("127.0.0.1", door.port))
            s.sendall(frames)
            if cycle % 2:
                s.recv(65536)  # some of the replies
            stopper = threading.Thread(target=door.shutdown, daemon=True)
            t = time.monotonic()
            stopper.start()
            stopper.join(timeout=5.0)
            s.close()
            assert not stopper.is_alive(), (
                f"shutdown {cycle} still running after "
                f"{time.monotonic() - t:.1f} s")
    finally:
        lim.close()


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'server.cpp:1: error: boom' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="boom"):
        native.build_server(str(tmp_path / "b"), cxx=str(fake))
    assert os.listdir(tmp_path / "b") == ["server.lock"]
    # The door raises too: no fallback to the asyncio door.
    monkeypatch.setattr(native, "_server", None)
    monkeypatch.setattr(native, "build_server", functools.partial(
        native.build_server, str(tmp_path / "b2"), cxx=str(fake)))
    lim = T.create_limiter(_cfg(T, "window"), clock=T.ManualClock(T0),
                           device="cpu")
    try:
        with pytest.raises(RuntimeError, match="boom"):
            NativeRateLimitServer(lim)
    finally:
        lim.close()


def test_library_of_another_abi_is_refused(tmp_path):
    src = tmp_path / "old.cpp"
    src.write_text('extern "C" long long rl_server_abi_version() '
                   '{ return 13; }\n')
    lib = tmp_path / "old.so"
    import subprocess

    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    with pytest.raises(RuntimeError, match="server ABI 13, expected 1"):
        native.load_server_library(str(lib))


def test_port_c_sources_include_nothing_of_the_jax_package():
    d = os.path.join(REPO, "ratelimiter_tpu_torch", "native")
    for name in ("server.cpp", "shm_ring.h", "loadgen.cpp",
                 "ratelimiter_client.hpp", "hasher.cpp"):
        with open(os.path.join(d, name)) as fh:
            includes = [line for line in fh if line.startswith("#include")]
        assert includes and not any("ratelimiter_tpu/" in line
                                    or ".." in line for line in includes)
    with open(os.path.join(d, "shm_ring.h")) as fh:
        port = fh.read()
    with open(os.path.join(REPO, "ratelimiter_tpu", "native",
                           "shm_ring.h")) as fh:
        jax = fh.read()
    # The layout (everything past the header comment up to the ring's
    # methods) is the JAX one.
    assert port[port.index("#pragma"):port.index("struct Ring {")] == \
        jax[jax.index("#pragma"):jax.index("struct Ring {")]
    # The ring's methods differ by the fences of C16 alone: the producer's
    # flag reads after a publish and the consumer's arming stores.
    assert "atomic_thread_fence" not in jax
    assert port.count(
        "std::atomic_thread_fence(std::memory_order_seq_cst);") == 4


# ------------------------------------------------------------ the binary


def test_binary_native_unix_shm_two_shards_recovers(tmp_path):
    """``python -m ratelimiter_tpu_torch.serving --native --device cpu
    --listen unix:... --shm --shards 2 --http-port 0 --snapshot-dir``
    serves over the unix socket and the lane, answers /healthz (the
    native door, its ABI, both shards' gauges on /metrics), and after a
    SIGKILL recovers its snapshot and WAL."""
    from ratelimiter_tpu_torch.serving.client import Client

    sock = str(tmp_path / "door.sock")
    argv = ["--native", "--device", "cpu", "--listen", f"unix:{sock}",
            "--shm", "--shm-dir", str(tmp_path), "--shards", "2",
            "--http-port", "0", "--snapshot-dir", str(tmp_path / "snap"),
            "--snapshot-interval", "3600", "--sketch-depth", "2",
            "--sketch-width", "1024", "--sub-windows", "6", "--limit", "3",
            "--algorithm", "sliding_window"]
    srv = chip_smoke.ServerProcess(argv, timeout=120)
    try:
        assert srv.port is None and srv.listen == f"unix:{sock}"
        with Client(f"unix:{sock}", transport="uds") as c:
            assert [c.allow("a").remaining for _ in range(3)] == [2, 1, 0]
            assert not c.allow("a").allowed
        with Client(f"unix:{sock}", transport="shm") as c:
            assert c.allow("b").remaining == 2
            assert c.allow_hashed(np.arange(4, dtype=np.uint64)).allowed.all()
        health = chip_smoke.http_call(srv.http, "GET", "/healthz")[2]
        assert (health["member"]["door"], health["member"]["abi"]) == (
            "native", "1")
        assert health["transport"]["connections"]["shm"] == 1
        assert health["transport"]["connections"]["uds"] == 2
        metrics = chip_smoke.http_call(srv.http, "GET", "/metrics")[2]
        for s in ("0", "1"):
            assert re.search(
                rf'rate_limiter_sketch_mass_budget{{shard="{s}"}} ', metrics)
        st, _, snap = chip_smoke.http_call(srv.http, "POST", "/v1/snapshot")
        assert st == 200
        srv.kill()
        srv = chip_smoke.ServerProcess(argv, timeout=120)
        assert "restored snapshot" in srv.recovered
        with Client(f"unix:{sock}", transport="uds") as c:
            assert not c.allow("a").allowed
            assert c.allow("b").remaining == 1
        assert srv.terminate() == 0
    finally:
        if srv.proc.poll() is None:
            srv.kill()


def test_binary_native_answers_equal_its_cpu_shards():
    """chip_smoke.check_native_binary on the CPU at a small geometry:
    binary-door and /v1/allow answers equal to CPU limiters of the two
    shards, the audit block, resets around a snapshot, a SIGKILL and the
    restart's WAL replay onto the reset key's shard."""
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=5,
                   window=60.0, sketch=T.SketchParams(depth=2, width=1024,
                                                      sub_windows=6))
    out = chip_smoke.check_native_binary(cfg, device="cpu")
    assert out["answers"] == 7 * 64 and out["audit_samples"] == 7 * 64
    chip_smoke.check_no_children()


def test_shards_without_native_are_refused():
    from ratelimiter_tpu_torch.serving.__main__ import build_config, parse_args

    with pytest.raises(SystemExit, match="--shards needs --native"):
        build_config(parse_args(["--shards", "2"]))
    build_config(parse_args(["--shards", "2", "--native"]))


def test_c15_default_algorithm_is_the_jax_binarys():
    """C15: with no --algorithm both binaries parse to configs with the
    same fingerprint and give the same /healthz member.algorithm
    (``tpu_sketch``)."""
    from ratelimiter_tpu.checkpoint import config_fingerprint as jfp
    from ratelimiter_tpu.serving import __main__ as jbin
    from ratelimiter_tpu_torch.checkpoint import config_fingerprint
    from ratelimiter_tpu_torch.serving import __main__ as tbin

    targs = tbin.parse_args([])
    jargs = jbin.build_parser().parse_args([])
    assert targs.algorithm == jargs.algorithm == "tpu_sketch"
    cfg = tbin.build_config(targs)
    jcfg = R.Config(algorithm=R.Algorithm(jargs.algorithm),
                    limit=jargs.limit, window=jargs.window,
                    sketch=R.SketchParams(depth=jargs.sketch_depth,
                                          width=jargs.sketch_width,
                                          sub_windows=jargs.sub_windows))
    assert config_fingerprint(cfg) == jfp(jcfg)
    assert cfg.algorithm.value == jcfg.algorithm.value
    tinfo, collect = tbin.make_member_info(targs, registry=Registry())
    jinfo = jbin._make_member_info(jargs, None)
    assert tinfo()["algorithm"] == jinfo()["algorithm"] == "tpu_sketch"
    # A snapshot taken under the port's old default refuses to restore.
    old = tbin.build_config(tbin.parse_args(["--algorithm",
                                             "sliding_window"]))
    assert config_fingerprint(old) != config_fingerprint(cfg)


def test_the_new_modules_import_nothing_of_jax():
    """serving/native_server.py, shm.py and client.py (and the door's
    extension, built and loaded) in a fresh interpreter leave no jax or
    ratelimiter_tpu module loaded (the pin of tests/test_torch_serving.py
    walks every module of the port; this one also loads the door)."""
    import subprocess

    code = r"""
import sys
import ratelimiter_tpu_torch.serving.native_server as ns
import ratelimiter_tpu_torch.serving.shm, ratelimiter_tpu_torch.serving.client
from ratelimiter_tpu_torch import native
native.load_server()
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "ratelimiter_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tenant_shards_enforce_their_share():
    """With the cascade, every dispatch shard (the base and its clones)
    enforces 1/N of the tenant and global limits, as the JAX binary's
    ``hier_divisor`` does; ``create_limiter`` takes it."""
    import dataclasses

    cfg = dataclasses.replace(_cfg(T, "window"), hierarchy=T.HierarchySpec(
        tenants=4, global_limit=100))
    lim = T.create_limiter(cfg, clock=T.ManualClock(T0), device="cpu",
                           hier_divisor=2)
    door = NativeRateLimitServer(lim, registry=Registry(), shards=2)
    try:
        assert [sl._hier_table.divisor for sl in door.shard_limiters] \
            == [2, 2]
    finally:
        door.shutdown()
        lim.close()
