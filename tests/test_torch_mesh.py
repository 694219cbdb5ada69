"""The sliced mesh (``--backend mesh``, ``SlicedMeshLimiter``) in the port,
on the CPU, against the JAX package's ``SlicedMeshLimiter``.

The port runs N slices on ``cpu``; the JAX package runs the same config
on N of its 8 virtual CPU devices (tests/conftest.py). Inputs are made
with NumPy from a seed and go through both packages; the tolerance is 0:
every result field and every slice's state array is bit-identical.
Covered (the intent of tests/test_mesh_serving.py): the string lane,
the raw-id lane, same-key sequencing across the split, scalar calls and
resets routed to the owner; launch/resolve against the synchronous
call; the single-owner passthrough and the fail-open OR; the write-all
control plane (overrides, ``update_limit``, ``update_window``), the
token bucket's refill, the factory and ``MeshSpec``; capture and
restore at the same slice count (across the packages too) and across
counts (re-bucketed, equal to the JAX restore); both doors over
``--device cpu --backend mesh --mesh-devices 4`` against a replay, a
kill -9 recovery of the durable binary on each door, and the binary's
flag refusals.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu_torch.parallel import CollectiveMeshLimiter
from ratelimiter_tpu_torch.parallel import SlicedMeshLimiter
from ratelimiter_tpu_torch.parallel.mesh import mesh_devices

T0 = 1_700_000_000.0
FIELDS = ("allowed", "remaining", "retry_after", "reset_at")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(M, *, algo="SLIDING_WINDOW", limit=5, window=6.0, devices=2,
         cu=True, hh=0, tenants=0, global_limit=None, fail_open=False,
         router="host", quarantine=False, persist=None):
    extra = {"kernels": "jnp"} if M is R else {}
    kw = {}
    if persist is not None:
        kw["persistence"] = M.PersistenceSpec(dir=str(persist),
                                              snapshot_interval=1000.0)
    return M.Config(
        algorithm=getattr(M.Algorithm, algo), limit=limit, window=window,
        fail_open=fail_open,
        policy=M.core.config.PolicySpec(capacity=64),
        sketch=M.SketchParams(depth=2, width=256, sub_windows=6,
                              conservative_update=cu, hh_slots=hh, **extra),
        hierarchy=M.core.config.HierarchySpec(
            tenants=tenants, **({} if global_limit is None
                                else {"global_limit": global_limit})),
        mesh=M.core.config.MeshSpec(devices=devices, router=router,
                                    quarantine=quarantine), **kw)


def _pair(**kw):
    j = R.create_limiter(_cfg(R, **kw), backend="mesh",
                         clock=R.ManualClock(T0))
    t = T.create_limiter(_cfg(T, **kw), backend="mesh",
                         clock=T.ManualClock(T0), device="cpu")
    return j, t


def _same(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.fail_open == b.fail_open
    if a.limits is None:
        assert b.limits is None
    else:
        np.testing.assert_array_equal(a.limits, b.limits)


def _same_slices(j, t):
    assert j.n_slices == t.n_slices
    for sj, st in zip(j.sub_limiters(), t.sub_limiters()):
        kj, aj, ej = sj.capture_state()
        kt, at, et = st.capture_state()
        assert kj == kt
        assert set(aj) == set(at)
        for k in aj:
            x, y = np.asarray(aj[k]), np.asarray(at[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert ej.get("host_period") == et.get("host_period")


def _close(*lims):
    for lim in lims:
        lim.close()


# ----------------------------------------------------------- routing


@pytest.mark.parametrize("algo,hh", [("SLIDING_WINDOW", 0),
                                     ("SLIDING_WINDOW", 16),
                                     ("TOKEN_BUCKET", 0)])
def test_string_lane_matches_jax(algo, hh):
    j, t = _pair(algo=algo, hh=hh, devices=3)
    rng = np.random.default_rng(1)
    try:
        for step in range(5):
            keys = [f"k{i}" for i in rng.integers(0, 40, 60)] + ["hot"] * 8
            ns = rng.integers(1, 3, len(keys)).tolist()
            _same(j.allow_batch(keys, ns), t.allow_batch(keys, ns))
            j.clock.advance(0.9)
            t.clock.advance(0.9)
        _same_slices(j, t)
        # The composite routes by h64 % n, as the JAX router does.
        h = t._hash([f"k{i}" for i in range(50)])
        np.testing.assert_array_equal(j.owner_of_hash(h),
                                      t.owner_of_hash(h))
    finally:
        _close(j, t)


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_raw_id_lane_matches_jax(algo):
    j, t = _pair(algo=algo, devices=2, cu=False)
    rng = np.random.default_rng(2)
    try:
        for _ in range(4):
            ids = rng.integers(0, 64, 96).astype(np.uint64)
            ns = rng.integers(1, 3, 96)
            _same(j.allow_ids(ids, ns), t.allow_ids(ids, ns))
            h = rng.integers(0, 1 << 63, 32).astype(np.uint64)
            _same(j.allow_hashed(h), t.allow_hashed(h))
            j.clock.advance(1.3)
            t.clock.advance(1.3)
        np.testing.assert_array_equal(j.owner_of_id(ids), t.owner_of_id(ids))
        _same_slices(j, t)
    finally:
        _close(j, t)


def test_same_key_sequencing_survives_the_split():
    """One key's requests interleaved with other slices' keys: exactly
    the limit admits, in frame order, as in the JAX package."""
    j, t = _pair(devices=4, limit=3)
    try:
        keys = []
        for i in range(12):
            keys += ["seq", f"other{i}"]
        rj, rt = j.allow_batch(keys), t.allow_batch(keys)
        _same(rj, rt)
        seq = rt.allowed[0::2]
        assert seq.tolist() == [True] * 3 + [False] * 9
    finally:
        _close(j, t)


def test_scalar_and_reset_route_to_owner():
    j, t = _pair(devices=3, limit=2)
    try:
        for _ in range(3):
            a, b = j.allow("solo"), t.allow("solo")
            assert (a.allowed, a.remaining, a.retry_after) == (
                b.allowed, b.remaining, b.retry_after)
        owner = t.owner_of_key("solo")
        assert owner == j.owner_of_key("solo")
        j.reset("solo")
        t.reset("solo")
        assert t.allow("solo").allowed and j.allow("solo").allowed
        _same_slices(j, t)
    finally:
        _close(j, t)


# ----------------------------------------------------------- pipeline


def test_launch_resolve_matches_sync_and_is_idempotent():
    _, a = _pair(devices=3)
    _, b = _pair(devices=3)
    rng = np.random.default_rng(3)
    try:
        tickets, syncs = [], []
        for i in range(4):
            ids = rng.integers(0, 50, 40).astype(np.uint64)
            tickets.append(a.launch_ids(ids, now=T0 + i))
            syncs.append(b.allow_ids(ids, now=T0 + i))
        for tk, s in zip(tickets, syncs):
            r = a.resolve(tk)
            _same(r, s)
            assert a.resolve(tk) is r
    finally:
        _close(a, b)


def test_single_owner_passthrough_keeps_the_wire_buffers():
    _, t = _pair(devices=4)
    try:
        ids = np.arange(1, 4096, dtype=np.uint64)
        mine = ids[t.owner_of_id(ids) == 2][:16]
        tk = t.launch_ids(mine, now=T0, wire=True)
        assert len(tk.subs) == 1 and tk.subs[0][1] is None
        res = t.resolve(tk)
        bits, words, padded = res.wire_packed
        assert padded == 16 and res.allowed.all()
        # A split frame rebuilds frame-order packed buffers.
        res2 = t.resolve(t.launch_ids(ids[:40], now=T0, wire=True))
        bits2, words2, b2 = res2.wire_packed
        assert b2 == 40
        np.testing.assert_array_equal(
            np.unpackbits(bits2, bitorder="little")[:40].astype(bool),
            res2.allowed)
        np.testing.assert_array_equal(words2[:40], res2.remaining)
    finally:
        t.close()


def test_fail_open_split_frame_ors_the_flag():
    j, t = _pair(devices=2, fail_open=True)
    try:
        ids = np.arange(1, 33, dtype=np.uint64)
        for m in (j, t):
            m.sub_limiters()[1].inject_failure()
        rj, rt = j.allow_ids(ids, now=T0), t.allow_ids(ids, now=T0)
        _same(rj, rt)
        assert rt.fail_open
        on1 = t.owner_of_id(ids) == 1
        assert rt.allowed[on1].all() and (rt.remaining[on1] == 0).all()
        for m in (j, t):
            m.heal()
        rj, rt = j.allow_ids(ids, now=T0), t.allow_ids(ids, now=T0)
        _same(rj, rt)
        assert not rt.fail_open
    finally:
        _close(j, t)


# ------------------------------------------------------ control plane


def test_control_plane_reaches_every_slice():
    j, t = _pair(devices=3)
    rng = np.random.default_rng(4)
    try:
        for m in (j, t):
            m.set_override("vip", 9)
            m.set_override("tiny", 1)
        assert t.get_override("vip").limit == j.get_override("vip").limit
        assert t.override_count() == j.override_count() == 2
        for s in t.sub_limiters():
            assert s.override_count() == 2
        keys = ["vip"] * 12 + ["tiny"] * 3 + [f"k{i}" for i in range(20)]
        _same(j.allow_batch(keys), t.allow_batch(keys))
        for m in (j, t):
            m.update_limit(7)
            m.update_window(12.0)
        for s in t.sub_limiters():
            assert (s.config.limit, s.config.window) == (7, 12.0)
        assert (t.config.limit, t.config.window) == (7, 12.0)
        ids = rng.integers(0, 60, 80).astype(np.uint64)
        _same(j.allow_ids(ids), t.allow_ids(ids))
        assert j.delete_override("tiny") and t.delete_override("tiny")
        _same(j.allow_batch(keys), t.allow_batch(keys))
        _same_slices(j, t)
    finally:
        _close(j, t)


def test_token_bucket_mesh_refill():
    j, t = _pair(algo="TOKEN_BUCKET", limit=4, window=4.0, devices=2)
    try:
        keys = ["a", "b", "c"] * 3
        for dt in (0.0, 0.5, 1.0, 3.0):
            for m in (j, t):
                m.clock.advance(dt)
            _same(j.allow_batch(keys), t.allow_batch(keys))
        _same_slices(j, t)
    finally:
        _close(j, t)


def test_cascade_per_slice_share_matches_jax():
    j, t = _pair(devices=2, tenants=4, global_limit=40, limit=50)
    try:
        for m in (j, t):
            m.set_tenant("gold", 20)
            m.assign_tenant("g1", "gold")
        keys = ["g1"] * 30 + [f"k{i}" for i in range(40)]
        for _ in range(2):
            _same(j.allow_batch(keys), t.allow_batch(keys))
        for s in t.sub_limiters():
            assert s._hier_table.divisor == 2
        assert (t.hierarchy_stats()["global"]["in_window"]
                == j.hierarchy_stats()["global"]["in_window"])
        _same_slices(j, t)
    finally:
        _close(j, t)


def test_factory_and_mesh_spec():
    cfg = _cfg(T, devices=3)
    lim = T.create_limiter(cfg, backend="mesh", device="cpu")
    assert type(lim) is SlicedMeshLimiter and lim.n_slices == 3
    assert [s.device.type for s in lim.slices] == ["cpu"] * 3
    lim.close()
    coll = T.create_limiter(_cfg(T, router="collective"), backend="mesh",
                            device="cpu")
    assert isinstance(coll, CollectiveMeshLimiter)
    coll.close()
    # Explicit device lists (repeats allowed) win over the count.
    lim = T.create_limiter(_cfg(T, devices=None), backend="mesh",
                           devices=["cpu"] * 4)
    assert lim.n_slices == 4
    lim.close()
    assert T.create_limiter(_cfg(T, devices=None), backend="mesh",
                            device="cpu").n_slices == 1
    # MeshSpec validation refuses what the JAX spec refuses, with its
    # words.
    for bad in (dict(devices=0), dict(slice_deadline=0),
                dict(probe_interval=-1), dict(failure_threshold=0),
                dict(router="p2p"), dict(bin_headroom=0),
                dict(router="collective", quarantine=True)):
        with pytest.raises(R.InvalidConfigError) as ej:
            R.core.config.MeshSpec(**bad).validate()
        with pytest.raises(T.InvalidConfigError) as et:
            T.MeshSpec(**bad).validate()
        assert str(ej.value) == str(et.value)
    # The fingerprint excludes the spec, as in the JAX package.
    from ratelimiter_tpu.checkpoint import config_fingerprint as jfp
    from ratelimiter_tpu_torch.checkpoint import config_fingerprint as tfp

    assert tfp(_cfg(T, devices=2)) == tfp(_cfg(T, devices=5))
    assert tfp(_cfg(T, devices=2)) == jfp(_cfg(R, devices=2))


def test_device_count_refusal_names_the_visible_count():
    with pytest.raises(T.InvalidConfigError,
                       match="mesh wants 2 devices but only 1 are visible"):
        mesh_devices(devices=["cpu"], n=2)
    with pytest.raises(R.InvalidConfigError,
                       match="mesh wants 16 devices but only 8 are visible"):
        R.create_limiter(_cfg(R, devices=16), backend="mesh")
    with pytest.raises(T.InvalidConfigError, match="at least 1 device"):
        mesh_devices("cpu", 0)


# ---------------------------------------------------------- checkpoints


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_capture_restore_same_count_across_packages(tmp_path, saver):
    j, t = _pair(devices=2, hh=16)
    rng = np.random.default_rng(5)
    try:
        for _ in range(3):
            keys = [f"k{i}" for i in rng.integers(0, 30, 40)] + ["hot"] * 6
            _same(j.allow_batch(keys), t.allow_batch(keys))
        for m in (j, t):
            m.set_override("vip", 3)
        path = str(tmp_path / "mesh.npz")
        (t if saver == "port" else j).save(path)
        j2, t2 = _pair(devices=2, hh=16)
        j2.restore(path)
        t2.restore(path)
        _same_slices(j, t2)
        _same_slices(j2, t2)
        keys = ["vip"] * 5 + [f"k{i}" for i in range(20)]
        _same(j2.allow_batch(keys), t2.allow_batch(keys))
        _close(j2, t2)
    finally:
        _close(j, t)


def test_restore_refuses_another_slice_count(tmp_path):
    """Across slice counts a restore re-buckets: 2 -> 3
    equals the JAX mesh's restore of the same file, and so does each
    ``restore_slice`` (the JAX package refuses that one); what is still
    refused is a slice out of range and a snapshot with no slice count."""
    j, t = _pair(devices=2)
    path = str(tmp_path / "two.npz")
    t.allow_batch(["a", "b"] * 4)
    t.save(path)
    j3, t3 = _pair(devices=3)
    try:
        j3.restore(path)
        t3.restore(path)
        _same_slices(j3, t3)
        _same(j3.allow_batch(["a", "b", "c"]), t3.allow_batch(["a", "b",
                                                                "c"]))
        t3.restore_slice(path, 0)
        with pytest.raises(T.CheckpointError, match="out of range"):
            t.restore_slice(path, 5)
        t.restore_slice(path, 1)
        plain = str(tmp_path / "plain.npz")
        t.slices[0].save(plain)
        with pytest.raises(T.CheckpointError):
            t3.restore(plain)
    finally:
        _close(j, t, j3, t3)


def test_restore_rebuckets_device_count_change(tmp_path):
    """tests/test_mesh_serving.py::test_restore_rebuckets_device_count_change
    in the port: a 4-slice snapshot restored on 2 slices carries the
    overrides and the counters, never admits what the source denies,
    and equals the JAX mesh's restore slice by slice."""
    j4, t4 = _pair(devices=4, limit=4)
    keys = [f"k{i}" for i in range(40)]
    try:
        _same(j4.allow_batch(keys), t4.allow_batch(keys))
        for m in (j4, t4):
            m.set_override("vip", 9)
        path = str(tmp_path / "mesh4.npz")
        t4.save(path)
        src = t4.allow_batch(keys)
    finally:
        _close(j4, t4)
    j2, t2 = _pair(devices=2, limit=4)
    try:
        j2.restore(path)
        t2.restore(path)
        _same_slices(j2, t2)
        assert t2.get_override("vip").limit == 9
        got = t2.allow_batch(keys)
        _same(j2.allow_batch(keys), got)
        assert not (got.allowed & ~src.allowed).any()
    finally:
        _close(j2, t2)


# ------------------------------------------------------------ the binary


def _start(args, *, timeout=60):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
         "--device", "cpu", "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    lines: list = []
    found = threading.Event()

    def read():
        # A reader thread, so that a binary which never prints its
        # banner fails the test after ``timeout`` instead of blocking
        # the worker on the pipe; it drains the pipe until the binary
        # exits, so the binary never blocks on a full pipe either.
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                found.set()
        found.set()

    proc.reader_lines = lines
    proc.reader = threading.Thread(target=read, daemon=True)
    proc.reader.start()
    if found.wait(timeout):
        line = next((x for x in lines if x.startswith("serving")), None)
        if line is not None:
            port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
            return proc, port, line
    proc.kill()
    proc.wait(timeout=30)
    proc.reader.join(timeout=30)
    raise AssertionError("binary did not start: " + "".join(lines[-20:]))


def _stop(proc, sig=signal.SIGTERM):
    proc.send_signal(sig)
    try:
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.reader.join(timeout=30)
        proc.stdout.close()


MESH_FLAGS = ["--backend", "mesh", "--mesh-devices", "4", "--algorithm",
              "fixed_window", "--limit", "5", "--window", "3600",
              "--sketch-width", "1024", "--sub-windows", "1"]


def _replay_limiter():
    cfg = T.Config(algorithm=T.Algorithm.FIXED_WINDOW, limit=5,
                   window=3600.0,
                   sketch=T.SketchParams(width=1024, sub_windows=1),
                   mesh=T.MeshSpec(devices=4))
    return SlicedMeshLimiter(cfg, device="cpu")


def _window_index() -> int:
    """The fixed hour-long window the wall clock is in (MESH_FLAGS)."""
    return int(time.time() // 3600)


def _mesh_round(c, rep, rng, native_slices: bool, base: int,
                prefix: str) -> list:
    """One round against the binary and the replay: a hashed frame of 64
    ids (offset by ``base``) and 12 scalar keys (named from ``prefix``),
    each answered by the binary, then by the replay. Returns every field
    as (name, binary's, replay's)."""
    from ratelimiter_tpu_torch.ops.hashing import splitmix64
    from ratelimiter_tpu_torch.serving.native_server import fnv_shard

    ids = rng.integers(0, 48, 64).astype(np.uint64) + np.uint64(base)
    got = c.allow_hashed(ids)
    if native_slices:
        sh = (splitmix64(ids) % np.uint64(4)).astype(np.int64)
        want_allowed = np.zeros(64, bool)
        want_rem = np.zeros(64, np.int64)
        for s in range(4):
            m = sh == s
            if m.any():
                r = rep.slices[s].allow_hashed(splitmix64(ids[m]))
                want_allowed[m], want_rem[m] = r.allowed, r.remaining
    else:
        r = rep.allow_ids(ids)
        want_allowed, want_rem = r.allowed, r.remaining
    fields = [("hashed allowed", got.allowed, want_allowed),
              ("hashed remaining", got.remaining, want_rem)]
    for k in [f"{prefix}{i}" for i in rng.integers(0, 20, 12)]:
        g = c.allow(k)
        w = (rep.slices[fnv_shard(k, 4)] if native_slices else rep).allow(k)
        fields.append((f"{k} (allowed, remaining, reset_at)",
                       (g.allowed, g.remaining, g.reset_at),
                       (w.allowed, w.remaining, w.reset_at)))
    return fields


@pytest.mark.parametrize("door", [[], ["--native"],
                                  ["--router", "collective"],
                                  ["--native", "--router", "collective"]])
def test_doors_serve_the_mesh_against_a_replay(door):
    """Both doors over ``--device cpu --backend mesh --mesh-devices 4``
    (and the collective router behind each), hashed, batch and scalar
    frames sent one at a time; every answer's allowed, remaining and
    reset equal a replay on a local sliced mesh (a fixed hour-long
    window: the decision time moves only the retry). The native door's
    host router mounts the slices as its shards, routed by its own
    shard router (FNV-1a / splitmix64), so its replay routes the same
    way.

    Both count on the wall clock, so a round during which a window
    starts (the hour read before it and after it differ) may count some
    requests in the old window on one side and the new one on the
    other: that round is redone on keys neither side has seen, and
    every later round stays on them, so that four rounds are held field
    by field, each within one window on both sides."""
    from ratelimiter_tpu_torch.serving import Client

    proc, port, line = _start(MESH_FLAGS + door)
    native_slices = door == ["--native"]
    assert ("shards=4" in line) == native_slices
    rep = _replay_limiter()
    c = Client(port=port)
    rng = np.random.default_rng(6)
    try:
        held, base, prefix = 0, 0, "user"
        while held < 4:
            window = _window_index()
            fields = _mesh_round(c, rep, rng, native_slices, base, prefix)
            if _window_index() != window:
                base += 1 << 20
                prefix = f"user-w{_window_index()}-"
                continue
            for name, got, want in fields:
                if isinstance(got, tuple):
                    assert got == want, name
                else:
                    np.testing.assert_array_equal(got, want, err_msg=name)
            held += 1
    finally:
        c.close()
        _stop(proc)
        rep.close()


def test_mesh_door_round_across_a_window_start_is_redone(monkeypatch):
    """The replay test's second reading of the window differs once (a
    window starting mid-round, as the wall clock gives it at the top of
    the hour): that round is redone on fresh keys, and four rounds are
    still held field by field."""
    readings = []

    def window_index():
        readings.append(None)
        return 0 if len(readings) < 2 else 1

    monkeypatch.setattr(sys.modules[__name__], "_window_index", window_index)
    test_doors_serve_the_mesh_against_a_replay([])
    # 5 rounds, each read before and after, plus the fresh keys' name.
    assert len(readings) == 11


@pytest.mark.parametrize("door", [[], ["--native"]])
def test_durable_mesh_binary_recovers_after_kill9(tmp_path, door):
    """The durable mesh binary (``--quarantine`` on) killed with SIGKILL
    after a snapshot (the SNAPSHOT frame on the asyncio door, POST
    /v1/snapshot on the native one) and a WAL-logged override: the
    restart restores every slice (one combined file on the asyncio door,
    a file per slice on the native door) and replays the override."""
    import urllib.request

    from ratelimiter_tpu_torch.serving import Client

    flags = MESH_FLAGS + ["--snapshot-dir", str(tmp_path), "--quarantine",
                          "--snapshot-interval", "1000", "--http-port", "0",
                          "--http-snapshot-token", "tok", "--http-policy"
                          ] + door
    proc, port, line = _start(flags)

    def post(http, path, **headers):
        req = urllib.request.Request(f"http://127.0.0.1:{http}{path}",
                                     method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200

    http = int(line.rsplit("http:", 1)[1].split()[0])
    c = Client(port=port)
    try:
        keys = [f"dur{i}" for i in range(12)]
        for _ in range(6):
            for k in keys:
                c.allow(k)
        post(http, "/v1/snapshot", Authorization="Bearer tok")
        files = sorted(os.listdir(tmp_path))
        assert sum(f.startswith("snap-") for f in files) == (
            4 if door else 1), files
        post(http, "/v1/policy?key=vip&limit=2")
        before = [c.allow(k).remaining for k in keys]
    finally:
        c.close()
        _stop(proc, signal.SIGKILL)
    proc, port, line = _start(flags)
    http = int(line.rsplit("http:", 1)[1].split()[0])
    c = Client(port=port)
    try:
        after = [c.allow(k) for k in keys]
        # Exhausted before the snapshot: still exhausted after recovery.
        assert before == [0] * 12
        assert not any(r.allowed for r in after)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http}/v1/policy?key=vip",
                timeout=30) as r:
            assert b'"limit": 2' in r.read()
        assert [c.allow("vip").allowed for _ in range(3)] == [True, True,
                                                              False]
    finally:
        c.close()
        _stop(proc)


@pytest.mark.parametrize("argv,msg", [
    (["--mesh-devices", "2"], "--mesh-devices needs --backend mesh"),
    (["--quarantine"], "--quarantine needs --backend mesh"),
    (["--router", "collective"], "--router needs --backend mesh"),
    (["--backend", "mesh", "--router", "collective", "--quarantine"],
     "incompatible with --quarantine"),
    (["--backend", "mesh", "--native", "--shards", "2"],
     "use --mesh-devices, not --shards"),
])
def test_binary_refuses_mesh_flag_misuse(argv, msg):
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_config,
        parse_args,
    )

    with pytest.raises(SystemExit) as e:
        build_config(parse_args(argv))
    assert msg in str(e.value)


def test_device_count_change_rebuckets_on_restart(tmp_path):
    """tests/test_mesh_serving.py::test_device_count_change_rebuckets_on_restart
    in the port: the durable binary at ``--mesh-devices 2`` spends a key,
    snapshots and is killed; restarted at 4 on the same directory it
    logs the re-bucketing and the key stays denied."""
    from ratelimiter_tpu_torch.serving import Client

    flags = ["--backend", "mesh", "--limit", "100", "--window", "600",
             "--sketch-width", "1024", "--sub-windows", "6",
             "--snapshot-dir", str(tmp_path / "snap"),
             "--snapshot-interval", "1000"]
    proc, port, _ = _start(flags + ["--mesh-devices", "2"])
    try:
        with Client(port=port, timeout=60.0) as c:
            assert c.allow_n("k", 100).allowed
            c.snapshot()
    finally:
        _stop(proc, signal.SIGKILL)
    proc, port, _ = _start(flags + ["--mesh-devices", "4"])
    try:
        with Client(port=port, timeout=60.0) as c:
            assert not c.allow_n("k", 1).allowed
            assert c.allow_n("other", 1).allowed
    finally:
        _stop(proc)
    assert any("re-bucketing" in ln for ln in proc.reader_lines)


def test_dcn_peer_gate_accepts_mesh_rejects_host_backends():
    """tests/test_mesh_serving.py::test_dcn_peer_gate_accepts_mesh_rejects_host_backends
    in the port: ``--dcn-peer`` with ``--backend exact`` is refused
    before any limiter is built; with ``--backend mesh`` the binary
    serves (its pushers, one a slice, fail quietly against a closed
    peer)."""
    out = subprocess.run(
        [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
         "--device", "cpu", "--backend", "exact", "--algorithm",
         "sliding_window", "--dcn-peer", "127.0.0.1:1", "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "sketch-family" in out.stderr
    proc, port, line = _start(
        ["--backend", "mesh", "--mesh-devices", "2", "--sketch-depth",
         "2", "--sketch-width", "1024", "--sub-windows", "6",
         "--dcn-peer", "127.0.0.1:1", "--dcn-interval", "0.2"])
    try:
        import time

        time.sleep(0.5)
        from ratelimiter_tpu_torch.serving import Client

        with Client(port=port, timeout=60.0) as c:
            assert c.allow("k").allowed
    finally:
        _stop(proc)
    assert proc.returncode == 0
