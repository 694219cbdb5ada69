"""Checkpoints, the write-ahead log and crash recovery in the port (on
the CPU) against the JAX package.

Mirrors tests/test_checkpoint.py, tests/test_wal.py and
tests/test_persistence.py, and holds the two packages to each other with
tolerance 0:

* ``config_fingerprint`` equals the JAX digest for every config the port
  serves, and the JAX golden value;
* a snapshot saved by either package restores in the other, and the
  decisions that follow are bit-identical;
* the same mutations give byte-identical WAL segments, and either package
  replays the other's;
* one persistence directory, written by a seeded run and then
  "killed" (WAL closed, no final snapshot), recovers to bit-identical
  state and overrides in both packages, whichever package wrote it.

The JAX side runs its ``jnp`` reference path, on ManualClocks.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu import checkpoint as jck
from ratelimiter_tpu.persistence import PersistenceManager as JaxManager
from ratelimiter_tpu.persistence import wal as jwal
from ratelimiter_tpu_torch import checkpoint as tck
from ratelimiter_tpu_torch.persistence import PersistenceManager, read_manifest
from ratelimiter_tpu_torch.persistence import wal as twal

T0 = 1_700_000_000.0
GOLDEN = "9ce0bf0e02550dc074f2925212dccb29"   # tests/test_checkpoint.py
WINDOW_KEYS = ("cur", "slabs", "totals", "slab_period", "last_period")
BUCKET_KEYS = ("debt", "acc", "rem", "last")
POLICY_KEYS = ("policy_keys", "policy_limits", "policy_scales")
FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


def _cfg(M, *, algo="SLIDING_WINDOW", limit=10, window=6.0, cu=True,
         capacity=1024, persist=None, **sketch):
    extra = {"kernels": "jnp"} if M is R else {}
    geo = dict(depth=2, width=128, sub_windows=6)
    geo.update(sketch)
    kw = {}
    if persist is not None:
        kw["persistence"] = M.PersistenceSpec(dir=str(persist),
                                              snapshot_interval=1000.0)
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window, policy=M.core.config.PolicySpec(
                        capacity=capacity),
                    sketch=M.SketchParams(conservative_update=cu, **geo,
                                          **extra), **kw)


def _lim(M, clock=None, **kw):
    clock = clock if clock is not None else M.ManualClock(T0)
    if M is R:
        return R.create_limiter(_cfg(R, **kw), backend="sketch",
                                clock=clock)
    return T.create_limiter(_cfg(T, **kw), clock=clock, device="cpu")


def _same(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_state(lj, lt):
    kj, aj, ej = lj.capture_state()
    kt, at, et = lt.capture_state()
    assert kj == kt
    keys = BUCKET_KEYS if kj == "bucket" or "debt" in at else WINDOW_KEYS
    for k in keys + POLICY_KEYS:
        x, y = np.asarray(aj[k]), np.asarray(at[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert ej.get("host_period") == et.get("host_period")
    assert (lj.config.limit, lj.config.window) == (lt.config.limit,
                                                   lt.config.window)


def _traffic(rng, lims, steps=4, clocks=()):
    """The same seeded hashed and string traffic through every limiter;
    their answers must agree."""
    for _ in range(steps):
        ids = rng.integers(0, 30, 24).astype(np.uint64)
        keys = [f"k{i}" for i in rng.integers(0, 6, 8)] + ["vip"]
        outs = [(lim.allow_ids(ids), lim.allow_batch(keys)) for lim in lims]
        for o in outs[1:]:
            _same(outs[0][0], o[0])
            _same(outs[0][1], o[1])
        for c in clocks:
            c.advance(0.7)


# ----------------------------------------------------------- fingerprint

FP_CASES = {
    "sliding_cu": dict(),
    "sliding_vanilla": dict(cu=False),
    "fixed": dict(algo="FIXED_WINDOW"),
    "tpu_sketch": dict(algo="TPU_SKETCH", limit=7, window=12.5),
    "token_bucket": dict(algo="TOKEN_BUCKET", limit=20, window=10.0),
    "override_capacity": dict(capacity=64),
    "strict": dict(overload_policy="strict", depth=4, width=65536,
                   sub_windows=60),
}


@pytest.mark.parametrize("case", sorted(FP_CASES))
def test_fingerprint_matches_jax(case):
    kw = FP_CASES[case]
    cj, ct = _cfg(R, **kw), _cfg(T, **kw)
    assert tck.config_fingerprint(ct) == jck.config_fingerprint(cj)
    assert (tck.config_fingerprint(ct.with_defaults())
            == jck.config_fingerprint(cj.with_defaults()))


def test_fingerprint_golden_value():
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=100,
                   window=60.0)
    assert tck.config_fingerprint(cfg) == GOLDEN


def test_fingerprint_excludes_persistence_and_kernels(tmp_path):
    base = _cfg(T)
    assert (tck.config_fingerprint(_cfg(T, persist=tmp_path))
            == tck.config_fingerprint(base))
    assert (tck.config_fingerprint(_cfg(T, kernels="pallas"))
            == tck.config_fingerprint(base))
    assert (tck.config_fingerprint(_cfg(T, limit=11))
            != tck.config_fingerprint(base))


# ------------------------------------------------- snapshots across packages

@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_snapshot_crosses_packages(tmp_path, algo, saver):
    """A snapshot saved mid-trace by one package restores in the other
    (overrides included); both then decide the rest of the trace
    bit-identically, and the restored state equals the saver's."""
    rng = np.random.default_rng(len(algo))
    cj, ct = R.ManualClock(T0), T.ManualClock(T0)
    lj, lt = _lim(R, cj, algo=algo), _lim(T, ct, algo=algo)
    for lim in (lj, lt):
        lim.set_override("vip", 3)
    _traffic(rng, [lj, lt], clocks=(cj, ct))
    path = str(tmp_path / "snap.npz")
    src, Dst = (lj, T) if saver == "jax" else (lt, R)
    src.save(path)
    fresh = _lim(Dst, Dst.ManualClock(T0), algo=algo)
    fresh.restore(path)
    a, b = (lj, fresh) if saver == "jax" else (fresh, lt)
    _same_state(a, b)
    fresh.clock.advance(cj.now() - T0)
    _traffic(rng, [a, b], clocks=(a.clock, b.clock))
    _same_state(a, b)
    for lim in (lj, lt, fresh):
        lim.close()


def test_saved_files_hold_the_same_arrays(tmp_path):
    """The same state saved by each package: equal arrays, equal meta."""
    lj, lt = _lim(R), _lim(T)
    _traffic(np.random.default_rng(3), [lj, lt])
    lj.save(str(tmp_path / "j.npz"))
    lt.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    lj.close()
    lt.close()


def test_restore_matches_uncrashed_control(tmp_path):
    """Crash equivalence: restore + the same future equals never having
    crashed."""
    rng = np.random.default_rng(5)
    control = _lim(T)
    _traffic(rng, [control])
    path = str(tmp_path / "s.npz")
    control.save(path)
    restored = _lim(T)
    restored.restore(path)
    _traffic(np.random.default_rng(6), [control, restored])
    _same_state(control, restored)
    control.close()
    restored.close()


def test_restore_refuses_other_config_kind_and_files(tmp_path):
    lim = _lim(T)
    lim.allow_n("a", 4)
    path = str(tmp_path / "s.npz")
    lim.save(path)
    with pytest.raises(T.CheckpointError, match="fingerprint"):
        _lim(T, limit=11).restore(path)
    with pytest.raises(T.CheckpointError, match="kind"):
        tck.load_state(path, "dense", lim.config)
    bad = tmp_path / "bad.npz"
    np.savez(bad, x=np.zeros(3))
    with pytest.raises(T.CheckpointError, match="not a ratelimiter_tpu"):
        lim.restore(str(bad))
    # A dynamic limit moves the fingerprint with it.
    lim.update_limit(12)
    lim.save(path)
    with pytest.raises(T.CheckpointError):
        _lim(T).restore(path)
    _lim(T, limit=12).restore(path)
    lim.close()


def test_bucket_checkpoint_without_acc_restores(tmp_path):
    lim = _lim(T, algo="TOKEN_BUCKET")
    lim.allow_n("a", 8)
    kind, arrays, extra = lim.capture_state()
    del arrays["acc"]
    path = str(tmp_path / "old.npz")
    tck.save_state(path, kind, lim.config, arrays, extra)
    fresh = _lim(T, algo="TOKEN_BUCKET")
    fresh.restore(path)
    assert not fresh.allow_n("a", 3).allowed
    assert int(fresh._state["acc"].abs().sum()) == 0
    lim.close()
    fresh.close()


@pytest.mark.parametrize("fail", ["fsync", "replace"])
def test_failed_save_keeps_old_snapshot(tmp_path, monkeypatch, fail):
    lim = _lim(T)
    lim.allow_n("a", 7)
    path = str(tmp_path / "snap.npz")
    lim.save(path)
    golden = open(path, "rb").read()
    lim.allow_n("a", 1)

    def boom(*_a):
        raise OSError("injected failure")

    monkeypatch.setattr(f"ratelimiter_tpu_torch.checkpoint.os.{fail}", boom)
    with pytest.raises(OSError):
        lim.save(path)
    monkeypatch.undo()
    assert open(path, "rb").read() == golden
    assert [p for p in tmp_path.iterdir() if ".tmp." in p.name] == []
    lim.close()


# ------------------------------------------------------------------- WAL

MUTATIONS = [
    (1, {"key": "vip", "limit": 7, "window_scale": 1.0}),
    (3, {"key": "k"}),
    (4, {"limit": 20}),
    (5, {"window": 4.5}),
    (2, {"key": "vip"}),
    (1, {"key": "ünï", "limit": 3, "window_scale": 1.0}),
] * 3


@pytest.mark.parametrize("max_bytes", [4096, 64 << 20])
def test_wal_bytes_identical(tmp_path, max_bytes):
    """The same appends give byte-identical segment files, rotation
    included, and each package replays the other's log."""
    dirs = {}
    for name, mod in (("j", jwal), ("t", twal)):
        d = tmp_path / name
        w = mod.WriteAheadLog(str(d), max_bytes=max_bytes, fsync="never")
        pad = "x" * 700                     # forces rotation at 4 KiB
        for rtype, payload in MUTATIONS:
            w.append(rtype, dict(payload, pad=pad))
        w.close()
        dirs[name] = d
    segs = sorted(p.name for p in dirs["j"].iterdir() if p.suffix == ".log")
    assert segs == sorted(p.name for p in dirs["t"].iterdir()
                          if p.suffix == ".log")
    assert len(segs) == (1 if max_bytes > 4096 else len(segs))
    for s in segs:
        assert (dirs["j"] / s).read_bytes() == (dirs["t"] / s).read_bytes()
    for reader, writer in ((twal, "j"), (jwal, "t")):
        got = [(r.seq, r.type, r.payload)
               for r in reader.replay(str(dirs[writer]))]
        assert [(t, p["key"] if "key" in p else None) for _, t, p in got] \
            == [(t, p.get("key")) for t, p in MUTATIONS]
        assert [s for s, _, _ in got] == list(range(1, len(MUTATIONS) + 1))


def test_wal_round_trip_reopen_and_filter(tmp_path):
    w = twal.WriteAheadLog(str(tmp_path))
    for i in range(5):
        assert w.append(twal.REC_RESET, {"key": f"k{i}"}) == i + 1
    w.close()
    w = twal.WriteAheadLog(str(tmp_path))
    assert w.last_seq == 5
    assert w.append(twal.REC_RESET, {"key": "k5"}) == 6
    w.close()
    assert [r.seq for r in twal.replay(str(tmp_path), after_seq=3)] == [
        4, 5, 6]
    assert list(twal.replay(str(tmp_path / "missing"))) == []


def test_wal_torn_tail_every_offset(tmp_path):
    """Truncating the log at ANY byte replays exactly the intact prefix,
    in both packages."""
    src = tmp_path / "src"
    w = twal.WriteAheadLog(str(src), fsync="never")
    ends = []
    for i in range(4):
        w.append(twal.REC_POLICY_SET,
                 {"key": f"k{i}", "limit": i + 1, "window_scale": 1.0})
        ends.append(w._size)
    w.close()
    seg = next(p for p in src.iterdir() if p.suffix == ".log")
    data = seg.read_bytes()
    for cut in range(len(data) + 1):
        d = tmp_path / f"c{cut}"
        d.mkdir()
        (d / seg.name).write_bytes(data[:cut])
        want = sum(1 for e in ends if e <= cut)
        for mod in (twal, jwal):
            assert len(list(mod.replay(str(d)))) == want, (cut, mod)
        shutil.rmtree(d)


def test_wal_flipped_byte_and_reopen_truncates(tmp_path):
    w = twal.WriteAheadLog(str(tmp_path), fsync="never")
    for i in range(3):
        w.append(twal.REC_RESET, {"key": f"k{i}"})
    w.close()
    seg = next(p for p in tmp_path.iterdir() if p.suffix == ".log")
    data = bytearray(seg.read_bytes())
    data[-3] ^= 0xFF                       # corrupt the last record
    seg.write_bytes(bytes(data))
    assert [r.seq for r in twal.replay(str(tmp_path))] == [1, 2]
    w = twal.WriteAheadLog(str(tmp_path))  # truncates the torn tail
    assert w.last_seq == 2
    assert w.append(twal.REC_RESET, {"key": "again"}) == 3
    w.close()
    assert [r.payload["key"] for r in jwal.replay(str(tmp_path))] == [
        "k0", "k1", "again"]


def test_wal_gap_prune_and_single_writer(tmp_path):
    w = twal.WriteAheadLog(str(tmp_path), max_bytes=4096, fsync="never")
    for i in range(80):
        w.append(twal.REC_RESET, {"key": f"k{i}", "pad": "y" * 300})
    with pytest.raises(T.CheckpointError, match="another process"):
        twal.WriteAheadLog(str(tmp_path))
    segs = twal.segment_files(str(tmp_path))
    assert len(segs) > 4
    assert w.prune(segs[2][0] - 1) == 2    # wholly-below segments go
    w.close()
    segs = twal.segment_files(str(tmp_path))
    os.unlink(segs[1][1])                  # a missing middle segment
    got = [r.seq for r in twal.replay(str(tmp_path))]
    assert got == [r.seq for r in jwal.replay(str(tmp_path))]
    assert got[-1] == segs[1][0] - 1       # replay stops before the gap
    with pytest.raises(T.CheckpointError, match="gap"):
        twal.WriteAheadLog(str(tmp_path))


# -------------------------------------------------------------- recovery

def _boot(M, d, clock, **kw):
    """(manager, wrapped limiter) recovered from directory d."""
    cfg = _cfg(M, persist=d, **kw)
    mgr = (JaxManager if M is R else PersistenceManager)(
        cfg.persistence, registry=M.observability.metrics.Registry())
    if M is R:
        inner = R.create_limiter(cfg, backend="sketch", clock=clock)
    else:
        inner = T.create_limiter(cfg, clock=clock, device="cpu")
    lim = mgr.wrap(inner)
    mgr.attach([lim])
    try:
        mgr.recover()
    except Exception:
        mgr.wal.close()                    # release the directory lock
        raise
    return mgr, lim


def _crash_run(M, d, rng, algo):
    """A seeded run: traffic, overrides, a reset, a snapshot, then
    mutations the WAL alone carries (a reset, override changes, a limit
    and a window update) and traffic the crash loses; then the crash."""
    clock = M.ManualClock(T0)
    mgr, lim = _boot(M, d, clock, algo=algo)
    for step in range(3):
        lim.allow_ids(rng.integers(0, 30, 24).astype(np.uint64))
        lim.allow_batch(["vip", "k1", "k2", "k1"])
        clock.advance(0.9)
    lim.set_override("vip", 3)
    lim.reset("k1")
    mgr.snapshot_now()
    lim.allow_batch(["k2"] * 5)            # lost with the crash
    clock.advance(1.3)
    lim.reset("k2")
    lim.set_override("vip2", 9)
    lim.delete_override("vip")
    lim.update_limit(14)
    lim.update_window(4.5)
    mgr.wal.close()                        # kill -9: no final snapshot
    lim.close()


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_one_directory_recovers_identically(tmp_path, algo):
    """The same seeded run written by each package leaves the same
    WAL bytes and snapshot arrays; then each directory recovers in both
    packages to bit-identical state, overrides and later decisions."""
    dirs = {}
    for name, M in (("j", R), ("t", T)):
        dirs[name] = tmp_path / name
        _crash_run(M, dirs[name], np.random.default_rng(11), algo)
    wal_j = sorted(p for p in dirs["j"].iterdir() if p.suffix == ".log")
    wal_t = sorted(p for p in dirs["t"].iterdir() if p.suffix == ".log")
    assert [p.read_bytes() for p in wal_j] == [p.read_bytes() for p in wal_t]
    mj, mt = read_manifest(str(dirs["j"])), read_manifest(str(dirs["t"]))
    strip = [{k: v for k, v in e.items() if k != "created_at"}
             for e in mj["snapshots"]]
    assert strip == [{k: v for k, v in e.items() if k != "created_at"}
                     for e in mt["snapshots"]]
    later = T0 + 3 * 0.9 + 1.3 + 2.0
    for name in ("j", "t"):
        lims = []
        for M in (R, T):
            copy = tmp_path / f"{name}-{M.__name__}"
            shutil.copytree(dirs[name], copy)
            mgr, lim = _boot(M, copy, M.ManualClock(later), algo=algo)
            assert mgr.report.snapshot_id == 1
            assert mgr.report.replayed == 5 and not mgr.report.apply_errors
            lims.append((mgr, lim))
        (_, lj), (_, lt) = lims
        assert lt.config.limit == 14 and lt.config.window == 4.5
        assert lt.get_override("vip") is None
        assert lt.get_override("vip2").limit == 9
        _same_state(lj, lt)
        _traffic(np.random.default_rng(12), [lj, lt])
        _same_state(lj, lt)
        for mgr, lim in lims:
            mgr.stop(final_snapshot=False)
            lim.close()


def test_graceful_stop_and_replay_not_relogged(tmp_path):
    clock = T.ManualClock(T0)
    mgr, lim = _boot(T, tmp_path, clock)
    assert lim.allow_n("a", 9).allowed
    lim.set_override("vip", 5)
    assert lim.delete_override("ghost") is False   # a no-op is not logged
    lim.allow_batch(["x", "y"])                    # decisions are not
    assert mgr.wal.last_seq == 1
    mgr.stop()                                     # final snapshot
    lim.close()
    mgr2, lim2 = _boot(T, tmp_path, T.ManualClock(T0))
    assert mgr2.report.snapshot_id == 1 and mgr2.report.replayed == 0
    assert not lim2.allow_n("a", 2).allowed        # 9 consumed survived
    assert lim2.get_override("vip").limit == 5
    assert mgr2.wal.last_seq == 1
    mgr2.stop(final_snapshot=False)
    lim2.close()


def test_snapshotter_interval_mutations_retention_and_metrics(tmp_path):
    reg = T.observability.metrics.Registry()
    spec = T.PersistenceSpec(dir=str(tmp_path), snapshot_interval=0.05,
                             snapshot_after_mutations=2, retain=2,
                             wal_max_bytes=4096)
    mgr = PersistenceManager(spec, registry=reg)
    lim = mgr.wrap(T.create_limiter(_cfg(T), device="cpu"))
    mgr.attach([lim])
    mgr.recover()
    mgr.start()
    for i in range(30):
        lim.set_override(f"k{i}", 3 + i % 4)
    deadline = time.monotonic() + 10.0
    while mgr.snapshotter.last_entry is None or mgr.snapshotter.last_entry[
            "wal_seq"] < 30:
        assert time.monotonic() < deadline, "no snapshot caught up"
        time.sleep(spec.snapshot_interval)
    mgr.stop(final_snapshot=False)
    manifest = read_manifest(str(tmp_path))
    assert len(manifest["snapshots"]) == 2
    names = {p.name for p in tmp_path.iterdir() if p.suffix == ".npz"}
    assert names == {f for e in manifest["snapshots"] for f in e["files"]}
    first = min(s for s, _ in twal.segment_files(str(tmp_path)))
    assert first <= min(e["wal_seq"] for e in manifest["snapshots"]) + 1
    text = reg.render()
    for name in ("rate_limiter_snapshots_total",
                 "rate_limiter_snapshot_capture_seconds",
                 "rate_limiter_wal_records_total 30",
                 "rate_limiter_wal_seq 30",
                 "rate_limiter_snapshot_duration_seconds_bucket"):
        assert name in text, name
    status = mgr.status()
    assert status["wal_seq"] == 30 and status["last_snapshot_id"] >= 1
    lim.close()


def test_recovery_refuses_drift_and_damage(tmp_path):
    mgr, lim = _boot(T, tmp_path, T.ManualClock(T0))
    lim.allow_n("a", 3)
    mgr.snapshot_now()
    mgr.stop(final_snapshot=False)
    lim.close()
    with pytest.raises(T.CheckpointError, match="boot with the flags"):
        _boot(T, tmp_path, T.ManualClock(T0), limit=11)
    manifest = read_manifest(str(tmp_path))
    with open(tmp_path / manifest["snapshots"][0]["files"][0], "wb") as f:
        f.write(b"not an npz")
    mgr, lim = _boot(T, tmp_path, T.ManualClock(T0))   # corrupt: fresh
    assert mgr.report.snapshot_id is None
    mgr.stop(final_snapshot=False)
    lim.close()
    (tmp_path / "manifest.json").write_text("{")
    with pytest.raises(T.CheckpointError, match="manifest"):
        _boot(T, tmp_path, T.ManualClock(T0))


def test_persistent_wrapper_keeps_the_raw_id_lane(tmp_path):
    """Behind the persistence wrapper the micro-batcher still sends raw
    ids down the raw-id lane, and decisions match the bare limiter."""
    from ratelimiter_tpu_torch.serving.batcher import MicroBatcher

    mgr, lim = _boot(T, tmp_path, T.ManualClock(T0))
    bare = _lim(T)
    assert MicroBatcher(lim)._hashed_lane
    ids = np.arange(40, dtype=np.uint64) % 7
    _same(lim.allow_ids(ids), bare.allow_ids(ids))
    _same(lim.resolve(lim.launch_ids(ids, wire=False)),
          bare.resolve(bare.launch_ids(ids)))
    for name in ("inject_failure", "heal", "restore", "restore_state",
                 "capture_state", "launch_hashed", "allow_hashed"):
        assert name in type(lim).__dict__ or name in type(
            lim).__mro__[1].__dict__, name
    mgr.stop(final_snapshot=False)
    lim.close()
    bare.close()
