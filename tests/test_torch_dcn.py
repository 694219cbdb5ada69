"""The DCN tier (``parallel/dcn.py``) in the port, on the CPU, against
the JAX package's.

Every pod is a pair: a JAX ``kernels="jnp"`` limiter and a port limiter
on ``device="cpu"``, on two ManualClocks moved together. The same seeded
traffic goes into both; every decision, every export (periods, slab
values, the current period, and the slab frame's bytes for a fixed
sender and sequence), every merge's return, and after each exchange the
whole state (``slabs``, ``slab_period``, ``totals``, ``cur``, the side
table, ``debt``, ``acc``, ``last``) are held equal, tolerance 0. Covered:
the counterparts of tests/test_dcn.py's ``TestExportMerge``,
``TestBucketExchange`` and ``TestMirrorGroup``; seeded multi-pod
exchanges on windowed CU with the side table, vanilla windowed and the
TB-c2 bucket; the int32 wrap of the ``totals`` rebuild; the export's
int64 promotion after a foreign merge.
"""

from __future__ import annotations

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.parallel import dcn as JD
from ratelimiter_tpu.serving import protocol as JP
from ratelimiter_tpu_torch.parallel import dcn as TD
from ratelimiter_tpu_torch.serving import protocol as TP

T0 = 1_700_000_000.0
FIELDS = ("allowed", "remaining", "retry_after", "reset_at")
EVER = -(1 << 62)
SENDER, SEQ = 0x1234_5678_9ABC_DEF0, 1_700_000_000_000_123


def _cfg(M, *, algo="TPU_SKETCH", limit=10, window=6.0, depth=4,
         width=4096, sub=6, cu=True, hh=0, frac=0.2):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window,
                    sketch=M.SketchParams(depth=depth, width=width,
                                          sub_windows=sub,
                                          conservative_update=cu,
                                          hh_slots=hh,
                                          hh_promote_fraction=frac,
                                          **extra))


class Pod:
    """One pod in both packages; every call is made on both and held
    equal."""

    def __init__(self, start=T0, **kw):
        self.j = R.create_limiter(_cfg(R, **kw), backend="sketch",
                                  clock=R.ManualClock(start))
        self.t = T.create_limiter(_cfg(T, **kw), backend="sketch",
                                  clock=T.ManualClock(start), device="cpu")

    def allow(self, key, n=1):
        a, b = self.j.allow_n(key, n), self.t.allow_n(key, n)
        for f in FIELDS + ("fail_open",):
            assert getattr(a, f) == getattr(b, f), f
        return b

    def batch(self, keys, ns=None):
        a = self.j.allow_batch(keys, ns)
        b = self.t.allow_batch(keys, ns)
        for f in FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        return b

    def reset(self, key):
        self.j.reset(key)
        self.t.reset(key)

    def advance(self, dt):
        self.j.clock.advance(dt)
        self.t.clock.advance(dt)

    def same_state(self):
        _, a, ea = self.j.capture_state()
        _, b, eb = self.t.capture_state()
        assert set(a) == set(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert ea.get("host_period") == eb.get("host_period")

    def close(self):
        self.j.close()
        self.t.close()


def export(pod, after=EVER):
    """Both packages' ``export_completed``, held equal (values, and the
    slab frame's bytes); returns the port's export."""
    jp, js, jl = JD.export_completed(pod.j, after)
    tp, ts, tl = TD.export_completed(pod.t, after)
    assert jl == tl
    np.testing.assert_array_equal(jp, tp)
    assert tp.dtype == np.int64 and ts.dtype == np.int32
    np.testing.assert_array_equal(js, ts)
    sub = R.ops.sketch_kernels.sketch_geometry(pod.j.config)[1]
    for kw in ({}, {"secret": "s", "sender": SENDER, "seq": SEQ}):
        assert (JP.encode_dcn_slabs(7, jp, js, sub, **kw)
                == TP.encode_dcn_slabs(7, tp, ts, sub, **kw))
    return tp, ts, tl


def merge(pod, periods, slabs):
    a = JD.merge_completed(pod.j, periods, slabs)
    b = TD.merge_completed(pod.t, periods, slabs)
    assert a == b
    pod.same_state()
    return b


def export_debt(pod):
    a, b = JD.export_debt(pod.j), TD.export_debt(pod.t)
    assert b.dtype == np.int64 and b.shape == a.shape
    np.testing.assert_array_equal(a, b)
    assert (JP.encode_dcn_debt(3, a, "s", sender=SENDER, seq=SEQ)
            == TP.encode_dcn_debt(3, b, "s", sender=SENDER, seq=SEQ))
    return b


def merge_debt(pod, delta):
    a, b = JD.merge_debt(pod.j, delta), TD.merge_debt(pod.t, delta)
    assert a == b
    pod.same_state()
    return b


def close(*pods):
    for p in pods:
        p.close()


# ------------------------------------------------------ TestExportMerge


def test_export_only_completed_periods():
    p = Pod()
    p.allow("k", 3)
    periods, _, _ = export(p)
    assert periods.shape[0] == 0
    p.advance(1.0)
    p.allow("k")
    periods, slabs, _ = export(p)
    assert periods.shape[0] == 1 and slabs[0].sum() >= 3 * 4
    close(p)


def test_merge_makes_foreign_traffic_visible():
    a, b = Pod(), Pod()
    assert a.allow("k", 10).allowed
    a.advance(1.0)
    b.advance(1.0)
    a.allow("warm")
    b.allow("warm")
    assert b.allow("k", 10).allowed
    periods, slabs, _ = export(a)
    assert merge(b, periods, slabs)[0] == 1
    assert not b.allow("k").allowed
    close(a, b)


def test_incomplete_foreign_periods_dropped():
    a, b = Pod(), Pod()
    a.allow("k", 5)
    a.advance(1.0)
    a.allow("warm")
    periods, slabs, _ = export(a)
    assert merge(b, periods, slabs)[0] == 0
    close(a, b)


def test_token_bucket_rejected():
    p = Pod(algo="TOKEN_BUCKET", window=10.0)
    with pytest.raises(R.InvalidConfigError):
        JD.export_completed(p.j, 0)
    with pytest.raises(T.InvalidConfigError):
        TD.export_completed(p.t, 0)
    with pytest.raises(T.InvalidConfigError):
        TD.merge_completed(p.t, np.zeros(1, np.int64),
                           np.zeros((1, 4, 4096), np.int32))
    close(p)


def _hh_pod():
    return Pod(depth=3, width=256, hh=16)


def test_hh_traffic_exported_as_cms_mass():
    a, b = _hh_pod(), _hh_pod()
    for _ in range(3):
        assert a.allow("hot").allowed
    assert int((a.t._state["hh_owner"] != 0).sum()) >= 1
    for _ in range(6):
        a.allow("hot")
    a.advance(1.0)
    b.advance(1.0)
    a.allow("warm")
    b.allow("warm")
    periods, slabs, _ = export(a)
    assert merge(b, periods, slabs)[0] >= 1
    assert b.allow("hot").allowed
    assert not b.allow("hot", 2).allowed
    close(a, b)


def test_hh_export_does_not_double_count():
    a, b = _hh_pod(), _hh_pod()
    for _ in range(4):
        assert a.allow("hot").allowed
    a.advance(1.0)
    b.advance(1.0)
    a.allow("warm")
    b.allow("warm")
    groups = (JD.DcnMirrorGroup([a.j, b.j]), TD.DcnMirrorGroup([a.t, b.t]))
    for _ in range(2):
        assert groups[0].sync() == groups[1].sync()
        a.same_state()
        b.same_state()
    assert a.allow("hot", 6).allowed
    assert not a.allow("hot").allowed
    close(a, b)


def test_negative_foreign_cells_clamped():
    a, b = Pod(), Pod()
    b.allow("k", 10)
    a.advance(1.0)
    b.advance(1.0)
    a.allow("warm")
    b.allow("warm")
    periods, slabs, _ = export(a)
    evil = -np.abs(slabs) - 1_000_000
    merge(b, periods, evil)
    assert not b.allow("k").allowed
    close(a, b)


def test_owner_without_owner2_stays_local():
    """A side-table slot restored without ``hh_owner2`` (a snapshot from
    before it) is skipped by the fold in both packages."""
    a = _hh_pod()
    for _ in range(5):
        a.allow("hot")
    _, arrays, extra = a.j.capture_state()
    arrays = dict(arrays)
    arrays.pop("hh_owner2")
    a.j._restore_loaded(dict(arrays), dict(extra))
    a.t.restore_state(arrays, extra)
    a.same_state()
    a.advance(1.0)
    a.allow("warm")
    _, slabs, _ = export(a)
    # The requests counted before the promotion ship; the side table's
    # share (no second hash half to fold with) stays local.
    assert 0 < slabs.sum() < 5 * 3
    close(a)


def test_export_after_a_foreign_merge_subtracts_it():
    """The JAX export promotes a slab holding foreign mass to int64
    (``np.maximum(slab - f, 0)``); the frame bytes stay equal."""
    a, b = _hh_pod(), _hh_pod()
    for p in (a, b):
        p.batch([f"k{i}" for i in range(12)] + ["hot"] * 4)
        p.advance(1.0)
        p.allow("warm")
    periods, slabs, last = export(a)
    merge(b, periods, slabs)
    b.batch(["k1", "k2", "hot"])
    periods, slabs, _ = export(b)
    jp, js, _ = JD.export_completed(b.j, EVER)
    assert js.dtype == np.int64          # the JAX export's promotion
    assert slabs.sum() == js.sum()
    close(a, b)


# --------------------------------------------------- TestBucketExchange


def _bucket(**kw):
    return Pod(algo="TOKEN_BUCKET", window=10.0, **kw)


def test_export_carries_local_increments_once():
    a = _bucket()
    a.allow("k", 4)
    assert export_debt(a).sum() == 4 * 1_000_000 * 4
    assert export_debt(a).sum() == 0
    close(a)


def test_merge_makes_foreign_debt_visible():
    a, b = _bucket(), _bucket()
    assert a.allow("k", 10).allowed
    assert merge_debt(b, export_debt(a)) > 0
    res = b.allow("k")
    assert not res.allowed and res.retry_after > 0
    close(a, b)


def test_merged_debt_drains_at_refill_rate():
    a, b = _bucket(), _bucket()
    a.allow("k", 10)
    merge_debt(b, export_debt(a))
    assert not b.allow("k").allowed
    b.advance(2.1)
    assert b.allow("k", 2).allowed
    assert not b.allow("k").allowed
    close(a, b)


def test_error_direction_never_over_admits_globally_after_sync():
    pods = [_bucket() for _ in range(3)]
    total = sum(int(p.batch(["hot"] * 12).allowed.sum()) for p in pods)
    assert 10 <= total <= 30
    deltas = [export_debt(p) for p in pods]
    for i, p in enumerate(pods):
        for j, d in enumerate(deltas):
            if i != j:
                merge_debt(p, d)
    for p in pods:
        assert not p.allow("hot").allowed
    close(*pods)


def test_negative_debt_delta_clamped():
    a = _bucket()
    a.allow("k", 10)
    evil = np.full((4, 4096), -(1 << 60), dtype=np.int64)
    assert merge_debt(a, evil) == 0
    assert not a.allow("k").allowed
    with pytest.raises(T.InvalidConfigError, match="shape"):
        TD.merge_debt(a.t, np.zeros((3, 4096), np.int64))
    close(a)


def test_reset_not_exported():
    a = _bucket()
    a.allow("k", 10)
    a.reset("k")
    assert a.allow("k").allowed
    delta = export_debt(a)
    assert (delta >= 0).all() and delta.sum() >= 10 * 1_000_000 * 4
    close(a)


def test_restore_debt_reships_and_clamps_at_the_cap():
    a = _bucket()
    a.allow("k", 3)
    delta = export_debt(a)
    for lim, mod in ((a.j, JD), (a.t, TD)):
        mod.restore_debt(lim, delta)
        mod.restore_debt(lim, np.full_like(delta, 1 << 61))
    a.same_state()
    assert int(a.t._state["acc"].max()) == 1 << 61
    np.testing.assert_array_equal(export_debt(a), np.full_like(delta,
                                                                1 << 61))
    close(a)


def test_merge_debt_moves_last_to_the_receivers_now():
    a, b = _bucket(), _bucket(start=T0 + 500.0)
    a.allow("k", 10)
    merge_debt(b, export_debt(a))
    assert int(b.t._state["last"]) == int((T0 + 500.0) * 1e6)
    b.advance(0.5)
    assert not b.allow("k").allowed
    close(a, b)


def test_mirror_group_bucket_mode():
    a, b = _bucket(), _bucket()
    groups = (JD.DcnMirrorGroup([a.j, b.j]), TD.DcnMirrorGroup([a.t, b.t]))
    a.allow("k", 6)
    b.allow("k", 4)
    n = [g.sync() for g in groups]
    assert n[0] == n[1] > 0
    a.same_state()
    b.same_state()
    assert not a.allow("k").allowed
    assert not b.allow("k").allowed
    assert [g.sync() for g in groups] == [0, 0]
    close(a, b)


def test_mixed_family_rejected():
    a, w = _bucket(), Pod()
    with pytest.raises(T.InvalidConfigError):
        TD.DcnMirrorGroup([a.t, w.t])
    with pytest.raises(T.InvalidConfigError):
        TD.export_debt(w.t)
    with pytest.raises(T.InvalidConfigError):
        TD.DcnMirrorGroup([])
    close(a, w)


# ------------------------------------------------------ TestMirrorGroup


def test_cross_pod_convergence_and_envelope():
    pods = [Pod() for _ in range(3)]
    groups = (JD.DcnMirrorGroup([p.j for p in pods]),
              TD.DcnMirrorGroup([p.t for p in pods]))
    total = sum(int(p.batch(["hot"] * 12).allowed.sum()) for p in pods)
    assert 10 <= total <= 30
    for p in pods:
        p.advance(1.0)
        p.allow("warm")
    assert groups[0].sync() == groups[1].sync()
    for p in pods:
        p.same_state()
        assert not p.allow("hot").allowed
    for p in pods:
        p.advance(15.0)
        assert p.allow("hot").allowed
    close(*pods)


def test_no_double_counting_across_cycles():
    a, b = Pod(), Pod()
    groups = (JD.DcnMirrorGroup([a.j, b.j]), TD.DcnMirrorGroup([a.t, b.t]))
    a.allow("k", 4)
    a.advance(1.0)
    b.advance(1.0)
    a.allow("warm")
    b.allow("warm")
    assert [g.sync() for g in groups] == [1, 1]
    assert [g.sync() for g in groups] == [0, 0]
    assert b.allow("k", 6).allowed
    assert not b.allow("k").allowed
    close(a, b)


def test_mixed_geometry_rejected():
    a, b = Pod(limit=10), Pod(limit=11)
    with pytest.raises(T.InvalidConfigError):
        TD.DcnMirrorGroup([a.t, b.t])
    close(a, b)


def test_sync_during_stale_ring_replaces_expired_slots():
    a, b = Pod(), Pod()
    groups = (JD.DcnMirrorGroup([a.j, b.j]), TD.DcnMirrorGroup([a.t, b.t]))
    for p in (a, b):
        p.advance(100.0)
    a.allow("k", 10)
    b.allow("other")
    for p in (a, b):
        p.advance(1.0)
        p.allow("warm")
    assert groups[0].sync() == groups[1].sync()
    assert not b.allow("k").allowed
    close(a, b)


# ------------------------------------------------- seeded exchanges


CELLS = {
    "cu+hh": dict(depth=4, width=1024, hh=16, frac=0.2),
    "vanilla": dict(depth=4, width=1024, cu=False),
    "tb-c2": dict(algo="TOKEN_BUCKET", limit=20, window=10.0, depth=4,
                  width=1024),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_seeded_pods_sync_equal_to_jax(cell):
    """Three pods, seeded Zipf-ish string traffic on a rotating pod,
    sub-window steps of 0.4-1.3 s, a sync every other step: every
    decision, every sync's count and every pod's state equal."""
    kw = CELLS[cell]
    pods = [Pod(**kw) for _ in range(3)]
    groups = (JD.DcnMirrorGroup([p.j for p in pods]),
              TD.DcnMirrorGroup([p.t for p in pods]))
    rng = np.random.default_rng(18)
    applied = 0
    for step in range(14):
        keys = [f"u:{int(k)}" for k in
                np.minimum(rng.zipf(1.3, 40), 60)] + ["hot"] * 6
        pods[step % 3].batch(keys, rng.integers(1, 3, len(keys)).tolist())
        dt = float(rng.uniform(0.4, 1.3))
        for p in pods:
            p.advance(dt)
        if step % 2:
            n = [g.sync() for g in groups]
            assert n[0] == n[1]
            applied += n[1]
            for p in pods:
                p.same_state()
    assert applied > 0
    for p in pods:
        p.batch([f"u:{i}" for i in range(1, 30)] + ["hot"] * 4)
    close(*pods)


def test_totals_rebuild_wraps_like_the_jax_int32_tensordot():
    """Slabs near 2^31 in every in-window period: the rebuilt totals wrap
    modulo 2^32 in both packages (the port's int32 masked sum against the
    JAX int32 ``tensordot``)."""
    a, b = Pod(depth=2, width=64), Pod(depth=2, width=64)
    for p in (a, b):
        p.allow("k")
        p.advance(1.0)
        p.allow("k")
    _, arrays, extra = b.j.capture_state()
    arrays = dict(arrays)
    arrays["slabs"] = np.full_like(arrays["slabs"], 0x6000_0000 + 12345)
    last = int(arrays["last_period"])
    # Every slot holds a period of the live ring: five of them in the
    # window ([last - 5, last - 1]), one on its boundary.
    arrays["slab_period"] = np.array(
        [last - 1 - ((last - 1 - s) % 6) for s in range(6)], np.int64)
    b.j._restore_loaded(dict(arrays), dict(extra))
    b.t.restore_state(arrays, extra)
    periods, slabs, _ = export(a)
    assert merge(b, periods, slabs)[0] == 1
    # 5 x (0x60000000 + 12345) is past 2^32 + 2^31: the int32 sum wraps
    # to a negative total in both packages (merge() held them equal).
    assert (b.t._state["totals"].numpy() < 0).all()
    close(a, b)
