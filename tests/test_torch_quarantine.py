"""Per-slice failure domains (``MeshSpec.quarantine``,
parallel/quarantine.py) in the port, on the CPU.

The quarantine cases of tests/test_chaos.py, driven by the port's chaos
injector (``fail_slice`` raises ``SliceFault`` inside the slice's guard,
as the JAX package's does) and, for the deadline, by a slice whose
resolve stalls: the classifier against the JAX package's on the same faults;
backend faults quarantine one slice while caller errors pass through;
healthy rows equal a quarantine-off mesh (and the JAX package's) bit
for bit, the victim's range answers fail-open (or fails closed with the
slice named); the scalar path degrades too; a stalled slice answers
within one deadline; a probe restores the slice through
``recover_unit`` (the newest snapshot plus the WAL suffix) before it
rejoins, a failed probe reopens and a failed restore blocks the rejoin;
and the circuit breaker scopes an attributed failure storm to its
slice while unattributed failures still trip it globally.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.parallel.quarantine import (
    classify_failure as jax_classify,
)
from ratelimiter_tpu_torch import chaos
from ratelimiter_tpu_torch.observability.decorators import (
    CircuitBreakerDecorator,
)
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.parallel import SlicedMeshLimiter
from ratelimiter_tpu_torch.parallel.quarantine import classify_failure

T0 = 1_700_000_000.0


def _cfg(M=T, *, devices=4, quarantine=True, fail_open=True, deadline=5.0,
         probe=0.05, persist=None, limit=10):
    extra = {"kernels": "jnp"} if M is R else {}
    kw = {}
    if persist is not None:
        kw["persistence"] = M.PersistenceSpec(dir=str(persist),
                                              snapshot_interval=3600.0)
    return M.Config(
        algorithm=M.Algorithm.SLIDING_WINDOW, limit=limit, window=60.0,
        fail_open=fail_open,
        policy=M.core.config.PolicySpec(capacity=64),
        sketch=M.SketchParams(depth=2, width=1 << 10, sub_windows=6,
                              **extra),
        mesh=M.core.config.MeshSpec(devices=devices, quarantine=quarantine,
                                    slice_deadline=deadline,
                                    probe_interval=probe), **kw)


@pytest.fixture(autouse=True)
def _injector():
    chaos.install(seed=0)
    yield
    chaos.uninstall()


def _kill(idx):
    chaos.INJECTOR.fail_slice(idx)


def _heal(idx):
    chaos.INJECTOR.clear_slice(idx)


def _mesh(**kw):
    return SlicedMeshLimiter(_cfg(**kw), device="cpu")


def _warm(lim, ids):
    lim.allow_ids(ids, now=T0 - 1.0)


# ------------------------------------------------------------ classifier


@pytest.mark.parametrize("name,caller", [
    ("StorageUnavailableError", False), ("DeadlineExceededError", False),
    ("TimeoutError", False), ("OSError", False), ("RuntimeError", False),
    ("InvalidKeyError", True), ("InvalidNError", True),
    ("InvalidConfigError", True), ("ClosedError", True),
    ("CheckpointError", True), ("NotImplementedError", True),
    ("TypeError", True)])
def test_classifier_matches_jax(name, caller):
    def make(M):
        cls = getattr(M.core.errors, name, None) or getattr(
            __builtins__, name, None) or __import__("builtins").__dict__[name]
        return cls("x")

    assert classify_failure(make(T)) is (not caller)
    assert classify_failure(make(T)) == jax_classify(make(R))


# ------------------------------------------------------- kill a slice


def test_healthy_ranges_equal_a_quarantine_off_mesh():
    """The same id traffic through a quarantined mesh that loses slice 2
    mid-traffic, a quarantine-off mesh without the fault and the JAX
    package's: rows of healthy slices are bit-identical (frames decided
    mid-fault included); the victim's rows after the fault answer
    fail-open; the guards are decision-transparent before it."""
    lim = _mesh()
    oracle = _mesh(quarantine=False)
    jax_oracle = R.create_limiter(_cfg(R, quarantine=False), backend="mesh")
    victim = 2
    rng = np.random.default_rng(7)
    frames = [rng.integers(1, 1 << 40, size=256, dtype=np.uint64)
              for _ in range(6)]
    try:
        for m in (lim, oracle, jax_oracle):
            _warm(m, frames[0])
        got, want, jwant = [], [], []
        for i, ids in enumerate(frames):
            if i == 3:
                _kill(victim)
            now = T0 + i * 0.25
            got.append(lim.allow_ids(ids, now=now))
            want.append(oracle.allow_ids(ids, now=now))
            jwant.append(jax_oracle.allow_ids(ids, now=now))
        owners = lim.owner_of_id(np.concatenate(frames))
        healthy = owners != victim
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            g = np.concatenate([getattr(x, f) for x in got])
            w = np.concatenate([getattr(x, f) for x in want])
            jw = np.concatenate([getattr(x, f) for x in jwant])
            np.testing.assert_array_equal(w, jw, err_msg=f)
            np.testing.assert_array_equal(g[healthy], w[healthy],
                                          err_msg=f)
        post = np.concatenate([np.full(256, i >= 3) for i in range(6)])
        g_allowed = np.concatenate([x.allowed for x in got])
        assert g_allowed[(owners == victim) & post].all()
        assert any(g.fail_open for g in got[3:])
        assert not any(g.fail_open for g in got[:3])
        assert got[3].fail_open_slices == [victim]
        assert lim.quarantine.state(victim) != "healthy"
        assert lim.quarantine.quarantined() == [victim]
        # Healthy slices' state equals the oracle's.
        for i in range(4):
            if i == victim:
                continue
            a = lim.slices[i].capture_state()[1]
            b = oracle.slices[i].capture_state()[1]
            for k in ("cur", "totals", "slabs"):
                np.testing.assert_array_equal(a[k], b[k])
        status = lim.quarantine.status()
        assert status["degraded"] and status["quarantined"] == [victim]
    finally:
        lim.close()
        oracle.close()
        jax_oracle.close()


def test_fail_closed_range_errors_with_slice_attribution():
    lim = _mesh(fail_open=False)
    ids = np.arange(1, 257, dtype=np.uint64)
    _warm(lim, ids)
    _kill(1)
    try:
        with pytest.raises(T.StorageUnavailableError) as ei:
            lim.allow_ids(ids, now=T0)
        assert getattr(ei.value, "slice_index", None) == 1
        assert lim.quarantine.state(1) == "quarantined"
        # A frame the victim does not own still decides exactly.
        owners = lim.owner_of_id(ids)
        res = lim.allow_ids(np.ascontiguousarray(ids[owners != 1]),
                            now=T0 + 0.1)
        assert not res.fail_open
    finally:
        lim.close()


def test_caller_errors_pass_through_without_quarantine():
    lim = _mesh()
    try:
        with pytest.raises(T.InvalidKeyError):
            lim.allow_n("", 1)
        with pytest.raises(T.InvalidNError):
            lim.allow_batch(["a"], [0])
        assert lim.quarantine.quarantined() == []
    finally:
        lim.close()


def test_scalar_path_degrades_too():
    lim = _mesh()
    key = next(f"k{i}" for i in range(200)
               if lim.owner_of_key(f"k{i}") == 2)
    try:
        lim.allow_n(key, 1, now=T0)
        _kill(2)
        res = lim.allow_n(key, 1, now=T0 + 0.1)
        assert res.allowed and res.fail_open
        assert res.limit == lim.config.limit
        assert res.fail_open_slices == [2]
    finally:
        lim.close()


def test_stalled_slice_answers_within_one_deadline():
    """A slice whose resolve stalls past the deadline: the frame answers
    within one budget, the slice quarantines, later frames skip it, and
    a probe after the stall ends brings it back."""
    deadline = 0.3
    lim = _mesh(deadline=deadline, probe=30.0)
    ids = np.arange(1, 513, dtype=np.uint64)
    _warm(lim, ids)
    victim = int(lim.owner_of_id(ids[:1])[0])
    inner = lim.slices[victim].inner
    real = inner.resolve
    stall = {"on": True}

    def slow(ticket):
        if stall["on"]:
            time.sleep(4 * deadline)
        return real(ticket)

    inner.resolve = slow
    try:
        t0 = time.perf_counter()
        out = lim.allow_ids(ids, now=T0)
        assert time.perf_counter() - t0 < deadline * 2 + 1.0
        assert out.fail_open
        assert lim.quarantine.state(victim) != "healthy"
        t1 = time.perf_counter()
        assert lim.allow_ids(ids, now=T0 + 0.1).fail_open
        assert time.perf_counter() - t1 < deadline
        stall["on"] = False
        time.sleep(4 * deadline)   # the orphaned resolve drains
        assert lim.quarantine.probe_now(victim)
        assert not lim.allow_ids(ids, now=T0 + 1.0).fail_open
    finally:
        lim.close()


# ------------------------------------- probe recovery + snapshot restore


def test_probe_restores_through_recover_unit(tmp_path):
    """Restore-before-rejoin: the victim slice, faulted after a snapshot
    and a WAL-logged override, rejoins with the snapshot's slabs plus
    every override the WAL holds (the composite's restore_slice under
    recover_unit), while the other slices keep their live state."""
    from ratelimiter_tpu_torch.persistence import PersistenceManager

    cfg = _cfg(persist=tmp_path)
    lim = SlicedMeshLimiter(cfg, device="cpu")
    mgr = PersistenceManager(cfg.persistence, registry=Registry())
    top = mgr.wrap(lim)
    mgr.attach([top])
    lim.quarantine.restore_fn = mgr.slice_restorer()
    victim = 3
    vkey = next(f"u{i}" for i in range(300)
                if lim.owner_of_key(f"u{i}") == victim)
    try:
        top.set_override(vkey, 77)
        for i in range(8):
            top.allow_n(vkey, 1, now=T0 + i * 0.01)
        mgr.snapshot_now()
        snap = {k: v.copy() for k, v in
                lim.slices[victim].capture_state()[1].items()}
        top.set_override(f"{vkey}:wal", 55)
        _kill(victim)
        out = top.allow_n(vkey, 1, now=T0 + 1.0)
        assert out.fail_open
        assert lim.quarantine.state(victim) != "healthy"
        top.set_override(f"{vkey}:during", 33)
        _heal(victim)
        assert lim.quarantine.probe_now(victim)
        assert lim.quarantine.state(victim) == "healthy"
        # The probe's unit decision was overwritten by the restore.
        now_state = lim.slices[victim].capture_state()[1]
        for k in ("cur", "totals", "slabs", "slab_period"):
            np.testing.assert_array_equal(now_state[k], snap[k], err_msg=k)
        assert lim.get_override(vkey).limit == 77
        assert lim.get_override(f"{vkey}:wal").limit == 55
        assert lim.get_override(f"{vkey}:during").limit == 33
        res = top.allow_n(vkey, 1, now=T0 + 2.0)
        assert res.allowed and not res.fail_open
        assert res.remaining <= 77 - 9
    finally:
        mgr.stop(final_snapshot=False)
        top.close()


def test_probe_failure_reopens_and_restore_failure_blocks_rejoin():
    lim = _mesh(deadline=1.0, probe=0.01)
    ids = np.arange(1, 65, dtype=np.uint64)
    _warm(lim, ids)
    victim = int(lim.owner_of_id(ids[:1])[0])
    _kill(victim)
    try:
        lim.allow_ids(ids, now=T0)
        assert not lim.quarantine.probe_now(victim)
        assert lim.quarantine.state(victim) == "quarantined"
        _heal(victim)
        calls = []

        def bad_restore(idx):
            calls.append(idx)
            raise RuntimeError("restore target unavailable")

        lim.quarantine.restore_fn = bad_restore
        assert not lim.quarantine.probe_now(victim)
        assert calls == [victim]
        assert lim.quarantine.state(victim) == "quarantined"
        lim.quarantine.restore_fn = None
        assert lim.quarantine.probe_now(victim)
        assert lim.quarantine.transitions >= 4
    finally:
        lim.close()


# --------------------------------------------------- breaker scoping


def test_single_slice_fault_storm_leaves_other_ranges_admitting():
    lim = _mesh()
    breaker = CircuitBreakerDecorator(lim, failure_threshold=3,
                                      cooldown=60.0, registry=Registry())
    ids = np.arange(1, 513, dtype=np.uint64)
    _warm(lim, ids)
    victim = 2
    _kill(victim)
    try:
        for i in range(10):
            assert breaker.allow_ids(ids, now=T0 + i * 0.01).fail_open
        assert breaker.state == "closed"
        assert breaker.sub_state(victim, now=T0 + 1.0) == "open"
        owners = lim.owner_of_id(ids)
        healthy = np.ascontiguousarray(ids[owners != victim])
        assert not breaker.allow_ids(healthy, now=T0 + 2.0).fail_open
    finally:
        lim.close()


def test_unattributed_failures_still_trip_globally():
    lim = _mesh(quarantine=False)
    breaker = CircuitBreakerDecorator(lim, failure_threshold=2,
                                      cooldown=60.0, registry=Registry())
    try:
        for s in lim.slices:
            s.inject_failure(T.StorageUnavailableError("backend down"))
        out1 = breaker.allow_batch(["a", "b"], now=T0)
        out2 = breaker.allow_batch(["c", "d"], now=T0 + 0.01)
        assert out1.fail_open and out2.fail_open
        assert breaker.state == "open"
    finally:
        lim.close()


def test_quarantine_off_holds_no_guard():
    lim = _mesh(quarantine=False)
    try:
        assert lim.quarantine is None
        assert all(type(s).__name__ == "SketchLimiter" for s in lim.slices)
        assert all(s.device == torch.device("cpu") for s in lim.slices)
    finally:
        lim.close()
