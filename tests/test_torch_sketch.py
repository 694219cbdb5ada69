"""The port's SketchLimiter (on the CPU) against the JAX package's.

Both limiters get the same Config, the same ManualClock trace and the same
operands, made with NumPy from a seed; every decision field and, at the
end, every state slab must be BIT-identical. The JAX side runs as its own
parity suite runs it (tests/test_pallas_parity.py): with the Pallas
kernels in interpret mode and with the jnp reference path. Also: state
carried across packages in both directions mid-trace, and the configs
this slice does not port are refused.
"""

from __future__ import annotations

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.algorithms.sketch import SketchLimiter as JaxSketch
from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter

T0 = 1_000_000.0
STATE_KEYS = ("cur", "slabs", "totals", "slab_period", "last_period")


def _cfg(M, *, algo="SLIDING_WINDOW", cu=True, kernels="auto", limit=7,
         **sketch):
    return M.Config(
        algorithm=getattr(M.Algorithm, algo), limit=limit, window=6.0,
        sketch=M.SketchParams(depth=3, width=128, sub_windows=6,
                              conservative_update=cu, kernels=kernels,
                              **sketch))


def _pair(kernels="jnp", **kw):
    return (JaxSketch(_cfg(R, kernels=kernels, **kw), R.ManualClock(T0)),
            SketchLimiter(_cfg(T, **kw), T.ManualClock(T0), device="cpu"))


def _same(a, b):
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    if a.limits is None:
        assert b.limits is None
    else:
        np.testing.assert_array_equal(a.limits, b.limits)


def _same_state(lj, lt):
    sj, st = lj.capture_state()[1], lt.capture_state()[1]
    for k in STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(sj[k]), st[k], err_msg=k)


def _drive(lj, lt, rng, steps, *, advance=0.75, reset_at=None):
    """Mixed traffic: raw ids, pre-hashed u64s and string keys (two of them
    overridden), one reset, the clock crossing sub-window boundaries."""
    for step in range(steps):
        kind = step % 3
        if kind == 0:
            ids = rng.integers(1, 24, size=48).astype(np.uint64)
            ns = rng.integers(1, 3, size=48)
            _same(lj.allow_ids(ids, ns), lt.allow_ids(ids, ns))
        elif kind == 1:
            h = rng.integers(0, 2 ** 63, size=40).astype(np.uint64) % 29
            h = h * np.uint64(0x9E3779B97F4A7C15)
            _same(lj.allow_hashed(h), lt.allow_hashed(h))
        else:
            keys = [f"k{int(i)}" for i in rng.integers(0, 12, size=30)]
            keys += ["whale"] * 8 + ["guppy"] * 3
            ns = rng.integers(1, 4, size=len(keys)).tolist()
            _same(lj.allow_batch(keys, ns), lt.allow_batch(keys, ns))
        if step == reset_at:
            for lim in (lj, lt):
                lim.reset("whale")
                lim.reset("k3")
        lj.clock.advance(advance)
        lt.clock.advance(advance)


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
@pytest.mark.parametrize("cu", [True, False])
@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW"])
def test_limiter_bit_identical_to_jax_across_rollovers(algo, cu, kernels):
    lj, lt = _pair(kernels, algo=algo, cu=cu)
    try:
        for lim in (lj, lt):
            lim.set_override("whale", 20)
            lim.set_override("guppy", 2)
        _drive(lj, lt, np.random.default_rng(0), 15, reset_at=8)
        _same_state(lj, lt)
    finally:
        lj.close()
        lt.close()


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TPU_SKETCH"])
def test_limiter_bit_identical_at_fractional_estimates(algo):
    """A larger limit with many colliding keys on a narrow sketch keeps
    the boundary-weighted estimates fractional, where the FMA rounding of
    the window read decides remaining and the CU deltas."""
    lj, lt = _pair("jnp", algo=algo, limit=300)
    try:
        rng = np.random.default_rng(11)
        for _ in range(16):
            ids = rng.zipf(1.3, size=256).astype(np.uint64)
            _same(lj.allow_ids(ids), lt.allow_ids(ids))
            step = float(rng.uniform(0.1, 0.9))
            lj.clock.advance(step)
            lt.clock.advance(step)
        _same_state(lj, lt)
    finally:
        lj.close()
        lt.close()


def test_limiter_bit_identical_when_the_clock_steps_back():
    """A backwards clock step (NTP) keeps the state's period; the step
    clamps the timestamp to the period start, as in the JAX package."""
    lj, lt = _pair("jnp")
    try:
        rng = np.random.default_rng(4)
        for advance in (0.8, 0.9, -1.3, 0.2, -0.4, 1.7, 0.3, -2.5, 0.6):
            ids = rng.integers(1, 20, size=40).astype(np.uint64)
            _same(lj.allow_ids(ids), lt.allow_ids(ids))
            lj.clock.advance(advance)
            lt.clock.advance(advance)
        _same_state(lj, lt)
    finally:
        lj.close()
        lt.close()


def test_failed_launch_honours_fail_open_and_fail_closed(monkeypatch):
    ids = np.arange(5, dtype=np.uint64)
    for fail_open in (True, False):
        cfg = dataclasses.replace(_cfg(T), fail_open=fail_open)
        lim = SketchLimiter(cfg, T.ManualClock(T0), device="cpu")

        def broken(*args, **kwargs):
            raise RuntimeError("device lost")

        monkeypatch.setattr(lim, "_ids_step", broken)
        if fail_open:
            res = lim.allow_ids(ids)
            assert res.fail_open and res.allowed.all()
            assert (res.remaining == 0).all()
        else:
            with pytest.raises(T.StorageUnavailableError, match="device lost"):
                lim.allow_ids(ids)
        lim.close()
        with pytest.raises(T.ClosedError):
            lim.allow_ids(ids)


def test_pipelined_launches_resolve_in_any_order():
    lj, lt = _pair("jnp")
    try:
        rng = np.random.default_rng(2)
        batches = [rng.integers(1, 16, size=32).astype(np.uint64)
                   for _ in range(4)]
        tickets = [lt.launch_ids(b, wire=bool(i % 2))
                   for i, b in enumerate(batches)]
        got = [lt.resolve(t) for t in reversed(tickets)][::-1]
        for b, res in zip(batches, got):
            _same(lj.allow_ids(b), res)
    finally:
        lj.close()
        lt.close()


def test_concurrent_launches_never_over_admit():
    """12 threads (more than cores) hammer one key through launch/resolve
    with a short switch interval: exactly ``limit`` requests are admitted,
    which a lost state update under the limiter's lock would break."""
    lim = SketchLimiter(_cfg(T, limit=50), T.ManualClock(T0), device="cpu")
    admitted = []

    def worker():
        for _ in range(20):
            res = lim.allow_ids(np.array([42], dtype=np.uint64))
            admitted.append(int(res.allowed.sum()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        lim.close()
    assert len(admitted) == 240
    assert sum(admitted) == 50


@pytest.mark.parametrize("cu", [True, False])
def test_state_carried_across_packages_both_ways(cu):
    """JAX runs the first half of a trace, the port restores its captured
    state and finishes it bit-identically to a JAX limiter that ran the
    whole trace; then the port's state goes back to a fresh JAX limiter."""
    ref, lt = _pair("jnp", cu=cu)
    half = JaxSketch(_cfg(R, cu=cu, kernels="jnp"), R.ManualClock(T0))
    try:
        for lim in (ref, half):
            lim.set_override("whale", 20)
        _drive(ref, half, np.random.default_rng(5), 7, reset_at=4)
        # The port picks up where the JAX limiter stopped.
        _, arrays, extra = half.capture_state()
        lt.restore_state(arrays, extra)
        lt.clock.set(half.clock.now())
        assert lt.get_override("whale").limit == 20
        _same_state(ref, lt)
        _drive(ref, lt, np.random.default_rng(6), 7)
        _same_state(ref, lt)
        # And back: a fresh JAX limiter restores the port's capture.
        back = JaxSketch(_cfg(R, cu=cu, kernels="jnp"), R.ManualClock(T0))
        _, arrays, extra = lt.capture_state()
        back._restore_loaded(dict(arrays), extra)
        back.clock.set(lt.clock.now())
        _same_state(back, lt)
        _drive(back, lt, np.random.default_rng(8), 4)
        _same_state(back, lt)
        back.close()
    finally:
        ref.close()
        half.close()
        lt.close()


def test_restore_refuses_other_geometry_and_missing_period():
    lj, lt = _pair("jnp")
    other = JaxSketch(dataclasses.replace(
        _cfg(R), sketch=R.SketchParams(depth=2, width=64, sub_windows=6)),
        R.ManualClock(T0))
    try:
        _, arrays, extra = other.capture_state()
        with pytest.raises(T.InvalidConfigError, match="geometry"):
            lt.restore_state(arrays, extra)
        _, arrays, extra = lj.capture_state()
        with pytest.raises(T.InvalidConfigError, match="host_period"):
            lt.restore_state(arrays, {})
    finally:
        lj.close()
        lt.close()
        other.close()


def test_create_limiter_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.create_limiter(_cfg(T), backend="sketch")
    lim = T.create_limiter(_cfg(T), backend="sketch", device="cpu")
    assert lim.device.type == "cpu"
    lim.close()


@pytest.mark.parametrize("cfg,match", [
    (dict(algo="TOKEN_BUCKET"), "cannot serve a TOKEN_BUCKET"),
])
def test_unported_configs_are_refused(cfg, match):
    with pytest.raises(T.InvalidConfigError, match=match):
        SketchLimiter(_cfg(T, **cfg), T.ManualClock(T0), device="cpu")


def test_hierarchy_and_other_backends_are_refused():
    # The hierarchy cascade is ported: a tenants=4 config serves (its
    # parity with the JAX package is tests/test_torch_hier.py's).
    cfg = dataclasses.replace(_cfg(T), hierarchy=dataclasses.replace(
        _cfg(T).hierarchy, tenants=4))
    lim = SketchLimiter(cfg, T.ManualClock(T0), device="cpu")
    lim.set_tenant("gold", 3)
    lim.assign_tenant("g", "gold")
    assert [lim.allow("g").allowed for _ in range(4)] == [True] * 3 + [False]
    assert lim.hierarchy_stats()["tenants"]["gold"]["in_window"] == 3
    lim.close()
    # The dense, exact and mesh backends are ported too
    # (tests/test_torch_dense.py, tests/test_torch_exact.py,
    # tests/test_torch_mesh.py); an unknown backend is refused.
    for backend in ("dense", "exact", "mesh"):
        T.create_limiter(_cfg(T), backend=backend, device="cpu").close()
    with pytest.raises(T.InvalidConfigError, match="unknown backend"):
        T.create_limiter(_cfg(T), backend="nope", device="cpu")
