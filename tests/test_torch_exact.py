"""The port's exact backend (host dicts, the conformance oracle) against
the JAX package's, and against the port's dense backend.

``ExactLimiter`` is host code in both packages; the port keeps its own
copy. Seeded random traces (NumPy) of all three algorithms, with policy
overrides (window-scaled ones included), resets, ``update_limit``,
``update_window`` and ``prune``, go through both; every result field, the
key count and the captured state must be identical (tolerance 0). The
port's dense backend must decide every such trace exactly as its exact
backend does (the JAX package pins the same in
tests/test_cross_backend.py). Snapshots cross the packages both ways;
fault injection answers per ``fail_open``.
"""

from __future__ import annotations

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T

T0 = 1_700_000_000.0
ALGOS = ("FIXED_WINDOW", "SLIDING_WINDOW", "TOKEN_BUCKET", "TPU_SKETCH")
FIELDS = ("allowed", "limit", "remaining", "retry_after", "reset_at",
          "fail_open")


def _cfg(M, algo, limit=5, window=2.0, **kw):
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window, dense=M.DenseParams(capacity=256), **kw)


def _fields(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


def _same_batch(a, b, msg=""):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, (msg, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


def _ops(rng, steps=40):
    """A seeded trace: (op, args) tuples."""
    now = T0
    out = []
    for it in range(steps):
        now += float(rng.choice([0.0, 0.05, 0.3, 0.9, 2.5]))
        if it == 6:
            out.append(("set_override", ("k1", 9), {}))
            out.append(("set_override", ("k2", 2), {"window_scale": 2.0}))
        if it == 12:
            out.append(("reset", ("k3",), {}))
        if it == 16:
            out.append(("update_limit", (3,), {}))
        if it == 22:
            out.append(("delete_override", ("k2",), {}))
            out.append(("update_window", (3.5,), {"now": now}))
        if it == 28:
            out.append(("update_limit", (8,), {}))
        if it == 34:
            out.append(("prune", (), {"now": now + 7.0}))
        keys = [f"k{i}" for i in rng.integers(0, 12, 24)]
        ns = [int(n) for n in rng.integers(1, 4, 24)]
        out.append(("allow_batch", (keys, ns), {"now": now}))
        out.append(("allow_n", ("k1", 2), {"now": now}))
    return out


def _run(lim, ops, clock):
    got = []
    for name, args, kw in ops:
        if name == "update_window":
            clock.set(kw["now"])
            lim.update_window(*args)
            continue
        got.append((name, getattr(lim, name)(*args, **kw)))
    return got


def _compare(got_a, got_b, msg):
    assert len(got_a) == len(got_b)
    for i, ((na, a), (nb, b)) in enumerate(zip(got_a, got_b)):
        assert na == nb
        if na == "allow_batch":
            _same_batch(a, b, f"{msg} {i}")
        elif na == "allow_n":
            assert _fields(a) == _fields(b), (msg, i)
        elif na in ("prune", "delete_override"):
            assert a == b, (msg, i, na)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algo", ALGOS)
def test_exact_matches_jax(algo, seed):
    """Every result, the key count and the captured state."""
    ops = _ops(np.random.default_rng(seed + 17 * ALGOS.index(algo)))
    cj, ct = R.ManualClock(T0), T.ManualClock(T0)
    lj = R.create_limiter(_cfg(R, algo), "exact", clock=cj)
    lt = T.create_limiter(_cfg(T, algo), "exact", clock=ct)
    _compare(_run(lj, ops, cj), _run(lt, ops, ct), algo)
    assert lj.key_count() == lt.key_count()
    kj, aj, _ = lj.capture_state()
    kt, at, _ = lt.capture_state()
    assert kj == kt == "exact" and set(aj) == set(at)
    for k in aj:
        assert np.asarray(aj[k]).dtype == np.asarray(at[k]).dtype, k
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)


@pytest.mark.parametrize("algo", ALGOS)
def test_exact_equals_dense(algo):
    """The port's dense backend decides every trace as its exact one
    (the integer recurrences are the same; tests/test_cross_backend.py
    pins the JAX pair)."""
    ops = _ops(np.random.default_rng(40 + ALGOS.index(algo)))
    ce, cd = T.ManualClock(T0), T.ManualClock(T0)
    le = T.create_limiter(_cfg(T, algo), "exact", clock=ce)
    ld = T.create_limiter(_cfg(T, algo), "dense", clock=cd, device="cpu")
    _compare(_run(le, ops, ce), _run(ld, ops, cd), algo)


@pytest.mark.parametrize("algo", ALGOS[:3])
def test_snapshot_crosses_packages_both_ways(algo, tmp_path):
    """An exact snapshot saved by either package restores in the other,
    overrides included, and both decide alike afterwards."""
    rng = np.random.default_rng(9)
    lj = R.create_limiter(_cfg(R, algo), "exact", clock=R.ManualClock(T0))
    lt = T.create_limiter(_cfg(T, algo), "exact", clock=T.ManualClock(T0))
    for lim in (lj, lt):
        lim.set_override("k0", 7, window_scale=0.5)
    for _ in range(4):
        keys = [f"k{i}" for i in rng.integers(0, 8, 16)]
        _same_batch(lj.allow_batch(keys, now=T0 + 0.4),
                    lt.allow_batch(keys, now=T0 + 0.4))
    lj.save(str(tmp_path / "j.npz"))
    lt.save(str(tmp_path / "t.npz"))
    rj = R.create_limiter(_cfg(R, algo), "exact")
    rt = T.create_limiter(_cfg(T, algo), "exact")
    rj.restore(str(tmp_path / "t.npz"))
    rt.restore(str(tmp_path / "j.npz"))
    assert rt.get_override("k0").window_scale == 0.5
    for _ in range(3):
        keys = [f"k{i}" for i in rng.integers(0, 10, 16)]
        want = lj.allow_batch(keys, now=T0 + 1.1)
        _same_batch(want, rj.allow_batch(keys, now=T0 + 1.1))
        _same_batch(want, rt.allow_batch(keys, now=T0 + 1.1))
    with pytest.raises(T.CheckpointError, match="kind"):
        T.create_limiter(_cfg(T, algo), "dense", device="cpu").restore(
            str(tmp_path / "j.npz"))


@pytest.mark.parametrize("fail_open", [False, True])
def test_fault_injection(fail_open):
    """inject_failure answers fail-open or raises StorageUnavailableError,
    as the JAX oracle; heal() restores."""
    lj = R.create_limiter(_cfg(R, "SLIDING_WINDOW", fail_open=fail_open),
                          "exact")
    lt = T.create_limiter(_cfg(T, "SLIDING_WINDOW", fail_open=fail_open),
                          "exact")
    for lim in (lj, lt):
        lim.inject_failure()
    if fail_open:
        assert (_fields(lj.allow("a", now=T0))
                == _fields(lt.allow("a", now=T0)))
        assert lt.allow("a", now=T0).fail_open
    else:
        with pytest.raises(T.StorageUnavailableError, match="injected"):
            lt.allow("a", now=T0)
    for lim in (lj, lt):
        lim.heal()
    assert _fields(lj.allow("a", now=T0)) == _fields(lt.allow("a", now=T0))
