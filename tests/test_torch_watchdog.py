"""The windowed limiter's mass-budget watchdog in the port (on the CPU)
against the JAX package: ``overload_policy="warn"`` and ``"strict"``.

Both packages get the same Config, ManualClock trace and operations; the
decisions, the admitted-mass ledger, ``overload_periods``, the in-flight
mass and the warnings logged (count and text) must match exactly. The
cases mirror tests/test_geometry.py (TestMassWatchdog,
TestStrictOverloadPolicy) and tests/test_pipeline.py (the strict gate
counts in-flight mass). The JAX side runs its ``jnp`` reference path.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T

T0 = 1_700_000_000.0
FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


def _cfg(M, *, policy="warn", width=16, limit=5, sub_windows=6, window=6.0,
         algo="TPU_SKETCH", iters=1, depth=3):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window, max_batch_admission_iters=iters,
                    sketch=M.SketchParams(depth=depth, width=width,
                                          sub_windows=sub_windows,
                                          overload_policy=policy, **extra))


def _pair(**kw):
    cj, ct = R.ManualClock(T0), T.ManualClock(T0)
    return (R.create_limiter(_cfg(R, **kw), backend="sketch", clock=cj),
            T.create_limiter(_cfg(T, **kw), clock=ct, device="cpu"),
            (cj, ct))


def _same(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _ledger(lim):
    return (dict(lim._period_mass), lim.overload_periods,
            lim._warned_period, lim._inflight_mass,
            lim.in_window_admitted_mass(), lim.mass_budget)


def _warnings(caplog, logger):
    return [r.getMessage() for r in caplog.records
            if r.name == logger and r.levelno == logging.WARNING]


def _run(caplog, ops, **kw):
    """Run ``ops`` on both packages; compare every result and the ledger
    after each, and the warnings logged by each package at the end.
    Returns the port's results."""
    lj, lt, clocks = _pair(**kw)
    got = []
    with caplog.at_level(logging.WARNING):
        for op, *args in ops:
            if op == "advance":
                for c in clocks:
                    c.advance(args[0])
                continue
            a = getattr(lj, op)(*args)
            b = getattr(lt, op)(*args)
            if op in ("allow", "allow_n"):
                assert (a.allowed, a.remaining, a.retry_after,
                        a.reset_at) == (b.allowed, b.remaining,
                                        b.retry_after, b.reset_at)
            elif op != "update_limit":
                _same(a, b)
            assert _ledger(lj) == _ledger(lt)
            got.append(b)
    wj = _warnings(caplog, "ratelimiter_tpu")
    wt = _warnings(caplog, "ratelimiter_tpu_torch")
    assert wj == wt
    lj.close()
    lt.close()
    return got, wt


def _keys(prefix, n):
    return [f"{prefix}{i}" for i in range(n)]


def test_overload_warns_once_per_subwindow(caplog):
    got, warns = _run(caplog, [
        ("allow_batch", _keys("k", 200)), ("allow_batch", _keys("k", 200)),
        ("advance", 1.1), ("allow_batch", _keys("j", 200))])
    assert len(warns) == 2
    assert all("geometry undersized" in w for w in warns)


def test_mass_expires_with_the_window(caplog):
    _run(caplog, [("allow_batch", _keys("k", 100)), ("advance", 7.0),
                  ("allow", "fresh")])


def test_within_budget_never_warns(caplog):
    _, warns = _run(caplog, [("allow_batch", _keys("k", 300))] * 3,
                    width=1024)
    assert warns == []


def test_denied_requests_do_not_count(caplog):
    got, _ = _run(caplog, [("allow", "hot")] * 10, width=64, limit=3)
    assert sum(r.allowed for r in got) == 3


def test_budget_follows_dynamic_limit(caplog):
    _run(caplog, [("allow_batch", _keys("k", 150)), ("update_limit", 4),
                  ("allow_batch", _keys("m", 20)), ("update_limit", 50),
                  ("allow_batch", _keys("n", 20))], width=16)


def test_token_bucket_excluded():
    lim = T.create_limiter(_cfg(T, algo="TOKEN_BUCKET"), device="cpu",
                           clock=T.ManualClock(T0))
    for i in range(50):
        lim.allow(f"k{i}")             # must not touch the watchdog
    with pytest.raises(NotImplementedError):
        lim.in_window_admitted_mass()
    with pytest.raises(NotImplementedError):
        lim.mass_budget
    lim.close()


@pytest.mark.parametrize("policy", ["strict", "warn"])
def test_over_budget(caplog, policy):
    """Strict: past the budget every new batch is denied (no state write)
    until history expires; warn keeps admitting."""
    got, warns = _run(caplog, [
        ("allow_batch", _keys("k", 200)), ("allow_batch", _keys("m", 10)),
        ("allow", "x"), ("advance", 1.5), ("allow_batch", _keys("y", 3)),
        ("advance", 7.0), ("allow", "x")], policy=policy)
    assert int(got[0].allowed.sum()) == 200
    if policy == "strict":
        assert int(got[1].allowed.sum()) == 0
        assert (got[1].retry_after > 0).all()
        assert any("overload (strict)" in w for w in warns)
    else:
        assert int(got[1].allowed.sum()) == 10
    assert got[-1].allowed


def test_strict_accepted_by_config():
    lim = T.create_limiter(_cfg(T, policy="strict"), device="cpu")
    assert lim._strict
    lim.close()
    with pytest.raises(T.InvalidConfigError, match="overload_policy"):
        T.SketchParams(overload_policy="explode").validate()


@pytest.mark.parametrize("lane", ["batch", "ids"])
def test_strict_gate_counts_inflight_mass(lane):
    """Launched-but-unresolved mass counts against the budget at full
    offered weight, so a deep in-flight window cannot slip admissions
    past the gate; resolve swaps it for the admitted mass, leaking
    nothing."""
    lj, lt, _ = _pair(policy="strict", width=256, limit=5, window=60.0,
                      iters=4)
    n = lt.mass_budget // 2 + 1

    def launch(lim, prefix, count):
        if lane == "batch":
            return lim.launch_batch(_keys(prefix, count))
        base = 1_000_000 * (ord(prefix) - 96)
        return lim.launch_ids(np.arange(base, base + count, dtype=np.uint64))

    tickets = [(launch(lj, p, n), launch(lt, p, n)) for p in "ab"]
    assert lj._inflight_mass == lt._inflight_mass == 2 * n
    tj, tt = launch(lj, "c", 1), launch(lt, "c", 1)
    assert tt.result is not None and not tt.result.allowed.any()
    _same(tj.result, tt.result)
    assert lj.overload_periods == lt.overload_periods == 1
    for a, b in tickets:
        ra, rb = lj.resolve(a), lt.resolve(b)
        _same(ra, rb)
        assert rb.allowed.all()
        lt.resolve(b)                  # idempotent: retires once
    assert _ledger(lj) == _ledger(lt)
    assert lt._inflight_mass == 0
    assert lt.in_window_admitted_mass() == 2 * n
    lj.close()
    lt.close()


def test_failed_resolve_retires_inflight_mass():
    """A ticket whose device work fails still leaves the in-flight count
    (resolved with 0 admitted), as in the JAX package."""
    lim = T.create_limiter(_cfg(T, policy="strict"), device="cpu",
                           clock=T.ManualClock(T0))
    t = lim.launch_batch(_keys("k", 4))
    assert lim._inflight_mass == 4

    class Boom:
        def synchronize(self):
            raise RuntimeError("device lost")

    t.event = Boom()
    with pytest.raises(T.StorageUnavailableError):
        lim.resolve(t)
    assert lim._inflight_mass == 0
    assert lim.in_window_admitted_mass() == 0
    lim.close()
