"""Live reconfiguration in the port (on the CPU) against the JAX package:
``update_limit`` and ``update_window`` on the windowed sketch (the ring
migration) and on the sketched token bucket (the debt clamp).

Both packages get the same Config, the same ManualClock trace and the
same operations, with operands made by NumPy from a seed; every decision
field, every state slab, ``host_period`` and the watchdog's ledger must be
BIT-identical after every operation (tolerance 0). The JAX side runs its
``jnp`` reference path. The scenarios mirror tests/test_dynamic_config.py
and tests/test_dynamic_window.py (the windowed and bucket cases; the
heavy-hitter and mesh cases wait for ROADMAP A6 and A8). Also:
``_migrate_window`` alone on seeded rings holding ``_NEVER`` slots and
negative cells, and tickets in flight across an update.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T

T0 = 1_700_000_000.0
WINDOW_KEYS = ("cur", "slabs", "totals", "slab_period", "last_period")
BUCKET_KEYS = ("debt", "acc", "rem", "last")
RESULT_FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


def _cfg(M, *, algo="TPU_SKETCH", window=6.0, limit=10, sub_windows=6,
         cu=True, depth=2, width=128, policy="warn"):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window, max_batch_admission_iters=4,
                    sketch=M.SketchParams(depth=depth, width=width,
                                          sub_windows=sub_windows,
                                          conservative_update=cu,
                                          overload_policy=policy, **extra))


class Pair:
    """A JAX limiter and a port limiter on the CPU, driven in lockstep."""

    def __init__(self, **kw):
        self.cj, self.ct = R.ManualClock(T0), T.ManualClock(T0)
        self.j = R.create_limiter(_cfg(R, **kw), backend="sketch",
                                  clock=self.cj)
        self.t = T.create_limiter(_cfg(T, **kw), clock=self.ct,
                                  device="cpu")
        self.bucket = kw.get("algo") == "TOKEN_BUCKET"

    def advance(self, dt):
        self.cj.advance(dt)
        self.ct.advance(dt)

    def both(self, name, *args, **kw):
        """Call ``name`` on both; the results (or the raised error types)
        must match, and so must the state afterwards."""
        out = []
        for lim in (self.j, self.t):
            try:
                out.append(getattr(lim, name)(*args, **kw))
            except Exception as exc:  # noqa: BLE001 — compared below
                out.append(exc)
        a, b = out
        if isinstance(a, Exception) or isinstance(b, Exception):
            assert type(a).__name__ == type(b).__name__, (a, b)
        else:
            same_result(a, b)
        self.check_state()
        return b

    def check_state(self):
        kj, aj, ej = self.j.capture_state()
        kt, at, et = self.t.capture_state()
        assert kj == kt
        for k in (BUCKET_KEYS if self.bucket else WINDOW_KEYS):
            x, y = np.asarray(aj[k]), np.asarray(at[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        for k in ("policy_keys", "policy_limits", "policy_scales"):
            np.testing.assert_array_equal(aj[k], at[k], err_msg=k)
        assert ej.get("host_period") == et.get("host_period")
        assert self.j.config.limit == self.t.config.limit
        assert self.j.config.window == self.t.config.window
        if not self.bucket:
            for attr in ("_period_mass", "overload_periods",
                         "_warned_period", "_inflight_mass", "_sub_us",
                         "_ring_sw", "_window_us", "mass_budget"):
                assert getattr(self.j, attr) == getattr(self.t, attr), attr

    def close(self):
        self.j.close()
        self.t.close()


def same_result(a, b):
    if hasattr(a, "allowed") and np.ndim(a.allowed):
        for f in RESULT_FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.limit == b.limit
        if a.limits is None:
            assert b.limits is None
        else:
            np.testing.assert_array_equal(a.limits, b.limits)
    elif hasattr(a, "allowed"):
        for f in ("allowed", "limit", "remaining", "retry_after",
                  "reset_at"):
            assert getattr(a, f) == getattr(b, f), f
    elif dataclasses.is_dataclass(a):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    else:
        assert a == b


# Each scenario: (pair kwargs, operations). An operation is
# ("advance", dt) or (method, *args), run on both packages.
SCENARIOS = {
    # tests/test_dynamic_window.py, windowed
    "shrink_keeps_quota": ({}, [("allow_n", "k", 10),
                                ("update_window", 3.0), ("allow", "k")]),
    "grow_keeps_quota": (dict(window=3.0, sub_windows=3),
                         [("allow_n", "k", 10), ("update_window", 12.0),
                          ("allow", "k")]),
    "expiry_follows_new_window": (
        dict(window=60.0, sub_windows=60),
        [("allow_n", "k", 10), ("update_window", 3.0), ("advance", 4.5),
         ("allow_n", "k", 10)]),
    "grow_keeps_history_longer": (
        dict(window=3.0, sub_windows=3),
        [("allow_n", "k", 10), ("update_window", 30.0), ("advance", 5.0),
         ("allow", "k"), ("advance", 35.0), ("allow", "k")]),
    "never_over_admits": ({}, [("allow", "k")] * 8
                          + [("update_window", 3.0)] + [("allow", "k")] * 8),
    "fresh_keys_unaffected": ({}, [("allow_n", "a", 10),
                                   ("update_window", 3.0),
                                   ("allow_batch", ["b"] * 10)]),
    "watchdog_ledger_remapped": (
        {}, [("allow_batch", [f"k{i}" for i in range(50)]),
             ("update_window", 12.0), ("in_window_admitted_mass",)]),
    "retry_and_reset_follow_new_window": (
        dict(window=60.0, sub_windows=60),
        [("allow_n", "k", 10), ("update_window", 3.0), ("allow", "k")]),
    "uneven_60_45_120": (
        dict(window=60.0, sub_windows=60, limit=100),
        [("allow_n", "a", 30), ("advance", 7.3), ("allow_n", "a", 30),
         ("allow_n", "b", 50), ("advance", 20.6), ("allow_n", "a", 30),
         ("update_window", 45.0), ("allow_n", "a", 20),
         ("allow_n", "b", 60), ("advance", 12.2),
         ("update_window", 120.0), ("allow_n", "a", 20),
         ("advance", 50.0), ("allow_n", "b", 40), ("advance", 80.0),
         ("allow_n", "a", 100)]),
    "fixed_window": (dict(algo="FIXED_WINDOW"),
                     [("allow_n", "k", 6), ("advance", 2.0),
                      ("update_window", 9.0), ("allow_n", "k", 5),
                      ("advance", 9.5), ("allow_n", "k", 10)]),
    "vanilla": (dict(cu=False),
                [("allow_batch", ["k", "j", "k"]), ("advance", 1.5),
                 ("update_window", 2.0), ("allow_batch", ["k"] * 12)]),
    "invalid_window_rejected": ({}, [("allow_n", "k", 3),
                                     ("update_window", 0.0),
                                     ("allow_n", "k", 7)]),
    "reset_after_migration": ({}, [("allow_n", "k", 9), ("advance", 2.2),
                                   ("update_window", 4.5), ("reset", "k"),
                                   ("allow_n", "k", 10)]),
    # tests/test_dynamic_config.py, windowed
    "raise_limit_keeps_consumption": (
        {}, [("allow_n", "k", 8), ("update_limit", 15), ("allow_n", "k", 7),
             ("allow", "k")]),
    "lower_limit_denies_immediately": (
        {}, [("allow_n", "k", 6), ("update_limit", 5), ("allow", "k")]),
    "invalid_limit_rejected": (
        {}, [("allow_n", "k", 3), ("update_limit", 1 << 24),
             ("allow_n", "k", 7), ("allow", "k")]),
    "override_pins_absolute_limit": (
        {}, [("set_override", "vip", 3), ("update_limit", 20),
             ("allow_batch", ["vip"] * 5 + ["k"] * 15)]),
    "fixed_window_limit": (dict(algo="FIXED_WINDOW"),
                           [("allow_n", "k", 10), ("update_limit", 12),
                            ("allow_n", "k", 2), ("allow", "k")]),
    # tests/test_dynamic_config.py and test_dynamic_window.py, bucket
    "bucket_raise_limit": (
        dict(algo="TOKEN_BUCKET"),
        [("allow_n", "k", 8), ("update_limit", 15), ("allow_n", "k", 7),
         ("allow", "k"), ("advance", 0.7), ("allow_n", "k", 2)]),
    "bucket_lower_limit_clamps_debt": (
        dict(algo="TOKEN_BUCKET", limit=20, window=10.0),
        [("allow_n", "k", 18), ("update_limit", 5), ("allow", "k"),
         ("advance", 1.0), ("allow", "k"), ("advance", 3.3),
         ("allow_n", "k", 2)]),
    "bucket_rate_changes_debt_stands": (
        dict(algo="TOKEN_BUCKET", window=10.0),
        [("allow_n", "k", 10), ("update_window", 5.0), ("allow", "k"),
         ("advance", 1.1), ("allow_n", "k", 2), ("allow", "k")]),
    "bucket_remainder_resets": (
        dict(algo="TOKEN_BUCKET", limit=7, window=3.0),
        [("allow_n", "k", 7), ("advance", 0.1234567),
         ("allow", "k"), ("update_limit", 9), ("advance", 0.3333337),
         ("allow", "k"), ("update_window", 7.0), ("advance", 0.7777),
         ("allow_batch", ["k", "j", "k"])]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    kw, ops = SCENARIOS[name]
    p = Pair(**kw)
    p.check_state()
    for op in ops:
        if op[0] == "advance":
            p.advance(op[1])
        else:
            p.both(*op)
    p.close()


@pytest.mark.parametrize("algo,cu", [("SLIDING_WINDOW", True),
                                     ("SLIDING_WINDOW", False),
                                     ("TOKEN_BUCKET", True)])
def test_seeded_trace_with_tickets_in_flight(algo, cu):
    """Random hashed traffic with tickets in flight across every update:
    tickets launched before an update resolve to their pre-update
    answers, and everything after matches the JAX package."""
    rng = np.random.default_rng(len(algo) + cu)
    p = Pair(algo=algo, cu=cu)
    windows = [4.5, 12.0]
    limits = [5, 15]
    for step in range(12):
        tickets = []
        for _ in range(3):
            ids = rng.integers(0, 40, 16).astype(np.uint64)
            ns = rng.integers(1, 4, 16).astype(np.int64)
            tickets.append((p.j.launch_ids(ids, ns), p.t.launch_ids(ids, ns)))
        if step % 6 == 2:
            p.j.update_window(windows[step // 6])
            p.t.update_window(windows[step // 6])
        elif step % 6 == 5:
            p.j.update_limit(limits[step // 6 % 3])
            p.t.update_limit(limits[step // 6 % 3])
        for tj, tt in tickets:
            same_result(p.j.resolve(tj), p.t.resolve(tt))
        p.check_state()
        p.advance(float(rng.uniform(0.05, 1.3)))
    p.close()


def test_update_limit_rebuilds_steps_under_inflight_ticket():
    """A ticket launched before update_limit answers under the old limit;
    the next launch under the new one."""
    p = Pair(limit=10)
    ids = np.zeros(12, np.uint64)
    tj, tt = p.j.launch_ids(ids), p.t.launch_ids(ids)
    p.j.update_limit(3)
    p.t.update_limit(3)
    a, b = p.j.resolve(tj), p.t.resolve(tt)
    same_result(a, b)
    assert int(b.allowed.sum()) == 10 and b.limit == 10
    p.both("allow_ids", np.zeros(2, np.uint64))
    p.close()


def test_geometry_change_rejected():
    from ratelimiter_tpu_torch.ops import sketch_kernels

    lim = T.create_limiter(_cfg(T), device="cpu")
    other = _cfg(T, depth=3, window=3.0)
    with pytest.raises(T.InvalidConfigError):
        sketch_kernels.build_migrate(lim.config, other)
    lim.close()


# ------------------------------------------------ _migrate_window alone

def _seeded_ring(rng, So, SWo, d, w, p_last):
    """A ring of ``So`` slabs: int32 cells of both signs (a reset leaves
    negative cells), periods mixing in-window, stale, future and _NEVER
    slots."""
    slabs = rng.integers(-50, 400, (So, d, w)).astype(np.int32)
    choices = np.concatenate([
        np.arange(p_last - SWo - 2, p_last + 1),
        [R.ops.sketch_kernels._NEVER] * 4])
    periods = rng.choice(choices, So).astype(np.int64)
    return {
        "cur": rng.integers(-20, 200, (d, w)).astype(np.int32),
        "slabs": slabs,
        "totals": rng.integers(-20, 900, (d, w)).astype(np.int32),
        "slab_period": periods,
        "last_period": np.asarray(p_last, np.int64),
    }


@pytest.mark.parametrize("old,new", [
    ((6.0, 6), (4.5, 6)),      # shrink, new sub-windows uneven
    ((6.0, 6), (13.0, 6)),     # grow
    ((60.0, 60), (45.0, 60)),  # config 3's 60 -> 45 s
    ((45.0, 60), (120.0, 60)),
    ((6.0, 1), (4.0, 8)),      # fixed-size ring to a longer one
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_migrate_window_alone(old, new, seed):
    import jax.numpy as jnp

    from ratelimiter_tpu.ops import sketch_kernels as jk
    from ratelimiter_tpu_torch.ops import sketch_kernels as tk

    rng = np.random.default_rng(seed)
    cj_old = _cfg(R, window=old[0], sub_windows=old[1], width=32, depth=3)
    cj_new = _cfg(R, window=new[0], sub_windows=new[1], width=32, depth=3)
    ct_old = _cfg(T, window=old[0], sub_windows=old[1], width=32, depth=3)
    ct_new = _cfg(T, window=new[0], sub_windows=new[1], width=32, depth=3)
    _, sub_o, SWo, So, _ = tk.sketch_geometry(ct_old)
    p_last = int(T0 * 1e6) // sub_o
    state = _seeded_ring(rng, So, SWo, 3, 32, p_last)
    now_us = p_last * sub_o + int(rng.integers(0, 3 * sub_o))
    want = jk.build_migrate(cj_old, cj_new)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.int64(now_us))
    got = tk.build_migrate(ct_old, ct_new)(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
        now_us)
    assert set(got) == set(want)
    for k in want:
        x, y = np.asarray(want[k]), got[k].numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
