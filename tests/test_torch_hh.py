"""The heavy-hitter side table (``SketchParams.hh_slots > 0``) in the port,
on the CPU, against the JAX package's ``jnp`` path.

Both packages get the same Config, the same ManualClock trace and the same
operands, made with NumPy from a seed; every decision field and every
state array, the six ``hh_*`` arrays included, must be BIT-identical
(tolerance 0). The JAX package runs its jnp reference for this config
(its Pallas path turns itself off with a side table), so that is what the
port's plain versions are held to here, and what ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold its kernels to on the card. Covered: the
scenarios of tests/test_hh.py::TestHHSemantics run in both packages;
seeded CU and vanilla traces, sliding and fixed, with 4 tickets in
flight, across rollovers, eviction and re-promotion; the fused rounding
of the side table's boundary read; a key whose h1 is 0, a padded batch
whose padding key owns its slot, and claim contention on one slot; the
reset of an owned key; live limit and window updates; snapshots across
the packages; ``consumer_stats``; convert.py; the bucket, which ignores
the side table; and the door with ``--hh-slots``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.algorithms.sketch import SketchLimiter as JaxSketch
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu_torch import convert
from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter
from ratelimiter_tpu_torch.ops import sketch_cuda as sc
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk
from ratelimiter_tpu_torch.ops.hashing import split_hash, splitmix64
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.server import run_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its door check, run here on the CPU)

T0 = 1_700_000_000.0
SEED = 0x5BD1E995
RESULT_FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


def _cfg(M, *, limit=10, window=6.0, hh_slots=16, frac=0.5, cu=True,
         algo="SLIDING_WINDOW", depth=2, width=64, **kw):
    """tests/test_hh.py's geometry (d=2, w=64, 6 sub-windows) by default."""
    sketch = dict(depth=depth, width=width, sub_windows=6, hh_slots=hh_slots,
                  hh_promote_fraction=frac, conservative_update=cu)
    if M is R:
        sketch["kernels"] = "jnp"
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window, max_batch_admission_iters=4,
                    sketch=M.SketchParams(**sketch), **kw)


def _pair(**kw):
    return (JaxSketch(_cfg(R, **kw), R.ManualClock(T0)),
            SketchLimiter(_cfg(T, **kw), T.ManualClock(T0), device="cpu"))


def _same(a, b):
    for f in RESULT_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_state(lj, lt):
    """Every state array (the policy columns too) of the two limiters'
    captures: same names, dtypes and bits."""
    sj, st = lj.capture_state()[1], lt.capture_state()[1]
    assert sorted(sj) == sorted(st)
    for k in sj:
        a = np.asarray(sj[k])
        assert a.dtype == st[k].dtype, k
        np.testing.assert_array_equal(a, st[k], err_msg=k)


class Pair:
    """One operation at a time on both packages' limiters, each result
    held equal; ``check`` holds every state array equal."""

    def __init__(self, **kw):
        self.j, self.t = _pair(**kw)

    def allow(self, key, n=1):
        a, b = self.j.allow_n(key, n), self.t.allow_n(key, n)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        return b

    def allow_batch(self, keys):
        a, b = self.j.allow_batch(keys), self.t.allow_batch(keys)
        _same(a, b)
        return b

    def reset(self, key):
        self.j.reset(key)
        self.t.reset(key)

    def advance(self, s):
        self.j.clock.advance(s)
        self.t.clock.advance(s)

    def owners(self):
        own = self.t.capture_state()[1]["hh_owner"]
        np.testing.assert_array_equal(
            np.asarray(self.j.capture_state()[1]["hh_owner"]), own)
        return int(np.count_nonzero(own))

    def check(self):
        _same_state(self.j, self.t)

    def close(self):
        self.j.close()
        self.t.close()


# ------------------------------------------ tests/test_hh.py's scenarios


def _exactness_across_promotion(p, tmp_path):
    assert sum(p.allow("hot").allowed for _ in range(25)) == 10
    assert p.owners() == 1


def _window_slide_recovers_quota(p, tmp_path):
    for _ in range(15):
        p.allow("hot")
    p.advance(7.0)
    assert sum(p.allow("hot").allowed for _ in range(15)) == 10


def _boundary_weighting_survives_promotion(p, tmp_path):
    assert p.allow("hot", 10).allowed
    assert not p.allow("hot").allowed
    p.advance(3.5)
    assert not p.allow("hot").allowed
    p.advance(3.0)
    got = sum(p.allow("hot").allowed for _ in range(10))
    assert 2 <= got <= 8


def _reset_clears_promoted_key(p, tmp_path):
    p.allow("hot", 10)
    assert not p.allow("hot").allowed
    p.check()
    p.reset("hot")
    p.check()
    assert p.allow("hot").allowed


def _idle_owner_evicted_and_slot_reusable(p, tmp_path):
    for _ in range(12):
        p.allow("hot")
    assert p.owners() == 1
    for step in range(8):
        p.advance(1.0)
        p.allow(f"tick{step}")
        p.check()
    assert p.owners() <= 1
    assert p.allow("hot").allowed


def _batch_duplicates_sequenced_through_hh(p, tmp_path):
    for _ in range(3):
        p.allow("h")
    assert int(np.sum(p.allow_batch(["h"] * 12).allowed)) == 7


def _unpromoted_keys_unaffected(p, tmp_path):
    assert p.allow_batch([f"c{i}" for i in range(30)]).allow_count == 30
    assert p.owners() == 0


def _vanilla_update_mode_works(p, tmp_path):
    assert sum(p.allow("hot").allowed for _ in range(25)) == 10


def _checkpoint_roundtrip_with_hh_state(p, tmp_path):
    """Each package saves; the other package's fresh limiter restores."""
    for _ in range(12):
        p.allow("hot")
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    p.j.save(pj)
    p.t.save(pt)
    q = Pair()
    try:
        q.j.restore(pt)
        q.t.restore(pj)
        q.check()
        assert not q.allow("hot").allowed
        np.testing.assert_array_equal(
            q.t.capture_state()[1]["hh_owner"],
            p.t.capture_state()[1]["hh_owner"])
    finally:
        q.close()


SCENARIOS = {
    "exactness_across_promotion": (_exactness_across_promotion, {}),
    "window_slide_recovers_quota": (_window_slide_recovers_quota, {}),
    "boundary_weighting_survives_promotion": (
        _boundary_weighting_survives_promotion, {}),
    "reset_clears_promoted_key": (_reset_clears_promoted_key, {}),
    "idle_owner_evicted_and_slot_reusable": (
        _idle_owner_evicted_and_slot_reusable, {}),
    "batch_duplicates_sequenced_through_hh": (
        _batch_duplicates_sequenced_through_hh, {}),
    "unpromoted_keys_unaffected": (_unpromoted_keys_unaffected,
                                   {"frac": 1.0}),
    "vanilla_update_mode_works": (_vanilla_update_mode_works, {"cu": False}),
    "checkpoint_roundtrip_with_hh_state": (
        _checkpoint_roundtrip_with_hh_state, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hh_semantics_scenario_in_both_packages(name, tmp_path):
    fn, kw = SCENARIOS[name]
    p = Pair(**kw)
    try:
        fn(p, tmp_path)
        p.check()
    finally:
        p.close()


def test_promote_fraction_is_validated_as_in_jax():
    for frac in (0.0, -0.5, 1.5):
        with pytest.raises(R.InvalidConfigError):
            R.SketchParams(hh_promote_fraction=frac).validate()
        with pytest.raises(T.InvalidConfigError, match="hh_promote_fraction"):
            T.SketchParams(hh_promote_fraction=frac).validate()
    T.SketchParams(hh_slots=16, hh_promote_fraction=1.0).validate()


# ------------------------------------------------------- seeded traces


def _trace_ops(seed: int, steps: int):
    """Per step a batch of Zipf(1.3) raw ids over 48 keys (hot keys cross
    the threshold of 5 and promote), sometimes string keys, with request
    counts 1-3; time advances 0.4 s a step with one jump of 7 s (past the
    6 s window: every owner idles out, then hot keys promote again)."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(steps):
        ids = (rng.zipf(1.3, size=32) % 48).astype(np.uint64)
        ns = rng.integers(1, 4, size=32).astype(np.int64)
        ops.append(("ids", ids, ns, bool(step % 2)))
        if step % 5 == 4:
            keys = [f"k{int(i)}" for i in rng.integers(0, 6, size=12)]
            ops.append(("keys", keys, None, False))
        ops.append(("advance", 7.0 if step == steps // 2 else 0.4))
    return ops


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW"])
@pytest.mark.parametrize("cu", [True, False])
def test_seeded_trace_with_tickets_in_flight(cu, algo):
    """4 tickets in flight (``launch_ids``, every other one wire-packed,
    and ``launch_batch``), a reset and an override; every result, and
    every state array after every launch, bit-identical."""
    lj, lt = _pair(cu=cu, algo=algo, limit=10, hh_slots=16, depth=4,
                   width=256)
    lj.set_override("k1", 4)
    lt.set_override("k1", 4)
    pend = []
    promoted = evicted = 0
    prev_owners = 0
    for i, op in enumerate(_trace_ops(3 + cu, 24)):
        if op[0] == "advance":
            lj.clock.advance(op[1])
            lt.clock.advance(op[1])
            continue
        if i == 30:
            while pend:
                a, b = pend.pop(0)
                _same(lj.resolve(a), lt.resolve(b))
            lj.reset("k2")
            lt.reset("k2")
        if op[0] == "ids":
            pend.append((lj.launch_ids(op[1], op[2], wire=op[3]),
                         lt.launch_ids(op[1], op[2], wire=op[3])))
        else:
            pend.append((lj.launch_batch(op[1]), lt.launch_batch(op[1])))
        _same_state(lj, lt)
        owners = int(np.count_nonzero(lt.capture_state()[1]["hh_owner"]))
        promoted += owners > prev_owners
        evicted += owners < prev_owners
        prev_owners = owners
        while len(pend) > 4:
            a, b = pend.pop(0)
            _same(lj.resolve(a), lt.resolve(b))
    for a, b in pend:
        _same(lj.resolve(a), lt.resolve(b))
    assert promoted >= 2 and evicted >= 1 and prev_owners >= 1
    lj.close()
    lt.close()


# --------------------------------------------------- step-level cases


def _halves(ids):
    """(h1, h2) of raw u64 ids as the raw-id lane hashes them."""
    return split_hash(splitmix64(np.asarray(ids, np.uint64)), SEED)


def _arrays(rng, K: int, S: int, d: int, w: int, period: int):
    """A windowed state with a side table, as after traffic and resets:
    random cells (some negative), a ring whose boundary slot holds period
    p - S (valid) and whose others are in-window, no owners yet."""
    a = {
        "cur": rng.integers(-3, 20, size=(d, w)).astype(np.int32),
        "slabs": rng.integers(-3, 40, size=(S, d, w)).astype(np.int32),
        "totals": rng.integers(-3, 200, size=(d, w)).astype(np.int32),
        "slab_period": np.array([period - S + ((j - period) % S)
                                 for j in range(S)], np.int64),
        "last_period": np.array(period, np.int64),
        "hh_owner": np.zeros(K, np.uint32),
        "hh_owner2": np.zeros(K, np.uint32),
        "hh_cur": rng.integers(-2, 30, size=K).astype(np.int32),
        "hh_slabs": rng.integers(-2, 3000, size=(S, K)).astype(np.int32),
        "hh_totals": rng.integers(-2, 3000, size=K).astype(np.int32),
        "hh_last": rng.integers(period - S, period + 1, size=K).astype(
            np.int64),
    }
    a["slab_period"][period % S] = period - S
    return a


def _own(arrays, h1, h2):
    K = arrays["hh_owner"].shape[0]
    arrays["hh_owner"][h1 & (K - 1)] = h1
    arrays["hh_owner2"][h1 & (K - 1)] = h2


def _steps(cfg_kw):
    """The JAX (h1, h2) step (jnp path, memoized per config by the JAX
    package) and the port's, with the step's geometry; ``tenants`` in
    ``cfg_kw`` adds the hierarchy (its table is the step's operand)."""
    kw = dict(cfg_kw)
    tenants = kw.pop("tenants", 0)
    jcfg, tcfg = (_cfg(M, **kw, **({"hierarchy": M.HierarchySpec(
        tenants=tenants, map_capacity=16)} if tenants else {}))
        for M in (R, T))
    jstep = jsk.build_steps(jcfg)[0]
    tstep = tsk.build_steps(tcfg)[0]
    _, sub_us, SW, S, _ = tsk.sketch_geometry(tcfg)
    return jstep, tstep, sub_us, S


def _run_both(cfg_kw, arrays, h1, h2, n, now_us):
    """One step of each package on the same state arrays; returns both
    packages' (allowed, remaining, est) and states as NumPy."""
    jstep, tstep, sub_us, S = _steps(cfg_kw)
    js = {k: jnp.asarray(v) for k, v in arrays.items()}
    js, jout = jstep(js, jnp.asarray(h1, jnp.uint32),
                     jnp.asarray(h2, jnp.uint32), jnp.asarray(n, jnp.int32),
                     jnp.int64(now_us))
    ts = convert.state_from_numpy(arrays, "cpu")
    tout = tstep(ts, torch.from_numpy(h1.astype(np.int64)),
                 torch.from_numpy(h2.astype(np.int64)),
                 torch.from_numpy(n.astype(np.int32)), now_us,
                 period=int(arrays["last_period"]))
    jst = {k: np.asarray(v) for k, v in js.items()}
    return ([np.asarray(x) for x in jout], [x.numpy() for x in tout], jst,
            convert.state_to_numpy(ts))


def _assert_same_step(got):
    jout, tout, jst, tst = got
    for name, x, y in zip(("allowed", "remaining", "est"), jout, tout):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert sorted(jst) == sorted(tst)
    for k in jst:
        assert jst[k].dtype == tst[k].dtype, k
        np.testing.assert_array_equal(jst[k], tst[k], err_msg=k)


STEP_KW = dict(limit=100, window=60.0, hh_slots=1024, depth=4, width=1024)


def test_owned_estimate_rounds_as_one_fma():
    """1,001 owned keys on a valid boundary slab: the port's estimates
    equal the JAX step's, which equal ``est_cms +
    fma(frac, f32(hh_b), f32(hh_t))`` — and the unfused sum differs on
    some of them, so the rounding is what is held."""
    rng = np.random.default_rng(11)
    cfg_kw = dict(STEP_KW, hh_slots=1 << 12)
    _, _, sub_us, S = _steps(cfg_kw)
    p = int(T0 * 1e6) // sub_us
    arrays = _arrays(rng, 1 << 12, S, 4, 1024, p)
    ids = rng.choice(1 << 40, size=1400, replace=False).astype(np.uint64)
    h1, h2 = _halves(ids)
    # Owned: the first key of every slot among the first 1,001 keys.
    for i in range(1001):
        _own(arrays, int(h1[i]), int(h2[i]))
    n = np.zeros(len(ids), np.int32)
    now_us = p * sub_us + 737_119
    got = _run_both(cfg_kw, arrays, h1, h2, n, now_us)
    _assert_same_step(got)
    K = 1 << 12
    sid = h1 & (K - 1)
    mine = arrays["hh_owner"][sid] == h1
    assert mine.sum() >= 800
    ts = convert.state_from_numpy(arrays, "cpu")
    bnd = tsk._boundary(ts, p, now_us, sub_us=sub_us, SW=S, S=S,
                        weighted=True)
    front = sc.window_front(ts["totals"], (torch.from_numpy(
        h1.astype(np.int64)), torch.from_numpy(h2.astype(np.int64))),
        boundary=bnd, hh=tsk._side(ts, p, S=S, weighted=True))
    frac = front[3]
    est_cms = front[6][1].numpy()
    hb = arrays["hh_slabs"][p % S][sid].astype(np.float32)
    ht = arrays["hh_totals"][sid].astype(np.float32)
    fused = sc.fma_f32(frac, torch.from_numpy(hb), torch.from_numpy(ht))
    want = est_cms + np.where(mine, np.maximum(fused.numpy(), 0.0), 0.0)
    np.testing.assert_array_equal(got[1][2], want)
    unfused = est_cms + np.where(
        mine, np.maximum(ht + np.float32(frac) * hb, 0.0), 0.0)
    assert (unfused != want)[mine].sum() > 0


def _contention_batch(rng, K: int):
    """Keys that all map to one slot (h1 = 5 + j*K), 3 requests each,
    two pairs of keys with equal mass so that h1 breaks the tie, and one
    key sharing h1 with another but not h2."""
    h1 = np.array([5 + j * K for j in range(1, 17)], np.uint32)
    h2 = rng.integers(0, 2 ** 32, size=16).astype(np.uint32) | 1
    h1 = np.concatenate([h1, h1[:1]])
    h2 = np.concatenate([h2, (h2[:1] + 2).astype(np.uint32)])
    return np.repeat(h1, 3), np.repeat(h2, 3)


@pytest.mark.parametrize("case", ["h1_zero", "padding_owns_its_slot",
                                  "one_slot_contention"])
@pytest.mark.parametrize("cu", [True, False])
def test_edge_batches(case, cu):
    rng = np.random.default_rng(len(case) + 10 * cu)
    K = 16
    cfg_kw = dict(STEP_KW, hh_slots=K, limit=20, cu=cu)
    _, _, sub_us, S = _steps(cfg_kw)
    p = int(T0 * 1e6) // sub_us
    arrays = _arrays(rng, K, S, 4, 1024, p)
    if case == "h1_zero":
        # h1 = 0 on a free slot 0: "mine", counted in cell 0, out of the
        # sketch, touching hh_last[0] (copied from the reference).
        h1 = np.array([0, 0, 7, 16, 0], np.uint32)
        h2 = np.array([9, 9, 3, 5, 9], np.uint32)
        n = np.array([2, 3, 1, 1, 4], np.int32)
    elif case == "padding_owns_its_slot":
        # The limiter pads with h64 = 0, n = 0; on the halves lane the
        # padding key's halves are split_hash(0).
        ph1, ph2 = split_hash(np.zeros(1, np.uint64), SEED)
        _own(arrays, int(ph1[0]), int(ph2[0]))
        ids = rng.integers(0, 1000, size=5).astype(np.uint64)
        h1, h2 = _halves(ids)
        h1 = np.concatenate([h1, np.repeat(ph1, 3)])
        h2 = np.concatenate([h2, np.repeat(ph2, 3)])
        n = np.array([1, 2, 3, 1, 2, 0, 0, 0], np.int32)
    else:
        h1, h2 = _contention_batch(rng, K)
        n = np.ones(len(h1), np.int32)
        n[::3] = 2
    got = _run_both(cfg_kw, arrays, h1, h2, n, p * sub_us + 123_457)
    _assert_same_step(got)
    tst = got[3]
    if case == "h1_zero":
        assert tst["hh_last"][0] == p
    if case == "one_slot_contention":
        slot = 5
        assert tst["hh_owner"][slot] != 0 and tst["hh_last"][slot] == p


def _hier_arrays(rng, tenants: int, h1, h2) -> dict:
    """A tenant table's device columns by hand: the keys (h1, h2) mapped
    round-robin to tenants 1..T-1 (sorted packed halves, PAD_KEY-padded),
    tight tenant limits (3-11) and a global one of 60, so that the
    cascade denies some of what the key scope admits."""
    from ratelimiter_tpu_torch.ops.policy_kernels import (
        PAD_KEY,
        pack_halves_host,
    )

    keys = np.unique(pack_halves_host(h1, h2))
    P = 16
    key = np.full(P, PAD_KEY, np.int64)
    tid = np.zeros(P, np.int64)
    key[:len(keys)] = keys
    tid[:len(keys)] = 1 + np.arange(len(keys)) % (tenants - 1)
    limit = rng.integers(3, 12, size=tenants + 1).astype(np.int64)
    limit[0] = 1 << 40
    limit[tenants] = 60
    return {"key": key, "tid": tid, "limit": limit,
            "weight": rng.integers(1, 4, size=tenants + 1).astype(np.int64)}


def _tail_trace_batches(rng, K: int, w: int):
    """Two batches over crafted slots (K = 16): slot 3 claimed by three
    keys sharing h1 (equal mass: all denied on a flat sketch of 50), slot
    5 by four keys of distinct h1 with equal mass, slot 7 owned by a key
    sending n = 0 twice, slot 9 owned and counted, slot 11 claimed by one
    key whose own cells are 0 (admitted, target 25); the second batch
    counts that key in its new cell, sends the slot-3 winner again and
    the n = 0 owner once more."""
    shared = np.uint32(3 + 16 * 100)
    h2s = rng.choice(1 << 31, size=3, replace=False).astype(np.uint32) | 1
    distinct = np.array([5 + 16 * j for j in (1, 2, 3, 4)], np.uint32)
    owner0, owner, promoted = (np.uint32(7 + 16 * 9), np.uint32(9 + 16 * 2),
                               np.uint32(11 + 16 * 5))
    h1 = np.array([shared] * 3 + list(distinct) + [owner0, owner0, owner,
                                                   owner, promoted],
                  np.uint32)
    h2 = np.concatenate([h2s, rng.integers(1, 1 << 31, size=4).astype(
        np.uint32) | 1, np.array([11, 11, 13, 13, 17], np.uint32)])
    n1 = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0, 2, 3, 25], np.int32)
    second = (np.array([promoted, owner0, shared, promoted], np.uint32),
              np.array([17, 11, h2s.max(), 17], np.uint32),
              np.array([5, 0, 1, 2], np.int32))
    return (h1, h2, n1), second


@pytest.mark.parametrize("tenants", [0, 4])
@pytest.mark.parametrize("cu", [True, False])
def test_side_table_step_trace_through_the_backs_tail(cu, tenants):
    """The side-table step as the backs run it now (the table's update as
    the back's tail: on the CPU the plain back, then hh_update_plain)
    against the JAX step, with and without tenants, over two batches of
    one period (``_tail_trace_batches``): candidates claiming one slot
    with equal mass and a shared h1 (the winners' largest h2 becomes
    owner2), candidates of distinct h1 and equal mass on another (the
    largest h1 wins), owned keys sending n = 0 (slot touched, nothing
    counted), an owned key counted, and a key promoted by the first
    batch and counted in its cell by the second. Every result and every
    state array, hh_* and tn_* included, at tolerance 0."""
    rng = np.random.default_rng(41 + 2 * cu + tenants)
    K, d, w = 16, 4, 1024
    cfg_kw = dict(STEP_KW, hh_slots=K, limit=40, cu=cu)
    if tenants:
        cfg_kw["tenants"] = tenants
    jstep, tstep, sub_us, S = _steps(cfg_kw)
    p = int(T0 * 1e6) // sub_us
    arrays = _arrays(rng, K, S, d, w, p)
    (h1, h2, n), second = _tail_trace_batches(rng, K, w)
    # A flat sketch of 50 (every claim of one slot has equal mass), the
    # boundary and the side table's boundary column empty, the owned and
    # promoted keys' own cells 0 (they are admitted), no owners but two.
    arrays["totals"][:] = 50
    arrays["slabs"][p % S] = 0
    arrays["hh_slabs"][p % S] = 0
    arrays["hh_totals"][:] = 0
    arrays["hh_totals"][9] = 3
    for k in (9, 10, 11):
        cols = (int(h1[k]) + np.arange(d) * int(h2[k])) % (1 << 32) % w
        arrays["totals"][np.arange(d), cols] = 0
    _own(arrays, int(h1[7]), int(h2[7]))
    _own(arrays, int(h1[9]), int(h2[9]))
    hier = None
    if tenants:
        T = tenants
        arrays.update(tn_cur=np.zeros(T + 1, np.int32),
                      tn_slabs=rng.integers(0, 3, size=(S, T + 1)).astype(
                          np.int32),
                      tn_totals=rng.integers(0, 5, size=T + 1).astype(
                          np.int32))
        # The owned keys and slot 5's claimants in tenants; the rest,
        # the promoted key included, in the default tenant.
        mapped = [3, 4, 5, 6, 9]
        hier = _hier_arrays(rng, T, h1[mapped], h2[mapped])
    js = {k: jnp.asarray(v) for k, v in arrays.items()}
    ts = convert.state_from_numpy(arrays, "cpu")
    jh = None if hier is None else {k: jnp.asarray(v)
                                    for k, v in hier.items()}
    th = None if hier is None else tsk.hier_tensors(hier, "cpu")
    for step, (b1, b2, bn) in enumerate(((h1, h2, n), second)):
        now_us = p * sub_us + 100_000 + 200_000 * step
        js, jout = jstep(js, jnp.asarray(b1, jnp.uint32),
                         jnp.asarray(b2, jnp.uint32),
                         jnp.asarray(bn, jnp.int32), jnp.int64(now_us),
                         None, jh)
        tout = tstep(ts, torch.from_numpy(b1.astype(np.int64)),
                     torch.from_numpy(b2.astype(np.int64)),
                     torch.from_numpy(bn), now_us, None, th, period=p)
        _assert_same_step(([np.asarray(x) for x in jout],
                           [x.numpy() for x in tout],
                           {k: np.asarray(v) for k, v in js.items()},
                           convert.state_to_numpy(ts)))
        tst = convert.state_to_numpy(ts)
        if step == 0:
            # The ties resolved as the trace intends, and slot 11 taken.
            assert tst["hh_owner"][3] == h1[0]
            assert tst["hh_owner2"][3] == h2[:3].max()
            assert tst["hh_owner"][5] == h1[3:7].max()
            assert tst["hh_owner"][11] == h1[11]
            assert (tst["hh_last"][[3, 5, 7, 9, 11]] == p).all()
            assert tst["hh_cur"][7] == arrays["hh_cur"][7]
    # The promoted key's second-batch requests count in its cell.
    assert tst["hh_cur"][11] == arrays["hh_cur"][11] + 7


def test_window_reset_plain_matches_jax_reset_of_several_keys():
    """``window_reset_plain`` (the reset kernel's plain version) on a
    seeded batch of six keys, two of them sharing a column and one owned
    by the side table, against the JAX package's ``_sketch_reset``:
    sliding (a weighted boundary) and fixed, with and without a side
    table; every state array at tolerance 0, and the shared column
    losing both keys' estimates, each read before either was written."""
    for algo in ("SLIDING_WINDOW", "FIXED_WINDOW"):
        for K in (16, 0):
            rng = np.random.default_rng(len(algo) + K)
            cfg_kw = dict(STEP_KW, hh_slots=K, algo=algo)
            jcfg, tcfg = _cfg(R, **cfg_kw), _cfg(T, **cfg_kw)
            jreset = jsk.build_steps(jcfg)[1]
            _, sub_us, SW, S, _ = tsk.sketch_geometry(tcfg)
            p = int(T0 * 1e6) // sub_us
            arrays = _arrays(rng, max(K, 16), S, 4, 1024, p)
            if not K:
                arrays = {k: v for k, v in arrays.items()
                          if not k.startswith("hh_")}
            ids = rng.integers(1, 1 << 40, size=6).astype(np.uint64)
            h1, h2 = _halves(ids)
            h1[1] = h1[0]                  # row 0: one column, two keys
            if K:
                _own(arrays, int(h1[4]), int(h2[4]))
            now_us = p * sub_us + 412_345
            js = {k: jnp.asarray(v) for k, v in arrays.items()}
            js = jreset(js, jnp.asarray(h1, jnp.uint32),
                        jnp.asarray(h2, jnp.uint32), jnp.int64(now_us))
            ts = convert.state_from_numpy(arrays, "cpu")
            weighted = algo == "SLIDING_WINDOW"
            bnd = tsk._boundary(ts, p, now_us, sub_us=sub_us, SW=SW, S=S,
                                weighted=weighted)
            sc.window_reset_plain(
                ts["totals"], ts["cur"], torch.from_numpy(
                    h1.astype(np.int64)),
                torch.from_numpy(h2.astype(np.int64)), boundary=bnd,
                hh=tsk._side(ts, p, S=S, weighted=weighted),
                hh_cur=ts.get("hh_cur"))
            tst = convert.state_to_numpy(ts)
            for k, v in js.items():
                np.testing.assert_array_equal(np.asarray(v), tst[k],
                                              err_msg=f"{algo} K={K} {k}")
            c0 = int(h1[0]) % 1024
            assert tst["totals"][0, c0] < arrays["totals"][0, c0]
            if K:
                sid = int(h1[4]) & (K - 1)
                assert tst["hh_totals"][sid] != arrays["hh_totals"][sid]


def test_limiter_padding_rows_go_through_the_side_table():
    """The limiter pads a batch of 5 to 8 rows with h64 = 0, n = 0 (both
    packages): with the padding key owning its slot, the padding rows
    are owned rows of the step (they touch the slot's idle clock)."""
    lj, lt = _pair(limit=20, hh_slots=16, depth=4, width=256)
    _, sub_us, _, S, _ = tsk.sketch_geometry(lt.config)
    p = int(T0 * 1e6) // sub_us
    arrays = _arrays(np.random.default_rng(6), 16, S, 4, 256, p)
    arrays["hh_last"][:] = p - 2
    ph1, ph2 = split_hash(np.zeros(1, np.uint64), SEED)
    _own(arrays, int(ph1[0]), int(ph2[0]))
    lj._restore_loaded(dict(arrays), {"host_period": p})
    lt.restore_state(dict(arrays), {"host_period": p})
    h64 = np.random.default_rng(7).integers(
        1, 2 ** 63, size=5).astype(np.uint64)
    _same(lj.allow_hashed(h64), lt.allow_hashed(h64))
    _same_state(lj, lt)
    assert lt.capture_state()[1]["hh_last"][int(ph1[0]) & 15] == p
    lj.close()
    lt.close()


def test_reset_of_an_owned_key_subtracts_each_part_from_its_table():
    """The reset subtracts the sketch's part of an owned key's estimate
    from the sketch and its cell's part from the cell (each floored),
    never the sum from the sketch."""
    p = Pair(limit=10)
    try:
        for _ in range(12):
            p.allow("hot")
        p.advance(2.4)
        for _ in range(3):
            p.allow("hot")
        p.advance(4.1)       # a valid, partly weighted boundary
        before = p.t.capture_state()[1]
        p.reset("hot")
        p.check()
        after = p.t.capture_state()[1]
        assert (after["hh_totals"] != before["hh_totals"]).any()
        assert (after["totals"] != before["totals"]).any()
        assert p.allow("hot").allowed
        p.check()
    finally:
        p.close()


# -------------------------------------------------------- live updates


def test_update_limit_moves_the_promotion_threshold():
    """The threshold is max(1, limit * fraction): after the limit drops
    from 40 to 8, a key at 5 requests promotes (threshold 4, was 20)."""
    p = Pair(limit=40)
    try:
        for _ in range(5):
            p.allow("warm")
        assert p.owners() == 0
        p.j.update_limit(8)
        p.t.update_limit(8)
        p.allow("warm")
        assert p.owners() == 1
        p.check()
        p.j.update_limit(200)
        p.t.update_limit(200)
        for i in range(20):
            p.allow(f"w{i % 3}")
        p.check()
    finally:
        p.close()


def test_update_window_migrates_the_side_table():
    """update_window 6 -> 4.5 -> 12 s with owned, idle (finite
    ``hh_last``) and never-touched (``_NEVER``) slots; every state array
    after each update and every later decision bit-identical."""
    p = Pair(limit=10, hh_slots=16)
    try:
        for step in range(10):
            for key in ("a", "b", "c"):
                p.allow(key, 2)
            p.advance(0.7)
        last = p.t.capture_state()[1]["hh_last"]
        assert (last == tsk._NEVER).any() and (last != tsk._NEVER).any()
        for window in (4.5, 12.0):
            p.j.update_window(window)
            p.t.update_window(window)
            p.check()
            for step in range(6):
                for key in ("a", "b", "d"):
                    p.allow(key)
                p.advance(1.3)
            p.check()
    finally:
        p.close()


def test_migrate_window_alone_on_seeded_side_tables():
    """``_migrate_window`` of the port against the JAX one on a seeded
    ring with a side table whose ``hh_last`` mixes ``_NEVER`` and finite
    periods, shrinking and growing the window."""
    rng = np.random.default_rng(5)
    K, d, w = 32, 2, 64
    for old_w, new_w, now_s in ((6.0, 4.5, 3.3), (6.0, 13.0, 9.1),
                                (12.0, 6.0, 40.7)):
        jo, jn = _cfg(R, window=old_w, hh_slots=K), _cfg(R, window=new_w,
                                                         hh_slots=K)
        to, tn = _cfg(T, window=old_w, hh_slots=K), _cfg(T, window=new_w,
                                                         hh_slots=K)
        _, sub_o, _, So, _ = tsk.sketch_geometry(to)
        now_us = int((T0 + now_s) * 1e6)
        p = now_us // sub_o
        arrays = _arrays(rng, K, So, d, w, p)
        arrays["hh_last"][::3] = tsk._NEVER
        arrays["hh_owner"][1::2] = rng.integers(1, 2 ** 32, size=K // 2)
        arrays["hh_owner2"][1::2] = rng.integers(1, 2 ** 32, size=K // 2)
        js = jsk.build_migrate(jo, jn)({k: jnp.asarray(v)
                                        for k, v in arrays.items()},
                                       jnp.int64(now_us))
        ts = tsk.build_migrate(to, tn)(convert.state_from_numpy(arrays,
                                                                "cpu"),
                                       now_us)
        tnp = convert.state_to_numpy(ts)
        for k, v in js.items():
            np.testing.assert_array_equal(np.asarray(v), tnp[k], err_msg=k)
        assert (tnp["hh_last"] == tsk._NEVER).sum() >= K // 3


# ---------------------------------------------------- state and stats


def test_snapshot_without_hh_owner2_restores_as_zeros_in_both(tmp_path):
    """A JAX snapshot from before ``hh_owner2``: both packages restore the
    column as zeros and decide alike."""
    p = Pair(limit=10)
    try:
        for _ in range(12):
            p.allow("hot")
        path = str(tmp_path / "s.npz")
        p.j.save(path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != "hh_owner2"}
        old = str(tmp_path / "old.npz")
        np.savez(old, **arrays)
        q = Pair(limit=10)
        try:
            q.j.restore(old)
            q.t.restore(old)
            q.check()
            assert not q.t.capture_state()[1]["hh_owner2"].any()
            assert q.t.capture_state()[1]["hh_owner"].any()
            assert not q.allow("hot").allowed
            q.check()
        finally:
            q.close()
    finally:
        p.close()


def test_snapshot_bytes_of_the_owner_columns_match_jax(tmp_path):
    p = Pair(limit=10)
    try:
        for key in ("a", "b", "hot", "hot", "hot", "hot", "hot", "hot"):
            p.allow(key)
        p.j.save(str(tmp_path / "j.npz"))
        p.t.save(str(tmp_path / "t.npz"))
        with np.load(tmp_path / "j.npz") as zj, \
                np.load(tmp_path / "t.npz") as zt:
            for k in sc.HH_KEYS:
                assert zj[k].dtype == zt[k].dtype, k
                assert zj[k].tobytes() == zt[k].tobytes(), k
    finally:
        p.close()


def test_consumer_stats_equal_jax():
    p = Pair(limit=10, hh_slots=16)
    try:
        assert p.j.consumer_stats() == p.t.consumer_stats()
        assert p.t.has_hh and p.j.has_hh
        for i, key in enumerate(["a"] * 9 + ["b"] * 7 + ["c"] * 6):
            p.allow(key)
        for k in (0, 1, 2, 10):
            assert p.j.consumer_stats(k) == p.t.consumer_stats(k)
        st = p.t.consumer_stats(2)
        assert st["slots"] == 16 and st["occupied"] >= 2
        assert len(st["top"]) == 2 and st["tracked_mass"] > 0
        # The side table counts in memory_bytes (int64 owners here).
        off = SketchLimiter(_cfg(T, hh_slots=0), T.ManualClock(T0),
                            device="cpu")
        assert p.t.memory_bytes() - off.memory_bytes() == 16 * (
            8 + 8 + 4 + 4 + 8) + 6 * 16 * 4
        assert not off.has_hh
        assert off.consumer_stats() == {"slots": 0, "occupied": 0, "top": []}
        off.close()
    finally:
        p.close()


def test_convert_round_trip_of_the_side_table():
    rng = np.random.default_rng(2)
    arrays = _arrays(rng, 64, 6, 2, 64, 1000)
    arrays["hh_owner"][:] = rng.integers(0, 2 ** 32, size=64)
    arrays["hh_owner"][0] = 2 ** 32 - 1
    arrays["hh_owner2"][:] = rng.integers(0, 2 ** 32, size=64)
    state = convert.state_from_numpy(arrays, "cpu")
    assert state["hh_owner"].dtype == torch.int64
    assert int(state["hh_owner"][0]) == 2 ** 32 - 1
    back = convert.state_to_numpy(state)
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    del arrays["hh_owner2"]
    assert not convert.state_from_numpy(arrays, "cpu")["hh_owner2"].any()
    arrays["hh_owner"] = arrays["hh_owner"].astype(np.int64)
    with pytest.raises(T.InvalidConfigError, match="hh_owner"):
        convert.state_from_numpy(arrays, "cpu")
    # A side table restores only into a limiter that has one.
    lim = SketchLimiter(_cfg(T, hh_slots=0), T.ManualClock(T0), device="cpu")
    with pytest.raises(T.InvalidConfigError, match="do not fit"):
        lim.restore_state(convert.state_to_numpy(state),
                          {"host_period": 1000})
    lim.close()


def test_bucket_ignores_hh_slots_as_jax_does():
    from ratelimiter_tpu.algorithms.sketch import (
        SketchTokenBucketLimiter as JaxBucket,
    )
    from ratelimiter_tpu_torch.algorithms.sketch import (
        SketchTokenBucketLimiter,
    )

    kw = dict(algo="TOKEN_BUCKET", limit=10, window=6.0, hh_slots=16)
    lj = JaxBucket(_cfg(R, **kw), R.ManualClock(T0))
    lt = SketchTokenBucketLimiter(_cfg(T, **kw), T.ManualClock(T0),
                                  device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(6):
        ids = (rng.zipf(1.3, size=32) % 20).astype(np.uint64)
        _same(lj.allow_ids(ids), lt.allow_ids(ids))
        lj.clock.advance(0.3)
        lt.clock.advance(0.3)
    _same_state(lj, lt)
    assert not any(k.startswith("hh_") for k in lt.capture_state()[1])
    assert lj.consumer_stats() == lt.consumer_stats() == {
        "slots": 0, "occupied": 0, "top": []}
    assert not lt.has_hh
    lj.close()
    lt.close()


# -------------------------------------------------------------- the door


def test_hh_slots_flag_builds_the_side_table_config():
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_config,
        parse_args,
    )

    cfg = build_config(parse_args(["--hh-slots", "256"]))
    assert cfg.sketch.hh_slots == 256
    assert cfg.sketch.hh_promote_fraction == 0.5
    assert build_config(parse_args([])).sketch.hh_slots == 0


def _gauges(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith(("rate_limiter_top_consumer_mass{",
                            "rate_limiter_hh_tracked_consumers{")):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_door_frames_and_consumer_gauges_against_an_in_process_limiter():
    """Frames to a server over a side-table limiter answer as an in-process
    limiter decides them; METRICS shows both gauges (the binary's
    default stack, MetricsDecorator, registers them in the door's
    registry), rank 1-5, with the served limiter's ``consumer_stats``,
    and zeroes the ranks the list no longer reaches after the hot keys
    idle out; the hook goes with the decorator."""
    from ratelimiter_tpu_torch.observability.decorators import (
        MetricsDecorator,
    )
    from ratelimiter_tpu_torch.observability.metrics import Registry

    cfg = _cfg(T, limit=10, hh_slots=16)
    served = SketchLimiter(cfg, T.ManualClock(T0), device="cpu")
    mirror = SketchLimiter(cfg, T.ManualClock(T0), device="cpu")
    registry = Registry()
    rng = np.random.default_rng(8)

    async def roundtrip(reader, writer, frame):
        writer.write(frame)
        await writer.drain()
        length, type_, rid = tp.parse_header(
            await reader.readexactly(tp.HEADER_SIZE))
        return type_, await reader.readexactly(length - 9)

    stack = MetricsDecorator(served, registry=registry)

    async def main():
        srv = await run_server(stack, registry=registry)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            for step in range(6):
                ids = (rng.zipf(1.3, size=48) % 12).astype(np.uint64)
                t, body = await roundtrip(reader, writer,
                                          tp.encode_allow_hashed(step, ids))
                got = tp.parse_result_hashed(body)
                want = mirror.allow_ids(ids)
                for f in RESULT_FIELDS:
                    np.testing.assert_array_equal(getattr(got, f),
                                                  getattr(want, f))
            t, _ = await roundtrip(reader, writer, tp.encode_reset(50, "k"))
            mirror.reset("k")
            t, body = await roundtrip(reader, writer,
                                      tp.encode_allow_n(51, "k", 2))
            assert tp.parse_result(body) == mirror.allow_n("k", 2)
            t, body = await roundtrip(reader, writer,
                                      tp.encode_simple(tp.T_METRICS, 52))
            hot = _gauges(tp.parse_metrics(body))
            served.clock.advance(13.0)
            mirror.clock.advance(13.0)
            ids = np.arange(100, 104, dtype=np.uint64)
            await roundtrip(reader, writer, tp.encode_allow_hashed(53, ids))
            mirror.allow_ids(ids)
            t, body = await roundtrip(reader, writer,
                                      tp.encode_simple(tp.T_METRICS, 54))
            cold = _gauges(tp.parse_metrics(body))
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()
        return hot, cold

    hot, cold = asyncio.run(main())
    assert registry._collect_hooks == [stack._collect_consumers]
    _same_state(mirror, served)
    tracked = 'rate_limiter_hh_tracked_consumers{shard="0",slice="0"}'
    assert hot[tracked] >= 2
    ranks = [hot[f'rate_limiter_top_consumer_mass{{rank="{r}",shard="0",'
                 f'slice="0"}}'] for r in range(1, 6)]
    assert ranks[0] > 0 and ranks == sorted(ranks, reverse=True)
    assert cold[tracked] == 0
    assert all(v == 0 for k, v in cold.items() if "top_consumer" in k)
    assert served.consumer_stats() == mirror.consumer_stats()
    stack.close()
    assert registry._collect_hooks == []
    mirror.close()


@pytest.mark.parametrize("cu", [True, False])
def test_door_with_hh_slots_matches_a_replay(cu):
    """chip_smoke.py's door check at a small size on the CPU with the side
    table: every frame bit-identical to a replay of the recorded windows,
    the final state (hh_* included) too, and METRICS shows both gauges
    equal to the served limiter's consumer_stats."""
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=20,
                   window=2.0, sketch=T.SketchParams(
                       depth=4, width=1024, sub_windows=4, hh_slots=16,
                       conservative_update=cu))
    out = chip_smoke.check_door(
        None, cfg, "hh", device="cpu", conns=2, frames=16, n_ids=64,
        n_keys=16, server_kw=dict(max_batch=256))
    assert out["dispatches"] < out["frames"] == 32
    assert out["hh_tracked"] >= 1 and out["hh_top_mass"][0] > 0


def test_window_admit_takes_h2_and_n_from_the_cascade():
    """With the cascade, ``window_admit``'s tail reads the batch's h2 and
    n from the cascade's operands: given through ``casc`` alone or as
    the same tensors by keyword, the same outputs, side table and scope
    counters; other tensors are refused, not quietly replaced."""
    rng = np.random.default_rng(23)
    B, K = 96, 16
    h1 = torch.from_numpy(rng.integers(1, 1 << 40, size=B))
    h2 = torch.from_numpy(rng.integers(1, 1 << 40, size=B))
    n = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32))
    est = torch.from_numpy(rng.integers(0, 60, size=B).astype(np.float32))
    n_f, avail = n.float(), torch.full((B,), 50.0)
    mine = h1 % 3 == 0
    casc = chip_smoke.side_cascade(torch, rng, h1, h2, n)
    hh = {"hh_owner": torch.where(torch.arange(K) % 2 == 0, 7, 0),
          "hh_owner2": torch.zeros(K, dtype=torch.int64),
          "hh_cur": torch.zeros(K, dtype=torch.int32),
          "hh_totals": torch.zeros(K, dtype=torch.int32),
          "hh_last": torch.zeros(K, dtype=torch.int64)}

    def run(**kw):
        st = {k: v.clone() for k, v in hh.items()}
        c = casc._replace(counts=casc.counts.clone(), cur=casc.cur.clone())
        out = sc.window_admit(h1, est, n_f, avail, 4, mine, c,
                              hh=sc.SideUpdate(st, 10.0, 5), **kw)
        return [*out, *st.values(), c.counts, c.cur]

    for a, b in zip(run(), run(h2=casc.h2, n=casc.n)):
        assert torch.equal(a, b)
    for kw in (dict(h2=h2.clone()), dict(n=n.clone()),
               dict(h2=h2.clone(), n=n)):
        with pytest.raises(ValueError, match="the cascade's"):
            run(**kw)
