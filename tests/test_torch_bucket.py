"""The port's sketched token bucket (on the CPU) against the JAX package's.

Inputs are made with NumPy from a seed and fed to both packages; every
output and every state array must be BIT-identical (no tolerance). The JAX
side runs as its own parity suite runs it (tests/test_pallas_parity.py):
with the Pallas kernels in interpret mode and with the jnp reference
path, jitted. Covered: int64 admission, the overflow gates, the exact
decay, both table kernels' plain versions (the 2^61 clamp and the decay
of untouched cells included), result assembly, the step, the limiter with
overrides and resets, ``debt_slab_stats``, state carried across packages
both ways, the factory's routing, and the wire bytes and server frames.

Geometry: d=3, w=128, limit 7 per 6 s, so the refill rate is 7/6
micro-tokens per microsecond and the decay remainder is non-trivial.
"""

from __future__ import annotations

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.algorithms.sketch import (
    SketchTokenBucketLimiter as JaxBucket,
)
from ratelimiter_tpu.core.types import BatchResult as JaxBatchResult
from ratelimiter_tpu.ops import bucket_kernels as jbk
from ratelimiter_tpu.ops import dense_kernels as jdk
from ratelimiter_tpu.ops import pallas_sketch as jps
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu.ops.segment import admit as jax_admit
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu_torch.algorithms.sketch import (
    SketchLimiter,
    SketchTokenBucketLimiter,
)
from ratelimiter_tpu_torch.ops import bucket_cuda as bc
from ratelimiter_tpu_torch.ops import bucket_kernels as tbk
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk
from ratelimiter_tpu_torch.ops.segment import admit
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.server import run_server

T0 = 1_000_000.0
D, W, B = 3, 128, 48
CAP = 1 << 61
NUM, DEN = 7, 6          # limit 7 per 6 s: 7e6 micro-tokens / 6e6 us
STATE_KEYS = ("debt", "acc", "rem", "last")


def _cfg(M, *, kernels="auto", limit=7, window=6.0, **kw):
    return M.Config(algorithm=M.Algorithm.TOKEN_BUCKET, limit=limit,
                    window=window,
                    sketch=M.SketchParams(depth=D, width=W, kernels=kernels),
                    **kw)


def _pair(kernels="jnp", **kw):
    return (JaxBucket(_cfg(R, kernels=kernels, **kw), R.ManualClock(T0)),
            SketchTokenBucketLimiter(_cfg(T, **kw), T.ManualClock(T0),
                                     device="cpu"))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _th(h):
    return torch.from_numpy(h.astype(np.int64))


def _hashes(rng, b=B):
    h1 = rng.integers(0, 2 ** 32, size=b, dtype=np.uint64).astype(np.uint32)
    h2 = (rng.integers(0, 2 ** 32, size=b, dtype=np.uint64)
          | 1).astype(np.uint32)
    return h1, h2


def _debt(rng, *, near_cap: bool = False):
    """Zeros, random debts and (optionally) cells within 10^6 of 2^61."""
    debt = rng.integers(0, 40_000_000, size=(D, W)).astype(np.int64)
    debt[rng.random((D, W)) < 0.3] = 0
    if near_cap:
        hot = rng.random((D, W)) < 0.25
        debt[hot] = CAP - rng.integers(0, 1_000_000, size=int(hot.sum()))
    return debt


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
        x = np.asarray(sj[k])
        assert x.dtype == st[k].dtype and x.shape == st[k].shape, k
        np.testing.assert_array_equal(x, st[k], err_msg=k)


# ------------------------------------------------------------- admission


def _admit_both(sid, n, avail, iters=4):
    a, s, c = admit(torch.from_numpy(sid.astype(np.int64)), _t(n), _t(avail),
                    iters)
    ja, js, jc = jax_admit(jnp.asarray(sid.astype(np.int32)), jnp.asarray(n),
                           jnp.asarray(avail), iters)
    assert s.dtype == c.dtype == torch.int64
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    return a.numpy(), s.numpy()


@pytest.mark.parametrize("seed", range(3))
def test_admit_int64_micro_units_matches_jax(seed):
    """Mixed n in micro-units with odd remainders, many past 2^24 and not
    representable in f32, against the JAX package's integer branch."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, 30, size=256)
    n = (rng.integers(0, 30, size=256) * 1_000_000
         + rng.integers(0, 2, size=256)).astype(np.int64)
    avail = rng.integers(0, 150_000_001, size=30).astype(np.int64)[sid]
    allowed, _ = _admit_both(sid, n, avail)
    assert allowed.any() and not allowed.all()
    assert (n.astype(np.float32).astype(np.int64) != n).any()


def test_admit_keeps_units_f32_cannot_hold():
    """n = k*10^6 + 1 and avail = 3*(2^24 + 1): an f32 ``seen`` would round
    while ``allowed`` still agreed; the int64 branch is exact."""
    k = np.array([1, 2, 3, 4, 5, 6], np.int64)
    n = k * 1_000_000 + 1
    sid = np.zeros(n.shape[0], np.int64)
    avail = np.full(n.shape[0], 3 * ((1 << 24) + 1), np.int64)
    _, seen = _admit_both(sid, n, avail)
    assert (seen.astype(np.float32).astype(np.int64) != seen).any()


# ----------------------------------------------------------------- gates


@pytest.mark.parametrize("limit,window_us", [
    (7, 6_000_000), (20, 10_000_000), (100, 60_000_000), (1, 1_000),
    (4_398_046, 1_000), (3, 86_400 * 1_000_000)])
def test_check_gate_values_accepts_as_jax(limit, window_us):
    assert (tbk.check_gate_values(limit, window_us)
            == jdk.check_gate_values(limit, window_us))


@pytest.mark.parametrize("limit,window_us", [
    (4_398_047, 1_000_000),                      # micro-unit accounting
    (4_000_000, 365 * 86_400 * 1_000_000),       # token math
    (10 ** 6, 10 ** 13)])                        # both
def test_check_gate_values_raises_as_jax(limit, window_us):
    with pytest.raises(R.InvalidConfigError) as jerr:
        jdk.check_gate_values(limit, window_us)
    with pytest.raises(T.InvalidConfigError) as terr:
        tbk.check_gate_values(limit, window_us)
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------- decay


@pytest.mark.parametrize("last,rem,now,num,den", [
    (0, 0, 1_000_000_000_000, NUM, DEN),             # first step
    (10 ** 12, 2, 10 ** 12 + 123_457, 5, 3),          # remainder carries
    (10 ** 12, 5, 10 ** 12 + 1, NUM, DEN),            # one microsecond
    (10 ** 12, 4, 10 ** 12 - 777, NUM, DEN),          # clock stepped back
    (0, 3, 365 * 86_400 * 10 ** 6 * 30, 9_999_991, 7),  # idle for years
    (0, 1, 1 << 62, 1, 3),                            # quotient past the cap
])
def test_decay_matches_jax(last, rem, now, num, den):
    state = {"last": last, "rem": rem}
    got = tbk._decay(state, now, rate_num=num, rate_den=den)
    want = jax.jit(lambda st, t: jbk._decay(st, t, rate_num=num,
                                            rate_den=den))(
        {"last": jnp.int64(last), "rem": jnp.int64(rem)}, jnp.int64(now))
    assert got == (int(want[0]), int(want[1]))
    assert all(isinstance(x, int) for x in got)


def test_decay_clamps_the_quotient_after_the_remainder():
    """The e_q clamp must come after ``acc``: the remainder is the
    unclamped quotient's (``bucket_kernels.py:109-114``)."""
    now = 9 * 10 ** 18 + 5          # now % 6 == 5, now // 6 > CAP // 7
    decay, rem = tbk._decay({"last": 0, "rem": 0}, now, rate_num=7,
                            rate_den=6)
    assert decay == (CAP // 7) * 7 + 35 // 6
    assert rem == 35 % 6


# --------------------------------------------------------------- kernels


_jit_est = jax.jit(jps.bucket_estimate)
_jit_upd = jax.jit(jps.bucket_update)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("decay", [0, 3_333_337, 1 << 62])
def test_bucket_estimate_plain_matches_pallas_and_jnp(seed, decay):
    rng = np.random.default_rng(seed)
    debt = _debt(rng, near_cap=seed == 2)
    h1, h2 = _hashes(rng)
    got = bc.bucket_estimate_plain(_t(debt), decay, _th(h1),
                                   _th(h2)).numpy()
    want = np.asarray(_jit_est(jnp.asarray(debt), jnp.int64(decay),
                               jnp.asarray(h1), jnp.asarray(h2)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    # The jnp reference: decay the slab, gather, min over rows.
    cols = np.asarray(jax.jit(lambda a, b: jbk._columns(a, b, D, W))(
        jnp.asarray(h1), jnp.asarray(h2)))
    dec = np.maximum(0, debt - decay)
    np.testing.assert_array_equal(
        got, np.min([dec[r][cols[:, r]] for r in range(D)], axis=0))
    if decay > CAP:
        assert not got.any()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("decay", [0, 3_333_337, 1 << 62])
def test_bucket_update_plain_matches_pallas(seed, decay):
    """Zeros, random debts and cells near 2^61; repeated keys; denied
    requests consuming 0; every cell decays, touched or not."""
    rng = np.random.default_rng(seed + 10)
    debt = _debt(rng, near_cap=True)
    acc = _debt(rng, near_cap=seed == 1)
    h1, h2 = _hashes(rng)
    h1[: B // 4] = h1[B // 4: B // 2]          # colliding keys add up
    h2[: B // 4] = h2[B // 4: B // 2]
    consumed = np.where(rng.random(B) < 0.7,
                        rng.integers(1, 3_000_000, size=B), 0).astype(np.int64)
    consumed[:4] = (1 << 42) - 1                 # the largest admissible
    cols = np.asarray(jax.jit(lambda a, b: jbk._columns(a, b, D, W))(
        jnp.asarray(h1[:4]), jnp.asarray(h2[:4])))
    for r in range(D):                           # they land near the cap
        debt[r, cols[:, r]] = CAP - 10
        acc[r, cols[:, r]] = CAP - 10
    d, a = _t(debt.copy()), _t(acc.copy())
    bc.bucket_update(d, a, decay, _th(h1), _th(h2), _t(consumed))
    jd, ja = _jit_upd(jnp.asarray(debt), jnp.asarray(acc), jnp.int64(decay),
                      jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(consumed))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert (a.numpy() == CAP).any()
    assert (d.numpy() == CAP).any() == (decay < CAP)
    if 0 < decay < CAP:
        # Untouched cells decayed too (the bucket's twin of ROADMAP §C).
        assert ((d.numpy() < debt) & (a.numpy() == acc)).any()


def test_bucket_wrappers_check_operands():
    rng = np.random.default_rng(5)
    debt = _t(_debt(rng))
    h1, h2 = (_th(h) for h in _hashes(rng))
    with pytest.raises(TypeError):
        bc.bucket_front(debt.to(torch.int32), 0, (h1, h2))
    with pytest.raises(ValueError, match="decay"):
        bc.bucket_front(debt, -1, (h1, h2))
    with pytest.raises(ValueError, match="contiguous"):
        bc.bucket_update(debt, debt.clone(), 0, h1, h2,
                         torch.zeros(2 * B, dtype=torch.int64)[::2])
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bc.bucket_front(torch.empty((D, W), dtype=torch.int64, device=meta),
                        0, (torch.empty(B, dtype=torch.int64, device=meta),
                            torch.empty(B, dtype=torch.int64, device=meta)))
    bc.reset_launch_counts()
    bc.bucket_front(debt, 0, (h1, h2))
    bc.bucket_update(debt, debt.clone(), 0, h1, h2,
                     torch.zeros(B, dtype=torch.int64))
    units = torch.full((B,), 1_000_000, dtype=torch.int64)
    bc.bucket_admit(h1, units, units, 4, NUM, DEN)
    assert bc.launch_counts() == {"bucket_estimate": 0, "bucket_update": 0,
                                  "admit": 0, "admit [cascade]": 0}


# -------------------------------------------------------- result assembly


@pytest.mark.parametrize("now_us,window_us", [
    (1_700_000_123_456_789, 10_000_000), (6_000_000, 6_000_000),
    (987_654_321, 1_000)])
def test_finish_bucket_and_pack_wire_match_jax(now_us, window_us):
    rng = np.random.default_rng(now_us % 1000)
    n = 4096
    allowed = rng.random(n) < 0.5
    remaining = rng.integers(0, 100, size=n).astype(np.int64)
    retry_us = np.where(allowed, 0, rng.integers(1, 10 ** 9, size=n))
    # A value whose quotient and reciprocal product differ in f64: the
    # JAX package (XLA) computes the product, and so must the port.
    retry_us[-1] = 19
    assert 19 / 1e6 != 19 * (1 / 1e6)
    allowed[-1] = False
    outs = tbk.finish_bucket(_t(allowed), _t(remaining), _t(retry_us),
                             now_us, window_us)
    jouts = jbk.finish_bucket(jnp.asarray(allowed), jnp.asarray(remaining),
                              jnp.asarray(retry_us), jnp.int64(now_us),
                              jnp.int64(window_us))
    for o, j in zip(outs, jouts):
        assert o.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))
    assert outs[2][-1] == 19 * (1 / 1e6)
    bits, words = tsk.pack_wire(*outs)
    jbits, jwords = jsk.pack_wire(*jouts)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))


# ------------------------------------------------------------------ step


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
def test_bucket_step_matches_jax(kernels):
    """Eight steps of the raw-id step with an override table that some ids
    hit, the clock moving unevenly and once back, against the JAX step
    jitted as the JAX limiter runs it."""
    from ratelimiter_tpu.ops.hashing import split_hash, splitmix64
    from ratelimiter_tpu_torch.ops.policy_kernels import pack_halves_host

    rng = np.random.default_rng(7)
    jcfg, tcfg = _cfg(R, kernels=kernels), _cfg(T)
    jstep = jbk.build_hashed_step(jcfg, premix=True)
    tstep = tbk.build_hashed_step(tcfg, premix=True)
    jstate = jbk.init_state(jcfg)
    tstate = tbk.init_state(tcfg, "cpu")
    hot = np.arange(1, 9, dtype=np.uint64)
    h1, h2 = split_hash(splitmix64(hot), tcfg.sketch.seed)
    order = np.argsort(pack_halves_host(h1, h2))
    policy = {"key": pack_halves_host(h1, h2)[order],
              "limit": rng.integers(1, 30, size=8).astype(np.int64)[order]}
    now = 10 ** 12
    for _ in range(8):
        ids = rng.integers(1, 40, size=64).astype(np.uint64)
        n = rng.integers(0, 4, size=64).astype(np.int32)
        jstate, jout = jstep(jstate, jnp.asarray(ids), jnp.asarray(n),
                             jnp.int64(now),
                             {k: jnp.asarray(v) for k, v in policy.items()})
        tout = tstep(tstate, _t(ids.view(np.int64)), _t(n), now,
                     {k: _t(v) for k, v in policy.items()})
        for o, j in zip(tout, jout):
            assert o.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(o.numpy(), np.asarray(j))
        now += int(rng.integers(-200_000, 900_000))
    for k in STATE_KEYS:
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))
    assert tstate["rem"] != 0 and (tstate["debt"] > 0).any()


# --------------------------------------------------------------- limiter


def _drive(lj, lt, rng, steps, *, reset_at=None):
    """Mixed traffic: raw ids, pre-hashed u64s and string keys (two of them
    overridden), resets, the clock moving by uneven steps and once back."""
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
        adv = -0.9 if step == 5 else float(rng.uniform(0.05, 1.3))
        lj.clock.advance(adv)
        lt.clock.advance(adv)


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
def test_bucket_limiter_bit_identical_to_jax(kernels):
    lj, lt = _pair(kernels)
    try:
        for lim in (lj, lt):
            lim.set_override("whale", 20)
            lim.set_override("guppy", 2)
        _drive(lj, lt, np.random.default_rng(0), 15, reset_at=8)
        _same_state(lj, lt)
        assert lt.capture_state()[1]["rem"] != 0
    finally:
        lj.close()
        lt.close()


def test_bucket_limiter_pipelined_and_denied_retry():
    """Hot keys past their burst are denied with a retry-after, launches
    resolve in any order, and the scalar allow_n matches too."""
    lj, lt = _pair("jnp")
    try:
        rng = np.random.default_rng(2)
        batches = [rng.integers(1, 6, size=32).astype(np.uint64)
                   for _ in range(4)]
        tickets = [lt.launch_ids(b, wire=bool(i % 2))
                   for i, b in enumerate(batches)]
        got = [lt.resolve(t) for t in reversed(tickets)][::-1]
        for b, res in zip(batches, got):
            _same(lj.allow_ids(b), res)
        assert (~got[-1].allowed).any() and (got[-1].retry_after > 0).any()
        for n in (3, 9, 1):
            assert vars(lj.allow_n("solo", n)) == vars(lt.allow_n("solo", n))
    finally:
        lj.close()
        lt.close()


def test_debt_slab_stats_matches_jax():
    lj, lt = _pair("jnp")
    try:
        assert lt.debt_slab_stats() == lj.debt_slab_stats()
        _drive(lj, lt, np.random.default_rng(3), 6)
        stats = lt.debt_slab_stats()
        assert stats == lj.debt_slab_stats() and stats["nonzero_cells"] > 0
        for lim in (lj, lt):
            lim.clock.advance(3.0)      # part of the debt drains
        assert lt.debt_slab_stats() == lj.debt_slab_stats()
        assert lt.debt_slab_stats()["nonzero_cells"] < stats["nonzero_cells"]
    finally:
        lj.close()
        lt.close()


def test_bucket_state_carried_across_packages_both_ways():
    """JAX runs the first half of a trace, the port restores its capture
    and finishes it bit-identically to a JAX limiter that ran it all; then
    the port's capture goes back to a fresh JAX limiter."""
    ref, lt = _pair("jnp")
    half = JaxBucket(_cfg(R, kernels="jnp"), R.ManualClock(T0))
    try:
        for lim in (ref, half):
            lim.set_override("whale", 20)
        _drive(ref, half, np.random.default_rng(5), 7, reset_at=4)
        kind, arrays, extra = half.capture_state()
        assert kind == "sketch" and "host_period" not in extra
        lt.restore_state(arrays, extra)
        lt.clock.set(half.clock.now())
        assert lt.get_override("whale").limit == 20
        _same_state(ref, lt)
        _drive(ref, lt, np.random.default_rng(6), 7)
        _same_state(ref, lt)
        back = JaxBucket(_cfg(R, kernels="jnp"), R.ManualClock(T0))
        kind, arrays, extra = lt.capture_state()
        assert kind == "sketch" and extra.keys() == {"saved_at"}
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


def test_bucket_restore_without_acc_and_refusals():
    lj, lt = _pair("jnp")
    win = SketchLimiter(T.Config(algorithm=T.Algorithm.SLIDING_WINDOW,
                                 limit=7, window=6.0,
                                 sketch=T.SketchParams(depth=D, width=W,
                                                       sub_windows=6)),
                        T.ManualClock(T0), device="cpu")
    try:
        _drive(lj, lt, np.random.default_rng(9), 3)
        _, arrays, extra = lj.capture_state()
        arrays = {k: v for k, v in arrays.items() if k != "acc"}
        lt.restore_state(arrays, extra)
        lj._restore_loaded(dict(arrays), extra)
        assert not lt.capture_state()[1]["acc"].any()
        _same_state(lj, lt)
        _drive(lj, lt, np.random.default_rng(10), 3)
        _same_state(lj, lt)
        # Neither limiter takes the other kind's arrays, nor extra ones.
        with pytest.raises(T.InvalidConfigError, match="do not fit"):
            win.restore_state(arrays, {"host_period": 0})
        _, warrays, wextra = win.capture_state()
        with pytest.raises(T.InvalidConfigError, match="do not fit"):
            lt.restore_state(warrays, wextra)
        with pytest.raises(T.InvalidConfigError, match="neither"):
            lt.restore_state(dict(arrays, tn_counts=np.zeros(3, np.int64)),
                             extra)
    finally:
        lj.close()
        lt.close()
        win.close()


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
def test_bucket_restore_with_acc_above_cap_matches_jax(kernels):
    """A captured state whose ``acc`` holds cells above 2^61 (no step
    writes one; a restore can bring one) goes into both packages. The
    JAX kernel clamps every acc cell on every step; the port's update
    reads acc only at touched cells, so the restore marks the state and
    the first step clamps it densely, then the mark clears."""
    lj, lt = _pair(kernels)
    try:
        _drive(lj, lt, np.random.default_rng(11), 3)
        _, arrays, extra = lj.capture_state()
        rng = np.random.default_rng(12)
        acc = np.asarray(arrays["acc"]).copy()
        over = rng.random(acc.shape) < 0.2
        acc[over] = CAP + rng.integers(1, 1 << 40, size=int(over.sum()))
        arrays = dict(arrays, acc=acc)
        assert not lt._acc_over_cap
        lj._restore_loaded(dict(arrays), extra)
        lt.restore_state(arrays, extra)
        assert lt._acc_over_cap
        _same_state(lj, lt)
        ids = rng.integers(1, 24, size=48).astype(np.uint64)
        _same(lj.allow_ids(ids), lt.allow_ids(ids))
        assert not lt._acc_over_cap
        _same_state(lj, lt)
        assert lt.capture_state()[1]["acc"].max() == CAP
        _drive(lj, lt, np.random.default_rng(13), 4)
        _same_state(lj, lt)
        # A state within the cap leaves the mark clear.
        lt.restore_state(*lt.capture_state()[1:])
        assert not lt._acc_over_cap
    finally:
        lj.close()
        lt.close()


def test_create_limiter_routes_token_bucket():
    lim = T.create_limiter(_cfg(T), backend="sketch", device="cpu")
    assert type(lim) is SketchTokenBucketLimiter
    assert lim.device.type == "cpu"
    lim.close()
    # The bucket has no watchdog in either package: "strict" is ignored.
    cfg = dataclasses.replace(_cfg(T), sketch=dataclasses.replace(
        _cfg(T).sketch, overload_policy="strict"))
    lim = T.create_limiter(cfg, backend="sketch", device="cpu")
    assert type(lim) is SketchTokenBucketLimiter
    lim.close()


def test_bucket_refuses_hierarchy_and_oversized_overrides():
    # The hierarchy cascade is ported: a tenants=4 config serves (its
    # parity with the JAX package is tests/test_torch_hier.py's).
    cfg = dataclasses.replace(_cfg(T), hierarchy=dataclasses.replace(
        _cfg(T).hierarchy, tenants=4))
    lim = SketchTokenBucketLimiter(cfg, T.ManualClock(T0), device="cpu")
    lim.set_tenant("gold", 3)
    lim.assign_tenant("g", "gold")
    assert [lim.allow("g").allowed for _ in range(4)] == [True] * 3 + [False]
    assert lim.hierarchy_stats()["tenants"]["gold"]["in_window"] == 3
    lim.close()
    lj, lt = _pair("jnp")
    try:
        for lim, err in ((lj, R.InvalidConfigError), (lt, T.InvalidConfigError)):
            with pytest.raises(err, match="2\\^42"):
                lim.set_override("whale", 4_398_047)
            assert lim.set_override("whale", 4_398_046).limit == 4_398_046
        keys = ["whale"] * 5
        ns = [4_398_046, 1, 1, 4_398_046, 2]
        _same(lj.allow_batch(keys, ns), lt.allow_batch(keys, ns))
        _same_state(lj, lt)
    finally:
        lj.close()
        lt.close()


# --------------------------------------------------------------- serving


def test_server_binary_serves_the_bucket():
    from ratelimiter_tpu_torch.serving.__main__ import build_config, parse_args

    args = parse_args(["--algorithm", "token_bucket", "--limit", "20",
                       "--window", "10", "--width", "1024", "--device", "cpu"])
    cfg = build_config(args)
    assert cfg.algorithm is T.Algorithm.TOKEN_BUCKET
    lim = T.create_limiter(cfg, backend="sketch", device=args.device)
    assert type(lim) is SketchTokenBucketLimiter
    lim.close()


def test_bucket_wire_bytes_match_jax_framing():
    lim = SketchTokenBucketLimiter(_cfg(T), T.ManualClock(T0), device="cpu")
    try:
        ids = np.arange(21, dtype=np.uint64) % 3
        for _ in range(3):
            res = lim.resolve(lim.launch_ids(ids, wire=True))
        assert res.wire_packed is not None and (~res.allowed).any()
        plain = JaxBatchResult(allowed=res.allowed, limit=res.limit,
                               remaining=res.remaining,
                               retry_after=res.retry_after,
                               reset_at=res.reset_at)
        assert (tp.encode_result_hashed(1, res)
                == jp.encode_result_hashed(1, plain))
        rows = lim.allow_batch(["a", "a", "b"], [5, 5, 1]).results()
        assert (tp.encode_result_batch(2, 7, rows)
                == jp.encode_result_batch(2, 7, [R.Result(**vars(r))
                                                 for r in rows]))
    finally:
        lim.close()


async def _roundtrip(reader, writer, frame):
    writer.write(frame)
    await writer.drain()
    length, type_, req_id = tp.parse_header(
        await reader.readexactly(tp.HEADER_SIZE))
    return type_, req_id, await reader.readexactly(length - 9)


def test_bucket_server_answers_frames_like_an_in_process_limiter():
    served = SketchTokenBucketLimiter(_cfg(T), T.ManualClock(T0), device="cpu")
    mirror = SketchTokenBucketLimiter(_cfg(T), T.ManualClock(T0), device="cpu")
    rng = np.random.default_rng(1)

    async def main():
        srv = await run_server(served)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            for step in range(3):
                ids = rng.integers(0, 20, size=64).astype(np.uint64)
                ns = rng.integers(1, 3, size=64).astype(np.uint32)
                t, rid, body = await _roundtrip(
                    reader, writer, tp.encode_allow_hashed(step, ids, ns))
                assert (t, rid) == (tp.T_RESULT_HASHED, step)
                got, want = tp.parse_result_hashed(body), mirror.allow_ids(ids, ns)
                for f in ("allowed", "remaining", "retry_after", "reset_at"):
                    np.testing.assert_array_equal(getattr(got, f),
                                                  getattr(want, f))
                keys = [f"u{int(i)}" for i in rng.integers(0, 6, size=10)]
                t, _, body = await _roundtrip(
                    reader, writer, tp.encode_allow_batch(100 + step, keys,
                                                          [3] * 10))
                assert t == tp.T_RESULT_BATCH
                assert tp.parse_result_batch(body) == mirror.allow_batch(
                    keys, [3] * 10).results()
            t, _, _ = await _roundtrip(reader, writer, tp.encode_reset(201, "u1"))
            mirror.reset("u1")
            assert t == tp.T_OK
            t, _, body = await _roundtrip(reader, writer,
                                          tp.encode_allow_n(202, "u1", 7))
            want = mirror.allow_n("u1", 7)
            assert tp.parse_result(body) == want and want.allowed
            t, _, body = await _roundtrip(reader, writer,
                                          tp.encode_simple(tp.T_HEALTH, 203))
            serving, _, decisions = tp.parse_health(body)
            assert t == tp.T_HEALTH_R and serving and decisions == 3 * 74 + 1
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()

    asyncio.run(main())
    _same_state_torch(served, mirror)
    served.close()
    mirror.close()


def _same_state_torch(a, b):
    sa, sb = a.capture_state()[1], b.capture_state()[1]
    for k in STATE_KEYS:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
