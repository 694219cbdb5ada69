"""The two plain fronts against the JAX package's step, bit for bit.

A front (``sketch_cuda.window_front_plain``, ``bucket_cuda.
bucket_front_plain``) is what a decision step computes before admission:
the keys' (h1, h2) halves, the estimate, the boundary weight, each key's
limit from the policy table, the available quota and the request units.
On a card one CUDA kernel computes it (``window_front``, ``bucket_front``;
``tests/test_torch_cuda.py`` holds it to these plain versions). Here the
plain versions are held BIT-identical (tolerance 0) to the JAX package's
composition of the same functions, jitted as its step runs them:
``hashing.splitmix64_dev``/``split_hash_dev``, ``sketch_kernels.
_boundary_weight``, the Pallas ``window_estimate``/``bucket_estimate`` in
interpret mode and ``policy_kernels.lookup_i64``.

Cases: the three key lanes (raw ids, hashes, halves given; ids include 0,
2^63 and 2^64-1 and negative int64 bit patterns), four policy tables
(none; sparse; full, with its last row hit; sparse with a query equal to
PAD_KEY), three windowed modes (sliding with a valid boundary, sliding
with a stale one, fixed), three bucket decays on debts near 2^61, the
estimate-only form the resets use, and a sweep of the boundary weight.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimiter_tpu.ops import hashing as jh
from ratelimiter_tpu.ops import pallas_sketch as jps
from ratelimiter_tpu.ops import policy_kernels as jpk
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu_torch.ops import bucket_cuda as bc
from ratelimiter_tpu_torch.ops import sketch_cuda as sc
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk
from ratelimiter_tpu_torch.ops.policy_kernels import PAD_KEY

D, W, B = 3, 128, 48
S = SW = 4
SUB_US = 999_983
PERIOD = 100
SEED = 0x5BD1E995
LIMIT = 100
MICROS = 1_000_000
CAP = 1 << 61

LANES = ["premix", "hashed", "halves"]
POLICIES = ["none", "sparse", "full", "pad"]


def _keys(rng, lane: str, pad_query: bool):
    """The batch in one lane: (the port's operand, the JAX operands, the
    packed queries). Key 0 is the PAD_KEY query when asked."""
    ids = rng.integers(0, 2 ** 63, size=B, dtype=np.int64).view(np.uint64)
    ids = ids * np.uint64(2) + rng.integers(0, 2, size=B).astype(np.uint64)
    ids[-4:] = [0, 1, 2 ** 63, 2 ** 64 - 1]
    ids[B // 2: B // 2 + 8] = ids[:8]                    # repeated keys
    if pad_query:
        # The split hash 0xFFFFFFFF_7FFFFFFF: h1 = 0x7FFFFFFF and h2 =
        # 0xFFFFFFFF, so (h1 << 32) | h2 == PAD_KEY.
        h = jh.splitmix64_inv(np.uint64(0xFFFFFFFF7FFFFFFF)) ^ np.uint64(SEED)
        ids[0] = jh.splitmix64_inv(h) if lane == "premix" else h
    h64 = jh.splitmix64(ids) if lane == "premix" else ids
    h1, h2 = jh.split_hash(h64, SEED)
    q = jpk.pack_halves_host(h1, h2)
    if lane == "halves":
        return ((torch.from_numpy(h1.astype(np.int64)),
                 torch.from_numpy(h2.astype(np.int64))), (h1, h2), q)
    return torch.from_numpy(ids.view(np.int64)), (ids, None), q


def _policy(rng, kind: str, q: np.ndarray):
    """Host key/limit columns: None; sparse (capacity 16: three of the
    batch's keys and two others, PAD_KEY-padded); full (capacity 8: eight
    real keys, the batch's largest last)."""
    if kind == "none":
        return None
    real = np.unique(q[q != PAD_KEY])
    if kind == "full":
        fill = np.setdiff1d(rng.integers(-(1 << 63), real[-1], size=32,
                                         dtype=np.int64), real)
        keys = np.sort(np.concatenate([fill[:5], real[[0, 5, -1]]]))
    else:
        keys = np.unique(np.concatenate([real[[1, 7, 11]], rng.integers(
            -(1 << 63), PAD_KEY, size=2, dtype=np.int64)]))
        keys = np.concatenate([keys, np.full(16 - len(keys), PAD_KEY)])
    limits = np.full(len(keys), LIMIT, dtype=np.int64)
    real_rows = keys != PAD_KEY
    limits[real_rows] = rng.integers(1, 4000, size=int(real_rows.sum()))
    return {"key": keys.astype(np.int64), "limit": limits}


def _torch_policy(pol):
    return None if pol is None else {k: torch.from_numpy(v)
                                     for k, v in pol.items()}


@functools.cache
def _jax_halves(lane: str):
    """The JAX step's hashing of its staged operand (jitted)."""
    def halves(h64):
        h = jh.splitmix64_dev(h64) if lane == "premix" else h64
        return jh.split_hash_dev(h, SEED)
    return jax.jit(halves)


def _jax_limits(h1, h2, pol, dtype):
    """The JAX step's where(found, limit[idx], limit), in ``dtype``."""
    q = jpk.pack_halves(h1, h2)
    idx, found = jpk.lookup_i64(pol["key"], q)
    return jnp.where(found, pol["limit"][idx], jnp.int64(LIMIT)).astype(dtype)


@functools.cache
def _jax_window(weighted: bool, has_policy: bool):
    """The JAX windowed step's front on the Pallas path (sketch_kernels.
    _sketch_step with use_pallas), jitted as the step is."""
    @jax.jit
    def front(h1, h2, n, totals, slabs, slab_period, now_us, pol):
        frac, boundary = jsk._boundary_weight(
            {"slabs": slabs, "slab_period": slab_period}, jnp.int64(PERIOD),
            now_us, sub_us=SUB_US, SW=SW, S=S, weighted=weighted)
        bop = boundary if boundary is not None else jnp.zeros_like(totals)
        est = jnp.maximum(jps.window_estimate(totals, bop, frac, h1, h2),
                          0.0)
        lim_f = (_jax_limits(h1, h2, pol, jnp.float32) if has_policy
                 else jnp.float32(LIMIT))
        return est, frac, jnp.maximum(lim_f - est, 0.0), n.astype(
            jnp.float32)
    return front


@functools.cache
def _jax_bucket(has_policy: bool):
    """The JAX bucket step's front on the Pallas path, jitted."""
    @jax.jit
    def front(h1, h2, n, debt, decay, pol):
        est = jps.bucket_estimate(debt, decay, h1, h2)
        cap = (_jax_limits(h1, h2, pol, jnp.int64) * MICROS if has_policy
               else LIMIT * MICROS)
        return est, jnp.maximum(jnp.int64(0), cap - est), n.astype(
            jnp.int64) * MICROS
    return front


def _halves_both(lane, jax_keys):
    """The JAX halves (uint32) of the batch."""
    if lane == "halves":
        return jax_keys
    return tuple(np.asarray(x) for x in _jax_halves(lane)(
        jnp.asarray(jax_keys[0])))


def _same_halves(got, j1, j2):
    np.testing.assert_array_equal(got[0].numpy(), j1.astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), j2.astype(np.int64))
    assert got[0].dtype == got[1].dtype == torch.int64


def _window_state(rng, mode: str):
    totals = rng.integers(-4, 4000, size=(D, W)).astype(np.int32)
    slabs = rng.integers(-3, 3000, size=(S, D, W)).astype(np.int32)
    periods = np.full(S, -(1 << 40), np.int64)
    periods[PERIOD % S] = PERIOD - SW - (mode == "stale")
    return totals, slabs, periods


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("lane", LANES)
def test_window_front_plain_matches_jax(lane, policy):
    """Each windowed mode: sliding with a valid boundary, sliding with a
    stale one (weight 0), fixed (no boundary)."""
    for mode in ("valid", "stale", "fixed"):
        _check_window_front(lane, policy, mode)


def _check_window_front(lane, policy, mode):
    rng = np.random.default_rng([LANES.index(lane), POLICIES.index(policy),
                                 len(mode)])
    keys, jkeys, q = _keys(rng, lane, policy == "pad")
    pol = _policy(rng, policy, q)
    n = rng.integers(0, 4, size=B).astype(np.int32)
    totals, slabs, periods = _window_state(rng, mode)
    now_us = PERIOD * SUB_US + 377_123
    weighted = mode != "fixed"
    bnd = tsk._boundary({"slabs": torch.from_numpy(slabs),
                         "slab_period": torch.from_numpy(periods)}, PERIOD,
                        now_us, sub_us=SUB_US, SW=SW, S=S, weighted=weighted)
    kw = dict(premix=lane == "premix", seed=SEED, boundary=bnd,
              policy=_torch_policy(pol), limit=LIMIT)
    got = sc.window_front(torch.from_numpy(totals), keys,
                          torch.from_numpy(n), **kw)

    j1, j2 = _halves_both(lane, jkeys)
    jpol = {"key": jnp.zeros(2, jnp.int64), "limit": jnp.zeros(
        2, jnp.int64)} if pol is None else {k: jnp.asarray(v)
                                            for k, v in pol.items()}
    est, frac, avail, n_f = (np.asarray(x) for x in _jax_window(
        weighted, pol is not None)(jnp.asarray(j1), jnp.asarray(j2),
                               jnp.asarray(n), jnp.asarray(totals),
                               jnp.asarray(slabs), jnp.asarray(periods),
                               jnp.int64(now_us), jpol))
    _same_halves(got, j1, j2)
    for t, want in zip((got[2], got[4], got[5]), (est, avail, n_f)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want)
    if weighted:
        assert got[3].shape == () and got[3].dtype == torch.float32
        assert np.float32(got[3]) == frac
        assert (frac == 0) == (mode == "stale")
    else:
        assert got[3] is None
    if policy == "pad":
        assert avail[0] == max(np.float32(LIMIT) - est[0], 0)
    # The estimate-only form (the reset): the same est and frac.
    est_only = sc.window_front(torch.from_numpy(totals), keys, **kw)
    np.testing.assert_array_equal(est_only[2].numpy(), est)
    assert est_only[4] is None and est_only[5] is None


def _debt(rng):
    """Zeros, random debts and cells within 10^6 of 2^61."""
    x = rng.integers(0, 400_000_000, size=(D, W)).astype(np.int64)
    x[rng.random((D, W)) < 0.3] = 0
    hot = rng.random((D, W)) < 0.3
    x[hot] = CAP - rng.integers(0, 1_000_000, size=int(hot.sum()))
    return x


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("lane", LANES)
def test_bucket_front_plain_matches_jax(lane, policy):
    """Decays of 0, a moderate value and one above the cap, on debts near
    2^61."""
    for decay in (0, 3_333_337, 1 << 62):
        _check_bucket_front(lane, policy, decay)


def _check_bucket_front(lane, policy, decay):
    rng = np.random.default_rng([LANES.index(lane), POLICIES.index(policy),
                                 decay % 1000, 9])
    keys, jkeys, q = _keys(rng, lane, policy == "pad")
    pol = _policy(rng, policy, q)
    n = rng.integers(0, 4, size=B).astype(np.int32)
    debt = _debt(rng)
    j1, j2 = _halves_both(lane, jkeys)
    for r in range(D):              # the first keys' cells near the cap
        debt[r, (j1[:4].astype(np.uint64) + np.uint64(r) * j2[:4])
             & np.uint64(W - 1)] = CAP - 10
    kw = dict(premix=lane == "premix", seed=SEED,
              policy=_torch_policy(pol), limit=LIMIT)
    got = bc.bucket_front(torch.from_numpy(debt), decay, keys,
                          torch.from_numpy(n), **kw)

    jpol = {"key": jnp.zeros(2, jnp.int64), "limit": jnp.zeros(
        2, jnp.int64)} if pol is None else {k: jnp.asarray(v)
                                            for k, v in pol.items()}
    est, avail, units = (np.asarray(x) for x in _jax_bucket(
        pol is not None)(jnp.asarray(j1), jnp.asarray(j2), jnp.asarray(n),
                         jnp.asarray(debt), jnp.int64(decay), jpol))
    _same_halves(got, j1, j2)
    for t, want in zip(got[2:], (est, avail, units)):
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), want)
    if decay == 0:
        assert (est[:4] == CAP - 10).all() and (avail[:4] == 0).all()
    est_only = bc.bucket_front(torch.from_numpy(debt), decay, keys, **kw)
    np.testing.assert_array_equal(est_only[2].numpy(), est)
    assert est_only[3] is None and est_only[4] is None


def test_policy_cases_reach_their_rows():
    """The tables above do what their names say: the full table's last
    row and the pad row are hit, and the sparse table finds three keys."""
    rng = np.random.default_rng(3)
    _, _, q = _keys(rng, "halves", True)
    for kind, last_row_hit, found in (("full", True, 3), ("pad", True, 4)):
        pol = _policy(rng, kind, q)
        idx, hit = jpk.lookup_host(pol["key"], q)
        P = len(pol["key"])
        assert bool((hit & (idx == P - 1)).any()) == last_row_hit
        assert len(np.unique(q[hit])) == found
    assert q[0] == PAD_KEY


@pytest.mark.parametrize("sub_us", [1_000_000, SUB_US, 7, 1 << 20])
def test_front_frac_sweep_matches_jax(sub_us):
    """The front's boundary weight, computed from (e, rcp) by the same
    correctly rounded FMA as the card's, against the JAX reference at
    elapsed 0, 1, sub_us - 1, sub_us and random points of the sub-window."""
    p = PERIOD
    state = {"slabs": jnp.zeros((S, 1, 16), jnp.int32),
             "slab_period": jnp.full((S,), p - SW, jnp.int64)}
    ref = jax.jit(lambda st, now: jsk._boundary_weight(
        st, jnp.int64(p), now, sub_us=sub_us, SW=SW, S=S, weighted=True)[0])
    tstate = {"slabs": torch.zeros((S, 1, 16), dtype=torch.int32),
              "slab_period": torch.full((S,), p - SW, dtype=torch.int64)}
    rng = np.random.default_rng(sub_us)
    elapsed = np.concatenate([[0, 1, sub_us - 1, sub_us],
                              rng.integers(0, sub_us, size=60)])
    zeros = torch.zeros(4, dtype=torch.int64)
    for e in elapsed:
        now = p * sub_us + int(e)
        bnd = tsk._boundary(tstate, p, now, sub_us=sub_us, SW=SW, S=S,
                            weighted=True)
        frac = sc.window_front(tstate["slabs"][0], (zeros, zeros),
                               boundary=bnd)[3]
        assert np.float32(frac) == np.float32(ref(state, jnp.int64(now)))
