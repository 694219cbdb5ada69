"""The three backs of the decision step (plain versions) and the rewired
steps against the JAX package, bit for bit.

A back is what a step computes after its front: in-batch admission
(``segment.admit``) and the results around it. On a card each is ONE CUDA
launch (``sketch_cuda.add_back``, ``window_admit``, ``bucket_cuda.
bucket_admit``; ``tests/test_torch_cuda.py`` holds them to these plain
versions). Here the plain versions are held BIT-identical (tolerance 0)
to the JAX package's ``segment.admit`` followed by the JAX step's own
epilogue expressions (``ratelimiter_tpu/ops/sketch_kernels.py:432,450-456,
534-535``, ``ratelimiter_tpu/ops/bucket_kernels.py:229-233``), jitted
once per dtype and ``iters``; and the whole vanilla, CU and bucket steps
(``build_hashed_step``) are held to the JAX steps on the jnp path.

Cases, 4096 requests each: mixed request counts on few keys (the fixpoint
under-admits against the greedy answer with one round), one key for the
whole batch, all keys distinct, half the batch padding (n = 0), counts
above 2^24 (rounded in f32) with a batch total past 2^24, int64 units past
2^24, ``iters`` 1 and 4, and a retry whose ``deficit * rate_den`` wraps
int64. And the batches that stress the card's cluster admission
(csrc/admit_cluster.cuh partitions the keys over a cluster's blocks by
``sketch_cuda.owners_of``): one key holding 60% of the batch (more
than a block's share), keys whose owner block agrees at every cluster
size for 3/4 of it, and B = 1, 257 and 4097 (not multiples of a cluster
size), for the backs and for the whole steps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.ops import bucket_kernels as jbk
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu.ops.segment import admit as jax_admit
from ratelimiter_tpu.ops.sortmerge import row_histogram
from ratelimiter_tpu_torch.ops import bucket_cuda as bc
from ratelimiter_tpu_torch.ops import bucket_kernels as tbk
from ratelimiter_tpu_torch.ops import sketch_cuda as sc
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk
from ratelimiter_tpu_torch.ops.sketch_cuda import owners_of

B = 4096
D, W = 3, 128
MICROS = 1_000_000
CASES = ["mixed", "one key", "distinct", "padding", "past 2^24",
         "hot key", "owner bits", "B=1", "B=257", "B=4097"]
#: The cluster admission's adversarial cases (the last five above).
CLUSTER_CASES = CASES[5:]
#: (rate_num, rate_den): config 3's refill, and one whose product with a
#: deficit wraps int64.
RATES = [(5, 3), (3, (1 << 62) + 11)]


# ------------------------------------------------ JAX side, jitted once


def _sid(h1):
    """The JAX step's segment id: h1's uint32 bits as int32."""
    return jax.lax.bitcast_convert_type(h1.astype(jnp.uint32), jnp.int32)


@functools.partial(jax.jit, static_argnames="iters")
def _jax_window_back(h1, h2, n, avail, est, totals, cur, *, iters):
    """segment.admit and the windowed step's epilogues: the CU target,
    the vanilla add folded in with row_histogram, and remaining."""
    n_f = n.astype(jnp.float32)
    allowed, seen, _ = jax_admit(_sid(h1), n_f, avail, iters)
    target = jnp.where(allowed, est + (avail - seen) + n_f, 0.0)
    add = jnp.where(allowed, n, 0).astype(jnp.int32)
    cols = jsk._columns(h1.astype(jnp.uint32), h2.astype(jnp.uint32), D, W)
    hists = jnp.stack([row_histogram(cols[:, r], add, W) for r in range(D)])
    remaining = jnp.maximum(
        jnp.floor(seen - jnp.where(allowed, n_f, 0.0)), 0.0).astype(jnp.int32)
    return allowed, remaining, target, totals + hists, cur + hists


@functools.partial(jax.jit, static_argnames="iters")
def _jax_bucket_back(h1, n_units, avail, rate_num, rate_den, *, iters):
    """segment.admit in int64 and the bucket step's remaining and retry."""
    allowed, seen, consumed = jax_admit(_sid(h1), n_units, avail, iters)
    remaining = (seen - jnp.where(allowed, n_units, 0)) // MICROS
    deficit = jnp.maximum(0, n_units - seen)
    retry_us = jnp.where(allowed, 0, -((-deficit * rate_den) // rate_num))
    return allowed, consumed, remaining, retry_us, deficit


# ------------------------------------------------------------ the cases


def _greedy(h1, n, avail):
    """The sequential answer: per key, each request in batch order is
    allowed iff it fits what the allowed ones before it left."""
    used, out = {}, np.zeros(len(h1), bool)
    for i, (k, x, a) in enumerate(zip(h1.tolist(), n.tolist(),
                                      avail.tolist())):
        c = used.get(k, 0)
        if c + x <= a:
            out[i] = True
            used[k] = c + x
    return out


def _size(name: str) -> int:
    return int(name[2:]) if name.startswith("B=") else B


def _case(name: str):
    """(h1 int64 in 0..2^32-1, h2, n int32, avail f32, est f32) for B
    requests (or the case's own size); avail is equal within a key, as the
    front gives it."""
    rng = np.random.default_rng(CASES.index(name))
    nb = _size(name)
    keys = rng.integers(0, 2 ** 32, size=max(nb, 64), dtype=np.int64)
    n = rng.integers(0, 7, size=nb).astype(np.int32)
    if name == "one key":
        h1 = np.full(nb, keys[0])
        n = rng.integers(0, 4, size=nb).astype(np.int32)
    elif name == "distinct":
        h1 = np.unique(keys)
        h1 = np.concatenate([h1, h1[:nb - len(h1)] ^ (1 << 31)])
    else:
        h1 = keys[rng.integers(0, 40, size=nb)]
        if nb >= 4:
            # One key's leading requests: the fixpoint's first round
            # denies all but the first (6 + 5 > 10), the greedy answer
            # admits the 4.
            h1[:4] = keys[41]
            n[:4] = [6, 5, 4, 1]
    if name == "hot key":
        h1[rng.random(nb) < 0.6] = keys[42]
    elif name == "owner bits":
        same = keys[owners_of(keys, 16) == 0][:64]
        pick = rng.random(nb) < 0.75
        h1[pick] = same[rng.integers(0, len(same), size=int(pick.sum()))]
        assert (owners_of(h1, 16) == 0).mean() > 0.7
    per_key = {k: rng.integers(0, 30) + rng.random() for k in np.unique(h1)}
    per_key[keys[41]] = 10.0
    if name == "one key":
        per_key[keys[0]] = 3000.5
    avail = np.array([per_key[k] for k in h1], np.float32)
    if name == "padding":
        n[B // 2:] = 0
    if name == "past 2^24":
        big = rng.choice(B, size=24, replace=False)
        n[big] = rng.integers(1 << 24, 1 << 25, size=24)
        avail[:] = np.float32((1 << 24) - 1)
        assert n.astype(np.int64).sum() >= 1 << 24
        assert n.astype(np.int64).sum() < 1 << 31
    h2 = rng.integers(0, 2 ** 32, size=nb) | 1
    est = (rng.random(nb) * 30).astype(np.float32)
    return h1, h2, n, avail, est


def _units(n, avail):
    """The bucket's operands in micro-units, past 2^24: 7 * 10^6 per
    request (+1 for some) and the windowed case's avail in the same
    units."""
    units = n.astype(np.int64) * 7 * MICROS + (n > 2)
    return units, (avail.astype(np.float64) * 7 * MICROS).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(got, want):
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert g.numpy().dtype == w_.dtype
        np.testing.assert_array_equal(g.numpy(), w_)


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_window_backs_plain_match_jax(case, iters):
    """add_back_plain (allowed, remaining, both slabs) and
    window_admit_plain (target, allowed, remaining)."""
    h1, h2, n, avail, est = _case(case)
    rng = np.random.default_rng(iters)
    totals = rng.integers(-3, 300, size=(D, W)).astype(np.int32)
    cur = rng.integers(-3, 30, size=(D, W)).astype(np.int32)
    j_allowed, j_rem, j_target, j_totals, j_cur = _jax_window_back(
        *(jnp.asarray(x) for x in (h1, h2, n, avail, est, totals, cur)),
        iters=iters)
    t_totals, t_cur = _t(totals.copy()), _t(cur.copy())
    got = sc.add_back_plain(t_totals, t_cur, _t(h1), _t(h2), _t(n),
                            _t(n).to(torch.float32), _t(avail), iters)
    _same([*got, t_totals, t_cur], [j_allowed, j_rem, j_totals, j_cur])
    _same(sc.window_admit_plain(_t(h1), _t(est), _t(n).to(torch.float32),
                                _t(avail), iters),
          [j_target, j_allowed, j_rem])
    allowed = np.asarray(j_allowed)
    if len(h1) > 1:
        assert allowed.any() and not allowed.all()
    if case == "mixed" and iters == 1:
        # The case the safety intersection exists for: fewer admitted
        # than the sequential answer, never more.
        greedy = _greedy(h1, n, avail)
        assert greedy[2] and not allowed[2]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_bucket_admit_plain_matches_jax(case, iters, rate):
    """bucket_admit_plain (allowed, consumed, remaining, retry_us) on int64
    units past 2^24; the second rate wraps deficit * rate_den."""
    h1, _, n, avail, _ = _case(case)
    units, b_avail = _units(n, avail)
    want = _jax_bucket_back(jnp.asarray(h1), jnp.asarray(units),
                            jnp.asarray(b_avail), jnp.int64(rate[0]),
                            jnp.int64(rate[1]), iters=iters)
    got = bc.bucket_admit_plain(_t(h1), _t(units), _t(b_avail), iters, *rate)
    _same(got, want[:4])
    denied = ~np.asarray(want[0])
    if len(h1) == 1:
        return
    assert denied.any() and not denied.all()
    assert (units > (1 << 24)).any()
    if rate[1] > 1 << 61:
        assert any(int(x) * rate[1] >= 1 << 63
                   for x in np.asarray(want[4])[denied])


# ------------------------------------------------------- whole steps


T0_US = 1_000_000_000_123
SUB_US = 1_000_000


def _window_cfg(M, cu: bool, iters: int):
    return M.Config(
        algorithm=M.Algorithm.SLIDING_WINDOW, limit=7, window=6.0,
        max_batch_admission_iters=iters,
        sketch=M.SketchParams(depth=D, width=W, sub_windows=6,
                              conservative_update=cu, **(
                                  {"kernels": "jnp"} if M is R else {})))


def _window_states(jcfg, tcfg, rng):
    """Equal JAX and port states mid-period, with a valid boundary slab
    and cells near the limit, at period ``T0_US // SUB_US``."""
    p = T0_US // SUB_US
    S = 6
    arrays = {
        "cur": rng.integers(0, 3, size=(D, W)).astype(np.int32),
        "slabs": rng.integers(0, 3, size=(S, D, W)).astype(np.int32),
        "slab_period": np.full(S, p - 100, np.int64),
        "last_period": np.int64(p),
    }
    arrays["slab_period"][p % S] = p - S
    arrays["totals"] = arrays["cur"] + rng.integers(0, 4, size=(D, W)).astype(
        np.int32)
    jstate = dict(jsk.init_state(jcfg))
    jstate.update({k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = tsk.init_state(tcfg, "cpu")
    for k, v in arrays.items():
        tstate[k].copy_(torch.as_tensor(v))
    return jstate, tstate, p


@pytest.mark.parametrize("cu,iters", [(False, 4), (True, 4), (False, 1)])
def test_window_step_matches_jax(cu, iters):
    """Three raw-id steps of the rewired windowed step (front, then
    add_back or window_admit + cu_update) against the JAX step."""
    rng = np.random.default_rng(int(cu) + iters)
    jcfg, tcfg = _window_cfg(R, cu, iters), _window_cfg(T, cu, iters)
    jstep = jsk.build_hashed_step(jcfg, premix=True)
    tstep = tsk.build_hashed_step(tcfg, premix=True)
    jstate, tstate, p = _window_states(jcfg, tcfg, rng)
    now = T0_US
    for _ in range(3):
        ids = rng.integers(1, 60, size=256).astype(np.uint64)
        n = rng.integers(0, 4, size=256).astype(np.int32)
        jstate, jout = jstep(jstate, jnp.asarray(ids), jnp.asarray(n),
                             jnp.int64(now), None)
        tout = tstep(tstate, _t(ids.view(np.int64)), _t(n), now, period=p)
        _same(tout, jout)
        now += int(rng.integers(1, 200_000))
    for k in ("cur", "totals"):
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]))
    assert not np.asarray(jout[0]).all()


def _bucket_cfg(M, iters: int):
    return M.Config(algorithm=M.Algorithm.TOKEN_BUCKET, limit=7, window=6.0,
                    max_batch_admission_iters=iters,
                    sketch=M.SketchParams(depth=D, width=W, **(
                        {"kernels": "jnp"} if M is R else {})))


@pytest.mark.parametrize("iters", [1, 4])
def test_bucket_step_with_admit_matches_jax(iters):
    """Three raw-id steps of the rewired bucket step (front, bucket_admit,
    bucket_update) against the JAX step, hot keys denied."""
    rng = np.random.default_rng(10 + iters)
    jcfg, tcfg = _bucket_cfg(R, iters), _bucket_cfg(T, iters)
    jstep = jbk.build_hashed_step(jcfg, premix=True)
    tstep = tbk.build_hashed_step(tcfg, premix=True)
    jstate, tstate = jbk.init_state(jcfg), tbk.init_state(tcfg, "cpu")
    now = T0_US
    for _ in range(3):
        ids = rng.integers(1, 30, size=256).astype(np.uint64)
        n = rng.integers(0, 4, size=256).astype(np.int32)
        jstate, jout = jstep(jstate, jnp.asarray(ids), jnp.asarray(n),
                             jnp.int64(now), None)
        tout = tstep(tstate, _t(ids.view(np.int64)), _t(n), now)
        _same(tout, jout)
        now += int(rng.integers(1, 300_000))
    for k in ("debt", "acc", "rem", "last"):
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]))
    assert (np.asarray(jout[2]) > 0).any()


# ------------------------------------- whole steps on the cluster cases


def _step_ids(case: str, seed: int, rng):
    """Raw ids for a step on one of ``CLUSTER_CASES``: few keys with one
    holding 60% ("hot key"), ids whose hashed h1 (the step's seed) has
    one owner block at every cluster size for 3/4 of the batch ("owner
    bits"), or B mixed ids ("B=<n>")."""
    from ratelimiter_tpu_torch.ops import hashing

    nb = 512 if case in ("hot key", "owner bits") else _size(case)
    ids = rng.integers(1, 600, size=nb).astype(np.uint64)
    if case == "hot key":
        ids[rng.random(nb) < 0.6] = 7
    elif case == "owner bits":
        pool = np.arange(1, 4096, dtype=np.uint64)
        h1, _ = hashing.split_hash(hashing.splitmix64(pool), seed)
        same = pool[owners_of(h1.astype(np.int64), 16) == 0][:40]
        pick = rng.random(nb) < 0.75
        ids[pick] = same[rng.integers(0, len(same), size=int(pick.sum()))]
    return ids


@pytest.mark.parametrize("algo,iters", [("cu", 4), ("cu", 1),
                                        ("vanilla", 4), ("bucket", 4),
                                        ("bucket", 1)])
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_steps_on_cluster_cases_match_jax(case, algo, iters):
    """Three raw-id steps of the rewired windowed (CU and vanilla) and
    bucket steps on the cluster admission's adversarial batches against
    the JAX steps, every output and the state bit for bit."""
    rng = np.random.default_rng(CLUSTER_CASES.index(case) * 7 + iters)
    if algo == "bucket":
        jcfg, tcfg = _bucket_cfg(R, iters), _bucket_cfg(T, iters)
        jstep = jbk.build_hashed_step(jcfg, premix=True)
        tstep = tbk.build_hashed_step(tcfg, premix=True)
        jstate, tstate = jbk.init_state(jcfg), tbk.init_state(tcfg, "cpu")
        names, kw = ("debt", "acc", "rem", "last"), {}
    else:
        cu = algo == "cu"
        jcfg, tcfg = _window_cfg(R, cu, iters), _window_cfg(T, cu, iters)
        jstep = jsk.build_hashed_step(jcfg, premix=True)
        tstep = tsk.build_hashed_step(tcfg, premix=True)
        jstate, tstate, p = _window_states(jcfg, tcfg, rng)
        names, kw = ("cur", "totals"), {"period": p}
    now = T0_US
    denied = 0
    for _ in range(3):
        ids = _step_ids(case, tcfg.sketch.seed, rng)
        n = rng.integers(0, 4, size=len(ids)).astype(np.int32)
        jstate, jout = jstep(jstate, jnp.asarray(ids), jnp.asarray(n),
                             jnp.int64(now), None)
        tout = tstep(tstate, _t(ids.view(np.int64)), _t(n), now, **kw)
        _same(tout, jout)
        denied += int((~np.asarray(jout[0])).sum())
        now += int(rng.integers(1, 200_000))
    for k in names:
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]))
    if _size(case) > 1:
        assert denied > 0
