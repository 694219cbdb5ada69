"""The port's scan runners (``sketch_kernels.build_scan`` and
``bucket_kernels.build_scan``, on the CPU) against the JAX package's.

A scan enqueues T steps back to back with no host sync and returns the
packed allow masks (T, B/8) and the deny counts (T,). Inputs are made
with NumPy from a seed and fed to both packages; the packed masks, the
deny counts and every state array must be BIT-identical (tolerance 0).
The JAX scans run their ``jnp`` reference path (the JAX package's own
parity suite holds its Pallas path to it). Windowed: sliding and fixed,
conservative and vanilla updates, with the heavy-hitter side table, and
with tenant counters (no tenant table rides a scan, so they carry
through untouched), each over a chunk whose boundary sub-window is live
(the weight varies within the chunk) and one after a rollover. The
one-sub-window precondition is refused by the port where the JAX scan
clamps (tests/test_scan.py). The scan's boundary weights are held to
the JAX scan's vector form at every elapsed value of a sub-window. Token
bucket: chunks across refills.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.ops import bucket_kernels as jbk
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu_torch.convert import state_from_numpy, state_to_numpy
from ratelimiter_tpu_torch.ops import bucket_kernels as tbk
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk

T0_US = 1_700_000_000 * 1_000_000
SUB_US = 1_000_000
TN, B = 6, 64


def _cfg(M, algo="SLIDING_WINDOW", cu=True, hh=0, tenants=0, limit=6):
    extra = {"kernels": "jnp"} if M is R else {}
    kw = {}
    if tenants:
        kw["hierarchy"] = M.HierarchySpec(tenants=tenants, global_limit=40)
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=6.0, max_batch_admission_iters=2,
                    sketch=M.SketchParams(depth=2, width=256, sub_windows=6,
                                          conservative_update=cu,
                                          hh_slots=hh, **extra), **kw)


def _keys(rng, shape, pool=40):
    """(h1 uint32, h2 uint32 odd) drawn from a small pool of keys, so a
    chunk holds contention, repeats and collisions."""
    h1 = rng.integers(0, 2 ** 32, size=pool, dtype=np.uint64)
    h2 = rng.integers(0, 2 ** 32, size=pool, dtype=np.uint64) | 1
    pick = rng.integers(0, pool, size=shape)
    return h1[pick].astype(np.uint32), h2[pick].astype(np.uint32)


def _same_state(jst, tst, msg=""):
    want = {k: np.asarray(v) for k, v in jst.items()}
    got = state_to_numpy(tst)
    assert set(want) == set(got), msg
    for k in want:
        assert want[k].dtype == got[k].dtype, (msg, k)
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{msg} {k}")


CASES = {
    "sliding_cu": dict(),
    "sliding_vanilla": dict(cu=False),
    "fixed_cu": dict(algo="FIXED_WINDOW"),
    "fixed_vanilla": dict(algo="FIXED_WINDOW", cu=False),
    "sliding_cu_hh": dict(hh=16),
    "sliding_vanilla_hh": dict(cu=False, hh=16),
    "sliding_cu_tenants": dict(tenants=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sketch_scan_matches_jax(case):
    """Three chunks: one in a first sub-window, one six sub-windows later
    (its boundary slab is the first chunk's, weighted anew each step),
    one after a further rollover; masks, deny counts and the whole state
    (``hh_*`` and ``tn_*`` included) after each."""
    kw = CASES[case]
    cj, ct = _cfg(R, **kw), _cfg(T, **kw)
    rng = np.random.default_rng(sorted(CASES).index(case))
    _, sub_us, _, _, _ = jsk.sketch_geometry(cj)
    _, _, jroll = jsk.build_steps(cj)
    _, _, troll = tsk.build_steps(ct)
    jscan, tscan = jsk.build_scan(cj), tsk.build_scan(ct)
    p0 = T0_US // sub_us
    js = jroll(jsk.init_state(cj), jnp.int64(p0))
    ts = state_from_numpy({k: np.asarray(v) for k, v in
                           jsk.init_state(cj).items()}, "cpu")
    troll(ts, p0)
    for p, dt in ((p0, 37_000), (p0 + 6, 160_000), (p0 + 7, 0)):
        if p != p0:
            js = jroll(js, jnp.int64(p))
            troll(ts, p)
        h1, h2 = _keys(rng, (TN, B))
        ns = rng.integers(1, 3, size=(TN, B)).astype(np.int32)
        now0 = p * sub_us + 1_000
        js, jp, jd = jscan(js, jnp.asarray(h1), jnp.asarray(h2),
                           jnp.asarray(ns), jnp.int64(now0), jnp.int64(dt))
        ts, tp, td = tscan(ts, torch.from_numpy(h1.astype(np.int64)),
                           torch.from_numpy(h2.astype(np.int64)),
                           torch.from_numpy(ns), now0, dt, period=p)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        _same_state(js, ts, f"{case} p={p - p0}")
        assert td.dtype == torch.int32 and tp.shape == (TN, B // 8)
    assert int(td.sum()) > 0


@pytest.mark.parametrize("sub_us", [1_000_000, 999_983, 60_000_000])
def test_scan_boundary_weights_match_the_jax_vector_form(sub_us):
    """The JAX scan computes every step's boundary weight at once,
    ``clip(1 - elapsed / f32(sub_us), 0, 1)`` over the chunk's clamped
    timestamps; the port's front derives it per step as ``clip(fma(-e,
    rcp, 1), 0, 1)``. Bit-equal at every elapsed value of a sub-window
    (2^20 of them, evenly spaced, for the long one), so the scan needs
    no given-weight operand."""
    from ratelimiter_tpu_torch.ops import sketch_cuda

    n = min(sub_us + 1, 1 << 20)
    dt = max(1, sub_us // (n - 1))
    p = 1_700_000_000 * 1_000_000 // sub_us

    def fracs(now0, step):
        ts = now0 + jnp.arange(n, dtype=jnp.int64) * step
        ts = jnp.maximum(ts, p * sub_us)
        elapsed = (ts - p * sub_us).astype(jnp.float32)
        return jnp.clip(1.0 - elapsed / jnp.float32(sub_us), 0.0, 1.0)

    want = np.asarray(jax.jit(fracs)(jnp.int64(p * sub_us), jnp.int64(dt)))
    e = torch.from_numpy((np.arange(n, dtype=np.int64) * dt).astype(
        np.float32))
    rcp = np.float32(1.0) / np.float32(sub_us)
    got = sketch_cuda.fma_f32(-e, torch.full((n,), float(rcp)),
                              torch.ones(n)).clamp(0.0, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert float(sketch_cuda.frac_plain(np.float32(e[n // 3]), rcp)) == \
        float(want[n // 3])


def test_sketch_scan_refuses_a_chunk_past_its_sub_window():
    """The one-sub-window precondition: the JAX scan freezes time at the
    stale period past its end (tests/test_scan.py counts 3 admits); the
    port refuses such a chunk before anything runs, and takes one that
    ends on the period's last microsecond."""
    cfg = _cfg(T, limit=3)
    _, sub_us, _, _, _ = tsk.sketch_geometry(cfg)
    scan = tsk.build_scan(cfg)
    p = T0_US // sub_us
    st = tsk.init_state(cfg, "cpu")
    tsk.build_steps(cfg)[2](st, p)
    before = {k: v.clone() for k, v in st.items()}
    h = torch.full((3, 8), 12345, dtype=torch.int64)
    ns = torch.ones((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="sub-window"):
        scan(st, h, h | 1, ns, p * sub_us, sub_us, period=p)
    for k in st:
        assert torch.equal(st[k], before[k]), k
    last = (p + 1) * sub_us - 1
    _, packed, _ = scan(st, h, h | 1, ns, last - 2 * 1000, 1000, period=p)
    assert int(np.unpackbits(packed.numpy()).sum()) == 3
    jcfg = _cfg(R, limit=3)
    js = jsk.build_steps(jcfg)[2](jsk.init_state(jcfg), jnp.int64(p))
    hj = jnp.full((3, 8), 12345, jnp.uint32)
    _, jp, _ = jsk.build_scan(jcfg)(js, hj, hj | 1, jnp.ones((3, 8),
                                                             jnp.int32),
                                    jnp.int64(p * sub_us),
                                    jnp.int64(sub_us))
    assert int(np.unpackbits(np.asarray(jp)).sum()) == 3


@pytest.mark.parametrize("tenants", [0, 4])
def test_bucket_scan_matches_jax(tenants):
    """The token bucket's scan over three chunks (the decay runs in each
    step); masks, deny counts and the state (``tn_*`` carried through)."""
    kw = dict(algo="TOKEN_BUCKET", limit=7, tenants=tenants)
    cj = dataclasses.replace(_cfg(R, **kw), window=6.0)
    ct = dataclasses.replace(_cfg(T, **kw), window=6.0)
    rng = np.random.default_rng(77 + tenants)
    js = jbk.init_state(cj)
    ts = tbk.init_state(ct, "cpu")
    jscan, tscan = jbk.build_scan(cj), tbk.build_scan(ct)
    now0 = T0_US
    for dt in (11_000, 400_000, 2_500_000):
        h1, h2 = _keys(rng, (TN, B))
        ns = rng.integers(1, 4, size=(TN, B)).astype(np.int32)
        js, jp, jd = jscan(js, jnp.asarray(h1), jnp.asarray(h2),
                           jnp.asarray(ns), jnp.int64(now0), jnp.int64(dt))
        ts, tp, td = tscan(ts, torch.from_numpy(h1.astype(np.int64)),
                           torch.from_numpy(h2.astype(np.int64)),
                           torch.from_numpy(ns), now0, dt)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        _same_state(js, ts, str(dt))
        now0 += TN * dt
