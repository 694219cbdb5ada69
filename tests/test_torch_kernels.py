"""The three table kernels' plain versions against the JAX package.

The plain versions (ratelimiter_tpu_torch/ops/sketch_cuda.py) are what a
CPU tensor runs, and what ``chip_smoke.py`` holds each CUDA kernel to on
the card. Here they are held BIT-identical to the JAX package's Pallas
kernels in interpret mode and to its jnp reference path, both jitted as
the JAX limiter runs them (jitting is what makes XLA round
``t + frac*b`` once, as an FMA). Inputs are made with NumPy from a seed.

The CUDA kernels themselves cannot run here: tests/test_torch_cuda.py
holds them to these plain versions on a card (``cuda`` marker).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimiter_tpu.ops import pallas_sketch as jps
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu_torch.ops import sketch_cuda as sc
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk

D, W, B = 3, 128, 48


def _frac(elapsed_us: int, sub_us: int = 1_000_000) -> np.float32:
    """The limiter's boundary weight after ``elapsed_us`` of the period
    (tests/test_torch_ops.py holds it to the JAX reference's)."""
    p = 100
    return np.float32(sc.frac_plain(*tsk.frac_operands(
        p, p * sub_us + elapsed_us, sub_us)))


def _inputs(seed: int, lo: int = -4, hi: int = 4000):
    rng = np.random.default_rng(seed)
    totals = rng.integers(lo, hi, size=(D, W)).astype(np.int32)
    boundary = rng.integers(lo, hi, size=(D, W)).astype(np.int32)
    cur = rng.integers(lo, 40, size=(D, W)).astype(np.int32)
    h1 = rng.integers(0, 2 ** 32, size=B, dtype=np.uint64).astype(np.uint32)
    h2 = (rng.integers(0, 2 ** 32, size=B, dtype=np.uint64)
          | 1).astype(np.uint32)
    return rng, totals, boundary, cur, h1, h2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _th(h):
    return torch.from_numpy(h.astype(np.int64))


_jit_est = jax.jit(jps.window_estimate)
_jit_cu = jax.jit(jps.cu_update)
_jit_add = jax.jit(jps.add_update)


def _jnp_estimate(totals, boundary, elapsed_us, h1, h2, weighted):
    """The jnp reference path's estimate (sketch_kernels._estimate in the
    direct regime), fed a state whose boundary slab is valid, at
    ``elapsed_us`` into the current period."""
    S, SW, sub = 4, 4, 1_000_000
    p = 100
    slabs = np.zeros((S, D, W), np.int32)
    slabs[p % S] = boundary
    periods = np.full(S, -(1 << 40), np.int64)
    periods[p % S] = p - SW
    state = {"totals": jnp.asarray(totals), "slabs": jnp.asarray(slabs),
             "slab_period": jnp.asarray(periods)}
    cols = jsk._columns(jnp.asarray(h1), jnp.asarray(h2), D, W)

    @jax.jit
    def f(state, cols, now_us):
        return jsk._estimate(state, cols, jnp.int64(p), now_us, sub_us=sub,
                             SW=SW, S=S, weighted=weighted)[0]

    return np.asarray(f(state, cols, jnp.int64(p * sub + elapsed_us)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("weighted", [True, False])
def test_window_estimate_plain_matches_pallas_and_jnp(seed, weighted):
    _, totals, boundary, _, h1, h2 = _inputs(seed)
    elapsed = 123_457 + 100_003 * seed
    frac = _frac(elapsed)
    got = sc.window_estimate_plain(
        _t(totals), _t(boundary) if weighted else None,
        torch.tensor(frac) if weighted else None, _th(h1), _th(h2)).numpy()
    bop = boundary if weighted else np.zeros_like(boundary)
    want = np.asarray(_jit_est(jnp.asarray(totals), jnp.asarray(bop),
                               jnp.float32(frac if weighted else 0.0),
                               jnp.asarray(h1), jnp.asarray(h2)))
    np.testing.assert_array_equal(got, want)
    # The jnp path clamps at 0; so does the port's caller (_estimate).
    np.testing.assert_array_equal(
        np.maximum(got, 0.0),
        _jnp_estimate(totals, boundary, elapsed, h1, h2, weighted))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("weighted", [True, False])
def test_cu_update_plain_matches_pallas(seed, weighted):
    rng, totals, boundary, cur, h1, h2 = _inputs(seed + 10)
    frac = _frac(654_321 - 50_000 * seed)
    est = np.maximum(sc.window_estimate_plain(
        _t(totals), _t(boundary) if weighted else None,
        torch.tensor(frac), _th(h1), _th(h2)).numpy(), 0)
    target = np.where(rng.random(B) < 0.7,
                      est + rng.integers(1, 4, size=B), 0).astype(np.float32)
    t, c = _t(totals.copy()), _t(cur.copy())
    sc.cu_update(t, c, _t(boundary) if weighted else None,
                 torch.tensor(frac) if weighted else None, _th(h1), _th(h2),
                 torch.from_numpy(target))
    bop = boundary if weighted else np.zeros_like(boundary)
    jt, jc = _jit_cu(jnp.asarray(totals), jnp.asarray(cur), jnp.asarray(bop),
                     jnp.float32(frac if weighted else 0.0), jnp.asarray(h1),
                     jnp.asarray(h2), jnp.asarray(target))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert (t.numpy() != totals).any()


@pytest.mark.parametrize("seed", range(3))
def test_add_update_plain_matches_pallas(seed):
    rng, totals, _, cur, h1, h2 = _inputs(seed + 20)
    h1[: B // 4] = h1[B // 4: B // 2]      # colliding keys add up
    h2[: B // 4] = h2[B // 4: B // 2]
    add = np.where(rng.random(B) < 0.7, rng.integers(1, 5, size=B),
                   0).astype(np.int32)
    t, c = _t(totals.copy()), _t(cur.copy())
    sc.add_update(t, c, _th(h1), _th(h2), torch.from_numpy(add))
    jt, jc = _jit_add(jnp.asarray(totals), jnp.asarray(cur), jnp.asarray(h1),
                      jnp.asarray(h2), jnp.asarray(add))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_fma_rounding_pinned_to_the_jax_reference():
    """Where one rounding (FMA) and two roundings of t + frac*b differ,
    the JAX reference gives the FMA value, and so does the port."""
    _, totals, boundary, _, _, _ = _inputs(7, lo=0, hi=1 << 20)
    frac = _frac(123_457)
    ref = np.asarray(jax.jit(
        lambda t, b, f: t.astype(jnp.float32) + f * b.astype(jnp.float32))(
            jnp.asarray(totals), jnp.asarray(boundary), jnp.float32(frac)))
    two_roundings = totals.astype(np.float32) + frac * boundary.astype(
        np.float32)
    differs = ref != two_roundings
    assert differs[0].any()
    # One key per cell of row 0 reads exactly the dense combine there.
    h1 = np.arange(W, dtype=np.uint32)
    h2 = np.full(W, 1, np.uint32)
    got = sc.window_estimate_plain(
        _t(totals[:1].copy()), _t(boundary[:1].copy()), torch.tensor(frac),
        _th(h1), _th(h2)).numpy()
    np.testing.assert_array_equal(got, ref[0])
    assert (got != two_roundings[0])[differs[0]].all()


def test_cu_dense_pass_grows_untouched_negative_cell():
    """After a reset a cell may hold -1; with boundary 3 weighted ~0.1 it
    reads -0.7, so the dense pass raises it even though no key maps there:
    totals[5] -1 -> 0 and cur[5] 0 -> 1, as in the JAX reference."""
    w = 16
    totals = np.zeros((1, w), np.int32)
    totals[0, 5] = -1
    boundary = np.zeros((1, w), np.int32)
    boundary[0, 5] = 3
    cur = np.zeros((1, w), np.int32)
    frac = _frac(900_000)
    h1 = np.array([2], np.uint32)
    h2 = np.array([1], np.uint32)
    target = np.array([1.0], np.float32)
    t, c = _t(totals.copy()), _t(cur.copy())
    sc.cu_update(t, c, _t(boundary), torch.tensor(frac), _th(h1), _th(h2),
                 torch.from_numpy(target))
    jt, jc = _jit_cu(jnp.asarray(totals), jnp.asarray(cur),
                     jnp.asarray(boundary), jnp.float32(frac),
                     jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(target))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert t[0, 5] == 0 and c[0, 5] == 1
    assert t[0, 2] == 1 and c[0, 2] == 1


@pytest.mark.parametrize("case", ["small_frac", "large_cells", "mixed"])
def test_fma_f32_is_correctly_rounded(case):
    """The plain versions' FMA equals XLA's (a hardware FMA) on every
    input, including fracs far below 1/2 (finer than 2^-24) and cells far
    past 2^24, where one float64 rounding alone would not be enough."""
    rng = np.random.default_rng(["small_frac", "large_cells",
                                 "mixed"].index(case))
    n = 1 << 16
    frac = rng.random(n).astype(np.float32)
    if case != "large_cells":
        frac *= np.float32(2.0) ** rng.integers(-40, 0, size=n).astype(
            np.float32)
    hi = 1 << 31 if case != "small_frac" else 1 << 12
    b = rng.integers(-hi, hi, size=n).astype(np.int32)
    t = rng.integers(-hi, hi, size=n).astype(np.int32)
    want = np.asarray(jax.jit(
        lambda f, b, t: t.astype(jnp.float32) + f * b.astype(jnp.float32))(
            frac, b, t))
    got = sc.fma_f32(torch.from_numpy(frac), torch.from_numpy(b).float(),
                     torch.from_numpy(t).float()).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_check_operands_and_never_fall_back():
    _, totals, boundary, cur, h1, h2 = _inputs(2)
    with pytest.raises(TypeError):
        sc.window_front(_t(totals.astype(np.int64)), (_th(h1), _th(h2)))
    with pytest.raises(ValueError, match="frac is required"):
        sc.cu_update(_t(totals), _t(cur), _t(boundary), None, _th(h1),
                     _th(h2), torch.zeros(B, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        sc.add_update(_t(totals), _t(cur), _th(h1), _th(h2),
                      torch.zeros(2 * B, dtype=torch.int32)[::2])
    # A tensor on a device that is neither the CPU nor CUDA has no kernel
    # and no plain fallback: the wrapper raises.
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sc.window_front(torch.empty((D, W), dtype=torch.int32, device=meta),
                        (torch.empty(B, dtype=torch.int64, device=meta),
                         torch.empty(B, dtype=torch.int64, device=meta)))


def test_plain_versions_do_not_count_launches():
    sc.reset_launch_counts()
    _, totals, boundary, cur, h1, h2 = _inputs(3)
    sc.window_front(_t(totals), (_th(h1), _th(h2)))
    sc.add_update(_t(totals), _t(cur), _th(h1), _th(h2),
                  torch.ones(B, dtype=torch.int32))
    n = torch.ones(B, dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.float32)
    sc.add_back(_t(totals), _t(cur), _th(h1), _th(h2), n, ones, ones, 4)
    sc.window_admit(_th(h1), ones, ones, ones, 4)
    assert sc.launch_counts() == {"window_estimate": 0, "cu_update": 0,
                                  "add_update": 0, "add_back": 0,
                                  "admit": 0}


@pytest.mark.parametrize("w,batch,given,want", [
    (65536, 4096, {}, (sc.TILE, 1)),
    (65536, sc.CLUSTER_BATCH, {}, (sc.TILE, 1)),
    (65536, 2 * sc.CLUSTER_BATCH, {}, (sc.TILE, sc.CLUSTER)),
    (16, 2 * sc.CLUSTER_BATCH, {}, (16, 1)),
    (4 * sc.TILE, 1 << 20, {}, (sc.TILE, min(sc.CLUSTER, 4))),
    (65536, 4096, {"tile": 16, "cluster": 4}, (16, 4)),
])
def test_tiled_updates_launch_shape(w, batch, given, want):
    """cu_update's and bucket_update's launch shape: the tile clamps to the
    row; clusters only above CLUSTER_BATCH keys (every block would read
    every key) and never wider than the row's tiles."""
    assert sc.tiling(w, batch, **given) == want
