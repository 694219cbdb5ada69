"""The port's CUDA kernels and limiter on a card, against the plain
versions on the same inputs (tolerance 0: bit-equal).

Every test here carries the ``cuda`` marker and skips without a CUDA
device. This file imports neither JAX nor the JAX package, so it runs on
a GPU host without them; ``tests/conftest.py`` imports JAX, so run it
there with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
The plain versions are held to the JAX package by the other
``tests/test_torch_*.py`` files on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ratelimiter_tpu_torch import Algorithm, Config, ManualClock, SketchParams
from ratelimiter_tpu_torch.algorithms.sketch import (
    SketchLimiter,
    SketchTokenBucketLimiter,
)
from ratelimiter_tpu_torch.ops import bucket_cuda as bc
from ratelimiter_tpu_torch.ops import sketch_cuda as sc
from ratelimiter_tpu_torch.ops.sketch_kernels import boundary_frac

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _slabs(rng, d, w, dev):
    def slab(lo, hi):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(d, w)).astype(np.int32)).to(dev)

    return slab(-4, 4000), slab(-4, 4000), slab(-4, 40)


@pytest.mark.parametrize("d,w,B", [(3, 128, 48), (4, 65536, 4096),
                                   (1, 16, 1)])
def test_kernels_bit_equal_to_plain(dev, d, w, B):
    rng = np.random.default_rng(d * w + B)
    totals, boundary, cur = _slabs(rng, d, w, dev)
    h1 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B)).to(dev)
    h2 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B) | 1).to(dev)
    frac = torch.tensor(boundary_frac(100, 100 * 999_983 + 331_117, 999_983),
                        dtype=torch.float32, device=dev)
    sc.reset_launch_counts()
    for bnd in (boundary, None):
        est = sc.window_estimate(totals, bnd, frac, h1, h2)
        assert torch.equal(est, sc.window_estimate_plain(totals, bnd, frac,
                                                         h1, h2))
        target = torch.clamp_min(est, 0.0) + 1.0
        target[::3] = 0.0
        a, c, a2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
        sc.cu_update(a, c, bnd, frac, h1, h2, target)
        sc.cu_update_plain(a2, c2, bnd, frac, h1, h2, target)
        assert torch.equal(a, a2) and torch.equal(c, c2)
    add = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32)).to(dev)
    a, c, a2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
    sc.add_update(a, c, h1, h2, add)
    sc.add_update_plain(a2, c2, h1, h2, add)
    torch.cuda.synchronize()
    assert torch.equal(a, a2) and torch.equal(c, c2)
    assert sc.launch_counts() == {"window_estimate": 2, "cu_update": 2,
                                  "add_update": 1}


def test_wrappers_refuse_mixed_devices(dev):
    totals = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    h = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="expected cuda"):
        sc.window_estimate(totals, None, None, h, h)


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW"])
@pytest.mark.parametrize("cu", [True, False])
def test_limiter_on_card_equals_limiter_on_cpu(dev, algo, cu):
    cfg = Config(algorithm=getattr(Algorithm, algo), limit=7, window=6.0,
                 sketch=SketchParams(depth=3, width=128, sub_windows=6,
                                     conservative_update=cu))
    gpu = SketchLimiter(cfg, ManualClock(1e6), device=dev)
    cpu = SketchLimiter(cfg, ManualClock(1e6), device="cpu")
    rng = np.random.default_rng(3)
    for lim in (gpu, cpu):
        lim.set_override("whale", 20)
    for step in range(14):
        ids = rng.integers(1, 24, size=48).astype(np.uint64)
        ns = rng.integers(1, 3, size=48)
        wire = bool(step % 2)
        a = gpu.resolve(gpu.launch_ids(ids, ns, wire=wire))
        b = cpu.resolve(cpu.launch_ids(ids, ns, wire=wire))
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        keys = ["whale"] * 6 + [f"k{i}" for i in range(6)]
        for f in ("allowed", "remaining"):
            np.testing.assert_array_equal(getattr(gpu.allow_batch(keys), f),
                                          getattr(cpu.allow_batch(keys), f))
        if step == 7:
            gpu.reset("whale")
            cpu.reset("whale")
        gpu.clock.advance(0.75)
        cpu.clock.advance(0.75)
    ga, ca = gpu.capture_state()[1], cpu.capture_state()[1]
    for k in ("cur", "slabs", "totals", "slab_period", "last_period"):
        np.testing.assert_array_equal(ga[k], ca[k])
    gpu.close()
    cpu.close()


@pytest.mark.parametrize("d,w,B", [(3, 128, 48), (4, 65536, 4096),
                                   (1, 16, 1)])
def test_bucket_kernels_bit_equal_to_plain(dev, d, w, B):
    """Debt holding zeros, random values and cells within 10^6 of 2^61;
    repeated keys; decays of 0, a moderate value and more than any cell."""
    rng = np.random.default_rng(d * w + B + 1)
    cap = bc.DEBT_CAP

    def slab():
        x = rng.integers(0, 40_000_000, size=(d, w)).astype(np.int64)
        x[rng.random((d, w)) < 0.3] = 0
        hot = rng.random((d, w)) < 0.2
        x[hot] = cap - rng.integers(0, 1_000_000, size=int(hot.sum()))
        return torch.from_numpy(x).to(dev)

    debt, acc = slab(), slab()
    h1 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B)).to(dev)
    h2 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B) | 1).to(dev)
    h1[: B // 2] = h1[B // 2: 2 * (B // 2)]
    h2[: B // 2] = h2[B // 2: 2 * (B // 2)]
    consumed = torch.from_numpy(np.where(
        rng.random(B) < 0.7, rng.integers(1, 1 << 42, size=B), 0)).to(dev)
    bc.reset_launch_counts()
    for decay in (0, 3_333_337, 1 << 62):
        est = bc.bucket_estimate(debt, decay, h1, h2)
        assert torch.equal(est, bc.bucket_estimate_plain(debt, decay, h1, h2))
        a, c, a2, c2 = debt.clone(), acc.clone(), debt.clone(), acc.clone()
        bc.bucket_update(a, c, decay, h1, h2, consumed)
        bc.bucket_update_plain(a2, c2, decay, h1, h2, consumed)
        torch.cuda.synchronize()
        assert torch.equal(a, a2) and torch.equal(c, c2)
    assert bc.launch_counts() == {"bucket_estimate": 3, "bucket_update": 3}


def test_bucket_limiter_on_card_equals_limiter_on_cpu(dev):
    cfg = Config(algorithm=Algorithm.TOKEN_BUCKET, limit=7, window=6.0,
                 sketch=SketchParams(depth=3, width=128))
    gpu = SketchTokenBucketLimiter(cfg, ManualClock(1e6), device=dev)
    cpu = SketchTokenBucketLimiter(cfg, ManualClock(1e6), device="cpu")
    rng = np.random.default_rng(4)
    for lim in (gpu, cpu):
        lim.set_override("whale", 20)
    for step in range(14):
        ids = rng.integers(1, 24, size=48).astype(np.uint64)
        ns = rng.integers(1, 3, size=48)
        wire = bool(step % 2)
        a = gpu.resolve(gpu.launch_ids(ids, ns, wire=wire))
        b = cpu.resolve(cpu.launch_ids(ids, ns, wire=wire))
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        keys = ["whale"] * 6 + [f"k{i}" for i in range(6)]
        for f in ("allowed", "remaining", "retry_after"):
            np.testing.assert_array_equal(getattr(gpu.allow_batch(keys), f),
                                          getattr(cpu.allow_batch(keys), f))
        if step == 7:
            gpu.reset("whale")
            cpu.reset("whale")
        gpu.clock.advance(0.37)
        cpu.clock.advance(0.37)
    ga, ca = gpu.capture_state()[1], cpu.capture_state()[1]
    for k in ("debt", "acc", "rem", "last"):
        np.testing.assert_array_equal(ga[k], ca[k])
    assert gpu.debt_slab_stats() == cpu.debt_slab_stats()
    gpu.close()
    cpu.close()


# Widths below, at and above the chosen tiles, and the config-3 width.
_TILED_WIDTHS = sorted({16, 128, sc.TILE, 65536})


def _batch(rng, kind, B, w, dev):
    """Keys of one kind: random (repeated) keys; ``one_column``: every key
    on one column of every row (h2 = 0); ``zeros``: amounts all 0 (the
    caller zeroes them); ``empty``: B = 0; ``large``: more keys than the
    launch shape takes without clusters."""
    if kind == "empty":
        B = 0
    elif kind == "large":
        B = 4 * sc.CLUSTER_BATCH
    h1 = rng.integers(0, 2 ** 32, size=B)
    h2 = rng.integers(0, 2 ** 32, size=B) | 1
    if kind == "one_column":
        h1[:] = int(rng.integers(0, w))
        h2[:] = 0
    else:
        h1[: B // 2] = h1[B // 2: 2 * (B // 2)]
        h2[: B // 2] = h2[B // 2: 2 * (B // 2)]
    return torch.from_numpy(h1).to(dev), torch.from_numpy(h2).to(dev)


@pytest.mark.parametrize("tiling", [{}, {"cluster": 8},
                                    {"tile": 16, "cluster": 4}],
                         ids=["chosen", "cluster8", "tile16-cluster4"])
@pytest.mark.parametrize("kind", ["random", "one_column", "zeros", "empty",
                                  "large"])
@pytest.mark.parametrize("w", _TILED_WIDTHS)
def test_tiled_updates_bit_equal_to_plain(dev, w, kind, tiling):
    """cu_update (sliding and fixed, negative cells) and bucket_update at
    widths below, at and above the tile, on a batch of keys of each kind,
    under the chosen launch shape (clusters for the large batch) and two
    others, one launch per call; the dense pass runs on every cell even
    when the batch adds nothing."""
    d, B = 4, 4096
    rng = np.random.default_rng(w + len(kind) + len(tiling))
    h1, h2 = _batch(rng, kind, B, w, dev)
    B = h1.shape[0]
    totals, boundary, cur = _slabs(rng, d, w, dev)
    totals[:, 3], boundary[:, 3] = -2, -1
    frac = torch.tensor(boundary_frac(100, 100 * 999_983 + 331_117, 999_983),
                        dtype=torch.float32, device=dev)
    sc.reset_launch_counts()
    bc.reset_launch_counts()
    for bnd in (boundary, None):
        est = sc.window_estimate_plain(totals, bnd, frac, h1, h2)
        target = torch.clamp_min(est, 0.0) + 1.0 + torch.from_numpy(
            rng.random(B).astype(np.float32)).to(dev)
        target[::3] = 0.0
        if kind == "zeros":
            target.zero_()
        a, c, a2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
        sc.cu_update(a, c, bnd, frac, h1, h2, target, **tiling)
        sc.cu_update_plain(a2, c2, bnd, frac, h1, h2, target)
        torch.cuda.synchronize()
        assert torch.equal(a, a2) and torch.equal(c, c2)
        # Cells reading below zero grew, touched or not.
        assert bool(((totals < 0) & (a > totals)).any())
    cap = bc.DEBT_CAP
    debt = torch.from_numpy(np.where(
        rng.random((d, w)) < 0.3, 0,
        rng.integers(0, 40_000_000, size=(d, w)))).to(dev)
    debt[:, ::7] = cap - 5
    acc = debt.flip(1).contiguous()
    consumed = torch.from_numpy(np.where(
        rng.random(B) < 0.7, rng.integers(1, 1 << 42, size=B), 0)).to(dev)
    if kind == "zeros":
        consumed.zero_()
    for decay in (0, 3_333_337):
        a, c, a2, c2 = debt.clone(), acc.clone(), debt.clone(), acc.clone()
        bc.bucket_update(a, c, decay, h1, h2, consumed, **tiling)
        bc.bucket_update_plain(a2, c2, decay, h1, h2, consumed)
        torch.cuda.synchronize()
        assert torch.equal(a, a2) and torch.equal(c, c2)
    assert sc.launch_counts()["cu_update"] == 2
    assert bc.launch_counts()["bucket_update"] == 2


@pytest.mark.parametrize("cluster", [1, 8])
def test_bucket_update_clamps_acc_above_cap_when_asked(dev, cluster):
    """acc cells above 2^61 (only a restore brings them): with clamp_acc
    the kernel clamps every cell, as the plain version does every call."""
    d, w, B = 4, 65536, 4096
    rng = np.random.default_rng(21)
    cap = bc.DEBT_CAP
    h1 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B)).to(dev)
    h2 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B) | 1).to(dev)
    debt = torch.from_numpy(rng.integers(0, 40_000_000, size=(d, w))).to(dev)
    acc = torch.from_numpy(rng.integers(0, 40_000_000, size=(d, w))).to(dev)
    over = torch.from_numpy(rng.random((d, w)) < 0.2).to(dev)
    acc[over] = cap + torch.from_numpy(
        rng.integers(1, 1 << 40, size=(d, w))).to(dev)[over]
    consumed = torch.from_numpy(rng.integers(0, 1 << 42, size=B)).to(dev)
    bc.reset_launch_counts()
    a, c, a2, c2 = debt.clone(), acc.clone(), debt.clone(), acc.clone()
    bc.bucket_update(a, c, 777, h1, h2, consumed, True, cluster=cluster)
    bc.bucket_update_plain(a2, c2, 777, h1, h2, consumed)
    torch.cuda.synchronize()
    assert torch.equal(a, a2) and torch.equal(c, c2)
    assert int(c.max()) == cap
    assert bc.launch_counts()["bucket_update"] == 1


def test_bucket_limiter_restore_above_cap_on_card_equals_cpu(dev):
    """A restored acc above 2^61 marks the limiter; its next step clamps
    acc densely on the card as on the CPU, and the mark clears."""
    cfg = Config(algorithm=Algorithm.TOKEN_BUCKET, limit=7, window=6.0,
                 sketch=SketchParams(depth=3, width=128))
    gpu = SketchTokenBucketLimiter(cfg, ManualClock(1e6), device=dev)
    cpu = SketchTokenBucketLimiter(cfg, ManualClock(1e6), device="cpu")
    rng = np.random.default_rng(6)
    _, arrays, extra = cpu.capture_state()
    acc = np.asarray(arrays["acc"]).copy()
    acc[:, ::5] = bc.DEBT_CAP + 1000
    arrays = dict(arrays, acc=acc)
    for lim in (gpu, cpu):
        lim.restore_state(arrays, extra)
        assert lim._acc_over_cap
    for _ in range(3):
        ids = rng.integers(1, 24, size=48).astype(np.uint64)
        a = gpu.allow_ids(ids)
        b = cpu.allow_ids(ids)
        np.testing.assert_array_equal(a.allowed, b.allowed)
        assert not gpu._acc_over_cap and not cpu._acc_over_cap
        gpu.clock.advance(0.37)
        cpu.clock.advance(0.37)
    ga, ca = gpu.capture_state()[1], cpu.capture_state()[1]
    for k in ("debt", "acc", "rem", "last"):
        np.testing.assert_array_equal(ga[k], ca[k])
    assert ga["acc"].max() == bc.DEBT_CAP
    gpu.close()
    cpu.close()
