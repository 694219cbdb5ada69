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
from ratelimiter_tpu_torch.ops.hashing import split_hash, splitmix64
from ratelimiter_tpu_torch.ops.policy_kernels import PAD_KEY, pack_halves_host
from ratelimiter_tpu_torch.ops.sketch_kernels import frac_operands

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _valid_boundary(slab, slot: int = 0, stale: bool = False):
    """A boundary for ``slab`` 0.331117 s into a 999,983 us sub-window of
    period 100 of a 4-slot ring (a stale slab holds another period)."""
    p, sub_us = 100, 999_983
    periods = torch.full((4,), -(1 << 40), dtype=torch.int64,
                         device=slab.device)
    periods[slot] = p - 4 - int(stale)
    return sc.Boundary(slab, periods, slot, p - 4,
                       *frac_operands(p, p * sub_us + 331_117, sub_us))


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
    sc.reset_launch_counts()
    for b in (_valid_boundary(boundary), None):
        _, _, est, frac, _, _ = sc.window_front(totals, (h1, h2), boundary=b)
        _, _, want, want_frac, _, _ = sc.window_front_plain(
            totals, (h1, h2), boundary=b)
        assert torch.equal(est, want)
        assert (frac is None) == (want_frac is None)
        if frac is not None:
            assert torch.equal(frac, want_frac)
        bnd = None if b is None else b.slab
        target = est + 1.0
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
                                  "add_update": 1, "add_back": 0,
                                  "admit": 0, "hh_update": 0,
                                  "add_back [cascade]": 0,
                                  "admit [cascade]": 0,
                                  "hh_update [fused]": 0,
                                  "window_reset": 0}


def test_wrappers_refuse_mixed_devices(dev):
    totals = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    h = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="expected cuda"):
        sc.window_front(totals, (h, h))


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
        est = bc.bucket_front(debt, decay, (h1, h2))[2]
        assert torch.equal(est, bc.bucket_estimate_plain(debt, decay, h1, h2))
        a, c, a2, c2 = debt.clone(), acc.clone(), debt.clone(), acc.clone()
        bc.bucket_update(a, c, decay, h1, h2, consumed)
        bc.bucket_update_plain(a2, c2, decay, h1, h2, consumed)
        torch.cuda.synchronize()
        assert torch.equal(a, a2) and torch.equal(c, c2)
    assert bc.launch_counts() == {"bucket_estimate": 3, "bucket_update": 3,
                                  "admit": 0, "admit [cascade]": 0}


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
    frac = sc.frac_plain(*frac_operands(100, 100 * 999_983 + 331_117,
                                        999_983)).to(dev)
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


# ------------------------------------------------------------- the fronts


_SEED = 0x5BD1E995
_INV_C1 = pow(0xBF58476D1CE4E5B9, -1, 1 << 64)
_INV_C2 = pow(0x94D049BB133111EB, -1, 1 << 64)
_M64 = (1 << 64) - 1


def _unmix(x: int) -> int:
    """The inverse of splitmix64 on one u64 (each xorshift undone to its
    fixpoint, each multiplier by its inverse mod 2^64)."""
    def unshift(y, s):
        z = y
        for _ in range(64 // s + 1):
            z = y ^ (z >> s)
        return z
    x = unshift(x, 31) * _INV_C2 & _M64
    x = unshift(x, 27) * _INV_C1 & _M64
    return (unshift(x, 30) - 0x9E3779B97F4A7C15) & _M64


def _front_keys(rng, lane: str, B: int, pad_query: bool, dev):
    """Keys of one lane (raw ids, hashes, or the halves they split into)
    with the sketch seed, repeated keys among them, and (``pad_query``)
    key 0 on the halves whose packed query is PAD_KEY. Returns the
    operand, ``premix`` and the packed queries (host)."""
    ids = rng.integers(0, 1 << 63, size=B, dtype=np.int64).view(np.uint64)
    ids[: B // 2] = ids[B // 2: 2 * (B // 2)]
    if pad_query and B:
        # The split hash 0xFFFFFFFF_7FFFFFFF: h1 = 0x7FFFFFFF and h2 =
        # 0xFFFFFFFF, so (h1 << 32) | h2 == PAD_KEY.
        h = _unmix(0xFFFFFFFF7FFFFFFF) ^ _SEED
        ids[0] = _unmix(h) if lane == "premix" else h
    h64 = splitmix64(ids) if lane == "premix" else ids
    h1, h2 = split_hash(h64, _SEED)
    q = pack_halves_host(h1, h2)
    if lane == "halves":
        keys = (torch.from_numpy(h1.astype(np.int64)).to(dev),
                torch.from_numpy(h2.astype(np.int64)).to(dev))
    else:
        keys = torch.from_numpy(ids.view(np.int64)).to(dev)
    return keys, lane == "premix", q


def _front_policy(rng, kind: str, q: np.ndarray, P: int, dev):
    """A device table of capacity P: none, sparse (a few of the batch's
    keys and random ones, padded with PAD_KEY), or full (P real keys, the
    batch's largest among them, so the last row is hit)."""
    if kind == "none":
        return None
    real = np.unique(q[q != PAD_KEY])
    if kind == "full":
        mine = real[-(P // 2):]
        top = mine[-1] if len(mine) else PAD_KEY - 1
        fill = np.setdiff1d(rng.integers(-(1 << 63), top, size=4 * P,
                                         dtype=np.int64), mine)
        keys = np.sort(np.concatenate([fill[:P - len(mine)], mine]))
    else:
        keys = np.unique(np.concatenate([real[: P // 8], rng.integers(
            -(1 << 63), PAD_KEY, size=P // 8, dtype=np.int64)]))
        keys = np.concatenate([keys, np.full(P - len(keys), PAD_KEY,
                                             dtype=np.int64)])
    limits = np.full(P, 100, dtype=np.int64)
    limits[keys != PAD_KEY] = rng.integers(1, 1 << 20, size=int(
        (keys != PAD_KEY).sum()))
    return {"key": torch.from_numpy(keys).to(dev),
            "limit": torch.from_numpy(limits).to(dev)}


def _same(got, want) -> bool:
    return all((a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and torch.equal(a, b)) for a, b in zip(got, want))


@pytest.mark.parametrize("lane", ["premix", "hashed", "halves"])
def test_fronts_bit_equal_to_plain(dev, lane):
    """window_front and bucket_front against their plain versions on
    every output, for each policy table (none, sparse, full with its last
    row hit, sparse with a PAD_KEY query) in shared memory (1024 rows) and
    in global memory (2^14 rows), at B = 0, 1, 4096 and 2^20; windowed
    sliding with a valid and a stale boundary and fixed; bucket decays of
    0, a moderate value and more than any cell on debts near 2^61; and
    the estimate-only form (the resets). One launch per call."""
    for policy in ("none", "sparse", "full", "pad"):
        for B in (0, 1, 4096, 1 << 20):
            _check_fronts(dev, lane, policy, B)


def _check_fronts(dev, lane, policy, B):
    d, w = 4, 65536
    rng = np.random.default_rng(B + len(lane) * 7 + len(policy))
    keys, premix, q = _front_keys(rng, lane, B, policy == "pad", dev)
    n = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32)).to(dev)
    totals, boundary, _ = _slabs(rng, d, w, dev)
    debt = torch.from_numpy(np.where(
        rng.random((d, w)) < 0.3, 0,
        rng.integers(0, 1 << 40, size=(d, w)))).to(dev)
    debt[:, ::5] = bc.DEBT_CAP - 7
    sc.reset_launch_counts()
    bc.reset_launch_counts()
    calls = 0
    for P in ((1024,) if policy == "none" else (1024, 1 << 14)):
        pol = _front_policy(rng, policy, q, P, dev)
        kw = dict(premix=premix, seed=_SEED, policy=pol, limit=100)
        for b in (_valid_boundary(boundary, slot=2),
                  _valid_boundary(boundary, slot=2, stale=True), None):
            for args in ((n,), ()):
                got = sc.window_front(totals, keys, *args, boundary=b, **kw)
                want = sc.window_front_plain(totals, keys, *args,
                                             boundary=b, **kw)
                torch.cuda.synchronize()
                assert _same(got, want)
                calls += 1
        for decay in (0, 3_333_337, 1 << 62):
            for args in ((n,), ()):
                got = bc.bucket_front(debt, decay, keys, *args, **kw)
                want = bc.bucket_front_plain(debt, decay, keys, *args, **kw)
                torch.cuda.synchronize()
                assert _same(got, want)
    assert sc.launch_counts()["window_estimate"] == calls
    assert bc.launch_counts()["bucket_estimate"] == calls


def test_front_launch_shapes_bit_equal(dev, monkeypatch):
    """The block sizes chip_smoke.py times (64, 128, 256, set through
    ``sketch_cuda.FRONT_THREADS``) give the same outputs."""
    for threads in (64, 128, 256):
        monkeypatch.setattr(sc, "FRONT_THREADS", threads)
        rng = np.random.default_rng(threads)
        keys, _, q = _front_keys(rng, "premix", 4096, True, dev)
        n = torch.ones(4096, dtype=torch.int32, device=dev)
        totals, boundary, _ = _slabs(rng, 4, 65536, dev)
        pol = _front_policy(rng, "sparse", q, 1024, dev)
        kw = dict(premix=True, seed=_SEED, policy=pol, limit=100)
        b = _valid_boundary(boundary)
        assert _same(sc.window_front(totals, keys, n, boundary=b, **kw),
                     sc.window_front_plain(totals, keys, n, boundary=b,
                                           **kw))
        debt = torch.from_numpy(rng.integers(0, 1 << 40,
                                             size=(4, 65536))).to(dev)
        assert _same(bc.bucket_front(debt, 77, keys, n, **kw),
                     bc.bucket_front_plain(debt, 77, keys, n, **kw))


def test_fronts_at_other_depths_bit_equal(dev):
    """The fronts' generic build (any depth but the shipped 4: 1, 3, 5
    and 16) against the plain versions, with a policy table and a PAD_KEY
    query."""
    for d in (1, 3, 5, 16):
        _check_depth(dev, d)


def _check_depth(dev, d):
    rng = np.random.default_rng(d)
    keys, _, q = _front_keys(rng, "premix", 4096, True, dev)
    n = torch.from_numpy(rng.integers(0, 4, size=4096).astype(
        np.int32)).to(dev)
    totals, boundary, _ = _slabs(rng, d, 1024, dev)
    debt = torch.from_numpy(rng.integers(0, 1 << 40, size=(d, 1024))).to(dev)
    kw = dict(premix=True, seed=_SEED, limit=100,
              policy=_front_policy(rng, "pad", q, 1024, dev))
    for b in (_valid_boundary(boundary), None):
        assert _same(sc.window_front(totals, keys, n, boundary=b, **kw),
                     sc.window_front_plain(totals, keys, n, boundary=b, **kw))
    for decay in (0, 1 << 39):
        assert _same(bc.bucket_front(debt, decay, keys, n, **kw),
                     bc.bucket_front_plain(debt, decay, keys, n, **kw))


# ------------------------------------------------------ the step's backs


def _back_keys(rng, kind: str, B: int):
    """int64 (B,) h1 values: Zipf ids' low halves, one key for the whole
    batch, or "wide" values (the halves lane takes h1 from a caller) whose
    low 32 bits collide across different high bits, with the all-ones
    value (the hash table's empty mark) among them."""
    if kind == "one key":
        return np.full(B, 0x1234567, dtype=np.int64)
    if kind == "wide":
        h = rng.integers(0, 16, size=B) + (rng.integers(0, 3, size=B) << 32)
        h[::7] = -1
        return h.astype(np.int64)
    return (rng.zipf(1.1, size=B) % 1_000_003).astype(np.int64)


def _back_operands(rng, kind: str, B: int, dev):
    h1 = torch.from_numpy(_back_keys(rng, kind, B)).to(dev)
    h2 = torch.from_numpy(rng.integers(0, 2 ** 32, size=B) | 1).to(dev)
    n = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32)).to(dev)
    avail = torch.from_numpy((rng.integers(0, 40, size=B)
                              + rng.random(B)).astype(np.float32)).to(dev)
    est = torch.from_numpy((rng.random(B) * 30).astype(np.float32)).to(dev)
    return h1, h2, n, n.to(torch.float32), avail, est


@pytest.mark.parametrize("B,kind", [
    (0, "zipf"), (1, "zipf"), (8, "zipf"), (4096, "zipf"), (4096, "one key"),
    (4096, "wide"), (sc.ADMIT_CAPACITY, "zipf"),
    (2 * sc.ADMIT_CAPACITY, "zipf")])
@pytest.mark.parametrize("iters", [1, 4])
def test_backs_bit_equal_to_plain(dev, B, kind, iters):
    """add_back, window_admit and bucket_admit against their plain versions
    on mixed request counts (0 is padding); up to ADMIT_CAPACITY keys each
    is ONE launch, above it (the limiter's next pad) the composed back:
    the plain admission on the card and the standalone add_update."""
    rng = np.random.default_rng(B + iters + len(kind))
    h1, h2, n, n_f, avail, est = _back_operands(rng, kind, B, dev)
    totals, _, cur = _slabs(rng, 4, 65536, dev)
    sc.reset_launch_counts()
    bc.reset_launch_counts()
    a, c, a2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
    got = sc.add_back(a, c, h1, h2, n, n_f, avail, iters)
    want = sc.add_back_plain(a2, c2, h1, h2, n, n_f, avail, iters)
    torch.cuda.synchronize()
    assert _same([*got, a, c], [*want, a2, c2])
    assert _same(sc.window_admit(h1, est, n_f, avail, iters),
                 sc.window_admit_plain(h1, est, n_f, avail, iters))
    units = n.to(torch.int64) * 1_000_000 + (n > 2).to(torch.int64)
    b_avail = (avail.double() * 1e6).to(torch.int64)
    assert _same(bc.bucket_admit(h1, units, b_avail, iters, 5, 3),
                 bc.bucket_admit_plain(h1, units, b_avail, iters, 5, 3))
    fused = int(B <= sc.ADMIT_CAPACITY)
    assert sc.launch_counts() == {"window_estimate": 0, "cu_update": 0,
                                  "add_update": 1, "add_back": fused,
                                  "admit": fused, "hh_update": 0,
                                  "add_back [cascade]": 0,
                                  "admit [cascade]": 0,
                                  "hh_update [fused]": 0,
                                  "window_reset": 0}
    assert bc.launch_counts() == {"bucket_estimate": 0, "bucket_update": 0,
                                  "admit": fused, "admit [cascade]": 0}


def test_bucket_admit_wrapping_retry_on_card(dev):
    """A deficit whose product with rate_den wraps int64, floor divisions
    of negative values, and int64 units past 2^24: the kernel's uint64
    arithmetic gives torch's bits."""
    rng = np.random.default_rng(17)
    B = 512
    h1 = torch.from_numpy(rng.integers(0, 24, size=B)).to(dev)
    units = torch.from_numpy(rng.integers(0, 1 << 41, size=B)).to(dev)
    units[::5] = 3 * ((1 << 24) + 1)
    avail = torch.from_numpy(rng.integers(0, 1 << 42, size=B)).to(dev)
    for num, den in ((7, 6), (3, (1 << 62) + 11), (1, 1)):
        for iters in (1, 4):
            assert _same(bc.bucket_admit(h1, units, avail, iters, num, den),
                         bc.bucket_admit_plain(h1, units, avail, iters, num,
                                               den))


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_reset_between_inflight_windows_on_card(dev, algo):
    """A reset issued from another thread (as the door's executor issues
    it) between two launched, unresolved windows lands between them in
    stream order: the card is held busy so both windows are still queued
    when the reset enqueues, and results and state equal the same
    sequence on the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    cfg = Config(algorithm=getattr(Algorithm, algo), limit=7, window=6.0,
                 sketch=SketchParams(depth=3, width=128, sub_windows=6))
    cls = (SketchTokenBucketLimiter if algo == "TOKEN_BUCKET"
           else SketchLimiter)
    gpu = cls(cfg, ManualClock(1e6), device=dev)
    cpu = cls(cfg, ManualClock(1e6), device="cpu")
    ids = np.array([5] * 12 + list(range(12)), dtype=np.uint64)
    key = np.array([_unmix(int(h)) for h in gpu._hash(["whale"])],
                   dtype=np.uint64)
    whale = np.concatenate([key.repeat(9), ids])
    want = [cpu.allow_ids(whale)]
    cpu.reset("whale")
    want.append(cpu.allow_ids(whale))
    with ThreadPoolExecutor(1) as other:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e8))           # ~0.1 s of device time
        first = gpu.launch_ids(whale, wire=True)
        other.submit(gpu.reset, "whale").result()
        second = gpu.launch_ids(whale)
        got = [gpu.resolve(first), gpu.resolve(second)]
    for a, b in zip(got, want):
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # The reset freed the whale's quota for the second window.
    assert not want[0].allowed[:9].all() and want[1].allowed[:7].all()
    ga, ca = gpu.capture_state()[1], cpu.capture_state()[1]
    for k in ca:
        np.testing.assert_array_equal(ga[k], ca[k], err_msg=k)
    gpu.close()
    cpu.close()


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_door_on_card_matches_cpu_replay(dev, algo):
    """The port's server on the card with the micro-batcher at its
    defaults, driven by 4 pipelining connections from a child process
    (chip_smoke.check_door): every frame's answer and the final state
    bit-identical to a CPU replay of the windows it launched, fewer
    dispatches than frames, an admission launch for every update."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    cfg = Config(algorithm=getattr(Algorithm, algo), limit=20, window=2.0,
                 sketch=SketchParams(depth=4, width=4096, sub_windows=4))
    if algo == "TOKEN_BUCKET":
        kw = dict(counters=[bc], space="c2",
                  required=("bucket_estimate", "admit", "bucket_update"),
                  same=("admit", "bucket_update"))
    else:
        kw = dict(counters=[sc],
                  required=("window_estimate", "admit", "cu_update"),
                  same=("admit", "cu_update"))
    out = chip_smoke.check_door(torch, cfg, algo, conns=4, frames=24,
                                n_ids=512, n_keys=64, **kw)
    assert out["dispatches"] < out["frames"] == 96


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_live_updates_with_tickets_in_flight_on_card(dev, algo):
    """update_window (the ring migration, on the card) and update_limit
    (the bucket's debt clamp, on the card) with tickets in flight: every
    result and the state after each update equal the same sequence on the
    CPU, and the state tensors stay on the card."""
    cfg = Config(algorithm=getattr(Algorithm, algo), limit=9, window=6.0,
                 sketch=SketchParams(depth=3, width=256, sub_windows=6))
    cls = (SketchTokenBucketLimiter if algo == "TOKEN_BUCKET"
           else SketchLimiter)
    gpu = cls(cfg, ManualClock(1e6), device=dev)
    cpu = cls(cfg, ManualClock(1e6), device="cpu")
    rng = np.random.default_rng(3)
    updates = [("update_window", 4.5), ("update_limit", 4),
               ("update_window", 13.0), ("update_limit", 20)]
    for name, arg in updates:
        pending = []
        for _ in range(3):
            ids = rng.integers(0, 40, 64).astype(np.uint64)
            pending.append((gpu.launch_ids(ids), cpu.launch_ids(ids)))
        torch.cuda._sleep(int(2e7))          # keep them queued
        getattr(gpu, name)(arg)
        getattr(cpu, name)(arg)
        for tg, tc in pending:
            a, b = gpu.resolve(tg), cpu.resolve(tc)
            for f in ("allowed", "remaining", "retry_after", "reset_at"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        ga, ca = gpu.capture_state()[1], cpu.capture_state()[1]
        for k in ca:
            np.testing.assert_array_equal(ga[k], ca[k], err_msg=k)
        for k in ("debt", "acc", "cur", "slabs", "totals"):
            if k in gpu._state:
                assert gpu._state[k].device.type == "cuda", k
        gpu.clock.advance(0.8)
        cpu.clock.advance(0.8)
    gpu.close()
    cpu.close()


def test_migrate_window_on_card_equals_cpu(dev):
    """The migration's scatters (index_add_ over int32, an int64 amax
    scatter) and floor division on the card, on a ring holding _NEVER
    slots and negative cells, equal the CPU's."""
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk

    old = Config(algorithm=Algorithm.SLIDING_WINDOW, limit=9, window=60.0,
                 sketch=SketchParams(depth=4, width=4096, sub_windows=60))
    new = Config(algorithm=Algorithm.SLIDING_WINDOW, limit=9, window=45.0,
                 sketch=SketchParams(depth=4, width=4096, sub_windows=60))
    rng = np.random.default_rng(7)
    p_last = 1_700_000_000
    periods = rng.choice(np.concatenate([np.arange(p_last - 62, p_last + 1),
                                         [sk._NEVER] * 8]), 60)
    state = {
        "cur": rng.integers(-9, 90, (4, 4096)).astype(np.int32),
        "slabs": rng.integers(-9, 90, (60, 4, 4096)).astype(np.int32),
        "totals": rng.integers(-9, 900, (4, 4096)).astype(np.int32),
        "slab_period": periods.astype(np.int64),
        "last_period": np.asarray(p_last, np.int64),
    }
    migrate = sk.build_migrate(old, new)
    now_us = p_last * 1_000_000 + 400_000
    want = migrate({k: torch.from_numpy(v) for k, v in state.items()},
                   now_us)
    got = migrate({k: torch.from_numpy(v).to(dev)
                   for k, v in state.items()}, now_us)
    for k in want:
        assert got[k].device.type == "cuda", k
        assert torch.equal(got[k].cpu(), want[k]), k


def test_persistent_wrapper_keeps_the_kernel_path(dev, tmp_path):
    """Behind the persistence wrapper the micro-batcher still takes the
    raw-id lane: the same frames launch the same kernels, as many times,
    with and without the wrapper."""
    import asyncio

    from ratelimiter_tpu_torch import PersistenceSpec
    from ratelimiter_tpu_torch.observability.metrics import Registry
    from ratelimiter_tpu_torch.persistence import PersistenceManager
    from ratelimiter_tpu_torch.serving.batcher import MicroBatcher

    cfg = Config(algorithm=Algorithm.SLIDING_WINDOW, limit=9, window=6.0,
                 sketch=SketchParams(depth=3, width=256, sub_windows=6))
    frames = [np.arange(i * 64, i * 64 + 64, dtype=np.uint64) % 50
              for i in range(6)]

    async def serve(lim):
        b = MicroBatcher(lim, registry=Registry())
        assert b._hashed_lane
        outs = await asyncio.gather(*(
            b.submit_hashed_nowait(f, np.ones(64, np.int64))
            for f in frames))
        await b.drain()
        b.close()
        return outs

    counts, results = [], []
    for wrap in (False, True):
        lim = SketchLimiter(cfg, ManualClock(1e6), device=dev)
        mgr = None
        if wrap:
            mgr = PersistenceManager(PersistenceSpec(dir=str(tmp_path)),
                                     registry=Registry())
            lim = mgr.wrap(lim)
            mgr.attach([lim])
            mgr.recover()
        torch.cuda.synchronize()
        sc.reset_launch_counts()
        results.append(asyncio.run(serve(lim)))
        torch.cuda.synchronize()
        counts.append(sc.launch_counts())
        if mgr is not None:
            mgr.stop(final_snapshot=False)
        lim.close()
    assert counts[0] == counts[1] and counts[0]["window_estimate"] > 0
    assert sum(len(r.allowed) for r in results[0]) == 6 * 64


# ------------------------------------------ the heavy-hitter side table


def _side_batch(rng, kind: str, B: int, K: int):
    """(h1, h2) int64 (B,) for the side-table kernels: Zipf ids' halves,
    all keys on one slot (h1 = 5 + j*K, a few distinct), or Zipf with a
    key whose h1 is 0 among them."""
    if kind == "one slot":
        h1 = 5 + K * rng.integers(0, 6, size=B)
    else:
        h1, _ = split_hash(splitmix64(
            (rng.zipf(1.1, size=B) % 1_000_003).astype(np.uint64)),
            0x5BD1E995)
        h1 = h1.astype(np.int64)
        if kind == "h1 zero":
            h1[::5] = 0
    h2 = rng.integers(0, 2 ** 32, size=B) | 1
    return h1.astype(np.int64), h2.astype(np.int64)


def _side_state(rng, h1, K: int, S: int, dev) -> dict:
    """hh_* tensors on ``dev``: a third of the batch's slots owned by
    their key (so owned and free slots both occur), random counts and
    idle clocks."""
    owner = np.zeros(K, np.int64)
    owned = np.unique(h1[: max(1, len(h1) // 3)])
    owner[owned & (K - 1)] = owned
    owner[(np.arange(K) % 7) == 3] = rng.integers(1, 2 ** 32, size=len(
        owner[(np.arange(K) % 7) == 3]))
    st = {"hh_owner": owner, "hh_owner2": np.where(owner != 0, 77, 0),
          "hh_cur": rng.integers(-2, 30, size=K).astype(np.int32),
          "hh_slabs": rng.integers(-2, 60, size=(S, K)).astype(np.int32),
          "hh_totals": rng.integers(-2, 90, size=K).astype(np.int32),
          "hh_last": rng.integers(-5, 5, size=K).astype(np.int64)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in st.items()}


_SIDE_BATCHES = [(0, "zipf"), (1, "zipf"), (48, "zipf"), (4096, "zipf"),
                 (4096, "one slot"), (4096, "h1 zero"),
                 (sc.ADMIT_CAPACITY, "zipf"), (2 * sc.ADMIT_CAPACITY, "zipf")]


@pytest.mark.parametrize("K,B,kind", [
    (K, B, kind) for K in (16, 1024) for B, kind in _SIDE_BATCHES]
    + [(1 << 22, 0, "zipf"), (1 << 22, 4096, "zipf")])
def test_side_table_kernels_bit_equal_to_plain(dev, K, B, kind):
    """The front, both backs and hh_update with the side table against
    their plain versions: every output and every slab and hh_* tensor.
    Up to ADMIT_CAPACITY keys each back is one launch; above it the
    composed back runs, and hh_update launches at every size. The
    largest table the config accepts (2^22 slots) on B = 0 and 4096."""
    rng = np.random.default_rng(B + K + len(kind))
    S, d, w = 4, 4, 1024
    k1, k2 = _side_batch(rng, kind, B, K)
    h1, h2 = torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev)
    n = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32)).to(dev)
    totals, boundary, cur = _slabs(rng, d, w, dev)
    hh = _side_state(rng, k1, K, S, dev)
    sc.reset_launch_counts()
    for bnd in (_valid_boundary(boundary), _valid_boundary(boundary,
                                                           stale=True), None):
        side = sc.SideTable(hh["hh_owner"], hh["hh_totals"],
                            hh["hh_slabs"][0] if bnd is not None else None)
        got = sc.window_front(totals, (h1, h2), n, boundary=bnd, limit=60,
                              hh=side)
        want = sc.window_front_plain(totals, (h1, h2), n, boundary=bnd,
                                     limit=60, hh=side)
        torch.cuda.synchronize()
        assert _same(got[2:3] + got[4:6] + got[6], want[2:3] + want[4:6]
                     + want[6])
        assert torch.equal(got[6][0], want[6][0])
        # The reset's estimate-only form.
        got = sc.window_front(totals, (h1, h2), boundary=bnd, hh=side)
        want = sc.window_front_plain(totals, (h1, h2), boundary=bnd, hh=side)
        assert _same([got[2], *got[6]], [want[2], *want[6]])
    _, _, est, frac, avail, n_f, (mine, _, _) = sc.window_front(
        totals, (h1, h2), n, boundary=_valid_boundary(boundary), limit=60,
        hh=sc.SideTable(hh["hh_owner"], hh["hh_totals"], hh["hh_slabs"][0]))
    a, c, a2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
    got = sc.add_back(a, c, h1, h2, n, n_f, avail, 4, est, mine)
    want = sc.add_back_plain(a2, c2, h1, h2, n, n_f, avail, 4, est, mine)
    torch.cuda.synchronize()
    assert _same([*got, a, c], [*want, a2, c2])
    got = sc.window_admit(h1, est, n_f, avail, 4, mine)
    want = sc.window_admit_plain(h1, est, n_f, avail, 4, mine)
    assert _same(got, want)
    _, allowed, _, target_pr = want
    for thresh in (1.0, 30.0):
        g = {k: v.clone() for k, v in hh.items()}
        p = {k: v.clone() for k, v in hh.items()}
        sc.hh_update(g, h1, h2, n, allowed, mine, target_pr, thresh=thresh,
                     period=9)
        sc.hh_update_plain(p, h1, h2, n, allowed, mine, target_pr,
                           thresh=thresh, period=9)
        torch.cuda.synchronize()
        for k in g:
            assert torch.equal(g[k], p[k]), k
        # The claim scratch is left zero for the next launch.
        assert not sc._hh_scratch(dev, K, sc._stream(h1)).any()
    fused = int(B <= sc.ADMIT_CAPACITY)
    counts = sc.launch_counts()
    assert counts["window_estimate"] == 7 and counts["hh_update"] == 2
    assert counts["add_back"] == fused and counts["admit"] == fused
    assert counts["add_update"] == 1


@pytest.mark.parametrize("casc", [False, True])
@pytest.mark.parametrize("B", [0, 1, 4096, sc.ADMIT_CAPACITY,
                               sc.ADMIT_CAPACITY + 1])
@pytest.mark.parametrize("K", [16, 256, 1 << 22])
def test_side_table_tails_bit_equal_to_plain(dev, K, B, casc):
    """The two backs' side-table builds with the side table's update as
    their tail (``chip_smoke.tail_calls``), without and with the cascade
    (``chip_smoke.side_cascade``), against the plain back followed by
    ``hh_update_plain``, and against the parent's form (the build
    without the tail, then the standalone hh_update): every output, the
    sketch, every hh_* tensor and the scope counters. Shared scratch at
    K = 16 and 256, global at 2^22. Up to ADMIT_CAPACITY keys each back
    is one launch with its tail; above it the composed back and the
    standalone hh_update."""
    cs = _chip_smoke()
    rng = np.random.default_rng(B + K + casc)
    S, d, w = 4, 4, 1024
    k1, k2 = _side_batch(rng, "zipf", B, K)
    h1, h2 = torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev)
    n = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32)).to(dev)
    totals, boundary, cur = _slabs(rng, d, w, dev)
    hh = _side_state(rng, k1, K, S, dev)
    hh["hh_last"].fill_(-(1 << 40))
    bnd = _valid_boundary(boundary)
    side = sc.SideTable(hh["hh_owner"], hh["hh_totals"], hh["hh_slabs"][0])
    front = sc.window_front_plain(totals, (h1, h2), n, boundary=bnd,
                                  limit=60, hh=side)
    c = cs.side_cascade(torch, rng, h1, h2, n) if casc else None
    calls = cs.tail_calls(sc, totals, cur, front, h1, h2, n, hh, 1.0, 9, c)
    sc.reset_launch_counts()
    for name, (kern, plain, parent, *_) in calls.items():
        got, want, old = kern(), plain(), parent()
        torch.cuda.synchronize()
        assert len(got) == len(want) == len(old), name
        for a, b, o in zip(got, want, old):
            assert torch.equal(a, b) and torch.equal(a, o), name
    fused = int(B <= sc.ADMIT_CAPACITY)
    counts = sc.launch_counts()
    build = " [cascade]" if casc else ""
    assert counts["hh_update [fused]"] == 2 * fused
    assert counts["hh_update"] == 2 * (1 - fused) + 2
    assert counts[f"admit{build}"] == 2 * fused
    assert counts[f"add_back{build}"] == 2 * fused
    if K > sc.HH_SHARED_SLOTS:
        # The global scratch is left zero for the next launch.
        assert not sc._hh_scratch(dev, K, sc._stream(h1)).any()


@pytest.mark.parametrize("B", [0, 1, 6, sc.RESET_CAPACITY, 4096,
                               sc.ADMIT_CAPACITY, sc.ADMIT_CAPACITY + 1])
@pytest.mark.parametrize("K", [0, 16, 256, 1 << 22])
def test_window_reset_bit_equal_to_plain(dev, K, B):
    """The reset kernel against ``window_reset_plain`` (the estimate-only
    front, the floors, add_update), sliding (valid and stale boundary)
    and fixed, without a side table (K = 0) and with one (a third of the
    keys owned): totals, cur, hh_totals and hh_cur. Two keys share a
    row-0 column. Up to RESET_CAPACITY keys one launch; above it the
    composed reset (window_front, then one add_update a table)."""
    rng = np.random.default_rng(B + K + 5)
    S, d, w = 4, 4, 1024
    k1, k2 = _side_batch(rng, "zipf", B, max(K, 16))
    if B > 1:
        k1[1] = k1[0]
    h1, h2 = torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev)
    totals, boundary, cur = _slabs(rng, d, w, dev)
    hh = _side_state(rng, k1, K, S, dev) if K else None
    sc.reset_launch_counts()
    for bnd in (_valid_boundary(boundary), _valid_boundary(boundary,
                                                           stale=True), None):
        out = []
        for fn in (sc.window_reset, sc.window_reset_plain):
            t, c = totals.clone(), cur.clone()
            g = None if hh is None else {k: v.clone() for k, v in hh.items()}
            side = None if g is None else sc.SideTable(
                g["hh_owner"], g["hh_totals"],
                g["hh_slabs"][0] if bnd is not None else None)
            fn(t, c, h1, h2, boundary=bnd, hh=side,
               hh_cur=None if g is None else g["hh_cur"])
            out.append([t, c] + ([] if g is None else [g["hh_totals"],
                                                       g["hh_cur"]]))
        torch.cuda.synchronize()
        for a, b in zip(*out):
            assert torch.equal(a, b)
    fused = B <= sc.RESET_CAPACITY
    counts = sc.launch_counts()
    assert counts["window_reset"] == 3 * fused
    assert counts["window_estimate"] == 3 * (not fused)
    assert counts["add_update"] == 3 * (not fused) * (1 + bool(K))


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW"])
@pytest.mark.parametrize("cu", [True, False])
def test_side_table_limiter_on_card_equals_limiter_on_cpu(dev, algo, cu):
    """Promotion, owned counts, a reset of an owned key, an override,
    idle eviction past a window and re-promotion, with 4 tickets in
    flight: every result and every state array (hh_* included) equal to
    the CPU's; the step launched the front, its back and hh_update."""
    cfg = Config(algorithm=getattr(Algorithm, algo), limit=10, window=6.0,
                 sketch=SketchParams(depth=3, width=256, sub_windows=6,
                                     hh_slots=16, conservative_update=cu))
    lims = [SketchLimiter(cfg, ManualClock(1e6), device=d)
            for d in (dev, "cpu")]
    rng = np.random.default_rng(4 + cu)
    for lim in lims:
        lim.set_override("k1", 4)
    sc.reset_launch_counts()
    pend = []
    for step in range(24):
        ids = (rng.zipf(1.3, size=48) % 30).astype(np.uint64)
        ns = rng.integers(1, 3, size=48)
        pend.append([lim.launch_ids(ids, ns, wire=bool(step % 2))
                     for lim in lims])
        if step % 6 == 5:
            keys = [f"k{int(i)}" for i in rng.integers(0, 4, size=12)]
            pend.append([lim.launch_batch(keys) for lim in lims])
        while len(pend) > 4:
            a, b = (lim.resolve(t) for lim, t in zip(lims, pend.pop(0)))
            for f in ("allowed", "remaining", "retry_after", "reset_at"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if step == 12:
            for lim in lims:
                lim.reset("k1")
        for lim in lims:
            lim.clock.advance(7.0 if step == 16 else 0.4)
    for pair in pend:
        a, b = (lim.resolve(t) for lim, t in zip(lims, pair))
        np.testing.assert_array_equal(a.allowed, b.allowed)
    torch.cuda.synchronize()
    counts = sc.launch_counts()
    ga, ca = (lim.capture_state()[1] for lim in lims)
    for k in ca:
        np.testing.assert_array_equal(ga[k], ca[k], err_msg=k)
    assert ga["hh_owner"].any()
    assert lims[0].consumer_stats() == lims[1].consumer_stats()
    back = ("admit", "cu_update") if cu else ("add_back",)
    for k in ("window_estimate", "hh_update [fused]", "window_reset", *back):
        assert counts[k] > 0, k
    # The update ran as every back launch's tail, the card's one reset in
    # one launch.
    assert counts["hh_update"] == 0 and counts["window_reset"] == 1
    assert counts["hh_update [fused]"] == counts[back[0]]
    for lim in lims:
        lim.close()


def test_side_table_door_on_card_matches_cpu_replay(dev):
    """chip_smoke.check_door with the side table: every frame and the final
    state bit-identical to a CPU replay, the consumer gauges on METRICS
    equal to the served limiter's consumer_stats."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    cfg = Config(algorithm=Algorithm.SLIDING_WINDOW, limit=20, window=2.0,
                 sketch=SketchParams(depth=4, width=4096, sub_windows=4,
                                     hh_slots=256))
    out = chip_smoke.check_door(
        torch, cfg, "hh", conns=4, frames=24, n_ids=512, n_keys=64,
        counters=[sc], required=("window_estimate", "admit", "cu_update",
                                 "hh_update [fused]"),
        same=("admit", "cu_update"))
    assert out["dispatches"] < out["frames"] == 96
    assert out["hh_tracked"] >= 1


# --------------------------------------------- the hierarchy cascade


def _chip_smoke():
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("T", [4, 16, 64, 4096])
@pytest.mark.parametrize("kind", ["contended", "uncontended", "one tenant",
                                  "wide map"])
@pytest.mark.parametrize("B", [0, 1, 4096, sc.ADMIT_CAPACITY,
                               2 * sc.ADMIT_CAPACITY])
def test_cascade_kernels_bit_equal_to_plain(dev, T, kind, B):
    """The cascade's routine alone (csrc/cascade_bench.cu) and the
    cascade builds of add_back, window_admit and bucket_admit against
    their plain versions in every operand form (sliding with the tenant
    boundary slab, fixed, the bucket in and past its counters' window):
    every output, the sketch and the scope counters they fold into; the
    map staged in shared memory, or (``wide map``, 8192 rows) searched in
    global memory. Up to ADMIT_CAPACITY requests each build is one
    launch; above it each back runs composed on the card (the plain
    admission and cascade; add_back's standalone add_update the only
    launch) and equals the plain version too."""
    cs = _chip_smoke()
    case = cs.cascade_case(np.random.default_rng(T + B + len(kind)), B, T,
                           kind)
    fused = B <= sc.ADMIT_CAPACITY
    for mode in cs.CASC_MODES:
        sc.reset_launch_counts()
        bc.reset_launch_counts()
        for name, (kern, plain, _) in cs.cascade_calls(
                torch, sc, bc, case, mode, dev).items():
            if not fused and name == "cascade_admit":
                continue  # the routine alone is one block
            got, want = kern(), plain()
            torch.cuda.synchronize()
            assert len(got) == len(want), name
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (name, mode)
        counts = cs.cascade_launches(sc, bc)
        builds = {k: v for k, v in counts.items() if v}
        windowed = not mode.startswith("bucket")
        if not fused:
            want = {"add_update": 1} if windowed else {}
        else:
            want = ({"add_back [cascade]": 1, "admit [cascade]": 1,
                     "add_update": 1} if windowed
                    else {"bucket admit [cascade]": 1})
        assert builds == want


def _tenant_cfg(algo, cu=True, hh_slots=0):
    from ratelimiter_tpu_torch import HierarchySpec

    return Config(algorithm=getattr(Algorithm, algo), limit=7, window=6.0,
                  sketch=SketchParams(depth=3, width=128, sub_windows=6,
                                      conservative_update=cu,
                                      hh_slots=hh_slots),
                  hierarchy=HierarchySpec(tenants=4, map_capacity=16,
                                          global_limit=60,
                                          default_tenant_limit=25))


@pytest.mark.parametrize("algo,cu,hh", [
    ("SLIDING_WINDOW", True, 0), ("SLIDING_WINDOW", False, 0),
    ("FIXED_WINDOW", True, 0), ("SLIDING_WINDOW", True, 16),
    ("SLIDING_WINDOW", False, 16), ("TOKEN_BUCKET", True, 0)])
def test_tenant_limiter_on_card_equals_limiter_on_cpu(dev, algo, cu, hh):
    """The cascade through the limiter with 4 tickets in flight, across
    rollovers (the bucket across its counters' window), an override, a
    reset and a moved effective limit: every result and every state array
    (tn_* included) equal to the CPU's; every step ran a cascade build."""
    from ratelimiter_tpu_torch import create_limiter

    lims = [create_limiter(_tenant_cfg(algo, cu, hh), clock=ManualClock(1e6),
                           device=d) for d in (dev, "cpu")]
    for lim in lims:
        lim.set_override("k1", 4)
        lim.set_tenant("gold", 20, weight=3)
        lim.set_tenant("free", 8)
        for i in range(6):
            lim.assign_tenant(f"k{i}", "gold" if i % 2 else "free")
    rng = np.random.default_rng(5 + cu + hh)
    sc.reset_launch_counts()
    bc.reset_launch_counts()
    pend, steps = [], 0
    for step in range(24):
        keys = [f"k{int(i)}" for i in rng.zipf(1.3, size=40) % 12]
        ns = rng.integers(1, 3, size=40)
        pend.append([lim.launch_batch(keys, ns) for lim in lims])
        ids = (rng.zipf(1.3, size=48) % 30).astype(np.uint64)
        pend.append([lim.launch_ids(ids, wire=bool(step % 2))
                     for lim in lims])
        steps += 2
        while len(pend) > 4:
            a, b = (lim.resolve(t) for lim, t in zip(lims, pend.pop(0)))
            for f in ("allowed", "remaining", "retry_after", "reset_at"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if step == 10:
            for lim in lims:
                lim.reset("k1")
                lim.set_effective("gold", 9)
        for lim in lims:
            lim.clock.advance(7.0 if step == 16 else 0.4)
    for pair in pend:
        a, b = (lim.resolve(t) for lim, t in zip(lims, pair))
        np.testing.assert_array_equal(a.allowed, b.allowed)
    torch.cuda.synchronize()
    counts = {**sc.launch_counts(), "bucket": bc.launch_counts()}
    ga, ca = (lim.capture_state()[1] for lim in lims)
    assert sorted(ga) == sorted(ca)
    for k in ca:
        np.testing.assert_array_equal(ga[k], ca[k], err_msg=k)
    assert lims[0].hierarchy_stats() == lims[1].hierarchy_stats()
    casc = (counts["bucket"]["admit [cascade]"] if algo == "TOKEN_BUCKET"
            else counts["admit [cascade]"] + counts["add_back [cascade]"])
    assert casc == steps
    assert not (counts["bucket"]["admit"] or counts["admit"]
                or counts["add_back"])
    for lim in lims:
        lim.close()


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_tenant_batch_above_capacity_refused_on_card(dev, algo):
    """With tenants on the card a batch above ADMIT_CAPACITY is served
    (no longer refused), composed: the front and the standalone update
    launched, no admission launch (the plain admission and cascade run on
    the card), every result and the state equal to the CPU twin's; the
    limiter then serves the next batch as the CPU twin does."""
    from ratelimiter_tpu_torch import create_limiter

    lims = [create_limiter(_tenant_cfg(algo), clock=ManualClock(1e6),
                           device=d) for d in (dev, "cpu")]
    for lim in lims:
        lim.set_tenant("gold", 20, weight=3)
        lim.set_tenant("free", 8)
        for i in range(6):
            lim.assign_tenant(f"k{i}", "gold" if i % 2 else "free")
    sc.reset_launch_counts()
    bc.reset_launch_counts()
    ids = np.arange(sc.ADMIT_CAPACITY + 1, dtype=np.uint64) % np.uint64(50)
    a, b = (lim.allow_ids(ids) for lim in lims)
    torch.cuda.synchronize()
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert 0 < a.allowed.sum() < len(ids)
    counts = {k: v for k, v in {**sc.launch_counts(), **{
        f"bucket {k}": v for k, v in bc.launch_counts().items()}}.items()
        if v}
    assert counts == ({"bucket bucket_estimate": 1, "bucket bucket_update": 1}
                      if algo == "TOKEN_BUCKET"
                      else {"window_estimate": 1, "cu_update": 1})
    ga, ca = (lim.capture_state()[1] for lim in lims)
    for k in ca:
        np.testing.assert_array_equal(ga[k], ca[k], err_msg=k)
    a, b = (lim.allow_ids(ids[:sc.ADMIT_CAPACITY]) for lim in lims)
    np.testing.assert_array_equal(a.allowed, b.allowed)
    for lim in lims:
        lim.close()


# ------------------------------------------------- the dense backend


def _dense_operands(rng, algo: str, C: int, B: int, dev, *, one_slot=False,
                    policy=False, table_rows: int = 64):
    """A lived-in dense state of C slots, a batch of B requests (a tenth
    padding) and, with ``policy``, an override table of ``table_rows``
    rows over some of the batch's slots with search keys a function of
    the slot."""
    from ratelimiter_tpu_torch.ops import dense_kernels as dk

    now = 1_700_000_000_123_457
    W = 3_000_000
    cols = dk.COLUMNS[getattr(Algorithm, algo)]
    if algo == "TOKEN_BUCKET":
        vals = [rng.integers(0, 7_000_001, C + 1), rng.integers(0, 3, C + 1),
                now - rng.integers(0, 2 * W, C + 1)]
    else:
        cur = (now // W) * W
        vals = [rng.integers(0, 9, C + 1) for _ in cols[:-1]]
        vals.append(rng.choice(np.array([cur, cur - W, 0]), C + 1))
    state = {c: torch.from_numpy(np.asarray(v, np.int64)).to(dev)
             for c, v in zip(cols, vals)}
    sid = (np.full(B, 3) if one_slot else rng.integers(0, C, B)).astype(
        np.int32)
    n = rng.integers(1, 4, B).astype(np.int64)
    pad = rng.random(B) < 0.1
    sid[pad], n[pad] = C, 0
    args = [torch.from_numpy(sid).to(dev), torch.from_numpy(n).to(dev), now]
    if policy:
        keyq = splitmix64(sid.astype(np.uint64)).view(np.int64)
        chosen = np.unique(keyq[~pad])[:48]
        P = table_rows
        tab = {"key": np.full(P, PAD_KEY, np.int64)}
        for k, v in (("limit", 7), ("window_us", W), ("rate_num", 7),
                     ("rate_den", 3)):
            tab[k] = np.full(P, v, np.int64)
        for i, q in enumerate(np.sort(chosen)):
            lim = int(rng.integers(1, 15))
            w = int(W * rng.choice([0.5, 2.0]))
            num, den = dk.check_gate_values(lim, w)
            tab["key"][i], tab["limit"][i], tab["window_us"][i] = q, lim, w
            tab["rate_num"][i], tab["rate_den"][i] = num, den
        args += [{k: torch.from_numpy(v).to(dev) for k, v in tab.items()},
                 torch.from_numpy(keyq).to(dev)]
    return state, args


@pytest.mark.parametrize("policy", [False, True], ids=["default", "policy"])
@pytest.mark.parametrize("B,kind", [(0, "zipf"), (1, "zipf"), (48, "zipf"),
                                    (4096, "zipf"), (4096, "one slot"),
                                    (sc.ADMIT_CAPACITY, "zipf")])
@pytest.mark.parametrize("algo", ["FIXED_WINDOW", "SLIDING_WINDOW",
                                  "TOKEN_BUCKET"])
def test_dense_step_bit_equal_to_plain(dev, algo, B, kind, policy):
    """Each build of the dense step against its plain version on the same
    operands: every output and the whole state (padding row included),
    at the config's limit and after a decrease (negative free units)."""
    from ratelimiter_tpu_torch.ops import dense_cuda, dense_kernels as dk

    rng = np.random.default_rng(B + len(kind) + 3 * policy)
    state, args = _dense_operands(rng, algo, 1024, B, dev,
                                  one_slot=kind == "one slot",
                                  policy=policy)
    for limit in (7, 2):
        params = dk.step_params(Config(algorithm=getattr(Algorithm, algo),
                                       limit=limit, window=3.0))
        a = {k: v.clone() for k, v in state.items()}
        b = {k: v.clone() for k, v in state.items()}
        dense_cuda.reset_launch_counts()
        got = dense_cuda.dense_step(a, *args, **params)
        want = dense_cuda.dense_step_plain(b, *args, **params)
        torch.cuda.synchronize()
        counts = dense_cuda.launch_counts()
        assert counts["dense_step"] == counts["dense_front"] == 1
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("rows", [0, 64, 8192],
                         ids=["no table", "table staged", "table in global"])
@pytest.mark.parametrize("B,kind", [(0, "zipf"), (1, "zipf"), (4096, "zipf"),
                                    (4096, "one slot"),
                                    (sc.ADMIT_CAPACITY, "zipf")])
@pytest.mark.parametrize("algo", ["FIXED_WINDOW", "SLIDING_WINDOW",
                                  "TOKEN_BUCKET"])
def test_dense_front_bit_equal_to_plain(dev, algo, B, kind, rows):
    """The step's phase A alone (``dense_front``, across the card) against
    ``dense_front_plain`` on the scratch rows its algorithm writes, with
    no table, a 64-row table (staged in shared memory) and an 8192-row
    one (searched in global memory); the state is only read. Then the
    whole step with the 8192-row table against its plain version."""
    from ratelimiter_tpu_torch.ops import dense_cuda, dense_kernels as dk

    rng = np.random.default_rng(B + len(kind) + rows)
    state, args = _dense_operands(rng, algo, 1024, B, dev,
                                  one_slot=kind == "one slot",
                                  policy=rows > 0, table_rows=max(rows, 64))
    params = dk.step_params(Config(algorithm=getattr(Algorithm, algo),
                                   limit=7, window=3.0))
    used = list(dk.USED_ROWS[params["algorithm"]])
    before = {k: v.clone() for k, v in state.items()}
    dense_cuda.reset_launch_counts()
    got = dense_cuda.dense_front(state, *args, **params)
    want = dk.dense_front_plain(state, *args, **params)
    torch.cuda.synchronize()
    assert dense_cuda.launch_counts()["dense_front"] == 1
    assert torch.equal(got[used], want[used])
    for k in state:
        assert torch.equal(state[k], before[k]), k
    if rows == 8192:
        b = {k: v.clone() for k, v in state.items()}
        for x, y in zip(dense_cuda.dense_step(state, *args, **params),
                        dense_cuda.dense_step_plain(b, *args, **params)):
            assert torch.equal(x, y)
        for k in state:
            assert torch.equal(state[k], b[k]), k


@pytest.mark.parametrize("algo", ["FIXED_WINDOW", "SLIDING_WINDOW",
                                  "TOKEN_BUCKET"])
def test_dense_step_refuses_above_capacity_on_card(dev, algo):
    """A dense batch above ADMIT_CAPACITY is served on the card (no longer
    refused), composed: the plain step on the card, counted as one
    composed step and no launch, equal to the plain version on the CPU;
    and the limiter's batch of ADMIT_CAPACITY + 1 equals the CPU
    limiter's."""
    from ratelimiter_tpu_torch import DenseParams, create_limiter
    from ratelimiter_tpu_torch.ops import dense_cuda, dense_kernels as dk

    rng = np.random.default_rng(1)
    state, args = _dense_operands(rng, algo, 64, 2 * sc.ADMIT_CAPACITY, dev)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    dense_cuda.reset_launch_counts()
    params = dk.step_params(Config(algorithm=getattr(Algorithm, algo),
                                   limit=7, window=3.0))
    got = dense_cuda.dense_step(state, *args, **params)
    torch.cuda.synchronize()
    counts = dense_cuda.launch_counts()
    assert counts["dense_step [composed]"] == 1
    assert counts["dense_step"] == counts["dense_front"] == 0
    want = dense_cuda.dense_step(cpu_state, *cpu_args, **params)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    for k in state:
        assert torch.equal(state[k].cpu(), cpu_state[k]), k
    cfg = Config(algorithm=getattr(Algorithm, algo), limit=7, window=3.0,
                 dense=DenseParams(capacity=1 << 14))
    lims = [create_limiter(cfg, "dense", clock=ManualClock(1e6), device=d)
            for d in (dev, "cpu")]
    keys = [f"k{i % 500}" for i in range(sc.ADMIT_CAPACITY + 1)]
    a, b = (lim.allow_batch(keys) for lim in lims)
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert 0 < a.allowed.sum() < len(keys)
    for lim in lims:
        lim.close()


@pytest.mark.parametrize("algo", ["FIXED_WINDOW", "SLIDING_WINDOW",
                                  "TOKEN_BUCKET"])
def test_dense_limiter_on_card_equals_limiter_on_cpu(dev, algo):
    """``create_limiter(cfg, "dense")`` on the card and on the CPU over
    the same string trace (an override, a reset, a limit and a window
    update, windows rolling): every result and the captured state, one
    launch a batch; the exact backend decides the same."""
    from ratelimiter_tpu_torch import DenseParams, create_limiter
    from ratelimiter_tpu_torch.ops import dense_cuda

    cfg = Config(algorithm=getattr(Algorithm, algo), limit=9, window=2.0,
                 dense=DenseParams(capacity=4096))
    rng = np.random.default_rng(2)
    batches = [[f"k{i}" for i in rng.integers(0, 600, 256)]
               for _ in range(16)]
    plan = {2: ("set_override", ("k1", 20)), 5: ("reset", ("k2",)),
            8: ("update_limit", (5,)), 11: ("update_window", (3.0,))}
    outs, states = [], []
    for backend, d in (("dense", dev), ("dense", "cpu"), ("exact", None)):
        kw = {} if d is None else {"device": d}
        lim = create_limiter(cfg, backend, clock=ManualClock(1e6), **kw)
        dense_cuda.reset_launch_counts()
        got = []
        for step, keys in enumerate(batches):
            if step in plan:
                getattr(lim, plan[step][0])(*plan[step][1])
            got.append(lim.allow_batch(keys))
            lim.clock.advance(0.4)
        if d == dev:
            assert dense_cuda.launch_counts()["dense_step"] == len(batches)
        outs.append(got)
        states.append(lim.capture_state()[1])
        lim.close()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            for f in ("allowed", "remaining", "retry_after", "reset_at"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for k in states[1]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)


@pytest.mark.parametrize("backend", ["dense", "exact"])
def test_backend_door_on_card_matches_cpu_replay(dev, backend):
    """The door over the dense and exact backends
    (chip_smoke.check_backend_door): string frames bit-identical to a CPU
    replay of the windows, ALLOW_HASHED refused."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    out = chip_smoke.check_backend_door(
        torch, chip_smoke.dense_config("SLIDING_WINDOW", capacity=1 << 16),
        backend, device=str(dev), frames=24)
    assert out["frames"] > 24


def test_scan_and_eval_chunks_on_card_equal_cpu(dev):
    """The sketch and bucket scans, the bench chunk and the eval chunk at
    a small geometry on the card against the CPU: masks, deny counts,
    stats and states; the card's Zipf ids equal to the CPU's; on the card
    each step of a scan, the bench chunk and the eval chunk launch
    exactly their kernels (front, admission, update; the oracle's front
    and fused vanilla back)."""
    from ratelimiter_tpu_torch.convert import state_to_numpy
    from ratelimiter_tpu_torch.evaluation import loadgen
    from ratelimiter_tpu_torch.evaluation import oracle_device as od
    from ratelimiter_tpu_torch.ops import bucket_kernels as bk
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk

    def counted(mod, want, fn, *args, **kw):
        """fn(*args, **kw), its launches exactly ``want`` on the card and
        none on the CPU."""
        mod.reset_launch_counts()
        out = fn(*args, **kw)
        counts = mod.launch_counts()
        assert set(want) <= set(counts)
        assert counts == {k: want.get(k, 0) if d == dev else 0
                          for k in counts}
        return out

    assert torch.equal(loadgen._zipf_ids(5, 1 << 16, 1_000_000, 1.1,
                                         dev).cpu(),
                       loadgen._zipf_ids(5, 1 << 16, 1_000_000, 1.1, "cpu"))
    cfg = Config(algorithm=Algorithm.SLIDING_WINDOW, limit=20, window=6.0,
                 max_batch_admission_iters=1,
                 sketch=SketchParams(depth=3, width=4096, sub_windows=6))
    sub_us = sk.sketch_geometry(cfg)[1]
    roll = sk.build_steps(cfg)[2]
    p = 1_700_000_000_000_000 // sub_us
    res = {}
    for d in (dev, "cpu"):
        st = sk.init_state(cfg, d)
        roll(st, p)
        rng = np.random.default_rng(4)
        h1 = torch.from_numpy(rng.integers(0, 2 ** 32, (8, 512))).to(d)
        h2 = torch.from_numpy(rng.integers(0, 2 ** 32, (8, 512)) | 1).to(d)
        ns = torch.ones((8, 512), dtype=torch.int32, device=d)
        _, masks, denies = counted(
            sc, {"window_estimate": 8, "admit": 8, "cu_update": 8},
            sk.build_scan(cfg), st, h1, h2, ns, p * sub_us, 400, period=p)
        chunk = loadgen.build_bench_chunk(cfg, 1024, 5000, 1.1, d)
        _, packed, dn = counted(
            sc, {"window_estimate": 1, "admit": 1, "cu_update": 1}, chunk,
            st, 0, p * sub_us + 5000, period=p)
        states = {"sk": st, "or": od.init_oracle_state(cfg, 5000, d)}
        od.build_oracle_rollover(cfg, 5000)(states["or"], p)
        _, stats = counted(
            sc, {"window_estimate": 2, "admit": 1, "cu_update": 1,
                 "add_back": 1, "add_update": 1},
            od.build_eval_chunk(cfg, 1024, 5000, 1.1, d), states, 1024,
            p * sub_us + 9000, period=p)
        bcfg = Config(algorithm=Algorithm.TOKEN_BUCKET, limit=20,
                      window=10.0, sketch=SketchParams(depth=4, width=4096))
        bst = bk.init_state(bcfg, d)
        _, bmasks, bden = counted(
            bc, {"bucket_estimate": 8, "admit": 8, "bucket_update": 8},
            bk.build_scan(bcfg), bst, h1, h2, ns, 1_700_000_000_000_000, 400)
        res[str(d)] = ([x.cpu() for x in (masks, denies, packed, dn, stats,
                                          bmasks, bden)],
                       state_to_numpy(st), state_to_numpy(states["or"]))
    a, b = res[str(dev)], res["cpu"]
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for sa, sb in zip(a[1:], b[1:]):
        for k in sb:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
