#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--steps N]
    python3 chip_smoke.py --sweep    # time the tiled updates' launch shapes

Phases (each raises on failure; the script exits non-zero):

1. build the port's CUDA kernels from ``ratelimiter_tpu_torch/csrc`` (one
   nvcc per source, all started together);
2. hold each kernel bit-equal to its plain PyTorch version and time
   kernel, plain version and bound: the windowed sketch's three at the
   serving geometry of the repo's benchmark config 3 (sliding window,
   limit 100 per 60 s, 60 one-second sub-windows, count-min sketch d=4,
   w=65536, batches of 4096 ids drawn Zipf(1.1) over 1M keys), sliding and
   fixed; the token bucket's two at d=4, w=65536, B=4096 on a debt slab
   holding zeros, random debts and cells within 10^6 of 2^61, under three
   decays; the two tiled updates (``cu_update``, ``bucket_update``) also on
   a batch whose 4096 keys share one column and on 2^20 Zipf keys (where
   their launch shape switches to clusters), and ``bucket_update`` with
   ``clamp_acc`` on an ``acc`` slab holding cells above 2^61; the tile and
   cluster each uses are logged;
3. drive each main path end to end through ``create_limiter(...,
   device="cuda")`` with launch/resolve and 4 tickets in flight, a policy
   override and a reset, and hold every result and the final state
   bit-identical to the same trace on the CPU (the plain versions, which
   the CPU tests hold to the JAX package). Each path's launch counts are
   set to 0 just before it and read just after, and each of its kernels
   must have launched. Windowed: config-3 traffic across sub-window
   rollovers, with conservative update on and off, then a profile of a
   short CU run. Token bucket: TB-c2, benchmark config 2's token-bucket
   cell at its literal parameters (limit 20 per 10 s, 4096 string keys
   per batch uniform over 10,000, +0.25 s per batch), and TB-zipf, config
   3's traffic under a token bucket (limit 100 per 60 s, +0.1 s per
   batch), then a profile of a short TB-zipf run;
4. start the port's server on 127.0.0.1, once with the windowed limiter
   and once with the TB-c2 bucket, and check its answers to ALLOW_HASHED,
   ALLOW_BATCH, RESET and HEALTH frames against an in-process limiter on
   the same trace;
5. print the kernel table as one JSON line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

``--sweep`` builds, then holds every (tile, cluster) of the two tiled
updates bit-equal to the plain version and times it (config-3 batch, B = 0
and the one-column batch), and every cluster at the chosen tile on larger
batches, printing the results as one JSON line before the card's line.

Without a CUDA device it exits non-zero before printing any result.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: Config 3's serving shape (benchmarks/configs.py:7-11,141-143).
LIMIT, WINDOW_S, SUB_WINDOWS, DEPTH, WIDTH = 100, 60.0, 60, 4, 65536
BATCH, N_KEYS, ZIPF_A = 4096, 1_000_000, 1.1
T0 = 1_700_000_000.0

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor op/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: Benchmark config 2's token-bucket cell (benchmarks/configs.py:71-81).
C2_LIMIT, C2_WINDOW_S, C2_KEYS, C2_ADVANCE = 20, 10.0, 10_000, 0.25

KERNEL_ROWS = {
    "window_estimate": "ratelimiter_tpu/ops/pallas_sketch.py:144",
    "cu_update": "ratelimiter_tpu/ops/pallas_sketch.py:186",
    "add_update": "ratelimiter_tpu/ops/pallas_sketch.py:224",
    "bucket_estimate": "ratelimiter_tpu/ops/pallas_sketch.py:270",
    "bucket_update": "ratelimiter_tpu/ops/pallas_sketch.py:302",
}
SOURCE = "ratelimiter_tpu_torch/csrc/sketch_kernels.cu"
BUCKET_SOURCE = "ratelimiter_tpu_torch/csrc/bucket_kernels.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def zipf_ids(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.zipf(ZIPF_A, size=shape).astype(np.uint64) % np.uint64(N_KEYS)


def device_keys(torch, ids: np.ndarray):
    """(h1, h2) on the card for raw u64 ids, as the raw-id lane hashes
    them (splitmix64, then the split with the sketch's seed)."""
    from ratelimiter_tpu_torch.ops import hashing

    return hashing.split_hash_dev(hashing.splitmix64_dev(
        hashing.u64_to_tensor(ids, torch.device("cuda"))), 0x5bd1e995)


def device_ms(fn, torch, *, reps: int = 7) -> float:
    """Median device time of one ``fn()`` call, in ms. The card is held
    busy (``torch.cuda._sleep``) while the host enqueues the start event,
    n calls and the end event, so the events time device work only, not
    the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    n = int(min(200, max(5, 4e-3 / max(host_s, 1e-7))))
    cycles = int(2e9 * (2.5 * n * host_s + 2e-3))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def config3(algorithm: str = "SLIDING_WINDOW", cu: bool = True):
    from ratelimiter_tpu_torch import Algorithm, Config, SketchParams

    return Config(algorithm=getattr(Algorithm, algorithm), limit=LIMIT,
                  window=WINDOW_S,
                  sketch=SketchParams(depth=DEPTH, width=WIDTH,
                                      sub_windows=SUB_WINDOWS,
                                      conservative_update=cu))


def config2_bucket():
    from ratelimiter_tpu_torch import Algorithm, Config, SketchParams

    return Config(algorithm=Algorithm.TOKEN_BUCKET, limit=C2_LIMIT,
                  window=C2_WINDOW_S,
                  sketch=SketchParams(depth=DEPTH, width=WIDTH))


def hold_equal(torch, err: dict, name: str, a, b) -> None:
    """Record the largest |kernel - plain| of one output in ``err[name]``;
    raise unless the two are bit-equal (the stated tolerance is 0)."""
    torch.cuda.synchronize()
    delta = a.double() - b.double() if a.is_floating_point() else a - b
    diff = float(delta.abs().max())
    err[name] = max(err[name], diff)
    if not torch.equal(a, b):
        raise AssertionError(f"{name} differs from its plain version "
                             f"(max abs err {diff})")


def kernel_row(name, source, err, kern, plain, lib, nbytes, ops,
               torch) -> dict:
    """Time a kernel, its plain version and (where one exists) the one
    PyTorch call computing the same function; bound = max(bytes over the
    HBM rate, operations over the non-tensor peak)."""
    ms = device_ms(kern, torch)
    plain_ms = device_ms(plain, torch)
    lib_ms = device_ms(lib, torch) if lib is not None else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": source,
        "replaces": KERNEL_ROWS[name], "launches": 0,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, "bytes": nbytes,
    }
    log(f"time {name}: kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, library "
        f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
        f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}, "
        f"{nbytes} B)")
    return row


# --------------------------------------------------------------- phase 2


def window_state(torch, rng):
    """A windowed state as after resets and traffic, negative cells
    included, at config-3 geometry: totals, boundary, cur, and the
    boundary weight 0.377 s into a sub-window."""
    from ratelimiter_tpu_torch.ops.sketch_kernels import boundary_frac

    def slab(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=(
            DEPTH, WIDTH)).astype(np.int32)).to("cuda")
    totals, boundary, cur = slab(-3, 300), slab(-2, 200), slab(-3, 30)
    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    p = int(T0 * 1e6) // sub_us
    frac = torch.tensor(boundary_frac(p, p * sub_us + 377_123, sub_us),
                        dtype=torch.float32, device="cuda")
    return totals, boundary, cur, frac


def check_kernels(torch, seed: int) -> dict:
    """Each kernel against its plain version at config-3 shapes, sliding
    and fixed; times and bounds. Launches made here do not count."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    h1, h2 = device_keys(torch, zipf_ids(rng, BATCH))
    totals, boundary, cur, frac = window_state(torch, rng)
    add = torch.from_numpy(
        rng.integers(0, 3, size=BATCH).astype(np.int32)).to(dev)

    # Cells the batch touches (the data-dependent part of the bounds).
    cols = sc._columns(h1, h2, DEPTH, WIDTH)
    touched = sum(int(torch.unique(cols[r]).numel()) for r in range(DEPTH))
    cells = DEPTH * WIDTH

    rows = {}
    err = {"window_estimate": 0.0, "cu_update": 0.0, "add_update": 0.0}

    def note(name, pairs):
        for a, b in pairs:
            hold_equal(torch, err, name, a, b)
    for bnd in (boundary, None):
        mode = "sliding" if bnd is not None else "fixed"
        fr = frac if bnd is not None else None
        est = sc.window_estimate(totals, bnd, fr, h1, h2)
        note("window_estimate",
             [(est, sc.window_estimate_plain(totals, bnd, fr, h1, h2))])
        target = torch.where(torch.rand(BATCH, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev) < 0.8,
            torch.clamp_min(est, 0.0) + 1.0, torch.zeros((), device=dev))
        got_t, got_c = totals.clone(), cur.clone()
        sc.cu_update(got_t, got_c, bnd, fr, h1, h2, target)
        ref_t, ref_c = totals.clone(), cur.clone()
        sc.cu_update_plain(ref_t, ref_c, bnd, fr, h1, h2, target)
        note("cu_update", [(got_t, ref_t), (got_c, ref_c)])
        grown = int(((totals < 0) & (got_t > totals)).sum())
        log(f"kernels[{mode}]: window_estimate and cu_update bit-equal to "
            f"plain; {int((got_t != totals).sum())} cells raised, {grown} of "
            f"them negative cells")
    # The skewed extreme: all 4096 keys on one column of every row, so the
    # shared-memory histogram's atomics all hit one entry.
    o1, o2 = one_column(torch, h1, h2)
    for bnd in (boundary, None):
        fr = frac if bnd is not None else None
        target = skewed_targets(torch, sc.window_estimate_plain(
            totals, bnd, fr, o1, o2), seed)
        got_t, got_c, ref_t, ref_c = (x.clone() for x in (totals, cur,
                                                          totals, cur))
        sc.cu_update(got_t, got_c, bnd, fr, o1, o2, target)
        sc.cu_update_plain(ref_t, ref_c, bnd, fr, o1, o2, target)
        note("cu_update", [(got_t, ref_t), (got_c, ref_c)])
    log(f"kernels: cu_update bit-equal to plain on the one-column batch; "
        f"tile {sc.tiling(WIDTH, BATCH)} (cells, "
        f"cluster blocks)")
    got_t, got_c, ref_t, ref_c = (x.clone() for x in (totals, cur, totals,
                                                      cur))
    sc.add_update(got_t, got_c, h1, h2, add)
    sc.add_update_plain(ref_t, ref_c, h1, h2, add)
    note("add_update", [(got_t, ref_t), (got_c, ref_c)])
    log("kernels: add_update bit-equal to plain")

    # Timing at the sliding (main-path) shapes.
    t_buf, c_buf = totals.clone(), cur.clone()
    target = torch.clamp_min(sc.window_estimate_plain(
        totals, boundary, frac, h1, h2), 0.0) + 1.0
    flat = (cols + torch.arange(DEPTH, device=dev)[:, None] * WIDTH
            ).reshape(-1)
    both = torch.cat([flat, flat + cells])
    stacked = torch.zeros(2 * cells, dtype=torch.int32, device=dev)
    vals2 = add.repeat(2 * DEPTH)
    timing = {
        "window_estimate": (
            lambda: sc.window_estimate(totals, boundary, frac, h1, h2),
            lambda: sc.window_estimate_plain(totals, boundary, frac, h1, h2),
            None,
            # h1, h2, est per key; totals and boundary per touched cell.
            BATCH * (8 + 8 + 4) + touched * 4 * 2 + 4,
            3 * DEPTH * BATCH),
        "cu_update": (
            lambda: sc.cu_update(t_buf, c_buf, boundary, frac, h1, h2,
                                 target),
            lambda: sc.cu_update_plain(t_buf, c_buf, boundary, frac, h1, h2,
                                       target),
            None,
            # h1, h2, target per key; per cell: totals r+w, cur r+w, boundary.
            BATCH * (8 + 8 + 4) + cells * (8 + 8 + 4) + 4,
            DEPTH * BATCH + 6 * cells),
        "add_update": (
            lambda: sc.add_update(t_buf, c_buf, h1, h2, add),
            lambda: sc.add_update_plain(t_buf, c_buf, h1, h2, add),
            # One call computing both slabs' scatter-add: index_add_ over
            # the two slabs laid side by side.
            lambda: stacked.index_add_(0, both, vals2),
            # h1, h2, add per key; touched cells of totals and cur r+w.
            BATCH * (8 + 8 + 4) + touched * 8 * 2,
            2 * DEPTH * BATCH),
    }
    for name, (kern, plain, lib, nbytes, ops) in timing.items():
        rows[name] = kernel_row(name, SOURCE, err[name], kern, plain, lib,
                                nbytes, ops, torch)
        rows[name]["touched_cells"] = touched
    tile, cluster = sc.tiling(WIDTH, BATCH)
    one_target = skewed_targets(torch, sc.window_estimate_plain(
        totals, boundary, frac, o1, o2), seed)
    rows["cu_update"]["large_batch"] = large_batch(
        torch, "cu_update", rng, seed,
        lambda t, c, k1, k2, target, _: sc.cu_update(
            t, c, boundary, frac, k1, k2, target),
        lambda t, c, k1, k2, target, _: sc.cu_update_plain(
            t, c, boundary, frac, k1, k2, target),
        (totals, cur), lambda k1, k2: sc.window_estimate_plain(
            totals, boundary, frac, k1, k2), err)
    rows["cu_update"].update(
        tile=tile, cluster=cluster,
        moved_bytes=tiled_bytes(cells * (4 * 5), tile, cluster, 8 + 8 + 4),
        one_column_ms=device_ms(lambda: sc.cu_update(
            t_buf, c_buf, boundary, frac, o1, o2, one_target), torch))
    log(f"time cu_update on the one-column batch: "
        f"{rows['cu_update']['one_column_ms'] * 1e3:.2f} us")
    return rows


#: A large batch: 2^20 Zipf ids (benchmark config 3's saturation run
#: takes 2^22 a step, benchmarks/configs.py:136-137; 2^20 is the batch
#: bound of the bucket's integer admission gate).
LARGE_BATCH = 1 << 20


def large_batch(torch, name, rng, seed, kern, plain, slabs, estimate,
                err) -> dict:
    """A tiled update on LARGE_BATCH keys, where the chosen launch shape
    runs clusters: held bit-equal to its plain version, then timed beside
    it. ``kern``/``plain`` take (slab, slab, h1, h2, target, consumed);
    ``estimate`` gives the CU targets' base (None for the bucket)."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    k1, k2 = device_keys(torch, zipf_ids(rng, LARGE_BATCH))
    target = (skewed_targets(torch, estimate(k1, k2), seed)
              if estimate is not None else None)
    used = torch.from_numpy(np.where(
        rng.random(LARGE_BATCH) < 0.7,
        rng.integers(1, 3, size=LARGE_BATCH) * 1_000_000,
        0).astype(np.int64)).to("cuda")
    got = [x.clone() for x in slabs]
    ref = [x.clone() for x in slabs]
    kern(*got, k1, k2, target, used)
    plain(*ref, k1, k2, target, used)
    for a, b in zip(got, ref):
        hold_equal(torch, err, name, a, b)
    out = {"batch": LARGE_BATCH,
           "tile_cluster": list(sc.tiling(WIDTH, LARGE_BATCH)),
           "ms": device_ms(lambda: kern(*got, k1, k2, target, used), torch),
           "plain_ms": device_ms(lambda: plain(*ref, k1, k2, target, used),
                                 torch)}
    log(f"kernels: {name} bit-equal to plain on {LARGE_BATCH} Zipf keys; "
        f"tile {tuple(out['tile_cluster'])}: kernel {out['ms'] * 1e3:.2f} "
        f"us, plain {out['plain_ms'] * 1e3:.2f} us")
    return out


def one_column(torch, h1, h2):
    """The batch's keys all moved to the column of its first key (h2 = 0
    puts a key on column h1 & (w-1) in every row)."""
    return torch.full_like(h1, int(h1[0])), torch.zeros_like(h2)


def skewed_targets(torch, est, seed: int):
    """CU targets above each key's estimate by 1 to 2, a fifth of them 0
    (denied), so the per-column max decides."""
    g = torch.Generator(device=est.device).manual_seed(seed)
    u = torch.rand(est.shape, generator=g, device=est.device)
    return torch.where(u < 0.8, torch.clamp_min(est, 0.0) + 1.0 + u,
                       torch.zeros((), device=est.device))


def tiled_bytes(slab_bytes: int, tile: int, cluster: int,
                key_bytes: int) -> int:
    """Bytes a tiled update moves at config-3 geometry: its slab traffic,
    plus every cluster (every block when the cluster is 1) reading all
    keys, ``key_bytes`` each (h1, h2 and the amount; from L2 after the
    first read)."""
    clusters = DEPTH * WIDTH // (tile * cluster)
    return slab_bytes + clusters * BATCH * key_bytes


def check_bucket_kernels(torch, seed: int) -> dict:
    """The token bucket's kernels against their plain versions at d=4,
    w=65536, B=4096 Zipf ids (repeated keys): a debt slab of zeros, random
    debts and cells within 10^6 of 2^61 (some at the batch's own columns,
    so the 2^61 clamp fires), decays of 0, a moderate value and more than
    any cell; consumed holding zeros. Times and bounds at the moderate
    decay. Launches made here do not count."""
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    dev = torch.device("cuda")
    cap = bc.DEBT_CAP
    rng = np.random.default_rng(seed + 3)
    h1, h2 = device_keys(torch, zipf_ids(rng, BATCH))
    cols = sc._columns(h1, h2, DEPTH, WIDTH)

    def slab():
        x = rng.integers(0, 400_000_000, size=(DEPTH, WIDTH)).astype(np.int64)
        x[rng.random((DEPTH, WIDTH)) < 0.4] = 0
        hot = rng.random((DEPTH, WIDTH)) < 0.1
        x[hot] = cap - rng.integers(0, 1_000_000, size=int(hot.sum()))
        t = torch.from_numpy(x).to(dev)
        t.scatter_(1, cols[:, :16], cap - 10)
        return t

    debt, acc = slab(), slab()
    consumed = torch.from_numpy(np.where(
        rng.random(BATCH) < 0.7, rng.integers(1, 3, size=BATCH) * 1_000_000,
        0).astype(np.int64)).to(dev)
    consumed[:16] = 1 << 41
    touched = sum(int(torch.unique(cols[r]).numel()) for r in range(DEPTH))
    cells = DEPTH * WIDTH
    err = {"bucket_estimate": 0.0, "bucket_update": 0.0}

    moderate = 3_333_337
    for decay in (0, moderate, 1 << 62):
        est = bc.bucket_estimate(debt, decay, h1, h2)
        hold_equal(torch, err, "bucket_estimate", est,
                   bc.bucket_estimate_plain(debt, decay, h1, h2))
        got_d, got_a, ref_d, ref_a = (x.clone() for x in (debt, acc, debt,
                                                          acc))
        bc.bucket_update(got_d, got_a, decay, h1, h2, consumed)
        bc.bucket_update_plain(ref_d, ref_a, decay, h1, h2, consumed)
        hold_equal(torch, err, "bucket_update", got_d, ref_d)
        hold_equal(torch, err, "bucket_update", got_a, ref_a)
        log(f"kernels[bucket, decay {decay}]: bucket_estimate and "
            f"bucket_update bit-equal to plain; {int((got_d == cap).sum())} "
            f"debt and {int((got_a == cap).sum())} acc cells at 2^61, "
            f"{int((got_d < debt).sum())} cells decayed")
    # The one-column batch (every key on one histogram entry), and an acc
    # slab above 2^61 (only a restore brings one) clamped with clamp_acc.
    o1, o2 = one_column(torch, h1, h2)
    over = acc.clone()
    hot = torch.rand(over.shape, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev) < 0.2
    over[hot] += cap
    for a_in, clamp, c1, c2 in ((acc, False, o1, o2), (over, True, h1, h2),
                                (over, True, o1, o2)):
        got_d, got_a, ref_d, ref_a = (x.clone() for x in (debt, a_in, debt,
                                                          a_in))
        bc.bucket_update(got_d, got_a, moderate, c1, c2, consumed, clamp)
        bc.bucket_update_plain(ref_d, ref_a, moderate, c1, c2, consumed)
        hold_equal(torch, err, "bucket_update", got_d, ref_d)
        hold_equal(torch, err, "bucket_update", got_a, ref_a)
    tile, cluster = sc.tiling(WIDTH, BATCH)
    log(f"kernels[bucket]: bucket_update bit-equal to plain on the "
        f"one-column batch and, with clamp_acc, on an acc slab with "
        f"{int(hot.sum())} cells above 2^61; tile {(tile, cluster)} "
        f"(cells, cluster blocks)")
    d_buf, a_buf = debt.clone(), acc.clone()
    timing = {
        "bucket_estimate": (
            lambda: bc.bucket_estimate(debt, moderate, h1, h2),
            lambda: bc.bucket_estimate_plain(debt, moderate, h1, h2),
            # h1, h2, est per key; debt per touched cell.
            BATCH * (8 + 8 + 8) + touched * 8,
            3 * DEPTH * BATCH),
        "bucket_update": (
            lambda: bc.bucket_update(d_buf, a_buf, moderate, h1, h2,
                                     consumed),
            lambda: bc.bucket_update_plain(d_buf, a_buf, moderate, h1, h2,
                                           consumed),
            # h1, h2, consumed per key; debt r+w at every cell (the decay
            # reaches them all); acc r+w at the touched cells.
            BATCH * (8 + 8 + 8) + cells * 16 + touched * 16,
            3 * cells + 4 * DEPTH * BATCH),
    }
    rows = {}
    for name, (kern, plain, nbytes, ops) in timing.items():
        # No single PyTorch call computes either function (a decayed,
        # clamped gather-min; a dense decay fused with a capped scatter).
        rows[name] = kernel_row(name, BUCKET_SOURCE, err[name], kern, plain,
                                None, nbytes, ops, torch)
        rows[name]["touched_cells"] = touched
    rows["bucket_update"]["large_batch"] = large_batch(
        torch, "bucket_update", rng, seed,
        lambda d_, a, k1, k2, _, used: bc.bucket_update(
            d_, a, moderate, k1, k2, used),
        lambda d_, a, k1, k2, _, used: bc.bucket_update_plain(
            d_, a, moderate, k1, k2, used),
        (debt, acc), None, err)
    rows["bucket_update"].update(
        tile=tile, cluster=cluster,
        moved_bytes=tiled_bytes(cells * 16 + touched * 16, tile, cluster,
                                8 + 8 + 8),
        one_column_ms=device_ms(lambda: bc.bucket_update(
            d_buf, a_buf, moderate, o1, o2, consumed), torch))
    log(f"time bucket_update on the one-column batch: "
        f"{rows['bucket_update']['one_column_ms'] * 1e3:.2f} us")
    return rows


# --------------------------------------------------------- tile sweep


SWEEP_TILES = (1024, 2048, 4096, 8192, 16384)
SWEEP_CLUSTERS = (1, 2, 4, 8)
#: Larger Zipf batches, swept at the chosen tile over every cluster: every
#: block reads every key, so the scan grows with B and clusters pay off.
SWEEP_BATCHES = (8192, 16384, 65536, 1 << 20)


def sweep_tiles(torch, seed: int) -> list:
    """The two tiled updates at config-3 geometry. Every (tile, cluster),
    held bit-equal to the plain version on the config-3 batch and on the
    one-column batch, then timed on the config-3 batch, on B = 0 (launch
    and dense pass alone: the key scan costs the difference) and on the
    one-column batch; then, at the chosen tile, every cluster on larger
    Zipf batches, held bit-equal and timed. A tiling whose shared memory
    does not fit a block is recorded with the launch's error."""
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    totals, boundary, cur, frac = window_state(torch, rng)
    debt = torch.from_numpy(np.where(
        rng.random((DEPTH, WIDTH)) < 0.4, 0,
        rng.integers(0, 400_000_000, size=(DEPTH, WIDTH)))).to(dev)
    acc = debt.flip(1).contiguous()

    def batch_of(h1, h2):
        """Keys with CU targets above their estimates and bucket amounts
        of 1-2 tokens, 3 in 10 denied (0)."""
        n = h1.shape[0]
        consumed = torch.from_numpy(np.where(
            rng.random(n) < 0.7, rng.integers(1, 3, size=n) * 1_000_000,
            0).astype(np.int64)).to(dev)
        return (h1, h2, skewed_targets(torch, sc.window_estimate_plain(
            totals, boundary, frac, h1, h2), seed), consumed)

    def zipf_keys(n):
        return device_keys(torch, zipf_ids(rng, n))

    h1, h2 = zipf_keys(BATCH)
    batches = {"config3": batch_of(h1, h2),
               "empty": batch_of(h1[:0], h2[:0]),
               "one_column": batch_of(*one_column(torch, h1, h2))}
    batches.update((n, batch_of(*zipf_keys(n))) for n in SWEEP_BATCHES)

    def cu(state, batch, **kw):
        a, b, target, _ = batches[batch]
        fn = sc.cu_update if kw else sc.cu_update_plain
        fn(state[0], state[1], boundary, frac, a, b, target, **kw)

    def bucket(state, batch, **kw):
        a, b, _, used = batches[batch]
        fn = bc.bucket_update if kw else bc.bucket_update_plain
        fn(state[0], state[1], 3_333_337, a, b, used, **kw)

    def exact(name, run, slabs, batch, tile, cluster):
        got = [x.clone() for x in slabs]
        ref = [x.clone() for x in slabs]
        run(got, batch, tile=tile, cluster=cluster)
        run(ref, batch)
        torch.cuda.synchronize()
        if not all(map(torch.equal, got, ref)):
            raise AssertionError(f"{name} tile {tile} cluster {cluster} "
                                 f"differs from its plain version on the "
                                 f"{batch} batch")

    out = []
    for name, run, slabs in (("cu_update", cu, (totals, cur)),
                             ("bucket_update", bucket, (debt, acc))):
        buf = [x.clone() for x in slabs]
        for tile in SWEEP_TILES:
            for cluster in SWEEP_CLUSTERS:
                if cluster * tile > WIDTH:
                    continue
                row = {"name": name, "tile": tile, "cluster": cluster,
                       "batch": BATCH}
                try:
                    for batch in ("config3", "one_column"):
                        exact(name, run, slabs, batch, tile, cluster)
                except RuntimeError as exc:
                    row["error"] = str(exc)
                    log(f"sweep {name} tile {tile} cluster {cluster}: {exc}")
                    out.append(row)
                    continue
                for batch in ("config3", "empty", "one_column"):
                    row[f"{batch}_ms"] = device_ms(
                        lambda: run(buf, batch, tile=tile, cluster=cluster),
                        torch)
                row["scan_ms"] = row["config3_ms"] - row["empty_ms"]
                out.append(row)
                log(f"sweep {name} tile {tile} cluster {cluster}: "
                    + ", ".join(f"{k} {row[k] * 1e3:.2f} us" for k in
                                ("config3_ms", "empty_ms", "scan_ms",
                                 "one_column_ms")))
        for n in SWEEP_BATCHES:
            for cluster in SWEEP_CLUSTERS:
                exact(name, run, slabs, n, sc.TILE, cluster)
                row = {"name": name, "tile": sc.TILE, "cluster": cluster,
                       "batch": n, "ms": device_ms(
                           lambda: run(buf, n, tile=sc.TILE,
                                       cluster=cluster), torch)}
                out.append(row)
                log(f"sweep {name} tile {sc.TILE} cluster {cluster} batch "
                    f"{n}: {row['ms'] * 1e3:.2f} us")
    return out


# --------------------------------------------------------------- phase 3


def _trace(seed: int, steps: int):
    """Config-3 traffic: per step 4096 Zipf ids, plus the string keys that
    ``drive`` sends every 8th step (one of them overridden)."""
    rng = np.random.default_rng(seed)
    ids = zipf_ids(rng, (steps, BATCH))
    keys = [f"user:{int(k)}" for k in zipf_ids(rng, 256)] + ["tenant:whale"] * 64
    return list(ids), keys


def _trace_c2(seed: int, steps: int):
    """Config 2's traffic: per step 4096 string keys ``u:{i}``, i uniform
    over 10,000 (benchmarks/configs.py:87-89)."""
    rng = np.random.default_rng(seed)
    batches = [[f"u:{int(i)}" for i in rng.integers(0, C2_KEYS, size=BATCH)]
               for _ in range(steps)]
    keys = [f"u:{int(i)}" for i in rng.integers(0, C2_KEYS, size=256)]
    return batches, keys + ["tenant:whale"] * 64


def drive(lim, batches, keys, *, advance: float = 0.1, inflight: int = 4):
    """Run a trace through launch/resolve with up to ``inflight`` tickets
    outstanding; returns the BatchResults in launch order. A batch is an
    array of raw u64 ids (``launch_ids``, every other one wire-packed) or
    a list of string keys (``launch_batch``); every 8th step also sends
    ``keys``, one of which is overridden, and halfway through that key is
    reset."""
    pending, out = [], []
    lim.set_override("tenant:whale", 40)
    for step, batch in enumerate(batches):
        if step == len(batches) // 2:
            while pending:
                out.append(lim.resolve(pending.pop(0)))
            lim.reset("tenant:whale")
        if step % 8 == 7:
            pending.append(lim.launch_batch(keys))
        if isinstance(batch, list):
            pending.append(lim.launch_batch(batch))
        else:
            pending.append(lim.launch_ids(batch, wire=bool(step % 2)))
        while len(pending) > inflight:
            out.append(lim.resolve(pending.pop(0)))
        lim.clock.advance(advance)
    while pending:
        out.append(lim.resolve(pending.pop(0)))
    return out


def check_path(torch, name: str, cfg, batches, keys, advance: float,
               counters, required, state_keys) -> dict:
    """One main path on the card against the same trace on the CPU: every
    result field and the final state bit-identical. ``counters`` are the
    kernel modules whose launch counts are set to 0 just before the run
    and read just after it; each kernel named in ``required`` must have
    launched."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    gpu = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                         device="cuda")
    # Warm-up on a throwaway limiter (first-call costs), then the run.
    warm = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                          device="cuda")
    drive(warm, batches[:4], keys, advance=advance)
    warm.close()
    torch.cuda.synchronize()
    for mod in counters:
        mod.reset_launch_counts()
    t = time.perf_counter()
    got = drive(gpu, batches, keys, advance=advance)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {}
    for mod in counters:
        counts.update(mod.launch_counts())
    _, gpu_arrays, extra = gpu.capture_state()
    gpu.close()

    cpu = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                         device="cpu")
    want = drive(cpu, batches, keys, advance=advance)
    _, cpu_arrays, _ = cpu.capture_state()
    cpu.close()
    if len(got) != len(want):
        raise AssertionError(f"{name}: result count differs")
    decisions = 0
    for i, (a, b) in enumerate(zip(got, want)):
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{name} batch {i}: {f} differs from "
                                     f"the CPU run")
        if (a.limits is None) != (b.limits is None) or (
                a.limits is not None and not np.array_equal(a.limits,
                                                            b.limits)):
            raise AssertionError(f"{name} batch {i}: limits differ")
        if not (np.isfinite(a.retry_after).all()
                and np.isfinite(a.reset_at).all()
                and (a.remaining >= 0).all()):
            raise AssertionError(f"{name} batch {i}: malformed result")
        decisions += len(a)
    for k in state_keys:
        if not np.array_equal(gpu_arrays[k], cpu_arrays[k]):
            raise AssertionError(f"{name}: final state {k} differs from the "
                                 f"CPU run")
    for k in required:
        if counts[k] == 0:
            raise AssertionError(f"{name}: {k} was not launched on the main "
                                 f"path")
    denied = sum(int((~r.allowed).sum()) for r in got)
    out = {"counts": counts, "steps_per_s": len(got) / wall,
           "decisions_per_s": decisions / wall, "wall_s": wall,
           "batches": len(got), "decisions": decisions, "denied": denied,
           "extra": {k: v for k, v in extra.items() if k != "saved_at"}}
    log(f"main path {name}: {len(got)} batches, {decisions} decisions, "
        f"{denied} denied, bit-identical to the CPU run; launches {counts}; "
        f"{out['steps_per_s']:.1f} steps/s, {out['decisions_per_s']:.0f} "
        f"decisions/s (wall {wall:.3f} s, launch/resolve with 4 in flight)")
    return out


def check_main_path(torch, seed: int, steps: int, cu: bool) -> dict:
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    batches, keys = _trace(seed, steps)
    out = check_path(torch, f"windowed cu={cu}", config3(cu=cu), batches,
                     keys, 0.1, [sc],
                     ("window_estimate", "cu_update") if cu
                     else ("window_estimate", "add_update"),
                     ("cur", "slabs", "totals", "slab_period", "last_period"))
    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    out["rollovers"] = int(out["extra"]["host_period"]
                           - int(T0 * 1e6) // sub_us)
    if out["rollovers"] < 3:
        raise AssertionError(f"only {out['rollovers']} rollovers")
    return out


def check_bucket_path(torch, seed: int, cell: str, steps: int) -> dict:
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc

    if cell == "TB-c2":
        cfg = config2_bucket()
        batches, keys = _trace_c2(seed, steps)
        advance = C2_ADVANCE
    else:
        cfg = config3("TOKEN_BUCKET")
        batches, keys = _trace(seed, steps)
        advance = 0.1
    out = check_path(torch, cell, cfg, batches, keys, advance, [bc],
                     ("bucket_estimate", "bucket_update"),
                     ("debt", "acc", "rem", "last"))
    if cell == "TB-zipf" and out["denied"] == 0:
        raise AssertionError("TB-zipf denied nothing: retry not exercised")
    return out


def profile_path(torch, name: str, cfg, batches, keys, advance: float,
                 warm: int = 16) -> dict:
    """Where a main-path step's time goes: ``torch.profiler`` over the
    batches after ``warm`` warm-up ones. Device busy share is the union
    of device-op intervals over the span from the first to the last; the
    profiler's own overhead lengthens the span, so the share is a lower
    bound on what an unprofiled run keeps the card busy."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch import ManualClock, create_limiter

    lim = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                         device="cuda")
    drive(lim, batches[:warm], keys, advance=advance)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n_batches = len(drive(lim, batches[warm:], keys, advance=advance))
        torch.cuda.synchronize()
    lim.close()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
            continue
        if cur is not None:
            busy += cur[1] - cur[0]
        cur = [a, b]
    busy += cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"batches": n_batches, "device_busy_share": busy / span,
           "device_us_per_batch": busy / n_batches,
           "device_ops_per_batch": len(dev) / n_batches,
           "top_device_us_per_batch": {k[:60]: v / n_batches for k, v in top}}
    log(f"profile {name}: {n_batches} batches, device busy "
        f"{out['device_busy_share']:.3f} of the span, "
        f"{out['device_us_per_batch']:.1f} us of device work and "
        f"{out['device_ops_per_batch']:.0f} device ops per batch; top: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in
                    out["top_device_us_per_batch"].items()))
    return out


# --------------------------------------------------------------- phase 4


def check_server(torch, seed: int, cfg, label: str) -> None:
    """A server on 127.0.0.1:0 serving a limiter of ``cfg`` on the card
    answers ALLOW_HASHED, ALLOW_BATCH, RESET, ALLOW_N and HEALTH frames as
    an in-process mirror limiter decides the same trace."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.serving import protocol as p
    from ratelimiter_tpu_torch.serving.server import run_server

    served = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                            device="cuda")
    mirror = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                            device="cuda")
    rng = np.random.default_rng(seed + 1)

    async def roundtrip(reader, writer, frame):
        writer.write(frame)
        await writer.drain()
        length, type_, _ = p.parse_header(await reader.readexactly(13))
        return type_, await reader.readexactly(length - 9)

    async def main():
        srv = await run_server(served, "127.0.0.1", 0)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            for i in range(4):
                ids = zipf_ids(rng, 1024)
                t, body = await roundtrip(reader, writer,
                                          p.encode_allow_hashed(i, ids))
                if t != p.T_RESULT_HASHED:
                    raise AssertionError(f"ALLOW_HASHED answered type {t}")
                got, want = p.parse_result_hashed(body), mirror.allow_ids(ids)
                for f in ("allowed", "remaining", "retry_after", "reset_at"):
                    if not np.array_equal(getattr(got, f), getattr(want, f)):
                        raise AssertionError(f"server {f} differs")
                keys = [f"user:{int(k)}" for k in zipf_ids(rng, 64)]
                t, body = await roundtrip(
                    reader, writer, p.encode_allow_batch(10 + i, keys,
                                                         [1] * 64))
                if (t != p.T_RESULT_BATCH or p.parse_result_batch(body)
                        != mirror.allow_batch(keys).results()):
                    raise AssertionError("server ALLOW_BATCH differs")
            t, _ = await roundtrip(reader, writer, p.encode_reset(20, "user:1"))
            mirror.reset("user:1")
            if t != p.T_OK:
                raise AssertionError(f"RESET answered type {t}")
            t, body = await roundtrip(reader, writer,
                                      p.encode_allow_n(21, "user:1", 3))
            if t != p.T_RESULT or p.parse_result(body) != mirror.allow_n(
                    "user:1", 3):
                raise AssertionError("server ALLOW_N after RESET differs")
            t, body = await roundtrip(reader, writer,
                                      p.encode_simple(p.T_HEALTH, 99))
            serving, _, decisions = p.parse_health(body)
            if t != p.T_HEALTH_R or not serving or decisions != 4 * 1088 + 1:
                raise AssertionError(f"bad HEALTH answer {serving} {decisions}")
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()

    asyncio.run(main())
    served.close()
    mirror.close()
    log(f"server[{label}]: ALLOW_HASHED x4 (1024 ids), ALLOW_BATCH x4 (64 "
        f"keys), RESET, ALLOW_N and HEALTH answered, matching an "
        f"in-process limiter")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--sweep", action="store_true",
                    help="only build, then sweep the tiled updates' tile, "
                         "cluster and batch sizes (one JSON line)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ratelimiter_tpu_torch.ops import _build, bucket_cuda, sketch_cuda

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t = time.perf_counter()
    _build.build_all(["sketch_kernels", "bucket_kernels"])
    sketch_cuda.build()
    bucket_cuda.build()
    log(f"build: kernels built and loaded in {time.perf_counter() - t:.1f} s "
        f"on {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    if args.sweep:
        print(json.dumps({"card": card, "sweep": sweep_tiles(torch,
                                                             args.seed)}))
        print(card)
        return 0

    rows = check_kernels(torch, args.seed)
    rows.update(check_bucket_kernels(torch, args.seed))
    cu = check_main_path(torch, args.seed, args.steps, cu=True)
    vanilla = check_main_path(torch, args.seed + 7, max(32, args.steps // 2),
                              cu=False)
    tb_c2 = check_bucket_path(torch, args.seed + 11, "TB-c2", args.steps)
    tb_zipf = check_bucket_path(torch, args.seed + 13, "TB-zipf",
                                max(32, args.steps // 2))
    for name in rows:
        rows[name]["launches"] = sum(run["counts"].get(name, 0) for run in
                                     (cu, vanilla, tb_c2, tb_zipf))
    log(f"main paths on {card}: " + "; ".join(
        f"{label} {run['steps_per_s']:.1f} steps/s, "
        f"{run['decisions_per_s']:.0f} decisions/s"
        for label, run in (("windowed CU", cu), ("windowed vanilla", vanilla),
                           ("TB-c2", tb_c2), ("TB-zipf", tb_zipf))))
    batches, keys = _trace(args.seed, 48)
    prof = profile_path(torch, "windowed cu=True", config3(), batches, keys,
                        0.1)
    prof_tb = profile_path(torch, "TB-zipf", config3("TOKEN_BUCKET"),
                           batches, keys, 0.1)
    check_server(torch, args.seed, config3(), "windowed")
    check_server(torch, args.seed, config2_bucket(), "TB-c2")

    log(json.dumps({"main_path": {
        "card": card, "cu": cu, "vanilla": vanilla, "profile": prof,
        "TB-c2": tb_c2, "TB-zipf": tb_zipf, "profile_TB-zipf": prof_tb}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
