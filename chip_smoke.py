#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--steps N]
    python3 chip_smoke.py --sweep    # time the tiled updates' launch shapes
    python3 chip_smoke.py --admit-sweep   # time the admission routine's shapes

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
   decays; the two front kernels (``window_front``, ``bucket_front``, in
   the rows of the TPU estimates they replace) on every output, on the
   halves lane without a policy and on the raw-id lane with a 1024-row
   policy table (shared memory) and a 2^14-row one (global memory), with
   and without ``n``, timed on the raw-id lane with the 1024-row table
   (the main path's form) and on the halves lane without ``n`` (the TPU
   kernel's own function) at 64, 128 and 256 threads a block; the two
   tiled updates (``cu_update``, ``bucket_update``) also on
   a batch whose 4096 keys share one column and on 2^20 Zipf keys (where
   their launch shape switches to clusters), and ``bucket_update`` with
   ``clamp_acc`` on an ``acc`` slab holding cells above 2^61; the tile and
   cluster each uses are logged; the three backs of the step (``add_back``,
   the vanilla step's admission, scatter and remaining in one launch, in
   the row of the TPU ``add_update``; ``window_admit`` and
   ``bucket_admit``, the admission launches ahead of ``cu_update`` and
   ``bucket_update``) on the config-3 batch, 4096 keys all on one key,
   keys sharing h1 but not h2, B = 0, B = ``ADMIT_CAPACITY`` and the next
   pad above it, where the wrappers
   run the composed back (plain admission on the card, then the
   standalone ``add_update`` kernel) and the launch counts must show it;
3. drive each main path end to end through ``create_limiter(...,
   device="cuda")`` with launch/resolve and 4 tickets in flight, a policy
   override and a reset, and hold every result and the final state
   bit-identical to the same trace on the CPU (the plain versions, which
   the CPU tests hold to the JAX package). Each path's launch counts are
   set to 0 just before it and read just after, and each of its kernels
   must have launched; the same trace then runs 4 more times on fresh
   limiters, and the median, min and max steps/s of the 5 are printed.
   Windowed: config-3 traffic across sub-window rollovers, with
   conservative update on and off, then a profile of a short CU and a
   short vanilla run. Token bucket: TB-c2, benchmark config 2's token-bucket
   cell at its literal parameters (limit 20 per 10 s, 4096 string keys
   per batch uniform over 10,000, +0.25 s per batch), and TB-zipf, config
   3's traffic under a token bucket (limit 100 per 60 s, +0.1 s per
   batch), then a profile of a short TB-zipf run. Each profile counts the
   device ops per batch and fails if a sort or scan op (the plain
   admission's) still runs on a path whose batches fit one admission
   launch;
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

``--admit-sweep`` builds, then times the admission routine alone
(``csrc/admit_bench.cu``) at the block shapes and sort digit widths of
``ADMIT_SWEEP`` and beside its first design, each held bit-equal to
``segment.admit`` first, printing the results as one JSON line before the
card's line.

``--paths`` builds, then runs phase 3 alone and prints its results as one
JSON line before the card's line. It reaches the port only through
``create_limiter``, the limiters' public methods and the launch counters,
so a copy of this script placed in an earlier checkout measures that
checkout's package on the same card (parent and change in one call).

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
    "add_back": "ratelimiter_tpu/ops/pallas_sketch.py:224",
    "bucket_estimate": "ratelimiter_tpu/ops/pallas_sketch.py:270",
    "bucket_update": "ratelimiter_tpu/ops/pallas_sketch.py:302",
    # The admission launches replace no TPU kernel: the reference's
    # in-batch admission, a jitted JAX function.
    "window_admit": "ratelimiter_tpu/ops/segment.py:90",
    "bucket_admit": "ratelimiter_tpu/ops/segment.py:90",
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
    delta = (a.double() - b.double() if a.is_floating_point()
             else a.to(torch.int64) - b.to(torch.int64))
    diff = float(delta.abs().max()) if delta.numel() else 0.0
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
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.sketch_kernels import frac_operands

    def slab(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=(
            DEPTH, WIDTH)).astype(np.int32)).to("cuda")
    totals, boundary, cur = slab(-3, 300), slab(-2, 200), slab(-3, 30)
    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    p = int(T0 * 1e6) // sub_us
    frac = sc.frac_plain(*frac_operands(p, p * sub_us + 377_123,
                                        sub_us)).to("cuda")
    return totals, boundary, cur, frac


def ring_boundary(torch, slab, stale: bool = False):
    """The front's view of ``slab`` as config 3's boundary sub-window,
    0.377 s into period p (the weight ``window_state`` gives), in a ring
    of SUB_WINDOWS slots whose slot p % S holds period p - S (or, stale,
    an older one)."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.sketch_kernels import frac_operands

    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    p = int(T0 * 1e6) // sub_us
    slot = p % SUB_WINDOWS
    periods = torch.full((SUB_WINDOWS,), -(1 << 40), dtype=torch.int64,
                         device="cuda")
    periods[slot] = p - SUB_WINDOWS - int(stale)
    return sc.Boundary(slab, periods, slot, p - SUB_WINDOWS,
                       *frac_operands(p, p * sub_us + 377_123, sub_us))


#: The default policy capacity (PolicySpec.capacity) and a capacity whose
#: key column is searched in global memory (above 4096 rows).
POLICY_CAPACITY, LARGE_POLICY = 1024, 1 << 14
SEED = 0x5BD1E995


def policy_table(torch, ids: np.ndarray, capacity: int, limit: int):
    """A device override table of ``capacity`` rows: 64 of the batch's
    keys (raw ids, hashed as the raw-id lane hashes them) and 64 others,
    each with its own limit below ``limit``, the rest PAD_KEY rows holding
    ``limit``."""
    from ratelimiter_tpu_torch.ops.hashing import split_hash, splitmix64
    from ratelimiter_tpu_torch.ops.policy_kernels import (
        empty_arrays,
        pack_halves_host,
    )

    rng = np.random.default_rng(capacity)
    q = np.unique(pack_halves_host(*split_hash(splitmix64(ids), SEED)))
    keys = np.unique(np.concatenate([q[:: max(1, len(q) // 64)][:64],
                                     rng.integers(-(1 << 63), (1 << 63) - 1,
                                                  size=64, dtype=np.int64)]))
    arrays = empty_arrays(capacity, {"limit": limit})
    arrays["key"][:len(keys)] = keys
    arrays["limit"][:len(keys)] = rng.integers(1, limit, size=len(keys))
    return {k: torch.from_numpy(v).to("cuda") for k, v in arrays.items()}


#: The front kernels' launch shapes timed in phase 2 (threads per block).
FRONT_SHAPES = (64, 128, 256)
#: The lane timed like the TPU kernel: halves given, no policy, no n.
TPU_LANE = "halves, estimate only"


def hold_front(torch, err: dict, name: str, got, want) -> None:
    """Every output of a front kernel bit-equal to its plain version's
    (None where the plain version gives None)."""
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{name}: an output is missing")
        if a is not None:
            if a.dtype != b.dtype:
                raise AssertionError(f"{name}: dtype {a.dtype} != {b.dtype}")
            hold_equal(torch, err, name, a, b)


def front_bytes(B: int, key_bytes: int, out_bytes: int, touched: int,
                cell_bytes: int, capacity: int) -> int:
    """A front's bytes: each key's staged key, n and outputs once, each
    touched cell once, and the policy key column once."""
    return B * (key_bytes + 4 + out_bytes) + touched * cell_bytes + capacity * 8


def front_moved_bytes(nbytes: int, B: int, capacity: int) -> int:
    """What the front's design moves beyond ``nbytes``: every block but
    the first stages the key column into its shared memory again (from
    L2 after the first read), ceil(B / FRONT_THREADS) blocks in all."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    return nbytes + (-(-B // sc.FRONT_THREADS) - 1) * capacity * 8


def front_ops(B: int, capacity: int) -> int:
    """A front's integer and f32 operations on the raw-id lane: two
    splitmix64 rounds and the split (~20), per row a column, a read and a
    min (4), the descent (2 per step) and the quota (~2)."""
    return B * (20 + 4 * DEPTH + 2 * (capacity.bit_length()) + 2)


def front_row(torch, name: str, kern, lanes: dict, tpu_bytes: int) -> dict:
    """The front's timings beyond its kernel row: each lane (``kern(
    lane_kwargs)``) at every launch shape (``sketch_cuda.FRONT_THREADS``
    set for the timing, then restored), logged; the TPU kernel's own
    function (``TPU_LANE``) at the chosen shape, and its bound
    (``tpu_bytes`` over the HBM rate)."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    chosen = sc.FRONT_THREADS
    shape_ms = {}
    for lane, kw in lanes.items():
        shape_ms[lane] = {}
        for t in FRONT_SHAPES:
            sc.FRONT_THREADS = t
            try:
                shape_ms[lane][t] = device_ms(lambda: kern(kw), torch)
            finally:
                sc.FRONT_THREADS = chosen
        log(f"time {name} [{lane}]: " + ", ".join(
            f"{t} threads {ms * 1e3:.2f} us"
            for t, ms in shape_ms[lane].items()))
    return {"threads": sc.FRONT_THREADS,
            "shape_ms": {lane: {str(t): ms for t, ms in by.items()}
                         for lane, by in shape_ms.items()},
            "tpu_lane_ms": shape_ms[TPU_LANE][sc.FRONT_THREADS],
            "tpu_lane_bound_ms": tpu_bytes / HBM_BYTES_PER_S * 1e3}


def check_kernels(torch, seed: int) -> dict:
    """Each kernel against its plain version at config-3 shapes, sliding
    and fixed; times and bounds. Launches made here do not count."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.hashing import u64_to_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    ids = zipf_ids(rng, BATCH)
    h1, h2 = device_keys(torch, ids)
    raw = u64_to_tensor(ids, dev)
    totals, boundary, cur, frac = window_state(torch, rng)
    add = torch.from_numpy(
        rng.integers(0, 3, size=BATCH).astype(np.int32)).to(dev)
    n = add + 1

    # Cells the batch touches (the data-dependent part of the bounds).
    cols = sc._columns(h1, h2, DEPTH, WIDTH)
    touched = sum(int(torch.unique(cols[r]).numel()) for r in range(DEPTH))
    cells = DEPTH * WIDTH

    rows = {}
    err = {"window_estimate": 0.0, "cu_update": 0.0, "add_update": 0.0}

    def note(name, pairs):
        for a, b in pairs:
            hold_equal(torch, err, name, a, b)

    # The front: the halves lane without a policy (the TPU kernel's own
    # function), and the raw-id lane with the default-capacity table (in
    # shared memory) and a 2^14-row one (in global memory); sliding with
    # a valid and a stale boundary, and fixed; with n and without (the
    # reset's estimate-only form).
    table = policy_table(torch, ids, POLICY_CAPACITY, LIMIT)
    lanes = {"halves": dict(keys=(h1, h2)),
             "raw ids + policy": dict(keys=raw, premix=True, seed=SEED,
                                      policy=table),
             "raw ids + 2^14 policy": dict(
                 keys=raw, premix=True, seed=SEED,
                 policy=policy_table(torch, ids, LARGE_POLICY, LIMIT))}
    valid = ring_boundary(torch, boundary)
    for b in (valid, ring_boundary(torch, boundary, stale=True), None):
        for kw in lanes.values():
            for nn in (n, None):
                hold_front(torch, err, "window_estimate",
                           sc.window_front(totals, n=nn, boundary=b,
                                           limit=LIMIT, **kw),
                           sc.window_front_plain(totals, n=nn, boundary=b,
                                                 limit=LIMIT, **kw))
    log(f"kernels: window_front bit-equal to plain on {len(lanes)} lanes "
        f"x 3 boundary modes x with/without n; {FRONT_SHAPES} threads "
        f"timed below, {sc.FRONT_THREADS} chosen")
    for bnd in (boundary, None):
        mode = "sliding" if bnd is not None else "fixed"
        fr = frac if bnd is not None else None
        est = torch.clamp_min(
            sc.window_estimate_plain(totals, bnd, fr, h1, h2), 0.0)
        target = torch.where(torch.rand(BATCH, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev) < 0.8,
            est + 1.0, torch.zeros((), device=dev))
        got_t, got_c = totals.clone(), cur.clone()
        sc.cu_update(got_t, got_c, bnd, fr, h1, h2, target)
        ref_t, ref_c = totals.clone(), cur.clone()
        sc.cu_update_plain(ref_t, ref_c, bnd, fr, h1, h2, target)
        note("cu_update", [(got_t, ref_t), (got_c, ref_c)])
        grown = int(((totals < 0) & (got_t > totals)).sum())
        log(f"kernels[{mode}]: cu_update bit-equal to plain; "
            f"{int((got_t != totals).sum())} cells raised, {grown} of "
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
    main = dict(lanes["raw ids + policy"], n=n)
    timing = {
        "window_estimate": (
            lambda: sc.window_front(totals, boundary=valid, limit=LIMIT,
                                    **main),
            lambda: sc.window_front_plain(totals, boundary=valid,
                                          limit=LIMIT, **main),
            None,
            # raw id and n in; h1, h2, est, avail, n_f out; totals and
            # boundary per touched cell; the table's key column once.
            front_bytes(BATCH, 8, 16 + 12, touched, 8, POLICY_CAPACITY)
            + 4 + 8,
            front_ops(BATCH, POLICY_CAPACITY)),
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
    rows["window_estimate"]["moved_bytes"] = front_moved_bytes(
        rows["window_estimate"]["bytes"], BATCH, POLICY_CAPACITY)
    rows["window_estimate"].update(front_row(
        torch, "window_front", lambda kw: sc.window_front(
            totals, boundary=valid, limit=LIMIT, **kw),
        {TPU_LANE: lanes["halves"],
         "raw ids": dict(keys=raw, premix=True, seed=SEED, n=n),
         "raw ids + policy": main},
        # h1, h2 in, est out (no n); totals and boundary per touched cell.
        BATCH * (16 + 4) + touched * 8 + 4 + 8))
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
    from ratelimiter_tpu_torch.ops.hashing import u64_to_tensor

    dev = torch.device("cuda")
    cap = bc.DEBT_CAP
    rng = np.random.default_rng(seed + 3)
    ids = zipf_ids(rng, BATCH)
    h1, h2 = device_keys(torch, ids)
    raw = u64_to_tensor(ids, dev)
    n = torch.from_numpy(rng.integers(1, 4, size=BATCH).astype(
        np.int32)).to(dev)
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
    # The front on the lanes and tables of the windowed one (above).
    table = policy_table(torch, ids, POLICY_CAPACITY, LIMIT)
    lanes = {"halves": dict(keys=(h1, h2)),
             "raw ids + policy": dict(keys=raw, premix=True, seed=SEED,
                                      policy=table),
             "raw ids + 2^14 policy": dict(
                 keys=raw, premix=True, seed=SEED,
                 policy=policy_table(torch, ids, LARGE_POLICY, LIMIT))}
    for decay in (0, moderate, 1 << 62):
        for kw in lanes.values():
            for nn in (n, None):
                hold_front(torch, err, "bucket_estimate",
                           bc.bucket_front(debt, decay, n=nn, limit=LIMIT,
                                           **kw),
                           bc.bucket_front_plain(debt, decay, n=nn,
                                                 limit=LIMIT, **kw))
        got_d, got_a, ref_d, ref_a = (x.clone() for x in (debt, acc, debt,
                                                          acc))
        bc.bucket_update(got_d, got_a, decay, h1, h2, consumed)
        bc.bucket_update_plain(ref_d, ref_a, decay, h1, h2, consumed)
        hold_equal(torch, err, "bucket_update", got_d, ref_d)
        hold_equal(torch, err, "bucket_update", got_a, ref_a)
        log(f"kernels[bucket, decay {decay}]: bucket_front ({len(lanes)} "
            f"lanes, with/without n) and bucket_update bit-equal to plain; "
            f"{int((got_d == cap).sum())} "
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
    main = dict(lanes["raw ids + policy"], n=n)
    timing = {
        "bucket_estimate": (
            lambda: bc.bucket_front(debt, moderate, limit=LIMIT, **main),
            lambda: bc.bucket_front_plain(debt, moderate, limit=LIMIT,
                                          **main),
            # raw id and n in; h1, h2, est, avail, n_units out; debt per
            # touched cell; the table's key column once.
            front_bytes(BATCH, 8, 16 + 24, touched, 8, POLICY_CAPACITY),
            front_ops(BATCH, POLICY_CAPACITY)),
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
        # No single PyTorch call computes either function (hashing, a
        # decayed gather-min and a table search; a dense decay fused with
        # a capped scatter).
        rows[name] = kernel_row(name, BUCKET_SOURCE, err[name], kern, plain,
                                None, nbytes, ops, torch)
        rows[name]["touched_cells"] = touched
    rows["bucket_estimate"]["moved_bytes"] = front_moved_bytes(
        rows["bucket_estimate"]["bytes"], BATCH, POLICY_CAPACITY)
    rows["bucket_estimate"].update(front_row(
        torch, "bucket_front", lambda kw: bc.bucket_front(
            debt, moderate, limit=LIMIT, **kw),
        {TPU_LANE: lanes["halves"],
         "raw ids": dict(keys=raw, premix=True, seed=SEED, n=n),
         "raw ids + policy": main},
        # h1, h2 in, est out (no n); debt per touched cell.
        BATCH * (16 + 8) + touched * 8))
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


#: The step's admission fixpoint rounds (Config.max_batch_admission_iters).
ITERS = 4


def back_batches(rng) -> dict:
    """The admission launches' batches: the config-3 batch (4096 Zipf
    ids), 4096 requests all for one key (one segment of 4096, the skewed
    extreme), the config-3 ids with h1 cut to 6 bits (``check_backs``:
    keys that share h1 but not h2, so admission's groups are not the
    scatter's keys), none, ``ADMIT_CAPACITY`` Zipf ids and the limiter's
    next pad above it."""
    from ratelimiter_tpu_torch.algorithms.sketch import _pad_size
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    ids = zipf_ids(rng, BATCH)
    return {"config3": ids, "one key": np.full(BATCH, ids[0]),
            "shared h1": ids, "empty": ids[:0],
            "capacity": zipf_ids(rng, sc.ADMIT_CAPACITY),
            "above capacity": zipf_ids(rng, _pad_size(sc.ADMIT_CAPACITY + 1))}


def back_row(torch, name: str, source: str, err: float, batches: dict,
             nbytes: int, ops: int) -> dict:
    """A back's row: timed on the config-3 batch (``batches[name]`` maps
    each batch to its (kernel, plain) callables), and every other batch
    timed beside it."""
    kern, plain = batches["config3"]
    row = kernel_row(name, source, err, kern, plain, None, nbytes, ops,
                     torch)
    row["batches"] = {}
    for label, (k, p) in batches.items():
        ms = row["ms"] if label == "config3" else device_ms(k, torch)
        plain_ms = (row["plain_ms"] if label == "config3"
                    else device_ms(p, torch))
        row["batches"][label] = {"ms": ms, "plain_ms": plain_ms}
        log(f"time {name} [{label}]: {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us")
    return row


def back_calls(sc, bc, t, c, h1, h2, n, n_f, avail, est, units, b_avail,
               rate_num, rate_den) -> dict:
    """{back: (kernel call, plain call)} on one batch's operands (the
    vanilla back on its own copies ``t``/``c`` of the slabs)."""
    return {
        "add_back": (
            lambda: sc.add_back(t, c, h1, h2, n, n_f, avail, ITERS),
            lambda: sc.add_back_plain(t, c, h1, h2, n, n_f, avail, ITERS)),
        "window_admit": (
            lambda: sc.window_admit(h1, est, n_f, avail, ITERS),
            lambda: sc.window_admit_plain(h1, est, n_f, avail, ITERS)),
        "bucket_admit": (
            lambda: bc.bucket_admit(h1, units, b_avail, ITERS, rate_num,
                                    rate_den),
            lambda: bc.bucket_admit_plain(h1, units, b_avail, ITERS,
                                          rate_num, rate_den)),
    }


def check_backs(torch, seed: int) -> dict:
    """The three backs of the step against their plain versions on every
    batch of ``back_batches``, from the fronts' outputs on a windowed state
    and a debt slab at config-3 geometry (request counts 0-3, 0 being
    padding); the launch counts must show the fused form up to
    ``ADMIT_CAPACITY`` keys and the composed one above it. Times and bounds
    on the config-3 batch. Launches made here do not count."""
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    totals, boundary, cur, _ = window_state(torch, rng)
    valid = ring_boundary(torch, boundary)
    debt = torch.from_numpy(rng.integers(0, 100_000_000, size=(
        DEPTH, WIDTH)).astype(np.int64)).to(dev)
    rate_num, rate_den = 5, 3          # config 3's refill under TOKEN_BUCKET
    err = {"add_back": 0.0, "window_admit": 0.0, "bucket_admit": 0.0}
    timed = {name: {} for name in err}
    info = {}
    for label, ids in back_batches(rng).items():
        B = len(ids)
        h1, h2 = device_keys(torch, ids)
        if label == "shared h1":
            h1 = h1 & 63
        n = torch.from_numpy(rng.integers(0, 4, size=B).astype(
            np.int32)).to(dev)
        # A limit above the slab's counts, so that avail varies per key and
        # hot keys meet it within the batch.
        _, _, est, _, avail, n_f = sc.window_front(
            totals, (h1, h2), n, boundary=valid, limit=4 * LIMIT)
        _, _, _, b_avail, units = bc.bucket_front(debt, 0, (h1, h2), n,
                                                  limit=LIMIT)
        fused = B <= sc.ADMIT_CAPACITY
        sc.reset_launch_counts()
        bc.reset_launch_counts()
        t, c, t2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
        got = sc.add_back(t, c, h1, h2, n, n_f, avail, ITERS)
        want = sc.add_back_plain(t2, c2, h1, h2, n, n_f, avail, ITERS)
        for a, b in zip([*got, t, c], [*want, t2, c2]):
            hold_equal(torch, err, "add_back", a, b)
        for a, b in zip(sc.window_admit(h1, est, n_f, avail, ITERS),
                        sc.window_admit_plain(h1, est, n_f, avail, ITERS)):
            hold_equal(torch, err, "window_admit", a, b)
        for a, b in zip(
                bc.bucket_admit(h1, units, b_avail, ITERS, rate_num,
                                rate_den),
                bc.bucket_admit_plain(h1, units, b_avail, ITERS, rate_num,
                                      rate_den)):
            hold_equal(torch, err, "bucket_admit", a, b)
        counts = {**sc.launch_counts(), "bucket admit": bc.launch_counts()[
            "admit"]}
        want_counts = {"add_update": 1, "add_back": int(fused),
                       "admit": int(fused), "bucket admit": int(fused)}
        if any(counts[k] != v for k, v in want_counts.items()):
            raise AssertionError(f"backs at B={B}: launch counts {counts}, "
                                 f"expected {want_counts}")
        allowed = want[0]
        info[label] = {"batch": B, "form": "fused" if fused else "composed",
                       "allowed": int(allowed.sum()),
                       "denied": int((~allowed).sum())}
        log(f"kernels: add_back, window_admit and bucket_admit bit-equal to "
            f"plain on the {label} batch (B={B}, {info[label]['form']} "
            f"form, {info[label]['allowed']} allowed, "
            f"{info[label]['denied']} denied; launches {counts})")
        for name, pair in back_calls(sc, bc, totals.clone(), cur.clone(),
                                     h1, h2, n, n_f, avail, est, units,
                                     b_avail, rate_num, rate_den).items():
            timed[name][label] = pair
        if label == "config3":
            # Cells the admitted amounts reach (the scatter's data-
            # dependent bytes): both slabs read and written there.
            changed = int((t2 != totals).sum())
    B = BATCH
    ops = B * (6 * (ITERS + 2) + 40)
    rows = {
        # h1, h2, n, n_f, avail in; allowed, remaining out; the cells the
        # admitted amounts reach, in totals and cur, read and written.
        "add_back": back_row(torch, "add_back", SOURCE, err["add_back"],
                             timed["add_back"],
                             B * (8 + 8 + 4 + 4 + 4 + 1 + 4) + changed * 16,
                             ops + 2 * DEPTH * B),
        # h1, est, n_f, avail in; target, allowed, remaining out.
        "window_admit": back_row(torch, "window_admit", SOURCE,
                                 err["window_admit"], timed["window_admit"],
                                 B * (8 + 4 + 4 + 4 + 4 + 1 + 4), ops),
        # h1, n_units, avail in; allowed, consumed, remaining, retry out.
        "bucket_admit": back_row(torch, "bucket_admit", BUCKET_SOURCE,
                                 err["bucket_admit"], timed["bucket_admit"],
                                 B * (8 + 8 + 8 + 1 + 8 + 8 + 8), ops),
    }
    # What each design reads twice: the admission reads h1 and the
    # quantity and avail once each (coalesced, staged in shared memory);
    # the epilogue, in batch order, reads the quantity again, avail again
    # (window_admit) and h1 again (add_back).
    again = {"add_back": 4 + 8, "window_admit": 4 + 4, "bucket_admit": 8}
    for name, row in rows.items():
        row["batch_info"] = info
        row["moved_bytes"] = row["bytes"] + B * again[name]
    rows["add_back"]["changed_cells"] = changed
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


#: The admission routine's sweep (``--admit-sweep``): (design, threads,
#: keys a thread, sort digit bits, int64) as csrc/admit_bench.cu builds
#: them. Design 0 is the routine, design 1 its first form (sorting the
#: 64-bit keys themselves).
ADMIT_SWEEP = (
    [(0, t, i, 5, q) for q in (0, 1) for t, i in (
        (64, 4), (256, 4), (1024, 4), (512, 8), (256, 16), (1024, 8),
        (512, 16))]
    + [(0, t, i, 4, q) for q in (0, 1) for t, i in ((512, 8), (1024, 8))]
    + [(1, 1024, 4, 4, 0), (1, 512, 8, 4, 0)])


def admit_sweep(torch, seed: int) -> list:
    """The admission routine alone (csrc/admit_bench.cu) at every block
    shape and digit width of ``ADMIT_SWEEP``, at B = the shape's capacity,
    on Zipf ids, on one key and on distinct keys, from the fronts'
    outputs as ``check_backs`` makes them: held bit-equal to
    ``segment.admit`` on the card (allowed and seen), then timed."""
    import ctypes

    from ratelimiter_tpu_torch.ops import _build
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.segment import admit

    lib = ctypes.CDLL(_build.compile_source("admit_bench"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rl_admit_bench.argtypes = [I, I, I, I, I, P, P, P, P, P, I, I, P]
    lib.rl_admit_bench.restype = ctypes.c_int
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)
    totals, boundary, _, _ = window_state(torch, rng)
    valid = ring_boundary(torch, boundary)
    debt = torch.from_numpy(rng.integers(0, 100_000_000, size=(
        DEPTH, WIDTH)).astype(np.int64)).to(dev)
    batches = {}
    for B in sorted({t * i for _, t, i, _, _ in ADMIT_SWEEP}):
        zipf = zipf_ids(rng, B)
        for label, ids in (("zipf", zipf), ("one key", np.full(B, zipf[0])),
                           ("distinct", np.arange(B, dtype=np.uint64))):
            h1, h2 = device_keys(torch, ids)
            n = torch.from_numpy(rng.integers(0, 4, size=B).astype(
                np.int32)).to(dev)
            _, _, _, _, avail, n_f = sc.window_front(
                totals, (h1, h2), n, boundary=valid, limit=4 * LIMIT)
            _, _, _, b_avail, units = bc.bucket_front(debt, 0, (h1, h2), n,
                                                      limit=LIMIT)
            batches[B, label] = (h1, (n_f, avail), (units, b_avail))
    out = []
    for design, threads, items, bits, int64 in ADMIT_SWEEP:
        B = threads * items
        for label in ("zipf", "one key", "distinct"):
            h1, *quantities = batches[B, label]
            q, avail = quantities[int64]
            seen = torch.empty_like(q)
            allowed = torch.empty(B, dtype=torch.bool, device=dev)

            def call():
                err = lib.rl_admit_bench(
                    design, threads, items, bits, int64, h1.data_ptr(),
                    q.data_ptr(), avail.data_ptr(), seen.data_ptr(),
                    allowed.data_ptr(), B, ITERS,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"admit_bench: CUDA error {err}")

            call()
            want_allowed, want_seen, _ = admit(h1, q, avail, ITERS)
            torch.cuda.synchronize()
            if not (torch.equal(allowed, want_allowed)
                    and torch.equal(seen, want_seen)):
                raise AssertionError(f"admit_bench design {design} "
                                     f"{threads}x{items} bits {bits} "
                                     f"int64 {int64} on {label} keys "
                                     f"differs from segment.admit")
            row = {"design": design, "threads": threads, "items": items,
                   "bits": bits, "int64": int64, "batch": B, "keys": label,
                   "ms": device_ms(call, torch)}
            out.append(row)
            log(f"admit sweep: design {design} {threads}x{items} bits "
                f"{bits} {'int64' if int64 else 'f32'} B={B} {label}: "
                f"{row['ms'] * 1e3:.2f} us")
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


#: Timed runs of each main path's trace (the first one is also checked
#: and counted).
REPEATS = 5


def check_path(torch, name: str, cfg, batches, keys, advance: float,
               counters, required, state_keys, strict: bool = True) -> dict:
    """One main path on the card against the same trace on the CPU: every
    result field and the final state bit-identical. ``counters`` are the
    kernel modules whose launch counts are set to 0 just before the run
    and read just after it; each kernel named in ``required`` must have
    launched (unless ``strict`` is off and the package counts no such
    kernel: an earlier checkout measured with ``--paths``)."""
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
        if counts.get(k, 0) == 0 and (strict or k in counts):
            raise AssertionError(f"{name}: {k} was not launched on the main "
                                 f"path")
    denied = sum(int((~r.allowed).sum()) for r in got)
    # The same trace again on fresh limiters, for the spread of the rate.
    walls = [wall]
    for _ in range(REPEATS - 1):
        again = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                               device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        drive(again, batches, keys, advance=advance)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        again.close()
    rates = sorted(len(got) / w for w in walls)
    wall = statistics.median(walls)
    out = {"counts": counts, "steps_per_s": statistics.median(rates),
           "steps_per_s_min": rates[0], "steps_per_s_max": rates[-1],
           "steps_per_s_runs": [len(got) / w for w in walls],
           "decisions_per_s": decisions / wall, "wall_s": wall,
           "batches": len(got), "decisions": decisions, "denied": denied,
           "extra": {k: v for k, v in extra.items() if k != "saved_at"}}
    log(f"main path {name}: {len(got)} batches, {decisions} decisions, "
        f"{denied} denied, bit-identical to the CPU run; launches {counts}; "
        f"{out['steps_per_s']:.1f} steps/s median of {REPEATS} runs (min "
        f"{rates[0]:.1f}, max {rates[-1]:.1f}), "
        f"{out['decisions_per_s']:.0f} decisions/s (launch/resolve with 4 "
        f"in flight)")
    return out


def check_main_path(torch, seed: int, steps: int, cu: bool,
                    strict: bool = True) -> dict:
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    batches, keys = _trace(seed, steps)
    out = check_path(torch, f"windowed cu={cu}", config3(cu=cu), batches,
                     keys, 0.1, [sc],
                     ("window_estimate", "admit", "cu_update") if cu
                     else ("window_estimate", "add_back"),
                     ("cur", "slabs", "totals", "slab_period", "last_period"),
                     strict)
    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    out["rollovers"] = int(out["extra"]["host_period"]
                           - int(T0 * 1e6) // sub_us)
    if out["rollovers"] < 3:
        raise AssertionError(f"only {out['rollovers']} rollovers")
    return out


def check_bucket_path(torch, seed: int, cell: str, steps: int,
                      strict: bool = True) -> dict:
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
                     ("bucket_estimate", "admit", "bucket_update"),
                     ("debt", "acc", "rem", "last"), strict)
    if cell == "TB-zipf" and out["denied"] == 0:
        raise AssertionError("TB-zipf denied nothing: retry not exercised")
    return out


#: Substrings of the device kernels behind torch.sort, torch.cumsum and
#: torch.cummax (CUB's radix sort and scan, ATen's scan kernels).
SCAN_OPS = ("sort", "scan", "cummax", "cumsum")


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
    # The plain admission's sort and scans (torch.sort, cumsum, cummax):
    # none should run where every batch fits one admission launch.
    scans = sorted({k[:80] for k in by_name
                    if any(w in k.lower() for w in SCAN_OPS)})
    out = {"batches": n_batches, "device_busy_share": busy / span,
           "device_us_per_batch": busy / n_batches,
           "device_ops_per_batch": len(dev) / n_batches,
           "top_device_us_per_batch": {k[:60]: v / n_batches for k, v in top},
           "sort_or_scan_ops": scans}
    log(f"profile {name}: {n_batches} batches, device busy "
        f"{out['device_busy_share']:.3f} of the span, "
        f"{out['device_us_per_batch']:.1f} us of device work and "
        f"{out['device_ops_per_batch']:.0f} device ops per batch; top: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in
                    out["top_device_us_per_batch"].items())
        + f"; sort or scan ops: {scans or 'none'}")
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


def row_launches(name: str, windowed, bucket) -> int:
    """A kernel row's launches over the main paths' runs: the standalone
    ``add_update`` is the TPU name's count less the fused back's, each
    admission launch counts as ``admit`` in its family's module."""
    if name == "add_update":
        return sum(r["counts"]["add_update"] - r["counts"]["add_back"]
                   for r in windowed)
    if name in ("window_admit", "bucket_admit"):
        runs = windowed if name == "window_admit" else bucket
        return sum(r["counts"]["admit"] for r in runs)
    return sum(r["counts"].get(name, 0) for r in (*windowed, *bucket))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--sweep", action="store_true",
                    help="only build, then sweep the tiled updates' tile, "
                         "cluster and batch sizes (one JSON line)")
    ap.add_argument("--admit-sweep", action="store_true",
                    help="only build, then time the admission routine "
                         "(csrc/admit_bench.cu) over block shapes and sort "
                         "digit widths (one JSON line)")
    ap.add_argument("--paths", action="store_true",
                    help="only build, then drive and profile the main "
                         "paths (phase 3, one JSON line)")
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
    if args.admit_sweep:
        print(json.dumps({"card": card, "admit_sweep": admit_sweep(
            torch, args.seed)}))
        print(card)
        return 0

    rows = {} if args.paths else check_kernels(torch, args.seed)
    if not args.paths:
        rows.update(check_bucket_kernels(torch, args.seed))
        rows.update(check_backs(torch, args.seed))
    strict = not args.paths
    cu = check_main_path(torch, args.seed, args.steps, cu=True,
                         strict=strict)
    vanilla = check_main_path(torch, args.seed + 7, max(32, args.steps // 2),
                              cu=False, strict=strict)
    tb_c2 = check_bucket_path(torch, args.seed + 11, "TB-c2", args.steps,
                              strict)
    tb_zipf = check_bucket_path(torch, args.seed + 13, "TB-zipf",
                                max(32, args.steps // 2), strict)
    for name in rows:
        rows[name]["launches"] = row_launches(name, (cu, vanilla),
                                              (tb_c2, tb_zipf))
    log(f"main paths on {card}: " + "; ".join(
        f"{label} {run['steps_per_s']:.1f} steps/s, "
        f"{run['decisions_per_s']:.0f} decisions/s"
        for label, run in (("windowed CU", cu), ("windowed vanilla", vanilla),
                           ("TB-c2", tb_c2), ("TB-zipf", tb_zipf))))
    batches, keys = _trace(args.seed, 48)
    prof = profile_path(torch, "windowed cu=True", config3(), batches, keys,
                        0.1)
    prof_vanilla = profile_path(torch, "windowed cu=False",
                                config3(cu=False), batches, keys, 0.1)
    prof_tb = profile_path(torch, "TB-zipf", config3("TOKEN_BUCKET"),
                           batches, keys, 0.1)
    paths = {"card": card, "cu": cu, "vanilla": vanilla, "profile": prof,
             "profile_vanilla": prof_vanilla, "TB-c2": tb_c2,
             "TB-zipf": tb_zipf, "profile_TB-zipf": prof_tb}
    if strict:
        # Every batch of these traces fits one admission launch.
        for label, p in (("windowed CU", prof), ("windowed vanilla",
                                                 prof_vanilla),
                         ("TB-zipf", prof_tb)):
            if p["sort_or_scan_ops"]:
                raise AssertionError(f"{label}: the plain admission still "
                                     f"runs: {p['sort_or_scan_ops']}")
    if args.paths:
        print(json.dumps({"main_path": paths}))
        print(card)
        return 0
    check_server(torch, args.seed, config3(), "windowed")
    check_server(torch, args.seed, config2_bucket(), "TB-c2")

    log(json.dumps({"main_path": paths}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
