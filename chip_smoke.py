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
   the same trace; then serve each again with the micro-batcher at its
   defaults (4096 / 200 us / 8 in flight) to a child process: 8
   connections, each pipelining 48 frames (8 in flight), ALLOW_HASHED of
   512 Zipf(1.1) ids with every 8th an ALLOW_BATCH of 64 string keys, a
   RESET halfway, then HEALTH and METRICS. A recording proxy logs each
   window the batcher launches (arrays and ``now``); every frame's answer
   must be bit-identical to a CPU replay of those windows, the final
   state to the replay's, HEALTH must count every decision, METRICS must
   show fewer dispatches than frames, every kernel of the path must have
   launched, and as many admission launches as updates (no composed
   back). The same traffic is then served once more straight over a
   limiter on the system clock, without the proxy, as
   ``python -m ratelimiter_tpu_torch.serving`` serves it. Decisions/s
   through the door, frames a dispatch and p50/p99 frame latency of both
   runs are printed side by side;
5. durable and live-reconfigured serving at config 3's full geometry,
   each part against a CPU limiter of the port driven with the same
   operations (the CPU port is held to the JAX package by the tests):
   live ``update_window`` 60 -> 45 -> 120 s and ``update_limit`` 100 -> 50
   -> 200 on config 3 and the limit 20 -> 10 -> 40 on TB-c2, each with 4
   tickets in flight (every decision, and every slab right after each
   update, bit-equal; the update's lock hold and the migration's device
   time printed); the mass-budget watchdog past config 3's budget of
   2 * 100 * 65536 with requests of n = 100 on fresh ids, 8192 a batch
   (larger n and batches than config 3's traffic, so the run crosses it
   in seconds), under "strict" (the same deny-all batches and overload
   periods as the CPU) and "warn" (one warning per offending
   sub-window); and ``python -m ratelimiter_tpu_torch.serving --device
   cuda --snapshot-dir D`` seeded, driven, killed with SIGKILL, restarted
   and compared with a CPU recovery of a copy of D
   (``check_durable_door``), then stopped with SIGTERM. The launch counts
   of the live and watchdog runs are set to 0 just before each and read
   just after; the recovery seconds, the snapshot's capture lock hold and
   its size are printed;
6. print the kernel table as one JSON line, the card's name and power
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
import logging
import multiprocessing
import queue
import signal
import statistics
import subprocess
import sys
import threading
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


# ---------------------------------------------- phase 4: the door's batcher

#: The door run: connections, frames per connection, raw ids per
#: ALLOW_HASHED frame, string keys per ALLOW_BATCH frame (every
#: DOOR_STRING_EVERY-th frame of a connection), frames each connection
#: keeps in flight.
DOOR_CONNS, DOOR_FRAMES, DOOR_IDS, DOOR_KEYS = 8, 48, 512, 64
DOOR_STRING_EVERY, DOOR_DEPTH = 8, 8


class RecordingLimiter:
    """A thin proxy over the served limiter: before each launch or reset
    it sets the limiter's ManualClock to the wall clock's progress since
    ``t0``, passes that ``now`` explicitly, and logs the call's arrays and
    ``now`` in the order the calls reach the limiter (the order of the
    state updates on the card: every thread enqueues on the default
    stream, under this proxy's lock). It also sums the launches' wall
    time and the launching thread's CPU time."""

    def __init__(self, inner, t0: float):
        self.inner = inner
        self.config = inner.config
        self.clock = inner.clock
        self.pipelined = inner.pipelined
        self.log: list = []
        self.launch_wall_s = self.launch_cpu_s = 0.0
        self._t0 = t0
        self._start = time.perf_counter()
        self._lock = threading.Lock()

    def _now(self) -> float:
        now = self._t0 + (time.perf_counter() - self._start)
        self.clock.set(now)
        return now

    def _timed(self, launch, *args, **kw):
        t, cpu = time.perf_counter(), time.thread_time()
        ticket = launch(*args, **kw)
        self.launch_wall_s += time.perf_counter() - t
        self.launch_cpu_s += time.thread_time() - cpu
        return ticket

    def launch_ids(self, ids, ns=None, *, wire: bool = False):
        with self._lock:
            now = self._now()
            ticket = self._timed(self.inner.launch_ids, ids, ns, now=now,
                                 wire=wire)
            self.log.append(("ids", np.array(ids), np.array(ns), now))
        return ticket

    def launch_batch(self, keys, ns=None):
        with self._lock:
            now = self._now()
            ticket = self._timed(self.inner.launch_batch, keys, ns, now=now)
            self.log.append(("keys", list(keys), list(ns), now))
        return ticket

    def reset(self, key: str) -> None:
        with self._lock:
            now = self._now()
            self.inner.reset(key)
            self.log.append(("reset", key, None, now))

    def resolve(self, ticket):
        return self.inner.resolve(ticket)

    def allow_ids(self, ids, ns=None):
        """Marks the raw-id lane (the batcher looks for it)."""
        return self.resolve(self.launch_ids(ids, ns))


def door_keys(rng, space: str, n: int) -> list:
    if space == "c2":
        return [f"u:{int(i)}" for i in rng.integers(0, C2_KEYS, size=n)]
    return [f"user:{int(k)}" for k in zipf_ids(rng, n)]


async def _door_conn(port: int, c: int, frames: int, n_ids: int,
                     n_keys: int, depth: int, space: str, seed: int):
    """One client connection: ``frames`` decision frames sent pipelined
    (at most ``depth`` unanswered), replies read as they come, by request
    id. Connection 0 also sends a RESET halfway."""
    from ratelimiter_tpu_torch.serving import protocol as p

    rng = np.random.default_rng(seed * 1000 + c)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    window = asyncio.Semaphore(depth)
    sent: dict = {}
    out = {"hashed": [], "strings": [], "latency": [], "inversions": 0,
           "errors": []}
    n_replies = frames + (1 if c == 0 else 0)

    async def read_replies():
        last = -1
        for _ in range(n_replies):
            length, type_, rid = p.parse_header(await reader.readexactly(13))
            body = await reader.readexactly(length - 9)
            t = time.perf_counter()
            kind, payload, t0 = sent.pop(rid)
            window.release()
            # Request ids rise in send order: a smaller one than seen
            # before is a reply overtaken by a later frame's.
            out["inversions"] += rid < last
            last = max(last, rid)
            if type_ == p.T_ERROR:
                out["errors"].append(p.parse_error(body))
                continue
            if kind == "reset":
                continue
            out["latency"].append(t - t0)
            if kind == "hashed":
                res = p.parse_result_hashed(body)
                out["hashed"].append((payload, np.array(res.allowed),
                                      np.array(res.remaining),
                                      np.array(res.retry_after),
                                      np.array(res.reset_at), res.fail_open))
            else:
                out["strings"].append((payload, [
                    (r.allowed, r.remaining, r.retry_after, r.reset_at,
                     r.fail_open) for r in p.parse_result_batch(body)]))

    reading = asyncio.ensure_future(read_replies())
    rid = 0
    for i in range(frames):
        await window.acquire()
        rid += 1
        if i % DOOR_STRING_EVERY == DOOR_STRING_EVERY - 1:
            keys = door_keys(rng, space, n_keys)
            sent[rid] = ("strings", keys, time.perf_counter())
            writer.write(p.encode_allow_batch(rid, keys, [1] * n_keys))
        else:
            ids = zipf_ids(rng, n_ids)
            sent[rid] = ("hashed", ids, time.perf_counter())
            writer.write(p.encode_allow_hashed(rid, ids))
        if c == 0 and i == frames // 2:
            await window.acquire()
            rid += 1
            sent[rid] = ("reset", None, time.perf_counter())
            writer.write(p.encode_reset(rid, door_keys(rng, space, 1)[0]))
        await writer.drain()
    await reading
    writer.close()
    await writer.wait_closed()
    return out


async def _door_clients(port: int, conns: int, frames: int, n_ids: int,
                        n_keys: int, depth: int, space: str, seed: int):
    from ratelimiter_tpu_torch.serving import protocol as p

    t, cpu = time.perf_counter(), time.process_time()
    outs = await asyncio.gather(*(
        _door_conn(port, c, frames, n_ids, n_keys, depth, space, seed)
        for c in range(conns)))
    wall, cpu = time.perf_counter() - t, time.process_time() - cpu
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(p.encode_simple(p.T_HEALTH, 1)
                 + p.encode_simple(p.T_METRICS, 2))
    replies = {}
    for _ in range(2):
        length, type_, rid = p.parse_header(await reader.readexactly(13))
        replies[rid] = (type_, await reader.readexactly(length - 9))
    writer.close()
    await writer.wait_closed()
    if replies[1][0] != p.T_HEALTH_R or replies[2][0] != p.T_METRICS_R:
        raise AssertionError(f"control frames answered {replies}")
    return {"conns": outs, "wall_s": wall, "client_cpu_s": cpu,
            "health": p.parse_health(replies[1][1]),
            "metrics": p.parse_metrics(replies[2][1])}


def door_client(port: int, conns: int, frames: int, n_ids: int,
                n_keys: int, depth: int, space: str, seed: int,
                out) -> None:
    """The door's client, run in a child process: ``conns`` connections
    pipelining ALLOW_HASHED and ALLOW_BATCH frames, then HEALTH and
    METRICS on one more; puts everything it read on ``out``."""
    out.put(asyncio.run(_door_clients(port, conns, frames, n_ids, n_keys,
                                      depth, space, seed)))


def _collect(proc, q, timeout: float):
    """The child's result (read before it is joined)."""
    deadline = time.time() + timeout
    while True:
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            if not proc.is_alive():
                raise AssertionError(f"door client exited with "
                                     f"{proc.exitcode} before its result")
            if time.time() > deadline:
                raise AssertionError("door client timed out")


def replay_windows(cfg, log: list):
    """Every recorded window (and reset) again, in order, on a CPU limiter
    of the port at the recorded ``now``s; returns the results (None for a
    reset) and the limiter."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    cpu = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                         device="cpu")
    outs = []
    for kind, a, ns, now in log:
        cpu.clock.set(now)
        if kind == "ids":
            outs.append(cpu.resolve(cpu.launch_ids(a, ns, now=now,
                                                   wire=True)))
        elif kind == "keys":
            outs.append(cpu.resolve(cpu.launch_batch(a, ns, now=now)))
        else:
            cpu.reset(a)
            outs.append(None)
    return outs, cpu


def _hold_door_frames(name: str, log, replayed, conns, n_ids: int,
                      n_keys: int) -> None:
    """Each frame's answer against its rows of the replayed window. A
    hashed window is its frames' ids in arrival order (whole frames:
    ``n_ids`` <= 2*max_batch), found by their bytes; the string windows
    together are the string frames' keys in arrival order (the fill may
    cut a frame between two windows)."""
    hashed: dict = {}
    strings: dict = {}
    for out in conns:
        for row in out["hashed"]:
            hashed.setdefault(row[0].tobytes(), []).append(row)
        for keys, rows in out["strings"]:
            strings.setdefault(tuple(keys), []).append(rows)
    n_hashed = sum(map(len, hashed.values()))
    n_strings = sum(map(len, strings.values()))
    fields = ("allowed", "remaining", "retry_after", "reset_at")
    key_stream, str_rows = [], []
    for (kind, a, _, _), res in zip(log, replayed):
        if kind == "keys":
            key_stream += a
            str_rows += [(bool(res.allowed[i]), int(res.remaining[i]),
                          float(res.retry_after[i]), float(res.reset_at[i]),
                          res.fail_open) for i in range(len(a))]
        if kind != "ids":
            continue
        if len(a) % n_ids:
            raise AssertionError(f"{name}: a hashed window of {len(a)} rows "
                                 f"is not whole frames")
        for off in range(0, len(a), n_ids):
            got = hashed.get(a[off:off + n_ids].tobytes())
            if not got:
                raise AssertionError(f"{name}: window rows {off}+ match no "
                                     f"frame")
            row = got.pop()
            want = res.rows(off, n_ids)
            for f, x in zip(fields, row[1:5]):
                y = getattr(want, f)
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"{name}: a frame's {f} differs "
                                         f"from the CPU replay")
            if row[5] != want.fail_open:
                raise AssertionError(f"{name}: fail_open differs")
    for off in range(0, len(key_stream), n_keys):
        got = strings.get(tuple(key_stream[off:off + n_keys]))
        if not got:
            raise AssertionError(f"{name}: string rows {off}+ match no frame")
        if got.pop() != str_rows[off:off + n_keys]:
            raise AssertionError(f"{name}: a string frame differs from the "
                                 f"CPU replay")
    left = sum(map(len, hashed.values())) + sum(map(len, strings.values()))
    if left or not n_hashed or not n_strings:
        raise AssertionError(f"{name}: {left} of {n_hashed} hashed and "
                             f"{n_strings} string frames were in no window")


def metric_value(text: str, sample: str) -> float:
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{sample} not in the METRICS text")


def serve_door(limiter, *, seed: int, space: str, conns: int, frames: int,
               n_ids: int, n_keys: int, depth: int, counters=(),
               server_kw=None) -> dict:
    """The port's server over ``limiter`` with the micro-batcher at its
    defaults (``server_kw`` overrides them), driven by ``door_client`` in
    a child process; the launch counts of ``counters`` are set to 0 once
    the server listens. Returns what the client read, plus the server's
    CPU seconds."""
    from ratelimiter_tpu_torch.observability.metrics import Registry
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()

    async def main():
        srv = RateLimitServer(limiter, "127.0.0.1", 0, registry=Registry(),
                              **(server_kw or {}))
        await srv.start()
        for mod in counters:
            mod.reset_launch_counts()
        proc = ctx.Process(target=door_client, args=(
            srv.port, conns, frames, n_ids, n_keys, depth, space, seed, q))
        proc.start()
        cpu = time.process_time()
        try:
            got = await asyncio.get_running_loop().run_in_executor(
                None, _collect, proc, q, 600.0)
            got["server_cpu_s"] = time.process_time() - cpu
            return got
        finally:
            await srv.shutdown()
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()

    return asyncio.run(main())


def _door_readings(name: str, got: dict) -> dict:
    """Frames, decisions, dispatches and latency of one door run; fails on
    an error reply, a HEALTH count that misses decisions, or no
    coalescing."""
    errors = [e for out in got["conns"] for e in out["errors"]]
    if errors:
        raise AssertionError(f"{name}: error replies {errors[:3]}")
    n_frames = sum(len(o["hashed"]) + len(o["strings"])
                   for o in got["conns"])
    decisions = sum(len(r[0]) for o in got["conns"] for r in o["hashed"]) \
        + sum(len(r[0]) for o in got["conns"] for r in o["strings"])
    dispatches = metric_value(got["metrics"],
                              "rate_limiter_server_batch_size_count")
    if got["health"][2] != decisions:
        raise AssertionError(f"{name}: HEALTH counts {got['health'][2]} "
                             f"decisions, not {decisions}")
    if not dispatches < n_frames:
        raise AssertionError(f"{name}: {dispatches:g} dispatches for "
                             f"{n_frames} frames")
    lat = np.array([t for o in got["conns"] for t in o["latency"]])
    return {"frames": n_frames, "decisions": decisions,
            "dispatches": int(dispatches),
            "frames_per_dispatch": n_frames / dispatches,
            "decisions_per_s": decisions / got["wall_s"],
            "wall_s": got["wall_s"],
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def time_door(cfg, label: str, *, seed: int = 0, space: str = "zipf",
              conns: int = DOOR_CONNS, frames: int = DOOR_FRAMES,
              n_ids: int = DOOR_IDS, n_keys: int = DOOR_KEYS,
              depth: int = DOOR_DEPTH) -> dict:
    """The door as ``python -m ratelimiter_tpu_torch.serving`` runs it: the
    server straight over a limiter on the card and the system clock, no
    recording proxy, driven by the same client as ``check_door``. Only
    timed; ``check_door`` holds the answers."""
    from ratelimiter_tpu_torch import create_limiter

    served = create_limiter(cfg, backend="sketch", device="cuda")
    try:
        got = serve_door(served, seed=seed, space=space, conns=conns,
                         frames=frames, n_ids=n_ids, n_keys=n_keys,
                         depth=depth)
    finally:
        served.close()
    out = _door_readings(f"door[{label}, unproxied]", got)
    log(f"door[{label}] unproxied on cuda: {out['frames']} frames in "
        f"{out['dispatches']} dispatches ({out['frames_per_dispatch']:.2f} "
        f"frames a dispatch); {out['decisions_per_s']:.0f} decisions/s, "
        f"frame latency p50 {out['p50_ms']:.2f} ms p99 "
        f"{out['p99_ms']:.2f} ms over {out['wall_s']:.3f} s")
    return out


def check_door(torch, cfg, label: str, *, device: str = "cuda",
               seed: int = 0, space: str = "zipf", conns: int = DOOR_CONNS,
               frames: int = DOOR_FRAMES, n_ids: int = DOOR_IDS,
               n_keys: int = DOOR_KEYS, depth: int = DOOR_DEPTH,
               counters=(), required=(), same=None, server_kw=None) -> dict:
    """The port's server over ``cfg`` (``serve_door``) through a
    ``RecordingLimiter``. Every frame's answer must be bit-identical to a
    CPU replay of the windows the batcher launched, the final state to
    the replay's, HEALTH must count every decision, METRICS must show
    fewer dispatches than frames (one for each window launched), and each
    kernel in ``required`` must have launched; ``same`` names two counts
    that must be equal (an admission launch for every update: no composed
    back). Returns the door's readings, which include the proxy's own
    cost (a lock, a copy of each window's arrays, a clock set and two
    timer reads per launch); ``time_door`` times the door without it."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    served = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                            device=device)
    rec = RecordingLimiter(served, T0)
    got = serve_door(rec, seed=seed, space=space, conns=conns,
                     frames=frames, n_ids=n_ids, n_keys=n_keys, depth=depth,
                     counters=counters, server_kw=server_kw)
    if device == "cuda":
        torch.cuda.synchronize()
    counts = {}
    for mod in counters:
        counts.update(mod.launch_counts())
    _, served_arrays, _ = served.capture_state()
    served.close()
    name = f"door[{label}]"
    out = _door_readings(name, got)
    replayed, cpu = replay_windows(cfg, rec.log)
    _hold_door_frames(name, rec.log, replayed, got["conns"], n_ids, n_keys)
    _, cpu_arrays, _ = cpu.capture_state()
    cpu.close()
    for k, v in cpu_arrays.items():
        if not np.array_equal(served_arrays[k], v):
            raise AssertionError(f"{name}: final state {k} differs from the "
                                 f"CPU replay")
    windows = sum(kind != "reset" for kind, *_ in rec.log)
    if out["dispatches"] != windows:
        raise AssertionError(f"{name}: {out['dispatches']} dispatches for "
                             f"{windows} windows launched")
    for k in required:
        if counts.get(k, 0) == 0:
            raise AssertionError(f"{name}: {k} was not launched")
    if same is not None and counts[same[0]] != counts[same[1]]:
        raise AssertionError(f"{name}: {counts[same[0]]} {same[0]} "
                             f"launches for {counts[same[1]]} {same[1]}: "
                             f"the composed back ran")

    def mean_ms(family: str) -> float:
        return 1e3 * (metric_value(got["metrics"], family + "_sum")
                      / metric_value(got["metrics"], family + "_count"))

    out.update({
        "counts": counts,
        "inversions": sum(o["inversions"] for o in got["conns"]),
        "resets": sum(kind == "reset" for kind, *_ in rec.log),
        "launch_ms_mean": mean_ms("rate_limiter_pipeline_launch_seconds"),
        "resolve_ms_mean": mean_ms("rate_limiter_pipeline_resolve_seconds"),
        "dispatch_ms_mean": mean_ms("rate_limiter_server_dispatch_seconds"),
        "limiter_launch_ms_mean": 1e3 * rec.launch_wall_s / windows,
        "limiter_launch_cpu_ms_mean": 1e3 * rec.launch_cpu_s / windows,
        "server_cpu_s": got["server_cpu_s"],
        "client_cpu_s": got["client_cpu_s"]})
    log(f"{name} on {device}: {conns} connections, {out['frames']} frames "
        f"({out['decisions']} decisions) in {out['dispatches']} dispatches "
        f"({out['frames_per_dispatch']:.2f} frames a dispatch), every frame "
        f"bit-identical to a CPU replay of the windows; "
        f"{out['decisions_per_s']:.0f} decisions/s, frame latency p50 "
        f"{out['p50_ms']:.2f} ms p99 {out['p99_ms']:.2f} ms, "
        f"{out['inversions']} replies out of order; per window launch "
        f"{out['launch_ms_mean']:.3f} ms (the limiter's "
        f"{out['limiter_launch_ms_mean']:.3f} ms, of which the launching "
        f"thread's CPU {out['limiter_launch_cpu_ms_mean']:.3f} ms), resolve "
        f"{out['resolve_ms_mean']:.3f} ms, dispatch (launch to answer) "
        f"{out['dispatch_ms_mean']:.3f} ms; CPU seconds over the "
        f"{out['wall_s']:.3f} s run: server {out['server_cpu_s']:.3f}, "
        f"client {out['client_cpu_s']:.3f}; launches {counts}")
    return out


# ------------------------- phase 5: live reconfiguration and durable serving


class TimedLock:
    """A limiter's lock that records how long each acquisition held it
    (``with`` only, as the limiters take it)."""

    def __init__(self, lock):
        self._lock = lock
        self.holds: list = []

    def __enter__(self):
        self._lock.acquire()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.holds.append(time.perf_counter() - self._t)
        self._lock.release()


def _same_results(name: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: result count differs")
    for i, (a, b) in enumerate(zip(got, want)):
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{name} batch {i}: {f} differs from "
                                     f"the CPU run")
        if a.limit != b.limit:
            raise AssertionError(f"{name} batch {i}: limit differs")


def _same_state(name: str, gpu, cpu, keys) -> None:
    _, ga, ge = gpu.capture_state()
    _, ca, ce = cpu.capture_state()
    for k in keys + ("policy_keys", "policy_limits", "policy_scales"):
        if ga[k].dtype != ca[k].dtype or not np.array_equal(ga[k], ca[k]):
            raise AssertionError(f"{name}: state {k} differs from the CPU "
                                 f"run")
    if ge.get("host_period") != ce.get("host_period"):
        raise AssertionError(f"{name}: host_period differs")


WINDOW_STATE = ("cur", "slabs", "totals", "slab_period", "last_period")
BUCKET_STATE = ("debt", "acc", "rem", "last")


def live_drive(lim, batches, keys, plan: dict, *, advance: float,
               on_update=None, inflight: int = 4):
    """``drive`` with live updates: at each step in ``plan`` (step ->
    (method, argument)) the update runs with ``inflight`` tickets
    outstanding, then ``on_update(lim, step)``. Every 8th step also sends
    ``keys`` (one overridden); the step after the first update resets the
    overridden key. Returns the results in launch order."""
    pending, out = [], []
    lim.set_override("tenant:whale", 40)
    first = min(plan)
    for step, batch in enumerate(batches):
        if step in plan:
            if len(pending) != inflight:
                raise AssertionError("update without tickets in flight")
            name, arg = plan[step]
            getattr(lim, name)(arg)
            if on_update is not None:
                on_update(lim, step)
        if step == first + 1:
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


#: Config 3's live updates: window 60 -> 45 s (0.75 s sub-windows, which
#: do not line up with the old 1 s ones) -> 120 s, limit 100 -> 50 -> 200.
LIVE_PLAN = {8: ("update_window", 45.0), 16: ("update_limit", 50),
             24: ("update_window", 120.0), 32: ("update_limit", 200)}
#: TB-c2's: the limit lowered (the debt clamps), then raised.
LIVE_PLAN_TB = {8: ("update_limit", 10), 16: ("update_limit", 40)}


def check_live(torch, cfg, name: str, batches, keys, plan: dict,
               advance: float, state_keys) -> dict:
    """One live-update run on the card against the same run on the CPU:
    every decision (those of tickets launched before an update included)
    and, right after each update, every state slab bit-equal. Returns
    each update's lock hold on the card, in ms (the longest acquisition
    the update made, through a TimedLock)."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    cpu = create_limiter(cfg, clock=ManualClock(T0), device="cpu")
    states = {}
    want = live_drive(cpu, batches, keys, plan, advance=advance,
                      on_update=lambda lim, step: states.__setitem__(
                          step, lim.capture_state()))

    def hold_state(lim, step):
        # The capture waits for the stream: the state after the update.
        _, ga, ge = lim.capture_state()
        _, ca, ce = states[step]
        for k in state_keys + ("policy_keys", "policy_limits"):
            if ga[k].dtype != ca[k].dtype or not np.array_equal(ga[k], ca[k]):
                raise AssertionError(f"{name}: state {k} after "
                                     f"{plan[step]} differs from the CPU run")
        if ge.get("host_period") != ce.get("host_period"):
            raise AssertionError(f"{name}: host_period after {plan[step]} "
                                 f"differs")

    gpu = create_limiter(cfg, clock=ManualClock(T0), device="cuda")
    timed = TimedLock(gpu._lock)
    gpu._lock = timed
    holds: dict = {}

    def timed_update(method):
        def run(arg):
            before = len(timed.holds)
            method(arg)
            holds.setdefault(f"{method.__name__}({arg:g})", 1e3 * max(
                timed.holds[before:]))
        return run

    for m in ("update_window", "update_limit"):
        setattr(gpu, m, timed_update(getattr(gpu, m)))
    got = live_drive(gpu, batches, keys, plan, advance=advance,
                     on_update=hold_state)
    _same_results(name, got, want)
    _same_state(name, gpu, cpu, state_keys)
    gpu.close()
    cpu.close()
    return holds


def migration_ms(torch) -> dict:
    """Device time of the ring migration alone at config 3's geometry, on
    a ring filled with Zipf traffic: 60 -> 45 s and 45 -> 120 s."""
    import dataclasses

    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk

    lim = create_limiter(config3(), clock=ManualClock(T0), device="cuda")
    batches, _ = _trace(5, 40)
    for ids in batches:
        lim.allow_ids(ids)
        lim.clock.advance(0.25)
    now_us = int(lim.clock.now() * 1e6)
    c60 = config3()
    c45 = dataclasses.replace(c60, window=45.0)
    c120 = dataclasses.replace(c60, window=120.0)
    state = dict(lim._state)
    out = {}
    for label, a, b in (("60->45", c60, c45), ("45->120", c45, c120)):
        migrate = sk.build_migrate(a, b)
        src = state
        if label == "45->120":
            src = sk.build_migrate(c60, c45)(state, now_us)
        out[label] = device_ms(lambda: migrate(src, now_us), torch, reps=5)
    lim.close()
    return out


def check_live_updates(torch, seed: int) -> dict:
    """Phase 5.1: live update_window/update_limit on config 3 and
    update_limit on TB-c2, with 4 tickets in flight, against the CPU."""
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    batches, keys = _trace(seed + 23, 40)
    tb_batches, tb_keys = _trace_c2(seed + 29, 24)
    torch.cuda.synchronize()
    for mod in (sc, bc):
        mod.reset_launch_counts()
    holds = check_live(torch, config3(), "live config 3", batches, keys,
                       LIVE_PLAN, 0.1, WINDOW_STATE)
    holds_tb = check_live(torch, config2_bucket(), "live TB-c2", tb_batches,
                          tb_keys, LIVE_PLAN_TB, C2_ADVANCE, BUCKET_STATE)
    torch.cuda.synchronize()
    counts = {"windowed": sc.launch_counts(), "bucket": bc.launch_counts()}
    for k in ("window_estimate", "admit", "cu_update", "add_update"):
        if counts["windowed"][k] == 0:
            raise AssertionError(f"live config 3: {k} was not launched")
    for k in ("bucket_estimate", "admit", "bucket_update"):
        if counts["bucket"][k] == 0:
            raise AssertionError(f"live TB-c2: {k} was not launched")
    mig = migration_ms(torch)
    out = {"lock_hold_ms": holds, "lock_hold_ms_TB-c2": holds_tb,
           "migration_device_ms": mig,
           "windowed": {"counts": counts["windowed"]},
           "bucket": {"counts": counts["bucket"]}}
    log(f"live updates on {card_line()}: config 3 window 60->45->120 s, "
        f"limit 100->50->200, "
        f"TB-c2 limit 20->10->40, each with 4 tickets in flight: every "
        f"decision and every slab after each update bit-equal to the CPU "
        f"run; lock held {holds} ms (TB-c2 {holds_tb}); the migration "
        f"alone {mig} device ms (config 3's 63 MB ring)")
    return out


#: The watchdog run: requests of n = the limit on fresh Zipf-free ids,
#: 8192 a batch (the one-launch admission capacity), 4 in flight: CU
#: admits each fresh key whose cells are not yet all occupied, so the
#: admitted in-window mass passes 2 * 100 * 65536 within ~25 batches.
WATCH_BATCH, WATCH_STEPS = 8192, 32


def _watch_drive(lim, logs):
    pending, out = [], []
    n = np.full(WATCH_BATCH, lim.config.limit, dtype=np.int64)
    for step in range(WATCH_STEPS):
        ids = np.arange(step * WATCH_BATCH, (step + 1) * WATCH_BATCH,
                        dtype=np.uint64) * np.uint64(2654435761)
        pending.append(lim.launch_ids(ids, n))
        while len(pending) > 4:
            out.append(lim.resolve(pending.pop(0)))
        # A tight step while the ring fills, then across sub-windows.
        lim.clock.advance(0.02 if step < 24 else 0.3)
    while pending:
        out.append(lim.resolve(pending.pop(0)))
    return out, {"overload_periods": lim.overload_periods,
                 "mass": lim.in_window_admitted_mass(),
                 "budget": lim.mass_budget, "warnings": list(logs)}


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records: list = []

    def emit(self, record):
        self.records.append(record.getMessage())


def check_watchdog(torch) -> dict:
    """Phase 5.2: config 3 past its mass budget under "strict" (deny-all
    batches) and "warn" (one warning per offending sub-window), on the
    card against the CPU."""
    import dataclasses

    from ratelimiter_tpu_torch import ManualClock, create_limiter

    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    logger = logging.getLogger("ratelimiter_tpu_torch")
    out = {}
    torch.cuda.synchronize()
    sc.reset_launch_counts()
    for policy in ("strict", "warn"):
        base = config3()
        cfg = dataclasses.replace(base, sketch=dataclasses.replace(
            base.sketch, overload_policy=policy))
        runs = []
        for device in ("cuda", "cpu"):
            handler = _Warnings()
            logger.addHandler(handler)
            try:
                lim = create_limiter(cfg, clock=ManualClock(T0),
                                     device=device)
                runs.append(_watch_drive(lim, handler.records))
                lim.close()
            finally:
                logger.removeHandler(handler)
        (got, g), (want, c) = runs
        _same_results(f"watchdog {policy}", got, want)
        if g != c:
            raise AssertionError(f"watchdog {policy}: ledger {g} differs "
                                 f"from the CPU run's {c}")
        denied_all = [i for i, r in enumerate(got) if not r.allowed.any()]
        if policy == "strict" and not (denied_all and g["overload_periods"]):
            raise AssertionError(f"strict watchdog denied no whole batch: {g}")
        if policy == "warn" and (g["mass"] <= g["budget"]
                                 or g["overload_periods"] < 2):
            raise AssertionError(f"warn watchdog: the run did not cross the "
                                 f"budget in two sub-windows: {g}")
        if policy == "warn" and (denied_all or len(g["warnings"])
                                 != g["overload_periods"]):
            raise AssertionError(f"warn watchdog: {len(denied_all)} deny-all "
                                 f"batches, {len(g['warnings'])} warnings for "
                                 f"{g['overload_periods']} periods")
        out[policy] = {"deny_all_batches": denied_all,
                       "overload_periods": g["overload_periods"],
                       "admitted_mass": g["mass"], "budget": g["budget"],
                       "warnings": len(g["warnings"])}
    torch.cuda.synchronize()
    out["counts"] = sc.launch_counts()
    for k in ("window_estimate", "admit", "cu_update"):
        if out["counts"][k] == 0:
            raise AssertionError(f"watchdog: {k} was not launched")
    log(f"watchdog on {card_line()}, config 3 (d=4, w=65536, budget "
        f"{out['strict']['budget']}; {WATCH_STEPS} batches of "
        f"{WATCH_BATCH} fresh ids at n=100, +0.02 s then +0.3 s a batch, 4 "
        f"in flight): strict denied whole batches "
        f"{out['strict']['deny_all_batches']} over "
        f"{out['strict']['overload_periods']} periods; warn warned "
        f"{out['warn']['warnings']} times for "
        f"{out['warn']['overload_periods']} periods at mass "
        f"{out['warn']['admitted_mass']}; both bit-equal to the CPU run")
    return out


# -- 5.3: crash and recovery through the door ----------------------------

class ServerProcess:
    """``python -m ratelimiter_tpu_torch.serving`` as a child process; its
    output is read by a thread, its port taken from the ``serving`` line
    and the recovery from the ``recovered`` line."""

    def __init__(self, args: list, timeout: float = 300.0):
        import os

        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
             "--port", "0", *args], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: "queue.Queue" = queue.Queue()
        self.output: list = []
        threading.Thread(target=self._read, daemon=True).start()
        self.recovered = None
        deadline = time.time() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                self.kill()
                raise AssertionError("server did not start: "
                                     + "".join(self.output[-20:]))
            if line is None:
                raise AssertionError("server exited: "
                                     + "".join(self.output[-20:]))
            if line.startswith("recovered:"):
                self.recovered = line.strip()
            if line.startswith("serving"):
                self.port = int(line.split(" on ")[1].split()[0]
                                .rsplit(":", 1)[1])
                return

    def _read(self):
        for line in self.proc.stdout:
            self.output.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def recovery_s(self) -> float:
        return float(self.recovered.rsplit(" in ", 1)[1].split()[0])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)

    def terminate(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=120)


class DoorClient:
    """A blocking client: one frame out, its reply back."""

    def __init__(self, port: int):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.rid = 0

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise AssertionError("server closed the connection")
            buf += chunk
        return buf

    def call(self, encode, *args):
        from ratelimiter_tpu_torch.serving import protocol as p

        self.rid += 1
        self.sock.sendall(encode(self.rid, *args))
        length, type_, rid = p.parse_header(self._read(13))
        body = self._read(length - 9)
        if rid != self.rid:
            raise AssertionError(f"reply to {rid}, expected {self.rid}")
        if type_ == p.T_ERROR:
            raise AssertionError(f"server error {p.parse_error(body)}")
        return type_, body

    def close(self):
        self.sock.close()


def _door_frames(rng, n_ids: int, frames: int):
    """ALLOW_HASHED frames of Zipf ids with every third an ALLOW_BATCH of
    string keys around the overridden and reset ones."""
    out = []
    for i in range(frames):
        if i % 3 == 2:
            keys = ([f"user:{int(k)}" for k in zipf_ids(rng, 56)]
                    + ["vip", "vip2", "seeded", "k:reset", "k:reset2"] * 2)
            out.append(("keys", keys[:64]))
        else:
            out.append(("ids", zipf_ids(rng, n_ids)))
    return out


def _send(client, frame):
    from ratelimiter_tpu_torch.serving import protocol as p

    kind, payload = frame
    t0 = time.time()
    if kind == "ids":
        type_, body = client.call(p.encode_allow_hashed, payload)
        res = p.parse_result_hashed(body)
        out = (res.allowed, res.remaining, res.retry_after, res.reset_at)
    else:
        type_, body = client.call(p.encode_allow_batch, payload,
                                  [1] * len(payload))
        rs = p.parse_result_batch(body)
        out = tuple(np.array([getattr(r, f) for r in rs]) for f in
                    ("allowed", "remaining", "retry_after", "reset_at"))
    return out, (t0, time.time())


def _hold_against_twin(name, got, bracket, want, window_s: float) -> None:
    """allowed and remaining bit-equal to the twin; retry_after and
    reset_at follow the server's clock, which the twin does not share, so
    they are held to the frame's send/receive bracket instead."""
    allowed, remaining, retry, reset_at = got
    if not (np.array_equal(allowed, want.allowed)
            and np.array_equal(remaining, want.remaining)):
        raise AssertionError(f"{name}: decisions differ from the CPU twin")
    lo, hi = bracket[0] - 1e-3, bracket[1] + 1e-3
    now = reset_at - retry
    if not (((now >= lo) & (now <= hi)) | allowed).all() or (
            retry[allowed] != 0).any():
        raise AssertionError(f"{name}: retry_after outside the frame's time")
    if not ((reset_at - window_s <= hi) & (reset_at >= lo)).all():
        raise AssertionError(f"{name}: reset_at outside the frame's window")


def _snapshot_file(client, d: str):
    """T_SNAPSHOT, then the snapshot's file: (id, arrays, meta, MB)."""
    import os

    from ratelimiter_tpu_torch.serving import protocol as p

    type_, body = client.call(lambda rid: p.encode_simple(p.T_SNAPSHOT, rid))
    if type_ != p.T_SNAPSHOT_R:
        raise AssertionError(f"SNAPSHOT answered type {type_}")
    snap_id, wal_seq, _ = p.parse_snapshot_r(body)
    path = os.path.join(d, f"snap-{snap_id:08d}-000.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__ratelimiter_tpu_meta__")).decode())
    return snap_id, wal_seq, arrays, meta, os.path.getsize(path) / 2**20


def _policy(client, type_, key):
    from ratelimiter_tpu_torch.serving import protocol as p

    t, body = client.call(lambda rid: p.encode_policy_key(type_, rid, key))
    return p.parse_policy_r(body)


def check_durable_door(cfg, *, device: str = "cuda", seed: int = 0,
                       n_ids: int = BATCH, limit1: int = 80,
                       window1: float = 45.0) -> dict:
    """Phase 5.3: the durable server binary (``--snapshot-dir``) killed
    and recovered, against a CPU twin's recovery of the same directory.

    1. The directory is seeded with a WAL of ``update_limit(limit1)``,
       ``update_window(window1)`` and an override, written in-process (no
       snapshot), as a live update would leave it.
    2. The server starts on it with ``cfg``'s limit and window and must
       recover to ``limit1``/``window1`` (a migration on its device).
    3. Hashed and string frames, POLICY_SET, RESET and SNAPSHOT; then
       POLICY_SET, POLICY_DEL, one RESET and frames the crash loses;
       SIGKILL; the directory is copied.
    4. The server restarts with ``limit1``/``window1`` (a snapshot restores
       only under its own config) and takes a SNAPSHOT: its file must be
       bit-equal to a CPU port limiter's recovery of the copy, run in the
       sub-window the server replayed the RESET in (the file's
       ``host_period``). The RESET's result depends on that period alone
       while the ring's boundary slab is empty, i.e. within ``window1`` of
       the first frame, which the check asserts.
    5. Frames one at a time (one per window, so the CPU twin sees the same
       batches): decisions bit-equal to the twin's; a SNAPSHOT's
       ``totals`` (invariant under rollovers within the window) equal to
       the twin's; more frames, SIGTERM, and the final snapshot's
       ``totals`` equal to the twin's: a graceful stop loses nothing.
    """
    import dataclasses
    import os
    import shutil
    import tempfile

    from ratelimiter_tpu_torch import (
        ManualClock,
        PersistenceSpec,
        create_limiter,
    )
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk
    from ratelimiter_tpu_torch.persistence import PersistenceManager
    from ratelimiter_tpu_torch.observability.metrics import Registry
    from ratelimiter_tpu_torch.serving import protocol as p

    rng = np.random.default_rng(seed + 31)
    root = tempfile.mkdtemp(prefix="durable-door-")
    d, copy = os.path.join(root, "live"), os.path.join(root, "copy")
    cfg1 = dataclasses.replace(cfg, limit=limit1, window=window1)

    def boot(directory, config, clock):
        spec = PersistenceSpec(dir=directory, snapshot_interval=3600.0)
        mgr = PersistenceManager(spec, registry=Registry())
        lim = mgr.wrap(create_limiter(config, clock=clock, device="cpu"))
        mgr.attach([lim])
        return mgr, lim

    mgr, lim = boot(d, cfg, ManualClock(T0))
    mgr.recover()
    lim.update_limit(limit1)
    lim.update_window(window1)
    lim.set_override("seeded", 7)
    mgr.wal.close()
    lim.close()

    geo = ["--depth", str(cfg.sketch.depth), "--width",
           str(cfg.sketch.width), "--sub-windows",
           str(cfg.sketch.sub_windows), "--device", device,
           "--snapshot-dir", d, "--snapshot-interval", "3600",
           "--wal-fsync", "always"]
    servers = []
    try:
        srv = ServerProcess(["--limit", str(cfg.limit), "--window",
                             str(cfg.window)] + geo)
        servers.append(srv)
        if "no snapshot found, replayed 3 WAL record(s)" not in srv.recovered:
            raise AssertionError(f"first start: {srv.recovered}")
        c = DoorClient(srv.port)
        if _policy(c, p.T_POLICY_GET, "k") != (False, limit1, 1.0):
            raise AssertionError("the seeded update_limit was not recovered")
        t_first = time.time()
        for frame in _door_frames(rng, n_ids, 9):
            _send(c, frame)
        t, body = c.call(p.encode_policy_set, "vip", 9)
        if p.parse_policy_r(body) != (True, 9, 1.0):
            raise AssertionError("POLICY_SET answered wrongly")
        c.call(p.encode_reset, "k:reset")
        snap1, seq1, _, _, mb = _snapshot_file(c, d)
        _, body = c.call(lambda rid: p.encode_simple(p.T_METRICS, rid))
        capture_ms = 1e3 * metric_value(
            p.parse_metrics(body), "rate_limiter_snapshot_capture_seconds")
        c.call(p.encode_policy_set, "vip2", 11)
        _, body = c.call(lambda rid: p.encode_policy_key(p.T_POLICY_DEL,
                                                        rid, "vip"))
        if not p.parse_policy_r(body)[0]:
            raise AssertionError("POLICY_DEL found no override")
        c.call(p.encode_reset, "k:reset2")
        for frame in _door_frames(rng, n_ids, 3):   # lost with the crash
            _send(c, frame)
        c.close()
        srv.kill()
        shutil.copytree(d, copy)

        srv = ServerProcess(["--limit", str(limit1), "--window",
                             str(window1)] + geo)
        servers.append(srv)
        want_rec = (f"restored snapshot {snap1}, replayed 3 WAL record(s) "
                    f"past seq {seq1}")
        if want_rec not in srv.recovered:
            raise AssertionError(f"restart: {srv.recovered}")
        c = DoorClient(srv.port)
        for key, want in (("vip", (False, limit1, 1.0)),
                          ("vip2", (True, 11, 1.0)),
                          ("seeded", (True, 7, 1.0))):
            if _policy(c, p.T_POLICY_GET, key) != want:
                raise AssertionError(f"override {key} not recovered")
        _, _, arrays, meta, _ = _snapshot_file(c, d)

        # The CPU twin recovers the copy in the sub-window the server
        # replayed the RESET in.
        _, sub_us, SW, S, _ = sk.sketch_geometry(cfg1)
        hp = int(meta["host_period"])
        twin_mgr, twin = boot(copy, cfg1,
                              ManualClock((hp * sub_us + sub_us // 2) / 1e6))
        report = twin_mgr.recover()
        if report.replayed != 3 or report.apply_errors:
            raise AssertionError(f"CPU twin recovery: {report.summary()}")
        if int(arrays["slab_period"][hp % S]) == hp - SW:
            raise AssertionError("the boundary slab was live at the replay: "
                                 "the run outlasted the window")
        _, twin_arrays, twin_extra = twin.capture_state()
        for k in WINDOW_STATE + ("policy_keys", "policy_limits",
                                 "policy_scales"):
            if (arrays[k].dtype != twin_arrays[k].dtype
                    or not np.array_equal(arrays[k], twin_arrays[k])):
                raise AssertionError(f"recovered {k} differs from the CPU "
                                     f"twin's recovery")
        if twin_extra["host_period"] != hp:
            raise AssertionError("recovered host_period differs")

        alone_ms = []

        def serial(frames, label, latencies=alone_ms):
            for i, frame in enumerate(frames):
                got, bracket = _send(c, frame)
                want = (twin.allow_ids(frame[1]) if frame[0] == "ids"
                        else twin.allow_batch(frame[1]))
                _hold_against_twin(f"{label} frame {i}", got, bracket, want,
                                   window1)
                latencies.append(1e3 * (bracket[1] - bracket[0]))

        serial(_door_frames(rng, n_ids, 6), "after recovery")
        _, _, arrays, _, _ = _snapshot_file(c, d)
        if not np.array_equal(arrays["totals"],
                              twin.capture_state()[1]["totals"]):
            raise AssertionError("totals after recovery differ from the twin")
        # One hashed frame sent while another connection's SNAPSHOT holds
        # the limiter lock for its capture: its latency beside the frames
        # sent alone (a reading, not a check).
        snap_client = DoorClient(srv.port)
        taker = threading.Thread(target=_snapshot_file, args=(snap_client, d))
        taker.start()
        time.sleep(0.01)
        during_ms = []
        serial([("ids", zipf_ids(rng, n_ids))], "during a snapshot",
               during_ms)
        taker.join()
        snap_client.close()
        serial(_door_frames(rng, n_ids, 3), "before SIGTERM")
        if time.time() - t_first > 0.8 * window1:
            raise AssertionError("the run outlasted the window the "
                                 "comparison relies on")
        c.close()
        if srv.terminate() != 0:
            raise AssertionError("SIGTERM: the server did not exit cleanly")
        from ratelimiter_tpu_torch.persistence import read_manifest

        last = read_manifest(d)["snapshots"][-1]
        with np.load(os.path.join(d, last["files"][0])) as z:
            final_totals = z["totals"]
        if not np.array_equal(final_totals, twin.capture_state()[1]["totals"]):
            raise AssertionError("the SIGTERM snapshot lost decisions")
        twin_mgr.stop(final_snapshot=False)
        twin.close()
        out = {"recovery_s": srv.recovery_s(), "capture_lock_ms": capture_ms,
               "snapshot_mb": mb, "snapshots": last["id"],
               "recovered": srv.recovered,
               "frame_ms_alone": statistics.median(alone_ms),
               "frame_ms_during_snapshot": during_ms[0]}
    finally:
        for s in servers:
            s.kill()
        shutil.rmtree(root, ignore_errors=True)
    where = card_line() if device == "cuda" else "the CPU"
    log(f"durable door on {where}: seeded WAL recovered (limit "
        f"{cfg.limit}->{limit1}, window {cfg.window:g}->{window1:g} s); "
        f"SIGKILL after SNAPSHOT + POLICY_SET/DEL + RESET; restart recovered "
        f"in {out['recovery_s']:.3f} s ({out['recovered']}), state "
        f"bit-equal to the CPU twin's recovery, decisions after it too; "
        f"SIGTERM lost nothing; snapshot {mb:.1f} MB, capture lock hold "
        f"{capture_ms:.2f} ms; a frame sent during a snapshot answered in "
        f"{out['frame_ms_during_snapshot']:.2f} ms, frames sent alone in "
        f"{out['frame_ms_alone']:.2f} ms (median)")
    return out


def row_launches(name: str, windowed, bucket) -> int:
    """A kernel row's launches over the main paths' runs, the door's and
    phase 5's (each counted from 0 just before it and read just after):
    the standalone ``add_update`` is the TPU name's count less the fused
    back's, each admission launch counts as ``admit`` in its family's
    module."""
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
    door_cu = check_door(
        torch, config3(), "windowed CU", seed=args.seed + 17,
        counters=[sketch_cuda],
        required=("window_estimate", "admit", "cu_update"),
        same=("admit", "cu_update"))
    door_tb = check_door(
        torch, config2_bucket(), "TB-c2", seed=args.seed + 19, space="c2",
        counters=[bucket_cuda],
        required=("bucket_estimate", "admit", "bucket_update"),
        same=("admit", "bucket_update"))
    bare_cu = time_door(config3(), "windowed CU", seed=args.seed + 17)
    bare_tb = time_door(config2_bucket(), "TB-c2", seed=args.seed + 19,
                        space="c2")
    log(f"door on {card} (through the recording proxy | unproxied): "
        + "; ".join(
            f"{label} {d['decisions_per_s']:.0f} | "
            f"{b['decisions_per_s']:.0f} decisions/s, "
            f"{d['frames_per_dispatch']:.2f} | "
            f"{b['frames_per_dispatch']:.2f} frames a dispatch, frame "
            f"latency p50 {d['p50_ms']:.2f} | {b['p50_ms']:.2f} ms, p99 "
            f"{d['p99_ms']:.2f} | {b['p99_ms']:.2f} ms"
            for label, d, b in (("windowed CU", door_cu, bare_cu),
                                ("TB-c2", door_tb, bare_tb))))
    live = check_live_updates(torch, args.seed)
    watch = check_watchdog(torch)
    durable = check_durable_door(config3(), device="cuda", seed=args.seed)
    log(f"phase 5 on {card}: migration {live['migration_device_ms']} device "
        f"ms, update lock hold {live['lock_hold_ms']} ms (TB-c2 "
        f"{live['lock_hold_ms_TB-c2']}); strict deny-all batches "
        f"{watch['strict']['deny_all_batches']}, overload periods "
        f"{watch['strict']['overload_periods']}; recovery "
        f"{durable['recovery_s']:.3f} s, snapshot capture lock hold "
        f"{durable['capture_lock_ms']:.2f} ms, snapshot "
        f"{durable['snapshot_mb']:.1f} MB; a frame during a snapshot "
        f"{durable['frame_ms_during_snapshot']:.2f} ms against "
        f"{durable['frame_ms_alone']:.2f} ms alone")
    for name in rows:
        rows[name]["launches"] = row_launches(
            name, (cu, vanilla, door_cu, live["windowed"], watch),
            (tb_c2, tb_zipf, door_tb, live["bucket"]))
    paths["live"] = live
    paths["watchdog"] = watch
    paths["durable_door"] = durable
    paths["door_windowed_CU"] = door_cu
    paths["door_TB-c2"] = door_tb
    paths["door_unproxied_windowed_CU"] = bare_cu
    paths["door_unproxied_TB-c2"] = bare_tb

    log(json.dumps({"main_path": paths}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
