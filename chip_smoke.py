#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--steps N]
    python3 chip_smoke.py --sweep    # time the tiled updates' launch shapes
    python3 chip_smoke.py --admit-sweep   # time the admission routine's shapes
    python3 chip_smoke.py --dense    # the dense/exact backends, the evaluation path
    python3 chip_smoke.py --gateway  # the HTTP gateway, the auditor and its twin
    python3 chip_smoke.py --native   # the C++ door, its lanes, the load generator

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
   the heavy-hitter side table's kernels (the side-table builds of
   ``window_front``, ``window_admit`` and ``add_back``, and
   ``hh_update``) at config-3 shapes with 256 slots (the observatory
   deployment's ``--hh-slots 256``) and 2^22 (the most the config
   accepts), on the config-3 batch over a pre-seeded owner table, 4096
   requests on one slot, a batch holding keys whose h1 is 0, B = 0,
   B = ``ADMIT_CAPACITY`` and the next pad above it; each side-table
   build timed in turns with its build without the side table on the
   same operands, ``hh_update`` a kernel row of its own; every back
   build that runs the side table's update as its tail
   (``window_admit`` and ``add_back``, each with and without the
   cascade, the documented tenants over each batch's own keys) on the
   same batches, bit-equal to the plain back followed by
   ``hh_update_plain``, the counts showing one ``hh_update [fused]`` a
   back launch and no standalone ``hh_update`` up to ``ADMIT_CAPACITY``,
   each timed in turns with the parent's form (the build without the
   tail, then the standalone ``hh_update``) and with the build without
   the tail alone; the reset kernel (``window_reset``, the per-key
   reset in one launch) bit-equal to its plain version (the front's
   estimate-only form, the floors, ``add_update``) on a config-3 state,
   sliding and fixed, without a side table and with 256 and 2^22 slots,
   on 1 key, none, 6 keys two of which share a column,
   ``RESET_CAPACITY`` and one more (composed), timed on one key beside
   the composed reset; the hierarchy
   cascade's kernels (the cascade builds of ``add_back``,
   ``window_admit`` and ``bucket_admit``, and the cascade's routine
   alone, ``csrc/cascade_bench.cu``, which no path calls) in every
   operand form (sliding with the tenant boundary slab, fixed, the bucket
   in and past its counters' window) at T = 16 (the documented
   deployment), 64 (past the reference's dense int32 path) and 4096 (the
   most the config accepts) on contended, uncontended, one-tenant and
   wide-map (8192 rows, searched in global memory; the others are staged
   in shared memory) batches of B = 0, 4096 and ``ADMIT_CAPACITY``, every
   output, the sketch and the scope counters bit-equal, and at the next
   pad above it, where the backs run composed on the card (the plain
   admission and cascade) and the launch counts must show it; every
   cascade build's ``ptxas -v`` report must show a 0-byte stack frame;
   each cascade build a kernel row of its own (``<back> [cascade]``),
   timed in turns with its build without the flag on the contended
   deployment batch and on an uncontended one (T = 64), and beside the
   composed form (the build without the flag, then the routine alone);
   the dense backend's step (two launches: ``dense_front``, phase A
   across the card, then the admission and epilogue block; one build per
   algorithm, ``csrc/dense_kernels.cu``) on a 2^20-slot state (config
   3's 1M keys as slots), every output and the whole state bit-equal to
   its plain version, and phase A alone to ``dense_front_plain``, on the
   config-3 batch, 4096 requests on one slot, B = 0 and ADMIT_CAPACITY,
   each with and without a 1024-row override table (staged in shared
   memory; the config-3 batch also with an 8192-row one, searched in
   global memory) and under a lowered limit (negative free units), the
   next pad above ADMIT_CAPACITY composed (the plain step on the card);
   a kernel row per build for the step and for ``dense_front``, and the
   step's split (``csrc/dense_bench.cu``: phase A on one block as the
   previous design ran it, the admission alone, the epilogue); and the
   shadow auditor's twin's forms of the step's kernels
   (``check_twin_kernels``): ``window_front``, ``window_admit``,
   ``cu_update``, ``bucket_front``, ``bucket_admit`` and
   ``bucket_update`` at d = 1 (config 3's 60 sub-windows; TB-c2's rate)
   and w = 65,536 and 2^22 (the twin's widths at ``--audit-sample`` 64
   and 1) on the config-3 batch of finalized hashes, bit-equal to plain,
   each timed beside plain with its bound (``twin`` in its row);
3. drive each main path end to end through ``create_limiter(...,
   device="cuda")`` with launch/resolve and 4 tickets in flight, a policy
   override and a reset, and hold every result and the final state
   bit-identical to the same trace on the CPU (the plain versions, which
   the CPU tests hold to the JAX package). Each path's launch counts are
   set to 0 just before it and read just after, and each of its kernels
   must have launched (on a windowed path the reset exactly one
   ``window_reset`` launch and no standalone ``add_update``; with the
   side table one ``hh_update [fused]`` tail a back launch and no
   standalone ``hh_update``); the same trace then runs 4 more times on
   fresh limiters, and the median, min and max steps/s of the 5 are
   printed.
   Windowed: config-3 traffic across sub-window rollovers, with
   conservative update on and off, then a profile of a short CU and a
   short vanilla run; then config 3 with the side table (256 slots,
   threshold 50), CU and vanilla, with a hot string key promoted and
   then reset halfway and a 61 s jump (every owner idles out, then hot
   keys promote again), every ``hh_*`` array held too and its steps/s
   printed beside the path without the side table, and a profile of a
   short CU run. Token bucket: TB-c2, benchmark config 2's token-bucket
   cell at its literal parameters (limit 20 per 10 s, 4096 string keys
   per batch uniform over 10,000, +0.25 s per batch), and TB-zipf, config
   3's traffic under a token bucket (limit 100 per 60 s, +0.1 s per
   batch), then a profile of a short TB-zipf run. Each profile counts the
   device ops per batch and fails if a sort or scan op (the plain
   admission's) still runs on a path whose batches fit one admission
   launch. Then the tenant paths, under the documented deployment
   (docs/OPERATIONS.md:814-819: 16 tenants, global limit 50,000,
   gold=20000:5:2000, free=5000:1, api-cust-42 in gold, 13 more named
   tenants, booted by the binary's own flag code): windowed CU, vanilla
   and CU with 256 side-table slots on 4096 string keys a batch drawn
   Zipf(1.1) over 10,000 keys ``u:{i}`` (the 1,000 lowest-ranked assigned
   round-robin to the 15 named tenants), 64 batches at +0.1 s, then a
   jump to 60.5 s and 32 more (the boundary sub-window then releases
   mass every step: the global scope stays contended with room left);
   and TB-c2 under the same tenants, across its 10 s window. Every
   result and every ``tn_*`` array bit-equal to the CPU, every step a
   cascade build (no back without the cascade launched), and
   each path's steps/s printed beside the same trace without tenants.
   Then the dense backend (``create_limiter(cfg, "dense")``) under each
   algorithm at config 3's limit and window with 2^20 slots: 48 batches
   of 4096 string keys across two window rolls, an override, a reset,
   ``update_limit`` and ``update_window``, every result and the final
   state bit-identical to the CPU, one ``dense_front`` and one
   ``dense_step`` launch a batch, steps/s the median of 5 runs; the exact
   backend on the same trace equal to dense;
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
   back); the windowed CU door runs again with ``--hh-slots 256``, where
   METRICS must also show the side table's consumer gauges equal to the
   served limiter's ``consumer_stats``; and once more with the tenant
   flags (string frames over the assigned key space), every frame and
   the final ``tn_*`` state held to the CPU replay and every window a
   cascade build; then the door over the dense and the exact backend
   (string frames pipelined on one connection, every answer and the final
   state bit-identical to a CPU replay of the windows, ALLOW_HASHED
   refused, one ``dense_front`` and one ``dense_step`` launch a window).
   The same traffic is then
   served once more straight over a
   limiter on the system clock, without the proxy, as
   ``python -m ratelimiter_tpu_torch.serving`` serves it. Decisions/s
   through the door, frames a dispatch and p50/p99 frame latency of both
   runs are printed side by side. Every door runs under the binary's
   default decorator stack (``MetricsDecorator``, the event journal), and
   METRICS must show as many allowed plus denied decisions, and requests,
   as were served, and one front launch for each window;
   observe. the observability stack (``run_observe``; ``--observe`` runs
   it alone, ~2-3 min after the build): (a) the three doors above
   (windowed CU, CU with the side table, TB-c2) again under the binary's
   full stack (``--trace --circuit-breaker --log-decisions
   --log-redact-keys --flight-recorder``), each held as above, with every
   frame stage's ``rate_limiter_stage_seconds`` count non-zero; (b) 32
   traced ALLOW_HASHED and 8 traced ALLOW_N frames in-process, one at a
   time: each trace id's spans form the span tree (io, coalesce, queue,
   launch, device, resolve, encode, in that order) and ``chrome_trace()``
   parses; (c) 16 frames with an expired deadline, fail-open and
   fail-closed, shed with no launch and counted by
   ``rate_limiter_server_deadline_shed_total``, then 16 with 10 s equal
   to a CPU limiter; (d) the binary with ``--event-journal-dir``: a
   POLICY_SET, a POLICY_DEL and a RESET journaled in order with
   ``key_token`` keys, and with the tenant flags and ``--controller``
   under phase 5's storm, the controller's two tightens of free, two
   ticks apart, under two correlation ids, one a tick; (e) ``--circuit-breaker --breaker-threshold
   3`` on a ManualClock with a failure injected: it trips after 3, short
   circuits with no launch, a probe after the cooldown reaches the
   limiter, and after ``heal()`` one reaches the card and closes it; (f)
   ``TracingDecorator.capture`` around 16 config-3 CU batches: the trace
   holds a ``launch`` and a ``resolve`` range a batch and the step's
   kernels by name; the top 10 device ops and the host ms a batch in
   each range are printed; (g) ``time_door`` on windowed CU and TB-c2,
   bare (``--no-metrics --no-event-journal``), default and full stack in
   turns, one round in the whole run (three under ``--observe``):
   decisions/s and p50/p99 a round, the flight recorder's split by
   stage, printed (nothing is gated on them);
   gateway. the HTTP gateway, the shadow auditor and the SLO tracker
   (``run_gateway``; ``--gateway`` runs it alone with the twin's kernel
   rows): the binary's own ``serve`` in-process (``in_process_binary``)
   with ``--http-port``, every lever and its token, ``--flight-recorder``
   and ``--audit --audit-sample 1 --audit-twin`` over a recording proxy,
   on config 3 with ``--hh-slots 256`` and on TB-c2 (``check_gateway``):
   (a) 8 connections x 24 binary frames in the whole run (x 48,
   phase 4's traffic, under ``--gateway``) and 8 HTTP
   client threads x 40 /v1/allow requests (``gateway_client``, a child
   process: each thread its own keys, some in X-User-ID, with a
   traceparent or a deadline budget) at once, every binary frame and
   every HTTP answer (status, ``X-RateLimit-*``, ``Retry-After``,
   traceparent, body) bit-identical to a CPU replay of the recorded
   windows; (b) after the auditor's flush, /debug/audit's integers equal
   to its recorded offers recomputed through the port's
   ``ShadowComparator`` on the CPU (the plain twin and the host oracle),
   one front launch for each window, bucket reset and twin step, as many
   admissions as updates (no composed back); (c) /healthz's blocks equal
   to their sources (``consumer_stats``, the envelope or debt slab, the
   audit headline, the journal's status), /metrics with the audit and SLO
   gauges and its decision counters equal to the decisions of both
   doors; (d) /v1/policy PUT, GET, DELETE and /v1/reset (one
   ``window_reset``) 403 without their tokens and 200 with them, their
   events in /debug/events; (e) a traced request's span chain under its
   traceparent's id in /debug/trace, and /debug/profile?seconds=1 during
   the traffic naming the step's kernels. Then the tenant binary with
   ``--controller --audit --audit-sample 1`` under phase 5's storm ((f):
   the controller journals a move whose signals show a nonzero SLO burn
   or audit bound; /v1/tenants GET equal to ``hierarchy_stats``, a tenant
   changed and deleted; /healthz's hierarchy block) and the durable binary
   (/v1/snapshot writes the snapshot it names; /healthz's persistence
   status). Readings: the door's decisions/s and frame latency with no
   audit, ``--audit`` (sample 64) and ``--audit --audit-twin
   --audit-sample 1`` in turns, 3 rounds, with the auditor's audited and
   dropped frames and its seconds to flush; /v1/allow requests/s and
   p50/p99 at 8 and 32 client threads;
   native. the native C++ door (``run_native``; ``--native`` runs it
   alone): (a) ``NativeRateLimitServer`` on the card over config 3's
   windowed CU limiter behind the recording proxy and the default stack,
   8 connections of the port's AsyncClient x 48 frames pipelined 8 deep
   (in a child process), over TCP, a unix socket and the shared-memory
   lane, then two dispatch shards on the one card over the lane, then
   TB-c2 over TCP (``check_native_door``): every frame bit-identical to
   CPU replays of each shard's recorded windows (the door launches
   finalized hashes, the front's hashed form), each shard's final state
   to its replay's, one ``window_estimate``, ``admit`` and ``cu_update``
   a window and one ``window_reset`` a reset (TB-c2: one
   ``bucket_estimate`` a window and a reset, as many admissions as
   updates), one dispatch a window on METRICS, every decision on HEALTH;
   (b) ``python -m ratelimiter_tpu_torch.serving --native --shards 2
   --http-port 0 --audit --audit-sample 1 --snapshot-dir D`` as a child
   process (``check_native_binary``): binary and /v1/allow answers equal
   to CPU limiters of its two shards, the audit block, two resets around
   a snapshot, SIGKILL, the restart replaying the second onto its shard;
   (c) the port's C++ load generator (``native/loadgen.cpp``, built with
   g++) against the native door with 1 and 2 shards and the asyncio door
   in turns, one round in the whole run (three under ``--native``),
   hashed and batch frames over TCP and (the native door) the lane:
   decisions/s and RTT p50/p99 with the net engine that ran, printed
   (nothing is gated on them);
5. durable and live-reconfigured serving at config 3's full geometry,
   each part against a CPU limiter of the port driven with the same
   operations (the CPU port is held to the JAX package by the tests):
   live ``update_window`` 60 -> 45 -> 120 s and ``update_limit`` 100 -> 50
   -> 200 on config 3 (also with the side table, ``hh_*`` held) and the
   limit 20 -> 10 -> 40 on TB-c2, each with 4
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
   (``check_durable_door``), then stopped with SIGTERM; and the durable
   binary with the tenant flags and ``--controller``: a hot-tenant storm
   makes the controller tighten free (5,000 -> 3,500, read on METRICS),
   a SNAPSHOT, SIGKILL, and the restart's state (``tn_*`` and the
   ``hier_*`` columns with the moved limit) and decisions bit-equal to a
   CPU recovery (``check_tenant_durable_door``). The launch counts
   of the live and watchdog runs are set to 0 just before each and read
   just after; the recovery seconds, the snapshot's capture lock hold and
   its size are printed; a dense limiter's ``save`` on the card
   restored on the CPU (state equal, the next batches identical); and
   batches of ADMIT_CAPACITY + 1 (C8) on the dense limiter under each
   algorithm and on the tenant deployment (windowed CU, CU with the side
   table, vanilla, and TB-c2), each served composed on the card (its
   launch counts must show it: the standalone ``hh_update`` and
   ``add_update`` run there) and equal to a CPU replay
   (``check_above_capacity``);
6. the evaluation path at bench.py's geometry (d=3, w=2^20, 60
   sub-windows, CU, 1M keys, Zipf(1.1)): ``loadgen.build_bench_chunk``
   at B = 8192 across two rollovers and one chunk of 2^20 (whose launch
   counts must show the composed back), the card's Zipf ids against the
   CPU's over 2^20 counters; ``oracle_device.build_eval_chunk`` with its
   (60, 1, 2^20) oracle ring, its four stats and both states; the scan
   runners at 64 steps x 4096 for config 3, d=3 w=2^20 and TB-c2; each
   bit-equal to the CPU; ``evaluate_accuracy`` at bench.py's CI-scale
   arguments equal to the CPU's report; decisions/s of the bench chunk
   and the scans and the false-deny and false-allow rates with their
   window coverage printed as smoke readings;
7. print the kernel table as one JSON line, the card's name and power
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

``--cascade`` builds, then runs phase 2's cascade part alone and prints
its results as one JSON line before the card's line; ``--rows`` runs
the rest of phase 2 alone (the kernel rows, ``hh_update`` and the
side-table forms),
through wrappers an earlier checkout has too, so a copy of this script
in the parent's checkout times the parent's builds in the same call.

``--door`` builds, then times the config-3 door under the binary's default
stack three times (``time_door``) and prints the readings as one JSON
line before the card's line; it reaches the port only through public
entry points, so a copy of this script in an earlier checkout times that
checkout's door in the same call.

``--gateway`` builds, then holds and times the twin's kernels and runs
phase gateway alone, printing its results as one JSON line before the
card's line.

``--native`` builds (the kernels, the native door and the load generator),
then runs phase native alone and prints its results as one JSON line
before the card's line.

``--observe`` builds, then runs phase observe alone and prints its
results as one JSON line before the card's line.

``--dense`` builds, then runs the dense parts alone (the dense rows
of phase 2 with the step's split, the dense and exact paths, their
doors, the batches above capacity, the dense round trip and phase 6)
and prints their results as one JSON line before the card's line.

``--paths`` builds, then runs phase 3's main paths and its two
side-table paths alone (the launch-count rules of this checkout's tail
and reset are held only where the package counts them), and prints their
results as one JSON line before the card's line; ``--dense-paths`` runs
phase 3's dense paths alone in the same way. Both reach the port only
through ``create_limiter``, the limiters' public methods and the launch
counters (the counts the checkout's own step makes: an earlier one has
no ``dense_front``), so a copy of this script placed in an earlier
checkout measures that checkout's package on the same card (parent and
change in one call).

Without a CUDA device it exits non-zero before printing any result.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import pickle
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
    # Nor does the side table's update: jnp ops in the reference's step.
    "hh_update": "ratelimiter_tpu/ops/sketch_kernels.py:487",
    # The reset kernel replaces the reset's add_update together with the
    # estimate it subtracts (the JAX package's _sketch_reset,
    # ratelimiter_tpu/ops/sketch_kernels.py:539).
    "window_reset": "ratelimiter_tpu/ops/pallas_sketch.py:224",
    # Nor do the backs' cascade builds, which add to their back the
    # cascade (jnp in the reference, hier_kernels.py).
    "add_back [cascade]": "ratelimiter_tpu/ops/hier_kernels.py:119",
    "window_admit [cascade]": "ratelimiter_tpu/ops/hier_kernels.py:119",
    "bucket_admit [cascade]": "ratelimiter_tpu/ops/hier_kernels.py:119",
}
#: The side table of the documented observatory deployment
#: (docs/EXAMPLES.md:533, ``--hh-slots 256``) and the largest the config
#: accepts (ratelimiter_tpu/core/config.py:95-100).
HH_SLOTS, HH_SLOTS_MAX = 256, 1 << 22
HH_STATE = ("hh_owner", "hh_owner2", "hh_cur", "hh_slabs", "hh_totals",
            "hh_last")
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


def config3_hh(cu: bool = True):
    """Config 3 with the side table as the observatory deployment runs it:
    256 slots, the default promotion fraction 0.5 (threshold 50)."""
    import dataclasses

    c = config3(cu=cu)
    return dataclasses.replace(c, sketch=dataclasses.replace(
        c.sketch, hh_slots=HH_SLOTS))


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
               torch, ms=None) -> dict:
    """Time a kernel (unless its time ``ms`` is given), its plain version
    and (where one exists) the one PyTorch call computing the same
    function; bound = max(bytes over the HBM rate, operations over the
    non-tensor peak)."""
    if ms is None:
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


def window_state(torch, rng, depth: int = DEPTH, width: int = WIDTH):
    """A windowed state as after resets and traffic, negative cells
    included, at config-3 geometry (or ``depth`` x ``width``): totals,
    boundary, cur, and the boundary weight 0.377 s into a sub-window."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.sketch_kernels import frac_operands

    def slab(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=(
            depth, width)).astype(np.int32)).to("cuda")
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


#: The shadow auditor's collision-free twin at config 3 (observability/
#: audit.py): depth 1, config 3's 60 sub-windows (TB-c2's rate for the
#: bucket), width 65,536 at ``--audit-sample 64`` and 2^22 at
#: ``--audit-sample 1`` (the JAX rule, ratelimiter_tpu/observability/
#: audit.py:120-131).
TWIN_WIDTHS = (WIDTH, 1 << 22)


def check_twin_kernels(torch, seed: int) -> dict:
    """The twin's front, admission and update at d = 1 for each of
    ``TWIN_WIDTHS``, windowed (sliding, CU: the twin inherits config 3's
    conservative update) and bucket (TB-c2's rate), against their plain
    versions on the config-3 batch of 4096 Zipf ids as the twin gets
    them (finalized hashes: ``allow_hashed``), bit-equal; each timed
    beside its plain version, its bound from this run's data (the
    touched cells; the tiled updates, as their config-3 rows, the whole
    slab). Returns {width: {kernel row: its twin form}}. Launches made
    here do not count."""
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.hashing import splitmix64, u64_to_tensor

    dev = torch.device("cuda")
    B, d = BATCH, 1
    ops_admit = B * (6 * (ITERS + 2) + 40)
    out = {}
    for width in TWIN_WIDTHS:
        rng = np.random.default_rng(seed + 29 + width.bit_length())
        ids = zipf_ids(rng, B)
        keys = u64_to_tensor(splitmix64(ids), dev)
        n = torch.from_numpy(rng.integers(1, 4, size=B).astype(
            np.int32)).to(dev)
        totals, boundary, cur, frac = window_state(torch, rng, d, width)
        valid = ring_boundary(torch, boundary)
        debt = torch.from_numpy(rng.integers(0, 400_000_000, size=(
            d, width)).astype(np.int64)).to(dev)
        acc = debt.clone()
        err = {k: 0.0 for k in ("window_estimate", "window_admit",
                                "cu_update", "bucket_estimate",
                                "bucket_admit", "bucket_update")}
        wkw = dict(keys=keys, n=n, seed=SEED, boundary=valid, limit=LIMIT)
        want = sc.window_front_plain(totals, **wkw)
        hold_front(torch, err, "window_estimate",
                   sc.window_front(totals, **wkw), want)
        h1, h2, est, _, avail, n_f = want
        target = sc.window_admit_plain(h1, est, n_f, avail, ITERS)[0]
        for a, b in zip(sc.window_admit(h1, est, n_f, avail, ITERS),
                        sc.window_admit_plain(h1, est, n_f, avail, ITERS)):
            hold_equal(torch, err, "window_admit", a, b)
        got_t, got_c, ref_t, ref_c = (x.clone() for x in (totals, cur,
                                                          totals, cur))
        sc.cu_update(got_t, got_c, boundary, frac, h1, h2, target)
        sc.cu_update_plain(ref_t, ref_c, boundary, frac, h1, h2, target)
        hold_equal(torch, err, "cu_update", got_t, ref_t)
        hold_equal(torch, err, "cu_update", got_c, ref_c)
        decay = 3_333_337
        bkw = dict(keys=keys, n=n, seed=SEED, limit=C2_LIMIT)
        bwant = bc.bucket_front_plain(debt, decay, **bkw)
        hold_front(torch, err, "bucket_estimate",
                   bc.bucket_front(debt, decay, **bkw), bwant)
        _, _, _, b_avail, units = bwant
        rate = (C2_LIMIT, int(C2_WINDOW_S))
        for a, b in zip(bc.bucket_admit(h1, units, b_avail, ITERS, *rate),
                        bc.bucket_admit_plain(h1, units, b_avail, ITERS,
                                              *rate)):
            hold_equal(torch, err, "bucket_admit", a, b)
        consumed = bc.bucket_admit_plain(h1, units, b_avail, ITERS,
                                         *rate)[1]
        got_d, got_a, ref_d, ref_a = (x.clone() for x in (debt, acc, debt,
                                                          acc))
        bc.bucket_update(got_d, got_a, decay, h1, h2, consumed)
        bc.bucket_update_plain(ref_d, ref_a, decay, h1, h2, consumed)
        hold_equal(torch, err, "bucket_update", got_d, ref_d)
        hold_equal(torch, err, "bucket_update", got_a, ref_a)
        touched = int(torch.unique(sc._columns(h1, h2, d, width)[0]).numel())
        cells = d * width
        t_buf, c_buf, d_buf, a_buf = (x.clone() for x in (totals, cur, debt,
                                                          acc))
        timing = {
            "window_estimate": (
                SOURCE, lambda: sc.window_front(totals, **wkw),
                lambda: sc.window_front_plain(totals, **wkw),
                front_bytes(B, 8, 16 + 12, touched, 8, 0) + 4 + 8,
                B * (22 + 4 * d)),
            "window_admit": (
                SOURCE, lambda: sc.window_admit(h1, est, n_f, avail, ITERS),
                lambda: sc.window_admit_plain(h1, est, n_f, avail, ITERS),
                B * (8 + 4 + 4 + 4 + 4 + 1 + 4), ops_admit),
            "cu_update": (
                SOURCE, lambda: sc.cu_update(t_buf, c_buf, boundary, frac,
                                             h1, h2, target),
                lambda: sc.cu_update_plain(t_buf, c_buf, boundary, frac,
                                           h1, h2, target),
                B * (8 + 8 + 4) + cells * (8 + 8 + 4) + 4,
                d * B + 6 * cells),
            "bucket_estimate": (
                BUCKET_SOURCE, lambda: bc.bucket_front(debt, decay, **bkw),
                lambda: bc.bucket_front_plain(debt, decay, **bkw),
                front_bytes(B, 8, 16 + 24, touched, 8, 0),
                B * (22 + 4 * d)),
            "bucket_admit": (
                BUCKET_SOURCE, lambda: bc.bucket_admit(
                    h1, units, b_avail, ITERS, *rate),
                lambda: bc.bucket_admit_plain(h1, units, b_avail, ITERS,
                                              *rate),
                B * (8 + 8 + 8 + 1 + 8 + 8 + 8), ops_admit),
            "bucket_update": (
                BUCKET_SOURCE, lambda: bc.bucket_update(
                    d_buf, a_buf, decay, h1, h2, consumed),
                lambda: bc.bucket_update_plain(d_buf, a_buf, decay, h1, h2,
                                               consumed),
                B * (8 + 8 + 8) + cells * 16 + touched * 16,
                3 * cells + 4 * d * B),
        }
        forms = {}
        for name, (src, kern, plain, nbytes, ops) in timing.items():
            row = kernel_row(name, src, err[name], kern, plain, None,
                             nbytes, ops, torch)
            forms[name] = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                "max_abs_err")}
            forms[name]["touched_cells"] = touched
        log(f"kernels[twin d=1 w={width}]: window_front, window_admit, "
            f"cu_update, bucket_front, bucket_admit and bucket_update "
            f"bit-equal to plain on the config-3 batch of finalized hashes "
            f"({touched} cells touched)")
        out[width] = forms
        del totals, boundary, cur, debt, acc, t_buf, c_buf, d_buf, a_buf
        torch.cuda.empty_cache()
    return out


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


def side_batches(rng, K: int) -> dict:
    """The side-table kernels' batches as (h1, h2) int64 on the card: the
    config-3 batch (4096 Zipf ids), 4096 requests on one slot (keys h1 =
    5 + j*K: claim contention, ties by h1), the config-3 batch with every
    64th key's h1 set to 0, none, ``ADMIT_CAPACITY`` Zipf ids and the
    limiter's next pad above it."""
    import torch

    from ratelimiter_tpu_torch.algorithms.sketch import _pad_size
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    def zipf(B):
        return device_keys(torch, zipf_ids(rng, B))

    h1, h2 = zipf(BATCH)
    zero = h1.clone()
    zero[::64] = 0
    slot = torch.from_numpy(5 + K * rng.integers(0, 999, size=BATCH)).to(
        "cuda")
    return {"config3": (h1, h2), "one slot": (slot, h2),
            "h1 zero": (zero, h2), "empty": (h1[:0], h2[:0]),
            "capacity": zipf(sc.ADMIT_CAPACITY),
            "above capacity": zipf(_pad_size(sc.ADMIT_CAPACITY + 1))}


def side_state(torch, rng, h1, K: int) -> dict:
    """A side table at config-3 ring depth holding owners for a third of
    the config-3 batch's keys (the hottest among them) and random owners
    elsewhere, in-window counts and idle clocks."""
    dev = torch.device("cuda")
    owner = torch.zeros(K, dtype=torch.int64, device=dev)
    own = h1[: BATCH // 3]
    owner[own & (K - 1)] = own
    spare = torch.arange(K, device=dev) % 7 == 3
    owner[spare & (owner == 0)] = 0x9E3779B9
    return {"hh_owner": owner,
            "hh_owner2": torch.where(owner != 0, 0x2545F491, 0),
            "hh_cur": torch.randint(-2, 30, (K,), dtype=torch.int32,
                                    device=dev),
            "hh_slabs": torch.randint(-2, 60, (SUB_WINDOWS, K),
                                      dtype=torch.int32, device=dev),
            "hh_totals": torch.randint(-2, 90, (K,), dtype=torch.int32,
                                       device=dev),
            "hh_last": torch.full((K,), -(1 << 40), dtype=torch.int64,
                                  device=dev)}


def restorer(h1, state: dict, casc=None):
    """A call that puts ``state``'s owner pair back, at the slots the
    batch ``h1`` names, as it is now (and ``casc``'s scope counters).
    Run ahead of each timed call of the side table's update, it makes
    every call find the free slots the first one found, so that its
    candidates claim them again (pass A's claims, pass B): the timed
    calls do the first call's work. The other ``hh_*`` tensors need no
    restoring: the update only adds to them, or writes the same clock,
    and their values do not change its work."""
    K = state["hh_owner"].shape[0]
    idx = (h1 & (K - 1)).unique()
    saved = [(state[k], state[k][idx].clone())
             for k in ("hh_owner", "hh_owner2")]
    scope = [] if casc is None else [(t, t.clone())
                                     for t in (casc.counts, casc.cur)]

    def restore():
        for dst, src in saved:
            dst.index_copy_(0, idx, src)
        for dst, src in scope:
            dst.copy_(src)
    return restore


def restored(restore, fn):
    """``fn`` after ``restore``: a timed call on fresh state."""
    def call():
        restore()
        return fn()
    return call


def side_calls(sc, totals, cur, bnd, side, h1, h2, n, hh, thresh, period):
    """The four side-table kernels on one batch: {name: (kernel call,
    plain call, the kernel's build without the side table on the same
    operands, or None)}, and the operands hh_update takes. hh_update's
    calls work on their own copies of the table and put its owners back
    first (``restorer``), so every call claims what the first claimed;
    ``hh_update`` also has a fourth element, that restore alone (the
    timed calls' baseline)."""
    front = dict(n=n, boundary=bnd, limit=LIMIT, hh=side)
    _, _, est, frac, avail, n_f, (mine, _, _) = sc.window_front_plain(
        totals, (h1, h2), **front)
    t, c, t2, c2 = totals.clone(), cur.clone(), totals.clone(), cur.clone()
    _, allowed, _, target_pr = sc.window_admit_plain(h1, est, n_f, avail,
                                                     ITERS, mine)
    g = {k: v.clone() for k, v in hh.items()}
    p = {k: v.clone() for k, v in hh.items()}
    fresh_g, fresh_p = restorer(h1, g), restorer(h1, p)
    plain_front = dict(front, hh=None)
    return {
        "window_front": (
            lambda: sc.window_front(totals, (h1, h2), **front),
            lambda: sc.window_front_plain(totals, (h1, h2), **front),
            lambda: sc.window_front(totals, (h1, h2), **plain_front)),
        "window_admit": (
            lambda: sc.window_admit(h1, est, n_f, avail, ITERS, mine),
            lambda: sc.window_admit_plain(h1, est, n_f, avail, ITERS, mine),
            lambda: sc.window_admit(h1, est, n_f, avail, ITERS)),
        "add_back": (
            lambda: (*sc.add_back(t, c, h1, h2, n, n_f, avail, ITERS, est,
                                  mine), t, c),
            lambda: (*sc.add_back_plain(t2, c2, h1, h2, n, n_f, avail, ITERS,
                                        est, mine), t2, c2),
            lambda: sc.add_back(t2, c2, h1, h2, n, n_f, avail, ITERS)),
        "hh_update": (
            restored(fresh_g, lambda: (sc.hh_update(
                g, h1, h2, n, allowed, mine, target_pr, thresh=thresh,
                period=period), *g.values())[1:]),
            restored(fresh_p, lambda: (sc.hh_update_plain(
                p, h1, h2, n, allowed, mine, target_pr, thresh=thresh,
                period=period), *p.values())[1:]),
            None, fresh_g),
    }, (est, allowed, mine, target_pr)


def _flat(out):
    """A kernel's outputs as a flat list of tensors (the front's seventh
    element is a tuple)."""
    flat = []
    for x in out:
        if isinstance(x, tuple):
            flat.extend(x)
        elif x is not None:
            flat.append(x)
    return flat


def side_cascade(torch, rng, h1, h2, n):
    """The documented deployment's tenant scopes (TENANTS, TENANT_MAP) over
    a side-table batch's own keys, for the backs' cascade builds with the
    tail: the hottest keys round-robin over tenants 1..T-1, limits about
    half the demand above random counters (the global one a third), the
    tenant boundary slab weighted by 0.377. A ``Cascade`` on the card."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.policy_kernels import (
        PAD_KEY,
        pack_halves_host,
    )

    T, dev = TENANTS, h1.device
    keys = pack_halves_host(h1.cpu().numpy().astype(np.uint32),
                            h2.cpu().numpy().astype(np.uint32))
    uniq, counts = np.unique(keys, return_counts=True)
    hot = uniq[np.argsort(-counts, kind="stable")][:TENANT_MAP]
    tids = 1 + np.arange(len(hot), dtype=np.int64) % (T - 1)
    P = max(8, 1 << int(np.ceil(np.log2(max(1, len(hot))))))
    order = np.argsort(hot)
    key = np.full(P, PAD_KEY, np.int64)
    tid = np.zeros(P, np.int64)
    key[:len(hot)], tid[:len(hot)] = hot[order], tids[order]
    of = dict(zip(hot.tolist(), tids.tolist()))
    tid_b = np.array([of.get(int(k), 0) for k in keys], np.int64)
    demand = np.bincount(tid_b, weights=n.cpu().numpy(),
                         minlength=T + 1).astype(np.int64)
    cnt = rng.integers(0, 40, size=T + 1)
    limit = (cnt + 20 + demand // 2).astype(np.int64)
    limit[T] = cnt[T] + 20 + int(demand.sum()) // 3

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(
            dev)

    hier = {"key": t(key, np.int64), "tid": t(tid, np.int64),
            "limit": t(limit, np.int64),
            "weight": t(rng.integers(1, 6, size=T + 1), np.int64)}
    return sc.Cascade(hier, h2, n, t(cnt, np.int32), t(cnt // 3, np.int32),
                      t(rng.integers(-3, 40, size=T + 1), np.int32),
                      torch.tensor(0.377, dtype=torch.float32, device=dev))


def tail_calls(sc, totals, cur, front, h1, h2, n, hh, thresh, period,
               casc=None) -> dict:
    """The two backs' side-table builds with the side table's update as
    their tail on one batch: {name: (kernel call, plain call, the parent's
    form: the same build without the tail, then the standalone
    ``hh_update``, and the build without the tail alone)}. ``front`` is
    the front's (plain) output on the batch; ``casc`` (a ``Cascade``)
    picks the cascade builds. Each call returns every output, the sketch
    slabs it wrote (``add_back``), every ``hh_*`` tensor and the scope
    counters, and works on its own copies of them, made here; it first
    puts their owners and scope counters back (``restorer``), so that
    every call admits and claims what the first did. A fifth element,
    that restore alone, is the timed calls' baseline."""
    _, _, est, _, avail, n_f, (mine, _, _) = front
    up_kw = dict(thresh=thresh, period=period)

    def copies():
        c = None if casc is None else casc._replace(
            counts=casc.counts.clone(), cur=casc.cur.clone())
        return ({k: v.clone() for k, v in hh.items()}, c, totals.clone(),
                cur.clone())

    def scope(c):
        return [] if c is None else [c.counts, c.cur]

    def admit(form):
        st, c, _, _ = copies()
        fresh = restorer(h1, st, c)

        def call():
            fresh()
            if form == "fused":
                out = sc.window_admit(h1, est, n_f, avail, ITERS, mine, c,
                                      hh=sc.SideUpdate(st, thresh, period),
                                      h2=h2, n=n)
            elif form == "plain":
                out = sc.window_admit_plain(h1, est, n_f, avail, ITERS, mine,
                                            c)
                sc.hh_update_plain(st, h1, h2, n, out[1], mine, out[3],
                                   **up_kw)
            else:
                out = sc.window_admit(h1, est, n_f, avail, ITERS, mine, c)
                if form == "parent":
                    sc.hh_update(st, h1, h2, n, out[1], mine, out[3],
                                 **up_kw)
            return [*out, *st.values(), *scope(c)]
        return call, fresh

    def back(form):
        st, c, t, u = copies()
        fresh = restorer(h1, st, c)

        def call():
            fresh()
            if form == "fused":
                out = sc.add_back(t, u, h1, h2, n, n_f, avail, ITERS, est,
                                  mine, c,
                                  hh=sc.SideUpdate(st, thresh, period))
            elif form == "plain":
                out = sc.add_back_plain(t, u, h1, h2, n, n_f, avail, ITERS,
                                        est, mine, c)
                sc.hh_update_plain(st, h1, h2, n, out[0], mine, out[2],
                                   **up_kw)
            else:
                out = sc.add_back(t, u, h1, h2, n, n_f, avail, ITERS, est,
                                  mine, c)
                if form == "parent":
                    sc.hh_update(st, h1, h2, n, out[0], mine, out[2],
                                 **up_kw)
            return [*out, t, u, *st.values(), *scope(c)]
        return call, fresh

    def forms(make):
        calls = [make(f) for f in ("fused", "plain", "parent", "no tail")]
        return (*(call for call, _ in calls), calls[0][1])

    flag = " [cascade, tail]" if casc is not None else " [tail]"
    return {f"window_admit{flag}": forms(admit),
            f"add_back{flag}": forms(back)}


def reset_bytes(B: int, d: int, hh: bool, weighted: bool) -> int:
    """The bytes a reset of B keys must move: each key's h1 and h2; its d
    cells of totals and cur read once and written once (the estimate
    reads the same totals cell the subtraction writes), and of the
    boundary read; the boundary's period; with the side table its slot's
    owner read, its hh_totals and hh_cur cells read once and written once,
    and its boundary cell read."""
    boundary = 4 if weighted else 0
    per = 16 + d * (16 + boundary)
    if hh:
        per += 8 + 16 + boundary
    return B * per + (8 if weighted else 0)


def check_reset(torch, seed: int) -> dict:
    """The reset kernel (``window_reset``) against its plain version
    (``window_reset_plain``: the front's estimate-only form, floor,
    ``add_update``) on a config-3 state: sliding (a valid boundary) and
    fixed, without a side table and with K = 256 and 2^22 slots (a third
    of the keys owned), on batches of 1 key (the limiter's reset), 0, 6
    keys of which two share a column, ``RESET_CAPACITY`` and the next
    size above it (composed: ``window_front`` then ``add_update``; the
    launch counts must show it); every slab and ``hh_*`` tensor
    bit-equal. A kernel row: one key with the side table (the side-table
    path's reset), beside the plain version, the composed form (the
    parent's reset: the front's kernel, the floors and one or two
    ``add_update`` kernels) and the same without the side table."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    rng = np.random.default_rng(seed + 53)
    totals, boundary, cur, _ = window_state(torch, rng)
    period = int(T0 * 1e6) // (int(WINDOW_S * 1e6) // SUB_WINDOWS)
    err = {"window_reset": 0.0}
    timed = {}
    for K in (0, HH_SLOTS, HH_SLOTS_MAX):
        for label, B in (("one key", 1), ("empty", 0), ("shared column", 6),
                         ("capacity", sc.RESET_CAPACITY),
                         ("above capacity", sc.RESET_CAPACITY + 1)):
            h1, h2 = device_keys(torch, zipf_ids(rng, max(B, 1)))
            h1, h2 = h1[:B].contiguous(), h2[:B].contiguous()
            if B == 6:
                h1[1] = h1[0]      # row 0: one column, two keys
            hh = side_state(torch, rng, h1, K) if K else None
            for weighted in (True, False):
                bnd = ring_boundary(torch, boundary) if weighted else None

                def run(fn, composed=False):
                    # Copies of what a reset writes (the side table's
                    # ring is only read: its boundary column).
                    t, c = totals.clone(), cur.clone()
                    g = None if hh is None else {
                        k: hh[k].clone() for k in ("hh_owner", "hh_totals",
                                                   "hh_cur")}
                    side = None if g is None else sc.SideTable(
                        g["hh_owner"], g["hh_totals"],
                        hh["hh_slabs"][period % SUB_WINDOWS]
                        if weighted else None)
                    k1, k2 = h1, h2
                    kw = dict(boundary=bnd, hh=side,
                              hh_cur=None if g is None else g["hh_cur"])

                    def call():
                        if composed:
                            sc._reset(sc.window_front, sc.add_update, t, c,
                                      k1, k2, kw["boundary"], side,
                                      kw["hh_cur"])
                        else:
                            fn(t, c, k1, k2, **kw)
                        return [t, c] + ([] if g is None
                                         else list(g.values()))
                    return call

                sc.reset_launch_counts()
                got = run(sc.window_reset)()
                want = run(sc.window_reset_plain)()
                for a, b in zip(got, want):
                    hold_equal(torch, err, "window_reset", a, b)
                counts = sc.launch_counts()
                fused = B <= sc.RESET_CAPACITY
                want_counts = {"window_reset": int(fused),
                               "window_estimate": int(not fused),
                               "add_update": 0 if fused else 1 + bool(K)}
                if any(counts[k] != v for k, v in want_counts.items()):
                    raise AssertionError(f"window_reset at K={K}, B={B}: "
                                         f"launch counts {counts}, expected "
                                         f"{want_counts}")
                if B == 1 and weighted:
                    timed[K] = (run(sc.window_reset),
                                run(sc.window_reset_plain),
                                run(None, composed=True))
            log(f"kernels: window_reset bit-equal to plain at K={K} on the "
                f"{label} batch (B={B}), sliding and fixed")
    # In turns: composed, kernel, kernel, composed; with the side table,
    # then without.
    kern, plain, composed = timed[HH_SLOTS]
    comp = [device_ms(composed, torch)]
    ms = [device_ms(kern, torch), device_ms(kern, torch)]
    comp.append(device_ms(composed, torch))
    row = kernel_row("window_reset", SOURCE, err["window_reset"], kern, plain,
                     None, reset_bytes(1, DEPTH, True, True), 0, torch,
                     ms=statistics.mean(ms))
    row.update(ms_runs=ms, composed_ms=statistics.mean(comp),
               composed_ms_runs=comp, K=HH_SLOTS,
               form="one key, sliding, side table (the side-table reset)")
    kern, plain, composed = timed[0]
    comp0 = [device_ms(composed, torch)]
    ms0 = [device_ms(kern, torch), device_ms(kern, torch)]
    comp0.append(device_ms(composed, torch))
    row["without_side_table"] = {
        "ms": statistics.mean(ms0), "ms_runs": ms0,
        "composed_ms": statistics.mean(comp0), "composed_ms_runs": comp0,
        "plain_ms": device_ms(plain, torch),
        "bound_ms": reset_bytes(1, DEPTH, False, True) / HBM_BYTES_PER_S
        * 1e3}
    log(f"time window_reset [one key, K={HH_SLOTS}]: kernel {ms[0] * 1e3:.2f}"
        f" / {ms[1] * 1e3:.2f} us, composed {comp[0] * 1e3:.2f} / "
        f"{comp[1] * 1e3:.2f} us; without the side table kernel "
        f"{ms0[0] * 1e3:.2f} / {ms0[1] * 1e3:.2f} us, composed "
        f"{comp0[0] * 1e3:.2f} / {comp0[1] * 1e3:.2f} us")
    return {"window_reset": row}


def check_side_table(torch, seed: int) -> dict:
    """The side table's kernels against their plain versions at config-3
    shapes with K = 256 and 2^22 slots on every ``side_batches`` batch:
    ``window_front``, ``window_admit`` and ``add_back`` in their
    side-table builds without the tail, the standalone ``hh_update``, and
    every back build with the tail (``tail_calls``: ``window_admit`` and
    ``add_back``, each with and without the cascade, on ``side_cascade``'s
    tenants), every output and every slab, ``hh_*`` tensor and scope
    counter bit-equal; the launch counts must show the fused backs (one
    ``hh_update [fused]`` a back launch, no standalone ``hh_update``) up
    to ``ADMIT_CAPACITY`` keys, and the composed ones (the standalone
    ``hh_update`` after each) above it. Times and bounds on the config-3
    batch (the side-table forms beside the rows of their kernels,
    hh_update a row of its own; each build with the tail in turns with
    the parent's form, the same build without the tail and then the
    standalone hh_update, and with the build without the tail alone).
    Launches made here do not count."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    rng = np.random.default_rng(seed + 31)
    totals, boundary, cur, _ = window_state(torch, rng)
    bnd = ring_boundary(torch, boundary)
    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    period = int(T0 * 1e6) // sub_us
    thresh = max(1.0, LIMIT * 0.5)
    err = {"window_front": 0.0, "window_admit": 0.0, "add_back": 0.0,
           "hh_update": 0.0}
    timed, tails, info = {}, {}, {}
    for K in (HH_SLOTS, HH_SLOTS_MAX):
        batches = side_batches(rng, K)
        hh = side_state(torch, rng, batches["config3"][0], K)
        side = sc.SideTable(hh["hh_owner"], hh["hh_totals"],
                            hh["hh_slabs"][period % SUB_WINDOWS])
        for label, (h1, h2) in batches.items():
            B = h1.shape[0]
            n = torch.from_numpy(rng.integers(0, 4, size=B).astype(
                np.int32)).to("cuda")
            calls, (est, allowed, mine, target_pr) = side_calls(
                sc, totals, cur, bnd, side, h1, h2, n, hh, thresh, period)
            sc.reset_launch_counts()
            for name, (kern, plain, *_) in calls.items():
                got, want = _flat(kern()), _flat(plain())
                if len(got) != len(want):
                    raise AssertionError(f"{name}: outputs missing")
                for a, b in zip(got, want):
                    hold_equal(torch, err, name, a, b)
            fused = int(B <= sc.ADMIT_CAPACITY)
            counts = sc.launch_counts()
            want_counts = {"window_estimate": 1, "admit": fused,
                           "add_back": fused, "add_update": 1,
                           "hh_update": 1, "hh_update [fused]": 0}
            if any(counts.get(k, 0) != v for k, v in want_counts.items()):
                raise AssertionError(f"side table at K={K}, B={B}: launch "
                                     f"counts {counts}, expected "
                                     f"{want_counts}")
            # The backs with the tail, without and with the cascade (an
            # earlier checkout, timed with --rows, has no tail).
            front = sc.window_front_plain(totals, (h1, h2), n, boundary=bnd,
                                          limit=LIMIT, hh=side)
            casc = side_cascade(torch, rng, h1, h2, n)
            with_tail = {} if not hasattr(sc, "SideUpdate") else {
                **tail_calls(sc, totals, cur, front, h1, h2, n, hh, thresh,
                             period),
                **tail_calls(sc, totals, cur, front, h1, h2, n, hh, thresh,
                             period, casc)}
            sc.reset_launch_counts()
            for name, (kern, plain, *_) in with_tail.items():
                err.setdefault(name, 0.0)
                got, want = kern(), plain()
                if len(got) != len(want):
                    raise AssertionError(f"{name}: outputs missing")
                for a, b in zip(got, want):
                    hold_equal(torch, err, name, a, b)
            counts = sc.launch_counts()
            want_counts = {"admit": fused, "admit [cascade]": fused,
                           "add_back": fused, "add_back [cascade]": fused,
                           "hh_update [fused]": 4 * fused,
                           "hh_update": 4 * (1 - fused),
                           # The fused add_back builds or the standalone.
                           "add_update": 2}
            if with_tail and any(counts[k] != v
                                 for k, v in want_counts.items()):
                raise AssertionError(f"backs with the tail at K={K}, B={B}: "
                                     f"launch counts {counts}, expected "
                                     f"{want_counts}")
            plain_hh = {k: v.clone() for k, v in hh.items()}
            sc.hh_update_plain(plain_hh, h1, h2, n, allowed, mine,
                               target_pr, thresh=thresh, period=period)
            changed = {k: int((plain_hh[k] != hh[k]).sum())
                       for k in ("hh_owner", "hh_cur", "hh_last")}
            # Candidates: requests of unowned keys at a free slot whose
            # target reaches the threshold (each claims by a max).
            cand = ~mine & (hh["hh_owner"][h1 & (K - 1)] == 0) & (
                target_pr >= float(np.float32(thresh)))
            info[f"K={K} {label}"] = {
                "batch": B, "form": "fused" if fused else "composed",
                "owned": int(mine.sum()), "allowed": int(allowed.sum()),
                "slots_named": int(torch.unique(h1 & (K - 1)).numel()),
                "candidates": int(cand.sum()),
                "claimed": changed["hh_owner"], "counted": changed["hh_cur"],
                "touched": changed["hh_last"]}
            log(f"kernels: the side table's window_front, window_admit, "
                f"add_back, hh_update and the four back builds with the "
                f"tail bit-equal to plain at K={K} on the {label} batch "
                f"(B={B}, {info[f'K={K} {label}']})")
            if label == "config3":
                timed[K] = (calls, dict(info[f"K={K} {label}"],
                                        keys=(h1, h2),
                                        written=allowed & ~mine & (n > 0)),
                            B)
                tails[K] = with_tail
                if K == HH_SLOTS:
                    casc3 = casc
    rows = {}
    calls, bi, B = timed[HH_SLOTS]
    slots = bi["slots_named"]
    h1, h2 = bi.pop("keys")
    cols = sc._columns(h1, h2, DEPTH, WIDTH)
    touched = sum(int(torch.unique(cols[r]).numel()) for r in range(DEPTH))
    written = bi.pop("written")
    reached = sum(int(torch.unique(cols[r][written]).numel())
                  for r in range(DEPTH))
    # hh_update's bytes: each key's h1, h2, n, allowed, mine and
    # target_pr once; the owner read at each named slot, hh_last written
    # where touched, hh_cur and hh_totals read and written where counted,
    # the owner pair written where claimed.
    hh_state = (slots * 8 + bi["touched"] * 8 + bi["counted"] * 16
                + bi["claimed"] * 16)
    hh_bytes = B * (8 + 8 + 4 + 1 + 1 + 4) + hh_state
    # Each form's bytes, its side-table part last: the front (halves and
    # n in; est, avail, n_f out; totals and boundary per touched cell;
    # the slot's owner, total and boundary per named slot; mine, est_cms,
    # est_hh out), window_admit (h1, est, n_f, avail, mine in; target,
    # allowed, remaining, target_pr out), add_back (h1, h2, n, n_f, avail,
    # est, mine in; allowed, remaining, target_pr out; the cells the
    # unowned admitted keys reach, in totals and cur, read and written).
    side_bytes = {
        "window_front": B * (8 + 8 + 4 + 12) + touched * 8 + 12
        + slots * (8 + 4 + 4) + B * (1 + 4 + 4),
        "window_admit": B * (8 + 4 + 4 + 4 + 4 + 1 + 4) + B * (1 + 4),
        "add_back": B * (8 + 8 + 4 + 4 + 4 + 1 + 4) + reached * 16
        + B * (4 + 1 + 4)}
    for name, nbytes in side_bytes.items():
        kern, plain, base = calls[name]
        # In turns: without the side table, with it, with it, without.
        base_ms = [device_ms(base, torch)]
        ms = [device_ms(kern, torch), device_ms(kern, torch)]
        base_ms.append(device_ms(base, torch))
        plain_ms = device_ms(plain, torch)
        rows[name] = {"ms": statistics.mean(ms), "ms_runs": ms,
                      "without_side_table_ms": statistics.mean(base_ms),
                      "without_side_table_ms_runs": base_ms,
                      "plain_ms": plain_ms, "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "K": HH_SLOTS,
                      "max_abs_err": err[name],
                      "lane": "halves, n, valid boundary, no policy"}
        log(f"time {name} [side table, K={HH_SLOTS}, halves lane]: kernel "
            f"{ms[0] * 1e3:.2f} / {ms[1] * 1e3:.2f} us, without the side "
            f"table {base_ms[0] * 1e3:.2f} / {base_ms[1] * 1e3:.2f} us, "
            f"plain {plain_ms * 1e3:.2f} us")
    # The backs with the tail: in turns, the parent's form (the build
    # without the tail, then the standalone hh_update), the build without
    # the tail alone, the build with it twice, then the other two again;
    # every call puts the owners and scope counters back first, and that
    # restore, timed before and after, is taken off each time. The tail
    # reads from memory only what its back did not: the table's state
    # (hh_state), and window_admit's h2 and n (add_back reads both, and
    # allowed, mine and target_pr stay in the block). A cascade build
    # also reads its map and scopes and writes its counters.
    tail_only = {"window_admit": B * (8 + 4) + hh_state,
                 "add_back": hh_state}
    scope_bytes = (sum(t.numel() * t.element_size()
                       for t in (*casc3.hier.values(), casc3.slab,
                                 casc3.frac))
                   + 2 * sum(t.numel() * t.element_size()
                             for t in (casc3.counts, casc3.cur)))
    tail_rows = {}
    for K, forms in tails.items():
        for name, (kern, plain, parent, alone, fresh) in forms.items():
            if K != HH_SLOTS and "cascade" in name:
                continue
            r_ms = [device_ms(fresh, torch)]
            p_ms, a_ms = [device_ms(parent, torch)], [device_ms(alone, torch)]
            ms = [device_ms(kern, torch), device_ms(kern, torch)]
            a_ms.append(device_ms(alone, torch))
            p_ms.append(device_ms(parent, torch))
            r_ms.append(device_ms(fresh, torch))
            r = statistics.mean(r_ms)
            base = "window_admit" if name.startswith("window_admit") else (
                "add_back")
            nbytes = side_bytes[base] + tail_only[base] + (
                scope_bytes if "cascade" in name else 0)
            row = {"ms": statistics.mean(ms) - r, "ms_runs": ms,
                   "parent_ms": statistics.mean(p_ms) - r,
                   "parent_ms_runs": p_ms,
                   "without_tail_ms": statistics.mean(a_ms) - r,
                   "without_tail_ms_runs": a_ms,
                   "restore_ms": r, "restore_ms_runs": r_ms,
                   "tail_excess_ms": statistics.mean(ms)
                   - statistics.mean(a_ms), "K": K,
                   "max_abs_err": err[name], "bound_by": "bytes"}
            if K == HH_SLOTS:
                row.update(plain_ms=device_ms(plain, torch) - r, bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            tail_rows[f"{name} K={K}"] = row
            log(f"time {name} [K={K}, restore {r * 1e3:.2f} us taken off]: "
                f"with the tail {(ms[0] - r) * 1e3:.2f} / "
                f"{(ms[1] - r) * 1e3:.2f} us, without it "
                f"{(a_ms[0] - r) * 1e3:.2f} / {(a_ms[1] - r) * 1e3:.2f} us "
                f"(excess {row['tail_excess_ms'] * 1e3:.2f} us), parent's "
                f"form (+ standalone hh_update) {(p_ms[0] - r) * 1e3:.2f} / "
                f"{(p_ms[1] - r) * 1e3:.2f} us")
    # The standalone hh_update, each call on restored owners, less the
    # restore alone.
    kern, plain, _, fresh = calls["hh_update"]
    r = device_ms(fresh, torch)
    row = kernel_row("hh_update", SOURCE, err["hh_update"], kern, plain,
                     None, hh_bytes, B * 12, torch,
                     ms=device_ms(kern, torch) - r)
    row["plain_ms"] -= r
    row.update(K=HH_SLOTS, batch_info=info, tails=tail_rows, restore_ms=r,
               candidates=bi["candidates"], claimed=bi["claimed"])
    kern, plain, _, fresh = timed[HH_SLOTS_MAX][0]["hh_update"]
    r = device_ms(fresh, torch)
    row[f"K={HH_SLOTS_MAX}"] = {"ms": device_ms(kern, torch) - r,
                                "plain_ms": device_ms(plain, torch) - r,
                                "restore_ms": r}
    log(f"time hh_update [K={HH_SLOTS_MAX}, restore {r * 1e3:.2f} us taken "
        f"off]: kernel {row[f'K={HH_SLOTS_MAX}']['ms'] * 1e3:.2f} us, plain "
        f"{row[f'K={HH_SLOTS_MAX}']['plain_ms'] * 1e3:.2f} us")
    return {"hh_update": row, "side_forms": rows}


# ------------------------------------------------- phase 2: the cascade

#: The documented tenant deployment (docs/OPERATIONS.md:814-819) on
#: config 3: 16 tenants, a 1024-row key->tenant map, a global limit of
#: 50,000 per window, gold=20000:5:2000, free=5000:1, api-cust-42 in
#: gold; 13 more named tenants fill the table (CASC_OTHERS, each
#: 2000 a window, weights 1-3).
TENANTS, TENANT_MAP, GLOBAL_LIMIT = 16, 1024, 50_000
CASC_OTHERS = tuple((f"t{i}", 2000, 1 + i % 3) for i in range(2, 15))
#: The widths the cascade's kernels are held at: the deployment's, the
#: first above the reference's dense int32 path (64 scopes), and the
#: most the config accepts.
CASC_TENANTS = (TENANTS, 64, 4096)
#: The batches: contended, uncontended, every request in one tenant, and
#: contended over a map of CASC_WIDE_MAP rows (above the 4096 the cascade
#: builds stage in shared memory: searched in global memory).
CASC_KINDS = ("contended", "uncontended", "one tenant", "wide map")
CASC_WIDE_MAP = 8192


def cascade_case(rng, B: int, T: int, kind: str) -> dict:
    """Host operands of one cascade case: B Zipf ids' halves, request
    counts 0-3, stage-1 verdicts (85% pass), a sorted key->tenant map
    (the batch's hottest ids round-robin over tenants 1..T-1, at most
    TENANT_MAP of them; ``one tenant``: every id of the batch in tenant 1;
    ``wide map``: CASC_WIDE_MAP rows, the hottest ids' and ids the batch
    does not hold), random weights 1-5 and counters, and limits: unlimited
    (``uncontended``), or about half the stage-1 demand above the
    counters at every scope, the global one at a third."""
    from ratelimiter_tpu_torch.core.config import HIER_UNLIMITED
    from ratelimiter_tpu_torch.ops.hashing import split_hash, splitmix64
    from ratelimiter_tpu_torch.ops.policy_kernels import (
        PAD_KEY,
        pack_halves_host,
    )

    ids = zipf_ids(rng, B)
    h1, h2 = split_hash(splitmix64(ids), SEED)
    n = rng.integers(0, 4, size=B).astype(np.int32)
    allowed_key = rng.random(B) < 0.85
    uniq, counts = np.unique(ids, return_counts=True)
    hot = uniq[np.argsort(-counts, kind="stable")]
    if kind == "one tenant":
        tids = np.ones(len(hot), np.int64)
    else:
        hot = hot[:TENANT_MAP]
        tids = 1 + np.arange(len(hot), dtype=np.int64) % (T - 1)
    if kind == "wide map":
        hot = np.concatenate([hot, rng.integers(
            N_KEYS, 1 << 40, size=CASC_WIDE_MAP - len(hot)).astype(
                np.uint64)])
        tids = 1 + np.arange(len(hot), dtype=np.int64) % (T - 1)
    P = max(8, 1 << int(np.ceil(np.log2(max(1, len(hot))))))
    q1, q2 = split_hash(splitmix64(hot), SEED)
    skeys = pack_halves_host(q1, q2)
    order = np.argsort(skeys)
    key = np.full(P, PAD_KEY, np.int64)
    tid = np.zeros(P, np.int64)
    key[:len(hot)], tid[:len(hot)] = skeys[order], tids[order]
    of = dict(zip(hot.tolist(), tids.tolist()))
    tid_b = np.array([of.get(int(i), 0) for i in ids], np.int64)
    demand = np.bincount(tid_b, weights=n * allowed_key,
                         minlength=T + 1).astype(np.int64)
    cnt = rng.integers(0, 40, size=T + 1)
    if kind == "uncontended":
        limit = np.full(T + 1, HIER_UNLIMITED, np.int64)
    else:
        limit = (cnt + 20 + demand // 2).astype(np.int64)
        limit[T] = cnt[T] + 20 + int(demand.sum()) // 3
    return {"h1": h1.astype(np.int64), "h2": h2.astype(np.int64), "n": n,
            "allowed_key": allowed_key, "key": key, "tid": tid,
            "limit": limit, "weight": rng.integers(1, 6, size=T + 1),
            "counts": cnt, "slab": rng.integers(-3, 40, size=T + 1),
            "est": (rng.random(B) * 30).astype(np.float32),
            "avail": (rng.integers(0, 6, size=B)
                      + rng.random(B)).astype(np.float32)}


#: The width of ``add_back``'s sketch in the cascade's checks (its own
#: cells are held in check_backs at config 3's width).
CASC_WIDTH = 1024
#: The cascade's operand forms: the windowed sketch's, sliding (with the
#: tenant boundary slab, weight 0.377) and fixed, and the bucket's, in its
#: counters' window and in a later one (``rolled``).
CASC_MODES = ("sliding", "fixed", "bucket", "bucket rolled")


def make_cascade(torch, case: dict, mode: str, dev):
    """``(h1, allowed_key, Cascade)`` on ``dev`` from ``cascade_case``'s
    operands, with fresh scope counters (a back folds into them)."""
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x if dtype is None else x.to(dtype)).to(dev)

    hier = {k: t(case[k], torch.int64) for k in ("key", "tid", "limit",
                                                  "weight")}
    h2, n = t(case["h2"]), t(case["n"])
    if mode.startswith("bucket"):
        c = sc.Cascade(hier, h2, n, t(case["counts"], torch.int64),
                       rolled=mode == "bucket rolled", retry_us=4_321_000)
    else:
        slab = t(case["slab"], torch.int32) if mode == "sliding" else None
        frac = (torch.tensor(0.377, dtype=torch.float32, device=dev)
                if mode == "sliding" else None)
        c = sc.Cascade(hier, h2, n, t(case["counts"], torch.int32),
                       t(case["counts"] // 3, torch.int32), slab, frac)
    return t(case["h1"]), t(case["allowed_key"]), c


def _casc_state(c) -> list:
    return [c.counts] + ([] if c.cur is None else [c.cur])


_CASCADE_BENCH: list = []


def cascade_bench(c, h1, allowed_key, iters: int, marks=None) -> tuple:
    """The cascade's routine alone (``csrc/cascade_bench.cu``, one launch
    of one block, no fold), which no path of the limiter calls:
    ``sketch_cuda.cascade_admit_plain``'s function. Returns ``(allowed
    bool[B], hist int64[T+1])``; at most ``ADMIT_CAPACITY`` requests.
    With ``marks`` (an int64 (11,) tensor on the card) thread 0 records
    the SM clock at entry and after each of the routine's steps."""
    import ctypes

    import torch

    from ratelimiter_tpu_torch.ops import _build
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    if not _CASCADE_BENCH:
        lib = ctypes.CDLL(_build.compile_source("cascade_bench"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rl_cascade_bench.argtypes = [P, P, P, P, P, P, P, P, I, P, P, I,
                                         P, P, P, P, I, I, I, P, P]
        lib.rl_cascade_bench.restype = I
        _CASCADE_BENCH.append(lib)
    B = h1.shape[0]
    T = sc._check_cascade(c, B, h1.device)
    allowed = torch.empty(B, dtype=torch.bool, device=h1.device)
    hist = torch.empty(T + 1, dtype=torch.int64, device=h1.device)
    err = _CASCADE_BENCH[0].rl_cascade_bench(
        h1.data_ptr(), allowed_key.data_ptr(), allowed.data_ptr(),
        hist.data_ptr(), c.h2.data_ptr(), c.n.data_ptr(),
        *sc._cascade_args(c), int(c.rolled), B, iters,
        None if marks is None else marks.data_ptr(),
        torch.cuda.current_stream(h1.device).cuda_stream)
    if err:
        raise RuntimeError(f"cascade_bench: CUDA error {err}")
    return allowed, hist


def cascade_calls(torch, sc, bc, case: dict, mode: str, dev,
                  fresh: bool = True) -> dict:
    """{kernel: (kernel call, plain call, call without the cascade)} on
    one case in one mode: ``cascade_admit`` (the routine alone,
    ``cascade_bench``) and the cascade builds of the mode's backs. Each
    call returns its outputs and the tensors it wrote; with ``fresh``
    each works on its own copies of the scope counters (the backs fold
    into them) and of ``add_back``'s small sketch, made on the device;
    without, every call updates the same ones (the timed form: nothing
    but the call runs)."""
    h1, ak, c0 = make_cascade(torch, case, mode, dev)
    est, avail = (torch.from_numpy(case[k]).to(dev) for k in ("est",
                                                             "avail"))
    n, h2 = c0.n, c0.h2
    n_f = n.to(torch.float32)
    units = n.to(torch.int64) * 1_000_000
    b_avail = (avail.double() * 1e6).to(torch.int64)
    tables = torch.from_numpy(np.random.default_rng(len(case["n"])).integers(
        0, 30, size=(2, DEPTH, CASC_WIDTH)).astype(np.int32)).to(dev)

    def copies():
        if not fresh:
            return c0, tables[0], tables[1]
        c = c0._replace(counts=c0.counts.clone(),
                        cur=None if c0.cur is None else c0.cur.clone())
        return c, tables[0].clone(), tables[1].clone()

    def k1(fn):
        def call():
            return list(fn(copies()[0], h1, ak, ITERS))
        return call

    def add_back(fn, casc=True):
        def call():
            c, t, u = copies()
            out = fn(t, u, h1, h2, n, n_f, avail, ITERS,
                     casc=c if casc else None)
            return [*out, t, u] + (_casc_state(c) if casc else [])
        return call

    def window_admit(fn, casc=True):
        def call():
            c = copies()[0]
            out = fn(h1, est, n_f, avail, ITERS, casc=c if casc else None)
            return list(out) + (_casc_state(c) if casc else [])
        return call

    def bucket_admit(fn, casc=True):
        def call():
            c = copies()[0]
            out = fn(h1, units, b_avail, ITERS, 5, 3,
                     casc=c if casc else None)
            return list(out) + (_casc_state(c) if casc else [])
        return call

    calls = {"cascade_admit": (k1(cascade_bench),
                               k1(sc.cascade_admit_plain), None)}
    if mode.startswith("bucket"):
        calls["bucket_admit"] = (bucket_admit(bc.bucket_admit),
                                 bucket_admit(bc.bucket_admit_plain),
                                 bucket_admit(bc.bucket_admit, False))
    else:
        calls["add_back"] = (add_back(sc.add_back),
                             add_back(sc.add_back_plain),
                             add_back(sc.add_back, False))
        calls["window_admit"] = (window_admit(sc.window_admit),
                                 window_admit(sc.window_admit_plain),
                                 window_admit(sc.window_admit, False))
    return calls


def cascade_launches(sc, bc) -> dict:
    """The launch counts of both kernel modules, flat (the bucket's keys
    prefixed ``bucket``)."""
    return {**sc.launch_counts(), **{f"bucket {k}": v for k, v in
                                     bc.launch_counts().items()}}


def touched_cells(case: dict, allowed, w: int) -> int:
    """Sketch cells of a (DEPTH, w) table that the admitted requests of
    ``case`` (n > 0) reach: columns (h1 + r*h2) & (w-1)."""
    keep = np.asarray(allowed) & (case["n"] > 0)
    h1, h2 = case["h1"][keep], case["h2"][keep]
    return sum(len(np.unique((h1 + r * h2) & (w - 1))) for r in range(DEPTH))


def cascade_ptxas() -> dict:
    """``ptxas -v``'s report of the three backs' builds (with and without
    the cascade, with and without the side table) and of the routine
    alone, by block shape: registers and stack frame, under names such as
    ``add_back [cascade] hh 1024x8``. Raises unless every cascade build
    has a 0-byte stack frame."""
    import re

    from ratelimiter_tpu_torch.ops import _build

    back = re.compile(r"(add_back|window_admit|bucket_admit)_kernelIN8rl_admit"
                      r"5ShapeILi(\d+)ELi(\d+)E[a-z]Li5EEE((?:Lb[01]E)+)")
    alone = re.compile(r"cascade_kernelIN8rl_admit5ShapeILi(\d+)ELi(\d+)E")
    out = {}
    for source in ("sketch_kernels", "bucket_kernels", "cascade_bench"):
        for mangled, props in _build.ptxas_report(source).items():
            m = back.search(mangled)
            if m:
                flags = re.findall(r"Lb([01])E", m.group(4))
                casc, hh = flags[-1] == "1", len(flags) == 2 and flags[0] == "1"
                key = (f"{m.group(1)}{' [cascade]' if casc else ''}"
                       f"{' hh' if hh else ''} {m.group(2)}x{m.group(3)}")
                out[key] = props
                continue
            m = alone.search(mangled)
            if m and "NoProbe" in mangled:  # the build the bench times
                out[f"cascade alone {m.group(1)}x{m.group(2)}"] = props
    casc = {k: v for k, v in out.items() if "cascade" in k}
    bad = {k: v for k, v in casc.items() if v.get("stack_frame", 0)}
    if len(casc) != 4 * 6 or bad:
        raise AssertionError(f"cascade builds: {len(casc)} found, with a "
                             f"stack frame: {bad}")
    log("ptxas: every cascade build has a 0-byte stack frame; registers "
        + ", ".join(f"{k} {v['registers']}" for k, v in sorted(casc.items())))
    log("ptxas: the builds without the flag: " + ", ".join(
        f"{k} {v['registers']} registers, {v['stack_frame']} B stack"
        for k, v in sorted(out.items()) if "cascade" not in k))
    return out


def cascade_smem_bytes() -> dict:
    """The dynamic shared memory of the cascade builds at B = 8192 (1024
    threads x 8) with T = 4096, a 4096-row map staged and a 8192-row one
    searched (``rl_cascade_smem_bytes``, from the build)."""
    import ctypes

    from ratelimiter_tpu_torch.ops import _build

    lib = ctypes.CDLL(_build.compile_source("cascade_bench"))
    lib.rl_cascade_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.rl_cascade_smem_bytes.restype = ctypes.c_longlong
    return {f"B=8192 T=4096 P={P}": lib.rl_cascade_smem_bytes(8192, 4096, P)
            for P in (4096, CASC_WIDE_MAP)}


#: The cascade routine's steps, as its bench build's marks close them
#: (cascade.cuh ``decide``): the map landed and indexed, the tenant ids,
#: the scopes' availability, the demand and the uncontended test, then
#: (contended) the sort, stage 2, the demand after it, the caps, stage 3,
#: the admitted mass and the final mask.
CASC_STEPS = ("map", "ids", "avail", "demand+test", "sort", "stage 2",
              "demand 2", "caps", "stage 3", "admitted+mask")


def check_cascade(torch, seed: int) -> dict:
    """The cascade's kernels against their plain versions: the routine
    alone (``cascade_bench``) in every ``CASC_MODES`` form, and the
    cascade builds of the three backs (``add_back`` and ``window_admit``
    sliding and fixed, ``bucket_admit`` in and past its window), every
    output, the sketch and every scope counter bit-equal, at T = 16, 64
    and 4096 on contended, uncontended, one-tenant and wide-map batches
    (the map staged in shared memory, or of 8192 rows searched in global
    memory) of B = 0, 4096 and ``ADMIT_CAPACITY``; at the limiter's next
    pad above it the backs run composed on the card (the plain admission
    and cascade; the routine alone is one block and takes no such batch),
    held to the plain versions too. The launch counts must show one
    cascade build a call and nothing else (composed: only ``add_back``'s
    standalone ``add_update``). Every cascade build's ``ptxas`` report
    must show a 0-byte stack frame. Times on the deployment's shape (T =
    16, B = 4096, contended, sliding; bucket not rolled) and on the
    uncontended batch at T = 64: each cascade build a kernel row of its
    own (``<back> [cascade]``), timed in turns with its build without the
    flag on the same operands (without, with, with, without), and beside
    the composed form (the build without the flag, then the routine
    alone). Launches made here do not count."""
    from ratelimiter_tpu_torch.algorithms.sketch import _pad_size
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    from ratelimiter_tpu_torch.ops.policy_kernels import PAD_KEY as PAD

    ptxas = cascade_ptxas()
    smem = cascade_smem_bytes()
    log(f"cascade builds' dynamic shared memory: {smem}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 41)
    names = ("cascade_admit", "add_back", "window_admit", "bucket_admit")
    err = {k: 0.0 for k in names}
    info = {}
    timed = {}
    timed_cases = {}
    for T in CASC_TENANTS:
        for kind in CASC_KINDS:
            for B in (0, BATCH, sc.ADMIT_CAPACITY,
                      _pad_size(sc.ADMIT_CAPACITY + 1)):
                case = cascade_case(rng, B, T, kind)
                fused = int(B <= sc.ADMIT_CAPACITY)
                flips = {}
                for mode in CASC_MODES:
                    calls = cascade_calls(torch, sc, bc, case, mode, dev)
                    sc.reset_launch_counts()
                    bc.reset_launch_counts()
                    for name, (kern, plain, _) in calls.items():
                        if name == "cascade_admit" and not fused:
                            continue  # one block, as the builds' routine
                        want = plain()
                        if name == "cascade_admit":
                            flips[mode] = int(
                                (want[0] != torch.from_numpy(
                                    case["allowed_key"]).to(dev)).sum())
                        if name == "add_back" and (T, kind, B, mode) == (
                                TENANTS, "contended", BATCH, "sliding"):
                            timed_allowed = want[0].cpu().numpy()
                        got = kern()
                        if len(got) != len(want):
                            raise AssertionError(f"{name}: outputs missing")
                        for a, b in zip(got, want):
                            hold_equal(torch, err, name, a, b)
                    counts = cascade_launches(sc, bc)
                    windowed = not mode.startswith("bucket")
                    want_counts = ({"add_update": 1} if windowed else {}) if (
                        not fused) else ({"add_back [cascade]": 1,
                                          "admit [cascade]": 1,
                                          "add_update": 1} if windowed
                                         else {"bucket admit [cascade]": 1})
                    hold_counts(f"cascade at T={T}, B={B}, {kind}, {mode}",
                                counts, want_counts)
                    for label, at in (("contended", (TENANTS, "contended")),
                                      ("uncontended", (64, "uncontended"))):
                        if (T, kind, B) == (*at, BATCH) and mode in (
                                "sliding", "bucket"):
                            family = "windowed" if windowed else "bucket"
                            timed_cases[label] = case
                            timed[(family, label)] = cascade_calls(
                                torch, sc, bc, case, mode, dev, False)
                key = f"T={T} {kind} B={B}"
                info[key] = {"form": "fused" if fused else "composed",
                             "map_rows": int(case["key"].size),
                             "verdicts_flipped": flips}
                log(f"kernels: the cascade alone and the backs' cascade "
                    f"builds bit-equal to plain at T={T}, {kind}, B={B} "
                    f"({info[key]})")
    # Bytes at the timed shape: the back's own (as check_backs counts
    # them), plus each request's h2 and n where the back lacks them, the
    # map's key and tid columns, and for each scope present (with the
    # default tenant and the global one) its limit and weight read and
    # its counters read and written (windowed: tn_totals and tn_cur, and
    # the boundary slab read; bucket: tn_counts, int64).
    case = timed_cases["contended"]
    present = len(np.unique(case["tid"][case["key"] != PAD])) + 2
    map_b = case["key"].size * 16
    casc_ops = BATCH * (12 + 6 * (2 * ITERS + 3))
    back_ops = BATCH * (6 * (ITERS + 2) + 40)
    changed = touched_cells(case, timed_allowed, CASC_WIDTH)
    shape = {
        "add_back": (SOURCE, BATCH * (8 + 8 + 4 + 4 + 4 + 1 + 4)
                     + changed * 16 + map_b + present * (16 + 20),
                     back_ops + 2 * DEPTH * BATCH + casc_ops),
        "window_admit": (SOURCE, BATCH * (8 + 4 + 4 + 4 + 8 + 4 + 4 + 1 + 4)
                         + map_b + present * (16 + 20), back_ops + casc_ops),
        "bucket_admit": (BUCKET_SOURCE,
                         BATCH * (8 + 8 + 8 + 8 + 4 + 1 + 8 + 8 + 8) + map_b
                         + present * (16 + 16), back_ops + casc_ops),
    }

    def in_turns(kern, base) -> tuple:
        """Without the cascade, with it, with it, without."""
        base_ms = [device_ms(base, torch)]
        ms = [device_ms(kern, torch), device_ms(kern, torch)]
        base_ms.append(device_ms(base, torch))
        return ms, base_ms

    # The routine's steps at the two timed shapes: the SM clock after each
    # (cascade_bench's marks), median of 5 launches, in us at the SM clock.
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 0)
    steps = {}
    for label, case in timed_cases.items():
        h1, ak, c = make_cascade(torch, case, "sliding", dev)
        marks = torch.zeros(11, dtype=torch.int64, device=dev)
        runs = []
        for _ in range(5):
            marks.zero_()
            cascade_bench(c, h1, ak, ITERS, marks)
            m = marks.cpu().numpy()
            runs.append([int(m[j] - m[j - 1]) if m[j] else 0
                         for j in range(1, 11)])
        cycles = [int(statistics.median(r[j] for r in runs))
                  for j in range(10)]
        steps[label] = {"cycles": dict(zip(CASC_STEPS, cycles)),
                        "sm_khz": khz,
                        "us": {k: (v / khz * 1e3 if khz else None)
                               for k, v in zip(CASC_STEPS, cycles)}}
        log(f"cascade steps ({label}, SM clock {khz} kHz): "
            + ", ".join(f"{k} {v}" for k, v in zip(CASC_STEPS, cycles)))
    rows = {}
    for family in ("windowed", "bucket"):
        calls = timed[(family, "contended")]
        alone_ms = device_ms(calls["cascade_admit"][0], torch)
        unc = timed[(family, "uncontended")]
        for name, (kern, plain, base) in calls.items():
            if name == "cascade_admit":
                continue
            ms, base_ms = in_turns(kern, base)
            unc_ms, unc_base_ms = in_turns(unc[name][0], unc[name][2])
            source, nbytes, ops = shape[name]
            row = kernel_row(f"{name} [cascade]", source, err[name], kern,
                             plain, None, nbytes, ops, torch,
                             ms=statistics.mean(ms))
            row.update(
                ms_runs=ms, without_cascade_ms=statistics.mean(base_ms),
                without_cascade_ms_runs=base_ms,
                excess_ms=statistics.mean(ms) - statistics.mean(base_ms),
                uncontended={
                    "lane": f"T=64, B={BATCH}, uncontended",
                    "ms": statistics.mean(unc_ms), "ms_runs": unc_ms,
                    "without_cascade_ms": statistics.mean(unc_base_ms),
                    "without_cascade_ms_runs": unc_base_ms,
                    "excess_ms": statistics.mean(unc_ms)
                    - statistics.mean(unc_base_ms)},
                cascade_alone_ms=alone_ms,
                cascade_alone_max_abs_err=err["cascade_admit"],
                composed_ms=statistics.mean(base_ms) + alone_ms,
                ptxas={k: v for k, v in ptxas.items() if k.startswith(name)},
                cascade_steps=steps,
                smem_bytes=smem, T=TENANTS, batch_info=info,
                lane=f"{family}, T={TENANTS}, B={BATCH}, contended")
            if name == "add_back":
                row["changed_cells"] = changed
            rows[f"{name} [cascade]"] = row
            log(f"time {name} [cascade build, T={TENANTS}]: "
                f"{ms[0] * 1e3:.2f} / {ms[1] * 1e3:.2f} us, without the "
                f"cascade {base_ms[0] * 1e3:.2f} / {base_ms[1] * 1e3:.2f} "
                f"us (excess {row['excess_ms'] * 1e3:.2f} us), composed "
                f"(without + the cascade alone, {alone_ms * 1e3:.2f} us) "
                f"{row['composed_ms'] * 1e3:.2f} us; uncontended at T=64: "
                f"{unc_ms[0] * 1e3:.2f} / {unc_ms[1] * 1e3:.2f} us, without "
                f"{unc_base_ms[0] * 1e3:.2f} / {unc_base_ms[1] * 1e3:.2f} us "
                f"(excess {row['uncontended']['excess_ms'] * 1e3:.2f} us)")
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


def drive(lim, batches, keys, *, advance: float = 0.1, inflight: int = 4,
          reset_key: str = "tenant:whale", jump=None):
    """Run a trace through launch/resolve with up to ``inflight`` tickets
    outstanding; returns the BatchResults in launch order. A batch is an
    array of raw u64 ids (``launch_ids``, every other one wire-packed) or
    a list of string keys (``launch_batch``); every 8th step also sends
    ``keys``, one of which ("tenant:whale") is overridden, and halfway
    through ``reset_key`` is reset. ``jump`` (step, seconds) advances the
    clock that much more before that step."""
    pending, out = [], []
    lim.set_override("tenant:whale", 40)
    for step, batch in enumerate(batches):
        if jump is not None and step == jump[0]:
            lim.clock.advance(jump[1])
        if step == len(batches) // 2:
            while pending:
                out.append(lim.resolve(pending.pop(0)))
            lim.reset(reset_key)
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
               counters, required, state_keys, strict: bool = True,
               drive_kw=None, setup=None) -> dict:
    """One main path on the card against the same trace on the CPU: every
    result field and the final state bit-identical. ``counters`` are the
    kernel modules whose launch counts are set to 0 just before the run
    and read just after it; each kernel named in ``required`` must have
    launched (unless ``strict`` is off and the package counts no such
    kernel: an earlier checkout measured with ``--paths``). ``drive_kw``
    goes to every ``drive``; ``setup`` (if given) to every limiter made
    here, before its traffic."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    drive_kw = drive_kw or {}

    def make(device):
        lim = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                             device=device)
        if setup is not None:
            setup(lim)
        return lim

    gpu = make("cuda")
    # Warm-up on a throwaway limiter (first-call costs), then the run.
    warm = make("cuda")
    drive(warm, batches[:4], keys, advance=advance)
    warm.close()
    torch.cuda.synchronize()
    for mod in counters:
        mod.reset_launch_counts()
    t = time.perf_counter()
    got = drive(gpu, batches, keys, advance=advance, **drive_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {}
    for mod in counters:
        counts.update(mod.launch_counts())
    _, gpu_arrays, extra = gpu.capture_state()
    stats = (gpu.consumer_stats(k=5) if getattr(gpu, "has_hh", False)
             else None)
    gpu.close()

    cpu = make("cpu")
    want = drive(cpu, batches, keys, advance=advance, **drive_kw)
    _, cpu_arrays, _ = cpu.capture_state()
    hier_stats = (cpu.hierarchy_stats()
                  if cfg.hierarchy.enabled else None)
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
    if "window_reset" in counts:
        # A windowed path: the trace's one reset is one window_reset
        # launch, and every batch fits one back launch, so no standalone
        # add_update ran (neither a composed back nor a composed reset).
        standalone = (counts["add_update"] - counts["add_back"]
                      - counts["add_back [cascade]"])
        if counts["window_reset"] != 1 or standalone:
            raise AssertionError(f"{name}: {counts['window_reset']} "
                                 f"window_reset launches for one reset, "
                                 f"{standalone} standalone add_update")
    denied = sum(int((~r.allowed).sum()) for r in got)
    # The same trace again on fresh limiters, for the spread of the rate.
    walls = [wall]
    for _ in range(REPEATS - 1):
        again = make("cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        drive(again, batches, keys, advance=advance, **drive_kw)
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
    if stats is not None:
        out["consumer_stats"] = stats
    if hier_stats is not None:
        out["hierarchy_stats"] = hier_stats
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
                     ("window_estimate", "admit", "cu_update", "window_reset")
                     if cu else ("window_estimate", "add_back",
                                 "window_reset"),
                     ("cur", "slabs", "totals", "slab_period", "last_period"),
                     strict)
    sub_us = int(WINDOW_S * 1e6) // SUB_WINDOWS
    out["rollovers"] = int(out["extra"]["host_period"]
                           - int(T0 * 1e6) // sub_us)
    if out["rollovers"] < 3:
        raise AssertionError(f"only {out['rollovers']} rollovers")
    return out


#: The side-table path's string key: 128 requests every 8th step, past
#: the promotion threshold (50) in its first batch, so that the reset
#: halfway is a reset of a promoted key.
HOT_KEY = "user:hot"


def check_hh_path(torch, seed: int, steps: int, cu: bool,
                  strict: bool = True) -> dict:
    """The side-table path (config 3 with 256 slots, ``config3_hh``) end
    to end against the CPU on config-3 traffic, with an override, a
    reset of a promoted key halfway and a 61 s jump at three quarters
    (every owner idles out at the next rollover, then hot keys promote
    again): every result and every state array, ``hh_*`` included,
    bit-identical. Every kernel of the path must have launched, with an
    admission launch per update (no plain version ran on the card), the
    side table's update the tail of every back launch (no standalone
    hh_update) and the reset one window_reset launch."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc
    from ratelimiter_tpu_torch.ops.hashing import split_hash

    batches, keys = _trace(seed, steps)
    keys = keys + [HOT_KEY] * 128
    cfg = config3_hh(cu=cu)
    drive_kw = {"reset_key": HOT_KEY, "jump": (3 * steps // 4, 61.0)}
    # The hot key is promoted before its reset: the same trace up to it.
    probe = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                           device="cpu")
    drive(probe, batches[:steps // 2], keys, advance=0.1)
    h1 = int(split_hash(probe._hash([HOT_KEY]), SEED)[0][0])
    owner = probe.capture_state()[1]["hh_owner"]
    promoted = int(owner[h1 & (HH_SLOTS - 1)]) == h1
    probe.close()
    if not promoted:
        raise AssertionError(f"{HOT_KEY} is not promoted before its reset")
    out = check_path(
        torch, f"windowed cu={cu} hh_slots={HH_SLOTS}", cfg, batches, keys,
        0.1, [sc], ("window_estimate", "admit", "cu_update",
                    "hh_update [fused]", "window_reset")
        if cu else ("window_estimate", "add_back", "hh_update [fused]",
                    "window_reset"),
        WINDOW_STATE + HH_STATE, strict=strict, drive_kw=drive_kw)
    if strict or "hh_update [fused]" in out["counts"]:
        hold_tails(f"side-table path cu={cu}", out["counts"])
    log(f"side table: {HOT_KEY} promoted before its reset; consumers "
        f"tracked at the end {out['consumer_stats']['occupied']}, top "
        f"{[c['in_window'] for c in out['consumer_stats']['top']]}")
    return out


def hold_tails(name: str, counts: dict) -> None:
    """A side-table path's launch counts: every step one front, one back
    launch (one admission per ``cu_update`` on the CU path) carrying the
    side table's update as its tail, no standalone ``hh_update`` (every
    batch is at most ADMIT_CAPACITY keys); the reset is one
    ``window_reset`` launch and adds no front (``check_path`` holds the
    reset itself)."""
    backs = (counts["admit"] + counts["admit [cascade]"]
             + counts["add_back"] + counts["add_back [cascade]"])
    cu_ok = counts["cu_update"] in (0, counts["admit"]
                                    + counts["admit [cascade]"])
    if (counts["hh_update"] or not cu_ok
            or counts["hh_update [fused]"] != backs
            or counts["window_estimate"] != backs):
        raise AssertionError(f"{name}: launch counts {counts} (a composed "
                             f"back, a standalone hh_update, or a back "
                             f"without its tail)")


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


#: The tenant paths' traffic: string keys ``u:{i}`` drawn Zipf(1.1) over
#: TENANT_KEYS (i = rank - 1), the TENANT_ASSIGNED lowest-ranked
#: assigned round-robin to the 15 named tenants; TENANT_STEPS batches at
#: +0.1 s, then a jump to T0 + TENANT_JUMP_S (the first sub-window is
#: then the boundary one and releases mass every step, so the global
#: scope stays contended with room left) and TENANT_AFTER more.
TENANT_KEYS, TENANT_ASSIGNED = 10_000, 1_000
TENANT_STEPS, TENANT_AFTER, TENANT_JUMP_S = 64, 32, 60.5


def tenant_keys(rng, n: int) -> list:
    return [f"u:{int(i)}" for i in (rng.zipf(ZIPF_A, size=n) - 1)
            % TENANT_KEYS]


def tenant_flags() -> list:
    """The documented deployment's flags (docs/OPERATIONS.md:814-819)
    with 13 more named tenants and the key assignments."""
    named = ["gold", "free"] + [name for name, _, _ in CASC_OTHERS]
    flags = ["--tenants", str(TENANTS), "--tenant-map", str(TENANT_MAP),
             "--global-limit", str(GLOBAL_LIMIT), "--tenant",
             "gold=20000:5:2000", "--tenant", "free=5000:1"]
    for name, limit, weight in CASC_OTHERS:
        flags += ["--tenant", f"{name}={limit}:{weight}"]
    flags += ["--assign", "api-cust-42=gold"]
    for i in range(TENANT_ASSIGNED):
        flags += ["--assign", f"u:{i}={named[i % len(named)]}"]
    return flags


def boot_tenants(lim) -> None:
    """``tenant_flags`` applied to a limiter, by the server binary's own
    code (serving/__main__.py ``boot_tenants``)."""
    from ratelimiter_tpu_torch.serving.__main__ import (
        boot_tenants as boot,
        parse_args,
    )

    boot(lim, parse_args(tenant_flags()))


def with_tenants(cfg):
    """``cfg`` under the documented tenant deployment's HierarchySpec."""
    import dataclasses

    from ratelimiter_tpu_torch import HierarchySpec

    return dataclasses.replace(cfg, hierarchy=HierarchySpec(
        tenants=TENANTS, map_capacity=TENANT_MAP,
        global_limit=GLOBAL_LIMIT))


TN_STATE = ("tn_cur", "tn_slabs", "tn_totals")
BUCKET_TN_STATE = ("tn_counts", "tn_period")


def check_tenant_path(torch, seed: int, label: str, base,
                      profile: bool = False) -> dict:
    """One tenant path (``base`` under ``with_tenants``, booted with
    ``tenant_flags``) end to end against the CPU on ``tenant_keys``
    traffic (for TB-c2, config 2's own traffic over the same key
    space: 64 batches at +0.25 s, across its 10 s window): every result
    and every state array, ``tn_*`` included, bit-identical; every step
    ran its back's cascade build (the back's build without the cascade
    never launched, and as many cascade builds as updates where the back
    feeds one: no plain version ran on the card). The same trace without
    the tenants runs too, for the steps/s beside it; with ``profile``,
    both are profiled on the trace's first 48 batches (no sort or scan op
    of the plain admission may run)."""
    from ratelimiter_tpu_torch.ops import bucket_cuda as bc
    from ratelimiter_tpu_torch.ops import sketch_cuda as sc

    rng = np.random.default_rng(seed)
    bucket = base.algorithm.name == "TOKEN_BUCKET"
    if bucket:
        batches, keys = _trace_c2(seed, TENANT_STEPS)
        advance, drive_kw = C2_ADVANCE, {}
        counters, state = [bc], BUCKET_STATE + BUCKET_TN_STATE
        required = ("bucket_estimate", "admit [cascade]", "bucket_update")
        back, update = "admit", "bucket_update"
    else:
        batches = [tenant_keys(rng, BATCH)
                   for _ in range(TENANT_STEPS + TENANT_AFTER)]
        keys = tenant_keys(rng, 256) + ["api-cust-42"] * 64
        advance = 0.1
        drive_kw = {"jump": (TENANT_STEPS,
                             TENANT_JUMP_S - TENANT_STEPS * advance)}
        counters, state = [sc], WINDOW_STATE + TN_STATE
        cu = base.sketch.conservative_update
        back, update = ("admit", "cu_update") if cu else ("add_back", None)
        required = ("window_estimate", f"{back} [cascade]") + (
            (update,) if cu else ())
        if base.sketch.hh_slots:
            state += HH_STATE
            required += ("hh_update [fused]",)
    out = check_path(torch, f"{label} tenants={TENANTS}",
                     with_tenants(base), batches, keys, advance, counters,
                     required, state, drive_kw=drive_kw, setup=boot_tenants)
    counts = out["counts"]
    if not bucket and base.sketch.hh_slots:
        hold_tails(f"{label} tenants", counts)
    if counts[back] or (update is not None and counts[f"{back} [cascade]"]
                        != counts[update]):
        raise AssertionError(f"{label} tenants: {counts[back]} {back} "
                             f"launches without the cascade, "
                             f"{counts[f'{back} [cascade]']} cascade builds "
                             f"for {counts.get(update)} {update} launches")
    g = out["hierarchy_stats"]["global"]
    plain = check_path(torch, f"{label} without tenants", base, batches,
                       keys, advance, counters,
                       tuple(k.replace(" [cascade]", "") for k in required),
                       state[:len(BUCKET_STATE if bucket
                                  else WINDOW_STATE)], drive_kw=drive_kw)
    out["without_tenants"] = {k: plain[k] for k in (
        "steps_per_s", "steps_per_s_min", "steps_per_s_max",
        "decisions_per_s", "denied")}
    if profile:
        out["profile"] = profile_path(
            torch, f"{label} tenants={TENANTS}", with_tenants(base),
            batches[:48], keys, advance, setup=boot_tenants)
        out["without_tenants"]["profile"] = profile_path(
            torch, f"{label} without tenants", base, batches[:48], keys,
            advance)
        if out["profile"]["sort_or_scan_ops"]:
            raise AssertionError(f"{label} tenants: the plain admission "
                                 f"still runs: "
                                 f"{out['profile']['sort_or_scan_ops']}")
    log(f"tenant path {label} on {card_line()}: global in-window "
        f"{g['in_window']} of {g['effective']} at the end; "
        f"{out['steps_per_s']:.1f} steps/s with the cascade (min "
        f"{out['steps_per_s_min']:.1f}, max {out['steps_per_s_max']:.1f}) "
        f"against {plain['steps_per_s']:.1f} without (min "
        f"{plain['steps_per_s_min']:.1f}, max "
        f"{plain['steps_per_s_max']:.1f}), median of {REPEATS}; denied "
        f"{out['denied']} against {plain['denied']}")
    return out


#: Substrings of the device kernels behind torch.sort, torch.cumsum and
#: torch.cummax (CUB's radix sort and scan, ATen's scan kernels).
SCAN_OPS = ("sort", "scan", "cummax", "cumsum")


def profile_path(torch, name: str, cfg, batches, keys, advance: float,
                 warm: int = 16, setup=None) -> dict:
    """Where a main-path step's time goes: ``torch.profiler`` over the
    batches after ``warm`` warm-up ones (``setup`` applied to the limiter
    first). Device busy share is the union of device-op intervals over
    the span from the first to the last; the profiler's own overhead
    lengthens the span, so the share is a lower bound on what an
    unprofiled run keeps the card busy."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch import ManualClock, create_limiter

    lim = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                         device="cuda")
    if setup is not None:
        setup(lim)
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
    time and the launching thread's CPU time. A ``now`` passed in (the
    decorators pass None) is replaced by its own. Anything else (the
    envelope and gauge reads of ``MetricsDecorator``, ``device``) is the
    limiter's (``__getattr__``)."""

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

    def launch_ids(self, ids, ns=None, *, now=None, wire: bool = False):
        with self._lock:
            now = self._now()
            ticket = self._timed(self.inner.launch_ids, ids, ns, now=now,
                                 wire=wire)
            self.log.append(("ids", np.array(ids), np.array(ns), now))
        return ticket

    def launch_batch(self, keys, ns=None, *, now=None):
        with self._lock:
            now = self._now()
            ticket = self._timed(self.inner.launch_batch, keys, ns, now=now)
            self.log.append(("keys", list(keys), list(ns), now))
        return ticket

    def launch_hashed(self, h64, ns=None, *, now=None):
        """The native door's launches: finalized hashes (both lanes)."""
        with self._lock:
            now = self._now()
            ticket = self._timed(self.inner.launch_hashed, h64, ns, now=now)
            self.log.append(("hashed", np.array(h64), np.array(ns), now))
        return ticket

    def reset(self, key: str) -> None:
        with self._lock:
            now = self._now()
            self.inner.reset(key)
            self.log.append(("reset", key, None, now))

    def resolve(self, ticket):
        return self.inner.resolve(ticket)

    def allow_ids(self, ids, ns=None, *, now=None):
        """Marks the raw-id lane (the batcher looks for it)."""
        return self.resolve(self.launch_ids(ids, ns))

    def __getattr__(self, name):
        return getattr(self.inner, name)


def door_keys(rng, space: str, n: int) -> list:
    if space == "tenants":
        return tenant_keys(rng, n)
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


def door_client() -> None:
    """The door's client, run in a child process (``serve_door``): its
    arguments come as JSON on stdin; ``conns`` connections pipeline
    ALLOW_HASHED and ALLOW_BATCH frames, then HEALTH and METRICS go on
    one more; everything it read goes pickled to stdout."""
    args = json.loads(sys.stdin.read())
    got = asyncio.run(_door_clients(**args))
    sys.stdout.buffer.write(pickle.dumps(got))
    sys.stdout.flush()


def child_env() -> tuple:
    """(the repo's root, an environment with it first on PYTHONPATH) for
    the child processes this script starts."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return repo, env


def _run_door_client(args: dict, timeout: float,
                     entry: str = "door_client") -> dict:
    """``door_client`` (or another ``entry`` of this script reading JSON
    arguments and writing a pickle) in a child process, run to its end
    (killed, and reaped, past ``timeout`` seconds); returns what it
    read."""
    repo, env = child_env()
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{entry}()"],
        cwd=repo, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(json.dumps(args).encode(),
                                    timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{entry} timed out")
    if proc.returncode != 0:
        raise AssertionError(f"{entry} exited with {proc.returncode}: "
                             f"{err.decode()[-2000:]}")
    return pickle.loads(out)


def replay_windows(cfg, log: list, setup=None):
    """Every recorded window (and reset) again, in order, on a CPU limiter
    of the port (``setup`` applied to it first) at the recorded ``now``s;
    returns the results (None for a reset) and the limiter."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    cpu = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                         device="cpu")
    if setup is not None:
        setup(cpu)
    outs = []
    for kind, a, ns, now in log:
        cpu.clock.set(now)
        if kind == "ids":
            outs.append(cpu.resolve(cpu.launch_ids(a, ns, now=now,
                                                   wire=True)))
        elif kind == "keys":
            outs.append(cpu.resolve(cpu.launch_batch(a, ns, now=now)))
        elif kind == "hashed":
            outs.append(cpu.resolve(cpu.launch_hashed(a, ns, now=now)))
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


def hold_consumer_gauges(name: str, text: str, stats: dict) -> dict:
    """The side table's gauges in a METRICS text read after the last
    decision: the tracked consumers and the rank 1-5 masses (0 past the
    list) equal to the served limiter's ``consumer_stats(k=5)`` then."""
    tracked = metric_value(
        text, 'rate_limiter_hh_tracked_consumers{shard="0",slice="0"}')
    top = [metric_value(text, f'rate_limiter_top_consumer_mass{{rank='
                              f'"{r}",shard="0",slice="0"}}')
           for r in range(1, 6)]
    want = [float(c["in_window"]) for c in stats["top"]]
    want += [0.0] * (5 - len(want))
    if tracked != stats["occupied"] or top != want:
        raise AssertionError(f"{name}: METRICS shows {tracked:g} tracked "
                             f"consumers and top masses {top}; the limiter "
                             f"{stats['occupied']} and {want}")
    return {"hh_tracked": int(tracked), "hh_top_mass": top}


def metric_value(text: str, sample: str) -> float:
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{sample} not in the METRICS text")


#: The binary's observability flags for the door runs: its default
#: stack (MetricsDecorator, the event journal), the full stack (every
#: decorator and the flight recorder) and the bare door (neither).
DEFAULT_STACK = ()
FULL_STACK = ("--trace", "--circuit-breaker", "--log-decisions",
              "--log-redact-keys", "--flight-recorder")
BARE_STACK = ("--no-metrics", "--no-event-journal")


class door_stack:
    """``with door_stack(flags) as (wrap, registry)``: what
    ``python -m ratelimiter_tpu_torch.serving`` sets up from its
    observability ``flags`` — the flight recorder and the event journal
    (``enable_observability``, both in a fresh registry, turned off
    again on exit) and ``wrap(limiter, shard=0)``, its decorator stack
    (``build_limiter_stack``, its gauges under the shard's label)
    registering there too."""

    def __init__(self, flags=DEFAULT_STACK):
        from ratelimiter_tpu_torch.serving.__main__ import parse_args

        self.args = parse_args(list(flags))

    def __enter__(self):
        from ratelimiter_tpu_torch.observability.metrics import Registry
        from ratelimiter_tpu_torch.serving.__main__ import (
            build_limiter_stack,
            enable_observability,
        )

        registry = Registry()
        enable_observability(self.args, registry)
        return (lambda lim, shard=0: build_limiter_stack(
                    lim, self.args, registry=registry, shard=shard),
                registry)

    def __exit__(self, *exc):
        from ratelimiter_tpu_torch.observability import events, tracing

        tracing.disable()
        events.disable()


def serve_door(limiter, *, seed: int, space: str, conns: int, frames: int,
               n_ids: int, n_keys: int, depth: int, counters=(),
               server_kw=None, flags=DEFAULT_STACK) -> dict:
    """The port's server over ``limiter`` wrapped as the binary wraps it
    under the observability ``flags`` (``door_stack``), with the
    micro-batcher at its defaults (``server_kw`` overrides them), driven
    by ``door_client`` in a child process; the launch counts of
    ``counters`` are set to 0 once the server listens. Returns what the
    client read, plus the server's CPU seconds and, with
    ``--flight-recorder``, the recorder's spans and their split by stage
    (``stage_split``; None without it)."""
    from ratelimiter_tpu_torch.observability import tracing
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    async def main(wrap, registry):
        srv = RateLimitServer(wrap(limiter), "127.0.0.1", 0,
                              registry=registry, **(server_kw or {}))
        await srv.start()
        for mod in counters:
            mod.reset_launch_counts()
        args = {"port": srv.port, "conns": conns, "frames": frames,
                "n_ids": n_ids, "n_keys": n_keys, "depth": depth,
                "space": space, "seed": seed}
        cpu = time.process_time()
        try:
            got = await asyncio.get_running_loop().run_in_executor(
                None, _run_door_client, args, 600.0)
            got["server_cpu_s"] = time.process_time() - cpu
            rec = tracing.get()
            got["spans"] = rec.dump() if rec is not None else []
            got["stages"] = (stage_split(got["spans"]) if rec is not None
                             else None)
            return got
        finally:
            await srv.shutdown()

    with door_stack(flags) as (wrap, registry):
        return asyncio.run(main(wrap, registry))


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
              depth: int = DOOR_DEPTH, flags=DEFAULT_STACK) -> dict:
    """The door as ``python -m ratelimiter_tpu_torch.serving`` runs it
    under the observability ``flags``: the server over a limiter on the
    card and the system clock, no recording proxy, driven by the same
    client as ``check_door``. Only timed; ``check_door`` holds the
    answers. With ``--flight-recorder`` the readings carry the
    recorder's per-stage split (``stages``)."""
    from ratelimiter_tpu_torch import create_limiter

    served = create_limiter(cfg, backend="sketch", device="cuda")
    try:
        got = serve_door(served, seed=seed, space=space, conns=conns,
                         frames=frames, n_ids=n_ids, n_keys=n_keys,
                         depth=depth, flags=flags)
    finally:
        served.close()
    out = _door_readings(f"door[{label}, unproxied]", got)
    out.update(stages=got["stages"], spans=got["spans"])
    log(f"door[{label}] unproxied on cuda {' '.join(flags)}: "
        f"{out['frames']} frames in "
        f"{out['dispatches']} dispatches ({out['frames_per_dispatch']:.2f} "
        f"frames a dispatch); {out['decisions_per_s']:.0f} decisions/s, "
        f"frame latency p50 {out['p50_ms']:.2f} ms p99 "
        f"{out['p99_ms']:.2f} ms over {out['wall_s']:.3f} s")
    return out


def hold_door_metrics(name: str, text: str, decisions: int,
                      flags) -> dict:
    """What the binary's stack under ``flags`` shows on the METRICS frame
    read after the last decision. With MetricsDecorator:
    ``rate_limiter_decisions_allowed_total`` + ``_denied_total`` and
    ``rate_limiter_requests_total`` (every label set) each equal to the
    decisions served. With the flight recorder: a non-zero
    ``rate_limiter_stage_seconds`` count for every stage of a frame."""
    def total(family: str) -> float:
        return sum(float(line.rsplit(" ", 1)[1])
                   for line in text.splitlines()
                   if line.startswith((family + "{", family + " ")))

    out = {}
    if "--no-metrics" not in flags:
        allowed = total("rate_limiter_decisions_allowed_total")
        denied = total("rate_limiter_decisions_denied_total")
        requests = total("rate_limiter_requests_total")
        if allowed + denied != decisions or requests != decisions:
            raise AssertionError(
                f"{name}: METRICS counts {allowed:g} allowed + {denied:g} "
                f"denied decisions and {requests:g} requests for "
                f"{decisions} decisions served")
        out.update(allowed=int(allowed), denied=int(denied))
    if "--flight-recorder" in flags:
        counts = {st: total(f'rate_limiter_stage_seconds_count{{stage='
                            f'"{st}"}}') for st in FRAME_STAGES}
        if not all(counts.values()):
            raise AssertionError(f"{name}: stage counts on METRICS {counts}")
        out["stage_counts"] = counts
    return out


#: The flight recorder's stages of one frame through the door.
FRAME_STAGES = ("io", "coalesce", "launch", "device", "resolve", "encode")


def check_door(torch, cfg, label: str, *, device: str = "cuda",
               seed: int = 0, space: str = "zipf", conns: int = DOOR_CONNS,
               frames: int = DOOR_FRAMES, n_ids: int = DOOR_IDS,
               n_keys: int = DOOR_KEYS, depth: int = DOOR_DEPTH,
               counters=(), required=(), same=None, front=None,
               front_per_reset: int = 0, server_kw=None, setup=None,
               flags=DEFAULT_STACK) -> dict:
    """The port's server over ``cfg`` (``serve_door``) through a
    ``RecordingLimiter`` under the binary's decorator stack for ``flags``
    (the default stack unless told). Every frame's answer must be
    bit-identical to a CPU replay of the windows the batcher launched,
    the final state to the replay's, HEALTH must count every decision,
    METRICS must show fewer dispatches than frames (one for each window
    launched) and what the stack counts (``hold_door_metrics``), and
    each kernel in ``required`` must have launched; ``same`` names two
    counts that must be equal (an admission launch for every update: no
    composed back), ``front`` a count that must equal the windows
    launched (every window went through that kernel) plus
    ``front_per_reset`` a reset (the bucket's reset reads its estimate
    with the front). Returns the door's
    readings, which include the proxy's own cost (a lock, a copy of each
    window's arrays, a clock set and two timer reads per launch);
    ``time_door`` times the door without it. ``setup`` (the binary's
    tenant flags, say) is applied to the served limiter and to the
    replay's before any frame."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    served = create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                            device=device)
    if setup is not None:
        setup(served)
    rec = RecordingLimiter(served, T0)
    got = serve_door(rec, seed=seed, space=space, conns=conns,
                     frames=frames, n_ids=n_ids, n_keys=n_keys, depth=depth,
                     counters=counters, server_kw=server_kw, flags=flags)
    if device == "cuda":
        torch.cuda.synchronize()
    counts = {}
    for mod in counters:
        counts.update(mod.launch_counts())
    _, served_arrays, _ = served.capture_state()
    stats = served.consumer_stats(k=5)
    served.close()
    name = f"door[{label}]"
    out = _door_readings(name, got)
    out.update(hold_door_metrics(name, got["metrics"], out["decisions"],
                                 flags))
    out["stages"] = got["stages"]
    if stats["slots"] and "--no-metrics" not in flags:
        out.update(hold_consumer_gauges(name, got["metrics"], stats))
    replayed, cpu = replay_windows(cfg, rec.log, setup)
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
    resets = sum(kind == "reset" for kind, *_ in rec.log)
    if front is not None and \
            counts[front] != windows + front_per_reset * resets:
        raise AssertionError(f"{name}: {counts[front]} {front} launches "
                             f"for {windows} windows and {resets} resets")

    def mean_ms(family: str) -> float:
        return 1e3 * (metric_value(got["metrics"], family + "_sum")
                      / metric_value(got["metrics"], family + "_count"))

    out.update({
        "counts": counts,
        "inversions": sum(o["inversions"] for o in got["conns"]),
        "resets": resets,
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
    holds_hh = check_live(torch, config3_hh(), "live config 3 hh",
                          batches, keys + [HOT_KEY] * 128, LIVE_PLAN, 0.1,
                          WINDOW_STATE + HH_STATE)
    holds_tb = check_live(torch, config2_bucket(), "live TB-c2", tb_batches,
                          tb_keys, LIVE_PLAN_TB, C2_ADVANCE, BUCKET_STATE)
    torch.cuda.synchronize()
    counts = {"windowed": sc.launch_counts(), "bucket": bc.launch_counts()}
    for k in ("window_estimate", "admit", "cu_update", "window_reset",
              "hh_update [fused]"):
        if counts["windowed"][k] == 0:
            raise AssertionError(f"live config 3: {k} was not launched")
    # The resets are window_reset launches and the side table's update
    # the backs' tail: no standalone add_update or hh_update.
    for k in ("add_update", "hh_update"):
        if counts["windowed"][k]:
            raise AssertionError(f"live config 3: {counts['windowed'][k]} "
                                 f"standalone {k} launches")
    for k in ("bucket_estimate", "admit", "bucket_update"):
        if counts["bucket"][k] == 0:
            raise AssertionError(f"live TB-c2: {k} was not launched")
    mig = migration_ms(torch)
    out = {"lock_hold_ms": holds, "lock_hold_ms_TB-c2": holds_tb,
           "lock_hold_ms_hh": holds_hh,
           "migration_device_ms": mig,
           "windowed": {"counts": counts["windowed"]},
           "bucket": {"counts": counts["bucket"]}}
    log(f"live updates on {card_line()}: config 3 window 60->45->120 s, "
        f"limit 100->50->200, "
        f"TB-c2 limit 20->10->40, each with 4 tickets in flight: every "
        f"decision and every slab after each update bit-equal to the CPU "
        f"run, and the same on config 3 with {HH_SLOTS} side-table slots "
        f"(hh_* included); lock held {holds} ms (TB-c2 {holds_tb}, side "
        f"table {holds_hh}); the migration "
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
        repo, env = child_env()
        # A session of its own, so that kill() reaches anything it starts.
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
             "--port", "0", *args], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
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
                addr = line.split(" on ")[1].split()[0]
                # A unix-socket door (--listen unix:PATH) has no port.
                self.listen = addr if addr.startswith("unix:") else None
                self.port = (None if self.listen
                             else int(addr.rsplit(":", 1)[1]))
                self.http = (int(line.rsplit(" http:", 1)[1])
                             if " http:" in line else None)
                return

    def _read(self):
        for line in self.proc.stdout:
            self.output.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def recovery_s(self) -> float:
        return float(self.recovered.rsplit(" in ", 1)[1].split()[0])

    def kill(self) -> None:
        """SIGKILL to the server's process group; reaps the server."""
        import os

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=60)

    def terminate(self) -> int:
        """SIGTERM to the server alone (a graceful stop); its exit code."""
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=120)


def check_no_children() -> None:
    """Fails if a process this script started still runs (or is not
    reaped): every child of this process, read from /proc."""
    import os

    me, left = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as fh:
                stat = fh.read()
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            left.append(f"{pid}: {cmd.strip() or stat.split()[1]}")
    if left:
        raise AssertionError(f"processes left running: {left}")


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

    geo = ["--algorithm", cfg.algorithm.value, "--sketch-depth",
           str(cfg.sketch.depth), "--sketch-width", str(cfg.sketch.width),
           "--sub-windows", str(cfg.sketch.sub_windows), "--device", device,
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


def tenant_storm(c) -> float:
    """The hot-tenant storm of ``check_tenant_durable_door`` (step 2)
    through ``c``, a ``DoorClient`` of the tenant binary with the
    controller: free's assigned keys ask for 75 each, then 450
    unassigned keys for 100 each; METRICS is read until free's effective
    limit moves (or 5 s pass). Returns free's effective limit then."""
    from ratelimiter_tpu_torch.serving import protocol as p

    free_keys = [f"u:{i}" for i in range(TENANT_ASSIGNED) if i % 15 == 1]
    c.call(p.encode_allow_batch, free_keys, [75] * len(free_keys))
    herd = [f"storm:{i}" for i in range(450)]
    c.call(p.encode_allow_batch, herd, [100] * len(herd))
    return free_effective_below(c, 5000)


def free_effective_below(c, limit: int, polls: int = 100) -> float:
    """Free's effective limit on METRICS, read through ``c`` every 50 ms
    until it falls below ``limit`` (or ``polls`` reads pass)."""
    from ratelimiter_tpu_torch.serving import protocol as p

    sample = 'rate_limiter_hier_effective_limit{scope="free"}'
    for _ in range(polls):
        _, body = c.call(lambda rid: p.encode_simple(p.T_METRICS, rid))
        text = p.parse_metrics(body)
        if sample in text and metric_value(text, sample) < limit:
            break
        time.sleep(0.05)
    return metric_value(text, sample)


def check_tenant_durable_door(cfg, *, device: str = "cuda",
                              seed: int = 0) -> dict:
    """Phase 5.4: the durable binary serving the documented tenant
    deployment (``tenant_flags``) with the AIMD controller, killed and
    recovered, against a CPU twin's recovery of the same directory.

    1. The server starts on an empty directory with ``cfg``'s geometry,
       the tenant flags and ``--controller --controller-interval 0.2``.
    2. A hot-tenant storm: free's assigned keys ask for 75 each (free
       admits up to its 5,000), then 450 unassigned keys ask for 100 each,
       so that the global scope is saturated (>= 90% of 50,000) and free
       holds more than twice its fair share (weight 1 of 34): the
       controller must tighten free's effective limit (5,000 -> 3,500),
       which METRICS shows; then a SNAPSHOT, and SIGKILL.
    3. The server restarts on a copy of the directory with the same flags
       and no controller, and takes a SNAPSHOT: every array of it
       (``tn_*`` and the ``hier_*`` columns with the moved limit
       included) must be bit-equal to the CPU twin's recovery of the
       copy, booted with the same flags after it (the binary's order: the
       flags do not undo a lower effective limit).
    4. Frames one at a time (free's keys, gold's, unassigned ones):
       decisions bit-equal to the twin's; SIGTERM."""
    import os
    import shutil
    import tempfile

    from ratelimiter_tpu_torch import (
        ManualClock,
        PersistenceSpec,
        create_limiter,
    )
    from ratelimiter_tpu_torch.observability.metrics import Registry
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk
    from ratelimiter_tpu_torch.persistence import PersistenceManager
    from ratelimiter_tpu_torch.serving import protocol as p

    cfg = with_tenants(cfg)
    root = tempfile.mkdtemp(prefix="tenant-door-")
    d, copy = os.path.join(root, "live"), os.path.join(root, "copy")
    flags = ["--algorithm", cfg.algorithm.value, "--limit", str(cfg.limit),
             "--window", str(cfg.window),
             "--sketch-depth", str(cfg.sketch.depth), "--sketch-width",
             str(cfg.sketch.width), "--sub-windows",
             str(cfg.sketch.sub_windows), "--device", device,
             "--snapshot-dir", d, "--snapshot-interval", "3600",
             *tenant_flags()]
    free_keys = [f"u:{i}" for i in range(TENANT_ASSIGNED) if i % 15 == 1]
    servers = []
    rng = np.random.default_rng(seed + 53)
    try:
        srv = ServerProcess(flags + ["--controller", "--controller-interval",
                                     "0.2"])
        servers.append(srv)
        c = DoorClient(srv.port)
        t_first = time.time()
        moved = tenant_storm(c)
        if moved != 3500:
            raise AssertionError(f"the controller moved free to {moved}, "
                                 f"not 3500")
        _, _, arrays, meta, mb = _snapshot_file(c, d)
        eff = dict(zip(arrays["hier_tenant_names"].tolist(),
                       arrays["hier_tenant_eff"].tolist()))
        if eff["free"] != 3500:
            raise AssertionError(f"the snapshot holds free at {eff['free']}")
        c.close()
        srv.kill()
        shutil.copytree(d, copy)

        srv = ServerProcess(flags)
        servers.append(srv)
        c = DoorClient(srv.port)
        _, _, arrays, meta, _ = _snapshot_file(c, d)
        spec = PersistenceSpec(dir=copy, snapshot_interval=3600.0)
        mgr = PersistenceManager(spec, registry=Registry())
        sub_us = sk.sketch_geometry(cfg)[1]
        twin = mgr.wrap(create_limiter(cfg, clock=ManualClock(
            (int(meta["host_period"]) * sub_us + sub_us // 2) / 1e6),
            device="cpu"))
        mgr.attach([twin])
        report = mgr.recover()
        boot_tenants(twin)
        _, twin_arrays, twin_extra = twin.capture_state()
        if sorted(twin_arrays) != sorted(arrays):
            raise AssertionError("recovered array sets differ")
        for k, v in twin_arrays.items():
            if v.dtype != arrays[k].dtype or not np.array_equal(v,
                                                                arrays[k]):
                raise AssertionError(f"recovered {k} differs from the CPU "
                                     f"twin's recovery")
        if twin.effective_limits()["free"] != 3500:
            raise AssertionError("the twin lost free's moved limit")
        frames = [("keys", free_keys[:32]),
                  ("keys", [f"u:{i}" for i in range(0, 64, 15)] * 4),
                  ("keys", [f"storm:{i}" for i in range(64)]),
                  ("ids", zipf_ids(rng, 256))]
        for i, frame in enumerate(frames):
            got, bracket = _send(c, frame)
            want = (twin.allow_ids(frame[1]) if frame[0] == "ids"
                    else twin.allow_batch(frame[1]))
            _hold_against_twin(f"tenant door frame {i}", got, bracket, want,
                               cfg.window)
        if time.time() - t_first > 0.8 * cfg.window:
            raise AssertionError("the run outlasted the window the "
                                 "comparison relies on")
        c.close()
        if srv.terminate() != 0:
            raise AssertionError("SIGTERM: the server did not exit cleanly")
        mgr.stop(final_snapshot=False)
        twin.close()
        out = {"free_effective": int(moved), "recovery_s": srv.recovery_s(),
               "recovered": srv.recovered, "twin": report.summary(),
               "snapshot_mb": mb}
    finally:
        for srv in servers:
            srv.kill()
        shutil.rmtree(root, ignore_errors=True)
    where = card_line() if device == "cuda" else "the CPU"
    log(f"tenant durable door on {where}: the controller tightened free "
        f"5000 -> {out['free_effective']} under the storm; SIGKILL after "
        f"SNAPSHOT; restart recovered in {out['recovery_s']:.3f} s "
        f"({out['recovered']}), every array (tn_*, hier_*) bit-equal to "
        f"the CPU twin's recovery, decisions after it too")
    return out


# ------------------------------------------ the dense and exact backends

#: The dense step's builds and the JAX steps they replace (jitted jnp, no
#: Pallas kernel; ratelimiter_tpu/ops/dense_kernels.py).
DENSE_BUILDS = {"FIXED_WINDOW": ("fixed_window", 124),
                "SLIDING_WINDOW": ("sliding_window", 153),
                "TOKEN_BUCKET": ("token_bucket", 189)}
for _algo, (_build_name, _line) in DENSE_BUILDS.items():
    # The step (phase A across the card, then the admission block) and its
    # first launch alone replace the same JAX step.
    for _kernel in ("dense_step", "dense_front"):
        KERNEL_ROWS[f"{_kernel} [{_build_name}]"] = (
            f"ratelimiter_tpu/ops/dense_kernels.py:{_line}")
DENSE_SOURCE = "ratelimiter_tpu_torch/csrc/dense_kernels.cu"
#: The dense state's capacity on the card: 2^20 slots (config 3's 1M
#: keys), 8 MB a column.
DENSE_CAPACITY = 1 << 20


def dense_config(algorithm: str, limit: int = LIMIT,
                 capacity: int = DENSE_CAPACITY):
    """Config 3's limit and window under a dense algorithm."""
    from ratelimiter_tpu_torch import Algorithm, Config, DenseParams

    return Config(algorithm=getattr(Algorithm, algorithm), limit=limit,
                  window=WINDOW_S, dense=DenseParams(capacity=capacity))


def dense_state(torch, rng, algorithm: str, now_us: int, capacity: int):
    """A lived-in dense state on the card: counts up to 1.2x the limit
    (some above it, so ``free_scaled`` goes negative), window starts in
    the current window, the one before and far back; buckets at random
    levels, remainders and refill times."""
    from ratelimiter_tpu_torch import Algorithm
    from ratelimiter_tpu_torch.ops import dense_kernels

    W = int(WINDOW_S * 1e6)
    n = capacity + 1
    cur = (now_us // W) * W
    cols = dense_kernels.COLUMNS[getattr(Algorithm, algorithm)]
    if algorithm == "TOKEN_BUCKET":
        _, _, den = dense_kernels._check_gates(dense_config(algorithm))
        vals = [rng.integers(0, LIMIT * 10 ** 6 + 1, n),
                rng.integers(0, den, n),
                now_us - rng.integers(0, 2 * W, n)]
    else:
        starts = rng.choice(np.array([cur, cur - W, 0], np.int64), n)
        vals = [rng.integers(0, int(LIMIT * 1.2), n)]
        if algorithm == "SLIDING_WINDOW":
            vals.append(rng.integers(0, int(LIMIT * 1.2), n))
        vals.append(starts)
    return {c: torch.from_numpy(np.asarray(v, np.int64)).to("cuda")
            for c, v in zip(cols, vals)}


def dense_policy(torch, rng, slots: np.ndarray, limit: int, W: int,
                 rows: int = 1024):
    """A 1024-row override table over some of the batch's slots (their
    search key is splitmix64 of the slot), limits and windows varied,
    every row gated as the policy table gates it. Returns (table on the
    card, the search key of every slot 0..C as a function)."""
    from ratelimiter_tpu_torch.ops import dense_kernels
    from ratelimiter_tpu_torch.ops.hashing import splitmix64
    from ratelimiter_tpu_torch.ops.policy_kernels import PAD_KEY

    def keyq(s):
        return splitmix64(np.asarray(s, np.uint64)).view(np.int64)

    chosen = np.unique(slots)[:rows]
    keys = np.sort(keyq(chosen))
    cols = {"key": np.full(rows, PAD_KEY, np.int64)}
    num0, den0 = dense_kernels.check_gate_values(limit, W)
    cols.update(limit=np.full(rows, limit, np.int64),
                window_us=np.full(rows, W, np.int64),
                rate_num=np.full(rows, num0, np.int64),
                rate_den=np.full(rows, den0, np.int64))
    for i, k in enumerate(keys):
        lim = int(rng.integers(1, 3 * limit))
        w = int(W * rng.choice([0.25, 0.5, 1.0, 2.0]))
        num, den = dense_kernels.check_gate_values(lim, w)
        cols["key"][i] = k
        cols["limit"][i], cols["window_us"][i] = lim, w
        cols["rate_num"][i], cols["rate_den"][i] = num, den
    return {k: torch.from_numpy(v).to("cuda") for k, v in cols.items()}, keyq


def dense_batches(rng, capacity: int) -> dict:
    """The dense step's batches: config 3's (4096 Zipf(1.1) ids over 1M
    keys, as slots), all 4096 on one slot, B = 0, B = ADMIT_CAPACITY and
    the next pad above it (composed on the card). n is 1 with some 2s and
    3s; a tenth of each batch is padding (slot C, n = 0)."""
    def batch(B, slots=None):
        sid = (zipf_ids(rng, B).astype(np.int64) % capacity
               if slots is None else np.full(B, slots, np.int64))
        n = rng.choice(np.array([1, 1, 1, 2, 3], np.int64), B)
        pad = rng.random(B) < 0.1
        sid[pad], n[pad] = capacity, 0
        return sid.astype(np.int32), n
    return {"config-3 Zipf": batch(BATCH), "one slot": batch(BATCH, 7),
            "B=0": batch(0), f"B={ADMIT}": batch(ADMIT),
            f"B={2 * ADMIT} (composed)": batch(2 * ADMIT)}


ADMIT = 8192


def dense_bytes(sid: np.ndarray, policy, columns: int, bucket: bool) -> int:
    """Bytes the step must move: sid, n (and the search key with a table)
    read; each touched slot's row read and written; allowed, remaining,
    retry and reset written; the table's columns that the build reads
    (key, limit and window_us; rate_num and rate_den in the token bucket
    alone) read once."""
    B = sid.shape[0]
    touched = np.unique(sid).shape[0]
    nbytes = B * (4 + 8 + (8 if policy is not None else 0) + 1 + 3 * 8)
    nbytes += 2 * touched * columns * 8
    if policy is not None:
        read = ("key", "limit", "window_us") + (
            ("rate_num", "rate_den") if bucket else ())
        nbytes += sum(policy[c].numel() * 8 for c in read)
    return nbytes


def dense_front_bytes(sid: np.ndarray, policy, columns: int, bucket: bool,
                      rows: int) -> int:
    """Bytes phase A must move: sid, n (and the search key) read, each
    touched slot's row read once, the table's columns that the build reads
    read once, and its ``rows`` scratch rows written."""
    B = sid.shape[0]
    nbytes = B * (4 + 8 + (8 if policy is not None else 0) + rows * 8)
    nbytes += np.unique(sid).shape[0] * columns * 8
    if policy is not None:
        read = ("key", "limit", "window_us") + (
            ("rate_num", "rate_den") if bucket else ())
        nbytes += sum(policy[c].numel() * 8 for c in read)
    return nbytes


_DENSE_BENCH: list = []


def dense_bench(mode: int, state: dict, sid, n, now_us: int, policy, keyq,
                scratch, outs: tuple, *, algorithm, limit: int,
                window_us: int, rate_num: int, rate_den: int,
                iters: int) -> None:
    """One launch of ``csrc/dense_bench.cu`` (no path of the limiter calls
    it): mode 0 phase A on one block (the step's previous design's), 1 the
    admission alone over ``scratch`` (writing ``outs[0]`` allowed and
    ``outs[4]`` seen). ``outs`` = (allowed, remaining, retry_us, reset_us,
    seen)."""
    import ctypes

    from ratelimiter_tpu_torch.ops import _build, dense_cuda

    if not _DENSE_BENCH:
        lib = ctypes.CDLL(_build.compile_source("dense_bench"))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rl_dense_bench.argtypes = [I, P, P, P, P, P, P, P, P, P, P, P, I,
                                       L, L, L, L, L, P, P, P, P, P, P, I, I,
                                       I, P]
        lib.rl_dense_bench.restype = I
        _DENSE_BENCH.append(lib)
    B = sid.shape[0]
    s0, s1, s2 = dense_cuda._state_ptrs(state, algorithm)
    err = _DENSE_BENCH[0].rl_dense_bench(
        mode, s0, s1, s2, sid.data_ptr(), n.data_ptr(),
        *dense_cuda._policy_args(policy, keyq), limit, window_us, rate_num,
        rate_den, now_us, scratch.data_ptr(), *(o.data_ptr() for o in outs),
        B, iters, dense_cuda.ALGO[algorithm], dense_cuda._stream(sid))
    if err:
        raise RuntimeError(f"dense_bench mode {mode}: CUDA error {err}")


def dense_back(state: dict, sid, scratch, now_us: int, outs: tuple, *,
               algorithm, iters: int, **_) -> None:
    """The step's second launch alone (``rl_dense_back``: admission and
    epilogue over a scratch phase A wrote), into ``outs``."""
    from ratelimiter_tpu_torch.ops import dense_cuda

    s0, s1, s2 = dense_cuda._state_ptrs(state, algorithm)
    err = dense_cuda._lib().rl_dense_back(
        s0, s1, s2, sid.data_ptr(), now_us, scratch.data_ptr(),
        *(o.data_ptr() for o in outs[:4]), sid.shape[0], iters,
        dense_cuda.ALGO[algorithm], dense_cuda._stream(sid))
    if err:
        raise RuntimeError(f"rl_dense_back: CUDA error {err}")


def dense_split(torch, state: dict, args: list, params: dict, err: dict,
                name: str) -> dict:
    """Where the step's time goes at one batch (ROADMAP B11): its two
    launches alone (phase A across the card; the admission and epilogue
    block), the admission alone and the previous design's one-block
    phase A (csrc/dense_bench.cu), the epilogue as the second launch less
    the admission. The bench's outputs are held to the plain versions
    first."""
    from ratelimiter_tpu_torch.ops import dense_cuda, dense_kernels
    from ratelimiter_tpu_torch.ops.segment import admit

    sid, n, now_us = args[0], args[1], args[2]
    policy, keyq = (args[3], args[4]) if len(args) > 3 else (None, None)
    B = sid.shape[0]
    algorithm = params["algorithm"]
    used = list(dense_kernels.USED_ROWS[algorithm])
    outs = (torch.empty(B, dtype=torch.bool, device="cuda"),
            *torch.empty((4, B), dtype=torch.int64, device="cuda").unbind())
    scratch = torch.empty((len(dense_kernels.SCRATCH_ROWS), B),
                          dtype=torch.int64, device="cuda")
    want_x = dense_kernels.dense_front_plain(state, sid, n, now_us, policy,
                                             keyq, **params)
    dense_bench(0, state, sid, n, now_us, policy, keyq, scratch, outs,
                **params)
    hold_equal(torch, err, name, scratch[used], want_x[used])
    dense_bench(1, state, sid, n, now_us, policy, keyq, scratch, outs,
                **params)
    allowed, seen, _ = admit(sid, want_x[0], want_x[1], params["iters"])
    hold_equal(torch, err, name, outs[0], allowed)
    hold_equal(torch, err, name, outs[4], seen)
    x = dense_cuda.dense_front(state, *args, **params)
    st = {k: v.clone() for k, v in state.items()}
    split = {
        "phase_a_ms": device_ms(
            lambda: dense_cuda.dense_front(state, *args, **params), torch),
        "phase_a_one_block_ms": device_ms(
            lambda: dense_bench(0, state, sid, n, now_us, policy, keyq,
                                scratch, outs, **params), torch),
        "admission_ms": device_ms(
            lambda: dense_bench(1, state, sid, n, now_us, policy, keyq, x,
                                outs, **params), torch),
        "back_ms": device_ms(
            lambda: dense_back(st, sid, x, now_us, outs, **params), torch),
    }
    split["epilogue_ms"] = split["back_ms"] - split["admission_ms"]
    log(f"split {name} (B={B}): phase A {split['phase_a_ms'] * 1e3:.2f} us "
        f"across the card ({split['phase_a_one_block_ms'] * 1e3:.2f} us on "
        f"one block), admission {split['admission_ms'] * 1e3:.2f} us, "
        f"epilogue {split['epilogue_ms'] * 1e3:.2f} us")
    return split


def dense_ptxas() -> dict:
    """``ptxas -v``'s report of the dense step's kernels: for each kernel
    (``dense_front``, ``dense_back`` by block shape) the registers and
    the stack frame, the largest over its builds."""
    import re

    from ratelimiter_tpu_torch.ops import _build

    out: dict = {}
    for mangled, props in _build.ptxas_report("dense_kernels").items():
        m = re.search(r"(dense_front|dense_back)_kernel", mangled)
        if not m:
            continue
        shape = re.search(r"ShapeILi(\d+)ELi(\d+)E", mangled)
        key = m.group(1) + (f" {shape.group(1)}x{shape.group(2)}"
                            if shape else "")
        now = out.setdefault(key, {"registers": 0, "stack_frame": 0})
        for f in now:
            now[f] = max(now[f], props.get(f, 0))
    log("ptxas (dense): " + ", ".join(
        f"{k} {v['registers']} registers, {v['stack_frame']} B stack"
        for k, v in sorted(out.items())))
    return out


def check_dense_kernel(torch, seed: int) -> dict:
    """Phase 2, the dense step: each build (fixed, sliding, token bucket)
    held bit-equal to its plain version on the card (every output and the
    whole 2^20-slot state) on each of ``dense_batches``, with and without
    a 1024-row override table (staged in shared memory), and after a
    limit decrease (the plain windowed state's ``free_scaled`` negative),
    its phase A alone (``dense_front``) against ``dense_front_plain`` on
    the rows it writes; the config-3 batch also with an 8192-row table
    (searched in global memory); the next pad above ADMIT_CAPACITY run
    composed (the plain step on the card: the launch counts must show no
    launch and one composed step); then per build a ``dense_step`` row
    (both launches) and a ``dense_front`` row on the config-3 batch with
    the 1024-row table (the main path's form), and the step's split
    (``dense_split``)."""
    from ratelimiter_tpu_torch.core.clock import to_micros
    from ratelimiter_tpu_torch.ops import dense_cuda, dense_kernels

    def on_card(a):
        return torch.from_numpy(a).to("cuda")

    rows = {}
    ptxas = dense_ptxas()
    now_us = int(T0 * 1e6) + 123_457
    W = to_micros(WINDOW_S)
    for algorithm, (build_name, _) in DENSE_BUILDS.items():
        name = f"dense_step [{build_name}]"
        front_name = f"dense_front [{build_name}]"
        rng = np.random.default_rng(seed + 101 + len(rows))
        err = {name: 0.0, front_name: 0.0}
        batches = dense_batches(rng, DENSE_CAPACITY)
        zipf_sid = batches["config-3 Zipf"][0]
        real = zipf_sid[zipf_sid < DENSE_CAPACITY]
        policy, keyq_of = dense_policy(torch, rng, real, LIMIT, W)
        wide, _ = dense_policy(torch, rng, real, LIMIT, W, rows=8192)
        base = dense_state(torch, rng, algorithm, now_us, DENSE_CAPACITY)
        used = None
        checked = 0
        for limit in (LIMIT, 7):
            params = dense_kernels.step_params(dense_config(algorithm,
                                                            limit))
            used = list(dense_kernels.USED_ROWS[params["algorithm"]])
            for label, (sid, n) in batches.items():
                tables = [None, policy] + (
                    [wide] if label == "config-3 Zipf" else [])
                for pol in tables:
                    args = [on_card(sid), on_card(n), now_us]
                    if pol is not None:
                        args += [pol, on_card(keyq_of(sid))]
                    kst = {k: v.clone() for k, v in base.items()}
                    pst = {k: v.clone() for k, v in base.items()}
                    composed = sid.shape[0] > ADMIT
                    if not composed:
                        hold_equal(torch, err, front_name,
                                   dense_cuda.dense_front(
                                       kst, *args, **params)[used],
                                   dense_kernels.dense_front_plain(
                                       pst, *args, **params)[used])
                    dense_cuda.reset_launch_counts()
                    got = dense_cuda.dense_step(kst, *args, **params)
                    counts = dense_cuda.launch_counts()
                    want = dense_cuda.dense_step_plain(pst, *args, **params)
                    for a, b in zip(got, want):
                        hold_equal(torch, err, name, a, b)
                    for k in kst:
                        hold_equal(torch, err, name, kst[k], pst[k])
                    hold_counts(f"{name} on {label}", counts, {
                        "dense_step [composed]": 1} if composed else {
                        "dense_front": 1, front_name: 1, "dense_step": 1,
                        name: 1})
                    checked += 1
        sid, n = batches["config-3 Zipf"]
        params = dense_kernels.step_params(dense_config(algorithm))
        args = [on_card(sid), on_card(n), now_us, policy,
                on_card(keyq_of(sid))]
        kst = {k: v.clone() for k, v in base.items()}
        pst = {k: v.clone() for k, v in base.items()}
        split = dense_split(torch, {k: v.clone() for k, v in base.items()},
                            args, params, err, name)
        bucket = algorithm == "TOKEN_BUCKET"
        row = kernel_row(
            name, DENSE_SOURCE, err[name],
            lambda: dense_cuda.dense_step(kst, *args, **params),
            lambda: dense_cuda.dense_step_plain(pst, *args, **params), None,
            dense_bytes(sid, policy, len(base), bucket), 0, torch)
        row.update(checked_batches=checked, split=split, ptxas=ptxas)
        rows[name] = row
        rows[front_name] = kernel_row(
            front_name, DENSE_SOURCE, err[front_name],
            lambda: dense_cuda.dense_front(kst, *args, **params),
            lambda: dense_kernels.dense_front_plain(pst, *args, **params),
            None, dense_front_bytes(sid, policy, len(base), bucket,
                                    len(used)), 0, torch,
            ms=split["phase_a_ms"])
        log(f"{name}: bit-equal to its plain version on {checked} batches "
            f"(config-3 Zipf, one slot, B=0, B={ADMIT}; with and without "
            f"the 1024-row table, the config-3 batch with an 8192-row one; "
            f"limits {LIMIT} and 7) over a {DENSE_CAPACITY}-slot state, "
            f"phase A alone too; B={2 * ADMIT} composed on the card")
    return rows


#: One request more than a launch of the card's admission takes.
C8_BATCH = ADMIT + 1


def check_above_capacity(torch, seed: int) -> dict:
    """C8: a batch of ADMIT_CAPACITY + 1 requests, which the JAX package
    decides, is decided on the card too, composed (by size alone): for
    each dense algorithm (``create_limiter(cfg, "dense")``, config 3's
    limit and window over 2^20 slots, string keys Zipf(1.1) over 5,000 so
    that slots contend; the plain step on the card: one composed step, no
    launch) and for the tenant deployment on the windowed CU sketch, on
    it with the side table (256 slots), on the windowed vanilla sketch and
    on TB-c2 (the front and the standalone update launched, no admission
    launch: the plain admission and cascade on the card; with the side
    table the standalone ``hh_update`` after them, no tail; on the
    vanilla sketch the standalone ``add_update``). Each result and the
    state equal to a CPU replay of the same batch."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.ops import bucket_cuda, dense_cuda, sketch_cuda

    rng = np.random.default_rng(seed + 97)
    out = {}
    keys = [f"user:{int(i)}" for i in (rng.zipf(ZIPF_A, size=C8_BATCH) - 1)
            % 5000]
    for algorithm, (build_name, _) in DENSE_BUILDS.items():
        cfg = dense_config(algorithm)
        lims = {d: create_limiter(cfg, "dense", clock=ManualClock(T0),
                                  device=d) for d in ("cuda", "cpu")}
        torch.cuda.synchronize()
        dense_cuda.reset_launch_counts()
        got = lims["cuda"].allow_batch(keys)
        counts = hold_counts(f"dense {build_name} batch of {C8_BATCH}",
                             dense_cuda.launch_counts(),
                             {"dense_step [composed]": 1})
        want = lims["cpu"].allow_batch(keys)
        _same_results(f"dense {build_name} batch of {C8_BATCH}", [got],
                      [want])
        states = [lim.capture_state()[1] for lim in lims.values()]
        for k in states[1]:
            if not np.array_equal(states[0][k], states[1][k]):
                raise AssertionError(f"dense {build_name} batch of "
                                     f"{C8_BATCH}: state {k} differs")
        for lim in lims.values():
            lim.close()
        out[f"dense {build_name}"] = {"counts": counts,
                                      "allowed": int(got.allowed.sum())}
    tkeys = tenant_keys(rng, C8_BATCH)
    for label, cfg, module, want_counts, state in (
            ("windowed CU", config3(), sketch_cuda,
             {"window_estimate": 1, "cu_update": 1}, WINDOW_STATE + TN_STATE),
            (f"windowed CU hh_slots={HH_SLOTS}", config3_hh(), sketch_cuda,
             {"window_estimate": 1, "cu_update": 1, "hh_update": 1},
             WINDOW_STATE + TN_STATE + HH_STATE),
            ("windowed vanilla", config3(cu=False), sketch_cuda,
             {"window_estimate": 1, "add_update": 1},
             WINDOW_STATE + TN_STATE),
            ("TB-c2", config2_bucket(), bucket_cuda,
             {"bucket_estimate": 1, "bucket_update": 1},
             BUCKET_STATE + BUCKET_TN_STATE)):
        lims = {d: create_limiter(with_tenants(cfg), clock=ManualClock(T0),
                                  device=d) for d in ("cuda", "cpu")}
        for lim in lims.values():
            boot_tenants(lim)
        torch.cuda.synchronize()
        module.reset_launch_counts()
        got = lims["cuda"].allow_batch(tkeys)
        torch.cuda.synchronize()
        counts = hold_counts(f"tenants {label} batch of {C8_BATCH}",
                             module.launch_counts(), want_counts)
        want = lims["cpu"].allow_batch(tkeys)
        _same_results(f"tenants {label} batch of {C8_BATCH}", [got], [want])
        _same_state(f"tenants {label} batch of {C8_BATCH}", lims["cuda"],
                    lims["cpu"], state)
        if lims["cuda"].hierarchy_stats() != lims["cpu"].hierarchy_stats():
            raise AssertionError(f"tenants {label}: hierarchy stats differ")
        for lim in lims.values():
            lim.close()
        out[f"tenants {label}"] = {"counts": counts,
                                   "allowed": int(got.allowed.sum()),
                                   "denied": int((~got.allowed).sum())}
    log(f"C8: batches of {C8_BATCH} served composed on the card, equal to "
        f"the CPU: {out}")
    return out


def dense_trace(seed: int, steps: int) -> list:
    """Config-3 traffic as string keys: per step 4096 keys ``user:{id}``,
    ids Zipf(1.1) over 1M keys."""
    rng = np.random.default_rng(seed)
    return [[f"user:{int(i)}" for i in zipf_ids(rng, BATCH)]
            for _ in range(steps)]


#: The dense paths' operations, by step: an override, a reset, a limit
#: update and a window update; +2.5 s of virtual time a step, so 48 steps
#: cross two 60 s windows.
DENSE_PLAN = {3: ("set_override", ("user:1", 300)), 12: ("reset",
                                                          ("user:2",)),
              20: ("update_limit", (60,)), 30: ("update_window", (45.0,))}
DENSE_ADVANCE = 2.5


def drive_plan(lim, batches, plan: dict, advance: float) -> list:
    """The trace through ``allow_batch`` with ``plan``'s operations before
    their steps; returns the BatchResults."""
    out = []
    for step, keys in enumerate(batches):
        if step in plan:
            op, args = plan[step]
            getattr(lim, op)(*args)
        out.append(lim.allow_batch(keys))
        lim.clock.advance(advance)
    return out


def check_dense_paths(torch, seed: int, steps: int,
                      strict: bool = True) -> dict:
    """Phase 3, the dense and exact backends: ``create_limiter(cfg,
    "dense", device="cuda")`` for each algorithm, on config-3 string
    traffic with a 2^20-slot state across window rolls, with
    ``DENSE_PLAN``'s override, reset, ``update_limit`` and
    ``update_window``; every result and the final state bit-identical to
    the same trace on the CPU, one ``dense_front`` and one ``dense_step``
    launch (of the algorithm's build) per batch (``strict=False``: the
    ``dense_front`` ones only where the checkout counts them, as an
    earlier one does not);
    steps/s the median of 5 runs; the exact backend's results on the same
    trace equal to dense's."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.ops import dense_cuda

    batches = dense_trace(seed, steps)
    out = {}
    for algorithm, (build_name, _) in DENSE_BUILDS.items():
        cfg = dense_config(algorithm)
        name = f"dense {build_name}"

        def make(backend, device="cuda"):
            kw = {} if backend == "exact" else {"device": device}
            return create_limiter(cfg, backend=backend,
                                  clock=ManualClock(T0), **kw)

        warm = make("dense")
        drive_plan(warm, batches[:4], {}, DENSE_ADVANCE)
        warm.close()
        torch.cuda.synchronize()
        dense_cuda.reset_launch_counts()
        gpu = make("dense")
        t = time.perf_counter()
        got = drive_plan(gpu, batches, DENSE_PLAN, DENSE_ADVANCE)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t]
        counts = dense_cuda.launch_counts()
        want_counts = {f"dense_step [{build_name}]": len(batches),
                       "dense_step": len(batches)}
        if strict or "dense_front" in counts:
            want_counts.update({f"dense_front [{build_name}]": len(batches),
                                "dense_front": len(batches)})
        hold_counts(f"{name}: {len(batches)} batches", counts, want_counts)
        _, ga, _ = gpu.capture_state()
        gpu.close()
        cpu = make("dense", "cpu")
        want = drive_plan(cpu, batches, DENSE_PLAN, DENSE_ADVANCE)
        _, ca, _ = cpu.capture_state()
        cpu.close()
        _same_results(name, got, want)
        for k in ca:
            if ga[k].dtype != ca[k].dtype or not np.array_equal(ga[k], ca[k]):
                raise AssertionError(f"{name}: state {k} differs from the "
                                     f"CPU run")
        exact = make("exact")
        _same_results(f"exact {build_name} against dense",
                      drive_plan(exact, batches, DENSE_PLAN, DENSE_ADVANCE),
                      want)
        exact.close()
        for _ in range(REPEATS - 1):
            again = make("dense")
            torch.cuda.synchronize()
            t = time.perf_counter()
            drive_plan(again, batches, DENSE_PLAN, DENSE_ADVANCE)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            again.close()
        rates = sorted(len(batches) / w for w in walls)
        denied = sum(int((~r.allowed).sum()) for r in got)
        out[build_name] = {
            "counts": counts, "steps_per_s": statistics.median(rates),
            "steps_per_s_min": rates[0], "steps_per_s_max": rates[-1],
            "decisions_per_s": statistics.median(rates) * BATCH,
            "batches": len(batches), "denied": denied,
            "keys": int(ga["slot_ids"].shape[0])}
        log(f"main path {name}: {len(batches)} batches of {BATCH} string "
            f"keys, {denied} denied, {out[build_name]['keys']} slots live, "
            f"bit-identical to the CPU run (results and state), exact "
            f"backend equal; launches {counts}; "
            f"{out[build_name]['steps_per_s']:.1f} steps/s median of "
            f"{REPEATS} runs (min {rates[0]:.1f}, max {rates[-1]:.1f})")
    return out


class KeyRecorder:
    """A proxy over a dense or exact limiter behind the door: each string
    window and reset is logged with its ``now`` (set on the limiter's
    ManualClock from the wall clock's progress) in the order it reaches
    the limiter. It has no raw-id lane of its own: the batcher sees the
    limiter's (``__getattr__``)."""

    def __init__(self, inner, t0: float):
        self.inner = inner
        self.config = inner.config
        self.clock = inner.clock
        self.pipelined = inner.pipelined
        self.log: list = []
        self._t0 = t0
        self._start = time.perf_counter()
        self._lock = threading.Lock()

    def _now(self) -> float:
        now = self._t0 + (time.perf_counter() - self._start)
        self.clock.set(now)
        return now

    def allow_batch(self, keys, ns=None, *, now=None):
        """The batcher's blocking decide (these backends resolve at
        launch, so the door does not pipeline them)."""
        with self._lock:
            now = self._now()
            out = self.inner.allow_batch(keys, ns, now=now)
            self.log.append(("keys", list(keys), list(ns), now))
        return out

    def reset(self, key: str) -> None:
        with self._lock:
            now = self._now()
            self.inner.reset(key)
            self.log.append(("reset", key, None, now))

    def __getattr__(self, name):
        return getattr(self.inner, name)


def check_backend_door(torch, cfg, backend: str, *, device: str = "cuda",
                       seed: int = 0, frames: int = 40, depth: int = 8,
                       n_keys: int = 64, flags=DEFAULT_STACK) -> dict:
    """Phase 4 for the dense and exact backends: the port's door over
    ``backend`` (micro-batcher at its defaults) on one connection
    pipelining ``frames`` ALLOW_BATCH frames of ``n_keys`` string keys
    (``depth`` in flight), ALLOW_N frames and a RESET; every answer must
    be bit-identical to a CPU replay of the windows the batcher launched
    (requests keep their order across windows on one connection), the
    final state to the replay's; ALLOW_HASHED must be refused
    (InvalidConfigError, as the JAX batcher refuses a backend without the
    raw-id lane, which the door looks for on the backend under the
    binary's decorator stack for ``flags``); HEALTH counts every
    decision."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.serving import protocol as p
    from ratelimiter_tpu_torch.serving.server import run_server

    from ratelimiter_tpu_torch.ops import dense_cuda

    kw = {} if backend == "exact" else {"device": device}
    served = create_limiter(cfg, backend=backend, clock=ManualClock(T0),
                            **kw)
    rec = KeyRecorder(served, T0)
    dense_cuda.reset_launch_counts()
    rng = np.random.default_rng(seed + 23)
    plan = []
    for i in range(frames):
        if i == frames // 2:
            plan.append(("reset", "user:1"))
        if i % 5 == 4:
            plan.append(("n", f"user:{int(zipf_ids(rng, 1)[0])}",
                         int(rng.integers(1, 4))))
        plan.append(("batch", [f"user:{int(k)}" for k in
                               zipf_ids(rng, n_keys)],
                     [int(x) for x in rng.integers(1, 3, n_keys)]))
    answers = {}

    async def main(served, registry):
        srv = await run_server(served, "127.0.0.1", 0, registry=registry)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        sent = 0

        async def read_one():
            length, type_, rid = p.parse_header(await reader.readexactly(13))
            answers[rid] = (type_, await reader.readexactly(length - 9))

        try:
            writer.write(p.encode_allow_hashed(10 ** 6, np.arange(
                8, dtype=np.uint64)))
            await writer.drain()
            await read_one()
            for rid, item in enumerate(plan):
                if item[0] == "reset":
                    while sent > len(answers) - 1:
                        await read_one()
                    writer.write(p.encode_reset(rid, item[1]))
                elif item[0] == "n":
                    writer.write(p.encode_allow_n(rid, item[1], item[2]))
                else:
                    writer.write(p.encode_allow_batch(rid, item[1], item[2]))
                sent += 1
                await writer.drain()
                while sent - (len(answers) - 1) > depth:
                    await read_one()
            while len(answers) - 1 < sent:
                await read_one()
            writer.write(p.encode_simple(p.T_HEALTH, 10 ** 6 + 1))
            await writer.drain()
            await read_one()
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()

    t = time.perf_counter()
    with door_stack(flags) as (wrap, registry):
        asyncio.run(main(wrap(rec), registry))
    wall = time.perf_counter() - t
    name = f"door[{backend} {cfg.algorithm.value}]"
    type_, body = answers.pop(10 ** 6)
    code, msg = p.parse_error(body) if type_ == p.T_ERROR else (None, "")
    if type_ != p.T_ERROR or code != p.E_INVALID_CONFIG or "sketch" not in msg:
        raise AssertionError(f"{name}: ALLOW_HASHED answered {type_} {code} "
                             f"{msg!r}, not refused")
    type_, body = answers.pop(10 ** 6 + 1)
    serving, _, decisions = p.parse_health(body)
    counts = dense_cuda.launch_counts()
    _, served_arrays, _ = served.capture_state()
    served.close()
    replay = create_limiter(cfg, backend=backend, clock=ManualClock(T0),
                            **({} if backend == "exact"
                               else {"device": "cpu"}))
    rows = []
    for kind, a, ns, now in rec.log:
        replay.clock.set(now)
        if kind == "reset":
            replay.reset(a)
        else:
            rows.extend(replay.allow_batch(a, ns, now=now).results())
    want = iter(rows)
    for rid, item in enumerate(plan):
        type_, body = answers[rid]
        if item[0] == "reset":
            if type_ != p.T_OK:
                raise AssertionError(f"{name}: RESET answered {type_}")
        elif item[0] == "n":
            if type_ != p.T_RESULT or p.parse_result(body) != next(want):
                raise AssertionError(f"{name}: ALLOW_N frame {rid} differs "
                                     f"from the CPU replay")
        else:
            exp = [next(want) for _ in item[1]]
            if type_ != p.T_RESULT_BATCH or p.parse_result_batch(body) != exp:
                raise AssertionError(f"{name}: ALLOW_BATCH frame {rid} "
                                     f"differs from the CPU replay")
    if next(want, None) is not None:
        raise AssertionError(f"{name}: the replay has rows no frame asked")
    _, replay_arrays, _ = replay.capture_state()
    replay.close()
    for k, v in replay_arrays.items():
        if not np.array_equal(served_arrays[k], v):
            raise AssertionError(f"{name}: final state {k} differs from the "
                                 f"CPU replay")
    n_decisions = sum(len(x[1]) if x[0] == "batch" else 1
                      for x in plan if x[0] != "reset")
    if not serving or decisions != n_decisions:
        raise AssertionError(f"{name}: HEALTH {serving} {decisions} for "
                             f"{n_decisions} decisions")
    windows = sum(kind != "reset" for kind, *_ in rec.log)
    if backend == "dense" and device != "cpu" and (
            counts["dense_step"] != windows
            or counts["dense_front"] != windows):
        raise AssertionError(f"{name}: {counts['dense_front']} dense_front "
                             f"and {counts['dense_step']} dense_step "
                             f"launches for {windows} windows")
    log(f"{name} on {device}: {len(plan)} frames ({n_decisions} decisions) "
        f"in {windows} windows, every answer and the final state "
        f"bit-identical to a CPU replay, ALLOW_HASHED refused ({msg!r}); "
        f"{n_decisions / wall:.0f} decisions/s over the run; launches "
        f"{counts}")
    return {"frames": len(plan), "decisions": n_decisions,
            "windows": windows, "decisions_per_s": n_decisions / wall,
            "counts": counts}


def check_dense_durable(torch, seed: int) -> dict:
    """Phase 5 for the dense backend: a limiter on the card after config-3
    string traffic (an override included) saved to a file, restored by a
    CPU limiter: the captured state equal, then the same decisions on
    both."""
    import os
    import tempfile

    from ratelimiter_tpu_torch import ManualClock, create_limiter

    cfg = dense_config("SLIDING_WINDOW")
    batches = dense_trace(seed + 5, 12)
    gpu = create_limiter(cfg, backend="dense", clock=ManualClock(T0),
                         device="cuda")
    drive_plan(gpu, batches[:8], {1: ("set_override", ("user:1", 300))},
               DENSE_ADVANCE)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dense.npz")
        t = time.perf_counter()
        gpu.save(path)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        cpu = create_limiter(cfg, backend="dense",
                             clock=ManualClock(gpu.clock.now()),
                             device="cpu")
        cpu.restore(path)
    _, ga, _ = gpu.capture_state()
    _, ca, _ = cpu.capture_state()
    for k in ga:
        if ga[k].dtype != ca[k].dtype or not np.array_equal(ga[k], ca[k]):
            raise AssertionError(f"dense durability: restored {k} differs")
    _same_results("dense after restore",
                  drive_plan(gpu, batches[8:], {}, DENSE_ADVANCE),
                  drive_plan(cpu, batches[8:], {}, DENSE_ADVANCE))
    gpu.close()
    cpu.close()
    log(f"dense durability: save from the card {save_s:.3f} s "
        f"({size / 2 ** 20:.1f} MB), restored on the CPU bit-equal, the "
        f"next 4 batches identical")
    return {"save_s": save_s, "snapshot_mb": size / 2 ** 20}


# ---------------------------------------------------- the evaluation path

#: bench.py's accelerator geometry (bench.py:1659-1675): sliding window,
#: 100 per 60 s, 60 sub-windows, CU, one admission round, d=3, w=2^20,
#: 1M keys; batches of ADMIT (one admission launch) here, and one chunk
#: of 2^20 (bench.py's phase A on an accelerator uses 2^22).
EVAL_DEPTH, EVAL_WIDTH, EVAL_B, EVAL_BIG = 3, 1 << 20, ADMIT, 1 << 20
#: Phase C's serving shape (bench.py:1795-1810): 64 steps of 4096, 400 us
#: apart.
SCAN_STEPS, SCAN_DT_US = 64, 400


def bench_config():
    from ratelimiter_tpu_torch import Algorithm, Config, SketchParams

    return Config(algorithm=Algorithm.SLIDING_WINDOW, limit=LIMIT,
                  window=WINDOW_S, max_batch_admission_iters=1,
                  sketch=SketchParams(depth=EVAL_DEPTH, width=EVAL_WIDTH,
                                      sub_windows=SUB_WINDOWS,
                                      conservative_update=True))


def _hold_state(name: str, gpu: dict, cpu: dict) -> None:
    from ratelimiter_tpu_torch.convert import state_to_numpy

    g, c = state_to_numpy(gpu), state_to_numpy(cpu)
    for k in c:
        if not np.array_equal(g[k], c[k]):
            raise AssertionError(f"{name}: state {k} differs from the CPU")


def hold_counts(name: str, counts: dict, want: dict) -> dict:
    """``counts`` (a ``launch_counts()`` reading) equal to ``want`` under
    every name, 0 under each name ``want`` leaves out; returns it."""
    if set(want) - set(counts) or any(v != want.get(k, 0)
                                      for k, v in counts.items()):
        raise AssertionError(f"{name}: launches {counts}, not {want}")
    return counts


def _rolled(cfg, device, p: int) -> dict:
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk

    st = sk.init_state(cfg, device)
    sk.build_steps(cfg)[2](st, p)
    return st


def check_bench_chunk(torch, seed: int, chunks: int = 10) -> dict:
    """``loadgen.build_bench_chunk`` at bench.py's geometry: ``chunks``
    chunks of 8192 requests 0.25 s apart (two rollovers), then one of
    2^20; every packed mask, deny count and the final state bit-equal to
    the CPU; the 8192 chunks' launches one front, one admission and one
    ``cu_update`` a chunk, the 2^20 chunk's the composed back (the front
    and ``cu_update`` launched, no admission launch); the Zipf ids of the
    card held to the CPU's. Then decisions/s of 64 chunks on the card
    (rollovers included)."""
    from ratelimiter_tpu_torch.evaluation import loadgen
    from ratelimiter_tpu_torch.ops import sketch_cuda
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk

    cfg = bench_config()
    sub_us = sk.sketch_geometry(cfg)[1]
    roll = sk.build_steps(cfg)[2]
    # The ids: the card's against the CPU's over 2^20 counters.
    ids_gpu = loadgen._zipf_ids(0, EVAL_BIG, N_KEYS, ZIPF_A, "cuda").cpu()
    ids_cpu = loadgen._zipf_ids(0, EVAL_BIG, N_KEYS, ZIPF_A, "cpu")
    differ = int((ids_gpu != ids_cpu).sum())
    if differ:
        first = int(torch.nonzero(ids_gpu != ids_cpu)[0])
        raise AssertionError(f"Zipf ids on the card differ from the CPU's "
                             f"at {differ} of {EVAL_BIG} counters; first at "
                             f"counter {first}: {int(ids_gpu[first])} "
                             f"against {int(ids_cpu[first])}")
    p0 = int(T0 * 1e6) // sub_us
    out = {"zipf_ids_differing": differ}
    states = {d: _rolled(cfg, d, p0) for d in ("cuda", "cpu")}
    chunk = {d: loadgen.build_bench_chunk(cfg, EVAL_B, N_KEYS, ZIPF_A, d)
             for d in ("cuda", "cpu")}
    big = {d: loadgen.build_bench_chunk(cfg, EVAL_BIG, N_KEYS, ZIPF_A, d)
           for d in ("cuda", "cpu")}
    p, denies = p0, 0
    sketch_cuda.reset_launch_counts()
    for i in range(chunks + 1):
        t = int(T0 * 1e6) + i * 250_000
        if t // sub_us > p:
            p = t // sub_us
            for d in states:
                roll(states[d], p)
        if i == chunks:
            out["counts"] = hold_counts(
                f"bench chunks of {EVAL_B}", sketch_cuda.launch_counts(),
                {"window_estimate": chunks, "admit": chunks,
                 "cu_update": chunks})
            sketch_cuda.reset_launch_counts()
        fn = big if i == chunks else chunk
        res = {d: fn[d](states[d], i * EVAL_B, t, period=p)
               for d in states}
        if i == chunks:
            out["big_chunk_counts"] = hold_counts(
                f"bench chunk of {EVAL_BIG} (the composed back)",
                sketch_cuda.launch_counts(),
                {"window_estimate": 1, "cu_update": 1})
        for j, what in ((1, "packed mask"), (2, "deny count")):
            if not torch.equal(res["cuda"][j].cpu(), res["cpu"][j]):
                raise AssertionError(f"bench chunk {i}: {what} differs from "
                                     f"the CPU")
        denies += int(res["cpu"][2])
    _hold_state("bench chunk", states["cuda"], states["cpu"])
    del states["cpu"]
    st = _rolled(cfg, "cuda", p0)
    n_time, p = 64, p0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_time):
        t = int(T0 * 1e6) + i * 100_000
        if t // sub_us > p:
            p = t // sub_us
            roll(st, p)
        chunk["cuda"](st, i * EVAL_B, t, period=p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(chunks=chunks + 1, denies=denies,
               decisions_per_s=n_time * EVAL_B / wall)
    log(f"bench chunk (d={EVAL_DEPTH}, w={EVAL_WIDTH}, B={EVAL_B}, then "
        f"{EVAL_BIG}): {chunks + 1} chunks across two rollovers bit-equal "
        f"to the CPU ({denies} denied), launches of the {EVAL_B} chunks "
        f"{out['counts']}, the {EVAL_BIG} chunk composed "
        f"({out['big_chunk_counts']}), Zipf ids on the card equal to the "
        f"CPU's at all {EVAL_BIG} counters; {out['decisions_per_s']:.0f} "
        f"decisions/s over {n_time} chunks (smoke reading)")
    return out


def check_eval_chunk(torch, seed: int, chunks: int = 6) -> dict:
    """``oracle_device.build_eval_chunk`` beside the bench chunk: the
    sketch ring (60, 3, 2^20) and the oracle ring (60, 1, 2^20) int32 on
    the card; ``chunks`` chunks of 8192 across a rollover with the four
    stats and both final states bit-equal to the CPU, each chunk one
    front, admission and ``cu_update`` for the sketch and one front and
    ``add_back`` (the vanilla fused back) for the oracle; then 96 chunks on
    the card at 0.1 s apart for the false-deny and false-allow rates and
    their window coverage (smoke readings)."""
    from ratelimiter_tpu_torch.evaluation import oracle_device as od
    from ratelimiter_tpu_torch.evaluation.compare import wilson_interval
    from ratelimiter_tpu_torch.ops import sketch_cuda
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk

    cfg = bench_config()
    sub_us = sk.sketch_geometry(cfg)[1]
    roll = sk.build_steps(cfg)[2]
    roll_or = od.build_oracle_rollover(cfg, N_KEYS)
    p0 = int(T0 * 1e6) // sub_us

    def fresh(d):
        st = {"sk": _rolled(cfg, d, p0),
              "or": od.init_oracle_state(cfg, N_KEYS, d)}
        roll_or(st["or"], p0)
        return st

    states = {d: fresh(d) for d in ("cuda", "cpu")}
    chunk = {d: od.build_eval_chunk(cfg, EVAL_B, N_KEYS, ZIPF_A, d)
             for d in states}
    p = p0
    sketch_cuda.reset_launch_counts()
    for i in range(chunks):
        t = int(T0 * 1e6) + i * 400_000
        if t // sub_us > p:
            p = t // sub_us
            for d in states:
                roll(states[d]["sk"], p)
                roll_or(states[d]["or"], p)
        stats = {d: chunk[d](states[d], i * EVAL_B, t, period=p)[1]
                 for d in states}
        if not torch.equal(stats["cuda"].cpu(), stats["cpu"]):
            raise AssertionError(f"eval chunk {i}: stats "
                                 f"{stats['cuda'].tolist()} differ from the "
                                 f"CPU's {stats['cpu'].tolist()}")
    counts = hold_counts(
        f"eval chunks of {EVAL_B}", sketch_cuda.launch_counts(),
        {"window_estimate": 2 * chunks, "admit": chunks, "cu_update": chunks,
         "add_back": chunks, "add_update": chunks})
    for k in ("sk", "or"):
        _hold_state(f"eval chunk {k}", states["cuda"][k], states["cpu"][k])
    del states
    st = fresh("cuda")
    n_run, dt, p = 96, 100_000, p0
    acc = []
    for i in range(n_run):
        t = int(T0 * 1e6) + i * dt
        if t // sub_us > p:
            p = t // sub_us
            roll(st["sk"], p)
            roll_or(st["or"], p)
        acc.append(chunk["cuda"](st, i * EVAL_B, t, period=p)[1])
    fd, fa, sk_deny, or_deny = (int(x) for x in torch.stack(acc).sum(0))
    total = n_run * EVAL_B
    coverage = n_run * dt / 1e6 / WINDOW_S
    out = {"chunks_checked": chunks, "counts": counts, "chunks": n_run,
           "decisions": total,
           "false_deny": fd, "false_allow": fa, "sketch_deny": sk_deny,
           "oracle_deny": or_deny,
           "false_deny_rate": fd / max(1, total - or_deny),
           "false_deny_wilson95": wilson_interval(fd, total - or_deny),
           "false_allow_rate": fa / max(1, or_deny),
           "window_coverage": coverage}
    log(f"eval chunk (sketch d={EVAL_DEPTH} w={EVAL_WIDTH} and oracle "
        f"(60, 1, {EVAL_WIDTH}) on the card): {chunks} chunks bit-equal to "
        f"the CPU (stats and both states), launches {counts}; {n_run} "
        f"chunks: false-deny rate "
        f"{out['false_deny_rate']:.3e} ({fd} of {total - or_deny} oracle "
        f"allows), false-allow rate {out['false_allow_rate']:.3e} ({fa} of "
        f"{or_deny}), window coverage {coverage:.3f} (smoke readings)")
    return out


def check_scans(torch, seed: int) -> dict:
    """The scan runners at phase C's shape (64 steps x 4096, 400 us
    apart, within one sub-window): ``sketch_kernels.build_scan`` for
    config 3 (d=4, w=65536) and for d=3, w=2^20, and
    ``bucket_kernels.build_scan`` on TB-c2 (its 64 x 4096 string keys
    uniform over 10,000); packed masks, deny counts and the final state
    bit-equal to the CPU; each scan's launches one front, admission and
    update a step; decisions/s of 8 scans on the card (smoke)."""
    import dataclasses

    from ratelimiter_tpu_torch.ops import bucket_cuda, sketch_cuda
    from ratelimiter_tpu_torch.ops import bucket_kernels as bk
    from ratelimiter_tpu_torch.ops import sketch_kernels as sk
    from ratelimiter_tpu_torch.ops.hashing import (
        hash_prefixed_u64,
        split_hash,
        splitmix64,
    )

    rng = np.random.default_rng(seed + 29)
    out = {}
    cfg2 = dataclasses.replace(config3(), max_batch_admission_iters=1)
    cases = (("config 3 d=4 w=65536", cfg2), (f"d={EVAL_DEPTH} "
                                               f"w={EVAL_WIDTH}",
                                               bench_config()),
             ("TB-c2", config2_bucket()))
    for label, cfg in cases:
        bucket = label == "TB-c2"
        if bucket:
            keys = [f"u:{int(i)}" for i in rng.integers(
                0, C2_KEYS, SCAN_STEPS * BATCH)]
            h1, h2 = split_hash(hash_prefixed_u64(keys, cfg.prefix),
                                cfg.sketch.seed)
        else:
            ids = rng.zipf(ZIPF_A, size=SCAN_STEPS * BATCH).astype(np.uint64)
            h1, h2 = split_hash(splitmix64(ids), cfg.sketch.seed)
        h1 = torch.from_numpy(h1.astype(np.int64).reshape(SCAN_STEPS, BATCH))
        h2 = torch.from_numpy(h2.astype(np.int64).reshape(SCAN_STEPS, BATCH))
        ns = torch.ones((SCAN_STEPS, BATCH), dtype=torch.int32)
        if bucket:
            scan = bk.build_scan(cfg)
            states = {d: bk.init_state(cfg, d) for d in ("cuda", "cpu")}
            kw = {}
            now0 = int(T0 * 1e6)
        else:
            scan = sk.build_scan(cfg)
            sub_us = sk.sketch_geometry(cfg)[1]
            p = int(T0 * 1e6) // sub_us
            states = {d: _rolled(cfg, d, p) for d in ("cuda", "cpu")}
            kw = {"period": p}
            now0 = p * sub_us
        counter = bucket_cuda if bucket else sketch_cuda
        counter.reset_launch_counts()
        res = {}
        for d, st in states.items():
            res[d] = scan(st, h1.to(d), h2.to(d), ns.to(d), now0,
                          SCAN_DT_US, **kw)
        counts = hold_counts(
            f"scan {label}", counter.launch_counts(),
            {"bucket_estimate": SCAN_STEPS, "admit": SCAN_STEPS,
             "bucket_update": SCAN_STEPS} if bucket else
            {"window_estimate": SCAN_STEPS, "admit": SCAN_STEPS,
             "cu_update": SCAN_STEPS})
        for j, what in ((1, "packed masks"), (2, "deny counts")):
            if not torch.equal(res["cuda"][j].cpu(), res["cpu"][j]):
                raise AssertionError(f"scan {label}: {what} differ from the "
                                     f"CPU")
        if bucket:
            for k in ("debt", "acc", "rem", "last"):
                if not torch.equal(states["cuda"][k].cpu(),
                                   states["cpu"][k]):
                    raise AssertionError(f"scan {label}: state {k} differs")
        else:
            _hold_state(f"scan {label}", states["cuda"], states["cpu"])
        denies = int(res["cpu"][2].sum())
        st = states["cuda"]
        del states
        dh1, dh2, dns = h1.to("cuda"), h2.to("cuda"), ns.to("cuda")
        reps = 8
        torch.cuda.synchronize()
        t = time.perf_counter()
        for r in range(reps):
            if bucket:
                scan(st, dh1, dh2, dns, now0 + (r + 1) * 10 ** 6,
                     SCAN_DT_US)
            else:
                sk.build_steps(cfg)[2](st, p + r + 1)
                scan(st, dh1, dh2, dns, (p + r + 1) * sub_us, SCAN_DT_US,
                     period=p + r + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out[label] = {"denies": denies, "counts": counts,
                      "decisions_per_s": reps * SCAN_STEPS * BATCH / wall}
        log(f"scan {label}: {SCAN_STEPS} x {BATCH} bit-equal to the CPU "
            f"(masks, deny counts, state; {denies} denied), launches "
            f"{counts}; "
            f"{out[label]['decisions_per_s']:.0f} decisions/s over {reps} "
            f"scans (smoke reading)")
    return out


#: bench.py's CI-scale accuracy run (bench.py:1763-1767).
ACCURACY_ARGS = dict(n_keys=20_000, n_requests=120_000, batch=4096,
                     limit=50, window=60.0, request_rate=50_000.0)
ACCURACY_SKETCH = dict(depth=3, width=1 << 10, sub_windows=30,
                       conservative_update=True)


def check_accuracy(torch) -> dict:
    """``evaluate_accuracy`` at bench.py's CI-scale arguments
    (bench.py:1763-1767) on the card and on the CPU: the report equal
    field by field; on the card one front, admission and ``cu_update``
    a batch for the sketch and for its collision-free twin each."""
    import dataclasses

    from ratelimiter_tpu_torch import SketchParams
    from ratelimiter_tpu_torch.evaluation import evaluate_accuracy
    from ratelimiter_tpu_torch.ops import sketch_cuda

    kw = dict(ACCURACY_ARGS, sketch=SketchParams(**ACCURACY_SKETCH))
    steps = 2 * -(-kw["n_requests"] // kw["batch"])
    sketch_cuda.reset_launch_counts()
    t = time.perf_counter()
    got = evaluate_accuracy(**kw, device="cuda")
    wall = time.perf_counter() - t
    counts = hold_counts("evaluate_accuracy", sketch_cuda.launch_counts(),
                         {"window_estimate": steps, "admit": steps,
                          "cu_update": steps})
    want = evaluate_accuracy(**kw, device="cpu")
    if dataclasses.asdict(got) != dataclasses.asdict(want):
        raise AssertionError(f"evaluate_accuracy on the card {got} differs "
                             f"from the CPU's {want}")
    out = dict(got.as_dict(), wall_s=wall, counts=counts)
    log(f"evaluate_accuracy (bench.py's CI scale) on the card equal to the "
        f"CPU field by field: false-deny rate {got.false_deny_rate:.3e} "
        f"(Wilson 95% {got.false_deny_wilson95[0]:.3e}-"
        f"{got.false_deny_wilson95[1]:.3e}), CMS false-deny rate "
        f"{got.cms_false_deny_rate:.3e}, {got.semantic_disagreements} "
        f"semantic disagreements, {got.requests} requests in {wall:.1f} s; "
        f"launches {counts}")
    return out


def check_eval_path(torch, seed: int) -> dict:
    """The evaluation path at bench.py's geometry: the bench chunk, the
    eval chunk, the scan runners and ``evaluate_accuracy``."""
    return {"bench_chunk": check_bench_chunk(torch, seed),
            "eval_chunk": check_eval_chunk(torch, seed),
            "scans": check_scans(torch, seed),
            "accuracy": check_accuracy(torch)}


def eval_runs(ev: dict) -> tuple:
    """The evaluation path's counted runs for ``row_launches``: (the
    windowed ones, the bucket scan's)."""
    scans = ev["scans"]
    windowed = [ev["bench_chunk"], {"counts": ev["bench_chunk"][
        "big_chunk_counts"]}, ev["eval_chunk"], ev["accuracy"],
        *(run for label, run in scans.items() if label != "TB-c2")]
    return windowed, [scans["TB-c2"]]


#: Batches of each dense path (48 at +2.5 s cross two 60 s windows).
DENSE_STEPS = 48


def run_dense_slice(torch, seed: int) -> dict:
    """``--dense``: the dense step's rows (launches from the dense paths
    and door, each counted from 0 just before it), the dense and exact
    paths, their doors, the dense round trip and the evaluation path."""
    rows = check_dense_kernel(torch, seed)
    paths = check_dense_paths(torch, seed + 79, DENSE_STEPS)
    doors = {b: check_backend_door(torch, dense_config("SLIDING_WINDOW"),
                                   b, seed=seed + 83)
             for b in ("dense", "exact")}
    for name, row in rows.items():
        row["launches"] = sum(r["counts"][name] for r in (
            *paths.values(), doors["dense"]))
    return {"kernels": list(rows.values()), "paths": paths, "doors": doors,
            "above_capacity": check_above_capacity(torch, seed),
            "durable": check_dense_durable(torch, seed),
            "evaluation": check_eval_path(torch, seed)}


# ------------------------------------------------ phase observe (A13a)


#: The frame stages of the flight recorder, in the order one frame alone
#: in its window crosses them.
SPAN_CHAIN = ("io", "coalesce", "queue", "launch", "device", "resolve",
              "encode")


def hold_span_tree(spans: list, tid: int) -> dict:
    """The span-tree oracle for one traced frame sent alone (the JAX
    package's ``tests/test_tracing.py::_assert_span_tree`` with the order
    of the stages): every stage of ``SPAN_CHAIN`` present under the trace
    id, each span's end at or after its start, same-stage spans of one
    thread not overlapping, ``io`` starting first and each stage after
    ``coalesce`` starting no earlier than the one before it ended.
    Returns the first span's microseconds by stage."""
    mine = [sp for sp in spans if sp["trace_id"] == tid]
    missing = set(SPAN_CHAIN) - {sp["stage"] for sp in mine}
    if missing:
        raise AssertionError(f"trace {tid:016x}: stages {sorted(missing)} "
                             f"missing")
    by: dict = {}
    for sp in mine:
        if sp["t_end_ns"] < sp["t_start_ns"]:
            raise AssertionError(f"trace {tid:016x}: span ends before it "
                                 f"starts: {sp}")
        by.setdefault((sp["thread"], sp["stage"]), []).append(sp)
    for (_, stage), group in by.items():
        group.sort(key=lambda sp: sp["t_start_ns"])
        for a, b in zip(group, group[1:]):
            if a["t_end_ns"] > b["t_start_ns"]:
                raise AssertionError(f"trace {tid:016x}: overlapping {stage} "
                                     f"spans in one thread")
    first = {st: min((sp for sp in mine if sp["stage"] == st),
                     key=lambda sp: sp["t_start_ns"]) for st in SPAN_CHAIN}
    if first["io"]["t_start_ns"] > first["coalesce"]["t_start_ns"]:
        raise AssertionError(f"trace {tid:016x}: coalesce before io")
    for a, b in zip(SPAN_CHAIN[1:], SPAN_CHAIN[2:]):
        if first[b]["t_start_ns"] < first[a]["t_end_ns"]:
            raise AssertionError(f"trace {tid:016x}: {b} starts before "
                                 f"{a} ends")
    return {st: (sp["t_end_ns"] - sp["t_start_ns"]) / 1e3
            for st, sp in first.items()}


def stage_split(spans: list) -> dict:
    """{stage: {count, p50_us, p99_us, mean_us}} over recorded spans."""
    per: dict = {}
    for sp in spans:
        per.setdefault(sp["stage"], []).append(
            (sp["t_end_ns"] - sp["t_start_ns"]) / 1e3)
    return {st: {"count": len(v), "p50_us": float(np.percentile(v, 50)),
                 "p99_us": float(np.percentile(v, 99)),
                 "mean_us": float(np.mean(v))} for st, v in per.items()}


async def _roundtrip(reader, writer, frame: bytes):
    from ratelimiter_tpu_torch.serving import protocol as p

    writer.write(frame)
    await writer.drain()
    length, type_, rid = p.parse_header(await reader.readexactly(13))
    return type_, rid, await reader.readexactly(length - 9)


def check_traced_frames(cfg, *, device: str = "cuda", hashed: int = 32,
                        allow_n: int = 8, n_ids: int = 512, seed: int = 0,
                        flags=FULL_STACK) -> dict:
    """(b) In-process, the port's door under the binary's stack for
    ``flags`` (the flight recorder on) answers ``hashed`` traced
    ALLOW_HASHED frames of ``n_ids`` Zipf ids and ``allow_n`` traced
    ALLOW_N frames, one at a time (each alone in its window): every
    reply a result, every trace id's spans the span tree
    (``hold_span_tree``), and the recorder's ``chrome_trace()`` a JSON
    document holding every span."""
    from ratelimiter_tpu_torch import create_limiter
    from ratelimiter_tpu_torch.observability import tracing
    from ratelimiter_tpu_torch.serving import protocol as p
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    rng = np.random.default_rng(seed + 29)
    lim = create_limiter(cfg, backend="sketch", device=device)
    tids = []
    with door_stack(flags) as (wrap, registry):
        rec = tracing.get()

        async def main():
            srv = RateLimitServer(wrap(lim), "127.0.0.1", 0,
                                  registry=registry)
            await srv.start()
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            try:
                for i in range(hashed + allow_n):
                    tid = tracing.new_trace_id()
                    tids.append(tid)
                    frame = (p.encode_allow_hashed(i, zipf_ids(rng, n_ids))
                             if i < hashed else p.encode_allow_n(
                                 i, f"user:{int(zipf_ids(rng, 1)[0])}", 1))
                    t, rid, _ = await _roundtrip(reader, writer,
                                                 p.with_trace(frame, tid))
                    want = p.T_RESULT_HASHED if i < hashed else p.T_RESULT
                    if (t, rid) != (want, i):
                        raise AssertionError(f"traced frame {i} answered "
                                             f"{t}")
            finally:
                writer.close()
                await writer.wait_closed()
                await srv.shutdown()

        asyncio.run(main())
        spans = rec.dump()
        doc = json.loads(json.dumps(rec.chrome_trace()))
    lim.close()
    trees = [hold_span_tree(spans, tid) for tid in tids]
    events = doc["traceEvents"]
    if len(events) != len(spans) or any(e["ph"] != "X" for e in events):
        raise AssertionError(f"chrome_trace holds {len(events)} events for "
                             f"{len(spans)} spans")
    out = {"frames": len(tids), "spans": len(spans),
           "hashed_frame_us": {st: float(np.median(
               [t[st] for t in trees[:hashed]])) for st in SPAN_CHAIN},
           "allow_n_frame_us": {st: float(np.median(
               [t[st] for t in trees[hashed:]])) for st in SPAN_CHAIN}}
    log(f"traced frames on {device}: {hashed} ALLOW_HASHED and {allow_n} "
        f"ALLOW_N frames, every trace id's {len(SPAN_CHAIN)} stages in "
        f"order, chrome_trace() {len(events)} events; median us by stage "
        f"(hashed) {out['hashed_frame_us']}")
    return out


def check_deadlines(cfg, *, device: str = "cuda", counters=(),
                    frames: int = 16, n_ids: int = 512,
                    seed: int = 0) -> dict:
    """(c) Deadline shedding through the door under the default stack,
    fail-open and fail-closed: ``frames`` frames (3 in 4 ALLOW_HASHED of
    ``n_ids`` ids, the rest ALLOW_N) with an expired budget are shed —
    a fail-open allowance (reset at the clock's now plus the window) or
    E_DEADLINE — with no launch on the card (``counters``), and
    ``rate_limiter_server_deadline_shed_total`` counts their decisions;
    then ``frames`` frames with a 10 s budget, one at a time, answer as a
    CPU limiter decides them."""
    from dataclasses import replace

    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.core.types import (
        batch_fail_open,
        fail_open_result,
    )
    from ratelimiter_tpu_torch.serving import protocol as p
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    out = {}
    for fail_open in (True, False):
        c = replace(cfg, fail_open=fail_open)
        served = create_limiter(c, backend="sketch", clock=ManualClock(T0),
                                device=device)
        mirror = create_limiter(c, backend="sketch", clock=ManualClock(T0),
                                device="cpu")
        rng = np.random.default_rng(seed + 31)
        plan = [("ids", zipf_ids(rng, n_ids)) if i % 4 else
                ("n", f"user:{int(zipf_ids(rng, 1)[0])}")
                for i in range(2 * frames)]

        def frame(i, budget):
            kind, a = plan[i]
            f = (p.encode_allow_hashed(i, a) if kind == "ids"
                 else p.encode_allow_n(i, a, 1))
            return p.with_deadline(f, budget)

        name = f"deadlines[{'fail-open' if fail_open else 'fail-closed'}]"
        with door_stack() as (wrap, registry):
            async def main():
                srv = RateLimitServer(wrap(served), "127.0.0.1", 0,
                                      registry=registry)
                await srv.start()
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", srv.port)
                try:
                    for mod in counters:
                        mod.reset_launch_counts()
                    writer.write(b"".join(frame(i, -1.0)
                                          for i in range(frames)))
                    await writer.drain()
                    shed = {}
                    for _ in range(frames):
                        length, t, rid = p.parse_header(
                            await reader.readexactly(13))
                        shed[rid] = (t, await reader.readexactly(length - 9))
                    if device == "cuda":
                        import torch

                        torch.cuda.synchronize()
                    counts = {}
                    for mod in counters:
                        counts.update(mod.launch_counts())
                    live = [await _roundtrip(reader, writer,
                                             frame(i, 10.0))
                            for i in range(frames, 2 * frames)]
                    t, _, body = await _roundtrip(
                        reader, writer, p.encode_simple(p.T_METRICS, 10 ** 6))
                    return shed, counts, live, p.parse_metrics(body)
                finally:
                    writer.close()
                    await writer.wait_closed()
                    await srv.shutdown()

            shed, counts, live, text = asyncio.run(main())
        if any(counts.values()):
            raise AssertionError(f"{name}: expired frames launched {counts}")
        reset_at = T0 + float(c.window)
        n_shed = 0
        for i in range(frames):
            kind, a = plan[i]
            t, body = shed[i]
            b = len(a) if kind == "ids" else 1
            n_shed += b
            if not fail_open:
                if t != p.T_ERROR or p.parse_error(body)[0] != p.E_DEADLINE:
                    raise AssertionError(f"{name}: frame {i} answered {t}")
                continue
            want = (p.encode_result_hashed(i, batch_fail_open(
                b, c.limit, reset_at)) if kind == "ids" else
                p.encode_result(i, fail_open_result(c.limit, reset_at)))
            if p.HEADER_SIZE + len(body) != len(want) or \
                    body != want[p.HEADER_SIZE:]:
                raise AssertionError(f"{name}: frame {i} is not the "
                                     f"fail-open allowance")
        for i, (t, rid, body) in enumerate(live, frames):
            kind, a = plan[i]
            if kind == "ids":
                got = p.parse_result_hashed(body)
                want = mirror.allow_ids(a)
                same = all(np.array_equal(getattr(got, f), getattr(want, f))
                           for f in ("allowed", "remaining", "retry_after",
                                     "reset_at"))
            else:
                same = p.parse_result(body) == mirror.allow_n(a, 1)
            if rid != i or not same:
                raise AssertionError(f"{name}: live frame {i} differs from "
                                     f"the CPU limiter")
        counted = metric_value(text, "rate_limiter_server_deadline_shed_total")
        if counted != n_shed:
            raise AssertionError(f"{name}: the shed counter shows "
                                 f"{counted:g} for {n_shed} decisions shed")
        served.close()
        mirror.close()
        out[name] = {"frames_shed": frames, "decisions_shed": n_shed}
        log(f"{name} on {device}: {frames} expired frames ({n_shed} "
            f"decisions) shed with no launch, the shed counter equal; "
            f"{frames} frames with a 10 s budget equal to the CPU limiter")
    return out


def read_journal(d: str) -> list:
    """The events spilled to ``d``'s segments, oldest first."""
    import glob
    import os

    out = []
    for path in sorted(glob.glob(os.path.join(d, "events-*.jsonl"))):
        with open(path, encoding="utf-8") as fh:
            out += [json.loads(line) for line in fh if line.strip()]
    return out


def check_journal_door(cfg, *, device: str = "cuda") -> dict:
    """(d) The event journal of ``python -m ratelimiter_tpu_torch.serving
    --event-journal-dir D``: POLICY_SET, POLICY_DEL and RESET frames,
    then SIGTERM; D's segment must hold their three events in order
    (``actor="binary"``, keys as ``key_token``s). Then the tenant binary
    (``tenant_flags``, ``--controller``) under ``tenant_storm``, whose
    mass stays in the window: the controller tightens free twice, in two
    ticks a cooldown apart (5000 -> 3500 -> 2450). Its journal must hold
    both tightens under two different correlation ids, and every
    controller event an id shared only by the events of one tick (the
    ids' events contiguous)."""
    import shutil
    import tempfile

    from ratelimiter_tpu_torch.ops.hashing import key_token
    from ratelimiter_tpu_torch.serving import protocol as p

    geometry = ["--algorithm", cfg.algorithm.value, "--limit",
                str(cfg.limit), "--window", str(cfg.window),
                "--sketch-depth", str(cfg.sketch.depth), "--sketch-width",
                str(cfg.sketch.width), "--sub-windows",
                str(cfg.sketch.sub_windows), "--device", device]
    root = tempfile.mkdtemp(prefix="journal-door-")
    servers = []
    try:
        d1 = f"{root}/policy"
        srv = ServerProcess(geometry + ["--event-journal-dir", d1])
        servers.append(srv)
        c = DoorClient(srv.port)
        c.call(p.encode_policy_set, "api-cust-7", 250)
        c.call(lambda rid: p.encode_policy_key(p.T_POLICY_DEL, rid,
                                               "api-cust-7"))
        c.call(p.encode_reset, "ünï:42")
        c.close()
        if srv.terminate() != 0:
            raise AssertionError("journal door: SIGTERM exit code")
        got = [(e["category"], e["action"], e["actor"], e["payload"])
               for e in read_journal(d1)]
        want = [("policy", "set-override", "binary",
                 {"key_hash": key_token("api-cust-7"), "limit": 250,
                  "window_scale": 1.0}),
                ("policy", "delete-override", "binary",
                 {"key_hash": key_token("api-cust-7"), "deleted": True}),
                ("policy", "reset", "binary",
                 {"key_hash": key_token("ünï:42")})]
        if got != want:
            raise AssertionError(f"journal door: the segment holds {got}")

        d2 = f"{root}/controller"
        srv = ServerProcess(geometry + tenant_flags() + [
            "--controller", "--controller-interval", "0.2",
            "--event-journal-dir", d2])
        servers.append(srv)
        c = DoorClient(srv.port)
        moved = [tenant_storm(c)]
        moved.append(free_effective_below(c, 3500))
        c.close()
        if srv.terminate() != 0:
            raise AssertionError("controller journal: SIGTERM exit code")
        ctl = [e for e in read_journal(d2) if e["category"] == "controller"]
        tighten = [e for e in ctl if e["action"] == "tighten"
                   and e["actor"] == "free"]
        steps = [(e["payload"]["old"], e["payload"]["new"])
                 for e in tighten]
        if moved != [3500, 2450] or steps[:2] != [(5000, 3500),
                                                  (3500, 2450)]:
            raise AssertionError(f"controller journal: free moved to "
                                 f"{moved}, events {ctl[:4]}")
        if tighten[0]["corr"] == tighten[1]["corr"]:
            raise AssertionError("controller journal: two ticks' tightens "
                                 "share one correlation id")
        seen, last = set(), None
        for e in ctl:
            if not e["corr"]:
                raise AssertionError(f"controller event without an id: {e}")
            if e["corr"] != last and e["corr"] in seen:
                raise AssertionError("a correlation id spans two ticks")
            seen.add(e["corr"])
            last = e["corr"]
    finally:
        for srv in servers:
            srv.kill()
        shutil.rmtree(root, ignore_errors=True)
    out = {"policy_events": len(got), "controller_events": len(ctl),
           "controller_ticks": len(seen)}
    log(f"journal door on {device}: POLICY_SET, POLICY_DEL and RESET "
        f"journaled in order with key tokens; the controller's "
        f"{len(ctl)} events (tighten free 5000 -> 3500, then 3500 -> "
        f"2450 a tick later) under {len(seen)} correlation ids, one a "
        f"tick")
    return out


def check_breaker(cfg=None, *, device: str = "cuda", seed: int = 0,
                  batch: int = BATCH) -> dict:
    """(e) ``--circuit-breaker --breaker-threshold 3`` over a fail-closed
    limiter (config 3 unless ``cfg``) on a ManualClock, ``batch`` Zipf
    ids a call, under the binary's stack: with a
    failure injected it trips after 3 failures; while open it
    short-circuits (the breaker's error, its counter, no launch); after
    the cooldown one probe reaches the limiter (its own error) and the
    breaker opens again; after ``heal()`` it still short-circuits until
    the cooldown, then one probe reaches the card (one step's launches)
    and the breaker closes."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.core.errors import StorageUnavailableError
    from ratelimiter_tpu_torch.observability.metrics import Registry
    from ratelimiter_tpu_torch.ops import sketch_cuda
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_limiter_stack,
        parse_args,
    )

    lim = create_limiter(cfg or config3(), backend="sketch",
                         clock=ManualClock(T0), device=device)
    reg = Registry()
    stack = build_limiter_stack(lim, parse_args(
        ["--circuit-breaker", "--breaker-threshold", "3"]), registry=reg)
    breaker = stack.inner
    ids = zipf_ids(np.random.default_rng(seed + 41), batch)

    def call() -> str:
        try:
            stack.resolve(stack.launch_ids(ids, wire=True))
            return "ok"
        except StorageUnavailableError as exc:
            return str(exc)

    def launches() -> int:
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        return sketch_cuda.launch_counts()["window_estimate"]

    sketch_cuda.reset_launch_counts()
    trail = [(call(), breaker.state, launches())]
    lim.inject_failure()
    trail += [(call(), breaker.state, launches()) for _ in range(3)]
    trail += [(call(), breaker.state, launches()) for _ in range(4)]
    lim.clock.advance(breaker.cooldown)
    trail.append((call(), breaker.state, launches()))
    lim.heal()
    trail.append((call(), breaker.state, launches()))
    lim.clock.advance(breaker.cooldown)
    trail += [(call(), breaker.state, launches()) for _ in range(2)]
    failed = "sketch launch failed: injected backend failure"
    opened = f"circuit breaker open (cooldown {breaker.cooldown:g}s)"
    k = 1 if device == "cuda" else 0    # the CPU launches no kernel
    want = ([("ok", "closed", k)]
            + [(failed, "closed", k)] * 2 + [(failed, "open", k)]
            + [(opened, "open", k)] * 4 + [(failed, "open", k)]
            + [(opened, "open", k)] + [("ok", "closed", 2 * k),
                                       ("ok", "closed", 3 * k)])
    if trail != want:
        raise AssertionError(f"breaker on {device}: {trail}")
    short = reg.get("rate_limiter_breaker_short_circuits_total").total()
    if short != 5 * batch:
        raise AssertionError(f"breaker: {short:g} short-circuited decisions")
    moves = {k: reg.get("rate_limiter_breaker_transitions_total").value(to=k)
             for k in ("open", "half-open", "closed")}
    if moves != {"open": 2.0, "half-open": 2.0, "closed": 1.0}:
        raise AssertionError(f"breaker transitions {moves}")
    stack.close()
    log(f"breaker on {device}: tripped after 3 failures, 5 calls "
        f"short-circuited with no launch, a failed probe re-opened it, "
        f"after heal() one probe reached the card and closed it; "
        f"transitions {moves}")
    return {"trail": [t[1] for t in trail], "transitions": moves}


def torch_ops_in(ranges: list, cpu_ops: list) -> dict:
    """The host time inside profiler ``ranges`` (Chrome-trace events of
    one thread each) split by layer: the torch ops called directly in a
    range (the outermost ``cpu_op`` events it contains, by name), and the
    rest, the Python between them. Milliseconds a range."""
    by_name: dict = {}
    calls = torch_us = 0.0
    for r in ranges:
        t0, t1 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        inside = sorted((o for o in cpu_ops if o["tid"] == r["tid"]
                         and t0 <= float(o["ts"])
                         and float(o["ts"]) + float(o["dur"]) <= t1),
                        key=lambda o: float(o["ts"]))
        end = -1.0
        for o in inside:
            if float(o["ts"]) < end:
                continue            # nested in the op before it
            end = float(o["ts"]) + float(o["dur"])
            calls += 1
            torch_us += float(o["dur"])
            by_name[o["name"]] = by_name.get(o["name"], 0.0) + float(
                o["dur"])
    n = max(len(ranges), 1)
    total = sum(float(r["dur"]) for r in ranges)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"ms": total / n / 1e3, "torch_ops": calls / n,
            "torch_ms": torch_us / n / 1e3,
            "python_ms": (total - torch_us) / n / 1e3,
            "top_torch_ops_ms": [(k, v / n / 1e3) for k, v in top]}


def check_capture(*, seed: int = 0, batches: int = 16,
                  device: str = "cuda") -> dict:
    """(f) ``TracingDecorator.capture`` around ``batches`` config-3 CU
    batches (launch and resolve of 4096 Zipf ids): the Chrome trace must
    hold a ``launch`` and a ``resolve`` range for each batch and, on the
    card, the step's kernels by name. Returns the top 10 device ops by
    time and, for each range, the host ms a batch split into the torch
    ops it calls and the Python between them (``torch_ops_in``)."""
    import os
    import tempfile

    from ratelimiter_tpu_torch import create_limiter
    from ratelimiter_tpu_torch.observability.decorators import (
        TracingDecorator,
    )

    rng = np.random.default_rng(seed + 47)
    lim = TracingDecorator(create_limiter(config3(), backend="sketch",
                                          device=device))
    work = [zipf_ids(rng, BATCH) for _ in range(batches + 2)]
    for ids in work[:2]:
        lim.resolve(lim.launch_ids(ids, wire=True))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with lim.capture(path):
            for ids in work[2:]:
                lim.resolve(lim.launch_ids(ids, wire=True))
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X"]
    finally:
        os.unlink(path)
        lim.close()
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    dev_ops: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev_ops[e["name"]] = dev_ops.get(e["name"], 0.0) + float(
                e["dur"])
    host = {}
    for op in ("launch", "resolve"):
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and e["name"] == f"ratelimiter/sliding_window/{op}"]
        if len(ranges) != batches:
            raise AssertionError(f"capture: {len(ranges)} {op} ranges for "
                                 f"{batches} batches")
        host[op] = torch_ops_in(ranges, cpu_ops)
    names = " ".join(dev_ops)
    for kern in (("window_front_kernel", "window_admit_kernel",
                  "cu_update_kernel") if device == "cuda" else ()):
        if kern not in names:
            raise AssertionError(f"capture: no {kern} in the trace's "
                                 f"device ops")
    top = sorted(dev_ops.items(), key=lambda kv: -kv[1])[:10]
    out = {"host": host,
           "top_device_ops_us": [(k[:80], v / batches) for k, v in top]}
    log(f"profiler capture on {device}: {batches} config-3 CU batches; "
        + "; ".join(
            f"ratelimiter/sliding_window/{op} {h['ms']:.3f} ms a batch "
            f"({h['torch_ops']:.0f} torch ops {h['torch_ms']:.3f} ms, "
            f"Python between them {h['python_ms']:.3f} ms; top ops "
            + ", ".join(f"{k} {v:.3f}" for k, v in h["top_torch_ops_ms"])
            + ")" for op, h in host.items())
        + "; top device ops (us a batch): " + "; ".join(
            f"{k} {v:.2f}" for k, v in out["top_device_ops_us"]))
    return out


#: (g)'s stacks, timed in turns.
READING_STACKS = (("bare", BARE_STACK), ("default", DEFAULT_STACK),
                  ("full", FULL_STACK))


def observe_readings(seed: int = 0, rounds: int = 3) -> dict:
    """(g) ``time_door`` on windowed CU and TB-c2 under each stack of
    ``READING_STACKS``, in turns, ``rounds`` rounds on the same traffic:
    decisions/s and frame latency p50/p99 a round, the flight recorder's
    split by stage (full stack), and whether the default stack's
    decisions/s falls outside the bare door's spread over its rounds.
    Smoke readings: nothing is gated on them."""
    cells = (("windowed CU", config3(), "zipf", seed + 17),
             ("TB-c2", config2_bucket(), "c2", seed + 19))
    runs: dict = {}
    for _ in range(rounds):
        for label, cfg, space, sd in cells:
            for stack, flags in READING_STACKS:
                r = time_door(cfg, f"{label} {stack}", seed=sd, space=space,
                              flags=flags)
                runs.setdefault(label, {}).setdefault(stack, []).append(r)
    out = {}
    for label, by in runs.items():
        cell = {}
        for stack, rs in by.items():
            rates = [r["decisions_per_s"] for r in rs]
            cell[stack] = {"decisions_per_s": rates,
                           "p50_ms": [r["p50_ms"] for r in rs],
                           "p99_ms": [r["p99_ms"] for r in rs]}
        bare = cell["bare"]["decisions_per_s"]
        cell["default_outside_bare_spread"] = any(
            not min(bare) <= x <= max(bare)
            for x in cell["default"]["decisions_per_s"])
        cell["stages_full"] = stage_split(
            [sp for r in by["full"] for sp in r["spans"]])
        out[label] = cell
        log(f"door readings [{label}] (rounds): " + "; ".join(
            f"{stack} {', '.join(f'{x:.0f}' for x in c['decisions_per_s'])} "
            f"decisions/s, p50 "
            f"{', '.join(f'{x:.2f}' for x in c['p50_ms'])} ms, p99 "
            f"{', '.join(f'{x:.2f}' for x in c['p99_ms'])} ms"
            for stack, c in cell.items() if stack in dict(READING_STACKS))
            + f"; default outside the bare spread: "
              f"{cell['default_outside_bare_spread']}; full-stack stages "
              f"(p50/p99 us): " + ", ".join(
                  f"{st} {v['p50_us']:.0f}/{v['p99_us']:.0f}"
                  for st, v in cell["stages_full"].items()))
    return out


def check_observe_doors(torch, seed: int = 0, reuse=None) -> dict:
    """(a) ``check_door`` on config 3 windowed CU, CU with the side table
    and TB-c2 under the binary's default stack and its full stack:
    replies bit-equal to the replay, every kernel of the path launched,
    every window through the front kernel, no composed back, and what the
    stack counts on METRICS (``hold_door_metrics``, the consumer
    gauges). ``reuse`` holds default-stack runs already made (phase 4)."""
    from ratelimiter_tpu_torch.ops import bucket_cuda, sketch_cuda

    cells = (
        ("windowed CU", config3(), "zipf", seed + 17, sketch_cuda,
         ("window_estimate", "admit", "cu_update", "window_reset"),
         "window_estimate", 0),
        (f"windowed CU hh_slots={HH_SLOTS}", config3_hh(), "zipf",
         seed + 37, sketch_cuda,
         ("window_estimate", "admit", "cu_update", "hh_update [fused]",
          "window_reset"), "window_estimate", 0),
        ("TB-c2", config2_bucket(), "c2", seed + 19, bucket_cuda,
         ("bucket_estimate", "admit", "bucket_update"), "bucket_estimate",
         1))
    out = {}
    for stack, flags in (("default", DEFAULT_STACK), ("full", FULL_STACK)):
        for label, cfg, space, sd, mod, required, front, per_reset in cells:
            if stack == "default" and reuse and label in reuse:
                out[f"{label} {stack}"] = reuse[label]
                continue
            out[f"{label} {stack}"] = check_door(
                torch, cfg, f"{label} {stack} stack", seed=sd,
                space=space, counters=[mod], required=required,
                same=("admit", required[2]), front=front,
                front_per_reset=per_reset, flags=flags)
    return out


def run_observe(torch, seed: int = 0, reuse=None,
                rounds: int = 3) -> dict:
    """Phase observe: (a)-(g) on the card, (g) over ``rounds`` rounds
    (one in the whole run, three under ``--observe``)."""
    from ratelimiter_tpu_torch.ops import sketch_cuda

    t = time.perf_counter()
    out = {"doors": check_observe_doors(torch, seed, reuse)}
    out["traced"] = check_traced_frames(config3(), seed=seed)
    out["deadlines"] = check_deadlines(config3(), counters=[sketch_cuda],
                                       seed=seed)
    out["journal"] = check_journal_door(config3())
    out["breaker"] = check_breaker(seed=seed)
    out["capture"] = check_capture(seed=seed)
    out["readings"] = observe_readings(seed, rounds=rounds)
    out["seconds"] = time.perf_counter() - t
    log(f"phase observe on {card_line()}: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------- phase gateway (A13b)

#: Phase gateway's HTTP clients (``gateway_client``): threads, requests a
#: thread and keys a thread in the checked runs (each thread asks for its
#: own keys, one request at a time over one keep-alive connection, so a
#: key's answers come back in the order its rows reach the replay).
HTTP_THREADS, HTTP_REQUESTS, HTTP_KEYS = 8, 40, 4
#: The headers an /v1/allow answer is held to.
HTTP_HEADERS = ("X-RateLimit-Limit", "X-RateLimit-Remaining",
                "X-RateLimit-Reset", "Retry-After", "traceparent")
#: The bearer tokens of the phase's binaries, by lever.
TOKENS = {"policy": "pt", "reset": "rt", "debug": "dt", "audit": "at",
          "snapshot": "st", "tenants": "tt"}
TOKEN_FLAGS = ("--http-policy", "--http-policy-token", TOKENS["policy"],
               "--http-reset", "--http-reset-token", TOKENS["reset"],
               "--debug-trace", "--debug-token", TOKENS["debug"],
               "--audit-token", TOKENS["audit"],
               "--http-snapshot-token", TOKENS["snapshot"],
               "--http-tenants", "--http-tenants-token", TOKENS["tenants"])


def _http_thread(port: int, t: int, requests: int, keys: int, seed: int,
                 space: str, ns: list, out: list) -> None:
    """One HTTP client thread: ``requests`` GET /v1/allow one at a time
    over one keep-alive connection. With ``keys`` it asks for its own
    keys ``http:<t>:<j>`` and records every answer (a third of the
    requests name the key in X-User-ID, a quarter carry a traceparent, a
    fifth a 60 s deadline budget); without, it asks for ``space``'s keys
    and records the latency alone."""
    import http.client
    from urllib.parse import quote

    from ratelimiter_tpu_torch.observability.tracing import (
        format_traceparent,
    )

    try:
        rng = np.random.default_rng(seed * 1000 + t)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        rows, lat = [], []
        for j in range(requests):
            key = (f"http:{t}:{j % keys}" if keys
                   else door_keys(rng, space, 1)[0])
            n = int(rng.choice(ns))
            headers = {}
            path = f"/v1/allow?key={quote(key)}&n={n}"
            if keys and j % 3 == 1:
                headers["X-User-ID"] = key
                path = f"/v1/allow?n={n}"
            if keys and j % 4 == 2:
                headers["traceparent"] = format_traceparent(
                    int(rng.integers(1, 1 << 62)))
            if keys and j % 5 == 3:
                headers["X-RateLimit-Deadline-Ms"] = "60000"
            t0 = time.perf_counter()
            conn.request("GET", path, headers=headers)
            r = conn.getresponse()
            body = r.read()
            lat.append(time.perf_counter() - t0)
            if r.status not in (200, 429):
                raise AssertionError(f"HTTP {r.status}: {body[:200]!r}")
            if keys:
                rows.append((key, n, r.status,
                             {h: r.getheader(h) for h in HTTP_HEADERS},
                             json.loads(body), headers.get("traceparent")))
        conn.close()
        out[t] = {"rows": rows, "latency": lat}
    except BaseException as exc:  # reported by the parent
        out[t] = {"error": repr(exc)}


def gateway_client() -> None:
    """Phase gateway's HTTP client, run in a child process: its arguments
    come as JSON on stdin (``port``, ``threads``, ``requests``, ``keys``,
    ``seed``, ``space``, ``ns``); the threads' answers and latencies and
    the wall time go pickled to stdout."""
    args = json.loads(sys.stdin.read())
    out: list = [None] * args["threads"]
    threads = [threading.Thread(target=_http_thread, args=(
        args["port"], t, args["requests"], args["keys"], args["seed"],
        args["space"], args["ns"], out)) for t in range(args["threads"])]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    errors = [o["error"] for o in out if "error" in o]
    if errors:
        raise SystemExit(f"HTTP client threads failed: {errors[:3]}")
    sys.stdout.buffer.write(pickle.dumps({"threads": out, "wall_s": wall}))
    sys.stdout.flush()


def http_call(port: int, method: str, path: str, token=None,
              headers=None):
    """One HTTP request: (status, headers, JSON body or text)."""
    import urllib.error
    import urllib.request

    hdrs = dict(headers or {})
    if token is not None:
        hdrs["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, h, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, h, raw = e.code, dict(e.headers), e.read()
    body = (json.loads(raw) if h.get("Content-Type") == "application/json"
            else raw.decode())
    return status, h, body


def gated(port: int, method: str, path: str, token: str, name: str):
    """A lever: 403 without its token, 200 with it; the answer's body."""
    st = http_call(port, method, path)[0]
    if st != 403:
        raise AssertionError(f"{name}: {method} {path} without its token "
                             f"answered {st}, not 403")
    st, _, body = http_call(port, method, path, token)
    if st != 200:
        raise AssertionError(f"{name}: {method} {path} with its token "
                             f"answered {st}: {body}")
    return body


def gateway_args(base: list, *, device: str, extra=()) -> list:
    """The binary's command line for an in-process run: ``base`` (the
    cell's flags), the device, ephemeral ports, ``extra``."""
    return [*base, "--device", device, "--port", "0", "--http-port", "0",
            *extra]


def cell_flags(cfg) -> list:
    """The binary's flags for ``cfg``'s algorithm, limit and geometry."""
    flags = ["--algorithm", cfg.algorithm.value, "--limit", str(cfg.limit),
             "--window", repr(float(cfg.window)), "--sketch-depth",
             str(cfg.sketch.depth), "--sketch-width", str(cfg.sketch.width)]
    if cfg.algorithm.value != "token_bucket":
        flags += ["--sub-windows", str(cfg.sketch.sub_windows)]
        if cfg.sketch.hh_slots:
            flags += ["--hh-slots", str(cfg.sketch.hh_slots)]
    return flags


class in_process_binary:
    """``with in_process_binary(argv, record=...) as svc``: the server
    binary's own ``serve()`` (serving/__main__.py) running ``argv`` in a
    thread of this process, with a fresh default metrics registry (as in
    a fresh process); ``svc`` is what ``serve`` hands out once the door
    and the gateway listen. With ``record`` the backend limiter is built
    on a ManualClock at T0 and wrapped in a ``RecordingLimiter`` (the
    recording proxy of ``check_door``), ``svc.rec``; the launch counts of
    ``counters`` are set to 0 once it listens, and the auditor's offers
    are recorded in ``svc.taps`` (with whether each was dropped; without
    ``record`` the tap runs as the binary runs it). On exit
    the service stops as on SIGTERM (the gateway, the door's drain, the
    auditor's flush, the journal) and the flight recorder is turned
    off."""

    def __init__(self, argv: list, *, record: bool = False, counters=()):
        self.argv, self.record, self.counters = argv, record, counters

    def __enter__(self):
        from ratelimiter_tpu_torch import ManualClock, create_limiter
        from ratelimiter_tpu_torch.observability import metrics
        from ratelimiter_tpu_torch.serving.__main__ import parse_args, serve

        self._saved = metrics.DEFAULT
        metrics.DEFAULT = metrics.Registry()
        args = parse_args(self.argv)
        holder = {}

        def make_limiter(cfg):
            lim = create_limiter(cfg, backend=args.backend,
                                 clock=ManualClock(T0), device=args.device)
            holder["rec"] = RecordingLimiter(lim, T0)
            return holder["rec"]

        started = queue.Queue()

        async def main():
            loop = asyncio.get_running_loop()
            ready = loop.create_future()
            self._stop = asyncio.Event()
            self._loop = loop
            task = asyncio.ensure_future(serve(
                args, make_limiter=make_limiter if self.record else None,
                ready=ready, stop=self._stop))
            done, _ = await asyncio.wait({task, ready},
                                         return_when=asyncio.FIRST_COMPLETED)
            if ready in done:
                started.put(ready.result())
            await task

        def run():
            try:
                asyncio.run(main())
            except BaseException as exc:
                started.put(exc)
            started.put(None)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="in-process-binary")
        self._thread.start()
        self._started = started
        svc = started.get(timeout=600)
        if svc is None or isinstance(svc, BaseException):
            self._thread.join(timeout=60)
            metrics.DEFAULT = self._saved
            raise AssertionError(f"the binary did not start: {svc!r}")
        svc.args = args
        svc.rec = holder.get("rec")
        svc.taps = []
        if svc.auditor is not None and self.record:
            aud, offer = svc.auditor, svc.auditor._offer

            def recorded(kind, data, ns, now, result, slice_idx):
                before = aud.dropped_frames
                offer(kind, data, ns, now, result, slice_idx)
                svc.taps.append((kind, data, ns, now,
                                 np.array(result.allowed, dtype=bool),
                                 aud.dropped_frames != before))

            aud._offer = recorded
        for mod in self.counters:
            mod.reset_launch_counts()
        self.svc = svc
        return svc

    def __exit__(self, *exc):
        from ratelimiter_tpu_torch.observability import metrics, tracing

        try:
            self._loop.call_soon_threadsafe(self._stop.set)
            self._thread.join(timeout=300)
            if self._thread.is_alive():
                raise AssertionError("the binary did not stop")
            left = self._started.get(timeout=5)
            if isinstance(left, BaseException) and exc[0] is None:
                raise AssertionError(f"the binary failed: {left!r}")
        finally:
            tracing.disable()
            metrics.DEFAULT = self._saved


def _string_rows(log, replayed, prefix: str) -> dict:
    """{key: [(n, Result), ...]} for the keys starting with ``prefix`` in
    the recorded string windows, in replay order."""
    rows: dict = {}
    for (kind, a, ns, _), res in zip(log, replayed):
        if kind != "keys":
            continue
        for i, k in enumerate(a):
            if k.startswith(prefix):
                rows.setdefault(k, []).append((int(ns[i]), res.result(i)))
    return rows


def hold_http_answers(name: str, log, replayed, http: dict) -> int:
    """Every /v1/allow answer of ``gateway_client`` against its row of the
    CPU replay: the status (200 or 429), the four ``X-RateLimit-*``
    values and ``Retry-After`` (on a 429), the traceparent echoed, and
    the JSON body. Each key's answers are matched to its rows in order
    (one thread asks for a key, one request at a time). Returns the
    number of answers held."""
    rows = _string_rows(log, replayed, "http:")
    held = 0
    for th in http["threads"]:
        for key, n, status, hdrs, body, tp in th["rows"]:
            if not rows.get(key):
                raise AssertionError(f"{name}: an answer for {key} has no "
                                     f"row in the recorded windows")
            n_row, r = rows[key].pop(0)
            want_hdrs = {
                "X-RateLimit-Limit": str(r.limit),
                "X-RateLimit-Remaining": str(r.remaining),
                "X-RateLimit-Reset": str(int(r.reset_at)),
                "Retry-After": (None if r.allowed
                                else str(max(1, int(r.retry_after)))),
                "traceparent": tp}
            want_body = {"allowed": bool(r.allowed), "limit": int(r.limit),
                         "remaining": int(r.remaining),
                         "retry_after": float(r.retry_after),
                         "reset_at": float(r.reset_at),
                         "fail_open": bool(r.fail_open)}
            if (n_row != n or status != (200 if r.allowed else 429)
                    or hdrs != want_hdrs or body != want_body):
                raise AssertionError(
                    f"{name}: {key} answered {status} {hdrs} {body}; the "
                    f"replay {want_hdrs} {want_body} (n {n_row} vs {n})")
            held += 1
    left = sum(map(len, rows.values()))
    if left:
        raise AssertionError(f"{name}: {left} recorded HTTP rows got no "
                             f"answer")
    return held


def without_keys(log, replayed, prefixes=("http:", "lever:", "prof:")):
    """The recorded windows and their replayed results without the rows
    of keys starting with ``prefixes`` (the HTTP, lever and profile-time
    requests), so
    the binary frames can be held as ``check_door`` holds them."""
    from ratelimiter_tpu_torch.core.types import BatchResult

    out_log, out_res = [], []
    for entry, res in zip(log, replayed):
        kind, a, ns, now = entry
        if kind != "keys":
            out_log.append(entry)
            out_res.append(res)
            continue
        keep = [i for i, k in enumerate(a) if not k.startswith(prefixes)]
        if not keep:
            continue
        out_log.append(("keys", [a[i] for i in keep], [ns[i] for i in keep],
                        now))
        out_res.append(BatchResult(
            allowed=res.allowed[keep], limit=res.limit,
            remaining=res.remaining[keep],
            retry_after=res.retry_after[keep],
            reset_at=res.reset_at[keep], fail_open=res.fail_open))
    return out_log, out_res


def recompute_audit(cfg, taps, twin_width: int) -> dict:
    """The auditor's tally recomputed from its recorded offers (those not
    dropped, in offer order) through the port's ``ShadowComparator`` on
    the CPU: the plain twin and the host oracle."""
    from ratelimiter_tpu_torch.evaluation.compare import ShadowComparator
    from ratelimiter_tpu_torch.ops.hashing import (
        hash_prefixed_u64,
        splitmix64,
    )

    comp = ShadowComparator(cfg, include_twin=True, twin_width=twin_width,
                            device="cpu")
    frames = 0
    for kind, data, ns, now, allowed, dropped in taps:
        if dropped:
            continue
        if kind == "ids":
            h64 = splitmix64(np.asarray(data, dtype=np.uint64))
        elif kind == "hashed":
            h64 = np.asarray(data, dtype=np.uint64)
        else:
            h64 = hash_prefixed_u64(list(data), cfg.prefix)
        comp.observe(h64, (np.ones(h64.shape[0], dtype=np.int64)
                           if ns is None
                           else np.asarray(ns, dtype=np.int64)),
                     now, allowed)
        frames += 1
    t = comp.tally
    comp.close()
    return {"samples": t.requests, "audited_frames": frames,
            "oracle_allows": t.oracle_allows,
            "false_denies": t.false_denies_vs_oracle,
            "false_allows": t.false_allows_vs_oracle,
            "semantic_disagreements": t.semantic_disagreements,
            "cms_false_deny_rate": round(t.cms_false_deny_rate, 8),
            "false_deny_rate": round(t.false_deny_rate, 8)}


def hold_health(name: str, health: dict, svc, hier=None) -> dict:
    """The /healthz blocks against their sources, read in-process with no
    traffic in between: the decisions, overrides and connections, the
    sketch envelope (or the debt slab), the side table's consumers, the
    hierarchy, the journal, the audit headline and the persistence
    status; the SLO block's windows present."""
    from ratelimiter_tpu_torch.observability import events
    from ratelimiter_tpu_torch.serving import __main__ as binary

    lim = svc.limiter
    want = {"serving": True,
            "decisions_total": svc.server.batcher.decisions_total,
            "policy_overrides": lim.override_count(),
            "transport": svc.server.transport_stats(),
            "member": svc.member_info()}
    unit = binary._units([lim])[0]
    if hasattr(unit, "_period_mass"):
        masses = unit.in_window_admitted_mass()
        want.update(overload_periods=unit.overload_periods,
                    in_window_admitted_mass=masses,
                    mass_budget=unit.mass_budget,
                    shards_overloaded=int(masses > unit.mass_budget),
                    overload_policy=unit.config.sketch.overload_policy)
    if hasattr(unit, "debt_slab_stats"):
        st = unit.debt_slab_stats()
        want["debt_slab"] = {k: st[k] for k in ("occupancy", "collision_p",
                                                "nonzero_cells", "cells")}
        want["debt_slab"]["units"] = 1
    if getattr(unit, "has_hh", False):
        st = unit.consumer_stats(k=10)
        want["consumers"] = {
            "slots": st["slots"], "occupied": st["occupied"],
            "tracked_mass": st.get("tracked_mass", 0),
            "top": [{**r, "slice": 0} for r in st["top"]]}
    if svc.auditor is not None:
        st = svc.auditor.status()
        want["audit"] = {k: st[k] for k in (
            "sample", "samples", "false_deny_rate", "false_deny_wilson95",
            "false_allow_rate", "false_denies", "false_allows",
            "oracle_allows", "fail_open_samples", "dropped_decisions",
            "oracle_errors")}
    if svc.hier is not None:
        st = svc.hier.hierarchy_stats()
        if svc.controller is not None:
            c = svc.controller
            st["controller"] = {"ticks": c.ticks, "tightened": c.tightened,
                                "relaxed": c.relaxed,
                                "interval": c.interval}
        want["hierarchy"] = st
    if events.JOURNAL is not None:
        want["events"] = events.JOURNAL.status()
    if svc.persist is not None:
        want.update(svc.persist.status())
    got = {k: v for k, v in health.items() if k != "slo"}
    # The age of the last snapshot grows between the two reads.
    age = "last_snapshot_age_s"
    if age in want and not got.pop(age, None) <= want.pop(age):
        raise AssertionError(f"{name}: /healthz snapshot age "
                             f"{health[age]} past its source's")
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise AssertionError(f"{name}: /healthz blocks {diff} differ from "
                             f"their sources: {[got.get(k) for k in diff]} "
                             f"vs {[want.get(k) for k in diff]}")
    if svc.slo is not None and sorted(health["slo"]["windows"]) != [
            "300s", "3600s"]:
        raise AssertionError(f"{name}: /healthz slo block {health['slo']}")
    return sorted(health)


def hold_metrics_text(name: str, text: str, decisions: int,
                      audit: bool) -> dict:
    """/metrics after the last decision: the requests and decision
    counters equal to the decisions served over both doors, and with
    ``--audit`` the audit and SLO gauges."""
    out = hold_door_metrics(name, text, decisions, DEFAULT_STACK)
    if not any(line.startswith("rate_limiter_member_info{")
               and line.split()[-1] in ("1", "1.0")
               for line in text.splitlines()):
        raise AssertionError(f"{name}: no rate_limiter_member_info gauge")
    metric_value(text, 'rate_limiter_transport_connections{transport="tcp"}')
    if audit:
        for g in ("rate_limiter_audit_samples",
                  "rate_limiter_audit_false_deny_rate",
                  'rate_limiter_slo_burn_rate{window="300s"}',
                  'rate_limiter_slo_availability_bad_fraction'
                  '{window="3600s"}'):
            metric_value(text, g)
        out["audit_samples"] = int(metric_value(
            text, "rate_limiter_audit_samples"))
    return out


def _drive_both(svc, *, seed: int, space: str, conns: int, frames: int,
                n_ids: int, n_keys: int, depth: int, ns: list,
                threads: int = HTTP_THREADS, requests: int = HTTP_REQUESTS,
                keys: int = HTTP_KEYS, during=None) -> tuple:
    """The door client (binary frames) and the HTTP client, each in a
    child process, at once; ``during()`` runs beside them in this
    process. Returns (door, http, during's result)."""
    import concurrent.futures as cf

    door_args = {"port": svc.server.port, "conns": conns, "frames": frames,
                 "n_ids": n_ids, "n_keys": n_keys, "depth": depth,
                 "space": space, "seed": seed}
    http_args = {"port": svc.gateway.port, "threads": threads,
                 "requests": requests, "keys": keys, "seed": seed,
                 "space": space, "ns": ns}
    with cf.ThreadPoolExecutor(3) as ex:
        side = ex.submit(during) if during is not None else None
        door = ex.submit(_run_door_client, door_args, 600.0)
        http = ex.submit(_run_door_client, http_args, 600.0,
                         "gateway_client")
        return door.result(), http.result(), (side.result() if side
                                              else None)


def profile_capture(http: int, key: str = "p") -> dict:
    """GET /debug/profile?seconds=1 (debug token) on the gateway at
    ``http`` once a decision has reached the batcher, while a thread of
    this process sends /v1/allow requests one at a time until the capture
    answers (a process's first capture pays the profiler's initialization
    first, ~10 s, so a client's finite traffic may be over by then): the
    kernel names in its trace, its seconds, and the requests sent during
    it and in all."""
    import os
    import shutil

    stop, sent = threading.Event(), [0]

    def traffic():
        while not stop.is_set():
            http_call(http, "GET", f"/v1/allow?key={key}{sent[0] % 512}")
            sent[0] += 1

    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    try:
        deadline = time.time() + 120
        while not http_call(http, "GET", "/healthz")[2]["decisions_total"]:
            if time.time() > deadline:
                raise AssertionError("no request reached the batcher")
            time.sleep(0.01)
        n0, t = sent[0], time.perf_counter()
        status, _, body = http_call(http, "GET", "/debug/profile?seconds=1",
                                    TOKENS["debug"])
        seconds, during = time.perf_counter() - t, sent[0] - n0
    finally:
        stop.set()
        th.join(timeout=120)
    if status != 200:
        raise AssertionError(f"/debug/profile answered {status}: {body}")
    with open(os.path.join(body["dir"], "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    shutil.rmtree(body["dir"], ignore_errors=True)
    return {"body": body, "seconds": seconds, "requests_during": during,
            "requests": sent[0], "names": sorted({e.get("name", "") for e in events
                             if e.get("cat") == "kernel"})}


def _profile_during(svc) -> dict:
    """``profile_capture`` on the in-process binary's gateway, its
    /v1/allow keys apart from the checked traffic's."""
    return profile_capture(svc.gateway.port, key="prof:")


def check_gateway(torch, cfg, label: str, *, device: str = "cuda",
                  seed: int = 0, space: str = "zipf", ns=(5, 15, 30),
                  conns: int = DOOR_CONNS, frames: int = DOOR_FRAMES,
                  n_ids: int = DOOR_IDS, n_keys: int = DOOR_KEYS,
                  depth: int = DOOR_DEPTH, threads: int = HTTP_THREADS,
                  requests: int = HTTP_REQUESTS, counters=(), front=None,
                  update=None, front_per_reset: int = 0,
                  required=()) -> dict:
    """Phase gateway (a)-(e) on one cell: the port's binary (its own
    ``serve``, in-process through ``in_process_binary`` with the recording
    proxy) under ``cfg``'s flags with ``--http-port``, every lever and
    its token, ``--flight-recorder`` and ``--audit --audit-sample 1
    --audit-twin``; binary frames (``door_client``) and /v1/allow
    requests (``gateway_client``) at once.

    (a) every binary frame and every HTTP answer bit-identical to a CPU
        replay of the recorded windows (status, ``X-RateLimit-*``,
        ``Retry-After``, traceparent, body), the final state too;
    (b) after the auditor's flush, /debug/audit's integers equal to a
        recomputation of its recorded offers through the port's
        ``ShadowComparator`` on the CPU; on the card, ``front`` launched
        for every window, reset (``front_per_reset``) and twin step, the
        admission as often as ``update`` (no composed back);
    (c) /healthz's blocks equal to their sources, /metrics with the audit
        and SLO gauges and its decision counters equal to the decisions
        served over both doors;
    (d) /v1/policy PUT, GET, DELETE, /v1/reset (one
        ``window_reset`` launch on the card for the windowed cells) each
        403 without its token and 200 with it, their events in
        /debug/events;
    (e) a traced request's spans under its traceparent's id in
        /debug/trace, and /debug/profile?seconds=1 during the
        traffic naming the step's kernels (on the card).
    Returns the readings."""
    from ratelimiter_tpu_torch.observability.tracing import (
        format_traceparent,
    )

    name = f"gateway[{label}]"
    argv = gateway_args(cell_flags(cfg), device=device, extra=(
        *TOKEN_FLAGS, "--flight-recorder", "--audit", "--audit-sample", "1",
        "--audit-twin"))
    bucket = cfg.algorithm.value == "token_bucket"
    out: dict = {}
    with in_process_binary(argv, record=True, counters=counters) as svc:
        port = svc.gateway.port
        during = ((lambda: _profile_during(svc)) if device == "cuda"
                  else None)
        t0 = time.perf_counter()
        door, http, prof = _drive_both(
            svc, seed=seed, space=space, conns=conns, frames=frames,
            n_ids=n_ids, n_keys=n_keys, depth=depth, ns=list(ns),
            threads=threads, requests=requests, during=during)
        out["traffic_s"] = time.perf_counter() - t0
        pol = "/v1/policy?key=lever:vip"
        body = gated(port, "PUT", pol + "&limit=7", TOKENS["policy"],
                     f"{name} policy PUT")
        if body["limit"] != 7:
            raise AssertionError(f"{name}: policy PUT answered {body}")
        if gated(port, "GET", pol, TOKENS["policy"],
                 f"{name} policy GET")["limit"] != 7:
            raise AssertionError(f"{name}: policy GET lost the limit")
        st, hdrs, _ = http_call(port, "GET", "/v1/allow?key=lever:vip")
        if st != 200 or hdrs["X-RateLimit-Limit"] != "7":
            raise AssertionError(f"{name}: the override did not apply "
                                 f"({st} {hdrs})")
        if not gated(port, "DELETE", pol, TOKENS["policy"],
                     f"{name} policy DELETE")["deleted"]:
            raise AssertionError(f"{name}: policy DELETE deleted none")
        resets = {}
        for mod in counters:
            resets.update(mod.launch_counts())
        gated(port, "POST", "/v1/reset?key=lever:vip", TOKENS["reset"],
              f"{name} reset")
        after = {}
        for mod in counters:
            after.update(mod.launch_counts())
        if device == "cuda" and not bucket and (
                after.get("window_reset", 0)
                - resets.get("window_reset", 0)) != 1:
            raise AssertionError(f"{name}: /v1/reset launched "
                                 f"{after} after {resets}")
        evs = gated(port, "GET", "/debug/events?tail=16",
                    TOKENS["debug"], f"{name} events")["events"]
        got_evs = [(e["action"], e["actor"]) for e in evs
                   if e["category"] == "policy"]
        if got_evs[-3:] != [("set-override", "http"),
                            ("delete-override", "http"),
                            ("reset", "http")]:
            raise AssertionError(f"{name}: /debug/events {got_evs}")
        tid = int(np.random.default_rng(seed).integers(1, 1 << 62))
        st, hdrs, _ = http_call(port, "GET", "/v1/allow?key=lever:traced",
                                headers={"traceparent":
                                         format_traceparent(tid)})
        if st != 200 or hdrs.get("traceparent") != format_traceparent(
                tid):
            raise AssertionError(f"{name}: traced request {st} {hdrs}")
        trace = gated(port, "GET", "/debug/trace", TOKENS["debug"],
                      f"{name} trace")
        spans = {e["name"] for e in trace["traceEvents"]
                 if e["args"]["trace_id"] == f"{tid:016x}"}
        want_spans = {"http", "coalesce", "queue", "launch", "device",
                      "resolve"}
        if not want_spans <= spans:
            raise AssertionError(f"{name}: the traced request's spans "
                                 f"{sorted(spans)}")
        out["traced_spans"] = sorted(spans)
        if prof is not None:
            kern = ("bucket_front_kernel", "bucket_admit_kernel",
                    "bucket_update_kernel") if bucket else (
                "window_front_kernel", "window_admit_kernel",
                "cu_update_kernel")
            names = " ".join(prof["names"])
            missing = [k for k in kern if k not in names]
            if missing:
                raise AssertionError(f"{name}: /debug/profile's trace "
                                     f"lacks {missing}")
            out["profile"] = {"files": prof["body"]["files"],
                              "seconds": prof["seconds"],
                              "kernels": len(prof["names"])}
        t = time.perf_counter()
        if not svc.auditor.flush(timeout=300):
            raise AssertionError(f"{name}: the auditor did not drain")
        out["flush_s"] = time.perf_counter() - t
        audit_st = gated(port, "GET", "/debug/audit", TOKENS["audit"],
                         f"{name} audit")
        st, _, health = http_call(port, "GET", "/healthz")
        out["health_blocks"] = hold_health(name, health, svc)
        metrics_text = http_call(port, "GET", "/metrics")[2]
        counts = {}
        for mod in counters:
            counts.update(mod.launch_counts())
        if device == "cuda":
            torch.cuda.synchronize()
        rec = svc.rec
        served = rec.inner
        _, served_arrays, _ = served.capture_state()
        served_cfg = served.config
        taps = list(svc.taps)
        twin_width = svc.auditor.twin_width
        audit_cfg = svc.auditor.config
    errors = [e for o in door["conns"] for e in o["errors"]]
    if errors:
        raise AssertionError(f"{name}: error replies {errors[:3]}")
    replayed, cpu = replay_windows(served_cfg, rec.log)
    out["http_answers"] = hold_http_answers(name, rec.log, replayed, http)
    flog, frep = without_keys(rec.log, replayed)
    _hold_door_frames(name, flog, frep, door["conns"], n_ids, n_keys)
    _, cpu_arrays, _ = cpu.capture_state()
    cpu.close()
    for k, v in cpu_arrays.items():
        # The lever's override was set and deleted outside the recording.
        if not k.startswith("policy") and not np.array_equal(
                served_arrays[k], v):
            raise AssertionError(f"{name}: final state {k} differs from "
                                 f"the CPU replay")
    # (b) the audit tally.
    want = recompute_audit(audit_cfg, taps, twin_width)
    got = {k: audit_st[k] for k in want}
    if got != want or audit_st["oracle_errors"] or \
            audit_st["fail_open_samples"]:
        raise AssertionError(f"{name}: /debug/audit {audit_st}; the CPU "
                             f"recomputation {want}")
    dropped = [t for t in taps if t[5]]
    out["audit"] = {"status": {k: audit_st[k] for k in (
        "samples", "audited_frames", "oracle_allows", "false_denies",
        "false_allows", "false_deny_rate", "false_deny_wilson95",
        "cms_false_deny_rate", "semantic_disagreements", "dropped_frames",
        "dropped_decisions", "twin")},
        "offered_frames": len(taps), "dropped_frames": len(dropped),
        "dropped_decisions": sum(len(t[4]) for t in dropped),
        "twin_width": twin_width}
    windows = sum(kind != "reset" for kind, *_ in rec.log)
    resets = sum(kind == "reset" for kind, *_ in rec.log)
    twin_steps = want["audited_frames"]
    decisions = (sum(len(r[0]) for o in door["conns"] for r in o["hashed"])
                 + sum(len(r[0]) for o in door["conns"]
                       for r in o["strings"])
                 + sum(len(th["rows"]) for th in http["threads"])
                 + (prof["requests"] if prof is not None else 0)
                 + 2)    # the levers' two /v1/allow requests
    out["metrics"] = hold_metrics_text(name, metrics_text, decisions, True)
    if device == "cuda":
        for k in required:
            if counts.get(k, 0) == 0:
                raise AssertionError(f"{name}: {k} was not launched")
        if counts[front] != windows + front_per_reset * resets + twin_steps:
            raise AssertionError(
                f"{name}: {counts[front]} {front} launches for {windows} "
                f"windows, {resets} resets and {twin_steps} twin steps")
        if not counts["admit"] == counts[update] == windows + twin_steps:
            raise AssertionError(
                f"{name}: {counts['admit']} admissions and "
                f"{counts[update]} {update} launches for {windows} windows "
                f"and {twin_steps} twin steps: a composed back ran")
    out.update(counts=counts, windows=windows, resets=resets,
               twin_steps=twin_steps, decisions=decisions,
               door_frames=sum(len(o["hashed"]) + len(o["strings"])
                               for o in door["conns"]),
               http_requests=sum(len(th["rows"]) for th in http["threads"]),
               http_wall_s=http["wall_s"], door_wall_s=door["wall_s"])
    where = card_line() if device == "cuda" else "the CPU"
    log(f"{name} on {where}: {out['door_frames']} binary frames and "
        f"{out['http_requests']} HTTP requests at once ({decisions} "
        f"decisions, {windows} windows, {resets} resets), every answer "
        f"bit-identical to the CPU replay; the auditor's tally (sample 1, "
        f"twin w={twin_width}) equal to the CPU recomputation: "
        f"{out['audit']['status']}; {out['audit']['offered_frames']} frames "
        f"offered, {out['audit']['dropped_frames']} dropped, flush "
        f"{out['flush_s']:.3f} s; /healthz blocks {out['health_blocks']} "
        f"equal to their sources; launches {counts}")
    return out


def check_gateway_tenants(torch, cfg, *, device: str = "cuda",
                          seed: int = 0) -> dict:
    """Phase gateway (c), (d) and (f) on the tenant binary: the
    documented deployment (``tenant_flags``) with ``--controller
    --controller-interval 0.2 --audit --audit-sample 1``, ``--http-port``
    and the tokens, in-process. The hot-tenant storm of
    ``tenant_storm`` through binary frames; the controller must journal
    a move on it (a tighten, or a tighten the audit's false-deny bound
    vetoed) whose signals show the SLO burn rate or the audit's bound
    it read as nonzero. /v1/tenants: GET (403 without the token) equal
    to ``hierarchy_stats`` with the effective limits, a tenant's limit
    changed, then the tenant deleted. Then, the controller stopped and
    the auditor drained, /healthz's blocks equal to their sources and
    /metrics' decision counters to the decisions served."""
    name = "gateway[tenants]"
    argv = gateway_args(cell_flags(cfg) + tenant_flags(), device=device,
                        extra=(*TOKEN_FLAGS, "--controller",
                               "--controller-interval", "0.2", "--audit",
                               "--audit-sample", "1"))
    with in_process_binary(argv) as svc:
        port = svc.gateway.port
        c = DoorClient(svc.server.port)
        try:
            free = tenant_storm(c)
        finally:
            c.close()
        deadline = time.time() + 20
        while True:
            evs = gated(port, "GET", "/debug/events?category=controller"
                        "&tail=64", TOKENS["debug"], f"{name} events")
            moves = [e for e in evs["events"]
                     if e["action"] in ("tighten", "tighten-vetoed")]
            if moves or time.time() > deadline:
                break
            time.sleep(0.1)
        if not moves:
            raise AssertionError(f"{name}: the controller journaled no move "
                                 f"under the storm")
        signals = [(e["action"], e["payload"]["burn_rate"],
                    e["payload"]["false_deny_wilson_high"]) for e in moves]
        if not any(b > 0 or f > 0 for _, b, f in signals):
            raise AssertionError(f"{name}: the controller's moves read a "
                                 f"zero SLO burn and audit bound: {signals}")
        svc.controller.stop()
        st = gated(port, "GET", "/v1/tenants", TOKENS["tenants"],
                   f"{name} GET /v1/tenants")
        want = svc.hier.hierarchy_stats()
        want["effective"] = svc.hier.effective_limits()
        if st != json.loads(json.dumps(want)):
            raise AssertionError(f"{name}: GET /v1/tenants {st}; the "
                                 f"hierarchy {want}")
        last = CASC_OTHERS[-1][0]
        body = gated(port, "POST", f"/v1/tenants?name={last}&limit=1234"
                     "&weight=2", TOKENS["tenants"], f"{name} POST")
        if (body["limit"], body["weight"]) != (1234, 2) or \
                svc.hier.effective_limits().get(last) != 1234:
            raise AssertionError(f"{name}: POST /v1/tenants {body}")
        if not gated(port, "DELETE", f"/v1/tenants?name={last}",
                     TOKENS["tenants"], f"{name} DELETE")["deleted"]:
            raise AssertionError(f"{name}: DELETE /v1/tenants deleted none")
        if not svc.auditor.flush(timeout=300):
            raise AssertionError(f"{name}: the auditor did not drain")
        health = http_call(port, "GET", "/healthz")[2]
        blocks = hold_health(name, health, svc)
        text = http_call(port, "GET", "/metrics")[2]
        metrics_out = hold_metrics_text(
            name, text, svc.server.batcher.decisions_total, True)
        audit_st = svc.auditor.status()
    out = {"free_effective": free, "moves": signals,
           "health_blocks": blocks, "metrics": metrics_out,
           "audit_samples": audit_st["samples"],
           "false_deny_wilson95": audit_st["false_deny_wilson95"]}
    where = card_line() if device == "cuda" else "the CPU"
    log(f"{name} on {where}: under the storm free's effective limit "
        f"{free:g}; the controller journaled {signals[:3]} (action, burn "
        f"rate, audit false-deny bound); /v1/tenants GET equal to "
        f"hierarchy_stats, a tenant changed and deleted; /healthz blocks "
        f"{blocks} equal to their sources")
    return out


def check_gateway_durable(torch, cfg, *, device: str = "cuda",
                          seed: int = 0) -> dict:
    """Phase gateway (c) and (d) on the durable binary (``--snapshot-dir``,
    in-process): a few binary frames and HTTP decisions, POST
    /v1/snapshot (403 without the token) writing the snapshot it names,
    /healthz's blocks (the persistence status among them) equal to their
    sources, /metrics' decision counters equal to the decisions
    served."""
    import os
    import shutil
    import tempfile

    name = "gateway[durable]"
    root = tempfile.mkdtemp(prefix="gateway-durable-")
    argv = gateway_args(cell_flags(cfg), device=device, extra=(
        *TOKEN_FLAGS, "--snapshot-dir", root, "--snapshot-interval",
        "3600"))
    rng = np.random.default_rng(seed + 59)
    try:
        with in_process_binary(argv) as svc:
            port = svc.gateway.port
            c = DoorClient(svc.server.port)
            try:
                for frame in _door_frames(rng, 256, 6):
                    _send(c, frame)
            finally:
                c.close()
            for i in range(16):
                if http_call(port, "GET", f"/v1/allow?key=http:d:{i % 4}"
                             f"&n=30")[0] not in (200, 429):
                    raise AssertionError(f"{name}: /v1/allow failed")
            body = gated(port, "POST", "/v1/snapshot", TOKENS["snapshot"],
                         f"{name} snapshot")
            path = os.path.join(root,
                                f"snap-{body['snapshot_id']:08d}-000.npz")
            if not body["ok"] or not os.path.exists(path):
                raise AssertionError(f"{name}: /v1/snapshot {body}, no "
                                     f"{path}")
            health = http_call(port, "GET", "/healthz")[2]
            blocks = hold_health(name, health, svc)
            text = http_call(port, "GET", "/metrics")[2]
            metrics_out = hold_metrics_text(
                name, text, svc.server.batcher.decisions_total, False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    where = card_line() if device == "cuda" else "the CPU"
    log(f"{name} on {where}: /v1/snapshot wrote snapshot "
        f"{body['snapshot_id']} (WAL seq {body['wal_seq']}); /healthz "
        f"blocks {blocks} equal to their sources")
    return {"snapshot": body, "health_blocks": blocks,
            "metrics": metrics_out}


#: Phase gateway's readings: the door without the auditor, with it at
#: the default sample (1 in 64, no twin), and at sample 1 with the twin.
#: Under ``--gateway`` two more settings split the default auditor's
#: cost: ``timer`` (offers do not wake the worker, which drains on its
#: 0.25 s timer) and ``tap`` (the worker stopped, so the tap alone runs:
#: the queue fills and the tap drops and counts).
AUDIT_READINGS = (("no audit", (), None), ("audit 64", ("--audit",), None),
                  ("audit twin 1", ("--audit", "--audit-twin",
                                    "--audit-sample", "1"), None))
AUDIT_SPLIT = (("audit 64 timer drain", ("--audit",), "timer"),
               ("audit 64 tap only", ("--audit",), "tap"))
#: /v1/allow timing: client threads, and requests in all.
HTTP_READING_THREADS, HTTP_READING_REQUESTS = (8, 32), 1600


class _NoWake(threading.Event):
    """The audit worker's event with ``set`` a no-op: offers no longer
    wake the worker, which drains on its wait's 0.25 s timeout."""

    def set(self) -> None:
        pass


def audit_mode(aud, mode) -> None:
    """Apply an ``AUDIT_SPLIT`` setting to the running auditor."""
    if mode == "timer":
        aud._wake = _NoWake()
    elif mode == "tap":
        aud._stop.set()
        aud._wake.set()
        aud._thread.join(timeout=30)
        # flush() then drains what is queued on the caller's thread.
        aud._thread = None


def thread_cpu_s(thread) -> float:
    """CPU seconds a live thread has run (its POSIX thread clock)."""
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


def gateway_readings(seed: int = 0, rounds: int = 3,
                     device: str = "cuda", conns: int = DOOR_CONNS,
                     frames: int = DOOR_FRAMES, n_ids: int = DOOR_IDS,
                     n_keys: int = DOOR_KEYS,
                     http_requests: int = HTTP_READING_REQUESTS,
                     split: bool = False, http: bool = True) -> dict:
    """Phase gateway's numbers on windowed CU, the binary's own
    ``serve`` in-process with no recording proxy: the door's decisions/s
    and frame latency under each of ``AUDIT_READINGS`` (and with
    ``split`` each of ``AUDIT_SPLIT``), in turns, ``rounds`` rounds on
    the same traffic, with the process's CPU seconds over the traffic,
    the audit worker's, the auditor's audited and dropped frames and
    decisions and its seconds to flush once the traffic ends; then, with
    ``http``, /v1/allow requests/s and latency p50/p99 at each of
    ``HTTP_READING_THREADS`` client threads (string keys of config 3's
    traffic, one keep-alive connection a thread) and the requests a
    dispatch carried. Smoke readings: nothing is gated on them but the
    door's own checks (``_door_readings``)."""
    settings = AUDIT_READINGS + (AUDIT_SPLIT if split else ())
    runs: dict = {}
    for _ in range(rounds):
        for label, extra, mode in settings:
            argv = gateway_args(cell_flags(config3()), device=device,
                                extra=extra)
            with in_process_binary(argv) as svc:
                aud = svc.auditor
                audit_mode(aud, mode)
                worker = aud._thread if aud is not None else None
                w0 = thread_cpu_s(worker) if worker is not None else 0.0
                c0 = time.process_time()
                got = _run_door_client(
                    {"port": svc.server.port, "conns": conns,
                     "frames": frames, "n_ids": n_ids, "n_keys": n_keys,
                     "depth": DOOR_DEPTH, "space": "zipf",
                     "seed": seed + 17}, 600.0)
                cpu = time.process_time() - c0
                r = _door_readings(f"gateway door [{label}]", got)
                r["process_cpu_s"] = cpu
                if worker is not None:
                    r["worker_cpu_s"] = thread_cpu_s(worker) - w0
                if aud is not None:
                    t = time.perf_counter()
                    if not aud.flush(timeout=300):
                        raise AssertionError(f"{label}: the auditor did "
                                             f"not drain")
                    r["flush_s"] = time.perf_counter() - t
                    st = aud.status()
                    # The batcher taps each window once.
                    r.update(offered_frames=r["dispatches"],
                             audited_frames=st["audited_frames"],
                             samples=st["samples"],
                             dropped_frames=st["dropped_frames"],
                             dropped_decisions=st["dropped_decisions"])
            runs.setdefault(label, []).append(r)
    out = {"door": {}}
    for label, rs in runs.items():
        out["door"][label] = {k: [r.get(k) for r in rs] for k in (
            "decisions_per_s", "p50_ms", "p99_ms", "frames_per_dispatch",
            "wall_s", "process_cpu_s", "worker_cpu_s", "flush_s",
            "offered_frames", "audited_frames", "samples",
            "dropped_frames", "dropped_decisions")}
        log(f"gateway door readings [{label}] (rounds): "
            + "; ".join(f"{k} {v}" for k, v in out["door"][label].items()
                        if v[0] is not None))
    argv = gateway_args(cell_flags(config3()), device=device)
    out["http"] = {}
    for threads in HTTP_READING_THREADS if http else ():
        with in_process_binary(argv) as svc:
            got = _run_door_client(
                {"port": svc.gateway.port, "threads": threads,
                 "requests": http_requests // threads, "keys": 0,
                 "seed": seed + 23, "space": "zipf", "ns": [1]}, 600.0,
                "gateway_client")
            text = http_call(svc.gateway.port, "GET", "/metrics")[2]
        lat = np.array([x for th in got["threads"] for x in th["latency"]])
        dispatches = metric_value(text,
                                  "rate_limiter_server_batch_size_count")
        out["http"][threads] = {
            "requests": int(lat.size),
            "requests_per_s": lat.size / got["wall_s"],
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "requests_per_dispatch": lat.size / dispatches}
        log(f"gateway /v1/allow [{threads} threads]: "
            f"{out['http'][threads]}")
    return out


#: What a /debug/profile capture of windowed CU must name.
PROFILE_KERNELS = ("window_front_kernel", "window_admit_kernel",
                   "cu_update_kernel")


def check_binary_profile(device: str = "cuda") -> dict:
    """(e) on the binary as it runs: ``python -m ratelimiter_tpu_torch.
    serving`` (config 3, ``--debug-token``) as a child process, its
    first profiler capture (``profile_capture``, on a gateway thread,
    with /v1/allow traffic meanwhile) must name the step's kernels on the
    card, and the binary must exit 0 on SIGTERM. Returns the capture's
    seconds (the first pays the profiler's initialization), whether the
    binary's output holds Kineto's thread message, and the requests
    sent during it."""
    argv = gateway_args(cell_flags(config3()), device=device,
                        extra=("--debug-token", TOKENS["debug"]))
    srv = ServerProcess(argv)
    try:
        got = profile_capture(srv.http)
    finally:
        rc = srv.terminate()
    names = " ".join(got["names"])
    missing = [k for k in PROFILE_KERNELS if device == "cuda"
               and k not in names]
    out = {"seconds": got["seconds"], "requests_during":
           got["requests_during"], "kernels": len(got["names"]),
           "thread_message": any("External init callback" in line
                                 for line in srv.output), "rc": rc}
    if missing or rc != 0:
        raise AssertionError(f"binary /debug/profile: kernels missing "
                             f"{missing}, exit code {rc}")
    where = card_line() if device == "cuda" else "the CPU"
    log(f"binary /debug/profile on {where}: {out}")
    return out


def run_gateway(torch, seed: int = 0, alone: bool = False) -> dict:
    """Phase gateway: (a)-(e) on windowed CU with the side table (config
    3, ``--hh-slots 256``) and on TB-c2 (8 x 24 binary frames a cell in
    the whole run, 8 x 48 under ``--gateway``), (c), (d) and (f) on the
    tenant and durable binaries, (e) on the binary as a child process,
    then the readings: the door's, one round, in the whole run; ``alone``
    (``--gateway``) takes three, splits the auditor's cost and times
    /v1/allow."""
    from ratelimiter_tpu_torch.ops import bucket_cuda, sketch_cuda

    t = time.perf_counter()
    # The whole run checks 8 x 24 frames a cell (its time limit is
    # shared with every later phase), ``--gateway`` 8 x 48.
    frames = DOOR_FRAMES if alone else DOOR_FRAMES // 2
    out = {"windowed": check_gateway(
        torch, config3_hh(), f"windowed CU hh_slots={HH_SLOTS}",
        seed=seed + 89, frames=frames, counters=[sketch_cuda],
        front="window_estimate",
        update="cu_update", required=("window_estimate", "admit",
                                      "cu_update", "hh_update [fused]",
                                      "window_reset"))}
    out["TB-c2"] = check_gateway(
        torch, config2_bucket(), "TB-c2", seed=seed + 97, space="c2",
        frames=frames, ns=(1, 4, 9), counters=[bucket_cuda],
        front="bucket_estimate",
        update="bucket_update", front_per_reset=1,
        required=("bucket_estimate", "admit", "bucket_update"))
    out["tenants"] = check_gateway_tenants(torch, config3(), seed=seed)
    out["durable"] = check_gateway_durable(torch, config3(), seed=seed)
    out["binary_profile"] = check_binary_profile()
    out["readings"] = gateway_readings(seed, rounds=3 if alone else 1,
                                       split=alone, http=alone)
    out["seconds"] = time.perf_counter() - t
    log(f"phase gateway on {card_line()}: {out['seconds']:.1f} s")
    return out


# ------------------------------------------ phase native: the C++ door

NATIVE_TRANSPORTS = ("tcp", "uds", "shm")


async def _native_conn(host: str, port: int, transport: str, c: int,
                       frames: int, n_ids: int, n_keys: int, depth: int,
                       space: str, seed: int):
    """One connection of the port's AsyncClient over ``transport``:
    ``frames`` decision frames pipelined (at most ``depth`` unanswered),
    the door's traffic of ``_door_conn`` (connection 0 also resets a key
    halfway)."""
    from ratelimiter_tpu_torch.serving.client import AsyncClient

    rng = np.random.default_rng(seed * 1000 + c)
    client = await AsyncClient.connect(host, port, transport=transport,
                                       retries=0)
    window = asyncio.Semaphore(depth)
    out = {"hashed": [], "strings": [], "latency": [], "errors": []}

    async def one(kind, payload):
        t0 = time.perf_counter()
        try:
            if kind == "hashed":
                res = await client.allow_hashed(payload)
            elif kind == "strings":
                res = await client.allow_batch(payload)
            else:
                await client.reset(payload)
                return
        except Exception as exc:  # noqa: BLE001 — reported, then failed
            out["errors"].append(repr(exc))
            return
        finally:
            window.release()
        out["latency"].append(time.perf_counter() - t0)
        if kind == "hashed":
            out["hashed"].append((payload, np.array(res.allowed),
                                  np.array(res.remaining),
                                  np.array(res.retry_after),
                                  np.array(res.reset_at), res.fail_open))
        else:
            out["strings"].append((payload, [
                (r.allowed, r.remaining, r.retry_after, r.reset_at,
                 r.fail_open) for r in res]))

    tasks = []
    for i in range(frames):
        await window.acquire()
        if i % DOOR_STRING_EVERY == DOOR_STRING_EVERY - 1:
            tasks.append(asyncio.ensure_future(
                one("strings", door_keys(rng, space, n_keys))))
        else:
            tasks.append(asyncio.ensure_future(
                one("hashed", zipf_ids(rng, n_ids))))
        if c == 0 and i == frames // 2:
            await window.acquire()
            tasks.append(asyncio.ensure_future(
                one("reset", door_keys(rng, space, 1)[0])))
    await asyncio.gather(*tasks)
    await client.close()
    return out


async def _native_clients(host: str, port: int, transport: str, conns: int,
                          frames: int, n_ids: int, n_keys: int, depth: int,
                          space: str, seed: int):
    from ratelimiter_tpu_torch.serving.client import AsyncClient

    t, cpu = time.perf_counter(), time.process_time()
    outs = await asyncio.gather(*(
        _native_conn(host, port, transport, c, frames, n_ids, n_keys,
                     depth, space, seed) for c in range(conns)))
    wall, cpu = time.perf_counter() - t, time.process_time() - cpu
    client = await AsyncClient.connect(host, port, transport=transport)
    health, metrics = await client.health(), await client.metrics()
    await client.close()
    return {"conns": outs, "wall_s": wall, "client_cpu_s": cpu,
            "health": health, "metrics": metrics}


def native_door_client() -> None:
    """The native door's client, run in a child process
    (``serve_native_door``): JSON arguments on stdin, ``conns``
    connections of the port's AsyncClient over TCP, a unix socket or the
    shared-memory lane, then HEALTH and METRICS; what it read goes
    pickled to stdout."""
    args = json.loads(sys.stdin.read())
    got = asyncio.run(_native_clients(**args))
    sys.stdout.buffer.write(pickle.dumps(got))
    sys.stdout.flush()


def serve_native_door(limiters, *, seed: int, space: str, conns: int,
                      frames: int, n_ids: int, n_keys: int, depth: int,
                      transport: str = "tcp", counters=(),
                      flags=DEFAULT_STACK, server_kw=None):
    """The port's native door (``NativeRateLimitServer``) with one
    dispatch shard a limiter of ``limiters``, each wrapped as the binary
    wraps it (``door_stack``, shard ``i``'s label), the batcher at the
    binary's defaults (``server_kw`` overrides them), listening on TCP, a
    unix socket (``transport`` "uds") or TCP with the shared-memory lane
    ("shm"), driven by
    ``native_door_client`` in a child process; the launch counts of
    ``counters`` are set to 0 once it listens. Returns (what the client
    read plus the door's ``stats()`` and the server's CPU seconds, the
    stopped door)."""
    import os
    import shutil
    import tempfile

    from ratelimiter_tpu_torch.serving.native_server import (
        NativeRateLimitServer,
    )

    d = tempfile.mkdtemp(prefix="native-door-")
    host = f"unix:{d}/door.sock" if transport == "uds" else "127.0.0.1"
    with door_stack(flags) as (wrap, registry):
        shard_lims = [wrap(lim, i) for i, lim in enumerate(limiters)]
        srv = NativeRateLimitServer(shard_lims[0], host, 0,
                                    registry=registry,
                                    shard_limiters=shard_lims,
                                    shm=transport == "shm", shm_dir=d,
                                    **(server_kw or {}))
        srv.start()
        try:
            for mod in counters:
                mod.reset_launch_counts()
            cpu = time.process_time()
            got = _run_door_client(
                {"host": host, "port": srv.port, "transport": transport,
                 "conns": conns, "frames": frames, "n_ids": n_ids,
                 "n_keys": n_keys, "depth": depth, "space": space,
                 "seed": seed}, 600.0, entry="native_door_client")
            got["server_cpu_s"] = time.process_time() - cpu
            got["stats"] = srv.stats()
        finally:
            srv.shutdown(close_limiters=False)
            left = [f for f in os.listdir(d) if f != "door.sock"]
            shutil.rmtree(d, ignore_errors=True)
    if left:
        raise AssertionError(f"the shared-memory lane left {left}")
    return got, srv


def _frame_rows(conns, prefix: str, srv):
    """Every frame the client read: (kind, finalized hashes, each row's
    shard, the answer's columns, its fail_open), hashed frames first."""
    from ratelimiter_tpu_torch.ops.hashing import hash_prefixed_u64, splitmix64

    n = len(srv.shard_limiters)
    rows = []
    for out in conns:
        for ids, *cols, fo in out["hashed"]:
            h = splitmix64(ids)
            rows.append(("hashed", h, (h % np.uint64(n)).astype(np.int64),
                         cols, fo))
        for keys, res in out["strings"]:
            cols = [np.array([r[i] for r in res]) for i in range(4)]
            rows.append(("strings", hash_prefixed_u64(keys, prefix),
                         np.array([srv.shard_of(k) for k in keys],
                                  dtype=np.int64),
                         cols, any(r[4] for r in res)))
    return rows


def _hold_native_frames(name: str, logs, replays, conns, prefix: str,
                        srv) -> int:
    """Each frame's answer against its rows of the replayed windows of
    its shards. A shard's windows are its frames' rows on that shard, in
    queue order; the dispatcher cuts a string frame only whole, and may
    carve a hashed frame at the ``max_batch`` boundary, its rest opening
    the next hashed window. Returns the frames held."""
    frames = _frame_rows(conns, prefix, srv)
    fields = ("allowed", "remaining", "retry_after", "reset_at")
    want = [[np.empty(len(f[1]), dtype=c.dtype) for c in f[3]]
            for f in frames]
    seen = [np.zeros(len(f[1]), dtype=bool) for f in frames]
    fo_seen = [False] * len(frames)
    for shard, (log, replayed) in enumerate(zip(logs, replays)):
        subs = [np.nonzero(f[2] == shard)[0] for f in frames]
        by_first: dict = {}
        for i, f in enumerate(frames):
            if subs[i].size:
                by_first.setdefault(int(f[1][subs[i][0]]), []).append(i)
        done = [False] * len(frames)
        # A carved hashed frame's head ends a window: (the frames whose
        # rows begin with that tail, the tail's window result, offset and
        # length). Hot keys make short tails ambiguous, so the frame is
        # chosen when its rest opens a later window.
        open_ = None

        def take(i, pos, res, off, count):
            at = subs[i][pos:pos + count]
            for k, f in enumerate(fields):
                want[i][k][at] = getattr(res, f)[off:off + count]
            seen[i][at] = True
            fo_seen[i] |= bool(res.fail_open)

        for (kind, a, _, _), res in zip(log, replayed):
            if kind != "hashed":
                continue
            n, off = len(a), 0
            if open_ is not None:
                cands, t_res, t_off, t_len = open_
                for i in cands:
                    rest = frames[i][1][subs[i][t_len:]]
                    if not done[i] and n >= len(rest) and np.array_equal(
                            a[:len(rest)], rest):
                        take(i, 0, t_res, t_off, t_len)
                        take(i, t_len, res, 0, len(rest))
                        done[i], off, open_ = True, len(rest), None
                        break
            while off < n:
                for i in by_first.get(int(a[off]), ()):
                    sub = frames[i][1][subs[i]]
                    if not done[i] and off + len(sub) <= n and \
                            np.array_equal(a[off:off + len(sub)], sub):
                        take(i, 0, res, off, len(sub))
                        done[i], off = True, off + len(sub)
                        break
                else:
                    cands = [i for i in by_first.get(int(a[off]), ())
                             if not done[i] and frames[i][0] == "hashed"
                             and np.array_equal(
                                 a[off:], frames[i][1][subs[i][:n - off]])]
                    if open_ is not None or not cands:
                        raise AssertionError(f"{name}: shard {shard}'s "
                                             f"window rows {off}+ match no "
                                             f"frame")
                    open_, off = (cands, res, off, n - off), n
        if open_ is not None:
            raise AssertionError(f"{name}: a carved frame never finished "
                                 f"on shard {shard}")
    for i, f in enumerate(frames):
        if not seen[i].all():
            raise AssertionError(f"{name}: {int((~seen[i]).sum())} rows of "
                                 f"a {f[0]} frame were in no window")
        for k, fld in enumerate(fields):
            got, exp = f[3][k], want[i][k]
            if got.dtype != exp.dtype or not np.array_equal(got, exp):
                raise AssertionError(f"{name}: a {f[0]} frame's {fld} "
                                     f"differs from the CPU replay")
        if f[4] != fo_seen[i]:
            raise AssertionError(f"{name}: a frame's fail_open differs")
    return len(frames)


def check_native_door(torch, cfg, label: str, *, device: str = "cuda",
                      seed: int = 0, space: str = "zipf",
                      conns: int = DOOR_CONNS, frames: int = DOOR_FRAMES,
                      n_ids: int = DOOR_IDS, n_keys: int = DOOR_KEYS,
                      depth: int = DOOR_DEPTH, shards: int = 1,
                      transport: str = "tcp", counters=(), required=(),
                      same=None, front=None, front_per_reset: int = 0,
                      flags=DEFAULT_STACK, server_kw=None) -> dict:
    """The port's native door over ``shards`` limiters of ``cfg`` on
    ``device``, each behind a ``RecordingLimiter`` (``serve_native_door``).
    Every frame's answer must be bit-identical to CPU replays of the
    windows each shard launched (``_hold_native_frames``), each shard's
    final state to its replay's; HEALTH must count every decision,
    METRICS one dispatch a window (fewer than the frames) and what the
    stack counts (``hold_door_metrics``); ``required``, ``same``,
    ``front`` and ``front_per_reset`` hold the launch counts as in
    ``check_door``."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter

    served = [create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                             device=device) for _ in range(shards)]
    recs = [RecordingLimiter(lim, T0) for lim in served]
    name = f"native door[{label}, {transport}, shards={shards}]"
    try:
        got, srv = serve_native_door(
            recs, seed=seed, space=space, conns=conns, frames=frames,
            n_ids=n_ids, n_keys=n_keys, depth=depth, transport=transport,
            counters=counters, flags=flags, server_kw=server_kw)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = {}
        for mod in counters:
            counts.update(mod.launch_counts())
        served_arrays = [lim.capture_state()[1] for lim in served]
    finally:
        for lim in served:
            lim.close()
    errors = [e for out in got["conns"] for e in out["errors"]]
    if errors:
        raise AssertionError(f"{name}: error replies {errors[:3]}")
    replays = [replay_windows(cfg, rec.log) for rec in recs]
    n_frames = _hold_native_frames(name, [r.log for r in recs],
                                   [r[0] for r in replays], got["conns"],
                                   cfg.prefix, srv)
    for shard, ((_, cpu), arrays) in enumerate(zip(replays,
                                                   served_arrays)):
        _, cpu_arrays, _ = cpu.capture_state()
        cpu.close()
        for k, v in cpu_arrays.items():
            if not np.array_equal(arrays[k], v):
                raise AssertionError(f"{name}: shard {shard}'s final state "
                                     f"{k} differs from the CPU replay")
    decisions = sum(len(r[0]) for o in got["conns"] for r in o["hashed"]) \
        + sum(len(r[0]) for o in got["conns"] for r in o["strings"])
    windows = sum(kind == "hashed" for rec in recs for kind, *_ in rec.log)
    resets = sum(kind == "reset" for rec in recs for kind, *_ in rec.log)
    dispatches = metric_value(got["metrics"],
                              "rate_limiter_server_batch_size_count")
    if got["health"][2] != decisions:
        raise AssertionError(f"{name}: HEALTH counts {got['health'][2]} "
                             f"decisions, not {decisions}")
    if dispatches != windows or not windows < n_frames:
        raise AssertionError(f"{name}: {dispatches:g} dispatches, "
                             f"{windows} windows, {n_frames} frames")
    out = hold_door_metrics(name, got["metrics"], decisions, flags)
    for k in required:
        if counts.get(k, 0) == 0:
            raise AssertionError(f"{name}: {k} was not launched")
    if same is not None and counts[same[0]] != counts[same[1]]:
        raise AssertionError(f"{name}: {counts[same[0]]} {same[0]} "
                             f"launches for {counts[same[1]]} {same[1]}")
    if front is not None and \
            counts[front] != windows + front_per_reset * resets:
        raise AssertionError(f"{name}: {counts[front]} {front} launches "
                             f"for {windows} windows and {resets} resets")
    lat = np.array([t for o in got["conns"] for t in o["latency"]])
    net = got["stats"]["net"]
    out.update({
        "frames": n_frames, "decisions": decisions, "windows": windows,
        "resets": resets, "frames_per_dispatch": n_frames / windows,
        "decisions_per_s": decisions / got["wall_s"],
        "wall_s": got["wall_s"],
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "counts": counts, "transport": transport, "shards": shards,
        "engine": net["engine"], "io_rings": net["rings"],
        "uring_probe": net["uring_probe"],
        "shard_decisions": got["stats"]["shard_decisions"],
        "transport_stats": got["stats"]["transport"],
        "shm_records_in": got["stats"]["shm"]["records_in"],
        "server_cpu_s": got["server_cpu_s"],
        "client_cpu_s": got["client_cpu_s"]})
    if shards > 1 and min(out["shard_decisions"]) == 0:
        raise AssertionError(f"{name}: a shard decided nothing "
                             f"{out['shard_decisions']}")
    if transport == "shm" and not out["shm_records_in"]:
        raise AssertionError(f"{name}: no frame came over the lane")
    log(f"{name} on {device}: {conns} connections, {n_frames} frames "
        f"({decisions} decisions) in {windows} windows "
        f"({out['frames_per_dispatch']:.2f} frames a window), every frame "
        f"bit-identical to CPU replays of each shard's windows; "
        f"{out['decisions_per_s']:.0f} decisions/s, frame latency p50 "
        f"{out['p50_ms']:.2f} ms p99 {out['p99_ms']:.2f} ms; net "
        f"{out['engine']} x{out['io_rings']} (probe {out['uring_probe']}); "
        f"shard decisions {out['shard_decisions']}; launches {counts}")
    return out


NATIVE_LIMIT = 5
NATIVE_KEYS = 32


def native_binary_config(cfg=None):
    """The native binary's deployment in (b): config 3 (or ``cfg``'s
    geometry) at a limit of 5, so seven requests a key cross it."""
    import dataclasses

    return dataclasses.replace(cfg or config3(), limit=NATIVE_LIMIT)


def _native_expected(cfg, order: list) -> list:
    """(allowed, remaining) of each request of ``order`` on CPU limiters
    of the port, one per shard of the binary, keys routed by the door's
    FNV router; every request inside one window, so time does not enter
    (fresh keys: no mass in the ring's boundary slab)."""
    from ratelimiter_tpu_torch import ManualClock, create_limiter
    from ratelimiter_tpu_torch.serving.native_server import fnv_shard

    cpu = [create_limiter(cfg, backend="sketch", clock=ManualClock(T0),
                          device="cpu") for _ in range(2)]
    try:
        out = []
        for key in order:
            if key.startswith("reset:"):
                key = key[len("reset:"):]
                cpu[fnv_shard(key, 2)].reset(key)
                continue
            r = cpu[fnv_shard(key, 2)].allow(key)
            out.append((bool(r.allowed), int(r.remaining)))
        return out
    finally:
        for lim in cpu:
            lim.close()


def check_native_binary(cfg=None, *, device: str = "cuda") -> dict:
    """(b) ``python -m ratelimiter_tpu_torch.serving --native --shards 2
    --http-port 0 --audit --audit-sample 1 --snapshot-dir D`` as a child
    process: 32 keys over the binary door (the port's Client) and 32 over
    /v1/allow, each seven times, every answer's allowed and remaining
    equal to CPU limiters of the two shards fed the same order; /healthz
    names the native door and its ABI, and after the auditor's flush it
    has audited every decision with no false deny or allow; a reset
    (HTTP) before a snapshot (/v1/snapshot) and one after it, a SIGKILL,
    and the restart must recover the snapshot and replay the second
    reset onto its key's shard (that key admitted again, the others
    still denied); SIGTERM then exits 0."""
    import shutil
    import tempfile

    from ratelimiter_tpu_torch.serving.client import Client

    cfg = native_binary_config(cfg)
    d = tempfile.mkdtemp(prefix="native-binary-")
    flags = cell_flags(cfg) + [
        "--native", "--shards", "2", "--device", device, "--http-port", "0",
        "--http-reset-token", TOKENS["reset"], "--audit", "--audit-sample",
        "1", "--snapshot-dir", d, "--snapshot-interval", "3600"]
    bin_keys = [f"nb:{i}" for i in range(NATIVE_KEYS)]
    http_keys = [f"nh:{i}" for i in range(NATIVE_KEYS)]
    order = [k for _ in range(NATIVE_LIMIT + 2)
             for k in bin_keys + http_keys]
    servers = []
    t0 = time.perf_counter()
    try:
        srv = ServerProcess(flags)
        servers.append(srv)
        got = []
        with Client("127.0.0.1", srv.port) as c:
            for key in order:
                if key in http_keys:
                    st, _, body = http_call(srv.http, "GET",
                                            f"/v1/allow?key={key}")
                    if st != (200 if body["allowed"] else 429):
                        raise AssertionError(f"/v1/allow answered {st}")
                    got.append((body["allowed"], body["remaining"]))
                else:
                    r = c.allow(key)
                    got.append((r.allowed, r.remaining))
        if got != _native_expected(cfg, order):
            raise AssertionError("native binary: answers differ from the "
                                 "CPU limiters of its shards")
        health = {}
        for _ in range(200):
            health = http_call(srv.http, "GET", "/healthz")[2]
            if health.get("audit", {}).get("samples") == len(order):
                break
            time.sleep(0.05)
        aud = health.get("audit", {})
        if (aud.get("samples") != len(order) or aud.get("false_denies")
                or aud.get("false_allows")):
            raise AssertionError(f"native binary: audit block {aud}")
        member = health["member"]
        # decisions_total is the C++ door's (as in the JAX binary); the
        # gateway's decisions go through decide_one.
        door_decisions = (NATIVE_LIMIT + 2) * NATIVE_KEYS
        if (member["door"], member["abi"]) != ("native", "1") or \
                health["decisions_total"] != door_decisions:
            raise AssertionError(f"native binary: /healthz {member}, "
                                 f"{health['decisions_total']} decisions")
        gated(srv.http, "POST", "/v1/reset?key=nb:0", TOKENS["reset"],
              "native binary reset")
        st, _, snap = http_call(srv.http, "POST", "/v1/snapshot")
        if st != 200:
            raise AssertionError(f"/v1/snapshot answered {st}: {snap}")
        gated(srv.http, "POST", "/v1/reset?key=nb:1", TOKENS["reset"],
              "native binary reset")
        srv.kill()
        srv = ServerProcess(flags)
        servers.append(srv)
        if "replayed 1 WAL record(s)" not in (srv.recovered or ""):
            raise AssertionError(f"native binary restart: {srv.recovered}")
        with Client("127.0.0.1", srv.port) as c:
            after = [(r.allowed, r.remaining) for r in
                     (c.allow(k) for k in ("nb:0", "nb:1", "nb:2"))]
        want = _native_expected(
            cfg, order + ["reset:nb:0", "reset:nb:1", "nb:0", "nb:1",
                          "nb:2"])
        if after != want[-3:]:
            raise AssertionError(f"native binary after recovery: {after}, "
                                 f"not {want[-3:]}")
        if srv.terminate() != 0:
            raise AssertionError("native binary: SIGTERM exit code")
    finally:
        for srv in servers:
            if srv.proc.poll() is None:
                srv.kill()
        shutil.rmtree(d, ignore_errors=True)
    out = {"answers": len(order), "recovered": srv.recovered,
           "audit_samples": aud["samples"],
           "net": health["transport"]["net"],
           "seconds": time.perf_counter() - t0}
    log(f"native binary on {device}: {len(order)} answers (binary door "
        f"and /v1/allow) equal to the CPU shards, audited with no false "
        f"deny; {srv.recovered}; {out['seconds']:.1f} s")
    return out


#: (door, shards, transports) of the load generator's readings. The
#: asyncio door's shared-memory lane is left out: under this generator
#: (whose consumer clears its sleeping flag between waits) it stalls in
#: both packages, runs answering nothing where TCP completes (ROADMAP
#: C16); the port's Python clients keep the flag up and are not hit.
LOADGEN_DOORS = (("native", 1, ("tcp", "shm")),
                 ("native", 2, ("tcp", "shm")),
                 ("asyncio", 1, ("tcp",)))
LOADGEN_SECONDS = 0.5


def _loadgen(exe: str, port: int, mode: str, transport: str) -> dict:
    """One run of the C++ load generator (8 threads, 8 frames in flight
    each, 512 ids or 64 keys a frame over 1M keys; 1 s warm-up)."""
    keys = 512 if mode == "hashed" else 64
    proc = subprocess.run(
        [exe, "127.0.0.1", str(port), str(LOADGEN_SECONDS), "8", "8",
         str(keys), str(N_KEYS), mode, "--transport", transport],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"loadgen exited {proc.returncode}: "
                             f"{proc.stderr[-500:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def native_readings(rounds: int = 3, device: str = "cuda") -> list:
    """(c) The port's C++ load generator (``native.build_loadgen``) on
    config 3's door on the card, the native door with 1 and 2 shards and
    the asyncio door in turns, ``rounds`` rounds, hashed and batch modes
    over TCP and (the native door) the shared-memory lane: decisions/s
    and frame RTT p50/p99, with the net engine that ran. Each door is the
    binary's (the default stack, the batcher's defaults, ``--shm``)."""
    import threading as _threading

    from ratelimiter_tpu_torch import create_limiter, native
    from ratelimiter_tpu_torch.serving.native_server import (
        NativeRateLimitServer,
    )
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    exe = native.build_loadgen()
    rows = []
    for rnd in range(rounds):
        for door, shards, transports in LOADGEN_DOORS:
            served = create_limiter(config3(), backend="sketch",
                                    device=device)
            with door_stack() as (wrap, registry):
                lim = wrap(served)
                if door == "native":
                    srv = NativeRateLimitServer(
                        lim, "127.0.0.1", 0, registry=registry,
                        shards=shards, shm=True,
                        shard_decorate=lambda c, i: wrap(c, i))
                    srv.start()
                    port, stop = srv.port, srv.shutdown
                    engine = srv.stats()["net"]["engine"]
                else:
                    loop = asyncio.new_event_loop()
                    th = _threading.Thread(target=loop.run_forever,
                                           daemon=True)
                    th.start()
                    srv = RateLimitServer(lim, "127.0.0.1", 0,
                                          registry=registry, shm=True)
                    asyncio.run_coroutine_threadsafe(
                        srv.start(), loop).result(timeout=30)
                    port, engine = srv.port, "asyncio"

                    def stop(srv=srv, loop=loop, th=th):
                        asyncio.run_coroutine_threadsafe(
                            srv.shutdown(), loop).result(timeout=60)
                        loop.call_soon_threadsafe(loop.stop)
                        th.join(timeout=30)
                        loop.close()
                try:
                    for mode in ("hashed", "batch"):
                        for transport in transports:
                            r = _loadgen(exe, port, mode, transport)
                            if not r["completed"]:
                                raise AssertionError(
                                    f"loadgen: no frame completed on the "
                                    f"{door} door ({mode}, {transport})")
                            rows.append({"round": rnd, "door": door,
                                         "shards": shards, "mode": mode,
                                         "transport": transport,
                                         "engine": engine,
                                         **{k: r[k] for k in (
                                             "decisions_per_sec",
                                             "frame_p50_ms",
                                             "frame_p99_ms")}})
                finally:
                    stop()
            served.close()
    for r in rows:
        log(f"loadgen round {r['round']}: {r['door']} door "
            f"shards={r['shards']} {r['mode']} over {r['transport']} "
            f"({r['engine']}): {r['decisions_per_sec']:.0f} decisions/s, "
            f"RTT p50 {r['frame_p50_ms']:.2f} ms p99 "
            f"{r['frame_p99_ms']:.2f} ms")
    return rows


def run_native(torch, seed: int = 0, device: str = "cuda",
               rounds: int = 3) -> dict:
    """Phase native: (a) the windowed CU door at config 3 over TCP, a
    unix socket and the shared-memory lane, TB-c2 with its bucket
    kernels, and two shards on one card (against two CPU replays), each
    through ``check_native_door``; (b) the binary as a child process
    (``check_native_binary``); (c) the load generator's readings
    (``native_readings``, ``rounds`` rounds: one in the whole run, three
    under ``--native``). The launch counts of each checked door run are
    set to 0 just before it and read just after."""
    from ratelimiter_tpu_torch.ops import bucket_cuda, sketch_cuda

    t = time.perf_counter()
    windowed = dict(counters=[sketch_cuda],
                    required=("window_estimate", "admit", "cu_update",
                              "window_reset"),
                    same=("admit", "cu_update"), front="window_estimate")
    out = {}
    for transport in NATIVE_TRANSPORTS:
        out[f"windowed CU {transport}"] = check_native_door(
            torch, config3(), "windowed CU", device=device, seed=seed + 91,
            transport=transport, **windowed)
    out["windowed CU shards=2"] = check_native_door(
        torch, config3(), "windowed CU", device=device, seed=seed + 93,
        shards=2, transport="shm", **windowed)
    out["TB-c2"] = check_native_door(
        torch, config2_bucket(), "TB-c2", device=device, seed=seed + 97,
        space="c2",
        counters=[bucket_cuda],
        required=("bucket_estimate", "admit", "bucket_update"),
        same=("admit", "bucket_update"), front="bucket_estimate",
        front_per_reset=1)
    out["binary"] = check_native_binary(device=device)
    out["readings"] = native_readings(rounds=rounds, device=device)
    out["seconds"] = time.perf_counter() - t
    log(f"phase native on {card_line()}: {out['seconds']:.1f} s")
    return out



def row_launches(name: str, windowed, bucket) -> int:
    """A kernel row's launches over the main paths' runs, the door's,
    phase 5's and the evaluation path's (each counted from 0 just before
    it and read just after):
    the standalone ``add_update`` is the TPU name's count less the fused
    back's builds, each admission launch counts as ``admit`` in its
    family's module (its cascade build as ``admit [cascade]``), and a
    back's row without ``[cascade]`` counts its build without the
    cascade alone."""
    if name == "add_update":
        return sum(r["counts"]["add_update"] - r["counts"]["add_back"]
                   - r["counts"].get("add_back [cascade]", 0)
                   for r in windowed)
    base, _, casc = name.partition(" ")
    if base in ("window_admit", "bucket_admit"):
        runs = windowed if base == "window_admit" else bucket
        return sum(r["counts"].get(f"admit {casc}".strip(), 0) for r in runs)
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
    ap.add_argument("--rows", action="store_true",
                    help="only build, then hold and time phase 2's kernel "
                         "rows without the cascade (one JSON line; "
                         "public wrappers only, so it runs on an earlier "
                         "checkout too)")
    ap.add_argument("--cascade", action="store_true",
                    help="only build, then hold and time the cascade's "
                         "kernels (phase 2's cascade part, one JSON line)")
    ap.add_argument("--paths", action="store_true",
                    help="only build, then drive and profile the main "
                         "paths (phase 3, one JSON line)")
    ap.add_argument("--dense-paths", action="store_true",
                    help="only build, then drive phase 3's dense paths "
                         "(public entry points only; one JSON line)")
    ap.add_argument("--observe", action="store_true",
                    help="only build, then run phase observe (the "
                         "decorator stacks through the door, traced "
                         "frames, deadlines, the journal, the breaker, a "
                         "profiler capture and the door readings; one "
                         "JSON line)")
    ap.add_argument("--door", action="store_true",
                    help="only build, then time the config-3 door under "
                         "the binary's default stack, 3 rounds (public "
                         "entry points only, so it runs on an earlier "
                         "checkout too; one JSON line)")
    ap.add_argument("--gateway", action="store_true",
                    help="only build, then hold the auditor twin's kernels "
                         "at d=1 and run phase gateway (the binary's HTTP "
                         "gateway, shadow auditor and SLO tracker beside "
                         "its door; one JSON line)")
    ap.add_argument("--native", action="store_true",
                    help="only build, then run phase native (the C++ "
                         "door over TCP, a unix socket and the "
                         "shared-memory lane, two shards, the binary "
                         "with --native, the load generator's readings; "
                         "one JSON line)")
    ap.add_argument("--dense", action="store_true",
                    help="only build, then run this slice's parts: the "
                         "dense step's rows, the dense and exact paths, "
                         "their doors, the dense round trip and the "
                         "evaluation path (one JSON line)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ratelimiter_tpu_torch.ops import (
        _build,
        bucket_cuda,
        dense_cuda,
        sketch_cuda,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t = time.perf_counter()
    full = not (args.sweep or args.admit_sweep or args.rows or args.paths
                or args.dense or args.dense_paths or args.observe
                or args.gateway or args.door or args.native)
    # The native door and the load generator build with g++ beside the
    # nvcc builds.
    host_build = None
    if full or args.native:
        from concurrent.futures import ThreadPoolExecutor

        from ratelimiter_tpu_torch import native

        pool = ThreadPoolExecutor(max_workers=2)
        host_build = [pool.submit(native.load_server),
                      pool.submit(native.build_loadgen)]
        pool.shutdown(wait=False)
    _build.build_all(["sketch_kernels", "bucket_kernels"]
                     + (["dense_kernels", "dense_bench"]
                        if full or args.dense else [])
                     + (["dense_kernels"] if args.dense_paths else [])
                     + (["cascade_bench"] if full else []))
    sketch_cuda.build()
    bucket_cuda.build()
    if full or args.dense or args.dense_paths:
        dense_cuda.build()
    for fut in host_build or ():
        fut.result()
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
    if args.cascade:
        print(json.dumps({"card": card, "cascade": check_cascade(
            torch, args.seed)}))
        print(card)
        return 0
    if args.dense_paths:
        print(json.dumps({"card": card, "dense_paths": check_dense_paths(
            torch, args.seed + 79, DENSE_STEPS, strict=False)}))
        print(card)
        return 0
    if args.dense:
        out = run_dense_slice(torch, args.seed)
        print(json.dumps({"card": card, "dense": out},
                         default=lambda o: repr(o)))
        check_no_children()
        print(card)
        return 0
    if args.observe:
        out = run_observe(torch, args.seed)
        check_no_children()
        print(json.dumps({"card": card, "observe": out},
                         default=lambda o: repr(o)))
        print(card)
        return 0
    if args.door:
        runs = [time_door(config3(), "windowed CU", seed=args.seed + 17)
                for _ in range(3)]
        check_no_children()
        print(json.dumps({"card": card, "door": [
            {k: r[k] for k in ("decisions_per_s", "p50_ms", "p99_ms",
                               "frames_per_dispatch")} for r in runs]}))
        print(card)
        return 0
    if args.native:
        out = run_native(torch, args.seed)
        check_no_children()
        print(json.dumps({"card": card, "native": out},
                         default=lambda o: repr(o)))
        print(card)
        return 0
    if args.gateway:
        out = {"twin_kernels": check_twin_kernels(torch, args.seed),
               "gateway": run_gateway(torch, args.seed, alone=True)}
        check_no_children()
        print(json.dumps({"card": card, **out}, default=lambda o: repr(o)))
        print(card)
        return 0
    if args.rows:
        rows = check_kernels(torch, args.seed)
        rows.update(check_bucket_kernels(torch, args.seed))
        rows.update(check_backs(torch, args.seed))
        side = check_side_table(torch, args.seed)
        rows.update(hh_update=side["hh_update"],
                    side_forms=side["side_forms"])
        print(json.dumps({"card": card, "rows": rows}))
        print(card)
        return 0

    rows = {} if args.paths else check_kernels(torch, args.seed)
    if not args.paths:
        rows.update(check_bucket_kernels(torch, args.seed))
        rows.update(check_backs(torch, args.seed))
        side = check_side_table(torch, args.seed)
        rows["hh_update"] = side["hh_update"]
        rows.update(check_reset(torch, args.seed))
        for name, row in (("window_front", "window_estimate"),
                          ("window_admit", "window_admit"),
                          ("add_back", "add_back")):
            rows[row]["side_table_form"] = side["side_forms"][name]
        rows.update(check_cascade(torch, args.seed))
        rows.update(check_dense_kernel(torch, args.seed))
        # The auditor twin's forms of the step's kernels (d = 1).
        for width, forms in check_twin_kernels(torch, args.seed).items():
            for name, form in forms.items():
                rows[name].setdefault("twin", {})[str(width)] = form
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
    cu_hh = check_hh_path(torch, args.seed, args.steps, cu=True,
                          strict=strict)
    vanilla_hh = check_hh_path(torch, args.seed + 7,
                               max(32, args.steps // 2), cu=False,
                               strict=strict)
    paths.update(cu_hh=cu_hh, vanilla_hh=vanilla_hh)
    if args.paths:
        print(json.dumps({"main_path": paths}))
        print(card)
        return 0
    prof_hh = profile_path(torch, f"windowed cu=True hh_slots={HH_SLOTS}",
                           config3_hh(), batches, keys, 0.1)
    if prof_hh["sort_or_scan_ops"]:
        raise AssertionError(f"side-table path: the plain admission still "
                             f"runs: {prof_hh['sort_or_scan_ops']}")
    paths["profile_hh"] = prof_hh
    cu_tn = check_tenant_path(torch, args.seed + 61, "windowed CU",
                              config3(), profile=True)
    vanilla_tn = check_tenant_path(torch, args.seed + 67,
                                   "windowed vanilla", config3(cu=False))
    hh_tn = check_tenant_path(torch, args.seed + 71,
                              f"windowed CU hh_slots={HH_SLOTS}",
                              config3_hh())
    tb_tn = check_tenant_path(torch, args.seed + 73, "TB-c2",
                              config2_bucket())
    paths.update({"cu_tenants": cu_tn, "vanilla_tenants": vanilla_tn,
                  "cu_hh_tenants": hh_tn, "TB-c2_tenants": tb_tn})
    dense_paths = check_dense_paths(torch, args.seed + 79, DENSE_STEPS)
    paths["dense"] = dense_paths
    log(f"side-table paths on {card} (hh_slots={HH_SLOTS} | without): "
        + "; ".join(
            f"{label} {h['steps_per_s']:.1f} | {b['steps_per_s']:.1f} "
            f"steps/s (median of {REPEATS}; min {h['steps_per_s_min']:.1f} "
            f"| {b['steps_per_s_min']:.1f}, max {h['steps_per_s_max']:.1f} "
            f"| {b['steps_per_s_max']:.1f})"
            for label, h, b in (("windowed CU", cu_hh, cu),
                                ("windowed vanilla", vanilla_hh,
                                 vanilla))))
    check_server(torch, args.seed, config3(), "windowed")
    check_server(torch, args.seed, config2_bucket(), "TB-c2")
    door_cu = check_door(
        torch, config3(), "windowed CU", seed=args.seed + 17,
        counters=[sketch_cuda],
        required=("window_estimate", "admit", "cu_update", "window_reset"),
        same=("admit", "cu_update"), front="window_estimate")
    door_tb = check_door(
        torch, config2_bucket(), "TB-c2", seed=args.seed + 19, space="c2",
        counters=[bucket_cuda],
        required=("bucket_estimate", "admit", "bucket_update"),
        same=("admit", "bucket_update"), front="bucket_estimate",
        front_per_reset=1)
    door_hh = check_door(
        torch, config3_hh(), f"windowed CU hh_slots={HH_SLOTS}",
        seed=args.seed + 37, counters=[sketch_cuda],
        required=("window_estimate", "admit", "cu_update",
                  "hh_update [fused]", "window_reset"),
        same=("admit", "cu_update"), front="window_estimate")
    hold_tails("door with the side table", door_hh["counts"])
    door_tn = check_door(
        torch, with_tenants(config3()), f"windowed CU tenants={TENANTS}",
        seed=args.seed + 43, space="tenants", counters=[sketch_cuda],
        required=("window_estimate", "admit [cascade]", "cu_update"),
        same=("admit [cascade]", "cu_update"), setup=boot_tenants)
    door_dense = check_backend_door(torch, dense_config("SLIDING_WINDOW"),
                                    "dense", seed=args.seed + 83)
    door_exact = check_backend_door(torch, dense_config("SLIDING_WINDOW"),
                                    "exact", seed=args.seed + 83)
    unproxied_cu = time_door(config3(), "windowed CU", seed=args.seed + 17)
    unproxied_tb = time_door(config2_bucket(), "TB-c2", seed=args.seed + 19,
                             space="c2")
    log(f"door on {card} (through the recording proxy | unproxied): "
        + "; ".join(
            f"{label} {d['decisions_per_s']:.0f} | "
            f"{b['decisions_per_s']:.0f} decisions/s, "
            f"{d['frames_per_dispatch']:.2f} | "
            f"{b['frames_per_dispatch']:.2f} frames a dispatch, frame "
            f"latency p50 {d['p50_ms']:.2f} | {b['p50_ms']:.2f} ms, p99 "
            f"{d['p99_ms']:.2f} | {b['p99_ms']:.2f} ms"
            for label, d, b in (("windowed CU", door_cu, unproxied_cu),
                                ("TB-c2", door_tb, unproxied_tb))))
    log(f"phases 1-4 done at {time.perf_counter() - t:.1f} s")
    observe = run_observe(torch, args.seed, reuse={
        "windowed CU": door_cu, f"windowed CU hh_slots={HH_SLOTS}": door_hh,
        "TB-c2": door_tb}, rounds=1)
    gateway = run_gateway(torch, args.seed)
    native_door = run_native(torch, args.seed, rounds=1)
    live = check_live_updates(torch, args.seed)
    watch = check_watchdog(torch)
    durable = check_durable_door(config3(), device="cuda", seed=args.seed)
    tenant_door = check_tenant_durable_door(config3(), device="cuda",
                                            seed=args.seed)
    dense_durable = check_dense_durable(torch, args.seed)
    above = check_above_capacity(torch, args.seed)
    eval_path = check_eval_path(torch, args.seed)
    log(f"phases 5-6 done at {time.perf_counter() - t:.1f} s")
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
    ev_windowed, ev_bucket = eval_runs(eval_path)
    windowed_runs = (cu, vanilla, cu_hh, vanilla_hh, cu_tn, vanilla_tn,
                     hh_tn, door_cu, door_hh, door_tn, live["windowed"],
                     watch, *ev_windowed, above["tenants windowed CU"],
                     above[f"tenants windowed CU hh_slots={HH_SLOTS}"],
                     above["tenants windowed vanilla"],
                     gateway["windowed"],
                     *(native_door[f"windowed CU {t}"]
                       for t in NATIVE_TRANSPORTS),
                     native_door["windowed CU shards=2"])
    bucket_runs = (tb_c2, tb_zipf, tb_tn, door_tb, live["bucket"],
                   *ev_bucket, above["tenants TB-c2"], gateway["TB-c2"],
                   native_door["TB-c2"])
    for name in rows:
        if name.startswith(("dense_step", "dense_front")):
            rows[name]["launches"] = sum(
                r["counts"][name] for r in (*dense_paths.values(),
                                            door_dense))
            continue
        rows[name]["launches"] = row_launches(
            name, windowed_runs, bucket_runs)
    # The side table's update ran as the backs' tail on every path.
    rows["hh_update"]["fused_launches"] = row_launches(
        "hh_update [fused]", windowed_runs, bucket_runs)
    paths["live"] = live
    paths["watchdog"] = watch
    paths["durable_door"] = durable
    paths["door_windowed_CU"] = door_cu
    paths["door_windowed_CU_hh"] = door_hh
    paths["door_windowed_CU_tenants"] = door_tn
    paths["tenant_durable_door"] = tenant_door
    paths["door_TB-c2"] = door_tb
    paths["door_unproxied_windowed_CU"] = unproxied_cu
    paths["door_unproxied_TB-c2"] = unproxied_tb
    paths["observe"] = observe
    paths["gateway"] = gateway
    paths["native"] = native_door
    paths["door_dense"] = door_dense
    paths["door_exact"] = door_exact
    paths["dense_durable"] = dense_durable
    paths["above_capacity"] = above
    paths["evaluation"] = eval_path

    log(json.dumps({"main_path": paths}))
    check_no_children()
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
