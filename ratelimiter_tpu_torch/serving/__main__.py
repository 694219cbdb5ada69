"""Server binary: ``python -m ratelimiter_tpu_torch.serving``.

Serves a limiter on the card (``--device cuda``, the default; ``--device
cpu`` runs the kernels' plain versions). ``--backend sketch`` (the
default) serves a count-min sketch: the windowed sketch, or with
``--algorithm token_bucket`` the sketched token bucket
(``--sub-windows``, ``--no-conservative-update`` and ``--hh-slots`` do
not apply to it); ``--backend dense`` exact slot-addressed state on the
card (``--dense-capacity`` slots; at most 8192 requests a launch, so
``--max-batch`` at most 8192) and ``--backend exact`` the host oracle.
Dense and exact serve ALLOW and ALLOW_BATCH frames (string keys); the
raw-id ALLOW_HASHED lane needs a sketch backend and is refused as in the
JAX binary,
behind the micro-batcher (``--max-batch``, ``--max-delay-us``,
``--dispatch-timeout-ms``, ``--inflight``; the JAX binary's names and
defaults). Before it listens it builds and loads the CUDA kernels (on
the card) and the C++ bulk hasher, so no client frame pays a build; then
it prints a line starting with ``serving``. SIGINT/SIGTERM stop it
gracefully (the batcher drains first).

``--snapshot-dir DIR`` turns on the durability subsystem (persistence/):
a write-ahead log of every mutation (policy frames, RESET, dynamic
limit/window updates), background snapshots every ``--snapshot-interval``
seconds (and after ``--snapshot-after-mutations`` mutations), and on
start a recovery from the newest snapshot plus the WAL replayed past it,
before the door listens (a ``recovered`` line precedes ``serving``). The
SNAPSHOT frame takes one on demand. A crash loses the decisions made
after the last snapshot, by design (under-counting); a SIGTERM takes a
final snapshot and loses nothing. Boot with the limit and window the
snapshot was taken under: a snapshot refuses to restore under another
config (checkpoint.py fingerprint). The JAX binary's flags and defaults.

``--tenants N`` turns on the hierarchy cascade (ADR-020): every decision
is held to its key's scope, its tenant's and the global one, in the same
launch. ``--tenant-map``, ``--global-limit``, ``--default-tenant-limit``,
``--tenant NAME=LIMIT[:WEIGHT[:FLOOR]]`` and ``--assign KEY=TENANT``
configure it (the tenant and assignment flags apply after recovery, so
they win over a snapshot's registry for the names they touch), and
``--controller`` runs the AIMD controller every ``--controller-interval``
seconds over it (hierarchy/controller.py; its gauges show on METRICS).
The wire protocol is unchanged: tenant ids derive from the key. The JAX
binary's flags, refusals and boot order.

Observability, with the JAX binary's flags and defaults: every limiter is
wrapped in the decorator stack (``build_limiter_stack``: ``--trace``
TracingDecorator, ``--circuit-breaker`` CircuitBreakerDecorator,
MetricsDecorator unless ``--no-metrics``, ``--log-decisions``
LoggingDecorator, innermost first, the persistence wrapper outermost);
``--flight-recorder`` turns the flight recorder on before any serving
thread starts (``rate_limiter_stage_seconds`` on METRICS); the event
journal is on unless ``--no-event-journal`` (``--event-journal-dir``
spills it to JSONL segments and replays their tail at start).

``--http-port`` also serves the HTTP gateway (serving/http_gateway.py):
its decisions go through the door's micro-batcher
(``make_threadsafe_decide``), so HTTP and binary frames share launches
and windows. ``/healthz`` carries the JAX binary's blocks (the sketch's
envelope or debt slab, the side table's consumers, the audit and SLO
blocks, the hierarchy, the journal, the persistence status; leases, the
fleet, placement and quarantine, which the port does not have, give the
JAX binary's ``{}`` for "off"); ``/v1/reset``, ``/v1/policy``,
``/v1/tenants``, ``/v1/snapshot`` and the ``/debug`` routes are gated by
the JAX binary's ``--http-*``, ``--debug-*`` and ``--audit-token``
flags. ``--audit`` turns on the live accuracy observatory
(observability/audit.py: a 1 in ``--audit-sample`` hash-sampled shadow
of the served decisions, ``--audit-twin`` adding the collision-free
twin on the serving limiter's device) and the SLO burn tracker
(observability/slo.py), whose statuses the AIMD controller reads; the
dense and exact backends refuse it, as in the JAX binary.

``--native`` serves the binary door through the C++ front door
(serving/native_server.py over native/server.cpp, built with g++ before
the ``serving(native)`` line; a failed build stops the binary with the
compiler's message): ``--shards N`` dispatch shards on the one device,
keys routed by FNV-1a, each shard under the decorator stack with its own
``shard`` label and the persistence wrapper (the WAL's resets replay onto
their shard; with ``--tenants`` each shard enforces 1/N of the tenant and
global limits); ``--net-engine`` and ``--io-rings`` its io threads. Both
doors take ``--listen unix:/path`` and ``--shm`` (``--shm-dir``,
``--shm-ring-bytes``: the shared-memory lane). ``--shards`` needs
``--native``. With no ``--algorithm`` the binary serves ``tpu_sketch``
(the JAX binary's default), which decides as the sliding window; a
snapshot taken under ``--algorithm sliding_window`` restores only under
that flag (the fingerprint names the algorithm).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import time
from types import SimpleNamespace

from ratelimiter_tpu_torch import (
    Algorithm,
    Config,
    DenseParams,
    HierarchySpec,
    PersistenceSpec,
    SketchParams,
    create_limiter,
)
from ratelimiter_tpu_torch.ops.sketch_cuda import ADMIT_CAPACITY
from ratelimiter_tpu_torch.serving.server import RateLimitServer

_ALGORITHMS = ("sliding_window", "fixed_window", "tpu_sketch",
               "token_bucket")


def build_parser() -> argparse.ArgumentParser:
    """The binary's options: the JAX binary's names and defaults for
    every flag the two share (``--sketch-depth``/``--sketch-width`` keep
    the older ``--depth``/``--width`` as aliases)."""
    ap = argparse.ArgumentParser(
        prog="ratelimiter_tpu_torch.serving",
        description="Count-min-sketch rate limiter on a CUDA card.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8432)
    ap.add_argument("--listen", default=None, metavar="ADDR",
                    help="binary-door bind override: 'unix:/path' listens "
                         "on a unix domain socket instead of TCP (--port "
                         "ignored for the binary door; the HTTP gateway "
                         "keeps --host)")
    ap.add_argument("--shm", action="store_true",
                    help="enable the zero-syscall shared-memory wire "
                         "lane: a connected client may send SHM_HELLO to "
                         "upgrade its connection to per-connection ring "
                         "pairs in --shm-dir carrying the SAME wire "
                         "frames; the socket stays open as the liveness "
                         "channel. Off (the default) = wire bytes "
                         "identical to a server without this flag")
    ap.add_argument("--shm-dir", default="/dev/shm", metavar="DIR",
                    help="--shm: directory for the ring files (0600, "
                         "unlinked after the handshake; same-uid trust "
                         "boundary)")
    ap.add_argument("--shm-ring-bytes", type=int, default=0, metavar="B",
                    help="--shm: per-direction ring capacity (power of "
                         "two, clamped to [64KiB, 64MiB]; 0 = 2MiB "
                         "default). A client's hello may request its "
                         "own size; the server clamps")
    ap.add_argument("--algorithm", default="tpu_sketch",
                    choices=_ALGORITHMS)
    ap.add_argument("--backend", default="sketch",
                    choices=["exact", "dense", "sketch"],
                    help="state backend: sketch (count-min sketch on the "
                         "card), dense (exact slot-addressed state on the "
                         "card) or exact (host dicts, the oracle). The "
                         "JAX binary's 'mesh' is not ported (ROADMAP A8)")
    ap.add_argument("--dense-capacity", type=int, default=1 << 16,
                    help="--backend dense: slots, i.e. the most distinct "
                         "live keys (idle keys are pruned after 2 "
                         "windows)")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--window", type=float, default=60.0,
                    help="window length in seconds")
    ap.add_argument("--sketch-depth", "--depth", dest="sketch_depth",
                    type=int, default=4)
    ap.add_argument("--sketch-width", "--width", dest="sketch_width",
                    type=int, default=65536)
    ap.add_argument("--sub-windows", type=int, default=60)
    ap.add_argument("--no-conservative-update", action="store_true",
                    help="plain sums instead of conservative update")
    ap.add_argument("--hh-slots", type=int, default=0,
                    help="heavy-hitter side table slots (0 = off; power "
                         "of two >= 16): promoted hot keys get exact "
                         "private counters, exported as top-K consumer "
                         "gauges on METRICS (rate_limiter_top_consumer_"
                         "mass, rate_limiter_hh_tracked_consumers). The "
                         "token bucket ignores it")
    ap.add_argument("--fail-open", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=4096,
                    help="micro-batcher flush size. Hashed windows merge "
                         "up to 2x this many rows; above --max-batch 4096 "
                         "they pass the one-launch admission capacity "
                         "(8192 keys) and run the composed back, ~0.6 ms "
                         "a window. With --tenants a window holds at most "
                         "8192 rows (the cascade's one launch) and this "
                         "flag at most 8192")
    ap.add_argument("--max-delay-us", type=float, default=200.0,
                    help="micro-batcher coalescing window, microseconds "
                         "(adaptive: a filling queue flushes sooner)")
    ap.add_argument("--dispatch-timeout-ms", type=float, default=None,
                    help="SLO per dispatch; a breach answers fail-open or "
                         "fail-closed (and turns pipelining off)")
    ap.add_argument("--inflight", type=int, default=8,
                    help="launches kept in flight on the card, overlapping "
                         "host staging and result copies with device "
                         "work; 1 restores launch-then-wait")
    ap.add_argument("--native", action="store_true",
                    help="use the C++ front door (native/server.cpp, "
                         "built with g++ on first use) instead of the "
                         "asyncio server; a failed build stops the "
                         "binary with the compiler's message")
    ap.add_argument("--shards", type=int, default=1,
                    help="native front door dispatch shards: keys are "
                         "hash-routed, each shard decides on its own "
                         "limiter on the same card (per-key semantics "
                         "exact)")
    ap.add_argument("--net-engine", default="auto",
                    choices=("auto", "epoll", "uring"),
                    help="native door wire backend: auto probes io_uring "
                         "at startup and falls back to epoll when the "
                         "kernel or seccomp refuses; epoll forces the "
                         "portable backend; uring requests io_uring but "
                         "still downgrades (recorded in stats/healthz) "
                         "rather than failing")
    ap.add_argument("--io-rings", type=int, default=0,
                    help="native door io ring shards: event-loop threads "
                         "connections are pinned to by accept order; 0 = "
                         "auto (min(4, cores))")
    ap.add_argument("--snapshot-dir", default=None,
                    help="enable the durability subsystem: write-ahead "
                         "log for mutations (policy/reset/config) plus "
                         "background snapshots in this directory; on "
                         "start, state recovers from the newest snapshot "
                         "+ WAL replay. Off by default")
    ap.add_argument("--snapshot-interval", type=float, default=30.0,
                    help="seconds between background snapshots (bounds "
                         "the decisions lost to kill -9 at one interval "
                         "of traffic, in the under-counting direction)")
    ap.add_argument("--snapshot-after-mutations", type=int, default=0,
                    help="also snapshot after this many WAL mutations "
                         "(0 = interval only)")
    ap.add_argument("--snapshot-retain", type=int, default=3,
                    help="snapshots kept on disk; older ones and their "
                         "WAL prefix are pruned")
    ap.add_argument("--wal-fsync", default="always",
                    choices=["always", "interval", "never"],
                    help="WAL durability: fsync every mutation (default), "
                         "at most every 50ms, or never (OS flushing only)")
    # Hierarchical cascades + adaptive control (ADR-020).
    ap.add_argument("--tenants", type=int, default=0,
                    help="enable hierarchical cascades (ADR-020): tenant "
                         "capacity (power of two >= 2; 0 = off). Every "
                         "decision then evaluates key -> tenant -> "
                         "global scopes in the same launch; tenant ids "
                         "derive on the card from the key->tenant map "
                         "(protocol unchanged)")
    ap.add_argument("--tenant-map", type=int, default=1024,
                    help="key->tenant assignment map capacity (power of "
                         "two)")
    ap.add_argument("--global-limit", type=int, default=0,
                    help="global-scope limit, requests per window across "
                         "ALL keys (0 = unlimited)")
    ap.add_argument("--default-tenant-limit", type=int, default=0,
                    help="per-window limit of the default tenant (every "
                         "unassigned key; 0 = unlimited)")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME=LIMIT[:WEIGHT[:FLOOR]]",
                    help="register a tenant at boot (repeatable); "
                         "LIMIT 0 = unlimited")
    ap.add_argument("--assign", action="append", default=[],
                    metavar="KEY=TENANT",
                    help="assign a key to a tenant at boot (repeatable)")
    ap.add_argument("--controller", action="store_true",
                    help="run the AIMD adaptive controller (ADR-020): a "
                         "background loop that tightens/relaxes EFFECTIVE "
                         "scope limits off the per-tenant in-window mass "
                         "between each scope's floor and its configured "
                         "ceiling; its gauges show on METRICS; needs "
                         "--tenants > 0")
    ap.add_argument("--controller-interval", type=float, default=1.0,
                    help="seconds between AIMD controller ticks")
    ap.add_argument("--log-level", default="info")
    # Decorator stack (observability/decorators.py).
    ap.add_argument("--circuit-breaker", action="store_true",
                    help="wrap the limiter in CircuitBreakerDecorator "
                         "(trips after --breaker-threshold consecutive "
                         "backend failures; probes after --breaker-cooldown)")
    ap.add_argument("--breaker-threshold", type=int, default=5)
    ap.add_argument("--breaker-cooldown", type=float, default=10.0,
                    help="seconds the breaker stays open before probing")
    ap.add_argument("--log-decisions", action="store_true",
                    help="wrap in LoggingDecorator (decisions at DEBUG, "
                         "fail-open at WARNING)")
    ap.add_argument("--log-redact-keys", action="store_true",
                    help="with --log-decisions: log key#<hex> tokens "
                         "(ops.hashing.key_token) instead of raw keys")
    ap.add_argument("--trace", action="store_true",
                    help="wrap in TracingDecorator (torch.profiler "
                         "record_function ranges around every dispatch)")
    ap.add_argument("--no-metrics", action="store_true",
                    help="skip the MetricsDecorator (on by default)")
    # Flight recorder (observability/tracing.py).
    ap.add_argument("--flight-recorder", action="store_true",
                    help="turn on the flight recorder: per-thread ring "
                         "buffers of per-stage spans stamped on the "
                         "serving hot path at clock-read cost, shown as "
                         "the rate_limiter_stage_seconds histograms on "
                         "METRICS. Off by default = zero overhead")
    ap.add_argument("--flight-recorder-capacity", type=int, default=8192,
                    help="span ring capacity PER THREAD (records; "
                         "rounded up to a power of two). At 32 B/record "
                         "the default is 256 KiB per serving thread")
    # Control-plane event journal (observability/events.py).
    ap.add_argument("--no-event-journal", action="store_true",
                    help="disable the control-plane event journal. ON by "
                         "default: controller moves and policy/reset "
                         "mutations are recorded in a bounded in-memory "
                         "ring (never the decide path)")
    ap.add_argument("--event-journal-capacity", type=int, default=4096,
                    help="events held in the journal ring (oldest "
                         "evicted; ~300 B/event)")
    ap.add_argument("--event-journal-dir", default=None, metavar="DIR",
                    help="also spill journal events to append-only "
                         "JSONL segments in DIR (bounded rotation) and "
                         "replay the on-disk tail into the ring at "
                         "startup")
    # HTTP gateway (serving/http_gateway.py).
    ap.add_argument("--http-port", type=int, default=None,
                    help="also serve the HTTP gateway (429 + X-RateLimit-* "
                         "headers, /healthz, /metrics) on this port; HTTP "
                         "decisions share the micro-batcher with binary "
                         "traffic")
    ap.add_argument("--http-reset", action="store_true",
                    help="expose POST /v1/reset on the HTTP gateway "
                         "(OFF by default: reset is a quota-erase lever "
                         "on a curl-able surface)")
    ap.add_argument("--http-reset-token", default=None,
                    help="bearer token required by /v1/reset (implies "
                         "--http-reset); Authorization header only — "
                         "query-string tokens are never accepted")
    ap.add_argument("--http-policy", action="store_true",
                    help="expose the tiered-override endpoint "
                         "(GET/POST/PUT/DELETE /v1/policy) on the HTTP "
                         "gateway (OFF by default: overrides are a "
                         "quota-GRANT lever on a curl-able surface)")
    ap.add_argument("--http-policy-token", default=None,
                    help="bearer token required by /v1/policy (implies "
                         "--http-policy); Authorization header only")
    ap.add_argument("--http-snapshot-token", default=None,
                    help="bearer token required by POST /v1/snapshot on "
                         "the HTTP gateway (the trigger is wired "
                         "whenever --snapshot-dir is set; without a "
                         "token it is open). Authorization header only")
    ap.add_argument("--http-tenants", action="store_true",
                    help="expose tenant management (GET/POST/PUT/DELETE "
                         "/v1/tenants) on the HTTP gateway (OFF by "
                         "default: a quota lever in both directions on "
                         "a curl-able surface)")
    ap.add_argument("--http-tenants-token", default=None,
                    help="bearer token required by /v1/tenants (implies "
                         "--http-tenants); Authorization header only")
    ap.add_argument("--debug-trace", action="store_true",
                    help="expose GET /debug/trace (Chrome-trace dump of "
                         "the flight recorder's recent spans), "
                         "/debug/events and /debug/profile (on-demand "
                         "torch.profiler capture) on the HTTP gateway. "
                         "OFF by default: traces reveal key traffic "
                         "timing — gate like /v1/policy")
    ap.add_argument("--debug-token", default=None,
                    help="bearer token required by the /debug endpoints "
                         "(implies --debug-trace); Authorization header "
                         "only, like every other token")
    # Live accuracy observatory (observability/audit.py, slo.py).
    ap.add_argument("--audit", action="store_true",
                    help="turn on the live accuracy observatory: a "
                         "deterministic hash-sampled fraction of live "
                         "decisions is mirrored into an exact shadow "
                         "oracle off the hot path; live false-deny/"
                         "false-allow rates with Wilson bounds land on "
                         "/metrics, /healthz, and GET /debug/audit, plus "
                         "the admission-SLO burn-rate block. Needs a "
                         "sketch-family backend. Off by default = "
                         "byte-identical hot path")
    ap.add_argument("--audit-sample", type=int, default=64,
                    help="audit 1 in N of the keyspace (hash-coherent: "
                         "a key is always or never audited, so its "
                         "windows stay whole; 1 audits everything)")
    ap.add_argument("--audit-token", default=None,
                    help="bearer token required by GET /debug/audit "
                         "(Authorization header only; without it the "
                         "endpoint is open whenever --audit is set)")
    ap.add_argument("--audit-twin", action="store_true",
                    help="also run the collision-free CMS twin online "
                         "(on the serving limiter's device), separating "
                         "pure-CMS collision error from semantic error "
                         "in the live stream; costs a twin step per "
                         "audited window, so it is off by default")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    cfg = Config(
        algorithm=Algorithm(args.algorithm), limit=args.limit,
        window=args.window, fail_open=args.fail_open,
        sketch=SketchParams(
            depth=args.sketch_depth, width=args.sketch_width, sub_windows=args.sub_windows,
            conservative_update=not args.no_conservative_update,
            hh_slots=args.hh_slots),
        dense=DenseParams(capacity=args.dense_capacity),
        persistence=PersistenceSpec(
            dir=args.snapshot_dir,
            snapshot_interval=args.snapshot_interval,
            snapshot_after_mutations=args.snapshot_after_mutations,
            retain=args.snapshot_retain,
            wal_fsync=args.wal_fsync),
        hierarchy=HierarchySpec(
            tenants=args.tenants, map_capacity=args.tenant_map,
            global_limit=args.global_limit,
            default_tenant_limit=args.default_tenant_limit))
    if cfg.hierarchy.enabled and args.backend != "sketch":
        raise SystemExit("--tenants needs a sketch-family backend "
                         "(--backend sketch)")
    if args.backend == "dense" and args.max_batch > ADMIT_CAPACITY:
        raise SystemExit(f"--max-batch {args.max_batch} with --backend "
                         f"dense: the card decides at most "
                         f"{ADMIT_CAPACITY} requests a dense launch")
    if args.controller and not cfg.hierarchy.enabled:
        raise SystemExit("--controller needs --tenants > 0")
    if (args.tenant or args.assign) and not cfg.hierarchy.enabled:
        raise SystemExit("--tenant/--assign need --tenants > 0")
    if args.audit and args.backend != "sketch":
        raise SystemExit("--audit needs a sketch-family backend "
                         "(exact/dense decisions are already exact — "
                         "there is nothing to audit)")
    if args.shards > 1 and not args.native:
        raise SystemExit("--shards needs --native (the asyncio front door "
                         "has one dispatcher)")
    if cfg.hierarchy.enabled and args.max_batch > ADMIT_CAPACITY:
        raise SystemExit(f"--max-batch {args.max_batch} with --tenants: the "
                         f"cascade decides at most {ADMIT_CAPACITY} requests "
                         f"a launch")
    return cfg


def max_window(args: argparse.Namespace, cfg: Config) -> int:
    """The most rows the batcher merges into one hashed window: twice
    ``--max-batch``, and with the cascade no more than one launch takes
    (``sketch_cuda.ADMIT_CAPACITY``)."""
    if cfg.hierarchy.enabled:
        return min(2 * args.max_batch, ADMIT_CAPACITY)
    return 2 * args.max_batch


def boot_tenants(hier, args: argparse.Namespace) -> None:
    """Apply --tenant NAME=LIMIT[:WEIGHT[:FLOOR]] and --assign
    KEY=TENANT boot flags (after recovery, so operator flags win over a
    snapshot's registry for the names they touch)."""
    for spec in args.tenant:
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise SystemExit(f"bad --tenant {spec!r}; expected "
                             f"NAME=LIMIT[:WEIGHT[:FLOOR]]")
        parts = rest.split(":")
        try:
            limit = int(parts[0]) or None
            weight = int(parts[1]) if len(parts) > 1 and parts[1] else 1
            floor = (int(parts[2])
                     if len(parts) > 2 and parts[2] else None)
        except ValueError:
            raise SystemExit(f"bad --tenant {spec!r}; expected "
                             f"NAME=LIMIT[:WEIGHT[:FLOOR]]") from None
        hier.set_tenant(name, limit, weight=weight, floor=floor)
    for spec in args.assign:
        key, _, tenant = spec.partition("=")
        if not key or not tenant:
            raise SystemExit(f"bad --assign {spec!r}; expected "
                             f"KEY=TENANT")
        hier.assign_tenant(key, tenant)


def setup_hierarchy(args: argparse.Namespace, cfg: Config, units, *,
                    slo_tracker=None, auditor=None):
    """Mount the cascade's management surface over the door's dispatch
    units (``HierarchyFanout``; the port's door has one), apply the boot
    flags, and build (not start) the AIMD controller when asked, its
    gauges in the door's registry, reading the SLO tracker's and the
    auditor's statuses when they run (``--audit``). Returns ``(hier,
    controller)``, (None, None) when the hierarchy is off."""
    if not cfg.hierarchy.enabled:
        return None, None
    from ratelimiter_tpu_torch.hierarchy import AIMDController, HierarchyFanout
    from ratelimiter_tpu_torch.observability import metrics

    hier = HierarchyFanout(list(units))
    boot_tenants(hier, args)
    controller = None
    if args.controller:
        controller = AIMDController(
            hier,
            slo_status=(slo_tracker.status if slo_tracker is not None
                        else None),
            audit_status=(auditor.status if auditor is not None
                          else None),
            interval=args.controller_interval, registry=metrics.DEFAULT)
    return hier, controller


# ------------------------------------------------------ /healthz blocks


def _units(limiters) -> list:
    """The backend dispatch units under ``limiters`` (decorators and the
    persistence wrapper peeled off)."""
    from ratelimiter_tpu_torch.observability.decorators import undecorated

    return [sl for lim in limiters for sl in undecorated(lim).sub_limiters()]


def _envelope_health(limiters) -> dict:
    """Accuracy-envelope fields for /healthz (windowed sketch only): a
    growing overload_periods flags an undersized geometry at the
    operational surface, not just in logs."""
    lims = [lim for lim in _units(limiters) if hasattr(lim, "_period_mass")]
    if not lims:
        return {}
    masses = [lim.in_window_admitted_mass() for lim in lims]
    return {"overload_periods": sum(lim.overload_periods for lim in lims),
            "in_window_admitted_mass": sum(masses),
            "mass_budget": sum(lim.mass_budget for lim in lims),
            "shards_overloaded": sum(
                mass > lim.mass_budget
                for lim, mass in zip(lims, masses)),
            "overload_policy": lims[0].config.sketch.overload_policy}


def _debt_slab_health(limiters) -> dict:
    """Debt-slab occupancy/collision fields for /healthz (token-bucket
    sketch only): occupancy and collision_p report the worst unit, cell
    counts sum. One device read a call — /healthz cadence, never the
    decide path."""
    lims = [lim for lim in _units(limiters)
            if hasattr(lim, "debt_slab_stats")]
    if not lims:
        return {}
    stats = [lim.debt_slab_stats() for lim in lims]
    return {"debt_slab": {
        "occupancy": max(s["occupancy"] for s in stats),
        "collision_p": max(s["collision_p"] for s in stats),
        "nonzero_cells": sum(s["nonzero_cells"] for s in stats),
        "cells": sum(s["cells"] for s in stats),
        "units": len(stats)}}


def _consumers_health(limiters, k: int = 10) -> dict:
    """Top-K consumer block for /healthz (the side table): per-unit
    ``consumer_stats`` merged into one ranking. Consumer identities are
    hash tokens, never raw keys. Empty when no unit runs a side table."""
    units = [(i, lim) for i, lim in enumerate(_units(limiters))
             if getattr(lim, "has_hh", False)]
    if not units:
        return {}
    rows = []
    occupied = slots = mass = 0
    for i, lim in units:
        st = lim.consumer_stats(k=k)
        slots += st["slots"]
        occupied += st["occupied"]
        mass += st.get("tracked_mass", 0)
        for row in st["top"]:
            rows.append({**row, "slice": i})
    rows.sort(key=lambda r: -r["in_window"])
    return {"consumers": {
        "slots": slots,
        "occupied": occupied,
        "tracked_mass": mass,
        "top": rows[:k]}}


def _audit_health() -> dict:
    """Audit envelope for /healthz: the observatory's headline numbers
    (rates, confidence, raw tallies, drop counters); the per-slice
    breakdown lives on GET /debug/audit."""
    from ratelimiter_tpu_torch.observability import audit

    aud = audit.AUDITOR
    if aud is None:
        return {}
    st = aud.status()
    return {"audit": {
        "sample": st["sample"],
        "samples": st["samples"],
        "false_deny_rate": st["false_deny_rate"],
        "false_deny_wilson95": st["false_deny_wilson95"],
        "false_allow_rate": st["false_allow_rate"],
        "false_denies": st["false_denies"],
        "false_allows": st["false_allows"],
        "oracle_allows": st["oracle_allows"],
        "fail_open_samples": st["fail_open_samples"],
        "dropped_decisions": st["dropped_decisions"],
        "oracle_errors": st["oracle_errors"]}}


def _slo_health(slo) -> dict:
    return {"slo": slo.status()} if slo is not None else {}


def _events_health() -> dict:
    from ratelimiter_tpu_torch.observability import events

    j = events.JOURNAL
    return {"events": j.status()} if j is not None else {}


def _hierarchy_health(hier, controller) -> dict:
    """Cascade block for /healthz: per-scope in-window mass and
    effective/ceiling limits, plus the AIMD controller's move counters
    when it runs."""
    if hier is None:
        return {}
    st = hier.hierarchy_stats()
    if controller is not None:
        st["controller"] = {"ticks": controller.ticks,
                            "tightened": controller.tightened,
                            "relaxed": controller.relaxed,
                            "interval": controller.interval}
    return {"hierarchy": st}


def make_member_info(args: argparse.Namespace, registry=None):
    """Member identity as the JAX binary gives it outside a fleet (no
    epoch): the door (``native`` with the port's door ABI, or
    ``asyncio`` with ``py``), the /healthz ``member`` block, also
    exported as the ``rate_limiter_member_info`` identity gauge (value 1,
    the block's fields as labels, the member id under ``id``) on
    ``registry`` (the process default when None), refreshed at scrape
    time. Returns ``(info, collect)``: the block's callable and the
    registry hook, which the caller removes at shutdown."""
    from ratelimiter_tpu_torch.observability import metrics

    registry = registry if registry is not None else metrics.DEFAULT
    abi = "py"
    if args.native:
        from ratelimiter_tpu_torch.serving.native_server import _ABI

        abi = str(_ABI)

    def info() -> dict:
        return {"self": f"{args.host}:{args.port}", "backend": args.backend,
                "algorithm": args.algorithm,
                "door": "native" if args.native else "asyncio", "abi": abi,
                "fleet_epoch": None}

    g_info = registry.gauge(
        "rate_limiter_member_info",
        "Identity gauge (value always 1): fleet self id, current "
        "ownership-map epoch, serving door + native ABI, and backend "
        "kind as labels — joins rolled-up series and stitched traces "
        "to a member (ADR-021)")

    def collect() -> None:
        # Clear, then set: a gauge only overwrites the label sets it is
        # told about. "self" cannot be a label keyword (it renders as
        # "id").
        g_info.clear()
        g_info.set(1.0, **{("id" if k == "self" else k):
                           ("-" if v is None else str(v))
                           for k, v in info().items()})

    registry.add_collect_hook(collect)
    return info, collect


def make_threadsafe_decide(batcher, loop):
    """Single-decision bridge from the gateway's worker threads into the
    event loop's micro-batcher: every surface shares device dispatches.
    Trace-aware: a sampled HTTP request's trace id rides into the
    batcher so its coalesced dispatch records under it. Deadline-aware:
    a caller's RELATIVE budget anchors to the local monotonic clock and
    the batcher sheds the work per policy if it expires in the
    coalescing queue."""
    def decide(key: str, n: int, trace_id: int = 0, deadline=None):
        abs_deadline = (time.monotonic() + float(deadline)
                        if deadline is not None else 0.0)
        return asyncio.run_coroutine_threadsafe(
            batcher.submit(key, n, trace_id=trace_id,
                           deadline=abs_deadline),
            loop).result(timeout=30)

    return decide


def setup_audit(args: argparse.Namespace, cfg: Config, limiter):
    """``--audit``: the process-wide shadow auditor (its twin, under
    ``--audit-twin``, on the serving limiter's device) following the
    served limiter's live limit and window, and the SLO burn tracker,
    both exporting their gauges on the default registry. Returns
    ``(auditor, slo_tracker)``, (None, None) without ``--audit``."""
    if not args.audit:
        return None, None
    from ratelimiter_tpu_torch.observability import audit, metrics
    from ratelimiter_tpu_torch.observability.slo import SloBurnTracker

    auditor = audit.enable(cfg, sample=args.audit_sample,
                           n_slices=len(_units([limiter])),
                           include_twin=args.audit_twin,
                           registry=metrics.DEFAULT,
                           live_config=lambda: limiter.config,
                           device=args.device)
    slo_tracker = SloBurnTracker(metrics.DEFAULT)
    slo_tracker.attach()
    return auditor, slo_tracker


def make_audit_status(auditor, slo_tracker, limiters):
    """GET /debug/audit payload: the auditor's rates, confidence and
    attribution, the top-K consumers and the SLO burn block."""
    def status() -> dict:
        out = auditor.status() if auditor is not None else {}
        out.update(_consumers_health(limiters))
        out.update(_slo_health(slo_tracker))
        return out

    return status


def make_gateway(args: argparse.Namespace, limiter, server, loop, *,
                 member_info, persist=None, hier=None, controller=None,
                 auditor=None, slo_tracker=None):
    """The HTTP gateway as the JAX binary's asyncio door builds it: its
    decisions through the door's batcher, /healthz from the blocks
    above, the levers and debug routes behind their flags."""
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.serving.http_gateway import HttpGateway

    def health() -> dict:
        return {"serving": True,
                "decisions_total": server.batcher.decisions_total,
                "policy_overrides": limiter.override_count(),
                "transport": server.transport_stats(),
                "member": member_info(),
                **_envelope_health([limiter]),
                **_debt_slab_health([limiter]),
                **_consumers_health([limiter]),
                **_audit_health(),
                **_slo_health(slo_tracker),
                **_hierarchy_health(hier, controller),
                **_events_health(),
                **(persist.status() if persist is not None else {})}

    return HttpGateway(
        make_threadsafe_decide(server.batcher, loop), limiter.reset,
        host=args.host, port=args.http_port,
        metrics_render=metrics.DEFAULT.render,
        health=health,
        enable_reset=bool(args.http_reset or args.http_reset_token),
        reset_token=args.http_reset_token,
        policy_set=limiter.set_override,
        policy_get=limiter.get_override,
        policy_delete=limiter.delete_override,
        enable_policy=bool(args.http_policy or args.http_policy_token),
        policy_token=args.http_policy_token,
        snapshot=(persist.snapshot_now if persist is not None else None),
        snapshot_token=args.http_snapshot_token,
        enable_debug=bool(args.debug_trace or args.debug_token),
        debug_token=args.debug_token,
        audit_status=(make_audit_status(auditor, slo_tracker, [limiter])
                      if args.audit else None),
        audit_token=args.audit_token,
        tenants=hier,
        enable_tenants=bool(args.http_tenants or args.http_tenants_token),
        tenants_token=args.http_tenants_token)


def build_limiter_stack(limiter, args, registry=None, shard: int = 0):
    """Apply the configured decorator stack, innermost first (the JAX
    binary's order): Tracing (annotates the real device dispatch),
    CircuitBreaker (judges backend health from real calls), Metrics
    (observes everything, including breaker short-circuits, into
    ``registry``, the process default when None; ``shard`` labels its
    gauges, so dispatch shards report distinct series), Logging
    (outermost, sees final outcomes)."""
    from ratelimiter_tpu_torch.observability.decorators import (
        CircuitBreakerDecorator,
        LoggingDecorator,
        MetricsDecorator,
        TracingDecorator,
    )

    if args.trace:
        limiter = TracingDecorator(limiter)
    if args.circuit_breaker:
        limiter = CircuitBreakerDecorator(
            limiter, failure_threshold=args.breaker_threshold,
            cooldown=args.breaker_cooldown, registry=registry)
    if not args.no_metrics:
        limiter = MetricsDecorator(limiter, registry=registry,
                                   shard=str(shard))
    if args.log_decisions:
        limiter = LoggingDecorator(limiter,
                                   redact_keys=args.log_redact_keys)
    return limiter


def enable_observability(args: argparse.Namespace, registry=None) -> None:
    """The flight recorder (``--flight-recorder``) and the event journal
    (on unless ``--no-event-journal``), their families in ``registry``
    (the process default when None), as the JAX binary enables them:
    before any serving thread starts and before anything that emits
    (the controller)."""
    from ratelimiter_tpu_torch.observability import events, metrics, tracing

    registry = registry if registry is not None else metrics.DEFAULT
    if args.flight_recorder:
        tracing.enable(args.flight_recorder_capacity, registry=registry)
    if not args.no_event_journal:
        events.enable(args.event_journal_capacity,
                      host=f"{args.host}:{args.port}", registry=registry,
                      spill_dir=args.event_journal_dir)


def prewarm(limiter, *, door: bool = False) -> float:
    """Build and load what the first frames would otherwise build: the
    C++ bulk hasher, with ``door`` the native door's extension, and on a
    CUDA device the backend's kernel libraries (one nvcc each, in
    parallel). Touches no limiter state. Returns the seconds it took."""
    from ratelimiter_tpu_torch import native

    t = time.perf_counter()
    native.bulk_hash_u64(["prewarm"])
    if door:
        native.load_server()
    device = getattr(limiter, "device", None)
    if device is not None and device.type == "cuda":
        from ratelimiter_tpu_torch.ops import (
            _build,
            bucket_cuda,
            dense_cuda,
            sketch_cuda,
        )

        from ratelimiter_tpu_torch.algorithms.dense import DenseLimiter

        mods = ([dense_cuda] if isinstance(limiter, DenseLimiter)
                else [sketch_cuda, bucket_cuda])
        _build.build_all([m._SOURCE for m in mods])
        for m in mods:
            m.build()
    return time.perf_counter() - t


def _signals(loop, stop):
    """``stop``, or a new event that SIGINT/SIGTERM set."""
    if stop is None:
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
    return stop


async def serve(args: argparse.Namespace, *, make_limiter=None,
                ready=None, stop=None) -> None:
    """The binary's service, start to graceful stop. ``make_limiter(cfg)``
    builds the backend limiter instead of ``create_limiter`` (a
    caller's recording proxy); ``ready``, an asyncio future, is given the
    running pieces (``limiter``, ``server``, ``gateway``, ``auditor``,
    ``slo``, ``hier``, ``controller``, ``persist``, ``member_info``) once
    the door and the
    gateway listen; ``stop``, an asyncio event, ends the service instead
    of SIGINT/SIGTERM. ``--native`` serves through the C++ door
    (``serve_native``)."""
    logging.basicConfig(level=args.log_level.upper())
    enable_observability(args)
    cfg = build_config(args)
    # A multi-shard native door: each dispatch shard enforces its share
    # of every tenant and global limit (the clones inherit the divisor).
    divisor = (args.shards if cfg.hierarchy.enabled and args.native
               and args.shards > 1 and args.backend == "sketch" else 1)
    limiter = (make_limiter(cfg) if make_limiter is not None
               else create_limiter(cfg, backend=args.backend,
                                   device=args.device,
                                   hier_divisor=divisor))
    built_s = prewarm(limiter, door=args.native)
    persist = None
    if cfg.persistence.enabled:
        from ratelimiter_tpu_torch.persistence import PersistenceManager

        persist = PersistenceManager(cfg.persistence)

    def decorate(lim, shard: int = 0):
        # The JAX binary's order: the decorator stack, then the
        # persistence wrapper outermost, so every surface's mutations
        # reach the WAL.
        lim = build_limiter_stack(lim, args, shard=shard)
        return persist.wrap(lim) if persist is not None else lim

    limiter = decorate(limiter)
    if args.native:
        await serve_native(args, cfg, limiter, persist, decorate, built_s,
                           ready=ready, stop=stop)
        return
    if persist is not None:
        # Attach, recover before the door listens, then start the
        # background snapshots.
        persist.attach([limiter])
        t = time.perf_counter()
        report = persist.recover()
        print(f"recovered: {report.summary()} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        persist.start()
    # The observatory goes in before the door listens, so the first
    # decision can already be mirrored.
    auditor, slo_tracker = setup_audit(args, cfg, limiter)
    member_info, member_collect = make_member_info(args)
    hier, controller = setup_hierarchy(args, cfg, [limiter],
                                       slo_tracker=slo_tracker,
                                       auditor=auditor)
    server = RateLimitServer(
        limiter, args.listen or args.host, args.port,
        max_batch=args.max_batch,
        max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms is not None else None),
        inflight=args.inflight,
        snapshot=persist.snapshot_now if persist is not None else None,
        max_window=max_window(args, cfg), shm=args.shm,
        shm_dir=args.shm_dir, shm_ring_bytes=args.shm_ring_bytes)
    await server.start()
    loop = asyncio.get_running_loop()
    gateway = None
    if args.http_port is not None:
        gateway = make_gateway(args, limiter, server, loop,
                               member_info=member_info, persist=persist,
                               hier=hier, controller=controller,
                               auditor=auditor, slo_tracker=slo_tracker)
        gateway.start()
    if controller is not None:
        controller.start()
    stop = _signals(loop, stop)
    print(f"serving {args.algorithm}/{args.backend} "
          f"limit={limiter.config.limit}/{limiter.config.window:g}s "
          f"on {args.listen or f'{args.host}:{server.port}'} "
          f"device={getattr(limiter, 'device', 'host')} "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)"
          + (" shm" if args.shm else "")
          + (f" http:{gateway.port}" if gateway is not None else ""),
          flush=True)
    if ready is not None:
        ready.set_result(SimpleNamespace(
            limiter=limiter, server=server, gateway=gateway,
            auditor=auditor, slo=slo_tracker, hier=hier,
            controller=controller, persist=persist,
            member_info=member_info))
    try:
        await stop.wait()
    finally:
        if controller is not None:
            controller.stop()
        if gateway is not None:
            gateway.shutdown()
        await server.shutdown()
        if persist is not None:
            # After the drain, before close: the final snapshot captures
            # every answered decision — a graceful shutdown loses nothing.
            persist.stop()
        _stop_observability(auditor, slo_tracker, member_collect)
        limiter.close()
        from ratelimiter_tpu_torch.observability import events

        events.disable()


def _stop_observability(auditor, slo_tracker, member_collect) -> None:
    from ratelimiter_tpu_torch.observability import audit, metrics

    if auditor is not None:
        auditor.flush(timeout=2.0)
        audit.disable()
    if slo_tracker is not None:
        slo_tracker.detach()
    metrics.DEFAULT.remove_collect_hook(member_collect)


async def serve_native(args: argparse.Namespace, cfg: Config, limiter,
                       persist, decorate, built_s: float, *, ready=None,
                       stop=None) -> None:
    """``--native``: the C++ door (serving/native_server.py) over
    ``limiter`` and, with ``--shards N``, N - 1 clones each under
    ``decorate(clone, i)`` (the decorator stack under shard ``i``'s
    label, the persistence wrapper); the JAX binary's native branch
    without the mesh, the fleet, DCN, leases, gRPC and quarantine. The
    persistence manager attaches every shard with the door's router and
    recovers before the door listens; the HTTP gateway decides through
    ``decide_one`` (the shard router)."""
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.serving.http_gateway import HttpGateway
    from ratelimiter_tpu_torch.serving.native_server import (
        NativeRateLimitServer,
    )

    auditor, slo_tracker = setup_audit(args, cfg, limiter)
    member_info, member_collect = make_member_info(args)
    server = NativeRateLimitServer(
        limiter, args.listen or args.host, args.port,
        shm=args.shm, shm_dir=args.shm_dir,
        shm_ring_bytes=args.shm_ring_bytes,
        max_batch=args.max_batch, max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms else None),
        inflight=args.inflight, shards=args.shards,
        net_engine=args.net_engine, io_rings=args.io_rings,
        shard_decorate=lambda lim, i: decorate(lim, shard=i))
    if persist is not None:
        # Recover BEFORE the listener opens: the restored snapshot and
        # the replayed mutations precede the first decision.
        persist.attach(server.shard_limiters, shard_of=server.shard_of)
        t = time.perf_counter()
        report = persist.recover()
        print(f"recovered: {report.summary()} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        persist.start()
    server.start()
    # After recovery (the hier_* columns restore first), before the
    # gateway, whose /healthz and /v1/tenants mount it.
    hier, controller = setup_hierarchy(args, cfg, server.shard_limiters,
                                       slo_tracker=slo_tracker,
                                       auditor=auditor)
    gateway = None
    if args.http_port is not None:
        lims = server.shard_limiters

        def health() -> dict:
            return {"serving": True,
                    "decisions_total": server.stats()["decisions_total"],
                    "policy_overrides": lims[0].override_count(),
                    "transport": server.transport_stats(),
                    "member": member_info(),
                    **_envelope_health(lims),
                    **_debt_slab_health(lims),
                    **_consumers_health(lims),
                    **_audit_health(),
                    **_slo_health(slo_tracker),
                    **_hierarchy_health(hier, controller),
                    **_events_health(),
                    **(persist.status() if persist is not None else {})}

        gateway = HttpGateway(
            server.decide_one, server.reset_one,
            host=args.host, port=args.http_port,
            metrics_render=metrics.DEFAULT.render,
            health=health,
            enable_reset=bool(args.http_reset or args.http_reset_token),
            reset_token=args.http_reset_token,
            # Overrides apply on every shard (keys hash-route).
            policy_set=server.set_override_all,
            policy_get=server.get_override_one,
            policy_delete=server.delete_override_all,
            enable_policy=bool(args.http_policy or args.http_policy_token),
            policy_token=args.http_policy_token,
            snapshot=(persist.snapshot_now if persist is not None
                      else None),
            snapshot_token=args.http_snapshot_token,
            enable_debug=bool(args.debug_trace or args.debug_token),
            debug_token=args.debug_token,
            audit_status=(make_audit_status(auditor, slo_tracker, lims)
                          if args.audit else None),
            audit_token=args.audit_token,
            tenants=hier,
            enable_tenants=bool(args.http_tenants
                                or args.http_tenants_token),
            tenants_token=args.http_tenants_token)
        gateway.start()
    if controller is not None:
        controller.start()
    stop = _signals(asyncio.get_running_loop(), stop)
    net = server.transport_stats()["net"]
    print(f"serving(native) {args.algorithm}/{args.backend} "
          f"limit={limiter.config.limit}/{limiter.config.window:g}s "
          f"on {args.listen or f'{args.host}:{server.port}'} "
          f"device={getattr(limiter, 'device', 'host')} "
          f"shards={args.shards} net={net.get('engine', '?')}"
          f"x{net.get('rings', '?')}(probe={net.get('uring_probe', '?')}) "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)"
          + (" shm" if args.shm else "")
          + (f" http:{gateway.port}" if gateway is not None else ""),
          flush=True)
    if ready is not None:
        ready.set_result(SimpleNamespace(
            limiter=limiter, server=server, gateway=gateway,
            auditor=auditor, slo=slo_tracker, hier=hier,
            controller=controller, persist=persist,
            member_info=member_info))
    try:
        await stop.wait()
    finally:
        if controller is not None:
            controller.stop()
        if gateway is not None:
            gateway.shutdown()
        if persist is not None:
            # The door first (it answers what is in flight), then the
            # final snapshot of every shard, then the clones close.
            server.shutdown(close_limiters=False)
            persist.stop()
            server.close_shards()
        else:
            server.shutdown()
        _stop_observability(auditor, slo_tracker, member_collect)
        limiter.close()
        from ratelimiter_tpu_torch.observability import events

        events.disable()


def main(argv=None) -> None:
    asyncio.run(serve(parse_args(argv)))


if __name__ == "__main__":
    main()
