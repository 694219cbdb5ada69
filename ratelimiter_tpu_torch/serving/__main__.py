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
binary's flags, refusals and boot order; its HTTP ``/v1/tenants`` and
``/healthz`` hierarchy block are not ported (the port's door has no HTTP,
ROADMAP A13).

Observability, with the JAX binary's flags and defaults: every limiter is
wrapped in the decorator stack (``build_limiter_stack``: ``--trace``
TracingDecorator, ``--circuit-breaker`` CircuitBreakerDecorator,
MetricsDecorator unless ``--no-metrics``, ``--log-decisions``
LoggingDecorator, innermost first, the persistence wrapper outermost);
``--flight-recorder`` turns the flight recorder on before any serving
thread starts (``rate_limiter_stage_seconds`` on METRICS); the event
journal is on unless ``--no-event-journal`` (``--event-journal-dir``
spills it to JSONL segments and replays their tail at start).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import time

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
    ap.add_argument("--algorithm", default="sliding_window",
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


def setup_hierarchy(args: argparse.Namespace, cfg: Config, units):
    """Mount the cascade's management surface over the door's dispatch
    units (``HierarchyFanout``; the port's door has one), apply the boot
    flags, and build (not start) the AIMD controller when asked, its
    gauges in the door's registry. Returns ``(hier, controller)``, (None,
    None) when the hierarchy is off."""
    if not cfg.hierarchy.enabled:
        return None, None
    from ratelimiter_tpu_torch.hierarchy import AIMDController, HierarchyFanout
    from ratelimiter_tpu_torch.observability import metrics

    hier = HierarchyFanout(list(units))
    boot_tenants(hier, args)
    controller = None
    if args.controller:
        controller = AIMDController(hier, interval=args.controller_interval,
                                    registry=metrics.DEFAULT)
    return hier, controller


def build_limiter_stack(limiter, args, registry=None):
    """Apply the configured decorator stack, innermost first (the JAX
    binary's order): Tracing (annotates the real device dispatch),
    CircuitBreaker (judges backend health from real calls), Metrics
    (observes everything, including breaker short-circuits, into
    ``registry``, the process default when None), Logging (outermost,
    sees final outcomes)."""
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
        limiter = MetricsDecorator(limiter, registry=registry)
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


def prewarm(limiter) -> float:
    """Build and load what the first frames would otherwise build: the
    C++ bulk hasher, and on a CUDA device the backend's kernel libraries
    (one nvcc each, in parallel). Touches no limiter state. Returns the
    seconds it took."""
    from ratelimiter_tpu_torch import native

    t = time.perf_counter()
    native.bulk_hash_u64(["prewarm"])
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


async def _serve(args: argparse.Namespace) -> None:
    logging.basicConfig(level=args.log_level.upper())
    enable_observability(args)
    cfg = build_config(args)
    limiter = create_limiter(cfg, backend=args.backend, device=args.device)
    built_s = prewarm(limiter)
    limiter = build_limiter_stack(limiter, args)
    persist = None
    if cfg.persistence.enabled:
        from ratelimiter_tpu_torch.persistence import PersistenceManager

        # The JAX binary's order: wrap (outermost, around the decorator
        # stack), attach, recover before the door listens, then start the
        # background snapshots.
        persist = PersistenceManager(cfg.persistence)
        limiter = persist.wrap(limiter)
        persist.attach([limiter])
        t = time.perf_counter()
        report = persist.recover()
        print(f"recovered: {report.summary()} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        persist.start()
    _, controller = setup_hierarchy(args, cfg, [limiter])
    server = RateLimitServer(
        limiter, args.host, args.port, max_batch=args.max_batch,
        max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms is not None else None),
        inflight=args.inflight,
        snapshot=persist.snapshot_now if persist is not None else None,
        max_window=max_window(args, cfg))
    await server.start()
    if controller is not None:
        controller.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"serving {args.algorithm}/{args.backend} "
          f"limit={limiter.config.limit}/{limiter.config.window:g}s "
          f"on {args.host}:{server.port} "
          f"device={getattr(limiter, 'device', 'host')} "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)",
          flush=True)
    try:
        await stop.wait()
    finally:
        if controller is not None:
            controller.stop()
        await server.shutdown()
        if persist is not None:
            # After the drain, before close: the final snapshot captures
            # every answered decision — a graceful shutdown loses nothing.
            persist.stop()
        limiter.close()
        from ratelimiter_tpu_torch.observability import events

        events.disable()


def main(argv=None) -> None:
    asyncio.run(_serve(parse_args(argv)))


if __name__ == "__main__":
    main()
