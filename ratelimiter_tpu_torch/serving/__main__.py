"""Server binary: ``python -m ratelimiter_tpu_torch.serving``.

Serves a count-min-sketch limiter on the card (``--device cuda``, the
default; ``--device cpu`` runs the kernels' plain versions): the windowed
sketch, or with ``--algorithm token_bucket`` the sketched token bucket
(``--sub-windows`` and ``--no-conservative-update`` do not apply to it),
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
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import time

from ratelimiter_tpu_torch import (
    Algorithm,
    Config,
    PersistenceSpec,
    SketchParams,
    create_limiter,
)
from ratelimiter_tpu_torch.serving.server import RateLimitServer

_ALGORITHMS = ("sliding_window", "fixed_window", "tpu_sketch",
               "token_bucket")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="ratelimiter_tpu_torch.serving",
        description="Count-min-sketch rate limiter on a CUDA card.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8432)
    ap.add_argument("--algorithm", default="sliding_window",
                    choices=_ALGORITHMS)
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--window", type=float, default=60.0,
                    help="window length in seconds")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--width", type=int, default=65536)
    ap.add_argument("--sub-windows", type=int, default=60)
    ap.add_argument("--no-conservative-update", action="store_true",
                    help="plain sums instead of conservative update")
    ap.add_argument("--fail-open", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=4096,
                    help="micro-batcher flush size. Hashed windows merge "
                         "up to 2x this many rows; above --max-batch 4096 "
                         "they pass the one-launch admission capacity "
                         "(8192 keys) and run the composed back, ~0.6 ms "
                         "a window")
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
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    return Config(
        algorithm=Algorithm(args.algorithm), limit=args.limit,
        window=args.window, fail_open=args.fail_open,
        sketch=SketchParams(
            depth=args.depth, width=args.width, sub_windows=args.sub_windows,
            conservative_update=not args.no_conservative_update),
        persistence=PersistenceSpec(
            dir=args.snapshot_dir,
            snapshot_interval=args.snapshot_interval,
            snapshot_after_mutations=args.snapshot_after_mutations,
            retain=args.snapshot_retain,
            wal_fsync=args.wal_fsync))


def prewarm(device) -> float:
    """Build and load what the first frames would otherwise build: the
    C++ bulk hasher, and on a CUDA device both kernel libraries (one nvcc
    each, in parallel). Touches no limiter state. Returns the seconds it
    took."""
    import torch

    from ratelimiter_tpu_torch import native

    t = time.perf_counter()
    native.bulk_hash_u64(["prewarm"])
    if torch.device(device).type == "cuda":
        from ratelimiter_tpu_torch.ops import _build, bucket_cuda, sketch_cuda

        _build.build_all(["sketch_kernels", "bucket_kernels"])
        sketch_cuda.build()
        bucket_cuda.build()
    return time.perf_counter() - t


async def _serve(args: argparse.Namespace) -> None:
    cfg = build_config(args)
    limiter = create_limiter(cfg, backend="sketch", device=args.device)
    built_s = prewarm(limiter.device)
    persist = None
    if cfg.persistence.enabled:
        from ratelimiter_tpu_torch.persistence import PersistenceManager

        # The JAX binary's order: wrap (outermost), attach, recover before
        # the door listens, then start the background snapshots.
        persist = PersistenceManager(cfg.persistence)
        limiter = persist.wrap(limiter)
        persist.attach([limiter])
        t = time.perf_counter()
        report = persist.recover()
        print(f"recovered: {report.summary()} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        persist.start()
    server = RateLimitServer(
        limiter, args.host, args.port, max_batch=args.max_batch,
        max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms is not None else None),
        inflight=args.inflight,
        snapshot=persist.snapshot_now if persist is not None else None)
    await server.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"serving {args.algorithm} "
          f"limit={limiter.config.limit}/{limiter.config.window:g}s "
          f"on {args.host}:{server.port} device={limiter.device} "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)",
          flush=True)
    try:
        await stop.wait()
    finally:
        await server.shutdown()
        if persist is not None:
            # After the drain, before close: the final snapshot captures
            # every answered decision — a graceful shutdown loses nothing.
            persist.stop()
        limiter.close()


def main(argv=None) -> None:
    asyncio.run(_serve(parse_args(argv)))


if __name__ == "__main__":
    main()
