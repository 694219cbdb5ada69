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
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import time

from ratelimiter_tpu_torch import Algorithm, Config, SketchParams, create_limiter
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
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    return Config(
        algorithm=Algorithm(args.algorithm), limit=args.limit,
        window=args.window, fail_open=args.fail_open,
        sketch=SketchParams(
            depth=args.depth, width=args.width, sub_windows=args.sub_windows,
            conservative_update=not args.no_conservative_update))


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
    limiter = create_limiter(build_config(args), backend="sketch",
                             device=args.device)
    built_s = prewarm(limiter.device)
    server = RateLimitServer(
        limiter, args.host, args.port, max_batch=args.max_batch,
        max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms is not None else None),
        inflight=args.inflight)
    await server.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"serving {args.algorithm} limit={args.limit}/{args.window:g}s "
          f"on {args.host}:{server.port} device={limiter.device} "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)",
          flush=True)
    try:
        await stop.wait()
    finally:
        await server.shutdown()
        limiter.close()


def main(argv=None) -> None:
    asyncio.run(_serve(parse_args(argv)))


if __name__ == "__main__":
    main()
