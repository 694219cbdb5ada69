"""Server binary: ``python -m ratelimiter_tpu_torch.serving``.

Serves a count-min-sketch limiter on the card (``--device cuda``, the
default; ``--device cpu`` runs the kernels' plain versions): the windowed
sketch, or with ``--algorithm token_bucket`` the sketched token bucket
(``--sub-windows`` and ``--no-conservative-update`` do not apply to it). Prints a line
starting with ``serving`` once it listens; SIGINT/SIGTERM stop it.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

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
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    return Config(
        algorithm=Algorithm(args.algorithm), limit=args.limit,
        window=args.window, fail_open=args.fail_open,
        sketch=SketchParams(
            depth=args.depth, width=args.width, sub_windows=args.sub_windows,
            conservative_update=not args.no_conservative_update))


async def _serve(args: argparse.Namespace) -> None:
    limiter = create_limiter(build_config(args), backend="sketch",
                             device=args.device)
    server = RateLimitServer(limiter, args.host, args.port)
    await server.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"serving {args.algorithm} limit={args.limit}/{args.window:g}s "
          f"on {args.host}:{server.port} device={limiter.device}",
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
