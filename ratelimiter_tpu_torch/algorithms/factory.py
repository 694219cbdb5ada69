"""Limiter factory — the port's constructor seam.

The JAX package's ``create_limiter`` selects among exact, dense, sketch
and mesh backends. The port serves ``backend="sketch"``: the windowed
sketch for a SLIDING_WINDOW, FIXED_WINDOW or TPU_SKETCH config, the
sketched token bucket for a TOKEN_BUCKET one. Every other backend raises
InvalidConfigError naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.clock import Clock
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.core.types import Algorithm

BACKENDS = ("sketch",)

_NOT_PORTED = {
    "exact": "the exact backend is pure Python and needs no port; use "
             "ratelimiter_tpu's",
    "dense": "the dense backend is not ported yet (ROADMAP A7)",
    "mesh": "multi-GPU serving is not ported yet (ROADMAP A8)",
}


def create_limiter(config: Config, backend: str = "sketch",
                   clock: Optional[Clock] = None,
                   device="cuda") -> RateLimiter:
    """Build a limiter whose state lives on ``device`` (default the CUDA
    card; without one this raises — pass ``device="cpu"`` to run on the
    CPU with the kernels' plain versions). No I/O happens until the first
    decision."""
    if backend == "sketch":
        if config.algorithm is Algorithm.TOKEN_BUCKET:
            from ratelimiter_tpu_torch.algorithms.sketch import (
                SketchTokenBucketLimiter,
            )

            return SketchTokenBucketLimiter(config, clock, device=device)
        from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter

        return SketchLimiter(config, clock, device=device)
    if backend in _NOT_PORTED:
        raise InvalidConfigError(_NOT_PORTED[backend])
    raise InvalidConfigError(
        f"unknown backend {backend!r}; expected one of {BACKENDS}")
