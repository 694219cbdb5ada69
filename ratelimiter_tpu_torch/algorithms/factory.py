"""Limiter factory — the port's constructor seam.

The JAX package's ``create_limiter`` selects among exact, dense, sketch
and mesh backends. This slice ports the windowed sketch only:
``backend="sketch"`` with a SLIDING_WINDOW, FIXED_WINDOW or TPU_SKETCH
config. Every other backend raises InvalidConfigError naming its ROADMAP
item.
"""

from __future__ import annotations

from typing import Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.clock import Clock
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError

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
        from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter

        return SketchLimiter(config, clock, device=device)
    if backend in _NOT_PORTED:
        raise InvalidConfigError(_NOT_PORTED[backend])
    raise InvalidConfigError(
        f"unknown backend {backend!r}; expected one of {BACKENDS}")
