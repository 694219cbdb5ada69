"""Limiter factory — the port's constructor seam.

The JAX package's ``create_limiter`` selects among exact, dense, sketch
and mesh backends, and so does the port's: ``sketch`` (the default; the
windowed sketch for a SLIDING_WINDOW, FIXED_WINDOW or TPU_SKETCH config,
the sketched token bucket for a TOKEN_BUCKET one), ``dense`` (exact
slot-addressed state on the device, every algorithm), ``exact`` (host
dicts, the conformance oracle; it takes no device) and ``mesh`` (the
sliced serving tier, parallel/: ``SlicedMeshLimiter``, or with
``MeshSpec.router="collective"`` the ``CollectiveMeshLimiter``;
``config.mesh.devices`` slices on the card's ``cuda:0..N-1``, or N
slices on the CPU, or the explicit ``devices=`` list).
"""

from __future__ import annotations

from typing import Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.clock import Clock
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.core.types import Algorithm

BACKENDS = ("exact", "dense", "sketch", "mesh")


def create_limiter(config: Config, backend: str = "sketch",
                   clock: Optional[Clock] = None,
                   device="cuda", hier_divisor: int = 1,
                   devices=None) -> RateLimiter:
    """Build a limiter whose state lives on ``device`` (default the CUDA
    card; without one this raises — pass ``device="cpu"`` to run on the
    CPU with the kernels' plain versions). The exact backend is host code
    and ignores ``device``. No I/O happens until the first decision.
    ``hier_divisor`` (sketch backends) is a dispatch shard's share of the
    tenant and global limits (the native door's ``--shards``);
    ``devices`` (mesh) an explicit list of the slices' devices, repeats
    allowed (several slices on one card)."""
    if backend == "exact":
        from ratelimiter_tpu_torch.algorithms.exact import ExactLimiter

        return ExactLimiter(config, clock)
    if backend == "dense":
        from ratelimiter_tpu_torch.algorithms.dense import DenseLimiter

        return DenseLimiter(config, clock, device=device)
    if backend == "sketch":
        if config.algorithm is Algorithm.TOKEN_BUCKET:
            from ratelimiter_tpu_torch.algorithms.sketch import (
                SketchTokenBucketLimiter,
            )

            return SketchTokenBucketLimiter(config, clock, device=device,
                                            hier_divisor=hier_divisor)
        from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter

        return SketchLimiter(config, clock, device=device,
                             hier_divisor=hier_divisor)
    if backend == "mesh":
        if config.mesh.router == "collective":
            from ratelimiter_tpu_torch.parallel.collective import (
                CollectiveMeshLimiter,
            )

            return CollectiveMeshLimiter(config, clock, device=device,
                                         devices=devices)
        from ratelimiter_tpu_torch.parallel.limiter import SlicedMeshLimiter

        return SlicedMeshLimiter(config, clock, device=device,
                                 devices=devices)
    raise InvalidConfigError(
        f"unknown backend {backend!r}; expected one of {BACKENDS}")
