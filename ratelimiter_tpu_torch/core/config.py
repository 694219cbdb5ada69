"""Configuration, validation, defaults, and key formatting.

A copy of ``ratelimiter_tpu/core/config.py`` (the port keeps its own copy
of every host module it needs and imports nothing of the JAX package),
trimmed to the fields this slice serves or must refuse; a ``Config`` built
from them means the same in both packages. The dense, persistence and mesh
specs and the sketch sizing helpers come back with the slices that serve
them (ROADMAP).

Parity with reference ``internal/ratelimiter/config.go`` and the Config struct
(``interface.go:46-70``): algorithm, limit, window, key prefix, fail-open,
extended with the sketch geometry and admission-scan iterations.

``key_prefix=None`` (the default) means "use DEFAULT_PREFIX" and
``key_prefix=""`` genuinely means "no prefix", as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.core.types import Algorithm

#: Reference ``config.go:11``.
DEFAULT_PREFIX = "ratelimit"

#: Reference bounds, ``config.go:31-47``.
MIN_WINDOW_SECONDS = 0.001
MAX_WINDOW_SECONDS = 365.0 * 24 * 3600


@dataclass(frozen=True)
class SketchParams:
    """Geometry of the count-min sketch backend (BASELINE.json configs 3-5).

    depth × width int32 counters shared by all keys; the window is covered by
    ``sub_windows`` equal sub-buckets (plus one boundary bucket in the ring)
    so expiry is a cheap slab subtraction instead of Redis TTLs
    (SURVEY.md §2.4.9, hard part #2).
    """

    depth: int = 4
    width: int = 65536
    sub_windows: int = 60
    #: Conservative update: only raise the counters that are below the new
    #: estimate; cuts CMS overestimate and therefore false denies
    #: (SURVEY.md hard part #3).
    conservative_update: bool = True
    seed: int = 0x5bd1e995
    #: Heavy-hitter exact side table (private per-key ring cells for hot
    #: keys); 0 disables. Not ported yet (ROADMAP A6): the sketch backend
    #: refuses a config that sets it.
    hh_slots: int = 0
    #: What to do when the admitted in-window mass exceeds the geometry's
    #: calibrated budget: "warn" or "strict" (reject admissions while over
    #: budget). The port has no mass-budget watchdog yet: it serves "warn"
    #: without the warning and refuses "strict".
    overload_policy: str = "warn"
    #: Hot-loop kernel implementation. Kept so that configs stay
    #: interchangeable with the JAX package, where it selects between the
    #: Pallas kernels and the jnp reference path. The port does not read
    #: it: a CUDA tensor always takes the hand-written kernel and a CPU
    #: tensor the plain PyTorch version (ops/sketch_cuda.py), and the two
    #: are bit-identical, so the choice is an execution detail.
    kernels: str = "auto"

    def validate(self) -> None:
        if self.depth < 1 or self.depth > 16:
            raise InvalidConfigError(f"sketch depth must be in [1, 16], got {self.depth}")
        if self.width < 16 or (self.width & (self.width - 1)) != 0:
            raise InvalidConfigError(
                f"sketch width must be a power of two >= 16, got {self.width}")
        if self.sub_windows < 1 or self.sub_windows > 4096:
            raise InvalidConfigError(
                f"sketch sub_windows must be in [1, 4096], got {self.sub_windows}")
        if self.hh_slots != 0 and (
                self.hh_slots < 16 or self.hh_slots > (1 << 22)
                or (self.hh_slots & (self.hh_slots - 1)) != 0):
            raise InvalidConfigError(
                f"hh_slots must be 0 or a power of two in [16, 2^22], "
                f"got {self.hh_slots}")
        if self.overload_policy not in ("warn", "strict"):
            raise InvalidConfigError(
                f"overload_policy must be 'warn' or 'strict', "
                f"got {self.overload_policy!r}")
        if self.kernels not in ("auto", "pallas", "jnp"):
            raise InvalidConfigError(
                f"sketch kernels must be 'auto', 'pallas' or 'jnp', "
                f"got {self.kernels!r}")


@dataclass(frozen=True)
class HierarchySpec:
    """The tenant cascade's geometry (``ratelimiter_tpu`` ADR-020), reduced
    to its switch: ``tenants > 0`` enables it there. Not ported yet
    (ROADMAP A6)."""

    tenants: int = 0

    @property
    def enabled(self) -> bool:
        return self.tenants > 0


@dataclass(frozen=True)
class PolicySpec:
    """Geometry of the per-key override table (the policy engine,
    policy/).

    ``capacity`` bounds how many keys may carry a tiered override at once.
    It is a *compiled-shape* parameter: the device-resident override table
    is a fixed-size sorted array consulted by a vectorized binary search
    inside every decision step, so capacity participates in the config
    fingerprint (checkpoints refuse to restore under a different policy
    geometry). Powers of two keep the branchless binary search exact in
    ``log2(capacity)`` steps.
    """

    #: Max simultaneous per-key overrides; power of two. 1024 entries cost
    #: ~40 KB of device memory — negligible next to any state backend.
    capacity: int = 1024

    def validate(self) -> None:
        if (self.capacity < 8 or self.capacity > (1 << 20)
                or (self.capacity & (self.capacity - 1)) != 0):
            raise InvalidConfigError(
                f"policy capacity must be a power of two in [8, 2^20], "
                f"got {self.capacity}")


@dataclass(frozen=True)
class Config:
    """User-facing limiter configuration (reference ``interface.go:46-70``).

    Attributes:
        algorithm: which algorithm decides (reference field ``Algorithm``).
        limit: max requests per window (reference field ``Limit``); > 0.
        window: window duration in float seconds (reference field ``Window``);
            bounds 1 ms .. 365 d (``config.go:31-47``).
        key_prefix: namespace prepended to every key. None -> DEFAULT_PREFIX;
            "" -> genuinely no prefix (see module docstring).
        fail_open: on backend failure allow (True) or raise (False)
            (reference ``interface.go:65-69``, ADR-002).
        max_batch_admission_iters: fixpoint iterations for same-key mixed-n
            sequencing inside one batch (exact for uniform n; see
            ops/segment.py).
        sketch: CMS geometry.
        policy: per-key override table geometry (the policy engine,
            consulted inside the decision step).
        hierarchy: the tenant cascade; not ported yet, so a config that
            enables it is refused by the sketch backend.
    """

    algorithm: Algorithm
    limit: int
    window: float
    key_prefix: Optional[str] = None
    fail_open: bool = False
    max_batch_admission_iters: int = 4
    sketch: SketchParams = field(default_factory=SketchParams)
    policy: PolicySpec = field(default_factory=PolicySpec)
    hierarchy: HierarchySpec = field(default_factory=HierarchySpec)

    def validate(self) -> None:
        """Reference ``Config.Validate`` (``config.go:16-50``), same bounds."""
        if not isinstance(self.algorithm, Algorithm):
            raise InvalidConfigError(f"invalid algorithm: {self.algorithm!r}")
        if not isinstance(self.limit, int) or isinstance(self.limit, bool) or self.limit <= 0:
            raise InvalidConfigError(f"limit must be a positive integer, got {self.limit!r}")
        w = float(self.window)
        if w < MIN_WINDOW_SECONDS:
            raise InvalidConfigError(
                f"window must be at least 1ms, got {self.window!r}")
        if w > MAX_WINDOW_SECONDS:
            raise InvalidConfigError(
                f"window must be at most 365 days, got {self.window!r}")
        if self.max_batch_admission_iters < 1:
            raise InvalidConfigError(
                "max_batch_admission_iters must be >= 1, "
                f"got {self.max_batch_admission_iters}")
        self.sketch.validate()
        self.policy.validate()

    def with_defaults(self) -> "Config":
        """Non-mutating defaulting (reference ``config.go:54-67``): returns a
        copy with ``key_prefix=None`` resolved to DEFAULT_PREFIX."""
        if self.key_prefix is None:
            return replace(self, key_prefix=DEFAULT_PREFIX)
        return self

    @property
    def prefix(self) -> str:
        """Resolved prefix ("" means no prefix)."""
        return DEFAULT_PREFIX if self.key_prefix is None else self.key_prefix
