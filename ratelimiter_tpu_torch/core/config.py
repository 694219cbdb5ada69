"""Configuration, validation, defaults, and key formatting.

A copy of ``ratelimiter_tpu/core/config.py`` (the port keeps its own copy
of every host module it needs and imports nothing of the JAX package); a
``Config`` built from its fields means the same in both packages. Left
out: the mesh spec (ROADMAP A8), which the JAX fingerprint excludes, and
``SketchParams.for_load``.

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
    #: Heavy-hitter exact side table: keys whose in-window estimate crosses
    #: ``hh_promote_fraction * limit`` are promoted into a direct-mapped
    #: table of ``hh_slots`` private per-key ring cells (exact counts, no
    #: collision error) and stop feeding the shared sketch. 0 disables.
    #: The windowed sketch serves it (ops/sketch_kernels.py); the token
    #: bucket ignores it, as in the JAX package.
    hh_slots: int = 0
    hh_promote_fraction: float = 0.5
    #: What to do when the admitted in-window mass exceeds this geometry's
    #: calibrated budget (``mass_budget`` — the point where collision
    #: error passes ~1% false denies):
    #:   "warn"   (default) log loudly once per sub-window and keep
    #:            serving (accuracy silently degrades with load);
    #:   "strict" additionally REJECT new admissions while over budget.
    #: Either way ``overload_periods`` counts offending sub-windows.
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
        if not (0.0 < self.hh_promote_fraction <= 1.0):
            raise InvalidConfigError(
                f"hh_promote_fraction must be in (0, 1], "
                f"got {self.hh_promote_fraction}")
        if self.overload_policy not in ("warn", "strict"):
            raise InvalidConfigError(
                f"overload_policy must be 'warn' or 'strict', "
                f"got {self.overload_policy!r}")
        if self.kernels not in ("auto", "pallas", "jnp"):
            raise InvalidConfigError(
                f"sketch kernels must be 'auto', 'pallas' or 'jnp', "
                f"got {self.kernels!r}")

    def mass_budget(self, limit: int) -> int:
        """In-window admitted mass this geometry absorbs before collision
        error reaches ~1% false denies (the calibrated 1% anchor: mean
        cell load of 2x limit). The windowed limiter tracks admitted mass
        at runtime and warns (or, strict, denies) past this."""
        return int(2.0 * limit * self.width)


#: "Effectively unlimited" sentinel for hierarchy scope limits (requests
#: per window). Chosen so int64 scatter/cumsum math in the cascade kernel
#: can never overflow (avail * weight stays < 2^62 with weights <= 2^20)
#: while still being far beyond any real per-window admission volume.
HIER_UNLIMITED = 1 << 40


@dataclass(frozen=True)
class HierarchySpec:
    """Hierarchical cascade geometry (hierarchy/, ADR-020).

    When ``tenants > 0`` the sketch-family decision step evaluates a
    CASCADE of scopes per request — key → tenant → global — with
    all-or-nothing admission in the same single device dispatch: tenant
    ids derive on device from a policy-table-style sorted key→tenant
    map, a per-tenant (+ global) counter slab updates in the same kernel
    pass, and contended global mass is clipped between tenants
    proportionally to their weights (weighted fair sharing).

    Like PolicySpec, these are *compiled-shape* parameters: the tenant
    slab is ``tenants + 1`` counters (index ``tenants`` is the global
    scope) and the key→tenant map is a fixed-capacity sorted array
    consulted by the same branchless binary search as the override
    table. The spec participates in the checkpoint config fingerprint
    ONLY when enabled (``tenants > 0``) so every pre-hierarchy snapshot
    stays restorable.

    Scope limits here are the CONFIGURED defaults (ceilings); the live
    *effective* limits move at runtime — operator calls or the AIMD
    controller (hierarchy/controller.py) — and ride checkpoints as
    ``hier_*`` columns. 0 means unlimited for both limit fields.
    """

    #: Tenant capacity, power of two in [2, 2^12] (tenant 0 is the
    #: implicit default tenant for unassigned keys). 0 disables the
    #: hierarchy subsystem entirely — zero hot-path cost.
    tenants: int = 0
    #: Key→tenant assignment map capacity; power of two (same binary-
    #: search geometry rule as PolicySpec.capacity).
    map_capacity: int = 1024
    #: Global-scope limit, requests per window across ALL keys
    #: (0 = unlimited).
    global_limit: int = 0
    #: Default per-tenant limit, requests per window (0 = unlimited);
    #: individual tenants override via set_tenant.
    default_tenant_limit: int = 0

    @property
    def enabled(self) -> bool:
        return self.tenants > 0

    def validate(self) -> None:
        t = self.tenants
        if t != 0 and (t < 2 or t > (1 << 12) or (t & (t - 1)) != 0):
            raise InvalidConfigError(
                f"hierarchy tenants must be 0 or a power of two in "
                f"[2, 2^12], got {t}")
        m = self.map_capacity
        if m < 8 or m > (1 << 20) or (m & (m - 1)) != 0:
            raise InvalidConfigError(
                f"hierarchy map_capacity must be a power of two in "
                f"[8, 2^20], got {m}")
        for name, v in (("global_limit", self.global_limit),
                        ("default_tenant_limit", self.default_tenant_limit)):
            if (not isinstance(v, int) or isinstance(v, bool) or v < 0
                    or v >= HIER_UNLIMITED):
                raise InvalidConfigError(
                    f"hierarchy {name} must be an integer in "
                    f"[0, 2^40), got {v!r}")


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
class PersistenceSpec:
    """Durability subsystem configuration (persistence/).

    When ``dir`` is set, the limiter stack gains a write-ahead log for
    every non-decision mutation (policy overrides, resets, dynamic
    limit/window updates) plus background snapshots, and recovery on
    startup replays the WAL suffix past the newest snapshot's watermark.
    ``dir=None`` (the default) disables the subsystem.

    Excluded from the checkpoint config fingerprint: these are operational
    knobs, not state geometry — a snapshot taken at one cadence must
    restore under another.
    """

    #: Directory holding WAL segments, snapshots, and the manifest.
    #: None disables persistence.
    dir: Optional[str] = None
    #: Seconds between background snapshots (the crash-window bound on
    #: lost decisions).
    snapshot_interval: float = 30.0
    #: Also snapshot after this many WAL mutations (0 = interval only).
    snapshot_after_mutations: int = 0
    #: Snapshots retained on disk (older ones + their WAL prefix are
    #: pruned after each successful snapshot).
    retain: int = 3
    #: WAL fsync policy: "always" (fsync every append), "interval" (at most
    #: every ``wal_fsync_interval`` seconds), "never" (leave it to the OS;
    #: a power loss may drop the tail).
    wal_fsync: str = "always"
    wal_fsync_interval: float = 0.05
    #: WAL segment rotation threshold, bytes.
    wal_max_bytes: int = 64 << 20

    @property
    def enabled(self) -> bool:
        return self.dir is not None

    def validate(self) -> None:
        if self.dir is not None and not isinstance(self.dir, str):
            raise InvalidConfigError(
                f"persistence dir must be a path string or None, "
                f"got {self.dir!r}")
        if not (self.snapshot_interval > 0):
            raise InvalidConfigError(
                f"snapshot_interval must be > 0, "
                f"got {self.snapshot_interval!r}")
        if self.snapshot_after_mutations < 0:
            raise InvalidConfigError(
                f"snapshot_after_mutations must be >= 0, "
                f"got {self.snapshot_after_mutations!r}")
        if self.retain < 1:
            raise InvalidConfigError(
                f"retain must be >= 1, got {self.retain!r}")
        if self.wal_fsync not in ("always", "interval", "never"):
            raise InvalidConfigError(
                f"wal_fsync must be 'always', 'interval' or 'never', "
                f"got {self.wal_fsync!r}")
        if not (self.wal_fsync_interval > 0):
            raise InvalidConfigError(
                f"wal_fsync_interval must be > 0, "
                f"got {self.wal_fsync_interval!r}")
        if self.wal_max_bytes < 4096:
            raise InvalidConfigError(
                f"wal_max_bytes must be >= 4096, got {self.wal_max_bytes!r}")


@dataclass(frozen=True)
class MeshSpec:
    """Slice-parallel serving deployment (``--backend mesh``, ADR-012).

    ``devices`` caps how many visible devices (CUDA cards; N slices on
    the CPU) the sliced mesh limiter spans (None = all of them). Each
    device holds an independent,
    device-pinned single-chip limiter slice; the serving tier routes every
    key to its owning slice by hash, so the decide path is collective-free
    and per-key decisions are bit-identical to a single-device limiter.

    Deliberately EXCLUDED from the checkpoint config fingerprint: the
    device count is a *placement* property, not state geometry. Each
    slice's counters are only meaningful under the routing that produced
    them, so a sliced snapshot restored onto a different slice count is
    re-bucketed onto the new routing (SlicedMeshLimiter.restore,
    parallel/reshard.py).
    """

    #: Devices to span (None = every visible device; must be >= 1).
    devices: Optional[int] = None
    #: Frame routing mode (ADR-024). "host" = the ADR-013 scatter-gather
    #: scheduler (host argsort partition, per-slice sub-launches, barrier
    #: + index-map scatter). "collective" = one routed dispatch per
    #: frame: owners and bins computed on device (the ``route_bins``
    #: kernel), rows all-to-all'd to their slices, verdicts all-to-all'd
    #: back — the host never partitions.
    #: Decisions are bit-identical either way (same ``h64 % n`` owner
    #: rule, same kernels); "collective" targets real accelerator meshes
    #: where device copies beat host phases, and falls back to the host router on
    #: bin overflow (so admission is never dropped) and under the strict
    #: overload policy.
    router: str = "host"
    #: Collective-router bin headroom: per-(source, destination) bin
    #: capacity is ``ceil(bin_headroom * shard_len / devices)``. Uniform
    #: mixed traffic fills bins to ~1/headroom; skewed frames that
    #: overflow a bin fall back to the host router (ADR-024 trade-off).
    bin_headroom: float = 2.0
    #: Failure-domain isolation (ADR-015): wrap every slice in a
    #: quarantine guard — per-slice dispatch deadline + failure
    #: classifier, degraded per-range answers per ``fail_open``, and
    #: half-open probe recovery with restore-before-rejoin. OFF by
    #: default: the guard adds one executor hop per slice resolve, and
    #: the no-quarantine hot path must stay byte-identical.
    quarantine: bool = False
    #: Per-slice sub-dispatch deadline, seconds: a slice that has not
    #: resolved within this budget is classified failed and its key
    #: range degrades (only that range — other slices stay exact).
    slice_deadline: float = 0.25
    #: Seconds a quarantined slice waits before each half-open probe.
    probe_interval: float = 1.0
    #: Consecutive classified failures before a slice quarantines
    #: (1 = first fault quarantines; the failure already degraded that
    #: frame's range either way).
    failure_threshold: int = 1

    def validate(self) -> None:
        if self.devices is not None and (
                not isinstance(self.devices, int) or self.devices < 1):
            raise InvalidConfigError(
                f"mesh devices must be a positive integer or None, "
                f"got {self.devices!r}")
        if self.slice_deadline <= 0:
            raise InvalidConfigError(
                f"mesh slice_deadline must be positive, "
                f"got {self.slice_deadline!r}")
        if self.probe_interval <= 0:
            raise InvalidConfigError(
                f"mesh probe_interval must be positive, "
                f"got {self.probe_interval!r}")
        if not isinstance(self.failure_threshold, int) \
                or self.failure_threshold < 1:
            raise InvalidConfigError(
                f"mesh failure_threshold must be an integer >= 1, "
                f"got {self.failure_threshold!r}")
        if self.router not in ("host", "collective"):
            raise InvalidConfigError(
                f"mesh router must be 'host' or 'collective', "
                f"got {self.router!r}")
        if self.router == "collective" and self.quarantine:
            raise InvalidConfigError(
                "router='collective' is incompatible with quarantine: a "
                "collective dispatch is ONE mesh-wide execution, so a "
                "single slice's fault has whole-mesh blast radius and "
                "per-slice failure domains cannot contain it (ADR-024). "
                "Use router='host' for quarantined deployments.")
        if not (self.bin_headroom > 0):
            raise InvalidConfigError(
                f"mesh bin_headroom must be positive, "
                f"got {self.bin_headroom!r}")


@dataclass(frozen=True)
class DenseParams:
    """Geometry of the dense (exact, slot-addressed) device backend."""

    #: Maximum number of distinct live keys; key -> slot assignment happens
    #: host-side at ingest.
    capacity: int = 1 << 16

    def validate(self) -> None:
        if self.capacity < 1:
            raise InvalidConfigError(f"dense capacity must be positive, got {self.capacity}")


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
        sketch: CMS geometry (sketch backend only).
        dense: dense-store geometry (dense backend only).
        policy: per-key override table geometry (the policy engine,
            consulted inside the decision step).
        persistence: durability subsystem knobs (WAL + background
            snapshots; disabled unless ``persistence.dir`` is set). Not
            part of the checkpoint fingerprint.
        hierarchy: hierarchical cascade geometry (tenant scopes + global
            scope, weighted fair share; hierarchy/). Part of the
            fingerprint only when enabled, so pre-hierarchy snapshots stay
            valid.
        mesh: slice-parallel serving placement (``--backend mesh``,
            parallel/). Not part of the checkpoint fingerprint.
    """

    algorithm: Algorithm
    limit: int
    window: float
    key_prefix: Optional[str] = None
    fail_open: bool = False
    max_batch_admission_iters: int = 4
    sketch: SketchParams = field(default_factory=SketchParams)
    dense: DenseParams = field(default_factory=DenseParams)
    policy: PolicySpec = field(default_factory=PolicySpec)
    persistence: PersistenceSpec = field(default_factory=PersistenceSpec)
    hierarchy: HierarchySpec = field(default_factory=HierarchySpec)
    mesh: MeshSpec = field(default_factory=MeshSpec)

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
        self.dense.validate()
        self.policy.validate()
        self.persistence.validate()
        self.hierarchy.validate()
        self.mesh.validate()

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

    def format_key(self, key: str, *parts: object) -> str:
        """Reference ``config.go:81-87`` + the per-algorithm window suffixing
        (``fixedwindow.go:139-141``): ``prefix:key[:part...]``; no leading
        colon when prefix is ""."""
        base = f"{self.prefix}:{key}" if self.prefix else key
        for p in parts:
            base = f"{base}:{p}"
        return base

    @property
    def refill_rate(self) -> float:
        """Token-bucket refill rate in tokens/second = limit / window
        (reference ``tokenbucket.go:155-157``)."""
        return self.limit / float(self.window)
