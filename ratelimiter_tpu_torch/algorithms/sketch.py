"""The count-min-sketch backends on PyTorch.

Ports of ``ratelimiter_tpu/algorithms/sketch.py``:

* ``SketchLimiter``: approximate sliding- (or fixed-) window rate limiting
  over a count-min sketch with sub-window decay (ops/sketch_kernels.py).
  Memory is depth x width x ring counters, independent of key cardinality;
* ``SketchTokenBucketLimiter``: TOKEN_BUCKET over a count-min sketch of
  per-key debt (ops/bucket_kernels.py), sharing the windowed limiter's
  shell and swapping its step, reset and result assembly.

Collisions can only cause false denies in either.

The hot path is split as in the JAX package:

* **launch** stages the batch (pinned host buffer, asynchronous copy to
  the card), runs the decision step on the current CUDA stream, queues
  the result assembly behind it, starts the copies of the results into
  pinned host buffers, records a CUDA event behind them, and returns a
  ``DispatchTicket`` without blocking;
* **resolve** waits on that event and assembles the ``BatchResult``.

Sequential semantics across in-flight tickets come from stream order:
each step updates the state tensors in place, and the stream runs the
steps in launch order, where the JAX package threads donated buffers.
On ``device="cpu"`` (the tests) the same code runs eagerly on the CPU
with the kernels' plain versions.

The windowed limiter runs the JAX package's accuracy-envelope watchdog:
admitted in-window mass is tracked on the host against
``SketchParams.mass_budget``; past it the limiter warns once per
sub-window (``overload_policy="warn"``) or also denies every new batch
until history expires (``"strict"``). The bucket has no watchdog in
either package. Both limiters take live ``update_limit``/``update_window``
(the windowed ring migrates on its device, ops/sketch_kernels.py
``build_migrate``; the bucket clamps its debt there) and ``save``/
``restore`` checkpoint files (checkpoint.py), and both port the failure
injection (``inject_failure``/``heal``) the serving tier's failure paths
need.

The windowed limiter serves the heavy-hitter side table
(``SketchParams.hh_slots > 0``, ops/sketch_kernels.py) and reads it out
as ``consumer_stats``; the token bucket ignores ``hh_slots``, as in the
JAX package. Both serve the hierarchy cascade (``hierarchy.tenants >
0``, ADR-020): a ``TenantTable`` (hierarchy/tenants.py) per limiter,
managed through RateLimiter's tenant surface, whose device columns ride
every step (rebuilt when the table's version moves), and whose
``hier_*`` columns ride snapshots; ``hierarchy_stats`` reads the scope
counters. On the card a batch under the cascade of up to
``sketch_cuda.ADMIT_CAPACITY`` requests runs the backs' cascade builds
(one block); a larger one runs composed (the plain admission and cascade
on the card, then the standalone update kernels), as windowed batches
without tenants do. The multi-batch scan
runners that benchmarks drive are ``sketch_kernels.build_scan`` and
``bucket_kernels.build_scan``, below the limiters. Both limiters are the
slices of the sliced mesh and the replicas of the replicated mesh
(parallel/), and the pods of the DCN tier (parallel/dcn.py: the
exports and merges of completed slabs and debt deltas, under the
limiter's lock, on its device).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

import numpy as np
import torch

from ratelimiter_tpu_torch.algorithms.base import RateLimiter, check_key, check_n
from ratelimiter_tpu_torch.core.clock import MICROS, Clock, to_micros
from ratelimiter_tpu_torch.core.config import HIER_UNLIMITED, Config
from ratelimiter_tpu_torch.core.errors import (
    CheckpointError,
    InvalidConfigError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    BatchResult,
    DispatchTicket,
    Result,
    batch_fail_open,
)
from ratelimiter_tpu_torch.hierarchy.tenants import GLOBAL, TenantTable
from ratelimiter_tpu_torch.ops import bucket_kernels, sketch_kernels
from ratelimiter_tpu_torch.ops.bucket_cuda import DEBT_CAP
from ratelimiter_tpu_torch.ops.hashing import (
    hash_prefixed_u64,
    split_hash,
    splitmix64,
)
from ratelimiter_tpu_torch.ops.policy_kernels import pack_halves_host

_MIN_PAD = 8

log = logging.getLogger("ratelimiter_tpu_torch")


def _pad_size(n: int) -> int:
    size = _MIN_PAD
    while size < n:
        size *= 2
    return size


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port's
    entry points never carry on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU with the kernels' plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise InvalidConfigError(f"unsupported device {device!r}")
    return dev


class SketchLimiter(RateLimiter):
    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 device="cuda", hier_divisor: int = 1):
        super().__init__(config, clock)
        self._init_device(device)
        self._step = sketch_kernels.build_hashed_step(self.config)
        self._ids_step = sketch_kernels.build_hashed_step(self.config,
                                                          premix=True)
        _, self._reset_step, self._rollover = sketch_kernels.build_steps(
            self.config)
        self._state = sketch_kernels.init_state(self.config, self._device)
        self._sub_us = sketch_kernels.sketch_geometry(self.config)[1]
        # Host mirror of state["last_period"]: drives rollover dispatches
        # and names the boundary slab (sketch_kernels module docstring).
        self._host_period = sketch_kernels._NEVER
        # Accuracy-envelope watchdog: admitted in-window mass vs the
        # geometry's calibrated budget (SketchParams.mass_budget). Host
        # integers only — no device cost.
        self._ring_sw = sketch_kernels.sketch_geometry(self.config)[2]
        self._mass_budget = self.config.sketch.mass_budget(self.config.limit)
        self._strict = self.config.sketch.overload_policy == "strict"
        self._period_mass: dict = {}
        self._warned_period = -1
        self.overload_periods = 0
        self._init_policy()
        self._init_hierarchy(hier_divisor)

    def _init_device(self, device) -> None:
        """The shell both sketch limiters share: device, hashing seed,
        window and the dispatch lock."""
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._window_us = to_micros(self.config.window)
        self._seed = self.config.sketch.seed
        self._lock = threading.Lock()
        #: Set by inject_failure: every launch raises it (under the lock)
        #: until heal().
        self._injected_failure: Optional[Exception] = None
        # Offered mass of launched-but-unresolved tickets: the strict
        # overload gate counts it AS IF fully admitted (see
        # _over_budget_locked) so a deep in-flight window cannot slip
        # inflight*max_batch of admissions past the accuracy budget —
        # pessimism errs toward denying, strict mode's direction.
        self._inflight_mass = 0

    def _init_policy(self) -> None:
        """Per-key limit overrides, resolved in the step; window scaling
        is impossible on a shared sketch geometry, so only limits
        override."""
        from ratelimiter_tpu_torch.policy import PolicyTable

        self._policy_table = PolicyTable(
            self.config, key_fn=self._policy_key,
            validator=self._policy_validate, window_scaling=False)
        self._policy_dev = None
        self._policy_dev_version = -1

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------- policy

    def _policy_validate(self, limit: int, _window_us: int) -> None:
        if limit >= (1 << 24):
            raise InvalidConfigError(
                f"sketch backends require override limits < 2**24 "
                f"(f32-exact admission), got {limit}")

    def _policy_key(self, key: str) -> int:
        h1, h2 = split_hash(self._hash([key]), self._seed)
        return int(pack_halves_host(h1, h2)[0])

    def _policy_device(self):
        """Device copy of the override table, or None while it is empty (a
        lookup in an all-padding table only ever finds the default limit).
        Lock must be held; rebuilt when the table version moved."""
        t = self._policy_table
        if not len(t):
            return None
        if self._policy_dev is None or self._policy_dev_version != t.version:
            self._policy_dev = sketch_kernels.policy_tensors(
                t.host_arrays(), self._device)
            self._policy_dev_version = t.version
        return self._policy_dev

    def _policy_limits(self, h64: np.ndarray):
        """Host-side per-request effective limits for result assembly
        (None when no override matches)."""
        if not len(self._policy_table):
            return None
        h1, h2 = split_hash(np.asarray(h64, np.uint64), self._seed)
        return self._policy_table.limits_for(pack_halves_host(h1, h2))

    # ---------------------------------------------------------- hierarchy

    def _init_hierarchy(self, divisor: int = 1) -> None:
        """Tenant + global cascade scopes (ADR-020), resolved in the step
        like the policy table, keyed by the same packed (h1, h2).
        ``divisor`` is the per-unit share of a multi-shard native door
        (each of N shards enforces 1/N of every scope's limit)."""
        self._hier_table = None
        self._hier_dev = None
        self._hier_dev_version = -1
        if self.config.hierarchy.enabled:
            self._hier_table = TenantTable(self.config,
                                           key_fn=self._policy_key,
                                           divisor=divisor)

    def _hier_device(self):
        """Device copy of the cascade tables (key→tenant map + limit/
        weight columns), or None when the hierarchy is disabled. Lock must
        be held; rebuilt when the table version moved."""
        t = self._hier_table
        if t is None:
            return None
        if self._hier_dev is None or self._hier_dev_version != t.version:
            self._hier_dev = sketch_kernels.hier_tensors(t.host_arrays(),
                                                         self._device)
            self._hier_dev_version = t.version
        return self._hier_dev

    def _hier_counts(self) -> np.ndarray:
        """(T+1,) in-window admitted counts per scope (global at index
        T). The rollover a decision would run is kicked first, so an idle
        limiter reports expired mass as 0; the copy is enqueued under the
        lock and read after it."""
        with self._lock:
            self._sync_period(to_micros(self.clock.now()))
            ref = self._state["tn_totals"].clone()
        return ref.cpu().numpy()

    def hierarchy_stats(self) -> dict:
        t = self._hier_table
        if t is None:
            return super().hierarchy_stats()
        counts = self._hier_counts()
        tenants = {}
        for name in t.tenant_names():
            ten = t.get_tenant(name)
            tenants[name] = {
                "tid": ten.tid,
                "in_window": int(counts[ten.tid]),
                "effective": t.effective_of(name),
                "ceiling": ten.limit or HIER_UNLIMITED,
                "floor": ten.floor,
                "weight": ten.weight,
            }
        return {"tenants": tenants,
                "global": {"in_window": int(counts[t.capacity]),
                           "effective": t.effective_of(GLOBAL),
                           "ceiling": t.global_ceiling},
                "divisor": t.divisor,
                "assignments": len(t.assignments())}

    # ------------------------------------------------------------ hashing

    def _hash(self, keys: List[str]) -> np.ndarray:
        return hash_prefixed_u64(keys, self.config.prefix)

    def _sync_period(self, now_us: int) -> None:
        """Dispatch the rollover if now_us entered a new sub-window. Must be
        called with self._lock held."""
        p = now_us // self._sub_us
        if p > self._host_period:
            self._rollover(self._state, p)
            self._host_period = p

    def _step_kw(self) -> dict:
        """Keyword operands of the step and reset callables: the windowed
        ones read their period from the host mirror. Lock must be held."""
        return {"period": self._host_period}

    def _launch_kw(self) -> dict:
        """Keyword operands of the step callables alone. Lock must be
        held."""
        return {}

    def _launch_finish(self, outs, now_us: int, window_us: int):
        """Queue the result assembly behind the step (windowed form:
        retry-after is the time to the window reset). ``window_us`` is
        the one the step ran under, read under the lock."""
        allowed, remaining, _est = outs
        return sketch_kernels.finish_window(allowed, remaining, now_us,
                                            window_us)

    # ------------------------------------------------------------ dispatch

    def _stage(self, arr: np.ndarray, dtype: np.dtype) -> torch.Tensor:
        """Host array -> device tensor. On CUDA the host side is a pinned
        buffer and the copy is asynchronous; the caching host allocator
        keeps the buffer until the copy has run."""
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
        if not self._cuda:
            return host
        return host.pin_memory().to(self._device, non_blocking=True)

    def _padded_size(self, b: int) -> int:
        """The staged batch length of ``b`` requests (the replicated mesh
        pads each slice's shard instead)."""
        return _pad_size(b)

    def _launch_hashed(self, h64: np.ndarray, ns: np.ndarray, now_us: int,
                       t_sec: float, *, premix: bool = False,
                       wire: bool = False) -> DispatchTicket:
        b = h64.shape[0]
        padded = self._padded_size(b)
        h64p = np.zeros(padded, dtype=np.uint64)
        h64p[:b] = h64
        nsp = np.zeros(padded, dtype=np.int32)
        nsp[:b] = ns
        with self._lock:
            if self._injected_failure is not None:
                raise self._injected_failure
            self._sync_period(now_us)
            if self._strict and self._over_budget_locked(now_us):
                # Strict overload policy: REJECT new admissions (no state
                # write, no launch) while admitted in-window mass exceeds
                # the geometry's accuracy budget. Clears as history ages
                # out of the ring.
                return DispatchTicket(result=self._deny_all(b, now_us))
            step = self._ids_step if premix else self._step
            h_dev = self._stage(h64p.view(np.int64), np.int64)
            n_dev = self._stage(nsp, np.int32)
            outs = step(self._state, h_dev, n_dev, now_us,
                        self._policy_device(), self._hier_device(),
                        **self._step_kw(), **self._launch_kw())
            # Inside the lock: a concurrent set/delete_override rebuilds
            # the table's sorted views.
            if premix:
                limits = (self._policy_limits(splitmix64(h64))
                          if len(self._policy_table) else None)
            else:
                limits = self._policy_limits(h64)
            self._inflight_mass += int(ns.sum())
            window_us = self._window_us
        outs = self._launch_finish(outs, now_us, window_us)
        if wire:
            outs = sketch_kernels.pack_wire(*outs)
        t = DispatchTicket()
        if self._cuda:
            host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                         for o in outs)
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            t.event = torch.cuda.Event()
            t.event.record()
            t.staged = (h_dev, n_dev, outs)
            outs = host
        t.outs = outs
        t.wire = wire
        t.b = b
        t.limit = self.config.limit
        t.limits = limits
        t.ns = np.asarray(ns)
        t.now_us = now_us
        t.t_sec = t_sec
        t.padded = padded
        t.inflight = True
        return t

    def _retire_ticket(self, t: DispatchTicket, admitted: int) -> None:
        """Once per launched ticket: in ONE lock acquisition, swap the
        ticket's offered mass out of the strict gate's in-flight
        pessimism for its actual admitted mass. A two-step swap would open
        a window where the batch counts as neither, letting a concurrent
        launch slip past the budget."""
        if not t.inflight:
            return
        t.inflight = False
        with self._lock:
            self._inflight_mass -= int(t.ns.sum())
            self._note_mass_locked(admitted, t.now_us)

    def _resolve_ticket(self, t: DispatchTicket) -> BatchResult:
        if t.result is not None:
            return t.result
        try:
            if t.event is not None:
                t.event.synchronize()
        except BaseException:
            self._retire_ticket(t, 0)
            raise
        b = t.b
        if t.wire:
            bits, words = (o.numpy() for o in t.outs)
            padded = t.padded
            res = BatchResult(
                allowed=np.unpackbits(bits, bitorder="little")[:b].astype(bool),
                limit=t.limit,
                remaining=words[:b],
                retry_after=words[padded:padded + b].view(np.float64),
                reset_at=words[2 * padded:2 * padded + b].view(np.float64),
                limits=t.limits,
                wire_packed=(bits, words, padded),
            )
        else:
            allowed, remaining, retry, reset_at = (o.numpy() for o in t.outs)
            res = BatchResult(
                allowed=allowed[:b],
                limit=t.limit,
                remaining=remaining[:b],
                retry_after=retry[:b],
                reset_at=reset_at[:b],
                limits=t.limits,
            )
        self._retire_ticket(t, int(t.ns[res.allowed].sum()))
        t.result = res
        t.outs = t.staged = t.event = None
        return res

    # ------------------------------------------------ pipelined public API

    pipelined = True

    def _launch_guarded(self, h64: np.ndarray, ns_arr: np.ndarray, t: float,
                        *, premix: bool = False, wire: bool = False,
                        phase: str = "launch") -> DispatchTicket:
        """Fail-open configs get a pre-resolved fail-open ticket when a
        launch fails; fail-closed configs raise StorageUnavailableError
        ("sketch <phase> failed: ...", the JAX package's text: "launch"
        from the launch methods, "dispatch" from its synchronous
        ``allow_batch``/``allow_n``/``allow_hashed``)."""
        try:
            return self._launch_hashed(h64, ns_arr, to_micros(t), t,
                                       premix=premix, wire=wire)
        except Exception as exc:
            if self.config.fail_open:
                return DispatchTicket(result=batch_fail_open(
                    h64.shape[0], self.config.limit,
                    t + float(self.config.window)))
            raise StorageUnavailableError(
                f"sketch {phase} failed: {exc}") from exc

    @staticmethod
    def _ns(count: int, ns) -> np.ndarray:
        if ns is None:
            return np.ones(count, dtype=np.int64)
        return np.asarray(ns, dtype=np.int64)

    def launch_hashed(self, h64: np.ndarray, ns: Optional[np.ndarray] = None,
                      *, now: Optional[float] = None) -> DispatchTicket:
        """Launch pre-hashed uint64 keys (finalized hashes); ns is trusted
        (the serving tier validated it at the wire)."""
        self._check_open()
        h64 = np.asarray(h64, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self._launch_guarded(h64, self._ns(h64.shape[0], ns), t)

    def launch_ids(self, ids: np.ndarray, ns: Optional[np.ndarray] = None, *,
                   now: Optional[float] = None,
                   wire: bool = False) -> DispatchTicket:
        """Raw-u64-id launch (the T_ALLOW_HASHED wire lane): splitmix64 and
        the (h1, h2) split both run in the step on the device. ``wire=True``
        also packs the response on the device (pack_wire)."""
        self._check_open()
        ids = np.asarray(ids, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self._launch_guarded(ids, self._ns(ids.shape[0], ns), t,
                                    premix=True, wire=wire)

    def allow_ids(self, ids: np.ndarray, ns: Optional[np.ndarray] = None, *,
                  now: Optional[float] = None) -> BatchResult:
        """Synchronous raw-u64-id decide: launch_ids + resolve."""
        return self.resolve(self.launch_ids(ids, ns, now=now))

    def launch_batch(self, keys: List[str], ns: Optional[np.ndarray] = None,
                     *, now: Optional[float] = None) -> DispatchTicket:
        """String-key launch: validate and hash on the host, then the
        hashed launch path."""
        self._check_open()
        keys = list(keys)
        for k in keys:
            check_key(k)
        if ns is not None:
            for n in ns:
                check_n(int(n))
        t = self.clock.now() if now is None else float(now)
        return self._launch_guarded(self._hash(keys), self._ns(len(keys), ns),
                                    t)

    def resolve(self, ticket: DispatchTicket) -> BatchResult:
        """Wait for a launched dispatch and assemble its BatchResult
        (idempotent). Device errors honour fail-open/fail-closed."""
        try:
            return self._resolve_ticket(ticket)
        except Exception as exc:
            if self.config.fail_open:
                res = batch_fail_open(ticket.b, self.config.limit,
                                      ticket.t_sec + float(self.config.window))
                ticket.result = res
                ticket.outs = ticket.staged = ticket.event = None
                return res
            raise StorageUnavailableError(
                f"sketch dispatch failed: {exc}") from exc

    def allow_hashed(self, h64: np.ndarray, ns: Optional[np.ndarray] = None,
                     *, now: Optional[float] = None) -> BatchResult:
        """Decide a batch of pre-hashed uint64 keys: launch + resolve."""
        self._check_open()
        h64 = np.asarray(h64, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self.resolve(self._launch_guarded(
            h64, self._ns(h64.shape[0], ns), t, phase="dispatch"))

    # ------------------------------------------------- accuracy envelope

    def _over_budget_locked(self, now_us: int) -> bool:
        """Prune + check the admitted-mass ledger; counts/warns once per
        offending sub-window. Launched-but-unresolved tickets count at
        their full offered mass (pessimistic — their true admitted mass
        replaces the estimate at resolve), so the pipeline's in-flight
        window cannot slip admissions past the budget. Lock must be
        held."""
        p = now_us // self._sub_us
        if self._period_mass:
            p = max(p, max(self._period_mass))
        low = p - self._ring_sw
        for q in [q for q in self._period_mass if q <= low]:
            del self._period_mass[q]
        mass = sum(self._period_mass.values()) + self._inflight_mass
        if mass <= self._mass_budget:
            return False
        if p > self._warned_period:
            self._warned_period = p
            self.overload_periods += 1
            log.warning(
                "sketch overload (strict): admitted in-window mass %d "
                "exceeds the d=%d w=%d budget of %d — rejecting new "
                "admissions until history expires; size the geometry "
                "with SketchParams.for_load", mass,
                self.config.sketch.depth, self.config.sketch.width,
                self._mass_budget)
        return True

    def _deny_all(self, b: int, now_us: int) -> BatchResult:
        """Uniform denial batch for the strict overload path. Retry
        points at the next sub-window boundary: mass drains one
        sub-window at a time, so that is when admission could resume."""
        retry = ((now_us // self._sub_us + 1) * self._sub_us
                 - now_us) / MICROS
        cur_ws = (now_us // self._window_us) * self._window_us
        reset_at = (cur_ws + self._window_us) / MICROS
        return BatchResult(
            allowed=np.zeros(b, dtype=bool),
            limit=self.config.limit,
            remaining=np.zeros(b, dtype=np.int64),
            retry_after=np.full(b, retry, dtype=np.float64),
            reset_at=np.full(b, reset_at, dtype=np.float64),
        )

    def _note_mass_locked(self, admitted: int, now_us: int) -> None:
        """Track admitted in-window mass against the geometry's calibrated
        budget (SketchParams.mass_budget): collision error — and with it
        the false-deny rate — scales with this mass, so exceeding the
        budget means the geometry is undersized for the offered load.
        Warns loudly once per sub-window while overloaded. Lock must be
        held (_retire_ticket pairs it with the in-flight bookkeeping)."""
        p = now_us // self._sub_us
        # Clamp forward like the step clamps now_us: after a backward
        # clock step the ledger would otherwise keep "future" periods
        # alive past pruning.
        if self._period_mass:
            p = max(p, max(self._period_mass))
        self._period_mass[p] = self._period_mass.get(p, 0) + admitted
        low = p - self._ring_sw
        for q in [q for q in self._period_mass if q <= low]:
            del self._period_mass[q]
        mass = sum(self._period_mass.values())
        if mass > self._mass_budget and p > self._warned_period:
            self._warned_period = p
            self.overload_periods += 1
            log.warning(
                "sketch geometry undersized: admitted in-window mass "
                "%d exceeds the d=%d w=%d budget of %d at limit=%d — "
                "collision error is at the ~1%% false-deny level and "
                "grows with load; size the geometry with "
                "SketchParams.for_load(limit=%d, "
                "expected_window_mass=%d)",
                mass, self.config.sketch.depth, self.config.sketch.width,
                self._mass_budget, self.config.limit, self.config.limit,
                mass)

    def in_window_admitted_mass(self) -> int:
        """Admitted requests currently counted inside the sliding window
        (the quantity SketchParams.mass_budget bounds)."""
        with self._lock:
            return sum(self._period_mass.values())

    @property
    def mass_budget(self) -> int:
        return self._mass_budget

    def _allow_batch(self, keys: list, ns: np.ndarray, now: float) -> BatchResult:
        return self.resolve(self._launch_guarded(self._hash(keys), ns, now,
                                                 phase="dispatch"))

    def _allow_n(self, key: str, n: int, now: float) -> Result:
        return self._allow_batch([key], np.array([n], dtype=np.int64),
                                 now).result(0)

    # --------------------------------------------------------------- reset

    def _reset(self, key: str) -> None:
        h1, h2 = split_hash(self._hash([key]), self._seed)
        now_us = to_micros(self.clock.now())
        with self._lock:
            self._sync_period(now_us)
            self._reset_step(
                self._state,
                self._stage(h1.astype(np.int64), np.int64),
                self._stage(h2.astype(np.int64), np.int64),
                now_us, **self._step_kw())

    def _close(self) -> None:
        self._state = {}

    # ------------------------------------------------- dynamic config

    def _apply_config(self, new_cfg: Config) -> None:
        """Dynamic limit: the geometry is unchanged, so the state tensors
        carry over; only the steps (which bake the limit and the side
        table's promotion threshold) are swapped."""
        step = sketch_kernels.build_hashed_step(new_cfg)
        ids_step = sketch_kernels.build_hashed_step(new_cfg, premix=True)
        steps = sketch_kernels.build_steps(new_cfg)
        with self._lock:
            self._step, self._ids_step = step, ids_step
            _, self._reset_step, self._rollover = steps
            self._mass_budget = new_cfg.sketch.mass_budget(new_cfg.limit)

    def _apply_window(self, new_cfg: Config) -> None:
        """Dynamic window: migrate the ring onto the new sub-window
        geometry on the state's device (sketch_kernels.build_migrate —
        conservative re-bucketing, never over-admits), swap the steps and
        re-bucket the watchdog's period ledger by wall time. Under the
        lock, so the migration is enqueued after every launch before it
        and ahead of every launch after it: tickets already in flight
        resolve to their pre-migration answers."""
        migrate = sketch_kernels.build_migrate(self.config, new_cfg)
        step = sketch_kernels.build_hashed_step(new_cfg)
        ids_step = sketch_kernels.build_hashed_step(new_cfg, premix=True)
        steps = sketch_kernels.build_steps(new_cfg)
        _, new_sub, new_sw, _, _ = sketch_kernels.sketch_geometry(new_cfg)
        now_us = to_micros(self.clock.now())
        with self._lock:
            old_sub = self._sub_us
            self._state = migrate(self._state, now_us)
            self._step, self._ids_step = step, ids_step
            _, self._reset_step, self._rollover = steps
            self._window_us = to_micros(new_cfg.window)
            self._sub_us = new_sub
            self._ring_sw = new_sw
            self._host_period = now_us // new_sub
            self._period_mass = self._remap_mass(old_sub, new_sub)
            self._warned_period = -1

    def _remap_mass(self, old_sub: int, new_sub: int) -> dict:
        merged: dict = {}
        for p, mass in self._period_mass.items():
            q = ((p + 1) * old_sub - 1) // new_sub
            merged[q] = merged.get(q, 0) + mass
        return merged

    # ---------------------------------------------------- fault injection

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        """Make every launch fail with ``exc`` until ``heal``: fail-open
        configs answer with fail-open results, fail-closed ones raise
        StorageUnavailableError (``_launch_guarded``)."""
        self._injected_failure = exc if exc is not None else RuntimeError(
            "injected backend failure")

    def heal(self) -> None:
        self._injected_failure = None

    # ------------------------------------------------- state carried across

    _CKPT_KIND = "sketch"
    #: Host mirrors that ride ``extra`` (each ``key`` mirrors ``self._key``):
    #: the windowed step reads its period from the host.
    _EXTRA_KEYS: tuple = ("host_period",)

    def capture_state(self):
        """``(kind, arrays, extra)`` in the JAX package's capture format:
        the state slabs as NumPy arrays plus the ``policy_*`` (and with
        tenants the ``hier_*``) columns, and (windowed) ``host_period`` in
        extra. convert.py carries it across packages."""
        from ratelimiter_tpu_torch.convert import state_to_numpy

        self._check_open()
        with self._lock:
            arrays = state_to_numpy(self._state)
            arrays.update(self._policy_table.snapshot_arrays())
            if self._hier_table is not None:
                arrays.update(self._hier_table.snapshot_arrays())
            extra = {"saved_at": self.clock.now()}
            extra.update((k, int(getattr(self, "_" + k)))
                         for k in self._EXTRA_KEYS)
        return self._CKPT_KIND, arrays, extra

    def restore_state(self, arrays: dict, extra: dict) -> None:
        """Replace state, overrides and (with tenants) the tenant table,
        its assignments and its controller-moved effective limits with
        captured ``arrays`` (from either package's ``capture_state``) of
        this limiter's kind; the host mirrors named in ``_EXTRA_KEYS`` are
        required in ``extra``."""
        from ratelimiter_tpu_torch.convert import state_from_numpy

        self._check_open()
        for k in self._EXTRA_KEYS:
            if k not in extra:
                raise InvalidConfigError(f"restore needs extra[{k!r}]")
        arrays = dict(arrays)
        with self._lock:
            state = state_from_numpy(arrays, self._device)
            if set(state) != set(self._state):
                raise InvalidConfigError(
                    f"state arrays {sorted(state)} do not fit this "
                    f"limiter's {sorted(self._state)}")
            for k, v in state.items():
                if tuple(v.shape) != tuple(self._state[k].shape):
                    raise InvalidConfigError(
                        f"state array {k} has shape {tuple(v.shape)}, this "
                        f"limiter's geometry needs "
                        f"{tuple(self._state[k].shape)}")
            self._policy_table.restore_arrays(arrays)
            self._policy_dev = None
            if self._hier_table is not None:
                self._hier_table.restore_arrays(arrays)
                self._hier_dev = None
            self._state = state
            for k in self._EXTRA_KEYS:
                setattr(self, "_" + k, int(extra[k]))
            self._restored(arrays)

    def _restored(self, arrays: dict) -> None:
        """Note what the next step must know of restored ``arrays``. Lock
        must be held."""

    # ----------------------------------------------------- introspection

    def memory_bytes(self) -> int:
        """Bytes held by the state tensors (the sketch's and, when on, the
        side table's): constant in key cardinality. The side table's two
        owner columns are int64 here, twice the JAX package's uint32."""
        return sum(v.numel() * v.element_size()
                   for v in self._state.values())

    @property
    def has_hh(self) -> bool:
        """Whether the heavy-hitter side table is configured
        (SketchParams.hh_slots > 0)."""
        return "hh_owner" in self._state

    def consumer_stats(self, k: int = 10) -> dict:
        """Top-K consumer analytics off the heavy-hitter side table, the
        JAX package's dict: the promoted hot keys' exact in-window counts,
        read only (scrape cadence, never the decide path). The lock is
        held while copies of the three columns are enqueued (stream order:
        the state as of every launch before, none after); the copies come
        to the host after it. Consumers are their (h1, h2) pair as one
        64-bit hex token, ``(owner << 32) | owner2`` — irreversible, yet
        stable across scrapes. ``{"slots": 0, ...}`` without a side
        table."""
        if "hh_owner" not in self._state:
            return {"slots": 0, "occupied": 0, "top": []}
        with self._lock:
            refs = [self._state[k].clone()
                    for k in ("hh_owner", "hh_owner2", "hh_totals")]
        owner, owner2, totals = (t.cpu().numpy() for t in refs)
        live = (owner != 0) & (totals > 0)
        idx = np.nonzero(live)[0]
        order = idx[np.argsort(totals[idx], kind="stable")[::-1]][:max(0, k)]
        total_mass = int(totals[live].sum())
        return {
            "slots": int(owner.shape[0]),
            "occupied": int((owner != 0).sum()),
            "tracked_mass": total_mass,
            "top": [{
                "consumer": f"{(int(owner[i]) << 32) | int(owner2[i]):016x}",
                "in_window": int(totals[i]),
                "share": round(int(totals[i]) / max(1, total_mass), 6),
            } for i in order],
        }

    def restore(self, path: str) -> None:
        """Replace state and overrides with the checkpoint file at
        ``path`` (either package's ``save``, checkpoint.py). Catch-up for
        elapsed time is automatic: the next dispatch's rollover (or
        token-bucket decay) advances the restored state to 'now'. A file
        of another kind, config or array set raises CheckpointError."""
        from ratelimiter_tpu_torch.checkpoint import load_state

        self._check_open()
        arrays, meta = load_state(path, self._CKPT_KIND, self.config)
        extra = {k: meta.get(k, getattr(self, "_" + k))
                 for k in self._EXTRA_KEYS}
        try:
            self.restore_state(arrays, extra)
        except InvalidConfigError as exc:
            raise CheckpointError(f"{path}: {exc}") from exc


class SketchTokenBucketLimiter(SketchLimiter):
    """TOKEN_BUCKET at unbounded key cardinality: a count-min sketch over
    per-key *debt* (ops/bucket_kernels.py — the GCRA meter form of the
    reference's ``tokenbucket.go:23-52``). Continuous fractional refill,
    burst up to ``limit``, denial consumes nothing; overestimated debt can
    only cause false denies, never over-admission.

    Shares the SketchLimiter shell (hashing, padding, staging, locking,
    launch/resolve, fail-open) and swaps the step, the reset and the result
    assembly: no sub-window ring, no rollover — the decay is inside the
    step, computed on the host from the state's host scalars."""

    #: No ring, so no period (the JAX package records none either); the
    #: decay's scalars ``rem`` and ``last`` are state arrays.
    _EXTRA_KEYS = ()

    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 device="cuda", hier_divisor: int = 1):
        RateLimiter.__init__(self, config, clock)
        self._init_device(device)
        self._step = bucket_kernels.build_hashed_step(self.config)
        self._ids_step = bucket_kernels.build_hashed_step(self.config,
                                                          premix=True)
        _, self._reset_step = bucket_kernels.build_steps(self.config)
        self._state = bucket_kernels.init_state(self.config, self._device)
        # The mass watchdog (and with it overload_policy="strict") is a
        # windowed-sketch concept; debt decays continuously
        # (_note_mass_locked).
        self._strict = False
        # Set by a restore that brought acc cells above 2^61, which no step
        # writes: the next step clamps every acc cell once (_launch_kw).
        self._acc_over_cap = False
        self._init_policy()
        self._init_hierarchy(hier_divisor)

    def _policy_validate(self, limit: int, _window_us: int) -> None:
        # Admission runs exact int64 micro-token cumsums: the same gate as
        # the config's micro-unit accounting.
        if limit * MICROS >= 2**42:
            raise InvalidConfigError(
                f"override limit {limit} too large for micro-unit batch "
                "accounting (>= 2^42/1e6)")

    def _sync_period(self, now_us: int) -> None:
        """No ring, no rollover: the decay happens inside every step."""

    def _step_kw(self) -> dict:
        return {}

    def _launch_kw(self) -> dict:
        clamp, self._acc_over_cap = self._acc_over_cap, False
        return {"clamp_acc": clamp}

    def _restored(self, arrays: dict) -> None:
        """Mark a restored ``acc`` holding cells above 2^61 (one NumPy max
        on the host): the update reads ``acc`` only at touched cells, so
        the next step clamps it densely, as the JAX kernel does every
        step."""
        acc = np.asarray(arrays.get("acc", ()), dtype=np.int64)
        self._acc_over_cap = bool(
            acc.size and int(acc.max()) > DEBT_CAP)

    def _hier_counts(self) -> np.ndarray:
        """The bucket's scope counters are fixed-window: counts of an
        earlier window than now's read as zero (the step zeroes them
        lazily)."""
        with self._lock:
            counts = self._state["tn_counts"].clone()
            period = int(self._state["tn_period"])
            window_us = self._window_us
        counts = counts.cpu().numpy()
        if period < to_micros(self.clock.now()) // window_us:
            return np.zeros_like(counts)
        return counts

    def _launch_finish(self, outs, now_us: int, window_us: int):
        """Token-bucket result assembly: retry-after = deficit / refill
        rate, computed exactly by the step; reset_at = now + window."""
        allowed, remaining, retry_us = outs
        return bucket_kernels.finish_bucket(allowed, remaining, retry_us,
                                            now_us, window_us)

    def _note_mass_locked(self, admitted: int, now_us: int) -> None:
        """No mass watchdog for the debt sketch: debt decays continuously
        (no sub-window ring to bucket mass into) and overestimated debt
        self-corrects as it drains; the windowed calibration does not
        transfer."""

    def in_window_admitted_mass(self) -> int:
        raise NotImplementedError(
            "the admitted-mass watchdog applies to windowed sketches "
            "only (debt decays continuously; see _note_mass_locked)")

    @property
    def mass_budget(self) -> int:
        raise NotImplementedError(
            "the admitted-mass watchdog applies to windowed sketches "
            "only (debt decays continuously; see _note_mass_locked)")

    def _apply_config(self, new_cfg: Config) -> None:
        """Dynamic limit: refill rate (limit/window) and capacity both
        change; the debt slab carries over, CLAMPED to the new capacity on
        its device. The sub-micro-token decay remainder is denominated in
        the old rate fraction, so it resets (forfeits < 1 micro-token of
        accrued refill, toward denying)."""
        step = bucket_kernels.build_hashed_step(new_cfg)
        ids_step = bucket_kernels.build_hashed_step(new_cfg, premix=True)
        steps = bucket_kernels.build_steps(new_cfg)
        cap = new_cfg.limit * MICROS
        with self._lock:
            self._step, self._ids_step = step, ids_step
            _, self._reset_step = steps
            self._state["debt"] = torch.clamp_max(self._state["debt"], cap)
            self._state["rem"] = torch.zeros((), dtype=torch.int64)

    def _apply_window(self, new_cfg: Config) -> None:
        """Dynamic window for the debt sketch: the window only sets the
        refill rate (limit/window), so the steps swap and accumulated
        debt stands (it now drains at the new rate). The decay remainder
        is denominated in the old rate fraction, so it resets."""
        step = bucket_kernels.build_hashed_step(new_cfg)
        ids_step = bucket_kernels.build_hashed_step(new_cfg, premix=True)
        steps = bucket_kernels.build_steps(new_cfg)
        with self._lock:
            self._step, self._ids_step = step, ids_step
            _, self._reset_step = steps
            self._window_us = to_micros(new_cfg.window)
            self._state["rem"] = torch.zeros((), dtype=torch.int64)

    def debt_slab_stats(self) -> dict:
        """Occupancy/collision visibility for the debt slab, as the JAX
        package's: per row, the cells whose EFFECTIVE debt is positive
        (stored debt above the decay the next step would apply), reduced
        on the device so only ``d`` scalars come back. ``occupancy`` is
        the max over rows; ``collision_p`` the product over rows — the
        chance a fresh key lands on an occupied cell in every row, which
        it takes for the min-over-rows read to overestimate its debt."""
        d, w = self.config.sketch.depth, self.config.sketch.width
        _, num, den = bucket_kernels._check_gates(self.config)
        now_us = to_micros(self.clock.now())
        with self._lock:
            # Enqueued under the lock, so the reduction sees the state as
            # of every launch before it (stream order), and no later one.
            decay, _ = bucket_kernels._decay(self._state, now_us,
                                             rate_num=num, rate_den=den)
            live = (self._state["debt"] > decay).sum(1)
        live_rows = live.cpu().numpy()
        occ_rows = live_rows / float(w)
        return {
            "depth": int(d),
            "width": int(w),
            "cells": int(d * w),
            "nonzero_cells": int(live_rows.sum()),
            "occupancy_rows": [round(float(o), 6) for o in occ_rows],
            "occupancy": round(float(occ_rows.max(initial=0.0)), 6),
            "collision_p": round(float(np.prod(occ_rows)), 9),
        }
