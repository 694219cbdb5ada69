"""Decorators around RateLimiter: a copy of
``ratelimiter_tpu/observability/decorators.py``.

Wrappers that implement the same RateLimiter surface and delegate it to
``inner``, so they compose with each other and with every backend of the
port — ``MetricsDecorator(LoggingDecorator(create_limiter(cfg)))`` —
and with the persistence wrapper (persistence/manager.py
``PersistentLimiter``). The binary stacks them as the JAX binary does
(serving/__main__.py ``build_limiter_stack``).

Metric names are the JAX package's:

* ``rate_limiter_requests_total{algorithm,result}`` — result is allowed /
  denied / fail_open / mixed (a batch) / error:<kind>;
* ``rate_limiter_decisions_allowed_total`` / ``_denied_total`` — per
  decision, one reduction over the batch mask;
* ``rate_limiter_latency_seconds{algorithm,op}`` — wall time of the inner
  call (the resolve of a pipelined batch);
* ``rate_limiter_batch_size`` — histogram of decisions per inner dispatch;
* ``rate_limiter_storage_errors_total{algorithm}`` — backend failures,
  whether surfaced as fail-open or raised;
* the windowed sketch's accuracy envelope
  (``rate_limiter_sketch_overload_periods``, ``..._in_window_admitted_mass``,
  ``..._mass_budget``), the token bucket's debt slab
  (``rate_limiter_debt_slab_occupancy``, ``..._collision_probability``)
  and the side table's top consumers (``rate_limiter_top_consumer_mass``
  by rank 1-5, ``rate_limiter_hh_tracked_consumers``), the last two
  families refreshed by scrape-time collect hooks.

Every public method of the port's limiters is delegated EXPLICITLY: the
base class defines several of them (launch_batch, resolve,
capture_state), so ``__getattr__`` would never fire for those and the
decorator would run the base's eager fallback instead of the backend's
pipelined path. Since the decorator therefore always has ``allow_ids``,
the serving door detects the raw-id lane on ``undecorated(limiter)``.

``TracingDecorator`` annotates with ``torch.profiler.record_function``
where the JAX package uses ``jax.profiler.TraceAnnotation``, and also
annotates the raw-id lane's launches (``launch``) and synchronous calls,
which the door's hashed frames take.

Around a composite backend (the sliced mesh, ``sub_limiters()`` > 1) the
breaker scopes a failure attributed to one slice (an exception's
``slice_index``, a result's ``fail_open_slices``) to that slice's own
breaker state, as the JAX breaker does; unattributed failures trip the
whole-keyspace breaker. The metrics decorator's per-unit gauges (the
debt slab, the top consumers) carry one series per slice.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.errors import (
    ClosedError,
    InvalidKeyError,
    InvalidNError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    BatchResult,
    DispatchTicket,
    Result,
    batch_fail_open,
    fail_open_result,
)
from ratelimiter_tpu_torch.observability import metrics as m


class LimiterDecorator(RateLimiter):
    """Base decorator: delegates the whole RateLimiter surface to ``inner``.

    Validation, clocking, and locking all live in the inner limiter; the
    decorator only observes. Subclasses override the ``_observe_*`` hooks.
    """

    def __init__(self, inner: RateLimiter):
        # Deliberately NOT calling RateLimiter.__init__: config is already
        # validated by (and owned by) the inner limiter.
        self.inner = inner
        self._closed = False

    # Delegated attributes ------------------------------------------------

    @property
    def config(self):  # type: ignore[override]
        return self.inner.config

    @property
    def clock(self):  # type: ignore[override]
        return self.inner.clock

    # Public surface (decorated) ------------------------------------------

    def allow(self, key: str, *, now: Optional[float] = None) -> Result:
        return self.allow_n(key, 1, now=now)

    def allow_n(self, key: str, n: int, *, now: Optional[float] = None) -> Result:
        t0 = time.perf_counter()
        try:
            res = self.inner.allow_n(key, n, now=now)
        except Exception as exc:
            self._observe_error("allow_n", exc, time.perf_counter() - t0)
            raise
        self._observe_result("allow_n", res, n, time.perf_counter() - t0)
        return res

    def allow_batch(self, keys: Sequence[str], ns=None, *,
                    now: Optional[float] = None) -> BatchResult:
        t0 = time.perf_counter()
        try:
            out = self.inner.allow_batch(keys, ns, now=now)
        except Exception as exc:
            self._observe_error("allow_batch", exc, time.perf_counter() - t0)
            raise
        self._observe_batch("allow_batch", out, ns, time.perf_counter() - t0)
        return out

    def reset(self, key: str) -> None:
        t0 = time.perf_counter()
        try:
            self.inner.reset(key)
        except Exception as exc:
            self._observe_error("reset", exc, time.perf_counter() - t0)
            raise
        self._observe_op("reset", time.perf_counter() - t0)

    # Pipelined dispatch: launch passes through unobserved (it only
    # enqueues); the batch is observed ONCE, at resolve, where the
    # decisions exist. Explicit delegation is required — the base class
    # defines launch_batch/resolve, so __getattr__ would never fire and
    # the decorator would run the base eager fallback instead of the
    # backend's pipelined path.

    @property
    def pipelined(self):  # type: ignore[override]
        return getattr(self.inner, "pipelined", False)

    def launch_batch(self, keys: Sequence[str], ns=None, *,
                     now: Optional[float] = None):
        return self.inner.launch_batch(keys, ns, now=now)

    def resolve(self, ticket):
        t0 = time.perf_counter()
        try:
            out = self.inner.resolve(ticket)
        except Exception as exc:
            self._observe_error("resolve", exc, time.perf_counter() - t0)
            raise
        self._observe_batch("resolve", out, None, time.perf_counter() - t0)
        return out

    # Hashed / raw-id lane: explicit delegation for the same
    # reason as launch_batch/resolve — subclasses (the breaker) must be
    # able to interpose, and the synchronous forms must be observed.
    # The serving doors detect lane SUPPORT on the undecorated backend
    # (hasattr on the decorator would now always be true), so these
    # definitions never advertise a lane the inner limiter lacks.

    def allow_hashed(self, h64, ns=None, *, now: Optional[float] = None):
        t0 = time.perf_counter()
        try:
            out = self.inner.allow_hashed(h64, ns, now=now)
        except Exception as exc:
            self._observe_error("allow_hashed", exc,
                                time.perf_counter() - t0)
            raise
        self._observe_batch("allow_hashed", out, ns,
                            time.perf_counter() - t0)
        return out

    def allow_ids(self, ids, ns=None, *, now: Optional[float] = None):
        t0 = time.perf_counter()
        try:
            out = self.inner.allow_ids(ids, ns, now=now)
        except Exception as exc:
            self._observe_error("allow_ids", exc, time.perf_counter() - t0)
            raise
        self._observe_batch("allow_ids", out, ns, time.perf_counter() - t0)
        return out

    def launch_hashed(self, h64, ns=None, *, now: Optional[float] = None):
        return self.inner.launch_hashed(h64, ns, now=now)

    def launch_ids(self, ids, ns=None, *, now: Optional[float] = None,
                   wire: bool = False):
        return self.inner.launch_ids(ids, ns, now=now, wire=wire)

    def close(self) -> None:
        self._closed = True
        self.inner.close()

    def update_limit(self, new_limit: int) -> None:
        # Delegate wholesale (config lives on the inner limiter; the
        # decorator's config property reflects it automatically).
        self.inner.update_limit(new_limit)

    def update_window(self, new_window: float) -> None:
        # Same: the base implementation would run against the decorator
        # and try to assign its read-only config property.
        self.inner.update_window(new_window)

    def capture_state(self):
        # Explicit (base defines it, so __getattr__ never fires): the
        # durability subsystem snapshots the BACKEND's state.
        return self.inner.capture_state()

    def restore_state(self, arrays: dict, extra: dict) -> None:
        self.inner.restore_state(arrays, extra)

    def save(self, path: str) -> None:
        self.inner.save(path)

    def restore(self, path: str) -> None:
        self.inner.restore(path)

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        self.inner.inject_failure(exc)

    def heal(self) -> None:
        self.inner.heal()

    # Policy overrides: delegate wholesale rather than running the base
    # implementation against a delegated ``_policy_table`` (a backend
    # that overrides the policy surface keeps its semantics under any
    # decorator stack).

    def set_override(self, key: str, limit: Optional[int] = None, *,
                     window_scale: float = 1.0):
        return self.inner.set_override(key, limit,
                                       window_scale=window_scale)

    def get_override(self, key: str):
        return self.inner.get_override(key)

    def delete_override(self, key: str) -> bool:
        return self.inner.delete_override(key)

    def list_overrides(self):
        return self.inner.list_overrides()

    def override_count(self) -> int:
        return self.inner.override_count()

    def sub_limiters(self):
        # The dispatch units live on the backend; the base impl would
        # wrongly answer [decorator].
        return self.inner.sub_limiters()

    # Hierarchy surface (ADR-020): same explicit-delegation rule as the
    # policy surface — the base class defines these, so __getattr__
    # never fires.

    def set_tenant(self, name: str, limit: Optional[int] = None, *,
                   weight: int = 1, floor: Optional[int] = None):
        return self.inner.set_tenant(name, limit, weight=weight,
                                     floor=floor)

    def delete_tenant(self, name: str) -> bool:
        return self.inner.delete_tenant(name)

    def assign_tenant(self, key: str, tenant: str) -> None:
        return self.inner.assign_tenant(key, tenant)

    def unassign_tenant(self, key: str) -> bool:
        return self.inner.unassign_tenant(key)

    def tenant_of(self, key: str) -> str:
        return self.inner.tenant_of(key)

    def get_tenant(self, name: str):
        return self.inner.get_tenant(name)

    def list_tenants(self):
        return self.inner.list_tenants()

    def set_global_limit(self, limit) -> None:
        return self.inner.set_global_limit(limit)

    def set_effective(self, scope: str, limit: int) -> int:
        return self.inner.set_effective(scope, limit)

    def effective_limits(self):
        return self.inner.effective_limits()

    def hierarchy_payload(self) -> dict:
        return self.inner.hierarchy_payload()

    def apply_hierarchy_payload(self, payload: dict) -> bool:
        return self.inner.apply_hierarchy_payload(payload)

    def hierarchy_stats(self) -> dict:
        return self.inner.hierarchy_stats()

    # Pass-through for backend extras (device, mass_budget, ...) ---------

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    # Hooks ----------------------------------------------------------------

    def _observe_result(self, op: str, res: Result, n: int, dt: float) -> None:
        pass

    def _observe_batch(self, op: str, out: BatchResult, ns, dt: float) -> None:
        pass

    def _observe_op(self, op: str, dt: float) -> None:
        pass

    def _observe_error(self, op: str, exc: Exception, dt: float) -> None:
        pass

    # The abstract hooks are never reached (public surface is overridden),
    # but the ABC requires concrete definitions.

    def _allow_n(self, key: str, n: int, now: float) -> Result:  # pragma: no cover
        raise AssertionError("decorator delegates the public surface")

    def _reset(self, key: str) -> None:  # pragma: no cover
        raise AssertionError("decorator delegates the public surface")


def undecorated(limiter: RateLimiter) -> RateLimiter:
    """Peel the decorator stack down to the backend limiter (the object
    owning ``_state``/``_lock``, which checkpoint and DCN code needs)."""
    while isinstance(limiter, LimiterDecorator):
        limiter = limiter.inner
    return limiter


def _error_kind(exc: Exception) -> str:
    if isinstance(exc, StorageUnavailableError):
        return "storage_unavailable"
    if isinstance(exc, InvalidNError):
        return "invalid_n"
    if isinstance(exc, InvalidKeyError):
        return "invalid_key"
    if isinstance(exc, ClosedError):
        return "closed"
    return "internal"


class MetricsDecorator(LimiterDecorator):
    """Records the reference-specced metric families into a Registry
    (``docs/ADR/003:44-66``; names ``docs/ARCHITECTURE.md:550-566``)."""

    def __init__(self, inner: RateLimiter,
                 registry: Optional[m.Registry] = None,
                 shard: str = "0"):
        super().__init__(inner)
        reg = registry if registry is not None else m.DEFAULT
        self.registry = reg
        #: The gauges' ``shard`` label: with dispatch shards (the native
        #: door's ``--shards``) each shard's decorator labels its own
        #: series, so an overloaded shard is not hidden behind the last
        #: one observed.
        self._shard = str(shard)
        self._algo = str(inner.config.algorithm)
        self._requests = reg.counter(
            "rate_limiter_requests_total",
            "Rate limit checks by algorithm and result")
        self._allowed = reg.counter(
            "rate_limiter_decisions_allowed_total",
            "Individual decisions allowed (device-side mask sum)")
        self._denied = reg.counter(
            "rate_limiter_decisions_denied_total",
            "Individual decisions denied (device-side mask sum)")
        self._latency = reg.histogram(
            "rate_limiter_latency_seconds",
            "Inner limiter call latency", m.LATENCY_BUCKETS)
        self._batch = reg.histogram(
            "rate_limiter_batch_size",
            "Decisions per batched dispatch", m.BATCH_BUCKETS)
        self._errors = reg.counter(
            "rate_limiter_storage_errors_total",
            "Backend failures (fail-open allowances included)")
        # Accuracy-envelope surface (windowed sketch only): exported so a
        # mis-sized geometry shows up on /metrics, not just in a log line
        # (SURVEY.md §7.4 hard part 3; docs/OPERATIONS.md §3).
        base = undecorated(inner)
        self._sketch = base if hasattr(base, "_period_mass") else None
        if self._sketch is not None:
            self._overload_g = reg.gauge(
                "rate_limiter_sketch_overload_periods",
                "Sub-windows whose admitted mass exceeded the geometry's "
                "accuracy budget (growing value = undersized sketch)")
            self._mass_g = reg.gauge(
                "rate_limiter_sketch_in_window_admitted_mass",
                "Admitted requests currently inside the sliding window")
            self._budget_g = reg.gauge(
                "rate_limiter_sketch_mass_budget",
                "Admitted-mass level where collision error reaches ~1% "
                "false denies for this geometry")
            self._budget_g.set(float(base.mass_budget), shard=self._shard)
        # Debt-slab surface (token-bucket sketch only): the continuous-
        # decay mirror of the mass watchdog. Reading it costs a device
        # fetch under the backend lock, so the gauges refresh via a
        # scrape-time collect hook, never per decision; one series per
        # dispatch unit (sub_limiters: one on the port's card).
        # Top-K consumer surface (heavy-hitter side table, ADR-016 §5):
        # promoted hot keys' exact in-window counts exported as ranked
        # gauges — refreshed by the same scrape-time collect-hook seam
        # as the debt slab (a K-slot device fetch per unit per scrape,
        # never the decide path). Consumer identity goes to /healthz
        # and /debug/audit as hash tokens; the gauge keys by RANK so
        # label cardinality stays bounded.
        self._hh_units = [
            (i, sl) for i, sl in enumerate(base.sub_limiters())
            if getattr(sl, "has_hh", False)]
        if self._hh_units:
            self._hh_top_g = reg.gauge(
                "rate_limiter_top_consumer_mass",
                "In-window admitted mass of the rank-N hottest tracked "
                "consumer (heavy-hitter side table; identities on "
                "/debug/audit)")
            self._hh_occ_g = reg.gauge(
                "rate_limiter_hh_tracked_consumers",
                "Occupied heavy-hitter slots (promoted hot keys "
                "currently tracked exactly)")
            reg.add_collect_hook(self._collect_consumers)
        self._debt_slabs = [
            (i, sl) for i, sl in enumerate(base.sub_limiters())
            if hasattr(sl, "debt_slab_stats")]
        if self._debt_slabs:
            self._debt_occ_g = reg.gauge(
                "rate_limiter_debt_slab_occupancy",
                "Max per-row fraction of debt cells with positive "
                "effective debt (colliding active keys share refill; "
                "hot rows throttle hot keys toward combined throughput)")
            self._debt_coll_g = reg.gauge(
                "rate_limiter_debt_slab_collision_probability",
                "Chance a fresh key reads an overestimated debt (an "
                "occupied cell in every sketch row) — errors are toward "
                "denying")
            reg.add_collect_hook(self._collect_debt_slab)

    def _collect_debt_slab(self) -> None:
        for i, sl in self._debt_slabs:
            st = sl.debt_slab_stats()
            self._debt_occ_g.set(st["occupancy"],
                                 shard=self._shard, slice=str(i))
            self._debt_coll_g.set(st["collision_p"],
                                  shard=self._shard, slice=str(i))

    def _collect_consumers(self) -> None:
        for i, sl in self._hh_units:
            st = sl.consumer_stats(k=5)
            self._hh_occ_g.set(float(st["occupied"]),
                               shard=self._shard, slice=str(i))
            top = st["top"]
            # Every rank 1..5 is written each scrape: when the list
            # SHRINKS (a hot key's window rolled off), the vacated
            # ranks must drop to 0 — a gauge only overwrites label
            # sets it is told to, so skipping them would leave phantom
            # heavy hitters frozen at their last mass forever.
            for rank in range(1, 6):
                mass = (float(top[rank - 1]["in_window"])
                        if rank <= len(top) else 0.0)
                self._hh_top_g.set(mass, shard=self._shard,
                                   slice=str(i), rank=str(rank))

    def close(self) -> None:
        # Unhook BEFORE closing: on the process-default registry a
        # leftover collect hook would pin this decorator (and the closed
        # backend's device arrays) forever and poke it on every scrape.
        if self._debt_slabs:
            self.registry.remove_collect_hook(self._collect_debt_slab)
        if self._hh_units:
            self.registry.remove_collect_hook(self._collect_consumers)
        super().close()

    def _observe_envelope(self) -> None:
        if self._sketch is not None:
            self._overload_g.set(float(self._sketch.overload_periods),
                                 shard=self._shard)
            self._mass_g.set(float(self._sketch.in_window_admitted_mass()),
                             shard=self._shard)
            self._budget_g.set(float(self._sketch.mass_budget),
                               shard=self._shard)

    def _result_label(self, res: Result) -> str:
        if res.fail_open:
            return "fail_open"
        return "allowed" if res.allowed else "denied"

    def _observe_result(self, op: str, res: Result, n: int, dt: float) -> None:
        self._requests.inc(algorithm=self._algo, result=self._result_label(res))
        if res.fail_open:
            self._errors.inc(algorithm=self._algo)
        if res.allowed:
            self._allowed.inc(algorithm=self._algo)
        else:
            self._denied.inc(algorithm=self._algo)
        self._latency.observe(dt, algorithm=self._algo, op=op)
        self._batch.observe(1.0)
        self._observe_envelope()

    def _observe_batch(self, op: str, out: BatchResult, ns, dt: float) -> None:
        b = len(out)
        n_allowed = int(np.sum(out.allowed))
        result = "fail_open" if out.fail_open else "mixed"
        self._requests.inc(b, algorithm=self._algo, result=result)
        if out.fail_open:
            self._errors.inc(algorithm=self._algo)
        self._allowed.inc(n_allowed, algorithm=self._algo)
        self._denied.inc(b - n_allowed, algorithm=self._algo)
        self._latency.observe(dt, algorithm=self._algo, op=op)
        self._batch.observe(float(b))
        self._observe_envelope()

    def _observe_op(self, op: str, dt: float) -> None:
        self._latency.observe(dt, algorithm=self._algo, op=op)

    def _observe_error(self, op: str, exc: Exception, dt: float) -> None:
        kind = _error_kind(exc)
        self._requests.inc(algorithm=self._algo, result=f"error:{kind}")
        if kind == "storage_unavailable":
            self._errors.inc(algorithm=self._algo)
        self._latency.observe(dt, algorithm=self._algo, op=op)


class TracingDecorator(LimiterDecorator):
    """Profiler-annotation wrapper (the JAX package's ``TracingDecorator``
    with ``torch.profiler``).

    Every decorated call runs inside a named
    ``torch.profiler.record_function`` range
    (``ratelimiter/<algorithm>/<op>``), so the kernels a call launches
    show up under it in a profiler trace: ``allow_n``, ``allow_batch``,
    ``allow_hashed``, ``allow_ids``, ``reset``, and the pipelined path's
    two phases, ``launch`` (every lane's) and ``resolve``. A range costs a
    little even with no profiler running, which is why the binary only
    stacks this decorator under ``--trace``. ``capture(path)`` profiles
    everything inside a with-block and writes a Chrome trace."""

    def __init__(self, inner: RateLimiter):
        super().__init__(inner)
        self._algo = str(inner.config.algorithm)

    def _annotation(self, op: str):
        import torch.profiler

        return torch.profiler.record_function(
            f"ratelimiter/{self._algo}/{op}")

    def allow_n(self, key: str, n: int, *, now: Optional[float] = None) -> Result:
        with self._annotation("allow_n"):
            return self.inner.allow_n(key, n, now=now)

    def allow_batch(self, keys: Sequence[str], ns=None, *,
                    now: Optional[float] = None) -> BatchResult:
        with self._annotation("allow_batch"):
            return self.inner.allow_batch(keys, ns, now=now)

    def allow_hashed(self, h64, ns=None, *, now: Optional[float] = None):
        with self._annotation("allow_hashed"):
            return self.inner.allow_hashed(h64, ns, now=now)

    def allow_ids(self, ids, ns=None, *, now: Optional[float] = None):
        with self._annotation("allow_ids"):
            return self.inner.allow_ids(ids, ns, now=now)

    def reset(self, key: str) -> None:
        with self._annotation("reset"):
            self.inner.reset(key)

    def launch_batch(self, keys: Sequence[str], ns=None, *,
                     now: Optional[float] = None):
        # The pipelined hot path's two phases each get their own
        # annotation — without these, the default serving path's device
        # work would show up unattributed in a trace.
        with self._annotation("launch"):
            return self.inner.launch_batch(keys, ns, now=now)

    def launch_hashed(self, h64, ns=None, *, now: Optional[float] = None):
        with self._annotation("launch"):
            return self.inner.launch_hashed(h64, ns, now=now)

    def launch_ids(self, ids, ns=None, *, now: Optional[float] = None,
                   wire: bool = False):
        with self._annotation("launch"):
            return self.inner.launch_ids(ids, ns, now=now, wire=wire)

    def resolve(self, ticket):
        with self._annotation("resolve"):
            return self.inner.resolve(ticket)

    @contextmanager
    def capture(self, path: str):
        """Profile everything inside the with-block and write it to
        ``path`` as a Chrome trace (``export_chrome_trace``; chrome://
        tracing and Perfetto open it). The CPU is always traced, the
        card too when the limiter's device is CUDA. A profiler that
        cannot trace the card raises here instead of writing a trace
        without it."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        device = getattr(undecorated(self.inner), "device", None)
        if getattr(device, "type", None) == "cuda":
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError("torch.profiler cannot trace CUDA here")
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        try:
            yield self
        finally:
            if len(acts) > 1:
                torch.cuda.synchronize(device)
            prof.stop()
            prof.export_chrome_trace(path)


class CircuitBreakerDecorator(LimiterDecorator):
    """Circuit breaker around a limiter backend — the reference's planned
    resilience layer (``docs/ADR/002:170-197``, ``ROADMAP.md:104-108``:
    closed / open / half-open states), realized as a decorator.

    * closed: calls pass through; ``failure_threshold`` CONSECUTIVE
      backend failures (StorageUnavailableError raised, or a fail-open
      allowance — both mean the backend is down) trip the breaker;
    * open: for ``cooldown`` seconds the backend is not touched at all —
      decisions short-circuit per the limiter's fail-open/fail-closed
      policy (the point: a dead backend stops eating a dispatch timeout
      per request);
    * half-open: after the cooldown, exactly one probe call reaches the
      backend; success closes the breaker, failure re-opens it with a
      fresh cooldown.

    Time comes from the wrapped limiter's clock, so breaker tests use
    virtual time like everything else.
    """

    def __init__(self, inner: RateLimiter, *, failure_threshold: int = 5,
                 cooldown: float = 10.0,
                 registry: Optional[m.Registry] = None):
        super().__init__(inner)
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown = float(cooldown)
        self._state = "closed"
        self._consecutive = 0
        self._open_until = 0.0
        self._probe_inflight = False
        self._cb_lock = threading.Lock()
        #: Per-sub-limiter scoping: around a
        #: composite backend (the sliced mesh — sub_limiters() > 1), a
        #: failure ATTRIBUTED to one slice (exception ``slice_index`` /
        #: result ``fail_open_slices``) counts against that slice's own
        #: breaker state and NEVER the whole-keyspace one — one bad
        #: device must not short-circuit every other range. Unattributed
        #: failures (the whole backend down) trip the global breaker as
        #: before.
        self._scoped = len(undecorated(inner).sub_limiters()) > 1
        self._sub_consecutive: dict = {}
        self._sub_last_failure: dict = {}
        self._sub_open_until: dict = {}
        reg = registry if registry is not None else m.DEFAULT
        self._transitions = reg.counter(
            "rate_limiter_breaker_transitions_total",
            "Circuit breaker state transitions")
        self._short_circuits = reg.counter(
            "rate_limiter_breaker_short_circuits_total",
            "Decisions answered without touching the backend")

    @property
    def state(self) -> str:
        return self._state

    def sub_state(self, index: int, now: Optional[float] = None) -> str:
        """Scoped breaker state of one sub-limiter: "open" while its
        cooldown runs, else "closed" (slice-scoped failures never have
        a half-open phase here — the quarantine manager owns per-slice
        probing; this state is attribution bookkeeping)."""
        t = self.inner.clock.now() if now is None else float(now)
        with self._cb_lock:
            return ("open"
                    if self._sub_open_until.get(index, 0.0) > t
                    else "closed")

    def sub_states(self) -> dict:
        with self._cb_lock:
            return dict(self._sub_open_until)

    @staticmethod
    def _exc_slices(exc: Exception):
        si = getattr(exc, "slice_index", None)
        return [si] if si is not None else None

    def _trip(self, now: float) -> None:
        self._state = "open"
        self._open_until = now + self.cooldown
        self._transitions.inc(to="open")

    def _clear_probe(self) -> None:
        """Release the half-open probe slot without judging backend health.

        Non-storage exceptions (key/N validation, a closed limiter, bugs)
        say nothing about whether the backend recovered; counting them as
        failures would re-open the breaker on caller mistakes, and not
        clearing the slot would wedge the breaker permanently (every later
        call short-circuits because the probe "never returned").
        Only the call that OWNS the slot may release it.
        """
        with self._cb_lock:
            self._probe_inflight = False

    def _note_result(self, failed: bool, now: float, probe: bool,
                     slices=None) -> None:
        with self._cb_lock:
            if probe:
                self._probe_inflight = False
            if failed:
                if slices and self._scoped:
                    # Slice-attributed failure: count against the named
                    # slices only. The whole-keyspace breaker must keep
                    # admitting traffic for every other range — that is
                    # the regression a single-slice fault storm used to
                    # cause (it tripped the global breaker). "Consecutive"
                    # is cooldown-windowed: a failure more than one
                    # cooldown after the slice's previous one restarts
                    # its count (a healthy frame can't clear it — frames
                    # not touching the slice say nothing about it — so
                    # isolated transients must not accumulate forever).
                    for s in slices:
                        last = self._sub_last_failure.get(s, 0.0)
                        stale = now - last > self.cooldown
                        self._sub_last_failure[s] = now
                        c = (1 if stale
                             else self._sub_consecutive.get(s, 0) + 1)
                        self._sub_consecutive[s] = c
                        if (c >= self.failure_threshold
                                and self._sub_open_until.get(s, 0.0)
                                <= now):
                            self._sub_open_until[s] = now + self.cooldown
                            self._transitions.inc(to="open",
                                                  slice=str(s))
                    return
                self._consecutive += 1
                if (self._state == "half-open"
                        or self._consecutive >= self.failure_threshold):
                    self._trip(now)
            else:
                self._consecutive = 0
                if self._state != "closed":
                    self._state = "closed"
                    self._transitions.inc(to="closed")

    def _admit_call(self, now: float) -> Optional[bool]:
        """None = short-circuit; False = admitted (breaker closed);
        True = admitted as THE half-open probe (this call owns the slot
        and is the only one allowed to release it — a concurrent
        closed-state call that later fails must not free a slot it never
        held, or two probes could run at once)."""
        with self._cb_lock:
            if self._state == "closed":
                return False
            if self._state == "open" and now >= self._open_until:
                self._state = "half-open"
                self._transitions.inc(to="half-open")
            if self._state == "half-open" and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return None

    def _short_circuit(self, b: int, now: float):
        self._short_circuits.inc(b)
        cfg = self.inner.config
        reset_at = now + float(cfg.window)
        if not cfg.fail_open:
            raise StorageUnavailableError(
                f"circuit breaker open (cooldown {self.cooldown:g}s)")
        if b == 1:
            return fail_open_result(cfg.limit, reset_at)
        return batch_fail_open(b, cfg.limit, reset_at)

    def allow_n(self, key: str, n: int, *, now: Optional[float] = None) -> Result:
        t = self.inner.clock.now() if now is None else float(now)
        probe = self._admit_call(t)
        if probe is None:
            return self._short_circuit(1, t)
        try:
            res = self.inner.allow_n(key, n, now=now)
        except StorageUnavailableError as exc:
            self._note_result(True, t, probe, self._exc_slices(exc))
            raise
        except BaseException:
            if probe:
                self._clear_probe()
            raise
        self._note_result(res.fail_open, t, probe,
                          getattr(res, "fail_open_slices", None))
        return res

    def allow_batch(self, keys: Sequence[str], ns=None, *,
                    now: Optional[float] = None) -> BatchResult:
        t = self.inner.clock.now() if now is None else float(now)
        probe = self._admit_call(t)
        if probe is None:
            return self._short_circuit(len(keys), t)
        try:
            out = self.inner.allow_batch(keys, ns, now=now)
        except StorageUnavailableError as exc:
            self._note_result(True, t, probe, self._exc_slices(exc))
            raise
        except BaseException:
            if probe:
                self._clear_probe()
            raise
        self._note_result(out.fail_open, t, probe,
                          getattr(out, "fail_open_slices", None))
        return out

    # Pipelined path (ADR-010): the breaker admits (or short-circuits) at
    # LAUNCH — an open breaker must not enqueue device work at all — and
    # judges backend health at RESOLVE, where failure actually surfaces.
    # Probe ownership rides the ticket's meta field between the phases.

    def launch_batch(self, keys: Sequence[str], ns=None, *,
                     now: Optional[float] = None):
        t = self.inner.clock.now() if now is None else float(now)
        probe = self._admit_call(t)
        if probe is None:
            return DispatchTicket(result=self._short_circuit(len(keys), t))
        try:
            ticket = self.inner.launch_batch(keys, ns, now=now)
        except StorageUnavailableError as exc:
            self._note_result(True, t, probe, self._exc_slices(exc))
            raise
        except BaseException:
            if probe:
                self._clear_probe()
            raise
        ticket.meta = ("breaker", t, probe)
        return ticket

    # Hashed / raw-id lane (ADR-011): the breaker guards every dispatch
    # entry point identically — an open breaker must not enqueue device
    # work for hashed frames any more than for string batches.

    def _guarded_sync(self, fn, b: int, now):
        t = self.inner.clock.now() if now is None else float(now)
        probe = self._admit_call(t)
        if probe is None:
            return self._short_circuit(b, t)
        try:
            out = fn()
        except StorageUnavailableError as exc:
            self._note_result(True, t, probe, self._exc_slices(exc))
            raise
        except BaseException:
            if probe:
                self._clear_probe()
            raise
        self._note_result(out.fail_open, t, probe,
                          getattr(out, "fail_open_slices", None))
        return out

    def _guarded_launch(self, fn, b: int, now):
        t = self.inner.clock.now() if now is None else float(now)
        probe = self._admit_call(t)
        if probe is None:
            return DispatchTicket(result=self._short_circuit(b, t))
        try:
            ticket = fn()
        except StorageUnavailableError as exc:
            self._note_result(True, t, probe, self._exc_slices(exc))
            raise
        except BaseException:
            if probe:
                self._clear_probe()
            raise
        ticket.meta = ("breaker", t, probe)
        return ticket

    def allow_hashed(self, h64, ns=None, *, now=None):
        return self._guarded_sync(
            lambda: self.inner.allow_hashed(h64, ns, now=now),
            len(h64), now)

    def allow_ids(self, ids, ns=None, *, now=None):
        return self._guarded_sync(
            lambda: self.inner.allow_ids(ids, ns, now=now), len(ids), now)

    def launch_hashed(self, h64, ns=None, *, now=None):
        return self._guarded_launch(
            lambda: self.inner.launch_hashed(h64, ns, now=now),
            len(h64), now)

    def launch_ids(self, ids, ns=None, *, now=None, wire: bool = False):
        return self._guarded_launch(
            lambda: self.inner.launch_ids(ids, ns, now=now, wire=wire),
            len(ids), now)

    def resolve(self, ticket):
        tag = None
        if (isinstance(ticket.meta, tuple) and ticket.meta
                and ticket.meta[0] == "breaker"):
            tag = ticket.meta
            ticket.meta = None
        try:
            out = self.inner.resolve(ticket)
        except StorageUnavailableError as exc:
            if tag is not None:
                self._note_result(True, tag[1], tag[2],
                                  self._exc_slices(exc))
            raise
        except BaseException:
            if tag is not None and tag[2]:
                self._clear_probe()
            raise
        if tag is not None:
            self._note_result(out.fail_open, tag[1], tag[2],
                              getattr(out, "fail_open_slices", None))
        return out


class LoggingDecorator(LimiterDecorator):
    """Structured logging wrapper (``docs/ADR/003:68-91``): decisions at
    DEBUG, fail-open allowances at WARNING, errors at ERROR.

    Keys on the scalar path are logged at the caller's discretion:
    by default as given (the caller owns PII policy, as in the
    reference), or — with ``redact_keys=True`` — as the splitmix64 hash
    of the key's finalized u64 hash (``key#<16 hex>``), an irreversible
    but stable token that still correlates log lines per key without
    writing raw identifiers (user ids, API tokens, emails) into log
    storage. The PII trust boundary is documented in
    docs/OPERATIONS.md §6.
    """

    def __init__(self, inner: RateLimiter,
                 logger: Optional[logging.Logger] = None, *,
                 redact_keys: bool = False):
        super().__init__(inner)
        self.logger = logger if logger is not None else logging.getLogger(
            "ratelimiter_tpu_torch")
        self._algo = str(inner.config.algorithm)
        self.redact_keys = bool(redact_keys)

    def _fmt_key(self, key: str) -> str:
        if not self.redact_keys:
            return key
        from ratelimiter_tpu_torch.ops.hashing import key_token

        # Shared token rule (ops/hashing.key_token): redacted log lines
        # stay joinable with journal key_hash fields.
        return key_token(key)

    # Scalar path: overridden (not just hooked) so the KEY is in scope
    # for the log line — the base hooks deliberately do not carry it.

    def allow_n(self, key: str, n: int, *,
                now: Optional[float] = None) -> Result:
        t0 = time.perf_counter()
        try:
            res = self.inner.allow_n(key, n, now=now)
        except Exception as exc:
            self._observe_error("allow_n", exc, time.perf_counter() - t0)
            raise
        dt = time.perf_counter() - t0
        if res.fail_open:
            self.logger.warning(
                "fail-open allowance algorithm=%s key=%s n=%d "
                "latency=%.6f",
                self._algo, self._fmt_key(key), n, dt)
        elif self.logger.isEnabledFor(logging.DEBUG):
            self.logger.debug(
                "decision algorithm=%s key=%s allowed=%s n=%d remaining=%d "
                "latency=%.6f",
                self._algo, self._fmt_key(key), res.allowed, n,
                res.remaining, dt)
        return res

    def reset(self, key: str) -> None:
        # Quota-erase is audit-worthy: always logged, same redaction.
        t0 = time.perf_counter()
        try:
            self.inner.reset(key)
        except Exception as exc:
            self._observe_error("reset", exc, time.perf_counter() - t0)
            raise
        self.logger.info("reset algorithm=%s key=%s latency=%.6f",
                         self._algo, self._fmt_key(key),
                         time.perf_counter() - t0)

    def _observe_batch(self, op: str, out: BatchResult, ns, dt: float) -> None:
        if out.fail_open:
            self.logger.warning(
                "fail-open batch algorithm=%s size=%d latency=%.6f",
                self._algo, len(out), dt)
        elif self.logger.isEnabledFor(logging.DEBUG):
            self.logger.debug(
                "batch algorithm=%s size=%d allowed=%d latency=%.6f",
                self._algo, len(out), int(np.sum(out.allowed)), dt)

    def _observe_error(self, op: str, exc: Exception, dt: float) -> None:
        self.logger.error("limiter error op=%s algorithm=%s error=%s",
                          op, self._algo, exc)
