"""Per-slice failure domains for the sliced mesh tier — a port of
``ratelimiter_tpu/parallel/quarantine.py`` (ADR-015).

The slice-parallel serving tier (ADR-012) gives every device its own
independent limiter slice — which means a fault on one device is
*naturally* scoped to one key range. This module turns that topology
into a contract:

* :func:`classify_failure` — is an exception a BACKEND fault (device
  error, storage outage, injected chaos, deadline) or a CALLER error
  (validation, closed limiter, config drift)? Only backend faults
  quarantine; caller errors propagate untouched.
* :class:`QuarantineManager` — one per deployment: per-slice breaker
  state (healthy → quarantined → probing → restoring → healthy),
  half-open probe scheduling, and the restore-before-rejoin hook
  (snapshot + WAL suffix) that guarantees a recovering slice
  rejoins routing with durable state, never the garbage it wedged on.
* :class:`SliceGuard` — a decorator around ONE slice enforcing the
  per-slice dispatch deadline (a wedged device cannot stall the frame
  past its budget) and answering a quarantined slice's range per the
  configured fail-open/fail-closed policy, stamped with the LIVE
  limit/window (the ADR-013 multi-shard OR contract: the frame's
  ``fail_open`` flag ORs over slices).

The whole subsystem is opt-in (``MeshSpec.quarantine``); with it off,
no guard exists and the mesh hot path holds no guard at all.

Faults are injected where real ones surface: the chaos injector's slice
hooks (``chaos.INJECTOR.slice_launch``/``slice_resolve``) fire inside
this guard, and its ``SliceFault`` classifies as a backend fault. torch's
CUDA errors are ``RuntimeError``s, as XLA's are, so they classify as
backend faults too.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue as queue_mod
import threading
from typing import Callable, Optional

import numpy as np

from ratelimiter_tpu_torch.core.errors import (
    CheckpointError,
    ClosedError,
    DeadlineExceededError,
    InvalidConfigError,
    InvalidKeyError,
    InvalidNError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    DispatchTicket,
    batch_fail_open,
    fail_open_result,
)
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability.decorators import LimiterDecorator

log = logging.getLogger("ratelimiter_tpu_torch.quarantine")


class _DaemonExecutor:
    """Single-worker executor on a DAEMON thread (the minimal slice of
    the concurrent.futures API the guard needs). A stock
    ThreadPoolExecutor's workers are non-daemon and are JOINED by the
    interpreter's atexit hook — a dispatch wedged forever (the exact
    failure quarantine contains) would then hang process shutdown on
    the very thread that is stuck inside it."""

    def __init__(self, name: str):
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as exc:  # noqa: BLE001 — future carries it
                fut.set_exception(exc)

    def submit(self, fn, *args) -> "concurrent.futures.Future":
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, fn, args))
        return fut

    def shutdown(self) -> None:
        self._q.put(None)

#: Reserved probe key hash (golden-ratio constant, top bit set): the
#: half-open probe dispatches ONE unit request against this hash. The
#: admitted mass lands on one CMS cell per row (noise toward denying,
#: bounded by probe cadence) and is overwritten by the snapshot restore
#: that follows a successful probe anyway.
PROBE_HASH = np.uint64(0x9E3779B97F4A7C15)

#: Exception classes that are NEVER backend faults — caller mistakes and
#: config drift must not quarantine a healthy device.
_CALLER_ERRORS = (InvalidKeyError, InvalidNError, InvalidConfigError,
                  ClosedError, CheckpointError, NotImplementedError,
                  TypeError)


def classify_failure(exc: BaseException) -> bool:
    """True iff ``exc`` indicates the SLICE (device/backend) failed —
    the quarantine-worthy class. Conservative direction: an unknown
    RuntimeError from inside a dispatch is treated as a backend fault
    (torch's CUDA errors are RuntimeErrors); typed caller
    errors never are."""
    if isinstance(exc, _CALLER_ERRORS):
        return False
    if isinstance(exc, (StorageUnavailableError, DeadlineExceededError,
                        TimeoutError, OSError, MemoryError)):
        return True
    from ratelimiter_tpu_torch.chaos.injector import SliceFault

    if isinstance(exc, SliceFault):
        return True
    # torch's CUDA errors are RuntimeErrors.
    return isinstance(exc, RuntimeError)


class QuarantineManager:
    """Per-slice breaker state + probe/restore orchestration.

    States per slice:

    * ``healthy``     — traffic routes normally;
    * ``quarantined`` — the slice's range answers degraded; a half-open
      probe fires every ``probe_interval`` seconds (kicked lazily from
      traffic, or explicitly via :meth:`probe_now`);
    * ``probing``     — one probe dispatch in flight (bounded by the
      slice deadline);
    * ``restoring``   — probe succeeded; the restore hook is replaying
      the newest snapshot + WAL suffix into the slice. Traffic stays
      degraded until restore completes — restore-before-rejoin is the
      invariant that makes recovery correct, not merely live (ADR-015).

    ``restore_fn(slice_idx)`` is wired by the deployment (the
    persistence manager's ``slice_restorer``, persistence/manager.py);
    without durability enabled the
    slice rejoins with its live in-memory state (exact for overrides —
    they are re-applied write-all — and conservative for sketch
    counters).
    """

    def __init__(self, n_slices: int, *, clock=None,
                 probe_interval: float = 1.0,
                 failure_threshold: int = 1,
                 restore_fn: Optional[Callable[[int], None]] = None,
                 on_state_change: Optional[Callable[[int, str], None]] = None,
                 registry: Optional[m.Registry] = None):
        from ratelimiter_tpu_torch.core.clock import SystemClock

        self.n_slices = int(n_slices)
        self.clock = clock if clock is not None else SystemClock()
        self.probe_interval = float(probe_interval)
        self.failure_threshold = int(failure_threshold)
        self.restore_fn = restore_fn
        self.on_state_change = on_state_change
        self._lock = threading.Lock()
        self._state = ["healthy"] * self.n_slices
        self._consecutive = [0] * self.n_slices
        self._next_probe_at = [0.0] * self.n_slices
        self._guards: dict = {}
        self.transitions = 0
        self.degraded_decisions = 0
        reg = registry if registry is not None else m.DEFAULT
        self._g_quarantined = reg.gauge(
            "rate_limiter_slice_quarantined",
            "1 while this mesh slice is out of routing (quarantined/"
            "probing/restoring), 0 while healthy (ADR-015)")
        self._c_transitions = reg.counter(
            "rate_limiter_slice_quarantine_transitions_total",
            "Per-slice quarantine state transitions")
        self._c_degraded = reg.counter(
            "rate_limiter_slice_degraded_decisions_total",
            "Decisions answered per fail-open/closed policy because the "
            "owning slice was quarantined or failed")
        for i in range(self.n_slices):
            self._g_quarantined.set(0.0, slice=str(i))

    # ------------------------------------------------------------ wiring

    def register(self, idx: int, guard: "SliceGuard") -> None:
        self._guards[int(idx)] = guard

    # ------------------------------------------------------- transitions

    def _set_state(self, idx: int, state: str) -> None:
        """Lock held by caller."""
        if self._state[idx] == state:
            return
        prev = self._state[idx]
        self._state[idx] = state
        self.transitions += 1
        self._c_transitions.inc(slice=str(idx), to=state)
        self._g_quarantined.set(0.0 if state == "healthy" else 1.0,
                                slice=str(idx))
        # Control-plane journal (ADR-021): quarantine transitions are
        # exactly the "why did range X degrade at 14:02" record.
        from ratelimiter_tpu_torch.observability import events

        events.emit("quarantine", state, actor=f"slice{idx}",
                    severity=("info" if state == "healthy"
                              else "warning"),
                    payload={"slice": idx, "from": prev,
                             "consecutive_failures":
                                 self._consecutive[idx]})
        cb = self.on_state_change
        if cb is not None:
            try:
                cb(idx, state)
            except Exception:  # noqa: BLE001 — observability only
                log.exception("quarantine on_state_change callback failed")

    def state(self, idx: int) -> str:
        with self._lock:
            return self._state[idx]

    def quarantined(self) -> list:
        with self._lock:
            return [i for i, s in enumerate(self._state) if s != "healthy"]

    def status(self) -> dict:
        """/healthz block (degraded-mode runbook, OPERATIONS §8)."""
        with self._lock:
            states = list(self._state)
        out = {
            "slices": len(states),
            "states": states,
            "quarantined": [i for i, s in enumerate(states)
                            if s != "healthy"],
            "transitions": self.transitions,
            "degraded_decisions": self.degraded_decisions,
            "probe_interval": self.probe_interval,
        }
        out["degraded"] = bool(out["quarantined"])
        return out

    # ----------------------------------------------------------- traffic

    def admit(self, idx: int, now: float) -> bool:
        """True = route traffic to the slice; False = answer degraded.
        A quarantined slice whose probe cadence elapsed kicks a
        BACKGROUND half-open probe — client traffic never rides the
        probe, because the slice must restore before it rejoins."""
        with self._lock:
            if self._state[idx] == "healthy":
                return True
            due = (self._state[idx] == "quarantined"
                   and now >= self._next_probe_at[idx])
            if due:
                self._set_state(idx, "probing")
        if due:
            t = threading.Thread(target=self._probe, args=(idx,),
                                 name=f"rl-probe-{idx}", daemon=True)
            t.start()
        return False

    def note_degraded(self, idx: int, count: int) -> None:
        with self._lock:
            self.degraded_decisions += int(count)
        self._c_degraded.inc(int(count), slice=str(idx))

    def note_success(self, idx: int) -> None:
        with self._lock:
            self._consecutive[idx] = 0

    def note_failure(self, idx: int, exc: BaseException, now: float) -> bool:
        """Record one classified backend failure; returns True iff the
        slice is (now) quarantined."""
        with self._lock:
            self._consecutive[idx] += 1
            already = self._state[idx] != "healthy"
            if already or self._consecutive[idx] >= self.failure_threshold:
                if self._state[idx] in ("healthy", "probing"):
                    log.warning(
                        "slice %d quarantined after %d failure(s): %s",
                        idx, self._consecutive[idx], exc)
                self._set_state(idx, "quarantined")
                self._next_probe_at[idx] = now + self.probe_interval
                return True
            return False

    # ------------------------------------------------------------ levers

    def force(self, idx: int) -> None:
        """Runbook lever: quarantine a slice NOW (e.g. ahead of planned
        device maintenance)."""
        with self._lock:
            self._set_state(idx, "quarantined")
            self._next_probe_at[idx] = (self.clock.now()
                                        + self.probe_interval)

    def clear(self, idx: int) -> None:
        """Runbook lever: return a slice to routing WITHOUT probe or
        restore (operator asserts the device and its state are good)."""
        with self._lock:
            self._consecutive[idx] = 0
            self._set_state(idx, "healthy")

    def probe_now(self, idx: int) -> bool:
        """Synchronous probe + restore + rejoin attempt (tests and the
        runbook's forced-recovery lever). True iff the slice is healthy
        afterwards."""
        with self._lock:
            if self._state[idx] == "healthy":
                return True
            self._set_state(idx, "probing")
        self._probe(idx)
        return self.state(idx) == "healthy"

    # ------------------------------------------------------------- probe

    def _probe(self, idx: int) -> None:
        guard = self._guards.get(idx)
        now = self.clock.now()
        try:
            if guard is not None:
                guard.probe()
        except Exception as exc:  # noqa: BLE001 — every fault re-opens
            with self._lock:
                self._set_state(idx, "quarantined")
                self._next_probe_at[idx] = now + self.probe_interval
            log.info("slice %d probe failed (%s); next probe in %.3gs",
                     idx, exc, self.probe_interval)
            return
        # Probe succeeded: restore BEFORE rejoining routing. A slice
        # that wedged mid-dispatch may hold arbitrary staging garbage;
        # the newest snapshot + WAL suffix is the only state we can
        # vouch for (ADR-015 records why restore-then-rejoin beats
        # rejoin-then-converge).
        with self._lock:
            self._set_state(idx, "restoring")
        if self.restore_fn is not None:
            try:
                self.restore_fn(idx)
            except Exception as exc:  # noqa: BLE001 — stay quarantined
                with self._lock:
                    self._set_state(idx, "quarantined")
                    self._next_probe_at[idx] = (self.clock.now()
                                                + self.probe_interval)
                log.warning("slice %d restore failed (%s); staying "
                            "quarantined", idx, exc)
                return
        with self._lock:
            self._consecutive[idx] = 0
            self._set_state(idx, "healthy")
        log.info("slice %d recovered (probe + restore) and rejoined "
                 "routing", idx)


class SliceGuard(LimiterDecorator):
    """Failure-domain guard around ONE mesh slice (ADR-015).

    Every dispatch entry (launch/decide, string/hashed/raw-id) checks
    quarantine state first: a quarantined slice's work is answered per
    the configured fail-open/fail-closed policy WITHOUT touching the
    device. Live dispatches resolve on the guard's own single worker
    thread bounded by the per-slice deadline, so a wedged device
    surfaces as a classified failure within one budget instead of
    hanging the frame. Chaos hooks (ratelimiter_tpu_torch/chaos/) fire
    inside this guard — the same surfaces real faults use.

    Fail-open degraded answers are stamped with the LIVE limit/window
    (the config property delegates to the inner slice, which
    update_limit/update_window mutate) and carry ``fail_open_slices``
    so the breaker decorator can scope the failure to this slice.
    """

    def __init__(self, inner, index: int, manager: QuarantineManager, *,
                 deadline: float = 0.25):
        super().__init__(inner)
        self.slice_index = int(index)
        self._mgr = manager
        self._deadline = float(deadline)
        #: Warm gate: until the slice's FIRST successful dispatch, the
        #: deadline stretches to cover first-use costs (the kernels'
        #: build and load; a cold start is not a device fault).
        self._warm = False
        self._cold_deadline = max(self._deadline, 30.0)
        self._pool: Optional[_DaemonExecutor] = None
        self._pool_lock = threading.Lock()
        manager.register(self.slice_index, self)

    # ------------------------------------------------------------ plumbing

    def _executor(self) -> _DaemonExecutor:
        # One worker: resolves stay FIFO per slice (launch order ==
        # resolve order, the pipelined state-threading contract), and an
        # orphaned (timed-out) resolve naturally blocks later work on
        # this slice — which is exactly the degraded answer path. The
        # worker is a DAEMON: a dispatch wedged forever must not hang
        # interpreter shutdown.
        with self._pool_lock:
            if self._pool is None:
                self._pool = _DaemonExecutor(
                    f"rl-slice{self.slice_index}")
            return self._pool

    def _degraded(self, b: int, now: float, cause: str, *,
                  scalar: bool = False):
        """Answer ``b`` decisions per policy: fail-open -> allowed rows
        stamped fail_open with the live limit/window; fail-closed ->
        typed StorageUnavailableError carrying ``slice_index`` (the
        breaker-scoping attribution, satellite 1)."""
        self._mgr.note_degraded(self.slice_index, b)
        cfg = self.inner.config
        if not cfg.fail_open:
            exc = StorageUnavailableError(
                f"slice {self.slice_index} unavailable ({cause}); its key "
                f"range fails closed per config")
            exc.slice_index = self.slice_index
            raise exc
        reset_at = now + float(cfg.window)
        if scalar:
            res = fail_open_result(cfg.limit, reset_at)
            # Result is frozen; the attribution riding along is what
            # keeps the scalar lane from tripping the whole-keyspace
            # breaker (same contract as the batch lanes).
            object.__setattr__(res, "fail_open_slices",
                               [self.slice_index])
            return res
        out = batch_fail_open(b, cfg.limit, reset_at)
        out.fail_open_slices = [self.slice_index]
        return out

    def _note_exc(self, exc: BaseException, now: float) -> bool:
        """Classify + record; True iff this was a backend fault (the
        caller then answers degraded)."""
        if not classify_failure(exc):
            return False
        self._mgr.note_failure(self.slice_index, exc, now)
        if getattr(exc, "slice_index", None) is None:
            try:
                exc.slice_index = self.slice_index
            except Exception:  # noqa: BLE001 — attribution best-effort
                pass
        return True

    def _chaos_launch(self) -> None:
        from ratelimiter_tpu_torch import chaos

        if chaos.INJECTOR is not None:
            chaos.INJECTOR.slice_launch(self.slice_index)

    def _chaos_resolve(self) -> None:
        from ratelimiter_tpu_torch import chaos

        if chaos.INJECTOR is not None:
            chaos.INJECTOR.slice_resolve(self.slice_index)

    # ----------------------------------------------------- guarded launch

    def _guard_launch(self, fn, b: int):
        now = self.inner.clock.now()
        if not self._mgr.admit(self.slice_index, now):
            return DispatchTicket(
                result=self._degraded(b, now, "quarantined"))
        try:
            self._chaos_launch()
            return fn()
        except Exception as exc:
            if self._note_exc(exc, now):
                return DispatchTicket(
                    result=self._degraded(b, now, f"launch failed: {exc}"))
            raise

    def launch_hashed(self, h64, ns=None, *, now=None):
        return self._guard_launch(
            lambda: self.inner.launch_hashed(h64, ns, now=now), len(h64))

    def launch_ids(self, ids, ns=None, *, now=None, wire: bool = False):
        return self._guard_launch(
            lambda: self.inner.launch_ids(ids, ns, now=now, wire=wire),
            len(ids))

    def launch_batch(self, keys, ns=None, *, now=None):
        return self._guard_launch(
            lambda: self.inner.launch_batch(keys, ns, now=now), len(keys))

    # ---------------------------------------------------- guarded resolve

    def _eff_deadline(self) -> float:
        return self._deadline if self._warm else self._cold_deadline

    def _resolve_inner(self, ticket):
        self._chaos_resolve()
        return self.inner.resolve(ticket)

    def resolve(self, ticket):
        if ticket.result is not None:
            return ticket.result
        b = int(getattr(ticket, "b", 0))
        now = self.inner.clock.now()
        fut = self._executor().submit(self._resolve_inner, ticket)
        try:
            out = fut.result(timeout=self._eff_deadline())
        except concurrent.futures.TimeoutError:
            # The dispatch keeps running (the worker thread is stuck in
            # it); its eventual outcome is swallowed — the range was
            # already answered per policy, and a later success must not
            # double-answer. Quarantine + probe own recovery.
            fut.add_done_callback(lambda f: f.exception())
            exc = DeadlineExceededError(
                f"slice {self.slice_index} resolve exceeded the "
                f"{self._eff_deadline():g}s per-slice deadline")
            self._note_exc(exc, now)
            return self._degraded(b, now, "deadline exceeded")
        except Exception as exc:
            if self._note_exc(exc, now):
                return self._degraded(b, now, f"resolve failed: {exc}")
            raise
        self._warm = True
        self._mgr.note_success(self.slice_index)
        return out

    # ------------------------------------------------- guarded sync decide

    def _sync_inner(self, fn):
        self._chaos_launch()
        self._chaos_resolve()
        return fn()

    def _guard_sync(self, fn, b: int, *, scalar: bool = False):
        now = self.inner.clock.now()
        if not self._mgr.admit(self.slice_index, now):
            return self._degraded(b, now, "quarantined", scalar=scalar)
        fut = self._executor().submit(self._sync_inner, fn)
        try:
            out = fut.result(timeout=self._eff_deadline())
        except concurrent.futures.TimeoutError:
            fut.add_done_callback(lambda f: f.exception())
            exc = DeadlineExceededError(
                f"slice {self.slice_index} decide exceeded the "
                f"{self._eff_deadline():g}s per-slice deadline")
            self._note_exc(exc, now)
            return self._degraded(b, now, "deadline exceeded",
                                  scalar=scalar)
        except Exception as exc:
            if self._note_exc(exc, now):
                return self._degraded(b, now, f"decide failed: {exc}",
                                      scalar=scalar)
            raise
        self._warm = True
        self._mgr.note_success(self.slice_index)
        return out

    def allow_n(self, key, n, *, now=None):
        return self._guard_sync(
            lambda: self.inner.allow_n(key, n, now=now), 1, scalar=True)

    def allow_batch(self, keys, ns=None, *, now=None):
        return self._guard_sync(
            lambda: self.inner.allow_batch(keys, ns, now=now), len(keys))

    def allow_hashed(self, h64, ns=None, *, now=None):
        return self._guard_sync(
            lambda: self.inner.allow_hashed(h64, ns, now=now), len(h64))

    def allow_ids(self, ids, ns=None, *, now=None):
        return self._guard_sync(
            lambda: self.inner.allow_ids(ids, ns, now=now), len(ids))

    # -------------------------------------------------------------- probe

    def probe(self) -> None:
        """Half-open probe: one reserved-hash unit decision against the
        inner slice, bounded by the slice deadline (a still-wedged
        device times out here, never in client traffic). Raises on any
        fault — the manager re-opens."""
        def _p():
            self._chaos_launch()
            self._chaos_resolve()
            return self.inner.allow_hashed(
                np.asarray([PROBE_HASH], dtype=np.uint64),
                now=self.inner.clock.now())

        fut = self._executor().submit(_p)
        try:
            fut.result(timeout=self._eff_deadline())
        except concurrent.futures.TimeoutError:
            fut.add_done_callback(lambda f: f.exception())
            raise DeadlineExceededError(
                f"slice {self.slice_index} probe exceeded the "
                f"{self._eff_deadline():g}s deadline") from None

    # ------------------------------------------------------ config changes

    def update_limit(self, new_limit: int) -> None:
        # A config change swaps the slice's steps — re-open the
        # cold-deadline allowance, as the JAX guard does after its
        # recompile, so a first-use cost is not classified as a fault.
        self.inner.update_limit(new_limit)
        self._warm = False

    def update_window(self, new_window: float) -> None:
        self.inner.update_window(new_window)
        self._warm = False

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        super().close()
        with self._pool_lock:
            pool = self._pool
            self._pool = None
        if pool is not None:
            pool.shutdown()
