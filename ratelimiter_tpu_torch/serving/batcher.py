"""Micro-batching dispatcher: many concurrent requests -> one device call.

A copy of ``ratelimiter_tpu/serving/batcher.py``, trimmed to the port's
door: the front door coalesces every request that arrives within
``max_delay`` (or until ``max_batch`` is reached) into ONE launch of the
limiter's step, whose in-batch admission gives exactly the serialized
semantics of one decision after another.

Policy knobs:

* dispatch failure: handled inside the limiter (fail-open allowance or
  StorageUnavailableError per Config.fail_open);
* SLO breach (``dispatch_timeout``): if one dispatch takes longer than the
  timeout, waiting requests stop waiting — fail-open configs answer
  "allowed (fail_open)" at once, fail-closed configs get
  StorageUnavailableError. The device call is not cancelled: its state
  update still lands, and the batcher keeps serving.

Thread model: the event loop owns the queues; a single-threaded *launch*
executor runs the non-blocking half of each dispatch (stage the batch and
enqueue the step on the device's current stream, the limiter's
``launch_*``) and a single-threaded *resolve* executor blocks on the
oldest in-flight result, so up to ``inflight`` dispatches overlap on the
device while the loop keeps coalescing. Every thread enqueues on the
device's default stream, so the state updates run in launch order.
Backends without a pipelined path, or a batcher with ``dispatch_timeout``
set, decide each window synchronously on one executor.

Coalescing is queue-depth-aware: ``max_delay`` is the idle coalescing
window; as the pending queue fills toward ``max_batch`` the flush timer is
pulled earlier, so a deep queue never waits the full delay for a batch it
could fill at once.

Deadline shedding: a decision whose propagated deadline (the frame's
deadline extension, anchored to its arrival) has expired is answered at
once per the fail-open/closed policy (a fail-open allowance, or
DeadlineExceededError), at submit or when its window dispatches, and
never joins a launch; ``rate_limiter_server_deadline_shed_total`` counts
those decisions.

Flight recorder (observability/tracing.py; off unless enabled, and then
one None check per operation): each coalescing window records its
``coalesce`` residency, a multi-frame hashed window its ``route``
assembly, each dispatch its ``queue`` wait for the launch thread and
window slot, its ``launch``, its ``device`` wait on the ticket and its
``resolve`` tail, under the window's first sampled trace id, which is
also the thread's current trace id around launch.

Audit tap (observability/audit.py; off unless an auditor is enabled,
and then one None check per resolved window): each window's decisions
are offered to the shadow auditor with the launch-time ``now`` its step
decided with (``ticket.t_sec``; the clock at dispatch entry on a
non-pipelined batcher), hashed windows as raw ids, string windows as
keys. A window the SLO answered is still tapped once its shielded launch
lands, so the shadow timelines keep the mass it consumed.

The fleet's lanes, as in the JAX batcher: hashed frames carrying the
forward hint (a peer's coalesced forward window, ``standalone=True``)
coalesce in their own buffer and launch apart from client windows, since
a client window may hold rows whose resolve waits on this host's own
forward legs to that peer; and a fleet ticket (forward legs pending,
``ticket.jobs``) resolves on a side pool, giving its in-flight slot back
first, so that two members never block their FIFO resolve threads on
each other.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ratelimiter_tpu_torch.algorithms.base import (
    RateLimiter,
    check_key,
    check_n,
)
from ratelimiter_tpu_torch.core.errors import (
    DeadlineExceededError,
    InvalidConfigError,
    InvalidNError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    BatchResult,
    batch_fail_open,
    fail_open_result,
)
from ratelimiter_tpu_torch.observability import audit
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.observability.decorators import undecorated


def _tap_late(work, offer: str, data, ns, t_sec: float) -> None:
    """A window the SLO answered still consumes its sketch mass when its
    shielded launch lands: offer that result to the auditor then (by its
    ``offer`` method), stamped ``t_sec``, so audited keys' shadow
    timelines keep no holes that would read as false denies later."""
    def tap(f) -> None:
        if f.cancelled() or f.exception() is not None:
            return
        aud = audit.AUDITOR
        if aud is not None:
            getattr(aud, offer)(data, ns, t_sec, f.result())

    work.add_done_callback(tap)


class MicroBatcher:
    """Coalesce concurrent allow/allow_n calls into batched dispatches.

    Args:
        limiter: a RateLimiter (the sketch limiters pipeline).
        max_batch: flush as soon as this many requests are pending.
        max_delay: flush this many seconds after the first pending request
            (the latency the batcher may add to coalesce; default 200 µs).
            This is the idle window: a queue filling toward max_batch
            flushes proportionally sooner.
        dispatch_timeout: SLO for one dispatch, seconds; None disables.
        inflight: launched-but-unresolved dispatch window for pipelined
            backends; launches past the window block in the launch
            executor (backpressure). 1 disables overlap.
        registry: metrics registry for queue/batch/SLO gauges.
        max_window: the most rows one hashed window merges (default
            ``2*max_batch``); a lone frame above it is split into
            segments of at most ``min(max_batch, max_window)`` rows.
    """

    def __init__(self, limiter: RateLimiter, *, max_batch: int = 4096,
                 max_delay: float = 200e-6,
                 dispatch_timeout: Optional[float] = None,
                 inflight: int = 8,
                 registry: Optional[m.Registry] = None,
                 max_window: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_window is None:
            max_window = 2 * max_batch
        if max_window < 1:
            raise ValueError(f"max_window must be >= 1, got {max_window}")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self.limiter = limiter
        self.max_batch = max_batch
        self.max_window = max_window
        self.max_delay = max_delay
        self.dispatch_timeout = dispatch_timeout
        self.inflight = inflight
        #: Queued string decisions, (key, n, future, deadline) each.
        self._pending: List[Tuple[str, int, asyncio.Future, float]] = []
        #: Queued ALLOW_HASHED frames awaiting the next coalescing window,
        #: (ids, ns, future, trace_id, deadline) each: flushed beside the
        #: string queue into one launch per window, each frame answered
        #: from its contiguous row range.
        self._pending_hashed: List[tuple] = []
        self._pending_hashed_ids = 0
        #: Fleet forward-lane windows (protocol.FORWARD_FLAG), same
        #: tuples: coalesced with each other, never with client rows.
        self._pending_fwd: List[tuple] = []
        self._pending_fwd_ids = 0
        #: Flight-recorder window context: first-enqueue stamp and the
        #: first sampled trace id of the current coalescing window (zero
        #: cost while tracing is off).
        self._q_t0 = 0
        self._q_trace = 0
        self._timer: Optional[asyncio.TimerHandle] = None
        self._first_ts = 0.0
        self._armed_depth = 0
        #: Re-arm points for the adaptive timer (re-arming per submit would
        #: churn call_later on the hot loop). Crossing detection, not
        #: equality: batch frames jump the depth by whole frames.
        self._adaptive_marks = sorted(
            {d for d in (max_batch // 8, max_batch // 4, max_batch // 2,
                         (3 * max_batch) // 4) if d >= 2})
        # Pipelining and the dispatch SLO are mutually exclusive: the SLO
        # promises that waiters are answered by the deadline even when the
        # device hangs, and a launch blocked on a full in-flight window
        # sits outside any wait_for.
        self._pipelined = bool(getattr(limiter, "pipelined", False)
                               and inflight > 1
                               and dispatch_timeout is None)
        # Lane support is a property of the BACKEND, not of the decorator
        # stack (decorators delegate the whole raw-id surface, so a
        # hasattr on the decorated limiter is always true).
        self._hashed_lane = hasattr(undecorated(limiter), "allow_ids")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rl-dispatch")
        if self._pipelined:
            # Separate single-thread stages keep launch order == resolve
            # order (both executors are FIFO) while batch k's blocking
            # resolve overlaps batch k+1's launch.
            self._resolve_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rl-resolve")
            self._window = threading.Semaphore(inflight)
        else:
            self._resolve_pool = None
            self._window = None
        #: Side pool for fleet tickets, built on first use: a frame whose
        #: resolve waits on a peer's answer may not occupy the FIFO
        #: resolve thread, where forwarded frames from that same peer
        #: resolve (two members blocking on each other is a distributed
        #: deadlock), and gives its in-flight slot back before the wait.
        self._fleet_pool: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._inflight: set = set()
        self._draining = False
        self.decisions_total = 0

        reg = registry if registry is not None else m.DEFAULT
        self._queue_depth = reg.gauge(
            "rate_limiter_server_queue_depth",
            "Requests waiting for the next batched dispatch")
        self._dispatch_batch = reg.histogram(
            "rate_limiter_server_batch_size",
            "Requests per batched dispatch", m.BATCH_BUCKETS)
        self._dispatch_latency = reg.histogram(
            "rate_limiter_server_dispatch_seconds",
            "Wall time of one batched device dispatch", m.LATENCY_BUCKETS)
        self._slo_breaches = reg.counter(
            "rate_limiter_server_slo_breaches_total",
            "Dispatches that exceeded dispatch_timeout")
        self._slo_breach_decisions = reg.counter(
            "rate_limiter_server_slo_breach_decisions_total",
            "Decisions answered by SLO-breach policy (fail-open/closed) "
            "instead of a device result")
        self._deadline_shed = reg.counter(
            "rate_limiter_server_deadline_shed_total",
            "Decisions shed because their propagated deadline expired "
            "before dispatch (answered per fail-open/closed, ADR-015)")
        self._inflight_gauge = reg.gauge(
            "rate_limiter_pipeline_inflight",
            "Launched device dispatches not yet resolved")
        self._launch_hist = reg.histogram(
            "rate_limiter_pipeline_launch_seconds",
            "Launch phase wall time (stage + enqueue, non-blocking)",
            m.LATENCY_BUCKETS)
        self._resolve_hist = reg.histogram(
            "rate_limiter_pipeline_resolve_seconds",
            "Resolve phase wall time (block on the oldest in-flight "
            "result + host conversion)", m.LATENCY_BUCKETS)

    def _depth_add(self, d: int) -> None:
        with self._depth_lock:
            self._depth += d
            self._inflight_gauge.set(float(self._depth))

    def _spawn(self, coro) -> None:
        """Run ``coro`` as a task that ``drain`` waits for."""
        task = asyncio.ensure_future(coro)
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    # ------------------------------------------------------------ submit

    def _note_window(self, trace_id: int) -> None:
        """Window trace context: stamp the first-enqueue time once per
        coalescing window and keep the first sampled trace id."""
        if tracing.RECORDER is not None and not self._q_t0:
            self._q_t0 = tracing.now()
        if trace_id and not self._q_trace:
            self._q_trace = trace_id

    def _enqueue(self, loop: asyncio.AbstractEventLoop, key: str,
                 n: int, trace_id: int = 0,
                 deadline: float = 0.0) -> asyncio.Future:
        fut: asyncio.Future = loop.create_future()
        self._pending.append((key, n, fut, deadline))
        self._note_window(trace_id)
        if len(self._pending) >= self.max_batch:
            self._flush()
        return fut

    # -------------------------------------------------- deadline shedding

    def _shed_frame(self, fut: asyncio.Future, b: int) -> None:
        """Answer one whole hashed frame (``b`` decisions) whose
        propagated deadline expired before dispatch, per the
        fail-open/closed policy: nobody is waiting for the real answer,
        so no dispatch slot is spent on it."""
        self._deadline_shed.inc(b)
        cfg = self.limiter.config
        if fut.done():
            return
        if cfg.fail_open:
            reset_at = self.limiter.clock.now() + float(cfg.window)
            fut.set_result(batch_fail_open(b, cfg.limit, reset_at))
        else:
            fut.set_exception(DeadlineExceededError(
                "request deadline expired before dispatch"))

    def _shed_scalar(self, fut: asyncio.Future) -> None:
        """The string lane's form of deadline shedding."""
        self._deadline_shed.inc()
        cfg = self.limiter.config
        if fut.done():
            return
        if cfg.fail_open:
            fut.set_result(fail_open_result(
                cfg.limit, self.limiter.clock.now() + float(cfg.window)))
        else:
            fut.set_exception(DeadlineExceededError(
                "request deadline expired before dispatch"))

    def _arm_timer(self, loop: asyncio.AbstractEventLoop) -> None:
        # Queue depth counts both lanes: pending string decisions plus
        # queued hashed-frame ids.
        depth = (len(self._pending) + self._pending_hashed_ids
                 + self._pending_fwd_ids)
        self._queue_depth.set(depth)
        if not depth:
            return
        if self._timer is None:
            self._first_ts = loop.time()
            self._armed_depth = depth
            delay = self.max_delay
            if depth > 1:
                # A whole frame landing on an idle queue arms directly at
                # its depth-scaled delay — the re-arm path's curve.
                delay = self.max_delay * max(0.0,
                                             1.0 - depth / self.max_batch)
            self._timer = loop.call_later(delay, self._flush)
        elif any(
                self._armed_depth < mk <= depth
                for mk in self._adaptive_marks):
            # At depth d the wait shrinks to max_delay * (1 - d/max_batch)
            # from the first pending request.
            target = (self._first_ts
                      + self.max_delay * (1.0 - depth / self.max_batch))
            self._armed_depth = depth
            self._timer.cancel()
            self._timer = loop.call_later(max(0.0, target - loop.time()),
                                          self._flush)

    def submit_nowait(self, key: str, n: int = 1, trace_id: int = 0,
                      deadline: float = 0.0) -> asyncio.Future:
        """Queue one decision and return its future without awaiting: the
        door's zero-task path (a done callback writes the response).
        Validation happens here, before batching, so a malformed request
        fails fast and never poisons a batch. Must run on the event loop
        thread. ``trace_id`` samples the window this decision joins into
        the flight recorder. ``deadline`` (absolute ``time.monotonic``
        seconds; 0 = none): a decision whose deadline has passed is shed
        (answered per policy) here or when its window dispatches."""
        if self._draining:
            raise StorageUnavailableError("server is shutting down")
        check_key(key)
        check_n(n)
        loop = asyncio.get_running_loop()
        if deadline and time.monotonic() >= deadline:
            fut: asyncio.Future = loop.create_future()
            self._shed_scalar(fut)
            return fut
        fut = self._enqueue(loop, key, n, trace_id, deadline)
        self._arm_timer(loop)
        return fut

    def submit_many_nowait(self, pairs, trace_id: int = 0,
                           deadline: float = 0.0) -> List[asyncio.Future]:
        """Queue a whole frame of (key, n) decisions atomically: every pair
        is validated before any is queued, so a bad pair mid-frame cannot
        leave earlier pairs consuming quota with nobody reading their
        futures. Must run on the event loop thread."""
        pairs = list(pairs)
        if self._draining:
            raise StorageUnavailableError("server is shutting down")
        for key, n in pairs:
            check_key(key)
            check_n(n)
        loop = asyncio.get_running_loop()
        if deadline and time.monotonic() >= deadline:
            futs = [loop.create_future() for _ in pairs]
            for f in futs:
                self._shed_scalar(f)
            return futs
        futs = [self._enqueue(loop, key, n, trace_id, deadline)
                for key, n in pairs]
        self._arm_timer(loop)
        return futs

    async def submit(self, key: str, n: int = 1, *,
                     trace_id: int = 0, deadline: float = 0.0):
        """Queue one decision; resolves when its window's dispatch lands
        (the coroutine the thread-safe bridge of the HTTP gateway runs
        on the loop)."""
        return await self.submit_nowait(key, n, trace_id, deadline)

    # ------------------------------------------------- hashed bulk lane

    def submit_hashed_nowait(self, ids: np.ndarray, ns: np.ndarray,
                             trace_id: int = 0,
                             deadline: float = 0.0, *,
                             standalone: bool = False) -> asyncio.Future:
        """Queue one whole ALLOW_HASHED frame into the current coalescing
        window: every hashed frame queued within ``max_delay`` merges into
        one ``launch_ids`` dispatch of at most ``max_window`` rows, and
        each frame's future resolves to its contiguous row range of the
        window's BatchResult (``BatchResult.rows``; wire buffers ride
        along). Shares the launch/resolve executors and in-flight window
        with the string lane. Must run on the event loop thread; needs a
        limiter with the raw-id lane (the sketch limiters). ``trace_id``
        and ``deadline`` as in ``submit_nowait``: an expired frame is
        shed whole. ``standalone`` marks a fleet forward window (the
        forward hint): it coalesces only with other forward windows."""
        if self._draining:
            raise StorageUnavailableError("server is shutting down")
        if not self._hashed_lane:
            raise InvalidConfigError(
                "the hashed bulk lane requires a sketch-family backend "
                "(raw-id decisions need device-side hashing)")
        if ids.shape[0] and int(ns.min()) <= 0:
            raise InvalidNError("n must be a positive integer")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if deadline and ids.shape[0] and time.monotonic() >= deadline:
            # Already expired at parse: answer per policy now.
            self._shed_frame(fut, int(ids.shape[0]))
            return fut
        if not ids.shape[0]:
            # count == 0 frames are valid (empty RESULT_HASHED), no
            # dispatch needed.
            fut.set_result(BatchResult(
                allowed=np.zeros(0, dtype=bool),
                limit=self.limiter.config.limit,
                remaining=np.zeros(0, dtype=np.int64),
                retry_after=np.zeros(0, dtype=np.float64),
                reset_at=np.zeros(0, dtype=np.float64)))
            return fut
        b = int(ids.shape[0])
        if b > self.max_window:
            # A lone frame larger than any window: flush the pending
            # window (arrival order across dispatches), dispatch
            # segments of at most max_batch (and max_window) rows in
            # order through the same FIFO executors
            # (same-key sequencing across segments is sequential-dispatch
            # order), and join them on the host. The joined result
            # carries no device-packed buffers, so the encoder packs the
            # mask itself.
            if self._pending_hashed or self._pending_fwd:
                self._flush()
            seg_futs: List[asyncio.Future] = []
            seg = min(self.max_batch, self.max_window)
            for off in range(0, b, seg):
                sfut: asyncio.Future = loop.create_future()
                seg_futs.append(sfut)
                self._spawn(self._dispatch_hashed(
                    ids[off:off + seg], ns[off:off + seg], sfut, trace_id))
            self._spawn(self._join_segments(seg_futs, fut))
            return fut
        if standalone:
            # A peer's forward window holds only rows this host owns;
            # coalescing it with a client window that waits on this
            # host's own forward legs would chain the reply to windows
            # formed later (the JAX package's FLEET_r01 mixed p99).
            if (self._pending_fwd
                    and self._pending_fwd_ids + b > self.max_window):
                self._flush_fwd()
            self._pending_fwd.append((ids, ns, fut, trace_id, deadline))
            self._pending_fwd_ids += b
            if self._pending_fwd_ids >= self.max_batch:
                self._flush_fwd()
            else:
                self._arm_timer(loop)
            return fut
        if (self._pending_hashed
                and self._pending_hashed_ids + b > self.max_window):
            # Coalescing never builds a window larger than max_window:
            # flush the current window first; this frame then opens the
            # next one (arrival order across dispatches is kept).
            self._flush()
        self._pending_hashed.append((ids, ns, fut, trace_id, deadline))
        self._pending_hashed_ids += b
        self._note_window(trace_id)
        if self._pending_hashed_ids >= self.max_batch:
            self._flush()
        else:
            self._arm_timer(loop)
        return fut

    def _launch_hashed_work(self, ids, ns, trace_id=0, t_q=0):
        """Hashed-window launch stage (launch executor thread): the same
        in-flight window as _launch_work; wire=True packs the response
        buffers on the device (sketch_kernels.pack_wire)."""
        return self._launch_traced(
            lambda: self.limiter.launch_ids(ids, ns, wire=True),
            int(ids.shape[0]), trace_id, t_q)

    def _launch_traced(self, launch, b: int, trace_id: int, t_q: int):
        """Acquire an in-flight slot — blocking here is the pipeline's
        backpressure, it stalls later launches, never the event loop —
        then run ``launch`` (stage and enqueue, no wait on the device).
        With the recorder on: the thread's current trace id around the
        launch, and the ``queue`` (launch thread and slot wait) and
        ``launch`` spans."""
        self._window.acquire()
        rec = tracing.RECORDER
        tq0 = tracing.now() if rec is not None else 0
        t0 = time.perf_counter()
        if rec is not None:
            tracing.set_current(trace_id)
        try:
            ticket = launch()
        except BaseException:
            self._window.release()
            raise
        finally:
            if rec is not None:
                tracing.set_current(0)
        self._launch_hist.observe(time.perf_counter() - t0)
        if rec is not None:
            if t_q:
                rec.record("queue", t_q, tq0, trace_id=trace_id, batch=b)
            rec.record("launch", tq0, tracing.now(), trace_id=trace_id,
                       batch=b)
        ticket.trace_id = trace_id
        self._depth_add(1)
        return ticket

    def _allow_work(self, keys, ns, trace_id=0, hashed=False):
        """Blocking decide (non-pipelined batchers): one "device" span
        covers the whole synchronous dispatch."""
        rec = tracing.RECORDER
        t0 = tracing.now() if rec is not None else 0
        if rec is not None:
            tracing.set_current(trace_id)
        try:
            out = (self.limiter.allow_ids(keys, ns) if hashed
                   else self.limiter.allow_batch(keys, ns))
        finally:
            if rec is not None:
                tracing.set_current(0)
        if rec is not None:
            rec.record("device", t0, tracing.now(), trace_id=trace_id,
                       batch=len(out),
                       outcome=tracing.FAIL_OPEN if out.fail_open
                       else tracing.OK)
        return out

    async def _await_dispatch(self, work, decisions: int, t0: float):
        """Await one dispatch's result under the SLO. Returns ``(out,
        timed_out)``; on a breach the counters are bumped and ``out`` is
        None. The dispatch's wall time counts from ``t0``, before its
        launch."""
        try:
            if self.dispatch_timeout is not None:
                return await asyncio.wait_for(asyncio.shield(work),
                                              self.dispatch_timeout), False
            return await work, False
        except asyncio.TimeoutError:
            self._slo_breaches.inc()
            self._slo_breach_decisions.inc(decisions)
            # The shielded call still lands and consumes the window's
            # sketch mass; read its outcome so an error is not left
            # unretrieved.
            work.add_done_callback(lambda f: f.cancelled() or f.exception())
            return None, True
        finally:
            self._dispatch_latency.observe(time.perf_counter() - t0)

    def _breach_error(self) -> StorageUnavailableError:
        return StorageUnavailableError(
            f"dispatch exceeded SLO ({self.dispatch_timeout * 1e3:.1f} ms)")

    async def _dispatch_hashed(self, ids, ns, fut: asyncio.Future,
                               trace_id: int = 0) -> None:
        b = int(ids.shape[0])
        self._dispatch_batch.observe(float(b))
        loop = asyncio.get_running_loop()
        t_q = tracing.now() if tracing.RECORDER is not None else 0
        # Audit timestamp fallback, taken at dispatch entry (a pipelined
        # ticket's launch-time t_sec is preferred below).
        t_tap = (self.limiter.clock.now() if audit.AUDITOR is not None
                 else 0.0)
        ticket = None
        t0 = time.perf_counter()
        if self._pipelined and self._hashed_lane:
            try:
                ticket = await loop.run_in_executor(
                    self._pool, self._launch_hashed_work, ids, ns,
                    trace_id, t_q)
            except Exception as exc:
                if not fut.done():
                    fut.set_exception(exc)
                return
            work = self._resolve_target(loop, ticket)
        else:
            work = loop.run_in_executor(
                self._pool,
                lambda: self._allow_work(ids, ns, trace_id, hashed=True))
        try:
            out, timed_out = await self._await_dispatch(work, b, t0)
        except Exception as exc:
            if not fut.done():
                fut.set_exception(exc)
            return
        t_dec = getattr(ticket, "t_sec", 0.0) or t_tap
        if timed_out:
            # SLO breach: answer now per fail-open/closed.
            cfg = self.limiter.config
            if cfg.fail_open:
                reset_at = self.limiter.clock.now() + float(cfg.window)
                if not fut.done():
                    fut.set_result(batch_fail_open(b, cfg.limit, reset_at))
                self.decisions_total += b
            elif not fut.done():
                fut.set_exception(self._breach_error())
            _tap_late(work, "offer_ids", ids, ns, t_dec)
            return
        self.decisions_total += b
        # Live accuracy tap: one None check when auditing is off, one
        # bounded-queue append of the window's arrays when on (sampling
        # and hashing run on the audit worker).
        aud = audit.AUDITOR
        if aud is not None:
            aud.offer_ids(ids, ns, t_dec, out)
        if not fut.done():
            fut.set_result(out)

    async def _join_segments(self, seg_futs: List[asyncio.Future],
                             fut: asyncio.Future) -> None:
        """Reassemble a cut oversized hashed frame: await every segment
        and answer the frame with the host-side concatenation. Any
        segment error fails the whole frame (a partial answer would
        mis-align the columnar reply); ``fail_open`` ORs over segments
        and per-request ``limits`` materialize wherever any segment
        carried overrides."""
        outs = await asyncio.gather(*seg_futs, return_exceptions=True)
        exc = next((o for o in outs if isinstance(o, BaseException)), None)
        if exc is not None:
            if not fut.done():
                fut.set_exception(exc)
            return
        merged = BatchResult(
            allowed=np.concatenate([o.allowed for o in outs]),
            limit=outs[0].limit,
            remaining=np.concatenate([o.remaining for o in outs]),
            retry_after=np.concatenate([o.retry_after for o in outs]),
            reset_at=np.concatenate([o.reset_at for o in outs]),
            fail_open=any(o.fail_open for o in outs),
            limits=(np.concatenate(
                [o.limits if o.limits is not None
                 else np.full(len(o), o.limit, dtype=np.int64)
                 for o in outs])
                if any(o.limits is not None for o in outs) else None))
        if not fut.done():
            fut.set_result(merged)

    async def _dispatch_hashed_window(self, frames) -> None:
        """Dispatch one coalescing window of hashed frames: a one-frame
        window is the frame as its batch; a multi-frame window
        concatenates in arrival order (same-key sequencing across a
        connection's back-to-back frames is kept: in-batch admission
        decides duplicates as sequential dispatches would), launches
        once, and answers each frame from its row range of the window's
        result (BatchResult.rows). Frames whose deadline expired while
        they waited in the window are shed here and join no launch."""
        now_mono = time.monotonic()
        if any(f[4] and now_mono >= f[4] for f in frames):
            for fids, _, fut, _, dl in frames:
                if dl and now_mono >= dl:
                    self._shed_frame(fut, int(fids.shape[0]))
            frames = [f for f in frames if not (f[4] and now_mono >= f[4])]
            if not frames:
                return
        if len(frames) == 1:
            ids, ns, fut, tid, _ = frames[0]
            await self._dispatch_hashed(ids, ns, fut, tid)
            return
        rec = tracing.RECORDER
        tid = next((f[3] for f in frames if f[3]), 0)
        t_r0 = tracing.now() if rec is not None else 0
        ids = np.concatenate([f[0] for f in frames])
        ns = np.concatenate([f[1] for f in frames])
        if rec is not None:
            # "route": window assembly (frame concatenation in arrival
            # order).
            rec.record("route", t_r0, tracing.now(), trace_id=tid,
                       batch=int(ids.shape[0]))
        win: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._dispatch_hashed(ids, ns, win, tid)
        exc = win.exception()
        if exc is not None:
            for _, _, fut, _, _ in frames:
                if not fut.done():
                    fut.set_exception(exc)
            return
        out = win.result()
        off = 0
        for fids, _, fut, _, _ in frames:
            k = int(fids.shape[0])
            if not fut.done():
                fut.set_result(out.rows(off, k))
            off += k

    # ------------------------------------------------------------- flush

    def _flush_fwd(self) -> None:
        """Dispatch the coalesced forward-lane windows as their own
        launch, never merged with the client lanes."""
        if not self._pending_fwd:
            return
        frames = self._pending_fwd
        self._pending_fwd = []
        self._pending_fwd_ids = 0
        self._spawn(self._dispatch_hashed_window(frames))

    def _flush(self) -> None:
        """Dispatch what is queued: the string window is launched before
        the hashed window (the order the state sees them in), then the
        forward window."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if (not self._pending and not self._pending_hashed
                and not self._pending_fwd):
            return
        self._queue_depth.set(0)
        rec = tracing.RECORDER
        trace = self._q_trace
        if rec is not None and self._q_t0:
            # "coalesce": the window's residency, first enqueue to flush,
            # in max_batch units across both lanes.
            rec.record("coalesce", self._q_t0, tracing.now(),
                       trace_id=trace,
                       batch=(len(self._pending) + self._pending_hashed_ids
                              + self._pending_fwd_ids))
        self._q_t0 = 0
        self._q_trace = 0
        if self._pending:
            batch = self._pending
            self._pending = []
            self._spawn(self._dispatch(batch, trace))
        if self._pending_hashed:
            frames = self._pending_hashed
            self._pending_hashed = []
            self._pending_hashed_ids = 0
            self._spawn(self._dispatch_hashed_window(frames))
        self._flush_fwd()

    def _launch_work(self, keys, ns, trace_id=0, t_q=0):
        """Launch stage (launch executor thread), as _launch_traced."""
        return self._launch_traced(
            lambda: self.limiter.launch_batch(keys, ns), len(keys),
            trace_id, t_q)

    def _resolve_target(self, loop, ticket):
        """Schedule one ticket's resolve: plain tickets on the FIFO
        resolve thread; fleet tickets (forward legs pending,
        ``ticket.jobs``) on the side pool, their window slot given back
        now (``_fleet_pool`` above)."""
        if getattr(ticket, "jobs", None):
            if self._fleet_pool is None:
                self._fleet_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="rl-fleet-merge")
            self._window.release()
            self._depth_add(-1)
            return loop.run_in_executor(
                self._fleet_pool,
                lambda: self._resolve_work(ticket, release=False))
        return loop.run_in_executor(self._resolve_pool,
                                    self._resolve_work, ticket)

    def _resolve_work(self, ticket, release: bool = True):
        rec = tracing.RECORDER
        tn0 = tracing.now() if rec is not None else 0
        t0 = time.perf_counter()
        try:
            out = self.limiter.resolve(ticket)
            if rec is not None:
                tn1 = tracing.now()
                tid = getattr(ticket, "trace_id", 0)
                # "device": the blocking wait on the oldest in-flight
                # dispatch; "resolve": the host bookkeeping tail.
                rec.record("device", tn0, tn1, trace_id=tid,
                           batch=len(out),
                           outcome=tracing.FAIL_OPEN if out.fail_open
                           else tracing.OK)
                rec.record("resolve", tn1, tracing.now(), trace_id=tid,
                           batch=len(out))
            return out
        except Exception:
            if rec is not None:
                rec.record("device", tn0, tracing.now(),
                           trace_id=getattr(ticket, "trace_id", 0),
                           outcome=tracing.ERROR)
            raise
        finally:
            if release:
                self._window.release()
                self._depth_add(-1)
            self._resolve_hist.observe(time.perf_counter() - t0)

    async def _dispatch(self, batch, trace_id: int = 0) -> None:
        # Deadline shedding at the dispatch boundary: entries whose
        # deadline expired while coalescing are answered per policy here
        # and left out of the launch.
        now_mono = time.monotonic()
        if any(e[3] and now_mono >= e[3] for e in batch):
            for _, _, fut, dl in batch:
                if dl and now_mono >= dl:
                    self._shed_scalar(fut)
            batch = [e for e in batch if not (e[3] and now_mono >= e[3])]
            if not batch:
                return
        keys = [k for k, _, _, _ in batch]
        ns = [n for _, n, _, _ in batch]
        self._dispatch_batch.observe(float(len(batch)))
        loop = asyncio.get_running_loop()
        t_q = tracing.now() if tracing.RECORDER is not None else 0
        t_tap = (self.limiter.clock.now() if audit.AUDITOR is not None
                 else 0.0)
        ticket = None
        t0 = time.perf_counter()
        if self._pipelined:
            # Launch/resolve split: the launch executor stages and
            # enqueues batch k+1 while the resolve executor blocks on
            # batch k, so the device always has work queued.
            try:
                ticket = await loop.run_in_executor(
                    self._pool, self._launch_work, keys, ns, trace_id, t_q)
            except Exception as exc:
                for _, _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            work = self._resolve_target(loop, ticket)
        else:
            work = loop.run_in_executor(
                self._pool, lambda: self._allow_work(keys, ns, trace_id))
        try:
            out, timed_out = await self._await_dispatch(work, len(batch),
                                                        t0)
        except Exception as exc:
            # Fail-open dispatch failures never get here (the limiter maps
            # them to a fail-open BatchResult): fail-closed, every waiter
            # gets the error.
            for _, _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(exc)
            return
        t_dec = getattr(ticket, "t_sec", 0.0) or t_tap
        if timed_out:
            cfg = self.limiter.config
            if cfg.fail_open:
                reset_at = self.limiter.clock.now() + float(cfg.window)
                for _, _, fut, _ in batch:
                    if not fut.done():
                        fut.set_result(fail_open_result(cfg.limit, reset_at))
                self.decisions_total += len(batch)
            else:
                err = self._breach_error()
                for _, _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(err)
            _tap_late(work, "offer_keys", keys, ns, t_dec)
            return
        self.decisions_total += len(batch)
        # String windows are tapped before the per-request split (the
        # worker hashes them with the limiter's prefix rule).
        aud = audit.AUDITOR
        if aud is not None:
            aud.offer_keys(keys, ns, t_dec, out)
        for i, (_, _, fut, _) in enumerate(batch):
            if not fut.done():
                fut.set_result(out.result(i))

    # ----------------------------------------------------------- control

    async def drain(self) -> None:
        """Flush what is queued and wait for every in-flight dispatch (the
        graceful-shutdown half)."""
        self._draining = True
        self._flush()
        while self._inflight:
            tasks = list(self._inflight)
            await asyncio.gather(*tasks, return_exceptions=True)
            # Remove directly: awaiting an already-done task does not yield
            # to the loop, so the done-callback discard may not have run
            # yet and the while would otherwise busy-spin.
            self._inflight.difference_update(tasks)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        if self._resolve_pool is not None:
            self._resolve_pool.shutdown(wait=True)
        if self._fleet_pool is not None:
            self._fleet_pool.shutdown(wait=True)
