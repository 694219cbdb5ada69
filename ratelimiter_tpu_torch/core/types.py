"""Algorithm enum, Result, and BatchResult.

A copy of ``ratelimiter_tpu/core/types.py``; only ``DispatchTicket``
differs, because the port's launch/resolve split rides a CUDA event.

Parity with reference ``internal/ratelimiter/interface.go:9-43`` and
``result.go:5-49``. The reference's result constructors are dead code
(defined + tested, never called — SURVEY.md §2.1 row 3); here they are the
only way backends build results, so the semantics in one place:

* allowed  -> remaining = post-decision remaining quota, retry_after = 0
* denied   -> remaining clamped >= 0, retry_after > 0 (algorithm-specific)
* fail-open  (backend down, Config.fail_open=True)  -> allowed, remaining 0
  (reference ``tokenbucket.go:103-110``)
* fail-closed (backend down, fail_open=False) -> raises
  StorageUnavailableError; there is deliberately no Result for it
  (reference returns nil result + error, ``fixedwindow_integration_test.go:271-273``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class Algorithm(enum.Enum):
    """Rate-limiting algorithm (reference ``interface.go:9-23``) plus this
    framework's own ``TPU_SKETCH`` (BASELINE.json north star)."""

    TOKEN_BUCKET = "token_bucket"
    SLIDING_WINDOW = "sliding_window"
    FIXED_WINDOW = "fixed_window"
    #: Count-min-sketch + sub-window decay; approximate, unbounded key space,
    #: the TPU-native flagship. Semantics follow SLIDING_WINDOW.
    TPU_SKETCH = "tpu_sketch"

    def __str__(self) -> str:  # str(Algorithm.TOKEN_BUCKET) == "token_bucket"
        return self.value


@dataclass(frozen=True)
class Result:
    """Outcome of one allow / allow_n decision (reference ``interface.go:26-43``).

    Attributes:
        allowed: whether the request may proceed.
        limit: the configured limit (for X-RateLimit-Limit headers).
        remaining: quota remaining after this decision, clamped >= 0.
        retry_after: seconds until a retry may succeed; 0 when allowed.
        reset_at: unix seconds when the limit fully resets.
        fail_open: True iff this is a backend-failure fail-open allowance.
    """

    allowed: bool
    limit: int
    remaining: int
    retry_after: float
    reset_at: float
    fail_open: bool = False


@dataclass
class BatchResult:
    """Vectorized outcome of allow_batch — the TPU-native first-class shape.

    All arrays are NumPy, length = number of requests, in request order.
    ``result(i)`` materializes a scalar Result for interop with the scalar
    API (e.g. the serving fan-out).
    """

    allowed: np.ndarray      # bool[B]
    limit: int
    remaining: np.ndarray    # int64[B], post-decision, clamped >= 0
    retry_after: np.ndarray  # float64[B] seconds, 0 where allowed
    reset_at: np.ndarray     # float64[B] unix seconds
    fail_open: bool = False
    #: Per-request effective limits when policy overrides touched this
    #: batch (int64[B]); None means every request saw the uniform `limit`.
    limits: "np.ndarray | None" = None
    #: Device-packed wire buffers ``(bits u8[padded/8], words
    #: i64[3*padded], padded)`` when the dispatch was launched
    #: ``wire=True`` (sketch_kernels.pack_wire):
    #: protocol.encode_result_hashed frames straight from these with
    #: slices instead of re-bit-packing the allow mask. A 4-tuple
    #: ``(bits, words, padded, row_off)`` is the row-window form
    #: produced by ``rows()``: the same buffers, framing the
    #: ``row_off``-based sub-range.
    wire_packed: "tuple | None" = None

    def __len__(self) -> int:
        return int(self.allowed.shape[0])

    def result(self, i: int) -> Result:
        return Result(
            allowed=bool(self.allowed[i]),
            limit=(int(self.limits[i]) if self.limits is not None
                   else self.limit),
            remaining=int(self.remaining[i]),
            retry_after=float(self.retry_after[i]),
            reset_at=float(self.reset_at[i]),
            fail_open=self.fail_open,
        )

    def results(self) -> list[Result]:
        return [self.result(i) for i in range(len(self))]

    def rows(self, off: int, count: int) -> "BatchResult":
        """A contiguous row-range view of this result (the micro-batcher's
        per-frame slice of a coalesced window): all arrays are NumPy
        views, and device-packed wire buffers ride along in the
        row-offset form ``(bits, words, padded, off)`` so the wire
        encoder still frames the sub-range from them
        (protocol.encode_result_hashed_views). ``fail_open`` is the
        window's: a frame coalesced with a failed-open neighbour reports
        that some answers may be fabricated."""
        wp = self.wire_packed
        if wp is not None:
            bits, words, padded = wp[0], wp[1], wp[2]
            base = wp[3] if len(wp) > 3 else 0
            wp = (bits, words, padded, base + off)
        return BatchResult(
            allowed=self.allowed[off:off + count],
            limit=self.limit,
            remaining=self.remaining[off:off + count],
            retry_after=self.retry_after[off:off + count],
            reset_at=self.reset_at[off:off + count],
            fail_open=self.fail_open,
            limits=(self.limits[off:off + count]
                    if self.limits is not None else None),
            wire_packed=wp,
        )

    @property
    def allow_count(self) -> int:
        return int(np.sum(self.allowed))


def allowed_result(limit: int, remaining: int, reset_at: float) -> Result:
    """Reference ``result.go:6-14`` (NewAllowedResult)."""
    return Result(allowed=True, limit=limit, remaining=max(0, int(remaining)),
                  retry_after=0.0, reset_at=reset_at)


def denied_result(limit: int, remaining: int, retry_after: float,
                  reset_at: float) -> Result:
    """Reference ``result.go:17-26`` (NewDeniedResult); retry_after clamped
    >= 0 the way every algorithm clamps it (``fixedwindow.go:110-112``)."""
    return Result(allowed=False, limit=limit, remaining=max(0, int(remaining)),
                  retry_after=max(0.0, float(retry_after)), reset_at=reset_at)


def fail_open_result(limit: int, reset_at: float) -> Result:
    """Backend down with fail_open: allowed, remaining 0 (reference
    ``result.go:29-38``, ``tokenbucket.go:103-110``)."""
    return Result(allowed=True, limit=limit, remaining=0, retry_after=0.0,
                  reset_at=reset_at, fail_open=True)


def batch_fail_open(n: int, limit: int, reset_at: float) -> BatchResult:
    """Whole-batch fail-open (dispatch failure with Config.fail_open=True)."""
    return BatchResult(
        allowed=np.ones(n, dtype=bool),
        limit=limit,
        remaining=np.zeros(n, dtype=np.int64),
        retry_after=np.zeros(n, dtype=np.float64),
        reset_at=np.full(n, reset_at, dtype=np.float64),
        fail_open=True,
    )


class DispatchTicket:
    """Handle to one *launched* batched dispatch (the pipelined serving hot
    path).

    ``limiter.launch_batch`` / ``launch_hashed`` / ``launch_ids`` stage the
    batch, enqueue the decision step on the device's current stream, start
    the copies of its results into pinned host buffers, record a CUDA event
    behind them and return one of these WITHOUT blocking;
    ``limiter.resolve(ticket)`` waits on that event and assembles the
    BatchResult. Sequential semantics across in-flight tickets come from
    stream order: every step updates the state tensors in place, and the
    stream runs launches in the order they were made, whatever order the
    tickets are resolved in.

    Backends without an async device path pre-resolve at launch:
    ``result`` is already set and resolve just returns it.
    """

    __slots__ = ("outs", "b", "limit", "limits", "ns", "now_us", "t_sec",
                 "padded", "result", "wire", "event", "staged", "inflight",
                 "meta", "trace_id")

    def __init__(self, result: "BatchResult | None" = None):
        self.outs = None        # host-side (pinned on CUDA) result tensors
        self.b = len(result) if result is not None else 0
        self.limit = result.limit if result is not None else 0
        self.limits = None      # host per-request override limits (or None)
        self.ns = None          # host ns[:b]
        self.now_us = 0
        self.t_sec = 0.0
        self.padded = 0
        self.result = result    # set once resolved (or pre-resolved)
        #: True from launch until resolve retires the ticket's offered
        #: mass from the overload watchdog's in-flight count (once).
        self.inflight = False
        self.wire = False       # outs are packed (bits, words) wire buffers
        self.event = None       # CUDA event recorded behind the copies
        self.staged = None      # staged input tensors, alive until resolve
        self.meta = None        # decorator bookkeeping rides along (the
        #                         circuit breaker's probe ownership)
        self.trace_id = 0       # flight-recorder trace context; 0 =
        #                         unsampled. Set by the batcher at launch
        #                         so resolve-side spans link to the frame.
