"""Injectable clocks (a copy of ``ratelimiter_tpu/core/clock.py``).

The reference takes timestamps from the Go process clock (``time.Now()``,
e.g. ``tokenbucket.go:97``) and tests fake time at the *storage* level with
miniredis ``FastForward`` (SURVEY.md §4.2.2). Here time is an explicit operand
of every decision — host-captured at batch assembly and passed into the device
call as a scalar — so virtual time is first-class and deterministic.

Internally, device kernels take time as int64 **microseconds** (float32 cannot
represent unix-epoch seconds to better than ~256 s; float64 is off by default
on TPU). The public API speaks float seconds.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

MICROS = 1_000_000


def to_micros(seconds: float) -> int:
    """Convert float seconds to int64 microseconds (round-to-nearest)."""
    return int(round(seconds * MICROS))


@runtime_checkable
class Clock(Protocol):
    def now(self) -> float:
        """Current time as float unix seconds."""
        ...


class SystemClock:
    """Wall clock."""

    def now(self) -> float:
        return time.time()


class ManualClock:
    """Deterministic clock for tests; the analog of miniredis FastForward
    (reference ``fixedwindow_integration_test.go:174``) but exact, and it
    supports negative advances the same way the reference's tests back-date
    state (``slidingwindow_integration_test.go:389``)."""

    def __init__(self, start: float = 1_700_000_000.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds

    def set(self, seconds: float) -> None:
        self._now = float(seconds)
