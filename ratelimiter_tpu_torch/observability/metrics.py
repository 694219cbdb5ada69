"""Thread-safe metrics registry with Prometheus text exposition.

A copy of ``ratelimiter_tpu/observability/metrics.py`` trimmed to what
the port's micro-batcher, door and persistence register: counters, gauges and
histograms with labels, a registry with scrape-time collect hooks, and
the classic Prometheus text format (no OpenMetrics exemplars). For the
same observations ``Registry.render`` gives the JAX registry's text byte
for byte (tests/test_torch_batcher.py holds it to it).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, Sequence, Tuple

#: Default histogram buckets, seconds — spans 10 µs host overhead to multi-
#: second SLO breaches (device dispatches land in the 100 µs .. 10 ms range).
LATENCY_BUCKETS = (1e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                   1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5)

#: Batch-size buckets for the micro-batcher (powers of two up to 64K).
BATCH_BUCKETS = tuple(float(1 << i) for i in range(17))

#: Snapshot wall-time buckets, seconds (multi-GiB sketch rings serialized
#: off-lock). Families using them, all registered by persistence/ under
#: the JAX package's names: rate_limiter_snapshot_duration_seconds plus
#: rate_limiter_last_snapshot_timestamp_seconds,
#: rate_limiter_snapshot_capture_seconds, rate_limiter_snapshots_total,
#: rate_limiter_snapshot_failures_total, rate_limiter_wal_records_total,
#: rate_limiter_wal_bytes_total and rate_limiter_wal_seq.
SNAPSHOT_DURATION_BUCKETS = (1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25,
                             0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text exposition spec
    (backslash, double-quote and newline are escaped inside the
    quotes)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(items: Iterable[Tuple[str, str]]) -> str:
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + inner + "}" if inner else ""


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter family, keyed by label values."""

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "counter")
        self._values: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        return lines


class Gauge(_Metric):
    """Point-in-time value family."""

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "gauge")
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        return lines


class Histogram(_Metric):
    """Cumulative histogram family (Prometheus bucket semantics)."""

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[tuple, list] = {}   # key -> per-bucket counts + inf
        self._sums: Dict[tuple, float] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        # bisect_left finds the first bound >= value: Prometheus' `le`.
        i = bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = [0] * (len(self.buckets) + 1)
                self._counts[key] = counts
                self._sums[key] = 0.0
            counts[i if i < len(self.buckets) else -1] += 1
            self._sums[key] += value

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum += counts[i]
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(key + (('le', f'{ub:g}'),))} {cum}")
                cum += counts[-1]
                lines.append(f"{self.name}_bucket"
                             f"{_fmt_labels(key + (('le', '+Inf'),))} {cum}")
                lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                             f"{self._sums[key]:g}")
                lines.append(f"{self.name}_count{_fmt_labels(key)} {cum}")
        return lines


class Registry:
    """A named collection of metric families; renders the Prometheus text
    exposition format. One default registry per process (DEFAULT), but
    tests and multi-limiter deployments can build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collect_hooks: list = []

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if existing.kind != metric.kind:
                    raise ValueError(f"metric {metric.name} already "
                                     f"registered as {existing.kind}")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(Counter(name, help_))  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge(name, help_))  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, buckets))  # type: ignore[return-value]

    def add_collect_hook(self, fn) -> None:
        """Register a zero-arg callable run at the start of every
        ``render()`` (scrape time), for gauges whose value costs real
        work. Duplicates are collapsed by identity."""
        with self._lock:
            if fn not in self._collect_hooks:
                self._collect_hooks.append(fn)

    def render(self) -> str:
        with self._lock:
            hooks = list(self._collect_hooks)
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — a scrape must never fail
                # because one collector's backend is closed; the gauge
                # keeps its last value.
                pass
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


#: Process-default registry.
DEFAULT = Registry()
