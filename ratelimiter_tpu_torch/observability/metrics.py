"""Thread-safe metrics registry with Prometheus text exposition.

A copy of ``ratelimiter_tpu/observability/metrics.py``: counters, gauges
and histograms with labels (histograms keep an OpenMetrics exemplar per
bucket), a registry with scrape-time collect hooks, and both the classic
Prometheus text format and the OpenMetrics one (``render(openmetrics=
True)``, exemplars and ``# EOF``). For the same observations the two
renderings give the JAX registry's text byte for byte
(tests/test_torch_batcher.py and tests/test_torch_tracing.py hold them
to it). The micro-batcher, the door, persistence, the controller, the
flight recorder and the decorators (observability/decorators.py, which
also own the side table's consumer gauges) register into it.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: Default histogram buckets, seconds — spans 10 µs host overhead to multi-
#: second SLO breaches (device dispatches land in the 100 µs .. 10 ms range).
LATENCY_BUCKETS = (1e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                   1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5)

#: Batch-size buckets for the micro-batcher (powers of two up to 64K).
BATCH_BUCKETS = tuple(float(1 << i) for i in range(17))

#: Snapshot-duration buckets, seconds — the durability subsystem's
#: background captures span ~1 ms (tiny host state) to tens of seconds
#: (multi-GiB sketch rings serialized off-lock). Families using them:
#: rate_limiter_snapshot_duration_seconds plus the gauges/counters
#: rate_limiter_last_snapshot_timestamp_seconds,
#: rate_limiter_snapshot_capture_seconds, rate_limiter_snapshots_total,
#: rate_limiter_snapshot_failures_total, rate_limiter_wal_records_total,
#: rate_limiter_wal_bytes_total, rate_limiter_wal_seq
#: (ratelimiter_tpu_torch/persistence/).
SNAPSHOT_DURATION_BUCKETS = (1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25,
                             0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text exposition spec
    (backslash, double-quote, and newline must be escaped INSIDE the
    quotes) — user-derived values (keys, algorithm strings) would
    otherwise corrupt the whole scrape with one embedded quote."""
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

    def value(self, **labels: str) -> float:
        # Under the lock: a bare dict read races inc()'s read-modify-
        # write and (on resize) dict mutation — cheap, and value() is
        # never on the decide path.
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self, **labels_filter: str) -> float:
        """Sum over every label set matching the (partial) filter —
        the SLO burn-rate tracker's family-wide read (observability/
        slo.py): e.g. a shed counter labeled per door sums to one
        bad-event count."""
        with self._lock:
            out = 0.0
            for key, v in self._values.items():
                kd = dict(key)
                if all(kd.get(k) == v2 for k, v2 in labels_filter.items()):
                    out += v
            return out

    def labeled_values(self) -> list[tuple[tuple, float]]:
        """Locked snapshot of (label_key, value) pairs — for consumers
        that must inspect label VALUES (the burn tracker matches
        ``result=error:*`` prefixes)."""
        with self._lock:
            return list(self._values.items())

    def render(self, om: bool = False) -> list[str]:
        # OpenMetrics requires the counter FAMILY name without the
        # `_total` suffix (HELP/TYPE lines) while the sample keeps it —
        # `# TYPE x_total counter` fails Prometheus's strict OM parser,
        # which would reject the whole scrape. Classic text exposition
        # uses the full name in both places.
        family = self.name
        sample = self.name
        if om:
            if family.endswith("_total"):
                family = family[:-len("_total")]
            else:
                sample = family + "_total"
        lines = [f"# HELP {family} {self.help}",
                 f"# TYPE {family} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(f"{sample}{_fmt_labels(key)} {v:g}")
        return lines


class Gauge(_Metric):
    """Point-in-time value family."""

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "gauge")
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        """Drop every label set. For identity/info gauges whose label
        VALUES change over time (e.g. the fleet map epoch on
        ``rate_limiter_member_info``): a gauge only overwrites label
        sets it is told about, so a collect hook clears before it sets
        or stale identities would persist forever."""
        with self._lock:
            self._values.clear()

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
        #: (key, bucket_index) -> (exemplar trace id, value, unix ts):
        #: the LAST sampled observation that landed in that bucket.
        #: Rendered only by the OpenMetrics exposition (render_om) —
        #: classic Prometheus text has no exemplar syntax.
        self._exemplars: Dict[tuple, tuple] = {}

    def observe(self, value: float, *, exemplar: Optional[str] = None,
                **labels: str) -> None:
        key = _label_key(labels)
        # bisect instead of a linear scan: this runs per decision on
        # 16-bucket latency families (bisect_left on "first ub >= value"
        # is exactly the old `value <= ub` bucket rule).
        i = bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = [0] * (len(self.buckets) + 1)
                self._counts[key] = counts
                self._sums[key] = 0.0
            counts[i if i < len(self.buckets) else -1] += 1
            self._sums[key] += value
            if exemplar is not None:
                self._exemplars[(key, i)] = (exemplar, value, time.time())

    def count(self, **labels: str) -> int:
        with self._lock:
            return sum(self._counts.get(_label_key(labels), []))

    def sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def counts_over(self, threshold: float,
                    **labels_filter: str) -> tuple[int, int, float]:
        """(total, over, effective_threshold) across every label set
        matching the (partial) filter: how many observations landed
        STRICTLY above the largest bucket bound <= ``threshold``.
        Cumulative buckets only resolve at bucket bounds, so the
        threshold snaps DOWN to one (returned as effective_threshold;
        pessimistic — borderline observations count as slow). The SLO
        burn-rate tracker derives its latency axis from this
        (observability/slo.py)."""
        from bisect import bisect_right

        idx = bisect_right(self.buckets, threshold)
        eff = self.buckets[idx - 1] if idx > 0 else 0.0
        total = over = 0
        with self._lock:
            for key, counts in self._counts.items():
                kd = dict(key)
                if not all(kd.get(k) == v for k, v in labels_filter.items()):
                    continue
                s = sum(counts)
                total += s
                over += s - sum(counts[:idx])
        return total, over, eff

    def render(self, om: bool = False) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum += counts[i]
                    line = (f"{self.name}_bucket"
                            f"{_fmt_labels(key + (('le', f'{ub:g}'),))} {cum}")
                    ex = self._exemplars.get((key, i)) if om else None
                    if ex is not None:
                        # OpenMetrics exemplar: ties this le-bucket to a
                        # trace id recorded by the flight recorder
                        # (ADR-014) — `# {trace_id="..."} value ts`.
                        line += (f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
                                 f" {ex[2]:.3f}")
                    lines.append(line)
                cum += counts[-1]
                line = (f"{self.name}_bucket"
                        f"{_fmt_labels(key + (('le', '+Inf'),))} {cum}")
                # The overflow bucket keeps its exemplar too — the
                # slowest observations are exactly the ones worth a
                # trace id (observe() stores them at index
                # len(self.buckets)).
                ex = (self._exemplars.get((key, len(self.buckets)))
                      if om else None)
                if ex is not None:
                    line += (f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
                             f" {ex[2]:.3f}")
                lines.append(line)
                lines.append(f"{self.name}_sum{_fmt_labels(key)} {self._sums[key]:g}")
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
                    raise ValueError(
                        f"metric {metric.name} already registered as {existing.kind}")
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

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def add_collect_hook(self, fn) -> None:
        """Register a zero-arg callable run at the START of every
        ``render()`` — i.e. at scrape time. This is how gauges whose
        value costs real work (a device fetch under the backend lock,
        e.g. the debt-slab occupancy surface) stay current without ever
        touching the decision hot path: they refresh once per scrape,
        not once per decision. Hooks must be idempotent; duplicates are
        collapsed by identity of the bound callable."""
        with self._lock:
            if fn not in self._collect_hooks:
                self._collect_hooks.append(fn)

    def remove_collect_hook(self, fn) -> None:
        """Unregister a collect hook (no-op if absent). Owners of hooked
        resources MUST call this on close — on the process-default
        registry a leftover hook would pin the closed backend (and its
        device arrays) alive forever and run against it on every
        scrape."""
        with self._lock:
            try:
                self._collect_hooks.remove(fn)
            except ValueError:
                pass

    def render(self, *, openmetrics: bool = False) -> str:
        with self._lock:
            hooks = list(self._collect_hooks)
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — a scrape must never fail
                # because one collector's backend is mid-restart/closed;
                # the gauge just keeps its last value.
                pass
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if openmetrics and isinstance(m, (Histogram, Counter)):
                lines.extend(m.render(om=True))
            else:
                lines.extend(m.render())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics-flavored exposition: same families, plus
        histogram bucket EXEMPLARS (`# {trace_id="..."} v ts`) tying
        `rate_limiter_*_seconds` buckets to the flight-recorder trace
        ids that landed in them (ADR-014), and the `# EOF` terminator.
        The HTTP gateway serves this for
        `Accept: application/openmetrics-text` scrapes."""
        return self.render(openmetrics=True)


#: Process-default registry (the serving tier exposes it over /metrics).
DEFAULT = Registry()
