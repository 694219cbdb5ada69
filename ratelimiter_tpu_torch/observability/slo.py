"""Admission SLO burn rate: error-budget consumption from live counters —
a copy of ``ratelimiter_tpu/observability/slo.py`` over the port's
metrics registry (same windows, axes, gauges and status dict).

The decision-quality half of the observatory (ADR-016 §5): the
flight-recorder stage histograms say how long admissions take, and the
deadline-shed / SLO-breach / storage-error counters say which admissions
the serving tier failed outright — this module folds both into the SRE
burn-rate form ("how fast is the error budget burning, over a fast and a
slow window") so an operator can alert on decision quality the same way
they alert on latency.

Two axes, deliberately kept in their native units (mixing them would be
a lie — spans count dispatches, sheds count decisions):

* **latency axis** (span units): fraction of ``rate_limiter_stage_seconds
  {stage=<stage>}`` observations above the latency target. Requires the
  flight recorder (``--flight-recorder``) for per-stage attribution;
  without it the tracker falls back to the always-on
  ``rate_limiter_server_dispatch_seconds`` histogram (whole-dispatch
  wall time, coarser but honest).
* **availability axis** (decision units): bad = deadline sheds + SLO
  breaches + error-result requests + fail-open requests, over total
  requests + sheds.

``burn_rate`` per window = bad_fraction / (1 - objective): 1.0 means the
budget burns exactly at the sustainable rate; 14.4 over 1h is the classic
"page now" multiwindow threshold. The reported rate per window is the
MAX of the two axes — the budget burns at the rate of its worst axis.

Sampling happens at scrape/healthz cadence (a collect hook on the
registry — the debt-slab pattern, never the decide path): the tracker
keeps a short ring of (t, counters) snapshots and differences the newest
against the oldest snapshot at least ``window`` old (or the oldest held,
with the actual span reported), so burn rates are windowed even though
the underlying families are cumulative.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from ratelimiter_tpu_torch.observability import metrics as m

#: Counter families whose deltas are availability-axis BAD events, and
#: the request family giving the denominator. Both are DECISION units:
#: sheds count decisions, and SLO breaches are consumed via the
#: decision-unit twin of the per-frame breach counter (one breached
#: frame fails-open up to max_batch decisions that never reach
#: rate_limiter_requests_total — counting the frame-unit family here
#: would understate a full latency outage by a factor of the batch
#: size).
_BAD_COUNTERS = (
    "rate_limiter_server_deadline_shed_total",
    "rate_limiter_server_slo_breach_decisions_total",
)
_REQUESTS = "rate_limiter_requests_total"


class SloBurnTracker:
    """Windowed burn-rate computation over a metrics Registry.

    Args:
        registry: the registry the serving tier records into.
        objective: fraction of admissions that must be good (default
            99.9% — error budget is ``1 - objective``).
        latency_target: seconds; an admission slower than this is a
            latency-axis bad event (snapped down to a histogram bucket
            bound; the snapped value is reported).
        stage: flight-recorder stage whose histogram carries the latency
            axis (default "device" — the dispatch wait, ADR-014).
        windows: burn-rate windows in seconds (default 5m and 1h).
    """

    def __init__(self, registry: Optional[m.Registry] = None, *,
                 objective: float = 0.999, latency_target: float = 0.025,
                 stage: str = "device",
                 windows: tuple = (300.0, 3600.0)):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.registry = registry if registry is not None else m.DEFAULT
        self.objective = float(objective)
        self.latency_target = float(latency_target)
        self.stage = stage
        self.windows = tuple(float(w) for w in windows)
        self._lock = threading.Lock()
        #: ring of (t_monotonic, spans_total, spans_slow, dec_total,
        #: dec_bad, effective_target). Sized from the windows: at the
        #: 0.5 s dedup floor the ring must hold 2x the LONGEST window
        #: of samples, or sub-second polling would evict the slow
        #: window's base and the "1 h" burn rate would silently
        #: evaluate a shorter span (~56 B/slot — ~800 KiB for the
        #: default 1 h window).
        self._samples: deque = deque(
            maxlen=int(2 * max(self.windows) / 0.5) + 16)
        self._attached = False

    # ------------------------------------------------------- counting

    def _counts(self) -> tuple:
        """One consistent-enough read of the cumulative families (each
        family is internally locked; cross-family skew is bounded by
        scrape concurrency and washes out in windowed deltas)."""
        spans_total = spans_slow = 0
        eff = self.latency_target
        hist = self.registry.get("rate_limiter_stage_seconds")
        if isinstance(hist, m.Histogram):
            spans_total, spans_slow, eff = hist.counts_over(
                self.latency_target, stage=self.stage)
        if spans_total == 0:
            # Flight recorder off (or no traffic yet): fall back to the
            # always-on dispatch histogram — whole-dispatch wall time.
            hist = self.registry.get("rate_limiter_server_dispatch_seconds")
            if isinstance(hist, m.Histogram):
                spans_total, spans_slow, eff = hist.counts_over(
                    self.latency_target)
        dec_total = dec_bad = 0.0
        req = self.registry.get(_REQUESTS)
        if isinstance(req, m.Counter):
            dec_total += req.total()
            dec_bad += req.total(result="fail_open")
            # error:<kind> results — enumerate label sets once.
            for key, v in req.labeled_values():
                if any(k == "result" and str(val).startswith("error:")
                       for k, val in key):
                    dec_bad += v
        for name in _BAD_COUNTERS:
            c = self.registry.get(name)
            if isinstance(c, m.Counter):
                bad = c.total()
                # Shed/breached decisions never reach the limiter (and
                # so never land in requests_total) — they join the
                # denominator here as well as the numerator.
                dec_total += bad
                dec_bad += bad
        return spans_total, spans_slow, dec_total, dec_bad, eff

    def sample(self) -> None:
        """Append one snapshot (idempotent at sub-second cadence: a
        hammered /healthz cannot flood the ring)."""
        now = time.monotonic()
        with self._lock:
            if self._samples and now - self._samples[-1][0] < 0.5:
                return
            st, ss, dt, db, eff = self._counts()
            self._samples.append((now, st, ss, dt, db, eff))
            horizon = now - 2 * max(self.windows)
            while len(self._samples) > 2 and self._samples[0][0] < horizon:
                self._samples.popleft()

    # --------------------------------------------------------- status

    @staticmethod
    def _frac(bad: float, total: float) -> float:
        return bad / total if total > 0 else 0.0

    def status(self) -> dict:
        """The /healthz ``slo`` block: per-window burn rates + the raw
        axis fractions. Always samples first, so a bare /healthz poll
        (no scraper running) still gets current numbers."""
        self.sample()
        budget = 1.0 - self.objective
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {"objective": self.objective, "windows": {}}
        newest = samples[-1]
        out: Dict[str, dict] = {}
        for w in self.windows:
            # Oldest sample at least w old; else the oldest held (the
            # actual span is reported so a young process cannot fake a
            # calm hour).
            base = samples[0]
            for s in samples:
                if newest[0] - s[0] >= w:
                    base = s
                else:
                    break
            span = newest[0] - base[0]
            slow_frac = self._frac(newest[2] - base[2],
                                   newest[1] - base[1])
            bad_frac = self._frac(newest[4] - base[4],
                                  newest[3] - base[3])
            out[f"{int(w)}s"] = {
                "span_s": round(span, 1),
                "latency_bad_fraction": round(slow_frac, 6),
                "availability_bad_fraction": round(bad_frac, 6),
                "burn_rate": round(max(slow_frac, bad_frac) / budget, 3),
                # Raw windowed deltas behind the fractions — the
                # MERGEABLE form (ADR-021): a fleet rollup sums these
                # across members and recomputes the fractions/burn over
                # the merged counts, instead of averaging ratios (which
                # would let an idle member dilute a burning one).
                "spans": int(newest[1] - base[1]),
                "spans_slow": int(newest[2] - base[2]),
                "decisions": int(newest[3] - base[3]),
                "decisions_bad": int(newest[4] - base[4]),
            }
        return {
            "objective": self.objective,
            "error_budget": round(budget, 6),
            "latency_target_s": self.latency_target,
            "latency_target_effective_s": newest[5],
            "latency_stage": self.stage,
            "spans_observed": int(newest[1]),
            "decisions_observed": int(newest[3]),
            "windows": out,
        }

    # ----------------------------------------------------- metrics hook

    def attach(self, registry: Optional[m.Registry] = None) -> None:
        """Export burn-rate gauges at scrape time (collect-hook seam)."""
        reg = registry if registry is not None else self.registry
        g_burn = reg.gauge(
            "rate_limiter_slo_burn_rate",
            "Admission SLO error-budget burn rate (max of the latency "
            "and availability axes; 1.0 = sustainable, ADR-016)")
        g_lat = reg.gauge(
            "rate_limiter_slo_latency_bad_fraction",
            "Fraction of admission stage observations above the latency "
            "target, per burn window")
        g_avail = reg.gauge(
            "rate_limiter_slo_availability_bad_fraction",
            "Fraction of decisions shed/errored/failed-open, per burn "
            "window")

        def collect() -> None:
            st = self.status()
            for wname, row in st.get("windows", {}).items():
                g_burn.set(row["burn_rate"], window=wname)
                g_lat.set(row["latency_bad_fraction"], window=wname)
                g_avail.set(row["availability_bad_fraction"], window=wname)

        reg.add_collect_hook(collect)
        self._collect = collect
        self._collect_reg = reg
        self._attached = True

    def detach(self) -> None:
        if self._attached:
            self._collect_reg.remove_collect_hook(self._collect)
            self._attached = False
