"""The port's SLO burn tracker (observability/slo.py) against the JAX
package's, tolerance 0.

The JAX ``TestSloBurnTracker`` scenarios (tests/test_audit.py) run
through both trackers on one fake monotonic clock, each over its own
package's registry fed the same observations: the status dicts must be
equal, and so must the gauges their collect hooks export (the rendered
registry text).
"""

from __future__ import annotations

import numpy as np
import pytest

from ratelimiter_tpu.observability import metrics as jm
from ratelimiter_tpu.observability import slo as jslo
from ratelimiter_tpu_torch.observability import metrics as tm
from ratelimiter_tpu_torch.observability import slo as tslo


class _FakeTime:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


class Pair:
    """The same registry families and tracker in both packages, fed
    through ``do(family, method, *args, **labels)``."""

    def __init__(self, monkeypatch, **tracker_kw):
        self.clock = _FakeTime()
        monkeypatch.setattr("ratelimiter_tpu.observability.slo.time",
                            self.clock)
        monkeypatch.setattr("ratelimiter_tpu_torch.observability.slo.time",
                            self.clock)
        self.regs = (jm.Registry(), tm.Registry())
        self.trackers = (jslo.SloBurnTracker(self.regs[0], **tracker_kw),
                         tslo.SloBurnTracker(self.regs[1], **tracker_kw))

    def family(self, kind: str, name: str):
        return [getattr(r, kind)(name) for r in self.regs]

    def do(self, fams, method: str, *args, **labels) -> None:
        for f in fams:
            getattr(f, method)(*args, **labels)

    def sample(self) -> None:
        for tr in self.trackers:
            tr.sample()

    def status(self) -> dict:
        j, t = (tr.status() for tr in self.trackers)
        assert t == j
        return t

    def render(self) -> str:
        j, t = (r.render() for r in self.regs)
        assert t == j
        return t


def test_burn_rate_windows(monkeypatch):
    p = Pair(monkeypatch, objective=0.99, latency_target=0.01,
             stage="device", windows=(60.0,))
    hist = p.family("histogram", "rate_limiter_stage_seconds")
    shed = p.family("counter", "rate_limiter_server_deadline_shed_total")
    req = p.family("counter", "rate_limiter_requests_total")
    p.sample()
    p.clock.t += 61.0
    for _ in range(99):
        p.do(hist, "observe", 0.001, stage="device")
        p.do(req, "inc", result="allowed")
    p.do(hist, "observe", 0.5, stage="device")
    p.do(req, "inc", result="allowed")
    p.do(shed, "inc", 1)
    st = p.status()
    row = st["windows"]["60s"]
    assert row["latency_bad_fraction"] == 0.01
    assert row["span_s"] == 61.0
    assert st["latency_target_effective_s"] <= 0.01


def test_slo_breach_counts_decisions_not_frames(monkeypatch):
    p = Pair(monkeypatch, objective=0.99, windows=(60.0,))
    breach = p.family("counter",
                      "rate_limiter_server_slo_breach_decisions_total")
    p.sample()
    p.clock.t += 61.0
    p.do(breach, "inc", 4096)
    assert p.status()["windows"]["60s"]["availability_bad_fraction"] == 1.0


def test_fallback_to_dispatch_histogram(monkeypatch):
    p = Pair(monkeypatch, latency_target=0.05)
    disp = p.family("histogram", "rate_limiter_server_dispatch_seconds")
    p.do(disp, "observe", 0.2)
    assert p.status()["spans_observed"] == 1


def test_gauges_on_collect(monkeypatch):
    p = Pair(monkeypatch, windows=(30.0,))
    hist = p.family("histogram", "rate_limiter_stage_seconds")
    for tr in p.trackers:
        tr.attach()
    p.do(hist, "observe", 1.0, stage="device")
    p.clock.t += 31.0
    assert "rate_limiter_slo_burn_rate" in p.render()
    for tr in p.trackers:
        tr.detach()
    # Detached: the gauges keep their last values but no hook runs.
    p.clock.t += 31.0
    p.do(hist, "observe", 1.0, stage="device")
    p.render()


def test_bad_objective_rejected():
    for cls in (jslo.SloBurnTracker, tslo.SloBurnTracker):
        with pytest.raises(ValueError):
            cls(None, objective=1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_feed(monkeypatch, seed):
    """A seeded mix of every family the tracker reads (stage and
    dispatch histograms, fail-open and error requests, sheds and SLO
    breaches), sampled at irregular steps across two windows and a
    sub-second re-poll: status and gauges equal after every step."""
    rng = np.random.default_rng(seed)
    p = Pair(monkeypatch, objective=0.995, latency_target=0.02,
             windows=(20.0, 90.0))
    for tr in p.trackers:
        tr.attach()
    stage = p.family("histogram", "rate_limiter_stage_seconds")
    disp = p.family("histogram", "rate_limiter_server_dispatch_seconds")
    req = p.family("counter", "rate_limiter_requests_total")
    shed = p.family("counter", "rate_limiter_server_deadline_shed_total")
    breach = p.family("counter",
                      "rate_limiter_server_slo_breach_decisions_total")
    results = ("allowed", "denied", "fail_open", "error:storage_unavailable",
               "error:invalid_key")
    for step in range(40):
        for _ in range(int(rng.integers(0, 30))):
            lat = float(rng.choice([0.001, 0.004, 0.03, 0.2]))
            if step >= 5:          # the first steps take the fallback
                p.do(stage, "observe", lat,
                     stage=str(rng.choice(["device", "launch"])))
            p.do(disp, "observe", lat)
            p.do(req, "inc", result=str(rng.choice(results)))
        if rng.random() < 0.2:
            p.do(shed, "inc", float(rng.integers(1, 9)))
        if rng.random() < 0.1:
            p.do(breach, "inc", float(rng.integers(1, 4097)))
        p.clock.t += float(rng.choice([0.2, 0.7, 3.0, 11.0]))
        p.status()
        p.render()
    for tr in p.trackers:
        tr.detach()
