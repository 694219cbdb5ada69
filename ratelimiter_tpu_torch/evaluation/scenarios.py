"""Abuse-scenario load generation + measurement for the hierarchical
cascade (ADR-020) — a copy of ``ratelimiter_tpu/evaluation/scenarios.py``.

Three canonical multi-tenant abuse shapes, expressed as deterministic
frame generators plus a runner that drives them against a REAL
hierarchy-enabled limiter (any backend exposing the cascade surface) and
measures behavior instead of claiming it:

* **hot-tenant-storm** — one tenant's traffic surges to ~90% of the
  global scope. The cascade must keep squeezing the storm into the
  attacker's fair share (the victim tenant keeps its headroom), and the
  AIMD controller (when wired) must tighten the HOT tenant's effective
  limit and additively recover it after the storm clears.
* **rotating-key** — an attacker mints fresh keys every frame, the
  classic per-key-limit evasion that also churns straight past the hh
  side table's per-key tracking (a rotating key never accumulates
  in-window mass under one identity). Per-key scopes never fire; the
  DEFAULT-tenant + global scopes are what contain the aggregate.
* **thundering-herd** — every key of every tenant bursts simultaneously
  at a window rollover. The global scope must clip the synchronized
  surge to exactly its limit, split between tenants proportionally to
  their weights (the fair-share contract, measured).

False-deny accounting is cascade-aware: decisions are shadowed by a
SEQUENTIAL key → tenant → global reference (``CascadeOracle``) evaluated
at the limiter's LIVE effective limits, so a controller tighten is
policy, not error — what the Wilson bound measures is the limiter's own
divergence from its declared cascade semantics (sketch collisions plus
the documented in-batch staging artifact, ops/hier_kernels.py).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ratelimiter_tpu_torch.evaluation.compare import wilson_interval

SCENARIOS = ("hot-tenant-storm", "rotating-key", "thundering-herd")


class CascadeOracle:
    """Sequential key → tenant → global reference limiter evaluated at
    live effective limits (requests-per-window; fixed time inside a
    window, ``roll()`` at window boundaries)."""

    def __init__(self, key_limit: int, tenant_of: Dict[str, str]):
        self.key_limit = key_limit
        self.tenant_of = dict(tenant_of)
        self.keys: Dict[str, int] = defaultdict(int)
        self.tenants: Dict[str, int] = defaultdict(int)
        self.total = 0

    def roll(self) -> None:
        """A full window elapsed: every scope's in-window mass clears."""
        self.keys.clear()
        self.tenants.clear()
        self.total = 0

    def decide(self, keys: List[str], effective: Dict[str, int]) -> np.ndarray:
        """Sequential verdicts for one frame under ``effective`` (the
        limiter's live per-scope limits; hierarchy.GLOBAL key for the
        global scope)."""
        out = np.zeros(len(keys), dtype=bool)
        g_lim = effective.get("global")
        for i, k in enumerate(keys):
            t = self.tenant_of.get(k, "default")
            t_lim = effective.get(t)
            ok = (self.keys[k] < self.key_limit
                  and (t_lim is None or self.tenants[t] + 1 <= t_lim)
                  and (g_lim is None or self.total + 1 <= g_lim))
            if ok:
                self.keys[k] += 1
                self.tenants[t] += 1
                self.total += 1
            out[i] = ok
        return out


@dataclass
class FalseDenyTally:
    """Wilson-bounded false-deny accounting vs the cascade oracle."""

    denies: int = 0
    false_denies: int = 0
    samples: int = 0

    def add(self, got: np.ndarray, want: np.ndarray) -> None:
        self.samples += int(got.shape[0])
        self.denies += int((~got).sum())
        self.false_denies += int((want & ~got).sum())

    def wilson95(self) -> Tuple[float, float]:
        return wilson_interval(self.false_denies, self.samples)

    def as_dict(self) -> dict:
        lo, hi = self.wilson95()
        return {"false_denies": self.false_denies,
                "samples": self.samples,
                "false_deny_wilson95": [round(lo, 6), round(hi, 6)]}


# ------------------------------------------------------------- generators


def hot_tenant_storm_frames(
        rng: np.random.Generator, *, batch: int, frames_per_phase: int,
        attacker_keys: int = 40, victim_keys: int = 8,
) -> Iterator[Tuple[str, List[str]]]:
    """(phase, keys) frames: baseline (balanced) → storm (attacker ~90%
    of the frame) → recovery (baseline mix again)."""
    atk = [f"atk{i}" for i in range(attacker_keys)]
    vic = [f"vic{i}" for i in range(victim_keys)]
    # The storm multiplies TOTAL demand (an attack adds traffic, it does
    # not displace the victim's): baseline/recovery frames must sit
    # below global saturation for the controller's relax leg to engage.
    for phase, atk_frac, mult in (("baseline", 0.3, 1), ("storm", 0.9, 4),
                                  ("recovery", 0.3, 1)):
        for _ in range(frames_per_phase):
            b = batch * mult
            n_atk = int(b * atk_frac)
            keys = ([atk[int(i)] for i in
                     rng.integers(0, len(atk), size=n_atk)]
                    + [vic[int(i)] for i in
                       rng.integers(0, len(vic), size=b - n_atk)])
            rng.shuffle(keys)
            yield phase, keys


def rotating_key_frames(
        rng: np.random.Generator, *, batch: int, frames: int,
        legit_keys: int = 16, attacker_frac: float = 0.75,
) -> Iterator[Tuple[str, List[str]]]:
    """Attacker keys are FRESH every frame (``rot<frame>_<i>`` — never
    repeated, never assigned to a tenant, never hh-resident); legit
    traffic rides a stable hot set."""
    legit = [f"legit{i}" for i in range(legit_keys)]
    for f in range(frames):
        n_atk = int(batch * attacker_frac)
        keys = ([f"rot{f}_{i}" for i in range(n_atk)]
                + [legit[int(i)] for i in
                   rng.integers(0, len(legit), size=batch - n_atk)])
        rng.shuffle(keys)
        yield "attack", keys


def thundering_herd_frames(
        rng: np.random.Generator, *, tenants: Dict[str, int],
        keys_per_tenant: int, bursts_per_key: int,
) -> Iterator[Tuple[str, List[str]]]:
    """One synchronized burst frame: every key of every tenant fires
    ``bursts_per_key`` requests at the same instant (the window-rollover
    herd). ``tenants`` maps name -> key count weighting is external."""
    keys = []
    for name in tenants:
        for i in range(keys_per_tenant):
            keys.extend([f"{name}_k{i}"] * bursts_per_key)
    rng.shuffle(keys)
    yield "herd", keys


# ----------------------------------------------------------------- runner


@dataclass
class ScenarioResult:
    name: str
    phases: Dict[str, dict] = field(default_factory=dict)
    extra: Dict[str, object] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"scenario": self.name, **self.phases, **self.extra}


def _effective_view(lim) -> Dict[str, int]:
    """Live effective limits with the UNLIMITED sentinel mapped to None
    (the oracle treats None as uncapped)."""
    from ratelimiter_tpu_torch.core.config import HIER_UNLIMITED

    return {scope: (None if v >= HIER_UNLIMITED else int(v))
            for scope, v in lim.effective_limits().items()}


def run_hot_tenant_storm(lim, clock, *, controller=None, batch: int = 256,
                         frames_per_phase: int = 6, window: float = 60.0,
                         seed: int = 7) -> ScenarioResult:
    """Drive the storm against ``lim`` (tenants 'attacker'/'victim' and
    their key assignments must already be registered). Phases advance
    the ManualClock past the window between them; the controller (when
    given) ticks once per frame, off the decision path."""
    rng = np.random.default_rng(seed)
    tenant_of = {f"atk{i}": "attacker" for i in range(40)}
    tenant_of.update({f"vic{i}": "victim" for i in range(8)})
    oracle = CascadeOracle(lim.config.limit, tenant_of)
    res = ScenarioResult("hot-tenant-storm")
    tally_before = FalseDenyTally()   # before the first controller move
    tally_after = FalseDenyTally()
    eff_timeline: List[int] = []
    phase_stats: Dict[str, dict] = {}
    cur_phase = None
    tick = 0.0
    for phase, keys in hot_tenant_storm_frames(
            rng, batch=batch, frames_per_phase=frames_per_phase):
        if phase != cur_phase:
            # Window (and its boundary sub-window) rolls between phases;
            # a warmup decision kicks the rollover sweep.
            clock.advance(2.5 * window)
            lim.allow("phase-warmup")
            oracle.roll()
            cur_phase = phase
            phase_stats[phase] = {"allowed": 0, "demand": 0,
                                  "victim_allowed": 0, "victim_demand": 0}
        eff = _effective_view(lim)
        out = lim.allow_batch(keys)
        got = np.asarray(out.allowed, dtype=bool)
        want = oracle.decide(keys, eff)
        # The sequential oracle is driven by ITS OWN verdicts (the
        # documented comparison basis); both sides saw the same live
        # effective limits, so a controller tighten is policy for both,
        # never a false deny.
        (tally_after if (controller is not None and controller.tightened)
         else tally_before).add(got, want)
        if controller is not None:
            controller.tick(tick)   # off the decision path, per frame
        tick += 1.0
        st = phase_stats[phase]
        vic_rows = np.array([k.startswith("vic") for k in keys])
        st["allowed"] += int(got.sum())
        st["demand"] += len(keys)
        st["victim_allowed"] += int(got[vic_rows].sum())
        st["victim_demand"] += int(vic_rows.sum())
        if controller is not None:
            eff_timeline.append(
                _effective_view(lim).get("attacker") or -1)
    for phase, st in phase_stats.items():
        st["allow_rate"] = round(st["allowed"] / max(st["demand"], 1), 4)
        st["victim_allow_rate"] = round(
            st["victim_allowed"] / max(st["victim_demand"], 1), 4)
        res.phases[phase] = st
    res.extra["false_deny_before_tighten"] = tally_before.as_dict()
    res.extra["false_deny_after_tighten"] = tally_after.as_dict()
    if controller is not None:
        ceiling = dict(lim.list_tenants())["attacker"].limit
        res.extra["controller"] = {
            "tightened": controller.tightened,
            "relaxed": controller.relaxed,
            "attacker_ceiling": ceiling,
            "attacker_effective_min": min(eff_timeline),
            "attacker_effective_final": eff_timeline[-1],
            "effective_timeline": eff_timeline,
        }
    return res


def run_rotating_key(lim, clock, *, batch: int = 256, frames: int = 8,
                     window: float = 60.0, seed: int = 11) -> ScenarioResult:
    """Rotating-key attacker vs the hh side table: fresh keys every
    frame ride the DEFAULT tenant; its ceiling + the global scope
    contain the aggregate while the stable legit set keeps serving."""
    rng = np.random.default_rng(seed)
    res = ScenarioResult("rotating-key")
    atk_allowed = atk_demand = legit_allowed = legit_demand = 0
    for _, keys in rotating_key_frames(rng, batch=batch, frames=frames):
        out = lim.allow_batch(keys)
        got = np.asarray(out.allowed, dtype=bool)
        rot = np.array([k.startswith("rot") for k in keys])
        atk_allowed += int(got[rot].sum())
        atk_demand += int(rot.sum())
        legit_allowed += int(got[~rot].sum())
        legit_demand += int((~rot).sum())
    st = lim.hierarchy_stats()
    res.extra.update({
        "attacker_admitted": atk_allowed,
        "attacker_demand": atk_demand,
        "attacker_admit_rate": round(atk_allowed / max(atk_demand, 1), 4),
        "legit_allow_rate": round(legit_allowed / max(legit_demand, 1), 4),
        "default_tenant_in_window": st["tenants"]["default"]["in_window"],
        "default_tenant_effective": st["tenants"]["default"]["effective"],
        # The containment claim, measured: aggregate admitted attacker
        # mass never exceeds the default tenant's effective limit even
        # though no single key ever hit a per-key limit.
        "contained": atk_allowed <= st["tenants"]["default"]["effective"],
    })
    return res


def run_thundering_herd(lim, clock, *, tenants: Dict[str, int],
                        keys_per_tenant: int = 16, bursts_per_key: int = 4,
                        window: float = 60.0, seed: int = 13) -> ScenarioResult:
    """Synchronized burst at a fresh window: total admitted must equal
    the global effective limit, split ~ proportionally to weights."""
    rng = np.random.default_rng(seed)
    clock.advance(2.5 * window)          # a fresh window for the herd
    lim.allow("herd-warmup")
    res = ScenarioResult("thundering-herd")
    per_tenant_allowed: Dict[str, int] = defaultdict(int)
    total_allowed = 0
    total_demand = 0
    for _, keys in thundering_herd_frames(
            rng, tenants=tenants, keys_per_tenant=keys_per_tenant,
            bursts_per_key=bursts_per_key):
        out = lim.allow_batch(keys)
        got = np.asarray(out.allowed, dtype=bool)
        total_allowed += int(got.sum())
        total_demand += len(keys)
        for k, ok in zip(keys, got):
            if ok:
                per_tenant_allowed[k.split("_k")[0]] += 1
    eff = _effective_view(lim)
    res.extra.update({
        "demand": total_demand,
        "admitted": total_allowed,
        "global_effective": eff.get("global"),
        "per_tenant_admitted": dict(sorted(per_tenant_allowed.items())),
        "weights": dict(tenants),
    })
    return res
