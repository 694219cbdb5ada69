"""Deterministic, seeded placement planner — a port of
``ratelimiter_tpu/placement/planner.py`` (ADR-023).

``plan_moves`` is a PURE function: (ownership map, per-bucket load
vector, liveness, frozen set, knobs, seed) → bounded migration plan.
Same inputs → byte-identical plan (``Plan.to_dict`` round-trips through
``json.dumps(..., sort_keys=True)`` to the same bytes) — the property
the determinism test pins, and the property that lets every member run
the planner independently: identical views plan identical moves, and
each member executes only the moves it donates, so no leader election
is needed. That holds across the two packages too: members of either
plan one plan, byte for byte (host NumPy float64 only, no device).

Algorithm — greedy max/mean imbalance reduction:

1. Per-host load = sum of the bucket load vector over owned buckets,
   alive hosts only. ``imbalance = max(load) / mean(load)``.
2. Hysteresis: plan only when imbalance ≥ ``trigger_ratio``; plan
   *down to* ``target_ratio`` (a strictly lower bar), so a fleet
   hovering at the trigger doesn't flap move/counter-move.
3. Up to ``max_moves`` times: pick the most-loaded alive donor and the
   least-loaded alive receiver (ties break on host id — determinism),
   and carve the donor sub-range whose mass best matches
   ``min(donor − mean, mean − receiver)``. Candidate windows are
   contiguous runs inside the donor's owned ranges that avoid frozen
   (min-residency cooldown) buckets; a move must improve projected
   imbalance by ``min_gain`` or planning stops.
4. Stop early once projected imbalance ≤ ``target_ratio``.

The planner never plans for dead hosts (failover owns that, ADR-017)
and never moves a bucket still inside its residency cooldown — the
executor stamps moved buckets, so a range settles before it is
eligible to move again (flap prevention).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ratelimiter_tpu_torch.fleet.config import FleetMap


@dataclass(frozen=True)
class PlannerKnobs:
    """Flap-prevention levers (see OPERATIONS §14)."""

    max_moves: int = 2            # move budget per planning cycle
    trigger_ratio: float = 1.4    # act only when imbalance >= this
    target_ratio: float = 1.15    # plan down toward this (hysteresis)
    min_gain: float = 0.02        # required imbalance drop per move
    window_overshoot: float = 1.25  # moved mass may exceed want by this
    min_residency_s: float = 60.0   # cooldown stamped by the executor

    def to_dict(self) -> dict:
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in asdict(self).items()}


@dataclass
class Plan:
    """A bounded migration plan; ``plan_id`` doubles as the journal
    correlation id (one id per plan, every move event carries it)."""

    plan_id: str
    epoch: int
    reason: str
    imbalance_before: float
    imbalance_projected: float
    moves: List[dict] = field(default_factory=list)
    seed: int = 0
    knobs: dict = field(default_factory=dict)
    loads_before: Dict[str, float] = field(default_factory=dict)
    loads_projected: Dict[str, float] = field(default_factory=dict)

    @property
    def corr(self) -> int:
        return int(self.plan_id, 16)

    def to_dict(self) -> dict:
        return {
            "plan_id": self.plan_id,
            "epoch": self.epoch,
            "reason": self.reason,
            "imbalance_before": self.imbalance_before,
            "imbalance_projected": self.imbalance_projected,
            "moves": list(self.moves),
            "seed": self.seed,
            "knobs": dict(self.knobs),
            "loads_before": dict(self.loads_before),
            "loads_projected": dict(self.loads_projected),
        }


def _host_loads(fmap: FleetMap, rate: np.ndarray,
                alive: Iterable[str]) -> Dict[str, float]:
    alive = set(alive)
    loads: Dict[str, float] = {}
    for h in fmap.hosts:
        if h.id not in alive:
            continue
        s = 0.0
        for lo, hi in h.ranges:
            s += float(rate[lo:hi].sum())
        loads[h.id] = s
    return loads


def _imbalance(loads: Dict[str, float]) -> float:
    if not loads:
        return 1.0
    mean = sum(loads.values()) / len(loads)
    if mean <= 0.0:
        return 1.0
    return max(loads.values()) / mean


def _segments(fmap: FleetMap, host_id: str,
              frozen: FrozenSet[int]) -> List[Tuple[int, int]]:
    """Maximal frozen-free contiguous runs inside the host's owned
    ranges — the candidate window space."""
    segs: List[Tuple[int, int]] = []
    for lo, hi in sorted(fmap.host(host_id).ranges):
        start = lo
        for b in range(lo, hi):
            if b in frozen:
                if b > start:
                    segs.append((start, b))
                start = b + 1
        if hi > start:
            segs.append((start, hi))
    return segs


def _best_window(segs: Sequence[Tuple[int, int]], rate: np.ndarray,
                 want: float, overshoot: float
                 ) -> Optional[Tuple[int, int, float]]:
    """The contiguous window whose mass best matches ``want`` without
    exceeding ``want * overshoot``. Deterministic: iterate windows in
    (lo, hi) order, strict improvement replaces — equal scores keep
    the first (lowest lo, then shortest)."""
    cap = want * overshoot
    best: Optional[Tuple[int, int, float]] = None
    best_score = None
    for lo, hi in segs:
        n = hi - lo
        # Prefix sums make every (i, j) window O(1); the donor's bucket
        # count is map-bounded (buckets ≤ a few thousand), so the O(n²)
        # scan is planner-cadence noise, never hot-path work.
        pref = np.concatenate(([0.0],
                               np.cumsum(rate[lo:hi], dtype=np.float64)))
        for i in range(n):
            for j in range(i + 1, n + 1):
                mass = float(pref[j] - pref[i])
                over = mass > cap
                if over and j > i + 1:
                    break
                # A single bucket hotter than the cap is still a
                # candidate (there is no smaller move); the planner's
                # gain check decides whether shipping it helps.
                score = abs(mass - want)
                if best_score is None or score < best_score - 1e-12:
                    best_score = score
                    best = (lo + i, lo + j, mass)
                if over:
                    break
    return best


def plan_moves(fmap: FleetMap, bucket_rate: np.ndarray, *,
               alive: Iterable[str],
               frozen: Iterable[int] = (),
               knobs: Optional[PlannerKnobs] = None,
               seed: int = 0) -> Plan:
    """Produce a bounded, deterministic migration plan. ``bucket_rate``
    is the MERGED fleet decide rate per bucket (events/s, float64);
    ``alive`` the host ids allowed to donate or receive; ``frozen``
    buckets inside their min-residency cooldown."""
    knobs = knobs or PlannerKnobs()
    rate = np.asarray(bucket_rate, dtype=np.float64)
    if rate.shape[0] != fmap.buckets:
        raise ValueError(
            f"bucket_rate has {rate.shape[0]} entries, map has "
            f"{fmap.buckets} buckets")
    frozen_set: FrozenSet[int] = frozenset(int(b) for b in frozen)
    alive_ids = sorted(set(alive) & {h.id for h in fmap.hosts})

    digest = hashlib.sha256(json.dumps({
        "map": fmap.to_dict(),
        "rate": [round(float(v), 6) for v in rate],
        "alive": alive_ids,
        "frozen": sorted(frozen_set),
        "knobs": knobs.to_dict(),
        "seed": int(seed),
    }, sort_keys=True).encode()).hexdigest()
    plan_id = digest[:16]

    loads = _host_loads(fmap, rate, alive_ids)
    imb0 = _imbalance(loads)
    plan = Plan(plan_id=plan_id, epoch=fmap.epoch, reason="planned",
                imbalance_before=round(imb0, 4),
                imbalance_projected=round(imb0, 4),
                seed=int(seed), knobs=knobs.to_dict(),
                loads_before={k: round(v, 3) for k, v in loads.items()})

    if len(loads) < 2:
        plan.reason = "single-host"
        return plan
    if imb0 < knobs.trigger_ratio:
        plan.reason = "within-band"
        return plan

    work = fmap
    cur = dict(loads)
    mean = sum(cur.values()) / len(cur)
    imb = imb0
    for _ in range(max(0, int(knobs.max_moves))):
        donor = min(cur, key=lambda h: (-cur[h], h))
        receiver = min((h for h in cur if h != donor),
                       key=lambda h: (cur[h], h))
        want = min(cur[donor] - mean, mean - cur[receiver])
        if want <= 0.0:
            plan.reason = "converged"
            break
        segs = _segments(work, donor, frozen_set)
        win = _best_window(segs, rate, want, knobs.window_overshoot)
        if win is None:
            plan.reason = "cooldown"
            break
        lo, hi, mass = win
        if mass <= 0.0:
            plan.reason = "no-eligible-mass"
            break
        nxt = dict(cur)
        nxt[donor] -= mass
        nxt[receiver] += mass
        imb_next = _imbalance(nxt)
        if imb - imb_next < knobs.min_gain:
            plan.reason = "no-gain"
            break
        work = work.move_ranges([(lo, hi)], donor, receiver)
        cur = nxt
        imb = imb_next
        plan.moves.append({"from": donor, "to": receiver,
                           "range": [int(lo), int(hi)],
                           "rate": round(mass, 3)})
        if imb <= knobs.target_ratio:
            plan.reason = "planned"
            break
    plan.imbalance_projected = round(imb, 4)
    plan.loads_projected = {k: round(v, 3) for k, v in cur.items()}
    if plan.moves and plan.reason in ("cooldown", "no-gain",
                                      "converged", "no-eligible-mass"):
        # Partial plans still execute; the reason records why planning
        # stopped short of the budget.
        plan.reason = f"planned-{plan.reason}"
    return plan
