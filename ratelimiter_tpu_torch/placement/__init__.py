"""Load-aware placement — a port of ``ratelimiter_tpu/placement/``
(ADR-023): the fleet's rebalancing brain. Host NumPy and plain dicts
only; the ranges it moves are restored on the members' devices by the
handoff it calls.

* :mod:`accounting`: per-bucket decision/forward mass on the fleet's
  routing path at counter-increment cost (the bucket index is already
  computed for routing), drained at scrape cadence into EWMA rates.
  Observation only: decisions and wire bytes do not change.
* :mod:`planner`: a deterministic, seeded greedy planner that turns the
  merged fleet load view into a bounded migration plan under hysteresis
  bands and a min-residency cooldown; byte-identical to the JAX
  package's for the same inputs.
* :mod:`executor`: the RebalanceController: plans execute through the
  existing ``migrate_ranges`` handoff one move at a time, with AIMD
  pacing vetoed by the observatory (SLO burn, false-deny Wilson bounds),
  journaled under one correlation id per plan.
"""

from ratelimiter_tpu_torch.placement.accounting import LoadSlab, merge_placement
from ratelimiter_tpu_torch.placement.planner import Plan, PlannerKnobs, plan_moves
from ratelimiter_tpu_torch.placement.executor import RebalanceController

__all__ = [
    "LoadSlab",
    "merge_placement",
    "Plan",
    "PlannerKnobs",
    "plan_moves",
    "RebalanceController",
]
