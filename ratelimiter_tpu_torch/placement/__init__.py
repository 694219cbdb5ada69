"""Load-aware placement — a port of ``ratelimiter_tpu/placement/``
(ADR-023), accounting half.

* :mod:`accounting`: per-bucket decision/forward mass on the fleet's
  routing path at counter-increment cost (the bucket index is already
  computed for routing), drained at scrape cadence into EWMA rates.
  Observation only: decisions and wire bytes do not change.

The planner and the rebalance executor are not ported yet.
"""

from ratelimiter_tpu_torch.placement.accounting import LoadSlab, merge_placement

__all__ = [
    "LoadSlab",
    "merge_placement",
]
