"""Uniform hierarchy surface over N dispatch units (ADR-020), a copy of
``ratelimiter_tpu/hierarchy/fanout.py``.

The JAX serving tier mounts the cascade's management surface over one
limiter, a sliced-mesh composite, or a LIST of per-shard limiters on
its native door. ``HierarchyFanout`` normalizes the last case — and
degenerates to pure delegation for a single unit, which is how the
port's door mounts it over its one limiter — so the AIMD controller
programs against ONE object everywhere.

Semantics mirror SlicedMeshLimiter's hierarchy overrides: mutations
apply on EVERY unit (each enforces its equal share of the scope limits;
keys hash-route so the key→tenant map rows are simply present
everywhere), reads come from unit 0 (write-all keeps the tables
agreeing), and stats sum the per-unit counter slabs into the whole
deployment's in-window view.
"""

from __future__ import annotations

from typing import List, Optional


class HierarchyFanout:
    """Write-all / read-one / sum-stats over ``units`` (each any object
    exposing the RateLimiter hierarchy surface, decorated or not)."""

    def __init__(self, units: List):
        if not units:
            raise ValueError("HierarchyFanout needs at least one unit")
        self.units = list(units)

    def _all(self, fn):
        out = None
        for u in self.units:
            out = fn(u)
        return out

    # ------------------------------------------------------- mutations

    def set_tenant(self, name: str, limit: Optional[int] = None, *,
                   weight: int = 1, floor: Optional[int] = None):
        return self._all(lambda u: u.set_tenant(name, limit, weight=weight,
                                                floor=floor))

    def delete_tenant(self, name: str) -> bool:
        return bool(self._all(lambda u: u.delete_tenant(name)))

    def assign_tenant(self, key: str, tenant: str) -> None:
        self._all(lambda u: u.assign_tenant(key, tenant))

    def unassign_tenant(self, key: str) -> bool:
        return bool(self._all(lambda u: u.unassign_tenant(key)))

    def set_global_limit(self, limit: Optional[int]) -> None:
        self._all(lambda u: u.set_global_limit(limit))

    def set_effective(self, scope: str, limit: int) -> int:
        return int(self._all(lambda u: u.set_effective(scope, limit)))

    def apply_hierarchy_payload(self, payload: dict) -> bool:
        return bool(self._all(
            lambda u: u.apply_hierarchy_payload(payload)))

    # ----------------------------------------------------------- reads

    def tenant_of(self, key: str) -> str:
        return self.units[0].tenant_of(key)

    def get_tenant(self, name: str):
        return self.units[0].get_tenant(name)

    def list_tenants(self):
        return self.units[0].list_tenants()

    def effective_limits(self):
        return self.units[0].effective_limits()

    def hierarchy_payload(self) -> dict:
        return self.units[0].hierarchy_payload()

    def hierarchy_stats(self) -> dict:
        parts = [u.hierarchy_stats() for u in self.units]
        out = parts[0]
        for p in parts[1:]:
            for name, t in p["tenants"].items():
                out["tenants"][name]["in_window"] += t["in_window"]
            out["global"]["in_window"] += p["global"]["in_window"]
        return out
