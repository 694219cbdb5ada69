"""Hierarchical cascades + adaptive control (ADR-020), a port of
``ratelimiter_tpu/hierarchy/``.

``tenants``    — the host-authoritative tenant registry + key→tenant map
                 (the cascade's control plane; device half in
                 ops/hier_kernels.py and the backs' cascade builds).
``controller`` — the AIMD loop: tightens/relaxes *effective* scope
                 limits off the cascade's own in-window counters (and
                 the SLO/audit signals when a caller supplies them).
``fanout``     — write-all/read-one/sum-stats facade over the door's
                 dispatch units (the serving mount).
"""

from ratelimiter_tpu_torch.hierarchy.controller import AIMDController, AIMDGains
from ratelimiter_tpu_torch.hierarchy.fanout import HierarchyFanout
from ratelimiter_tpu_torch.hierarchy.tenants import GLOBAL, Tenant, TenantTable

__all__ = [
    "AIMDController",
    "AIMDGains",
    "GLOBAL",
    "HierarchyFanout",
    "Tenant",
    "TenantTable",
]
