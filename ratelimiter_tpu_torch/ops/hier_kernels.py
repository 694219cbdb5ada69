"""The hierarchical cascade's device half — plain PyTorch versions of
``ratelimiter_tpu/ops/hier_kernels.py`` (ADR-020).

The cascade extends the sketch steps (windowed and token bucket) to
evaluate THREE nested scopes per request — key → tenant → global — with
all-or-nothing admission:

* **stage 1, key scope**: the step's own greedy in-batch admission
  (ops/segment.admit), unchanged;
* **stage 2, tenant scope**: among stage-1 survivors, greedy in-batch-
  order admission per tenant against that tenant's availability;
* **stage 3, global scope + fair share**: when the survivors' total fits
  the global availability G every survivor passes; under contention each
  ACTIVE tenant's admissible mass is clipped to ``G * weight // Σ active
  weights`` (int64 floor: the caps can only under-fill G) and survivors
  admit greedily in batch order within their tenant up to the cap.

A request is allowed iff it passes all three scopes; a denied request
consumes nothing at ANY scope (the steps recompute the key scope's
consumption under the final mask). Tenant ids derive from the sorted
key→tenant map (hierarchy/tenants.py ``host_arrays``) by the policy
table's search over the packed (h1, h2) key; misses land on tenant 0.
Quantities at the tenant and global scopes are int64 request counts.

These are the plain versions, which the CPU runs. The card runs the CUDA
routine of ``csrc/cascade.cuh`` inside the cascade builds of the three
backs on the step's path, for batches of up to
``sketch_cuda.ADMIT_CAPACITY`` requests, and these plain versions on the
card above it (the composed back; ``chip_smoke.py`` also holds the
routine alone, ``csrc/cascade_bench.cu``, to ``cascade_admit`` here).

A reference defect is kept, for bit-identity (ROADMAP C5): with at most
``_DENSE_MAX_SCOPES`` scopes (T + 1 <= 64) the reference's per-tenant
prefix sums are int32 cumsums (``_admit_dense``) that wrap once a batch's
survivor mass in one tenant passes 2^31, and the wrapped value is then
compared in int64; above 64 scopes ``segment.admit`` sums in int64.
``_tenant_admit`` keeps both (``wrap32``).

Both branches of the reference's ``lax.cond`` (uncontended / contended)
are computed and selected with ``torch.where``: each is pure, so the bits
are the reference's and no device value is read back.
"""

from __future__ import annotations

import torch

from ratelimiter_tpu_torch.ops.policy_kernels import lookup_i64, pack_halves
from ratelimiter_tpu_torch.ops.segment import _segment_exclusive_cumsum

#: Widest tenant domain (T + 1 scopes) the reference admits with its dense
#: int32 one-hot path; beyond it, ``segment.admit`` in int64.
_DENSE_MAX_SCOPES = 64


def derive_tids(hier, h1: torch.Tensor, h2: torch.Tensor,
                tenants: int) -> torch.Tensor:
    """(B,) int64 tenant ids (the reference's int32 values): the sorted
    key→tenant map ``hier["key"]``/``hier["tid"]`` searched on the packed
    (h1, h2) key, misses on tenant 0, clamped to [0, tenants - 1]."""
    idx, found = lookup_i64(hier["key"], pack_halves(h1, h2))
    tid = torch.where(found, hier["tid"][idx], 0)
    return tid.clamp(0, tenants - 1)


def scope_avail(limits: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """int64[T+1] per-scope availability: max(limit - in-window count, 0).
    ``limits`` carries the UNLIMITED sentinel for uncapped scopes."""
    return torch.clamp_min(limits - counts.to(torch.int64), 0)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits, as int64."""
    lo = x & 0xFFFFFFFF
    return torch.where(lo >= (1 << 31), lo - (1 << 32), lo)


def _tenant_admit(tid, n, avail, iters: int, wrap32: bool) -> torch.Tensor:
    """Greedy in-batch-order admission of int64 ``n`` against ``avail``
    per tenant (the reference's ``_admit_dense`` and, for wide tenant
    domains, ``segment.admit``): ``iters`` fixpoint
    rounds from "everyone consumes", then the safety intersection. The
    per-tenant exclusive prefix sums are exact int64, wrapped to int32 with
    ``wrap32`` (``_admit_dense``: its int32 cumsum wraps modulo 2^32 in
    any order of summation) or kept (``segment.admit``)."""
    order = torch.sort(tid, stable=True).indices
    s, nn, av = tid[order], n[order], avail[order]
    head = torch.ones_like(s, dtype=torch.bool)
    head[1:] = s[1:] != s[:-1]

    def cons(mask):
        c = _segment_exclusive_cumsum(torch.where(mask, nn, 0), head)
        return _wrap32(c) if wrap32 else c

    allowed = torch.ones_like(head)
    for _ in range(iters):
        allowed = cons(allowed) + nn <= av
    allowed = allowed & (cons(allowed) + nn <= av)
    out = torch.empty_like(allowed)
    out[order] = allowed
    return out


def _hist(tid, x, tenants: int) -> torch.Tensor:
    return torch.zeros(tenants + 1, dtype=torch.int64,
                       device=tid.device).index_add_(0, tid, x)


def cascade_admit(allowed_key, tid, n, avail_scopes, weights, tenants: int,
                  iters: int):
    """Stages 2+3 of the cascade over one batch.

    Args:
        allowed_key: bool[B] stage-1 (key scope) verdicts.
        tid: int64[B] tenant id per request (``derive_tids``).
        n: [B] requested amounts (request counts; any integer dtype).
        avail_scopes: int64[tenants+1] free quota per tenant, the global
            scope's at index ``tenants``.
        weights: int64[tenants+1] fair-share weights (>= 1).
        tenants: tenant capacity T (slab width - 1).
        iters: admission fixpoint iterations.

    Returns ``(allowed bool[B], hist int64[tenants+1])``: the final mask
    and the admitted-mass histogram (per tenant, global total at index
    ``tenants``)."""
    n = n.to(torch.int64)
    # The reference's _admit_scope: int32 sums up to _DENSE_MAX_SCOPES.
    dense = tenants + 1 <= _DENSE_MAX_SCOPES
    n2 = torch.where(allowed_key, n, 0)
    demand2 = _hist(tid, n2, tenants)
    total2 = demand2.sum()
    g_avail = avail_scopes[tenants]
    uncontended = ((demand2[:tenants] <= avail_scopes[:tenants]).all()
                   & (total2 <= g_avail))
    hist_u = demand2.clone()
    hist_u[tenants] = total2

    # Stage 2: tenant-scope greedy among key-scope survivors.
    a2 = _tenant_admit(tid, n2, avail_scopes[tid], iters, dense)
    surv = allowed_key & a2
    # Stage 3: weighted fair share of the global scope.
    n3 = torch.where(surv, n, 0)
    demand = _hist(tid, n3, tenants)
    total = demand.sum()
    active_w = torch.where(demand > 0, weights, 0)
    w_sum = torch.clamp_min(active_w.sum(), 1)
    share = torch.div(g_avail * weights, w_sum, rounding_mode="floor")
    cap = torch.where(total > g_avail, torch.minimum(demand, share), demand)
    a3 = _tenant_admit(tid, n3, cap[tid], iters, dense)
    allowed_c = surv & a3
    adm = torch.where(allowed_c, n, 0)
    hist_c = _hist(tid, adm, tenants)
    hist_c[tenants] += adm.sum()

    return (torch.where(uncontended, allowed_key, allowed_c),
            torch.where(uncontended, hist_u, hist_c))
