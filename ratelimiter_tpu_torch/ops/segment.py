"""In-batch same-key sequencing — a port of ``ratelimiter_tpu/ops/segment.py``.

A batch holding k requests for one key must behave like k sequential
calls: greedy conditional consume in batch order, denied requests
consuming nothing. The greedy recurrence is not associative, so (as in
the JAX package) it is computed by a bounded fixpoint iteration plus a
safety intersection that can under-admit in adversarial mixed-n cases but
never over-admits:

1. stable-sort requests by segment id (the key's h1);
2. from "everyone consumes", iterate
   ``allowed <- segment-exclusive-cumsum(n * allowed) + n <= avail``;
3. keep only requests that fit under the final mask's own consumption,
   intersected with that mask.

Two dtypes of quantity, as in the JAX package:

* f32 request counts (the windowed sketch). The JAX package runs the
  segment cumsum in f32 while the batch total is below 2^24 and otherwise
  in int32 through MXU limbs (``ops/scans.py``, a TPU cost trick). Both
  give the exact integer sums, so the port takes one exact int64 cumsum
  for every batch and casts the segment-relative value to f32 as the JAX
  exact path does; the comparisons that follow run in f32 exactly as there.
* int64 micro-units (the token bucket, 1 token = 10^6 units). The cumsum,
  the comparisons, ``seen`` and ``consumed`` all stay int64, exact, as the
  JAX package's integer branch. (Nothing here may promote them to a float:
  f32 would round units past 2^24 and shift ``seen`` silently.)

``ops/scans.py`` and ``ops/sortmerge.py`` are not ported: off the TPU the
reference takes the direct-gather regime.
"""

from __future__ import annotations

import torch


def _segment_exclusive_cumsum(x: torch.Tensor,
                              seg_head: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum of non-negative integer-valued ``x`` (f32 or int64)
    restarting at each segment head, in int64, returned in ``x``'s dtype.
    The global exclusive cumsum is
    non-decreasing, so the running max of its head-masked values is each
    element's segment-head value."""
    xi = x.to(torch.int64)
    c = torch.cumsum(xi, 0) - xi
    head = torch.cummax(torch.where(seg_head, c, torch.zeros_like(c)), 0).values
    return (c - head).to(x.dtype)


def admit(sid: torch.Tensor, n_units: torch.Tensor, avail_units: torch.Tensor,
          iters: int):
    """Greedy-in-batch-order admission.

    Args:
        sid: int64[B] segment id per request (only equality matters).
        n_units: [B] requested amount, integer-valued (0 = padding): f32
            request counts or int64 micro-units.
        avail_units: [B] per-request available quota, in n_units' dtype.
        iters: fixpoint iterations.

    Returns (in original request order) ``(allowed bool[B], seen [B],
    consumed [B])``, both in n_units' dtype: ``seen`` is the free quota request i sees after
    earlier allowed same-segment requests, before its own.
    """
    order = torch.sort(sid, stable=True).indices
    s = sid[order]
    nn = n_units[order]
    av = avail_units[order]
    seg_head = torch.ones_like(s, dtype=torch.bool)
    seg_head[1:] = s[1:] != s[:-1]

    allowed = torch.ones_like(seg_head)
    for _ in range(iters):
        cons = _segment_exclusive_cumsum(torch.where(allowed, nn, 0),
                                         seg_head)
        allowed = cons + nn <= av
    # Safety intersection: a subset of the last mask, checked against that
    # mask's own consumption -> never over-admits.
    cons = _segment_exclusive_cumsum(torch.where(allowed, nn, 0), seg_head)
    allowed = allowed & (cons + nn <= av)
    cons = _segment_exclusive_cumsum(torch.where(allowed, nn, 0), seg_head)
    seen = av - cons

    allowed_o = torch.empty_like(allowed)
    allowed_o[order] = allowed
    seen_o = torch.empty_like(seen)
    seen_o[order] = seen
    consumed_o = torch.where(allowed_o, n_units, 0)
    return allowed_o, seen_o, consumed_o


def segment_consumption(sid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The segment-exclusive sum of (already masked) ``x`` in original
    request order: ``cons[i]`` = the sum of ``x[j]`` for earlier j of the
    same segment, in ``x``'s dtype (the JAX package's
    ``segment.segment_consumption``). The cascade recomputes the key
    scope's consumption under its final mask with it."""
    order = torch.sort(sid, stable=True).indices
    s = sid[order]
    seg_head = torch.ones_like(s, dtype=torch.bool)
    seg_head[1:] = s[1:] != s[:-1]
    cons = _segment_exclusive_cumsum(x[order], seg_head)
    out = torch.empty_like(cons)
    out[order] = cons
    return out
