"""The DCN tier: cross-pod exchange of completed sub-window slabs and
debt deltas — the port of ``ratelimiter_tpu/parallel/dcn.py``.

A pod's mesh stays coherent through its own collectives; across pods
(regions) a per-step collective is unaffordable. The unit of exchange is
the **completed sub-window slab**: once the rollover flushes a
sub-window, that (d, w) slab is fixed local history, so pods ship those
slabs over any transport and fold them into each other's rings.

Consistency contract (tests/test_torch_dcn.py holds it to the JAX
package's):

* a key's traffic on pod A is invisible to pod B until the sub-window
  holding it completes and a sync runs: cross-pod over-admission is
  bounded by ``n_pods x limit`` per (sub-window + sync cadence);
* after a sync every pod's estimate includes every pod's completed
  traffic, and expiry needs no coordination (slabs age out of each ring
  by the same period arithmetic everywhere);
* exports carry local traffic only: foreign slabs merged into a period
  are recorded (``_foreign_record``) and subtracted at export, so no
  topology echoes a peer's traffic back to it.

The token bucket exchanges **debt deltas**: every step adds its local
debt increments to ``acc``, an export snapshots and zeroes it, and a
merge adds a foreign delta to ``debt`` alone, so foreign traffic never
re-exports. A delta that lands ``dt`` after its traffic missed ``dt`` of
refill: an over-count (extra denies) bounded by ``rate x dt``.

Where the work runs: the state stays on the limiter's device. Every
merge is torch ops there, enqueued under ``lim._lock`` on the current
stream (the default stream: the port sets no other), so it lands after
every launch enqueued before it and ahead of every launch after it, as
the JAX limiter's lock orders its donated buffers. An export reads the
ring's periods under the lock (one small copy to the host, which waits
for the launches before it), builds the exported slabs on the device
(the foreign record subtracted, the side table folded in) and copies
them, and only them, to the host after the lock is released; the debt
export snapshots and zeroes ``acc`` on the device the same way. The
foreign record itself is kept on the device, one int64 (d, w) tensor a
period in the live window.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ratelimiter_tpu_torch.algorithms.sketch import (
    SketchLimiter,
    SketchTokenBucketLimiter,
)
from ratelimiter_tpu_torch.core.clock import to_micros
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.ops import sketch_kernels
from ratelimiter_tpu_torch.ops.bucket_cuda import DEBT_CAP

#: The watermark "before everything".
NEVER_EXPORTED = -(1 << 62)


def _check(lim) -> None:
    if isinstance(lim, SketchTokenBucketLimiter):
        raise InvalidConfigError(
            "slab exchange applies to windowed sketch limiters; token "
            "buckets exchange debt deltas (export_debt/merge_debt)")


def _check_bucket(lim, what: str) -> None:
    if not isinstance(lim, SketchTokenBucketLimiter):
        raise InvalidConfigError(
            f"{what} needs a SketchTokenBucketLimiter; windowed limiters "
            f"exchange completed slabs (export_completed/merge_completed)")


# ---------------------------------------------------------- token bucket

def export_debt(lim: SketchTokenBucketLimiter) -> np.ndarray:
    """Snapshot-and-zero the pod's accumulated local debt increments:
    int64[d, w] micro-token deltas since the previous export. Merges add
    to ``debt`` only, so an export carries local traffic alone."""
    _check_bucket(lim, "export_debt")
    with lim._lock:
        acc = lim._state["acc"]
        snap = acc.clone()
        acc.zero_()
    return snap.cpu().numpy()


def restore_debt(lim: SketchTokenBucketLimiter, delta: np.ndarray) -> None:
    """Give an exported but undelivered delta back to the accumulator, so
    the next cycle ships it again (the push transport does this when
    every push of a cycle fails)."""
    _check_bucket(lim, "restore_debt")
    dev = torch.from_numpy(np.ascontiguousarray(delta, dtype=np.int64)
                           ).to(lim.device)
    with lim._lock:
        lim._state["acc"].add_(dev).clamp_max_(DEBT_CAP)


def merge_debt(lim: SketchTokenBucketLimiter, delta: np.ndarray) -> int:
    """Add a foreign pod's debt delta to the local slab (clamped at the
    overflow cap) and return the count of nonzero cells applied.
    Negative cells (corruption, or a forged frame: a negative merge
    would erase real debt) are clamped to 0 first. ``last`` moves to the
    receiver's now, so an idle pod does not decay the merged debt over
    its idle gap on its next step (less decay: the deny direction)."""
    _check_bucket(lim, "merge_debt")
    shape = tuple(lim._state["debt"].shape)
    if delta.shape != shape:
        raise InvalidConfigError(
            f"debt delta shape {delta.shape} != sketch geometry {shape}")
    delta = np.maximum(delta, 0)
    nz = int(np.count_nonzero(delta))
    if nz == 0:
        return 0
    now_us = to_micros(lim.clock.now())
    dev = torch.from_numpy(np.ascontiguousarray(delta, dtype=np.int64)
                           ).to(lim.device)
    with lim._lock:
        lim._state["debt"].add_(dev).clamp_max_(DEBT_CAP)
        last = lim._state["last"]
        last.fill_(max(int(last), now_us))
    return nz


# ------------------------------------------------------- windowed sketch

def _foreign_record(lim: SketchLimiter, last: int, SW: int
                    ) -> Dict[int, torch.Tensor]:
    """Per-period record of the foreign mass merged into the local ring
    (int64 (d, w) tensors on the limiter's device, attached lazily,
    pruned to the live window). Lock must be held.

    Under an asynchronous push transport a peer's merge can land in a
    slab before this pod exports that period; re-exporting the raw slab
    would echo the peer's own traffic back to it (a steady double count,
    the effective limit about halved). Exports subtract the record."""
    rec = getattr(lim, "_dcn_foreign", None)
    if rec is None:
        rec = {}
        lim._dcn_foreign = rec
    for q in [q for q in rec if q < last - SW]:
        del rec[q]
    return rec


def _ring_periods(lim: SketchLimiter) -> Tuple[List[int], int]:
    """(slab_period as a list, last_period), read from the device. Lock
    must be held: the copy waits for every launch enqueued before it."""
    st = lim._state
    both = torch.cat([st["slab_period"], st["last_period"].view(1)]).cpu()
    vals = both.tolist()
    return vals[:-1], vals[-1]


def export_completed(lim: SketchLimiter, after_period: int,
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(periods int64[k], slabs int32[k, d, w], last_period): every
    completed sub-window with period > ``after_period`` still in the
    ring, and the pod's current period. The caller's next watermark is
    ``last_period - 1``, not the largest period exported, so a period
    that completes (or takes a foreign merge) after this export still
    ships next cycle. The slabs carry local traffic only (the foreign
    record is subtracted, clamped at 0).

    With the heavy-hitter side table a promoted key's traffic sits in its
    private per-period cell, not the sketch, so each exported slab folds
    that period's side-table row back in: each owner's count added at
    its columns ``(owner + r * owner2) & (w - 1)``, the (h1, h2) pair
    captured at claim time. Slots without ``hh_owner2`` (restored from
    snapshots older than it) are skipped: their traffic stays local."""
    _check(lim)
    _, _, SW, S, _ = sketch_kernels.sketch_geometry(lim.config)
    d, w = lim.config.sketch.depth, lim.config.sketch.width
    with lim._lock:
        sp, last = _ring_periods(lim)
        rec = _foreign_record(lim, last, SW)
        # In-window completed periods only: [last - SW, last - 1]; this
        # also leaves out the _NEVER slab the first rollover flushes.
        take = sorted((p, slot) for slot, p in enumerate(sp)
                      if after_period < p < last and p >= last - SW)
        if not take:
            return (np.empty(0, np.int64), np.empty((0, d, w), np.int32),
                    last)
        st = lim._state
        slots = torch.tensor([slot for _, slot in take], dtype=torch.int64,
                             device=lim.device)
        out = st["slabs"].index_select(0, slots)
        for i, (per, _slot) in enumerate(take):
            f = rec.get(per)
            if f is not None:
                out[i] = torch.clamp_min(out[i].to(torch.int64) - f, 0
                                         ).to(torch.int32)
        if "hh_owner" in st:
            _fold_side_table(st, out, slots, d, w)
    periods = np.array([p for p, _ in take], dtype=np.int64)
    return periods, out.cpu().numpy(), last


def _fold_side_table(st: dict, out: torch.Tensor, slots: torch.Tensor,
                     d: int, w: int) -> None:
    """Add each exported slot's side-table row into ``out`` (k, d, w) at
    its owners' columns: an int32 scatter-add per row, owners with no
    ``hh_owner2`` or no count skipped."""
    owner, owner2 = st["hh_owner"], st["hh_owner2"]
    rows = st["hh_slabs"].index_select(0, slots)             # (k, K)
    mask = (owner != 0) & (owner2 != 0) & (rows > 0)         # (k, K)
    k_idx, slot_idx = mask.nonzero(as_tuple=True)
    if k_idx.numel() == 0:
        return
    cnt = rows[k_idx, slot_idx]
    o1, o2 = owner[slot_idx], owner2[slot_idx]
    flat = out.view(-1)
    for r in range(d):
        cols = (o1 + r * o2) & (w - 1)
        flat.index_add_(0, k_idx * (d * w) + r * w + cols, cnt)


def merge_completed(lim: SketchLimiter, periods: np.ndarray,
                    slabs: np.ndarray) -> Tuple[int, int]:
    """Fold foreign completed slabs into the local ring; returns
    (applied_count, max_applied_period).

    The limiter first rolls itself to its own clock: the exporter ships
    only periods its clock completed and advances its watermark on
    delivery, so a lagging ring would drop such a period for good. Then,
    per period p (local slot p mod S):

    * p >= the local current period: dropped (not completed here);
    * the slot holds p: the slabs add (another pod's share of it);
    * the slot holds an older period: the foreign slab replaces it (the
      old content is out of the window);
    * the slot holds a newer period: dropped (the foreign data expired).

    Negative cells are clamped to 0 (a bad peer must not subtract
    history). ``totals`` is rebuilt as the in-window slabs plus ``cur``
    (an int32 masked sum that wraps as the JAX package's int32
    ``tensordot`` does), so estimates see the merged history at once."""
    _check(lim)
    if periods.shape[0] == 0:
        return 0, -(1 << 62)
    _, _, SW, S, _ = sketch_kernels.sketch_geometry(lim.config)
    # Clamped on the host (a new array: the caller's, often a view of
    # the frame, stays as it was) and staged before the lock.
    foreign = torch.from_numpy(np.maximum(slabs, 0).astype(
        np.int32, copy=False)).to(lim.device)
    applied = 0
    max_applied = -(1 << 62)
    with lim._lock:
        lim._sync_period(to_micros(lim.clock.now()))
        sp, last = _ring_periods(lim)
        rec = _foreign_record(lim, last, SW)
        st = lim._state
        for i, p in enumerate(int(x) for x in periods.tolist()):
            if p >= last:
                continue
            slot = p % S
            cur_p = sp[slot]
            slab = foreign[i]
            if cur_p == p:
                st["slabs"][slot].add_(slab)
                prev = rec.get(p)
                rec[p] = (slab.to(torch.int64) if prev is None
                          else prev + slab)
            elif cur_p < p:
                st["slabs"][slot].copy_(slab)
                st["slab_period"][slot] = p
                sp[slot] = p
                # The whole slot is foreign now.
                rec[p] = slab.to(torch.int64)
            else:
                continue
            applied += 1
            max_applied = max(max_applied, p)
        if applied:
            spt = st["slab_period"]
            in_window = (spt >= last - SW + 1) & (spt <= last - 1)
            st["totals"].copy_(sketch_kernels._masked_sum(st["slabs"],
                                                          in_window)
                               + st["cur"])
    return applied, max_applied


class DcnMirrorGroup:
    """In-process mirror of a multi-pod deployment: N sketch limiters (the
    pods), synced by exchanging completed slabs (windowed) or debt deltas
    (token bucket). The harness of the tests and of the card's checks;
    serving/dcn_peer.py runs the same calls over the binary protocol
    between processes."""

    def __init__(self, pods: Sequence[SketchLimiter]):
        if not pods:
            raise InvalidConfigError("DcnMirrorGroup needs >= 1 pod")
        kinds = {isinstance(p, SketchTokenBucketLimiter) for p in pods}
        if len(kinds) != 1:
            raise InvalidConfigError(
                "all pods must run the same algorithm family (all "
                "windowed or all token bucket)")
        self._bucket = kinds.pop()
        if self._bucket:
            fp = {(p.config.limit, float(p.config.window),
                   p.config.sketch.depth, p.config.sketch.width,
                   p.config.sketch.seed, p.config.prefix) for p in pods}
        else:
            for p in pods:
                _check(p)
            fp = {sketch_kernels.sketch_geometry(p.config)
                  + (p.config.sketch.depth, p.config.sketch.width,
                     p.config.sketch.seed, p.config.prefix)
                  for p in pods}
        if len(fp) != 1:
            raise InvalidConfigError(
                "all pods must share algorithm geometry AND hashing "
                "(window, sub-windows, limit, depth, width, seed, "
                "prefix) — mismatched seeds would merge counts into "
                "other keys' cells")
        self.pods: List[SketchLimiter] = list(pods)
        self._exported_up_to: Dict[int, int] = {
            i: NEVER_EXPORTED for i in range(len(pods))}

    def sync(self) -> int:
        """One exchange cycle: export every pod's new local history, then
        merge everything into everyone else. Returns the number of
        applications (slabs, or nonzero delta cells) across the group."""
        if self._bucket:
            deltas = [export_debt(p) for p in self.pods]
            applied = 0
            for i, pod in enumerate(self.pods):
                for j, delta in enumerate(deltas):
                    if i != j:
                        applied += merge_debt(pod, delta)
            return applied
        exports = []
        for i, pod in enumerate(self.pods):
            periods, slabs, last = export_completed(
                pod, self._exported_up_to[i])
            # Everything completed as of this export: this cycle's merges
            # touch only periods at or below it, so nothing foreign
            # re-exports.
            self._exported_up_to[i] = max(self._exported_up_to[i], last - 1)
            exports.append((periods, slabs))
        applied = 0
        for i, pod in enumerate(self.pods):
            for j, (periods, slabs) in enumerate(exports):
                if i == j or periods.shape[0] == 0:
                    continue
                applied += merge_completed(pod, periods, slabs)[0]
        return applied
