"""Per-bucket load accounting for placement decisions (ADR-023).

The fleet router already computes ``bucket = h64 % buckets`` for every
row it routes (fleet/config.py ``owner_of_hash``); the only *new* hot
path work is two ``np.bincount`` adds into a per-host u64 slab — the
same cost model as a metrics counter increment. Everything else
(EWMA rates, imbalance, the fleet merge) happens off the decide and
forward paths, at scrape cadence.

Semantics — chosen so the FLEET-WIDE merge counts every decision
exactly once:

* **decision mass**: rows whose owner is *this* member (it decided
  them), whether they arrived directly or were forwarded to it. Summed
  across members, each decision lands in exactly one member's slab —
  the merged per-bucket vector is the true fleet decide load.
* **forward mass**: rows this member shipped to a peer (misrouted
  ingress). A row forwarded from A to B counts forward-mass at A and
  decision-mass at B; forward mass is routing pain, not extra load.

The slab is attached to every fleet member regardless of whether the
rebalancer is enabled: any planning peer needs to see everyone's load,
and the ``/healthz`` placement block + ``rate_limiter_placement_*``
families export unconditionally for fleet members.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class LoadSlab:
    """Per-bucket u64 decision/forward accumulators with lazy EWMA
    drains.

    ``note`` / ``note_one`` are the only hot-path entry points; they
    do two bounded bincount adds under a lock. ``snapshot`` drains the
    accumulators into per-bucket EWMA rates (events/s) whenever at
    least ``min_drain_s`` has elapsed — the scrape/healthz cadence is
    the drain cadence, no extra thread.
    """

    def __init__(self, buckets: int, *, ewma_halflife_s: float = 10.0,
                 min_drain_s: float = 0.25, registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if buckets <= 0:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.buckets = int(buckets)
        self.halflife = float(ewma_halflife_s)
        self.min_drain_s = float(min_drain_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._dec = np.zeros(self.buckets, dtype=np.uint64)
        self._fwd = np.zeros(self.buckets, dtype=np.uint64)
        self._dec_last = np.zeros(self.buckets, dtype=np.uint64)
        self._fwd_last = np.zeros(self.buckets, dtype=np.uint64)
        self._dec_rate = np.zeros(self.buckets, dtype=np.float64)
        self._fwd_rate = np.zeros(self.buckets, dtype=np.float64)
        self._drained_at = clock()
        self._started_at = clock()
        self._c_dec = self._c_fwd = None
        if registry is not None:
            self._c_dec = registry.counter(
                "rate_limiter_placement_decide_mass_total",
                "Rows decided by this member (placement load "
                "accounting, ADR-023)")
            self._c_fwd = registry.counter(
                "rate_limiter_placement_forward_mass_total",
                "Rows this member forwarded to a peer owner "
                "(placement load accounting, ADR-023)")

    # --------------------------------------------------------- hot path

    def note(self, buckets: np.ndarray, local: np.ndarray) -> None:
        """Account one routed frame: ``buckets`` is the int64 bucket
        index per row (already computed for routing), ``local`` the
        boolean owned-here mask per row."""
        n = int(buckets.shape[0])
        if n == 0:
            return
        nloc = int(np.count_nonzero(local))
        if nloc == n:
            dec = np.bincount(buckets, minlength=self.buckets)
            fwd = None
        elif nloc == 0:
            dec = None
            fwd = np.bincount(buckets, minlength=self.buckets)
        else:
            dec = np.bincount(buckets[local], minlength=self.buckets)
            fwd = np.bincount(buckets[~local], minlength=self.buckets)
        with self._lock:
            if dec is not None:
                self._dec += dec.astype(np.uint64)
            if fwd is not None:
                self._fwd += fwd.astype(np.uint64)
        if self._c_dec is not None and nloc:
            self._c_dec.inc(nloc)
        if self._c_fwd is not None and n - nloc:
            self._c_fwd.inc(n - nloc)

    def note_one(self, bucket: int, local: bool) -> None:
        """Scalar fast path (single-key RPCs)."""
        with self._lock:
            if local:
                self._dec[bucket] += np.uint64(1)
            else:
                self._fwd[bucket] += np.uint64(1)
        c = self._c_dec if local else self._c_fwd
        if c is not None:
            c.inc()

    # -------------------------------------------------------- cold path

    def _drain_locked(self, now: float) -> None:
        dt = now - self._drained_at
        if dt < self.min_drain_s:
            return
        d_dec = (self._dec - self._dec_last).astype(np.float64) / dt
        d_fwd = (self._fwd - self._fwd_last).astype(np.float64) / dt
        alpha = 1.0 - 0.5 ** (dt / self.halflife)
        self._dec_rate += alpha * (d_dec - self._dec_rate)
        self._fwd_rate += alpha * (d_fwd - self._fwd_rate)
        self._dec_last = self._dec.copy()
        self._fwd_last = self._fwd.copy()
        self._drained_at = now

    def snapshot(self) -> dict:
        """Drain (if due) and return the per-bucket view the planner
        and ``/healthz`` consume. Rates are EWMA events/s; totals are
        cumulative u64 (wrap-free at any realistic rate)."""
        now = self._clock()
        with self._lock:
            self._drain_locked(now)
            dec_total = int(self._dec.sum())
            fwd_total = int(self._fwd.sum())
            return {
                "buckets": self.buckets,
                "decide_total": dec_total,
                "forward_total": fwd_total,
                "decide_rate": [round(float(v), 3)
                                for v in self._dec_rate],
                "forward_rate": [round(float(v), 3)
                                 for v in self._fwd_rate],
                "halflife_s": self.halflife,
                "age_s": round(now - self._started_at, 3),
            }

    def rates(self) -> np.ndarray:
        """Drained per-bucket decide rate as float64[buckets] (a copy)."""
        now = self._clock()
        with self._lock:
            self._drain_locked(now)
            return self._dec_rate.copy()


def merge_placement(members: Dict[str, Optional[dict]]) -> dict:
    """Fleet-wide merge of per-member ``/healthz`` placement blocks
    (the ADR-021 tower calls this from ``merged_status``): sums the
    per-bucket decide/forward rates across members, carries per-member
    totals, and computes the max/mean per-host decision-load imbalance
    — the number the rebalancer drives toward 1.0.

    A member with a missing/None block is reported as a gap, never
    silently treated as idle.
    """
    buckets = 0
    for blk in members.values():
        if blk and blk.get("buckets"):
            buckets = max(buckets, int(blk["buckets"]))
    dec = np.zeros(buckets, dtype=np.float64) if buckets else None
    fwd = np.zeros(buckets, dtype=np.float64) if buckets else None
    hosts: Dict[str, dict] = {}
    gaps: List[str] = []
    for hid in sorted(members):
        blk = members[hid]
        if not blk or int(blk.get("buckets", 0)) != buckets:
            gaps.append(hid)
            continue
        dr = np.asarray(blk.get("decide_rate", ()), dtype=np.float64)
        fr = np.asarray(blk.get("forward_rate", ()), dtype=np.float64)
        if dr.shape[0] == buckets:
            dec += dr
        if fr.shape[0] == buckets:
            fwd += fr
        hosts[hid] = {
            "decide_rate": round(float(dr.sum()), 3),
            "forward_rate": round(float(fr.sum()), 3),
            "decide_total": int(blk.get("decide_total", 0)),
            "forward_total": int(blk.get("forward_total", 0)),
        }
    rates = [h["decide_rate"] for h in hosts.values()]
    mean = (sum(rates) / len(rates)) if rates else 0.0
    imbalance = (max(rates) / mean) if mean > 0 else 1.0
    return {
        "buckets": buckets,
        "hosts": hosts,
        "gaps": gaps,
        "decide_rate": [round(float(v), 3) for v in dec] if dec is not None else [],
        "forward_rate": [round(float(v), 3) for v in fwd] if fwd is not None else [],
        "imbalance": round(float(imbalance), 4),
    }
