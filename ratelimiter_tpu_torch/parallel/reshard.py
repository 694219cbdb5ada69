"""Elastic re-bucketing: per-slice limiter state split or merged onto a
new slice count — the port of ``ratelimiter_tpu/parallel/reshard.py``,
host NumPy over captured or snapshot arrays (the JAX package's layout,
which the port's snapshots share byte for byte), so its output for a
snapshot equals the JAX package's.

The slice router is ``owner = h64 % n_slices``, so a new slice count
re-partitions the keyspace. Every slice shares one (d, w) geometry and
one column rule, so a key sits in the same cells whichever slice owns
it, and re-bucketing is cell arithmetic:

* **contributors**: by the CRT, a hash with ``h % N == i`` and
  ``h % M == j`` exists iff ``i == j (mod gcd(N, M))``, so new slice
  ``j``'s keys came from the old slices ``{i : i == j (mod g)}``. A clean
  split (``N | M``) has one contributor (a verbatim copy), a clean merge
  (``M | N``) folds ``N/M``, a coprime resize folds all of them;
* **conservative union**: the merged cell is the elementwise max over
  the contributors, so a key's estimate can only rise (extra denies,
  never over-admission); the contributors' key sets are disjoint, so the
  max is the tightest sound union;
* **period alignment**: ring slabs are matched by their absolute
  ``slab_period`` before the max; the merged ring re-anchors at the
  newest contributor's period and ``totals`` is recomputed as the
  rollover computes it;
* **heavy hitters**: every live side-table entry is folded back into
  its sketch columns first (the DCN exporter's scatter-add,
  parallel/dcn.py) and the merged table starts empty; entries without
  ``hh_owner2`` cannot be folded and are dropped;
* **token bucket**: debt normalizes to the newest contributor's
  timestamp by the exact integer decay (skipped without a config:
  debt only overstates), then the elementwise max; the decay remainder
  resets and the DCN accumulator zeroes on a true merge;
* **overrides**: the write-all override tables union by key, exactly.

Identical contributors (the merge leg of a split-then-merge round trip)
copy verbatim, so ``N -> k*N -> N`` is bit-identical. The live restore
(``SlicedMeshLimiter.restore``/``restore_slice``) and the offline tool
(``python -m ratelimiter_tpu_torch.tools.rebucket``) share this code.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.errors import CheckpointError
from ratelimiter_tpu_torch.ops.sketch_kernels import _NEVER

Arrays = Dict[str, np.ndarray]


# ------------------------------------------------------------ routing math

def contributors(j: int, old_n: int, new_n: int) -> List[int]:
    """Old slices whose key sets intersect new slice ``j`` (CRT rule)."""
    g = math.gcd(old_n, new_n)
    return [i for i in range(old_n) if i % g == j % g]


# --------------------------------------------------------------- helpers

_POLICY_KEYS = ("policy_keys", "policy_limits", "policy_scales")


def _copy(arrays: Arrays) -> Arrays:
    return {k: np.array(v, copy=True) for k, v in arrays.items()}


def _pop_policy(arrays: Arrays) -> Dict[str, tuple]:
    """Remove the ``policy_*`` columns, returning {key: (limit, scale)}."""
    keys = arrays.pop("policy_keys", None)
    limits = arrays.pop("policy_limits", None)
    scales = arrays.pop("policy_scales", None)
    if keys is None or keys.shape[0] == 0:
        return {}
    return {str(k): (int(li), float(sc))
            for k, li, sc in zip(keys, limits, scales)}


def _policy_arrays(table: Dict[str, tuple]) -> Arrays:
    items = sorted(table.items())
    return {
        "policy_keys": np.array([k for k, _ in items], dtype=str),
        "policy_limits": np.array([v[0] for _, v in items], dtype=np.int64),
        "policy_scales": np.array([v[1] for _, v in items],
                                  dtype=np.float64),
    }


def _merge_policy(tables: Sequence[Dict[str, tuple]]) -> Dict[str, tuple]:
    """Union keyed by override key. Tables are write-all replicas
    (parallel/limiter.py), so entries agree; if they ever diverged
    (e.g. a slice restored from an older snapshot), the last table —
    the newest contributor's — wins, matching live write-all order."""
    out: Dict[str, tuple] = {}
    for t in tables:
        out.update(t)
    return out


def _identical(states: Sequence[Arrays]) -> bool:
    first = states[0]
    for other in states[1:]:
        if set(other) != set(first):
            return False
        for k in first:
            a, b = first[k], other[k]
            if a.shape != b.shape or not np.array_equal(a, b):
                return False
    return True


def _km_cols(o1: np.ndarray, o2: np.ndarray, r: int, w: int) -> np.ndarray:
    """Kirsch-Mitzenmacher CMS columns for row ``r``: the DCN exporter's
    rule (parallel/dcn.export_completed) and the kernels' columns."""
    return ((o1.astype(np.uint64) + np.uint64(r) * o2.astype(np.uint64))
            & np.uint64(w - 1)).astype(np.int64)


# ------------------------------------------------------- windowed sketch

def _fold_hh(a: Arrays) -> Arrays:
    """Fold the heavy-hitter side table's private counts back into the
    CMS ring (scatter-add at each owner's columns), returning a state
    whose hh table is empty. Sound in one direction only: folding can
    inflate OTHER keys' estimates (collisions), never deflate the folded
    key's own — extra denies at worst."""
    if "hh_owner" not in a or not (a["hh_owner"] != 0).any():
        return a
    a = dict(a)
    d, w = a["cur"].shape
    S = a["slabs"].shape[0]
    owner = np.asarray(a["hh_owner"])
    owner2 = np.asarray(a["hh_owner2"])
    valid = (owner != 0) & (owner2 != 0)
    last = int(a["last_period"])
    slab_period = np.asarray(a["slab_period"])
    slabs = np.array(a["slabs"], copy=True)
    cur = np.array(a["cur"], copy=True)
    hh_slabs = np.asarray(a["hh_slabs"])          # (S, K)
    hh_cur = np.asarray(a["hh_cur"])
    hh_last = np.asarray(a["hh_last"])
    for slot in range(S):
        if int(slab_period[slot]) == _NEVER:
            continue
        row = hh_slabs[slot]
        m = valid & (row > 0)
        if m.any():
            cnt = row[m].astype(np.int32)
            for r in range(d):
                np.add.at(slabs[slot][r],
                          _km_cols(owner[m], owner2[m], r, w), cnt)
    # The current period's private counts: only slots whose validity
    # stamp IS the current period hold live mass there (stale slots'
    # in-window history was folded from the ring above).
    m = valid & (hh_cur > 0) & (hh_last == last)
    if m.any():
        cnt = hh_cur[m].astype(np.int32)
        for r in range(d):
            np.add.at(cur[r], _km_cols(owner[m], owner2[m], r, w), cnt)
    K = owner.shape[0]
    a.update({
        "cur": cur, "slabs": slabs,
        "hh_owner": np.zeros(K, np.uint32),
        "hh_owner2": np.zeros(K, np.uint32),
        "hh_cur": np.zeros(K, np.int32),
        "hh_slabs": np.zeros((S, K), np.int32),
        "hh_totals": np.zeros(K, np.int32),
        "hh_last": np.full(K, _NEVER, np.int64),
    })
    return a


def _merge_windowed(states: Sequence[Arrays],
                    extras: Sequence[dict]) -> Tuple[Arrays, dict]:
    """Conservative union of windowed-sketch states (disjoint key sets):
    align ring slabs by absolute period, elementwise max, re-anchor at
    the newest contributor period, recompute totals like the rollover
    kernel."""
    if _identical(states):
        out = _copy(states[0])
        return out, dict(extras[0])
    folded = [_fold_hh(s) for s in states]
    live = [s for s in folded if int(s["last_period"]) != _NEVER]
    if not live:
        out = _copy(folded[0])
        return out, dict(extras[0])
    d, w = folded[0]["cur"].shape
    S = folded[0]["slabs"].shape[0]
    SW = S
    P = max(int(s["last_period"]) for s in live)
    by_period: Dict[int, np.ndarray] = {}

    def fold_period(p: int, slab: np.ndarray) -> None:
        if p < P - SW or not slab.any():
            return
        have = by_period.get(p)
        by_period[p] = (np.array(slab, copy=True) if have is None
                        else np.maximum(have, slab))

    for s in live:
        fold_period(int(s["last_period"]), np.asarray(s["cur"]))
        sp = np.asarray(s["slab_period"])
        for slot in range(S):
            p = int(sp[slot])
            if p != _NEVER:
                fold_period(p, np.asarray(s["slabs"][slot]))
    cur = by_period.pop(P, None)
    slabs = np.zeros((S, d, w), np.int32)
    slab_period = np.full(S, _NEVER, np.int64)
    # ``totals`` is the live running window total the estimate reads
    # (totals + frac * boundary): the step maintains it in-place to
    # INCLUDE the current period's ``cur`` mass, and each rollover
    # recomputes it as flushed in-window slabs. Mirror that invariant:
    # in-window flushed periods [P-SW+1, P-1] plus the current period.
    totals = np.zeros((d, w), np.int32)
    if cur is not None:
        totals += cur
    for p, slab in by_period.items():
        slot = p % S
        # Periods in (P-SW, P-1] occupy distinct slots; the boundary
        # period P-SW shares P's slot and P lives in ``cur``, so the
        # ring can hold it — exactly the live layout after a rollover.
        slabs[slot] = slab
        slab_period[slot] = p
        if P - SW + 1 <= p <= P - 1:
            totals += slab
    out = dict(folded[0])
    out.update({
        "cur": (cur if cur is not None else np.zeros((d, w), np.int32)),
        "slabs": slabs,
        "totals": totals,
        "slab_period": slab_period,
        "last_period": np.asarray(P, np.int64),
    })
    extra = dict(extras[0])
    extra["saved_at"] = max(float(e.get("saved_at", 0.0)) for e in extras)
    extra["host_period"] = P
    return out, extra


# ---------------------------------------------------------- token bucket

def _bucket_rate(config) -> Tuple[int, int]:
    from ratelimiter_tpu_torch.ops import bucket_kernels

    params = bucket_kernels._params(config)
    return params["rate_num"], params["rate_den"]


def _decay_exact(elapsed_us: int, rem: int, num: int, den: int) -> int:
    """Exact host-integer mirror of bucket_kernels._decay (scalar)."""
    cap = 1 << 61  # bucket_kernels._DEBT_CAP
    e_q = elapsed_us // den
    acc = (elapsed_us - e_q * den) * num + rem
    e_q = min(e_q, cap // num)
    return e_q * num + acc // den


def _merge_bucket(states: Sequence[Arrays], extras: Sequence[dict],
                  config=None) -> Tuple[Arrays, dict]:
    """Conservative union of debt-sketch states: normalize each debt
    slab to the newest contributor timestamp (exact decay mirror; with
    no config the decay is skipped — debt only overstates, toward
    denying), elementwise max, remainder reset, accumulator zeroed (a
    merged ``acc`` could re-ship traffic a DCN peer already merged)."""
    if _identical(states):
        out = _copy(states[0])
        return out, dict(extras[0])
    t_star = max(int(s["last"]) for s in states)
    rate = _bucket_rate(config) if config is not None else None
    debts = []
    for s in states:
        debt = np.asarray(s["debt"], np.int64)
        if rate is not None:
            elapsed = t_star - int(s["last"])
            if elapsed > 0:
                dec = _decay_exact(elapsed, int(s["rem"]), *rate)
                debt = np.maximum(debt - dec, 0)
        debts.append(debt)
    merged = debts[0]
    for dbt in debts[1:]:
        merged = np.maximum(merged, dbt)
    out = dict(states[0])
    out.update({
        "debt": merged.astype(np.int64),
        "acc": np.zeros_like(np.asarray(states[0]["acc"])),
        "rem": np.asarray(0, np.int64),
        "last": np.asarray(t_star, np.int64),
    })
    extra = dict(extras[0])
    extra["saved_at"] = max(float(e.get("saved_at", 0.0)) for e in extras)
    return out, extra


# ---------------------------------------------------------- public seams

def merge_states(states: Sequence[Arrays], extras: Sequence[dict],
                 config=None) -> Tuple[Arrays, dict]:
    """Conservative union of k single-slice states (policy columns
    included) into one: the building block of re-bucketing merges and
    of ``merge_into_limiter``."""
    states = [dict(s) for s in states]
    tables = [_pop_policy(s) for s in states]
    if "debt" in states[0]:
        out, extra = _merge_bucket(states, extras, config)
    else:
        out, extra = _merge_windowed(states, extras)
    out.update(_policy_arrays(_merge_policy(tables)))
    return out, extra


def merge_into_limiter(lim, src_arrays: Arrays, src_extra: dict) -> None:
    """Fold ``src_arrays`` (a captured/snapshot single-unit state) into a
    LIVE limiter by conservative union (the JAX fleet's hand-off of a
    key range into an already-mounted unit). The result serves
    both key sets with the never-under-count guarantee; collisions
    between the two populations can only add denies."""
    _, dst_arrays, dst_extra = lim.capture_state()
    merged, extra = merge_states(
        [dst_arrays, dict(src_arrays)], [dst_extra, dict(src_extra)],
        lim.config)
    lim.restore_state(merged, extra)


def rebucket(slice_states: Sequence[Arrays], slice_extras: Sequence[dict],
             new_n: int, config=None,
             ) -> Tuple[List[Arrays], List[dict]]:
    """Re-bucket ``old_n`` per-slice states onto ``new_n`` slices. A
    single-contributor slice (clean split) copies verbatim — so
    ``N -> k*N -> N`` round-trips bit-identically; multi-contributor
    slices take the conservative union."""
    old_n = len(slice_states)
    if new_n < 1:
        raise CheckpointError(f"rebucket needs new_n >= 1, got {new_n}")
    out_states: List[Arrays] = []
    out_extras: List[dict] = []
    for j in range(new_n):
        contrib = contributors(j, old_n, new_n)
        if len(contrib) == 1:
            out_states.append(_copy(slice_states[contrib[0]]))
            out_extras.append(dict(slice_extras[contrib[0]]))
        else:
            merged, extra = merge_states(
                [slice_states[i] for i in contrib],
                [slice_extras[i] for i in contrib], config)
            out_states.append(merged)
            out_extras.append(extra)
    return out_states, out_extras


def split_combined(arrays: Arrays, meta: dict,
                   ) -> Tuple[List[Arrays], List[dict]]:
    """Per-slice (arrays, extras) from a combined mesh snapshot's
    ``slice{i}:``-prefixed form."""
    n = int(meta.get("n_slices", -1))
    if n < 1:
        raise CheckpointError(
            f"combined snapshot carries no n_slices (got {n})")
    extras = meta.get("slice_extras") or [{}] * n
    states = []
    for i in range(n):
        prefix = f"slice{i}:"
        states.append({k[len(prefix):]: v for k, v in arrays.items()
                       if k.startswith(prefix)})
    return states, list(extras)


def join_combined(states: Sequence[Arrays], extras: Sequence[dict],
                  meta: dict) -> Tuple[Arrays, dict]:
    """Inverse of :func:`split_combined` (new slice count from the
    state list)."""
    arrays: Arrays = {}
    for i, s in enumerate(states):
        arrays.update({f"slice{i}:{k}": v for k, v in s.items()})
    out_meta = dict(meta)
    out_meta["n_slices"] = len(states)
    out_meta["slice_extras"] = list(extras)
    return arrays, out_meta


def rebucket_combined(arrays: Arrays, meta: dict, new_n: int, config=None,
                      ) -> Tuple[Arrays, dict]:
    """Re-bucket a combined mesh snapshot (the ``slice{i}:`` form) onto
    ``new_n`` slices — the live ``SlicedMeshLimiter.restore`` seam."""
    states, extras = split_combined(arrays, meta)
    new_states, new_extras = rebucket(states, extras, new_n, config)
    out, out_meta = join_combined(new_states, new_extras, meta)
    out_meta["rebucketed_from"] = int(meta.get("n_slices", len(states)))
    return out, out_meta
