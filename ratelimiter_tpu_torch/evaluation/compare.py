"""Three-way decision comparison engine (offline bench + online audit) — a
copy of ``ratelimiter_tpu/evaluation/compare.py``.

The accuracy story of this repo is one measurement made in two places:
``evaluation/accuracy.py`` runs it OFFLINE over a synthetic trace (the
BASELINE.json metric), and ``observability/audit.py`` runs it ONLINE over
a hash-sampled tap of live traffic (ADR-016). Both consume this module so
the comparison semantics — what counts as a false deny, how the CMS error
is separated from the semantic error, how a confidence interval is put on
a sampled rate — can never drift between the bench and the observatory.

Three-way comparison (each leg isolates one error source):

* live   (the system under test)   — sketch decisions, however obtained
  (an offline SketchLimiter run, or decisions mirrored off a serving
  door);
* twin   (CMS, collision-free)     — same sub-window semantics, width so
  large that collisions are negligible: live-vs-twin disagreement is
  pure CMS (collision) error;
* oracle (dense, exact)            — exact per-key semantics:
  twin-vs-oracle disagreement is the pure semantic resolution
  difference (sub-window ring vs the reference's two-window weighting).

Both the twin and the oracle are PER-KEY EXACT in the relevant sense
(the twin has no collisions, the oracle is exact), so feeding them only
a hash-coherent SAMPLE of the keyspace leaves their verdicts for the
sampled keys unchanged — that is the property that makes the online
auditor's sampled estimate unbiased (ADR-016 §2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.types import Algorithm


def wilson_interval(k: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion k/n (default 95%).

    Chosen over the normal approximation because audit sample counts are
    often small and rates are near zero — exactly where the Wald interval
    collapses to a meaningless [p, p]. Returns (0, 1) for n == 0 ("no
    evidence"), never NaN."""
    if n <= 0:
        return (0.0, 1.0)
    p = k / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (z * math.sqrt(max(p * (1.0 - p) / n + z2 / (4.0 * n * n), 0.0))
            / denom)
    return (max(0.0, center - half), min(1.0, center + half))


@dataclasses.dataclass
class ThreeWayTally:
    """Running counts of one three-way comparison stream.

    ``add`` consumes aligned boolean arrays for one batch; rates and
    Wilson bounds are derived properties so every consumer (bench JSON,
    /debug/audit, gauges) reads the same arithmetic."""

    requests: int = 0
    oracle_allows: int = 0
    oracle_denies: int = 0
    twin_allows: int = 0
    false_denies_vs_oracle: int = 0     # live denied, oracle allowed
    false_allows_vs_oracle: int = 0     # live allowed, oracle denied
    cms_false_denies_vs_twin: int = 0   # live denied, twin allowed
    semantic_disagreements: int = 0     # twin != oracle

    def add(self, live: np.ndarray, twin: Optional[np.ndarray],
            oracle: np.ndarray) -> None:
        live = np.asarray(live, dtype=bool)
        oracle = np.asarray(oracle, dtype=bool)
        self.requests += int(live.size)
        self.oracle_allows += int(oracle.sum())
        self.oracle_denies += int((~oracle).sum())
        self.false_denies_vs_oracle += int((oracle & ~live).sum())
        self.false_allows_vs_oracle += int((~oracle & live).sum())
        if twin is not None:
            twin = np.asarray(twin, dtype=bool)
            self.twin_allows += int(twin.sum())
            self.cms_false_denies_vs_twin += int((twin & ~live).sum())
            self.semantic_disagreements += int((twin != oracle).sum())

    # ----------------------------------------------------------- rates

    @property
    def false_deny_rate(self) -> float:
        """False denies over oracle allows — the BASELINE.json metric."""
        return self.false_denies_vs_oracle / max(1, self.oracle_allows)

    @property
    def false_allow_rate(self) -> float:
        return self.false_allows_vs_oracle / max(1, self.oracle_denies)

    @property
    def cms_false_deny_rate(self) -> float:
        return self.cms_false_denies_vs_twin / max(1, self.twin_allows)

    def false_deny_wilson(self, z: float = 1.96) -> Tuple[float, float]:
        return wilson_interval(self.false_denies_vs_oracle,
                               self.oracle_allows, z)

    def false_allow_wilson(self, z: float = 1.96) -> Tuple[float, float]:
        return wilson_interval(self.false_allows_vs_oracle,
                               self.oracle_denies, z)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        lo, hi = self.false_deny_wilson()
        d.update(false_deny_rate=self.false_deny_rate,
                 false_allow_rate=self.false_allow_rate,
                 cms_false_deny_rate=self.cms_false_deny_rate,
                 false_deny_wilson95=[lo, hi])
        return d


def _oracle_algorithm(base: Algorithm) -> Algorithm:
    """Exact-backend algorithm with the reference semantics for ``base``
    (TPU_SKETCH follows SLIDING_WINDOW — types.Algorithm docstring)."""
    if base is Algorithm.TOKEN_BUCKET:
        return Algorithm.TOKEN_BUCKET
    if base is Algorithm.FIXED_WINDOW:
        return Algorithm.FIXED_WINDOW
    return Algorithm.SLIDING_WINDOW


class ShadowComparator:
    """The twin + oracle pair, fed a stream of (h64, ns, now, live).

    Owns a collision-free sketch twin (the port's sketch limiter, its
    state on ``device``) and an exact oracle (the port's ExactLimiter,
    host code) built from ``config``'s limit/window/algorithm, and a
    :class:`ThreeWayTally` over everything observed. Keys are finalized u64 hashes — the oracle
    is keyed on their decimal form, which preserves decisions exactly
    (the hash is injective on the caller's key population, and both
    shadow legs are per-key exact).

    Thread model: ``decide``/``observe`` must be called from ONE thread
    (the audit worker, or the offline loop); the tally may be read from
    other threads only via a caller-owned lock (the online auditor does
    exactly that — it calls ``decide`` unlocked and folds into the tally
    under its status lock).

    Known blind spots, shared by design with the offline bench and
    documented in ADR-016: per-key policy overrides and DCN-merged
    foreign traffic are invisible to the shadow legs, so keys using
    either show up as (rare, bounded) disagreement.
    """

    def __init__(self, config: Config, *, include_twin: bool = True,
                 twin_width: Optional[int] = None,
                 oracle_capacity: int = 1 << 16, device="cuda"):
        from ratelimiter_tpu_torch.algorithms.exact import ExactLimiter
        from ratelimiter_tpu_torch.algorithms.sketch import (
            SketchLimiter,
            SketchTokenBucketLimiter,
        )

        self.config = config
        self.tally = ThreeWayTally()
        self.oracle_errors = 0
        base = dict(limit=config.limit, window=config.window, key_prefix="")
        self._twin = None
        if include_twin:
            # Collision-free twin: one row, width large enough that the
            # caller's key population cannot collide. The offline bench
            # uses 64x the sketch width; the online auditor passes a
            # width sized to the SAMPLED population (1/sample of the
            # keyspace), which is what keeps the shadow state small
            # enough to run forever (ADR-016 §3).
            width = int(twin_width if twin_width is not None
                        else max(config.sketch.width * 64, 1 << 22))
            twin_cfg = Config(
                algorithm=config.algorithm,
                sketch=dataclasses.replace(
                    config.sketch, depth=1, width=width, hh_slots=0,
                    overload_policy="warn"),
                max_batch_admission_iters=config.max_batch_admission_iters,
                **base)
            cls = (SketchTokenBucketLimiter
                   if config.algorithm is Algorithm.TOKEN_BUCKET
                   else SketchLimiter)
            self._twin = cls(twin_cfg, device=device)
        # Oracle: exact HOST semantics — bit-for-bit with the dense
        # device oracle (tests/test_cross_backend.py pins exact==dense),
        # but pure dict arithmetic: no device dispatch, no XLA compile,
        # no slot capacity, and only microseconds of GIL per audited
        # batch — which is what lets the ONLINE auditor shadow a serving
        # process without stealing its throughput (ADR-016 §3; the
        # measured A/B in the bench's live_accuracy block guards this).
        # Windowed algorithms take a further inlined u64-keyed fast path
        # (_oracle_fast — the ExactLimiter recurrence without string
        # keys, per-call locks, or Result objects; fuzz-pinned identical
        # to ExactLimiter by tests/test_audit.py); token bucket keeps
        # the ExactLimiter (heavier math, rarer audit target).
        # ``oracle_capacity`` sizes the fast path's prune sweep: past
        # ~4x it, fully-stale entries (idle > one window, both windows
        # expired — semantically identical to fresh) are dropped.
        self._oracle_cap = max(1024, int(oracle_capacity))
        oracle_alg = _oracle_algorithm(config.algorithm)
        oracle_cfg = Config(algorithm=oracle_alg, **base)
        self._oracle = ExactLimiter(oracle_cfg)
        self._fast_windowed = oracle_alg in (Algorithm.SLIDING_WINDOW,
                                             Algorithm.FIXED_WINDOW)
        self._fixed = oracle_alg is Algorithm.FIXED_WINDOW
        from ratelimiter_tpu_torch.core.clock import to_micros

        self._W_us = to_micros(config.window)
        self._limit = int(config.limit)
        self._sw_state: dict = {}

    @property
    def include_twin(self) -> bool:
        return self._twin is not None

    def _oracle_fast(self, h64: np.ndarray, ns_list, now: float) -> np.ndarray:
        """Inlined windowed-oracle batch: EXACTLY ExactLimiter's
        ``_sliding_window`` / ``_fixed_window`` integer recurrence
        (algorithms/exact.py — conditional consume, window_us-scaled
        weighting, lazy rolls) keyed on the u64 hash directly. ~1 us per
        decision vs ~5 us through the public path — the difference
        between the live auditor costing <2% and ~8% of a CPU box's
        serving throughput. Any change here must keep the fuzz pin vs
        ExactLimiter green (tests/test_audit.py)."""
        from ratelimiter_tpu_torch.core.clock import to_micros

        now_us = to_micros(now)
        W = self._W_us
        limit = self._limit
        curr_start = (now_us // W) * W
        elapsed = now_us - curr_start
        fixed = self._fixed
        state = self._sw_state
        out = np.empty(h64.shape[0], dtype=bool)
        budget = limit * W
        for i, h in enumerate(h64.tolist()):
            st = state.get(h)
            if st is None:
                curr = prev = 0
            else:
                start, curr, prev = st
                if start != curr_start:
                    if start == curr_start - W and not fixed:
                        prev, curr = curr, 0
                    else:
                        prev, curr = 0, 0
            n = ns_list[i]
            if fixed:
                ok = curr + n <= limit
            else:
                ok = (n * W
                      <= budget - prev * (W - elapsed) - curr * W)
            if ok:
                curr += n
            out[i] = ok
            state[h] = (curr_start, curr, prev)
        if len(state) > 4 * self._oracle_cap:
            # Drop fully-stale entries (both windows expired == fresh);
            # the TTL-horizon analog of ExactLimiter.prune().
            horizon = curr_start - W
            for h in [h for h, st in state.items() if st[0] < horizon]:
                del state[h]
        return out

    def update_policy(self, limit: int, window: float) -> None:
        """Follow a LIVE ``update_limit``/``update_window`` on the
        audited backend (the online auditor calls this when the serving
        config moves — without it every allow between the old and new
        limit would be scored a false allow forever). A limit change
        updates the comparison constant and both shadow legs in place;
        a window change additionally drops the fast oracle's per-key
        grid (the bucket numbering changed — keys re-learn, erring
        toward allowing for at most one window, the same convergence
        class as the documented blind spots)."""
        from ratelimiter_tpu_torch.core.clock import to_micros

        limit = int(limit)
        if limit != self._limit:
            self._limit = limit
            if self._twin is not None:
                self._twin.update_limit(limit)
            self._oracle.update_limit(limit)
        new_w = to_micros(window)
        if new_w != self._W_us:
            self._W_us = new_w
            self._sw_state.clear()
            if self._twin is not None:
                self._twin.update_window(window)
            self._oracle.update_window(window)

    def decide(self, h64: np.ndarray, ns: Optional[np.ndarray],
               now: float) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Run one batch through the oracle (and twin) WITHOUT touching
        the tally: returns (oracle_allowed, twin_allowed-or-None). The
        online auditor uses this so the device dispatches run outside
        its status lock."""
        h64 = np.asarray(h64, dtype=np.uint64)
        if ns is None:
            ns_list = [1] * int(h64.shape[0])
            ns_arr = None
        else:
            ns_arr = np.asarray(ns, dtype=np.int64)
            ns_list = [int(n) for n in ns_arr]
        twin_allowed = None
        if self._twin is not None:
            twin_allowed = self._twin.allow_hashed(h64, ns_arr,
                                                   now=now).allowed
        if self._fast_windowed:
            oracle_allowed = self._oracle_fast(h64, ns_list, now)
        else:
            # Token bucket: the ExactLimiter path. Decimal-formatted
            # hashes key its dict; idle keys prune on the reference's
            # TTL horizons.
            keys = [f"k{int(h)}" for h in h64]
            oracle_allowed = self._oracle.allow_batch(keys, ns_list,
                                                      now=now).allowed
        return oracle_allowed, twin_allowed

    def observe(self, h64: np.ndarray, ns: Optional[np.ndarray], now: float,
                live_allowed: np.ndarray) -> Tuple[np.ndarray,
                                                   Optional[np.ndarray]]:
        """decide + fold into the tally (the offline bench's loop body)."""
        oracle_allowed, twin_allowed = self.decide(h64, ns, now)
        self.tally.add(live_allowed, twin_allowed, oracle_allowed)
        return oracle_allowed, twin_allowed

    def close(self) -> None:
        if self._twin is not None:
            self._twin.close()
            self._twin = None
        self._oracle.close()
