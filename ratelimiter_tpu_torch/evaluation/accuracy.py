"""False-deny evaluation harness (BASELINE.json metric) — a port of
``ratelimiter_tpu/evaluation/accuracy.py``.

The north-star accuracy number: on a Zipf(1.1) trace over ~1M keys, the
sketch backend must produce <= 1% false-positive *denies* versus the exact
sliding-window oracle (the stand-in for the reference's Redis sliding window,
SURVEY.md §4.3). Error direction: ops/segment.admit never over-admits
against the *estimate*, and with vanilla (non-conservative) updates CMS
estimates only err upward, so over-admission versus the sketch's own
semantics is impossible in that configuration. With
``conservative_update=True`` (the flagship bench config) the guarantee is
weaker: CU writes raise a cell only to the largest single-key target, so a
cell can undercount colliding traffic once boundary slabs holding part of a
CU write expire — a small, *measured* false-allow risk (BENCH_r02:
``false_allow_rate_vs_oracle ~= 2e-8``), traded for a large false-deny
reduction. Allow-where-oracle-denied events therefore combine that CU
effect with the *semantic* difference between sub-window-ring sliding and
the reference's two-window weighting; the three-way comparison separates
the CMS-error component from the semantic component.

The comparison core itself (sketch vs collision-free twin vs exact
oracle, tally arithmetic, Wilson intervals) lives in
``evaluation/compare.py`` — the SAME engine the live accuracy observatory
(``observability/audit.py``, ADR-016) runs against a hash-sampled tap of
serving traffic, so the offline bench and the online auditor can never
disagree about what a false deny is. This module is the offline runner:
a synthetic Zipf trace under virtual time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.clock import ManualClock
from ratelimiter_tpu_torch.core.config import Config, SketchParams
from ratelimiter_tpu_torch.core.types import Algorithm
from ratelimiter_tpu_torch.evaluation.compare import ShadowComparator


def zipf_key_ids(n_keys: int, n_requests: int, alpha: float = 1.1,
                 seed: int = 0) -> np.ndarray:
    """Sample request key ids from a bounded Zipf(alpha) over [0, n_keys):
    inverse-CDF over the normalized 1/rank^alpha mass (BASELINE configs 3/5)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -alpha)
    cdf /= cdf[-1]
    u = rng.random(n_requests)
    return np.searchsorted(cdf, u).astype(np.uint64)


@dataclasses.dataclass
class AccuracyReport:
    requests: int
    oracle_allows: int
    false_denies_vs_oracle: int      # sketch denied, oracle allowed
    false_allows_vs_oracle: int      # sketch allowed, oracle denied (semantic)
    false_deny_rate: float           # vs oracle allows — the BASELINE metric
    cms_false_denies_vs_twin: int    # sketch denied, twin allowed (pure CMS)
    cms_false_deny_rate: float
    semantic_disagreements: int      # twin vs oracle (resolution difference)
    #: 95% Wilson interval on false_deny_rate (compare.wilson_interval) —
    #: the same bound the live auditor reports, so bench JSONs and
    #: /debug/audit quote comparable uncertainty.
    false_deny_wilson95: Tuple[float, float] = (0.0, 1.0)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["false_deny_wilson95"] = list(self.false_deny_wilson95)
        return d


def evaluate_accuracy(
    n_keys: int = 100_000,
    n_requests: int = 200_000,
    batch: int = 4096,
    alpha: float = 1.1,
    limit: int = 100,
    window: float = 60.0,
    request_rate: float = 50_000.0,
    sketch: Optional[SketchParams] = None,
    seed: int = 0,
    include_twin: bool = True,
    device="cuda",
) -> AccuracyReport:
    """Run the same batched trace through sketch / twin / exact oracle
    under identical virtual time (requests arrive uniformly at
    request_rate); the sketch and the twin keep their state on
    ``device``."""
    from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter
    from ratelimiter_tpu_torch.ops.hashing import splitmix64

    sketch = sketch or SketchParams()
    ids = zipf_key_ids(n_keys, n_requests, alpha, seed)
    hashes = splitmix64(ids)

    cfg_sketch = Config(algorithm=Algorithm.TPU_SKETCH, sketch=sketch,
                        limit=limit, window=window, key_prefix="")
    # The oracle only needs a slot per *distinct* key that can appear in the
    # trace (slots are assigned on demand), not per key in the keyspace.
    oracle_cap = min(n_keys, n_requests) + 1

    t0 = 1_700_000_000.0
    lim_sketch = SketchLimiter(cfg_sketch, ManualClock(t0), device=device)
    # Twin: identical sub-window semantics, collision-free width; oracle:
    # exact two-window sliding semantics (compare.ShadowComparator).
    comparator = ShadowComparator(
        cfg_sketch, include_twin=include_twin,
        twin_width=max(sketch.width * 64, 1 << 22),
        oracle_capacity=oracle_cap, device=device)

    for start in range(0, n_requests, batch):
        end = min(start + batch, n_requests)
        now = t0 + start / request_rate
        h = hashes[start:end]
        live = lim_sketch.allow_hashed(h, now=now).allowed
        comparator.observe(h, None, now, live)

    lim_sketch.close()
    comparator.close()

    t = comparator.tally
    return AccuracyReport(
        requests=t.requests,
        oracle_allows=t.oracle_allows,
        false_denies_vs_oracle=t.false_denies_vs_oracle,
        false_allows_vs_oracle=t.false_allows_vs_oracle,
        false_deny_rate=t.false_deny_rate,
        cms_false_denies_vs_twin=t.cms_false_denies_vs_twin,
        cms_false_deny_rate=t.cms_false_deny_rate,
        semantic_disagreements=t.semantic_disagreements,
        false_deny_wilson95=t.false_deny_wilson(),
    )
