"""Accuracy evaluation: sketch vs exact oracle (BASELINE.json metric) — a
port of ``ratelimiter_tpu/evaluation``: the accuracy harness, the
comparison engine, the device load generator (``loadgen``), the device
oracle (``oracle_device``) and the hierarchy scenarios (``scenarios``).

The three-way comparison core (``compare.py``) is the one the live
accuracy observatory runs, in the JAX package and in the port
(``observability/audit.py``, ADR-016)."""

from ratelimiter_tpu_torch.evaluation.accuracy import evaluate_accuracy, zipf_key_ids
from ratelimiter_tpu_torch.evaluation.compare import (
    ShadowComparator,
    ThreeWayTally,
    wilson_interval,
)

__all__ = [
    "ShadowComparator",
    "ThreeWayTally",
    "evaluate_accuracy",
    "wilson_interval",
    "zipf_key_ids",
]
