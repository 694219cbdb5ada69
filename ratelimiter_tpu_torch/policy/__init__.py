"""Policy engine: tiered per-key limit overrides (a copy of
``ratelimiter_tpu/policy``). The host table (policy/table.py) keeps the
entries and the padded sorted arrays the limiter places on the device;
ops/policy_kernels.py looks each batch up in them inside the step.
"""

from ratelimiter_tpu_torch.policy.table import Override, PolicyTable

__all__ = ["Override", "PolicyTable"]
