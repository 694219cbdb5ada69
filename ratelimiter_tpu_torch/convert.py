"""State carried across packages: the JAX package's captured sketch state
to the port's tensors, and back.

``ratelimiter_tpu``'s ``SketchLimiter.capture_state()`` (and its token
bucket's) returns ``(kind, arrays, extra)``: the state arrays as NumPy
arrays, the ``policy_*`` override columns and, for the windowed sketch,
``extra["host_period"]``. The port's limiters return the same format. So
a sketch moves between the packages as::

    kind, arrays, extra = jax_limiter.capture_state()
    torch_limiter.restore_state(arrays, extra)      # uses state_from_numpy

and back with ``state_to_numpy``, in the JAX package's restore format.
Two array sets carry across: the windowed sketch's and the token
bucket's. The bucket's ``acc`` may be absent (checkpoints from before the
JAX package added it) and then restores as zeros, as there. Heavy-hitter
(``hh_*``) and hierarchy (``tn_*``, ``hier_*``) arrays are refused.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ratelimiter_tpu_torch.core.errors import InvalidConfigError

#: The windowed sketch's state arrays and their dtypes.
STATE_DTYPES = {
    "cur": np.int32,
    "slabs": np.int32,
    "totals": np.int32,
    "slab_period": np.int64,
    "last_period": np.int64,
}

#: The token bucket's state arrays and their dtypes.
BUCKET_DTYPES = {
    "debt": np.int64,
    "acc": np.int64,
    "rem": np.int64,
    "last": np.int64,
}

#: The bucket's scalars live on the host (ops/bucket_kernels.py).
_HOST_KEYS = ("rem", "last")


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's state dict from captured arrays: the windowed sketch's
    tensors on ``device``, or the bucket's slabs on ``device`` with its
    scalars on the host. ``policy_*`` columns are skipped (the limiter's
    policy table restores them); any other array set is refused, as is a
    wrong dtype."""
    keys = {k for k in arrays if not k.startswith("policy_")}
    if keys == set(STATE_DTYPES):
        dtypes = STATE_DTYPES
    elif keys | {"acc"} == set(BUCKET_DTYPES):
        dtypes = BUCKET_DTYPES
        if "acc" not in keys:
            arrays = dict(arrays, acc=np.zeros_like(np.asarray(arrays["debt"])))
    else:
        raise InvalidConfigError(
            f"state arrays {sorted(keys)} are neither the windowed sketch's "
            f"{sorted(STATE_DTYPES)} nor the token bucket's "
            f"{sorted(BUCKET_DTYPES)} (the heavy-hitter table and the "
            f"hierarchy are not ported yet, ROADMAP A6)")
    out = {}
    for k, dt in dtypes.items():
        a = np.asarray(arrays[k])
        if a.dtype != dt:
            raise InvalidConfigError(f"state array {k} is {a.dtype}, "
                                     f"expected {np.dtype(dt)}")
        t = torch.from_numpy(np.array(a, copy=True))
        out[k] = t if k in _HOST_KEYS else t.to(device)
    return out


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Captured NumPy arrays from the port's state dict (the inverse)."""
    keys = BUCKET_DTYPES if "debt" in state else STATE_DTYPES
    return {k: state[k].detach().cpu().numpy().copy() for k in keys}
