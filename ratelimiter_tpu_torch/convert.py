"""State carried across packages: the JAX package's captured sketch state
to the port's tensors, and back.

``ratelimiter_tpu``'s ``SketchLimiter.capture_state()`` returns
``(kind, arrays, extra)``: the state slabs as NumPy arrays, the
``policy_*`` override columns and ``extra["host_period"]``. The port's
``SketchLimiter.capture_state()`` returns the same format. So a sketch
moves between the packages as::

    kind, arrays, extra = jax_limiter.capture_state()
    torch_limiter.restore_state(arrays, extra)      # uses state_from_numpy

and back with ``state_to_numpy``, in the JAX package's restore format.
Only the windowed sketch's arrays carry across in this slice: heavy-hitter
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


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's state dict (tensors on ``device``) from captured arrays.
    ``policy_*`` columns are skipped (the limiter's policy table restores
    them); any other array is refused, as is a wrong dtype."""
    keys = {k for k in arrays if not k.startswith("policy_")}
    if keys != set(STATE_DTYPES):
        raise InvalidConfigError(
            f"state arrays {sorted(keys)} != the windowed sketch's "
            f"{sorted(STATE_DTYPES)} (the heavy-hitter table and the "
            f"hierarchy are not ported yet, ROADMAP A6)")
    out = {}
    for k, dt in STATE_DTYPES.items():
        a = np.asarray(arrays[k])
        if a.dtype != dt:
            raise InvalidConfigError(f"state array {k} is {a.dtype}, "
                                     f"expected {np.dtype(dt)}")
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Captured NumPy arrays from the port's state dict (the inverse)."""
    return {k: state[k].detach().cpu().numpy().copy() for k in STATE_DTYPES}
