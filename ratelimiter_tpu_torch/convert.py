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
The array sets that carry across: the windowed sketch's, with or without
the heavy-hitter side table (``hh_*``) and with or without the hierarchy
cascade's counters (``tn_cur``/``tn_slabs``/``tn_totals``, int32), and
the token bucket's, with or without its tenant counters (``tn_counts``
int64 and the scalar ``tn_period``). The side table's owner columns are
uint32 at this boundary, as in the JAX package and its snapshots, and
int64 holding the same values on the port's device. ``hh_owner2`` and the
bucket's ``acc`` may be absent (checkpoints from before the JAX package
added them) and then restore as zeros, as there. The tenant registry's
``hier_*`` columns are the limiter's (hierarchy/tenants.py
``snapshot_arrays``), not state: they are skipped here, like the
``policy_*`` columns.
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

#: The side table's state arrays and their dtypes at the NumPy boundary.
HH_DTYPES = {
    "hh_owner": np.uint32,
    "hh_owner2": np.uint32,
    "hh_cur": np.int32,
    "hh_slabs": np.int32,
    "hh_totals": np.int32,
    "hh_last": np.int64,
}

#: Held as int64 on the port's device (torch.uint32 supports few ops).
_OWNER_KEYS = ("hh_owner", "hh_owner2")

#: The token bucket's state arrays and their dtypes.
BUCKET_DTYPES = {
    "debt": np.int64,
    "acc": np.int64,
    "rem": np.int64,
    "last": np.int64,
}

#: The windowed sketch's hierarchy counters (index T is the global scope).
TN_DTYPES = {
    "tn_cur": np.int32,
    "tn_slabs": np.int32,
    "tn_totals": np.int32,
}

#: The token bucket's hierarchy counters.
BUCKET_TN_DTYPES = {
    "tn_counts": np.int64,
    "tn_period": np.int64,
}

#: The bucket's scalars live on the host (ops/bucket_kernels.py).
_HOST_KEYS = ("rem", "last", "tn_period")


def _windowed_sets():
    """Every windowed array set: (side table?, hierarchy?)."""
    for hh in (False, True):
        for tn in (False, True):
            yield {**STATE_DTYPES, **(HH_DTYPES if hh else {}),
                   **(TN_DTYPES if tn else {})}


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's state dict from captured arrays: the windowed sketch's
    tensors on ``device``, or the bucket's slabs on ``device`` with its
    scalars on the host. ``policy_*`` and ``hier_*`` columns are skipped
    (the limiter's policy and tenant tables restore them); any other array
    set is refused, as is a wrong dtype."""
    keys = {k for k in arrays
            if not k.startswith(("policy_", "hier_"))}
    dtypes = None
    for cand in _windowed_sets():
        if keys == set(cand) or ("hh_owner" in cand
                                 and keys | {"hh_owner2"} == set(cand)):
            dtypes = cand
    for cand in (BUCKET_DTYPES, {**BUCKET_DTYPES, **BUCKET_TN_DTYPES}):
        if keys | {"acc"} == set(cand):
            dtypes = cand
    if dtypes is None:
        raise InvalidConfigError(
            f"state arrays {sorted(keys)} are neither the windowed sketch's "
            f"{sorted(STATE_DTYPES)} (with or without the side table's "
            f"{sorted(HH_DTYPES)} and the hierarchy's {sorted(TN_DTYPES)}) "
            f"nor the token bucket's {sorted(BUCKET_DTYPES)} (with or "
            f"without {sorted(BUCKET_TN_DTYPES)})")
    if "hh_owner2" in dtypes and "hh_owner2" not in keys:
        arrays = dict(arrays, hh_owner2=np.zeros_like(
            np.asarray(arrays["hh_owner"])))
    if "acc" in dtypes and "acc" not in keys:
        arrays = dict(arrays, acc=np.zeros_like(np.asarray(arrays["debt"])))
    out = {}
    for k, dt in dtypes.items():
        a = np.asarray(arrays[k])
        if a.dtype != dt:
            raise InvalidConfigError(f"state array {k} is {a.dtype}, "
                                     f"expected {np.dtype(dt)}")
        a = a.astype(np.int64) if k in _OWNER_KEYS else np.array(a, copy=True)
        t = torch.from_numpy(a)
        out[k] = t if k in _HOST_KEYS else t.to(device)
    return out


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Captured NumPy arrays from the port's state dict (the inverse)."""
    if "debt" in state:
        dtypes = dict(BUCKET_DTYPES)
        if "tn_counts" in state:
            dtypes.update(BUCKET_TN_DTYPES)
    else:
        dtypes = dict(STATE_DTYPES)
        if "hh_owner" in state:
            dtypes.update(HH_DTYPES)
        if "tn_cur" in state:
            dtypes.update(TN_DTYPES)
    return {k: state[k].detach().cpu().numpy().astype(dt)
            for k, dt in dtypes.items()}
