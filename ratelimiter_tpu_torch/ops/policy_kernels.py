"""Override-table lookup — the policy engine's device half.

A port of ``ratelimiter_tpu/ops/policy_kernels.py``. The policy table
(policy/table.py) keeps per-key limit overrides as a SORTED int64 key
array of fixed capacity plus parallel value columns; every decision step
looks its batch up in it, so a batch mixing default and overridden keys
is still one step.

Key domain (sketch backends): the (h1, h2) uint32 halves the CMS columns
are derived from, packed as ``(h1 << 32) | h2`` and bit-cast to int64 —
the query is packed on device from operands the step already has.

Padding rows hold PAD_KEY (int64 max) with default values; a search miss
therefore also lands on default values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

#: Padding sentinel for unused table rows (same as the JAX package).
PAD_KEY = (1 << 63) - 1


def lookup_i64(table_keys: torch.Tensor, queries: torch.Tensor):
    """For each query, the index of its match in the sorted ``table_keys``
    (int64[P], P a power of two, padded with PAD_KEY) and whether it
    matched: ``(idx int64[B], found bool[B])``, idx clamped to [0, P-1] so
    it is safe to gather with on a miss.

    ``searchsorted(..., right=True) - 1`` is the largest i with
    ``table_keys[i] <= q`` (-1 when every entry is greater) — the same
    index the JAX package's branchless descent lands on, including the
    LAST row of a full table."""
    P = table_keys.shape[0]
    if P & (P - 1):
        raise ValueError(f"table capacity must be a power of two, got {P}")
    idx = torch.searchsorted(table_keys, queries, right=True) - 1
    safe = idx.clamp_min(0)
    found = (idx >= 0) & (table_keys[safe] == queries)
    return safe, found


def limits_dev(policy, h1: torch.Tensor, h2: torch.Tensor,
               default: int) -> torch.Tensor:
    """Each key's limit, int64[B]: its override in the device table
    ``policy`` (``key``/``limit`` columns), else ``default``; all
    ``default`` when ``policy`` is None."""
    if policy is None:
        return torch.full_like(h1, default)
    idx, found = lookup_i64(policy["key"], pack_halves(h1, h2))
    return torch.where(found, policy["limit"][idx], default)


def lookup_host(table_keys: np.ndarray, queries: np.ndarray,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of lookup_i64 (same contract) for host-side result
    assembly."""
    idx = np.searchsorted(table_keys, queries, side="right").astype(np.int64) - 1
    safe = np.maximum(idx, 0).astype(np.int32)
    found = (idx >= 0) & (table_keys[safe] == queries)
    return safe, found


def pack_halves(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """(h1, h2) int64 tensors in 0..2^32-1 -> the int64 search key,
    bit-identical to the host packing (uint64 ``(h1 << 32) | h2`` bit-cast).
    h1 is first taken to its signed 32-bit value, so the shift by 32 stays
    inside the int64 range and nothing overflows."""
    h1s = h1 - ((h1 >> 31) << 32)
    return (h1s << 32) | h2


def pack_halves_host(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Host twin of pack_halves on uint32 arrays."""
    packed = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
    return packed.view(np.int64)


def empty_arrays(capacity: int, defaults: Dict[str, int]) -> Dict[str, np.ndarray]:
    """An all-padding host table: ``key`` int64[capacity] of PAD_KEY plus
    one int64 column per default value."""
    out = {"key": np.full(capacity, PAD_KEY, dtype=np.int64)}
    for name, val in defaults.items():
        out[name] = np.full(capacity, int(val), dtype=np.int64)
    return out
