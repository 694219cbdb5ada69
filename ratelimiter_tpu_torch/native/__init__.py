"""Host bulk string hashing: key packing plus the NumPy hasher.

A copy of the packing and dispatch half of ``ratelimiter_tpu/native``
with only its NumPy twin (``fallback.py``), which is bit-identical to the
JAX package's C++ hasher: string keys hash to the same u64 in both
packages, so a sketch carried across (``convert.py``) stays addressable.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ratelimiter_tpu_torch.native.fallback import hash_packed_numpy

DEFAULT_SEED = 0x52_4C_54_50_55_31  # "RLTPU1"


def pack_keys(keys: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack strings into (buf uint8[], offsets int64[], byte_lengths int64[]).

    Fast path: one ``str.join`` + one encode for the whole batch, with
    per-key byte lengths taken from ``len`` — valid exactly when every key
    is ASCII, which the total-bytes check proves after the fact. Non-ASCII
    batches fall back to per-key encoding (correct, slower).
    """
    n = len(keys)
    if n == 0:
        return (np.empty(0, np.uint8), np.empty(0, np.int64),
                np.empty(0, np.int64))
    lengths = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    blob = "".join(keys).encode("utf-8")
    if len(blob) != int(lengths.sum()):
        # Some key is non-ASCII: char count != byte count. Re-pack exactly.
        encoded = [k.encode("utf-8") for k in keys]
        lengths = np.fromiter((len(e) for e in encoded), dtype=np.int64,
                              count=n)
        blob = b"".join(encoded)
    buf = np.frombuffer(blob, dtype=np.uint8)
    offsets = np.cumsum(lengths) - lengths
    return buf, offsets, lengths


def bulk_hash_u64(keys: Sequence[str], seed: int = DEFAULT_SEED) -> np.ndarray:
    """Hash a batch of string keys to uint64 (the NumPy bulk hasher)."""
    return hash_packed_numpy(*pack_keys(keys), seed=seed)
