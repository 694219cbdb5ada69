"""NumPy bulk string hasher, a copy of ``ratelimiter_tpu/native/fallback.py``:
the plain twin of the C++ hasher (``hasher.cpp``), bit for bit.

Fully vectorized over the batch: the per-key variable-length byte streams are
gathered into a dense (n, W) little-endian uint64 lane matrix and the
multiply-rotate rounds run column-wise, masked by each key's lane count, so
cost is O(n * max_lanes) vector ops with no Python-level per-key loop.

tests/test_torch_hasher.py holds the C++ hasher to this twin and to the
JAX package's hasher.
"""

from __future__ import annotations

import numpy as np

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix64(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def hash_packed_numpy(buf: np.ndarray, offsets: np.ndarray,
                      lengths: np.ndarray, seed: int) -> np.ndarray:
    """Hash n packed byte strings; same layout contract as rl_bulk_hash_u64."""
    n = offsets.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    if buf.shape[0] == 0:
        # All-empty keys: zero lanes, just the seeded length mix + finalizer.
        with np.errstate(over="ignore"):
            return _fmix64(np.full(n, np.uint64(seed), dtype=np.uint64))
    with np.errstate(over="ignore"):
        max_len = int(lengths.max(initial=0))
        W = max(1, -(-max_len // 8))  # lanes per key
        # Gather each key's bytes into a zero-padded (n, W*8) matrix. The
        # clip keeps indices in-bounds; the mask zeroes tail bytes.
        idx = offsets[:, None] + np.arange(W * 8, dtype=np.int64)[None, :]
        valid = idx < (offsets + lengths)[:, None]
        dense = np.where(valid, buf[np.minimum(idx, buf.shape[0] - 1)], 0)
        lanes = np.ascontiguousarray(dense, dtype=np.uint8).reshape(n, W, 8)
        lanes = lanes.view('<u8').reshape(n, W)  # little-endian lanes

        h = np.uint64(seed) ^ (lengths.astype(np.uint64) * _P1)
        n_lanes = -(-lengths // 8)  # ceil: the remainder lane is one round
        for w in range(W):
            active = w < n_lanes
            hr = _rotl64(h ^ (lanes[:, w] * _P1), 27) * _P2 + _P3
            h = np.where(active, hr, h)
        return _fmix64(h)
