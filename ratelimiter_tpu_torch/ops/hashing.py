"""Key hashing for the sketch backend: host functions and device twins.

The host half is a copy of ``ratelimiter_tpu/ops/hashing.py``: string keys
go through the bulk hasher, u64 ids through the splitmix64 finalizer, and
``split_hash`` cuts a 64-bit hash into the two 32-bit halves (h1, h2) the
count-min columns are derived from.

The device twins run inside the decision step, so the host stages one
raw u64 buffer per batch and never does per-key hash math. PyTorch has
no usable uint64 arithmetic (add and ``>>`` are not implemented for it),
so the twins work on int64 tensors that hold the same 64 bits:

* add and multiply wrap modulo 2^64 exactly as uint64 would (two's
  complement), with the constants given as their signed equivalents;
* ``>>`` on int64 is arithmetic, so every logical right shift by s is
  written ``(x >> s) & ((1 << (64 - s)) - 1)``;
* h1 and h2 come back as int64 tensors holding 0..2^32-1.

tests/test_torch_ops.py holds them bit-equal to the NumPy host functions
and to the JAX package's jnp twins.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.native import bulk_hash_u64

_MASK32 = 0xFFFFFFFF


def _i64(c: int) -> int:
    """The int64 value holding the same 64 bits as unsigned ``c``."""
    c &= 0xFFFFFFFFFFFFFFFF
    return c - (1 << 64) if c >= (1 << 63) else c


_GAMMA = _i64(0x9E3779B97F4A7C15)
_C1 = _i64(0xBF58476D1CE4E5B9)
_C2 = _i64(0x94D049BB133111EB)


def hash_strings_u64(keys: Sequence[str]) -> np.ndarray:
    """Stable 64-bit hashes of string keys (native bulk hasher)."""
    return bulk_hash_u64(keys)


def hash_prefixed_u64(keys: Sequence[str], prefix: str = "") -> np.ndarray:
    """THE key→hash rule: namespace prefix, then the bulk hash — the same
    rule as the JAX package, so a key lands on the same columns in both."""
    if prefix:
        keys = [f"{prefix}:{k}" for k in keys]
    return bulk_hash_u64(keys)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uniform 64-bit mixing of integer ids."""
    x = np.asarray(x, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def key_token(key: str) -> str:
    """Irreversible ``key#<16hex>`` token for logs and the control-plane
    event journal (the JAX package's rule, ``ops/hashing.key_token``).
    The logging decorator's redaction and every journal emit site render
    keys through this, so redacted log lines and journal ``key_hash``
    fields stay joinable. Hash-of-hash: ``hash_strings_u64`` feeds
    decisions and wire routing, so its raw value is quasi-public; the
    extra splitmix keeps tokens uncorrelatable with routing hashes."""
    return f"key#{int(splitmix64(hash_strings_u64([key]))[0]):016x}"


def split_hash(h64: np.ndarray, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(h1, h2) uint32 halves for double hashing; h2 forced odd so strides
    cycle the full power-of-two width. A seed remixes per-limiter so two
    sketches never share collision patterns."""
    h = h64
    if seed:
        h = splitmix64(h ^ np.uint64(seed & 0xFFFFFFFFFFFFFFFF))
    h1 = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h2 = ((h >> np.uint64(32)).astype(np.uint32)) | np.uint32(1)
    return h1, h2


def u64_to_tensor(x: np.ndarray, device) -> torch.Tensor:
    """uint64 host array -> int64 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.uint64).view(np.int64)).to(device)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 64 bits held in an int64 tensor."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64_dev(x: torch.Tensor) -> torch.Tensor:
    """Torch twin of splitmix64 on int64 tensors (same bits as uint64)."""
    x = x + _GAMMA
    x = (x ^ _shr(x, 30)) * _C1
    x = (x ^ _shr(x, 27)) * _C2
    return x ^ _shr(x, 31)


def split_hash_dev(h64: torch.Tensor, seed: int = 0):
    """Torch twin of split_hash: (h1, h2) as int64 tensors in 0..2^32-1."""
    h = h64
    if seed:
        h = splitmix64_dev(h ^ _i64(seed))
    h1 = h & _MASK32
    h2 = _shr(h, 32) | 1
    return h1, h2


def halves_dev(keys, premix: bool, seed: int):
    """(h1, h2) of a step's keys: an (h1, h2) pair as given, or an int64
    tensor of finalized 64-bit hashes (raw ids when ``premix``: splitmix64
    first) split with ``seed``."""
    if isinstance(keys, tuple):
        return keys
    return split_hash_dev(splitmix64_dev(keys) if premix else keys, seed)


# ----------------------------------------------------- splitmix64 inverse
#
# splitmix64 is a bijection on u64 (an odd-constant add, then three
# invertible xorshift-multiply rounds), so a finalized hash goes back to
# the raw id that produced it. The fleet forwards finalized hashes over
# the plain T_ALLOW_HASHED lane as ``splitmix64_inv(h64)``: the receiver
# re-finalizes them to the bit-identical hash.

#: Modular inverses of the two splitmix64 multipliers mod 2^64.
_INV_C1 = np.uint64(pow(0xBF58476D1CE4E5B9, -1, 1 << 64))
_INV_C2 = np.uint64(pow(0x94D049BB133111EB, -1, 1 << 64))


def _unshift_right(x: np.ndarray, s: int) -> np.ndarray:
    """Invert ``y = x ^ (x >> s)`` (iterate to the fixpoint: each round
    recovers ``s`` more high-order-correct bits)."""
    y = x.copy()
    for _ in range(-(-64 // s) - 1):
        y = x ^ (y >> np.uint64(s))
    return y


def splitmix64_inv(x: np.ndarray) -> np.ndarray:
    """Exact inverse of :func:`splitmix64` (vectorized)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = _unshift_right(x, 31)
        x = x * _INV_C2
        x = _unshift_right(x, 27)
        x = x * _INV_C1
        x = _unshift_right(x, 30)
        x = x - np.uint64(0x9E3779B97F4A7C15)
    return x
