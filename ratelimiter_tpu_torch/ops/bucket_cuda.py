"""The token bucket's table kernels: CUDA wrappers and plain versions.

Each function here replaces one Pallas kernel of the JAX package
(``ratelimiter_tpu/ops/pallas_sketch.py``) with a kernel written by hand
for Hopper (``csrc/bucket_kernels.cu``, built by ``ops/_build.py`` and
called through ctypes), beside a plain PyTorch version of the same
function:

* a CUDA tensor launches the kernel (on the current stream, without
  synchronising) or raises — there is no fallback;
* a CPU tensor takes the plain version. The CPU tests hold the plain
  versions bit-equal to the JAX package, and ``chip_smoke.py`` holds each
  kernel bit-equal to its plain version on the card.

Each wrapper counts its kernel launches in a plain integer attribute
(``bucket_estimate.launches``, ``bucket_update.launches``);
``launch_counts`` and ``reset_launch_counts`` read and clear them.

All arithmetic is int64 and exact, so no order of operations (rows in a
thread, shared-memory atomics in any order) can change a result. The
scalar ``decay`` arrives by value from the host (ops/bucket_kernels.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ratelimiter_tpu_torch.ops import _build
from ratelimiter_tpu_torch.ops.sketch_cuda import (
    _check,
    _columns,
    _raise_on,
    _stream,
    tiling,
)

#: Debt and acc cells clamp here on every write, so debt arithmetic never
#: overflows int64 (2^61 micro-tokens; clamping errs toward denying).
DEBT_CAP = 1 << 61

_SOURCE = "bucket_kernels"
_configured = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rl_bucket_estimate.argtypes = [P, L, P, P, P, I, I, I, P]
        lib.rl_bucket_update.argtypes = [P, P, L, P, P, P, I, I, I, I, I, I,
                                         P]
        for fn in (lib.rl_bucket_estimate, lib.rl_bucket_update):
            fn.restype = ctypes.c_int
        _configured.add(id(lib))
    return lib


def build() -> None:
    """Compile (if needed) and load the kernels' library."""
    _lib()


def _check_decay(decay: int) -> int:
    decay = int(decay)
    if not 0 <= decay < (1 << 63):
        raise ValueError(f"decay must be an int64 >= 0, got {decay}")
    return decay


def _check_common(debt, h1, h2):
    if debt.dim() != 2:
        raise ValueError(f"debt must be (d, w), got {tuple(debt.shape)}")
    d, w = debt.shape
    if w < 16 or w & (w - 1):
        raise ValueError(f"sketch width must be a power of two >= 16, got {w}")
    B = h1.shape[0]
    _check("debt", debt, torch.int64, (d, w), debt.device, align16=True)
    _check("h1", h1, torch.int64, (B,), debt.device)
    _check("h2", h2, torch.int64, (B,), debt.device)
    return d, w, B


# ------------------------------------------------------------ plain forms


def flat_cells(h1, h2, d: int, w: int) -> torch.Tensor:
    """(d*B,) int64 indices of each key's cell in each row of a flattened
    (d, w) slab, row-major (row 0's keys first)."""
    return (_columns(h1, h2, d, w)
            + torch.arange(d, device=h1.device)[:, None] * w).reshape(-1)


def bucket_estimate_plain(debt, decay: int, h1, h2) -> torch.Tensor:
    """Min over rows, in row order, of ``max(0, debt - decay)`` at each
    key's column. (B,) int64 micro-tokens."""
    d, w = debt.shape
    e = torch.clamp_min(torch.gather(debt, 1, _columns(h1, h2, d, w))
                        - decay, 0)
    est = e[0]
    for r in range(1, d):
        est = torch.minimum(est, e[r])
    return est


def bucket_update_plain(debt, acc, decay: int, h1, h2, consumed) -> None:
    """Decay and consume, in place, over EVERY cell: ``debt = min(max(0,
    debt - decay) + h, CAP)`` and ``acc = min(acc + h, CAP)``, where h is
    the per-row int64 histogram of ``consumed`` at each key's column.
    Computed as clamp, scatter-add, clamp: ``min(min(x, CAP) + h, CAP) ==
    min(x + h, CAP)`` for h >= 0, and nothing overflows (x <= 2^61 after
    the first clamp, h < 2^62 by the admission gate)."""
    d, w = debt.shape
    debt.sub_(decay).clamp_(0, DEBT_CAP)
    acc.clamp_max_(DEBT_CAP)
    flat = flat_cells(h1, h2, d, w)
    vals = consumed.repeat(d)
    debt.view(-1).index_add_(0, flat, vals)
    acc.view(-1).index_add_(0, flat, vals)
    debt.clamp_max_(DEBT_CAP)
    acc.clamp_max_(DEBT_CAP)


# --------------------------------------------------------------- wrappers


def bucket_estimate(debt: torch.Tensor, decay: int, h1: torch.Tensor,
                    h2: torch.Tensor) -> torch.Tensor:
    """Replaces Pallas ``bucket_estimate`` (pallas_sketch.py:270-288).

    Bound on an H100: d*B random 8-byte reads (one 32-byte sector each)
    plus the (B,) operands — about 0.2 MB at B=4096, d=4, a fraction of a
    microsecond at 3.35 TB/s, so the kernel is launch-bound. Design: one
    thread per key walks its d rows in order with a running int64 min
    (the Pallas kernel's sequential row grid becomes a loop in the
    thread); the decayed slab is never materialised."""
    d, w, B = _check_common(debt, h1, h2)
    decay = _check_decay(decay)
    if debt.device.type == "cpu":
        return bucket_estimate_plain(debt, decay, h1, h2)
    if debt.device.type != "cuda":
        raise ValueError(f"unsupported device {debt.device}")
    est = torch.empty(B, dtype=torch.int64, device=debt.device)
    err = _lib().rl_bucket_estimate(
        debt.data_ptr(), decay, h1.data_ptr(), h2.data_ptr(), est.data_ptr(),
        B, d, w, _stream(debt))
    _raise_on(err, "bucket_estimate")
    bucket_estimate.launches += 1
    return est


def bucket_update(debt: torch.Tensor, acc: torch.Tensor, decay: int,
                  h1: torch.Tensor, h2: torch.Tensor, consumed: torch.Tensor,
                  clamp_acc: bool = False, *, tile: Optional[int] = None,
                  cluster: Optional[int] = None) -> None:
    """Replaces Pallas ``bucket_update`` (pallas_sketch.py:302-327);
    updates ``debt`` and ``acc`` in place (the JAX kernel aliases them).

    Bound on an H100: ``debt`` read and written at every cell (the decay
    reaches every cell, not only touched ones), 16 bytes per cell, plus
    ``acc`` at the touched cells and the key operands — 4.4 MB at d=4,
    w=65536, B=4096, about 1.3 us at 3.35 TB/s. Design: ONE launch of
    (w/tile, d) blocks, each owning ``tile`` cells of one row
    (csrc/tile_owner.cuh): a bulk asynchronous copy brings its ``debt``
    tile into shared memory while its threads scan the keys (h1, h2 and
    consumed loaded together) and add the ``consumed`` of those that land
    in the tile into an exact int64 histogram h in shared memory (two
    32-bit halves with a carry: 64-bit shared atomics are
    compare-and-swap loops); then every cell gets ``debt = min(min(max(0,
    debt - decay), CAP) + h, CAP)`` (no sum overflows: 2^61 + 2^62 <
    2^63), and only cells with h != 0 read and write ``acc = min(acc + h,
    CAP)``. Above ``sketch_cuda.CLUSTER_BATCH`` keys, clusters of
    neighbouring tiles split one scan of the keys, as in ``cu_update``. No
    global atomics, no scratch.

    ``acc`` is not clamped densely: every state the step writes holds
    ``acc <= CAP``. A restored state may not (the limiter marks one), and
    ``clamp_acc=True`` then clamps every ``acc`` cell in this call, as the
    plain version, and the JAX kernel, do on every call."""
    d, w, B = _check_common(debt, h1, h2)
    decay = _check_decay(decay)
    _check("acc", acc, torch.int64, (d, w), debt.device, align16=True)
    _check("consumed", consumed, torch.int64, (B,), debt.device)
    if debt.device.type == "cpu":
        return bucket_update_plain(debt, acc, decay, h1, h2, consumed)
    if debt.device.type != "cuda":
        raise ValueError(f"unsupported device {debt.device}")
    tile, cluster = tiling(w, B, tile, cluster)
    err = _lib().rl_bucket_update(
        debt.data_ptr(), acc.data_ptr(), decay, h1.data_ptr(), h2.data_ptr(),
        consumed.data_ptr(), B, d, w, tile, cluster, int(clamp_acc),
        _stream(debt))
    _raise_on(err, "bucket_update")
    bucket_update.launches += 1


KERNELS = (bucket_estimate, bucket_update)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
