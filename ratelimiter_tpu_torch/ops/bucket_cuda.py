"""The token bucket's table kernels: CUDA wrappers and plain versions.

Each wrapper here replaces one Pallas kernel of the JAX package
(``ratelimiter_tpu/ops/pallas_sketch.py``) with a kernel written by hand
for Hopper (``csrc/bucket_kernels.cu``, built by ``ops/_build.py`` and
called through ctypes), beside a plain PyTorch version of the same
function. ``bucket_front`` replaces ``bucket_estimate`` together with the
step's ops around it (hashing, policy lookup, available quota, request
units), and ``bucket_admit`` runs the step's in-batch admission, consumed,
remaining and retry in one launch ahead of ``bucket_update`` (over the
block-level routine of ``csrc/admit.cuh``, or without the cascade above
``sketch_cuda.ADMIT_CLUSTER_BATCH`` requests the cluster routine of
``csrc/admit_cluster.cuh``; it replaces no TPU kernel):

* a CUDA tensor launches the kernel (on the current stream, without
  synchronising) or raises — there is no fallback;
* a CPU tensor takes the plain version. The CPU tests hold the plain
  versions bit-equal to the JAX package, and ``chip_smoke.py`` holds each
  kernel bit-equal to its plain version on the card.

With the hierarchy cascade, ``bucket_admit`` takes its operands
(``sketch_cuda.Cascade``, the fixed-window ``tn_counts``) and launches
its cascade build, up to ``ADMIT_CAPACITY`` requests; above it the plain
admission and cascade run on the card, as without the cascade.

Each wrapper counts its kernel launches in a plain integer attribute
(``bucket_front.launches`` ...); ``launch_counts`` reads them under the
names of the TPU kernels they replace, the admission launch's build
without the cascade as ``admit`` and its cascade build as
``admit [cascade]``; ``reset_launch_counts`` clears them.

All arithmetic is int64 and exact, so no order of operations (rows in a
thread, shared-memory atomics in any order) can change a result. The
scalar ``decay`` arrives by value from the host (ops/bucket_kernels.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ratelimiter_tpu_torch.core.clock import MICROS
from ratelimiter_tpu_torch.ops import _build, sketch_cuda
from ratelimiter_tpu_torch.ops.hashing import halves_dev
from ratelimiter_tpu_torch.ops.policy_kernels import limits_dev
from ratelimiter_tpu_torch.ops.sketch_cuda import (
    ADMIT_CAPACITY,
    Cascade,
    _cascade_args,
    _check,
    _check_cascade,
    _check_back,
    _check_front,
    _columns,
    _key_args,
    _policy_args,
    _ptr,
    _raise_on,
    _stream,
    key_admission,
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
        U = ctypes.c_uint64
        lib.rl_bucket_front.argtypes = [P, L, P, P, P, U, I, P, P, P, I, L,
                                        P, P, P, I, I, I, I, P]
        lib.rl_bucket_update.argtypes = [P, P, L, P, P, P, I, I, I, I, I, I,
                                         P]
        C = [P, P, I, P, P, I, P]
        lib.rl_bucket_admit.argtypes = [P, P, P, P, P, P, P, U, I, L, I, I,
                                        P, P, *C, I, L, P]
        for fn in (lib.rl_bucket_front, lib.rl_bucket_update,
                   lib.rl_bucket_admit):
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


def bucket_front_plain(debt, decay: int, keys, n=None, *,
                       premix: bool = False, seed: int = 0, policy=None,
                       limit: int = 0) -> tuple:
    """The bucket step's front as the step composed it before the front
    kernel: the keys' halves (``halves_dev``), the decayed estimate, each
    key's limit (``limits_dev``), the available quota ``max(limit * 10^6
    - est, 0)`` and the request units ``n * 10^6``, all int64. Returns
    ``(h1, h2, est, avail, n_units)``; the last two are None without
    ``n``."""
    h1, h2 = halves_dev(keys, premix, seed)
    est = bucket_estimate_plain(debt, decay, h1, h2)
    if n is None:
        return h1, h2, est, None, None
    cap = limits_dev(policy, h1, h2, limit) * MICROS
    return (h1, h2, est, torch.clamp_min(cap - est, 0),
            n.to(torch.int64) * MICROS)


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


def bucket_admit_plain(h1, n_units, avail, iters: int, rate_num: int,
                       rate_den: int, casc: Optional[Cascade] = None
                       ) -> tuple:
    """The bucket step's admission and results, all int64: ``segment.
    admit`` of ``n_units`` against ``avail`` grouped on h1, ``consumed =
    where(allowed, n_units, 0)``, ``remaining = (seen - consumed) //
    10^6`` and ``retry_us = where(allowed, 0, -((-deficit * rate_den) //
    rate_num))`` with ``deficit = max(n_units - seen, 0)`` (torch's floor
    division; the product wraps as int64 does). Reference semantics of
    retry: ``tokenbucket.go:122-130``, the time to refill the deficit,
    ceil'd to whole microseconds. Returns ``(allowed, consumed, remaining,
    retry_us)``. With the cascade's operands ``casc``, admission is
    ``sketch_cuda.key_admission``'s (the tenant counters folded in place),
    and a denied row without a deficit retries at ``casc.retry_us``, the
    tenant/global window's reset (ratelimiter_tpu/ops/bucket_kernels.py:
    164-205,234-238)."""
    allowed, seen = key_admission(h1, n_units, avail, iters, casc)
    consumed = torch.where(allowed, n_units, 0)
    remaining = (seen - consumed) // MICROS
    deficit = torch.clamp_min(n_units - seen, 0)
    retry_us = torch.where(allowed, 0, -((-deficit * rate_den) // rate_num))
    if casc is not None:
        retry_us = torch.where(~allowed & (deficit <= 0), casc.retry_us,
                               retry_us)
    return allowed, consumed, remaining, retry_us


# --------------------------------------------------------------- wrappers


def bucket_front(debt: torch.Tensor, decay: int, keys,
                 n: Optional[torch.Tensor] = None, *, premix: bool = False,
                 seed: int = 0, policy=None, limit: int = 0) -> tuple:
    """Replaces Pallas ``bucket_estimate`` (pallas_sketch.py:270-288) and
    the step's ops around it: ``bucket_front_plain``'s function in one
    launch. ``keys`` is an int64 (B,) tensor of finalized 64-bit hashes,
    of raw ids (``premix=True``), or the pair (h1, h2); ``n`` None asks
    for the estimate alone (the reset); ``policy`` the device table's
    ``key``/``limit`` columns.

    Bound on an H100: each key's staged key, ``n`` and five int64 outputs
    once, its touched debt cells, and the policy key column once, ~0.3 MB
    at B=4096, d=4 with the default 1024-row table: ~0.09 us at
    3.35 TB/s, so one launch is the cost.
    Design (csrc/front.cuh): one thread per key hashes it, issues its d
    debt loads, searches the policy table (staged in each block's shared
    memory when it has at most 4096 rows) while they are in flight, folds
    ``max(0, debt - decay)`` over rows in row order and writes est, avail
    and n_units; the decayed slab is never materialised."""
    d, w, B = _check_front(debt, "debt", torch.int64, keys, n, policy)
    decay = _check_decay(decay)
    dev = debt.device
    if dev.type == "cpu":
        return bucket_front_plain(debt, decay, keys, n, premix=premix,
                                  seed=seed, policy=policy, limit=limit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h64, h1, h2, seed, lane = _key_args(keys, premix, seed, B, dev)
    k = 1 if n is None else 3
    out = torch.empty(k * B, dtype=torch.int64, device=dev)
    est = out[:B]
    avail, n_units = (None, None) if n is None else (out[B:2 * B],
                                                    out[2 * B:])
    err = _lib().rl_bucket_front(
        debt.data_ptr(), decay, _ptr(h64), h1.data_ptr(), h2.data_ptr(),
        seed, lane, _ptr(n), *_policy_args(policy), limit, est.data_ptr(),
        _ptr(avail), _ptr(n_units), B, d, w, sketch_cuda.FRONT_THREADS,
        _stream(debt))
    _raise_on(err, "bucket_front")
    bucket_front.launches += 1
    return h1, h2, est, avail, n_units


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


def divider(d: int) -> tuple:
    """The rate's numerator ``d`` (1 <= d < 2^63) as the kernel's
    invariant multiply, ``(magic, shift)``: libdivide's branch-free
    unsigned 64-bit scheme (``libdivide_u64_branchfree``), with which
    floor(x / d) = (((x - q) >> 1) + q) >> shift for q = (magic * x) >>
    64, exact for every x < 2^64; d = 1 gives shift -1, which the kernel
    takes as x itself (``Divider`` in csrc/bucket_kernels.cu). Computed
    once a launch, here on the host."""
    d = int(d)
    if not 0 < d < (1 << 63):
        raise ValueError(f"divisor {d} must be a positive int64 value")
    if d == 1:
        return 0, -1
    fl = d.bit_length() - 1
    if d & (d - 1) == 0:
        return 0, fl - 1
    return ((1 << (65 + fl)) // d + 1) % (1 << 64), fl


def bucket_admit(h1: torch.Tensor, n_units: torch.Tensor,
                 avail: torch.Tensor, iters: int, rate_num: int,
                 rate_den: int, casc: Optional[Cascade] = None) -> tuple:
    """The bucket step's admission and results (``bucket_admit_plain``'s
    function; the JAX step's ``segment.admit`` and its remaining and retry
    expressions) in one launch ahead of ``bucket_update``, which needs
    every ``consumed`` of the batch in each of its tiles. Returns
    ``(allowed, consumed, remaining, retry_us)``.

    Bound on an H100: h1, n_units and avail in, the four outputs out,
    ~0.2 MB at B=4096: ~0.06 us at 3.35 TB/s, far below one launch.
    Design: without the cascade (the main path), one cluster of
    ``sketch_cuda.admit_cluster(B)`` blocks (csrc/admit_cluster.cuh), the
    keys partitioned over them, each block admitting its own in int64
    and writing their four outputs at their batch indices; at and below
    ``ADMIT_CLUSTER_BATCH`` requests (and in the cascade build) the
    windowed backs' block (csrc/admit.cuh) in int64, with an epilogue
    that writes the four outputs in batch order (floor divisions and
    wrapping products spelled as torch computes them, in both; the
    retry's division by ``rate_num`` as ``divider``'s multiply). The C
    entry picks the cluster or the block from B. It replaces the ~90
    launches of the composed admission and results with one. Above
    ``ADMIT_CAPACITY`` keys the plain version runs on the card (with the
    plain cascade when ``casc`` is given).

    With the cascade's operands ``casc`` (the bucket's fixed-window scope
    counters), the cascade build runs csrc/cascade.cuh's routine in the
    same block after admission and the epilogue reads the final mask
    (``sketch_cuda.add_back``'s design), counted in
    ``bucket_admit.cascade_launches`` too."""
    B = _check_back(h1, {"n_units": (n_units, torch.int64),
                         "avail": (avail, torch.int64)}, iters)
    if not (0 < rate_num < (1 << 63) and 0 < rate_den < (1 << 63)):
        raise ValueError(f"rate {rate_num}/{rate_den} must be positive "
                         f"int64 values")
    dev = h1.device
    if casc is not None:
        _check_cascade(casc, B, dev)
        if casc.cur is not None:
            raise ValueError("the bucket's cascade takes tn_counts alone")
    if dev.type == "cpu" or (dev.type == "cuda" and B > ADMIT_CAPACITY):
        return bucket_admit_plain(h1, n_units, avail, iters, rate_num,
                                  rate_den, casc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    allowed = torch.empty(B, dtype=torch.bool, device=dev)
    consumed, remaining, retry_us = torch.empty(
        (3, B), dtype=torch.int64, device=dev).unbind()
    magic, shift = divider(rate_num)
    err = _lib().rl_bucket_admit(
        h1.data_ptr(), n_units.data_ptr(), avail.data_ptr(),
        allowed.data_ptr(), consumed.data_ptr(), remaining.data_ptr(),
        retry_us.data_ptr(), magic, shift, rate_den, B, iters,
        *((None, None) if casc is None else (casc.h2.data_ptr(),
                                             casc.n.data_ptr())),
        *_cascade_args(casc)[:7],
        0 if casc is None else int(casc.rolled),
        0 if casc is None else casc.retry_us, _stream(h1))
    _raise_on(err, "bucket_admit")
    bucket_admit.launches += 1
    bucket_admit.cascade_launches += casc is not None
    return allowed, consumed, remaining, retry_us


#: Each wrapper under the name of the TPU kernel it replaces, and the
#: admission launch, which replaces no TPU kernel, as ``admit``.
KERNELS = {"bucket_estimate": bucket_front, "bucket_update": bucket_update,
           "admit": bucket_admit}
for _fn in KERNELS.values():
    _fn.launches = 0
bucket_admit.cascade_launches = 0


def launch_counts() -> dict:
    """{TPU kernel name (or ``admit``): launches of its replacement since
    the last reset}: the admission launch's build without the cascade as
    ``admit``, its cascade build as ``admit [cascade]``."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["admit"] -= bucket_admit.cascade_launches
    counts["admit [cascade]"] = bucket_admit.cascade_launches
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    bucket_admit.cascade_launches = 0
