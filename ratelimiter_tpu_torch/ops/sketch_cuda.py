"""The windowed sketch's table kernels: CUDA wrappers and plain versions.

Each wrapper here replaces one Pallas kernel of the JAX package
(``ratelimiter_tpu/ops/pallas_sketch.py``) with a kernel written by hand
for Hopper (``csrc/sketch_kernels.cu``, built by ``ops/_build.py`` and
called through ctypes), beside a plain PyTorch version of the same
function. ``window_front`` replaces ``window_estimate`` together with the
step's ops around it (hashing, boundary weight, policy lookup, available
quota), which the JAX package's jit fuses and the port would otherwise
launch one by one. The back of the step is one launch too: ``add_back``
(the vanilla step: admission, the ``add_update`` scatter and remaining)
and ``window_admit`` (the CU step's admission, targets and remaining,
ahead of ``cu_update``), both over the block-level admission routine of
``csrc/admit.cuh``:

* a CUDA tensor launches the kernel (on the current stream, without
  synchronising) or raises — there is no fallback;
* a CPU tensor takes the plain version. The CPU tests hold the plain
  versions bit-equal to the JAX package, and ``chip_smoke.py`` holds each
  kernel bit-equal to its plain version on the card.

Each wrapper counts its kernel launches in a plain integer attribute
(``window_front.launches`` ...); ``launch_counts`` reads them under the
names of the TPU kernels they replace (``add_update``: both of its forms,
the fused back and the standalone scatter), the fused back alone as
``add_back``, and the admission launch, which replaces no TPU kernel, as
``admit``; ``reset_launch_counts`` clears them.

Rounding. The JAX reference's window read ``f32(t) + frac * f32(b)``
rounds once, as a fused multiply-add: XLA contracts it when it jits the
step on the CPU, in the jnp path and in the Pallas interpret path alike.
The kernels spell ``__fmaf_rn``; the plain versions compute the same
correctly rounded FMA with ``fma_f32`` below, exactly for every input.
So is the boundary weight ``clip(1 - e/sub_us, 0, 1)``, as
``clip(fma(-e, rcp, 1), 0, 1)`` with ``rcp`` the f32 reciprocal of
``sub_us`` (XLA turns the division by a constant into that product).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ratelimiter_tpu_torch.ops import _build
from ratelimiter_tpu_torch.ops.hashing import halves_dev
from ratelimiter_tpu_torch.ops.policy_kernels import limits_dev
from ratelimiter_tpu_torch.ops.segment import admit

_SOURCE = "sketch_kernels"
_configured = set()

#: The launch shape of the two tiled updates (cu_update here,
#: bucket_update in bucket_cuda.py), chosen by ``python3 chip_smoke.py
#: --sweep`` on an H100 (PERF.md): each block owns TILE cells of a row;
#: batches of more than CLUSTER_BATCH keys run in clusters of CLUSTER
#: neighbouring tiles, which read the keys once per cluster instead of
#: once per block but launch slower.
TILE, CLUSTER, CLUSTER_BATCH = 2048, 8, 8192

#: Threads per block of the two front kernels (window_front here,
#: bucket_front in bucket_cuda.py), read at every launch: one thread per
#: key. ``chip_smoke.py`` times 64, 128 and 256 on the card.
FRONT_THREADS = 128

#: The most keys one admission launch holds (``kMaxCapacity`` in
#: csrc/admit.cuh): one block of 1024 threads, 8 keys a thread, whose
#: shared-memory hash table (two 8-byte slots a key, 128 KB) is the
#: largest power of two that fits a block. Batches above it take the plain
#: admission on the card and the standalone ``add_update`` (``add_back``),
#: or the plain admission before ``cu_update`` (``window_admit``). PERF.md
#: §6 ("Admission capacity and block shapes") has the times behind this
#: size.
ADMIT_CAPACITY = 8192

#: The front kernels' key lanes (csrc/front.cuh): raw u64 ids (splitmix64
#: in the kernel), finalized 64-bit hashes, or the (h1, h2) halves given.
LANE_PREMIX, LANE_HASHED, LANE_HALVES = 0, 1, 2


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I = ctypes.c_void_p, ctypes.c_int
        L, U, F = ctypes.c_int64, ctypes.c_uint64, ctypes.c_float
        lib.rl_window_front.argtypes = [P, P, P, L, I, F, F, P, P, P, U, I,
                                        P, P, P, I, L, P, P, P, P, I, I, I,
                                        I, P]
        lib.rl_cu_update.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
        lib.rl_add_update.argtypes = [P, P, P, P, P, I, I, I, P]
        lib.rl_add_back.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I,
                                    P]
        lib.rl_window_admit.argtypes = [P, P, P, P, P, P, P, I, I, P]
        for fn in (lib.rl_window_front, lib.rl_cu_update,
                   lib.rl_add_update, lib.rl_add_back,
                   lib.rl_window_admit):
            fn.restype = ctypes.c_int
        _configured.add(id(lib))
    return lib


def build() -> None:
    """Compile (if needed) and load the kernels' library."""
    _lib()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def tiling(w: int, B: int, tile: Optional[int] = None,
           cluster: Optional[int] = None) -> tuple:
    """The (tile, cluster) of a tiled update over rows of width ``w`` and
    a batch of ``B`` keys: the chosen shape where none is given (the
    sweep and the tests give one); the tile clamps to the row, the
    cluster to the tiles in a row."""
    tile = min(TILE if tile is None else tile, w)
    if cluster is None:
        cluster = CLUSTER if B > CLUSTER_BATCH else 1
    return tile, min(cluster, w // tile)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, align16: bool = False) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_common(totals, h1, h2):
    if totals.dim() != 2:
        raise ValueError(f"totals must be (d, w), got {tuple(totals.shape)}")
    d, w = totals.shape
    if w < 16 or w & (w - 1):
        raise ValueError(f"sketch width must be a power of two >= 16, got {w}")
    B = h1.shape[0]
    _check("totals", totals, torch.int32, (d, w), totals.device, align16=True)
    _check("h1", h1, torch.int64, (B,), totals.device)
    _check("h2", h2, torch.int64, (B,), totals.device)
    return d, w, B


def _check_frac(boundary, frac, d, w, device):
    if boundary is None:
        return
    _check("boundary", boundary, torch.int32, (d, w), device, align16=True)
    if frac is None:
        raise ValueError("frac is required with a boundary slab")
    _check("frac", frac, torch.float32, (), device)


class Boundary(NamedTuple):
    """The sliding window's boundary sub-window as the front reads it: the
    ring slab at ``slot`` (``p % S``), valid when ``slab_period[slot] ==
    want`` (``p - SW``), weighted by ``clip(fma(-e, rcp, 1), 0, 1)`` with
    ``e = f32(now_us - p*sub_us)`` and ``rcp = f32(1) / f32(sub_us)``."""

    slab: torch.Tensor
    slab_period: torch.Tensor
    slot: int
    want: int
    e: np.float32
    rcp: np.float32


def _check_front(slab, name: str, dtype, keys, n, policy) -> tuple:
    """The operands both fronts share: the (d, w) slab, the keys (an int64
    (B,) tensor, or an (h1, h2) pair), ``n`` and the policy table.
    Returns (d, w, B)."""
    if slab.dim() != 2:
        raise ValueError(f"{name} must be (d, w), got {tuple(slab.shape)}")
    d, w = slab.shape
    if not 1 <= d <= 16:
        raise ValueError(f"sketch depth must be in [1, 16], got {d}")
    if w < 16 or w & (w - 1):
        raise ValueError(f"sketch width must be a power of two >= 16, got {w}")
    dev = slab.device
    _check(name, slab, dtype, (d, w), dev, align16=True)
    names = ("h1", "h2") if isinstance(keys, tuple) else ("h64",)
    keys = keys if isinstance(keys, tuple) else (keys,)
    B = keys[0].shape[0]
    for k, t in zip(names, keys):
        _check(k, t, torch.int64, (B,), dev)
    if n is not None:
        _check("n", n, torch.int32, (B,), dev)
    if policy is not None:
        P = policy["key"].shape[0]
        if P < 2 or P & (P - 1):
            raise ValueError(f"table capacity must be a power of two, got {P}")
        _check("policy key", policy["key"], torch.int64, (P,), dev,
               align16=True)
        _check("policy limit", policy["limit"], torch.int64, (P,), dev)
    return d, w, B


def _key_args(keys, premix: bool, seed: int, B: int, device) -> tuple:
    """(h64, h1, h2, seed, lane) for a front launch; h1 and h2 are the
    given halves or new (B,) outputs."""
    if isinstance(keys, tuple):
        return None, keys[0], keys[1], 0, LANE_HALVES
    h1, h2 = torch.empty((2, B), dtype=torch.int64, device=device).unbind()
    return (keys, h1, h2, seed & 0xFFFFFFFFFFFFFFFF,
            LANE_PREMIX if premix else LANE_HASHED)


def _policy_args(policy) -> tuple:
    """(key column, limit column, capacity) for a front launch."""
    if policy is None:
        return None, None, 0
    return (policy["key"].data_ptr(), policy["limit"].data_ptr(),
            policy["key"].shape[0])


# ------------------------------------------------------------ plain forms


def _columns(h1: torch.Tensor, h2: torch.Tensor, d: int, w: int) -> torch.Tensor:
    """(d, B) int64 columns ``(h1 + r*h2) & (w-1)``; int64 arithmetic never
    wraps here and keeps the low bits of the uint32 result."""
    r = torch.arange(d, dtype=torch.int64, device=h1.device)
    return (h1[None, :] + r[:, None] * h2[None, :]) & (w - 1)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c`` of float32 tensors, exact for
    every input: the product of two 24-bit significands is exact in
    float64; the sum is rounded to float64 and its exact error recovered
    with TwoSum; an inexact sum whose last bit is even moves one ulp toward
    the exact value (rounding to odd); and one rounding of a round-to-odd
    float64 to float32 is the correct rounding, since 53 >= 24 + 2
    (Boldo and Melquiond, 2008). Plain float64 arithmetic would round
    twice and miss in rare cases."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    odd = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    s = torch.where((err != 0) & ((bits & 1) == 0), odd.view(torch.float64), s)
    return s.float()


def _window_read(frac, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``fma(frac, f32(b), f32(t))`` for int32 slabs, as the reference."""
    return fma_f32(frac, b.float(), t.float())


def window_estimate_plain(totals, boundary, frac, h1, h2) -> torch.Tensor:
    """Min over rows, in row order, of the window read at each key's
    column: ``f32(t) + frac*f32(b)`` (one rounding) or ``f32(t)`` when
    ``boundary`` is None. (B,) f32, not clamped."""
    d, w = totals.shape
    cols = _columns(h1, h2, d, w)
    t = torch.gather(totals, 1, cols)
    e = (t.float() if boundary is None
         else _window_read(frac, torch.gather(boundary, 1, cols), t))
    est = e[0]
    for r in range(1, d):
        est = torch.minimum(est, e[r])
    return est


def frac_plain(e: np.float32, rcp: np.float32) -> torch.Tensor:
    """The boundary weight ``clip(fma(-e, rcp, 1), 0, 1)``, a 0-d f32 CPU
    tensor."""
    return fma_f32(torch.tensor(-e), torch.tensor(rcp),
                   torch.ones((), dtype=torch.float32)).clamp(0.0, 1.0)


def window_front_plain(totals, keys, n=None, *, premix: bool = False,
                       seed: int = 0, boundary: Optional[Boundary] = None,
                       policy=None, limit: int = 0) -> tuple:
    """The windowed step's front as the step composed it before the front
    kernel: the keys' halves (``halves_dev``), the boundary weight (0 when
    the slab is stale), the estimate clamped at 0, each key's limit
    (``limits_dev``) and the available quota ``max(f32(limit) - est, 0)``.
    Returns ``(h1, h2, est, frac, avail, n_f)``; ``frac`` is None without
    a boundary, ``avail`` and ``n_f`` are None without ``n``."""
    h1, h2 = halves_dev(keys, premix, seed)
    slab = frac = None
    if boundary is not None:
        slab = boundary.slab
        valid = boundary.slab_period[boundary.slot] == boundary.want
        # An f32 value as a Python float is exact, and stays on the host.
        frac = torch.where(valid, float(frac_plain(boundary.e, boundary.rcp)),
                           0.0)
    est = torch.clamp_min(window_estimate_plain(totals, slab, frac, h1, h2),
                          0.0)
    if n is None:
        return h1, h2, est, frac, None, None
    # Exact in f32: limits are < 2^24.
    lim_f = limits_dev(policy, h1, h2, limit).to(torch.float32)
    return (h1, h2, est, frac, torch.clamp_min(lim_f - est, 0.0),
            n.to(torch.float32))


def cu_update_plain(totals, cur, boundary, frac, h1, h2, target) -> None:
    """Conservative update, in place: per row, the max target per column,
    then over EVERY cell ``delta = ceil(max(m - read, 0))`` added to both
    ``totals`` and ``cur``."""
    d, w = totals.shape
    cols = _columns(h1, h2, d, w)
    m = torch.zeros((d, w), dtype=torch.float32, device=totals.device)
    m.scatter_reduce_(1, cols, target[None, :].expand(d, -1).contiguous(),
                      reduce="amax", include_self=True)
    read = (totals.float() if boundary is None
            else _window_read(frac, boundary, totals))
    delta = torch.ceil(torch.clamp_min(m - read, 0.0)).to(torch.int32)
    totals += delta
    cur += delta


def add_update_plain(totals, cur, h1, h2, add) -> None:
    """Vanilla update, in place: per row, the int32 histogram of ``add``
    at each key's column, added to both ``totals`` and ``cur``."""
    d, w = totals.shape
    flat = (_columns(h1, h2, d, w)
            + torch.arange(d, device=h1.device)[:, None] * w).reshape(-1)
    vals = add.repeat(d)
    totals.view(-1).index_add_(0, flat, vals)
    cur.view(-1).index_add_(0, flat, vals)


def _remaining(seen, allowed, n_f) -> torch.Tensor:
    """The windowed step's ``int32(max(floor(seen - where(allowed, n_f,
    0)), 0))``."""
    return torch.clamp_min(
        torch.floor(seen - torch.where(allowed, n_f, 0.0)),
        0.0).to(torch.int32)


def _vanilla_back(scatter, totals, cur, h1, h2, n, n_f, avail,
                  iters: int) -> tuple:
    """The vanilla step's back as composed ops: ``admit``, the admitted
    amounts through ``scatter`` (``add_update_plain`` or the standalone
    kernel), and remaining."""
    allowed, seen, _ = admit(h1, n_f, avail, iters)
    scatter(totals, cur, h1, h2,
            torch.where(allowed, n, torch.zeros_like(n)).to(torch.int32))
    return allowed, _remaining(seen, allowed, n_f)


def add_back_plain(totals, cur, h1, h2, n, n_f, avail, iters: int) -> tuple:
    """The vanilla step from the front's outputs to its results, in place
    on ``totals`` and ``cur``: in-batch admission of ``n_f`` against
    ``avail`` (``segment.admit``, grouped on h1), ``where(allowed, n, 0)``
    added at each key's column of every row (``add_update_plain``), and
    ``remaining``. Returns ``(allowed bool[B], remaining int32[B])``."""
    return _vanilla_back(add_update_plain, totals, cur, h1, h2, n, n_f,
                         avail, iters)


def window_admit_plain(h1, est, n_f, avail, iters: int) -> tuple:
    """The CU step's admission: ``segment.admit``, then the CU targets
    ``where(allowed, (est + (avail - seen)) + n_f, 0)`` and
    ``remaining``. Returns ``(target f32[B], allowed bool[B], remaining
    int32[B])``."""
    allowed, seen, _ = admit(h1, n_f, avail, iters)
    target = torch.where(allowed, est + (avail - seen) + n_f, 0.0)
    return target, allowed, _remaining(seen, allowed, n_f)


# --------------------------------------------------------------- wrappers


def window_front(totals: torch.Tensor, keys, n: Optional[torch.Tensor] = None,
                 *, premix: bool = False, seed: int = 0,
                 boundary: Optional[Boundary] = None, policy=None,
                 limit: int = 0) -> tuple:
    """Replaces Pallas ``window_estimate`` (pallas_sketch.py:144-166) and
    the step's ops around it: ``window_front_plain``'s function in one
    launch. ``keys`` is an int64 (B,) tensor of finalized 64-bit hashes,
    of raw ids (``premix=True``), or the pair (h1, h2); ``n`` None asks
    for the estimate alone (the reset); ``boundary`` None is a fixed
    window; ``policy`` the device table's ``key``/``limit`` columns.

    Bound on an H100: each key's staged key, ``n`` and five outputs once,
    its touched cells of ``totals`` and the boundary, and the policy key
    column once, ~0.25 MB at B=4096, d=4 with the default 1024-row table:
    ~0.07 us at 3.35 TB/s, so one launch is the cost. Design
    (csrc/front.cuh): one thread per key hashes it, issues all 2*d cell
    loads, then searches the policy table (staged into shared memory by
    one bulk copy per block when it has at most 4096 rows, so each of the
    ceil(B / FRONT_THREADS) blocks reads the column again, from L2) while
    they are in flight, folds the min over rows in row order (the Pallas
    kernel's sequential row grid becomes a loop in the thread) and writes
    est, avail and n_f; thread 0 writes ``frac``, which ``cu_update``
    reads."""
    d, w, B = _check_front(totals, "totals", torch.int32, keys, n, policy)
    dev = totals.device
    if boundary is not None:
        S = boundary.slab_period.shape[0]
        _check("boundary", boundary.slab, torch.int32, (d, w), dev,
               align16=True)
        _check("slab_period", boundary.slab_period, torch.int64, (S,), dev)
        if not 0 <= boundary.slot < S:
            raise ValueError(f"boundary slot {boundary.slot} outside the "
                             f"ring of {S}")
    if dev.type == "cpu":
        return window_front_plain(totals, keys, n, premix=premix, seed=seed,
                                  boundary=boundary, policy=policy,
                                  limit=limit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h64, h1, h2, seed, lane = _key_args(keys, premix, seed, B, dev)
    k = 1 if n is None else 3
    out = torch.empty(k * B + 1, dtype=torch.float32, device=dev)
    est, frac = out[:B], out[k * B]
    avail, n_f = (None, None) if n is None else (out[B:2 * B],
                                                out[2 * B:3 * B])
    bnd = (boundary.slab.data_ptr(), boundary.slab_period.data_ptr(),
           boundary.want, boundary.slot, float(boundary.e),
           float(boundary.rcp)) if boundary is not None else (
               None, None, 0, 0, 0.0, 0.0)
    err = _lib().rl_window_front(
        totals.data_ptr(), *bnd, _ptr(h64), h1.data_ptr(), h2.data_ptr(),
        seed, lane, _ptr(n), *_policy_args(policy), limit, est.data_ptr(),
        frac.data_ptr(), _ptr(avail), _ptr(n_f), B, d, w, FRONT_THREADS,
        _stream(totals))
    _raise_on(err, "window_front")
    window_front.launches += 1
    return (h1, h2, est, frac if boundary is not None else None, avail,
            n_f)


def cu_update(totals: torch.Tensor, cur: torch.Tensor,
              boundary: Optional[torch.Tensor], frac: Optional[torch.Tensor],
              h1: torch.Tensor, h2: torch.Tensor, target: torch.Tensor, *,
              tile: Optional[int] = None,
              cluster: Optional[int] = None) -> None:
    """Replaces Pallas ``cu_update`` (pallas_sketch.py:186-212); updates
    ``totals`` and ``cur`` in place (the JAX kernel aliases them).

    Bound on an H100: ``totals`` and ``cur`` read and written and
    ``boundary`` read at every cell, 20 bytes per cell, plus the key
    operands — 5.3 MB at d=4, w=65536, B=4096, about 1.6 us at 3.35 TB/s.
    Design: ONE launch of (w/tile, d) blocks, each owning ``tile`` cells
    of one row (csrc/tile_owner.cuh): a bulk asynchronous copy brings its
    ``totals``, ``cur`` and ``boundary`` tiles into shared memory while its
    threads scan the keys (h1, h2 and target loaded together) and
    ``atomicMax`` the int bits of the non-negative targets that land in
    the tile into a shared-memory histogram; then every cell of the tile
    gets ``delta = ceil(max(m - read, 0))``. Every block reads every key,
    so the scan grows with B: above ``CLUSTER_BATCH`` keys the blocks of
    ``CLUSTER`` neighbouring tiles split one scan and add into each
    other's histograms through distributed shared memory (``tiling``). No
    scratch, no memset, nothing allocated. The dense pass is not narrowed
    to touched columns: after a reset an untouched cell can read below
    zero and must grow."""
    d, w, B = _check_common(totals, h1, h2)
    _check("cur", cur, torch.int32, (d, w), totals.device, align16=True)
    _check("target", target, torch.float32, (B,), totals.device)
    _check_frac(boundary, frac, d, w, totals.device)
    if totals.device.type == "cpu":
        return cu_update_plain(totals, cur, boundary, frac, h1, h2, target)
    if totals.device.type != "cuda":
        raise ValueError(f"unsupported device {totals.device}")
    tile, cluster = tiling(w, B, tile, cluster)
    err = _lib().rl_cu_update(
        totals.data_ptr(), cur.data_ptr(), _ptr(boundary),
        _ptr(frac) if boundary is not None else None, h1.data_ptr(),
        h2.data_ptr(), target.data_ptr(), B, d, w, tile, cluster,
        _stream(totals))
    _raise_on(err, "cu_update")
    cu_update.launches += 1


def add_update(totals: torch.Tensor, cur: torch.Tensor, h1: torch.Tensor,
               h2: torch.Tensor, add: torch.Tensor) -> None:
    """Replaces Pallas ``add_update`` (pallas_sketch.py:224-245); updates
    ``totals`` and ``cur`` in place.

    Bound on an H100: 2*d*B atomic adds (about 32K at B=4096, d=4), a
    launch-bound amount of work. Design: one thread per (key, row) adds
    its key's amount with ``atomicAdd`` into both slabs, skipping zeros;
    integer adds commute, so this equals the reference's histogram."""
    d, w, B = _check_common(totals, h1, h2)
    _check("cur", cur, torch.int32, (d, w), totals.device, align16=True)
    _check("add", add, torch.int32, (B,), totals.device)
    if totals.device.type == "cpu":
        return add_update_plain(totals, cur, h1, h2, add)
    if totals.device.type != "cuda":
        raise ValueError(f"unsupported device {totals.device}")
    err = _lib().rl_add_update(
        totals.data_ptr(), cur.data_ptr(), h1.data_ptr(), h2.data_ptr(),
        add.data_ptr(), B, d, w, _stream(totals))
    _raise_on(err, "add_update")
    add_update.launches += 1


def _check_back(h1, operands: dict, iters: int) -> int:
    """The admission operands: ``h1`` int64 (B,) and each of
    ``operands`` (name: (tensor, dtype)) a contiguous (B,) tensor on
    h1's device. Returns B."""
    B = h1.shape[0] if h1.dim() == 1 else -1
    _check("h1", h1, torch.int64, (B,), h1.device)
    for name, (t, dtype) in operands.items():
        _check(name, t, dtype, (B,), h1.device)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    return B


def add_back(totals: torch.Tensor, cur: torch.Tensor, h1: torch.Tensor,
             h2: torch.Tensor, n: torch.Tensor, n_f: torch.Tensor,
             avail: torch.Tensor, iters: int) -> tuple:
    """Replaces Pallas ``add_update`` (pallas_sketch.py:224-245) with the
    vanilla step's ops around it (the JAX step's ``segment.admit``, its
    add amounts and remaining, ratelimiter_tpu/ops/sketch_kernels.py:374,
    450-456,534-535): ``add_back_plain``'s function in one launch, in
    place on ``totals`` and ``cur``. Returns ``(allowed, remaining)``.

    Bound on an H100: h1, h2, n, n_f and avail in, the touched cells of
    ``totals`` and ``cur`` read and written, allowed and remaining out,
    ~0.2 MB at B=4096, d=4: ~0.06 us at 3.35 TB/s, far below one launch.
    Design (csrc/admit.cuh): ONE block holds the batch (up to
    ``ADMIT_CAPACITY`` keys), gives each key a group id through a hash
    table of h1 in shared memory, sorts (id, batch index) with a stable
    block radix sort, runs the ``iters + 2`` segmented sums as block scans
    in int64 (fewer once a round finds a fixed point), adds each key's
    admitted total into both slabs with one global atomic per row and
    slab (per run of one (h1, h2) in the sorted batch: keys may share
    h1), and writes allowed and remaining in batch order. It replaces the
    ~85 launches of the composed back with one; its time is the single
    block's sort and scans. Above ``ADMIT_CAPACITY`` keys the back runs
    composed on the card: the plain admission, then the standalone
    ``add_update`` kernel."""
    d, w, B = _check_common(totals, h1, h2)
    _check("cur", cur, torch.int32, (d, w), totals.device, align16=True)
    _check_back(h1, {"n": (n, torch.int32), "n_f": (n_f, torch.float32),
                     "avail": (avail, torch.float32)}, iters)
    dev = totals.device
    if dev.type == "cpu":
        return add_back_plain(totals, cur, h1, h2, n, n_f, avail, iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if B > ADMIT_CAPACITY:
        return _vanilla_back(add_update, totals, cur, h1, h2, n, n_f, avail,
                             iters)
    allowed = torch.empty(B, dtype=torch.bool, device=dev)
    remaining = torch.empty(B, dtype=torch.int32, device=dev)
    err = _lib().rl_add_back(
        totals.data_ptr(), cur.data_ptr(), h1.data_ptr(), h2.data_ptr(),
        n.data_ptr(), n_f.data_ptr(), avail.data_ptr(), allowed.data_ptr(),
        remaining.data_ptr(), B, d, w, iters, _stream(totals))
    _raise_on(err, "add_back")
    add_back.launches += 1
    return allowed, remaining


def window_admit(h1: torch.Tensor, est: torch.Tensor, n_f: torch.Tensor,
                 avail: torch.Tensor, iters: int) -> tuple:
    """The CU step's admission, CU targets and remaining
    (``window_admit_plain``'s function; the JAX step's ``segment.admit``
    and ratelimiter_tpu/ops/sketch_kernels.py:374,432,534-535) in one
    launch ahead of ``cu_update``, which needs every target of the batch
    in each of its tiles. Returns ``(target, allowed, remaining)``.

    Bound on an H100: h1, est, n_f and avail in, target, allowed and
    remaining out, ~0.1 MB at B=4096: ~0.03 us at 3.35 TB/s, far below
    one launch. Design: ``add_back``'s block (csrc/admit.cuh) with an
    epilogue that writes the three outputs in batch order. It
    replaces the ~85 launches of the composed admission, targets and
    remaining with one. Above ``ADMIT_CAPACITY`` keys the plain version
    runs on the card."""
    B = _check_back(h1, {"est": (est, torch.float32),
                         "n_f": (n_f, torch.float32),
                         "avail": (avail, torch.float32)}, iters)
    dev = h1.device
    if dev.type == "cpu" or (dev.type == "cuda" and B > ADMIT_CAPACITY):
        return window_admit_plain(h1, est, n_f, avail, iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    target = torch.empty(B, dtype=torch.float32, device=dev)
    allowed = torch.empty(B, dtype=torch.bool, device=dev)
    remaining = torch.empty(B, dtype=torch.int32, device=dev)
    err = _lib().rl_window_admit(
        h1.data_ptr(), est.data_ptr(), n_f.data_ptr(), avail.data_ptr(),
        target.data_ptr(), allowed.data_ptr(), remaining.data_ptr(), B,
        iters, _stream(h1))
    _raise_on(err, "window_admit")
    window_admit.launches += 1
    return target, allowed, remaining


#: Each wrapper under the name of the TPU kernel it replaces (both forms
#: of add_update under its name), the fused back alone as ``add_back``,
#: and the admission launch, which replaces no TPU kernel, as ``admit``.
KERNELS = {"window_estimate": (window_front,), "cu_update": (cu_update,),
           "add_update": (add_back, add_update), "add_back": (add_back,),
           "admit": (window_admit,)}
WRAPPERS = (window_front, cu_update, add_update, add_back, window_admit)
for _fn in WRAPPERS:
    _fn.launches = 0


def launch_counts() -> dict:
    """{TPU kernel name (or ``add_back``, ``admit``): launches of its
    replacement since the last reset}."""
    return {name: sum(fn.launches for fn in fns)
            for name, fns in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
