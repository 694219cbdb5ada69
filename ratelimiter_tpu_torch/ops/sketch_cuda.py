"""The windowed sketch's table kernels: CUDA wrappers and plain versions.

Each function here replaces one Pallas kernel of the JAX package
(``ratelimiter_tpu/ops/pallas_sketch.py``) with a kernel written by hand
for Hopper (``csrc/sketch_kernels.cu``, built by ``ops/_build.py`` and
called through ctypes), beside a plain PyTorch version of the same
function:

* a CUDA tensor launches the kernel (on the current stream, without
  synchronising) or raises — there is no fallback;
* a CPU tensor takes the plain version. The CPU tests hold the plain
  versions bit-equal to the JAX package, and ``chip_smoke.py`` holds each
  kernel bit-equal to its plain version on the card.

Each wrapper counts its kernel launches in a plain integer attribute
(``window_estimate.launches`` ...); ``launch_counts`` and
``reset_launch_counts`` read and clear them.

Rounding. The JAX reference's window read ``f32(t) + frac * f32(b)``
rounds once, as a fused multiply-add: XLA contracts it when it jits the
step on the CPU, in the jnp path and in the Pallas interpret path alike.
The kernels spell ``__fmaf_rn``; the plain versions compute the same
correctly rounded FMA with ``fma_f32`` below, exactly for every input.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ratelimiter_tpu_torch.ops import _build

_SOURCE = "sketch_kernels"
_configured = set()

#: The launch shape of the two tiled updates (cu_update here,
#: bucket_update in bucket_cuda.py), chosen by ``python3 chip_smoke.py
#: --sweep`` on an H100 (PERF.md): each block owns TILE cells of a row;
#: batches of more than CLUSTER_BATCH keys run in clusters of CLUSTER
#: neighbouring tiles, which read the keys once per cluster instead of
#: once per block but launch slower.
TILE, CLUSTER, CLUSTER_BATCH = 2048, 8, 8192


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rl_window_estimate.argtypes = [P, P, P, P, P, P, I, I, I, P]
        lib.rl_cu_update.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
        lib.rl_add_update.argtypes = [P, P, P, P, P, I, I, I, P]
        for fn in (lib.rl_window_estimate, lib.rl_cu_update,
                   lib.rl_add_update):
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


# --------------------------------------------------------------- wrappers


def window_estimate(totals: torch.Tensor, boundary: Optional[torch.Tensor],
                    frac: Optional[torch.Tensor], h1: torch.Tensor,
                    h2: torch.Tensor) -> torch.Tensor:
    """Replaces Pallas ``window_estimate`` (pallas_sketch.py:144-166).

    Bound on an H100: 2*d*B random 4-byte reads, one 32-byte sector each,
    plus the (B,) operands — about 1.1 MB at B=4096, d=4, a fraction of a
    microsecond at 3.35 TB/s, so the kernel is launch-bound. Design: one
    thread per key walks its d rows in order (the Pallas kernel's
    sequential row grid becomes a loop in the thread), so the min folds
    in the reference's order and no (B, d) column matrix is written.
    ``boundary=None`` means a fixed window: t alone, with no zero slab."""
    d, w, B = _check_common(totals, h1, h2)
    _check_frac(boundary, frac, d, w, totals.device)
    if totals.device.type == "cpu":
        return window_estimate_plain(totals, boundary, frac, h1, h2)
    if totals.device.type != "cuda":
        raise ValueError(f"unsupported device {totals.device}")
    est = torch.empty(B, dtype=torch.float32, device=totals.device)
    err = _lib().rl_window_estimate(
        totals.data_ptr(), _ptr(boundary), _ptr(frac) if boundary is not None
        else None, h1.data_ptr(), h2.data_ptr(), est.data_ptr(), B, d, w,
        _stream(totals))
    _raise_on(err, "window_estimate")
    window_estimate.launches += 1
    return est


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


KERNELS = (window_estimate, cu_update, add_update)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
