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

With the heavy-hitter side table (``hh_slots > 0``) the front also reads
each key's slot (``SideTable``), the two backs mask owned keys out of the
sketch writes and return the promotion targets, and, given the table
(``SideUpdate``), run its update (which replaces no TPU kernel: the
reference's side-table update is jnp, ratelimiter_tpu/ops/
sketch_kernels.py:487-532; it counts owned keys and promotes new ones) as
the tail of their launch (``csrc/hh.cuh``). ``hh_update`` runs the same
routine alone, for the composed back above ``ADMIT_CAPACITY``. Each of
those is a compile-time variant of its kernel, so the step without the
side table runs the same machine code as before. ``window_reset`` is the
per-key reset (estimate, floor, subtraction) in one launch.

With the hierarchy cascade (``tenants > 0``) the two backs take its
operands (``Cascade``) and launch their cascade builds, which run
``csrc/cascade.cuh``'s block routine after admission (stages 2 and 3,
the final mask, the scope counters' fold) in the same launch, up to
``ADMIT_CAPACITY`` requests; above it the backs run composed on the card,
as without the cascade (the plain admission and cascade, then the
standalone update kernel). The plain versions compose
``ops/hier_kernels.py`` as the JAX step does (``key_admission``).

Each wrapper counts its kernel launches in a plain integer attribute
(``window_front.launches`` ...; the backs' cascade builds in
``cascade_launches`` and their side-table tails in ``tail_launches``
too); ``launch_counts`` reads them under the names of the TPU kernels
they replace (``add_update``: every form, the fused back's builds and
the standalone scatter), the fused back's build without the cascade as
``add_back``, the admission launch's (which replaces no TPU kernel) as
``admit``, their cascade builds as ``add_back [cascade]`` and ``admit
[cascade]``, the side table's standalone update as ``hh_update`` and its
tails (one a side-table back launch) as ``hh_update [fused]``, and the
reset kernel as ``window_reset``; ``reset_launch_counts`` clears them.

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

from ratelimiter_tpu_torch.ops import _build, hier_kernels
from ratelimiter_tpu_torch.ops.hashing import halves_dev
from ratelimiter_tpu_torch.ops.policy_kernels import limits_dev
from ratelimiter_tpu_torch.ops.segment import admit, segment_consumption

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
#: or the plain admission before ``cu_update`` (``window_admit``), with the
#: hierarchy cascade too (the plain cascade after the plain admission).
#: PERF.md §6 ("Admission capacity and block shapes") has the times behind
#: this size.
ADMIT_CAPACITY = 8192

#: The side table's update keeps its per-slot scratch in shared memory
#: (``kSharedSlots`` in csrc/hh.cuh: 26 bytes a slot, at most 106,496;
#: each slot's owner, hh_cur and hh_totals read once) up to this many
#: slots, and sweeps the slots once; a larger table (up to the config's
#: 2^22) works on a (2, K) int64 scratch in global memory
#: (``_hh_scratch``) and touches only the slots the batch names.
HH_SHARED_SLOTS = 4096

#: The most keys one ``window_reset`` launch takes (one block, a thread a
#: key; ``kResetThreads`` in csrc/sketch_kernels.cu). The limiter resets
#: one key; a larger reset runs composed on the card (``window_front``,
#: then ``add_update``), counted under those names.
RESET_CAPACITY = 1024

#: The front kernels' key lanes (csrc/front.cuh): raw u64 ids (splitmix64
#: in the kernel), finalized 64-bit hashes, or the (h1, h2) halves given.
LANE_PREMIX, LANE_HASHED, LANE_HALVES = 0, 1, 2


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I = ctypes.c_void_p, ctypes.c_int
        L, U, F = ctypes.c_int64, ctypes.c_uint64, ctypes.c_float
        lib.rl_window_front.argtypes = [P, P, P, L, I, F, F, P, P, P, U, I,
                                        P, P, P, I, L, P, P, P, P, P, P, P,
                                        I, P, P, P, I, I, I, I, P]
        lib.rl_cu_update.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
        lib.rl_add_update.argtypes = [P, P, P, P, P, I, I, I, P]
        # The cascade's table and scope operands (``_cascade_args``).
        C = [P, P, I, P, P, I, P, P, P, P]
        # The side table's tail (``_tail_args``).
        H = [P, P, P, P, P, P, F, L, I]
        lib.rl_add_back.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I,
                                    I, I, I, *C, *H, P]
        lib.rl_window_admit.argtypes = [P, P, P, P, P, P, P, P, P, I, I, P,
                                        P, *C, *H, P]
        lib.rl_hh_update.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, F,
                                     L, I, I, P]
        lib.rl_window_reset.argtypes = [P, P, P, P, L, I, F, F, P, P, P, P,
                                        P, P, I, I, I, I, P]
        for fn in (lib.rl_window_front, lib.rl_cu_update,
                   lib.rl_add_update, lib.rl_add_back,
                   lib.rl_window_admit, lib.rl_hh_update,
                   lib.rl_window_reset):
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


class SideTable(NamedTuple):
    """The heavy-hitter side table as the front reads it: ``owner`` int64
    (K,) (each slot's owner h1, 0..2^32-1, 0 marking a free slot; int64
    because torch.uint32 supports few ops), ``totals`` int32 (K,), and
    ``slab`` int32 (K,), the side table's boundary sub-window
    ``hh_slabs[p % S]`` (a view; None in fixed mode), weighted by the
    front's ``frac`` as the sketch's boundary slab is. K is a power of
    two; a key's slot is ``h1 & (K-1)``."""

    owner: torch.Tensor
    totals: torch.Tensor
    slab: Optional[torch.Tensor]


#: The side table's state arrays (the windowed state dict's ``hh_*``).
HH_KEYS = ("hh_owner", "hh_owner2", "hh_cur", "hh_slabs", "hh_totals",
           "hh_last")


class SideUpdate(NamedTuple):
    """The side table's update as a back's tail (or ``hh_update``) takes
    it: ``state`` holds the ``hh_*`` tensors (updated in place), ``thresh``
    is the promotion threshold (compared as f32) and ``period`` the step's
    period, written into ``hh_last``."""

    state: dict
    thresh: float
    period: int


class Cascade(NamedTuple):
    """The hierarchy cascade's operands for one step's back (ADR-020,
    ops/hier_kernels.py). ``hier`` holds the tenant table's device
    columns (hierarchy/tenants.py ``host_arrays``): ``key``/``tid`` the
    sorted key->tenant map (int64, a power-of-two capacity), ``limit``/
    ``weight`` int64 (T+1,), the global scope at index T. ``h2`` and ``n``
    are the batch's second hash halves (tenant ids derive from (h1, h2))
    and int32 request counts.

    Windowed: ``counts`` is ``tn_totals`` and ``cur`` ``tn_cur`` (int32
    (T+1,)), both folded with the admitted histogram (cast to int32);
    ``slab`` is the tenant boundary sub-window ``tn_slabs[p % S]``
    weighted by ``frac`` (the front's 0-d output), both None in fixed
    mode. Bucket: ``counts`` is ``tn_counts`` (int64 (T+1,)) and ``cur``
    None; ``rolled`` says they count an earlier window (read as 0, then
    replaced by the histogram), and ``retry_us`` is the time to the next
    window, the retry of rows the cascade denied."""

    hier: dict
    h2: torch.Tensor
    n: torch.Tensor
    counts: torch.Tensor
    cur: Optional[torch.Tensor] = None
    slab: Optional[torch.Tensor] = None
    frac: Optional[torch.Tensor] = None
    rolled: bool = False
    retry_us: int = 0

    @property
    def tenants(self) -> int:
        return self.hier["limit"].shape[0] - 1


def _check_cascade(c: Cascade, B: int, device) -> int:
    """The cascade's operands; returns T. The map's key and tid columns
    are staged by bulk copies in the cascade builds: 16-byte aligned."""
    T = c.tenants
    if T < 2 or T > 4096 or T & (T - 1):
        raise ValueError(f"tenants must be a power of two in [2, 4096], got "
                         f"{T}")
    P = c.hier["key"].shape[0]
    if P < 2 or P & (P - 1):
        raise ValueError(f"tenant map capacity must be a power of two, got "
                         f"{P}")
    staged = device.type == "cuda"
    _check("tenant map key", c.hier["key"], torch.int64, (P,), device,
           align16=staged)
    _check("tenant map tid", c.hier["tid"], torch.int64, (P,), device,
           align16=staged)
    _check("scope limit", c.hier["limit"], torch.int64, (T + 1,), device)
    _check("scope weight", c.hier["weight"], torch.int64, (T + 1,), device)
    _check("h2", c.h2, torch.int64, (B,), device)
    _check("n", c.n, torch.int32, (B,), device)
    windowed = c.cur is not None
    _check("scope counts", c.counts, torch.int32 if windowed else torch.int64,
           (T + 1,), device)
    if windowed:
        _check("scope cur", c.cur, torch.int32, (T + 1,), device)
    if (c.slab is None) != (c.frac is None) or (c.slab is not None
                                                 and not windowed):
        raise ValueError("the tenant boundary slab goes with frac, on the "
                         "windowed sketch")
    if c.slab is not None:
        _check("scope boundary", c.slab, torch.int32, (T + 1,), device)
        _check("frac", c.frac, torch.float32, (), device)
    return T


def _cascade_args(c: Optional[Cascade]) -> tuple:
    """The C interface's cascade operands after h2 and n (map key, tid,
    capacity, limit, weight, T, counts, cur, slab, frac); all null
    without a cascade."""
    if c is None:
        return (None, None, 0, None, None, 0, None, None, None, None)
    return (c.hier["key"].data_ptr(), c.hier["tid"].data_ptr(),
            c.hier["key"].shape[0], c.hier["limit"].data_ptr(),
            c.hier["weight"].data_ptr(), c.tenants, c.counts.data_ptr(),
            _ptr(c.cur), _ptr(c.slab), _ptr(c.frac))


def _check_side(hh: SideTable, weighted: bool, device) -> int:
    """The side table's operands; returns K."""
    K = hh.owner.shape[0] if hh.owner.dim() == 1 else 0
    if K < 1 or K & (K - 1):
        raise ValueError(f"side table slots must be a power of two, got "
                         f"{tuple(hh.owner.shape)}")
    _check("hh owner", hh.owner, torch.int64, (K,), device)
    _check("hh totals", hh.totals, torch.int32, (K,), device)
    if (hh.slab is not None) != weighted:
        raise ValueError("the side table's boundary column goes with the "
                         "sketch's boundary slab")
    if hh.slab is not None:
        _check("hh boundary", hh.slab, torch.int32, (K,), device)
    return K


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


def side_estimate_plain(hh: SideTable, h1, frac) -> tuple:
    """Each key's side-table part of the estimate (the JAX step's
    ratelimiter_tpu/ops/sketch_kernels.py:342-358): ``mine`` (its slot's
    owner is its h1) and ``where(mine, max(est_hh, 0), 0)`` with
    ``est_hh = fma(frac, f32(slab[sid]), f32(totals[sid]))``, or
    ``f32(totals[sid])`` in fixed mode (XLA fuses the read as it fuses
    the sketch's)."""
    sid = h1 & (hh.owner.shape[0] - 1)
    mine = hh.owner[sid] == h1
    t = hh.totals[sid].float()
    raw = t if hh.slab is None else fma_f32(frac, hh.slab[sid].float(), t)
    return mine, torch.where(mine, torch.clamp_min(raw, 0.0), 0.0)


def window_front_plain(totals, keys, n=None, *, premix: bool = False,
                       seed: int = 0, boundary: Optional[Boundary] = None,
                       policy=None, limit: int = 0,
                       hh: Optional[SideTable] = None) -> tuple:
    """The windowed step's front as the step composed it before the front
    kernel: the keys' halves (``halves_dev``), the boundary weight (0 when
    the slab is stale), the estimate clamped at 0, each key's limit
    (``limits_dev``) and the available quota ``max(f32(limit) - est, 0)``.
    Returns ``(h1, h2, est, frac, avail, n_f)``; ``frac`` is None without
    a boundary, ``avail`` and ``n_f`` are None without ``n``. With the
    side table ``hh`` the estimate is the sketch's plus each owned key's
    side-table part (``side_estimate_plain``), and a seventh element
    ``(mine, est_cms, est_hh)`` holds the two parts apart (the reset
    subtracts each from its own table)."""
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
    side = ()
    if hh is not None:
        mine, est_hh = side_estimate_plain(hh, h1, frac)
        side = ((mine, est, est_hh),)
        est = est + est_hh
    if n is None:
        return (h1, h2, est, frac, None, None, *side)
    # Exact in f32: limits are < 2^24.
    lim_f = limits_dev(policy, h1, h2, limit).to(torch.float32)
    return (h1, h2, est, frac, torch.clamp_min(lim_f - est, 0.0),
            n.to(torch.float32), *side)


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


def _reset(front, scatter, totals, cur, h1, h2, boundary, hh,
           hh_cur) -> None:
    """The per-key reset as composed ops: ``front``'s estimate-only form
    (``window_front_plain`` or the kernel), each part floored to int32 and
    subtracted through ``scatter`` (``add_update_plain`` or the
    standalone kernel): the sketch's part at each row's cell, and with
    the side table ``hh`` the owned part at the key's slot (row 0 of the
    (1, K) table, whose column is ``h1 & (K-1)``)."""
    out = front(totals, (h1, h2), boundary=boundary, hh=hh)
    est = out[2] if hh is None else out[6][1]
    scatter(totals, cur, h1, h2, -torch.floor(est).to(torch.int32))
    if hh is not None:
        K = hh.owner.shape[0]
        scatter(hh.totals.view(1, K), hh_cur.view(1, K), h1, h2,
                -torch.floor(out[6][2]).to(torch.int32))


def window_reset_plain(totals, cur, h1, h2, *,
                       boundary: Optional[Boundary] = None,
                       hh: Optional[SideTable] = None,
                       hh_cur: Optional[torch.Tensor] = None) -> None:
    """The per-key reset of the keys (h1, h2), in place, as the step
    composed it before the reset kernel (the JAX package's
    ``_sketch_reset``, ratelimiter_tpu/ops/sketch_kernels.py:539-593):
    ``window_front_plain``'s estimate-only form, floored, then
    ``add_update_plain`` of the negated floors into ``totals`` and
    ``cur``; with the side table ``hh`` the sketch loses its own part of
    the estimate and each owned key's slot of ``hh.totals`` and
    ``hh_cur`` the owned part. Every estimate is read before any cell is
    written."""
    _reset(window_front_plain, add_update_plain, totals, cur, h1, h2,
           boundary, hh, hh_cur)


def _remaining(seen, allowed, n_f) -> torch.Tensor:
    """The windowed step's ``int32(max(floor(seen - where(allowed, n_f,
    0)), 0))``."""
    return torch.clamp_min(
        torch.floor(seen - torch.where(allowed, n_f, 0.0)),
        0.0).to(torch.int32)


def cascade_avail_plain(c: Cascade) -> torch.Tensor:
    """int64 (T+1,) availability of every scope (the JAX steps' operand
    of ``cascade_admit``). Windowed: ``tn_totals`` plus the tenant
    boundary term ``ceil(frac * f32(max(b, 0)))`` (f32, one multiply) as
    int64, clamped at 0 (ratelimiter_tpu/ops/sketch_kernels.py:390-398);
    bucket: ``tn_counts``, 0 when ``rolled`` (ops/bucket_kernels.py:
    176-179)."""
    if c.cur is None:
        counts = torch.zeros_like(c.counts) if c.rolled else c.counts
    else:
        est = c.counts.to(torch.int64)
        if c.slab is not None:
            est = est + torch.ceil(
                c.frac * torch.clamp_min(c.slab, 0).to(torch.float32)
            ).to(torch.int64)
        counts = torch.clamp_min(est, 0)
    return hier_kernels.scope_avail(c.hier["limit"], counts)


def cascade_admit_plain(c: Cascade, h1, allowed_key, iters: int) -> tuple:
    """Stages 2 and 3 of the cascade from the key scope's verdicts:
    ``derive_tids``, ``cascade_avail_plain`` and ``hier_kernels.
    cascade_admit``. Returns ``(allowed bool[B], hist int64[T+1])``."""
    T = c.tenants
    tid = hier_kernels.derive_tids(c.hier, h1, c.h2, T)
    return hier_kernels.cascade_admit(allowed_key, tid, c.n,
                                      cascade_avail_plain(c),
                                      c.hier["weight"], T, iters)


def cascade_fold_plain(c: Cascade, hist: torch.Tensor) -> None:
    """The admitted histogram into the scope counters, in place: the
    windowed ``tn_cur``/``tn_totals`` gain its int32 cast (wrapping), the
    bucket's ``tn_counts`` become ``(0 if rolled else tn_counts) +
    hist``."""
    if c.cur is None:
        if c.rolled:
            c.counts.zero_()
        c.counts.add_(hist)
    else:
        h32 = hier_kernels._wrap32(hist).to(torch.int32)
        c.cur.add_(h32)
        c.counts.add_(h32)


def key_admission(h1, n_units, avail, iters: int,
                  casc: Optional[Cascade] = None) -> tuple:
    """The step's admission: ``segment.admit`` of ``n_units`` against
    ``avail`` grouped on h1; with ``casc``, the cascade on its verdicts
    (folded into the scope counters) and the key scope's ``seen``
    recomputed under the final mask (``avail - segment_consumption``), as
    the reference does when a verdict flipped (the same bits when none
    did). Returns ``(allowed, seen)``."""
    allowed, seen, _ = admit(h1, n_units, avail, iters)
    if casc is None:
        return allowed, seen
    allowed, hist = cascade_admit_plain(casc, h1, allowed, iters)
    cascade_fold_plain(casc, hist)
    return allowed, avail - segment_consumption(
        h1, torch.where(allowed, n_units, 0))


def _vanilla_back(scatter, totals, cur, h1, h2, n, n_f, avail,
                  iters: int, est=None, mine=None, casc=None) -> tuple:
    """The vanilla step's back as composed ops: ``key_admission``, the
    admitted amounts of keys the side table does not own (``mine``)
    through ``scatter`` (``add_update_plain`` or the standalone kernel),
    and remaining; with ``mine``, also the promotion targets."""
    allowed, seen = key_admission(h1, n_f, avail, iters, casc)
    written = allowed if mine is None else allowed & ~mine
    scatter(totals, cur, h1, h2,
            torch.where(written, n, torch.zeros_like(n)).to(torch.int32))
    remaining = _remaining(seen, allowed, n_f)
    if mine is None:
        return allowed, remaining
    return (allowed, remaining,
            torch.where(allowed, est + (avail - seen) + n_f, est))


def add_back_plain(totals, cur, h1, h2, n, n_f, avail, iters: int,
                   est=None, mine=None, casc=None) -> tuple:
    """The vanilla step from the front's outputs to its results, in place
    on ``totals`` and ``cur``: in-batch admission of ``n_f`` against
    ``avail`` (``segment.admit``, grouped on h1), ``where(allowed, n, 0)``
    added at each key's column of every row (``add_update_plain``), and
    ``remaining``. Returns ``(allowed bool[B], remaining int32[B])``.
    With the side table's ``mine`` (and the front's ``est``), owned keys
    write nothing to the sketch (ratelimiter_tpu/ops/sketch_kernels.py:
    450) and a third element holds the promotion targets
    ``where(allowed, (est + (avail - seen)) + n_f, est)`` (:496). With
    the cascade's operands ``casc`` (``key_admission``), everything after
    admission reads the final mask (:376-415)."""
    return _vanilla_back(add_update_plain, totals, cur, h1, h2, n, n_f,
                         avail, iters, est, mine, casc)


def window_admit_plain(h1, est, n_f, avail, iters: int,
                       mine=None, casc=None) -> tuple:
    """The CU step's admission: ``segment.admit``, then the CU targets
    ``where(allowed, (est + (avail - seen)) + n_f, 0)`` and
    ``remaining``. Returns ``(target f32[B], allowed bool[B], remaining
    int32[B])``. With the side table's ``mine``, owned keys target 0
    (ratelimiter_tpu/ops/sketch_kernels.py:432) and a fourth element
    holds the promotion targets ``where(allowed, ..., est)`` (:496).
    With the cascade's operands ``casc``, admission is
    ``key_admission``'s."""
    allowed, seen = key_admission(h1, n_f, avail, iters, casc)
    v = est + (avail - seen) + n_f
    written = allowed if mine is None else allowed & ~mine
    out = (torch.where(written, v, 0.0), allowed,
           _remaining(seen, allowed, n_f))
    if mine is None:
        return out
    return (*out, torch.where(allowed, v, est))


def hh_update_plain(state, h1, h2, n, allowed, mine, target_pr, *,
                    thresh: float, period: int) -> None:
    """The side table's update, in place on ``state``'s ``hh_*`` tensors,
    as the JAX step computes it (ratelimiter_tpu/ops/sketch_kernels.py:
    487-532, dense (K,) passes): owned keys' admitted counts added to
    ``hh_cur`` and ``hh_totals`` (int32, wrapping); candidates (not
    owned, slot free, ``target_pr >= f32(thresh)``) claim their slot by
    a max of ``(ceil(clip(target_pr, 0, 2^30)) << 32) | h1``, the
    winner's h2 by a second max over the requests whose value equals
    their slot's claim; a free slot with a claim takes its owner and
    owner2; and ``hh_last = period`` at every slot an owned key or a
    candidate named."""
    owner, owner2 = state["hh_owner"], state["hh_owner2"]
    K = owner.shape[0]
    sid = h1 & (K - 1)
    hist = torch.zeros(K, dtype=torch.int32, device=h1.device).index_add_(
        0, sid, torch.where(allowed & mine, n, torch.zeros_like(n)))
    cand = ~mine & (owner[sid] == 0) & (
        target_pr >= float(np.float32(thresh)))
    mass = torch.ceil(torch.clamp(target_pr, 0.0, float(1 << 30))).to(
        torch.int64)
    packed = torch.where(cand, (mass << 32) | h1, 0)
    touched = torch.zeros(K, dtype=torch.int32, device=h1.device).index_add_(
        0, sid, (mine | cand).to(torch.int32)) > 0
    claims = torch.zeros(K, dtype=torch.int64, device=h1.device)
    claims.scatter_reduce_(0, sid, packed, "amax")
    winner = cand & (packed == claims[sid])
    h2w = torch.zeros(K, dtype=torch.int64, device=h1.device)
    h2w.scatter_reduce_(0, sid, torch.where(winner, h2, 0), "amax")
    claim_owner = claims & 0xFFFFFFFF
    newly = (owner == 0) & (claim_owner != 0)
    owner.copy_(torch.where(newly, claim_owner, owner))
    owner2.copy_(torch.where(newly, h2w, owner2))
    state["hh_cur"] += hist
    state["hh_totals"] += hist
    state["hh_last"].masked_fill_(touched, period)


# --------------------------------------------------------------- wrappers


def window_front(totals: torch.Tensor, keys, n: Optional[torch.Tensor] = None,
                 *, premix: bool = False, seed: int = 0,
                 boundary: Optional[Boundary] = None, policy=None,
                 limit: int = 0, hh: Optional[SideTable] = None) -> tuple:
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
    reads.

    With the side table ``hh`` (a compile-time variant of the kernel) each
    thread also loads its key's slot owner, side-table total and boundary
    cell with the others, and adds the owned part to the estimate before
    the quota; the seventh output ``(mine, est_cms, est_hh)`` is
    ``window_front_plain``'s. Three more loads and 9 bytes out a key."""
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
    K = 0 if hh is None else _check_side(hh, boundary is not None, dev)
    if dev.type == "cpu":
        return window_front_plain(totals, keys, n, premix=premix, seed=seed,
                                  boundary=boundary, policy=policy,
                                  limit=limit, hh=hh)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h64, h1, h2, seed, lane = _key_args(keys, premix, seed, B, dev)
    k = (1 if n is None else 3) + (0 if hh is None else 2)
    out = torch.empty(k * B + 1, dtype=torch.float32, device=dev)
    est, frac = out[:B], out[k * B]
    avail, n_f = (None, None) if n is None else (out[B:2 * B],
                                                out[2 * B:3 * B])
    bnd = (boundary.slab.data_ptr(), boundary.slab_period.data_ptr(),
           boundary.want, boundary.slot, float(boundary.e),
           float(boundary.rcp)) if boundary is not None else (
               None, None, 0, 0, 0.0, 0.0)
    side = ()
    hh_args = (None, None, None, 0, None, None, None)
    if hh is not None:
        mine = torch.empty(B, dtype=torch.bool, device=dev)
        est_cms, est_hh = out[(k - 2) * B:(k - 1) * B], out[(k - 1) * B:k * B]
        side = ((mine, est_cms, est_hh),)
        hh_args = (hh.owner.data_ptr(), hh.totals.data_ptr(), _ptr(hh.slab),
                   K, mine.data_ptr(), est_cms.data_ptr(),
                   est_hh.data_ptr())
    err = _lib().rl_window_front(
        totals.data_ptr(), *bnd, _ptr(h64), h1.data_ptr(), h2.data_ptr(),
        seed, lane, _ptr(n), *_policy_args(policy), limit, est.data_ptr(),
        frac.data_ptr(), _ptr(avail), _ptr(n_f), *hh_args, B, d, w,
        FRONT_THREADS, _stream(totals))
    _raise_on(err, "window_front")
    window_front.launches += 1
    return (h1, h2, est, frac if boundary is not None else None, avail,
            n_f, *side)


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


def _check_table(state: dict, device) -> int:
    """The side table's state tensors (``hh_*`` but the ring); returns
    K."""
    owner = state["hh_owner"]
    K = owner.shape[0] if owner.dim() == 1 else 0
    if K < 1 or K & (K - 1):
        raise ValueError(f"side table slots must be a power of two, got "
                         f"{tuple(owner.shape)}")
    for name, dtype in (("hh_owner", torch.int64), ("hh_owner2", torch.int64),
                        ("hh_cur", torch.int32), ("hh_totals", torch.int32),
                        ("hh_last", torch.int64)):
        _check(name, state[name], dtype, (K,), device)
    return K


def _check_tail(hh: Optional[SideUpdate], mine, device) -> None:
    if hh is None:
        return
    if mine is None:
        raise ValueError("the side table's update goes with mine")
    _check_table(hh.state, device)


def _tail_args(hh: Optional[SideUpdate], stream: int) -> tuple:
    """The C interface's tail operands (the table's five tensors, the
    global claim scratch above ``HH_SHARED_SLOTS`` slots, f32(thresh),
    the period, K); all null without a tail."""
    if hh is None:
        return (None,) * 6 + (0.0, 0, 0)
    st = hh.state
    K = st["hh_owner"].shape[0]
    claims = (None if K <= HH_SHARED_SLOTS
              else _hh_scratch(st["hh_owner"].device, K, stream).data_ptr())
    return (st["hh_owner"].data_ptr(), st["hh_owner2"].data_ptr(),
            st["hh_cur"].data_ptr(), st["hh_totals"].data_ptr(),
            st["hh_last"].data_ptr(), claims, float(np.float32(hh.thresh)),
            hh.period, K)


def _composed_tail(update, hh: SideUpdate, h1, h2, n, allowed, mine,
                   target_pr) -> None:
    """A back's tail as its own call after the back (the CPU's plain
    composition, and the card's above ``ADMIT_CAPACITY``): ``update`` is
    ``hh_update_plain`` or the standalone ``hh_update``."""
    update(hh.state, h1, h2, n, allowed, mine, target_pr, thresh=hh.thresh,
           period=hh.period)


def add_back(totals: torch.Tensor, cur: torch.Tensor, h1: torch.Tensor,
             h2: torch.Tensor, n: torch.Tensor, n_f: torch.Tensor,
             avail: torch.Tensor, iters: int,
             est: Optional[torch.Tensor] = None,
             mine: Optional[torch.Tensor] = None,
             casc: Optional[Cascade] = None,
             hh: Optional[SideUpdate] = None) -> tuple:
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
    composed on the card: the plain admission (and the plain cascade with
    ``casc``), then the standalone ``add_update`` kernel.

    With the side table's ``mine`` (and ``est``), a compile-time variant
    leaves owned keys out of the scatter and also writes the promotion
    targets, returned third (``add_back_plain``). Given the table too
    (``hh``, a ``SideUpdate``), that build runs the table's update as the
    launch's tail (csrc/hh.cuh: ``hh_update_plain``'s function on the
    block's final mask and targets, in place on ``hh.state``), counted in
    ``add_back.tail_launches``: the side-table step launches no
    ``hh_update``. The tail's scratch sits in the block's shared memory up
    to ``HH_SHARED_SLOTS`` slots (the launch grows its dynamic shared
    memory where the admission's storage has no room left after its
    results, for the scratch and the candidates' masses: at most ~180 KB,
    on the 1024-thread shape with 4096 slots), above that in global
    memory. Above ``ADMIT_CAPACITY`` keys the composed back is followed by
    the standalone ``hh_update`` kernel; on the CPU by
    ``hh_update_plain``.

    With the cascade's operands ``casc`` (``Cascade``), the cascade build
    runs csrc/cascade.cuh's routine in the same block after admission
    (stages 2 and 3, the key scope's consumption again under the final
    mask, the histogram folded into the scope counters), and the scatter
    and results read the final mask: still one launch, counted in
    ``add_back.cascade_launches`` too."""
    d, w, B = _check_common(totals, h1, h2)
    _check("cur", cur, torch.int32, (d, w), totals.device, align16=True)
    operands = {"n": (n, torch.int32), "n_f": (n_f, torch.float32),
                "avail": (avail, torch.float32)}
    if (est is None) != (mine is None):
        raise ValueError("the side table's mine goes with est")
    if mine is not None:
        operands.update(est=(est, torch.float32), mine=(mine, torch.bool))
    _check_back(h1, operands, iters)
    dev = totals.device
    if casc is not None:
        _check_cascade(casc, B, dev)
    _check_tail(hh, mine, dev)
    if dev.type == "cpu" or (dev.type == "cuda" and B > ADMIT_CAPACITY):
        cpu = dev.type == "cpu"
        out = _vanilla_back(add_update_plain if cpu else add_update, totals,
                            cur, h1, h2, n, n_f, avail, iters, est, mine,
                            casc)
        if hh is not None:
            _composed_tail(hh_update_plain if cpu else hh_update, hh, h1,
                           h2, n, out[0], mine, out[2])
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    allowed = torch.empty(B, dtype=torch.bool, device=dev)
    remaining = torch.empty(B, dtype=torch.int32, device=dev)
    target_pr = (None if mine is None
                 else torch.empty(B, dtype=torch.float32, device=dev))
    stream = _stream(totals)
    err = _lib().rl_add_back(
        totals.data_ptr(), cur.data_ptr(), h1.data_ptr(), h2.data_ptr(),
        n.data_ptr(), n_f.data_ptr(), avail.data_ptr(), _ptr(est),
        _ptr(mine), allowed.data_ptr(), remaining.data_ptr(),
        _ptr(target_pr), B, d, w, iters, *_cascade_args(casc),
        *_tail_args(hh, stream), stream)
    _raise_on(err, "add_back")
    add_back.launches += 1
    add_back.cascade_launches += casc is not None
    add_back.tail_launches += hh is not None
    return (allowed, remaining) if mine is None else (allowed, remaining,
                                                      target_pr)


def window_admit(h1: torch.Tensor, est: torch.Tensor, n_f: torch.Tensor,
                 avail: torch.Tensor, iters: int,
                 mine: Optional[torch.Tensor] = None,
                 casc: Optional[Cascade] = None, *,
                 hh: Optional[SideUpdate] = None,
                 h2: Optional[torch.Tensor] = None,
                 n: Optional[torch.Tensor] = None) -> tuple:
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
    runs on the card (with the plain cascade when ``casc`` is given).

    With the side table's ``mine``, a compile-time variant targets 0 for
    owned keys and also writes the promotion targets, returned fourth
    (``window_admit_plain``). Given the table too (``hh``, with the
    batch's ``h2`` and ``n``), that build runs its update as the launch's
    tail, as ``add_back``'s does (counted in
    ``window_admit.tail_launches``). With the cascade, the batch's ``h2``
    and ``n`` are the cascade's (``casc.h2``, ``casc.n``): others are
    refused. With the cascade's operands ``casc``,
    the cascade build (``add_back``'s) decides them all under the final
    mask and folds the scope counters, counted in
    ``window_admit.cascade_launches`` too."""
    operands = {"est": (est, torch.float32), "n_f": (n_f, torch.float32),
                "avail": (avail, torch.float32)}
    if mine is not None:
        operands["mine"] = (mine, torch.bool)
    if casc is not None:
        if (h2 is not None and h2 is not casc.h2) or (
                n is not None and n is not casc.n):
            raise ValueError("with the cascade, the batch's h2 and n are "
                             "the cascade's")
        h2, n = casc.h2, casc.n
    if hh is not None:
        if h2 is None or n is None:
            raise ValueError("the side table's update needs the batch's h2 "
                             "and n")
        operands.update(h2=(h2, torch.int64), n=(n, torch.int32))
    B = _check_back(h1, operands, iters)
    dev = h1.device
    if casc is not None:
        _check_cascade(casc, B, dev)
    _check_tail(hh, mine, dev)
    if dev.type == "cpu" or (dev.type == "cuda" and B > ADMIT_CAPACITY):
        out = window_admit_plain(h1, est, n_f, avail, iters, mine, casc)
        if hh is not None:
            _composed_tail(hh_update_plain if dev.type == "cpu"
                           else hh_update, hh, h1, h2, n, out[1], mine,
                           out[3])
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((1 if mine is None else 2) * B, dtype=torch.float32,
                      device=dev)
    target, target_pr = out[:B], (None if mine is None else out[B:])
    allowed = torch.empty(B, dtype=torch.bool, device=dev)
    remaining = torch.empty(B, dtype=torch.int32, device=dev)
    stream = _stream(h1)
    err = _lib().rl_window_admit(
        h1.data_ptr(), est.data_ptr(), n_f.data_ptr(), avail.data_ptr(),
        _ptr(mine), target.data_ptr(), allowed.data_ptr(),
        remaining.data_ptr(), _ptr(target_pr), B, iters, _ptr(h2), _ptr(n),
        *_cascade_args(casc), *_tail_args(hh, stream), stream)
    _raise_on(err, "window_admit")
    window_admit.launches += 1
    window_admit.cascade_launches += casc is not None
    window_admit.tail_launches += hh is not None
    if mine is None:
        return target, allowed, remaining
    return target, allowed, remaining, target_pr


#: The side table's claim scratch of each (device, K, stream) for tables
#: above ``HH_SHARED_SLOTS`` slots: (2, K) int64, the slots' claims then
#: the winners' h2, zero between launches (the update clears the slots it
#: touched before it ends).
_HH_SCRATCH: dict = {}


def _hh_scratch(device, K: int, stream: int) -> torch.Tensor:
    key = (str(device), K, stream)
    t = _HH_SCRATCH.get(key)
    if t is None:
        t = _HH_SCRATCH[key] = torch.zeros((2, K), dtype=torch.int64,
                                           device=device)
    return t


def hh_update(state: dict, h1: torch.Tensor, h2: torch.Tensor,
              n: torch.Tensor, allowed: torch.Tensor, mine: torch.Tensor,
              target_pr: torch.Tensor, *, thresh: float,
              period: int) -> None:
    """The side table's update (``hh_update_plain``'s function) in one
    launch of its own, in place on ``state``'s ``hh_*`` tensors: the
    form the composed back runs above ``ADMIT_CAPACITY`` (up to it the
    backs run the same routine as their tail). It replaces no TPU kernel:
    the JAX step computes it with jnp ops (ratelimiter_tpu/ops/
    sketch_kernels.py:487-532), in dense passes over all K slots.

    Bound on an H100: each key's h1, h2, n, allowed, mine and target_pr
    read once (26 bytes), and at each slot the batch names its owner
    read, ``hh_cur``/``hh_totals`` read and written, ``hh_last`` and (on
    a claim) the owner pair written: ~0.15 MB at B=4096, ~0.04 us at
    3.35 TB/s, whatever K is. Design (csrc/hh.cuh): ONE block. Up to
    ``HH_SHARED_SLOTS`` slots its scratch is per slot in shared memory,
    zeroed by a sweep: pass A over the batch adds owned counts and marks
    touched slots with native 32-bit shared atomics and takes each
    candidate's packed (mass, h1) claim by a 64-bit shared max; pass B
    the winners' h2; pass C sweeps the K slots and writes ``hh_cur``/
    ``hh_totals``, the owner pair and ``hh_last`` with one plain
    read-modify-write each, no global atomics. Above it (the 2^22
    ceiling), the passes work on a (2, K) int64 scratch in global memory
    (``_hh_scratch``) and touch only the slots the batch names, a fourth
    pass clearing them. The owner a key's candidacy reads is the one
    before the step in every pass: ownership is written only in the last.
    The launch is the cost at serving batch sizes."""
    dev = state["hh_owner"].device
    K = _check_table(state, dev)
    B = _check_back(h1, {"h2": (h2, torch.int64), "n": (n, torch.int32),
                         "allowed": (allowed, torch.bool),
                         "mine": (mine, torch.bool),
                         "target_pr": (target_pr, torch.float32)}, 1)
    if h1.device != dev:
        raise ValueError(f"h1 is on {h1.device}, expected {dev}")
    if dev.type == "cpu":
        return hh_update_plain(state, h1, h2, n, allowed, mine, target_pr,
                               thresh=thresh, period=period)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    stream = _stream(h1)
    args = _tail_args(SideUpdate(state, thresh, period), stream)
    err = _lib().rl_hh_update(
        *args[:6], h1.data_ptr(), h2.data_ptr(), n.data_ptr(),
        allowed.data_ptr(), mine.data_ptr(), target_pr.data_ptr(), args[6],
        period, B, K, stream)
    _raise_on(err, "hh_update")
    hh_update.launches += 1


def window_reset(totals: torch.Tensor, cur: torch.Tensor, h1: torch.Tensor,
                 h2: torch.Tensor, *, boundary: Optional[Boundary] = None,
                 hh: Optional[SideTable] = None,
                 hh_cur: Optional[torch.Tensor] = None) -> None:
    """The per-key reset of the keys (h1, h2) in one launch:
    ``window_reset_plain``'s function, in place on ``totals`` and ``cur``
    (and with the side table ``hh`` on ``hh.totals`` and ``hh_cur``). It
    replaces the reset's composition (the JAX package's ``_sketch_reset``,
    ratelimiter_tpu/ops/sketch_kernels.py:539-593: the estimate, Pallas
    ``window_estimate``'s function, then ``add_update`` of the negated
    floors), 4-9 launches on the card (the front, a floor, a cast and a
    negation, ``add_update``, and the same again on the side table).

    Bound on an H100: each key's h1 and h2, its d cells of ``totals`` and
    of the boundary and the boundary's period read, its d cells of
    ``totals`` and ``cur`` read and written (with the side table, its
    slot's owner, total and boundary cell read and its ``hh_totals``/
    ``hh_cur`` cells read and written): ~110 bytes a key at d=4, so one
    key is far below a launch. Design: ONE block, a thread a key (up to
    ``RESET_CAPACITY`` keys), each computing the front's estimate-only
    form with the front's own per-key code (csrc/sketch_kernels.cu
    ``load_cells``/``fold_cells``) and flooring it; one barrier, so that
    every estimate is read before any cell is written (two keys may
    share a column); then int32 atomics subtract each floor at the key's
    cells. A larger reset runs composed on the card (``window_front``,
    then ``add_update``), counted under those names."""
    d, w, B = _check_common(totals, h1, h2)
    dev = totals.device
    _check("cur", cur, torch.int32, (d, w), dev, align16=True)
    if boundary is not None:
        S = boundary.slab_period.shape[0]
        _check("boundary", boundary.slab, torch.int32, (d, w), dev)
        _check("slab_period", boundary.slab_period, torch.int64, (S,), dev)
        if not 0 <= boundary.slot < S:
            raise ValueError(f"boundary slot {boundary.slot} outside the "
                             f"ring of {S}")
    K = 0
    if hh is not None:
        K = _check_side(hh, boundary is not None, dev)
        if hh_cur is None:
            raise ValueError("the side table's reset needs hh_cur")
        _check("hh cur", hh_cur, torch.int32, (K,), dev)
    if dev.type == "cpu":
        return window_reset_plain(totals, cur, h1, h2, boundary=boundary,
                                  hh=hh, hh_cur=hh_cur)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if B > RESET_CAPACITY:
        return _reset(window_front, add_update, totals, cur, h1, h2,
                      boundary, hh, hh_cur)
    bnd = (boundary.slab.data_ptr(), boundary.slab_period.data_ptr(),
           boundary.want, boundary.slot, float(boundary.e),
           float(boundary.rcp)) if boundary is not None else (
               None, None, 0, 0, 0.0, 0.0)
    side = ((hh.owner.data_ptr(), hh.totals.data_ptr(), hh_cur.data_ptr(),
             _ptr(hh.slab)) if hh is not None else (None,) * 4)
    err = _lib().rl_window_reset(
        totals.data_ptr(), cur.data_ptr(), *bnd, h1.data_ptr(),
        h2.data_ptr(), *side, K, B, d, w, _stream(totals))
    _raise_on(err, "window_reset")
    window_reset.launches += 1


#: Each wrapper under the name of the TPU kernel it replaces (every form
#: of add_update under its name), and the side table's standalone update,
#: which replaces no TPU kernel, as ``hh_update``; the reset kernel, which
#: replaces the reset's estimate and ``add_update`` together, as
#: ``window_reset``.
KERNELS = {"window_estimate": (window_front,), "cu_update": (cu_update,),
           "add_update": (add_back, add_update), "hh_update": (hh_update,),
           "window_reset": (window_reset,)}
#: The backs, whose builds without the cascade and cascade builds are
#: counted apart: the fused vanilla back and the admission launch (which
#: replaces no TPU kernel); their side-table tails together as
#: ``hh_update [fused]``.
BACKS = {"add_back": add_back, "admit": window_admit}
WRAPPERS = (window_front, cu_update, add_update, add_back, window_admit,
            hh_update, window_reset)
for _fn in WRAPPERS:
    _fn.launches = 0
for _fn in BACKS.values():
    _fn.cascade_launches = 0
    _fn.tail_launches = 0


def launch_counts() -> dict:
    """{TPU kernel name (or ``hh_update``, ``window_reset``): launches of
    its replacement since the last reset}, for each back (``add_back``,
    ``admit``) the launches of its build without the cascade under its
    name and of its cascade build under ``<name> [cascade]``, and the
    backs' side-table tails under ``hh_update [fused]``."""
    counts = {name: sum(fn.launches for fn in fns)
              for name, fns in KERNELS.items()}
    for name, fn in BACKS.items():
        counts[name] = fn.launches - fn.cascade_launches
        counts[f"{name} [cascade]"] = fn.cascade_launches
    counts["hh_update [fused]"] = sum(fn.tail_launches
                                      for fn in BACKS.values())
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in BACKS.values():
        fn.cascade_launches = 0
        fn.tail_launches = 0
