"""The collective mesh router's routing — a port of
``ratelimiter_tpu/ops/route_kernels.py``.

The host router (parallel/limiter.py ``SlicedMeshLimiter``) partitions
every mixed frame on the host: a stable argsort over the owner vector,
per-slice sub-launches and an index-map scatter of the results. The
collective router (parallel/collective.py) makes the frame one routed
dispatch instead:

1. each slice takes an even 1/n shard of the frame's (h64, ns) columns;
2. ``route_bins`` (one launch per source shard) computes each row's
   owner ``h64 % n`` on the device (raw-id lanes splitmix64 first — the
   rule of ``SlicedMeshLimiter.owner_of_id``), its stable rank among the
   shard's valid rows with that owner, and scatters the kept rows into
   fixed-capacity per-destination bins;
3. one ``all_to_all`` of the bins (parallel/mesh.py) routes rows to
   their owning slices, which compact them to the front in frame order
   (``compact``) and run the UNCHANGED step of their own slice;
4. the verdicts go back by the inverse all_to_all and gather into source
   row order (``return_route``).

Bit-identity with the host router holds because the owning slice runs
the same step on the same rows in the same order: a source shard is a
contiguous chunk of the frame, bins fill in shard order, and the
all_to_all concatenates source-major, so an owner's rows arrive in
global frame order — the order the host router's stable argsort feeds
that slice. Pad rows (key 0, n = 0) decide nothing and write nothing.

Bins have a fixed capacity C per (source, destination) pair
(``bin_capacity``, exactly the JAX package's). A source with more than C
rows for one destination sets its overflow flag; the router then leaves
every slice's state untouched and re-dispatches the frame through the
host router, so admission is never dropped or double-counted.

``route_bins`` is a hand-written CUDA kernel (csrc/route_kernels.cu); it
replaces the JAX router's jnp prologue (``_route``, its one-hot cumsum
and scatter), not a Pallas kernel. On a CPU tensor the wrapper runs
``route_bins_plain``, the plain PyTorch twin the tests hold to JAX's
``_route``; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ratelimiter_tpu_torch.ops import _build
from ratelimiter_tpu_torch.ops.hashing import splitmix64_dev

_SOURCE = "route_kernels"
_configured = set()

#: Empty bin slots travel with this ns sentinel, so a destination tells a
#: routed row from bin padding without an index column.
EMPTY = -1

#: The most slices one ``route_bins`` launch routes to (``kMaxSlices`` in
#: csrc/route_kernels.cu): its shared (warps x n) count table.
MAX_SLICES = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rl_route_bins.argtypes = [P, P, I, L, I, I, I, P, P, P, P, P, P]
        lib.rl_route_bins.restype = ctypes.c_int
        _configured.add(id(lib))
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _lib()


def bin_capacity(L: int, n: int, headroom: float) -> int:
    """Static per-(source, destination) bin capacity for an L-row shard
    on an n-slice mesh (the JAX package's rule, exactly). Clamped to
    [1, L]. With ``headroom >= 1`` two lower bounds apply on top of the
    multiplier: a floor of 8 rows (small mixed frames, where binomial
    noise dwarfs the L/n mean, do not overflow constantly) and the
    binomial tail ``mean + 4*sqrt(mean) + 8`` (each (source,
    destination) pair receives Bin(L, 1/n) rows); ``headroom < 1`` skips
    both, so tests can force capacity-1 bins and the fallback."""
    c = int(-(-int(headroom * L) // n)) if headroom > 0 else 1
    if headroom >= 1.0:
        mean = L / n
        tail = int(mean + 4.0 * mean ** 0.5 + 8)
        c = max(c, 8, tail)
    return max(1, min(L, c))


class Bins(NamedTuple):
    """One source shard's routing: ``send_h`` int64 (n*C,) (the rows'
    raw h64 bits, 0 in empty slots), ``send_ns`` int32 (n*C,) (``EMPTY``
    in empty slots), ``binpos`` int32 (L,) (``owner * C + rank``),
    ``keep`` bool (L,) (valid and ranked below C) and ``ovf`` int32 (1,)
    (1 when a valid row found its bin full)."""

    send_h: torch.Tensor
    send_ns: torch.Tensor
    binpos: torch.Tensor
    keep: torch.Tensor
    ovf: torch.Tensor


def route_bins_plain(h64: torch.Tensor, ns: torch.Tensor, valid: int,
                     n: int, C: int, premix: bool) -> Bins:
    """The plain version: JAX's ``_route`` up to the all_to_all
    (ratelimiter_tpu/ops/route_kernels.py:89-124) on one shard. ``valid``
    is how many of the shard's L rows are frame rows (``b - src*L``,
    clamped to [0, L])."""
    L = h64.shape[0]
    dev = h64.device
    valid_src = torch.arange(L, device=dev) < valid
    hfin = splitmix64_dev(h64) if premix else h64
    # u64 % n on int64 bits: the unsigned remainder.
    owner = _umod(hfin, n)
    oh = ((owner[:, None] == torch.arange(n, device=dev)[None, :])
          & valid_src[:, None]).to(torch.int64)
    rank = torch.gather(torch.cumsum(oh, 0) - oh, 1,
                        owner[:, None])[:, 0]
    keep = valid_src & (rank < C)
    ovf = torch.any(valid_src & (rank >= C)).to(torch.int32).reshape(1)
    binpos = owner * C + rank
    pos = torch.where(keep, binpos, torch.full_like(binpos, n * C))
    send_h = torch.zeros(n * C + 1, dtype=torch.int64, device=dev)
    send_h.index_copy_(0, pos, torch.where(keep, h64, 0))
    send_ns = torch.full((n * C + 1,), EMPTY, dtype=torch.int32, device=dev)
    send_ns.index_copy_(0, pos, torch.where(keep, ns, EMPTY))
    return Bins(send_h[:n * C], send_ns[:n * C], binpos.to(torch.int32),
                keep, ovf)


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``uint64(h) % n`` for int64 tensors holding u64 bits."""
    if n & (n - 1) == 0:
        return h & (n - 1)
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    # (hi * 2^32 + lo) % n, with every partial product below 2^63.
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def route_bins(h64: torch.Tensor, ns: torch.Tensor, valid: int, n: int,
               C: int, premix: bool) -> Bins:
    """One source shard's routing prologue (``route_bins_plain``'s
    function): on a CUDA tensor one launch of csrc/route_kernels.cu, on
    the CPU the plain version.

    Bound on an H100: each row's h64 and ns read once and binpos and
    keep written once, the (n, C) bins written once: ~L*17 + n*C*12
    bytes, ~0.2 MB at L = 4096, n = 4, C ~ 1100 — ~0.06 us at 3.35
    TB/s, far below one launch. Design: one block walks the rows in
    order, ranks them by warp match and a shared per-owner scan, and
    scatters the kept rows (csrc/route_kernels.cu)."""
    L = h64.shape[0]
    dev = h64.device
    if h64.dtype != torch.int64 or ns.dtype != torch.int32 or h64.dim() != 1:
        raise ValueError("route_bins takes int64 h64 and int32 ns (L,)")
    if ns.shape != h64.shape or ns.device != dev:
        raise ValueError(f"ns {tuple(ns.shape)} on {ns.device} does not "
                         f"match h64 {tuple(h64.shape)} on {dev}")
    if not 1 <= n <= MAX_SLICES or C < 1:
        raise ValueError(f"route_bins needs 1 <= n <= {MAX_SLICES} and "
                         f"C >= 1, got n={n}, C={C}")
    valid = max(0, min(L, int(valid)))
    if dev.type == "cpu":
        return route_bins_plain(h64, ns, valid, n, C, premix)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h64, ns = h64.contiguous(), ns.contiguous()
    out = Bins(torch.empty(n * C, dtype=torch.int64, device=dev),
               torch.empty(n * C, dtype=torch.int32, device=dev),
               torch.empty(L, dtype=torch.int32, device=dev),
               torch.empty(L, dtype=torch.bool, device=dev),
               torch.empty(1, dtype=torch.int32, device=dev))
    err = _lib().rl_route_bins(
        h64.data_ptr(), ns.data_ptr(), L, valid, n, C, int(premix),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"route_bins: CUDA error {err} at launch")
    route_bins.launches += 1
    return out


route_bins.launches = 0


def compact(recv_h: torch.Tensor, recv_ns: torch.Tensor) -> tuple:
    """A destination's received bins -> its owned rows compacted to the
    front in global frame order, padded with decision-inert (0, 0) rows
    (JAX ``_route``:125-131). Returns ``(h_own, ns_own, order)``."""
    valid_r = recv_ns != EMPTY
    order = torch.argsort((~valid_r).to(torch.int8), stable=True)
    vr = valid_r[order]
    h_own = torch.where(vr, recv_h[order], 0)
    ns_own = torch.where(vr, recv_ns[order], 0)
    return h_own, ns_own, order


def uncompact(col: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """A result column in compacted order -> bin order (the inverse
    scatter of JAX ``_return_route``:137-143, before its all_to_all)."""
    back = torch.zeros_like(col)
    back[order] = col
    return back


def gather_back(ret: torch.Tensor, bins: Bins) -> torch.Tensor:
    """A source's returned bin column -> its rows in shard order; rows
    it never shipped (overflow) read slot 0, and the frame goes to the
    host router then, so the values never reach a client."""
    safe = torch.where(bins.keep, bins.binpos, 0).to(torch.int64)
    return ret[safe]


def launch_counts() -> dict:
    return {"route_bins": route_bins.launches}


def reset_launch_counts() -> None:
    route_bins.launches = 0
