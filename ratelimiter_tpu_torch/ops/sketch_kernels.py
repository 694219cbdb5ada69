"""Count-min-sketch sliding-window step — a port of
``ratelimiter_tpu/ops/sketch_kernels.py`` (windowed sketch only).

Design, as in the JAX package:

* the window is covered by ``SW`` sub-windows of ``sub_us`` each; the
  current sub-window's counts live in ``cur int32[d, w]``, completed ones
  in the ring ``slabs int32[S, d, w]`` (S == SW); the oldest ring slab is
  the *boundary* sub-window, weighted by its remaining overlap ``frac``;
* ``totals int32[d, w]`` equals ``cur`` plus every fully-in-window ring
  slab; a step touches only ``totals`` and ``cur``, and the ring is read
  or written only by ``_rollover``, which the host dispatches once per
  sub-window;
* columns are ``(h1 + r*h2) mod w``; the estimate is the min over rows of
  ``totals + frac*boundary``, clamped at 0; admission is ops/segment.admit;
  writes are conservative (CU) or plain sums, and denied requests write
  nothing.

PyTorch idiom: the state is a dict of tensors that the step, the reset and
the rollover update IN PLACE (where the JAX package donates the buffers and
gets new ones back). Stream order keeps consecutive steps sequential. The
step's front (hashing, boundary weight, estimate, policy lookup, available
quota) and its back (admission, the CU targets or the vanilla table
update, remaining; then ``cu_update`` on the CU step) go through
ops/sketch_cuda.py: the hand-written CUDA kernels on a CUDA device, their
plain versions on the CPU. Result assembly is plain PyTorch.

Unlike the JAX step, which reads the period from ``state["last_period"]``,
the port's step takes it from the host (``period=``, the limiter's mirror
``_host_period``, equal to it by construction): the boundary slab is then
a zero-copy view ``slabs[period % S]`` and no device value is read back.
The boundary weight's operands are host scalars too (``frac_operands``);
the front kernel computes the weight itself.

A live ``update_window`` re-buckets the ring onto the new sub-window
geometry (``build_migrate``). It is plain PyTorch on the state's device:
the JAX package's migration is jitted ``jnp`` too, not a Pallas kernel.
Left out: the heavy-hitter and hierarchy branches of the JAX migration
(their configs are refused, ROADMAP A6) and the scan runner
``build_scan``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ratelimiter_tpu_torch.core.clock import to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.core.types import Algorithm
from ratelimiter_tpu_torch.ops import sketch_cuda

State = Dict[str, torch.Tensor]

#: slab_period init: far enough in the past that every slab reads as expired.
_NEVER = -(1 << 40)

#: Seconds per microsecond, as the f64 reciprocal XLA folds ``/ 1e6`` into.
_PER_MICRO = 1.0 / 1e6


def sketch_geometry(cfg: Config) -> tuple[int, int, int, int, int]:
    """Returns (window_us, sub_us, SW, S, limit); S == SW is the ring size.

    Fixed-window mode uses a single sub-window (the whole window) and no
    boundary weighting. Sliding mode uses the largest divisor of window_us
    that is <= the requested sketch.sub_windows."""
    if cfg.algorithm is Algorithm.TOKEN_BUCKET:
        raise InvalidConfigError(
            "the windowed sketch cannot serve a TOKEN_BUCKET config; "
            "the sketched token bucket (SketchTokenBucketLimiter, "
            "ops/bucket_kernels.py) does")
    if cfg.limit >= (1 << 24):
        raise InvalidConfigError(
            f"sketch backend requires limit < 2**24, got {cfg.limit}")
    W = to_micros(cfg.window)
    if cfg.algorithm is Algorithm.FIXED_WINDOW:
        SW = 1
    else:
        SW = next(k for k in range(min(cfg.sketch.sub_windows, W), 0, -1)
                  if W % k == 0)
    return W, W // SW, SW, SW, cfg.limit


def check_ported(cfg: Config) -> None:
    """Refuse the parts of the sketch that this slice does not port."""
    if cfg.sketch.hh_slots:
        raise InvalidConfigError(
            "the heavy-hitter side table (hh_slots > 0) is not ported yet "
            "(ROADMAP A6)")
    if cfg.hierarchy.enabled:
        raise InvalidConfigError(
            "the hierarchy cascade (hierarchy.tenants > 0) is not ported "
            "yet (ROADMAP A6)")
    sketch_geometry(cfg)


def init_state(cfg: Config, device) -> State:
    """Fresh windowed state on ``device``: the same keys, shapes and dtypes
    as the JAX package's init_state."""
    check_ported(cfg)
    _, _, _, S, _ = sketch_geometry(cfg)
    d, w = cfg.sketch.depth, cfg.sketch.width
    return {
        "cur": torch.zeros((d, w), dtype=torch.int32, device=device),
        "slabs": torch.zeros((S, d, w), dtype=torch.int32, device=device),
        "totals": torch.zeros((d, w), dtype=torch.int32, device=device),
        "slab_period": torch.full((S,), _NEVER, dtype=torch.int64,
                                  device=device),
        "last_period": torch.full((), _NEVER, dtype=torch.int64,
                                  device=device),
    }


def _rollover(state: State, p: int, *, SW: int, S: int) -> None:
    """Advance state to period p (p > last_period), in place: flush ``cur``
    into the ring at slot ``last_period % S``, recompute ``totals`` as the
    masked sum of ring slabs still fully inside the window (self-healing
    after reset subtractions) and zero ``cur``."""
    p_old = state["last_period"]
    slot = torch.remainder(p_old, S).view(1)
    state["slabs"].index_copy_(0, slot, state["cur"].unsqueeze(0))
    state["slab_period"].index_copy_(0, slot, p_old.view(1))
    periods = state["slab_period"]
    # Fully-in-window flushed periods: [p-SW+1, p-1]. (The boundary period
    # p-SW is read weighted at estimate time; period p is `cur`.)
    in_window = ((periods >= p - SW + 1) & (periods <= p - 1)).to(torch.int32)
    state["totals"].copy_((state["slabs"] * in_window.view(S, 1, 1))
                          .sum(0, dtype=torch.int32))
    state["cur"].zero_()
    state["last_period"].fill_(p)


def frac_operands(p: int, now_us: int, sub_us: int):
    """(e, rcp) of the boundary weight at now_us in period p:
    ``e = f32(now_us - p*sub_us)`` and ``rcp = f32(1) / f32(sub_us)``, NumPy
    float32 scalars."""
    return (np.float32(now_us - p * sub_us),
            np.float32(1.0) / np.float32(sub_us))


def _boundary(state: State, p: int, now_us: int, *, sub_us: int, SW: int,
              S: int, weighted: bool) -> Optional[sketch_cuda.Boundary]:
    """The sliding-window boundary sub-window for the front: the ring slab
    at ``p % S`` (a view), valid when it holds period p-SW; None in fixed
    mode."""
    if not weighted:
        return None
    slot = p % S
    return sketch_cuda.Boundary(state["slabs"][slot], state["slab_period"],
                                slot, p - SW,
                                *frac_operands(p, now_us, sub_us))


def _decide(state: State, keys, n, now_us: int, policy=None, *,
            premix: bool, seed: int, period: int, limit: int, sub_us: int,
            SW: int, S: int, iters: int, weighted: bool,
            conservative: bool):
    """One decision step over a padded batch, updating ``state`` in place.

    ``keys`` the staged int64[B] hashes (raw ids with ``premix``) or an
    (h1, h2) pair of int64[B] halves, ``n`` int32[B] request counts (0 =
    padding), ``now_us`` the batch timestamp. Precondition (host-enforced
    by the limiter's _sync_period): ``period`` is state's last_period.
    Returns ``(allowed bool[B], remaining int32[B], est f32[B])``."""
    # Clamp defends against clock skew backwards, as in the reference.
    now_us = max(now_us, period * sub_us)
    bnd = _boundary(state, period, now_us, sub_us=sub_us, SW=SW, S=S,
                    weighted=weighted)
    h1, h2, est, frac, avail, n_f = sketch_cuda.window_front(
        state["totals"], keys, n, premix=premix, seed=seed, boundary=bnd,
        policy=policy, limit=limit)
    if conservative:
        # Raise each touched cell only as high as the largest single-key
        # post-batch target that maps to it; denied requests target 0.
        target, allowed, remaining = sketch_cuda.window_admit(
            h1, est, n_f, avail, iters)
        sketch_cuda.cu_update(state["totals"], state["cur"],
                              None if bnd is None else bnd.slab, frac, h1,
                              h2, target)
    else:
        allowed, remaining = sketch_cuda.add_back(
            state["totals"], state["cur"], h1, h2, n, n_f, avail, iters)
    return allowed, remaining, est


def _sketch_step(state: State, h1, h2, n, now_us: int, policy=None, **kw):
    """``_decide`` on given (h1, h2) halves."""
    return _decide(state, (h1, h2), n, now_us, policy, premix=False, seed=0,
                   **kw)


def _sketch_reset(state: State, h1, h2, now_us: int, *, period: int,
                  sub_us: int, SW: int, S: int, weighted: bool) -> None:
    """Per-key reset, in place: subtract the key's current min-estimate
    from all its cells in both ``cur`` and ``totals`` (cells may go
    transiently negative; reads clamp at 0 and the next rollover heals).
    The estimate is the front's (without ``n``), the subtraction the
    add_update kernel with negated amounts."""
    now_us = max(now_us, period * sub_us)
    bnd = _boundary(state, period, now_us, sub_us=sub_us, SW=SW, S=S,
                    weighted=weighted)
    est = sketch_cuda.window_front(state["totals"], (h1, h2),
                                   boundary=bnd)[2]
    sub = torch.floor(est).to(torch.int32)
    sketch_cuda.add_update(state["totals"], state["cur"], h1, h2, -sub)


def finish_window(allowed, remaining, now_us: int, window_us: int):
    """Result assembly for windowed sketches: retry-after is the time to
    the window reset. Returns ``(allowed bool[B], remaining int64[B],
    retry f64[B], reset f64[B])``. The scalar arithmetic is the JAX
    package's as XLA compiles it: int64 micros, then a multiplication by
    the f64 reciprocal of 1e6 (XLA rewrites the division by the constant
    that way, and the two round differently in about a third of cases)."""
    cur_ws = (now_us // window_us) * window_us
    reset_s = float(cur_ws + window_us) * _PER_MICRO
    retry_s = float(cur_ws + window_us - now_us) * _PER_MICRO
    retry = torch.full(allowed.shape, retry_s, dtype=torch.float64,
                       device=allowed.device).masked_fill_(allowed, 0.0)
    reset = torch.full(allowed.shape, reset_s, dtype=torch.float64,
                       device=allowed.device)
    return allowed, remaining.to(torch.int64), retry, reset


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> (B/8,) uint8, little-endian bit order."""
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (mask.view(-1, 8).to(torch.uint8) << shifts).sum(
        1, dtype=torch.uint8)


def pack_wire(allowed, remaining, retry, reset):
    """Response packing for the hashed wire lane: the allow mask bit-packs
    to B/8 bytes and remaining/retry/reset ride ONE (3B,) int64 array
    (floats bitcast), as in the JAX package."""
    words = torch.cat([remaining.to(torch.int64),
                       retry.to(torch.float64).view(torch.int64),
                       reset.to(torch.float64).view(torch.int64)])
    return _pack_bits(allowed), words


def _step_kw(cfg: Config) -> dict:
    _, sub_us, SW, S, limit = sketch_geometry(cfg)
    return dict(limit=limit, sub_us=sub_us, SW=SW, S=S,
                iters=cfg.max_batch_admission_iters,
                weighted=cfg.algorithm is not Algorithm.FIXED_WINDOW,
                conservative=cfg.sketch.conservative_update)


def build_steps(cfg: Config) -> tuple[Callable, Callable, Callable]:
    """(step, reset, rollover) callables for cfg: ``step(state, h1, h2, n,
    now_us, policy=None, *, period)``, ``reset(state, h1, h2, now_us, *,
    period)`` and ``rollover(state, p)``, all updating state in place."""
    check_ported(cfg)
    kw = _step_kw(cfg)
    step = partial(_sketch_step, **kw)
    reset = partial(_sketch_reset, sub_us=kw["sub_us"], SW=kw["SW"],
                    S=kw["S"], weighted=kw["weighted"])
    rollover = partial(_rollover, SW=kw["SW"], S=kw["S"])
    return step, reset, rollover


def build_hashed_step(cfg: Config, *, premix: bool = False) -> Callable:
    """``step(state, h64, n, now_us, policy=None, *, period)`` taking
    finalized 64-bit hashes (premix=False) or raw u64 ids (premix=True,
    splitmix64 runs in-step), each as an int64 tensor holding the bits."""
    check_ported(cfg)
    return partial(_decide, seed=cfg.sketch.seed, premix=premix,
                   **_step_kw(cfg))


def policy_tensors(host: Dict[str, np.ndarray], device) -> dict:
    """Device copy of the override table's key and limit columns."""
    return {"key": torch.from_numpy(host["key"]).to(device),
            "limit": torch.from_numpy(host["limit"]).to(device)}


def _migrate_window(state: State, now_us: int, *, sub_o: int, SWo: int,
                    So: int, sub_n: int, SWn: int, Sn: int) -> State:
    """Re-bucket ring state onto a new sub-window geometry (dynamic window
    updates), returning new state tensors on the state's device. Every old
    sub-window's mass is attributed to the LAST new period its time span
    overlaps, so nothing expires earlier than it would have under either
    window — migration can only err toward denying, never over-admission.
    Mass mapped past the new window's tail (an old window longer than the
    new one) drops into the boundary-or-older region and ages out exactly
    like native history.

    The JAX package's int32 arithmetic is kept: the ring contraction is a
    masked sum with an int32 accumulator (``tensordot`` of int32 wraps
    there; CUDA has no integer matmul), the scatters are ``index_add_``
    and an int64 ``amax`` scatter, and ``//``/``%`` floor as jnp's do
    (``_NEVER`` slots make ``(sp + 1) * sub_o`` very negative; they are
    masked out, but their slot must still be a valid index)."""
    p_last = state["last_period"]
    p_now = now_us // sub_n
    sp = state["slab_period"]                              # (So,)
    valid = (sp >= p_last - SWo) & (sp <= p_last - 1)
    q = torch.div((sp + 1) * sub_o - 1, sub_n,
                  rounding_mode="floor")                   # last overlapped
    to_cur = valid & (q >= p_now)
    in_ring = valid & (q < p_now) & (q >= p_now - SWn)
    slot = torch.remainder(q, Sn)
    slabs, cur = state["slabs"], state["cur"]

    def masked(mask):
        return slabs * mask.view(-1, 1, 1).to(slabs.dtype)

    new_slabs = torch.zeros((Sn,) + tuple(slabs.shape[1:]),
                            dtype=slabs.dtype, device=slabs.device)
    new_slabs.index_add_(0, slot, masked(in_ring))
    # dtype pinned: an int32 sum must stay int32, as in the JAX package.
    new_cur = cur + masked(to_cur).sum(0, dtype=cur.dtype)
    periods_n = torch.full((Sn,), _NEVER, dtype=torch.int64,
                           device=sp.device)
    periods_n.scatter_reduce_(
        0, slot, torch.where(in_ring, q, torch.full_like(q, _NEVER)),
        "amax", include_self=True)
    in_window = ((periods_n >= p_now - SWn + 1)
                 & (periods_n <= p_now - 1)).to(torch.int32)
    totals_n = ((new_slabs * in_window.view(-1, 1, 1))
                .sum(0, dtype=torch.int32) + new_cur)
    return {"cur": new_cur, "slabs": new_slabs, "totals": totals_n,
            "slab_period": periods_n,
            "last_period": torch.full((), p_now, dtype=torch.int64,
                                      device=sp.device)}


def build_migrate(old_cfg: Config, new_cfg: Config) -> Callable:
    """``migrate(state, now_us) -> state`` moving ring state from
    old_cfg's window geometry to new_cfg's, on the state's device.
    Limit/depth/width must match (only the window changes)."""
    check_ported(old_cfg)
    check_ported(new_cfg)
    _, sub_o, SWo, So, _ = sketch_geometry(old_cfg)
    _, sub_n, SWn, Sn, _ = sketch_geometry(new_cfg)
    if (old_cfg.sketch.depth, old_cfg.sketch.width) != (
            new_cfg.sketch.depth, new_cfg.sketch.width):
        raise InvalidConfigError("window migration cannot change geometry")
    return partial(_migrate_window, sub_o=sub_o, SWo=SWo, So=So,
                   sub_n=sub_n, SWn=SWn, Sn=Sn)
