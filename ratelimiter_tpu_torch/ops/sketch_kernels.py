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

The heavy-hitter side table (``hh_slots`` = K > 0) is a direct-mapped
table of private per-key ring cells for promoted hot keys (``hh_*``
state, slot ``h1 & (K-1)``, identity h1, sharing the sketch's period
clock): an owned key's new traffic counts exactly in its cell and not in
the sketch, and its estimate is the sketch's plus its cell's; an unowned
key whose post-batch target crosses ``max(1, limit * hh_promote_fraction)``
claims its free slot (the hottest candidate wins, ties by h1); a slot
idle for a whole window is freed at rollover. On the device the slot
owners are int64 holding 0..2^32-1 (uint32 in the JAX package and at the
NumPy boundary, convert.py). The step's front reads the table, its back
masks owned keys out of the sketch writes, and ``hh_update`` does the
rest (ops/sketch_cuda.py); the JAX package runs the jnp reference for
this config (its Pallas path is off with a side table), so the port's
kernels are held to that.

The hierarchy cascade (``hierarchy.tenants`` = T > 0, ADR-020) adds
per-tenant and global in-window counters on the same ring clock
(``tn_cur`` (T+1,), ``tn_slabs`` (S, T+1), ``tn_totals`` (T+1,), int32,
index T the global scope), flushed and recomputed by the rollover. The
step takes the tenant table's device columns (``hier=``): after the key
scope's admission the back runs stages 2 and 3 (tenant scope, then the
global scope's weighted fair share; ops/hier_kernels.py), writes and
reports only what the final all-or-nothing mask admits, and folds the
admitted histogram into ``tn_cur``/``tn_totals``, all in the cascade
build of its one launch (ops/sketch_cuda.py ``Cascade``). The tenant
boundary term rides the front's ``frac``. A reset leaves the tenant
counters standing (they count admitted aggregate traffic).

A live ``update_window`` re-buckets the ring (and the side table's and
the tenant counters') onto the new sub-window geometry
(``build_migrate``). It is plain PyTorch on the state's device, as the
rollover is: the JAX package's migration and rollover are jitted ``jnp``
too, not Pallas kernels.

``build_scan`` is the multi-step runner of the bench's serving shape: T
steps enqueued back to back with no host sync, packed masks and deny
counts out, within one sub-window (the precondition is refused when
broken, where the JAX scan clamps).
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


def init_state(cfg: Config, device) -> State:
    """Fresh windowed state on ``device``: the same keys, shapes and dtypes
    as the JAX package's init_state."""
    _, _, _, S, _ = sketch_geometry(cfg)
    d, w = cfg.sketch.depth, cfg.sketch.width
    state = {
        "cur": torch.zeros((d, w), dtype=torch.int32, device=device),
        "slabs": torch.zeros((S, d, w), dtype=torch.int32, device=device),
        "totals": torch.zeros((d, w), dtype=torch.int32, device=device),
        "slab_period": torch.full((S,), _NEVER, dtype=torch.int64,
                                  device=device),
        "last_period": torch.full((), _NEVER, dtype=torch.int64,
                                  device=device),
    }
    T = cfg.hierarchy.tenants
    if T:
        # Per-tenant + global in-window counters on the ring's clock; index
        # T is the global scope.
        state.update({
            "tn_cur": torch.zeros((T + 1,), dtype=torch.int32,
                                  device=device),
            "tn_slabs": torch.zeros((S, T + 1), dtype=torch.int32,
                                    device=device),
            "tn_totals": torch.zeros((T + 1,), dtype=torch.int32,
                                     device=device),
        })
    K = cfg.sketch.hh_slots
    if K:
        # The owners (hh_owner: h1; hh_owner2: its h2, captured at claim
        # time for the JAX package's DCN export) are uint32 there, int64
        # holding the same values here. 0 marks a free slot, so a key
        # whose h1 is 0 never claims one.
        state.update({
            "hh_owner": torch.zeros((K,), dtype=torch.int64, device=device),
            "hh_owner2": torch.zeros((K,), dtype=torch.int64, device=device),
            "hh_cur": torch.zeros((K,), dtype=torch.int32, device=device),
            "hh_slabs": torch.zeros((S, K), dtype=torch.int32,
                                    device=device),
            "hh_totals": torch.zeros((K,), dtype=torch.int32, device=device),
            "hh_last": torch.full((K,), _NEVER, dtype=torch.int64,
                                  device=device),
        })
    return state


def _masked_sum(slabs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over the ring axis of the slabs ``mask`` (S,) keeps, with an
    int32 accumulator (the JAX package's int32 ``tensordot``, which
    wraps; CUDA has no integer matmul)."""
    shape = (-1,) + (1,) * (slabs.dim() - 1)
    return (slabs * mask.to(slabs.dtype).view(shape)).sum(
        0, dtype=slabs.dtype)


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
    in_window = (periods >= p - SW + 1) & (periods <= p - 1)
    state["totals"].copy_(_masked_sum(state["slabs"], in_window))
    state["cur"].zero_()
    if "tn_cur" in state:
        # The tenant/global counters share the ring clock.
        state["tn_slabs"].index_copy_(0, slot, state["tn_cur"].unsqueeze(0))
        state["tn_totals"].copy_(_masked_sum(state["tn_slabs"], in_window))
        state["tn_cur"].zero_()
    if "hh_owner" in state:
        # The side table rides the same clock: flush, recompute, and free
        # slots idle a whole window (their in-window counts are zero).
        state["hh_slabs"].index_copy_(0, slot, state["hh_cur"].unsqueeze(0))
        state["hh_totals"].copy_(_masked_sum(state["hh_slabs"], in_window))
        idle = state["hh_last"] <= p - SW
        state["hh_owner"].masked_fill_(idle, 0)
        state["hh_owner2"].masked_fill_(idle, 0)
        state["hh_cur"].zero_()
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


def _side(state: State, p: int, *, S: int,
          weighted: bool) -> Optional[sketch_cuda.SideTable]:
    """The side table as the front reads it (None without one): its
    boundary column is the view ``hh_slabs[p % S]``, valid with the
    sketch's boundary (the front's frac carries that)."""
    if "hh_owner" not in state:
        return None
    return sketch_cuda.SideTable(
        state["hh_owner"], state["hh_totals"],
        state["hh_slabs"][p % S] if weighted else None)


def _cascade(state: State, hier, h2, n, frac, *, period: int, S: int,
             weighted: bool) -> Optional[sketch_cuda.Cascade]:
    """The cascade's operands for the back (None without ``hier``): the
    tenant counters, and in sliding mode the tenant boundary sub-window
    ``tn_slabs[p % S]`` (a view) weighted by the front's ``frac``."""
    if hier is None:
        return None
    return sketch_cuda.Cascade(
        hier, h2, n, state["tn_totals"], state["tn_cur"],
        state["tn_slabs"][period % S] if weighted else None,
        frac if weighted else None)


def _decide(state: State, keys, n, now_us: int, policy=None, hier=None, *,
            premix: bool, seed: int, period: int, limit: int, sub_us: int,
            SW: int, S: int, iters: int, weighted: bool,
            conservative: bool, hh_thresh: float = 0.0):
    """One decision step over a padded batch, updating ``state`` in place.

    ``keys`` the staged int64[B] hashes (raw ids with ``premix``) or an
    (h1, h2) pair of int64[B] halves, ``n`` int32[B] request counts (0 =
    padding), ``now_us`` the batch timestamp. Precondition (host-enforced
    by the limiter's _sync_period): ``period`` is state's last_period.
    With a side table in ``state``, ``hh_thresh`` is its promotion
    threshold. ``hier`` (the tenant table's device columns, with
    ``tn_*`` state) runs the cascade. Returns
    ``(allowed bool[B], remaining int32[B], est f32[B])``."""
    # Clamp defends against clock skew backwards, as in the reference.
    now_us = max(now_us, period * sub_us)
    bnd = _boundary(state, period, now_us, sub_us=sub_us, SW=SW, S=S,
                    weighted=weighted)
    side = _side(state, period, S=S, weighted=weighted)
    h1, h2, est, frac, avail, n_f, *parts = sketch_cuda.window_front(
        state["totals"], keys, n, premix=premix, seed=seed, boundary=bnd,
        policy=policy, limit=limit, hh=side)
    # Owned keys (mine) count in their side-table cell, not the sketch.
    mine = parts[0][0] if parts else None
    casc = _cascade(state, hier, h2, n, frac, period=period, S=S,
                    weighted=weighted)
    if conservative:
        # Raise each touched cell only as high as the largest single-key
        # post-batch target that maps to it; denied requests target 0.
        target, allowed, remaining, *target_pr = sketch_cuda.window_admit(
            h1, est, n_f, avail, iters, mine, casc)
        sketch_cuda.cu_update(state["totals"], state["cur"],
                              None if bnd is None else bnd.slab, frac, h1,
                              h2, target)
    else:
        allowed, remaining, *target_pr = sketch_cuda.add_back(
            state["totals"], state["cur"], h1, h2, n, n_f, avail, iters,
            None if mine is None else est, mine, casc)
    if mine is not None:
        sketch_cuda.hh_update(state, h1, h2, n, allowed, mine, target_pr[0],
                              thresh=hh_thresh, period=period)
    return allowed, remaining, est


def _sketch_step(state: State, h1, h2, n, now_us: int, policy=None,
                 hier=None, **kw):
    """``_decide`` on given (h1, h2) halves."""
    return _decide(state, (h1, h2), n, now_us, policy, hier, premix=False,
                   seed=0, **kw)


def _sketch_reset(state: State, h1, h2, now_us: int, *, period: int,
                  sub_us: int, SW: int, S: int, weighted: bool) -> None:
    """Per-key reset, in place: subtract the key's current min-estimate
    from all its cells in both ``cur`` and ``totals`` (cells may go
    transiently negative; reads clamp at 0 and the next rollover heals).
    The estimate is the front's (without ``n``), the subtraction the
    add_update kernel with negated amounts. With a side table, the
    sketch loses the sketch's part of the estimate only and an owned
    key's cell its own part, each floored, as in the reference; the
    cell's subtraction is the same kernel on the (1, K) table, whose
    row-0 column is the slot ``h1 & (K-1)``. The tenant counters stand:
    a reset forgives a key, not its tenant's admitted traffic."""
    now_us = max(now_us, period * sub_us)
    bnd = _boundary(state, period, now_us, sub_us=sub_us, SW=SW, S=S,
                    weighted=weighted)
    side = _side(state, period, S=S, weighted=weighted)
    out = sketch_cuda.window_front(state["totals"], (h1, h2), boundary=bnd,
                                   hh=side)
    est = out[2] if side is None else out[6][1]
    sub = torch.floor(est).to(torch.int32)
    sketch_cuda.add_update(state["totals"], state["cur"], h1, h2, -sub)
    if side is not None:
        K = state["hh_owner"].shape[0]
        sub_hh = torch.floor(out[6][2]).to(torch.int32)
        sketch_cuda.add_update(state["hh_totals"].view(1, K),
                               state["hh_cur"].view(1, K), h1, h2, -sub_hh)


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


def _sketch_scan(state: State, h1s, h2s, ns, now0_us: int, dt_us: int, *,
                 period: int, step_kw: dict) -> tuple:
    """T sequential sketch steps enqueued back to back with no host sync
    (the JAX package's ``_sketch_scan``, a lax.scan there). Timestamps
    advance dt_us per step; the leading axis of h1s/h2s (int64 halves)
    and ns (int32) is time. Returns ``(state, packed_masks uint8 (T,
    B/8), deny_counts int32 (T,))``; ``state`` is updated in place.

    Precondition, as in the JAX scan: the whole chunk lies within the
    sub-window ``period`` (the state's, from the host like the step's),
    so the caller splits chunks at period boundaries and rolls over
    between them. The JAX scan would freeze time at the stale period
    past its end; here a chunk reaching past it is refused. The JAX scan
    hoists the boundary slab and the side table's boundary column out of
    its body; here each step rebuilds them as views of the ring, which
    costs no device work. No tenant table rides the chunk, so ``tn_*``
    state carries through untouched."""
    T, B = h1s.shape
    sub_us = step_kw["sub_us"]
    if dt_us < 0 or (now0_us + (T - 1) * dt_us) // sub_us > period:
        raise ValueError(
            f"a scan chunk must lie within its sub-window {period} "
            f"(ending at {(period + 1) * sub_us} us): {T} steps from "
            f"{now0_us} us at +{dt_us} us reach past it; split the chunk "
            f"and roll over between")
    packed = torch.empty((T, B // 8), dtype=torch.uint8, device=h1s.device)
    denies = torch.empty((T,), dtype=torch.int32, device=h1s.device)
    for i in range(T):
        allowed = _sketch_step(state, h1s[i], h2s[i], ns[i],
                               now0_us + i * dt_us, period=period,
                               **step_kw)[0]
        packed[i] = _pack_bits(allowed)
        denies[i] = (~allowed).sum(dtype=torch.int32)
    return state, packed, denies


def build_scan(cfg: Config) -> Callable:
    """Multi-step runner: ``scan(state, h1s, h2s, ns, now0_us, dt_us, *,
    period) -> (state, packed_masks, deny_counts)``, T batches enqueued
    without a host sync (the JAX package's ``build_scan``, one dispatch
    there)."""
    return partial(_sketch_scan, step_kw=_step_kw(cfg))


def pack_wire(allowed, remaining, retry, reset):
    """Response packing for the hashed wire lane: the allow mask bit-packs
    to B/8 bytes and remaining/retry/reset ride ONE (3B,) int64 array
    (floats bitcast), as in the JAX package."""
    words = torch.cat([remaining.to(torch.int64),
                       retry.to(torch.float64).view(torch.int64),
                       reset.to(torch.float64).view(torch.int64)])
    return _pack_bits(allowed), words


def _hh_threshold(cfg: Config) -> float:
    """The side table's promotion threshold in requests (the JAX package's
    ``_hh_params``), 0 when the side table is disabled. The step compares
    targets with it as f32."""
    if not cfg.sketch.hh_slots:
        return 0.0
    return max(1.0, float(cfg.limit) * cfg.sketch.hh_promote_fraction)


def _step_kw(cfg: Config) -> dict:
    _, sub_us, SW, S, limit = sketch_geometry(cfg)
    return dict(limit=limit, sub_us=sub_us, SW=SW, S=S,
                iters=cfg.max_batch_admission_iters,
                weighted=cfg.algorithm is not Algorithm.FIXED_WINDOW,
                conservative=cfg.sketch.conservative_update,
                hh_thresh=_hh_threshold(cfg))


def build_steps(cfg: Config) -> tuple[Callable, Callable, Callable]:
    """(step, reset, rollover) callables for cfg: ``step(state, h1, h2, n,
    now_us, policy=None, hier=None, *, period)``, ``reset(state, h1, h2,
    now_us, *, period)`` and ``rollover(state, p)``, all updating state in
    place."""
    kw = _step_kw(cfg)
    step = partial(_sketch_step, **kw)
    reset = partial(_sketch_reset, sub_us=kw["sub_us"], SW=kw["SW"],
                    S=kw["S"], weighted=kw["weighted"])
    rollover = partial(_rollover, SW=kw["SW"], S=kw["S"])
    return step, reset, rollover


def build_hashed_step(cfg: Config, *, premix: bool = False) -> Callable:
    """``step(state, h64, n, now_us, policy=None, hier=None, *, period)``
    taking finalized 64-bit hashes (premix=False) or raw u64 ids
    (premix=True, splitmix64 runs in-step), each as an int64 tensor
    holding the bits."""
    return partial(_decide, seed=cfg.sketch.seed, premix=premix,
                   **_step_kw(cfg))


def policy_tensors(host: Dict[str, np.ndarray], device) -> dict:
    """Device copy of the override table's key and limit columns."""
    return {"key": torch.from_numpy(host["key"]).to(device),
            "limit": torch.from_numpy(host["limit"]).to(device)}


def hier_tensors(host: Dict[str, np.ndarray], device) -> dict:
    """Device copy of the tenant table's columns (``key``/``tid`` map,
    ``limit``/``weight`` per scope; hierarchy/tenants.py host_arrays)."""
    return {k: torch.from_numpy(np.ascontiguousarray(host[k])).to(device)
            for k in ("key", "tid", "limit", "weight")}


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
    masked out, but their slot must still be a valid index).

    The side table's ring and current cells, and the tenant counters,
    re-bucket the same way; the side table's owners carry over, and each
    slot's last touched period maps to the last new period its old one
    overlaps, ``_NEVER`` staying ``_NEVER``."""
    p_last = state["last_period"]
    p_now = now_us // sub_n
    sp = state["slab_period"]                              # (So,)
    valid = (sp >= p_last - SWo) & (sp <= p_last - 1)
    q = torch.div((sp + 1) * sub_o - 1, sub_n,
                  rounding_mode="floor")                   # last overlapped
    to_cur = valid & (q >= p_now)
    in_ring = valid & (q < p_now) & (q >= p_now - SWn)
    slot = torch.remainder(q, Sn)

    def rebucket(slabs, cur):
        shape = (-1,) + (1,) * (slabs.dim() - 1)
        new_slabs = torch.zeros((Sn,) + tuple(slabs.shape[1:]),
                                dtype=slabs.dtype, device=slabs.device)
        new_slabs.index_add_(
            0, slot, slabs * in_ring.view(shape).to(slabs.dtype))
        return new_slabs, cur + _masked_sum(slabs, to_cur)

    new_slabs, new_cur = rebucket(state["slabs"], state["cur"])
    periods_n = torch.full((Sn,), _NEVER, dtype=torch.int64,
                           device=sp.device)
    periods_n.scatter_reduce_(
        0, slot, torch.where(in_ring, q, torch.full_like(q, _NEVER)),
        "amax", include_self=True)
    in_window = (periods_n >= p_now - SWn + 1) & (periods_n <= p_now - 1)
    out = {"cur": new_cur, "slabs": new_slabs,
           "totals": _masked_sum(new_slabs, in_window) + new_cur,
           "slab_period": periods_n,
           "last_period": torch.full((), p_now, dtype=torch.int64,
                                     device=sp.device)}
    if "tn_cur" in state:
        tn_slabs, tn_cur = rebucket(state["tn_slabs"], state["tn_cur"])
        out.update({"tn_cur": tn_cur, "tn_slabs": tn_slabs,
                    "tn_totals": _masked_sum(tn_slabs, in_window) + tn_cur})
    if "hh_owner" in state:
        hh_slabs, hh_cur = rebucket(state["hh_slabs"], state["hh_cur"])
        last = state["hh_last"]
        q_hh = torch.div((last + 1) * sub_o - 1, sub_n, rounding_mode="floor")
        out.update({
            "hh_owner": state["hh_owner"], "hh_owner2": state["hh_owner2"],
            "hh_cur": hh_cur, "hh_slabs": hh_slabs,
            "hh_totals": _masked_sum(hh_slabs, in_window) + hh_cur,
            "hh_last": torch.where(last == _NEVER, last, q_hh),
        })
    return out


def build_migrate(old_cfg: Config, new_cfg: Config) -> Callable:
    """``migrate(state, now_us) -> state`` moving ring state (and the
    side table's) from old_cfg's window geometry to new_cfg's, on the
    state's device. Limit/depth/width/hh must match (only the window
    changes)."""
    _, sub_o, SWo, So, _ = sketch_geometry(old_cfg)
    _, sub_n, SWn, Sn, _ = sketch_geometry(new_cfg)
    if (old_cfg.sketch.depth, old_cfg.sketch.width) != (
            new_cfg.sketch.depth, new_cfg.sketch.width):
        raise InvalidConfigError("window migration cannot change geometry")
    return partial(_migrate_window, sub_o=sub_o, SWo=SWo, So=So,
                   sub_n=sub_n, SWn=SWn, Sn=Sn)
