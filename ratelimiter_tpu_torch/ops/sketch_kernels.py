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
three table accesses go through ops/sketch_cuda.py: the hand-written CUDA
kernels on a CUDA device, their plain versions on the CPU. The rest of the
step (hashing, lookup, admit, result assembly) is plain PyTorch.

Unlike the JAX step, which reads the period from ``state["last_period"]``,
the port's step takes it from the host (``period=``, the limiter's mirror
``_host_period``, equal to it by construction): the boundary slab is then
a zero-copy view ``slabs[period % S]`` and no device value is read back.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import numpy as np
import torch

from ratelimiter_tpu_torch.core.clock import to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.core.types import Algorithm
from ratelimiter_tpu_torch.ops import policy_kernels, sketch_cuda
from ratelimiter_tpu_torch.ops.hashing import split_hash_dev, splitmix64_dev
from ratelimiter_tpu_torch.ops.segment import admit

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


def boundary_frac(p: int, now_us: int, sub_us: int) -> float:
    """The boundary sub-window's remaining-overlap weight at now_us,
    ``clip(1 - elapsed/sub_us, 0, 1)`` in f32 as the JAX reference computes
    it once XLA has compiled it: the division by the constant ``sub_us``
    becomes a multiplication by its f32 reciprocal, and ``1 - e*r`` one
    fused multiply-add. (So frac is not always a multiple of 2^-24.)"""
    e = torch.tensor(np.float32(now_us - p * sub_us))
    r = torch.tensor(np.float32(1.0) / np.float32(sub_us))
    return float(sketch_cuda.fma_f32(-e, r, torch.tensor(np.float32(1.0)))
                 .clamp(0.0, 1.0))


def _boundary_weight(state: State, p: int, now_us: int, *, sub_us: int,
                     SW: int, S: int, weighted: bool):
    """(frac, boundary) for the sliding-window boundary sub-window:
    ``frac`` a 0-d f32 tensor (0 when the slab at ``p % S`` is not period
    p-SW), ``boundary`` a view of that ring slab; (None, None) in fixed
    mode."""
    if not weighted:
        return None, None
    b_idx = p % S
    valid = state["slab_period"][b_idx] == p - SW
    frac = valid.to(torch.float32) * boundary_frac(p, now_us, sub_us)
    return frac, state["slabs"][b_idx]


def _estimate(state: State, h1, h2, p: int, now_us: int, *, sub_us: int,
              SW: int, S: int, weighted: bool):
    """Min-over-rows window estimate at each key's columns, clamped at 0
    (the direct regime of the JAX package's _estimate, through the
    window_estimate kernel). Returns (est, frac, boundary)."""
    frac, boundary = _boundary_weight(state, p, now_us, sub_us=sub_us,
                                      SW=SW, S=S, weighted=weighted)
    est = sketch_cuda.window_estimate(state["totals"], boundary, frac, h1, h2)
    return torch.clamp_min(est, 0.0), frac, boundary


def _sketch_step(state: State, h1, h2, n, now_us: int, policy=None, *,
                 period: int, limit: int, sub_us: int, SW: int, S: int,
                 iters: int, weighted: bool, conservative: bool):
    """One decision step over a padded batch, updating ``state`` in place.

    ``h1``/``h2`` int64[B] hash halves, ``n`` int32[B] request counts (0 =
    padding), ``now_us`` the batch timestamp. Precondition (host-enforced
    by the limiter's _sync_period): ``period`` is state's last_period.
    Returns ``(allowed bool[B], remaining int32[B], est f32[B])``."""
    # Clamp defends against clock skew backwards, as in the reference.
    now_us = max(now_us, period * sub_us)
    est, frac, boundary = _estimate(state, h1, h2, period, now_us,
                                    sub_us=sub_us, SW=SW, S=S,
                                    weighted=weighted)
    if policy is not None:
        q = policy_kernels.pack_halves(h1, h2)
        pidx, pfound = policy_kernels.lookup_i64(policy["key"], q)
        lim_f = torch.where(pfound, policy["limit"][pidx],
                            limit).to(torch.float32)
    else:
        lim_f = float(limit)     # exact in f32: limits are < 2^24
    avail = torch.clamp_min(lim_f - est, 0.0)
    n_f = n.to(torch.float32)
    allowed, seen, _ = admit(h1, n_f, avail, iters)

    if conservative:
        # Raise each touched cell only as high as the largest single-key
        # post-batch target that maps to it; denied requests target 0.
        target = torch.where(allowed, est + (avail - seen) + n_f, 0.0)
        sketch_cuda.cu_update(state["totals"], state["cur"], boundary, frac,
                              h1, h2, target)
    else:
        add = torch.where(allowed, n, torch.zeros_like(n)).to(torch.int32)
        sketch_cuda.add_update(state["totals"], state["cur"], h1, h2, add)

    remaining = torch.clamp_min(
        torch.floor(seen - torch.where(allowed, n_f, 0.0)),
        0.0).to(torch.int32)
    return allowed, remaining, est


def _sketch_reset(state: State, h1, h2, now_us: int, *, period: int,
                  sub_us: int, SW: int, S: int, weighted: bool) -> None:
    """Per-key reset, in place: subtract the key's current min-estimate
    from all its cells in both ``cur`` and ``totals`` (cells may go
    transiently negative; reads clamp at 0 and the next rollover heals).
    The subtraction is the add_update kernel with negated amounts."""
    now_us = max(now_us, period * sub_us)
    est, _, _ = _estimate(state, h1, h2, period, now_us, sub_us=sub_us,
                          SW=SW, S=S, weighted=weighted)
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


def _sketch_step_h64(state: State, h64, n, now_us: int, policy=None, *,
                     period: int, seed: int, premix: bool, **step_kw):
    h = splitmix64_dev(h64) if premix else h64
    h1, h2 = split_hash_dev(h, seed)
    return _sketch_step(state, h1, h2, n, now_us, policy, period=period,
                        **step_kw)


def build_hashed_step(cfg: Config, *, premix: bool = False) -> Callable:
    """``step(state, h64, n, now_us, policy=None, *, period)`` taking
    finalized 64-bit hashes (premix=False) or raw u64 ids (premix=True,
    splitmix64 runs in-step), each as an int64 tensor holding the bits."""
    check_ported(cfg)
    return partial(_sketch_step_h64, seed=cfg.sketch.seed, premix=premix,
                   **_step_kw(cfg))


def policy_tensors(host: Dict[str, np.ndarray], device) -> dict:
    """Device copy of the override table's key and limit columns."""
    return {"key": torch.from_numpy(host["key"]).to(device),
            "limit": torch.from_numpy(host["limit"]).to(device)}
