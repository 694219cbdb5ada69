"""Batched decision steps over dense slot-addressed state — a port of
``ratelimiter_tpu/ops/dense_kernels.py``.

Each step decides a whole batch: gather the state of the batch's slots,
sequence same-slot requests with segment admission, write the consumed
amounts back. State lives on the device across calls; time is an
explicit int64-microsecond host operand.

The integer recurrences are bit-identical to algorithms/exact.py (see its
module docstring for the micro-token / window-scaled representations),
with an int64-overflow gate checked at build time (``check_gate_values``):
configs too large for the exact-integer path raise at construction.

State layout (int64 arrays of capacity+1 rows; the last row is the padding
slot batches are padded into — padding requests carry n=0 and are
discarded on the host):

* fixed window:  count, win_start (us)
* sliding:       curr, prev, win_start
* token bucket:  tokens (micro-tokens), rem (refill remainder), last (us)

Per-key policy overrides: each step optionally takes ``(policy, keyq)``,
the device copy of the sorted override table (``key``, ``limit``,
``window_us``, ``rate_num``, ``rate_den`` columns) and the batch's int64
search keys; each request's effective (limit, window, refill fraction) is
its row's, found by binary search (ops/policy_kernels.lookup_i64). Each
step returns ``(allowed, remaining, retry_us, reset_us)``, reset_us the
absolute reset/refill timestamp.

PyTorch idiom: a step updates the state dict IN PLACE (where the JAX
package donates the buffers). ``plain_step`` is the plain PyTorch version
of the step, the JAX steps' expressions with torch's floor division, split
where the kernels split it: ``dense_front_plain`` (phase A, the
per-request front) and ``dense_back_plain`` (phase B, admission and the
epilogue). ``dense_cuda.dense_step`` runs it for CPU tensors (and for CUDA
batches above the kernels' 8192) and the hand-written kernels
(``csrc/dense_kernels.cu``, two launches a step) for CUDA ones.
``_dense_scan``/``build_scan`` enqueue T steps back to back without a host
sync.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Tuple

import torch

from ratelimiter_tpu_torch.core.clock import MICROS, to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.core.types import Algorithm
from ratelimiter_tpu_torch.ops.policy_kernels import lookup_i64
from ratelimiter_tpu_torch.ops.segment import admit

State = Dict[str, torch.Tensor]
#: allowed, remaining, retry_us, reset_us (per request)
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: Each algorithm's state columns, in the kernel's (s0, s1, s2) order.
COLUMNS = {
    Algorithm.FIXED_WINDOW: ("count", "win_start"),
    Algorithm.SLIDING_WINDOW: ("curr", "prev", "win_start"),
    Algorithm.TPU_SKETCH: ("curr", "prev", "win_start"),
    Algorithm.TOKEN_BUCKET: ("tokens", "rem", "last"),
}


def check_gate_values(limit: int, window_us: int) -> tuple[int, int]:
    """Overflow gates for the exact-integer paths, for one (limit,
    window_us) operating point — the base config AND every policy-table
    override entry must pass (policy/table.py re-runs this per entry, so
    an override a kernel cannot decide exactly is refused at set time).
    Returns the reduced refill fraction (rate_num, rate_den)."""
    W = window_us
    g = math.gcd(limit * MICROS, W)
    num, den = limit * MICROS // g, W // g
    # token bucket: elapsed*num + rem with elapsed < W, rem < den
    if W * num >= 2**62:
        raise InvalidConfigError(
            "limit*window too large for exact integer token math "
            f"(window_us*rate_num = {W * num} >= 2^62)")
    # sliding window: counts*(W) terms and the micro-rescale (x % W) * MICROS
    if limit * W >= 2**61 or W * MICROS >= 2**63:
        raise InvalidConfigError(
            "limit*window too large for exact integer sliding-window math "
            f"(limit*window_us = {limit * W} >= 2^61)")
    # admission cumsum: batch_total <= B * limit * MICROS; B <= 2^20 assumed
    if limit * MICROS >= 2**42:
        raise InvalidConfigError(
            f"limit {limit} too large for micro-unit batch accounting (>= 2^42/1e6)")
    return num, den


def _check_gates(cfg: Config) -> tuple[int, int, int]:
    """Config-level gate wrapper. Returns (window_us, rate_num, rate_den)."""
    W = to_micros(cfg.window)
    num, den = check_gate_values(cfg.limit, W)
    return W, num, den


def _resolve(policy, keyq, names, defaults):
    """Per-request effective parameters: ``defaults`` (python ints) when no
    policy table rides the dispatch, else the binary-search lookup over
    the device table for each of ``names``."""
    if policy is None:
        return defaults
    idx, found = lookup_i64(policy["key"], keyq)
    return tuple(torch.where(found, policy[name][idx], default)
                 for name, default in zip(names, defaults))


def _bcast(x, like: torch.Tensor) -> torch.Tensor:
    """A (possibly scalar) time quantity at per-request shape, int64."""
    if isinstance(x, torch.Tensor):
        return x.expand(like.shape)
    return torch.full(like.shape, x, dtype=torch.int64, device=like.device)


def _scale_to_micro(x_winscale: torch.Tensor, window_us) -> torch.Tensor:
    """floor(x * MICROS / window_us) without int64 overflow, for
    x <= limit*window_us < 2^61 (``//`` and ``%`` floor, as jnp's).
    Exactness of comparisons is preserved: n*MICROS <= floor(x*MICROS/W)
    <=> n*W <= x for integer n."""
    q, r = x_winscale // window_us, x_winscale % window_us
    return q * MICROS + (r * MICROS) // window_us


def _fold(state: State, sid, consumed, column: str, values: dict) -> None:
    """The step's state write, in place: every touched row of each column
    in ``values`` takes its value (equal within a slot), then ``column``
    gains its slot's summed ``consumed`` (int64, wrapping) through
    ``values[column]``'s rule: ``//MICROS`` for the windowed counts, minus
    for the bucket's tokens."""
    for name, v in values.items():
        state[name][sid] = v
    delta = torch.zeros_like(state[column]).index_add_(0, sid, consumed)
    if column == "tokens":
        state[column].sub_(delta)
    else:
        state[column].add_(delta // MICROS)


# ------------------------------------------------- the kernel's two phases

#: The scratch rows the kernel's phase A writes per request, in order
#: (csrc/dense.cuh ``Row``): units, available units, the effective state
#: (count/curr/tokens, then prev/rem), the window start (the bucket's
#: refill denominator), the window and the bucket's refill numerator.
SCRATCH_ROWS = ("units", "avail", "e0", "e1", "start", "win", "num")

#: The rows each algorithm's phase A writes (the others stay unwritten).
USED_ROWS = {
    Algorithm.FIXED_WINDOW: (0, 1, 2, 4, 5),
    Algorithm.SLIDING_WINDOW: (0, 1, 2, 3, 4, 5),
    Algorithm.TPU_SKETCH: (0, 1, 2, 3, 4, 5),
    Algorithm.TOKEN_BUCKET: (0, 1, 2, 3, 4, 5, 6),
}


def dense_front_plain(state: State, sid, n, now_us: int, policy=None,
                      keyq=None, *, algorithm, limit, window_us, rate_num,
                      rate_den, **_) -> torch.Tensor:
    """The step's phase A (the kernel's ``rl_dense_front``): per request
    its effective parameters, its slot's rolled or refilled row, its units
    and available units, as the JAX step computes them before admission.
    Returns the int64 (len(SCRATCH_ROWS), B) scratch; rows outside
    ``USED_ROWS[algorithm]`` are 0. The state is only read."""
    out = torch.zeros((len(SCRATCH_ROWS), sid.shape[0]), dtype=torch.int64,
                      device=sid.device)
    bucket = algorithm is Algorithm.TOKEN_BUCKET
    names = ("limit", "window_us") + (("rate_num", "rate_den")
                                      if bucket else ())
    vals = _resolve(policy, keyq, names, (limit, window_us, rate_num,
                                          rate_den)[:len(names)])
    lim, W = vals[0], vals[1]
    out[0] = n * MICROS
    out[5] = _bcast(W, n)
    if algorithm is Algorithm.FIXED_WINDOW:
        cur_ws = (now_us // W) * W
        stale = state["win_start"][sid] != cur_ws
        count_eff = torch.where(stale, 0, state["count"][sid])
        out[1] = (lim - count_eff) * MICROS
        out[2] = count_eff
        out[4] = _bcast(cur_ws, n)
    elif bucket:
        num, den = vals[2], vals[3]
        cap = lim * MICROS
        elapsed = torch.clamp_min(now_us - state["last"][sid], 0)
        full = elapsed >= W
        acc = torch.where(full, 0, elapsed) * num + state["rem"][sid]
        tokens_r = state["tokens"][sid] + acc // den
        capped = full | (tokens_r >= cap)
        tokens_eff = torch.where(capped, cap, tokens_r)
        out[1] = tokens_eff
        out[2] = tokens_eff
        out[3] = torch.where(capped, 0, acc % den)
        out[4] = _bcast(den, n)
        out[6] = _bcast(num, n)
    else:
        cur_ws = (now_us // W) * W
        ws = state["win_start"][sid]
        curr = state["curr"][sid]
        current = ws == cur_ws
        curr_eff = torch.where(current, curr, 0)
        prev_eff = torch.where(current, state["prev"][sid],
                               torch.where(ws == cur_ws - W, curr, 0))
        free_scaled = (lim * W - prev_eff * (W - (now_us - cur_ws))
                       - curr_eff * W)
        out[1] = _scale_to_micro(free_scaled, W)
        out[2] = curr_eff
        out[3] = prev_eff
        out[4] = _bcast(cur_ws, n)
    return out


def dense_back_plain(state: State, sid, scratch: torch.Tensor, now_us: int,
                     *, algorithm, iters, **_) -> Outputs:
    """The step's phase B (the kernel's ``rl_dense_back``) over phase A's
    scratch: admission grouped on the slot, each touched row written (the
    effective values, then the consumption folded in), and the four
    results, in place on ``state``."""
    units, avail, e0, e1, start, win, num = scratch
    allowed, seen, consumed = admit(sid, units, avail, iters)
    if algorithm is Algorithm.FIXED_WINDOW:
        values, column = {"count": e0, "win_start": start}, "count"
    elif algorithm is Algorithm.TOKEN_BUCKET:
        values, column = {"tokens": e0, "rem": e1,
                          "last": _bcast(now_us, e0)}, "tokens"
    else:
        values, column = {"curr": e0, "prev": e1,
                          "win_start": start}, "curr"
    _fold(state, sid.long(), consumed, column, values)
    remaining = (seen - torch.where(allowed, units, 0)) // MICROS
    if algorithm is Algorithm.TOKEN_BUCKET:
        deficit = torch.clamp_min(units - seen, 0)
        retry_us = torch.where(allowed, 0, -((-deficit * start) // num))
        reset_us = now_us + win
    else:
        reset_us = start + win
        retry_us = torch.where(allowed, 0, reset_us - now_us)
    return allowed, remaining, retry_us, reset_us


def plain_step(state: State, sid, n, now_us: int, policy=None, keyq=None,
               **params) -> Outputs:
    """The plain step: phase A, then admission and the epilogue over its
    scratch, in place on ``state``; the JAX step's function."""
    scratch = dense_front_plain(state, sid, n, now_us, policy, keyq, **params)
    return dense_back_plain(state, sid, scratch, now_us, **params)


# ------------------------------------------------------------------- factory

def init_state(algorithm: Algorithm, capacity: int, limit: int,
               device="cpu") -> State:
    """Fresh state with capacity+1 rows (last = padding slot). Token buckets
    start full with last=0: the first touch sees elapsed >= window and
    saturates at capacity, which is exactly the reference's or-capacity
    default for absent keys (``tokenbucket.go:31-33``) — and with a policy
    override, the step's per-request cap clamp makes the first touch
    saturate at the KEY'S capacity."""
    n = capacity + 1
    state = {k: torch.zeros((n,), dtype=torch.int64, device=device)
             for k in COLUMNS[algorithm]}
    if algorithm is Algorithm.TOKEN_BUCKET:
        state["tokens"].fill_(limit * MICROS)
    return state


def step_params(cfg: Config) -> dict:
    """The step's static parameters for cfg (gated)."""
    if cfg.algorithm not in COLUMNS:
        raise InvalidConfigError(f"unsupported algorithm {cfg.algorithm}")
    W, num, den = _check_gates(cfg)
    return dict(algorithm=cfg.algorithm, limit=cfg.limit, window_us=W,
                rate_num=num, rate_den=den,
                iters=cfg.max_batch_admission_iters)


def build_step(cfg: Config) -> Callable[..., Outputs]:
    """The batched step for cfg's algorithm: ``step(state, sid, n, now_us[,
    policy, keyq])`` with ``sid`` int32[B] slots, ``n`` int64[B] and
    ``now_us`` a host int; updates ``state`` in place and returns
    ``(allowed, remaining, retry_us, reset_us)``. The optional trailing
    operands carry the device override table and the batch's int64 search
    keys."""
    from ratelimiter_tpu_torch.ops import dense_cuda

    return partial(dense_cuda.dense_step, **step_params(cfg))


def _dense_scan(state: State, sids, ns, now0_us: int, dt_us: int, *,
                step: Callable) -> tuple:
    """T sequential dense steps, enqueued back to back with no host sync
    (sketch_kernels._sketch_scan's shape for slot-addressed state). The
    leading axis of sids/ns is time; timestamps advance dt_us per step.
    Returns ``(state, packed_masks uint8 (T, B/8), deny_counts int32
    (T,))``; ``state`` is updated in place."""
    from ratelimiter_tpu_torch.ops.sketch_kernels import _pack_bits

    T, B = sids.shape
    packed = torch.empty((T, B // 8), dtype=torch.uint8, device=sids.device)
    denies = torch.empty((T,), dtype=torch.int32, device=sids.device)
    for i in range(T):
        allowed = step(state, sids[i], ns[i], now0_us + i * dt_us)[0]
        packed[i] = _pack_bits(allowed)
        denies[i] = (~allowed).sum(dtype=torch.int32)
    return state, packed, denies


def build_scan(cfg: Config) -> Callable:
    """Multi-step runner: ``scan(state, sids, ns, now0_us, dt_us) ->
    (state, packed_masks, deny_counts)``, T batches enqueued without a
    host sync — the amortized shape benchmarks use. Default policy only
    (policy-bearing traffic goes through build_step)."""
    return partial(_dense_scan, step=build_step(cfg))


def apply_window(state: State, algorithm: Algorithm, now_us: int,
                 W_old: int, W_new: int) -> None:
    """The dense backend's window migration (the JAX DenseLimiter's
    ``_apply_window`` body, plain torch on the state's device, in place):
    consumption stands, re-expiry on the NEW schedule, errs toward
    denying. Every grid quantity is a host scalar."""
    cur_old = (now_us // W_old) * W_old
    p_now = now_us // W_new
    new_start = p_now * W_new
    if algorithm is Algorithm.FIXED_WINDOW:
        # The live old window's span always reaches into the current
        # new-grid window (now < cur_old + W_old), so a live count is
        # always carried; stale slots zero.
        live = state["win_start"] == cur_old
        state["count"].copy_(torch.where(live, state["count"], 0))
        state["win_start"].copy_(torch.where(live, new_start, 0))
    elif algorithm is Algorithm.TOKEN_BUCKET:
        # Rate changes (the step's parameters); levels/last stand, the
        # remainder resets (< 1 micro-token, toward denying).
        state["rem"].zero_()
    else:
        ws = state["win_start"]
        on_cur = ws == cur_old
        on_prev = ws == cur_old - W_old
        curr = torch.where(on_cur, state["curr"], 0)
        prev = torch.where(on_cur, state["prev"],
                           torch.where(on_prev, state["curr"], 0))
        # The old curr bucket's span always overlaps the current new
        # window -> new curr. Old prev lands by its span end: current
        # window, the one before (weighted boundary), or aged out.
        q_prev = (cur_old - 1) // W_new
        new_curr = curr + (prev if q_prev >= p_now else 0)
        new_prev = prev if q_prev == p_now - 1 else torch.zeros_like(prev)
        keep = (new_curr > 0) | (new_prev > 0)
        state["curr"].copy_(torch.where(keep, new_curr, 0))
        state["prev"].copy_(torch.where(keep, new_prev, 0))
        state["win_start"].copy_(torch.where(keep, new_start, 0))
