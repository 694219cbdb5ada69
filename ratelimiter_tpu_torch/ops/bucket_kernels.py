"""Sketched token bucket step — a port of ``ratelimiter_tpu/ops/bucket_kernels.py``.

TOKEN_BUCKET at unbounded key cardinality through the token-bucket <->
leaky-meter equivalence (GCRA), as in the JAX package: per-key *debt*
(``tokens = limit - debt``) lives in a count-min sketch, decays at the
refill rate ``limit/window`` and clamps at 0; a consume of n adds n to
debt; a request is allowed iff ``debt + n <= limit``. A cell holds the sum
of its colliding keys' debts, so the min-over-rows read can only
overestimate a key's debt: errors are false denies, never over-admission.

State (see init_state), all int64, units of micro-tokens (1 token = 10^6):

* ``debt [d, w]`` the debt cells, clamped at ``_DEBT_CAP`` on every write;
* ``acc [d, w]`` local debt increments since the last cross-pod export
  (the JAX package's DCN tier; the port carries it so that state moves
  between the packages intact);
* ``rem []`` the global decay remainder (< rate_den) and ``last []`` the
  timestamp of the last step, in microseconds.

Decay is exact integer math: every cell decays by the same scalar, which
depends only on ``now_us``, ``last``, ``rem`` and the config, never on
traffic. The port therefore keeps ``rem`` and ``last`` on the HOST (0-d
CPU tensors, whatever the slabs' device) and computes the decay in Python
integers (``_decay``); it reaches the kernels by value. No device value is
read back, and no scalar launch is spent on it.

PyTorch idiom: the step and the reset update the state dict IN PLACE
(where the JAX package donates the buffers). The two table accesses go
through ops/bucket_cuda.py: the hand-written CUDA kernels on a CUDA device,
their plain versions on the CPU. The rest of the step (hashing, lookup,
admit, retry and remaining, result assembly) and the whole reset are
plain PyTorch, as the JAX package computes them outside any Pallas kernel.

Not ported: the hierarchy cascade (``hierarchy.tenants > 0`` raises,
ROADMAP A6) and the scan runner ``_bucket_scan``/``build_scan``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict

import torch

from ratelimiter_tpu_torch.core.clock import MICROS, to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.ops import bucket_cuda, policy_kernels
from ratelimiter_tpu_torch.ops.bucket_cuda import DEBT_CAP as _DEBT_CAP
from ratelimiter_tpu_torch.ops.hashing import split_hash_dev, splitmix64_dev
from ratelimiter_tpu_torch.ops.segment import admit
from ratelimiter_tpu_torch.ops.sketch_kernels import _PER_MICRO

State = Dict[str, torch.Tensor]


def check_gate_values(limit: int, window_us: int) -> tuple[int, int]:
    """Overflow gates for the exact-integer paths, for one (limit,
    window_us) operating point (a copy of the JAX package's
    ``dense_kernels.check_gate_values``). Returns the reduced refill
    fraction (rate_num, rate_den) in micro-tokens per microsecond."""
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


def check_ported(cfg: Config) -> tuple[int, int, int]:
    """Refuse the parts of the bucket that this slice does not port, and
    configs the exact-integer gates refuse. Returns ``_check_gates``'s
    (window_us, rate_num, rate_den)."""
    if cfg.hierarchy.enabled:
        raise InvalidConfigError(
            "the hierarchy cascade (hierarchy.tenants > 0) is not ported "
            "yet (ROADMAP A6)")
    return _check_gates(cfg)


def init_state(cfg: Config, device) -> State:
    """All-zero debt (every bucket full) on ``device``; ``rem`` and
    ``last`` as int64 scalars on the host (module docstring). ``last = 0``
    makes the first step see a huge elapsed whose decay is a no-op on zero
    debt. The same keys, shapes and dtypes as the JAX package's."""
    check_ported(cfg)
    d, w = cfg.sketch.depth, cfg.sketch.width
    return {
        "debt": torch.zeros((d, w), dtype=torch.int64, device=device),
        "acc": torch.zeros((d, w), dtype=torch.int64, device=device),
        "rem": torch.zeros((), dtype=torch.int64),
        "last": torch.zeros((), dtype=torch.int64),
    }


def _decay(state, now_us: int, *, rate_num: int, rate_den: int):
    """Scalar micro-token decay since ``state["last"]``, and the new
    remainder, in Python integers (``state`` values may be ints or 0-d
    tensors). The JAX package's operation order is kept: ``acc`` is
    computed from the quotient BEFORE the quotient is clamped, so that
    idle-for-years elapsed values cannot overflow its int64 while the
    remainder stays the unclamped one."""
    elapsed = max(0, int(now_us) - int(state["last"]))
    e_q = elapsed // rate_den
    acc = (elapsed - e_q * rate_den) * rate_num + int(state["rem"])
    e_q = min(e_q, _DEBT_CAP // rate_num)
    decay = e_q * rate_num + acc // rate_den
    return decay, acc % rate_den


def _advance(state: State, now_us: int, rem: int) -> None:
    """Record the step's remainder and timestamp (host scalars)."""
    state["rem"].fill_(rem)
    state["last"].fill_(max(int(state["last"]), int(now_us)))


def _bucket_step(state: State, h1, h2, n, now_us: int, policy=None, *,
                 limit: int, rate_num: int, rate_den: int, iters: int,
                 clamp_acc: bool = False):
    """One decision step over a padded batch, updating ``state`` in place.

    ``h1``/``h2`` int64[B] hash halves, ``n`` int32[B] request counts (0 =
    padding). Returns ``(allowed bool[B], remaining int64[B], retry_us
    int64[B])``. ``clamp_acc`` asks the update to clamp every ``acc`` cell
    at 2^61, after a restore that brought cells above it (the JAX kernel
    does so on every call; ops/bucket_cuda.py).

    Policy overrides change a key's burst CAPACITY (``limit_k`` micro-
    tokens); the decay rate stays the global limit/window, since colliding
    keys share debt cells (the JAX package's documented divergence)."""
    decay, rem = _decay(state, now_us, rate_num=rate_num, rate_den=rate_den)
    est = bucket_cuda.bucket_estimate(state["debt"], decay, h1, h2)
    if policy is not None:
        q = policy_kernels.pack_halves(h1, h2)
        pidx, pfound = policy_kernels.lookup_i64(policy["key"], q)
        cap = torch.where(pfound, policy["limit"][pidx].to(torch.int64),
                          limit) * MICROS
    else:
        cap = limit * MICROS
    avail = torch.clamp_min(cap - est, 0)                 # micro-tokens
    n_units = n.to(torch.int64) * MICROS
    allowed, seen, consumed = admit(h1, n_units, avail, iters)
    bucket_cuda.bucket_update(state["debt"], state["acc"], decay, h1, h2,
                              consumed, clamp_acc)
    _advance(state, now_us, rem)
    remaining = (seen - torch.where(allowed, n_units, 0)) // MICROS
    # Reference retry semantics (``tokenbucket.go:122-130``): time to refill
    # the deficit, ceil'd to whole microseconds (int64 floor division).
    deficit = torch.clamp_min(n_units - seen, 0)
    retry_us = torch.where(allowed, 0, -((-deficit * rate_den) // rate_num))
    return allowed, remaining, retry_us


def _bucket_reset(state: State, h1, h2, now_us: int, *,
                  rate_num: int, rate_den: int) -> None:
    """Per-key reset, in place: decay the whole slab, then subtract the
    key's min-estimate from all its cells, clamped at 0 (colliding keys
    gain allowance: errs toward allowing). ``acc`` is left alone, as in the
    JAX package: the forgiven debt was real local traffic."""
    decay, rem = _decay(state, now_us, rate_num=rate_num, rate_den=rate_den)
    debt = state["debt"]
    d, w = debt.shape
    debt.sub_(decay).clamp_min_(0)
    est = bucket_cuda.bucket_estimate(debt, 0, h1, h2)
    # max(0, debt - hist(est)): integer subtractions in any order, then
    # one clamp.
    debt.view(-1).index_add_(0, bucket_cuda.flat_cells(h1, h2, d, w),
                             -est.repeat(d))
    debt.clamp_min_(0)
    _advance(state, now_us, rem)


def finish_bucket(allowed, remaining, retry_us, now_us: int, window_us: int):
    """Result assembly for the debt sketch: retry-after is the deficit over
    the refill rate, computed exactly by the step (``tokenbucket.go:122-130``);
    reset_at is the reference's approximation now + window. Returns
    ``(allowed bool[B], remaining int64[B], retry f64[B], reset f64[B])``.
    XLA compiles the JAX package's ``x / 1e6`` as ``x * (1/1e6)``, and so
    does the port (ROADMAP B, rounding)."""
    reset_s = float(now_us + window_us) * _PER_MICRO
    retry = retry_us.to(torch.float64) * _PER_MICRO
    reset = torch.full(allowed.shape, reset_s, dtype=torch.float64,
                       device=allowed.device)
    return allowed, remaining.to(torch.int64), retry, reset


def _params(cfg: Config) -> dict:
    _, num, den = check_ported(cfg)
    return dict(limit=cfg.limit, rate_num=num, rate_den=den,
                iters=cfg.max_batch_admission_iters)


def build_steps(cfg: Config) -> tuple[Callable, Callable]:
    """(step, reset) callables for cfg: ``step(state, h1, h2, n, now_us,
    policy=None)`` and ``reset(state, h1, h2, now_us)``, both updating
    state in place."""
    kw = _params(cfg)
    step = partial(_bucket_step, **kw)
    reset = partial(_bucket_reset, rate_num=kw["rate_num"],
                    rate_den=kw["rate_den"])
    return step, reset


def _bucket_step_h64(state: State, h64, n, now_us: int, policy=None, *,
                     seed: int, premix: bool, **step_kw):
    h = splitmix64_dev(h64) if premix else h64
    h1, h2 = split_hash_dev(h, seed)
    return _bucket_step(state, h1, h2, n, now_us, policy, **step_kw)


def build_hashed_step(cfg: Config, *, premix: bool = False) -> Callable:
    """``step(state, h64, n, now_us, policy=None)`` taking finalized 64-bit
    hashes (premix=False) or raw u64 ids (premix=True, splitmix64 runs
    in-step), each as an int64 tensor holding the bits."""
    return partial(_bucket_step_h64, seed=cfg.sketch.seed, premix=premix,
                   **_params(cfg))
