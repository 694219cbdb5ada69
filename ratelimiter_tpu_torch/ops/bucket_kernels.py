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
(where the JAX package donates the buffers). The step's front (hashing,
estimate, policy lookup, available quota, request units) and its table
update go through ops/bucket_cuda.py, and so does its admission with
consumed, remaining and retry (``bucket_admit``): the hand-written CUDA
kernels on a CUDA device, their plain versions on the CPU. Result
assembly and the reset's decay and subtraction are plain PyTorch.

The hierarchy cascade (``hierarchy.tenants`` = T > 0, ADR-020) counts
the tenant and global scopes as FIXED-WINDOW request counters, as the
JAX package does: ``tn_counts`` int64 (T+1,) (index T the global scope)
for the window ``tn_period`` = ``now_us // window_us``, a host scalar
like ``rem`` and ``last``. A step in a later window reads them as zero
and replaces them with its own admitted histogram (lazy zeroing); the
cascade runs in the back's cascade build (ops/bucket_cuda.py
``bucket_admit``), and a row the key scope admits but the cascade denies
retries when the scope window resets. A reset leaves them standing.

``build_scan`` is the multi-step runner of the bench's serving shape: T
steps enqueued back to back with no host sync (the decay is part of each
step, so no sub-window precondition).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import torch

from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.ops import bucket_cuda
from ratelimiter_tpu_torch.ops.bucket_cuda import DEBT_CAP as _DEBT_CAP
from ratelimiter_tpu_torch.ops.dense_kernels import (  # noqa: F401
    _check_gates,
    check_gate_values,
)
from ratelimiter_tpu_torch.ops.sketch_kernels import _PER_MICRO

State = Dict[str, torch.Tensor]


#: tn_period's initial value: every count reads as an earlier window's.
_TN_NEVER = -(1 << 40)


def init_state(cfg: Config, device) -> State:
    """All-zero debt (every bucket full) on ``device``; ``rem`` and
    ``last`` (and with tenants ``tn_period``) as int64 scalars on the host
    (module docstring). ``last = 0`` makes the first step see a huge
    elapsed whose decay is a no-op on zero debt. The same keys, shapes and
    dtypes as the JAX package's."""
    _check_gates(cfg)
    d, w = cfg.sketch.depth, cfg.sketch.width
    state = {
        "debt": torch.zeros((d, w), dtype=torch.int64, device=device),
        "acc": torch.zeros((d, w), dtype=torch.int64, device=device),
        "rem": torch.zeros((), dtype=torch.int64),
        "last": torch.zeros((), dtype=torch.int64),
    }
    T = cfg.hierarchy.tenants
    if T:
        state.update({
            "tn_counts": torch.zeros((T + 1,), dtype=torch.int64,
                                     device=device),
            "tn_period": torch.full((), _TN_NEVER, dtype=torch.int64),
        })
    return state


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


def _cascade(state: State, hier, h2, n, now_us: int, window_us: int):
    """The cascade's operands for the back (None without ``hier``): the
    scope counters of the window ``now_us // window_us``, read as zero
    when they count an earlier one; the window's reset is the retry of
    rows the cascade denies. Records the window in ``tn_period``."""
    if hier is None:
        return None
    hp = now_us // window_us
    period = int(state["tn_period"])
    state["tn_period"].fill_(max(period, hp))
    return bucket_cuda.Cascade(hier, h2, n, state["tn_counts"],
                               rolled=hp > period,
                               retry_us=(hp + 1) * window_us - now_us)


def _decide(state: State, keys, n, now_us: int, policy=None, hier=None, *,
            premix: bool, seed: int, limit: int, rate_num: int,
            rate_den: int, iters: int, window_us: int,
            clamp_acc: bool = False):
    """One decision step over a padded batch, updating ``state`` in place.

    ``keys`` the staged int64[B] hashes (raw ids with ``premix``) or an
    (h1, h2) pair of int64[B] halves, ``n`` int32[B] request counts (0 =
    padding). Returns ``(allowed bool[B], remaining int64[B], retry_us
    int64[B])``. ``clamp_acc`` asks the update to clamp every ``acc`` cell
    at 2^61, after a restore that brought cells above it (the JAX kernel
    does so on every call; ops/bucket_cuda.py). ``hier`` (the tenant
    table's device columns, with ``tn_*`` state) runs the cascade.

    Policy overrides change a key's burst CAPACITY (``limit_k`` micro-
    tokens); the decay rate stays the global limit/window, since colliding
    keys share debt cells (the JAX package's documented divergence)."""
    decay, rem = _decay(state, now_us, rate_num=rate_num, rate_den=rate_den)
    h1, h2, _, avail, n_units = bucket_cuda.bucket_front(
        state["debt"], decay, keys, n, premix=premix, seed=seed,
        policy=policy, limit=limit)
    casc = _cascade(state, hier, h2, n, now_us, window_us)
    allowed, consumed, remaining, retry_us = bucket_cuda.bucket_admit(
        h1, n_units, avail, iters, rate_num, rate_den, casc)
    bucket_cuda.bucket_update(state["debt"], state["acc"], decay, h1, h2,
                              consumed, clamp_acc)
    _advance(state, now_us, rem)
    return allowed, remaining, retry_us


def _bucket_step(state: State, h1, h2, n, now_us: int, policy=None,
                 hier=None, **kw):
    """``_decide`` on given (h1, h2) halves."""
    return _decide(state, (h1, h2), n, now_us, policy, hier, premix=False,
                   seed=0, **kw)


def _bucket_reset(state: State, h1, h2, now_us: int, *,
                  rate_num: int, rate_den: int) -> None:
    """Per-key reset, in place: decay the whole slab, then subtract the
    key's min-estimate from all its cells, clamped at 0 (colliding keys
    gain allowance: errs toward allowing). ``acc`` is left alone, as in the
    JAX package: the forgiven debt was real local traffic, and so are the
    tenant counters."""
    decay, rem = _decay(state, now_us, rate_num=rate_num, rate_den=rate_den)
    debt = state["debt"]
    d, w = debt.shape
    debt.sub_(decay).clamp_min_(0)
    est = bucket_cuda.bucket_front(debt, 0, (h1, h2))[2]
    # max(0, debt - hist(est)): integer subtractions in any order, then
    # one clamp.
    debt.view(-1).index_add_(0, bucket_cuda.flat_cells(h1, h2, d, w),
                             -est.repeat(d))
    debt.clamp_min_(0)
    _advance(state, now_us, rem)


def _bucket_scan(state: State, h1s, h2s, ns, now0_us: int, dt_us: int, *,
                 step_kw: dict) -> tuple:
    """T sequential bucket steps enqueued back to back with no host sync
    (the JAX package's ``_bucket_scan``, a lax.scan there). Timestamps
    advance dt_us per step; the leading axis of h1s/h2s (int64 halves)
    and ns (int32) is time. Returns ``(state, packed_masks uint8 (T,
    B/8), deny_counts int32 (T,))``; ``state`` is updated in place."""
    from ratelimiter_tpu_torch.ops.sketch_kernels import _pack_bits

    T, B = h1s.shape
    packed = torch.empty((T, B // 8), dtype=torch.uint8, device=h1s.device)
    denies = torch.empty((T,), dtype=torch.int32, device=h1s.device)
    for i in range(T):
        allowed = _bucket_step(state, h1s[i], h2s[i], ns[i],
                               now0_us + i * dt_us, **step_kw)[0]
        packed[i] = _pack_bits(allowed)
        denies[i] = (~allowed).sum(dtype=torch.int32)
    return state, packed, denies


def build_scan(cfg: Config) -> Callable:
    """Multi-step runner: ``scan(state, h1s, h2s, ns, now0_us, dt_us) ->
    (state, packed_masks, deny_counts)``, T batches enqueued without a
    host sync (the JAX package's ``build_scan``)."""
    return partial(_bucket_scan, step_kw=_params(cfg))


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
    window_us, num, den = _check_gates(cfg)
    return dict(limit=cfg.limit, rate_num=num, rate_den=den,
                iters=cfg.max_batch_admission_iters, window_us=window_us)


def build_steps(cfg: Config) -> tuple[Callable, Callable]:
    """(step, reset) callables for cfg: ``step(state, h1, h2, n, now_us,
    policy=None, hier=None)`` and ``reset(state, h1, h2, now_us)``, both
    updating state in place."""
    kw = _params(cfg)
    step = partial(_bucket_step, **kw)
    reset = partial(_bucket_reset, rate_num=kw["rate_num"],
                    rate_den=kw["rate_den"])
    return step, reset


def build_hashed_step(cfg: Config, *, premix: bool = False) -> Callable:
    """``step(state, h64, n, now_us, policy=None, hier=None)`` taking
    finalized 64-bit hashes (premix=False) or raw u64 ids (premix=True, splitmix64 runs
    in-step), each as an int64 tensor holding the bits."""
    return partial(_decide, seed=cfg.sketch.seed, premix=premix,
                   **_params(cfg))
