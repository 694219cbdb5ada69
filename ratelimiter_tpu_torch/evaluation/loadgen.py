"""Device-side synthetic load generation — a port of
``ratelimiter_tpu/evaluation/loadgen.py``.

The request trace is synthesized on the device, so a benchmark measures
the limiter and not the host link:

* uniform u64 stream via the splitmix64 finalizer over a counter (the
  mixer of ops/hashing.py, on int64 tensors holding the u64 bits);
* bounded-Pareto inverse CDF maps uniforms to Zipf(alpha)-distributed key
  ids over [0, n_keys);
* ids are hashed to (h1, h2) exactly like real ingest, then decided by the
  sketch step (``sketch_kernels._sketch_step``); verdicts come back as
  packed bitmasks (1 bit a decision).

The ids are the JAX package's, bit for bit, on the CPU: its ``_zipf_ids``
is f32 ``log1p`` and ``exp``, which XLA compiles on the CPU into its own
polynomial approximations (not correctly rounded, and with each
single-use multiply-add contracted into an FMA), so a library's
``log1p``/``exp`` (torch's, CUDA's) differ from it in the last ulp in
about a fifth of the values and move ~0.2% of the ids. ``xla_log1p_f32``
and ``xla_exp_f32`` below spell XLA's instruction sequences out as
float32 operations, each IEEE-rounded in torch on the CPU and on the card
alike, with its FMAs as ``fma_f32`` (exact) and its constants;
tests/test_torch_eval.py holds the ids to the JAX package's over 2^20
counters.
"""

from __future__ import annotations

from typing import Callable

import torch

from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.ops import sketch_kernels
from ratelimiter_tpu_torch.ops.hashing import _i64, _shr, splitmix64_dev
from ratelimiter_tpu_torch.ops.sketch_cuda import fma_f32

_F32 = torch.float32

# XLA's CPU log1p (ElementalIrEmitter: a Cephes-style rational for |x| <
# sqrt(2) - 1, else its log polynomial of 1 + x) and exp (a range-reduced
# polynomial), the float32 constants of their emitted IR in order.
_LOG_MIN = 1.1754943508222875e-38          # 2^-126
_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
          0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
          0.11676998436450958, -0.16668057441711426, 0.3333333134651184)
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_L1P_P = (15.062909126281738, 83.04756927490234, 221.7624053955078,
          309.0987243652344, 216.42788696289062, 60.11865997314453)
_L1P_Q = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
          29.91191864013672, 60.949668884277344, 57.11296463012695,
          20.039552688598633)
_L1P_SMALL = 0.4142135679721832
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_EXP_P = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592)


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device (a 0-d tensor, so every
    operation stays float32)."""
    return torch.tensor(x, dtype=_F32, device=like.device)


def _log_f32(a: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log of ``a`` (the ``log_f32`` sequence)."""
    m = torch.where(a > _c(_LOG_MIN, a), a, _c(_LOG_MIN, a))
    bits = m.view(torch.int32)
    e = bits >> 23                          # m > 0: the sign bit is 0
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    e_f = (e - 127).to(_F32) + _c(1.0, a)
    lt = mant < _c(_SQRTHF, a)
    y = (mant + _c(-1.0, a)) + torch.where(lt, mant, _c(0.0, a))
    E = e_f - torch.where(lt, _c(1.0, a), _c(0.0, a))
    y2 = y * y
    y3 = y2 * y
    p = [fma_f32(fma_f32(y, _c(_LOG_P[2 * k], a), _c(_LOG_P[2 * k + 1], a)),
                 y, _c(_LOG_P[6 + k], a)) for k in range(3)]
    t = fma_f32(fma_f32(fma_f32(p[0], y3, p[1]), y3, p[2]), y3,
                E * _c(_LN2_LO, a))
    res = fma_f32(E, _c(_LN2_HI, a),
                  fma_f32(-y2, _c(0.5, a), y) + t)
    nan = torch.full_like(a, float("nan"))
    res = torch.where(a <= 0, nan, res)
    res = torch.where(a == 0, torch.full_like(a, float("-inf")), res)
    res = torch.where(a == float("inf"), a, res)
    return torch.where(torch.isnan(a), nan, res)


def xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 ``x`` as XLA computes it on the CPU."""
    large = _log_f32(x + _c(1.0, x))
    x2 = x * x
    p = _c(1.0, x).expand_as(x)
    for c in _L1P_P:
        p = fma_f32(p, x, _c(c, x))
    q = _c(_L1P_Q[0], x).expand_as(x)
    for c in _L1P_Q[1:]:
        q = fma_f32(q, x, _c(c, x))
    small = x + fma_f32(x2, _c(-0.5, x), (x * x2) * (q / p))
    return torch.where(x.abs() < _c(_L1P_SMALL, x), small, large)


def xla_exp_f32(p: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of float32 ``p`` as XLA computes it on the CPU, for
    results of at least 2^-126 (XLA flushes denormals)."""
    p = torch.where(p < _c(_EXP_LO, p), _c(_EXP_LO, p), p)
    p = torch.where(p > _c(_EXP_HI, p), _c(_EXP_HI, p), p)
    fl = torch.floor(fma_f32(p, _c(_LOG2E, p), _c(0.5, p)))
    fl = torch.where(fl < _c(-127.0, p), _c(-127.0, p), fl)
    fl = torch.where(fl > _c(127.0, p), _c(127.0, p), fl)
    r = fma_f32(-fl, _c(_LN2_LO, p), fma_f32(-fl, _c(_LN2_HI, p), p))
    q = fma_f32(r, _c(_EXP_P[0], p), _c(_EXP_P[1], p))
    for c in _EXP_P[2:]:
        q = fma_f32(q, r, _c(c, p))
    q = fma_f32(q, r, _c(0.5, p))
    q = fma_f32(q, r * r, r) + _c(1.0, p)
    scale = ((fl.to(torch.int32) << 23) + 0x3F800000).view(_F32)
    return q * scale


#: The splitmix64 finalizer on int64 tensors holding u64 bits (the JAX
#: package's name for it here).
_splitmix64_dev = splitmix64_dev


def _zipf_ids(counter0: int, B: int, n_keys: int, alpha: float,
              device) -> torch.Tensor:
    """(B,) Zipf(alpha)-distributed ids in [0, n_keys) as int64 (the JAX
    package's uint64 values): bounded-Pareto inverse CDF, x = (1 +
    u*((N+1)^(1-a) - 1))^(1/(1-a)), with the counter wrapping modulo 2^64."""
    ctr = torch.arange(B, dtype=torch.int64, device=device) + _i64(counter0)
    u64 = _splitmix64_dev(ctr)
    u = _shr(u64, 40).to(_F32) * _c(2.0 ** -24, u64)
    a1 = 1.0 - alpha                       # < 0
    hi = float((n_keys + 1) ** a1)
    x = xla_exp_f32(xla_log1p_f32(u * _c(hi - 1.0, u)) * _c(1.0 / a1, u))
    return torch.clamp(x.to(torch.int64) - 1, 0, n_keys - 1)


def hashed_halves(ids: torch.Tensor, seed: int) -> tuple:
    """(h1, h2) int64 halves of raw ids as real ingest derives them:
    ``splitmix64(ids ^ seed)``, low word, high word | 1."""
    h = _splitmix64_dev(ids ^ _i64(seed))
    return h & 0xFFFFFFFF, _shr(h, 32) | 1


def build_bench_chunk(cfg: Config, B: int, n_keys: int, alpha: float,
                      device="cuda") -> Callable:
    """``chunk(state, counter0, now_us, *, period) -> (state, packed,
    denies)``: generate B Zipf requests on the device, decide them in one
    sketch step, return the packed allow bitmask (B/8,) uint8 and the deny
    count (0-d int32). ``state`` is updated in place; ``period`` is its
    sub-window (the caller rolls over as with the step)."""
    kw = sketch_kernels._step_kw(cfg)
    seed = cfg.sketch.seed
    n = torch.ones((B,), dtype=torch.int32, device=device)

    def chunk(state, counter0: int, now_us: int, *, period: int):
        ids = _zipf_ids(counter0, B, n_keys, alpha, device)
        h1, h2 = hashed_halves(ids, seed)
        allowed = sketch_kernels._sketch_step(state, h1, h2, n, now_us,
                                              period=period, **kw)[0]
        packed = sketch_kernels._pack_bits(allowed)
        denies = (~allowed).sum(dtype=torch.int32)
        return state, packed, denies

    return chunk
