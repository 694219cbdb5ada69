"""On-device exact oracle — a port of
``ratelimiter_tpu/evaluation/oracle_device.py``: sketch accuracy measured
at the benched operating point, inside the benched run.

The oracle is the sketch step itself instantiated collision-free: depth
1, width >= n_keys (a power of two), and *identity* halves (h1 = key id,
h2 = 0, so ``col = id``). Every key gets a private cell per sub-window —
an exact per-key sliding-window counter with the same time discretization
and the same in-batch greedy admission as the sketch under test, with
plain sums (vanilla update). The sketch-vs-oracle disagreement is
therefore pure collision / conservative-update error.

The halves reach the step on its halves lane, where nothing forces h2
odd (only the hashed lanes do ``| 1``): h2 = 0 gives column ``id & (w-1)``
in the front and the vanilla back alike.

Both limiters decide the same device-generated trace in one chunk
(evaluation/loadgen.py), so accuracy costs one more step, not a host
round trip per decision.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

import torch

from ratelimiter_tpu_torch.core.config import Config, HierarchySpec
from ratelimiter_tpu_torch.evaluation.loadgen import _zipf_ids, hashed_halves
from ratelimiter_tpu_torch.ops import sketch_kernels


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _oracle_config(cfg: Config, n_keys: int) -> Config:
    """cfg at the oracle's geometry: depth 1, width next_pow2(n_keys),
    plain sums, no side table, no tenants."""
    return replace(cfg, sketch=replace(
        cfg.sketch, depth=1, width=_next_pow2(n_keys),
        conservative_update=False, hh_slots=0), hierarchy=HierarchySpec())


def oracle_geometry(cfg: Config, n_keys: int) -> dict:
    """Step kwargs for the collision-free oracle twin of ``cfg`` (with its
    d and w, as the JAX package's)."""
    return dict(sketch_kernels._step_kw(_oracle_config(cfg, n_keys)), d=1,
                w=_next_pow2(n_keys))


def init_oracle_state(cfg: Config, n_keys: int, device="cuda") -> dict:
    """The oracle's fresh ring state: (1, w) slabs, S of them."""
    return sketch_kernels.init_state(_oracle_config(cfg, n_keys), device)


def build_eval_chunk(cfg: Config, B: int, n_keys: int, alpha: float,
                     device="cuda") -> Callable:
    """``chunk(states, counter0, now_us, *, period) -> (states, stats)``
    deciding one B-sized Zipf batch with BOTH the sketch and the exact
    oracle. ``states`` is ``{"sk": sketch_state, "or": oracle_state}``,
    updated in place; both share the sub-window ``period`` (the caller
    rolls both over). ``stats`` is an int64 (4,) tensor: (false_deny,
    false_allow, sketch_deny, oracle_deny); false_deny = the sketch denied
    but the oracle allowed (the capped metric), false_allow = the sketch
    allowed but the oracle denied."""
    sk_kw = sketch_kernels._step_kw(cfg)
    or_kw = sketch_kernels._step_kw(_oracle_config(cfg, n_keys))
    seed = cfg.sketch.seed
    n = torch.ones((B,), dtype=torch.int32, device=device)
    zeros = torch.zeros((B,), dtype=torch.int64, device=device)

    def chunk(states, counter0: int, now_us: int, *, period: int):
        ids = _zipf_ids(counter0, B, n_keys, alpha, device)
        h1, h2 = hashed_halves(ids, seed)
        sk_allow = sketch_kernels._sketch_step(
            states["sk"], h1, h2, n, now_us, period=period, **sk_kw)[0]
        # Oracle: identity columns (h1 = id, h2 = 0), collision-free.
        or_allow = sketch_kernels._sketch_step(
            states["or"], ids & 0xFFFFFFFF, zeros, n, now_us, period=period,
            **or_kw)[0]
        stats = torch.stack([(~sk_allow & or_allow).sum(),
                             (sk_allow & ~or_allow).sum(),
                             (~sk_allow).sum(), (~or_allow).sum()])
        return states, stats

    return chunk


def build_oracle_rollover(cfg: Config, n_keys: int) -> Callable:
    """``rollover(state, p)`` for the oracle's ring, in place."""
    return sketch_kernels.build_steps(_oracle_config(cfg, n_keys))[2]
