"""The dense backend's step kernel: CUDA wrapper and plain version.

``dense_step`` is one decision step of the dense backend (slot-addressed
exact state, ops/dense_kernels.py). The JAX package jits the step as
``jnp`` (``ratelimiter_tpu/ops/dense_kernels.py``, no Pallas kernel); its
in-batch sequencing is ``segment.admit``, which the sketch's backs already
run as one block (``csrc/admit.cuh``). Here the whole step is one launch
of a kernel written by hand for Hopper (``csrc/dense_kernels.cu``, built
by ``ops/_build.py`` and called through ctypes): gather, window roll or
refill, policy lookup, available units, admission grouped on the slot id,
one write of each touched slot's row from its segment's tail, and the
four results. One build per algorithm (fixed, sliding, token bucket).

* a CUDA tensor launches the kernel (on the current stream, without
  synchronising) or raises — there is no fallback. It holds at most
  ``ADMIT_CAPACITY`` (8192) requests: a larger batch is refused before
  anything runs;
* a CPU tensor takes the plain version (``dense_kernels.PLAIN_STEPS``,
  the JAX step's expressions in torch). The CPU tests hold it bit-equal
  to the JAX package, and ``chip_smoke.py`` holds the kernel bit-equal to
  it on the card.

``dense_step.launches`` counts kernel launches by build; ``launch_counts``
reads them as ``dense_step`` (all builds) and ``dense_step [<build>]``,
and ``reset_launch_counts`` clears them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ratelimiter_tpu_torch.core.types import Algorithm
from ratelimiter_tpu_torch.ops import _build, dense_kernels
from ratelimiter_tpu_torch.ops.sketch_cuda import (
    ADMIT_CAPACITY,
    _check,
    _raise_on,
    _stream,
)

_SOURCE = "dense_kernels"
_configured = set()

#: The kernel's algorithm flag.
ALGO = {Algorithm.FIXED_WINDOW: 0, Algorithm.SLIDING_WINDOW: 1,
        Algorithm.TPU_SKETCH: 1, Algorithm.TOKEN_BUCKET: 2}

#: Each build's name in the launch counts.
BUILDS = ("fixed_window", "sliding_window", "token_bucket")

#: Scratch rows the kernel keeps per request (kRows in the source).
SCRATCH_ROWS = 7

_POLICY_COLUMNS = ("key", "limit", "window_us", "rate_num", "rate_den")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rl_dense_step.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I,
                                      L, L, L, L, L, P, P, P, P, P, I, I,
                                      I, P]
        lib.rl_dense_step.restype = ctypes.c_int
        _configured.add(id(lib))
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _lib()


def _check_step(state: dict, algorithm: Algorithm, sid, n, policy,
                keyq) -> int:
    """The step's operands; returns B."""
    cols = dense_kernels.COLUMNS[algorithm]
    if set(state) != set(cols):
        raise ValueError(f"{algorithm} state must hold {cols}, got "
                         f"{sorted(state)}")
    rows = state[cols[0]].shape[0] if state[cols[0]].dim() == 1 else 0
    if rows < 1:
        raise ValueError(f"state columns must be (capacity+1,), got "
                         f"{tuple(state[cols[0]].shape)}")
    dev = state[cols[0]].device
    for c in cols:
        _check(c, state[c], torch.int64, (rows,), dev)
    B = sid.shape[0] if sid.dim() == 1 else -1
    _check("sid", sid, torch.int32, (B,), dev)
    _check("n", n, torch.int64, (B,), dev)
    if policy is not None:
        P = policy["key"].shape[0]
        if P < 1 or P & (P - 1):
            raise ValueError(f"table capacity must be a power of two, got "
                             f"{P}")
        for c in _POLICY_COLUMNS:
            _check(f"policy {c}", policy[c], torch.int64, (P,), dev)
        if keyq is None:
            raise ValueError("keyq is required with a policy table")
        _check("keyq", keyq, torch.int64, (B,), dev)
    return B


def dense_step_plain(state: dict, sid, n, now_us: int, policy=None,
                     keyq=None, *, algorithm: Algorithm, limit: int,
                     window_us: int, rate_num: int, rate_den: int,
                     iters: int) -> tuple:
    """The JAX step in torch (``dense_kernels.PLAIN_STEPS``), in place."""
    return dense_kernels.PLAIN_STEPS[algorithm](
        state, sid, n, now_us, policy, keyq, limit=limit,
        window_us=window_us, rate_num=rate_num, rate_den=rate_den,
        iters=iters)


def dense_step(state: dict, sid: torch.Tensor, n: torch.Tensor,
               now_us: int, policy: Optional[dict] = None,
               keyq: Optional[torch.Tensor] = None, *,
               algorithm: Algorithm, limit: int, window_us: int,
               rate_num: int, rate_den: int, iters: int) -> tuple:
    """One dense step over a padded batch, updating ``state`` (the
    algorithm's int64 (C+1,) columns) in place. ``sid`` int32[B] slots in
    [0, C] (C the padding slot), ``n`` int64[B] (0 = padding), ``now_us``
    a host int; ``policy`` the device override table (``key``, ``limit``,
    ``window_us``, ``rate_num``, ``rate_den``, int64, a power-of-two
    capacity) with ``keyq`` int64[B] the batch's search keys (requests of
    one slot carry one key). Returns ``(allowed bool[B], remaining
    int64[B], retry_us int64[B], reset_us int64[B])``.

    On a CUDA device one launch of ``csrc/dense_kernels.cu``'s build for
    ``algorithm``; at most ``ADMIT_CAPACITY`` requests."""
    B = _check_step(state, algorithm, sid, n, policy, keyq)
    dev = sid.device
    if dev.type != "cuda":
        return dense_step_plain(
            state, sid, n, now_us, policy, keyq, algorithm=algorithm,
            limit=limit, window_us=window_us, rate_num=rate_num,
            rate_den=rate_den, iters=iters)
    if B > ADMIT_CAPACITY:
        raise ValueError(f"the dense step takes at most {ADMIT_CAPACITY} "
                         f"requests a launch on the card, got {B}")
    cols = [state[c] for c in dense_kernels.COLUMNS[algorithm]]
    s2 = cols[2] if len(cols) > 2 else None
    scratch = torch.empty((SCRATCH_ROWS, B), dtype=torch.int64, device=dev)
    allowed = torch.empty((B,), dtype=torch.bool, device=dev)
    remaining, retry_us, reset_us = torch.empty(
        (3, B), dtype=torch.int64, device=dev).unbind()
    if policy is None:
        pol = (None,) * 6 + (0,)
    else:
        pol = (keyq.data_ptr(),
               *(policy[c].data_ptr() for c in _POLICY_COLUMNS),
               policy["key"].shape[0])
    err = _lib().rl_dense_step(
        cols[0].data_ptr(), cols[1].data_ptr(),
        None if s2 is None else s2.data_ptr(), sid.data_ptr(), n.data_ptr(),
        *pol, limit, window_us, rate_num, rate_den, now_us,
        scratch.data_ptr(), allowed.data_ptr(), remaining.data_ptr(),
        retry_us.data_ptr(), reset_us.data_ptr(), B, iters,
        ALGO[algorithm], _stream(sid))
    _raise_on(err, "rl_dense_step")
    dense_step.launches[BUILDS[ALGO[algorithm]]] += 1
    return allowed, remaining, retry_us, reset_us


#: Launches of each build since the last reset.
dense_step.launches = dict.fromkeys(BUILDS, 0)


def launch_counts() -> dict:
    """{``dense_step``: its kernel launches since the last reset, and
    ``dense_step [<build>]``: each build's}."""
    counts = {f"dense_step [{b}]": n for b, n in dense_step.launches.items()}
    counts["dense_step"] = sum(dense_step.launches.values())
    return counts


def reset_launch_counts() -> None:
    dense_step.launches = dict.fromkeys(BUILDS, 0)
