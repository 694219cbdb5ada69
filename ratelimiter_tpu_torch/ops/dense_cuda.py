"""The dense backend's step kernels: CUDA wrappers and plain versions.

``dense_step`` is one decision step of the dense backend (slot-addressed
exact state, ops/dense_kernels.py). The JAX package jits the step as
``jnp`` (``ratelimiter_tpu/ops/dense_kernels.py``, no Pallas kernel); its
in-batch sequencing is ``segment.admit``, which the sketch's backs already
run as one block (``csrc/admit.cuh``). Here the step is two launches of
kernels written by hand for Hopper (``csrc/dense_kernels.cu`` over
``csrc/dense.cuh``, built by ``ops/_build.py`` and called through ctypes),
on one stream with no host sync between them:

* ``dense_front`` (phase A) across the card, one request a thread: the
  override-table search (the key column staged in each block's shared
  memory), the slot row's gather, the window roll or the refill, and the
  available units, into a scratch array;
* the admission grouped on the slot id and the epilogue on one block:
  each touched slot's row written once from its segment's tail, and the
  four results. One build per algorithm (fixed, sliding, token bucket).

* a CUDA tensor launches the kernels (on the current stream, without
  synchronising) or raises — there is no fallback. A batch above
  ``ADMIT_CAPACITY`` (8192) requests runs composed on the card: the plain
  step as torch ops on the CUDA tensors, by size alone (the admission is
  one block; ROADMAP B6), counted as ``dense_step [composed]``;
* a CPU tensor takes the plain version (``dense_kernels.plain_step``,
  the JAX step's expressions in torch; ``dense_kernels.
  dense_front_plain`` for phase A alone). The CPU tests hold them
  bit-equal to the JAX package, and ``chip_smoke.py`` holds the kernels
  bit-equal to them on the card.

``dense_front.launches`` and ``dense_step.launches`` count phase A's and
the admission's launches by build, ``dense_step.composed`` the steps run
composed; ``launch_counts`` reads them as ``dense_front`` and
``dense_step`` (all builds), ``dense_front [<build>]``, ``dense_step
[<build>]`` and ``dense_step [composed]``, and ``reset_launch_counts``
clears them.
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


_POLICY_COLUMNS = ("key", "limit", "window_us", "rate_num", "rate_den")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if id(lib) not in _configured:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rl_dense_front.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I,
                                       L, L, L, L, L, P, I, I, P]
        lib.rl_dense_back.argtypes = [P, P, P, P, L, P, P, P, P, P, I, I,
                                      I, P]
        lib.rl_dense_step.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I,
                                      L, L, L, L, L, P, P, P, P, P, I, I, I,
                                      P]
        for fn in (lib.rl_dense_front, lib.rl_dense_back, lib.rl_dense_step):
            fn.restype = ctypes.c_int
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
            # The key column is staged by a bulk copy: 16-byte aligned.
            _check(f"policy {c}", policy[c], torch.int64, (P,), dev,
                   align16=c == "key")
        if keyq is None:
            raise ValueError("keyq is required with a policy table")
        _check("keyq", keyq, torch.int64, (B,), dev)
    return B


def dense_step_plain(state: dict, sid, n, now_us: int, policy=None,
                     keyq=None, *, algorithm: Algorithm, limit: int,
                     window_us: int, rate_num: int, rate_den: int,
                     iters: int) -> tuple:
    """The JAX step in torch (``dense_kernels.plain_step``), in place."""
    return dense_kernels.plain_step(
        state, sid, n, now_us, policy, keyq, algorithm=algorithm,
        limit=limit, window_us=window_us, rate_num=rate_num,
        rate_den=rate_den, iters=iters)


def _policy_args(policy, keyq) -> tuple:
    """The C interface's table operands: keyq, the five columns, P."""
    if policy is None:
        return (None,) * 6 + (0,)
    return (keyq.data_ptr(), *(policy[c].data_ptr() for c in _POLICY_COLUMNS),
            policy["key"].shape[0])


def _state_ptrs(state: dict, algorithm: Algorithm) -> tuple:
    cols = [state[c] for c in dense_kernels.COLUMNS[algorithm]]
    return (cols[0].data_ptr(), cols[1].data_ptr(),
            cols[2].data_ptr() if len(cols) > 2 else None)


def dense_front(state: dict, sid: torch.Tensor, n: torch.Tensor,
                now_us: int, policy: Optional[dict] = None,
                keyq: Optional[torch.Tensor] = None, *,
                algorithm: Algorithm, limit: int, window_us: int,
                rate_num: int, rate_den: int, **_) -> torch.Tensor:
    """The step's phase A (``dense_kernels.dense_front_plain``'s
    function): returns the int64 (len(SCRATCH_ROWS), B) scratch, of which
    the rows ``dense_kernels.USED_ROWS[algorithm]`` are written. The state
    is only read.

    Bound on an H100: each request's sid, n and search key and its slot's
    row read, the table's columns read once, the scratch rows written:
    ~0.3 MB at B = 4096, ~0.1 us at 3.35 TB/s. Design: ceil(B / 256)
    blocks of one request a thread across the card; each block stages the
    table's key column in its shared memory by one bulk copy (tables of at
    most 4096 rows; larger ones are searched in global memory), each
    thread issues its row's loads while the copy lands. On a CUDA device
    one launch of ``rl_dense_front``, at most ``ADMIT_CAPACITY`` requests
    (the step's admission takes no more)."""
    B = _check_step(state, algorithm, sid, n, policy, keyq)
    dev = sid.device
    if dev.type != "cuda":
        return dense_kernels.dense_front_plain(
            state, sid, n, now_us, policy, keyq, algorithm=algorithm,
            limit=limit, window_us=window_us, rate_num=rate_num,
            rate_den=rate_den)
    if B > ADMIT_CAPACITY:
        raise ValueError(f"the dense front takes at most {ADMIT_CAPACITY} "
                         f"requests a launch, got {B}")
    scratch = torch.empty((len(dense_kernels.SCRATCH_ROWS), B),
                          dtype=torch.int64, device=dev)
    s0, s1, s2 = _state_ptrs(state, algorithm)
    err = _lib().rl_dense_front(
        s0, s1, s2, sid.data_ptr(), n.data_ptr(), *_policy_args(policy, keyq),
        limit, window_us, rate_num, rate_den, now_us, scratch.data_ptr(), B,
        ALGO[algorithm], _stream(sid))
    _raise_on(err, "rl_dense_front")
    dense_front.launches[BUILDS[ALGO[algorithm]]] += 1
    return scratch


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

    On a CUDA device one host call, ``csrc/dense_kernels.cu``'s
    ``rl_dense_step`` for ``algorithm``: phase A across the card (as
    ``dense_front``), then one block of admission and epilogue, two
    launches counted as ``dense_front`` and ``dense_step``; above
    ``ADMIT_CAPACITY`` requests the plain step on the card (composed)."""
    B = _check_step(state, algorithm, sid, n, policy, keyq)
    dev = sid.device
    if dev.type != "cuda" or B > ADMIT_CAPACITY:
        if dev.type == "cuda":
            dense_step.composed += 1
        return dense_step_plain(
            state, sid, n, now_us, policy, keyq, algorithm=algorithm,
            limit=limit, window_us=window_us, rate_num=rate_num,
            rate_den=rate_den, iters=iters)
    scratch = torch.empty((len(dense_kernels.SCRATCH_ROWS), B),
                          dtype=torch.int64, device=dev)
    allowed = torch.empty((B,), dtype=torch.bool, device=dev)
    remaining, retry_us, reset_us = torch.empty(
        (3, B), dtype=torch.int64, device=dev).unbind()
    s0, s1, s2 = _state_ptrs(state, algorithm)
    err = _lib().rl_dense_step(
        s0, s1, s2, sid.data_ptr(), n.data_ptr(), *_policy_args(policy, keyq),
        limit, window_us, rate_num, rate_den, now_us, scratch.data_ptr(),
        allowed.data_ptr(), remaining.data_ptr(), retry_us.data_ptr(),
        reset_us.data_ptr(), B, iters, ALGO[algorithm], _stream(sid))
    _raise_on(err, "rl_dense_step")
    dense_front.launches[BUILDS[ALGO[algorithm]]] += 1
    dense_step.launches[BUILDS[ALGO[algorithm]]] += 1
    return allowed, remaining, retry_us, reset_us


#: Launches of each build's phase A and admission since the last reset,
#: and the steps run composed above ADMIT_CAPACITY on the card.
dense_front.launches = dict.fromkeys(BUILDS, 0)
dense_step.launches = dict.fromkeys(BUILDS, 0)
dense_step.composed = 0


def launch_counts() -> dict:
    """{``dense_front`` and ``dense_step``: phase A's and the admission's
    launches since the last reset (all builds), ``dense_front [<build>]``
    and ``dense_step [<build>]``: each build's, and ``dense_step
    [composed]``: the steps run composed on the card (no launch of
    either)}."""
    counts = {}
    for fn in (dense_front, dense_step):
        name = fn.__name__
        counts.update({f"{name} [{b}]": n for b, n in fn.launches.items()})
        counts[name] = sum(fn.launches.values())
    counts["dense_step [composed]"] = dense_step.composed
    return counts


def reset_launch_counts() -> None:
    dense_front.launches = dict.fromkeys(BUILDS, 0)
    dense_step.launches = dict.fromkeys(BUILDS, 0)
    dense_step.composed = 0
