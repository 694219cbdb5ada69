"""The count-min-sketch backends on PyTorch.

Ports of ``ratelimiter_tpu/algorithms/sketch.py``:

* ``SketchLimiter``: approximate sliding- (or fixed-) window rate limiting
  over a count-min sketch with sub-window decay (ops/sketch_kernels.py).
  Memory is depth x width x ring counters, independent of key cardinality;
* ``SketchTokenBucketLimiter``: TOKEN_BUCKET over a count-min sketch of
  per-key debt (ops/bucket_kernels.py), sharing the windowed limiter's
  shell and swapping its step, reset and result assembly.

Collisions can only cause false denies in either.

The hot path is split as in the JAX package:

* **launch** stages the batch (pinned host buffer, asynchronous copy to
  the card), runs the decision step on the current CUDA stream, queues
  the result assembly behind it, starts the copies of the results into
  pinned host buffers, records a CUDA event behind them, and returns a
  ``DispatchTicket`` without blocking;
* **resolve** waits on that event and assembles the ``BatchResult``.

Sequential semantics across in-flight tickets come from stream order:
each step updates the state tensors in place, and the stream runs the
steps in launch order, where the JAX package threads donated buffers.
On ``device="cpu"`` (the tests) the same code runs eagerly on the CPU
with the kernels' plain versions.

Not ported yet (constructing such a config raises InvalidConfigError
naming the ROADMAP item): the heavy-hitter side table and the hierarchy
(A6). The windowed accuracy-envelope watchdog (mass budget,
``overload_policy``) is not ported either, so the windowed limiter refuses
the "strict" policy rather than silently ignoring it (the bucket has no
watchdog in either package and ignores it). Neither limiter ports
``update_limit``/``update_window``. Both port the failure injection
(``inject_failure``/``heal``) the serving tier's failure paths need.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ratelimiter_tpu_torch.algorithms.base import RateLimiter, check_key, check_n
from ratelimiter_tpu_torch.core.clock import MICROS, Clock, to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import (
    InvalidConfigError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    BatchResult,
    DispatchTicket,
    Result,
    batch_fail_open,
)
from ratelimiter_tpu_torch.ops import bucket_kernels, sketch_kernels
from ratelimiter_tpu_torch.ops.bucket_cuda import DEBT_CAP
from ratelimiter_tpu_torch.ops.hashing import (
    hash_prefixed_u64,
    split_hash,
    splitmix64,
)
from ratelimiter_tpu_torch.ops.policy_kernels import pack_halves_host

_MIN_PAD = 8


def _pad_size(n: int) -> int:
    size = _MIN_PAD
    while size < n:
        size *= 2
    return size


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port's
    entry points never carry on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU with the kernels' plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise InvalidConfigError(f"unsupported device {device!r}")
    return dev


class SketchLimiter(RateLimiter):
    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 device="cuda"):
        super().__init__(config, clock)
        if self.config.sketch.overload_policy == "strict":
            raise InvalidConfigError(
                "overload_policy='strict' needs the mass-budget watchdog, "
                "which is not ported yet")
        self._init_device(device)
        self._step = sketch_kernels.build_hashed_step(self.config)
        self._ids_step = sketch_kernels.build_hashed_step(self.config,
                                                          premix=True)
        _, self._reset_step, self._rollover = sketch_kernels.build_steps(
            self.config)
        self._state = sketch_kernels.init_state(self.config, self._device)
        self._sub_us = sketch_kernels.sketch_geometry(self.config)[1]
        # Host mirror of state["last_period"]: drives rollover dispatches
        # and names the boundary slab (sketch_kernels module docstring).
        self._host_period = sketch_kernels._NEVER
        self._init_policy()

    def _init_device(self, device) -> None:
        """The shell both sketch limiters share: device, hashing seed,
        window and the dispatch lock."""
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._window_us = to_micros(self.config.window)
        self._seed = self.config.sketch.seed
        self._lock = threading.Lock()
        #: Set by inject_failure: every launch raises it (under the lock)
        #: until heal().
        self._injected_failure: Optional[Exception] = None

    def _init_policy(self) -> None:
        """Per-key limit overrides, resolved in the step; window scaling
        is impossible on a shared sketch geometry, so only limits
        override."""
        from ratelimiter_tpu_torch.policy import PolicyTable

        self._policy_table = PolicyTable(
            self.config, key_fn=self._policy_key,
            validator=self._policy_validate, window_scaling=False)
        self._policy_dev = None
        self._policy_dev_version = -1

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------- policy

    def _policy_validate(self, limit: int, _window_us: int) -> None:
        if limit >= (1 << 24):
            raise InvalidConfigError(
                f"sketch backends require override limits < 2**24 "
                f"(f32-exact admission), got {limit}")

    def _policy_key(self, key: str) -> int:
        h1, h2 = split_hash(self._hash([key]), self._seed)
        return int(pack_halves_host(h1, h2)[0])

    def _policy_device(self):
        """Device copy of the override table, or None while it is empty (a
        lookup in an all-padding table only ever finds the default limit).
        Lock must be held; rebuilt when the table version moved."""
        t = self._policy_table
        if not len(t):
            return None
        if self._policy_dev is None or self._policy_dev_version != t.version:
            self._policy_dev = sketch_kernels.policy_tensors(
                t.host_arrays(), self._device)
            self._policy_dev_version = t.version
        return self._policy_dev

    def _policy_limits(self, h64: np.ndarray):
        """Host-side per-request effective limits for result assembly
        (None when no override matches)."""
        if not len(self._policy_table):
            return None
        h1, h2 = split_hash(np.asarray(h64, np.uint64), self._seed)
        return self._policy_table.limits_for(pack_halves_host(h1, h2))

    # ------------------------------------------------------------ hashing

    def _hash(self, keys: List[str]) -> np.ndarray:
        return hash_prefixed_u64(keys, self.config.prefix)

    def _sync_period(self, now_us: int) -> None:
        """Dispatch the rollover if now_us entered a new sub-window. Must be
        called with self._lock held."""
        p = now_us // self._sub_us
        if p > self._host_period:
            self._rollover(self._state, p)
            self._host_period = p

    def _step_kw(self) -> dict:
        """Keyword operands of the step and reset callables: the windowed
        ones read their period from the host mirror. Lock must be held."""
        return {"period": self._host_period}

    def _launch_kw(self) -> dict:
        """Keyword operands of the step callables alone. Lock must be
        held."""
        return {}

    def _launch_finish(self, outs, now_us: int):
        """Queue the result assembly behind the step (windowed form:
        retry-after is the time to the window reset)."""
        allowed, remaining, _est = outs
        return sketch_kernels.finish_window(allowed, remaining, now_us,
                                            self._window_us)

    # ------------------------------------------------------------ dispatch

    def _stage(self, arr: np.ndarray, dtype: np.dtype) -> torch.Tensor:
        """Host array -> device tensor. On CUDA the host side is a pinned
        buffer and the copy is asynchronous; the caching host allocator
        keeps the buffer until the copy has run."""
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
        if not self._cuda:
            return host
        return host.pin_memory().to(self._device, non_blocking=True)

    def _launch_hashed(self, h64: np.ndarray, ns: np.ndarray, now_us: int,
                       t_sec: float, *, premix: bool = False,
                       wire: bool = False) -> DispatchTicket:
        b = h64.shape[0]
        padded = _pad_size(b)
        h64p = np.zeros(padded, dtype=np.uint64)
        h64p[:b] = h64
        nsp = np.zeros(padded, dtype=np.int32)
        nsp[:b] = ns
        with self._lock:
            if self._injected_failure is not None:
                raise self._injected_failure
            self._sync_period(now_us)
            step = self._ids_step if premix else self._step
            h_dev = self._stage(h64p.view(np.int64), np.int64)
            n_dev = self._stage(nsp, np.int32)
            outs = step(self._state, h_dev, n_dev, now_us,
                        self._policy_device(), **self._step_kw(),
                        **self._launch_kw())
            # Inside the lock: a concurrent set/delete_override rebuilds
            # the table's sorted views.
            if premix:
                limits = (self._policy_limits(splitmix64(h64))
                          if len(self._policy_table) else None)
            else:
                limits = self._policy_limits(h64)
        outs = self._launch_finish(outs, now_us)
        if wire:
            outs = sketch_kernels.pack_wire(*outs)
        t = DispatchTicket()
        if self._cuda:
            host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                         for o in outs)
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            t.event = torch.cuda.Event()
            t.event.record()
            t.staged = (h_dev, n_dev, outs)
            outs = host
        t.outs = outs
        t.wire = wire
        t.b = b
        t.limit = self.config.limit
        t.limits = limits
        t.ns = np.asarray(ns)
        t.now_us = now_us
        t.t_sec = t_sec
        t.padded = padded
        return t

    def _resolve_ticket(self, t: DispatchTicket) -> BatchResult:
        if t.result is not None:
            return t.result
        if t.event is not None:
            t.event.synchronize()
        b = t.b
        if t.wire:
            bits, words = (o.numpy() for o in t.outs)
            padded = t.padded
            res = BatchResult(
                allowed=np.unpackbits(bits, bitorder="little")[:b].astype(bool),
                limit=t.limit,
                remaining=words[:b],
                retry_after=words[padded:padded + b].view(np.float64),
                reset_at=words[2 * padded:2 * padded + b].view(np.float64),
                limits=t.limits,
                wire_packed=(bits, words, padded),
            )
        else:
            allowed, remaining, retry, reset_at = (o.numpy() for o in t.outs)
            res = BatchResult(
                allowed=allowed[:b],
                limit=t.limit,
                remaining=remaining[:b],
                retry_after=retry[:b],
                reset_at=reset_at[:b],
                limits=t.limits,
            )
        t.result = res
        t.outs = t.staged = t.event = None
        return res

    # ------------------------------------------------ pipelined public API

    pipelined = True

    def _launch_guarded(self, h64: np.ndarray, ns_arr: np.ndarray, t: float,
                        *, premix: bool = False,
                        wire: bool = False) -> DispatchTicket:
        """Fail-open configs get a pre-resolved fail-open ticket when a
        launch fails; fail-closed configs raise StorageUnavailableError."""
        try:
            return self._launch_hashed(h64, ns_arr, to_micros(t), t,
                                       premix=premix, wire=wire)
        except Exception as exc:
            if self.config.fail_open:
                return DispatchTicket(result=batch_fail_open(
                    h64.shape[0], self.config.limit,
                    t + float(self.config.window)))
            raise StorageUnavailableError(
                f"sketch launch failed: {exc}") from exc

    @staticmethod
    def _ns(count: int, ns) -> np.ndarray:
        if ns is None:
            return np.ones(count, dtype=np.int64)
        return np.asarray(ns, dtype=np.int64)

    def launch_hashed(self, h64: np.ndarray, ns: Optional[np.ndarray] = None,
                      *, now: Optional[float] = None) -> DispatchTicket:
        """Launch pre-hashed uint64 keys (finalized hashes); ns is trusted
        (the serving tier validated it at the wire)."""
        self._check_open()
        h64 = np.asarray(h64, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self._launch_guarded(h64, self._ns(h64.shape[0], ns), t)

    def launch_ids(self, ids: np.ndarray, ns: Optional[np.ndarray] = None, *,
                   now: Optional[float] = None,
                   wire: bool = False) -> DispatchTicket:
        """Raw-u64-id launch (the T_ALLOW_HASHED wire lane): splitmix64 and
        the (h1, h2) split both run in the step on the device. ``wire=True``
        also packs the response on the device (pack_wire)."""
        self._check_open()
        ids = np.asarray(ids, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self._launch_guarded(ids, self._ns(ids.shape[0], ns), t,
                                    premix=True, wire=wire)

    def allow_ids(self, ids: np.ndarray, ns: Optional[np.ndarray] = None, *,
                  now: Optional[float] = None) -> BatchResult:
        """Synchronous raw-u64-id decide: launch_ids + resolve."""
        return self.resolve(self.launch_ids(ids, ns, now=now))

    def launch_batch(self, keys: List[str], ns: Optional[np.ndarray] = None,
                     *, now: Optional[float] = None) -> DispatchTicket:
        """String-key launch: validate and hash on the host, then the
        hashed launch path."""
        self._check_open()
        keys = list(keys)
        for k in keys:
            check_key(k)
        if ns is not None:
            for n in ns:
                check_n(int(n))
        t = self.clock.now() if now is None else float(now)
        return self._launch_guarded(self._hash(keys), self._ns(len(keys), ns),
                                    t)

    def resolve(self, ticket: DispatchTicket) -> BatchResult:
        """Wait for a launched dispatch and assemble its BatchResult
        (idempotent). Device errors honour fail-open/fail-closed."""
        try:
            return self._resolve_ticket(ticket)
        except Exception as exc:
            if self.config.fail_open:
                res = batch_fail_open(ticket.b, self.config.limit,
                                      ticket.t_sec + float(self.config.window))
                ticket.result = res
                ticket.outs = ticket.staged = ticket.event = None
                return res
            raise StorageUnavailableError(
                f"sketch dispatch failed: {exc}") from exc

    def allow_hashed(self, h64: np.ndarray, ns: Optional[np.ndarray] = None,
                     *, now: Optional[float] = None) -> BatchResult:
        """Decide a batch of pre-hashed uint64 keys: launch + resolve."""
        return self.resolve(self.launch_hashed(h64, ns, now=now))

    def _allow_batch(self, keys: list, ns: np.ndarray, now: float) -> BatchResult:
        return self.resolve(self._launch_guarded(self._hash(keys), ns, now))

    def _allow_n(self, key: str, n: int, now: float) -> Result:
        return self._allow_batch([key], np.array([n], dtype=np.int64),
                                 now).result(0)

    # --------------------------------------------------------------- reset

    def _reset(self, key: str) -> None:
        h1, h2 = split_hash(self._hash([key]), self._seed)
        now_us = to_micros(self.clock.now())
        with self._lock:
            self._sync_period(now_us)
            self._reset_step(
                self._state,
                self._stage(h1.astype(np.int64), np.int64),
                self._stage(h2.astype(np.int64), np.int64),
                now_us, **self._step_kw())

    def _close(self) -> None:
        self._state = {}

    # ---------------------------------------------------- fault injection

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        """Make every launch fail with ``exc`` until ``heal``: fail-open
        configs answer with fail-open results, fail-closed ones raise
        StorageUnavailableError (``_launch_guarded``)."""
        self._injected_failure = exc if exc is not None else RuntimeError(
            "injected backend failure")

    def heal(self) -> None:
        self._injected_failure = None

    # ------------------------------------------------- state carried across

    _CKPT_KIND = "sketch"
    #: Host mirrors that ride ``extra`` (each ``key`` mirrors ``self._key``):
    #: the windowed step reads its period from the host.
    _EXTRA_KEYS: tuple = ("host_period",)

    def capture_state(self):
        """``(kind, arrays, extra)`` in the JAX package's capture format:
        the state slabs as NumPy arrays plus the ``policy_*`` columns, and
        (windowed) ``host_period`` in extra. convert.py carries it across
        packages."""
        from ratelimiter_tpu_torch.convert import state_to_numpy

        self._check_open()
        with self._lock:
            arrays = state_to_numpy(self._state)
            arrays.update(self._policy_table.snapshot_arrays())
            extra = {"saved_at": self.clock.now()}
            extra.update((k, int(getattr(self, "_" + k)))
                         for k in self._EXTRA_KEYS)
        return self._CKPT_KIND, arrays, extra

    def restore_state(self, arrays: dict, extra: dict) -> None:
        """Replace state and overrides with captured ``arrays`` (from
        either package's ``capture_state``) of this limiter's kind; the
        host mirrors named in ``_EXTRA_KEYS`` are required in ``extra``."""
        from ratelimiter_tpu_torch.convert import state_from_numpy

        self._check_open()
        for k in self._EXTRA_KEYS:
            if k not in extra:
                raise InvalidConfigError(f"restore needs extra[{k!r}]")
        arrays = dict(arrays)
        with self._lock:
            state = state_from_numpy(arrays, self._device)
            if set(state) != set(self._state):
                raise InvalidConfigError(
                    f"state arrays {sorted(state)} do not fit this "
                    f"limiter's {sorted(self._state)}")
            for k, v in state.items():
                if tuple(v.shape) != tuple(self._state[k].shape):
                    raise InvalidConfigError(
                        f"state array {k} has shape {tuple(v.shape)}, this "
                        f"limiter's geometry needs "
                        f"{tuple(self._state[k].shape)}")
            self._policy_table.restore_arrays(arrays)
            self._policy_dev = None
            self._state = state
            for k in self._EXTRA_KEYS:
                setattr(self, "_" + k, int(extra[k]))
            self._restored(arrays)

    def _restored(self, arrays: dict) -> None:
        """Note what the next step must know of restored ``arrays``. Lock
        must be held."""


class SketchTokenBucketLimiter(SketchLimiter):
    """TOKEN_BUCKET at unbounded key cardinality: a count-min sketch over
    per-key *debt* (ops/bucket_kernels.py — the GCRA meter form of the
    reference's ``tokenbucket.go:23-52``). Continuous fractional refill,
    burst up to ``limit``, denial consumes nothing; overestimated debt can
    only cause false denies, never over-admission.

    Shares the SketchLimiter shell (hashing, padding, staging, locking,
    launch/resolve, fail-open) and swaps the step, the reset and the result
    assembly: no sub-window ring, no rollover — the decay is inside the
    step, computed on the host from the state's host scalars."""

    #: No ring, so no period (the JAX package records none either); the
    #: decay's scalars ``rem`` and ``last`` are state arrays.
    _EXTRA_KEYS = ()

    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 device="cuda"):
        RateLimiter.__init__(self, config, clock)
        self._init_device(device)
        self._step = bucket_kernels.build_hashed_step(self.config)
        self._ids_step = bucket_kernels.build_hashed_step(self.config,
                                                          premix=True)
        _, self._reset_step = bucket_kernels.build_steps(self.config)
        self._state = bucket_kernels.init_state(self.config, self._device)
        # Set by a restore that brought acc cells above 2^61, which no step
        # writes: the next step clamps every acc cell once (_launch_kw).
        self._acc_over_cap = False
        self._init_policy()

    def _policy_validate(self, limit: int, _window_us: int) -> None:
        # Admission runs exact int64 micro-token cumsums: the same gate as
        # the config's micro-unit accounting.
        if limit * MICROS >= 2**42:
            raise InvalidConfigError(
                f"override limit {limit} too large for micro-unit batch "
                "accounting (>= 2^42/1e6)")

    def _sync_period(self, now_us: int) -> None:
        """No ring, no rollover: the decay happens inside every step."""

    def _step_kw(self) -> dict:
        return {}

    def _launch_kw(self) -> dict:
        clamp, self._acc_over_cap = self._acc_over_cap, False
        return {"clamp_acc": clamp}

    def _restored(self, arrays: dict) -> None:
        """Mark a restored ``acc`` holding cells above 2^61 (one NumPy max
        on the host): the update reads ``acc`` only at touched cells, so
        the next step clamps it densely, as the JAX kernel does every
        step."""
        acc = np.asarray(arrays.get("acc", ()), dtype=np.int64)
        self._acc_over_cap = bool(
            acc.size and int(acc.max()) > DEBT_CAP)

    def _launch_finish(self, outs, now_us: int):
        """Token-bucket result assembly: retry-after = deficit / refill
        rate, computed exactly by the step; reset_at = now + window."""
        allowed, remaining, retry_us = outs
        return bucket_kernels.finish_bucket(allowed, remaining, retry_us,
                                            now_us, self._window_us)

    def debt_slab_stats(self) -> dict:
        """Occupancy/collision visibility for the debt slab, as the JAX
        package's: per row, the cells whose EFFECTIVE debt is positive
        (stored debt above the decay the next step would apply), reduced
        on the device so only ``d`` scalars come back. ``occupancy`` is
        the max over rows; ``collision_p`` the product over rows — the
        chance a fresh key lands on an occupied cell in every row, which
        it takes for the min-over-rows read to overestimate its debt."""
        d, w = self.config.sketch.depth, self.config.sketch.width
        _, num, den = bucket_kernels._check_gates(self.config)
        now_us = to_micros(self.clock.now())
        with self._lock:
            # Enqueued under the lock, so the reduction sees the state as
            # of every launch before it (stream order), and no later one.
            decay, _ = bucket_kernels._decay(self._state, now_us,
                                             rate_num=num, rate_den=den)
            live = (self._state["debt"] > decay).sum(1)
        live_rows = live.cpu().numpy()
        occ_rows = live_rows / float(w)
        return {
            "depth": int(d),
            "width": int(w),
            "cells": int(d * w),
            "nonzero_cells": int(live_rows.sum()),
            "occupancy_rows": [round(float(o), 6) for o in occ_rows],
            "occupancy": round(float(occ_rows.max(initial=0.0)), 6),
            "collision_p": round(float(np.prod(occ_rows)), 9),
        }
