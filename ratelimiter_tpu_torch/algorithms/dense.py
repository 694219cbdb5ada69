"""Dense device backend: exact semantics, slot-addressed state on the card
— a port of ``ratelimiter_tpu/algorithms/dense.py``.

Keys are assigned integer slots on the host at ingest (the analog of
Redis's keyspace hash), state lives in dense int64 arrays on the device,
and every decision batch is one step (ops/dense_kernels.py; on the card
two launches of ``csrc/dense_kernels.cu``). Exactness matches the exact
backend bit for bit; capacity is bounded by the configured slot count
(the sketch backend lifts that bound at the price of approximation).

Failure semantics (reference ADR-002, ``interface.go:65-69``): any dispatch
failure — including slot exhaustion, the analog of Redis OOM — resolves per
Config.fail_open: allow with the fail_open flag set (the reference swallows
the error the same way, ``tokenbucket.go:100-112``) or raise
StorageUnavailableError. On the card a batch of up to ``ADMIT_CAPACITY``
(8192) requests is the step's two launches; a larger one runs the plain
step on the card (``ops/dense_cuda.py``, by size alone), so any batch the
JAX package decides is decided here too.

The live window migration (``_apply_window``), the limit update's level
shift and slot recycling are plain torch on the state's device, as the
JAX package's are ``jnp``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.algorithms.sketch import resolve_device
from ratelimiter_tpu_torch.core.clock import Clock, MICROS, to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import StorageUnavailableError
from ratelimiter_tpu_torch.core.types import (
    Algorithm,
    BatchResult,
    Result,
    batch_fail_open,
)
from ratelimiter_tpu_torch.ops import dense_kernels

_MIN_PAD = 8


def _pad_size(n: int) -> int:
    """Next power of two >= n (>= _MIN_PAD): bounds the number of distinct
    batch shapes (the JAX package's compile cache; here the scratch sizes)."""
    size = _MIN_PAD
    while size < n:
        size *= 2
    return size


class DenseLimiter(RateLimiter):
    def __init__(self, config: Config, clock: Optional[Clock] = None,
                 capacity: Optional[int] = None, *, device="cuda"):
        super().__init__(config, clock)
        self._device = resolve_device(device)
        self._capacity = int(capacity if capacity is not None
                             else self.config.dense.capacity)
        self._window_us = to_micros(self.config.window)
        self._step = dense_kernels.build_step(self.config)
        self._state = dense_kernels.init_state(
            self.config.algorithm, self._capacity, self.config.limit,
            self._device)
        # The padding row == pristine per-slot state, used to reset slots.
        self._fresh_row = {k: int(v[-1]) for k, v in self._state.items()}
        self._slots: Dict[str, int] = {}
        self._free: List[int] = list(range(self._capacity - 1, -1, -1))
        self._last_used = np.zeros(self._capacity, dtype=np.int64)  # us
        self._lock = threading.Lock()
        self._injected_failure: Optional[Exception] = None
        # Policy engine: overrides resolved in the step (binary search over
        # the device table). Entries are re-gated through the same
        # overflow checks as the base config.
        from ratelimiter_tpu_torch.policy import PolicyTable

        self._policy_table = PolicyTable(
            self.config, key_fn=self._policy_key,
            validator=dense_kernels.check_gate_values, window_scaling=True)
        self._policy_dev = None
        self._policy_dev_version = -1

    @property
    def device(self) -> torch.device:
        return self._device

    def _policy_key(self, key: str) -> int:
        from ratelimiter_tpu_torch.ops.hashing import hash_strings_u64

        h = hash_strings_u64([self.config.format_key(key)])
        return int(h.view(np.int64)[0])

    def _policy_device(self) -> dict:
        """Device copy of the override table, rebuilt when the host table's
        version moved. Lock must be held."""
        t = self._policy_table
        if self._policy_dev is None or self._policy_dev_version != t.version:
            self._policy_dev = {k: torch.from_numpy(v).to(self._device)
                                for k, v in t.host_arrays().items()}
            self._policy_dev_version = t.version
        return self._policy_dev

    def _policy_changed(self, key: str) -> None:
        """Reset the key's refill remainder: it is denominated in the key's
        (old) rate fraction. Forfeits < 1 micro-token, toward denying.
        Lock held by the caller."""
        if self.config.algorithm is not Algorithm.TOKEN_BUCKET:
            return
        slot = self._slots.get(self.config.format_key(key))
        if slot is not None:
            self._state["rem"][slot] = 0

    def _apply_config(self, new_cfg: Config) -> None:
        """Dynamic limit: the step for the new limit. Window state carries
        over untouched; token-bucket levels shift by the limit delta
        clamped to [0, new_cap] (the consumption-stands contract, see
        exact.ExactLimiter._apply_config) and the pristine row used for
        fresh slots moves to the new full level."""
        new_step = dense_kernels.build_step(new_cfg)
        with self._lock:
            self._step = new_step
            if self.config.algorithm is Algorithm.TOKEN_BUCKET:
                delta = (new_cfg.limit - self.config.limit) * MICROS
                cap = new_cfg.limit * MICROS
                tokens = self._state["tokens"]
                tokens.copy_(torch.clamp(tokens + delta, 0, cap))
                self._state["rem"].zero_()
                self._fresh_row.update(tokens=cap, rem=0)

    def _apply_window(self, new_cfg: Config) -> None:
        """Dynamic window: slot-state re-bucketing, same contract as the
        exact backend's host migration (exact.ExactLimiter._apply_window
        — consumption stands, re-expiry on the NEW schedule, errs toward
        denying), elementwise selects over the slot arrays
        (``dense_kernels.apply_window``)."""
        W_new = to_micros(new_cfg.window)
        new_step = dense_kernels.build_step(new_cfg)
        with self._lock:
            # Grid anchors INSIDE the lock: sampling the clock before
            # acquiring it races a concurrent dispatch's window roll.
            now_us = to_micros(self.clock.now())
            self._step = new_step
            dense_kernels.apply_window(self._state, self.config.algorithm,
                                       now_us, self._window_us, W_new)
            self._window_us = W_new

    # ------------------------------------------------------------ slot admin

    def _assign_slots(self, keys: List[str], now_us: int) -> np.ndarray:
        """Key -> slot for a whole batch. The mapping itself is a host dict
        (O(1) amortized per key); all slots newly claimed by this batch
        are zeroed in one scatter per column."""
        sids = np.empty(len(keys), dtype=np.int32)
        fresh: List[int] = []
        for i, key in enumerate(keys):
            fkey = self.config.format_key(key)
            slot = self._slots.get(fkey)
            if slot is None:
                if not self._free:
                    self._prune_locked(now_us)
                if not self._free:
                    raise StorageUnavailableError(
                        f"dense store full ({self._capacity} slots); "
                        "prune idle keys or use the sketch backend")
                slot = self._free.pop()
                self._slots[fkey] = slot
                fresh.append(slot)
            sids[i] = slot
            self._last_used[slot] = now_us
        if fresh:
            self._zero_slots(fresh)
        return sids

    def _zero_slots(self, slots: List[int]) -> None:
        """Restore slots to pristine state (count 0 / full bucket) before
        reuse — one scatter per column, however many slots."""
        idx = torch.as_tensor(slots, dtype=torch.int64).to(self._device)
        for k, v in self._state.items():
            v[idx] = self._fresh_row[k]

    def _prune_locked(self, now_us: int) -> int:
        """Free slots idle for >= 2 windows — the TTL analog. Lock must be
        held."""
        horizon = now_us - 2 * self._window_us
        dropped = 0
        for fkey, slot in list(self._slots.items()):
            if self._last_used[slot] <= horizon:
                del self._slots[fkey]
                self._free.append(slot)
                self._zero_slots([slot])
                dropped += 1
        return dropped

    def prune(self, now: Optional[float] = None) -> int:
        t_us = to_micros(self.clock.now() if now is None else float(now))
        with self._lock:
            return self._prune_locked(t_us)

    def key_count(self) -> int:
        with self._lock:
            return len(self._slots)

    # -------------------------------------------------------------- dispatch

    def _dispatch(self, keys: List[str], ns: np.ndarray, now: float) -> BatchResult:
        from ratelimiter_tpu_torch.ops.hashing import hash_strings_u64

        now_us = to_micros(now)
        dev = self._device
        with self._lock:
            if self._injected_failure is not None:
                raise self._injected_failure
            sids = self._assign_slots(keys, now_us)
            b = len(keys)
            padded = _pad_size(b)
            sid_arr = np.full(padded, self._capacity, dtype=np.int32)  # padding slot
            n_arr = np.zeros(padded, dtype=np.int64)
            sid_arr[:b] = sids
            n_arr[:b] = ns
            # Policy search keys: only worth hashing when overrides exist;
            # an empty table resolves every key to the defaults, so the
            # step then runs without one.
            policy = keyq = limits_arr = None
            if len(self._policy_table):
                keyq_arr = np.zeros(padded, dtype=np.int64)
                h64 = hash_strings_u64(
                    [self.config.format_key(k) for k in keys])
                keyq_arr[:b] = h64.view(np.int64)
                limits_arr = self._policy_table.limits_for(keyq_arr[:b])
                policy = self._policy_device()
                keyq = torch.from_numpy(keyq_arr).to(dev)
            allowed, remaining, retry_us, reset_us = self._step(
                self._state, torch.from_numpy(sid_arr).to(dev),
                torch.from_numpy(n_arr).to(dev), now_us, policy, keyq)
        allowed = allowed[:b].cpu().numpy()
        remaining = remaining[:b].cpu().numpy()
        retry_us = retry_us[:b].cpu().numpy()
        reset_us = reset_us[:b].cpu().numpy()
        return BatchResult(
            allowed=allowed,
            limit=self.config.limit,
            remaining=np.maximum(remaining, 0),
            retry_after=(retry_us / MICROS).astype(np.float64),
            reset_at=(reset_us / MICROS).astype(np.float64),
            limits=limits_arr,
        )

    def _allow_batch(self, keys: list, ns: np.ndarray, now: float) -> BatchResult:
        try:
            return self._dispatch(keys, ns, now)
        except Exception as exc:
            if self.config.fail_open:
                # Reference swallows the error on fail-open
                # (``tokenbucket.go:100-112``).
                reset_at = now + float(self.config.window)
                return batch_fail_open(len(keys), self.config.limit, reset_at)
            if isinstance(exc, StorageUnavailableError):
                raise
            raise StorageUnavailableError(f"device dispatch failed: {exc}") from exc

    def _allow_n(self, key: str, n: int, now: float) -> Result:
        return self._allow_batch([key], np.array([n], dtype=np.int64), now).result(0)

    # ----------------------------------------------------------------- reset

    def _reset(self, key: str) -> None:
        fkey = self.config.format_key(key)
        with self._lock:
            slot = self._slots.pop(fkey, None)
            if slot is not None:
                self._free.append(slot)
                self._zero_slots([slot])

    def _close(self) -> None:
        # State buffers are owned by this limiter; drop the references and
        # let the device allocator reclaim.
        self._state = {}
        self._slots.clear()
        self._free.clear()

    # ------------------------------------------------- checkpoint/restore

    def capture_state(self):
        """Lock-held device→host copy of the state buffers + the host slot
        map, in the JAX package's format (checkpoint.py): a file saved
        by either package restores in the other."""
        self._check_open()
        with self._lock:
            arrays = {f"state_{k}": v.cpu().numpy()
                      for k, v in self._state.items()}
            arrays["slot_keys"] = np.array(list(self._slots.keys()), dtype=str)
            arrays["slot_ids"] = np.array(list(self._slots.values()),
                                          dtype=np.int32)
            arrays["last_used"] = self._last_used.copy()
            arrays.update(self._policy_table.snapshot_arrays())
            extra = {"saved_at": self.clock.now(), "capacity": self._capacity}
        return "dense", arrays, extra

    def restore(self, path: str) -> None:
        """Replace device state and slot map with the snapshot. Elapsed-time
        catch-up is automatic (window roll / token refill key off absolute
        timestamps); keys idle across the gap are reclaimed by the usual
        prune horizon."""
        from ratelimiter_tpu_torch.checkpoint import load_state
        from ratelimiter_tpu_torch.core.errors import CheckpointError

        self._check_open()
        arrays, meta = load_state(path, "dense", self.config)
        if meta.get("capacity") != self._capacity:
            raise CheckpointError(
                f"{path}: snapshot capacity {meta.get('capacity')} != "
                f"limiter capacity {self._capacity}")
        with self._lock:
            self._policy_table.restore_arrays(arrays)  # pops policy_* columns
        state_keys = {f"state_{k}" for k in self._state}
        expected = state_keys | {"slot_keys", "slot_ids", "last_used"}
        if set(arrays) != expected:
            raise CheckpointError(
                f"{path}: state arrays {sorted(arrays)} != expected "
                f"{sorted(expected)}")
        with self._lock:
            for k, v in self._state.items():
                v.copy_(torch.from_numpy(
                    np.ascontiguousarray(arrays[f"state_{k}"], np.int64)))
            ids = arrays["slot_ids"]
            self._slots = {str(k): int(s)
                           for k, s in zip(arrays["slot_keys"], ids)}
            taken = set(int(s) for s in ids)
            self._free = [s for s in range(self._capacity - 1, -1, -1)
                          if s not in taken]
            self._last_used = arrays["last_used"].astype(np.int64).copy()

    # ------------------------------------------------------- fault injection

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        """Test hook: make every subsequent dispatch fail (the analog of
        miniredis ``mr.Close()`` mid-test). Pass None to heal."""
        self._injected_failure = exc if exc is not None else RuntimeError(
            "injected backend failure")

    def heal(self) -> None:
        self._injected_failure = None
