"""Host-authoritative per-key override table (a copy of
``ratelimiter_tpu/policy/table.py``).

One PolicyTable per limiter instance. The table owns the entry store and
the *host* form of the device arrays; the backend places them on its
device and decides which value columns its kernels consume:

* ``limit``      — the entry's absolute limit (tiers pin absolute
  numbers; a later ``update_limit`` moves only the default);
* ``window_us``  — the entry's effective window, microseconds
  (``base_window * window_scale``; the dense and exact backends);
* ``rate_num`` / ``rate_den`` — the entry's token-bucket refill rate as
  a reduced exact fraction (micro-tokens per microsecond), precomputed
  host-side so the device path stays gcd-free.

``update_limit``/``update_window`` rebase the table (``validate_rebase``
before any state moves, ``rebase`` after).

Thread model: the OWNING LIMITER serializes mutations and dispatches
under its own lock (set/delete happen rarely; dispatches read a
consistent snapshot). The table itself is not internally locked.

Validation happens at set time, not decision time: bounds (positive
limit, legal effective window) plus a backend-supplied ``validator``
re-running that backend's overflow/representability gates per entry —
an override a backend cannot decide exactly is refused loudly, never
silently misdecided (the same posture as ops/dense_kernels._check_gates).

Overrides ride the captured state as the ``policy_*`` columns
(snapshot_arrays/restore_arrays below), so they carry across packages,
and are the write-ahead log's main cargo (persistence/): with
persistence enabled every set/delete is logged before it is
acknowledged and recovers exactly across a crash.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.clock import MICROS, to_micros
from ratelimiter_tpu_torch.core.config import (
    MAX_WINDOW_SECONDS,
    MIN_WINDOW_SECONDS,
    Config,
)
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.ops import policy_kernels as pk


@dataclass(frozen=True)
class Override:
    """One key's tier: an absolute limit and a window multiplier."""

    limit: int
    window_scale: float = 1.0


class PolicyTable:
    """Bounded per-key override store + sorted host arrays.

    Args:
        config: the owning limiter's config (capacity, default limit /
            window, prefix come from here).
        key_fn: maps a key string to its int64 search key — the SAME
            domain the backend's decision step queries in
            (ops/policy_kernels.py module docstring).
        validator: optional hook ``(limit, window_us) -> None`` raising
            InvalidConfigError for entries the backend cannot represent.
        window_scaling: whether this backend supports per-key windows;
            False rejects ``window_scale != 1`` at set time (the sketch
            backends share one ring geometry across all keys).
    """

    def __init__(self, config: Config, *,
                 key_fn: Callable[[str], int],
                 validator: Optional[Callable[[int, int], None]] = None,
                 window_scaling: bool = True):
        self.capacity = config.policy.capacity
        self._key_fn = key_fn
        self._validator = validator
        self._window_scaling = window_scaling
        self._base_limit = config.limit
        self._base_window_us = to_micros(config.window)
        self._base_window_s = float(config.window)
        self._entries: Dict[str, Override] = {}
        self._skey: Dict[str, int] = {}      # key -> int64 search key
        self._by_skey: Dict[int, str] = {}   # reverse map (O(1) clash check)
        #: bumped on every mutation; backends invalidate device caches on it
        self.version = 0
        self._sorted_keys: np.ndarray = np.empty(0, np.int64)
        self._sorted_entries: List[Tuple[str, Override]] = []
        self._host_arrays: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------- derive

    def _effective(self, ov: Override) -> Tuple[int, int, int, int]:
        """(limit, window_us, rate_num, rate_den) for one entry."""
        w_us = max(1, int(round(self._base_window_us * ov.window_scale)))
        g = math.gcd(ov.limit * MICROS, w_us)
        return ov.limit, w_us, ov.limit * MICROS // g, w_us // g

    # ------------------------------------------------------------ mutate

    def set(self, key: str, limit: Optional[int] = None,
            window_scale: float = 1.0) -> Override:
        ov = self._insert(key, limit, window_scale)
        self._invalidate()
        return ov

    def _insert(self, key: str, limit: Optional[int],
                window_scale: float) -> Override:
        """Validate + store one entry WITHOUT rebuilding the sorted view
        (set() rebuilds per call; load() rebuilds once for the batch)."""
        if limit is None:
            limit = self._base_limit
        if (not isinstance(limit, int) or isinstance(limit, bool)
                or limit <= 0):
            raise InvalidConfigError(
                f"override limit must be a positive integer, got {limit!r}")
        ws = float(window_scale)
        if not (ws > 0.0) or ws != ws:
            raise InvalidConfigError(
                f"override window_scale must be > 0, got {window_scale!r}")
        if ws != 1.0 and not self._window_scaling:
            raise InvalidConfigError(
                "this backend shares one window geometry across all keys "
                "and cannot scale windows per key (window_scale must be 1); "
                "use the exact or dense backend for per-key windows")
        eff_w_s = self._base_window_s * ws
        if not (MIN_WINDOW_SECONDS <= eff_w_s <= MAX_WINDOW_SECONDS):
            raise InvalidConfigError(
                f"override effective window {eff_w_s:g}s outside "
                f"[{MIN_WINDOW_SECONDS:g}, {MAX_WINDOW_SECONDS:g}]s")
        ov = Override(limit=limit, window_scale=ws)
        if self._validator is not None:
            self._validator(*self._effective(ov)[:2])
        if key not in self._entries and len(self._entries) >= self.capacity:
            raise InvalidConfigError(
                f"policy table full ({self.capacity} overrides); raise "
                "PolicySpec.capacity or delete unused overrides")
        skey = int(self._key_fn(key))
        clash = self._by_skey.get(skey)
        if (clash is not None and clash != key) or skey == pk.PAD_KEY:
            raise InvalidConfigError(
                f"override key {key!r} collides in the hash domain "
                f"(with {clash!r}); rename one of the keys")
        self._entries[key] = ov
        self._skey[key] = skey
        self._by_skey[skey] = key
        return ov

    def delete(self, key: str) -> bool:
        if key not in self._entries:
            return False
        del self._entries[key]
        del self._by_skey[self._skey.pop(key)]
        self._invalidate()
        return True

    def validate_rebase(self, new_limit: int, new_window: float) -> None:
        """Re-run every entry's backend gates against a PROSPECTIVE new
        base (limit, window) — callers check this BEFORE migrating state,
        so a window change that would push an existing override past an
        overflow gate is refused up front, never silently misdecided."""
        if self._validator is None:
            return
        w_us = to_micros(new_window)
        for key, ov in self._entries.items():
            eff_w = max(1, int(round(w_us * ov.window_scale)))
            try:
                self._validator(ov.limit, eff_w)
            except InvalidConfigError as exc:
                raise InvalidConfigError(
                    f"override for {key!r} is not representable under the "
                    f"new window {new_window:g}s: {exc}") from exc

    def rebase(self, new_limit: int, new_window: float) -> None:
        """Re-derive defaults and effective windows after a dynamic
        limit/window update. Entries pin ABSOLUTE limits, so only the
        default columns and the window-derived values move. Callers run
        ``validate_rebase`` first (before any state migration)."""
        self._base_limit = int(new_limit)
        self._base_window_s = float(new_window)
        self._base_window_us = to_micros(new_window)
        self._invalidate()

    def load(self, keys, limits, scales) -> None:
        """Replace all entries (checkpoint restore). Re-runs full set-time
        validation so a snapshot can never smuggle in an entry this
        backend/config combination would refuse; the sorted view rebuilds
        ONCE for the whole batch (restore stays O(n log n))."""
        self._entries.clear()
        self._skey.clear()
        self._by_skey.clear()
        for k, lim, sc in zip(keys, limits, scales):
            self._insert(str(k), int(lim), float(sc))
        self._invalidate()

    def _invalidate(self) -> None:
        self.version += 1
        self._host_arrays = None
        items = sorted(self._entries.items(), key=lambda kv: self._skey[kv[0]])
        self._sorted_entries = items
        self._sorted_keys = np.array([self._skey[k] for k, _ in items],
                                     dtype=np.int64)

    # -------------------------------------------------------------- read

    def get(self, key: str) -> Optional[Override]:
        return self._entries.get(key)

    def items(self) -> List[Tuple[str, Override]]:
        return sorted(self._entries.items())

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def has_window_scaled(self) -> bool:
        return any(ov.window_scale != 1.0 for ov in self._entries.values())

    def effective(self, key: str) -> Optional[Tuple[int, int, int, int]]:
        """(limit, window_us, rate_num, rate_den) or None for default keys
        — the exact backend's host-side consult."""
        ov = self._entries.get(key)
        return None if ov is None else self._effective(ov)

    # -------------------------------------------------------- host arrays

    def host_arrays(self) -> Dict[str, np.ndarray]:
        """Padded, sorted int64 columns {key, limit, window_us, rate_num,
        rate_den} of length ``capacity`` — the host form the backend
        places on device. Rebuilt lazily per version."""
        if self._host_arrays is None:
            g = math.gcd(self._base_limit * MICROS, self._base_window_us)
            arrs = pk.empty_arrays(self.capacity, {
                "limit": self._base_limit,
                "window_us": self._base_window_us,
                "rate_num": self._base_limit * MICROS // g,
                "rate_den": self._base_window_us // g,
            })
            for i, (_key, ov) in enumerate(self._sorted_entries):
                lim, w_us, num, den = self._effective(ov)
                arrs["key"][i] = self._sorted_keys[i]
                arrs["limit"][i] = lim
                arrs["window_us"][i] = w_us
                arrs["rate_num"][i] = num
                arrs["rate_den"][i] = den
            self._host_arrays = arrs
        return self._host_arrays

    def limits_for(self, queries_i64: np.ndarray) -> Optional[np.ndarray]:
        """Per-query effective limits (int64[B]) for host-side result
        assembly (Result.limit / X-RateLimit-Limit), or None when no
        override matches (callers keep the scalar default)."""
        if not self._entries:
            return None
        idx, found = pk.lookup_host(self._sorted_keys,
                                    np.asarray(queries_i64, np.int64))
        if not found.any():
            return None
        lims = np.array([e[1].limit for e in self._sorted_entries],
                        dtype=np.int64)
        return np.where(found, lims[idx], np.int64(self._base_limit))

    # --------------------------------------------------------- checkpoint

    def snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """Checkpoint columns (prefix ``policy_``) appended to a backend's
        state arrays; restore feeds them back through ``load``."""
        items = self.items()
        return {
            "policy_keys": np.array([k for k, _ in items], dtype=str),
            "policy_limits": np.array([ov.limit for _, ov in items],
                                      dtype=np.int64),
            "policy_scales": np.array([ov.window_scale for _, ov in items],
                                      dtype=np.float64),
        }

    def restore_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Consume (pop) the ``policy_*`` columns from a checkpoint's array
        dict; absent columns (older snapshots) restore an empty table."""
        keys = arrays.pop("policy_keys", None)
        limits = arrays.pop("policy_limits", None)
        scales = arrays.pop("policy_scales", None)
        if keys is None:
            self._entries.clear()
            self._skey.clear()
            self._by_skey.clear()
            self._invalidate()
            return
        self.load([str(k) for k in keys],
                  [int(x) for x in np.asarray(limits, np.int64)],
                  [float(x) for x in np.asarray(scales, np.float64)])
