"""Exact host-side (dict) backend — the conformance oracle (a copy of
``ratelimiter_tpu/algorithms/exact.py``).

Plays the role miniredis plays for the reference (SURVEY.md §4.2.1): the same
public code path, exact semantics, virtual time, no device. It is also the
accuracy oracle the sketch backend's false-deny rate is measured against
(BASELINE.json metric), standing in for the reference's Redis sliding-window
oracle.

Semantics follow the reference implementations (SURVEY.md §2.4) except where
the documented contract wins over the code (deliberate divergences, pinned in
tests/test_divergences.py):

* allow_n is conditional-consume for ALL algorithms — denial consumes nothing
  (the documented contract ``interface.go:104-105``; the reference's FW/SW
  code INCRBYs before checking, §2.4.2).
* remaining is uniformly "floor of the free quota after this decision" —
  the reference token bucket's behavior (``tokenbucket.go:51``) applied
  everywhere. (At fractional sliding-window weights the reference instead
  floors the weighted count, overstating free quota by <1.)

Numerics (SURVEY.md §7.4 hard part #5): the reference does token math in
float64 inside Lua (``tokenbucket.go:36-38``), which drifts under f32 and
accumulates rounding under any float. Here ALL state math is exact integer
arithmetic in microseconds / micro-tokens:

* token bucket: tokens in int micro-tokens; refill rate as the reduced
  fraction num/den of (limit * 1e6) / window_us; a per-key remainder carries
  sub-micro-token credit so refill truncation never loses quota;
* sliding window: weighted counts scaled by window_us
  (``prev*(window-elapsed) + curr*window`` vs ``limit*window``), no division
  at all on the decision path.

The device backends implement the *same* integer recurrences, so exact and
dense backends agree bit-for-bit (tests/test_torch_exact.py; the JAX
package pins the same in tests/test_cross_backend.py). Host code in both
packages: it takes no device.

State GC: the reference leans on Redis TTLs (window for FW, 2x window for
SW-prev and TB hashes — §2.4.9). Here idle entries are pruned lazily on access
and by ``prune()`` using the same horizons.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.clock import Clock, MICROS, to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.types import (
    Algorithm,
    Result,
    allowed_result,
    denied_result,
)


class ExactLimiter(RateLimiter):
    """Exact in-process limiter for all algorithms (TPU_SKETCH maps to exact
    sliding-window semantics — it is the sketch's oracle)."""

    def __init__(self, config: Config, clock: Optional[Clock] = None):
        super().__init__(config, clock)
        self._lock = threading.Lock()
        self._window_us = to_micros(self.config.window)
        # Token-bucket refill rate as a reduced exact fraction:
        # num/den micro-tokens per microsecond = (limit * 1e6) / window_us.
        g = math.gcd(self.config.limit * MICROS, self._window_us)
        self._rate_num = self.config.limit * MICROS // g
        self._rate_den = self._window_us // g
        # fixed window: formatted key -> (window_start_us, count)
        self._fw: Dict[str, Tuple[int, int]] = {}
        # sliding window: formatted key -> (curr_start_us, curr, prev)
        self._sw: Dict[str, Tuple[int, int, int]] = {}
        # token bucket: formatted key -> (tokens_micro, refill_remainder, last_us)
        self._tb: Dict[str, Tuple[int, int, int]] = {}
        # Policy engine: host-side consult (this backend IS the oracle the
        # device backends' in-kernel lookup is measured against). The key
        # domain matches the dense backend's so cross-backend tests cover
        # the same hash path.
        from ratelimiter_tpu_torch.policy import PolicyTable

        self._policy_table = PolicyTable(
            self.config, key_fn=self._policy_key, window_scaling=True)

    def _policy_key(self, key: str) -> int:
        import numpy as np

        from ratelimiter_tpu_torch.ops.hashing import hash_strings_u64

        h = hash_strings_u64([self.config.format_key(key)])
        return int(h.view(np.int64)[0])

    def _policy_changed(self, key: str) -> None:
        """An override mutation re-denominates the key's token-bucket
        refill remainder (it carries sub-micro-token credit in units of
        the key's rate fraction): reset it — forfeits < 1 micro-token,
        toward denying. Lock held by the caller."""
        fkey = self.config.format_key(key)
        if fkey in self._tb:
            tokens, _rem, last = self._tb[fkey]
            self._tb[fkey] = (tokens, 0, last)

    def _eff(self, key: str) -> Tuple[int, int, int, int]:
        """(limit, window_us, rate_num, rate_den) for key — the override
        entry when present, the config defaults otherwise."""
        eff = self._policy_table.effective(key)
        if eff is None:
            return (self.config.limit, self._window_us,
                    self._rate_num, self._rate_den)
        return eff

    def _apply_config(self, new_cfg: Config) -> None:
        """Dynamic limit. The cross-backend contract (pinned in
        tests/test_dynamic_config.py): CONSUMPTION STANDS — available
        quota becomes max(0, new_limit - consumed). For the token bucket
        that means stored levels shift by the limit delta (clamped to
        [0, new_cap]), matching the sketch backend's debt form exactly;
        refill remainders reset (forfeits < 1 micro-token, toward
        denying)."""
        with self._lock:
            delta = (new_cfg.limit - self.config.limit) * MICROS
            cap = new_cfg.limit * MICROS
            self._tb = {k: (min(max(t + delta, 0), cap), 0, last)
                        for k, (t, _rem, last) in self._tb.items()}
            g = math.gcd(new_cfg.limit * MICROS, self._window_us)
            self._rate_num = new_cfg.limit * MICROS // g
            self._rate_den = self._window_us // g

    def _apply_window(self, new_cfg: Config) -> None:
        """Dynamic window: host-side re-bucketing under the SAME contract
        the sketch migration pins (tests/test_dynamic_window.py):
        consumption stands, history re-expires on the NEW window's
        schedule, and migration can only err toward denying — each live
        old bucket's mass is attributed to the last new-grid window its
        time span overlaps (the window-granularity mirror of
        ops/sketch_kernels._migrate_window's sub-window rule), so
        nothing gets an early free refill.

        Token bucket: the window only sets the refill rate; debt/levels
        stand and the sub-micro-token remainder (denominated in the old
        rate fraction) resets — forfeits < 1 micro-token, toward
        denying."""
        W_new = to_micros(new_cfg.window)
        with self._lock:
            # The grid anchors (now / cur_old / p_now) are computed INSIDE
            # the lock: sampling them outside raced concurrent decisions —
            # a decision could roll a key's window against the live clock
            # after we snapshotted an older "current window", making the
            # migration misclassify that key's buckets (over-admission).
            W_old = self._window_us
            now_us = to_micros(self.clock.now())
            cur_old = (now_us // W_old) * W_old
            p_now = now_us // W_new
            new_start = p_now * W_new
            # Fixed window: the live old window's span always reaches
            # into the current new-grid window (now < cur_old + W_old),
            # so live counts carry; stale entries drop.
            self._fw = {fkey: (new_start, count)
                        for fkey, (start, count) in self._fw.items()
                        if start == cur_old}
            # Sliding window: normalize (lazy-roll) under the old grid,
            # then attribute each bucket by its span's last new period.
            # The old curr bucket always overlaps the current new window
            # (same argument as FW) -> new curr; old prev lands in the
            # current window, the boundary one, or ages out.
            q_prev = (cur_old - 1) // W_new
            sw = {}
            for fkey, (start, curr, prev) in self._sw.items():
                if start == cur_old:
                    pass                      # both buckets live
                elif start == cur_old - W_old:
                    prev, curr = curr, 0      # rolled exactly one window
                else:
                    continue                  # idle > one window: dead
                new_curr = curr + (prev if q_prev >= p_now else 0)
                new_prev = prev if q_prev == p_now - 1 else 0
                if new_curr or new_prev:
                    sw[fkey] = (new_start, new_curr, new_prev)
            self._sw = sw
            # Token bucket: new rate fraction; levels and last stand.
            self._window_us = W_new
            g = math.gcd(new_cfg.limit * MICROS, W_new)
            self._rate_num = new_cfg.limit * MICROS // g
            self._rate_den = W_new // g
            self._tb = {k: (t, 0, last)
                        for k, (t, _rem, last) in self._tb.items()}

    # ---------------------------------------------------- fault injection

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        """Test hook: fail every subsequent decision (the miniredis
        ``mr.Close()`` analog, SURVEY.md §4.2.3) so fail-open/fail-closed
        paths are exercisable on the oracle exactly like on the device
        backends. Pass None via heal() to recover."""
        self._injected_failure = exc if exc is not None else RuntimeError(
            "injected backend failure")

    def heal(self) -> None:
        self._injected_failure = None

    # ------------------------------------------------------------------ allow

    def _allow_n(self, key: str, n: int, now: float) -> Result:
        algo = self.config.algorithm
        if getattr(self, "_injected_failure", None) is not None:
            if self.config.fail_open:
                from ratelimiter_tpu_torch.core.types import fail_open_result

                return fail_open_result(self.config.limit,
                                        now + float(self.config.window))
            from ratelimiter_tpu_torch.core.errors import StorageUnavailableError

            raise StorageUnavailableError(
                f"exact store failure: {self._injected_failure}")
        now_us = to_micros(now)
        with self._lock:
            if algo is Algorithm.FIXED_WINDOW:
                return self._fixed_window(key, n, now_us)
            if algo in (Algorithm.SLIDING_WINDOW, Algorithm.TPU_SKETCH):
                return self._sliding_window(key, n, now_us)
            return self._token_bucket(key, n, now_us)

    def _fixed_window(self, key: str, n: int, now_us: int) -> Result:
        """Reference ``fixedwindow.go:65-115``: counter per (key, window
        start); windows wall-clock aligned via truncation (§2.4.14); allow iff
        count + n <= limit (conditional consume, see module docstring).
        Limit and window come from the policy table when key carries an
        override — a window-scaled key lives on its OWN wall-clock grid."""
        cfg = self.config
        limit, W, _, _ = self._eff(key)
        window_start = (now_us // W) * W
        fkey = cfg.format_key(key)
        start, count = self._fw.get(fkey, (window_start, 0))
        if start != window_start:
            count = 0  # lazy window roll — the analog of the FW key TTL
        reset_at = (window_start + W) / MICROS
        if count + n <= limit:
            count += n
            self._fw[fkey] = (window_start, count)
            return allowed_result(limit, limit - count, reset_at)
        self._fw[fkey] = (window_start, count)
        retry = (window_start + W - now_us) / MICROS
        return denied_result(limit, limit - count, retry, reset_at)

    def _sliding_window(self, key: str, n: int, now_us: int) -> Result:
        """Reference ``slidingwindow.go:68-122``: weighted two-window count
        ``prev*(1-progress) + curr`` (``slidingwindow.go:190-197``), windows
        wall-clock aligned. Unlike the reference (which increments in Lua then
        decides in Go — a check-act race it accepts, §2.4.4), the check and
        the consume here are one atomic step. All math is window_us-scaled
        integers (module docstring)."""
        cfg = self.config
        limit, W, _, _ = self._eff(key)
        curr_start = (now_us // W) * W
        fkey = cfg.format_key(key)
        start, curr, prev = self._sw.get(fkey, (curr_start, 0, 0))
        if start != curr_start:
            if start == curr_start - W:
                prev, curr = curr, 0     # rolled exactly one window
            else:
                prev, curr = 0, 0        # idle > one window: both expired
        elapsed = now_us - curr_start
        # weighted * W == prev*(W-elapsed) + curr*W ; free * W as below.
        free_scaled = limit * W - prev * (W - elapsed) - curr * W
        reset_at = (curr_start + W) / MICROS
        if n * W <= free_scaled:
            curr += n
            self._sw[fkey] = (curr_start, curr, prev)
            return allowed_result(limit, (free_scaled - n * W) // W, reset_at)
        self._sw[fkey] = (curr_start, curr, prev)
        retry = (curr_start + W - now_us) / MICROS
        return denied_result(limit, free_scaled // W, retry, reset_at)

    def _token_bucket(self, key: str, n: int, now_us: int) -> Result:
        """Reference Lua ``tokenbucket.go:23-52``: lazy continuous refill
        ``tokens = min(cap, tokens + elapsed*rate)``; new buckets start full;
        consume only if sufficient (denial consumes nothing — the one
        algorithm where the reference already honors the contract).

        Exact integer refill: time-to-full from any level is <= window, so
        elapsed >= window_us short-circuits to a full bucket; otherwise
        ``elapsed*num + rem`` micro-token-numerator units accrue, with the
        remainder carried per key (zero drift, module docstring)."""
        cfg = self.config
        limit, W, num, den = self._eff(key)
        cap = limit * MICROS
        fkey = cfg.format_key(key)
        tokens, rem, last = self._tb.get(fkey, (cap, 0, now_us))
        elapsed = max(0, now_us - last)
        if elapsed >= W:
            tokens, rem = cap, 0
        else:
            acc = elapsed * num + rem
            tokens += acc // den
            rem = acc % den
            if tokens >= cap:
                tokens, rem = cap, 0
        # Reference reset_at approximation: now + time to fill the whole
        # bucket from empty, regardless of level (``tokenbucket.go:161-165``)
        # == now + window.
        reset_at = (now_us + W) / MICROS
        need = n * MICROS
        if tokens >= need:
            tokens -= need
            self._tb[fkey] = (tokens, rem, now_us)
            return allowed_result(limit, tokens // MICROS, reset_at)
        self._tb[fkey] = (tokens, rem, now_us)
        # Reference ``tokenbucket.go:122-130``: time for the deficit to refill
        # (ceil so that retrying exactly then succeeds).
        retry_us = -((need - tokens) * den // -num)  # ceil division
        return denied_result(limit, tokens // MICROS, retry_us / MICROS, reset_at)

    # ------------------------------------------------------------------ reset

    def _reset(self, key: str) -> None:
        """Clears all state for key. For FW the reference deletes only the
        current window's Redis key (``fixedwindow.go:118-128``, §2.4.12);
        since expired windows can never influence a decision, deleting
        everything is observationally equivalent — pinned in tests."""
        fkey = self.config.format_key(key)
        with self._lock:
            self._fw.pop(fkey, None)
            self._sw.pop(fkey, None)
            self._tb.pop(fkey, None)

    # ------------------------------------------------------------------ GC

    def prune(self, now: Optional[float] = None) -> int:
        """Drop entries the reference's TTLs would have expired (§2.4.9):
        FW after 1 window, SW and TB after 2 windows of idleness. Returns the
        number of entries dropped."""
        t_us = to_micros(self.clock.now() if now is None else float(now))
        W = self._window_us
        dropped = 0
        with self._lock:
            for fkey, (start, _count) in list(self._fw.items()):
                if t_us - start >= W:
                    del self._fw[fkey]
                    dropped += 1
            for fkey, (start, _c, _p) in list(self._sw.items()):
                if t_us - start >= 2 * W:
                    del self._sw[fkey]
                    dropped += 1
            for fkey, (_tok, _rem, last) in list(self._tb.items()):
                if t_us - last >= 2 * W:
                    del self._tb[fkey]
                    dropped += 1
        return dropped

    # ------------------------------------------------- checkpoint/restore

    def capture_state(self):
        """Lock-held copy of the host dicts as arrays — same format family
        as the device backends (checkpoint.py), so the
        oracle can be checkpointed alongside the backend it validates.
        Serialization/writing happen in the caller, off-lock."""
        import numpy as np

        self._check_open()
        with self._lock:
            arrays = {}
            for name, d, width in (("fw", self._fw, 2), ("sw", self._sw, 3),
                                   ("tb", self._tb, 3)):
                arrays[f"{name}_keys"] = np.array(list(d.keys()), dtype=str)
                arrays[f"{name}_vals"] = (
                    np.array(list(d.values()), dtype=np.int64).reshape(-1, width))
            arrays.update(self._policy_table.snapshot_arrays())
            extra = {"saved_at": self.clock.now()}
        return "exact", arrays, extra

    def restore(self, path: str) -> None:
        import numpy as np  # noqa: F401  (symmetry with save)

        from ratelimiter_tpu_torch.checkpoint import load_state

        self._check_open()
        arrays, _meta = load_state(path, "exact", self.config)
        with self._lock:
            self._policy_table.restore_arrays(arrays)
            self._fw = {str(k): tuple(int(x) for x in v)
                        for k, v in zip(arrays["fw_keys"], arrays["fw_vals"])}
            self._sw = {str(k): tuple(int(x) for x in v)
                        for k, v in zip(arrays["sw_keys"], arrays["sw_vals"])}
            self._tb = {str(k): tuple(int(x) for x in v)
                        for k, v in zip(arrays["tb_keys"], arrays["tb_vals"])}

    # ------------------------------------------------------------------ intro

    def key_count(self) -> int:
        """Number of live state entries (memory-footprint introspection; the
        analog of the reference's ~100-200 B/user Redis accounting,
        ``docs/ARCHITECTURE.md:458-469``)."""
        with self._lock:
            return len(self._fw) + len(self._sw) + len(self._tb)
