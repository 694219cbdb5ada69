"""The RateLimiter contract — a copy of ``ratelimiter_tpu/algorithms/base.py``
trimmed to what the port's backends serve (the scalar and batched API,
launch/resolve, per-key overrides, dynamic limit/window updates and the
checkpoint seam) and the hierarchy surface (tenant and global scopes).
``sub_limiters`` (the mesh, A8) is not ported.

Parity with reference ``internal/ratelimiter/interface.go:76-145`` plus the
TPU-native first-class batched call. Semantic decisions (SURVEY.md §2.4, each
deliberate):

1. ``allow(key) == allow_n(key, 1)`` — same as reference (§2.4.1).
2. **allow_n is all-or-nothing and denial consumes nothing**, for *all*
   algorithms. This honors the documented contract (reference
   ``interface.go:104-105``) that the reference's FixedWindow/SlidingWindow
   implementations violate (they INCRBY before checking — §2.4.2). A
   divergence test pins this (tests/test_divergences.py).
3. Denied results have remaining clamped >= 0 and algorithm-specific
   retry_after (§2.4.5): token bucket = time to refill the deficit; windows =
   time to window reset.
4. Backend failure: fail_open=True -> allowed Result with fail_open flag set
   (reference swallows the error, ``tokenbucket.go:100-112``); fail_open=False
   -> StorageUnavailableError raised, no Result (§2.4.10).
5. ``n <= 0`` raises InvalidNError before touching the backend (§2.4.11);
   empty / non-string keys raise InvalidKeyError (fixing the reference's
   unvalidated-key gap, §2.4.11).
6. close() releases only what the limiter owns; shared stores are not killed
   by one limiter's close (fixing §2.4.13).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import numpy as np

from ratelimiter_tpu_torch.core.clock import Clock, SystemClock
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import (
    ClosedError,
    InvalidConfigError,
    InvalidKeyError,
    InvalidNError,
)
from ratelimiter_tpu_torch.core.types import BatchResult, Result


def check_key(key: str) -> None:
    if not isinstance(key, str) or key == "":
        raise InvalidKeyError(f"key must be a non-empty string, got {key!r}")


def check_n(n: int) -> None:
    if not isinstance(n, int) or isinstance(n, bool) or n <= 0:
        raise InvalidNError(f"n must be a positive integer, got {n!r}")


class RateLimiter(abc.ABC):
    """Abstract limiter. Thread-safety is part of the contract (reference
    ``interface.go:74``): implementations must serialize or batch concurrent
    calls such that a limit of L admits exactly L unit requests."""

    def __init__(self, config: Config, clock: Optional[Clock] = None):
        config = config.with_defaults()
        config.validate()
        self.config = config
        self.clock = clock if clock is not None else SystemClock()
        self._closed = False

    # -- scalar API (reference parity) ------------------------------------

    def allow(self, key: str, *, now: Optional[float] = None) -> Result:
        """One request for key. Reference ``Allow`` (``interface.go:87-96``)."""
        return self.allow_n(key, 1, now=now)

    def allow_n(self, key: str, n: int, *, now: Optional[float] = None) -> Result:
        """Atomic batch of n for key: all n admitted or none, denial consumes
        nothing. Reference ``AllowN`` (``interface.go:98-115``)."""
        self._check_open()
        check_key(key)
        check_n(n)
        t = self.clock.now() if now is None else float(now)
        return self._allow_n(key, n, t)

    def reset(self, key: str) -> None:
        """Clear all state for key. Reference ``Reset`` (``interface.go:117-126``)."""
        self._check_open()
        check_key(key)
        self._reset(key)

    def close(self) -> None:
        """Release owned resources; idempotent. Reference ``Close``
        (``interface.go:128-136``)."""
        if not self._closed:
            self._closed = True
            self._close()

    def update_limit(self, new_limit: int) -> None:
        """Change the limit without losing state.

        Semantics: takes effect for every subsequent decision; quota
        already consumed stands. For the token bucket the refill rate
        (limit/window) and capacity both change. Policy overrides pin
        ABSOLUTE limits, so only non-overridden keys move."""
        from dataclasses import replace

        self._check_open()
        new_cfg = replace(self.config, limit=new_limit)
        new_cfg.validate()
        table = getattr(self, "_policy_table", None)
        if table is not None:
            table.validate_rebase(new_cfg.limit, new_cfg.window)
        self._apply_config(new_cfg)
        self.config = new_cfg
        if table is not None:
            table.rebase(new_cfg.limit, new_cfg.window)

    def update_window(self, new_window: float) -> None:
        """Change the window without losing state: backends that support
        this migrate their state to the new time geometry.

        Semantics: takes effect for every subsequent decision. Consumed
        quota is re-bucketed onto the new geometry conservatively —
        counts never expire earlier than they would have under either
        window, so a migration can only err toward denying, never toward
        over-admission. For the token bucket the refill rate
        (limit/window) changes; accumulated debt stands."""
        self._check_open()
        from dataclasses import replace

        table = getattr(self, "_policy_table", None)
        if table is not None and table.has_window_scaled:
            raise InvalidConfigError(
                "update_window with window-scaled overrides present is not "
                "supported (per-key grids cannot be re-bucketed uniformly); "
                "delete the scaled overrides first")
        new_cfg = replace(self.config, window=float(new_window))
        new_cfg.validate()
        if table is not None:
            # BEFORE migrating state: an entry the backend cannot decide
            # exactly under the new window is refused up front.
            table.validate_rebase(new_cfg.limit, new_cfg.window)
        self._apply_window(new_cfg)
        self.config = new_cfg
        if table is not None:
            table.rebase(new_cfg.limit, new_cfg.window)

    def _apply_window(self, new_cfg: Config) -> None:
        """Backend hook: migrate state onto the new window geometry."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support dynamic window updates")

    def _apply_config(self, new_cfg: Config) -> None:
        """Backend hook: rebuild the steps / derived constants / stored
        levels for the new config. The base raises so an unimplemented
        backend fails loudly."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support dynamic limit updates")

    # -- batched API -----------------------------

    def allow_batch(
        self,
        keys: Sequence[str],
        ns: Optional[Sequence[int]] = None,
        *,
        now: Optional[float] = None,
    ) -> BatchResult:
        """Decide a whole batch in one backend call.

        Semantics: equivalent to calling allow_n(keys[i], ns[i]) sequentially
        in batch order at a single common timestamp (the reference's
        serialized-Lua semantics, SURVEY.md §4.2.4, transplanted to batches).
        Duplicate keys in one batch therefore contend for the same quota, in
        order.
        """
        self._check_open()
        for k in keys:
            check_key(k)
        if ns is None:
            ns_arr = np.ones(len(keys), dtype=np.int64)
        else:
            if len(ns) != len(keys):
                raise InvalidNError(
                    f"ns length {len(ns)} != keys length {len(keys)}")
            for n in ns:
                check_n(int(n))
            ns_arr = np.asarray(ns, dtype=np.int64)
        t = self.clock.now() if now is None else float(now)
        return self._allow_batch(list(keys), ns_arr, t)

    # -- pipelined dispatch (launch / resolve) -----------------------------
    #
    # The serving doors overlap host encode/decode with device compute by
    # splitting each dispatch into a launch phase (enqueue, non-blocking)
    # and a resolve phase (block on the oldest in-flight result) —
    # ADR-010. Backends with an async device path (the sketch family)
    # override with a real split and set ``pipelined = True``; the base
    # fallback computes eagerly and returns a pre-resolved ticket so
    # callers can target one API regardless of backend.

    #: True when launch_batch genuinely defers device work (a door gains
    #: nothing from pipelining a backend that resolves at launch).
    pipelined = False

    def launch_batch(self, keys: Sequence[str],
                     ns: Optional[Sequence[int]] = None, *,
                     now: Optional[float] = None):
        """Launch a batched dispatch; resolve() returns its BatchResult.
        Base fallback: decide eagerly, return a pre-resolved ticket."""
        from ratelimiter_tpu_torch.core.types import DispatchTicket

        return DispatchTicket(result=self.allow_batch(keys, ns, now=now))

    def resolve(self, ticket):
        """Block until a launched dispatch lands; returns its BatchResult."""
        if ticket.result is None:
            from ratelimiter_tpu_torch.core.errors import RateLimiterError

            raise RateLimiterError(
                "unresolved ticket reached the base resolve() — it was "
                "launched by a pipelined backend and must be resolved by it")
        return ticket.result

    # -- policy engine (tiered per-key overrides) --------------------------
    #
    # Backends that support overrides own a ``_policy_table``
    # (ratelimiter_tpu/policy/table.py) consulted INSIDE their decision
    # step; these methods are the uniform management surface every serving
    # front door (binary protocol, HTTP /v1/policy, gRPC) routes through.
    # Decorators inherit them and reach the backend's table via attribute
    # delegation.

    def _policy(self):
        table = getattr(self, "_policy_table", None)
        if table is None:
            raise NotImplementedError(
                f"{type(self).__name__} does not support per-key overrides")
        return table

    def set_override(self, key: str, limit: Optional[int] = None, *,
                     window_scale: float = 1.0):
        """Give ``key`` its own limit (and, on backends with per-key
        windows, a window multiplier). Takes effect for every subsequent
        decision, including ones in the same batch as default keys —
        resolution happens inside the fused device step. Consumed quota
        stands; a raised limit frees headroom immediately, a lowered one
        denies until usage drains. Returns the stored Override."""
        self._check_open()
        check_key(key)
        table = self._policy()

        def _mutate():
            ov = table.set(key, limit, window_scale)
            hook = getattr(self, "_policy_changed", None)
            if hook is not None:
                hook(key)
            return ov

        return self._policy_mutate(_mutate)

    def get_override(self, key: str):
        """The Override stored for key, or None (default tier)."""
        self._check_open()
        check_key(key)
        return self._policy().get(key)

    def delete_override(self, key: str) -> bool:
        """Return key to the default tier. True iff an override existed."""
        self._check_open()
        check_key(key)
        table = self._policy()

        def _mutate():
            existed = table.delete(key)
            hook = getattr(self, "_policy_changed", None)
            if existed and hook is not None:
                hook(key)
            return existed

        return self._policy_mutate(_mutate)

    def list_overrides(self):
        """All (key, Override) pairs, sorted by key."""
        self._check_open()
        return self._policy().items()

    def override_count(self) -> int:
        return len(self._policy())

    def _policy_mutate(self, fn):
        """Run a table mutation under the backend's lock when it has one
        (mutations race with dispatch snapshots otherwise)."""
        lock = getattr(self, "_lock", None)
        if lock is None:
            return fn()
        with lock:
            return fn()

    # -- hierarchical cascades (tenant + global scopes, ADR-020) -----------
    #
    # Backends that support the cascade own a ``_hier_table``
    # (hierarchy/tenants.py) whose device arrays the
    # decision step consults; this is the uniform management surface.
    # Mutations run under the backend's lock (same rule as the policy
    # table); the device copy invalidates off the table's version.

    def _hier(self):
        table = getattr(self, "_hier_table", None)
        if table is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no hierarchy — enable it with "
                f"Config.hierarchy.tenants > 0 on a sketch-family backend")
        return table

    def set_tenant(self, name: str, limit: Optional[int] = None, *,
                   weight: int = 1, floor: Optional[int] = None):
        """Register (or update) a tenant scope: its per-window ceiling
        (None = unlimited), fair-share weight, and controller floor."""
        self._check_open()
        table = self._hier()
        return self._policy_mutate(
            lambda: table.set_tenant(name, limit, weight, floor))

    def delete_tenant(self, name: str) -> bool:
        self._check_open()
        table = self._hier()
        return self._policy_mutate(lambda: table.delete_tenant(name))

    def assign_tenant(self, key: str, tenant: str) -> None:
        """Map ``key`` to ``tenant``; the decision step derives the id on
        device from the sorted map (nothing new crosses the wire)."""
        self._check_open()
        check_key(key)
        table = self._hier()
        self._policy_mutate(lambda: table.assign(key, tenant))

    def unassign_tenant(self, key: str) -> bool:
        self._check_open()
        check_key(key)
        table = self._hier()
        return self._policy_mutate(lambda: table.unassign(key))

    def tenant_of(self, key: str) -> str:
        self._check_open()
        return self._hier().tenant_of(key)

    def get_tenant(self, name: str):
        """The registered Tenant (tid/limit/weight/floor), or None."""
        self._check_open()
        return self._hier().get_tenant(name)

    def list_tenants(self):
        """Sorted (name, Tenant) pairs."""
        self._check_open()
        t = self._hier()
        return sorted((n, t.get_tenant(n)) for n in t.tenant_names())

    def set_global_limit(self, limit: Optional[int]) -> None:
        self._check_open()
        table = self._hier()
        self._policy_mutate(lambda: table.set_global_limit(limit))

    def set_effective(self, scope: str, limit: int) -> int:
        """The adaptive-control lever: move a scope's LIVE effective
        limit (clamped to [floor, ceiling]); ``scope`` is a tenant name
        or hierarchy.GLOBAL. Configuration (ceilings) never moves."""
        self._check_open()
        table = self._hier()
        return self._policy_mutate(lambda: table.set_effective(scope, limit))

    def effective_limits(self):
        self._check_open()
        return self._hier().effective_limits()

    def hierarchy_payload(self) -> dict:
        """Revision-stamped effective-limit frame for fleet propagation."""
        self._check_open()
        return self._hier().effective_payload()

    def apply_hierarchy_payload(self, payload: dict) -> bool:
        """Adopt a peer's effective limits when newer (announce receive
        path); returns whether anything changed."""
        self._check_open()
        table = self._hier()
        return self._policy_mutate(
            lambda: table.apply_effective_payload(payload))

    def hierarchy_stats(self) -> dict:
        """Live per-scope view for the controller/healthz: in-window
        admitted mass + effective/ceiling/weight per tenant and for the
        global scope. Backends with cascade state override."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose hierarchy stats")

    # -- durability (checkpoint / async snapshot seam) ---------------------

    def capture_state(self):
        """Lock-held, cheap device→host capture of full limiter state:
        returns ``(kind, arrays, extra)`` ready for
        ``checkpoint.save_state``. The contract that makes async
        snapshotting (persistence/snapshotter.py) safe: everything
        needing the limiter's lock happens INSIDE this call; the caller
        serializes and writes off-lock. ``save()`` is capture + write in
        one blocking call (the manual checkpoint surface)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support state capture")

    def save(self, path: str) -> None:
        """Blocking snapshot to ``path`` (.npz): capture under the lock,
        then a crash-atomic write (checkpoint.save_state). Format and
        staleness contract: ratelimiter_tpu_torch/checkpoint.py."""
        from ratelimiter_tpu_torch.checkpoint import save_state

        kind, arrays, extra = self.capture_state()
        save_state(path, kind, self.config, arrays, extra)

    # -- implementation hooks ---------------------------------------------

    @abc.abstractmethod
    def _allow_n(self, key: str, n: int, now: float) -> Result: ...

    @abc.abstractmethod
    def _reset(self, key: str) -> None: ...

    def _close(self) -> None:
        pass

    def _allow_batch(self, keys: list, ns: np.ndarray, now: float) -> BatchResult:
        """Default: sequential scalar calls (exact). Device backends override
        with a single fused dispatch."""
        results = [self._allow_n(k, int(n), now) for k, n in zip(keys, ns)]
        limits = np.array([r.limit for r in results], dtype=np.int64)
        return BatchResult(
            allowed=np.array([r.allowed for r in results], dtype=bool),
            limit=self.config.limit,
            remaining=np.array([r.remaining for r in results], dtype=np.int64),
            retry_after=np.array([r.retry_after for r in results], dtype=np.float64),
            reset_at=np.array([r.reset_at for r in results], dtype=np.float64),
            limits=(limits if bool(np.any(limits != self.config.limit))
                    else None),
        )

    def _check_open(self) -> None:
        if self._closed:
            raise ClosedError("limiter is closed")
