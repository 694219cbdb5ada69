"""Decorators around RateLimiter — ``LimiterDecorator`` from
``ratelimiter_tpu/observability/decorators.py``.

A decorator implements the same RateLimiter surface and delegates it to
``inner``, so decorators compose with each other and with either of the
port's backends. The port needs the base class for the persistence
wrapper (persistence/manager.py ``PersistentLimiter``), and delegates
the hierarchy's tenant surface too. Left out: the metrics, logging and
circuit-breaker decorators (ROADMAP A13).

Every public method of the port's limiters is delegated EXPLICITLY: the
base class defines several of them (launch_batch, resolve,
capture_state), so ``__getattr__`` would never fire for those and the
decorator would run the base's eager fallback instead of the backend's
pipelined path; and the micro-batcher picks the raw-id lane by
``hasattr(limiter, "allow_ids")``, so a wrapper missing it would quietly
send raw ids down the string path.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.types import BatchResult, Result


class LimiterDecorator(RateLimiter):
    """Base decorator: delegates the whole RateLimiter surface to ``inner``.

    Validation, clocking, and locking all live in the inner limiter.
    """

    def __init__(self, inner: RateLimiter):
        # Deliberately NOT calling RateLimiter.__init__: config is already
        # validated by (and owned by) the inner limiter.
        self.inner = inner
        self._closed = False

    @property
    def config(self):  # type: ignore[override]
        return self.inner.config

    @property
    def clock(self):  # type: ignore[override]
        return self.inner.clock

    @property
    def pipelined(self):  # type: ignore[override]
        return getattr(self.inner, "pipelined", False)

    # Decisions -----------------------------------------------------------

    def allow(self, key: str, *, now: Optional[float] = None) -> Result:
        return self.allow_n(key, 1, now=now)

    def allow_n(self, key: str, n: int, *,
                now: Optional[float] = None) -> Result:
        return self.inner.allow_n(key, n, now=now)

    def allow_batch(self, keys: Sequence[str], ns=None, *,
                    now: Optional[float] = None) -> BatchResult:
        return self.inner.allow_batch(keys, ns, now=now)

    def allow_hashed(self, h64, ns=None, *, now: Optional[float] = None):
        return self.inner.allow_hashed(h64, ns, now=now)

    def allow_ids(self, ids, ns=None, *, now: Optional[float] = None):
        return self.inner.allow_ids(ids, ns, now=now)

    def launch_batch(self, keys: Sequence[str], ns=None, *,
                     now: Optional[float] = None):
        return self.inner.launch_batch(keys, ns, now=now)

    def launch_hashed(self, h64, ns=None, *, now: Optional[float] = None):
        return self.inner.launch_hashed(h64, ns, now=now)

    def launch_ids(self, ids, ns=None, *, now: Optional[float] = None,
                   wire: bool = False):
        return self.inner.launch_ids(ids, ns, now=now, wire=wire)

    def resolve(self, ticket):
        return self.inner.resolve(ticket)

    # Mutations and lifecycle ----------------------------------------------

    def reset(self, key: str) -> None:
        self.inner.reset(key)

    def close(self) -> None:
        self._closed = True
        self.inner.close()

    def update_limit(self, new_limit: int) -> None:
        # Wholesale: config lives on the inner limiter (the base would try
        # to assign this decorator's read-only config property).
        self.inner.update_limit(new_limit)

    def update_window(self, new_window: float) -> None:
        self.inner.update_window(new_window)

    def set_override(self, key: str, limit: Optional[int] = None, *,
                     window_scale: float = 1.0):
        return self.inner.set_override(key, limit,
                                       window_scale=window_scale)

    def get_override(self, key: str):
        return self.inner.get_override(key)

    def delete_override(self, key: str) -> bool:
        return self.inner.delete_override(key)

    def list_overrides(self):
        return self.inner.list_overrides()

    def override_count(self) -> int:
        return self.inner.override_count()

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        self.inner.inject_failure(exc)

    def heal(self) -> None:
        self.inner.heal()

    # Durability: the BACKEND's state is what a snapshot holds ---------------

    def capture_state(self):
        return self.inner.capture_state()

    def restore_state(self, arrays: dict, extra: dict) -> None:
        self.inner.restore_state(arrays, extra)

    def save(self, path: str) -> None:
        self.inner.save(path)

    def restore(self, path: str) -> None:
        self.inner.restore(path)

    # Backend extras (device, mass_budget, overload_periods, ...) -----------

    # Hierarchy surface (ADR-020): same explicit-delegation rule as the
    # policy surface — the base class defines these, so __getattr__
    # never fires (the JAX package's sliced mesh overrides them with
    # write-all semantics that must survive any decorator stack).

    def set_tenant(self, name: str, limit: Optional[int] = None, *,
                   weight: int = 1, floor: Optional[int] = None):
        return self.inner.set_tenant(name, limit, weight=weight,
                                     floor=floor)

    def delete_tenant(self, name: str) -> bool:
        return self.inner.delete_tenant(name)

    def assign_tenant(self, key: str, tenant: str) -> None:
        return self.inner.assign_tenant(key, tenant)

    def unassign_tenant(self, key: str) -> bool:
        return self.inner.unassign_tenant(key)

    def tenant_of(self, key: str) -> str:
        return self.inner.tenant_of(key)

    def get_tenant(self, name: str):
        return self.inner.get_tenant(name)

    def list_tenants(self):
        return self.inner.list_tenants()

    def set_global_limit(self, limit) -> None:
        return self.inner.set_global_limit(limit)

    def set_effective(self, scope: str, limit: int) -> int:
        return self.inner.set_effective(scope, limit)

    def effective_limits(self):
        return self.inner.effective_limits()

    def hierarchy_payload(self) -> dict:
        return self.inner.hierarchy_payload()

    def apply_hierarchy_payload(self, payload: dict) -> bool:
        return self.inner.apply_hierarchy_payload(payload)

    def hierarchy_stats(self) -> dict:
        return self.inner.hierarchy_stats()

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    # The abstract hooks are never reached (the public surface is
    # overridden), but the ABC requires concrete definitions.

    def _allow_n(self, key: str, n: int, now: float) -> Result:  # pragma: no cover
        raise AssertionError("decorator delegates the public surface")

    def _reset(self, key: str) -> None:  # pragma: no cover
        raise AssertionError("decorator delegates the public surface")

