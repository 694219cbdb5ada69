"""Host-authoritative tenant registry + key→tenant map (ADR-020), a copy
of ``ratelimiter_tpu/hierarchy/tenants.py``.

One TenantTable per limiter unit, mirroring the policy engine's split:
the table owns the entry store and the *host* form of the device arrays
(sorted key→tenant map, per-scope limit/weight columns); the backend
owns placement and consults the arrays inside its decision step
(ops/hier_kernels.py and the cascade builds of the backs). Mutations are serialized by the OWNING LIMITER's
lock (RateLimiter._policy_mutate — the same discipline as PolicyTable).

Two kinds of limit per scope:

* **configured** — the operator-set ceiling (``set_tenant`` /
  ``HierarchySpec``); 0 means unlimited.
* **effective** — what the device table actually enforces right now.
  Defaults to the configured ceiling; the AIMD controller (or an
  operator override) moves it between its floor and the ceiling. The
  distinction is the control loop's lever: tightening never rewrites
  configuration, and recovery has a well-defined target to return to.

Sliced-mesh deployments pass ``divisor = n_slices``: each hash-routed
slice enforces an equal share (``max(1, effective // divisor)``) of
every tenant/global limit, the same static-split rule hash-partitioned
fleet members use. The port's multi-shard native door passes its shard
count (``--shards``); the mesh cascade is ROADMAP A8.

Durability: tenant definitions, assignments, and the CONTROLLER-MOVED
effective limits ride checkpoints as ``hier_*`` columns
(snapshot_arrays/restore_arrays), so a restart resumes adaptive state
instead of snapping every limit back to its ceiling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.config import Config, HIER_UNLIMITED
from ratelimiter_tpu_torch.core.errors import InvalidConfigError
from ratelimiter_tpu_torch.ops import policy_kernels as pk

#: Scope name addressing the global (whole-limiter) scope in the
#: effective-limit surfaces.
GLOBAL = "global"

#: Default tenant's reserved name (tid 0 — every unassigned key).
DEFAULT_TENANT = "default"

_MAX_WEIGHT = 1 << 20


@dataclass(frozen=True)
class Tenant:
    """One tenant scope: its slab index, configured ceiling, fair-share
    weight, and controller floor (the AIMD tighten bound)."""

    tid: int
    limit: int        # configured ceiling; 0 = unlimited
    weight: int
    floor: int        # lowest effective limit the controller may set


class TenantTable:
    """Bounded tenant registry + key→tenant assignment map.

    Args:
        config: the owning limiter's config (capacities and the default
            tenant/global limits come from ``config.hierarchy``).
        key_fn: maps a key string to its int64 search key — the SAME
            packed (h1, h2) domain the decision step derives tenant ids
            in (ops/hier_kernels.derive_tids).
        divisor: per-unit share divisor (sliced mesh: n_slices).
    """

    def __init__(self, config: Config, *, key_fn: Callable[[str], int],
                 divisor: int = 1):
        spec = config.hierarchy
        if not spec.enabled:
            raise InvalidConfigError(
                "TenantTable needs hierarchy.tenants > 0")
        self.capacity = spec.tenants
        self.map_capacity = spec.map_capacity
        self.divisor = max(1, int(divisor))
        self._key_fn = key_fn
        self._tenants: Dict[str, Tenant] = {}
        self._names: List[Optional[str]] = [None] * self.capacity
        self._glimit = int(spec.global_limit)          # configured; 0=unl
        #: controller-moved effective limits: tid (or GLOBAL) -> limit.
        #: Absent = tracking the configured ceiling.
        self._eff: Dict[object, int] = {}
        self._assign: Dict[str, str] = {}              # key -> tenant name
        self._skey: Dict[str, int] = {}                # key -> search key
        self._by_skey: Dict[int, str] = {}
        #: bumped on every mutation; backends invalidate device caches.
        self.version = 0
        #: bumped on every EFFECTIVE-limit change; fleet propagation uses
        #: it as a last-writer-wins revision (apply_effective_payload).
        self.revision = 0
        self._host_arrays: Optional[Dict[str, np.ndarray]] = None
        self.set_tenant(DEFAULT_TENANT,
                        limit=spec.default_tenant_limit or None)

    # ------------------------------------------------------------ tenants

    def set_tenant(self, name: str, limit: Optional[int] = None,
                   weight: int = 1, floor: Optional[int] = None) -> Tenant:
        """Register a tenant or update an existing one's ceiling/weight/
        floor. ``limit=None`` means unlimited; the effective limit snaps
        back under a LOWERED ceiling but otherwise stands."""
        if not isinstance(name, str) or not name:
            raise InvalidConfigError(f"tenant name must be a non-empty "
                                     f"string, got {name!r}")
        lim = 0 if limit is None else limit
        if (not isinstance(lim, int) or isinstance(lim, bool)
                or lim < 0 or lim >= HIER_UNLIMITED):
            raise InvalidConfigError(
                f"tenant limit must be None or an integer in [1, 2^40), "
                f"got {limit!r}")
        if (not isinstance(weight, int) or isinstance(weight, bool)
                or weight < 1 or weight > _MAX_WEIGHT):
            raise InvalidConfigError(
                f"tenant weight must be an integer in [1, {_MAX_WEIGHT}], "
                f"got {weight!r}")
        ceil_ = lim or HIER_UNLIMITED
        fl = floor if floor is not None else max(1, ceil_ // 10)
        if (not isinstance(fl, int) or isinstance(fl, bool) or fl < 1
                or fl > ceil_):
            raise InvalidConfigError(
                f"tenant floor must be an integer in [1, ceiling], "
                f"got {floor!r}")
        prev = self._tenants.get(name)
        if prev is None:
            try:
                tid = self._names.index(None)
            except ValueError:
                raise InvalidConfigError(
                    f"tenant table full ({self.capacity} tenants); raise "
                    f"HierarchySpec.tenants") from None
            if name == DEFAULT_TENANT and tid != 0:
                raise InvalidConfigError(
                    "the default tenant must be registered first (tid 0)")
        else:
            tid = prev.tid
        t = Tenant(tid=tid, limit=lim, weight=int(weight), floor=int(fl))
        self._tenants[name] = t
        self._names[tid] = name
        eff = self._eff.get(tid)
        if eff is not None and eff > ceil_:
            self._eff[tid] = ceil_
        self._invalidate()
        return t

    def delete_tenant(self, name: str) -> bool:
        """Unregister a tenant; its keys fall back to the default tenant
        (their map rows are removed)."""
        if name == DEFAULT_TENANT:
            raise InvalidConfigError("the default tenant cannot be deleted")
        t = self._tenants.pop(name, None)
        if t is None:
            return False
        self._names[t.tid] = None
        self._eff.pop(t.tid, None)
        for key in [k for k, v in self._assign.items() if v == name]:
            del self._by_skey[self._skey.pop(key)]
            del self._assign[key]
        self._invalidate()
        return True

    def get_tenant(self, name: str) -> Optional[Tenant]:
        return self._tenants.get(name)

    def tenant_names(self) -> List[str]:
        return sorted(self._tenants)

    # ------------------------------------------------------- assignments

    def assign(self, key: str, tenant: str) -> None:
        if tenant not in self._tenants:
            raise InvalidConfigError(f"unknown tenant {tenant!r}")
        if tenant == DEFAULT_TENANT:
            self.unassign(key)
            return
        if key not in self._assign and len(self._assign) >= self.map_capacity:
            raise InvalidConfigError(
                f"tenant map full ({self.map_capacity} assignments); "
                f"raise HierarchySpec.map_capacity")
        skey = int(self._key_fn(key))
        clash = self._by_skey.get(skey)
        if (clash is not None and clash != key) or skey == pk.PAD_KEY:
            raise InvalidConfigError(
                f"key {key!r} collides in the hash domain (with "
                f"{clash!r}); rename one of the keys")
        self._assign[key] = tenant
        self._skey[key] = skey
        self._by_skey[skey] = key
        self._invalidate()

    def unassign(self, key: str) -> bool:
        if key not in self._assign:
            return False
        del self._assign[key]
        del self._by_skey[self._skey.pop(key)]
        self._invalidate()
        return True

    def tenant_of(self, key: str) -> str:
        return self._assign.get(key, DEFAULT_TENANT)

    def assignments(self) -> List[Tuple[str, str]]:
        return sorted(self._assign.items())

    # -------------------------------------------------- effective limits

    def _ceiling(self, scope: object) -> int:
        if scope == GLOBAL:
            return self._glimit or HIER_UNLIMITED
        name = self._names[scope] if isinstance(scope, int) else None
        if name is None:
            raise InvalidConfigError(f"unknown scope {scope!r}")
        return self._tenants[name].limit or HIER_UNLIMITED

    def _floor(self, scope: object) -> int:
        if scope == GLOBAL:
            return max(1, (self._glimit or HIER_UNLIMITED) // 10)
        return self._tenants[self._names[scope]].floor

    @property
    def global_ceiling(self) -> int:
        return self._glimit or HIER_UNLIMITED

    def set_global_limit(self, limit: Optional[int]) -> None:
        """Move the configured global ceiling (0/None = unlimited)."""
        lim = 0 if limit is None else int(limit)
        if lim < 0 or lim >= HIER_UNLIMITED:
            raise InvalidConfigError(
                f"global limit must be in [0, 2^40), got {limit!r}")
        self._glimit = lim
        eff = self._eff.get(GLOBAL)
        if eff is not None and eff > (lim or HIER_UNLIMITED):
            self._eff[GLOBAL] = lim or HIER_UNLIMITED
        self._invalidate()

    def set_effective(self, scope: str, limit: int) -> int:
        """The controller's lever: set a scope's live effective limit
        (``scope`` = tenant name or GLOBAL), clamped to [floor, ceiling].
        Returns the clamped value actually installed."""
        key: object = GLOBAL
        if scope != GLOBAL:
            t = self._tenants.get(scope)
            if t is None:
                raise InvalidConfigError(f"unknown tenant {scope!r}")
            key = t.tid
        lim = int(limit)
        lim = max(self._floor(key), min(lim, self._ceiling(key)))
        if lim == self.effective_of(scope):
            return lim
        if lim == self._ceiling(key):
            self._eff.pop(key, None)
        else:
            self._eff[key] = lim
        self.revision += 1
        self._invalidate()
        return lim

    def effective_of(self, scope: str) -> int:
        """Current effective limit for a tenant name or GLOBAL (the
        HIER_UNLIMITED sentinel when uncapped)."""
        if scope == GLOBAL:
            return self._eff.get(GLOBAL, self._glimit or HIER_UNLIMITED)
        t = self._tenants.get(scope)
        if t is None:
            raise InvalidConfigError(f"unknown tenant {scope!r}")
        return self._eff.get(t.tid, t.limit or HIER_UNLIMITED)

    def effective_limits(self) -> Dict[str, int]:
        out = {name: self.effective_of(name) for name in self._tenants}
        out[GLOBAL] = self.effective_of(GLOBAL)
        return out

    # ------------------------------------------- fleet propagation frame

    def effective_payload(self) -> dict:
        """JSON-able effective-limit frame for DCN/announce propagation
        (fleet members converge on the highest revision)."""
        return {"revision": self.revision,
                "effective": {str(k): v for k, v in
                              self.effective_limits().items()}}

    def apply_effective_payload(self, payload: dict) -> bool:
        """Adopt a peer's effective limits when its revision is newer.
        Unknown tenant names are skipped (registries may briefly skew
        during a rollout); clamping re-applies locally."""
        try:
            rev = int(payload.get("revision", 0))
            eff = dict(payload.get("effective") or {})
        except Exception:
            return False
        if rev <= self.revision:
            return False
        for scope, lim in eff.items():
            if scope != GLOBAL and scope not in self._tenants:
                continue
            try:
                self.set_effective(scope, int(lim))
            except (InvalidConfigError, ValueError, TypeError):
                continue
        # Adoption lands exactly AT the peer's revision — the per-scope
        # set_effective bumps above must not inflate it past rev, or
        # this member would reject the origin's NEXT move (rev+1) and
        # its own re-announce would roll the fleet back to these values.
        self.revision = rev
        return True

    # -------------------------------------------------------- host arrays

    def _invalidate(self) -> None:
        self.version += 1
        self._host_arrays = None

    def host_arrays(self) -> Dict[str, np.ndarray]:
        """Padded device-table columns: sorted key→tenant map
        ({key, tid}) plus per-scope {limit, weight} with the global
        scope at index ``capacity``. Limits are EFFECTIVE, divided by
        this unit's share divisor; uncapped scopes carry the
        HIER_UNLIMITED sentinel. Rebuilt lazily per version."""
        if self._host_arrays is not None:
            return self._host_arrays
        keys = np.full(self.map_capacity, pk.PAD_KEY, dtype=np.int64)
        tids = np.zeros(self.map_capacity, dtype=np.int64)
        items = sorted((self._skey[k], self._tenants[t].tid)
                       for k, t in self._assign.items())
        for i, (sk, tid) in enumerate(items):
            keys[i] = sk
            tids[i] = tid
        T = self.capacity
        limits = np.full(T + 1, HIER_UNLIMITED, dtype=np.int64)
        weights = np.ones(T + 1, dtype=np.int64)
        for name, t in self._tenants.items():
            eff = self.effective_of(name)
            limits[t.tid] = (eff if eff >= HIER_UNLIMITED
                             else max(1, eff // self.divisor))
            weights[t.tid] = t.weight
        geff = self.effective_of(GLOBAL)
        limits[T] = (geff if geff >= HIER_UNLIMITED
                     else max(1, geff // self.divisor))
        self._host_arrays = {"key": keys, "tid": tids,
                             "limit": limits, "weight": weights}
        return self._host_arrays

    # ---------------------------------------------------------- snapshot

    def snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """Checkpoint columns (prefix ``hier_``): tenant definitions,
        controller-moved effective limits (-1 = tracking the ceiling),
        key assignments, and the effective-limit revision."""
        names = sorted(self._tenants)
        recs = [self._tenants[n] for n in names]
        eff = [self._eff.get(t.tid, -1) for t in recs]
        assigns = self.assignments()
        return {
            "hier_tenant_names": np.array(names, dtype=str),
            "hier_tenant_tids": np.array([t.tid for t in recs], np.int64),
            "hier_tenant_limits": np.array([t.limit for t in recs],
                                           np.int64),
            "hier_tenant_weights": np.array([t.weight for t in recs],
                                            np.int64),
            "hier_tenant_floors": np.array([t.floor for t in recs],
                                           np.int64),
            "hier_tenant_eff": np.array(eff, np.int64),
            "hier_assign_keys": np.array([k for k, _ in assigns],
                                         dtype=str),
            "hier_assign_tenants": np.array([t for _, t in assigns],
                                            dtype=str),
            "hier_meta": np.array(
                [self._glimit, self._eff.get(GLOBAL, -1), self.revision],
                np.int64),
        }

    def restore_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Consume (pop) the ``hier_*`` columns from a checkpoint's array
        dict; absent columns (a pre-hierarchy snapshot restored into a
        hierarchy-enabled config cannot happen — the fingerprint differs
        — but slice sub-dicts may share one combined set) leave the
        construction-time registry untouched."""
        names = arrays.pop("hier_tenant_names", None)
        tids = arrays.pop("hier_tenant_tids", None)
        limits = arrays.pop("hier_tenant_limits", None)
        weights = arrays.pop("hier_tenant_weights", None)
        floors = arrays.pop("hier_tenant_floors", None)
        eff = arrays.pop("hier_tenant_eff", None)
        akeys = arrays.pop("hier_assign_keys", None)
        atenants = arrays.pop("hier_assign_tenants", None)
        meta = arrays.pop("hier_meta", None)
        if names is None:
            return
        self._tenants.clear()
        self._names = [None] * self.capacity
        self._eff.clear()
        self._assign.clear()
        self._skey.clear()
        self._by_skey.clear()
        recs = sorted(
            zip([str(x) for x in names],
                np.asarray(tids, np.int64).tolist(),
                np.asarray(limits, np.int64).tolist(),
                np.asarray(weights, np.int64).tolist(),
                np.asarray(floors, np.int64).tolist(),
                np.asarray(eff, np.int64).tolist()),
            key=lambda r: r[1])
        for name, tid, lim, wgt, fl, ef in recs:
            if tid >= self.capacity:
                raise InvalidConfigError(
                    f"snapshot tenant {name!r} has tid {tid} outside this "
                    f"config's capacity {self.capacity}")
            self._tenants[name] = Tenant(tid=tid, limit=lim, weight=wgt,
                                         floor=fl)
            self._names[tid] = name
            if ef >= 0:
                self._eff[tid] = ef
        if meta is not None:
            glimit, geff, rev = np.asarray(meta, np.int64).tolist()[:3]
            self._glimit = int(glimit)
            if geff >= 0:
                self._eff[GLOBAL] = int(geff)
            self.revision = int(rev)
        if akeys is not None:
            for k, t in zip([str(x) for x in akeys],
                            [str(x) for x in atenants]):
                if t in self._tenants:
                    self.assign(k, t)
        self._invalidate()
