"""Fleet ownership map: which host owns which hash buckets (ADR-017).

The fleet tier shards the keyspace ACROSS PROCESSES exactly as the
slice-parallel mesh shards it across devices (ADR-012): a key reduces to
its finalized u64 hash (``hash_prefixed_u64`` for strings,
``splitmix64(id)`` for raw ids — the one key→hash rule), and

    bucket = h64 % buckets          # the fleet routing rule
    owner  = owner_table[bucket]    # host owning that bucket

Each host owns one or more CONTIGUOUS bucket ranges ``[lo, hi)``.
Contiguity is a failover/resharding convenience (a range moves as one
unit), not a correctness requirement. ``buckets`` is fixed for the life
of a deployment (pick hosts × 8..64 so ranges can later split —
ROADMAP item 2's elastic resharding reassigns ranges, never re-buckets).

The map carries an ``epoch``: every ownership change (today: per-range
failover, ``fleet/membership.py``) bumps it, and the highest epoch wins
everywhere — announce frames gossip the whole map, servers answer
``T_FLEET_MAP`` with theirs, and the E_NOT_OWNER redirect names the
answering epoch so stale routers know to refresh.

This is the capability analog of the reference's Redis Cluster hash
slots (16384 slots, ranges per node): same slot→node indirection, same
"move ranges, not keys" operational story.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.errors import InvalidConfigError


@dataclass(frozen=True)
class FleetHost:
    """One fleet member: identity, address, owned bucket ranges, and the
    configured failover successor for those ranges."""

    id: str
    host: str
    port: int
    ranges: Tuple[Tuple[int, int], ...] = ()
    #: Host id that adopts this host's ranges when it dies (ADR-017
    #: failover). None = no failover for these ranges (they answer
    #: degraded per fail-open/closed until the host returns).
    successor: Optional[str] = None
    #: This host's --snapshot-dir, as REACHABLE FROM ITS SUCCESSOR
    #: (shared filesystem / replicated volume): the successor restores
    #: the adopted ranges from the newest snapshot + WAL suffix here.
    snapshot_dir: Optional[str] = None
    #: Dispatch shards behind this member's door (ADR-019). 1 (the
    #: default, and always true for the asyncio door) lets peers
    #: hash-forward STRING rows on the columnar lane — a single-shard
    #: receiver decides ``splitmix64_inv(h64)`` bit-identically to the
    #: direct string. A MULTI-shard native member routes string frames
    #: by FNV over raw key bytes, so it MUST declare its shard count
    #: here; peers then forward its string rows as strings. The server
    #: binary refuses to start when its own entry disagrees with its
    #: actual shard count.
    shards: int = 1
    #: This member's HTTP gateway port (ADR-021 control tower). The
    #: fleet fan-out surfaces — /v1/fleet/status, /debug/trace?fleet=1,
    #: /debug/events?fleet=1, and the offline tools — pull peers'
    #: /healthz, trace, and event payloads from it. None = this member
    #: is skipped by rollups (reported as unreachable, never a failure).
    http: Optional[int] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def http_addr(self) -> Optional[str]:
        return f"{self.host}:{self.http}" if self.http else None

    def to_dict(self) -> dict:
        d = {"id": self.id, "host": self.host, "port": self.port,
             "ranges": [list(r) for r in self.ranges]}
        if self.successor is not None:
            d["successor"] = self.successor
        if self.snapshot_dir is not None:
            d["snapshot_dir"] = self.snapshot_dir
        if self.shards != 1:
            d["shards"] = self.shards
        if self.http is not None:
            d["http"] = self.http
        return d


@dataclass(frozen=True)
class FleetMap:
    """The whole fleet's keyspace ownership at one epoch (immutable —
    ownership changes produce a NEW map via :meth:`reassign`, so readers
    racing a failover see either map, never a half-written one)."""

    buckets: int
    hosts: Tuple[FleetHost, ...]
    epoch: int = 1
    #: bucket -> host ordinal (index into ``hosts``); built lazily.
    _table: Optional[np.ndarray] = field(default=None, compare=False,
                                         repr=False)

    # ------------------------------------------------------------ build

    @classmethod
    def from_dict(cls, d: dict) -> "FleetMap":
        hosts = tuple(
            FleetHost(id=str(h["id"]), host=str(h["host"]),
                      port=int(h["port"]),
                      ranges=tuple((int(lo), int(hi))
                                   for lo, hi in h.get("ranges", [])),
                      successor=h.get("successor"),
                      snapshot_dir=h.get("snapshot_dir"),
                      shards=int(h.get("shards", 1)),
                      http=(int(h["http"]) if h.get("http") else None))
            for h in d["hosts"])
        m = cls(buckets=int(d["buckets"]), hosts=hosts,
                epoch=int(d.get("epoch", 1)))
        m.validate()
        return m

    @classmethod
    def load(cls, path: str) -> "FleetMap":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return {"buckets": self.buckets, "epoch": self.epoch,
                "hosts": [h.to_dict() for h in self.hosts]}

    # --------------------------------------------------------- validate

    def validate(self) -> None:
        if self.buckets < 1:
            raise InvalidConfigError(
                f"fleet map needs buckets >= 1, got {self.buckets}")
        if not self.hosts:
            raise InvalidConfigError("fleet map has no hosts")
        ids = [h.id for h in self.hosts]
        if len(set(ids)) != len(ids):
            raise InvalidConfigError(f"duplicate fleet host ids: {ids}")
        for h in self.hosts:
            if h.shards < 1:
                raise InvalidConfigError(
                    f"fleet host {h.id!r} declares shards={h.shards}; "
                    f"must be >= 1")
        covered = np.zeros(self.buckets, dtype=np.int32)
        for h in self.hosts:
            if h.successor is not None and h.successor not in ids:
                raise InvalidConfigError(
                    f"fleet host {h.id!r} names unknown successor "
                    f"{h.successor!r}")
            if h.successor == h.id:
                raise InvalidConfigError(
                    f"fleet host {h.id!r} is its own successor")
            for lo, hi in h.ranges:
                if not (0 <= lo < hi <= self.buckets):
                    raise InvalidConfigError(
                        f"fleet host {h.id!r} range [{lo}, {hi}) is "
                        f"outside [0, {self.buckets})")
                covered[lo:hi] += 1
        if (covered != 1).any():
            missing = int((covered == 0).sum())
            doubled = int((covered > 1).sum())
            raise InvalidConfigError(
                f"fleet ranges must cover every bucket exactly once: "
                f"{missing} uncovered, {doubled} doubly-owned of "
                f"{self.buckets}")

    # ---------------------------------------------------------- routing

    @property
    def owner_table(self) -> np.ndarray:
        """int32[buckets] -> host ordinal (one vectorized gather routes a
        whole frame)."""
        t = self._table
        if t is None:
            t = np.zeros(self.buckets, dtype=np.int32)
            for i, h in enumerate(self.hosts):
                for lo, hi in h.ranges:
                    t[lo:hi] = i
            object.__setattr__(self, "_table", t)
        return t

    def bucket_of_hash(self, h64: np.ndarray) -> np.ndarray:
        return (np.asarray(h64, np.uint64)
                % np.uint64(self.buckets)).astype(np.int64)

    def owner_of_hash(self, h64: np.ndarray) -> np.ndarray:
        """Host ordinal per FINALIZED u64 hash."""
        return self.owner_table[self.bucket_of_hash(h64)]

    def partition(self, owners: np.ndarray) -> dict:
        """{host ordinal: frame positions} from a per-row owner vector —
        ONE stable argsort, contiguous position slices, frame order
        preserved within every group. The single partition rule shared
        by FleetClient/AsyncFleetClient fan-out and the server-side
        forwarder's split (a divergent copy would silently give one
        key two owners)."""
        owners = np.asarray(owners)
        groups: dict = {}
        order = np.argsort(owners, kind="stable")
        sorted_owners = owners[order]
        bounds = np.searchsorted(sorted_owners,
                                 np.arange(len(self.hosts) + 1))
        for o in range(len(self.hosts)):
            lo, hi = int(bounds[o]), int(bounds[o + 1])
            if lo < hi:
                groups[o] = order[lo:hi]
        return groups

    def assigns(self, ranges: Sequence[Tuple[int, int]],
                host_id: str) -> bool:
        """True when EVERY bucket of ``ranges`` is owned by ``host_id``
        under this map — the ownership-level flip confirmation
        (ADR-018): an epoch comparison alone would be satisfied by any
        concurrent bump (e.g. an unrelated failover), falsely
        confirming a move that never landed."""
        try:
            o = self.ordinal(host_id)
        except InvalidConfigError:
            return False
        t = self.owner_table
        return all((t[int(lo):int(hi)] == o).all() for lo, hi in ranges)

    def canonical_key(self) -> str:
        """Deterministic content key used to tie-break two DIFFERENT
        maps published at the SAME epoch (two uncoordinated movers can
        mint ``epoch + 1`` concurrently): every member prefers the
        smaller key, so the fleet converges on one winner; the losing
        move's sender sees its flip unconfirmed (``assigns``) and
        retries at a higher epoch."""
        import hashlib

        return hashlib.sha256(json.dumps(
            self.to_dict(), sort_keys=True).encode()).hexdigest()

    def ordinal(self, host_id: str) -> int:
        for i, h in enumerate(self.hosts):
            if h.id == host_id:
                return i
        raise InvalidConfigError(
            f"host {host_id!r} is not in the fleet map "
            f"({[h.id for h in self.hosts]})")

    def host(self, host_id: str) -> FleetHost:
        return self.hosts[self.ordinal(host_id)]

    def owned_buckets(self, host_id: str) -> int:
        return sum(hi - lo for lo, hi in self.host(host_id).ranges)

    # --------------------------------------------------------- failover

    def reassign(self, dead_id: str, to_id: str) -> "FleetMap":
        """New map with ``dead_id``'s ranges moved to ``to_id`` and the
        epoch bumped — the per-range failover transition (ADR-017). The
        dead host stays in the map with no ranges (its identity and
        snapshot_dir remain addressable; a later rejoin is an operator /
        resharding action, ROADMAP item 2)."""
        dead = self.host(dead_id)
        if not dead.ranges:
            return self
        hosts: List[FleetHost] = []
        for h in self.hosts:
            if h.id == dead_id:
                hosts.append(replace(h, ranges=()))
            elif h.id == to_id:
                # Keep ranges sorted by lo so the map stays readable.
                merged = tuple(sorted(h.ranges + dead.ranges))
                hosts.append(replace(h, ranges=merged))
            else:
                hosts.append(h)
        m = FleetMap(buckets=self.buckets, hosts=tuple(hosts),
                     epoch=self.epoch + 1)
        m.validate()
        return m

    def move_ranges(self, ranges: Sequence[Tuple[int, int]], from_id: str,
                    to_id: str) -> "FleetMap":
        """New map with the given ``[lo, hi)`` ranges moved from
        ``from_id`` to ``to_id`` and the epoch bumped — the live
        migration / rejoin / departure transition (ADR-018). A moving
        range may be a whole owned range OR a sub-range of one (the
        placement planner carves slices out of affine units, ADR-023);
        the remainder stays with ``from_id`` as split pieces. Each
        moving range must lie entirely inside ONE owned range — a
        handoff ships one standby unit, so a move that straddles units
        is two moves. Everything else (successors, snapshot dirs) is
        unchanged."""
        src = self.host(from_id)
        self.host(to_id)  # validates existence
        moving = {(int(lo), int(hi)) for lo, hi in ranges}
        owned = set(src.ranges)
        if not moving:
            return self
        if not moving <= owned:
            # Sub-range path: split each containing owned range into
            # (left, moved, right) and keep the leftovers. Whole-unit
            # moves above stay byte-identical to the pre-split code
            # (no coalescing of existing tuples).
            new_owned = set(owned)
            for lo, hi in sorted(moving):
                if not (0 <= lo < hi <= self.buckets):
                    raise InvalidConfigError(
                        f"range [{lo}, {hi}) is outside "
                        f"[0, {self.buckets})")
                parent = next((r for r in new_owned
                               if r[0] <= lo and hi <= r[1]), None)
                if parent is None:
                    raise InvalidConfigError(
                        f"fleet host {from_id!r} does not own range "
                        f"[{lo}, {hi}) as a whole unit or sub-range "
                        f"of one owned range (owns "
                        f"{sorted(new_owned)}); a straddling move "
                        f"must be issued per owned range")
                new_owned.discard(parent)
                if parent[0] < lo:
                    new_owned.add((parent[0], lo))
                if hi < parent[1]:
                    new_owned.add((hi, parent[1]))
            owned_after = new_owned
        else:
            owned_after = owned - moving
        hosts: List[FleetHost] = []
        for h in self.hosts:
            if h.id == from_id:
                hosts.append(replace(h, ranges=tuple(
                    sorted(owned_after))))
            elif h.id == to_id:
                hosts.append(replace(h, ranges=tuple(
                    sorted(set(h.ranges) | moving))))
            else:
                hosts.append(h)
        m = FleetMap(buckets=self.buckets, hosts=tuple(hosts),
                     epoch=self.epoch + 1)
        m.validate()
        return m


def affine_map(addrs: Sequence[Tuple[str, int]], *, buckets: int = 0,
               snapshot_dirs: Optional[Sequence[Optional[str]]] = None,
               ring_successors: bool = True) -> FleetMap:
    """Even contiguous split of ``buckets`` over ``addrs`` (host ids
    ``h0..hN-1``), successors on a ring — the bench/test/bootstrap
    shape. Default buckets = 16 × hosts."""
    n = len(addrs)
    if buckets <= 0:
        buckets = 16 * n
    per = buckets // n
    hosts = []
    for i, (host, port) in enumerate(addrs):
        lo = i * per
        hi = buckets if i == n - 1 else (i + 1) * per
        hosts.append(FleetHost(
            id=f"h{i}", host=host, port=port, ranges=((lo, hi),),
            successor=(f"h{(i + 1) % n}" if ring_successors and n > 1
                       else None),
            snapshot_dir=(snapshot_dirs[i] if snapshot_dirs else None)))
    m = FleetMap(buckets=buckets, hosts=tuple(hosts))
    m.validate()
    return m
