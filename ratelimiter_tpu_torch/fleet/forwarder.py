"""Fleet routing core + the server-side coalesced forwarder (ADR-017,
forward lanes reworked by ADR-019).

``FleetCore`` is one process's view of the fleet: the live ownership map
(swapped atomically on epoch bumps), this host's identity, per-peer
forward lanes, the adopted-range standby unit installed by failover,
and the shared metrics. Both front doors route through one core:

* the asyncio door wraps its serving limiter in :class:`FleetForwarder`
  (a LimiterDecorator — the micro-batcher's launch_batch / launch_ids
  calls partition per frame);
* the native (C++) door calls the core directly from its bridge
  callbacks (serving/native_server.py), where the key blob is still in
  hand.

Forwarding rides ONE columnar lane (ADR-019): every foreign row reduces
to its finalized u64 hash, the lane ships ``splitmix64_inv(h64)`` on
the plain ``T_ALLOW_HASHED`` wire (the receiver re-finalizes to the
bit-identical hash — splitmix64 is a bijection), and fragments from
MANY inbound frames coalesce into one wire frame per peer connection
per window (fleet/lanes.py). String rows hash-forward on the same lane
when the receiver is single-shard — decisions and policy overrides key
on the finalized hash, so the answer is bit-identical to the string
arriving directly; a MULTI-shard native receiver routes string frames
by FNV over the raw key bytes, so string rows bound for one (declared
``shards`` > 1 in the fleet map) still forward as strings, pipelined on
the same connection. Same-key send order survives the multi-connection
links via per-key connection affinity (``h64 % conns``).

Bounded-ness: each peer lane bounds outstanding fragments
(``--fleet-forward-queue``) and in-flight wire frames per connection
(``--fleet-forward-inflight``); every forwarded frame carries the fleet
forward deadline (the ADR-015 wire extension — the peer sheds expired
work). Overflow / peer failure degrades exactly the failed wire
frame's member rows per the configured fail-open/fail-closed policy,
and feeds the membership failure classifier.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ratelimiter_tpu_torch.core.errors import (
    NotOwnerError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    BatchResult,
    DispatchTicket,
    batch_fail_open,
    fail_open_result,
)
from ratelimiter_tpu_torch.fleet.config import FleetMap
from ratelimiter_tpu_torch.fleet.lanes import ForwardRuntime, PeerLane
from ratelimiter_tpu_torch.observability import events, tracing
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability.decorators import LimiterDecorator
from ratelimiter_tpu_torch.ops.hashing import (
    hash_prefixed_u64,
    splitmix64,
    splitmix64_inv,
)

log = logging.getLogger("ratelimiter_tpu_torch.fleet")

#: Forward RTT histogram buckets: a LAN hop under load — finer than the
#: dispatch buckets below 1 ms, out to the multi-second failure tail.
FORWARD_RTT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                       2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class LaneMetrics:
    """Per-peer coalescing/occupancy instruments shared by every lane
    of one core (ADR-019 observability)."""

    def __init__(self, reg: m.Registry):
        self._g_rows = reg.gauge(
            "rate_limiter_fleet_forward_window_rows",
            "Rows in the most recent coalesced forward window per peer "
            "(occupancy: how much each wire frame amortizes)")
        self._g_frames = reg.gauge(
            "rate_limiter_fleet_forward_window_frames",
            "Member fragments merged into the most recent coalesced "
            "forward window per peer (depth: how many inbound frames "
            "share one wire round-trip)")
        self._c_frames = reg.counter(
            "rate_limiter_fleet_forward_wire_frames_total",
            "Coalesced wire frames sent to each peer (rows_total / "
            "frames_total = mean window occupancy)")
        self._c_rows = reg.counter(
            "rate_limiter_fleet_forward_wire_rows_total",
            "Rows shipped inside coalesced wire frames per peer")
        self._h_rtt = reg.histogram(
            "rate_limiter_fleet_forward_rtt_seconds",
            "Wire round-trip of one coalesced forward frame (send to "
            "parsed reply)", FORWARD_RTT_BUCKETS)

    def window(self, peer: str, frames: int, rows: int) -> None:
        self._g_rows.set(float(rows), peer=peer)
        self._g_frames.set(float(frames), peer=peer)
        self._c_frames.inc(1, peer=peer)
        self._c_rows.inc(rows, peer=peer)

    def rtt(self, seconds: float) -> None:
        self._h_rtt.observe(seconds)


class FleetCore:
    """One process's fleet state: live map + identity + peer lanes +
    adopted-range unit + metrics. Thread-safe: the map reference swaps
    atomically; routing reads never lock."""

    def __init__(self, fleet_map: FleetMap, self_id: str, *,
                 prefix: str = "", forward: bool = True,
                 forward_deadline: float = 1.0,
                 forward_queue: int = 128,
                 forward_inflight: int = 2,
                 forward_conns: int = 1,
                 forward_coalesce: int = 16384,
                 registry: Optional[m.Registry] = None):
        fleet_map.validate()
        self.self_id = self_id
        self.prefix = prefix
        self.forward_enabled = bool(forward)
        self.forward_deadline = float(forward_deadline)
        self.forward_queue = int(forward_queue)
        self.forward_inflight = max(1, int(forward_inflight))
        self.forward_conns = max(1, int(forward_conns))
        # Bounded by the wire: the coalesced REPLY costs ~24.1 B/row
        # against the 1 MiB MAX_FRAME (the request is cheaper at
        # 12 B/row), so the window may never exceed ~43K rows.
        self.forward_coalesce = max(1, min(int(forward_coalesce), 32768))
        self._lock = threading.Lock()
        self._lanes: Dict[int, PeerLane] = {}
        self._runtime: Optional[ForwardRuntime] = None
        #: Adopted-range standby unit (failover): decisions for adopted
        #: buckets run on this limiter, restored from the dead peer's
        #: snapshot + WAL suffix before it serves (restore-before-rejoin).
        self._adopted_unit = None
        #: origin host id -> tuple of (lo, hi) ranges this host serves on
        #: the standby unit FOR that origin (ADR-018: a rejoining origin
        #: takes exactly these back; the aux snapshot cycle labels its
        #: files with them).
        self._adopted_origins: Dict[str, tuple] = {}
        self._adopted_lock = threading.Lock()
        #: Serializes whole install_adopted calls: failover (membership
        #: thread) and a handoff (its own thread) can race — unguarded,
        #: both read no-unit-mounted and the second assignment silently
        #: dropped the first restored unit and its mask bits.
        self._install_lock = threading.Lock()
        self._adopted_exec: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        #: Failure sink (wired to FleetMembership.note_peer_failure):
        #: classified forward failures count toward peer-death detection.
        self.on_peer_failure = None
        #: Placement load slab (ADR-023): attached by the server binary
        #: for fleet members. owners_of_hash notes every routed row's
        #: bucket into it — observation only, decisions untouched.
        self.load_slab = None
        reg = registry if registry is not None else m.DEFAULT
        self._lane_metrics = LaneMetrics(reg)
        self._g_epoch = reg.gauge(
            "rate_limiter_fleet_epoch",
            "Current fleet ownership-map epoch (bumps on failover)")
        self._g_owned = reg.gauge(
            "rate_limiter_fleet_owned_buckets",
            "Hash buckets this host owns under the current map")
        self._g_adopted = reg.gauge(
            "rate_limiter_fleet_adopted_buckets",
            "Owned buckets served by the adopted-range standby unit "
            "(nonzero only after a failover adoption)")
        self._c_forwarded = reg.counter(
            "rate_limiter_fleet_forwarded_decisions_total",
            "Decisions submitted to their owning host because they "
            "arrived mis-routed (ADR-017 server-side forwarding; "
            "counted at submit — a later lane failure degrades the "
            "rows AND counts them in forward_errors/degraded)")
        self._c_forward_errors = reg.counter(
            "rate_limiter_fleet_forward_errors_total",
            "Forward jobs that failed (peer dead/slow/queue-full); "
            "their rows answered per fail-open/closed policy")
        self._c_redirects = reg.counter(
            "rate_limiter_fleet_redirects_total",
            "Frames answered with the E_NOT_OWNER typed redirect "
            "instead of forwarding")
        self._c_degraded = reg.counter(
            "rate_limiter_fleet_degraded_decisions_total",
            "Decisions answered per fail-open/closed policy because "
            "their owner was unreachable")
        # Buckets whose ownership maps to a dead host mid-failover are
        # recorded here by the membership so routing can degrade fast
        # instead of timing out per frame.
        self._dead_ordinals: frozenset = frozenset()
        self._closed = False
        self._install(fleet_map, adopted_buckets=None)

    # ------------------------------------------------------------- state

    def _install(self, fleet_map: FleetMap,
                 adopted_buckets: Optional[np.ndarray]) -> None:
        """Swap in a new map (and adopted-bucket mask) atomically."""
        self_ord = fleet_map.ordinal(self.self_id)
        adopted = (adopted_buckets if adopted_buckets is not None
                   else np.zeros(fleet_map.buckets, dtype=bool))
        with self._lock:
            prev_epoch = getattr(self, "map", None)
            prev_epoch = prev_epoch.epoch if prev_epoch is not None else None
            self.map = fleet_map
            self.self_ordinal = self_ord
            self._adopted_buckets = adopted
        self._g_epoch.set(float(fleet_map.epoch))
        self._g_owned.set(float(fleet_map.owned_buckets(self.self_id)))
        self._g_adopted.set(float(int(adopted.sum())))
        if prev_epoch is not None and fleet_map.epoch != prev_epoch:
            # Control-plane journal (ADR-021): every ownership-map
            # install with a new epoch, whoever minted it.
            events.emit(
                "epoch", "install", actor=self.self_id,
                payload={
                    "epoch": fleet_map.epoch, "from_epoch": prev_epoch,
                    "owned_buckets": int(
                        fleet_map.owned_buckets(self.self_id)),
                    "adopted_buckets": int(adopted.sum()),
                    "assigns": {h.id: [list(r) for r in h.ranges]
                                for h in fleet_map.hosts}})

    def swap_map(self, new_map: FleetMap,
                 adopted_buckets: Optional[np.ndarray] = None) -> None:
        if adopted_buckets is None:
            # Preserve the existing mask where sizes agree (a map update
            # that doesn't change adoption).
            adopted_buckets = self._adopted_buckets
            if adopted_buckets.shape[0] != new_map.buckets:
                adopted_buckets = None
        self._install(new_map, adopted_buckets)

    def install_adopted(self, unit, ranges: Sequence,
                        origin: Optional[str] = None) -> None:
        """Mount the failover standby unit for ``ranges`` (list of
        (lo, hi) bucket ranges). The unit must already be restored
        (restore-before-rejoin); routing flips to it atomically.

        A SECOND adoption while a unit is already mounted (a migration
        or a second failover landing on the same successor) folds the
        new unit's state into the mounted one by conservative union
        (parallel/reshard.py, ADR-018): the two populations are
        disjoint key ranges, so estimates stay >= each origin's own —
        never an over-admit. The fold runs on the adopted executor so
        it serializes with in-flight adopted decides; whole installs
        serialize on ``_install_lock`` (failover and handoff threads
        can race), and the mask update ORs into the CURRENT mask under
        the map lock so concurrent moves never lose each other's
        buckets. Prefer :meth:`install_and_swap` when a map swap
        follows — it holds the install lock across BOTH, so a racing
        reconcile can never strip the just-mounted bits in the gap."""
        with self._install_lock:
            self._install_adopted_locked(unit, ranges, origin)

    def install_and_swap(self, unit, ranges: Sequence,
                         new_map: FleetMap,
                         origin: Optional[str] = None) -> None:
        """Mount the restored unit and install the new map as ONE
        atomic step w.r.t. mask reconciliation: between a bare
        install_adopted and the swap, the buckets still belong to the
        giver under the CURRENT map, so an unrelated higher-epoch
        announce running sync_adopted_with_map would strip the
        pre-mounted bits (and release the origin) before the flip."""
        with self._install_lock:
            if unit is not None:
                self._install_adopted_locked(unit, ranges, origin)
            self.swap_map(new_map)

    def _install_adopted_locked(self, unit, ranges: Sequence,
                                origin: Optional[str]) -> None:
        """Body of install_adopted; ``_install_lock`` must be held."""
        with self._adopted_lock:
            if self._adopted_exec is None:
                # Single worker: adopted-range decides stay FIFO
                # (per-key order), mirroring every other dispatch unit.
                self._adopted_exec = (
                    concurrent.futures.ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix="rl-fleet-adopted"))
            existing = self._adopted_unit
        if existing is None or existing is unit:
            with self._adopted_lock:
                self._adopted_unit = unit
        else:
            from ratelimiter_tpu_torch.parallel import reshard

            def fold() -> None:
                _, arrays, extra = unit.capture_state()
                reshard.merge_into_limiter(existing, arrays, extra)
                unit.close()

            self.adopted_submit(fold).result()
        if origin is not None:
            self._adopted_origins[origin] = tuple(
                (int(lo), int(hi)) for lo, hi in ranges)
        with self._lock:
            mask = self._adopted_buckets
            if mask.shape[0] != self.map.buckets:
                mask = np.zeros(self.map.buckets, dtype=bool)
            else:
                mask = mask.copy()
            for lo, hi in ranges:
                mask[lo:hi] = True
            self._adopted_buckets = mask
        self._g_adopted.set(float(int(mask.sum())))

    def adopted_origin_ranges(self, origin: str) -> tuple:
        """Ranges this host serves on the standby unit for ``origin``
        (empty tuple when none)."""
        return self._adopted_origins.get(origin, ())

    def sync_adopted_with_map(self) -> List[str]:
        """Reconcile the adopted mask with the CURRENT map: buckets the
        map no longer assigns to this host leave the mask (their new
        owner published a higher epoch — e.g. a rejoined origin took its
        ranges back), and origins whose handed ranges all left are
        released. Returns the released origin ids. Called after every
        map swap; the single-owner-per-epoch invariant makes this pure
        bookkeeping — the epoch bump already moved ownership. Takes
        ``_install_lock`` so it can never interleave with a mid-flight
        install_and_swap (whose mounted bits only become map-owned at
        its swap)."""
        with self._install_lock:
            return self._sync_adopted_locked()

    def _sync_adopted_locked(self) -> List[str]:
        with self._lock:
            mask = self._adopted_buckets
            if not mask.any():
                return []
            mine = self.map.owner_table == self.self_ordinal
            new_mask = mask & mine
            self._adopted_buckets = new_mask
        released = []
        for origin, ranges in list(self._adopted_origins.items()):
            if not any(new_mask[lo:hi].any() for lo, hi in ranges):
                del self._adopted_origins[origin]
                released.append(origin)
        self._g_adopted.set(float(int(new_mask.sum())))
        return released

    def set_dead(self, ordinals: Sequence[int]) -> None:
        """Membership marks unreachable hosts so routing degrades their
        rows immediately instead of paying a connect timeout per frame."""
        self._dead_ordinals = frozenset(int(o) for o in ordinals)

    # ----------------------------------------------------------- routing

    def hash_keys(self, keys: Sequence[str]) -> np.ndarray:
        return hash_prefixed_u64(list(keys), self.prefix)

    def owners_of_hash(self, h64: np.ndarray) -> np.ndarray:
        mp = self.map
        slab = self.load_slab
        if slab is None:
            return mp.owner_of_hash(h64)
        # Placement load accounting (ADR-023) rides the routing lookup:
        # the bucket index is computed here ANYWAY — note it into the
        # slab (two bincount adds) and gather owners from the same
        # vector. Decisions are untouched; with the slab detached this
        # path is byte-identical to owner_of_hash.
        b = mp.bucket_of_hash(h64)
        owners = mp.owner_table[b]
        slab.note(b, owners == self.self_ordinal)
        return owners

    def owners_of_ids(self, ids: np.ndarray) -> np.ndarray:
        return self.owners_of_hash(splitmix64(np.asarray(ids, np.uint64)))

    def all_local(self, owners: np.ndarray) -> bool:
        return bool((owners == self.self_ordinal).all()
                    and not self._adopted_buckets.any())

    def split(self, h64: np.ndarray, owners: np.ndarray):
        """Partition one frame: (local_pos, adopted_pos,
        {foreign_ordinal: pos}) — one stable argsort, contiguous
        position slices, frame order preserved within every group."""
        mine = owners == self.self_ordinal
        if self._adopted_buckets.any():
            adopted_rows = mine & self._adopted_buckets[
                self.map.bucket_of_hash(h64)]
            local_rows = mine & ~adopted_rows
        else:
            adopted_rows = np.zeros(0, dtype=bool)
            local_rows = mine
        local_pos = np.nonzero(local_rows)[0]
        adopted_pos = (np.nonzero(adopted_rows)[0]
                       if adopted_rows.shape[0] else
                       np.zeros(0, dtype=np.int64))
        foreign: Dict[int, np.ndarray] = {}
        if local_pos.shape[0] + adopted_pos.shape[0] < owners.shape[0]:
            fpos = np.nonzero(~mine)[0]
            foreign = {o: fpos[sub] for o, sub in
                       self.map.partition(owners[fpos]).items()}
        return local_pos, adopted_pos, foreign

    def lane(self, ordinal: int) -> PeerLane:
        """The forward lane to one peer (built lazily; rebuilt when a
        map swap moved that ordinal's address)."""
        ln = self._lanes.get(ordinal)
        host = self.map.hosts[ordinal]
        if ln is None or (ln.host, ln.port) != (host.host, host.port):
            with self._lock:
                if self._closed:
                    raise StorageUnavailableError(
                        "fleet core is closed; forwarding unavailable")
                ln = self._lanes.get(ordinal)
                if ln is None or (ln.host, ln.port) != (host.host,
                                                        host.port):
                    if ln is not None:
                        ln.close()
                    if self._runtime is None or not self._runtime.alive:
                        self._runtime = ForwardRuntime()
                    ln = PeerLane(
                        self._runtime, host.host, host.port,
                        label=host.id,
                        deadline=self.forward_deadline,
                        inflight=self.forward_inflight,
                        conns=self.forward_conns,
                        coalesce=self.forward_coalesce,
                        queue_cap=self.forward_queue,
                        metrics=self._lane_metrics)
                    self._lanes[ordinal] = ln
        return ln

    def peer_columnar(self, ordinal: int) -> bool:
        """True when STRING rows may hash-forward to this peer on the
        columnar lane: a single-shard receiver decides a forwarded
        ``splitmix64_inv(h64)`` bit-identically to the direct string
        (decisions and overrides key on the finalized hash). A
        multi-shard native receiver routes string frames by FNV over
        the raw key bytes — hash-routing them would split a key's
        quota across shards — so its entry must declare ``shards`` in
        the fleet map and its string rows forward as strings."""
        return self.map.hosts[ordinal].shards <= 1

    # ------------------------------------------------------- redirecting

    def redirect_error(self, h64_row: int, owner_ordinal: int
                       ) -> NotOwnerError:
        from ratelimiter_tpu_torch.serving import protocol as p

        host = self.map.hosts[owner_ordinal]
        bucket = int(np.uint64(h64_row) % np.uint64(self.map.buckets))
        self._c_redirects.inc()
        return NotOwnerError(
            p.format_not_owner(bucket, f"{host.id}@{host.addr}",
                               self.map.epoch, self.map.buckets),
            owner=host.addr, epoch=self.map.epoch)

    def check_frame_owned(self, h64: np.ndarray) -> None:
        """Redirect-only mode's door check: raises the typed redirect
        when any row is foreign (the whole frame errors, the batch
        error contract)."""
        owners = self.owners_of_hash(h64)
        foreign = owners != self.self_ordinal
        if foreign.any():
            i = int(np.argmax(foreign))
            raise self.redirect_error(int(h64[i]), int(owners[i]))

    # ------------------------------------------------------- forwarding

    def forward_jobs(self, ordinal: int, pos: np.ndarray,
                     h64: np.ndarray, ns: np.ndarray, *,
                     keys_fn=None) -> list:
        """Submit one peer's foreign rows onto its lane, split by
        per-key connection affinity. ``pos`` holds the rows' global
        frame positions; ``h64``/``ns`` are the FULL frame columns.
        Returns ``[(positions, future)]`` — one job per touched
        connection, each future resolving to that job's BatchResult
        (a row-range VIEW of the coalesced reply). Never raises: a
        submit failure (lane closed / queue full) yields a pre-failed
        future so sibling connections' rows still decide."""
        host = self.map.hosts[ordinal]
        self._c_forwarded.inc(int(pos.shape[0]), peer=host.id)
        try:
            lane = self.lane(ordinal)
        except StorageUnavailableError as exc:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.set_exception(exc)
            return [(pos, fut)]
        sub_h = h64[pos]
        sub_ns = ns[pos]
        columnar = keys_fn is None or self.peer_columnar(ordinal)
        if lane.conns == 1:
            groups = [(0, pos, sub_h, sub_ns)]
        else:
            ci = lane.conn_of(sub_h)
            groups = []
            for c in range(lane.conns):
                sel = ci == c
                if sel.any():
                    groups.append((c, pos[sel], sub_h[sel], sub_ns[sel]))
        # Originating frame's trace id (thread-local, set by the
        # batcher around the launch; 0 when tracing is off): rides the
        # fragment so the lane can link it to the coalesced window's
        # wire-level id (ADR-021 cross-host stitching).
        trace = tracing.current() if tracing.RECORDER is not None else 0
        jobs = []
        for conn, g_pos, g_h, g_ns in groups:
            try:
                if columnar:
                    fut = lane.submit_rows(splitmix64_inv(g_h), g_ns,
                                           conn, trace=trace)
                else:
                    keys = keys_fn(g_pos)
                    build, parse = self._string_call(
                        keys, [int(x) for x in g_ns])
                    fut = lane.submit_call(build, parse, conn,
                                           rows=len(keys))
            except StorageUnavailableError as exc:
                fut = concurrent.futures.Future()
                fut.set_exception(exc)
            jobs.append((g_pos, fut))
        return jobs

    def _string_call(self, keys: List[str], ns_list: List[int]):
        """Build/parse pair for the multi-shard string fallback: a
        pipelined T_ALLOW_BATCH whose reply parses COLUMNAR
        (protocol.parse_result_batch_columnar) so scatter_merge stays
        on the numpy path."""
        from ratelimiter_tpu_torch.serving import protocol as p

        dl = self.forward_deadline

        def build(req_id: int) -> bytes:
            # FORWARD_FLAG: the multi-shard receiver's dispatcher also
            # keeps forward windows out of client-frame dispatches.
            return p.with_forward(p.with_deadline(
                p.encode_allow_batch(req_id, keys, ns_list), dl))

        def parse(type_: int, body: bytes):
            if type_ != p.T_RESULT_BATCH:
                raise p.ProtocolError(
                    f"unexpected forward response type {type_}")
            return p.parse_result_batch_columnar(body)

        return build, parse

    @staticmethod
    def _combine_jobs(jobs: list, b: int):
        """Legacy single-future surface over per-connection jobs: one
        job covering the whole fragment passes its future through
        (zero-copy); a multi-connection split scatters back to fragment
        order once every job lands."""
        if len(jobs) == 1 and int(jobs[0][0].shape[0]) == b:
            return jobs[0][1]
        out: concurrent.futures.Future = concurrent.futures.Future()
        lock = threading.Lock()
        state = {"left": len(jobs), "parts": [], "exc": None}

        def _done(pos):
            def cb(f):
                with lock:
                    try:
                        state["parts"].append((pos, f.result()))
                    except BaseException as exc:  # noqa: BLE001
                        if state["exc"] is None:
                            state["exc"] = exc
                    state["left"] -= 1
                    fire = state["left"] == 0
                if not fire:
                    return
                if state["exc"] is not None:
                    out.set_exception(state["exc"])
                else:
                    parts = state["parts"]
                    out.set_result(scatter_merge(
                        b, parts[0][1].limit, parts))
            return cb

        for pos, fut in jobs:
            fut.add_done_callback(_done(pos))
        return out

    def forward_ids(self, ordinal: int, raw_ids: np.ndarray,
                    ns) -> "concurrent.futures.Future":
        """Single-future convenience over :meth:`forward_jobs` for one
        raw-id fragment (tests and ad-hoc callers; the doors submit
        jobs directly)."""
        raw_ids = np.ascontiguousarray(raw_ids, dtype=np.uint64)
        jobs = self.forward_jobs(
            ordinal, np.arange(raw_ids.shape[0]), splitmix64(raw_ids),
            np.asarray(ns, dtype=np.int64))
        return self._combine_jobs(jobs, int(raw_ids.shape[0]))

    def forward_allow_n(self, ordinal: int, key: str,
                        n: int) -> "concurrent.futures.Future":
        """Scalar forward on the key's affinity connection (FIFO with
        its batch rows): keeps the full scalar Result fidelity
        (override limits ride the scalar wire path)."""
        from ratelimiter_tpu_torch.serving import protocol as p

        self._c_forwarded.inc(peer=self.map.hosts[ordinal].id)
        lane = self.lane(ordinal)
        h64 = self.hash_keys([key])
        dl = self.forward_deadline

        def build(req_id: int) -> bytes:
            return p.with_deadline(p.encode_allow_n(req_id, key, int(n)),
                                   dl)

        def parse(type_: int, body: bytes):
            if type_ != p.T_RESULT:
                raise p.ProtocolError(
                    f"unexpected forward response type {type_}")
            return p.parse_result(body)

        return lane.submit_call(build, parse,
                                int(h64[0] % np.uint64(lane.conns)))

    def forward_op(self, ordinal: int, kind: str,
                   key: str) -> "concurrent.futures.Future":
        """Control-plane forward (today: reset) on the key's affinity
        connection so it serializes with that key's decision rows."""
        from ratelimiter_tpu_torch.serving import protocol as p

        if kind != "reset":  # pragma: no cover - programming error
            raise ValueError(f"unknown forward op {kind}")
        lane = self.lane(ordinal)
        h64 = self.hash_keys([key])

        def build(req_id: int) -> bytes:
            return p.encode_reset(req_id, key)

        def parse(type_: int, body: bytes):
            if type_ != p.T_OK:
                raise p.ProtocolError(
                    f"unexpected forward response type {type_}")
            return None

        return lane.submit_call(build, parse,
                                int(h64[0] % np.uint64(lane.conns)))

    def note_forward_failure(self, ordinal: int, exc: BaseException,
                             count: int) -> None:
        host = self.map.hosts[ordinal]
        self._c_forward_errors.inc(peer=host.id)
        self._c_degraded.inc(count)
        cb = self.on_peer_failure
        if cb is not None:
            try:
                cb(host.id, exc)
            except Exception:  # noqa: BLE001 — observability only
                log.exception("fleet on_peer_failure callback failed")

    # ---------------------------------------------------- adopted ranges

    @property
    def adopted_unit(self):
        return self._adopted_unit

    def adopted_submit(self, fn) -> "concurrent.futures.Future":
        with self._adopted_lock:
            ex = self._adopted_exec
        assert ex is not None, "no adopted unit installed"
        return ex.submit(fn)

    def decide_adopted_hashed(self, h64: np.ndarray, ns: np.ndarray
                              ) -> "concurrent.futures.Future":
        unit = self._adopted_unit
        return self.adopted_submit(
            lambda: unit.allow_hashed(h64, ns))

    def decide_adopted_keys(self, keys: List[str], ns
                            ) -> "concurrent.futures.Future":
        unit = self._adopted_unit
        return self.adopted_submit(
            lambda: unit.allow_batch(keys, list(ns)))

    # ----------------------------------------------------------- surface

    def status(self) -> dict:
        """/healthz fleet block (membership adds liveness)."""
        mp = self.map
        me = mp.host(self.self_id)
        with self._lock:  # lane() inserts under the same lock
            lanes = list(self._lanes.values())
        wire_frames = sum(ln.wire_frames for ln in lanes)
        wire_rows = sum(ln.wire_rows for ln in lanes)
        return {
            "self": self.self_id,
            "epoch": mp.epoch,
            "buckets": mp.buckets,
            # Member addresses incl. the declared gateway ports, so
            # offline tools (tools/fleet_trace.py --offline,
            # tools/fleet_status.py --offline) can reach every member
            # from one /healthz read (ADR-021).
            "hosts": {h.id: {"addr": h.addr, "http": h.http}
                      for h in mp.hosts},
            "owned_ranges": [list(r) for r in me.ranges],
            "adopted_buckets": int(self._adopted_buckets.sum()),
            "adopted_origins": {o: [list(r) for r in rs] for o, rs in
                                self._adopted_origins.items()},
            "forwarding": self.forward_enabled,
            "forwarded_total": int(self._c_forwarded.total()),
            "forward_errors_total": int(self._c_forward_errors.total()),
            "redirects_total": int(self._c_redirects.total()),
            "forward_wire_frames_total": wire_frames,
            "forward_wire_rows_total": wire_rows,
            "forward_mean_window_rows": (
                round(wire_rows / wire_frames, 1) if wire_frames else None),
            "forward_inflight_per_conn": self.forward_inflight,
            "forward_conns_per_peer": self.forward_conns,
        }

    def map_payload(self) -> dict:
        return self.map.to_dict()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            lanes = list(self._lanes.values())
            self._lanes.clear()
            runtime = self._runtime
            self._runtime = None
        for ln in lanes:
            ln.close()
        if runtime is not None:
            runtime.stop()
        with self._adopted_lock:
            if self._adopted_exec is not None:
                self._adopted_exec.shutdown(wait=False)
                self._adopted_exec = None
            unit = self._adopted_unit
            self._adopted_unit = None
        if unit is not None:
            try:
                unit.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


def collect_jobs(core: FleetCore, jobs, cfg, now: float):
    """Wait out a fleet ticket's forward/adopted futures: returns
    ``(parts, err)`` where ``parts`` is ``[(positions, result)]`` ready
    for :func:`scatter_merge`. A failed job degrades EXACTLY its rows
    per the fail-open/closed policy — one failed coalesced wire frame
    touches only its member fragments (fail-closed keeps the FIRST
    error to raise after every job is drained — the ADR-013
    non-transactional frame contract: other hosts' quota stands).

    Per-leg completion (ADR-019 residual): legs harvest AS THEY FINISH
    under ONE shared deadline anchored at collect start, not
    sequentially in launch order each with a fresh budget. An
    early-finishing leg surfaces its rows (and releases its lane reply
    buffer reference) immediately even when an earlier-launched leg is
    the slow one, and the whole barrier is bounded by max(leg), never
    sum(timeouts) — the old loop could stall a pipelined completer
    thread for n_legs × deadline behind one wedged peer."""
    parts = []
    err = None
    deadline = time.monotonic() + core.forward_deadline + 2.0
    by_fut = {id(fut): (pos, ordinal) for pos, fut, ordinal in jobs}

    def _harvest(fut) -> None:
        nonlocal err
        pos, ordinal = by_fut[id(fut)]
        k = int(pos.shape[0])
        try:
            out = fut.result(timeout=0)
        except Exception as exc:
            if ordinal is not None:
                core.note_forward_failure(ordinal, exc, k)
            if not cfg.fail_open:
                err = err if err is not None else StorageUnavailableError(
                    f"fleet forward failed ({exc}); rows fail closed "
                    f"per config")
                return
            out = batch_fail_open(k, cfg.limit, now + float(cfg.window))
        parts.append((pos, out))

    pending = {fut for _, fut, _ in jobs}
    while pending:
        done, pending = concurrent.futures.wait(
            pending, timeout=max(0.0, deadline - time.monotonic()),
            return_when=concurrent.futures.FIRST_COMPLETED)
        for fut in done:
            _harvest(fut)
        if pending and not done:
            # Shared budget exhausted with legs still in flight: fail
            # exactly those rows (fut.result(0) raises TimeoutError).
            for fut in pending:
                _harvest(fut)
            break
    return parts, err


#: One-pass record view of a list of scalar Results (the forwarded-
#: string in-process legs); columnar assembly replaces the former
#: six per-row list comprehensions.
_RESULT_REC = np.dtype([("allowed", "?"), ("remaining", "<i8"),
                        ("retry", "<f8"), ("reset", "<f8"),
                        ("fail_open", "?"), ("limit", "<i8")])


def scatter_merge(b: int, limit: int, parts) -> BatchResult:
    """Scatter per-group results back to frame order: ``parts`` is
    ``[(positions | None, BatchResult | list[Result])]`` (None =
    positions are the whole frame). ``fail_open`` ORs over groups (the
    multi-shard contract, ADR-013); per-row ``limits`` materialize when
    any group carried overrides. Forwarded legs arrive as BatchResult
    row-range VIEWS of the coalesced lane reply (ADR-019) and assemble
    with four vectorized scatters; list[Result] legs collapse to one
    structured-array pass."""
    allowed = np.zeros(b, dtype=bool)
    remaining = np.zeros(b, dtype=np.int64)
    retry = np.zeros(b, dtype=np.float64)
    reset_at = np.zeros(b, dtype=np.float64)
    limits = None
    fail_open = False
    for pos, out in parts:
        sel = slice(None) if pos is None else pos
        if isinstance(out, list):  # forwarded string rows: Result objects
            rec = np.array([(r.allowed, r.remaining, r.retry_after,
                             r.reset_at, r.fail_open, r.limit)
                            for r in out], dtype=_RESULT_REC)
            allowed[sel] = rec["allowed"]
            remaining[sel] = rec["remaining"]
            retry[sel] = rec["retry"]
            reset_at[sel] = rec["reset"]
            fail_open = fail_open or bool(rec["fail_open"].any())
            if (rec["limit"] != limit).any():
                # Keep whatever limit fidelity the leg carried. NOTE:
                # the RESULT_BATCH wire stamps every row with the
                # DEFAULT limit (overridden keys' true limits ride the
                # scalar path only — protocol.py), so forwarded batch
                # rows inherit that documented wire bound; this branch
                # matters for in-process legs and future wire upgrades.
                if limits is None:
                    limits = np.full(b, limit, dtype=np.int64)
                limits[sel] = rec["limit"]
        else:
            allowed[sel] = out.allowed
            remaining[sel] = out.remaining
            retry[sel] = out.retry_after
            reset_at[sel] = out.reset_at
            fail_open = fail_open or out.fail_open
            if getattr(out, "limits", None) is not None:
                if limits is None:
                    limits = np.full(b, limit, dtype=np.int64)
                limits[sel] = out.limits
    return BatchResult(allowed=allowed, limit=limit, remaining=remaining,
                       retry_after=retry, reset_at=reset_at,
                       fail_open=fail_open, limits=limits)


class FleetTicket(DispatchTicket):
    """Composite ticket for one frame split across the fleet: the local
    sub-ticket plus in-flight forward / adopted futures, scattered back
    to frame order at resolve (the cross-HOST sibling of
    MeshDispatchTicket's cross-slice form)."""

    __slots__ = ("local", "local_pos", "jobs")

    def __init__(self, result=None):
        super().__init__(result)
        self.local = None        # (positions | None, inner ticket)
        self.local_pos = None
        self.jobs = ()           # [(positions, future, ordinal|None)]


class FleetForwarder(LimiterDecorator):
    """Asyncio-door fleet decorator: partitions every decision frame by
    keyspace owner — local rows dispatch on the inner limiter, adopted
    rows on the failover standby unit, foreign rows submit onto their
    owner's coalesced forward lane — and reassembles per-frame answers
    in frame order. Wraps the TOP of the serving stack (outside
    persistence: forwarded rows must not consume local quota, and
    decisions are never WAL-logged anyway)."""

    def __init__(self, inner, core: FleetCore):
        super().__init__(inner)
        self.core = core

    @property
    def pipelined(self) -> bool:
        return bool(getattr(self.inner, "pipelined", False))

    # ------------------------------------------------------------ helpers

    def _launch_fleet(self, h64: np.ndarray, ns: np.ndarray, now: float,
                      *, owners: Optional[np.ndarray] = None,
                      keys: Optional[List[str]] = None,
                      raw_ids: Optional[np.ndarray] = None,
                      wire: bool = False) -> FleetTicket:
        core = self.core
        if owners is None:
            owners = core.owners_of_hash(h64)
        if core.all_local(owners):
            # Fast path: the whole frame is ours — one owner check, no
            # split, the inner ticket passes through (wire buffers
            # preserved).
            if raw_ids is not None:
                return self.inner.launch_ids(raw_ids, ns, now=now,
                                             wire=wire)
            return self.inner.launch_hashed(h64, ns, now=now)
        local_pos, adopted_pos, foreign = core.split(h64, owners)
        if foreign and not core.forward_enabled:
            o = next(iter(foreign))
            raise core.redirect_error(int(h64[foreign[o][0]]), o)
        t = FleetTicket()
        t.b = int(h64.shape[0])
        t.limit = self.inner.config.limit
        t.t_sec = now
        jobs = []
        if local_pos.shape[0]:
            if local_pos.shape[0] == t.b:
                sub_h, sub_n = h64, ns
                t.local_pos = None
            else:
                sub_h, sub_n = h64[local_pos], ns[local_pos]
                t.local_pos = local_pos
            if raw_ids is not None:
                ids_sub = (raw_ids if t.local_pos is None
                           else raw_ids[local_pos])
                t.local = self.inner.launch_ids(ids_sub, sub_n, now=now)
            else:
                t.local = self.inner.launch_hashed(sub_h, sub_n, now=now)
        if adopted_pos.shape[0]:
            jobs.append((adopted_pos,
                         core.decide_adopted_hashed(h64[adopted_pos],
                                                    ns[adopted_pos]),
                         None))
        keys_fn = (None if keys is None
                   else (lambda p_: [keys[i] for i in p_]))
        for o, pos in foreign.items():
            if o in core._dead_ordinals:
                # Known-dead owner mid-failover: degrade now rather than
                # pay a connect timeout per frame.
                fut: concurrent.futures.Future = concurrent.futures.Future()
                fut.set_exception(StorageUnavailableError(
                    f"fleet owner {core.map.hosts[o].id} is down "
                    f"(failover pending)"))
                jobs.append((pos, fut, o))
                continue
            for sub_pos, fut in core.forward_jobs(o, pos, h64, ns,
                                                  keys_fn=keys_fn):
                jobs.append((sub_pos, fut, o))
        t.jobs = tuple(jobs)
        return t

    # ----------------------------------------------------------- launch

    def launch_batch(self, keys, ns=None, *, now=None):
        from ratelimiter_tpu_torch.algorithms.base import check_key, check_n

        keys = list(keys)
        for k in keys:
            check_key(k)
        if ns is None:
            ns_arr = np.ones(len(keys), dtype=np.int64)
        else:
            for n in ns:
                check_n(int(n))
            ns_arr = np.asarray(ns, dtype=np.int64)
        t = self.clock.now() if now is None else float(now)
        h64 = self.core.hash_keys(keys)
        # Owners computed ONCE and threaded through (_launch_fleet used
        # to recompute the same table gather per frame).
        owners = self.core.owners_of_hash(h64)
        if self.core.all_local(owners):
            return self.inner.launch_batch(keys, ns, now=now)
        return self._launch_fleet(h64, ns_arr, t, owners=owners,
                                  keys=keys)

    def launch_ids(self, ids, ns=None, *, now=None, wire: bool = False):
        ids = np.asarray(ids, dtype=np.uint64)
        ns_arr = (np.ones(ids.shape[0], dtype=np.int64) if ns is None
                  else np.asarray(ns, dtype=np.int64))
        t = self.clock.now() if now is None else float(now)
        return self._launch_fleet(splitmix64(ids), ns_arr, t,
                                  raw_ids=ids, wire=wire)

    def launch_hashed(self, h64, ns=None, *, now=None):
        h64 = np.asarray(h64, dtype=np.uint64)
        ns_arr = (np.ones(h64.shape[0], dtype=np.int64) if ns is None
                  else np.asarray(ns, dtype=np.int64))
        t = self.clock.now() if now is None else float(now)
        return self._launch_fleet(h64, ns_arr, t)

    # ---------------------------------------------------------- resolve

    def resolve(self, ticket):
        if not isinstance(ticket, FleetTicket):
            return self.inner.resolve(ticket)
        if ticket.result is not None:
            return ticket.result
        parts = []
        err = None
        if ticket.local is not None:
            try:
                parts.append((ticket.local_pos,
                              self.inner.resolve(ticket.local)))
            except Exception as exc:  # finish the forwards regardless
                err = exc
        fparts, ferr = collect_jobs(self.core, ticket.jobs,
                                    self.inner.config, ticket.t_sec)
        parts.extend(fparts)
        err = err if err is not None else ferr
        if err is not None:
            raise err
        res = scatter_merge(ticket.b, ticket.limit, parts)
        ticket.result = res
        return res

    # ------------------------------------------------------ sync surface

    def allow_batch(self, keys, ns=None, *, now=None):
        return self.resolve(self.launch_batch(keys, ns, now=now))

    def allow_ids(self, ids, ns=None, *, now=None):
        return self.resolve(self.launch_ids(ids, ns, now=now))

    def allow_hashed(self, h64, ns=None, *, now=None):
        return self.resolve(self.launch_hashed(h64, ns, now=now))

    def allow_n(self, key, n, *, now=None):
        core = self.core
        h64 = core.hash_keys([key])
        owner = int(core.owners_of_hash(h64)[0])
        if owner == core.self_ordinal:
            if core._adopted_buckets.any() and bool(
                    core._adopted_buckets[
                        int(core.map.bucket_of_hash(h64)[0])]):
                return core.adopted_submit(
                    lambda: core.adopted_unit.allow_n(
                        key, n, now=now)).result()
            return self.inner.allow_n(key, n, now=now)
        if not core.forward_enabled:
            raise core.redirect_error(int(h64[0]), owner)
        t = self.clock.now() if now is None else float(now)
        try:
            fut = core.forward_allow_n(owner, key, n)
            return fut.result(timeout=core.forward_deadline + 2.0)
        except Exception as exc:
            core.note_forward_failure(owner, exc, 1)
            cfg = self.inner.config
            if not cfg.fail_open:
                raise StorageUnavailableError(
                    f"fleet forward failed ({exc}); fails closed per "
                    f"config") from exc
            return fail_open_result(cfg.limit, t + float(cfg.window))

    def reset(self, key: str) -> None:
        """Reset applies locally AND at the owner (a mis-routed reset on
        a non-owner would otherwise be a silent no-op — the same rule as
        shard-routed resets, stretched across hosts)."""
        core = self.core
        h64 = core.hash_keys([key])
        owner = int(core.owners_of_hash(h64)[0])
        if owner == core.self_ordinal:
            if core._adopted_buckets.any() and bool(
                    core._adopted_buckets[
                        int(core.map.bucket_of_hash(h64)[0])]):
                core.adopted_submit(
                    lambda: core.adopted_unit.reset(key)).result()
                return
            self.inner.reset(key)
            return
        if not core.forward_enabled:
            raise core.redirect_error(int(h64[0]), owner)
        core.forward_op(owner, "reset", key).result(
            timeout=core.forward_deadline + 2.0)

    # Policy overrides apply on the LOCAL stack only: fleet-wide
    # distribution is the client's job (FleetClient.set_override hits
    # every member, exactly as set_override_all hits every shard) — a
    # server cannot know whether its peers already heard the same call.
    # The adopted unit mirrors local writes so adopted keys honor
    # overrides set after failover.

    def set_override(self, key, limit=None, *, window_scale=1.0):
        ov = self.inner.set_override(key, limit, window_scale=window_scale)
        unit = self.core.adopted_unit
        if unit is not None:
            self.core.adopted_submit(
                lambda: unit.set_override(
                    key, limit, window_scale=window_scale)).result()
        return ov

    def delete_override(self, key) -> bool:
        existed = self.inner.delete_override(key)
        unit = self.core.adopted_unit
        if unit is not None:
            existed = self.core.adopted_submit(
                lambda: unit.delete_override(key)).result() or existed
        return existed

    def get_override(self, key):
        core = self.core
        unit = core.adopted_unit
        if unit is not None:
            h64 = core.hash_keys([key])
            if bool(core._adopted_buckets[
                    int(core.map.bucket_of_hash(h64)[0])]):
                # Overrides restored from the dead host's WAL live only
                # in the standby unit.
                return core.adopted_submit(
                    lambda: unit.get_override(key)).result()
        return self.inner.get_override(key)

    def close(self) -> None:
        super().close()
        self.core.close()
