"""Fleet membership: announce/heartbeat gossip + per-range failover
(ADR-017).

Every fleet member runs one ``FleetMembership``: a background thread
announces this host's view of the ownership map to every peer each
``heartbeat`` seconds (T_DCN_PUSH kind=DCN_KIND_FLEET over the existing
authenticated DCN channel — RLA2 HMAC + replay guard when a secret is
held, ADR-007), and the same thread watches peer liveness:

* an announce from a peer refreshes its ``last_seen`` and, when it
  carries a HIGHER epoch, installs that map (highest epoch wins — the
  fleet's only convergence rule, sufficient because every ownership
  change bumps the epoch exactly once at the host that made it);
* a peer silent past ``dead_after`` (or accumulating
  ``failure_threshold`` quarantine-classified forward failures, the
  ADR-015 classifier) is declared dead;
* if this host is the configured SUCCESSOR for a dead peer's ranges, it
  fails them over: build a standby unit restored from the dead peer's
  newest snapshot + WAL suffix (``adopt_fn`` — restore-before-rejoin,
  the same contract as slice quarantine), mount it for the adopted
  buckets, install the reassigned map at ``epoch + 1``, and announce it
  immediately so routers and peers converge.

Announce reception is PASSIVE for followers: a member that is not the
successor simply learns the new map from the successor's announce (or
keeps forwarding — mis-routed rows stay correct either way, they just
pay a hop).

**Elastic lifecycle (ADR-018).** Beyond failover, the same channel moves
ranges between LIVE hosts with one handoff protocol — live migration
(``migrate_ranges``), graceful departure (``depart``, the rolling-restart
drain), and automatic rejoin give-back (a declared-dead peer announcing
again gets its adopted ranges handed back). Every move follows
capture -> WAL-suffix replay -> flip:

1. the GIVING side snapshots (``snapshot_fn`` — the handoff artifact
   lands in its ``snapshot_dir``, reachable from the receiver) and sends
   an authenticated ``handoff`` frame naming the ranges and carrying the
   PROPOSED map at ``epoch + 1``;
2. the RECEIVING side restores a standby from the artifact + WAL suffix
   (``handoff_restore_fn``), mounts it, installs the proposed map, and
   announces — only the receiver ever publishes ``epoch + 1``, and only
   AFTER its restore: a crash at any point leaves exactly one owner per
   range per epoch (the giver at ``epoch``, or the receiver at
   ``epoch + 1``);
3. the giver learns the flip from the announce; its copy of the moved
   ranges becomes inert (rows forward to the new owner), and adopted
   masks reconcile against the new map (``sync_adopted_with_map``).

Counter loss is bounded by the handoff window (decisions between the
capture and the flip), in the under-counting, fail-toward-allowing
direction; overrides replay exactly from the WAL.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Callable, Dict, Optional

from ratelimiter_tpu_torch.fleet.config import FleetHost, FleetMap
from ratelimiter_tpu_torch.fleet.forwarder import FleetCore
from ratelimiter_tpu_torch.observability import events, tracing
from ratelimiter_tpu_torch.observability import metrics as m

log = logging.getLogger("ratelimiter_tpu_torch.fleet")


class FleetMembership:
    """Announce/heartbeat + liveness + failover for one fleet member.

    Args:
        core: the process's FleetCore (map swaps and adopted-unit
            mounting go through it).
        heartbeat: seconds between announce pushes.
        dead_after: declare a previously-seen peer dead after this many
            seconds of silence.
        boot_grace: never-seen peers can only be declared dead after
            this many seconds from OUR start (default
            ``max(3 * dead_after, 15)``): a fleet starts in arbitrary
            order and a member still prewarming its jit shapes is not
            dead — failing it over at boot would fork its ranges the
            moment it finally serves (rejoin is never automatic).
        failure_threshold: quarantine-classified forward failures
            (FleetCore.on_peer_failure) before a peer is treated as
            dead without waiting out ``dead_after``.
        adopt_fn: ``adopt_fn(dead: FleetHost) -> limiter`` — build the
            standby unit for the dead host's ranges, restored from its
            ``snapshot_dir`` when reachable (wired by the server binary
            to the persistence tier). None disables adoption (ranges
            degrade per policy until an operator acts).
        snapshot_fn: take one snapshot NOW (PersistenceManager
            .snapshot_now) — the capture half of every handoff; None
            means handoffs ship from the newest existing snapshot.
        handoff_restore_fn: ``fn(payload) -> limiter | None`` — build
            the restored standby for an incoming handoff (wired to
            fleet/handoff.build_standby). None adopts handed ranges
            with fresh state (under-counts, fail-toward-allowing).
        on_adopt: ``fn(origin, unit, ranges)`` — a standby unit was
            mounted for ``origin``'s ranges; the binary wires this to
            PersistenceManager.add_aux_unit so adopted state rides this
            host's own snapshot cycle (ADR-018, satellite of ADR-017).
        on_release: ``fn(origin)`` — the origin took its ranges back.
        absorb_fn: ``fn(unit) -> bool`` — fold a handoff unit whose
            ORIGIN IS THIS HOST (a rejoin give-back) into the main
            serving limiter instead of mounting it as an adopted
            standby: the ranges then serve on the full pipelined path
            and ride the normal snapshot files, no aux cycle needed.
            Return False to fall back to the adopted mount. The fold
            is the conservative union (parallel/reshard.py); decisions
            landing between its capture and restore are lost —
            sub-second, under-count only, once per rejoin.
        auto_rejoin: hand a returning (previously declared dead) peer
            its adopted ranges back automatically via the handoff
            protocol. True by default — the zero-operator lifecycle;
            False preserves the ADR-017 manual posture.
        secret: DCN shared secret; announces ride the RLA2 envelope.
    """

    def __init__(self, core: FleetCore, *, heartbeat: float = 0.5,
                 dead_after: float = 2.0, failure_threshold: int = 3,
                 boot_grace: Optional[float] = None,
                 adopt_fn: Optional[Callable[[FleetHost], object]] = None,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 handoff_restore_fn: Optional[Callable] = None,
                 on_adopt: Optional[Callable] = None,
                 on_release: Optional[Callable[[str], None]] = None,
                 absorb_fn: Optional[Callable] = None,
                 auto_rejoin: bool = True,
                 secret: Optional[str] = None,
                 hier_payload_fn: Optional[Callable[[], dict]] = None,
                 hier_apply_fn: Optional[Callable[[dict], bool]] = None,
                 registry: Optional[m.Registry] = None):
        import secrets as _secrets

        self.core = core
        self.heartbeat = float(heartbeat)
        self.dead_after = float(dead_after)
        self.boot_grace = (float(boot_grace) if boot_grace is not None
                           else max(3.0 * self.dead_after, 15.0))
        self.failure_threshold = int(failure_threshold)
        self.adopt_fn = adopt_fn
        self.snapshot_fn = snapshot_fn
        self.handoff_restore_fn = handoff_restore_fn
        self.on_adopt = on_adopt
        self.on_release = on_release
        self.absorb_fn = absorb_fn
        self.auto_rejoin = bool(auto_rejoin)
        self.secret = secret
        #: Hierarchy effective-limit gossip (ADR-020): when set, every
        #: announce carries the local cascade's revision-stamped
        #: effective-limit frame and every received announce offers its
        #: peer's frame to the local table (last-writer-wins on
        #: revision) — the AIMD controller's fleet convergence path.
        self.hier_payload_fn = hier_payload_fn
        self.hier_apply_fn = hier_apply_fn
        self._sender = _secrets.randbits(64)
        self._last_seq = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._last_seen: Dict[str, float] = {}
        self._peer_epoch: Dict[str, int] = {}
        #: Per-peer clock alignment (ADR-021 trace stitching): announce
        #: frames carry the sender's CLOCK_MONOTONIC ns; on receipt we
        #: note delta_in = our_mono - sender_mono (true offset + one-way
        #: delay), and our own announce pushes to that peer measure the
        #: round trip (push waits for the T_OK ack). offset ≈ delta_in -
        #: rtt/2 maps the peer's span/event timestamps into OUR
        #: monotonic domain (t_mine = t_peer + offset) — the NTP
        #: estimate, good to ~rtt/2 (sub-ms on a LAN, exactly the
        #: precision a cross-host Perfetto lane needs). BOTH sides
        #: min-filter over a short window: delay (connect handshakes,
        #: GC pauses, a loaded receive path) only ever INFLATES
        #: delta_in exactly as it inflates RTT — a latest-sample
        #: delta against a min RTT would shift a lane by one slow
        #: announce's full delay.
        self._peer_deltas: Dict[str, list] = {}
        self._peer_rtts: Dict[str, list] = {}
        self._failures: Dict[str, int] = {}
        self._dead: set = set()
        self._started_at = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: Dict[str, object] = {}
        self.failovers = 0
        self.handoffs = 0            # completed incoming handoffs
        self.rejoins = 0             # adopted ranges handed back
        self._rejoin_pending: set = set()
        self._rejoin_inflight: set = set()
        #: origin -> monotonic time of the last give-back attempt; a
        #: flapping origin (the rejoin-storm shape) must not drive one
        #: full snapshot per heartbeat cycle.
        self._rejoin_last: Dict[str, float] = {}
        self.rejoin_backoff = max(2.0 * self.dead_after, 5.0)
        self._handoff_lock = threading.Lock()
        #: Serializes frame pushes: announce_once runs on the
        #: membership thread AND at the end of a handoff (its own
        #: thread); _PeerConn sockets and the seq counter are not
        #: otherwise thread-safe — interleaved sends would corrupt
        #: frames / desync acks / emit out-of-order seqs the replay
        #: guard rejects.
        self._send_lock = threading.Lock()
        reg = registry if registry is not None else m.DEFAULT
        self._g_alive = reg.gauge(
            "rate_limiter_fleet_peer_alive",
            "1 while this fleet peer is considered live (announce heard "
            "within dead_after), 0 once declared dead")
        self._c_failovers = reg.counter(
            "rate_limiter_fleet_failovers_total",
            "Per-range failovers this host performed as successor")
        self._c_announces = reg.counter(
            "rate_limiter_fleet_announces_total",
            "Fleet announce frames sent (ok) / failed, by outcome")
        self._c_handoffs = reg.counter(
            "rate_limiter_fleet_handoffs_total",
            "Range handoffs (live migration / departure / rejoin "
            "give-back), by role (send/receive) and reason")
        self._c_rejoins = reg.counter(
            "rate_limiter_fleet_rejoins_total",
            "Adopted ranges handed back to a returning origin host")
        core.on_peer_failure = self.note_peer_failure

    # ---------------------------------------------------------- announce

    def _next_seq(self) -> int:
        # Wall-clock-tracking monotonic sequence, same contract as
        # DcnPusher._next_seq (the replay guard reads seq as a coarse
        # timestamp for first-contact freshness).
        self._last_seq = max(self._last_seq + 1, int(time.time() * 1e6))
        return self._last_seq

    def announce_payload(self) -> dict:
        out = {"kind": "announce", "from": self.core.self_id,
               "map": self.core.map_payload(),
               "sent_at": time.time(),
               # Sender's span clock (CLOCK_MONOTONIC ns, the ADR-014
               # domain): receivers estimate the cross-host clock
               # offset from it (see _peer_delta_in above).
               "mono_ns": time.monotonic_ns()}
        if self.hier_payload_fn is not None:
            try:
                out["hier"] = self.hier_payload_fn()
            except Exception:  # noqa: BLE001 — gossip rides best-effort
                log.exception("fleet: hierarchy payload hook failed")
        return out

    def _push_frame(self, host: FleetHost, payload: dict) -> None:
        """Encode + push one DCN fleet frame to ``host`` (raises on
        delivery failure). Serialized on ``_send_lock``: the heartbeat
        thread and a handoff thread share the peer connections and the
        monotonic seq."""
        from ratelimiter_tpu_torch.serving import protocol as p
        from ratelimiter_tpu_torch.serving.dcn_peer import _PeerConn

        with self._send_lock:
            req_id = next(self._ids)
            if payload.get("kind") == "announce":
                # Re-stamp the span clock PER PUSH (the shared payload
                # was built before earlier peers' round trips): the
                # offset estimate's one-way-delay term must be this
                # push's, not the announce cycle's.
                payload = {**payload, "mono_ns": time.monotonic_ns()}
            frame = p.encode_dcn_fleet(
                req_id, payload, secret=self.secret, sender=self._sender,
                seq=(self._next_seq() if self.secret is not None
                     else None))
            conn = self._conns.get(host.id)
            if conn is None or (conn.host, conn.port) != (host.host,
                                                          host.port):
                conn = _PeerConn(host.host, host.port, timeout=2.0)
                self._conns[host.id] = conn
            t0 = time.monotonic_ns()
            conn.push(frame, req_id)
            rtt = time.monotonic_ns() - t0
        # Round trip of push -> T_OK ack: the one-way-delay estimate in
        # the peer clock offset. Keep a short window and use its MIN
        # (first-connect handshakes and GC pauses only ever inflate).
        with self._lock:
            rtts = self._peer_rtts.setdefault(host.id, [])
            rtts.append(rtt)
            del rtts[:-8]

    def announce_once(self) -> int:
        """Push one announce to every peer; returns deliveries. Never
        raises — a dead peer's connection failure is exactly the signal
        the OTHER side's monitor consumes."""
        payload = self.announce_payload()
        delivered = 0
        for host in self.core.map.hosts:
            if host.id == self.core.self_id:
                continue
            with self._lock:
                if host.id in self._dead:
                    continue
            try:
                self._push_frame(host, payload)
                delivered += 1
                self._c_announces.inc(outcome="ok")
            except Exception as exc:  # noqa: BLE001 — liveness signal
                self._c_announces.inc(outcome="error")
                log.debug("fleet announce to %s (%s) failed: %s",
                          host.id, host.addr, exc)
        return delivered

    def handle_announce(self, payload: dict) -> None:
        """Receive path (both doors funnel DCN_KIND_FLEET here via
        dcn_peer.merge_push_payload's on_fleet hook). Dispatches on the
        payload ``kind``: ``announce`` (liveness + map gossip) or
        ``handoff`` (an ownership move addressed to this host,
        ADR-018)."""
        if payload.get("kind") == "handoff":
            # Off the receive path: a standby restore can take seconds
            # (snapshot load + jit); the door must keep serving. The
            # per-membership handoff lock serializes concurrent moves.
            threading.Thread(target=self._handle_handoff,
                             args=(payload,), daemon=True,
                             name="rl-fleet-handoff").start()
            return
        peer = str(payload.get("from", ""))
        if not peer or peer == self.core.self_id:
            return
        map_d = payload.get("map") or {}
        epoch = int(map_d.get("epoch", 0))
        mono = payload.get("mono_ns")
        with self._lock:
            self._last_seen[peer] = time.monotonic()
            self._peer_epoch[peer] = epoch
            self._failures[peer] = 0
            if mono is not None:
                # Offset raw material: our mono at receipt minus the
                # peer's mono at send (= true offset + one-way delay;
                # the delay half subtracts out in peer_clock()).
                # Min-filtered like the RTTs — see _peer_deltas above.
                deltas = self._peer_deltas.setdefault(peer, [])
                deltas.append(time.monotonic_ns() - int(mono))
                del deltas[:-8]
            was_dead = peer in self._dead
            if was_dead:
                # A declared-dead peer announcing again is back AS A
                # MEMBER (liveness); its ranges stay wherever the epoch
                # says they are until the HANDOFF protocol moves them —
                # with auto_rejoin, this host (if it adopted the peer's
                # ranges) snapshots the standby and hands them back
                # (restore-before-rejoin on the peer's side); never by
                # the peer simply reappearing (two hosts serving one
                # range would split counters — single owner per epoch,
                # ADR-018).
                self._dead.discard(peer)
        if was_dead:
            events.emit("membership", "peer-returned", actor=peer,
                        payload={"epoch": epoch})
        self._g_alive.set(1.0, peer=peer)
        hier = payload.get("hier")
        if hier and self.hier_apply_fn is not None:
            # Before the steady-state map short-circuit below: effective
            # limits move independently of map epochs (the controller
            # ticks far more often than ownership changes).
            try:
                self.hier_apply_fn(hier)
            except Exception:  # noqa: BLE001 — gossip is best-effort
                log.exception("fleet: hierarchy apply hook failed")
        if was_dead:
            self.core.set_dead([self.core.map.ordinal(p_id)
                                for p_id in self._dead
                                if self._in_map(p_id)])
            if (self.auto_rejoin
                    and self.core.adopted_origin_ranges(peer)):
                # Queue for the membership loop (the receive path must
                # stay cheap; the give-back snapshots + pushes).
                with self._lock:
                    self._rejoin_pending.add(peer)
        cur = self.core.map
        if epoch < cur.epoch:
            return
        if epoch == cur.epoch and map_d == cur.to_dict():
            return  # steady state: same map gossiped back
        try:
            new_map = FleetMap.from_dict(map_d)
        except Exception as exc:  # noqa: BLE001 — bad gossip
            log.warning("fleet announce from %s carried an invalid "
                        "map (%s); ignoring", peer, exc)
            return
        if epoch == cur.epoch:
            # Two uncoordinated movers can mint the SAME epoch
            # concurrently (each proposed cur+1). Without a tiebreak
            # the fleet splits permanently — every member keeps
            # whichever map it heard first. Deterministic rule: the
            # smaller canonical key wins everywhere; the losing
            # mover's flip stays unconfirmed (the ownership check in
            # migrate_ranges) and retries at a higher epoch.
            if new_map.canonical_key() >= cur.canonical_key():
                return
            log.warning("fleet: equal-epoch map conflict at %d; "
                        "adopting the canonical winner from %s",
                        epoch, peer)
        else:
            log.info("fleet: adopting map epoch %d from %s (was %d)",
                     epoch, peer, cur.epoch)
        self.core.swap_map(new_map)
        self._reconcile_adopted()

    def _reconcile_adopted(self) -> None:
        """After any map swap: drop adopted-mask bits the new epoch
        assigns elsewhere and release fully-returned origins (their aux
        snapshots stop; the unit's leftover state is inert)."""
        for origin in self.core.sync_adopted_with_map():
            log.info("fleet: origin %s took its ranges back; released "
                     "the adopted mask for it", origin)
            if self.on_release is not None:
                try:
                    self.on_release(origin)
                except Exception:  # noqa: BLE001 — bookkeeping only
                    log.exception("fleet on_release(%s) failed", origin)

    def _in_map(self, host_id: str) -> bool:
        return any(h.id == host_id for h in self.core.map.hosts)

    # ---------------------------------------------------------- liveness

    def _peer_clock_locked(self, host_id: str) -> dict:
        """``self._lock`` held. The ONE offset estimator (peer_clock
        and status() both render it — server-side and offline stitches
        must agree on alignment): min over the window on BOTH terms,
        since delay only ever inflates delta_in exactly as it inflates
        RTT."""
        deltas = self._peer_deltas.get(host_id, ())
        rtts = self._peer_rtts.get(host_id, ())
        rtt = min(rtts) if rtts else None
        if not deltas:
            return {"offset_ns": None, "rtt_ns": rtt}
        return {"offset_ns": int(min(deltas) - (rtt or 0) // 2),
                "rtt_ns": rtt}

    def peer_clock(self, host_id: str) -> dict:
        """Estimated mapping of ``host_id``'s CLOCK_MONOTONIC domain
        into OURS: ``t_mine ≈ t_peer + offset_ns`` (ADR-021 trace/event
        stitching). ``offset_ns`` is None until the peer's first
        announce lands; ``rtt_ns`` is the min observed announce round
        trip (None until we delivered one)."""
        with self._lock:
            return self._peer_clock_locked(host_id)

    def note_peer_failure(self, host_id: str, exc: BaseException) -> None:
        """Forward-path failure sink (FleetCore.on_peer_failure): only
        quarantine-classified backend faults count toward death — a
        caller error must never fail a healthy peer over (ADR-015)."""
        from ratelimiter_tpu_torch.parallel.quarantine import classify_failure

        if not classify_failure(exc):
            return
        with self._lock:
            self._failures[host_id] = self._failures.get(host_id, 0) + 1

    def _check_dead(self) -> None:
        now = time.monotonic()
        grace_until = self._started_at + self.boot_grace
        newly_dead = []
        with self._lock:
            for host in self.core.map.hosts:
                hid = host.id
                if hid == self.core.self_id or hid in self._dead:
                    continue
                seen = self._last_seen.get(hid)
                silent = (now - seen > self.dead_after if seen is not None
                          else now > grace_until)
                failed = self._failures.get(hid, 0) >= self.failure_threshold
                if silent or failed:
                    self._dead.add(hid)
                    newly_dead.append((host, "silence" if silent
                                       else "forward failures"))
        for host, why in newly_dead:
            self._g_alive.set(0.0, peer=host.id)
            log.warning("fleet peer %s (%s) declared dead (%s)",
                        host.id, host.addr, why)
            events.emit("membership", "peer-dead", actor=host.id,
                        severity="warning",
                        payload={"reason": why, "addr": host.addr})
            self.core.set_dead([self.core.map.ordinal(p_id)
                                for p_id in self._dead
                                if self._in_map(p_id)])
            self._maybe_failover(host)

    # ---------------------------------------------------------- failover

    def _maybe_failover(self, dead: FleetHost) -> None:
        cur = self.core.map.host(dead.id)
        if not cur.ranges:
            return  # already failed over (or never owned anything)
        if cur.successor != self.core.self_id:
            return  # somebody else's job; we learn the map via announce
        log.warning("fleet: failing over %s's ranges %s to %s "
                    "(epoch %d -> %d)", dead.id,
                    [list(r) for r in cur.ranges], self.core.self_id,
                    self.core.map.epoch, self.core.map.epoch + 1)
        unit = None
        if self.adopt_fn is not None:
            try:
                unit = self.adopt_fn(cur)
            except Exception:  # noqa: BLE001 — adopt empty instead
                log.exception("fleet: standby restore for %s failed; "
                              "adopting the range with FRESH state "
                              "(under-counts, fail-toward-allowing)",
                              dead.id)
        new_map = self.core.map.reassign(dead.id, self.core.self_id)
        # Mount + swap atomically w.r.t. mask reconciliation (the mount
        # precedes the swap inside, restore-before-rejoin: the instant
        # the swap makes the buckets local, routing finds the restored
        # unit — a gap would decide adopted keys on empty state).
        self.core.install_and_swap(unit, cur.ranges, new_map,
                                   origin=dead.id)
        if unit is not None:
            self._notify_adopt(dead.id, cur.ranges)
        self.failovers += 1
        self._c_failovers.inc()
        events.emit("failover", "adopt-ranges", actor=dead.id,
                    severity="warning",
                    payload={"successor": self.core.self_id,
                             "ranges": [list(r) for r in cur.ranges],
                             "epoch": new_map.epoch,
                             "restored": unit is not None})
        # Converge fast: don't wait a heartbeat to tell the fleet.
        self.announce_once()

    def _notify_adopt(self, origin: str, ranges) -> None:
        """Fold the (possibly merged) standby unit into this host's own
        snapshot cycle under ``origin``'s name (ADR-018: a second
        failure after adoption must not lose the adopted counters)."""
        if self.on_adopt is None:
            return
        try:
            self.on_adopt(origin, self.core.adopted_unit, ranges)
        except Exception:  # noqa: BLE001 — durability bookkeeping only
            log.exception("fleet on_adopt(%s) failed; adopted state "
                          "will not ride this host's snapshots", origin)

    # ---------------------------------------------------------- handoffs

    def _chaos_phase(self, phase: str) -> None:
        from ratelimiter_tpu_torch import chaos

        if chaos.INJECTOR is not None:
            chaos.INJECTOR.handoff_phase(phase)

    def migrate_ranges(self, ranges, to_id: str, *,
                       reason: str = "migrate",
                       origin: Optional[str] = None,
                       wait: float = 10.0) -> bool:
        """Move owned bucket ``ranges`` to live host ``to_id`` with zero
        downtime: capture (fresh snapshot into our ``snapshot_dir``, the
        handoff artifact) -> send the authenticated handoff frame naming
        the PROPOSED map at epoch+1 -> the receiver restores the ranges'
        state (+ WAL suffix) and is the ONLY side that publishes the
        bump, after its restore. We keep serving the ranges until the
        flip lands (stale routers then get forwarded rows / E_NOT_OWNER
        redirects, the ADR-017 window). Returns True once this host has
        seen the flipped epoch, False on timeout (ownership unchanged —
        the move either fully happened or not at all).

        ``origin`` names whose state travels: None ships this host's
        OWN unit (migration / departure); a host id ships that origin's
        adopted standby (the rejoin give-back) so the returning owner
        restores exactly its ranges from our aux snapshot."""
        cur = self.core.map
        me = cur.host(self.core.self_id)
        ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
        proposed = cur.move_ranges(ranges, self.core.self_id, to_id)
        if proposed.epoch == cur.epoch:   # nothing to move
            return True
        # One correlation id for the whole move: stamped on the send /
        # receive / confirm journal events ON BOTH SIDES (it rides the
        # handoff frame), so an operator can follow one migration
        # across hosts from /debug/events?fleet=1 alone (ADR-021).
        corr = tracing.new_trace_id()
        self._chaos_phase("capture")
        if self.snapshot_fn is not None:
            try:
                self.snapshot_fn()
            except Exception:  # noqa: BLE001 — ship the previous one
                log.exception(
                    "fleet handoff: capture snapshot failed; handing "
                    "off from the newest existing snapshot (counters "
                    "lose up to one interval, fail-toward-allowing)")
        payload = {"kind": "handoff", "from": self.core.self_id,
                   "to": to_id, "reason": reason,
                   "ranges": [list(r) for r in ranges],
                   "map": proposed.to_dict(),
                   "snapshot_dir": me.snapshot_dir,
                   "sent_at": time.time(),
                   "corr": f"{corr:016x}"}
        if origin is not None:
            payload["origin"] = origin
        try:
            self._push_frame(cur.host(to_id), payload)
            self._c_handoffs.inc(role="send", reason=reason)
            events.emit("handoff", "send", actor=to_id, corr=corr,
                        payload={"reason": reason, "origin": origin,
                                 "ranges": [list(r) for r in ranges],
                                 "proposed_epoch": proposed.epoch})
        except Exception as exc:  # noqa: BLE001 — move simply didn't happen
            log.warning("fleet handoff to %s failed to send: %s", to_id,
                        exc)
            self._c_handoffs.inc(role="send_error", reason=reason)
            events.emit("handoff", "send-error", actor=to_id, corr=corr,
                        severity="warning",
                        payload={"reason": reason, "error": str(exc)})
            return False
        # Flip confirmation is OWNERSHIP-level, never epoch-level: a
        # concurrent unrelated bump (a failover elsewhere) also raises
        # the epoch, and epoch >= proposed would falsely confirm a move
        # whose handoff frame the receiver discarded as stale. Only a
        # map that actually assigns the ranges to the receiver counts;
        # an unconfirmed move returns False and the caller retries
        # (re-proposing from the then-current, higher epoch).
        deadline = time.monotonic() + max(0.0, float(wait))
        while True:
            mp = self.core.map
            if mp.epoch > cur.epoch and mp.assigns(ranges, to_id):
                events.emit("handoff", "flip-confirmed", actor=to_id,
                            corr=corr,
                            payload={"reason": reason,
                                     "epoch": mp.epoch})
                return True
            if time.monotonic() >= deadline:
                events.emit("handoff", "flip-timeout", actor=to_id,
                            corr=corr, severity="warning",
                            payload={"reason": reason,
                                     "waited_s": round(float(wait), 3)})
                return False
            time.sleep(0.02)

    def _handle_handoff(self, payload: dict) -> None:
        """Receiver half of a handoff: restore-before-rejoin, then this
        host alone publishes the epoch bump. Any failure (including an
        injected kill) before the final swap leaves the map — and so
        ownership — untouched: the sender still owns the ranges at the
        old epoch."""
        if payload.get("to") != self.core.self_id:
            return
        frm = str(payload.get("from", ""))
        with self._lock:
            if frm:
                self._last_seen[frm] = time.monotonic()
                self._failures[frm] = 0
        with self._handoff_lock:
            self._handle_handoff_locked(payload, frm)

    def _handle_handoff_locked(self, payload: dict, frm: str) -> None:
        try:
            new_map = FleetMap.from_dict(payload.get("map") or {})
        except Exception as exc:  # noqa: BLE001 — bad frame
            log.warning("fleet handoff from %s carried an invalid map "
                        "(%s); ignoring", frm, exc)
            return
        if new_map.epoch <= self.core.map.epoch:
            log.info("fleet handoff from %s is stale (epoch %d <= %d); "
                     "ignoring", frm, new_map.epoch, self.core.map.epoch)
            return
        ranges = tuple((int(lo), int(hi))
                       for lo, hi in payload.get("ranges", []))
        reason = str(payload.get("reason", "migrate"))
        try:
            corr = int(str(payload.get("corr", "") or "0"), 16)
        except ValueError:
            corr = 0
        try:
            self._chaos_phase("restore")
            unit = None
            if self.handoff_restore_fn is not None:
                try:
                    unit = self.handoff_restore_fn(payload)
                except Exception:  # noqa: BLE001 — abort, giver serves on
                    # UNLIKE dead-owner failover, the giver is ALIVE
                    # and still holds the exact counters: flipping to
                    # fresh state here would hand every moved key a
                    # full quota for nothing. Abort before the bump —
                    # ownership stays with the sender, which retries
                    # or keeps serving (single owner throughout).
                    log.exception(
                        "fleet handoff from %s: standby restore failed; "
                        "ABORTING before the epoch bump (the sender "
                        "still owns ranges %s and keeps serving)", frm,
                        [list(r) for r in ranges])
                    self._c_handoffs.inc(role="receive_aborted",
                                         reason=reason)
                    events.emit(
                        "handoff", "receive-aborted", actor=frm,
                        corr=corr, severity="warning",
                        payload={"reason": reason, "phase": "restore",
                                 "ranges": [list(r) for r in ranges]})
                    return
            self._chaos_phase("flip")
            origin = str(payload.get("origin") or frm)
            absorbed = False
            if (unit is not None and origin == self.core.self_id
                    and self.absorb_fn is not None):
                # Rejoin give-back of OUR OWN ranges: fold the unit
                # into the main serving limiter — the ranges then run
                # the full pipelined path and ride the normal snapshot
                # files (no adopted executor, no aux cycle).
                try:
                    absorbed = bool(self.absorb_fn(unit))
                except Exception:  # noqa: BLE001 — adopted fallback
                    log.exception("fleet rejoin absorb failed; "
                                  "mounting as adopted standby instead")
                if absorbed:
                    unit.close()
                    unit = None
            # Mount + swap atomically (mount first inside —
            # restore-before-rejoin, same ordering as failover).
            self.core.install_and_swap(unit, ranges, new_map,
                                       origin=origin)
            if unit is not None:
                self._notify_adopt(origin, ranges)
            self._reconcile_adopted()
        except Exception as exc:  # noqa: BLE001 — abandoned handoff
            # The injected kill / a mid-handoff crash: nothing was
            # published, the sender remains the one owner at the old
            # epoch and retries or keeps serving.
            log.warning("fleet handoff from %s abandoned before the "
                        "flip (%s); ownership unchanged", frm, exc)
            self._c_handoffs.inc(role="receive_aborted", reason=reason)
            events.emit("handoff", "receive-aborted", actor=frm,
                        corr=corr, severity="warning",
                        payload={"reason": reason, "error": str(exc)})
            return
        self.handoffs += 1
        self._c_handoffs.inc(role="receive", reason=reason)
        events.emit("handoff", "receive", actor=frm, corr=corr,
                    payload={"reason": reason,
                             "ranges": [list(r) for r in ranges],
                             "epoch": new_map.epoch,
                             "absorbed": absorbed})
        log.warning("fleet: received %s handoff of %s from %s; now "
                    "serving at epoch %d", reason,
                    [list(r) for r in ranges], frm, new_map.epoch)
        # Converge fast: the sender (and every router) learns the flip
        # from this announce.
        self.announce_once()

    def _maybe_rejoin(self) -> None:
        """Kick give-backs for returning origins (queued by the
        announce path). Each runs on ITS OWN thread: migrate_ranges
        blocks up to its flip wait, and the heartbeat must keep beating
        throughout — a silent gap >= dead_after would make peers
        declare this live host dead mid-rejoin and fork its ranges.
        Retries back off (``rejoin_backoff``) so a flapping origin
        cannot drive one full capture snapshot per heartbeat cycle."""
        now = time.monotonic()
        with self._lock:
            ready = [o for o in self._rejoin_pending
                     if o not in self._rejoin_inflight
                     and now - self._rejoin_last.get(o, 0.0)
                     >= self.rejoin_backoff - 1e-9]
            for o in ready:
                self._rejoin_pending.discard(o)
                self._rejoin_inflight.add(o)
                self._rejoin_last[o] = now
        for origin in ready:
            threading.Thread(target=self._rejoin_one, args=(origin,),
                             daemon=True,
                             name=f"rl-fleet-rejoin-{origin}").start()

    def _rejoin_one(self, origin: str) -> None:
        try:
            ranges = self.core.adopted_origin_ranges(origin)
            if not ranges or not self._in_map(origin):
                return
            log.warning("fleet: %s returned; handing its adopted ranges "
                        "%s back (rejoin)", origin,
                        [list(r) for r in ranges])
            events.emit("handoff", "rejoin-giveback", actor=origin,
                        payload={"ranges": [list(r) for r in ranges]})
            try:
                if self.migrate_ranges(ranges, origin, reason="rejoin",
                                       origin=origin,
                                       wait=max(2.0, 4 * self.heartbeat)):
                    self.rejoins += 1
                    self._c_rejoins.inc()
                else:
                    # Not flipped yet — requeue after the backoff; the
                    # origin may still be prewarming (its next announce
                    # also re-triggers).
                    with self._lock:
                        self._rejoin_pending.add(origin)
            except Exception:  # noqa: BLE001 — retry after backoff
                log.exception("fleet rejoin give-back to %s failed",
                              origin)
                with self._lock:
                    self._rejoin_pending.add(origin)
        finally:
            with self._lock:
                self._rejoin_inflight.discard(origin)

    def depart(self, *, wait: float = 10.0) -> bool:
        """Graceful departure (the rolling-restart drain, ADR-018): hand
        EVERY range this host serves — its own and any adopted — to its
        configured successor (or the first live peer) BEFORE the doors
        close, so a restarting fleet loses no ownership window at all.
        The receiver restores our final snapshot (taken here) + WAL
        suffix and publishes the flip; in-flight routers ride the
        forward/redirect window. Returns True when the flip was
        observed; False leaves ownership with us (the kill -9 failover
        path then covers the restart, exactly as before)."""
        cur = self.core.map
        me = cur.host(self.core.self_id)
        if not me.ranges:
            return True
        with self._lock:
            dead = set(self._dead)
        target = None
        if me.successor and me.successor not in dead:
            target = me.successor
        else:
            for h in cur.hosts:
                if h.id != self.core.self_id and h.id not in dead:
                    target = h.id
                    break
        if target is None:
            log.warning("fleet depart: no live peer to hand ranges to; "
                        "leaving ownership in place (failover covers "
                        "the restart)")
            return False
        ok = self.migrate_ranges(me.ranges, target, reason="depart",
                                 wait=wait)
        if ok:
            log.warning("fleet: departed; %s now owns %s (epoch %d)",
                        target, [list(r) for r in me.ranges],
                        self.core.map.epoch)
        return ok

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.heartbeat):
                try:
                    self.announce_once()
                    self._maybe_rejoin()
                    self._check_dead()
                except Exception:  # noqa: BLE001 — keep the heart beating
                    log.exception("fleet membership cycle failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rl-fleet-membership")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for conn in self._conns.values():
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._conns.clear()

    # ----------------------------------------------------------- surface

    def status(self) -> dict:
        now = time.monotonic()
        with self._lock:
            peers = {}
            for host in self.core.map.hosts:
                if host.id == self.core.self_id:
                    continue
                seen = self._last_seen.get(host.id)
                clk = self._peer_clock_locked(host.id)
                peers[host.id] = {
                    "addr": host.addr,
                    "alive": host.id not in self._dead,
                    "last_seen_age_s": (round(now - seen, 3)
                                        if seen is not None else None),
                    "epoch": self._peer_epoch.get(host.id),
                    "ranges": [list(r) for r in
                               self.core.map.host(host.id).ranges],
                    # Clock alignment (ADR-021): t_mine ≈ t_peer +
                    # offset. Exposed here so OFFLINE stitchers
                    # (tools/fleet_trace.py --offline) can align dumps
                    # without the server-side fan-out.
                    "mono_offset_ns": clk["offset_ns"],
                    "announce_rtt_ms": (round(clk["rtt_ns"] / 1e6, 3)
                                        if clk["rtt_ns"] is not None
                                        else None),
                }
        return {"peers": peers, "failovers": self.failovers,
                "handoffs": self.handoffs, "rejoins": self.rejoins,
                "auto_rejoin": self.auto_rejoin,
                "heartbeat_s": self.heartbeat,
                "dead_after_s": self.dead_after}
