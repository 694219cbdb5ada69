"""RebalanceController: the placement executor — a port of
``ratelimiter_tpu/placement/executor.py`` (ADR-023).

Every ``--rebalance`` member runs the same loop: gather the fleet's
per-bucket decide rates (own slab + peers' ``/healthz`` placement
blocks over the ADR-021 tower fetch), run the deterministic planner,
and execute ONLY the moves this member donates — each range has exactly
one owner, so identically-planning members never collide, and no
leader election is needed. Moves go through the existing
``migrate_ranges`` handoff one at a time, inheriting ADR-018's
never-over-admission and single-owner-per-epoch invariants (and its
chaos behavior: an aborted handoff leaves ownership unchanged; the next
cycle replans from the real map).

Safety discipline (the ADR-020 veto, applied to *placement*):

* before every move the controller reads the observatory — SLO burn
  above ``burn_abort`` or a false-deny Wilson upper bound above
  ``false_deny_veto`` aborts the rest of the plan (journaled, with the
  signal snapshot);
* pacing is AIMD: a veto or failed move MULTIPLIES the inter-cycle
  pace (backoff), every clean move additively recovers toward 1×;
* moved buckets get a min-residency stamp — the planner refuses to
  move them again until the cooldown expires (no flapping);
* any alive-but-unreachable member means the load view is partial: the
  cycle is SKIPPED, never planned on a guess.

One correlation id per plan (= the plan id), carried by every
plan/move/abort/veto event in the journal — ``/debug/events?fleet=1``
reconstructs a rebalance end to end.

The controller touches no device state itself: a move is the member's
``migrate_ranges``, whose receiver builds its standby on the serving
limiter's device (``fleet/handoff.py``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ratelimiter_tpu_torch.observability import events
from ratelimiter_tpu_torch.placement.planner import Plan, PlannerKnobs, plan_moves

log = logging.getLogger("ratelimiter_tpu_torch.placement")


class RebalanceController:
    """Plans and paces load-driven range moves for ONE fleet member."""

    def __init__(self, core, membership, slab, *,
                 interval: float = 10.0,
                 knobs: Optional[PlannerKnobs] = None,
                 seed: int = 0,
                 move_wait: float = 15.0,
                 fetch_peer_health: Optional[Callable[[], Dict[str, Optional[dict]]]] = None,
                 slo_status: Optional[Callable[[], dict]] = None,
                 audit_status: Optional[Callable[[], dict]] = None,
                 burn_abort: float = 2.0,
                 false_deny_veto: float = 0.05,
                 max_pace: float = 16.0,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.core = core
        self.membership = membership
        self.slab = slab
        self.interval = float(interval)
        self.knobs = knobs or PlannerKnobs()
        self.seed = int(seed)
        self.move_wait = float(move_wait)
        self.fetch_peer_health = fetch_peer_health
        self.slo_status = slo_status
        self.audit_status = audit_status
        self.burn_abort = float(burn_abort)
        self.false_deny_veto = float(false_deny_veto)
        self.max_pace = float(max_pace)
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self._hold = False
        self._residency: Dict[int, float] = {}
        self._state = "idle"
        self._last_plan: Optional[dict] = None
        self._last_skip = ""
        self.pace = 1.0
        self.cycles = 0
        self.plans = 0
        self.moves_ok = 0
        self.moves_failed = 0
        self.vetoes = 0
        self.aborts = 0
        self._g_imb = self._g_pace = None
        self._c_plans = self._c_moves = self._c_vetoes = None
        if registry is not None:
            self._g_imb = registry.gauge(
                "rate_limiter_placement_imbalance",
                "Fleet max/mean per-host decision-load imbalance as "
                "seen by this member's planner (1.0 = balanced)")
            self._g_pace = registry.gauge(
                "rate_limiter_placement_pace",
                "Rebalance pacing multiplier (AIMD: vetoes/failures "
                "multiply, clean moves additively recover toward 1)")
            self._c_plans = registry.counter(
                "rate_limiter_placement_plans_total",
                "Placement plans produced, by outcome reason")
            self._c_moves = registry.counter(
                "rate_limiter_placement_moves_total",
                "Range moves this member donated under a placement "
                "plan, by result")
            self._c_vetoes = registry.counter(
                "rate_limiter_placement_vetoes_total",
                "Placement moves vetoed/aborted by the observatory "
                "(SLO burn, false-deny bound) or the operator")
            self._g_imb.set(1.0)
            self._g_pace.set(1.0)

    # ---------------------------------------------------------- signals

    def _burn(self) -> float:
        if self.slo_status is None:
            return 0.0
        try:
            windows = (self.slo_status() or {}).get("windows") or {}
            if not windows:
                return 0.0
            key = min(windows, key=lambda k: float(k.rstrip("s")))
            return float(windows[key].get("burn_rate", 0.0))
        except Exception:  # noqa: BLE001 — a signal, not a dependency
            log.exception("rebalance: slo_status failed; treating as 0")
            return 0.0

    def _false_deny_hi(self) -> float:
        if self.audit_status is None:
            return 0.0
        try:
            st = self.audit_status() or {}
            return float((st.get("false_deny_wilson95") or [0, 0])[1])
        except Exception:  # noqa: BLE001
            log.exception("rebalance: audit_status failed; treating as 0")
            return 0.0

    def _signals(self) -> dict:
        burn = self._burn()
        fd_hi = self._false_deny_hi()
        return {"burn_rate": round(burn, 4),
                "false_deny_wilson_high": round(fd_hi, 6),
                "vetoed": bool(burn >= self.burn_abort
                               or fd_hi > self.false_deny_veto)}

    # ------------------------------------------------------ load gather

    def frozen_now(self) -> set:
        now = self._clock()
        with self._lock:
            expired = [b for b, t in self._residency.items() if t <= now]
            for b in expired:
                del self._residency[b]
            return set(self._residency)

    def _stamp_residency(self, lo: int, hi: int) -> None:
        until = self._clock() + self.knobs.min_residency_s
        with self._lock:
            for b in range(lo, hi):
                self._residency[b] = until

    def gather(self) -> dict:
        """One merged load view: own slab + every peer's ``/healthz``
        placement block. Returns ``{"rate", "alive", "gaps"}`` —
        ``gaps`` non-empty means an ALIVE member's load is unknown and
        the cycle must not plan."""
        fmap = self.core.map
        # This member's own load as its peers read it from /healthz
        # (rounded to 3 decimals there): with the unrounded view the JAX
        # package plans on, the donor's plan id differs from every
        # peer's on a live fleet (ROADMAP C19).
        rate = np.asarray(self.slab.snapshot()["decide_rate"],
                          dtype=np.float64)
        if rate.shape[0] != fmap.buckets:  # pragma: no cover — config
            raise RuntimeError("load slab does not match map buckets")
        alive = {self.core.self_id}
        gaps = []
        peers_alive = {
            hid: st["alive"] for hid, st in
            (self.membership.status()["peers"] if self.membership
             else {}).items()}
        fetched = (self.fetch_peer_health() if self.fetch_peer_health
                   else {})
        for h in fmap.hosts:
            if h.id == self.core.self_id:
                continue
            if not peers_alive.get(h.id, False):
                continue  # dead peers are failover's problem (ADR-017)
            alive.add(h.id)
            blk = (fetched.get(h.id) or {}).get("placement") or {}
            dr = np.asarray(blk.get("decide_rate", ()),
                            dtype=np.float64)
            if dr.shape[0] != fmap.buckets:
                gaps.append(h.id)
                continue
            rate = rate + dr
        return {"rate": rate, "alive": alive, "gaps": gaps}

    # -------------------------------------------------------------- plan

    def dry_run(self) -> dict:
        """Plan from the live view without executing — the operator
        preview (`POST /v1/fleet/rebalance?action=dry-run`)."""
        view = self.gather()
        if view["gaps"]:
            return {"ok": False, "reason": "load-gap",
                    "gaps": view["gaps"]}
        plan = plan_moves(self.core.map, view["rate"],
                          alive=view["alive"],
                          frozen=self.frozen_now(),
                          knobs=self.knobs, seed=self.seed)
        if self._g_imb is not None:
            self._g_imb.set(plan.imbalance_before)
        return {"ok": True, "plan": plan.to_dict(),
                "signals": self._signals()}

    # ----------------------------------------------------------- execute

    def _execute(self, plan: Plan) -> int:
        """Execute this member's donated moves, one handoff at a time,
        veto-checked before each. Returns the number that flipped."""
        mine = [m for m in plan.moves
                if m["from"] == self.core.self_id]
        if not mine:
            return 0
        done = 0
        for mv in mine:
            if self._abort.is_set() or self._stop.is_set():
                self.aborts += 1
                if self._c_vetoes is not None:
                    self._c_vetoes.inc()
                events.emit("placement", "plan-aborted",
                            actor=self.core.self_id, corr=plan.corr,
                            severity="warning",
                            payload={"plan_id": plan.plan_id,
                                     "cause": "operator-abort",
                                     "moves_done": done,
                                     "moves_left": len(mine) - done})
                break
            sig = self._signals()
            if sig["vetoed"]:
                self.vetoes += 1
                if self._c_vetoes is not None:
                    self._c_vetoes.inc()
                self.pace = min(self.max_pace, self.pace * 2.0)
                events.emit("placement", "move-vetoed",
                            actor=self.core.self_id, corr=plan.corr,
                            severity="warning",
                            payload={"plan_id": plan.plan_id,
                                     "move": dict(mv), **sig})
                log.warning(
                    "rebalance: plan %s vetoed before move %s (burn=%s "
                    "fd_hi=%s); pace -> %.2fx", plan.plan_id, mv,
                    sig["burn_rate"], sig["false_deny_wilson_high"],
                    self.pace)
                break
            lo, hi = mv["range"]
            self._state = "moving"
            ok = False
            try:
                ok = self.membership.migrate_ranges(
                    [(int(lo), int(hi))], mv["to"],
                    reason="rebalance", wait=self.move_wait)
            except Exception:  # noqa: BLE001 — a failed move is a
                # journaled fact and a replan, never a dead controller.
                log.exception("rebalance: move %s failed", mv)
            if ok:
                done += 1
                self.moves_ok += 1
                self._stamp_residency(int(lo), int(hi))
                self.pace = max(1.0, self.pace - 0.25)
                if self._c_moves is not None:
                    self._c_moves.inc(result="ok")
                events.emit("placement", "move",
                            actor=self.core.self_id, corr=plan.corr,
                            payload={"plan_id": plan.plan_id,
                                     "move": dict(mv),
                                     "epoch": self.core.map.epoch,
                                     **sig})
            else:
                self.moves_failed += 1
                self.pace = min(self.max_pace, self.pace * 2.0)
                if self._c_moves is not None:
                    self._c_moves.inc(result="failed")
                events.emit("placement", "move-failed",
                            actor=self.core.self_id, corr=plan.corr,
                            severity="warning",
                            payload={"plan_id": plan.plan_id,
                                     "move": dict(mv), **sig})
                # The map may have moved under us (lost a canonical-key
                # race, concurrent failover): replan from reality.
                break
        if self._g_pace is not None:
            self._g_pace.set(self.pace)
        return done

    def run_cycle(self, *, force: bool = False) -> dict:
        """One gather → plan → execute cycle (the background loop body;
        also the operator ``apply``, which sets ``force`` to override a
        hold)."""
        self.cycles += 1
        if self._hold and not force:
            self._state = "held"
            return {"ok": True, "state": "held"}
        self._abort.clear()
        self._state = "planning"
        view = self.gather()
        if view["gaps"]:
            self._state = "idle"
            self._last_skip = f"load-gap:{','.join(view['gaps'])}"
            if self._c_plans is not None:
                self._c_plans.inc(reason="load-gap")
            return {"ok": False, "reason": "load-gap",
                    "gaps": view["gaps"]}
        plan = plan_moves(self.core.map, view["rate"],
                          alive=view["alive"],
                          frozen=self.frozen_now(),
                          knobs=self.knobs, seed=self.seed)
        self._last_skip = ""
        self._last_plan = plan.to_dict()
        if self._g_imb is not None:
            self._g_imb.set(plan.imbalance_before)
        if self._c_plans is not None:
            self._c_plans.inc(reason=plan.reason)
        if not plan.moves:
            self._state = "idle"
            return {"ok": True, "plan": plan.to_dict(), "executed": 0}
        self.plans += 1
        events.emit("placement", "plan", actor=self.core.self_id,
                    corr=plan.corr,
                    payload={"plan_id": plan.plan_id,
                             "reason": plan.reason,
                             "imbalance_before": plan.imbalance_before,
                             "imbalance_projected":
                                 plan.imbalance_projected,
                             "moves": list(plan.moves),
                             **self._signals()})
        log.info("rebalance: plan %s imbalance %.2fx -> %.2fx, "
                 "%d move(s)", plan.plan_id, plan.imbalance_before,
                 plan.imbalance_projected, len(plan.moves))
        executed = self._execute(plan)
        self._state = "idle"
        return {"ok": True, "plan": plan.to_dict(),
                "executed": executed}

    # --------------------------------------------------- operator verbs

    def abort(self) -> dict:
        """Operator abort: stop the in-flight plan between moves AND
        hold automatic planning until the next ``apply``."""
        self._abort.set()
        with self._lock:
            self._hold = True
        self.aborts += 1
        if self._c_vetoes is not None:
            self._c_vetoes.inc()
        events.emit("placement", "abort", actor="operator",
                    severity="warning",
                    payload={"state": self._state})
        return {"ok": True, "held": True}

    def apply(self) -> dict:
        """Operator apply: clear any hold and run one cycle NOW."""
        with self._lock:
            self._hold = False
        return self.run_cycle(force=True)

    # ------------------------------------------------------------ thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rl-rebalance")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval * self.pace):
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 — keep planning
                log.exception("rebalance cycle failed")

    def stop(self) -> None:
        self._stop.set()
        self._abort.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def status(self) -> dict:
        with self._lock:
            hold = self._hold
            frozen = len(self._residency)
        return {
            "state": self._state,
            "held": hold,
            "interval_s": self.interval,
            "pace": round(self.pace, 3),
            "cycles": self.cycles,
            "plans": self.plans,
            "moves_ok": self.moves_ok,
            "moves_failed": self.moves_failed,
            "vetoes": self.vetoes,
            "aborts": self.aborts,
            "frozen_buckets": frozen,
            "last_skip": self._last_skip,
            "last_plan": self._last_plan,
            "knobs": self.knobs.to_dict(),
            "seed": self.seed,
        }
