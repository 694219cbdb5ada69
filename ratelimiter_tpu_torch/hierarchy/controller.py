"""AIMD adaptive control over the cascade's effective limits (ADR-020), a
port of ``ratelimiter_tpu/hierarchy/controller.py``.

Closes ROADMAP item 3's control loop: a background thread (never the hot
path) reads the LIVE signals the observatory already produces —

* the SLO burn rate (observability/slo.SloBurnTracker.status): latency /
  availability pressure on the serving door;
* the audit observatory's Wilson-bounded false-deny rate
  (observability/audit.ShadowAuditor.status): how much of the current
  denying is the LIMITER's own error — used as a tighten VETO, since
  tightening amplifies exactly that;
* per-scope in-window mass from the cascade's own counter slab
  (RateLimiter.hierarchy_stats — the same counters the kernel admits
  against, so "pressure" is measured where it is enforced; the hh-backed
  top-K consumer analytics tell the operator WHICH keys carry a hot
  tenant's mass)

— and moves each scope's *effective* limit between its floor and its
configured ceiling:

* **Multiplicative decrease** (``decrease_factor``) when the door is
  burning SLO budget, or when the global scope is saturated AND a tenant
  is hogging it (mass share > ``hot_share`` × its fair weight share —
  the hot-tenant-storm signature). Hot tenants tighten before the global
  scope ever does, so an abusive tenant is squeezed while the others
  keep their headroom. A per-scope cooldown keeps one decision per
  ``cooldown_s`` — AIMD, not free-fall.
* **Additive increase** (``increase_fraction`` of the ceiling per tick)
  back toward the ceiling once pressure clears and the scope's demand
  sits comfortably under its current effective limit
  (``relax_occupancy``).

Publishing rides the existing update machinery: ``set_effective`` on the
limiter (write-all across mesh slices), and an optional ``publish`` hook
the serving tier wires to the fleet announce channel so members converge
on the newest revision (hierarchy/tenants.effective_payload).

Port notes. Every decision (``tick``'s tighten, veto and relax moves,
the cooldowns, ``on_tighten``, ``publish``) is the JAX controller's. The
binary wires ``slo_status`` and ``audit_status`` to the SLO tracker and
the shadow auditor under ``--audit`` (serving/__main__.py
``setup_hierarchy``), as the JAX binary does; without them they stay
None, which gives a burn rate of 0 and a false-deny bound of 0. Each
move and veto is journaled (observability/events.py) under one
correlation id a tick (``tracing.new_trace_id``), as the JAX controller
journals them. The three gauges live in the port's metrics registry.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ratelimiter_tpu_torch.core.config import HIER_UNLIMITED
from ratelimiter_tpu_torch.hierarchy.tenants import GLOBAL
from ratelimiter_tpu_torch.observability import events, tracing

log = logging.getLogger("ratelimiter_tpu_torch.hierarchy")


@dataclass(frozen=True)
class AIMDGains:
    """Controller gains. Defaults are deliberately gentle: one tighten
    halves-ish a scope, recovery takes ~1/increase_fraction ticks."""

    #: Multiplicative decrease applied on tighten.
    decrease_factor: float = 0.7
    #: Additive increase per tick, as a fraction of the scope's ceiling.
    increase_fraction: float = 0.05
    #: SLO burn rate at/above which the door counts as under pressure.
    burn_tighten: float = 2.0
    #: Burn rate at/below which recovery may proceed.
    burn_relax: float = 1.0
    #: Global-scope occupancy (mass / effective limit) that counts as
    #: saturation — the storm trigger when no SLO tracker is wired.
    saturation: float = 0.9
    #: A tenant is "hot" when its share of global mass exceeds
    #: hot_share × its fair weight share.
    hot_share: float = 2.0
    #: Tighten veto: skip tightening while the audited false-deny
    #: Wilson-95 UPPER bound exceeds this (the limiter is already
    #: over-denying; squeezing harder amplifies its own error).
    false_deny_veto: float = 0.05
    #: Scope demand must sit under relax_occupancy × effective before a
    #: relax step (no point raising a limit demand is still slamming).
    relax_occupancy: float = 0.8
    #: Minimum seconds between tightens of one scope.
    cooldown_s: float = 2.0


class AIMDController:
    """Background AIMD loop over one limiter's TenantTable.

    Args:
        limiter: any limiter (or decorator stack) exposing the hierarchy
            surface (hierarchy_stats / set_effective / effective_limits).
        slo_status: optional zero-arg callable returning
            SloBurnTracker.status() (None = no SLO axis; the saturation
            trigger still runs).
        audit_status: optional zero-arg callable returning
            ShadowAuditor.status() (None = no false-deny veto).
        interval: seconds between ticks.
        gains: AIMDGains.
        publish: optional callable(payload dict) invoked after any
            effective-limit change (the fleet propagation seam).
        registry: metrics registry for the controller gauges (None =
            the process default).
    """

    def __init__(self, limiter, *,
                 slo_status: Optional[Callable[[], dict]] = None,
                 audit_status: Optional[Callable[[], dict]] = None,
                 interval: float = 1.0,
                 gains: Optional[AIMDGains] = None,
                 publish: Optional[Callable[[dict], None]] = None,
                 on_tighten: Optional[Callable[[str], None]] = None,
                 registry=None):
        from ratelimiter_tpu_torch.observability import metrics as m

        self.limiter = limiter
        self.slo_status = slo_status
        self.audit_status = audit_status
        self.interval = float(interval)
        self.gains = gains or AIMDGains()
        self.publish = publish
        #: Called with the scope name after each successful tighten —
        #: the lease-revocation seam (ADR-022): leased budget granted
        #: under the old effective limit must not keep spending at the
        #: old rate once the controller squeezes the scope.
        self.on_tighten = on_tighten
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_tighten: Dict[str, float] = {}
        self._last_veto_event = -1e9
        self.ticks = 0
        self.tightened = 0
        self.relaxed = 0
        reg = registry if registry is not None else m.DEFAULT
        self._g_eff = reg.gauge(
            "rate_limiter_hier_effective_limit",
            "Live effective limit per cascade scope (AIMD-controlled)")
        self._g_mass = reg.gauge(
            "rate_limiter_hier_in_window",
            "In-window admitted mass per cascade scope")
        self._c_adj = reg.counter(
            "rate_limiter_hier_adjustments_total",
            "AIMD effective-limit moves by direction")

    # ------------------------------------------------------------ signals

    def _burn(self) -> float:
        if self.slo_status is None:
            return 0.0
        try:
            windows = (self.slo_status() or {}).get("windows") or {}
            if not windows:
                return 0.0
            # The shortest window is the most reactive signal.
            key = min(windows, key=lambda k: float(k.rstrip("s")))
            return float(windows[key].get("burn_rate", 0.0))
        except Exception:  # noqa: BLE001 — a signal, not a dependency
            log.exception("controller: slo_status failed; treating as 0")
            return 0.0

    def _false_deny_hi(self) -> float:
        if self.audit_status is None:
            return 0.0
        try:
            st = self.audit_status() or {}
            return float((st.get("false_deny_wilson95") or [0, 0])[1])
        except Exception:  # noqa: BLE001
            log.exception("controller: audit_status failed; treating as 0")
            return 0.0

    # --------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> Dict[str, int]:
        """One control step; returns {scope: new effective limit} for the
        scopes it moved (exposed for tests and the bench harness)."""
        import time as _time

        g = self.gains
        now = _time.monotonic() if now is None else now
        stats = self.limiter.hierarchy_stats()
        burn = self._burn()
        fd_hi = self._false_deny_hi()
        tenants: Dict[str, dict] = stats["tenants"]
        gstat = stats["global"]
        g_eff = gstat["effective"]
        g_mass = gstat["in_window"]
        self._g_mass.set(float(g_mass), scope=GLOBAL)
        if g_eff < HIER_UNLIMITED:
            self._g_eff.set(float(g_eff), scope=GLOBAL)
        for name, t in tenants.items():
            self._g_mass.set(float(t["in_window"]), scope=name)
            if t["effective"] < HIER_UNLIMITED:
                self._g_eff.set(float(t["effective"]), scope=name)

        pressure = burn >= g.burn_tighten
        saturated = (g_eff < HIER_UNLIMITED
                     and g_mass >= g.saturation * g_eff)
        w_sum = sum(t["weight"] for t in tenants.values()) or 1
        hot = []
        if g_mass > 0:
            for name, t in tenants.items():
                fair = t["weight"] / w_sum
                if t["in_window"] / g_mass > g.hot_share * fair:
                    hot.append(name)

        moved: Dict[str, int] = {}
        # One correlation id per tick + the full triggering-signal
        # snapshot on every journal event (ADR-021): a tighten must be
        # reconstructable from /debug/events ALONE — cause, signals,
        # old/new limits — without grepping N hosts' logs.
        corr = tracing.new_trace_id() if events.JOURNAL is not None else 0
        snapshot = {
            "burn_rate": round(burn, 4),
            "false_deny_wilson_high": round(fd_hi, 6),
            "global_mass": int(g_mass),
            "global_effective": (int(g_eff) if g_eff < HIER_UNLIMITED
                                 else None),
            "saturated": saturated,
            "hot_tenants": list(hot),
        }

        def _tighten(scope: str, eff: int) -> None:
            if eff >= HIER_UNLIMITED:
                # An uncapped scope has no real limit to move: 0.7 x
                # 2^40 would install a meaningless "limit" while the
                # log/counters claim a containment that contains
                # nothing. Cap the scope (give it a ceiling) to make it
                # controllable.
                return
            if now - self._last_tighten.get(scope, -1e9) < g.cooldown_s:
                return
            new = self.limiter.set_effective(
                scope, max(1, int(eff * g.decrease_factor)))
            if new != eff:
                self._last_tighten[scope] = now
                moved[scope] = new
                self.tightened += 1
                self._c_adj.inc(direction="tighten")
                log.warning("controller: tightened %s %d -> %d "
                            "(burn=%.2f saturated=%s hot=%s corr=%016x)",
                            scope, eff, new, burn, saturated, hot, corr)
                events.emit(
                    "controller", "tighten", actor=scope, corr=corr,
                    severity="warning",
                    payload={"old": int(eff), "new": int(new),
                             "cause": ("hot-tenant" if scope in hot
                                       else "slo-pressure"),
                             "in_window": int(
                                 tenants[scope]["in_window"]
                                 if scope in tenants else g_mass),
                             **snapshot})
                if self.on_tighten is not None:
                    try:
                        self.on_tighten(scope)
                    except Exception:  # noqa: BLE001 — best-effort
                        log.exception(
                            "controller: on_tighten hook failed")

        if (pressure or (saturated and hot)) and fd_hi > g.false_deny_veto:
            # Vetoed tighten: the limiter is already over-denying with
            # 95% confidence — journal it (the "why did it NOT act"
            # half of incident reconstruction). Cooldown-bounded like
            # tightens: a veto holding for an hour at a 1 s tick must
            # not flood the bounded ring and evict the incident's own
            # start (handoffs, failovers, the first tighten).
            if now - self._last_veto_event >= g.cooldown_s:
                self._last_veto_event = now
                events.emit("controller", "tighten-vetoed", corr=corr,
                            severity="warning",
                            payload={"veto_threshold": g.false_deny_veto,
                                     **snapshot})
        if (pressure or (saturated and hot)) and fd_hi <= g.false_deny_veto:
            # Hot tenants squeeze first; the global scope only tightens
            # under SLO pressure with no attributable tenant (fair-share
            # clipping already arbitrates honest contention).
            if hot:
                for name in hot:
                    _tighten(name, tenants[name]["effective"])
            elif pressure and g_eff < HIER_UNLIMITED:
                _tighten(GLOBAL, g_eff)
        elif burn <= g.burn_relax:
            # Additive recovery toward each ceiling once demand clears.
            for name, t in tenants.items():
                eff, ceil_ = t["effective"], t["ceiling"]
                if (eff < ceil_
                        and t["in_window"] <= g.relax_occupancy * eff):
                    step = max(1, int(ceil_ * g.increase_fraction))
                    new = self.limiter.set_effective(
                        name, min(ceil_, eff + step))
                    if new != eff:
                        moved[name] = new
                        self.relaxed += 1
                        self._c_adj.inc(direction="relax")
                        events.emit(
                            "controller", "relax", actor=name, corr=corr,
                            payload={"old": int(eff), "new": int(new),
                                     "ceiling": int(ceil_), **snapshot})
            if (g_eff < gstat["ceiling"]
                    and g_mass <= g.relax_occupancy * g_eff):
                step = max(1, int(gstat["ceiling"] * g.increase_fraction))
                new = self.limiter.set_effective(
                    GLOBAL, min(gstat["ceiling"], g_eff + step))
                if new != g_eff:
                    moved[GLOBAL] = new
                    self.relaxed += 1
                    self._c_adj.inc(direction="relax")
                    events.emit(
                        "controller", "relax", actor=GLOBAL, corr=corr,
                        payload={"old": int(g_eff), "new": int(new),
                                 "ceiling": int(gstat["ceiling"]),
                                 **snapshot})

        if moved and self.publish is not None:
            try:
                self.publish(self.limiter.hierarchy_payload())
            except Exception:  # noqa: BLE001 — propagation is best-effort
                log.exception("controller: publish hook failed")
        self.ticks += 1
        return moved

    # ------------------------------------------------------------ thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rl-aimd-controller")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — keep controlling
                log.exception("controller tick failed")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def status(self) -> dict:
        return {"ticks": self.ticks, "tightened": self.tightened,
                "relaxed": self.relaxed, "interval": self.interval,
                "effective": self.limiter.effective_limits()}
