"""Fleet control tower: cross-host rollup, trace stitching, event merge
— a port of ``ratelimiter_tpu/fleet/tower.py`` (ADR-021).

A fleet of N server processes is one limiter, but every observability
surface of a member is per-process: without this module an operator
could not follow a forwarded frame across the hop, could not get a
fleet-wide false-deny bound, and could not ask "why did tenant X
tighten" without grepping N hosts. It works in two layers, over plain
dicts only (no device state: the members' payloads are JSON), and every
merge returns what the JAX package's returns for the same payloads:

* **Pure merge functions** (`merge_audit`, `merge_consumers`,
  `merge_slo`, `merge_hierarchy`, `merge_traces`, `merge_events`) over
  plain member payload dicts — the same code path serves the live
  server fan-out AND the offline tools (``python -m
  ratelimiter_tpu_torch.tools.fleet_status`` and ``fleet_trace``), so
  "the endpoint agrees with an offline merge of the members' tallies"
  is true by construction and pinned by unit tests against
  hand-computed merges.
* **:class:`ControlTower`** — the server-side fan-out: any member
  answers ``GET /v1/fleet/status`` / ``/debug/trace?fleet=1`` /
  ``/debug/events?fleet=1`` by pulling every OTHER member's /healthz,
  trace dump, or event page over the HTTP addresses the fleet map
  declares (``FleetHost.http``), merging with its own. Bearer tokens
  pass THROUGH: the caller's ``Authorization`` header is forwarded to
  peers (debug surfaces are assumed fleet-uniformly tokened), so the
  tower never stores a credential. An unreachable member degrades to a
  named gap in the rollup, never a failed request.

Merge correctness rules (the reason this module exists rather than a
dashboard `avg()`):

* **Audit** tallies SUM (requests, oracle allows/denies, false
  denies/allows) and the Wilson bounds RECOMPUTE over the merged
  counts — averaging per-member rates (or worse, their bounds) would
  let an idle member dilute a lying one and has no coverage guarantee.
* **Top-K consumers** merge by their (h1,h2) hash tokens: a consumer's
  mass can land on two members (mis-routed rows decided before
  forwarding existed in its timeline, rebalance windows), so the token
  — stable across hosts by construction (one hash rule fleet-wide) —
  is the join key; masses sum, ranks recompute.
* **SLO burn** evaluates on merged raw window deltas (spans, slow
  spans, decisions, bad decisions — observability/slo.py exports them
  per window) — the fleet burns budget as one service.
* **Hierarchy** gauges aggregate per scope: in-window mass sums
  (tenant mass is fleet-wide mass), effective/ceiling limits take the
  MIN across members (the binding constraint; gossip should converge
  them, so a spread is itself a finding and is reported).
* **Traces and events** align on the membership's estimated per-peer
  CLOCK_MONOTONIC offsets (announce mono stamps - announce RTT/2,
  fleet/membership.py) and land in ONE Perfetto timeline with a
  process lane per host; spans a receiver recorded under a forward
  window's wire-level trace id are rewritten to the client frame's id
  when the sender's (fragment -> window) link names exactly one
  parent, which is what makes "one trace id across the hop" true in
  the merged view.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Dict, List, Optional

from ratelimiter_tpu_torch.evaluation.compare import wilson_interval

log = logging.getLogger("ratelimiter_tpu_torch.fleet.tower")

#: Fan-out fetch timeout: a rollup must answer in interactive time even
#: with a dead member in the map.
FETCH_TIMEOUT_S = 3.0


def fetch_json(url: str, *, bearer: Optional[str] = None,
               timeout: float = FETCH_TIMEOUT_S) -> dict:
    """GET one JSON payload (raises on transport/HTTP/parse failure —
    callers degrade per member)."""
    req = urllib.request.Request(url)
    if bearer:
        req.add_header("Authorization", f"Bearer {bearer}")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


# =====================================================================
#                        pure merge functions
# =====================================================================


def merge_audit(blocks: Dict[str, dict]) -> dict:
    """Sum the members' shadow-audit tallies and recompute the rates +
    Wilson bounds over the MERGED counts. ``blocks`` maps host id to
    the member's /healthz ``audit`` block (raw counts included)."""
    if not blocks:
        return {}
    tot = {k: 0 for k in ("samples", "oracle_allows", "false_denies",
                          "false_allows", "fail_open_samples",
                          "dropped_decisions", "oracle_errors")}
    per_host = {}
    for host, b in blocks.items():
        for k in tot:
            tot[k] += int(b.get(k, 0))
        per_host[host] = {k: int(b.get(k, 0)) for k in tot}
        per_host[host]["sample"] = b.get("sample")
    oracle_denies = tot["samples"] - tot["oracle_allows"]
    fd_lo, fd_hi = wilson_interval(tot["false_denies"],
                                   tot["oracle_allows"])
    fa_lo, fa_hi = wilson_interval(tot["false_allows"],
                                   max(0, oracle_denies))
    return {
        **tot,
        "oracle_denies": max(0, oracle_denies),
        "false_deny_rate": round(
            tot["false_denies"] / max(1, tot["oracle_allows"]), 8),
        "false_deny_wilson95": [round(fd_lo, 8), round(fd_hi, 8)],
        "false_allow_rate": round(
            tot["false_allows"] / max(1, oracle_denies), 10),
        "false_allow_wilson95": [round(fa_lo, 10), round(fa_hi, 10)],
        "per_host": per_host,
    }


def merge_consumers(blocks: Dict[str, dict], k: int = 10) -> dict:
    """Merge the members' top-K consumer analytics BY (h1,h2) TOKEN:
    masses sum per token (one consumer's rows can have landed on two
    members), ranks and shares recompute over the merged mass."""
    if not blocks:
        return {}
    by_token: Dict[str, dict] = {}
    slots = occupied = tracked = 0
    for host, b in blocks.items():
        slots += int(b.get("slots", 0))
        occupied += int(b.get("occupied", 0))
        tracked += int(b.get("tracked_mass", 0))
        for row in b.get("top", ()):
            tok = row.get("consumer")
            if not tok:
                continue
            d = by_token.setdefault(tok, {"consumer": tok,
                                          "in_window": 0, "hosts": {}})
            d["in_window"] += int(row.get("in_window", 0))
            d["hosts"][host] = int(row.get("in_window", 0))
    top = sorted(by_token.values(), key=lambda r: -r["in_window"])[:k]
    for r in top:
        r["share"] = round(r["in_window"] / max(1, tracked), 6)
    return {"slots": slots, "occupied": occupied,
            "tracked_mass": tracked, "top": top}


def merge_slo(blocks: Dict[str, dict]) -> dict:
    """Fleet burn rate from the members' raw per-window deltas: sum
    spans/decisions (good and bad) per window name, recompute the axis
    fractions and burn over the merged counts. The fleet is one
    service; its budget burns on pooled traffic, not on an average of
    ratios."""
    if not blocks:
        return {}
    objective = max(float(b.get("objective", 0.999))
                    for b in blocks.values())
    budget = 1.0 - objective
    windows: Dict[str, dict] = {}
    per_host_burn: Dict[str, dict] = {}
    for host, b in blocks.items():
        for wname, row in (b.get("windows") or {}).items():
            w = windows.setdefault(wname, {"spans": 0, "spans_slow": 0,
                                           "decisions": 0,
                                           "decisions_bad": 0,
                                           "span_s": 0.0})
            w["spans"] += int(row.get("spans", 0))
            w["spans_slow"] += int(row.get("spans_slow", 0))
            w["decisions"] += int(row.get("decisions", 0))
            w["decisions_bad"] += int(row.get("decisions_bad", 0))
            w["span_s"] = max(w["span_s"], float(row.get("span_s", 0.0)))
            per_host_burn.setdefault(wname, {})[host] = row.get(
                "burn_rate")
    out = {}
    for wname, w in windows.items():
        slow_frac = (w["spans_slow"] / w["spans"]) if w["spans"] else 0.0
        bad_frac = (w["decisions_bad"] / w["decisions"]
                    if w["decisions"] else 0.0)
        out[wname] = {
            **w,
            "latency_bad_fraction": round(slow_frac, 6),
            "availability_bad_fraction": round(bad_frac, 6),
            "burn_rate": round(max(slow_frac, bad_frac)
                               / max(budget, 1e-9), 3),
            "per_host_burn": per_host_burn.get(wname, {}),
        }
    return {"objective": objective, "error_budget": round(budget, 6),
            "windows": out}


def merge_hierarchy(blocks: Dict[str, dict]) -> dict:
    """Aggregate the cascade gauges per scope: in-window mass SUMS
    (tenant mass is fleet mass), effective/ceiling limits take the MIN
    across members (the binding constraint). A spread between members'
    effective limits means the gossip has not converged — reported
    per host rather than papered over."""
    if not blocks:
        return {}

    def _scope_merge(rows: Dict[str, dict]) -> dict:
        out = {"in_window": 0, "effective": None, "ceiling": None,
               "per_host_in_window": {}, "per_host_effective": {}}
        for host, r in rows.items():
            out["in_window"] += int(r.get("in_window", 0))
            out["per_host_in_window"][host] = int(r.get("in_window", 0))
            for field in ("effective", "ceiling"):
                v = r.get(field)
                if v is not None:
                    out[field] = (int(v) if out[field] is None
                                  else min(out[field], int(v)))
            if r.get("effective") is not None:
                out["per_host_effective"][host] = int(r["effective"])
            if r.get("weight") is not None:
                out["weight"] = int(r["weight"])
        return out

    tenants: Dict[str, Dict[str, dict]] = {}
    glob: Dict[str, dict] = {}
    controllers = {}
    for host, b in blocks.items():
        if b.get("global"):
            glob[host] = b["global"]
        for name, row in (b.get("tenants") or {}).items():
            tenants.setdefault(name, {})[host] = row
        if b.get("controller"):
            controllers[host] = b["controller"]
    out = {"global": _scope_merge(glob),
           "tenants": {name: _scope_merge(rows)
                       for name, rows in tenants.items()}}
    if controllers:
        out["controllers"] = controllers
    return out


def merged_status(members: Dict[str, Optional[dict]]) -> dict:
    """The /v1/fleet/status body from per-member /healthz payloads
    (None = unreachable member — named, not failed). Every series is
    host-labeled; the accuracy/consumer/SLO/hierarchy blocks merge by
    the rules in the module docstring."""
    reach = {h: b for h, b in members.items() if b is not None}
    hosts = {}
    for h, b in members.items():
        if b is None:
            hosts[h] = {"reachable": False}
            continue
        fleet = b.get("fleet") or {}
        hosts[h] = {
            "reachable": True,
            "serving": b.get("serving"),
            "decisions_total": b.get("decisions_total"),
            "epoch": fleet.get("epoch"),
            "owned_ranges": fleet.get("owned_ranges"),
            "adopted_buckets": fleet.get("adopted_buckets"),
            "forwarded_total": fleet.get("forwarded_total"),
            "forward_errors_total": fleet.get("forward_errors_total"),
            "member": b.get("member"),
        }
    out: dict = {
        "members": len(members),
        "reachable": len(reach),
        "hosts": hosts,
        "decisions_total": sum(int(b.get("decisions_total", 0))
                               for b in reach.values()),
    }
    epochs = {h: d.get("epoch") for h, d in hosts.items()
              if d.get("epoch") is not None}
    out["epoch"] = max(epochs.values()) if epochs else None
    out["epoch_converged"] = len(set(epochs.values())) <= 1
    audit = {h: b["audit"] for h, b in reach.items() if b.get("audit")}
    if audit:
        out["audit"] = merge_audit(audit)
    cons = {h: b["consumers"] for h, b in reach.items()
            if b.get("consumers")}
    if cons:
        out["consumers"] = merge_consumers(cons)
    slo = {h: b["slo"] for h, b in reach.items() if b.get("slo")}
    if slo:
        out["slo"] = merge_slo(slo)
    hier = {h: b["hierarchy"] for h, b in reach.items()
            if b.get("hierarchy")}
    if hier:
        out["hierarchy"] = merge_hierarchy(hier)
    plc = {h: b["placement"] for h, b in reach.items()
           if b.get("placement")}
    if plc:
        from ratelimiter_tpu_torch.placement.accounting import merge_placement

        out["placement"] = merge_placement(plc)
        rebal = {h: b["placement"]["rebalance"] for h, b in reach.items()
                 if isinstance(b.get("placement"), dict)
                 and b["placement"].get("rebalance")}
        if rebal:
            out["placement"]["rebalance"] = rebal
    return out


# ------------------------------------------------------------- tracing


def synthetic_parent_id(parents) -> str:
    """Deterministic synthetic trace id for a forward window that
    coalesced SEVERAL sampled client frames: the truncated digest of the
    sorted parent ids, in the same 16-hex shape as real trace ids. A
    pure function of the parent set — the same coalition always maps to
    the same id regardless of which window carried it or which host
    runs the stitch (the server-side/offline parity pin depends on
    that)."""
    import hashlib

    return hashlib.sha256(
        ",".join(sorted(parents)).encode()).hexdigest()[:16]


def merge_traces(payloads: Dict[str, Optional[dict]],
                 offsets: Dict[str, Optional[int]],
                 ref: str) -> dict:
    """One offset-aligned Perfetto timeline from per-member
    ``chrome_trace()`` payloads: a process lane per host (Perfetto
    renders one track group per pid), every peer's timestamps shifted
    into ``ref``'s CLOCK_MONOTONIC domain by ``offsets[host]``
    (t_ref = t_host + offset; ns), and forward-window spans REWRITTEN
    to their client frame's trace id wherever the sender's
    (fragment -> window) links name exactly one parent — the cross-hop
    stitch. Multi-parent windows rewrite to ``synthetic_parent_id`` of
    their parent set (window id + parents preserved in args). Hosts
    with a None payload (unreachable) or a None offset (no announce
    heard yet; merged unshifted) are reported in ``otherData``."""
    events: List[dict] = []
    links: List[dict] = []
    meta: List[dict] = []
    hosts_meta: Dict[str, dict] = {}
    for pid, (host, payload) in enumerate(sorted(payloads.items())):
        off = offsets.get(host)
        hosts_meta[host] = {
            "pid": pid,
            "reachable": payload is not None,
            "mono_offset_ns": (0 if host == ref else off),
            "aligned": host == ref or off is not None,
        }
        if payload is None:
            continue
        off_us = 0.0 if host == ref else (off or 0) / 1e3
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": host}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "args": {"sort_index": pid}})
        other = payload.get("otherData") or {}
        for tid, tname in (other.get("threads") or {}).items():
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": int(tid), "args": {"name": tname}})
        for ln in other.get("links") or ():
            links.append({**ln, "host": host})
        for e in payload.get("traceEvents", ()):
            e = dict(e)
            e["pid"] = pid
            e["ts"] = e.get("ts", 0.0) + off_us
            e.setdefault("args", {})
            e["args"] = {**e["args"], "host": host}
            events.append(e)
    # Stitch: window id -> the set of client frame ids that shipped
    # fragments into it (sender-side links). A single-parent window's
    # spans rename to the client id — ONE trace id across the hop; a
    # multi-parent window (several sampled frames coalesced into one
    # wire window) renames to a SYNTHETIC parent id derived from the
    # full parent set (keeping the window id would leave the receiver's
    # spans grouped apart from every client frame, so a trace viewer's
    # by-id filter would find neither side). The synthetic id
    # is a pure function of the sorted parents, so every window that
    # coalesced the same client frames lands under the same id, the
    # server-side and offline stitches agree byte-for-byte, and the
    # original window id + the parent list stay in args.
    parents: Dict[str, set] = {}
    for ln in links:
        parents.setdefault(ln["child"], set()).add(ln["parent"])
    for e in events:
        tid = e["args"].get("trace_id")
        ps = parents.get(tid)
        if not ps:
            continue
        e["args"]["window_id"] = tid
        if len(ps) == 1:
            e["args"]["trace_id"] = next(iter(ps))
        else:
            e["args"]["trace_id"] = synthetic_parent_id(ps)
            e["args"]["trace_parents"] = sorted(ps)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": f"CLOCK_MONOTONIC of {ref} (peers offset-aligned)",
            "ref": ref,
            "hosts": hosts_meta,
            "links": links,
        },
    }


# -------------------------------------------------------------- events


def merge_events(member_events: Dict[str, Optional[dict]],
                 offsets: Dict[str, Optional[int]],
                 ref: str, *, limit: int = 512) -> dict:
    """One fleet-wide control-plane timeline from per-member
    /debug/events pages: every event is host-tagged, its monotonic
    stamp aligned into ``ref``'s clock domain (``mono_aligned_ns``)
    when an offset estimate exists, and the merged list sorts on wall
    time (NTP-grade — control-plane events are seconds apart; the
    aligned monotonic stamp is there for joining against the stitched
    span timeline)."""
    merged: List[dict] = []
    hosts = {}
    for host, page in member_events.items():
        off = 0 if host == ref else offsets.get(host)
        hosts[host] = {"reachable": page is not None,
                       "aligned": off is not None}
        if page is None:
            continue
        for e in page.get("events", ()):
            e = {**e, "host": host}
            if off is not None and "mono_ns" in e:
                e["mono_aligned_ns"] = int(e["mono_ns"]) + off
            merged.append(e)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    if len(merged) > limit:
        merged = merged[-limit:]
    return {"enabled": True, "fleet": True, "ref": ref, "hosts": hosts,
            "events": merged}


# =====================================================================
#                       server-side fan-out
# =====================================================================


class ControlTower:
    """One member's fan-out engine behind /v1/fleet/status,
    /debug/trace?fleet=1 and /debug/events?fleet=1. Peers are read over
    the fleet map's declared HTTP gateways; this member's own payloads
    come from local callables (never a self-HTTP hop)."""

    def __init__(self, core, membership, *, self_health,
                 timeout: float = FETCH_TIMEOUT_S):
        self.core = core
        self.membership = membership
        self.self_health = self_health
        self.timeout = float(timeout)

    # ------------------------------------------------------------ peers

    def _peers(self):
        """[(host_id, base_url | None)] for every OTHER member."""
        out = []
        for h in self.core.map.hosts:
            if h.id == self.core.self_id:
                continue
            addr = h.http_addr
            out.append((h.id, f"http://{addr}" if addr else None))
        return out

    def _offsets(self) -> Dict[str, Optional[int]]:
        offs: Dict[str, Optional[int]] = {self.core.self_id: 0}
        for h in self.core.map.hosts:
            if h.id == self.core.self_id:
                continue
            offs[h.id] = (self.membership.peer_clock(h.id)["offset_ns"]
                          if self.membership is not None else None)
        return offs

    def _fetch(self, base: Optional[str], path: str,
               bearer: Optional[str]) -> Optional[dict]:
        if base is None:
            return None
        try:
            return fetch_json(base + path, bearer=bearer,
                              timeout=self.timeout)
        except Exception as exc:  # noqa: BLE001 — a dead member is a
            # named gap in the rollup, never a failed rollup.
            log.debug("fleet tower fetch %s%s failed: %s", base, path,
                      exc)
            return None

    def _fetch_all(self, path: str,
                   bearer: Optional[str]) -> Dict[str, Optional[dict]]:
        """Fetch ``path`` from every peer CONCURRENTLY: the surface is
        bounded by ONE fetch timeout, not peers × timeout — with three
        partitioned members an 8-host rollup must still answer in
        interactive time (the §12 triage contract)."""
        import concurrent.futures

        peers = self._peers()
        if not peers:
            return {}
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(peers)),
                thread_name_prefix="rl-fleet-tower") as ex:
            futs = {hid: ex.submit(self._fetch, base, path, bearer)
                    for hid, base in peers}
            return {hid: f.result() for hid, f in futs.items()}

    # ---------------------------------------------------------- surfaces

    def fleet_status(self) -> dict:
        members: Dict[str, Optional[dict]] = {
            self.core.self_id: self.self_health()}
        members.update(self._fetch_all("/healthz", None))
        out = merged_status(members)
        out["generated_by"] = self.core.self_id
        return out

    def fleet_trace(self, bearer: Optional[str] = None) -> dict:
        from ratelimiter_tpu_torch.observability import tracing

        rec = tracing.RECORDER
        payloads: Dict[str, Optional[dict]] = {
            self.core.self_id: (rec.chrome_trace() if rec is not None
                                else {"traceEvents": [],
                                      "otherData": {}})}
        payloads.update(self._fetch_all("/debug/trace", bearer))
        return merge_traces(payloads, self._offsets(),
                            self.core.self_id)

    def fleet_events(self, *, limit: int = 512,
                     category: Optional[str] = None,
                     bearer: Optional[str] = None) -> dict:
        from urllib.parse import quote

        from ratelimiter_tpu_torch.observability import events as ev

        j = ev.JOURNAL
        pages: Dict[str, Optional[dict]] = {
            self.core.self_id: (j.tail(limit, category=category)
                                if j is not None else {"events": []})}
        q = f"?tail={int(limit)}"
        if category:
            # Percent-encode: a caller's odd category must 400 locally
            # or filter cleanly — never make peers read as unreachable.
            q += f"&category={quote(category, safe='')}"
        pages.update(self._fetch_all("/debug/events" + q, bearer))
        return merge_events(pages, self._offsets(), self.core.self_id,
                            limit=limit)
