"""Fleet status rollup CLI (ADR-021): one merged view of the whole
fleet's observability — merged audit Wilson bounds, fleet-wide top-K
consumers, pooled SLO burn, per-scope hierarchy mass, liveness and
epochs — from any member.

    python -m ratelimiter_tpu_torch.tools.fleet_status http://member:8434
    python -m ratelimiter_tpu_torch.tools.fleet_status URL --json
    python -m ratelimiter_tpu_torch.tools.fleet_status URL --offline

Default mode asks the member to fan out (``GET /v1/fleet/status`` —
the member pulls every peer's /healthz over the fleet map's declared
gateway ports and merges with ``ratelimiter_tpu_torch.fleet.tower``).
``--offline`` pulls each member's /healthz from THIS box and merges
locally with the same code — for when the members cannot reach each
other's gateways. The port's counterpart of the JAX package's
``tools/fleet_status.py``; either speaks to a member of either package.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fail(msg: str) -> None:
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(1)


def rollup_via_member(base: str, timeout: float) -> dict:
    from ratelimiter_tpu_torch.fleet.tower import fetch_json

    return fetch_json(base.rstrip("/") + "/v1/fleet/status",
                      timeout=timeout)


def rollup_offline(base: str, timeout: float) -> dict:
    from ratelimiter_tpu_torch.fleet.tower import fetch_json, merged_status

    base = base.rstrip("/")
    health = fetch_json(base + "/healthz", timeout=timeout)
    fleet = health.get("fleet")
    if not fleet:
        _fail("--offline needs a fleet member (no fleet block on "
              "/healthz)")
    ref = fleet["self"]
    members = {ref: health}
    for peer_id, entry in (fleet.get("hosts") or {}).items():
        if peer_id == ref:
            continue
        http = entry.get("http")
        if not http:
            members[peer_id] = None
            continue
        host = entry.get("addr", "").rsplit(":", 1)[0]
        try:
            members[peer_id] = fetch_json(
                f"http://{host}:{http}/healthz", timeout=timeout)
        except Exception as exc:  # noqa: BLE001 — named gap
            print(f"warning: {peer_id} unreachable ({exc})",
                  file=sys.stderr)
            members[peer_id] = None
    out = merged_status(members)
    out["generated_by"] = f"offline merge via {ref}"
    return out


def _render(st: dict) -> None:
    print(f"fleet: {st.get('reachable')}/{st.get('members')} members "
          f"reachable, epoch {st.get('epoch')}"
          f"{'' if st.get('epoch_converged') else '  [EPOCH SPLIT]'}, "
          f"{st.get('decisions_total'):,} decisions")
    for host, d in sorted((st.get("hosts") or {}).items()):
        if not d.get("reachable"):
            print(f"  {host}: UNREACHABLE")
            continue
        mem = d.get("member") or {}
        print(f"  {host}: epoch={d.get('epoch')} "
              f"decisions={d.get('decisions_total'):,} "
              f"forwarded={d.get('forwarded_total')} "
              f"door={mem.get('door')} backend={mem.get('backend')}")
    audit = st.get("audit")
    if audit:
        lo, hi = audit["false_deny_wilson95"]
        print(f"audit (merged over {audit['samples']:,} samples): "
              f"false-deny {audit['false_deny_rate']:.5f} "
              f"wilson95 [{lo:.5f}, {hi:.5f}], "
              f"false-allow {audit['false_allow_rate']:.2e}")
    slo = st.get("slo")
    if slo:
        for wname, row in sorted(slo.get("windows", {}).items()):
            print(f"slo {wname}: burn {row['burn_rate']} "
                  f"(latency {row['latency_bad_fraction']}, "
                  f"availability {row['availability_bad_fraction']}) "
                  f"per-host {row.get('per_host_burn')}")
    cons = st.get("consumers")
    if cons and cons.get("top"):
        print(f"top consumers (fleet-merged, {cons['tracked_mass']:,} "
              f"tracked mass):")
        for i, row in enumerate(cons["top"][:10], 1):
            print(f"  #{i} {row['consumer']} in_window="
                  f"{row['in_window']:,} share={row['share']} "
                  f"hosts={sorted(row['hosts'])}")
    hier = st.get("hierarchy")
    if hier:
        g = hier.get("global") or {}
        print(f"hierarchy: global in_window={g.get('in_window')} "
              f"effective={g.get('effective')}")
        for name, t in sorted((hier.get("tenants") or {}).items()):
            print(f"  tenant {name}: in_window={t.get('in_window')} "
                  f"effective={t.get('effective')} "
                  f"per-host {t.get('per_host_in_window')}")


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Merged fleet observability rollup (ADR-021)")
    ap.add_argument("gateway", help="any member's HTTP gateway, e.g. "
                                    "http://host:8434")
    ap.add_argument("--offline", action="store_true",
                    help="pull each member's /healthz from this box "
                         "and merge locally (same merge code)")
    ap.add_argument("--json", action="store_true",
                    help="print the full merged JSON instead of the "
                         "summary")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args()
    try:
        st = (rollup_offline(args.gateway, args.timeout) if args.offline
              else rollup_via_member(args.gateway, args.timeout))
    except Exception as exc:  # noqa: BLE001
        _fail(str(exc))
    if args.json:
        json.dump(st, sys.stdout, indent=2)
        print()
    else:
        _render(st)


if __name__ == "__main__":
    main()
