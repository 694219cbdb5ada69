"""Fleet trace stitcher (ADR-021): pull every member's flight-recorder
span rings and emit ONE offset-aligned Perfetto timeline with a process
lane per host — so a forwarded frame's journey (client → host A
io/coalesce → forward lane → host B dispatch/device → reply) reads as
one trace.

Two modes:

* **Server-side stitch** (default): ask one member to do the fan-out —
  ``GET /debug/trace?fleet=1`` merges every member's dump on the
  membership's live clock-offset estimates and rewrites forward-window
  spans to their client frame's trace id where the sender's
  (fragment → window) links allow it.

      python -m ratelimiter_tpu_torch.tools.fleet_trace http://member:8434 \\
          --token $DEBUG_TOKEN -o fleet_trace.json

* **Offline stitch** (``--offline``): pull each member's own
  ``/debug/trace`` + ``/healthz`` (for the peer clock offsets the
  reference member's membership measured) and merge locally with the
  SAME code (``ratelimiter_tpu_torch.fleet.tower.merge_traces``) — for
  when a member cannot reach its peers' gateways but the operator box
  can.

The output loads directly in Perfetto (ui.perfetto.dev) or
chrome://tracing. Each host renders as its own process lane; follow a
``trace_id`` across lanes (forward-window spans carry the original id
plus a ``window_id`` arg after stitching).

The fleet map must declare each member's gateway port (``"http": N``
per host entry); members without one are reported as unreachable lanes.
The port's counterpart of the JAX package's ``tools/fleet_trace.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error


def _fail(msg: str) -> None:
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _summarize(payload: dict) -> None:
    events = [e for e in payload.get("traceEvents", ())
              if e.get("ph") == "X"]
    hosts = payload.get("otherData", {}).get("hosts", {})
    by_host: dict = {}
    traces_per_host: dict = {}
    for e in events:
        host = e.get("args", {}).get("host", "?")
        by_host[host] = by_host.get(host, 0) + 1
        tid = e.get("args", {}).get("trace_id")
        if tid and tid != "0" * 16:
            traces_per_host.setdefault(tid, set()).add(host)
    crossing = sorted(t for t, hs in traces_per_host.items()
                      if len(hs) > 1)
    print(f"hosts: {len(hosts)} "
          f"({sum(1 for h in hosts.values() if h.get('reachable'))} "
          f"reachable, "
          f"{sum(1 for h in hosts.values() if h.get('aligned'))} "
          f"clock-aligned)")
    for host, meta in sorted(hosts.items()):
        off = meta.get("mono_offset_ns")
        print(f"  {host}: pid={meta.get('pid')} "
              f"spans={by_host.get(host, 0)} "
              f"offset={'n/a' if off is None else f'{off / 1e6:+.3f}ms'}"
              f"{'' if meta.get('reachable') else '  [UNREACHABLE]'}")
    print(f"spans: {len(events)}  trace ids crossing hosts: "
          f"{len(crossing)}")
    for t in crossing[:8]:
        print(f"  {t} on {sorted(traces_per_host[t])}")


def stitched_via_member(base: str, token: str, timeout: float) -> dict:
    from ratelimiter_tpu_torch.fleet.tower import fetch_json

    return fetch_json(base.rstrip("/") + "/debug/trace?fleet=1",
                      bearer=token, timeout=timeout)


def stitched_offline(base: str, token: str, timeout: float) -> dict:
    from ratelimiter_tpu_torch.fleet.tower import fetch_json, merge_traces

    base = base.rstrip("/")
    health = fetch_json(base + "/healthz", timeout=timeout)
    fleet = health.get("fleet")
    if not fleet:
        _fail("--offline needs a fleet member (no fleet block on "
              "/healthz)")
    ref = fleet["self"]
    payloads = {ref: fetch_json(base + "/debug/trace", bearer=token,
                                timeout=timeout)}
    offsets: dict = {ref: 0}
    peers = fleet.get("peers") or {}
    for peer_id, entry in (fleet.get("hosts") or {}).items():
        if peer_id == ref:
            continue
        offsets[peer_id] = (peers.get(peer_id) or {}).get(
            "mono_offset_ns")
        http = entry.get("http")
        if not http:
            payloads[peer_id] = None
            continue
        host = entry.get("addr", "").rsplit(":", 1)[0]
        try:
            payloads[peer_id] = fetch_json(
                f"http://{host}:{http}/debug/trace", bearer=token,
                timeout=timeout)
        except Exception as exc:  # noqa: BLE001 — named gap
            print(f"warning: {peer_id} unreachable ({exc})",
                  file=sys.stderr)
            payloads[peer_id] = None
    return merge_traces(payloads, offsets, ref)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Stitch the fleet's flight-recorder rings into one "
                    "Perfetto timeline (ADR-021)")
    ap.add_argument("gateway", help="any member's HTTP gateway, e.g. "
                                    "http://host:8434")
    ap.add_argument("--token", default=None,
                    help="debug bearer token (--debug-token; assumed "
                         "fleet-uniform — it is passed through to "
                         "peers)")
    ap.add_argument("-o", "--out", default="fleet_trace.json",
                    help="output file (Perfetto/Chrome-trace JSON)")
    ap.add_argument("--offline", action="store_true",
                    help="merge locally from each member's own "
                         "/debug/trace instead of asking the member to "
                         "fan out")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args()
    try:
        payload = (stitched_offline(args.gateway, args.token,
                                    args.timeout) if args.offline
                   else stitched_via_member(args.gateway, args.token,
                                            args.timeout))
    except urllib.error.HTTPError as exc:
        _fail(f"{exc} — bad/missing --token, or the member runs "
              f"without --debug-trace/--flight-recorder")
    except Exception as exc:  # noqa: BLE001
        _fail(str(exc))
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    _summarize(payload)
    print(f"wrote {args.out} — open in ui.perfetto.dev")


if __name__ == "__main__":
    main()
