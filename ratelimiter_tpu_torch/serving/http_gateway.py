"""HTTP interop gateway: the reference's flagship usage shape as a
service — a copy of ``ratelimiter_tpu/serving/http_gateway.py`` over the
port's limiters and observability. Every route, status, header, JSON
body and token gate is the JAX gateway's; ``/debug/profile`` captures
with ``torch.profiler`` (a Chrome trace of the CPU and, with a card, its
kernels) where the JAX gateway uses ``jax.profiler``. ``POST
/v1/fleet/migrate`` moves ranges through the fleet membership when the
binary wires its hook and ``--http-migrate-token``; ``/v1/fleet/status``
and ``?fleet=1`` on the debug routes answer through the fleet's control
tower (``fleet/tower.py``) and ``/v1/fleet/rebalance`` through the
placement controller (``placement/executor.py``) when the binary wires
their hooks, and as the JAX gateway does without them.
Unlike the JAX gateway, its connections set TCP_NODELAY (ROADMAP C12),
and it listens with a backlog of ``LISTEN_BACKLOG`` where the JAX
gateway keeps socketserver's 5 (ROADMAP C13: a burst of connects past 5
had its SYNs dropped and retried a second later).

The reference's canonical example is an HTTP handler that consults the
limiter and answers 429 with ``X-RateLimit-Limit`` / ``-Remaining`` /
``-Reset`` and ``Retry-After`` headers (``docs/EXAMPLES.md:44-57``), and
maps backend failure to 503 Service Unavailable. This gateway is that
example as a standalone surface, so plain HTTP clients (curl, sidecars,
anything without the binary protocol) get drop-in rate limiting:

    GET/POST /v1/allow?key=K[&n=N]   -> 200 allowed / 429 denied,
                                        X-RateLimit-* + Retry-After
    POST     /v1/reset?key=K         -> 200 {"ok": true}
    POST     /v1/snapshot            -> 200 {"ok": true, "wal_seq": ...}
                                        (durability trigger; 403 unless
                                        persistence is enabled)
    GET      /v1/policy?key=K        -> 200 override | 404 default tier
    POST/PUT /v1/policy?key=K&limit=N[&window_scale=S]
                                     -> 200 stored override
    DELETE   /v1/policy?key=K        -> 200 {"ok": true, "deleted": ...}
    GET      /healthz                -> 200 {"serving": true, ...}
    GET      /metrics                -> Prometheus text (OpenMetrics with
                                        exemplars when the scraper sends
                                        Accept: application/openmetrics-text)
    GET      /debug/trace            -> recent flight-recorder spans as
                                        Perfetto/Chrome-trace JSON
                                        (ADR-014; bearer-gated like
                                        /v1/policy, off by default)
    GET/POST /debug/profile?seconds=N -> on-demand torch.profiler capture
                                        (same gate; one at a time)
    GET      /debug/audit            -> live accuracy observatory JSON
                                        (ADR-016): false-deny/allow
                                        rates with Wilson bounds, top-K
                                        consumers, SLO burn rate,
                                        dropped-sample counts. Wired
                                        only when auditing is on
                                        (--audit); bearer-gated via
                                        --audit-token

Reset is a quota-erase lever and the policy endpoint is a quota-GRANT
lever, so on a broad plain-HTTP surface both are bypass risks: the
server binary ships them DISABLED (enable with ``--http-reset`` /
``--http-policy``, optionally token-gated with ``--http-reset-token`` /
``--http-policy-token``). Tokens ride ``Authorization: Bearer <t>``
ONLY — never the query string, where they would leak into access logs,
proxies, and browser history. Embedded gateways choose their own
exposure via ``enable_reset``/``reset_token`` and
``enable_policy``/``policy_token`` (docs/OPERATIONS.md "Trust
boundaries").

The key may also ride the ``X-User-ID`` header (the reference example's
convention) when no ``key`` query parameter is given.

Transport-agnostic core: the gateway takes ``decide(key, n) -> Result``
and ``reset(key)`` callables. The server binary wires them to the SAME
micro-batcher as the binary protocol (HTTP and binary traffic coalesce
into shared device dispatches); standalone embedding wires them straight
to a limiter. The gRPC shape of this same surface is checked in at
``api/proto/ratelimiter.proto``.
"""

from __future__ import annotations

import inspect
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from ratelimiter_tpu_torch.core.errors import (
    DeadlineExceededError,
    InvalidConfigError,
    InvalidKeyError,
    InvalidNError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import Result
from ratelimiter_tpu_torch.observability import events as _events
from ratelimiter_tpu_torch.observability import tracing

#: The listen backlog: the native door's (native/server.cpp), so a burst
#: of simultaneous connects is queued instead of dropped.
LISTEN_BACKLOG = 512


class _GatewayHTTPServer(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


def _key_token(key: str) -> str:
    """Irreversible key token for journal payloads (the PII boundary,
    OPERATIONS §6) — the shared ops/hashing.key_token rule, so journal
    key_hash fields join against redacted log lines."""
    from ratelimiter_tpu_torch.ops.hashing import key_token

    return key_token(key)

log = logging.getLogger("ratelimiter_tpu_torch.serving.http")

#: /debug/profile upper bound: an on-demand torch.profiler capture holds
#: a handler thread (and profiler overhead) for its whole duration.
MAX_PROFILE_SECONDS = 30.0


def _accepts_kw(fn, name: str) -> bool:
    """Does this callable accept keyword ``name``? Checked ONCE at
    construction: embeddings wiring plain ``lambda key, n`` callables
    keep working; the in-repo doors opt in."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return any(p.name == name or p.kind is p.VAR_KEYWORD
               for p in sig.parameters.values())


def _accepts_trace(fn) -> bool:
    return _accepts_kw(fn, "trace_id")


def _policy_unsupported(*_a, **_kw):
    raise InvalidConfigError("no policy callables wired to this gateway")


class HttpGateway:
    """Threaded stdlib HTTP front door over decide/reset callables."""

    def __init__(self, decide: Callable[[str, int], Result],
                 reset: Callable[[str], None], *,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics_render: Optional[Callable[[], str]] = None,
                 health: Optional[Callable[[], dict]] = None,
                 enable_reset: bool = True,
                 reset_token: Optional[str] = None,
                 policy_set: Optional[Callable] = None,
                 policy_get: Optional[Callable] = None,
                 policy_delete: Optional[Callable] = None,
                 enable_policy: bool = False,
                 policy_token: Optional[str] = None,
                 snapshot: Optional[Callable[[], dict]] = None,
                 snapshot_token: Optional[str] = None,
                 enable_debug: bool = False,
                 debug_token: Optional[str] = None,
                 audit_status: Optional[Callable[[], dict]] = None,
                 audit_token: Optional[str] = None,
                 tenants: Optional[object] = None,
                 enable_tenants: bool = False,
                 tenants_token: Optional[str] = None,
                 fleet_migrate: Optional[Callable] = None,
                 migrate_token: Optional[str] = None,
                 fleet_status: Optional[Callable[[], dict]] = None,
                 fleet_trace: Optional[Callable] = None,
                 fleet_events: Optional[Callable] = None,
                 fleet_rebalance: Optional[Callable] = None,
                 rebalance_token: Optional[str] = None):
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: an answer is two writes (the headers, then the
            # body), and with Nagle's algorithm the second waits for the
            # client's delayed ACK, ~40 ms an answer on a keep-alive
            # connection. The JAX gateway leaves Nagle on (ROADMAP C12).
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route through logging
                log.debug("http %s", fmt % args)

            def _send(self, status: int, body: dict, headers=()):
                payload = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _bearer_ok(self, token: Optional[str]) -> bool:
                """Constant-time bearer check. HEADER ONLY: a token in the
                query string would persist in access logs, proxy caches,
                and Referer headers — the regression the old ``?token=``
                fallback invited (tests pin its removal)."""
                if token is None:
                    return True
                import hmac

                auth = self.headers.get("Authorization", "")
                supplied = auth[7:] if auth.startswith("Bearer ") else ""
                return hmac.compare_digest(supplied, token)

            def _handle_policy(self, q) -> None:
                """Tiered per-key overrides (policy engine). A quota-GRANT
                lever, so gated exactly like reset: disabled unless the
                embedding opted in, bearer-token in the header only."""
                if not gateway.enable_policy:
                    self._send(403, {"error": "policy endpoint is disabled "
                                     "on this gateway"})
                    return
                if not self._bearer_ok(gateway.policy_token):
                    self._send(403, {"error": "bad policy token"})
                    return
                key = q.get("key", [None])[0]
                if key is None:
                    self._send(400, {"error": "missing key"})
                    return
                if self.command == "GET":
                    ov = gateway.policy_get(key)
                    if ov is None:
                        self._send(404, {"error": f"no override for {key!r}",
                                         "key": key})
                        return
                    self._send(200, {"key": key, "limit": int(ov.limit),
                                     "window_scale": float(ov.window_scale)})
                elif self.command in ("POST", "PUT"):
                    raw = q.get("limit", [None])[0]
                    limit = int(raw) if raw is not None else None
                    scale = float(q.get("window_scale", ["1.0"])[0])
                    ov = gateway.policy_set(key, limit, window_scale=scale)
                    _events.emit("policy", "set-override", actor="http",
                                 payload={"key_hash": _key_token(key),
                                          "limit": int(ov.limit),
                                          "window_scale":
                                              float(ov.window_scale)})
                    self._send(200, {"ok": True, "key": key,
                                     "limit": int(ov.limit),
                                     "window_scale": float(ov.window_scale)})
                elif self.command == "DELETE":
                    deleted = bool(gateway.policy_delete(key))
                    _events.emit("policy", "delete-override",
                                 actor="http",
                                 payload={"key_hash": _key_token(key),
                                          "deleted": deleted})
                    self._send(200, {"ok": True, "key": key,
                                     "deleted": deleted})
                else:
                    self._send(405, {"error": f"method {self.command} not "
                                     "allowed on /v1/policy"})

            def _handle_tenants(self, q) -> None:
                """Hierarchical-cascade management (ADR-020): tenant
                registry + key assignments + effective-limit overrides.
                A quota lever in BOTH directions (raising a tenant
                ceiling grants, forcing an effective limit denies), so
                gated exactly like /v1/policy: explicit opt-in plus a
                header-only bearer token."""
                if not gateway.enable_tenants:
                    self._send(403, {"error": "tenant endpoint is disabled "
                                     "on this gateway"})
                    return
                if not self._bearer_ok(gateway.tenants_token):
                    self._send(403, {"error": "bad tenants token"})
                    return
                hier = gateway.tenants
                if self.command == "GET":
                    st = hier.hierarchy_stats()
                    st["effective"] = hier.effective_limits()
                    self._send(200, st)
                    return
                if self.command == "DELETE":
                    name = q.get("name", [None])[0]
                    if not name:
                        self._send(400, {"error": "missing name"})
                        return
                    deleted = bool(hier.delete_tenant(name))
                    _events.emit("tenant", "delete", actor="http",
                                 payload={"name": name,
                                          "deleted": deleted})
                    self._send(200, {"ok": True, "name": name,
                                     "deleted": deleted})
                    return
                if self.command not in ("POST", "PUT"):
                    self._send(405, {"error": f"method {self.command} not "
                                     "allowed on /v1/tenants"})
                    return
                if "assign" in q:
                    key = q["assign"][0]
                    tenant = q.get("tenant", [None])[0]
                    if not tenant:
                        self._send(400, {"error": "assign needs tenant"})
                        return
                    hier.assign_tenant(key, tenant)
                    _events.emit("tenant", "assign", actor="http",
                                 payload={"key_hash": _key_token(key),
                                          "tenant": tenant})
                    self._send(200, {"ok": True, "key": key,
                                     "tenant": tenant})
                elif "unassign" in q:
                    key = q["unassign"][0]
                    unassigned = bool(hier.unassign_tenant(key))
                    _events.emit("tenant", "unassign", actor="http",
                                 payload={"key_hash": _key_token(key),
                                          "unassigned": unassigned})
                    self._send(200, {"ok": True, "key": key,
                                     "unassigned": unassigned})
                elif "global_limit" in q:
                    raw = q["global_limit"][0]
                    lim = int(raw) if raw else None
                    hier.set_global_limit(lim or None)
                    _events.emit("tenant", "set-global-limit",
                                 actor="http",
                                 payload={"global_limit": lim or 0})
                    self._send(200, {"ok": True, "global_limit": lim or 0})
                elif "effective" in q:
                    scope = q["effective"][0]
                    raw = q.get("limit", [None])[0]
                    if raw is None:
                        self._send(400, {"error": "effective needs limit"})
                        return
                    new = hier.set_effective(scope, int(raw))
                    _events.emit("tenant", "set-effective", actor="http",
                                 payload={"scope": scope,
                                          "effective": int(new)})
                    self._send(200, {"ok": True, "scope": scope,
                                     "effective": int(new)})
                else:
                    name = q.get("name", [None])[0]
                    if not name:
                        self._send(400, {"error": "missing name (or one of "
                                         "assign/unassign/global_limit/"
                                         "effective)"})
                        return
                    raw = q.get("limit", [None])[0]
                    limit = int(raw) if raw is not None else None
                    weight = int(q.get("weight", ["1"])[0])
                    rawf = q.get("floor", [None])[0]
                    floor = int(rawf) if rawf is not None else None
                    t = hier.set_tenant(name, limit, weight=weight,
                                        floor=floor)
                    _events.emit("tenant", "set", actor="http",
                                 payload={"name": name,
                                          "limit": int(t.limit),
                                          "weight": int(t.weight),
                                          "floor": int(t.floor)})
                    self._send(200, {"ok": True, "name": name,
                                     "tid": int(t.tid),
                                     "limit": int(t.limit),
                                     "weight": int(t.weight),
                                     "floor": int(t.floor)})

            def _handle_migrate(self, q) -> None:
                """Live range migration: POST /v1/fleet/migrate?to=HOST&
                ranges=lo:hi[,lo:hi...]&wait=S. An ownership-move lever,
                so it exists only when the embedding wired both the
                fleet hook and a bearer token."""
                if gateway.fleet_migrate is None or \
                        gateway.migrate_token is None:
                    self._send(403, {"error": "fleet migration is not "
                                     "exposed on this gateway (needs "
                                     "--http-migrate-token on a fleet "
                                     "member)"})
                    return
                if not self._bearer_ok(gateway.migrate_token):
                    self._send(403, {"error": "bad migrate token"})
                    return
                if self.command != "POST":
                    self._send(405, {"error": "POST only"})
                    return
                to = q.get("to", [None])[0]
                raw = q.get("ranges", [None])[0]
                if not to or not raw:
                    self._send(400, {"error": "missing to= or ranges= "
                                     "(lo:hi[,lo:hi...])"})
                    return
                try:
                    ranges = []
                    for part in raw.split(","):
                        lo, hi = part.split(":")
                        ranges.append((int(lo), int(hi)))
                except ValueError:
                    self._send(400, {"error": f"bad ranges {raw!r}; "
                                     "expected lo:hi[,lo:hi...]"})
                    return
                wait = float(q.get("wait", ["10.0"])[0])
                out = gateway.fleet_migrate(ranges, to, wait)
                self._send(200 if out.get("ok") else 504, out)

            def _handle_rebalance(self, q) -> None:
                """The placement controller's operator surface: GET
                /v1/fleet/rebalance (status) and POST
                /v1/fleet/rebalance?action=dry-run|apply|abort. An
                ownership-move lever like /v1/fleet/migrate, so it only
                exists when the embedding wired both the controller
                hook and a bearer token (--http-rebalance-token)."""
                if gateway.fleet_rebalance is None or \
                        gateway.rebalance_token is None:
                    self._send(403, {"error": "rebalancing is not "
                                     "exposed on this gateway (needs "
                                     "--http-rebalance-token on a "
                                     "fleet member)"})
                    return
                if not self._bearer_ok(gateway.rebalance_token):
                    self._send(403, {"error": "bad rebalance token"})
                    return
                if self.command == "GET":
                    self._send(200, gateway.fleet_rebalance("status"))
                    return
                if self.command != "POST":
                    self._send(405, {"error": "GET or POST only"})
                    return
                action = q.get("action", [None])[0]
                if action not in ("dry-run", "apply", "abort"):
                    self._send(400, {"error": "action must be one of "
                                     "dry-run|apply|abort"})
                    return
                out = gateway.fleet_rebalance(action)
                self._send(200 if out.get("ok") else 409, out)

            def _bearer_value(self) -> Optional[str]:
                """The caller's bearer token, passed through to the
                peers of a fleet fan-out (debug tokens are assumed
                fleet-uniform, so the tower forwards the same header
                and never stores one)."""
                auth = self.headers.get("Authorization", "")
                return auth[7:] if auth.startswith("Bearer ") else None

            def _handle_debug_trace(self, q) -> None:
                """Flight-recorder dump as Perfetto/Chrome-trace JSON
                (ADR-014). A trace exposes keys' traffic timing and
                thread structure, so the trust boundary is the same as
                /v1/policy: disabled unless the embedding opted in,
                bearer token in the header only. ``?fleet=1`` on a
                fleet member answers one offset-aligned timeline over
                every member's span rings, the caller's bearer passed
                through to the peers; 400 without the tower's hook."""
                if not gateway.enable_debug:
                    self._send(403, {"error": "debug endpoints are "
                                     "disabled on this gateway"})
                    return
                if not self._bearer_ok(gateway.debug_token):
                    self._send(403, {"error": "bad debug token"})
                    return
                if q.get("fleet", ["0"])[0] not in ("", "0", "false"):
                    if gateway.fleet_trace is None:
                        self._send(400, {"error": "fleet trace "
                                         "stitching needs a fleet "
                                         "member (--fleet-config) with "
                                         "http ports in the map"})
                        return
                    payload = gateway.fleet_trace(self._bearer_value())
                    payload["enabled"] = True
                    self._send(200, payload)
                    return
                rec = tracing.RECORDER
                if rec is None:
                    self._send(200, {"enabled": False, "traceEvents": [],
                                     "hint": "start the server with "
                                     "--flight-recorder (or call "
                                     "tracing.enable())"})
                    return
                payload = rec.chrome_trace()
                payload["enabled"] = True
                self._send(200, payload)

            def _handle_debug_events(self, q) -> None:
                """Control-plane event journal (ADR-021): cursor-
                paginated (``?after=SEQ&limit=N[&category=C]``), tail
                form (``?tail=N``), and the fleet merge
                (``?fleet=1``, aligned on the membership clock offsets;
                400 without the tower's hook). Same trust boundary as
                /debug/trace: events name tenants, ranges, and
                controller decisions."""
                if not gateway.enable_debug:
                    self._send(403, {"error": "debug endpoints are "
                                     "disabled on this gateway"})
                    return
                if not self._bearer_ok(gateway.debug_token):
                    self._send(403, {"error": "bad debug token"})
                    return
                from ratelimiter_tpu_torch.observability import events as ev

                category = q.get("category", [None])[0] or None
                try:
                    limit = int(q.get("limit", ["256"])[0])
                    after = int(q.get("after", ["0"])[0])
                    tail = int(q.get("tail", ["0"])[0])
                except ValueError:
                    self._send(400, {"error": "after/limit/tail must "
                                     "be integers"})
                    return
                if q.get("fleet", ["0"])[0] not in ("", "0", "false"):
                    if gateway.fleet_events is None:
                        self._send(400, {"error": "fleet event merge "
                                         "needs a fleet member "
                                         "(--fleet-config) with http "
                                         "ports in the map"})
                        return
                    self._send(200, gateway.fleet_events(
                        limit=(tail or limit), category=category,
                        bearer=self._bearer_value()))
                    return
                j = ev.JOURNAL
                if j is None:
                    self._send(200, {"enabled": False, "events": [],
                                     "hint": "the event journal is "
                                     "disabled (--no-event-journal?)"})
                    return
                if tail:
                    self._send(200, j.tail(tail, category=category))
                else:
                    self._send(200, j.read(after=after, limit=limit,
                                           category=category))

            def _handle_debug_profile(self, q) -> None:
                """On-demand ``torch.profiler`` capture
                (GET/POST /debug/profile?seconds=N): profiles the CPU
                (and, with a card, its kernels), holds THIS handler
                thread for N seconds while traffic keeps flowing, and
                reports the artifact directory (one Chrome trace,
                ``trace.json`` — open with Perfetto or chrome://tracing).
                One capture at a time; same gate as /debug/trace. A
                process's first capture first pays the profiler's
                one-time initialization (~10 s on an H100), off the
                thread that loaded torch, which Kineto reports as an
                error line; the capture that follows holds the kernels
                all the same."""
                if not gateway.enable_debug:
                    self._send(403, {"error": "debug endpoints are "
                                     "disabled on this gateway"})
                    return
                if not self._bearer_ok(gateway.debug_token):
                    self._send(403, {"error": "bad debug token"})
                    return
                seconds = min(float(q.get("seconds", ["1.0"])[0]),
                              MAX_PROFILE_SECONDS)
                if seconds <= 0:
                    self._send(400, {"error": "seconds must be > 0"})
                    return
                if not gateway._profile_lock.acquire(blocking=False):
                    self._send(409, {"error": "a profile capture is "
                                     "already running"})
                    return
                try:
                    import os
                    import tempfile
                    import time as _time

                    import torch
                    from torch.profiler import ProfilerActivity, profile

                    out_dir = tempfile.mkdtemp(prefix="rl_profile_")
                    acts = [ProfilerActivity.CPU]
                    cuda = (torch.cuda.is_available()
                            and ProfilerActivity.CUDA
                            in torch.profiler.supported_activities())
                    if cuda:
                        acts.append(ProfilerActivity.CUDA)
                    prof = profile(activities=acts)
                    prof.start()
                    try:
                        _time.sleep(seconds)
                    finally:
                        if cuda:
                            torch.cuda.synchronize()
                        prof.stop()
                    prof.export_chrome_trace(
                        os.path.join(out_dir, "trace.json"))
                    files = sorted(
                        os.path.relpath(os.path.join(root, f), out_dir)
                        for root, _, fs in os.walk(out_dir) for f in fs)
                except Exception as exc:  # noqa: BLE001 — profiler is
                    # best-effort (unsupported platform, concurrent
                    # capture by another tool): report, never crash.
                    log.exception("debug profile capture failed")
                    self._send(503, {"error": f"profiler unavailable: "
                                     f"{exc}"})
                    return
                finally:
                    gateway._profile_lock.release()
                # Send OUTSIDE the capture try: a client that gave up
                # mid-capture must not be misreported as a profiler
                # failure (the broken pipe surfaces in _handle's guard).
                self._send(200, {"ok": True, "dir": out_dir,
                                 "seconds": seconds, "files": files})

            def _handle_debug_audit(self) -> None:
                """Live accuracy observatory snapshot (ADR-016): the
                auditor's rates + confidence + attribution, top-K
                consumer analytics, and the SLO burn-rate block. Top-K
                rows expose consumer HASH tokens (never raw keys), but
                traffic shape is still reconnaissance-grade — so the
                endpoint exists only when auditing is on and honors its
                own bearer token (header only, like every other
                token)."""
                if gateway.audit_status is None:
                    self._send(403, {"error": "the accuracy observatory "
                                     "is not enabled on this server "
                                     "(--audit)"})
                    return
                if not self._bearer_ok(gateway.audit_token):
                    self._send(403, {"error": "bad audit token"})
                    return
                try:
                    self._send(200, gateway.audit_status())
                except Exception as exc:  # noqa: BLE001 — a flaky shadow
                    # leg must degrade the debug surface, never the conn.
                    log.exception("debug audit status failed")
                    self._send(503, {"error": f"audit status unavailable: "
                                     f"{exc}"})

            def _handle(self):
                # Drain any request body first: HTTP/1.1 keep-alive means
                # unread body bytes would be parsed as the next request
                # line, corrupting the connection.
                try:
                    remaining = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    remaining = 0
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    if url.path == "/v1/allow":
                        key = q.get("key", [None])[0] \
                            or self.headers.get("X-User-ID")
                        n = int(q.get("n", ["1"])[0])
                        if key is None:
                            self._send(400, {"error": "missing key (query "
                                             "param or X-User-ID header)"})
                            return
                        # W3C trace context (ADR-014): a caller's
                        # traceparent samples this decision into the
                        # flight recorder under its trace id, and the
                        # id propagates into the decide path when the
                        # wired callable is trace-aware (the in-repo
                        # doors are; plain lambdas keep working).
                        tid = tracing.parse_traceparent(
                            self.headers.get("traceparent"))
                        # Request deadline (ADR-015): callers propagate a
                        # RELATIVE millisecond budget; deadline-aware
                        # decide callables (the in-repo doors) shed
                        # expired work per policy, and a client-side
                        # expired budget answers 504 below.
                        budget = None
                        dl_hdr = self.headers.get("X-RateLimit-Deadline-Ms")
                        if dl_hdr is not None:
                            try:
                                budget = float(dl_hdr) / 1000.0
                            except ValueError:
                                budget = None
                        kwargs = {}
                        if tid and gateway._decide_trace:
                            kwargs["trace_id"] = tid
                        if budget is not None and gateway._decide_deadline:
                            kwargs["deadline"] = budget
                        rec = tracing.RECORDER
                        t0 = tracing.now() if rec is not None else 0
                        res = gateway.decide(key, n, **kwargs)
                        if rec is not None:
                            rec.record("http", t0, tracing.now(),
                                       trace_id=tid)
                        headers = [
                            ("X-RateLimit-Limit", str(res.limit)),
                            ("X-RateLimit-Remaining", str(res.remaining)),
                            ("X-RateLimit-Reset", str(int(res.reset_at))),
                        ]
                        if tid:
                            headers.append(
                                ("traceparent",
                                 self.headers.get("traceparent")))
                        body = {"allowed": bool(res.allowed),
                                "limit": int(res.limit),
                                "remaining": int(res.remaining),
                                "retry_after": float(res.retry_after),
                                "reset_at": float(res.reset_at),
                                "fail_open": bool(res.fail_open)}
                        if res.allowed:
                            self._send(200, body, headers)
                        else:
                            headers.append(
                                ("Retry-After",
                                 str(max(1, int(res.retry_after)))))
                            self._send(429, body, headers)
                    elif url.path == "/v1/reset" and self.command == "POST":
                        if not gateway.enable_reset:
                            self._send(403, {"error": "reset is disabled on "
                                             "this gateway"})
                            return
                        if not self._bearer_ok(gateway.reset_token):
                            self._send(403, {"error": "bad reset token"})
                            return
                        key = q.get("key", [None])[0]
                        if key is None:
                            self._send(400, {"error": "missing key"})
                            return
                        gateway.reset(key)
                        _events.emit("policy", "reset", actor="http",
                                     payload={"key_hash":
                                              _key_token(key)})
                        self._send(200, {"ok": True})
                    elif url.path == "/v1/policy":
                        self._handle_policy(q)
                    elif url.path == "/v1/tenants":
                        self._handle_tenants(q)
                    elif url.path == "/v1/fleet/migrate":
                        self._handle_migrate(q)
                    elif url.path == "/v1/fleet/rebalance":
                        self._handle_rebalance(q)
                    elif (url.path == "/v1/snapshot"
                          and self.command == "POST"):
                        # Durability trigger: bearer-gated like reset
                        # (it costs a capture + disk churn, so an open
                        # surface invites DoS-by-snapshot).
                        if gateway.snapshot is None:
                            self._send(403, {"error": "persistence is not "
                                             "enabled on this server"})
                            return
                        if not self._bearer_ok(gateway.snapshot_token):
                            self._send(403, {"error": "bad snapshot token"})
                            return
                        entry = gateway.snapshot()
                        self._send(200, {
                            "ok": True,
                            "snapshot_id": int(entry.get("id", 0)),
                            "wal_seq": int(entry.get("wal_seq", 0)),
                            "duration_s": float(entry.get("duration_s",
                                                          0.0))})
                    elif url.path == "/debug/trace":
                        self._handle_debug_trace(q)
                    elif url.path == "/debug/profile":
                        self._handle_debug_profile(q)
                    elif url.path == "/debug/audit":
                        self._handle_debug_audit()
                    elif url.path == "/debug/events":
                        self._handle_debug_events(q)
                    elif url.path == "/v1/fleet/status":
                        # Read-only fleet rollup (ADR-021): merged
                        # audit/consumer/SLO/hierarchy blocks over every
                        # member's /healthz, the exposure of /healthz
                        # itself (no mutation lever).
                        if gateway.fleet_status is None:
                            self._send(404, {"error": "not a fleet "
                                             "member (--fleet-config "
                                             "with http ports in the "
                                             "map)"})
                        else:
                            self._send(200, gateway.fleet_status())
                    elif url.path == "/healthz":
                        self._send(200, gateway.health())
                    elif url.path == "/metrics":
                        # Content negotiation: an OpenMetrics scraper
                        # (Accept: application/openmetrics-text) gets the
                        # exemplar-carrying exposition — histogram
                        # buckets annotated with the flight-recorder
                        # trace ids that landed in them (ADR-014).
                        accept = self.headers.get("Accept", "")
                        om = "application/openmetrics-text" in accept
                        text = gateway.metrics_render(
                            openmetrics=True).encode() if (
                            om and gateway._metrics_om) else \
                            gateway.metrics_render().encode()
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8" if om and gateway._metrics_om
                            else "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(text)))
                        self.end_headers()
                        self.wfile.write(text)
                    else:
                        self._send(404, {"error": f"no route {url.path}"})
                except (InvalidKeyError, InvalidNError, InvalidConfigError,
                        ValueError) as exc:
                    self._send(400, {"error": str(exc)})
                except DeadlineExceededError as exc:
                    # The propagated deadline expired before dispatch
                    # (fail-closed side of deadline shedding, ADR-015).
                    self._send(504, {"error": str(exc)})
                except StorageUnavailableError as exc:
                    # Reference example: backend down -> 503
                    # (docs/EXAMPLES.md:38-41).
                    self._send(503, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001 — never kill the conn
                    log.exception("http gateway internal error")
                    self._send(500, {"error": str(exc)})

            do_GET = _handle
            do_POST = _handle
            do_PUT = _handle
            do_DELETE = _handle

        self.decide = decide
        self.reset = reset
        self.enable_reset = enable_reset
        self.reset_token = reset_token
        self.policy_set = policy_set or _policy_unsupported
        self.policy_get = policy_get or _policy_unsupported
        self.policy_delete = policy_delete or _policy_unsupported
        # Policy needs both an explicit opt-in AND wired callables.
        self.enable_policy = bool(enable_policy and policy_set is not None)
        self.policy_token = policy_token
        # Snapshot trigger is wired iff the embedding runs persistence.
        self.snapshot = snapshot
        self.snapshot_token = snapshot_token
        # Debug surface (ADR-014): /debug/trace + /debug/profile, gated
        # like /v1/policy (explicit opt-in + header-only bearer).
        self.enable_debug = bool(enable_debug)
        self.debug_token = debug_token
        # Accuracy observatory (ADR-016): wired iff auditing is on.
        self.audit_status = audit_status
        self.audit_token = audit_token
        # Hierarchy management (ADR-020): opt-in + wired surface, like
        # policy.
        self.tenants = tenants
        self.enable_tenants = bool(enable_tenants and tenants is not None)
        self.tenants_token = tenants_token
        # Both required: _handle_migrate refuses otherwise.
        self.fleet_migrate = fleet_migrate
        self.migrate_token = migrate_token
        # The control tower's rollup, trace-stitch and event fan-out
        # callables, wired only on fleet members.
        self.fleet_status = fleet_status
        self.fleet_trace = fleet_trace
        self.fleet_events = fleet_events
        # The placement controller: hook and token both required —
        # _handle_rebalance refuses otherwise.
        self.fleet_rebalance = fleet_rebalance
        self.rebalance_token = rebalance_token
        self._profile_lock = threading.Lock()
        self._decide_trace = _accepts_trace(decide)
        self._decide_deadline = _accepts_kw(decide, "deadline")
        self.metrics_render = metrics_render if metrics_render else lambda: ""
        # OpenMetrics negotiation needs a renderer that takes the
        # openmetrics kwarg (Registry.render does; plain lambdas don't).
        self._metrics_om = (metrics_render is not None
                            and _accepts_kw(metrics_render, "openmetrics"))
        self.health = health if health else lambda: {"serving": True}
        self._httpd = _GatewayHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="rl-http-gateway")
        self._thread.start()
        log.info("http gateway listening on %s:%d", self.host, self.port)

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def gateway_for_limiter(limiter, *, host: str = "127.0.0.1",
                        port: int = 0, enable_policy: bool = False,
                        policy_token: Optional[str] = None,
                        enable_debug: bool = False,
                        debug_token: Optional[str] = None) -> HttpGateway:
    """Standalone embedding: the gateway calls the limiter directly
    (the limiter's own lock serializes; for coalescing with binary
    traffic use the server binary's --http-port instead)."""
    from ratelimiter_tpu_torch.observability import metrics as m

    return HttpGateway(
        lambda key, n: limiter.allow_n(key, n),
        limiter.reset,
        host=host, port=port,
        metrics_render=m.DEFAULT.render,
        health=lambda: {"serving": True},
        policy_set=limiter.set_override,
        policy_get=limiter.get_override,
        policy_delete=limiter.delete_override,
        enable_policy=enable_policy,
        policy_token=policy_token,
        enable_debug=enable_debug,
        debug_token=debug_token)
