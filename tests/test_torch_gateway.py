"""The port's HTTP gateway (serving/http_gateway.py) against the JAX
package's, tolerance 0, and the port's binary serving HTTP beside binary
frames.

The scenarios of tests/test_http_gateway.py (and the gateway's other
routes) run in-process on both gateways side by side: one over a JAX
limiter (exact, and the sketch on its jnp path), one over the port's
limiter on the CPU, the two clocks set to the same instant before every
request. Each request goes to both; the status, every header but
``Date`` and ``Server`` (``X-RateLimit-*``, ``Retry-After``,
``traceparent``, the content type and length) and the JSON body must be
equal, and so must the token gates' answers (403, 400, 404, 409, 503,
504). ``/debug/profile``'s capture itself is the port's
``torch.profiler`` (JAX's is ``jax.profiler``), so its 200 answer is
held to the JAX shape (``ok``, ``dir``, ``seconds``, ``files``) on the
port alone.

The binary (``python -m ratelimiter_tpu_torch.serving --device cpu
--http-port``) runs in a child process, killed in a ``finally``: HTTP
and binary ALLOW_N frames spend one key's quota, the reset and policy
levers answer behind their tokens, ``/healthz`` counts the decisions of
both doors and ``/debug/audit`` answers under ``--audit``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.core import errors as jerrors
from ratelimiter_tpu.observability import events as jevents
from ratelimiter_tpu.observability import metrics as jm
from ratelimiter_tpu.observability import tracing as jtracing
from ratelimiter_tpu.observability.decorators import (
    MetricsDecorator as JMetrics,
)
from ratelimiter_tpu.serving import http_gateway as jgw
from ratelimiter_tpu_torch.core import errors as terrors
from ratelimiter_tpu_torch.observability import events as tevents
from ratelimiter_tpu_torch.observability import metrics as tm
from ratelimiter_tpu_torch.observability import tracing as ttracing
from ratelimiter_tpu_torch.observability.decorators import (
    MetricsDecorator as TMetrics,
)
from ratelimiter_tpu_torch.serving import http_gateway as tgw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
_SKIP_HEADERS = ("Date", "Server")


@pytest.fixture(autouse=True)
def _globals_off():
    for mod in (jtracing, ttracing, jevents, tevents):
        mod.disable()
    yield
    for mod in (jtracing, ttracing, jevents, tevents):
        mod.disable()


def _call(port: int, method: str, path: str, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, hdrs, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, dict(e.headers), e.read()
    for h in _SKIP_HEADERS:
        hdrs.pop(h, None)
    ctype = hdrs.get("Content-Type", "")
    body = json.loads(raw) if ctype == "application/json" else raw.decode()
    return status, hdrs, body


def _cfg(M, backend: str, limit: int = 3, **kw):
    sketch = {}
    if backend == "sketch":
        sketch = dict(depth=2, width=512, sub_windows=6)
        if M is R:
            sketch["kernels"] = "jnp"
    return M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=limit,
                    window=60.0, fail_open=False,
                    sketch=M.SketchParams(**sketch), **kw)


def _limiter(M, backend: str, cfg, clock):
    if M is R:
        return M.create_limiter(cfg, backend=backend, clock=clock)
    return M.create_limiter(cfg, backend=backend, clock=clock, device="cpu")


class GatewayPair:
    """The JAX gateway over a JAX limiter and the port's over the
    port's, each limiter under its package's MetricsDecorator. A
    callable gateway keyword is called with (package, limiter) for each
    side; ``cfg_kw(package)`` gives more Config fields."""

    def __init__(self, backend: str = "exact", *, limit: int = 3,
                 decide=None, cfg_kw=None, **gw_kw):
        self.clocks, self.lims, self.regs, self.gws = [], [], [], []
        for M, mod, reg_mod, metrics in ((R, jgw, jm, JMetrics),
                                         (T, tgw, tm, TMetrics)):
            clock = M.ManualClock(T0)
            reg = reg_mod.Registry()
            cfg = _cfg(M, backend, limit, **(cfg_kw(M) if cfg_kw else {}))
            lim = metrics(_limiter(M, backend, cfg, clock), registry=reg)
            kw = {k: (v(M, lim) if callable(v) else v)
                  for k, v in gw_kw.items()}
            dec = (decide(M, lim) if decide is not None
                   else (lambda k, n, lim=lim: lim.allow_n(k, n)))
            gw = mod.HttpGateway(dec, lim.reset, metrics_render=reg.render,
                                 **kw)
            gw.start()
            self.clocks.append(clock)
            self.lims.append(lim)
            self.regs.append(reg)
            self.gws.append(gw)

    def at(self, t: float) -> None:
        for c in self.clocks:
            c.set(t)

    def both(self, method: str, path: str, headers=None):
        """The request on both gateways; the answers must be equal."""
        j, t = (_call(gw.port, method, path, headers) for gw in self.gws)
        assert t == j, (method, path)
        return t

    def close(self) -> None:
        for gw in self.gws:
            gw.shutdown()
        for lim in self.lims:
            lim.close()


@pytest.fixture(params=["exact", "sketch"])
def pair(request):
    p = GatewayPair(request.param)
    yield p
    p.close()


def test_allow_with_headers_then_429(pair):
    for i in range(3):
        pair.at(T0 + i)
        st, hdrs, body = pair.both("GET", "/v1/allow?key=u1")
        assert st == 200 and body["allowed"]
        assert hdrs["X-RateLimit-Remaining"] == str(2 - i)
    pair.at(T0 + 3.5)
    st, hdrs, body = pair.both("GET", "/v1/allow?key=u1")
    assert st == 429 and int(hdrs["Retry-After"]) >= 1
    assert body["allowed"] is False and body["retry_after"] > 0


def test_allow_n_header_key_and_reset(pair):
    pair.at(T0)
    assert pair.both("GET", "/v1/allow?key=u2&n=3")[0] == 200
    assert pair.both("GET", "/v1/allow", {"X-User-ID": "u2"})[0] == 429
    assert pair.both("POST", "/v1/allow?n=2", {"X-User-ID": "u3"})[0] == 200
    pair.at(T0 + 1)
    assert pair.both("POST", "/v1/reset?key=u2") == (200, {
        "Content-Type": "application/json", "Content-Length": "12"},
        {"ok": True})
    assert pair.both("GET", "/v1/allow?key=u2")[0] == 200


def test_validation_errors_are_400(pair):
    for path in ("/v1/allow", "/v1/allow?key=u5&n=0",
                 "/v1/allow?key=u5&n=abc", "/v1/reset"):
        method = "POST" if "reset" in path else "GET"
        assert pair.both(method, path)[0] == 400


def test_backend_failure_is_503(pair):
    for lim in pair.lims:
        lim.inner.inject_failure()
    assert pair.both("GET", "/v1/allow?key=u6")[0] == 503
    for lim in pair.lims:
        lim.inner.heal()
    assert pair.both("GET", "/v1/allow?key=u6")[0] == 200


def test_healthz_metrics_and_404(pair):
    assert pair.both("GET", "/healthz") == (200, {
        "Content-Type": "application/json", "Content-Length": "17"},
        {"serving": True})
    pair.both("GET", "/v1/allow?key=u7")
    # The texts carry each side's own latency histograms, so their
    # lengths may differ; status and content type may not.
    got = [_call(gw.port, "GET", "/metrics") for gw in pair.gws]
    assert [(st, h["Content-Type"]) for st, h, _ in got] == [
        (200, "text/plain; version=0.0.4")] * 2
    assert "rate_limiter_requests_total" in got[1][2]
    om = [_call(gw.port, "GET", "/metrics",
                {"Accept": "application/openmetrics-text"})
          for gw in pair.gws]
    assert om[0][1]["Content-Type"] == om[1][1]["Content-Type"]
    assert om[1][2].endswith("# EOF\n")
    assert pair.both("GET", "/nope")[0] == 404
    assert pair.both("GET", "/v1/reset?key=x")[0] == 404     # POST only


def test_traceparent_and_deadline():
    """A traceparent is echoed; a deadline-aware decide gets the budget
    (an expired one answers 504); other failures answer 500."""
    def decide(M, lim):
        errs = jerrors if M is R else terrors

        def fn(key, n, trace_id=0, deadline=None):
            if key == "boom":
                raise RuntimeError("backend exploded")
            if deadline is not None and deadline <= 0:
                raise errs.DeadlineExceededError(
                    "request deadline expired before dispatch")
            return lim.allow_n(key, n)
        return fn

    p = GatewayPair(decide=decide)
    try:
        tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
        st, hdrs, _ = p.both("GET", "/v1/allow?key=t", {"traceparent": tp})
        assert st == 200 and hdrs["traceparent"] == tp
        assert p.both("GET", "/v1/allow?key=t",
                      {"X-RateLimit-Deadline-Ms": "0"})[0] == 504
        assert p.both("GET", "/v1/allow?key=t",
                      {"X-RateLimit-Deadline-Ms": "oops"})[0] == 200
        assert p.both("GET", "/v1/allow?key=boom")[0] == 500
    finally:
        p.close()


def test_reset_gates():
    p = GatewayPair(enable_reset=False)
    try:
        p.both("GET", "/v1/allow?key=g&n=3")
        assert p.both("POST", "/v1/reset?key=g")[0] == 403
        assert p.both("GET", "/v1/allow?key=g")[0] == 429
    finally:
        p.close()
    p = GatewayPair(reset_token="tok123")
    try:
        p.both("GET", "/v1/allow?key=g&n=3")
        for hdrs in ({}, {"Authorization": "Bearer nope"},
                     {"Authorization": "tok123"}):
            assert p.both("POST", "/v1/reset?key=g", hdrs)[0] == 403
        assert p.both("POST", "/v1/reset?key=g&token=tok123")[0] == 403
        assert p.both("POST", "/v1/reset?key=g",
                      {"Authorization": "Bearer tok123"})[0] == 200
        assert p.both("GET", "/v1/allow?key=g")[0] == 200
    finally:
        p.close()


@pytest.mark.parametrize("backend", ["exact", "sketch"])
def test_policy_crud_and_gates(backend):
    p = GatewayPair(backend, policy_set=lambda M, lim: lim.set_override,
                    policy_get=lambda M, lim: lim.get_override,
                    policy_delete=lambda M, lim: lim.delete_override,
                    enable_policy=True, policy_token="pt")
    auth = {"Authorization": "Bearer pt"}
    try:
        for path in ("/v1/policy?key=v&limit=9",
                     "/v1/policy?key=v&limit=9&token=pt"):
            assert p.both("POST", path)[0] == 403
        st, _, body = p.both("POST", "/v1/policy?key=v&limit=9", auth)
        assert st == 200 and body["limit"] == 9
        # The sketch refuses a per-key window (400); exact stores it.
        st, _, body = p.both("PUT", "/v1/policy?key=w&limit=4"
                             "&window_scale=2.0", auth)
        assert (st, body.get("window_scale")) == (
            (200, 2.0) if backend == "exact" else (400, None))
        assert p.both("GET", "/v1/policy?key=v", auth)[2]["limit"] == 9
        st, hdrs, _ = p.both("GET", "/v1/allow?key=v")
        assert st == 200 and hdrs["X-RateLimit-Limit"] == "9"
        assert p.both("POST", "/v1/policy?key=v&limit=-3", auth)[0] == 400
        assert p.both("POST", "/v1/policy?limit=3", auth)[0] == 400
        assert p.both("DELETE", "/v1/policy?key=v", auth)[2]["deleted"]
        assert p.both("GET", "/v1/policy?key=v", auth)[0] == 404
    finally:
        p.close()
    p = GatewayPair(backend)           # the default: no policy surface
    try:
        assert p.both("POST", "/v1/policy?key=k&limit=9")[0] == 403
    finally:
        p.close()


def test_snapshot_gates():
    calls = []

    def snap(M, lim):
        def fn():
            calls.append(M)
            return {"id": 3, "wal_seq": 17, "duration_s": 0.01}
        return fn

    p = GatewayPair()
    try:
        st, _, body = p.both("POST", "/v1/snapshot")
        assert st == 403 and "not enabled" in body["error"]
    finally:
        p.close()
    p = GatewayPair(snapshot=snap, snapshot_token="st")
    try:
        for hdrs in ({}, {"Authorization": "Bearer nope"}):
            assert p.both("POST", "/v1/snapshot", hdrs)[0] == 403
        assert p.both("POST", "/v1/snapshot?token=st")[0] == 403
        assert calls == []
        st, _, body = p.both("POST", "/v1/snapshot",
                             {"Authorization": "Bearer st"})
        assert st == 200 and body["snapshot_id"] == 3
        assert calls == [R, T]
        assert p.both("GET", "/v1/snapshot")[0] == 404
    finally:
        p.close()


def test_debug_routes_and_fleet_answers():
    """/debug/trace and /debug/events behind the debug gate (recorder
    off, then on; the journal's policy events from both gateways), the
    fleet routes answering as the JAX gateway without its hooks, and
    /debug/profile's 400/403/409 answers."""
    p = GatewayPair()
    try:
        assert p.both("GET", "/debug/trace")[0] == 403
        assert p.both("GET", "/debug/events")[0] == 403
        assert p.both("GET", "/debug/profile")[0] == 403
        assert p.both("POST", "/v1/fleet/migrate?to=x&ranges=0:1")[0] == 403
        assert p.both("GET", "/v1/fleet/rebalance")[0] == 403
        assert p.both("GET", "/v1/fleet/status")[0] == 404
    finally:
        p.close()
    p = GatewayPair(enable_debug=True, debug_token="dt",
                    policy_set=lambda M, lim: lim.set_override,
                    policy_get=lambda M, lim: lim.get_override,
                    policy_delete=lambda M, lim: lim.delete_override,
                    enable_policy=True)
    auth = {"Authorization": "Bearer dt"}
    try:
        assert p.both("GET", "/debug/trace")[0] == 403
        st, _, body = p.both("GET", "/debug/trace", auth)
        assert st == 200 and body["enabled"] is False
        assert p.both("GET", "/debug/trace?fleet=1", auth)[0] == 400
        assert p.both("GET", "/debug/events", auth)[2]["enabled"] is False
        assert p.both("GET", "/debug/events?fleet=1", auth)[0] == 400
        assert p.both("GET", "/debug/events?limit=x", auth)[0] == 400
        assert p.both("GET", "/debug/profile?seconds=0", auth)[0] == 400
        for gw in p.gws:
            gw._profile_lock.acquire()
        assert p.both("GET", "/debug/profile?seconds=1", auth)[0] == 409
        for gw in p.gws:
            gw._profile_lock.release()
        jevents.enable(64, host="h:1")
        tevents.enable(64, host="h:1")
        p.both("POST", "/v1/policy?key=e&limit=7")
        p.both("DELETE", "/v1/policy?key=e")
        p.both("POST", "/v1/reset?key=e")
        j, t = (_call(gw.port, "GET", "/debug/events?tail=10", auth)[2]
                for gw in p.gws)
        def strip(evs):
            return [{k: v for k, v in ev.items()
                     if k not in ("ts", "mono_ns")} for ev in evs]

        assert strip(t["events"]) == strip(j["events"])
        assert [ev["action"] for ev in t["events"]] == [
            "set-override", "delete-override", "reset"]
        jtracing.enable(64)
        ttracing.enable(64)
        p.both("GET", "/v1/allow?key=t", {"traceparent":
               "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"})
        for gw in p.gws:
            st, _, body = _call(gw.port, "GET", "/debug/trace", auth)
            assert st == 200 and body["enabled"] is True
            assert any(e.get("name") == "http"
                       for e in body["traceEvents"])
    finally:
        p.close()


def test_profile_capture_port():
    """The port's capture: one Chrome trace in a fresh directory, the
    JAX reply's keys."""
    lim = T.create_limiter(_cfg(T, "exact"), backend="exact",
                           clock=T.ManualClock(T0))
    gw = tgw.HttpGateway(lambda k, n: lim.allow_n(k, n), lim.reset,
                         enable_debug=True)
    gw.start()
    try:
        st, _, body = _call(gw.port, "POST", "/debug/profile?seconds=0.2")
        assert st == 200
        assert sorted(body) == ["dir", "files", "ok", "seconds"]
        assert body["files"] == ["trace.json"] and body["seconds"] == 0.2
        with open(os.path.join(body["dir"], "trace.json")) as fh:
            assert "traceEvents" in json.load(fh)
    finally:
        gw.shutdown()
        lim.close()


def test_debug_audit_gate():
    """/debug/audit: 403 unless an audit status is wired, then behind
    its own token; a status that raises answers 503."""
    p = GatewayPair()
    try:
        assert p.both("GET", "/debug/audit")[0] == 403
    finally:
        p.close()
    state = {"fail": False}

    def status(M, lim):
        def fn():
            if state["fail"]:
                raise RuntimeError("shadow leg down")
            return {"enabled": True, "samples": 4}
        return fn

    p = GatewayPair(audit_status=status, audit_token="at")
    try:
        assert p.both("GET", "/debug/audit")[0] == 403
        assert p.both("GET", "/debug/audit",
                      {"Authorization": "Bearer at"})[2]["samples"] == 4
        state["fail"] = True
        assert p.both("GET", "/debug/audit",
                      {"Authorization": "Bearer at"})[0] == 503
    finally:
        p.close()


def test_tenants_route():
    """/v1/tenants over a hierarchy-enabled sketch in both packages:
    GET (hierarchy_stats and effective limits), every POST form, DELETE,
    and the gates."""
    p = GatewayPair("sketch", limit=10, cfg_kw=lambda M: {
        "hierarchy": M.HierarchySpec(tenants=4, map_capacity=32,
                                     global_limit=90,
                                     default_tenant_limit=40)},
        tenants=lambda M, lim: lim, enable_tenants=True, tenants_token="tt")
    auth = {"Authorization": "Bearer tt"}
    try:
        assert p.both("GET", "/v1/tenants")[0] == 403
        forms = [("POST", "/v1/tenants?name=gold&limit=20&weight=3&floor=2"),
                 ("PUT", "/v1/tenants?name=free&limit=5"),
                 ("POST", "/v1/tenants?assign=api-1&tenant=gold"),
                 ("POST", "/v1/tenants?assign=api-2"),
                 ("POST", "/v1/tenants?unassign=api-1"),
                 ("POST", "/v1/tenants?global_limit=80"),
                 ("POST", "/v1/tenants?assign=api-3&tenant=gold"),
                 ("GET", "/v1/allow?key=api-3&n=4"),
                 ("GET", "/v1/allow?key=api-4&n=2"),
                 ("POST", "/v1/tenants?effective=gold&limit=15"),
                 ("POST", "/v1/tenants?effective=gold"),
                 ("POST", "/v1/tenants?limit=3"),
                 ("GET", "/v1/tenants"),
                 ("DELETE", "/v1/tenants?name=free"),
                 ("DELETE", "/v1/tenants"),
                 ("PATCH", "/v1/tenants"),
                 ("GET", "/v1/tenants")]
        codes = [p.both(m, path, auth)[0] for m, path in forms]
        assert codes == [200, 200, 200, 400, 200, 200, 200, 200, 200, 200,
                         400, 400, 200, 200, 400, 501, 200]
        st = p.both("GET", "/v1/tenants", auth)[2]
        assert st["tenants"]["gold"]["in_window"] == 4
        assert st["effective"]["gold"] == 15
    finally:
        p.close()


# ------------------------------------------------------- the port's binary


def _binary(args: list):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                  if x])
    proc = subprocess.Popen(
        [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
         "--device", "cpu", "--port", "0", "--http-port", "0", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    lines: list = []
    found = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                found.set()
        found.set()

    threading.Thread(target=read, daemon=True).start()
    if not found.wait(120) or not lines or \
            not lines[-1].startswith("serving"):
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError("binary did not start: " + "".join(lines[-20:]))
    line = lines[-1]
    port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
    http = int(line.rsplit("http:", 1)[1])
    return proc, port, http


def test_binary_http_beside_binary_frames():
    sys.path.insert(0, REPO)
    import chip_smoke
    from ratelimiter_tpu_torch.serving import protocol as p

    proc, port, http = _binary(
        ["--limit", "2", "--window", "60", "--sketch-width", "1024",
         "--http-reset-token", "rt", "--http-policy-token", "pt",
         "--debug-trace", "--audit", "--audit-sample", "1",
         "--audit-twin"])
    client = None
    try:
        assert _call(http, "GET", "/v1/allow?key=shared")[0] == 200
        client = chip_smoke.DoorClient(port)
        _, body = client.call(p.encode_allow_n, "shared", 1)
        assert p.parse_result(body).allowed
        _, body = client.call(p.encode_allow_n, "shared", 1)
        assert not p.parse_result(body).allowed
        st, hdrs, _ = _call(http, "GET", "/v1/allow?key=shared")
        assert st == 429 and hdrs["X-RateLimit-Remaining"] == "0"
        assert _call(http, "POST", "/v1/reset?key=shared")[0] == 403
        assert _call(http, "POST", "/v1/reset?key=shared",
                     {"Authorization": "Bearer rt"})[0] == 200
        _, body = client.call(p.encode_allow_n, "shared", 1)
        assert p.parse_result(body).allowed
        assert _call(http, "POST", "/v1/policy?key=vip&limit=7",
                     {"Authorization": "Bearer pt"})[0] == 200
        assert _call(http, "GET", "/v1/allow?key=vip")[1][
            "X-RateLimit-Limit"] == "7"
        st, _, health = _call(http, "GET", "/healthz")
        assert st == 200 and health["decisions_total"] == 6
        assert health["policy_overrides"] == 1
        assert health["transport"]["connections"] == {"tcp": 1, "uds": 0,
                                                      "shm": 0}
        assert not any(health["transport"]["shm"].values())
        assert health["audit"]["sample"] == 1 and "slo" in health
        assert [e["action"] for e in
                _call(http, "GET", "/debug/events")[2]["events"]] == [
            "reset", "set-override"]
        st, _, aud = _call(http, "GET", "/debug/audit")
        assert st == 200 and aud["twin"] is True
        text = _call(http, "GET", "/metrics")[2]
        assert "rate_limiter_audit_samples" in text
        assert "rate_limiter_slo_burn_rate" in text
    finally:
        if client is not None:
            client.close()
        proc.terminate()
        try:
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_binary_refuses_audit_on_exact_and_dense():
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_config,
        parse_args,
    )

    for backend in ("exact", "dense"):
        with pytest.raises(SystemExit, match="sketch-family"):
            build_config(parse_args(["--backend", backend, "--audit"]))
    build_config(parse_args(["--audit"]))


# ------------------------------------- chip_smoke's phase gateway, on CPU


def _small(cfg, **sketch):
    import dataclasses

    return dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, width=1024, **sketch))


@pytest.mark.parametrize("cell", ["windowed", "TB-c2"])
def test_phase_gateway_checks_on_cpu(cell):
    """chip_smoke.check_gateway at a small size on the CPU: binary frames
    and HTTP answers against the CPU replay, the audit tally against its
    recomputation, /healthz against its sources, the levers."""
    sys.path.insert(0, REPO)
    import chip_smoke

    if cell == "windowed":
        out = chip_smoke.check_gateway(
            None, _small(chip_smoke.config3_hh(), hh_slots=16), cell,
            device="cpu", seed=1, conns=1, frames=8, n_ids=64, n_keys=16,
            threads=3, requests=6)
    else:
        out = chip_smoke.check_gateway(
            None, _small(chip_smoke.config2_bucket()), cell, device="cpu",
            seed=2, space="c2", ns=(1, 4, 9), conns=2, frames=8, n_ids=64,
            n_keys=16, threads=3, requests=12, front_per_reset=1)
    assert out["http_answers"] == 3 * (6 if cell == "windowed" else 12)
    assert out["audit"]["status"]["samples"] == out["decisions"]
    assert "audit" in out["health_blocks"]


def test_phase_gateway_tenants_and_durable_on_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    out = chip_smoke.check_gateway_tenants(
        None, _small(chip_smoke.config3()), device="cpu")
    assert out["moves"] and "hierarchy" in out["health_blocks"]
    out = chip_smoke.check_gateway_durable(
        None, _small(chip_smoke.config3()), device="cpu")
    assert out["snapshot"]["ok"] and "wal_seq" in out["health_blocks"]


def test_binary_profile_capture_on_cpu():
    """``chip_smoke.check_binary_profile`` on the CPU: ``python -m
    ratelimiter_tpu_torch.serving`` as a child process answers its first
    /debug/profile capture while /v1/allow traffic flows, and exits 0 on
    SIGTERM (on the card the capture must also name the kernels)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    out = chip_smoke.check_binary_profile(device="cpu")
    assert out["rc"] == 0 and out["requests_during"] > 0
    assert out["seconds"] >= 1.0


def _first_answers(port: int, clients: int = 32) -> list:
    """``clients`` threads, released at once, each opening its own
    connection for one /v1/allow; the seconds each waited for its first
    answer."""
    import http.client
    import time

    gate = threading.Barrier(clients)
    waits = [None] * clients

    def one(i: int) -> None:
        gate.wait()
        t = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("GET", f"/v1/allow?key=c13-{i}")
            conn.getresponse().read()
        finally:
            conn.close()
        waits[i] = time.perf_counter() - t

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    return waits


def test_c13_simultaneous_connects_are_queued_not_dropped():
    """C13: the JAX gateway listens with socketserver's backlog of 5, so
    a burst of connects past it has SYNs dropped and retried after 1 s.
    The port's listens with the native door's 512: 32 clients
    connecting at once all get their first answer well under a second,
    and the answers are the JAX gateway's (the backlog changes none)."""
    assert tgw._GatewayHTTPServer.request_queue_size == tgw.LISTEN_BACKLOG
    assert tgw.LISTEN_BACKLOG == 512
    lim = T.create_limiter(_cfg(T, "exact", limit=100),
                           backend="exact", device="cpu")
    gw = tgw.gateway_for_limiter(lim)
    gw.start()
    try:
        for _ in range(3):
            waits = _first_answers(gw.port)
            assert None not in waits
            assert max(waits) < 0.75, sorted(waits)[-4:]
    finally:
        gw.shutdown()
        lim.close()
