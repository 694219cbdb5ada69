"""The fleet's control tower in the port (``ratelimiter_tpu_torch/fleet/
tower.py`` and ``tools/fleet_status.py``/``fleet_trace.py``), held to the
JAX package on the CPU.

* every merge of ``tower.py`` (``merge_audit``, ``merge_consumers``,
  ``merge_slo``, ``merge_hierarchy``, ``merged_status``,
  ``synthetic_parent_id``, ``merge_traces``, ``merge_events``) returns
  the JAX merge's dict for seeded member payloads (unreachable members,
  missing fields, unaligned peers, multi-parent windows) and for the
  JAX tests' hand-computed cases;
* ``fetch_json`` sends the bearer through, and ``ControlTower`` merges
  its own payloads with its peers' and names an unreachable peer a gap;
* the forward lane's trace pins over a real TCP hop to a port asyncio
  door: a traced frame crosses the hop under a linked window id, no
  trace flag goes on the wire with the recorder off, untraced frames
  still get window ids;
* the offline tools merge with the same code as the endpoint;
* two port binaries on the CPU (h0 the asyncio door, h1 the native door)
  under one timeout: ``chip_smoke.check_control_tower`` (the rollup on
  every member and through ``fleet_status`` live and ``--offline`` equal
  to the merge of the members' /healthz, the stitched trace, the merged
  events), a policy set on h1 read from h0's fleet events, the member
  identity gauge, ``fleet_trace`` and ``fleet_status``'s summaries.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error

import numpy as np
import pytest

from ratelimiter_tpu.fleet import tower as jtower
from ratelimiter_tpu_torch.core.clock import ManualClock
from ratelimiter_tpu_torch.evaluation.compare import wilson_interval
from ratelimiter_tpu_torch.fleet import FleetCore, FleetForwarder, FleetMap
from ratelimiter_tpu_torch.fleet import tower
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.serving import protocol as p

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from tests.test_torch_placement import deadline  # noqa: E402


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ----------------------------------------------------- seeded payloads


def _tok(rng):
    return f"{int(rng.integers(0, 12)):016x}"


def _audit(rng):
    n = int(rng.integers(0, 5000))
    allows = int(rng.integers(0, n + 1))
    b = {"sample": int(rng.choice([1, 16, 64])), "samples": n,
         "oracle_allows": allows,
         "false_denies": int(rng.integers(0, allows // 10 + 1)),
         "false_allows": int(rng.integers(0, (n - allows) // 10 + 1)),
         "fail_open_samples": int(rng.integers(0, 5)),
         "dropped_decisions": int(rng.integers(0, 50)),
         "oracle_errors": int(rng.integers(0, 3))}
    for k in list(b):
        if rng.random() < 0.1:
            del b[k]
    return b


def _consumers(rng):
    top = [{"consumer": _tok(rng), "in_window": int(rng.integers(0, 500))}
           for _ in range(int(rng.integers(0, 8)))]
    if top and rng.random() < 0.2:
        top[0].pop("consumer")
    return {"slots": int(rng.choice([16, 64, 256])),
            "occupied": int(rng.integers(0, 16)),
            "tracked_mass": int(rng.integers(0, 5000)), "top": top}


def _slo(rng):
    windows = {}
    for w in ("300s", "3600s")[:int(rng.integers(0, 3))]:
        spans = int(rng.integers(0, 10000))
        dec = int(rng.integers(0, 10000))
        windows[w] = {"span_s": float(rng.integers(0, 3600)),
                      "spans": spans,
                      "spans_slow": int(rng.integers(0, spans // 50 + 1)),
                      "decisions": dec,
                      "decisions_bad": int(rng.integers(0, dec // 50 + 1)),
                      "burn_rate": round(float(rng.random() * 5), 3)}
    return {"objective": float(rng.choice([0.99, 0.999, 0.9999])),
            "windows": windows}


def _scope(rng):
    r = {"in_window": int(rng.integers(0, 10000))}
    for f in ("effective", "ceiling", "weight"):
        if rng.random() < 0.8:
            r[f] = int(rng.integers(1, 50000))
    return r


def _hierarchy(rng):
    b = {"tenants": {f"t{i}": _scope(rng)
                     for i in rng.choice(6, int(rng.integers(0, 4)),
                                         replace=False)}}
    if rng.random() < 0.8:
        b["global"] = _scope(rng)
    if rng.random() < 0.3:
        b["controller"] = {"adjustments": int(rng.integers(0, 9))}
    return b


def _placement(rng, buckets=8):
    return {"buckets": buckets,
            "decide_total": int(rng.integers(0, 9999)),
            "forward_total": int(rng.integers(0, 9999)),
            "decide_rate": [round(float(v), 3)
                            for v in rng.exponential(3, buckets)],
            "forward_rate": [round(float(v), 3)
                             for v in rng.exponential(1, buckets)],
            "halflife_s": 10.0, "age_s": 12.5,
            **({"rebalance": {"state": "idle", "moves_ok": 1}}
               if rng.random() < 0.5 else {})}


def _health(rng, host):
    b = {"serving": True, "decisions_total": int(rng.integers(0, 10 ** 6)),
         "member": {"self": host, "door": "asyncio"},
         "fleet": {"epoch": int(rng.integers(1, 4)),
                   "owned_ranges": [[0, 8]], "adopted_buckets": 0,
                   "forwarded_total": int(rng.integers(0, 99)),
                   "forward_errors_total": 0}}
    for name, make in (("audit", _audit), ("consumers", _consumers),
                       ("slo", _slo), ("hierarchy", _hierarchy),
                       ("placement", _placement)):
        if rng.random() < 0.75:
            b[name] = make(rng)
    return b


def _members(rng):
    hosts = [f"h{i}" for i in range(int(rng.integers(1, 5)))]
    return {h: (None if rng.random() < 0.2 else _health(rng, h))
            for h in hosts}


@pytest.mark.parametrize("seed", range(12))
def test_block_merges_equal_jax_on_seeded_payloads(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        for fn, make in (("merge_audit", _audit),
                         ("merge_slo", _slo),
                         ("merge_hierarchy", _hierarchy)):
            blocks = {f"h{i}": make(rng)
                      for i in range(int(rng.integers(0, 5)))}
            _same(getattr(tower, fn)(copy.deepcopy(blocks)),
                  getattr(jtower, fn)(copy.deepcopy(blocks)))
        blocks = {f"h{i}": _consumers(rng)
                  for i in range(int(rng.integers(0, 5)))}
        k = int(rng.integers(1, 12))
        _same(tower.merge_consumers(copy.deepcopy(blocks), k=k),
              jtower.merge_consumers(copy.deepcopy(blocks), k=k))


@pytest.mark.parametrize("seed", range(12))
def test_merged_status_equals_jax_on_seeded_members(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        members = _members(rng)
        _same(tower.merged_status(copy.deepcopy(members)),
              jtower.merged_status(copy.deepcopy(members)))


def _trace_payload(rng, ids, links=()):
    return {"traceEvents": [
        {"name": str(rng.choice(["io", "forward", "device", "queue"])),
         "cat": "ratelimiter", "ph": "X",
         "ts": float(rng.integers(0, 10 ** 7)) / 7, "dur": 1.5,
         "pid": 1, "tid": int(rng.integers(1, 4)),
         "args": {"trace_id": str(rng.choice(ids))}}
        for _ in range(int(rng.integers(0, 30)))],
        "otherData": {"links": list(links),
                      "threads": {str(t): f"thread-{t}"
                                  for t in range(1, 4)}}}


@pytest.mark.parametrize("seed", range(12))
def test_trace_and_event_merges_equal_jax(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(4):
        clients = [f"{int(v):016x}" for v in rng.integers(1, 1 << 60, 4)]
        windows = [f"{int(v):016x}" for v in rng.integers(1, 1 << 60, 3)]
        links = [{"parent": str(rng.choice(clients)),
                  "child": str(rng.choice(windows)),
                  "t_ns": int(rng.integers(0, 10 ** 9))}
                 for _ in range(int(rng.integers(0, 6)))]
        hosts = [f"h{i}" for i in range(int(rng.integers(1, 5)))]
        payloads = {h: (None if i and rng.random() < 0.2 else
                        _trace_payload(rng, clients + windows,
                                       links if i == 0 else ()))
                    for i, h in enumerate(hosts)}
        offsets = {h: (0 if i == 0 else None if rng.random() < 0.2 else
                       int(rng.integers(-10 ** 10, 10 ** 10)))
                   for i, h in enumerate(hosts)}
        _same(tower.merge_traces(copy.deepcopy(payloads), offsets, "h0"),
              jtower.merge_traces(copy.deepcopy(payloads), offsets, "h0"))
        pages = {h: (None if i and rng.random() < 0.2 else {"events": [
            {"seq": int(s), "ts": float(rng.integers(0, 10 ** 6)) / 3,
             "category": "policy", "action": "x",
             **({"mono_ns": int(rng.integers(0, 10 ** 12))}
                if rng.random() < 0.9 else {})}
            for s in range(int(rng.integers(0, 20)))]})
            for i, h in enumerate(hosts)}
        limit = int(rng.integers(1, 40))
        _same(tower.merge_events(copy.deepcopy(pages), offsets, "h0",
                                 limit=limit),
              jtower.merge_events(copy.deepcopy(pages), offsets, "h0",
                                  limit=limit))
        parents = list(rng.choice(clients, int(rng.integers(1, 4))))
        assert tower.synthetic_parent_id(parents) == \
            jtower.synthetic_parent_id(parents)


# ------------------------------------------------ the JAX tests' hand cases


def test_merge_audit_sum_and_recomputed_wilson():
    blocks = {
        "h0": {"sample": 1, "samples": 1000, "oracle_allows": 900,
               "false_denies": 9, "false_allows": 1,
               "fail_open_samples": 2, "dropped_decisions": 5,
               "oracle_errors": 0},
        "h1": {"sample": 1, "samples": 500, "oracle_allows": 400,
               "false_denies": 1, "false_allows": 0,
               "fail_open_samples": 0, "dropped_decisions": 0,
               "oracle_errors": 1},
    }
    m = tower.merge_audit(blocks)
    _same(m, jtower.merge_audit(blocks))
    assert m["samples"] == 1500 and m["oracle_allows"] == 1300
    assert m["false_denies"] == 10 and m["oracle_denies"] == 200
    assert m["false_deny_rate"] == round(10 / 1300, 8)
    lo, hi = wilson_interval(10, 1300)
    assert m["false_deny_wilson95"] == [round(lo, 8), round(hi, 8)]
    lo, hi = wilson_interval(1, 200)
    assert m["false_allow_wilson95"] == [round(lo, 10), round(hi, 10)]
    assert m["per_host"]["h1"]["false_denies"] == 1
    assert tower.merge_audit({}) == {}


def test_merge_consumers_token_join_and_rerank():
    blocks = {
        "h0": {"slots": 16, "occupied": 2, "tracked_mass": 100,
               "top": [{"consumer": "aa", "in_window": 60},
                       {"consumer": "bb", "in_window": 40}]},
        "h1": {"slots": 16, "occupied": 2, "tracked_mass": 100,
               "top": [{"consumer": "cc", "in_window": 70},
                       {"consumer": "aa", "in_window": 30}]},
    }
    m = tower.merge_consumers(blocks, k=2)
    _same(m, jtower.merge_consumers(blocks, k=2))
    assert m["tracked_mass"] == 200
    assert [r["consumer"] for r in m["top"]] == ["aa", "cc"]
    assert m["top"][0]["hosts"] == {"h0": 60, "h1": 30}
    assert m["top"][0]["share"] == round(90 / 200, 6)


def test_merge_slo_pools_counts_not_ratios():
    blocks = {
        "h0": {"objective": 0.999, "windows": {"300s": {
            "span_s": 300, "spans": 10, "spans_slow": 0,
            "decisions": 10, "decisions_bad": 0, "burn_rate": 0.0}}},
        "h1": {"objective": 0.999, "windows": {"300s": {
            "span_s": 300, "spans": 1000, "spans_slow": 0,
            "decisions": 990, "decisions_bad": 99, "burn_rate": 100.0}}},
    }
    m = tower.merge_slo(blocks)
    _same(m, jtower.merge_slo(blocks))
    row = m["windows"]["300s"]
    assert row["decisions"] == 1000 and row["decisions_bad"] == 99
    assert row["availability_bad_fraction"] == round(99 / 1000, 6)
    assert row["burn_rate"] == round((99 / 1000) / 0.001, 3)
    assert row["per_host_burn"] == {"h0": 0.0, "h1": 100.0}


def test_merge_hierarchy_sums_mass_and_takes_min_limits():
    blocks = {
        "h0": {"tenants": {"t": {"in_window": 30, "effective": 100,
                                 "ceiling": 1000, "weight": 2}},
               "global": {"in_window": 50, "effective": 500,
                          "ceiling": 500}},
        "h1": {"tenants": {"t": {"in_window": 20, "effective": 70,
                                 "ceiling": 1000, "weight": 2}},
               "global": {"in_window": 10, "effective": 500,
                          "ceiling": 500}},
    }
    m = tower.merge_hierarchy(blocks)
    _same(m, jtower.merge_hierarchy(blocks))
    t = m["tenants"]["t"]
    assert t["in_window"] == 50 and t["effective"] == 70
    assert t["per_host_in_window"] == {"h0": 30, "h1": 20}
    assert t["per_host_effective"] == {"h0": 100, "h1": 70}
    assert m["global"]["in_window"] == 60


def test_merged_status_names_gaps_and_epoch_splits():
    members = {
        "h0": {"serving": True, "decisions_total": 10,
               "fleet": {"epoch": 3, "owned_ranges": [[0, 16]]},
               "audit": {"sample": 1, "samples": 10, "oracle_allows": 9,
                         "false_denies": 0, "false_allows": 0}},
        "h1": None,
    }
    m = tower.merged_status(members)
    _same(m, jtower.merged_status(members))
    assert m["members"] == 2 and m["reachable"] == 1
    assert m["hosts"]["h1"] == {"reachable": False}
    assert m["epoch"] == 3 and m["epoch_converged"] is True
    split = {"h0": {"fleet": {"epoch": 3}}, "h1": {"fleet": {"epoch": 4}}}
    m = tower.merged_status(split)
    assert m["epoch"] == 4 and m["epoch_converged"] is False


def _payload(spans, links=(), threads=None):
    return {"traceEvents": [
        {"name": s["stage"], "cat": "ratelimiter", "ph": "X", "ts": s["ts"],
         "dur": s.get("dur", 1.0), "pid": 1, "tid": s.get("tid", 7),
         "args": {"trace_id": s["trace_id"]}} for s in spans],
        "otherData": {"links": list(links), "threads": threads or {}}}


def test_merge_traces_aligns_and_rewrites_to_the_client_id():
    a = _payload([{"stage": "io", "ts": 100.0, "trace_id": "aa" * 8}])
    b = _payload([{"stage": "device", "ts": 5000.0, "trace_id": "bb" * 8}],
                 threads={"7": "worker"})
    offs = {"h0": 0, "h1": -4_000_000_000}
    merged = tower.merge_traces({"h0": a, "h1": b}, offs, "h0")
    _same(merged, jtower.merge_traces({"h0": a, "h1": b}, offs, "h0"))
    spans = {e["args"]["host"]: e for e in merged["traceEvents"]
             if e["ph"] == "X"}
    assert spans["h0"]["ts"] == 100.0
    assert spans["h1"]["ts"] == pytest.approx(5000.0 - 4e6)
    T, W = "11" * 8, "22" * 8
    a = _payload([{"stage": "io", "ts": 1.0, "trace_id": T},
                  {"stage": "forward", "ts": 2.0, "trace_id": W}],
                 links=[{"parent": T, "child": W, "t_ns": 0}])
    b = _payload([{"stage": "device", "ts": 3.0, "trace_id": W}])
    merged = tower.merge_traces({"h0": a, "h1": b}, {"h0": 0, "h1": 0},
                                "h0")
    spans = [e for e in merged["traceEvents"] if e["ph"] == "X"]
    assert all(e["args"]["trace_id"] == T for e in spans)
    assert next(e for e in spans if e["name"] == "device")["args"][
        "window_id"] == W
    t2 = "33" * 8
    a = _payload([], links=[{"parent": T, "child": W, "t_ns": 0},
                            {"parent": t2, "child": W, "t_ns": 0}])
    merged = tower.merge_traces({"h0": a, "h1": b}, {"h0": 0, "h1": 0},
                                "h0")
    dev = [e for e in merged["traceEvents"] if e["ph"] == "X"][0]
    assert dev["args"]["trace_id"] == tower.synthetic_parent_id([T, t2])
    assert dev["args"]["trace_parents"] == sorted([T, t2])
    sid = tower.synthetic_parent_id([t2, T])
    assert sid == tower.synthetic_parent_id([T, t2]) and len(sid) == 16


def test_merge_events_tags_aligns_and_sorts():
    pages = {
        "h0": {"events": [{"seq": 1, "ts": 100.0, "mono_ns": 50,
                           "category": "policy", "action": "x"}]},
        "h1": {"events": [{"seq": 9, "ts": 99.0, "mono_ns": 10,
                           "category": "handoff", "action": "y"}]},
        "h2": None,
    }
    offs = {"h0": 0, "h1": 1000, "h2": None}
    m = tower.merge_events(pages, offs, "h0")
    _same(m, jtower.merge_events(pages, offs, "h0"))
    assert [e["host"] for e in m["events"]] == ["h1", "h0"]
    assert m["events"][0]["mono_aligned_ns"] == 1010
    assert m["hosts"]["h2"] == {"reachable": False, "aligned": False}


# --------------------------------------------------------- fan-out engine


class _Core:
    def __init__(self, fmap, me):
        self.map, self.self_id = fmap, me


class _Membership:
    def peer_clock(self, host_id):
        return {"offset_ns": {"h1": 1000, "h2": None}.get(host_id)}


def test_control_tower_fans_out_and_names_gaps(monkeypatch):
    """The tower fetches every peer's declared gateway with the caller's
    bearer, merges its own payloads first, and a peer it cannot reach or
    that declares no gateway is a named gap."""
    fmap = FleetMap.from_dict({"buckets": 12, "epoch": 2, "hosts": [
        {"id": "h0", "host": "127.0.0.1", "port": 1, "http": 8001,
         "ranges": [[0, 4]]},
        {"id": "h1", "host": "127.0.0.1", "port": 2, "http": 8002,
         "ranges": [[4, 8]]},
        {"id": "h2", "host": "127.0.0.1", "port": 3, "ranges": [[8, 12]]}]})
    calls = []
    peer = {"serving": True, "decisions_total": 5,
            "fleet": {"epoch": 2}, "events": [
                {"seq": 1, "ts": 1.0, "mono_ns": 5, "category": "policy",
                 "action": "x"}],
            "traceEvents": [], "otherData": {}}

    def fetch(url, bearer=None, timeout=3.0):
        calls.append((url, bearer, timeout))
        return copy.deepcopy(peer)

    monkeypatch.setattr(tower, "fetch_json", fetch)
    t = tower.ControlTower(_Core(fmap, "h0"), _Membership(),
                           self_health=lambda: {"serving": True,
                                                "decisions_total": 7,
                                                "fleet": {"epoch": 2}},
                           timeout=1.5)
    st = t.fleet_status()
    assert st["members"] == 3 and st["reachable"] == 2
    assert st["hosts"]["h2"] == {"reachable": False}
    assert st["decisions_total"] == 12 and st["generated_by"] == "h0"
    assert calls == [("http://127.0.0.1:8002/healthz", None, 1.5)]
    calls.clear()
    tr = t.fleet_trace("tok")
    assert calls == [("http://127.0.0.1:8002/debug/trace", "tok", 1.5)]
    assert tr["otherData"]["hosts"]["h2"]["reachable"] is False
    calls.clear()
    ev = t.fleet_events(limit=7, category="a b", bearer="tok")
    assert calls == [("http://127.0.0.1:8002/debug/events?tail=7"
                      "&category=a%20b", "tok", 1.5)]
    assert ev["hosts"]["h1"] == {"reachable": True, "aligned": True}
    assert ev["events"][0]["mono_aligned_ns"] == 1005

    def refuse(url, bearer=None, timeout=3.0):
        raise urllib.error.URLError("connection refused")

    monkeypatch.setattr(tower, "fetch_json", refuse)
    st = t.fleet_status()
    assert st["reachable"] == 1 and st["hosts"]["h1"] == {
        "reachable": False}


def test_fetch_json_sends_the_bearer():
    import http.server

    seen = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.headers.get("Authorization"))
            body = b'{"ok": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/x"
        assert tower.fetch_json(url, bearer="tok") == {"ok": True}
        assert tower.fetch_json(url) == {"ok": True}
        assert seen == ["Bearer tok", None]
        assert tower.FETCH_TIMEOUT_S == jtower.FETCH_TIMEOUT_S == 3.0
    finally:
        srv.shutdown()
        th.join(timeout=10)


# ------------------------------------------- the forward lane's trace pins


def _cfg(limit=20):
    base = cs.config3()
    return dataclasses.replace(base, algorithm=base.algorithm.TPU_SKETCH,
                               limit=limit, window=600.0,
                               sketch=dataclasses.replace(
                                   base.sketch, depth=4, width=4096,
                                   sub_windows=6))


def _server_on_thread(limiter):
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    srv = RateLimitServer(limiter, "127.0.0.1", 0)
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(10)
    return srv, loop, t


def _stop(srv, loop, t):
    asyncio.run_coroutine_threadsafe(srv.shutdown(), loop).result(10)
    loop.call_soon_threadsafe(loop.stop)
    t.join(timeout=10)
    loop.close()


class _Hop:
    """Host A: the port's ``FleetForwarder`` over a limiter on the CPU;
    host B: a port asyncio door on a thread, owning half the buckets."""

    def __init__(self, clock):
        from ratelimiter_tpu_torch import create_limiter
        from ratelimiter_tpu_torch.observability.metrics import Registry

        self.cfg = _cfg()
        self.lim_a = create_limiter(self.cfg, clock=clock, device="cpu")
        self.lim_b = create_limiter(self.cfg, clock=clock, device="cpu")
        self.srv = _server_on_thread(self.lim_b)
        fmap = FleetMap.from_dict({"buckets": 32, "epoch": 1, "hosts": [
            {"id": "a", "host": "127.0.0.1", "port": 1,
             "ranges": [[0, 16]]},
            {"id": "b", "host": "127.0.0.1", "port": self.srv[0].port,
             "ranges": [[16, 32]]}]})
        self.core = FleetCore(fmap, "a", prefix=self.cfg.prefix,
                              forward_deadline=30.0, registry=Registry())
        self.fwd = FleetForwarder(self.lim_a, self.core)

    def close(self):
        self.fwd.close()
        _stop(*self.srv)
        self.lim_b.close()


@pytest.fixture
def recorder():
    rec = tracing.enable(4096)
    yield rec
    tracing.disable()


def test_traced_frame_crosses_the_hop(recorder):
    from ratelimiter_tpu_torch import create_limiter

    clock = ManualClock(1000.0)
    hop = _Hop(clock)
    try:
        ids = np.arange(1, 41, dtype=np.uint64)
        owners = hop.core.owners_of_ids(ids)
        assert (owners == 1).any() and (owners == 0).any()
        T = tracing.new_trace_id()
        tracing.set_current(T)
        try:
            out = hop.fwd.allow_ids(ids)
        finally:
            tracing.set_current(0)
        wids = [ln["child"] for ln in recorder.links()
                if ln["parent"] == f"{T:016x}"]
        assert len(wids) == 1
        stages = {s["stage"] for s in recorder.dump()
                  if f"{s['trace_id']:016x}" == wids[0]}
        assert {"io", "forward"} <= stages
        want = np.zeros(40, dtype=bool)
        for host in (0, 1):
            rep = create_limiter(hop.cfg, clock=clock, device="cpu")
            pos = np.nonzero(owners == host)[0]
            want[pos] = rep.allow_ids(ids[pos]).allowed
            rep.close()
        np.testing.assert_array_equal(out.allowed, want)
    finally:
        hop.close()


def test_recorder_off_no_trace_flag_on_wire(monkeypatch):
    assert tracing.RECORDER is None
    seen = []
    orig = p.with_trace
    monkeypatch.setattr(p, "with_trace",
                        lambda frame, tid: seen.append(tid) or orig(frame,
                                                                    tid))
    hop = _Hop(ManualClock(1000.0))
    try:
        hop.fwd.allow_ids(np.arange(1, 41, dtype=np.uint64))
        assert seen == []
    finally:
        hop.close()


def test_untraced_frames_under_recorder_still_get_window_ids(recorder):
    hop = _Hop(ManualClock(1000.0))
    try:
        hop.fwd.allow_ids(np.arange(1, 41, dtype=np.uint64))
        assert recorder.links() == []
        assert any(s["stage"] == "forward" for s in recorder.dump())
    finally:
        hop.close()


# ------------------------------------------ the offline tools' parity pin


def _tool_payloads():
    t1, t2, w1, w2 = "11" * 8, "33" * 8, "22" * 8, "44" * 8
    a = {"traceEvents": [
        {"name": "io", "cat": "ratelimiter", "ph": "X", "ts": 100.0,
         "dur": 2.0, "pid": 1, "tid": 7, "args": {"trace_id": t1}},
        {"name": "forward", "cat": "ratelimiter", "ph": "X", "ts": 101.0,
         "dur": 5.0, "pid": 1, "tid": 7, "args": {"trace_id": w1}}],
        "otherData": {"links": [{"parent": t1, "child": w1, "t_ns": 0},
                                {"parent": t1, "child": w2, "t_ns": 0},
                                {"parent": t2, "child": w2, "t_ns": 1}],
                      "threads": {"7": "io-worker"}}}
    b = {"traceEvents": [
        {"name": "device", "cat": "ratelimiter", "ph": "X", "ts": 5000.0,
         "dur": 3.0, "pid": 1, "tid": 9, "args": {"trace_id": w1}},
        {"name": "device", "cat": "ratelimiter", "ph": "X", "ts": 5010.0,
         "dur": 3.0, "pid": 1, "tid": 9, "args": {"trace_id": w2}}],
        "otherData": {"links": [], "threads": {"9": "dispatch"}}}
    return a, b


def _fake_fetch(health, by_port, urls=None):
    def fetch(url, bearer=None, timeout=10.0):
        if urls is not None:
            urls.append((url, bearer))
        if url.endswith("/healthz") and "8434" in url:
            return copy.deepcopy(health)
        for port, payload in by_port.items():
            if port in url:
                if payload is None:
                    raise urllib.error.URLError("connection refused")
                return copy.deepcopy(payload)
        raise AssertionError(f"unexpected fetch {url}")

    return fetch


@pytest.mark.parametrize("reachable", [True, False])
def test_offline_trace_stitch_equals_the_server_side_merge(monkeypatch,
                                                           reachable):
    from ratelimiter_tpu_torch.tools import fleet_trace

    a, b = _tool_payloads()
    off_b = -4_000_000_000
    health = {"fleet": {
        "self": "a", "peers": {"b": {"mono_offset_ns": off_b}} if reachable
        else {},
        "hosts": {"a": {"addr": "127.0.0.1:9001", "http": 8434},
                  "b": {"addr": "127.0.0.1:9002", "http": 8435}}}}
    urls = []
    monkeypatch.setattr(tower, "fetch_json", _fake_fetch(
        health, {"8434": a, "8435": b if reachable else None}, urls))
    offline = fleet_trace.stitched_offline("http://127.0.0.1:8434", "tok",
                                           10.0)
    server_side = tower.merge_traces(
        {"a": copy.deepcopy(a), "b": copy.deepcopy(b) if reachable
         else None}, {"a": 0, "b": off_b if reachable else None}, "a")
    _same(offline, server_side)
    _same(offline, jtower.merge_traces(
        {"a": copy.deepcopy(a), "b": copy.deepcopy(b) if reachable
         else None}, {"a": 0, "b": off_b if reachable else None}, "a"))
    assert all(bearer == "tok" for u, bearer in urls if "trace" in u)
    if reachable:
        spans = [e for e in offline["traceEvents"] if e["ph"] == "X"]
        single = next(e for e in spans if e["name"] == "device"
                      and "trace_parents" not in e["args"])
        assert single["args"]["trace_id"] == "11" * 8
        assert single["ts"] == pytest.approx(5000.0 + off_b / 1e3)
    else:
        assert offline["otherData"]["hosts"]["b"] == {
            "pid": 1, "reachable": False, "mono_offset_ns": None,
            "aligned": False}


def test_offline_rollup_equals_the_tower_merge(monkeypatch):
    from ratelimiter_tpu_torch.tools import fleet_status

    rng = np.random.default_rng(7)
    ha, hb = _health(rng, "a"), _health(rng, "b")
    ha["fleet"].update({"self": "a", "hosts": {
        "a": {"addr": "127.0.0.1:9001", "http": 8434},
        "b": {"addr": "127.0.0.1:9002", "http": 8435},
        "c": {"addr": "127.0.0.1:9003", "http": None}}})
    monkeypatch.setattr(tower, "fetch_json", _fake_fetch(
        ha, {"8435": hb}))
    got = fleet_status.rollup_offline("http://127.0.0.1:8434", 10.0)
    want = tower.merged_status({"a": ha, "b": hb, "c": None})
    want["generated_by"] = "offline merge via a"
    _same(got, want)


# ------------------------------------------------ two port binaries


def test_control_tower_on_two_port_binaries(tmp_path):
    with deadline(120.0):
        _control_tower_on_two_port_binaries(tmp_path)
    cs.check_no_children()


def _control_tower_on_two_port_binaries(tmp_path):
    base = cs.config3()
    cfg = dataclasses.replace(base, sketch=dataclasses.replace(
        base.sketch, depth=2, width=4096))
    load = cs.FleetLoad(str(tmp_path), n=2)
    try:
        pair = cs.FleetPair(
            str(tmp_path / "m"), cfg, "cpu", http_ports=True,
            flags=cs.CONTROL_FLAGS, boot_timeout=45.0,
            extra=(("--http-policy-token", "ptok"),) * 2)
        try:
            # A move first: every member then has journal events.
            st, body = cs._migrate(pair, 0, 1, [(0, 2)], 30.0)
            assert st == 200 and body["ok"], body
            out = cs.check_control_tower(pair, load, 7)
            assert out["status"]["reachable"] == 2
            assert out["audit_samples"] > 0
            assert "device" in out["traced_frame_stages"]
            h0, h1 = (pair.srv[i].http for i in range(2))
            st, _, _ = cs.http_call(h1, "POST", "/v1/policy?key=vip"
                                    "&limit=500", "ptok")
            assert st == 200
            st, _, evs = cs.http_call(h0, "GET", "/debug/events?fleet=1"
                                      "&category=policy", cs.CONTROL_DEBUG)
            mine = [e for e in evs["events"]
                    if e["action"] == "set-override"]
            assert mine and mine[-1]["host"] == "h1"
            assert mine[-1]["payload"]["limit"] == 500
            assert "key_hash" in mine[-1]["payload"]
            assert "vip" not in json.dumps(mine[-1])
            text = cs.http_call(h0, "GET", "/metrics")[2]
            info = next(ln for ln in text.splitlines()
                        if ln.startswith("rate_limiter_member_info{"))
            for part in ('id="h0"', 'backend="sketch"', 'fleet_epoch="2"',
                         'door="asyncio"'):
                assert part in info, info
            repo, env = cs.child_env()
            trace_out = str(tmp_path / "trace.json")
            r = subprocess.run(
                [sys.executable, "-m",
                 "ratelimiter_tpu_torch.tools.fleet_trace",
                 f"http://127.0.0.1:{h0}", "--token", cs.CONTROL_DEBUG,
                 "-o", trace_out], cwd=repo, env=env, capture_output=True,
                text=True, timeout=60)
            assert r.returncode == 0, r.stdout + r.stderr
            assert "trace ids crossing hosts" in r.stdout
            with open(trace_out, encoding="utf-8") as f:
                assert json.load(f)["traceEvents"]
            r = subprocess.run(
                [sys.executable, "-m",
                 "ratelimiter_tpu_torch.tools.fleet_status",
                 f"http://127.0.0.1:{h1}", "--offline"], cwd=repo, env=env,
                capture_output=True, text=True, timeout=60)
            assert r.returncode == 0, r.stdout + r.stderr
            assert "2/2 members reachable" in r.stdout
            assert "audit (merged over" in r.stdout
        finally:
            pair.close()
    finally:
        load.close()


def test_fleet_routes_answer_as_the_jax_gateway():
    """The fleet hooks wired on the JAX gateway and the port's (the same
    stand-ins on both): /v1/fleet/status read-only and open; ``?fleet=1``
    on /debug/trace and /debug/events behind the debug token, the caller's
    bearer passed to the hook; /v1/fleet/rebalance's token gate, verbs
    and refusals. Every answer (status, headers, body) equal."""
    from tests.test_torch_gateway import GatewayPair

    seen = []

    def rebalance(M, lim):
        def hook(action):
            seen.append(action)
            return ({"ok": False, "reason": "load-gap", "gaps": ["h2"]}
                    if action == "dry-run" else {"ok": True, "a": action})
        return hook

    p = GatewayPair(
        enable_debug=True, debug_token="dt",
        fleet_status=lambda M, lim: (lambda: {"members": 3,
                                              "reachable": 2}),
        fleet_trace=lambda M, lim: (lambda bearer: {
            "traceEvents": [], "otherData": {"bearer": bearer}}),
        fleet_events=lambda M, lim: (
            lambda limit, category, bearer: {
                "events": [], "limit": limit, "category": category,
                "bearer": bearer}),
        fleet_rebalance=rebalance, rebalance_token="rt")
    dt, rt = ({"Authorization": f"Bearer {t}"} for t in ("dt", "rt"))
    try:
        st, _, body = p.both("GET", "/v1/fleet/status")
        assert st == 200 and body == {"members": 3, "reachable": 2}
        assert p.both("GET", "/debug/trace?fleet=1")[0] == 403
        st, _, body = p.both("GET", "/debug/trace?fleet=1", dt)
        assert st == 200 and body["otherData"]["bearer"] == "dt"
        assert body["enabled"] is True
        assert p.both("GET", "/debug/events?fleet=1", rt)[0] == 403
        st, _, body = p.both("GET", "/debug/events?fleet=1&tail=9"
                             "&category=policy", dt)
        assert st == 200 and (body["limit"], body["category"],
                              body["bearer"]) == (9, "policy", "dt")
        assert p.both("GET", "/v1/fleet/rebalance")[0] == 403
        assert p.both("GET", "/v1/fleet/rebalance", dt)[0] == 403
        st, _, body = p.both("GET", "/v1/fleet/rebalance", rt)
        assert st == 200 and body == {"ok": True, "a": "status"}
        assert p.both("POST", "/v1/fleet/rebalance?action=apply",
                      rt)[2] == {"ok": True, "a": "apply"}
        assert p.both("POST", "/v1/fleet/rebalance?action=abort",
                      rt)[0] == 200
        assert p.both("POST", "/v1/fleet/rebalance?action=dry-run",
                      rt)[0] == 409
        assert p.both("POST", "/v1/fleet/rebalance?action=x", rt)[0] == 400
        assert p.both("POST", "/v1/fleet/rebalance", rt)[0] == 400
        assert p.both("DELETE", "/v1/fleet/rebalance", rt)[0] == 405
        assert seen == ["status", "status", "apply", "apply", "abort",
                        "abort", "dry-run", "dry-run"]
    finally:
        p.close()
    # A token without the hook (off a fleet): the unwired 403.
    p = GatewayPair(rebalance_token="rt")
    try:
        assert p.both("GET", "/v1/fleet/rebalance", rt)[0] == 403
    finally:
        p.close()
