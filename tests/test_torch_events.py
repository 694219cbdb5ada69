"""The port's control-plane event journal against the JAX package's.

Tolerance 0, everything compared is text or integers:

* the same emits into a journal of each package, with the wall and
  monotonic clocks replaced by one counter in both, give equal records,
  equal cursor pages (``read`` with ``after``/``limit``/``category``,
  ``tail``), equal ``status`` and equal spill files (names, bytes, the
  rotation past the segment bound and the replay into a new journal);
* the port's door journals the policy frames (POLICY_SET, POLICY_DEL,
  RESET) as the JAX door does (``actor="binary"``, ``key#`` tokens);
* the port's AIMD controller journals the hot-tenant storm (tightens,
  relaxes, and with an audit signal over the veto bound, the vetoes)
  as the JAX controller does, each tick's correlation id drawn from a
  replaced ``new_trace_id`` in both packages.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.evaluation import scenarios
from ratelimiter_tpu.hierarchy import AIMDController as JaxController
from ratelimiter_tpu.hierarchy import AIMDGains as JaxGains
from ratelimiter_tpu.observability import events as jevents
from ratelimiter_tpu.observability import metrics as jmetrics
from ratelimiter_tpu.observability import tracing as jtracing
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu.serving.server import RateLimitServer as JaxServer
from ratelimiter_tpu_torch.hierarchy import AIMDController, AIMDGains
from ratelimiter_tpu_torch.observability import events as tevents
from ratelimiter_tpu_torch.observability import metrics as tmetrics
from ratelimiter_tpu_torch.observability import tracing as ttracing
from ratelimiter_tpu_torch.ops.hashing import key_token
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.server import RateLimitServer

T0 = 1_700_000_000.0


@pytest.fixture
def clocks(monkeypatch):
    """time.time and time.monotonic_ns as counters, restarted by
    ``restart()`` before each package runs (both modules read the shared
    ``time`` module at call time)."""
    state = {}

    def restart():
        state["wall"] = itertools.count()
        state["mono"] = itertools.count()

    restart()
    monkeypatch.setattr(time, "time",
                        lambda: T0 + 0.25 * next(state["wall"]))
    monkeypatch.setattr(time, "monotonic_ns",
                        lambda: 10 ** 9 + 1000 * next(state["mono"]))
    return restart


def _emit_all(journal) -> None:
    rng = np.random.default_rng(3)
    cats = ["policy", "tenant", "controller", "quarantine", "custom"]
    for i in range(60):
        journal.record(cats[int(rng.integers(0, len(cats)))],
                       f"act-{i % 7}", actor=f"a{i % 3}",
                       corr=int(rng.integers(0, 1 << 62)) if i % 4 else 0,
                       severity="warning" if i % 5 == 0 else "info",
                       payload={"i": i, "key_hash": f"key#{i:016x}",
                                "x": [i, i * 0.5], "none": None}
                       if i % 6 else None)


def _journal_run(ev, metrics, spill_dir):
    reg = metrics.Registry()
    j = ev.EventJournal(32, host="h:1", registry=reg, spill_dir=spill_dir,
                        spill_segment_bytes=4096, spill_segments=3)
    _emit_all(j)
    pages = [j.read(after, limit, category)
             for after, limit, category in ((0, 10, None), (30, 5, None),
                                            (40, 100, "policy"),
                                            (59, 3, None), (60, 4, None),
                                            (0, 1000, "custom"))]
    tails = [j.tail(5), j.tail(100, "tenant")]
    status = j.status()
    status["spill"].pop("dir")
    j.close()
    files = {}
    for name in sorted(os.listdir(spill_dir)):
        with open(os.path.join(spill_dir, name), "rb") as fh:
            files[name] = fh.read()
    j2 = ev.EventJournal(16, spill_dir=spill_dir)
    replay = j2.read(0, 100)
    status2 = j2.status()
    status2["spill"].pop("dir")
    j2.close()
    return pages, tails, status, files, replay, status2, reg.render()


def test_journal_records_pages_and_spill_match_jax(clocks, tmp_path):
    clocks()
    want = _journal_run(jevents, jmetrics, str(tmp_path / "jax"))
    clocks()
    got = _journal_run(tevents, tmetrics, str(tmp_path / "port"))
    names = ("pages", "tails", "status", "spill files", "replay",
             "status after replay", "registry")
    for name, g, w in zip(names, got, want):
        assert g == w, name
    pages, _, status, files, replay, _, _ = got
    assert pages[0]["truncated"] and len(files) == 3
    assert status["spill"]["segments"] == 3
    assert replay["events"][0]["replayed"] is True


def test_module_seam_matches_jax(clocks, tmp_path):
    """``enable``/``emit``/``get``/``disable``: the module-global journal
    of each package records the same events; emit is a no-op when off."""
    out = []
    for ev in (jevents, tevents):
        clocks()
        ev.disable()
        ev.emit("policy", "reset", actor="x")
        assert ev.get() is None
        j = ev.enable(16, host="h")
        ev.emit("policy", "reset", actor="x", payload={"k": 1})
        ev.emit("tenant", "assign", corr=5)
        out.append(j.read())
        ev.disable()
        assert ev.get() is None
    assert out[0] == out[1]


async def _policy_frames(server_cls, limiter, proto):
    srv = server_cls(limiter, "127.0.0.1", 0)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
    replies = []
    try:
        for frame in (proto.encode_policy_set(1, "api-cust-7", 250, 2.0),
                      proto.encode_policy_key(proto.T_POLICY_DEL, 2,
                                              "api-cust-7"),
                      proto.encode_policy_key(proto.T_POLICY_DEL, 3,
                                              "nobody"),
                      proto.encode_reset(4, "ünï:42")):
            writer.write(frame)
            await writer.drain()
            hdr = await reader.readexactly(proto.HEADER_SIZE)
            replies.append(hdr + await reader.readexactly(
                proto.parse_header(hdr)[0] - 9))
    finally:
        writer.close()
        await writer.wait_closed()
        await srv.shutdown()
    return replies


def test_door_policy_frames_journal_like_the_jax_door(clocks):
    out = []
    for pkg, ev, server, proto in ((R, jevents, JaxServer, jp),
                                   (T, tevents, RateLimitServer, tp)):
        clocks()
        lim = pkg.create_limiter(
            pkg.Config(algorithm=pkg.Algorithm.SLIDING_WINDOW, limit=5,
                       window=60.0), backend="exact")
        j = ev.enable(64, host="127.0.0.1:8432")
        try:
            replies = asyncio.run(_policy_frames(server, lim, proto))
            events = j.read()["events"]
        finally:
            ev.disable()
            lim.close()
        out.append((replies, [{k: v for k, v in e.items()
                               if k not in ("ts", "mono_ns")}
                              for e in events]))
    assert out[0] == out[1]
    actions = [(e["action"], e["actor"], e["payload"]) for e in out[1][1]]
    assert actions == [
        ("set-override", "binary", {"key_hash": key_token("api-cust-7"),
                                    "limit": 250, "window_scale": 2.0}),
        ("delete-override", "binary", {"key_hash": key_token("api-cust-7"),
                                       "deleted": True}),
        ("delete-override", "binary", {"key_hash": key_token("nobody"),
                                       "deleted": False}),
        ("reset", "binary", {"key_hash": key_token("ünï:42")})]


def _storm(M, Ctl, Gains, audit_status=None):
    cfg = M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=100_000,
                   window=60.0,
                   sketch=M.SketchParams(depth=3, width=1 << 12,
                                         sub_windows=4,
                                         **({"kernels": "jnp"} if M is R
                                            else {})),
                   hierarchy=M.HierarchySpec(tenants=8, global_limit=1200))
    clock = M.ManualClock(T0)
    kw = {"backend": "sketch"} if M is R else {"device": "cpu"}
    lim = M.create_limiter(cfg, clock=clock, **kw)
    lim.set_tenant("attacker", 1000, weight=1, floor=50)
    lim.set_tenant("victim", 1000, weight=6, floor=50)
    for i in range(40):
        lim.assign_tenant(f"atk{i}", "attacker")
    for i in range(8):
        lim.assign_tenant(f"vic{i}", "victim")
    reg = (jmetrics if M is R else tmetrics).Registry()
    ctl = Ctl(lim, interval=999.0, audit_status=audit_status, registry=reg,
              gains=Gains(decrease_factor=0.7, increase_fraction=0.2,
                          cooldown_s=0.0))
    res = scenarios.run_hot_tenant_storm(lim, clock, controller=ctl,
                                         batch=160, frames_per_phase=6)
    lim.close()
    return res.as_dict()


@pytest.mark.parametrize("veto", [False, True], ids=["moves", "vetoes"])
def test_controller_journals_like_the_jax_controller(clocks, monkeypatch,
                                                     veto):
    audit = ((lambda: {"false_deny_wilson95": [0.01, 0.3]}) if veto
             else None)
    out = []
    for M, Ctl, Gains, ev, tr in ((R, JaxController, JaxGains, jevents,
                                   jtracing),
                                  (T, AIMDController, AIMDGains, tevents,
                                   ttracing)):
        clocks()
        ids = itertools.count(0x1000, 0x11)
        monkeypatch.setattr(tr, "new_trace_id", lambda: next(ids))
        j = ev.enable(4096)
        try:
            res = _storm(M, Ctl, Gains, audit)
            events = j.read(0, 4096)["events"]
        finally:
            ev.disable()
        out.append((res, [{k: v for k, v in e.items()
                           if k not in ("ts", "mono_ns")} for e in events]))
    assert out[0] == out[1]
    events = out[1][1]
    actions = {e["action"] for e in events}
    if veto:
        assert actions == {"tighten-vetoed"}
    else:
        assert {"tighten", "relax"} <= actions
    # One correlation id a tick: an id's events are contiguous.
    seen, last = set(), None
    for e in events:
        assert e["corr"] and (e["corr"] == last or e["corr"] not in seen)
        seen.add(e["corr"])
        last = e["corr"]


def test_binary_journals_policy_frames_and_controller_moves():
    """chip_smoke.py's (d) at a small size on the CPU: ``python -m
    ratelimiter_tpu_torch.serving --event-journal-dir D`` journals
    POLICY_SET, POLICY_DEL and RESET in order with key tokens, and the
    tenant binary with --controller journals free's tighten under a
    storm, one correlation id a tick."""
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=100,
                   window=60.0, sketch=T.SketchParams(depth=2, width=1024,
                                                      sub_windows=60))
    out = chip_smoke.check_journal_door(cfg, device="cpu")
    assert out["policy_events"] == 3 and out["controller_events"] >= 1
