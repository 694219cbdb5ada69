"""The port binary's /healthz blocks, member identity and /metrics
families against the JAX binary's, tolerance 0.

* Each /healthz block function of both binaries (serving/__main__.py:
  ``_envelope_health``, ``_debt_slab_health``, ``_consumers_health``,
  ``_audit_health``, ``_slo_health``, ``_hierarchy_health``,
  ``_events_health``, and the persistence manager's ``status``) runs over
  a JAX limiter (its jnp path) and a port limiter on the CPU that took
  the same seeded traffic on one clock, each under its package's
  ``MetricsDecorator``: the windowed sketch with the side table (CU and
  vanilla), the token bucket, and the tenant hierarchy with its AIMD
  controller reading the SLO tracker and the auditor. Every cell runs
  the auditor at sample 1 with its twin, fed every decision as the
  batcher's tap feeds it, the SLO tracker and the event journal; two
  cells run under the durable wrapper. The dict the gateway's /healthz
  assembles from them, and ``/debug/audit``'s payload, must be equal.
* The ``member`` block and its ``rate_limiter_member_info`` gauge, built
  by both binaries from the same command line.
* Both binaries run as child processes with the same flags (the JAX one
  with ``--no-prewarm``: its prewarm decides on the live limiter, see
  ROADMAP C14) and take the same HTTP requests and binary frames, one at
  a time: /metrics must carry the same families, the transport, writev
  and identity gauges the same samples, and /healthz the same blocks.
  Only the SLO block's latency-derived fields (each process times its
  own dispatches) are held to their shape instead of their values.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.observability import audit as jaudit
from ratelimiter_tpu.observability import events as jevents
from ratelimiter_tpu.observability import metrics as jm
from ratelimiter_tpu.observability import slo as jslo
from ratelimiter_tpu.observability.decorators import (
    MetricsDecorator as JMetrics,
)
from ratelimiter_tpu.persistence import PersistenceManager as JManager
from ratelimiter_tpu.serving import __main__ as jbin
from ratelimiter_tpu_torch.observability import audit as taudit
from ratelimiter_tpu_torch.observability import events as tevents
from ratelimiter_tpu_torch.observability import metrics as tm
from ratelimiter_tpu_torch.observability import slo as tslo
from ratelimiter_tpu_torch.observability.decorators import (
    MetricsDecorator as TMetrics,
)
from ratelimiter_tpu_torch.persistence import PersistenceManager as TManager
from ratelimiter_tpu_torch.serving import __main__ as tbin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
SIDES = ((R, jbin, jaudit, jevents, jm, jslo, JMetrics, JManager),
         (T, tbin, taudit, tevents, tm, tslo, TMetrics, TManager))


class _FixedTime:
    """A ``time`` module whose clocks stand still (the snapshotter's
    wall-clock ages and durations, the SLO tracker's samples)."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(autouse=True)
def _globals(monkeypatch):
    clock = _FixedTime()
    for mod in ("ratelimiter_tpu.persistence.snapshotter",
                "ratelimiter_tpu_torch.persistence.snapshotter",
                "ratelimiter_tpu.observability.slo",
                "ratelimiter_tpu_torch.observability.slo"):
        monkeypatch.setattr(f"{mod}.time", clock)
    # Each binary registers the controller's and the identity gauges on
    # its package's default registry.
    monkeypatch.setattr(jm, "DEFAULT", jm.Registry())
    monkeypatch.setattr(tm, "DEFAULT", tm.Registry())
    for mod in (jaudit, taudit, jevents, tevents):
        mod.disable()
    yield clock
    for mod in (jaudit, taudit, jevents, tevents):
        mod.disable()


CELLS = {
    "windowed-cu-hh": dict(algorithm="SLIDING_WINDOW", hh_slots=64,
                           durable=True),
    "fixed-vanilla-hh": dict(algorithm="FIXED_WINDOW", hh_slots=32,
                             conservative=False),
    "bucket": dict(algorithm="TOKEN_BUCKET", durable=True),
    "tenants": dict(algorithm="SLIDING_WINDOW", tenants=True),
}
TENANT_FLAGS = ["--tenants", "8", "--global-limit", "300",
                "--tenant", "gold=200:3:20", "--tenant", "free=60:1",
                "--assign", "user:1=gold", "--assign", "user:2=free",
                "--controller", "--controller-interval", "1"]


def _config(M, cell: dict, d=None):
    sketch = dict(depth=2, width=512, sub_windows=6,
                  hh_slots=cell.get("hh_slots", 0),
                  conservative_update=cell.get("conservative", True))
    if M is R:
        sketch["kernels"] = "jnp"
    kw = {}
    if cell.get("tenants"):
        kw["hierarchy"] = M.HierarchySpec(tenants=8, global_limit=300)
    if d is not None:
        kw["persistence"] = M.PersistenceSpec(dir=d)
    return M.Config(algorithm=M.Algorithm[cell["algorithm"]], limit=12,
                    window=30.0, sketch=M.SketchParams(**sketch), **kw)


class Side:
    """One package's stack: its limiter under MetricsDecorator (and the
    durable wrapper), the auditor, the SLO tracker, the journal, the
    hierarchy and controller its binary builds."""

    def __init__(self, pkg, cell: dict, tmp_path):
        (M, self.B, self.audit, self.events, metrics, slo, Metrics,
         Manager) = pkg
        self.M = M
        self.clock = M.ManualClock(T0)
        d = (str(tmp_path / M.__name__) if cell.get("durable") else None)
        cfg = _config(M, cell, d)
        self.reg = metrics.Registry()
        kw = {"backend": "sketch"} if M is R else {"device": "cpu"}
        lim = Metrics(M.create_limiter(cfg, clock=self.clock, **kw),
                      registry=self.reg)
        self.persist = None
        if d is not None:
            self.persist = Manager(cfg.persistence,
                                   registry=metrics.Registry())
            lim = self.persist.wrap(lim)
            self.persist.attach([lim])
            self.persist.recover()
        self.lim = lim
        self.events.enable(64, host="127.0.0.1:8432")
        extra = {} if M is R else {"device": "cpu"}
        self.auditor = self.audit.enable(
            cfg, sample=1, n_slices=1, include_twin=True,
            twin_width=1 << 14, registry=self.reg, start=False,
            live_config=lambda: lim.config, **extra)
        self.slo = slo.SloBurnTracker(self.reg)
        self.slo.attach()
        self.hier = self.controller = None
        if cell.get("tenants"):
            argv = ["--limit", "12"] + TENANT_FLAGS
            if M is R:
                args = jbin.build_parser().parse_args(argv)
                self.hier, self.controller = jbin._setup_hierarchy(
                    args, cfg, [lim], slo_tracker=self.slo,
                    auditor=self.auditor, fleet_membership=None)
            else:
                args = tbin.parse_args(argv)
                self.hier, self.controller = tbin.setup_hierarchy(
                    args, cfg, [lim], slo_tracker=self.slo,
                    auditor=self.auditor)

    def health(self) -> dict:
        B = self.B
        self.auditor.process_pending()
        out = {**B._envelope_health([self.lim]),
               **B._debt_slab_health([self.lim]),
               **B._consumers_health([self.lim]),
               **B._audit_health(),
               **B._slo_health(self.slo),
               **B._hierarchy_health(self.hier, self.controller)}
        if B is jbin:
            out.update(jbin._lease_health(None))
        out.update(B._events_health())
        if self.persist is not None:
            out.update(self.persist.status())
        return out

    def audit_status(self) -> dict:
        """/debug/audit: the port binary's ``make_audit_status``; the JAX
        binary's closure of the same name, spelled out."""
        self.auditor.process_pending()
        if self.B is tbin:
            return tbin.make_audit_status(self.auditor, self.slo,
                                          [self.lim])()
        out = self.auditor.status()
        out.update(jbin._consumers_health([self.lim]))
        out.update(jbin._slo_health(self.slo))
        return out

    def close(self) -> None:
        self.slo.detach()
        if self.persist is not None:
            self.persist.stop()
        self.lim.close()


def _drive(sides, rng, steps: int) -> None:
    """Seeded traffic on both sides: string batches (a hot key, the tenant
    assignments), single decisions, an override, a reset, the journal's
    events, the SLO histograms and breach counter, each auditor fed every
    decision as the batcher's tap feeds it, controller ticks."""
    keys = [f"user:{i}" for i in range(40)]
    fams = [(s.reg.histogram("rate_limiter_stage_seconds",
                             buckets=(0.001, 0.01, 0.025, 0.1, 1.0)),
             s.reg.counter("rate_limiter_server_slo_breach_decisions_total"))
            for s in sides]
    for step in range(steps):
        b = int(rng.integers(4, 40))
        batch = [keys[0] if rng.random() < 0.3 else
                 keys[int(rng.zipf(1.3)) % len(keys)] for _ in range(b)]
        ns = rng.integers(1, 3, size=b).astype(np.int64)
        lat = rng.choice([0.0005, 0.005, 0.05, 0.5], size=4)
        breach = bool(rng.random() < 0.2)
        dt = float(rng.choice([0.3, 1.7, 4.0]))
        for s, (hist, breaches) in zip(sides, fams):
            now = s.clock.now()
            res = s.lim.allow_batch(batch, [int(n) for n in ns])
            s.auditor.offer_keys(batch, ns, now, res)
            r1 = s.lim.allow_n(keys[step % 7], 1)
            one = s.M.core.types.BatchResult(
                allowed=np.array([r1.allowed]), limit=r1.limit,
                remaining=np.array([r1.remaining]),
                retry_after=np.array([r1.retry_after]),
                reset_at=np.array([r1.reset_at]))
            s.auditor.offer_keys([keys[step % 7]], None, now, one)
            for x in lat:
                hist.observe(float(x), stage="device")
            if breach:
                breaches.inc(float(b))
            if step == 3:
                s.lim.set_override("user:5", 3)
                s.events.emit("policy", "set-override", actor="binary",
                              payload={"key": "key#5", "limit": 3})
            if step == 6:
                s.lim.reset(keys[0])
                s.events.emit("policy", "reset", actor="binary",
                              payload={"key": "key#0"})
            if step % 4 == 3:
                s.slo.sample()
                if s.controller is not None:
                    s.controller.tick(now=s.clock.now())
            s.clock.advance(dt)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_health_blocks_equal_jax(cell, tmp_path, _globals):
    spec = CELLS[cell]
    sides = [Side(pkg, spec, tmp_path) for pkg in SIDES]
    try:
        _drive(sides, np.random.default_rng(len(cell)), 24)
        for s in sides:
            s.slo.sample()
        if spec.get("durable"):
            for s in sides:
                s.persist.snapshot_now()
            _globals.t += 2.5
        j, t = (s.health() for s in sides)
        assert t == j
        assert t["audit"]["samples"] > 0
        assert "slo" in t and "events" in t
        assert ("consumers" in t) is bool(spec.get("hh_slots"))
        assert ("debt_slab" in t) is (spec["algorithm"] == "TOKEN_BUCKET")
        assert ("hierarchy" in t) is bool(spec.get("tenants"))
        assert ("persistence" in t) is bool(spec.get("durable"))
        if spec.get("tenants"):
            assert t["hierarchy"]["controller"]["ticks"] > 0
        j, t = (s.audit_status() for s in sides)
        assert t == j
        # The registries hold the audit, SLO and consumer gauges beside
        # MetricsDecorator's families; its latency histogram is timed on
        # the wall clock.
        j, t = ([line for line in s.reg.render().splitlines()
                 if "rate_limiter_latency_seconds" not in line]
                for s in sides)
        assert t == j
        assert any(line.startswith("rate_limiter_audit_samples ")
                   for line in t)
    finally:
        for s in sides:
            s.close()


def test_member_info_and_gauge_equal_jax():
    argv = ["--host", "127.0.0.1", "--port", "8432", "--backend", "sketch",
            "--algorithm", "sliding_window"]
    jinfo = jbin._make_member_info(jbin.build_parser().parse_args(argv),
                                   None)
    tinfo, _ = tbin.make_member_info(tbin.parse_args(argv))
    assert tinfo() == jinfo() == {
        "self": "127.0.0.1:8432", "backend": "sketch",
        "algorithm": "sliding_window", "door": "asyncio", "abi": "py",
        "fleet_epoch": None}
    text = tm.DEFAULT.render()
    assert text == jm.DEFAULT.render()
    assert ('rate_limiter_member_info{abi="py",algorithm="sliding_window",'
            'backend="sketch",door="asyncio",fleet_epoch="-",'
            'id="127.0.0.1:8432"} 1') in text


# ------------------------------------------------- the two binaries, live


def _spawn(module: str, flags: list):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                  if x])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0", "--http-port", "0",
         *flags], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines: list = []
    found = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                found.set()
        found.set()

    threading.Thread(target=read, daemon=True).start()
    if not found.wait(240) or not lines or \
            not lines[-1].startswith("serving"):
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"{module} did not start: "
                             + "".join(lines[-20:]))
    line = lines[-1]
    port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
    return proc, port, int(line.rsplit("http:", 1)[1])


def _get(port: int, path: str, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _families(text: str) -> list:
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE "))


def _samples(text: str, prefix: str) -> list:
    return sorted(line for line in text.splitlines()
                  if line.startswith(prefix))


#: The SLO block's fields measured on each process's own clock.
_SLO_TIMED = ("latency_bad_fraction", "burn_rate", "span_s", "spans_slow")


def _slo_untimed(block: dict) -> dict:
    out = {k: v for k, v in block.items() if k != "windows"}
    out["windows"] = {w: {k: (v if k not in _SLO_TIMED else type(v))
                          for k, v in wb.items()}
                      for w, wb in block["windows"].items()}
    return out


def test_binaries_metrics_and_healthz_equal_jax():
    sys.path.insert(0, REPO)
    import chip_smoke
    from ratelimiter_tpu_torch.serving import protocol as p

    flags = ["--algorithm", "sliding_window", "--limit", "5", "--window",
             "60", "--sketch-depth", "2", "--sketch-width", "1024",
             "--sub-windows", "6", "--hh-slots", "64", "--debug-trace",
             "--http-policy-token", "pt", "--audit", "--audit-sample", "1",
             "--audit-twin"]
    procs, answers = [], []
    try:
        for module, extra in (("ratelimiter_tpu.serving",
                               ["--kernels", "jnp", "--no-prewarm"]),
                              ("ratelimiter_tpu_torch.serving",
                               ["--device", "cpu"])):
            proc, port, http = _spawn(module, flags + extra)
            procs.append(proc)
            client = chip_smoke.DoorClient(port)
            try:
                got = []
                for i in range(6):
                    st, hdrs, _ = _get(http, f"/v1/allow?key=k{i % 3}&n=2")
                    got.append((st, hdrs.get("X-RateLimit-Remaining")))
                    _, body = client.call(p.encode_allow_n, f"k{i % 4}", 1)
                    got.append(p.parse_result(body).allowed)
                    _, body = client.call(
                        p.encode_allow_hashed,
                        np.arange(i, i + 16, dtype=np.uint64))
                    got.append(p.parse_result_hashed(body).allowed.tolist())
                assert _get(http, "/v1/policy?key=k1&limit=9")[0] == 403
                for _ in range(200):
                    aud = json.loads(_get(http, "/debug/audit")[2])
                    if aud["samples"] == 6 * (1 + 1 + 16):
                        break
                    time.sleep(0.05)
                health = json.loads(_get(http, "/healthz")[2])
                text = _get(http, "/metrics")[2].decode()
            finally:
                client.close()
            answers.append((got, health, text))
        (jgot, jhealth, jtext), (tgot, thealth, ttext) = answers
        assert tgot == jgot
        assert _families(ttext) == _families(jtext)
        for prefix in ("rate_limiter_transport_connections",
                       "rate_limiter_net_writev_frames",
                       "rate_limiter_member_info", "rate_limiter_shm_"):
            assert _samples(ttext, prefix) == _samples(jtext, prefix)
        assert int(thealth["audit"]["samples"]) == 6 * (1 + 1 + 16)
        jslo_block, tslo_block = jhealth.pop("slo"), thealth.pop("slo")
        assert _slo_untimed(tslo_block) == _slo_untimed(jslo_block)
        assert thealth == jhealth
    finally:
        for proc in procs:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
