"""The fleet's placement brain in the port (``ratelimiter_tpu_torch/
placement/planner.py`` and ``executor.py``), held to the JAX package on
the CPU.

* ``plan_moves``: byte-identical to the JAX planner's
  (``json.dumps(plan.to_dict(), sort_keys=True)``, the plan id included)
  on 200 seeded cases (maps of 2-5 hosts and 8-64 buckets, rates with
  hot spots and zeros, dead hosts, frozen sets, knobs, seeds) and on the
  JAX ``TestPlanner`` cases;
* the ``RebalanceController`` over the port's in-process fleet on the
  CPU (``chip_smoke.control_hosts``: three members, frames delivered by
  direct calls, moves restored on the CPU): one correlation id a plan,
  never over-admission under kill-during-handoff at every phase, the
  unreachable-peer skip, the observatory's veto and the AIMD backoff,
  the operator's abort hold, the five metric families; the same seeded
  hotspot through the JAX controller and the port's executes the same
  moves and ends on the same map; decisions are the same with and
  without the slab and the controller (the off pin);
* the binary: the rebalance on three port members on the CPU
  (``chip_smoke.check_control_rebalance``), the fleet routes and their
  token gates on both doors, and ``tools/fleet_rebalance.py`` against a
  port member, under one timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from ratelimiter_tpu.fleet import config as jfc
from ratelimiter_tpu.placement import planner as jplanner
from ratelimiter_tpu_torch.fleet import config as tfc
from ratelimiter_tpu_torch.observability import events
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.placement import (
    LoadSlab,
    PlannerKnobs,
    RebalanceController,
    plan_moves,
)
from ratelimiter_tpu_torch.placement import planner as tplanner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


# ---------------------------------------------------------------- planner


def _seeded_case(rng):
    """A map of 2-5 hosts over 8-64 buckets (each host 1-3 contiguous
    ranges), a rate vector with hot spots and zeros, the alive set, a
    frozen set, knobs and a seed."""
    n = int(rng.integers(2, 6))
    buckets = int(rng.integers(max(8, 2 * n), 65))
    k = min(buckets, n * int(rng.integers(1, 4)))
    cuts = np.sort(rng.choice(np.arange(1, buckets), size=k - 1,
                              replace=False))
    edges = [0, *cuts.tolist(), buckets]
    owner = rng.permutation(np.arange(k) % n)
    hosts = [{"id": f"h{h}", "host": "10.0.0.1", "port": 9000 + h,
              "ranges": [[edges[i], edges[i + 1]] for i in range(k)
                         if owner[i] == h],
              "successor": f"h{(h + 1) % n}"} for h in range(n)]
    d = {"buckets": buckets, "epoch": int(rng.integers(1, 9)),
         "hosts": hosts}
    rate = rng.exponential(5.0, buckets)
    rate[rng.random(buckets) < 0.3] = 0.0
    for _ in range(int(rng.integers(0, 4))):
        lo = int(rng.integers(0, buckets))
        rate[lo:lo + int(rng.integers(1, 6))] *= rng.uniform(5, 200)
    rate = np.round(rate, int(rng.integers(0, 7)))
    alive = [h["id"] for h in hosts if rng.random() > 0.2]
    frozen = rng.choice(buckets, size=int(rng.integers(0, buckets // 2)),
                        replace=False).tolist()
    knobs = dict(max_moves=int(rng.integers(0, 5)),
                 trigger_ratio=float(rng.choice([1.0, 1.2, 1.4, 2.0])),
                 target_ratio=float(rng.choice([1.0, 1.05, 1.15])),
                 min_gain=float(rng.choice([0.0, 0.02, 0.1])),
                 window_overshoot=float(rng.choice([1.0, 1.25, 2.0])),
                 min_residency_s=float(rng.choice([0.0, 60.0])))
    return d, rate, alive, frozen, knobs, int(rng.integers(0, 1 << 31))


def _plans(d, rate, alive, frozen, knobs, seed):
    t = plan_moves(tfc.FleetMap.from_dict(d), rate, alive=alive,
                   frozen=frozen, knobs=PlannerKnobs(**knobs), seed=seed)
    j = jplanner.plan_moves(jfc.FleetMap.from_dict(d), rate, alive=alive,
                            frozen=frozen,
                            knobs=jplanner.PlannerKnobs(**knobs), seed=seed)
    return t, j


@pytest.mark.parametrize("chunk", range(25))
def test_plan_moves_byte_identical_to_jax(chunk):
    rng = np.random.default_rng(1000 + chunk)
    reasons = set()
    for _ in range(8):
        t, j = _plans(*_seeded_case(rng))
        assert json.dumps(t.to_dict(), sort_keys=True) == json.dumps(
            j.to_dict(), sort_keys=True)
        assert t.plan_id == j.plan_id and t.corr == j.corr
        reasons.add(t.reason)
    assert reasons


def test_seeded_cases_reach_every_outcome():
    """The 200 cases above plan moves and stop for each reason."""
    seen = set()
    for chunk in range(25):
        rng = np.random.default_rng(1000 + chunk)
        for _ in range(8):
            t, _ = _plans(*_seeded_case(rng))
            seen.add(t.reason.replace("planned-", ""))
    assert {"planned", "within-band", "single-host"} <= seen
    assert seen & {"cooldown", "no-gain", "converged", "no-eligible-mass"}


def _map3(buckets=48):
    return tfc.affine_map([("127.0.0.1", 7001), ("127.0.0.1", 7002),
                           ("127.0.0.1", 7003)], buckets=buckets)


def _hot(buckets, lo, hi, hot=100.0, base=1.0):
    rate = np.full(buckets, base, dtype=np.float64)
    rate[lo:hi] = hot
    return rate


def _same_as_jax(m, rate, **kw):
    """The port's plan, after holding it byte-identical to the JAX one."""
    knobs = kw.pop("knobs", None)
    jm = jfc.FleetMap.from_dict(m.to_dict())
    t = plan_moves(m, rate, knobs=knobs, **kw)
    j = jplanner.plan_moves(jm, rate, knobs=(
        jplanner.PlannerKnobs(**dataclasses.asdict(knobs)) if knobs
        else None), **kw)
    assert json.dumps(t.to_dict(), sort_keys=True) == json.dumps(
        j.to_dict(), sort_keys=True)
    return t


class TestPlanner:
    def test_same_inputs_byte_identical_plan(self):
        m, rate = _map3(), _hot(48, 0, 8)
        alive = {"h0", "h1", "h2"}
        dumps = {json.dumps(_same_as_jax(m, rate, alive=alive, frozen={40},
                                         seed=7).to_dict(), sort_keys=True)
                 for _ in range(3)}
        assert len(dumps) == 1
        assert _same_as_jax(m, rate, alive=alive, frozen={40},
                            seed=8).plan_id != _same_as_jax(
            m, rate, alive=alive, frozen={40}, seed=7).plan_id

    def test_hotspot_plan_reduces_imbalance_below_target(self):
        p = _same_as_jax(_map3(), _hot(48, 0, 8), alive={"h0", "h1", "h2"})
        assert p.imbalance_before >= 2.0
        assert p.moves and p.reason == "planned"
        assert p.imbalance_projected <= p.knobs["target_ratio"]
        assert all(mv["from"] == "h0" for mv in p.moves)
        assert len(p.moves) <= p.knobs["max_moves"]
        assert f"{p.corr:016x}" == p.plan_id

    def test_within_band_and_single_host_do_not_plan(self):
        m = _map3()
        p = _same_as_jax(m, np.ones(48), alive={"h0", "h1", "h2"})
        assert p.reason == "within-band" and not p.moves
        solo = _same_as_jax(m, _hot(48, 0, 8), alive={"h0"})
        assert solo.reason == "single-host" and not solo.moves

    def test_dead_hosts_never_donate_or_receive(self):
        p = _same_as_jax(_map3(), _hot(48, 0, 8), alive={"h0", "h1"})
        assert p.moves
        assert all("h2" not in (mv["to"], mv["from"]) for mv in p.moves)

    def test_fully_frozen_donor_cannot_plan(self):
        p = _same_as_jax(_map3(), _hot(48, 0, 8), alive={"h0", "h1", "h2"},
                         frozen=set(range(16)))
        assert not p.moves and p.reason == "cooldown"

    def test_single_hot_bucket_over_cap_is_still_movable(self):
        rate = np.full(48, 10.0)
        rate[3] = 200.0
        rate[16:] = 1.0
        p = _same_as_jax(_map3(), rate, alive={"h0", "h1", "h2"},
                         frozen=set(range(16)) - {3})
        assert p.moves[0]["from"] == "h0" and p.moves[0]["range"] == [3, 4]

    def test_plan_applies_on_real_map_transitions(self):
        m = _map3()
        p = _same_as_jax(m, _hot(48, 0, 8), alive={"h0", "h1", "h2"},
                         knobs=PlannerKnobs(max_moves=4))
        work = m
        for mv in p.moves:
            work = work.move_ranges([tuple(mv["range"])], mv["from"],
                                    mv["to"])
        work.validate()
        assert work.epoch == m.epoch + len(p.moves)

    def test_bucket_count_mismatch_refused_like_jax(self):
        m = _map3()
        with pytest.raises(ValueError) as te:
            plan_moves(m, np.ones(47), alive={"h0"})
        with pytest.raises(ValueError) as je:
            jplanner.plan_moves(jfc.FleetMap.from_dict(m.to_dict()),
                                np.ones(47), alive={"h0"})
        assert str(te.value) == str(je.value)

    def test_private_helpers_equal_jax(self):
        m = _map3()
        jm = jfc.FleetMap.from_dict(m.to_dict())
        rate = _hot(48, 4, 9)
        alive = {"h0", "h2"}
        assert tplanner._host_loads(m, rate, alive) == \
            jplanner._host_loads(jm, rate, alive)
        loads = tplanner._host_loads(m, rate, alive)
        assert tplanner._imbalance(loads) == jplanner._imbalance(loads)
        frozen = frozenset({2, 5, 6})
        segs = tplanner._segments(m, "h0", frozen)
        assert segs == jplanner._segments(jm, "h0", frozen)
        assert tplanner._best_window(segs, rate, 150.0, 1.25) == \
            jplanner._best_window(segs, rate, 150.0, 1.25)


# ------------------------------------------------------------- controller


def _cfg(limit=20):
    base = cs.config3()
    return dataclasses.replace(base, limit=limit, window=600.0,
                               sketch=dataclasses.replace(
                                   base.sketch, depth=2, width=1024,
                                   sub_windows=6))


class _Fleet:
    """Three in-process port members on the CPU (``chip_smoke``'s
    harness) with a controller each."""

    def __init__(self, tmp, **ctl_kw):
        from ratelimiter_tpu_torch.core.clock import ManualClock

        self.clock, self.mono = ManualClock(1000.0), [100.0]
        self.cfg = _cfg()
        self.hosts = cs.control_hosts(self.cfg, self.clock, self.mono,
                                      str(tmp), "cpu")
        self.map = self.hosts["h0"].core.map
        self.ctls = cs.control_controllers(self.hosts, self.mono,
                                           move_wait=3.0, **ctl_kw)

    def seed(self, buckets=(4, 5, 6)):
        cs.seed_hotspot(self.hosts, self.mono, "h0", buckets)

    def close(self):
        for h in self.hosts.values():
            h.close()


@pytest.fixture
def journal():
    j = events.enable(capacity=256)
    yield j
    events.disable()


def _owned_key(core, lo, hi, prefix="o"):
    return next(f"{prefix}:{i}" for i in range(5000)
                if lo <= int(core.map.bucket_of_hash(
                    core.hash_keys([f"{prefix}:{i}"]))[0]) < hi)


def test_cycle_moves_hotspot_and_journals_one_corr(tmp_path, journal):
    f = _Fleet(tmp_path)
    try:
        f.seed()
        plans = {n: c.dry_run()["plan"]["plan_id"]
                 for n, c in f.ctls.items()}
        assert len(set(plans.values())) == 1
        out_b = f.ctls["h1"].run_cycle()
        assert out_b["ok"] and out_b["executed"] == 0
        out = f.ctls["h0"].run_cycle()
        assert out["ok"] and out["executed"] >= 1
        new_map = f.hosts["h0"].core.map
        assert new_map.epoch == f.map.epoch + out["executed"]
        moved = [tuple(mv["range"])
                 for mv in out["plan"]["moves"][:out["executed"]]]
        assert any(lo <= 4 < hi for lo, hi in moved)
        assert new_map.owner_table[4] != new_map.ordinal("h0")
        assert f.ctls["h0"].frozen_now()
        st = f.ctls["h0"].status()
        assert st["moves_ok"] == out["executed"] and not st["moves_failed"]
        evs = journal.tail(category="placement")["events"]
        corr = {e["corr"] for e in evs if e["action"] in ("plan", "move")}
        assert corr == {out["plan"]["plan_id"]}
        assert sum(e["action"] == "move" for e in evs) == out["executed"]
    finally:
        f.close()


def test_never_over_admission_under_chaos_at_every_phase(tmp_path,
                                                        journal):
    from ratelimiter_tpu_torch.chaos import injector

    f = _Fleet(tmp_path)
    inj = injector.install(seed=5)
    try:
        a = f.hosts["h0"]
        f.seed()
        plan = f.ctls["h0"].dry_run()["plan"]
        lo, hi = plan["moves"][0]["range"]
        to_id = plan["moves"][0]["to"]
        key = _owned_key(a.core, lo, hi)
        limit, spent = f.cfg.limit, 15
        for _ in range(spent):
            assert a.fwd.allow_n(key, 1).allowed
        for phase in ("capture", "restore", "flip"):
            inj.abort_handoff(phase=phase, count=1)
            out = f.ctls["h0"].run_cycle()
            assert a.core.map.epoch == f.map.epoch
            assert a.core.map.host("h0").ranges == f.map.host("h0").ranges
            assert out["executed"] == 0
            assert f.ctls["h0"].pace > 1.0
        assert f.ctls["h0"].moves_failed == 3
        evs = journal.tail(category="placement")["events"]
        assert sum(e["action"] == "move-failed" for e in evs) == 3
        inj.clear()
        out = f.ctls["h0"].run_cycle()
        assert out["executed"] >= 1
        assert out["plan"]["plan_id"] == plan["plan_id"]
        recv = f.hosts[to_id]
        seq = [recv.fwd.allow_n(key, 1).allowed
               for _ in range(limit - spent + 3)]
        assert seq == [True] * (limit - spent) + [False] * 3
    finally:
        injector.uninstall()
        f.close()


def test_alive_but_unreachable_peer_skips_cycle(tmp_path):
    f = _Fleet(tmp_path)
    try:
        f.seed()
        h2 = f.hosts["h2"].core.load_slab
        f.ctls["h0"].fetch_peer_health = lambda: {
            "h1": None, "h2": {"placement": h2.snapshot()}}
        out = f.ctls["h0"].run_cycle()
        assert not out["ok"] and out["reason"] == "load-gap"
        assert out["gaps"] == ["h1"]
        assert f.ctls["h0"].dry_run() == {"ok": False, "reason": "load-gap",
                                          "gaps": ["h1"]}
        assert f.hosts["h0"].core.map.epoch == f.map.epoch
        assert "load-gap" in f.ctls["h0"].status()["last_skip"]
    finally:
        f.close()


def test_observatory_veto_halts_plan_and_backs_off(tmp_path, journal):
    burn, fd = [0.0], [0.0]
    f = _Fleet(tmp_path, slo_status=lambda: {"windows": {
        "3600s": {"burn_rate": 0.0}, "300s": {"burn_rate": burn[0]}}},
        audit_status=lambda: {"false_deny_wilson95": [0.0, fd[0]]})
    try:
        f.seed()
        burn[0] = 5.0
        out = f.ctls["h0"].run_cycle()
        assert out["executed"] == 0 and f.ctls["h0"].vetoes == 1
        assert f.ctls["h0"].pace == 2.0
        veto = [e for e in journal.tail(category="placement")["events"]
                if e["action"] == "move-vetoed"]
        assert veto and veto[-1]["payload"]["burn_rate"] == 5.0
        burn[0], fd[0] = 0.0, 0.2
        assert f.ctls["h0"].run_cycle()["executed"] == 0
        assert f.ctls["h0"].pace == 4.0
        fd[0] = 0.01
        out = f.ctls["h0"].run_cycle()
        assert out["executed"] >= 1 and f.ctls["h0"].pace < 4.0
        assert f.hosts["h0"].core.map.epoch > f.map.epoch
    finally:
        f.close()


def test_operator_abort_holds_until_apply(tmp_path, journal):
    f = _Fleet(tmp_path)
    try:
        f.seed()
        got = f.ctls["h0"].abort()
        assert got == {"ok": True, "held": True}
        assert f.ctls["h0"].run_cycle() == {"ok": True, "state": "held"}
        assert f.ctls["h0"].status()["held"]
        assert f.hosts["h0"].core.map.epoch == f.map.epoch
        assert any(e["action"] == "abort" and e["actor"] == "operator"
                   for e in journal.tail(category="placement")["events"])
        out = f.ctls["h0"].apply()
        assert out["ok"] and out["executed"] >= 1
        assert not f.ctls["h0"].status()["held"]
    finally:
        f.close()


def test_controller_metric_families_export(tmp_path):
    reg = Registry()
    f = _Fleet(tmp_path, registry=reg)
    try:
        text = reg.render()
        for fam in cs.PLACEMENT_FAMILIES:
            assert f"# TYPE {fam}" in text, fam
        f.seed()
        f.ctls["h0"].run_cycle()
        text = reg.render()
        assert 'rate_limiter_placement_moves_total{result="ok"}' in text
        assert 'rate_limiter_placement_plans_total{reason="planned"}' in text
    finally:
        f.close()


def test_same_hotspot_moves_like_the_jax_controller(tmp_path):
    """One seeded hotspot through the JAX package's in-process fleet and
    controller and through the port's: the same plan (but for the plan
    id, which digests the maps' snapshot directories), the same executed
    moves and the same map after them."""
    pytest.importorskip("jax")
    from ratelimiter_tpu.core.clock import ManualClock as JClock
    from tests.test_elastic import _make_fleet
    from tests.test_placement import _attach_placement, _seed_load

    jmono = [100.0]
    jmap, jhosts = _make_fleet(tmp_path / "jax", ["h0", "h1", "h2"],
                               JClock(1000.0))
    jctls = _attach_placement(jhosts, jmono)
    f = _Fleet(tmp_path / "port")
    try:
        hot = [2, 3, 4, 5, 9, 12]
        _seed_load(jhosts, jmono, "h0", hot)
        f.seed(hot)

        def strip(d):
            d = json.loads(json.dumps(d))
            for h in d.get("hosts", ()):
                h.pop("snapshot_dir", None)
            return d

        tp, jp = f.ctls["h0"].dry_run()["plan"], jctls["h0"].dry_run()["plan"]
        assert {**tp, "plan_id": None} == {**jp, "plan_id": None}
        tout, jout = f.ctls["h0"].run_cycle(), jctls["h0"].run_cycle()
        assert tout["executed"] == jout["executed"] >= 1
        assert tout["plan"]["moves"] == jout["plan"]["moves"]
        assert strip(f.hosts["h1"].core.map.to_dict()) == strip(
            jhosts["h1"].core.map.to_dict())
    finally:
        f.close()
        for h in list(jhosts.values()):
            h.close()


def test_decisions_identical_with_and_without_slab_and_controller(
        tmp_path):
    """The off pin: the same workload through a fleet whose members have
    no load slab and no controller, and through one with both (the
    controller planning between frames, its moves off): the same
    decisions in the same order."""
    keys = [f"pin:{i}" for i in range(40)]

    def run(sub, attach):
        f = _Fleet(tmp_path / sub)
        try:
            if not attach:
                for h in f.hosts.values():
                    h.core.load_slab = None
            out = []
            for _ in range(3):
                for k in keys:
                    h = int(f.map.owner_of_hash(
                        f.hosts["h0"].core.hash_keys([k]))[0])
                    r = f.hosts[f"h{h}"].fwd.allow_n(k, 1)
                    out.append((k, bool(r.allowed), int(r.remaining),
                                int(r.limit)))
                if attach:
                    f.ctls["h0"].dry_run()
            return out
        finally:
            f.close()

    assert run("plain", False) == run("slabbed", True)


def test_slab_sees_the_routed_traffic(tmp_path):
    f = _Fleet(tmp_path)
    try:
        a = f.hosts["h0"]
        for _ in range(5):
            a.fwd.allow_n(_owned_key(a.core, 0, 16), 1)
        assert a.core.load_slab.snapshot()["decide_total"] >= 5
    finally:
        f.close()


def test_own_view_is_the_one_peers_read(tmp_path):
    """ROADMAP C19: a member plans on its own load as its peers read it
    from /healthz (3 decimals), so members asked at one drain agree on
    the plan id although the rates are not exact in 3 decimals."""
    mono = [0.0]
    slabs = {}
    hosts = {}
    f = _Fleet(tmp_path)
    try:
        for n, h in f.hosts.items():
            slabs[n] = h.core.load_slab = LoadSlab(
                48, ewma_halflife_s=7.0, min_drain_s=0.05,
                clock=lambda: mono[0])
            hosts[n] = h
        slabs["h0"].note(np.repeat(np.arange(16), 37), np.ones(16 * 37,
                                                               dtype=bool))
        mono[0] = 0.77
        for s in slabs.values():
            s.snapshot()
        own = slabs["h0"].rates()
        assert not np.array_equal(own, np.round(own, 3))

        def fetch(me):
            return lambda: {n: {"placement": s.snapshot()}
                            for n, s in slabs.items() if n != me}

        ctls = {n: RebalanceController(
            h.core, h.membership, slabs[n], interval=999.0,
            fetch_peer_health=fetch(n), clock=lambda: mono[0])
            for n, h in hosts.items()}
        ids = {c.dry_run()["plan"]["plan_id"] for c in ctls.values()}
        assert len(ids) == 1
        # The JAX controller's own view, unrounded, plans another id.
        fmap = hosts["h0"].core.map
        alive = {"h0", "h1", "h2"}
        assert plan_moves(fmap, own, alive=alive).plan_id not in ids
        assert jplanner.plan_moves(jfc.FleetMap.from_dict(fmap.to_dict()),
                                   own, alive=alive).plan_id not in ids
    finally:
        f.close()


# ------------------------------------------------------------- the binary


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the test (TimeoutError) past ``seconds`` of wall time: the
    timeout of a test that starts member processes."""
    def expire(signum, frame):
        raise TimeoutError(f"the test ran past {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def test_rebalance_on_three_port_members(tmp_path):
    """``chip_smoke``'s stage (c) on three port binaries on the CPU (h1 the
    native door; no auditor: its SLO burn on a shared CPU vetoes moves):
    the hotspot on h0 planned alike by every member, applied under a
    driver with no client error, the receivers' answers equal to CPU
    replays, the exact admission oracle, one correlation id; then the
    fleet routes and their gates on both doors, and
    ``tools/fleet_rebalance.py`` (status, dry-run, apply) against a
    member."""
    with deadline(120.0):
        _rebalance_on_three_port_members(tmp_path)
    cs.check_no_children()


def _rebalance_on_three_port_members(tmp_path):
    base = cs.config3()
    cfg = dataclasses.replace(base, sketch=dataclasses.replace(
        base.sketch, depth=2, width=16384))
    pair = cs.FleetPair(str(tmp_path), cfg, "cpu",
                        native=cs.CONTROL_NATIVE,
                        buckets=cs.CONTROL_BUCKETS, http_ports=True,
                        flags=cs.CONTROL_BASE, boot_timeout=45.0)
    try:
        out = cs.check_control_rebalance(pair, 5)
        assert out["client_errors"] == 0 and out["held_rows"] > 0
        assert out["oracle"]["over_admitted_keys"] == 0
        for i in range(pair.n):
            port = pair.srv[i].http
            st, _, body = cs.http_call(port, "GET", "/v1/fleet/status")
            assert st == 200 and body["reachable"] == 3, body
            assert body["placement"]["rebalance"]["h0"]["moves_ok"] == len(
                out["moves"])
            for path in ("/debug/trace?fleet=1", "/debug/events?fleet=1"):
                assert cs.http_call(port, "GET", path)[0] == 403
                assert cs.http_call(port, "GET", path, "wrong")[0] == 403
                st, _, body = cs.http_call(port, "GET", path,
                                           cs.CONTROL_DEBUG)
                hosts = (body["otherData"]["hosts"] if "trace" in path
                         else body["hosts"])
                assert st == 200 and set(hosts) == {"h0", "h1", "h2"}
            assert cs.http_call(port, "POST", "/v1/fleet/rebalance"
                                "?action=dry-run", "wrong")[0] == 403
            st, _, body = cs.http_call(port, "POST", "/v1/fleet/rebalance"
                                       "?action=nope", cs.CONTROL_TOKEN)
            assert st == 400
            assert cs.http_call(port, "PUT", "/v1/fleet/rebalance",
                                cs.CONTROL_TOKEN)[0] == 405
        tool = os.path.join(REPO, "tools", "fleet_rebalance.py")
        gw = f"http://127.0.0.1:{pair.srv[1].http}"
        for verb in ("status", "dry-run", "apply"):
            r = subprocess.run(
                [sys.executable, tool, gw, verb, "--token",
                 cs.CONTROL_TOKEN], capture_output=True, text=True,
                timeout=60)
            assert r.returncode == 0, r.stdout + r.stderr
            assert r.stdout.strip()
        r = subprocess.run([sys.executable, tool, gw, "status", "--token",
                            "wrong"], capture_output=True, text=True,
                           timeout=60)
        assert r.returncode != 0
    finally:
        pair.close()
