"""The chaos harness in the port (``ratelimiter_tpu_torch/chaos/``) and the
seams it fires at, held to the JAX package on the CPU.

The injector, seeded alike in both packages, drops, corrupts and faults
the same calls in the same order; ``SliceFault`` classifies as a backend
fault. ``kill-slice`` on the port's quarantined mesh answers exactly as
the JAX mesh under the JAX injector (healthy slices equal to a no-fault
replay, the victim's range fail-open); ``dcn-corrupt`` pushes merge no
mass and ``dcn-partition`` drops them at the sender; ``snapshot-stall``
stalls the capture. Through the binaries: ``--chaos-scenario`` refusals
as in the JAX binary, ``kill-during-handoff`` on a member ends with
exactly one owner (``chip_smoke.check_fleet_handoff_abort``), and the
mesh binary with ``--quarantine`` and ``kill-slice`` (phase fleet (e),
``chip_smoke.check_fleet_slice_chaos``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu import chaos as jchaos
from ratelimiter_tpu.parallel.quarantine import (
    classify_failure as jclassify,
)
from ratelimiter_tpu_torch import chaos
from ratelimiter_tpu_torch.parallel import SlicedMeshLimiter
from ratelimiter_tpu_torch.parallel.quarantine import classify_failure
from ratelimiter_tpu_torch.serving import protocol as p

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _no_injector():
    yield
    chaos.uninstall()
    jchaos.uninstall()


def _trace(M, seed):
    """One seeded run of every hook family; what fired, in order."""
    inj = M.chaos.ChaosInjector(seed)
    rng = np.random.default_rng(seed)
    out = []
    inj.partition_dcn(0.3)
    inj.corrupt_dcn(0.4)
    for i in range(120):
        frame = bytes(rng.integers(0, 256, 13 + int(rng.integers(1, 40)),
                                   dtype=np.uint8))
        out.append(inj.dcn_frame(frame))
    inj.clear()
    inj.fail_slice(1, count=3)
    for _ in range(5):
        try:
            inj.slice_launch(1)
            out.append("ok")
        except M.chaos.SliceFault as exc:
            out.append(str(exc))
    inj.abort_handoff("flip", count=2)
    inj.stall_handoff(0.0, phase="restore")
    for phase in ("capture", "restore", "flip", "flip", "flip"):
        try:
            inj.handoff_phase(phase)
            out.append("ok")
        except M.chaos.SliceFault as exc:
            out.append(str(exc))
    out.append((inj.dcn_dropped, inj.dcn_corrupted, inj.slice_faults,
                inj.handoff_aborts, inj.handoff_stalls))
    return out


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_injector_sequences_equal_jax(seed):
    got, want = _trace(T, seed), _trace(R, seed)
    assert got == want
    assert got[-1][0] > 0 and got[-1][1] > 0


@pytest.mark.parametrize("name", [
    "kill-slice", "slow-slice", "wedge-slice", "dcn-partition",
    "dcn-corrupt", "snapshot-stall", "migration-stall",
    "kill-during-handoff", "rejoin-storm", "no-such-scenario"])
def test_scenarios_arm_as_in_jax(name):
    def armed(M):
        inj = M.chaos.ChaosInjector(1)
        try:
            M.chaos.scenario(name, inj, slice_idx=2, seconds=0.01)
        except ValueError as exc:
            return str(exc)
        return (sorted((k, v[0]) for k, v in inj._slice.items()),
                inj._dcn_drop_p, inj._dcn_corrupt_p, inj._snapshot_stall_s,
                inj._handoff_stall, inj._handoff_abort)

    assert armed(T) == armed(R)


def test_slice_fault_classifies_as_a_backend_fault():
    assert classify_failure(chaos.SliceFault("x")) is True
    assert jclassify(jchaos.SliceFault("x")) is True
    assert classify_failure(T.InvalidKeyError("x")) is False


def _mesh_cfg(M, quarantine=True):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(
        algorithm=M.Algorithm.SLIDING_WINDOW, limit=10, window=60.0,
        fail_open=True,
        sketch=M.SketchParams(depth=2, width=1 << 10, sub_windows=6, **extra),
        mesh=M.core.config.MeshSpec(devices=4, quarantine=quarantine,
                                    slice_deadline=5.0,
                                    probe_interval=30.0))


def test_kill_slice_scenario_equals_jax_and_the_no_fault_replay():
    """The same id traffic through the port's quarantined mesh and the
    JAX one, ``kill-slice`` armed mid-traffic in each package's
    injector: every row equal between the packages (the victim's
    fail-open allowances too; their reset is the wall clock's), and the
    healthy slices' rows equal a no-fault replay."""
    lim = SlicedMeshLimiter(_mesh_cfg(T), device="cpu")
    oracle = SlicedMeshLimiter(_mesh_cfg(T, quarantine=False), device="cpu")
    jlim = R.create_limiter(_mesh_cfg(R), backend="mesh")
    victim = 2
    rng = np.random.default_rng(9)
    frames = [rng.integers(1, 1 << 40, size=256, dtype=np.uint64)
              for _ in range(6)]
    inj, jinj = chaos.install(seed=3), jchaos.install(seed=3)
    try:
        for m in (lim, oracle, jlim):
            m.allow_ids(frames[0], now=T0 - 1.0)
        got, want, jgot = [], [], []
        for i, ids in enumerate(frames):
            if i == 3:
                chaos.scenario("kill-slice", inj, slice_idx=victim)
                jchaos.scenario("kill-slice", jinj, slice_idx=victim)
            now = T0 + i * 0.25
            got.append(lim.allow_ids(ids, now=now))
            want.append(oracle.allow_ids(ids, now=now))
            jgot.append(jlim.allow_ids(ids, now=now))
        owners = lim.owner_of_id(np.concatenate(frames))
        healthy = owners != victim
        for f in ("allowed", "remaining", "retry_after", "reset_at"):
            g = np.concatenate([getattr(x, f) for x in got])
            # A fail-open row's reset is the wall clock's now + window.
            rows = (slice(None) if f in ("allowed", "remaining")
                    else healthy)
            np.testing.assert_array_equal(
                g[rows], np.concatenate(
                    [getattr(x, f) for x in jgot])[rows], err_msg=f)
            np.testing.assert_array_equal(
                g[healthy], np.concatenate(
                    [getattr(x, f) for x in want])[healthy], err_msg=f)
        assert [x.fail_open for x in got] == [x.fail_open for x in jgot]
        assert not any(x.fail_open for x in got[:3])
        assert all(x.fail_open for x in got[3:])
        assert lim.quarantine.quarantined() == [victim]
        assert inj.slice_faults == jinj.slice_faults > 0
    finally:
        lim.close()
        oracle.close()
        jlim.close()


def test_dcn_corrupt_merges_no_mass_and_partition_drops():
    from ratelimiter_tpu_torch.parallel.dcn import export_debt
    from ratelimiter_tpu_torch.serving.dcn_peer import _PeerConn
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    cfg = T.Config(algorithm=T.Algorithm.TOKEN_BUCKET, limit=10, window=6.0,
                   sketch=T.SketchParams(depth=2, width=256))
    a = T.create_limiter(cfg, backend="sketch", clock=T.ManualClock(T0),
                         device="cpu")
    b = T.create_limiter(cfg, backend="sketch", clock=T.ManualClock(T0),
                         device="cpu")
    import asyncio
    import threading

    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    door = RateLimitServer(b, "127.0.0.1", 0, dcn=True, dcn_secret="s")
    asyncio.run_coroutine_threadsafe(door.start(), loop).result(30)
    try:
        assert a.allow_n("k", 10).allowed
        delta = export_debt(a)
        frame = p.encode_dcn_debt(1, delta, secret="s", sender=5,
                                  seq=int(time.time() * 1e6))
        before = b.capture_state()[1]
        inj = chaos.install(seed=4)
        chaos.scenario("dcn-corrupt", inj)
        peer = _PeerConn("127.0.0.1", door.port)
        try:
            with pytest.raises(Exception):
                peer.push(frame, 1)
        finally:
            peer.close()
        after = b.capture_state()[1]
        for k in before:
            np.testing.assert_array_equal(np.asarray(before[k]),
                                          np.asarray(after[k]), err_msg=k)
        assert inj.dcn_corrupted == 1 and b.allow("k").allowed
        inj.clear()
        chaos.scenario("dcn-partition", inj)
        peer = _PeerConn("127.0.0.1", door.port)
        try:
            with pytest.raises(ConnectionError, match="chaos"):
                peer.push(frame, 2)
        finally:
            peer.close()
        assert inj.dcn_dropped == 1
        inj.clear()
        peer = _PeerConn("127.0.0.1", door.port)
        try:
            peer.push(p.encode_dcn_debt(3, delta, secret="s", sender=5,
                                        seq=int(time.time() * 1e6) + 10), 3)
        finally:
            peer.close()
        assert not b.allow("k").allowed
    finally:
        asyncio.run_coroutine_threadsafe(door.shutdown(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        loop.close()
        a.close()
        b.close()


def test_snapshot_stall_stalls_the_capture(tmp_path):
    from ratelimiter_tpu_torch.observability.metrics import Registry
    from ratelimiter_tpu_torch.persistence import PersistenceManager

    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=10,
                   window=6.0, sketch=T.SketchParams(depth=2, width=256,
                                                     sub_windows=6),
                   persistence=T.PersistenceSpec(dir=str(tmp_path),
                                                 snapshot_interval=3600.0))
    lim = T.create_limiter(cfg, backend="sketch", device="cpu")
    mgr = PersistenceManager(cfg.persistence, registry=Registry())
    top = mgr.wrap(lim)
    mgr.attach([top])
    try:
        inj = chaos.install(seed=0)
        chaos.scenario("snapshot-stall", inj, seconds=0.2)
        t = time.perf_counter()
        mgr.snapshot_now()
        assert time.perf_counter() - t >= 0.2
        assert inj.snapshot_stalls == 1
    finally:
        mgr.stop(final_snapshot=False)
        top.close()


def test_binary_refusals_equal_jax():
    from ratelimiter_tpu_torch.serving import __main__ as tbin

    cases = [
        (["--chaos-scenario", "kill-slice"],
         "--chaos-scenario slice faults need --quarantine (otherwise "
         "nothing contains them)"),
        (["--fleet-config", "m.json"],
         "--fleet-config needs --fleet-self (this server's host id in the "
         "map)"),
        (["--fleet-config", "m.json", "--fleet-self", "h0", "--backend",
          "dense"],
         "--fleet-config needs a sketch-family backend (fleet routing "
         "hashes keys)"),
    ]
    for argv, msg in cases:
        with pytest.raises(SystemExit) as ei:
            tbin.build_config(tbin.parse_args(argv))
        assert str(ei.value) == msg
    # The same texts in the JAX binary's source.
    src = open(os.path.join(REPO, "ratelimiter_tpu", "serving",
                            "__main__.py")).read().replace(
        '"\n                             "', "").replace(
        '"\n                         "', "")
    for _, msg in cases:
        assert msg.split(" (")[0] in src


def test_kill_during_handoff_leaves_one_owner(tmp_path):
    """Two member binaries on the CPU, kill-during-handoff armed on h1: a
    move to h1 dies at its flip; the migrate answers 504 and both serve
    the old map."""
    import dataclasses

    base = cs.config3()
    cfg = dataclasses.replace(base, limit=20, sketch=dataclasses.replace(
        base.sketch, depth=2, width=4096, sub_windows=6))
    pair = cs.FleetPair(str(tmp_path), cfg, "cpu", extra=(
        (), ("--chaos-scenario", "kill-during-handoff")), boot_timeout=45.0)
    try:
        out = cs.check_fleet_handoff_abort(pair, 8)
        assert out["status"] == 504 and out["epoch"] == 1
    finally:
        pair.close()
    cs.check_no_children()


def test_smoke_slice_chaos_binary_on_cpu():
    flags = list(cs.FLEET_SLICE_CHAOS)
    flags[flags.index("--sketch-width") + 1] = "1024"
    flags[flags.index("--sketch-depth") + 1] = "2"
    out = cs.check_fleet_slice_chaos(5, device="cpu", flags=flags, frames=4,
                                     size=256, boot_timeout=45.0)
    assert out["victim_rows"] > 0 and out["healthy_rows"] > 0
    cs.check_no_children()
