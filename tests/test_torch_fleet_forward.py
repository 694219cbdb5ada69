"""The fleet through the port's binaries on the CPU: ``chip_smoke.py``'s
phase fleet at a narrow width (d=2, w=4096, limit 20).

(a) in process: host A the port's ``FleetForwarder``, host B a port
asyncio door, one manual clock; a frame of each host's own rows, then
mixed string and raw-id frames, every answer and both hosts' state equal
to CPU replays of each owner's rows, for the window with the side table
and for the token bucket. Then two binaries of one affine map, h0 on the
asyncio door and h1 on the native door, each with a snapshot directory
and an HTTP gateway: the seeded sample through both doors equal to the
replay, a key spent through one door denied on the other, ``FleetClient``
routing to the owners (nothing forwarded), the affine and mixed load;
kill -9 failover onto the successor (the adopted unit on the binary's
device, its answers equal to a CPU standby built from the dead member's
snapshot directory), h1's restart and the give-back (h1's answers equal
to its boot restore with the unit h0 kept for it folded in);
``/v1/fleet/migrate`` with its token, a move each way, one owner after
each and the receiver's answers equal to a CPU standby from the giver's
directory, the receiver's restore stalled (migration-stall) while the
giver keeps the range. Each process test runs under its own
subprocess timeouts and kills what it started.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _cfg():
    base = cs.config3()
    return dataclasses.replace(base, limit=20, sketch=dataclasses.replace(
        base.sketch, depth=2, width=4096, sub_windows=6))


@pytest.mark.parametrize("algo", ["windowed", "bucket"])
def test_smoke_fleet_in_process_on_cpu(algo):
    if algo == "windowed":
        base = cs.config3_hh()
        cfg = dataclasses.replace(base, window=6.0, sketch=dataclasses.replace(
            base.sketch, depth=2, width=1024, sub_windows=6, hh_slots=16))
        advance = 1.0
    else:
        base = cs.config2_bucket()
        cfg = dataclasses.replace(base, sketch=dataclasses.replace(
            base.sketch, depth=2, width=1024))
        advance = cs.C2_ADVANCE
    out = cs.check_fleet_inprocess(torch, algo, cfg, 5, device="cpu",
                                   frames=6, size=256, advance=advance)
    assert out["forwarded_rows"] > 0 and out["wire_frames"] > 0


def _pair(tmp, extra=((), ())):
    return cs.FleetPair(str(tmp), _cfg(), "cpu", extra=extra,
                        boot_timeout=45.0)


def test_two_binaries_forward_across_both_doors(tmp_path):
    load = cs.FleetLoad(str(tmp_path))
    try:
        pair = _pair(tmp_path)
        try:
            out = cs.check_fleet_sample(pair, 3, frames=4, size=256)
            assert out["epochs_before_traffic"] == [1, 1]
            kw = dict(seconds=0.4, warmup=0.2, frame=256, conns=2, depth=3,
                      pool=4096)
            affine = load.run(pair, "affine", seed=1, **kw)
            mixed = load.run(pair, "mixed", seed=2, **kw)
            assert affine["forwarded_fraction"] == 0.0
            assert 0.3 < mixed["forwarded_fraction"] < 0.7
            assert mixed["forward_rtt_ms"] is not None
            assert affine["forward_errors"] == mixed["forward_errors"] == 0
            assert affine["epoch"] == mixed["epoch"] == 1
            assert affine["processes"] == 2 and affine["frames"] > 0
        finally:
            pair.close()
    finally:
        load.close()
    cs.check_no_children()


def test_kill9_failover_onto_the_successor(tmp_path):
    pair = _pair(tmp_path)
    try:
        out = cs.check_fleet_failover(pair, 4)
        assert out["adopted_device"] == "cpu"
        assert out["epochs"] == [1, 2, 3]
        assert out["failovers"] == 1 and out["rejoins"] == 1
        assert out["recovery_s"] < 10.0
    finally:
        pair.close()
    cs.check_no_children()


def test_http_migrate_with_token(tmp_path):
    pair = _pair(tmp_path, extra=(("--chaos-scenario", "migration-stall",
                                   "--chaos-seconds", "0.4"), ()))
    try:
        out = cs.check_fleet_migrate(pair, 6, stall=0.4)
        assert out["migrate"]["epoch"] == 2
        assert out["migration-stall"]["epoch"] == 3
        assert out["migration-stall"]["giver_kept_it_mid_stall"]
        assert out["migration-stall"]["seconds"] >= 0.4
    finally:
        pair.close()
    cs.check_no_children()
