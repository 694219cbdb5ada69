"""The collective mesh router (``MeshSpec.router="collective"``) in the
port, on the CPU: against the port's host router, the JAX package's
``CollectiveMeshLimiter`` and its routing prologue ``_route``.

The port runs N slices on ``cpu`` and the JAX package N of its 8 virtual
CPU devices. Inputs are made with NumPy from a seed; the tolerance is 0.
Covered (the 16 cases of tests/test_collective_router.py): mixed and
affine frames, in-batch same-key sequencing, rollovers, the token
bucket, policy overrides, the hierarchy cascade, the raw-id wire lane,
capacity-1 bins falling back bit-identically, no lost or duplicated
mass through the fallback, ``bin_capacity``'s bounds (against the JAX
function), a snapshot with routed tickets in flight, the restore round
trip, and the config and CLI refusals; then ``route_bins_plain`` against
JAX's ``_route`` on every output (owners, ranks, bins after the
all_to_all, the compaction, overflow), and the port's collective router
against the JAX package's.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu_torch.ops import route_kernels
from ratelimiter_tpu_torch.parallel import (
    CollectiveMeshLimiter,
    SlicedMeshLimiter,
)
from ratelimiter_tpu_torch.parallel.mesh import Mesh

T0 = 1_700_000_000.0
FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


def _cfg(M, router, *, algo="SLIDING_WINDOW", limit=10, devices=4,
         headroom=2.0, tenants=0, global_limit=300):
    extra = {"kernels": "jnp"} if M is R else {}
    hier = (M.core.config.HierarchySpec(tenants=tenants,
                                        global_limit=global_limit)
            if tenants else M.core.config.HierarchySpec())
    return M.Config(
        algorithm=getattr(M.Algorithm, algo), limit=limit, window=60.0,
        policy=M.core.config.PolicySpec(capacity=64),
        sketch=M.SketchParams(depth=2, width=1 << 10, sub_windows=6,
                              **extra),
        mesh=M.core.config.MeshSpec(devices=devices, router=router,
                                    bin_headroom=headroom),
        hierarchy=hier)


def _pair(router_kw=None, **kw):
    """(host-routed oracle, collective), both the port's."""
    ckw = dict(kw)
    ckw.update(router_kw or {})
    host = T.create_limiter(_cfg(T, "host", **kw), backend="mesh",
                            clock=T.ManualClock(T0), device="cpu")
    coll = T.create_limiter(_cfg(T, "collective", **ckw), backend="mesh",
                            clock=T.ManualClock(T0), device="cpu")
    assert isinstance(coll, CollectiveMeshLimiter)
    assert type(host) is SlicedMeshLimiter
    return host, coll


def _same(a, b, i=None):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f"{f} (frame {i})")
    if a.limits is None:
        assert b.limits is None
    else:
        np.testing.assert_array_equal(a.limits, b.limits)


def _same_slices(a, b):
    for sa, sb in zip(a.sub_limiters(), b.sub_limiters()):
        xa, xb = sa.capture_state()[1], sb.capture_state()[1]
        assert set(xa) == set(xb)
        for k in xa:
            np.testing.assert_array_equal(np.asarray(xa[k]),
                                          np.asarray(xb[k]), err_msg=k)


def _close(*lims):
    for lim in lims:
        lim.close()


# ------------------------------------------------------------ parity


def test_mixed_frames_bit_identical():
    host, coll = _pair()
    rng = np.random.default_rng(0)
    try:
        for i in range(12):
            b = int(rng.integers(1, 400))
            h = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
            ns = rng.integers(1, 4, size=b).astype(np.int64)
            now = T0 + i * 0.5
            _same(host.allow_hashed(h, ns, now=now),
                  coll.allow_hashed(h, ns, now=now), i)
        assert coll.fallbacks == 0
        assert coll.router_stats() == {"mode": "collective", "fallbacks": 0}
        _same_slices(host, coll)
    finally:
        _close(host, coll)


def test_affine_frames_bit_identical():
    host, coll = _pair()
    try:
        all_ids = np.arange(1, 1 << 12, dtype=np.uint64)
        h = all_ids[host.owner_of_hash(all_ids) == 3][:64]
        assert len(h) == 64
        for i in range(4):
            _same(host.allow_hashed(h, now=T0 + i),
                  coll.allow_hashed(h, now=T0 + i), i)
        assert coll.fallbacks == 0
    finally:
        _close(host, coll)


def test_in_batch_same_key_sequencing():
    host, coll = _pair()
    try:
        h = np.full(15, 0xDEAD_BEEF_F00D, dtype=np.uint64)
        rh, rc = host.allow_hashed(h, now=T0), coll.allow_hashed(h, now=T0)
        _same(rh, rc)
        assert rc.allowed.tolist() == [True] * 10 + [False] * 5
    finally:
        _close(host, coll)


def test_rollover_parity():
    host, coll = _pair()
    rng = np.random.default_rng(1)
    try:
        for i, dt in enumerate([0.0, 15.0, 30.0, 45.0, 61.0, 125.0]):
            b = int(rng.integers(32, 200))
            h = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
            _same(host.allow_hashed(h, now=T0 + dt),
                  coll.allow_hashed(h, now=T0 + dt), i)
        _same_slices(host, coll)
    finally:
        _close(host, coll)


def test_token_bucket_parity():
    host, coll = _pair(algo="TOKEN_BUCKET")
    rng = np.random.default_rng(2)
    try:
        for i in range(8):
            b = int(rng.integers(1, 300))
            h = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
            _same(host.allow_hashed(h, now=T0 + i * 0.5),
                  coll.allow_hashed(h, now=T0 + i * 0.5), i)
        _same_slices(host, coll)
    finally:
        _close(host, coll)


def test_policy_override_parity():
    host, coll = _pair()
    rng = np.random.default_rng(3)
    try:
        keys = ["vip-a", "vip-b", "cheap", "fast"]
        for key, lim in zip(keys, (2, 50, 1, 25)):
            for m in (host, coll):
                m.set_override(key, lim)
        special = np.asarray(host._hash(keys), dtype=np.uint64)
        for i in range(6):
            b = int(rng.integers(64, 256))
            h = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
            h[:len(special)] = special
            rh = host.allow_hashed(h, now=T0 + i * 0.5)
            _same(rh, coll.allow_hashed(h, now=T0 + i * 0.5), i)
            assert rh.limits is not None
    finally:
        _close(host, coll)


def test_hierarchy_cascade_parity():
    host, coll = _pair(tenants=4)
    rng = np.random.default_rng(4)
    try:
        for i in range(6):
            b = int(rng.integers(64, 400))
            h = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
            _same(host.allow_hashed(h, now=T0 + i * 0.5),
                  coll.allow_hashed(h, now=T0 + i * 0.5), i)
        _same_slices(host, coll)
    finally:
        _close(host, coll)


def test_wire_lane_parity():
    host, coll = _pair()
    rng = np.random.default_rng(5)
    try:
        ids = rng.integers(0, 1 << 62, size=128, dtype=np.uint64)
        rh = host.resolve(host.launch_ids(ids, now=T0, wire=True))
        rc = coll.resolve(coll.launch_ids(ids, now=T0, wire=True))
        _same(rh, rc)
        pb_h, words_h, bh = rh.wire_packed
        pb_c, words_c, bc = rc.wire_packed
        assert bh == bc
        np.testing.assert_array_equal(pb_h, pb_c)
        np.testing.assert_array_equal(words_h, words_c)
    finally:
        _close(host, coll)


# -------------------------------------------------- overflow fallback


def test_capacity_one_bins_fall_back_bit_identically():
    host, coll = _pair(router_kw={"headroom": 0.001})
    rng = np.random.default_rng(6)
    try:
        for i in range(6):
            b = int(rng.integers(64, 300))
            h = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
            ns = rng.integers(1, 4, size=b).astype(np.int64)
            _same(host.allow_hashed(h, ns, now=T0 + i * 0.5),
                  coll.allow_hashed(h, ns, now=T0 + i * 0.5), i)
        assert coll.fallbacks > 0
        assert coll.router_stats()["fallbacks"] == coll.fallbacks
        _same_slices(host, coll)
    finally:
        _close(host, coll)


def test_no_lost_or_duplicated_admission_mass():
    _, coll = _pair(router_kw={"headroom": 0.001})
    try:
        hot = np.full(4, 0xF00D, dtype=np.uint64)
        admitted = sum(int(coll.allow_hashed(hot, now=T0 + i * 0.01)
                           .allowed.sum()) for i in range(4))
        assert admitted == 10
        assert coll.fallbacks > 0
    finally:
        coll.close()


def test_bin_capacity_bounds_match_jax():
    from ratelimiter_tpu.ops.route_kernels import bin_capacity as jbc

    bc = route_kernels.bin_capacity
    assert bc(1024, 8, 2.0) == 256
    assert bc(32, 8, 2.0) > 8
    assert bc(8, 8, 2.0) == 8
    assert bc(4, 8, 8.0) == 4
    assert bc(64, 8, 0.001) == 1
    for L in (8, 16, 64, 512, 4096):
        for n in (1, 2, 3, 4, 8):
            for hr in (0.001, 0.5, 1.0, 2.0, 3.7):
                assert bc(L, n, hr) == jbc(L, n, hr), (L, n, hr)


# ---------------------------------------------- snapshot during flight


def test_capture_quiesces_inflight_collective_dispatches(tmp_path):
    cfg = _cfg(T, "collective")
    coll = T.create_limiter(cfg, backend="mesh", clock=T.ManualClock(T0),
                            device="cpu")
    try:
        hot = np.full(4, 0xF00D, dtype=np.uint64)
        t1 = coll.launch_ids(np.concatenate([hot, hot]), now=T0)
        t2 = coll.launch_ids(hot, now=T0)
        path = str(tmp_path / "mid.npz")
        coll.save(path)
        assert coll.resolve(t1).allowed.tolist() == [True] * 8
        assert coll.resolve(t2).allowed.tolist() == [True, True, False,
                                                     False]
        restored = T.create_limiter(cfg, backend="mesh",
                                    clock=T.ManualClock(T0), device="cpu")
        restored.restore(path)
        assert restored.allow_ids(hot, now=T0).allowed.tolist() == [False] * 4
        restored.close()
    finally:
        coll.close()


def test_restore_round_trip_parity(tmp_path):
    host, coll = _pair()
    rng = np.random.default_rng(7)
    h = rng.integers(0, 1 << 64, size=200, dtype=np.uint64)
    try:
        host.allow_hashed(h, now=T0)
        coll.allow_hashed(h, now=T0)
        ph, pc = str(tmp_path / "host.npz"), str(tmp_path / "coll.npz")
        host.save(ph)
        coll.save(pc)
        host2, coll2 = _pair()
        host2.restore(ph)
        coll2.restore(pc)
        _same(host2.allow_hashed(h, now=T0 + 1.0),
              coll2.allow_hashed(h, now=T0 + 1.0))
        _close(host2, coll2)
    finally:
        _close(host, coll)


# ----------------------------------------------------- config refusal


def test_config_refuses_collective_plus_quarantine():
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=10,
                   window=60.0, sketch=T.SketchParams(depth=2, width=1024),
                   mesh=T.MeshSpec(devices=4, router="collective",
                                   quarantine=True))
    with pytest.raises(T.InvalidConfigError, match="blast radius"):
        T.create_limiter(cfg, backend="mesh", device="cpu")


def test_config_refuses_unknown_router():
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=10,
                   window=60.0, sketch=T.SketchParams(depth=2, width=1024),
                   mesh=T.MeshSpec(devices=4, router="p2p"))
    with pytest.raises(T.InvalidConfigError, match="router"):
        T.create_limiter(cfg, backend="mesh", device="cpu")


def test_cli_refuses_collective_plus_quarantine():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
         "--backend", "mesh", "--router", "collective", "--quarantine",
         "--device", "cpu", "--port", "1"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "incompatible with --quarantine" in out.stderr


# --------------------------------------------- against the JAX package


@pytest.mark.parametrize("premix", [False, True])
@pytest.mark.parametrize("headroom,b", [(2.0, 200), (2.0, 7), (0.001, 90)])
def test_route_bins_plain_matches_jax_route(premix, headroom, b):
    """Per source shard: owners, ranks, keep and overflow, the bins after
    the all_to_all and each destination's compaction — every output of
    JAX's ``_route`` — from ``route_bins_plain`` and the port's mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, PartitionSpec as P

    from ratelimiter_tpu.ops import route_kernels as jrk
    from ratelimiter_tpu.parallel.mesh_kernels import shard_map

    n = 4
    L = 64
    C = route_kernels.bin_capacity(L, n, headroom)
    rng = np.random.default_rng(8)
    h = np.zeros(n * L, np.uint64)
    h[:b] = rng.integers(0, 1 << 64, size=b, dtype=np.uint64)
    h[:b:5] = h[0]                      # repeats of one owner
    ns = np.zeros(n * L, np.int32)
    ns[:b] = rng.integers(1, 5, size=b)

    mesh = JMesh(np.asarray(jax.devices()[:n]), ("chips",))

    def body(hh, nn):
        h_own, ns_own, order, binpos, keep, ovf = jrk._route(
            hh, nn, jnp.int64(b), n, L, C, premix)
        return h_own, ns_own, order, binpos, keep, ovf.reshape(1)

    spec = P("chips")
    f = jax.jit(shard_map(partial(body), mesh=mesh, in_specs=(spec, spec),
                          out_specs=(spec,) * 6, check_vma=False))
    jh_own, jns_own, jorder, jbinpos, jkeep, jovf = (
        np.asarray(x) for x in f(jnp.asarray(h), jnp.asarray(ns)))

    ht = torch.from_numpy(h.view(np.int64))
    nt = torch.from_numpy(ns)
    bins = [route_kernels.route_bins(ht[i * L:(i + 1) * L],
                                     nt[i * L:(i + 1) * L], b - i * L, n, C,
                                     premix) for i in range(n)]
    tm = Mesh(["cpu"] * n)
    recv_h = tm.all_to_all([[x.send_h[d * C:(d + 1) * C] for d in range(n)]
                            for x in bins])
    recv_ns = tm.all_to_all([[x.send_ns[d * C:(d + 1) * C]
                              for d in range(n)] for x in bins])
    for i in range(n):
        x = bins[i]
        np.testing.assert_array_equal(x.binpos.numpy(),
                                      jbinpos[i * L:(i + 1) * L])
        np.testing.assert_array_equal(x.keep.numpy(),
                                      jkeep[i * L:(i + 1) * L])
        assert int(x.ovf[0]) == int(jovf[i])
        h_own, ns_own, order = route_kernels.compact(recv_h[i], recv_ns[i])
        span = slice(i * n * C, (i + 1) * n * C)
        np.testing.assert_array_equal(h_own.numpy().view(np.uint64),
                                      jh_own[span])
        np.testing.assert_array_equal(ns_own.numpy(), jns_own[span])
        np.testing.assert_array_equal(order.numpy(), jorder[span])
    assert bool(jovf.any()) == (headroom < 1)


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_collective_matches_jax_collective(algo):
    """The port's collective router against the JAX package's, on mixed
    frames at one pad bucket and a capacity-1 overflowing frame: every
    field, every slice's state and the fallback count."""
    from ratelimiter_tpu.parallel.collective import (
        CollectiveMeshLimiter as JaxCollective,
    )

    j = R.create_limiter(_cfg(R, "collective", algo=algo, devices=2),
                         backend="mesh", clock=R.ManualClock(T0))
    assert isinstance(j, JaxCollective)
    t = T.create_limiter(_cfg(T, "collective", algo=algo, devices=2),
                         backend="mesh", clock=T.ManualClock(T0),
                         device="cpu")
    rng = np.random.default_rng(9)
    try:
        for i in range(4):
            h = rng.integers(0, 1 << 64, size=100, dtype=np.uint64)
            h[::7] = h[0]
            ns = rng.integers(1, 3, size=100)
            _same(j.allow_hashed(h, ns, now=T0 + i * 3.0),
                  t.allow_hashed(h, ns, now=T0 + i * 3.0), i)
        assert j.fallbacks == t.fallbacks == 0
        _same_slices(j, t)
    finally:
        _close(j, t)
