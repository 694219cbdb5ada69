"""The replicated mesh tier (``MeshSketchLimiter``,
``MeshTokenBucketLimiter``: gather and delta merges) in the port, on the
CPU, against the JAX package's mesh limiters.

The port runs N replicas on ``cpu``; the JAX package runs the same
config on N of its 8 virtual CPU devices (``make_mesh``). Inputs are
made with NumPy from a seed; the tolerance is 0: every result field and
the replicated state (every replica of it, in the port) bit-identical.
Covered (the intent of tests/test_multichip.py,
tests/test_contract_mesh.py, tests/test_hh.py::TestHHMesh and the mesh
cases of test_hierarchy.py, test_checkpoint.py and test_dynamic_*.py):
gather and delta, windowed (CU and vanilla, sliding and fixed) and
token bucket, with the heavy-hitter side table and with the hierarchy
cascade; resets, rollovers and live limit and window updates; the
gather mode's global exactness and equality with one limiter fed the
global batch; the delta mode's one-step staleness envelope; and a
checkpoint taken on the port's mesh restored by the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.parallel import MeshSketchLimiter as JaxMesh
from ratelimiter_tpu.parallel import MeshTokenBucketLimiter as JaxMeshTB
from ratelimiter_tpu.parallel import make_mesh
from ratelimiter_tpu_torch.parallel import (
    Mesh,
    MeshSketchLimiter,
    MeshTokenBucketLimiter,
)

T0 = 1_700_000_000.0
FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


def _cfg(M, *, algo="SLIDING_WINDOW", limit=6, window=6.0, cu=True, hh=0,
         tenants=0):
    extra = {"kernels": "jnp"} if M is R else {}
    hier = (M.core.config.HierarchySpec(tenants=tenants, global_limit=60)
            if tenants else M.core.config.HierarchySpec())
    return M.Config(
        algorithm=getattr(M.Algorithm, algo), limit=limit, window=window,
        policy=M.core.config.PolicySpec(capacity=64),
        sketch=M.SketchParams(depth=2, width=512, sub_windows=6,
                              conservative_update=cu, hh_slots=hh,
                              hh_promote_fraction=0.5, **extra),
        hierarchy=hier)


def _pair(merge, n=2, **kw):
    tb = kw.get("algo") == "TOKEN_BUCKET"
    jcls = JaxMeshTB if tb else JaxMesh
    tcls = MeshTokenBucketLimiter if tb else MeshSketchLimiter
    j = jcls(_cfg(R, **kw), R.ManualClock(T0), mesh=make_mesh(n_devices=n),
             merge=merge)
    t = tcls(_cfg(T, **kw), T.ManualClock(T0), mesh=Mesh(["cpu"] * n),
             merge=merge)
    return j, t


def _same(a, b, i=None):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f"{f} (step {i})")


def _same_state(j, t):
    aj = j.capture_state()[1]
    at = t.capture_state()[1]
    assert set(aj) == set(at)
    for k in aj:
        x, y = np.asarray(aj[k]), np.asarray(at[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    # Every replica equals slice 0's.
    for rep in t._replicas:
        for k, v in rep.items():
            assert torch.equal(v.cpu(), t._state[k].cpu()), k


def _traffic(j, t, steps=4, seed=0, dt=0.8, hot=True):
    rng = np.random.default_rng(seed)
    for i in range(steps):
        keys = [f"k{x}" for x in rng.integers(0, 30, 40)]
        if hot:
            keys += ["hot"] * 9
        ns = rng.integers(1, 3, len(keys)).tolist()
        _same(j.allow_batch(keys, ns), t.allow_batch(keys, ns), i)
        ids = rng.integers(0, 50, 24).astype(np.uint64)
        _same(j.allow_ids(ids), t.allow_ids(ids), i)
        j.clock.advance(dt)
        t.clock.advance(dt)


CASES = {
    "sliding_cu": dict(),
    "sliding_vanilla": dict(cu=False),
    "fixed": dict(algo="FIXED_WINDOW"),
    "side_table": dict(hh=16),
    "cascade": dict(tenants=4),
    "bucket": dict(algo="TOKEN_BUCKET"),
    "bucket_cascade": dict(algo="TOKEN_BUCKET", tenants=4),
}


@pytest.mark.parametrize("merge", ["gather", "delta"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_matches_jax(merge, case):
    j, t = _pair(merge, **CASES[case])
    try:
        if CASES[case].get("tenants"):
            for m in (j, t):
                m.set_tenant("gold", 12)
                m.assign_tenant("hot", "gold")
        _traffic(j, t)
        _same_state(j, t)
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("merge", ["gather", "delta"])
@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_mesh_control_plane_matches_jax(merge, algo):
    """Overrides, a reset on every replica, a rollover-crossing jump and
    live limit and window updates, on three replicas."""
    j, t = _pair(merge, n=3, algo=algo)
    try:
        for m in (j, t):
            m.set_override("vip", 2)
        _traffic(j, t, steps=2, seed=1)
        for m in (j, t):
            m.reset("hot")
            m.update_limit(9)
        _traffic(j, t, steps=2, seed=2, dt=2.5)
        for m in (j, t):
            m.update_window(12.0)
        _traffic(j, t, steps=2, seed=3, dt=7.0)
        _same_state(j, t)
    finally:
        j.close()
        t.close()


def test_gather_global_exactness_and_single_limiter_equality():
    """One key over four replicas, limit L: exactly the first L admit;
    and the gather mesh equals one limiter fed the padded global batch
    in chip-major order, state included."""
    _, t = _pair("gather", n=4, limit=10)
    single = T.create_limiter(_cfg(T, limit=10), clock=T.ManualClock(T0),
                              device="cpu")
    try:
        out = t.allow_batch(["hot"] * 64)
        assert out.allowed[:10].all() and not out.allowed[10:].any()
        rng = np.random.default_rng(4)
        for _ in range(3):
            keys = [f"k{x}" for x in rng.integers(0, 20, 50)]
            _same(t.allow_batch(keys), single.allow_batch(keys))
        single.allow_batch(["hot"] * 64)
        a, b = t.capture_state()[1], single.capture_state()[1]
        for k in ("cur", "totals", "slabs"):
            np.testing.assert_array_equal(a[k], b[k])
    finally:
        t.close()
        single.close()


def test_delta_staleness_envelope():
    """Delta mode: a key hammered from every replica in one step admits
    at most n*limit, and every replica denies it from the next step on
    (the merged delta is on all of them)."""
    j, t = _pair("delta", n=4, limit=5, hh=16)
    try:
        keys = ["hot"] * 64
        rj, rt = j.allow_batch(keys), t.allow_batch(keys)
        _same(rj, rt)
        assert 5 <= rt.allow_count <= 20
        assert t.allow_batch(["hot"] * 16).allow_count == 0
        assert j.allow_batch(["hot"] * 16).allow_count == 0
        assert np.count_nonzero(t.capture_state()[1]["hh_owner"]) == 1
        _same_state(j, t)
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_mesh_checkpoint_restores_in_the_jax_package(tmp_path, algo):
    j, t = _pair("delta", algo=algo, hh=0)
    try:
        _traffic(j, t, steps=2, seed=5)
        path = str(tmp_path / "mesh.npz")
        t.save(path)
        j2, t2 = _pair("delta", algo=algo)
        j2.restore(path)
        t2.restore(path)
        _same_state(j2, t2)
        _traffic(j2, t2, steps=1, seed=6)
        j2.close()
        t2.close()
    finally:
        j.close()
        t.close()
