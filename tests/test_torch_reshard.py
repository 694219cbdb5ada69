"""Elastic re-bucketing (``parallel/reshard.py``) in the port, on the CPU,
against the JAX package's.

Snapshots are made by the port's sliced mesh (their bytes are the JAX
package's format) and re-bucketed by both packages: every array and the
metadata equal, for N -> M in {2 -> 4, 4 -> 2, 3 -> 2}, the windowed
sketch with and without the side table and the token bucket. Live
restores across a slice count equal the JAX mesh's restore, slice by
slice and decision by decision, and keep the contracts of
tests/test_reshard.py: never over-admit against the same-count restore,
overrides exact, ``N -> k*N -> N`` bit-identical, the side table folded,
the bucket's decay normalized exactly. The port's tool (``python -m
ratelimiter_tpu_torch.tools.rebucket``) writes what ``tools/rebucket.py``
writes. Counterparts of the six classes of tests/test_reshard.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.parallel import reshard as JR
from ratelimiter_tpu_torch.parallel import SlicedMeshLimiter
from ratelimiter_tpu_torch.parallel import reshard as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1000.0
META = "__ratelimiter_tpu_meta__"


def _cfg(M, n, *, limit=20, hh=0, algo="SLIDING_WINDOW"):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=600.0,
                    policy=M.core.config.PolicySpec(capacity=64),
                    sketch=M.SketchParams(depth=2, width=1024,
                                          sub_windows=6, hh_slots=hh,
                                          **extra),
                    mesh=M.core.config.MeshSpec(devices=n))


def _mesh(M, n, now=T0, **kw):
    opt = {} if M is R else {"device": "cpu"}
    return M.create_limiter(_cfg(M, n, **kw), backend="mesh",
                            clock=M.ManualClock(now), **opt)


def _load(path):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != META}
        meta = json.loads(bytes(z[META]).decode())
    return arrays, meta


def _same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _same_slices(j, t):
    assert j.n_slices == t.n_slices
    for sj, st in zip(j.sub_limiters(), t.sub_limiters()):
        _, a, ea = sj.capture_state()
        _, b, eb = st.capture_state()
        _same_arrays(a, b)
        assert ea.get("host_period") == eb.get("host_period")


def _same_results(a, b):
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


KEYS = [f"user:{i}" for i in range(60)]


def _source(tmp_path, n, *, hh=0, algo="SLIDING_WINDOW", limit=20,
            name=None):
    """A port mesh at ``n`` slices driven by seeded uneven traffic (hot
    keys near their limit), two overrides, saved; returns the path."""
    src = _mesh(T, n, hh=hh, algo=algo, limit=limit)
    rng = np.random.default_rng(7)
    for _ in range(8):
        src.allow_batch([KEYS[j] for j in rng.integers(0, 60, size=48)]
                        + KEYS[:6] * 2 + ["tenant:hot"] * 4)
        src.clock.advance(30.0 if algo != "TOKEN_BUCKET" else 0.5)
    src.set_override("user:3", 5)
    src.set_override("user:7", 200)
    path = str(tmp_path / (name or f"src{n}.npz"))
    src.save(path)
    now = src.clock.now()
    src.close()
    return path, now


# ------------------------------------------------------ TestContributors


def test_contributors_gcd_rule():
    assert TR.contributors(5, 4, 8) == [1]
    assert TR.contributors(1, 8, 4) == [1, 5]
    assert TR.contributors(2, 4, 3) == [0, 1, 2, 3]
    assert TR.contributors(3, 4, 4) == [3]
    for old in range(1, 9):
        for new in range(1, 9):
            for j in range(new):
                assert TR.contributors(j, old, new) == JR.contributors(
                    j, old, new)


# ---------------------------------------------------- TestReshardOracle


@pytest.mark.parametrize("algo,hh", [("SLIDING_WINDOW", 0),
                                     ("SLIDING_WINDOW", 16),
                                     ("TOKEN_BUCKET", 0)])
@pytest.mark.parametrize("n,m", [(2, 4), (4, 2), (3, 2)])
def test_rebucket_arrays_equal_jax(tmp_path, algo, hh, n, m):
    path, _ = _source(tmp_path, n, hh=hh, algo=algo)
    arrays, meta = _load(path)
    ja, jm = JR.rebucket_combined(arrays, meta, m, _cfg(R, n, hh=hh,
                                                        algo=algo))
    ta, tm = TR.rebucket_combined(arrays, meta, m, _cfg(T, n, hh=hh,
                                                        algo=algo))
    _same_arrays(ja, ta)
    assert jm == tm and tm["n_slices"] == m and tm["rebucketed_from"] == n
    states, extras = TR.split_combined(arrays, meta)
    js, je = JR.rebucket(states, extras, m)
    ts, te = TR.rebucket(states, extras, m)
    for a, b in zip(js, ts):
        _same_arrays(a, b)
    assert je == te


@pytest.mark.parametrize("m", [8, 3])
def test_never_over_admits_and_overrides_exact(tmp_path, m):
    path, now = _source(tmp_path, 4)
    oracle = _mesh(T, 4, now)
    oracle.restore(path)
    dst, jdst = _mesh(T, m, now), _mesh(R, m, now)
    dst.restore(path)
    jdst.restore(path)
    try:
        _same_slices(jdst, dst)
        assert dst.get_override("user:3").limit == 5
        assert dst.get_override("user:7").limit == 200
        assert dst.override_count() == oracle.override_count()
        ro = oracle.allow_batch(KEYS)
        rd = dst.allow_batch(KEYS)
        _same_results(jdst.allow_batch(KEYS), rd)
        assert not (rd.allowed & ~ro.allowed).any()
        assert not ro.allowed.all()
    finally:
        for x in (oracle, dst, jdst):
            x.close()


def test_split_then_merge_round_trip_bit_identical(tmp_path):
    path, now = _source(tmp_path, 4)
    mid = _mesh(T, 8, now)
    mid.restore(path)
    p8 = str(tmp_path / "snap8.npz")
    mid.save(p8)
    mid.close()
    back = _mesh(T, 4, now)
    back.restore(p8)
    p4 = str(tmp_path / "snap4.npz")
    back.save(p4)
    back.close()
    a, _ = _load(path)
    b, _ = _load(p4)
    _same_arrays(a, b)


def test_restore_slice_rebuckets_like_a_full_restore(tmp_path):
    """The port's ``restore_slice`` of a snapshot of another count gives
    the slice what a full re-bucketing restore gives it (the JAX package
    refuses this case; ROADMAP C records the divergence)."""
    path, now = _source(tmp_path, 4)
    full, one = _mesh(T, 3, now), _mesh(T, 3, now)
    full.restore(path)
    try:
        for i in range(3):
            one.restore_slice(path, i)
        for sf, so in zip(full.sub_limiters(), one.sub_limiters()):
            _same_arrays(sf.capture_state()[1], so.capture_state()[1])
        with pytest.raises(T.CheckpointError, match="out of range"):
            one.restore_slice(path, 3)
    finally:
        full.close()
        one.close()
    j = _mesh(R, 3, now)
    try:
        with pytest.raises(R.CheckpointError, match="rebucket"):
            j.restore_slice(path, 0)
    finally:
        j.close()


# --------------------------------------------------- TestHeavyHitterFold


def test_merge_folds_hh_counts_never_over_admits(tmp_path):
    src = _mesh(T, 4, hh=16)
    hot = "tenant:hot"
    for _ in range(6):
        src.allow_batch([hot] * 4)
        src.clock.advance(20.0)
    path = str(tmp_path / "hh.npz")
    src.save(path)
    now = src.clock.now()
    src.close()
    oracle, merged, jmerged = _mesh(T, 4, now, hh=16), _mesh(
        T, 2, now, hh=16), _mesh(R, 2, now, hh=16)
    for x in (oracle, merged, jmerged):
        x.restore(path)
    try:
        _same_slices(jmerged, merged)
        assert not oracle.allow_n(hot, 1).allowed
        assert not merged.allow_n(hot, 1).allowed
        assert not jmerged.allow_n(hot, 1).allowed
    finally:
        for x in (oracle, merged, jmerged):
            x.close()


# ------------------------------------------------- TestTokenBucketReshard


def test_debt_merge_never_over_admits(tmp_path):
    src = _mesh(T, 4, limit=10, algo="TOKEN_BUCKET")
    ids = np.arange(48, dtype=np.uint64)
    rng = np.random.default_rng(3)
    for _ in range(4):
        src.allow_ids(ids[rng.integers(0, 48, size=96)])
        src.clock.advance(0.5)
    path = str(tmp_path / "tb.npz")
    src.save(path)
    now = src.clock.now()
    src.close()
    oracle = _mesh(T, 4, now, limit=10, algo="TOKEN_BUCKET")
    dst = _mesh(T, 3, now, limit=10, algo="TOKEN_BUCKET")
    jdst = _mesh(R, 3, now, limit=10, algo="TOKEN_BUCKET")
    for x in (oracle, dst, jdst):
        x.restore(path)
    try:
        _same_slices(jdst, dst)
        ro, rd = oracle.allow_ids(ids), dst.allow_ids(ids)
        _same_results(jdst.allow_ids(ids), rd)
        assert not (rd.allowed & ~ro.allowed).any()
        assert not ro.allowed.all()
    finally:
        for x in (oracle, dst, jdst):
            x.close()


def test_decay_normalization_is_exact_mirror():
    from ratelimiter_tpu_torch.ops import bucket_kernels

    params = bucket_kernels._params(_cfg(T, 1, limit=10,
                                         algo="TOKEN_BUCKET"))
    num, den = params["rate_num"], params["rate_den"]
    assert (num, den) == JR._bucket_rate(_cfg(R, 1, limit=10,
                                              algo="TOKEN_BUCKET"))
    for elapsed, rem in [(0, 0), (123456, 17), (10**9, den - 1),
                         (10**13, 0), (1 << 62, 5)]:
        host = TR._decay_exact(elapsed, rem, num, den)
        assert host == JR._decay_exact(elapsed, rem, num, den)
        dev, _ = bucket_kernels._decay({"last": 0, "rem": rem}, elapsed,
                                       rate_num=num, rate_den=den)
        assert host == int(dev), (elapsed, rem)


# ------------------------------------------------------- TestMergeStates


def _sketch(M, now=T0):
    opt = {} if M is R else {"device": "cpu"}
    cfg = _cfg(M, None)
    return M.create_limiter(cfg, backend="sketch", clock=M.ManualClock(now),
                            **opt)


def test_identical_states_short_circuit_verbatim():
    lim = _sketch(T)
    lim.allow_batch([f"k{i}" for i in range(32)])
    _, arrays, extra = lim.capture_state()
    merged, _ = TR.merge_states([dict(arrays)] * 3, [dict(extra)] * 3)
    _same_arrays(arrays, merged)
    lim.close()


def test_merge_into_limiter_carries_counters_and_overrides():
    src = _sketch(T)
    for _ in range(20):
        src.allow_n("hot", 1)
    src.set_override("vip", 3)
    src.allow_batch([f"k{i}" for i in range(16)])
    _, arrays, extra = src.capture_state()
    dst, jdst = _sketch(T), _sketch(R)
    for d in (dst, jdst):
        for _ in range(4):
            d.allow_n("other", 1)
        d.clock.advance(130.0)
        d.allow_n("other", 1)
    TR.merge_into_limiter(dst, arrays, extra)
    JR.merge_into_limiter(jdst, dict(arrays), dict(extra))
    _same_arrays(jdst.capture_state()[1], dst.capture_state()[1])
    assert not dst.allow_n("hot", 1).allowed
    assert dst.get_override("vip").limit == 3
    r = dst.allow_n("other", 1)
    assert r.allowed and r.remaining <= 20 - 6
    for x in (src, dst, jdst):
        x.close()


# ------------------------------------------------------ TestRebucketTool


def test_cli_writes_what_the_jax_tool_writes(tmp_path):
    """plain -> 3-slice mesh -> plain through the port's tool (one leg as
    ``python -m``, the other in-process) and the JAX tool: every output
    file's arrays and metadata equal, the round trip bit-identical, and
    both forms restore into the port's live limiters."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import rebucket as jax_tool
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    from ratelimiter_tpu_torch.tools import rebucket as port_tool

    lim = _sketch(T)
    lim.allow_batch([f"k{i}" for i in range(40)])
    lim.set_override("vip", 9)
    plain = str(tmp_path / "plain.npz")
    lim.save(plain)
    now = lim.clock.now()
    lim.close()
    mesh3, back = str(tmp_path / "mesh3.npz"), str(tmp_path / "back.npz")
    out = subprocess.run(
        [sys.executable, "-m", "ratelimiter_tpu_torch.tools.rebucket",
         plain, mesh3, "--slices", "3"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "(3 slice(s), kind=mesh:sketch)" in out.stdout
    assert port_tool.main([mesh3, back, "--slices", "1"]) == 0
    jmesh3, jback = str(tmp_path / "j3.npz"), str(tmp_path / "jb.npz")
    jax_tool.rebucket_file(plain, jmesh3, 3)
    jax_tool.rebucket_file(jmesh3, jback, 1)
    for mine, theirs in ((mesh3, jmesh3), (back, jback)):
        a, am = _load(mine)
        b, bm = _load(theirs)
        _same_arrays(a, b)
        assert am == bm
    a, _ = _load(plain)
    b, _ = _load(back)
    _same_arrays(a, b)
    m = SlicedMeshLimiter(_cfg(T, None), T.ManualClock(now),
                          devices=["cpu"] * 3)
    m.restore(mesh3)
    assert m.get_override("vip").limit == 9
    m.close()
    p = _sketch(T, now)
    p.restore(back)
    assert p.get_override("vip").limit == 9
    p.close()


def test_cli_rejects_bad_slices(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "ratelimiter_tpu_torch.tools.rebucket",
         "in.npz", "out.npz", "--slices", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "--slices must be >= 1" in out.stderr
