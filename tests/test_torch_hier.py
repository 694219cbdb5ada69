"""The hierarchy cascade (``hierarchy.tenants > 0``, ADR-020) in the port,
on the CPU, against the JAX package's ``jnp`` path.

Inputs are made with NumPy from a seed and go through both packages; the
tolerance is 0 (bit-identical). Covered: the plain ``derive_tids``,
``scope_avail`` and ``cascade_admit`` against the JAX functions on
contended, uncontended and one-tenant batches at T = 4, 16, 32, 64 and
4096 (the reference admits with int32 sums up to 64 scopes, int64
above: T = 32 and 64 straddle it), and the survivor mass past 2^31
where the int32 sums wrap (the reference defect the port keeps, ROADMAP
C5); the ``TenantTable`` copy (mutations, errors, host arrays, payloads,
``hier_*`` columns); both limiters end to end (windowed CU and vanilla,
sliding and fixed, with and without the side table, and the token
bucket) with overrides, resets, rollovers and the bucket's window
crossing, live ``update_limit``/``update_window``, moved effective
limits and checkpoints in both directions, every decision field and
every state array (``tn_*`` and ``hier_*`` included) held equal; the
enabled spec's checkpoint fingerprint; and the AIMD controller through
the JAX package's abuse scenarios (``evaluation/scenarios.py``) on a
ManualClock, the result dicts equal. ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the CUDA kernels to the plain versions.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.checkpoint import config_fingerprint as jax_fingerprint
from ratelimiter_tpu.evaluation import scenarios
from ratelimiter_tpu.hierarchy import AIMDController as JaxController
from ratelimiter_tpu.hierarchy import AIMDGains as JaxGains
from ratelimiter_tpu.hierarchy import TenantTable as JaxTable
from ratelimiter_tpu.ops import hier_kernels as jhk
from ratelimiter_tpu_torch.checkpoint import config_fingerprint
from ratelimiter_tpu_torch.hierarchy import AIMDController, AIMDGains
from ratelimiter_tpu_torch.hierarchy import TenantTable
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.ops import hier_kernels as thk

T0 = 1_700_000_000.0
RESULT_FIELDS = ("allowed", "remaining", "retry_after", "reset_at")


# ------------------------------------------------------ the plain kernels


@lru_cache(maxsize=None)
def _jax_cascade(tenants: int, iters: int = 4):
    return jax.jit(lambda a, t, n, av, w: jhk.cascade_admit(
        a, t, n, av, w, tenants, iters))


def _case(rng, B: int, tenants: int, kind: str) -> dict:
    """Stage-1 verdicts, tenant ids, request counts 0-3, scope
    availability and weights: contended (about half each tenant's
    demand free, a third of the total at the global scope), uncontended
    (everything fits), or every request in one tenant."""
    allowed_key = rng.random(B) < 0.85
    tid = (np.full(B, 1) if kind == "one tenant"
           else rng.integers(0, tenants, size=B)).astype(np.int64)
    n = rng.integers(0, 4, size=B).astype(np.int64)
    demand = np.bincount(tid, weights=n * allowed_key,
                         minlength=tenants + 1).astype(np.int64)
    if kind == "uncontended":
        avail = demand + rng.integers(0, 5, size=tenants + 1)
        avail[tenants] = demand.sum()
    else:
        avail = demand // 2 + rng.integers(0, 3, size=tenants + 1)
        avail[tenants] = demand.sum() // 3
    return {"allowed_key": allowed_key, "tid": tid, "n": n,
            "avail": avail.astype(np.int64),
            "weights": rng.integers(1, 6, size=tenants + 1).astype(np.int64)}


def _both(case: dict, tenants: int):
    got = thk.cascade_admit(*(torch.from_numpy(case[k]) for k in (
        "allowed_key", "tid", "n", "avail", "weights")), tenants, 4)
    want = _jax_cascade(tenants)(
        jnp.asarray(case["allowed_key"]),
        jnp.asarray(case["tid"], jnp.int32), jnp.asarray(case["n"]),
        jnp.asarray(case["avail"]), jnp.asarray(case["weights"]))
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("tenants", [4, 16, 32, 64, 4096])
@pytest.mark.parametrize("kind", ["contended", "uncontended", "one tenant"])
def test_cascade_admit_matches_jax(tenants, kind):
    """Both branches of the reference's cond, both tenant-domain paths
    (T + 1 <= 64 dense int32, above it int64), and one tenant's 4096
    requests as one segment."""
    case = _case(np.random.default_rng(tenants + len(kind)), 4096, tenants,
                 kind)
    got, want = _both(case, tenants)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype.newbyteorder("=") or g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    flipped = int((got[0] != case["allowed_key"]).sum())
    assert (flipped == 0) == (kind == "uncontended")


@pytest.mark.parametrize("tenants,admitted", [(4, 256), (128, 200)])
def test_survivor_mass_past_2_31_wraps_like_the_reference(tenants,
                                                          admitted):
    """256 key-scope survivors of n = 2^24 - 1 in tenant 0 against a
    tenant availability of 200 * n: the reference's dense path (T = 4)
    sums in int32, which wraps past 2^31 and admits all 256 (a defect of
    the JAX package, ROADMAP C5); its int64 path (T = 128) admits exactly
    200. The port gives the same bits on both."""
    nval = (1 << 24) - 1
    case = {"allowed_key": np.ones(256, bool),
            "tid": np.zeros(256, np.int64),
            "n": np.full(256, nval, np.int64),
            "avail": np.full(tenants + 1, 1 << 40, np.int64),
            "weights": np.ones(tenants + 1, np.int64)}
    case["avail"][0] = 200 * nval
    got, want = _both(case, tenants)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(got[0].sum()) == admitted


def _tables(rng, tenants: int):
    """The same TenantTable in both packages (a seeded registry and key
    map), and the key function they share."""
    def key_fn(k: str) -> int:
        return int.from_bytes(k.encode().ljust(8, b"\0")[:8], "little") >> 2

    cfgs = [M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=10,
                     window=6.0, hierarchy=M.HierarchySpec(
                         tenants=tenants, map_capacity=64,
                         global_limit=500, default_tenant_limit=40))
            for M in (R, T)]
    tabs = [JaxTable(cfgs[0], key_fn=key_fn),
            TenantTable(cfgs[1], key_fn=key_fn)]
    for tab in tabs:
        tab.set_tenant("gold", 60, 3, 10)
        tab.set_tenant("free", 20)
        tab.set_tenant("t3", None, 2)
        for i in range(40):
            tab.assign(f"k{i:02d}", ("gold", "free", "t3")[i % 3])
    return tabs, key_fn


def test_derive_tids_and_scope_avail_match_jax():
    rng = np.random.default_rng(3)
    (jt, tt), key_fn = _tables(rng, 4)
    host = tt.host_arrays()
    for k, v in jt.host_arrays().items():
        np.testing.assert_array_equal(v, host[k], err_msg=k)
    skeys = np.array([key_fn(f"k{i:02d}") for i in range(60)], np.uint64)
    h1 = (skeys >> np.uint64(32)).astype(np.int64)
    h2 = (skeys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    got = thk.derive_tids({k: torch.from_numpy(v) for k, v in host.items()},
                          torch.from_numpy(h1), torch.from_numpy(h2), 4)
    want = jhk.derive_tids({k: jnp.asarray(v) for k, v in host.items()},
                           jnp.asarray(h1, jnp.uint32),
                           jnp.asarray(h2, jnp.uint32), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got.numpy().tolist()) == {0, 1, 2, 3}
    counts = rng.integers(-5, 600, size=5)
    np.testing.assert_array_equal(
        thk.scope_avail(torch.from_numpy(host["limit"]),
                        torch.from_numpy(counts)).numpy(),
        np.asarray(jhk.scope_avail(jnp.asarray(host["limit"]),
                                   jnp.asarray(counts))))


# --------------------------------------------------------- the registry


def _same_table(jt, tt, history: bool = True):
    for k, v in jt.host_arrays().items():
        np.testing.assert_array_equal(v, tt.host_arrays()[k], err_msg=k)
    sj, st = jt.snapshot_arrays(), tt.snapshot_arrays()
    assert sorted(sj) == sorted(st)
    for k in sj:
        assert sj[k].dtype == st[k].dtype, k
        np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
    assert jt.effective_limits() == tt.effective_limits()
    assert jt.effective_payload() == tt.effective_payload()
    assert jt.assignments() == tt.assignments()
    assert jt.revision == tt.revision
    if history:
        assert jt.version == tt.version


def test_tenant_table_matches_jax():
    """Mutations, refusals (same messages), effective-limit clamping,
    payload adoption and the hier_* columns round trip."""
    (jt, tt), _ = _tables(np.random.default_rng(1), 4)
    _same_table(jt, tt)
    ops = [("set_effective", ("gold", 3)), ("set_effective", ("free", 15)),
           ("set_effective", ("global", 10 ** 9)),
           ("set_global_limit", (300,)), ("set_tenant", ("gold", 8, 2, 4)),
           ("unassign", ("k03",)), ("assign", ("k03", "default")),
           ("delete_tenant", ("t3",)), ("set_tenant", ("t4", 5, 1, 1)),
           ("set_tenant", ("t5", 5)), ("set_tenant", ("x", -1)),
           ("set_tenant", ("x", 5, 0)), ("assign", ("k99", "nope")),
           ("delete_tenant", ("default",)), ("set_effective", ("nope", 1)),
           ("apply_effective_payload", ({"revision": 99, "effective": {
               "gold": 6, "global": 250, "ghost": 1}},)),
           ("apply_effective_payload", ({"revision": 3},))]
    for name, args in ops:
        outs = []
        for tab in (jt, tt):
            try:
                outs.append(("ok", getattr(tab, name)(*args)))
            except Exception as exc:       # noqa: BLE001 — compared below
                outs.append((type(exc).__name__, str(exc)))
        if isinstance(outs[0][1], R.hierarchy.Tenant):
            outs = [(o[0], dataclasses.astuple(o[1])) for o in outs]
        assert outs[0] == outs[1], name
        _same_table(jt, tt)
    arrays = tt.snapshot_arrays()
    (jt2, tt2), _ = _tables(np.random.default_rng(2), 4)
    jt2.restore_arrays(dict(arrays))
    tt2.restore_arrays(dict(jt.snapshot_arrays()))
    _same_table(jt2, tt2)
    _same_table(jt, tt2, history=False)


# ------------------------------------------------- the limiters end to end


def _cfg(M, algo="SLIDING_WINDOW", *, cu=True, hh_slots=0, tenants=4):
    sketch = dict(depth=2, width=256, sub_windows=6, conservative_update=cu,
                  hh_slots=hh_slots)
    if M is R:
        sketch["kernels"] = "jnp"
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=12,
                    window=6.0, max_batch_admission_iters=4,
                    sketch=M.SketchParams(**sketch),
                    hierarchy=M.HierarchySpec(
                        tenants=tenants, map_capacity=32, global_limit=90,
                        default_tenant_limit=40))


def _same_state(lj, lt):
    sj, st = lj.capture_state()[1], lt.capture_state()[1]
    assert sorted(sj) == sorted(st)
    for k in sj:
        a = np.asarray(sj[k])
        assert a.dtype == st[k].dtype, k
        np.testing.assert_array_equal(a, st[k], err_msg=k)


def _same(a, b):
    for f in RESULT_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _boot(lim):
    lim.set_override("k1", 5)
    lim.set_tenant("gold", 30, weight=3, floor=4)
    lim.set_tenant("free", 14)
    lim.set_tenant("t3", None, weight=2)
    for i in range(12):
        lim.assign_tenant(f"k{i}", ("gold", "free", "t3", "default")[i % 4])


def _traffic(rng, pair, steps: int, advance: float):
    """Mixed string and hashed batches through both limiters, each result
    and the whole state held equal after every step."""
    lj, lt = pair
    for step in range(steps):
        # One padded size (32) for both lanes: one compile in the JAX
        # package per step build.
        keys = [f"k{int(i)}" for i in rng.zipf(1.3, size=int(
            rng.integers(17, 33))) % 16]
        ns = rng.integers(1, 4, size=len(keys))
        _same(lj.allow_batch(keys, ns), lt.allow_batch(keys, ns))
        h64 = rng.integers(0, 40, size=32).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        _same(lj.allow_hashed(h64), lt.allow_hashed(h64))
        _same_state(lj, lt)
        for lim in pair:
            lim.clock.advance(advance)


@pytest.mark.parametrize("algo,cu,hh_slots", [
    ("SLIDING_WINDOW", True, 0), ("SLIDING_WINDOW", False, 0),
    ("FIXED_WINDOW", True, 0), ("FIXED_WINDOW", False, 16),
    ("SLIDING_WINDOW", True, 16), ("TOKEN_BUCKET", True, 0)])
def test_limiters_match_jax(tmp_path, algo, cu, hh_slots):
    """Contention at every scope, rollovers (the bucket's counters across
    their fixed window), a reset, a moved effective limit, live limit
    and window updates, and checkpoints from each package restored into
    the other, each followed by more traffic."""
    rng = np.random.default_rng(len(algo) + cu + hh_slots)
    pair = (R.create_limiter(_cfg(R, algo, cu=cu, hh_slots=hh_slots),
                             backend="sketch", clock=R.ManualClock(T0)),
            T.create_limiter(_cfg(T, algo, cu=cu, hh_slots=hh_slots),
                             clock=T.ManualClock(T0), device="cpu"))
    lj, lt = pair
    for lim in pair:
        _boot(lim)
    _traffic(rng, pair, 10, 0.7)
    for lim in pair:
        lim.reset("k1")
        assert lim.set_effective("gold", 9) == 9
    _traffic(rng, pair, 6, 0.7)
    assert lj.hierarchy_stats() == lt.hierarchy_stats()
    assert lt.hierarchy_stats()["global"]["in_window"] > 0
    for lim in pair:
        lim.update_limit(9)
        if algo != "TOKEN_BUCKET":
            lim.update_window(4.0)
    _traffic(rng, pair, 6, 0.9)
    lj.save(str(tmp_path / "jax.npz"))
    lt.save(str(tmp_path / "torch.npz"))
    lj.restore(str(tmp_path / "torch.npz"))
    lt.restore(str(tmp_path / "jax.npz"))
    _same_state(lj, lt)
    assert lj.effective_limits() == lt.effective_limits()
    _traffic(rng, pair, 4, 1.3)
    assert lj.hierarchy_stats() == lt.hierarchy_stats()
    for lim in pair:
        lim.close()


@pytest.mark.parametrize("algo,cu", [("SLIDING_WINDOW", True),
                                     ("SLIDING_WINDOW", False),
                                     ("TOKEN_BUCKET", True)])
def test_batch_above_admit_capacity_matches_jax(algo, cu):
    """A tenant batch of ADMIT_CAPACITY + 1 requests, which the card runs
    composed (the plain admission and cascade, then the standalone update
    kernel; tests/test_torch_cuda.py pins the card), decides as the JAX
    package decides it, contended at every scope; the state after it too."""
    from ratelimiter_tpu_torch.ops.sketch_cuda import ADMIT_CAPACITY

    pair = (R.create_limiter(_cfg(R, algo, cu=cu), backend="sketch",
                             clock=R.ManualClock(T0)),
            T.create_limiter(_cfg(T, algo, cu=cu), clock=T.ManualClock(T0),
                             device="cpu"))
    for lim in pair:
        _boot(lim)
    h64 = (np.arange(ADMIT_CAPACITY + 1, dtype=np.uint64) % np.uint64(97)
           * np.uint64(0x9E3779B97F4A7C15))
    got = pair[1].allow_hashed(h64)
    _same(pair[0].allow_hashed(h64), got)
    assert 0 < got.allowed.sum() < len(h64)
    _same_state(*pair)
    for lim in pair:
        lim.close()


def test_reset_and_idle_stats_leave_tenant_counters():
    """A reset forgives the key, not its tenant; an idle windowed limiter
    reports expired mass as 0 (the stats kick the rollover), and the
    bucket's counters of an earlier window read as 0."""
    for algo in ("SLIDING_WINDOW", "TOKEN_BUCKET"):
        pair = (R.create_limiter(_cfg(R, algo), backend="sketch",
                                 clock=R.ManualClock(T0)),
                T.create_limiter(_cfg(T, algo), clock=T.ManualClock(T0),
                                 device="cpu"))
        for lim in pair:
            _boot(lim)
            for _ in range(5):
                lim.allow_n("k0", 2)
            lim.reset("k0")
        st = [lim.hierarchy_stats() for lim in pair]
        assert st[0] == st[1] and st[1]["tenants"]["gold"]["in_window"] > 0
        for lim in pair:
            lim.clock.advance(61.0)
        st = [lim.hierarchy_stats() for lim in pair]
        assert st[0] == st[1] and st[1]["global"]["in_window"] == 0
        for lim in pair:
            lim.close()


def test_enabled_fingerprint_matches_jax():
    """An enabled spec takes part in the fingerprint, as in the JAX
    package (so checkpoints cross); a disabled one does not."""
    for tenants in (0, 4, 4096):
        pair = [dataclasses.replace(
            _cfg(M), hierarchy=dataclasses.replace(
                _cfg(M).hierarchy, tenants=tenants)) for M in (R, T)]
        assert jax_fingerprint(pair[0]) == config_fingerprint(pair[1])
    plain = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=4,
                     window=60.0)
    same = dataclasses.replace(plain, hierarchy=T.HierarchySpec(
        map_capacity=1 << 16))
    assert config_fingerprint(plain) == config_fingerprint(same)


def test_spec_validation_matches_jax():
    for kw in ({"tenants": 3}, {"tenants": 1 << 13}, {"map_capacity": 6},
               {"global_limit": -1}, {"default_tenant_limit": 1 << 40},
               {"tenants": 4, "global_limit": True}):
        msgs = []
        for M in (R, T):
            with pytest.raises(M.InvalidConfigError) as ei:
                M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=4,
                         window=60.0,
                         hierarchy=M.HierarchySpec(**kw)).validate()
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------- the controller, scenarios


def _scenario_limiter(M, spec: dict, *, hh_slots: int = 0):
    cfg = M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=100_000,
                   window=60.0,
                   sketch=M.SketchParams(depth=3, width=1 << 12,
                                         sub_windows=4, hh_slots=hh_slots,
                                         **({"kernels": "jnp"} if M is R
                                            else {})),
                   hierarchy=M.HierarchySpec(**spec))
    clock = M.ManualClock(T0)
    kw = {"backend": "sketch"} if M is R else {"device": "cpu"}
    return M.create_limiter(cfg, clock=clock, **kw), clock


def test_scenarios_match_jax():
    """bench.py's three abuse scenarios in both packages: the hot-tenant
    storm with the AIMD controller ticking per frame (tighten, then
    recover), the rotating-key attacker and the thundering herd, whose
    contended global scope splits 12/24/60 by weight 1:2:5."""
    results = []
    for M, Ctl, Gains in ((R, JaxController, JaxGains),
                          (T, AIMDController, AIMDGains)):
        out = {}
        lim, clock = _scenario_limiter(M, {"tenants": 8,
                                           "global_limit": 1200})
        lim.set_tenant("attacker", 1000, weight=1, floor=50)
        lim.set_tenant("victim", 1000, weight=6, floor=50)
        for i in range(40):
            lim.assign_tenant(f"atk{i}", "attacker")
        for i in range(8):
            lim.assign_tenant(f"vic{i}", "victim")
        kw = {} if M is R else {"registry": Registry()}
        ctl = Ctl(lim, interval=999.0, gains=Gains(
            decrease_factor=0.7, increase_fraction=0.2, cooldown_s=0.0),
            **kw)
        out["storm"] = scenarios.run_hot_tenant_storm(
            lim, clock, controller=ctl, batch=160,
            frames_per_phase=6).as_dict()
        out["storm_stats"] = lim.hierarchy_stats()
        lim.close()
        lim, clock = _scenario_limiter(
            M, {"tenants": 8, "global_limit": 10_000,
                "default_tenant_limit": 200}, hh_slots=64)
        lim.set_tenant("legit", 10_000, weight=4)
        for i in range(16):
            lim.assign_tenant(f"legit{i}", "legit")
        out["rotating"] = scenarios.run_rotating_key(
            lim, clock, batch=256, frames=8).as_dict()
        lim.close()
        weights = {"small": 1, "mid": 2, "big": 5}
        lim, clock = _scenario_limiter(M, {"tenants": 8,
                                           "global_limit": 96})
        for name, w in weights.items():
            lim.set_tenant(name, 10_000, weight=w)
            for i in range(16):
                lim.assign_tenant(f"{name}_k{i}", name)
        out["herd"] = scenarios.run_thundering_herd(
            lim, clock, tenants=weights, keys_per_tenant=16,
            bursts_per_key=4).as_dict()
        lim.close()
        results.append(out)
    assert results[0] == results[1]
    storm = results[1]["storm"]["controller"]
    assert storm["tightened"] > 0 and storm["relaxed"] > 0
    assert storm["attacker_effective_min"] < storm["attacker_ceiling"]
    assert results[1]["rotating"]["contained"]
    # The herd's warm-up request takes one unit of the global 96 first.
    assert results[1]["herd"]["per_tenant_admitted"] == {
        "big": 59, "mid": 23, "small": 11}


def test_fair_share_splits_12_24_60():
    """docs/EXAMPLES.md's weighted fair sharing (examples/17): 192
    requests of three tenants weighted 1:2:5 at once against a global
    limit of 96 admit exactly 12/24/60, in both packages."""
    weights = {"small": 1, "mid": 2, "big": 5}
    got = []
    for M in (R, T):
        cfg = M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=1000,
                       window=60.0, sketch=M.SketchParams(
                           depth=2, width=1 << 12, sub_windows=4,
                           **({"kernels": "jnp"} if M is R else {})),
                       hierarchy=M.HierarchySpec(tenants=4, global_limit=96))
        kw = {"backend": "sketch"} if M is R else {"device": "cpu"}
        lim = M.create_limiter(cfg, clock=M.ManualClock(T0), **kw)
        keys = []
        for name, w in weights.items():
            lim.set_tenant(name, 10_000, weight=w)
            for i in range(16):
                lim.assign_tenant(f"{name}_k{i}", name)
                keys.extend([f"{name}_k{i}"] * 4)
        np.random.default_rng(5).shuffle(keys)
        ok = np.asarray(lim.allow_batch(keys).allowed, dtype=bool)
        got.append({name: int(sum(a for k, a in zip(keys, ok)
                                  if k.startswith(name)))
                    for name in weights})
        lim.close()
    assert got[0] == got[1] == {"small": 12, "mid": 24, "big": 60}
