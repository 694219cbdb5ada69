"""The port's evaluation path (on the CPU) against the JAX package's.

Covered, each fed NumPy inputs made from a seed (or the same counters)
and held with tolerance 0 (bit for bit) unless stated:

* the device load generator: ``_splitmix64_dev`` and ``_zipf_ids`` over
  2^20 counters (the ids need XLA's own float32 ``log1p``/``exp``, which
  ``loadgen.xla_log1p_f32``/``xla_exp_f32`` spell out; they are held to
  ``jnp.log1p``/``jnp.exp`` on 2^20 inputs too);
* ``build_bench_chunk``: packed masks, deny counts and the whole sketch
  state over chunks across a rollover;
* the device oracle: ``init_oracle_state``, ``build_oracle_rollover`` and
  ``build_eval_chunk``'s four stats and both states;
* ``ShadowComparator`` tallies (windowed and token bucket, twin and
  oracle) and ``evaluate_accuracy``'s report, field by field;
* ``evaluation/scenarios.py`` (the port's copy) on the port's limiters
  against the JAX copy on the JAX limiters.

Geometry is cut to CPU size (d <= 3, w <= 2^12, short windows); the
JAX side runs its ``jnp`` reference path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.evaluation import accuracy as jacc
from ratelimiter_tpu.evaluation import compare as jcmp
from ratelimiter_tpu.evaluation import loadgen as jlg
from ratelimiter_tpu.evaluation import oracle_device as jor
from ratelimiter_tpu.evaluation import scenarios as jsc
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu_torch.convert import state_from_numpy, state_to_numpy
from ratelimiter_tpu_torch.evaluation import accuracy as tacc
from ratelimiter_tpu_torch.evaluation import compare as tcmp
from ratelimiter_tpu_torch.evaluation import loadgen as tlg
from ratelimiter_tpu_torch.evaluation import oracle_device as tor
from ratelimiter_tpu_torch.evaluation import scenarios as tsc
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk

N20 = 1 << 20
T0_US = 1_700_000_000 * 1_000_000


def _cfg(M, algo="SLIDING_WINDOW", cu=True, **kw):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=20,
                    window=6.0, max_batch_admission_iters=1,
                    sketch=M.SketchParams(depth=3, width=1 << 12,
                                          sub_windows=6,
                                          conservative_update=cu, **extra),
                    **kw)


def _same_state(jst, tst, msg=""):
    want = {k: np.asarray(v) for k, v in jst.items()}
    got = state_to_numpy(tst)
    assert set(want) == set(got), msg
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{msg} {k}")


def _torch_state(jst):
    return state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                            "cpu")


# ----------------------------------------------------------- load generator


@pytest.mark.parametrize("c0", [0, 2 ** 63 + 5, 2 ** 64 - 1000])
def test_splitmix64_over_2_20_counters(c0):
    """The u64 stream, as int64 bits, wrapping past 2^64 like uint64."""
    want = np.asarray(jax.jit(lambda c: jlg._splitmix64_dev(
        c + jax.lax.iota(jnp.uint64, N20)))(jnp.uint64(c0)))
    ctr = torch.arange(N20, dtype=torch.int64) + tlg._i64(c0)
    got = tlg._splitmix64_dev(ctr).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_keys,alpha,c0", [
    (1_000_000, 1.1, 0), (1_000_000, 1.1, 3 * N20),
    (50_000, 1.1, 2 ** 64 - 77), (20_000, 1.3, 12345)])
def test_zipf_ids_over_2_20_counters(n_keys, alpha, c0):
    """``_zipf_ids``: every one of 2^20 ids equals the JAX package's
    (XLA's float32 log1p/exp on the CPU, spelled out)."""
    want = np.asarray(jax.jit(lambda c: jlg._zipf_ids(c, N20, n_keys,
                                                      alpha))(
        jnp.uint64(c0)))
    got = tlg._zipf_ids(c0, N20, n_keys, alpha, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    assert 0 <= int(got.min()) and int(got.max()) < n_keys


def test_xla_log1p_and_exp_match_jnp():
    """The two spelled-out functions against jnp's on 2^20 float32
    inputs each: log1p over (-1, 1), exp over [-80, 80] (results above
    XLA's denormal flush)."""
    rng = np.random.default_rng(1)
    x = (rng.random(N20) * 1.999 - 0.9995).astype(np.float32)
    p = (rng.random(N20) * 160 - 80).astype(np.float32)
    for f, jf, v in ((tlg.xla_log1p_f32, jnp.log1p, x),
                     (tlg.xla_exp_f32, jnp.exp, p)):
        want = np.asarray(jax.jit(jf)(v)).view(np.int32)
        got = f(torch.from_numpy(v)).numpy().view(np.int32)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- bench chunk


@pytest.mark.parametrize("cu", [True, False], ids=["cu", "vanilla"])
def test_bench_chunk_matches_jax(cu):
    """Chunks of 1024 Zipf requests over 5,000 keys across two rollovers:
    packed masks, deny counts and the state after each."""
    jc, tc = _cfg(R, cu=cu), _cfg(T, cu=cu)
    B, n_keys = 1024, 5000
    jchunk = jlg.build_bench_chunk(jc, B, n_keys, 1.1)
    tchunk = tlg.build_bench_chunk(tc, B, n_keys, 1.1, device="cpu")
    _, sub_us, _, _, _ = jsk.sketch_geometry(jc)
    _, _, jroll = jsk.build_steps(jc)
    _, _, troll = tsk.build_steps(tc)
    p = T0_US // sub_us
    js = jroll(jsk.init_state(jc), jnp.int64(p))
    ts = _torch_state(jsk.init_state(jc))
    troll(ts, p)
    denies = 0
    for i in range(6):
        t = T0_US + i * 450_000
        if t // sub_us > p:
            p = t // sub_us
            js = jroll(js, jnp.int64(p))
            troll(ts, p)
        js, jp, jd = jchunk(js, jnp.uint64(i * B), jnp.int64(t))
        ts, tp, td = tchunk(ts, i * B, t, period=p)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        assert int(jd) == int(td) and td.dtype == torch.int32
        denies += int(td)
        _same_state(js, ts, str(i))
    assert denies > 0


# ----------------------------------------------------------- device oracle


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW"])
def test_eval_chunk_matches_jax(algo):
    """``build_eval_chunk``: the four stats and both states (the sketch's
    and the oracle's (S, 1, next_pow2(n_keys)) ring) after each chunk,
    rolled over by ``build_oracle_rollover``; the oracle's geometry and
    fresh state as the JAX package's."""
    jc, tc = _cfg(R, algo), _cfg(T, algo)
    B, n_keys = 1024, 3000
    jg, tg = jor.oracle_geometry(jc, n_keys), tor.oracle_geometry(tc, n_keys)
    for k in ("limit", "sub_us", "SW", "S", "d", "w", "iters", "weighted",
              "conservative"):
        assert jg[k] == tg[k], k
    jchunk = jor.build_eval_chunk(jc, B, n_keys, 1.1)
    tchunk = tor.build_eval_chunk(tc, B, n_keys, 1.1, device="cpu")
    jroll_or = jor.build_oracle_rollover(jc, n_keys)
    troll_or = tor.build_oracle_rollover(tc, n_keys)
    _, sub_us, _, _, _ = jsk.sketch_geometry(jc)
    _, _, jroll = jsk.build_steps(jc)
    _, _, troll = tsk.build_steps(tc)
    p = T0_US // sub_us
    jo0 = jor.init_oracle_state(jc, n_keys)
    to0 = tor.init_oracle_state(tc, n_keys, device="cpu")
    _same_state(jo0, to0, "fresh oracle")
    js = {"sk": jroll(jsk.init_state(jc), jnp.int64(p)),
          "or": jroll_or(jo0, jnp.int64(p))}
    ts = {"sk": _torch_state(jsk.init_state(jc)), "or": to0}
    troll(ts["sk"], p)
    troll_or(ts["or"], p)
    total = np.zeros(4, np.int64)
    for i in range(6):
        t = T0_US + i * 700_000
        if t // sub_us > p:
            p = t // sub_us
            js = {"sk": jroll(js["sk"], jnp.int64(p)),
                  "or": jroll_or(js["or"], jnp.int64(p))}
            troll(ts["sk"], p)
            troll_or(ts["or"], p)
        js, jstats = jchunk(js, jnp.uint64(i * B), jnp.int64(t))
        ts, tstats = tchunk(ts, i * B, t, period=p)
        np.testing.assert_array_equal(np.stack([np.asarray(s)
                                                for s in jstats]),
                                      tstats.numpy())
        total += tstats.numpy()
        for k in ("sk", "or"):
            _same_state(js[k], ts[k], f"{i} {k}")
    assert total[3] > 0 and total[2] >= total[3]


# ----------------------------------------------------------- comparator


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW",
                                  "TOKEN_BUCKET"])
def test_shadow_comparator_matches_jax(algo):
    """The same (h64, ns, now, live) stream through both packages'
    ShadowComparator (twin and oracle): the oracle and twin verdicts of
    every batch and the tally, field by field; ``update_policy``
    midway."""
    rng = np.random.default_rng(8)
    kw = dict(limit=8, window=3.0, key_prefix="")
    jc = R.Config(algorithm=getattr(R.Algorithm, algo), **kw,
                  sketch=R.SketchParams(depth=2, width=64, sub_windows=3,
                                        kernels="jnp"))
    tc = T.Config(algorithm=getattr(T.Algorithm, algo), **kw,
                  sketch=T.SketchParams(depth=2, width=64, sub_windows=3))
    jsh = jcmp.ShadowComparator(jc, twin_width=1 << 10)
    tsh = tcmp.ShadowComparator(tc, twin_width=1 << 10, device="cpu")
    pool = rng.integers(0, 2 ** 63, size=50, dtype=np.uint64)
    now = 1_700_000_000.0
    for i in range(10):
        h = pool[rng.integers(0, 50, size=64)]
        ns = rng.integers(1, 3, size=64) if i % 2 else None
        live = rng.random(64) < 0.8
        now += 0.4
        if i == 6:
            jsh.update_policy(5, 3.0)
            tsh.update_policy(5, 3.0)
        jo, jt = jsh.observe(h, ns, now, live)
        to, tt = tsh.observe(h, ns, now, live)
        np.testing.assert_array_equal(jo, to)
        np.testing.assert_array_equal(jt, tt)
    assert jsh.tally.as_dict() == tsh.tally.as_dict()
    assert tsh.tally.oracle_denies > 0
    jsh.close()
    tsh.close()


def test_wilson_and_tally_arithmetic():
    """``wilson_interval`` and the tally's rates, as the JAX copy's."""
    for k, n in ((0, 0), (0, 10), (3, 10), (10, 10), (7, 123456)):
        assert tcmp.wilson_interval(k, n) == jcmp.wilson_interval(k, n)
    a, b = jcmp.ThreeWayTally(), tcmp.ThreeWayTally()
    rng = np.random.default_rng(2)
    for _ in range(3):
        live, twin, orc = (rng.random(32) < 0.7 for _ in range(3))
        a.add(live, twin, orc)
        b.add(live, twin, orc)
    assert a.as_dict() == b.as_dict()


def test_evaluate_accuracy_matches_jax():
    """``evaluate_accuracy`` at a small size (2,000 keys, 12,288 requests
    in batches of 1,024 across several sub-windows): its report, field by
    field."""
    kw = dict(n_keys=2000, n_requests=12_288, batch=1024, limit=12,
              window=2.0, request_rate=4000.0, seed=3)
    want = jacc.evaluate_accuracy(**kw, sketch=R.SketchParams(
        depth=2, width=256, sub_windows=4, kernels="jnp"))
    got = tacc.evaluate_accuracy(**kw, sketch=T.SketchParams(
        depth=2, width=256, sub_windows=4), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.as_dict() == want.as_dict()
    assert got.false_denies_vs_oracle > 0
    np.testing.assert_array_equal(tacc.zipf_key_ids(500, 4000, 1.1, 5),
                                  jacc.zipf_key_ids(500, 4000, 1.1, 5))


# -------------------------------------------------------------- scenarios


def _scenario_limiter(M, spec: dict):
    cfg = M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=100_000,
                   window=60.0,
                   sketch=M.SketchParams(depth=3, width=1 << 12,
                                         sub_windows=4,
                                         **({"kernels": "jnp"} if M is R
                                            else {})),
                   hierarchy=M.HierarchySpec(**spec))
    clock = M.ManualClock(1_700_000_000.0)
    kw = {"backend": "sketch"} if M is R else {"device": "cpu"}
    return M.create_limiter(cfg, clock=clock, **kw), clock


def test_scenarios_copy_matches_jax():
    """The port's copy of the abuse scenarios on the port's limiters
    against the JAX copy on the JAX limiters: the rotating-key attacker
    and the thundering herd, result dicts equal."""
    out = []
    for M, sc in ((R, jsc), (T, tsc)):
        lim, clock = _scenario_limiter(M, {"tenants": 8,
                                           "global_limit": 10_000,
                                           "default_tenant_limit": 200})
        lim.set_tenant("legit", 10_000, weight=4)
        for i in range(16):
            lim.assign_tenant(f"legit{i}", "legit")
        rot = sc.run_rotating_key(lim, clock, batch=128, frames=4).as_dict()
        lim.close()
        weights = {"small": 1, "mid": 2, "big": 5}
        lim, clock = _scenario_limiter(M, {"tenants": 8,
                                           "global_limit": 96})
        for name, w in weights.items():
            lim.set_tenant(name, 10_000, weight=w)
            for i in range(16):
                lim.assign_tenant(f"{name}_k{i}", name)
        herd = sc.run_thundering_herd(lim, clock, tenants=weights,
                                      keys_per_tenant=16,
                                      bursts_per_key=4).as_dict()
        lim.close()
        out.append((rot, herd))
    assert out[0] == out[1]
    assert tsc.SCENARIOS == jsc.SCENARIOS
