"""The port's dense backend (on the CPU) against the JAX package's.

Inputs are made with NumPy from a seed and fed to both packages; every
output and every state array must be BIT-identical (tolerance 0). The JAX
dense step is jitted ``jnp`` (no Pallas kernel); the port's CPU path is
the kernel's plain version (``dense_cuda.dense_step`` on CPU tensors).
Covered: the three steps with and without a policy table (window-scaled
override rows included), negative ``free_scaled`` after a limit decrease,
the padding row and the whole state; ``_scale_to_micro``'s floor
semantics; the dense scan; ``DenseLimiter`` end to end (overrides,
resets, live updates, capacity exhaustion, recycling, fault injection,
fail-open); snapshots across packages both ways; the config fingerprint
of a non-default ``DenseParams``; the factory; and the server binary's
``--backend`` refusals.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu import checkpoint as jck
from ratelimiter_tpu.ops import dense_kernels as jdk
from ratelimiter_tpu_torch import checkpoint as tck
from ratelimiter_tpu_torch.algorithms.dense import DenseLimiter
from ratelimiter_tpu_torch.ops import dense_cuda
from ratelimiter_tpu_torch.ops import dense_kernels as tdk
from ratelimiter_tpu_torch.ops.sketch_cuda import ADMIT_CAPACITY

T0 = 1_700_000_000.0
T0_US = 1_700_000_000_000_000
ALGOS = ("FIXED_WINDOW", "SLIDING_WINDOW", "TOKEN_BUCKET")
FIELDS = ("allowed", "remaining", "retry_after", "reset_at", "limit",
          "fail_open")
CAP = 24
B = 32


def _cfg(M, algo, limit=7, window=3.0, iters=2, capacity=CAP, **kw):
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=limit,
                    window=window, max_batch_admission_iters=iters,
                    dense=M.DenseParams(capacity=capacity), **kw)


def _same(a, b, msg=""):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, (msg, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")
    if a.limits is None:
        assert b.limits is None, msg
    else:
        np.testing.assert_array_equal(a.limits, b.limits, err_msg=msg)


def _fields(r) -> tuple:
    """A scalar Result's fields (the packages' Result classes differ)."""
    return tuple((f, getattr(r, f)) for f in FIELDS)


def _same_state(js, ts, msg=""):
    assert set(js) == set(ts), msg
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                      err_msg=f"{msg} {k}")


# ------------------------------------------------------------------ steps


def _policy_rows(rng, algo, limit, W, n_rows, P, slot_keys):
    """A sorted override table of P rows (n_rows real) over the slots'
    search keys, each row gated as the table gates it."""
    keys = np.sort(rng.choice(slot_keys, size=n_rows, replace=False))
    cols = {"key": np.full(P, jdk.policy_kernels.PAD_KEY, np.int64)}
    for name in ("limit", "window_us", "rate_num", "rate_den"):
        cols[name] = np.zeros(P, np.int64)
    num0, den0 = jdk.check_gate_values(limit, W)
    cols["limit"][:], cols["window_us"][:] = limit, W
    cols["rate_num"][:], cols["rate_den"][:] = num0, den0
    for i, k in enumerate(keys):
        lim = int(rng.integers(1, 12))
        w = int(W * rng.choice([0.5, 1.0, 2.0, 0.37]))
        num, den = jdk.check_gate_values(lim, w)
        cols["key"][i], cols["limit"][i], cols["window_us"][i] = k, lim, w
        cols["rate_num"][i], cols["rate_den"][i] = num, den
    return cols


@pytest.mark.parametrize("policy", [False, True], ids=["default", "policy"])
@pytest.mark.parametrize("algo", ALGOS)
def test_step_matches_jax(algo, policy):
    """Each step, with and without the override table, over a seeded
    trace: contention on few slots, mixed n, padding into row C, time
    jumps across windows and back within one, and a limit decrease
    mid-trace (``free_scaled`` and the available units go negative).
    Every output and the whole state, row C included, each step. On the
    CPU the step is ``plain_step``: the plain phase A, then the plain
    admission and epilogue over its scratch, where the kernels split it."""
    _trace_matches_jax(algo, policy, tdk.build_step)


@pytest.mark.parametrize("algo", ALGOS)
def test_front_plain_writes_only_its_rows(algo):
    """Phase A reads the state and writes the scratch rows its algorithm
    uses (the others stay 0): the state is unchanged after it."""
    rng = np.random.default_rng(4)
    cfg = _cfg(T, algo)
    ts = tdk.init_state(cfg.algorithm, CAP, 7)
    ones = torch.ones(B, dtype=torch.int64)
    tdk.build_step(cfg)(ts, torch.from_numpy(
        rng.integers(0, CAP, B).astype(np.int32)), ones, T0_US)
    before = {k: v.clone() for k, v in ts.items()}
    sid = torch.from_numpy(rng.integers(0, CAP + 1, B).astype(np.int32))
    x = tdk.dense_front_plain(ts, sid, ones, T0_US + 1_500_000,
                              **tdk.step_params(cfg))
    assert x.shape == (len(tdk.SCRATCH_ROWS), B) and x.dtype == torch.int64
    unused = sorted(set(range(len(tdk.SCRATCH_ROWS)))
                    - set(tdk.USED_ROWS[cfg.algorithm]))
    assert not x[unused].any()
    assert x[list(tdk.USED_ROWS[cfg.algorithm])].any()
    for k in ts:
        assert torch.equal(ts[k], before[k]), k


def _trace_matches_jax(algo, policy, port_step):
    rng = np.random.default_rng(11 + ALGOS.index(algo) + 7 * policy)
    limit, W = 7, 3_000_000
    slot_keys = rng.integers(-2 ** 63, 2 ** 63 - 1, size=CAP + 1,
                             dtype=np.int64)
    slot_keys[CAP] = 0                      # padding rows search key 0
    cols = (_policy_rows(rng, algo, limit, W, 6, 16, slot_keys[:CAP])
            if policy else None)
    js = jdk.init_state(getattr(R.Algorithm, algo), CAP, limit)
    ts = tdk.init_state(getattr(T.Algorithm, algo), CAP, limit)
    now = T0_US
    for it in range(24):
        lim = limit if it < 14 else 3      # the limit decrease
        jstep = jdk.build_step(_cfg(R, algo, limit=lim))
        tstep = port_step(_cfg(T, algo, limit=lim))
        sid = rng.integers(0, 6 if it % 3 else CAP, B).astype(np.int32)
        n = rng.integers(1, 4, B).astype(np.int64)
        pad = rng.random(B) < 0.2
        sid[pad], n[pad] = CAP, 0
        now += int(rng.choice([0, 150_000, 1_000_000, 2_900_000,
                               7_000_000]))
        keyq = slot_keys[sid]
        if cols is None:
            jout = jstep(js, jnp.asarray(sid), jnp.asarray(n),
                         jnp.int64(now))
            tout = tstep(ts, torch.from_numpy(sid), torch.from_numpy(n), now)
        else:
            jout = jstep(js, jnp.asarray(sid), jnp.asarray(n),
                         jnp.int64(now),
                         {k: jnp.asarray(v) for k, v in cols.items()},
                         jnp.asarray(keyq))
            tout = tstep(ts, torch.from_numpy(sid), torch.from_numpy(n), now,
                         {k: torch.from_numpy(v) for k, v in cols.items()},
                         torch.from_numpy(keyq))
        js, jres = jout
        for name, x, y in zip(("allowed", "remaining", "retry", "reset"),
                              jres, tout):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f"{it} {name}")
        _same_state(js, ts, str(it))


def test_negative_free_scaled_floors():
    """After a limit decrease the sliding window's ``free_scaled`` is
    negative: ``_scale_to_micro`` floors (``//`` and ``%`` as jnp's), the
    available units are negative, every request is denied and
    ``remaining`` floors below zero before the limiter's clamp."""
    W = 3_000_000
    x = np.array([-1, -W, -W - 1, -7 * W + 5, 0, W - 1, 5 * W + 3,
                  -(2 ** 60) + 17], np.int64)
    got = tdk._scale_to_micro(torch.from_numpy(x), W).numpy()
    want = np.asarray(jdk._scale_to_micro(jnp.asarray(x), W))
    np.testing.assert_array_equal(got, want)
    assert got[0] == -1 and got[2] < -1_000_000
    js = jdk.init_state(R.Algorithm.SLIDING_WINDOW, 4, 9)
    ts = tdk.init_state(T.Algorithm.SLIDING_WINDOW, 4, 9)
    sid = np.array([0, 0, 0, 1, 4, 4, 4, 4], np.int32)
    n = np.array([3, 3, 3, 1, 0, 0, 0, 0], np.int64)
    for lim, t in ((9, T0_US + 100), (2, T0_US + 1_700_000),
                   (2, T0_US + 3_100_000)):
        js, jres = jdk.build_step(_cfg(R, "SLIDING_WINDOW", limit=lim))(
            js, jnp.asarray(sid), jnp.asarray(n), jnp.int64(t))
        tres = tdk.build_step(_cfg(T, "SLIDING_WINDOW", limit=lim))(
            ts, torch.from_numpy(sid), torch.from_numpy(n), t)
        for x, y in zip(jres, tres):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        _same_state(js, ts)
    assert (tres[1][:3] < 0).all() and not tres[0][:3].any()


@pytest.mark.parametrize("algo", ALGOS)
def test_dense_scan_matches_jax(algo):
    """``build_scan``: T steps without a host sync, packed masks, deny
    counts and the final state as the JAX scan's."""
    rng = np.random.default_rng(5)
    Tn = 5
    sids = rng.integers(0, 8, size=(Tn, B)).astype(np.int32)
    ns = rng.integers(1, 3, size=(Tn, B)).astype(np.int64)
    js = jdk.init_state(getattr(R.Algorithm, algo), CAP, 7)
    ts = tdk.init_state(getattr(T.Algorithm, algo), CAP, 7)
    js, jp, jd = jdk.build_scan(_cfg(R, algo))(
        js, jnp.asarray(sids), jnp.asarray(ns), jnp.int64(T0_US),
        jnp.int64(700_000))
    ts, tp, td = tdk.build_scan(_cfg(T, algo))(
        ts, torch.from_numpy(sids), torch.from_numpy(ns), T0_US, 700_000)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    _same_state(js, ts)


def test_step_checks_operands():
    """The wrapper refuses wrong types and shapes before anything runs,
    and a policy table without search keys."""
    cfg = _cfg(T, "FIXED_WINDOW")
    step = tdk.build_step(cfg)
    st = tdk.init_state(cfg.algorithm, 4, 7)
    with pytest.raises(TypeError):
        step(st, torch.zeros(8, dtype=torch.int64),
             torch.zeros(8, dtype=torch.int64), T0_US)
    with pytest.raises(ValueError):
        step({"count": st["count"]}, torch.zeros(8, dtype=torch.int32),
             torch.zeros(8, dtype=torch.int64), T0_US)
    pol = {k: torch.zeros(4, dtype=torch.int64)
           for k in ("key", "limit", "window_us", "rate_num", "rate_den")}
    with pytest.raises(ValueError, match="keyq"):
        step(st, torch.zeros(8, dtype=torch.int32),
             torch.zeros(8, dtype=torch.int64), T0_US, pol)
    assert dense_cuda.launch_counts()["dense_step"] == 0


# ---------------------------------------------------------------- limiter


def _pair(algo, **kw):
    cj, ct = _cfg(R, algo, **kw), _cfg(T, algo, **kw)
    return (R.create_limiter(cj, "dense", clock=R.ManualClock(T0)),
            T.create_limiter(ct, "dense", clock=T.ManualClock(T0),
                             device="cpu"))


@pytest.mark.parametrize("algo", ALGOS)
def test_limiter_matches_jax(algo):
    """Seeded string-key traffic through both packages' DenseLimiter:
    overrides (one window-scaled), a reset, ``update_limit`` down and up,
    ``update_window`` (after the scaled override goes), prune; every
    result, the key count and the captured state."""
    rng = np.random.default_rng(21 + ALGOS.index(algo))
    lj, lt = _pair(algo, capacity=64)
    now = T0
    for it in range(36):
        if it == 4:
            for lim in (lj, lt):
                lim.set_override("k1", 11)
                lim.set_override("k2", 2, window_scale=2.0)
        if it == 9:
            lj.reset("k3")
            lt.reset("k3")
        if it == 12:
            lj.update_limit(4)
            lt.update_limit(4)
        if it == 18:
            for lim in (lj, lt):
                lim.delete_override("k2")
                lim.clock.set(now)
                lim.update_window(5.0)
        if it == 24:
            lj.update_limit(9)
            lt.update_limit(9)
        if it == 30:
            assert lj.prune(now + 20) == lt.prune(now + 20)
        keys = [f"k{i}" for i in rng.integers(0, 30, 40)]
        ns = rng.integers(1, 3, 40)
        now += float(rng.choice([0.05, 0.4, 1.3, 3.1]))
        _same(lj.allow_batch(keys, ns, now=now),
              lt.allow_batch(keys, ns, now=now), str(it))
        rj = lj.allow_n("k1", 2, now=now)
        rt = lt.allow_n("k1", 2, now=now)
        assert _fields(rj) == _fields(rt), it
    assert lj.key_count() == lt.key_count()
    kj, aj, ej = lj.capture_state()
    kt, at, et = lt.capture_state()
    assert (kj, ej["capacity"]) == (kt, et["capacity"]) == ("dense", 64)
    assert set(aj) == set(at)
    for k in aj:
        assert np.asarray(aj[k]).dtype == np.asarray(at[k]).dtype, k
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)


def test_capacity_exhaustion_and_recycling():
    """A full store raises StorageUnavailableError in both packages (after
    an attempted prune); keys idle two windows are recycled, their slots
    zeroed, with the same decisions after."""
    for algo in ALGOS:
        lj, lt = _pair(algo, capacity=4, limit=3, window=1.0)
        for lim in (lj, lt):
            lim.allow_batch(["a", "b", "c", "d"], now=T0)
            with pytest.raises(R.StorageUnavailableError
                               if lim is lj else T.StorageUnavailableError,
                               match="dense store full"):
                lim.allow_batch(["e"], now=T0 + 0.5)
        # Two windows later every slot is idle: "e" recycles one.
        _same(lj.allow_batch(["e", "a", "e"], [2, 1, 2], now=T0 + 2.5),
              lt.allow_batch(["e", "a", "e"], [2, 1, 2], now=T0 + 2.5), algo)
        assert lj.key_count() == lt.key_count() == 2
        _same(lj.allow_batch(["b", "e"], now=T0 + 2.6),
              lt.allow_batch(["b", "e"], now=T0 + 2.6), algo)


@pytest.mark.parametrize("fail_open", [False, True])
def test_fault_injection_and_fail_open(fail_open):
    """An injected failure answers fail-open (allowed, flagged) or raises
    StorageUnavailableError, as the JAX limiter; heal() restores, and a
    full store fails open too."""
    lj, lt = _pair("SLIDING_WINDOW", capacity=2, fail_open=fail_open)
    for lim in (lj, lt):
        lim.inject_failure()
    if fail_open:
        _same(lj.allow_batch(["a", "b"], now=T0),
              lt.allow_batch(["a", "b"], now=T0))
        assert lt.allow("a", now=T0).fail_open
    else:
        for lim, err in ((lj, R.StorageUnavailableError),
                         (lt, T.StorageUnavailableError)):
            with pytest.raises(err, match="injected"):
                lim.allow_batch(["a"], now=T0)
    for lim in (lj, lt):
        lim.heal()
    _same(lj.allow_batch(["a", "b", "a"], now=T0 + 1),
          lt.allow_batch(["a", "b", "a"], now=T0 + 1))
    if fail_open:
        _same(lj.allow_batch(["x", "y", "z"], now=T0 + 1.1),
              lt.allow_batch(["x", "y", "z"], now=T0 + 1.1))


def test_batch_above_capacity_refused_on_the_card_only():
    """A batch of ADMIT_CAPACITY + 1 requests is decided, as the JAX
    package decides it: on the CPU by the plain step, and on the card by
    the same plain step composed of torch ops (no longer refused;
    tests/test_torch_cuda.py pins the card). Repeated keys contend, so
    some are denied."""
    keys = [f"k{i % 5000}" for i in range(ADMIT_CAPACITY + 1)]
    for algo in ALGOS:
        cfg = {M: _cfg(M, algo, capacity=ADMIT_CAPACITY + 8, limit=1)
               for M in (R, T)}
        lj = R.create_limiter(cfg[R], "dense", clock=R.ManualClock(T0))
        lt = T.create_limiter(cfg[T], "dense", clock=T.ManualClock(T0),
                              device="cpu")
        got = lt.allow_batch(keys, now=T0)
        _same(lj.allow_batch(keys, now=T0), got, algo)
        assert 0 < got.allowed.sum() < len(keys)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("algo", ALGOS)
def test_snapshot_crosses_packages_both_ways(algo, tmp_path):
    """A dense snapshot saved by either package restores in the other
    (state, slot map, last use, overrides), and both then decide alike."""
    rng = np.random.default_rng(3)
    lj, lt = _pair(algo, capacity=32)
    for lim in (lj, lt):
        lim.set_override("k0", 9)
    for _ in range(5):
        keys = [f"k{i}" for i in rng.integers(0, 12, 24)]
        _same(lj.allow_batch(keys, now=T0 + 0.3),
              lt.allow_batch(keys, now=T0 + 0.3))
    lj.save(str(tmp_path / "j.npz"))
    lt.save(str(tmp_path / "t.npz"))
    rj, rt = _pair(algo, capacity=32)
    rj.restore(str(tmp_path / "t.npz"))
    rt.restore(str(tmp_path / "j.npz"))
    assert rt.get_override("k0") is not None
    for _ in range(4):
        keys = [f"k{i}" for i in rng.integers(0, 14, 24)]
        want = lj.allow_batch(keys, now=T0 + 0.9)
        lt.allow_batch(keys, now=T0 + 0.9)
        _same(want, rj.allow_batch(keys, now=T0 + 0.9))
        _same(want, rt.allow_batch(keys, now=T0 + 0.9))
    other = T.create_limiter(_cfg(T, algo, capacity=16), "dense",
                             device="cpu")
    with pytest.raises(T.CheckpointError):
        other.restore(str(tmp_path / "j.npz"))


def test_fingerprint_reads_the_dense_spec():
    """``config_fingerprint`` digests the config's own dense spec: the
    default config keeps the JAX golden value, a non-default capacity has
    the JAX digest (pinned)."""
    base = dict(algorithm=T.Algorithm.SLIDING_WINDOW, limit=10, window=6.0)
    assert (tck.config_fingerprint(T.Config(**base))
            == "989557b792166cf22f182d4779de5dce")
    ct = T.Config(**base, dense=T.DenseParams(capacity=4096))
    cj = R.Config(algorithm=R.Algorithm.SLIDING_WINDOW, limit=10,
                  window=6.0, dense=R.DenseParams(capacity=4096))
    assert tck.config_fingerprint(ct) == jck.config_fingerprint(cj) \
        == "2c1d5f11948cf73c4c6040e7a5dbe8b8"
    with pytest.raises(T.InvalidConfigError):
        T.Config(**base, dense=T.DenseParams(capacity=0)).validate()


# ------------------------------------------------------------ the factory


def test_factory_backends():
    """exact and dense are served; mesh is refused naming A8; the default
    stays the sketch on the card."""
    cfg = _cfg(T, "SLIDING_WINDOW")
    assert T.algorithms.factory.BACKENDS == ("exact", "dense", "sketch")
    assert isinstance(T.create_limiter(cfg, "dense", device="cpu"),
                      DenseLimiter)
    from ratelimiter_tpu_torch.algorithms.exact import ExactLimiter

    assert isinstance(T.create_limiter(cfg, "exact"), ExactLimiter)
    with pytest.raises(T.InvalidConfigError, match="A8"):
        T.create_limiter(cfg, "mesh")
    import inspect

    sig = inspect.signature(T.create_limiter)
    assert sig.parameters["backend"].default == "sketch"
    assert sig.parameters["device"].default == "cuda"


@pytest.mark.parametrize("argv,msg", [
    (["--backend", "dense", "--tenants", "4"], "sketch-family"),
    (["--backend", "exact", "--tenants", "4"], "sketch-family"),
    (["--backend", "dense", "--max-batch", "8193"], "8192"),
])
def test_binary_refusals(argv, msg):
    """The binary's --backend refusals: the hierarchy needs a sketch
    backend (the JAX binary's), and a dense door's flush size fits one
    launch on the card."""
    from ratelimiter_tpu_torch.serving import __main__ as srv

    with pytest.raises(SystemExit, match=msg):
        srv.build_config(srv.parse_args(argv))
    args = srv.parse_args(["--backend", "dense", "--max-batch", "8192",
                           "--dense-capacity", "128"])
    assert srv.build_config(args).dense.capacity == 128


# ------------------------------------------------------- durable serving


def _durable(M, d, backend, clock, algo="SLIDING_WINDOW", **kw):
    """(manager, wrapped limiter of ``backend``) recovered from d."""
    from ratelimiter_tpu.persistence import PersistenceManager as JaxManager
    from ratelimiter_tpu_torch.persistence import PersistenceManager

    cfg = _cfg(M, algo, capacity=64, persistence=M.PersistenceSpec(
        dir=str(d), snapshot_interval=1000.0), **kw)
    mgr = (JaxManager if M is R else PersistenceManager)(
        cfg.persistence, registry=M.observability.metrics.Registry())
    dev = {} if M is R or backend == "exact" else {"device": "cpu"}
    lim = mgr.wrap(M.create_limiter(cfg, backend, clock=clock, **dev))
    mgr.attach([lim])
    mgr.recover()
    return mgr, lim


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
@pytest.mark.parametrize("backend", ["dense", "exact"])
def test_durable_directory_recovers_in_both_packages(tmp_path, backend,
                                                     algo):
    """The binary's ``--snapshot-dir`` path for the dense and exact kinds:
    a seeded run (traffic, an override, a reset, a snapshot, then
    mutations only the WAL carries) written by each package, killed
    without a final snapshot, recovers in both packages to the same
    state, overrides, config and later decisions."""
    import shutil

    rng = np.random.default_rng(13)
    batches = [[f"k{i}" for i in rng.integers(0, 20, 16)] for _ in range(6)]
    for M in (R, T):
        clock = M.ManualClock(T0)
        mgr, lim = _durable(M, tmp_path / M.__name__, backend, clock, algo)
        for keys in batches[:3]:
            lim.allow_batch(keys)
            clock.advance(0.9)
        lim.set_override("k1", 3)
        lim.reset("k2")
        mgr.snapshot_now()
        lim.allow_batch(batches[3])        # lost with the crash
        clock.advance(1.3)
        lim.reset("k3")
        lim.set_override("k4", 9)
        lim.update_limit(5)
        lim.update_window(4.5)
        mgr.wal.close()                    # kill -9: no final snapshot
        lim.close()
    later = T0 + 3 * 0.9 + 1.3 + 2.0
    for name in (R.__name__, T.__name__):
        outs = []
        for M in (R, T):
            copy = tmp_path / f"{name}-{M.__name__}"
            shutil.copytree(tmp_path / name, copy)
            mgr, lim = _durable(M, copy, backend, M.ManualClock(later), algo)
            assert mgr.report.snapshot_id == 1 and mgr.report.replayed == 4
            assert (lim.config.limit, lim.config.window) == (5, 4.5)
            assert lim.get_override("k4").limit == 9
            outs.append([lim.allow_batch(k) for k in batches[4:]])
            outs.append(lim.capture_state()[1])
            mgr.stop(final_snapshot=False)
            lim.close()
        for a, b in zip(outs[0], outs[2]):
            _same(a, b, name)
        for k in outs[1]:
            np.testing.assert_array_equal(outs[1][k], outs[3][k],
                                          err_msg=f"{name} {k}")
