"""The fleet's serving half in the port (``ratelimiter_tpu_torch/fleet/``,
``placement/accounting.py``), held to the JAX package on the CPU.

Every piece is compared with no tolerance: the ownership map (round
trip, owner table, partition, reassign, ``move_ranges`` with sub-range
splits, ``affine_map``), ``splitmix64_inv``, the fleet frames' bytes
(the forward hint, the map pair, the typed redirect, the signed
announce), ``scatter_merge`` and ``collect_jobs`` on seeded legs
(failed legs under fail-open and fail-closed), the placement load slab
under a manual clock and ``merge_placement``, ``build_standby`` from a
snapshot directory and WAL the port wrote, and the in-process fleet
oracle: host A is the port's ``FleetForwarder`` over a port limiter,
host B a port asyncio server on a thread, one manual clock drives both,
and every answer and both hosts' state equal JAX ``SketchLimiter``s
(``kernels="jnp"``) replaying each owner's rows in frame order, for the
window and the token bucket; redirect-only mode answers the typed
E_NOT_OWNER.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.core.clock import ManualClock as JClock
from ratelimiter_tpu.fleet import config as jfc
from ratelimiter_tpu.fleet import forwarder as jfw
from ratelimiter_tpu.observability.metrics import Registry as JRegistry
from ratelimiter_tpu.ops.hashing import splitmix64_inv as j_inv
from ratelimiter_tpu.placement import accounting as jacc
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu_torch.core.clock import ManualClock
from ratelimiter_tpu_torch.core.errors import NotOwnerError
from ratelimiter_tpu_torch.fleet import config as tfc
from ratelimiter_tpu_torch.fleet import forwarder as tfw
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.ops.hashing import splitmix64, splitmix64_inv
from ratelimiter_tpu_torch.placement import accounting as tacc
from ratelimiter_tpu_torch.serving import protocol as p

T0 = 1_000.0


def _map_dict(port_a=1, port_b=2, buckets=32):
    return {"buckets": buckets, "epoch": 1, "hosts": [
        {"id": "a", "host": "127.0.0.1", "port": port_a,
         "ranges": [[0, buckets // 2]], "successor": "b"},
        {"id": "b", "host": "127.0.0.1", "port": port_b,
         "ranges": [[buckets // 2, buckets]], "successor": "a"}]}


def _seeded_map(rng, n_hosts, buckets):
    """A valid map: ``buckets`` split into 2..3 ranges a host, shuffled."""
    cuts = np.sort(rng.choice(np.arange(1, buckets), size=3 * n_hosts - 1,
                              replace=False))
    edges = [0, *cuts.tolist(), buckets]
    spans = list(zip(edges[:-1], edges[1:]))
    owner = rng.permutation(np.arange(len(spans)) % n_hosts)
    hosts = []
    for h in range(n_hosts):
        ranges = [list(spans[i]) for i in range(len(spans)) if owner[i] == h]
        hosts.append({"id": f"h{h}", "host": "10.0.0.1", "port": 9000 + h,
                      "ranges": ranges,
                      "successor": f"h{(h + 1) % n_hosts}",
                      "shards": int(rng.integers(1, 3)),
                      "snapshot_dir": f"/var/lib/rl/h{h}"})
    return {"buckets": buckets, "epoch": int(rng.integers(1, 9)),
            "hosts": hosts}


# ------------------------------------------------------------ the map


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fleet_map_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 2 + seed % 3
    d = _seeded_map(rng, n, 64 + 16 * seed)
    tm, jm = tfc.FleetMap.from_dict(d), jfc.FleetMap.from_dict(d)
    assert tm.to_dict() == jm.to_dict()
    assert tfc.FleetMap.from_dict(tm.to_dict()).to_dict() == tm.to_dict()
    np.testing.assert_array_equal(tm.owner_table, jm.owner_table)
    assert tm.canonical_key() == jm.canonical_key()
    h = rng.integers(0, 1 << 63, size=500, dtype=np.int64).astype(np.uint64)
    np.testing.assert_array_equal(tm.owner_of_hash(h), jm.owner_of_hash(h))
    np.testing.assert_array_equal(tm.bucket_of_hash(h), jm.bucket_of_hash(h))
    owners = tm.owner_of_hash(h)
    tp, jpart = tm.partition(owners), jm.partition(owners)
    assert tp.keys() == jpart.keys()
    for k in tp:
        np.testing.assert_array_equal(tp[k], jpart[k])
    for hid in (x["id"] for x in d["hosts"]):
        assert tm.owned_buckets(hid) == jm.owned_buckets(hid)
    # reassign and move_ranges (whole and sub-range splits).
    assert (tm.reassign("h0", "h1").to_dict()
            == jm.reassign("h0", "h1").to_dict())
    lo, hi = d["hosts"][0]["ranges"][0]
    mid = (lo + hi) // 2
    for moves in ([(lo, hi)], [(lo, mid)], [(mid, hi)]
                  if mid < hi else [(lo, hi)]):
        if moves[0][0] >= moves[0][1]:
            continue
        a = tm.move_ranges(moves, "h0", "h1").to_dict()
        b = jm.move_ranges(moves, "h0", "h1").to_dict()
        assert a == b
    other = int(np.nonzero(tm.owner_table != 0)[0][0])
    with pytest.raises(T.InvalidConfigError) as te:
        tm.move_ranges([(other, other + 1)], "h0", "h1")
    with pytest.raises(R.InvalidConfigError) as je:
        jm.move_ranges([(other, other + 1)], "h0", "h1")
    assert str(te.value) == str(je.value)
    # affine maps, with and without dirs.
    addrs = [("127.0.0.1", 9000 + i) for i in range(n)]
    dirs = [f"/d/{i}" for i in range(n)]
    assert (tfc.affine_map(addrs).to_dict()
            == jfc.affine_map(addrs).to_dict())
    assert (tfc.affine_map(addrs, buckets=96, snapshot_dirs=dirs).to_dict()
            == jfc.affine_map(addrs, buckets=96,
                              snapshot_dirs=dirs).to_dict())


def test_fleet_map_refusals_equal_jax():
    bad = [
        {"buckets": 8, "hosts": [
            {"id": "a", "host": "h", "port": 1, "ranges": [[0, 4]]}]},
        {"buckets": 8, "hosts": [
            {"id": "a", "host": "h", "port": 1, "ranges": [[0, 6]]},
            {"id": "b", "host": "h", "port": 2, "ranges": [[4, 8]]}]},
        {"buckets": 8, "hosts": [
            {"id": "a", "host": "h", "port": 1, "ranges": [[0, 8]],
             "successor": "ghost"}]},
        {"buckets": 8, "hosts": [
            {"id": "a", "host": "h", "port": 1, "ranges": [[0, 8]],
             "successor": "a"}]},
    ]
    for d in bad:
        with pytest.raises(R.InvalidConfigError) as je:
            jfc.FleetMap.from_dict(d)
        with pytest.raises(T.InvalidConfigError) as te:
            tfc.FleetMap.from_dict(d)
        assert str(te.value) == str(je.value)


def test_splitmix64_inv_equals_jax():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 63, size=50_000, dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + rng.integers(0, 2, size=50_000).astype(
        np.uint64)
    edges = np.array([0, 1, (1 << 64) - 1, 1 << 63, 0x9E3779B97F4A7C15,
                      0xBF58476D1CE4E5B9], dtype=np.uint64)
    for v in (x, edges):
        got = splitmix64_inv(v)
        np.testing.assert_array_equal(got, j_inv(v))
        np.testing.assert_array_equal(splitmix64(got), v)


# ------------------------------------------------------------ the frames


def test_fleet_frame_bytes_equal_jax():
    frame = p.encode_allow_hashed(9, np.arange(5, dtype=np.uint64),
                                  np.ones(5, dtype=np.int64))
    assert frame == jp.encode_allow_hashed(9, np.arange(5, dtype=np.uint64),
                                           np.ones(5, dtype=np.int64))
    dl = p.with_deadline(frame, 0.25)
    assert p.with_forward(dl) == jp.with_forward(jp.with_deadline(frame, 0.25))
    assert (p.with_forward(p.encode_allow_batch(3, ["k", "é"], [1, 2]))
            == jp.with_forward(jp.encode_allow_batch(3, ["k", "é"], [1, 2])))
    for t in (0x1B, 0x05, 0x10, 0x91, 0x0B):
        assert p.split_forward(t) == jp.split_forward(t)
    with pytest.raises(p.ProtocolError):
        p.with_forward(p.with_forward(frame))
    d = _map_dict()
    assert p.encode_fleet_map(4) == jp.encode_fleet_map(4)
    assert p.encode_fleet_map_r(4, d) == jp.encode_fleet_map_r(4, d)
    assert p.parse_fleet_map_r(p.encode_fleet_map_r(4, d)[13:]) == d
    msg = p.format_not_owner(3, "b@10.0.0.2:9001", 7, 64)
    assert msg == jp.format_not_owner(3, "b@10.0.0.2:9001", 7, 64)
    for m in (msg, "storage unavailable", "not owner: garbage"):
        assert p.parse_not_owner(m) == jp.parse_not_owner(m)
    exc = p.exception_for(p.E_NOT_OWNER, msg)
    assert isinstance(exc, NotOwnerError)
    assert (exc.owner, exc.epoch) == ("b@10.0.0.2:9001", 7)
    assert p.code_for(exc) == p.E_NOT_OWNER == jp.E_NOT_OWNER
    payload = {"kind": "announce", "from": "a", "map": d,
               "mono_ns": 123456789}
    assert (p.encode_dcn_fleet(1, payload)
            == jp.encode_dcn_fleet(1, payload))
    signed = p.encode_dcn_fleet(2, payload, secret="s", sender=7,
                                seq=10_000_000_000_000_000)
    assert signed == jp.encode_dcn_fleet(2, payload, secret="s", sender=7,
                                         seq=10_000_000_000_000_000)
    assert p.T_FLEET_MAP == jp.T_FLEET_MAP
    assert p.T_FLEET_MAP_R == jp.T_FLEET_MAP_R
    assert p.FORWARD_FLAG == jp.FORWARD_FLAG


def test_announce_rides_the_authenticated_dcn_merge():
    from ratelimiter_tpu_torch.serving.dcn_peer import merge_push_payload

    payload = {"kind": "announce", "from": "a", "map": _map_dict()}
    body = p.encode_dcn_fleet(1, payload, secret="s", sender=7,
                              seq=10_000_000_000_000_000)[13:]
    got = []
    guard = p.DcnReplayGuard(time_fn=lambda: 1e10)
    merge_push_payload([], body, "s", guard, on_fleet=got.append)
    assert got == [payload]
    with pytest.raises(T.InvalidConfigError, match="replayed"):
        merge_push_payload([], body, "s", guard, on_fleet=got.append)
    with pytest.raises(T.InvalidConfigError, match="auth tag"):
        merge_push_payload([], body, "wrong", None, on_fleet=got.append)
    assert len(got) == 1


def test_result_batch_columnar_equals_jax():
    rng = np.random.default_rng(2)
    results = [T.Result(allowed=bool(a), limit=50, remaining=int(r),
                        retry_after=float(t), reset_at=float(s),
                        fail_open=bool(f))
               for a, r, t, s, f in zip(
                   rng.integers(0, 2, 40), rng.integers(0, 50, 40),
                   rng.random(40), rng.random(40) + 1e9,
                   rng.integers(0, 2, 40) * (rng.random(40) < 0.1))]
    body = p.encode_result_batch(1, 50, results)[13:]
    a = p.parse_result_batch_columnar(body)
    b = jp.parse_result_batch_columnar(body)
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.limit, a.fail_open) == (b.limit, b.fail_open)


# ------------------------------------------------- merge and collect


def _batch(M, rng, k, limit, with_limits=False):
    return M.core.types.BatchResult(
        allowed=rng.integers(0, 2, k).astype(bool), limit=limit,
        remaining=rng.integers(0, limit, k).astype(np.int64),
        retry_after=rng.random(k), reset_at=rng.random(k) + 1e9,
        fail_open=bool(rng.random() < 0.3),
        limits=(rng.integers(1, 99, k).astype(np.int64)
                if with_limits else None))


def _legs(M, seed, b=60, limit=40):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(b)
    cuts = np.sort(rng.choice(np.arange(1, b), size=3, replace=False))
    groups = np.split(perm, cuts)
    legs = []
    for i, pos in enumerate(groups):
        if i == 1:
            legs.append((pos, [M.core.types.Result(
                allowed=bool(rng.integers(0, 2)), limit=int(
                    rng.choice([limit, 77])),
                remaining=int(rng.integers(0, 9)),
                retry_after=float(rng.random()),
                reset_at=float(rng.random() + 1e9),
                fail_open=bool(rng.random() < 0.2))
                for _ in range(pos.shape[0])]))
        else:
            legs.append((pos, _batch(M, rng, pos.shape[0], limit,
                                     with_limits=(i == 2))))
    return legs


def _same_batch(a, b):
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.limit, bool(a.fail_open)) == (b.limit, bool(b.fail_open))
    if a.limits is None or b.limits is None:
        assert a.limits is None and b.limits is None
    else:
        np.testing.assert_array_equal(a.limits, b.limits)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_merge_equals_jax(seed):
    t = tfw.scatter_merge(60, 40, _legs(T, seed))
    j = jfw.scatter_merge(60, 40, _legs(R, seed))
    _same_batch(t, j)
    whole = tfw.scatter_merge(5, 40, [(None, _batch(
        T, np.random.default_rng(seed), 5, 40))])
    jwhole = jfw.scatter_merge(5, 40, [(None, _batch(
        R, np.random.default_rng(seed), 5, 40))])
    _same_batch(whole, jwhole)


def _jobs(M, seed, fail):
    rng = np.random.default_rng(seed)
    legs = _legs(M, seed)
    jobs = []
    for i, (pos, out) in enumerate(legs):
        fut = concurrent.futures.Future()
        if i in fail:
            fut.set_exception(M.StorageUnavailableError(f"leg {i} down"))
        elif isinstance(out, list):
            fut.set_result(M.core.types.BatchResult(
                allowed=np.array([r.allowed for r in out]), limit=40,
                remaining=np.array([r.remaining for r in out]),
                retry_after=np.array([r.retry_after for r in out]),
                reset_at=np.array([r.reset_at for r in out])))
        else:
            fut.set_result(out)
        jobs.append((pos, fut, None if i == 0 else int(rng.integers(0, 2))))
    return jobs


@pytest.mark.parametrize("fail_open", [True, False])
@pytest.mark.parametrize("fail", [(), (2,), (1, 3)])
def test_collect_jobs_equals_jax(fail_open, fail):
    d = _map_dict()
    cores = (tfw.FleetCore(tfc.FleetMap.from_dict(d), "a",
                           registry=Registry()),
             jfw.FleetCore(jfc.FleetMap.from_dict(d), "a",
                           registry=JRegistry()))
    out = []
    for M, core in zip((T, R), cores):
        cfg = M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=40,
                       window=30.0, fail_open=fail_open)
        parts, err = (tfw if M is T else jfw).collect_jobs(
            core, _jobs(M, 5, fail), cfg, T0)
        out.append((parts, err))
        core.close()
    (tparts, terr), (jparts, jerr) = out
    assert (terr is None) == (jerr is None)
    if terr is not None:
        assert type(terr).__name__ == type(jerr).__name__
        # Legs harvest as they finish (a set's order in both packages):
        # the first error kept is one of the failed legs'.
        assert {str(terr), str(jerr)} <= {
            f"fleet forward failed (leg {i} down); rows fail closed per "
            f"config" for i in fail}
    assert len(tparts) == len(jparts)
    key = lambda pr: int(pr[0][0])  # noqa: E731
    for (tp_, to), (jp_, jo) in zip(sorted(tparts, key=key),
                                    sorted(jparts, key=key)):
        np.testing.assert_array_equal(tp_, jp_)
        _same_batch(to, jo)
    if not fail_open or not fail:
        return
    merged = tfw.scatter_merge(60, 40, tparts)
    assert merged.fail_open
    _same_batch(merged, jfw.scatter_merge(60, 40, jparts))


# ------------------------------------------------------ load accounting


def test_load_slab_and_merge_equal_jax():
    rng = np.random.default_rng(9)
    now = [100.0]
    slabs = [tacc.LoadSlab(16, ewma_halflife_s=2.0, min_drain_s=0.1,
                           registry=Registry(), clock=lambda: now[0]),
             jacc.LoadSlab(16, ewma_halflife_s=2.0, min_drain_s=0.1,
                           registry=JRegistry(), clock=lambda: now[0])]
    for step in range(6):
        b = rng.integers(0, 16, size=200)
        local = rng.random(200) < (0.2 * step)
        one = int(rng.integers(0, 16))
        for s in slabs:
            s.note(b, local)
            s.note_one(one, step % 2 == 0)
        now[0] += 0.05 + 0.3 * step
        snaps = [s.snapshot() for s in slabs]
        assert snaps[0] == snaps[1]
        np.testing.assert_array_equal(slabs[0].rates(), slabs[1].rates())
    members = {"a": snaps[0], "b": None,
               "c": {**snaps[0], "decide_rate": [1.0] * 16}}
    assert tacc.merge_placement(members) == jacc.merge_placement(members)


# --------------------------------------------------- the standby unit


def _persisted(M, tmp, clock, cfg):
    from importlib import import_module

    pm = import_module(f"{M.__name__}.persistence")
    kw = {} if M is R else {"device": "cpu"}
    lim = M.create_limiter(cfg, "sketch", clock=clock, **kw)
    reg = M.observability.metrics.Registry()
    mgr = pm.PersistenceManager(cfg.persistence, registry=reg)
    top = mgr.wrap(lim)
    mgr.attach([top])
    return lim, mgr, top


def _fleet_cfg(M, limit=20, algorithm=None, **kw):
    extra = {"kernels": "jnp"} if M is R else {}
    return M.Config(algorithm=algorithm or M.Algorithm.SLIDING_WINDOW,
                    limit=limit, window=60.0,
                    sketch=M.SketchParams(depth=2, width=1 << 10,
                                          sub_windows=6, **extra), **kw)


def _state_equal(a, b):
    _, aa, ae = a.capture_state()
    _, ba, be = b.capture_state()
    assert sorted(aa) == sorted(ba)
    for k in aa:
        np.testing.assert_array_equal(np.asarray(aa[k]), np.asarray(ba[k]),
                                      err_msg=k)


def test_build_standby_equals_jax(tmp_path):
    """A snapshot directory the port wrote (snapshot, WAL suffix, an aux
    unit for an adopted origin): the port's ``build_standby`` (own unit
    with the aux fold, and the origin's aux unit alone) equals the JAX
    package's from the same directory."""
    from ratelimiter_tpu.fleet.handoff import build_standby as jbuild
    from ratelimiter_tpu_torch.fleet.handoff import build_standby

    d = tmp_path / "snap"
    clock = ManualClock(T0)
    cfg = _fleet_cfg(T, persistence=T.PersistenceSpec(
        dir=str(d), snapshot_interval=3600.0))
    lim, mgr, top = _persisted(T, d, clock, cfg)
    aux = T.create_limiter(_fleet_cfg(T), clock=clock, device="cpu")
    rng = np.random.default_rng(4)
    try:
        for i in range(6):
            top.allow_batch([f"k{j}" for j in rng.integers(0, 60, 50)])
            aux.allow_ids(rng.integers(0, 500, 80).astype(np.uint64))
            clock.advance(3.0)
        top.set_override("vip", 55)
        mgr.add_aux_unit("b", aux, [(16, 32)])
        mgr.snapshot_now()
        top.set_override("wal-only", 7)
        top.delete_override("vip")
        top.reset("k3")
    finally:
        mgr.stop(final_snapshot=False)
        top.close()
        aux.close()
    jcfg = _fleet_cfg(R)
    tunit = build_standby(_fleet_cfg(T), str(d), clock=ManualClock(T0),
                          device="cpu")
    junit = jbuild(jcfg, str(d), clock=JClock(T0))
    try:
        _state_equal(tunit, junit)
        assert tunit.get_override("wal-only").limit == 7
        assert tunit.get_override("vip") is None
        assert str(tunit.device) == "cpu"
    finally:
        tunit.close()
        junit.close()
    tunit = build_standby(_fleet_cfg(T), str(d), origin="b",
                          clock=ManualClock(T0), device="cpu")
    junit = jbuild(jcfg, str(d), origin="b", clock=JClock(T0))
    try:
        _state_equal(tunit, junit)
    finally:
        tunit.close()
        junit.close()
    with pytest.raises(T.CheckpointError):
        build_standby(_fleet_cfg(T), str(d), origin="ghost", device="cpu")


# ------------------------------------------------ the in-process oracle


def _server_on_thread(limiter, **kw):
    from ratelimiter_tpu_torch.serving.server import RateLimitServer

    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    srv = RateLimitServer(limiter, "127.0.0.1", 0, dcn=True, **kw)
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(10)
    return srv, loop, t


def _stop(srv, loop, t):
    asyncio.run_coroutine_threadsafe(srv.shutdown(), loop).result(10)
    loop.call_soon_threadsafe(loop.stop)
    t.join(timeout=10)
    loop.close()


class _Fleet:
    """Host A: the port's FleetForwarder over a port limiter; host B: a
    port asyncio server on a thread; both on one manual clock. Oracles:
    one JAX limiter per host, on a JAX manual clock held at the same
    time."""

    def __init__(self, algorithm=None, limit=20, forward=True):
        self.clock = ManualClock(T0)
        self.jclock = JClock(T0)
        cfg = _fleet_cfg(T, limit=limit, algorithm=algorithm
                         and getattr(T.Algorithm, algorithm))
        jcfg = _fleet_cfg(R, limit=limit, algorithm=algorithm
                          and getattr(R.Algorithm, algorithm))
        self.cfg = cfg
        self.lim_a = T.create_limiter(cfg, clock=self.clock, device="cpu")
        self.lim_b = T.create_limiter(cfg, clock=self.clock, device="cpu")
        self.server = _server_on_thread(self.lim_b)
        m = tfc.FleetMap.from_dict(_map_dict(port_b=self.server[0].port))
        self.core = tfw.FleetCore(m, "a", prefix=cfg.prefix,
                                  forward=forward, forward_deadline=30.0,
                                  registry=Registry())
        self.fwd = tfw.FleetForwarder(self.lim_a, self.core)
        self.oracles = (R.create_limiter(jcfg, "sketch", clock=self.jclock),
                        R.create_limiter(jcfg, "sketch", clock=self.jclock))

    def advance(self, dt):
        self.clock.advance(dt)
        self.jclock.advance(dt)

    def replay(self, owners, b, call):
        """Each owner's rows through its JAX oracle, in frame order."""
        allowed = np.zeros(b, dtype=bool)
        remaining = np.zeros(b, dtype=np.int64)
        retry = np.zeros(b)
        reset = np.zeros(b)
        for host, oracle in enumerate(self.oracles):
            pos = np.nonzero(owners == host)[0]
            if not pos.shape[0]:
                continue
            out = call(oracle, pos)
            allowed[pos] = out.allowed
            remaining[pos] = out.remaining
            retry[pos] = out.retry_after
            reset[pos] = out.reset_at
        return allowed, remaining, retry, reset

    def close(self):
        self.fwd.close()
        _stop(*self.server)
        self.lim_b.close()
        for o in self.oracles:
            o.close()


@pytest.mark.parametrize("algorithm", [None, "TOKEN_BUCKET"],
                         ids=["window", "bucket"])
def test_in_process_fleet_equals_jax_replay(algorithm):
    """Mixed string and raw-id frames through host A, crossing a
    sub-window: every answer (allowed, remaining, retry, reset) equals
    the JAX replay of each owner's rows, and both hosts' state equals
    their oracle's."""
    f = _Fleet(algorithm=algorithm, limit=12)
    try:
        rng = np.random.default_rng(3)
        pool = [f"user:{i}" for i in range(40)]
        for i in range(10):
            if i % 2:
                ids = rng.integers(0, 80, size=64).astype(np.uint64)
                ns = rng.integers(1, 3, size=64).astype(np.int64)
                got = f.fwd.allow_ids(ids, ns)
                owners = f.core.owners_of_ids(ids)
                want = f.replay(owners, 64,
                                lambda o, pos: o.allow_ids(ids[pos], ns[pos]))
            else:
                keys = [pool[j] for j in rng.integers(0, 40, size=25)]
                ns = rng.integers(1, 3, size=25).tolist()
                got = f.fwd.allow_batch(keys, ns)
                owners = f.core.owners_of_hash(f.core.hash_keys(keys))
                want = f.replay(owners, 25, lambda o, pos: o.allow_batch(
                    [keys[k] for k in pos], [ns[k] for k in pos]))
            for name, g, w in zip(("allowed", "remaining", "retry", "reset"),
                                  (got.allowed, got.remaining,
                                   got.retry_after, got.reset_at), want):
                np.testing.assert_array_equal(g, w, err_msg=f"{i} {name}")
            assert (owners == 1).any()
            if i == 5:
                f.advance(10.0)  # crosses a 10 s sub-window
        _state_equal(f.lim_a, f.oracles[0])
        _state_equal(f.lim_b, f.oracles[1])
        st = f.core.status()
        assert st["forwarded_total"] > 0 and st["forward_errors_total"] == 0
    finally:
        f.close()


def test_same_key_order_across_the_hop_and_reset_at_the_owner():
    f = _Fleet(limit=6)
    try:
        key = next(f"k:{i}" for i in range(100)
                   if int(f.core.owners_of_hash(
                       f.core.hash_keys([f"k:{i}"]))[0]) == 1)
        seq = [f.fwd.allow_n(key, 1) for _ in range(9)]
        assert [r.allowed for r in seq] == [True] * 6 + [False] * 3
        assert [r.remaining for r in seq[:6]] == list(range(5, -1, -1))
        f.fwd.reset(key)
        assert f.lim_b.allow_n(key, 1).allowed
    finally:
        f.close()


def test_redirect_only_door_answers_typed_not_owner():
    """A member with forwarding off answers a foreign frame E_NOT_OWNER
    at the door (parsed back into the typed error by the client), owned
    frames decide, and FLEET_MAP serves the map."""
    from ratelimiter_tpu_torch.serving.client import Client

    clock = ManualClock(T0)
    cfg = _fleet_cfg(T)
    lim_b = T.create_limiter(cfg, clock=clock, device="cpu")
    core_b = tfw.FleetCore(tfc.FleetMap.from_dict(_map_dict()), "b",
                           prefix=cfg.prefix, forward=False,
                           registry=Registry())
    srv = _server_on_thread(tfw.FleetForwarder(lim_b, core_b), fleet=core_b)
    try:
        with Client(port=srv[0].port, timeout=10) as c:
            foreign = next(f"k:{i}" for i in range(100)
                           if int(core_b.owners_of_hash(
                               core_b.hash_keys([f"k:{i}"]))[0]) == 0)
            own = next(f"k:{i}" for i in range(100)
                       if int(core_b.owners_of_hash(
                           core_b.hash_keys([f"k:{i}"]))[0]) == 1)
            with pytest.raises(NotOwnerError) as ei:
                c.allow(foreign)
            assert ei.value.epoch == 1 and "a@" in str(ei.value)
            with pytest.raises(NotOwnerError):
                c.allow_batch([own, foreign])
            ids = np.arange(200, dtype=np.uint64)
            with pytest.raises(NotOwnerError):
                c.allow_hashed(ids)
            assert c.allow(own).allowed
            assert tfc.FleetMap.from_dict(c.fleet_map()).epoch == 1
        assert core_b.status()["redirects_total"] >= 3
    finally:
        _stop(*srv)
        core_b.close()
        lim_b.close()


def test_dead_owner_degrades_per_policy():
    from netutil import free_port

    clock = ManualClock(T0)
    dead = free_port()
    for fail_open in (True, False):
        cfg = _fleet_cfg(T, limit=10, fail_open=fail_open)
        lim = T.create_limiter(cfg, clock=clock, device="cpu")
        core = tfw.FleetCore(tfc.FleetMap.from_dict(_map_dict(port_b=dead)),
                             "a", prefix=cfg.prefix, forward_deadline=0.3,
                             registry=Registry())
        fwd = tfw.FleetForwarder(lim, core)
        try:
            ids = np.arange(40, dtype=np.uint64)
            if fail_open:
                out = fwd.allow_ids(ids)
                foreign = core.owners_of_ids(ids) == 1
                assert out.fail_open and out.allowed[foreign].all()
            else:
                with pytest.raises(T.StorageUnavailableError):
                    fwd.allow_ids(ids)
        finally:
            fwd.close()


def test_string_rows_reach_a_multi_shard_peer_as_strings():
    """A peer that declares ``shards: 2`` (a native door with two
    dispatch shards, FNV-routed on the key bytes) gets its string rows
    as strings: each key decides on the shard its direct traffic uses,
    so a key spent through the forwarder is denied on the peer and every
    answer equals replays of each owner's (and shard's) rows."""
    from ratelimiter_tpu_torch.serving.client import Client
    from ratelimiter_tpu_torch.serving.native_server import (
        NativeRateLimitServer,
        fnv_shard,
    )

    clock = ManualClock(T0)
    cfg = _fleet_cfg(T, limit=6)
    lim_a = T.create_limiter(cfg, clock=clock, device="cpu")
    lim_b = T.create_limiter(cfg, clock=clock, device="cpu")
    reps = {key: T.create_limiter(cfg, clock=ManualClock(T0), device="cpu")
            for key in ("a", 0, 1)}
    door = NativeRateLimitServer(lim_b, "127.0.0.1", 0, shards=2,
                                 registry=Registry())
    door.start()
    d = _map_dict(port_b=door.port)
    d["hosts"][1]["shards"] = 2
    core = tfw.FleetCore(tfc.FleetMap.from_dict(d), "a", prefix=cfg.prefix,
                         forward_deadline=30.0, registry=Registry())
    fwd = tfw.FleetForwarder(lim_a, core)
    rng = np.random.default_rng(8)
    try:
        assert not core.peer_columnar(1)
        for _ in range(6):
            keys = [f"s:{k}" for k in rng.integers(0, 24, 30)]
            got = fwd.allow_batch(keys)
            owners = core.owners_of_hash(core.hash_keys(keys))
            for i, k in enumerate(keys):
                rep = reps["a"] if owners[i] == 0 else reps[fnv_shard(k, 2)]
                want = rep.allow_n(k, 1)
                assert (got.allowed[i], got.remaining[i]) == (
                    want.allowed, want.remaining), k
        spent = next(f"s:{k}" for k in range(24)
                     if int(core.owners_of_hash(
                         core.hash_keys([f"s:{k}"]))[0]) == 1)
        fwd.allow_batch([spent] * 8)
        with Client(port=door.port, timeout=30) as c:
            assert not c.allow(spent).allowed
    finally:
        fwd.close()
        door.shutdown()
        for r in reps.values():
            r.close()
