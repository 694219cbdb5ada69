"""The port's client-embedded quota leases (leases/, the lease frames of
serving/protocol.py, the doors' lease wiring, the persistence sidecar)
against the JAX package's, tolerance 0.

* the lease frames: every encoder byte-equal to the JAX one, round trips
  and malformed bodies refused;
* the manager: seeded grant/renew/return/revoke/expiry traces through
  both packages' managers (over the exact backend, and the sketch on the
  JAX jnp path and the port's CPU path), every answer, the status, the
  metric text, the journal events and the snapshot arrays equal;
  ``require_hot`` over a real side table, the hashed consumer token
  equal to ``consumer_stats``' on both;
* the cache: the same seeded call sequence through both caches, every
  answer and action equal; the never-over-admit oracle (the storm and
  the token-flow ledger) on both, admissions equal and within the limit;
  a lost revocation push counted, journaled and bounded by the TTL;
* the doors: the asyncio door's lease frames and revocation pushes
  byte-equal to the JAX asyncio door's; a client's lease life cycle over
  TCP and the shared-memory lane with a policy revocation, shutdown's
  revoke-all, the AsyncClient, the native door's sidecar; a lease holder
  killed with ``kill -9`` (its mass stays charged); the audit mirror; the
  off pin; the sidecar's arrays byte-equal to the JAX package's;
* the binary: ``--leases`` on both doors through
  ``chip_smoke.check_lease_binary`` on the CPU, and the flags' refusals.
"""

from __future__ import annotations

import asyncio
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu import leases as jleases
from ratelimiter_tpu.observability import Registry as JRegistry
from ratelimiter_tpu.observability import events as jevents
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu.serving.server import RateLimitServer as JServer
from ratelimiter_tpu_torch import leases as tleases
from ratelimiter_tpu_torch.observability import Registry as TRegistry
from ratelimiter_tpu_torch.observability import events as tevents
from ratelimiter_tpu_torch.serving import protocol as p
from ratelimiter_tpu_torch.serving.client import AsyncClient, Client
from ratelimiter_tpu_torch.serving.server import RateLimitServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
# (package, leases module, protocol module, journal module, Registry)
JAX = (R, jleases, jp, jevents, JRegistry)
PORT = (T, tleases, p, tevents, TRegistry)


@pytest.fixture(autouse=True)
def _journals_off():
    for mod in (jevents, tevents):
        mod.disable()
    yield
    for mod in (jevents, tevents):
        mod.disable()


class FakeClock:
    """Mutable monotonic stand-in for the manager and cache clocks."""

    def __init__(self, t: float = 100.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _limiter(M, limit=1000, backend="exact", **sketch):
    if backend == "exact":
        cfg = M.Config(algorithm=M.Algorithm.TPU_SKETCH, limit=limit,
                       window=60.0)
    else:
        sk = dict(depth=2, width=512, sub_windows=6, **sketch)
        if M is R:
            sk["kernels"] = "jnp"
        cfg = M.Config(algorithm=M.Algorithm.SLIDING_WINDOW, limit=limit,
                       window=60.0, sketch=M.SketchParams(**sk))
    kw = {} if M is R else {"device": "cpu"}
    return M.create_limiter(cfg, backend=backend,
                            clock=M.ManualClock(T0), **kw)


def _wait_until(cond, timeout=10.0, interval=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def _journal(ev_mod):
    return [(e["action"], e["severity"], e["payload"])
            for e in ev_mod.get().tail(category="lease")["events"]]


def _arrays_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


# ----------------------------------------------------------------- frames


_FRAMES = [
    ("encode_lease_grant", (7, 0xDEADBEEF12345678, "hot:key", 64, 1.5)),
    ("encode_lease_grant", (8, 1, "ü-ключ", 0, 0.0)),
    ("encode_lease_renew", (9, 5, 42, "hot:key", 17, 32)),
    ("encode_lease_return", (10, 5, 42, "hot:key", 3)),
    ("encode_lease_r", (11, True, 42, 64, 2.0, 1000, 3)),
    ("encode_lease_r", (12, False, 0, 0, 0.0, 0, 0)),
    ("encode_lease_revoke", (p.LEASE_REV_POLICY, 0, [1, 2, 3])),
    ("encode_lease_revoke", (p.LEASE_REV_SHUTDOWN, 9, [])),
]


@pytest.mark.parametrize("enc,args", _FRAMES)
def test_lease_frames_are_the_jax_bytes(enc, args):
    frame = getattr(p, enc)(*args)
    assert frame == getattr(jp, enc)(*args)
    length, type_, rid = p.parse_header(frame)
    body = frame[p.HEADER_SIZE:]
    assert len(body) == length - 9
    parse = {"encode_lease_grant": p.parse_lease_grant,
             "encode_lease_renew": p.parse_lease_renew,
             "encode_lease_return": p.parse_lease_return,
             "encode_lease_r": p.parse_lease_r,
             "encode_lease_revoke": p.parse_lease_revoke}[enc]
    jparse = getattr(jp, parse.__name__)
    assert parse(body) == jparse(body)


def test_lease_constants_and_malformed_bodies():
    for name in ("T_LEASE_GRANT", "T_LEASE_RENEW", "T_LEASE_RETURN",
                 "T_LEASE_R", "T_LEASE_REVOKE", "LEASE_REV_POLICY",
                 "LEASE_REV_LIMIT", "LEASE_REV_CONTROLLER",
                 "LEASE_REV_EPOCH", "LEASE_REV_SHUTDOWN",
                 "LEASE_REV_MANUAL", "LEASE_REASONS"):
        assert getattr(p, name) == getattr(jp, name), name
    body = p.encode_lease_revoke(1, 0, [5, 6])[p.HEADER_SIZE:]
    with pytest.raises(p.ProtocolError):
        p.parse_lease_revoke(body[:-3])
    grant = p.encode_lease_grant(1, 2, "key", 3)[p.HEADER_SIZE:]
    with pytest.raises(p.ProtocolError):
        p.parse_lease_grant(grant + b"x")
    renew = p.encode_lease_renew(1, 2, 3, "k", 4, 5)[p.HEADER_SIZE:]
    with pytest.raises(p.ProtocolError):
        p.parse_lease_renew(renew[:-1])


# ---------------------------------------------------------------- manager


def _manager_trace(pkg, seed: int, backend: str) -> dict:
    """A seeded trace of grants, renewals, returns, revocations and TTL
    expiries through one package's manager; everything it answered and
    everything it left behind."""
    M, L, P, ev, Reg = pkg
    ev.enable(capacity=4096)
    lim = _limiter(M, limit=400, backend=backend)
    clk = FakeClock()
    reg = Reg()
    pushed = []
    mgr = L.LeaseManager(lim, ttl=2.0, default_budget=16, max_budget=48,
                         max_leases=6, registry=reg, clock=clk)
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(5)]
    live = []
    out = []
    for _ in range(300):
        op = rng.random()
        if op < 0.35 or not live:
            client, key = rng.randrange(3), rng.choice(keys)
            want = rng.choice([0, 8, 16, 100])
            r = mgr.grant(client, key, want,
                          ttl_want=rng.choice([0.0, 1.0, 5.0]),
                          push=lambda f, c=client: pushed.append((c, f)))
            if r[0]:
                live.append((client, r[1], key))
        elif op < 0.6:
            client, lid, key = rng.choice(live)
            if rng.random() < 0.1:
                client ^= 1          # not the holder: refused
            r = mgr.renew(client, lid, key, rng.randrange(0, 12),
                          rng.choice([0, 0, 8, 64]))
        elif op < 0.72:
            client, lid, key = live.pop(rng.randrange(len(live)))
            r = mgr.release(client, lid, key, rng.randrange(0, 20))
        elif op < 0.8:
            r = mgr.revoke_key(rng.choice(keys),
                               rng.choice([P.LEASE_REV_POLICY,
                                           P.LEASE_REV_MANUAL]))
        elif op < 0.83:
            r = mgr.revoke_all(P.LEASE_REV_CONTROLLER)
        else:
            clk.advance(rng.random() * 1.5)
            r = None
        out.append(r)
    arrays, meta = mgr.snapshot_arrays()
    return {"answers": out, "status": mgr.status(), "metrics": reg.render(),
            "pushes": pushed, "journal": _journal(ev), "arrays": arrays,
            "meta": meta, "admits": [lim.allow_n(k, 1).allowed
                                     for k in keys]}


@pytest.mark.parametrize("backend,seed", [("exact", 1), ("exact", 2),
                                          ("sketch", 3)])
def test_seeded_manager_traces_equal_jax(backend, seed):
    j = _manager_trace(JAX, seed, backend)
    t = _manager_trace(PORT, seed, backend)
    assert t["answers"] == j["answers"]
    assert t["status"] == j["status"]
    assert t["metrics"] == j["metrics"]
    assert t["pushes"] == j["pushes"]
    assert t["journal"] == j["journal"]
    assert t["meta"] == j["meta"]
    _arrays_equal(t["arrays"], j["arrays"])
    assert t["admits"] == j["admits"]
    # The trace exercised what it claims to.
    flows = t["metrics"]
    for needle in ('result="granted"', 'result="refused"',
                   'reason="policy"', 'reason="controller"',
                   'flow="returned"', "rate_limiter_lease_expired_total"):
        assert needle in flows, needle
    assert t["status"]["granted_total"] > 10


def test_snapshot_restore_across_packages():
    """A grant table captured by either package restores into the
    other's manager to the same status, and surviving holders renew."""
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        M, L, P, _, Reg = src
        clk = FakeClock()
        mgr = L.LeaseManager(_limiter(M), ttl=4.0, default_budget=32,
                             registry=Reg(), clock=clk)
        id_a = mgr.grant(11, "a", 32)[1]
        id_b = mgr.grant(22, "b", 64)[1]
        mgr.revoke_key("b")
        arrays, meta = mgr.snapshot_arrays()
        M2, L2, _, _, Reg2 = dst
        lim2 = _limiter(M2)
        mgr2 = L2.LeaseManager(lim2, ttl=4.0, registry=Reg2(), clock=clk)
        assert mgr2.restore_arrays(arrays, meta) == 2
        assert mgr2.snapshot_arrays()[1] == meta
        st = mgr2.status()
        assert st["active"] == 1 and st["tombstoned"] == 1
        assert lim2.allow_n("probe", 1000).allowed   # no re-debit
        assert mgr2.renew(11, id_a, "a", 3, 0)[0]
        assert not mgr2.renew(22, id_b, "b", 0, 0)[0]
        assert mgr2.grant(33, "c")[1] > max(id_a, id_b)


def _hot_side_table(M):
    # Promoted past 1% of the limit: "hot" crosses it, the others not.
    lim = _limiter(M, limit=10_000, backend="sketch", hh_slots=64,
                   hh_promote_fraction=0.01)
    for i in range(40):
        lim.allow_batch(["hot"] * 8 + [f"cold{i}-{j}" for j in range(8)],
                        [1] * 16)
    return lim


def test_require_hot_reads_the_side_table_on_both():
    """``require_hot`` nominates from the side table: the manager's
    consumer token is the side table's ``consumer`` bytes on both
    packages (the same hex string), so the hot key is granted and a cold
    one refused, with the same answers."""
    answers = []
    for M, L, _, _, Reg in (JAX, PORT):
        lim = _hot_side_table(M)
        mgr = L.LeaseManager(lim, require_hot=True, hot_k=4,
                             default_budget=32, registry=Reg(),
                             clock=FakeClock())
        top = [row["consumer"] for row in lim.consumer_stats(4)["top"]]
        assert mgr._consumer_token("hot") == top[0]
        answers.append((mgr._consumer_token("hot"), mgr.grant(1, "hot"),
                        mgr.grant(1, "never-seen"), mgr.status()))
        lim.close()
    assert answers[1] == answers[0]
    assert answers[1][1][0] and not answers[1][2][0]


def test_lost_push_is_counted_journaled_and_ttl_bounded():
    """A revocation push that cannot be delivered (the holder's
    connection is gone) is counted and journaled; the holder's cache,
    which never heard, answers locally only until the TTL."""
    tevents.enable(capacity=64)
    clk = FakeClock()
    reg = TRegistry()
    mgr = tleases.LeaseManager(_limiter(T), ttl=2.0, default_budget=32,
                               registry=reg, clock=clk)
    cache = tleases.LeaseCache(client_id=3, registry=TRegistry(),
                               clock=clk)

    def gone(_frame):
        raise ConnectionError("holder is gone")

    out = mgr.grant(3, "k", 32, push=gone)
    cache.on_grant("k", *out)
    assert mgr.revoke_key("k", p.LEASE_REV_POLICY) == 1
    assert reg.get("rate_limiter_lease_push_failures_total").value() == 1.0
    assert any(a == "revoke" for a, _, _ in _journal(tevents))
    assert cache.try_acquire("k") is not None
    clk.advance(2.1)
    assert cache.try_acquire("k") is None
    assert not mgr.renew(3, out[1], "k", 1, 0)[0]


def test_audit_mirror_offers_leased_admissions():
    from ratelimiter_tpu_torch.observability import audit

    cfg = T.Config(algorithm=T.Algorithm.TPU_SKETCH, limit=1000,
                   window=60.0)
    aud = audit.enable(cfg, sample=1, start=False, registry=TRegistry(),
                       device="cpu")
    try:
        mgr = tleases.LeaseManager(_limiter(T), registry=TRegistry(),
                                   clock=FakeClock())
        lease_id = mgr.grant(1, "k", 64)[1]
        mgr.renew(1, lease_id, "k", 10, 0)
        mgr.release(1, lease_id, "k", 5)
        aud.process_pending()
        assert aud.status()["samples"] >= 2
    finally:
        audit.disable()


def test_leases_off_pin():
    """A manager attached with no grants changes no decision."""
    rng = random.Random(1234)
    workload = [(f"k{rng.randrange(8)}", rng.randrange(1, 4))
                for _ in range(300)]
    plain, leased = _limiter(T, limit=100), _limiter(T, limit=100)
    tleases.LeaseManager(leased, registry=TRegistry())
    assert [plain.allow_n(k, n) for k, n in workload] == \
        [leased.allow_n(k, n) for k, n in workload]


# ------------------------------------------------------------------ cache


def _cache_trace(pkg, seed: int) -> list:
    M, L, _, _, Reg = pkg
    clk = FakeClock()
    cache = L.LeaseCache(client_id=7, hot_after=3, hot_window=1.0,
                         want=0, low_water=0.25, max_tracked=8,
                         registry=Reg(), clock=clk)
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(12)]
    out = []
    next_id = 1
    for _ in range(400):
        op = rng.random()
        key = rng.choice(keys)
        if op < 0.4:
            r = cache.try_acquire(key, rng.choice([1, 1, 2, 5]))
            out.append(None if r is None else (r.allowed, r.limit,
                                               r.remaining))
        elif op < 0.6:
            cache.note_wire(key)
        elif op < 0.75:
            acts = cache.actions()
            out.append(acts)
            for act in acts:
                if act[0] == "grant":
                    ok = rng.random() < 0.8
                    cache.on_grant(act[1], ok, next_id, 10, 2.0, 100,
                                   rng.randrange(2))
                    next_id += 1
                elif rng.random() < 0.2:
                    cache.renew_failed(act[2], act[3])
                else:
                    cache.on_renew(act[2], rng.random() < 0.9, act[4],
                                   2.0, 100, 0)
        elif op < 0.8:
            out.append(cache.invalidate_ids(
                [rng.randrange(1, next_id + 1)]))
        elif op < 0.82:
            out.append(cache.on_epoch(rng.randrange(3)))
        else:
            clk.advance(rng.random() * 0.8)
        out.append(cache.status())
    out.append(cache.drain())
    return out


@pytest.mark.parametrize("seed", [5, 6])
def test_seeded_cache_traces_equal_jax(seed):
    assert _cache_trace(PORT, seed) == _cache_trace(JAX, seed)


def _storm(pkg) -> dict:
    """tests/test_leases.py's storm: grants, local spends, renews,
    revocations with lost pushes, abandons; one frozen window."""
    M, L, P, _, Reg = pkg
    limit = 500
    lim = _limiter(M, limit=limit)
    clk = FakeClock()
    mgr = L.LeaseManager(lim, ttl=3.0, default_budget=16, registry=Reg(),
                         clock=clk)
    cache = L.LeaseCache(client_id=7, hot_after=2, hot_window=10.0,
                         registry=Reg(), clock=clk)
    rng = random.Random(42)
    keys = ["alpha", "beta", "gamma"]
    admitted = {k: 0 for k in keys}

    def drive():
        for act in cache.actions():
            if act[0] == "grant":
                out = mgr.grant(cache.client_id, act[1], act[2])
                cache.on_grant(act[1], *out)
            else:
                _, key, lease_id, delta, top_up = act
                out = mgr.renew(cache.client_id, lease_id, key, delta,
                                top_up)
                cache.on_renew(lease_id, out[0], out[2], out[3], out[4],
                               out[5])

    for step in range(4000):
        key = rng.choice(keys)
        res = cache.try_acquire(key)
        if res is not None:
            admitted[key] += 1
        else:
            if lim.allow_n(key, 1).allowed:
                admitted[key] += 1
            cache.note_wire(key)
        if step % 7 == 0:
            drive()
        roll = rng.random()
        if roll < 0.01:
            victim = rng.choice(keys)
            ids = [i for i, k in list(cache._by_id.items()) if k == victim]
            mgr.revoke_key(victim, P.LEASE_REV_POLICY)
            if rng.random() < 0.5:
                cache.invalidate_ids(ids)
        elif roll < 0.02:
            cache.invalidate_ids([])
        elif roll < 0.1:
            clk.advance(rng.random())
    for k in keys:
        assert admitted[k] <= limit, (k, admitted[k])
    for k in keys:
        for _ in range(3 * limit):
            res = cache.try_acquire(k)
            if res is None:
                res = lim.allow_n(k, 1)
            if res.allowed:
                admitted[k] += 1
        assert admitted[k] <= limit, (k, admitted[k])
        assert not lim.allow_n(k, 1).allowed
    return {"admitted": admitted, "status": mgr.status()}


def test_never_over_admit_storm_equal_to_jax():
    assert _storm(PORT) == _storm(JAX)


def test_grants_plus_wire_bounded_by_limit():
    for M, L, _, _, Reg in (JAX, PORT):
        limit = 300
        lim = _limiter(M, limit=limit)
        clk = FakeClock()
        reg = Reg()
        mgr = L.LeaseManager(lim, ttl=1.0, default_budget=50,
                             registry=reg, clock=clk)
        rng = random.Random(7)
        wire = 0
        for i in range(40):
            if rng.random() < 0.5:
                mgr.grant(i, "k", 50)
                clk.advance(1.1)
            elif lim.allow_n("k", 5).allowed:
                wire += 5
        granted = int(reg.get("rate_limiter_lease_tokens_total")
                      .value(flow="granted"))
        assert granted + wire <= limit
        assert not lim.allow_n("k", limit).allowed


# ------------------------------------------------------------------ doors


@contextmanager
def _door(cls, limiter, **kw):
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server = cls(limiter, "127.0.0.1", 0, **kw)
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=10)
    try:
        yield server
    finally:
        asyncio.run_coroutine_threadsafe(server.shutdown(),
                                         loop).result(timeout=20)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()


class _Raw:
    """One raw connection: send a frame, read frames (pushes too)."""

    def __init__(self, port: int):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.buf = b""

    def frame(self) -> bytes:
        while True:
            if len(self.buf) >= 4:
                n = int.from_bytes(self.buf[:4], "little") + 4
                if len(self.buf) >= n:
                    f, self.buf = self.buf[:n], self.buf[n:]
                    return f
            chunk = self.s.recv(65536)
            assert chunk, "door closed the connection"
            self.buf += chunk

    def call(self, frame: bytes) -> bytes:
        self.s.sendall(frame)
        return self.frame()

    def close(self) -> None:
        self.s.close()


def _door_lease_bytes(pkg, server_cls) -> list:
    M, L, P, _, Reg = pkg
    lim = _limiter(M, limit=200)
    mgr = L.LeaseManager(lim, ttl=2.0, default_budget=64, registry=Reg())
    out = []
    with _door(server_cls, lim, leases=mgr) as srv:
        a, b = _Raw(srv.port), _Raw(srv.port)
        try:
            out.append(a.call(P.encode_lease_grant(1, 11, "hot", 0)))
            out.append(b.call(P.encode_lease_grant(2, 22, "hot", 50)))
            out.append(a.call(P.encode_lease_grant(3, 11, "hot", 100)))
            out.append(a.call(P.encode_lease_renew(4, 11, 1, "hot", 5, 0)))
            out.append(a.call(P.encode_lease_renew(5, 99, 1, "hot", 5, 0)))
            out.append(b.call(P.encode_lease_grant(6, 22, "cold", 8)))
            out.append(b.call(P.encode_lease_return(7, 22, 3, "cold", 2)))
            # A policy set revokes the key's leases: a push to each
            # granting connection, then the POLICY_R.
            out.append(a.call(P.encode_policy_set(8, "hot", 7)))
            out.append(a.frame())
            out.append(b.frame())
            out.append(b.call(P.encode_lease_grant(9, 22, "r", 4)))
            out.append(b.call(P.encode_reset(10, "r")))
            out.append(b.frame())
            out.append(a.call(P.with_trace(
                P.encode_lease_renew(11, 11, 1, "hot", 0, 0), 77)))
        finally:
            a.close()
            b.close()
    return out


def test_door_lease_frames_and_pushes_equal_the_jax_door():
    t = _door_lease_bytes(PORT, RateLimitServer)
    j = _door_lease_bytes(JAX, JServer)
    assert t == j
    types = [p.parse_header(f)[1] for f in t]
    assert types.count(p.T_LEASE_REVOKE) == 3 and p.T_OK in types


def test_leases_off_answers_like_the_jax_door():
    for M, _, P, _, _ in (PORT, JAX):
        cls = RateLimitServer if M is T else JServer
        with _door(cls, _limiter(M)) as srv:
            c = _Raw(srv.port)
            try:
                f = c.call(P.encode_lease_grant(1, 2, "k", 0))
            finally:
                c.close()
        code, msg = P.parse_error(f[P.HEADER_SIZE:])
        assert code == P.E_INVALID_CONFIG and "--leases" in msg


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_client_lease_lifecycle_and_policy_revocation(transport):
    lim = _limiter(T, limit=100000)
    mgr = tleases.LeaseManager(lim, ttl=2.0, default_budget=64,
                               registry=TRegistry())
    with _door(RateLimitServer, lim, leases=mgr, shm=True) as srv:
        with Client(port=srv.port, transport=transport) as c:
            cache = c.enable_leases(interval=0.02, hot_after=3,
                                    hot_window=5.0)
            _wait_until(lambda: (c.allow("hot").allowed
                                 and cache.status()["leased_keys"] > 0),
                        what="lease grant")
            before = cache.status()["local_answers"]
            for _ in range(32):
                assert c.allow("hot").allowed
            assert cache.status()["local_answers"] > before
            assert mgr.status()["active"] >= 1
            c.set_override("hot", 50000)
            _wait_until(lambda: cache.status()["leased_keys"] == 0,
                        what="the revocation push")
            assert c.allow("hot").allowed


def test_shutdown_revokes_all():
    lim = _limiter(T, limit=100000)
    mgr = tleases.LeaseManager(lim, ttl=30.0, default_budget=16,
                               registry=TRegistry())
    with _door(RateLimitServer, lim, leases=mgr) as srv:
        with Client(port=srv.port) as c:
            cache = c.enable_leases(interval=0.02, hot_after=2,
                                    hot_window=5.0)
            _wait_until(lambda: (c.allow("k").allowed
                                 and cache.status()["leased_keys"] > 0),
                        what="lease grant")
    assert mgr.status()["active"] == 0


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_async_client_leases_and_pushes(transport):
    """The AsyncClient's leases pipeline on its own connection, and a
    policy revocation's push comes back on it (over the lane: through
    the reply ring)."""
    lim = _limiter(T, limit=100000)
    mgr = tleases.LeaseManager(lim, ttl=2.0, default_budget=64,
                               registry=TRegistry())

    async def go():
        server = RateLimitServer(lim, "127.0.0.1", 0, leases=mgr, shm=True)
        await server.start()
        c = await AsyncClient.connect(port=server.port, transport=transport)
        try:
            cache = await c.enable_leases(interval=0.02, hot_after=3,
                                          hot_window=5.0)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                assert (await c.allow("hot")).allowed
                if cache.status()["leased_keys"]:
                    break
                await asyncio.sleep(0.005)
            assert cache.status()["leased_keys"] == 1
            before = cache.status()["local_answers"]
            for _ in range(20):
                assert (await c.allow("hot")).allowed
            assert cache.status()["local_answers"] > before
            assert await c.set_override("hot", 9000)
            deadline = time.monotonic() + 10
            while cache.status()["leased_keys"] and \
                    time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            assert cache.status()["leased_keys"] == 0
        finally:
            await c.close()
            await server.shutdown()

    asyncio.run(go())
    assert mgr.status()["active"] == 0


def test_native_door_sidecar():
    from ratelimiter_tpu_torch.serving.native_server import (
        NativeRateLimitServer,
    )

    lim = _limiter(T, limit=100000)
    mgr = tleases.LeaseManager(lim, ttl=2.0, default_budget=64,
                               registry=TRegistry())
    listener = tleases.LeaseListener(mgr, "127.0.0.1", 0)
    listener.start()
    srv = NativeRateLimitServer(lim, "127.0.0.1", 0, registry=TRegistry(),
                                leases=mgr)
    srv.start()
    try:
        assert srv.leases is mgr
        with Client(port=srv.port) as c:
            cache = c.enable_leases(lease_port=listener.port,
                                    interval=0.02, hot_after=3,
                                    hot_window=5.0)
            _wait_until(lambda: (c.allow("hot").allowed
                                 and cache.status()["leased_keys"] > 0),
                        what="a grant through the sidecar")
            before = cache.status()["local_answers"]
            for _ in range(20):
                assert c.allow("hot").allowed
            assert cache.status()["local_answers"] > before
            mgr.revoke_all(p.LEASE_REV_MANUAL)
            _wait_until(lambda: cache.status()["leased_keys"] == 0,
                        what="the push through the sidecar")
            # A frame that is no lease frame: the JAX listener's answer.
            raw = _Raw(listener.port)
            try:
                code, msg = p.parse_error(raw.call(
                    p.encode_simple(p.T_HEALTH, 5))[p.HEADER_SIZE:])
            finally:
                raw.close()
            assert code == p.E_INTERNAL and "unknown request" in msg
    finally:
        srv.shutdown()
        listener.close()


_HOLDER = """
import sys, time
sys.path.insert(0, {repo!r})
from ratelimiter_tpu_torch.serving.client import Client

c = Client(port=int(sys.argv[1]))
cache = c.enable_leases(interval=0.02, hot_after=1, hot_window=60.0,
                        low_water=0.0)
assert c.allow("hh").allowed
deadline = time.monotonic() + 30
while not cache.status()["leased_keys"]:
    if time.monotonic() > deadline:
        sys.exit(3)
    time.sleep(0.01)
for _ in range(5):
    assert c.allow("hh").allowed
print("LEASED", flush=True)
time.sleep(600)
"""


def test_killed_holder_budget_expires_and_mass_stays(tmp_path):
    limit, budget = 200, 64
    lim = _limiter(T, limit=limit)
    mgr = tleases.LeaseManager(lim, ttl=1.0, default_budget=budget,
                               registry=TRegistry())
    script = tmp_path / "holder.py"
    script.write_text(_HOLDER.format(repo=REPO))
    with _door(RateLimitServer, lim, leases=mgr) as srv:
        proc = subprocess.Popen([sys.executable, str(script), str(srv.port)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            line = ""
            deadline = time.monotonic() + 60
            while "LEASED" not in line and time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
            assert "LEASED" in line, line
            assert mgr.status()["active"] == 1
            arrays, meta = mgr.snapshot_arrays()
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
            _wait_until(lambda: (mgr.grant(99, "sweep-probe")[0] or True)
                        and mgr.status()["expired_total"] >= 1,
                        what="the grant's expiry")
            assert "hh" not in mgr._by_key
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
    assert lim.allow_n("hh", limit - budget - 1).allowed
    assert not lim.allow_n("hh", 1).allowed
    mgr2 = tleases.LeaseManager(_limiter(T, limit=limit), ttl=1.0,
                                registry=TRegistry())
    assert mgr2.restore_arrays(arrays, meta) == 1
    assert mgr2.limiter.allow_n("probe", limit).allowed


# ----------------------------------------------------------- persistence


def _sidecar_dir(pkg, tmp_path, name: str):
    M, L, _, _, Reg = pkg
    d = str(tmp_path / name)
    spec = M.PersistenceSpec(dir=d, snapshot_interval=3600.0)
    if M is R:
        from ratelimiter_tpu.persistence import PersistenceManager
    else:
        from ratelimiter_tpu_torch.persistence import PersistenceManager
    pm = PersistenceManager(spec)
    lim = pm.wrap(_limiter(M))
    pm.attach([lim])
    pm.recover()
    clk = FakeClock()
    mgr = L.LeaseManager(lim, ttl=4.0, default_budget=32, registry=Reg(),
                         clock=clk)
    pm.add_sidecar("leases", mgr)
    mgr.grant(11, "a", 32)
    mgr.grant(22, "b", 64)
    mgr.grant(33, "c", 16)
    mgr.revoke_key("b")
    clk.advance(1.25)
    entry = pm.snapshot_now()
    pm.stop(final_snapshot=False)
    return d, entry, clk


def test_sidecar_arrays_byte_equal_to_jax(tmp_path):
    from ratelimiter_tpu.persistence.snapshotter import (
        load_sidecar as jload,
    )
    from ratelimiter_tpu_torch.persistence import PersistenceManager
    from ratelimiter_tpu_torch.persistence.snapshotter import load_sidecar

    jd, jentry, _ = _sidecar_dir(JAX, tmp_path, "jax")
    td, tentry, clk = _sidecar_dir(PORT, tmp_path, "port")
    assert tentry["sidecars"] == jentry["sidecars"] == [
        {"name": "leases", "file": "side-00000001-leases.npz"}]
    ja, jm = jload(jd, jentry, "leases")
    ta, tm = load_sidecar(td, tentry, "leases")
    assert tm == jm
    _arrays_equal(ta, ja)
    # Either package reads the other's file to the same arrays.
    _arrays_equal(load_sidecar(jd, jentry, "leases")[0], ja)
    _arrays_equal(jload(td, tentry, "leases")[0], ta)
    # restore_sidecar after recovery, from the newest entry.
    pm = PersistenceManager(T.PersistenceSpec(dir=td))
    lim = pm.wrap(_limiter(T))
    pm.attach([lim])
    pm.recover()
    mgr = tleases.LeaseManager(lim, ttl=4.0, registry=TRegistry(),
                               clock=clk)
    assert pm.restore_sidecar("leases", mgr)
    st = mgr.status()
    assert (st["active"], st["tombstoned"]) == (2, 1)
    assert not pm.restore_sidecar("other", mgr)
    pm.stop(final_snapshot=False)


# ---------------------------------------------------------------- binary


def test_binary_lease_flags_and_refusals():
    from ratelimiter_tpu_torch.serving.__main__ import build_config, parse_args

    args = parse_args(["--leases", "--lease-ttl", "3", "--lease-budget",
                       "8", "--lease-max", "16", "--grpc-port", "0"])
    assert (args.leases, args.lease_ttl, args.lease_budget, args.lease_max,
            args.lease_require_hot, args.lease_port, args.grpc_port) == \
        (True, 3.0, 8, 16, False, None, 0)
    d = parse_args([])
    assert (d.lease_ttl, d.lease_budget, d.lease_max, d.grpc_port) == \
        (2.0, 256, 4096, None)
    for argv, msg in (
            (["--lease-require-hot"], "needs --leases"),
            (["--leases", "--lease-require-hot"], "needs --hh-slots"),
            (["--leases", "--lease-port", "0"], "native door's lease")):
        with pytest.raises(SystemExit, match=msg):
            build_config(parse_args(argv))
    build_config(parse_args(["--leases", "--lease-require-hot",
                             "--hh-slots", "64"]))
    build_config(parse_args(["--native", "--leases", "--lease-port", "0"]))


@pytest.mark.parametrize("native", [False, True], ids=["asyncio", "native"])
def test_binary_leases_on_cpu(tmp_path, native):
    """``chip_smoke.check_lease_binary`` on the CPU: the binary with
    ``--leases --lease-require-hot --hh-slots --grpc-port --snapshot-dir``
    (the native door with two shards and ``--lease-port``) as a child
    process: gRPC answers equal the binary door's, a leased client
    answers the hot key locally and sees the policy revocation, the
    lease table survives a kill and recovery, no child is left."""
    sys.path.insert(0, REPO)
    import chip_smoke

    out = chip_smoke.check_lease_binary(str(tmp_path), native=native,
                                        device="cpu")
    assert out["local_answers"] > 0 and out["revoked"]
    assert out["restored"]["tombstoned"] + out["restored"]["active"] >= 1
