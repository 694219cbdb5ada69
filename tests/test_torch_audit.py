"""The port's shadow auditor (observability/audit.py) and the
micro-batcher's audit tap against the JAX package's, tolerance 0.

* Seeded tapped traces on the hashed, ids and keys lanes (the key
  prefix, per-slice attribution, fail-open exclusion with and without
  named slices, drop-and-count, a ``live_config`` limit and window flip,
  power-of-two and remixed sample rates, the windowed and token-bucket
  twins) go through the JAX ``ShadowAuditor`` (its twin the JAX
  limiter's jnp path) and the port's (``device="cpu"``), both with
  ``start=False``: ``status()`` is equal field by field, and so are the
  gauges each exports.
* The port's ``MicroBatcher`` with the tap on and off gives identical
  reply bytes and final state; its tally equals an offline recomputation
  through the port's ``ShadowComparator``, including a window the SLO
  answered whose shielded launch lands later and is tapped then.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.core.types import BatchResult as JBatchResult
from ratelimiter_tpu.observability import audit as jaudit
from ratelimiter_tpu.observability import metrics as jm
from ratelimiter_tpu_torch.core.types import BatchResult as TBatchResult
from ratelimiter_tpu_torch.evaluation.compare import ShadowComparator
from ratelimiter_tpu_torch.observability import audit as taudit
from ratelimiter_tpu_torch.observability import metrics as tm
from ratelimiter_tpu_torch.ops.hashing import hash_prefixed_u64, splitmix64
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.batcher import MicroBatcher

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _audit_off():
    jaudit.disable()
    taudit.disable()
    yield
    jaudit.disable()
    taudit.disable()


def _cfgs(algorithm="SLIDING_WINDOW", limit=5, width=1 << 10, depth=2,
          sub_windows=8, prefix="", window=60.0):
    out = []
    for pkg in (R, T):
        out.append(pkg.Config(
            algorithm=pkg.Algorithm[algorithm], limit=limit, window=window,
            key_prefix=prefix,
            sketch=pkg.SketchParams(depth=depth, width=width,
                                    sub_windows=sub_windows)))
    return out


def _result(cls, allowed, fail_open=False, slices=None):
    allowed = np.asarray(allowed, dtype=bool)
    b = allowed.shape[0]
    res = cls(allowed=allowed, limit=5, remaining=np.zeros(b, np.int64),
              retry_after=np.zeros(b, np.float64),
              reset_at=np.zeros(b, np.float64), fail_open=fail_open)
    if slices is not None:
        res.fail_open_slices = list(slices)
    return res


class Pair:
    """One auditor in each package over equal configs (JAX first), both
    without a worker thread, each exporting its gauges to a registry of
    its own package. The twin's width is 2^14 unless given (one JAX
    compile of the twin's step serves every test of a worker)."""

    def __init__(self, cfgs, **kw):
        kw.setdefault("twin_width", 1 << 14)
        self.cfgs = list(cfgs)
        self.regs = (jm.Registry(), tm.Registry())
        live = kw.pop("live", False)
        self.auds = []
        for i, (mod, cfg, reg) in enumerate(zip((jaudit, taudit), self.cfgs,
                                                self.regs)):
            extra = {"device": "cpu"} if mod is taudit else {}
            if live:
                extra["live_config"] = (lambda i=i: self.cfgs[i])
            self.auds.append(mod.ShadowAuditor(cfg, start=False,
                                               registry=reg, **kw, **extra))

    def offer(self, lane: str, data, ns, now, allowed, *, fail_open=False,
              slices=None, slice_idx=-1) -> None:
        for aud, cls in zip(self.auds, (JBatchResult, TBatchResult)):
            getattr(aud, f"offer_{lane}")(
                data, ns, now, _result(cls, allowed, fail_open, slices),
                slice_idx=slice_idx)

    def check(self) -> dict:
        for aud in self.auds:
            aud.process_pending()
        j, t = (aud.status() for aud in self.auds)
        assert t == j
        jt, tt = (reg.render() for reg in self.regs)
        assert tt == jt
        return t

    def close(self) -> None:
        for aud in self.auds:
            aud.close()


def _trace(rng, lane: str, n_frames: int, pool: int = 96):
    """Seeded frames: (data, ns or None, now, live allowed)."""
    keys = [f"user:{i}" for i in range(pool)]
    now = T0
    for _ in range(n_frames):
        b = int(rng.integers(1, 48))
        pick = rng.integers(0, pool, size=b)
        if lane == "keys":
            data = [keys[i] for i in pick]
        elif lane == "ids":
            data = pick.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        else:
            data = splitmix64(pick.astype(np.uint64) + np.uint64(7))
        ns = (None if rng.random() < 0.3
              else rng.integers(1, 4, size=b).astype(np.int64))
        now += float(rng.choice([0.05, 0.9, 4.0, 31.0]))
        yield data, ns, now, rng.random(b) < 0.7


@pytest.mark.parametrize("lane", ["hashed", "ids", "keys"])
@pytest.mark.parametrize("sample", [1, 4, 6])
@pytest.mark.parametrize("twin", [True, False])
def test_lanes_status_equal(lane, sample, twin):
    rng = np.random.default_rng(sample * 10 + len(lane))
    p = Pair(_cfgs(prefix="rl" if lane == "keys" else ""), sample=sample,
             include_twin=twin)
    try:
        for data, ns, now, allowed in _trace(rng, lane, 24):
            p.offer(lane, data, ns, now, allowed)
        st = p.check()
        assert st["samples"] > 0 and st["twin"] is twin
    finally:
        p.close()


def test_token_bucket_twin():
    rng = np.random.default_rng(3)
    p = Pair(_cfgs("TOKEN_BUCKET", limit=4, window=10.0), sample=2)
    try:
        for data, ns, now, allowed in _trace(rng, "hashed", 20):
            p.offer("hashed", data, ns, now, allowed)
        assert p.check()["samples"] > 0
    finally:
        p.close()


def test_per_slice_and_fail_open():
    """Four slices: rows attributed by h64 % 4 (or by a frame's own
    slice index); fail-open frames with named slices exclude those rows
    only, unattributed ones the whole frame."""
    rng = np.random.default_rng(11)
    p = Pair(_cfgs(), sample=1, n_slices=4)
    try:
        for i, (data, ns, now, allowed) in enumerate(
                _trace(rng, "hashed", 30)):
            kw = {}
            if i % 5 == 1:
                kw = dict(fail_open=True, slices=[1, 3])
            elif i % 5 == 2:
                kw = dict(fail_open=True)
            elif i % 5 == 3:
                kw = dict(slice_idx=2)
            p.offer("hashed", data, ns, now, allowed, **kw)
        st = p.check()
        assert st["fail_open_samples"] > 0
        assert set(st["per_slice"]) == {"0", "1", "2", "3"}
    finally:
        p.close()


def test_drop_and_count():
    rng = np.random.default_rng(5)
    p = Pair(_cfgs(), sample=2, queue_depth=3)
    try:
        frames = list(_trace(rng, "ids", 12))
        for data, ns, now, allowed in frames[:8]:
            p.offer("ids", data, ns, now, allowed)
        st = p.check()
        assert st["dropped_frames"] == 5
        assert st["dropped_decisions"] == sum(len(f[3]) for f in frames[3:8])
        for data, ns, now, allowed in frames[8:]:
            p.offer("ids", data, ns, now, allowed)
        p.check()
    finally:
        p.close()


def test_live_config_flip():
    """The audited limiter's limit, then its window, moves mid-stream:
    both auditors re-baseline their shadow legs at the same entry."""
    rng = np.random.default_rng(9)
    p = Pair(_cfgs(), sample=1, live=True)
    try:
        frames = list(_trace(rng, "keys", 30, pool=24))
        for i, (data, ns, now, allowed) in enumerate(frames):
            if i == 10:
                p.cfgs = [dataclasses.replace(c, limit=9) for c in p.cfgs]
            if i == 20:
                p.cfgs = [dataclasses.replace(c, window=45.0)
                          for c in p.cfgs]
            p.offer("keys", data, ns, now, allowed)
            p.check()
    finally:
        p.close()


def test_default_twin_width():
    """The twin's width follows the JAX rule: 64x the sketch width over
    the sample rate, rounded up to a power of two, at least 2^14."""
    jcfg, tcfg = _cfgs(width=1 << 12)
    for sample, width in ((1, 1 << 18), (3, 1 << 17), (64, 1 << 14)):
        auds = [jaudit.ShadowAuditor(jcfg, sample=sample, start=False,
                                     include_twin=False),
                taudit.ShadowAuditor(tcfg, sample=sample, start=False,
                                     include_twin=False, device="cpu")]
        assert [a.twin_width for a in auds] == [width, width]
        for a in auds:
            a.close()


def test_enable_disable_seam():
    cfg = _cfgs()[1]
    assert taudit.AUDITOR is None
    a = taudit.enable(cfg, sample=4, include_twin=False, device="cpu")
    assert taudit.get() is a
    taudit.disable()
    assert taudit.AUDITOR is None


# ------------------------------------------------- the micro-batcher's tap


def _frames(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 2:
            keys = [f"user:{int(k)}" for k in rng.integers(0, 40, 12)]
            out.append(("keys", keys, [1] * len(keys)))
        else:
            ids = rng.integers(0, 64, size=int(rng.integers(4, 40)))
            out.append(("ids", ids.astype(np.uint64),
                        rng.integers(1, 3, size=ids.shape[0])
                        .astype(np.uint32)))
    return out


def _drive(frames, *, tapped: bool, sample: int = 1, twin: bool = True,
           clock_step: float = 0.7):
    """The frames through the port's batcher over a CPU limiter, one
    window at a time at a stepped ManualClock; returns the reply bytes,
    the final state, the frames' (data, ns, now, allowed) and the
    auditor's status (None when untapped)."""
    cfg = _cfgs()[1]

    async def run():
        lim = T.create_limiter(cfg, backend="sketch",
                               clock=T.ManualClock(T0), device="cpu")
        b = MicroBatcher(lim, max_batch=64, max_delay=1e-4)
        aud = (taudit.enable(cfg, sample=sample, include_twin=twin,
                             device="cpu") if tapped else None)
        replies, seen = [], []
        for i, (kind, data, ns) in enumerate(frames):
            now = T0 + i * clock_step
            lim.clock.set(now)
            if kind == "ids":
                out = await b.submit_hashed_nowait(data, ns, 0)
                replies.append(b"".join(
                    bytes(x) for x in tp.encode_result_hashed_views(i, out)))
                seen.append(("ids", data, ns, now, out.allowed))
            else:
                outs = await asyncio.gather(
                    *b.submit_many_nowait(zip(data, ns)))
                replies.append(b"".join(bytes(x) for x in
                                        tp.encode_result_batch_views(
                                            i, cfg.limit, outs)))
                seen.append(("keys", data, ns, now,
                             np.array([r.allowed for r in outs])))
        await b.drain()
        b.close()
        _, arrays, _ = lim.capture_state()
        lim.close()
        st = None
        if aud is not None:
            assert aud.flush(timeout=20)
            st = aud.status()
            taudit.disable()
        return replies, arrays, seen, st

    return asyncio.run(run())


def test_tap_off_and_on_reply_bytes_identical():
    frames = _frames(0)
    off, arrays_off, _, st_off = _drive(frames, tapped=False)
    on, arrays_on, _, st_on = _drive(frames, tapped=True)
    assert st_off is None and st_on["samples"] > 0
    assert on == off
    for k, v in arrays_off.items():
        assert np.array_equal(arrays_on[k], v), k


def _recompute(seen, cfg, twin: bool = True):
    comp = ShadowComparator(cfg, include_twin=twin, device="cpu",
                            twin_width=1 << 16)
    for kind, data, ns, now, allowed in seen:
        h64 = (splitmix64(np.asarray(data, dtype=np.uint64))
               if kind == "ids" else hash_prefixed_u64(data, cfg.prefix))
        comp.observe(h64, np.asarray(ns, dtype=np.int64), now, allowed)
    t = comp.tally
    comp.close()
    return t


def test_tally_equals_offline_recomputation():
    frames = _frames(1, 30)
    _, _, seen, st = _drive(frames, tapped=True, clock_step=0.4)
    t = _recompute(seen, _cfgs()[1])
    assert st["samples"] == t.requests
    assert st["false_denies"] == t.false_denies_vs_oracle
    assert st["false_allows"] == t.false_allows_vs_oracle
    assert st["oracle_allows"] == t.oracle_allows
    assert st["semantic_disagreements"] == t.semantic_disagreements
    assert st["audited_frames"] == len(frames)
    # Hot keys at limit 5 deny: the comparison is not vacuous.
    assert t.oracle_allows < t.requests


def test_slo_answered_window_tapped_late():
    """A window past the dispatch SLO is answered fail-open at once; its
    shielded launch still lands and consumes the window's mass, and the
    tap offers THAT result (the limiter's decisions at the window's
    now), so the tally equals a recomputation over the real decisions,
    not the fail-open answers."""
    cfg = dataclasses.replace(_cfgs()[1], fail_open=True)

    async def run():
        lim = T.create_limiter(cfg, backend="sketch",
                               clock=T.ManualClock(T0), device="cpu")
        real, landed = lim.allow_ids, []

        def slow(ids, ns=None, *, now=None):
            time.sleep(0.15)                       # past the 50 ms SLO
            out = real(ids, ns, now=now)
            landed.append((ids, ns, out.allowed))
            return out

        lim.allow_ids = slow
        b = MicroBatcher(lim, max_batch=64, max_delay=1e-4,
                         dispatch_timeout=0.05)
        aud = taudit.enable(cfg, sample=1, include_twin=True, device="cpu")
        ids = np.array([1, 2, 2, 3, 3, 3, 3, 3, 3, 3], dtype=np.uint64)
        out = await b.submit_hashed_nowait(ids, np.ones(10, np.uint32), 0)
        assert out.fail_open and out.allowed.all()
        await b.drain()
        b.close()                 # the shielded launch has landed
        await asyncio.sleep(0.05)  # its done callback has run
        lim.close()
        assert aud.flush(timeout=10)
        st = aud.status()
        taudit.disable()
        return st, landed

    st, landed = asyncio.run(run())
    assert len(landed) == 1
    ids, ns, allowed = landed[0]
    assert not allowed.all()      # key 3 passes its limit of 5
    t = _recompute([("ids", ids, ns, T0, allowed)], cfg)
    assert st["samples"] == t.requests == 10
    assert st["fail_open_samples"] == 0
    assert st["false_denies"] == t.false_denies_vs_oracle == 0
    assert st["false_allows"] == t.false_allows_vs_oracle == 0
    assert st["oracle_allows"] == t.oracle_allows
