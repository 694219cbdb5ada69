"""The port's MicroBatcher (over the port's limiter on the CPU) against the
JAX package's MicroBatcher (over the JAX SketchLimiter, jnp path).

Both batchers get equal ManualClocks and a long ``max_delay``, so windows
flush only on fill, on the merge cap and where the script flushes; both
are fed the same seeded frames: hashed frames whose sizes cross every
flush and cut rule (fill, the ``2*max_batch`` merge cap, a frame above
it, row offsets that are not multiples of 8), string frames (one cut by
the fill mid-frame), and flushes that hold both lanes. Every frame's
result and reply bytes, the final state and the batch-size histogram must
be bit-identical (tolerance 0), for the windowed limiter (CU and vanilla)
and the bucket. Also: failure injection under fail-open and fail-closed,
the dispatch SLO with a slow limiter, and drain/close with a full
in-flight window and a failing resolve, each answered as the JAX batcher
answers; and the port's metrics text against the JAX registry's.
"""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.algorithms.sketch import SketchLimiter as JaxSketch
from ratelimiter_tpu.algorithms.sketch import (
    SketchTokenBucketLimiter as JaxBucket,
)
from ratelimiter_tpu.observability import metrics as jm
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu.serving.batcher import MicroBatcher as JaxBatcher
from ratelimiter_tpu_torch.algorithms.sketch import (
    SketchLimiter,
    SketchTokenBucketLimiter,
)
from ratelimiter_tpu_torch.observability import metrics as tm
from ratelimiter_tpu_torch.ops.hashing import hash_prefixed_u64, splitmix64
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.batcher import MicroBatcher

T0 = 1_000_000.0
MB = 32                 # max_batch: hashed windows merge up to 64 rows
LONG = 3600.0           # max_delay: the timer never fires in a test
STATE_KEYS = {"window": ("cur", "slabs", "totals", "slab_period",
                         "last_period"),
              "bucket": ("debt", "acc", "rem", "last")}


def _cfg(M, kind, *, kernels=None, fail_open=False):
    sk = dict(depth=2, width=256, sub_windows=6)
    if kernels is not None:
        sk["kernels"] = kernels
    algo = "TOKEN_BUCKET" if kind == "bucket" else "SLIDING_WINDOW"
    return M.Config(algorithm=getattr(M.Algorithm, algo), limit=7,
                    window=6.0, fail_open=fail_open,
                    sketch=M.SketchParams(conservative_update=kind != "vanilla",
                                          **sk))


def _pair(kind, **kw):
    jcls, tcls = ((JaxBucket, SketchTokenBucketLimiter) if kind == "bucket"
                  else (JaxSketch, SketchLimiter))
    return (jcls(_cfg(R, kind, kernels="jnp", **kw), R.ManualClock(T0)),
            tcls(_cfg(T, kind, **kw), T.ManualClock(T0), device="cpu"))


# ------------------------------------------------------------- scenario

_INV_C1 = pow(0xBF58476D1CE4E5B9, -1, 1 << 64)
_INV_C2 = pow(0x94D049BB133111EB, -1, 1 << 64)
_M64 = (1 << 64) - 1


def _unmix(x: int) -> int:
    """The inverse of splitmix64 on one u64 (each xorshift undone to its
    fixpoint, each multiplier by its inverse mod 2^64)."""
    def unshift(y, s):
        z = y
        for _ in range(64 // s + 1):
            z = y ^ (z >> s)
        return z
    x = unshift(x, 31) * _INV_C2 & _M64
    x = unshift(x, 27) * _INV_C1 & _M64
    return (unshift(x, 30) - 0x9E3779B97F4A7C15) & _M64


def test_unmix_inverts_splitmix64():
    h = hash_prefixed_u64(["k0", "k9"], T.DEFAULT_PREFIX)
    ids = np.array([_unmix(int(x)) for x in h], dtype=np.uint64)
    np.testing.assert_array_equal(splitmix64(ids), h)



def _scenario(seed: int):
    """Rounds of frames; each round runs at one clock time and ends with a
    flush. Sizes against max_batch 32 (windows up to 64 rows): 13+5+17
    fills a window, its frames at row offsets 0, 13 and 18; 30 then 40
    hits the merge cap (30 flushes alone, 40 opens the next window and
    fills it); 70 is cut into 32+32+6 segments; 9- and 40-pair string
    frames fill a window 23 pairs into the second; the rest of it and an
    11-id hashed frame share the round's last flush. That frame's raw ids
    are the string keys' hashes unmixed, so both lanes contend for the
    same counters and the order of the two windows shows in the
    answers."""
    rng = np.random.default_rng(seed)

    def ids(b):
        return rng.integers(0, 24, size=b).astype(np.uint64)

    def ns(b):
        return rng.integers(1, 3, size=b).astype(np.uint32)

    def keys(b):
        return [f"k{int(i)}" for i in rng.integers(0, 10, size=b)]

    def key_ids(b):
        h = hash_prefixed_u64(keys(b), T.DEFAULT_PREFIX)
        return np.array([_unmix(int(x)) for x in h], dtype=np.uint64)

    rounds = []
    for r in range(3):
        frames = [("h", ids(b), ns(b)) for b in (13, 5, 17, 30, 40)]
        frames.append(("h", ids(70), ns(70)))
        frames += [("s", keys(b), [int(x) for x in rng.integers(1, 3, b)])
                   for b in (9, 40)]
        frames.append(("h", key_ids(11), ns(11)))
        rounds.append(frames)
    return rounds


async def _run(batcher, clock, rounds, advance=0.7):
    """Feed ``rounds`` to ``batcher``; returns per frame its BatchResult
    (hashed) or list of Results (string), or the exception it raised."""
    out = []
    for frames in rounds:
        futs = []
        for kind, a, b in frames:
            if kind == "h":
                futs.append(batcher.submit_hashed_nowait(a, b))
            else:
                futs.append(asyncio.gather(
                    *batcher.submit_many_nowait(zip(a, b))))
        batcher._flush()
        out += await asyncio.gather(*futs, return_exceptions=True)
        clock.advance(advance)
    await batcher.drain()
    batcher.close()
    return out


def _drive_pair(lj, lt, rounds, **kw):
    rj, rt = jm.Registry(), tm.Registry()
    got_j = asyncio.run(_run(JaxBatcher(lj, registry=rj, **kw), lj.clock,
                             rounds))
    got_t = asyncio.run(_run(MicroBatcher(lt, registry=rt, **kw), lt.clock,
                             rounds))
    return got_j, got_t, rj, rt


def _same_frame(j, t, req_id):
    if isinstance(j, BaseException):
        assert type(t).__name__ == type(j).__name__ and str(t) == str(j)
        return
    if isinstance(j, list):
        assert [tuple(vars(r).values()) for r in t] == [
            tuple(vars(r).values()) for r in j]
        assert (b"".join(tp.encode_result_batch_views(req_id, 7, t))
                == b"".join(jp.encode_result_batch_views(req_id, 7, j)))
        return
    for f in ("allowed", "remaining", "retry_after", "reset_at"):
        x, y = np.asarray(getattr(j, f)), np.asarray(getattr(t, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert j.fail_open == t.fail_open and j.limit == t.limit
    assert (j.wire_packed is None) == (t.wire_packed is None)
    assert (b"".join(bytes(v) for v in tp.encode_result_hashed_views(
        req_id, t)) == b"".join(bytes(v) for v in
                                jp.encode_result_hashed_views(req_id, j)))


def _family(registry, name):
    """The TYPE line and samples of one metric family (the help texts
    name the JAX package's own documents, so they are not compared)."""
    return [ln for ln in registry.render().splitlines()
            if ln.split("{")[0].split(" ")[0] in (name, name + "_bucket",
                                                 name + "_sum",
                                                 name + "_count")
            or ln.startswith(f"# TYPE {name} ")]


def _sample(registry, name):
    """The value of the unlabelled sample ``name`` in the rendered text."""
    for ln in registry.render().splitlines():
        if ln.startswith(name + " "):
            return float(ln.split(" ")[1])
    raise AssertionError(f"no sample {name}")


@pytest.mark.parametrize("kind", ["window", "vanilla", "bucket"])
def test_batcher_frames_state_and_histogram_match_jax(kind):
    lj, lt = _pair(kind)
    rounds = _scenario(1)
    got_j, got_t, rj, rt = _drive_pair(lj, lt, rounds, max_batch=MB,
                                       max_delay=LONG)
    assert len(got_j) == len(got_t) == sum(map(len, rounds))
    for i, (j, t) in enumerate(zip(got_j, got_t)):
        assert not isinstance(j, BaseException), j
        _same_frame(j, t, i)
    # A multi-frame window answers each frame from its row range of the
    # window's device-packed buffers.
    assert got_t[1].wire_packed[3] == 13
    sj, st = lj.capture_state()[1], lt.capture_state()[1]
    for k in STATE_KEYS["bucket" if kind == "bucket" else "window"]:
        np.testing.assert_array_equal(np.asarray(sj[k]), st[k], err_msg=k)
    name = "rate_limiter_server_batch_size"
    hist = _family(rt, name)
    assert hist == _family(rj, name)
    # Per round: [13,5,17], [30], [40], 32+32+6, 32 string pairs, then 17
    # string pairs and [11]: 9 dispatches.
    assert _sample(rt, name + "_count") == 27


@pytest.mark.parametrize("fail_open", [True, False])
def test_injected_failure_answers_like_jax(fail_open):
    lj, lt = _pair("window", fail_open=fail_open)
    rounds = _scenario(2)[:1]
    for lim in (lj, lt):
        lim.inject_failure()
    got_j, got_t, _, _ = _drive_pair(lj, lt, rounds, max_batch=MB,
                                     max_delay=LONG)
    for i, (j, t) in enumerate(zip(got_j, got_t)):
        assert isinstance(j, BaseException) != fail_open
        _same_frame(j, t, i)
    if fail_open:
        assert all(r.fail_open for r in got_t[6])
        assert got_t[0].fail_open and got_t[0].allowed.all()
    else:
        assert isinstance(got_t[0], T.StorageUnavailableError)
        assert "injected backend failure" in str(got_t[0])
    # Healed, both decide again, from the same state.
    for lim in (lj, lt):
        lim.heal()
    got_j, got_t, _, _ = _drive_pair(lj, lt, _scenario(3)[:1], max_batch=MB,
                                     max_delay=LONG)
    for i, (j, t) in enumerate(zip(got_j, got_t)):
        assert not isinstance(t, BaseException) and not _any_fail_open(t)
        _same_frame(j, t, i)


def _any_fail_open(res) -> bool:
    return (any(r.fail_open for r in res) if isinstance(res, list)
            else res.fail_open)


class _Proxy:
    """A limiter stand-in over a real one (either package): optionally
    slow in its blocking calls and resolve, optionally failing one
    resolve; counts the tickets outstanding."""

    def __init__(self, inner, *, sleep=0.0, fail_resolve=None):
        self.inner = inner
        self.config = inner.config
        self.clock = inner.clock
        self.pipelined = True
        self.sleep = sleep
        self.fail_resolve = fail_resolve
        self.resolves = 0
        self.outstanding = 0
        self.most_outstanding = 0
        self._lock = threading.Lock()

    def _launched(self, ticket):
        with self._lock:
            self.outstanding += 1
            self.most_outstanding = max(self.most_outstanding,
                                        self.outstanding)
        return ticket

    def launch_ids(self, ids, ns=None, **kw):
        return self._launched(self.inner.launch_ids(ids, ns, **kw))

    def launch_batch(self, keys, ns=None, **kw):
        return self._launched(self.inner.launch_batch(keys, ns, **kw))

    def resolve(self, ticket):
        time.sleep(self.sleep)
        with self._lock:
            self.outstanding -= 1
            self.resolves += 1
            n = self.resolves
        out = self.inner.resolve(ticket)
        if n == self.fail_resolve:
            raise RuntimeError("resolve failed")
        return out

    def allow_ids(self, ids, ns=None, **kw):
        time.sleep(self.sleep)
        return self.inner.allow_ids(ids, ns, **kw)

    def allow_batch(self, keys, ns=None, **kw):
        time.sleep(self.sleep)
        return self.inner.allow_batch(keys, ns, **kw)


@pytest.mark.parametrize("fail_open", [True, False])
def test_dispatch_timeout_with_slow_limiter_answers_like_jax(fail_open):
    lj, lt = _pair("window", fail_open=fail_open)
    pj, pt = _Proxy(lj, sleep=0.06), _Proxy(lt, sleep=0.06)
    rounds = [[("h", np.arange(5, dtype=np.uint64), np.ones(5, np.uint32)),
               ("s", ["a", "b"], [1, 2])]]
    got_j, got_t, rj, rt = _drive_pair(pj, pt, rounds, max_batch=MB,
                                       max_delay=LONG, dispatch_timeout=0.01)
    for i, (j, t) in enumerate(zip(got_j, got_t)):
        assert isinstance(j, BaseException) != fail_open
        _same_frame(j, t, i)
    if not fail_open:
        assert str(got_t[0]) == "dispatch exceeded SLO (10.0 ms)"
    for name in ("rate_limiter_server_slo_breaches_total",
                 "rate_limiter_server_slo_breach_decisions_total"):
        assert _family(rt, name) == _family(rj, name)
    assert _sample(rt, "rate_limiter_server_slo_breach_decisions_total") == 7
    # The shielded calls still landed: the state moved identically.
    sj, st = lj.capture_state()[1], lt.capture_state()[1]
    for k in STATE_KEYS["window"]:
        np.testing.assert_array_equal(np.asarray(sj[k]), st[k], err_msg=k)


def test_drain_and_close_with_full_inflight_window_and_failed_resolve():
    """inflight=2 with slow resolves: launches block on the window (never
    more than 2 outstanding), one resolve fails (its frames get the
    error, as in the JAX batcher), and drain/close return with every
    frame answered."""
    lj, lt = _pair("window")
    pj = _Proxy(lj, sleep=0.02, fail_resolve=3)
    pt = _Proxy(lt, sleep=0.02, fail_resolve=3)
    rounds = _scenario(4)[:1]
    t = time.perf_counter()
    got_j, got_t, _, rt = _drive_pair(pj, pt, rounds, max_batch=MB,
                                      max_delay=LONG, inflight=2)
    assert time.perf_counter() - t < 10.0
    assert pt.most_outstanding == 2 and pj.most_outstanding == 2
    assert pt.outstanding == 0
    failed = [i for i, r in enumerate(got_t) if isinstance(r, BaseException)]
    assert failed and all(str(got_t[i]) == "resolve failed" for i in failed)
    for i, (j, r) in enumerate(zip(got_j, got_t)):
        _same_frame(j, r, i)
    assert _sample(rt, "rate_limiter_pipeline_inflight") == 0


def test_submit_validation_and_shutdown_like_jax():
    """All-or-nothing string frames, bad n on the hashed lane, an empty
    hashed frame, and submits after drain, against the JAX batcher."""
    lj, lt = _pair("window")

    async def run(b):
        out = []
        for call in (lambda: b.submit_many_nowait([("a", 1), ("", 1)]),
                     lambda: b.submit_many_nowait([("a", 1), ("b", 0)]),
                     lambda: b.submit_hashed_nowait(
                         np.arange(3, dtype=np.uint64),
                         np.array([1, 0, 1], np.uint32))):
            with pytest.raises(Exception) as ei:
                call()
            out.append((type(ei.value).__name__, str(ei.value)))
        assert not b._pending and not b._pending_hashed
        empty = await b.submit_hashed_nowait(np.zeros(0, np.uint64),
                                             np.zeros(0, np.uint32))
        out.append((len(empty), empty.limit))
        await b.drain()
        with pytest.raises(Exception) as ei:
            b.submit_nowait("a")
        out.append((type(ei.value).__name__, str(ei.value)))
        b.close()
        return out

    assert (asyncio.run(run(MicroBatcher(lt, registry=tm.Registry())))
            == asyncio.run(run(JaxBatcher(lj, registry=jm.Registry()))))


def test_adaptive_timer_flushes_like_jax():
    """The timer path (max_delay 20 ms, adaptive): a lone request and a
    frame that pulls the flush earlier both flush without a fill; the
    batch histogram matches the JAX batcher's."""
    lj, lt = _pair("window")

    async def run(b, clock):
        r1 = await b.submit_nowait("solo")
        fut = b.submit_hashed_nowait(np.arange(20, dtype=np.uint64),
                                     np.ones(20, np.uint32))
        delay = b._timer.when() - asyncio.get_running_loop().time()
        r2 = await fut
        await b.drain()
        b.close()
        return r1, r2, delay

    rj, rt = jm.Registry(), tm.Registry()
    a = asyncio.run(run(JaxBatcher(lj, max_batch=MB, max_delay=0.02,
                                   registry=rj), lj.clock))
    b = asyncio.run(run(MicroBatcher(lt, max_batch=MB, max_delay=0.02,
                                     registry=rt), lt.clock))
    assert tuple(vars(a[0]).values()) == tuple(vars(b[0]).values())
    _same_frame(a[1], b[1], 0)
    # 20 of 32 pending: the wait shrinks to 20 ms * (1 - 20/32).
    assert 0 < b[2] <= 0.0075
    name = "rate_limiter_server_batch_size"
    assert _family(rt, name) == _family(rj, name)


def test_metrics_text_byte_identical_to_jax_registry():
    rng = np.random.default_rng(5)
    regs = (jm.Registry(), tm.Registry())
    for reg in regs:
        c = reg.counter("rate_limiter_x_total", "A counter")
        g = reg.gauge("rate_limiter_g", "A gauge")
        h = reg.histogram("rate_limiter_h_seconds", "A histogram",
                          jm.LATENCY_BUCKETS)
        hb = reg.histogram("rate_limiter_b", "Batches", jm.BATCH_BUCKETS)
        reg.add_collect_hook(lambda g=g: g.set(0.5, hook="on"))
    assert tm.LATENCY_BUCKETS == jm.LATENCY_BUCKETS
    assert tm.BATCH_BUCKETS == jm.BATCH_BUCKETS
    vals = rng.random(40) * 3
    for reg in regs:
        # Registering a name again returns the metric already there.
        c, g = reg.counter("rate_limiter_x_total"), reg.gauge("rate_limiter_g")
        h = reg.histogram("rate_limiter_h_seconds")
        hb = reg.histogram("rate_limiter_b")
        for i, v in enumerate(vals):
            c.inc(float(v), door="tcp" if i % 2 else 'we"ird\\\n')
            g.set(float(v) * 1e6)
            h.observe(float(v) / 100, result="ok" if i % 3 else "err")
            hb.observe(float(int(v * 5000)))
    assert regs[1].render() == regs[0].render()
    assert regs[1].render() == regs[0].render()  # hooks run again
