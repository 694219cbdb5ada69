"""The port's decorator stack against the JAX package's.

The same seeded operation sequence runs through the JAX stack
``MetricsDecorator(LoggingDecorator(CircuitBreakerDecorator(
TracingDecorator(inner))))`` over the JAX sketch limiter and through the
port's over its sketch limiter on the CPU: single and batched decisions,
an invalid ``n`` and key, a reset, the pipelined launch/resolve path, the
raw-id lane, an injected backend failure (fail-open and fail-closed
configs) that trips the breaker, its half-open probes and its recovery,
all on a ManualClock. Tolerance 0: the decisions field by field, the
breaker's state after every operation, the log records (level and
message, with the measured latency masked; keys redacted as
``key#<hex>``) and the rendered registry (the latency histograms' bucket
values and sums masked, their observation counts kept) must be equal.
Also: ``key_token`` on 1000 seeded keys, ``TracingDecorator.capture`` on
the CPU, and ROADMAP C10 — an ALLOW_HASHED frame to a door over a
decorated exact or dense limiter is refused with E_INVALID_CONFIG, the
JAX door's reply byte for byte.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.observability import decorators as jdeco
from ratelimiter_tpu.observability import metrics as jmetrics
from ratelimiter_tpu.ops.hashing import key_token as jax_key_token
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu.serving.server import RateLimitServer as JaxServer
from ratelimiter_tpu_torch.observability import decorators as tdeco
from ratelimiter_tpu_torch.observability import metrics as tmetrics
from ratelimiter_tpu_torch.ops.hashing import key_token
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.batcher import MicroBatcher
from ratelimiter_tpu_torch.serving.server import RateLimitServer

T0 = 1_700_000_000.0
FIELDS = ("allowed", "limit", "remaining", "retry_after", "reset_at",
          "fail_open")


def _cfg(pkg, fail_open: bool):
    return pkg.Config(algorithm=pkg.Algorithm.SLIDING_WINDOW, limit=5,
                      window=10.0, fail_open=fail_open,
                      sketch=pkg.SketchParams(depth=2, width=256,
                                              sub_windows=4))


def _make(pkg, fail_open: bool):
    clock = pkg.ManualClock(T0)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.create_limiter(_cfg(pkg, fail_open), backend="sketch",
                              clock=clock, **kw), clock


def _norm(res):
    """A decision as plain Python values, field by field."""
    if hasattr(res, "results"):
        cols = tuple(np.asarray(getattr(res, f)).tolist()
                     for f in ("allowed", "remaining", "retry_after",
                               "reset_at"))
        limits = (None if getattr(res, "limits", None) is None
                  else np.asarray(res.limits).tolist())
        return ("batch", res.limit, bool(res.fail_open), cols, limits)
    return ("one",) + tuple(getattr(res, f) for f in FIELDS)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append((record.levelname, re.sub(
            r"latency=[0-9.]+", "latency=*", record.getMessage())))


def _mask_latency(text: str) -> str:
    """The registry text with the latency histograms' bucket values and
    sums masked (wall times); their ``_count`` lines are kept."""
    out = []
    for line in text.splitlines():
        if line.startswith(("rate_limiter_latency_seconds_bucket",
                            "rate_limiter_latency_seconds_sum")):
            line = line.rsplit(" ", 1)[0] + " *"
        out.append(line)
    return "\n".join(out)


def _drive(pkg, deco, metrics, logger_name: str, fail_open: bool,
           seed: int, redact: bool):
    """The operation sequence through the four-decorator stack; returns
    (decisions, breaker states, log records, masked registry text)."""
    inner, clock = _make(pkg, fail_open)
    reg = metrics.Registry()
    breaker = deco.CircuitBreakerDecorator(
        deco.TracingDecorator(inner), failure_threshold=2, cooldown=5.0,
        registry=reg)
    stack = deco.MetricsDecorator(
        deco.LoggingDecorator(breaker, redact_keys=redact), registry=reg)
    logger = logging.getLogger(logger_name)
    handler = _Records()
    level = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    rng = np.random.default_rng(seed)
    keys = [f"user:{int(i)}" for i in rng.integers(0, 8, size=30)]
    keys[3] = "ünï:ключ-🔑"
    ids = rng.integers(0, 16, size=20).astype(np.uint64)
    out, states = [], []

    def step(name, fn):
        try:
            out.append((name, _norm(fn())))
        except Exception as exc:  # noqa: BLE001 — compared by type/text
            out.append((name, type(exc).__name__, str(exc)))
        states.append(breaker.state)

    try:
        for k in keys[:6]:
            step("allow_n", lambda k=k: stack.allow_n(k, 1))
        step("allow_batch", lambda: stack.allow_batch(keys[6:18]))
        step("invalid n", lambda: stack.allow_n("user:1", 0))
        step("invalid key", lambda: stack.allow_n("", 1))
        step("reset", lambda: stack.reset(keys[0]) or ("none",))
        step("launch/resolve", lambda: stack.resolve(
            stack.launch_batch(keys[18:], [1, 2] * 6)))
        step("allow_ids", lambda: stack.allow_ids(ids))
        step("launch_ids", lambda: stack.resolve(stack.launch_ids(ids)))
        clock.advance(1.0)
        inner.inject_failure()
        step("failing allow_n", lambda: stack.allow_n(keys[1], 1))
        step("failing allow_batch", lambda: stack.allow_batch(keys[:4]))
        step("open allow_n", lambda: stack.allow_n(keys[2], 1))
        step("open launch", lambda: stack.resolve(
            stack.launch_batch(keys[:3])))
        step("open allow_ids", lambda: stack.allow_ids(ids[:5]))
        clock.advance(5.0)
        step("failed probe", lambda: stack.allow_n(keys[4], 1))
        step("open again", lambda: stack.allow_n(keys[4], 1))
        inner.heal()
        clock.advance(5.0)
        step("probe", lambda: stack.allow_n(keys[5], 1))
        step("closed allow_batch", lambda: stack.allow_batch(keys[6:12]))
        step("closed launch", lambda: stack.resolve(
            stack.launch_ids(ids[:8])))
        step("reset", lambda: stack.reset(keys[3]) or ("none",))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    text = _mask_latency(reg.render())
    stack.close()
    return out, states, handler.records, text


@pytest.mark.parametrize("fail_open", [True, False],
                         ids=["fail-open", "fail-closed"])
@pytest.mark.parametrize("redact", [False, True], ids=["keys", "redacted"])
def test_stack_matches_the_jax_stack(fail_open, redact):
    want = _drive(R, jdeco, jmetrics, "ratelimiter_tpu", fail_open, 5,
                  redact)
    got = _drive(T, tdeco, tmetrics, "ratelimiter_tpu_torch", fail_open, 5,
                 redact)
    names = ("decisions", "breaker states", "log records", "registry")
    for name, g, w in zip(names, got, want):
        assert g == w, name
    decisions, states, records, text = got
    # The sequence reached every state and level it is meant to.
    assert {"closed", "open"} <= set(states)
    assert {lvl for lvl, _ in records} >= {"DEBUG", "INFO", "ERROR"}
    if fail_open:
        assert any(lvl == "WARNING" for lvl, _ in records)
    assert ('rate_limiter_breaker_short_circuits_total' in text
            and 'result="error:invalid_n"' in text)
    if redact:
        assert not any("user:" in msg for _, msg in records)
        assert any(key_token("ünï:ключ-🔑") in msg for _, msg in records)


def test_key_token_matches_jax():
    rng = np.random.default_rng(11)
    alphabet = list("abcxyz019:_-/") + ["é", "ß", "ключ", "鍵", "🔑", " "]
    keys = ["".join(rng.choice(alphabet, size=int(rng.integers(1, 24))))
            for _ in range(1000)]
    assert [key_token(k) for k in keys] == [jax_key_token(k) for k in keys]
    assert all(re.fullmatch(r"key#[0-9a-f]{16}", key_token(k))
               for k in keys[:50])


def test_tracing_capture_writes_a_chrome_trace_on_the_cpu(tmp_path):
    inner, _ = _make(T, False)
    tr = tdeco.TracingDecorator(inner)
    path = str(tmp_path / "trace.json")
    with tr.capture(path):
        tr.resolve(tr.launch_batch(["a", "b", "a"]))
        tr.allow_ids(np.arange(4, dtype=np.uint64))
        tr.reset("a")
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    for op in ("launch", "resolve", "allow_ids", "reset"):
        assert f"ratelimiter/sliding_window/{op}" in names, op
    tr.close()


def _exact(pkg, backend="exact"):
    kw = {} if pkg is R else ({"device": "cpu"} if backend == "dense"
                              else {})
    return pkg.create_limiter(
        pkg.Config(algorithm=pkg.Algorithm.SLIDING_WINDOW, limit=5,
                   window=60.0), backend=backend, **kw)


async def _hashed_reply(server_cls, limiter) -> bytes:
    srv = server_cls(limiter, "127.0.0.1", 0)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
    try:
        writer.write(jp.encode_allow_hashed(7, np.arange(4,
                                                         dtype=np.uint64)))
        await writer.drain()
        hdr = await reader.readexactly(jp.HEADER_SIZE)
        length = jp.parse_header(hdr)[0]
        return hdr + await reader.readexactly(length - 9)
    finally:
        writer.close()
        await writer.wait_closed()
        await srv.shutdown()


@pytest.mark.parametrize("backend", ["exact", "dense"])
@pytest.mark.parametrize("wrap", ["LimiterDecorator", "MetricsDecorator"])
def test_c10_hashed_frame_to_a_decorated_backend_is_refused(backend, wrap):
    """ROADMAP C10: the door detects the raw-id lane on the undecorated
    backend, so an ALLOW_HASHED frame to a door over a decorated exact or
    dense limiter gets E_INVALID_CONFIG — the JAX door's reply (over the
    JAX exact backend) byte for byte — and not E_INTERNAL."""
    def deco(mod, lim):
        if wrap == "LimiterDecorator":
            return mod.LimiterDecorator(lim)
        reg = (jmetrics if mod is jdeco else tmetrics).Registry()
        return mod.MetricsDecorator(lim, registry=reg)

    want = asyncio.run(_hashed_reply(JaxServer, deco(jdeco, _exact(R))))
    lim = _exact(T, backend)
    got = asyncio.run(_hashed_reply(RateLimitServer, deco(tdeco, lim)))
    assert got == want
    assert tp.parse_error(got[tp.HEADER_SIZE:])[0] == tp.E_INVALID_CONFIG
    lim.close()


def test_c10_batcher_refuses_the_lane_through_a_decorator():
    """ROADMAP C10's seeded input: MicroBatcher.submit_hashed_nowait over
    LimiterDecorator(exact) raises InvalidConfigError, as it does over
    the bare exact limiter (an AttributeError before the repair)."""
    async def submit(lim):
        b = MicroBatcher(lim)
        try:
            b.submit_hashed_nowait(np.arange(4, dtype=np.uint64),
                                   np.ones(4, dtype=np.uint32))
        finally:
            b.close()

    for lim in (_exact(T), tdeco.LimiterDecorator(_exact(T))):
        with pytest.raises(T.InvalidConfigError, match="sketch-family"):
            asyncio.run(submit(lim))
        assert not hasattr(tdeco.undecorated(lim), "allow_ids")


def test_binary_stacks_the_jax_binarys_decorators_in_its_order():
    """``build_limiter_stack``: MetricsDecorator alone by default, nothing
    under --no-metrics, and with every flag Logging(Metrics(Breaker(
    Tracing(limiter)))) — the JAX binary's order — with the breaker's
    threshold and cooldown from the flags."""
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_limiter_stack,
        parse_args,
    )

    lim, _ = _make(T, False)

    def layers(argv):
        out, cur = [], build_limiter_stack(lim, parse_args(argv),
                                           registry=tmetrics.Registry())
        while isinstance(cur, tdeco.LimiterDecorator):
            out.append(type(cur).__name__)
            cur = cur.inner
        assert cur is lim
        return out

    assert layers([]) == ["MetricsDecorator"]
    assert layers(["--no-metrics"]) == []
    full = ["--trace", "--circuit-breaker", "--breaker-threshold", "3",
            "--breaker-cooldown", "2", "--log-decisions"]
    assert layers(full) == ["LoggingDecorator", "MetricsDecorator",
                            "CircuitBreakerDecorator", "TracingDecorator"]
    stack = build_limiter_stack(lim, parse_args(full),
                                registry=tmetrics.Registry())
    breaker = stack.inner.inner
    assert (breaker.failure_threshold, breaker.cooldown) == (3, 2.0)
    lim.close()


def test_breaker_trips_short_circuits_probes_and_closes():
    """chip_smoke.py's (e) at a small size on the CPU: the breaker's
    states, errors, short-circuit count and transitions through the
    binary's --circuit-breaker stack."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    out = chip_smoke.check_breaker(_cfg(T, False), device="cpu", batch=64)
    assert out["transitions"] == {"open": 2.0, "half-open": 2.0,
                                  "closed": 1.0}
