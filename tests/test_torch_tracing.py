"""The port's flight recorder, frame extensions and deadline shedding
against the JAX package's.

Tolerance 0 (bytes, integers and text):

* ``with_trace``, ``with_deadline``, ``split_trace`` and
  ``split_request`` give the JAX protocol's bytes and tuples, and raise
  where it raises;
* ``FlightRecorder.dump``, ``stage_summary`` and ``chrome_trace`` equal
  the JAX recorder's on the same recorded rows, and the OpenMetrics
  rendering (exemplars, ``# EOF``) the JAX registry's;
* through the port's door, a traced ALLOW_HASHED and a traced ALLOW_N
  frame each leave the whole span tree under its trace id
  (``chip_smoke.check_traced_frames``), the full stack shows every
  stage's count on METRICS, and decisions are the same with the
  recorder on and off;
* an expired deadline is shed with the JAX door's reply bytes (the
  exact backend, fail-open and fail-closed; ALLOW_HASHED on the sketch,
  where no dispatch runs), and the shed counter counts the decisions.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time

import numpy as np
import pytest

import ratelimiter_tpu as R
import ratelimiter_tpu_torch as T
from ratelimiter_tpu.observability import metrics as jmetrics
from ratelimiter_tpu.observability import tracing as jtracing
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu.serving.server import RateLimitServer as JaxServer
from ratelimiter_tpu_torch.observability import metrics as tmetrics
from ratelimiter_tpu_torch.observability import tracing as ttracing
from ratelimiter_tpu_torch.ops import sketch_cuda
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.serving.server import RateLimitServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its observe-phase checks, on the CPU)

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _recorders_off():
    jtracing.disable()
    ttracing.disable()
    yield
    jtracing.disable()
    ttracing.disable()


# -------------------------------------------------------- frame extensions


def _frames(P):
    return [P.encode_allow_n(5, "user:1", 3), P.encode_reset(6, "k"),
            P.encode_simple(P.T_HEALTH, 7),
            P.encode_allow_batch(8, ["a", "ü"], [1, 2]),
            P.encode_allow_hashed(9, np.arange(5, dtype=np.uint64))]


def _split(P, frame):
    length, type_, rid = P.parse_header(frame[:P.HEADER_SIZE])
    body = frame[P.HEADER_SIZE:]
    try:
        return ("ok", P.split_request(type_, body),
                P.split_trace(type_, body))
    except P.ProtocolError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("budget", [10.0, 0.0, -1.5, 1e-6])
@pytest.mark.parametrize("tid", [0, 1, (1 << 64) - 1, 0xDEADBEEF])
def test_frame_extensions_match_jax(tid, budget):
    for a, b in zip(_frames(tp), _frames(jp)):
        assert a == b
        for wrap in (lambda P, f: P.with_trace(f, tid),
                     lambda P, f: P.with_deadline(f, budget),
                     lambda P, f: P.with_trace(P.with_deadline(f, budget),
                                               tid)):
            got, want = wrap(tp, a), wrap(jp, b)
            assert got == want
            assert _split(tp, got) == _split(jp, want)
        assert _split(tp, a) == _split(jp, b)


def test_frame_extension_errors_match_jax():
    """Each misuse raises in both packages with the same text: a flag on
    a frame that has it, on a response type, and short extensions."""
    def outcome(P, fn):
        try:
            return ("ok", fn(P))
        except P.ProtocolError as exc:
            return ("error", str(exc))

    cases = [
        lambda P: P.with_trace(P.with_trace(
            P.encode_simple(P.T_HEALTH, 1), 3), 4),
        lambda P: P.with_deadline(P.with_trace(
            P.encode_simple(P.T_HEALTH, 1), 3), 1.0),
        lambda P: P.with_deadline(P.with_deadline(
            P.encode_simple(P.T_HEALTH, 1), 1.0), 1.0),
        lambda P: P.with_trace(P.encode_ok(1), 3),
        lambda P: P.with_deadline(P.encode_ok(1), 1.0),
        lambda P: P.split_request(P.T_HEALTH | P.TRACE_FLAG, b"\0" * 7),
        lambda P: P.split_request(P.T_HEALTH | P.DEADLINE_FLAG, b"\0" * 7),
        lambda P: P.split_request(P.T_HEALTH | P.TRACE_FLAG
                                  | P.DEADLINE_FLAG, b"\0" * 12),
        lambda P: P.split_trace(P.T_HEALTH | P.TRACE_FLAG, b""),
        lambda P: P.split_request(P.T_RESULT, b"\0" * 3),
    ]
    for case in cases:
        got, want = outcome(tp, case), outcome(jp, case)
        assert got == want
    assert sum(outcome(tp, c)[0] == "error" for c in cases) == 9
    assert (tp.TRACE_FLAG, tp.DEADLINE_FLAG, tp.FORWARD_FLAG) == (
        jp.TRACE_FLAG, jp.DEADLINE_FLAG, jp.FORWARD_FLAG)


# -------------------------------------------------------- the recorder


def _record_rows(tr, rows):
    """80 rows into a 64-row ring, from this thread."""
    rec = tr.FlightRecorder(64)
    for stage, t0, t1, kw in rows[:80]:
        rec.record(stage, t0, t1, **kw)
    return rec


def _rows(seed):
    rng = np.random.default_rng(seed)
    stages = ["io", "coalesce", "launch", "device", "resolve", "encode",
              "queue", "route"]
    rows = []
    t = 10 ** 9
    for i in range(100):
        t += int(rng.integers(1, 5000))
        rows.append((stages[int(rng.integers(0, len(stages)))], t,
                     t + int(rng.integers(0, 90_000)),
                     {"trace_id": int(rng.integers(0, 1 << 62)) * (i % 3),
                      "shard": int(rng.integers(-1, 4)),
                      "batch": int(rng.integers(1, 5000)),
                      "outcome": int(rng.integers(0, 3))}))
    return rows


def test_recorder_dump_summary_and_chrome_trace_match_jax(monkeypatch):
    rows = _rows(2)
    monkeypatch.setattr(time, "time", lambda: T0)
    monkeypatch.setattr(time, "monotonic_ns", lambda: 5 * 10 ** 9)
    got, want = _record_rows(ttracing, rows), _record_rows(jtracing, rows)
    assert got.capacity == want.capacity == 64
    assert got.dump() == want.dump()
    assert len(got.dump()) == 64          # the ring kept the newest 64
    assert got.stage_summary() == want.stage_summary()
    a, b = got.chrome_trace(), want.chrome_trace()
    assert a == b
    for tr in (ttracing, jtracing):
        assert tr.parse_traceparent(
            "00-0123456789abcdef0123456789abcdef-0011223344556677-01") == \
            0x0123456789ABCDEF
        assert tr.format_traceparent(77) == jtracing.format_traceparent(77)


def test_openmetrics_exemplars_and_stage_histograms_match_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0 + 0.125)
    rows = _rows(4)
    texts = []
    for metrics, tr in ((tmetrics, ttracing), (jmetrics, jtracing)):
        reg = metrics.Registry()
        h = reg.histogram("rate_limiter_x_seconds", "x")
        for i, v in enumerate((1e-6, 3e-4, 0.02, 7.0, 0.02)):
            h.observe(v, exemplar=f"{i:016x}" if i != 1 else None, op="a")
        c = reg.counter("rate_limiter_y_total", "y")
        c.inc(3, kind='q"1')
        reg.counter("rate_limiter_z", "z").inc()
        g = reg.gauge("rate_limiter_g", "g")
        g.set(2.5, shard="0")
        g.inc(1.0, shard="0")
        rec = tr.FlightRecorder(64)
        rec.attach_registry(reg)
        for stage, t0, t1, kw in rows[:30]:
            rec.record(stage, t0, t1, **kw)
        first = reg.render_openmetrics()
        for stage, t0, t1, kw in rows[30:50]:
            rec.record(stage, t0, t1, **kw)
        texts.append((first, reg.render(), reg.render(openmetrics=True),
                      h.count(op="a"), h.sum(op="a"),
                      h.counts_over(0.01), c.total(), c.labeled_values(),
                      g.value(shard="0")))
        rec.detach()
    assert texts[0] == texts[1]
    assert '# {trace_id="' in texts[0][0] and texts[0][0].endswith("# EOF\n")


# -------------------------------------------------------- through the door


def _cfg(**kw):
    return T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=20,
                    window=2.0, sketch=T.SketchParams(depth=4, width=1024,
                                                      sub_windows=4), **kw)


def test_traced_frames_leave_the_span_tree_through_the_door():
    out = chip_smoke.check_traced_frames(_cfg(), device="cpu", hashed=4,
                                         allow_n=3, n_ids=64)
    assert out["frames"] == 7 and out["spans"] >= 7 * 7


def test_full_stack_door_shows_every_stage_on_metrics():
    """chip_smoke.py's (a) at a small size on the CPU: the full stack
    (every decorator, the recorder) over the recording proxy, every frame
    bit-identical to the replay, the METRICS decision and request counts
    equal to the decisions served, every stage counted."""
    out = chip_smoke.check_door(
        None, _cfg(), "full", device="cpu", conns=2, frames=16, n_ids=64,
        n_keys=16, server_kw=dict(max_batch=256),
        flags=chip_smoke.FULL_STACK, counters=[sketch_cuda])
    assert out["allowed"] + out["denied"] == out["decisions"]
    assert set(out["stage_counts"]) == set(chip_smoke.FRAME_STAGES)
    assert all(out["stage_counts"].values())


def test_decisions_identical_with_the_recorder_on_and_off():
    def run(on: bool):
        ttracing.disable()
        if on:
            ttracing.enable(1024)
        lim = T.create_limiter(_cfg(), backend="sketch",
                               clock=T.ManualClock(T0), device="cpu")

        async def drive():
            srv = RateLimitServer(lim, "127.0.0.1", 0, max_batch=32,
                                  max_delay=100e-6,
                                  registry=tmetrics.Registry())
            await srv.start()
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            got = []
            try:
                for i in range(8):
                    for frame in (tp.encode_allow_hashed(
                            2 * i, np.arange(1, 65, dtype=np.uint64)),
                            tp.encode_allow_batch(
                                2 * i + 1, [f"u:{j}" for j in range(16)],
                                [1] * 16)):
                        if on:
                            frame = tp.with_trace(frame, i + 1)
                        t, _, body = await chip_smoke._roundtrip(
                            reader, writer, frame)
                        got.append((t, body))
            finally:
                writer.close()
                await writer.wait_closed()
                await srv.shutdown()
            return got

        try:
            return asyncio.run(drive())
        finally:
            lim.close()
            ttracing.disable()

    assert run(False) == run(True)


async def _shed_replies(server_cls, limiter, P, frames, registry):
    srv = server_cls(limiter, "127.0.0.1", 0, registry=registry)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
    out = []
    try:
        for frame in frames:
            writer.write(frame)
            await writer.drain()
            hdr = await reader.readexactly(P.HEADER_SIZE)
            out.append(hdr + await reader.readexactly(
                P.parse_header(hdr)[0] - 9))
        writer.write(P.encode_simple(P.T_METRICS, 99))
        await writer.drain()
        hdr = await reader.readexactly(P.HEADER_SIZE)
        text = P.parse_metrics(await reader.readexactly(
            P.parse_header(hdr)[0] - 9))
    finally:
        writer.close()
        await writer.wait_closed()
        await srv.shutdown()
    shed = [ln for ln in text.splitlines()
            if ln.startswith("rate_limiter_server_deadline_shed_total")]
    return out, shed


@pytest.mark.parametrize("fail_open", [True, False],
                         ids=["fail-open", "fail-closed"])
@pytest.mark.parametrize("backend", ["exact", "sketch"])
def test_deadline_shedding_replies_match_the_jax_door(fail_open, backend):
    """Expired budgets (on arrival, and past), shed per policy with the
    JAX door's bytes; frames with a live budget answered as usual. On the
    sketch only the expired ALLOW_HASHED frames are sent: they never
    dispatch, so the JAX side needs no compile."""
    def frames(P):
        if backend == "sketch":
            return [P.with_deadline(P.encode_allow_hashed(
                1, np.arange(9, dtype=np.uint64)), b) for b in (0.0, -2.0)]
        return [P.with_deadline(P.encode_allow_n(1, "user:1", 2), -1.0),
                P.with_trace(P.with_deadline(P.encode_allow_batch(
                    2, ["a", "b", "a"], [1, 1, 3]), 0.0), 77),
                P.with_deadline(P.encode_allow_n(3, "user:1", 2), 30.0),
                P.with_deadline(P.encode_allow_batch(4, ["a", "b"], [1, 1]),
                                30.0)]

    out = []
    for pkg, server, P, metrics in ((R, JaxServer, jp, jmetrics),
                                    (T, RateLimitServer, tp, tmetrics)):
        cfg = pkg.Config(algorithm=pkg.Algorithm.SLIDING_WINDOW, limit=5,
                         window=60.0, fail_open=fail_open,
                         **({"sketch": pkg.SketchParams(
                             depth=2, width=256, sub_windows=4)}
                            if backend == "sketch" else {}))
        kw = {"device": "cpu"} if pkg is T and backend == "sketch" else {}
        lim = pkg.create_limiter(cfg, backend=backend,
                                 clock=pkg.ManualClock(T0), **kw)
        out.append(asyncio.run(_shed_replies(server, lim, P, frames(P),
                                             metrics.Registry())))
        lim.close()
    assert out[0] == out[1]
    n_shed = 18 if backend == "sketch" else 4
    replies, shed = out[1]
    assert shed == [f"rate_limiter_server_deadline_shed_total {n_shed}"]
    codes = [tp.parse_header(r[:tp.HEADER_SIZE])[1] for r in replies]
    if fail_open:
        assert tp.T_ERROR not in codes
    else:
        assert codes.count(tp.T_ERROR) == 2
        assert all(tp.parse_error(r[tp.HEADER_SIZE:])[0] == tp.E_DEADLINE
                   for r, c in zip(replies, codes) if c == tp.T_ERROR)


def test_deadline_shedding_counts_and_launches_nothing():
    """chip_smoke.py's (c) on the CPU: expired frames shed with no launch
    of the window step and counted by
    ``rate_limiter_server_deadline_shed_total``; live ones equal to a
    CPU limiter."""
    out = chip_smoke.check_deadlines(_cfg(), device="cpu",
                                     counters=[sketch_cuda], frames=8,
                                     n_ids=64)
    for run in out.values():
        assert run["frames_shed"] == 8 and run["decisions_shed"] > 8


def test_capture_splits_each_range_into_torch_ops_and_python():
    """chip_smoke.py's (f) on the CPU: ``TracingDecorator.capture``
    around config-3 batches holds one ``launch`` and one ``resolve``
    range a batch, and ``torch_ops_in`` splits each range's host time
    into the torch ops it calls and the Python between them."""
    out = chip_smoke.check_capture(device="cpu", batches=2)
    for op in ("launch", "resolve"):
        h = out["host"][op]
        assert h["torch_ops"] > 0 and h["python_ms"] >= 0
        assert abs(h["torch_ms"] + h["python_ms"] - h["ms"]) < 1e-6
