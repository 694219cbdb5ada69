"""The port's wire protocol and server against the JAX package's.

The encoders must produce the same bytes as ratelimiter_tpu.serving.
protocol for the same results (the writev-style view encoders too, on a
coalesced window's rows at offsets 0, 3, 8 and 13); the in-process
asyncio server must answer ALLOW_HASHED, ALLOW_BATCH, ALLOW_N, RESET,
HEALTH and METRICS frames with what an in-process limiter decides on the
same trace; pipelined connections through its micro-batcher, whose
replies come out of order, must get exactly what a replay of the
windows it launched decides (``chip_smoke.check_door`` at a small size,
on the CPU); and importing every module of the port must load neither
jax nor ratelimiter_tpu.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ratelimiter_tpu_torch as T
from ratelimiter_tpu.core.types import BatchResult as JaxBatchResult
from ratelimiter_tpu.core.types import Result as JaxResult
from ratelimiter_tpu.serving import protocol as jp
from ratelimiter_tpu_torch import Algorithm, Config, ManualClock, SketchParams
from ratelimiter_tpu_torch.algorithms.sketch import SketchLimiter
from ratelimiter_tpu_torch.core.types import BatchResult, Result
from ratelimiter_tpu_torch.serving import protocol as tp
from ratelimiter_tpu_torch.observability.metrics import Registry
from ratelimiter_tpu_torch.serving.server import run_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its door check, run here on the CPU)


def _results(rng, n):
    return [dict(allowed=bool(rng.random() < 0.5), limit=int(rng.integers(1, 500)),
                 remaining=int(rng.integers(0, 500)),
                 retry_after=float(rng.random() * 60),
                 reset_at=1.7e9 + float(rng.random()), fail_open=bool(i == 3))
            for i in range(n)]


@pytest.mark.parametrize("count", [0, 1, 7, 8, 13])
def test_encoders_byte_identical_to_jax_protocol(count):
    rng = np.random.default_rng(count)
    rows = _results(rng, max(count, 1))
    assert (tp.encode_result(5, Result(**rows[0]))
            == jp.encode_result(5, JaxResult(**rows[0])))
    assert (tp.encode_result_batch(6, 100, [Result(**r) for r in rows[:count]])
            == jp.encode_result_batch(6, 100,
                                      [JaxResult(**r) for r in rows[:count]]))
    cols = dict(allowed=rng.random(count) < 0.5, limit=100,
                remaining=rng.integers(0, 100, size=count).astype(np.int64),
                retry_after=rng.random(count), reset_at=rng.random(count) + 1e9)
    for fail_open in (False, True):
        assert (tp.encode_result_hashed(7, BatchResult(**cols,
                                                       fail_open=fail_open))
                == jp.encode_result_hashed(7, JaxBatchResult(
                    **cols, fail_open=fail_open)))
    keys = [f"key-{i}-ключ" for i in range(count)]
    ns = rng.integers(1, 9, size=count).tolist()
    ids = rng.integers(0, 2 ** 63, size=count).astype(np.uint64)
    assert (tp.encode_allow_batch(8, keys, ns)
            == jp.encode_allow_batch(8, keys, ns))
    assert (tp.encode_allow_hashed(9, ids, ns)
            == jp.encode_allow_hashed(9, ids, ns))
    assert tp.encode_allow_n(10, "k", 3) == jp.encode_allow_n(10, "k", 3)
    assert tp.encode_reset(11, "k") == jp.encode_reset(11, "k")
    assert tp.encode_ok(12) == jp.encode_ok(12)
    assert (tp.encode_health(13, True, 1.5, 99)
            == jp.encode_health(13, True, 1.5, 99))
    assert (tp.encode_error(14, tp.E_INVALID_N, "bad n")
            == jp.encode_error(14, jp.E_INVALID_N, "bad n"))
    assert (tp.encode_simple(tp.T_HEALTH, 15)
            == jp.encode_simple(jp.T_HEALTH, 15))


@pytest.mark.parametrize("key", ["vip", "ключ-" * 40, ""])
def test_control_frames_byte_identical_to_jax_protocol(key):
    """POLICY_SET/GET/DEL/R and SNAPSHOT/SNAPSHOT_R: the port's bytes are
    the JAX encoders', and each parser reads the other's frames."""
    for limit in (None, 7, 2**40):
        for scale in (1.0, 2.5):
            a = tp.encode_policy_set(3, key, limit, scale)
            assert a == jp.encode_policy_set(3, key, limit, scale)
            assert (tp.parse_policy_set(a[tp.HEADER_SIZE:])
                    == jp.parse_policy_set(a[tp.HEADER_SIZE:])
                    == (key, limit, scale))
    for t_t, t_j in ((tp.T_POLICY_GET, jp.T_POLICY_GET),
                     (tp.T_POLICY_DEL, jp.T_POLICY_DEL)):
        assert t_t == t_j
        assert (tp.encode_policy_key(t_t, 4, key)
                == jp.encode_policy_key(t_j, 4, key))
    for found, limit, scale in ((True, 9, 1.0), (False, 100, 0.5)):
        r = tp.encode_policy_r(5, found, limit, scale)
        assert r == jp.encode_policy_r(5, found, limit, scale)
        assert tp.parse_policy_r(r[tp.HEADER_SIZE:]) == (found, limit, scale)
    assert (tp.encode_simple(tp.T_SNAPSHOT, 6)
            == jp.encode_simple(jp.T_SNAPSHOT, 6))
    r = tp.encode_snapshot_r(7, 12, 345, 0.125)
    assert r == jp.encode_snapshot_r(7, 12, 345, 0.125)
    assert jp.parse_snapshot_r(r[tp.HEADER_SIZE:]) == (12, 345, 0.125)
    assert (tp.T_POLICY_R, tp.T_SNAPSHOT_R) == (jp.T_POLICY_R,
                                                jp.T_SNAPSHOT_R)


def test_policy_and_snapshot_frames_in_process(tmp_path):
    """The door answers POLICY_SET/GET/DEL as the limiter's override table
    moves, the overrides steer later decisions, SNAPSHOT without
    persistence gets the JAX door's E_INVALID_CONFIG, and with
    ``snapshot=`` it answers SNAPSHOT_R."""
    served = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    calls = []

    def snap():
        calls.append(1)
        return {"id": 4, "wal_seq": 17, "duration_s": 0.5}

    async def main(snapshot):
        srv = await run_server(served, snapshot=snapshot)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            out = []
            for frame in (tp.encode_policy_set(1, "vip", 2),
                          tp.encode_policy_key(tp.T_POLICY_GET, 2, "vip"),
                          tp.encode_allow_batch(3, ["vip"] * 3, [1] * 3),
                          tp.encode_policy_key(tp.T_POLICY_DEL, 4, "vip"),
                          tp.encode_policy_key(tp.T_POLICY_DEL, 5, "vip"),
                          tp.encode_policy_key(tp.T_POLICY_GET, 6, "vip"),
                          tp.encode_policy_set(7, "big", 1 << 24),
                          tp.encode_simple(tp.T_SNAPSHOT, 8)):
                out.append(await _roundtrip(reader, writer, frame))
            return out
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()

    out = asyncio.run(main(None))
    limit = served.config.limit
    assert [o[0] for o in out] == [tp.T_POLICY_R] * 2 + [tp.T_RESULT_BATCH] + [
        tp.T_POLICY_R] * 3 + [tp.T_ERROR] * 2
    assert tp.parse_policy_r(out[0][2]) == (True, 2, 1.0)
    assert tp.parse_policy_r(out[1][2]) == (True, 2, 1.0)
    assert [r.allowed for r in tp.parse_result_batch(out[2][2])] == [
        True, True, False]
    assert tp.parse_policy_r(out[3][2]) == (True, limit, 1.0)
    assert tp.parse_policy_r(out[4][2]) == (False, limit, 1.0)
    assert tp.parse_policy_r(out[5][2]) == (False, limit, 1.0)
    assert tp.parse_error(out[6][2])[0] == tp.E_INVALID_CONFIG
    assert tp.parse_error(out[7][2]) == (
        tp.E_INVALID_CONFIG,
        "persistence not enabled on this server (--snapshot-dir)")
    out = asyncio.run(main(snap))
    assert out[-1][0] == tp.T_SNAPSHOT_R and calls == [1]
    assert tp.parse_snapshot_r(out[-1][2]) == (4, 17, 0.5)
    served.close()


def test_durable_door_killed_and_recovered():
    """chip_smoke.py's crash-and-recovery check at a small size on the CPU:
    ``python -m ratelimiter_tpu_torch.serving --snapshot-dir D`` recovers
    a seeded WAL (limit and window updates, an override), serves frames,
    POLICY_SET/DEL, RESET and SNAPSHOT, is killed with SIGKILL, restarts
    to state bit-equal to a CPU recovery of a copy of D with the decisions
    after it equal too, and loses nothing to a SIGTERM."""
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=20,
                   window=60.0, sketch=T.SketchParams(depth=2, width=1024,
                                                      sub_windows=60))
    out = chip_smoke.check_durable_door(cfg, device="cpu", n_ids=64,
                                        limit1=15, window1=45.0)
    assert "replayed 3 WAL record(s) past seq 5" in out["recovered"]
    assert out["snapshots"] == 5 and out["snapshot_mb"] > 0


@pytest.mark.parametrize("count", [5, 8, 21])
def test_device_packed_hashed_reply_matches_jax_framing(count):
    """A wire=True launch frames from the device-packed buffers; the bytes
    equal the JAX encoder's for the same BatchResult."""
    lim = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    ids = np.arange(count, dtype=np.uint64) % 3
    res = lim.resolve(lim.launch_ids(ids, wire=True))
    assert res.wire_packed is not None
    plain = JaxBatchResult(allowed=res.allowed, limit=res.limit,
                           remaining=res.remaining,
                           retry_after=res.retry_after, reset_at=res.reset_at)
    assert tp.encode_result_hashed(1, res) == jp.encode_result_hashed(1, plain)
    lim.close()


@pytest.mark.parametrize("off", [0, 3, 8, 13])
def test_view_encoders_byte_identical_to_jax_at_row_offsets(off):
    """Frames cut from one device-packed window at row offset ``off``
    (the mask re-packed where ``off`` is not a multiple of 8) frame to the
    JAX view encoder's bytes; so do the batch views."""
    lim = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    ids = np.arange(48, dtype=np.uint64) % 7
    win = lim.resolve(lim.launch_ids(ids, wire=True))
    jwin = JaxBatchResult(allowed=win.allowed, limit=win.limit,
                          remaining=win.remaining,
                          retry_after=win.retry_after,
                          reset_at=win.reset_at,
                          wire_packed=win.wire_packed)
    for count in (1, 5, 8, 21, 48 - off):
        got, want = win.rows(off, count), jwin.rows(off, count)
        assert got.wire_packed[3] == want.wire_packed[3] == off
        tv = tp.encode_result_hashed_views(off + count, got)
        jv = jp.encode_result_hashed_views(off + count, want)
        assert [bytes(v) for v in tv] == [bytes(v) for v in jv]
        assert (tp.encode_result_hashed(1, got)
                == jp.encode_result_hashed(1, want))
        # A second cut of a cut adds the offsets.
        assert got.rows(1, 0).wire_packed[3] == off + 1
    rows = [Result(**r) for r in _results(np.random.default_rng(off), 9)]
    jrows = [JaxResult(**vars(r)) for r in rows]
    assert (tp.encode_result_batch_views(3, 100, rows)
            == jp.encode_result_batch_views(3, 100, jrows))
    lim.close()


def test_metrics_encoding_matches_jax():
    text = "# HELP x a\n# TYPE x counter\nx{k=\"ключ\"} 3\n"
    assert tp.encode_metrics(4, text) == jp.encode_metrics(4, text)
    frame = tp.encode_metrics(4, text)
    assert tp.parse_metrics(frame[tp.HEADER_SIZE:]) == text
    assert (tp.T_METRICS, tp.T_METRICS_R) == (jp.T_METRICS, jp.T_METRICS_R)


def _cfg():
    return Config(algorithm=Algorithm.SLIDING_WINDOW, limit=5, window=6.0,
                  sketch=SketchParams(depth=3, width=128, sub_windows=6))


async def _roundtrip(reader, writer, frame):
    writer.write(frame)
    await writer.drain()
    hdr = await reader.readexactly(tp.HEADER_SIZE)
    length, type_, req_id = tp.parse_header(hdr)
    return type_, req_id, await reader.readexactly(length - 9)


def test_server_answers_frames_like_an_in_process_limiter():
    served = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    mirror = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    rng = np.random.default_rng(1)

    async def main():
        srv = await run_server(served)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            for step in range(4):
                ids = rng.integers(0, 20, size=64).astype(np.uint64)
                ns = rng.integers(1, 3, size=64).astype(np.uint32)
                t, rid, body = await _roundtrip(
                    reader, writer, tp.encode_allow_hashed(step, ids, ns))
                assert (t, rid) == (tp.T_RESULT_HASHED, step)
                got = tp.parse_result_hashed(body)
                want = mirror.allow_ids(ids, ns)
                for f in ("allowed", "remaining", "retry_after", "reset_at"):
                    np.testing.assert_array_equal(getattr(got, f),
                                                  getattr(want, f))
                keys = [f"u{int(i)}" for i in rng.integers(0, 6, size=10)]
                t, _, body = await _roundtrip(
                    reader, writer, tp.encode_allow_batch(100 + step, keys,
                                                          [1] * 10))
                assert t == tp.T_RESULT_BATCH
                assert tp.parse_result_batch(body) == mirror.allow_batch(
                    keys).results()
            t, _, body = await _roundtrip(reader, writer,
                                          tp.encode_allow_n(200, "u1", 2))
            assert tp.parse_result(body) == mirror.allow_n("u1", 2)
            t, _, _ = await _roundtrip(reader, writer, tp.encode_reset(201, "u1"))
            mirror.reset("u1")
            assert t == tp.T_OK
            t, _, body = await _roundtrip(reader, writer,
                                          tp.encode_allow_n(202, "u1", 1))
            assert tp.parse_result(body) == mirror.allow_n("u1", 1)
            t, _, body = await _roundtrip(reader, writer,
                                          tp.encode_simple(tp.T_HEALTH, 203))
            serving, _, decisions = tp.parse_health(body)
            assert t == tp.T_HEALTH_R and serving and decisions == 4 * 74 + 2
            # A zero n is refused; a traced frame is served (the trace
            # extension is stripped), and so is a forward-hinted one.
            t, _, body = await _roundtrip(reader, writer, tp.encode_allow_hashed(
                204, np.arange(3, dtype=np.uint64), [1, 0, 1]))
            assert t == tp.T_ERROR and tp.parse_error(body)[0] == tp.E_INVALID_N
            traced = jp.with_trace(jp.encode_simple(jp.T_HEALTH, 205), 77)
            t, rid, body = await _roundtrip(reader, writer, traced)
            assert (t, rid) == (tp.T_HEALTH_R, 205)
            forward = jp.with_forward(jp.encode_simple(jp.T_HEALTH, 206))
            t, rid, body = await _roundtrip(reader, writer, forward)
            assert (t, rid) == (tp.T_HEALTH_R, 206)
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()

    asyncio.run(main())
    served.close()
    mirror.close()


async def _read_reply(reader):
    length, type_, req_id = tp.parse_header(
        await reader.readexactly(tp.HEADER_SIZE))
    return type_, req_id, await reader.readexactly(length - 9)


def test_replies_out_of_order_and_metrics_frame():
    """Frames wait in the batcher's coalescing window (50 ms here) while a
    HEALTH frame sent after them is answered at once: replies carry
    request ids and come out of order. METRICS returns the door's
    registry as Prometheus text."""
    served = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    mirror = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    reg = Registry()

    async def main():
        srv = await run_server(served, max_delay=0.05, registry=reg)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            ids = np.arange(12, dtype=np.uint64) % 5
            writer.write(tp.encode_allow_hashed(1, ids)
                         + tp.encode_allow_hashed(2, ids)
                         + tp.encode_simple(tp.T_HEALTH, 3))
            replies = [await _read_reply(reader) for _ in range(3)]
            assert replies[0][:2] == (tp.T_HEALTH_R, 3)
            assert tp.parse_health(replies[0][2])[2] == 0
            # Both frames were one window: answered in order within it.
            want = mirror.allow_ids(np.concatenate([ids, ids]))
            for (t, rid, body), rows in zip(replies[1:], (want.rows(0, 12),
                                                          want.rows(12, 12))):
                assert t == tp.T_RESULT_HASHED
                got = tp.parse_result_hashed(body)
                np.testing.assert_array_equal(got.allowed, rows.allowed)
                np.testing.assert_array_equal(got.remaining, rows.remaining)
            writer.write(tp.encode_simple(tp.T_METRICS, 4))
            t, rid, body = await _read_reply(reader)
            assert (t, rid) == (tp.T_METRICS_R, 4)
            text = tp.parse_metrics(body)
            assert text == reg.render()
            assert "rate_limiter_server_batch_size_count 1\n" in text
            assert ('rate_limiter_server_batch_size_bucket{le="32"} 1\n'
                    in text)
            assert "rate_limiter_pipeline_inflight 0\n" in text
        finally:
            writer.close()
            await writer.wait_closed()
            await srv.shutdown()

    asyncio.run(main())
    served.close()
    mirror.close()


def test_slow_reader_is_dropped(monkeypatch):
    """A client that pipelines frames but never reads is cut off once the
    connection's write buffer passes WRITE_BUFFER_LIMIT (lowered to 64 KiB
    here), instead of buffering replies without bound. The client's
    receive buffer is capped, so the ~12 MB of replies cannot all wait in
    the kernel's buffers."""
    import socket
    import time

    from ratelimiter_tpu_torch.serving import server as door

    monkeypatch.setattr(door, "WRITE_BUFFER_LIMIT", 64 * 1024)
    served = SketchLimiter(_cfg(), ManualClock(1e6), device="cpu")
    ids = np.arange(4096, dtype=np.uint64)
    frames, reply = 128, tp.HEADER_SIZE + 13 + 512 + 24 * 4096

    async def main():
        srv = await run_server(served, registry=Registry())
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
        sock.connect(("127.0.0.1", srv.port))
        reader, writer = await asyncio.open_connection(sock=sock)
        try:
            for i in range(frames):
                writer.write(tp.encode_allow_hashed(i, ids))
            try:
                await writer.drain()
            except ConnectionResetError:
                pass
            # Read nothing until the server has let go of the connection.
            deadline = time.monotonic() + 120
            while srv._conn_tasks and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            dropped = not srv._conn_tasks
            got = 0
            try:
                while True:
                    chunk = await asyncio.wait_for(reader.read(1 << 20), 10)
                    if not chunk:
                        break
                    got += len(chunk)
            except ConnectionResetError:
                pass
            return dropped, got
        finally:
            writer.close()
            await srv.shutdown()

    dropped, got = asyncio.run(main())
    assert dropped and got < frames * reply
    served.close()


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "TOKEN_BUCKET"])
def test_pipelined_connections_through_the_batcher_match_a_replay(algo):
    """chip_smoke.py's door check at a small size on the CPU: 4 pipelining
    connections (ALLOW_HASHED and ALLOW_BATCH frames, a RESET, HEALTH,
    METRICS) from a child process; every frame's answer bit-identical to
    a replay of the recorded windows, the final state too, and fewer
    dispatches than frames."""
    cfg = T.Config(algorithm=getattr(T.Algorithm, algo), limit=20,
                   window=2.0, sketch=T.SketchParams(depth=4, width=4096,
                                                     sub_windows=4))
    out = chip_smoke.check_door(
        None, cfg, algo, device="cpu", conns=4, frames=24, n_ids=64,
        n_keys=16, space="c2" if algo == "TOKEN_BUCKET" else "zipf",
        server_kw=dict(max_batch=256))
    assert out["dispatches"] < out["frames"] == 96
    assert out["resets"] == 1 and out["decisions"] == 4 * (21 * 64 + 3 * 16)


@pytest.mark.parametrize("algo", ["SLIDING_WINDOW", "FIXED_WINDOW",
                                  "TOKEN_BUCKET"])
@pytest.mark.parametrize("backend", ["dense", "exact"])
def test_dense_and_exact_doors_match_a_replay(backend, algo):
    """chip_smoke.py's door check for the dense and exact backends on the
    CPU: ALLOW_BATCH, ALLOW_N and RESET frames pipelined on one
    connection, every answer and the final state bit-identical to a
    replay of the windows the batcher launched; ALLOW_HASHED refused with
    InvalidConfigError, as the JAX batcher refuses a backend without the
    raw-id lane; HEALTH counts every decision."""
    cfg = chip_smoke.dense_config(algo, capacity=1 << 14)
    out = chip_smoke.check_backend_door(None, cfg, backend, device="cpu",
                                        frames=24, n_keys=32)
    assert out["frames"] == 24 + 4 + 1
    assert out["windows"] < out["frames"]


def test_binary_serves_the_dense_backend():
    """``python -m ratelimiter_tpu_torch.serving --backend dense --device
    cpu`` boots, prints its serving line naming the backend, answers a
    string frame and refuses ALLOW_HASHED."""
    from ratelimiter_tpu_torch.serving import protocol as tp

    srv = chip_smoke.ServerProcess(["--backend", "dense", "--device", "cpu",
                                    "--dense-capacity", "1024",
                                    "--algorithm", "token_bucket",
                                    "--limit", "3", "--window", "10"])
    try:
        assert any(line.startswith("serving token_bucket/dense")
                   for line in srv.output)
        client = chip_smoke.DoorClient(srv.port)
        t, body = client.call(tp.encode_allow_batch, ["a"] * 5, [1] * 5)
        assert t == tp.T_RESULT_BATCH
        assert [r.allowed for r in tp.parse_result_batch(body)] == [
            True, True, True, False, False]
        with pytest.raises(AssertionError,
                           match=f"server error \\({tp.E_INVALID_CONFIG}, "
                                 f"'the hashed bulk lane"):
            client.call(tp.encode_allow_hashed,
                        np.arange(4, dtype=np.uint64))
        client.close()
    finally:
        assert srv.terminate() == 0


def test_tenant_door_matches_a_replay():
    """chip_smoke.py's door check with the documented tenant flags (the
    binary's own boot code on the served limiter and the replay's): string
    frames over the assigned key space, every frame and the final state
    (tn_* included) bit-identical to a replay of the recorded windows."""
    cfg = chip_smoke.with_tenants(T.Config(
        algorithm=T.Algorithm.SLIDING_WINDOW, limit=20, window=2.0,
        sketch=T.SketchParams(depth=4, width=4096, sub_windows=4)))
    out = chip_smoke.check_door(
        None, cfg, "tenants", device="cpu", conns=4, frames=24, n_ids=64,
        n_keys=64, space="tenants", server_kw=dict(max_batch=256),
        setup=chip_smoke.boot_tenants)
    assert out["dispatches"] < out["frames"] == 96


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the fleet, chaos and placement packages
    among them), and chip_smoke.py, imported in a fresh
    interpreter, leaves no jax/jaxlib/ratelimiter_tpu module loaded (exact
    names or dotted children: ratelimiter_tpu_torch itself is fine)."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import ratelimiter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("checkpoint", "observability.decorators",
             "observability.tracing", "observability.events", "persistence",
             "persistence.wal", "persistence.snapshotter",
             "persistence.recover", "persistence.manager",
             "algorithms.exact", "algorithms.dense", "ops.dense_kernels",
             "ops.dense_cuda", "evaluation", "evaluation.accuracy",
             "evaluation.compare", "evaluation.loadgen",
             "evaluation.oracle_device", "evaluation.scenarios",
             "observability.audit", "observability.slo",
             "serving.http_gateway", "serving.grpc_server",
             "serving.grpc_pb", "leases", "leases.manager",
             "leases.listener", "leases.cache", "leases.driver",
             "parallel", "parallel.mesh", "parallel.limiter",
             "parallel.mesh_kernels", "parallel.collective",
             "parallel.quarantine", "ops.route_kernels", "parallel.dcn",
             "parallel.reshard", "serving.dcn_peer", "tools",
             "tools.rebucket", "fleet", "fleet.config", "fleet.lanes",
             "fleet.forwarder", "fleet.handoff", "fleet.membership",
             "chaos", "chaos.injector", "placement",
             "placement.accounting", "fleet.tower", "placement.planner",
             "placement.executor", "tools.fleet_status",
             "tools.fleet_trace"):
    assert pkg.__name__ + "." + name in names, name
print(*names, file=sys.stderr)
# The gRPC message classes build from the committed descriptor alone.
importlib.import_module(pkg.__name__ + ".serving.grpc_pb").load()
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "ratelimiter_tpu"
             or m.startswith("ratelimiter_tpu."))
print(len(names), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 40
    assert bad.strip() == "[]"
    assert "ratelimiter_tpu_torch.persistence.recover" in out.stderr
    assert "ratelimiter_tpu_torch.parallel.collective" in out.stderr
    assert "ratelimiter_tpu_torch.serving.dcn_peer" in out.stderr
    assert "ratelimiter_tpu_torch.fleet.membership" in out.stderr
    assert "ratelimiter_tpu_torch.chaos.injector" in out.stderr
    assert "ratelimiter_tpu_torch.placement.accounting" in out.stderr
    for name in ("fleet.tower", "placement.planner", "placement.executor",
                 "tools.fleet_status", "tools.fleet_trace"):
        assert f"ratelimiter_tpu_torch.{name}" in out.stderr


@pytest.mark.parametrize("argv", [["--controller"], ["--tenant", "a=5"],
                                  ["--assign", "k=a"]])
def test_tenant_flags_need_tenants(argv):
    """The JAX binary's refusals (tests/test_hierarchy_serving.py::
    test_flag_validation): --controller, --tenant and --assign need
    --tenants > 0."""
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_config,
        parse_args,
    )

    with pytest.raises(SystemExit, match="--tenants"):
        build_config(parse_args(argv))
    cfg = build_config(parse_args(argv + ["--tenants", "4"]))
    assert cfg.hierarchy.tenants == 4


def test_tenant_door_keeps_windows_within_one_cascade_launch():
    """With --tenants the door's hashed windows merge at most
    sketch_cuda.ADMIT_CAPACITY rows (the cascade's one launch; twice
    --max-batch without tenants), and a --max-batch above it is
    refused."""
    from ratelimiter_tpu_torch.ops.sketch_cuda import ADMIT_CAPACITY
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_config,
        max_window,
        parse_args,
    )

    for argv, want in ((["--max-batch", "4096"], 8192),
                       (["--max-batch", "6000"], 12000),
                       (["--max-batch", "6000", "--tenants", "4"],
                        ADMIT_CAPACITY),
                       (["--max-batch", "100", "--tenants", "4"], 200)):
        args = parse_args(argv)
        assert max_window(args, build_config(args)) == want, argv
    with pytest.raises(SystemExit, match="--max-batch"):
        build_config(parse_args(["--tenants", "4", "--max-batch",
                                 str(ADMIT_CAPACITY + 1)]))


def test_batcher_hashed_windows_stay_within_max_window():
    """MicroBatcher(max_window=12, max_batch=16): three 5-id frames
    coalesce into windows of 10 and 5 (a third would pass 12), and a lone
    30-id frame splits into segments of 12, 12 and 6; every frame gets
    its own rows of the limiter's decisions."""
    from ratelimiter_tpu_torch.serving.batcher import MicroBatcher

    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=3,
                   window=2.0, sketch=T.SketchParams(depth=2, width=1024,
                                                     sub_windows=4))
    lim = SketchLimiter(cfg, ManualClock(1e6), device="cpu")
    twin = SketchLimiter(cfg, ManualClock(1e6), device="cpu")
    sizes = []
    launch = lim.launch_ids

    def recorded(ids, ns=None, **kw):
        sizes.append(len(ids))
        return launch(ids, ns, **kw)

    lim.launch_ids = recorded
    frames = [np.arange(i * 5, i * 5 + 5, dtype=np.uint64) % 7
              for i in range(3)] + [np.arange(30, dtype=np.uint64) % 9]

    async def main():
        b = MicroBatcher(lim, max_batch=16, max_window=12,
                         registry=Registry())
        futs = [b.submit_hashed_nowait(f, np.ones(len(f), np.int32))
                for f in frames]
        got = await asyncio.gather(*futs)
        await b.drain()
        b.close()
        return got

    got = asyncio.run(main())
    assert sizes == [10, 5, 12, 12, 6]
    want = [twin.allow_ids(w) for w in (np.concatenate(frames[:2]),
                                        frames[2], frames[3][:12],
                                        frames[3][12:24], frames[3][24:])]
    allowed = np.concatenate([w.allowed for w in want])
    np.testing.assert_array_equal(
        np.concatenate([r.allowed for r in got]), allowed)
    lim.close()
    twin.close()


def test_door_with_tenants_and_controller_gauges():
    """``python -m ratelimiter_tpu_torch.serving --tenants 4 --global-limit
    100 --tenant gold=5:3:2 --assign g1=gold --assign g2=gold --controller``
    on the CPU: six ALLOW frames for gold's two keys admit exactly gold's
    5, an unassigned key is admitted (the default tenant), and METRICS
    shows the controller's gauges for every scope."""
    srv = chip_smoke.ServerProcess(
        ["--device", "cpu", "--depth", "2", "--width", "1024",
         "--tenants", "4", "--global-limit", "100", "--tenant",
         "gold=5:3:2", "--assign", "g1=gold", "--assign", "g2=gold",
         "--controller", "--controller-interval", "0.05"])
    try:
        c = chip_smoke.DoorClient(srv.port)
        got = [tp.parse_result(c.call(tp.encode_allow_n, k, 1)[1]).allowed
               for k in ("g1", "g2") * 3]
        assert sum(got) == 5 and not got[-1]
        assert tp.parse_result(c.call(tp.encode_allow_n, "other",
                                      1)[1]).allowed
        deadline = 50
        while deadline:
            _, body = c.call(lambda rid: tp.encode_simple(tp.T_METRICS, rid))
            text = tp.parse_metrics(body)
            if 'rate_limiter_hier_in_window{scope="global"} 6' in text:
                break
            deadline -= 1
            time.sleep(0.05)
        for sample in ('rate_limiter_hier_effective_limit{scope="gold"} 5',
                       'rate_limiter_hier_effective_limit{scope="global"} '
                       '100', 'rate_limiter_hier_in_window{scope="gold"} 5',
                       'rate_limiter_hier_in_window{scope="global"} 6'):
            assert sample in text, sample
        c.close()
        assert srv.terminate() == 0
    finally:
        srv.kill()


def test_tenant_durable_door_keeps_the_controllers_move():
    """chip_smoke.py's tenant crash-and-recovery check at a small size on
    the CPU: the binary with the documented tenant flags and
    --controller tightens free (5000 -> 3500) under a hot-tenant storm,
    is killed after a SNAPSHOT, and restarts to every array (tn_*, the
    hier_* columns with the moved limit) bit-equal to a CPU recovery of a
    copy, its decisions after it too."""
    cfg = T.Config(algorithm=T.Algorithm.SLIDING_WINDOW, limit=100,
                   window=60.0, sketch=T.SketchParams(depth=2, width=1024,
                                                      sub_windows=60))
    out = chip_smoke.check_tenant_durable_door(cfg, device="cpu")
    assert out["free_effective"] == 3500
    assert "restored snapshot" in out["recovered"]


def test_chip_smoke_names_a_child_left_running():
    """chip_smoke.py fails its run when a process it started is still
    there at the end (a door client, a server, multiprocessing's
    resource tracker): ``check_no_children`` names the child."""
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        with pytest.raises(AssertionError,
                           match=rf"processes left running: .*{proc.pid}: "):
            chip_smoke.check_no_children()
    finally:
        proc.kill()
        proc.wait()


# ------------------------------------------------- the binary's flag names


def _service_argv() -> list:
    """The options of ``deployments/ratelimiter-tpu.service``'s ExecStart
    (after ``-m ratelimiter_tpu.serving``), split into words."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "deployments", "ratelimiter-tpu.service")
    with open(path) as fh:
        text = fh.read()
    start = text.index("ExecStart=")
    lines = []
    for line in text[start:].splitlines():
        lines.append(line.rstrip("\\ "))
        if not line.rstrip().endswith("\\"):
            break
    words = " ".join(lines).split()
    return words[words.index("ratelimiter_tpu.serving") + 1:]


def _jax_config(args):
    """The Config the JAX binary builds from its parsed ``args``
    (ratelimiter_tpu/serving/__main__.py, ``main``: the Config(...) call
    before the tenant checks)."""
    import ratelimiter_tpu as R

    return R.Config(
        algorithm=R.Algorithm(args.algorithm), limit=args.limit,
        window=args.window, fail_open=args.fail_open,
        sketch=R.SketchParams(depth=args.sketch_depth,
                              width=args.sketch_width,
                              sub_windows=args.sub_windows,
                              hh_slots=args.hh_slots, kernels=args.kernels),
        persistence=R.PersistenceSpec(
            dir=args.snapshot_dir, snapshot_interval=args.snapshot_interval,
            snapshot_after_mutations=args.snapshot_after_mutations,
            retain=args.snapshot_retain, wal_fsync=args.wal_fsync),
        hierarchy=R.HierarchySpec(
            tenants=args.tenants, map_capacity=args.tenant_map,
            global_limit=args.global_limit,
            default_tenant_limit=args.default_tenant_limit))


@pytest.mark.parametrize("extra", [
    [], ["--hh-slots", "256", "--sub-windows", "30", "--fail-open"],
    ["--tenants", "16", "--tenant-map", "512", "--global-limit", "50000",
     "--snapshot-dir", "/var/lib/rl", "--snapshot-interval", "10",
     "--wal-fsync", "interval"],
    ["--trace", "--circuit-breaker", "--breaker-threshold", "3",
     "--breaker-cooldown", "2.5", "--log-decisions", "--log-redact-keys",
     "--no-metrics", "--flight-recorder", "--flight-recorder-capacity",
     "1024", "--no-event-journal", "--event-journal-capacity", "512",
     "--event-journal-dir", "/var/lib/rl/events", "--log-level", "debug"],
    ["--http-port", "8080", "--http-reset", "--http-reset-token", "rt",
     "--http-policy", "--http-policy-token", "pt", "--http-snapshot-token",
     "st", "--http-tenants", "--http-tenants-token", "tt", "--debug-trace",
     "--debug-token", "dt", "--audit", "--audit-sample", "8",
     "--audit-token", "at", "--audit-twin"]],
    ids=["service", "sketch", "tenants", "observability", "http-audit"])
def test_shared_flags_give_the_jax_binarys_config(extra):
    """The deployment's command line (its options that the port's binary
    has: --sketch-depth 4 --sketch-width 65536 and the rest of
    deployments/ratelimiter-tpu.service:22-25), with more shared flags,
    parses in both binaries to equal Configs: the same fingerprint (every
    semantic field) and the same persistence and hierarchy specs; the
    observability flags (the decorator stack, the flight recorder, the
    event journal, the log level) and the HTTP gateway's and auditor's
    (``--http-*``, ``--debug-*``, ``--audit*``) to equal values, their
    defaults too."""
    from dataclasses import asdict

    from ratelimiter_tpu.checkpoint import config_fingerprint as jfp
    from ratelimiter_tpu.serving.__main__ import build_parser
    from ratelimiter_tpu_torch.checkpoint import config_fingerprint
    from ratelimiter_tpu_torch.serving import __main__ as port

    argv = _service_argv()
    assert "--sketch-depth" in argv and "--sketch-width" in argv
    known = port.build_parser()._option_string_actions
    ported, i = [], 0
    while i < len(argv):
        takes = i + 1 < len(argv) and not argv[i + 1].startswith("--")
        if argv[i] in known:
            ported += argv[i:i + 1 + takes]
        i += 1 + takes
    assert ported[ported.index("--sketch-depth") + 1] == "4"
    ported += extra
    args, jargs = port.parse_args(ported), build_parser().parse_args(ported)
    cfg = port.build_config(args)
    jcfg = _jax_config(jargs)
    assert config_fingerprint(cfg) == jfp(jcfg)
    observability = ("trace", "circuit_breaker", "breaker_threshold",
                     "breaker_cooldown", "log_decisions", "log_redact_keys",
                     "no_metrics", "flight_recorder",
                     "flight_recorder_capacity", "no_event_journal",
                     "event_journal_capacity", "event_journal_dir",
                     "log_level", "http_port", "http_reset",
                     "http_reset_token", "http_policy", "http_policy_token",
                     "http_snapshot_token", "http_tenants",
                     "http_tenants_token", "debug_trace", "debug_token",
                     "audit", "audit_sample", "audit_token", "audit_twin")
    assert ({k: getattr(args, k) for k in observability}
            == {k: getattr(jargs, k) for k in observability})
    assert (cfg.sketch.depth, cfg.sketch.width) == (4, 65536)
    assert asdict(cfg.persistence) == asdict(jcfg.persistence)
    assert asdict(cfg.hierarchy) == asdict(jcfg.hierarchy)


def test_old_geometry_flags_still_parse():
    """--depth/--width, the port's older spellings, stay aliases of
    --sketch-depth/--sketch-width."""
    from ratelimiter_tpu_torch.serving.__main__ import parse_args

    old = parse_args(["--depth", "2", "--width", "1024"])
    new = parse_args(["--sketch-depth", "2", "--sketch-width", "1024"])
    assert (old.sketch_depth, old.sketch_width) == (2, 1024)
    assert vars(old) == vars(new)


#: The port binary's own flags: the card (--device), the dense
#: backend's capacity and the bare CU switch, and the geometry flags'
#: older aliases.
PORT_ONLY_FLAGS = {"--device", "--dense-capacity", "--no-conservative-update",
                   "--depth", "--width"}
#: The JAX binary's own: the Pallas/jnp kernel choice and its prewarm.
JAX_ONLY_FLAGS = {"--kernels", "--no-prewarm"}


def test_binary_has_every_flag_of_the_jax_binary():
    """The port's ``build_parser()`` takes every option string of the JAX
    binary's but ``--kernels`` and ``--no-prewarm`` (and adds only its
    own five), each shared flag with the JAX default."""
    from ratelimiter_tpu.serving.__main__ import build_parser as jax_parser
    from ratelimiter_tpu_torch.serving.__main__ import build_parser

    def options(parser):
        return {o: a for a in parser._actions for o in a.option_strings}

    port, jax = options(build_parser()), options(jax_parser())
    assert set(jax) - JAX_ONLY_FLAGS == set(port) - PORT_ONLY_FLAGS
    assert len(set(jax)) == 112
    for opt in set(jax) & set(port):
        assert port[opt].default == jax[opt].default, opt
        assert port[opt].dest == jax[opt].dest, opt
    for opt, default in (("--rebalance-interval", 10.0),
                         ("--rebalance-max-moves", 2),
                         ("--rebalance-trigger", 1.4),
                         ("--rebalance-target", 1.15),
                         ("--rebalance-min-residency", 60.0),
                         ("--rebalance-seed", 0), ("--rebalance", False),
                         ("--http-rebalance-token", None)):
        assert port[opt].default == default, opt


@pytest.mark.parametrize("argv,words", [
    (["--rebalance"], "--rebalance needs --fleet-config (the placement "
                      "brain moves fleet ranges)"),
    (["--rebalance", "--fleet-config", "fleet.json", "--fleet-self", "h0",
      "--rebalance-target", "1.4"],
     "--rebalance-target must be below --rebalance-trigger (the "
     "hysteresis band prevents flapping)")], ids=["no-fleet", "band"])
def test_rebalance_refusals_in_the_jax_words(argv, words):
    """The JAX binary's two refusals (ratelimiter_tpu/serving/__main__.py
    :1086-1091), word for word; a target below the trigger, and the
    flags without ``--rebalance``, parse."""
    from ratelimiter_tpu_torch.serving.__main__ import (
        build_config,
        parse_args,
    )

    with pytest.raises(SystemExit) as ei:
        build_config(parse_args(argv))
    assert str(ei.value) == words
    build_config(parse_args(argv[:-1] + ["1.3"] if "--rebalance-target"
                            in argv else ["--rebalance-target", "2.0"]))
