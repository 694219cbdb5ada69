"""The port's gRPC server (serving/grpc_server.py, its message classes
from the committed descriptor in serving/grpc_pb.py) against the JAX
package's, tolerance 0.

The scenarios of tests/test_grpc_server.py run on both servers side by
side: one over a JAX limiter (the exact backend, and the sketch on its
jnp path), one over the port's limiter on the CPU, their clocks at the
same instant. Each RPC goes to both; replies are compared as serialized
bytes (the two packages' messages are different classes from different
descriptor pools), errors by status code and details, and journal
events by action, actor and payload. Health is compared without its
wall-clock uptime.

Then the binary: ``python -m ratelimiter_tpu_torch.serving --device cpu
--grpc-port`` on the asyncio door and on the native door with two
shards, in child processes killed in a ``finally``: gRPC answers equal
the binary door's on the same keys. And the descriptor: where ``protoc``
is installed, ``api/proto/ratelimiter.proto`` compiled again gives the
committed bytes.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest

grpc = pytest.importorskip("grpc")

import ratelimiter_tpu as R  # noqa: E402
import ratelimiter_tpu_torch as T  # noqa: E402
from ratelimiter_tpu.core.types import Result as JResult  # noqa: E402
from ratelimiter_tpu.observability import events as jevents  # noqa: E402
from ratelimiter_tpu.observability import tracing as jtracing  # noqa: E402
from ratelimiter_tpu.serving import grpc_server as jgs  # noqa: E402
from ratelimiter_tpu_torch.core.types import Result as TResult  # noqa: E402
from ratelimiter_tpu_torch.observability import events as tevents  # noqa: E402
from ratelimiter_tpu_torch.observability import tracing as ttracing  # noqa: E402
from ratelimiter_tpu_torch.serving import grpc_pb  # noqa: E402
from ratelimiter_tpu_torch.serving import grpc_server as tgs  # noqa: E402

if not jgs.grpc_available():  # pragma: no cover - env without protoc
    pytest.skip("the JAX server needs protoc and grpcio",
                allow_module_level=True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
TIMEOUT = 30


@pytest.fixture(autouse=True)
def _globals_off():
    for mod in (jtracing, ttracing, jevents, tevents):
        mod.disable()
    yield
    for mod in (jtracing, ttracing, jevents, tevents):
        mod.disable()


def _stub(channel, pb2):
    """Method callables over ``channel`` for ``pb2``'s classes (no
    generated stubs)."""
    base = "/ratelimiter.v1.RateLimiter/"
    names = {
        "Allow": ("AllowRequest", "AllowResponse"),
        "AllowN": ("AllowNRequest", "AllowResponse"),
        "AllowBatch": ("AllowBatchRequest", "AllowBatchResponse"),
        "Reset": ("ResetRequest", "ResetResponse"),
        "Health": ("HealthRequest", "HealthResponse"),
        "SetOverride": ("SetOverrideRequest", "OverrideResponse"),
        "GetOverride": ("GetOverrideRequest", "OverrideResponse"),
        "DeleteOverride": ("DeleteOverrideRequest", "DeleteOverrideResponse"),
        "SetTenant": ("SetTenantRequest", "TenantResponse"),
        "GetTenant": ("GetTenantRequest", "TenantResponse"),
        "DeleteTenant": ("DeleteTenantRequest", "DeleteTenantResponse"),
        "AssignTenant": ("AssignTenantRequest", "AssignTenantResponse"),
        "UnassignTenant": ("UnassignTenantRequest", "UnassignTenantResponse"),
    }
    return {name: channel.unary_unary(
        base + name,
        request_serializer=getattr(pb2, req).SerializeToString,
        response_deserializer=getattr(pb2, resp).FromString)
        for name, (req, resp) in names.items()}


def _cfg(M, backend: str, limit: int = 3, *, fail_open: bool = False,
         algo=None, **kw):
    sketch = {}
    if backend == "sketch":
        sketch = dict(depth=2, width=512, sub_windows=4)
        if M is R:
            sketch["kernels"] = "jnp"
    return M.Config(algorithm=algo or M.Algorithm.SLIDING_WINDOW,
                    limit=limit, window=60.0, fail_open=fail_open,
                    sketch=M.SketchParams(**sketch), **kw)


def _limiter(M, backend, cfg, clock):
    if M is R:
        return M.create_limiter(cfg, backend=backend, clock=clock)
    return M.create_limiter(cfg, backend=backend, clock=clock, device="cpu")


class GrpcPair:
    """The JAX server over a JAX limiter and the port's over the port's.
    ``server(M, mod, lim)`` builds a server (default:
    ``grpc_server_for_limiter``)."""

    def __init__(self, backend: str = "exact", *, limit: int = 3,
                 server=None, **cfg_kw):
        self.pb2 = (jgs._load_pb2(), grpc_pb.load())
        self.lims, self.srvs, self.chans, self.stubs = [], [], [], []
        for M, mod, pb2 in ((R, jgs, self.pb2[0]), (T, tgs, self.pb2[1])):
            lim = _limiter(M, backend, _cfg(M, backend, limit, **{
                k: (v(M) if callable(v) else v)
                for k, v in cfg_kw.items()}), M.ManualClock(T0))
            srv = (server(M, mod, lim) if server is not None
                   else mod.grpc_server_for_limiter(lim))
            srv.start()
            ch = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
            self.lims.append(lim)
            self.srvs.append(srv)
            self.chans.append(ch)
            self.stubs.append(_stub(ch, pb2))

    def call(self, rpc: str, msg: str, **fields):
        """``rpc`` on both servers with the same request; returns the
        port's reply (or its error as ``(code, details)``) after holding
        it to the JAX reply."""
        outs = []
        for stub, pb2 in zip(self.stubs, self.pb2):
            req = _build(pb2, msg, fields)
            try:
                outs.append(stub[rpc](req, timeout=TIMEOUT))
            except grpc.RpcError as e:
                outs.append((e.code(), e.details()))
        j, t = outs
        if isinstance(t, tuple):
            assert t == j, (rpc, fields)
            return t
        if rpc == "Health":
            assert (t.serving, t.decisions_total) == \
                (j.serving, j.decisions_total)
        else:
            assert t.SerializeToString() == j.SerializeToString(), \
                (rpc, fields, t, j)
        return t

    def close(self) -> None:
        for ch in self.chans:
            ch.close()
        for srv in self.srvs:
            srv.shutdown()
        for lim in self.lims:
            lim.close()


def _build(pb2, msg: str, fields: dict):
    if msg == "AllowBatchRequest":
        return pb2.AllowBatchRequest(items=[
            pb2.AllowBatchRequest.Item(key=k, n=n)
            for k, n in fields["items"]])
    return getattr(pb2, msg)(**fields)


@pytest.fixture(params=["exact", "sketch"])
def pair(request):
    p = GrpcPair(request.param)
    yield p
    p.close()


def test_allow_deny_reset_roundtrip(pair):
    for i in range(3):
        r = pair.call("Allow", "AllowRequest", key="u1")
        assert r.allowed and r.remaining == 2 - i and r.limit == 3
    r = pair.call("Allow", "AllowRequest", key="u1")
    assert not r.allowed and r.retry_after > 0 and r.reset_at > T0
    pair.call("Reset", "ResetRequest", key="u1")
    assert pair.call("Allow", "AllowRequest", key="u1").allowed


def test_allow_n_all_or_nothing(pair):
    assert pair.call("AllowN", "AllowNRequest", key="u2", n=3).allowed
    r = pair.call("AllowN", "AllowNRequest", key="u2", n=2)
    assert not r.allowed and r.remaining == 0


def test_allow_batch_in_order_with_sequencing(pair):
    out = pair.call("AllowBatch", "AllowBatchRequest", items=[
        ("b1", 2), ("b2", 1), ("b1", 1), ("b1", 1)])
    assert [r.allowed for r in out.results] == [True, True, True, False]


def test_health_and_error_mapping(pair):
    pair.call("Allow", "AllowRequest", key="h")
    assert pair.call("Health", "HealthRequest").serving
    code, _ = pair.call("Allow", "AllowRequest", key="")
    assert code == grpc.StatusCode.INVALID_ARGUMENT
    code, _ = pair.call("AllowN", "AllowNRequest", key="k", n=0)
    assert code == grpc.StatusCode.INVALID_ARGUMENT
    code, _ = pair.call("AllowBatch", "AllowBatchRequest",
                        items=[("k", 1), ("k", 0)])
    assert code == grpc.StatusCode.INVALID_ARGUMENT


def test_tenantless_server_unimplemented(pair):
    code, _ = pair.call("SetTenant", "SetTenantRequest", name="gold",
                        limit=1)
    assert code == grpc.StatusCode.UNIMPLEMENTED


@pytest.mark.parametrize("fail_open", [False, True])
def test_backend_failure_unavailable_or_fail_open(fail_open):
    pair = GrpcPair("exact", fail_open=fail_open)
    try:
        for lim in pair.lims:
            lim.inject_failure()
        out = pair.call("Allow", "AllowRequest", key="k")
        if fail_open:
            assert out.allowed and out.fail_open
        else:
            assert out[0] == grpc.StatusCode.UNAVAILABLE
        for lim in pair.lims:
            lim.heal()
        assert pair.call("Allow", "AllowRequest", key="k").allowed
    finally:
        pair.close()


def test_closed_limiter_failed_precondition():
    pair = GrpcPair("exact", algo=lambda M: M.Algorithm.FIXED_WINDOW)
    try:
        for lim in pair.lims:
            lim.close()
        code, _ = pair.call("Allow", "AllowRequest", key="k")
        assert code == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        pair.close()


def test_allow_batch_is_one_bulk_submission():
    """An N-item AllowBatch reaches the decide layer as ONE
    ``decide_many`` call, results in request order, on both servers."""
    calls = {R: [], T: []}

    def server(M, mod, _lim):
        res = JResult if M is R else TResult

        def decide_many(pairs):
            calls[M].append(len(pairs))
            return [res(allowed=(i % 2 == 0), limit=100, remaining=i,
                        retry_after=0.0, reset_at=T0)
                    for i, _ in enumerate(pairs)]

        def decide(key, n):
            raise AssertionError("scalar path must not serve AllowBatch")

        return mod.GrpcRateLimitServer(decide, lambda k: None,
                                       decide_many=decide_many)

    pair = GrpcPair("exact", server=server)
    try:
        out = pair.call("AllowBatch", "AllowBatchRequest",
                        items=[(f"k{i}", 1) for i in range(64)])
        assert [r.remaining for r in out.results] == list(range(64))
        assert calls == {R: [64], T: [64]}
    finally:
        pair.close()


def test_override_rpcs_and_journal(pair):
    for mod in (jevents, tevents):
        mod.enable(capacity=64)
    r = pair.call("GetOverride", "GetOverrideRequest", key="vip")
    assert not r.found and r.limit == 3
    r = pair.call("SetOverride", "SetOverrideRequest", key="vip", limit=7)
    assert r.found and r.limit == 7
    allowed = sum(pair.call("Allow", "AllowRequest", key="vip").allowed
                  for _ in range(9))
    assert allowed == 7
    assert pair.call("Allow", "AllowRequest", key="std").limit == 3
    assert pair.call("GetOverride", "GetOverrideRequest", key="vip").found
    assert pair.call("DeleteOverride", "DeleteOverrideRequest",
                     key="vip").deleted
    assert not pair.call("DeleteOverride", "DeleteOverrideRequest",
                         key="vip").deleted
    pair.call("Reset", "ResetRequest", key="vip")
    code, _ = pair.call("SetOverride", "SetOverrideRequest", key="v",
                        limit=-4)
    assert code == grpc.StatusCode.INVALID_ARGUMENT
    j, t = ([(e["action"], e["actor"], e["payload"])
             for e in mod.get().tail(category="policy")["events"]]
            for mod in (jevents, tevents))
    assert t == j
    assert [a for a, _, _ in t] == ["set-override", "delete-override",
                                    "delete-override", "reset"]
    assert "vip" not in json.dumps(t)


def test_tenant_crud_and_journal():
    def server(M, mod, lim):
        return mod.GrpcRateLimitServer(
            lambda key, n: lim.allow_n(key, n), lim.reset, tenants=lim)

    pair = GrpcPair("sketch", limit=50, server=server,
                    hierarchy=lambda M: M.HierarchySpec(tenants=4))
    for mod in (jevents, tevents):
        mod.enable(capacity=64)
    try:
        out = pair.call("SetTenant", "SetTenantRequest", name="gold",
                        limit=30, weight=3)
        assert out.found and out.limit == 30 and out.floor == 3
        assert pair.call("GetTenant", "GetTenantRequest",
                         name="gold").tid == out.tid
        assert not pair.call("GetTenant", "GetTenantRequest",
                             name="nope").found
        pair.call("AssignTenant", "AssignTenantRequest", key="acct:1",
                  tenant="gold")
        assert [lim.tenant_of("acct:1") for lim in pair.lims] == \
            ["gold", "gold"]
        for _ in range(3):
            pair.call("AllowN", "AllowNRequest", key="acct:1", n=11)
        assert pair.call("UnassignTenant", "UnassignTenantRequest",
                         key="acct:1").unassigned
        assert pair.call("DeleteTenant", "DeleteTenantRequest",
                         name="gold").deleted
        assert not pair.call("DeleteTenant", "DeleteTenantRequest",
                             name="gold").deleted
        code, _ = pair.call("AssignTenant", "AssignTenantRequest",
                            key="k", tenant="nope")
        assert code == grpc.StatusCode.INVALID_ARGUMENT
        j, t = ([(e["action"], e["actor"], e["payload"])
                 for e in mod.get().tail(category="tenant")["events"]]
                for mod in (jevents, tevents))
        assert t == j and len(t) == 5
        assert "acct:1" not in json.dumps(t)
    finally:
        pair.close()


def test_traceparent_and_deadline_reach_the_decide():
    """A ``traceparent`` entry samples the RPC into the flight recorder
    and its id rides into a trace-aware decide; the caller's deadline
    rides in as ``deadline`` (the residual budget): on both servers."""
    seen = {R: [], T: []}

    def server(M, mod, lim):
        def decide(key, n, trace_id=0, deadline=None):
            # The residual of the caller's 5 s budget (grpc measures it
            # on its own timer, which may read a few ms above 5).
            seen[M].append((trace_id, deadline is not None
                            and 0 < deadline < 6.0))
            return lim.allow_n(key, n)

        return mod.GrpcRateLimitServer(decide, lim.reset)

    pair = GrpcPair("exact", server=server)
    for mod in (jtracing, ttracing):
        mod.enable(256)
    tp = "00-0000000000000000000000000000abcd-00000000000000ef-01"
    try:
        for stub, pb2 in zip(pair.stubs, pair.pb2):
            stub["Allow"](pb2.AllowRequest(key="t"), timeout=5.0,
                          metadata=(("traceparent", tp),))
        assert seen[T] == seen[R] == [(0xabcd, True)]
        for mod in (jtracing, ttracing):
            spans = [s for s in mod.get().dump()
                     if s["stage"] == "grpc"]
            assert [s["trace_id"] for s in spans] == [0xabcd]
    finally:
        pair.close()


# ------------------------------------------------------------ descriptor


def test_descriptor_is_protocs_output(tmp_path):
    """The committed descriptor equals what ``protoc --python_out``
    embeds for api/proto/ratelimiter.proto (where protoc is installed)."""
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("protoc is not installed here")
    proto = os.path.join(REPO, "api", "proto")
    subprocess.run([protoc, f"--proto_path={proto}",
                    f"--python_out={tmp_path}", "ratelimiter.proto"],
                   check=True, capture_output=True, timeout=60)
    src = (tmp_path / "ratelimiter_pb2.py").read_text()
    lit = re.search(r"AddSerializedFile\((b'.*?')\)", src, re.S).group(1)
    assert ast.literal_eval(lit) == grpc_pb.SERIALIZED_FILE


def test_private_pool_beside_the_jax_module():
    """The port's classes live in a private pool: loading them beside
    the JAX package's generated module (in the default pool) clashes
    with nothing, the two are distinct classes, and every message type
    serializes to the same bytes from the same fields."""
    jpb, tpb = jgs._load_pb2(), grpc_pb.load()
    assert grpc_pb.load() is tpb
    assert tpb.AllowRequest is not jpb.AllowRequest
    assert sorted(tpb.DESCRIPTOR.message_types_by_name) == \
        sorted(jpb.DESCRIPTOR.message_types_by_name)
    assert tpb.DESCRIPTOR.services_by_name["RateLimiter"].full_name == \
        grpc_pb.SERVICE
    for name in tpb.DESCRIPTOR.message_types_by_name:
        jm, tm = getattr(jpb, name)(), getattr(tpb, name)()
        for f in tm.DESCRIPTOR.fields:
            repeated = (f.is_repeated if hasattr(f, "is_repeated")
                        else f.label == f.LABEL_REPEATED)
            if repeated or f.message_type is not None:
                continue
            v = {f.TYPE_STRING: "kéy", f.TYPE_BOOL: True,
                 f.TYPE_DOUBLE: 2.5}.get(f.type, 7)
            setattr(jm, f.name, v)
            setattr(tm, f.name, v)
        assert tm.SerializeToString() == jm.SerializeToString(), name
        assert getattr(jpb, name).FromString(
            tm.SerializeToString()) == jm


# ---------------------------------------------------------------- binary


def _binary(args: list):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                  if x])
    proc = subprocess.Popen(
        [sys.executable, "-m", "ratelimiter_tpu_torch.serving",
         "--device", "cpu", "--port", "0", "--grpc-port", "0", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    lines: list = []
    found = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                found.set()
        found.set()

    threading.Thread(target=read, daemon=True).start()
    if not found.wait(120) or not lines or \
            not lines[-1].startswith("serving"):
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError("binary did not start: " + "".join(lines[-20:]))
    line = lines[-1]
    port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
    gport = int(line.split("grpc:", 1)[1].split()[0])
    return proc, port, gport


@pytest.mark.parametrize("door", [[], ["--native", "--shards", "2"]],
                         ids=["asyncio", "native"])
def test_binary_grpc_answers_equal_the_binary_doors(door):
    """--grpc-port on the port's binary: gRPC and binary frames spend
    one key's quota (through the batcher, or the native door's shard
    router), a gRPC Reset reaches the key's shard, and gRPC's answers
    equal the binary door's for the same keys at the same limit."""
    from ratelimiter_tpu_torch.serving.client import Client

    pb2 = grpc_pb.load()
    proc, port, gport = _binary(
        ["--limit", "4", "--window", "60", "--sketch-depth", "3",
         "--sketch-width", "256", "--sub-windows", "6", *door])
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{gport}")
        stub = _stub(ch, pb2)
        with Client(port=port, timeout=30.0) as c:
            for k in ("mix0", "mix1", "mix2", "mix3"):
                assert c.allow_n(k, 2).allowed
                g = stub["AllowN"](pb2.AllowNRequest(key=k, n=2),
                                   timeout=TIMEOUT)
                assert g.allowed and g.remaining == 0
                b = c.allow(k)
                g = stub["Allow"](pb2.AllowRequest(key=k), timeout=TIMEOUT)
                assert not b.allowed and not g.allowed
                assert (g.limit, g.remaining, g.fail_open) == \
                    (b.limit, b.remaining, b.fail_open)
                stub["Reset"](pb2.ResetRequest(key=k), timeout=TIMEOUT)
                assert c.allow(k).allowed
            out = stub["AllowBatch"](pb2.AllowBatchRequest(items=[
                pb2.AllowBatchRequest.Item(key=f"bb{i % 3}", n=2)
                for i in range(7)]), timeout=TIMEOUT)
            assert [r.allowed for r in out.results] == \
                [True, True, True, True, True, True, False]
            assert c.allow("bb0").allowed is False
            # The native door counts the frames its C++ side served
            # (13 here), the asyncio door's batcher every decision.
            h = stub["Health"](pb2.HealthRequest(), timeout=TIMEOUT)
            assert h.serving and h.decisions_total >= 13
        ch.close()
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
