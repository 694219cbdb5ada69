"""gRPC adapter for the checked-in contract (api/proto/ratelimiter.proto),
a copy of ``ratelimiter_tpu/serving/grpc_server.py`` over the port's doors.

Each RPC maps onto the same decide/reset callables the HTTP gateway
uses, so the server binary fronts all three surfaces (binary protocol,
HTTP, gRPC) with one limiter: on the asyncio door through its
micro-batcher (``serving/__main__.make_threadsafe_decide`` and
``make_threadsafe_decide_many``), on the native door through its shard
router (``decide_one``/``decide_many``), so on the card every gRPC
decision runs the step's kernels. AllowBatch hands the whole frame to
``decide_many`` before any wait.

``grpcio`` is optional at import: ``grpc`` is imported in the
constructor, so the package imports without it. The message classes come
from the committed descriptor (``serving/grpc_pb.py``), not from
``protoc`` at first use as in the JAX server; the service is wired by
hand with ``grpc.method_handlers_generic_handler``, so no generated
stubs are needed.

Error mapping (the JAX server's):
  INVALID_ARGUMENT    <- InvalidKeyError, InvalidNError, InvalidConfigError
  DEADLINE_EXCEEDED   <- DeadlineExceededError
  UNAVAILABLE         <- StorageUnavailableError (fail-closed path)
  FAILED_PRECONDITION <- ClosedError
  UNIMPLEMENTED       <- NotImplementedError (and RPCs not wired: the
                         tenant RPCs without a hierarchy)
  INTERNAL            <- anything else

A ``traceparent`` metadata entry samples the RPC into the flight
recorder and rides into trace-aware decide callables;
``context.time_remaining()`` rides into deadline-aware ones.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ratelimiter_tpu_torch.core.errors import (
    ClosedError,
    DeadlineExceededError,
    InvalidConfigError,
    InvalidKeyError,
    InvalidNError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import Result
from ratelimiter_tpu_torch.observability import events, tracing
from ratelimiter_tpu_torch.ops.hashing import key_token as _key_token
from ratelimiter_tpu_torch.serving import grpc_pb

log = logging.getLogger("ratelimiter_tpu_torch.serving.grpc")


def grpc_available() -> bool:
    """True when the grpcio runtime and protobuf import here (the
    descriptor is committed: no protoc is needed)."""
    try:
        import grpc  # noqa: F401
        import google.protobuf  # noqa: F401
    except ImportError:
        return False
    return True


def _to_pb(pb2, res: Result):
    return pb2.AllowResponse(
        allowed=bool(res.allowed), limit=int(res.limit),
        remaining=int(res.remaining), retry_after=float(res.retry_after),
        reset_at=float(res.reset_at), fail_open=bool(res.fail_open))


class GrpcRateLimitServer:
    """grpcio server over decide/reset callables (the same transport-
    agnostic shape as HttpGateway, so it wires to a raw limiter, the
    micro-batcher, or the native door's shard router unchanged)."""

    def __init__(self, decide: Callable[[str, int], Result],
                 reset: Callable[[str], None], *,
                 host: str = "127.0.0.1", port: int = 0,
                 decisions_total: Optional[Callable[[], int]] = None,
                 max_workers: int = 8,
                 decide_many: Optional[Callable] = None,
                 policy: Optional[tuple] = None,
                 default_limit: Optional[Callable[[], int]] = None,
                 tenants: Optional[object] = None):
        """``decide_many``: optional bulk callable ``[(key, n), ...] ->
        [Result, ...]`` (request order). When wired, AllowBatch submits
        the WHOLE frame to the micro-batcher before waiting, so an
        N-item RPC costs O(1) coalesced dispatches instead of N
        sequential submit-wait round-trips. ``policy``: optional
        ``(set_override, get_override, delete_override)`` triple
        enabling the override RPCs; ``default_limit`` supplies the
        default-tier limit GetOverride reports on a miss. ``tenants``:
        optional hierarchy surface (TenantTable / HierarchyFanout)
        enabling the tenant CRUD RPCs — mutations are journaled with
        ``actor="grpc"`` mirroring the HTTP twin's /v1/tenants."""
        import grpc
        from concurrent import futures

        pb2 = grpc_pb.load()
        self.decide = decide
        self.decide_many = decide_many
        self.reset = reset
        # Trace context (ADR-014): callers propagate W3C traceparent as
        # gRPC metadata; trace-aware decide callables (the in-repo
        # doors) receive the id, plain lambdas keep working.
        from ratelimiter_tpu_torch.serving.http_gateway import (
            _accepts_kw,
            _accepts_trace,
        )

        self._decide_trace = _accepts_trace(decide)
        self._decide_deadline = _accepts_kw(decide, "deadline")
        self._trace_ctx = threading.local()
        self._default_limit = default_limit or (lambda: 0)
        self._decisions_total = decisions_total or (lambda: 0)
        self._started_at = time.time()
        grpc_mod = grpc

        def guard(fn):
            """Run one RPC body, mapping core errors to gRPC status.
            A ``traceparent`` metadata entry samples the RPC into the
            flight recorder (ADR-014) and rides into trace-aware decide
            callables via the thread-local ``_trace_ctx``."""
            def wrapped(request, context):
                tid = 0
                rec = tracing.RECORDER
                if rec is not None:
                    try:
                        meta = dict(context.invocation_metadata())
                        tid = tracing.parse_traceparent(
                            meta.get("traceparent"))
                    except Exception:  # noqa: BLE001 — attribution only
                        tid = 0
                t0 = tracing.now() if rec is not None else 0
                self._trace_ctx.tid = tid
                # gRPC deadlines propagate natively: time_remaining()
                # is the caller's residual budget (None = no deadline).
                # Deadline-aware decide callables shed expired work per
                # the server's fail-open/closed policy (ADR-015).
                try:
                    self._trace_ctx.budget = context.time_remaining()
                except Exception:  # noqa: BLE001 — optional surface
                    self._trace_ctx.budget = None
                try:
                    out = fn(request)
                    if rec is not None:
                        rec.record("grpc", t0, tracing.now(), trace_id=tid)
                    return out
                except (InvalidKeyError, InvalidNError,
                        InvalidConfigError) as exc:
                    context.abort(grpc_mod.StatusCode.INVALID_ARGUMENT,
                                  str(exc))
                except DeadlineExceededError as exc:
                    context.abort(grpc_mod.StatusCode.DEADLINE_EXCEEDED,
                                  str(exc))
                except StorageUnavailableError as exc:
                    context.abort(grpc_mod.StatusCode.UNAVAILABLE, str(exc))
                except ClosedError as exc:
                    context.abort(grpc_mod.StatusCode.FAILED_PRECONDITION,
                                  str(exc))
                except NotImplementedError as exc:
                    context.abort(grpc_mod.StatusCode.UNIMPLEMENTED, str(exc))
                except Exception as exc:  # noqa: BLE001 — typed INTERNAL
                    log.exception("grpc internal error")
                    context.abort(grpc_mod.StatusCode.INTERNAL, str(exc))
            return wrapped

        def call_decide(key, n):
            tid = getattr(self._trace_ctx, "tid", 0)
            budget = getattr(self._trace_ctx, "budget", None)
            kwargs = {}
            if tid and self._decide_trace:
                kwargs["trace_id"] = tid
            if budget is not None and self._decide_deadline:
                kwargs["deadline"] = budget
            return self.decide(key, n, **kwargs)

        def allow(req):
            return _to_pb(pb2, call_decide(req.key, 1))

        def allow_n(req):
            return _to_pb(pb2, call_decide(req.key, int(req.n)))

        def allow_batch(req):
            # Request order is preserved either way; in-batch same-key
            # sequencing is the decide callable's contract. n=0 (incl.
            # proto3-unset) maps to InvalidN exactly like the binary
            # protocol's ALLOW_BATCH items.
            pairs = [(it.key, int(it.n)) for it in req.items]
            if self.decide_many is not None:
                # One bulk submission: all items coalesce into shared
                # device dispatches instead of N sequential round-trips.
                results = self.decide_many(pairs)
            else:
                results = [self.decide(k, n) for k, n in pairs]
            return pb2.AllowBatchResponse(
                results=[_to_pb(pb2, r) for r in results])

        def do_reset(req):
            self.reset(req.key)
            # Control-plane journal (ADR-021): the gRPC door records
            # the same mutation events as the HTTP/binary doors, so an
            # incident reconstruction never depends on WHICH surface
            # the operator used. Hashed key tokens only (OPERATIONS §6).
            events.emit("policy", "reset", actor="grpc",
                        payload={"key_hash": _key_token(req.key)})
            return pb2.ResetResponse()

        def health(_req):
            return pb2.HealthResponse(
                serving=True, uptime_seconds=time.time() - self._started_at,
                decisions_total=int(self._decisions_total()))

        rpcs = {
            "Allow": (allow, pb2.AllowRequest),
            "AllowN": (allow_n, pb2.AllowNRequest),
            "AllowBatch": (allow_batch, pb2.AllowBatchRequest),
            "Reset": (do_reset, pb2.ResetRequest),
            "Health": (health, pb2.HealthRequest),
        }

        if policy is not None:
            p_set, p_get, p_del = policy

            def set_override(req):
                ov = p_set(req.key,
                           int(req.limit) if req.limit else None,
                           window_scale=(req.window_scale
                                         if req.window_scale else 1.0))
                events.emit("policy", "set-override", actor="grpc",
                            payload={"key_hash": _key_token(req.key),
                                     "limit": int(ov.limit),
                                     "window_scale":
                                         float(ov.window_scale)})
                return pb2.OverrideResponse(
                    found=True, key=req.key, limit=int(ov.limit),
                    window_scale=float(ov.window_scale))

            def get_override(req):
                ov = p_get(req.key)
                if ov is None:
                    # Proto contract (and binary-protocol parity): a miss
                    # carries the DEFAULT tier values, not proto3 zeros.
                    return pb2.OverrideResponse(
                        found=False, key=req.key,
                        limit=int(self._default_limit()), window_scale=1.0)
                return pb2.OverrideResponse(
                    found=True, key=req.key, limit=int(ov.limit),
                    window_scale=float(ov.window_scale))

            def delete_override(req):
                deleted = bool(p_del(req.key))
                events.emit("policy", "delete-override", actor="grpc",
                            payload={"key_hash": _key_token(req.key),
                                     "deleted": deleted})
                return pb2.DeleteOverrideResponse(deleted=deleted)

            rpcs.update({
                "SetOverride": (set_override, pb2.SetOverrideRequest),
                "GetOverride": (get_override, pb2.GetOverrideRequest),
                "DeleteOverride": (delete_override,
                                   pb2.DeleteOverrideRequest),
            })

        if tenants is not None:
            hier = tenants

            def set_tenant(req):
                t = hier.set_tenant(
                    req.name,
                    int(req.limit) if req.limit else None,
                    weight=int(req.weight) if req.weight else 1,
                    floor=int(req.floor) if req.floor else None)
                events.emit("tenant", "set", actor="grpc",
                            payload={"name": req.name,
                                     "limit": int(t.limit),
                                     "weight": int(t.weight),
                                     "floor": int(t.floor)})
                return pb2.TenantResponse(
                    found=True, name=req.name, tid=int(t.tid),
                    limit=int(t.limit), weight=int(t.weight),
                    floor=int(t.floor))

            def get_tenant(req):
                t = hier.get_tenant(req.name)
                if t is None:
                    return pb2.TenantResponse(found=False, name=req.name)
                return pb2.TenantResponse(
                    found=True, name=req.name, tid=int(t.tid),
                    limit=int(t.limit), weight=int(t.weight),
                    floor=int(t.floor))

            def delete_tenant(req):
                deleted = bool(hier.delete_tenant(req.name))
                events.emit("tenant", "delete", actor="grpc",
                            payload={"name": req.name,
                                     "deleted": deleted})
                return pb2.DeleteTenantResponse(deleted=deleted)

            def assign_tenant(req):
                hier.assign_tenant(req.key, req.tenant)
                events.emit("tenant", "assign", actor="grpc",
                            payload={"key_hash": _key_token(req.key),
                                     "tenant": req.tenant})
                return pb2.AssignTenantResponse()

            def unassign_tenant(req):
                unassigned = bool(hier.unassign_tenant(req.key))
                events.emit("tenant", "unassign", actor="grpc",
                            payload={"key_hash": _key_token(req.key),
                                     "unassigned": unassigned})
                return pb2.UnassignTenantResponse(unassigned=unassigned)

            rpcs.update({
                "SetTenant": (set_tenant, pb2.SetTenantRequest),
                "GetTenant": (get_tenant, pb2.GetTenantRequest),
                "DeleteTenant": (delete_tenant, pb2.DeleteTenantRequest),
                "AssignTenant": (assign_tenant, pb2.AssignTenantRequest),
                "UnassignTenant": (unassign_tenant,
                                   pb2.UnassignTenantRequest),
            })
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                guard(fn), request_deserializer=req_cls.FromString,
                response_serializer=lambda resp: resp.SerializeToString())
            for name, (fn, req_cls) in rpcs.items()
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(pb2.SERVICE, handlers),))
        self.host = host
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    def start(self) -> None:
        self._server.start()
        log.info("grpc server listening on %s:%d", self.host, self.port)

    def shutdown(self, grace: float = 5.0) -> None:
        self._server.stop(grace).wait()


def grpc_server_for_limiter(limiter, *, host: str = "127.0.0.1",
                            port: int = 0) -> GrpcRateLimitServer:
    """Standalone embedding (mirror of gateway_for_limiter)."""
    def decide_many(pairs):
        out = limiter.allow_batch([k for k, _ in pairs],
                                  [n for _, n in pairs])
        return out.results()

    return GrpcRateLimitServer(
        lambda key, n: limiter.allow_n(key, n), limiter.reset,
        host=host, port=port, decide_many=decide_many,
        policy=(limiter.set_override, limiter.get_override,
                limiter.delete_override),
        default_limit=lambda: limiter.config.limit)
