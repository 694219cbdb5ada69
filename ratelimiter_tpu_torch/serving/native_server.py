"""Python bridge for the native (C++) front door: the port's copy of
``ratelimiter_tpu/serving/native_server.py``.

The C++ extension (native/server.cpp) owns sockets, frame parsing,
micro-batch coalescing and reply encoding in GIL-free threads; Python is
entered once per batched dispatch through the callbacks this module
builds. Same protocol, same answers as the asyncio door
(serving/server.py), which stays the reference; this is the throughput
path.

Hot path: string frames reach the launch callback as four flat buffers
(key blob with the key prefix already prepended, offsets, lengths, ns);
the keys never become Python strings: the blob is bulk-hashed by the C++
hasher (``native.hash_packed``) and the hashes go to ``launch_hashed``.
Hashed-lane frames (ALLOW_HASHED) arrive as ids the C++ io threads have
already finalized with splitmix64, so they too go to ``launch_hashed``
(the front's hashed form, not the raw-id one the asyncio door runs).
Backends without the hashed surface (dense, exact) decode the keys and
use ``allow_batch`` through the blocking decide.

Pipelined mode (the default for sketch backends without an SLO): the
C++ dispatcher calls ``launch`` (stage and enqueue the step, no wait)
and a C++ completer calls ``resolve`` on the oldest ticket in flight,
which waits on the ticket's CUDA event with the GIL released; up to
``inflight`` launches overlap per shard. Both run on threads Python did
not start, through ``PyGILState_Ensure``. Every limiter call passes
through the shard's lock, and each limiter was built with its device
given explicitly (the current device is per thread).

Left out against the JAX bridge: the fleet, DCN, leases, mesh slices and
quarantine (ROADMAP A8, A13d).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ratelimiter_tpu_torch import native
from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.errors import DeadlineExceededError
from ratelimiter_tpu_torch.core.types import fail_open_result
from ratelimiter_tpu_torch.observability import audit, tracing
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability.decorators import undecorated
from ratelimiter_tpu_torch.ops.hashing import splitmix64
from ratelimiter_tpu_torch.serving import protocol as p

#: The door's ABI, also /healthz ``member.abi`` under ``--native``.
_ABI = native.SERVER_ABI


def fnv_shard(key: str, n_shards: int) -> int:
    """The C++ door's string router (server.cpp ``key_shard``): FNV-1a
    over the key's UTF-8 bytes, mod ``n_shards``. The constants are
    server.cpp's, bit for bit: only C++/Python agreement matters (a
    mismatch gives a key two quotas)."""
    if n_shards == 1:
        return 0
    h = 1469598103934665603
    for b in key.encode("utf-8"):
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h % n_shards


class _BridgeError(Exception):
    """Carries a protocol error code for the C++ layer (read as
    ``rl_code``)."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.rl_code = code


class NativeRateLimitServer:
    """Sibling of RateLimitServer backed by the C++ front door.

    Args mirror RateLimitServer, including ``dispatch_timeout``: a C++
    watcher thread answers waiters per the limiter's fail-open/closed
    policy when one batched dispatch exceeds the SLO, while the Python
    decide completes in the background. The ``limit``/``window`` stamped
    into fail-open answers follow this server's ``update_limit`` and
    ``update_window`` (pushed to the C++ atomics).

    ``inflight`` (default 8; above 1 with a sketch-family limiter and no
    ``dispatch_timeout``) turns on the pipelined launch/resolve path.

    ``shards`` > 1 mounts that many dispatch shards, keys routed by
    FNV-1a (strings) or the finalized hash (the hashed lane): shard 0
    decides on ``limiter``, the others on clones built from its config,
    clock and device (with the cascade, the same per-shard share of the
    tenant and global limits), each wrapped by ``shard_decorate(clone,
    i)`` when given (the binary's decorator stack under the shard's
    label). ``shard_limiters`` instead mounts pre-built shard limiters
    (``limiter`` must be its first). The build of the extension raises,
    with the compiler's message, when it fails: there is no fallback to
    the asyncio door.
    """

    def __init__(self, limiter: RateLimiter, host: str = "127.0.0.1",
                 port: int = 0, *, max_batch: int = 4096,
                 max_delay: float = 200e-6,
                 dispatch_timeout: Optional[float] = None,
                 inflight: int = 8,
                 registry: Optional[m.Registry] = None,
                 shards: int = 1, shard_decorate=None,
                 shard_limiters: Optional[list] = None,
                 shm: bool = False, shm_dir: str = "/dev/shm",
                 shm_ring_bytes: int = 0,
                 net_engine: str = "auto", io_rings: int = 0):
        ext = native.load_server()
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self.limiter = limiter
        self.host = host
        self.port = port
        self.registry = registry if registry is not None else m.DEFAULT
        self._batch_hist = self.registry.histogram(
            "rate_limiter_server_batch_size",
            "Decisions per batched dispatch", m.BATCH_BUCKETS)
        self._inflight_gauge = self.registry.gauge(
            "rate_limiter_pipeline_inflight",
            "Launched device dispatches not yet resolved (pipelined "
            "serving hot path, ADR-010)")
        self._launch_hist = self.registry.histogram(
            "rate_limiter_pipeline_launch_seconds",
            "Launch phase wall time (stage + enqueue, non-blocking)",
            m.LATENCY_BUCKETS)
        self._resolve_hist = self.registry.histogram(
            "rate_limiter_pipeline_resolve_seconds",
            "Resolve phase wall time (block on the oldest in-flight "
            "result + host conversion)", m.LATENCY_BUCKETS)
        self._depth = 0
        self._depth_lock = threading.Lock()

        # The hashed surface, detected on the UNDECORATED backend (the
        # decorators delegate it, so hasattr on the stack is always true).
        base = undecorated(limiter)
        self._fast = hasattr(base, "allow_hashed")
        prefix = limiter.config.prefix
        self._prefix_bytes = (f"{prefix}:".encode() if prefix else b"")

        if shard_limiters is not None:
            if shards not in (1, len(shard_limiters)):
                raise ValueError(
                    f"shards={shards} disagrees with "
                    f"{len(shard_limiters)} supplied shard limiters")
            shards = len(shard_limiters)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > 1 and dispatch_timeout is not None:
            raise ValueError("dispatch_timeout requires shards == 1")
        if shards > 1 and not self._fast:
            # Clones are rebuilt from (config, clock, device) alone; a
            # backend with more constructor state (the dense backend's
            # capacity) would diverge between shards.
            raise ValueError(
                "shards > 1 requires a sketch-family limiter (its state "
                "is fully determined by the config)")
        if shard_limiters is not None:
            self._shard_limiters = list(shard_limiters)
        else:
            self._shard_limiters = [limiter]
            for i in range(1, shards):
                kw = {}
                if getattr(base, "_hier_table", None) is not None:
                    # Every clone enforces the same per-shard share of
                    # the tenant and global limits as the base (keys
                    # hash-route, shards share no counters).
                    kw["hier_divisor"] = base._hier_table.divisor
                clone = type(base)(base.config, clock=base.clock,
                                   device=base.device, **kw)
                self._shard_limiters.append(
                    shard_decorate(clone, i) if shard_decorate else clone)
        self._locks = [threading.Lock() for _ in range(shards)]

        # Pipelined launch/resolve needs the hashed surface (the launch
        # must not block, which the string slow path's allow_batch does)
        # and no SLO (the C++ watcher assumes one dispatch in flight);
        # otherwise the blocking decide runs.
        self.inflight = inflight
        self._pipelined = bool(self._fast and dispatch_timeout is None
                               and inflight > 1)
        self._server = ext.create_server(
            decide=self._decide, reset=self._reset, metrics=self._metrics,
            max_batch=max_batch, max_delay_us=int(max_delay * 1e6),
            slo_us=int(dispatch_timeout * 1e6) if dispatch_timeout else 0,
            fail_open=bool(limiter.config.fail_open),
            limit=int(limiter.config.limit),
            window_s=float(limiter.config.window),
            # The fast path hashes "prefix:key" bytes the C++ blob
            # builder made; the slow path's allow_batch applies the
            # prefix itself, so C++ must not.
            key_prefix=self._prefix_bytes if self._fast else b"",
            num_shards=shards,
            launch=self._launch if self._pipelined else None,
            resolve=self._resolve if self._pipelined else None,
            # The hashed lane: C++ finalizes raw ids with splitmix64 on
            # its io threads and hands the columnar buffers over.
            decide_hashed=self._decide_hashed if self._fast else None,
            launch_hashed=(self._launch_hashed_cb
                           if self._pipelined else None),
            # Per-ticket stage stamps from the completer into the
            # flight recorder (one None check a dispatch when off).
            spans=self._spans if self._pipelined else None,
            inflight=inflight,
            shm=bool(shm), shm_dir=str(shm_dir),
            shm_ring_bytes=int(shm_ring_bytes),
            net_engine=str(net_engine), io_rings=int(io_rings))
        self.net_engine = str(net_engine)
        self.io_rings = int(io_rings)
        self.shm = bool(shm)
        self.shm_dir = str(shm_dir)
        self.shm_ring_bytes = int(shm_ring_bytes)
        self.registry.add_collect_hook(self._collect_transport_metrics)

    # ------------------------------------------------------------ callbacks

    @staticmethod
    def _hash_buffers(blob: bytes, offsets_b: bytes, lengths_b: bytes,
                      ns_b: bytes):
        """C++ buffers -> (h64, ns): the C++ hasher over the prefixed
        blob, no Python string made."""
        offsets = np.frombuffer(offsets_b, dtype=np.int64)
        lengths = np.frombuffer(lengths_b, dtype=np.int64)
        ns = np.frombuffer(ns_b, dtype=np.int64)
        buf = np.frombuffer(blob, dtype=np.uint8)
        return native.hash_packed(buf, offsets, lengths), ns

    @staticmethod
    def _pack_result(out):
        flags = out.allowed.astype(np.uint8)
        if out.fail_open:
            flags |= 2
        return (flags.tobytes(),
                np.ascontiguousarray(out.remaining, dtype=np.int64).tobytes(),
                np.ascontiguousarray(out.retry_after,
                                     dtype=np.float64).tobytes(),
                np.ascontiguousarray(out.reset_at, dtype=np.float64).tobytes(),
                int(out.limit))

    def _spans(self, shard: int, count: int, trace_id: int, t_io: int,
               t_d0: int, t_d1: int, t_v0: int, t_v1: int):
        """Per-ticket CLOCK_MONOTONIC stage stamps from the C++ completer
        (io: enqueue to drain; dispatch: drain to launch returned;
        device: the resolve's wait; complete: resolve to now) into the
        flight recorder, on the completer thread. Same clock domain as
        ``tracing.now()``."""
        rec = tracing.RECORDER
        if rec is None:
            return
        if t_io and t_d0 >= t_io:
            rec.record("io", t_io, t_d0, trace_id=trace_id, shard=shard,
                       batch=count)
        rec.record("dispatch", t_d0, t_d1, trace_id=trace_id, shard=shard,
                   batch=count)
        rec.record("device", t_v0, t_v1, trace_id=trace_id, shard=shard,
                   batch=count)
        rec.record("complete", t_v1, tracing.now(), trace_id=trace_id,
                   shard=shard, batch=count)

    def _decide(self, shard: int, blob: bytes, offsets_b: bytes,
                lengths_b: bytes, ns_b: bytes, trace_id: int = 0):
        """Blocking decide of a string run (the SLO mode, and backends
        without the hashed surface)."""
        b = len(offsets_b) // 8
        lim = self._shard_limiters[shard]
        aud = audit.AUDITOR
        # The decision's time, read BEFORE the decide (the backend reads
        # its clock at launch); audit off skips even this.
        t_dec = lim.clock.now() if aud is not None else 0.0
        try:
            if self._fast:
                h64, ns = self._hash_buffers(blob, offsets_b, lengths_b,
                                             ns_b)
                with self._locks[shard]:
                    out = lim.allow_hashed(h64, ns)
                if aud is not None:
                    # h64 is the finalized string hash (the prefix is in
                    # the blob), so the hashed offer is exact.
                    aud.offer_hashed(h64, ns, t_dec, out, slice_idx=shard)
            else:
                offsets = np.frombuffer(offsets_b, dtype=np.int64)
                lengths = np.frombuffer(lengths_b, dtype=np.int64)
                ns = np.frombuffer(ns_b, dtype=np.int64)
                keys = [blob[o:o + n].decode("utf-8")
                        for o, n in zip(offsets.tolist(), lengths.tolist())]
                with self._locks[shard]:
                    out = lim.allow_batch(keys, ns.tolist())
                if aud is not None:
                    aud.offer_keys(keys, ns, t_dec, out, slice_idx=shard)
        except Exception as exc:
            raise _BridgeError(p.code_for(exc), str(exc)) from exc
        self._batch_hist.observe(float(b))
        return self._pack_result(out)

    def _decide_hashed(self, shard: int, ids_b: bytes, ns_b: bytes,
                       trace_id: int = 0):
        """Blocking decide of a hashed run: the buffers are finalized
        u64 hashes (C++ splitmix64), so no host hash math."""
        b = len(ids_b) // 8
        lim = self._shard_limiters[shard]
        aud = audit.AUDITOR
        t_dec = lim.clock.now() if aud is not None else 0.0
        try:
            h64 = np.frombuffer(ids_b, dtype=np.uint64)
            ns = np.frombuffer(ns_b, dtype=np.int64)
            with self._locks[shard]:
                out = lim.allow_hashed(h64, ns)
        except Exception as exc:
            raise _BridgeError(p.code_for(exc), str(exc)) from exc
        if aud is not None:
            aud.offer_hashed(h64, ns, t_dec, out, slice_idx=shard)
        self._batch_hist.observe(float(b))
        return self._pack_result(out)

    def _launched(self, shard: int, h64: np.ndarray, ns: np.ndarray,
                  trace_id: int, t0: float):
        """Launch finalized hashes on the shard's limiter (no wait) and
        return the ticket, tagged for the resolve."""
        lim = self._shard_limiters[shard]
        try:
            with self._locks[shard]:
                ticket = lim.launch_hashed(h64, ns)
        except Exception as exc:
            raise _BridgeError(p.code_for(exc), str(exc)) from exc
        ticket.trace_id = trace_id
        if audit.AUDITOR is not None:
            # The frame's hashes ride the ticket to the resolve's tap
            # (the frombuffer views keep the bytes alive).
            ticket.audit = (h64, ns)
        with self._depth_lock:
            self._depth += 1
            self._inflight_gauge.set(float(self._depth))
        self._launch_hist.observe(time.perf_counter() - t0)
        return ticket

    def _launch_hashed_cb(self, shard: int, ids_b: bytes, ns_b: bytes,
                          trace_id: int = 0):
        """Hashed-lane launch (pipelined): stage and enqueue, no wait."""
        t0 = time.perf_counter()
        return self._launched(shard, np.frombuffer(ids_b, dtype=np.uint64),
                              np.frombuffer(ns_b, dtype=np.int64),
                              trace_id, t0)

    def _launch(self, shard: int, blob: bytes, offsets_b: bytes,
                lengths_b: bytes, ns_b: bytes, trace_id: int = 0):
        """String-lane launch (pipelined): hash, stage and enqueue the
        step without waiting; the ticket comes back through ``_resolve``
        on the completer thread."""
        t0 = time.perf_counter()
        try:
            h64, ns = self._hash_buffers(blob, offsets_b, lengths_b, ns_b)
        except Exception as exc:
            raise _BridgeError(p.code_for(exc), str(exc)) from exc
        return self._launched(shard, h64, ns, trace_id, t0)

    def _resolve(self, shard: int, ticket):
        """Wait for the oldest launch in flight (GIL released while the
        card drains) and hand the flat result buffers to the C++
        responder."""
        t0 = time.perf_counter()
        lim = self._shard_limiters[shard]
        try:
            out = lim.resolve(ticket)
        except Exception as exc:
            raise _BridgeError(p.code_for(exc), str(exc)) from exc
        finally:
            with self._depth_lock:
                self._depth -= 1
                self._inflight_gauge.set(float(self._depth))
        aud = audit.AUDITOR
        if aud is not None and ticket.audit is not None:
            # On the completer: a shard resolves in launch order, so the
            # shadow oracle sees each key's timeline in decision order.
            # The time is the ticket's launch-time now, the one the
            # sketch decided with.
            h64, ns = ticket.audit
            aud.offer_hashed(h64, ns, ticket.t_sec or lim.clock.now(),
                             out, slice_idx=shard)
        self._resolve_hist.observe(time.perf_counter() - t0)
        self._batch_hist.observe(float(len(out)))
        return self._pack_result(out)

    def _reset(self, shard: int, key_bytes: bytes) -> None:
        try:
            with self._locks[shard]:
                self._shard_limiters[shard].reset(key_bytes.decode("utf-8"))
        except Exception as exc:
            raise _BridgeError(p.code_for(exc), str(exc)) from exc

    def _metrics(self) -> bytes:
        return self.registry.render().encode()

    # ----------------------------------------------- key-routed side doors

    def shard_of(self, key: str) -> int:
        """Python mirror of the C++ FNV-1a shard router (server.cpp
        ``key_shard``): side doors (the HTTP gateway, embedding) route
        through it, so a key's quota lives on one shard whatever surface
        served it."""
        return fnv_shard(key, len(self._shard_limiters))

    def shard_of_id(self, raw_id: int) -> int:
        """Python mirror of the C++ hashed-lane router: the finalized
        splitmix64(id) mod shards."""
        n_shards = len(self._shard_limiters)
        if n_shards == 1:
            return 0
        return int(splitmix64(np.asarray([raw_id], np.uint64))[0]
                   % n_shards)

    def decide_one(self, key: str, n: int = 1, *, trace_id: int = 0,
                   deadline=None):
        """One key's decision on its dispatch shard: the HTTP gateway's
        decide under ``--native``. Each call is a synchronous batch of
        one, serialized with the shard's wire windows (the C++ batcher
        owns the coalescing window, which this path cannot join).

        ``trace_id``: a sampled gateway request records its dispatch
        into the flight recorder under the shard. ``deadline`` (relative
        seconds): an expired budget is shed, answered per the limiter's
        fail-open/closed policy without a dispatch."""
        if deadline is not None and float(deadline) <= 0.0:
            cfg = self.limiter.config
            if cfg.fail_open:
                return fail_open_result(
                    cfg.limit, self.limiter.clock.now() + float(cfg.window))
            raise DeadlineExceededError(
                "request deadline expired before dispatch")
        shard = self.shard_of(key)
        lim = self._shard_limiters[shard]
        rec = tracing.RECORDER
        aud = audit.AUDITOR
        t_dec = lim.clock.now() if aud is not None else 0.0
        t0 = tracing.now() if rec is not None else 0
        with self._locks[shard]:
            res = lim.allow_n(key, n)
        if rec is not None:
            rec.record("device", t0, tracing.now(), trace_id=trace_id,
                       shard=shard)
        if aud is not None:
            aud.offer_keys([key], [n], t_dec, res, slice_idx=shard)
        return res

    def reset_one(self, key: str) -> None:
        """Reset on the key's dispatch shard (another shard's reset of it
        would subtract colliding keys' mass)."""
        shard = self.shard_of(key)
        with self._locks[shard]:
            self._shard_limiters[shard].reset(key)

    def decide_many(self, pairs):
        """Bulk decide grouped by owning shard: one ``allow_batch`` per
        touched shard (a key's requests stay in frame order on its
        shard), results back in request order."""
        pairs = list(pairs)
        by_shard: dict = {}
        for i, (key, n) in enumerate(pairs):
            by_shard.setdefault(self.shard_of(key), []).append((i, key, n))
        results = [None] * len(pairs)
        for shard, items in by_shard.items():
            with self._locks[shard]:
                out = self._shard_limiters[shard].allow_batch(
                    [k for _, k, _ in items], [n for _, _, n in items])
            for (i, _, _), res in zip(items, out.results()):
                results[i] = res
        return results

    # ------------------------------------------------- dynamic config

    def refresh_fail_open_params(self) -> None:
        """Push the live default limit and window into the C++ door's
        fail-open stamp. The C++ side also takes the limit from every
        completed dispatch; the window moves only through this push."""
        cfg = undecorated(self._shard_limiters[0]).config
        self._server.set_limits(int(cfg.limit), float(cfg.window))

    def update_limit(self, new_limit: int) -> None:
        """A limit change on EVERY shard limiter, then pushed to the C++
        fail-open stamp."""
        for shard, lim in enumerate(self._shard_limiters):
            with self._locks[shard]:
                lim.update_limit(new_limit)
        self.refresh_fail_open_params()

    def update_window(self, new_window: float) -> None:
        """A window change on every shard, then the C++ stamp."""
        for shard, lim in enumerate(self._shard_limiters):
            with self._locks[shard]:
                lim.update_window(new_window)
        self.refresh_fail_open_params()

    # ------------------------------------------------- policy management

    def set_override_all(self, key: str, limit=None, *,
                         window_scale: float = 1.0):
        """An override on EVERY shard limiter: keys hash-route, so the
        owning shard must have it, and the others never query it."""
        ov = None
        for shard, lim in enumerate(self._shard_limiters):
            with self._locks[shard]:
                ov = lim.set_override(key, limit, window_scale=window_scale)
        return ov

    def get_override_one(self, key: str):
        shard = self.shard_of(key)
        with self._locks[shard]:
            return self._shard_limiters[shard].get_override(key)

    def delete_override_all(self, key: str) -> bool:
        existed = False
        for shard, lim in enumerate(self._shard_limiters):
            with self._locks[shard]:
                existed = lim.delete_override(key) or existed
        return existed

    @property
    def shard_limiters(self):
        """All shard limiters (index 0 is the caller's)."""
        return list(self._shard_limiters)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.port = self._server.start(self.host, self.port)

    def shutdown(self, *, close_limiters: bool = True) -> None:
        """Stop the C++ door (it answers what is in flight first) and, by
        default, close the owned shard clones. ``close_limiters=False``
        keeps them for a final snapshot; ``close_shards()`` after it."""
        self.registry.remove_collect_hook(self._collect_transport_metrics)
        self._server.shutdown()
        if close_limiters:
            self.close_shards()

    def close_shards(self) -> None:
        # The shards past the caller's limiter are owned here.
        for lim in self._shard_limiters[1:]:
            lim.close()

    def stats(self) -> dict:
        return self._server.stats()

    def transport_stats(self) -> dict:
        """RateLimitServer.transport_stats's shape, plus the network
        engine's record (``net``: the engine that runs, the ring count,
        the io_uring probe's verdict and the syscall counters). The C++
        io threads own the counters; this is a snapshot read."""
        st = self._server.stats()
        sh = dict(st.get("shm", {}))
        # The C++ door does not sample live ring occupancy (the io
        # threads own the rings); 0 keeps the gauge set uniform.
        sh.setdefault("req_ring_used_bytes", 0)
        sh.setdefault("rep_ring_used_bytes", 0)
        return {"connections": dict(st.get("transport", {})), "shm": sh,
                "net": dict(st.get("net", {}))}

    def _collect_transport_metrics(self) -> None:
        st = self.transport_stats()
        g = self.registry.gauge(
            "rate_limiter_transport_connections",
            "Connections accepted per transport (cumulative)")
        for k, v in st["connections"].items():
            g.set(v, transport=k)
        sh = st["shm"]
        self.registry.gauge(
            "rate_limiter_shm_lanes_active",
            "Live shared-memory lanes (ADR-025)").set(sh["lanes_active"])
        self.registry.gauge(
            "rate_limiter_shm_doorbell_wakes",
            "eventfd wakeups taken by shm ring consumers").set(
                sh["doorbell_wakes"])
        self.registry.gauge(
            "rate_limiter_shm_spin_hits",
            "shm records claimed during the bounded spin (no syscall)"
        ).set(sh["spin_hits"])
        self.registry.gauge(
            "rate_limiter_shm_ring_full_stalls",
            "shm ring-full backpressure stalls").set(
                sh["ring_full_stalls"])
        rg = self.registry.gauge(
            "rate_limiter_shm_records",
            "Frames carried over shm rings, by direction")
        rg.set(sh["records_in"], direction="in")
        rg.set(sh["records_out"], direction="out")
        ug = self.registry.gauge(
            "rate_limiter_shm_ring_used_bytes",
            "Current shm ring occupancy, summed over lanes")
        ug.set(sh["req_ring_used_bytes"], ring="req")
        ug.set(sh["rep_ring_used_bytes"], ring="rep")
        hg = self.registry.gauge(
            "rate_limiter_shm_ring_highwater_bytes",
            "High-water shm ring occupancy across lanes")
        hg.set(sh["req_ring_highwater_bytes"], ring="req")
        hg.set(sh["rep_ring_highwater_bytes"], ring="rep")
        net = st.get("net", {})
        if net:
            self.registry.gauge(
                "rate_limiter_net_engine_info",
                "Network engine identity (value 1): labels engine "
                "(epoll/uring), rings, probe (pass/fail/off)").set(
                    1, engine=net.get("engine", "epoll"),
                    rings=str(net.get("rings", 0)),
                    probe=net.get("uring_probe", "off"))
            sg = self.registry.gauge(
                "rate_limiter_net_syscalls_total",
                "Wire-loop syscalls by kind (recv/writev/wait/wake) — "
                "divide by decisions_total for syscalls per decision")
            sg.set(net.get("recv_calls", 0), kind="recv")
            sg.set(net.get("writev_calls", 0), kind="writev")
            sg.set(net.get("wait_calls", 0), kind="wait")
            sg.set(net.get("wake_calls", 0), kind="wake")
            self.registry.gauge(
                "rate_limiter_net_writev_frames",
                "Reply frames flushed through vectored writes — over "
                "net_syscalls_total{kind=\"writev\"} this is the "
                "reply batch factor").set(net.get("writev_frames", 0))
