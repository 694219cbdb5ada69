"""Collective mesh router — one routed dispatch per frame, a port of
``ratelimiter_tpu/parallel/collective.py``.

``CollectiveMeshLimiter`` is the ``MeshSpec.router="collective"`` twin
of the host-routed ``SlicedMeshLimiter``. State placement is IDENTICAL —
one independent, device-pinned single-slice limiter per device, every
key owned by ``h64 % n`` — but a frame is dispatched as one routed step
over the slices (ops/route_kernels.py): each slice takes an even 1/n
shard of the frame columns, ``route_bins`` computes owners and bins on
the device (one launch per shard), one all_to_all (parallel/mesh.py)
moves rows to their owning slices, each owner runs its slice's
UNCHANGED step (the front, admission and update kernels) on the rows it
owns, and the verdicts come back by the inverse all_to_all in frame
order. The host stages the columns and fetches the results; it never
argsorts or fans out sub-launches, and resolve waits on one event.

Because the per-slice states stay where the host router keeps them
(``self.slices[i]._state``, updated in place by the slices' steps), the
control plane, overrides, the cascade, capture/restore and stats are
inherited unchanged, and decisions are bit-identical to the host router.

Escape hatches to the host router, both counted in ``fallbacks`` (the
JAX package's own, and no other):

* bin overflow — a shard with more rows for one destination than the
  bin capacity sets its flag; the router reads the flags before any
  slice steps (one small device-to-host copy), leaves every slice's
  state untouched and dispatches the ORIGINAL frame through the host
  router (each row admitted exactly once). The JAX router detects it at
  resolve and re-dispatches then; here the frame keeps its place in
  launch order;
* the strict overload policy — a per-slice host-side admission gate
  that must see each slice's offered mass before dispatch; frames route
  on the host while it is on.

Quarantine is refused at config validation: a collective dispatch spans
every slice, so per-slice failure domains cannot hold.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.algorithms.sketch import _pad_size
from ratelimiter_tpu_torch.core.clock import Clock, to_micros
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import (
    InvalidConfigError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import (
    BatchResult,
    DispatchTicket,
    batch_fail_open,
)
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.ops import route_kernels
from ratelimiter_tpu_torch.parallel.limiter import SlicedMeshLimiter
from ratelimiter_tpu_torch.parallel.mesh import Mesh


class CollectiveDispatchTicket(DispatchTicket):
    """Ticket for one collective frame dispatch: ``outs`` holds the host
    copies of (allowed, remaining, retry, reset, per-slice admitted
    mass), ``event`` the CUDA event behind them."""

    __slots__ = ("wire_lane",)

    def __init__(self, result=None):
        super().__init__(result)
        self.wire_lane = False


class CollectiveMeshLimiter(SlicedMeshLimiter):
    """Sliced mesh limiter whose decide path is one routed dispatch
    (``MeshSpec.router="collective"``)."""

    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None, device="cuda"):
        super().__init__(config, clock, n_devices=n_devices,
                         devices=devices, device=device)
        if self.quarantine is not None:  # pragma: no cover - config gate
            raise InvalidConfigError(
                "router='collective' cannot wrap slices in quarantine "
                "guards (whole-mesh blast radius; MeshSpec.validate "
                "refuses this combination)")
        if self.n_slices > route_kernels.MAX_SLICES:
            raise InvalidConfigError(
                f"router='collective' routes at most "
                f"{route_kernels.MAX_SLICES} slices, got {self.n_slices}")
        self.mesh = Mesh([s.device for s in self.slices])
        #: Serializes collective dispatches: the routed step spans every
        #: slice, and it holds the slices' locks (in slice order) like
        #: the control-plane and capture paths.
        self._mesh_lock = threading.Lock()
        #: Host-router fallbacks taken (overflow or the strict gate).
        self.fallbacks = 0
        self._strict_gate = bool(getattr(self.slices[0], "_strict", False))

    def _use_host_router(self, b: int) -> bool:
        # The strict overload gate is a host-side per-slice decision made
        # BEFORE dispatch; empty frames take the host router's
        # passthrough (nothing to route).
        return b == 0 or self._strict_gate

    # --------------------------------------------------- routed dispatch

    def _route_shards(self, h64p: np.ndarray, nsp: np.ndarray, b: int,
                      L: int, C: int, premix: bool) -> list:
        """Stage each shard on its slice's device and run ``route_bins``
        on it (one launch per source shard)."""
        bins = []
        for i, s in enumerate(self.slices):
            h = s._stage(h64p[i * L:(i + 1) * L].view(np.int64), np.int64)
            n = s._stage(nsp[i * L:(i + 1) * L], np.int32)
            bins.append(route_kernels.route_bins(h, n, b - i * L,
                                                 self.n_slices, C, premix))
        return bins

    def _launch_routed(self, arrays: np.ndarray, ns: np.ndarray,
                       now: float, *, premix: bool, wire: bool):
        b = int(arrays.shape[0])
        n = self.n_slices
        now_us = to_micros(now)
        L = _pad_size(max(1, -(-b // n)))
        C = route_kernels.bin_capacity(L, n, self.config.mesh.bin_headroom)
        h64p = np.zeros(n * L, dtype=np.uint64)
        h64p[:b] = arrays
        nsp = np.zeros(n * L, dtype=np.int32)
        nsp[:b] = ns
        rec = tracing.RECORDER
        t_r0 = tracing.now() if rec is not None else 0
        dev0 = self.mesh.devices[0]
        s0 = self.slices[0]
        with self._mesh_lock:
            for s in self.slices:
                s._lock.acquire()
            try:
                for s in self.slices:
                    if s._injected_failure is not None:
                        raise s._injected_failure
                    s._sync_period(now_us)
                bins = self._route_shards(h64p, nsp, b, L, C, premix)
                ovf = torch.cat([x.ovf.to(dev0) for x in bins]).cpu()
                if bool(ovf.any()):
                    outs = None
                else:
                    outs = self._routed_step(bins, C, L, now_us, premix)
                    window_us = s0._window_us
                    if premix:
                        from ratelimiter_tpu_torch.ops.hashing import (
                            splitmix64,
                        )

                        limits = (s0._policy_limits(splitmix64(arrays))
                                  if len(s0._policy_table) else None)
                    else:
                        limits = s0._policy_limits(arrays)
            finally:
                for s in reversed(self.slices):
                    s._lock.release()
        if outs is None:
            # Bin overflow: nothing has stepped, so the host router
            # admits each row of the original frame exactly once.
            self.fallbacks += 1
            owners = (self.owner_of_id(arrays) if premix
                      else self.owner_of_hash(arrays))
            return self._launch_split(arrays, ns, owners, now,
                                      premix=premix, wire=wire)
        cols, masses = outs
        fin = s0._launch_finish(tuple(c[:b] for c in cols), now_us,
                                window_us)
        t = CollectiveDispatchTicket()
        res = fin + (masses,)
        if dev0.type == "cuda":
            host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                         for o in res)
            for h, o in zip(host, res):
                h.copy_(o, non_blocking=True)
            t.event = torch.cuda.Event()
            t.event.record(torch.cuda.current_stream(dev0))
            t.staged = (bins, res)
            res = host
        if rec is not None:
            # The whole launch is one "route" span: no argsort, no index
            # maps, no fan-out on the host.
            rec.record("route", t_r0, tracing.now(), batch=b)
        t.outs = res
        t.b = b
        t.limit = self.config.limit
        t.limits = limits
        t.ns = np.asarray(ns)
        t.now_us = now_us
        t.t_sec = now
        t.wire_lane = bool(wire and premix)
        return t

    def _routed_step(self, bins, C: int, L: int, now_us: int,
                     premix: bool):
        """all_to_all the bins, run each owner's step on its compacted
        rows, and return the verdict columns in frame order on slice 0's
        device plus the per-slice admitted mass. Slice locks held."""
        n = self.n_slices
        mesh = self.mesh
        recv_h = mesh.all_to_all([[x.send_h[d * C:(d + 1) * C]
                                   for d in range(n)] for x in bins])
        recv_ns = mesh.all_to_all([[x.send_ns[d * C:(d + 1) * C]
                                    for d in range(n)] for x in bins])
        back, masses = [], []
        for d, s in enumerate(self.slices):
            h_own, ns_own, order = route_kernels.compact(recv_h[d],
                                                         recv_ns[d])
            step = s._ids_step if premix else s._step
            allowed, remaining, third = step(
                s._state, h_own, ns_own, now_us, s._policy_device(),
                s._hier_device(), **s._step_kw(), **s._launch_kw())
            masses.append(torch.where(allowed, ns_own, 0).sum(
                dtype=torch.int64).reshape(1).to(mesh.devices[0]))
            back.append([route_kernels.uncompact(c, order)
                         for c in (allowed, remaining, third)])
        cols = []
        for k in range(3):
            rets = mesh.all_to_all([[back[d][k][src * C:(src + 1) * C]
                                     for src in range(n)]
                                    for d in range(n)])
            parts = [route_kernels.gather_back(rets[src], bins[src])
                     for src in range(n)]
            cols.append(torch.cat([p.to(mesh.devices[0], non_blocking=True)
                                   for p in parts]))
        return tuple(cols), torch.cat(masses)

    def _launch_routed_guarded(self, arrays: np.ndarray, ns: np.ndarray,
                               now: float, *, premix: bool,
                               wire: bool) -> DispatchTicket:
        """The slices' fail-open/fail-closed launch contract — but a
        routed launch failure spans the whole mesh, so fail-open covers
        the whole frame."""
        try:
            return self._launch_routed(arrays, ns, now, premix=premix,
                                       wire=wire)
        except Exception as exc:
            if self.config.fail_open:
                return DispatchTicket(result=batch_fail_open(
                    int(arrays.shape[0]), self.config.limit,
                    now + float(self.config.window)))
            raise StorageUnavailableError(
                f"collective launch failed: {exc}") from exc

    def resolve(self, ticket: DispatchTicket) -> BatchResult:
        if not isinstance(ticket, CollectiveDispatchTicket):
            return super().resolve(ticket)
        if ticket.result is not None:
            return ticket.result
        rec = tracing.RECORDER
        t_b0 = tracing.now() if rec is not None else 0
        try:
            if ticket.event is not None:
                ticket.event.synchronize()
            allowed, remaining, retry, reset_at, mass = (
                o.numpy() for o in ticket.outs)
        except Exception as exc:
            ticket.outs = ticket.staged = ticket.event = None
            if self.config.fail_open:
                res = batch_fail_open(ticket.b, self.config.limit,
                                      ticket.t_sec
                                      + float(self.config.window))
                ticket.result = res
                return res
            raise StorageUnavailableError(
                f"collective resolve failed: {exc}") from exc
        if rec is not None:
            rec.record("barrier", t_b0, tracing.now(),
                       trace_id=getattr(ticket, "trace_id", 0),
                       batch=ticket.b)
        ticket.outs = ticket.staged = ticket.event = None
        b = ticket.b
        for i, s in enumerate(self.slices):
            admitted = int(mass[i])
            if admitted:
                with s._lock:
                    s._note_mass_locked(admitted, ticket.now_us)
        wire_packed = None
        if ticket.wire_lane:
            # Host packbits from the frame-order columns, the host
            # router's cross-slice convention.
            words = np.empty(3 * b, dtype=np.int64)
            words[0:b] = remaining
            words[b:2 * b] = retry.view(np.int64)
            words[2 * b:3 * b] = reset_at.view(np.int64)
            wire_packed = (np.packbits(allowed, bitorder="little"),
                           words, b)
        res = BatchResult(allowed=allowed, limit=ticket.limit,
                          remaining=remaining, retry_after=retry,
                          reset_at=reset_at, limits=ticket.limits,
                          wire_packed=wire_packed)
        ticket.result = res
        return res

    # ------------------------------------------------ pipelined public API

    def launch_hashed(self, h64: np.ndarray,
                      ns: Optional[np.ndarray] = None, *,
                      now: Optional[float] = None) -> DispatchTicket:
        self._check_open()
        h64 = np.asarray(h64, dtype=np.uint64)
        ns_arr = self._ns(h64.shape[0], ns)
        t = self.clock.now() if now is None else float(now)
        if self._use_host_router(h64.shape[0]):
            return self._launch_split(h64, ns_arr, self.owner_of_hash(h64),
                                      t, premix=False, wire=False)
        return self._launch_routed_guarded(h64, ns_arr, t, premix=False,
                                           wire=False)

    def launch_ids(self, ids: np.ndarray,
                   ns: Optional[np.ndarray] = None, *,
                   now: Optional[float] = None,
                   wire: bool = False) -> DispatchTicket:
        self._check_open()
        ids = np.asarray(ids, dtype=np.uint64)
        ns_arr = self._ns(ids.shape[0], ns)
        t = self.clock.now() if now is None else float(now)
        if self._use_host_router(ids.shape[0]):
            return self._launch_split(ids, ns_arr, self.owner_of_id(ids), t,
                                      premix=True, wire=wire)
        return self._launch_routed_guarded(ids, ns_arr, t, premix=True,
                                           wire=wire)

    def launch_batch(self, keys: Sequence[str],
                     ns: Optional[Sequence[int]] = None, *,
                     now: Optional[float] = None) -> DispatchTicket:
        self._check_open()
        keys, ns_arr = self._batch_operands(keys, ns)
        t = self.clock.now() if now is None else float(now)
        h64 = self._hash(keys)
        if self._use_host_router(h64.shape[0]):
            return self._launch_split(h64, ns_arr, self.owner_of_hash(h64),
                                      t, premix=False, wire=False)
        return self._launch_routed_guarded(h64, ns_arr, t, premix=False,
                                           wire=False)

    def _allow_batch(self, keys: list, ns: np.ndarray,
                     now: float) -> BatchResult:
        h64 = self._hash(keys)
        if self._use_host_router(h64.shape[0]):
            return super()._allow_batch(keys, ns, now)
        return self.resolve(self._launch_routed_guarded(
            h64, np.asarray(ns, dtype=np.int64), now, premix=False,
            wire=False))

    # -------------------------------------------------------------- stats

    def router_stats(self) -> dict:
        """Collective-path bookkeeping for /healthz and the readings."""
        return {"mode": "collective", "fallbacks": self.fallbacks}
