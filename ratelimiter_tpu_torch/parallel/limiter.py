"""Multi-slice limiters: the replicated mesh tier and the sliced serving
tier — a port of ``ratelimiter_tpu/parallel/limiter.py``.

* ``MeshSketchLimiter`` / ``MeshTokenBucketLimiter`` — the replicated
  tier: state replicated on every slice of a ``Mesh``, the request
  batch sharded positionally, coherence through the gather/delta merge
  modes of parallel/mesh_kernels.py. Any slice may see any key.

* ``SlicedMeshLimiter`` — the slice-parallel SERVING tier (``--backend
  mesh``): one independent, device-pinned single-slice limiter per
  device, and every key routed to its OWNING slice by hash. The decide
  path is collective-free, so each key's decisions are bit-identical to
  a single-slice limiter fed that key's traffic.

Slices live on the devices ``parallel.mesh.mesh_devices`` gives: N
cards, N slices on ``cpu`` (the tests), or an explicit list with
repeats (several slices on one card). One process drives them all, as
the JAX package's single controller does.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.algorithms.sketch import (
    SketchLimiter,
    SketchTokenBucketLimiter,
    _pad_size,
)
from ratelimiter_tpu_torch.core.clock import Clock
from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import (
    CheckpointError,
    InvalidConfigError,
)
from ratelimiter_tpu_torch.core.types import (
    Algorithm,
    BatchResult,
    DispatchTicket,
)
from ratelimiter_tpu_torch.observability import tracing
from ratelimiter_tpu_torch.ops import bucket_kernels, sketch_kernels
from ratelimiter_tpu_torch.parallel import mesh_kernels
from ratelimiter_tpu_torch.parallel.mesh import Mesh, mesh_devices


def _warn_delta() -> None:
    # The only configuration that relaxes the strict never-over-admit
    # invariant — say so once, loudly.
    logging.getLogger(__name__).warning(
        "merge='delta': cross-slice admission is eventually consistent; a "
        "key can be over-admitted up to n_slices*limit within one step "
        "(bounded staleness). Use merge='gather' for strict exactness.")


def _copy_state(state: dict, device) -> dict:
    """A replica of ``state`` on ``device``; host scalars (the bucket's
    ``rem``/``last``/``tn_period``) stay on the host."""
    return {k: (v.clone() if v.device.type == "cpu" and v.dim() == 0
                else v.to(device, copy=True))
            for k, v in state.items()}


class _MeshPlacement:
    """Placement shared by the two replicated limiters: the batch sharded
    over the mesh's slices (each shard padded as the single-slice
    limiter pads), the state replicated. ``self._state`` is slice 0's
    replica; ``self._replicas`` the others. Every step, rollover and
    reset runs on all of them; a host-side replacement of the state
    (restore, a live limit or window update) re-replicates."""

    def _init_mesh(self, mesh: Mesh, merge: str) -> None:
        mesh_kernels.check_merge(merge)
        if merge == "delta":
            _warn_delta()
        self.mesh = mesh
        self.merge = merge
        self.n_chips = self.mesh.size
        self._per_dev: dict = {}
        self._replicate()
        self._wrap_steps()

    def _replicate(self) -> None:
        self._replicas = [_copy_state(self._state, d)
                          for d in self.mesh.devices[1:]]

    def _states(self) -> list:
        return [self._state] + self._replicas

    def _padded_size(self, b: int) -> int:
        return _pad_size(max(1, -(-b // self.n_chips))) * self.n_chips

    def _each_device(self, obj) -> list:
        """A dict of device tensors (the policy or tenant table) copied
        to every slice's device, cached on the object's identity."""
        if obj is None:
            return [None] * self.n_chips
        hit = self._per_dev.get(id(obj))
        if hit is not None and hit[0] is obj:
            return hit[1]
        out = [{k: v.to(d) for k, v in obj.items()}
               for d in self.mesh.devices]
        if len(self._per_dev) > 4:
            self._per_dev.clear()
        self._per_dev[id(obj)] = (obj, out)
        return out

    def _wrap_steps(self) -> None:
        """Replace the single-slice step, ids step, reset (and windowed
        rollover) by their mesh forms over every replica."""
        merge_step = (mesh_kernels.gather_step if self.merge == "gather"
                      else self._delta_step)
        single = {"hashed": self._step, "ids": self._ids_step}

        def mesh_step(which):
            one = single[which]

            def step(_state, keys, n, now_us, policy=None, hier=None, **kw):
                pols = self._each_device(policy)
                hiers = self._each_device(hier)
                states = self._states()
                if self.merge == "gather":
                    return merge_step(self.mesh, one, states, keys, n,
                                      now_us, pols, hiers, **kw)
                return merge_step(self.mesh, states, keys, n, now_us, pols,
                                  hiers, premix=which == "ids",
                                  seed=self._seed, **self._delta_kw, **kw)
            return step

        self._step, self._ids_step = mesh_step("hashed"), mesh_step("ids")
        reset = self._reset_step

        def mesh_reset(_state, h1, h2, now_us, **kw):
            for st, d in zip(self._states(), self.mesh.devices):
                reset(st, h1.to(d), h2.to(d), now_us, **kw)

        self._reset_step = mesh_reset
        rollover = getattr(self, "_rollover", None)
        if rollover is not None:
            def mesh_rollover(_state, p):
                for st in self._states():
                    rollover(st, p)

            self._rollover = mesh_rollover

    def memory_bytes(self) -> int:
        """State on every slice: each holds a complete copy."""
        return super().memory_bytes() * self.n_chips

    # Every path that REPLACES the state (or the single-slice steps) on
    # the host re-replicates and re-wraps.

    def _apply_config(self, new_cfg: Config) -> None:
        super()._apply_config(new_cfg)
        with self._lock:
            self._replicate()
            self._wrap_steps()

    def _apply_window(self, new_cfg: Config) -> None:
        super()._apply_window(new_cfg)
        with self._lock:
            self._replicate()
            self._wrap_steps()

    def _restored(self, arrays: dict) -> None:
        super()._restored(arrays)
        self._replicate()


class MeshSketchLimiter(_MeshPlacement, SketchLimiter):
    """Windowed sketch whose dispatch spans every slice of a mesh.

    Args:
        config: limiter configuration.
        mesh: a ``Mesh``; default ``config.mesh.devices`` slices on
            ``device``'s kind (parallel/mesh.py ``mesh_devices``).
        merge: "gather" (bit-exact global sequencing — the default, and
            the only mode that keeps the strict never-over-admit
            contract) or "delta" (one psum per step, <= 1 step
            staleness: a key hammered from every slice in the SAME step
            can be over-admitted up to n_slices * limit in that step).
        clock: time source (tests inject ManualClock).
    """

    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 mesh: Optional[Mesh] = None, merge: str = "gather",
                 device="cuda"):
        if mesh is None:
            mesh = Mesh(mesh_devices(device, config.mesh.devices))
        super().__init__(config, clock, device=mesh.devices[0])
        self._init_mesh(mesh, merge)

    @property
    def _delta_kw(self) -> dict:
        return sketch_kernels._step_kw(self.config)

    _delta_step = staticmethod(mesh_kernels.delta_window_step)


class MeshTokenBucketLimiter(_MeshPlacement, SketchTokenBucketLimiter):
    """Sketched token bucket spanning a mesh: replicated debt slab, batch
    sharded over slices, the same merge modes and staleness contract as
    MeshSketchLimiter (the scalar decay is deterministic on replicated
    state, so only the debt increments need a collective)."""

    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 mesh: Optional[Mesh] = None, merge: str = "gather",
                 device="cuda"):
        if mesh is None:
            mesh = Mesh(mesh_devices(device, config.mesh.devices))
        super().__init__(config, clock, device=mesh.devices[0])
        self._init_mesh(mesh, merge)

    @property
    def _delta_kw(self) -> dict:
        return bucket_kernels._params(self.config)

    _delta_step = staticmethod(mesh_kernels.delta_bucket_step)


# ===================================================================
#                      slice-parallel serving tier
# ===================================================================

def build_slices(config: Config, clock: Optional[Clock] = None, *,
                 n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 device="cuda") -> List[SketchLimiter]:
    """One device-pinned single-slice limiter per device (the slices of
    ``SlicedMeshLimiter``; the native front door mounts them directly as
    its dispatch shards). Token-bucket configs get the sketched token
    bucket, everything else the windowed sketch — the same selection as
    ``create_limiter(backend="sketch")``. Each slice enforces an equal
    share of every tenant and global limit (``hier_divisor`` = the slice
    count), since slices share no counters."""
    n = n_devices if n_devices is not None else config.mesh.devices
    devs = mesh_devices(device, n, devices)
    cls = (SketchTokenBucketLimiter
           if config.algorithm is Algorithm.TOKEN_BUCKET else SketchLimiter)
    return [cls(config, clock, device=d, hier_divisor=len(devs))
            for d in devs]


class MeshDispatchTicket(DispatchTicket):
    """Composite ticket for one frame split across slices.

    ``subs`` holds (slice_index, positions, slice_ticket) triples;
    resolve() scatters each slice's results back to the frame's original
    positions. A frame fully owned by one slice skips the split (its
    slice ticket passes through, keeping the device-packed wire
    buffers). ``DispatchTicket.meta`` stays free for the decorator stack
    (the circuit breaker parks judgment state there)."""

    __slots__ = ("subs",)

    def __init__(self, result=None):
        super().__init__(result)
        self.subs = None


def _restore_sub(s, arrays: dict, extra: dict, label: str) -> None:
    """Restore one slice from its sub-dictionary of a combined snapshot;
    the host mirrors the slice needs come from ``extra``."""
    full = {k: extra.get(k, getattr(s, "_" + k))
            for k in getattr(s, "_EXTRA_KEYS", ())}
    try:
        s.restore_state(arrays, full)
    except InvalidConfigError as exc:
        raise CheckpointError(f"{label}: {exc}") from exc


class SlicedMeshLimiter(RateLimiter):
    """Slice-parallel serving limiter (``--backend mesh``).

    One independent single-slice limiter (windowed sketch or sketched
    token bucket, per ``config.algorithm``) is pinned to each of the
    mesh's devices; every key is routed to its OWNING slice by hash:

    * pre-hashed keys (``allow_hashed``/``launch_hashed``): owner =
      ``h64 % n_slices``;
    * raw u64 ids (``allow_ids``/``launch_ids``): owner =
      ``splitmix64(id) % n_slices``;
    * string keys: hashed exactly as the single-slice limiter hashes
      them (prefix + hash), then the ``h64`` rule.

    The decide path is collective-free: a frame is partitioned on the
    host (one stable argsort over the owner vector), each touched slice
    gets one independent pipelined dispatch on its own device, and the
    results scatter back to frame order at resolve. Per-key decisions
    are therefore bit-identical to a single-slice limiter fed that key's
    traffic. With ``MeshSpec.quarantine`` every slice is wrapped in a
    ``SliceGuard`` (parallel/quarantine.py).
    """

    pipelined = True

    def __init__(self, config: Config, clock: Optional[Clock] = None, *,
                 n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None, device="cuda"):
        super().__init__(config, clock)
        self.slices = build_slices(self.config, self.clock,
                                   n_devices=n_devices, devices=devices,
                                   device=device)
        self.n_slices = len(self.slices)
        self._CKPT_KIND = f"mesh:{self.slices[0]._CKPT_KIND}"
        self._seed = self.config.sketch.seed
        #: Failure-domain isolation (opt-in via ``MeshSpec.quarantine``):
        #: the shared state machine, None when off (then the hot path
        #: holds no guard at all).
        self.quarantine = None
        if self.config.mesh.quarantine:
            from ratelimiter_tpu_torch.parallel.quarantine import (
                QuarantineManager,
                SliceGuard,
            )

            spec = self.config.mesh
            self.quarantine = QuarantineManager(
                self.n_slices, clock=self.clock,
                probe_interval=spec.probe_interval,
                failure_threshold=spec.failure_threshold)
            self.slices = [
                SliceGuard(s, i, self.quarantine,
                           deadline=spec.slice_deadline)
                for i, s in enumerate(self.slices)]

    @property
    def device(self) -> torch.device:
        """Slice 0's device (the binary's banner and prewarm read it)."""
        return self.slices[0].device

    # ------------------------------------------------------------ routing

    def _hash(self, keys: List[str]) -> np.ndarray:
        """Prefix + hash exactly as the slices do (all share one
        config)."""
        return self.slices[0]._hash(list(keys))

    def owner_of_hash(self, h64: np.ndarray) -> np.ndarray:
        """Owning slice index per finalized u64 hash."""
        return (np.asarray(h64, np.uint64)
                % np.uint64(self.n_slices)).astype(np.int64)

    def owner_of_id(self, ids: np.ndarray) -> np.ndarray:
        """Owning slice index per RAW u64 id (the hashed wire lane):
        finalize with splitmix64 first."""
        from ratelimiter_tpu_torch.ops.hashing import splitmix64

        return self.owner_of_hash(splitmix64(np.asarray(ids, np.uint64)))

    def owner_of_key(self, key: str) -> int:
        return int(self.owner_of_hash(self._hash([key]))[0])

    # ----------------------------------------------------- split dispatch

    def _launch_split(self, arrays: np.ndarray, ns: np.ndarray,
                      owners: np.ndarray, now: float, *,
                      premix: bool, wire: bool) -> MeshDispatchTicket:
        """Partition one frame by owning slice and launch one pipelined
        dispatch per touched slice. ``arrays`` holds finalized hashes
        (premix=False) or raw ids (premix=True — the slice finalizes
        in-step). Single-owner frames pass through unsplit, keeping the
        slice ticket's device-packed wire buffers."""
        b = int(arrays.shape[0])

        def sub_launch(lim, a, n_arr):
            if premix:
                return lim.launch_ids(a, n_arr, now=now, wire=wire)
            return lim.launch_hashed(a, n_arr, now=now)

        first = int(owners[0]) if b else 0
        if b == 0 or self.n_slices == 1 or not np.any(owners != first):
            t = MeshDispatchTicket()
            t.subs = [(first, None, sub_launch(self.slices[first],
                                               arrays, ns))]
            t.b = b
            t.limit = self.config.limit
            t.t_sec = now
            return t
        # One stable argsort partitions the whole frame: frame order is
        # kept within a slice, so same-key sequencing holds (a key's
        # requests all land on its slice in order).
        rec = tracing.RECORDER
        t_r0 = tracing.now() if rec is not None else 0
        order = np.argsort(owners, kind="stable")
        bounds = np.searchsorted(owners[order], np.arange(self.n_slices + 1))
        t = MeshDispatchTicket()
        t.subs = []
        for s in range(self.n_slices):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            if lo == hi:
                continue
            pos = order[lo:hi]
            t.subs.append((s, pos, sub_launch(self.slices[s],
                                              arrays[pos], ns[pos])))
        t.b = b
        t.limit = self.config.limit
        t.t_sec = now
        # Wire frames reassemble packed buffers at resolve (only the
        # raw-id lane's sub-launches pack on the device).
        t.wire = bool(wire and premix)
        if rec is not None:
            rec.record("route", t_r0, tracing.now(), batch=b)
        return t

    def _resolve_one(self, s: int, sub) -> BatchResult:
        try:
            return self.slices[s].resolve(sub)
        except Exception as exc:
            if getattr(exc, "slice_index", None) is None:
                try:
                    exc.slice_index = s
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            raise

    def resolve(self, ticket: DispatchTicket) -> BatchResult:
        """Resolve every slice dispatch and scatter results back to the
        frame's positions. Completion is ONE barrier per frame (every
        sub-dispatch's CUDA event waited on in one pass), so the frame
        finishes when its slowest slice does. Failures are
        non-transactional, as on the native door's multi-shard frames: a
        fail-closed error on one slice fails the frame but other slices'
        quota stands; fail-open slices answer fail-open and the frame's
        flag ORs over slices."""
        if ticket.result is not None:
            return ticket.result
        subs = getattr(ticket, "subs", None)
        if subs is None:
            from ratelimiter_tpu_torch.core.errors import RateLimiterError

            raise RateLimiterError(
                "foreign ticket reached SlicedMeshLimiter.resolve")
        if len(subs) == 1 and subs[0][1] is None:
            s, _, sub = subs[0]
            res = self._resolve_one(s, sub)
            ticket.result = res
            return res
        rec = tracing.RECORDER
        trace = getattr(ticket, "trace_id", 0)
        if self.quarantine is None:
            # The frame's single completion barrier. Under quarantine
            # there is none (a wedged device would hang it): each
            # slice's guard bounds its own resolve with its deadline.
            t_b0 = tracing.now() if rec is not None else 0
            for _, _, sub in subs:
                ev = getattr(sub, "event", None)
                if ev is not None:
                    try:
                        ev.synchronize()
                    except Exception:  # noqa: BLE001 — the slice reports
                        pass
            if rec is not None:
                rec.record("barrier", t_b0, tracing.now(), trace_id=trace,
                           batch=ticket.b)
        b = ticket.b
        allowed = np.zeros(b, dtype=bool)
        remaining = np.zeros(b, dtype=np.int64)
        retry = np.zeros(b, dtype=np.float64)
        reset_at = np.zeros(b, dtype=np.float64)
        limits = None
        fail_open = False
        fo_slices: list = []
        fo_unattributed = False
        err = None
        wire = bool(getattr(ticket, "wire", False))
        for s, pos, sub in subs:
            t_s0 = tracing.now() if rec is not None else 0
            try:
                res = self._resolve_one(s, sub)
            except Exception as exc:  # fail-closed slice: finish the rest
                if rec is not None:
                    rec.record("slice", t_s0, tracing.now(),
                               trace_id=trace, shard=s,
                               outcome=tracing.ERROR)
                err = err if err is not None else exc
                continue
            if rec is not None:
                rec.record("slice", t_s0, tracing.now(), trace_id=trace,
                           shard=s, batch=len(res),
                           outcome=tracing.FAIL_OPEN if res.fail_open
                           else tracing.OK)
            allowed[pos] = res.allowed
            remaining[pos] = res.remaining
            retry[pos] = res.retry_after
            reset_at[pos] = res.reset_at
            if res.fail_open:
                attr = getattr(res, "fail_open_slices", None)
                if attr:
                    fo_slices.extend(attr)
                else:
                    fo_unattributed = True
            fail_open = fail_open or res.fail_open
            wire = wire and res.wire_packed is not None
            if res.limits is not None:
                if limits is None:
                    limits = np.full(b, self.config.limit, dtype=np.int64)
                limits[pos] = res.limits
        if err is not None:
            raise err
        wire_packed = None
        if wire:
            # Frame-order packed buffers rebuilt from the scattered
            # columns, so the wire encoder still frames from packed
            # buffers.
            words = np.empty(3 * b, dtype=np.int64)
            words[0:b] = remaining
            words[b:2 * b] = retry.view(np.int64)
            words[2 * b:3 * b] = reset_at.view(np.int64)
            wire_packed = (np.packbits(allowed, bitorder="little"),
                           words, b)
        res = BatchResult(allowed=allowed, limit=self.config.limit,
                          remaining=remaining, retry_after=retry,
                          reset_at=reset_at, fail_open=fail_open,
                          limits=limits, wire_packed=wire_packed)
        if fail_open and fo_slices and not fo_unattributed:
            res.fail_open_slices = sorted(set(fo_slices))
        ticket.result = res
        return res

    # ------------------------------------------------- pipelined public API

    @staticmethod
    def _ns(count: int, ns) -> np.ndarray:
        if ns is None:
            return np.ones(count, dtype=np.int64)
        return np.asarray(ns, dtype=np.int64)

    def launch_hashed(self, h64: np.ndarray,
                      ns: Optional[np.ndarray] = None, *,
                      now: Optional[float] = None) -> MeshDispatchTicket:
        self._check_open()
        h64 = np.asarray(h64, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self._launch_split(h64, self._ns(h64.shape[0], ns),
                                  self.owner_of_hash(h64), t,
                                  premix=False, wire=False)

    def launch_ids(self, ids: np.ndarray,
                   ns: Optional[np.ndarray] = None, *,
                   now: Optional[float] = None,
                   wire: bool = False) -> MeshDispatchTicket:
        self._check_open()
        ids = np.asarray(ids, dtype=np.uint64)
        t = self.clock.now() if now is None else float(now)
        return self._launch_split(ids, self._ns(ids.shape[0], ns),
                                  self.owner_of_id(ids), t,
                                  premix=True, wire=wire)

    def _batch_operands(self, keys, ns) -> tuple:
        from ratelimiter_tpu_torch.algorithms.base import check_key, check_n
        from ratelimiter_tpu_torch.core.errors import InvalidNError

        keys = list(keys)
        for k in keys:
            check_key(k)
        if ns is None:
            return keys, np.ones(len(keys), dtype=np.int64)
        if len(ns) != len(keys):
            raise InvalidNError(
                f"ns length {len(ns)} != keys length {len(keys)}")
        for n in ns:
            check_n(int(n))
        return keys, np.asarray(ns, dtype=np.int64)

    def launch_batch(self, keys: Sequence[str],
                     ns: Optional[Sequence[int]] = None, *,
                     now: Optional[float] = None) -> MeshDispatchTicket:
        self._check_open()
        keys, ns_arr = self._batch_operands(keys, ns)
        t = self.clock.now() if now is None else float(now)
        h64 = self._hash(keys)
        return self._launch_split(h64, ns_arr, self.owner_of_hash(h64), t,
                                  premix=False, wire=False)

    def allow_hashed(self, h64: np.ndarray,
                     ns: Optional[np.ndarray] = None, *,
                     now: Optional[float] = None) -> BatchResult:
        return self.resolve(self.launch_hashed(h64, ns, now=now))

    def allow_ids(self, ids: np.ndarray,
                  ns: Optional[np.ndarray] = None, *,
                  now: Optional[float] = None) -> BatchResult:
        return self.resolve(self.launch_ids(ids, ns, now=now))

    def _allow_batch(self, keys: list, ns: np.ndarray,
                     now: float) -> BatchResult:
        h64 = self._hash(keys)
        return self.resolve(self._launch_split(
            h64, ns, self.owner_of_hash(h64), now,
            premix=False, wire=False))

    def _allow_n(self, key: str, n: int, now: float):
        return self.slices[self.owner_of_key(key)].allow_n(key, n, now=now)

    # --------------------------------------------------- control plane

    def _reset(self, key: str) -> None:
        self.slices[self.owner_of_key(key)].reset(key)

    def update_limit(self, new_limit: int) -> None:
        self._check_open()
        for s in self.slices:
            s.update_limit(new_limit)
        from dataclasses import replace

        self.config = replace(self.config, limit=new_limit)

    def update_window(self, new_window: float) -> None:
        self._check_open()
        for s in self.slices:
            s.update_window(new_window)
        from dataclasses import replace

        self.config = replace(self.config, window=float(new_window))

    # Policy overrides apply on EVERY slice (idempotent for non-owners —
    # their copy is never queried for the key), the native door's shard
    # rule; reads route to the owner.

    def set_override(self, key: str, limit: Optional[int] = None, *,
                     window_scale: float = 1.0):
        self._check_open()
        ov = None
        for s in self.slices:
            ov = s.set_override(key, limit, window_scale=window_scale)
        return ov

    def get_override(self, key: str):
        self._check_open()
        return self.slices[self.owner_of_key(key)].get_override(key)

    def delete_override(self, key: str) -> bool:
        self._check_open()
        existed = False
        for s in self.slices:
            existed = s.delete_override(key) or existed
        return existed

    def list_overrides(self):
        self._check_open()
        return self.slices[0].list_overrides()

    def override_count(self) -> int:
        return self.slices[0].override_count()

    # Hierarchy surface: HierarchyFanout's write-all / read-one /
    # sum-stats over the slices (each enforces its equal share of the
    # scope limits). Built per call: restore may rebuild self.slices.

    def _hier(self):
        from ratelimiter_tpu_torch.hierarchy.fanout import HierarchyFanout

        self._check_open()
        return HierarchyFanout(self.slices)

    def set_tenant(self, name, limit=None, *, weight=1, floor=None):
        return self._hier().set_tenant(name, limit, weight=weight,
                                       floor=floor)

    def delete_tenant(self, name: str) -> bool:
        return self._hier().delete_tenant(name)

    def assign_tenant(self, key: str, tenant: str) -> None:
        self._hier().assign_tenant(key, tenant)

    def unassign_tenant(self, key: str) -> bool:
        return self._hier().unassign_tenant(key)

    def tenant_of(self, key: str) -> str:
        return self._hier().tenant_of(key)

    def get_tenant(self, name: str):
        return self._hier().get_tenant(name)

    def list_tenants(self):
        return self._hier().list_tenants()

    def set_global_limit(self, limit) -> None:
        self._hier().set_global_limit(limit)

    def set_effective(self, scope: str, limit: int) -> int:
        return self._hier().set_effective(scope, limit)

    def effective_limits(self):
        return self._hier().effective_limits()

    def hierarchy_payload(self) -> dict:
        return self._hier().hierarchy_payload()

    def apply_hierarchy_payload(self, payload: dict) -> bool:
        return self._hier().apply_hierarchy_payload(payload)

    def hierarchy_stats(self) -> dict:
        """Per-scope stats summed across slices (each slice's counters
        cover its hash-owned keys); effective and ceiling values come
        from slice 0's table (mutations are write-all)."""
        return self._hier().hierarchy_stats()

    # ------------------------------------------------- checkpoint seam

    def capture_state(self):
        """One combined snapshot over every slice: each slice captures
        under its own lock (device to host only). Slices share no keys,
        so per-key consistency holds. The slice count rides in the
        extras; a restore at another count re-buckets (``_load``)."""
        self._check_open()
        arrays = {}
        extras = []
        for i, s in enumerate(self.slices):
            _, a, e = s.capture_state()
            arrays.update({f"slice{i}:{k}": v for k, v in a.items()})
            extras.append(e)
        return self._CKPT_KIND, arrays, {
            "n_slices": self.n_slices,
            "slice_extras": extras,
            "saved_at": self.clock.now(),
        }

    def _load(self, path: str):
        """(arrays, slice extras) of the combined snapshot at ``path`` on
        this mesh's slice count: a snapshot of another count is
        re-bucketed onto it (parallel/reshard.py): clean splits copy a
        slice verbatim, merges take the conservative union (elementwise
        max after period alignment), overrides re-route exactly, and
        estimates only rise, so the resharded mesh never over-admits
        against its source."""
        from ratelimiter_tpu_torch.checkpoint import load_state

        arrays, meta = load_state(path, self._CKPT_KIND, self.config)
        saved = int(meta.get("n_slices", -1))
        if saved != self.n_slices:
            from ratelimiter_tpu_torch.parallel import reshard

            logging.getLogger(__name__).warning(
                "%s: snapshot holds %d slice(s) but this mesh runs %d "
                "device(s) — re-bucketing key-routed state onto the new "
                "geometry (conservative union: overrides exact, "
                "estimates only rise)", path, saved, self.n_slices)
            arrays, meta = reshard.rebucket_combined(
                arrays, meta, self.n_slices, self.config)
        return arrays, meta.get("slice_extras") or [{}] * self.n_slices

    def restore(self, path: str) -> None:
        """Restore a combined snapshot, re-bucketed onto this mesh when it
        was taken under another slice count (``_load``)."""
        self._check_open()
        arrays, extras = self._load(path)
        for i, s in enumerate(self.slices):
            prefix = f"slice{i}:"
            sub = {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix)}
            _restore_sub(s, sub, extras[i], f"{path}[slice{i}]")

    def restore_slice(self, path: str, index: int) -> None:
        """Slice-scoped restore: replace ONE slice's state with its
        sub-dictionary of the combined snapshot at ``path``, leaving
        every other slice untouched — the recovery half of quarantine
        (recover.recover_unit replays the WAL suffix after it). A
        snapshot of another slice count is re-bucketed whole onto this
        mesh first (``_load``), so the slice gets the state the new
        routing gives it: the case of a mesh restarted at another count
        whose newest snapshot predates the restart. (The JAX package
        refuses this case and points at a full restore.)"""
        self._check_open()
        if not 0 <= index < self.n_slices:
            raise CheckpointError(
                f"restore_slice: slice {index} out of range "
                f"[0, {self.n_slices})")
        arrays, extras = self._load(path)
        prefix = f"slice{index}:"
        sub = {k[len(prefix):]: v for k, v in arrays.items()
               if k.startswith(prefix)}
        _restore_sub(self.slices[index], sub, extras[index],
                     f"{path}[slice{index}]")

    # ------------------------------------------------- fault injection

    def inject_failure(self, exc: Optional[Exception] = None) -> None:
        for s in self.slices:
            s.inject_failure(exc)

    def heal(self) -> None:
        for s in self.slices:
            s.heal()

    # ----------------------------------------------------- introspection

    def sub_limiters(self):
        """The per-device slices (the serving tier's per-unit seam: the
        health envelope, the consumer gauges and slice recovery iterate
        these)."""
        return list(self.slices)

    def memory_bytes(self) -> int:
        return sum(s.memory_bytes() for s in self.slices)

    def in_window_admitted_mass(self) -> int:
        return sum(s.in_window_admitted_mass() for s in self.slices)

    @property
    def mass_budget(self) -> int:
        return sum(s.mass_budget for s in self.slices)

    @property
    def overload_periods(self) -> int:
        return sum(s.overload_periods for s in self.slices)

    def _close(self) -> None:
        for s in self.slices:
            s.close()
