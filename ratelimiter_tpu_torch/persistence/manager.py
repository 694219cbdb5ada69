"""PersistenceManager: one object owning the WAL + snapshotter for a
limiter deployment, plus the ``PersistentLimiter`` decorator that routes
every non-decision mutation through the log — a copy of
``ratelimiter_tpu/persistence/manager.py``.

Wiring order (the server binary follows it, embedders should too):

    spec = PersistenceSpec(dir="/var/lib/ratelimiter")
    mgr = PersistenceManager(spec)
    lim = mgr.wrap(create_limiter(cfg))   # outermost decorator
    mgr.attach([lim])
    mgr.recover()                         # BEFORE serving traffic
    mgr.start()                           # background snapshots
    ...
    mgr.stop()                            # final snapshot + WAL close

Mutations are applied first, then logged, then acknowledged
(apply→log→ack): a record only ever describes a mutation that
succeeded, and the caller's response implies durability (under
``wal_fsync="always"``). The crash window between apply and append
loses a mutation that was never acknowledged — indistinguishable, to
the caller, from crashing a moment earlier.

Sidecars (``add_sidecar``/``restore_sidecar``) carry a non-limiter
table on the same snapshots: the lease grant table rides every snapshot
and is restored after recovery.

``slice_restorer`` is the mesh quarantine's restore-before-rejoin hook
(recover.recover_unit). ``add_aux_unit``/``remove_aux_unit`` put a
fleet member's adopted-range standby on the same cycle
(snapshotter.py).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.core.config import PersistenceSpec
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.observability.decorators import LimiterDecorator
from ratelimiter_tpu_torch.persistence import wal as walmod
from ratelimiter_tpu_torch.persistence.recover import RecoveryReport, recover
from ratelimiter_tpu_torch.persistence.snapshotter import Snapshotter

log = logging.getLogger("ratelimiter_tpu_torch.persistence")


class PersistenceManager:
    """Owns the durability machinery for one process: a WAL, a
    background Snapshotter over every dispatch shard, recovery, and the
    mutation-logging seam the PersistentLimiter wrappers call into."""

    def __init__(self, spec: PersistenceSpec, *,
                 registry: Optional[m.Registry] = None):
        if not spec.enabled:
            raise ValueError("PersistenceSpec.dir must be set")
        spec.validate()
        self.spec = spec
        self.dir = spec.dir
        reg = registry if registry is not None else m.DEFAULT
        self._wal_records = reg.counter(
            "rate_limiter_wal_records_total",
            "Mutation records appended to the write-ahead log")
        self._wal_bytes = reg.counter(
            "rate_limiter_wal_bytes_total",
            "Bytes appended to the write-ahead log")
        self.wal = walmod.WriteAheadLog(
            spec.dir, fsync=spec.wal_fsync,
            fsync_interval=spec.wal_fsync_interval,
            max_bytes=spec.wal_max_bytes)
        self._registry = reg
        self._limiters: List[RateLimiter] = []
        self._shard_of: Optional[Callable[[str], int]] = None
        self.snapshotter: Optional[Snapshotter] = None
        self.report: Optional[RecoveryReport] = None
        self._replaying = False
        self._log_lock = threading.Lock()

    # ------------------------------------------------------------- wiring

    def wrap(self, limiter: RateLimiter) -> "PersistentLimiter":
        """Wrap one (possibly already-decorated) limiter so its mutations
        reach the WAL. Must be the OUTERMOST decorator — every serving
        surface mutates through the top of the stack."""
        return PersistentLimiter(limiter, self)

    def attach(self, limiters: List[RateLimiter],
               shard_of: Optional[Callable[[str], int]] = None) -> None:
        """Register the final limiter stack(s) — one per dispatch shard —
        plus the shard router (a replayed reset must land on the owning
        shard; the native door's ``shard_of``). Builds the snapshotter;
        call before recover()/start()."""
        self._limiters = list(limiters)
        self._shard_of = shard_of
        self.snapshotter = Snapshotter(
            self._limiters, self.wal, self.dir,
            interval=self.spec.snapshot_interval,
            after_mutations=self.spec.snapshot_after_mutations,
            retain=self.spec.retain, registry=self._registry)

    # ---------------------------------------------------------- lifecycle

    def recover(self) -> RecoveryReport:
        """Restore the newest valid snapshot and replay the WAL suffix.
        Run BEFORE serving traffic; replayed mutations pass through the
        wrappers without being re-logged."""
        assert self._limiters, "attach() first"
        self._replaying = True
        try:
            self.report = recover(self._limiters, self.dir,
                                  shard_of=self._shard_of)
        finally:
            self._replaying = False
        return self.report

    def start(self) -> None:
        assert self.snapshotter is not None, "attach() first"
        self.snapshotter.start()

    def stop(self, *, final_snapshot: bool = True) -> None:
        """Stop the background thread; by default take one last snapshot
        so a graceful shutdown loses nothing at all."""
        if self.snapshotter is not None:
            self.snapshotter.stop()
            if final_snapshot:
                try:
                    self.snapshotter.snapshot_now()
                except Exception:
                    log.exception("final shutdown snapshot failed; state "
                                  "recovers from the previous one + WAL")
        self.wal.close()

    # ------------------------------------------------------------ surface

    def slice_restorer(self) -> Callable[[int], None]:
        """The quarantine tier's restore-before-rejoin hook (ADR-015):
        a callable restoring ONE dispatch unit from the newest readable
        snapshot + WAL suffix (recover.recover_unit). Wire it as
        ``QuarantineManager.restore_fn``. Mutation replay bypasses the
        PersistentLimiter wrappers, so nothing is re-logged — safe to
        run while the rest of the deployment keeps serving."""
        from ratelimiter_tpu_torch.persistence.recover import recover_unit

        def restore(unit: int) -> None:
            assert self._limiters, "attach() first"
            recover_unit(self._limiters, self.dir, unit,
                         shard_of=self._shard_of)

        return restore

    def snapshot_now(self) -> dict:
        """Manual trigger (binary T_SNAPSHOT)."""
        assert self.snapshotter is not None, "attach() first"
        return self.snapshotter.snapshot_now()

    def add_aux_unit(self, origin: str, limiter, ranges=()) -> None:
        """Fold an adopted-range standby unit into this host's own
        snapshot cycle: every later snapshot captures it to an ``aux-*``
        file named in the manifest, so a second failure after adoption
        does not lose the adopted counters and overrides (this host's
        successor restores them, fleet/handoff.build_standby)."""
        assert self.snapshotter is not None, "attach() first"
        self.snapshotter.add_aux(origin, limiter, ranges)

    def remove_aux_unit(self, origin: str) -> None:
        assert self.snapshotter is not None, "attach() first"
        self.snapshotter.remove_aux(origin)

    def add_sidecar(self, name: str, obj) -> None:
        """Ride a non-limiter object on the snapshot cycle (the lease
        grant table). ``obj`` duck-types ``snapshot_arrays() -> (arrays,
        meta)`` / ``restore_arrays(arrays, meta)``."""
        assert self.snapshotter is not None, "attach() first"
        self.snapshotter.add_sidecar(name, obj)

    def restore_sidecar(self, name: str, obj) -> bool:
        """Restore ``obj`` from the newest manifest entry carrying a
        sidecar of this name; True iff one was found and applied. Run
        AFTER recover(): the sidecar is consistent with (not ahead of)
        the snapshot the shards restored from."""
        from ratelimiter_tpu_torch.persistence.snapshotter import (
            load_sidecar,
            read_manifest,
        )

        manifest = read_manifest(self.dir)
        if not manifest:
            return False
        for entry in reversed(manifest["snapshots"]):
            got = load_sidecar(self.dir, entry, name)
            if got is not None:
                obj.restore_arrays(got[0], got[1])
                return True
        return False

    def status(self) -> dict:
        out = self.snapshotter.status() if self.snapshotter else {
            "persistence": True, "wal_seq": self.wal.last_seq}
        if self.report is not None:
            out["recovered"] = self.report.summary()
        return out

    # ------------------------------------------------------------ logging

    def log_mutation(self, rtype: int, payload: dict) -> Optional[int]:
        """Durably append one mutation record (no-op while replaying —
        recovery must not re-log what it replays); returns the record's
        seq. The byte-delta read around append is guarded by _log_lock so
        concurrent mutators cannot double-count
        rate_limiter_wal_bytes_total."""
        if self._replaying:
            return None
        with self._log_lock:
            before = self.wal.bytes_appended
            seq = self.wal.append(rtype, payload)
            delta = self.wal.bytes_appended - before
        self._wal_records.inc()
        self._wal_bytes.inc(float(delta))
        if self.snapshotter is not None:
            self.snapshotter.notify_mutation()
        return seq


class PersistentLimiter(LimiterDecorator):
    """Outermost decorator: applies each non-decision mutation on the
    inner stack, then WAL-logs it, then returns — so an acknowledged
    mutation is durable (fsync policy permitting) and a logged record
    always describes a mutation that succeeded. Decisions pass through
    untouched (deliberately not logged)."""

    def __init__(self, inner: RateLimiter, manager: PersistenceManager):
        super().__init__(inner)
        self._persist = manager

    def reset(self, key: str) -> None:
        self.inner.reset(key)
        self._persist.log_mutation(walmod.REC_RESET, {"key": key})

    def set_override(self, key: str, limit: Optional[int] = None, *,
                     window_scale: float = 1.0):
        ov = self.inner.set_override(key, limit, window_scale=window_scale)
        # Log the STORED limit, not the request's None-means-default:
        # tiers pin absolute numbers, and replay after an update_limit
        # must restore the value that was granted, not today's default.
        self._persist.log_mutation(
            walmod.REC_POLICY_SET,
            {"key": key, "limit": int(ov.limit),
             "window_scale": float(ov.window_scale)})
        return ov

    def delete_override(self, key: str) -> bool:
        existed = self.inner.delete_override(key)
        if existed:
            self._persist.log_mutation(walmod.REC_POLICY_DEL, {"key": key})
        return existed

    def update_limit(self, new_limit: int) -> None:
        self.inner.update_limit(new_limit)
        self._persist.log_mutation(walmod.REC_UPDATE_LIMIT,
                                   {"limit": int(new_limit)})

    def update_window(self, new_window: float) -> None:
        self.inner.update_window(new_window)
        self._persist.log_mutation(walmod.REC_UPDATE_WINDOW,
                                   {"window": float(new_window)})
