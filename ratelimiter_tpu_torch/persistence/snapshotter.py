"""Background snapshotter: device→host capture off the decision hot path
— a copy of ``ratelimiter_tpu/persistence/snapshotter.py``.

A background thread wakes on an interval (or after enough WAL
mutations), takes each limiter's lock just long enough for a device→host
copy (``capture_state`` — the cheap part), then serializes and writes
crash-atomically *off*-lock (tmp + fsync + ``os.replace``; the expensive
part never blocks decisions). A manifest written last commits the
snapshot together with the WAL watermark captured for it. The manifest
and the snapshot files have the JAX package's names and shape, so either
package can recover the other's directory.

Watermark correctness: mutations are applied to the limiter BEFORE they
are appended to the WAL (apply→log→ack), and the watermark is sampled
from the WAL *before* state capture. So every record with seq <=
watermark was fully applied before capture (it is in the snapshot), and
anything applied during/after capture has seq > watermark and gets
replayed — mutation replay is idempotent, so replaying a mutation the
snapshot already contains is harmless.

Retention: the last ``retain`` snapshots stay on disk; older snapshot
files and every WAL segment wholly below the OLDEST retained watermark
are pruned (any retained snapshot can still replay forward).

Sidecars ride the same cycle: a non-limiter object with
``snapshot_arrays() -> (arrays, meta)`` (the lease grant table,
leases/manager.py) is captured under the snapshot lock after the shards
and written as ``side-<id>-<name>.npz`` (its arrays, and its meta as a
``__meta__`` byte array), named in the manifest entry's ``sidecars``.

A sliced mesh (``--backend mesh``) snapshots as one unit on the asyncio
door (its combined ``slice<i>:`` arrays) and as one file per slice on
the native door.

Auxiliary units ride the cycle too: a fleet member's adopted-range
standby (``add_aux``) is captured after the shards and written as
``aux-<id>-<origin>.npz``, named in the manifest entry's ``aux`` with
its origin and ranges, so the member's own successor restores it
(``fleet/handoff.py``). The chaos injector's ``snapshot_capture`` hook
(the snapshot-stall scenario) runs before each capture.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
from typing import List, Optional

import numpy as np

from ratelimiter_tpu_torch.checkpoint import (
    config_fingerprint,
    save_state,
    write_atomic,
)
from ratelimiter_tpu_torch.core.errors import CheckpointError
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.persistence.wal import WriteAheadLog

log = logging.getLogger("ratelimiter_tpu_torch.persistence")

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1


def _snap_name(snap_id: int, shard: int) -> str:
    return f"snap-{snap_id:08d}-{shard:03d}.npz"


def _aux_name(snap_id: int, origin: str) -> str:
    return f"aux-{snap_id:08d}-{origin}.npz"


def _side_name(snap_id: int, name: str) -> str:
    return f"side-{snap_id:08d}-{name}.npz"


def load_sidecar(dir_: str, entry: dict, name: str):
    """Read one sidecar's ``(arrays, meta)`` from a manifest entry, or
    None when the entry has no sidecar of that name (older snapshot, or
    the subsystem was off when it was taken)."""
    import numpy as np

    for sc in entry.get("sidecars", []):
        if sc.get("name") != name:
            continue
        with np.load(os.path.join(dir_, sc["file"])) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = (json.loads(bytes(z["__meta__"]).decode("utf-8"))
                    if "__meta__" in z.files else {})
        return arrays, meta
    return None


def read_manifest(dir_: str) -> Optional[dict]:
    """The snapshot manifest, or None when the directory has none yet.
    Unparseable content raises CheckpointError: the manifest is written
    atomically, so garbage means operator damage, not a crash — refusing
    loudly beats silently starting empty."""
    path = os.path.join(dir_, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    try:
        manifest = json.loads(raw.decode("utf-8"))
        if not isinstance(manifest.get("snapshots"), list):
            raise ValueError("no snapshots list")
    except (ValueError, UnicodeDecodeError) as exc:
        raise CheckpointError(
            f"{path}: unreadable snapshot manifest ({exc}); move the "
            "directory aside to start fresh, or restore the file from "
            "backup") from exc
    return manifest


def write_manifest(dir_: str, manifest: dict) -> None:
    write_atomic(os.path.join(dir_, MANIFEST_NAME),
                 json.dumps(manifest, indent=1, sort_keys=True).encode())


class Snapshotter:
    """Interval/mutation-triggered background snapshots of one or more
    limiters (each gets its own file under one manifest entry).
    ``snapshot_now`` is also callable directly from any thread — the
    ``T_SNAPSHOT`` trigger path."""

    def __init__(self, limiters: List, wal: WriteAheadLog, dir_: str, *,
                 interval: float = 30.0, after_mutations: int = 0,
                 retain: int = 3,
                 registry: Optional[m.Registry] = None):
        self.limiters = list(limiters)
        self.wal = wal
        self.dir = dir_
        self.interval = float(interval)
        self.after_mutations = int(after_mutations)
        self.retain = int(retain)
        reg = registry if registry is not None else m.DEFAULT
        self._snap_total = reg.counter(
            "rate_limiter_snapshots_total",
            "Background/triggered state snapshots completed")
        self._snap_failures = reg.counter(
            "rate_limiter_snapshot_failures_total",
            "Snapshot attempts that raised (state on disk unchanged)")
        self._snap_duration = reg.histogram(
            "rate_limiter_snapshot_duration_seconds",
            "Wall time of one snapshot (capture + off-lock write)",
            m.SNAPSHOT_DURATION_BUCKETS)
        self._snap_ts = reg.gauge(
            "rate_limiter_last_snapshot_timestamp_seconds",
            "Unix time of the last successful snapshot (age = now - this)")
        self._snap_capture = reg.gauge(
            "rate_limiter_snapshot_capture_seconds",
            "Lock-held device->host capture portion of the last snapshot")
        self._wal_seq_gauge = reg.gauge(
            "rate_limiter_wal_seq",
            "Sequence number of the last durable WAL record")
        self._lock = threading.Lock()         # serializes snapshots
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mutations_pending = 0
        manifest = read_manifest(dir_)
        entries = manifest["snapshots"] if manifest else []
        self._next_id = (entries[-1]["id"] + 1) if entries else 1
        self.last_entry: Optional[dict] = entries[-1] if entries else None
        #: duration of the last successful snapshot
        self.last_duration: Optional[float] = None
        #: Lightweight objects riding the snapshot cycle (the lease grant
        #: table): name -> object with ``snapshot_arrays``.
        self._sidecars: dict = {}
        #: Fleet adopted-range standby units: origin host id ->
        #: {"limiter", "ranges"}; each cycle writes one file per unit.
        self._aux: dict = {}

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rl-snapshotter")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.snapshot_now()
            except Exception:
                log.exception("background snapshot failed; will retry "
                              "next interval")

    def add_sidecar(self, name: str, obj) -> None:
        """Register a sidecar (``snapshot_arrays``/``restore_arrays``
        duck type) so every later cycle captures it alongside the
        shards. The name lands in filenames — keep it short and
        path-safe."""
        if "/" in name or name != name.strip() or not name:
            raise ValueError(f"bad sidecar name {name!r}")
        with self._lock:
            self._sidecars[name] = obj

    def remove_sidecar(self, name: str) -> None:
        with self._lock:
            self._sidecars.pop(name, None)

    def add_aux(self, origin: str, limiter, ranges=()) -> None:
        """Register an auxiliary unit (an adopted-range standby) so every
        later cycle captures it alongside the shards."""
        with self._lock:
            self._aux[str(origin)] = {
                "limiter": limiter,
                "ranges": [list(r) for r in ranges]}

    def remove_aux(self, origin: str) -> None:
        with self._lock:
            self._aux.pop(str(origin), None)

    def notify_mutation(self) -> None:
        """Called per WAL append; trips the mutation-count trigger."""
        self._wal_seq_gauge.set(float(self.wal.last_seq))
        if self.after_mutations <= 0:
            return
        self._mutations_pending += 1
        if self._mutations_pending >= self.after_mutations:
            self._wake.set()

    # ----------------------------------------------------------- snapshot

    def snapshot_now(self) -> dict:
        """Take one snapshot; returns its manifest entry. Thread-safe
        (concurrent triggers serialize). Raises on failure — disk state
        is unchanged then (every write is crash-atomic and the manifest
        commits last)."""
        with self._lock:
            try:
                return self._snapshot_locked()
            except Exception:
                self._snap_failures.inc()
                raise

    def _snapshot_locked(self) -> dict:
        from ratelimiter_tpu_torch import chaos

        if chaos.INJECTOR is not None:
            # The snapshot-stall scenario sleeps here, before the
            # capture, the only phase that holds a limiter lock.
            chaos.INJECTOR.snapshot_capture()
        t0 = time.perf_counter()
        snap_id = self._next_id
        # Watermark BEFORE capture: see module docstring for why this
        # ordering (with apply-before-log mutations + idempotent replay)
        # never loses a mutation.
        wal_seq = self.wal.last_seq
        self._mutations_pending = 0
        captures = []
        for lim in self.limiters:
            captures.append((lim.capture_state(), lim.config))
        # Several origins can share one merged standby unit (a second
        # adoption folds into the mounted unit): capture and write it
        # once, each origin's manifest entry naming the shared file.
        aux_captures = []
        unit_caps: dict = {}    # id(limiter) -> (capture, config, origin)
        for origin, ent in self._aux.items():
            lim = ent["limiter"]
            key = id(lim)
            if key not in unit_caps:
                unit_caps[key] = (lim.capture_state(), lim.config, origin)
            aux_captures.append((origin, ent["ranges"], key))
        side_captures = []
        for name, obj in self._sidecars.items():
            try:
                side_captures.append((name, obj.snapshot_arrays()))
            except Exception:  # noqa: BLE001 — a sidecar must never
                # block the shards' durability
                log.exception("sidecar %r capture failed; skipping", name)
        capture_s = time.perf_counter() - t0
        # Off-lock from here: serialization + fsync happen while decisions
        # keep flowing.
        files = []
        for shard, ((kind, arrays, extra), config) in enumerate(captures):
            name = _snap_name(snap_id, shard)
            extra = {**extra, "wal_seq": wal_seq, "shard": shard}
            save_state(os.path.join(self.dir, name), kind, config,
                       arrays, extra)
            files.append(name)
        aux_files: dict = {}
        for key, ((kind, arrays, extra), config,
                  first_origin) in unit_caps.items():
            name = _aux_name(snap_id, first_origin)
            extra = {**extra, "wal_seq": wal_seq, "origin": first_origin}
            save_state(os.path.join(self.dir, name), kind, config,
                       arrays, extra)
            aux_files[key] = name
        aux_entries = [{"origin": origin, "file": aux_files[key],
                        "ranges": ranges}
                       for origin, ranges, key in aux_captures]
        side_entries = []
        for name, (arrays, meta) in side_captures:
            fname = _side_name(snap_id, name)
            buf = io.BytesIO()
            np.savez(buf, __meta__=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8),
                **arrays)
            write_atomic(os.path.join(self.dir, fname), buf.getvalue())
            side_entries.append({"name": name, "file": fname})
        cfg = self.limiters[0].config
        entry = {
            "id": snap_id,
            "wal_seq": wal_seq,
            "created_at": time.time(),
            "files": files,
            "shards": len(files),
            "config_fingerprint": config_fingerprint(cfg),
            # Operator-facing description of the config the snapshot was
            # taken under — surfaced by recovery's mismatch error.
            "config": {"algorithm": str(cfg.algorithm.value),
                       "limit": cfg.limit, "window": cfg.window},
        }
        if aux_entries:
            entry["aux"] = aux_entries
        if side_entries:
            entry["sidecars"] = side_entries
        manifest = read_manifest(self.dir) or {
            "format_version": MANIFEST_VERSION, "snapshots": []}
        manifest["snapshots"].append(entry)
        manifest["snapshots"] = manifest["snapshots"][-self.retain:]
        write_manifest(self.dir, manifest)
        self._next_id = snap_id + 1
        self._prune(manifest)
        dt = time.perf_counter() - t0
        self.last_entry = entry
        self.last_duration = dt
        self._snap_total.inc()
        self._snap_duration.observe(dt)
        self._snap_ts.set(entry["created_at"])
        self._snap_capture.set(capture_s)
        self._wal_seq_gauge.set(float(wal_seq))
        log.info("snapshot %d: %d shard file(s), wal_seq=%d, %.1f ms "
                 "(%.1f ms capture)", snap_id, len(files), wal_seq,
                 dt * 1e3, capture_s * 1e3)
        return {**entry, "duration_s": round(dt, 4)}

    def _prune(self, manifest: dict) -> None:
        """Drop snapshot files not referenced by the manifest and WAL
        segments wholly below the oldest retained watermark."""
        keep = {name for e in manifest["snapshots"] for name in e["files"]}
        keep |= {s["file"] for e in manifest["snapshots"]
                 for s in e.get("sidecars", [])}
        keep |= {a["file"] for e in manifest["snapshots"]
                 for a in e.get("aux", [])}
        try:
            for name in os.listdir(self.dir):
                if (name.startswith(("snap-", "aux-", "side-"))
                        and name.endswith(".npz")
                        and name not in keep):
                    try:
                        os.unlink(os.path.join(self.dir, name))
                    except OSError:
                        pass
        except OSError:
            pass
        oldest = min(e["wal_seq"] for e in manifest["snapshots"])
        self.wal.prune(oldest)

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        """Health fields: last snapshot id/age/duration + WAL position."""
        out = {"persistence": True, "wal_seq": self.wal.last_seq}
        if self.last_entry is not None:
            out["last_snapshot_id"] = self.last_entry["id"]
            out["last_snapshot_wal_seq"] = self.last_entry["wal_seq"]
            out["last_snapshot_age_s"] = round(
                max(0.0, time.time() - self.last_entry["created_at"]), 3)
        if self.last_duration is not None:
            out["last_snapshot_duration_s"] = round(self.last_duration, 4)
        return out
