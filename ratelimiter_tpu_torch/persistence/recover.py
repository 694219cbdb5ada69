"""Crash recovery: newest valid snapshot + WAL suffix replay — a copy of
``ratelimiter_tpu/persistence/recover.py`` (``recover``,
``_restore_snapshot``, ``_apply``).

On startup with persistence enabled:

1. load the newest snapshot from the manifest whose files are readable —
   a *corrupt* snapshot falls back to the previous retained one (its
   watermark is older, so strictly more WAL replays — correctness is
   unaffected), but a *fingerprint/kind mismatch* refuses loudly: that is
   config drift, every retained snapshot was taken under the same config,
   and silently reinterpreting state arrays is exactly what the
   fingerprint exists to prevent;
2. replay every intact WAL record past the loaded snapshot's watermark
   (or the whole log when no snapshot exists yet).

Net guarantees: policy overrides and dynamic config updates recover
EXACTLY (they are WAL-logged, fsynced before the mutation is
acknowledged); per-decision counters recover to the last snapshot — the
crash window loses at most one snapshot interval of decisions, in the
under-counting (fail-toward-allowing) direction. Replay application is
idempotent, so records the snapshot already contains reapply harmlessly.

Left out: ``recover_unit``, the slice-scoped recovery of the mesh's
quarantine tier (ROADMAP A8).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ratelimiter_tpu_torch.core.errors import CheckpointError
from ratelimiter_tpu_torch.persistence import wal as walmod
from ratelimiter_tpu_torch.persistence.snapshotter import read_manifest

log = logging.getLogger("ratelimiter_tpu_torch.persistence")


@dataclass
class RecoveryReport:
    """What recovery did — logged at startup."""

    snapshot_id: Optional[int] = None
    wal_seq: int = 0                 # watermark replay started after
    replayed: int = 0                # WAL records applied
    apply_errors: List[str] = field(default_factory=list)

    def summary(self) -> str:
        base = (f"restored snapshot {self.snapshot_id}"
                if self.snapshot_id is not None else "no snapshot found")
        tail = f", replayed {self.replayed} WAL record(s) past seq {self.wal_seq}"
        if self.apply_errors:
            tail += f", {len(self.apply_errors)} replay error(s)"
        return base + tail


def _restore_snapshot(limiters: List, dir_: str) -> RecoveryReport:
    """Load the newest loadable manifest entry into every shard limiter.
    Returns a report carrying the watermark to replay past."""
    manifest = read_manifest(dir_)
    report = RecoveryReport()
    if manifest is None:
        return report
    tainted = False          # some shard holds a partial entry's state
    for entry in reversed(manifest["snapshots"]):
        if len(entry["files"]) != len(limiters):
            raise CheckpointError(
                f"snapshot {entry['id']} in {dir_} has "
                f"{len(entry['files'])} shard file(s) but this server "
                f"runs {len(limiters)} shard(s); move the directory aside")
        restored = 0
        try:
            for lim, name in zip(limiters, entry["files"]):
                lim.restore(os.path.join(dir_, name))
                restored += 1
        except CheckpointError as exc:
            # Config drift, not corruption: refuse loudly. Every retained
            # snapshot shares the config, so falling back cannot help.
            cfg = entry.get("config", {})
            raise CheckpointError(
                f"snapshot {entry['id']} in {dir_} refuses to load: {exc}. "
                f"The snapshot was taken under "
                f"algorithm={cfg.get('algorithm')!r} "
                f"limit={cfg.get('limit')} window={cfg.get('window')}; "
                "boot with the flags the snapshot was taken under (config "
                "fingerprints must match), or move the snapshot directory "
                "aside to start empty") from exc
        except Exception as exc:
            # Restore fully replaces a shard's state, so a SUCCESSFUL
            # older entry overwrites these partial restores — but if no
            # entry ever succeeds, shards would be left mixed across
            # entries; track that and refuse below.
            tainted = tainted or restored > 0
            log.warning("snapshot %s unreadable (%s); falling back to the "
                        "previous retained snapshot", entry["id"], exc)
            continue
        report.snapshot_id = entry["id"]
        report.wal_seq = int(entry["wal_seq"])
        return report
    if tainted:
        raise CheckpointError(
            f"no retained snapshot in {dir_} was fully readable, and a "
            "partial restore already touched some shard(s) — refusing to "
            "replay the WAL onto mixed state; move the snapshot "
            "directory aside to start empty")
    if manifest["snapshots"]:
        log.warning("no retained snapshot in %s was readable; replaying "
                    "the whole WAL onto fresh state", dir_)
    return report


def _apply(rec: walmod.WalRecord, limiters: List,
           shard_of: Optional[Callable[[str], int]]) -> None:
    p = rec.payload
    if rec.type == walmod.REC_POLICY_SET:
        for lim in limiters:
            lim.set_override(p["key"], int(p["limit"]),
                             window_scale=float(p.get("window_scale", 1.0)))
    elif rec.type == walmod.REC_POLICY_DEL:
        for lim in limiters:
            lim.delete_override(p["key"])
    elif rec.type == walmod.REC_RESET:
        # Reset routes to the key's owning shard only, as the live reset
        # does: on a sketch shard that never saw the key, reset would
        # subtract colliding keys' mass.
        if shard_of is not None and len(limiters) > 1:
            limiters[shard_of(p["key"]) % len(limiters)].reset(p["key"])
        else:
            limiters[0].reset(p["key"])
    elif rec.type == walmod.REC_UPDATE_LIMIT:
        for lim in limiters:
            lim.update_limit(int(p["limit"]))
    elif rec.type == walmod.REC_UPDATE_WINDOW:
        for lim in limiters:
            lim.update_window(float(p["window"]))
    else:
        raise CheckpointError(f"unknown WAL record type {rec.type}")


def recover(limiters: List, dir_: str, *,
            shard_of: Optional[Callable[[str], int]] = None,
            ) -> RecoveryReport:
    """Restore ``limiters`` (one per dispatch shard) from ``dir_``;
    ``shard_of`` routes a replayed reset to its key's shard.

    Never raises on torn/truncated WAL data (the log replays to its
    intact prefix); DOES raise CheckpointError on config-fingerprint
    drift or an unreadable manifest — both need an operator decision.
    Individual replay-apply failures are recorded in the report and
    logged, not raised: a mutation that validated when it was logged can
    only fail under drift the fingerprint gate already screens for, and
    recovery prefers serving with a warning over refusing outright.
    """
    report = _restore_snapshot(limiters, dir_)
    for rec in walmod.replay(dir_, after_seq=report.wal_seq):
        try:
            _apply(rec, limiters, shard_of)
            report.replayed += 1
        except Exception as exc:
            msg = (f"seq {rec.seq} ({walmod.REC_NAMES.get(rec.type, '?')}): "
                   f"{exc}")
            report.apply_errors.append(msg)
            log.warning("WAL replay apply failed: %s", msg)
    log.info("recovery: %s", report.summary())
    return report
