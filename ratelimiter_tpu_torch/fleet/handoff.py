"""Handoff artifacts: restoring range state across fleet hosts — a port
of ``ratelimiter_tpu/fleet/handoff.py`` (ADR-018).

Every ownership move in the fleet — kill -9 failover (ADR-017), live
migration, graceful departure, and rejoin give-back — ships state the
same way: the giving side's snapshot directory (a shared/replicated
volume, ``FleetHost.snapshot_dir``) is the handoff artifact, and the
receiving side restores **before** it announces ownership
(restore-before-rejoin, the ADR-015 contract):

* ``build_standby(origin=None)`` — the failover / departure shape:
  recover the host's OWN unit from its newest snapshot + WAL suffix,
  then fold any ``aux-*`` adopted-range units its manifest records
  (ADR-017's declared leftover: without the fold, a second failure
  after adoption lost the adopted counters — the successor's successor
  now restores them from the successor's own snapshot cycle).
* ``build_standby(origin=...)`` — the rejoin shape: a returning host
  restores exactly ITS ranges from the successor's aux snapshot of the
  adopted unit, plus the WAL suffix (overrides exact; counters within
  one snapshot interval, under-count only).

Folding uses the conservative union (parallel/reshard.py): the folded
populations are disjoint key ranges, so per-key estimates never drop —
a restored standby can only deny more than the units it absorbed, never
over-admit.

A standby is built on the device the caller names (the serving
limiter's): there is no default, so an adopted range never lands on the
CPU behind a card's back. The restore and the folds are torch ops on
that device.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

from ratelimiter_tpu_torch.core.errors import CheckpointError
from ratelimiter_tpu_torch.persistence import wal as walmod
from ratelimiter_tpu_torch.persistence.snapshotter import read_manifest

log = logging.getLogger("ratelimiter_tpu_torch.fleet")


def _newest_aux_entry(manifest: Optional[dict], origin: str):
    """(snapshot entry, aux record) for the newest snapshot carrying an
    aux unit for ``origin`` — or (None, None)."""
    if manifest is None:
        return None, None
    for entry in reversed(manifest["snapshots"]):
        for aux in entry.get("aux", []):
            if aux.get("origin") == origin:
                return entry, aux
    return None, None


def _replay_wal(unit, dir_: str, after_seq: int,
                owns: Optional[Callable[[str], bool]]) -> int:
    """Replay the WAL suffix onto one standby unit: policy/config
    records apply unconditionally (write-all, the live semantics),
    resets only where the unit owns the key (subtracting a foreign
    key's estimate would erase colliding keys' mass — toward
    over-admitting, the one direction we never take)."""
    replayed = 0
    for rec in walmod.replay(dir_, after_seq=after_seq):
        p = rec.payload
        try:
            if rec.type == walmod.REC_POLICY_SET:
                unit.set_override(
                    p["key"], int(p["limit"]),
                    window_scale=float(p.get("window_scale", 1.0)))
            elif rec.type == walmod.REC_POLICY_DEL:
                unit.delete_override(p["key"])
            elif rec.type == walmod.REC_RESET:
                if owns is not None and owns(p["key"]):
                    unit.reset(p["key"])
            elif rec.type == walmod.REC_UPDATE_LIMIT:
                unit.update_limit(int(p["limit"]))
            elif rec.type == walmod.REC_UPDATE_WINDOW:
                unit.update_window(float(p["window"]))
            replayed += 1
        except Exception as exc:  # noqa: BLE001 — serve with a warning
            log.warning("handoff WAL replay apply failed (seq %d): %s",
                        rec.seq, exc)
    return replayed


def fold_aux_units(unit, dir_: str) -> int:
    """Conservative-union every aux adopted-range snapshot recorded in
    ``dir_``'s newest manifest entries into ``unit`` (one fold per
    origin, newest file each). Returns the number of origins folded."""
    from ratelimiter_tpu_torch.checkpoint import load_state
    from ratelimiter_tpu_torch.parallel import reshard

    manifest = read_manifest(dir_)
    if manifest is None:
        return 0
    seen = set()
    seen_files = set()
    folded = 0
    for entry in reversed(manifest["snapshots"]):
        for aux in entry.get("aux", []):
            origin = aux.get("origin")
            if origin in seen:
                continue
            seen.add(origin)
            if aux["file"] in seen_files:
                continue  # several origins share one merged-unit file
            seen_files.add(aux["file"])
            path = os.path.join(dir_, aux["file"])
            try:
                arrays, meta = load_state(path, unit._CKPT_KIND,
                                          unit.config)
                reshard.merge_into_limiter(unit, arrays, meta)
                folded += 1
                log.warning("handoff: folded adopted-unit snapshot for "
                            "origin %s (%s) into the standby", origin,
                            aux["file"])
            except Exception as exc:  # noqa: BLE001 — under-count only
                log.warning("handoff: aux snapshot %s unreadable (%s); "
                            "its origin's counters under-count "
                            "(fail-toward-allowing)", path, exc)
    return folded


def _restore_mesh_combined(unit, snapshot_dir: str,
                           owns: Optional[Callable[[str], bool]]) -> bool:
    """Fallback for a SLICED-MESH peer: its combined ``mesh:`` snapshot
    cannot restore a single-unit standby directly, but the elastic
    re-bucketing seam can fold it — a 1-slice re-bucket is the
    conservative union of every slice (parallel/reshard.py), so the
    standby's estimates upper-bound each slice's (deny-ward). Returns
    True when a combined snapshot was restored + WAL-replayed."""
    import numpy as np

    from ratelimiter_tpu_torch.checkpoint import _META_KEY
    from ratelimiter_tpu_torch.parallel import reshard

    manifest = read_manifest(snapshot_dir)
    if manifest is None:
        return False
    for entry in reversed(manifest["snapshots"]):
        if len(entry["files"]) != 1:
            continue
        path = os.path.join(snapshot_dir, entry["files"][0])
        try:
            import json as _json

            with np.load(path, allow_pickle=False) as z:
                meta = _json.loads(bytes(z[_META_KEY]).decode())
                if str(meta.get("kind", "")) != f"mesh:{unit._CKPT_KIND}":
                    return False
                arrays = {k: z[k] for k in z.files if k != _META_KEY}
            states, extras = reshard.split_combined(arrays, meta)
            merged, extra = reshard.merge_states(states, extras,
                                                 unit.config)
            unit.restore_state(merged, extra)
            _replay_wal(unit, snapshot_dir, int(entry["wal_seq"]), owns)
            log.warning("handoff: re-bucketed mesh snapshot %s onto the "
                        "single-unit standby (conservative union, "
                        "ADR-018)", path)
            return True
        except Exception as exc:  # noqa: BLE001 — older entry / fresh
            log.warning("handoff: combined snapshot %s unusable (%s); "
                        "falling back", path, exc)
    return False


def build_standby(config, snapshot_dir: str, *,
                  origin: Optional[str] = None,
                  owns: Optional[Callable[[str], bool]] = None,
                  clock=None, device):
    """Build one restored standby unit from a peer's snapshot
    directory. ``origin=None`` restores the peer's own unit (newest
    snapshot + WAL suffix) and folds its aux adopted units — a sliced-
    mesh peer's combined snapshot re-buckets onto the unit by
    conservative union; ``origin=<host id>`` restores that origin's aux
    unit only (the rejoin give-back). Raises on a missing/unusable
    artifact — the caller decides whether fresh state is an acceptable
    fallback."""
    from ratelimiter_tpu_torch import create_limiter
    from ratelimiter_tpu_torch.persistence.recover import recover

    unit = create_limiter(config, backend="sketch", clock=clock,
                          device=device)
    try:
        if origin is None:
            try:
                report = recover([unit], snapshot_dir)
                log.info("handoff standby from %s: %s", snapshot_dir,
                         report.summary())
            except CheckpointError:
                # Kind/shape mismatch — a sliced-mesh peer. Re-bucket
                # its combined snapshot instead of starting fresh.
                if not _restore_mesh_combined(unit, snapshot_dir, owns):
                    raise
            fold_aux_units(unit, snapshot_dir)
            return unit
        manifest = read_manifest(snapshot_dir)
        entry, aux = _newest_aux_entry(manifest, origin)
        if aux is None:
            raise CheckpointError(
                f"{snapshot_dir}: no aux snapshot for origin "
                f"{origin!r} in the manifest")
        unit.restore(os.path.join(snapshot_dir, aux["file"]))
        replayed = _replay_wal(unit, snapshot_dir,
                               int(entry["wal_seq"]), owns)
        log.info("handoff standby for origin %s from %s: restored %s, "
                 "replayed %d WAL record(s)", origin, snapshot_dir,
                 aux["file"], replayed)
        return unit
    except BaseException:
        unit.close()
        raise
