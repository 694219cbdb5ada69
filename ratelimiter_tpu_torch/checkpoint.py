"""Checkpoint / restore of limiter state — a copy of
``ratelimiter_tpu/checkpoint.py``.

State lives in device memory and dies with the process, so snapshot and
restore are explicit.

Format: one ``.npz`` holding the state arrays plus a JSON header with a
format version, a backend kind tag, and a **config fingerprint** — restore
refuses a snapshot taken under a different algorithm/limit/window/geometry
(the arrays would be reinterpreted silently otherwise). The format, the
meta key and the fingerprint are the JAX package's, byte for byte, so a
file saved by either package restores in the other, the heavy-hitter side
table's ``hh_*`` arrays included (uint32 owners, as there; a file without
``hh_owner2`` restores it as zeros, convert.py).

Staleness semantics:

* decisions made after the snapshot are lost on restore — the restored
  limiter *under*-counts the crash window, so errors are toward ALLOWING,
  the right direction for availability;
* elapsed wall time between save and restore needs no special handling:
  every backend keys its state off absolute host timestamps, so the first
  post-restore dispatch applies the usual catch-up (windowed sketch:
  sub-window rollover masks out expired slabs; token bucket: decay from
  the restored ``last``; dense and exact windows: lazy window roll). A
  snapshot restored after >= 1 full window therefore behaves like a
  fresh limiter, as it must.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import os
from dataclasses import asdict
from typing import Any, Dict, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.core.errors import CheckpointError

FORMAT_VERSION = 1
_META_KEY = "__ratelimiter_tpu_meta__"
_tmp_counter = itertools.count()

def config_fingerprint(config: Config) -> str:
    """Stable hash over every semantic config field: the JAX package's
    digest for the same config. The persistence spec and
    ``sketch.kernels`` are excluded (operational knobs, not state
    geometry), as is the hierarchy spec while it is disabled (so every
    pre-hierarchy snapshot keeps its fingerprint); enabled, the cascade's
    geometry shapes the ``tn_*`` arrays and participates. The mesh spec
    (slice placement, not state geometry) is excluded, as in the JAX
    package.
    tests/test_torch_persistence.py pins the JAX golden value,
    tests/test_torch_hier.py an enabled spec's and tests/test_torch_dense.py
    a non-default dense spec's."""
    fields = asdict(config)
    fields.pop("persistence", None)
    fields.pop("mesh", None)
    fields["sketch"].pop("kernels", None)
    if not fields["hierarchy"].get("tenants"):
        fields.pop("hierarchy")
    payload = json.dumps(
        {**fields, "algorithm": str(config.algorithm)},
        sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (the rename itself lives in the directory's metadata). Best-effort:
    some filesystems/platforms refuse O_RDONLY fsync on directories."""
    try:
        fd = os.open(path if path else ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_atomic(path: str, data: bytes) -> None:
    """Crash-atomic file write: tmp + fsync(file) + os.replace + fsync(dir).
    A crash at ANY point leaves either the old file or the new one, never
    a torn mix; after return the bytes are on stable storage."""
    # Unique per call: concurrent writers to one path must not share a
    # tmp name.
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def save_state(path: str, kind: str, config: Config,
               arrays: Dict[str, np.ndarray], extra: Dict[str, Any]) -> None:
    """Crash-atomic snapshot write (see write_atomic): a crash mid-save
    never corrupts the previous snapshot, and a completed save survives
    power loss (file and directory entry both fsynced)."""
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "config_fingerprint": config_fingerprint(config),
        **extra,
    }
    write_raw(path, arrays, meta)


def write_raw(path: str, arrays: Dict[str, np.ndarray],
              meta: Dict[str, Any]) -> None:
    """The snapshot's file format, written crash-atomic: the arrays and
    the JSON ``meta`` under ``_META_KEY`` in one npz. No validation
    (``save_state`` builds ``meta``; the offline re-bucketer carries a
    read one through)."""
    if _META_KEY in arrays:
        raise CheckpointError(f"array name {_META_KEY!r} is reserved")
    buf = io.BytesIO()
    np.savez(buf, **arrays,
             **{_META_KEY: np.frombuffer(
                 json.dumps(meta).encode(), dtype=np.uint8)})
    write_atomic(path, buf.getvalue())


def read_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A snapshot's arrays and meta, unvalidated (``load_state``
    validates them)."""
    with np.load(path, allow_pickle=False) as z:
        if _META_KEY not in z.files:
            raise CheckpointError(f"{path}: not a ratelimiter_tpu checkpoint")
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY]).decode())
    return arrays, meta


def load_state(path: str, kind: str, config: Config,
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load + validate a snapshot for the given limiter kind and config."""
    arrays, meta = read_raw(path)
    if meta.get("format_version") != FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: format version {meta.get('format_version')} != "
            f"{FORMAT_VERSION}")
    if meta.get("kind") != kind:
        raise CheckpointError(
            f"{path}: snapshot kind {meta.get('kind')!r} cannot restore a "
            f"{kind!r} limiter")
    fp = config_fingerprint(config)
    if meta.get("config_fingerprint") != fp:
        raise CheckpointError(
            f"{path}: config fingerprint mismatch — snapshot was taken "
            "under a different algorithm/limit/window/geometry")
    return arrays, meta
