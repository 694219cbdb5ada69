"""Durability subsystem: write-ahead log + background snapshots with
crash recovery — a copy of ``ratelimiter_tpu/persistence/``.

State lives in device memory and dies with the process, so durability is
explicit: mutations (policy overrides, resets, dynamic config) are
WAL-logged and recover exactly; decision counters are snapshotted in the
background and recover to within one snapshot interval, under-counting —
the fail-toward-allowing posture. WAL segments, snapshot files and the
manifest are the JAX package's, byte for byte where the inputs match, so
either package recovers the other's directory.

    from ratelimiter_tpu_torch.persistence import PersistenceManager

    mgr = PersistenceManager(cfg.persistence)
    lim = mgr.wrap(create_limiter(cfg))
    mgr.attach([lim])
    mgr.recover()      # before traffic
    mgr.start()        # background snapshots
"""

from ratelimiter_tpu_torch.persistence.manager import (
    PersistenceManager,
    PersistentLimiter,
)
from ratelimiter_tpu_torch.persistence.recover import RecoveryReport, recover
from ratelimiter_tpu_torch.persistence.snapshotter import (
    Snapshotter,
    read_manifest,
)
from ratelimiter_tpu_torch.persistence.wal import (
    WalRecord,
    WriteAheadLog,
    replay,
)

__all__ = [
    "PersistenceManager",
    "PersistentLimiter",
    "RecoveryReport",
    "recover",
    "Snapshotter",
    "read_manifest",
    "WalRecord",
    "WriteAheadLog",
    "replay",
]
