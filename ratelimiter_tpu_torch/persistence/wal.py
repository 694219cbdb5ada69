"""Write-ahead log for non-decision mutations — a copy of
``ratelimiter_tpu/persistence/wal.py``: the same framing, CRC, segment
names and JSON payloads, so the same mutations give byte-identical
segment files in either package and either package replays the other's.

Per-decision traffic is deliberately NOT logged: at
millions of decisions/sec a per-decision log would be the new hot path,
and losing the crash window's decisions only *under*-counts — the
documented fail-toward-allowing posture (checkpoint.py staleness
contract). What IS logged is everything whose loss an operator would
notice as a config regression: policy ``set/delete_override``, ``reset``,
and dynamic ``update_limit`` / ``update_window``. Those replay exactly.

Record framing (little-endian), append-only:

    u32  crc32      over the rest of the record (length..payload)
    u32  length     payload byte count
    u64  seq        dense, monotonically increasing from 1
    u8   type       REC_* below
    ...  payload    canonical JSON, utf-8

Recovery truncates at the first torn record: a record is accepted only
if its header is complete, its length is sane, its payload is complete,
its CRC matches, and its seq is exactly ``prev + 1``. Anything else ends
the replay — the intact prefix is exactly what was durably acknowledged
(tests/test_torch_persistence.py truncates at every byte offset).

Segments rotate at ``max_bytes``; a segment file is named by the seq of
its first record (``wal-<seq:020d>.log``), so segment boundaries are
reconstructible from names alone and pruning below a snapshot watermark
is a file unlink, not a rewrite.

Thread model: ``append`` is serialized by an internal lock (mutations
are rare control-plane operations). Readers (``replay``) only ever run
on startup, before traffic.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ratelimiter_tpu_torch.checkpoint import fsync_dir
from ratelimiter_tpu_torch.core.errors import CheckpointError

log = logging.getLogger("ratelimiter_tpu_torch.persistence")

#: Record types (u8 on the wire).
REC_POLICY_SET = 1
REC_POLICY_DEL = 2
REC_RESET = 3
REC_UPDATE_LIMIT = 4
REC_UPDATE_WINDOW = 5

REC_NAMES = {
    REC_POLICY_SET: "policy_set",
    REC_POLICY_DEL: "policy_del",
    REC_RESET: "reset",
    REC_UPDATE_LIMIT: "update_limit",
    REC_UPDATE_WINDOW: "update_window",
}

_HEAD = struct.Struct("<IIQB")          # crc, length, seq, type
#: Far above any legal mutation payload (a key caps at 4 KiB on the
#: wire); bounds what a corrupt length field can make replay allocate.
MAX_PAYLOAD = 1 << 20

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


def _seg_name(first_seq: int) -> str:
    return f"{_SEG_PREFIX}{first_seq:020d}{_SEG_SUFFIX}"


def _seg_first_seq(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    digits = name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]
    return int(digits) if digits.isdigit() else None


def _encode(seq: int, rtype: int, payload: Dict[str, Any]) -> bytes:
    body = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    rest = struct.pack("<IQB", len(body), seq, rtype) + body
    return struct.pack("<I", zlib.crc32(rest)) + rest


@dataclass(frozen=True)
class WalRecord:
    seq: int
    type: int
    payload: Dict[str, Any]


def _scan_buffer(buf: bytes, prev_seq: int) -> Tuple[List[WalRecord], int]:
    """(intact records, valid byte length) of one segment's contents.
    Never raises: the first structural violation ends the scan — that is
    the torn-tail truncation point."""
    records: List[WalRecord] = []
    off = 0
    while off + _HEAD.size <= len(buf):
        crc, length, seq, rtype = _HEAD.unpack_from(buf, off)
        if length > MAX_PAYLOAD or seq != prev_seq + 1:
            break
        end = off + _HEAD.size + length
        if end > len(buf):
            break
        rest = buf[off + 4:end]
        if zlib.crc32(rest) != crc:
            break
        try:
            payload = json.loads(buf[off + _HEAD.size:end].decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            break
        records.append(WalRecord(seq, rtype, payload))
        prev_seq = seq
        off = end
    return records, off


def segment_files(dir_: str) -> List[Tuple[int, str]]:
    """Sorted (first_seq, path) of every WAL segment in ``dir_``."""
    try:
        names = os.listdir(dir_)
    except OSError:
        return []
    out = []
    for name in names:
        first = _seg_first_seq(name)
        if first is not None:
            out.append((first, os.path.join(dir_, name)))
    return sorted(out)


def replay(dir_: str, after_seq: int = 0) -> Iterator[WalRecord]:
    """Yield intact records with ``seq > after_seq``, in order. Never
    raises on torn/corrupt data: replay stops at the first record that
    fails validation (including a seq gap between segments — a missing
    middle segment must not let later mutations replay out of order)."""
    prev = 0
    for first_seq, path in segment_files(dir_):
        if first_seq != prev + 1:
            if prev:
                log.warning("WAL segment gap at %s (expected seq %d); "
                            "stopping replay at the intact prefix",
                            path, prev + 1)
            if first_seq <= prev:
                continue
            if prev:
                return
            # No earlier segments at all (pruned): the first segment
            # defines where history starts.
            prev = first_seq - 1
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except OSError:
            return
        records, valid = _scan_buffer(buf, prev)
        for rec in records:
            if rec.seq > after_seq:
                yield rec
        if valid != len(buf):
            log.warning("WAL %s: torn record at byte %d of %d; replayed "
                        "the intact prefix", path, valid, len(buf))
            return
        if records:
            prev = records[-1].seq
        elif buf:
            return
        else:
            prev = first_seq - 1 if prev == 0 else prev


class WriteAheadLog:
    """Append-only CRC-framed mutation log with rotation and pruning.

    ``fsync`` policy: "always" syncs every append before returning (the
    durability guarantee the serving tier acknowledges mutations under),
    "interval" syncs at most every ``fsync_interval`` seconds, "never"
    leaves flushing to the OS.
    """

    def __init__(self, dir_: str, *, fsync: str = "always",
                 fsync_interval: float = 0.05,
                 max_bytes: int = 64 << 20):
        if fsync not in ("always", "interval", "never"):
            raise ValueError(f"bad fsync policy {fsync!r}")
        self.dir = dir_
        self._fsync = fsync
        self._fsync_interval = float(fsync_interval)
        self._max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._file = None
        self._size = 0
        self._last_sync = 0.0
        self.records_appended = 0
        self.bytes_appended = 0
        os.makedirs(dir_, exist_ok=True)
        self._lock_fd = self._acquire_dir_lock()
        self.last_seq = self._open_tail()

    # ------------------------------------------------------------ startup

    def _acquire_dir_lock(self):
        """Single-writer guard: two processes appending to one WAL
        interleave frames and clobber each other's manifest, silently
        corrupting recovery — a double-started supervisor or a restart
        racing the draining predecessor must fail LOUDLY instead. flock
        releases on process death, so kill -9 never wedges the lock."""
        path = os.path.join(self.dir, "wal.lock")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:        # non-POSIX: no guard available
            pass
        except OSError as exc:
            os.close(fd)
            raise CheckpointError(
                f"{self.dir}: another process holds the write-ahead log "
                f"({exc}); a persistence directory has exactly one "
                "writer — wait for the previous instance to exit or "
                "point --snapshot-dir elsewhere") from exc
        return fd

    def _open_tail(self) -> int:
        """Find the last durable seq, truncate the active segment past the
        first torn record (appends must land after the valid prefix, not
        after garbage), and open it for append."""
        segs = segment_files(self.dir)
        if not segs:
            return 0
        # Validate every segment to find the global last seq; only the
        # LAST segment is opened for append (and truncated if torn). A
        # torn record ANYWHERE ELSE — mid-history corruption or a
        # missing middle segment — refuses loudly: replay() permanently
        # stops at the first violation, so acknowledging new appends
        # past one would accept mutations that can never recover.
        prev = segs[0][0] - 1
        for i, (first_seq, path) in enumerate(segs):
            if first_seq != prev + 1 and i > 0:
                raise CheckpointError(
                    f"{self.dir}: WAL segment gap before "
                    f"{os.path.basename(path)} (expected seq {prev + 1}) "
                    "— mutations after the gap can never replay; move "
                    "the directory aside to start fresh")
            with open(path, "rb") as f:
                buf = f.read()
            records, valid = _scan_buffer(buf, prev)
            if records:
                prev = records[-1].seq
            if valid != len(buf):
                if i != len(segs) - 1:
                    raise CheckpointError(
                        f"{self.dir}: torn/corrupt record mid-history in "
                        f"{os.path.basename(path)} (byte {valid}) — "
                        "mutations after it can never replay; move the "
                        "directory aside to start fresh")
                log.warning("WAL %s: truncating torn tail at byte %d",
                            path, valid)
                with open(path, "rb+") as f:
                    f.truncate(valid)
                    f.flush()
                    os.fsync(f.fileno())
        last_path = segs[-1][1]
        self._file = open(last_path, "ab")
        self._size = os.path.getsize(last_path)
        return prev

    # ------------------------------------------------------------- append

    def append(self, rtype: int, payload: Dict[str, Any]) -> int:
        """Durably append one record; returns its seq. The record is on
        stable storage when this returns under fsync="always"."""
        with self._lock:
            seq = self.last_seq + 1
            frame = _encode(seq, rtype, payload)
            if self._file is None or (
                    self._size and self._size + len(frame) > self._max_bytes):
                self._rotate(seq)
            self._file.write(frame)
            self._size += len(frame)
            self.last_seq = seq
            self.records_appended += 1
            self.bytes_appended += len(frame)
            now = time.monotonic()
            if self._fsync == "always" or (
                    self._fsync == "interval"
                    and now - self._last_sync >= self._fsync_interval):
                self._file.flush()
                os.fsync(self._file.fileno())
                self._last_sync = now
            return seq

    def _rotate(self, first_seq: int) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
        path = os.path.join(self.dir, _seg_name(first_seq))
        self._file = open(path, "ab")
        self._size = os.path.getsize(path)
        fsync_dir(self.dir)

    def sync(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._last_sync = time.monotonic()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None
            if self._lock_fd is not None:
                os.close(self._lock_fd)     # releases the flock
                self._lock_fd = None

    # -------------------------------------------------------------- prune

    def prune(self, upto_seq: int) -> int:
        """Unlink closed segments whose every record has seq <= upto_seq
        (seqs are dense, so a segment's last seq is the next segment's
        first minus one). The active segment is never removed. Returns
        the number of segments deleted."""
        with self._lock:
            segs = segment_files(self.dir)
            removed = 0
            for (first, path), (next_first, _) in zip(segs, segs[1:]):
                if next_first - 1 <= upto_seq:
                    try:
                        os.unlink(path)
                        removed += 1
                    except OSError:
                        pass
            if removed:
                fsync_dir(self.dir)
            return removed
