"""Control-plane event journal: WHY the limiter changed its mind (ADR-021).

A copy of ``ratelimiter_tpu/observability/events.py``, its code
verbatim (tests/test_torch_events.py holds it to the JAX package's).

The flight recorder (ADR-014) answers "where did this frame's latency
go" and the observatory (ADR-016) answers "how accurate are we being" —
but once N hosts serve as ONE limiter, the questions an
operator actually asks during an incident are control-plane ones: *why
did tenant X get tightened at 14:02, who adopted h1's ranges, when did
slice 3 quarantine, which member published epoch 9?* Until now those
answers lived in scattered WARNING log lines on N machines. This module
is the structured, bounded, queryable record of every control-plane
transition, exposed per member via bearer-gated ``GET /debug/events``
(cursor-paginated) and fleet-wide via ``GET /debug/events?fleet=1``
(merged on the membership's estimated clock offsets, fleet/tower.py).

Design rules:

* **Events are rare.** Controller moves, quarantine transitions,
  handoffs, failovers, epoch bumps, policy/tenant mutations — tens per
  minute at the very worst. A plain lock + deque is the right cost
  model; nothing here is ever on the decide path.
* **Same module-global seam** as ``tracing.RECORDER`` / ``audit.AUDITOR``
  / the chaos injector: library code calls :func:`emit`, which is one
  None check when the journal is off. The server binary enables it by
  default (``--no-event-journal`` opts out) because the whole point is
  being able to reconstruct an incident you did not predict.
* **Every event carries both clocks**: wall time (human correlation,
  NTP-grade) and CLOCK_MONOTONIC ns (the span clock, ADR-014) — the
  fleet merge aligns members on the same per-peer monotonic offsets the
  trace stitcher uses, so events interleave correctly with spans on one
  Perfetto timeline.
* **Correlation ids** join an event to its cause: a controller tick
  stamps one id on every move it makes (and into its log line), handoff
  events share the giver's id across send/receive/flip, and a traced
  frame's trace id can ride along. Ids render as 16-hex tokens, the
  trace-id convention.

Cursor pagination contract (``read``): the caller passes ``after`` (the
last ``seq`` it has seen; 0 = from the oldest held) and gets events with
``seq > after`` in order, up to ``limit``, plus ``cursor`` (pass it back
as the next ``after``) and ``truncated`` (True when the bounded ring
dropped events the cursor never saw — the caller's history has a hole).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: Category vocabulary (free-form strings are accepted — a dump must
#: never be lost to a new subsystem — but the known set is documented
#: so dashboards can enumerate it).
CATEGORIES = (
    "controller",   # AIMD tighten/relax with the triggering signals
    "quarantine",   # slice state transitions (ADR-015)
    "handoff",      # live migration / departure / rejoin phases (ADR-018)
    "failover",     # dead-peer range adoption (ADR-017)
    "epoch",        # ownership-map installs/adoptions
    "membership",   # peer liveness transitions
    "policy",       # per-key override + reset mutations
    "tenant",       # tenant registry / assignment / effective-limit moves
    "lease",        # client-embedded quota leases: grant/return/revoke/expire
    "placement",    # load-aware rebalancing: plan/move/abort/veto (ADR-023)
)


class EventJournal:
    """Bounded in-memory ring of structured control-plane events."""

    def __init__(self, capacity: int = 4096, *, host: str = "",
                 registry=None, spill_dir: Optional[str] = None,
                 spill_segment_bytes: int = 1 << 20,
                 spill_segments: int = 8):
        if capacity < 16:
            raise ValueError(f"capacity must be >= 16, got {capacity}")
        self.capacity = int(capacity)
        self.host = host
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "rate_limiter_events_total",
                "Control-plane events recorded in the event journal "
                "(ADR-021), by category")
        # Optional append-only file spill: a restart replays the tail
        # of the on-disk segments back into the ring, so pre-restart
        # events survive (`--event-journal-dir`). Bounded: segments
        # rotate at spill_segment_bytes and the oldest is deleted past
        # spill_segments. Spill failures NEVER break serving — they are
        # counted and surfaced in status().
        self._spill_dir = spill_dir
        self._spill_segment_bytes = max(4096, int(spill_segment_bytes))
        self._spill_segments = max(1, int(spill_segments))
        self._spill_file = None
        self._spill_path = ""
        self._spill_index = 0
        self._spill_written = 0
        self._spill_errors = 0
        self._replayed = 0
        if spill_dir:
            self._spill_open(spill_dir)

    # ------------------------------------------------------------ spill

    _SEG_RE = re.compile(r"^events-(\d{8})\.jsonl$")

    def _segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self._spill_dir)
                           if self._SEG_RE.match(n))
        except OSError:
            return []
        return names

    def _spill_open(self, spill_dir: str) -> None:
        try:
            os.makedirs(spill_dir, exist_ok=True)
            segs = self._segments()
            # Replay the on-disk tail (oldest segment first) into the
            # ring, re-sequencing: seqs are per-process-generation, the
            # ring's contract is only "monotonic within this journal".
            replay: deque = deque(maxlen=self.capacity)
            for name in segs:
                try:
                    with open(os.path.join(self._spill_dir, name),
                              encoding="utf-8") as f:
                        for line in f:
                            line = line.strip()
                            if not line:
                                continue
                            try:
                                e = json.loads(line)
                            except ValueError:
                                continue  # torn tail write (kill -9)
                            if isinstance(e, dict) and "category" in e:
                                replay.append(e)
                except OSError:
                    continue
            for e in replay:
                self._seq += 1
                e["seq"] = self._seq
                e.setdefault("replayed", True)
                self._events.append(e)
            self._replayed = len(replay)
            if segs:
                self._spill_index = int(
                    self._SEG_RE.match(segs[-1]).group(1)) + 1
            self._spill_rotate_locked()
        except OSError:
            self._spill_errors += 1
            self._spill_file = None

    def _spill_rotate_locked(self) -> None:
        if self._spill_file is not None:
            try:
                self._spill_file.close()
            except OSError:
                pass
        self._spill_path = os.path.join(
            self._spill_dir, f"events-{self._spill_index:08d}.jsonl")
        self._spill_file = open(self._spill_path, "a",
                                encoding="utf-8")
        self._spill_index += 1
        self._spill_written = 0
        # Enforce the segment bound (oldest deleted first).
        segs = self._segments()
        while len(segs) > self._spill_segments:
            try:
                os.unlink(os.path.join(self._spill_dir, segs.pop(0)))
            except OSError:
                break

    def _spill_locked(self, event: dict) -> None:
        if self._spill_file is None:
            return
        try:
            line = json.dumps(event, sort_keys=True,
                              default=str) + "\n"
            self._spill_file.write(line)
            self._spill_file.flush()
            self._spill_written += len(line)
            if self._spill_written >= self._spill_segment_bytes:
                self._spill_rotate_locked()
        except (OSError, ValueError):
            self._spill_errors += 1

    def close(self) -> None:
        with self._lock:
            if self._spill_file is not None:
                try:
                    self._spill_file.close()
                except OSError:
                    pass
                self._spill_file = None

    # ----------------------------------------------------------- record

    def record(self, category: str, action: str, *, actor: str = "",
               corr: int = 0, severity: str = "info",
               payload: Optional[dict] = None) -> int:
        """Append one event; returns its seq. ``corr`` is a u64
        correlation id (0 = none), rendered as the 16-hex trace-id
        convention so it joins against flight-recorder spans."""
        now_wall = time.time()
        now_mono = time.monotonic_ns()
        with self._lock:
            self._seq += 1
            seq = self._seq
            event = {
                "seq": seq,
                "ts": round(now_wall, 6),
                "mono_ns": now_mono,
                "category": str(category),
                "action": str(action),
                "actor": str(actor),
                "corr": (f"{corr & 0xFFFFFFFFFFFFFFFF:016x}" if corr
                         else ""),
                "severity": str(severity),
                "payload": dict(payload) if payload else {},
            }
            self._events.append(event)
            self._spill_locked(event)
        c = self._counter
        if c is not None:
            c.inc(category=str(category))
        return seq

    # ------------------------------------------------------------- read

    def read(self, after: int = 0, limit: int = 256,
             category: Optional[str] = None) -> Dict:
        """Events with ``seq > after`` (oldest first), up to ``limit``.
        See the module docstring for the pagination contract."""
        limit = max(1, min(int(limit), self.capacity))
        with self._lock:
            events = list(self._events)
            newest = self._seq
        oldest = events[0]["seq"] if events else newest + 1
        out: List[dict] = []
        for e in events:
            if e["seq"] <= after:
                continue
            if category is not None and e["category"] != category:
                continue
            out.append(e)
            if len(out) >= limit:
                break
        cursor = out[-1]["seq"] if out else max(after, newest)
        return {
            "enabled": True,
            "host": self.host,
            "events": out,
            "cursor": cursor,
            "newest": newest,
            # The ring dropped events this cursor never saw: the reader
            # asked for history older than the oldest held event.
            "truncated": bool(after + 1 < oldest and after < newest),
        }

    def tail(self, limit: int = 256,
             category: Optional[str] = None) -> Dict:
        """The NEWEST ``limit`` events (still oldest-first in the
        returned list) — the fleet-merge fetch shape, where per-host
        cursors don't compose."""
        limit = max(1, min(int(limit), self.capacity))
        with self._lock:
            events = list(self._events)
            newest = self._seq
        if category is not None:
            events = [e for e in events if e["category"] == category]
        out = events[-limit:]
        return {"enabled": True, "host": self.host, "events": out,
                "cursor": out[-1]["seq"] if out else newest,
                "newest": newest, "truncated": False}

    def status(self) -> dict:
        with self._lock:
            out = {"capacity": self.capacity,
                   "held": len(self._events), "seq": self._seq}
            if self._spill_dir:
                out["spill"] = {
                    "dir": self._spill_dir,
                    "segments": len(self._segments()),
                    "replayed": self._replayed,
                    "errors": self._spill_errors,
                }
            return out


#: Process-wide journal; None = journaling off. Library emit sites pay
#: one None check when off — the same seam as tracing.RECORDER,
#: audit.AUDITOR, and chaos.INJECTOR. The server binary enables it by
#: default (events are rare; reconstructing an unpredicted incident is
#: the feature).
JOURNAL: Optional[EventJournal] = None


def enable(capacity: int = 4096, *, host: str = "",
           registry=None, spill_dir: Optional[str] = None,
           spill_segment_bytes: int = 1 << 20,
           spill_segments: int = 8) -> EventJournal:
    """Install (and return) the process-wide journal, replacing any
    previous one. With ``spill_dir`` the journal keeps an append-only
    on-disk mirror (bounded rotating segments) and replays its tail
    into the ring on startup — a restart no longer loses the events
    that explain WHY it restarted."""
    global JOURNAL
    JOURNAL = EventJournal(capacity, host=host, registry=registry,
                           spill_dir=spill_dir,
                           spill_segment_bytes=spill_segment_bytes,
                           spill_segments=spill_segments)
    return JOURNAL


def disable() -> None:
    global JOURNAL
    if JOURNAL is not None:
        JOURNAL.close()
    JOURNAL = None


def get() -> Optional[EventJournal]:
    return JOURNAL


def emit(category: str, action: str, **kw) -> None:
    """Guarded record: one None check when journaling is off."""
    j = JOURNAL
    if j is not None:
        j.record(category, action, **kw)
