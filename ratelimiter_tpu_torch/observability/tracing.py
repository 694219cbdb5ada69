"""Flight-recorder tracing: per-stage spans across the whole serving path.

A copy of ``ratelimiter_tpu/observability/tracing.py``, its code
verbatim (tests/test_torch_tracing.py holds it to the JAX package's).

The reference plans an OpenTelemetry ``TracingDecorator``
(``docs/ADR/003-decorator-pattern-for-observability.md:115-124``); the
existing ``TracingDecorator`` realizes the device half of that with
``jax.profiler`` annotations, but nothing could attribute ONE frame's
latency to the pipeline stages it crossed (io → route → coalesce →
launch → device → resolve → encode, spanning C++ threads, asyncio
executors, and mesh slices — the MULTICHIP_r07 p99 investigation was
done by ad-hoc printf). This module is the missing half: a
flight-recorder of binary span records cheap enough to leave stamped on
the serving hot path.

Design (ADR-014):

* **Per-thread fixed-size ring buffers** of fixed-width records
  (trace_id, stage, shard, batch, t_start/t_end monotonic ns, outcome)
  in a numpy structured array — one row assignment per span, never a
  lock, never an allocation, never I/O on the record path. Rings are
  registered once per thread (the only locked operation) and drained
  only at dump/scrape time.
* **Off by default, zero overhead when off**: hot paths read the module
  global ``RECORDER`` once and skip everything — no clock reads, no
  branches beyond the None check, byte-identical decisions either way
  (tests/test_tracing.py pins this).
* **Trace context** is a caller-supplied u64 id (0 = unsampled). The
  binary protocol carries it as a flagged extension on any request frame
  (``protocol.with_trace``), HTTP carries W3C ``traceparent``, gRPC the
  same header as metadata, and DCN pushes ride the same frame flag
  outside the HMAC envelope, so one id survives client → server → DCN.
* **Dumps are Perfetto-loadable**: ``chrome_trace()`` renders the Chrome
  trace-event JSON Perfetto/chrome://tracing open directly; spans of one
  frame share its trace id in ``args`` and nest by containment
  (frame ⊃ slice ⊃ device), which is the span-tree oracle the tests
  walk.
* **Histograms ride the scrape**: ``attach_registry`` installs a
  collect hook deriving ``rate_limiter_stage_seconds{stage=...}`` from
  the rings at scrape time (the same seam as the debt-slab gauges) with
  OpenMetrics exemplars tying buckets to the trace ids that landed in
  them.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

#: Stage vocabulary (u8 codes in the record). Both doors + the mesh
#: composite use these names; unknown names are rejected loudly so
#: dumps stay joinable across versions.
STAGES = (
    "io",         # wire frame parse + enqueue (reader loop / C++ io thread)
    "route",      # shard/slice partition of a frame
    "queue",      # waiting in the pending queue for the next dispatch
    "coalesce",   # coalescing-window residency (first pending -> flush)
    "launch",     # stage + enqueue the jitted step (non-blocking)
    "dispatch",   # native door: drain -> launch callback returned
    "device",     # block on the device for the oldest in-flight dispatch
    "barrier",    # mesh frame: the single completion barrier (ADR-013)
    "slice",      # mesh frame: one slice's sub-dispatch resolve
    "resolve",    # host bookkeeping after the device fetch
    "complete",   # native door: completer post-processing
    "encode",     # response framing
    "respond",    # native door: responder encode+send (aggregate only)
    "http",       # HTTP gateway decision (traceparent attribution)
    "grpc",       # gRPC decision (traceparent metadata attribution)
    "dcn",        # one DCN push round-trip to a peer
    "client",     # client-side request span (loadgen sampling)
    "forward",    # fleet forward lane: one coalesced wire window's
                  # round trip to a peer (send -> parsed reply), recorded
                  # under the WINDOW-level trace id (ADR-021)
)
_STAGE_CODE: Dict[str, int] = {s: i for i, s in enumerate(STAGES)}

#: Outcome codes.
OK, ERROR, FAIL_OPEN = 0, 1, 2

#: One span record: 32 bytes, fixed width — the ring is a plain numpy
#: structured array so a record is ONE row assignment.
RECORD_DTYPE = np.dtype([
    ("trace_id", "<u8"),
    ("t_start", "<u8"),
    ("t_end", "<u8"),
    ("batch", "<u4"),
    ("shard", "<i2"),
    ("stage", "u1"),
    ("outcome", "u1"),
])


def now() -> int:
    """Monotonic nanoseconds — the span clock. Same CLOCK_MONOTONIC
    domain as the native door's ``steady_clock`` stamps, so C++ and
    Python spans interleave on one timeline."""
    return time.monotonic_ns()


def new_trace_id() -> int:
    """Fresh nonzero sampling id (64-bit; 0 means 'unsampled')."""
    import secrets

    return secrets.randbits(64) | 1


def parse_traceparent(header: Optional[str]) -> int:
    """W3C ``traceparent`` -> u64 trace id (low 8 bytes of the 16-byte
    trace-id field), 0 for absent/malformed headers. Lenient on
    version/flags — attribution must never reject a request."""
    if not header:
        return 0
    parts = header.strip().split("-")
    if len(parts) < 3 or len(parts[1]) != 32:
        return 0
    try:
        return int(parts[1][16:], 16)
    except ValueError:
        return 0


def format_traceparent(trace_id: int) -> str:
    """u64 trace id -> a valid ``traceparent`` header value."""
    return f"00-{trace_id & ((1 << 64) - 1):032x}-{trace_id & ((1 << 64) - 1) or 1:016x}-01"


class _Ring:
    """One thread's span ring. Only its owning thread writes; readers
    take racy-but-consistent numpy copies (each row is written once and
    ``idx`` is published after the row — a torn read can at worst see a
    half-written CURRENT row, which drains skip via t_end==0)."""

    __slots__ = ("buf", "idx", "tid", "name")

    def __init__(self, capacity: int):
        self.buf = np.zeros(capacity, dtype=RECORD_DTYPE)
        self.idx = 0  # total records ever written (monotone)
        self.tid = threading.get_ident()
        self.name = threading.current_thread().name


class FlightRecorder:
    """Process-wide span recorder over per-thread rings."""

    def __init__(self, capacity: int = 8192):
        if capacity < 16:
            raise ValueError(f"capacity must be >= 16, got {capacity}")
        # Round up to a power of two so the ring index is a mask.
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self._mask = cap - 1
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._rings_lock = threading.Lock()
        self._registries: list = []
        #: Parent-child trace-id links (ADR-021): a fleet forward lane
        #: re-frames member fragments under one WINDOW-level trace id
        #: and records (client frame id -> window id) here, so the
        #: cross-host stitcher can join the receiving member's
        #: window-id spans back to the client frame. Bounded; links are
        #: per-window (rare next to spans), appended under a lock.
        self._links: collections.deque = collections.deque(
            maxlen=max(1024, cap))
        self._links_lock = threading.Lock()

    # ------------------------------------------------------------ record

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.capacity)
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def record(self, stage, t_start: int, t_end: int, *, trace_id: int = 0,
               shard: int = -1, batch: int = 1, outcome: int = OK) -> None:
        """Stamp one span. Hot-path cost: a thread-local lookup and one
        structured-row assignment (no locks, no allocation)."""
        ring = self._ring()
        i = ring.idx & self._mask
        ring.buf[i] = (trace_id & 0xFFFFFFFFFFFFFFFF, t_start, t_end,
                       batch & 0xFFFFFFFF, shard,
                       stage if isinstance(stage, int)
                       else _STAGE_CODE[stage], outcome)
        ring.idx += 1

    def link(self, parent_id: int, child_id: int) -> None:
        """Record a parent->child trace-id relation (the fleet forward
        lane's fragment -> wire-window linkage, ADR-021). Not a
        hot-path call: one link per coalesced wire window."""
        if not parent_id or not child_id or parent_id == child_id:
            return
        with self._links_lock:
            self._links.append((parent_id & 0xFFFFFFFFFFFFFFFF,
                                child_id & 0xFFFFFFFFFFFFFFFF, now()))

    def links(self) -> List[dict]:
        """Recorded trace-id links as dicts (ids in the 16-hex trace-id
        rendering)."""
        with self._links_lock:
            snap = list(self._links)
        return [{"parent": f"{p:016x}", "child": f"{c:016x}",
                 "t_ns": t} for p, c, t in snap]

    # ------------------------------------------------------------- drain

    def _snapshot(self):
        """[(ring, entries-copy oldest-first, first_seq)] without
        stopping writers (copies are taken per ring)."""
        with self._rings_lock:
            rings = list(self._rings)
        out = []
        for ring in rings:
            idx = ring.idx
            n = min(idx, self.capacity)
            if n == 0:
                continue
            lo = idx & self._mask
            if idx <= self.capacity:
                ent = ring.buf[:n].copy()
            else:
                ent = np.concatenate([ring.buf[lo:], ring.buf[:lo]])
            out.append((ring, ent, idx - n))
        return out

    def dump(self) -> List[dict]:
        """Recent spans (up to capacity per thread) as dicts, sorted by
        t_start. Drain-time work only — never on the record path."""
        spans: List[dict] = []
        for ring, ent, _ in self._snapshot():
            keep = ent[ent["t_end"] != 0]
            for row in keep:
                spans.append({
                    "trace_id": int(row["trace_id"]),
                    "stage": STAGES[int(row["stage"])],
                    "shard": int(row["shard"]),
                    "batch": int(row["batch"]),
                    "t_start_ns": int(row["t_start"]),
                    "t_end_ns": int(row["t_end"]),
                    "outcome": int(row["outcome"]),
                    "thread": ring.name,
                })
        spans.sort(key=lambda s: s["t_start_ns"])
        return spans

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing load it
        directly): one complete ("X") event per span, microsecond
        timestamps, trace id / shard / batch / outcome in args."""
        pid = os.getpid()
        events = []
        for ring, ent, _ in self._snapshot():
            keep = ent[ent["t_end"] != 0]
            for row in keep:
                t0 = int(row["t_start"])
                events.append({
                    "name": STAGES[int(row["stage"])],
                    "cat": "ratelimiter",
                    "ph": "X",
                    "ts": t0 / 1e3,
                    "dur": max(int(row["t_end"]) - t0, 0) / 1e3,
                    "pid": pid,
                    "tid": ring.tid,
                    "args": {
                        "trace_id": f"{int(row['trace_id']):016x}",
                        "shard": int(row["shard"]),
                        "batch": int(row["batch"]),
                        "outcome": int(row["outcome"]),
                    },
                })
        events.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"clock": "CLOCK_MONOTONIC",
                          "threads": {str(r.tid): r.name
                                      for r in list(self._rings)},
                          # Fragment -> wire-window linkage plus a
                          # (mono, wall) clock stamp, so an offline
                          # stitcher can join and align dumps pulled
                          # from several hosts (fleet/tower.py).
                          "links": self.links(),
                          "mono_ns": now(),
                          "wall_s": time.time()},
        }

    def stage_summary(self) -> Dict[str, dict]:
        """{stage: {count, total_us, mean_us, p99_us}} over the rings —
        the bench's ``--trace`` breakdown block derives from this."""
        per: Dict[str, list] = {}
        for _, ent, _ in self._snapshot():
            keep = ent[ent["t_end"] != 0]
            for code in np.unique(keep["stage"]):
                rows = keep[keep["stage"] == code]
                per.setdefault(STAGES[int(code)], []).append(
                    (rows["t_end"] - rows["t_start"]).astype(np.int64))
        out: Dict[str, dict] = {}
        for stage, chunks in per.items():
            ns = np.concatenate(chunks)
            out[stage] = {
                "count": int(ns.size),
                "total_us": round(float(ns.sum()) / 1e3, 1),
                "mean_us": round(float(ns.mean()) / 1e3, 1),
                "p99_us": round(float(np.percentile(ns, 99)) / 1e3, 1),
            }
        return out

    # --------------------------------------------- scrape-time histograms

    def attach_registry(self, registry) -> None:
        """Derive ``rate_limiter_stage_seconds{stage=...}`` from the
        rings via the registry's scrape-time collect-hook seam (the same
        mechanism as the debt-slab gauges, ADR-013): spans recorded since
        the previous scrape are observed into the histogram — WITH an
        OpenMetrics exemplar carrying the span's trace id — once per
        scrape, never on the decide path."""
        hist = registry.histogram(
            "rate_limiter_stage_seconds",
            "Per-stage serving latency derived from the flight recorder "
            "(ADR-014); buckets carry trace-id exemplars in the "
            "OpenMetrics rendering")
        cursors: Dict[int, int] = {}

        def collect() -> None:
            for ring, ent, first_seq in self._snapshot():
                seen = cursors.get(id(ring), 0)
                start = max(seen, first_seq)
                fresh = ent[start - first_seq:]
                fresh = fresh[fresh["t_end"] != 0]
                for row in fresh:
                    dt = max(int(row["t_end"]) - int(row["t_start"]), 0) / 1e9
                    tid = int(row["trace_id"])
                    hist.observe(
                        dt,
                        exemplar=(f"{tid:016x}" if tid else None),
                        stage=STAGES[int(row["stage"])])
                cursors[id(ring)] = first_seq + len(ent)

        registry.add_collect_hook(collect)
        self._registries.append((registry, collect))

    def detach(self) -> None:
        for registry, collect in self._registries:
            registry.remove_collect_hook(collect)
        self._registries.clear()


#: Process-wide recorder; None = tracing off (the default). Hot paths
#: read this module global once per operation and skip everything when
#: it is None — that None check IS the documented overhead budget.
RECORDER: Optional[FlightRecorder] = None


def enable(capacity: int = 8192, registry=None) -> FlightRecorder:
    """Turn the flight recorder on (idempotent); optionally attach the
    scrape-time stage histograms to ``registry``."""
    global RECORDER
    if RECORDER is None:
        RECORDER = FlightRecorder(capacity)
    if registry is not None:
        RECORDER.attach_registry(registry)
    return RECORDER


def disable() -> None:
    """Turn tracing off and unhook any scrape-time collectors."""
    global RECORDER
    if RECORDER is not None:
        RECORDER.detach()
    RECORDER = None


def get() -> Optional[FlightRecorder]:
    return RECORDER


def record(stage, t_start: int, t_end: int, **kw) -> None:
    """Convenience guarded record (hot paths inline the None check and
    call ``RECORDER.record`` directly instead)."""
    rec = RECORDER
    if rec is not None:
        rec.record(stage, t_start, t_end, **kw)


# ----------------------------------------------- current-trace context
#
# A thread-local "trace id of the work currently being launched": the
# micro-batcher sets it (recorder-on only) around the limiter launch
# call, so layers WITHOUT a trace-id parameter in their signature — the
# fleet forwarder splitting a frame onto peer lanes is the one that
# matters (ADR-021) — can attribute the rows they ship. For a coalesced
# window the id is the window's representative (first sampled frame),
# the same id its coalesce/launch/device spans carry.

_CTX = threading.local()


def set_current(trace_id: int) -> None:
    _CTX.trace_id = trace_id


def current() -> int:
    """Trace id of the frame/window being launched on this thread
    (0 = none/unsampled)."""
    return getattr(_CTX, "trace_id", 0)
