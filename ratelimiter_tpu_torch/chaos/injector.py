"""The chaos injector: seeded, deterministic fault scenarios.

See the package docstring for the design rules. The injector exposes
three hook families, called from the production seams:

* ``slice_launch(idx)`` / ``slice_resolve(idx)`` — per-slice faults
  (parallel/quarantine.py SliceGuard). ``fail`` raises
  :class:`SliceFault` (classified as a backend fault by the quarantine
  failure classifier), ``delay`` sleeps, ``wedge`` blocks until the
  scenario is cleared — which is what lets the guard's per-slice
  deadline fire deterministically in tests.
* ``dcn_frame(frame)`` — DCN partition/corruption
  (serving/dcn_peer.py): returns the frame, a corrupted copy, or None
  (dropped).
* ``snapshot_capture()`` — stalls the snapshotter's capture loop
  (persistence/snapshotter.py).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional


class SliceFault(RuntimeError):
    """Injected slice fault — classified as a backend failure by the
    quarantine failure classifier (a stand-in for a device error)."""


class ChaosInjector:
    """Deterministic fault injector. Thread-safe: hooks are called from
    dispatcher/completer/executor threads concurrently.

    Per-slice fault modes (at most one per slice):

    * ``fail``  — every dispatch touching the slice raises SliceFault
      (optionally only the next ``count`` dispatches);
    * ``delay`` — every resolve sleeps ``seconds`` (a slow slice);
    * ``wedge`` — every resolve blocks until :meth:`clear_slice`
      (a wedged device; the guard's deadline is what unwedges callers).
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        #: slice idx -> ("fail", remaining|None) | ("delay", seconds)
        #:              | ("wedge", threading.Event)
        self._slice: dict = {}
        self._dcn_drop_p = 0.0
        self._dcn_corrupt_p = 0.0
        self._snapshot_stall_s = 0.0
        #: Elastic-lifecycle faults (ADR-018): stall/abort the fleet
        #: handoff path at a named phase (capture -> restore -> flip).
        self._handoff_stall: dict = {}      # phase -> seconds
        self._handoff_abort: dict = {}      # phase -> remaining | None
        # Observability for assertions: what actually fired.
        self.slice_faults = 0
        self.dcn_dropped = 0
        self.dcn_corrupted = 0
        self.snapshot_stalls = 0
        self.handoff_stalls = 0
        self.handoff_aborts = 0

    # ------------------------------------------------------- scenarios

    def fail_slice(self, idx: int, *, count: Optional[int] = None) -> None:
        """Dispatches touching slice ``idx`` raise SliceFault (the next
        ``count`` of them, or until cleared)."""
        with self._lock:
            self._slice[int(idx)] = ("fail", count)

    def delay_slice(self, idx: int, seconds: float) -> None:
        """Resolves on slice ``idx`` sleep ``seconds`` (slow slice)."""
        with self._lock:
            self._slice[int(idx)] = ("delay", float(seconds))

    def wedge_slice(self, idx: int) -> None:
        """Resolves on slice ``idx`` block until :meth:`clear_slice`."""
        with self._lock:
            self._slice[int(idx)] = ("wedge", threading.Event())

    def clear_slice(self, idx: int) -> None:
        with self._lock:
            mode = self._slice.pop(int(idx), None)
        if mode is not None and mode[0] == "wedge":
            mode[1].set()  # release every blocked resolve

    def partition_dcn(self, drop_p: float = 1.0) -> None:
        """Drop DCN push frames with probability ``drop_p`` (1.0 = full
        partition)."""
        with self._lock:
            self._dcn_drop_p = float(drop_p)

    def corrupt_dcn(self, p: float = 1.0) -> None:
        """Flip a byte in DCN push frames with probability ``p``."""
        with self._lock:
            self._dcn_corrupt_p = float(p)

    def stall_snapshot(self, seconds: float) -> None:
        """Every snapshot capture sleeps ``seconds`` first."""
        with self._lock:
            self._snapshot_stall_s = float(seconds)

    def stall_handoff(self, seconds: float, phase: str = "restore") -> None:
        """Fleet handoff (migration/rejoin/departure) sleeps ``seconds``
        at ``phase`` — the migration-stall scenario: the OLD owner keeps
        serving at the old epoch for the whole stall (single owner per
        epoch, just a longer window)."""
        with self._lock:
            self._handoff_stall[str(phase)] = float(seconds)

    def abort_handoff(self, phase: str = "flip",
                      count: Optional[int] = None) -> None:
        """Fleet handoff raises at ``phase`` (the next ``count`` times,
        or until cleared) — the in-process form of kill -9 mid-handoff:
        the transition dies BEFORE the epoch bump is published, so the
        old owner must remain the only owner."""
        with self._lock:
            self._handoff_abort[str(phase)] = count

    def clear(self) -> None:
        """Clear every scenario (wedged resolves are released)."""
        with self._lock:
            modes = list(self._slice.values())
            self._slice.clear()
            self._dcn_drop_p = 0.0
            self._dcn_corrupt_p = 0.0
            self._snapshot_stall_s = 0.0
            self._handoff_stall.clear()
            self._handoff_abort.clear()
        for mode in modes:
            if mode[0] == "wedge":
                mode[1].set()

    # ------------------------------------------------------------ hooks

    def _slice_mode(self, idx: int):
        with self._lock:
            return self._slice.get(int(idx))

    def slice_launch(self, idx: int) -> None:
        """Hook at slice dispatch entry (SliceGuard launch/decide):
        ``fail`` fires here so a failed slice never enqueues device
        work — the same surface as a launch-time device error."""
        mode = self._slice_mode(idx)
        if mode is None:
            return
        if mode[0] == "fail":
            with self._lock:
                cur = self._slice.get(int(idx))
                if cur is not None and cur[0] == "fail":
                    if cur[1] is not None:
                        if cur[1] <= 1:
                            self._slice.pop(int(idx), None)
                        else:
                            self._slice[int(idx)] = ("fail", cur[1] - 1)
                    self.slice_faults += 1
                else:
                    return
            raise SliceFault(f"injected fault on slice {idx}")

    def slice_resolve(self, idx: int) -> None:
        """Hook inside the deadline-bounded resolve (SliceGuard executor
        thread): ``delay`` sleeps, ``wedge`` blocks until cleared."""
        mode = self._slice_mode(idx)
        if mode is None:
            return
        if mode[0] == "delay":
            time.sleep(mode[1])
        elif mode[0] == "wedge":
            mode[1].wait()
        elif mode[0] == "fail":
            # A dispatch launched before fail_slice() was armed still
            # faults at resolve — a device dying mid-flight.
            self.slice_launch(idx)

    def dcn_frame(self, frame: bytes) -> Optional[bytes]:
        """Hook on the DCN push send path: None = dropped (partition),
        or a (possibly corrupted) frame to send."""
        with self._lock:
            drop_p, corrupt_p = self._dcn_drop_p, self._dcn_corrupt_p
            if drop_p > 0.0 and self._rng.random() < drop_p:
                self.dcn_dropped += 1
                return None
            if corrupt_p > 0.0 and self._rng.random() < corrupt_p:
                self.dcn_corrupted += 1
                buf = bytearray(frame)
                # Flip one bit inside the BODY (past the 13-byte header)
                # so the frame parses but its HMAC/payload is garbage.
                if len(buf) > 13:
                    at = 13 + self._rng.randrange(len(buf) - 13)
                    buf[at] ^= 0x01
                return bytes(buf)
        return frame

    def handoff_phase(self, phase: str) -> None:
        """Hook inside the fleet handoff path (fleet/membership.py), at
        the named phase: ``capture`` (source, before the handoff
        snapshot), ``restore`` (receiver, before the standby restore),
        ``flip`` (receiver, before the epoch bump is published)."""
        with self._lock:
            stall = self._handoff_stall.get(phase, 0.0)
            abort = phase in self._handoff_abort
            if abort:
                cur = self._handoff_abort[phase]
                if cur is not None:
                    if cur <= 1:
                        self._handoff_abort.pop(phase, None)
                    else:
                        self._handoff_abort[phase] = cur - 1
                self.handoff_aborts += 1
            elif stall > 0.0:
                self.handoff_stalls += 1
        if abort:
            raise SliceFault(f"injected handoff abort at {phase!r}")
        if stall > 0.0:
            time.sleep(stall)

    def snapshot_capture(self) -> None:
        """Hook at snapshot capture entry (snapshotter thread)."""
        with self._lock:
            stall = self._snapshot_stall_s
            if stall > 0.0:
                self.snapshot_stalls += 1
        if stall > 0.0:
            time.sleep(stall)


# --------------------------------------------------------- installation


def install(injector: Optional[ChaosInjector] = None,
            seed: int = 0) -> ChaosInjector:
    """Install (and return) the process-wide injector. Idempotent-ish:
    installing replaces any previous injector (its wedges are NOT
    auto-released — call :meth:`ChaosInjector.clear` first)."""
    import ratelimiter_tpu_torch.chaos as pkg

    inj = injector if injector is not None else ChaosInjector(seed)
    pkg.INJECTOR = inj
    return inj


def uninstall() -> None:
    """Remove the injector (releasing wedges) — chaos off, hot path
    byte-identical again."""
    import ratelimiter_tpu_torch.chaos as pkg

    if pkg.INJECTOR is not None:
        pkg.INJECTOR.clear()
    pkg.INJECTOR = None


def scenario(name: str, injector: ChaosInjector, *, slice_idx: int = 0,
             seconds: float = 0.05) -> None:
    """Arm one named scenario — the vocabulary ``loadgen --chaos`` and
    ``bench.py --chaos`` share with the chaos suite:

    * ``kill-slice``     — slice faults every dispatch (dead device);
    * ``slow-slice``     — slice resolves sleep ``seconds``;
    * ``wedge-slice``    — slice resolves block until cleared;
    * ``dcn-partition``  — every DCN push frame dropped;
    * ``dcn-corrupt``    — every DCN push frame bit-flipped;
    * ``snapshot-stall`` — snapshot captures sleep ``seconds``;
    * ``migration-stall``     — fleet handoffs stall ``seconds`` at the
      receiver's restore phase (the old owner keeps serving, ADR-018);
    * ``kill-during-handoff`` — fleet handoffs die at the flip phase,
      BEFORE the epoch bump publishes (exactly one owner must remain);
    * ``rejoin-storm``        — announce frames drop with p=0.6: peers
      flap dead/alive, driving repeated failover + rejoin give-backs
      (seeded, so a storm replays exactly).
    """
    if name == "kill-slice":
        injector.fail_slice(slice_idx)
    elif name == "slow-slice":
        injector.delay_slice(slice_idx, seconds)
    elif name == "wedge-slice":
        injector.wedge_slice(slice_idx)
    elif name == "dcn-partition":
        injector.partition_dcn(1.0)
    elif name == "dcn-corrupt":
        injector.corrupt_dcn(1.0)
    elif name == "snapshot-stall":
        injector.stall_snapshot(seconds)
    elif name == "migration-stall":
        injector.stall_handoff(seconds, phase="restore")
    elif name == "kill-during-handoff":
        injector.abort_handoff(phase="flip")
    elif name == "rejoin-storm":
        injector.partition_dcn(0.6)
    else:
        raise ValueError(
            f"unknown chaos scenario {name!r} (known: kill-slice, "
            f"slow-slice, wedge-slice, dcn-partition, dcn-corrupt, "
            f"snapshot-stall, migration-stall, kill-during-handoff, "
            f"rejoin-storm)")
