"""Live accuracy observatory: shadow-oracle auditing of serving traffic —
a copy of ``ratelimiter_tpu/observability/audit.py`` over the port's
``evaluation/compare.ShadowComparator``: the same sampling rule, slice
attribution, fail-open exclusion, bounded tap queue, status and gauges.
Its collision-free twin is the port's sketch limiter on ``device`` (the
serving limiter's device: the card unless the caller asks for the CPU),
so its steps launch the same kernels as the serving steps, from the
audit worker thread; the exact oracle is host code.

The sketch backend is approximate BY DESIGN, and until now its quality bar
(<= 1% false-positive denies vs the exact sliding-window oracle —
BASELINE.json, ``evaluation/accuracy.py``) was measured only OFFLINE, in
bench phase B. This module closes the loop in production (ADR-016): both
front doors mirror a deterministic hash-sampled fraction of live decisions
into an exact shadow oracle (plus a collision-free CMS twin) running off
the hot path, so an operator can read the LIVE false-deny / false-allow
rate — with sample counts and Wilson confidence bounds — from /metrics,
/healthz, and ``GET /debug/audit``.

Design rules (ADR-016):

* **Hash-coherent sampling.** A key is ALWAYS or NEVER audited:
  ``splitmix64(h64) % sample == 0`` over the key's finalized routing hash.
  Per-request sampling would feed the shadow oracle fragments of each
  key's timeline and misjudge every window boundary; per-key sampling
  keeps sampled keys' windows coherent, and because both shadow legs are
  per-key exact, the sampled estimate is unbiased for the population rate
  (a cluster sample by key — the Wilson bound treats requests as
  independent, a documented approximation). The sampling hash is a
  DIFFERENT mix of the routing hash, so the audited subset stays uniform
  across mesh slices (sampling on ``h64 % sample`` would alias against
  the ``h64 % n_slices`` slice router).
* **Off the hot path.** The doors' tap is one module-global None check
  (same seam as ``tracing.RECORDER`` and the chaos injector — audit off
  is byte-identical, pinned by tests/test_torch_audit.py) plus, when on, a
  bounded-queue append of references the door already holds. The queue
  DROPS AND COUNTS when full — auditing never applies backpressure to
  serving. All hashing, sampling, and shadow dispatches happen on the
  audit worker thread.
* **Degraded ranges are attributed, not averaged away.** Fail-open
  results (quarantined slices, breaker short-circuits, SLO breaches)
  are counted per slice as ``fail_open_samples`` and EXCLUDED from the
  accuracy rates — a fail-open allowance is not a sketch decision, and
  folding it in would let an outage launder the accuracy number.
* **One comparison engine.** The three-way core (sketch vs
  collision-free twin vs exact oracle) is ``evaluation/compare.py`` —
  the same code the offline bench runs, so the live estimate and the
  phase-B ground truth are the same measurement at two vantage points
  (``bench.py --audit`` checks they agree within the live estimate's
  confidence interval).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from ratelimiter_tpu_torch.core.config import Config
from ratelimiter_tpu_torch.evaluation.compare import ShadowComparator, ThreeWayTally

log = logging.getLogger("ratelimiter_tpu_torch.audit")


class ShadowAuditor:
    """Shadow-oracle auditor over a bounded tap queue.

    Args:
        config: the serving limiter's Config (limit/window/algorithm/
            sketch geometry feed the shadow legs; ``config.prefix`` is
            applied when hashing string-lane keys, matching the
            limiter's own hashing).
        sample: audit 1/``sample`` of the keyspace (hash-coherent;
            1 = audit everything, for tests and small deployments).
        n_slices: mesh slice count for per-slice attribution
            (``h64 % n_slices`` — the SlicedMeshLimiter router). 1 for
            single-device backends.
        queue_depth: max tap entries (frames, not decisions) queued for
            the worker; beyond it the tap drops and counts.
        include_twin: also run the collision-free twin (separates CMS
            error from semantic error, at ~2x shadow device work).
        twin_width: twin CMS width. The default sizes for the SAMPLED
            population: collisions among audited keys only, so it can
            stay ~64x smaller than the offline twin.
        oracle_capacity: dense oracle slots — bounds concurrently-active
            audited keys (idle slots recycle after 2 windows); overflow
            surfaces as ``oracle_errors``, never as serving failure.
        registry: attach the audit gauges to this metrics registry.
        start: spawn the worker thread (tests pass False to drive
            ``process_pending`` synchronously).
        live_config: optional zero-arg callable returning the audited
            limiter's CURRENT Config. The worker polls it per processed
            entry and re-baselines the shadow legs when limit/window
            moved (``ShadowComparator.update_policy``) — without this a
            runtime ``update_limit`` would poison the rates forever.
            Entries queued across the flip may be scored under the
            other policy (bounded by queue depth; one-window
            convergence, same class as the ADR-016 blind spots).
        device: where the twin's state lives and its steps run (the
            serving limiter's device).
    """

    def __init__(self, config: Config, *, sample: int = 64,
                 n_slices: int = 1, queue_depth: int = 512,
                 include_twin: bool = True,
                 twin_width: Optional[int] = None,
                 oracle_capacity: int = 1 << 16,
                 registry=None, start: bool = True,
                 live_config=None, device="cuda"):
        if sample < 1:
            raise ValueError(f"sample must be >= 1, got {sample}")
        self.config = config
        self.sample = int(sample)
        #: Power-of-two sample rates select on the hash's TOP bits
        #: (h64 >> shift == 0): two vector ops per frame instead of a
        #: full splitmix64 remix, still hash-coherent and independent of
        #: the low-bit slice router (h64 % n_slices). Other rates keep
        #: the remix (ADR-016 §2).
        self._sample_shift = (64 - (self.sample.bit_length() - 1)
                              if self.sample > 1
                              and self.sample & (self.sample - 1) == 0
                              else None)
        self.n_slices = max(1, int(n_slices))
        self.queue_depth = int(queue_depth)
        self._prefix = config.prefix
        if twin_width is None:
            # Collision-free over the audited subset: the sampled key
            # population is ~1/sample of the full keyspace, so the
            # offline twin's 64x-width rule shrinks by the sample rate
            # (floored so tiny geometries still get headroom).
            twin_width = max(1 << 14,
                             (config.sketch.width * 64) // self.sample)
            # Power of two (sketch geometry validation requires it).
            w = 1 << 14
            while w < twin_width:
                w <<= 1
            twin_width = w
        self._comparator = ShadowComparator(
            config, include_twin=include_twin, twin_width=twin_width,
            oracle_capacity=oracle_capacity, device=device)
        self.twin_width = twin_width
        self._live_config = live_config
        self._cur_limit = int(config.limit)
        self._cur_window = float(config.window)

        #: Tap queue: entries are (kind, data, ns, now, allowed,
        #: fail_open, fail_open_slices, slice_idx) appended by serving
        #: threads (GIL-atomic deque.append) and drained by the worker.
        self._q: deque = deque()
        self.dropped_frames = 0
        self.dropped_decisions = 0
        self.oracle_errors = 0
        #: Guards the tally + per-slice counters (written by the worker,
        #: read by status()/gauges from scrape threads). The shadow
        #: dispatches themselves run OUTSIDE this lock.
        self._status_lock = threading.Lock()
        self._per_slice: Dict[int, dict] = {}
        self.fail_open_samples = 0
        self.audited_frames = 0

        self._registries: list = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        if registry is not None:
            self.attach_registry(registry)
        if start:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="rl-audit")
            self._thread.start()

    # ------------------------------------------------------------- tap
    #
    # Called from serving threads with AUDITOR already known non-None.
    # Hot-path cost: a len() check and a deque append of references the
    # door already holds (BatchResult arrays are fresh device fetches,
    # never mutated after resolve). NO hashing, sampling, or copying
    # here — all of that is worker-side.

    def _offer(self, kind: str, data, ns, now: float, result,
               slice_idx: int) -> None:
        if len(self._q) >= self.queue_depth:
            self.dropped_frames += 1
            try:
                self.dropped_decisions += len(result)
            except TypeError:
                self.dropped_decisions += 1
            return
        self._q.append((kind, data, ns, now, result.allowed,
                        bool(result.fail_open),
                        getattr(result, "fail_open_slices", None),
                        slice_idx))
        self._wake.set()

    def offer_hashed(self, h64, ns, now: float, result, *,
                     slice_idx: int = -1) -> None:
        """Finalized u64 hashes (the doors' string fast path and the
        C++-finalized hashed lane)."""
        self._offer("hashed", h64, ns, now, result, slice_idx)

    def offer_ids(self, ids, ns, now: float, result, *,
                  slice_idx: int = -1) -> None:
        """Raw u64 ids (the asyncio ALLOW_HASHED lane — the worker
        applies the same splitmix64 finalizer the device step does)."""
        self._offer("ids", ids, ns, now, result, slice_idx)

    def offer_keys(self, keys, ns, now: float, result, *,
                   slice_idx: int = -1) -> None:
        """String keys (slow paths); hashed worker-side with the
        limiter's prefix rule."""
        self._offer("keys", keys, ns, now, result, slice_idx)

    # ---------------------------------------------------------- worker

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.25)
            self._wake.clear()
            self.process_pending()

    def process_pending(self) -> int:
        """Drain and process everything queued; returns entries handled.
        Runs on the worker thread (or synchronously in tests)."""
        n = 0
        while True:
            # _busy goes up BEFORE the pop: flush() checks "queue empty
            # AND not busy", and raising the flag first closes the
            # window where the last entry has been popped (queue empty)
            # but not yet processed.
            self._busy = True
            try:
                try:
                    entry = self._q.popleft()
                except IndexError:
                    return n
                if self._live_config is not None:
                    self._follow_live_config()
                try:
                    self._process(entry)
                except Exception:  # noqa: BLE001 — auditing must never
                    # take serving down; a poisoned entry is dropped
                    # and counted like an oracle failure.
                    self.oracle_errors += 1
                    log.exception("audit entry dropped")
                n += 1
            finally:
                self._busy = False

    def _follow_live_config(self) -> None:
        """Re-baseline the shadow legs after a runtime update_limit/
        update_window on the audited backend (worker thread only)."""
        try:
            cfg = self._live_config()
            limit, window = int(cfg.limit), float(cfg.window)
        except Exception:  # noqa: BLE001 — a mid-close backend must
            # not kill the worker; the next entry retries.
            return
        if limit != self._cur_limit or window != self._cur_window:
            self._cur_limit, self._cur_window = limit, window
            self._comparator.update_policy(limit, window)

    def _finalize(self, kind: str, data) -> np.ndarray:
        from ratelimiter_tpu_torch.ops.hashing import hash_prefixed_u64, splitmix64

        if kind == "hashed":
            return np.asarray(data, dtype=np.uint64)
        if kind == "ids":
            # The raw-id wire lane finalizes in-step (ADR-011); mirror it.
            return splitmix64(np.asarray(data, dtype=np.uint64))
        # The limiter's own prefix+hash rule (shared definition — see
        # hash_prefixed_u64), so sampled keys always match their
        # serving timeline.
        return hash_prefixed_u64(list(data), self._prefix)

    def _process(self, entry) -> None:
        from ratelimiter_tpu_torch.ops.hashing import splitmix64

        kind, data, ns, now, allowed, fail_open, fo_slices, slice_idx = entry
        h64 = self._finalize(kind, data)
        if h64.size == 0:
            return
        if self.sample > 1:
            # Select BEFORE normalizing anything else: at 1/64 most
            # frames contribute a handful of rows (or none), and this
            # early-out is most of the worker's per-frame budget.
            if self._sample_shift is not None:
                sel = np.flatnonzero(
                    (h64 >> np.uint64(self._sample_shift)) == 0)
            else:
                sel = np.flatnonzero(
                    (splitmix64(h64) % np.uint64(self.sample)) == 0)
            if sel.size == 0:
                return
            h64 = h64[sel]
            allowed = np.atleast_1d(np.asarray(allowed, dtype=bool))[sel]
            ns_arr = (np.ones(h64.shape[0], dtype=np.int64) if ns is None
                      else np.atleast_1d(
                          np.asarray(ns, dtype=np.int64))[sel])
        else:
            allowed = np.atleast_1d(np.asarray(allowed, dtype=bool))
            ns_arr = (np.ones(h64.shape[0], dtype=np.int64) if ns is None
                      else np.atleast_1d(np.asarray(ns, dtype=np.int64)))
        slices = (np.full(h64.shape[0], int(slice_idx), dtype=np.int64)
                  if slice_idx >= 0
                  else (h64 % np.uint64(self.n_slices)).astype(np.int64))

        # Degraded-range attribution (ADR-016 §4): fail-open rows are
        # not sketch decisions — count them per slice and keep them OUT
        # of the accuracy comparison. With per-slice attribution
        # (fail_open_slices) only the named ranges are excluded; an
        # unattributed fail-open excludes the whole frame.
        fo_mask = None
        if fail_open:
            if fo_slices:
                fo_mask = np.isin(slices, np.asarray(list(fo_slices),
                                                     dtype=np.int64))
            else:
                fo_mask = np.ones(h64.shape[0], dtype=bool)
        if fo_mask is not None and fo_mask.any():
            with self._status_lock:
                self.fail_open_samples += int(fo_mask.sum())
                for s in np.unique(slices[fo_mask]):
                    d = self._slice_entry(int(s))
                    d["fail_open_samples"] += int(
                        (slices[fo_mask] == s).sum())
            keep = ~fo_mask
            if not keep.any():
                with self._status_lock:
                    self.audited_frames += 1
                return
            h64, ns_arr, allowed, slices = (h64[keep], ns_arr[keep],
                                            allowed[keep], slices[keep])

        try:
            oracle, twin = self._comparator.decide(h64, ns_arr, now)
        except Exception:  # noqa: BLE001 — shadow capacity/dispatch
            # failure: count, drop the batch, keep serving-side numbers
            # honest (the status block reports oracle_errors).
            self.oracle_errors += 1
            log.warning("audit shadow dispatch failed", exc_info=True)
            return
        fd_rows = oracle & ~allowed
        fa_rows = ~oracle & allowed
        with self._status_lock:
            self.audited_frames += 1
            self._comparator.tally.add(allowed, twin, oracle)
            for s in np.unique(slices):
                m = slices == s
                d = self._slice_entry(int(s))
                d["samples"] += int(m.sum())
                d["oracle_allows"] += int(oracle[m].sum())
                d["false_denies"] += int(fd_rows[m].sum())
                d["false_allows"] += int(fa_rows[m].sum())

    def _slice_entry(self, s: int) -> dict:
        d = self._per_slice.get(s)
        if d is None:
            d = {"samples": 0, "oracle_allows": 0, "false_denies": 0,
                 "false_allows": 0, "fail_open_samples": 0}
            self._per_slice[s] = d
        return d

    # ---------------------------------------------------------- status

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until every offered entry is processed (tests, bench,
        graceful shutdown). True if drained within the timeout."""
        import time

        deadline = time.monotonic() + timeout
        self._wake.set()
        while time.monotonic() < deadline:
            if not self._q and not self._busy:
                return True
            if self._thread is None:
                self.process_pending()
            else:
                self._wake.set()
                time.sleep(0.002)
        return not self._q and not self._busy

    def status(self) -> dict:
        """The /debug/audit JSON core: rates, Wilson bounds, sample
        counts, per-slice attribution, drop counters."""
        with self._status_lock:
            t = self._comparator.tally
            # Consistent snapshot under the lock; rates derive after.
            tally = ThreeWayTally(
                requests=t.requests, oracle_allows=t.oracle_allows,
                oracle_denies=t.oracle_denies, twin_allows=t.twin_allows,
                false_denies_vs_oracle=t.false_denies_vs_oracle,
                false_allows_vs_oracle=t.false_allows_vs_oracle,
                cms_false_denies_vs_twin=t.cms_false_denies_vs_twin,
                semantic_disagreements=t.semantic_disagreements)
            per_slice = {s: dict(d) for s, d in self._per_slice.items()}
            fail_open_samples = self.fail_open_samples
            frames = self.audited_frames
        fd_lo, fd_hi = tally.false_deny_wilson()
        fa_lo, fa_hi = tally.false_allow_wilson()
        return {
            "enabled": True,
            "sample": self.sample,
            "samples": tally.requests,
            "audited_frames": frames,
            "false_deny_rate": round(tally.false_deny_rate, 8),
            "false_deny_wilson95": [round(fd_lo, 8), round(fd_hi, 8)],
            "false_denies": tally.false_denies_vs_oracle,
            "oracle_allows": tally.oracle_allows,
            "false_allow_rate": round(tally.false_allow_rate, 10),
            "false_allow_wilson95": [round(fa_lo, 10), round(fa_hi, 10)],
            "false_allows": tally.false_allows_vs_oracle,
            "cms_false_deny_rate": round(tally.cms_false_deny_rate, 8),
            "semantic_disagreements": tally.semantic_disagreements,
            "twin": self._comparator.include_twin,
            "fail_open_samples": fail_open_samples,
            "dropped_frames": self.dropped_frames,
            # Drops happen at the tap, BEFORE worker-side sampling, so
            # dropped_decisions counts whole frame lengths; the
            # _audited_estimate divides by the sample rate into the
            # same units as ``samples`` (what the audit stream actually
            # lost).
            "dropped_decisions": self.dropped_decisions,
            "dropped_audited_estimate": self.dropped_decisions
            // self.sample,
            "oracle_errors": self.oracle_errors,
            "per_slice": {str(s): per_slice[s]
                          for s in sorted(per_slice)},
        }

    # ---------------------------------------------------- metrics hook

    def attach_registry(self, registry) -> None:
        """Scrape-time gauges (the debt-slab collect-hook pattern,
        ADR-013 — never the decide path)."""
        g_fd = registry.gauge(
            "rate_limiter_audit_false_deny_rate",
            "Live false-deny rate vs the exact shadow oracle over the "
            "hash-sampled audit stream (ADR-016)")
        g_fd_lo = registry.gauge(
            "rate_limiter_audit_false_deny_wilson_low",
            "Lower 95% Wilson bound on the live false-deny rate")
        g_fd_hi = registry.gauge(
            "rate_limiter_audit_false_deny_wilson_high",
            "Upper 95% Wilson bound on the live false-deny rate")
        g_fa = registry.gauge(
            "rate_limiter_audit_false_allow_rate",
            "Live false-allow rate vs the exact shadow oracle")
        g_n = registry.gauge(
            "rate_limiter_audit_samples",
            "Audited decisions compared against the shadow oracle")
        g_drop = registry.gauge(
            "rate_limiter_audit_dropped_decisions",
            "Decisions in frames dropped at the tap because the audit "
            "queue was full (audit never backpressures serving). "
            "PRE-sampling units — divide by the sample rate to compare "
            "against rate_limiter_audit_samples")
        g_fo = registry.gauge(
            "rate_limiter_audit_fail_open_samples",
            "Sampled decisions excluded from the accuracy rates because "
            "they were fail-open (degraded ranges are attributed, not "
            "averaged away)")
        g_sl_fd = registry.gauge(
            "rate_limiter_audit_slice_false_denies",
            "False denies attributed to one mesh slice's key range")
        g_sl_n = registry.gauge(
            "rate_limiter_audit_slice_samples",
            "Audited decisions attributed to one mesh slice's key range")

        def collect() -> None:
            st = self.status()
            g_fd.set(st["false_deny_rate"])
            g_fd_lo.set(st["false_deny_wilson95"][0])
            g_fd_hi.set(st["false_deny_wilson95"][1])
            g_fa.set(st["false_allow_rate"])
            g_n.set(float(st["samples"]))
            g_drop.set(float(st["dropped_decisions"]))
            g_fo.set(float(st["fail_open_samples"]))
            for s, d in st["per_slice"].items():
                g_sl_fd.set(float(d["false_denies"]), slice=s)
                g_sl_n.set(float(d["samples"]), slice=s)

        registry.add_collect_hook(collect)
        self._registries.append((registry, collect))

    # -------------------------------------------------------- lifecycle

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for registry, collect in self._registries:
            registry.remove_collect_hook(collect)
        self._registries.clear()
        self._comparator.close()


#: Process-wide auditor; None = auditing off (the default). The serving
#: doors read this module global once per resolved batch and skip
#: everything when it is None — that None check IS the audit-off
#: overhead budget (byte-identical decisions, pinned by
#: tests/test_torch_audit.py; the same seam as tracing.RECORDER and
#: chaos.INJECTOR).
AUDITOR: Optional[ShadowAuditor] = None


def enable(config: Config, **kw) -> ShadowAuditor:
    """Install (and return) the process-wide auditor. Replaces any
    previous one (which is closed)."""
    global AUDITOR
    if AUDITOR is not None:
        AUDITOR.close()
    AUDITOR = ShadowAuditor(config, **kw)
    return AUDITOR


def disable() -> None:
    """Audit off — hot path byte-identical again."""
    global AUDITOR
    if AUDITOR is not None:
        AUDITOR.close()
    AUDITOR = None


def get() -> Optional[ShadowAuditor]:
    return AUDITOR
