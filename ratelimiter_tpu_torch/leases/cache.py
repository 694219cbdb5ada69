"""Client-side lease cache, a copy of ``ratelimiter_tpu/leases/cache.py``:
the memory-speed half.

The cache is PURE STATE — thread-safe token counters plus a work queue —
so one implementation serves both client flavors: the blocking
``Client`` drives it from a maintenance thread, ``AsyncClient`` from an
asyncio task. The decision path is ``try_acquire``: one lock, one dict
lookup, one integer decrement — nanoseconds, no wire. Everything that
talks to the server (grant, renew, return) happens in the background
driver via :meth:`actions`, never under a caller's decision.

Consumption accounting is exactly-once: ``try_acquire`` accumulates a
per-key ``consumed_since`` delta; ``actions`` moves the delta into the
renew it emits; a failed SEND re-credits it (the server never saw it),
while a REFUSED renew does not (the server already mirrored it into the
audit tap). The local counter can only ever answer from budget the
server debited upfront, so no client-side bug can over-admit globally —
the worst bug wastes tokens (false denies), the documented failure side.
"""

from __future__ import annotations

import threading
from time import monotonic
from typing import Callable, Dict, List, Optional, Tuple

from ratelimiter_tpu_torch.core.types import Result
from ratelimiter_tpu_torch.observability import metrics as m


class LeasedKey:
    """Local state for one leased key."""

    __slots__ = ("key", "lease_id", "tokens", "budget", "consumed_since",
                 "limit", "expires", "ttl", "epoch", "renew_pending")

    def __init__(self, key: str, lease_id: int, tokens: int, limit: int,
                 expires: float, ttl: float, epoch: int):
        self.key = key
        self.lease_id = lease_id
        self.tokens = int(tokens)
        self.budget = int(tokens)
        self.consumed_since = 0
        self.limit = int(limit)
        self.expires = float(expires)
        self.ttl = float(ttl)
        self.epoch = int(epoch)
        self.renew_pending = False


class LeaseCache:
    """Per-process lease table + hot-key detector.

    Args:
        client_id: this holder's identity on the wire (random when
            omitted — one per cache instance).
        hot_after: wire decisions for one key within ``hot_window``
            seconds before the cache asks for a lease on it.
        hot_window: the hotness counting window.
        want: budget to request per grant/renew (0 = server default).
        low_water: renew when local tokens fall below this fraction of
            the granted budget.
        max_tracked: hotness-counter capacity (stale entries are evicted
            on overflow — the tracker must never grow with keyspace).
    """

    def __init__(self, *, client_id: Optional[int] = None,
                 hot_after: int = 8, hot_window: float = 1.0,
                 want: int = 0, low_water: float = 0.25,
                 max_tracked: int = 4096,
                 registry: Optional[m.Registry] = None,
                 clock: Callable[[], float] = monotonic):
        if client_id is None:
            import secrets

            client_id = secrets.randbits(64)
        self.client_id = int(client_id)
        self.hot_after = int(hot_after)
        self.hot_window = float(hot_window)
        self.want = int(want)
        self.low_water = float(low_water)
        self.max_tracked = int(max_tracked)
        self.clock = clock
        self._lock = threading.Lock()
        self._leases: Dict[str, LeasedKey] = {}
        self._by_id: Dict[int, str] = {}
        self._hot: Dict[str, Tuple[int, float]] = {}
        self._grant_pending: Dict[str, float] = {}
        self.epoch = 0
        reg = registry if registry is not None else m.DEFAULT
        self._c_local = reg.counter(
            "rate_limiter_lease_local_answers_total",
            "Decisions answered from the in-process lease cache "
            "(no wire round trip; ADR-022)")
        self._c_fallback = reg.counter(
            "rate_limiter_lease_client_fallbacks_total",
            "Leased-key decisions that fell back to the wire path, "
            "by reason (exhausted / expired / oversize)")

    # ---------------------------------------------------- decision path

    def try_acquire(self, key: str, n: int = 1) -> Optional[Result]:
        """Answer locally when the key holds a live lease with budget;
        None = caller takes the wire path (and the miss feeds the
        hot-key detector via note_wire)."""
        with self._lock:
            lk = self._leases.get(key)
            if lk is None:
                return None
            if lk.expires <= self.clock():
                # TTL is the client-side bound too: a lease whose renews
                # stopped landing (lost revocation, partition) dies HERE
                # no later than it dies on the server.
                self._drop_locked(lk)
                self._c_fallback.inc(reason="expired")
                return None
            if n > lk.tokens:
                self._c_fallback.inc(
                    reason="oversize" if n > lk.budget else "exhausted")
                return None
            lk.tokens -= n
            lk.consumed_since += n
            remaining = lk.tokens
            limit = lk.limit
        self._c_local.inc()
        return Result(allowed=True, limit=limit, remaining=remaining,
                      retry_after=0.0, reset_at=0.0, fail_open=False)

    def note_wire(self, key: str) -> None:
        """Count a wire decision toward the key's hotness; the
        background driver picks hot keys up via actions()."""
        now = self.clock()
        with self._lock:
            if key in self._leases or key in self._grant_pending:
                return
            count, start = self._hot.get(key, (0, now))
            if now - start > self.hot_window:
                count, start = 0, now
            self._hot[key] = (count + 1, start)
            if len(self._hot) > self.max_tracked:
                cutoff = now - self.hot_window
                self._hot = {k: v for k, v in self._hot.items()
                             if v[1] > cutoff and v[0] > 1}

    # -------------------------------------------------- background work

    def actions(self) -> List[tuple]:
        """Work for the background driver:
        ``("grant", key, want)`` and
        ``("renew", key, lease_id, consumed_delta, want)``.
        Consumed deltas are MOVED out here (exactly-once);
        :meth:`renew_failed` re-credits them if the send never reached
        the server."""
        now = self.clock()
        out: List[tuple] = []
        with self._lock:
            for key, (count, start) in list(self._hot.items()):
                if count >= self.hot_after and now - start <= self.hot_window:
                    self._hot.pop(key, None)
                    self._grant_pending[key] = now
                    out.append(("grant", key, self.want))
            for lk in list(self._leases.values()):
                if lk.renew_pending:
                    continue
                # Renew when budget runs low, the TTL is half spent, or
                # there is consumption to reconcile (the audit mirror's
                # freshness rides the driver's tick).
                low = lk.tokens <= self.low_water * max(1, lk.budget)
                halfway = now >= lk.expires - 0.5 * lk.ttl
                if low or halfway or lk.consumed_since > 0:
                    lk.renew_pending = True
                    delta, lk.consumed_since = lk.consumed_since, 0
                    want = self.want or lk.budget
                    top_up = max(0, want - lk.tokens) if low else 0
                    out.append(("renew", lk.key, lk.lease_id, delta,
                                top_up))
        return out

    # ------------------------------------------------- transport results

    def on_grant(self, key: str, granted: bool, lease_id: int,
                 budget: int, ttl_s: float, limit: int,
                 epoch: int) -> None:
        now = self.clock()
        with self._lock:
            self._grant_pending.pop(key, None)
            if not granted or budget <= 0:
                return
            ttl = max(0.05, ttl_s)
            lk = LeasedKey(key, lease_id, budget, limit, now + ttl,
                           ttl, epoch)
            self._leases[key] = lk
            self._by_id[lease_id] = key

    def grant_failed(self, key: str) -> None:
        """Transport error: clear the pending marker so a still-hot key
        retries on a later tick."""
        with self._lock:
            self._grant_pending.pop(key, None)

    def on_renew(self, lease_id: int, granted: bool, top_up: int,
                 ttl_s: float, limit: int, epoch: int) -> None:
        now = self.clock()
        with self._lock:
            key = self._by_id.get(lease_id)
            lk = self._leases.get(key) if key is not None else None
            if lk is None:
                return
            lk.renew_pending = False
            if not granted:
                # Revoked/expired server-side (possibly a lost push):
                # the local counter dies NOW — remaining tokens are
                # abandoned, never over-admitted.
                self._drop_locked(lk)
                return
            if top_up > 0:
                lk.tokens += top_up
                lk.budget = max(lk.budget, lk.tokens)
            if limit > 0:
                lk.limit = limit
            lk.ttl = max(0.05, ttl_s)
            lk.expires = now + lk.ttl
            lk.epoch = epoch or lk.epoch

    def renew_failed(self, lease_id: int, consumed_delta: int) -> None:
        """The renew never reached the server: re-credit the moved delta
        so the next renew reports it (exactly-once accounting)."""
        with self._lock:
            key = self._by_id.get(lease_id)
            lk = self._leases.get(key) if key is not None else None
            if lk is None:
                return
            lk.renew_pending = False
            lk.consumed_since += int(consumed_delta)

    # --------------------------------------------------- invalidation

    def invalidate_ids(self, lease_ids, reason: str = "revoked") -> int:
        """Server push: drop the named leases (empty = drop ALL)."""
        with self._lock:
            if not lease_ids:
                victims = list(self._leases.values())
            else:
                victims = [self._leases[k] for i in lease_ids
                           if (k := self._by_id.get(i)) is not None
                           and k in self._leases]
            for lk in victims:
                self._drop_locked(lk)
            return len(victims)

    def on_epoch(self, epoch: int) -> int:
        """Fleet map moved (ADR-017): leases granted under an older
        epoch may name ranges this server no longer owns — drop them;
        the wire path re-routes and re-leases against the new owner."""
        with self._lock:
            if epoch <= self.epoch:
                return 0
            self.epoch = epoch
            victims = [lk for lk in self._leases.values()
                       if lk.epoch < epoch]
            for lk in victims:
                self._drop_locked(lk)
            return len(victims)

    def _drop_locked(self, lk: LeasedKey) -> None:
        self._leases.pop(lk.key, None)
        self._by_id.pop(lk.lease_id, None)

    # --------------------------------------------------------- shutdown

    def drain(self) -> List[tuple]:
        """Hand every lease back: ``("return", key, lease_id,
        consumed_delta)`` rows for the driver's final sends; the local
        table empties immediately (no more local answers)."""
        with self._lock:
            rows = [("return", lk.key, lk.lease_id, lk.consumed_since)
                    for lk in self._leases.values()]
            self._leases.clear()
            self._by_id.clear()
            self._hot.clear()
            self._grant_pending.clear()
        return rows

    # ----------------------------------------------------------- status

    def status(self) -> dict:
        with self._lock:
            return {
                "client_id": f"{self.client_id:016x}",
                "leased_keys": len(self._leases),
                "tracked_hot": len(self._hot),
                "pending_grants": len(self._grant_pending),
                "epoch": self.epoch,
                "local_answers": int(self._c_local.value()),
            }
