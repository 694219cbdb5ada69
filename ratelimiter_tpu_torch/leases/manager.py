"""Server-side lease authority, a copy of
``ratelimiter_tpu/leases/manager.py``.

One LeaseManager per serving process owns every outstanding lease the
process granted. The safety story is debit-upfront: a grant admits the
WHOLE budget through the limiter's normal decide path (on the card, the
step's kernels) before a single token reaches the client, so whatever
the client does afterwards — spends, idles, crashes, partitions — the
key's window has already charged the mass. Unused budget is deliberately
NOT re-credited on return or expiry: a crashed client's tokens read as
consumed (false denies for the remainder of the window), never as
over-admission. That is the documented failure side of the global bound,
and the audit mirror is what measures its cost.

Grants live in a columnar table (parallel numpy arrays on capture) so
the checkpoint sidecar rides the snapshot cycle like any other state;
key STRINGS never enter the table — only the side-table-compatible
hashed consumer token, which is all the restore path needs because
RENEW/RETURN frames re-carry the key.

In a fleet the binary wires ``epoch_fn``/``owns_fn`` to the fleet core
(grants over ranges the member no longer owns are revoked) and
``gossip`` to the membership's announce connections; without a fleet,
``gossip`` is the first DCN pusher's ``push_lease`` when the binary
runs ``--dcn-peer``. Revocation pushes traverse the chaos injector's DCN
seam, so the partition and corruption drills exercise the
lost-revocation path.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from time import monotonic
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from ratelimiter_tpu_torch.observability import events
from ratelimiter_tpu_torch.observability import metrics as m
from ratelimiter_tpu_torch.ops.hashing import key_token
from ratelimiter_tpu_torch.serving import protocol as p

log = logging.getLogger("ratelimiter_tpu_torch.leases")

#: Default grant TTL. Push revocation is the fast path; the TTL is the
#: bound on how long a client that LOST the push (partition, chaos) can
#: keep answering locally — tune it as the staleness budget.
DEFAULT_TTL = 2.0
DEFAULT_BUDGET = 256
MAX_BUDGET = 1 << 20


class _MirrorResult:
    """Result shim for the audit tap: ``consumed`` leased admissions for
    one key replay against the shadow oracle exactly like an
    ``allow_n(key, consumed)`` wire admission would."""

    __slots__ = ("allowed", "fail_open", "fail_open_slices")

    def __init__(self) -> None:
        self.allowed = np.ones(1, dtype=bool)
        self.fail_open = False
        self.fail_open_slices = None

    def __len__(self) -> int:
        return 1


@dataclass
class Grant:
    lease_id: int
    client: int
    key: str
    token: str           # hh-compatible consumer token (no raw key)
    budget: int          # total tokens debited for this grant
    consumed: int        # client-reported spend (reconciled)
    expires: float       # monotonic deadline; renew extends
    epoch: int           # fleet map epoch at grant time
    push: Optional[Callable[[bytes], None]] = None
    #: revoked grants linger (tombstoned) until TTL so a late RENEW gets
    #: a clean granted=False instead of an unknown-lease ambiguity.
    revoked: bool = field(default=False)


class LeaseManager:
    """Grant authority + revocation fan-out for one serving process.

    Args:
        limiter: the serving limiter stack (its ``allow_n`` is the
            default debit path and its config supplies the hh hashing
            rule for eligibility checks).
        decide: optional ``(key, n) -> result`` override for the debit —
            the serving binary passes its thread-safe batcher decide so
            lease debits ride the same dispatch pipeline as wire
            decisions (required on multi-shard doors, where a direct
            ``limiter.allow_n`` would debit the wrong shard).
        ttl: grant lifetime in seconds (renewals extend it).
        default_budget / max_budget: tokens per grant when the client
            does not ask / cap on what it may ask.
        max_leases: active-grant capacity (grants beyond it are refused,
            clients stay on the wire path).
        require_hot: only grant keys currently in the hh side table's
            top-k (``consumer_stats``) — the paper's hot-key nomination.
            False opens eligibility to any key (tests, sketch-less
            backends).
        hot_k: how deep in the top-k a key may sit and still be leased.
        epoch_fn: zero-arg callable returning the fleet map epoch (0 =
            not a fleet member).
        owns_fn: optional ``(key) -> bool`` ownership probe; on an epoch
            bump, grants whose key this host no longer owns are revoked
            (None = revoke ALL grants on any epoch change — safe and
            coarse).
        gossip: optional ``(payload: dict) -> None`` hook that forwards
            a revocation to the fleet's DCN push machinery.
    """

    def __init__(self, limiter, *, decide=None, ttl: float = DEFAULT_TTL,
                 default_budget: int = DEFAULT_BUDGET,
                 max_budget: int = 4096, max_leases: int = 4096,
                 require_hot: bool = False, hot_k: int = 16,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 owns_fn: Optional[Callable[[str], bool]] = None,
                 gossip: Optional[Callable[[dict], None]] = None,
                 registry: Optional[m.Registry] = None,
                 clock: Callable[[], float] = monotonic):
        self.limiter = limiter
        self._decide = decide if decide is not None else (
            lambda key, n: limiter.allow_n(key, n))
        self.ttl = float(ttl)
        self.default_budget = int(default_budget)
        self.max_budget = min(int(max_budget), MAX_BUDGET)
        self.max_leases = int(max_leases)
        self.require_hot = bool(require_hot)
        self.hot_k = int(hot_k)
        self.epoch_fn = epoch_fn
        self.owns_fn = owns_fn
        self.gossip = gossip
        self.clock = clock
        self._lock = threading.Lock()
        self._grants: Dict[int, Grant] = {}
        self._by_key: Dict[str, Set[int]] = {}
        self._next_id = 1
        self._last_epoch = epoch_fn() if epoch_fn is not None else 0
        #: Hotness ledger: consumer token -> grants issued. A key that
        #: EARNED a lease stays grant-worthy across a restart, when the
        #: hh side table is cold and ``require_hot`` would otherwise
        #: refuse every grant until the sketch re-warms. Bounded;
        #: checkpointed with the grant table (hot_token/hot_count
        #: columns — tokens only, the OPERATIONS §6 PII boundary).
        self._hot_counts: Dict[str, int] = {}
        self._hot_cap = max(64, 4 * self.hot_k)

        reg = registry if registry is not None else m.DEFAULT
        self._g_active = reg.gauge(
            "rate_limiter_leases_active",
            "Outstanding client-embedded quota leases (ADR-022)")
        self._c_grants = reg.counter(
            "rate_limiter_lease_grants_total",
            "Lease grant requests by outcome (granted / refused)")
        self._c_renews = reg.counter(
            "rate_limiter_lease_renewals_total",
            "Lease renewals by outcome (extended / refused)")
        self._c_revoked = reg.counter(
            "rate_limiter_lease_revocations_total",
            "Leases revoked, by reason (policy / limit / controller / "
            "epoch / shutdown / manual)")
        self._c_expired = reg.counter(
            "rate_limiter_lease_expired_total",
            "Leases that hit their TTL without renew or return "
            "(crashed or partitioned holders; their unused budget "
            "stays consumed)")
        self._c_tokens = reg.counter(
            "rate_limiter_lease_tokens_total",
            "Lease token flow: debited upfront (granted), "
            "client-reported spend (consumed), and handed back unspent "
            "(returned — NOT re-credited to the window)")
        self._c_push_fail = reg.counter(
            "rate_limiter_lease_push_failures_total",
            "Revocation pushes that could not be delivered (dead or "
            "chaos-dropped connection) — the holder's staleness is then "
            "bounded by the lease TTL")

    # ------------------------------------------------------------- debit

    def _debit(self, key: str, n: int):
        """(allowed, limit) through the configured decide path. A debit
        that ERRORS refuses the grant — the client stays on the wire
        path, which is always correct."""
        try:
            res = self._decide(key, n)
        except Exception:  # noqa: BLE001 — refuse, never over-admit
            log.exception("lease debit failed for %d tokens", n)
            return False, 0
        return bool(res.allowed), int(res.limit)

    # ------------------------------------------------------- eligibility

    def _hot_tokens(self) -> Optional[Set[str]]:
        stats = getattr(self.limiter, "consumer_stats", None)
        if stats is None:
            return None
        try:
            top = stats(self.hot_k).get("top") or []
        except Exception:  # noqa: BLE001 — analytics, not a dependency
            return None
        return {row["consumer"] for row in top}

    def _consumer_token(self, key: str) -> str:
        """The key's hh-table consumer token under THIS limiter's
        hashing rule (prefix + sketch seed) — comparable against
        ``consumer_stats`` rows. Falls back to the journal key token
        for limiters without a sketch config."""
        try:
            from ratelimiter_tpu_torch.ops.hashing import (
                hash_prefixed_u64,
                split_hash,
            )

            cfg = self.limiter.config
            h64 = hash_prefixed_u64([key], cfg.prefix)
            h1, h2 = split_hash(h64, cfg.sketch.seed)
            return f"{(int(h1[0]) << 32) | int(h2[0]):016x}"
        except Exception:  # noqa: BLE001
            return key_token(key)

    def eligible(self, key: str) -> bool:
        """Hot-key nomination: with ``require_hot`` the key must sit in
        the hh side table's current top-k (the sketch already tracks
        exactly the keys worth leasing), or in the persisted hotness
        ledger — a key that already earned a lease stays eligible after
        a restart while the restored sketch's side table re-warms;
        otherwise any key qualifies."""
        if not self.require_hot:
            return True
        token = self._consumer_token(key)
        hot = self._hot_tokens()
        if hot and token in hot:
            return True
        with self._lock:
            return token in self._hot_counts

    def _note_hot_locked(self, token: str) -> None:
        self._hot_counts[token] = self._hot_counts.get(token, 0) + 1
        if len(self._hot_counts) > self._hot_cap:
            # Evict the coldest entry (ties: lowest token) — the ledger
            # is a warm-start hint, not an exact ranking.
            victim = min(self._hot_counts.items(),
                         key=lambda kv: (kv[1], kv[0]))[0]
            del self._hot_counts[victim]

    # ------------------------------------------------------------ grants

    def grant(self, client: int, key: str, want: int = 0,
              ttl_want: float = 0.0,
              push: Optional[Callable[[bytes], None]] = None):
        """-> (granted, lease_id, budget, ttl_s, limit, epoch)."""
        now = self.clock()
        self._sweep(now)
        self.check_epoch()
        epoch = self._last_epoch
        if not self.eligible(key):
            self._c_grants.inc(result="refused")
            return False, 0, 0, 0.0, 0, epoch
        with self._lock:
            room = len(self._grants) < self.max_leases
        if not room:
            self._c_grants.inc(result="refused")
            return False, 0, 0, 0.0, 0, epoch
        budget = max(1, min(int(want) or self.default_budget,
                            self.max_budget))
        allowed, limit = self._debit(key, budget)
        if not allowed:
            self._c_grants.inc(result="refused")
            return False, 0, 0, 0.0, limit, epoch
        ttl = min(ttl_want, self.ttl) if ttl_want > 0 else self.ttl
        token = self._consumer_token(key)
        # Re-sample the clock: the debit above can block for seconds on
        # a first-call JIT compile, and the TTL must start when the
        # budget actually goes live, not when the request arrived.
        now = self.clock()
        with self._lock:
            lease_id = self._next_id
            self._next_id += 1
            g = Grant(lease_id=lease_id, client=client, key=key,
                      token=token, budget=budget, consumed=0,
                      expires=now + ttl, epoch=epoch, push=push)
            self._grants[lease_id] = g
            self._by_key.setdefault(key, set()).add(lease_id)
            self._note_hot_locked(token)
            active = sum(1 for gg in self._grants.values()
                         if not gg.revoked)
        self._g_active.set(active)
        self._c_grants.inc(result="granted")
        self._c_tokens.inc(budget, flow="granted")
        events.emit("lease", "grant",
                    payload={"lease_id": lease_id,
                             "key_hash": key_token(key),
                             "client": f"{client:016x}",
                             "budget": budget, "ttl_s": round(ttl, 3),
                             "epoch": epoch})
        return True, lease_id, budget, ttl, limit, epoch

    def renew(self, client: int, lease_id: int, key: str,
              consumed: int, want: int):
        """-> (granted, lease_id, top_up, ttl_s, limit, epoch). A renew
        of a revoked/expired/unknown lease answers granted=False — the
        client's local counter dies with it (TTL is the staleness bound
        when the revocation push was lost)."""
        now = self.clock()
        self._sweep(now)
        self.check_epoch()
        self._reconcile(key, consumed, now)
        with self._lock:
            g = self._grants.get(lease_id)
            if g is None or g.revoked or g.client != client:
                pass
            else:
                g.consumed += int(consumed)
                g.expires = now + self.ttl
        if g is None or g.revoked or g.client != client:
            self._c_renews.inc(result="refused")
            return False, lease_id, 0, 0.0, 0, self._last_epoch
        top_up = 0
        limit = 0
        if want > 0:
            ask = min(int(want), self.max_budget)
            allowed, limit = self._debit(key, ask)
            if allowed:
                top_up = ask
                with self._lock:
                    g.budget += ask
                self._c_tokens.inc(ask, flow="granted")
        self._c_renews.inc(result="extended")
        return True, lease_id, top_up, self.ttl, limit, self._last_epoch

    def release(self, client: int, lease_id: int, key: str,
                consumed: int):
        """RETURN: reconcile the final count and drop the grant. Unused
        budget is NOT re-credited — the window already charged it."""
        now = self.clock()
        self._reconcile(key, consumed, now)
        with self._lock:
            g = self._grants.get(lease_id)
            dropped = (g is not None and g.client == client)
            if dropped:
                g.consumed += int(consumed)
                unused = max(0, g.budget - g.consumed)
                self._drop_locked(g)
            active = sum(1 for gg in self._grants.values()
                         if not gg.revoked)
        self._g_active.set(active)
        if dropped:
            self._c_tokens.inc(unused, flow="returned")
            events.emit("lease", "return",
                        payload={"lease_id": lease_id,
                                 "key_hash": key_token(key),
                                 "consumed": int(consumed),
                                 "unused": unused})
        # granted=False: the lease is gone either way — the client's
        # local counter must not outlive a RETURN.
        return False, lease_id, 0, 0.0, 0, self._last_epoch

    # ------------------------------------------------------ audit mirror

    def _reconcile(self, key: str, consumed: int, now: float) -> None:
        """Mirror client-reported leased admissions into the audit tap:
        one weight-``consumed`` admission for the key, exactly how an
        ``allow_n`` wire admission audits (ADR-016). Reconcile
        granularity — one offer per renew/return, not per local decision
        — is the documented timing coarseness of the lease mirror."""
        if consumed <= 0:
            return
        self._c_tokens.inc(consumed, flow="consumed")
        from ratelimiter_tpu_torch.observability import audit

        auditor = audit.AUDITOR
        if auditor is not None:
            auditor.offer_keys([key], np.asarray([consumed],
                                                 dtype=np.int64),
                               now, _MirrorResult())

    # -------------------------------------------------------- revocation

    def _drop_locked(self, g: Grant) -> None:
        self._grants.pop(g.lease_id, None)
        ids = self._by_key.get(g.key)
        if ids is not None:
            ids.discard(g.lease_id)
            if not ids:
                self._by_key.pop(g.key, None)

    def _push_revoke(self, grants: List[Grant], reason: int,
                     epoch: int) -> None:
        """Send one T_LEASE_REVOKE push per (connection) holder; pushes
        traverse the chaos DCN seam."""
        from ratelimiter_tpu_torch import chaos

        by_push: Dict[int, tuple] = {}
        for g in grants:
            if g.push is None:
                continue
            by_push.setdefault(id(g.push), (g.push, []))[1].append(
                g.lease_id)
        for push, ids in by_push.values():
            frame = p.encode_lease_revoke(reason, epoch, ids)
            if chaos.INJECTOR is not None:
                frame = chaos.INJECTOR.dcn_frame(frame)
                if frame is None:
                    self._c_push_fail.inc(len(ids))
                    continue
            try:
                push(frame)
            except Exception:  # noqa: BLE001 — TTL bounds the holder
                self._c_push_fail.inc(len(ids))

    def _revoke_grants(self, grants: List[Grant], reason: int, *,
                       origin: str = "local") -> int:
        if not grants:
            return 0
        epoch = self._last_epoch
        now = self.clock()
        label = p.LEASE_REASONS.get(reason, str(reason))
        with self._lock:
            for g in grants:
                # Tombstone until TTL: a renew that raced the push gets
                # a clean granted=False answer instead of unknown-lease.
                g.revoked = True
                g.expires = min(g.expires, now + self.ttl)
            active = sum(1 for gg in self._grants.values()
                         if not gg.revoked)
        self._g_active.set(active)
        self._c_revoked.inc(len(grants), reason=label)
        self._push_revoke(grants, reason, epoch)
        events.emit("lease", "revoke", severity="warning",
                    payload={"reason": label, "count": len(grants),
                             "origin": origin, "epoch": epoch,
                             "keys": sorted({key_token(g.key)
                                             for g in grants})[:16]})
        return len(grants)

    def revoke_key(self, key: str, reason: int = p.LEASE_REV_POLICY, *,
                   origin: str = "local") -> int:
        """Revoke every grant on one key (policy override set/deleted,
        AIMD tighten on its scope). Gossips to fleet peers so THEIR
        holders die too."""
        with self._lock:
            grants = [self._grants[i]
                      for i in self._by_key.get(key, ())
                      if not self._grants[i].revoked]
        n = self._revoke_grants(grants, reason, origin=origin)
        if self.gossip is not None and origin == "local":
            try:
                self.gossip({"scope": "key",
                             "key_hash": self._consumer_token(key),
                             "reason": p.LEASE_REASONS.get(reason,
                                                           str(reason)),
                             "epoch": self._last_epoch})
            except Exception:  # noqa: BLE001 — best-effort propagation
                log.exception("lease revocation gossip failed")
        return n

    def revoke_token(self, token: str, reason: int, *,
                     origin: str = "peer") -> int:
        """Revoke by hashed consumer token — the DCN gossip receive path
        (peers never see raw keys)."""
        with self._lock:
            grants = [g for g in self._grants.values()
                      if g.token == token and not g.revoked]
        return self._revoke_grants(grants, reason, origin=origin)

    def revoke_all(self, reason: int = p.LEASE_REV_LIMIT, *,
                   origin: str = "local") -> int:
        """Revoke every outstanding grant (update_limit/update_window,
        controller global tighten, shutdown, operator drill)."""
        with self._lock:
            grants = [g for g in self._grants.values() if not g.revoked]
        n = self._revoke_grants(grants, reason, origin=origin)
        if self.gossip is not None and origin == "local" and n:
            try:
                self.gossip({"scope": "all",
                             "reason": p.LEASE_REASONS.get(reason,
                                                           str(reason)),
                             "epoch": self._last_epoch})
            except Exception:  # noqa: BLE001
                log.exception("lease revocation gossip failed")
        return n

    def on_gossip(self, payload: dict) -> int:
        """Apply a DCN_KIND_LEASE revocation from a fleet peer."""
        reasons = {v: k for k, v in p.LEASE_REASONS.items()}
        reason = reasons.get(payload.get("reason"), p.LEASE_REV_MANUAL)
        if payload.get("scope") == "all":
            return self.revoke_all(reason, origin="peer")
        token = payload.get("key_hash")
        if not token:
            return 0
        return self.revoke_token(token, reason, origin="peer")

    # ------------------------------------------------- epoch / TTL sweep

    def check_epoch(self) -> int:
        """Fleet ownership moved (a range handoff / ADR-017 failover):
        grants for keys this host no longer owns are revoked — their
        budget stays debited HERE (fails toward denial), the new owner
        grants fresh leases against its own window."""
        if self.epoch_fn is None:
            return 0
        try:
            epoch = int(self.epoch_fn())
        except Exception:  # noqa: BLE001
            return 0
        if epoch == self._last_epoch:
            return 0
        self._last_epoch = epoch
        with self._lock:
            if self.owns_fn is None:
                grants = [g for g in self._grants.values()
                          if not g.revoked]
            else:
                grants = [g for g in self._grants.values()
                          if not g.revoked and not self._owns(g.key)]
        return self._revoke_grants(grants, p.LEASE_REV_EPOCH)

    def _owns(self, key: str) -> bool:
        try:
            return bool(self.owns_fn(key))
        except Exception:  # noqa: BLE001 — treat as moved (revoke)
            return False

    def _sweep(self, now: float) -> None:
        with self._lock:
            dead = [g for g in self._grants.values() if g.expires <= now]
            expired = [g for g in dead if not g.revoked]
            for g in dead:
                self._drop_locked(g)
            active = sum(1 for gg in self._grants.values()
                         if not gg.revoked)
        self._g_active.set(active)
        if expired:
            self._c_expired.inc(len(expired))
            events.emit("lease", "expire",
                        payload={"count": len(expired),
                                 "keys": sorted({key_token(g.key)
                                                 for g in expired})[:16]})

    # ------------------------------------------------------- checkpoints

    def snapshot_arrays(self):
        """(arrays, meta): the grant table as parallel numpy columns —
        the device-friendly form the checkpoint sidecar writes. TTLs are
        stored as REMAINING seconds (monotonic clocks do not survive a
        restart)."""
        now = self.clock()
        with self._lock:
            gs = sorted(self._grants.values(), key=lambda g: g.lease_id)
            arrays = {
                "lease_id": np.asarray([g.lease_id for g in gs],
                                       dtype=np.uint64),
                "client": np.asarray([g.client for g in gs],
                                     dtype=np.uint64),
                "token": np.asarray([int(g.token, 16) for g in gs],
                                    dtype=np.uint64),
                "budget": np.asarray([g.budget for g in gs],
                                     dtype=np.int64),
                "consumed": np.asarray([g.consumed for g in gs],
                                       dtype=np.int64),
                "ttl_left": np.asarray([g.expires - now for g in gs],
                                       dtype=np.float64),
                "revoked": np.asarray([g.revoked for g in gs],
                                      dtype=np.bool_),
                "epoch": np.asarray([g.epoch for g in gs],
                                    dtype=np.uint64),
            }
            # Hotness ledger rides the same sidecar so restart keeps
            # hot-key eligibility warm (tokens only, never raw keys).
            hot = sorted(self._hot_counts.items())
            arrays["hot_token"] = np.asarray(
                [int(t, 16) for t, _ in hot], dtype=np.uint64)
            arrays["hot_count"] = np.asarray(
                [c for _, c in hot], dtype=np.int64)
            meta = {"next_id": self._next_id,
                    "last_epoch": self._last_epoch}
        return arrays, meta

    def restore_arrays(self, arrays, meta) -> int:
        """Rebuild the grant table from a checkpoint sidecar. Restored
        grants have no push channel (their connections died with the
        old process) — holders either renew (the lease answers by id)
        or the TTL expires them; the debited mass was restored with the
        LIMITER's own snapshot and is never re-credited."""
        now = self.clock()
        with self._lock:
            self._grants.clear()
            self._by_key.clear()
            n = len(arrays["lease_id"])
            for i in range(n):
                token = f"{int(arrays['token'][i]):016x}"
                g = Grant(
                    lease_id=int(arrays["lease_id"][i]),
                    client=int(arrays["client"][i]),
                    # Raw keys never ride checkpoints; RENEW/RETURN
                    # frames re-supply the string, keyed by lease id.
                    key="",
                    token=token,
                    budget=int(arrays["budget"][i]),
                    consumed=int(arrays["consumed"][i]),
                    expires=now + min(float(arrays["ttl_left"][i]),
                                      self.ttl),
                    epoch=int(arrays["epoch"][i]),
                    revoked=bool(arrays["revoked"][i]))
                self._grants[g.lease_id] = g
            if "hot_token" in arrays:
                # Older sidecars predate the ledger: keep it empty and
                # let grants rebuild it.
                self._hot_counts = {
                    f"{int(t):016x}": int(c)
                    for t, c in zip(arrays["hot_token"],
                                    arrays["hot_count"])}
            self._next_id = max(int(meta.get("next_id", 1)),
                                (max(self._grants) + 1
                                 if self._grants else 1))
            self._last_epoch = int(meta.get("last_epoch",
                                            self._last_epoch))
            active = sum(1 for gg in self._grants.values()
                         if not gg.revoked)
        self._g_active.set(active)
        return n

    # ------------------------------------------------------------ status

    def status(self) -> dict:
        now = self.clock()
        with self._lock:
            active = [g for g in self._grants.values()
                      if not g.revoked and g.expires > now]
            out = {
                "leases": True,
                "active": len(active),
                "tombstoned": len(self._grants) - len(active),
                "keys": len(self._by_key),
                "ttl_s": self.ttl,
                "default_budget": self.default_budget,
                "max_leases": self.max_leases,
                "require_hot": self.require_hot,
                "hot_ledger": len(self._hot_counts),
                "epoch": self._last_epoch,
            }
        out["granted_total"] = int(
            self._c_grants.value(result="granted"))
        out["revoked_total"] = int(self._c_revoked.total())
        out["expired_total"] = int(self._c_expired.value())
        return out

    def close(self) -> None:
        """Graceful shutdown: push revoke-all so holders fall back to
        the wire path (their next server) immediately."""
        self.revoke_all(p.LEASE_REV_SHUTDOWN)
