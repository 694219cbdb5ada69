"""Server binary: ``python -m ratelimiter_tpu_torch.serving``.

Serves a limiter on the card (``--device cuda``, the default; ``--device
cpu`` runs the kernels' plain versions). ``--backend sketch`` (the
default) serves a count-min sketch: the windowed sketch, or with
``--algorithm token_bucket`` the sketched token bucket
(``--sub-windows``, ``--no-conservative-update`` and ``--hh-slots`` do
not apply to it); ``--backend dense`` exact slot-addressed state on the
card (``--dense-capacity`` slots; at most 8192 requests a launch, so
``--max-batch`` at most 8192) and ``--backend exact`` the host oracle.
Dense and exact serve ALLOW and ALLOW_BATCH frames (string keys); the
raw-id ALLOW_HASHED lane needs a sketch backend and is refused as in the
JAX binary,
behind the micro-batcher (``--max-batch``, ``--max-delay-us``,
``--dispatch-timeout-ms``, ``--inflight``; the JAX binary's names and
defaults). Before it listens it builds and loads the CUDA kernels (on
the card) and the C++ bulk hasher, so no client frame pays a build; then
it prints a line starting with ``serving``. SIGINT/SIGTERM stop it
gracefully (the batcher drains first).

``--snapshot-dir DIR`` turns on the durability subsystem (persistence/):
a write-ahead log of every mutation (policy frames, RESET, dynamic
limit/window updates), background snapshots every ``--snapshot-interval``
seconds (and after ``--snapshot-after-mutations`` mutations), and on
start a recovery from the newest snapshot plus the WAL replayed past it,
before the door listens (a ``recovered`` line precedes ``serving``). The
SNAPSHOT frame takes one on demand. A crash loses the decisions made
after the last snapshot, by design (under-counting); a SIGTERM takes a
final snapshot and loses nothing. Boot with the limit and window the
snapshot was taken under: a snapshot refuses to restore under another
config (checkpoint.py fingerprint). The JAX binary's flags and defaults.

``--tenants N`` turns on the hierarchy cascade (ADR-020): every decision
is held to its key's scope, its tenant's and the global one, in the same
launch. ``--tenant-map``, ``--global-limit``, ``--default-tenant-limit``,
``--tenant NAME=LIMIT[:WEIGHT[:FLOOR]]`` and ``--assign KEY=TENANT``
configure it (the tenant and assignment flags apply after recovery, so
they win over a snapshot's registry for the names they touch), and
``--controller`` runs the AIMD controller every ``--controller-interval``
seconds over it (hierarchy/controller.py; its gauges show on METRICS).
The wire protocol is unchanged: tenant ids derive from the key. The JAX
binary's flags, refusals and boot order.

Observability, with the JAX binary's flags and defaults: every limiter is
wrapped in the decorator stack (``build_limiter_stack``: ``--trace``
TracingDecorator, ``--circuit-breaker`` CircuitBreakerDecorator,
MetricsDecorator unless ``--no-metrics``, ``--log-decisions``
LoggingDecorator, innermost first, the persistence wrapper outermost);
``--flight-recorder`` turns the flight recorder on before any serving
thread starts (``rate_limiter_stage_seconds`` on METRICS); the event
journal is on unless ``--no-event-journal`` (``--event-journal-dir``
spills it to JSONL segments and replays their tail at start).

``--http-port`` also serves the HTTP gateway (serving/http_gateway.py):
its decisions go through the door's micro-batcher
(``make_threadsafe_decide``), so HTTP and binary frames share launches
and windows. ``/healthz`` carries the JAX binary's blocks (the sketch's
envelope or debt slab, the side table's consumers, the audit and SLO
blocks, the hierarchy, the leases, the journal, the persistence status;
the mesh's quarantine block under ``--quarantine``; the fleet and
placement blocks in a fleet); ``/v1/reset``, ``/v1/policy``,
``/v1/tenants``, ``/v1/snapshot`` and the ``/debug`` routes are gated by
the JAX binary's ``--http-*``, ``--debug-*`` and ``--audit-token``
flags. ``--audit`` turns on the live accuracy observatory
(observability/audit.py: a 1 in ``--audit-sample`` hash-sampled shadow
of the served decisions, ``--audit-twin`` adding the collision-free
twin on the serving limiter's device) and the SLO burn tracker
(observability/slo.py), whose statuses the AIMD controller reads; the
dense and exact backends refuse it, as in the JAX binary.

``--native`` serves the binary door through the C++ front door
(serving/native_server.py over native/server.cpp, built with g++ before
the ``serving(native)`` line; a failed build stops the binary with the
compiler's message): ``--shards N`` dispatch shards on the one device,
keys routed by FNV-1a, each shard under the decorator stack with its own
``shard`` label and the persistence wrapper (the WAL's resets replay onto
their shard; with ``--tenants`` each shard enforces 1/N of the tenant and
global limits); ``--net-engine`` and ``--io-rings`` its io threads. Both
doors take ``--listen unix:/path`` and ``--shm`` (``--shm-dir``,
``--shm-ring-bytes``: the shared-memory lane). ``--shards`` needs
``--native``. With no ``--algorithm`` the binary serves ``tpu_sketch``
(the JAX binary's default), which decides as the sliding window; a
snapshot taken under ``--algorithm sliding_window`` restores only under
that flag (the fingerprint names the algorithm).

``--grpc-port`` serves the gRPC contract (serving/grpc_server.py, its
descriptor committed in serving/grpc_pb.py) beside either door, its
decisions through the same batcher or shard router. ``--leases`` turns
on client-embedded quota leases (leases/; ``--lease-ttl``,
``--lease-budget``, ``--lease-max``, ``--lease-require-hot`` over the
side table, which needs ``--hh-slots``): the asyncio door serves the
lease frames on its port, the native door on the ``--lease-port``
sidecar; a grant debits its budget through the door's decide path, the
HTTP and gRPC policy and reset levers revoke the key's leases, an AIMD
tighten revokes all of them, and with ``--snapshot-dir`` the grant table
rides every snapshot. The JAX binary's flags, defaults and refusals.

``--backend mesh`` serves the sliced mesh (parallel/): one slice per
card (``--mesh-devices N`` of them, default every visible card; N
slices on the CPU under ``--device cpu``), keys hash-routed to their
owning slice. ``--router host`` (the default) partitions frames on the
host; under ``--native`` the slices are the door's dispatch shards,
each under its own decorator stack. ``--router collective`` (with
``--bin-headroom``) makes every frame one routed dispatch
(``route_bins`` on the card, an all-to-all of rows) behind either door,
which then serves the composite limiter, as the asyncio door always
does. ``--quarantine`` (``--slice-deadline-ms``, ``--probe-interval``,
``--quarantine-threshold``) guards each slice: a failing slice's range
answers per ``--fail-open`` while the others serve exactly, and with
``--snapshot-dir`` a recovering slice restores from the snapshot and
the WAL before it rejoins, and a snapshot of another slice count is
re-bucketed onto ``--mesh-devices`` at recovery (parallel/reshard.py).
The JAX binary's flags, defaults and refusals.

Cross-pod DCN, on either door and on ``--backend sketch`` or ``mesh``:
``--dcn-peer HOST:PORT`` (repeatable) runs one pusher per dispatch unit
(the native door's shards, a mesh's slices) exporting completed slabs
or debt deltas every ``--dcn-interval`` seconds to each peer, and
implies ``--dcn-listen``, which takes peers' pushes (the native door
holds at most ``--dcn-max-transfers`` slab-sized receive buffers at
once); ``--dcn-secret`` (or ``RATELIMITER_TPU_DCN_SECRET``) signs and
requires the RLA2 envelope; with ``--leases`` a revocation is gossiped
to the peers through the first pusher. The JAX binary's flags, defaults
and refusals (``--dcn-peer`` on another backend).

The fleet, on either door: ``--fleet-config MAP --fleet-self ID`` makes
this server one member of a fleet that is one limiter (fleet/): it owns
the hash buckets the map gives it, forwards mis-routed rows to their
owner over coalesced peer lanes (``--fleet-forward-*``) or, with
``--fleet-no-forward``, answers them E_NOT_OWNER; members announce over
the DCN channel every ``--fleet-heartbeat`` seconds, a peer silent for
``--fleet-dead-after`` (after ``--fleet-boot-grace``) fails over to its
successor, which restores the dead member's newest snapshot and WAL
suffix on this server's device, and ``--fleet-rejoin auto`` hands the
ranges back when it returns. ``--http-migrate-token`` opens POST
/v1/fleet/migrate; SIGTERM departs (hands the ranges to the successor)
before the door drains. ``--chaos-scenario`` (``--chaos-slice``,
``--chaos-after``, ``--chaos-seconds``, ``--chaos-seed``) arms the chaos
harness in the serving process (test and bench only). The JAX binary's
flags, defaults and refusals.

The fleet's control plane, with ``--http-port`` on a member whose map
declares each member's ``"http"`` port: ``GET /v1/fleet/status`` merges
every member's /healthz (``fleet/tower.py``), ``/debug/trace?fleet=1``
stitches the members' span rings on the membership's clock offsets and
``/debug/events?fleet=1`` merges their journals (both behind the debug
token, which is passed through to the peers). ``--rebalance`` runs the
placement controller (``placement/``) every ``--rebalance-interval``
seconds: it gathers every member's load, plans with the
``--rebalance-*`` knobs and moves the ranges this member donates through
the migration handoff; ``--http-rebalance-token`` opens GET/POST
/v1/fleet/rebalance (status, dry-run, apply, abort). The JAX binary's
flags, defaults, refusals and warnings.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import time
from types import SimpleNamespace

from ratelimiter_tpu_torch import (
    Algorithm,
    Config,
    DenseParams,
    HierarchySpec,
    MeshSpec,
    PersistenceSpec,
    SketchParams,
    create_limiter,
)
from ratelimiter_tpu_torch.ops.sketch_cuda import ADMIT_CAPACITY
from ratelimiter_tpu_torch.serving.server import RateLimitServer

_ALGORITHMS = ("sliding_window", "fixed_window", "tpu_sketch",
               "token_bucket")


def build_parser() -> argparse.ArgumentParser:
    """The binary's options: the JAX binary's names and defaults for
    every flag the two share (``--sketch-depth``/``--sketch-width`` keep
    the older ``--depth``/``--width`` as aliases)."""
    ap = argparse.ArgumentParser(
        prog="ratelimiter_tpu_torch.serving",
        description="Count-min-sketch rate limiter on a CUDA card.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8432)
    ap.add_argument("--listen", default=None, metavar="ADDR",
                    help="binary-door bind override: 'unix:/path' listens "
                         "on a unix domain socket instead of TCP (--port "
                         "ignored for the binary door; the HTTP gateway "
                         "keeps --host)")
    ap.add_argument("--shm", action="store_true",
                    help="enable the zero-syscall shared-memory wire "
                         "lane: a connected client may send SHM_HELLO to "
                         "upgrade its connection to per-connection ring "
                         "pairs in --shm-dir carrying the SAME wire "
                         "frames; the socket stays open as the liveness "
                         "channel. Off (the default) = wire bytes "
                         "identical to a server without this flag")
    ap.add_argument("--shm-dir", default="/dev/shm", metavar="DIR",
                    help="--shm: directory for the ring files (0600, "
                         "unlinked after the handshake; same-uid trust "
                         "boundary)")
    ap.add_argument("--shm-ring-bytes", type=int, default=0, metavar="B",
                    help="--shm: per-direction ring capacity (power of "
                         "two, clamped to [64KiB, 64MiB]; 0 = 2MiB "
                         "default). A client's hello may request its "
                         "own size; the server clamps")
    ap.add_argument("--algorithm", default="tpu_sketch",
                    choices=_ALGORITHMS)
    ap.add_argument("--backend", default="sketch",
                    choices=["exact", "dense", "sketch", "mesh"],
                    help="state backend: sketch (count-min sketch on the "
                         "card), dense (exact slot-addressed state on the "
                         "card), exact (host dicts, the oracle) or mesh "
                         "(slice-parallel serving: one sketch slice per "
                         "card, keys hash-routed to their owning slice)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="--backend mesh: devices to span (default: every "
                         "visible card; with --device cpu, that many "
                         "slices on the CPU)")
    ap.add_argument("--router", default="host",
                    choices=["host", "collective"],
                    help="--backend mesh: how a mixed frame reaches its "
                         "owning slices. 'host' argsorts and fans out "
                         "per-slice sub-launches on the host; "
                         "'collective' makes the whole frame ONE routed "
                         "dispatch — owners and bins computed on the "
                         "card, rows moved by an all-to-all. "
                         "Incompatible with --quarantine")
    ap.add_argument("--bin-headroom", type=float, default=2.0,
                    help="--router collective: per-(source,destination) "
                         "bin capacity multiplier over the L/n mean; a "
                         "frame overflowing a bin falls back to the host "
                         "router (never silently dropped)")
    ap.add_argument("--quarantine", action="store_true",
                    help="--backend mesh: per-slice failure domains — "
                         "slice dispatches get a deadline + failure "
                         "classifier; a failing slice's key range "
                         "degrades per --fail-open while every other "
                         "slice keeps serving exactly, with half-open "
                         "probe recovery and (with --snapshot-dir) "
                         "restore-before-rejoin")
    ap.add_argument("--slice-deadline-ms", type=float, default=250.0,
                    help="per-slice sub-dispatch deadline (quarantine "
                         "mode): a slice not resolving within this "
                         "budget is classified failed")
    ap.add_argument("--probe-interval", type=float, default=1.0,
                    help="seconds between half-open probes of a "
                         "quarantined slice")
    ap.add_argument("--quarantine-threshold", type=int, default=1,
                    help="consecutive classified failures before a "
                         "slice quarantines")
    # The chaos harness (test and bench only): deterministic fault
    # injection in the serving process.
    ap.add_argument("--chaos-scenario", default=None,
                    metavar="NAME",
                    help="arm one chaos scenario in-process (kill-slice, "
                         "slow-slice, wedge-slice, dcn-partition, "
                         "dcn-corrupt, snapshot-stall, migration-stall, "
                         "kill-during-handoff, rejoin-storm). Requires "
                         "--quarantine for the slice scenarios; the "
                         "handoff/rejoin scenarios need --fleet-config. "
                         "Test/bench lever — never set in production")
    ap.add_argument("--chaos-slice", type=int, default=0,
                    help="victim slice index for slice scenarios")
    ap.add_argument("--chaos-after", type=float, default=0.0,
                    help="arm the scenario this many seconds after "
                         "serving starts (0 = immediately) — the "
                         "kill-a-slice-MID-TRAFFIC shape")
    ap.add_argument("--chaos-seconds", type=float, default=0.05,
                    help="delay/stall magnitude for slow-slice / "
                         "snapshot-stall")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="injector RNG seed (failures replay exactly)")
    ap.add_argument("--dense-capacity", type=int, default=1 << 16,
                    help="--backend dense: slots, i.e. the most distinct "
                         "live keys (idle keys are pruned after 2 "
                         "windows)")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--window", type=float, default=60.0,
                    help="window length in seconds")
    ap.add_argument("--sketch-depth", "--depth", dest="sketch_depth",
                    type=int, default=4)
    ap.add_argument("--sketch-width", "--width", dest="sketch_width",
                    type=int, default=65536)
    ap.add_argument("--sub-windows", type=int, default=60)
    ap.add_argument("--no-conservative-update", action="store_true",
                    help="plain sums instead of conservative update")
    ap.add_argument("--hh-slots", type=int, default=0,
                    help="heavy-hitter side table slots (0 = off; power "
                         "of two >= 16): promoted hot keys get exact "
                         "private counters, exported as top-K consumer "
                         "gauges on METRICS (rate_limiter_top_consumer_"
                         "mass, rate_limiter_hh_tracked_consumers). The "
                         "token bucket ignores it")
    ap.add_argument("--fail-open", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=4096,
                    help="micro-batcher flush size. Hashed windows merge "
                         "up to 2x this many rows; above --max-batch 4096 "
                         "they pass the one-launch admission capacity "
                         "(8192 keys) and run the composed back, ~0.6 ms "
                         "a window. With --tenants a window holds at most "
                         "8192 rows (the cascade's one launch) and this "
                         "flag at most 8192")
    ap.add_argument("--max-delay-us", type=float, default=200.0,
                    help="micro-batcher coalescing window, microseconds "
                         "(adaptive: a filling queue flushes sooner)")
    ap.add_argument("--dispatch-timeout-ms", type=float, default=None,
                    help="SLO per dispatch; a breach answers fail-open or "
                         "fail-closed (and turns pipelining off)")
    ap.add_argument("--inflight", type=int, default=8,
                    help="launches kept in flight on the card, overlapping "
                         "host staging and result copies with device "
                         "work; 1 restores launch-then-wait")
    ap.add_argument("--native", action="store_true",
                    help="use the C++ front door (native/server.cpp, "
                         "built with g++ on first use) instead of the "
                         "asyncio server; a failed build stops the "
                         "binary with the compiler's message")
    ap.add_argument("--shards", type=int, default=1,
                    help="native front door dispatch shards: keys are "
                         "hash-routed, each shard decides on its own "
                         "limiter on the same card (per-key semantics "
                         "exact)")
    ap.add_argument("--net-engine", default="auto",
                    choices=("auto", "epoll", "uring"),
                    help="native door wire backend: auto probes io_uring "
                         "at startup and falls back to epoll when the "
                         "kernel or seccomp refuses; epoll forces the "
                         "portable backend; uring requests io_uring but "
                         "still downgrades (recorded in stats/healthz) "
                         "rather than failing")
    ap.add_argument("--io-rings", type=int, default=0,
                    help="native door io ring shards: event-loop threads "
                         "connections are pinned to by accept order; 0 = "
                         "auto (min(4, cores))")
    ap.add_argument("--snapshot-dir", default=None,
                    help="enable the durability subsystem: write-ahead "
                         "log for mutations (policy/reset/config) plus "
                         "background snapshots in this directory; on "
                         "start, state recovers from the newest snapshot "
                         "+ WAL replay. Off by default")
    ap.add_argument("--snapshot-interval", type=float, default=30.0,
                    help="seconds between background snapshots (bounds "
                         "the decisions lost to kill -9 at one interval "
                         "of traffic, in the under-counting direction)")
    ap.add_argument("--snapshot-after-mutations", type=int, default=0,
                    help="also snapshot after this many WAL mutations "
                         "(0 = interval only)")
    ap.add_argument("--snapshot-retain", type=int, default=3,
                    help="snapshots kept on disk; older ones and their "
                         "WAL prefix are pruned")
    ap.add_argument("--wal-fsync", default="always",
                    choices=["always", "interval", "never"],
                    help="WAL durability: fsync every mutation (default), "
                         "at most every 50ms, or never (OS flushing only)")
    # Hierarchical cascades + adaptive control (ADR-020).
    ap.add_argument("--tenants", type=int, default=0,
                    help="enable hierarchical cascades (ADR-020): tenant "
                         "capacity (power of two >= 2; 0 = off). Every "
                         "decision then evaluates key -> tenant -> "
                         "global scopes in the same launch; tenant ids "
                         "derive on the card from the key->tenant map "
                         "(protocol unchanged)")
    ap.add_argument("--tenant-map", type=int, default=1024,
                    help="key->tenant assignment map capacity (power of "
                         "two)")
    ap.add_argument("--global-limit", type=int, default=0,
                    help="global-scope limit, requests per window across "
                         "ALL keys (0 = unlimited)")
    ap.add_argument("--default-tenant-limit", type=int, default=0,
                    help="per-window limit of the default tenant (every "
                         "unassigned key; 0 = unlimited)")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME=LIMIT[:WEIGHT[:FLOOR]]",
                    help="register a tenant at boot (repeatable); "
                         "LIMIT 0 = unlimited")
    ap.add_argument("--assign", action="append", default=[],
                    metavar="KEY=TENANT",
                    help="assign a key to a tenant at boot (repeatable)")
    ap.add_argument("--controller", action="store_true",
                    help="run the AIMD adaptive controller (ADR-020): a "
                         "background loop that tightens/relaxes EFFECTIVE "
                         "scope limits off the per-tenant in-window mass "
                         "between each scope's floor and its configured "
                         "ceiling; its gauges show on METRICS; needs "
                         "--tenants > 0")
    ap.add_argument("--controller-interval", type=float, default=1.0,
                    help="seconds between AIMD controller ticks")
    # Client-embedded quota leases (the JAX binary's flags and defaults).
    ap.add_argument("--leases", action="store_true",
                    help="grant client-embedded quota leases: clients "
                         "holding a lease answer allow/allow_n for that "
                         "key from a local token budget at memory speed; "
                         "the budget is debited upfront through the "
                         "normal decide path, so the global bound fails "
                         "toward false-denies, never over-admission. "
                         "Revocations push over the granting connection; "
                         "the lease TTL bounds a holder that lost the "
                         "push")
    ap.add_argument("--lease-ttl", type=float, default=2.0,
                    help="lease lifetime seconds (renewals extend it); "
                         "ALSO the staleness bound on a partitioned "
                         "holder that missed its revocation push")
    ap.add_argument("--lease-budget", type=int, default=256,
                    help="tokens per grant when the client does not ask "
                         "for a specific amount")
    ap.add_argument("--lease-max", type=int, default=4096,
                    help="active-grant capacity; grants beyond it are "
                         "refused and clients stay on the wire path")
    ap.add_argument("--lease-require-hot", action="store_true",
                    help="only lease keys currently in the heavy-hitter "
                         "side table's top-k (needs --hh-slots): cold "
                         "keys stay on the wire")
    ap.add_argument("--lease-port", type=int, default=None,
                    help="--native only: serve lease frames on this "
                         "sidecar port (0 = ephemeral, printed in the "
                         "serving line). The C++ front door has no lease "
                         "lane; the asyncio door serves lease frames on "
                         "its main port")
    # Cross-pod DCN exchange (parallel/dcn.py over serving/dcn_peer.py).
    ap.add_argument("--dcn-peer", action="append", default=[],
                    metavar="HOST:PORT",
                    help="push completed slabs / debt deltas to this peer "
                         "server (repeatable); both front doors can "
                         "receive (asyncio and --native)")
    ap.add_argument("--dcn-interval", type=float, default=1.0,
                    help="seconds between DCN export+push cycles")
    ap.add_argument("--dcn-listen", action="store_true",
                    help="accept T_DCN_PUSH frames from peers (implied by "
                         "--dcn-peer); off by default so plain deployments "
                         "keep the 1 MiB per-frame bound")
    ap.add_argument("--dcn-max-transfers", type=int, default=4,
                    help="native door: connections allowed to hold a "
                         "DCN-slab-sized receive buffer concurrently "
                         "(size to your peer count; refused peers get a "
                         "typed error and re-push next cycle)")
    ap.add_argument("--dcn-secret", default=None,
                    help="shared secret HMAC-gating T_DCN_PUSH frames "
                         "(both sides must set it; prefer the "
                         "RATELIMITER_TPU_DCN_SECRET env var to keep it "
                         "off argv). Without it, anyone with reach to the "
                         "serving port can inject counter mass: firewall "
                         "the port or set a secret")
    # The fleet: this server owns a set of keyspace hash buckets;
    # mis-routed rows forward to their owner; peers heartbeat over the
    # DCN channel; a dead peer's ranges fail over to its successor.
    ap.add_argument("--fleet-config", default=None, metavar="PATH",
                    help="join a fleet: JSON ownership map (buckets, "
                         "epoch, hosts with id/host/port/ranges/"
                         "successor/snapshot_dir). Implies accepting "
                         "DCN pushes (fleet announces ride that "
                         "channel); needs a sketch-family backend and "
                         "--fleet-self")
    ap.add_argument("--fleet-self", default=None, metavar="ID",
                    help="this server's host id inside --fleet-config")
    ap.add_argument("--fleet-no-forward", action="store_true",
                    help="answer mis-routed frames with the typed "
                         "E_NOT_OWNER redirect instead of proxying them "
                         "to the owner (routing becomes entirely the "
                         "client's job; dumb LBs will see errors)")
    ap.add_argument("--fleet-rejoin", default="auto",
                    choices=["auto", "manual"],
                    help="when a previously-dead peer announces again, "
                         "hand its adopted ranges back automatically "
                         "via the handoff protocol (snapshot -> restore "
                         "on the returning host -> epoch bump); "
                         "'manual' leaves them to the operator")
    ap.add_argument("--fleet-heartbeat", type=float, default=0.5,
                    help="seconds between fleet announce pushes")
    ap.add_argument("--fleet-dead-after", type=float, default=2.0,
                    help="declare a peer dead after this many seconds "
                         "of announce silence (failover trigger)")
    ap.add_argument("--fleet-boot-grace", type=float, default=None,
                    help="seconds from start before a NEVER-seen peer "
                         "can be declared dead (default max(3 x "
                         "dead-after, 15): members still building at "
                         "boot are not dead)")
    ap.add_argument("--fleet-forward-deadline", type=float, default=1.0,
                    help="per-call deadline (seconds) on forwarded "
                         "frames; rides the wire so the owner sheds "
                         "expired work")
    ap.add_argument("--fleet-forward-queue", type=int, default=128,
                    help="bounded per-peer forward queue (outstanding "
                         "fragments); overflow answers per "
                         "fail-open/closed policy")
    ap.add_argument("--fleet-forward-inflight", type=int, default=2,
                    help="pipelined wire frames in flight per forward "
                         "connection. Small windows coalesce more rows "
                         "per wire frame; raise it on high-RTT links")
    ap.add_argument("--fleet-forward-conns", type=int, default=1,
                    help="pipelined connections per peer; rows pick "
                         "their connection by key hash, so same-key "
                         "send order survives the multi-connection "
                         "link. 1 maximizes window occupancy")
    ap.add_argument("--fleet-forward-coalesce", type=int, default=16384,
                    help="max rows merged into one coalesced forward "
                         "wire frame (capped at 32768 — the coalesced "
                         "REPLY costs ~24 B/row against the 1 MiB wire "
                         "bound)")
    # Load-aware placement (placement/): the fleet rebalancing brain.
    ap.add_argument("--rebalance", action="store_true",
                    help="run the placement rebalancer: a background "
                         "loop that merges every member's per-bucket "
                         "decision load, plans bounded range moves "
                         "toward max/mean balance (hysteresis + "
                         "min-residency cooldown, so ranges never "
                         "flap), and executes its OWN donated moves "
                         "through the migration handoff — paced "
                         "AIMD-style and vetoed by SLO burn / "
                         "false-deny bounds. Needs --fleet-config; "
                         "every member should run it (each executes "
                         "only the moves it donates)")
    ap.add_argument("--rebalance-interval", type=float, default=10.0,
                    help="seconds between rebalance planning cycles "
                         "(vetoes and failed moves back the effective "
                         "interval off multiplicatively)")
    ap.add_argument("--rebalance-max-moves", type=int, default=2,
                    help="range moves budgeted per planning cycle")
    ap.add_argument("--rebalance-trigger", type=float, default=1.4,
                    help="plan only when fleet max/mean decision-load "
                         "imbalance reaches this ratio (hysteresis "
                         "upper band)")
    ap.add_argument("--rebalance-target", type=float, default=1.15,
                    help="plan down toward this imbalance ratio "
                         "(hysteresis lower band; must be below the "
                         "trigger or the fleet flaps)")
    ap.add_argument("--rebalance-min-residency", type=float,
                    default=60.0,
                    help="seconds a moved bucket is frozen before it "
                         "may move again (flap prevention)")
    ap.add_argument("--rebalance-seed", type=int, default=0,
                    help="planner seed, salted into every plan id "
                         "(plans are deterministic: same load view -> "
                         "same plan)")
    ap.add_argument("--grpc-port", type=int, default=None,
                    help="also serve the gRPC contract "
                         "(api/proto/ratelimiter.proto) on this port "
                         "(needs grpcio; the descriptor is committed, so "
                         "no protoc). Decisions share the door's batcher "
                         "(the shard router under --native) with every "
                         "other surface")
    ap.add_argument("--log-level", default="info")
    # Decorator stack (observability/decorators.py).
    ap.add_argument("--circuit-breaker", action="store_true",
                    help="wrap the limiter in CircuitBreakerDecorator "
                         "(trips after --breaker-threshold consecutive "
                         "backend failures; probes after --breaker-cooldown)")
    ap.add_argument("--breaker-threshold", type=int, default=5)
    ap.add_argument("--breaker-cooldown", type=float, default=10.0,
                    help="seconds the breaker stays open before probing")
    ap.add_argument("--log-decisions", action="store_true",
                    help="wrap in LoggingDecorator (decisions at DEBUG, "
                         "fail-open at WARNING)")
    ap.add_argument("--log-redact-keys", action="store_true",
                    help="with --log-decisions: log key#<hex> tokens "
                         "(ops.hashing.key_token) instead of raw keys")
    ap.add_argument("--trace", action="store_true",
                    help="wrap in TracingDecorator (torch.profiler "
                         "record_function ranges around every dispatch)")
    ap.add_argument("--no-metrics", action="store_true",
                    help="skip the MetricsDecorator (on by default)")
    # Flight recorder (observability/tracing.py).
    ap.add_argument("--flight-recorder", action="store_true",
                    help="turn on the flight recorder: per-thread ring "
                         "buffers of per-stage spans stamped on the "
                         "serving hot path at clock-read cost, shown as "
                         "the rate_limiter_stage_seconds histograms on "
                         "METRICS. Off by default = zero overhead")
    ap.add_argument("--flight-recorder-capacity", type=int, default=8192,
                    help="span ring capacity PER THREAD (records; "
                         "rounded up to a power of two). At 32 B/record "
                         "the default is 256 KiB per serving thread")
    # Control-plane event journal (observability/events.py).
    ap.add_argument("--no-event-journal", action="store_true",
                    help="disable the control-plane event journal. ON by "
                         "default: controller moves and policy/reset "
                         "mutations are recorded in a bounded in-memory "
                         "ring (never the decide path)")
    ap.add_argument("--event-journal-capacity", type=int, default=4096,
                    help="events held in the journal ring (oldest "
                         "evicted; ~300 B/event)")
    ap.add_argument("--event-journal-dir", default=None, metavar="DIR",
                    help="also spill journal events to append-only "
                         "JSONL segments in DIR (bounded rotation) and "
                         "replay the on-disk tail into the ring at "
                         "startup")
    # HTTP gateway (serving/http_gateway.py).
    ap.add_argument("--http-port", type=int, default=None,
                    help="also serve the HTTP gateway (429 + X-RateLimit-* "
                         "headers, /healthz, /metrics) on this port; HTTP "
                         "decisions share the micro-batcher with binary "
                         "traffic")
    ap.add_argument("--http-reset", action="store_true",
                    help="expose POST /v1/reset on the HTTP gateway "
                         "(OFF by default: reset is a quota-erase lever "
                         "on a curl-able surface)")
    ap.add_argument("--http-reset-token", default=None,
                    help="bearer token required by /v1/reset (implies "
                         "--http-reset); Authorization header only — "
                         "query-string tokens are never accepted")
    ap.add_argument("--http-policy", action="store_true",
                    help="expose the tiered-override endpoint "
                         "(GET/POST/PUT/DELETE /v1/policy) on the HTTP "
                         "gateway (OFF by default: overrides are a "
                         "quota-GRANT lever on a curl-able surface)")
    ap.add_argument("--http-policy-token", default=None,
                    help="bearer token required by /v1/policy (implies "
                         "--http-policy); Authorization header only")
    ap.add_argument("--http-snapshot-token", default=None,
                    help="bearer token required by POST /v1/snapshot on "
                         "the HTTP gateway (the trigger is wired "
                         "whenever --snapshot-dir is set; without a "
                         "token it is open). Authorization header only")
    ap.add_argument("--http-tenants", action="store_true",
                    help="expose tenant management (GET/POST/PUT/DELETE "
                         "/v1/tenants) on the HTTP gateway (OFF by "
                         "default: a quota lever in both directions on "
                         "a curl-able surface)")
    ap.add_argument("--http-tenants-token", default=None,
                    help="bearer token required by /v1/tenants (implies "
                         "--http-tenants); Authorization header only")
    ap.add_argument("--http-migrate-token", default=None,
                    help="enable POST /v1/fleet/migrate (live range "
                         "migration) on the HTTP gateway, gated by this "
                         "bearer token. No token, no endpoint — an "
                         "ownership-move lever is never open")
    ap.add_argument("--http-rebalance-token", default=None,
                    help="enable GET/POST /v1/fleet/rebalance (the "
                         "placement rebalancer's operator surface: "
                         "status / dry-run / apply / abort) on the HTTP "
                         "gateway, gated by this bearer token. No "
                         "token, no endpoint — same posture as "
                         "/v1/fleet/migrate")
    ap.add_argument("--debug-trace", action="store_true",
                    help="expose GET /debug/trace (Chrome-trace dump of "
                         "the flight recorder's recent spans), "
                         "/debug/events and /debug/profile (on-demand "
                         "torch.profiler capture) on the HTTP gateway. "
                         "OFF by default: traces reveal key traffic "
                         "timing — gate like /v1/policy")
    ap.add_argument("--debug-token", default=None,
                    help="bearer token required by the /debug endpoints "
                         "(implies --debug-trace); Authorization header "
                         "only, like every other token")
    # Live accuracy observatory (observability/audit.py, slo.py).
    ap.add_argument("--audit", action="store_true",
                    help="turn on the live accuracy observatory: a "
                         "deterministic hash-sampled fraction of live "
                         "decisions is mirrored into an exact shadow "
                         "oracle off the hot path; live false-deny/"
                         "false-allow rates with Wilson bounds land on "
                         "/metrics, /healthz, and GET /debug/audit, plus "
                         "the admission-SLO burn-rate block. Needs a "
                         "sketch-family backend. Off by default = "
                         "byte-identical hot path")
    ap.add_argument("--audit-sample", type=int, default=64,
                    help="audit 1 in N of the keyspace (hash-coherent: "
                         "a key is always or never audited, so its "
                         "windows stay whole; 1 audits everything)")
    ap.add_argument("--audit-token", default=None,
                    help="bearer token required by GET /debug/audit "
                         "(Authorization header only; without it the "
                         "endpoint is open whenever --audit is set)")
    ap.add_argument("--audit-twin", action="store_true",
                    help="also run the collision-free CMS twin online "
                         "(on the serving limiter's device), separating "
                         "pure-CMS collision error from semantic error "
                         "in the live stream; costs a twin step per "
                         "audited window, so it is off by default")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    cfg = Config(
        algorithm=Algorithm(args.algorithm), limit=args.limit,
        window=args.window, fail_open=args.fail_open,
        sketch=SketchParams(
            depth=args.sketch_depth, width=args.sketch_width, sub_windows=args.sub_windows,
            conservative_update=not args.no_conservative_update,
            hh_slots=args.hh_slots),
        dense=DenseParams(capacity=args.dense_capacity),
        persistence=PersistenceSpec(
            dir=args.snapshot_dir,
            snapshot_interval=args.snapshot_interval,
            snapshot_after_mutations=args.snapshot_after_mutations,
            retain=args.snapshot_retain,
            wal_fsync=args.wal_fsync),
        hierarchy=HierarchySpec(
            tenants=args.tenants, map_capacity=args.tenant_map,
            global_limit=args.global_limit,
            default_tenant_limit=args.default_tenant_limit),
        mesh=MeshSpec(devices=args.mesh_devices,
                      router=args.router,
                      bin_headroom=args.bin_headroom,
                      quarantine=args.quarantine,
                      slice_deadline=args.slice_deadline_ms * 1e-3,
                      probe_interval=args.probe_interval,
                      failure_threshold=args.quarantine_threshold))
    if cfg.hierarchy.enabled and args.backend not in ("sketch", "mesh"):
        raise SystemExit("--tenants needs a sketch-family backend "
                         "(--backend sketch or --backend mesh)")
    if args.backend == "dense" and args.max_batch > ADMIT_CAPACITY:
        raise SystemExit(f"--max-batch {args.max_batch} with --backend "
                         f"dense: the card decides at most "
                         f"{ADMIT_CAPACITY} requests a dense launch")
    if args.controller and not cfg.hierarchy.enabled:
        raise SystemExit("--controller needs --tenants > 0")
    if (args.tenant or args.assign) and not cfg.hierarchy.enabled:
        raise SystemExit("--tenant/--assign need --tenants > 0")
    if args.mesh_devices is not None and args.backend != "mesh":
        raise SystemExit("--mesh-devices needs --backend mesh")
    if args.rebalance and not args.fleet_config:
        raise SystemExit("--rebalance needs --fleet-config (the "
                         "placement brain moves fleet ranges)")
    if args.rebalance and args.rebalance_target >= args.rebalance_trigger:
        raise SystemExit("--rebalance-target must be below "
                         "--rebalance-trigger (the hysteresis band "
                         "prevents flapping)")
    if args.quarantine and args.backend != "mesh":
        raise SystemExit("--quarantine needs --backend mesh (failure "
                         "domains are per device slice)")
    if args.router != "host" and args.backend != "mesh":
        raise SystemExit("--router needs --backend mesh (it selects how "
                         "mixed frames reach the device slices)")
    if args.router == "collective" and args.quarantine:
        raise SystemExit(
            "--router collective is incompatible with --quarantine: a "
            "collective dispatch is ONE mesh-wide shard_map execution, "
            "so a single slice's fault has whole-mesh blast radius and "
            "per-slice failure domains cannot contain it (ADR-024). "
            "Use --router host for quarantined deployments.")
    if args.backend == "mesh" and args.shards > 1:
        raise SystemExit("--backend mesh routes one dispatch shard per "
                         "device; use --mesh-devices, not --shards")
    if args.audit and args.backend not in ("sketch", "mesh"):
        raise SystemExit("--audit needs a sketch-family backend "
                         "(exact/dense decisions are already exact — "
                         "there is nothing to audit)")
    if args.shards > 1 and not args.native:
        raise SystemExit("--shards needs --native (the asyncio front door "
                         "has one dispatcher)")
    if args.lease_require_hot and not args.leases:
        raise SystemExit("--lease-require-hot needs --leases")
    if args.lease_require_hot and args.hh_slots <= 0:
        raise SystemExit("--lease-require-hot needs --hh-slots > 0 "
                         "(hot-key nomination reads the heavy-hitter "
                         "side table)")
    if args.lease_port is not None and not args.native:
        raise SystemExit("--lease-port is the native door's lease "
                         "sidecar; the asyncio door serves lease "
                         "frames on its main port")
    if cfg.hierarchy.enabled and args.max_batch > ADMIT_CAPACITY:
        raise SystemExit(f"--max-batch {args.max_batch} with --tenants: the "
                         f"cascade decides at most {ADMIT_CAPACITY} requests "
                         f"a launch")
    if args.dcn_peer:
        from ratelimiter_tpu_torch.serving.dcn_peer import parse_peer

        if args.backend not in ("sketch", "mesh"):
            # A mesh's slices are plain sketch limiters, each exporting
            # its own slabs or deltas (one pusher a slice).
            raise SystemExit("--dcn-peer needs a sketch-family backend "
                             "(--backend sketch or --backend mesh)")
        try:
            for spec in args.dcn_peer:
                parse_peer(spec)
        except ValueError as exc:
            raise SystemExit(f"--dcn-peer: {exc}") from None
    if args.fleet_config:
        if args.backend not in ("sketch", "mesh"):
            raise SystemExit("--fleet-config needs a sketch-family "
                             "backend (fleet routing hashes keys)")
        if not args.fleet_self:
            raise SystemExit("--fleet-config needs --fleet-self "
                             "(this server's host id in the map)")
    if (args.chaos_scenario in ("kill-slice", "slow-slice", "wedge-slice")
            and not args.quarantine):
        raise SystemExit("--chaos-scenario slice faults need "
                         "--quarantine (otherwise nothing contains "
                         "them)")
    return cfg


def dcn_secret(args: argparse.Namespace):
    """``--dcn-secret``, else ``RATELIMITER_TPU_DCN_SECRET``, else None."""
    import os

    return (args.dcn_secret
            or os.environ.get("RATELIMITER_TPU_DCN_SECRET") or None)


def start_pushers(args: argparse.Namespace, limiters) -> list:
    """One started ``DcnPusher`` per dispatch unit under ``limiters`` (the
    native door's shards, a mesh's slices): keys hash-route across them,
    so exporting one would hide the others' traffic from every peer.
    None without ``--dcn-peer``."""
    if not args.dcn_peer:
        return []
    from ratelimiter_tpu_torch.observability.decorators import undecorated
    from ratelimiter_tpu_torch.serving.dcn_peer import DcnPusher, parse_peer

    peers = [parse_peer(spec) for spec in args.dcn_peer]
    pushers = [DcnPusher(undecorated(u), peers, interval=args.dcn_interval,
                         secret=dcn_secret(args))
               for u in _units(limiters)]
    for pu in pushers:
        pu.start()
    return pushers


def max_window(args: argparse.Namespace, cfg: Config) -> int:
    """The most rows the batcher merges into one hashed window: twice
    ``--max-batch``, and with the cascade no more than one launch takes
    (``sketch_cuda.ADMIT_CAPACITY``)."""
    if cfg.hierarchy.enabled:
        return min(2 * args.max_batch, ADMIT_CAPACITY)
    return 2 * args.max_batch


def boot_tenants(hier, args: argparse.Namespace) -> None:
    """Apply --tenant NAME=LIMIT[:WEIGHT[:FLOOR]] and --assign
    KEY=TENANT boot flags (after recovery, so operator flags win over a
    snapshot's registry for the names they touch)."""
    for spec in args.tenant:
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise SystemExit(f"bad --tenant {spec!r}; expected "
                             f"NAME=LIMIT[:WEIGHT[:FLOOR]]")
        parts = rest.split(":")
        try:
            limit = int(parts[0]) or None
            weight = int(parts[1]) if len(parts) > 1 and parts[1] else 1
            floor = (int(parts[2])
                     if len(parts) > 2 and parts[2] else None)
        except ValueError:
            raise SystemExit(f"bad --tenant {spec!r}; expected "
                             f"NAME=LIMIT[:WEIGHT[:FLOOR]]") from None
        hier.set_tenant(name, limit, weight=weight, floor=floor)
    for spec in args.assign:
        key, _, tenant = spec.partition("=")
        if not key or not tenant:
            raise SystemExit(f"bad --assign {spec!r}; expected "
                             f"KEY=TENANT")
        hier.assign_tenant(key, tenant)


def setup_hierarchy(args: argparse.Namespace, cfg: Config, units, *,
                    slo_tracker=None, auditor=None, fleet_membership=None):
    """Mount the cascade's management surface over the door's dispatch
    units (``HierarchyFanout``; the port's door has one), apply the boot
    flags, and build (not start) the AIMD controller when asked, its
    gauges in the door's registry, reading the SLO tracker's and the
    auditor's statuses when they run (``--audit``). Returns ``(hier,
    controller)``, (None, None) when the hierarchy is off. In a fleet the
    effective limits gossip on every announce (``fleet_membership``:
    members adopt the newest revision) and the controller's moves are
    announced at once."""
    if not cfg.hierarchy.enabled:
        return None, None
    from ratelimiter_tpu_torch.hierarchy import AIMDController, HierarchyFanout
    from ratelimiter_tpu_torch.observability import metrics

    hier = HierarchyFanout(list(units))
    boot_tenants(hier, args)
    if fleet_membership is not None:
        fleet_membership.hier_payload_fn = hier.hierarchy_payload
        fleet_membership.hier_apply_fn = hier.apply_hierarchy_payload
    controller = None
    if args.controller:
        controller = AIMDController(
            hier,
            slo_status=(slo_tracker.status if slo_tracker is not None
                        else None),
            audit_status=(auditor.status if auditor is not None
                          else None),
            interval=args.controller_interval,
            publish=((lambda _payload: fleet_membership.announce_once())
                     if fleet_membership is not None else None),
            registry=metrics.DEFAULT)
    return hier, controller


# ------------------------------------------------------ /healthz blocks


def _units(limiters) -> list:
    """The backend dispatch units under ``limiters`` (decorators and the
    persistence wrapper peeled off)."""
    from ratelimiter_tpu_torch.observability.decorators import undecorated

    return [sl for lim in limiters for sl in undecorated(lim).sub_limiters()]


def _envelope_health(limiters) -> dict:
    """Accuracy-envelope fields for /healthz (windowed sketch only): a
    growing overload_periods flags an undersized geometry at the
    operational surface, not just in logs."""
    lims = [lim for lim in _units(limiters) if hasattr(lim, "_period_mass")]
    if not lims:
        return {}
    masses = [lim.in_window_admitted_mass() for lim in lims]
    return {"overload_periods": sum(lim.overload_periods for lim in lims),
            "in_window_admitted_mass": sum(masses),
            "mass_budget": sum(lim.mass_budget for lim in lims),
            "shards_overloaded": sum(
                mass > lim.mass_budget
                for lim, mass in zip(lims, masses)),
            "overload_policy": lims[0].config.sketch.overload_policy}


def _debt_slab_health(limiters) -> dict:
    """Debt-slab occupancy/collision fields for /healthz (token-bucket
    sketch only): occupancy and collision_p report the worst unit, cell
    counts sum. One device read a call — /healthz cadence, never the
    decide path."""
    lims = [lim for lim in _units(limiters)
            if hasattr(lim, "debt_slab_stats")]
    if not lims:
        return {}
    stats = [lim.debt_slab_stats() for lim in lims]
    return {"debt_slab": {
        "occupancy": max(s["occupancy"] for s in stats),
        "collision_p": max(s["collision_p"] for s in stats),
        "nonzero_cells": sum(s["nonzero_cells"] for s in stats),
        "cells": sum(s["cells"] for s in stats),
        "units": len(stats)}}


def _consumers_health(limiters, k: int = 10) -> dict:
    """Top-K consumer block for /healthz (the side table): per-unit
    ``consumer_stats`` merged into one ranking. Consumer identities are
    hash tokens, never raw keys. Empty when no unit runs a side table."""
    units = [(i, lim) for i, lim in enumerate(_units(limiters))
             if getattr(lim, "has_hh", False)]
    if not units:
        return {}
    rows = []
    occupied = slots = mass = 0
    for i, lim in units:
        st = lim.consumer_stats(k=k)
        slots += st["slots"]
        occupied += st["occupied"]
        mass += st.get("tracked_mass", 0)
        for row in st["top"]:
            rows.append({**row, "slice": i})
    rows.sort(key=lambda r: -r["in_window"])
    return {"consumers": {
        "slots": slots,
        "occupied": occupied,
        "tracked_mass": mass,
        "top": rows[:k]}}


def _audit_health() -> dict:
    """Audit envelope for /healthz: the observatory's headline numbers
    (rates, confidence, raw tallies, drop counters); the per-slice
    breakdown lives on GET /debug/audit."""
    from ratelimiter_tpu_torch.observability import audit

    aud = audit.AUDITOR
    if aud is None:
        return {}
    st = aud.status()
    return {"audit": {
        "sample": st["sample"],
        "samples": st["samples"],
        "false_deny_rate": st["false_deny_rate"],
        "false_deny_wilson95": st["false_deny_wilson95"],
        "false_allow_rate": st["false_allow_rate"],
        "false_denies": st["false_denies"],
        "false_allows": st["false_allows"],
        "oracle_allows": st["oracle_allows"],
        "fail_open_samples": st["fail_open_samples"],
        "dropped_decisions": st["dropped_decisions"],
        "oracle_errors": st["oracle_errors"]}}


def _slo_health(slo) -> dict:
    return {"slo": slo.status()} if slo is not None else {}


def _events_health() -> dict:
    from ratelimiter_tpu_torch.observability import events

    j = events.JOURNAL
    return {"events": j.status()} if j is not None else {}


def _quarantine_health(qmgr) -> dict:
    """The mesh's quarantine block (``--quarantine``), as the JAX binary
    gives it; nothing when the subsystem is off."""
    return {"quarantine": qmgr.status()} if qmgr is not None else {}


def _hierarchy_health(hier, controller) -> dict:
    """Cascade block for /healthz: per-scope in-window mass and
    effective/ceiling limits, plus the AIMD controller's move counters
    when it runs."""
    if hier is None:
        return {}
    st = hier.hierarchy_stats()
    if controller is not None:
        st["controller"] = {"ticks": controller.ticks,
                            "tightened": controller.tightened,
                            "relaxed": controller.relaxed,
                            "interval": controller.interval}
    return {"hierarchy": st}


def make_member_info(args: argparse.Namespace, registry=None,
                     fleet_core=None):
    """Member identity as the JAX binary gives it (the fleet id and map
    epoch in a fleet, ``host:port`` and no epoch outside one): the door
    (``native`` with the port's door ABI, or ``asyncio`` with ``py``),
    the /healthz ``member`` block, also
    exported as the ``rate_limiter_member_info`` identity gauge (value 1,
    the block's fields as labels, the member id under ``id``) on
    ``registry`` (the process default when None), refreshed at scrape
    time. Returns ``(info, collect)``: the block's callable and the
    registry hook, which the caller removes at shutdown."""
    from ratelimiter_tpu_torch.observability import metrics

    registry = registry if registry is not None else metrics.DEFAULT
    abi = "py"
    if args.native:
        from ratelimiter_tpu_torch.serving.native_server import _ABI

        abi = str(_ABI)

    def info() -> dict:
        return {"self": args.fleet_self or f"{args.host}:{args.port}",
                "backend": args.backend,
                "algorithm": args.algorithm,
                "door": "native" if args.native else "asyncio", "abi": abi,
                "fleet_epoch": (int(fleet_core.map.epoch)
                                if fleet_core is not None else None)}

    g_info = registry.gauge(
        "rate_limiter_member_info",
        "Identity gauge (value always 1): fleet self id, current "
        "ownership-map epoch, serving door + native ABI, and backend "
        "kind as labels — joins rolled-up series and stitched traces "
        "to a member (ADR-021)")

    def collect() -> None:
        # Clear, then set: a gauge only overwrites the label sets it is
        # told about. "self" cannot be a label keyword (it renders as
        # "id").
        g_info.clear()
        g_info.set(1.0, **{("id" if k == "self" else k):
                           ("-" if v is None else str(v))
                           for k, v in info().items()})

    registry.add_collect_hook(collect)
    return info, collect


def make_threadsafe_decide(batcher, loop):
    """Single-decision bridge from the gateway's worker threads into the
    event loop's micro-batcher: every surface shares device dispatches.
    Trace-aware: a sampled HTTP request's trace id rides into the
    batcher so its coalesced dispatch records under it. Deadline-aware:
    a caller's RELATIVE budget anchors to the local monotonic clock and
    the batcher sheds the work per policy if it expires in the
    coalescing queue."""
    def decide(key: str, n: int, trace_id: int = 0, deadline=None):
        abs_deadline = (time.monotonic() + float(deadline)
                        if deadline is not None else 0.0)
        return asyncio.run_coroutine_threadsafe(
            batcher.submit(key, n, trace_id=trace_id,
                           deadline=abs_deadline),
            loop).result(timeout=30)

    return decide


def make_threadsafe_decide_many(batcher, loop):
    """Bulk bridge for gRPC AllowBatch: the WHOLE frame is submitted to
    the micro-batcher before any result is awaited, so N items coalesce
    into O(1) batched dispatches (they typically land in ONE, together
    with concurrent binary-protocol traffic) instead of N sequential
    submit-wait round-trips. Results return in request order
    (submit_many_nowait preserves it; gather keeps positions)."""
    def decide_many(pairs):
        async def _run():
            futs = batcher.submit_many_nowait(pairs)
            return await asyncio.gather(*futs)

        return asyncio.run_coroutine_threadsafe(
            _run(), loop).result(timeout=30)

    return decide_many


def _setup_leases(args: argparse.Namespace, *, limiter, decide, persist,
                  pushers=(), fleet_core=None):
    """The lease authority (leases/manager.py), as the JAX binary's
    ``_setup_leases`` builds it (in a fleet ``epoch_fn`` and ``owns_fn``
    read the fleet core, so a grant over a range this member no longer
    owns is revoked; ``gossip`` is the first DCN pusher's ``push_lease``
    when the binary runs pushers, so a revocation reaches the peers at
    once): grants, renewals and returns
    debit through ``decide``, the door's shared dispatch path (the
    asyncio door's batcher bridge, the native door's shard router), so a
    lease budget is charged exactly like a wire decision, on the card by
    the step's kernels. With ``--snapshot-dir`` the grant table rides
    every snapshot as the ``leases`` sidecar and is restored after
    recovery. None without ``--leases``."""
    if not args.leases:
        return None
    from ratelimiter_tpu_torch.leases import LeaseManager
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.observability.decorators import undecorated

    epoch_fn = owns_fn = None
    if fleet_core is not None:
        epoch_fn = lambda: int(fleet_core.map.epoch)  # noqa: E731

        def owns_fn(key: str) -> bool:
            h = fleet_core.hash_keys([key])
            return bool(fleet_core.all_local(fleet_core.owners_of_hash(h)))

    mgr = LeaseManager(
        undecorated(limiter), decide=decide,
        ttl=args.lease_ttl, default_budget=args.lease_budget,
        max_leases=args.lease_max,
        require_hot=args.lease_require_hot,
        epoch_fn=epoch_fn, owns_fn=owns_fn,
        gossip=(pushers[0].push_lease if pushers else None),
        registry=metrics.DEFAULT)
    if persist is not None:
        persist.add_sidecar("leases", mgr)
        if persist.restore_sidecar("leases", mgr):
            logging.getLogger("ratelimiter_tpu_torch.leases").info(
                "lease table restored from snapshot sidecar "
                "(restored grants are tombstone-only: their mass "
                "stays charged, holders re-grant)")
    return mgr


def _lease_guarded_policy(lease_mgr, set_fn, delete_fn):
    """Wrap a door's policy callables so an override mutation revokes
    the key's outstanding leases: a holder must not keep answering
    locally under the limit the operator just changed. The wrappers
    keep the wrapped callables' signatures (the gateway and gRPC both
    call them)."""
    if lease_mgr is None:
        return set_fn, delete_fn
    from ratelimiter_tpu_torch.serving import protocol as p

    def set_(key, limit=None, **kw):
        ov = set_fn(key, limit, **kw)
        lease_mgr.revoke_key(key, p.LEASE_REV_POLICY)
        return ov

    def delete_(key):
        existed = delete_fn(key)
        if existed:
            lease_mgr.revoke_key(key, p.LEASE_REV_POLICY)
        return existed

    return set_, delete_


def _lease_guarded_reset(lease_mgr, reset_fn):
    """A reset erases the window counter holding a grant's debited mass,
    so leased tokens spent afterwards would be invisible to the bound:
    the key's leases are revoked alongside (the asyncio door's RESET
    frame does the same)."""
    if lease_mgr is None:
        return reset_fn
    from ratelimiter_tpu_torch.serving import protocol as p

    def reset_(key):
        out = reset_fn(key)
        lease_mgr.revoke_key(key, p.LEASE_REV_MANUAL)
        return out

    return reset_


def _lease_controller_hook(lease_mgr):
    """AIMD tighten -> lease revocation: any tightened scope invalidates
    outstanding budgets sized under the old effective limits. Scope to
    keys is not tracked, so the hook revokes ALL grants: coarse, but in
    the safe direction (lease churn, never over-admission)."""
    if lease_mgr is None:
        return None
    from ratelimiter_tpu_torch.serving import protocol as p

    return lambda _scope: lease_mgr.revoke_all(p.LEASE_REV_CONTROLLER)


def _lease_health(lease_mgr) -> dict:
    return {"leases": lease_mgr.status()} if lease_mgr is not None else {}


def make_grpc(args: argparse.Namespace, limiter, *, decide, decide_many,
              reset, policy, decisions_total, hier):
    """The gRPC server as the JAX binary builds it beside either door:
    decisions through the door's ``decide``/``decide_many``, the
    lease-guarded reset and policy levers, the tenant RPCs over the
    hierarchy when it runs."""
    from ratelimiter_tpu_torch.serving.grpc_server import GrpcRateLimitServer

    return GrpcRateLimitServer(
        decide, reset, host=args.host, port=args.grpc_port,
        decisions_total=decisions_total, decide_many=decide_many,
        policy=policy, default_limit=lambda: limiter.config.limit,
        tenants=hier)


def setup_audit(args: argparse.Namespace, cfg: Config, limiter,
                n_slices=None):
    """``--audit``: the process-wide shadow auditor (its twin, under
    ``--audit-twin``, on the serving limiter's device) following the
    served limiter's live limit and window, and the SLO burn tracker,
    both exporting their gauges on the default registry; ``n_slices``
    (default the limiter's dispatch units) attributes decisions to mesh
    slices. Returns ``(auditor, slo_tracker)``, (None, None) without
    ``--audit``."""
    if not args.audit:
        return None, None
    from ratelimiter_tpu_torch.observability import audit, metrics
    from ratelimiter_tpu_torch.observability.slo import SloBurnTracker

    auditor = audit.enable(cfg, sample=args.audit_sample,
                           n_slices=(n_slices if n_slices is not None
                                     else len(_units([limiter]))),
                           include_twin=args.audit_twin,
                           registry=metrics.DEFAULT,
                           live_config=lambda: limiter.config,
                           device=args.device)
    slo_tracker = SloBurnTracker(metrics.DEFAULT)
    slo_tracker.attach()
    return auditor, slo_tracker


def make_audit_status(auditor, slo_tracker, limiters):
    """GET /debug/audit payload: the auditor's rates, confidence and
    attribution, the top-K consumers and the SLO burn block."""
    def status() -> dict:
        out = auditor.status() if auditor is not None else {}
        out.update(_consumers_health(limiters))
        out.update(_slo_health(slo_tracker))
        return out

    return status


def make_gateway(args: argparse.Namespace, limiter, server, *, decide,
                 levers, member_info, persist=None, hier=None,
                 controller=None, auditor=None, slo_tracker=None,
                 lease_mgr=None, qmgr=None, fleet=None):
    """The HTTP gateway as the JAX binary's asyncio door builds it: its
    decisions through ``decide`` (the door's batcher bridge), the
    lease-guarded ``levers`` (reset, policy set, policy delete), /healthz
    from the blocks above, the levers and debug routes behind their
    flags."""
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.serving.http_gateway import HttpGateway

    def health() -> dict:
        return {"serving": True,
                "decisions_total": server.batcher.decisions_total,
                "policy_overrides": limiter.override_count(),
                "transport": server.transport_stats(),
                "member": member_info(),
                **_envelope_health([limiter]),
                **_debt_slab_health([limiter]),
                **_consumers_health([limiter]),
                **_audit_health(),
                **_slo_health(slo_tracker),
                **_hierarchy_health(hier, controller),
                **_lease_health(lease_mgr),
                **_events_health(),
                **_quarantine_health(qmgr),
                **_fleet_health(fleet),
                **_placement_health(fleet),
                **(persist.status() if persist is not None else {})}

    reset, policy_set, policy_delete = levers
    control = make_control_plane(args, fleet, health, auditor, slo_tracker)
    return HttpGateway(
        decide, reset,
        host=args.host, port=args.http_port,
        metrics_render=metrics.DEFAULT.render,
        health=health,
        enable_reset=bool(args.http_reset or args.http_reset_token),
        reset_token=args.http_reset_token,
        policy_set=policy_set,
        policy_get=limiter.get_override,
        policy_delete=policy_delete,
        enable_policy=bool(args.http_policy or args.http_policy_token),
        policy_token=args.http_policy_token,
        snapshot=(persist.snapshot_now if persist is not None else None),
        snapshot_token=args.http_snapshot_token,
        enable_debug=bool(args.debug_trace or args.debug_token),
        debug_token=args.debug_token,
        audit_status=(make_audit_status(auditor, slo_tracker, [limiter])
                      if args.audit else None),
        audit_token=args.audit_token,
        tenants=hier,
        enable_tenants=bool(args.http_tenants or args.http_tenants_token),
        tenants_token=args.http_tenants_token,
        fleet_migrate=make_fleet_migrate(args, fleet),
        migrate_token=args.http_migrate_token, **control)


# ------------------------------------------------------------- the fleet


def setup_fleet(args: argparse.Namespace, cfg: Config, limiter, persist):
    """The fleet member's routing core and membership, as the JAX binary
    builds them (None without ``--fleet-config``): the map from
    ``--fleet-config``, the ``--fleet-*`` knobs, the placement load slab
    on every member (observation only), the failover adopter, the
    handoff restorer and the rejoin absorber. Every standby unit is
    built on the serving limiter's device (``fleet/handoff.py``). Built
    before either door; the membership starts once serving does."""
    if not args.fleet_config:
        return None
    from ratelimiter_tpu_torch.fleet import (
        FleetCore,
        FleetMap,
        FleetMembership,
    )
    from ratelimiter_tpu_torch.fleet.handoff import build_standby
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.observability.decorators import undecorated
    from ratelimiter_tpu_torch.placement import LoadSlab

    log = logging.getLogger("ratelimiter_tpu_torch.fleet")
    device = str(getattr(undecorated(limiter), "device", None)
                 or args.device)
    fleet_map = FleetMap.load(args.fleet_config)
    core = FleetCore(
        fleet_map, args.fleet_self, prefix=cfg.prefix,
        forward=not args.fleet_no_forward,
        forward_deadline=args.fleet_forward_deadline,
        forward_queue=args.fleet_forward_queue,
        forward_inflight=args.fleet_forward_inflight,
        forward_conns=args.fleet_forward_conns,
        forward_coalesce=args.fleet_forward_coalesce,
        registry=metrics.DEFAULT)
    # On every member, not only a planning one: a planner elsewhere
    # reads this member's per-bucket load. Decisions are untouched.
    core.load_slab = LoadSlab(fleet_map.buckets, registry=metrics.DEFAULT)

    def adopt(dead):
        """Failover standby: restored from the dead host's newest
        snapshot, WAL suffix and aux units; fresh state (under-counting
        only) when the restore fails."""
        if dead.snapshot_dir:
            try:
                unit = build_standby(cfg, dead.snapshot_dir, device=device)
                log.warning("fleet: adopted %s's ranges from %s on %s",
                            dead.id, dead.snapshot_dir, device)
                return unit
            except Exception:
                log.exception("fleet: restore of %s's snapshot dir %s "
                              "failed; adopting with fresh state",
                              dead.id, dead.snapshot_dir)
        return create_limiter(cfg, backend="sketch", device=device)

    def handoff_restore(payload):
        """Incoming handoff (migration, departure, rejoin): the moved
        ranges' state from the sender's snapshot dir; resets replay only
        where the moved ranges own the key."""
        dir_ = payload.get("snapshot_dir")
        if not dir_:
            return None
        origin = payload.get("origin")
        owns = None
        if origin:
            ranges = [tuple(r) for r in payload.get("ranges", [])]
            buckets = core.map.buckets

            def owns(key: str) -> bool:
                b = int(core.hash_keys([key])[0] % buckets)
                return any(lo <= b < hi for lo, hi in ranges)

        return build_standby(cfg, dir_, origin=origin, owns=owns,
                             device=device)

    def absorb(unit):
        """Rejoin give-back: fold the returned ranges into the serving
        limiter (conservative union) so they run the pipelined path.
        Only the single-unit sketch backend: a mesh or a multi-shard
        door keeps the adopted mount."""
        if args.backend != "sketch" or (args.native and args.shards > 1):
            return False
        from ratelimiter_tpu_torch.parallel import reshard

        _, arrays, extra = unit.capture_state()
        reshard.merge_into_limiter(undecorated(limiter), arrays, extra)
        return True

    membership = FleetMembership(
        core, heartbeat=args.fleet_heartbeat,
        dead_after=args.fleet_dead_after,
        boot_grace=args.fleet_boot_grace, adopt_fn=adopt,
        snapshot_fn=persist.snapshot_now if persist is not None else None,
        handoff_restore_fn=handoff_restore,
        on_adopt=((lambda origin, unit, ranges:
                   persist.add_aux_unit(origin, unit, ranges))
                  if persist is not None else None),
        on_release=(persist.remove_aux_unit
                    if persist is not None else None),
        absorb_fn=absorb, auto_rejoin=(args.fleet_rejoin == "auto"),
        secret=dcn_secret(args), registry=metrics.DEFAULT)
    if not args.native and args.inflight < 2:
        # The fleet-merge side pool exists only on the pipelined path.
        log.warning("fleet on the asyncio door with --inflight 1: "
                    "forwarded frames block the single dispatch "
                    "executor; use --inflight >= 2 for mis-routed "
                    "traffic")
    # ``rebalance``: the placement controller, built with the gateway
    # (make_control_plane) when this member runs one.
    return SimpleNamespace(core=core, membership=membership, device=device,
                           rebalance=None)


def _fleet_health(fleet) -> dict:
    """The /healthz fleet block (the core's and the membership's
    status), plus ``adopted_device``: where an adopted range's standby
    unit lives (None while no range is adopted)."""
    if fleet is None:
        return {}
    unit = fleet.core.adopted_unit
    return {"fleet": {**fleet.core.status(), **fleet.membership.status(),
                      "adopted_device": (str(unit.device)
                                         if unit is not None else None)}}


def _placement_health(fleet) -> dict:
    """The /healthz placement block: this member's load slab, and the
    controller's status as ``rebalance`` when the rebalancer runs here."""
    if fleet is None or fleet.core.load_slab is None:
        return {}
    blk = fleet.core.load_slab.snapshot()
    if fleet.rebalance is not None:
        blk["rebalance"] = fleet.rebalance.status()
    return {"placement": blk}


def _make_tower(args: argparse.Namespace, fleet, health):
    """The fleet's control tower: rollup, trace and event fan-out over
    the peers' declared HTTP gateways, this member's own payloads from
    ``health`` and the process's recorder and journal. None off a fleet
    or without a local gateway."""
    if fleet is None or args.http_port is None:
        return None
    from ratelimiter_tpu_torch.fleet.tower import ControlTower

    me = fleet.core.map.host(args.fleet_self)
    if me.http != args.http_port:
        logging.getLogger("ratelimiter_tpu_torch.fleet").warning(
            "fleet map entry %r declares http=%s but this server "
            "serves HTTP on %s — peers' fleet rollups/trace "
            "stitching will miss this member until the map's "
            "\"http\" field matches", args.fleet_self, me.http,
            args.http_port)
    return ControlTower(fleet.core, fleet.membership, self_health=health)


def _make_rebalance(args: argparse.Namespace, fleet, tower, auditor,
                    slo_tracker):
    """The placement controller and its gateway hook, or (None, None):
    it exists on a fleet member whose operator asked for it (the
    ``--rebalance`` loop, or ``--http-rebalance-token`` alone for a
    manual dry-run/apply surface). Peers' load comes through the tower's
    /healthz fetch; the observatory's SLO burn and false-deny bound veto
    its moves. Sets ``fleet.rebalance``."""
    if fleet is None or fleet.core.load_slab is None:
        return None, None
    if not (args.rebalance or args.http_rebalance_token):
        return None, None
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.placement import (
        PlannerKnobs,
        RebalanceController,
    )

    if tower is None and len(fleet.core.map.hosts) > 1:
        logging.getLogger("ratelimiter_tpu_torch.placement").warning(
            "rebalance on a multi-member fleet without --http-port: "
            "peers' load blocks are unreachable, so every cycle "
            "skips on load-gap (wire an HTTP gateway and declare "
            "\"http\" ports in the fleet map)")
    ctl = RebalanceController(
        fleet.core, fleet.membership, fleet.core.load_slab,
        interval=args.rebalance_interval,
        knobs=PlannerKnobs(
            max_moves=args.rebalance_max_moves,
            trigger_ratio=args.rebalance_trigger,
            target_ratio=args.rebalance_target,
            min_residency_s=args.rebalance_min_residency),
        seed=args.rebalance_seed,
        fetch_peer_health=((lambda: tower._fetch_all("/healthz", None))
                           if tower is not None else None),
        slo_status=slo_tracker.status if slo_tracker is not None else None,
        audit_status=auditor.status if auditor is not None else None,
        registry=metrics.DEFAULT)
    fleet.rebalance = ctl

    def hook(action: str) -> dict:
        if action == "status":
            return {"ok": True, "auto": bool(args.rebalance),
                    **ctl.status()}
        if action == "dry-run":
            return ctl.dry_run()
        if action == "apply":
            return ctl.apply()
        if action == "abort":
            return ctl.abort()
        return {"ok": False, "error": f"unknown action {action!r}"}

    return ctl, hook


def make_control_plane(args: argparse.Namespace, fleet, health, auditor,
                       slo_tracker) -> dict:
    """The gateway's fleet hooks, as the JAX binary wires them on either
    door: the tower's ``fleet_status``/``fleet_trace``/``fleet_events``
    and the placement controller's ``fleet_rebalance`` with its token.
    Every hook is None off a fleet; the controller starts once serving
    does (``--rebalance``) and stops before the departure."""
    tower = _make_tower(args, fleet, health)
    _, rebalance = _make_rebalance(args, fleet, tower, auditor,
                                   slo_tracker)
    return {"fleet_status": tower.fleet_status if tower else None,
            "fleet_trace": tower.fleet_trace if tower else None,
            "fleet_events": tower.fleet_events if tower else None,
            "fleet_rebalance": rebalance,
            "rebalance_token": args.http_rebalance_token}


def _start_rebalance(args: argparse.Namespace, fleet) -> None:
    if fleet is not None and fleet.rebalance is not None and args.rebalance:
        fleet.rebalance.start()


def _stop_rebalance(fleet) -> None:
    # Before the departure: a mid-shutdown plan must not race the
    # departure handoff for the same ranges.
    if fleet is not None and fleet.rebalance is not None:
        fleet.rebalance.stop()


def make_fleet_migrate(args: argparse.Namespace, fleet):
    """POST /v1/fleet/migrate's hook, bound to ``migrate_ranges`` and
    reporting the epoch after the move; None unless this is a fleet
    member with ``--http-migrate-token``."""
    if fleet is None or not args.http_migrate_token:
        return None

    def migrate(ranges, to, wait):
        ok = fleet.membership.migrate_ranges(ranges, to, wait=wait)
        return {"ok": bool(ok), "epoch": int(fleet.core.map.epoch),
                "to": to, "ranges": [list(r) for r in ranges]}

    return migrate


def setup_chaos(args: argparse.Namespace):
    """Install the chaos injector (``--chaos-seed``) and return the
    callable that arms ``--chaos-scenario`` once serving starts, after
    ``--chaos-after`` seconds (so the build never eats the delay); None
    without a scenario."""
    if not args.chaos_scenario:
        return None
    import threading

    from ratelimiter_tpu_torch import chaos

    inj = chaos.install(seed=args.chaos_seed)

    def arm() -> None:
        chaos.scenario(args.chaos_scenario, inj,
                       slice_idx=args.chaos_slice,
                       seconds=args.chaos_seconds)
        logging.getLogger("ratelimiter_tpu_torch.serving").warning(
            "chaos scenario %s armed (slice %d, seed %d)",
            args.chaos_scenario, args.chaos_slice, args.chaos_seed)

    def start() -> None:
        if args.chaos_after > 0:
            # Daemon: a server stopped before the delay must not wait
            # on it.
            t = threading.Timer(args.chaos_after, arm)
            t.daemon = True
            t.start()
        else:
            arm()

    return start


async def _depart(args: argparse.Namespace, fleet) -> None:
    """Departure before the door drains: hand this member's ranges to
    the successor so a rolling restart leaves no ownership hole; off the
    loop, which keeps receiving the flip announce the wait needs."""
    if fleet is None:
        return
    await asyncio.get_running_loop().run_in_executor(
        None, lambda: fleet.membership.depart(
            wait=max(2.0, 4 * args.fleet_heartbeat)))
    fleet.membership.stop()


def build_limiter_stack(limiter, args, registry=None, shard: int = 0):
    """Apply the configured decorator stack, innermost first (the JAX
    binary's order): Tracing (annotates the real device dispatch),
    CircuitBreaker (judges backend health from real calls), Metrics
    (observes everything, including breaker short-circuits, into
    ``registry``, the process default when None; ``shard`` labels its
    gauges, so dispatch shards report distinct series), Logging
    (outermost, sees final outcomes)."""
    from ratelimiter_tpu_torch.observability.decorators import (
        CircuitBreakerDecorator,
        LoggingDecorator,
        MetricsDecorator,
        TracingDecorator,
    )

    if args.trace:
        limiter = TracingDecorator(limiter)
    if args.circuit_breaker:
        limiter = CircuitBreakerDecorator(
            limiter, failure_threshold=args.breaker_threshold,
            cooldown=args.breaker_cooldown, registry=registry)
    if not args.no_metrics:
        limiter = MetricsDecorator(limiter, registry=registry,
                                   shard=str(shard))
    if args.log_decisions:
        limiter = LoggingDecorator(limiter,
                                   redact_keys=args.log_redact_keys)
    return limiter


def enable_observability(args: argparse.Namespace, registry=None) -> None:
    """The flight recorder (``--flight-recorder``) and the event journal
    (on unless ``--no-event-journal``), their families in ``registry``
    (the process default when None), as the JAX binary enables them:
    before any serving thread starts and before anything that emits
    (the controller)."""
    from ratelimiter_tpu_torch.observability import events, metrics, tracing

    registry = registry if registry is not None else metrics.DEFAULT
    if args.flight_recorder:
        tracing.enable(args.flight_recorder_capacity, registry=registry)
    if not args.no_event_journal:
        events.enable(args.event_journal_capacity,
                      host=f"{args.host}:{args.port}", registry=registry,
                      spill_dir=args.event_journal_dir)


def prewarm(limiter, *, door: bool = False, routed: bool = False) -> float:
    """Build and load what the first frames would otherwise build: the
    C++ bulk hasher, with ``door`` the native door's extension, and on a
    CUDA device the backend's kernel libraries (one nvcc each, in
    parallel; with ``routed``, the collective router's ``route_bins``
    too). Touches no limiter state. Returns the seconds it took."""
    from ratelimiter_tpu_torch import native

    t = time.perf_counter()
    native.bulk_hash_u64(["prewarm"])
    if door:
        native.load_server()
    device = getattr(limiter, "device", None)
    if device is not None and device.type == "cuda":
        from ratelimiter_tpu_torch.ops import (
            _build,
            bucket_cuda,
            dense_cuda,
            sketch_cuda,
        )

        from ratelimiter_tpu_torch.algorithms.dense import DenseLimiter

        mods = ([dense_cuda] if isinstance(limiter, DenseLimiter)
                else [sketch_cuda, bucket_cuda])
        if routed:
            from ratelimiter_tpu_torch.ops import route_kernels

            mods.append(route_kernels)
        _build.build_all([m._SOURCE for m in mods])
        for m in mods:
            m.build()
    return time.perf_counter() - t


def build_mesh_shards(cfg: Config, device) -> tuple:
    """The sliced mesh's slices for the native door (one dispatch shard
    per slice), each in its ``SliceGuard`` under ``--quarantine`` (the
    door's shard router is the slice router, so a guard around each
    shard scopes faults to one key range). Returns ``(slices,
    quarantine_manager or None)``."""
    from ratelimiter_tpu_torch.parallel import build_slices

    slices = build_slices(cfg, device=device)
    if not cfg.mesh.quarantine:
        return slices, None
    from ratelimiter_tpu_torch.parallel.quarantine import (
        QuarantineManager,
        SliceGuard,
    )

    qmgr = QuarantineManager(
        len(slices), clock=slices[0].clock,
        probe_interval=cfg.mesh.probe_interval,
        failure_threshold=cfg.mesh.failure_threshold)
    return [SliceGuard(s, i, qmgr, deadline=cfg.mesh.slice_deadline)
            for i, s in enumerate(slices)], qmgr


def _signals(loop, stop):
    """``stop``, or a new event that SIGINT/SIGTERM set."""
    if stop is None:
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
    return stop


async def serve(args: argparse.Namespace, *, make_limiter=None,
                ready=None, stop=None) -> None:
    """The binary's service, start to graceful stop. ``make_limiter(cfg)``
    builds the backend limiter instead of ``create_limiter`` (a
    caller's recording proxy); ``ready``, an asyncio future, is given the
    running pieces (``limiter``, ``server``, ``gateway``, ``auditor``,
    ``slo``, ``hier``, ``controller``, ``persist``, ``member_info``) once
    the door and the
    gateway listen; ``stop``, an asyncio event, ends the service instead
    of SIGINT/SIGTERM. ``--native`` serves through the C++ door
    (``serve_native``)."""
    logging.basicConfig(level=args.log_level.upper())
    enable_observability(args)
    cfg = build_config(args)
    # A multi-shard native door: each dispatch shard enforces its share
    # of every tenant and global limit (the clones inherit the divisor).
    divisor = (args.shards if cfg.hierarchy.enabled and args.native
               and args.shards > 1 and args.backend == "sketch" else 1)
    # --backend mesh behind the native door with the host router mounts
    # the slices as the door's dispatch shards (its shard router is the
    # slice router); the asyncio door, and the collective router under
    # either door, serve the composite limiter.
    mesh_native = (args.backend == "mesh" and args.native
                   and args.router != "collective")
    slices = qmgr = None
    if make_limiter is not None:
        limiter = make_limiter(cfg)
    elif mesh_native:
        slices, qmgr = build_mesh_shards(cfg, args.device)
        limiter = slices[0]
    else:
        limiter = create_limiter(cfg, backend=args.backend,
                                 device=args.device, hier_divisor=divisor)
    if args.backend == "mesh" and not mesh_native:
        from ratelimiter_tpu_torch.observability.decorators import (
            undecorated,
        )

        qmgr = getattr(undecorated(limiter), "quarantine", None)
    built_s = prewarm(limiter, door=args.native,
                      routed=args.router == "collective")
    persist = None
    if cfg.persistence.enabled:
        from ratelimiter_tpu_torch.persistence import PersistenceManager

        persist = PersistenceManager(cfg.persistence)

    def decorate(lim, shard: int = 0):
        # The JAX binary's order: the decorator stack, then the
        # persistence wrapper outermost, so every surface's mutations
        # reach the WAL.
        lim = build_limiter_stack(lim, args, shard=shard)
        return persist.wrap(lim) if persist is not None else lim

    limiter = decorate(limiter)
    # Built before either door, whose constructors take the core; the
    # membership starts once serving does.
    fleet = setup_fleet(args, cfg, limiter, persist)
    start_chaos = setup_chaos(args)
    if args.native:
        await serve_native(args, cfg, limiter, persist, decorate, built_s,
                           ready=ready, stop=stop, slices=slices, qmgr=qmgr,
                           fleet=fleet, start_chaos=start_chaos)
        return
    if persist is not None:
        # Attach, recover before the door listens, then start the
        # background snapshots.
        persist.attach([limiter])
        t = time.perf_counter()
        report = persist.recover()
        print(f"recovered: {report.summary()} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        persist.start()
        if qmgr is not None:
            # Restore-before-rejoin: a recovering slice replays the
            # newest snapshot and the WAL suffix before it routes again.
            qmgr.restore_fn = persist.slice_restorer()
    if fleet is not None:
        # After recovery (the WAL replays locally, never forwards), and
        # outermost: the batcher's frames partition by owner before
        # anything local runs.
        from ratelimiter_tpu_torch.fleet import FleetForwarder

        limiter = FleetForwarder(limiter, fleet.core)
    # The observatory goes in before the door listens, so the first
    # decision can already be mirrored.
    auditor, slo_tracker = setup_audit(args, cfg, limiter)
    member_info, member_collect = make_member_info(
        args, fleet_core=fleet.core if fleet is not None else None)
    hier, controller = setup_hierarchy(
        args, cfg, [limiter], slo_tracker=slo_tracker, auditor=auditor,
        fleet_membership=fleet.membership if fleet is not None else None)
    server = RateLimitServer(
        limiter, args.listen or args.host, args.port,
        max_batch=args.max_batch,
        max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms is not None else None),
        inflight=args.inflight,
        snapshot=persist.snapshot_now if persist is not None else None,
        max_window=max_window(args, cfg), shm=args.shm,
        shm_dir=args.shm_dir, shm_ring_bytes=args.shm_ring_bytes,
        # Fleet announces ride the DCN channel: a member always listens.
        dcn=bool(args.dcn_listen or args.dcn_peer or fleet),
        dcn_secret=dcn_secret(args),
        fleet=fleet.core if fleet is not None else None,
        fleet_announce=(fleet.membership.handle_announce
                        if fleet is not None else None))
    # After recovery: a pusher's export reads the recovered ring.
    pushers = start_pushers(args, [limiter])
    loop = asyncio.get_running_loop()
    # The gateway's and gRPC's worker threads, and the lease debits,
    # funnel into the door's micro-batcher: every surface shares its
    # launches.
    decide = make_threadsafe_decide(server.batcher, loop)
    lease_mgr = _setup_leases(
        args, limiter=limiter, decide=decide, persist=persist,
        pushers=pushers,
        fleet_core=fleet.core if fleet is not None else None)
    server.leases = lease_mgr
    await server.start()
    if controller is not None:
        controller.on_tighten = _lease_controller_hook(lease_mgr)
    # The HTTP and gRPC levers revoke the touched key's leases (the
    # door's own policy and RESET frames revoke inline).
    lease_set, lease_del = _lease_guarded_policy(
        lease_mgr, limiter.set_override, limiter.delete_override)
    lease_reset = _lease_guarded_reset(lease_mgr, limiter.reset)
    gateway = None
    if args.http_port is not None:
        gateway = make_gateway(args, limiter, server, decide=decide,
                               levers=(lease_reset, lease_set, lease_del),
                               member_info=member_info, persist=persist,
                               hier=hier, controller=controller,
                               auditor=auditor, slo_tracker=slo_tracker,
                               lease_mgr=lease_mgr, qmgr=qmgr, fleet=fleet)
        gateway.start()
    grpc_srv = None
    if args.grpc_port is not None:
        grpc_srv = make_grpc(
            args, limiter, decide=decide,
            decide_many=make_threadsafe_decide_many(server.batcher, loop),
            reset=lease_reset,
            policy=(lease_set, limiter.get_override, lease_del),
            decisions_total=lambda: server.batcher.decisions_total,
            hier=hier)
        grpc_srv.start()
    if controller is not None:
        controller.start()
    stop = _signals(loop, stop)
    print(f"serving {args.algorithm}/{args.backend} "
          f"limit={limiter.config.limit}/{limiter.config.window:g}s "
          f"on {args.listen or f'{args.host}:{server.port}'} "
          f"device={getattr(limiter, 'device', 'host')} "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)"
          + (" shm" if args.shm else "")
          + (f" http:{gateway.port}" if gateway is not None else "")
          + (f" grpc:{grpc_srv.port}" if grpc_srv is not None else ""),
          flush=True)
    if fleet is not None:
        fleet.membership.start()
    _start_rebalance(args, fleet)
    if start_chaos is not None:
        start_chaos()
    if ready is not None:
        ready.set_result(SimpleNamespace(
            limiter=limiter, server=server, gateway=gateway,
            auditor=auditor, slo=slo_tracker, hier=hier,
            controller=controller, persist=persist,
            member_info=member_info, grpc=grpc_srv, leases=lease_mgr,
            lease_listener=None, quarantine=qmgr, pushers=pushers,
            fleet=fleet))
    try:
        await stop.wait()
    finally:
        _stop_rebalance(fleet)
        if controller is not None:
            # Before the departure: a tick against a closing limiter
            # would race the teardown.
            controller.stop()
        # Before the door drains: in-flight rows ride the forward
        # window while the successor takes the ranges.
        await _depart(args, fleet)
        for pu in pushers:
            pu.stop()
        if gateway is not None:
            gateway.shutdown()
        if grpc_srv is not None:
            grpc_srv.shutdown()
        # Pushes the leases' revoke-all while the connections are open.
        await server.shutdown()
        if persist is not None:
            # After the drain, before close: the final snapshot captures
            # every answered decision — a graceful shutdown loses nothing.
            persist.stop()
        _stop_observability(auditor, slo_tracker, member_collect)
        limiter.close()
        from ratelimiter_tpu_torch.observability import events

        events.disable()


def _stop_observability(auditor, slo_tracker, member_collect) -> None:
    from ratelimiter_tpu_torch.observability import audit, metrics

    if auditor is not None:
        auditor.flush(timeout=2.0)
        audit.disable()
    if slo_tracker is not None:
        slo_tracker.detach()
    metrics.DEFAULT.remove_collect_hook(member_collect)


async def serve_native(args: argparse.Namespace, cfg: Config, limiter,
                       persist, decorate, built_s: float, *, ready=None,
                       stop=None, slices=None, qmgr=None, fleet=None,
                       start_chaos=None) -> None:
    """``--native``: the C++ door (serving/native_server.py) over
    ``limiter`` and, with ``--shards N``, N - 1 clones each under
    ``decorate(clone, i)`` (the decorator stack under shard ``i``'s
    label, the persistence wrapper), or with ``slices`` (``--backend
    mesh``, host router) the mesh's slices as the shards, slice 0 being
    ``limiter`` (``qmgr`` their quarantine manager); ``fleet`` the
    member's core and membership (``setup_fleet``); the JAX binary's
    native branch. The persistence
    manager attaches every shard with the door's router and recovers
    before the door listens; the HTTP gateway and gRPC decide through
    ``decide_one``/``decide_many`` (the shard router), and so do the
    lease debits, whose frames the ``LeaseListener`` sidecar serves on
    ``--lease-port``."""
    from ratelimiter_tpu_torch.observability import metrics
    from ratelimiter_tpu_torch.serving.http_gateway import HttpGateway
    from ratelimiter_tpu_torch.serving.native_server import (
        NativeRateLimitServer,
    )

    auditor, slo_tracker = setup_audit(
        args, cfg, limiter,
        n_slices=len(slices) if slices is not None else None)
    member_info, member_collect = make_member_info(
        args, fleet_core=fleet.core if fleet is not None else None)
    if fleet is not None:
        # Peers hash-forward this member's string rows on the raw-id
        # lane unless its map entry declares shards > 1 (FNV string
        # routing): an undeclared multi-shard member would split a key's
        # quota across shards, so it refuses to start.
        actual = len(slices) if slices is not None else args.shards
        declared = fleet.core.map.host(args.fleet_self).shards
        if actual > 1 and declared != actual:
            raise SystemExit(
                f"--fleet-config entry {args.fleet_self!r} declares "
                f"shards={declared} but this native door runs {actual} "
                f"shards; set \"shards\": {actual} on this host in the "
                f"fleet map so peers forward its string rows as strings")
    server = NativeRateLimitServer(
        limiter, args.listen or args.host, args.port,
        shm=args.shm, shm_dir=args.shm_dir,
        shm_ring_bytes=args.shm_ring_bytes,
        max_batch=args.max_batch, max_delay=args.max_delay_us * 1e-6,
        dispatch_timeout=(args.dispatch_timeout_ms * 1e-3
                          if args.dispatch_timeout_ms else None),
        inflight=args.inflight, shards=args.shards,
        net_engine=args.net_engine, io_rings=args.io_rings,
        shard_decorate=lambda lim, i: decorate(lim, shard=i),
        shard_limiters=([limiter] + [decorate(s, shard=i) for i, s in
                                     enumerate(slices[1:], start=1)]
                        if slices is not None else None),
        dcn=bool(args.dcn_listen or args.dcn_peer or fleet),
        dcn_secret=dcn_secret(args),
        max_dcn_conns=args.dcn_max_transfers,
        fleet=fleet.core if fleet is not None else None,
        fleet_announce=(fleet.membership.handle_announce
                        if fleet is not None else None))
    if persist is not None:
        # Recover BEFORE the listener opens: the restored snapshot and
        # the replayed mutations precede the first decision.
        persist.attach(server.shard_limiters, shard_of=server.shard_of)
        t = time.perf_counter()
        report = persist.recover()
        print(f"recovered: {report.summary()} in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        persist.start()
        if qmgr is not None:
            qmgr.restore_fn = persist.slice_restorer()
    server.start()
    pushers = start_pushers(args, server.shard_limiters)
    # The C++ door has no lease lane: grants, renewals and returns are
    # served by a sidecar listener, their debits through decide_one, the
    # shard router, so a lease budget lands on the key's shard.
    lease_mgr = _setup_leases(
        args, limiter=limiter, decide=server.decide_one, persist=persist,
        pushers=pushers,
        fleet_core=fleet.core if fleet is not None else None)
    server.leases = lease_mgr
    lease_listener = None
    if lease_mgr is not None:
        from ratelimiter_tpu_torch.leases.listener import LeaseListener

        lease_listener = LeaseListener(lease_mgr, host=args.host,
                                       port=args.lease_port or 0)
        lease_listener.start()
    # After recovery (the hier_* columns restore first), before the
    # gateway, whose /healthz and /v1/tenants mount it.
    hier, controller = setup_hierarchy(
        args, cfg, server.shard_limiters, slo_tracker=slo_tracker,
        auditor=auditor,
        fleet_membership=fleet.membership if fleet is not None else None)
    if controller is not None:
        controller.on_tighten = _lease_controller_hook(lease_mgr)
    # HTTP and gRPC get the lease-guarded levers; a mutation over the
    # C++ door's own binary lane is bounded by the lease TTL instead.
    lease_set, lease_del = _lease_guarded_policy(
        lease_mgr, server.set_override_all, server.delete_override_all)
    lease_reset = _lease_guarded_reset(lease_mgr, server.reset_one)
    gateway = None
    if args.http_port is not None:
        lims = server.shard_limiters

        def health() -> dict:
            return {"serving": True,
                    "decisions_total": server.stats()["decisions_total"],
                    "policy_overrides": lims[0].override_count(),
                    "transport": server.transport_stats(),
                    "member": member_info(),
                    **_envelope_health(lims),
                    **_debt_slab_health(lims),
                    **_consumers_health(lims),
                    **_audit_health(),
                    **_slo_health(slo_tracker),
                    **_hierarchy_health(hier, controller),
                    **_lease_health(lease_mgr),
                    **_events_health(),
                    **_quarantine_health(qmgr),
                    **_fleet_health(fleet),
                    **_placement_health(fleet),
                    **(persist.status() if persist is not None else {})}

        gateway = HttpGateway(
            server.decide_one, lease_reset,
            host=args.host, port=args.http_port,
            metrics_render=metrics.DEFAULT.render,
            health=health,
            enable_reset=bool(args.http_reset or args.http_reset_token),
            reset_token=args.http_reset_token,
            # Overrides apply on every shard (keys hash-route).
            policy_set=lease_set,
            policy_get=server.get_override_one,
            policy_delete=lease_del,
            enable_policy=bool(args.http_policy or args.http_policy_token),
            policy_token=args.http_policy_token,
            snapshot=(persist.snapshot_now if persist is not None
                      else None),
            snapshot_token=args.http_snapshot_token,
            enable_debug=bool(args.debug_trace or args.debug_token),
            debug_token=args.debug_token,
            audit_status=(make_audit_status(auditor, slo_tracker, lims)
                          if args.audit else None),
            audit_token=args.audit_token,
            tenants=hier,
            enable_tenants=bool(args.http_tenants
                                or args.http_tenants_token),
            tenants_token=args.http_tenants_token,
            fleet_migrate=make_fleet_migrate(args, fleet),
            migrate_token=args.http_migrate_token,
            **make_control_plane(args, fleet, health, auditor,
                                 slo_tracker))
        gateway.start()
    grpc_srv = None
    if args.grpc_port is not None:
        grpc_srv = make_grpc(
            args, limiter, decide=server.decide_one,
            decide_many=server.decide_many, reset=lease_reset,
            policy=(lease_set, server.get_override_one, lease_del),
            decisions_total=lambda: server.stats()["decisions_total"],
            hier=hier)
        grpc_srv.start()
    if controller is not None:
        controller.start()
    stop = _signals(asyncio.get_running_loop(), stop)
    net = server.transport_stats()["net"]
    print(f"serving(native) {args.algorithm}/{args.backend} "
          f"limit={limiter.config.limit}/{limiter.config.window:g}s "
          f"on {args.listen or f'{args.host}:{server.port}'} "
          f"device={getattr(limiter, 'device', 'host')} "
          f"shards={len(server.shard_limiters)} "
          f"net={net.get('engine', '?')}"
          f"x{net.get('rings', '?')}(probe={net.get('uring_probe', '?')}) "
          f"max_batch={args.max_batch} max_delay={args.max_delay_us:g}us "
          f"inflight={args.inflight} (built in {built_s:.1f} s)"
          + (" shm" if args.shm else "")
          + (f" http:{gateway.port}" if gateway is not None else "")
          + (f" grpc:{grpc_srv.port}" if grpc_srv is not None else "")
          + (f" lease:{lease_listener.port}" if lease_listener is not None
             else ""),
          flush=True)
    if fleet is not None:
        fleet.membership.start()
    _start_rebalance(args, fleet)
    if start_chaos is not None:
        start_chaos()
    if ready is not None:
        ready.set_result(SimpleNamespace(
            limiter=limiter, server=server, gateway=gateway,
            auditor=auditor, slo=slo_tracker, hier=hier,
            controller=controller, persist=persist,
            member_info=member_info, grpc=grpc_srv, leases=lease_mgr,
            lease_listener=lease_listener, quarantine=qmgr,
            pushers=pushers, fleet=fleet))
    try:
        await stop.wait()
    finally:
        _stop_rebalance(fleet)
        if controller is not None:
            controller.stop()
        await _depart(args, fleet)
        for pu in pushers:
            pu.stop()
        if gateway is not None:
            gateway.shutdown()
        if grpc_srv is not None:
            grpc_srv.shutdown()
        if lease_mgr is not None:
            # Revoke-all BEFORE the listener closes: holders get the
            # shutdown push and stop answering locally right away.
            lease_mgr.close()
        if lease_listener is not None:
            lease_listener.close()
        if persist is not None:
            # The door first (it answers what is in flight), then the
            # final snapshot of every shard, then the clones close.
            server.shutdown(close_limiters=False)
            persist.stop()
            server.close_shards()
        else:
            server.shutdown()
        if fleet is not None:
            # After the door drains: in-flight frames may still hold
            # forward futures.
            fleet.core.close()
        _stop_observability(auditor, slo_tracker, member_collect)
        limiter.close()
        from ratelimiter_tpu_torch.observability import events

        events.disable()


def main(argv=None) -> None:
    asyncio.run(serve(parse_args(argv)))


if __name__ == "__main__":
    main()
