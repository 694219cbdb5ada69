"""Fleet tier: multi-host scale-out with consistent-hash routing,
cross-host forwarding and per-range failover — a port of
``ratelimiter_tpu/fleet/`` (ADR-017, ADR-018, ADR-019).

One server owns a contiguous set of keyspace hash buckets; a fleet of
them is one limiter:

* :class:`~ratelimiter_tpu_torch.fleet.config.FleetMap`: the ownership
  map (bucket ranges per host, epoch-versioned);
* :class:`~ratelimiter_tpu_torch.fleet.forwarder.FleetCore` /
  :class:`~ratelimiter_tpu_torch.fleet.forwarder.FleetForwarder`:
  per-process routing and the server-side forwarder for mis-routed
  rows, over the coalesced columnar peer lanes of ``fleet/lanes.py``;
* :class:`~ratelimiter_tpu_torch.fleet.membership.FleetMembership`:
  announce/heartbeat gossip over the authenticated DCN channel,
  per-range failover onto the successor (restored from the dead host's
  newest snapshot and WAL suffix, on the serving limiter's device),
  live migration, departure and rejoin give-back;
* ``fleet/handoff.py``: standby units restored from a peer's snapshot
  directory before ownership flips;
* :class:`~ratelimiter_tpu_torch.fleet.tower.ControlTower`: the
  fleet-wide rollup (``/v1/fleet/status``), trace stitching and event
  merge over the members' HTTP gateways (``fleet/tower.py``).

Every member's own rows, forwarded rows and an adopted range decide on
sketch limiters on the member's device. Client-side routing lives in
``serving/client.py`` (``FleetClient`` / ``AsyncFleetClient``); the
load-aware planner and rebalancer in ``placement/``.
"""

from ratelimiter_tpu_torch.fleet.config import FleetHost, FleetMap, affine_map
from ratelimiter_tpu_torch.fleet.forwarder import FleetCore, FleetForwarder
from ratelimiter_tpu_torch.fleet.handoff import build_standby
from ratelimiter_tpu_torch.fleet.membership import FleetMembership
from ratelimiter_tpu_torch.fleet.tower import ControlTower

__all__ = [
    "FleetHost",
    "FleetMap",
    "affine_map",
    "FleetCore",
    "FleetForwarder",
    "FleetMembership",
    "ControlTower",
    "build_standby",
]
