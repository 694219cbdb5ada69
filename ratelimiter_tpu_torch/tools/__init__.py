"""Offline tools of the port, each run as ``python -m
ratelimiter_tpu_torch.tools.<name>``:

* ``rebucket``: resize a snapshot onto a new slice count;
* ``fleet_status``: the fleet's merged rollup, from a member's
  ``/v1/fleet/status`` or merged here (``--offline``);
* ``fleet_trace``: the fleet's stitched trace, from a member's
  ``/debug/trace?fleet=1`` or stitched here (``--offline``).

``tools/fleet_rebalance.py`` and ``tools/fleet_migrate.py`` at the
repo's root speak HTTP only and drive a member of either package.
"""
