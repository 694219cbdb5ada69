"""Multi-slice deployment — the port of ``ratelimiter_tpu/parallel/``.

* ``SlicedMeshLimiter`` (``--backend mesh``, ``MeshSpec.router="host"``):
  one device-pinned single-slice limiter per device, keys hash-routed to
  their owning slice on the host; the decide path is collective-free.
* ``CollectiveMeshLimiter`` (``router="collective"``): the same slices,
  each frame one routed dispatch (``route_bins`` on the device, an
  all-to-all of rows to their owners, the unchanged step per owner).
* ``MeshSketchLimiter`` / ``MeshTokenBucketLimiter``: state replicated on
  every slice, the batch sharded, coherence through the gather or delta
  merge (parallel/mesh_kernels.py).
* ``quarantine``: per-slice failure domains for the sliced mesh.

A mesh is an ordered list of devices (parallel/mesh.py), repeats allowed:
N cards, N slices on one card, or N slices on the CPU (the tests). One
process drives every slice; the collectives are device copies plus
reductions, not ``torch.distributed``.

* ``dcn``: the cross-pod tier (completed slabs and debt deltas between
  pods; serving/dcn_peer.py carries them between processes);
* ``reshard``: a combined snapshot re-bucketed onto another slice
  count (the sliced mesh's restore, and ``python -m
  ratelimiter_tpu_torch.tools.rebucket`` offline).
"""

from ratelimiter_tpu_torch.parallel.mesh import Mesh, mesh_devices
from ratelimiter_tpu_torch.parallel.limiter import (
    MeshSketchLimiter,
    MeshTokenBucketLimiter,
    SlicedMeshLimiter,
    build_slices,
)
from ratelimiter_tpu_torch.parallel.collective import CollectiveMeshLimiter

__all__ = [
    "CollectiveMeshLimiter",
    "Mesh",
    "MeshSketchLimiter",
    "MeshTokenBucketLimiter",
    "SlicedMeshLimiter",
    "build_slices",
    "mesh_devices",
]
