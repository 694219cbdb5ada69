"""The port's mesh: an ordered list of devices and the collectives over it.

The JAX package builds a ``jax.sharding.Mesh`` over one flat axis
("chips") and runs its collectives (``all_gather``, ``psum``, ``pmax``,
``all_to_all``) inside ``shard_map`` (ratelimiter_tpu/parallel/mesh.py,
mesh_kernels.py): ONE process owns every device. The port keeps that
single-controller shape. A mesh is a list of ``torch.device``s, one per
slice, in slice order (chip-major, as the JAX flat axis), and repeats are
allowed: N slices on ``cuda:0`` (one card) or on ``cpu`` (the tests, the
counterpart of the JAX tests' virtual CPU devices) run the same code that
spans N cards. A collective is copies between the slices' devices and a
reduction on each device, written once here:

* ``all_gather(parts)``: every slice's part copied to every device, then
  concatenated in slice order;
* ``psum(parts)`` / ``pmax(parts)``: every part copied to each device,
  then summed / maxed there (in slice order, so integer sums are the
  same bits everywhere);
* ``all_to_all(send)``: ``send[src][dst]`` copied to ``dst``; each
  destination receives its bins concatenated source-major.

No NCCL and no ``torch.distributed``: both need a process per rank, and
NCCL does not put two ranks on one card. A copy is ``Tensor.to(device,
non_blocking=True)``: between two CUDA devices PyTorch enqueues it on
the destination's current stream behind an event recorded on the
source's, so the two sides stay ordered; on one device it returns the
tensor itself, and only the concatenation or reduction copies.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ratelimiter_tpu_torch.core.errors import InvalidConfigError


def mesh_devices(device="cuda", n: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The slices' devices, in slice order.

    ``devices`` (an explicit list, repeats allowed) wins. Otherwise, on
    the CPU ``n`` slices (default 1) all go on ``cpu``; on CUDA ``n``
    slices (default every visible card) go on ``cuda:0..n-1``, and an
    ``n`` above ``torch.cuda.device_count()`` is refused with the JAX
    package's message (ratelimiter_tpu/parallel/limiter.py
    ``build_slices``)."""
    from ratelimiter_tpu_torch.algorithms.sketch import resolve_device

    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if n is not None:
            _check_count(n, len(out))
            out = out[:n]
        if not out:
            raise InvalidConfigError("mesh needs at least 1 device, got 0")
        return out
    dev = resolve_device(device)
    if dev.type == "cpu":
        count = 1 if n is None else n
        _check_count(count, count)
        return [dev] * count
    visible = torch.cuda.device_count()
    count = visible if n is None else n
    _check_count(count, visible)
    return [torch.device("cuda", i) for i in range(count)]


def _check_count(n: int, visible: int) -> None:
    if n < 1:
        raise InvalidConfigError(f"mesh needs at least 1 device, got {n}")
    if n > visible:
        raise InvalidConfigError(
            f"mesh wants {n} devices but only {visible} are visible "
            f"(CUDA_VISIBLE_DEVICES; pass an explicit devices= list to "
            f"put several slices on one card)")


class Mesh:
    """One flat axis of slices over ``devices`` (repeats allowed)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise InvalidConfigError("mesh needs at least 1 device, got 0")

    @property
    def size(self) -> int:
        return len(self.devices)

    def _to(self, t: torch.Tensor, i: int) -> torch.Tensor:
        return t.to(self.devices[i], non_blocking=True)

    def all_gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """parts[i] lives on slice i; returns, per slice, the parts
        concatenated in slice order on that slice's device."""
        return [torch.cat([self._to(p, i) for p in parts])
                for i in range(self.size)]

    def _reduce(self, parts, op) -> List[torch.Tensor]:
        out = []
        for i in range(self.size):
            acc = self._to(parts[0], i).clone()
            for p in parts[1:]:
                op(acc, self._to(p, i))
            out.append(acc)
        return out

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per slice, the elementwise sum of every slice's part (in the
        parts' dtype: int32 sums wrap, as XLA's do)."""
        return self._reduce(parts, torch.Tensor.add_)

    def pmax(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per slice, the elementwise max of every slice's part."""
        def op(acc, p):
            torch.maximum(acc, p, out=acc)
        return self._reduce(parts, op)

    def all_to_all(self, send: Sequence[Sequence[torch.Tensor]]
                   ) -> List[torch.Tensor]:
        """``send[src][dst]`` is the bin slice ``src`` sends to ``dst``;
        returns, per destination, its received bins concatenated
        source-major (the JAX tiled ``all_to_all``)."""
        return [torch.cat([self._to(send[src][dst], dst)
                           for src in range(self.size)])
                for dst in range(self.size)]
