"""The client mesh: D logical shards of the K clients on one device.

Port of the client mesh of ``federated_pytorch_test_tpu/parallel/mesh.py``.
The JAX package lays the K clients over a 1-D mesh of D devices (axis
``'clients'``), each device holding a contiguous group of K/D clients, and
runs one program per device under ``shard_map``; its tests run D > 1 on
virtual CPU devices in one process.  Here the D shards all live on the one
device, as the leading client dimension of every stacked tensor cut into D
contiguous groups, and the collectives become tensor operations in a fixed
order:

  * ``psum``: a sum over d = 0..D-1, in that order;
  * the tiled ``all_to_all`` over the coordinate axis: a split of the padded
    ``[K, D*seg]`` stack into D column slabs ``[K, seg]``;
  * the tiled ``all_gather``: a concatenation.

The numbers are those of the JAX program at that D; the mesh adds nothing
the JAX package lacks.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class ClientMesh:
    """D logical shards of a K-client stack, all on one device."""

    def __init__(self, D: int = 1):
        if D < 1:
            raise ValueError(f"num_devices={D} must be >= 1")
        self.size = int(D)

    def shards(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """The D contiguous client groups of ``stack`` [K, ...] (views)."""
        K = stack.shape[0]
        if K % self.size:
            raise ValueError(f"K={K} not divisible by device count {self.size}")
        return list(stack.split(K // self.size))

    @staticmethod
    def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the per-shard values, in shard order."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def federated_sum(self, stack: torch.Tensor) -> torch.Tensor:
        """Sum over all clients: each shard's local sum, then ``psum``."""
        return self.psum([s.sum(dim=0) for s in self.shards(stack)])

    def all_to_all(self, stack: torch.Tensor) -> List[torch.Tensor]:
        """The tiled ``all_to_all`` over the coordinate axis: the [K, n]
        stack padded with zero columns to [K, D*seg], seg = ceil(n / D), cut
        into D column slabs [K, seg]; slab d is what device d receives."""
        n = stack.shape[1]
        seg = -(-n // self.size)
        if self.size * seg != n:
            stack = torch.nn.functional.pad(stack, (0, self.size * seg - n))
        return list(stack.split(seg, dim=1))

    @staticmethod
    def all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The tiled ``all_gather``: the shards' pieces concatenated."""
        return torch.cat(list(parts))


def usable_device_count(K: int, n_devices: int = 1) -> int:
    """Largest D <= n_devices with K % D == 0 (``usable_device_count`` of
    the JAX package).  The port runs on one card, so without an explicit
    ``num_devices`` the mesh has one shard."""
    d = min(n_devices, K)
    while K % d:
        d -= 1
    return d
