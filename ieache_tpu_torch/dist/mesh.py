"""Meshes of ranks for multi-chip scaling.

Counterpart of :mod:`ieache_tpu.dist.mesh`: a (dp, tp) mesh over the
first ranks of the process group, with two axes:

* ``dp`` — data parallel over the ciphertext/gate batch;
* ``tp`` — tensor parallel over the external-product contraction
  (TRGSW rows x N) and the keyswitch's (kN x t), splitting the keys
  and the products, with one all_reduce a blind-rotation step.

A :class:`Mesh` holds the ``torch.distributed`` ``DeviceMesh`` (the one
``init_device_mesh`` builds, here over the first n ranks, as the JAX
package's meshes take the first n devices), the axis sizes, this rank's
coordinates and its group along each axis.  Every rank of the process
group builds the mesh, in the same order; a rank outside it has no
coordinates.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _rank_device() -> torch.device:
    """This rank's device: its current CUDA device under NCCL, else the
    CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """Axes ``shape`` ({name: size}, in order) over the first
    prod(sizes) ranks; raises ``ValueError`` where the process group has
    fewer ranks."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        n = math.prod(self.shape.values())
        world = dist.get_world_size()
        if n > world:
            raise ValueError(f"need {n} ranks, have {world}")
        self.device = _rank_device()
        ranks = torch.arange(n).reshape(tuple(self.shape.values()))
        self.device_mesh = DeviceMesh(self.device.type, ranks,
                                      mesh_dim_names=tuple(self.shape))
        coord = self.device_mesh.get_coordinate()
        #: {axis: this rank's index}, or None outside the mesh
        self.coordinate = None if coord is None else dict(zip(self.shape,
                                                              coord))

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coordinate[axis]

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The first rank's ``x`` on every rank of the mesh, on its
        device: broadcast along each axis in turn, from index 0 (a copy
        of ``x`` is sent; ``x`` itself is left as it was)."""
        x = x.to(self.device, copy=True).contiguous()
        for axis in self.shape:
            group = self.group(axis)
            dist.broadcast(x, src=dist.get_global_rank(group, 0),
                           group=group)
        return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The slices ``x`` of every rank of ``group``, concatenated along
    ``dim`` in group-rank order (the JAX package's tiled all_gather)."""
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def make_mesh(n_devices: int | None = None, tp: int = 1) -> Mesh:
    """A (dp, tp) mesh over the first ``n_devices`` ranks (all of them by
    default)."""
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    if n % tp:
        raise ValueError(f"n_devices {n} not divisible by tp {tp}")
    return Mesh({"dp": n // tp, "tp": tp})
