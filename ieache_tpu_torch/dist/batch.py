"""Data-parallel placement for batched expression evaluation.

Counterpart of :mod:`ieache_tpu.dist.batch`.  The evaluator
(:mod:`ieache_tpu_torch.circuits.evaluator`) is written over a leading
batch axis and every gate in the batch is independent, so scaling over
ranks is pure data parallelism: each rank holds the evaluation key
(:func:`replicate_cloud_key`) and its dp slice of every operand
(:func:`shard_operand`), runs the unchanged ``CloudEvaluator`` on it
with no collective, and the answer's slices are gathered back
(:func:`gather_operand`).  It changes no compute path: the same arrays
as the unsharded run.
"""

from __future__ import annotations

import dataclasses

from ieache_tpu_torch.boot.bootstrap import DeviceCloudKey
from ieache_tpu_torch.circuits.evaluator import Operand
from ieache_tpu_torch.dist.mesh import Mesh, all_gather_cat
from ieache_tpu_torch.dist.shard import shard_batch


def replicate_cloud_key(dck: DeviceCloudKey, mesh: Mesh) -> DeviceCloudKey:
    """The first rank's evaluation key on every rank of the mesh (one
    broadcast instead of the reference's per-host key transfers)."""
    return DeviceCloudKey(bk=mesh.broadcast(dck.bk),
                          ks_limbs=mesh.broadcast(dck.ks_limbs),
                          params=dck.params)


def shard_operand(op: Operand, mesh: Mesh) -> Operand:
    """This rank's dp slice of every array of ``op`` (the batch axis);
    raises ``ValueError`` where dp does not divide the batch."""
    dp = mesh.shape["dp"]
    if op.batch % dp:
        raise ValueError(f"batch {op.batch} not divisible by dp={dp}")
    return Operand(**{f.name: shard_batch(getattr(op, f.name), mesh)
                      for f in dataclasses.fields(Operand)})


def gather_operand(op: Operand, mesh: Mesh) -> Operand:
    """Every rank's dp slice of ``op`` gathered back into the whole
    batch, on every rank."""
    group = mesh.group("dp")
    return Operand(**{f.name: all_gather_cat(getattr(op, f.name), group, 0)
                      for f in dataclasses.fields(Operand)})
