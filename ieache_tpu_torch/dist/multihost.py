"""Multi-host runtime: one process group over the ranks of several
hosts.

Counterpart of :mod:`ieache_tpu.dist.multihost` (``jax.distributed``
over DCN).  Every host runs the same program; :func:`initialize` joins
it to the process group on a TCP store, and one global mesh spans every
rank of every host (:func:`global_mesh`): ``dp`` crosses hosts, ``tp``
stays within one.  The reference's key fan-out becomes a broadcast of
the packed cloud key from rank 0 (:func:`replicate_cloud_key`), and a
rank's slice of a global batch is simply the tensor it holds.

Importing this module makes no device and no process group;
:func:`initialize` does.
"""

from __future__ import annotations

from ieache_tpu_torch.dist import launch
from ieache_tpu_torch.dist import mesh as dmesh
# the evaluation key replicated across the global mesh: one broadcast
# from rank 0, as on one host
from ieache_tpu_torch.dist.batch import replicate_cloud_key  # noqa: F401


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, platform: str = "cuda"):
    """Join the process group whose TCP store ``coordinator_address``
    (``host:port``) names, as rank ``process_id`` of ``num_processes``:
    gloo for ``platform="cpu"``, NCCL on this host's card otherwise.
    Returns the rank's device."""
    return launch.init(process_id, num_processes, coordinator_address,
                       platform)


def global_mesh(tp: int = 1) -> dmesh.Mesh:
    """(dp, tp) mesh over every rank of every host."""
    return dmesh.make_mesh(tp=tp)


def shard_global_batch(x, mesh: dmesh.Mesh):
    """This host's slice of a global batch: the rank holds it as it is,
    on its device (a global array is the slices of all ranks, in dp
    order)."""
    return x.to(mesh.device)


def replicate_global(x, mesh: dmesh.Mesh):
    """Rank 0's ``x`` on every rank of the global mesh (the key fan-out
    as one broadcast)."""
    return mesh.broadcast(x)


def to_host_local(garr, mesh: dmesh.Mesh):
    """A global dp-sharded result -> this host's slice: the tensor the
    rank holds."""
    return garr
