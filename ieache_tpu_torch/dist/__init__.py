"""Distribution: meshes of ranks, the sharded bootstrap, dp placement,
the pipelined chain, multi-host start-up and the dry run.

Counterpart of :mod:`ieache_tpu.dist`.  Where the JAX package maps a
function over the devices of one process (``shard_map``), the port runs
one process per rank on a ``torch.distributed`` process group (NCCL on
CUDA, gloo on the CPU), and each rank calls the same function on its
own slice: ``psum`` becomes ``all_reduce``, ``all_gather`` the list
form of ``all_gather``, ``ppermute`` ``send``/``recv``.
:mod:`~ieache_tpu_torch.dist.launch` starts the ranks of one host.

Import the submodules directly; this package imports none of them, and
importing one makes no device or process group.
"""
