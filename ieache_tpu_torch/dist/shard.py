"""Sharded (multi-rank) gate bootstrapping.

Counterpart of :mod:`ieache_tpu.dist.shard`.  Each function here is run
by every rank of a mesh on its own slice, where the JAX package maps it
over the devices with ``shard_map``:

* ``dp``: the gate batch is sharded (:func:`shard_batch`); a rank
  bootstraps its lanes alone;
* ``tp``: the external product's TRGSW rows and the keyswitch's kN*t
  contraction are sharded (:func:`shard_cloud_key`); each blind-rotation
  step ends in one ``all_reduce`` over tp, and so does the keyswitch;
* ``sp``: the accumulator's polynomial axis N is sharded
  (:func:`make_sharded_bootstrap_sp`); each step all-gathers it once
  and computes this rank's block of output columns.

The tp and sp steps are plain PyTorch ops, as the JAX package's are
plain XLA: they reach no kernel.  Every int32 sum over ranks wraps mod
2^32, as the products' sums do, so each returns the unsharded
bootstrap's arrays.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ieache_tpu_torch.boot.bootstrap import (
    MU,
    DeviceCloudKey,
    initial_accumulator,
    sample_extract,
)
from ieache_tpu_torch.dist.mesh import Mesh, all_gather_cat
from ieache_tpu_torch.ops.blind_rotate import (
    _digit_products,
    blind_rotate_sharded,
    make_step_gmatrix_local,
)
from ieache_tpu_torch.ops.decompose import _step_digits
from ieache_tpu_torch.ops.keyswitch import (
    keyswitch,
    keyswitch_digits,
    keyswitch_finish,
    keyswitch_products,
)
from ieache_tpu_torch.params import TFHEParams


def _keyswitch_sharded(lwe_ext: torch.Tensor, ks_local: torch.Tensor,
                       params: TFHEParams, group) -> torch.Tensor:
    """Keyswitch with the (kN*t) contraction sharded over ``group``:
    this rank's digits against its rows of the KS limbs, the partial
    sums all-reduced, trimmed to n+1 columns as :func:`keyswitch` does."""
    d8, body = keyswitch_digits(lwe_ext, params)
    k_local = ks_local.shape[1]
    start = dist.get_rank(group) * k_local
    acc = keyswitch_products(d8[:, start:start + k_local].contiguous(),
                             ks_local)
    dist.all_reduce(acc, group=group)
    return keyswitch_finish(acc, body, params)


def make_sharded_bootstrap(mesh: Mesh, params: TFHEParams, mu: int = MU,
                           overlap_chunks: int = 2):
    """The (dp, tp)-sharded bootstrap: ``fn(lwe, bk_local, ks_local) ->
    lwe_out``, run by every rank of ``mesh`` on its dp slice of the
    batch (:func:`shard_batch`) and its tp slices of the keys
    (:func:`shard_cloud_key`); returns its dp slice of the output.

    ``tp`` must divide the TRGSW rows and kN*ks_t.  ``overlap_chunks``
    overlaps each step's all_reduce with the next chunk's products
    (:func:`~ieache_tpu_torch.ops.blind_rotate.blind_rotate_sharded`).
    """
    tp = mesh.shape["tp"]
    if params.trgsw_rows % tp or (params.kN * params.ks_t) % tp:
        raise ValueError(f"tp={tp} must divide TRGSW rows and kN*t")

    def fn(lwe, bk_local, ks_local):
        group = mesh.group("tp")
        acc0, bara = initial_accumulator(lwe, params, mu)
        acc = blind_rotate_sharded(acc0, bara, bk_local, params, group,
                                   overlap_chunks=overlap_chunks)
        return _keyswitch_sharded(sample_extract(acc, params), ks_local,
                                  params, group)

    return fn


def make_sp_mesh(n_devices: int, sp: int) -> Mesh:
    """(dp, sp) mesh over the first ``n_devices`` ranks: batch-parallel x
    polynomial-dimension-parallel."""
    if n_devices % sp:
        raise ValueError(f"n_devices {n_devices} not divisible by {sp}")
    return Mesh({"dp": n_devices // sp, "sp": sp})


def _external_product_step_sp(acc_local: torch.Tensor, bara_i: torch.Tensor,
                              bk_i: torch.Tensor, params: TFHEParams,
                              group) -> torch.Tensor:
    """CMux step with the accumulator's polynomial axis N sharded over
    ``group``: all-gather the accumulator (the negacyclic rotation mixes
    every coefficient), decompose the gathered copy (the same work on
    every rank), and contract the digits against only this rank's
    column block of the step's operand,
    :func:`~ieache_tpu_torch.ops.blind_rotate.make_step_gmatrix_local`;
    the block is this rank's slice of the new accumulator, so no sum
    over ranks is needed."""
    n_local = acc_local.shape[-1]
    acc_full = all_gather_cat(acc_local, group, dim=-1)   # (B, k+1, N)
    digits = _step_digits(acc_full, bara_i, params)        # (B, rows, N)
    g_local = make_step_gmatrix_local(
        bk_i, params, dist.get_rank(group) * n_local, n_local)
    return acc_local + _digit_products(digits, g_local, params)


def make_sharded_bootstrap_sp(mesh: Mesh, params: TFHEParams, mu: int = MU):
    """The (dp, sp)-sharded bootstrap: ``fn(lwe, bk, ks_limbs) ->
    lwe_out``, run by every rank of ``mesh`` on its dp slice of the batch
    with the whole keys; one all-gather a blind-rotation step.  Returns
    its dp slice of the output.  ``sp`` must divide N."""
    sp = mesh.shape["sp"]
    if params.N % sp:
        raise ValueError(f"sp={sp} must divide N={params.N}")
    n_local = params.N // sp

    def fn(lwe, bk, ks_limbs):
        group = mesh.group("sp")
        acc0, bara = initial_accumulator(lwe, params, mu)
        start = mesh.index("sp") * n_local
        acc = acc0[..., start:start + n_local].contiguous()
        for i in range(bk.shape[0]):
            acc = _external_product_step_sp(acc, bara[:, i], bk[i], params,
                                            group)
        # the disjoint slices gathered back (JAX sums them, scattered
        # into zeros, for a shard_map check; the arrays are the same)
        acc = all_gather_cat(acc, group, dim=-1)
        return keyswitch(sample_extract(acc, params), ks_limbs, params)

    return fn


def shard_cloud_key(dck: DeviceCloudKey, mesh: Mesh) -> tuple:
    """This rank's tp slices of the key, on its device: ``bk`` on its
    TRGSW-rows axis (axis 1) and ``ks_limbs`` on its contraction axis
    (axis 1; never the padded output axis)."""
    tp, r = mesh.shape["tp"], mesh.index("tp")
    rows = dck.bk.shape[1] // tp
    k = dck.ks_limbs.shape[1] // tp
    bk = dck.bk[:, r * rows:(r + 1) * rows]
    ks = dck.ks_limbs[:, r * k:(r + 1) * k]
    return (bk.contiguous().to(mesh.device),
            ks.contiguous().to(mesh.device))


def shard_batch(lwe: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's dp slice of the batch (axis 0), on its device; raises
    ``ValueError`` where dp does not divide the batch."""
    dp = mesh.shape["dp"]
    if lwe.shape[0] % dp:
        raise ValueError(f"batch {lwe.shape[0]} not divisible by dp={dp}")
    b = lwe.shape[0] // dp
    r = mesh.index("dp")
    return lwe[r * b:(r + 1) * b].contiguous().to(mesh.device)
