"""Pipeline parallelism for expression chains.

Counterpart of :mod:`ieache_tpu.dist.pipeline`.  A chain ``v0 (op0) v1
(op1) v2 ...`` of S ops is laid across a one-axis ``pp`` mesh of S
ranks: stage ``s`` holds operand ``s+1`` (and its per-lane add/sub
flags) and applies ``flow <- flow ± operand`` with the fused ripple
adder, or the carry-save multiply's low W bits; the flowing partial
result goes from rank to rank by ``send``/``recv`` (the JAX package's
``ppermute``).  The batch is split into ``n_micro`` microbatches,
GPipe-style: after an S-1-microbatch fill, every stage works on its own
microbatch, so a chain's serial dependency no longer serialises the
ranks.

The gate sequence per lane is that of the fused adders and multiplies
run back to back on one device, so the outputs are the unpipelined
chain's arrays (:func:`chain_unpipelined`).  The JAX package computes
every stage at every tick and throws the fill and drain bubbles' outputs
away; here a stage computes only its S live microbatches, and the
recorded arrays are the same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ieache_tpu_torch.boot import gates
from ieache_tpu_torch.boot.bootstrap import DeviceCloudKey
from ieache_tpu_torch.circuits import fused
from ieache_tpu_torch.dist.mesh import Mesh
from ieache_tpu_torch.params import TFHEParams


def make_pp_mesh(n_stages: int) -> Mesh:
    """One-axis (pp,) mesh over the first ``n_stages`` ranks."""
    world = dist.get_world_size()
    if n_stages > world:
        raise ValueError(f"need {n_stages} ranks for {n_stages} stages, "
                         f"have {world}")
    return Mesh({"pp": n_stages})


def _stage(op: str, flow: torch.Tensor, y: torch.Tensor, comp: torch.Tensor,
           dck: DeviceCloudKey) -> torch.Tensor:
    """One stage on a (micro)batch: ``flow ± y`` per lane by ``comp`` (0
    adds, nonzero subtracts: NOT(y) with carry-in 1) for ``'+'``, the
    low W bits of ``flow * y`` for ``'*'``."""
    if op == "*":
        return fused.schoolbook_mul_csa(flow, y, dck)[:, :flow.shape[1]]
    y = torch.where((comp != 0)[:, None, None], gates.NOT(y), y)
    out, _ = fused.ripple_add(flow, y, gates.CONSTANT(comp, dck.params.n),
                              dck)
    return out


def _stage_ops(stage_ops, n_stages: int) -> tuple:
    stage_ops = tuple(stage_ops or ("+",) * n_stages)
    if len(stage_ops) != n_stages:
        raise ValueError(f"{len(stage_ops)} stage_ops for {n_stages} stages")
    if any(o not in ("+", "*") for o in stage_ops):
        raise ValueError(f"stage_ops must be '+'/'*', got {stage_ops}")
    return stage_ops


def make_pipelined_chain(mesh: Mesh, params: TFHEParams, n_micro: int,
                         stage_ops=None):
    """The pipelined chain evaluator, ``fn(flow0, operands, comps, bk,
    ks_limbs) -> result``, called by every rank of ``mesh``:

    * ``flow0``    (B, W, n+1) int32: operand 0's word (B must divide by
      ``n_micro``);
    * ``operands`` (S, B, W, n+1) int32: operand s+1's word for stage s
      (a rank reads only its own stage's);
    * ``comps``    (S, B) int32: per stage and lane, 0 for ``flow +
      operand``, nonzero for ``flow - operand`` (ignored by ``'*'``
      stages);
    * ``bk``/``ks_limbs``: the evaluation key.

    ``stage_ops`` gives each stage ``'+'`` (add/sub by ``comps``) or
    ``'*'`` (low-W carry-save product), all ``'+'`` by default; a rank
    runs only its own stage's.  Returns the (B, W, n+1) chain value mod
    2^W on every rank (broadcast from the last stage).
    """
    n_stages = mesh.shape["pp"]
    stage_ops = _stage_ops(stage_ops, n_stages)

    def call(flow0, operands, comps, bk, ks_limbs):
        # the global shapes, which every rank is given
        if operands.shape[0] != n_stages:
            raise ValueError(
                f"chain has {operands.shape[0]} stages but the pp mesh axis "
                f"has {n_stages} ranks — they must match (one stage per "
                "rank)")
        if comps.shape[0] != n_stages:
            raise ValueError(f"comps has {comps.shape[0]} stages, expected "
                             f"{n_stages}")
        if flow0.shape[0] % n_micro:
            raise ValueError(f"batch {flow0.shape[0]} not divisible by "
                             f"n_micro={n_micro}")
        dev = mesh.device
        dck = DeviceCloudKey(bk.to(dev), ks_limbs.to(dev), params)
        s = mesh.index("pp")
        group = mesh.group("pp")
        mb = flow0.shape[0] // n_micro
        my_ops, my_comp = operands[s].to(dev), comps[s].to(dev)
        outbuf = torch.zeros(flow0.shape, dtype=torch.int32, device=dev)
        sends = []
        for m in range(n_micro):
            lanes = slice(m * mb, (m + 1) * mb)
            if s == 0:
                inp = flow0[lanes].to(dev)
            else:
                inp = torch.empty((mb,) + tuple(flow0.shape[1:]),
                                  dtype=torch.int32, device=dev)
                dist.recv(inp, src=dist.get_global_rank(group, s - 1),
                          group=group)
            out = _stage(stage_ops[s], inp, my_ops[lanes], my_comp[lanes],
                         dck)
            if s == n_stages - 1:
                outbuf[lanes] = out
            else:
                out = out.contiguous()
                sends.append((dist.isend(
                    out, dst=dist.get_global_rank(group, s + 1),
                    group=group), out))
        for work, _ in sends:
            work.wait()
        dist.broadcast(outbuf, src=dist.get_global_rank(group, n_stages - 1),
                       group=group)
        return outbuf

    return call


def chain_unpipelined(flow0, operands, comps, bk, ks_limbs,
                      params: TFHEParams, stage_ops=None) -> torch.Tensor:
    """The same chain on one device (the reference the pipeline is held
    to)."""
    dck = DeviceCloudKey(bk, ks_limbs, params)
    stage_ops = _stage_ops(stage_ops, operands.shape[0])
    out = flow0
    for s, op in enumerate(stage_ops):
        out = _stage(op, out, operands[s], comps[s], dck)
    return out
