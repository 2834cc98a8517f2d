"""Scaling benchmark: bootstraps/s at dp = 1, 2, 4, ... ranks.

Counterpart of ``tools/scaling_bench.py``.  Each gate bootstrap is
independent, so the batch scales by data parallelism; the losses are
dispatch and key replication.  One rank a card (``launch.run``): on one
H100 only dp=1 runs.  On the CPU the ranks are processes sharing the
host's cores, so their rates say nothing of a card: they are a
correctness record (errors 0 at every dp).

At each dp the first dp*tp*sp ranks form the mesh, encrypt NAND
operands of ``SB_BATCH_PER_CHIP`` lanes a rank and bootstrap them
``SB_ITERS`` times after a warm-up, between two fences; the rate is
the batch over the slowest rank's seconds.  SB_TP > 1 runs the
tp-sharded pipeline (``dist/shard.make_sharded_bootstrap``, one
all_reduce a step, SB_TP_CHUNKS its overlap chunks), SB_SP > 1 the
sp-sharded one (one all-gather a step); otherwise a NAND with the key
replicated.  Prints one JSON line per dp and a summary with the
efficiency at the largest dp; a dp line carries the kernel launches of
its ranks (warm-up included).  Run from the root of a checkout:

    python -m ieache_tpu_torch.tools.scaling_bench [--device cuda]

Env: SB_PARAMS (test_small_noisy, the default; test_tiny; ieache_110;
ieache_110_l2), SB_BATCH_PER_CHIP (256), SB_ITERS (4), SB_TP (1), SB_SP
(1), SB_TP_CHUNKS (2).  The ranks are the cards of this host, or
:data:`CPU_RANKS` on ``--device cpu`` (where the JAX tool forces 8
virtual devices).  The keyset is the main one of ``.keycache/``
(``<name>_.iek``, the file ``serve --keycache`` reads), written there
where absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from ieache_tpu_torch import files, prng
from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.dist import batch as dbatch
from ieache_tpu_torch.dist import launch
from ieache_tpu_torch.dist import mesh as dmesh
from ieache_tpu_torch.dist import shard as dshard
from ieache_tpu_torch.lwe import encrypt
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools._common import line_fields
from ieache_tpu_torch.utils.trace import sync

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the ranks of ``--device cpu``: processes sharing this host's cores
CPU_RANKS = 4

#: SB_PARAMS names
PARAMS = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
          "test_tiny": P.TEST_TINY, "test_small_noisy": P.TEST_SMALL_NOISY}


def dp_sizes(ranks: int, model: int) -> list:
    """The dp sizes a run of ``ranks`` covers at ``model`` ranks a
    replica (tp * sp)."""
    return [d for d in (1, 2, 4, 8, 16, 32) if d * model <= ranks]


def _scaling_rank(device, ks, per_chip, iters, sizes, tp, sp, chunks):
    """One rank: {dp: (seconds, wrong lanes, kernel launches)} for the
    meshes it is in."""
    p = ks.params
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    stream = prng.key_from_seed_words([0x5CA1E])
    got = {}
    for dp in sizes:
        m = (dshard.make_sp_mesh(dp * sp, sp=sp) if sp > 1
             else dmesh.make_mesh(dp * tp, tp=tp))
        if m.coordinate is not None:
            batch = per_chip * dp
            xb = prng.uniform_bits01(prng.derive(stream, 2 * dp), batch)
            yb = prng.uniform_bits01(prng.derive(stream, 2 * dp + 1), batch)
            cx, cy = (dshard.shard_batch(encrypt.encrypt_bits(
                ks, bits, prng.derive(stream, base + dp), device), m)
                for bits, base in ((xb, 100), (yb, 200)))
            pre = -cx - cy
            pre[:, p.n] += bootstrap.MU
            if sp > 1:
                boot_sp = dshard.make_sharded_bootstrap_sp(m, p)

                def step():
                    return boot_sp(pre, key.bk, key.ks_limbs)
            elif tp > 1:
                boot_tp = dshard.make_sharded_bootstrap(
                    m, p, overlap_chunks=chunks)
                bk, ksl = dshard.shard_cloud_key(key, m)

                def step():
                    return boot_tp(pre, bk, ksl)
            else:
                key_r = dbatch.replicate_cloud_key(key, m)

                def step():
                    return gates.NAND(cx, cy, key_r)

            before = kernels.launch_counts()
            sync(device)
            step()                                    # warm-up
            sync(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = step()
            sync(device)
            dt = time.perf_counter() - t0
            after = kernels.launch_counts()
            want = dshard.shard_batch(torch.from_numpy(1 - (xb & yb)), m)
            wrong = int((torch.from_numpy(encrypt.decrypt_bits(ks, out))
                         != want.cpu()).sum())
            got[dp] = (dt, wrong, {k: after[k] - before[k] for k in after
                                   if after[k] > before[k]})
        dist.barrier()
    return got


def run(p, per_chip: int, iters: int, ranks: int, device, tp: int = 1,
        sp: int = 1, chunks: int = 2, keycache: str | None = None) -> list:
    """The benchmark's records on ``ranks`` ranks of ``device``: one per
    dp size, then the summary."""
    if tp > 1 and sp > 1:
        raise ValueError("SB_TP and SB_SP are mutually exclusive")
    sizes = dp_sizes(ranks, tp * sp)
    if not sizes:
        raise ValueError(f"{ranks} ranks hold no replica of tp*sp = "
                         f"{tp * sp}")
    ks = files.cached_keyset(keycache or os.path.join(REPO, ".keycache"), p)
    per_rank = launch.run(_scaling_rank, ranks, ks, per_chip, iters, sizes,
                          tp, sp, chunks, device=torch.device(device).type)
    fields = line_fields(device)
    recs, rates = [], {}
    for dp in sizes:
        dts, wrongs, counts = zip(*(r[dp] for r in per_rank if dp in r))
        batch = per_chip * dp
        rates[dp] = batch * iters / max(dts)
        launches = {}
        for c in counts:
            for k, n in c.items():
                launches[k] = launches.get(k, 0) + n
        recs.append({"metric": "scaling_bootstraps_per_sec", "dp": dp,
                     "tp": tp, "sp": sp, "batch": batch,
                     "value": round(rates[dp], 1), "unit": "bootstraps/s",
                     "seconds": round(max(dts), 3), "errors": sum(wrongs),
                     "launches": launches, **fields})
    top = sizes[-1]
    eff = rates[top] / (rates[sizes[0]] * top / sizes[0])
    recs.append({"metric": "scaling_efficiency", "value": round(eff, 4),
                 "unit": "fraction", "dp_max": top,
                 "vs_baseline": round(eff / 0.8, 3), "params": p.name,
                 "note": "target >= 0.8 at 16 chips (BASELINE.md); CPU "
                         "ranks share one host's cores", **fields})
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank; no fallback) or cpu")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling_bench: no CUDA device; --device cuda "
                         "needs one and does not fall back to the CPU")

    def env(name, default):
        return os.environ.get("SB_" + name, default)

    ranks = (torch.cuda.device_count() if device.type == "cuda"
             else CPU_RANKS)
    for rec in run(PARAMS[env("PARAMS", "test_small_noisy")],
                   int(env("BATCH_PER_CHIP", 256)), int(env("ITERS", 4)),
                   ranks, device, tp=int(env("TP", 1)), sp=int(env("SP", 1)),
                   chunks=int(env("TP_CHUNKS", 2))):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
