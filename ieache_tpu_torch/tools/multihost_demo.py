"""Multi-host worker: a dp-sharded gate evaluated across OS processes.

Counterpart of ``tools/multihost_demo.py``.  One process a host (one
rank), joined through :func:`ieache_tpu_torch.dist.multihost.initialize`
on a TCP store (the replacement for the reference's six-host TCP
topology): each host encrypts the whole gate batch from the shared
seed, keeps its own slice, the packed key is broadcast from rank 0, the
batched AND gate runs on every rank's slice, and each host decrypts and
checks its own.  Run once per process:

    python -m ieache_tpu_torch.tools.multihost_demo <process_id> \\
        <num_processes> <port> [--device cuda|cpu] [--host 127.0.0.1]

``--device cuda`` (the default) puts the rank on this host's card, NCCL
between hosts; ``cpu`` runs gloo (the tests' two local processes).
Env: MH_BATCH (global batch, default 16).  Prints ``MH_OK pid=<id>
ranks=<n> local=<lanes> errors=<wrong lanes>`` and exits 1 on an error.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ieache_tpu_torch import keygen, prng
from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.dist import multihost
from ieache_tpu_torch.lwe import encrypt


def run(pid: int, nproc: int, device, batch: int = 16) -> int:
    """This rank's wrong lanes of the AND gate, inside an initialized
    process group of ``nproc`` ranks."""
    if batch % nproc:
        raise ValueError(f"MH_BATCH {batch} not divisible by {nproc} ranks")
    local = batch // nproc
    # a deterministic keygen gives every host the same keyset; the
    # cloud key is broadcast from rank 0 all the same (the reference's
    # key fan-out, C15/C16)
    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    mesh = multihost.global_mesh(tp=1)
    dck = multihost.replicate_cloud_key(
        bootstrap.pack_cloud_key(ks.cloud, device), mesh)

    stream = prng.key_from_seed_words([0x34, batch])
    xbits = prng.uniform_bits01(prng.derive(stream, 0), batch)
    ybits = prng.uniform_bits01(prng.derive(stream, 1), batch)
    sl = slice(pid * local, (pid + 1) * local)
    gx, gy = (multihost.shard_global_batch(
        encrypt.encrypt_bits(ks, bits, prng.derive(stream, i), "cpu")[sl],
        mesh) for i, bits in ((2, xbits), (3, ybits)))
    out = multihost.to_host_local(gates.AND(gx, gy, dck), mesh)
    got = encrypt.decrypt_bits(ks, out)
    return int(np.sum(got != (np.asarray(xbits) & np.asarray(ybits))[sl]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (this host's card, NCCL) or cpu (gloo)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="the host of rank 0's TCP store")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("multihost_demo: no CUDA device; --device cuda "
                         "needs one and does not fall back to the CPU")
    torch.set_num_threads(1)
    device = multihost.initialize(f"{args.host}:{args.port}",
                                  args.num_processes, args.process_id,
                                  platform=args.device)
    batch = int(os.environ.get("MH_BATCH", 16))
    try:
        errors = run(args.process_id, args.num_processes, device, batch)
        print(f"MH_OK pid={args.process_id} ranks={dist.get_world_size()} "
              f"local={batch // args.num_processes} errors={errors}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
