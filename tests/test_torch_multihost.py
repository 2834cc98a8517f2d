"""Multi-host smoke test of the port: two OS processes on one TCP store.

Counterpart of tests/test_multihost.py (``jax.distributed`` over two
processes): ``python -m ieache_tpu_torch.tools.multihost_demo`` twice,
as ranks 0 and 1 of a gloo process group joined through
``dist/multihost.initialize``; the key is broadcast from rank 0, a
dp-sharded batched AND gate runs on each rank's slice and each rank
decrypts and checks its own.  It costs a few seconds, so it stays in
tier-1 (the JAX test is marked slow).
"""

import os
import subprocess
import sys

from ieache_tpu_torch.dist import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_dp_sharded_gate(tmp_path):
    port = launch.free_port()
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ieache_tpu_torch.tools.multihost_demo",
         str(i), "2", str(port), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {i}:\n{out}"
            assert f"MH_OK pid={i} ranks=2 local=8 errors=0" in out, out
    finally:
        for p in procs:
            p.kill()
