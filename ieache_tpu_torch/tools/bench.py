"""Headline benchmark of the port: TFHE gate bootstraps/s on one card.

Counterpart of ``bench.py``, on the same workload: NAND on a batch of
random bit pairs (seed words ``[2026]``) at ``IEACHE_110_FAST``, keys
from the device keygen (the keyset ``bench.py`` caches in
``.keycache/``, array for array).  After one warm-up call (which builds
the kernels) it times ``BENCH_ITERS`` calls, :data:`REPEATS` times (host
clock, ``torch.cuda.synchronize`` fences), decrypts the last result and
prints ONE JSON line with ``bench.py``'s fields: ``value`` is the median
rate over the repeats, ``seconds`` the median repeat's, ``vs_baseline``
value / 40 (the reference's ~40 gate bootstraps/s a core); beside them
the min, max and every repeat's rate, and ``backend``, ``step_mode`` and
``card``.  Run from the root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.bench

Env: BENCH_PARAMS (fast = ieache_110_l2, the default; l3 or ieache_110;
tiny), BENCH_BATCH (1024; 64 for tiny), BENCH_ITERS (16).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

from ieache_tpu_torch import params as P
from ieache_tpu_torch import prng
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.lwe import encrypt, keygen_device
from ieache_tpu_torch.tools._common import line_fields, require_cuda, sync

#: BENCH_PARAMS names
PARAMS = {"fast": P.IEACHE_110_FAST, "l3": P.IEACHE_110,
          "ieache_110": P.IEACHE_110, "tiny": P.TEST_TINY}

#: timed repeats of BENCH_ITERS calls each
REPEATS = 5


def run(p, batch: int, iters: int, device, repeats: int = REPEATS) -> dict:
    """The benchmark's record on ``device``."""
    ks = keygen_device.generate_secret_keyset_device(p, device)
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    stream = prng.key_from_seed_words([2026])
    xbits = prng.uniform_bits01(prng.derive(stream, 0), batch)
    ybits = prng.uniform_bits01(prng.derive(stream, 1), batch)
    cx = encrypt.encrypt_bits_device(ks, xbits, prng.derive(stream, 2),
                                     device)
    cy = encrypt.encrypt_bits_device(ks, ybits, prng.derive(stream, 3),
                                     device)

    out = gates.NAND(cx, cy, key)  # build + warm-up
    sync(device)
    seconds = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = gates.NAND(cx, cy, key)
        sync(device)
        seconds.append(time.perf_counter() - t0)

    got = encrypt.decrypt_bits(ks, out)
    errors = int((got != 1 - (xbits & ybits)).sum())
    rates = [batch * iters / s for s in seconds]
    value = statistics.median(rates)
    return {
        "metric": "gate_bootstraps_per_sec_per_chip",
        "value": round(value, 2),
        "unit": "bootstraps/s",
        "vs_baseline": round(value / 40.0, 2),
        "batch": batch,
        "iters": iters,
        "seconds": round(statistics.median(seconds), 3),
        "decrypt_errors": errors,
        "params": p.name,
        "median": round(value, 2),
        "min": round(min(rates), 2),
        "max": round(max(rates), 2),
        "repeats": [round(r, 2) for r in rates],
        **line_fields(device),
    }


def main() -> int:
    device = require_cuda("bench")
    pname = os.environ.get("BENCH_PARAMS", "fast")
    if pname not in PARAMS:
        raise SystemExit(f"BENCH_PARAMS must be one of {list(PARAMS)}, "
                         f"got {pname!r}")
    batch = int(os.environ.get("BENCH_BATCH",
                               64 if pname == "tiny" else 1024))
    iters = int(os.environ.get("BENCH_ITERS", 16))
    print(json.dumps(run(PARAMS[pname], batch, iters, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
