"""Per-step cost of each step mode of the port's blind rotation.

Counterpart of ``tools/step_bench.py``.  For each step mode it runs an
ST_STEPS-step blind rotation (:func:`~ieache_tpu_torch.ops.blind_rotate.
blind_rotate` under ``IEACHE_PALLAS_STEP=mode``, so exactly what the
bootstrap dispatches, entry and exit transposes included) on random
inputs from seed 7, and prints one JSON line per mode: ms per step
(host clock around ST_ITERS calls, ``torch.cuda.synchronize`` fences),
``compile_s`` (the first call, which includes the kernel build), the
batch, steps, parameter set, projected bootstraps/s (B / (n * step
time)) and the wrapping int32 checksum of the result.  Every mode
computes the same rotation on the same inputs, so the checksums must
be equal; the summary line says whether they are, beside each mode's
speedup over ``split``, and the tool exits 1 when they are not.  Run
from the root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.step_bench

Env: ST_MODES (comma list, default all seven: split, fused2, overlap,
overlap2, scan, tr, ntt), ST_B (1024), ST_STEPS (128), ST_PARAMS
(ieache_110_l2, or ieache_110), ST_ITERS (8).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.tools._common import (
    PARAMS,
    card_line,
    environ,
    require_cuda,
    sync,
)


def make_inputs(p, b: int, steps: int, device, seed: int = 7):
    """acc0 (B, k+1, N), bara (B, steps) and bk (steps, rows, k+1, N),
    drawn as the JAX tool draws them."""
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    rng = np.random.RandomState(seed)
    acc = rng.randint(-2**31, 2**31, (kp1, b, n)).astype(np.int32)
    bara = rng.randint(0, 2 * n, (steps, b)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31, (steps, rows, kp1, n)).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (acc.transpose(1, 0, 2), bara.T, bk))


def bench_mode(mode: str, p, inputs, iters: int) -> dict:
    """One mode's record on the device ``inputs`` lie on."""
    acc0, bara, bk = inputs
    b, steps = bara.shape
    with environ("IEACHE_PALLAS_STEP", mode):
        t0 = time.perf_counter()
        out = br.blind_rotate(acc0, bara, bk, p)
        sync(acc0.device)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            out = br.blind_rotate(acc0, bara, bk, p)
        sync(acc0.device)
        dt = (time.perf_counter() - t0) / max(iters, 1) / steps
    return {"mode": mode, "ms_per_step": dt * 1e3, "compile_s": compile_s,
            "b": b, "steps": steps, "params": p.name,
            "proj_bootstraps_per_s": b / (p.n * dt),
            "checksum": int(out.sum(dtype=torch.int64)) & 0xFFFFFFFF}


def summary(records: list) -> dict:
    """Speedup over ``split`` (or the first mode) and whether every
    mode's checksum is equal."""
    times = {r["mode"]: r["ms_per_step"] for r in records}
    base = times.get("split") or next(iter(times.values()))
    return {"speedup_vs_split": {m: base / t - 1 for m, t in times.items()},
            "checksums_match": len({r["checksum"] for r in records}) == 1}


def run(modes, p, b: int, steps: int, iters: int, device, emit=None) -> list:
    """Each mode's record on ``device``, in order; ``emit`` is called
    with each record as it is made."""
    inputs = make_inputs(p, b, steps, device)
    records = []
    for mode in modes:
        rec = bench_mode(mode, p, inputs, iters)
        records.append(rec)
        if emit is not None:
            emit(rec)
    return records


def main() -> int:
    device = require_cuda("step_bench")

    def env(name, default):
        return os.environ.get("ST_" + name, default)

    p = PARAMS[env("PARAMS", "ieache_110_l2")]
    modes = [m.strip() for m in env("MODES", ",".join(br.STEP_MODES))
             .split(",")]
    kind, card = torch.cuda.get_device_name(device), card_line()
    records = run(modes, p, int(env("B", 1024)), int(env("STEPS", 128)),
                  int(env("ITERS", 8)), device,
                  emit=lambda r: print(json.dumps(
                      {**r, "device": kind, "card": card}), flush=True))
    summ = summary(records)
    print(json.dumps(summ), flush=True)
    return 0 if summ["checksums_match"] else 1


if __name__ == "__main__":
    sys.exit(main())
