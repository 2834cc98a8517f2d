"""The bare tensor-core matmul rate: int8 and bf16 TOP/s of one product.

Counterpart of ``tools/mosaic_mm_probe.py``: what rate does a matrix
product written by hand reach with its operands kept on chip?  The
external product's int8 tensor-core form would run at this rate.  The
probe sums ``grid`` products of one A (m, k) by one B (k, n) into one
accumulator, (s8, s8) -> s32 and (bf16, bf16) -> f32, through the two
kernels of ``csrc/mm_probe.cu`` (:func:`~ieache_tpu_torch.ops.kernels.
mm_s8`, :func:`~ieache_tpu_torch.ops.kernels.mm_bf16`; ``mma.sync`` on
operands kept in shared memory over all passes when a block's rows
fit there, else re-staged from the L2 cache on every pass), and prints
one JSON
line with, per type, the seconds per call (CUDA events around ``iters``
calls after a warm-up) and the rate grid·2·m·k·n / s in TOP/s.  Run from
the root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.mosaic_mm_probe

Env: PM_M/PM_K/PM_N (1024; multiples of 128), PM_G (passes, 512), PM_DT
(s8|bf16|both).  A failed kernel raises; nothing falls back to the
plain twins.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools._common import card_line, events_ms, require_cuda

#: PM_DT value -> (JSON key, kernel wrapper)
TYPES = {"s8": ("s8s8_s32", kernels.mm_s8),
         "bf16": ("bf16_f32", kernels.mm_bf16)}


def make_inputs(m: int, k: int, n: int, device, seed: int = 0) -> dict:
    """The JAX probe's operands, drawn in its order from its seed:
    PM_DT value -> (a (m, k), b (k, n)) on ``device``."""
    rng = np.random.RandomState(seed)
    a8 = rng.randint(-128, 128, (m, k)).astype(np.int8)
    b8 = rng.randint(-128, 128, (k, n)).astype(np.int8)
    abf = rng.randn(m, k).astype(np.float32)
    bbf = rng.randn(k, n).astype(np.float32)
    return {
        "s8": (torch.from_numpy(a8).to(device),
               torch.from_numpy(b8).to(device)),
        "bf16": (torch.from_numpy(abf).to(device, torch.bfloat16),
                 torch.from_numpy(bbf).to(device, torch.bfloat16)),
    }


def extreme_inputs(m: int, k: int, n: int, device) -> tuple:
    """int8 operands whose product is as large as it can be: a all -128,
    b all -128 but for odd columns of 127, so every entry of a @ b is
    +-k * 2^14 (about) and a few passes overflow int32."""
    a = torch.full((m, k), -128, dtype=torch.int8, device=device)
    b = torch.full((k, n), -128, dtype=torch.int8, device=device)
    b[:, 1::2] = 127
    return a, b


def selected(which: str) -> list:
    """The PM_DT value's types, in the JAX probe's order."""
    if which == "both":
        return list(TYPES)
    if which not in TYPES:
        raise ValueError(f"PM_DT must be s8|bf16|both, got {which!r}")
    return [which]


def run(m: int, k: int, n: int, g: int, which: str, device,
        iters: int = 8) -> dict:
    """The probe's record on a CUDA ``device``."""
    inputs = make_inputs(m, k, n, device)
    out = {"probe": "mosaic_mm_rate", "m": m, "k": k, "n": n, "grid": g}
    for dt in selected(which):
        key, mm = TYPES[dt]
        a, b = inputs[dt]
        s = events_ms(lambda: mm(a, b, g), iters) / 1e3
        tops = g * 2 * m * k * n / s / 1e12
        out[key] = {"s": s, "tops": tops}
        print(f"# {key}: {tops:.1f} TOPS", file=sys.stderr, flush=True)
    return out


def main() -> int:
    device = require_cuda("mosaic_mm_probe")
    out = run(int(os.environ.get("PM_M", 1024)),
              int(os.environ.get("PM_K", 1024)),
              int(os.environ.get("PM_N", 1024)),
              int(os.environ.get("PM_G", 512)),
              os.environ.get("PM_DT", "both"), device)
    out["device"] = torch.cuda.get_device_name(device)
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
