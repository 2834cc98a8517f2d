"""Time one negacyclic rotation per step in both accumulator layouts.

Counterpart of ``tools/transposed_probe.py``: the rotation X^a·acc with
per-batch amounts, the first half of every CMux step, costs what in the
(k+1, B, N) layout (``split`` and the fused modes) and in the
transposed (k+1, N, B) layout (``tr``)?  The probe runs ``steps``
rotations of one (2, B, 1024) int32 accumulator in each layout, through
the two kernels of ``csrc/rotate_probe.cu`` (:func:`~ieache_tpu_torch.
ops.kernels.rotate_lane`, :func:`~ieache_tpu_torch.ops.kernels.
rotate_sublane`), and prints one JSON line with the device ms per step
of each (one CUDA graph of the ``steps`` launches, replayed ``iters``
times between CUDA events), the wrapping int32 checksum of each result,
and whether the two checksums match (the same rotation on the same data
must give the same sum).  Run from the root of a checkout, on a CUDA
device:

    python -m ieache_tpu_torch.tools.transposed_probe

Env: TP_B (2048), TP_STEPS (200), TP_ITERS (8).  A failed kernel
raises; nothing falls back to the plain twins.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools._common import card_line, graph_ms, require_cuda

N, KP1 = 1024, 2

#: JSON key -> the rotation in that layout: (k+1, B, N), (k+1, N, B)
LAYOUTS = {"lane_rolls_kpl_B_N": kernels.rotate_lane,
           "sublane_rolls_kpl_N_B": kernels.rotate_sublane}


def make_inputs(b: int, steps: int, device, n: int = N, kp1: int = KP1,
                seed: int = 0):
    """The JAX probe's inputs: acc (k+1, B, N), the same values as
    (k+1, N, B), and amounts (steps, B) in [0, 2N)."""
    rng = np.random.RandomState(seed)
    acc = torch.from_numpy(
        rng.randint(-2**31, 2**31, (kp1, b, n)).astype(np.int32)).to(device)
    bara = torch.from_numpy(
        rng.randint(0, 2 * n, (steps, b)).astype(np.int32)).to(device)
    return acc, acc.transpose(1, 2).contiguous(), bara


def rotate_steps(rotate, acc: torch.Tensor, bara: torch.Tensor):
    """``acc`` rotated by each row of ``bara`` in turn."""
    for s in range(bara.shape[0]):
        acc = rotate(acc, bara[s])
    return acc


def checksum(acc: torch.Tensor) -> int:
    """The wrapping int32 sum of ``acc``, as an unsigned 32-bit int."""
    return int(acc.sum(dtype=torch.int64)) & 0xFFFFFFFF


def run(b: int, steps: int, iters: int, device) -> dict:
    """The probe's record on a CUDA ``device``."""
    acc, acc_t, bara = make_inputs(b, steps, device)
    out = {"probe": "transposed_rotation", "b": b, "steps": steps, "n": N}
    for (key, rotate), acc0 in zip(LAYOUTS.items(), (acc, acc_t)):
        total = checksum(rotate_steps(rotate, acc0, bara))
        ms = graph_ms(lambda: rotate_steps(rotate, acc0, bara), 1,
                      replays=iters) / steps
        out[key] = {"ms_per_step": ms, "checksum": total}
        print(f"# {key}: {ms:.4f} ms/step", file=sys.stderr, flush=True)
    out["checksums_match"] = (out["lane_rolls_kpl_B_N"]["checksum"]
                              == out["sublane_rolls_kpl_N_B"]["checksum"])
    return out


def main() -> int:
    device = require_cuda("transposed_probe")
    b = int(os.environ.get("TP_B", 2048))
    steps = int(os.environ.get("TP_STEPS", 200))
    iters = int(os.environ.get("TP_ITERS", 8))
    out = run(b, steps, iters, device)
    out["device"] = torch.cuda.get_device_name(device)
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return 0 if out["checksums_match"] else 1


if __name__ == "__main__":
    sys.exit(main())
