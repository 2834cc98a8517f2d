"""Times of the kernels on the tensor-core tile, by batch.

``external_product`` and ``external_product_tr`` (ms per call with the
accumulator fused), ``rot_diff_decompose_tr`` (ms per call),
``cmux_step`` and ``cmux_step_overlap`` (ms per step; each the median of
three CUDA-graph replays of 50 calls) and ``blind_rotate_scan`` (ms per
whole rotation of n steps: the median of three runs of 3 calls between
CUDA events) at ``IEACHE_110_FAST`` or ``IEACHE_110`` on random operands
from seed 0, each first held against its plain twin (the scan kernel at
batches up to 16 only: its twin takes half a second a rotation).  One
JSON line with the card's name, power limit and clocks.  It is the
yardstick for a change to ``csrc/mma_tile.cuh`` or to the step kernels:
run it on two copies of the package within one call, and on a copy with
a part of the kernel taken out (the build of the byte planes, the MMAs,
the atomic adds, ``decompose_tile``, a phase of the scan kernel) to see
that part's share; such a copy computes garbage, so ``TB_CHECK=0`` skips
the comparison.  Run from the root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.tile_bench

Env: TB_PRODUCT_B (comma list, default ``8,16,1024``), TB_STEP_B (the
two fused steps and the tr pair, ``8,16,1024``), TB_SCAN_B (``8,1024``),
TB_PARAMS (ieache_110_l2, or ieache_110), TB_CHECK (1).
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools._common import (
    PARAMS,
    card_line,
    card_state,
    events_ms,
    graph_ms,
    require_cuda,
)

#: the largest batch at which the scan kernel is held against its twin
SCAN_CHECK_MAX_B = 16


def _rand(rng, shape, lo, hi, dtype, device):
    return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                            .astype(dtype)).to(device)


def product_inputs(p, b: int, device, rng):
    """d (rows, B, N) int8, bk_i (rows, k+1, N), acc (k+1, B, N)."""
    return (_rand(rng, (p.trgsw_rows, b, p.N), -128, 128, np.int8, device),
            _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                  device),
            _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device))


def scan_inputs(p, b: int, device, rng):
    """acc (k+1, B, N), bara (B, n), bk (n, rows, k+1, N)."""
    return (_rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device),
            _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, device),
            _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                  np.int32, device))


def step_inputs(p, b: int, device, rng):
    """acc (k+1, B, N), bara (B,), bk_i (rows, k+1, N)."""
    return (_rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device),
            _rand(rng, (b,), 0, 2 * p.N, np.int32, device),
            _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                  device))


def run(p, product_b, scan_b, device, check: bool = True,
        timed: bool = True, step_b=()) -> dict:
    """The record: ``external_product_ms``, ``cmux_step_ms``,
    ``cmux_step_overlap_ms``, ``blind_rotate_scan_ms``,
    ``rot_diff_decompose_tr_ms`` and ``external_product_tr_ms`` by batch.
    ``check`` holds each kernel against its twin first and raises where
    they differ; ``timed=False`` (the CPU rehearsal) only checks."""
    rng = np.random.RandomState(0)
    rec = {"params": p.name, "external_product_ms": {}, "cmux_step_ms": {},
           "cmux_step_overlap_ms": {}, "blind_rotate_scan_ms": {},
           "rot_diff_decompose_tr_ms": {}, "external_product_tr_ms": {}}
    for b in product_b:
        d, bk_i, acc = product_inputs(p, b, device, rng)
        if check and not torch.equal(
                kernels.external_product(d, bk_i, p, acc=acc),
                kernels.external_product_plain(d, bk_i, p, acc)):
            raise AssertionError(f"external_product differs from its twin "
                                 f"at B={b}")
        if timed:
            rec["external_product_ms"][b] = statistics.median(
                graph_ms(lambda: kernels.external_product(d, bk_i, p,
                                                          acc=acc), 50)
                for _ in range(3))
    for b in step_b:
        acc, bara, bk_i = step_inputs(p, b, device, rng)
        acc_tr = acc.transpose(1, 2).contiguous()            # (k+1, N, B)
        d_tr = kernels.rot_diff_decompose_tr_plain(acc_tr, bara, p)
        calls = {
            "cmux_step": (lambda: kernels.cmux_step(acc, bara, bk_i, p),
                          lambda: kernels.cmux_step_plain(acc, bara, bk_i, p)),
            "cmux_step_overlap": (
                lambda: kernels.cmux_step_overlap(acc, bara, bk_i, p),
                lambda: kernels.cmux_step_plain(acc, bara, bk_i, p)),
            "rot_diff_decompose_tr": (
                lambda: kernels.rot_diff_decompose_tr(acc_tr, bara, p),
                lambda: d_tr),
            "external_product_tr": (
                lambda: kernels.external_product_tr(d_tr, bk_i, p,
                                                    acc=acc_tr),
                lambda: kernels.external_product_tr_plain(d_tr, bk_i, p,
                                                          acc_tr))}
        for name, (kern, plain) in calls.items():
            if check and not torch.equal(kern(), plain()):
                raise AssertionError(f"{name} differs from its twin at "
                                     f"B={b}")
            if timed:
                rec[name + "_ms"][b] = statistics.median(
                    graph_ms(kern, 50) for _ in range(3))
    for b in scan_b:
        acc, bara, bk = scan_inputs(p, b, device, rng)
        if check and b <= SCAN_CHECK_MAX_B and not torch.equal(
                kernels.blind_rotate_scan(acc, bara, bk, p),
                kernels.blind_rotate_scan_plain(acc, bara, bk, p)):
            raise AssertionError(f"blind_rotate_scan differs from its twin "
                                 f"at B={b}")
        if timed:
            rec["blind_rotate_scan_ms"][b] = statistics.median(
                events_ms(lambda: kernels.blind_rotate_scan(acc, bara, bk, p),
                          3)
                for _ in range(3))
    return rec


def main() -> int:
    device = require_cuda("tile_bench")

    def env(name, default):
        return os.environ.get("TB_" + name, default)

    def batches(name, default):
        return [int(x) for x in env(name, default).split(",") if x.strip()]

    rec = run(PARAMS[env("PARAMS", "ieache_110_l2")],
              batches("PRODUCT_B", "8,16,1024"), batches("SCAN_B", "8,1024"),
              device, check=env("CHECK", "1") != "0",
              step_b=batches("STEP_B", "8,16,1024"))
    print(json.dumps({**rec, "device": torch.cuda.get_device_name(device),
                      "card": card_line(), "card_state": card_state()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
