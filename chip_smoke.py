#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ieache_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc``, and refuses to run without them.
The blind rotation has seven step modes (``IEACHE_PALLAS_STEP``), six
with their own kernels: ``split`` (rot_diff_decompose +
external_product per step), ``fused2`` (cmux_step), ``overlap`` and
``overlap2`` (cmux_step_overlap), ``scan`` (blind_rotate_scan, all
steps in one launch), ``tr`` (rot_diff_decompose_tr +
external_product_tr per step, in the transposed (k+1, N, B) layout);
all six run their products on the int8 tensor-core tile; ``ntt`` (the CRT-NTT step, plain PyTorch ops) launches no kernel.
``IEACHE_PALLAS`` = 0 (the plain step), interpret (the mode's plain
twins) or 1 (the kernels) reroutes the kernel modes.  Four more kernels
belong to the probe tools: rotate_lane and rotate_sublane
(``python -m ieache_tpu_torch.tools.transposed_probe``), mm_s8 and
mm_bf16 (``python -m ieache_tpu_torch.tools.mosaic_mm_probe``).  The
script imports nothing of the JAX package.  Phases, each printed on
lines of its own; any failure raises, so the script exits nonzero and
prints no result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels of ``ieache_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. each of the eleven kernels against its plain PyTorch twin: the nine
   integer kernels of the blind rotation and the rotation probe to
   exact equality, at IEACHE_110_FAST and the main path's batches
   (B=1024 for NAND, 8 and 16 for the rounds of ``A + B - C``), at
   ragged B in {1, 5, 1056} and at rotation amounts {0, 1, 2, 3, N,
   N+1, 2N-1, random} (every residue of the amount mod 4, on which the
   split rotation's runs of aligned quads turn); the scan kernel over
   all n=500 steps, its input accumulator unchanged, and at both
   parameter sets below over 1 to 4 steps (every phase of its turn
   through three buffers) at B in {8, 24, 256, 272}, either side of
   where its launch stops splitting a tile's sum; the five kernels on the
   int8 tensor-core tile (external_product, blind_rotate_scan, cmux_step,
   cmux_step_overlap, external_product_tr) and the tr rotation once more
   at IEACHE_110_FAST and at IEACHE_110 (6 TRGSW rows), B in {1, 5, 8,
   16, 1024, 1056}, with extreme operands beside random ones (digits all
   -128 or +127: for the step kernels and the tr pair an accumulator that
   decomposes to them at bara = N; key words whose int8 limbs are all
   -128 or +127, and the words where a carry between limbs goes wrong),
   the per-step kernels also at B = 256 and 257, either side of where
   their launches start to split a tile's sum over blocks;
   external_product at both parameter sets once more under every form
   and launch shape ``product_launch`` picks from (the mma.sync tile and
   the two wgmma tiles, each at its default split), through the uncounted
   entry, at those batches and B = 24 and 64, on random and extreme
   operands, with and without the accumulator;
   the rotation probe's
   kernels at its B=2048 and at B=5 and 16 (the sublane kernel's slab
   and its gather); the split rotation at every run length and block
   size and the sublane rotation by slab and by gather, whatever their
   launch policies pick, at B in {8, 256, 1024}, and both on an
   accumulator that is only 4-byte aligned; the keyswitch kernel
   (``csrc/keyswitch.cu``) at TEST_SMALL_NOISY and IEACHE_110, B in {1,
   32, 33, 1024, 1025}, under the policy's launch and every tile of
   ``keyswitch_launch_shapes``, on random words and on masks and keys of
   the extreme words, equal to ``keyswitch_plain``; mm_s8 (exact) and
   mm_bf16 at the
   matmul probe's (1024, 1024, 1024) with g in {1, 512} (the int32 sum
   wraps with extreme operands) and at four smaller shapes with k up
   to 4096, so that each type runs its three kernels, mm_bf16 to within
   MM_BF16_RTOL of the largest |o| of a float64 product of the same
   bf16 operands (its float32 sums run in another order than the
   twin's);
4. keygen: ``generate_secret_keyset_device`` on the card equal to the
   host keyset (from ``.keycache/`` or generated), every array, and
   ``encrypt_bits_device`` equal to host ``encrypt_bits`` on 1024
   bits.  Then a whole B=1024 bootstrap under each step mode against
   the plain path; under ``IEACHE_PALLAS`` = 0 and interpret (no kernel
   may launch) and 1 (the mode's kernels must launch), each under split
   and tr; the compat gadget's blind rotation (split's kernels at two
   digit rows a digit) at B=8 against ``plain=True``, and NAND at the
   compat gadget under split on 1024 random bit pairs from keys the
   device keygen made: ``decrypt_errors`` 0, 500 + 500 launches a wave,
   the NAND rate; and the blind
   rotation at N=32, which every mode's kernels refuse (each runs its
   products on the tensor-core tile), under every step mode (and under
   ``IEACHE_PALLAS=interpret``) against ``plain=True``: each must take
   the plain step and launch nothing;
5. main path, NAND under each step mode at IEACHE_110_FAST: NAND on
   1024 random bit pairs, decrypted on the host and on the card
   (``decrypt_bits_device``); ``decrypt_errors`` must be 0 both ways.
   Every launch count is reset just before a mode's run and read just
   after it: the mode's kernels must have launched, and no other (under
   ntt, none);
6. main path, ``A + B - C`` under ``split``, ``fused2`` and ``scan``
   (inside their mode's counted run): 16-bit signed words, 8 lanes, through
   ``ripple_add`` then ``ripple_sub``, and once through the fused
   ``add_then_sub``; ``A * B`` through ``fused.schoolbook_mul_csa`` on
   16-bit words, windowed and ``latency=True`` at 8 lanes and
   ``latency=True`` at 2 lanes (the Wallace tree); every lane must
   decrypt to the Python result;
7. timing, per mode: NAND bootstraps/s over 5 repeats (one repeat for
   a mode slower than 3 s a call) and, except under ntt, the
   latency of ``A + B - C`` (host clock, ``torch.cuda.synchronize``
   fences; one repeat for a mode slower than 3 s); ms per call of each
   per-step kernel beside its twin (CUDA events around a CUDA-graph
   replay, and around a plain Python loop), at B=1024 (the probe's
   rotations at B=2048) and, for the split pair, the two fused step
   kernels, the tr pair and the sublane rotation (its gather), at B=8
   and B=16 too (the result line gives external_product's at B=8, 16
   and 1024 beside their bounds and the form its launch took); ms per
   whole rotation
   of the scan kernel and its twin at B=8 and B=1024 (CUDA events
   around the call); the rotation probe (``transposed_probe``, its
   launch counts reset just before and read just after: the probe
   kernels' own path), the matmul probe (``mosaic_mm_probe``, counted
   the same way) with each mm kernel beside its twin and beside
   ``torch._int_mm`` / bf16 ``torch.matmul`` on the same operands g
   times; the keyswitch kernel's ms per call at B = 1, 33 and 1024
   beside its plain chain (the four ``torch._int_mm`` products it
   replaced: the library path) and its bound; and ``step_bench`` over
   all seven modes, each printing the
   tool's JSON line; the device keygen's seconds beside the host's;
   ``mul32`` at 32 lanes under split, once;
8. the evaluator (``circuits/evaluator.py``), the slice's own main path,
   at IEACHE_110_FAST on 16-bit operands, 8 lanes: under ``split``,
   ``fused2`` and ``scan`` (launch counts set to 0 just before each
   mode's run and read just after: the mode's kernels and no other), with
   the ripple and the parallel-prefix adder, ``A + B - C`` through
   ``compute_chain`` (lanes over every sign combination), ``A - B * C``
   through ``compute_steps``, multiply first, and ``B * C`` through
   ``compute`` (answer codes 0, 1, 2, 4 and 5 between them), every lane
   decrypted by ``decrypt_answer`` to the Python result, with the
   metadata round trips and ``decrypt_answer`` timed apart; one case of
   ``A + B - C`` and ``A - B * C`` on 6-bit operands (not 16: the plain
   step takes about half a second a wave) under ``IEACHE_PALLAS=0`` (no
   launch), its value word equal to split's; the per-lane widening of a
   chain (7+7 at 4 bits widened to 8 reads 14); the tools' lines from
   their ``run`` functions: ``bench`` (5 repeats), ``margin_probe``
   (B=2048; at least 7σ), ``width_bench`` ``mul32`` and ``add256``,
   ``expr_bench`` ``add_sub`` at B=256, each with 0 errors; and
   ``chain_memory_analysis`` of ``A * B * C`` at B=64 (it runs the chain
   between the card's peak-memory counters).  Every batch at which the
   phase calls a kernel (the lanes of each bootstrap wave: 2 to 2048)
   is recorded, and at the end of the phase each kernel is held to its
   plain twin at each of its batches (the rotation and the fused step
   at the amounts of phase 3, the external product with and without
   acc, the scan over all n steps);
9. the protocol (``mp/``, ``tools/e2e_bench.py``), the slice's own main
   path, at IEACHE_110_FAST: ``A + B - C`` and ``A - B * C`` on 16-bit
   operands, 8 lanes (every sign combination; no product of two
   negatives inside the chain), through the six-role flow in process
   (``mp/sim.py``: SAE key fan-out, BER job, operand pulls from the
   clients, the Cloud evaluating on the card, Output decrypting on the
   host) under ``split`` and ``scan``, launch counts set to 0 just
   before each flow and read just after (the mode's kernels and no
   other), every lane decrypted to the Python result, the Cloud's and
   the Output's spans printed; e2e_bench's expressions and operands (one
   lane at width 32) through the same flow under scan; then
   ``e2e_bench.run``: keygen, three clients and the Cloud as ``python -m
   ieache_tpu_torch.cli.main serve`` processes (the Cloud on the card
   under split and ``IEACHE_PALLAS=1``, so that a step that reaches no
   kernel raises; its spans carry its launches: split's kernels and no
   other), Output in this process, each expression cold and warm, every
   ``decrypt_ok`` true, its JSON line printed.  The keysets e2e_bench's
   keygen role loads are written to ``.keycache/`` from phase 8's
   device keygen where absent.  Every batch at which the in-process
   flows call a kernel is recorded (the lanes of a wave do not depend on
   the step mode, so the width-32 flow's are the Cloud process's), and
   split's and scan's kernels are held to their twins at each that
   phase 8 did not hold them at;
10. distribution and the key plane (``dist/``), the slice's own main
   path, at world size 1 on NCCL (one card gives one rank): this
   process joins a one-rank group; ``make_sharded_bootstrap`` and
   ``make_sharded_bootstrap_sp`` on (1, 1) meshes on the phase-5 NAND
   inputs, each equal to the unsharded ``bootstrap`` with 0 decrypt
   errors and no kernel launched (the tp and sp steps are plain ops, as
   in the JAX package); ``A + B - C`` (phase 8's operands) through
   ``dist/batch.py`` (key replicated, operands sharded, answer
   gathered) under split, its value word equal to phase 8's, split's
   kernels launched and no other; a one-stage pipelined chain at pp=1,
   ``n_micro=2``, equal to ``chain_unpipelined``; the kernels held to
   their twins at the batches these called them with; then
   ``dryrun_multichip(1)`` on a rank process of its own (every decrypt
   assert; each of split, tr and scan launching its kernels), its
   kernels held to their twins at TEST_TINY and its batches; the lines
   of ``keyplane_bench`` (its own process; the key plane at λ=110 for 1,
   2 and 3 clients, the Cloud's key unpacked on the card),
   ``scaling_bench`` at dp=1 (a rank process: NAND at B=1024, split's
   kernels) and ``comm_model``.

The next-to-last line is a JSON object with one entry per kernel
(route, source, the Pallas kernel it replaces, launches in its path,
max abs error against the twin, ms and plain ms per call: at B=1024,
B=2048 for the rotation probe's kernels, (1024, 1024, 1024) with g=512
for the matmul probe's; the least time the card could take for the
call, from its bytes over 3.35 TB/s or its operations over the
tensor-core peak, whichever is larger; and the ms of the one PyTorch
call that computes the same function, where there is one), and a
``keyswitch`` entry (its error and its times by batch); the last
line is ``{"ok": true, "device": {...}}``.  The secret keyset is cached
in ``.keycache/`` (the JAX package's bench writes the same file).
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ieache_tpu_torch import files, keygen, prng
from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.circuits import arith, evaluator, fused, words
from ieache_tpu_torch.core.poly import TORUS_LIMBS
from ieache_tpu_torch.dist import batch as dbatch
from ieache_tpu_torch.dist import dryrun, launch
from ieache_tpu_torch.dist import mesh as dmesh
from ieache_tpu_torch.dist import pipeline as ppl
from ieache_tpu_torch.dist import shard as dshard
from ieache_tpu_torch.lwe import encrypt, keygen_device
from ieache_tpu_torch.mp import sim
from ieache_tpu_torch.ops import _build, kernels, tile_models
from ieache_tpu_torch.ops import keyswitch as ksw
from ieache_tpu_torch.ops.blind_rotate import STEP_MODES, blind_rotate
from ieache_tpu_torch.tools import (
    bench,
    comm_model,
    e2e_bench,
    expr_bench,
    margin_probe,
    mosaic_mm_probe,
    scaling_bench,
    step_bench,
    tile_bench,
    transposed_probe,
    width_bench,
)
from ieache_tpu_torch.tools._common import (
    card_line,
    card_state,
    COLD_BYTES,
    cold_copies,
    environ,
    events_ms,
    graph_ms,
    graph_ms_cold,
    require_cuda,
    sync,
)

ROOT = os.path.dirname(os.path.abspath(__file__))

#: (name, source, the Pallas kernel it replaces)
KERNELS = [
    ("rot_diff_decompose", "ieache_tpu_torch/csrc/rot_diff_decompose.cu",
     "ieache_tpu/ops/pallas_kernels.py:856"),
    ("external_product", "ieache_tpu_torch/csrc/external_product.cu",
     "ieache_tpu/ops/pallas_kernels.py:61"),
    ("cmux_step", "ieache_tpu_torch/csrc/cmux_step.cu",
     "ieache_tpu/ops/pallas_kernels.py:285"),
    ("cmux_step_overlap", "ieache_tpu_torch/csrc/cmux_step_overlap.cu",
     "ieache_tpu/ops/pallas_kernels.py:600"),
    ("blind_rotate_scan", "ieache_tpu_torch/csrc/blind_rotate_scan.cu",
     "ieache_tpu/ops/pallas_kernels.py:420"),
    ("rot_diff_decompose_tr", "ieache_tpu_torch/csrc/rot_diff_decompose_tr.cu",
     "ieache_tpu/ops/pallas_kernels.py:1123"),
    ("external_product_tr", "ieache_tpu_torch/csrc/external_product_tr.cu",
     "ieache_tpu/ops/pallas_kernels.py:951"),
    ("rotate_lane", "ieache_tpu_torch/csrc/rotate_probe.cu",
     "tools/transposed_probe.py:62"),
    ("rotate_sublane", "ieache_tpu_torch/csrc/rotate_probe.cu",
     "tools/transposed_probe.py:96"),
    ("mm_s8", "ieache_tpu_torch/csrc/mm_probe.cu",
     "tools/mosaic_mm_probe.py:50"),
    ("mm_bf16", "ieache_tpu_torch/csrc/mm_probe.cu",
     "tools/mosaic_mm_probe.py:50"),
]

#: the kernels each step mode launches
MODES = kernels.MODE_KERNELS

#: the modes that also run A + B - C in the counted main path
EXPRESSION_MODES = ("split", "fused2", "scan")

#: the modes whose A + B - C latency phase 7 times: 96 rounds of B=8
#: bootstraps under ntt would take minutes
TIMED_EXPRESSION_MODES = ("split", "fused2", "overlap", "overlap2", "scan",
                          "tr")

#: the IEACHE_PALLAS routes phase 4 runs, and the modes it runs them under
ROUTES, ROUTE_MODES = ("0", "interpret", "1"), ("split", "tr")

#: a NAND batch at which the fused step and scan take their wgmma form
#: (at IEACHE_110_FAST step_launch's B = 257 .. 512, scan_launch's 272 ..
#: 512), and the
#: modes phases 5 and 7 run it under beside the main batch
WGMMA_NAND_B = 384
WGMMA_NAND_MODES = ("fused2", "scan")

#: the rotation probe's batch, and the sizes step_bench runs at here
PROBE_B = 2048
STEP_BENCH = {"b": 1024, "steps": 32, "iters": 2}

#: the matmul probe's (m, k, n, g) cases of phase 3: the first is the one
#: phase 7 times; between them they run the three kernels of each type
#: (resident on the wide tile up to k = 1024 for s8 and 512 for bf16, on
#: the narrow tile with k split over the warps up to twice that, an odd
#: number of k-steps a warp included, else streaming)
MM_CASES = ((1024, 1024, 1024, 512), (1024, 1024, 1024, 1),
            (128, 256, 384, 3), (256, 2048, 128, 2), (128, 1408, 128, 3),
            (128, 4096, 128, 2))

#: passes at which extreme int8 operands overflow int32 at k >= 128
MM_WRAP_G = 1100

#: mm_bf16's tolerance against a float64 product of the same bf16
#: operands, relative to the largest |o|: the float32 sums of g*k terms
#: run in another order than the twin's and the tensor core truncates
#: (under 1e-3 measured at g=512); a wrong fragment layout gives O(1)
MM_BF16_RTOL = 1e-2

#: the parameter sets and batches at which phase 3 holds the four kernels
#: on the tensor-core tile against their twins once more, and the batches
#: either side of where the per-step launches start to split a tile's sum
#: over blocks (8 N / 256 tiles of 16 rows below 132 SMs)
MMA_PARAMS = (P.IEACHE_110_FAST, P.IEACHE_110)
MMA_BATCHES = (1, 5, 8, 16, 1024, 1056)
MMA_SPLIT_EDGE = (256, 257)

#: the batches beside MMA_BATCHES and MMA_SPLIT_EDGE at which phase 3 holds
#: external_product to its twin under every launch shape: inside a 32-row
#: wgmma tile, and one 64-row tile
PRODUCT_BATCHES = (24, 64)

#: the batches at which phase 3 holds the keyswitch kernel to its twin:
#: one lane, the multiply's waves of 32 and 33, a batch wave and one past
#: it; and those at which phase 7 times it
KS_CHECK_BATCHES = (1, 32, 33, 1024, 1025)
KS_TIMED_BATCHES = (1, 33, 1024)

#: the batches and step counts at which phase 3 holds the scan kernel to
#: its twin once more: either side of where its launch stops splitting a
#: tile's sum into parts that add atomically (256 | 272), and 1 to 4
#: steps, every phase of the turn through its three buffers
SCAN_TURN_BATCHES = (8, 24, 256, 272)
SCAN_TURN_STEPS = (1, 2, 3, 4)

#: key words at which a carry between int8 limbs goes wrong: INT32_MIN,
#: -1, 2^31 - 1, 0x7F7F7F7F, 0x80808080 (limbs all -128), 0
EDGE_KEY_WORDS = (-2**31, -1, 2**31 - 1, 0x7F7F7F7F, 0x80808080 - 2**32, 0)

#: the small batches at which phase 7 times the per-step kernels
SMALL_BATCHES = (8, 16)

#: the per-step kernels phase 7 times at the small batches: the split pair
#: beside the two fused steps and the tr pair; and the probe's sublane
#: rotation, whose launch gathers there
SMALL_BATCH_KERNELS = ("rot_diff_decompose", "external_product", "cmux_step",
                       "cmux_step_overlap", "rot_diff_decompose_tr",
                       "external_product_tr", "rotate_sublane")


#: the rotations phase 7 also times with the L2 cold: (name, whether its
#: accumulator is (k+1, N, B), whether it runs at the probe's batch)
COLD_KERNELS = (("rot_diff_decompose", False, False),
                ("rot_diff_decompose_tr", True, False),
                ("rotate_lane", False, True),
                ("rotate_sublane", True, True))


def rot_amounts(n):
    """The fixed rotation amounts of phase 3 beside random ones: every
    residue mod 4 (0, 1, 2, 3), X^N = -1 and one past it, and 2N - 1."""
    return (0, 1, 2, 3, n, n + 1, 2 * n - 1)

#: a ring degree below the tensor-core tile's 64: the kernels refuse it and
#: the blind rotation takes the plain step
SMALL_N_PARAMS = P.TFHEParams(n=8, N=32, k=1, bg_bit=8, l=2, ks_basebit=4,
                              ks_t=4, lwe_noise_scale=0, tlwe_noise_scale=0,
                              name="small_n32")

#: published dense peaks of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


def log(*args):
    print(*args, flush=True)


def step_mode(mode):
    """Run a block under ``IEACHE_PALLAS_STEP=mode``."""
    return environ("IEACHE_PALLAS_STEP", mode)


def _rand(rng, shape, lo, hi, dtype, device):
    return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                            .astype(dtype)).to(device)


def _compare(name, got, want, errs, device, case):
    sync(device)
    if got.shape != want.shape:
        raise AssertionError(f"{name} at {case}: shape {tuple(got.shape)}, "
                             f"plain twin {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain twin at {case}: "
                             f"max abs err {err}")


def bara_cases(rng, p, b, device):
    """(name, bara (B,)): random amounts, then those of
    :func:`rot_amounts`."""
    yield "random", _rand(rng, (b,), 0, 2 * p.N, np.int32, device)
    for a in rot_amounts(p.N):
        yield a, torch.full((b,), a, dtype=torch.int32, device=device)


def check_kernels(p, device, batches, probe_batches=(PROBE_B, 5, 16),
                  seed=0, phase="phase 3"):
    """Phase 3: each kernel against its plain twin; returns max abs
    error per kernel (0 when all equal).  ``phase`` heads the lines it
    prints."""
    rng = np.random.RandomState(seed)

    def rand(shape, lo, hi, dtype):
        return _rand(rng, shape, lo, hi, dtype, device)

    def amounts(b):
        return bara_cases(rng, p, b, device)

    errs = {}
    for b in batches:
        acc = rand((p.k + 1, b, p.N), -2**31, 2**31, np.int32)
        acc_tr = acc.transpose(1, 2).contiguous()          # (k+1, N, B)
        bk_i = rand((p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32)
        for amount, bara in amounts(b):
            case = f"B={b} bara={amount}"
            _compare("rot_diff_decompose",
                     kernels.rot_diff_decompose(acc, bara, p),
                     kernels.rot_diff_decompose_plain(acc, bara, p),
                     errs, device, case)
            d_tr = kernels.rot_diff_decompose_tr(acc_tr, bara, p)
            _compare("rot_diff_decompose_tr", d_tr,
                     kernels.rot_diff_decompose_tr_plain(acc_tr, bara, p),
                     errs, device, case)
            want = kernels.cmux_step_plain(acc, bara, bk_i, p)
            for name in ("cmux_step", "cmux_step_overlap"):
                _compare(name, getattr(kernels, name)(acc, bara, bk_i, p),
                         want, errs, device, case)
            # the whole tr step against the step's twin
            _compare("external_product_tr",
                     kernels.external_product_tr(d_tr, bk_i, p, acc=acc_tr),
                     want.transpose(1, 2), errs, device, case + " (tr step)")
        d = rand((p.trgsw_rows, b, p.N), -128, 128, np.int8)
        d_tr = d.transpose(1, 2).contiguous()
        for fused in (False, True):
            a, a_tr = (acc, acc_tr) if fused else (None, None)
            _compare("external_product",
                     kernels.external_product(d, bk_i, p, acc=a),
                     kernels.external_product_plain(d, bk_i, p, a),
                     errs, device, f"B={b} acc={fused}")
            _compare("external_product_tr",
                     kernels.external_product_tr(d_tr, bk_i, p, acc=a_tr),
                     kernels.external_product_tr_plain(d_tr, bk_i, p, a_tr),
                     errs, device, f"B={b} acc={fused}")
        # the whole rotation; the edge amounts in the first three steps
        bara_n = rand((b, p.n), 0, 2 * p.N, np.int32)
        bara_n[:, :3] = torch.tensor([0, p.N, 2 * p.N - 1],
                                     dtype=torch.int32, device=device)
        bk = rand((p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                  np.int32)
        before = acc.clone()
        _compare("blind_rotate_scan",
                 kernels.blind_rotate_scan(acc, bara_n, bk, p),
                 kernels.blind_rotate_scan_plain(acc, bara_n, bk, p),
                 errs, device, f"B={b} steps={p.n}")
        if not torch.equal(acc, before):
            raise AssertionError(f"blind_rotate_scan wrote its input "
                                 f"accumulator at B={b}")
        log(f"{phase} kernels: {p.name} B={b} equal (rot amounts "
            f"random/0/1/2/3/N/N+1/2N-1 "
            f"for both rotations, cmux_step, cmux_step_overlap and the tr "
            f"step; both external products with and without acc; scan "
            f"over {p.n} steps)")
    for b in probe_batches:
        acc = rand((p.k + 1, b, p.N), -2**31, 2**31, np.int32)
        acc_tr = acc.transpose(1, 2).contiguous()
        for amount, bara in amounts(b):
            case = f"B={b} bara={amount}"
            _compare("rotate_lane", kernels.rotate_lane(acc, bara),
                     kernels.rotate_lane_plain(acc, bara), errs, device, case)
            _compare("rotate_sublane", kernels.rotate_sublane(acc_tr, bara),
                     kernels.rotate_sublane_plain(acc_tr, bara), errs,
                     device, case)
        log(f"{phase} probe kernels: B={b} equal (amounts "
            f"random/0/1/2/3/N/N+1/2N-1)")
    return errs


def check_rotation_launches(p, device, batches=(8, 256, 1024), seed=6):
    """Phase 3, the two redesigned rotations on every path their launches
    can take, against their twins: ``rot_diff_decompose`` at both run
    lengths and ``rotate_sublane`` by its slab and by its
    gather (``tile_bench.rotation_variants``: uncounted launches of the C
    entry points), at the amounts of :func:`rot_amounts` and random ones;
    then both wrappers on an accumulator that is only 4-byte aligned (no
    16-byte loads or copies).  Returns max abs error per kernel."""
    rng = np.random.RandomState(seed)
    errs = {"rot_diff_decompose": 0, "rotate_sublane": 0}
    for b in batches:
        acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device)
        acc_tr = acc.transpose(1, 2).contiguous()
        for amount in ("random", *rot_amounts(p.N)):
            bara = (_rand(rng, (b,), 0, 2 * p.N, np.int32, device)
                    if amount == "random" else
                    torch.full((b,), amount, dtype=torch.int32,
                               device=device))
            for name, (kern, plain) in tile_bench.rotation_variants(
                    p, acc, bara, acc_tr).items():
                kernel, shape = name.split(" ", 1)
                _compare(kernel, kern(), plain(), errs, device,
                         f"B={b} bara={amount} launch {shape}")
        for x, kern, plain, args in (
                (acc, kernels.rot_diff_decompose,
                 kernels.rot_diff_decompose_plain, (p,)),
                (acc_tr, kernels.rotate_sublane, kernels.rotate_sublane_plain,
                 ())):
            # the same words one word into a larger allocation
            off = torch.empty(x.numel() + 1, dtype=torch.int32,
                              device=device)[1:].view(x.shape)
            off.copy_(x)
            bara = _rand(rng, (b,), 0, 2 * p.N, np.int32, device)
            _compare(kern.__name__, kern(off, bara, *args),
                     plain(x, bara, *args), errs, device,
                     f"B={b} acc 4-byte aligned")
        log(f"phase 3 rotation launches: B={b} equal (rot_diff_decompose at "
            f"runs {tile_models.ROT_RUNS}, rotate_sublane by "
            f"slab and gather, amounts random/0/1/2/3/N/N+1/2N-1; both on "
            f"a 4-byte aligned accumulator)")
    return errs


def edge_key(shape, device):
    """An int32 key tensor of ``shape`` that runs through
    :data:`EDGE_KEY_WORDS` in turn."""
    edge = torch.tensor(EDGE_KEY_WORDS, dtype=torch.int32, device=device)
    idx = torch.arange(int(np.prod(shape)), device=device)
    return edge[idx % len(edge)].reshape(shape)


def extreme_operands(p, b, device, rng):
    """(name, digits (rows, B, N) int8, key step (rows, k+1, N) int32):
    every limb sum at its largest and smallest, then random digits on
    the key words of :data:`EDGE_KEY_WORDS` in turn."""
    shape_d = (p.trgsw_rows, b, p.N)
    shape_k = (p.trgsw_rows, p.k + 1, p.N)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    lo, hi = 0x80808080 - 2**32, 0x7F7F7F7F
    yield "d=-128 key limbs -128", full(shape_d, -128, torch.int8), \
        full(shape_k, lo, torch.int32)
    yield "d=+127 key limbs +127", full(shape_d, 127, torch.int8), \
        full(shape_k, hi, torch.int32)
    yield "d=-128 key limbs +127", full(shape_d, -128, torch.int8), \
        full(shape_k, hi, torch.int32)
    yield "random d, edge key words", \
        _rand(rng, shape_d, -128, 128, np.int8, device), \
        edge_key(shape_k, device)


def extreme_accumulators(p, b, device, rng):
    """(name, acc (k+1, B, N) int32, bara (B,), key step): accumulators
    whose step at bara = N decomposes to -128 and to +127 everywhere
    (checked here against the plain decomposition), on the key limbs
    that drive every limb sum to its ends; then a random accumulator on
    the key words of :data:`EDGE_KEY_WORDS` in turn."""
    shape_a = (p.k + 1, b, p.N)
    shape_k = (p.trgsw_rows, p.k + 1, p.N)
    at_n = torch.full((b,), p.N, dtype=torch.int32, device=device)
    lo, hi = 0x80808080 - 2**32, 0x7F7F7F7F
    for digit, limbs, limb in ((-128, lo, -128), (127, hi, 127),
                               (-128, hi, 127)):
        acc = tile_models.accumulator_for_digits(p, digit, shape_a, device)
        d = kernels.rot_diff_decompose_plain(acc, at_n, p)
        if int(d.min()) != digit or int(d.max()) != digit:
            raise AssertionError(f"the accumulator for digits {digit} "
                                 f"decomposes to [{int(d.min())}, "
                                 f"{int(d.max())}]")
        yield (f"digits {digit:+d} key limbs {limb:+d}", acc, at_n,
               torch.full(shape_k, limbs, dtype=torch.int32, device=device))
    yield ("random acc, edge key words",
           _rand(rng, shape_a, -2**31, 2**31, np.int32, device),
           _rand(rng, (b,), 0, 2 * p.N, np.int32, device),
           edge_key(shape_k, device))


def _resident(p, device, kernel):
    """``kernel``'s (cluster, clusters held at once) pairs at the
    policies' tile: the occupancy query's on the card, the H100's on the
    CPU (None)."""
    if device.type != "cuda":
        return None
    return kernels._wgmma_resident(device, kernel, p.trgsw_rows, p.k + 1,
                                   p.N)


def _card_sms(device):
    """The card's SMs, or the H100's on the CPU."""
    return kernels._sm_count(device) if device.type == "cuda" else 132


def check_scan_turns(p, device, batches=SCAN_TURN_BATCHES,
                     steps=SCAN_TURN_STEPS, seed=11):
    """Phase 3: blind_rotate_scan against its twin over the first
    ``steps`` steps of a random key (the edge amounts in the first three)
    at each of ``batches``, its input accumulator unchanged by the call;
    and, through the uncounted entry, under every launch shape
    scan_launch picks from there (its mma.sync form, and the wgmma form
    at each tile and cluster that fits).  Returns max abs error per
    kernel."""
    rng = np.random.RandomState(seed)
    errs = {}
    most = max(steps)
    sms = _card_sms(device)
    per_sm = (kernels._scan_per_sm(device, p.trgsw_rows, p.N)
              if device.type == "cuda" else 2)
    bk = _rand(rng, (most, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    for b in batches:
        acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device)
        bara = _rand(rng, (b, most), 0, 2 * p.N, np.int32, device)
        bara[:, :3] = torch.tensor([0, p.N, 2 * p.N - 1], dtype=torch.int32,
                                   device=device)
        shapes = tile_models.scan_launch_shapes(
            b, p.k + 1, p.N, p.trgsw_rows, sms, per_sm,
            _resident(p, device, "blind_rotate_scan"))
        for n in steps:
            args = (acc, bara[:, :n].contiguous(), bk[:n].contiguous())
            before = acc.clone()
            want = kernels.blind_rotate_scan_plain(*args, p)
            _compare("blind_rotate_scan", kernels.blind_rotate_scan(*args, p),
                     want, errs, device, f"{p.name} B={b} steps={n}")
            for shape, launch in shapes.items():
                got = tile_models.blind_rotate_scan_as(*args, p, launch)
                _compare("blind_rotate_scan", got, want, errs, device,
                         f"{p.name} B={b} steps={n} {shape}")
            if not torch.equal(acc, before):
                raise AssertionError(f"blind_rotate_scan wrote its input "
                                     f"accumulator at B={b} steps={n}")
        pick = kernels.scan_launch(b, p.k + 1, p.N, p.trgsw_rows, sms,
                                   per_sm,
                                   _resident(p, device, "blind_rotate_scan"))
        log(f"phase 3 scan turns: {p.name} B={b} blind_rotate_scan equal "
            f"over {'/'.join(map(str, steps))} steps under the policy (the "
            f"pick: {pick.form} {pick.tile} rows, cluster {pick.cluster}, "
            f"grid {pick.grid}) and under {', '.join(shapes)}, its input "
            f"unchanged")
    return errs


def step_crossovers(p, sms=132, resident=None, most=4096):
    """The batches up to ``most`` at which step_launch changes form at
    ``p`` (the first of the new form's)."""
    forms = [kernels.step_launch(b, p.k + 1, p.N, p.trgsw_rows, sms,
                                 resident=resident).form
             for b in range(1, most + 1)]
    return [b for b in range(2, most + 1) if forms[b - 1] != forms[b - 2]]


def check_step_launches(p, device, batches, seed=41):
    """Phase 3: cmux_step at ``p`` under every launch shape step_launch
    picks from at each of ``batches`` (the mma.sync form, and each wgmma
    tile in each cluster that fits), whatever the policy picks there,
    through the uncounted entry: random operands (the edge amounts first)
    and the extreme accumulators of :func:`extreme_accumulators`, each
    equal to the twin.  Returns max abs error."""
    rng = np.random.RandomState(seed)
    errs = {}
    sms = _card_sms(device)
    per_sm = (kernels._step_per_sm(device, p.trgsw_rows, p.N)
              if device.type == "cuda" else 2)
    for b in batches:
        bara = _rand(rng, (b,), 0, 2 * p.N, np.int32, device)
        bara[:3] = torch.tensor([0, p.N, 2 * p.N - 1], dtype=torch.int32,
                                device=device)[:b]
        cases = [("random",
                  _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32,
                        device), bara,
                  _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                        np.int32, device)),
                 *extreme_accumulators(p, b, device, rng)]
        shapes = tile_models.step_launch_shapes(b, p.k + 1, p.N, p.trgsw_rows,
                                                sms, per_sm)
        for name, a, bara_c, bk_i in cases:
            want = kernels.cmux_step_plain(a, bara_c, bk_i, p)
            for shape, launch in shapes.items():
                _compare("cmux_step",
                         tile_models.cmux_step_as(a, bara_c, bk_i, p, launch),
                         want, errs, device, f"{p.name} B={b} {name} {shape}")
        pick = kernels.step_launch(b, p.k + 1, p.N, p.trgsw_rows, sms, per_sm,
                                   _resident(p, device, "cmux_step"))
        log(f"phase 3 step launches: {p.name} B={b} cmux_step equal under "
            f"{', '.join(shapes)} (the pick: {pick.form} {pick.tile} x "
            f"{pick.cols}, split {pick.split}, cluster {pick.cluster}) on "
            f"random and {len(cases) - 1} extreme accumulator sets")
    return errs


def check_mma_kernels(p, device, batches, split_edge=MMA_SPLIT_EDGE, seed=5):
    """Phase 3, the five kernels on the tensor-core tile once more, at
    ``p``: external_product and external_product_tr on random and extreme
    operands, with and without acc, and cmux_step, cmux_step_overlap and
    the tr pair (rot_diff_decompose_tr, then external_product_tr with the
    accumulator) on random and extreme accumulators, at ``batches`` and
    (random only) at ``split_edge``; blind_rotate_scan over all n steps on
    a random key and on a key of edge words.  Returns max abs error per
    kernel."""
    rng = np.random.RandomState(seed)
    errs = {}
    for b in (*batches, *split_edge):
        acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device)
        cases = [("random",
                  _rand(rng, (p.trgsw_rows, b, p.N), -128, 128, np.int8,
                        device),
                  _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                        np.int32, device))]
        steps = [("random", acc,
                  _rand(rng, (b,), 0, 2 * p.N, np.int32, device),
                  cases[0][2])]
        if b in batches:
            cases += extreme_operands(p, b, device, rng)
            steps += extreme_accumulators(p, b, device, rng)
        acc_tr = acc.transpose(1, 2).contiguous()
        for name, d, bk_i in cases:
            d_tr = d.transpose(1, 2).contiguous()
            for a, a_tr in ((None, None), (acc, acc_tr)):
                case = f"{p.name} B={b} {name} acc={a is not None}"
                _compare("external_product",
                         kernels.external_product(d, bk_i, p, acc=a),
                         kernels.external_product_plain(d, bk_i, p, a),
                         errs, device, case)
                _compare("external_product_tr",
                         kernels.external_product_tr(d_tr, bk_i, p, acc=a_tr),
                         kernels.external_product_tr_plain(d_tr, bk_i, p,
                                                           a_tr),
                         errs, device, case)
        for name, a, bara, bk_i in steps:
            want = kernels.cmux_step_plain(a, bara, bk_i, p)
            for kern in ("cmux_step", "cmux_step_overlap"):
                _compare(kern, getattr(kernels, kern)(a, bara, bk_i, p), want,
                         errs, device, f"{p.name} B={b} {name}")
            # the tr pair as one step, and its rotation alone
            a_tr = a.transpose(1, 2).contiguous()
            d_tr = kernels.rot_diff_decompose_tr(a_tr, bara, p)
            _compare("rot_diff_decompose_tr", d_tr,
                     kernels.rot_diff_decompose_tr_plain(a_tr, bara, p), errs,
                     device, f"{p.name} B={b} {name}")
            _compare("external_product_tr",
                     kernels.external_product_tr(d_tr, bk_i, p, acc=a_tr),
                     want.transpose(1, 2), errs, device,
                     f"{p.name} B={b} {name} (tr step)")
        if b not in batches:
            continue
        bara = _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, device)
        shape = (p.n, p.trgsw_rows, p.k + 1, p.N)
        for name, bk in (
                ("random key", _rand(rng, shape, -2**31, 2**31, np.int32,
                                     device)),
                ("edge key words", edge_key(shape, device))):
            _compare("blind_rotate_scan",
                     kernels.blind_rotate_scan(acc, bara, bk, p),
                     kernels.blind_rotate_scan_plain(acc, bara, bk, p),
                     errs, device, f"{p.name} B={b} steps={p.n} {name}")
        log(f"phase 3 tensor-core tile: {p.name} ({p.trgsw_rows} rows) "
            f"B={b} equal (external_product and external_product_tr on "
            f"random and {len(cases) - 1} extreme operand sets, with and "
            f"without acc; cmux_step, cmux_step_overlap and the tr pair on "
            f"random and {len(steps) - 1} extreme accumulator sets; scan "
            f"over {p.n} steps on a random key and on edge key words)")
    log(f"phase 3 tensor-core tile: {p.name} external_product, "
        f"external_product_tr, cmux_step, cmux_step_overlap and the tr pair "
        f"equal at B={'/'.join(map(str, split_edge))}, either side of the "
        f"split")
    return errs


def check_product_launches(p, device, batches, seed=23):
    """Phase 3: external_product at ``p`` under every launch shape
    ``kernels.product_launch`` picks from at each of ``batches`` (the
    mma.sync tile and each wgmma tile, at its default split), whatever the
    policy picks there, through the uncounted entry: random operands and
    the extreme ones of :func:`extreme_operands`, with and without the
    accumulator, each equal to the twin.  Returns max abs error."""
    rng = np.random.RandomState(seed)
    errs = {}
    sms = kernels._sm_count(device) if device.type == "cuda" else 132
    for b in batches:
        acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device)
        cases = [("random",
                  _rand(rng, (p.trgsw_rows, b, p.N), -128, 128, np.int8,
                        device),
                  _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                        np.int32, device)),
                 *extreme_operands(p, b, device, rng)]
        shapes = tile_models.product_launch_shapes(b, p.k + 1, p.N,
                                                   p.trgsw_rows, sms)
        for name, d, bk_i in cases:
            for a in (None, acc):
                want = kernels.external_product_plain(d, bk_i, p, a)
                for shape, launch in shapes.items():
                    got = tile_models.external_product_as(d, bk_i, p, a,
                                                          launch)
                    _compare("external_product", got, want, errs, device,
                             f"{p.name} B={b} {name} acc={a is not None} "
                             f"{shape} split {launch.split}")
        pick = kernels.product_launch(b, p.k + 1, p.N, p.trgsw_rows, sms)
        log(f"phase 3 product launches: {p.name} B={b} external_product "
            f"equal under {', '.join(shapes)} (the pick: {pick.form} "
            f"{pick.tile} x {pick.cols}, split {pick.split}) on random and "
            f"{len(cases) - 1} extreme operand sets, with and without acc")
    return errs


def keyswitch_operands(p, b, device, rng):
    """(name, lwe_ext (B, kN+1) int32, packed key limbs): random words
    with the words of :data:`EDGE_KEY_WORDS` first, then masks and keys
    each all one edge word (a different one for the two), where every
    digit and every limb sum is at an extreme and the sums wrap."""
    shape_x, shape_k = (b, p.kN + 1), (p.kN * p.ks_t, p.n + 1)
    x = rng.randint(-2**31, 2**31, shape_x, dtype=np.int64).astype(np.int32)
    ks = rng.randint(-2**31, 2**31, shape_k, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[: len(EDGE_KEY_WORDS)] = EDGE_KEY_WORDS
    ks.reshape(-1)[: len(EDGE_KEY_WORDS)] = EDGE_KEY_WORDS
    yield "random", torch.from_numpy(x).to(device), \
        ksw.pack_ks_limbs(ks, device)
    for i, word in enumerate(EDGE_KEY_WORDS):
        key_word = EDGE_KEY_WORDS[(i + 1) % len(EDGE_KEY_WORDS)]
        yield (f"mask {word:#x} key {key_word:#x}",
               torch.full(shape_x, word, dtype=torch.int32, device=device),
               ksw.pack_ks_limbs(np.full(shape_k, key_word, np.int32),
                                 device))


def check_keyswitch(p, device, batches=KS_CHECK_BATCHES, seed=43):
    """Phase 3: the keyswitch kernel (``ops/keyswitch.keyswitch``, launched
    as ``kernels.keyswitch_launch`` says) and every tile of
    ``tile_models.keyswitch_launch_shapes`` through the uncounted entry, at
    ``p`` and each of ``batches``, on the operands of
    :func:`keyswitch_operands`, each equal to ``keyswitch_plain`` (on CPU
    tensors the wrapper is the twin and the tiles run the plain model).
    Returns max abs error."""
    rng = np.random.RandomState(seed)
    errs = {}
    sms = _card_sms(device)
    for b in batches:
        shapes = tile_models.keyswitch_launch_shapes(b, p, sms)
        cases = list(keyswitch_operands(p, b, device, rng))
        for name, x, limbs in cases:
            want = ksw.keyswitch_plain(x, limbs, p)
            _compare("keyswitch", ksw.keyswitch(x, limbs, p), want, errs,
                     device, f"{p.name} B={b} {name}")
            for shape, launch in shapes.items():
                _compare("keyswitch",
                         tile_models.keyswitch_as(x, limbs, p, launch), want,
                         errs, device, f"{p.name} B={b} {name} {shape}")
        log(f"phase 3 keyswitch: {p.name} B={b} equal to keyswitch_plain "
            f"under the pick ({kernels.keyswitch_launch(b, p, sms).form}) "
            f"and {', '.join(shapes)}, on random and {len(cases) - 1} "
            f"extreme operand sets")
    return errs


def check_mm_kernels(device, cases=MM_CASES):
    """Phase 3: mm_s8 equal to its twin (the int32 sum wrapping where g
    is large) and mm_bf16 within MM_BF16_RTOL of a float64 product,
    relative to its largest |o|; returns max abs error per kernel
    against the twin."""
    errs = {"mm_s8": 0, "mm_bf16": 0.0}
    for m, k, n, g in cases:
        ins = mosaic_mm_probe.make_inputs(m, k, n, device)
        case = f"(m, k, n)=({m}, {k}, {n}) g={g}"
        a, b = ins["s8"]
        _compare("mm_s8", kernels.mm_s8(a, b, g),
                 kernels.mm_s8_plain(a, b, g), errs, device, case)
        a, b = ins["bf16"]
        got = kernels.mm_bf16(a, b, g)
        twin = kernels.mm_bf16_plain(a, b, g)
        sync(device)
        ref = g * (a.double() @ b.double())
        scale = float(ref.abs().max())
        rel = {name: float((x.double() - ref).abs().max()) / scale
               for name, x in (("kernel", got), ("twin", twin))}
        errs["mm_bf16"] = max(errs["mm_bf16"],
                              float((got - twin).abs().max()))
        if got.shape != ref.shape or not max(rel.values()) <= MM_BF16_RTOL:
            raise AssertionError(
                f"mm_bf16 at {case}: relative error {rel} against float64, "
                f"tolerance {MM_BF16_RTOL}")
        log(f"phase 3 matmul probe kernels: {case}: mm_s8 equal; mm_bf16 "
            f"relative error {rel['kernel']:.3g} (twin {rel['twin']:.3g}), "
            f"tolerance {MM_BF16_RTOL}")
    # random operands never reach 2^31: the extreme ones pass 2^32
    m, k, n, _ = cases[0]
    a, b = mosaic_mm_probe.extreme_inputs(m, k, n, device)
    got = kernels.mm_s8(a, b, MM_WRAP_G)
    _compare("mm_s8", got, kernels.mm_s8_plain(a, b, MM_WRAP_G), errs, device,
             f"extreme operands g={MM_WRAP_G}")
    exact = MM_WRAP_G * k * 128 * 128          # column 0 of a @ b, g times
    want = ((exact + 2**31) % 2**32) - 2**31
    if exact < 2**31 or not bool((got[:, 0] == want).all()):
        raise AssertionError(f"mm_s8 did not wrap: {exact} should read "
                             f"{want}, got {got[:, 0].unique().tolist()}")
    log(f"phase 3 matmul probe kernels: extreme operands g={MM_WRAP_G}: "
        f"mm_s8 equal, {exact} wrapped to {want}")
    return errs


def keygen_vs_host(host_ks, device):
    """Keygen phase: the device keygen's keyset equal to the host
    keyset, every array; returns the device keygen's seconds."""
    t0 = time.perf_counter()
    dev_ks = keygen_device.generate_secret_keyset_device(host_ks.params,
                                                         device)
    sync(device)
    dt = time.perf_counter() - t0
    for name, got, want in (
            ("lwe_s", dev_ks.lwe_key.s, host_ks.lwe_key.s),
            ("trlwe_k", dev_ks.trlwe_key.coefs, host_ks.trlwe_key.coefs),
            ("bk", dev_ks.cloud.bk, host_ks.cloud.bk),
            ("ks", dev_ks.cloud.ks, host_ks.cloud.ks)):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"device keygen: {name} differs from the "
                                 f"host keyset")
    return dt


def encrypt_vs_host(ks, count, device, seed=11):
    """Keygen phase: encrypt_bits_device equal to host encrypt_bits on
    ``count`` bits, the result on ``device``, decrypting to the bits on
    the device; returns (device seconds, host seconds)."""
    stream = prng.key_from_seed_words([seed])
    bits = prng.uniform_bits01(prng.derive(stream, 0), count)
    t0 = time.perf_counter()
    got = encrypt.encrypt_bits_device(ks, bits, prng.derive(stream, 1),
                                      device)
    sync(device)
    t1 = time.perf_counter()
    want = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1), device)
    t2 = time.perf_counter()
    if got.device != device or not torch.equal(got, want):
        raise AssertionError("encrypt_bits_device differs from encrypt_bits")
    dec = encrypt.decrypt_bits_device(ks, got)
    if dec.device != device or dec.cpu().numpy().tolist() != bits.tolist():
        raise AssertionError("decrypt_bits_device did not return the bits")
    return t1 - t0, t2 - t1


def load_keyset(p):
    """The main secret keyset for ``p``, from .keycache/ or generated
    (host), and the keygen's seconds (0 when cached)."""
    path = files.cached_keyset_path(os.path.join(ROOT, ".keycache"), p)
    if os.path.exists(path):
        return files.load_secret_keyset(path), 0.0
    t0 = time.perf_counter()
    ks = keygen.generate_secret_keyset(p)
    dt = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    files.save_secret_keyset(path, ks)
    return ks, dt


def nand_inputs(ks, batch, device):
    """The bench's NAND operands: bits and ciphertexts from seed 2026."""
    stream = prng.key_from_seed_words([2026])
    x = prng.uniform_bits01(prng.derive(stream, 0), batch)
    y = prng.uniform_bits01(prng.derive(stream, 1), batch)
    cx = encrypt.encrypt_bits(ks, x, prng.derive(stream, 2), device)
    cy = encrypt.encrypt_bits(ks, y, prng.derive(stream, 3), device)
    return x, y, cx, cy


def bootstrap_vs_plain(key, cx, device):
    """Phase 4: the whole bootstrap under each step mode against the
    plain path; returns the plain path's result."""
    want = bootstrap.bootstrap(cx, key, plain=True)
    for mode in MODES:
        with step_mode(mode):
            got = bootstrap.bootstrap(cx, key)
        sync(device)
        if not torch.equal(got, want):
            raise AssertionError(f"bootstrap under {mode} differs from the "
                                 f"plain path")
    return want


def routes_vs_plain(key, cx, want, device):
    """Phase 4: the bootstrap under each ``IEACHE_PALLAS`` route and
    each of :data:`ROUTE_MODES` against the plain path ``want``, launch
    counts set to 0 just before each and read just after: 0 and
    interpret launch nothing, 1 the mode's kernels and no other (on CPU
    tensors 1 must raise)."""
    for route in ROUTES:
        for mode in ROUTE_MODES:
            kernels.reset_launch_counts()
            with step_mode(mode), environ("IEACHE_PALLAS", route):
                if route == "1" and device.type != "cuda":
                    try:
                        bootstrap.bootstrap(cx, key)
                    except RuntimeError:
                        continue
                    raise AssertionError("IEACHE_PALLAS=1 ran on the CPU")
                got = bootstrap.bootstrap(cx, key)
            sync(device)
            launched = {k for k, n in kernels.launch_counts().items() if n}
            expected = set(MODES[mode]) if route == "1" else set()
            if not torch.equal(got, want) or launched != expected:
                raise AssertionError(
                    f"IEACHE_PALLAS={route} under {mode}: equal to the plain "
                    f"path {torch.equal(got, want)}, launched "
                    f"{sorted(launched)}, expected {sorted(expected)}")


def compat_vs_plain(p, device, batch, seed=3):
    """Phase 4: the compat gadget's blind rotation on random inputs,
    under the default step mode (split's kernels, two digit rows a
    digit), against ``plain=True``; the default path must not refuse
    it."""
    rng = np.random.RandomState(seed)
    acc0 = _rand(rng, (batch, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 device)
    bara = _rand(rng, (batch, p.n), 0, 2 * p.N, np.int32, device)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    got = blind_rotate(acc0, bara, bk, p)
    want = blind_rotate(acc0, bara, bk, p, plain=True)
    sync(device)
    if not torch.equal(got, want):
        raise AssertionError(f"{p.name} blind rotation differs from "
                             f"plain=True")


def compat_nand(p, device, batch, seed_words=(0xC0, 0x3A7)):
    """Phase 4: NAND at the two-limb gadget ``p`` under split on ``batch``
    random bit pairs, its keys from the device keygen; returns
    (decrypt_errors, seconds of the first call, launch counts, NAND
    bootstraps/s over three more calls)."""
    ks = keygen_device.generate_secret_keyset_device(p, device, seed_words)
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    inputs = nand_inputs(ks, batch, device)
    kernels.reset_launch_counts()
    with step_mode("split"):
        errors, secs = run_nand(ks, key, inputs, device)
        counts = kernels.launch_counts()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            gates.NAND(inputs[2], inputs[3], key)
            sync(device)
            rates.append(batch / (time.perf_counter() - t0))
    return errors, secs, counts, rates


def small_n_vs_plain(p, device, batch=1, seed=4):
    """Phase 4: the blind rotation at a ring degree the tensor-core
    kernels refuse, under every step mode and under the interpret route,
    against ``plain=True``; launch counts set to 0 just before each and
    read just after: no mode's kernels take the shape, none launches."""
    rng = np.random.RandomState(seed)
    acc0 = _rand(rng, (batch, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 device)
    bara = _rand(rng, (batch, p.n), 0, 2 * p.N, np.int32, device)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    want = blind_rotate(acc0, bara, bk, p, plain=True)
    for mode in MODES:
        takes = kernels.kernels_take(mode, p)
        if takes != (mode == "ntt"):
            raise AssertionError(f"kernels_take({mode!r}) at N={p.N}: {takes}")
        for route in ("auto", "interpret"):
            kernels.reset_launch_counts()
            with step_mode(mode), environ("IEACHE_PALLAS", route):
                got = blind_rotate(acc0, bara, bk, p)
            sync(device)
            launched = {k for k, n in kernels.launch_counts().items() if n}
            expected = set(MODES[mode]) if (
                takes and route == "auto" and device.type == "cuda") else set()
            if not torch.equal(got, want) or launched != expected:
                raise AssertionError(
                    f"N={p.N} under {mode}, IEACHE_PALLAS={route}: equal to "
                    f"plain=True {torch.equal(got, want)}, launched "
                    f"{sorted(launched)}, expected {sorted(expected)}")
        if not takes:
            with step_mode(mode), environ("IEACHE_PALLAS", "1"):
                try:
                    blind_rotate(acc0, bara, bk, p)
                except ValueError:
                    continue
            raise AssertionError(f"IEACHE_PALLAS=1 under {mode} ran at "
                                 f"N={p.N}")


def run_nand(ks, key, inputs, device):
    """Phase 5: NAND on the batch; returns (decrypt_errors, seconds)."""
    x, y, cx, cy = inputs
    t0 = time.perf_counter()
    out = gates.NAND(cx, cy, key)
    sync(device)
    dt = time.perf_counter() - t0
    if tuple(out.shape) != (len(x), ks.params.n + 1):
        raise AssertionError(f"NAND output shape {tuple(out.shape)}")
    want = 1 - (x & y)
    errors = int((encrypt.decrypt_bits(ks, out) != want).sum())
    on_device = encrypt.decrypt_bits_device(ks, out)
    if on_device.device != out.device:
        raise AssertionError(f"decrypt_bits_device returned its bits on "
                             f"{on_device.device}")
    errors += int((on_device.cpu().numpy() != want).sum())
    return errors, dt


def expression_inputs(ks, width, batch, device, seed=7):
    """Signed operands small enough that A + B - C fits ``width`` bits,
    and their ciphertexts."""
    rng = np.random.RandomState(seed)
    lim = 1 << (width - 3)
    vals = [rng.randint(-lim, lim, batch).tolist() for _ in range(3)]
    stream = prng.key_from_seed_words([seed, width])
    cts = [words.encrypt_word(ks, v, width, prng.derive(stream, i), device)
           for i, v in enumerate(vals)]
    return vals, cts


def run_expression(ks, key, inputs, device):
    """Phase 6: A + B - C; returns (decrypted lanes, expected, seconds)."""
    (a, b, c), (ca, cb, cc) = inputs
    t0 = time.perf_counter()
    zero = gates.CONSTANT(torch.zeros(len(a), dtype=torch.int32,
                                      device=device), key.params.n)
    s, _ = arith.ripple_add(ca, cb, zero, key)
    r, _ = arith.ripple_sub(s, cc, key)
    sync(device)
    dt = time.perf_counter() - t0
    got = words.decrypt_word_signed(ks, r)
    want = [x + y - z for x, y, z in zip(a, b, c)]
    return got, want, dt


def run_fused_expression(ks, key, inputs, device):
    """Phase 6: A + B - C through the fused adder; returns (decrypted
    lanes, expected, seconds)."""
    (a, b, c), (ca, cb, cc) = inputs
    t0 = time.perf_counter()
    r = fused.add_then_sub(ca, cb, cc, key)
    sync(device)
    dt = time.perf_counter() - t0
    return (words.decrypt_word_signed(ks, r),
            [x + y - z for x, y, z in zip(a, b, c)], dt)


def multiply_inputs(ks, width, batch, device, seed=13):
    """Unsigned ``width``-bit operands, the extremes in lane 0, and
    their ciphertexts."""
    rng = np.random.RandomState(seed + batch)
    vals = [rng.randint(0, 1 << width, batch).tolist() for _ in range(2)]
    vals[0][0] = vals[1][0] = (1 << width) - 1
    stream = prng.key_from_seed_words([seed, width, batch])
    cts = [words.encrypt_word(ks, v, width, prng.derive(stream, i), device)
           for i, v in enumerate(vals)]
    return vals, cts


def run_multiply(ks, key, inputs, latency, device):
    """Phase 6: A * B over 2W bits through fused.schoolbook_mul_csa;
    returns (decrypted lanes, expected, seconds)."""
    (a, b), (ca, cb) = inputs
    t0 = time.perf_counter()
    r = fused.schoolbook_mul_csa(ca, cb, key, latency=latency)
    sync(device)
    dt = time.perf_counter() - t0
    return (words.decrypt_word(ks, r), [x * y for x, y in zip(a, b)], dt)


def run_mode(ks, key, mode, nand_in, expr_in, mul_in, device):
    """Phases 5 and 6 under one step mode, with every launch count set
    to 0 just before and read just after: on a CUDA device the mode's
    kernels must have launched and no other.  ``mul_in`` is a list of
    (name, multiply inputs, latency).  Returns (decrypt_errors, NAND
    seconds, {expression name: seconds}, launches of the NAND alone,
    launches of the whole run)."""
    kernels.reset_launch_counts()
    with step_mode(mode):
        errors, nand_s = run_nand(ks, key, nand_in, device)
        nand_launches = kernels.launch_counts()
        runs = []
        if mode in EXPRESSION_MODES:
            runs = [("A+B-C", lambda: run_expression(ks, key, expr_in,
                                                      device)),
                    ("A+B-C fused", lambda: run_fused_expression(
                        ks, key, expr_in, device))]
            runs += [(name, lambda i=inputs, lat=latency: run_multiply(
                ks, key, i, lat, device)) for name, inputs, latency in mul_in]
        expr_s = {}
        for name, run in runs:
            got, want, expr_s[name] = run()
            if got != want:
                raise AssertionError(f"{name} under {mode} decrypted "
                                     f"wrong: got {got}, want {want}")
    launches = kernels.launch_counts()
    if errors:
        raise AssertionError(f"NAND under {mode}: decrypt_errors={errors}")
    check_mode_launches(mode, launches, device)
    return errors, nand_s, expr_s, nand_launches, launches


def run_wgmma_nand(ks, key, p, nand_in, device):
    """Phase 5 at :data:`WGMMA_NAND_B`: NAND under each of
    :data:`WGMMA_NAND_MODES`, every launch count set to 0 just before and
    read just after, on a batch at which the mode's kernel runs its wgmma
    form (checked first); returns {mode: (seconds, launches)}."""
    b, kp1, rows = len(nand_in[0]), p.k + 1, p.trgsw_rows
    cuda = device.type == "cuda"
    forms = {"fused2": kernels.step_launch(
                 b, kp1, p.N, rows, _card_sms(device),
                 kernels._step_per_sm(device, rows, p.N) if cuda else 2,
                 _resident(p, device, "cmux_step")).form,
             "scan": kernels.scan_launch(
                 b, kp1, p.N, rows, _card_sms(device),
                 kernels._scan_per_sm(device, rows, p.N) if cuda else 2,
                 _resident(p, device, "blind_rotate_scan")).form}
    out = {}
    for mode in WGMMA_NAND_MODES:
        if forms[mode] != "wgmma":
            raise AssertionError(f"{mode} at B={b} picks its {forms[mode]} "
                                 f"form, not wgmma")
        kernels.reset_launch_counts()
        with step_mode(mode):
            errors, secs = run_nand(ks, key, nand_in, device)
        launches = kernels.launch_counts()
        if errors:
            raise AssertionError(f"NAND B={b} under {mode}: "
                                 f"decrypt_errors={errors}")
        check_mode_launches(mode, launches, device)
        out[mode] = secs, launches
    return out


def check_mode_launches(mode, launches, device):
    """On a CUDA device the kernels of ``mode`` must have launched and no
    other; on the CPU (the plain twins) none."""
    if device.type != "cuda":
        if any(launches.values()):
            raise AssertionError(f"{mode} on {device}: {launches}")
        return
    unlaunched = [k for k in MODES[mode] if not launches[k]]
    stray = [k for k, n in launches.items() if n and k not in MODES[mode]]
    if unlaunched or stray:
        raise AssertionError(f"{mode}: kernels not launched {unlaunched}, "
                             f"launched by another mode {stray}: {launches}")


#: the evaluator phase's adders
ADDERS = ("ripple", "kogge_stone")

#: the evaluator phase's mul-first tree A - B * C
A_MINUS_B_TIMES_C = [(evaluator.OP_MUL, ("opnd", 1), ("opnd", 2)),
                     (evaluator.OP_SUB, ("opnd", 0), ("step", 0))]


def evaluator_inputs(pair, width, device, seed=17):
    """The evaluator phase's operands, 8 lanes each: {expression: (A, B,
    C values, their operands)}.  ``A + B - C``: the lanes run through
    every sign combination of A, B and C.  ``A - B * C``: A of both signs
    against B and C of signs (+, +), (+, -) and (-, +); B and C both
    negative are left out, since the product's answer code 4 reads as
    negative inside a chain (the JAX package's evaluator does the same).
    ``B * C`` (one ``compute``): every sign pair of B and C twice, code 4
    among them."""
    rng = np.random.RandomState(seed)
    stream = prng.key_from_seed_words([seed, width])
    signs = {
        "A+B-C": list(itertools.product((1, -1), repeat=3)),
        "A-B*C": [(sa, sb, sc) for sa in (1, -1)
                  for sb, sc in ((1, 1), (1, -1), (-1, 1), (1, 1))],
        "B*C": [(1, sb, sc) for sb, sc in
                itertools.product((1, -1), repeat=2)] * 2,
    }
    lim = {"A+B-C": 1 << (width - 3), "A-B*C": 1 << (width - 1),
           "B*C": 1 << width}
    out = {}
    for i, (name, lanes) in enumerate(signs.items()):
        vals = [[sgn[k] * int(rng.randint(1, lim[name])) for sgn in lanes]
                for k in range(3)]
        out[name] = (vals, [evaluator.encrypt_operand(
            pair.main, pair.nbit, v, width, prng.derive(stream, 3 * i + k),
            device) for k, v in enumerate(vals)])
    return out


def meta_seconds(nbit_ks, operands, device):
    """Seconds of the host round trips of the operands' metadata: each
    negativity and bit-count word decrypted on the host, as the
    evaluator does before it plans."""
    sync(device)
    t0 = time.perf_counter()
    for o in operands:
        for word in (o.neg_word, o.bit_word):
            evaluator._decrypt_meta_value(nbit_ks, word)
    return time.perf_counter() - t0


def run_evaluator(pair, key, inputs, adder, device,
                  names=("A+B-C", "A-B*C", "B*C")):
    """Phase 8 under the current step mode and ``adder``: ``A + B - C``
    by ``compute_chain``, ``A - B * C`` by ``compute_steps``, ``B * C``
    by ``compute``, each lane decrypted by ``decrypt_answer`` and held to
    the Python result.  Returns {expression: record}: the answer's value
    word and codes, the call's seconds (metadata round trips, the circuit
    and the answer's metadata), the round trips' seconds and
    ``decrypt_answer``'s."""
    cloud = evaluator.CloudEvaluator(key, pair.nbit, adder=adder)
    recs = {}
    for name in names:
        (a, b, c), ops = inputs[name]
        if name == "A+B-C":
            op, used = evaluator.OP_SUB, ops
            call = lambda: cloud.compute_chain(  # noqa: E731
                [evaluator.OP_ADD, evaluator.OP_SUB], ops)
            want = [x + y - z for x, y, z in zip(a, b, c)]
        elif name == "A-B*C":
            op, used = evaluator.OP_SUB, ops
            call = lambda: cloud.compute_steps(  # noqa: E731
                A_MINUS_B_TIMES_C, ops)
            want = [x - y * z for x, y, z in zip(a, b, c)]
        else:
            op, used = evaluator.OP_MUL, ops[1:]
            call = lambda: cloud.compute(evaluator.OP_MUL, *ops[1:])  # noqa
            want = [y * z for y, z in zip(b, c)]
        meta_s = meta_seconds(pair.nbit, used, device)
        t0 = time.perf_counter()
        ans, info = call()
        sync(device)
        t1 = time.perf_counter()
        got = evaluator.decrypt_answer(pair.main, pair.nbit, ans, op)
        t2 = time.perf_counter()
        if got != want:
            raise AssertionError(f"{name} ({adder}) decrypted wrong: got "
                                 f"{got}, want {want}")
        recs[name] = {"value": ans.value, "codes": info["neg_codes"],
                      "seconds": t1 - t0, "meta_s": meta_s,
                      "decrypt_s": t2 - t1}
    return recs


def evaluator_modes(pair, key, inputs, device, modes=EXPRESSION_MODES):
    """Phase 8 under each of ``modes`` with both adders, launch counts
    set to 0 just before each mode's run and read just after: its
    kernels and no other.  Returns ({(mode, adder): records}, {mode:
    launches}); the answer codes of each run must cover 0, 1, 2, 4, 5."""
    recs, launches = {}, {}
    for mode in modes:
        kernels.reset_launch_counts()
        with step_mode(mode):
            for adder in ADDERS:
                recs[mode, adder] = run_evaluator(pair, key, inputs, adder,
                                                  device)
        launches[mode] = kernels.launch_counts()
        check_mode_launches(mode, launches[mode], device)
        for adder in ADDERS:
            codes = set().union(*(r["codes"] for r in
                                  recs[mode, adder].values()))
            if codes != {0, 1, 2, 4, 5}:
                raise AssertionError(f"{mode} {adder}: answer codes {codes}")
    return recs, launches


def evaluator_vs_plain(pair, key, device, width=6):
    """Phase 8: ``A + B - C`` and ``A - B * C`` (parallel-prefix adder)
    on ``width``-bit operands, 8 lanes, under split and under
    ``IEACHE_PALLAS=0``, which launches nothing; the plain path's value
    words equal to the kernel path's.  The plain step takes about half a
    second a bootstrap wave here, so its operands are narrower than the
    modes' 16 bits.  Returns {name: (kernel record, plain record)}."""
    names = ("A+B-C", "A-B*C")
    inputs = evaluator_inputs(pair, width, device, seed=23)
    with step_mode("split"):
        kernel_recs = run_evaluator(pair, key, inputs, "kogge_stone", device,
                                    names=names)
        kernels.reset_launch_counts()
        with environ("IEACHE_PALLAS", "0"):
            recs = run_evaluator(pair, key, inputs, "kogge_stone", device,
                                 names=names)
        launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"IEACHE_PALLAS=0 launched {launches}")
    for name, rec in recs.items():
        if not torch.equal(rec["value"], kernel_recs[name]["value"]):
            raise AssertionError(f"{name}: the plain path's value word "
                                 f"differs from the kernel path's")
    return {name: (kernel_recs[name], recs[name]) for name in names}


def check_wave_kernels(p, device, seen, seed=29):
    """Phases 8-10: each step kernel against its plain twin at every
    batch in ``seen`` (``kernels.recording_batches``, {kernel: batches}):
    the rotations and the fused steps at the amounts of
    :func:`bara_cases`, both external products with and without acc, the
    scan over all n steps.  Returns max abs error per kernel."""
    rng = np.random.RandomState(seed)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    bk_i = bk[0]
    errs = {}
    for name, batches in seen.items():
        wrapper = getattr(kernels, name)
        twin = getattr(kernels, name + "_plain")
        tr = name.endswith("_tr")                    # (k+1, N, B) layout
        for b in sorted(batches):
            acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32,
                        device)
            if tr:
                acc = acc.transpose(1, 2).contiguous()
            if name.startswith("external_product"):
                d = _rand(rng, (p.trgsw_rows, b, p.N), -128, 128, np.int8,
                          device)
                if tr:
                    d = d.transpose(1, 2).contiguous()
                for a in (None, acc):
                    _compare(name, wrapper(d, bk_i, p, acc=a),
                             twin(d, bk_i, p, a), errs, device,
                             f"B={b} acc={a is not None}")
            elif name == "blind_rotate_scan":
                bara = _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, device)
                _compare(name, wrapper(acc, bara, bk, p),
                         twin(acc, bara, bk, p), errs, device,
                         f"B={b} steps={p.n}")
            else:
                for amount, bara in bara_cases(rng, p, b, device):
                    args = (acc, bara) if name.startswith("rot_diff") \
                        else (acc, bara, bk_i)
                    _compare(name, wrapper(*args, p), twin(*args, p), errs,
                             device, f"B={b} bara={amount}")
    return errs


def widening_case(pair, key, device):
    """Phase 8: tests/test_evaluator.py's per-lane widening at full
    parameters: 7+7 (a magnitude with the top bit set at 4 bits)
    zero-extends and 3-6 sign-extends to C's 8 bits.  Returns the lanes."""
    cloud = evaluator.CloudEvaluator(key, pair.nbit)
    s = prng.key_from_seed_words([0xD1])
    ops = [evaluator.encrypt_operand(pair.main, pair.nbit, v, w,
                                     prng.derive(s, i), device)
           for i, (v, w) in enumerate((([7, 3], 4), ([7, -6], 4),
                                       ([100, 100], 8)))]
    ans, _ = cloud.compute_chain([evaluator.OP_ADD, evaluator.OP_ADD], ops)
    got = evaluator.decrypt_answer(pair.main, pair.nbit, ans,
                                   evaluator.OP_ADD)
    if got != [7 + 7 + 100, 3 - 6 + 100]:
        raise AssertionError(f"the per-lane widening decrypted {got}")
    return got


def chain_memory(pair, key, device, batch=64, width=16, seed=19):
    """Phase 8: ``chain_memory_analysis`` of ``A * B * C``; on the card
    every byte count must be positive (on the CPU the fields it cannot
    measure are -1).  Returns the analysis."""
    cloud = evaluator.CloudEvaluator(key, pair.nbit)
    rng = np.random.RandomState(seed)
    s = prng.key_from_seed_words([seed, batch, width])
    ops = [evaluator.encrypt_operand(
        pair.main, pair.nbit, rng.randint(1, 1 << width, batch).tolist(),
        width, prng.derive(s, i), device) for i in range(3)]
    steps = [(evaluator.OP_MUL, ("opnd", 0), ("opnd", 1)),
             (evaluator.OP_MUL, ("step", 0), ("opnd", 2))]
    ma = cloud.chain_memory_analysis(steps, ops)
    measured = ("temp_size_in_bytes", "peak_bytes_estimate")
    for field in ("argument_size_in_bytes", "output_size_in_bytes",
                  *measured):
        if device.type == "cuda" or field not in measured:
            if ma[field] <= 0:
                raise AssertionError(f"chain_memory_analysis: {ma}")
        elif ma[field] != -1:
            raise AssertionError(f"chain_memory_analysis on {device}: {ma}")
    if cloud.gate_count:
        raise AssertionError("chain_memory_analysis counted gates")
    return ma


def tool_lines(p, device, bench_b=1024, margin_b=2048, expr_b=256,
               width_cases=("mul32", "add256"), cases=width_bench.CASES):
    """Phase 8: the lines of bench (5 repeats), margin_probe, width_bench
    and expr_bench (``add_sub``) from their ``run`` functions, each with
    no decrypt error and the margin at least 7σ.  Returns [(tool,
    line)]."""
    lines = [("bench", bench.run(p, bench_b, 16, device)),
             ("margin_probe", margin_probe.run(p, margin_b, 4, device))]
    lines += [("width_bench", r) for r in width_bench.run(
        width_cases, p, device, cases=cases)]
    lines.append(("expr_bench", expr_bench.run("add_sub", p, expr_b, 16,
                                               device)))
    for tool, rec in lines:
        if rec.get("decrypt_errors", rec.get("errors")) != 0:
            raise AssertionError(f"{tool}: {rec}")
    if lines[1][1]["value"] < 7:
        raise AssertionError(f"margin_probe: {lines[1][1]}")
    return lines


#: phase 9's expressions through the protocol: (name, postfix)
PROTOCOL_EXPRESSIONS = (("A+B-C", "AB+C-"), ("A-B*C", "ABC*-"))

#: the step modes of phase 9's in-process flows
PROTOCOL_MODES = ("split", "scan")

#: e2e_bench in phase 9: the JAX tool's geometry, one lane at width 32
E2E_WIDTH, E2E_BATCH = 32, 1

#: the spans each role of a flow must have recorded
CLOUD_SPANS = ("job_receive", "data_request", "compute_chain", "answer_ship")
OUTPUT_SPANS = ("user_input_processing", "answer_wait", "verify")


def protocol_values(width, seed=31):
    """Phase 9's operands, 8 lanes an expression: {name: {letter:
    values}}.  ``A + B - C`` over every sign combination of A, B and C;
    ``A - B * C`` with A of both signs against B and C of signs (+, +),
    (+, -), (-, +), (+, +): a product of two negatives (code 4) reads as
    negative inside a chain, in both packages."""
    rng = np.random.RandomState(seed)
    signs = {
        "A+B-C": list(itertools.product((1, -1), repeat=3)),
        "A-B*C": [(sa, sb, sc) for sa in (1, -1)
                  for sb, sc in ((1, 1), (1, -1), (-1, 1), (1, 1))],
    }
    lim = {"A+B-C": 1 << (width - 3), "A-B*C": 1 << (width - 1)}
    return {name: {letter: [sgn[k] * int(rng.randint(1, lim[name]))
                            for sgn in lanes]
                   for k, letter in enumerate("ABC")}
            for name, lanes in signs.items()}


def span_seconds(spans, names):
    """{span name: seconds summed over ``spans``}, each of ``names`` at
    least once."""
    got = {}
    for sp in spans:
        got[sp["name"]] = got.get(sp["name"], 0.0) + sp["seconds"]
    missing = [n for n in names if n not in got]
    if missing:
        raise AssertionError(f"spans {missing} missing: {sorted(got)}")
    return {n: got[n] for n in names}


def protocol_flow(pair, p, postfix, values, width, mode, device):
    """Phase 9: one six-role flow in process (``mp/sim.py``: SAE key
    fan-out, BER job, operand pulls, the Cloud on ``device``, Output's
    decryption) under ``mode``, launch counts set to 0 just before and
    read just after: the mode's kernels and no other; every lane
    decrypted to the Python result.  Returns a record: the flow's and the
    key plane's seconds, the Cloud's and the Output's spans, launches."""
    kernels.reset_launch_counts()
    with step_mode(mode):
        t0 = time.perf_counter()
        res = sim.run_full_flow(postfix, values, width, p, pair=pair,
                                device=device)
        secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_mode_launches(mode, launches, device)
    want = e2e_bench.expected(postfix, values)
    if res.values != want:
        raise AssertionError(f"{postfix} under {mode} decrypted "
                             f"{res.values}, want {want}")
    return {"seconds": secs, "key_exchange_s": res.key_exchange_s,
            "cloud": span_seconds(res.cloud_spans, CLOUD_SPANS),
            "output": span_seconds(res.output_spans, OUTPUT_SPANS),
            "launches": launches}


def protocol_flows(pair, p, device, width=16, modes=PROTOCOL_MODES):
    """Phase 9's in-process flows: each expression under each mode.
    Returns {(mode, name): record}."""
    values = protocol_values(width)
    return {(mode, name): protocol_flow(pair, p, postfix, values[name],
                                        width, mode, device)
            for mode in modes for name, postfix in PROTOCOL_EXPRESSIONS}


def e2e_replica(pair, p, device, mode="scan", width=E2E_WIDTH,
                batch=E2E_BATCH):
    """Phase 9: e2e_bench's expressions and operands (one lane at width
    32) through the in-process flow under ``mode``, counted like
    :func:`protocol_flow`.  A wave's lanes, and so the batches of the
    kernel calls, do not depend on the step mode: recorded here, they
    are the batches of the Cloud process's calls in e2e_bench, which
    this process cannot record.  Returns {postfix: record}."""
    vals = e2e_bench.operand_values(width, batch)
    return {postfix: protocol_flow(pair, p, postfix, vals, width, mode,
                                   device)
            for _, postfix in PROTOCOL_EXPRESSIONS}


def ensure_e2e_keycache(pair, p, keycache):
    """The keysets e2e_bench's keygen role loads from ``keycache``
    (``serve --keycache``: ``<name>_.iek``, ``<name>_nbit.iek``), written
    from ``pair`` where absent; ``pair`` is the host keygen's, array for
    array (the keygen phase)."""
    os.makedirs(keycache, exist_ok=True)
    for tag, ks in (("", pair.main), ("nbit", pair.nbit)):
        path = files.cached_keyset_path(keycache, p, tag)
        if not os.path.exists(path):
            files.save_secret_keyset(path, ks)


def e2e_line(p, device, keycache, mode="split", width=E2E_WIDTH,
             batch=E2E_BATCH, logdir=e2e_bench.LOGDIR, pallas="1"):
    """Phase 9: ``e2e_bench.run`` with the Cloud process on ``device``
    under ``mode`` and ``IEACHE_PALLAS=pallas`` (under 1, a step that
    does not reach a kernel raises there; None leaves it unset, for the
    CPU's twins), the expressions of
    :data:`PROTOCOL_EXPRESSIONS` cold and warm at width 32, one lane:
    every ``decrypt_ok`` true, and the Cloud process's launches (its
    spans carry them) the mode's kernels and no other.  Returns the
    tool's record."""
    with step_mode(mode):
        rec = e2e_bench.run(p.name, batch, width,
                            [pf for _, pf in PROTOCOL_EXPRESSIONS], device,
                            timeout=900, keycache=keycache, logdir=logdir,
                            cloud_env={"IEACHE_PALLAS": pallas}
                            if pallas else None)
    if rec["decrypt_errors"] or not all(r["decrypt_ok"] for r in rec["runs"]):
        raise AssertionError(f"e2e_bench: {rec['runs']}")
    launches = {name: rec["cloud_launches"].get(name, 0)
                for name, _, _ in KERNELS}
    check_mode_launches(mode, launches, torch.device(device))
    span_seconds(rec["cloud_spans"], CLOUD_SPANS)
    span_seconds(rec["output_spans"], OUTPUT_SPANS)
    return rec


def protocol_phase(pair, p, device, seen, errs, launches):
    """Phase 9, the protocol: the six-role flow in process under each of
    :data:`PROTOCOL_MODES` (counted from 0 per flow), e2e_bench's shapes
    in process, then e2e_bench's OS processes with the Cloud on
    ``device``; the batches of the in-process flows recorded, and split's
    and scan's kernels held to their twins at each that ``seen`` (phase
    8's record) lacks.  Adds the launches to ``launches`` and the
    largest errors to ``errs``."""
    t9 = time.perf_counter()
    with kernels.recording_batches() as seen9:
        for (mode, name), r in protocol_flows(pair, p, device).items():
            log(f"phase 9 {name} width 16 B=8 {mode} in process: every "
                f"lane right, {r['seconds']:.3f} s the flow (key plane "
                f"{r['key_exchange_s']:.3f} s); Cloud spans "
                + json.dumps({k: round(v, 4) for k, v in r["cloud"].items()})
                + "; Output spans "
                + json.dumps({k: round(v, 4) for k, v in r["output"].items()})
                + f"; launches { {k: r['launches'][k] for k in MODES[mode]} }"
                f", others 0")
            for k in MODES[mode]:
                launches[k] += r["launches"][k]
        for postfix, r in e2e_replica(pair, p, device).items():
            log(f"phase 9 {postfix} width {E2E_WIDTH} B={E2E_BATCH} scan in "
                f"process (e2e_bench's shapes): every lane right, "
                f"{r['seconds']:.3f} s the flow, compute_chain "
                f"{r['cloud']['compute_chain']:.3f} s")
            for k in MODES["scan"]:
                launches[k] += r["launches"][k]
    keycache = os.path.join(ROOT, ".keycache")
    ensure_e2e_keycache(pair, p, keycache)
    e2e = e2e_line(p, device, keycache)
    log("phase 9 e2e_bench: " + json.dumps(e2e))
    for k, n in e2e["cloud_launches"].items():
        launches[k] += n
    t0 = time.perf_counter()
    every = set().union(*seen9.values())
    fresh = {name: every - seen.get(name, set())
             for name in ("rot_diff_decompose", "external_product",
                          "blind_rotate_scan")}
    for name, err in check_wave_kernels(p, device, fresh).items():
        errs[name] = max(errs[name], err)
    log(f"phase 9 waves: split's and scan's kernels equal to their twins "
        f"at every batch phase 9 called a kernel with, "
        f"B={'/'.join(map(str, sorted(every)))} (those phase 8 had not: "
        + json.dumps({k: sorted(v) for k, v in fresh.items()})
        + f"), {time.perf_counter() - t0:.1f} s")
    log(f"phase 9 protocol: {time.perf_counter() - t9:.1f} s")


#: phase 10: keyplane_bench's environment (the key plane at λ=110 for
#: 1, 2 and 3 clients, once each)
KEYPLANE_ENV = {"KB_PARAMS": "ieache_110_l2", "KB_CLIENTS": "1,2,3",
                "KB_ITERS": "1"}


def _timed(fn, device):
    """(``fn()``, its seconds to a fence)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def sharded_bootstraps(ks, key, nand_in, device):
    """Phase 10: ``make_sharded_bootstrap`` and
    ``make_sharded_bootstrap_sp`` on (1, 1) meshes of this process's
    group, on the phase-5 NAND inputs: each equal to the unsharded
    port's ``bootstrap`` (under split, on the kernels), no wrong lane,
    and no kernel launched (the tp and sp steps are plain ops, as in the
    JAX package).  Each path runs twice, the second call timed (the
    first creates its groups' NCCL communicators).  Returns {path:
    (first seconds, second seconds)}."""
    x, y, cx, cy = nand_in
    p = key.params
    pre = -cx - cy
    pre[:, p.n] += bootstrap.MU
    with step_mode("split"):
        want = bootstrap.bootstrap(pre, key)
    truth = 1 - (x & y)
    m, m_sp = dmesh.make_mesh(1, tp=1), dshard.make_sp_mesh(1, sp=1)
    bk, ksl = dshard.shard_cloud_key(key, m)
    tp_fn = dshard.make_sharded_bootstrap(m, p)
    sp_fn = dshard.make_sharded_bootstrap_sp(m_sp, p)
    runs = {"tp": lambda: tp_fn(dshard.shard_batch(pre, m), bk, ksl),
            "sp": lambda: sp_fn(dshard.shard_batch(pre, m_sp), key.bk,
                                key.ks_limbs)}
    secs = {}
    for name, fn in runs.items():
        kernels.reset_launch_counts()
        _, first = _timed(fn, device)
        got, warm = _timed(fn, device)
        secs[name] = (first, warm)
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        errors = int((encrypt.decrypt_bits(ks, got) != truth).sum())
        if launched or errors or not torch.equal(got, want):
            raise AssertionError(
                f"{name} (1, 1) bootstrap: equal to the unsharded port "
                f"{torch.equal(got, want)}, decrypt_errors {errors}, "
                f"launched {launched}")
    return secs


def dp_evaluator(pair, key, inputs, want_value, device):
    """Phase 10: ``A + B - C`` (phase 8's 16-bit operands, 8 lanes)
    under split through ``dist/batch.py`` on a (1, 1) mesh: the key
    replicated, each operand sharded, the answer gathered; its value
    word equal to phase 8's, every lane right, split's kernels launched
    and no other.  Returns (seconds, launches)."""
    m = dmesh.make_mesh(1, tp=1)
    (a, b, c), ops = inputs["A+B-C"]
    kernels.reset_launch_counts()
    with step_mode("split"):
        cloud = evaluator.CloudEvaluator(dbatch.replicate_cloud_key(key, m),
                                         pair.nbit)
        ans, secs = _timed(lambda: dbatch.gather_operand(cloud.compute_chain(
            [evaluator.OP_ADD, evaluator.OP_SUB],
            [dbatch.shard_operand(o, m) for o in ops])[0], m), device)
    launches = kernels.launch_counts()
    check_mode_launches("split", launches, device)
    got = evaluator.decrypt_answer(pair.main, pair.nbit, ans, evaluator.OP_SUB)
    if not torch.equal(ans.value, want_value) or got != [
            x + y - z for x, y, z in zip(a, b, c)]:
        raise AssertionError(f"the dp-sharded A+B-C: value word equal to "
                             f"phase 8's {torch.equal(ans.value, want_value)}"
                             f", decrypted {got}")
    return secs, launches


def pipeline_chain(ks, key, device, width=8, batch=8, seed=37):
    """Phase 10: a one-stage chain (add on even lanes, subtract on odd
    ones) on a pp=1 mesh, ``n_micro=2``, under split: equal to
    ``chain_unpipelined`` on the same inputs, every lane right, split's
    kernels launched and no other (by both).  Returns (seconds,
    launches)."""
    p = key.params
    rng = np.random.RandomState(seed)
    vals = [rng.randint(0, 1 << (width - 1), batch).tolist()
            for _ in range(2)]
    stream = prng.key_from_seed_words([seed, width])
    flow0, y = (words.encrypt_word(ks, v, width, prng.derive(stream, i),
                                   device) for i, v in enumerate(vals))
    comps = (torch.arange(batch, device=device) % 2).to(torch.int32)[None]
    chain = ppl.make_pipelined_chain(ppl.make_pp_mesh(1), p, n_micro=2)
    kernels.reset_launch_counts()
    with step_mode("split"):
        got, secs = _timed(lambda: chain(flow0, y[None], comps, key.bk,
                                         key.ks_limbs), device)
        want = ppl.chain_unpipelined(flow0, y[None], comps, key.bk,
                                     key.ks_limbs, p)
    launches = kernels.launch_counts()
    check_mode_launches("split", launches, device)
    expect = [(a - b if lane % 2 else a + b) % (1 << width)
              for lane, (a, b) in enumerate(zip(*vals))]
    if not torch.equal(got, want) or words.decrypt_word(ks, got) != expect:
        raise AssertionError("the pp=1 chain differs from chain_unpipelined "
                             "or decrypts wrong")
    return secs, launches


def dryrun_line(device):
    """Phase 10: ``dryrun_multichip(1)`` on ``device`` (a rank process
    of its own); under split, tr and scan its bootstrap must launch that
    mode's kernels and no other (the rank raises otherwise), under ntt
    none, and every kernel it launched must have its batches recorded.
    Returns ({mode: launches}, {kernel: batches of its calls},
    seconds)."""
    t0 = time.perf_counter()
    (report,) = dryrun.dryrun_multichip(1, device=device.type)
    secs = time.perf_counter() - t0
    batches = {k: set(b) for k, b in report["batches"].items()}
    for mode, counts in report["launches"].items():
        if device.type == "cuda" and not (all(counts.values())
                                          and set(counts) <= set(batches)):
            raise AssertionError(f"the dry run under {mode}: {counts}, "
                                 f"batches {report['batches']}")
    return report["launches"], batches, secs


def keyplane_line(timeout=600, env=KEYPLANE_ENV):
    """Phase 10: ``python -m ieache_tpu_torch.tools.keyplane_bench`` as a
    process of its own (this one has CUDA up, and the tool spawns its
    clients), the Cloud on the card: its JSON line, which must name the
    card and hold every client count."""
    proc = subprocess.run(
        [sys.executable, "-m", "ieache_tpu_torch.tools.keyplane_bench"],
        cwd=ROOT, env=dict(os.environ, **env), capture_output=True,
        text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        raise AssertionError(f"keyplane_bench exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    rec = json.loads(lines[-1])
    if rec["card"] != card_line() or sorted(rec["per_clients"]) != sorted(
            env["KB_CLIENTS"].split(",")):
        raise AssertionError(f"keyplane_bench: {rec}")
    return rec


def dist_phase(ks, key, nand_in, pair, ev_in, want_value, device, seen,
               errs, launches):
    """Phase 10, distribution and the key plane: this process joins a
    one-rank NCCL group, runs the (1, 1) sharded bootstraps, the
    dp-sharded evaluator and the pp=1 chain (their batches recorded, the
    kernels held to their twins at those phase 8 had not), then the dry
    run on a rank of its own (its kernels held to their twins at
    TEST_TINY and the batches the rank recorded), and the lines of keyplane_bench,
    scaling_bench at dp=1 (the dp-sharded NAND at B=1024 on a rank of
    its own: split's kernels, and no other) and comm_model.  Adds the launches to
    ``launches`` and the largest errors to ``errs``."""
    t10 = time.perf_counter()
    p = key.params
    launch.init(0, 1, f"127.0.0.1:{launch.free_port()}", device)
    try:
        secs = sharded_bootstraps(ks, key, nand_in, device)
        log(f"phase 10 sharded bootstraps B={len(nand_in[0])} {p.name} "
            f"(plain steps; first call, second call): tp (1, 1) "
            f"{secs['tp'][0]:.3f}, {secs['tp'][1]:.3f} s; sp (1, 1) "
            f"{secs['sp'][0]:.3f}, {secs['sp'][1]:.3f} s; each equal to the "
            f"unsharded port's bootstrap, decrypt_errors 0, no kernel "
            f"launched")
        with kernels.recording_batches() as seen10:
            ev_s, counts = dp_evaluator(pair, key, ev_in, want_value, device)
            log(f"phase 10 dp-sharded A+B-C width 16 B=8 split: value word "
                f"equal to phase 8's, every lane right, {ev_s:.3f} s; "
                f"launches { {k: counts[k] for k in MODES['split']} }, "
                f"others 0")
            for k in MODES["split"]:
                launches[k] += counts[k]
            pp_s, counts = pipeline_chain(ks, key, device)
            log(f"phase 10 pp=1 chain (add/sub per lane, width 8 B=8, "
                f"n_micro=2) split: equal to chain_unpipelined, every lane "
                f"right, {pp_s:.3f} s; launches "
                f"{ {k: counts[k] for k in MODES['split']} }, others 0")
            for k in MODES["split"]:
                launches[k] += counts[k]
    finally:
        torch.distributed.destroy_process_group()
    every = set().union(*seen10.values())
    fresh = {name: every - seen.get(name, set())
             for name in ("rot_diff_decompose", "external_product")}
    for name, err in check_wave_kernels(p, device, fresh).items():
        errs[name] = max(errs[name], err)
    log(f"phase 10 waves: split's kernels equal to their twins at every "
        f"batch phase 10 called them with, B="
        f"{'/'.join(map(str, sorted(every)))} (those phase 8 had not: "
        + json.dumps({k: sorted(v) for k, v in fresh.items()}) + ")")

    by_mode, dry_seen, dry_s = dryrun_line(device)
    log(f"phase 10 dryrun_multichip(1) on {device.type}: every decrypt "
        f"assert held, {dry_s:.1f} s (a rank process of its own); launches "
        + json.dumps(by_mode))
    for counts in by_mode.values():
        for k, n in counts.items():
            launches[k] += n
    for name, err in check_wave_kernels(P.TEST_TINY, device,
                                        dry_seen).items():
        errs[name] = max(errs.get(name, 0), err)
    log("phase 10 dry run waves: each kernel equal to its plain twin at "
        "every batch the dry run's rank called it with, "
        + json.dumps({k: sorted(v) for k, v in dry_seen.items()}))

    t0 = time.perf_counter()
    log("phase 10 keyplane_bench: " + json.dumps(keyplane_line()))
    log(f"phase 10 keyplane_bench: {time.perf_counter() - t0:.1f} s (the "
        f"tool's process included)")
    line, summary = scaling_bench.run(p, 1024, 3, 1, device)
    if line["errors"] or (device.type == "cuda"
                          and set(line["launches"]) != set(MODES["split"])):
        raise AssertionError(f"scaling_bench: {line}")
    for k, n in line["launches"].items():
        launches[k] += n
    log("phase 10 scaling_bench: " + json.dumps(line))
    log("phase 10 scaling_bench: " + json.dumps(summary))
    log("phase 10 comm_model: " + json.dumps(comm_model.run()))
    log(f"phase 10 distribution: {time.perf_counter() - t10:.1f} s")


def bound_ms(tensors, ops, op_type):
    """The least ms the card could take for a call: the bytes of
    ``tensors`` (each input read once, each output written once) over
    the memory rate, or ``ops`` operations over the published peak for
    ``op_type``, whichever is larger.  Returns (ms, "bytes" or
    "operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def external_product_ops(p, batch, steps=1):
    """Operations of ``steps`` external products in the JAX kernel's
    form: per limb, TRGSW row and output polynomial, a (B, N) x (N, N)
    int8 product (2 operations per multiply-add)."""
    return (2 * TORUS_LIMBS * p.trgsw_rows * (p.k + 1) * batch * p.N * p.N
            * steps)


def step_calls(p, device, batch, probe_b=PROBE_B):
    """The per-step kernels' calls at B=``batch`` (the probe's kernels
    at B=``probe_b``): name -> (kernel call, twin call, input tensors,
    operations of the call)."""
    rng = np.random.RandomState(1)
    acc = _rand(rng, (p.k + 1, batch, p.N), -2**31, 2**31, np.int32, device)
    bara = _rand(rng, (batch,), 0, 2 * p.N, np.int32, device)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 device)
    d = kernels.rot_diff_decompose(acc, bara, p)
    acc_tr, d_tr = (x.transpose(1, 2).contiguous() for x in (acc, d))
    probe = _rand(rng, (p.k + 1, probe_b, p.N), -2**31, 2**31, np.int32,
                  device)
    probe_tr = probe.transpose(1, 2).contiguous()
    probe_bara = _rand(rng, (probe_b,), 0, 2 * p.N, np.int32, device)
    ep_ops = external_product_ops(p, batch)
    return {
        "rot_diff_decompose": (
            lambda: kernels.rot_diff_decompose(acc, bara, p),
            lambda: kernels.rot_diff_decompose_plain(acc, bara, p),
            (acc, bara), 0),
        "external_product": (
            lambda: kernels.external_product(d, bk_i, p, acc=acc),
            lambda: kernels.external_product_plain(d, bk_i, p, acc),
            (d, bk_i, acc), ep_ops),
        "cmux_step": (
            lambda: kernels.cmux_step(acc, bara, bk_i, p),
            lambda: kernels.cmux_step_plain(acc, bara, bk_i, p),
            (acc, bara, bk_i), ep_ops),
        "cmux_step_overlap": (
            lambda: kernels.cmux_step_overlap(acc, bara, bk_i, p),
            lambda: kernels.cmux_step_plain(acc, bara, bk_i, p),
            (acc, bara, bk_i), ep_ops),
        "rot_diff_decompose_tr": (
            lambda: kernels.rot_diff_decompose_tr(acc_tr, bara, p),
            lambda: kernels.rot_diff_decompose_tr_plain(acc_tr, bara, p),
            (acc_tr, bara), 0),
        "external_product_tr": (
            lambda: kernels.external_product_tr(d_tr, bk_i, p, acc=acc_tr),
            lambda: kernels.external_product_tr_plain(d_tr, bk_i, p,
                                                      acc_tr),
            (d_tr, bk_i, acc_tr), ep_ops),
        "rotate_lane": (
            lambda: kernels.rotate_lane(probe, probe_bara),
            lambda: kernels.rotate_lane_plain(probe, probe_bara),
            (probe, probe_bara), 0),
        "rotate_sublane": (
            lambda: kernels.rotate_sublane(probe_tr, probe_bara),
            lambda: kernels.rotate_sublane_plain(probe_tr, probe_bara),
            (probe_tr, probe_bara), 0),
    }


def step_times(p, device, batch, reps, names=None, probe_b=PROBE_B):
    """Phase 7: ms per call of each per-step kernel (of ``names`` only,
    when given) and of its plain twin at the main-path shapes
    (:func:`step_calls`; the probe's at B=``probe_b``), on a CUDA
    ``device``: ``ms``/``plain_ms`` on
    the device (CUDA graph replay), ``host_ms``/``plain_host_ms`` per
    call of a Python loop (launch cost included), and the call's bound
    (:func:`bound_ms`; a rotation's few integer operations per
    coefficient have no tensor-core form and are not counted)."""
    times = {}
    for name, (kern, plain, inputs, ops) in step_calls(
            p, device, batch, probe_b).items():
        if names is not None and name not in names:
            continue
        bound, by = bound_ms((*inputs, kern()), ops, "int8")
        times[name] = {"host_ms": events_ms(kern, reps),
                       "plain_host_ms": events_ms(plain, reps),
                       "ms": graph_ms(kern, reps),
                       "plain_ms": graph_ms(plain, reps),
                       "bound_ms": bound, "bound_by": by, "library_ms": None}
    return times


def cold_calls(p, device, batch, probe_b=PROBE_B, cycle=COLD_BYTES):
    """The rotations of :data:`COLD_KERNELS` at B=``batch`` (the probe's
    at B=``probe_b``), each on :func:`cold_copies` copies of its
    accumulator (``cycle`` bytes of them): name -> (B, the calls, one per
    copy, the input tensors of one call)."""
    rng = np.random.RandomState(8)
    wrappers = {
        "rot_diff_decompose": lambda a, t: kernels.rot_diff_decompose(a, t, p),
        "rot_diff_decompose_tr":
            lambda a, t: kernels.rot_diff_decompose_tr(a, t, p),
        "rotate_lane": kernels.rotate_lane,
        "rotate_sublane": kernels.rotate_sublane}
    out = {}
    for name, tr, probe in COLD_KERNELS:
        b = probe_b if probe else batch
        shape = (p.k + 1, p.N, b) if tr else (p.k + 1, b, p.N)
        acc = _rand(rng, shape, -2**31, 2**31, np.int32, device)
        bara = _rand(rng, (b,), 0, 2 * p.N, np.int32, device)
        copies = [acc] + [acc.clone() for _ in range(
            cold_copies(acc.numel() * 4, cycle) - 1)]
        fn = wrappers[name]
        out[name] = (b, [lambda a=a, fn=fn, t=bara: fn(a, t)
                         for a in copies], (acc, bara))
    return out


def cold_times(p, device, batch, probe_b=PROBE_B):
    """Phase 7: ms per call of the rotations of :data:`COLD_KERNELS` with
    the L2 cold (:func:`graph_ms_cold` through :func:`cold_calls`, two
    cycles of the copies), beside the bound of their bytes at the HBM
    rate.  name -> {"b", "copies", "ms", "bound_ms"}."""
    times = {}
    for name, (b, calls, inputs) in cold_calls(p, device, batch,
                                               probe_b).items():
        bound, _ = bound_ms((*inputs, calls[0]()), 0, "int8")
        times[name] = {"b": b, "copies": len(calls),
                       "ms": graph_ms_cold(calls, 2 * len(calls)),
                       "bound_ms": bound}
        del calls
    return times


def cold_line(name, t):
    """Phase 7's line for one rotation's time with the L2 cold."""
    return (f"phase 7 {name} B={t['b']} L2 cold: kernel {t['ms']:.4f} "
            f"ms/call (graph replay through {t['copies']} copies of the "
            f"accumulator, every output kept); bound {t['bound_ms']:.4f} "
            f"ms (bytes at the HBM rate), {t['bound_ms'] / t['ms']:.0%} of "
            f"it")


def step_line(name, b, t):
    """Phase 7's line for one per-step kernel's times at B=``b``."""
    return (f"phase 7 {name} B={b}: kernel {t['ms']:.4f} ms/call, "
            f"plain twin {t['plain_ms']:.4f} ms/call on the device (graph "
            f"replay); from a Python loop {t['host_ms']:.4f} and "
            f"{t['plain_host_ms']:.4f} ms/call; bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']})")


def scan_times(p, device, batch, reps):
    """Phase 7: ms per whole rotation (n steps) of the scan kernel and
    of its plain twin, CUDA events around each call, and its bound."""
    rng = np.random.RandomState(2)
    acc = _rand(rng, (p.k + 1, batch, p.N), -2**31, 2**31, np.int32, device)
    bara = _rand(rng, (batch, p.n), 0, 2 * p.N, np.int32, device)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    bound, by = bound_ms((acc, bara, bk, acc),
                         external_product_ops(p, batch, p.n), "int8")
    return {"ms": events_ms(
                lambda: kernels.blind_rotate_scan(acc, bara, bk, p), reps),
            "plain_ms": events_ms(
                lambda: kernels.blind_rotate_scan_plain(acc, bara, bk, p),
                reps),
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def keyswitch_ops(p, batch, m):
    """The keyswitch's int8 operations at B=``batch`` against the packed
    key of ``m`` columns: four limbs, 2 a multiply-add."""
    return 2 * TORUS_LIMBS * batch * p.kN * p.ks_t * m


def keyswitch_times(p, device, batches=KS_TIMED_BATCHES, reps=50):
    """Phase 7: ms per call of the keyswitch at each of ``batches`` (a CUDA
    graph of ``reps`` calls replayed between CUDA events, the median of
    three): the kernel, the plain chain ``keyswitch_plain`` (the four
    ``torch._int_mm`` products and their elementwise ops: the library
    path the kernel replaced, so also ``library_ms``), and the bound
    (the packed key, the ciphertexts in and the answers out over
    3.35 TB/s, or :func:`keyswitch_ops` over the int8 peak)."""
    rng = np.random.RandomState(47)
    out = {}
    sms = _card_sms(device)
    for b in batches:
        _, x, limbs = next(keyswitch_operands(p, b, device, rng))
        kern = statistics.median(
            graph_ms(lambda: ksw.keyswitch(x, limbs, p), reps)
            for _ in range(3))
        plain = statistics.median(
            graph_ms(lambda: ksw.keyswitch_plain(x, limbs, p), reps)
            for _ in range(3))
        ans = torch.empty((b, p.n + 1), dtype=torch.int32, device=device)
        bound, by = bound_ms([limbs, x, ans],
                             keyswitch_ops(p, b, limbs.shape[-1]), "int8")
        out[b] = {"ms": kern, "plain_ms": plain, "library_ms": plain,
                  "bound_ms": bound, "bound_by": by,
                  "form": kernels.keyswitch_launch(b, p, sms).form}
    return out


def mm_times(device, reps, case=MM_CASES[0]):
    """Phase 7: ms per call of mm_s8 and mm_bf16 at the probe's shape
    (the sum of g products), each beside its twin, its bound, and the
    library call on the same operands g times (``torch._int_mm``, bf16
    ``torch.matmul``); device times from CUDA-graph replay, the twins'
    from CUDA events around the call."""
    m, k, n, g = case
    ins = mosaic_mm_probe.make_inputs(m, k, n, device)
    times = {}
    for name, dt, op_type, library in (
            ("mm_s8", "s8", "int8", torch._int_mm),
            ("mm_bf16", "bf16", "bf16", torch.matmul)):
        a, b = ins[dt]
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        bound, by = bound_ms((a, b, kern(a, b, g)), g * 2 * m * k * n,
                             op_type)
        times[name] = {
            "ms": graph_ms(lambda: kern(a, b, g), reps),
            "plain_ms": events_ms(lambda: plain(a, b, g), 2),
            "library_ms": graph_ms(lambda: library(a, b), g) * g,
            "bound_ms": bound, "bound_by": by}
    return times


def nand_rates(ks, key, mode, nand_in, device, repeats=5):
    """Phase 7: NAND bootstraps/s under ``mode``, ``repeats`` times, or
    once when a call takes more than 3 s."""
    rates = []
    with step_mode(mode):
        while len(rates) < repeats and (not rates or
                                        len(nand_in[0]) / rates[0] < 3.0):
            e, dt = run_nand(ks, key, nand_in, device)
            if e:
                raise AssertionError(f"NAND decrypt_errors={e} under {mode} "
                                     f"in a timed repeat")
            rates.append(len(nand_in[0]) / dt)
    return rates


def expression_latency(ks, key, mode, expr_in, device):
    """Phase 7: A + B - C seconds under ``mode``, 3 times, or once when
    a call takes more than 3 s."""
    lat = []
    with step_mode(mode):
        while len(lat) < 3 and (not lat or lat[0] < 3.0):
            g, w, dt = run_expression(ks, key, expr_in, device)
            if g != w:
                raise AssertionError(f"A + B - C under {mode} decrypted "
                                     f"wrong in a timed repeat")
            lat.append(dt)
    return lat


def run_probe(device, b=PROBE_B, steps=200, iters=8):
    """Phase 7: the rotation probe, its own path: launch counts set to 0
    just before and read just after; both probe kernels must have
    launched, and no other.  Returns (the probe's record, launches)."""
    kernels.reset_launch_counts()
    rec = transposed_probe.run(b, steps, iters, device)
    launches = kernels.launch_counts()
    probe = ("rotate_lane", "rotate_sublane")
    if (not rec["checksums_match"] or not all(launches[k] for k in probe)
            or any(n for k, n in launches.items() if k not in probe)):
        raise AssertionError(f"transposed_probe: {rec}, launches {launches}")
    return rec, launches


def run_mm_probe(device, case=MM_CASES[0]):
    """Phase 7: the matmul probe, its own path: launch counts set to 0
    just before and read just after; both mm kernels must have launched,
    and no other.  Returns (the probe's record, launches)."""
    m, k, n, g = case
    kernels.reset_launch_counts()
    rec = mosaic_mm_probe.run(m, k, n, g, "both", device)
    launches = kernels.launch_counts()
    probe = ("mm_s8", "mm_bf16")
    if (not all(launches[name] for name in probe)
            or any(c for name, c in launches.items() if name not in probe)):
        raise AssertionError(f"mosaic_mm_probe: {rec}, launches {launches}")
    return rec, launches


def main() -> int:
    # phase 1: device
    device = require_cuda("chip_smoke")
    kind = torch.cuda.get_device_name(device)
    card = card_line()
    log(f"phase 1 device: {kind}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    log(card)

    # phase 2: build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {build_s:.1f} s -> "
        f"{os.path.relpath(_build.LIB_PATH, ROOT)}")
    if os.path.exists(_build.PTXAS_LOG):
        with open(_build.PTXAS_LOG) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    log("  ptxas:", line.strip())

    p = P.IEACHE_110_FAST
    batch = 1024

    # phase 3: kernels against their plain twins; 8 and 16 are the
    # batches of the A + B - C rounds below
    errs = check_kernels(p, device, [batch, 8, 16, 1, 5, 1056])
    for name, err in check_rotation_launches(p, device).items():
        errs[name] = max(errs[name], err)
    for mma_p in MMA_PARAMS:
        for name, err in check_mma_kernels(mma_p, device,
                                           MMA_BATCHES).items():
            errs[name] = max(errs[name], err)
        for name, err in check_scan_turns(mma_p, device).items():
            errs[name] = max(errs[name], err)
        for name, err in check_product_launches(
                mma_p, device, (*MMA_BATCHES, *PRODUCT_BATCHES,
                                *MMA_SPLIT_EDGE)).items():
            errs[name] = max(errs[name], err)
        cross = step_crossovers(mma_p, _card_sms(device),
                                _resident(mma_p, device, "cmux_step"))
        for name, err in check_step_launches(
                mma_p, device, sorted({*MMA_BATCHES, *PRODUCT_BATCHES,
                                       *MMA_SPLIT_EDGE,
                                       *(b + d for b in cross
                                         for d in (-1, 0, 1))})).items():
            errs[name] = max(errs[name], err)
    errs.update(check_mm_kernels(device))
    ks_errs = {}
    for ks_p in (P.TEST_SMALL_NOISY, P.IEACHE_110):
        for name, err in check_keyswitch(ks_p, device).items():
            ks_errs[name] = max(ks_errs.get(name, 0), err)

    # keys and operands (set-up), and the keygen phase: the device
    # keygen and encryption against the host's
    ks, keygen_s = load_keyset(p)
    torch.cuda.reset_peak_memory_stats(device)
    device_keygen_s = keygen_vs_host(ks, device)
    keygen_peak = torch.cuda.max_memory_allocated(device)
    log(f"keygen phase: generate_secret_keyset_device on {device} equal to "
        f"the host keyset (lwe_s, trlwe_k, bk, ks), {device_keygen_s:.2f} s "
        f"(first call), peak device memory {keygen_peak / 1e9:.2f} GB")
    enc_s, host_enc_s = encrypt_vs_host(ks, 1024, device)
    log(f"keygen phase: encrypt_bits_device equal to encrypt_bits on 1024 "
        f"bits ({enc_s:.3f} s on the device, {host_enc_s:.3f} s on the "
        f"host); decrypt_bits_device returns the bits")
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    log(f"keys: {p.name} keygen {keygen_s:.1f} s "
        f"({'cached' if keygen_s == 0 else 'generated'}); bk "
        f"{key.bk.numel() * 4 / 1e6:.1f} MB, ks_limbs "
        f"{key.ks_limbs.numel() / 1e6:.1f} MB on {device}")
    nand_in = nand_inputs(ks, batch, device)
    expr_in = expression_inputs(ks, 16, 8, device)
    mul_in = [("mul16 B=8 windowed", multiply_inputs(ks, 16, 8, device),
               False),
              ("mul16 B=8 latency", multiply_inputs(ks, 16, 8, device), True),
              ("mul16 B=2 latency (Wallace)",
               multiply_inputs(ks, 16, 2, device), True)]

    # phase 4: whole bootstrap under each mode and each IEACHE_PALLAS
    # route against the plain path; the compat gadget's rotation (no
    # kernel) against plain=True
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    want = bootstrap_vs_plain(key, nand_in[2], device)
    unlaunched = [k for m in MODES for k in MODES[m]
                  if not kernels.launch_counts()[k]]
    if unlaunched:
        raise AssertionError(f"phase 4 left kernels unlaunched: {unlaunched}")
    log(f"phase 4 bootstrap B={batch}: {', '.join(MODES)} each equal to "
        f"the plain path ({time.perf_counter() - t0:.1f} s)")
    routes_vs_plain(key, nand_in[2], want, device)
    log(f"phase 4 IEACHE_PALLAS={'/'.join(ROUTES)} under "
        f"{'/'.join(ROUTE_MODES)} B={batch}: each equal to the plain path; "
        f"0 and interpret launched nothing, 1 the mode's kernels")
    compat_vs_plain(P.IEACHE_110_TFHE_COMPAT, device, 8)
    log(f"phase 4 {P.IEACHE_110_TFHE_COMPAT.name} blind rotation B=8: "
        f"runs, equal to plain=True")
    errors, secs, counts, rates = compat_nand(P.IEACHE_110_TFHE_COMPAT,
                                              device, batch)
    log(f"phase 4 NAND B={batch} {P.IEACHE_110_TFHE_COMPAT.name} split: "
        f"decrypt_errors={errors} on the host and on the device ({secs:.3f} "
        f"s, first call); launches "
        f"{ {k: counts[k] for k in MODES['split']} }; bootstraps/s "
        f"{', '.join(f'{r:.1f}' for r in rates)}")
    if errors or any(counts[k] != P.IEACHE_110_TFHE_COMPAT.n
                     * (k in MODES["split"]) for k in counts):
        raise AssertionError(f"compat NAND: decrypt_errors={errors}, "
                             f"launches {counts}")
    small_n_vs_plain(SMALL_N_PARAMS, device)
    log(f"phase 4 blind rotation at N={SMALL_N_PARAMS.N} B=1: every step "
        f"mode, under IEACHE_PALLAS unset and interpret, equal to "
        f"plain=True; no kernel launched; IEACHE_PALLAS=1 raises")

    # phases 5 and 6: the main path under each mode, counted from 0
    launches = dict.fromkeys(kernels.launch_counts(), 0)
    nand_launches = dict(launches)
    for mode in MODES:
        errors, nand_s, expr_s, nand_counts, counts = run_mode(
            ks, key, mode, nand_in, expr_in, mul_in, device)
        log(f"phase 5 NAND B={batch} {p.name} {mode}: decrypt_errors="
            f"{errors} on the host and on the device ({nand_s:.3f} s, "
            f"first call); launches "
            f"{ {k: nand_counts[k] for k in MODES[mode]} }, others 0")
        for name, secs in expr_s.items():
            log(f"phase 6 {name} width 16 {mode}: every lane right "
                f"({secs:.3f} s, first call)")
        if expr_s:
            log(f"phase 6 {mode}: launches of NAND and expressions "
                f"{ {k: counts[k] for k in MODES[mode]} }, others 0")
        for k in MODES[mode]:
            launches[k] += counts[k]
            nand_launches[k] += nand_counts[k]
    wg_in = nand_inputs(ks, WGMMA_NAND_B, device)
    for mode, (secs, counts) in run_wgmma_nand(ks, key, p, wg_in,
                                               device).items():
        log(f"phase 5 NAND B={WGMMA_NAND_B} {p.name} {mode} (wgmma form): "
            f"decrypt_errors=0 on the host and on the device ({secs:.3f} "
            f"s, first call); launches "
            f"{ {k: counts[k] for k in MODES[mode]} }, others 0")
        for k in MODES[mode]:
            launches[k] += counts[k]
            nand_launches[k] += counts[k]
    log(f"main-path launches: {launches}")
    log(f"main-path launches of the NAND batches alone: {nand_launches}")

    # phase 7: timing
    log(f"phase 7 card state (SM clock, its maximum, power draw, "
        f"temperature) before the timings: {card_state()}")
    for mode in MODES:
        rates = nand_rates(ks, key, mode, nand_in, device)
        line = (f"phase 7 {mode}: NAND B={batch} bootstraps/s median "
                f"{statistics.median(rates):.1f} min {min(rates):.1f} max "
                f"{max(rates):.1f} ({len(rates)} repeats; host clock around "
                f"the NAND call, decryption excluded)")
        if mode in TIMED_EXPRESSION_MODES:
            lat = expression_latency(ks, key, mode, expr_in, device)
            line += (f"; A+B-C width 16 B=8 latency median "
                     f"{statistics.median(lat):.3f} s ({len(lat)} repeats)")
        log(line)
    for mode in WGMMA_NAND_MODES:
        rates = nand_rates(ks, key, mode, wg_in, device)
        log(f"phase 7 {mode}: NAND B={WGMMA_NAND_B} (wgmma form) "
            f"bootstraps/s median {statistics.median(rates):.1f} min "
            f"{min(rates):.1f} max {max(rates):.1f} ({len(rates)} repeats)")
    steps = step_times(p, device, batch, reps=20)
    for name, t in steps.items():
        log(step_line(name, PROBE_B if name.startswith("rotate_") else batch,
                      t))
    # the split pair beside the two fused steps and the tr pair at the
    # batches of A + B - C, and the sublane rotation's gather
    by_batch = {name: {batch: steps[name]}
                for name in ("external_product", "cmux_step")}
    for b in SMALL_BATCHES:
        for name, t in step_times(p, device, b, reps=20,
                                  names=SMALL_BATCH_KERNELS,
                                  probe_b=b).items():
            log(step_line(name, b, t))
            if name in by_batch:
                by_batch[name][b] = t
    t = step_times(p, device, WGMMA_NAND_B, reps=20,
                   names=("cmux_step",))["cmux_step"]
    log(step_line("cmux_step", WGMMA_NAND_B, t))
    by_batch["cmux_step"][WGMMA_NAND_B] = t
    sms = kernels._sm_count(device)
    step_per_sm = kernels._step_per_sm(device, p.trgsw_rows, p.N)
    forms = {"external_product": lambda b: kernels.product_launch(
                 b, p.k + 1, p.N, p.trgsw_rows, sms).form,
             "cmux_step": lambda b: kernels.step_launch(
                 b, p.k + 1, p.N, p.trgsw_rows, sms, step_per_sm,
                 _resident(p, device, "cmux_step")).form,
             "blind_rotate_scan": lambda b: kernels.scan_launch(
                 b, p.k + 1, p.N, p.trgsw_rows, sms,
                 kernels._scan_per_sm(device, p.trgsw_rows, p.N),
                 _resident(p, device, "blind_rotate_scan")).form}
    # the rotations again with the L2 cold: their bytes from HBM
    for name, t in cold_times(p, device, batch).items():
        log(cold_line(name, t))
    by_batch["blind_rotate_scan"] = {}
    for b in (*SMALL_BATCHES, WGMMA_NAND_B, batch):
        t = scan_times(p, device, b, reps=2)
        log(f"phase 7 blind_rotate_scan B={b} ({forms['blind_rotate_scan'](b)}"
            f"): kernel {t['ms']:.3f} ms, plain twin {t['plain_ms']:.3f} ms "
            f"per rotation of {p.n} steps (CUDA events around the call); "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
        by_batch["blind_rotate_scan"][b] = t
    steps["blind_rotate_scan"] = t
    by_batch = {name: {b: {"ms": t["ms"], "bound_ms": t["bound_ms"],
                           "form": forms[name](b)}
                       for b, t in sorted(times.items())}
                for name, times in by_batch.items()}
    probe, probe_launches = run_probe(device)
    log("phase 7 transposed_probe: " + json.dumps(probe))
    mm_probe, mm_launches = run_mm_probe(device)
    log("phase 7 mosaic_mm_probe: " + json.dumps(mm_probe))
    # at k = 512 both types run their resident kernel
    m, _, n, g = MM_CASES[0]
    log("phase 7 mosaic_mm_probe at k=512: "
        + json.dumps(mosaic_mm_probe.run(m, 512, n, g, "both", device)))
    for k in ("rotate_lane", "rotate_sublane"):
        launches[k] = probe_launches[k]
    for k in ("mm_s8", "mm_bf16"):
        launches[k] = mm_launches[k]
    m, k, n, g = MM_CASES[0]
    for name, t in mm_times(device, reps=4).items():
        steps[name] = t
        log(f"phase 7 {name} ({m}, {k}, {n}) g={g}: kernel {t['ms']:.4f} "
            f"ms/call (graph replay), plain twin {t['plain_ms']:.4f} ms, "
            f"the library call {g} times {t['library_ms']:.4f} ms (graph "
            f"replay), bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    ks_times = keyswitch_times(p, device)
    for b, t in ks_times.items():
        log(f"phase 7 keyswitch B={b} ({t['form']}): kernel {t['ms']:.4f} "
            f"ms/call (graph replay), plain chain (four torch._int_mm and "
            f"their ops: the library path) {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    log(f"phase 7 keygen {p.name}: device {device_keygen_s:.2f} s, host "
        + (f"{keygen_s:.2f} s" if keygen_s else "not timed (cached)"))
    with step_mode("split"):
        got, want, mul32_s = run_multiply(
            ks, key, multiply_inputs(ks, 32, 32, device), False, device)
    if got != want:
        raise AssertionError(f"mul32 decrypted wrong: got {got}, want {want}")
    log(f"phase 7 mul32 B=32 windowed split: every lane right, "
        f"{mul32_s:.2f} s (one call)")
    log(f"phase 7 card state after mul32: {card_state()}")
    records = step_bench.run(
        STEP_MODES, p, STEP_BENCH["b"], STEP_BENCH["steps"],
        STEP_BENCH["iters"], device,
        emit=lambda r: log("phase 7 step_bench: " + json.dumps(r)))
    summ = step_bench.summary(records)
    log("phase 7 step_bench: " + json.dumps(summ))
    if not summ["checksums_match"]:
        raise AssertionError("step_bench: the modes' checksums differ")

    # phase 8: the evaluator, this slice's main path, counted per mode;
    # the batch of every kernel call recorded, for the check against the
    # twins at the end of the phase
    t8 = time.perf_counter()
    pair = keygen_device.generate_gate_keypair_device(p, device)
    ev_in = evaluator_inputs(pair, 16, device)
    with kernels.recording_batches() as seen:
        ev_recs, ev_launches = evaluator_modes(pair, key, ev_in, device)
        for (mode, adder), recs in ev_recs.items():
            for name, r in recs.items():
                log(f"phase 8 {name} width 16 B=8 {mode} {adder}: every "
                    f"lane right, codes {r['codes']}; the call "
                    f"{r['seconds']:.3f} s (metadata round trips "
                    f"{r['meta_s'] * 1e3:.2f} ms of it), decrypt_answer "
                    f"{r['decrypt_s'] * 1e3:.2f} ms")
        for mode, counts in ev_launches.items():
            log(f"phase 8 {mode}: launches of the evaluator "
                f"{ {k: counts[k] for k in MODES[mode]} }, others 0")
            for k in MODES[mode]:
                launches[k] += counts[k]
        for name, (kr, r) in evaluator_vs_plain(pair, key, device).items():
            log(f"phase 8 {name} width 6 B=8 kogge_stone under "
                f"IEACHE_PALLAS=0: no launch, value word equal to split's; "
                f"the call {r['seconds']:.3f} s (split {kr['seconds']:.3f} "
                f"s)")
        log(f"phase 8 widening at {p.name}: 7+7 (4 bits) + 100 and 3-6 + "
            f"100 (8 bits) read {widening_case(pair, key, device)}")
        log("phase 8 chain_memory_analysis A*B*C width 16 B=64: "
            + json.dumps(chain_memory(pair, key, device)))
        for tool, rec in tool_lines(p, device):
            log(f"phase 8 {tool}: " + json.dumps(rec))
    t0 = time.perf_counter()
    for name, err in check_wave_kernels(p, device, seen).items():
        errs[name] = max(errs[name], err)
    for name, batches in ((k, b) for k, b in seen.items() if b):
        log(f"phase 8 waves: {name} equal to its plain twin at every "
            f"batch phase 8 called it with, "
            f"B={'/'.join(map(str, sorted(batches)))}")
    log(f"phase 8 waves: {time.perf_counter() - t0:.1f} s")
    log(f"phase 8 evaluator: {time.perf_counter() - t8:.1f} s")

    # phase 9: the protocol
    protocol_phase(pair, p, device, seen, errs, launches)

    # phase 10: distribution and the key plane, this slice's main path
    dist_phase(ks, key, nand_in, pair, ev_in,
               ev_recs["split", "ripple"]["A+B-C"]["value"], device, seen,
               errs, launches)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": steps[name]["ms"], "plain_ms": steps[name]["plain_ms"],
         "bound_ms": steps[name]["bound_ms"],
         "bound_by": steps[name]["bound_by"],
         "library_ms": steps[name]["library_ms"],
         **({"by_batch": by_batch[name]} if name in by_batch else {})}
        for name, src, rep in KERNELS
    ], "keyswitch": {
        "route": "cuda", "source": "ieache_tpu_torch/csrc/keyswitch.cu",
        "replaces": "ieache_tpu/ops/keyswitch.py (XLA; no Pallas kernel)",
        "max_abs_err": ks_errs["keyswitch"], "by_batch": ks_times}}
    device_rec = {"platform": "gpu", "kind": kind,
                  "count": torch.cuda.device_count()}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": device_rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
