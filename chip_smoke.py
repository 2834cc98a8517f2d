#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ieache_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc``, and refuses to run without them.
Phases, each printed on lines of its own; any failure raises, so the
script exits nonzero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels of ``ieache_tpu_torch/csrc``;
3. each kernel against its plain PyTorch twin, exact equality, at
   IEACHE_110_FAST and the main path's batches (B=1024 for NAND, 8 and
   16 for the rounds of ``A + B - C``), at ragged B in {1, 5, 1056} and
   at rotation amounts {0, N, 2N-1, random};
4. a whole B=1024 bootstrap, kernel path against plain path;
5. main path, NAND: keygen at IEACHE_110_FAST, NAND on 1024 random bit
   pairs, decrypt; ``decrypt_errors`` must be 0;
6. main path, ``A + B - C``: 16-bit signed words, 8 lanes, through
   ``ripple_add`` then ``ripple_sub``; every lane must decrypt to the
   Python result.  The kernels' launch counts are reset just before
   phase 5 and read just after phase 6: both must be > 0;
7. timing: NAND bootstraps/s over 5 repeats and the latency of
   ``A + B - C`` (host clock, ``torch.cuda.synchronize`` fences); ms
   per CMux step of each kernel beside its twin (CUDA events around a
   CUDA-graph replay, and around a plain Python loop).

The next-to-last line is a JSON object with one entry per kernel
(route, source, the Pallas kernel it replaces, launches in the main
path, max abs error against the twin, ms and plain ms per call); the
last line is ``{"ok": true, "device": {...}}``.  The secret keyset is
cached in ``.keycache/`` (the JAX package's bench uses the same file).
"""

from __future__ import annotations

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
from ieache_tpu_torch.circuits import arith, words
from ieache_tpu_torch.lwe import encrypt
from ieache_tpu_torch.ops import _build, kernels

ROOT = os.path.dirname(os.path.abspath(__file__))

#: (name, source, the Pallas kernel it replaces)
KERNELS = [
    ("rot_diff_decompose", "ieache_tpu_torch/csrc/rot_diff_decompose.cu",
     "ieache_tpu/ops/pallas_kernels.py:856"),
    ("external_product", "ieache_tpu_torch/csrc/external_product.cu",
     "ieache_tpu/ops/pallas_kernels.py:61"),
]


def log(*args):
    print(*args, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    between two CUDA events (host cost per call included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rand(rng, shape, lo, hi, dtype, device):
    return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                            .astype(dtype)).to(device)


def _compare(name, got, want, errs, device, case):
    _sync(device)
    if got.shape != want.shape:
        raise AssertionError(f"{name} at {case}: shape {tuple(got.shape)}, "
                             f"plain twin {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain twin at {case}: "
                             f"max abs err {err}")


def check_kernels(p, device, batches, seed=0):
    """Phase 3: each kernel against its plain twin; returns max abs
    error per kernel (0 when all equal)."""
    rng = np.random.RandomState(seed)

    def rand(shape, lo, hi, dtype):
        return _rand(rng, shape, lo, hi, dtype, device)

    errs = {}
    for b in batches:
        acc = rand((p.k + 1, b, p.N), -2**31, 2**31, np.int32)
        for amount in ("random", 0, p.N, 2 * p.N - 1):
            bara = (rand((b,), 0, 2 * p.N, np.int32) if amount == "random"
                    else torch.full((b,), amount, dtype=torch.int32,
                                    device=device))
            _compare("rot_diff_decompose",
                     kernels.rot_diff_decompose(acc, bara, p),
                     kernels.rot_diff_decompose_plain(acc, bara, p),
                     errs, device, f"B={b} bara={amount}")
        d = rand((p.trgsw_rows, b, p.N), -128, 128, np.int8)
        bk_i = rand((p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32)
        for fused in (False, True):
            a = acc if fused else None
            _compare("external_product",
                     kernels.external_product(d, bk_i, p, acc=a),
                     kernels.external_product_plain(d, bk_i, p, a),
                     errs, device, f"B={b} acc={fused}")
        log(f"phase 3 kernels: B={b} equal (rot amounts random/0/N/2N-1, "
            f"external product with and without acc)")
    return errs


def load_keyset(p):
    """The secret keyset for ``p``, from .keycache/ or generated (host)."""
    path = os.path.join(ROOT, ".keycache", f"{p.name}.iek")
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
    """Phase 4: the whole bootstrap, kernel path against plain path."""
    got = bootstrap.bootstrap(cx, key)
    want = bootstrap.bootstrap(cx, key, plain=True)
    _sync(device)
    if not torch.equal(got, want):
        raise AssertionError("bootstrap: kernel path differs from plain path")


def run_nand(ks, key, inputs, device):
    """Phase 5: NAND on the batch; returns (decrypt_errors, seconds)."""
    x, y, cx, cy = inputs
    t0 = time.perf_counter()
    out = gates.NAND(cx, cy, key)
    _sync(device)
    dt = time.perf_counter() - t0
    if tuple(out.shape) != (len(x), ks.params.n + 1):
        raise AssertionError(f"NAND output shape {tuple(out.shape)}")
    errors = int((encrypt.decrypt_bits(ks, out) != 1 - (x & y)).sum())
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
    _sync(device)
    dt = time.perf_counter() - t0
    got = words.decrypt_word_signed(ks, r)
    want = [x + y - z for x, y, z in zip(a, b, c)]
    return got, want, dt


def _graph_ms(fn, reps):
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the host's per-call cost (the
    Python wrapper, the launch) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_times(p, device, batch, reps):
    """Phase 7: ms per CMux step of each kernel and of its plain twin at
    the main-path shapes, on a CUDA ``device``: ``ms``/``plain_ms`` on
    the device (CUDA graph replay), ``host_ms``/``plain_host_ms`` per
    call of a Python loop (launch cost included)."""
    rng = np.random.RandomState(1)
    acc = _rand(rng, (p.k + 1, batch, p.N), -2**31, 2**31, np.int32, device)
    bara = _rand(rng, (batch,), 0, 2 * p.N, np.int32, device)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 device)
    d = kernels.rot_diff_decompose(acc, bara, p)
    calls = {
        "rot_diff_decompose": (
            lambda: kernels.rot_diff_decompose(acc, bara, p),
            lambda: kernels.rot_diff_decompose_plain(acc, bara, p)),
        "external_product": (
            lambda: kernels.external_product(d, bk_i, p, acc=acc),
            lambda: kernels.external_product_plain(d, bk_i, p, acc)),
    }
    return {name: {"host_ms": _time_ms(kern, reps),
                   "plain_host_ms": _time_ms(plain, reps),
                   "ms": _graph_ms(kern, reps),
                   "plain_ms": _graph_ms(plain, reps)}
            for name, (kern, plain) in calls.items()}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "one and does not fall back to the CPU")
    device = torch.device("cuda", torch.cuda.current_device())
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

    # keys and operands (set-up)
    ks, keygen_s = load_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    log(f"keys: {p.name} keygen {keygen_s:.1f} s "
        f"({'cached' if keygen_s == 0 else 'generated'}); bk "
        f"{key.bk.numel() * 4 / 1e6:.1f} MB, ks_limbs "
        f"{key.ks_limbs.numel() / 1e6:.1f} MB on {device}")
    nand_in = nand_inputs(ks, batch, device)
    expr_in = expression_inputs(ks, 16, 8, device)

    # phase 4: whole bootstrap, kernel path against plain path
    bootstrap_vs_plain(key, nand_in[2], device)
    if not (kernels.rot_diff_decompose.launches
            and kernels.external_product.launches):
        raise AssertionError("phase 4 ran no kernel launch")
    log(f"phase 4 bootstrap B={batch}: kernel path equal to plain path")

    # phases 5 and 6: the main path, with the launch counts from 0
    kernels.rot_diff_decompose.launches = 0
    kernels.external_product.launches = 0
    errors, nand_s = run_nand(ks, key, nand_in, device)
    got, want, expr_s = run_expression(ks, key, expr_in, device)
    launches = {"rot_diff_decompose": kernels.rot_diff_decompose.launches,
                "external_product": kernels.external_product.launches}
    log(f"phase 5 NAND B={batch} {p.name}: decrypt_errors={errors} "
        f"({nand_s:.3f} s, first call)")
    if errors:
        raise AssertionError(f"NAND decrypt_errors={errors}")
    log(f"phase 6 A+B-C width 16 B=8: got {got}, want {want} "
        f"({expr_s:.3f} s, first call)")
    if got != want:
        raise AssertionError("A + B - C decrypted wrong")
    log(f"main-path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    # phase 7: timing
    nand_rates = []
    for _ in range(5):
        e, dt = run_nand(ks, key, nand_in, device)
        if e:
            raise AssertionError(f"NAND decrypt_errors={e} in a timed repeat")
        nand_rates.append(batch / dt)
    expr_lat = []
    for _ in range(3):
        g, w, dt = run_expression(ks, key, expr_in, device)
        if g != w:
            raise AssertionError("A + B - C decrypted wrong in a timed repeat")
        expr_lat.append(dt)
    steps = step_times(p, device, batch, reps=20)
    log(f"phase 7 NAND B={batch}: bootstraps/s median "
        f"{statistics.median(nand_rates):.1f} min {min(nand_rates):.1f} "
        f"max {max(nand_rates):.1f} (5 repeats; host clock around the "
        f"NAND call, decryption excluded)")
    for name, t in steps.items():
        log(f"phase 7 {name} B={batch}: kernel {t['ms']:.4f} ms/step, "
            f"plain twin {t['plain_ms']:.4f} ms/step on the device (graph "
            f"replay); from a Python loop {t['host_ms']:.4f} and "
            f"{t['plain_host_ms']:.4f} ms/call")
    log(f"phase 7 A+B-C width 16 B=8: latency median "
        f"{statistics.median(expr_lat):.3f} s (3 repeats)")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": steps[name]["ms"], "plain_ms": steps[name]["plain_ms"]}
        for name, src, rep in KERNELS
    ]}
    device_rec = {"platform": "gpu", "kind": kind,
                  "count": torch.cuda.device_count()}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": device_rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
