#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ieache_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc``, and refuses to run without them.
The blind rotation has five step modes (``IEACHE_PALLAS_STEP``), each
with its own kernels: ``split`` (rot_diff_decompose + external_product
per step), ``fused2`` (cmux_step), ``overlap`` and ``overlap2``
(cmux_step_overlap) and ``scan`` (blind_rotate_scan, all steps in one
launch).  Phases, each printed on lines of its own; any failure raises,
so the script exits nonzero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels of ``ieache_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. each of the five kernels against its plain PyTorch twin, exact
   equality, at IEACHE_110_FAST and the main path's batches (B=1024 for
   NAND, 8 and 16 for the rounds of ``A + B - C``), at ragged B in
   {1, 5, 1056} and at rotation amounts {0, N, 2N-1, random}; the scan
   kernel over all n=500 steps;
4. a whole B=1024 bootstrap under each step mode against the plain
   path, and the compat gadget's blind rotation (no kernel; the plain
   step on the card) at B=8 against ``plain=True``;
5. main path, NAND under each step mode: keygen at IEACHE_110_FAST,
   NAND on 1024 random bit pairs, decrypt; ``decrypt_errors`` must be
   0.  Every launch count is reset just before a mode's run and read
   just after it: the mode's kernels must have launched, and no other;
6. main path, ``A + B - C`` under ``split`` and ``scan`` (inside their
   mode's counted run): 16-bit signed words, 8 lanes, through
   ``ripple_add`` then ``ripple_sub``; every lane must decrypt to the
   Python result;
7. timing, per mode: NAND bootstraps/s over 5 repeats and the latency
   of ``A + B - C`` (host clock, ``torch.cuda.synchronize`` fences; one
   repeat for a mode slower than 3 s); ms per CMux step of each step
   kernel beside its twin (CUDA events around a CUDA-graph replay, and
   around a plain Python loop), and ms per whole rotation of the scan
   kernel and its twin at B=8 and B=1024 (CUDA events around the call).

The next-to-last line is a JSON object with one entry per kernel
(route, source, the Pallas kernel it replaces, launches in the main
path, max abs error against the twin, ms and plain ms per call at
B=1024); the last line is ``{"ok": true, "device": {...}}``.  The
secret keyset is cached in ``.keycache/`` (the JAX package's bench uses
the same file).
"""

from __future__ import annotations

import contextlib
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
from ieache_tpu_torch.ops.blind_rotate import blind_rotate

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
]

#: the kernels each step mode launches
MODES = {
    "split": ("rot_diff_decompose", "external_product"),
    "fused2": ("cmux_step",),
    "overlap": ("cmux_step_overlap",),
    "overlap2": ("cmux_step_overlap",),
    "scan": ("blind_rotate_scan",),
}

#: the modes that also run A + B - C in the counted main path
EXPRESSION_MODES = ("split", "scan")


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def step_mode(mode):
    """Run the block under ``IEACHE_PALLAS_STEP=mode``."""
    saved = os.environ.get("IEACHE_PALLAS_STEP")
    os.environ["IEACHE_PALLAS_STEP"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("IEACHE_PALLAS_STEP", None)
        else:
            os.environ["IEACHE_PALLAS_STEP"] = saved


def reset_launches():
    for name, _, _ in KERNELS:
        getattr(kernels, name).launches = 0


def read_launches():
    return {name: getattr(kernels, name).launches for name, _, _ in KERNELS}


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
        bk_i = rand((p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32)
        for amount in ("random", 0, p.N, 2 * p.N - 1):
            bara = (rand((b,), 0, 2 * p.N, np.int32) if amount == "random"
                    else torch.full((b,), amount, dtype=torch.int32,
                                    device=device))
            case = f"B={b} bara={amount}"
            _compare("rot_diff_decompose",
                     kernels.rot_diff_decompose(acc, bara, p),
                     kernels.rot_diff_decompose_plain(acc, bara, p),
                     errs, device, case)
            want = kernels.cmux_step_plain(acc, bara, bk_i, p)
            for name in ("cmux_step", "cmux_step_overlap"):
                _compare(name, getattr(kernels, name)(acc, bara, bk_i, p),
                         want, errs, device, case)
        d = rand((p.trgsw_rows, b, p.N), -128, 128, np.int8)
        for fused in (False, True):
            a = acc if fused else None
            _compare("external_product",
                     kernels.external_product(d, bk_i, p, acc=a),
                     kernels.external_product_plain(d, bk_i, p, a),
                     errs, device, f"B={b} acc={fused}")
        # the whole rotation; the edge amounts in the first three steps
        bara_n = rand((b, p.n), 0, 2 * p.N, np.int32)
        bara_n[:, :3] = torch.tensor([0, p.N, 2 * p.N - 1],
                                     dtype=torch.int32, device=device)
        bk = rand((p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                  np.int32)
        _compare("blind_rotate_scan",
                 kernels.blind_rotate_scan(acc, bara_n, bk, p),
                 kernels.blind_rotate_scan_plain(acc, bara_n, bk, p),
                 errs, device, f"B={b} steps={p.n}")
        log(f"phase 3 kernels: B={b} equal (rot amounts random/0/N/2N-1 "
            f"for rotate, cmux_step and cmux_step_overlap; external "
            f"product with and without acc; scan over {p.n} steps)")
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
    """Phase 4: the whole bootstrap under each step mode against the
    plain path."""
    want = bootstrap.bootstrap(cx, key, plain=True)
    for mode in MODES:
        with step_mode(mode):
            got = bootstrap.bootstrap(cx, key)
        _sync(device)
        if not torch.equal(got, want):
            raise AssertionError(f"bootstrap under {mode} differs from the "
                                 f"plain path")


def compat_vs_plain(p, device, batch, seed=3):
    """Phase 4: the compat gadget's blind rotation on random inputs,
    under the default step mode, against ``plain=True``; neither has a
    kernel, and the default path must not refuse it."""
    rng = np.random.RandomState(seed)
    acc0 = _rand(rng, (batch, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 device)
    bara = _rand(rng, (batch, p.n), 0, 2 * p.N, np.int32, device)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    got = blind_rotate(acc0, bara, bk, p)
    want = blind_rotate(acc0, bara, bk, p, plain=True)
    _sync(device)
    if not torch.equal(got, want):
        raise AssertionError(f"{p.name} blind rotation differs from "
                             f"plain=True")


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


def run_mode(ks, key, mode, nand_in, expr_in, device):
    """Phases 5 and 6 under one step mode, with every launch count set
    to 0 just before and read just after: on a CUDA device the mode's
    kernels must have launched and no other.  Returns (decrypt_errors,
    NAND seconds, expression seconds or None, launches)."""
    reset_launches()
    with step_mode(mode):
        errors, nand_s = run_nand(ks, key, nand_in, device)
        expr_s = None
        if mode in EXPRESSION_MODES:
            got, want, expr_s = run_expression(ks, key, expr_in, device)
            if got != want:
                raise AssertionError(f"A + B - C under {mode} decrypted "
                                     f"wrong: got {got}, want {want}")
    launches = read_launches()
    if errors:
        raise AssertionError(f"NAND under {mode}: decrypt_errors={errors}")
    if device.type != "cuda":
        # CPU tensors run the plain twins, which launch nothing
        if any(launches.values()):
            raise AssertionError(f"{mode} on {device}: {launches}")
        return errors, nand_s, expr_s, launches
    unlaunched = [k for k in MODES[mode] if not launches[k]]
    stray = [k for k, n in launches.items() if n and k not in MODES[mode]]
    if unlaunched or stray:
        raise AssertionError(f"{mode}: kernels not launched {unlaunched}, "
                             f"launched by another mode {stray}: {launches}")
    return errors, nand_s, expr_s, launches


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
    """Phase 7: ms per CMux step of each step kernel and of its plain
    twin at the main-path shapes, on a CUDA ``device``: ``ms``/``plain_ms``
    on the device (CUDA graph replay), ``host_ms``/``plain_host_ms`` per
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
        "cmux_step": (
            lambda: kernels.cmux_step(acc, bara, bk_i, p),
            lambda: kernels.cmux_step_plain(acc, bara, bk_i, p)),
        "cmux_step_overlap": (
            lambda: kernels.cmux_step_overlap(acc, bara, bk_i, p),
            lambda: kernels.cmux_step_plain(acc, bara, bk_i, p)),
    }
    return {name: {"host_ms": _time_ms(kern, reps),
                   "plain_host_ms": _time_ms(plain, reps),
                   "ms": _graph_ms(kern, reps),
                   "plain_ms": _graph_ms(plain, reps)}
            for name, (kern, plain) in calls.items()}


def scan_times(p, device, batch, reps):
    """Phase 7: ms per whole rotation (n steps) of the scan kernel and
    of its plain twin, CUDA events around each call."""
    rng = np.random.RandomState(2)
    acc = _rand(rng, (p.k + 1, batch, p.N), -2**31, 2**31, np.int32, device)
    bara = _rand(rng, (batch, p.n), 0, 2 * p.N, np.int32, device)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, device)
    return {"ms": _time_ms(
                lambda: kernels.blind_rotate_scan(acc, bara, bk, p), reps),
            "plain_ms": _time_ms(
                lambda: kernels.blind_rotate_scan_plain(acc, bara, bk, p),
                reps)}


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

    # phase 4: whole bootstrap under each mode against the plain path;
    # the compat gadget's rotation (no kernel) against plain=True
    reset_launches()
    bootstrap_vs_plain(key, nand_in[2], device)
    if not all(read_launches().values()):
        raise AssertionError(f"phase 4 left a kernel unlaunched: "
                             f"{read_launches()}")
    log(f"phase 4 bootstrap B={batch}: {', '.join(MODES)} each equal to "
        f"the plain path")
    compat_vs_plain(P.IEACHE_110_TFHE_COMPAT, device, 8)
    log(f"phase 4 {P.IEACHE_110_TFHE_COMPAT.name} blind rotation B=8: "
        f"runs, equal to plain=True")

    # phases 5 and 6: the main path under each mode, counted from 0
    launches = dict.fromkeys(read_launches(), 0)
    for mode in MODES:
        errors, nand_s, expr_s, counts = run_mode(ks, key, mode, nand_in,
                                                  expr_in, device)
        log(f"phase 5 NAND B={batch} {p.name} {mode}: decrypt_errors="
            f"{errors} ({nand_s:.3f} s, first call); launches "
            f"{ {k: counts[k] for k in MODES[mode]} }, others 0")
        if expr_s is not None:
            log(f"phase 6 A+B-C width 16 B=8 {mode}: every lane right "
                f"({expr_s:.3f} s, first call)")
        for k in MODES[mode]:
            launches[k] += counts[k]
    log(f"main-path launches: {launches}")

    # phase 7: timing
    for mode in MODES:
        with step_mode(mode):
            rates = []
            for _ in range(5):
                e, dt = run_nand(ks, key, nand_in, device)
                if e:
                    raise AssertionError(f"NAND decrypt_errors={e} under "
                                         f"{mode} in a timed repeat")
                rates.append(batch / dt)
            lat = []
            while len(lat) < 3 and (not lat or lat[0] < 3.0):
                g, w, dt = run_expression(ks, key, expr_in, device)
                if g != w:
                    raise AssertionError(f"A + B - C under {mode} decrypted "
                                         f"wrong in a timed repeat")
                lat.append(dt)
        log(f"phase 7 {mode}: NAND B={batch} bootstraps/s median "
            f"{statistics.median(rates):.1f} min {min(rates):.1f} max "
            f"{max(rates):.1f} (5 repeats; host clock around the NAND "
            f"call, decryption excluded); A+B-C width 16 B=8 latency "
            f"median {statistics.median(lat):.3f} s ({len(lat)} "
            f"repeat{'s' if len(lat) > 1 else ''})")
    steps = step_times(p, device, batch, reps=20)
    for name, t in steps.items():
        log(f"phase 7 {name} B={batch}: kernel {t['ms']:.4f} ms/step, "
            f"plain twin {t['plain_ms']:.4f} ms/step on the device (graph "
            f"replay); from a Python loop {t['host_ms']:.4f} and "
            f"{t['plain_host_ms']:.4f} ms/call")
    for b in (8, batch):
        t = scan_times(p, device, b, reps=2)
        log(f"phase 7 blind_rotate_scan B={b}: kernel {t['ms']:.3f} ms, "
            f"plain twin {t['plain_ms']:.3f} ms per rotation of {p.n} "
            f"steps (CUDA events around the call)")
    steps["blind_rotate_scan"] = t

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
