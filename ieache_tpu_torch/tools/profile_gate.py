"""Where the time of a gate batch and of an expression goes on the card.

Runs one NAND batch (gate throughput's shape) and one ``A + B - C`` on
signed words (expression latency's shape) under each step mode asked
for, each once to warm up and once under ``torch.profiler`` (CPU and
CUDA activities), and prints one JSON line per run: the wall time (host
clock, ``torch.cuda.synchronize`` fences), the device's busy time (the
sum of every kernel's and copy's device time; one stream, so they do not
overlap), its idle share (1 - busy / wall), the number of kernels and
copies, and the kernels that take most of the busy time with their calls, ms and share.
Keys come from the device keygen, operands from a seed.  Run from the
root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.profile_gate

Env: PG_MODES (comma list, default ``split,scan``), PG_B (NAND batch,
1024), PG_LANES (lanes of the expression, 8), PG_WIDTH (16), PG_PARAMS
(ieache_110_l2, or ieache_110), PG_TOP (kernels listed, 6).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ieache_tpu_torch import prng
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.circuits import arith, words
from ieache_tpu_torch.lwe import encrypt, keygen_device
from ieache_tpu_torch.tools._common import (
    PARAMS,
    card_line,
    environ,
    require_cuda,
    sync,
)


def profile_call(fn, device, top: int = 6) -> dict:
    """``fn`` once to warm up, then once under the profiler.  On a CUDA
    device the rows are the device's kernels and copies and ``busy_ms``
    their summed device time; on the CPU (the tests' rehearsal) the rows
    are the host's ops by self time and nothing is said of a device."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    fn()
    sync(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if on_card:
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
        else:
            us = evt.self_cpu_time_total
        rows.append((evt.key, evt.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    rec = {"wall_ms": wall_ms, "events": sum(r[1] for r in rows),
           "rows": [{"name": name[:96], "calls": calls, "ms": ms,
                     "share": ms / busy_ms if busy_ms else 0.0}
                    for name, calls, ms in rows[:top]]}
    if on_card:
        if not busy_ms:
            raise RuntimeError("the profiler recorded no device time")
        rec.update(busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms)
    return rec


def nand_case(ks, key, batch: int, device):
    """A callable running NAND on ``batch`` random bit pairs (seed 2026),
    and a check that its last result decrypts right."""
    stream = prng.key_from_seed_words([2026])
    x = prng.uniform_bits01(prng.derive(stream, 0), batch)
    y = prng.uniform_bits01(prng.derive(stream, 1), batch)
    cx = encrypt.encrypt_bits(ks, x, prng.derive(stream, 2), device)
    cy = encrypt.encrypt_bits(ks, y, prng.derive(stream, 3), device)
    out = []

    def run():
        out[:] = [gates.NAND(cx, cy, key)]

    def errors() -> int:
        return int((encrypt.decrypt_bits(ks, out[0]) != 1 - (x & y)).sum())

    return run, errors


def expression_case(ks, key, width: int, lanes: int, device, seed: int = 7):
    """A callable running ``A + B - C`` (ripple adder, then subtractor)
    on ``lanes`` signed ``width``-bit words, and a check that every lane
    of its last result decrypts to the Python value."""
    rng = np.random.RandomState(seed)
    lim = 1 << (width - 3)
    a, b, c = (rng.randint(-lim, lim, lanes).tolist() for _ in range(3))
    stream = prng.key_from_seed_words([seed, width])
    ca, cb, cc = (words.encrypt_word(ks, v, width, prng.derive(stream, i),
                                     device)
                  for i, v in enumerate((a, b, c)))
    out = []

    def run():
        zero = gates.CONSTANT(torch.zeros(lanes, dtype=torch.int32,
                                          device=device), key.params.n)
        s, _ = arith.ripple_add(ca, cb, zero, key)
        out[:] = [arith.ripple_sub(s, cc, key)[0]]

    def errors() -> int:
        got = words.decrypt_word_signed(ks, out[0])
        return sum(g != x + y - z for g, x, y, z in zip(got, a, b, c))

    return run, errors


def run(ks, modes, batch: int, lanes: int, width: int, device, top: int = 6,
        emit=None) -> list:
    """One record per (mode, workload) on ``device``; a run whose result
    decrypts wrong raises."""
    key = bootstrap.pack_cloud_key(ks.cloud, device)
    cases = [(f"NAND B={batch}", nand_case(ks, key, batch, device)),
             (f"A+B-C width {width} B={lanes}",
              expression_case(ks, key, width, lanes, device))]
    records = []
    for mode in modes:
        for name, (fn, errors) in cases:
            with environ("IEACHE_PALLAS_STEP", mode):
                rec = {"mode": mode, "workload": name,
                       "params": ks.params.name,
                       **profile_call(fn, device, top)}
            rec["decrypt_errors"] = errors()
            if rec["decrypt_errors"]:
                raise RuntimeError(f"{name} under {mode}: "
                                   f"{rec['decrypt_errors']} lanes wrong")
            records.append(rec)
            if emit is not None:
                emit(rec)
    return records


def main() -> int:
    device = require_cuda("profile_gate")

    def env(name, default):
        return os.environ.get("PG_" + name, default)

    p = PARAMS[env("PARAMS", "ieache_110_l2")]
    ks = keygen_device.generate_secret_keyset_device(p, device)
    kind, card = torch.cuda.get_device_name(device), card_line()
    run(ks, [m.strip() for m in env("MODES", "split,scan").split(",")],
        int(env("B", 1024)), int(env("LANES", 8)), int(env("WIDTH", 16)),
        device, int(env("TOP", 6)),
        emit=lambda r: print(json.dumps({**r, "device": kind, "card": card}),
                             flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
