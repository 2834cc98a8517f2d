"""Reference-width arithmetic on the card: mul32/64/128 and a 256-bit add.

Counterpart of ``tools/width_bench.py``: the reference's heaviest
capabilities through the full :class:`~ieache_tpu_torch.circuits.
evaluator.CloudEvaluator` (``compute``: metadata, sign dispatch, circuit,
answer metadata) at λ=110, every lane decrypted by ``decrypt_answer``
and checked.  Per case, a first pass and a warm pass (each compute +
decrypt; with the kernels built, the two differ by what the first call
pays once), and one JSON line with the JAX tool's keys (``errors``
counts both passes), ``seconds_decrypt`` (the warm pass's
``decrypt_answer`` alone: the value word comes to the host), and
``backend``, ``step_mode`` and ``card``.  Keys come from the device
keygen (the main and nbit keysets of the JAX tool's ``.keycache/``,
array for array).  Run from the root of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.width_bench

Env: WB_PARAMS (ieache_110_l2, the default; ieache_110; test_tiny),
WB_CASES (comma list from mul32, mul64, mul128, add256; all four).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ieache_tpu_torch import params as P
from ieache_tpu_torch import prng
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.lwe import keygen_device
from ieache_tpu_torch.tools._common import line_fields, require_cuda, sync

#: name: (op, width, batch); mul32 at B=32 makes 1024-lane waves, the
#: windowed CSA's b·(W+1) lanes (1056 at mul32) are no power of two
CASES = {
    "mul32": ("mul", 32, 32),
    "mul64": ("mul", 64, 8),
    "mul128": ("mul", 128, 4),
    "add256": ("add", 256, 256),
}

#: WB_PARAMS names
PARAMS = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
          "test_tiny": P.TEST_TINY}


def rand_vals(rng, width: int, batch: int) -> list:
    """Random signed magnitudes spanning the full width (the JAX tool's
    draw)."""
    out = []
    for _ in range(batch):
        v = int(rng.randint(1, 2 ** 31))
        for _ in range((width - 1) // 31):
            v = (v << 31) | int(rng.randint(0, 2 ** 31))
        v &= (1 << width) - 1
        v = max(v, 1)
        out.append(-v if rng.rand() < 0.5 else v)
    return out


def run(names, p, device, cases=CASES, emit=None) -> list:
    """One record per case name of ``cases``, on ``device``, in order;
    ``emit`` is called with each record as it is made."""
    pair = keygen_device.generate_gate_keypair_device(p, device)
    main_ks, nbit_ks = pair.main, pair.nbit
    cloud = ev.CloudEvaluator(bootstrap.pack_cloud_key(main_ks.cloud, device),
                              nbit_ks)
    rng = np.random.RandomState(7)
    fields = line_fields(device)
    records = []
    for name in names:
        op_kind, width, batch = cases[name]
        a_vals = rand_vals(rng, width, batch)
        b_vals = rand_vals(rng, width, batch)
        op = ev.OP_MUL if op_kind == "mul" else ev.OP_ADD
        if op_kind == "add":
            # magnitude adds must fit the operand width
            a_vals = [abs(v) >> 1 for v in a_vals]
            b_vals = [abs(v) >> 1 for v in b_vals]
            want = [x + y for x, y in zip(a_vals, b_vals)]
        else:
            want = [x * y for x, y in zip(a_vals, b_vals)]

        s = prng.key_from_seed_words([0xB0B, width, batch])
        t0 = time.perf_counter()
        a = ev.encrypt_operand(main_ks, nbit_ks, a_vals, width,
                               prng.derive(s, 0), device)
        b = ev.encrypt_operand(main_ks, nbit_ks, b_vals, width,
                               prng.derive(s, 1), device)
        sync(device)
        t_enc = time.perf_counter() - t0

        def one_pass():
            """compute + decrypt: (wrong lanes, seconds, decrypt s)."""
            t0 = time.perf_counter()
            ans, _ = cloud.compute(op, a, b)
            sync(device)
            t1 = time.perf_counter()
            got = ev.decrypt_answer(main_ks, nbit_ks, ans, op)
            t2 = time.perf_counter()
            return (sum(1 for g, w in zip(got, want) if g != w), t2 - t0,
                    t2 - t1)

        gates0 = cloud.gate_count
        errors, cold, _ = one_pass()
        gates = cloud.gate_count - gates0
        wrong, warm, t_dec = one_pass()
        errors += wrong

        rec = {
            "case": name,
            "op": op_kind,
            "width": width,
            "batch": batch,
            "gates_per_pass": gates,
            "bootstraps_per_sec": round(gates / warm, 1),
            "seconds_warm": round(warm, 2),
            "seconds_cold_incl_compile": round(cold, 2),
            "seconds_encrypt": round(t_enc, 2),
            "seconds_decrypt": round(t_dec, 3),
            "errors": errors,
            "params": p.name,
            "mul_mode": os.environ.get("IEACHE_MUL", "csa"),
            **fields,
        }
        records.append(rec)
        if emit is not None:
            emit(rec)
    return records


def main() -> int:
    device = require_cuda("width_bench")
    p = PARAMS[os.environ.get("WB_PARAMS", "ieache_110_l2")]
    names = os.environ.get("WB_CASES", "mul32,mul64,mul128,add256")
    run(names.split(","), p, device,
        emit=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
