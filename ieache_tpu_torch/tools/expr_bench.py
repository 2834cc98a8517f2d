"""Batched end-to-end expression benchmark on the card.

Counterpart of ``tools/expr_bench.py``: B parallel 3-operand expressions
(one of the six of the reference paper's Fig. 7) on random positive
``EB_WIDTH``-bit operands, through the full
:class:`~ieache_tpu_torch.circuits.evaluator.CloudEvaluator`: left folds
by ``compute_chain``, the mul-first trees by ``compute_steps`` (or, with
``EB_CHAIN=0``, one ``compute`` per op), every lane decrypted by
``decrypt_answer`` and checked.  A first pass and a warm pass (each
compute + decrypt over ``EB_CHUNK``-lane chunks), and one JSON line with
the JAX tool's keys (``errors`` counts both passes; ``dp`` is 1: the
port has no dist layer yet) and ``backend``, ``step_mode`` and
``card``.  Keys come from the device keygen.  Run from the root of a
checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.expr_bench

Env: EB_EXPR (add_add = A+B+C, add_sub = A+B-C (the default), sub_sub =
A-B-C, mul_add = A+B*C, add_mul = A-B*C, mul_mul = A*B*C), EB_BATCH
(256), EB_WIDTH (16), EB_PARAMS (ieache_110, the default;
ieache_110_l2; test_tiny; test_small_noisy), EB_ADDER (ripple |
kogge_stone), EB_CHAIN (1; 0 for one ``compute`` per op), EB_CHUNK (0:
one pass over the whole batch).
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

#: EB_PARAMS names
PARAMS = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
          "test_tiny": P.TEST_TINY, "test_small_noisy": P.TEST_SMALL_NOISY}

#: the six expressions of the reference paper's Fig. 7: (display,
#: left-fold ops or None, step list or None, plaintext function,
#: reference seconds per expression)
FIG7 = {
    "add_add": ("A+B+C", [ev.OP_ADD, ev.OP_ADD], None,
                lambda x, y, z: x + y + z, 142.0),
    "add_sub": ("A+B-C", [ev.OP_ADD, ev.OP_SUB], None,
                lambda x, y, z: x + y - z, 149.0),
    "sub_sub": ("A-B-C", [ev.OP_SUB, ev.OP_SUB], None,
                lambda x, y, z: x - y - z, 159.0),
    "mul_add": ("A+B*C", None,
                [(ev.OP_MUL, ("opnd", 1), ("opnd", 2)),
                 (ev.OP_ADD, ("opnd", 0), ("step", 0))],
                lambda x, y, z: x + y * z, 329.0),
    "add_mul": ("A-B*C", None,
                [(ev.OP_MUL, ("opnd", 1), ("opnd", 2)),
                 (ev.OP_SUB, ("opnd", 0), ("step", 0))],
                lambda x, y, z: x - y * z, 359.0),
    "mul_mul": ("A*B*C", [ev.OP_MUL, ev.OP_MUL], None,
                lambda x, y, z: x * y * z, 563.0),
}


def _slice_op(o, lo, hi):
    return ev.Operand(o.neg_word[lo:hi], o.bit_word[lo:hi],
                      o.value[lo:hi], o.carry_word[lo:hi])


def run(expr: str, p, batch: int, width: int, device, adder: str = "ripple",
        chain: bool = True, chunk: int = 0) -> dict:
    """The benchmark's record on ``device``."""
    if expr not in FIG7:
        raise ValueError(f"EB_EXPR must be one of {sorted(FIG7)}")
    if chunk and batch % chunk:
        raise ValueError(f"EB_CHUNK {chunk} must divide batch {batch}")
    disp, fold_ops, step_list, plain, ref_s = FIG7[expr]
    pair = keygen_device.generate_gate_keypair_device(p, device)
    main_ks, nbit_ks = pair.main, pair.nbit
    cloud = ev.CloudEvaluator(bootstrap.pack_cloud_key(main_ks.cloud, device),
                              nbit_ks, adder=adder)

    rng = np.random.RandomState(0)
    hi = 1 << (width - 2)
    a_vals = rng.randint(1, hi, batch)
    b_vals = rng.randint(1, hi, batch)
    c_vals = rng.randint(1, hi, batch)

    stream = prng.key_from_seed_words([0xE1, batch, width])
    t0 = time.perf_counter()
    a, b, c = (ev.encrypt_operand(main_ks, nbit_ks, vals, width,
                                  prng.derive(stream, i), device)
               for i, vals in enumerate((a_vals, b_vals, c_vals)))
    sync(device)
    t_enc = time.perf_counter() - t0
    n_chunks = (batch // chunk) if chunk else 1

    def run_expr(ai, bi, ci):
        if fold_ops is not None:
            if chain:
                ans, _ = cloud.compute_chain(fold_ops, [ai, bi, ci])
            else:
                ab, _ = cloud.compute(fold_ops[0], ai, bi)
                ans, _ = cloud.compute(fold_ops[1], ab, ci)
            return ans, fold_ops[-1]
        if chain:
            ans, _ = cloud.compute_steps(step_list, [ai, bi, ci])
        else:
            bc, _ = cloud.compute(ev.OP_MUL, bi, ci)
            ans, _ = cloud.compute(step_list[-1][0], ai, bc)
        return ans, step_list[-1][0]

    def one_pass():
        """All chunks through compute + decrypt: (wrong lanes, seconds)."""
        t0 = time.perf_counter()
        wrong = 0
        for j in range(n_chunks):
            lo = j * chunk if chunk else 0
            hi_ = lo + chunk if chunk else batch
            ans, fop = run_expr(*(_slice_op(x, lo, hi_) for x in (a, b, c)))
            got = ev.decrypt_answer(main_ks, nbit_ks, ans, fop)
            want = [plain(int(x), int(y), int(z)) for x, y, z in
                    zip(a_vals[lo:hi_], b_vals[lo:hi_], c_vals[lo:hi_])]
            wrong += sum(1 for g, w in zip(got, want) if g != w)
        return wrong, time.perf_counter() - t0

    errors, cold = one_pass()
    gates = cloud.gate_count
    wrong, warm = one_pass()
    errors += wrong
    return {
        "metric": "expressions_per_sec",
        "value": round(batch / warm, 3),
        "unit": "expr/s",
        "expr": disp,
        "batch": batch,
        "width": width,
        "adder": adder,
        "chained": chain,
        "seconds_warm": round(warm, 2),
        "seconds_cold_incl_compile": round(cold, 2),
        "seconds_encrypt": round(t_enc, 2),
        "bootstraps_per_sec": round(gates / warm, 1),
        "gates_per_pass": gates,
        "errors": errors,
        "vs_reference_s_per_expr": round((batch / warm) * ref_s, 1),
        "reference_s_per_expr": ref_s,
        "dp": 1,
        "chunk": chunk or batch,
        "params": p.name,
        **line_fields(device),
    }


def main() -> int:
    device = require_cuda("expr_bench")

    def env(name, default):
        return os.environ.get("EB_" + name, default)

    rec = run(env("EXPR", "add_sub"), PARAMS[env("PARAMS", "ieache_110")],
              int(env("BATCH", 256)), int(env("WIDTH", 16)), device,
              adder=env("ADDER", "ripple"), chain=env("CHAIN", "1") != "0",
              chunk=int(env("CHUNK", 0)))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
