"""The control of the check that decides ``correct``.

The configuration states operands of ``width`` bits and exact answers
at the documented result width.  The control breaks that guarantee: the
plain reference, put in the Cloud evaluator's place, decrypts the
operands with the keys, computes the expression on integers of half the
operand width (every operand and every step wrapped to that many bits,
two's complement) and encrypts that answer under the same keys.  The
window and the check then run as in a benchmark run, and the check has
to find wrong lanes.  On the card, at a cell's own size::

    python3 -m fhe_bench.control --workload <name> --seeds 1,2,3 --seconds 0.3

prints one JSON line per seed with the jobs attempted and its
``wrong_lanes``.  The control's jobs are fast (no bootstrap), so a short
window compares about as many jobs as a benchmark run does; every
answer stays on the card until the window closes.  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from fhe_bench import harness
from fhe_bench.reference import answer as reference
from fhe_bench.reference import keys as ref_keys
from ieache_tpu_torch.circuits import evaluator as ev

OP_CHARS = {ev.OP_ADD: "+", ev.OP_SUB: "-", ev.OP_MUL: "*"}
#: the answer codes that read a value as itself and as its negation
PLAIN_NEG = {"+": (0, 4), "-": (2, 1), "*": (0, 1)}
MU = 1 << 29


def encrypt_bits(bits: np.ndarray, s: np.ndarray, gen, device):
    """Noiseless LWE encryptions (..., n+1) int32 of a bit array under
    the binary key ``s``, masks from the generator ``gen``."""
    n = s.shape[0]
    flat = torch.from_numpy(bits.reshape(-1).astype(np.int64)).to(device)
    a = torch.randint(-2**31, 2**31, (flat.shape[0], n), generator=gen,
                      dtype=torch.int64, device=device)
    key = torch.from_numpy(s.astype(np.int64)).to(device)
    b = (a * key).sum(1) + torch.where(flat != 0, MU, -MU)
    b = ((b + 2**31) % 2**32) - 2**31
    out = torch.cat([a, b[:, None]], 1).to(torch.int32)
    return out.reshape(bits.shape + (n + 1,))


def int_bits(values, width: int) -> np.ndarray:
    """(B,) non-negative ints -> (B, width) bits, LSB first."""
    return np.array([[(v >> i) & 1 for i in range(width)] for v in values],
                    np.uint8)


class HalfWidthEvaluator:
    """The reference in the evaluator's place, on half-width integers."""

    def __init__(self, real, main_s, nbit_s, width: int, seed: int):
        self.dck, self.nbit_ks = real.dck, real.nbit_ks
        self.gate_count = 0
        self.main_s, self.nbit_s, self.half = main_s, nbit_s, width // 2
        self.seed = seed

    def _wrap(self, v: int) -> int:
        m = 1 << self.half
        return (v + m // 2) % m - m // 2

    def _operand(self, o):
        codes = reference.bits_to_ints(
            reference.decrypt_bits(o.neg_word, self.nbit_s))
        widths = reference.bits_to_ints(
            reference.decrypt_bits(o.bit_word, self.nbit_s))
        mags = reference.bits_to_ints(
            reference.decrypt_bits(o.value[:, :max(widths)], self.main_s))
        return [self._wrap(-m if c == 2 else m) for m, c in zip(mags, codes)]

    def compute_chain(self, ops, operands):
        steps = [(ops[0], ("opnd", 0), ("opnd", 1))] + [
            (op, ("step", k), ("opnd", k + 2)) for k, op in enumerate(ops[1:])]
        return self.compute_steps(steps, operands)

    def compute_steps(self, steps, operands):
        device = operands[0].value.device
        width = 2 * self.half
        vals = [self._operand(o) for o in operands]
        wids = [width] * len(operands)
        outs, out_w = [], []
        for op, lhs, rhs in steps:
            ch = OP_CHARS[ev.OP_MUL if op == 3 else op]
            xs = vals[lhs[1]] if lhs[0] == "opnd" else outs[lhs[1]]
            ys = vals[rhs[1]] if rhs[0] == "opnd" else outs[rhs[1]]
            wl = wids[lhs[1]] if lhs[0] == "opnd" else out_w[lhs[1]]
            wr = wids[rhs[1]] if rhs[0] == "opnd" else out_w[rhs[1]]
            outs.append([self._wrap(reference.OPS[ch](x, y))
                         for x, y in zip(xs, ys)])
            out_w.append(2 * max(wl, wr) if ch == "*" else max(wl, wr))
        plain, neg = PLAIN_NEG[ch]
        d, w = outs[-1], out_w[-1]
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed & 0xFFFFFFFF)
        codes = [neg if v < 0 else plain for v in d]
        answer = ev.Operand(
            encrypt_bits(int_bits(codes, 32), self.nbit_s, gen, device),
            encrypt_bits(int_bits([w] * len(d), 32), self.nbit_s, gen,
                         device),
            encrypt_bits(int_bits([abs(v) for v in d], w), self.main_s, gen,
                         device),
            operands[0].carry_word)
        return answer, {}


def tamper_for(seed: int, n: int, width: int):
    """The tamper that puts the control in the cell's evaluator's
    place."""
    main_s, nbit_s = (ref_keys.lwe_secret(ref_keys.seed_words(seed, k), n)
                      for k in ("main", "nbit"))

    def tamper(cell):
        cell.evaluator = HalfWidthEvaluator(cell.evaluator, main_s, nbit_s,
                                            width, seed)
    return tamper


def run(bench, name: str, seed: int, seconds: float, device) -> dict:
    """One control run of cell ``name``; its result line."""
    spec = bench.workload(name)
    cfg = bench.config(spec["config"])
    return harness.run(bench, name, seed, seconds, False, device,
                       time.perf_counter(),
                       tamper_for(seed, cfg["params"]["n"],
                                  cfg["operand_width"]))[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fhe_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fhe_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench(harness.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run(bench, args.workload, seed, args.seconds,
                   torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          **{k: c["value"] for k, c in
                             line["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
