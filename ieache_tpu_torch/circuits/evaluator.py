"""The Cloud evaluator: multi-precision signed expression operations.

Counterpart of :mod:`ieache_tpu.circuits.evaluator`, the reference
evaluator binary's ``main`` dispatch (``Cloud/cloud.c:650-2720``).  It
keeps that module's observable semantics:

* operands arrive as **magnitude + metadata**: a negativity word and a
  bit-count word encrypted under the *nbit* keyset, value limbs and a
  zero carry word under the *main* keyset (LSB-first bits, LSW-first
  limbs);
* the evaluator **decrypts the metadata** with the nbit secret key it
  holds: width and sign are cleartext to the evaluator by design;
* negativity codes: operand code 2 means negative; the combined code
  written to the answer is {0:0, 1:1, 2:2, 3:4}; chained expressions
  add code 5 (negated two's complement);
* result width ``max(bit1, bit2)``, doubled for multiplication;
  multiplying >=256-bit operands raises :class:`MulWidthError`;
* add/sub lanes pick per lane between the magnitude add X + Y and the
  two's-complement subtract X + NOT(Y) + 1, with the operand swap and
  the ``+1`` riding the adder's per-lane carry-in;
* the answer mirrors the operand layout, so it chains as an operand.

One :class:`Operand` holds B expressions with shared (op, widths); signs
may differ per lane.  Every word is an int32 tensor on one device, and
every circuit runs on that device: under a CUDA device the blind
rotation launches the kernels of the step mode ``IEACHE_PALLAS_STEP``
selects.  The planning (metadata, per-lane sign dataflow, widths, answer
codes, gate accounting) runs on the host with NumPy, as in the JAX
package; its per-lane masks reach the device as tensors built there.
Where the JAX package compiles a whole expression into one ``jax.jit``
program, :func:`_chain_exec` is a plain function: the plan stays a tuple
and nothing is cached.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ieache_tpu_torch.boot import gates
from ieache_tpu_torch.boot.bootstrap import DeviceCloudKey
from ieache_tpu_torch.circuits import arith, words
from ieache_tpu_torch.circuits import fused as fz
from ieache_tpu_torch.lwe import encrypt
from ieache_tpu_torch.lwe.types import SecretKeySet
from ieache_tpu_torch.utils import prng, trace

#: operation codes as written to operator.txt by the Output CLI
#: (+ -> 1, - -> 2, * and / -> 4)
OP_ADD, OP_SUB, OP_MUL = 1, 2, 4

#: operand layout constants: 8 value limb slots of 32 bits
VALUE_SLOTS = 8
META_WIDTH = 32


class MulWidthError(Exception):
    """256-bit multiplication rejection (the reference's exit 126)."""


@dataclasses.dataclass
class Operand:
    """One batched operand in the reference wire layout: four int32
    tensors on one device."""

    neg_word: torch.Tensor    # (B, 32, n_nbit+1) under nbit key
    bit_word: torch.Tensor    # (B, 32, n_nbit+1) under nbit key
    value: torch.Tensor       # (B, W, n+1) under main key (256 from a client)
    carry_word: torch.Tensor  # (B, 32, n+1) encrypted zeros under main key

    @property
    def batch(self) -> int:
        return self.neg_word.shape[0]


def encrypt_operand(main_ks: SecretKeySet, nbit_ks: SecretKeySet, values,
                    width: int, stream, device) -> Operand:
    """Client-side operand encryption on ``device``.

    ``values`` are signed Python ints; the magnitude is encrypted, the
    sign goes to the negativity word (code 2 = negative).  Each word
    comes from :func:`~ieache_tpu_torch.lwe.encrypt.encrypt_bits_device`
    on the stream the JAX package uses for it, so the arrays are the JAX
    package's.
    """
    values = [int(v) for v in values]
    negs = [2 if v < 0 else 0 for v in values]
    mags = [abs(v) for v in values]
    if any(m >= (1 << width) for m in mags):
        raise ValueError(f"magnitude does not fit {width} bits")

    def enc(ks, bits, i):
        return encrypt.encrypt_bits_device(ks, bits, prng.derive(stream, i),
                                           device)

    return Operand(
        enc(nbit_ks, words.values_to_bits(negs, META_WIDTH), 0),
        enc(nbit_ks, words.values_to_bits([width] * len(values),
                                          META_WIDTH), 1),
        enc(main_ks, words.values_to_bits(mags, VALUE_SLOTS * 32), 2),
        enc(main_ks, np.zeros((len(values), 32), np.int32), 3),
    )


def operand_from_jax(neg, bit, value, carry, device) -> Operand:
    """A JAX-package operand's four words (as NumPy arrays,
    ``np.asarray(op.neg_word)`` ...) -> :class:`Operand` on ``device``:
    the same arrays, for state carried across the two packages."""
    return Operand(*(torch.from_numpy(np.array(x, np.int32)).to(device)
                     for x in (neg, bit, value, carry)))


def _decrypt_meta_value(nbit_ks: SecretKeySet, word) -> np.ndarray:
    bits = encrypt.decrypt_bits(nbit_ks, word)
    return np.asarray(words.bits_to_values(bits), np.int64)


def _normalized_neg(neg: np.ndarray) -> np.ndarray:
    """Negativity code -> 0/1 per lane.  Operand codes: 2 from clients;
    1/2/4 when a chained answer is fed back as an operand, plus code 5
    (negated two's complement): all normalize to "is negative".  The
    re-import of sign-ambiguous answers (codes 1/2/5) keeps the
    reference's magnitude heuristic; in-job chains bypass codes."""
    bad = set(neg.tolist()) - {0, 1, 2, 4, 5}
    if bad:
        raise ValueError(f"invalid negativity codes: {bad}")
    return np.isin(neg, (1, 2, 4, 5)).astype(np.int64)


def _sign_plan(op: int, combined: np.ndarray):
    """Per-lane dataflow selection for add/sub: returns (swap, comp);
    swap exchanges the operands, comp runs X + NOT(Y) + 1 instead of the
    magnitude add X + Y."""
    if op == OP_ADD:
        # magnitude add lanes: A+B, (-A)+(-B); swap when only A is
        # negative ((-A)+B = B - A)
        mag = (combined == 0) | (combined == 3)
        swap = combined == 1
    elif op == OP_SUB:
        # magnitude add lanes: A-(-B), (-A)-B; swap when both negative
        # ((-A)-(-B) = B - A)
        mag = (combined == 1) | (combined == 2)
        swap = combined == 3
    else:  # mul: magnitude product, signs live in the answer code
        mag = np.ones_like(combined, bool)
        swap = np.zeros_like(combined, bool)
    return swap, ~mag


def _lane_mask(mask: np.ndarray, device) -> torch.Tensor:
    """A host per-lane mask (B,) as a (B, 1, 1) bool tensor on
    ``device``, to select between two words."""
    return torch.from_numpy(np.asarray(mask, bool)).to(device)[:, None, None]


def _zero_rows(val: torch.Tensor, count: int, n: int) -> torch.Tensor:
    return gates.CONSTANT(torch.zeros((val.shape[0], count),
                                      dtype=torch.int32, device=val.device), n)


def _take_width(val: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Slice a value word to ``width`` bits, zero-extending with trivial
    LWE(0) rows if it stores fewer (a chained answer keeps only
    out_width bits in memory)."""
    have = val.shape[1]
    if have >= width:
        return val[:, :width, :]
    return torch.cat([val, _zero_rows(val, width - have, n)], dim=1)


def _take_width_lane(val: torch.Tensor, width: int, n: int,
                     sext) -> torch.Tensor:
    """Per-lane width extension of a chain intermediate: lanes whose bits
    are a signed two's complement (``sext`` = 1, the planner's impure
    lanes) replicate the top bit, magnitude lanes zero-extend (7+7=14 at
    w=4 widened to 8 must read 14, not 254)."""
    have = val.shape[1]
    if have >= width:
        return val[:, :width, :]
    zeros = _zero_rows(val, width - have, n)
    if sext is None:
        pad = zeros
    else:
        top = val[:, have - 1:have, :].expand(-1, width - have, -1)
        pad = torch.where(sext[:, None, None] == 1, top, zeros)
    return torch.cat([val, pad], dim=1)


def _csa3_fusable(plan) -> bool:
    """True when the plan is the pure-add 3-operand left fold
    ``(o0 ± o1) ± o2`` with equal step widths: the shape the fused
    carry-free 3:2 compression + one parallel-prefix add serves."""
    if len(plan) != 2:
        return False
    (op1, wl1, wr1, ow1, lhs1, rhs1) = plan[0][:6]
    (op2, wl2, wr2, ow2, lhs2, rhs2) = plan[1][:6]
    return (
        op1 in (OP_ADD, OP_SUB) and op2 in (OP_ADD, OP_SUB)
        and lhs1 == ("opnd", 0) and rhs1 == ("opnd", 1)
        and lhs2 == ("step", 0) and rhs2 == ("opnd", 2)
        and ow1 == ow2
    )


def _kogge_count(w: int) -> int:
    """Exact bootstraps per lane of one W-bit parallel-prefix add."""
    return fz._kogge_count_fz(w)


def _chain_exec(dck, vals, comps, sexts, plan, amode, mmode):
    """Execute a planned expression DAG.

    plan: tuple of (op, wl, wr, ow, lhs, rhs, kinds) per step, where
    lhs/rhs reference an input operand ("opnd", i) or an earlier step's
    output ("step", j).  vals are the operand value words; comps the
    per-step per-lane rhs complement masks (bool tensors (B,) on the
    words' device; the lhs is never complemented); sexts the per-step
    per-lane sign-extension masks consulted when a later, wider step
    consumes that step's output.
    """
    n = dck.params.n

    if amode == "kogge" and _csa3_fusable(plan):
        # fused 3-term add: one carry-free 3:2 compression + ONE
        # parallel-prefix add; the dataflow is uniformly
        # a + (b ~ cm1) + (c ~ cm2) + cm1 + cm2, the constant riding as
        # two unit carries
        w = plan[1][3]
        a3 = _take_width(vals[0], w, n)
        b3 = _take_width(vals[1], w, n)
        c3 = _take_width(vals[2], w, n)
        cm1 = comps[0].to(torch.int32)
        cm2 = comps[1].to(torch.int32)
        k_const = cm1 + cm2
        bw_ = torch.where(cm1[:, None, None] == 1, arith.not_word(b3), b3)
        cw_ = torch.where(cm2[:, None, None] == 1, arith.not_word(c3), c3)
        out3, _ = fz.csa3_add(a3, bw_, cw_, (k_const >= 1).to(torch.int32),
                              (k_const >= 2).to(torch.int32), dck)
        return out3

    outs = []

    def val_of(ref):
        kind, i = ref
        return vals[i] if kind == "opnd" else outs[i]

    def ext_of(ref):
        return None if ref[0] == "opnd" else sexts[ref[1]]

    for k, step in enumerate(plan):
        (op, wl, wr, ow, lhs, rhs) = step[:6]
        if op == OP_MUL and mmode == "csa":
            # width-asymmetric multiply: each side at its true width,
            # rounds over the narrower operand (zero-extension)
            x = _take_width(val_of(lhs), wl, n)
            bv = _take_width(val_of(rhs), wr, n)
            if wr > wl:
                x, bv = bv, x
            outs.append(fz.schoolbook_mul_csa(x, bv, dck,
                                              latency=(amode == "kogge")))
            continue
        w = max(wl, wr)
        if op == OP_MUL:
            x = _take_width(val_of(lhs), w, n)
            bv = _take_width(val_of(rhs), w, n)
            cur = fz.schoolbook_mul_fused(x, bv, dck)
        else:
            x = _take_width_lane(val_of(lhs), w, n, ext_of(lhs))
            bv = _take_width_lane(val_of(rhs), w, n, ext_of(rhs))
            y = torch.where(comps[k][:, None, None], arith.not_word(bv), bv)
            ci = gates.CONSTANT(comps[k].to(torch.int32), n)
            if amode == "kogge":
                cur, _ = fz.kogge_stone_add(x, y, dck, ci)
            else:
                cur, _ = fz.ripple_add(x, y, ci, dck, amode)
        outs.append(cur)
    return outs[-1]


def _chained_product_code(n1: np.ndarray, n2: np.ndarray) -> np.ndarray:
    """The negativity code a multiply step hands its in-job consumers,
    per lane, from its operands' signs n1, n2 (0/1): the product's exact
    sign n1 ^ n2, as code 2 (negative) or 0.  The answer table's code 4
    (both operands negative, a positive product) is the final answer's,
    for its decoding alone; the JAX package hands that code on, and a
    later step of the chain reads it as negative."""
    return 2 * (n1 ^ n2)


def _signed_products(steps) -> int:
    """The multiply steps of ``steps`` whose product a later step of the
    same job consumes: each hands it on with the sign taken from its
    operands (:meth:`CloudEvaluator._plan_steps`)."""
    used = {ref[1] for _, lhs, rhs in steps for ref in (lhs, rhs)
            if ref[0] == "step"}
    return sum(op in (3, OP_MUL) and k in used
               for k, (op, _, _) in enumerate(steps))


def _result_width(plan, mmode) -> int:
    """Bits of the value word :func:`_chain_exec` returns for ``plan``:
    the width-asymmetric multiply gives wl + wr bits, which is less than
    the 2·max(wl, wr) its answer's bit-count word states when the widths
    differ."""
    op, wl, wr = plan[-1][:3]
    if op == OP_MUL:
        return wl + wr if mmode == "csa" else 2 * max(wl, wr)
    return max(wl, wr)


class CloudEvaluator:
    """Holds the evaluation keys and runs one (op, A, B) computation, or
    a whole expression."""

    def __init__(self, main_dck: DeviceCloudKey, nbit_ks: SecretKeySet,
                 adder: str = "ripple", fused: bool = True):
        self.dck = main_dck
        self.nbit_ks = nbit_ks
        if adder not in ("ripple", "kogge_stone"):
            raise ValueError(adder)
        self.adder = adder
        #: fused=True runs the circuits of circuits/fused.py, False those
        #: of circuits/arith.py (gate by gate)
        self.fused = fused
        self.gate_count = 0

    # -- helpers -----------------------------------------------------------
    def _add(self, x, y, carry_in):
        b, w = x.shape[0], x.shape[1]
        if self.adder == "kogge_stone":
            if self.fused:
                s, c = fz.kogge_stone_add(x, y, self.dck, carry_in)
            else:
                s, c = arith.kogge_stone_add(x, y, self.dck,
                                             carry_in=carry_in)
            self.gate_count += _kogge_count(w) * b
            return s, c
        per_bit = 5
        if self.fused:
            s, c = fz.ripple_add(x, y, carry_in, self.dck)
            per_bit = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
        else:
            s, c = arith.ripple_add(x, y, carry_in, self.dck)
        self.gate_count += per_bit * w * b
        return s, c

    # -- the dispatch ------------------------------------------------------
    def compute(self, op: int, a: Operand, b: Operand):
        """Returns (answer Operand, info dict).

        Sign handling is **per lane**: the four metadata words are
        decrypted on the host, and each lane's dataflow (magnitude add or
        two's-complement subtract, operands swapped or not) is a
        ``torch.where`` over masks built on the operands' device, so the
        whole batch runs as one adder.
        """
        if op == 3:
            # the reference's orchestrator writes "4" for opcodes 3 and 4
            op = OP_MUL
        nbit = self.nbit_ks
        neg1 = _decrypt_meta_value(nbit, a.neg_word)
        neg2 = _decrypt_meta_value(nbit, b.neg_word)
        bit1 = _decrypt_meta_value(nbit, a.bit_word)
        bit2 = _decrypt_meta_value(nbit, b.bit_word)

        width = int(max(bit1.max(), bit2.max()))

        # combined negativity in {0,1,2,3} (0 = none, 1 = A negative,
        # 2 = B negative, 3 = both)
        combined = _normalized_neg(neg1) + 2 * _normalized_neg(neg2)
        answer_codes = np.array([0, 1, 2, 4])[combined]

        out_width = width
        if op == OP_MUL:
            if width >= 256:
                raise MulWidthError("Cannot multiply 256 bit number!")
            out_width = 2 * width

        batch = a.batch
        n = self.dck.params.n
        device = a.value.device
        wa, wb = int(bit1.max()), int(bit2.max())
        av = _take_width(a.value, width, n)
        bv = _take_width(b.value, width, n)

        if op == OP_MUL:
            # magnitude product; per-lane signs live in the answer code
            if self.fused:
                mode = fz.mul_mode()
                if mode == "csa":
                    # width-asymmetric: each operand at its true width
                    xv = _take_width(a.value, wa, n)
                    yv = _take_width(b.value, wb, n)
                    if wb > wa:
                        xv, yv = yv, xv
                    result = fz.schoolbook_mul_csa(xv, yv, self.dck)
                    self.gate_count += fz._csa_bootstraps_xy(
                        max(wa, wb), min(wa, wb),
                        fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()],
                    ) * batch
                else:
                    result = fz.schoolbook_mul_fused(av, bv, self.dck)
                    pb = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
                    self.gate_count += (
                        fz.MUL_BOOTSTRAPS[mode](width, pb) * batch
                    )
            else:
                result = arith.schoolbook_mul(av, bv, self.dck, out_width)
                # W rounds x (W ANDs + one 2W-bit add at 5 gates/bit)
                self.gate_count += (1 + 2 * 5) * width * width * batch
        elif op in (OP_ADD, OP_SUB):
            swap, comp = _sign_plan(op, combined)
            swap_t = _lane_mask(swap, device)
            x = torch.where(swap_t, bv, av)
            y = torch.where(swap_t, av, bv)
            y = torch.where(_lane_mask(comp, device), arith.not_word(y), y)
            carry_in = gates.CONSTANT(
                torch.from_numpy(comp.astype(np.int32)).to(device), n)
            result, _ = self._add(x, y, carry_in)
        else:
            raise ValueError(f"bad op {op}")

        return self._finish_answer(op, width, out_width, answer_codes,
                                   combined, result, a.carry_word)

    def _finish_answer(self, op, width, out_width, answer_codes,
                       combined, result, carry_word):
        """Answer metadata: fresh nbit encryptions on the result's device.

        The answer's value carries exactly out_width bits; the 8-slot
        padding of the reference's answer file belongs at the wire
        boundary.  The stream is :func:`~ieache_tpu_torch.utils.prng.
        fresh_stream`, entropy-backed unless ``IEACHE_DETERMINISTIC=1``.
        """
        nbit = self.nbit_ks
        batch = result.shape[0]
        with trace.span("evaluator.finish", lanes=batch):
            stream = prng.fresh_stream(
                0xA27, op, width, int(answer_codes.sum()) & 0x7FFFFFFF
            )
            device = result.device
            neg_word = encrypt.encrypt_bits_device(
                nbit, words.values_to_bits(answer_codes.tolist(),
                                           META_WIDTH),
                prng.derive(stream, 0), device)
            bit_word = encrypt.encrypt_bits_device(
                nbit, words.values_to_bits([out_width] * batch, META_WIDTH),
                prng.derive(stream, 1), device)
        answer = Operand(neg_word, bit_word, result, carry_word)
        info = {
            "op": op,
            "width": width,
            "out_width": out_width,
            "neg_codes": sorted(set(answer_codes.tolist())),
            "combined_neg": sorted(set(combined.tolist())),
        }
        return answer, info

    def compute_chain(self, ops: list, operands: list):
        """A left-fold expression ``(((o0 op0 o1) op1 o2) ...)`` (thin
        wrapper over :meth:`compute_steps`)."""
        if len(operands) != len(ops) + 1:
            raise ValueError("chain needs len(ops)+1 operands")
        steps = [(ops[0], ("opnd", 0), ("opnd", 1))]
        for k in range(1, len(ops)):
            steps.append((ops[k], ("step", k - 1), ("opnd", k + 1)))
        return self.compute_steps(steps, operands)

    def _chain_args(self, steps: list, operands: list, count_gates: bool):
        """The plan of ``steps`` and the arguments of :func:`_chain_exec`,
        masks on the operands' device; returns (args, plan outputs)."""
        planned = self._plan_steps(steps, operands, count_gates)
        plan, comps, sexts = planned[:3]
        device = operands[0].value.device
        amode = ("kogge" if self.adder == "kogge_stone"
                 else fz.adder_mode())
        args = (
            self.dck,
            tuple(o.value for o in operands),
            tuple(torch.from_numpy(np.asarray(c, bool)).to(device)
                  for c in comps),
            tuple(torch.from_numpy(np.asarray(s, np.int32)).to(device)
                  for s in sexts),
            tuple(plan), amode, fz.mul_mode(),
        )
        return args, planned

    def compute_steps(self, steps: list, operands: list):
        """A whole expression DAG in one call.

        steps: [(op, lhs, rhs)] where lhs/rhs reference an input operand
        ("opnd", i) or an earlier step ("step", j<k): left folds like
        AB+C- and mul-first trees like ABC*-.  Observably equivalent to
        sequential :meth:`compute` calls minus the per-step metadata
        round trips; the whole per-lane sign dataflow is planned on the
        host up front.
        """
        # the host's planning: metadata decrypted, masks uploaded
        with trace.span("evaluator.plan", lanes=operands[0].batch,
                        steps=len(steps),
                        signed_products=_signed_products(steps)):
            args, planned = self._chain_args(steps, operands, True)
        plan, _, _, answer_codes, combined, step_w = planned
        result = _chain_exec(*args)
        final_op = steps[-1][0]
        return self._finish_answer(
            final_op, max(plan[-1][1], plan[-1][2]), step_w[-1],
            answer_codes, combined, result, operands[0].carry_word,
        )

    def _plan_steps(self, steps: list, operands: list,
                    count_gates: bool = True):
        """Host-side chain planning shared by :meth:`compute_steps` and
        :meth:`chain_memory_analysis`: decrypts the cleartext metadata,
        resolves per-step widths and sign dataflows, and builds the plan
        for :func:`_chain_exec`.  Returns (plan, comps, sexts,
        answer_codes, combined, step_w); comps and sexts are NumPy masks
        (B,) per step."""
        nbit = self.nbit_ks
        negs = [_decrypt_meta_value(nbit, o.neg_word) for o in operands]
        bitws = [
            int(_decrypt_meta_value(nbit, o.bit_word).max())
            for o in operands
        ]
        batch = operands[0].batch
        pb = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
        use_kogge = self.adder == "kogge_stone"

        # Side descriptors: operands and MUL results are ("coded",
        # code_vec), a magnitude plus the reference's negativity code (a
        # MUL result's code 2 or 0: its exact sign);
        # ADD/SUB intermediates are ("twos", negflag_vec, pure_vec), raw
        # two's-complement bits whose lane value is (-1)^negflag *
        # signed(bits), with `pure` marking lanes whose bits are a
        # provable magnitude sum.  Two's-complement intermediates carry
        # no sign claim, so every lane is exact; the per-lane negflag
        # folds into the NEXT step's complement flag and into the final
        # answer code (4/5 = negated magnitude / two's complement).
        step_kind, step_w = [], []

        def side_of(ref):
            if ref[0] == "opnd":
                return ("coded", negs[ref[1]], None)
            return step_kind[ref[1]]

        def w_of(ref):
            return (bitws[ref[1]] if ref[0] == "opnd"
                    else step_w[ref[1]])

        zeros = np.zeros(batch, np.int64)
        plan, comps, sexts = [], [], []
        answer_codes = combined = None
        for op, lhs, rhs in steps:
            if op == 3:  # 3 and 4 both mean multiply (see compute())
                op = OP_MUL
            wl, wr = w_of(lhs), w_of(rhs)
            w = max(wl, wr)
            ow = w
            if op == OP_MUL:
                kl = side_of(lhs)
                kr = side_of(rhs)

                def _mul_code(side):
                    # the multiplier consumes magnitudes; a two's-
                    # complement intermediate is taken at its negflag
                    # sign
                    if side[0] == "coded":
                        return _normalized_neg(side[1])
                    return side[1].astype(np.int64)

                n1 = _mul_code(kl)
                n2 = _mul_code(kr)
                combined = n1 + 2 * n2
                answer_codes = np.array([0, 1, 2, 4])[combined]
                if w >= 256:
                    raise MulWidthError("Cannot multiply 256 bit number!")
                ow = 2 * w
                if count_gates:
                    if (fz.mul_mode() == "csa" and use_kogge
                            and batch * (w + 1) <= 64):
                        # latency mode, wave-bound regime: Wallace
                        self.gate_count += fz._wallace_bootstraps(
                            w, min(wl, wr)) * batch
                    elif fz.mul_mode() == "csa" and use_kogge:
                        # latency mode: windowed scan + prefix final
                        mn = min(wl, wr)
                        self.gate_count += (
                            w * mn + 2 * mn * (w + 1) + _kogge_count(w)
                        ) * batch
                    elif fz.mul_mode() == "csa":
                        self.gate_count += fz._csa_bootstraps_xy(
                            w, min(wl, wr), pb) * batch
                    else:
                        self.gate_count += (
                            fz.MUL_BOOTSTRAPS[fz.mul_mode()](w, pb)
                            * batch
                        )
                comp = zeros.astype(bool)
                sext = zeros          # mul outputs are magnitudes
                kinds = ("coded", "coded")
                step_kind.append(("coded", _chained_product_code(n1, n2),
                                  None))
            elif op in (OP_ADD, OP_SUB):
                kl = side_of(lhs)
                kr = side_of(rhs)
                opneg = 1 if op == OP_SUB else 0
                # lhs term: coded magnitude (el = its sign) or twos bits
                # (never complemented; negflag folds forward)
                if kl[0] == "coded":
                    el = _normalized_neg(kl[1])
                    fl = zeros
                    pl = np.ones(batch, np.int64)
                else:
                    el = zeros
                    fl = kl[1]
                    pl = kl[2]
                # rhs effective sign: code (or rhs negflag), the op and
                # the lhs negflag all fold in (~y + 1 == -y)
                er0 = (_normalized_neg(kr[1]) if kr[0] == "coded"
                       else kr[1])
                pr = (np.ones(batch, np.int64) if kr[0] == "coded"
                      else kr[2])
                er = er0 ^ opneg ^ fl
                # lanes whose lhs term is itself negative: negate the
                # whole lane instead (the lhs stays uncomplemented and
                # the cleartext carry at <= 1)
                negf = (fl ^ el).astype(np.int64)
                er = er ^ el
                comp = er.astype(bool)
                pure = (pl & pr & (1 - er)).astype(np.int64)
                sext = 1 - pure       # impure lanes: bits are signed
                if count_gates:
                    if use_kogge:
                        self.gate_count += _kogge_count(w) * batch
                    else:
                        self.gate_count += pb * w * batch
                step_kind.append(("twos", negf, pure))
                # final answer code per lane (decrypt_answer tables):
                #   f=0 pure   -> plain     (ADD: 0, SUB: 2)
                #   f=0 impure -> signed    (ADD: 1, SUB: 0)
                #   f=1 pure   -> -plain    (ADD: 4, SUB: 1)
                #   f=1 impure -> -signed   (code 5, both)
                if op == OP_ADD:
                    tbl = np.array([0, 1, 4, 5])
                else:
                    tbl = np.array([2, 0, 1, 5])
                sel = 2 * negf + (1 - pure)
                answer_codes = tbl[sel]
                combined = el + 2 * er0  # effective signs (info only)
                kinds = (kl[0], kr[0])
            else:
                raise ValueError(f"bad op {op}")
            plan.append((op, wl, wr, ow, lhs, rhs, kinds))
            comps.append(np.asarray(comp))
            sexts.append(np.asarray(sext))
            step_w.append(ow)
        if count_gates and use_kogge and _csa3_fusable(tuple(plan)):
            # the fused 3-term path replaces the two chained prefix adds
            # with 3w compression bootstraps + ONE prefix add
            w = plan[1][3]
            self.gate_count += (3 * w - _kogge_count(w)) * batch
        return plan, comps, sexts, answer_codes, combined, step_w

    def chain_memory_analysis(self, steps: list, operands: list):
        """The device memory of the whole-chain program, in the keys of
        the JAX package's XLA audit (bytes; ``gate_count`` unchanged).

        Unlike that audit, which compiles and never runs, this one
        EXECUTES the chain once on a CUDA operand, between
        ``torch.cuda.reset_peak_memory_stats`` and
        ``torch.cuda.max_memory_allocated``: ``temp_size_in_bytes`` is
        the peak above what was allocated before, less the output.
        ``argument_size_in_bytes`` (the key, the operands' value words
        and the masks) and ``output_size_in_bytes`` (the result word, its
        size from the plan) are counted from the tensors' sizes on every
        device, ``alias_size_in_bytes`` is 0
        (nothing is donated).  Where no counter exists (CPU operands) the
        chain does not run, and the fields it cannot measure
        (``temp_size_in_bytes``, ``generated_code_size_in_bytes``, and so
        ``peak_bytes_estimate``) are -1.
        """
        args, _ = self._chain_args(steps, operands, False)
        dck, vals, comps, sexts, plan, _, mmode = args
        tensors = (dck.bk, dck.ks_limbs, *vals, *comps, *sexts) + (
            () if dck.bk_limbs is None else (dck.bk_limbs,))
        out = {
            "temp_size_in_bytes": -1,
            "argument_size_in_bytes": sum(t.numel() * t.element_size()
                                          for t in tensors),
            "output_size_in_bytes": (operands[0].batch
                                     * _result_width(plan, mmode)
                                     * (dck.params.n + 1) * 4),
            "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": -1,
        }
        device = vals[0].device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            result = _chain_exec(*args)
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
            del result
            out["temp_size_in_bytes"] = (peak - base
                                         - out["output_size_in_bytes"])
        out["peak_bytes_estimate"] = (
            -1 if out["temp_size_in_bytes"] < 0 else
            out["temp_size_in_bytes"] + out["argument_size_in_bytes"]
            + out["output_size_in_bytes"])
        return out


def decrypt_answer(main_ks: SecretKeySet, nbit_ks: SecretKeySet,
                   answer: Operand, op: int) -> list:
    """Output-side decryption (the reference's verif semantics), each
    lane at its own width.

    Interpretation table per (op, answer negativity code):
      add : 0 -> +mag ; 1,2 -> two's complement ; 4 -> -mag
      sub : 0,4 -> two's complement ; 1 -> -mag ; 2 -> +mag
      mul : 0,4 -> +mag ; 1,2 -> -mag
    Code 5, beyond the reference's vocabulary, is the NEGATED two's
    complement of chained lanes whose whole-lane negation folded into
    the final code.  The value word comes to the host to decrypt.
    """
    if op == 3:  # 3 and 4 both mean multiply (see CloudEvaluator.compute)
        op = OP_MUL
    codes = _decrypt_meta_value(nbit_ks, answer.neg_word)
    widths = _decrypt_meta_value(nbit_ks, answer.bit_word)
    width = int(widths.max())
    vals = words.decrypt_word(main_ks, answer.value[:, :width, :])

    def signed(v, w):
        return v - (1 << w) if v >= (1 << (w - 1)) else v

    def plain(v, w):
        return v

    def neg(v, w):
        return -v

    def neg_signed(v, w):
        return -signed(v, w)

    if op == OP_ADD:
        table = {0: plain, 1: signed, 2: signed, 4: neg, 5: neg_signed}
    elif op == OP_SUB:
        table = {0: signed, 4: signed, 1: neg, 2: plain, 5: neg_signed}
    elif op == OP_MUL:
        table = {0: plain, 4: plain, 1: neg, 2: neg}
    else:
        raise ValueError(f"bad op {op}")
    # sign fix-up applied per lane: a batch may mix negativity codes
    return [
        table[int(code)](v, int(w))
        for v, code, w in zip(vals, codes, widths)
    ]
