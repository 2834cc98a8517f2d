"""Decrypting the program's answers and holding them to plain integers.

The semantics are the evaluator's documented ones, not its code:

* an operand is a magnitude of ``width`` bits with a sign; an answer is
  a negativity code and a bit count, each a 32-bit word under the
  *nbit* key, and a value word under the *main* key, bits LSB first;
* a bit decrypts to the sign of its phase ``b - a.s`` (mod 2^32);
* a step's result width is ``max(wl, wr)``, doubled for a multiply,
  and the answer's bit count states the last step's;
* the answer's code says how to read its value bits, by the last
  operation (the verifier's table, with code 5 for a negated two's
  complement);
* a width-W answer is defined modulo 2^W: it must equal the plain
  value modulo 2^W, and equal it outright where the plain value lies in
  the signed range of W bits.
"""

from __future__ import annotations

import numpy as np
import torch

OPS = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
       "*": lambda x, y: x * y}


def plain_value(postfix: str, values: dict) -> int:
    """The postfix expression on plain integers (``values``: letter ->
    int)."""
    stack = []
    for ch in postfix:
        if ch in OPS:
            y, x = stack.pop(), stack.pop()
            stack.append(OPS[ch](x, y))
        else:
            stack.append(int(values[ch]))
    if len(stack) != 1:
        raise ValueError(f"malformed postfix {postfix!r}")
    return stack[0]


def result_width(postfix: str, width: int) -> int:
    """The bit count the answer states: the last step's result width."""
    stack = []
    for ch in postfix:
        if ch in OPS:
            wr, wl = stack.pop(), stack.pop()
            stack.append(2 * max(wl, wr) if ch == "*" else max(wl, wr))
        else:
            stack.append(width)
    return stack[0]


def _signed(v, w):
    return v - (1 << w) if v >= 1 << (w - 1) else v


#: how each answer code reads its value bits, by the last operation
READ = {
    "+": {0: lambda v, w: v, 1: _signed, 2: _signed, 4: lambda v, w: -v,
          5: lambda v, w: -_signed(v, w)},
    "-": {0: _signed, 4: _signed, 1: lambda v, w: -v, 2: lambda v, w: v,
          5: lambda v, w: -_signed(v, w)},
    "*": {0: lambda v, w: v, 4: lambda v, w: v, 1: lambda v, w: -v,
          2: lambda v, w: -v},
}


def decrypt_bits(word: torch.Tensor, s: np.ndarray) -> np.ndarray:
    """LWE ciphertexts (..., n+1) int32 -> their bits (...) as a host
    uint8 array: the sign of ``b - a.s`` taken mod 2^32, on the word's
    device."""
    n = s.shape[0]
    key = torch.from_numpy(s.astype(np.int64)).to(word.device)
    flat = word.reshape(-1, n + 1)
    bits = []
    for lo in range(0, flat.shape[0], 1 << 16):
        rows = flat[lo:lo + (1 << 16)].to(torch.int64)
        phase = (rows[:, n] - (rows[:, :n] * key).sum(1)) & 0xFFFFFFFF
        bits.append(((phase > 0) & (phase < 1 << 31)).to(torch.uint8).cpu())
    return torch.cat(bits).numpy().reshape(word.shape[:-1])


def bits_to_ints(bits: np.ndarray) -> list:
    """(B, W) bits, LSB first -> B unsigned Python ints."""
    packed = np.packbits(np.ascontiguousarray(bits, np.uint8), axis=1,
                         bitorder="little")
    return [int.from_bytes(row.tobytes(), "little") for row in packed]


def decode(neg_word, bit_word, value_word, main_s, nbit_s,
           final_op: str) -> list:
    """Each lane's (code, stated width, value read by the table) of one
    answer; a code the table lacks, or a width outside the value word,
    reads as None."""
    codes = bits_to_ints(decrypt_bits(neg_word, nbit_s))
    widths = bits_to_ints(decrypt_bits(bit_word, nbit_s))
    have = value_word.shape[1]
    top = min(max(widths), have)
    raw = bits_to_ints(decrypt_bits(value_word[:, :top], main_s))
    out = []
    for code, w, v in zip(codes, widths, raw):
        read = READ[final_op].get(code)
        ok = read is not None and 0 < w <= have
        out.append((code, w, read(v % (1 << w), w) if ok else None))
    return out


def lane_ok(got, want: int, width: int) -> bool:
    """Whether an answer read as ``got`` is the width-``width`` answer
    of the plain value ``want``."""
    if got is None:
        return False
    if (got - want) % (1 << width):
        return False
    return got == want or not -(1 << (width - 1)) <= want < 1 << (width - 1)


def judge_job(postfix: str, values: dict, width: int, answer, main_s,
              nbit_s, reported=None) -> int:
    """Wrong lanes of one job: ``values`` letter -> the lanes' plain
    operands, ``answer`` the program's (neg, bit, value) words.  A lane
    is wrong where its stated width is not the documented one, or its
    value is not the plain one under :func:`lane_ok`; where
    ``reported`` (the values the program itself decoded) is given, also
    where one of those fails :func:`lane_ok`."""
    final_op = next(ch for ch in reversed(postfix) if ch in OPS)
    w_doc = result_width(postfix, width)
    lanes = len(next(iter(values.values())))
    decoded = decode(*answer, main_s, nbit_s, final_op)
    if len(decoded) != lanes or (reported is not None
                                 and len(reported) != lanes):
        return lanes
    wrong = 0
    for i, (_, w, got) in enumerate(decoded):
        want = plain_value(postfix, {k: v[i] for k, v in values.items()})
        ok = w == w_doc and lane_ok(got, want, w_doc)
        if reported is not None:
            ok = ok and lane_ok(int(reported[i]), want, w_doc)
        wrong += not ok
    return wrong
