"""Homomorphic integer arithmetic circuits (batched).

Counterpart of :mod:`ieache_tpu.circuits.arith`:

* ``ripple_add`` — 5 bootstrapped gates per bit (axc = x^c,
  bxc = y^c, sum = x^bxc, g = axc&bxc, c = c^g), emitted as 3
  bootstrap rounds per bit over a (2B, 2B, B) batch;
* ``zero_word`` / ``not_word``;
* ``twos_complement`` / ``ripple_sub`` — NOT + add 1, and x + NOT(y)
  with carry-in 1;
* ``schoolbook_mul`` — W rounds of (W batched AND partial products +
  one 2W-bit accumulate add), the reference's mul32/64/128 pattern;
* ``kogge_stone_add`` — a parallel-prefix adder with O(log W)
  bootstrap rounds instead of O(W), for latency-bound runs.

All functions take words of shape (B, W, n+1) (see circuits/words.py)
and a DeviceCloudKey.
"""

from __future__ import annotations

import torch

from ieache_tpu_torch.boot import gates
from ieache_tpu_torch.boot.bootstrap import DeviceCloudKey


def _flat(word):
    b, w, m = word.shape
    return word.reshape(b * w, m)


def _unflat(flat, b, w):
    return flat.reshape(b, w, flat.shape[-1])


def zero_word(batch: int, width: int, n: int, device) -> torch.Tensor:
    """Trivial LWE(0) fill."""
    return gates.CONSTANT(
        torch.zeros((batch, width), dtype=torch.int32, device=device), n
    )


def not_word(x: torch.Tensor) -> torch.Tensor:
    """Bitwise negation, no bootstrap."""
    return gates.NOT(x)


def ripple_add(x, y, carry_in, key: DeviceCloudKey):
    """(sum, carry_out) of two W-bit words + 1-bit carry-in.

    carry_in: (B, n+1) LWE bit.  Returns ((B, W, n+1), (B, n+1)).
    """
    b, w, _ = x.shape
    ops_mixed = torch.cat([
        torch.full((b,), gates.GATE_OPCODES["XOR"], dtype=torch.int32,
                   device=x.device),
        torch.full((b,), gates.GATE_OPCODES["AND"], dtype=torch.int32,
                   device=x.device),
    ])

    carry = carry_in
    sums = []
    for i in range(w):
        xi = x[:, i]
        yi = y[:, i]
        # round 1: axc = x^c, bxc = y^c  (one 2B-batch bootstrap)
        both = gates.XOR(torch.cat([xi, yi], 0),
                         torch.cat([carry, carry], 0), key)
        axc, bxc = both[:b], both[b:]
        # round 2: sum = x^bxc, g = axc&bxc  (one mixed 2B-batch bootstrap)
        mixed = gates.apply_gate_batch(
            ops_mixed, torch.cat([xi, axc], 0), torch.cat([bxc, bxc], 0),
            key,
        )
        sum_i, g = mixed[:b], mixed[b:]
        # round 3: c = c^g
        carry = gates.XOR(carry, g, key)
        sums.append(sum_i)
    return torch.stack(sums, dim=1), carry


def twos_complement(x, key: DeviceCloudKey):
    """-x over W bits: NOT(x) + 1."""
    b, w, _ = x.shape
    n = key.params.n
    one_bits = torch.zeros((b, w), dtype=torch.int32, device=x.device)
    one_bits[:, 0] = 1
    one = gates.CONSTANT(one_bits, n)
    zero_c = gates.CONSTANT(
        torch.zeros((b,), dtype=torch.int32, device=x.device), n
    )
    s, _ = ripple_add(not_word(x), one, zero_c, key)
    return s


def ripple_sub(x, y, key: DeviceCloudKey):
    """x - y over W bits (two's complement): x + NOT(y) + carry_in=1."""
    b = x.shape[0]
    one_c = gates.CONSTANT(
        torch.ones((b,), dtype=torch.int32, device=x.device), key.params.n
    )
    return ripple_add(x, not_word(y), one_c, key)


def shift_word_left(x, amount: int, total_width: int, n: int):
    """Zero-extend x into `total_width` bits shifted up by `amount`
    (free — no bootstraps, trivial zeros elsewhere)."""
    b, w, _ = x.shape
    keep = min(w, total_width - amount)
    hi_len = total_width - amount - keep
    parts = [zero_word(b, amount, n, x.device), x[:, :keep]]
    if hi_len > 0:
        parts.append(zero_word(b, hi_len, n, x.device))
    return torch.cat(parts, dim=1)


def schoolbook_mul(x, y, key: DeviceCloudKey, out_width: int | None = None):
    """W x W -> out_width (default 2W) bit product, unsigned.

    Round i: batched AND partial products x_k & y_i (one B*W-batch
    bootstrap), shift-copy, one out_width-bit accumulate add.
    """
    b, w, _ = x.shape
    n = key.params.n
    ow = out_width or 2 * w
    acc = zero_word(b, ow, n, x.device)
    zero_c = gates.CONSTANT(
        torch.zeros((b,), dtype=torch.int32, device=x.device), n)
    xf = _flat(x)  # (B*W, n+1)
    for i in range(w):
        yi_rep = y[:, i][:, None, :].expand(b, w, -1)
        partial = _unflat(gates.AND(xf, _flat(yi_rep), key), b, w)
        shifted = shift_word_left(partial, i, ow, n)  # (B, OW)
        acc, _ = ripple_add(acc, shifted, zero_c, key)
    return acc


def kogge_stone_add(x, y, key: DeviceCloudKey, carry_in=None):
    """W-bit add in O(log W) bootstrap rounds.

    p = x^y, g = x&y; then log2(W) combine levels
    (g' = g | (p & g_shift), p' = p & p_shift); sum = p ^ carries.
    ~2 + 2*ceil(log2 W) rounds vs 3W for ripple.
    """
    b, w, _ = x.shape
    n = key.params.n
    dev = x.device

    def ops(name, count):
        return torch.full((count,), gates.GATE_OPCODES[name],
                          dtype=torch.int32, device=dev)

    # round 1: p = x^y and g = x&y in one 2BW-batch bootstrap
    xy = torch.cat([_flat(x), _flat(x)], 0)
    yy = torch.cat([_flat(y), _flat(y)], 0)
    pg = gates.apply_gate_batch(
        torch.cat([ops("XOR", b * w), ops("AND", b * w)]), xy, yy, key)
    p0 = _unflat(pg[: b * w], b, w)            # propagate (kept for sum)
    g = _unflat(pg[b * w:], b, w)              # generate

    # carry-in rides as a virtual bit position -1: p=0, g=cin
    if carry_in is None:
        cin = gates.CONSTANT(
            torch.zeros((b,), dtype=torch.int32, device=dev), n)
    else:
        cin = carry_in
    g = torch.cat([cin[:, None, :], g], dim=1)                 # (B, W+1)
    p = torch.cat([zero_word(b, 1, n, dev), p0], dim=1)

    # combine levels: g' = g | (p & g_shift), p' = p & p_shift.  The two
    # ANDs (t = p & g_shift, p' = p & p_shift) are mutually independent,
    # so they run as ONE bootstrap wave; only the OR depends on t: 2
    # serial waves per level instead of 3
    we = w + 1
    dist = 1
    while dist < we:
        span = we - dist
        p_shift = _flat(p[:, dist:, :])
        both = gates.apply_gate_batch(
            ops("AND", 2 * b * span),
            torch.cat([p_shift, p_shift], 0),
            torch.cat([_flat(g[:, :span, :]), _flat(p[:, :span, :])], 0),
            key,
        )
        t, p_hi = both[: b * span], both[b * span:]
        g_hi = gates.OR(_flat(g[:, dist:, :]), t, key)
        g = torch.cat([g[:, :dist, :], _unflat(g_hi, b, span)], 1)
        p = torch.cat([p[:, :dist, :], _unflat(p_hi, b, span)], 1)
        dist *= 2

    # carry into real bit i = inclusive prefix generate g[i] (covers
    # virtual..i-1); sum_i = p0_i ^ carry_i; carry_out = g[W]
    carries = g[:, :w, :]
    s = gates.XOR(_flat(p0), _flat(carries), key)
    return _unflat(s, b, w), g[:, w]
