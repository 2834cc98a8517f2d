"""Homomorphic integer arithmetic circuits (batched): the adder slice.

Counterpart of part of :mod:`ieache_tpu.circuits.arith`:

* ``ripple_add`` — 5 bootstrapped gates per bit (axc = x^c,
  bxc = y^c, sum = x^bxc, g = axc&bxc, c = c^g), emitted as 3
  bootstrap rounds per bit over a (2B, 2B, B) batch;
* ``zero_word`` / ``not_word``;
* ``twos_complement`` / ``ripple_sub`` — NOT + add 1, and x + NOT(y)
  with carry-in 1.

All functions take words of shape (B, W, n+1) (see circuits/words.py)
and a DeviceCloudKey.
"""

from __future__ import annotations

import torch

from ieache_tpu_torch.boot import gates
from ieache_tpu_torch.boot.bootstrap import DeviceCloudKey


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
