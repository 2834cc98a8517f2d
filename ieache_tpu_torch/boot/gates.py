"""Batched homomorphic gate API.

Counterpart of :mod:`ieache_tpu.boot.gates`: every two-input gate is
``bootstrap(alpha1*c1 + alpha2*c2 + (0, beta))``, and
:func:`apply_gate_batch` evaluates a mixed batch (per-element opcode)
at the cost of one bootstrap.
"""

from __future__ import annotations

import torch

from ieache_tpu_torch.boot.bootstrap import (
    MU,
    DeviceCloudKey,
    bootstrap,
    bootstrap_no_ks,
)
from ieache_tpu_torch.ops.keyswitch import keyswitch

#: gate -> (alpha1, alpha2, beta): bootstrap(a1*c1 + a2*c2 + (0, beta));
#: a test pins this table and the opcodes to the JAX package's
GATE_TABLE = {
    "AND":   (1, 1, -MU),
    "OR":    (1, 1, MU),
    "NAND":  (-1, -1, MU),
    "NOR":   (-1, -1, -MU),
    "XOR":   (2, 2, 2 * MU),
    "XNOR":  (-2, -2, -2 * MU),
    "ANDNY": (-1, 1, -MU),   # (not c1) and c2
    "ANDYN": (1, -1, -MU),   # c1 and (not c2)
    "ORNY":  (-1, 1, MU),    # (not c1) or c2
    "ORYN":  (1, -1, MU),    # c1 or (not c2)
}

#: stable opcode numbering for mixed batches
GATE_OPCODES = {name: i for i, name in enumerate(GATE_TABLE)}


def _gate(name: str, c1: torch.Tensor, c2: torch.Tensor,
          key: DeviceCloudKey) -> torch.Tensor:
    a1, a2, beta = GATE_TABLE[name]
    pre = a1 * c1 + a2 * c2
    pre[:, key.params.n] += beta
    return bootstrap(pre, key)


def AND(c1, c2, key):   return _gate("AND", c1, c2, key)    # noqa: E704
def OR(c1, c2, key):    return _gate("OR", c1, c2, key)     # noqa: E704
def NAND(c1, c2, key):  return _gate("NAND", c1, c2, key)   # noqa: E704
def NOR(c1, c2, key):   return _gate("NOR", c1, c2, key)    # noqa: E704
def XOR(c1, c2, key):   return _gate("XOR", c1, c2, key)    # noqa: E704
def XNOR(c1, c2, key):  return _gate("XNOR", c1, c2, key)   # noqa: E704
def ANDNY(c1, c2, key): return _gate("ANDNY", c1, c2, key)  # noqa: E704
def ANDYN(c1, c2, key): return _gate("ANDYN", c1, c2, key)  # noqa: E704
def ORNY(c1, c2, key):  return _gate("ORNY", c1, c2, key)   # noqa: E704
def ORYN(c1, c2, key):  return _gate("ORYN", c1, c2, key)   # noqa: E704


def NOT(c: torch.Tensor) -> torch.Tensor:
    """bootsNOT: negation, no bootstrap."""
    return -c


def COPY(c: torch.Tensor) -> torch.Tensor:
    """bootsCOPY: identity."""
    return c


def CONSTANT(bits: torch.Tensor, n: int) -> torch.Tensor:
    """bootsCONSTANT: trivial LWE(±1/8) batch on ``bits``' device."""
    out = torch.zeros(bits.shape + (n + 1,), dtype=torch.int32,
                      device=bits.device)
    out[..., n] = torch.where(bits != 0, MU, -MU).to(torch.int32)
    return out


def MUX(sel, c1, c2, key: DeviceCloudKey) -> torch.Tensor:
    """bootsMUX: sel ? c1 : c2 — two bootstraps + one keyswitch."""
    p = key.params
    n = p.n
    t1 = sel + c1
    t1[:, n] -= MU
    u1 = bootstrap_no_ks(t1, key)           # sel AND c1 (extracted dim)
    t2 = -sel + c2
    t2[:, n] -= MU
    u2 = bootstrap_no_ks(t2, key)           # (not sel) AND c2
    u = u1 + u2
    u[:, p.kN] += MU
    return keyswitch(u, key.ks_limbs, p)


def _coefficients(device) -> torch.Tensor:
    """(3, gates) int32: alpha1, alpha2, beta rows in opcode order."""
    return torch.tensor(list(zip(*GATE_TABLE.values())), dtype=torch.int32,
                        device=device)


def apply_gate_batch(opcodes: torch.Tensor, c1: torch.Tensor,
                     c2: torch.Tensor, key: DeviceCloudKey) -> torch.Tensor:
    """Mixed-gate batch: per-element opcode (see GATE_OPCODES).

    One bootstrap for the whole batch regardless of the gate mix.
    """
    a1, a2, beta = _coefficients(c1.device)[:, opcodes.to(torch.int64)]
    pre = a1[:, None] * c1 + a2[:, None] * c2
    pre[:, key.params.n] += beta
    return bootstrap(pre, key)
