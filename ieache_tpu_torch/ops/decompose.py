"""Balanced gadget (digit) decomposition of torus32 values.

Counterpart of :mod:`ieache_tpu.ops.decompose`: add the rounding
offset in wrapping 32-bit arithmetic, then each digit is a shifted
mask minus B/2.  The JAX version adds in uint32 and shifts logically;
here the add is wrapping int32 and the shift arithmetic, which gives
the same bits because the mask keeps only bits below ``32 - shift``.
"""

from __future__ import annotations

import torch

from ieache_tpu_torch.core.poly import negacyclic_rotate_batch
from ieache_tpu_torch.params import TFHEParams


def _offset(base_bit: int, levels: int) -> int:
    # copied from ieache_tpu.ops.decompose._offset, whose module imports
    # jax; tests/test_torch_kernels.py pins the two together
    off = 0
    for j in range(levels):
        off += (1 << (base_bit - 1)) << (32 - (j + 1) * base_bit)
    # round-to-nearest of the dropped low bits: without this half-ulp
    # term the residual has mean -2^(32-levels*bb-1), and inside one
    # blind-rotation step that bias couples coherently with the ~N/2
    # secret-key coefficients (error ~ s(X)*eps_a(X)), costing ~10x the
    # zero-mean residual noise at 16-bit coverage (measured 0.034 vs
    # 0.0035 torus stdev at l=2 — tools/margin_probe.py).
    if levels * base_bit < 32:
        off += 1 << (32 - levels * base_bit - 1)
    return off & 0xFFFFFFFF


def as_int32(u: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return u - (1 << 32) if u >= (1 << 31) else u


def gadget_decompose(x: torch.Tensor, base_bit: int,
                     levels: int) -> torch.Tensor:
    """int32 (...,) -> int32 (..., levels), balanced digits."""
    half = 1 << (base_bit - 1)
    mask = (1 << base_bit) - 1
    v = x.to(torch.int32) + as_int32(_offset(base_bit, levels))
    digits = []
    for j in range(levels):
        shift = 32 - (j + 1) * base_bit
        digits.append(((v >> shift) & mask) - half)
    return torch.stack(digits, dim=-1)


def _step_digits(acc: torch.Tensor, bara_i: torch.Tensor,
                 params: TFHEParams) -> torch.Tensor:
    """Digits of (X^bara·acc - acc): int32 (B, rows, N)."""
    b = acc.shape[0]
    diff = negacyclic_rotate_batch(acc, bara_i) - acc      # (B, k+1, N)
    digits = gadget_decompose(diff, params.bg_bit, params.l)
    # (B, k+1, N, l) -> (B, k+1, l, N): row p = u*l + j matches BK layout
    digits = torch.movedim(digits, -1, 2)
    return digits.reshape(b, params.trgsw_rows, params.N)
