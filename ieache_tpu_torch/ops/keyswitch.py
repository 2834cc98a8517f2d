"""LWE-to-LWE keyswitch as int8 matrix products.

Counterpart of :mod:`ieache_tpu.ops.keyswitch` (the *linear*
keyswitch: ``out = (0, ..., b) - Digits(a) @ KS``), computed per int8
torus limb of KS with ``torch._int_mm`` and recombined with wrapping
shifts, exact mod 2^32.  The JAX package leaves this product to XLA,
outside any Pallas kernel, so it stays a plain PyTorch op here.
"""

from __future__ import annotations

import numpy as np
import torch

from ieache_tpu_torch.core.poly import TORUS_LIMBS, _dot_i8, split_i8_limbs
from ieache_tpu_torch.ops.decompose import gadget_decompose
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import trace


def pad_ks_limbs(limbs: torch.Tensor, device) -> torch.Tensor:
    """(TORUS_LIMBS, K, n+1) int8 -> (TORUS_LIMBS, K, M) on ``device``,
    M = n+1 rounded up to a multiple of 8 with zero columns: the CUDA
    int8 matmul's shape rule, met once here instead of by a copy per
    keyswitch."""
    pad = (-limbs.shape[-1]) % 8
    return torch.nn.functional.pad(limbs, (0, pad)).contiguous().to(device)


def pack_ks_limbs(ks: np.ndarray, device) -> torch.Tensor:
    """Host KS matrix (K, n+1) int32 -> padded (TORUS_LIMBS, K, M) int8
    limbs on ``device`` (see :func:`pad_ks_limbs`)."""
    limbs = split_i8_limbs(torch.tensor(np.asarray(ks, np.int32)))
    return pad_ks_limbs(torch.movedim(limbs, -1, 0), device)


def keyswitch_digits(lwe_ext: torch.Tensor, params: TFHEParams):
    """The keyswitch's int8 digits of the mask, (B, kN*t), and the body
    (B,) of ``lwe_ext`` (B, kN+1)."""
    kn, t = params.kN, params.ks_t
    digits = gadget_decompose(lwe_ext[:, :kn], params.ks_basebit, t)
    return (digits.reshape(lwe_ext.shape[0], kn * t).to(torch.int8),
            lwe_ext[:, kn])


def keyswitch_products(d8: torch.Tensor, ks_limbs: torch.Tensor) -> torch.Tensor:
    """Digits (B, K) against the limbs (TORUS_LIMBS, K, M) of K rows of
    the KS matrix: (B, M) int32, recombined with wrapping shifts."""
    acc = torch.zeros((d8.shape[0], ks_limbs.shape[-1]), dtype=torch.int32,
                      device=d8.device)
    for v in range(TORUS_LIMBS):
        acc = acc + (_dot_i8(d8, ks_limbs[v]) << (8 * v))
    return acc


def keyswitch_finish(acc: torch.Tensor, body: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """(0, ..., body) - acc, trimmed to the n+1 columns of the small key."""
    n = params.n
    out = -acc[:, : n + 1]
    out[:, n] += body
    return out


def keyswitch(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """(B, kN+1) int32 -> (B, n+1) int32 under the small LWE key.

    ``ks_limbs`` is (TORUS_LIMBS, kN*t, M) int8 with M >= n+1; columns
    past n+1 are padding and are dropped.
    """
    with trace.span("keyswitch", lanes=lwe_ext.shape[0]):
        d8, body = keyswitch_digits(lwe_ext, params)
        return keyswitch_finish(keyswitch_products(d8, ks_limbs), body,
                                params)
