"""LWE-to-LWE keyswitch: one CUDA kernel on the card, int8 matrix
products on the CPU.

Counterpart of :mod:`ieache_tpu.ops.keyswitch` (the *linear*
keyswitch: ``out = (0, ..., b) - Digits(a) @ KS``).  The JAX package
leaves this product to XLA, outside any Pallas kernel.  On CUDA tensors
:func:`keyswitch` launches ``csrc/keyswitch.cu``, which makes the digits,
sums the four int8 limbs of KS and finishes in one launch (its launch
from ``kernels.keyswitch_launch``, its plain model
``kernels.keyswitch_kernel_model``); on CPU tensors it runs
:func:`keyswitch_plain`: the digits, one ``torch._int_mm`` product per
int8 torus limb of KS, recombined with wrapping shifts, exact mod 2^32.
The pieces stay for ``dist/shard.py``'s tensor-parallel K-slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ieache_tpu_torch.core.poly import TORUS_LIMBS, _dot_i8, split_i8_limbs
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.ops.decompose import gadget_decompose
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import trace


def pad_ks_limbs(limbs: torch.Tensor, device) -> torch.Tensor:
    """(TORUS_LIMBS, K, n+1) int8 -> (TORUS_LIMBS, K, M) on ``device``,
    M = n+1 rounded up to a multiple of 8 with zero columns: the shape
    rule of the keyswitch kernel and of the CUDA int8 matmul, met once
    here instead of by a copy per keyswitch."""
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


def keyswitch_plain(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """The kernel's plain twin, on any device: :func:`keyswitch_digits`,
    :func:`keyswitch_products` (``torch._int_mm`` on the card) and
    :func:`keyswitch_finish`.  Same arguments and result as
    :func:`keyswitch`."""
    d8, body = keyswitch_digits(lwe_ext, params)
    return keyswitch_finish(keyswitch_products(d8, ks_limbs), body, params)


def keyswitch(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """(B, kN+1) int32 -> (B, n+1) int32 under the small LWE key.

    ``ks_limbs`` is (TORUS_LIMBS, kN*t, M) int8 with M >= n+1; columns
    past n+1 are padding and are dropped.  Both are contiguous, on one
    device.  On CUDA tensors one launch of ``csrc/keyswitch.cu`` (after
    a zeroing of the output) as ``kernels.keyswitch_launch`` says,
    counted on ``keyswitch.launches``, or ``ValueError`` where the
    kernel refuses the shape (``kernels.keyswitch_refusal``); on CPU
    tensors :func:`keyswitch_plain`.  The ``keyswitch`` span's ``form``
    names the launch, or ``plain``.
    """
    p = params
    b = lwe_ext.shape[0] if lwe_ext.dim() == 2 else -1
    m = ks_limbs.shape[-1] if ks_limbs.dim() == 3 else -1
    kernels._check(lwe_ext, "lwe_ext", torch.int32, (b, p.kN + 1),
                   lwe_ext.device)
    # a unit's bulk copy reads 16-byte pieces of the key
    kernels._check(ks_limbs, "ks_limbs", torch.int8,
                   (TORUS_LIMBS, p.kN * p.ks_t, max(m, p.n + 1)),
                   lwe_ext.device, align=16)
    if not lwe_ext.is_cuda:
        with trace.span("keyswitch", lanes=b, form="plain"):
            return keyswitch_plain(lwe_ext, ks_limbs, p)

    kernels._refuse(kernels.keyswitch_refusal(p, m))
    launch = kernels.keyswitch_launch(b, p,
                                      kernels._sm_count(lwe_ext.device))
    with trace.span("keyswitch", lanes=b, form=launch.form):
        out = kernels._keyswitch_entry(lwe_ext, ks_limbs, p, launch)
    keyswitch.launches += 1
    return out


keyswitch.launches = 0
