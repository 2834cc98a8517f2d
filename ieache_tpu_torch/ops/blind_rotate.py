"""Blind rotation — the hot core of TFHE gate bootstrapping.

Counterpart of :mod:`ieache_tpu.ops.blind_rotate`.  One CMux step per
LWE mask coefficient:

    acc <- acc + BK_i ⊡ (X^bara_i · acc - acc)

:func:`blind_rotate` runs the n steps as a Python loop.  With the
single-limb gadget (``digit_limbs == 1``) each step is two calls in
the (k+1, B, N) layout — :func:`~ieache_tpu_torch.ops.kernels.rot_diff_decompose`
then :func:`~ieache_tpu_torch.ops.kernels.external_product` with the
accumulator fused — which launch the CUDA kernels for CUDA tensors and
run their plain twins for CPU tensors.  ``plain=True`` runs instead
:func:`external_product_step`, the plain form of the JAX package's XLA
branch (Toeplitz operand + four int8 limb products), on any device:
the reference the kernel path is compared with.
"""

from __future__ import annotations

import torch

from ieache_tpu.params import TFHEParams
from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    _dot_i8,
    negacyclic_extend,
    split_i8_limbs,
    toeplitz_index,
)
from ieache_tpu_torch.ops.decompose import gadget_decompose


def make_step_gmatrix(bk_step: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """TRGSW step -> negacyclic matmul operand (Toeplitz tensor).

    bk_step: int32 (rows, k+1, N) -> int8 (TORUS_LIMBS, rows, k+1, N, N)
    with G[v, p, o, m, j] = limb_v( e_{p,o}[N + j - m] ), e = concat(-g, g).
    """
    e = negacyclic_extend(bk_step)                     # (rows, k+1, 2N)
    el = torch.movedim(split_i8_limbs(e), -1, 0)       # (L, rows, k+1, 2N)
    return el[..., toeplitz_index(params.N, bk_step.device)]


def negacyclic_rotate_batch(acc: torch.Tensor,
                            amount: torch.Tensor) -> torch.Tensor:
    """X^amount · acc for per-batch amounts in [0, 2N).

    acc: (B, k+1, N) int32; amount: (B,) int32 -> (B, k+1, N).
    Coefficient j of X^a·c is c_i with i = (j - a) mod 2N when i < N,
    else -c_{i-N}: one gather from concat(c, -c).
    """
    b, kp1, n = acc.shape
    ext = torch.cat([acc, -acc], dim=-1)               # (B, k+1, 2N)
    j = torch.arange(n, device=acc.device)
    idx = (j[None, :] - amount.to(torch.int64)[:, None]) % (2 * n)
    return torch.gather(ext, 2, idx[:, None, :].expand(b, kp1, n))


def _step_digits(acc: torch.Tensor, bara_i: torch.Tensor,
                 params: TFHEParams) -> torch.Tensor:
    """Digits of (X^bara·acc - acc): int32 (B, rows, N)."""
    b = acc.shape[0]
    diff = negacyclic_rotate_batch(acc, bara_i) - acc      # (B, k+1, N)
    digits = gadget_decompose(diff, params.bg_bit, params.l)
    # (B, k+1, N, l) -> (B, k+1, l, N): row p = u*l + j matches BK layout
    digits = torch.movedim(digits, -1, 2)
    return digits.reshape(b, params.trgsw_rows, params.N)


def _dot_digits_g(d8: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """(B, rows, m) x (rows, kp1, m, j) -> (B, kp1, j), s8 x s8 -> s32."""
    b, rows, n = d8.shape
    kp1 = gv.shape[1]
    g2 = gv.permute(0, 2, 1, 3).reshape(rows * n, kp1 * n)
    return _dot_i8(d8.reshape(b, rows * n), g2).reshape(b, kp1, n)


def external_product_step(
    acc: torch.Tensor, bara_i: torch.Tensor, bk_i: torch.Tensor,
    params: TFHEParams,
) -> torch.Tensor:
    """One CMux: acc + BK_i ⊡ (X^bara_i · acc - acc).  Exact mod 2^32."""
    d = _step_digits(acc, bara_i, params)                  # (B, rows, N)
    g = make_step_gmatrix(bk_i, params)                    # (L, rows, kp1, N, N)

    out = torch.zeros_like(acc)
    if params.digit_limbs == 1:
        d8 = d.to(torch.int8)
        for v in range(TORUS_LIMBS):
            out = out + (_dot_digits_g(d8, g[v]) << (8 * v))
    else:
        dl = split_i8_limbs(d, params.digit_limbs)         # (B, rows, N, 2)
        for u in range(params.digit_limbs):
            for v in range(TORUS_LIMBS):
                sh = 8 * u + 8 * v
                if sh >= 32:
                    continue
                out = out + (_dot_digits_g(dl[..., u], g[v]) << sh)
    return acc + out


def blind_rotate(
    acc0: torch.Tensor, bara: torch.Tensor, bk: torch.Tensor,
    params: TFHEParams, plain: bool = False,
) -> torch.Tensor:
    """Full blind rotation over all n LWE coefficients.

    acc0: (B, k+1, N) int32 — rotated test-vector accumulator.
    bara: (B, n) int32 in [0, 2N) — mod-switched mask coefficients.
    bk:   (n, rows, k+1, N) int32 — bootstrapping key.

    The two-limb compat gadget has no kernel: on the CPU it takes
    :func:`external_product_step`, on a CUDA tensor the kernel wrappers
    refuse it (``ValueError``) unless ``plain`` is set.
    """
    if plain or (params.digit_limbs != 1 and not acc0.is_cuda):
        acc = acc0
        for i in range(bk.shape[0]):
            acc = external_product_step(acc, bara[:, i], bk[i], params)
        return acc

    # kernels.py builds its plain twins from this module's functions
    from ieache_tpu_torch.ops import kernels

    acc_t = acc0.transpose(0, 1).contiguous()              # (k+1, B, N)
    bara_t = bara.t().contiguous()                         # (n, B)
    for i in range(bk.shape[0]):
        d_t = kernels.rot_diff_decompose(acc_t, bara_t[i], params)
        acc_t = kernels.external_product(d_t, bk[i], params, acc=acc_t)
    return acc_t.transpose(0, 1).contiguous()
