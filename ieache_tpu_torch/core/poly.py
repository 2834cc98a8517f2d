"""Exact negacyclic torus-polynomial arithmetic on torch tensors.

Counterpart of :mod:`ieache_tpu.core.poly`.  Torus coefficients are
int32 with wraparound mod 2^32: torch's int32 ``+``, ``-``, ``*`` and
``<<`` wrap, ``>>`` is arithmetic.  A negacyclic product of a small
digit polynomial d with a torus polynomial g is

    (d * g)[j] = sum_m d[m] * e[N + j - m],   e = concat(-g, g)

computed as int8 x int8 -> int32 matrix products against the four
signed int8 limbs of the Toeplitz matrix ``T[m, j] = e[N + j - m]``,
recombined with wrapping shifts — exact, no rounding anywhere.
"""

from __future__ import annotations

import torch

from ieache_tpu_torch.params import TFHEParams

#: number of signed int8 limbs covering a torus32 coefficient
TORUS_LIMBS = 4


def split_i8_limbs(x: torch.Tensor, nlimbs: int = TORUS_LIMBS) -> torch.Tensor:
    """Split int32 -> ``nlimbs`` signed base-256 limbs (balanced, exact).

    Returns int8 with a new trailing axis of size ``nlimbs``;
    ``sum_v limbs[..., v] * 2^(8 v) == x (mod 2^32)`` and every limb is
    in [-128, 127].
    """
    x = x.to(torch.int32)
    limbs = []
    for _ in range(nlimbs):
        s = ((x + 128) & 0xFF) - 128
        limbs.append(s.to(torch.int8))
        x = (x - s) >> 8
    return torch.stack(limbs, dim=-1)


def negacyclic_extend(g: torch.Tensor) -> torch.Tensor:
    """concat(-g, g) along the last axis: e[s] s.t. T[m,j] = e[N+j-m]."""
    return torch.cat([-g, g], dim=-1)


def toeplitz_index(n: int, device) -> torch.Tensor:
    """(N, N) int64 index ``N + j - m`` into the extended polynomial."""
    ar = torch.arange(n, device=device)
    return n + ar[None, :] - ar[:, None]


def toeplitz_negacyclic(g: torch.Tensor) -> torch.Tensor:
    """(..., N) int -> (..., N, N) T with (d * g)[j] = sum_m d[m] T[m, j]."""
    n = g.shape[-1]
    return negacyclic_extend(g)[..., toeplitz_index(n, g.device)]


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


def _dot_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, M) -> int32 (..., M), exact.

    Goes to ``torch._int_mm``, whose CUDA path wants more than 16 rows
    and K, M multiples of 8: the operands are zero-padded to that
    (exact — zero rows and columns add nothing) and the result sliced.
    The padding is applied on every device, so the CPU tests run the
    same shapes the card gets.
    """
    lead = a.shape[:-1]
    k, m = b.shape
    a2 = a.reshape(-1, k)
    rows = a2.shape[0]
    pad_r, pad_k, pad_m = max(0, 17 - rows), (-k) % 8, (-m) % 8
    if pad_r or pad_k:
        a2 = torch.nn.functional.pad(a2, (0, pad_k, 0, pad_r))
    if pad_k or pad_m:
        b = torch.nn.functional.pad(b, (0, pad_m, 0, pad_k))
    out = torch._int_mm(a2.contiguous(), b.contiguous())
    return out[:rows, :m].reshape(*lead, m)


def _dot_digits_g(d8: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """(B, rows, m) x (rows, kp1, m, j) -> (B, kp1, j), s8 x s8 -> s32."""
    b, rows, m = d8.shape
    kp1, j = gv.shape[1], gv.shape[-1]
    g2 = gv.permute(0, 2, 1, 3).reshape(rows * m, kp1 * j)
    return _dot_i8(d8.reshape(b, rows * m), g2).reshape(b, kp1, j)


def negacyclic_mul_small(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Exact (mod 2^32) negacyclic product, |d| <= 127, g torus32.

    d: (..., N) int — digit polynomial(s), must fit int8.
    g: (N,) int32 — torus polynomial.
    Returns (..., N) int32.
    """
    t_limbs = split_i8_limbs(toeplitz_negacyclic(g))     # (N, N, 4)
    d8 = d.to(torch.int8)
    out = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
    for v in range(TORUS_LIMBS):
        out = out + (_dot_i8(d8, t_limbs[..., v]) << (8 * v))
    return out
