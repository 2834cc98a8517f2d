"""A plain CMux step and blind rotation at any gadget, in int64.

Written from TFHE's definitions, not from the program: a torus element
is a residue mod 2^32 (held here as an int64 in [0, 2^32)); a TRLWE
sample is k+1 polynomials of the ring Z_{2^32}[X] / (X^N + 1); a TRGSW
sample of the bootstrapping key is (k+1)·l such rows, row u·l + j
gadget level j of component u.  One CMux step of the blind rotation is

    acc <- acc + BK_i ⊡ (X^a · acc - acc),

where ⊡ decomposes each of the k+1 polynomials of its TRLWE argument
into l signed digits a coefficient and sums the negacyclic products of
each digit polynomial with its row of the key, all mod 2^32.

The decomposition is tfhe-lib's signed one (``tGswTorus32PolynomialDecompH``):
add the offset sum_j (Bg/2)·2^(32-(j+1)·Bgbit), then digit j is bits
[32-(j+1)·Bgbit, 32-j·Bgbit) of the sum less Bg/2, a whole digit in
[-Bg/2, Bg/2).  The offset also holds the half of the dropped low bits
(2^(31-l·Bgbit) where l·Bgbit < 32), so the digits round the value to
the nearest multiple of 2^(32-l·Bgbit) where tfhe-lib truncates: the
program's documented decomposition, which the comparison holds it to.

Nothing here imports the program or JAX; no floating-point arithmetic
is used (the TF32 switch is set off all the same).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False

MOD = 1 << 32


def offset(bg_bit: int, l: int) -> int:
    """The decomposition's offset, mod 2^32."""
    off = sum((1 << (bg_bit - 1)) << (32 - (j + 1) * bg_bit) for j in range(l))
    if l * bg_bit < 32:
        off += 1 << (32 - l * bg_bit - 1)
    return off % MOD


def decompose(x: torch.Tensor, bg_bit: int, l: int) -> torch.Tensor:
    """Torus values (any int64, read mod 2^32) -> their l signed digits,
    int64 (..., l), digit j at level j (weight 2^(32-(j+1)·Bgbit))."""
    v = (x + offset(bg_bit, l)) % MOD
    half, mask = 1 << (bg_bit - 1), (1 << bg_bit) - 1
    return torch.stack([((v >> (32 - (j + 1) * bg_bit)) & mask) - half
                        for j in range(l)], dim=-1)


def negacyclic_rotate(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """X^a · p mod (X^N + 1, 2^32) for polynomials p (B, ..., N) and a
    (B,) in [0, 2N): coefficient j is p[j - a] for j >= a, else
    -p[j - a + N] (a < N), the signs turning again past N."""
    n = p.shape[-1]
    j = torch.arange(n, device=p.device)
    i = (j[None, :] - a.to(torch.int64)[:, None]) % (2 * n)        # (B, N)
    sign = torch.where(i < n, 1, -1)
    shape = (p.shape[0],) + (1,) * (p.dim() - 2) + (n,)
    src = torch.gather(p, -1, (i % n).reshape(shape).expand(p.shape))
    return (src * sign.reshape(shape)) % MOD


def negacyclic_products(d: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum_p d[:, p] ⊛ key[p, o] mod (X^N + 1, 2^32): digits d (B, rows,
    N) int64 (small), key (rows, k+1, N) int64 in [0, 2^32) -> (B, k+1, N)
    int64 in [0, 2^32).  Coefficient j of X^i·key is key[j - i] for
    j >= i and -key[N + j - i] below: the key extended to (-key, key)
    and read at N + j - i.  Exact: each term is below 2^42 in magnitude
    and a chunk's sum below 2^62."""
    b, rows, n = d.shape
    kp1 = key.shape[1]
    ext = torch.cat([-key, key], dim=-1)                        # (rows, kp1, 2N)
    j = torch.arange(n, device=d.device)
    out = torch.zeros((b, kp1, n), dtype=torch.int64, device=d.device)
    chunk = max(1, min(n, (1 << 24) // max(1, b * rows * kp1 * n)))
    for i0 in range(0, n, chunk):
        i = torch.arange(i0, min(n, i0 + chunk), device=d.device)
        shifted = ext[..., n + j[None, :] - i[:, None]]         # (rows, kp1, c, N)
        terms = d[:, :, i0:i0 + len(i), None, None] * \
            shifted.permute(0, 2, 1, 3)[None]                   # (B, rows, c, kp1, N)
        out = (out + terms.sum(dim=(1, 2))) % MOD
    return out


def external_product(diff: torch.Tensor, bk_i: torch.Tensor, bg_bit: int,
                     l: int) -> torch.Tensor:
    """BK_i ⊡ diff: diff (B, k+1, N) torus, bk_i (rows, k+1, N) torus,
    rows = (k+1)·l -> (B, k+1, N) int64 in [0, 2^32)."""
    b, kp1, n = diff.shape
    digits = decompose(diff, bg_bit, l)                         # (B, kp1, N, l)
    d = digits.permute(0, 1, 3, 2).reshape(b, kp1 * l, n)      # row u·l + j
    return negacyclic_products(d, bk_i.to(torch.int64) % MOD)


def cmux_step(acc: torch.Tensor, a: torch.Tensor, bk_i: torch.Tensor,
              bg_bit: int, l: int) -> torch.Tensor:
    """acc + BK_i ⊡ (X^a·acc - acc): acc (B, k+1, N), a (B,) in [0, 2N),
    bk_i (rows, k+1, N); any integer dtype in, int64 in [0, 2^32) out."""
    acc = acc.to(torch.int64) % MOD
    diff = (negacyclic_rotate(acc, a) - acc) % MOD
    return (acc + external_product(diff, bk_i, bg_bit, l)) % MOD


def blind_rotate(acc0: torch.Tensor, bara: torch.Tensor, bk: torch.Tensor,
                 bg_bit: int, l: int) -> torch.Tensor:
    """The CMux steps in order: acc0 (B, k+1, N), bara (B, steps), bk
    (steps, rows, k+1, N) -> (B, k+1, N) as int32 (two's complement of the
    torus residue), the program's dtype."""
    acc = acc0.to(torch.int64) % MOD
    for i in range(bk.shape[0]):
        acc = cmux_step(acc, bara[:, i], bk[i], bg_bit, l)
    return as_int32(acc)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """Residues mod 2^32 (int64) -> the int32 with the same bits."""
    x = x % MOD
    return torch.where(x >= 1 << 31, x - MOD, x).to(torch.int32)
