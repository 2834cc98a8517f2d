"""Keyset generation on a torch device — bit-identical to the host path.

Counterpart of :mod:`ieache_tpu.lwe.keygen_device`.  The host NumPy
path in :mod:`ieache_tpu_torch.lwe.keygen` spends its time in threefry
streams and int32 matmuls; this module runs the heavy parts as torch
ops on the given device:

* all threefry streams via the torch implementation of
  :mod:`ieache_tpu_torch.utils.prng` (uint32 words carried as int32);
* centered-binomial noise via a SWAR popcount;
* the TRLWE body polynomials ``b = Σ a_u ⊛ K_u`` as int8-limb matmuls
  against the Toeplitz expansion of the (binary) TRLWE key;
* the keyswitch bodies ``b = a·s + msg + e`` as an exact integer
  matrix-vector product.

The JAX module's ``_jderive``, ``_jbits_multi`` and ``_jbinomial_multi``
are :func:`_derive`, :func:`_bits_multi` and :func:`_binomial_multi`
here (the ``j`` stood for jax.numpy).  ``generate_secret_keyset_device``
takes an explicit ``device`` and never falls back to the host
generators; it must produce arrays identical to theirs.
"""

from __future__ import annotations

import numpy as np
import torch

from ieache_tpu_torch.core import poly
from ieache_tpu_torch.lwe import keygen as host_kg
from ieache_tpu_torch.lwe.types import (
    CloudKeySet,
    GateKeyPair,
    LweKey,
    SecretKeySet,
    TrlweKey,
)
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import prng
from ieache_tpu_torch.utils.prng import _GOLDEN, _threefry2x32_core_i32

#: words one :func:`_binomial_multi` chunk may draw: bounds the threefry
#: temporaries (about ten int32 tensors of this many words) to a few GB
_NOISE_CHUNK_WORDS = 1 << 26


def _derive(keys, idx):
    """Vectorized ``derive`` over key tensors: keys = (k0, k1) int32
    (R,), ``idx`` an int or an int32 (R,) tensor."""
    k0, k1 = keys
    i = (torch.full_like(k0, idx) if isinstance(idx, int)
         else idx.to(torch.int32))
    golden = prng.as_i32(_GOLDEN, k0.device)
    return _threefry2x32_core_i32(k0, k1, i, golden)


def _bits_multi(keys, n: int) -> torch.Tensor:
    """Per-stream words: keys (R,) -> int32 (R, n), the bit patterns of
    ``prng.random_bits_multi``."""
    k0, k1 = keys
    nblocks = (n + 1) // 2
    ctr = torch.arange(nblocks, dtype=torch.int32, device=k0.device)[None, :]
    y0, y1 = _threefry2x32_core_i32(k0[:, None], k1[:, None], ctr,
                                    torch.zeros_like(ctr))
    out = torch.stack([y0, y1], dim=-1).reshape(k0.shape[0], 2 * nblocks)
    return out[:, :n]


def _binomial_multi(keys, n: int, scale: int, noise_bits: int) -> torch.Tensor:
    """Per-stream centered binomial noise: int32 (R, n), equal to
    ``prng.binomial_noise_multi``; streams are drawn in chunks of at
    most ``_NOISE_CHUNK_WORDS`` words."""
    k0, k1 = keys
    r = k0.shape[0]
    if scale == 0:
        return torch.zeros((r, n), dtype=torch.int32, device=k0.device)
    words_per = noise_bits // 32
    rows = max(1, _NOISE_CHUNK_WORDS // (n * words_per))
    out = []
    for lo in range(0, r, rows):
        w = _bits_multi((k0[lo:lo + rows], k1[lo:lo + rows]), n * words_per)
        pop = prng.popcount_i32(w).reshape(-1, n, words_per).sum(
            dim=2, dtype=torch.int32)
        out.append((pop - noise_bits // 2) * scale)
    return torch.cat(out, dim=0)


def _limb_matmul_i32(a32: torch.Tensor, t8: torch.Tensor) -> torch.Tensor:
    """Exact (R, N) int32 @ (N, M) int8 matrix, mod 2^32: four int8 limb
    products recombined with wrapping shifts.  Outside any kernel, as
    the JAX package leaves it to XLA."""
    limbs = poly.split_i8_limbs(a32)                 # (R, N, 4)
    out = torch.zeros((a32.shape[0], t8.shape[1]), dtype=torch.int32,
                      device=a32.device)
    for v in range(poly.TORUS_LIMBS):
        out = out + (poly._dot_i8(limbs[..., v].contiguous(), t8) << (8 * v))
    return out


def _dot_bits(a32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Exact (R, n) int32 @ (n,) binary key -> (R,) int32 mod 2^32: the
    one-column case of :func:`_limb_matmul_i32`, as an exact int64 sum
    wrapped to 32 bits (an int8 matmul with one output column would
    need its operand padded to eight)."""
    total = (a32 * s[None, :].to(torch.int32)).sum(dim=1)      # int64, exact
    return (((total + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _keys_to(keys, device):
    """NumPy uint32 key arrays (k0s, k1s) -> int32 tensors on ``device``."""
    return prng.as_i32(keys[0], device), prng.as_i32(keys[1], device)


def generate_secret_keyset_device(
    params: TFHEParams, device, seed_words=host_kg.MAIN_SEED
) -> SecretKeySet:
    """:func:`ieache_tpu_torch.lwe.keygen.generate_secret_keyset` with
    the streams and products computed on ``device``; the keyset comes
    back as host arrays, equal to the host generator's."""
    p = params
    device = torch.device(device)
    master = prng.key_from_seed_words(seed_words)
    lwe_s = prng.uniform_bits01(prng.derive(master, 0), p.n)
    trlwe_k = prng.uniform_bits01(
        prng.derive(master, 1), p.k * p.N
    ).reshape(p.k, p.N)

    rows, n, big_n, k = p.trgsw_rows, p.n, p.N, p.k

    # ---- bootstrapping key ------------------------------------------------
    bk_root = prng.derive(master, 2)
    i_keys = _keys_to(prng.derive_multi(bk_root, np.arange(n)), device)
    # derive(i, p) for all rows -> (n*rows,)
    row_keys = [_derive(i_keys, pr) for pr in range(rows)]
    rk = (torch.stack([r[0] for r in row_keys], 1).reshape(-1),
          torch.stack([r[1] for r in row_keys], 1).reshape(-1))

    masks = [_bits_multi(_derive(rk, u), big_n) for u in range(k)]
    noise = _binomial_multi(_derive(rk, k), big_n, p.tlwe_noise_scale,
                            p.noise_bits)

    # b = sum_u a_u * K_u + e via Toeplitz matmul (K binary -> int8)
    t_key = poly.toeplitz_negacyclic(
        torch.from_numpy(trlwe_k).to(device))            # (k, N, N)
    b = noise
    for u in range(k):
        b = b + _limb_matmul_i32(masks[u], t_key[u].to(torch.int8))

    bk = torch.stack(masks + [b], dim=1).reshape(n, rows, k + 1, big_n)
    # gadget message: row p = u*l + j gets s_i * h_j on component u
    # (wrapping int32)
    h = host_kg.gadget_h(p)
    s_dev = torch.from_numpy(lwe_s).to(device)
    for u in range(k + 1):
        for j in range(p.l):
            bk[:, u * p.l + j, u, 0] += s_dev * int(h[j])

    # ---- keyswitch key ----------------------------------------------------
    ks_root = prng.derive(master, 3)
    nrows = p.kN * p.ks_t
    r_keys = _keys_to(prng.derive_multi(ks_root, np.arange(nrows)), device)
    a = _bits_multi(_derive(r_keys, 0), n)                # (nrows, n)
    e = _binomial_multi(
        _derive(r_keys, 1), 1, p.lwe_noise_scale, p.noise_bits
    )[:, 0]
    hks = host_kg.ks_gadget_h(p).astype(np.int64)
    msg = (
        trlwe_k.reshape(-1).astype(np.int64)[:, None] * hks[None, :]
    ).reshape(-1).astype(np.int32)
    b_ks = (_dot_bits(a, s_dev) + torch.from_numpy(msg).to(device) + e)
    ks = torch.cat([a, b_ks[:, None]], dim=1)

    cloud = CloudKeySet(p, bk.cpu().numpy(), ks.cpu().numpy())
    return SecretKeySet(
        p, LweKey(p, lwe_s), TrlweKey(p, trlwe_k), cloud
    )


def generate_gate_keypair_device(params: TFHEParams, device) -> GateKeyPair:
    """The reference's two keysets (main + nbit) on ``device``."""
    return GateKeyPair(
        main=generate_secret_keyset_device(params, device, host_kg.MAIN_SEED),
        nbit=generate_secret_keyset_device(params, device, host_kg.NBIT_SEED),
    )
