"""Symmetric LWE encryption/decryption of gate-bootstrapping bits.

Counterpart of the host path of :mod:`ieache_tpu.lwe.encrypt`: a bit
is the torus message +1/8 (true) or -1/8 (false); decryption is the
sign of the phase.  Encryption draws from the same normative threefry
streams (:mod:`ieache_tpu.utils.prng`), so both backends produce
identical ciphertexts from one stream key.  The JAX module is not
called because its entry points import jax (device routing); this one
never does.
"""

from __future__ import annotations

import numpy as np
import torch

from ieache_tpu.lwe.types import SecretKeySet
from ieache_tpu.utils import prng
from ieache_tpu_torch.boot.bootstrap import MU


def _derive_all(keys, idx):
    return prng.threefry2x32(
        (keys[0], keys[1]),
        (np.full_like(keys[0], idx), np.full_like(keys[0], 0x9E3779B9)),
    )


def encrypt_bits(keyset: SecretKeySet, bits, stream_key,
                 device) -> torch.Tensor:
    """Encrypt a bit array -> LWE batch int32 (..., n+1) on ``device``.

    Sample r of the flattened batch uses sub-stream
    derive(stream_key, r), with its mask at derive(sub, 0) and its noise
    at derive(sub, 1) (normative; mirrored by the C++ oracle).
    """
    p = keyset.params
    bits = np.asarray(bits)
    flat = bits.reshape(-1)
    row_keys = prng.derive_multi(stream_key, np.arange(flat.shape[0]))
    a = prng.random_bits_multi(_derive_all(row_keys, 0), p.n).astype(np.int32)
    e = prng.binomial_noise_multi(
        _derive_all(row_keys, 1), 1, p.lwe_noise_scale, p.noise_bits
    )[:, 0]
    mu = np.where(flat != 0, MU, -MU).astype(np.int32)
    with np.errstate(over="ignore"):
        b = (a @ keyset.lwe_key.s + mu + e).astype(np.int32)
    out = np.concatenate([a, b[:, None]], axis=1)
    return torch.from_numpy(out.reshape(bits.shape + (p.n + 1,))).to(device)


def decrypt_bits(keyset: SecretKeySet, lwe: torch.Tensor) -> np.ndarray:
    """Decrypt LWE batch (..., n+1) -> host bit array (...,) of int32
    {0,1}: the sign of b - a·s, in wrapping int32 on the host."""
    p = keyset.params
    x = lwe.detach().to("cpu", torch.int32).numpy()
    with np.errstate(over="ignore"):
        phase = (x[..., p.n] - x[..., : p.n] @ keyset.lwe_key.s).astype(np.int32)
    return (phase > 0).astype(np.int32)
