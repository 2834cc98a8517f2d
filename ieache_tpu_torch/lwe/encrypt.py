"""Symmetric LWE encryption/decryption of gate-bootstrapping bits.

Counterpart of the host path of :mod:`ieache_tpu.lwe.encrypt`: a bit
is the torus message +1/8 (true) or -1/8 (false); decryption is the
sign of the phase.  Encryption draws from the same normative threefry
streams (:mod:`ieache_tpu_torch.utils.prng`), so both packages produce
identical ciphertexts from one stream key.  :func:`encrypt_bits` and
:func:`decrypt_bits` compute on the host with NumPy;
:func:`encrypt_bits_device` and :func:`decrypt_bits_device` compute on
the given device with torch ops and are called by name (the JAX
package's routing by array size and platform is not carried over).  All
four give the same arrays.  :func:`phase_of` is the host helper
of the noise-margin probe.
"""

from __future__ import annotations

import numpy as np
import torch

from ieache_tpu_torch.boot.bootstrap import MU
from ieache_tpu_torch.lwe import keygen_device as kd
from ieache_tpu_torch.lwe.keygen import _derive_all
from ieache_tpu_torch.lwe.types import SecretKeySet
from ieache_tpu_torch.utils import prng


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


def _key_on(keyset: SecretKeySet, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keyset.lwe_key.s, np.int32)).to(device)


def encrypt_bits_device(keyset: SecretKeySet, bits, stream_key,
                        device) -> torch.Tensor:
    """Device twin of :func:`encrypt_bits`: the same normative threefry
    stream layout and the same ciphertexts, with the mask generation,
    the noise and the exact a·s contraction computed on ``device``,
    where the result stays."""
    p = keyset.params
    bits = np.asarray(bits)
    flat = torch.from_numpy(bits.reshape(-1).astype(np.int32)).to(device)
    rk = kd._keys_to(
        prng.derive_multi(stream_key, np.arange(flat.shape[0])), device)
    a = kd._bits_multi(kd._derive(rk, 0), p.n)
    e = kd._binomial_multi(kd._derive(rk, 1), 1, p.lwe_noise_scale,
                           p.noise_bits)[:, 0]
    mu = torch.where(flat != 0, MU, -MU).to(torch.int32)
    b = kd._dot_bits(a, _key_on(keyset, flat.device)) + mu + e
    out = torch.cat([a, b[:, None]], dim=1)
    return out.reshape(bits.shape + (p.n + 1,))


def decrypt_bits_device(keyset: SecretKeySet,
                        lwe: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`decrypt_bits`: LWE batch (..., n+1) -> bit
    tensor (...,) of int32 {0,1} on ``lwe``'s device; only the key goes
    to the device and nothing comes back."""
    p = keyset.params
    flat = lwe.reshape(-1, p.n + 1).to(torch.int32)
    phase = flat[:, p.n] - kd._dot_bits(flat[:, : p.n],
                                        _key_on(keyset, lwe.device))
    return (phase > 0).to(torch.int32).reshape(lwe.shape[:-1])


def phase_of(keyset: SecretKeySet, lwe: torch.Tensor) -> np.ndarray:
    """Raw phase (b - a.s) of an LWE batch (..., n+1) as host int32, in
    wrapping int32 as :func:`decrypt_bits` computes it: for noise-margin
    diagnostics."""
    p = keyset.params
    x = lwe.detach().to("cpu", torch.int32).numpy()
    with np.errstate(over="ignore"):
        return (x[..., p.n] - x[..., : p.n] @ keyset.lwe_key.s).astype(
            np.int32)
