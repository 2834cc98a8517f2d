"""Gate bootstrapping pipeline: modswitch → blind rotate → extract → keyswitch.

Counterpart of :mod:`ieache_tpu.boot.bootstrap`, batched over a
leading gate axis B.  The blind rotation runs the CUDA kernels for a
key on a CUDA device; the other stages are plain PyTorch ops, as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ieache_tpu_torch.lwe.types import (
    CloudKeySet,
    LweKey,
    SecretKeySet,
    TrlweKey,
)
from ieache_tpu_torch.ops.blind_rotate import blind_rotate
from ieache_tpu_torch.ops.kernels import limb_key
from ieache_tpu_torch.ops.keyswitch import (
    keyswitch,
    keyswitch_plain,
    pack_ks_limbs,
    pad_ks_limbs,
)
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import trace

#: torus encoding of a gate-bootstrapping bit (1/8); a test pins it to
#: the JAX package's
MU = 1 << 29


class DeviceCloudKey(nn.Module):
    """Evaluation keys on one device.

    Buffers: ``bk`` int32 (n, rows, k+1, N), ``ks_limbs`` int8
    (TORUS_LIMBS, kN*t, M), M = n+1 padded to a multiple of 8, and
    ``bk_limbs``: where a gadget digit takes two int8 limbs, the key the
    split kernels read, int32 (n, 2 rows, k+1, N) with (2^8·b) mod 2^32
    beside each row b (``kernels.limb_key``), made once here; else None.
    """

    def __init__(self, bk: torch.Tensor, ks_limbs: torch.Tensor,
                 params: TFHEParams):
        super().__init__()
        self.params = params
        self.register_buffer("bk", bk)
        self.register_buffer("ks_limbs", ks_limbs)
        self.register_buffer("bk_limbs", limb_key(bk, params)
                             if params.digit_limbs != 1 else None)


def pack_cloud_key(cloud: CloudKeySet, device) -> DeviceCloudKey:
    """Host cloud keys (NumPy ``bk``, ``ks``) -> :class:`DeviceCloudKey`."""
    return DeviceCloudKey(
        bk=torch.tensor(np.asarray(cloud.bk, np.int32), device=device),
        ks_limbs=pack_ks_limbs(cloud.ks, device),
        params=cloud.params,
    )


def from_jax_cloud_key(dck_arrays, params: TFHEParams, device) -> DeviceCloudKey:
    """The JAX package's packed key -> :class:`DeviceCloudKey`.

    ``dck_arrays`` = ``(bk, ks_limbs)`` of a JAX ``DeviceCloudKey`` as
    NumPy arrays (``np.asarray(dck.bk)``, ``np.asarray(dck.ks_limbs)``);
    ``ks_limbs`` gets the same column padding as :func:`pack_cloud_key`.
    """
    bk, ks_limbs = dck_arrays
    return DeviceCloudKey(
        bk=torch.tensor(np.asarray(bk, np.int32), device=device),
        ks_limbs=pad_ks_limbs(torch.tensor(np.asarray(ks_limbs, np.int8)),
                              device),
        params=params,
    )


def from_jax_keyset(keyset) -> SecretKeySet:
    """A JAX-package ``SecretKeySet`` (or any object with its fields)
    -> the port's :class:`~ieache_tpu_torch.lwe.types.SecretKeySet`
    with the port's ``TFHEParams``: same arrays, same parameter fields,
    so that one keyset feeds both packages."""
    p = TFHEParams(**dataclasses.asdict(keyset.params))
    as_i32 = functools.partial(np.asarray, dtype=np.int32)
    return SecretKeySet(
        p, LweKey(p, as_i32(keyset.lwe_key.s)),
        TrlweKey(p, as_i32(keyset.trlwe_key.coefs)),
        CloudKeySet(p, as_i32(keyset.cloud.bk), as_i32(keyset.cloud.ks)))


def mod_switch_2n(x: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Torus32 -> Z_{2N} with round-to-nearest: (B, ...) int32 in [0, 2N).

    Wrapping int32 add and arithmetic shift; the mask keeps only the
    log2(2N) = 32 - shift low bits, so the result equals the JAX
    version's uint32 add and logical shift.
    """
    shift = 32 - params.log2_2N
    v = x.to(torch.int32) + (1 << (shift - 1))
    return (v >> shift) & (2 * params.N - 1)


def _rotated_test_vector(barb: torch.Tensor, mu: int,
                         params: TFHEParams) -> torch.Tensor:
    """b-polynomial of X^(2N-barb) · (mu, mu, ..., mu): (B, N) int32.

    Coefficient j of the rotated all-mu test vector is +mu when
    (j - t) mod 2N < N (t = 2N - barb), else -mu.
    """
    n = params.N
    t = (2 * n - barb.to(torch.int64)) % (2 * n)               # (B,)
    j = torch.arange(n, device=barb.device)
    pos = (j[None, :] - t[:, None]) % (2 * n)                  # (B, N)
    return torch.where(pos < n, mu, -mu).to(torch.int32)


def sample_extract(acc: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Extract coefficient 0: (B, k+1, N) -> LWE (B, kN+1) under K-flat.

    a[u*N + 0] = acc_u[0]; a[u*N + m] = -acc_u[N-m] (negacyclic wrap).
    """
    k = params.k
    parts = []
    for u in range(k):
        parts.append(torch.cat(
            [acc[:, u, :1], -torch.flip(acc[:, u, 1:], dims=[-1])], dim=-1
        ))
    parts.append(acc[:, k, :1])
    return torch.cat(parts, dim=-1).to(torch.int32)


def initial_accumulator(lwe: torch.Tensor, params: TFHEParams,
                        mu: int = MU) -> tuple:
    """(B, n+1) -> the blind rotation's inputs: the rotated test vector
    as accumulator (B, k+1, N) int32 and the mod-switched mask (B, n)."""
    p = params
    bara = mod_switch_2n(lwe[:, :p.n], p)                      # (B, n)
    barb = mod_switch_2n(lwe[:, p.n], p)                       # (B,)
    acc0 = torch.zeros((lwe.shape[0], p.k + 1, p.N), dtype=torch.int32,
                       device=lwe.device)
    acc0[:, p.k, :] = _rotated_test_vector(barb, mu, p)
    return acc0, bara


def bootstrap_no_ks(lwe: torch.Tensor, key: DeviceCloudKey, mu: int = MU,
                    plain: bool = False) -> torch.Tensor:
    """(B, n+1) -> (B, kN+1): bootstrap without the final keyswitch.

    ``plain=True`` runs the blind rotation's plain path on any device
    (the reference the CUDA kernels are compared with).
    """
    p = key.params
    # one wave: its lanes are the ciphertexts bootstrapped
    with trace.span("bootstrap", lanes=lwe.shape[0]):
        acc0, bara = initial_accumulator(lwe, p, mu)
        acc = blind_rotate(acc0, bara, key.bk, p, plain=plain,
                           bk_limbs=key.bk_limbs)
        return sample_extract(acc, p)


def bootstrap(lwe: torch.Tensor, key: DeviceCloudKey, mu: int = MU,
              plain: bool = False) -> torch.Tensor:
    """Full gate bootstrap: (B, n+1) -> (B, n+1), result ≈ LWE(±mu).

    ``plain=True`` runs the plain blind rotation and the plain keyswitch
    (``keyswitch_plain``) on any device: the reference both kernels'
    paths are compared with.
    """
    ext = bootstrap_no_ks(lwe, key, mu, plain=plain)
    return (keyswitch_plain if plain else keyswitch)(ext, key.ks_limbs,
                                                     key.params)
