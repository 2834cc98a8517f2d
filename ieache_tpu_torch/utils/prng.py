"""Deterministic counter-based PRNG (Threefry-2x32-20).

The port's own copy of the NumPy part of :mod:`ieache_tpu.utils.prng`,
with torch counterparts of its jax.numpy part.  The reference's keygen
is reproducible from fixed seed words ``{314, 1592, 657}`` /
``{314, 1592, 888}`` via tfhe-lib's global RNG
(``Keygen/keygen.c:30-36``).  tfhe-lib's stream cannot be reproduced
without the library, so this module *defines* the framework's RNG: a
self-contained Threefry-2x32 implementation whose spec is mirrored bit
for bit by the JAX package and by its C++ oracle.  Everything key- or
noise-related derives from it, which is what makes keygen, encryption,
gate evaluation and decryption comparable array for array across the
two packages.

Stream spec (normative):

* a *key* is a pair of uint32 ``(k0, k1)``;
* ``key_from_seed_words([w0, w1, ...])`` folds arbitrary seed words:
  starting from ``(0, 0)``, for each word ``w`` at index ``i`` the key
  becomes ``threefry2x32(key, (w, i))``;
* ``derive(key, i)`` = ``threefry2x32(key, (i, 0x9E3779B9))`` gives
  independent sub-streams;
* ``random_bits(key, n)`` returns ``n`` uint32 words: block ``j``
  yields words ``2j`` and ``2j+1`` as ``threefry2x32(key, (j, 0))``
  ... i.e. counter pair ``(x0, x1) = (j, 0)``.

A NumPy implementation (host-side keygen) and a torch implementation
(sampling on a given device) are provided and agree bit for bit.  torch
has no usable uint32 (no ``>>`` on the CPU), so the torch functions
carry each uint32 word as the int32 of the same bit pattern: ``+`` and
``<<`` wrap, and every arithmetic ``>>`` is followed by a mask.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_ROTATIONS_A = (13, 15, 26, 6)
_ROTATIONS_B = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)
_GOLDEN = 0x9E3779B9


def _rotl(x, r, xp):
    r = np.uint32(r)
    return (x << r) | (x >> np.uint32(32 - r))


def _threefry2x32_core(k0, k1, x0, x1, xp):
    """One Threefry-2x32-20 block. All args uint32 arrays (broadcastable)."""
    ks0, ks1 = k0, k1
    ks2 = k0 ^ k1 ^ _PARITY

    x0 = x0 + ks0
    x1 = x1 + ks1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r, xp)
            x1 = x1 ^ x0
        return x0, x1

    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks1, x1 + ks2 + np.uint32(1)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_B)
    x0, x1 = x0 + ks2, x1 + ks0 + np.uint32(2)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks0, x1 + ks1 + np.uint32(3)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_B)
    x0, x1 = x0 + ks1, x1 + ks2 + np.uint32(4)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks2, x1 + ks0 + np.uint32(5)
    return x0, x1


# ---------------------------------------------------------------------------
# NumPy (host) implementation
# ---------------------------------------------------------------------------

def threefry2x32(key, x):
    """key=(k0,k1), x=(x0,x1) of uint32 scalars/arrays -> (y0,y1)."""
    k0 = np.asarray(key[0], np.uint32)
    k1 = np.asarray(key[1], np.uint32)
    x0 = np.asarray(x[0], np.uint32)
    x1 = np.asarray(x[1], np.uint32)
    with np.errstate(over="ignore"):
        return _threefry2x32_core(k0, k1, x0, x1, np)


def key_from_seed_words(words) -> tuple:
    """Fold arbitrary uint32 seed words into a (k0, k1) key."""
    k0 = np.uint32(0)
    k1 = np.uint32(0)
    for i, w in enumerate(words):
        k0, k1 = threefry2x32((k0, k1), (np.uint32(w), np.uint32(i)))
    return (np.uint32(k0), np.uint32(k1))


def derive(key, i) -> tuple:
    """Derive an independent sub-stream key."""
    y0, y1 = threefry2x32(key, (np.uint32(i), np.uint32(_GOLDEN)))
    return (np.uint32(y0), np.uint32(y1))


def deterministic_mode() -> bool:
    """IEACHE_DETERMINISTIC=1 pins protocol-path encryption streams to
    their labels (repro/testing only — see fresh_stream)."""
    return os.environ.get("IEACHE_DETERMINISTIC", "0") == "1"


def fresh_stream(*label_words) -> tuple:
    """Entropy-backed stream key for protocol-path encryptions.

    The reference draws fresh randomness for every ``bootsSymEncrypt``
    (`Client1/alice.c:116-149`).  Deriving the stream purely from
    deployment-stable labels (client index, serve count, opcode) makes
    two deployments encrypting different values at the same label emit
    ciphertexts with IDENTICAL a-vectors and noise, so ``c - c' =
    (0, Δm + Δe)`` leaks the plaintext-bit difference outright.
    Default: fold 128 bits of ``os.urandom`` after the label words.
    ``IEACHE_DETERMINISTIC=1`` restores pure label derivation for
    reproduction and the oracle-parity tests.
    """
    words = [np.uint32(int(w) & 0xFFFFFFFF) for w in label_words]
    if not deterministic_mode():
        words += list(np.frombuffer(os.urandom(16), np.uint32))
    return key_from_seed_words(words)


def random_bits(key, n: int) -> np.ndarray:
    """n uint32 words from the stream of `key` (host/NumPy)."""
    nblocks = (n + 1) // 2
    ctr = np.arange(nblocks, dtype=np.uint32)
    zero = np.zeros(nblocks, dtype=np.uint32)
    y0, y1 = threefry2x32(key, (ctr, zero))
    out = np.empty(2 * nblocks, dtype=np.uint32)
    out[0::2] = y0
    out[1::2] = y1
    return out[:n]


def uniform_torus32(key, n: int) -> np.ndarray:
    """n uniform torus elements as int32."""
    return random_bits(key, n).astype(np.int32)


def uniform_bits01(key, n: int) -> np.ndarray:
    """n uniform bits in {0,1} as int32 (lowest bit of each word)."""
    return (random_bits(key, n) & np.uint32(1)).astype(np.int32)


def binomial_noise(key, n: int, scale: int, noise_bits: int = 1024) -> np.ndarray:
    """n centered-binomial noise samples, in torus32 units (int32).

    Each sample is ``scale * (popcount(noise_bits random bits) -
    noise_bits/2)``; stddev = ``scale * sqrt(noise_bits) / 2``.
    A zero ``scale`` short-circuits to zeros (noiseless test params).
    """
    if scale == 0:
        return np.zeros(n, dtype=np.int32)
    words_per = noise_bits // 32
    w = random_bits(key, n * words_per).reshape(n, words_per)
    pop = _popcount32(w).sum(axis=1).astype(np.int64)
    centered = pop - noise_bits // 2
    return (centered * scale).astype(np.int32)


def _popcount32(v: np.ndarray) -> np.ndarray:
    """SWAR popcount of uint32 arrays (no memory blow-up)."""
    v = v.astype(np.uint32)
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    with np.errstate(over="ignore"):
        return ((v * np.uint32(0x01010101)) >> 24).astype(np.int32)


# -- vectorized multi-stream variants (same per-stream outputs) -------------

def derive_multi(key, indices) -> tuple:
    """Vectorized `derive`: indices (R,) -> (k0s, k1s) arrays of shape (R,)."""
    idx = np.asarray(indices, np.uint32)
    y0, y1 = threefry2x32(key, (idx, np.full_like(idx, _GOLDEN)))
    return (y0, y1)


def random_bits_multi(keys, n: int) -> np.ndarray:
    """Per-stream bits: keys = (k0s, k1s) of shape (R,) -> uint32 (R, n)."""
    k0, k1 = (np.asarray(k, np.uint32) for k in keys)
    nblocks = (n + 1) // 2
    ctr = np.arange(nblocks, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32_core(
            k0[:, None], k1[:, None], ctr, np.zeros_like(ctr), np
        )
    out = np.empty((k0.shape[0], 2 * nblocks), dtype=np.uint32)
    out[:, 0::2] = y0
    out[:, 1::2] = y1
    return out[:, :n]


def binomial_noise_multi(keys, n: int, scale: int,
                         noise_bits: int = 1024) -> np.ndarray:
    """Per-stream centered binomial noise: (R, n) int32."""
    k0 = np.asarray(keys[0], np.uint32)
    r = k0.shape[0]
    if scale == 0:
        return np.zeros((r, n), dtype=np.int32)
    words_per = noise_bits // 32
    w = random_bits_multi(keys, n * words_per).reshape(r, n, words_per)
    pop = _popcount32(w).sum(axis=2).astype(np.int64)
    return ((pop - noise_bits // 2) * scale).astype(np.int32)


# ---------------------------------------------------------------------------
# torch (device) implementation — same spec, same bits, carried as int32
# ---------------------------------------------------------------------------

def as_i32(x, device) -> torch.Tensor:
    """uint32 words (Python ints, NumPy scalars or arrays of any integer
    type, or int32 tensors) -> the int32 tensor of the same low 32 bits
    on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    words = (np.asarray(x).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    flat = np.atleast_1d(words).view(np.int32).copy()
    return torch.from_numpy(flat).reshape(words.shape).to(device)


def _rotl_i32(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry2x32_core_i32(k0, k1, x0, x1):
    """:func:`_threefry2x32_core` on int32 tensors (broadcastable)."""
    ks0, ks1 = k0, k1
    ks2 = k0 ^ k1 ^ int(_PARITY)

    x0 = x0 + ks0
    x1 = x1 + ks1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl_i32(x1, r)
            x1 = x1 ^ x0
        return x0, x1

    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks1, x1 + ks2 + 1
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_B)
    x0, x1 = x0 + ks2, x1 + ks0 + 2
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks0, x1 + ks1 + 3
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_B)
    x0, x1 = x0 + ks1, x1 + ks2 + 4
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks2, x1 + ks0 + 5
    return x0, x1


def torch_threefry2x32(key, x0, x1, device):
    """Counterpart of ``jax_threefry2x32``: key=(k0, k1) and counters
    x0, x1 (anything :func:`as_i32` takes) -> (y0, y1) int32 tensors on
    ``device`` holding the uint32 outputs' bit patterns."""
    return _threefry2x32_core_i32(
        as_i32(key[0], device), as_i32(key[1], device),
        as_i32(x0, device), as_i32(x1, device))


def torch_random_bits(key, n: int, device) -> torch.Tensor:
    """Counterpart of ``jax_random_bits``: the ``n`` words of
    :func:`random_bits` as an int32 tensor on ``device``."""
    nblocks = (n + 1) // 2
    ctr = torch.arange(nblocks, dtype=torch.int32, device=device)
    y0, y1 = torch_threefry2x32(key, ctr, torch.zeros_like(ctr), device)
    return torch.stack([y0, y1], dim=1).reshape(-1)[:n]


def popcount_i32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the 32 bits of each int32 word (torch has no
    popcount op); the masks undo the arithmetic shifts' sign fill."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF
