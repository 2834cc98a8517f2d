"""Encrypted integer words: batched bit-arrays of LWE ciphertexts.

Counterpart of :mod:`ieache_tpu.circuits.words`.  A *word* is
``int32 (B, W, n+1)``: B values in the batch, W bits LSB-first (bit i
of value v is ``(v >> i) & 1``), each an LWE ciphertext row.
"""

from __future__ import annotations

import numpy as np
import torch

from ieache_tpu_torch.boot import gates
from ieache_tpu_torch.lwe import encrypt
from ieache_tpu_torch.lwe.types import SecretKeySet


def values_to_bits(values, width: int) -> np.ndarray:
    """int array (B,) -> bit matrix (B, width), LSB-first (host)."""
    v = np.asarray(values, dtype=object)  # allow >64-bit python ints
    out = np.zeros((len(v), width), np.int32)
    for r, val in enumerate(v):
        val = int(val) & ((1 << width) - 1)
        for i in range(width):
            out[r, i] = (val >> i) & 1
    return out


def bits_to_values(bits) -> list:
    """bit matrix (B, W) LSB-first -> python ints (unsigned)."""
    return [sum(int(b) << i for i, b in enumerate(row))
            for row in np.asarray(bits)]


def encrypt_word(ks: SecretKeySet, values, width: int, stream,
                 device) -> torch.Tensor:
    """Encrypt a batch of integers -> (B, width, n+1) on ``device``."""
    return encrypt.encrypt_bits(ks, values_to_bits(values, width), stream,
                                device)


def decrypt_word(ks: SecretKeySet, word: torch.Tensor) -> list:
    """(B, W, n+1) -> python ints (unsigned)."""
    return bits_to_values(encrypt.decrypt_bits(ks, word))


def decrypt_word_signed(ks: SecretKeySet, word: torch.Tensor) -> list:
    """Two's-complement interpretation over the word width."""
    bits = encrypt.decrypt_bits(ks, word)
    w = bits.shape[1]
    return [v - (1 << w) if v >= (1 << (w - 1)) else v
            for v in bits_to_values(bits)]


def trivial_word(batch: int, width: int, n: int, device,
                 value: int = 0) -> torch.Tensor:
    """Trivial (noiseless) encrypted word of a public constant."""
    bits = values_to_bits([value] * batch, width)
    return gates.CONSTANT(torch.from_numpy(bits).to(device), n)
