"""A frozen copy of the key derivation: Threefry-2x32-20 in NumPy and
the LWE secret key of a keyset derived from its seed words.

The stream spec, as the program documents it: a key is a pair of uint32;
``key_from_seed_words`` folds the words into it starting from (0, 0),
word ``w`` at index ``i`` giving ``threefry((k0, k1), (w, i))``;
``derive(key, i) = threefry(key, (i, 0x9E3779B9))``; block ``j`` of a
stream is ``threefry(key, (j, 0))`` and gives words ``2j`` and ``2j+1``.
A keyset's binary LWE key is the lowest bit of the first ``n`` words of
the stream ``derive(master, 0)``.  Copied here so that a change of the
program's derivation cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)
_GOLDEN = np.uint32(0x9E3779B9)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x):
    """Threefry-2x32 with 20 rounds: key (k0, k1), counter (x0, x1), all
    uint32 (arrays broadcast) -> (y0, y1)."""
    k0, k1 = (np.asarray(k, np.uint32) for k in key)
    x0, x1 = (np.asarray(v, np.uint32) for v in x)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for s in range(5):
            for r in (_ROT_A if s % 2 == 0 else _ROT_B):
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(s + 1) % 3]
            x1 = x1 + ks[(s + 2) % 3] + np.uint32(s + 1)
    return x0, x1


def key_from_seed_words(words) -> tuple:
    key = (np.uint32(0), np.uint32(0))
    for i, w in enumerate(words):
        key = threefry2x32(key, (np.uint32(w), np.uint32(i)))
    return key


def derive(key, i) -> tuple:
    return threefry2x32(key, (np.uint32(i), _GOLDEN))


def random_words(key, n: int) -> np.ndarray:
    blocks = (n + 1) // 2
    y0, y1 = threefry2x32(key, (np.arange(blocks, dtype=np.uint32),
                                np.zeros(blocks, np.uint32)))
    return np.stack([y0, y1], axis=1).reshape(-1)[:n]


def lwe_secret(seed_words, n: int) -> np.ndarray:
    """The binary LWE key (n,) int32 of the keyset derived from
    ``seed_words``."""
    master = key_from_seed_words(seed_words)
    return (random_words(derive(master, 0), n) & 1).astype(np.int32)


#: the label word of each keyset, before the seed's two words
KEYSET_LABELS = {"main": 0x6D61696E, "nbit": 0x6E626974}


def seed_words(seed: int, keyset: str) -> tuple:
    """The seed words the benchmark derives keyset ``keyset`` (``main``
    or ``nbit``) from for run seed ``seed`` (any whole number below
    2^64): its label, then the seed's low and high 32 bits."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    return (KEYSET_LABELS[keyset], seed & 0xFFFFFFFF, seed >> 32)
