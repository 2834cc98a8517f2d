"""The kernels layer's yardstick at any gadget: the int8 limb products a
bootstrap's external products need, whatever implements them.

A step's external product is, per ciphertext, the ``rows x (k+1)``
negacyclic products of N-coefficient polynomials, ``rows = (k+1)·l``
the published key's.  On int8 tensor cores each is an N x N Toeplitz
product per pair of a digit's int8 limb and one of the key's four 8-bit
limbs, two operations (multiply, add) a term.  A digit of ``bg_bit``
bits takes ceil(bg_bit / 8) limbs; a pair whose two limbs weigh 2^32 or
more vanishes mod 2^32 and is not counted: P = 4 pairs for one-limb
digits, 7 for two.  So a bootstrap's operations are
``n · 2 · rows · (k+1) · N^2 · P``: at one limb those of
:mod:`fhe_bench.roofline`; a kernel that runs a key with its rows
pre-shifted (8 pairs a two-limb digit) does 8/7 of this work and reads
at most 87.5% of the peak by it.  Bytes: the published key's, as
:func:`fhe_bench.roofline.bytes_per_wave` counts them (its rows as
int32, the keyswitch key, read once a wave) and the wave's ciphertexts.
"""

from __future__ import annotations

from fhe_bench import roofline

#: the torus's bits and an int8 limb's
TORUS_BITS, LIMB_BITS = 32, 8


def digit_limbs(p: dict) -> int:
    """int8 limbs a gadget digit of ``bg_bit`` bits takes."""
    return -(-p["bg_bit"] // LIMB_BITS)


def limb_pairs(p: dict) -> int:
    """(digit limb, key limb) pairs whose weight 2^(8u + 8v) is below
    2^32: 4 for one-limb digits, 7 for two."""
    key = TORUS_BITS // LIMB_BITS
    return sum(1 for u in range(digit_limbs(p)) for v in range(key)
               if LIMB_BITS * (u + v) < TORUS_BITS)


def ops_per_bootstrap(p: dict) -> int:
    rows = (p["k"] + 1) * p["l"]
    return p["n"] * 2 * rows * (p["k"] + 1) * p["N"] ** 2 * limb_pairs(p)


def least_seconds(p: dict, boots: int, batch: int,
                  peak=roofline.H100) -> float:
    """The least time ``boots`` bootstraps in waves of ``batch`` take:
    the larger of their limb products over the int8 peak and their bytes
    over the HBM's."""
    waves = boots / batch
    return max(boots * ops_per_bootstrap(p) / peak["int8_ops_per_s"],
               waves * roofline.bytes_per_wave(p, batch)
               / peak["hbm_bytes_per_s"])
