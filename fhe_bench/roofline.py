"""The yardstick of the kernels layer: the card's published peaks and
the least time a bootstrap can take there.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 1,979 TOP/s in int8
on the tensor cores and 3.35 TB/s of HBM, at the full 700 W power limit.

Work counted, whatever implements the rotation: a bootstrap is n CMux
steps, and a step's external product is, per ciphertext, the
``rows x (k+1)`` negacyclic products of N-coefficient polynomials, each
an N x N Toeplitz product over the key's four 8-bit limbs, two
operations (multiply, add) a term: ``2 * rows * (k+1) * N**2 * 4``.
The keyswitch's additions are left out.  Bytes counted: the
bootstrapping and keyswitch keys read once a wave, as int32, and the
wave's input and output ciphertexts.
"""

from __future__ import annotations

#: one H100 SXM: int8 tensor-core operations per second, HBM bytes/s
H100 = {"int8_ops_per_s": 1979e12, "hbm_bytes_per_s": 3.35e12}


def ops_per_bootstrap(p: dict) -> int:
    rows = (p["k"] + 1) * p["l"]
    return p["n"] * 2 * rows * (p["k"] + 1) * p["N"] ** 2 * 4


def bytes_per_wave(p: dict, batch: int) -> int:
    rows = (p["k"] + 1) * p["l"]
    bk = p["n"] * rows * (p["k"] + 1) * p["N"] * 4
    ks = p["k"] * p["N"] * p["ks_t"] * (p["n"] + 1) * 4
    return bk + ks + 2 * batch * (p["n"] + 1) * 4


def least_seconds(p: dict, boots: int, batch: int, peak=H100) -> float:
    """The least time ``boots`` bootstraps in waves of ``batch`` take:
    the larger of their operations over the int8 peak and their bytes
    over the HBM's."""
    waves = boots / batch
    return max(boots * ops_per_bootstrap(p) / peak["int8_ops_per_s"],
               waves * bytes_per_wave(p, batch) / peak["hbm_bytes_per_s"])
