"""Exact negacyclic NTT over two small CRT primes, on torch tensors.

Counterpart of :mod:`ieache_tpu.core.ntt` (which imports jax, so its
tables and functions are re-declared here; tests/test_torch_transposed_ntt.py
pins every function to its JAX twin).  It backs the blind rotation's
``ntt`` step mode (``IEACHE_PALLAS_STEP=ntt``):

* a torus operand is split into four balanced 8-bit limbs, so each limb
  convolution with a gadget digit is bounded by rows * N * 128 * 128
  and fits the CRT range of the primes 12289 and 18433 (both
  k * 2^11 + 1, with the 2N-th roots the negacyclic twist needs);
* all modular arithmetic is Montgomery with R = 2^16.  torch has no
  usable uint32, so the reference's uint32 steps are written in int32,
  with a mask after every shift: a*b < 2^30 fits; the low 16 bits of
  (t & 0xFFFF) * pinv survive int32 wrapping; t + m*p < 2^30 + 2^31
  wraps, and ``((t + m*p) >> 16) & 0xFFFF`` recovers its top 16 bits;
* forward CT takes natural order to bit-reversed, inverse GS returns to
  natural order, with the psi twist merged into the twiddles and the
  pointwise product's R^-1 cancelled by an R^2 fold in the inverse's
  n^-1 scaling.

Residues are int32 tensors in [0, p) (the reference's uint32 values).
The transforms work on a stack whose leading axis indexes the prime, so
that one butterfly stage is one set of tensor ops for both primes (and
every limb, row and batch lane), not one per prime and limb.  There is
no kernel here: the JAX package leaves this path to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: CRT primes: k * 2^11 + 1, < 2^15 (Montgomery-safe in 32 bits)
PRIMES = (12289, 18433)
R_BITS = 16
R = 1 << R_BITS
R_MASK = R - 1
#: 0x80808080 as a wrapped int32: the balanced byte-limb bias
_LIMB_BIAS_NTT = -0x7F7F7F80


def _is_prime(p: int) -> bool:
    i = 2
    while i * i <= p:
        if p % i == 0:
            return False
        i += 1
    return p >= 2


def _find_generator(p: int) -> int:
    fac, m, d = [], p - 1, 2
    while d * d <= m:
        if m % d == 0:
            fac.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fac.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fac):
            return g
    raise ValueError(f"no generator for {p}")


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


@functools.lru_cache(maxsize=None)
def _host_tables(n: int):
    """Per-prime host tables (numpy) for the length-n negacyclic NTT;
    the same values as the JAX package's ``_host_tables``."""
    assert n & (n - 1) == 0
    logn = n.bit_length() - 1
    per = []
    for p in PRIMES:
        assert _is_prime(p) and (p - 1) % (2 * n) == 0 and p < (1 << 15)
        g = _find_generator(p)
        psi = pow(g, (p - 1) // (2 * n), p)      # primitive 2n-th root
        ipsi = pow(psi, p - 2, p)
        # bit-reversed psi power tables (Longa-Naehrig)
        psi_br = np.array([pow(psi, _bitrev(i, logn), p) for i in range(n)],
                          np.uint64)
        ipsi_br = np.array([pow(ipsi, _bitrev(i, logn), p)
                            for i in range(n)], np.uint64)
        ninv = pow(n, p - 2, p)
        pinv = (-pow(p, -1, R)) % R              # -p^-1 mod 2^16
        per.append({
            "p": p, "pinv": pinv,
            "psi_br_m": ((psi_br * R) % p).astype(np.uint32),
            "ipsi_br_m": ((ipsi_br * R) % p).astype(np.uint32),
            # n^-1 with the R^2 fold: mont_mul(x*R^-1, c) = x*n^-1
            # exactly when c = n^-1 * R^2 mod p
            "ninv_r2_m": np.uint32((ninv * R * R) % p),
            "ninv_r_m": np.uint32((ninv * R) % p),
        })
    p0, p1 = PRIMES
    crt = {
        "inv_p0_p1_m": np.uint32((pow(p0, -1, p1) * R) % p1),
        "p0_u32": np.uint32(p0 & 0xFFFFFFFF),
        "P_u32": np.uint32((p0 * p1) & 0xFFFFFFFF),
    }
    return {"logn": logn, "per": per, "crt": crt}


@functools.lru_cache(maxsize=None)
def _dev_tables(n: int, device: str):
    """The host tables as int32 tensors on ``device``, stacked over the
    primes: twiddles (P, n), and p, pinv and the two n^-1 constants
    (P,)."""
    per = _host_tables(n)["per"]

    def stack(key):
        return torch.tensor(np.stack([np.asarray(q[key], np.int64)
                                      for q in per]),
                            dtype=torch.int32, device=device)

    return {key: stack(key) for key in ("p", "pinv", "psi_br_m", "ipsi_br_m",
                                        "ninv_r2_m", "ninv_r_m")}


def _tables(n: int, device) -> dict:
    return _dev_tables(n, str(torch.device(device)))


def _lead(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-prime (P, ...) tensor shaped to broadcast against a
    prime-stacked tensor of ``ndim`` dimensions."""
    return c.reshape(c.shape + (1,) * (ndim - c.dim()))


def prime_constants(n: int, device, ndim: int):
    """(p, pinv), each (P,) int32 shaped to broadcast against a
    prime-stacked tensor of ``ndim`` dimensions."""
    tab = _tables(n, device)
    return _lead(tab["p"], ndim), _lead(tab["pinv"], ndim)


# -- Montgomery primitives (int32 holding [0, p), p < 2^15) -----------------

def _mont_mul(a, b, p, pinv):
    """a * b * R^-1 mod p; ``p`` and ``pinv`` are ints or tensors that
    broadcast against ``a``."""
    t = a * b                                        # < 2^30
    m = ((t & R_MASK) * pinv) & R_MASK               # wraps; low bits exact
    u = ((t + m * p) >> R_BITS) & R_MASK             # top half of a uint32
    return torch.where(u >= p, u - p, u)


def _add_mod(a, b, p):
    s = a + b
    return torch.where(s >= p, s - p, s)


def _sub_mod(a, b, p):
    return torch.where(a >= b, a - b, a + p - b)


# -- transforms -------------------------------------------------------------

def _fwd_one(x: torch.Tensor, psi: torch.Tensor, p: torch.Tensor,
             pinv: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward (psi merged), natural -> bit-reversed, of a
    prime stack: x (P', ..., n) int32 in [0, p), psi (P', n), p and
    pinv (P',).  Every stage views the array as (P', lead, m, 2, t) and
    uses twiddle psi[m + i] for block i."""
    shape, n = x.shape, x.shape[-1]
    np_ = shape[0]
    pb, pib = _lead(p, 4), _lead(pinv, 4)
    m, t = 1, n
    while m < n:
        t //= 2
        y = x.reshape(np_, -1, m, 2, t)
        u, v = y[..., 0, :], y[..., 1, :]
        s = psi[:, m:2 * m].reshape(np_, 1, m, 1)
        vt = _mont_mul(v, s, pb, pib)
        x = torch.stack([_add_mod(u, vt, pb), _sub_mod(u, vt, pb)], dim=-2)
        m *= 2
    return x.reshape(shape)


def _inv_one(x: torch.Tensor, ipsi: torch.Tensor, p: torch.Tensor,
             pinv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse of a prime stack, bit-reversed -> natural,
    then times ``scale`` (P',) in Montgomery form: ninv_r_m for x*n^-1,
    ninv_r2_m to also cancel a pointwise R^-1 defect."""
    shape, n = x.shape, x.shape[-1]
    np_ = shape[0]
    pb, pib = _lead(p, 4), _lead(pinv, 4)
    t, m = 1, n
    while m > 1:
        h = m // 2
        y = x.reshape(np_, -1, h, 2, t)
        u, v = y[..., 0, :], y[..., 1, :]
        s = ipsi[:, h:2 * h].reshape(np_, 1, h, 1)
        x = torch.stack([_add_mod(u, v, pb),
                         _mont_mul(_sub_mod(u, v, pb), s, pb, pib)], dim=-2)
        t *= 2
        m = h
    x = x.reshape(np_, -1, n)
    p3, pi3 = _lead(p, 3), _lead(pinv, 3)
    return _mont_mul(x, _lead(scale, 3), p3, pi3).reshape(shape)


def ntt_forward_digits(d: torch.Tensor, n: int) -> torch.Tensor:
    """Digit polys (..., N) int (|d| < p_min) -> spectra (P, ..., N)
    int32 (bit-reversed order, normal domain)."""
    tab = _tables(n, d.device)
    x = d.to(torch.int32).unsqueeze(0)
    x = torch.where(x < 0, x + _lead(tab["p"], x.dim()), x)
    return _fwd_one(x, tab["psi_br_m"], tab["p"], tab["pinv"])


def torus_limbs(g: torch.Tensor) -> torch.Tensor:
    """Torus polys (..., N) int32 -> (4, ..., N) int32, the balanced
    byte limbs: sum_v limb_v * 2^(8v) == g mod 2^32, each in
    [-128, 127]."""
    x32 = (g.to(torch.int32) + _LIMB_BIAS_NTT) ^ _LIMB_BIAS_NTT
    return torch.stack([(x32 << (24 - 8 * v)) >> 24 for v in range(4)])


def ntt_forward_torus_limbs(g: torch.Tensor, n: int) -> torch.Tensor:
    """Torus polys (..., N) int32 -> spectra (P, 4, ..., N) int32 of the
    four balanced byte limbs.  Precomputable for the bootstrapping key;
    the result stays int32 (131 MB for the whole key at
    IEACHE_110_FAST)."""
    tab = _tables(n, g.device)
    limbs = torus_limbs(g).unsqueeze(0)                  # (1, 4, ..., N)
    x = torch.where(limbs < 0, limbs + _lead(tab["p"], limbs.dim()), limbs)
    return _fwd_one(x, tab["psi_br_m"], tab["p"], tab["pinv"])


def ntt_pointwise(a, b, prime_idx: int, n: int):
    """Spectrum product with an R^-1 defect (cancelled by the inverse
    when called with extra_r=True)."""
    per = _host_tables(n)["per"][prime_idx]
    return _mont_mul(a, b, per["p"], per["pinv"])


def ntt_inverse(spec: torch.Tensor, prime_idx: int, n: int,
                extra_r: bool = True) -> torch.Tensor:
    """Inverse transform of one prime's spectra (..., N)."""
    tab = _tables(n, spec.device)
    sl = slice(prime_idx, prime_idx + 1)
    scale = tab["ninv_r2_m" if extra_r else "ninv_r_m"][sl]
    return _inv_one(spec.unsqueeze(0), tab["ipsi_br_m"][sl], tab["p"][sl],
                    tab["pinv"][sl], scale)[0]


def ntt_inverse_stack(spec: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`ntt_inverse` with ``extra_r`` of every prime at once:
    spec (P, ..., N) -> residues (P, ..., N)."""
    tab = _tables(n, spec.device)
    return _inv_one(spec, tab["ipsi_br_m"], tab["p"], tab["pinv"],
                    tab["ninv_r2_m"])


def crt_to_int32(v0: torch.Tensor, v1: torch.Tensor, n: int) -> torch.Tensor:
    """Residues (int32 in [0, p_i)) of a signed value |v| << P/2 ->
    v mod 2^32 as int32, exact (Garner mixed radix, two primes)."""
    crt = _host_tables(n)["crt"]
    p0, p1 = PRIMES
    pinv1 = _host_tables(n)["per"][1]["pinv"]
    d1 = _mont_mul(_sub_mod(v1, v0 % p1, p1), int(crt["inv_p0_p1_m"]), p1,
                   pinv1)
    x = v0 + d1 * p0                                 # < 2^28
    # d1 >= p1/2 <=> negative integer (|v| <= 2^24 << P/2 ~ 2^26.75)
    return torch.where(d1 >= p1 // 2, x - int(crt["P_u32"]), x)


def negacyclic_mul_ntt(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Exact (mod 2^32) negacyclic product via the CRT-NTT path.

    d: (..., N) int digits (|d| <= 128); g: (..., N) int32 torus poly
    (broadcast-compatible with d).  Bit-identical to
    :func:`ieache_tpu.core.poly.negacyclic_mul_np`.
    """
    n = g.shape[-1]
    dh = ntt_forward_digits(d, n)                    # (P, ..., N)
    gh = ntt_forward_torus_limbs(g, n)               # (P, 4, ..., N)
    # align the lead axes as numpy broadcasting does, right to left
    nd = max(d.dim(), g.dim()) + 2
    dh = dh.reshape(dh.shape[:1] + (1,) * (nd - dh.dim()) + dh.shape[1:])
    gh = gh.reshape(gh.shape[:2] + (1,) * (nd - gh.dim()) + gh.shape[2:])
    return limb_products_to_int32(
        _mont_mul(dh, gh, *prime_constants(n, d.device, nd)), n)


def limb_products_to_int32(spec: torch.Tensor, n: int) -> torch.Tensor:
    """Pointwise products (P, 4, ..., N) of digit spectra with the four
    byte-limb spectra (each with the R^-1 defect) -> the int32
    negacyclic product (..., N): inverse, CRT, and the limbs recombined
    with wrapping shifts, exact mod 2^32."""
    res = ntt_inverse_stack(spec, n)                 # (P, 4, ..., N)
    parts = crt_to_int32(res[0], res[1], n)          # (4, ..., N)
    out = parts[0]
    for v in range(1, 4):
        out = out + (parts[v] << (8 * v))
    return out
