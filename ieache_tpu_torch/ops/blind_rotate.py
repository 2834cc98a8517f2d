"""Blind rotation — the hot core of TFHE gate bootstrapping.

Counterpart of :mod:`ieache_tpu.ops.blind_rotate`.  One CMux step per
LWE mask coefficient:

    acc <- acc + BK_i ⊡ (X^bara_i · acc - acc)

:func:`blind_rotate` reads two variables at each call, as the JAX
package reads them.  ``IEACHE_PALLAS_STEP`` names the step mode
(:func:`step_mode`); with the single-limb gadget (``digit_limbs == 1``)
each mode runs the n steps through its own kernels:

* ``split`` (the default, also for ``auto`` or unset): per step,
  :func:`~ieache_tpu_torch.ops.kernels.rot_diff_decompose` then
  :func:`~ieache_tpu_torch.ops.kernels.external_product`, in the
  (k+1, B, N) layout;
* ``fused2``: per step, :func:`~ieache_tpu_torch.ops.kernels.cmux_step`;
* ``overlap`` and ``overlap2``: per step,
  :func:`~ieache_tpu_torch.ops.kernels.cmux_step_overlap`;
* ``scan``: all steps in one call of
  :func:`~ieache_tpu_torch.ops.kernels.blind_rotate_scan`;
* ``tr``: per step,
  :func:`~ieache_tpu_torch.ops.kernels.rot_diff_decompose_tr` then
  :func:`~ieache_tpu_torch.ops.kernels.external_product_tr`, in the
  transposed (k+1, N, B) layout, batch innermost;
* ``ntt``: the CRT-NTT external product of
  :mod:`ieache_tpu_torch.core.ntt`, plain PyTorch ops (the JAX package
  leaves it to XLA), bit-identical to the others.  It is chosen before
  ``IEACHE_PALLAS`` is read, as in the JAX package.

``IEACHE_PALLAS`` (:func:`pallas_route`) then says what runs the
kernel modes:

* ``auto`` or unset: the wrappers launch the CUDA kernels for CUDA
  tensors and run their plain twins for CPU tensors;
* ``0``: the per-step plain path, :func:`external_product_step`, on
  any device (the JAX package's XLA step);
* ``interpret``: the selected mode's plain twins (``kernels.*_plain``)
  on the tensors' own device, CUDA included, launching nothing (the
  counterpart of the Pallas interpreter);
* ``1``: the kernels; CPU tensors raise, since no kernel runs there.

Every route and mode returns the same arrays, for any batch.  Where
the mode's kernels refuse the parameter set's shape
(:func:`~ieache_tpu_torch.ops.kernels.kernels_take`: a ring degree
below 64 under every kernel mode, all on the tensor-core tile), ``auto``
and ``interpret`` take :func:`external_product_step`, as the JAX package
takes its XLA step where its kernels cannot run, and ``1`` raises.  The
two-limb compat gadget has no kernel, as on the TPU: it takes
:func:`external_product_step`, the plain form of the JAX package's XLA
branch (Toeplitz operand + int8 limb products), on any device, as does
``plain=True`` whatever the mode: the reference the kernel paths are
compared with.  Under ``ntt`` the compat gadget warns, as in the JAX
package, before it takes that step.
"""

from __future__ import annotations

import os
import warnings

import torch

from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    _dot_i8,
    negacyclic_extend,
    split_i8_limbs,
    toeplitz_index,
)
from ieache_tpu_torch.ops.decompose import gadget_decompose
from ieache_tpu_torch.params import TFHEParams


def make_step_gmatrix(bk_step: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """TRGSW step -> negacyclic matmul operand (Toeplitz tensor).

    bk_step: int32 (rows, k+1, N) -> int8 (TORUS_LIMBS, rows, k+1, N, N)
    with G[v, p, o, m, j] = limb_v( e_{p,o}[N + j - m] ), e = concat(-g, g).
    """
    e = negacyclic_extend(bk_step)                     # (rows, k+1, 2N)
    el = torch.movedim(split_i8_limbs(e), -1, 0)       # (L, rows, k+1, 2N)
    return el[..., toeplitz_index(params.N, bk_step.device)]


def negacyclic_rotate_batch(acc: torch.Tensor,
                            amount: torch.Tensor) -> torch.Tensor:
    """X^amount · acc for per-batch amounts in [0, 2N).

    acc: (B, k+1, N) int32; amount: (B,) int32 -> (B, k+1, N).
    Coefficient j of X^a·c is c_i with i = (j - a) mod 2N when i < N,
    else -c_{i-N}: one gather from concat(c, -c).
    """
    b, kp1, n = acc.shape
    ext = torch.cat([acc, -acc], dim=-1)               # (B, k+1, 2N)
    j = torch.arange(n, device=acc.device)
    idx = (j[None, :] - amount.to(torch.int64)[:, None]) % (2 * n)
    return torch.gather(ext, 2, idx[:, None, :].expand(b, kp1, n))


def _step_digits(acc: torch.Tensor, bara_i: torch.Tensor,
                 params: TFHEParams) -> torch.Tensor:
    """Digits of (X^bara·acc - acc): int32 (B, rows, N)."""
    b = acc.shape[0]
    diff = negacyclic_rotate_batch(acc, bara_i) - acc      # (B, k+1, N)
    digits = gadget_decompose(diff, params.bg_bit, params.l)
    # (B, k+1, N, l) -> (B, k+1, l, N): row p = u*l + j matches BK layout
    digits = torch.movedim(digits, -1, 2)
    return digits.reshape(b, params.trgsw_rows, params.N)


def _dot_digits_g(d8: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """(B, rows, m) x (rows, kp1, m, j) -> (B, kp1, j), s8 x s8 -> s32."""
    b, rows, n = d8.shape
    kp1 = gv.shape[1]
    g2 = gv.permute(0, 2, 1, 3).reshape(rows * n, kp1 * n)
    return _dot_i8(d8.reshape(b, rows * n), g2).reshape(b, kp1, n)


def external_product_step(
    acc: torch.Tensor, bara_i: torch.Tensor, bk_i: torch.Tensor,
    params: TFHEParams,
) -> torch.Tensor:
    """One CMux: acc + BK_i ⊡ (X^bara_i · acc - acc).  Exact mod 2^32."""
    d = _step_digits(acc, bara_i, params)                  # (B, rows, N)
    g = make_step_gmatrix(bk_i, params)                    # (L, rows, kp1, N, N)

    out = torch.zeros_like(acc)
    if params.digit_limbs == 1:
        d8 = d.to(torch.int8)
        for v in range(TORUS_LIMBS):
            out = out + (_dot_digits_g(d8, g[v]) << (8 * v))
    else:
        dl = split_i8_limbs(d, params.digit_limbs)         # (B, rows, N, 2)
        for u in range(params.digit_limbs):
            for v in range(TORUS_LIMBS):
                sh = 8 * u + 8 * v
                if sh >= 32:
                    continue
                out = out + (_dot_digits_g(dl[..., u], g[v]) << sh)
    return acc + out


#: the step modes the port runs
STEP_MODES = ("split", "fused2", "overlap", "overlap2", "scan", "tr", "ntt")

#: the values of ``IEACHE_PALLAS``
PALLAS_ROUTES = ("auto", "0", "1", "interpret")


def step_mode() -> str:
    """The step mode ``IEACHE_PALLAS_STEP`` selects: ``auto`` or unset
    is ``split``; a name outside :data:`STEP_MODES` raises
    ``ValueError``."""
    mode = os.environ.get("IEACHE_PALLAS_STEP", "auto")
    if mode == "auto":
        return "split"
    if mode not in STEP_MODES:
        raise ValueError(f"IEACHE_PALLAS_STEP={mode!r}: expected auto or "
                         f"one of {', '.join(STEP_MODES)}")
    return mode


def pallas_route() -> str:
    """What ``IEACHE_PALLAS`` asks to run the kernel modes: ``auto``
    (also unset), ``0``, ``1`` or ``interpret``; any other value raises
    ``ValueError``."""
    route = os.environ.get("IEACHE_PALLAS", "auto")
    if route not in PALLAS_ROUTES:
        raise ValueError(f"IEACHE_PALLAS={route!r}: expected one of "
                         f"{', '.join(PALLAS_ROUTES)}")
    return route


def _blind_rotate_ntt(acc0: torch.Tensor, bara: torch.Tensor,
                      bk: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Blind rotation with the CRT-NTT external product (``ntt``).

    The key's spectra are computed once per call, int32 (P=2, 4 limbs,
    n, rows, k+1, N): 131 MB at IEACHE_110_FAST.  Each step transforms
    only the digits, sums the rows in the spectral domain, inverts and
    CRT-recombines the four byte-limb convolutions, exact mod 2^32.
    Range: |sum over rows*N of d*s_v| <= rows * N * 2^(bg_bit-1) * 128
    must stay below P/2 (rows <= 6 at N=1024, bg_bit=8)."""
    from ieache_tpu_torch.core import ntt

    n = params.N
    bound = params.trgsw_rows * n * (1 << (params.bg_bit - 1)) * 128
    if bound >= (ntt.PRIMES[0] * ntt.PRIMES[1]) // 2:
        raise ValueError(
            f"CRT-NTT range exceeded: rows*N*2^(bg_bit-1)*128 = {bound}"
            f" >= P/2 = {(ntt.PRIMES[0] * ntt.PRIMES[1]) // 2}; the"
            " two-prime byte-limb path needs rows <= 6 at N=1024,"
            " bg_bit=8; use another step mode for wider gadgets")
    bkhat = ntt.ntt_forward_torus_limbs(bk, n)   # (P, 4, steps, rows, kp1, N)
    p, pinv = ntt.prime_constants(n, acc0.device, 6)
    acc = acc0
    for i in range(bk.shape[0]):
        digits = _step_digits(acc, bara[:, i], params)     # (B, rows, N)
        dh = ntt.ntt_forward_digits(digits, n)             # (P, B, rows, N)
        prod = ntt._mont_mul(dh[:, None, :, :, None, :],
                             bkhat[:, :, i, None], p, pinv)
        # (P, 4, B, rows, kp1, N): sum the rows, reduced once (< rows*p)
        spec = prod.sum(dim=3, dtype=torch.int32) % p[..., 0]
        acc = acc + ntt.limb_products_to_int32(spec, n)
    return acc


def blind_rotate(
    acc0: torch.Tensor, bara: torch.Tensor, bk: torch.Tensor,
    params: TFHEParams, plain: bool = False,
) -> torch.Tensor:
    """Full blind rotation over all n LWE coefficients.

    acc0: (B, k+1, N) int32 — rotated test-vector accumulator.
    bara: (B, n) int32 in [0, 2N) — mod-switched mask coefficients.
    bk:   (n, rows, k+1, N) int32 — bootstrapping key.
    """
    if not plain:
        mode, route = step_mode(), pallas_route()
        if mode == "ntt":
            if params.digit_limbs == 1:
                return _blind_rotate_ntt(acc0, bara, bk, params)
            warnings.warn(
                f"IEACHE_PALLAS_STEP=ntt needs digit_limbs == 1 (got "
                f"{params.digit_limbs}); taking the plain step",
                stacklevel=2)
        plain = mode == "ntt" or route == "0" or params.digit_limbs != 1
    if not plain:
        # kernels.py builds its plain twins from this module's functions
        from ieache_tpu_torch.ops import kernels

        why = kernels.kernels_refusal(mode, params.trgsw_rows, params.N)
        if why is not None:
            if route == "1":
                raise ValueError(f"IEACHE_PALLAS=1 asks for the kernels of "
                                 f"{mode}, which refuse this shape: {why}")
            plain = True
    if plain:
        acc = acc0
        for i in range(bk.shape[0]):
            acc = external_product_step(acc, bara[:, i], bk[i], params)
        return acc
    if route == "1" and not acc0.is_cuda:
        raise RuntimeError(
            f"IEACHE_PALLAS=1 asks for the CUDA kernels, but the tensors "
            f"are on {acc0.device}, where no kernel runs")

    def pick(name):
        """The wrapper ``name``, or its plain twin under interpret."""
        return getattr(kernels, name + "_plain" if route == "interpret"
                       else name)

    # (k+1, N, B) under tr, else (k+1, B, N); and back at exit
    layout, back = ((1, 2, 0), (2, 0, 1)) if mode == "tr" else ((1, 0, 2),) * 2
    acc_t = acc0.permute(*layout).contiguous()
    if mode == "scan":
        acc_t = pick("blind_rotate_scan")(acc_t, bara.contiguous(), bk,
                                          params)
        return acc_t.permute(*back).contiguous()

    bara_t = bara.t().contiguous()                         # (n, B)
    if mode in ("split", "tr"):
        suffix = "_tr" if mode == "tr" else ""
        rot = pick("rot_diff_decompose" + suffix)
        ext = pick("external_product" + suffix)
        for i in range(bk.shape[0]):
            acc_t = ext(rot(acc_t, bara_t[i], params), bk[i], params,
                        acc=acc_t)
    else:
        step = pick("cmux_step" if mode == "fused2" else "cmux_step_overlap")
        for i in range(bk.shape[0]):
            acc_t = step(acc_t, bara_t[i], bk[i], params)
    return acc_t.permute(*back).contiguous()
