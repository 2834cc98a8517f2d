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
import torch.distributed as dist

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


def make_step_gmatrix_local(bk_step: torch.Tensor, params: TFHEParams,
                            start: int, n_local: int) -> torch.Tensor:
    """Columns [start, start+n_local) of the step's Toeplitz operand,
    built without the full (N, 2N) rows: with ``T[m, j] = e[N + j - m]``
    the block reads only the window ``e[start+1 : start+N+n_local]``, so
    the transient is the (N, n_local) block itself (the sp-sharded
    bootstrap's memory, ÷sp of the full build).

    bk_step: int32 (rows, k+1, N) -> int8 (L, rows, k+1, N, n_local);
    equal to ``make_step_gmatrix(...)[..., start:start+n_local]``.
    Raises ``ValueError`` where ``n_local`` does not divide N.
    """
    n = params.N
    if n % n_local:
        raise ValueError(f"n_local={n_local} must divide N={n}")
    e = negacyclic_extend(bk_step)                     # (rows, k+1, 2N)
    ew = e[..., start + 1:start + n + n_local]         # (rows, k+1, N+nl-1)
    el = torch.movedim(split_i8_limbs(ew), -1, 0)      # (L, rows, k+1, ...)
    m = torch.arange(n, device=bk_step.device)
    j = torch.arange(n_local, device=bk_step.device)
    return el[..., (n - 1) + j[None, :] - m[:, None]]


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
    b, rows, m = d8.shape
    kp1, j = gv.shape[1], gv.shape[-1]
    g2 = gv.permute(0, 2, 1, 3).reshape(rows * m, kp1 * j)
    return _dot_i8(d8.reshape(b, rows * m), g2).reshape(b, kp1, j)


def _digit_products(d: torch.Tensor, g: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """Σ over rows and m of digits ``d`` (B, rows, m) against the limbs
    ``g`` (L, rows, kp1, m, j) of a Toeplitz operand: (B, kp1, j) int32,
    the limb products recombined with wrapping shifts.  The two-limb
    gadget's products at a shift of 32 or more vanish mod 2^32 and are
    dropped."""
    if params.digit_limbs == 1:
        terms = [(d.to(torch.int8), v, 8 * v) for v in range(TORUS_LIMBS)]
    else:
        dl = split_i8_limbs(d, params.digit_limbs)         # (B, rows, m, 2)
        terms = [(dl[..., u], v, 8 * u + 8 * v)
                 for u in range(params.digit_limbs)
                 for v in range(TORUS_LIMBS) if 8 * u + 8 * v < 32]
    return sum(_dot_digits_g(d8, g[v]) << sh for d8, v, sh in terms)


def external_product_step(
    acc: torch.Tensor, bara_i: torch.Tensor, bk_i: torch.Tensor,
    params: TFHEParams,
) -> torch.Tensor:
    """One CMux: acc + BK_i ⊡ (X^bara_i · acc - acc).  Exact mod 2^32."""
    d = _step_digits(acc, bara_i, params)                  # (B, rows, N)
    g = make_step_gmatrix(bk_i, params)                    # (L, rows, kp1, N, N)
    return acc + _digit_products(d, g, params)


def _tp_partial(acc: torch.Tensor, bara_i: torch.Tensor, g: torch.Tensor,
                rank: int, params: TFHEParams) -> torch.Tensor:
    """This tp rank's partial external product: the step's whole digits,
    computed on every rank, sliced to the rank's rows of ``g`` (the
    operand of its rows of the step's key)."""
    rows_local = g.shape[1]
    digits = _step_digits(acc, bara_i, params)             # (B, rows, N)
    d_local = digits[:, rank * rows_local:(rank + 1) * rows_local]
    return _digit_products(d_local, g, params)


def external_product_step_sharded(
    acc: torch.Tensor, bara_i: torch.Tensor, bk_i_local: torch.Tensor,
    params: TFHEParams, group,
) -> torch.Tensor:
    """Tensor-parallel CMux step, run by every rank of the tp ``group``.

    The TRGSW rows axis is sharded over the group: this rank holds
    ``bk_i_local`` (rows/tp, k+1, N), builds only its operand, contracts
    it against its rows of the digits, and the partial products are
    summed over the group by one ``all_reduce``; int32 sums wrap mod
    2^32, as the product's do.  ``acc`` is the same on every rank of the
    group.
    """
    g = make_step_gmatrix(bk_i_local, params)              # (L, r/tp, ...)
    out = _tp_partial(acc, bara_i, g, dist.get_rank(group), params)
    dist.all_reduce(out, group=group)
    return acc + out


def blind_rotate_sharded(
    acc0: torch.Tensor, bara: torch.Tensor, bk_local: torch.Tensor,
    params: TFHEParams, group, overlap_chunks: int = 2,
) -> torch.Tensor:
    """Blind rotation with the key's rows axis sharded over the tp
    ``group`` (:func:`external_product_step_sharded` at each step).

    ``overlap_chunks``: the all_reduce of a step lies on the rotation's
    serial path (decomposition is nonlinear, so it cannot be deferred).
    Where the batch splits into C equal chunks of at least two lanes
    (``b % C == 0 and b >= 2 * C``), each chunk's all_reduce is issued
    asynchronously as soon as its partial is ready and waited on only
    before that chunk's next step, so one chunk's products run while
    another's sum is in flight.  The arithmetic per lane is unchanged,
    so the result is the same for every C; with C = 1 each step waits on
    its one all_reduce before the next.
    """
    b = acc0.shape[0]
    nc = overlap_chunks
    if not (nc > 1 and b % nc == 0 and b >= 2 * nc):
        nc = 1
    rank = dist.get_rank(group)
    accs = list(acc0.split(b // nc))
    baras = list(bara.split(b // nc))
    pending = [None] * nc
    for i in range(bk_local.shape[0]):
        g = make_step_gmatrix(bk_local[i], params)
        for c in range(nc):
            if pending[c] is not None:
                work, out = pending[c]
                work.wait()
                accs[c] = accs[c] + out
            out = _tp_partial(accs[c], baras[c][:, i], g, rank, params)
            pending[c] = (dist.all_reduce(out, group=group, async_op=True),
                          out)
    for c, (work, out) in enumerate(pending):
        work.wait()
        accs[c] = accs[c] + out
    return torch.cat(accs)


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
