"""The blind rotation's two CUDA kernels: wrappers, plain twins, counts.

Each CMux step of :func:`ieache_tpu_torch.ops.blind_rotate.blind_rotate`
calls both, in the (k+1, B, N) accumulator layout:

* :func:`rot_diff_decompose` (``csrc/rot_diff_decompose.cu``) replaces
  ``rot_diff_decompose_pallas``: digits of X^bara·acc - acc;
* :func:`external_product` (``csrc/external_product.cu``) replaces
  ``external_product_pallas_t`` with the accumulator fused.

A wrapper checks device, dtype, shape, contiguity and alignment, then
launches its kernel when the tensors lie on a CUDA device, or runs its
plain twin (``*_plain``) when they lie on the CPU; it never falls back
from one to the other.  Each wrapper's ``launches`` attribute counts
its kernel launches (the plain twins count nothing).  Only the
single-limb gadget (``digit_limbs == 1``) is taken, as on the TPU.
"""

from __future__ import annotations

import torch

from ieache_tpu.params import TFHEParams
from ieache_tpu_torch.core.poly import TORUS_LIMBS
from ieache_tpu_torch.ops import _build
from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.ops.decompose import _offset


def _require_single_limb(params: TFHEParams) -> None:
    if params.digit_limbs != 1:
        raise ValueError(
            "the blind-rotation kernels require single-limb digits "
            f"(bg_bit <= 8); got bg_bit={params.bg_bit}"
        )


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device, align: int = 4) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.is_cuda and t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def _launch_context(t: torch.Tensor):
    """(kernel library, current stream) for a launch on ``t``'s device."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return _build.library(), torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# rotate + diff + decompose
# ---------------------------------------------------------------------------

def rot_diff_decompose_plain(acc: torch.Tensor, bara: torch.Tensor,
                             params: TFHEParams) -> torch.Tensor:
    """Plain twin: acc (k+1, B, N) int32, bara (B,) int32 -> digits of
    (X^bara·acc - acc) as (rows, B, N) int8, row p = u*l + j."""
    d = br._step_digits(acc.transpose(0, 1), bara, params)   # (B, rows, N)
    return d.transpose(0, 1).to(torch.int8).contiguous()


def rot_diff_decompose(acc: torch.Tensor, bara: torch.Tensor,
                       params: TFHEParams) -> torch.Tensor:
    """acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N) -> (rows, B, N)
    int8 digits; the kernel on CUDA tensors, the plain twin on CPU."""
    _require_single_limb(params)
    kp1, b, n = params.k + 1, bara.numel(), params.N
    _check(acc, "acc", torch.int32, (kp1, b, n), acc.device)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    if not acc.is_cuda:
        return rot_diff_decompose_plain(acc, bara, params)

    out = torch.empty((params.trgsw_rows, b, n), dtype=torch.int8,
                      device=acc.device)
    if b == 0:
        return out
    lib, stream = _launch_context(acc)
    code = lib.ieache_rot_diff_decompose(
        acc.data_ptr(), bara.data_ptr(), out.data_ptr(), kp1, b, n,
        params.bg_bit, params.l, _offset(params.bg_bit, params.l), stream,
    )
    _build.check(lib, code, "rot_diff_decompose")
    rot_diff_decompose.launches += 1
    return out


rot_diff_decompose.launches = 0


# ---------------------------------------------------------------------------
# external product, accumulator fused
# ---------------------------------------------------------------------------

def external_product_plain(d: torch.Tensor, bk_i: torch.Tensor,
                           params: TFHEParams,
                           acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin, the JAX package's XLA branch: Toeplitz limb operand
    (``make_step_gmatrix``) and four int8 limb products recombined with
    wrapping shifts.  d (rows, B, N) int8, bk_i (rows, k+1, N) int32,
    acc (k+1, B, N) int32 or None -> (k+1, B, N) int32."""
    g = br.make_step_gmatrix(bk_i, params)           # (L, rows, kp1, N, N)
    d8 = d.transpose(0, 1)                           # (B, rows, N)
    out = torch.zeros((d8.shape[0], params.k + 1, params.N),
                      dtype=torch.int32, device=d.device)
    for v in range(TORUS_LIMBS):
        out = out + (br._dot_digits_g(d8, g[v]) << (8 * v))
    out = out.transpose(0, 1)
    return (out if acc is None else acc + out).contiguous()


def external_product(d: torch.Tensor, bk_i: torch.Tensor, params: TFHEParams,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc + sum_p d[p] ⊛ bk_i[p, o], negacyclic, exact mod 2^32:
    d (rows, B, N) int8, bk_i (rows, k+1, N) int32, acc (k+1, B, N)
    int32 or None -> (k+1, B, N) int32; the kernel on CUDA tensors, the
    plain twin on CPU."""
    _require_single_limb(params)
    rows, kp1, n = params.trgsw_rows, params.k + 1, params.N
    b = d.shape[1] if d.dim() == 3 else -1
    _check(d, "d", torch.int8, (rows, b, n), d.device)
    _check(bk_i, "bk_i", torch.int32, (rows, kp1, n), d.device)
    if acc is not None:
        _check(acc, "acc", torch.int32, (kp1, b, n), d.device, align=16)
    if not d.is_cuda:
        return external_product_plain(d, bk_i, params, acc)

    if n % 8:
        raise ValueError(f"the external-product kernel needs N % 8 == 0, "
                         f"got N={n}")
    out = torch.empty((kp1, b, n), dtype=torch.int32, device=d.device)
    if b == 0:
        return out
    lib, stream = _launch_context(d)
    code = lib.ieache_external_product(
        d.data_ptr(), bk_i.data_ptr(),
        None if acc is None else acc.data_ptr(), out.data_ptr(),
        rows, kp1, b, n, stream,
    )
    _build.check(lib, code, "external_product")
    external_product.launches += 1
    return out


external_product.launches = 0
