"""The port's CUDA kernels: wrappers, plain twins, counts.

:func:`ieache_tpu_torch.ops.blind_rotate.blind_rotate` runs its CMux
steps, in the (k+1, B, N) accumulator layout (``tr``: (k+1, N, B)),
through the kernels of the step mode ``IEACHE_PALLAS_STEP`` selects:

* ``split``: :func:`rot_diff_decompose` (``csrc/rot_diff_decompose.cu``,
  replaces ``rot_diff_decompose_pallas``), the digits of
  X^bara·acc - acc, then :func:`external_product`
  (``csrc/external_product.cu``, replaces ``external_product_pallas_t``)
  with the accumulator fused, on the int8 tensor cores
  (``csrc/mma_tile.cuh``; :func:`mma_planes`, :func:`mma_toeplitz_tile`
  and :func:`external_product_mma_model` are a plain model of that
  tile's operand construction, for the CPU tests);
* ``fused2``: :func:`cmux_step` (``csrc/cmux_step.cu``, replaces
  ``cmux_step_pallas``), the whole step in one kernel;
* ``overlap``/``overlap2``: :func:`cmux_step_overlap`
  (``csrc/cmux_step_overlap.cu``, replaces ``cmux_step_overlap_pallas``
  and ``cmux_step_overlap2_pallas``), the step with the next tile's
  decomposition overlapped;
* ``scan``: :func:`blind_rotate_scan` (``csrc/blind_rotate_scan.cu``,
  replaces ``blind_rotate_scan_pallas``), all n steps in one launch, its
  products on the same tensor-core tile;
* ``tr``: :func:`rot_diff_decompose_tr`
  (``csrc/rot_diff_decompose_tr.cu``, replaces
  ``rot_diff_decompose_pallas_tr``) then :func:`external_product_tr`
  (``csrc/external_product_tr.cu``, replaces
  ``external_product_pallas_tr``), the split pair in the transposed
  layout.

:func:`rotate_lane` and :func:`rotate_sublane` (``csrc/rotate_probe.cu``,
replacing the two inline kernels of ``tools/transposed_probe.py``) are
one negacyclic rotation in each layout, timed by
:mod:`ieache_tpu_torch.tools.transposed_probe`.

:func:`mm_s8` and :func:`mm_bf16` (``csrc/mm_probe.cu``, replacing the
inline kernel of ``tools/mosaic_mm_probe.py``) are a bare tensor-core
matrix product repeated g times into one accumulator, timed by
:mod:`ieache_tpu_torch.tools.mosaic_mm_probe`.

A wrapper checks device, dtype, shape, contiguity and alignment, then
launches its kernel when the tensors lie on a CUDA device, or runs its
plain twin (``*_plain``) when they lie on the CPU; it never falls back
from one to the other.  Each wrapper's ``launches`` attribute counts
its kernel launches (the plain twins count nothing).  Only the
single-limb gadget (``digit_limbs == 1``) is taken, as on the TPU.
"""

from __future__ import annotations

import torch

from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    _dot_i8,
    negacyclic_extend,
)
from ieache_tpu_torch.ops import _build
from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.ops.decompose import _offset
from ieache_tpu_torch.params import TFHEParams


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


def _rot_diff_decompose_launch(wrapper, entry: str, plain,
                               acc: torch.Tensor, bara: torch.Tensor,
                               params: TFHEParams, tr: bool) -> torch.Tensor:
    """Both rotation wrappers' body: the digits, (rows, N, B) when ``tr``
    else (rows, B, N), from the C entry point ``entry`` on CUDA tensors,
    counted on ``wrapper``, or from ``plain`` on CPU tensors."""
    _require_single_limb(params)
    kp1, b, n = params.k + 1, bara.numel(), params.N
    _check(acc, "acc", torch.int32, (kp1, n, b) if tr else (kp1, b, n),
           acc.device)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    if not acc.is_cuda:
        return plain(acc, bara, params)

    if n % 8:
        raise ValueError(f"the rotation kernels need N % 8 == 0, got N={n}")
    rows = params.trgsw_rows
    out = torch.empty((rows, n, b) if tr else (rows, b, n), dtype=torch.int8,
                      device=acc.device)
    if b == 0:
        return out
    lib, stream = _launch_context(acc)
    code = getattr(lib, entry)(
        acc.data_ptr(), bara.data_ptr(), out.data_ptr(), kp1, b, n,
        params.bg_bit, params.l, _offset(params.bg_bit, params.l), stream,
    )
    _build.check(lib, code, entry)
    wrapper.launches += 1
    return out


def rot_diff_decompose(acc: torch.Tensor, bara: torch.Tensor,
                       params: TFHEParams) -> torch.Tensor:
    """acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N) -> (rows, B, N)
    int8 digits; the kernel on CUDA tensors, the plain twin on CPU."""
    return _rot_diff_decompose_launch(
        rot_diff_decompose, "ieache_rot_diff_decompose",
        rot_diff_decompose_plain, acc, bara, params, tr=False)


rot_diff_decompose.launches = 0


# ---------------------------------------------------------------------------
# the tensor-core tile of csrc/mma_tile.cuh: its limits, and a plain model
# of how it builds and indexes its Toeplitz operand
# ---------------------------------------------------------------------------

#: the most coefficients (and digit columns a chunk) of a block's tile
MMA_TILE_COLS = 256

#: chunks of digit columns per build of the byte planes
MMA_SEG_CHUNKS = 4

#: the tile's limit on rows * N: below it each limb's s8 x s8 sum over all
#: rows * N terms (at most 2^14 each) is exact in int32
MMA_MAX_TERMS = 1 << 17


def mma_tile_check(rows: int, n: int) -> None:
    """Raise ``ValueError`` for a shape the tensor-core tile refuses: N
    must be a power of two of at least 64 and rows * N below
    :data:`MMA_MAX_TERMS`."""
    if n < 64 or n & (n - 1):
        raise ValueError(f"the tensor-core external product needs N a power "
                         f"of two >= 64, got N={n}")
    if rows * n >= MMA_MAX_TERMS:
        raise ValueError(
            f"the tensor-core external product needs rows * N < "
            f"{MMA_MAX_TERMS} (each int8 limb's sum must stay exact in "
            f"int32), got rows={rows}, N={n}")


def mma_limb_bytes(e: torch.Tensor) -> torch.Tensor:
    """The kernel's balanced limbs: int32 e -> int8 (..., 4), limb v the
    sign-extended byte v of ``(e + 0x80808080) ^ 0x80808080``."""
    bias = torch.tensor(0x80808080 - (1 << 32), dtype=torch.int32,
                        device=e.device)
    x = (e.to(torch.int32) + bias) ^ bias
    return torch.stack([(x << (24 - 8 * v)) >> 24 for v in range(TORUS_LIMBS)],
                       dim=-1).to(torch.int8)


def mma_planes(g: torch.Tensor, jb: int, ma: int, mcols: int) -> torch.Tensor:
    """``build_planes`` of the kernel for one key polynomial g (N,) int32,
    a tile whose first coefficient is ``jb`` and digit columns ``ma`` ..
    ``ma + mcols - 1``: int8 (4 limbs, 4 copies, T + mcols bytes), byte
    4x + q of copy s of limb v = limb v of e[i0 - s - q] with
    i0 = N - 1 + jb + T - ma - 4x, e = concat(-g, g) and e[i] = 0 for
    i < 0."""
    n = g.shape[-1]
    t = min(n, MMA_TILE_COLS)
    limbs = mma_limb_bytes(negacyclic_extend(g))           # (2N, 4)
    y = torch.arange(t + mcols, device=g.device)            # byte 4x + q
    s = torch.arange(4, device=g.device)[:, None]
    i = (n - 1 + jb + t - ma) - y[None, :] - s              # (4, bytes)
    picked = limbs[i.clamp(min=0)]                          # (4, bytes, 4)
    picked = torch.where((i >= 0)[..., None], picked,
                         torch.zeros_like(picked))
    return picked.permute(2, 0, 1).contiguous()


def mma_toeplitz_tile(planes: torch.Tensor, n: int, mcols: int) -> torch.Tensor:
    """The Toeplitz limb tile the kernel's MMAs see, gathered from
    :func:`mma_planes` through the kernel's fragment map: int8 (4 limbs,
    mcols, T), entry [v, ml, jl].  Thread (warp, lane = 4 grp + t4) reads,
    for its MMA tile ni, k-step kseg and half h, word
    ``(T - 8 NI warp) / 4 + t4 - 1 - grp // 4 + 2 (4 kseg - ni + 2 h)`` of
    copy ``3 - grp % 4``: its byte q is the operand at digit column
    ml = 32 kseg + 16 h + 4 t4 + q, coefficient jl = 8 NI warp + 8 ni +
    grp."""
    t = min(n, MMA_TILE_COLS)
    ni_count = t // 32
    dev = planes.device
    warp, ni, grp, kseg, h, t4, q = torch.meshgrid(
        torch.arange(4, device=dev), torch.arange(ni_count, device=dev),
        torch.arange(8, device=dev), torch.arange(mcols // 32, device=dev),
        torch.arange(2, device=dev), torch.arange(4, device=dev),
        torch.arange(4, device=dev), indexing="ij")
    word = ((t - 8 * ni_count * warp) // 4 + t4 - 1 - grp // 4
            + 2 * (4 * kseg - ni + 2 * h))
    copy = 3 - grp % 4
    ml = 32 * kseg + 16 * h + 4 * t4 + q
    jl = 8 * ni_count * warp + 8 * ni + grp
    tile = torch.zeros((TORUS_LIMBS, mcols, t), dtype=torch.int8, device=dev)
    tile[:, ml.reshape(-1), jl.reshape(-1)] = \
        planes[:, copy.reshape(-1), (4 * word + q).reshape(-1)]
    return tile


def external_product_mma_model(d: torch.Tensor, bk_i: torch.Tensor,
                               params: TFHEParams,
                               acc: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The kernel's arithmetic in plain ops, tile by tile: the planes of
    each (p, o) key polynomial per segment of up to
    :data:`MMA_SEG_CHUNKS` chunks, the Toeplitz limb tiles from the
    fragment map, one int32 sum per limb over all rows and digit columns,
    folded once as sum_v S_v << 8v (wrapping).  Same arguments and result
    as :func:`external_product_plain`."""
    rows, kp1, n = bk_i.shape
    mma_tile_check(rows, n)
    t = min(n, MMA_TILE_COLS)
    seg = min(n, MMA_SEG_CHUNKS * t)
    d32 = d.to(torch.int32)
    out = torch.zeros((kp1, d.shape[1], n), dtype=torch.int32,
                      device=d.device)
    for o in range(kp1):
        for jb in range(0, n, t):
            sums = torch.zeros((TORUS_LIMBS, d.shape[1], t),
                               dtype=torch.int32, device=d.device)
            for p in range(rows):
                for ma in range(0, n, seg):
                    tile = mma_toeplitz_tile(
                        mma_planes(bk_i[p, o], jb, ma, seg), n, seg)
                    sums += torch.einsum(
                        "bm,vmj->vbj", d32[p, :, ma:ma + seg],
                        tile.to(torch.int32))
            for v in range(TORUS_LIMBS):
                out[o, :, jb:jb + t] += sums[v] << (8 * v)
    return out if acc is None else acc + out


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


def _external_product_launch(wrapper, entry: str, plain, d: torch.Tensor,
                             bk_i: torch.Tensor, params: TFHEParams,
                             acc: torch.Tensor | None,
                             tr: bool) -> torch.Tensor:
    """Both external-product wrappers' body, in the (k+1, N, B) layout
    when ``tr`` else (k+1, B, N): the C entry point ``entry`` on CUDA
    tensors, counted on ``wrapper``, or ``plain`` on CPU tensors."""
    _require_single_limb(params)
    rows, kp1, n = params.trgsw_rows, params.k + 1, params.N
    b = d.shape[2 if tr else 1] if d.dim() == 3 else -1
    shape = (n, b) if tr else (b, n)
    # both stagings read 16-byte pieces of the digits
    _check(d, "d", torch.int8, (rows, *shape), d.device, align=16)
    _check(bk_i, "bk_i", torch.int32, (rows, kp1, n), d.device)
    if acc is not None:
        _check(acc, "acc", torch.int32, (kp1, *shape), d.device, align=16)
    if not d.is_cuda:
        return plain(d, bk_i, params, acc)

    if tr and n % 8:
        raise ValueError(f"the transposed external-product kernel needs "
                         f"N % 8 == 0, got N={n}")
    if not tr:
        mma_tile_check(rows, n)
    out = torch.empty((kp1, *shape), dtype=torch.int32, device=d.device)
    if b == 0:
        return out
    lib, stream = _launch_context(d)
    code = getattr(lib, entry)(
        d.data_ptr(), bk_i.data_ptr(),
        None if acc is None else acc.data_ptr(), out.data_ptr(),
        rows, kp1, b, n, stream,
    )
    _build.check(lib, code, entry)
    wrapper.launches += 1
    return out


def external_product(d: torch.Tensor, bk_i: torch.Tensor, params: TFHEParams,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc + sum_p d[p] ⊛ bk_i[p, o], negacyclic, exact mod 2^32:
    d (rows, B, N) int8, bk_i (rows, k+1, N) int32, acc (k+1, B, N)
    int32 or None -> (k+1, B, N) int32; the kernel on CUDA tensors (which
    raises ``ValueError`` for a shape :func:`mma_tile_check` refuses),
    the plain twin on CPU."""
    return _external_product_launch(
        external_product, "ieache_external_product", external_product_plain,
        d, bk_i, params, acc, tr=False)


external_product.launches = 0


# ---------------------------------------------------------------------------
# the whole CMux step: fused2 and overlap
# ---------------------------------------------------------------------------

def cmux_step_plain(acc: torch.Tensor, bara: torch.Tensor,
                    bk_i: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Plain twin of both step kernels: :func:`rot_diff_decompose_plain`
    then :func:`external_product_plain` with the accumulator fused."""
    d = rot_diff_decompose_plain(acc, bara, params)
    return external_product_plain(d, bk_i, params, acc)


def _cmux_step_launch(wrapper, entry: str, acc: torch.Tensor,
                      bara: torch.Tensor, bk_i: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """Both step kernels' wrapper body: the new accumulator from the C
    entry point ``entry`` on CUDA tensors, counted on ``wrapper``, or
    from the plain twin on CPU tensors."""
    _require_single_limb(params)
    rows, kp1, b, n = params.trgsw_rows, params.k + 1, bara.numel(), params.N
    _check(acc, "acc", torch.int32, (kp1, b, n), acc.device, align=16)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    _check(bk_i, "bk_i", torch.int32, (rows, kp1, n), acc.device)
    if not acc.is_cuda:
        return cmux_step_plain(acc, bara, bk_i, params)

    if n % 8:
        raise ValueError(f"the CMux step kernels need N % 8 == 0, got N={n}")
    out = torch.empty_like(acc)
    if b == 0:
        return out
    lib, stream = _launch_context(acc)
    code = getattr(lib, entry)(
        acc.data_ptr(), bara.data_ptr(), bk_i.data_ptr(), out.data_ptr(),
        rows, kp1, b, n, params.bg_bit, params.l,
        _offset(params.bg_bit, params.l), stream,
    )
    _build.check(lib, code, entry)
    wrapper.launches += 1
    return out


def cmux_step(acc: torch.Tensor, bara: torch.Tensor, bk_i: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """One CMux step, acc + BK_i ⊡ (X^bara·acc - acc), as one kernel
    (``fused2``): acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N),
    bk_i (rows, k+1, N) int32 -> (k+1, B, N) int32, exact mod 2^32."""
    return _cmux_step_launch(cmux_step, "ieache_cmux_step", acc, bara,
                             bk_i, params)


cmux_step.launches = 0


def cmux_step_overlap(acc: torch.Tensor, bara: torch.Tensor,
                      bk_i: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """:func:`cmux_step` with the next tile's rotate + decompose
    overlapped with this tile's product (``overlap``/``overlap2``);
    same arguments and result, bit for bit."""
    return _cmux_step_launch(cmux_step_overlap, "ieache_cmux_step_overlap",
                             acc, bara, bk_i, params)


cmux_step_overlap.launches = 0

#: the overlap kernel computes what cmux_step does, so shares its twin
cmux_step_overlap_plain = cmux_step_plain


# ---------------------------------------------------------------------------
# the whole blind rotation: scan
# ---------------------------------------------------------------------------

def blind_rotate_scan_plain(acc: torch.Tensor, bara: torch.Tensor,
                            bk: torch.Tensor,
                            params: TFHEParams) -> torch.Tensor:
    """Plain twin: :func:`cmux_step_plain` looped over the n steps."""
    for i in range(bk.shape[0]):
        acc = cmux_step_plain(acc, bara[:, i].contiguous(), bk[i], params)
    return acc


def blind_rotate_scan(acc: torch.Tensor, bara: torch.Tensor, bk: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """All n CMux steps in one launch: acc (k+1, B, N) int32, bara
    (B, n) int32 in [0, 2N), bk (n, rows, k+1, N) int32 -> the rotated
    (k+1, B, N) int32 accumulator, exact mod 2^32; the kernel on CUDA
    tensors (which raises ``ValueError`` for a shape
    :func:`mma_tile_check` refuses), the plain twin on CPU."""
    _require_single_limb(params)
    rows, kp1, n = params.trgsw_rows, params.k + 1, params.N
    b = acc.shape[1] if acc.dim() == 3 else -1
    steps = bk.shape[0] if bk.dim() == 4 else -1
    _check(acc, "acc", torch.int32, (kp1, b, n), acc.device, align=16)
    _check(bara, "bara", torch.int32, (b, steps), acc.device)
    _check(bk, "bk", torch.int32, (steps, rows, kp1, n), acc.device)
    if not acc.is_cuda:
        return blind_rotate_scan_plain(acc, bara, bk, params)

    mma_tile_check(rows, n)
    if b == 0 or steps == 0:
        return acc.clone()
    out = torch.empty_like(acc)
    scratch = torch.empty_like(acc)
    digits = torch.empty((rows, b, n), dtype=torch.int8, device=acc.device)
    lib, stream = _launch_context(acc)
    code = lib.ieache_blind_rotate_scan(
        acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), digits.data_ptr(), rows, kp1, b, n, steps,
        params.bg_bit, params.l, _offset(params.bg_bit, params.l), stream,
    )
    _build.check(lib, code, "blind_rotate_scan")
    blind_rotate_scan.launches += 1
    return out


blind_rotate_scan.launches = 0


# ---------------------------------------------------------------------------
# tr: the split pair in the transposed (k+1, N, B) layout
# ---------------------------------------------------------------------------

def rot_diff_decompose_tr_plain(acc: torch.Tensor, bara: torch.Tensor,
                                params: TFHEParams) -> torch.Tensor:
    """Plain twin: :func:`rot_diff_decompose_plain` with its operands
    transposed; acc (k+1, N, B) int32, bara (B,) int32 -> (rows, N, B)
    int8."""
    d = rot_diff_decompose_plain(acc.transpose(1, 2), bara, params)
    return d.transpose(1, 2).contiguous()


def rot_diff_decompose_tr(acc: torch.Tensor, bara: torch.Tensor,
                          params: TFHEParams) -> torch.Tensor:
    """acc (k+1, N, B) int32, bara (B,) int32 in [0, 2N) -> (rows, N, B)
    int8 digits of X^bara·acc - acc; the kernel on CUDA tensors, the
    plain twin on CPU."""
    return _rot_diff_decompose_launch(
        rot_diff_decompose_tr, "ieache_rot_diff_decompose_tr",
        rot_diff_decompose_tr_plain, acc, bara, params, tr=True)


rot_diff_decompose_tr.launches = 0


def external_product_tr_plain(d: torch.Tensor, bk_i: torch.Tensor,
                              params: TFHEParams,
                              acc: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain twin: :func:`external_product_plain` with its operands
    transposed; d (rows, N, B) int8, bk_i (rows, k+1, N) int32, acc
    (k+1, N, B) int32 or None -> (k+1, N, B) int32."""
    out = external_product_plain(
        d.transpose(1, 2), bk_i, params,
        None if acc is None else acc.transpose(1, 2))
    return out.transpose(1, 2).contiguous()


def external_product_tr(d: torch.Tensor, bk_i: torch.Tensor,
                        params: TFHEParams,
                        acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc + sum_p d[p] ⊛ bk_i[p, o] in the transposed layout, exact mod
    2^32: d (rows, N, B) int8, bk_i (rows, k+1, N) int32, acc (k+1, N, B)
    int32 or None -> (k+1, N, B) int32; the kernel on CUDA tensors, the
    plain twin on CPU."""
    return _external_product_launch(
        external_product_tr, "ieache_external_product_tr",
        external_product_tr_plain, d, bk_i, params, acc, tr=True)


external_product_tr.launches = 0


# ---------------------------------------------------------------------------
# the rotation probe: X^bara·acc in each layout
# ---------------------------------------------------------------------------

def rotate_lane_plain(acc: torch.Tensor, bara: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``negacyclic_rotate_batch`` on acc (k+1, B, N)."""
    return br.negacyclic_rotate_batch(acc.transpose(0, 1), bara) \
        .transpose(0, 1).contiguous()


def rotate_sublane_plain(acc: torch.Tensor,
                         bara: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``negacyclic_rotate_batch`` on acc (k+1, N, B)."""
    return rotate_lane_plain(acc.transpose(1, 2), bara) \
        .transpose(1, 2).contiguous()


def _rotate_launch(wrapper, entry: str, plain, acc: torch.Tensor,
                   bara: torch.Tensor, lanes_last: bool) -> torch.Tensor:
    """Both rotation wrappers' body: acc (k+1, B, N), or (k+1, N, B)
    when ``lanes_last``, rotated by bara (B,) int32 in [0, 2N)."""
    kp1 = acc.shape[0] if acc.dim() == 3 else -1
    b = bara.numel()
    n = acc.shape[1 if lanes_last else 2] if acc.dim() == 3 else -1
    shape = (kp1, n, b) if lanes_last else (kp1, b, n)
    _check(acc, "acc", torch.int32, shape, acc.device)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    if n & (n - 1) or n < 8:
        raise ValueError(f"N must be a power of two >= 8, got {n}")
    if not acc.is_cuda:
        return plain(acc, bara)

    out = torch.empty_like(acc)
    if b == 0 or kp1 == 0:
        return out
    lib, stream = _launch_context(acc)
    code = getattr(lib, entry)(acc.data_ptr(), bara.data_ptr(),
                               out.data_ptr(), kp1, b, n, stream)
    _build.check(lib, code, entry)
    wrapper.launches += 1
    return out


def rotate_lane(acc: torch.Tensor, bara: torch.Tensor) -> torch.Tensor:
    """X^bara·acc, acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N) ->
    (k+1, B, N); the kernel on CUDA tensors, the plain twin on CPU."""
    return _rotate_launch(rotate_lane, "ieache_rotate_lane",
                          rotate_lane_plain, acc, bara, lanes_last=False)


rotate_lane.launches = 0


def rotate_sublane(acc: torch.Tensor, bara: torch.Tensor) -> torch.Tensor:
    """X^bara·acc, acc (k+1, N, B) int32, bara (B,) int32 in [0, 2N) ->
    (k+1, N, B); the kernel on CUDA tensors, the plain twin on CPU."""
    return _rotate_launch(rotate_sublane, "ieache_rotate_sublane",
                          rotate_sublane_plain, acc, bara, lanes_last=True)


rotate_sublane.launches = 0


# ---------------------------------------------------------------------------
# the matmul-rate probe: g products A @ B summed on the tensor cores
# ---------------------------------------------------------------------------

#: the probe kernels' tile: m, k and n must be multiples of it
MM_TILE = 128


def mm_s8_plain(a: torch.Tensor, b: torch.Tensor, g: int) -> torch.Tensor:
    """Plain twin: ``o = 0; g times: o += a @ b`` in wrapping int32 (one
    product is exact in int32 for k < 2^17; the sum of g wraps mod 2^32
    as the kernel's accumulator does)."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for _ in range(g):
        out += _dot_i8(a, b)
    return out


def mm_bf16_plain(a: torch.Tensor, b: torch.Tensor, g: int) -> torch.Tensor:
    """Plain twin: ``o = 0; g times: o += a @ b`` in float32 (bf16
    products are exact in float32; the sum's order differs from the
    kernel's, so the two agree within a tolerance, not bit for bit)."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for _ in range(g):
        out += a32 @ b32
    return out


def _mm_launch(wrapper, entry: str, plain, in_dtype: torch.dtype,
               out_dtype: torch.dtype, a: torch.Tensor, b: torch.Tensor,
               g: int) -> torch.Tensor:
    """Both probe wrappers' body: a (m, k), b (k, n) of ``in_dtype``
    -> the sum of g products as ``out_dtype`` (m, n), from the C entry
    point ``entry`` on CUDA tensors, counted on ``wrapper``, or from
    ``plain`` on CPU tensors."""
    m, k = a.shape if a.dim() == 2 else (-1, -1)
    n = b.shape[1] if b.dim() == 2 else -1
    _check(a, "a", in_dtype, (m, k), a.device, align=16)
    _check(b, "b", in_dtype, (k, n), a.device, align=16)
    if min(m, k, n) < MM_TILE or any(x % MM_TILE for x in (m, k, n)):
        raise ValueError(f"m, k, n must be positive multiples of {MM_TILE}, "
                         f"got {(m, k, n)}")
    if g < 1 or g * k >= 2**31:
        raise ValueError(f"g must be in [1, 2^31 / k), got {g}")
    if not a.is_cuda:
        return plain(a, b, g)

    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    bt = torch.empty((n, k), dtype=in_dtype, device=a.device)   # scratch
    lib, stream = _launch_context(a)
    code = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), bt.data_ptr(),
                               out.data_ptr(), m, k, n, g, stream)
    _build.check(lib, code, entry)
    wrapper.launches += 1
    return out


def mm_s8(a: torch.Tensor, b: torch.Tensor, g: int = 1) -> torch.Tensor:
    """The sum of g products a @ b, a (m, k) int8, b (k, n) int8 ->
    (m, n) int32, wrapping mod 2^32, on the int8 tensor cores; the
    kernel on CUDA tensors, the plain twin on CPU.  m, k, n multiples of
    128."""
    return _mm_launch(mm_s8, "ieache_mm_s8", mm_s8_plain, torch.int8,
                      torch.int32, a, b, g)


mm_s8.launches = 0


def mm_bf16(a: torch.Tensor, b: torch.Tensor, g: int = 1) -> torch.Tensor:
    """The sum of g products a @ b, a (m, k) bf16, b (k, n) bf16 ->
    (m, n) float32 accumulated in float32 on the bf16 tensor cores; the
    kernel on CUDA tensors, the plain twin on CPU.  m, k, n multiples of
    128."""
    return _mm_launch(mm_bf16, "ieache_mm_bf16", mm_bf16_plain,
                      torch.bfloat16, torch.float32, a, b, g)


mm_bf16.launches = 0
