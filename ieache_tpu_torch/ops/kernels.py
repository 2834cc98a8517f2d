"""The port's CUDA kernels: wrappers, plain twins, counts.

:func:`ieache_tpu_torch.ops.blind_rotate.blind_rotate` runs its CMux
steps, in the (k+1, B, N) accumulator layout (``tr``: (k+1, N, B)),
through the kernels of the step mode ``IEACHE_PALLAS_STEP`` selects:

* ``split``: :func:`rot_diff_decompose` (``csrc/rot_diff_decompose.cu``,
  replaces ``rot_diff_decompose_pallas``), the digits of
  X^bara·acc - acc, a run of coefficients a thread from aligned 16-byte
  loads, launched as :func:`rot_launch` says
  (:func:`rot_diff_decompose_run_model` is its plain model), then
  :func:`external_product`
  (``csrc/external_product.cu``, replaces ``external_product_pallas_t``)
  with the accumulator fused, on the int8 tensor cores
  (``csrc/mma_tile.cuh``; :func:`mma_planes`, :func:`mma_toeplitz_tile`
  and :func:`external_product_mma_model` are a plain model of that
  tile's operand construction, for the CPU tests);
* ``fused2``: :func:`cmux_step` (``csrc/cmux_step.cu``, replaces
  ``cmux_step_pallas``), the whole step in one kernel: the same
  tensor-core tile fed from digits the block decomposes into its own
  shared memory (:func:`cmux_digit_tile`, :func:`cmux_part_ranges` and
  :func:`cmux_step_mma_model` are the plain model of that);
* ``overlap``/``overlap2``: :func:`cmux_step_overlap`
  (``csrc/cmux_step_overlap.cu``, replaces ``cmux_step_overlap_pallas``
  and ``cmux_step_overlap2_pallas``), the step with the next batch rows'
  decomposition overlapped (:func:`step_work_items` and
  :func:`cmux_step_overlap_mma_model` model its order of work);
* ``scan``: :func:`blind_rotate_scan` (``csrc/blind_rotate_scan.cu``,
  replaces ``blind_rotate_scan_pallas``), all n steps in one launch, its
  products on the same tensor-core tile;
* ``tr``: :func:`rot_diff_decompose_tr`
  (``csrc/rot_diff_decompose_tr.cu``, replaces
  ``rot_diff_decompose_pallas_tr``) then :func:`external_product_tr`
  (``csrc/external_product_tr.cu``, replaces
  ``external_product_pallas_tr``), the split pair in the transposed
  layout: the rotation through a shared-memory slab of 16 batch lanes
  (``csrc/rot_slab.cuh``), or a gather at small batches, as
  :func:`rot_tr_route` says (:func:`rot_diff_decompose_tr_slab_model`,
  :func:`rot_tr_slab_banks`),
  the product on the same tensor-core tile with the Toeplitz tile as the
  MMA's A operand and the digits staged through a transpose
  (:func:`mma_toeplitz_tile_a`, :func:`tr_stage_model`,
  :func:`external_product_tr_mma_model`).

:func:`rotate_lane` and :func:`rotate_sublane` (``csrc/rotate_probe.cu``,
replacing the two inline kernels of ``tools/transposed_probe.py``) are
one negacyclic rotation in each layout, timed by
:mod:`ieache_tpu_torch.tools.transposed_probe`; the sublane kernel runs
on the tr rotation's slab or gather, by the same :func:`rot_tr_route`
(:func:`rot_tr_slab_model`).

:func:`mm_s8` and :func:`mm_bf16` (``csrc/mm_probe.cu``, replacing the
inline kernel of ``tools/mosaic_mm_probe.py``) are a bare tensor-core
matrix product repeated g times into one accumulator, timed by
:mod:`ieache_tpu_torch.tools.mosaic_mm_probe`.

A wrapper checks device, dtype, shape, contiguity and alignment, then
launches its kernel when the tensors lie on a CUDA device, or runs its
plain twin (``*_plain``) when they lie on the CPU; it never falls back
from one to the other.  Each wrapper's ``launches`` attribute counts
its kernel launches (the plain twins count nothing);
:func:`recording_batches` also notes the batch of each call.  Only the
single-limb gadget (``digit_limbs == 1``) is taken, as on the TPU.
:func:`kernels_take` says whether a step mode's kernels accept a
parameter set's shape; the wrappers refuse what it refuses
(``ValueError``, CUDA tensors only), and ``blind_rotate`` asks it before
it picks kernels.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    _dot_i8,
    negacyclic_extend,
)
from ieache_tpu_torch.ops import _build
from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.ops.decompose import _offset, gadget_decompose
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


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, which the launch policies read."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rot_diff_decompose_launch(wrapper, entry: str, plain, policy,
                               acc: torch.Tensor, bara: torch.Tensor,
                               params: TFHEParams, tr: bool) -> torch.Tensor:
    """Both rotation wrappers' body: the digits, (rows, N, B) when ``tr``
    else (rows, B, N), from the C entry point ``entry`` launched as
    ``policy(B, k+1, N, SMs)`` says on CUDA tensors, counted on
    ``wrapper``, or from ``plain`` on CPU tensors."""
    _require_single_limb(params)
    kp1, b, n = params.k + 1, bara.numel(), params.N
    _check(acc, "acc", torch.int32, (kp1, n, b) if tr else (kp1, b, n),
           acc.device)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    if not acc.is_cuda:
        return plain(acc, bara, params)

    _refuse(kernels_refusal("tr", params.trgsw_rows, n) if tr
            else rotation_refusal(n))
    out = _rot_diff_decompose_entry(entry, acc, bara, params, tr,
                                    policy(b, kp1, n, _sm_count(acc.device)))
    wrapper.launches += 1
    return out


def _rot_diff_decompose_entry(entry: str, acc: torch.Tensor,
                              bara: torch.Tensor, params: TFHEParams,
                              tr: bool, launch) -> torch.Tensor:
    """One launch of a rotation's C entry point on checked CUDA tensors,
    with the launch shape ``launch`` (a tuple of ints the entry takes
    after the offset), uncounted: the wrappers' launch, and the one
    ``tools/tile_bench.py`` times other shapes through."""
    kp1, b, n = params.k + 1, bara.numel(), params.N
    rows = params.trgsw_rows
    out = torch.empty((rows, n, b) if tr else (rows, b, n), dtype=torch.int8,
                      device=acc.device)
    if b == 0:
        return out
    lib, stream = _launch_context(acc)
    code = getattr(lib, entry)(
        acc.data_ptr(), bara.data_ptr(), out.data_ptr(), kp1, b, n,
        params.bg_bit, params.l, _offset(params.bg_bit, params.l), *launch,
        stream,
    )
    _build.check(lib, code, entry)
    return out


def rot_diff_decompose(acc: torch.Tensor, bara: torch.Tensor,
                       params: TFHEParams) -> torch.Tensor:
    """acc (k+1, B, N) int32, bara (B,) int32 in [0, 2N) -> (rows, B, N)
    int8 digits; the kernel on CUDA tensors, the plain twin on CPU."""
    return _rot_diff_decompose_launch(
        rot_diff_decompose, "ieache_rot_diff_decompose",
        rot_diff_decompose_plain, _split_launch, acc, bara, params, tr=False)


def _split_launch(batch: int, kp1: int, n: int, sms: int) -> tuple:
    """The split rotation's launch arguments: (:func:`rot_launch`,)."""
    return (rot_launch(batch, kp1, n, sms),)


rot_diff_decompose.launches = 0


# ---------------------------------------------------------------------------
# the tensor-core tile of csrc/mma_tile.cuh: its limits, and a plain model
# of how it builds and indexes its Toeplitz operand
# ---------------------------------------------------------------------------

#: the most coefficients (and digit columns a chunk) of a block's tile
MMA_TILE_COLS = 256

#: chunks of digit columns per build of the byte planes
MMA_SEG_CHUNKS = 4

#: batch rows of a block's tile (the MMA's m)
MMA_TILE_ROWS = 16

#: bytes of padding after the N digits of a row of a digit tile in shared
#: memory: ldmatrix's 8 rows then fall on 8 distinct groups of 4 banks
DIGIT_ROW_PAD = 16

#: the tile's limit on rows * N: below it each limb's s8 x s8 sum over all
#: rows * N terms (at most 2^14 each) is exact in int32
MMA_MAX_TERMS = 1 << 17


#: dynamic shared memory a block may ask for on the H100
SMEM_BLOCK_BYTES = 232448

#: digit tiles a block of each tensor-core step mode keeps in shared
#: memory: none where the digits stream from device memory, one under
#: fused2, the overlap kernel's two stages
_DIGIT_TILES = {"split": 0, "scan": 0, "tr": 0, "fused2": 1, "overlap": 2,
                "overlap2": 2}


def mma_planes_bytes(n: int) -> int:
    """Shared memory of the tile's byte planes at ring degree ``n``
    (``Shape<NI>::kPlanesBytes``): 4 limbs x 4 copies of T + 4T bytes, a
    copy's stride in words padded to 8 mod 32."""
    words = (min(n, MMA_TILE_COLS) * (1 + MMA_SEG_CHUNKS)) // 4
    return 16 * (words + (8 - words % 32) % 32) * 4


def digit_tile_bytes(rows: int, n: int) -> int:
    """Bytes of a block's digit tile, (rows, 16, N + 16) int8."""
    return rows * MMA_TILE_ROWS * (n + DIGIT_ROW_PAD)


def kernels_refusal(mode: str, rows: int, n: int) -> str | None:
    """Why the kernels of step mode ``mode`` refuse ``rows`` TRGSW rows
    at ring degree ``n``, or None where they take the shape.  Every mode
    with kernels runs its products on the tensor-core tile, which needs N
    a power of two of at least 64 and rows * N below
    :data:`MMA_MAX_TERMS`; where a block keeps digit tiles in shared
    memory (fused2, overlap) it needs room for them, and under ``tr`` the
    rotation's slab (:func:`rot_tr_slab_bytes`) must fit a block; ``ntt``
    runs no kernel."""
    if mode == "ntt":
        return None
    tiles = _DIGIT_TILES[mode]
    if n < 64 or n & (n - 1):
        return (f"the tensor-core external product needs N a power of two "
                f">= 64, got N={n}")
    if rows * n >= MMA_MAX_TERMS:
        return (f"the tensor-core external product needs rows * N < "
                f"{MMA_MAX_TERMS} (each int8 limb's sum must stay exact in "
                f"int32), got rows={rows}, N={n}")
    need = mma_planes_bytes(n) + tiles * digit_tile_bytes(rows, n)
    if tiles and need > SMEM_BLOCK_BYTES:
        return (f"the tensor-core external product's {tiles} digit tile(s) "
                f"of rows={rows}, N={n} need {need} bytes of shared memory, "
                f"a block has {SMEM_BLOCK_BYTES}")
    if mode == "tr" and rot_tr_slab_bytes(n) > SMEM_BLOCK_BYTES:
        return (f"the tr rotation's slab of N={n} rows x {TR_SLAB_LANES} "
                f"lanes needs {rot_tr_slab_bytes(n)} bytes of shared memory, "
                f"a block has {SMEM_BLOCK_BYTES}")
    return None


def rotation_refusal(n: int) -> str | None:
    """Why ``rot_diff_decompose`` (the split mode's rotation) refuses ring
    degree ``n``, or None: it takes N % 8 == 0 (N a power of two, as
    every parameter set has it, so N >= 8 and a run of 4 or 8 fits)."""
    return None if n % 8 == 0 else (
        f"the rotation kernel needs N % 8 == 0, got N={n}")


# The split step's rotation (csrc/rot_diff_decompose.cu): a thread takes a
# run of consecutive coefficients of one polynomial; its launch policy and
# a plain model of its work.

#: the run lengths of a thread, longest first: one 8- or 4-byte store a
#: digit row (runs of 16 lost to runs of 8 at every batch on the H100:
#: PERF.md §6)
ROT_RUNS = (8, 4)

#: threads of the kernel's block, fixed in the ``.cu`` (``kThreads``;
#: blocks of 32, 64 and 256 lost or tied: PERF.md §6)
ROT_THREADS = 128

#: threads an SM of the H100 holds at once
SM_THREADS = 2048


def rot_launch(batch: int, kp1: int, n: int, sms: int = 132) -> int:
    """The run (coefficients a thread) of ``csrc/rot_diff_decompose.cu``'s
    launch, which takes it as it is: runs of 8 once runs of 4 would need
    more threads than the ``sms`` SMs hold at once (the throughput
    batches: B > 528 at k = 1, N = 1024), else runs of 4 (more threads,
    each with fewer loads to wait for, spread over more SMs).  N >= 8, so
    a run of 8 always fits."""
    return 8 if kp1 * batch * n // 4 > sms * SM_THREADS else 4


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as int64 in [0, 2^32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """``__byte_perm(x, y, sel)`` on words held as int64 in [0, 2^32):
    byte k of the result is byte ``(sel >> 4k) & 7`` of the eight bytes
    y:x (x the low four)."""
    out = torch.zeros_like(x)
    for k in range(4):
        m = (sel >> (4 * k)) & 7
        src = x if m < 4 else y
        out |= ((src >> (8 * (m % 4))) & 0xFF) << (8 * k)
    return out


def digit_word_model(v: torch.Tensor, jl: int, bg_bit: int) -> torch.Tensor:
    """``digit_word`` of ``cmux_common.cuh``: v (..., 4) words as int64 in
    [0, 2^32) -> the (...) words whose byte s is digit jl of v[..., s];
    with Bg = 2^8 by three byte permutes and a xor, else digit by
    digit."""
    if bg_bit == 8:
        pick = (3 - jl) | ((7 - jl) << 4)
        return byte_perm(byte_perm(v[..., 0], v[..., 1], pick),
                         byte_perm(v[..., 2], v[..., 3], pick),
                         0x5410) ^ 0x80808080
    shift = 32 - (jl + 1) * bg_bit
    digit = ((v >> shift) & ((1 << bg_bit) - 1)) - (1 << (bg_bit - 1))
    return sum((digit[..., s] & 0xFF) << (8 * s) for s in range(4))


def rot_diff_decompose_run_model(acc: torch.Tensor, bara: torch.Tensor,
                                 params: TFHEParams, sms: int = 132,
                                 run: int | None = None
                                 ) -> torch.Tensor:
    """``rot_diff_decompose``'s work in plain ops, thread by thread, for
    runs of ``run`` coefficients (by default :func:`rot_launch` on a card
    of ``sms`` SMs) in blocks of :data:`ROT_THREADS`: thread t of grid row
    u (the (B N / R runs, k+1) grid) takes run t of component u, lane
    t >> log2(N / R), coefficients R (t & (N / R - 1)) onwards; its
    rotated words are the R / 4 + 1 aligned quads of e = (c, -c) from
    i0 & ~3 (i0 = (j0 - bara) mod 2N; the last one read only when
    s = i0 & 3 is not 0), each negated whole, shifted down by s in two
    selects (by 2, then by 1); each digit row's R bytes are packed by
    :func:`digit_word_model` and stored as one run.  Same arguments and
    result as :func:`rot_diff_decompose_plain`; every output byte is
    written once."""
    kp1, b, n = acc.shape
    run = rot_launch(b, kp1, n, sms) if run is None else run
    if run not in ROT_RUNS or run > n:
        raise ValueError(f"no launch of run {run} at N={n}")
    dev = acc.device
    per = n // run
    log_per = per.bit_length() - 1
    blocks = -(-b * per // ROT_THREADS)
    row = torch.arange(blocks * ROT_THREADS, device=dev)
    row = row[row < b * per]                    # the threads that have a run
    u = torch.arange(kp1, device=dev).repeat_interleave(len(row))
    t = row.repeat(kp1)
    lane, j0 = t >> log_per, (t & (per - 1)) * run
    poly = u * b + lane
    c = _u32(acc.reshape(kp1 * b, n))
    mask2n = 2 * n - 1
    i0 = (j0 - bara.to(torch.int64)[lane]) & mask2n
    s = i0 & 3
    q = ((i0 & ~3)[:, None] + 4 * torch.arange(run // 4 + 1, device=dev)) \
        & mask2n                                                # (t, Q+1)
    hi = q >= n
    idx = torch.where(hi, q - n, q)[..., None] + torch.arange(4, device=dev)
    quads = c[poly[:, None, None], idx]                         # (t, Q+1, 4)
    quads[:, -1] *= (s != 0)[:, None]           # read only when s != 0
    w = torch.where(hi[..., None], (-quads) & 0xFFFFFFFF, quads) \
        .reshape(len(t), run + 4)
    k = torch.arange(run + 2, device=dev)
    w = torch.where((s & 2 != 0)[:, None], w[:, k + 2], w[:, k])
    k = torch.arange(run, device=dev)
    w = torch.where((s & 1 != 0)[:, None], w[:, k + 1], w[:, k])
    cols = j0[:, None] + k
    v = (w - c[poly[:, None], cols] + _offset(params.bg_bit, params.l)) \
        & 0xFFFFFFFF                                            # (t, R)
    out = torch.zeros((params.trgsw_rows, b, n), dtype=torch.int8,
                      device=dev)
    written = torch.zeros(out.shape, dtype=torch.int32, device=dev)
    shifts = 8 * torch.arange(4, device=dev)
    for jl in range(params.l):
        words = digit_word_model(v.reshape(len(t), run // 4, 4), jl,
                                 params.bg_bit)                 # (t, R/4)
        digits = ((words[..., None] >> shifts) & 0xFF).reshape(len(t), run)
        p = (u * params.l + jl)[:, None]
        out[p, lane[:, None], cols] = \
            (digits - ((digits & 0x80) << 1)).to(torch.int8)
        written[p, lane[:, None], cols] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the rotation's runs do not write every digit "
                             "once")
    return out


def kernels_take(mode: str, params: TFHEParams) -> bool:
    """Whether the kernels of step mode ``mode`` accept ``params``'
    shape (:func:`kernels_refusal`); ``blind_rotate`` takes the plain
    step where they do not."""
    return kernels_refusal(mode, params.trgsw_rows, params.N) is None


def _refuse(why: str | None) -> None:
    if why is not None:
        raise ValueError(why)


def mma_tile_check(rows: int, n: int) -> None:
    """Raise ``ValueError`` for a shape the tensor-core tile refuses: N
    must be a power of two of at least 64 and rows * N below
    :data:`MMA_MAX_TERMS`."""
    _refuse(kernels_refusal("split", rows, n))


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


# The same tile in the transposed (k+1, N, B) layout (csrc/external_product
# _tr.cu): the Toeplitz limb tile is the MMA's A operand (16 coefficients x
# 32 digit columns), the digits its B operand (32 digit columns x 8 batch
# lanes), staged through a transpose.

#: batch lanes of a tr tile: two of the MMA's 8-lane n-tiles
TR_TILE_LANES = 16

#: where the A registers a0..a3 of m16n8k32 lie against a0, in diagonals of
#: the Toeplitz tile (units of 8): a1 holds the 8 coefficients below a0's,
#: a2 the 16 digit columns right of them, a3 both
MMA_A_DIAGONALS = (0, -1, 2, 1)


def mma_a_window_index(ni: int, mt: int, r: int) -> int:
    """The entry of a warp's window of NI + 2 plane words (entry i holds
    diagonal 4 kseg - NI + 1 + i of k-step kseg) that A register ``r`` of
    the warp's m-tile ``mt`` (16 coefficients from 16 mt) takes."""
    return ni - 1 - 2 * mt + MMA_A_DIAGONALS[r]


def mma_toeplitz_tile_a(planes: torch.Tensor, n: int,
                        mcols: int) -> torch.Tensor:
    """The Toeplitz limb tile as ``external_product_tr``'s MMAs see it, its
    A operand gathered from :func:`mma_planes` through the window of
    :func:`mma_a_window_index`: int8 (4 limbs, T, mcols), entry [v, jl,
    ml] = T_v[ml, jl].  Warp w owns coefficients T/4 w .. T/4 (w + 1) - 1
    as NI/2 m-tiles; thread lane = 4 grp + t4 reads, for m-tile mt,
    k-step kseg and register r, word ``(T - 8 NI w) / 4 + t4 - 1 - grp // 4
    + 2 d`` of copy ``3 - grp % 4``, d the window entry's diagonal: byte q
    is the operand at coefficient jl = T/4 w + 16 mt + 8 (r % 2) + grp,
    digit column ml = 32 kseg + 16 (r // 2) + 4 t4 + q."""
    t = min(n, MMA_TILE_COLS)
    ni = t // 32
    dev = planes.device
    warp, mt, grp, kseg, r, t4, q = torch.meshgrid(
        torch.arange(4, device=dev), torch.arange(ni // 2, device=dev),
        torch.arange(8, device=dev), torch.arange(mcols // 32, device=dev),
        torch.arange(4, device=dev), torch.arange(4, device=dev),
        torch.arange(4, device=dev), indexing="ij")
    entry = (ni - 1 - 2 * mt
             + torch.tensor(MMA_A_DIAGONALS, device=dev)[r])
    diagonal = 4 * kseg - ni + 1 + entry
    word = (t - 8 * ni * warp) // 4 + t4 - 1 - grp // 4 + 2 * diagonal
    copy = 3 - grp % 4
    jl = (t // 4) * warp + 16 * mt + 8 * (r % 2) + grp
    ml = 32 * kseg + 16 * (r // 2) + 4 * t4 + q
    tile = torch.zeros((TORUS_LIMBS, t, mcols), dtype=torch.int8, device=dev)
    tile[:, jl.reshape(-1), ml.reshape(-1)] = \
        planes[:, copy.reshape(-1), (4 * word + q).reshape(-1)]
    return tile


def tr_raw_offset(m) -> int:
    """Byte offset of digit column m's 16 lanes in a raw tr stage: 16-byte
    rows as they lie in device memory, 16 bytes of padding after every 8,
    so that the transpose's reads fall on 32 distinct banks."""
    return 16 * m + 16 * (m >> 3)


def tr_transpose_reads(t: int) -> torch.Tensor:
    """The 32-bit words of the raw stage that the transpose reads, as
    (item x, row mi) -> word: item x (thread x mod 128) takes lanes
    4 (x % 4) .. + 3 of digit columns 4 (x // 4) .. + 3, one word a
    column."""
    x = torch.arange(t)[:, None]
    mi = torch.arange(4)[None, :]
    return tr_raw_offset(4 * (x // 4) + mi) // 4 + x % 4


def tr_stage_model(d: torch.Tensor, p: int, m0c: int, b0: int,
                   t: int) -> torch.Tensor:
    """The chunk of digits ``external_product_tr`` stages for digit row p,
    columns m0c .. m0c + t - 1 and lanes b0 .. b0 + 15 of d (rows, N, B)
    int8: copied as it lies into a raw stage (:func:`tr_raw_offset`; lanes
    past the batch zero), then item x of :func:`tr_transpose_reads`
    writes its 4 x 4 bytes transposed, byte r of column word mi to lane
    4 (x % 4) + r, column 4 (x // 4) + mi.  Returns the (16, t + 16)
    int8 buffer ldmatrix reads (row = lane, padding zero)."""
    nb = min(TR_TILE_LANES, d.shape[2] - b0)
    raw = torch.zeros(tr_raw_offset(t), dtype=torch.int8, device=d.device)
    rows = torch.arange(t, device=d.device)
    at = tr_raw_offset(rows)[:, None] + torch.arange(nb, device=d.device)
    raw[at] = d[p, m0c:m0c + t, b0:b0 + nb]
    words = raw.reshape(-1, 4)[tr_transpose_reads(t).to(d.device)]
    x = torch.arange(t, device=d.device)
    out = torch.zeros((TR_TILE_LANES, t + DIGIT_ROW_PAD), dtype=torch.int8,
                      device=d.device)
    for mi in range(4):
        for r in range(4):
            out[4 * (x % 4) + r, 4 * (x // 4) + mi] = words[:, mi, r]
    return out


def external_product_tr_mma_model(d: torch.Tensor, bk_i: torch.Tensor,
                                  params: TFHEParams,
                                  acc: torch.Tensor | None = None,
                                  sms: int = 132) -> torch.Tensor:
    """``external_product_tr``'s arithmetic in plain ops, tile by tile:
    a T-coefficient x 16-lane tile of each component, its (p, chunk) sum
    split over parts as the launch splits it on a card of ``sms`` SMs,
    the planes of each key polynomial built per segment of up to
    :data:`MMA_SEG_CHUNKS` chunks of the part, the A tiles from
    :func:`mma_toeplitz_tile_a`, the digits from :func:`tr_stage_model`,
    one int32 sum per limb, folded as sum_v S_v << 8v (wrapping) and
    added to the output.  Same arguments and result as
    :func:`external_product_tr_plain`."""
    rows, kp1, n = bk_i.shape
    _refuse(kernels_refusal("tr", rows, n))
    t = min(n, MMA_TILE_COLS)
    nchunk, b = n // t, d.shape[2]
    nbt = -(-b // TR_TILE_LANES)
    nchunks = rows * nchunk
    split = mma_split_for(nbt * nchunk * kp1, nchunks, sms)
    out = torch.zeros((kp1, n, b), dtype=torch.int32, device=d.device)
    for o in range(kp1):
        for jb in range(0, n, t):
            for b0 in range(0, b, TR_TILE_LANES):
                nb = min(TR_TILE_LANES, b - b0)
                for q in range(split):
                    c, c_end = q * nchunks // split, (q + 1) * nchunks // split
                    sums = torch.zeros((TORUS_LIMBS, t, TR_TILE_LANES),
                                       dtype=torch.int32, device=d.device)
                    while c < c_end:
                        p, ch0 = c // nchunk, c % nchunk
                        nseg = min(c_end - c, nchunk - ch0, MMA_SEG_CHUNKS)
                        tile = mma_toeplitz_tile_a(
                            mma_planes(bk_i[p, o], jb, ch0 * t, nseg * t), n,
                            nseg * t).to(torch.int32)
                        for i in range(nseg):
                            staged = tr_stage_model(d, p, (ch0 + i) * t, b0,
                                                    t)[:, :t]
                            sums += torch.einsum(
                                "vjm,bm->vjb", tile[:, :, i * t:(i + 1) * t],
                                staged.to(torch.int32))
                        c += nseg
                    for v in range(TORUS_LIMBS):
                        out[o, jb:jb + t, b0:b0 + nb] += \
                            sums[v, :, :nb] << (8 * v)
    return out if acc is None else acc + out


# The rotations in the (k+1, N, B) layout (csrc/rot_slab.cuh: the tr step's,
# csrc/rot_diff_decompose_tr.cu, and the probe's sublane kernel,
# csrc/rotate_probe.cu): a block holds all N rows of 16 batch lanes of one
# polynomial in shared memory; a small batch gathers from device memory
# instead.

#: batch lanes of a rotation slab
TR_SLAB_LANES = 16

#: blocks a slab from which the rotation gathers: each moves 64 bytes a
#: row of the slab, the gather 16 sectors of 32 bytes and 64 bytes
TR_GATHER_SPLITS = 16


def rot_tr_slab_bytes(n: int) -> int:
    """Shared memory of a rotation block: the (N, 16) int32 slab."""
    return n * TR_SLAB_LANES * 4


def rot_tr_splits(blocks: int, n: int, sms: int = 132) -> int:
    """How many blocks share a slab, each loading all of it and computing
    N / splits of its rows: 1 when the launch's ``blocks`` slabs reach
    ``sms``, else the smallest power of two that does, at most N / 16
    (one row of a block's threads).  From :data:`TR_GATHER_SPLITS` the
    rotations gather instead (:func:`rot_tr_route`)."""
    splits = 1
    while blocks * splits < sms and splits < n // 16:
        splits *= 2
    return splits


def rot_tr_route(batch: int, kp1: int, n: int, sms: int = 132) -> int:
    """The ``splits`` both slab kernels' launches take as they are:
    :func:`rot_tr_splits` of the launch's slabs, or 0, the gather, from
    :data:`TR_GATHER_SPLITS` blocks a slab on and where the slab does not
    fit a block's shared memory (:data:`SMEM_BLOCK_BYTES`)."""
    if rot_tr_slab_bytes(n) > SMEM_BLOCK_BYTES:
        return 0
    splits = rot_tr_splits(-(-batch // TR_SLAB_LANES) * kp1, n, sms)
    return 0 if splits >= TR_GATHER_SPLITS else splits


def rot_tr_slab_banks(j0: int, bara: torch.Tensor, n: int,
                      lanes: int = TR_SLAB_LANES) -> tuple:
    """The shared-memory banks a warp's 32 lanes read: lanes 0 .. 15 row
    j0, 16 .. 31 row j0 + 1 (with 16-lane slabs), lane's batch lane b
    with amount bara[b].  Returns (banks of the rotated reads, banks of
    the plain reads), each (32,): word row * lanes + b of the slab."""
    lane = torch.arange(32)
    b, j = lane % lanes, j0 + lane // lanes
    i = (j - bara.to(torch.int64)[b]) % (2 * n)
    row = torch.where(i < n, i, i - n)
    return (row * lanes + b) % 32, (j * lanes + b) % 32


def rot_tr_slab_model(acc: torch.Tensor, bara: torch.Tensor,
                      sms: int = 132, splits: int | None = None
                      ) -> torch.Tensor:
    """X^bara·acc on acc (k+1, N, B) int32 as both slab kernels compute
    it, block by block, launched with ``splits`` (by default
    :func:`rot_tr_route` on a card of ``sms`` SMs): per polynomial u and
    slab of 16 lanes the (N, 16) slab (lanes past the batch zero), shared
    by ``splits`` blocks that each compute a run of rows;
    coefficient j of lane b reads slab row (j - bara_b) mod N (negated
    past N).  With ``splits`` 0 (the gather) every coefficient reads its
    word from ``acc`` itself.  Same result as :func:`rotate_sublane_plain`; every
    output row is written once."""
    kp1, n, b = acc.shape
    w = TR_SLAB_LANES
    if splits is None:
        splits = rot_tr_route(b, kp1, n, sms)
    if splits == 0:
        j = torch.arange(n, device=acc.device)[:, None]
        i = (j - bara.to(torch.int64)[None, :]) % (2 * n)      # (N, B)
        word = acc[:, i % n, torch.arange(b, device=acc.device)]
        return torch.where(i < n, word, -word)
    out = torch.zeros_like(acc)
    written = torch.zeros_like(acc)
    lane = torch.arange(w, device=acc.device)
    for u in range(kp1):
        for b0 in range(0, b, w):
            nb = min(w, b - b0)
            slab = torch.zeros((n, w), dtype=torch.int32, device=acc.device)
            slab[:, :nb] = acc[u, :, b0:b0 + nb]
            a = torch.zeros(w, dtype=torch.int64, device=acc.device)
            a[:nb] = bara[b0:b0 + nb].to(torch.int64)
            for s in range(splits):
                j = torch.arange(s * n // splits, (s + 1) * n // splits,
                                 device=acc.device)[:, None]
                i = (j - a[None, :]) % (2 * n)
                rot = torch.where(i < n, slab[i % n, lane], -slab[i % n, lane])
                out[u, j[:, 0], b0:b0 + nb] = rot[:, :nb]
                written[u, j[:, 0], b0:b0 + nb] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the rotation blocks do not write every row "
                             "once")
    return out


def rot_diff_decompose_tr_slab_model(acc: torch.Tensor, bara: torch.Tensor,
                                     params: TFHEParams,
                                     sms: int = 132) -> torch.Tensor:
    """``rot_diff_decompose_tr``'s work in plain ops: the rotated words of
    :func:`rot_tr_slab_model` (each block also reads the plain word from
    its slab: the same word of ``acc``), less ``acc``, decomposed.  Same
    arguments and result as :func:`rot_diff_decompose_tr_plain`."""
    rotated = rot_tr_slab_model(acc, bara, sms)
    digits = gadget_decompose(rotated - acc, params.bg_bit, params.l)
    return digits.permute(0, 3, 1, 2).reshape(params.trgsw_rows,
                                              *acc.shape[1:]) \
        .to(torch.int8)


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

    _refuse(kernels_refusal("tr" if tr else "split", rows, n))
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


# A plain model of what the two step kernels add to the tile: the digit
# tile a block decomposes into shared memory, the part of it a split
# tile's block decomposes, and the overlap kernel's order of work.

def accumulator_for_digits(params: TFHEParams, digit: int, shape: tuple,
                           device=None) -> torch.Tensor:
    """An int32 accumulator of ``shape`` whose CMux step at bara = N
    decomposes to ``digit`` (in [-Bg/2, Bg/2)) in every digit row and
    column: X^N·acc - acc = -2·acc, so acc = -diff / 2 for the diff
    whose l fields all hold ``digit``, which is even while
    l * bg_bit < 32."""
    field = digit + (1 << (params.bg_bit - 1))
    v = sum(field << (32 - (j + 1) * params.bg_bit) for j in range(params.l))
    neg_diff = (_offset(params.bg_bit, params.l) - v) % (1 << 32)
    if neg_diff % 2:
        raise ValueError("no accumulator gives these digits at bara = N "
                         "(l * bg_bit == 32)")
    acc = neg_diff // 2
    return torch.full(shape, acc - (1 << 32) if acc >= 1 << 31 else acc,
                      dtype=torch.int32, device=device)


def cmux_digit_tile(acc: torch.Tensor, bara: torch.Tensor,
                    params: TFHEParams, b0: int, p_lo: int = 0,
                    p_hi: int | None = None, col_lo: int = 0,
                    col_hi: int | None = None, bl_lo: int = 0,
                    bl_hi: int = MMA_TILE_ROWS) -> torch.Tensor:
    """``decompose_tile`` of the kernels: the (rows, 16, N + 16) int8
    tile a block builds in shared memory for batch rows b0 .. b0 + 15 of
    acc (k+1, B, N): tile rows bl_lo .. bl_hi - 1, digit rows p_lo ..
    p_hi at columns col_lo .. col_hi - 1 (all by default).  Rows past
    the batch hold zero digits; what the block does not write (the
    padding, and digits outside the ranges) is zero here and never read
    there."""
    rows, n = params.trgsw_rows, params.N
    p_hi = rows - 1 if p_hi is None else p_hi
    col_hi = n if col_hi is None else col_hi
    d = rot_diff_decompose_plain(
        acc[:, b0:b0 + MMA_TILE_ROWS].contiguous(),
        bara[b0:b0 + MMA_TILE_ROWS].contiguous(), params)
    tile = torch.zeros((rows, MMA_TILE_ROWS, n + DIGIT_ROW_PAD),
                       dtype=torch.int8, device=acc.device)
    bl_hi = min(bl_hi, d.shape[1])
    tile[p_lo:p_hi + 1, bl_lo:bl_hi, col_lo:col_hi] = \
        d[p_lo:p_hi + 1, bl_lo:bl_hi, col_lo:col_hi]
    return tile


#: the most blocks the fused2 launch joins in a thread-block cluster
STEP_CLUSTER_MAX = 2


def step_cluster_shares(nper: int, split: int) -> list:
    """The fused2 launch's cluster: the ``nper`` blocks that share 16
    batch rows form clusters of the largest size up to
    :data:`STEP_CLUSTER_MAX` that divides ``nper`` (of one block when the
    launch splits each tile's sum), and rank r of c decomposes tile rows
    16 r // c .. 16 (r + 1) // c - 1, then copies the rest from its
    peers' shared memory.  Returns the (bl_lo, bl_hi) of each rank."""
    csize = STEP_CLUSTER_MAX if split == 1 else 1
    while nper % csize:
        csize -= 1
    return [(r * MMA_TILE_ROWS // csize, (r + 1) * MMA_TILE_ROWS // csize)
            for r in range(csize)]


def mma_split_for(ntiles: int, nchunks: int, sms: int) -> int:
    """``mma::split_for``: the smallest divisor of a tile's ``nchunks``
    (p, chunk) pairs that gives a launch of ``ntiles`` tiles at least
    one part per SM."""
    split = 1
    while ntiles * split < sms and split < nchunks:
        split += 1
        while nchunks % split:
            split += 1
    return split


def cmux_part_ranges(rows: int, n: int, split: int) -> list:
    """What part q of a tile split ``split`` ways sums and decomposes
    (``part_range`` of the kernels), as (c_begin, c_end, p_lo, p_hi,
    col_lo, col_hi) for q = 0 .. split - 1: the (p, chunk) pairs c_begin
    .. c_end - 1 (pair c = p * (N / T) + chunk), and the digit rows p_lo
    .. p_hi and columns col_lo .. col_hi - 1 its block decomposes first:
    one row's columns of its chunks when their count is a power of two,
    else all columns of every row it touches."""
    t = min(n, MMA_TILE_COLS)
    nchunk = n // t
    nchunks = rows * nchunk
    parts = []
    for q in range(split):
        c_begin, c_end = q * nchunks // split, (q + 1) * nchunks // split
        p_lo, p_hi = c_begin // nchunk, (c_end - 1) // nchunk
        count = c_end - c_begin
        if p_lo == p_hi and count & (count - 1) == 0:
            col_lo = (c_begin - p_lo * nchunk) * t
            parts.append((c_begin, c_end, p_lo, p_hi, col_lo,
                          col_lo + count * t))
        else:
            parts.append((c_begin, c_end, p_lo, p_hi, 0, n))
    return parts


def tiles_per_item(nbt: int, group: int, places: int) -> int:
    """``tiles_per_item`` of the step kernels' launches: the tiles a
    block (fused2) or a work item (overlap) computes from one
    decomposition.  Of the ways to cut a row group's ``group`` tiles into
    equal runs, the one whose busiest place ends soonest when ``nbt``
    row groups are dealt to ``places`` blocks resident at once, a run
    costing its tiles and a quarter of a tile for its decomposition; of
    equal ones the longest run."""
    best, best_cost = group, None
    for parts in range(1, group + 1):
        per = -(-group // parts)
        items = nbt * -(-group // per)
        cost = -(-items // places) * (4 * per + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = per, cost
    return best


def step_work_items(batch: int, n: int, kp1: int, places: int) -> list:
    """The step kernels' work items in their order, as (b0, [(jb, o),
    ...]): 16 batch rows from b0 and a run of their N/T x (k+1) output
    tiles, tile t at coefficient jb = (t % (N/T)) * T of component
    o = t // (N/T).  Under fused2 item (x, y) is block (x, y) of the
    grid; block x of the overlap kernel's grid of g takes items x,
    x + g, ..."""
    t = min(n, MMA_TILE_COLS)
    njt = n // t
    nbt, group = -(-batch // MMA_TILE_ROWS), njt * kp1
    per = tiles_per_item(nbt, group, places)
    return [(bt * MMA_TILE_ROWS,
             [((tl % njt) * t, tl // njt)
              for tl in range(t0, min(t0 + per, group))])
            for bt in range(nbt) for t0 in range(0, group, per)]


def cmux_step_mma_model(acc: torch.Tensor, bara: torch.Tensor,
                        bk_i: torch.Tensor, params: TFHEParams,
                        sms: int = 132, blocks_per_sm: int = 2,
                        cluster: bool = True) -> torch.Tensor:
    """The fused2 kernel's work in plain ops, block by block, on a card
    of ``sms`` SMs that hold ``blocks_per_sm`` of its blocks each.  With
    fewer tiles than SMs: per 16 batch rows and part of the split, the
    digit tile the block decomposes (:func:`cmux_digit_tile` over
    :func:`cmux_part_ranges`), cut to the part's (p, chunk) pairs, through
    :func:`external_product_mma_model`, the parts' shares added to a copy
    of the accumulator.  Else per work item of :func:`step_work_items`
    one whole digit tile (with ``cluster`` put together from the shares
    of :func:`step_cluster_shares`) and, from it, each of the item's
    output tiles, every output written once.  Same arguments and result
    as :func:`cmux_step_plain`."""
    rows, kp1, n = bk_i.shape
    b = acc.shape[1]
    t = min(n, MMA_TILE_COLS)
    nbt = -(-b // MMA_TILE_ROWS)
    split = mma_split_for(nbt * (n // t) * kp1, rows * (n // t), sms)
    if split > 1:
        out = acc.clone()
        for b0 in range(0, b, MMA_TILE_ROWS):
            nb = min(MMA_TILE_ROWS, b - b0)
            for c_begin, c_end, *rect in cmux_part_ranges(rows, n, split):
                tile = cmux_digit_tile(acc, bara, params, b0, *rect)
                d = torch.zeros((rows, nb, n), dtype=torch.int8,
                                device=acc.device)
                for c in range(c_begin, c_end):
                    p, m0 = c // (n // t), (c % (n // t)) * t
                    d[p, :, m0:m0 + t] = tile[p, :nb, m0:m0 + t]
                out[:, b0:b0 + nb] += external_product_mma_model(d, bk_i,
                                                                 params)
        return out
    out = torch.zeros_like(acc)
    written = torch.zeros_like(acc)
    items = step_work_items(b, n, kp1, sms * blocks_per_sm)
    shares = step_cluster_shares(len(items) // nbt, split) if cluster \
        else [(0, MMA_TILE_ROWS)]
    for b0, tiles in items:
        nb = min(MMA_TILE_ROWS, b - b0)
        # a cluster's blocks each decompose a share of the rows; every
        # block ends with the whole tile
        tile = sum(cmux_digit_tile(acc, bara, params, b0, bl_lo=lo, bl_hi=hi)
                   for lo, hi in shares)
        full = external_product_mma_model(
            tile[:, :nb, :n].contiguous(), bk_i, params,
            acc[:, b0:b0 + nb].contiguous())
        for jb, o in tiles:
            out[o, b0:b0 + nb, jb:jb + t] = full[o, :, jb:jb + t]
            written[o, b0:b0 + nb, jb:jb + t] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the work items do not write every output "
                             "tile once")
    return out


def cmux_step_overlap_mma_model(acc: torch.Tensor, bara: torch.Tensor,
                                bk_i: torch.Tensor, params: TFHEParams,
                                sms: int = 132) -> torch.Tensor:
    """The overlap kernel's work in plain ops on a card of ``sms`` SMs:
    :func:`cmux_step_mma_model` with one block an SM (with fewer tiles
    than SMs its launch runs the fused2 kernel's split parts; else its
    persistent blocks walk the same work items, each decomposing its
    own)."""
    return cmux_step_mma_model(acc, bara, bk_i, params, sms, blocks_per_sm=1,
                               cluster=False)


def _cmux_step_launch(wrapper, entry: str, mode: str, acc: torch.Tensor,
                      bara: torch.Tensor, bk_i: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """Both step kernels' wrapper body: the new accumulator from the C
    entry point ``entry`` on CUDA tensors (which raises ``ValueError``
    for a shape :func:`kernels_refusal` refuses under ``mode``), counted
    on ``wrapper``, or from the plain twin on CPU tensors.  The output
    never aliases ``acc``: blocks read it while others write."""
    _require_single_limb(params)
    rows, kp1, b, n = params.trgsw_rows, params.k + 1, bara.numel(), params.N
    _check(acc, "acc", torch.int32, (kp1, b, n), acc.device, align=16)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    _check(bk_i, "bk_i", torch.int32, (rows, kp1, n), acc.device)
    if not acc.is_cuda:
        return cmux_step_plain(acc, bara, bk_i, params)

    _refuse(kernels_refusal(mode, rows, n))
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
    return _cmux_step_launch(cmux_step, "ieache_cmux_step", "fused2", acc,
                             bara, bk_i, params)


cmux_step.launches = 0


def cmux_step_overlap(acc: torch.Tensor, bara: torch.Tensor,
                      bk_i: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """:func:`cmux_step` with the next batch rows' rotate + decompose
    overlapped with these rows' product (``overlap``/``overlap2``);
    same arguments and result, bit for bit."""
    return _cmux_step_launch(cmux_step_overlap, "ieache_cmux_step_overlap",
                             "overlap", acc, bara, bk_i, params)


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

    _refuse(kernels_refusal("scan", rows, n))
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
    int8 digits of X^bara·acc - acc; the kernel on CUDA tensors (which
    raises ``ValueError`` for a shape ``kernels_refusal("tr", ...)``
    refuses), the plain twin on CPU."""
    return _rot_diff_decompose_launch(
        rot_diff_decompose_tr, "ieache_rot_diff_decompose_tr",
        rot_diff_decompose_tr_plain, _tr_launch, acc, bara, params, tr=True)


def _tr_launch(batch: int, kp1: int, n: int, sms: int) -> tuple:
    """The tr rotations' launch arguments: (:func:`rot_tr_route`,)."""
    return (rot_tr_route(batch, kp1, n, sms),)


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
    int32 or None -> (k+1, N, B) int32; the kernel on CUDA tensors (which
    raises ``ValueError`` for a shape ``kernels_refusal("tr", ...)``
    refuses), the plain twin on CPU."""
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
    when ``lanes_last``, rotated by bara (B,) int32 in [0, 2N); the
    sublane kernel launched as :func:`rot_tr_route` says."""
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

    launch = (rot_tr_route(b, kp1, n, _sm_count(acc.device)),) \
        if lanes_last else ()
    out = _rotate_entry(entry, acc, bara, n, launch)
    wrapper.launches += 1
    return out


def _rotate_entry(entry: str, acc: torch.Tensor, bara: torch.Tensor, n: int,
                  launch: tuple) -> torch.Tensor:
    """One launch of a probe rotation's C entry point on checked CUDA
    tensors with the launch arguments ``launch``, uncounted: the
    wrappers' launch, and the one ``tools/tile_bench.py`` times the
    sublane kernel's other route through."""
    out = torch.empty_like(acc)
    kp1, b = acc.shape[0], bara.numel()
    if b == 0 or kp1 == 0:
        return out
    lib, stream = _launch_context(acc)
    code = getattr(lib, entry)(acc.data_ptr(), bara.data_ptr(),
                               out.data_ptr(), kp1, b, n, *launch, stream)
    _build.check(lib, code, entry)
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


#: every wrapper that counts its launches
WRAPPERS = ("rot_diff_decompose", "external_product", "cmux_step",
            "cmux_step_overlap", "blind_rotate_scan", "rot_diff_decompose_tr",
            "external_product_tr", "rotate_lane", "rotate_sublane", "mm_s8",
            "mm_bf16")


#: the kernels each step mode of ``blind_rotate`` launches (ntt none)
MODE_KERNELS = {
    "split": ("rot_diff_decompose", "external_product"),
    "fused2": ("cmux_step",),
    "overlap": ("cmux_step_overlap",),
    "overlap2": ("cmux_step_overlap",),
    "scan": ("blind_rotate_scan",),
    "tr": ("rot_diff_decompose_tr", "external_product_tr"),
    "ntt": (),
}

#: the step kernels' wrappers, and where a call holds its batch (the
#: lanes of one bootstrap wave): (argument, axis)
BATCH_AXES = {"rot_diff_decompose": (1, 0), "external_product": (0, 1),
              "cmux_step": (1, 0), "cmux_step_overlap": (1, 0),
              "blind_rotate_scan": (1, 0), "rot_diff_decompose_tr": (1, 0),
              "external_product_tr": (0, 2)}


def launch_counts() -> dict:
    """{wrapper: its launches so far} for each of :data:`WRAPPERS`."""
    return {name: globals()[name].launches for name in WRAPPERS}


def reset_launch_counts() -> None:
    """Sets every wrapper's ``launches`` to 0."""
    for name in WRAPPERS:
        globals()[name].launches = 0


class _BatchRecorder:
    """Stands in for a wrapper in this module: adds the batch of each
    call to ``seen``, then calls the wrapper, whose ``launches`` it reads
    and sets."""

    def __init__(self, wrapper, arg, axis, seen):
        self.wrapper, self.arg, self.axis, self.seen = wrapper, arg, axis, seen

    def __call__(self, *args, **kwargs):
        self.seen.add(args[self.arg].shape[self.axis])
        return self.wrapper(*args, **kwargs)

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, n):
        self.wrapper.launches = n


@contextlib.contextmanager
def recording_batches():
    """Within the block, every batch at which a wrapper of
    :data:`BATCH_AXES` is called (on any device): yields {wrapper: set
    of batches}."""
    wrappers = {name: globals()[name] for name in BATCH_AXES}
    seen = {name: set() for name in BATCH_AXES}
    try:
        for name, (arg, axis) in BATCH_AXES.items():
            globals()[name] = _BatchRecorder(wrappers[name], arg, axis,
                                             seen[name])
        yield seen
    finally:
        globals().update(wrappers)
