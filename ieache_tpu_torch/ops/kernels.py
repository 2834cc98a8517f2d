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
  with the accumulator fused, on the int8 tensor cores in the form
  :func:`product_launch` picks by batch: Hopper's warpgroup MMA
  (``csrc/wgmma_tile.cuh``; :func:`wgmma_toeplitz_tile`,
  :func:`wgmma_stage_model`, :func:`wgmma_descriptor_reads`,
  :func:`wgmma_epilogue_model` and :func:`external_product_wgmma_model`
  are its plain model) or, at small batches, ``mma.sync``
  (``csrc/mma_tile.cuh``; :func:`mma_planes`, :func:`mma_toeplitz_tile`
  and :func:`external_product_mma_model` model that tile's operand
  construction), for the CPU tests;
* ``fused2``: :func:`cmux_step` (``csrc/cmux_step.cu``, replaces
  ``cmux_step_pallas``), the whole step in one kernel, in the form
  :func:`step_launch` picks by batch: the warpgroup tile with a producer
  that decomposes the digits straight into its stages, shared across a
  cluster of the blocks of the same batch rows (``csrc/wgmma_step.cuh``;
  :func:`wgmma_step_unit_model`, :func:`wgmma_step_copy_ranges`,
  :func:`wgmma_step_stages` and :func:`cmux_step_wgmma_model` are its
  plain model), or the ``mma.sync`` tile fed from digits the block
  decomposes into its own shared memory (:func:`cmux_digit_tile`,
  :func:`cmux_part_ranges` and :func:`cmux_step_mma_model`);
* ``overlap``/``overlap2``: :func:`cmux_step_overlap`
  (``csrc/cmux_step_overlap.cu``, replaces ``cmux_step_overlap_pallas``
  and ``cmux_step_overlap2_pallas``), the step with the next batch rows'
  decomposition overlapped (:func:`step_work_items` and
  :func:`cmux_step_overlap_mma_model` model its order of work);
* ``scan``: :func:`blind_rotate_scan` (``csrc/blind_rotate_scan.cu``,
  replaces ``blind_rotate_scan_pallas``), all n steps in one persistent
  cooperative launch: each step is fused2's work (in the form fused2
  takes at the batch) over the whole grid, one grid barrier a step, the
  accumulator turning through two buffers (three when the tiles' sums
  are split into parts that add atomically), launched as
  :func:`scan_launch` says (:func:`blind_rotate_scan_schedule_model`
  walks that schedule);
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

The keyswitch of every bootstrap wave (``csrc/keyswitch.cu``, which
replaces no Pallas kernel: the JAX package leaves it to XLA) is launched
by ``ops/keyswitch.keyswitch`` as :func:`keyswitch_launch` says, and
runs any launch through :func:`keyswitch_as`;
:func:`keyswitch_kernel_model` is its plain model.

A wrapper checks device, dtype, shape, contiguity and alignment, then
launches its kernel when the tensors lie on a CUDA device, or runs its
plain twin (``*_plain``) when they lie on the CPU; it never falls back
from one to the other.  Each wrapper's ``launches`` attribute counts
its kernel launches (the plain twins count nothing);
:func:`recording_batches` also notes the batch of each call.

A gadget whose digits need two int8 limbs (``digit_limbs == 2``: the
compat gadget Bg = 2^10) runs under ``split`` alone: the rotation writes
each digit d as two digit rows, its signed low byte d_lo and
d_hi = (d - d_lo) / 2^8 (:func:`digit_limb_rows`), and the external
product runs unchanged at those :func:`digit_rows`, against the key with
(2^8·b) mod 2^32 beside each row b (:func:`limb_key`, made once when
the key is packed): d_hi times that row is the plain step's limb
products at shifts 8 to 24, those at 32 and above vanishing mod 2^32.
The other modes' wrappers refuse it (``ValueError``).
:func:`kernels_take` says whether a step mode's kernels accept a
parameter set's shape; the wrappers refuse what it refuses
(``ValueError``, CUDA tensors only), and ``blind_rotate`` asks it before
it picks kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    _dot_i8,
    negacyclic_extend,
    split_i8_limbs,
)
from ieache_tpu_torch.ops import _build
from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.ops.decompose import _offset, gadget_decompose
from ieache_tpu_torch.params import TFHEParams


def _require_single_limb(params: TFHEParams) -> None:
    if params.digit_limbs != 1:
        raise ValueError(
            "this step mode's kernels require single-limb digits "
            f"(bg_bit <= 8; split takes two limbs); got bg_bit={params.bg_bit}"
        )


def digit_rows(params: TFHEParams) -> int:
    """The digit rows the split kernels run: the TRGSW rows (k+1)·l,
    twice that where a digit takes two int8 limbs."""
    return params.trgsw_rows * params.digit_limbs


def digit_limb_rows(d: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Digits int32 (B, rows, N) -> the split kernels' int8 digit rows
    (B, rows·limbs, N): the digits themselves, or with two limbs
    row 2p + h limb h of row p's digits (``split_i8_limbs``: d_lo the
    signed low byte, d_hi = (d - d_lo) / 2^8)."""
    if params.digit_limbs == 1:
        return d.to(torch.int8)
    b, rows, n = d.shape
    limbs = split_i8_limbs(d, params.digit_limbs)            # (B, rows, N, 2)
    return torch.movedim(limbs, -1, 2).reshape(b, rows * params.digit_limbs,
                                                n)


def limb_key(bk: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """The key the split product reads: int32 (..., rows, k+1, N) ->
    (..., :func:`digit_rows`, k+1, N), row 2p + h being
    (2^(8h)·bk[..., p]) mod 2^32 where a digit takes two limbs; ``bk``
    itself with one."""
    if params.digit_limbs == 1:
        return bk
    shifted = torch.stack([bk << (8 * h) for h in range(params.digit_limbs)],
                          dim=-3)                      # (..., rows, 2, k+1, N)
    return shifted.reshape(*bk.shape[:-3], digit_rows(params),
                           *bk.shape[-2:]).contiguous()


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
    (X^bara·acc - acc) as (rows, B, N) int8, row p = u*l + j; with two
    limbs a digit (2 rows, B, N), row 2p + h (:func:`digit_limb_rows`)."""
    d = br._step_digits(acc.transpose(0, 1), bara, params)   # (B, rows, N)
    return digit_limb_rows(d, params).transpose(0, 1).contiguous()


@functools.cache
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
    ``wrapper``, or from ``plain`` on CPU tensors.  Two-limb digits are
    taken only in the (rows, B, N) layout."""
    if tr:
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
    rows = digit_rows(params)
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
    int8 digits (:func:`digit_rows` rows: two a digit where it takes two
    limbs); the kernel on CUDA tensors, the plain twin on CPU."""
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
#: fused2 and scan, the overlap kernel's two stages
_DIGIT_TILES = {"split": 0, "tr": 0, "fused2": 1, "scan": 1, "overlap": 2,
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


#: shared memory a scan block holds beside the fused step's: its first
#: work item's 16 amounts
SCAN_EXTRA_BYTES = MMA_TILE_ROWS * 4


def scan_add_tile_fits(rows: int, n: int) -> bool:
    """Whether a scan block at (rows, N) also holds, in a launch that
    splits each tile's sum, the 16 x T tile of the accumulator (rows
    padded by 8 words) that the part holding pair 0 copies in while its
    product runs; where it does not, :func:`scan_launch` keeps each tile
    whole."""
    add = MMA_TILE_ROWS * (min(n, MMA_TILE_COLS) + 8) * 4
    return (mma_planes_bytes(n) + digit_tile_bytes(rows, n)
            + SCAN_EXTRA_BYTES + add <= SMEM_BLOCK_BYTES)


def kernels_refusal(mode: str, rows: int, n: int,
                    limbs: int = 1) -> str | None:
    """Why the kernels of step mode ``mode`` refuse ``rows`` TRGSW rows
    at ring degree ``n`` with ``limbs`` int8 limbs a digit, or None where
    they take the shape.  Two limbs run under ``split`` alone, at
    ``rows * limbs`` digit rows.  Every mode with kernels runs its
    products on the tensor-core tile, which needs N a power of two of at
    least 64 and rows * N below :data:`MMA_MAX_TERMS`; where a block
    keeps digit tiles in shared memory (fused2, scan, overlap) it needs
    room for them (scan also for :data:`SCAN_EXTRA_BYTES`), and under
    ``tr`` the rotation's slab (:func:`rot_tr_slab_bytes`) must fit a
    block; ``ntt`` runs no kernel."""
    if mode == "ntt":
        return None
    if limbs != 1:
        if mode != "split":
            return (f"the kernels of {mode} take single-limb digits "
                    f"(bg_bit <= 8); two int8 limbs a digit run under split")
        rows *= limbs
    tiles = _DIGIT_TILES[mode]
    if n < 64 or n & (n - 1):
        return (f"the tensor-core external product needs N a power of two "
                f">= 64, got N={n}")
    if rows * n >= MMA_MAX_TERMS:
        return (f"the tensor-core external product needs rows * N < "
                f"{MMA_MAX_TERMS} (each int8 limb's sum must stay exact in "
                f"int32), got rows={rows}, N={n}")
    need = mma_planes_bytes(n) + tiles * digit_tile_bytes(rows, n) + (
        SCAN_EXTRA_BYTES if mode == "scan" else 0)
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


def digit_limb_words_model(v: torch.Tensor, jl: int,
                           bg_bit: int) -> tuple:
    """``digit_limb_words`` of ``rot_diff_decompose.cu``: v (..., 4)
    words as int64 in [0, 2^32) -> (lo, hi) words, byte s of lo the
    sign-extended low byte d_lo of digit jl of v[..., s] and byte s of hi
    (d - d_lo) / 2^8."""
    shift = 32 - (jl + 1) * bg_bit
    d = ((v >> shift) & ((1 << bg_bit) - 1)) - (1 << (bg_bit - 1))
    d_lo = ((d & 0xFF) ^ 0x80) - 0x80
    d_hi = torch.div(d - d_lo, 256, rounding_mode="trunc")
    return tuple(sum((x[..., s] & 0xFF) << (8 * s) for s in range(4))
                 for x in (d_lo, d_hi))


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
    :func:`digit_word_model` and stored as one run, or with two limbs a
    digit (bg_bit > 8) the two rows' by :func:`digit_limb_words_model`, in
    rows 2p and 2p + 1.  Same arguments and result as
    :func:`rot_diff_decompose_plain`; every output byte is written
    once."""
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
    two = params.bg_bit > 8
    out = torch.zeros((digit_rows(params), b, n), dtype=torch.int8,
                      device=dev)
    written = torch.zeros(out.shape, dtype=torch.int32, device=dev)
    shifts = 8 * torch.arange(4, device=dev)
    vq = v.reshape(len(t), run // 4, 4)
    for jl in range(params.l):
        rows = (digit_limb_words_model(vq, jl, params.bg_bit) if two
                else (digit_word_model(vq, jl, params.bg_bit),))
        for h, words in enumerate(rows):                        # (t, R/4)
            digits = ((words[..., None] >> shifts) & 0xFF).reshape(len(t),
                                                                   run)
            p = ((u * params.l + jl) * len(rows) + h)[:, None]
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
    return kernels_refusal(mode, params.trgsw_rows, params.N,
                           params.digit_limbs) is None


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


def mma_planes(g: torch.Tensor, jb: int, ma: int, mcols: int,
               t: int | None = None) -> torch.Tensor:
    """``build_planes`` of the kernel for one key polynomial g (N,) int32,
    a tile of T coefficients (``t``; by default ``min(N, 256)``, the
    ``mma.sync`` tile's) whose first coefficient is ``jb`` and digit
    columns ``ma`` .. ``ma + mcols - 1``: int8 (4 limbs, 4 copies, T +
    mcols bytes), byte 4x + q of copy s of limb v = limb v of
    e[i0 - s - q] with i0 = N - 1 + jb + T - ma - 4x, e = concat(-g, g)
    and e[i] = 0 for i < 0."""
    n = g.shape[-1]
    t = min(n, MMA_TILE_COLS) if t is None else t
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


# The same product on Hopper's warpgroup MMA (csrc/wgmma_tile.cuh): a block
# of W consumer warpgroups beside a producer warpgroup, wgmma.mma_async
# m64nBNk32 s8 x s8 -> s32 with the Toeplitz limbs as the A operand from
# registers (the 64 rows of a wgmma are the four limbs of 16 coefficients:
# warp v of a warpgroup holds limb v) and the digits as the B operand from
# shared memory, staged by the tensor-memory accelerator in the swizzled
# layout the matrix descriptor reads; a plain model of each part, and the
# launch policy.

#: batch rows of a wgmma block's tile (the wgmma's n)
WG_BATCH_TILES = (32, 64)

#: chains of 16 coefficients a consumer warpgroup computes, one wgmma each
#: a k-step: its registers hold the accumulators, 4 x BN / 2, and the A
#: quads of two commit groups in flight, 2 x 4 x 2 k-steps x 4
WG_CHAINS = 4

#: digit columns one build of a wgmma block's byte planes covers
WG_SEG_COLS = 1024

#: the product's kernel forms: mma.sync m16n8k32 on the 16-row tile of
#: csrc/mma_tile.cuh, and wgmma on csrc/wgmma_tile.cuh's
PRODUCT_FORMS = ("mma", "wgmma")

#: batch x TRGSW rows up to which the mma.sync form's 16-row tile is the
#: faster one (tools/tile_bench.py's sweep on the H100, PERF.md: at 4 rows
#: up to B = 128, at 6 rows up to B = 64)
PRODUCT_MMA_MAX_WORK = 512


def wgmma_chunk_cols(n: int) -> int:
    """Digit columns a chunk of the wgmma form at ring degree ``n``: one
    stage of its ring, min(N, 256), issued as commit groups of 64
    columns."""
    return min(n, 256)


def wgmma_tiles(n: int) -> tuple:
    """The (batch rows, coefficients) tiles of the wgmma form at ring
    degree ``n`` (``wgmma_launch_for`` in csrc/external_product.cu): 32 or
    64 rows x min(N, 128) coefficients, a consumer warpgroup for each 64
    of them."""
    return tuple((bn, min(n, 128)) for bn in WG_BATCH_TILES)


def wgmma_window_index(c: int, r: int) -> int:
    """The entry of a warpgroup's window of 2 C + 2 plane words a k-step
    (C = :data:`WG_CHAINS`; entry i holds diagonal 4 ks - (2 C - 1) + i of
    k-step ks, in units of 8 coefficients) that A register ``r`` of its
    chain ``c`` takes: 2 C - 1 - 2 c + :data:`MMA_A_DIAGONALS` [r]."""
    return 2 * WG_CHAINS - 1 - 2 * c + MMA_A_DIAGONALS[r]


def wgmma_toeplitz_tile(planes: torch.Tensor, t: int,
                        mcols: int) -> torch.Tensor:
    """The Toeplitz limb tile as the wgmma block's A registers hold it,
    gathered from :func:`mma_planes` (T = ``t``) through the window of
    :func:`wgmma_window_index`: int8 (4 limbs, t, mcols), entry [v, jl,
    ml] = T_v[ml, jl].  Thread lane = 4 grp + t4 of warp v (limb v) of
    warpgroup g reads, for its chain c, k-step ks and register r, word
    ``t / 4 - 1 - 4 C g - grp // 4 + t4 + 2 (4 ks - (2 C - 1) +
    wgmma_window_index(c, r))`` (C = :data:`WG_CHAINS`) of copy
    ``3 - grp % 4`` of limb v: byte q is the operand at coefficient
    jl = 16 (C g + c) + 8 (r % 2) + grp, digit column ml = 32 ks +
    16 (r // 2) + 4 t4 + q."""
    jl, ml, copy, byte = (x.to(planes.device)
                          for x in _wgmma_a_gather(t, mcols))
    tile = torch.zeros((TORUS_LIMBS, t, mcols), dtype=torch.int8,
                       device=planes.device)
    tile[:, jl, ml] = planes[:, copy, byte]
    return tile


@functools.cache
def _wgmma_a_gather(t: int, mcols: int) -> tuple:
    """:func:`wgmma_toeplitz_tile`'s index map, flat: (jl, ml, copy, byte
    4 word + q) for every (warpgroup, chain, grp, k-step, register, t4,
    q)."""
    g, c, grp, ks, r, t4, q = torch.meshgrid(
        torch.arange(t // (16 * WG_CHAINS)), torch.arange(WG_CHAINS),
        torch.arange(8), torch.arange(mcols // 32), torch.arange(4),
        torch.arange(4), torch.arange(4), indexing="ij")
    entry = 2 * WG_CHAINS - 1 - 2 * c + torch.tensor(MMA_A_DIAGONALS)[r]
    word = (t // 4 - 1 - 4 * WG_CHAINS * g - grp // 4 + t4
            + 2 * (4 * ks - (2 * WG_CHAINS - 1) + entry))
    jl = 16 * (WG_CHAINS * g + c) + 8 * (r % 2) + grp
    ml = 32 * ks + 16 * (r // 2) + 4 * t4 + q
    return (jl.reshape(-1), ml.reshape(-1), (3 - grp % 4).reshape(-1),
            (4 * word + q).reshape(-1))


def wgmma_swizzle(kc: int) -> int:
    """The swizzle span, in bytes, of a wgmma stage of ``kc`` columns: the
    tensor-memory accelerator writes boxes of that many columns, 128 (64
    for chunks of 64 columns)."""
    return 128 if kc >= 128 else 64


def _swizzled(lin, sw: int):
    """A byte offset within a box with its 16-byte pieces permuted as the
    hardware's swizzle of span ``sw`` permutes them: bits 4.. xor bits
    7.. (3 bits at 128, 2 at 64); boxes start on the swizzle's atoms."""
    return lin ^ (((lin >> 7) & (sw // 16 - 1)) << 4)


def wgmma_stage_offset(row, col, bn: int, kc: int):
    """Byte offset of digit (batch row ``row``, column ``col`` of the chunk)
    in a stage of ``bn`` rows x ``kc`` columns as the tensor-memory
    accelerator writes it: box col // SW (SW = :func:`wgmma_swizzle`) of
    ``bn`` rows x SW bytes at (col // SW) * bn * SW, its rows SW bytes
    apart, the 16-byte pieces of a row swizzled (:func:`_swizzled`)."""
    sw = wgmma_swizzle(kc)
    return (col // sw) * bn * sw + _swizzled(row * sw + col % sw, sw)


def wgmma_stage_model(d: torch.Tensor, p: int, m0c: int, b0: int, bn: int,
                      kc: int) -> torch.Tensor:
    """The stage the tensor-memory accelerator fills for digit row p,
    columns m0c .. m0c + kc - 1 and batch rows b0 .. b0 + bn - 1 of d
    (rows, B, N) int8 (dimensions N, B, rows; boxes of SW x bn x 1):
    (bn * kc,) int8, rows past the batch zero."""
    stage = torch.zeros(bn * kc, dtype=torch.int8, device=d.device)
    nb = min(bn, d.shape[1] - b0)
    row = torch.arange(nb, device=d.device)[:, None]
    col = torch.arange(kc, device=d.device)[None, :]
    stage[wgmma_stage_offset(row, col, bn, kc).reshape(-1)] = \
        d[p, b0:b0 + nb, m0c:m0c + kc].reshape(-1)
    return stage


def wgmma_descriptor_reads(bn: int, kc: int, ks: int) -> torch.Tensor:
    """What the B matrix descriptor of k-step ``ks`` reads: (32, bn) int64
    of stage byte offsets, entry [k, n] = the byte the wgmma takes as
    B[k, n] (digit column 32 ks + k of batch row n).  The descriptor
    starts at box 32 ks // SW plus 32 ks % SW bytes, SBO = 8 SW, swizzle
    span SW; the hardware reads row n at (n // 8) SBO + (n % 8) SW, byte k
    of the k-step 32 ks % SW + k on, and swizzles the offset within its
    box (:func:`_swizzled`)."""
    sw = wgmma_swizzle(kc)
    k = torch.arange(32)[:, None]
    n = torch.arange(bn)[None, :]
    kb = 32 * ks
    lin = (n // 8) * 8 * sw + (n % 8) * sw + kb % sw + k
    return (kb // sw) * bn * sw + _swizzled(lin, sw)


def wgmma_fragment_rows(bn: int) -> torch.Tensor:
    """Where the wgmma's accumulator registers lie: (32 lanes, bn / 2, 2)
    int64 of (row, batch column) for register i of lane = 4 grp + t4 of a
    warp: row grp + 8 ((i // 2) % 2) of the warp's 16, column 8 (i // 4) +
    2 t4 + i % 2."""
    lane = torch.arange(32)[:, None]
    i = torch.arange(bn // 2)[None, :]
    rows = (lane // 4 + 8 * ((i // 2) % 2)).expand(32, bn // 2)
    cols = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return torch.stack([rows, cols], dim=-1)


#: words of a row of an epilogue slab: a warpgroup's 64 coefficients and 4
#: of padding, so that a warp's 32 stores of one fragment register fall on
#: 32 banks
WG_SLAB_PITCH = 16 * WG_CHAINS + 4


def wgmma_slab_words(bn: int) -> torch.Tensor:
    """The slab word each accumulator register of a warp is stored to:
    (4 chains, 32 lanes, bn / 2) int64, chain c's register at row = batch
    column b, column 16 c + its fragment row."""
    frag = wgmma_fragment_rows(bn)
    c = torch.arange(WG_CHAINS)[:, None, None]
    return frag[..., 1] * WG_SLAB_PITCH + 16 * c + frag[..., 0]


def wgmma_epilogue_model(sums: torch.Tensor) -> torch.Tensor:
    """The epilogue's fold: ``sums`` (4 limbs, T, bn) int32, limb v's sums
    as warp v of each warpgroup holds them, each register stored as
    (uint32) S_v << 8v to its warpgroup's slab v at
    :func:`wgmma_slab_words`, then each warpgroup's four slabs read back by
    16-byte quads and added (wrapping).  Returns (bn, T) int32, batch row
    by coefficient."""
    _, t, bn = sums.shape
    pitch = WG_SLAB_PITCH
    frag = wgmma_fragment_rows(bn)
    words = wgmma_slab_words(bn)
    out = []
    for g in range(t // (16 * WG_CHAINS)):
        total = torch.zeros(bn * pitch, dtype=torch.int32)
        for v in range(TORUS_LIMBS):
            slab = torch.zeros(bn * pitch, dtype=torch.int32)
            for c in range(WG_CHAINS):
                vals = sums[v, 16 * (WG_CHAINS * g + c) + frag[..., 0],
                            frag[..., 1]]
                slab[words[c].reshape(-1)] = (vals << (8 * v)).reshape(-1)
            total = total + slab
        out.append(total.reshape(bn, pitch)[:, :16 * WG_CHAINS])
    return torch.cat(out, dim=1)


class ProductLaunch(NamedTuple):
    """The external product's launch (:func:`product_launch`): the last
    arguments of ``ieache_external_product`` before the stream, and the
    blocks they make."""

    form: str    # "mma" (csrc/mma_tile.cuh) or "wgmma" (csrc/wgmma_tile.cuh)
    tile: int    # batch rows of a block's tile: 16, or a wgmma's n
    cols: int    # coefficients of a block's tile
    split: int   # parts of each tile's sum over its (p, chunk) pairs
    grid: int    # blocks


def product_shape(batch: int, kp1: int, n: int, rows: int, form: str,
                  tile: int, cols: int, split: int | None = None,
                  sms: int = 132) -> ProductLaunch:
    """The product's launch in ``form`` with ``tile`` batch rows x ``cols``
    coefficients a block, each tile's sum cut in ``split`` parts (by
    default :func:`mma_split_for`'s: the fewest that give each of ``sms``
    SMs a block, a divisor of a tile's (p, chunk) pairs)."""
    kc = min(n, MMA_TILE_COLS) if form == "mma" else wgmma_chunk_cols(n)
    tiles = -(-batch // tile) * (n // cols) * kp1
    if split is None:
        split = mma_split_for(tiles, rows * (n // kc), sms)
    return ProductLaunch(form, tile, cols, split, tiles * split)


def product_launch_shapes(batch: int, kp1: int, n: int, rows: int,
                          sms: int = 132) -> dict:
    """The launches :func:`product_launch` picks from, each with its
    default split: "mma" (the 16-row mma.sync tile) and "wgmma BN x T" for
    each tile of :func:`wgmma_tiles`."""
    shapes = {"mma": product_shape(batch, kp1, n, rows, "mma", MMA_TILE_ROWS,
                                   min(n, MMA_TILE_COLS), sms=sms)}
    for bn, cols in wgmma_tiles(n):
        shapes[f"wgmma {bn} x {cols}"] = product_shape(
            batch, kp1, n, rows, "wgmma", bn, cols, sms=sms)
    return shapes


@functools.cache
def product_launch(batch: int, kp1: int, n: int, rows: int,
                   sms: int = 132) -> ProductLaunch:
    """The launch of ``csrc/external_product.cu`` on a card of ``sms`` SMs,
    which the kernel takes as it is (each tile's sum split as
    :func:`product_shape` says).  Up to :data:`PRODUCT_MMA_MAX_WORK` batch
    x rows the mma.sync form: there a step is a chain of latencies, and
    its 16-row tile's shorter one wins.  Beyond, the wgmma form: its 64-row
    tile (one block an SM, twice the work of a 32-row block for less than
    twice the time) where its grid holds 1.4 waves or more and does not
    leave the last wave under 40% full, else the 32-row tile.  Set from
    tools/tile_bench.py's sweep of B = 8 .. 1056 at 4 and 6 rows (PERF.md):
    it picks the fastest shape or one within 6% of it."""
    if batch * rows <= PRODUCT_MMA_MAX_WORK:
        return product_shape(batch, kp1, n, rows, "mma", MMA_TILE_ROWS,
                             min(n, MMA_TILE_COLS), sms=sms)
    (narrow, cols), (wide, _) = wgmma_tiles(n)
    blocks = -(-batch // wide) * (n // cols) * kp1
    last = blocks % sms
    bn = wide if blocks >= 1.4 * sms and (last == 0 or last >= 0.4 * sms) \
        else narrow
    return product_shape(batch, kp1, n, rows, "wgmma", bn, cols, sms=sms)


def external_product_wgmma_model(d: torch.Tensor, bk_i: torch.Tensor,
                                 params: TFHEParams,
                                 acc: torch.Tensor | None = None,
                                 launch: ProductLaunch | None = None,
                                 sms: int = 132) -> torch.Tensor:
    """The wgmma form's arithmetic in plain ops, tile by tile, under
    ``launch`` (by default :func:`product_launch`'s on ``sms`` SMs): for
    each T x BN tile and each part of its (p, chunk) pairs, the planes of
    each key polynomial built per segment of up to :data:`MMA_SEG_CHUNKS`
    chunks, the A tile from :func:`wgmma_toeplitz_tile`, each chunk staged
    (:func:`wgmma_stage_model`) and read through the descriptor of each
    k-step (:func:`wgmma_descriptor_reads`), one int32 sum per limb, the
    epilogue's fold (:func:`wgmma_epilogue_model`), and the part added to
    the output (wrapping), which holds acc or zero.  Same arguments and
    result as :func:`external_product_plain`."""
    rows, kp1, n = bk_i.shape
    _refuse(kernels_refusal("split", rows, n))
    b = d.shape[1]
    launch = launch or product_launch(b, kp1, n, rows, sms)
    bn, t, split = launch.tile, launch.cols, launch.split
    kc = wgmma_chunk_cols(n)
    nchunk = n // kc
    nchunks = rows * nchunk
    out = (torch.zeros((kp1, b, n), dtype=torch.int32, device=d.device)
           if acc is None else acc.clone())
    # the chunk's k-steps' descriptor reads, k-step after k-step: (kc, bn)
    reads = torch.cat([wgmma_descriptor_reads(bn, kc, ks)
                       for ks in range(kc // 32)])
    for o in range(kp1):
        for jb in range(0, n, t):
            for b0 in range(0, b, bn):
                nb = min(bn, b - b0)
                for q in range(split):
                    c, c_end = q * nchunks // split, (q + 1) * nchunks // split
                    sums = torch.zeros((TORUS_LIMBS, t, bn),
                                       dtype=torch.int32, device=d.device)
                    while c < c_end:
                        p, ch0 = c // nchunk, c % nchunk
                        nseg = min(c_end - c, nchunk - ch0,
                                   WG_SEG_COLS // kc)
                        tile = wgmma_toeplitz_tile(
                            mma_planes(bk_i[p, o], jb, ch0 * kc, nseg * kc,
                                       t=t),
                            t, nseg * kc).to(torch.int32)
                        for i in range(nseg):
                            stage = wgmma_stage_model(d, p, (ch0 + i) * kc,
                                                      b0, bn, kc)
                            sums += torch.einsum(
                                "vjk,kn->vjn",
                                tile[:, :, i * kc:(i + 1) * kc],
                                stage[reads].to(torch.int32))
                        c += nseg
                    out[o, b0:b0 + nb, jb:jb + t] += \
                        wgmma_epilogue_model(sums)[:nb]
    return out


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
    out = _gmatrix_product(d, br.make_step_gmatrix(bk_i, params), params)
    return (out if acc is None else acc + out).contiguous()


def _gmatrix_product(d: torch.Tensor, g: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """sum_p d[p] ⊛ BK_i[p, o] from BK_i's Toeplitz limb operand ``g``
    (``make_step_gmatrix``): d (rows, B, N) int8 -> (k+1, B, N) int32."""
    d8 = d.transpose(0, 1)                           # (B, rows, N)
    out = torch.zeros((d8.shape[0], params.k + 1, params.N),
                      dtype=torch.int32, device=d.device)
    for v in range(TORUS_LIMBS):
        out = out + (br._dot_digits_g(d8, g[v]) << (8 * v))
    return out.transpose(0, 1)


def _external_product_launch(wrapper, entry: str, plain, d: torch.Tensor,
                             bk_i: torch.Tensor, params: TFHEParams,
                             acc: torch.Tensor | None,
                             tr: bool) -> torch.Tensor:
    """Both external-product wrappers' body, in the (k+1, N, B) layout
    when ``tr`` else (k+1, B, N): the C entry point ``entry`` on CUDA
    tensors, counted on ``wrapper``, or ``plain`` on CPU tensors.  Two-limb
    digits are taken only in the (k+1, B, N) layout, at
    :func:`digit_rows` rows of ``d`` and of the :func:`limb_key` row
    ``bk_i``."""
    if tr:
        _require_single_limb(params)
    rows, kp1, n = digit_rows(params), params.k + 1, params.N
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
    if b == 0:
        return torch.empty((kp1, *shape), dtype=torch.int32, device=d.device)
    lib, stream = _launch_context(d)
    if tr:
        out = torch.empty((kp1, *shape), dtype=torch.int32, device=d.device)
        code = getattr(lib, entry)(
            d.data_ptr(), bk_i.data_ptr(),
            None if acc is None else acc.data_ptr(), out.data_ptr(),
            rows, kp1, b, n, stream,
        )
        _build.check(lib, code, entry)
    else:
        out = _external_product_entry(
            d, bk_i, params, acc,
            product_launch(b, kp1, n, rows, _sm_count(d.device)))
    wrapper.launches += 1
    return out


def _external_product_entry(d: torch.Tensor, bk_i: torch.Tensor,
                            params: TFHEParams, acc: torch.Tensor | None,
                            launch: ProductLaunch) -> torch.Tensor:
    """One launch of ``ieache_external_product`` on checked CUDA tensors
    with the launch shape ``launch``, uncounted: the wrapper's launch, and
    the one chip_smoke and ``tools/tile_bench.py`` give every form, batch
    tile and split by."""
    rows, kp1, n = digit_rows(params), params.k + 1, params.N
    b = d.shape[1]
    out = torch.empty((kp1, b, n), dtype=torch.int32, device=d.device)
    lib, stream = _launch_context(d)
    code = lib.ieache_external_product(
        d.data_ptr(), bk_i.data_ptr(),
        None if acc is None else acc.data_ptr(), out.data_ptr(),
        rows, kp1, b, n, PRODUCT_FORMS.index(launch.form), launch.tile,
        launch.cols, launch.split, stream,
    )
    _build.check(lib, code, "external_product")
    return out


def external_product_as(d: torch.Tensor, bk_i: torch.Tensor,
                        params: TFHEParams, acc: torch.Tensor | None,
                        launch: ProductLaunch) -> torch.Tensor:
    """The product under ``launch``, uncounted, whatever the policy picks:
    :func:`_external_product_entry` on CUDA tensors, the plain model of
    that form on CPU tensors (:func:`external_product_wgmma_model`, or
    :func:`external_product_mma_model`).  chip_smoke and
    ``tools/tile_bench.py`` hold every launch shape to the twin by it."""
    if d.is_cuda:
        return _external_product_entry(d, bk_i, params, acc, launch)
    if launch.form == "wgmma":
        return external_product_wgmma_model(d, bk_i, params, acc,
                                            launch=launch)
    return external_product_mma_model(d, bk_i, params, acc)


def external_product(d: torch.Tensor, bk_i: torch.Tensor, params: TFHEParams,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc + sum_p d[p] ⊛ bk_i[p, o], negacyclic, exact mod 2^32:
    d (rows, B, N) int8, bk_i (rows, k+1, N) int32, acc (k+1, B, N)
    int32 or None -> (k+1, B, N) int32, rows :func:`digit_rows` (with two
    limbs a digit, ``bk_i`` a step of :func:`limb_key`); the kernel on CUDA
    tensors (which raises ``ValueError`` for a shape :func:`mma_tile_check`
    refuses), launched as :func:`product_launch` says, the plain twin on
    CPU."""
    return _external_product_launch(
        external_product, "ieache_external_product", external_product_plain,
        d, bk_i, params, acc, tr=False)


external_product.launches = 0


# ---------------------------------------------------------------------------
# the keyswitch: csrc/keyswitch.cu, its launch and a plain model of it
# ---------------------------------------------------------------------------

#: key rows a stage of the keyswitch kernel holds: the unit of its K split
KS_UNIT_ROWS = 64
#: stages of a block's ring, each one bulk copy in flight
KS_STAGES = 4
#: bytes past a stage's rows that the last column strip reads (M < 32 w)
KS_STAGE_PAD = 32
#: columns of a warp's strip: four 8-column MMA tiles
KS_STRIP_COLS = 32
#: warps of a block, one strip each, so M <= 512
KS_MAX_STRIPS = 16
#: lanes of a block's tile: one, two or four 16-row MMA tiles
KS_TILE_LANES = (16, 32, 64)
#: words a row of a warp's epilogue tile: 32 columns and 4 of padding
KS_EPI_PITCH = 36
#: the stages' mbarriers at the start of shared memory, then alignment
KS_BAR_BYTES = 128


class KeyswitchLaunch(NamedTuple):
    """The keyswitch kernel's launch (:func:`keyswitch_launch`): the last
    arguments of ``ieache_keyswitch`` before the stream, and the blocks
    they make."""

    lanes: int   # lanes of a block's tile: 16, 32 or 64
    split: int   # K-slices: parts of each output's sum, added atomically
    grid: int    # blocks: lane tiles x K-slices

    @property
    def form(self) -> str:
        """The launch as the ``keyswitch`` span's ``form`` names it."""
        return f"{self.lanes} lanes x {self.split} slices"


def keyswitch_cols(params: TFHEParams) -> int:
    """M, the columns of the packed key: n+1 rounded up to 8."""
    return -(-(params.n + 1) // 8) * 8


def keyswitch_units(params: TFHEParams) -> int:
    """The key's kN·t rows in units of :data:`KS_UNIT_ROWS` (the last
    may be short)."""
    return -(-(params.kN * params.ks_t) // KS_UNIT_ROWS)


def keyswitch_refusal(params: TFHEParams, m: int) -> str | None:
    """Why ``csrc/keyswitch.cu`` refuses ``params`` with a key of ``m``
    columns, or None: digits of more than 8 bits (no int8), an odd
    number of key rows (a unit's bulk copy moves 16-byte pieces), or M
    not a multiple of 8 in [n+1, 512] (a warp's strip a column group)."""
    if params.ks_basebit > 8:
        return (f"keyswitch kernel: digits of {params.ks_basebit} bits do "
                f"not fit int8")
    if (params.kN * params.ks_t) % 2:
        return "keyswitch kernel: an odd number of key rows"
    if m % 8 or not params.n + 1 <= m <= KS_STRIP_COLS * KS_MAX_STRIPS:
        return (f"keyswitch kernel: M = {m} columns, wants a multiple of 8 "
                f"in [n+1, {KS_STRIP_COLS * KS_MAX_STRIPS}]")
    return None


def keyswitch_slice(units: int, split: int, s: int) -> tuple:
    """Units [u0, u1) of K-slice ``s`` of ``split``."""
    return s * units // split, (s + 1) * units // split


def keyswitch_smem_bytes(m: int, lanes: int, units: int) -> int:
    """Shared memory of a block whose K-slice holds ``units`` units: the
    mbarriers, then the ring of staged key rows and the slice's digits,
    which the warps' epilogue tiles reuse at the end."""
    ring = KS_STAGES * (KS_UNIT_ROWS * m + KS_STAGE_PAD)
    digits = units * KS_UNIT_ROWS * lanes
    epi = -(-m // KS_STRIP_COLS) * 16 * KS_EPI_PITCH * 4
    return KS_BAR_BYTES + max(ring + digits, epi)


def keyswitch_shape(batch: int, params: TFHEParams, lanes: int,
                    split: int | None = None,
                    sms: int = 132) -> KeyswitchLaunch:
    """The keyswitch's launch with ``lanes`` lanes a tile and the key's
    rows cut in ``split`` K-slices.  By default the most slices that keep
    the grid within one block an SM (a block's ring holds 129 KB of
    shared memory at λ=110: one block an SM), at most one a unit; where
    the fewest slices whose digits fit a block's shared memory already
    make more blocks than SMs, the most that fill whole waves of them."""
    units = keyswitch_units(params)
    tiles = max(-(-batch // lanes), 1)
    if split is None:
        ring = keyswitch_smem_bytes(keyswitch_cols(params), lanes, 0)
        least = -(-units // ((SMEM_BLOCK_BYTES - ring)
                             // (KS_UNIT_ROWS * lanes)))
        split = sms // tiles
        if split < least:
            split = -(-tiles * least // sms) * sms // tiles
        split = min(units, max(split, least, 1))
    return KeyswitchLaunch(lanes, split, -(-batch // lanes) * split)


def keyswitch_launch_shapes(batch: int, params: TFHEParams,
                            sms: int = 132) -> dict:
    """The launches :func:`keyswitch_launch` picks from: "L lanes" for each
    tile of :data:`KS_TILE_LANES`, each with its default split."""
    return {f"{t} lanes": keyswitch_shape(batch, params, t, sms=sms)
            for t in KS_TILE_LANES}


#: the most lanes a wave has for which :func:`keyswitch_launch` takes the
#: 16-lane tile, and the 32-lane one (tile_bench's sweep, PERF.md §6)
KS_LANES_16_UP_TO = 64
KS_LANES_32_UP_TO = 128


@functools.cache
def keyswitch_launch(batch: int, params: TFHEParams,
                     sms: int = 132) -> KeyswitchLaunch:
    """The launch of ``csrc/keyswitch.cu`` for a wave of ``batch`` lanes on
    a card of ``sms`` SMs: the 16-lane tile up to
    :data:`KS_LANES_16_UP_TO` lanes, the 32-lane tile up to
    :data:`KS_LANES_32_UP_TO`, the 64-lane tile beyond; the split as
    :func:`keyswitch_shape` says.  A block's time follows its slice's
    units times its tile's MMAs, which is about the batch over the SMs
    whatever the tile; what differs is that a wider tile reads the key
    fewer times (from L2) and makes its digits in fewer, larger blocks.
    At small batches the narrow tile's lighter blocks win, at large ones
    the fewer reads.  Set from tools/tile_bench.py's sweep of B = 1 ..
    2048 at λ=110: it picks the fastest tile or one within 8% of it (B =
    17), 16 lanes x 128 slices at one lane, 64 lanes x 8 slices at 1024
    lanes."""
    lanes = (16 if batch <= KS_LANES_16_UP_TO
             else 32 if batch <= KS_LANES_32_UP_TO else 64)
    return keyswitch_shape(batch, params, lanes, sms=sms)


def keyswitch_digit_words(lwe_ext: torch.Tensor, params: TFHEParams,
                          b0: int, lanes: int, k0: int, rows: int,
                          ksteps: int) -> torch.Tensor:
    """The digits a block writes to shared memory before its MMAs, as
    words held as int64 in [0, 2^32): (ksteps, lanes / 16, 32, 4), word
    [kk, mt, lane, r] register r of the A fragment of thread ``lane`` for
    k-step kk of the slice and the 16 lanes b0 + 16 mt ..: byte i the
    digit of lane b0 + 16 mt + lane / 4 + 8 (r & 1) at key row
    k0 + 32 kk + 4 (lane % 4) + 16 (r >> 1) + i, decomposed from its
    mask word as ``ops/decompose.gadget_decompose`` does (offset
    included); 0 past the batch and past the slice's ``rows``."""
    p = params
    batch, t, bb = lwe_ext.shape[0], p.ks_t, p.ks_basebit
    kk, mt, ln, r, i = (torch.arange(x).view(
        [-1 if a == j else 1 for j in range(5)])
        for a, x in enumerate((ksteps, lanes // 16, 32, 4, 4)))
    b = b0 + 16 * mt + ln // 4 + 8 * (r % 2)
    k = 32 * kk + 4 * (ln % 4) + 16 * (r // 2) + i
    valid = (b < batch) & (k < rows)
    kg = k0 + k
    x = lwe_ext[b.clamp(max=max(batch - 1, 0)), (kg // t).clamp(max=p.kN - 1)]
    v = (_u32(x) + _offset(bb, t)) & 0xFFFFFFFF
    d = ((v >> (32 - (kg % t + 1) * bb)) & ((1 << bb) - 1)) - (1 << (bb - 1))
    d = torch.where(valid, d, 0)
    return ((d & 0xFF) << (8 * i)).sum(-1)


def keyswitch_stage_model(ks_limbs: torch.Tensor, v: int, row0: int,
                          rows: int, fill: int = 0x5A) -> torch.Tensor:
    """A stage's bytes after its bulk copy, as int64 in [0, 256):
    (KS_UNIT_ROWS · M + KS_STAGE_PAD,), key rows row0 .. row0 + rows - 1
    of limb v as they lie in memory (M bytes a row), the rest what the
    stage held before, ``fill`` here: the kernel reads it only against
    zero digits (rows past the slice) or into columns past M, which it
    never writes."""
    m = ks_limbs.shape[-1]
    stage = torch.full((KS_UNIT_ROWS * m + KS_STAGE_PAD,), fill,
                       dtype=torch.int64)
    stage[: rows * m] = ks_limbs[v, row0:row0 + rows].reshape(-1).to(
        torch.int64) & 0xFF
    return stage


def keyswitch_key_words(stage: torch.Tensor, m: int,
                        strips: int) -> torch.Tensor:
    """The B fragments the warps build from a stage, words held as int64
    in [0, 2^32): (2, strips, 32, 4, 2), [ks, w, lane, c, h] register h
    of 8-column tile c at k-step ks of warp w.  Thread lane = 4 g + q
    loads the word at bytes 32 w + 4 g of each of the rows
    32 ks + 16 h + 4 q + i (i = 0..3) and transposes the four by four
    byte permutes in two rounds: byte i of tile c's register is byte c of
    row i's word, the key at that row and column 32 w + 4 g + c.  So a
    tile's fragment column g is the strip's column 4 g + c: the tiles
    interleave, and the epilogue puts the columns back in order."""
    ks, w, ln, h, i = (torch.arange(x).view(
        [-1 if a == j else 1 for j in range(5)])
        for a, x in enumerate((2, strips, 32, 2, 4)))
    off = (32 * ks + 16 * h + 4 * (ln % 4) + i) * m + 32 * w + 4 * (ln // 4)
    word = sum(stage[off + e] << (8 * e) for e in range(4))
    w0, w1, w2, w3 = word.unbind(-1)                       # (2, strips, 32, 2)
    x, y = byte_perm(w0, w1, 0x5140), byte_perm(w0, w1, 0x7362)
    z, u = byte_perm(w2, w3, 0x5140), byte_perm(w2, w3, 0x7362)
    return torch.stack([byte_perm(x, z, 0x5410), byte_perm(x, z, 0x7632),
                        byte_perm(y, u, 0x5410), byte_perm(y, u, 0x7632)],
                       dim=3)


def _signed_bytes(w: torch.Tensor) -> torch.Tensor:
    """Words as int64 in [0, 2^32) -> their four bytes as int8 values,
    a new last axis."""
    b = (w.unsqueeze(-1) >> (8 * torch.arange(4))) & 0xFF
    return (b ^ 0x80) - 0x80


def mma_s8_model(a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` on a warp's fragments,
    words held as int64 in [0, 2^32): a (..., 32, 4), b (..., 32, 2), c
    (..., 32, 4) -> d = A·B + C (..., 32, 4), wrapping mod 2^32 (no
    .satfinite).  Thread 4 g + q holds A[g + 8 (r & 1), 4 q + 16 (r >> 1)
    + i] in byte i of a[r], B[4 q + 16 h + i, g] in byte i of b[h] and
    C[g + 8 (r >> 1), 2 q + (r & 1)] in c[r] (PTX's fragment layout, as
    ``csrc/mma_tile.cuh`` uses it)."""
    ln, r, i = torch.arange(32).view(32, 1, 1), torch.arange(4).view(
        1, 4, 1), torch.arange(4).view(1, 1, 4)
    g, q = ln // 4, ln % 4
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2], c.shape[:-2])
    am = torch.zeros((*lead, 16, 32), dtype=torch.int64)
    am[..., g + 8 * (r % 2), 4 * q + 16 * (r // 2) + i] = _signed_bytes(a)
    h = torch.arange(2).view(1, 2, 1)
    bm = torch.zeros((*lead, 32, 8), dtype=torch.int64)
    bm[..., 4 * q + 16 * h + i, g.expand(32, 2, 4)] = _signed_bytes(b)
    d = am @ bm
    rr = torch.arange(4).view(1, 4)
    return (c + d[..., ln.view(32, 1) // 4 + 8 * (rr // 2),
                  2 * (ln.view(32, 1) % 4) + rr % 2]) & 0xFFFFFFFF


def keyswitch_epilogue_model(acc: torch.Tensor) -> torch.Tensor:
    """The warps' epilogue: accumulators (lanes / 16, strips, 4, 32, 4),
    [mt, w, c, lane, r] register r of tile c, through each warp's 16 x
    :data:`KS_EPI_PITCH` words of shared memory one 16-lane tile at a
    time: thread 4 g + q stores register r of its four tiles as one
    16-byte word at row g + 8 (r >> 1), word 8 q + 4 (r & 1), which is
    the columns 8 q + 4 (r & 1) + c in order (:func:`keyswitch_key_words`);
    then lane l reads word l of each row.  Returns the block's
    (lanes, 32 strips) sums, column 32 w + l."""
    mts, strips = acc.shape[:2]
    ln, r, c = (torch.arange(x).view([-1 if a == j else 1 for j in range(3)])
                for a, x in enumerate((32, 4, 4)))
    epi = torch.zeros((mts, strips, 16, KS_EPI_PITCH), dtype=torch.int64)
    epi[..., ln // 4 + 8 * (r // 2), 8 * (ln % 4) + 4 * (r % 2) + c] = \
        acc.permute(0, 1, 3, 4, 2)
    return epi[..., :KS_STRIP_COLS].permute(0, 2, 1, 3).reshape(
        16 * mts, strips * KS_STRIP_COLS)


def keyswitch_part_model(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
                         params: TFHEParams, launch: KeyswitchLaunch,
                         s: int, tile: int, fill: int = 0x5A
                         ) -> torch.Tensor:
    """What block (K-slice ``s``, lane tile ``tile``) of ``launch`` adds to
    the output, modelled at the level of the warps' fragments: the
    slice's digits (:func:`keyswitch_digit_words`); the ring's chunks,
    limb 3 first, each unit's rows of one limb staged as the bulk copy
    leaves them (:func:`keyswitch_stage_model`); at each new limb the
    accumulators shifted left by 8 (Horner: ((S3·2^8 + S2)·2^8 + S1)·2^8
    + S0 = Σ_v S_v·2^(8v) mod 2^32, S_v the limb's sum), then the
    stage's two k-steps of MMAs (:func:`keyswitch_key_words`,
    :func:`mma_s8_model`); the epilogue (:func:`keyswitch_epilogue_model`)
    and its atomic add of minus the sum, the body added at column n by
    slice 0 alone.  Returns (lanes of the tile within the batch, n+1)
    words as int64 in [0, 2^32)."""
    p = params
    batch, m = lwe_ext.shape[0], ks_limbs.shape[-1]
    krows, units = p.kN * p.ks_t, keyswitch_units(p)
    u0, u1 = keyswitch_slice(units, launch.split, s)
    nu, strips = u1 - u0, -(-m // KS_STRIP_COLS)
    k0, b0 = u0 * KS_UNIT_ROWS, tile * launch.lanes
    a = keyswitch_digit_words(lwe_ext, p, b0, launch.lanes, k0,
                              min(u1 * KS_UNIT_ROWS, krows) - k0, 2 * nu)
    acc = torch.zeros((launch.lanes // 16, strips, 4, 32, 4),
                      dtype=torch.int64)
    for c in range(4 * nu):
        v, u = 3 - c // nu, u0 + c % nu
        if c and c % nu == 0:
            acc = (acc << 8) & 0xFFFFFFFF
        row0 = u * KS_UNIT_ROWS
        stage = keyswitch_stage_model(ks_limbs, v, row0,
                                      min(KS_UNIT_ROWS, krows - row0), fill)
        bw = keyswitch_key_words(stage, m, strips).transpose(2, 3)
        for ks in range(2):
            acc = mma_s8_model(a[2 * (c % nu) + ks][:, None, None],
                               bw[ks][None], acc)
    nb = min(launch.lanes, batch - b0)
    part = -keyswitch_epilogue_model(acc)[:nb, : p.n + 1] & 0xFFFFFFFF
    if s == 0:
        part[:, p.n] = (part[:, p.n] + _u32(lwe_ext[b0:b0 + nb, p.kN])) \
            & 0xFFFFFFFF
    return part


def keyswitch_kernel_model(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
                           params: TFHEParams,
                           launch: KeyswitchLaunch | None = None,
                           sms: int = 132, order=None) -> torch.Tensor:
    """``csrc/keyswitch.cu`` in plain ops on CPU tensors under ``launch``
    (by default :func:`keyswitch_launch`'s on ``sms`` SMs): the zeroed
    output, then every block's part (:func:`keyswitch_part_model`) added
    wrapping, in ``order`` (a sequence of the grid's (slice, tile) pairs;
    by default slice-major), as the atomic adds land in any order.  Same
    arguments and result as ``ops/keyswitch.keyswitch_plain``."""
    p = params
    batch = lwe_ext.shape[0]
    _refuse(keyswitch_refusal(p, ks_limbs.shape[-1]))
    launch = launch or keyswitch_launch(batch, p, sms)
    tiles = -(-batch // launch.lanes)
    out = torch.zeros((batch, p.n + 1), dtype=torch.int64)
    for s, tile in order or [(s, t) for s in range(launch.split)
                             for t in range(tiles)]:
        b0 = tile * launch.lanes
        part = keyswitch_part_model(lwe_ext, ks_limbs, p, launch, s, tile)
        out[b0:b0 + part.shape[0]] = (out[b0:b0 + part.shape[0]] + part) \
            & 0xFFFFFFFF
    return ((out ^ 0x80000000) - 0x80000000).to(torch.int32)


def _keyswitch_entry(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
                     params: TFHEParams,
                     launch: KeyswitchLaunch) -> torch.Tensor:
    """One launch of ``ieache_keyswitch`` (after its zeroing of the
    output) on checked CUDA tensors with the launch shape ``launch``,
    uncounted: ``ops/keyswitch.keyswitch``'s launch, and the one
    chip_smoke and ``tools/tile_bench.py`` give every tile by."""
    p = params
    b = lwe_ext.shape[0]
    out = torch.empty((b, p.n + 1), dtype=torch.int32, device=lwe_ext.device)
    if b == 0:
        return out
    lib, stream = _launch_context(lwe_ext)
    code = lib.ieache_keyswitch(
        lwe_ext.data_ptr(), ks_limbs.data_ptr(), out.data_ptr(), b, p.kN,
        p.ks_t, p.ks_basebit, _offset(p.ks_basebit, p.ks_t),
        ks_limbs.shape[-1], p.n, launch.lanes, launch.split, stream)
    _build.check(lib, code, "keyswitch")
    return out


def keyswitch_as(lwe_ext: torch.Tensor, ks_limbs: torch.Tensor,
                 params: TFHEParams,
                 launch: KeyswitchLaunch) -> torch.Tensor:
    """The keyswitch under ``launch``, uncounted, whatever the policy
    picks: :func:`_keyswitch_entry` on CUDA tensors, the plain model
    (:func:`keyswitch_kernel_model`) on CPU tensors.  chip_smoke and
    ``tools/tile_bench.py`` hold every tile to the twin by it."""
    if lwe_ext.is_cuda:
        return _keyswitch_entry(lwe_ext, ks_limbs, params, launch)
    return keyswitch_kernel_model(lwe_ext, ks_limbs, params, launch)


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


def step_work_items(batch: int, n: int, kp1: int, places: int,
                    per_item: int | None = None) -> list:
    """The step kernels' work items in their order, as (b0, [(jb, o),
    ...]): 16 batch rows from b0 and a run of ``per_item`` (by default
    :func:`tiles_per_item`'s on ``places``) of their N/T x (k+1) output
    tiles, tile t at coefficient jb = (t % (N/T)) * T of component
    o = t // (N/T).  Under fused2 item (x, y) is block (x, y) of the
    grid; block x of the overlap kernel's grid of g takes items x,
    x + g, ..."""
    t = min(n, MMA_TILE_COLS)
    njt = n // t
    nbt, group = -(-batch // MMA_TILE_ROWS), njt * kp1
    per = tiles_per_item(nbt, group, places) if per_item is None \
        else per_item
    return [(bt * MMA_TILE_ROWS,
             [((tl % njt) * t, tl // njt)
              for tl in range(t0, min(t0 + per, group))])
            for bt in range(nbt) for t0 in range(0, group, per)]


class ScanLaunch(NamedTuple):
    """The scan kernel's launch shape (:func:`scan_launch`): but the
    tile, which follows from the form, the last arguments of
    ``ieache_blind_rotate_scan`` before the stream."""

    split: int      # parts of each tile's sum over its (p, chunk) pairs
    per_item: int   # output tiles a block computes from one decomposition
    grid: int       # blocks, every one resident at once
    cluster: int    # blocks a thread-block cluster
    form: str = "mma"   # the step's form: "mma" or "wgmma" (STEP_FORMS)
    tile: int = MMA_TILE_ROWS   # batch rows of a block's tile


def scan_shape(batch: int, kp1: int, n: int, split: int, per_item: int,
               places: int) -> ScanLaunch:
    """The scan kernel's launch with each tile's sum cut in ``split``
    parts and runs of ``per_item`` output tiles a work item, on a card
    that holds ``places`` of its blocks at once: with one part a tile the
    runs of a row group paired in clusters, as fused2 pairs them
    (:func:`step_cluster_shares`); a grid of every work item, or of as
    many blocks as are resident at once, in whole clusters."""
    group = n // min(n, MMA_TILE_COLS) * kp1
    nbt = -(-batch // MMA_TILE_ROWS)
    nper = -(-group // per_item)
    cluster = len(step_cluster_shares(nper, split))
    grid = min(nbt * split * nper, places // cluster * cluster)
    return ScanLaunch(split, per_item, grid, cluster)


def scan_wgmma_shape(batch: int, kp1: int, n: int, tile: int, cluster: int,
                     clusters: int) -> ScanLaunch:
    """The scan kernel's wgmma form: ``tile`` rows x min(N, 128)
    coefficients a block, each tile whole, the blocks of a batch tile in
    clusters of ``cluster`` (a cluster's work item: one tile a rank), a
    grid of every item's cluster or of the ``clusters`` the card holds at
    once, whichever is fewer."""
    group = n // min(n, 128) * kp1
    items = -(-batch // tile) * (group // cluster)
    return ScanLaunch(1, 1, min(items, clusters) * cluster, cluster, "wgmma",
                      tile)


#: the fewest lanes at which the scan takes its wgmma form: at B=257 the
#: mma.sync form's last 16-row tile holds one lane, the blocks that share
#: an SM are light, and at 4 rows it won (tools/tile_bench.py on the H100,
#: PERF.md); from 272 lanes the wgmma form won wherever the step takes it
SCAN_WGMMA_MIN_BATCH = 272


def scan_launch(batch: int, kp1: int, n: int, rows: int, sms: int = 132,
                per_sm: int = 2, resident: tuple | None = None) -> ScanLaunch:
    """The launch of ``csrc/blind_rotate_scan.cu`` on a card of ``sms``
    SMs that hold ``per_sm`` of its mma.sync form's blocks each, which the
    kernel takes as it is.  Where the fused step takes its wgmma form
    (:func:`step_launch`, on ``resident``, the scan kernel's (cluster,
    clusters held at once) pairs) and the batch has at least
    :data:`SCAN_WGMMA_MIN_BATCH` lanes, the scan's
    (:func:`scan_wgmma_shape`): the same tile and cluster, a grid of the
    clusters held at once.  Else
    :func:`scan_shape`: a step is fused2's
    work over the whole grid: each tile's sum cut in :func:`mma_split_for`
    parts while the tiles are fewer than the SMs; the output tiles of each
    row group, or of each part, cut into runs of ``per_item``
    (:func:`tiles_per_item` over the row groups times the parts, dealt to
    the ``sms * per_sm`` places), a run being one block's work item from
    one decomposition; each tile whole where :func:`scan_add_tile_fits`
    says no.  Of every split and run tools/tile_bench.py times beside it
    on the H100, none was faster at B = 8, 16, 256 or 1024, and one by
    0.4% at 272 (PERF.md)."""
    step = step_launch(batch, kp1, n, rows, sms, per_sm, resident)
    if step.form == "wgmma" and batch >= SCAN_WGMMA_MIN_BATCH:
        return scan_wgmma_shape(batch, kp1, n, step.tile, step.cluster,
                                _resident(sms, resident)[step.cluster])
    return _scan_mma_launch(batch, kp1, n, rows, sms, per_sm)


def _scan_mma_launch(batch: int, kp1: int, n: int, rows: int, sms: int,
                     per_sm: int) -> ScanLaunch:
    """:func:`scan_launch`'s mma.sync form (:func:`scan_shape`)."""
    t = min(n, MMA_TILE_COLS)
    nbt, group = -(-batch // MMA_TILE_ROWS), n // t * kp1
    split = (mma_split_for(nbt * group, rows * (n // t), sms)
             if scan_add_tile_fits(rows, n) else 1)
    places = sms * per_sm
    return scan_shape(batch, kp1, n, split,
                      tiles_per_item(nbt * split, group, places), places)


def scan_launch_shapes(batch: int, kp1: int, n: int, rows: int,
                       sms: int = 132, per_sm: int = 2,
                       resident: tuple | None = None) -> dict:
    """The launches :func:`scan_launch` picks from: "mma" (its mma.sync
    form's) and "wgmma BN x T, cluster c" (BN = :data:`WG_STEP_TILE`) for
    each cluster of :func:`wgmma_step_clusters`, on a grid of the clusters
    held at once (``resident``, as :func:`step_launch` takes it)."""
    shapes = {"mma": _scan_mma_launch(batch, kp1, n, rows, sms, per_sm)}
    if wgmma_step_refusal(rows, kp1, n) is not None:
        return shapes
    held = _resident(sms, resident)
    for c in wgmma_step_clusters(WG_STEP_TILE, n, kp1, rows // kp1):
        shapes[f"wgmma {WG_STEP_TILE} x {min(n, 128)}, cluster {c}"] = \
            scan_wgmma_shape(batch, kp1, n, WG_STEP_TILE, c, held[c])
    return shapes


def scan_work_items(launch: ScanLaunch, batch: int, n: int,
                    kp1: int) -> list:
    """The work items of one scan step in the kernel's order, as (b0, q,
    tiles): batch rows b0 .. b0 + 15, part q of the split, and the
    output tiles [(jb, o), ...] of the item's run (run y of a row group
    is block y % cluster of its cluster).  Under the wgmma form an item
    is a cluster's: batch rows b0 .. b0 + tile - 1 and one tile a rank,
    rank r's at [r]."""
    if launch.form == "wgmma":
        t = min(n, 128)
        njt = n // t
        group = njt * kp1
        return [(bt * launch.tile, 0,
                 [((tl % njt) * t, tl // njt)
                  for tl in range(y * launch.cluster,
                                  (y + 1) * launch.cluster)])
                for bt in range(-(-batch // launch.tile))
                for y in range(group // launch.cluster)]
    t = min(n, MMA_TILE_COLS)
    njt = n // t
    nbt, group = -(-batch // MMA_TILE_ROWS), njt * kp1
    per = launch.per_item
    return [(bt * MMA_TILE_ROWS, q,
             [((tl % njt) * t, tl // njt)
              for tl in range(y * per, min((y + 1) * per, group))])
            for bt in range(nbt) for q in range(launch.split)
            for y in range(-(-group // per))]


def cmux_step_mma_model(acc: torch.Tensor, bara: torch.Tensor,
                        bk_i: torch.Tensor, params: TFHEParams,
                        sms: int = 132, blocks_per_sm: int = 2,
                        cluster: bool = True,
                        launch: StepLaunch | None = None) -> torch.Tensor:
    """The fused2 kernel's mma.sync form in plain ops, block by block,
    under ``launch`` (by default :func:`step_shape`'s mma form on a card
    of ``sms`` SMs that hold ``blocks_per_sm`` of its blocks each).  With
    a split: per 16 batch rows and part of the split, the digit tile the
    block decomposes (:func:`cmux_digit_tile` over
    :func:`cmux_part_ranges`), cut to the part's (p, chunk) pairs, through
    :func:`external_product_mma_model`, the parts' shares added to a copy
    of the accumulator.  Else per work item of :func:`step_work_items`
    (runs of the launch's ``per_item`` tiles) one whole digit tile (with
    ``cluster`` put together from the shares of the launch's cluster) and,
    from it, each of the item's output tiles, every output written once.
    Same arguments and result as :func:`cmux_step_plain`."""
    rows, kp1, n = bk_i.shape
    b = acc.shape[1]
    t = min(n, MMA_TILE_COLS)
    nbt = -(-b // MMA_TILE_ROWS)
    launch = launch or step_shape(b, kp1, n, rows, "mma", MMA_TILE_ROWS,
                                  sms=sms, per_sm=blocks_per_sm)
    if launch.form != "mma":
        raise ValueError(f"not an mma.sync launch: {launch}")
    split = launch.split
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
    items = step_work_items(b, n, kp1, sms * blocks_per_sm, launch.per_item)
    c = launch.cluster if cluster else 1
    shares = [(r * MMA_TILE_ROWS // c, (r + 1) * MMA_TILE_ROWS // c)
              for r in range(c)]
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


# The fused step on the warpgroup tile (csrc/wgmma_step.cuh): the
# producer warpgroup rotates, diffs and decomposes the digits straight
# into the swizzled stages the wgmmas read, shared across a cluster of the
# blocks of the same batch rows; a plain model of that, and the launch
# policy of both step forms.

#: the fused step's kernel forms: mma.sync on the 16-row tile of
#: csrc/cmux_step_parts.cuh, and wgmma on csrc/wgmma_step.cuh's
STEP_FORMS = ("mma", "wgmma")

#: the most gadget levels l a unit (the l stages of one rotation) holds
WG_STEP_MAX_LEVELS = 4

#: the cluster sizes the wgmma form takes (a power of two up to 8 that
#: divides the N/T x (k+1) blocks of a batch tile)
WG_STEP_CLUSTERS = (1, 2, 4, 8)

#: the largest cluster the policies give the wgmma form
WG_STEP_CLUSTER = 4

#: the batch rows of the wgmma form's tile (a 32-row tile lost to it at
#: every batch tools/tile_bench.py swept, PERF.md)
WG_STEP_TILE = 64

#: clusters of each size the H100 holds at once of a one-block-an-SM
#: wgmma step kernel (the runtime's occupancy query, PERF.md): whole
#: clusters sit inside a GPC, so four and eight leave 12 SMs idle
H100_RESIDENT_CLUSTERS = ((1, 132), (2, 66), (4, 30), (8, 15))


class StepLaunch(NamedTuple):
    """The fused step's launch (:func:`step_launch`): form, split,
    per_item and cluster are the last arguments of ``ieache_cmux_step``
    before the stream; the tile follows from the form, the grid from
    the rest."""

    form: str       # "mma" (cmux_step_parts.cuh) or "wgmma" (wgmma_step.cuh)
    tile: int       # batch rows of a block's tile: 16, or a wgmma's n
    cols: int       # coefficients of a block's tile
    split: int      # parts of each tile's sum over its (p, chunk) pairs
    per_item: int   # output tiles a block computes from one decomposition
    cluster: int    # blocks a thread-block cluster
    grid: int       # blocks


def wgmma_step_smem_bytes(bn: int, n: int, l: int, cluster: int) -> int:
    """Shared memory of a wgmma step block (``StepTile::smem_bytes``): from
    a 1024-byte boundary, two unit buffers of l stages of bn x KC digits,
    two plane buffers and the rank's bn / cluster rows of one polynomial
    of the accumulator (the epilogue's slabs over all three), then five
    mbarriers and bn amounts."""
    t, kc = min(n, 128), wgmma_chunk_cols(n)
    words = (t + kc) // 4
    stride = words + (8 - words % 32) % 32
    main = 2 * l * bn * kc + 2 * 16 * stride * 4 + bn // cluster * n * 4
    slabs = 4 * (t // 64) * bn * WG_SLAB_PITCH * 4
    return 1024 + -(-max(main, slabs) // 16) * 16 + 8 * 5 + 4 * bn


def wgmma_step_clusters(bn: int, n: int, kp1: int, l: int) -> tuple:
    """The clusters the wgmma step takes for a batch tile of ``bn`` rows:
    those of :data:`WG_STEP_CLUSTERS` that divide its N/T x (k+1) blocks
    and whose rows of the accumulator fit a block's shared memory beside
    the stages (:func:`wgmma_step_smem_bytes`)."""
    group = n // min(n, 128) * kp1
    return tuple(c for c in WG_STEP_CLUSTERS if group % c == 0 and
                 wgmma_step_smem_bytes(bn, n, l, c) <= SMEM_BLOCK_BYTES)


def wgmma_step_cluster(bn: int, n: int, kp1: int, l: int,
                       most: int = WG_STEP_CLUSTER) -> int:
    """The policies' cluster for a batch tile of ``bn`` rows: the largest
    of :func:`wgmma_step_clusters` up to ``most``, else the smallest."""
    takes = wgmma_step_clusters(bn, n, kp1, l)
    return max((c for c in takes if c <= most), default=min(takes))


def step_shape(batch: int, kp1: int, n: int, rows: int, form: str,
               tile: int, cluster: int | None = None, sms: int = 132,
               per_sm: int = 2) -> StepLaunch:
    """The fused step's launch in ``form`` on a card of ``sms`` SMs.
    "mma": 16-row tiles of min(N, 256) coefficients, each tile's sum cut
    in :func:`mma_split_for`'s parts while the tiles are fewer than the
    SMs, else runs of :func:`tiles_per_item` tiles a block over the
    ``sms * per_sm`` blocks resident at once, the runs of a row group in
    clusters as :func:`step_cluster_shares` pairs them.  "wgmma": ``tile``
    rows x min(N, 128) coefficients a block, each tile whole, the blocks
    of a batch tile in clusters of ``cluster`` (by default
    :func:`wgmma_step_cluster`'s)."""
    if form == "mma":
        t = min(n, MMA_TILE_COLS)
        nbt, group = -(-batch // MMA_TILE_ROWS), n // t * kp1
        split = mma_split_for(nbt * group, rows * (n // t), sms)
        per_item = (tiles_per_item(nbt, group, sms * per_sm) if split == 1
                    else 1)
        nper = -(-group // per_item)
        return StepLaunch("mma", MMA_TILE_ROWS, t, split, per_item,
                          len(step_cluster_shares(nper, split)),
                          nbt * split * nper)
    cols = min(n, 128)
    cluster = (wgmma_step_cluster(tile, n, kp1, rows // kp1)
               if cluster is None else cluster)
    return StepLaunch("wgmma", tile, cols, 1, 1, cluster,
                      -(-batch // tile) * (n // cols) * kp1)


def step_launch_shapes(batch: int, kp1: int, n: int, rows: int,
                       sms: int = 132, per_sm: int = 2) -> dict:
    """The launches :func:`step_launch` picks from: "mma", and "wgmma BN x
    T, cluster c" (BN = :data:`WG_STEP_TILE`) for each cluster of
    :func:`wgmma_step_clusters` (none where the wgmma form refuses the
    shape: :func:`wgmma_step_refusal`)."""
    shapes = {"mma": step_shape(batch, kp1, n, rows, "mma", MMA_TILE_ROWS,
                                sms=sms, per_sm=per_sm)}
    if wgmma_step_refusal(rows, kp1, n) is not None:
        return shapes
    for c in wgmma_step_clusters(WG_STEP_TILE, n, kp1, rows // kp1):
        shapes[f"wgmma {WG_STEP_TILE} x {min(n, 128)}, cluster {c}"] = \
            step_shape(batch, kp1, n, rows, "wgmma", WG_STEP_TILE, c, sms=sms)
    return shapes


def wgmma_step_refusal(rows: int, kp1: int, n: int) -> str | None:
    """Why the fused step's wgmma form refuses a shape the mma form takes,
    or None: a unit holds at most :data:`WG_STEP_MAX_LEVELS` stages."""
    if rows // kp1 > WG_STEP_MAX_LEVELS:
        return (f"the wgmma step holds at most {WG_STEP_MAX_LEVELS} gadget "
                f"levels a unit, got l={rows // kp1}")
    return None


def _resident(sms: int, resident: tuple | None) -> dict:
    """{cluster: clusters held at once} of a one-block-an-SM wgmma kernel:
    ``resident`` as the occupancy query gives it, else the H100's
    (:data:`H100_RESIDENT_CLUSTERS`) on 132 SMs, else one block an SM."""
    if resident is not None:
        return dict(resident)
    if sms == 132:
        return dict(H100_RESIDENT_CLUSTERS)
    return {c: sms // c for c in WG_STEP_CLUSTERS}


@functools.cache
def step_launch(batch: int, kp1: int, n: int, rows: int, sms: int = 132,
                per_sm: int = 2, resident: tuple | None = None) -> StepLaunch:
    """The launch of ``csrc/cmux_step.cu`` on a card of ``sms`` SMs that
    hold ``per_sm`` of its mma.sync form's blocks each, which the kernel
    takes as it is.  The wgmma form's :data:`WG_STEP_TILE`-row tile where
    the mma.sync form keeps every tile whole and the card holds the wgmma
    grid in one wave: in clusters of :data:`WG_STEP_CLUSTER`, else of
    fewer (``resident``: (cluster, clusters the card holds at once) pairs
    from the occupancy query; by default the H100's).  Elsewhere the
    mma.sync form (:func:`step_shape`), whose tiles' sums split over the
    SMs at small batches.  Set from tools/tile_bench.py's sweeps at 4 and
    6 rows on the H100 (PERF.md): the wgmma form won in one wave (4 rows,
    B = 257 .. 512; 6 rows, B = 257 .. 448) and lost in more."""
    mma = step_shape(batch, kp1, n, rows, "mma", MMA_TILE_ROWS, sms=sms,
                     per_sm=per_sm)
    if mma.split > 1 or wgmma_step_refusal(rows, kp1, n) is not None:
        return mma
    held = _resident(sms, resident)
    blocks = -(-batch // WG_STEP_TILE) * (n // min(n, 128)) * kp1
    for c in sorted(wgmma_step_clusters(WG_STEP_TILE, n, kp1, rows // kp1),
                    reverse=True):
        if c <= WG_STEP_CLUSTER and blocks <= held.get(c, 0) * c:
            return step_shape(batch, kp1, n, rows, "wgmma", WG_STEP_TILE, c,
                              sms=sms)
    return mma


def overlap_parts_launch(batch: int, kp1: int, n: int, rows: int,
                         sms: int = 132,
                         per_sm: int = 2) -> StepLaunch | None:
    """The overlap kernel's small-batch route: where its whole tiles are
    fewer than the ``sms`` SMs, the launch of the fused2 kernel's mma.sync
    form it runs instead (:func:`step_shape`), else None (its own
    persistent kernel)."""
    t = min(n, MMA_TILE_COLS)
    if -(-batch // MMA_TILE_ROWS) * (n // t) * kp1 >= sms:
        return None
    return step_shape(batch, kp1, n, rows, "mma", MMA_TILE_ROWS, sms=sms,
                      per_sm=per_sm)


def wgmma_step_rank_rows(bn: int, cluster: int, rank: int) -> tuple:
    """The batch rows (lo, hi) of a stage that cluster rank ``rank`` of
    ``cluster`` decomposes into every rank's stages."""
    return rank * bn // cluster, (rank + 1) * bn // cluster


def wgmma_step_copy_ranges(bn: int, kc: int, cluster: int, rank: int,
                           l: int) -> list:
    """The bulk copies that send cluster rank ``rank``'s share of a unit
    from its stages into every peer's: (byte offset in the unit buffer,
    bytes) for each stage jl and box of the stage, the rank's rows of the
    box (its rows lie whole and contiguous in a box: the swizzle permutes
    16-byte pieces within a row)."""
    sw = wgmma_swizzle(kc)
    lo, hi = wgmma_step_rank_rows(bn, cluster, rank)
    return [(jl * bn * kc + box * bn * sw + lo * sw, (hi - lo) * sw)
            for jl in range(l) for box in range(kc // sw)]


def wgmma_step_unit_model(acc: torch.Tensor, bara: torch.Tensor,
                          params: TFHEParams, u: int, ch: int, b0: int,
                          bn: int, kc: int, rank: int = 0,
                          cluster: int = 1) -> list:
    """What cluster rank ``rank`` decomposes into its own stages for unit
    (polynomial ``u``, chunk ``ch``) of the batch tile at ``b0``, and its
    copies (:func:`wgmma_step_copy_ranges`) bring to every peer's: for
    each gadget level jl (the stage of digit row u l + jl), (offsets,
    bytes), int64 and int8, one entry a byte.  Its rows
    (:func:`wgmma_step_rank_rows`) x the chunk's kc columns (the kernel's
    threads take runs of 8): X^bara·acc[u] - acc[u] + offset, each 4
    packed by :func:`digit_word_model` into a word of digits, at
    :func:`wgmma_stage_offset`; rows past the batch zero."""
    kp1, b, n = acc.shape
    lo, hi = wgmma_step_rank_rows(bn, cluster, rank)
    dev = acc.device
    row = torch.arange(lo, hi, device=dev)
    col = torch.arange(kc, device=dev)
    lane = (b0 + row).clamp(max=b - 1)
    valid = (b0 + row < b)[:, None]
    j = ch * kc + col                                           # (kc,)
    i = (j[None, :] - bara.to(torch.int64)[lane][:, None]) & (2 * n - 1)
    c = _u32(acc[u])                                            # (B, N)
    rot = torch.where(i < n, c[lane[:, None], i % n],
                      (-c[lane[:, None], i % n]) & 0xFFFFFFFF)
    v = (rot - c[lane][:, j] + _offset(params.bg_bit, params.l)) \
        & 0xFFFFFFFF                                            # (rows, kc)
    offsets = wgmma_stage_offset(row[:, None], col[None, :], bn, kc)
    shifts = 8 * torch.arange(4, device=dev)
    out = []
    for jl in range(params.l):
        words = digit_word_model(v.reshape(len(row), kc // 4, 4), jl,
                                 params.bg_bit)
        digits = ((words[..., None] >> shifts) & 0xFF).reshape(len(row), kc)
        digits = torch.where(valid, digits, torch.zeros_like(digits))
        out.append((offsets.reshape(-1),
                    (digits - ((digits & 0x80) << 1)).to(torch.int8)
                    .reshape(-1)))
    return out


def wgmma_step_stages(acc: torch.Tensor, bara: torch.Tensor,
                      params: TFHEParams, u: int, ch: int, b0: int, bn: int,
                      kc: int, cluster: int = 1) -> torch.Tensor:
    """The l stages (l, bn * kc) int8 of unit (``u``, ``ch``) in every
    rank, put together from each rank's share
    (:func:`wgmma_step_unit_model`) through its copies
    (:func:`wgmma_step_copy_ranges`); raises unless the ranks' copies
    write every byte exactly once, each within the rank's own share."""
    unit = torch.zeros(params.l * bn * kc, dtype=torch.int8,
                       device=acc.device)
    written = torch.zeros(params.l * bn * kc, dtype=torch.int32,
                          device=acc.device)
    for rank in range(cluster):
        own = torch.zeros_like(unit)
        mine = torch.zeros_like(written)
        for jl, (at, vals) in enumerate(wgmma_step_unit_model(
                acc, bara, params, u, ch, b0, bn, kc, rank, cluster)):
            own[jl * bn * kc + at] = vals
            mine[jl * bn * kc + at] += 1
        for start, size in wgmma_step_copy_ranges(bn, kc, cluster, rank,
                                                  params.l):
            if not bool((mine[start:start + size] == 1).all()):
                raise AssertionError("a rank copies bytes it did not write")
            unit[start:start + size] = own[start:start + size]
            written[start:start + size] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the cluster's copies do not write every "
                             "staged byte once")
    return unit.reshape(params.l, bn * kc)


def _wgmma_step_tile(acc: torch.Tensor, bara: torch.Tensor,
                     bk_i: torch.Tensor, params: TFHEParams, b0: int, bn: int,
                     t: int, o: int, jb: int, cluster: int) -> torch.Tensor:
    """One wgmma step block's sum, before the accumulator is added: for
    each unit (u, chunk) its stages (:func:`wgmma_step_stages`), and for
    each of its pairs (p = u l + jl) the A tile from the pair's planes
    (:func:`mma_planes` of kc columns, :func:`wgmma_toeplitz_tile`) times
    the stage as the descriptor of each k-step reads it, one int32 sum per
    limb; then the epilogue's fold (:func:`wgmma_epilogue_model`).
    Returns (rows of the batch from b0, t) int32."""
    rows, kp1, n = bk_i.shape
    kc = wgmma_chunk_cols(n)
    reads = torch.cat([wgmma_descriptor_reads(bn, kc, ks)
                       for ks in range(kc // 32)]).to(acc.device)
    sums = torch.zeros((TORUS_LIMBS, t, bn), dtype=torch.int32,
                       device=acc.device)
    for u in range(kp1):
        for ch in range(n // kc):
            stages = wgmma_step_stages(acc, bara, params, u, ch, b0, bn, kc,
                                       cluster)
            for jl in range(params.l):
                tile = wgmma_toeplitz_tile(
                    mma_planes(bk_i[u * params.l + jl, o], jb, ch * kc, kc,
                               t=t), t, kc).to(torch.int32)
                sums += torch.einsum("vjk,kn->vjn", tile,
                                     stages[jl][reads].to(torch.int32))
    return wgmma_epilogue_model(sums)[:acc.shape[1] - b0]


def cmux_step_wgmma_model(acc: torch.Tensor, bara: torch.Tensor,
                          bk_i: torch.Tensor, params: TFHEParams,
                          launch: StepLaunch | None = None,
                          sms: int = 132) -> torch.Tensor:
    """The fused step's wgmma form in plain ops, block by block, under
    ``launch`` (by default :func:`step_shape`'s wgmma form on ``sms``
    SMs): for each T x BN tile
    (:func:`_wgmma_step_tile`, its digits from the cluster's ranks'
    shares) acc's tile + the folded sum, every output written once.  Same
    arguments and result as :func:`cmux_step_plain`."""
    rows, kp1, n = bk_i.shape
    _refuse(kernels_refusal("fused2", rows, n)
            or wgmma_step_refusal(rows, kp1, n))
    b = acc.shape[1]
    launch = launch or step_shape(b, kp1, n, rows, "wgmma", WG_STEP_TILE,
                                  sms=sms)
    if launch.form != "wgmma" or launch.split != 1:
        raise ValueError(f"not a wgmma launch of whole tiles: {launch}")
    bn, t = launch.tile, launch.cols
    out = torch.zeros_like(acc)
    written = torch.zeros_like(acc)
    for o in range(kp1):
        for jb in range(0, n, t):
            for b0 in range(0, b, bn):
                at = (o, slice(b0, b0 + bn), slice(jb, jb + t))
                out[at] = acc[at] + _wgmma_step_tile(
                    acc, bara, bk_i, params, b0, bn, t, o, jb,
                    launch.cluster)
                written[at] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the tiles do not write every output once")
    return out


def blind_rotate_scan_schedule_model(acc: torch.Tensor, bara: torch.Tensor,
                                     bk: torch.Tensor, params: TFHEParams,
                                     sms: int = 132, per_sm: int = 2,
                                     order=None,
                                     launch: ScanLaunch | None = None
                                     ) -> torch.Tensor:
    """The scan kernel's schedule in plain ops, step by step, on a card
    of ``sms`` SMs holding ``per_sm`` of its blocks each: the work items
    of :func:`scan_work_items` under :func:`scan_launch` (or under
    ``launch``, another shape of :func:`scan_shape`), in the order
    ``order(items)`` gives (the kernel's blocks run them in any order;
    by default as listed).  Each item's block decomposes its part's
    digit rows and columns of its 16 batch rows from the step's current
    accumulator (:func:`cmux_digit_tile`; a cluster's blocks each their
    share of the rows), and sums their product over its part's pairs
    for each of its tiles.  The accumulator turns through the launch's
    buffers, the last step landing in the first (``out``): with one part
    a tile two buffers, step s storing cur + sum into the one it does not
    read; with more, three, the parts adding their sums with wrapping
    int32 adds into the step's buffer, zeroed before the loop for step 0
    and during step s - 1 (by then no step reads it) for step s, and the
    part that holds pair 0 adding cur's tile too.  ``acc`` is never
    written.  Same arguments and result as
    :func:`blind_rotate_scan_plain`."""
    nsteps, rows, kp1, n = bk.shape
    b = acc.shape[1]
    if launch is None:
        launch = scan_launch(b, kp1, n, rows, sms, per_sm)
    if launch.form == "wgmma":
        return _scan_wgmma_schedule(acc, bara, bk, params, launch, order)
    atomic = launch.split > 1
    t = min(n, MMA_TILE_COLS)
    parts = cmux_part_ranges(rows, n, launch.split)
    items = scan_work_items(launch, b, n, kp1)
    shares = step_cluster_shares(-(-(n // t) * kp1 // launch.per_item),
                                 launch.split)
    if order is not None:
        items = order(items)
    # stale words in every buffer: what a step reads must have been
    # written in the launch
    ring = [torch.full_like(acc, 0x5A5A5A5A) for _ in range(3 if atomic
                                                             else 2)]

    def dst(s):
        return ring[(nsteps - 1 - s) % len(ring)]

    if atomic:
        dst(0).zero_()
    for s in range(nsteps):
        cur, out = (acc if s == 0 else dst(s - 1)), dst(s)
        g = br.make_step_gmatrix(bk[s], params)
        bara_s = bara[:, s].contiguous()
        # how often each output word was written (split 1) or added to
        count = torch.zeros_like(acc)
        for b0, q, tiles in items:
            nb = min(MMA_TILE_ROWS, b - b0)
            c_begin, c_end, *rect = parts[q]
            # a cluster's blocks each decompose a share of the rows and
            # copy the others': every block ends with the whole tile
            tile = sum(cmux_digit_tile(cur, bara_s, params, b0, *rect,
                                       bl_lo=lo, bl_hi=hi)
                       for lo, hi in shares)
            d = torch.zeros((rows, nb, n), dtype=torch.int8,
                            device=acc.device)
            for c in range(c_begin, c_end):
                p, m0 = c // (n // t), (c % (n // t)) * t
                d[p, :, m0:m0 + t] = tile[p, :nb, m0:m0 + t]
            prod = _gmatrix_product(d, g, params)
            for jb, o in tiles:
                at = (o, slice(b0, b0 + nb), slice(jb, jb + t))
                if atomic:
                    add = prod[o, :, jb:jb + t]
                    out[at] += add + cur[at] if q == 0 else add
                else:
                    out[at] = cur[at] + prod[o, :, jb:jb + t]
                count[at] += 1
        if not bool((count == launch.split).all()):
            raise AssertionError(f"step {s}'s work items do not cover every "
                                 f"output word {launch.split} time(s)")
        if atomic and s + 1 < nsteps:
            nxt = dst(s + 1)
            if nxt is cur or nxt is out:
                raise AssertionError("the buffer zeroed during a step is "
                                     "read or written in it")
            nxt.zero_()
    return dst(nsteps - 1)


def _scan_wgmma_schedule(acc: torch.Tensor, bara: torch.Tensor,
                         bk: torch.Tensor, params: TFHEParams,
                         launch: ScanLaunch, order=None) -> torch.Tensor:
    """:func:`blind_rotate_scan_schedule_model` under the wgmma form: the
    clusters' work items (:func:`scan_work_items`) of each step in the
    order ``order(items)`` gives, each rank's tile the wgmma step block's
    (:func:`_wgmma_step_tile` from the step's current accumulator, its
    digits from every rank's share) stored as cur + sum into the buffer
    the step does not read; two buffers, the last step landing in the
    first."""
    nsteps, rows, kp1, n = bk.shape
    b = acc.shape[1]
    bn, t = launch.tile, min(n, 128)
    items = scan_work_items(launch, b, n, kp1)
    if order is not None:
        items = order(items)
    ring = [torch.full_like(acc, 0x5A5A5A5A) for _ in range(2)]

    def dst(s):
        return ring[(nsteps - 1 - s) % 2]

    for s in range(nsteps):
        cur, out = (acc if s == 0 else dst(s - 1)), dst(s)
        bara_s = bara[:, s].contiguous()
        count = torch.zeros_like(acc)
        for b0, _, tiles in items:
            for jb, o in tiles:
                at = (o, slice(b0, b0 + bn), slice(jb, jb + t))
                out[at] = cur[at] + _wgmma_step_tile(
                    cur, bara_s, bk[s], params, b0, bn, t, o, jb,
                    launch.cluster)
                count[at] += 1
        if not bool((count == 1).all()):
            raise AssertionError(f"step {s}'s work items do not cover every "
                                 f"output word once")
    return dst(nsteps - 1)


def _cmux_step_launch(wrapper, entry: str, mode: str, acc: torch.Tensor,
                      bara: torch.Tensor, bk_i: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """Both step kernels' wrapper body: the new accumulator from the C
    entry point ``entry`` on CUDA tensors (which raises ``ValueError``
    for a shape :func:`kernels_refusal` refuses under ``mode``), launched
    as :func:`step_launch` (fused2) or :func:`overlap_parts_launch` (the
    overlap kernel's small-batch route) says, counted on ``wrapper``, or
    from the plain twin on CPU tensors.  The output never aliases
    ``acc``: blocks read it while others write."""
    _require_single_limb(params)
    rows, kp1, b, n = params.trgsw_rows, params.k + 1, bara.numel(), params.N
    _check(acc, "acc", torch.int32, (kp1, b, n), acc.device, align=16)
    _check(bara, "bara", torch.int32, (b,), acc.device)
    _check(bk_i, "bk_i", torch.int32, (rows, kp1, n), acc.device)
    if not acc.is_cuda:
        return cmux_step_plain(acc, bara, bk_i, params)

    _refuse(kernels_refusal(mode, rows, n))
    if b == 0:
        return torch.empty_like(acc)
    sms = _sm_count(acc.device)
    per_sm = _step_per_sm(acc.device, rows, n)
    if mode == "fused2":
        out = _cmux_step_entry(acc, bara, bk_i, params, step_launch(
            b, kp1, n, rows, sms, per_sm,
            _wgmma_resident(acc.device, "cmux_step", rows, kp1, n)))
    else:
        out = torch.empty_like(acc)
        parts = overlap_parts_launch(b, kp1, n, rows, sms, per_sm)
        lib, stream = _launch_context(acc)
        code = getattr(lib, entry)(
            acc.data_ptr(), bara.data_ptr(), bk_i.data_ptr(), out.data_ptr(),
            rows, kp1, b, n, params.bg_bit, params.l,
            _offset(params.bg_bit, params.l),
            *((parts.split, parts.per_item, parts.cluster) if parts
              else (0, 0, 0)), stream,
        )
        _build.check(lib, code, entry)
    wrapper.launches += 1
    return out


@functools.cache
def _step_per_sm(device: torch.device, rows: int, n: int) -> int:
    """Blocks of the fused step's mma.sync form an SM of ``device`` (the
    current one) holds at once at (rows, N), as the runtime's occupancy
    query says."""
    lib = _build.library()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.ieache_cmux_step_per_sm(rows, n,
                                                  ctypes.byref(blocks)),
                 "cmux_step_per_sm")
    return blocks.value


def _cmux_step_entry(acc: torch.Tensor, bara: torch.Tensor,
                     bk_i: torch.Tensor, params: TFHEParams,
                     launch: StepLaunch) -> torch.Tensor:
    """One launch of ``ieache_cmux_step`` on checked CUDA tensors with the
    launch shape ``launch``, uncounted: the wrapper's launch, and the one
    chip_smoke and ``tools/tile_bench.py`` give every form, tile and
    cluster by."""
    rows, kp1, n = params.trgsw_rows, params.k + 1, params.N
    b = bara.numel()
    out = torch.empty_like(acc)
    if b == 0:
        return out
    lib, stream = _launch_context(acc)
    code = lib.ieache_cmux_step(
        acc.data_ptr(), bara.data_ptr(), bk_i.data_ptr(), out.data_ptr(),
        rows, kp1, b, n, params.bg_bit, params.l,
        _offset(params.bg_bit, params.l), STEP_FORMS.index(launch.form),
        launch.split, launch.per_item, launch.cluster, stream,
    )
    _build.check(lib, code, "cmux_step")
    return out


def cmux_step_as(acc: torch.Tensor, bara: torch.Tensor, bk_i: torch.Tensor,
                 params: TFHEParams, launch: StepLaunch) -> torch.Tensor:
    """The fused step under ``launch``, uncounted, whatever the policy
    picks: :func:`_cmux_step_entry` on CUDA tensors, the plain model of
    that form on CPU tensors (:func:`cmux_step_wgmma_model`, or
    :func:`cmux_step_mma_model`).  chip_smoke and ``tools/tile_bench.py``
    hold every launch shape to the twin by it."""
    if acc.is_cuda:
        return _cmux_step_entry(acc, bara, bk_i, params, launch)
    if launch.form == "wgmma":
        return cmux_step_wgmma_model(acc, bara, bk_i, params, launch=launch)
    return cmux_step_mma_model(acc, bara, bk_i, params, launch=launch)


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
    (k+1, B, N) int32 accumulator, exact mod 2^32; acc is not written.
    On CUDA tensors the kernel (which raises ``ValueError`` for a shape
    ``kernels_refusal("scan", ...)`` refuses), launched as
    :func:`scan_launch` says, with the accumulator's two or three
    buffers and no digit tensor; the plain twin on CPU tensors."""
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
    _launch_context(acc)
    launch = scan_launch(
        b, kp1, n, rows, _sm_count(acc.device),
        _scan_per_sm(acc.device, rows, n),
        _wgmma_resident(acc.device, "blind_rotate_scan", rows, kp1, n))
    out = _blind_rotate_scan_entry(acc, bara, bk, params, launch)
    blind_rotate_scan.launches += 1
    return out


@functools.cache
def _scan_per_sm(device: torch.device, rows: int, n: int) -> int:
    """Blocks of the scan kernel an SM of ``device`` (the current one)
    holds at once at (rows, N), as the runtime's occupancy query says
    for its registers and shared memory."""
    lib = _build.library()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.ieache_blind_rotate_scan_per_sm(
        rows, n, ctypes.byref(blocks)), "blind_rotate_scan_per_sm")
    return blocks.value


@functools.cache
def _wgmma_clusters(device: torch.device, kernel: str, rows: int, kp1: int,
                    n: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks of ``kernel``'s wgmma form
    ("cmux_step" or "blind_rotate_scan"; its :data:`WG_STEP_TILE`) ``device``
    (the current one) holds at once at (rows, k+1, N), as the runtime's
    occupancy query says: the scan's cooperative launch needs every block
    resident, and the step's policy wants its grid in one wave."""
    lib = _build.library()
    count = ctypes.c_int(0)
    entry = f"ieache_{kernel}_clusters"
    _build.check(lib, getattr(lib, entry)(rows, kp1, n, cluster,
                                          ctypes.byref(count)), entry)
    return count.value


@functools.cache
def _wgmma_resident(device: torch.device, kernel: str, rows: int, kp1: int,
                    n: int) -> tuple | None:
    """The (cluster, clusters held at once) pairs of ``kernel``'s wgmma
    form at the policies' tile on ``device``, for every cluster it takes
    there; None where the form refuses the shape."""
    if wgmma_step_refusal(rows, kp1, n) is not None:
        return None
    return tuple((c, _wgmma_clusters(device, kernel, rows, kp1, n, c))
                 for c in wgmma_step_clusters(WG_STEP_TILE, n, kp1,
                                              rows // kp1))


def _blind_rotate_scan_entry(acc: torch.Tensor, bara: torch.Tensor,
                             bk: torch.Tensor, params: TFHEParams,
                             launch: ScanLaunch) -> torch.Tensor:
    """One launch of ``ieache_blind_rotate_scan`` on checked CUDA tensors
    with the launch shape ``launch``, uncounted: the wrapper's launch, and
    the one chip_smoke and ``tools/tile_bench.py`` give other shapes by.
    Allocates the accumulator's buffers the steps turn through, out
    first: two with one part a tile, three with more (fewer when there
    are fewer steps); and the grid barrier's word, zeroed."""
    rows, kp1, n = params.trgsw_rows, params.k + 1, params.N
    b, steps = bara.shape
    bufs = [torch.empty_like(acc)
            for _ in range(min(3 if launch.split > 1 else 2, steps))]
    ptrs = [t.data_ptr() for t in bufs] + [None] * (3 - len(bufs))
    barrier = torch.zeros(1, dtype=torch.int32, device=acc.device)
    lib, stream = _launch_context(acc)
    code = lib.ieache_blind_rotate_scan(
        acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), *ptrs,
        barrier.data_ptr(), rows, kp1, b, n, steps, params.bg_bit, params.l,
        _offset(params.bg_bit, params.l), launch.split, launch.per_item,
        launch.grid, launch.cluster, STEP_FORMS.index(launch.form), stream,
    )
    _build.check(lib, code, "blind_rotate_scan")
    return bufs[0]


def blind_rotate_scan_as(acc: torch.Tensor, bara: torch.Tensor,
                         bk: torch.Tensor, params: TFHEParams,
                         launch: ScanLaunch) -> torch.Tensor:
    """The whole rotation under ``launch``, uncounted, whatever the policy
    picks: :func:`_blind_rotate_scan_entry` on CUDA tensors, the schedule
    model of that form on CPU tensors
    (:func:`blind_rotate_scan_schedule_model`).  chip_smoke and
    ``tools/tile_bench.py`` hold every launch shape to the twin by it."""
    if acc.is_cuda:
        return _blind_rotate_scan_entry(acc, bara, bk, params, launch)
    return blind_rotate_scan_schedule_model(acc, bara, bk, params,
                                            launch=launch)


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


def mode_launches(mode: str) -> int:
    """Launches so far of the wrappers of step mode ``mode``'s kernels
    (:data:`MODE_KERNELS`)."""
    return sum(globals()[name].launches for name in MODE_KERNELS[mode])


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
