"""The port's CUDA kernels: wrappers, plain twins, launch policies, counts.

:func:`ieache_tpu_torch.ops.blind_rotate.blind_rotate` runs its CMux
steps, in the (k+1, B, N) accumulator layout (``tr``: (k+1, N, B)),
through the kernels of the step mode ``IEACHE_PALLAS_STEP`` selects:

* ``split``: :func:`rot_diff_decompose` (``csrc/rot_diff_decompose.cu``,
  replaces ``rot_diff_decompose_pallas``), the digits of
  X^bara·acc - acc, a run of coefficients a thread from aligned 16-byte
  loads, launched as :func:`rot_launch` says, then
  :func:`external_product`
  (``csrc/external_product.cu``, replaces ``external_product_pallas_t``)
  with the accumulator fused, on the int8 tensor cores in the form
  :func:`product_launch` picks by batch: Hopper's warpgroup MMA
  (``csrc/wgmma_tile.cuh``) or, at small batches, ``mma.sync``
  (``csrc/mma_tile.cuh``);
* ``fused2``: :func:`cmux_step` (``csrc/cmux_step.cu``, replaces
  ``cmux_step_pallas``), the whole step in one kernel, in the form
  :func:`step_launch` picks by batch: the warpgroup tile with a producer
  that decomposes the digits straight into its stages, shared across a
  cluster of the blocks of the same batch rows (``csrc/wgmma_step.cuh``),
  or the ``mma.sync`` tile fed from digits the block decomposes into its
  own shared memory;
* ``overlap``/``overlap2``: :func:`cmux_step_overlap`
  (``csrc/cmux_step_overlap.cu``, replaces ``cmux_step_overlap_pallas``
  and ``cmux_step_overlap2_pallas``), the step with the next batch rows'
  decomposition overlapped;
* ``scan``: :func:`blind_rotate_scan` (``csrc/blind_rotate_scan.cu``,
  replaces ``blind_rotate_scan_pallas``), all n steps in one persistent
  cooperative launch: each step is fused2's work (in the form fused2
  takes at the batch) over the whole grid, one grid barrier a step, the
  accumulator turning through two buffers (three when the tiles' sums
  are split into parts that add atomically), launched as
  :func:`scan_launch` says;
* ``tr``: :func:`rot_diff_decompose_tr`
  (``csrc/rot_diff_decompose_tr.cu``, replaces
  ``rot_diff_decompose_pallas_tr``) then :func:`external_product_tr`
  (``csrc/external_product_tr.cu``, replaces
  ``external_product_pallas_tr``), the split pair in the transposed
  layout: the rotation through a shared-memory slab of 16 batch lanes
  (``csrc/rot_slab.cuh``), or a gather at small batches, as
  :func:`rot_tr_route` says, the product on the same tensor-core tile
  with the Toeplitz tile as the MMA's A operand and the digits staged
  through a transpose.

:func:`rotate_lane` and :func:`rotate_sublane` (``csrc/rotate_probe.cu``,
replacing the two inline kernels of ``tools/transposed_probe.py``) are
one negacyclic rotation in each layout, timed by
:mod:`ieache_tpu_torch.tools.transposed_probe`; the sublane kernel runs
on the tr rotation's slab or gather, by the same :func:`rot_tr_route`.

:func:`mm_s8` and :func:`mm_bf16` (``csrc/mm_probe.cu``, replacing the
inline kernel of ``tools/mosaic_mm_probe.py``) are a bare tensor-core
matrix product repeated g times into one accumulator, timed by
:mod:`ieache_tpu_torch.tools.mosaic_mm_probe`.

The keyswitch of every bootstrap wave (``csrc/keyswitch.cu``, which
replaces no Pallas kernel: the JAX package leaves it to XLA) is launched
by ``ops/keyswitch.keyswitch`` as :func:`keyswitch_launch` says.

:mod:`ieache_tpu_torch.ops.tile_models` holds the kernels' plain models,
for the tests and ``tools/tile_bench.py``; the program does not import
it.

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
(``ValueError``, CUDA tensors only), and ``blind_rotate`` asks
:func:`kernels_refusal` before it picks kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    _dot_digits_g,
    _dot_i8,
    make_step_gmatrix,
    negacyclic_rotate_batch,
    split_i8_limbs,
)
from ieache_tpu_torch.ops import _build
from ieache_tpu_torch.ops.decompose import _offset, _step_digits
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
    d = _step_digits(acc.transpose(0, 1), bara, params)   # (B, rows, N)
    return digit_limb_rows(d, params).transpose(0, 1).contiguous()


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
# the tensor-core tile of csrc/mma_tile.cuh: its limits
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
# run of consecutive coefficients of one polynomial; its launch policy.

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


def kernels_take(mode: str, params: TFHEParams) -> bool:
    """Whether the kernels of step mode ``mode`` accept ``params``'
    shape (:func:`kernels_refusal`); ``blind_rotate`` takes the plain
    step where they do not."""
    return kernels_refusal(mode, params.trgsw_rows, params.N,
                           params.digit_limbs) is None


def _refuse(why: str | None) -> None:
    if why is not None:
        raise ValueError(why)


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


# The same product on Hopper's warpgroup MMA (csrc/wgmma_tile.cuh): a block
# of W consumer warpgroups beside a producer warpgroup, wgmma.mma_async
# m64nBNk32 s8 x s8 -> s32 with the Toeplitz limbs as the A operand from
# registers (the 64 rows of a wgmma are the four limbs of 16 coefficients:
# warp v of a warpgroup holds limb v) and the digits as the B operand from
# shared memory, staged by the tensor-memory accelerator in the swizzled
# layout the matrix descriptor reads; its launch policy.

#: batch rows of a wgmma block's tile (the wgmma's n)
WG_BATCH_TILES = (32, 64)

#: chains of 16 coefficients a consumer warpgroup computes, one wgmma each
#: a k-step: its registers hold the accumulators, 4 x BN / 2, and the A
#: quads of two commit groups in flight, 2 x 4 x 2 k-steps x 4
WG_CHAINS = 4


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


#: words of a row of an epilogue slab: a warpgroup's 64 coefficients and 4
#: of padding, so that a warp's 32 stores of one fragment register fall on
#: 32 banks
WG_SLAB_PITCH = 16 * WG_CHAINS + 4


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
    out = _gmatrix_product(d, make_step_gmatrix(bk_i, params), params)
    return (out if acc is None else acc + out).contiguous()


def _gmatrix_product(d: torch.Tensor, g: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """sum_p d[p] ⊛ BK_i[p, o] from BK_i's Toeplitz limb operand ``g``
    (``make_step_gmatrix``): d (rows, B, N) int8 -> (k+1, B, N) int32."""
    d8 = d.transpose(0, 1)                           # (B, rows, N)
    out = torch.zeros((d8.shape[0], params.k + 1, params.N),
                      dtype=torch.int32, device=d.device)
    for v in range(TORUS_LIMBS):
        out = out + (_dot_digits_g(d8, g[v]) << (8 * v))
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


def external_product(d: torch.Tensor, bk_i: torch.Tensor, params: TFHEParams,
                     acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc + sum_p d[p] ⊛ bk_i[p, o], negacyclic, exact mod 2^32:
    d (rows, B, N) int8, bk_i (rows, k+1, N) int32, acc (k+1, B, N)
    int32 or None -> (k+1, B, N) int32, rows :func:`digit_rows` (with two
    limbs a digit, ``bk_i`` a step of :func:`limb_key`); the kernel on CUDA
    tensors (which raises ``ValueError`` for a shape
    ``kernels_refusal("split", ...)`` refuses), launched as
    :func:`product_launch` says, the plain twin on CPU."""
    return _external_product_launch(
        external_product, "ieache_external_product", external_product_plain,
        d, bk_i, params, acc, tr=False)


external_product.launches = 0


# ---------------------------------------------------------------------------
# the keyswitch: csrc/keyswitch.cu and its launch
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


# ---------------------------------------------------------------------------
# the whole CMux step: fused2 and overlap
# ---------------------------------------------------------------------------

def cmux_step_plain(acc: torch.Tensor, bara: torch.Tensor,
                    bk_i: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Plain twin of both step kernels: :func:`rot_diff_decompose_plain`
    then :func:`external_product_plain` with the accumulator fused."""
    d = rot_diff_decompose_plain(acc, bara, params)
    return external_product_plain(d, bk_i, params, acc)


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


# The fused step on the warpgroup tile (csrc/wgmma_step.cuh): the
# producer warpgroup rotates, diffs and decomposes the digits straight
# into the swizzled stages the wgmmas read, shared across a cluster of the
# blocks of the same batch rows; the launch policy of both step forms.

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
    return negacyclic_rotate_batch(acc.transpose(0, 1), bara) \
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
