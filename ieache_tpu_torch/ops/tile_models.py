"""Plain models of the port's CUDA kernels, for the CPU tests,
``tools/tile_bench.py`` and ``chip_smoke.py``; the program imports none
of it.

A model does a kernel's work in plain torch ops the way its ``.cu``
does it, tile by tile or thread by thread, and gives the same result as
the kernel's plain twin in :mod:`ieache_tpu_torch.ops.kernels`, whose
constants, launch shapes and launch policies it reads.  A change to a
kernel's fragment map, staging or order of work is made in its model
first:

* the split rotation (``csrc/rot_diff_decompose.cu``):
  :func:`rot_diff_decompose_run_model`;
* the external product's ``mma.sync`` tile (``csrc/mma_tile.cuh``):
  :func:`mma_planes`, :func:`mma_toeplitz_tile` and
  :func:`external_product_mma_model` model its operand construction;
  its warpgroup MMA tile (``csrc/wgmma_tile.cuh``):
  :func:`wgmma_toeplitz_tile`, :func:`wgmma_stage_model`,
  :func:`wgmma_descriptor_reads`, :func:`wgmma_epilogue_model` and
  :func:`external_product_wgmma_model`;
* the fused step (``csrc/cmux_step.cu``): its warpgroup form
  (``csrc/wgmma_step.cuh``) in :func:`wgmma_step_unit_model`,
  :func:`wgmma_step_copy_ranges`, :func:`wgmma_step_stages` and
  :func:`cmux_step_wgmma_model`, its ``mma.sync`` form in
  :func:`cmux_digit_tile`, :func:`cmux_part_ranges` and
  :func:`cmux_step_mma_model`; the overlap kernel's order of work in
  :func:`step_work_items` and :func:`cmux_step_overlap_mma_model`;
* the scan (``csrc/blind_rotate_scan.cu``): its schedule in
  :func:`blind_rotate_scan_schedule_model`;
* ``tr``: the rotation's slab (:func:`rot_diff_decompose_tr_slab_model`,
  :func:`rot_tr_slab_banks`; the probe's sublane rotation
  :func:`rot_tr_slab_model`), the product's A operand and staged digits
  (:func:`mma_toeplitz_tile_a`, :func:`tr_stage_model`,
  :func:`external_product_tr_mma_model`);
* the keyswitch (``csrc/keyswitch.cu``): :func:`keyswitch_kernel_model`.

:func:`external_product_as`, :func:`cmux_step_as`,
:func:`blind_rotate_scan_as` and :func:`keyswitch_as` run a kernel under
any launch shape, uncounted: its C entry on CUDA tensors, its model on
CPU tensors.  The ``*_launch_shapes`` functions list the shapes each
launch policy picks from.
"""

from __future__ import annotations

import functools

import torch

from ieache_tpu_torch.core.poly import (
    TORUS_LIMBS,
    make_step_gmatrix,
    negacyclic_extend,
)
from ieache_tpu_torch.ops.decompose import _offset, gadget_decompose
from ieache_tpu_torch.ops.kernels import (
    DIGIT_ROW_PAD,
    KS_EPI_PITCH,
    KS_STAGE_PAD,
    KS_STRIP_COLS,
    KS_UNIT_ROWS,
    KeyswitchLaunch,
    MMA_SEG_CHUNKS,
    MMA_TILE_COLS,
    MMA_TILE_ROWS,
    ProductLaunch,
    ScanLaunch,
    StepLaunch,
    TR_SLAB_LANES,
    WG_CHAINS,
    WG_SLAB_PITCH,
    WG_STEP_TILE,
    _blind_rotate_scan_entry,
    _cmux_step_entry,
    _external_product_entry,
    _gmatrix_product,
    _keyswitch_entry,
    _refuse,
    _resident,
    _scan_mma_launch,
    digit_rows,
    kernels_refusal,
    keyswitch_launch,
    keyswitch_refusal,
    keyswitch_shape,
    keyswitch_units,
    mma_split_for,
    product_launch,
    product_shape,
    rot_diff_decompose_plain,
    rot_launch,
    rot_tr_route,
    scan_launch,
    scan_wgmma_shape,
    step_cluster_shares,
    step_shape,
    tiles_per_item,
    wgmma_chunk_cols,
    wgmma_step_clusters,
    wgmma_step_refusal,
    wgmma_tiles,
)
from ieache_tpu_torch.params import TFHEParams


# the split step's rotation (csrc/rot_diff_decompose.cu)

#: the run lengths of a thread, longest first: one 8- or 4-byte store a
#: digit row (runs of 16 lost to runs of 8 at every batch on the H100:
#: PERF.md §6)
ROT_RUNS = (8, 4)

#: threads of the kernel's block, fixed in the ``.cu`` (``kThreads``;
#: blocks of 32, 64 and 256 lost or tied: PERF.md §6)
ROT_THREADS = 128


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


# the tensor-core tile of csrc/mma_tile.cuh

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


# the rotations in the (k+1, N, B) layout (csrc/rot_slab.cuh)

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


# the product on Hopper's warpgroup MMA (csrc/wgmma_tile.cuh)

#: digit columns one build of a wgmma block's byte planes covers
WG_SEG_COLS = 1024


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


# the keyswitch (csrc/keyswitch.cu)

#: lanes of a block's tile: one, two or four 16-row MMA tiles
KS_TILE_LANES = (16, 32, 64)


def keyswitch_slice(units: int, split: int, s: int) -> tuple:
    """Units [u0, u1) of K-slice ``s`` of ``split``."""
    return s * units // split, (s + 1) * units // split


def keyswitch_launch_shapes(batch: int, params: TFHEParams,
                            sms: int = 132) -> dict:
    """The launches :func:`keyswitch_launch` picks from: "L lanes" for each
    tile of :data:`KS_TILE_LANES`, each with its default split."""
    return {f"{t} lanes": keyswitch_shape(batch, params, t, sms=sms)
            for t in KS_TILE_LANES}


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


# the fused step on the warpgroup tile (csrc/wgmma_step.cuh)

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
        g = make_step_gmatrix(bk[s], params)
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
