"""The warpgroup tile of ``csrc/wgmma_tile.cuh`` and the product's launch
policy, as far as a CPU can hold them: the plain model in
``ieache_tpu_torch.ops.kernels`` of each part of the wgmma form (the A
fragments of each warp from the shifted byte planes, the stage the
tensor-memory accelerator writes and the address function the B matrix
descriptor reads it by, the epilogue's transpose through shared memory and
the limb fold) against the Toeplitz matrix, the external product's plain
twin and the JAX package's Pallas kernel run in interpret mode on the same
numpy inputs; and ``product_launch`` pinned by batch at both parameter sets.

All arithmetic is exact mod 2^32: the tolerance is exact equality.  The
CUDA kernel itself is held against the twin on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ieache_tpu import params as P
from ieache_tpu.ops.pallas_kernels import external_product_pallas_t
from ieache_tpu_torch import params as TP
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.ops.blind_rotate import make_step_gmatrix

#: where a carry between int8 limbs goes wrong: INT32_MIN, -1, 2^31 - 1,
#: 0x7F7F7F7F, 0x80808080, and their neighbours
EDGES = np.array([-2**31, -1, 2**31 - 1, 0x7F7F7F7F, 0x80808080 - 2**32, 0,
                  -2**31 + 1, 0x7F7F7F80, 0x80808080 - 2**32 - 1, 0x7F80, -128,
                  127, 128, -129], np.int32)

LIMBS_LO, LIMBS_HI = 0x80808080 - 2**32, 0x7F7F7F7F   # limbs all -128 / +127

#: TEST_TINY with three gadget levels: 6 TRGSW rows
TINY_6ROWS = dataclasses.replace(P.TEST_TINY, l=3, name="tiny_6rows")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test workers on one CPU,
    and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_i32(rng, shape):
    x = rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return x


def _sized(n, rows=4):
    """A parameter set of ring degree n with ``rows`` TRGSW rows."""
    return dataclasses.replace(P.TEST_TINY, N=n, l=rows // 2, name=f"n{n}")


def _inputs(p, b, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(-128, 128, (p.trgsw_rows, b, p.N)).astype(np.int8),
            _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N)),
            _rand_i32(rng, (p.k + 1, b, p.N)))


def _wgmma_launches(p, b, sms=132):
    return [launch for launch in kernels.product_launch_shapes(
        b, p.k + 1, p.N, p.trgsw_rows, sms).values()
        if launch.form == "wgmma"]


# ---------------------------------------------------------------------------
# the A operand: each warp's fragments from the shifted planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mcols", [(64, 64), (256, 256), (1024, 256),
                                     (1024, 1024)])
def test_a_fragments_reproduce_the_toeplitz_tile(n, mcols):
    """The shifted, reversed planes of a T = min(N, 128) tile, read through
    the consumers' window (warp v = limb v, chain c's registers on
    diagonals 0, -1, 2, 1 of its entry), give make_step_gmatrix's (T,
    mcols) tile of every limb, for every block of coefficients and digit
    columns."""
    p = _sized(n)
    rng = np.random.RandomState(n + mcols)
    bk_i = _t(_rand_i32(rng, (1, 1, n)))
    want = make_step_gmatrix(bk_i, p)[:, 0, 0]          # (L, N, N)
    t = min(n, 128)
    for jb in range(0, n, t):
        for ma in range(0, n, mcols):
            planes = kernels.mma_planes(bk_i[0, 0], jb, ma, mcols, t=t)
            got = kernels.wgmma_toeplitz_tile(planes, t, mcols)
            assert got.shape == (4, t, mcols)
            assert torch.equal(got, want[:, ma:ma + mcols, jb:jb + t]
                               .transpose(1, 2)), (jb, ma)


def test_window_entries_stay_in_the_window_and_slide_by_four():
    """A commit group of 2 k-steps loads 4 x 2 + 2 C - 2 = 14 words: the
    entries chains 0 .. 3 take lie in 0 .. 9 a k-step, and the next k-step
    (4 diagonals on) takes 4 new ones."""
    entries = {kernels.wgmma_window_index(c, r)
               for c in range(kernels.WG_CHAINS) for r in range(4)}
    assert entries == set(range(2 * kernels.WG_CHAINS + 2))
    shifted = {e + 4 for e in entries}
    assert len(shifted - entries) == 4


# ---------------------------------------------------------------------------
# the B operand: the stage and the descriptor that reads it
# ---------------------------------------------------------------------------

@settings(max_examples=18, deadline=None)
@given(bn=st.sampled_from([8, 16, 24, 32, 48, 64]),
       kc=st.sampled_from([64, 128, 256]))
def test_descriptor_reads_every_staged_byte_once(bn, kc):
    """Over a chunk's k-steps the descriptor reads each (row, k) of the
    stage exactly once, at the offset the tensor-memory accelerator wrote
    that digit to."""
    reads = torch.cat([kernels.wgmma_descriptor_reads(bn, kc, ks).reshape(-1)
                       for ks in range(kc // 32)])
    assert sorted(reads.tolist()) == list(range(bn * kc))
    row = torch.arange(bn)[None, :].expand(32, bn)
    for ks in range(kc // 32):
        col = 32 * ks + torch.arange(32)[:, None].expand(32, bn)
        assert torch.equal(kernels.wgmma_descriptor_reads(bn, kc, ks),
                           kernels.wgmma_stage_offset(row, col, bn, kc))


@pytest.mark.parametrize("kc", [64, 128, 256])
def test_swizzle_keeps_sixteen_byte_pieces_and_boxes_on_atoms(kc):
    """The swizzle permutes whole 16-byte pieces within a row of the box, and
    every box starts on a swizzle atom (8 rows x SW bytes)."""
    sw = kernels.wgmma_swizzle(kc)
    for bn in (32, 64):
        row = torch.arange(bn)[:, None]
        col = torch.arange(kc)[None, :]
        off = kernels.wgmma_stage_offset(row, col, bn, kc)
        assert torch.equal(off % 16, col.expand(bn, kc) % 16)
        box = (col // sw) * bn * sw
        assert torch.equal((off - box) // sw, row.expand(bn, kc))
        assert (bn * sw) % (8 * sw) == 0


def test_stage_reads_rows_past_the_batch_as_zeros():
    """A tile that runs past the batch stages zeros in its last rows, and
    the descriptor reads them back as the digits' columns."""
    p = _sized(256)
    d = torch.from_numpy(np.random.RandomState(2).randint(
        -128, 128, (p.trgsw_rows, 5, p.N)).astype(np.int8))
    stage = kernels.wgmma_stage_model(d, 1, 256 - 128, 0, 32, 128)
    for ks in range(4):
        b = stage[kernels.wgmma_descriptor_reads(32, 128, ks)]   # (32, bn)
        assert torch.equal(b[:, :5].t(), d[1, :, 128 + 32 * ks:160 + 32 * ks])
        assert not bool(b[:, 5:].any())


# ---------------------------------------------------------------------------
# the epilogue: the transpose through the slabs and the limb fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,bn", [(64, 32), (128, 64), (128, 32)])
def test_epilogue_transposes_and_folds_the_limbs(t, bn):
    """The slabs give sum_v S_v << 8v (wrapping), batch row by
    coefficient, for sums at the int32 edges."""
    rng = np.random.RandomState(t + bn)
    sums = _t(_rand_i32(rng, (4, t, bn)))
    got = kernels.wgmma_epilogue_model(sums)
    want = sum((sums[v].to(torch.int64) << (8 * v)) for v in range(4))
    want = ((want + 2**31) % 2**32 - 2**31).to(torch.int32)
    assert torch.equal(got, want.t())


@pytest.mark.parametrize("bn", [32, 64])
def test_slab_stores_of_a_register_fall_on_32_banks(bn):
    """Each fragment register's 32 stores (one a lane) to a warp's slab hit
    32 distinct banks: the 68-word rows."""
    words = kernels.wgmma_slab_words(bn)                  # (C, 32, bn / 2)
    for c in range(words.shape[0]):
        for i in range(words.shape[2]):
            assert len(set((words[c, :, i] % 32).tolist())) == 32


# ---------------------------------------------------------------------------
# the whole tile against the twin and the Pallas kernel
# ---------------------------------------------------------------------------

def _extreme_cases(p, b, rng):
    shape_d, shape_k = (p.trgsw_rows, b, p.N), (p.trgsw_rows, p.k + 1, p.N)
    return {
        "d-128_key-128": (np.full(shape_d, -128, np.int8),
                          np.full(shape_k, LIMBS_LO, np.int32)),
        "d+127_key+127": (np.full(shape_d, 127, np.int8),
                          np.full(shape_k, LIMBS_HI, np.int32)),
        "d-128_key+127": (np.full(shape_d, -128, np.int8),
                          np.full(shape_k, LIMBS_HI, np.int32)),
        "random_edges": (rng.randint(-128, 128, shape_d).astype(np.int8),
                         _rand_i32(rng, shape_k)),
    }


@pytest.mark.parametrize("case", ["d-128_key-128", "d+127_key+127",
                                  "d-128_key+127", "random_edges"])
@pytest.mark.parametrize("p", [P.TEST_TINY, TINY_6ROWS],
                         ids=lambda p: f"{p.trgsw_rows}rows")
def test_extreme_operands_match_twin_and_pallas(p, case):
    """Every limb sum at its ends, with the accumulator fused, under both
    wgmma tiles: equal to the plain twin and to the JAX Pallas kernel
    (interpret mode)."""
    rng = np.random.RandomState(p.trgsw_rows)
    b = 5
    d, bk_i = _extreme_cases(p, b, rng)[case]
    acc = _rand_i32(rng, (p.k + 1, b, p.N))
    want = np.asarray(external_product_pallas_t(
        jnp.asarray(d), jnp.asarray(bk_i), p, acc_t=jnp.asarray(acc),
        interpret=True))
    twin = kernels.external_product_plain(_t(d), _t(bk_i), p, _t(acc))
    np.testing.assert_array_equal(twin.numpy(), want)
    for launch in _wgmma_launches(p, b):
        got = kernels.external_product_wgmma_model(_t(d), _t(bk_i), p,
                                                   _t(acc), launch=launch)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(launch))


@pytest.mark.parametrize("p,b", [(P.TEST_TINY, 1), (P.TEST_TINY, 33),
                                 (P.TEST_SMALL_NOISY, 5),
                                 (P.TEST_SMALL_NOISY, 40),
                                 (_sized(1024), 3)],
                         ids=["tiny-1", "tiny-33", "small-5", "small-40",
                              "n1024-3"])
def test_model_matches_twin_and_pallas_at_ragged_batches(p, b):
    """Batches that end inside a tile (1, 3, 5 of 32; 33, 40 past one):
    every wgmma tile, with and without the accumulator, equal to the twin
    and to the JAX Pallas kernel in interpret mode."""
    d, bk_i, acc = _inputs(p, b, seed=b + p.N)
    want = np.asarray(external_product_pallas_t(
        jnp.asarray(d), jnp.asarray(bk_i), p, acc_t=jnp.asarray(acc),
        interpret=True))
    for launch in _wgmma_launches(p, b):
        got = kernels.external_product_wgmma_model(_t(d), _t(bk_i), p,
                                                   _t(acc), launch=launch)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(launch))
    bare = kernels.external_product_wgmma_model(_t(d), _t(bk_i), p)
    assert torch.equal(bare, kernels.external_product_plain(_t(d), _t(bk_i),
                                                            p))


@pytest.mark.parametrize("split", [1, 5, 6])
def test_parts_of_six_rows_add_into_the_output(split):
    """At 6 rows and N = 1024 a tile has 24 (p, chunk) pairs of 256
    columns, and a part may start and end inside a row (segments of up to
    1024 columns): every split's parts, added with wrapping into an output
    that holds acc, equal the twin."""
    p = _sized(1024, rows=6)
    d, bk_i, acc = _inputs(p, 2, seed=split)
    launch = kernels.product_shape(2, p.k + 1, p.N, p.trgsw_rows, "wgmma", 32,
                                   128, split=split)
    got = kernels.external_product_wgmma_model(_t(d), _t(bk_i), p, _t(acc),
                                               launch=launch)
    assert torch.equal(got, kernels.external_product_plain(
        _t(d), _t(bk_i), p, _t(acc)))


# ---------------------------------------------------------------------------
# the launch policy
# ---------------------------------------------------------------------------

#: product_launch's picks on 132 SMs, N = 1024, k = 1: (form, batch tile,
#: coefficients, split, grid) by batch, at 4 and at 6 TRGSW rows
PICKS = {
    4: {1: ("mma", 16, 256, 16, 128), 5: ("mma", 16, 256, 16, 128),
        8: ("mma", 16, 256, 16, 128), 16: ("mma", 16, 256, 16, 128),
        24: ("mma", 16, 256, 16, 256), 256: ("wgmma", 32, 128, 2, 256),
        257: ("wgmma", 32, 128, 1, 144), 1024: ("wgmma", 64, 128, 1, 256),
        1056: ("wgmma", 32, 128, 1, 528)},
    6: {1: ("mma", 16, 256, 24, 192), 5: ("mma", 16, 256, 24, 192),
        8: ("mma", 16, 256, 24, 192), 16: ("mma", 16, 256, 24, 192),
        24: ("mma", 16, 256, 12, 192), 256: ("wgmma", 32, 128, 2, 256),
        257: ("wgmma", 32, 128, 1, 144), 1024: ("wgmma", 64, 128, 1, 256),
        1056: ("wgmma", 32, 128, 1, 528)},
}


@pytest.mark.parametrize("rows,p", [(4, TP.IEACHE_110_FAST),
                                    (6, TP.IEACHE_110)], ids=["4rows", "6rows"])
@pytest.mark.parametrize("b", [1, 5, 8, 16, 24, 256, 257, 1024, 1056])
def test_product_launch_by_batch(rows, p, b):
    """The mma.sync form up to batch x rows = 512, the wgmma form beyond:
    its 64-row tile where the grid holds 1.4 waves or more and fills its
    last wave to 40% or more, else the 32-row tile; each tile's sum split
    as mma_split_for says."""
    assert p.trgsw_rows == rows and p.N == 1024 and p.k == 1
    launch = kernels.product_launch(b, p.k + 1, p.N, rows, 132)
    assert tuple(launch) == PICKS[rows][b]
    assert launch in kernels.product_launch_shapes(b, p.k + 1, p.N, rows,
                                                   132).values()


@pytest.mark.parametrize("b", [1, 24, 64, 257, 1056])
def test_launch_shapes_split_to_fill_the_card(b):
    """Every shape the policy picks from: grid = tiles x split, the split a
    divisor of a tile's (p, chunk) pairs, the fewest that give each SM a
    block; the wgmma tiles cover min(N, 128) coefficients."""
    p = TP.IEACHE_110_FAST
    for name, launch in kernels.product_launch_shapes(
            b, p.k + 1, p.N, p.trgsw_rows, 132).items():
        kc = (min(p.N, kernels.MMA_TILE_COLS) if launch.form == "mma"
              else kernels.wgmma_chunk_cols(p.N))
        nchunks = p.trgsw_rows * p.N // kc
        tiles = -(-b // launch.tile) * (p.N // launch.cols) * (p.k + 1)
        assert launch.grid == tiles * launch.split, name
        assert nchunks % launch.split == 0, name
        assert launch.split == kernels.mma_split_for(tiles, nchunks, 132)
        if launch.form == "wgmma":
            assert (launch.tile, launch.cols) in kernels.wgmma_tiles(p.N)
