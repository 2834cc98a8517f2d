"""The tensor-core tile of ``csrc/mma_tile.cuh``, as far as a CPU can
hold it: the plain model of its operand construction in
``ieache_tpu_torch.ops.tile_models`` (byte planes, shifted reversed copies,
the fragment map, the per-limb fold) against the port's own references,
the external product's plain twin, and the JAX package's Pallas kernel
run in interpret mode on the same numpy inputs; and the plain model of
what the two fused step kernels add to it (the padded digit tile a block
decomposes into shared memory, the part of it a split tile's block
decomposes, a cluster's shares of its rows, the order of the work
items) against the step's twin and the JAX package's fused Pallas
kernels in interpret mode.

All arithmetic is exact mod 2^32: the tolerance is exact equality.  The
CUDA kernel itself is held against the twin on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.ops.pallas_kernels import (
    cmux_step_overlap_pallas,
    cmux_step_pallas,
    external_product_pallas_t,
)
from ieache_tpu_torch.core.poly import (
    make_step_gmatrix,
    negacyclic_extend,
    split_i8_limbs,
)
from ieache_tpu_torch.ops import kernels, tile_models

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


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_biased_xor_bytes_are_the_balanced_limbs(n):
    """Byte v of (e + 0x80808080) ^ 0x80808080, sign-extended, is limb v
    of split_i8_limbs(negacyclic_extend(g)), edge words included."""
    g = _t(_rand_i32(np.random.RandomState(n), (3, n)))
    e = negacyclic_extend(g)
    got = tile_models.mma_limb_bytes(e)
    assert got.dtype == torch.int8 and got.shape == (3, 2 * n, 4)
    assert torch.equal(got, split_i8_limbs(e))
    # and -e of every edge word, which the extension holds too
    edges = _t(EDGES)
    assert torch.equal(tile_models.mma_limb_bytes(-edges),
                       split_i8_limbs(-edges))


@pytest.mark.parametrize("n,mcols", [(64, 64), (256, 256), (1024, 256),
                                     (1024, 1024)])
def test_fragment_map_reproduces_the_toeplitz_tile(n, mcols):
    """The shifted, reversed planes read through the kernel's fragment map
    give make_step_gmatrix's (mcols, T) tile of every limb, for every
    block of digit columns and coefficients."""
    p = _sized(n)
    rng = np.random.RandomState(n + mcols)
    bk_i = _t(_rand_i32(rng, (1, 1, n)))
    want = make_step_gmatrix(bk_i, p)[:, 0, 0]          # (L, N, N)
    t = min(n, kernels.MMA_TILE_COLS)
    for jb in range(0, n, t):
        for ma in range(0, n, mcols):
            planes = tile_models.mma_planes(bk_i[0, 0], jb, ma, mcols)
            assert planes.shape == (4, 4, t + mcols)
            got = tile_models.mma_toeplitz_tile(planes, n, mcols)
            assert torch.equal(got, want[:, ma:ma + mcols, jb:jb + t]), \
                (jb, ma)


def test_shifted_copies_are_one_plane_shifted():
    """Copy s of a plane is copy 0 moved down by s bytes: an aligned word
    of copy s is the unaligned word of copy 0 at byte offset + s."""
    g = _t(_rand_i32(np.random.RandomState(9), (256,)))
    planes = tile_models.mma_planes(g, 0, 0, 256)
    for s in range(1, 4):
        assert torch.equal(planes[:, s, :-s], planes[:, 0, s:])


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
def test_fold_matches_twin_and_pallas(p, case):
    """One int32 sum per limb over all rows and columns, folded once
    with wrapping shifts: equal to the plain twin and to the JAX Pallas
    kernel (interpret mode), with the accumulator fused."""
    rng = np.random.RandomState(p.trgsw_rows)
    b = 5
    d, bk_i = _extreme_cases(p, b, rng)[case]
    acc = _rand_i32(rng, (p.k + 1, b, p.N))
    got = tile_models.external_product_mma_model(_t(d), _t(bk_i), p, _t(acc))
    twin = kernels.external_product_plain(_t(d), _t(bk_i), p, _t(acc))
    assert got.dtype == torch.int32 and torch.equal(got, twin)
    want = np.asarray(external_product_pallas_t(
        jnp.asarray(d), jnp.asarray(bk_i), p, acc_t=jnp.asarray(acc),
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(
        tile_models.external_product_mma_model(_t(d), _t(bk_i), p),
        kernels.external_product_plain(_t(d), _t(bk_i), p))


@pytest.mark.parametrize("n,rows,b", [(256, 6, 3), (1024, 4, 2)])
def test_model_matches_twin_over_several_tiles_and_segments(n, rows, b):
    """N = 256 is one tile of 256 coefficients and one segment; N = 1024
    is four tiles, each over one segment of four chunks."""
    p = _sized(n, rows)
    rng = np.random.RandomState(n)
    d = _t(rng.randint(-128, 128, (rows, b, n)).astype(np.int8))
    bk_i = _t(_rand_i32(rng, (rows, p.k + 1, n)))
    acc = _t(_rand_i32(rng, (p.k + 1, b, n)))
    assert torch.equal(tile_models.external_product_mma_model(d, bk_i, p, acc),
                       kernels.external_product_plain(d, bk_i, p, acc))


def test_limb_sums_stay_exact_up_to_the_bound():
    """At the largest operands each limb's sum is rows * N * 2^14 in
    magnitude: below 2^31 exactly while rows * N < MMA_MAX_TERMS."""
    assert (kernels.MMA_MAX_TERMS - 1) * 128 * 128 < 2**31
    assert kernels.MMA_MAX_TERMS * 128 * 128 >= 2**31
    p = TINY_6ROWS
    d = torch.full((p.trgsw_rows, 1, p.N), -128, dtype=torch.int8)
    tile = tile_models.mma_toeplitz_tile(
        tile_models.mma_planes(torch.full((p.N,), LIMBS_LO, dtype=torch.int32),
                               0, 0, p.N), p.N, p.N)
    # e = concat(-g, g): the upper half of each column is g, limbs -128
    s = torch.einsum("bm,vmj->vbj", d[0].to(torch.int64), tile.to(torch.int64))
    assert int(s.abs().max()) <= p.N * 128 * 128
    assert int(s[0].max()) == p.N * 128 * 128     # limb 0 of -g is -128 too


@pytest.mark.parametrize("rows,n,ok", [
    (4, 1024, True), (6, 1024, True), (4, 64, True), (127, 1024, True),
    (128, 1024, False), (4, 32768, False), (4, 32, False), (4, 96, False),
    (4, 1000, False)])
def test_tile_check_bounds(rows, n, ok):
    if ok:
        tile_models.mma_tile_check(rows, n)
    else:
        with pytest.raises(ValueError, match="tensor-core external product"):
            tile_models.mma_tile_check(rows, n)


def test_cpu_tensors_take_the_twin_whatever_the_tile_refuses():
    """The tile's limits hold for launches only: on CPU tensors the
    wrappers run their twins at an N the tile refuses."""
    p = dataclasses.replace(P.TEST_TINY, N=32, name="n32")
    rng = np.random.RandomState(4)
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    with pytest.raises(ValueError):
        tile_models.mma_tile_check(rows, n)
    d = _t(rng.randint(-128, 128, (rows, 3, n)).astype(np.int8))
    bk = _t(_rand_i32(rng, (2, rows, kp1, n)))
    acc = _t(_rand_i32(rng, (kp1, 3, n)))
    bara = _t(rng.randint(0, 2 * n, (3, 2)).astype(np.int32))
    assert torch.equal(kernels.external_product(d, bk[0], p, acc=acc),
                       kernels.external_product_plain(d, bk[0], p, acc))
    assert torch.equal(kernels.blind_rotate_scan(acc, bara, bk, p),
                       kernels.blind_rotate_scan_plain(acc, bara, bk, p))


# ---------------------------------------------------------------------------
# the fused step kernels: digit tile, split parts, clusters, work items
# ---------------------------------------------------------------------------

def _step_case(p, b, seed):
    rng = np.random.RandomState(seed)
    bara = rng.randint(0, 2 * p.N, (b,)).astype(np.int32)
    bara[:3] = (0, p.N, 2 * p.N - 1)[:b]
    return (_rand_i32(rng, (p.k + 1, b, p.N)), bara,
            _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N)))


def _extreme_step_cases(p, b, seed):
    """name -> (acc, bara, bk_i): a random accumulator, and accumulators
    that decompose to -128 and to +127 everywhere at bara = N, on key
    limbs at their ends."""
    acc, bara, bk_i = _step_case(p, b, seed)
    at_n = np.full((b,), p.N, np.int32)
    shape_k = bk_i.shape
    cases = {"random": (acc, bara, bk_i)}
    for digit, limbs in ((-128, LIMBS_LO), (127, LIMBS_HI)):
        a = tile_models.accumulator_for_digits(p, digit, acc.shape).numpy()
        cases[f"digits{digit:+d}"] = (a, at_n,
                                      np.full(shape_k, limbs, np.int32))
    return cases


@pytest.mark.parametrize("p", [P.TEST_TINY, TINY_6ROWS, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("digit", [-128, 127, 0, -1])
def test_accumulator_for_digits_decomposes_to_them(p, digit):
    acc = tile_models.accumulator_for_digits(p, digit, (p.k + 1, 3, p.N))
    assert acc.dtype == torch.int32
    d = kernels.rot_diff_decompose_plain(
        acc, torch.full((3,), p.N, dtype=torch.int32), p)
    assert int(d.min()) == int(d.max()) == digit


def test_accumulator_for_digits_needs_an_even_diff():
    p = dataclasses.replace(P.TEST_TINY, l=4, name="tiny_32bits")
    with pytest.raises(ValueError, match="l \\* bg_bit == 32"):
        tile_models.accumulator_for_digits(p, -127, (2, 1, p.N))


@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("b", [5, 16, 37])
def test_digit_tile_is_the_padded_decomposition(p, b):
    """The (rows, 16, N + 16) tile of each 16 batch rows holds
    rot_diff_decompose_plain's digits, zero rows past the batch and zero
    padding; a (p, column, row) range of it holds that range alone."""
    acc, bara, _ = _step_case(p, b, b)
    want = kernels.rot_diff_decompose_plain(_t(acc), _t(bara), p)
    rows, n = p.trgsw_rows, p.N
    for b0 in range(0, b, 16):
        nb = min(16, b - b0)
        tile = tile_models.cmux_digit_tile(_t(acc), _t(bara), p, b0)
        assert tile.dtype == torch.int8
        assert tile.shape == (rows, 16, n + kernels.DIGIT_ROW_PAD)
        assert torch.equal(tile[:, :nb, :n], want[:, b0:b0 + nb])
        assert not tile[:, nb:].any() and not tile[:, :, n:].any()
        part = tile_models.cmux_digit_tile(_t(acc), _t(bara), p, b0, 1, 2,
                                           n // 4, n // 2, 0, 8)
        keep = torch.zeros_like(tile)
        keep[1:3, :8, n // 4:n // 2] = tile[1:3, :8, n // 4:n // 2]
        assert torch.equal(part, keep)


@pytest.mark.parametrize("rows,n", [(4, 64), (4, 256), (6, 256), (4, 1024),
                                    (6, 1024)])
def test_split_parts_cover_every_pair_once(rows, n):
    """For every split the launch can pick, the parts' (p, chunk) ranges
    partition the tile's pairs, and each part decomposes a rectangle that
    holds its pairs, with a power-of-two count of columns."""
    t = min(n, kernels.MMA_TILE_COLS)
    nchunk = n // t
    nchunks = rows * nchunk
    for split in (s for s in range(1, nchunks + 1) if nchunks % s == 0):
        parts = tile_models.cmux_part_ranges(rows, n, split)
        assert len(parts) == split
        seen = []
        for c_begin, c_end, p_lo, p_hi, col_lo, col_hi in parts:
            assert c_end > c_begin
            ncols = col_hi - col_lo
            assert ncols >= 64 and ncols & (ncols - 1) == 0
            assert 0 <= col_lo and col_hi <= n and col_lo % t == 0
            for c in range(c_begin, c_end):
                pp, m0 = c // nchunk, (c % nchunk) * t
                assert p_lo <= pp <= p_hi
                assert col_lo <= m0 and m0 + t <= col_hi
                seen.append(c)
        assert seen == list(range(nchunks))
    # one chunk a part, as at B=8 and N=1024: nothing decomposed twice
    ones = tile_models.cmux_part_ranges(rows, n, nchunks)
    assert all(p_lo == p_hi and col_hi - col_lo == t
               for _, _, p_lo, p_hi, col_lo, col_hi in ones)


def test_split_for_follows_the_launch():
    # 8 tiles at B=8, N=1024: 16 parts of one chunk; from 132 tiles, none
    assert kernels.mma_split_for(8, 16, 132) == 16
    assert kernels.mma_split_for(128, 16, 132) == 2
    assert kernels.mma_split_for(136, 16, 132) == 1
    assert kernels.mma_split_for(8, 24, 132) == 24
    assert kernels.mma_split_for(24, 24, 132) == 6


@pytest.mark.parametrize("batch", [1, 16, 256, 1024, 1056])
@pytest.mark.parametrize("places", [132, 264])
def test_work_items_visit_every_tile_once(batch, places):
    """The order of work at N=1024, k=1, for the overlap kernel (one
    block an SM) and for fused2 (two): every (batch rows, coefficient
    block, component) tile in exactly one item, items of a row group side
    by side, and no run longer than what fills the card."""
    n, kp1 = 1024, 2
    items = tile_models.step_work_items(batch, n, kp1, places)
    nbt = -(-batch // 16)
    seen = [(b0, jb, o) for b0, tiles in items for jb, o in tiles]
    assert sorted(seen) == sorted(
        (bt * 16, jb, o) for bt in range(nbt) for jb in range(0, n, 256)
        for o in range(kp1))
    assert [b0 for b0, _ in items] == sorted(b0 for b0, _ in items)
    per = kernels.tiles_per_item(nbt, 8, places)
    assert max(len(tiles) for _, tiles in items) == per
    assert len(items) == nbt * -(-8 // per)


def test_tiles_per_item_fills_the_card_with_the_longest_run():
    # overlap, 132 places: B=1024 and 1056 halve a row group, B=2048 keeps
    # it whole; fused2, 264 places: runs of 2 at B=1024, 4 at B=2048
    assert kernels.tiles_per_item(64, 8, 132) == 4
    assert kernels.tiles_per_item(66, 8, 132) == 4
    assert kernels.tiles_per_item(128, 8, 132) == 8
    assert kernels.tiles_per_item(64, 8, 264) == 2
    assert kernels.tiles_per_item(128, 8, 264) == 4
    assert kernels.tiles_per_item(17, 8, 132) == 2
    assert kernels.tiles_per_item(1000, 8, 132) == 8


def test_cluster_shares_partition_the_rows():
    assert kernels.step_cluster_shares(4, 1) == [(0, 8), (8, 16)]
    assert kernels.step_cluster_shares(2, 1) == [(0, 8), (8, 16)]
    assert kernels.step_cluster_shares(3, 1) == [(0, 16)]
    assert kernels.step_cluster_shares(1, 1) == [(0, 16)]
    # a launch that splits the tiles' sums forms no cluster
    assert kernels.step_cluster_shares(8, 16) == [(0, 16)]


@pytest.mark.parametrize("case", ["random", "digits-128", "digits+127"])
@pytest.mark.parametrize("p", [P.TEST_TINY, TINY_6ROWS],
                         ids=lambda p: f"{p.trgsw_rows}rows")
def test_step_models_match_twin_and_pallas(p, case):
    """The digits of the padded tile through the tile's model equal the
    step's twin and JAX's fused kernels in interpret mode (cmux_step at
    b=8, the overlap kernel at one batch block of 8 lanes a rotation
    slice), on random and on extreme-digit accumulators, whether the
    launch splits the tiles' sums (132 SMs) or deals whole tiles (2 and
    1)."""
    slices = (p.k + 1) * p.trgsw_rows
    for b, pallas in ((8, cmux_step_pallas),
                      (8 * slices, cmux_step_overlap_pallas)):
        acc, bara, bk_i = _extreme_step_cases(p, b, p.trgsw_rows + b)[case]
        twin = kernels.cmux_step_plain(_t(acc), _t(bara), _t(bk_i), p)
        want = np.asarray(pallas(jnp.asarray(acc), jnp.asarray(bara),
                                 jnp.asarray(bk_i), p, interpret=True))
        np.testing.assert_array_equal(twin.numpy(), want)
        # the whole padded tile's digits through the tile's model
        d = torch.cat([tile_models.cmux_digit_tile(_t(acc), _t(bara), p, b0)
                       [:, :min(16, b - b0), :p.N]
                       for b0 in range(0, b, 16)], dim=1)
        got = tile_models.external_product_mma_model(d, _t(bk_i), p, _t(acc))
        np.testing.assert_array_equal(got.numpy(), want)
        for sms in ((132, 2) if b == 8 else (1,)):
            for model in (tile_models.cmux_step_mma_model,
                          tile_models.cmux_step_overlap_mma_model):
                got = model(_t(acc), _t(bara), _t(bk_i), p, sms)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{model.__name__} "
                                                      f"b={b} sms={sms}")


@pytest.mark.parametrize("b", [5, 33])
def test_step_models_match_twin_at_small_noisy(b):
    """N=256, 6 rows: ragged batches, split parts that span rows."""
    p = P.TEST_SMALL_NOISY
    acc, bara, bk_i = _step_case(p, b, 90 + b)
    want = kernels.cmux_step_plain(_t(acc), _t(bara), _t(bk_i), p)
    for sms in (132, 4):
        assert torch.equal(tile_models.cmux_step_mma_model(
            _t(acc), _t(bara), _t(bk_i), p, sms), want)
        assert torch.equal(tile_models.cmux_step_overlap_mma_model(
            _t(acc), _t(bara), _t(bk_i), p, sms), want)
