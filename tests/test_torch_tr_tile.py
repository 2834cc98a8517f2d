"""The ``tr`` step pair's kernels as far as a CPU can hold them: the plain
models in ``ieache_tpu_torch.ops.tile_models`` of
``csrc/external_product_tr.cu`` (the Toeplitz limb tile as the MMA's A
operand through its window over diagonals, the transposed digit stage,
the kernel's arithmetic tile by tile) and of
``csrc/rot_diff_decompose_tr.cu`` (the shared-memory slab and the banks
its reads fall on), against the port's own references, the
plain twins and the JAX package's Pallas kernels in interpret mode on the
same numpy inputs.

All arithmetic is exact mod 2^32: the tolerance is exact equality.  The
CUDA kernels themselves are held against the twins on the card
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
from ieache_tpu.ops.pallas_kernels import (
    external_product_pallas_tr,
    rot_diff_decompose_pallas_tr,
)
from ieache_tpu_torch.core.poly import make_step_gmatrix
from ieache_tpu_torch.ops import kernels, tile_models

#: where a carry between int8 limbs goes wrong: INT32_MIN, -1, 2^31 - 1,
#: 0x7F7F7F7F, 0x80808080, 0
EDGE_KEY_WORDS = np.array([-2**31, -1, 2**31 - 1, 0x7F7F7F7F,
                           0x80808080 - 2**32, 0], np.int32)

LIMBS_LO, LIMBS_HI = 0x80808080 - 2**32, 0x7F7F7F7F   # limbs all -128 / +127

PARAMS = [P.TEST_TINY, P.TEST_SMALL_NOISY]


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
    return rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _edge_key(shape):
    return EDGE_KEY_WORDS[np.arange(int(np.prod(shape))) %
                          len(EDGE_KEY_WORDS)].reshape(shape)


# ---------------------------------------------------------------------------
# external_product_tr: the A operand, the stage, the arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mcols", [(64, 64), (128, 128), (256, 256),
                                     (1024, 256), (1024, 1024)])
def test_a_operand_map_reproduces_the_toeplitz_tile(n, mcols):
    """The byte planes read through the A fragment map give the transpose
    of make_step_gmatrix's (mcols, T) tile (the Toeplitz matrix of
    negacyclic_extend), every limb, for every block of coefficients and
    digit columns."""
    p = dataclasses.replace(P.TEST_TINY, N=n, name=f"n{n}")
    bk_i = _t(_rand_i32(np.random.RandomState(n + mcols), (1, 1, n)))
    want = make_step_gmatrix(bk_i, p)[:, 0, 0]          # (L, m, j)
    t = min(n, kernels.MMA_TILE_COLS)
    for jb in range(0, n, t):
        for ma in range(0, n, mcols):
            got = tile_models.mma_toeplitz_tile_a(
                tile_models.mma_planes(bk_i[0, 0], jb, ma, mcols), n, mcols)
            assert got.shape == (4, t, mcols)
            assert torch.equal(
                got, want[:, ma:ma + mcols, jb:jb + t].transpose(1, 2)), \
                (jb, ma)


@pytest.mark.parametrize("ni", [2, 4, 8])
def test_a_registers_take_every_window_entry(ni):
    """The four A registers of the warp's NI/2 m-tiles read entries of
    the window of NI + 2 diagonals only, and between them all of it:
    a1 one diagonal below a0, a2 two above, a3 one above."""
    taken = {tile_models.mma_a_window_index(ni, mt, r)
             for mt in range(ni // 2) for r in range(4)}
    assert taken == set(range(ni + 2))
    for mt in range(ni // 2):
        a0 = tile_models.mma_a_window_index(ni, mt, 0)
        assert [tile_models.mma_a_window_index(ni, mt, r) - a0
                for r in range(4)] == [0, -1, 2, 1]


@pytest.mark.parametrize("b,b0", [(16, 0), (40, 32), (5, 0), (1056, 1040)])
@pytest.mark.parametrize("t", [64, 256])
def test_stage_is_a_transpose_of_the_digit_chunk(t, b, b0):
    """The raw stage and its byte-block transpose give the (16, T + 16)
    buffer of d[p, m0c .. m0c + T - 1, b0 .. b0 + 15] transposed, lanes
    past the batch and the padding zero."""
    rng = np.random.RandomState(t + b)
    d = _t(rng.randint(-128, 128, (2, 2 * t, b)).astype(np.int8))
    got = tile_models.tr_stage_model(d, 1, t, b0, t)
    nb = min(16, b - b0)
    want = torch.zeros((16, t + 16), dtype=torch.int8)
    want[:nb, :t] = d[1, t:2 * t, b0:b0 + nb].transpose(0, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [64, 128, 256])
def test_transpose_reads_fall_on_32_banks(t):
    """Each warp's four column reads of the raw stage touch 32 distinct
    banks (the 16 bytes of padding after every 8 columns)."""
    words = tile_models.tr_transpose_reads(t)
    for w0 in range(0, t, 32):
        for mi in range(4):
            banks = words[w0:w0 + 32, mi] % 32
            assert len(set(banks.tolist())) == min(32, t - w0)
    assert tile_models.tr_raw_offset(t) == 18 * t


def _operands(p, b, case, rng):
    shape_d, shape_k = (p.trgsw_rows, p.N, b), (p.trgsw_rows, p.k + 1, p.N)
    if case == "d-128_key-128":
        return np.full(shape_d, -128, np.int8), np.full(shape_k, LIMBS_LO,
                                                        np.int32)
    if case == "d+127_key+127":
        return np.full(shape_d, 127, np.int8), np.full(shape_k, LIMBS_HI,
                                                       np.int32)
    if case == "edge_key":
        return (rng.randint(-128, 128, shape_d).astype(np.int8),
                _edge_key(shape_k))
    return (rng.randint(-128, 128, shape_d).astype(np.int8),
            _rand_i32(rng, shape_k))


@pytest.mark.parametrize("case", ["random", "d-128_key-128", "d+127_key+127",
                                  "edge_key"])
@pytest.mark.parametrize("b", [1, 5, 8, 16, 40])
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_tr_model_matches_the_twin(p, b, case):
    """The kernel's arithmetic tile by tile (split over parts as the
    launch splits it), with and without the accumulator: equal to the
    plain twin on random and extreme operands."""
    rng = np.random.RandomState(b)
    d, bk_i = _operands(p, b, case, rng)
    acc = _t(_rand_i32(rng, (p.k + 1, p.N, b)))
    for a in (None, acc):
        got = tile_models.external_product_tr_mma_model(_t(d), _t(bk_i), p, a)
        assert got.dtype == torch.int32 and got.shape == (p.k + 1, p.N, b)
        assert torch.equal(
            got, kernels.external_product_tr_plain(_t(d), _t(bk_i), p, a))


def test_tr_model_over_several_tiles_and_segments():
    """N = 1024: four coefficient tiles, each over segments of four
    chunks, 6 TRGSW rows, one part a tile at B = 1024's grid."""
    p = dataclasses.replace(P.TEST_TINY, N=1024, l=3, name="n1024_6rows")
    rng = np.random.RandomState(3)
    d = _t(rng.randint(-128, 128, (6, 1024, 3)).astype(np.int8))
    bk_i = _t(_rand_i32(rng, (6, 2, 1024)))
    acc = _t(_rand_i32(rng, (2, 1024, 3)))
    want = kernels.external_product_tr_plain(d, bk_i, p, acc)
    for sms in (132, 1):
        assert torch.equal(
            tile_models.external_product_tr_mma_model(d, bk_i, p, acc,
                                                      sms=sms),
            want)


@pytest.mark.parametrize("case", ["random", "d-128_key-128"])
def test_tr_model_matches_pallas(case):
    """The model equal to JAX's external_product_pallas_tr in interpret
    mode at TEST_TINY (JAX's kernel always adds its accumulator)."""
    p = P.TEST_TINY
    rng = np.random.RandomState(17)
    d, bk_i = _operands(p, 8, case, rng)
    acc = _rand_i32(rng, (p.k + 1, p.N, 8))
    want = np.asarray(external_product_pallas_tr(
        jnp.asarray(d), jnp.asarray(bk_i), p, jnp.asarray(acc),
        interpret=True))
    got = tile_models.external_product_tr_mma_model(_t(d), _t(bk_i), p,
                                                    _t(acc))
    np.testing.assert_array_equal(got.numpy(), want)


def test_tr_model_refuses_what_the_kernel_refuses():
    p = dataclasses.replace(P.TEST_TINY, N=32, name="n32")
    d = torch.zeros((p.trgsw_rows, 32, 1), dtype=torch.int8)
    bk_i = torch.zeros((p.trgsw_rows, 2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two >= 64"):
        tile_models.external_product_tr_mma_model(d, bk_i, p)


# ---------------------------------------------------------------------------
# rot_diff_decompose_tr: the slab
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 5, 16, 40])
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_slab_model_matches_the_twin(p, b):
    """Random amounts and the edge amounts 0, N and 2N - 1."""
    rng = np.random.RandomState(30 + b)
    acc = _t(_rand_i32(rng, (p.k + 1, p.N, b)))
    for bara in (rng.randint(0, 2 * p.N, (b,)),
                 *(np.full((b,), a) for a in (0, p.N, 2 * p.N - 1))):
        bara = _t(bara.astype(np.int32))
        got = tile_models.rot_diff_decompose_tr_slab_model(acc, bara, p)
        assert got.dtype == torch.int8
        assert torch.equal(got,
                           kernels.rot_diff_decompose_tr_plain(acc, bara, p))


@pytest.mark.parametrize("sms,splits", [(1, 1), (4, 2), (16, 8), (32, 16),
                                        (132, 16)])
def test_slab_model_at_every_split(sms, splits):
    """TEST_SMALL_NOISY (N = 256, 2 slabs at B = 16) with 1 to 8 blocks a
    slab, and from 16 the gather: every route equals the twin."""
    p = P.TEST_SMALL_NOISY
    assert kernels.rot_tr_splits(p.k + 1, p.N, sms) == splits
    rng = np.random.RandomState(60 + splits)
    acc = _t(_rand_i32(rng, (p.k + 1, p.N, 16)))
    bara = _t(np.concatenate([rng.randint(0, 2 * p.N, (13,)),
                              [0, p.N, 2 * p.N - 1]]).astype(np.int32))
    got = tile_models.rot_diff_decompose_tr_slab_model(acc, bara, p, sms=sms)
    assert torch.equal(got, kernels.rot_diff_decompose_tr_plain(acc, bara, p))


def test_slab_model_matches_pallas():
    p = P.TEST_TINY
    rng = np.random.RandomState(8)
    acc = _rand_i32(rng, (p.k + 1, p.N, 8))
    bara = rng.randint(0, 2 * p.N, (8,)).astype(np.int32)
    want = np.asarray(rot_diff_decompose_pallas_tr(
        jnp.asarray(acc), jnp.asarray(bara), p, interpret=True))
    got = tile_models.rot_diff_decompose_tr_slab_model(_t(acc), _t(bara), p)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blocks,n,want", [
    (128, 1024, 2), (132, 1024, 1), (2, 1024, 64), (2, 64, 4), (8, 256, 16),
    (260, 1024, 1)])
def test_slab_splits(blocks, n, want):
    """One block a slab once the slabs reach the SMs; else a power of two
    of blocks share a slab, at least 16 rows each."""
    assert kernels.rot_tr_splits(blocks, n) == want


@pytest.mark.parametrize("b,gathers", [
    (1, True), (8, True), (16, True), (128, True), (129, False),
    (256, False), (1024, False), (1056, False)])
def test_slab_or_gather_by_batch(b, gathers):
    """At IEACHE_110_FAST (k + 1 = 2, N = 1024, 132 SMs) the rotation
    gathers up to B = 128, where 16 or more blocks would share a slab,
    and loads slabs from B = 129 on."""
    splits = kernels.rot_tr_splits(-(-b // kernels.TR_SLAB_LANES) * 2, 1024)
    assert (splits >= kernels.TR_GATHER_SPLITS) == gathers


@settings(max_examples=200, deadline=None)
@given(j0=st.integers(0, 1023).map(lambda j: j - j % 2),
       bara=st.lists(st.integers(0, 2047), min_size=16, max_size=16))
def test_slab_reads_are_free_of_bank_conflicts(j0, bara):
    """A warp's two rows x 16 lanes read 32 distinct banks, rotated and
    plain, whatever each lane's amount."""
    rot, plain = tile_models.rot_tr_slab_banks(j0, torch.tensor(bara), 1024)
    assert len(set(rot.tolist())) == 32
    assert len(set(plain.tolist())) == 32


@pytest.mark.parametrize("amount", [0, 1024, 2047])
@pytest.mark.parametrize("j0", [0, 2, 1022])
def test_slab_reads_at_the_edge_amounts(j0, amount):
    rot, plain = tile_models.rot_tr_slab_banks(
        j0, torch.full((16,), amount), 1024)
    assert len(set(rot.tolist())) == 32 and len(set(plain.tolist())) == 32


def test_slab_bytes_join_the_predicate():
    """The tr predicate is the tensor-core tile's plus the slab: N = 4096
    is the first ring degree whose slab does not fit a block."""
    assert kernels.rot_tr_slab_bytes(1024) == 64 * 1024
    assert kernels.kernels_refusal("tr", 4, 2048) is None
    why = kernels.kernels_refusal("tr", 4, 4096)
    assert why is not None and "slab" in why
    assert kernels.kernels_refusal("split", 4, 4096) is None
    for n in (32, 96):
        assert "power of two >= 64" in kernels.kernels_refusal("tr", 4, n)
    assert "rows * N" in kernels.kernels_refusal("tr", 128, 1024)
    # split's rotation keeps its own predicate: N % 8 == 0
    assert kernels.rotation_refusal(32) is None
    assert kernels.rotation_refusal(4) is not None
