"""The tensor-core tile of ``csrc/mma_tile.cuh``, as far as a CPU can
hold it: the plain model of its operand construction in
``ieache_tpu_torch.ops.kernels`` (byte planes, shifted reversed copies,
the fragment map, the per-limb fold) against the port's own references,
the external product's plain twin, and the JAX package's Pallas kernel
run in interpret mode on the same numpy inputs.

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
from ieache_tpu.ops.pallas_kernels import external_product_pallas_t
from ieache_tpu_torch.core.poly import negacyclic_extend, split_i8_limbs
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


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_biased_xor_bytes_are_the_balanced_limbs(n):
    """Byte v of (e + 0x80808080) ^ 0x80808080, sign-extended, is limb v
    of split_i8_limbs(negacyclic_extend(g)), edge words included."""
    g = _t(_rand_i32(np.random.RandomState(n), (3, n)))
    e = negacyclic_extend(g)
    got = kernels.mma_limb_bytes(e)
    assert got.dtype == torch.int8 and got.shape == (3, 2 * n, 4)
    assert torch.equal(got, split_i8_limbs(e))
    # and -e of every edge word, which the extension holds too
    edges = _t(EDGES)
    assert torch.equal(kernels.mma_limb_bytes(-edges), split_i8_limbs(-edges))


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
            planes = kernels.mma_planes(bk_i[0, 0], jb, ma, mcols)
            assert planes.shape == (4, 4, t + mcols)
            got = kernels.mma_toeplitz_tile(planes, n, mcols)
            assert torch.equal(got, want[:, ma:ma + mcols, jb:jb + t]), \
                (jb, ma)


def test_shifted_copies_are_one_plane_shifted():
    """Copy s of a plane is copy 0 moved down by s bytes: an aligned word
    of copy s is the unaligned word of copy 0 at byte offset + s."""
    g = _t(_rand_i32(np.random.RandomState(9), (256,)))
    planes = kernels.mma_planes(g, 0, 0, 256)
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
    got = kernels.external_product_mma_model(_t(d), _t(bk_i), p, _t(acc))
    twin = kernels.external_product_plain(_t(d), _t(bk_i), p, _t(acc))
    assert got.dtype == torch.int32 and torch.equal(got, twin)
    want = np.asarray(external_product_pallas_t(
        jnp.asarray(d), jnp.asarray(bk_i), p, acc_t=jnp.asarray(acc),
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(
        kernels.external_product_mma_model(_t(d), _t(bk_i), p),
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
    assert torch.equal(kernels.external_product_mma_model(d, bk_i, p, acc),
                       kernels.external_product_plain(d, bk_i, p, acc))


def test_limb_sums_stay_exact_up_to_the_bound():
    """At the largest operands each limb's sum is rows * N * 2^14 in
    magnitude: below 2^31 exactly while rows * N < MMA_MAX_TERMS."""
    assert (kernels.MMA_MAX_TERMS - 1) * 128 * 128 < 2**31
    assert kernels.MMA_MAX_TERMS * 128 * 128 >= 2**31
    p = TINY_6ROWS
    d = torch.full((p.trgsw_rows, 1, p.N), -128, dtype=torch.int8)
    tile = kernels.mma_toeplitz_tile(
        kernels.mma_planes(torch.full((p.N,), LIMBS_LO, dtype=torch.int32),
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
        kernels.mma_tile_check(rows, n)
    else:
        with pytest.raises(ValueError, match="tensor-core external product"):
            kernels.mma_tile_check(rows, n)


def test_cpu_tensors_take_the_twin_whatever_the_tile_refuses():
    """The tile's limits hold for launches only: on CPU tensors the
    wrappers run their twins at an N the tile refuses."""
    p = dataclasses.replace(P.TEST_TINY, N=32, name="n32")
    rng = np.random.RandomState(4)
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    with pytest.raises(ValueError):
        kernels.mma_tile_check(rows, n)
    d = _t(rng.randint(-128, 128, (rows, 3, n)).astype(np.int8))
    bk = _t(_rand_i32(rng, (2, rows, kp1, n)))
    acc = _t(_rand_i32(rng, (kp1, 3, n)))
    bara = _t(rng.randint(0, 2 * n, (3, 2)).astype(np.int32))
    assert torch.equal(kernels.external_product(d, bk[0], p, acc=acc),
                       kernels.external_product_plain(d, bk[0], p, acc))
    assert torch.equal(kernels.blind_rotate_scan(acc, bara, bk, p),
                       kernels.blind_rotate_scan_plain(acc, bara, bk, p))
