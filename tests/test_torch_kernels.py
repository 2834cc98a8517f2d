"""The port's polynomial core, decomposition and blind-rotation step
against the JAX package, array for array.

Same numpy inputs (made from a seed) go to the JAX function and to its
``ieache_tpu_torch`` counterpart; all arithmetic is exact mod 2^32, so
the tolerance is exact equality.  The two kernels' plain twins are held
against the JAX Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them.  The CUDA kernels themselves are
checked against these twins in tests/test_torch_gpu.py and by
chip_smoke.py.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.core import poly as jpoly
from ieache_tpu.ops import blind_rotate as jbr
from ieache_tpu.ops import decompose as jdec
from ieache_tpu.ops.pallas_kernels import (
    external_product_pallas_t,
    rot_diff_decompose_pallas,
)
from ieache_tpu_torch.core import poly as tpoly
from ieache_tpu_torch.ops import blind_rotate as tbr
from ieache_tpu_torch.ops import decompose as tdec
from ieache_tpu_torch.ops import kernels

#: INT32_MIN, -1 and 2^31-1 and their neighbours
EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                 np.int32)

#: compat gadget (bg_bit=10: two int8 limbs per digit) at TEST_TINY size
TINY_COMPAT = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
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


@pytest.mark.parametrize("base_bit,levels",
                         [(8, 2), (8, 3), (10, 2), (4, 4), (2, 8), (8, 4)])
def test_offset_matches_jax(base_bit, levels):
    assert tdec._offset(base_bit, levels) == jdec._offset(base_bit, levels)


@pytest.mark.parametrize("base_bit,levels", [(8, 2), (8, 3), (10, 2), (2, 8)])
def test_gadget_decompose_matches_jax(base_bit, levels):
    x = _rand_i32(np.random.RandomState(base_bit * 10 + levels), (64, 33))
    want = np.asarray(jdec.gadget_decompose(jnp.asarray(x), base_bit, levels))
    got = tdec.gadget_decompose(_t(x), base_bit, levels).numpy()
    np.testing.assert_array_equal(got, want)


def test_split_i8_limbs_matches_jax():
    x = _rand_i32(np.random.RandomState(1), (257,))
    for nl in (2, 4):
        want = np.asarray(jpoly.split_i8_limbs(jnp.asarray(x), nl))
        np.testing.assert_array_equal(
            tpoly.split_i8_limbs(_t(x), nl).numpy(), want)


def test_toeplitz_and_negacyclic_mul_small_match_jax():
    rng = np.random.RandomState(2)
    n = 64
    g = _rand_i32(rng, (n,))
    d = rng.randint(-128, 128, (5, n)).astype(np.int32)
    np.testing.assert_array_equal(
        tpoly.toeplitz_negacyclic(_t(g)).numpy(),
        np.asarray(jpoly.toeplitz_negacyclic(jnp.asarray(g))))
    got = tpoly.negacyclic_mul_small(_t(d), _t(g)).numpy()
    np.testing.assert_array_equal(got, jpoly.negacyclic_mul_np(d, g))
    np.testing.assert_array_equal(
        got, np.asarray(jpoly.negacyclic_mul_small(jnp.asarray(d),
                                                   jnp.asarray(g))))


def test_make_step_gmatrix_matches_jax():
    p = P.TEST_TINY
    bk_i = _rand_i32(np.random.RandomState(3), (p.trgsw_rows, p.k + 1, p.N))
    np.testing.assert_array_equal(
        tpoly.make_step_gmatrix(_t(bk_i), p).numpy(),
        np.asarray(jbr.make_step_gmatrix(jnp.asarray(bk_i), p)))


def test_negacyclic_rotate_batch_matches_jax():
    p = P.TEST_TINY
    rng = np.random.RandomState(4)
    acc = _rand_i32(rng, (8, p.k + 1, p.N))
    amt = np.array([0, 1, p.N - 1, p.N, p.N + 1, 2 * p.N - 1, 17, 100],
                   np.int32)
    np.testing.assert_array_equal(
        tpoly.negacyclic_rotate_batch(_t(acc), _t(amt)).numpy(),
        np.asarray(jbr.negacyclic_rotate_batch(jnp.asarray(acc),
                                               jnp.asarray(amt))))


@pytest.mark.parametrize("p", [P.TEST_TINY, TINY_COMPAT],
                         ids=lambda p: p.name)
def test_external_product_step_matches_jax(p):
    """Plain CMux step, incl. the two-limb (digit_limbs == 2) branch."""
    rng = np.random.RandomState(5)
    acc = _rand_i32(rng, (6, p.k + 1, p.N))
    bara = rng.randint(0, 2 * p.N, (6,)).astype(np.int32)
    bk_i = _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N))
    want = np.asarray(jbr.external_product_step(
        jnp.asarray(acc), jnp.asarray(bara), jnp.asarray(bk_i), p))
    got = tbr.external_product_step(_t(acc), _t(bara), _t(bk_i), p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [8, 16])
def test_rot_diff_decompose_plain_matches_pallas(b):
    p = P.TEST_TINY
    rng = np.random.RandomState(6 + b)
    acc_t = _rand_i32(rng, (p.k + 1, b, p.N))
    for bara in (rng.randint(0, 2 * p.N, (b,)),
                 *(np.full((b,), a) for a in (0, p.N, 2 * p.N - 1))):
        bara = bara.astype(np.int32)
        want = np.asarray(rot_diff_decompose_pallas(
            jnp.asarray(acc_t), jnp.asarray(bara), p, interpret=True))
        got = kernels.rot_diff_decompose_plain(_t(acc_t), _t(bara), p)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("with_acc", [False, True])
def test_external_product_plain_matches_pallas(b, with_acc):
    p = P.TEST_TINY
    rng = np.random.RandomState(20 + b)
    d = rng.randint(-128, 128, (p.trgsw_rows, b, p.N)).astype(np.int8)
    bk_i = _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N))
    acc_t = _rand_i32(rng, (p.k + 1, b, p.N)) if with_acc else None
    want = np.asarray(external_product_pallas_t(
        jnp.asarray(d), jnp.asarray(bk_i), p,
        acc_t=None if acc_t is None else jnp.asarray(acc_t), interpret=True))
    got = kernels.external_product_plain(
        _t(d), _t(bk_i), p, None if acc_t is None else _t(acc_t))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_run_plain_twins_on_cpu():
    """On CPU tensors the wrappers return their plain twin's arrays and
    launch nothing."""
    p = P.TEST_SMALL_NOISY
    rng = np.random.RandomState(7)
    b = 5
    acc_t = _t(_rand_i32(rng, (p.k + 1, b, p.N)))
    bara = _t(rng.randint(0, 2 * p.N, (b,)).astype(np.int32))
    bk_i = _t(_rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N)))
    before = (kernels.rot_diff_decompose.launches,
              kernels.external_product.launches)
    d = kernels.rot_diff_decompose(acc_t, bara, p)
    assert torch.equal(d, kernels.rot_diff_decompose_plain(acc_t, bara, p))
    out = kernels.external_product(d, bk_i, p, acc=acc_t)
    assert torch.equal(out, kernels.external_product_plain(d, bk_i, p, acc_t))
    assert torch.equal(
        kernels.external_product(d, bk_i, p),
        kernels.external_product_plain(d, bk_i, p))
    assert (kernels.rot_diff_decompose.launches,
            kernels.external_product.launches) == before


def test_wrappers_reject_bad_inputs():
    p = P.TEST_TINY
    b = 4
    acc_t = torch.zeros((p.k + 1, b, p.N), dtype=torch.int32)
    bara = torch.zeros((b,), dtype=torch.int32)
    d = torch.zeros((p.trgsw_rows, b, p.N), dtype=torch.int8)
    bk_i = torch.zeros((p.trgsw_rows, p.k + 1, p.N), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.rot_diff_decompose(acc_t.to(torch.int64), bara, p)
    with pytest.raises(ValueError):
        kernels.rot_diff_decompose(acc_t[:, :3], bara, p)
    with pytest.raises(ValueError):
        kernels.rot_diff_decompose(acc_t.transpose(0, 1).contiguous()
                                   .transpose(0, 1), bara, p)
    with pytest.raises(TypeError):
        kernels.external_product(d.to(torch.int32), bk_i, p)
    with pytest.raises(ValueError):
        kernels.external_product(d, bk_i[:, :1], p)
    with pytest.raises(ValueError):
        kernels.external_product(d, bk_i, p, acc=acc_t[:1])
    # the compat gadget's split pair takes two digit rows a digit, and
    # refuses the single-limb rows; the tr pair refuses it outright
    assert kernels.rot_diff_decompose(acc_t, bara, TINY_COMPAT).shape == \
        (2 * p.trgsw_rows, b, p.N)
    with pytest.raises(ValueError):
        kernels.external_product(d, bk_i, TINY_COMPAT)
    with pytest.raises(ValueError, match="single-limb"):
        kernels.rot_diff_decompose_tr(acc_t.transpose(1, 2).contiguous(),
                                      bara, TINY_COMPAT)
    with pytest.raises(ValueError, match="single-limb"):
        kernels.external_product_tr(d.transpose(1, 2).contiguous(), bk_i,
                                    TINY_COMPAT)


@pytest.mark.parametrize("p", [P.TEST_TINY, TINY_COMPAT],
                         ids=lambda p: p.name)
def test_blind_rotate_matches_jax(p, monkeypatch):
    """Every step mode's loop (plain twins on CPU; ntt's transforms) and
    the plain step loop equal JAX's blind_rotate at a ragged batch; the
    compat gadget takes split's two-limb twins under split and the plain
    step in every other mode, as JAX takes its XLA step."""
    rng = np.random.RandomState(8)
    b = 5
    acc0 = _rand_i32(rng, (b, p.k + 1, p.N))
    bara = rng.randint(0, 2 * p.N, (b, p.n)).astype(np.int32)
    bk = _rand_i32(rng, (p.n, p.trgsw_rows, p.k + 1, p.N))
    want = np.asarray(jbr.blind_rotate(jnp.asarray(acc0), jnp.asarray(bara),
                                       jnp.asarray(bk), p))
    got = tbr.blind_rotate(_t(acc0), _t(bara), _t(bk), p, plain=True)
    np.testing.assert_array_equal(got.numpy(), want)
    for mode in tbr.STEP_MODES:
        monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
        # ntt warns that it cannot take the compat gadget, as JAX does
        with (pytest.warns(UserWarning, match="ntt needs digit_limbs")
              if mode == "ntt" and p.digit_limbs != 1
              else contextlib.nullcontext()):
            got = tbr.blind_rotate(_t(acc0), _t(bara), _t(bk), p)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)
