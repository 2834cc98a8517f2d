"""The blind rotation's step modes (``IEACHE_PALLAS_STEP``) on the port
against the JAX package, array for array.

The plain twins of the fused2, overlap and scan kernels are held
against the JAX Pallas kernels run in interpret mode (the tr pair's in
tests/test_torch_transposed_ntt.py), as
tests/test_pallas_kernels.py runs them; the port's ``bootstrap`` under
each step mode is held against the JAX ``bootstrap`` under
``IEACHE_PALLAS=interpret`` and the same mode.  Same numpy inputs (made
from a seed) go to both packages; all arithmetic is exact mod 2^32, so
the tolerance is exact equality.  The CUDA kernels themselves are
checked against these twins in tests/test_torch_gpu.py and by
chip_smoke.py.
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ieache_tpu.boot.bootstrap as JB
from ieache_tpu import params as P
from ieache_tpu.core import ntt as jntt
from ieache_tpu.lwe import keygen
from ieache_tpu.ops.pallas_kernels import (
    blind_rotate_scan_pallas,
    cmux_step_overlap2_pallas,
    cmux_step_overlap_pallas,
    cmux_step_pallas,
)
from ieache_tpu.utils import prng
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch.lwe import encrypt as tenc
from ieache_tpu_torch.ops import blind_rotate as tbr
from ieache_tpu_torch.ops import kernels

#: INT32_MIN, -1 and 2^31-1 and their neighbours
EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                 np.int32)

#: compat gadget (bg_bit=10: two int8 limbs per digit) at TEST_TINY size
TINY_COMPAT = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")

ALL_WRAPPERS = (kernels.rot_diff_decompose, kernels.external_product,
                kernels.cmux_step, kernels.cmux_step_overlap,
                kernels.blind_rotate_scan, kernels.rot_diff_decompose_tr,
                kernels.external_product_tr)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _env(**values):
    """Set (or, for None, unset) environment variables, clearing JAX's
    caches on entry and exit: the JAX package reads IEACHE_PALLAS and
    IEACHE_PALLAS_STEP while it traces."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.clear_caches()
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.clear_caches()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_i32(rng, shape):
    x = rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return x


def _amounts(rng, p, b):
    """Rotation amounts: random, then the edges 0, N and 2N-1."""
    return [rng.randint(0, 2 * p.N, (b,)).astype(np.int32),
            *(np.full((b,), a, np.int32) for a in (0, p.N, 2 * p.N - 1))]


@pytest.mark.parametrize("b", [8, 16])
def test_cmux_step_plain_matches_pallas(b):
    p = P.TEST_TINY
    rng = np.random.RandomState(30 + b)
    acc_t = _rand_i32(rng, (p.k + 1, b, p.N))
    bk_i = _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N))
    for bara in _amounts(rng, p, b):
        want = np.asarray(cmux_step_pallas(
            jnp.asarray(acc_t), jnp.asarray(bara), jnp.asarray(bk_i), p,
            interpret=True))
        got = kernels.cmux_step_plain(_t(acc_t), _t(bara), _t(bk_i), p)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            kernels.cmux_step(_t(acc_t), _t(bara), _t(bk_i), p).numpy(), want)


@pytest.mark.parametrize("pallas", [cmux_step_overlap_pallas,
                                    cmux_step_overlap2_pallas],
                         ids=["overlap", "overlap2"])
@pytest.mark.parametrize("b", [64, 512])
def test_cmux_step_overlap_plain_matches_pallas(pallas, b):
    """b=64 is one batch block of the JAX overlap kernel, b=512 four:
    its cross-block digit hand-off runs."""
    p = P.TEST_TINY
    rng = np.random.RandomState(40 + b)
    acc_t = _rand_i32(rng, (p.k + 1, b, p.N))
    bara = rng.randint(0, 2 * p.N, (b,)).astype(np.int32)
    bara[:3] = (0, p.N, 2 * p.N - 1)
    bk_i = _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N))
    want = np.asarray(pallas(jnp.asarray(acc_t), jnp.asarray(bara),
                             jnp.asarray(bk_i), p, interpret=True))
    got = kernels.cmux_step_overlap(_t(acc_t), _t(bara), _t(bk_i), p)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("sms", [132, 1])
def test_fused_step_models_match_pallas(p, sms):
    """The plain models of the two fused kernels' work (digit tiles in
    shared memory, split parts on a card of 132 SMs, whole work items on
    a card of one) against JAX's cmux_step kernel in interpret mode, at
    every edge amount."""
    b = 8
    rng = np.random.RandomState(35 + p.N)
    acc_t = _rand_i32(rng, (p.k + 1, b, p.N))
    bk_i = _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N))
    for bara in _amounts(rng, p, b):
        want = np.asarray(cmux_step_pallas(
            jnp.asarray(acc_t), jnp.asarray(bara), jnp.asarray(bk_i), p,
            interpret=True))
        for model in (kernels.cmux_step_mma_model,
                      kernels.cmux_step_overlap_mma_model):
            got = model(_t(acc_t), _t(bara), _t(bk_i), p, sms)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [8, 16])
def test_blind_rotate_scan_plain_matches_pallas(b):
    """All n = 8 steps of TEST_TINY, edge amounts in the first steps."""
    p = P.TEST_TINY
    rng = np.random.RandomState(50 + b)
    acc_t = _rand_i32(rng, (p.k + 1, b, p.N))
    bara = rng.randint(0, 2 * p.N, (b, p.n)).astype(np.int32)
    bara[:, :3] = (0, p.N, 2 * p.N - 1)
    bk = _rand_i32(rng, (p.n, p.trgsw_rows, p.k + 1, p.N))
    want = np.asarray(blind_rotate_scan_pallas(
        jnp.asarray(acc_t), jnp.asarray(bara), jnp.asarray(bk), p,
        interpret=True))
    got = kernels.blind_rotate_scan(_t(acc_t), _t(bara), _t(bk), p)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kernels.blind_rotate_scan_plain(_t(acc_t), _t(bara), _t(bk), p)
        .numpy(), want)


@functools.cache
def _tiny_keys():
    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    return ks, JB.pack_cloud_key(ks.cloud), TB.pack_cloud_key(ks.cloud, "cpu")


@pytest.mark.parametrize("mode", tbr.STEP_MODES)
def test_bootstrap_step_mode_matches_jax(mode):
    """The slice as a whole: the port's bootstrap under one step mode
    against the JAX bootstrap with its Pallas kernels interpreted under
    the same mode, at B=64; both decrypt to the bits."""
    ks, jkey, tkey = _tiny_keys()
    bits = prng.uniform_bits01(prng.key_from_seed_words([60]), 64)
    ct = tenc.encrypt_bits(ks, bits, prng.key_from_seed_words([61]), "cpu")
    # JAX's ntt caches its device tables in a module dict on first use:
    # fill it outside the jitted bootstrap, or the cache would keep tracers
    jntt._dev_tables(P.TEST_TINY.N)
    with _env(IEACHE_PALLAS="interpret", IEACHE_PALLAS_STEP=mode):
        want = np.asarray(JB.bootstrap(jnp.asarray(ct.numpy()), jkey))
        before = [w.launches for w in ALL_WRAPPERS]
        got = TB.bootstrap(ct, tkey)
        assert [w.launches for w in ALL_WRAPPERS] == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, got), bits)


def test_step_mode_is_read_at_each_call():
    with _env(IEACHE_PALLAS_STEP=None):
        assert tbr.step_mode() == "split"
    with _env(IEACHE_PALLAS_STEP="auto"):
        assert tbr.step_mode() == "split"
    for mode in tbr.STEP_MODES:
        with _env(IEACHE_PALLAS_STEP=mode):
            assert tbr.step_mode() == mode


@pytest.mark.parametrize("mode", ["bogus", "tr:probe_nodot"])
def test_unported_step_modes_raise(mode):
    """A mode the port does not run (an unknown name, or one of the JAX
    tr kernel's garbage-output timing probes) raises rather than run
    another mode; plain=True, which never reaches a kernel, still
    runs."""
    p = P.TEST_TINY
    rng = np.random.RandomState(70)
    acc0 = _t(_rand_i32(rng, (3, p.k + 1, p.N)))
    bara = _t(rng.randint(0, 2 * p.N, (3, p.n)).astype(np.int32))
    bk = _t(_rand_i32(rng, (p.n, p.trgsw_rows, p.k + 1, p.N)))
    with _env(IEACHE_PALLAS_STEP=mode):
        with pytest.raises(ValueError, match="IEACHE_PALLAS_STEP"):
            tbr.blind_rotate(acc0, bara, bk, p)
        tbr.blind_rotate(acc0, bara, bk, p, plain=True)


def test_step_wrappers_refuse_compat_and_bad_inputs():
    p = P.TEST_TINY
    b = 4
    acc = torch.zeros((p.k + 1, b, p.N), dtype=torch.int32)
    bara = torch.zeros((b,), dtype=torch.int32)
    bk_i = torch.zeros((p.trgsw_rows, p.k + 1, p.N), dtype=torch.int32)
    bara_n = torch.zeros((b, p.n), dtype=torch.int32)
    bk = torch.zeros((p.n, p.trgsw_rows, p.k + 1, p.N), dtype=torch.int32)
    for step in (kernels.cmux_step, kernels.cmux_step_overlap):
        with pytest.raises(ValueError, match="single-limb"):
            step(acc, bara, bk_i, TINY_COMPAT)
        with pytest.raises(TypeError):
            step(acc.to(torch.int64), bara, bk_i, p)
        with pytest.raises(ValueError):
            step(acc[:, :3], bara, bk_i, p)
        with pytest.raises(ValueError):
            step(acc, bara, bk_i[:, :1], p)
        with pytest.raises(ValueError):
            step(acc.transpose(1, 2).contiguous().transpose(1, 2), bara,
                 bk_i, p)
    with pytest.raises(ValueError, match="single-limb"):
        kernels.blind_rotate_scan(acc, bara_n, bk, TINY_COMPAT)
    with pytest.raises(ValueError):
        kernels.blind_rotate_scan(acc, bara_n[:, :3], bk, p)
    with pytest.raises(ValueError):
        kernels.blind_rotate_scan(acc, bara_n, bk[:, :, :1], p)
    with pytest.raises(TypeError):
        kernels.blind_rotate_scan(acc, bara_n.to(torch.int64), bk, p)
