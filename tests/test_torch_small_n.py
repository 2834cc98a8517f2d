"""A ring degree the port's kernels refuse: the blind rotation takes the
plain step, as the JAX package takes its XLA step where its Pallas
kernels cannot run, and returns the same arrays.

``ieache_tpu_torch.ops.kernels.kernels_take`` is the one predicate that
the wrappers' refusals and ``blind_rotate`` share.  The same numpy inputs
(made from a seed) go to the JAX ``blind_rotate`` and to the port's under
every step mode and route; all arithmetic is exact mod 2^32, so the
tolerance is exact equality.  On the card the same routing is held in
tests/test_torch_gpu.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.ops import blind_rotate as jbr
from ieache_tpu_torch.ops import blind_rotate as tbr
from ieache_tpu_torch.ops import kernels

#: the smallest input that showed the fault: N below the tile's 64
N32 = P.TFHEParams(n=8, N=32, k=1, bg_bit=8, l=2, ks_basebit=4, ks_t=4,
                   lwe_noise_scale=0, tlwe_noise_scale=0, name="n32")

#: N % 8 != 0: even split's rotation kernel refuses it
N4 = dataclasses.replace(N32, N=4, name="n4")

TILE_MODES = ("split", "fused2", "overlap", "overlap2", "scan")


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


def _case(p, b, seed):
    rng = np.random.RandomState(seed)

    def i32(shape):
        return rng.randint(-2**31, 2**31, shape, dtype=np.int64) \
            .astype(np.int32)

    return (i32((b, p.k + 1, p.N)),
            rng.randint(0, 2 * p.N, (b, p.n)).astype(np.int32),
            i32((p.n, p.trgsw_rows, p.k + 1, p.N)))


@pytest.mark.parametrize("mode", tbr.STEP_MODES)
def test_predicate_by_mode_and_ring_degree(mode):
    """Every mode with kernels runs its products on the tensor-core
    tile, which takes N a power of two from 64 with rows * N < 2^17 (tr
    also its rotation's slab); ntt has no kernel to refuse."""
    takes = {n: kernels.kernels_take(mode, dataclasses.replace(N32, N=n))
             for n in (4, 32, 64, 1024)}
    if mode in TILE_MODES + ("tr",):
        assert takes == {4: False, 32: False, 64: True, 1024: True}
    else:
        assert all(takes.values())
    assert kernels.kernels_take(mode, P.IEACHE_110_FAST)
    assert kernels.kernels_take(mode, P.IEACHE_110)
    assert kernels.kernels_take(mode, P.TEST_TINY)


@pytest.mark.parametrize("mode,rows,ok", [
    ("split", 127, True), ("scan", 12, True), ("scan", 13, False),
    ("split", 128, False), ("fused2", 12, True), ("fused2", 13, False),
    ("overlap", 6, True), ("overlap2", 6, True), ("overlap", 7, False)])
def test_predicate_holds_the_digit_tiles_to_a_block_s_shared_memory(
        mode, rows, ok):
    """At N=1024 a fused2 or scan block keeps one (rows, 16, N + 16) digit
    tile beside the 21 KB of byte planes (a scan block also 16 amounts)
    and an overlap block two; split streams its digits and is bound by
    rows * N alone."""
    why = kernels.kernels_refusal(mode, rows, 1024)
    assert (why is None) == ok, why
    if not ok:
        assert "tensor-core external product" in why
    assert kernels.mma_planes_bytes(1024) == 20992
    assert kernels.digit_tile_bytes(4, 1024) == 4 * 16 * 1040
    assert (kernels.mma_planes_bytes(1024)
            + 2 * kernels.digit_tile_bytes(6, 1024)
            <= kernels.SMEM_BLOCK_BYTES)


def test_tile_check_is_the_predicate():
    for rows, n in ((4, 1024), (4, 32), (128, 1024), (4, 96)):
        why = kernels.kernels_refusal("split", rows, n)
        if why is None:
            kernels.mma_tile_check(rows, n)
        else:
            with pytest.raises(ValueError) as err:
                kernels.mma_tile_check(rows, n)
            assert str(err.value) == why


@pytest.mark.parametrize("route", ["auto", "interpret", "0"])
@pytest.mark.parametrize("mode", tbr.STEP_MODES)
@pytest.mark.parametrize("p", [N32, N4], ids=lambda p: p.name)
def test_blind_rotate_at_small_n_matches_jax(p, mode, route, monkeypatch):
    """The port's blind rotation equals JAX's under every step mode and
    route, and where the mode's kernels refuse the shape every step is
    the plain step."""
    b = 3
    acc0, bara, bk = _case(p, b, p.N)
    want = np.asarray(jbr.blind_rotate(jnp.asarray(acc0), jnp.asarray(bara),
                                       jnp.asarray(bk), p))
    calls = []
    step = tbr.external_product_step
    monkeypatch.setattr(
        tbr, "external_product_step",
        lambda *a: calls.append(1) or step(*a))
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
    monkeypatch.setenv("IEACHE_PALLAS", route)
    got = tbr.blind_rotate(_t(acc0), _t(bara), _t(bk), p)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = (route == "0" or not kernels.kernels_take(mode, p)) \
        and mode != "ntt"
    assert len(calls) == (p.n if plain else 0)


@pytest.mark.parametrize("mode", TILE_MODES + ("tr",))
def test_pallas_1_raises_where_the_kernels_refuse(mode, monkeypatch):
    p = N32
    acc0, bara, bk = _case(p, 1, 7)
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
    monkeypatch.setenv("IEACHE_PALLAS", "1")
    with pytest.raises(ValueError, match="refuse this shape"):
        tbr.blind_rotate(_t(acc0), _t(bara), _t(bk), p)
    # plain=True never asks for a kernel
    tbr.blind_rotate(_t(acc0), _t(bara), _t(bk), p, plain=True)


def test_bootstrap_at_small_n_matches_jax():
    """The whole gate bootstrap at N=32 under the default mode: keys from
    the JAX package's generator, the port's result equal to JAX's."""
    import ieache_tpu.boot.bootstrap as JB
    import ieache_tpu_torch.boot.bootstrap as TB
    from ieache_tpu.lwe import keygen
    from ieache_tpu.utils import prng
    from ieache_tpu_torch.lwe import encrypt as tenc

    ks = keygen.generate_secret_keyset(N32)
    bits = prng.uniform_bits01(prng.key_from_seed_words([32]), 9)
    ct = tenc.encrypt_bits(ks, bits, prng.key_from_seed_words([33]), "cpu")
    want = np.asarray(JB.bootstrap(jnp.asarray(ct.numpy()),
                                   JB.pack_cloud_key(ks.cloud)))
    got = TB.bootstrap(ct, TB.pack_cloud_key(ks.cloud, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, got), bits)
