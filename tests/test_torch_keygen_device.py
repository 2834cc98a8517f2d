"""The port's device keygen, device encryption and torch threefry
against its own host generators and against the JAX package's device
path, array for array, on CPU tensors.

The same seed words and stream keys go to all sides; all arithmetic is
exact mod 2^32, so the tolerance is exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as JP
from ieache_tpu.lwe import encrypt as jenc
from ieache_tpu.lwe import keygen as jkeygen
from ieache_tpu.lwe import keygen_device as jkd
from ieache_tpu.utils import prng as jprng
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch import params as TP
from ieache_tpu_torch.lwe import encrypt as tenc
from ieache_tpu_torch.lwe import keygen as tkeygen
from ieache_tpu_torch.lwe import keygen_device as tkd
from ieache_tpu_torch.utils import prng as tprng

#: keys and counters at the edges: 0, -1, INT32_MIN, 2^31-1 as int32
EDGE_WORDS = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 0x9E3779B9]

PARAMS = ["TEST_TINY", "TEST_SMALL_NOISY"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(t):
    """An int32 tensor's bit patterns as uint32."""
    return t.numpy().view(np.uint32)


def _assert_keysets_equal(a, b):
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    for x, y in ((a.lwe_key.s, b.lwe_key.s),
                 (a.trlwe_key.coefs, b.trlwe_key.coefs),
                 (a.cloud.bk, b.cloud.bk), (a.cloud.ks, b.cloud.ks)):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_torch_threefry_matches_numpy_and_jax_at_edges():
    words = np.array(EDGE_WORDS, np.uint32)
    for k0 in EDGE_WORDS:
        for k1 in EDGE_WORDS[:4]:
            got = tprng.torch_threefry2x32((k0, k1), words, words[::-1].copy(),
                                           "cpu")
            want = jprng.threefry2x32((k0, k1), (words, words[::-1]))
            jgot = jprng.jax_threefry2x32((k0, k1), words, words[::-1])
            for g, w, j in zip(got, want, jgot):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(_u32(g), w)
                np.testing.assert_array_equal(_u32(g), np.asarray(j))
    # counters given as int32 tensors (the bit patterns), keys as ints
    x = torch.tensor([0, -1, -2**31, 2**31 - 1], dtype=torch.int32)
    got = tprng.torch_threefry2x32((-1 & 0xFFFFFFFF, 0), x, x.flip(0), "cpu")
    want = jprng.threefry2x32((0xFFFFFFFF, 0), (_u32(x), _u32(x)[::-1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), w)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 64])
def test_torch_random_bits_matches_numpy_and_jax(n):
    key = jprng.key_from_seed_words([n, 0xFFFFFFFF])
    got = tprng.torch_random_bits(key, n, "cpu")
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(_u32(got), jprng.random_bits(key, n))
    np.testing.assert_array_equal(_u32(got),
                                  np.asarray(jprng.jax_random_bits(key, n)))


def test_popcount_and_as_i32_at_edges():
    w = np.array(EDGE_WORDS + [0x55555555, 0xAAAAAAAA, 0x0F0F0F0F], np.uint32)
    t = tprng.as_i32(w, "cpu")
    np.testing.assert_array_equal(_u32(t), w)
    np.testing.assert_array_equal(tprng.popcount_i32(t).numpy(),
                                  jprng._popcount32(w))
    assert tprng.as_i32(0xFFFFFFFF, "cpu").item() == -1
    assert tprng.as_i32(np.uint32(0x80000000), "cpu").item() == -2**31
    assert tprng.as_i32(-1, "cpu").item() == -1
    assert tprng.as_i32(t, "cpu") is t


def test_stream_helpers_match_numpy_and_jax():
    """derive, bits and binomial noise over several streams, with edge
    keys among them."""
    keys = (np.array(EDGE_WORDS, np.uint32),
            np.array(EDGE_WORDS[::-1], np.uint32))
    tk = tkd._keys_to(keys, "cpu")
    jk = (jnp.asarray(keys[0]), jnp.asarray(keys[1]))
    for idx in (0, 1, 5):
        got = tkd._derive(tk, idx)
        want = jprng.threefry2x32(keys, (np.full(6, idx, np.uint32),
                                         np.full(6, 0x9E3779B9, np.uint32)))
        jgot = jkd._jderive(jk, idx)
        for g, w, j in zip(got, want, jgot):
            np.testing.assert_array_equal(_u32(g), w)
            np.testing.assert_array_equal(_u32(g), np.asarray(j))
    idx = torch.tensor([0, -1, 3, 2**31 - 1, -2**31, 7], dtype=torch.int32)
    for g, w in zip(tkd._derive(tk, idx),
                    jprng.threefry2x32(keys, (_u32(idx),
                                              np.full(6, 0x9E3779B9,
                                                      np.uint32)))):
        np.testing.assert_array_equal(_u32(g), w)
    for n in (1, 6, 9):
        np.testing.assert_array_equal(_u32(tkd._bits_multi(tk, n)),
                                      jprng.random_bits_multi(keys, n))
        np.testing.assert_array_equal(_u32(tkd._bits_multi(tk, n)),
                                      np.asarray(jkd._jbits_multi(jk, n)))
    for n, scale, bits in ((4, 0, 1024), (3, 6550, 1024), (5, -7, 64),
                           (2, 2, 32)):
        got = tkd._binomial_multi(tk, n, scale, bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), jprng.binomial_noise_multi(keys, n, scale, bits))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jkd._jbinomial_multi(jk, n, scale, bits)))


def test_binomial_noise_chunks_over_streams(monkeypatch):
    keys = jprng.derive_multi(jprng.key_from_seed_words([3]), np.arange(7))
    want = tkd._binomial_multi(tkd._keys_to(keys, "cpu"), 3, 5, 64)
    monkeypatch.setattr(tkd, "_NOISE_CHUNK_WORDS", 12)     # 2 streams a chunk
    got = tkd._binomial_multi(tkd._keys_to(keys, "cpu"), 3, 5, 64)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), jprng.binomial_noise_multi(keys, 3, 5, 64))


def test_limb_matmul_and_dot_bits_wrap_mod_2_32():
    rng = np.random.RandomState(0)
    a = rng.randint(-2**31, 2**31, (19, 24), dtype=np.int64).astype(np.int32)
    a[0, :4] = [-2**31, -1, 2**31 - 1, 0]
    t8 = rng.randint(-128, 128, (24, 8)).astype(np.int8)
    want = (a.astype(np.int64) @ t8.astype(np.int64)).astype(np.int32)
    got = tkd._limb_matmul_i32(torch.from_numpy(a), torch.from_numpy(t8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jkd._limb_matmul_i32(jnp.asarray(a), jnp.asarray(t8))))
    s = rng.randint(0, 2, 24).astype(np.int32)
    s[:4] = 1
    with np.errstate(over="ignore"):
        want = (a @ s).astype(np.int32)
    np.testing.assert_array_equal(
        tkd._dot_bits(torch.from_numpy(a), torch.from_numpy(s)).numpy(), want)


@pytest.mark.parametrize("name", PARAMS)
def test_device_keyset_matches_host_and_jax_device(name):
    tp, jp = getattr(TP, name), getattr(JP, name)
    dev = tkd.generate_secret_keyset_device(tp, "cpu")
    assert isinstance(dev.params, TP.TFHEParams)
    _assert_keysets_equal(dev, tkeygen.generate_secret_keyset(tp))
    _assert_keysets_equal(dev, jkd.generate_secret_keyset_device(jp))
    nbit = tkd.generate_secret_keyset_device(tp, torch.device("cpu"),
                                             tkeygen.NBIT_SEED)
    _assert_keysets_equal(
        nbit, jkeygen.generate_secret_keyset(jp, jkeygen.NBIT_SEED))


def test_device_gate_keypair_matches_host():
    pair = tkd.generate_gate_keypair_device(TP.TEST_TINY, "cpu")
    host = tkeygen.generate_gate_keypair(TP.TEST_TINY)
    _assert_keysets_equal(pair.main, host.main)
    _assert_keysets_equal(pair.nbit, host.nbit)


@pytest.mark.parametrize("name", PARAMS)
def test_device_encrypt_decrypt_match_host_and_jax(name):
    jks = jkeygen.generate_secret_keyset(getattr(JP, name))
    ks = TB.from_jax_keyset(jks)
    stream = jprng.key_from_seed_words([77])
    bits = jprng.uniform_bits01(jprng.derive(stream, 5), 33).reshape(3, 11)
    key = jprng.derive(stream, 6)
    got = tenc.encrypt_bits_device(ks, bits, key, "cpu")
    assert got.dtype == torch.int32
    assert got.shape == (3, 11, ks.params.n + 1)
    assert torch.equal(got, tenc.encrypt_bits(ks, bits, key, "cpu"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jenc.encrypt_bits_device(jks, bits, key)))
    np.testing.assert_array_equal(got.numpy(),
                                  jenc.encrypt_bits(jks, bits, key))
    # either package's keyset serves (the port is duck-typed on it)
    assert torch.equal(got, tenc.encrypt_bits_device(jks, bits, key, "cpu"))
    dec = tenc.decrypt_bits_device(ks, got)
    assert isinstance(dec, torch.Tensor) and dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), bits)
    rng = np.random.RandomState(4)
    edge = rng.randint(-2**31, 2**31, (5, ks.params.n + 1),
                       dtype=np.int64).astype(np.int32)
    edge[:, -1] = [-2**31, -1, 0, 1, 2**31 - 1]
    np.testing.assert_array_equal(
        tenc.decrypt_bits_device(ks, torch.from_numpy(edge)).numpy(),
        jenc.decrypt_bits_device(jks, edge))
    np.testing.assert_array_equal(
        tenc.decrypt_bits_device(ks, torch.from_numpy(edge)).numpy(),
        tenc.decrypt_bits(ks, torch.from_numpy(edge)))
