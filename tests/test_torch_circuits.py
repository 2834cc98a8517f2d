"""The port's encrypted words and adder circuits against the JAX
package: identical ciphertext arrays, and the right decrypted values.

Same numpy inputs (made from a seed) go to both backends on identical
keys at TEST_TINY; the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ieache_tpu.boot.bootstrap as JB
from ieache_tpu import params as P
from ieache_tpu.boot import gates as JG
from ieache_tpu.circuits import arith as jarith
from ieache_tpu.circuits import words as jwords
from ieache_tpu.lwe import keygen
from ieache_tpu.utils import prng
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch.boot import gates as TG
from ieache_tpu_torch.circuits import arith as tarith
from ieache_tpu_torch.circuits import words as twords

W = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    return ks, JB.pack_cloud_key(ks.cloud), TB.pack_cloud_key(ks.cloud, "cpu")


def _operands(ks, seed, count=2, batch=5):
    """Signed W-bit operands and their port ciphertexts."""
    rng = np.random.RandomState(seed)
    vals = [rng.randint(-(1 << (W - 1)), 1 << (W - 1), batch)
            for _ in range(count)]
    stream = prng.key_from_seed_words([seed])
    cts = [twords.encrypt_word(ks, v, W, prng.derive(stream, i), "cpu")
           for i, v in enumerate(vals)]
    return vals, cts


def _jax(x):
    return jnp.asarray(x.numpy())


def _wrap_signed(v):
    v &= (1 << W) - 1
    return v - (1 << W) if v >= 1 << (W - 1) else v


def test_bit_helpers_and_encrypt_word_match_jax(keys):
    ks, _, _ = keys
    vals = [0, 1, 127, -128, -1, 300, 2**40 + 5]
    np.testing.assert_array_equal(twords.values_to_bits(vals, W),
                                  jwords.values_to_bits(vals, W))
    bits = jwords.values_to_bits(vals, W)
    assert twords.bits_to_values(bits) == jwords.bits_to_values(bits)
    stream = prng.key_from_seed_words([9])
    got = twords.encrypt_word(ks, vals, W, stream, "cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jwords.encrypt_word(ks, vals, W, stream)))
    assert twords.decrypt_word(ks, got) == [v & 0xFF for v in vals]
    assert twords.decrypt_word_signed(ks, got) == [_wrap_signed(v)
                                                   for v in vals]
    np.testing.assert_array_equal(
        twords.trivial_word(3, W, ks.params.n, "cpu", value=-5).numpy(),
        np.asarray(jwords.trivial_word(3, W, ks.params.n, value=-5)))
    np.testing.assert_array_equal(
        tarith.zero_word(3, W, ks.params.n, "cpu").numpy(),
        np.asarray(jarith.zero_word(3, W, ks.params.n)))
    np.testing.assert_array_equal(tarith.not_word(got).numpy(),
                                  np.asarray(jarith.not_word(_jax(got))))


def test_ripple_add_matches_jax(keys):
    ks, dck, tk = keys
    (a, b), (ca, cb) = _operands(ks, 31)
    n = ks.params.n
    cin = np.array([0, 1, 0, 1, 1], np.int32)
    s, cout = tarith.ripple_add(ca, cb, TG.CONSTANT(torch.from_numpy(cin), n),
                                tk)
    js, jcout = jarith.ripple_add(_jax(ca), _jax(cb),
                                  JG.CONSTANT(jnp.asarray(cin), n), dck)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cout.numpy(), np.asarray(jcout))
    assert twords.decrypt_word_signed(ks, s) == [
        _wrap_signed(int(x) + int(y) + int(c)) for x, y, c in zip(a, b, cin)]


def test_ripple_sub_and_twos_complement_match_jax(keys):
    ks, dck, tk = keys
    (a, b), (ca, cb) = _operands(ks, 32)
    d, _ = tarith.ripple_sub(ca, cb, tk)
    jd, _ = jarith.ripple_sub(_jax(ca), _jax(cb), dck)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert twords.decrypt_word_signed(ks, d) == [
        _wrap_signed(int(x) - int(y)) for x, y in zip(a, b)]

    neg = tarith.twos_complement(ca, tk)
    np.testing.assert_array_equal(
        neg.numpy(), np.asarray(jarith.twos_complement(_jax(ca), dck)))
    assert twords.decrypt_word_signed(ks, neg) == [_wrap_signed(-int(x))
                                                   for x in a]


def test_add_then_sub_expression(keys):
    """A + B - C through ripple_add then ripple_sub, as chip_smoke.py
    drives it on the card."""
    ks, _, tk = keys
    (a, b, c), (ca, cb, cc) = _operands(ks, 33, count=3, batch=4)
    n = ks.params.n
    zero = TG.CONSTANT(torch.zeros(4, dtype=torch.int32), n)
    s, _ = tarith.ripple_add(ca, cb, zero, tk)
    r, _ = tarith.ripple_sub(s, cc, tk)
    assert twords.decrypt_word_signed(ks, r) == [
        _wrap_signed(int(x) + int(y) - int(z)) for x, y, z in zip(a, b, c)]
