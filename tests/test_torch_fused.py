"""The port's integer circuits (the rest of circuits/arith.py and all of
circuits/fused.py) against the JAX package: identical ciphertext arrays
and the right decrypted values.

Same numpy inputs (made from a seed) go to both packages on one keyset
at TEST_TINY; all arithmetic is exact mod 2^32, so the tolerance is
exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ieache_tpu.boot.bootstrap as JB
from ieache_tpu import params as JP
from ieache_tpu.boot import gates as JG
from ieache_tpu.circuits import arith as jarith
from ieache_tpu.circuits import fused as jfused
from ieache_tpu.lwe import keygen as jkeygen
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch import prng
from ieache_tpu_torch.boot import gates as TG
from ieache_tpu_torch.circuits import arith as tarith
from ieache_tpu_torch.circuits import fused as tfused
from ieache_tpu_torch.circuits import words as twords
from ieache_tpu_torch.lwe import encrypt as tenc


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
    """One keyset for both packages: the JAX package's host keyset, its
    packed key, and the port's types and packed key made from it."""
    jks = jkeygen.generate_secret_keyset(JP.TEST_TINY)
    ks = TB.from_jax_keyset(jks)
    return ks, JB.pack_cloud_key(jks.cloud), TB.pack_cloud_key(ks.cloud, "cpu")


def _enc(ks, vals, width, salt):
    return twords.encrypt_word(ks, vals, width,
                               prng.key_from_seed_words([salt]), "cpu")


def _jax(x):
    return jnp.asarray(x.numpy())


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _signed(vals, width):
    return [v - (1 << width) if v >= 1 << (width - 1) else v for v in vals]


#: every sign mix of two operands, and zero
SIGN_MIX = ([5, -5, 5, -5, 0, -8], [3, 3, -3, -3, -1, 7])


def test_flat_unflat_and_shift_word_left_match_jax(keys):
    ks, _, _ = keys
    n = ks.params.n
    x = _enc(ks, [1, 6, 15], 4, 1)
    assert tarith._flat(x).shape == (12, n + 1)
    assert torch.equal(tarith._unflat(tarith._flat(x), 3, 4), x)
    for amount, total in ((0, 4), (2, 8), (3, 5), (4, 6)):
        got = tarith.shift_word_left(x, amount, total, n)
        _same(got, jarith.shift_word_left(_jax(x), amount, total, n))
        assert twords.decrypt_word(ks, got) == [
            (v << amount) & ((1 << total) - 1) for v in (1, 6, 15)]


@pytest.mark.parametrize("cin", [None, 0, 1])
def test_kogge_stone_add_matches_jax(keys, cin):
    ks, dck, tk = keys
    n, w = ks.params.n, 5
    a, b = SIGN_MIX
    ca, cb = _enc(ks, a, w, 2), _enc(ks, b, w, 3)
    tc = jc = None
    if cin is not None:
        bits = np.full(len(a), cin, np.int32)
        tc = TG.CONSTANT(torch.from_numpy(bits), n)
        jc = JG.CONSTANT(jnp.asarray(bits), n)
    s, cout = tarith.kogge_stone_add(ca, cb, tk, carry_in=tc)
    js, jcout = jarith.kogge_stone_add(_jax(ca), _jax(cb), dck, carry_in=jc)
    _same(s, js)
    _same(cout, jcout)
    want = [(x + y + (cin or 0)) & 31 for x, y in zip(a, b)]
    assert twords.decrypt_word(ks, s) == want
    if cin is not None:
        fs, fcout = tfused.kogge_stone_add(ca, cb, tk, tc)
        jfs, jfcout = jfused.kogge_stone_add(_jax(ca), _jax(cb), dck, jc)
        _same(fs, jfs)
        _same(fcout, jfcout)
        assert torch.equal(fs, s)


def test_schoolbook_mul_matches_jax(keys):
    ks, dck, tk = keys
    a, b = [0, 3, 7, 5], [6, 3, 7, 0]
    ca, cb = _enc(ks, a, 3, 4), _enc(ks, b, 3, 5)
    got = tarith.schoolbook_mul(ca, cb, tk)
    _same(got, jarith.schoolbook_mul(_jax(ca), _jax(cb), dck))
    assert twords.decrypt_word(ks, got) == [x * y for x, y in zip(a, b)]
    got5 = tarith.schoolbook_mul(ca, cb, tk, out_width=5)
    _same(got5, jarith.schoolbook_mul(_jax(ca), _jax(cb), dck, out_width=5))
    assert twords.decrypt_word(ks, got5) == [(x * y) & 31
                                             for x, y in zip(a, b)]


@pytest.mark.parametrize("mode", ["maj2", "ref5"])
@pytest.mark.parametrize("cin", [0, 1])
def test_fused_ripple_add_modes_match_jax(keys, mode, cin):
    """Both adder circuits over all (x, y, carry) combinations per bit
    and long carry chains, carry-out included."""
    ks, dck, tk = keys
    n = ks.params.n
    a = [0b1111, 0b1010, 0b0110, 0b0001]
    b = [0b0001, 0b0101, 0b0110, 0b1111]
    ca, cb = _enc(ks, a, 4, 21), _enc(ks, b, 4, 22)
    bits = np.full(4, cin, np.int32)
    s, cout = tfused.ripple_add(ca, cb, TG.CONSTANT(torch.from_numpy(bits), n),
                                tk, mode=mode)
    js, jcout = jfused.ripple_add(_jax(ca), _jax(cb),
                                  JG.CONSTANT(jnp.asarray(bits), n), dck,
                                  mode=mode)
    _same(s, js)
    _same(cout, jcout)
    assert twords.decrypt_word(ks, s) == [(x + y + cin) & 0xF
                                          for x, y in zip(a, b)]
    np.testing.assert_array_equal(
        tenc.decrypt_bits(ks, cout), [(x + y + cin) >> 4
                                      for x, y in zip(a, b)])


def test_adder_and_mul_modes_read_the_environment(monkeypatch):
    for name, fn, jfn, values in (
            ("IEACHE_ADDER", tfused.adder_mode, jfused.adder_mode,
             ("maj2", "ref5")),
            ("IEACHE_MUL", tfused.mul_mode, jfused.mul_mode,
             ("csa", "shift"))):
        monkeypatch.delenv(name, raising=False)
        assert fn() == jfn() == values[0]
        for v in values:
            monkeypatch.setenv(name, v)
            assert fn() == jfn() == v
        monkeypatch.setenv(name, "bogus")
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("adder", ["maj2", "ref5"])
def test_twos_complement_and_add_then_sub_match_jax(keys, adder, monkeypatch):
    """All sign mixes of A + B - C and -A, under both IEACHE_ADDER
    values (read at call time on both sides)."""
    monkeypatch.setenv("IEACHE_ADDER", adder)
    ks, dck, tk = keys
    w = 6
    a, b = SIGN_MIX
    c = [7, -7, -2, 2, 0, 1]
    ca, cb, cc = (_enc(ks, v, w, 30 + i) for i, v in enumerate((a, b, c)))
    neg = tfused.twos_complement(ca, tk)
    # the JAX functions read IEACHE_ADDER while tracing: call the
    # unjitted bodies, so no trace under another value is reused
    _same(neg, jfused.twos_complement.__wrapped__(_jax(ca), dck))
    assert twords.decrypt_word_signed(ks, neg) == _signed(
        [(-x) & 63 for x in a], w)
    s = tfused.add_then_sub(ca, cb, cc, tk)
    _same(s, jfused.add_then_sub.__wrapped__(_jax(ca), _jax(cb), _jax(cc),
                                             dck))
    assert twords.decrypt_word_signed(ks, s) == _signed(
        [(x + y - z) & 63 for x, y, z in zip(a, b, c)], w)


@pytest.mark.parametrize("u,v", [(0, 0), (1, 0), (1, 1)])
def test_csa3_add_matches_jax(keys, u, v):
    ks, dck, tk = keys
    w = 5
    a, b = SIGN_MIX
    c = [7, -7, -2, 2, 0, 1]
    ca, cb, cc = (_enc(ks, x, w, 40 + i) for i, x in enumerate((a, b, c)))
    uu, vv = np.full(len(a), u, np.int32), np.full(len(a), v, np.int32)
    s, cout = tfused.csa3_add(ca, cb, cc, torch.from_numpy(uu),
                              torch.from_numpy(vv), tk)
    js, jcout = jfused.csa3_add(_jax(ca), _jax(cb), _jax(cc),
                                jnp.asarray(uu), jnp.asarray(vv), dck)
    _same(s, js)
    _same(cout, jcout)
    assert twords.decrypt_word(ks, s) == [(x + y + z + u + v) & 31
                                          for x, y, z in zip(a, b, c)]


#: (batch, Wx, Wy, latency, takes the Wallace tree): windowed; latency
#: above the Wallace gate (b*(W+1) = 72 > 64); latency inside it
#: (2*5 = 10 and 12*5 = 60); an asymmetric pair each way
MUL_CASES = [
    (3, 4, 4, False, False),
    (2, 5, 3, False, False),
    (18, 3, 3, True, False),
    (2, 4, 4, True, True),
    (12, 4, 3, True, True),
]


@pytest.mark.parametrize("batch,wx,wy,latency,wallace", MUL_CASES)
def test_schoolbook_mul_csa_matches_jax(keys, batch, wx, wy, latency,
                                        wallace):
    ks, dck, tk = keys
    assert (latency and batch * (wx + 1) <= 64) == wallace
    rng = np.random.RandomState(batch * 100 + wx * 10 + wy)
    a = rng.randint(0, 1 << wx, batch)
    b = rng.randint(0, 1 << wy, batch)
    a[0], b[0] = (1 << wx) - 1, (1 << wy) - 1
    ca, cb = _enc(ks, a, wx, 50), _enc(ks, b, wy, 51)
    got = tfused.schoolbook_mul_csa(ca, cb, tk, latency=latency)
    _same(got, jfused.schoolbook_mul_csa(_jax(ca), _jax(cb), dck,
                                         latency=latency))
    assert got.shape == (batch, wx + wy, ks.params.n + 1)
    assert twords.decrypt_word(ks, got) == [int(x) * int(y)
                                            for x, y in zip(a, b)]


def test_mul_wallace_and_compress3_words_match_jax(keys):
    """The Wallace tree on its own (an odd number of partial rows, so a
    layer leaves words over), and one 3:2 layer."""
    ks, dck, tk = keys
    bsz, wx, wy = 1, 2, 5
    rng = np.random.RandomState(9)
    rows = rng.randint(0, 1 << wx, (wy, bsz))
    partials = torch.stack([_enc(ks, r, wx, 60 + i)
                            for i, r in enumerate(rows)])
    got = tfused._mul_wallace(partials, tk)
    _same(got, jfused._mul_wallace(_jax(partials), dck))
    assert twords.decrypt_word(ks, got) == [
        sum(int(rows[i, j]) << i for i in range(wy)) & 0x7F
        for j in range(bsz)]
    triples = [tuple(partials[3 * t + i] for i in range(3)) for t in (0,)]
    triples.append((partials[3], partials[4], partials[0]))
    outs = tfused._compress3_words(triples, tk)
    jouts = jfused._compress3_words(
        [tuple(_jax(x) for x in t) for t in triples], dck)
    assert len(outs) == len(jouts) == 4
    for o, jo in zip(outs, jouts):
        _same(o, jo)


def test_schoolbook_mul_fused_and_placement_match_jax(keys, monkeypatch):
    monkeypatch.delenv("IEACHE_ADDER", raising=False)
    ks, dck, tk = keys
    n, w = ks.params.n, 3
    a, b = [0, 3, 7, 5], [6, 3, 7, 0]
    ca, cb = _enc(ks, a, w, 70), _enc(ks, b, w, 71)
    got = tfused.schoolbook_mul_fused(ca, cb, tk)
    _same(got, jfused.schoolbook_mul_fused(_jax(ca), _jax(cb), dck))
    assert twords.decrypt_word(ks, got) == [x * y for x, y in zip(a, b)]
    mats = tfused._mul_shift_matrices(w, 2 * w)
    _same(mats, jfused._mul_shift_matrices(w, 2 * w))
    for i in range(w):
        _same(tfused._place_partial(ca, mats[i], n),
              jfused._place_partial(_jax(ca), jnp.asarray(mats[i].numpy()),
                                    n))
    _same(tfused._and_partial(ca.reshape(-1, n + 1), cb[:, 1], w, tk),
          jfused._and_partial(_jax(ca).reshape(-1, n + 1), _jax(cb)[:, 1], w,
                              dck))
    _same(tfused._bootstrap_raw(ca[:, 0], tk),
          jfused._bootstrap_raw(_jax(ca)[:, 0], dck))


@pytest.mark.parametrize("w", range(4, 33))
def test_bootstrap_count_tables_match_jax(w):
    """Gate accounting, widths 4…32: the Wallace count keeps the JAX
    package's sort key (it differs from the tree's own, which changes
    counts only)."""
    assert tfused.ADDER_BOOTSTRAPS_PER_BIT == jfused.ADDER_BOOTSTRAPS_PER_BIT
    assert tfused.MUL_BOOTSTRAPS.keys() == jfused.MUL_BOOTSTRAPS.keys()
    for pb in tfused.ADDER_BOOTSTRAPS_PER_BIT.values():
        for mode in tfused.MUL_BOOTSTRAPS:
            assert (tfused.MUL_BOOTSTRAPS[mode](w, pb)
                    == jfused.MUL_BOOTSTRAPS[mode](w, pb))
        assert (tfused._csa_bootstraps_xy(w, w // 2, pb)
                == jfused._csa_bootstraps_xy(w, w // 2, pb))
    assert tfused._kogge_count_fz(w) == jfused._kogge_count_fz(w)
    for wy in (w, w // 2, 3):
        assert (tfused._wallace_bootstraps(w, wy)
                == jfused._wallace_bootstraps(w, wy))
