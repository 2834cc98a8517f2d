"""The port's Cloud evaluator (circuits/evaluator.py) against the JAX
package's.

One keypair (main + nbit, TEST_TINY) feeds both packages.  Each test of
tests/test_evaluator.py has a counterpart here that runs the same
operands (encrypted from the same streams) through both evaluators and
asserts: equal operand words, equal decrypted lanes, equal ``info``
dicts, equal ``gate_count`` and equal answer words.  The answer's
negativity and bit-count words come from ``prng.fresh_stream``, which
draws ``os.urandom`` unless ``IEACHE_DETERMINISTIC=1``: every test here
sets it, so all four words are compared; one test shows that without it
the value words are still equal and the metadata words are not.  All
arithmetic is exact mod 2^32: the tolerance is exact equality.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ieache_tpu.boot.bootstrap as JB
from ieache_tpu import params as JP
from ieache_tpu.circuits import evaluator as jev
from ieache_tpu.circuits import fused as jfused
from ieache_tpu.circuits import words as jwords
from ieache_tpu.lwe import encrypt as jenc
from ieache_tpu.lwe import keygen as jkeygen
from ieache_tpu.utils import prng as jprng
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch import prng
from ieache_tpu_torch.circuits import evaluator as tev
from ieache_tpu_torch.circuits import fused as tfused
from ieache_tpu_torch.lwe import encrypt as tenc

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "1")


class Keys:
    """The JAX package's TEST_TINY keypair and packed key, and the port's
    keysets and packed key made from them."""

    def __init__(self):
        self.jpair = jkeygen.generate_gate_keypair(JP.TEST_TINY)
        self.jdck = JB.pack_cloud_key(self.jpair.main.cloud)
        self.main = TB.from_jax_keyset(self.jpair.main)
        self.nbit = TB.from_jax_keyset(self.jpair.nbit)
        self.dck = TB.pack_cloud_key(self.main.cloud, CPU)


@pytest.fixture(scope="module")
def keys():
    return Keys()


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _same_operand(t, j):
    """All four words equal (neg/bit of an answer: deterministic mode)."""
    for name in ("neg_word", "bit_word", "value", "carry_word"):
        _same(getattr(t, name), getattr(j, name))


class Both:
    """A JAX and a port evaluator on the same keys, driven in step."""

    def __init__(self, keys, **kw):
        self.k = keys
        self.j = jev.CloudEvaluator(keys.jdck, keys.jpair.nbit, **kw)
        self.t = tev.CloudEvaluator(keys.dck, keys.nbit, **kw)

    def enc(self, vals, width, stream):
        """(JAX operand, port operand) from one stream, held equal."""
        j = jev.encrypt_operand(self.k.jpair.main, self.k.jpair.nbit, vals,
                                width, stream)
        t = tev.encrypt_operand(self.k.main, self.k.nbit, vals, width,
                                stream, CPU)
        _same_operand(t, j)
        return j, t

    def _answer(self, jres, tres):
        (ja, jinfo), (ta, tinfo) = jres, tres
        assert tinfo == jinfo
        _same_operand(ta, ja)
        assert self.t.gate_count == self.j.gate_count
        return (ja, ta), tinfo

    def compute(self, op, a, b):
        return self._answer(self.j.compute(op, a[0], b[0]),
                            self.t.compute(op, a[1], b[1]))

    def steps(self, steps, ops):
        return self._answer(
            self.j.compute_steps(steps, [o[0] for o in ops]),
            self.t.compute_steps(steps, [o[1] for o in ops]))

    def chain(self, fold, ops):
        return self._answer(
            self.j.compute_chain(fold, [o[0] for o in ops]),
            self.t.compute_chain(fold, [o[1] for o in ops]))

    def decrypt(self, ans, op):
        """Both packages' decrypt_answer; equal lanes."""
        want = jev.decrypt_answer(self.k.jpair.main, self.k.jpair.nbit,
                                  ans[0], op)
        got = tev.decrypt_answer(self.k.main, self.k.nbit, ans[1], op)
        assert got == want
        return got


def _run(keys, op, avals, bvals, width=8):
    both = Both(keys)
    s = prng.key_from_seed_words([len(avals), op, width])
    a = both.enc(avals, width, prng.derive(s, 0))
    b = both.enc(bvals, width, prng.derive(s, 1))
    ans, info = both.compute(op, a, b)
    return both.decrypt(ans, op), info


def test_add_all_sign_cases(keys):
    assert _run(keys, tev.OP_ADD, [3, 9], [5, 100])[0] == [8, 109]
    assert _run(keys, tev.OP_ADD, [-3, -9], [-5, -100])[0] == [-8, -109]
    assert _run(keys, tev.OP_ADD, [-3, -100], [5, 9])[0] == [2, -91]
    assert _run(keys, tev.OP_ADD, [3, 9], [-5, -2])[0] == [-2, 7]


def test_sub_all_sign_cases(keys):
    assert _run(keys, tev.OP_SUB, [7, 3], [3, 7])[0] == [4, -4]
    assert _run(keys, tev.OP_SUB, [-7, -1], [3, 9])[0] == [-10, -10]
    assert _run(keys, tev.OP_SUB, [7, 2], [-3, -9])[0] == [10, 11]
    assert _run(keys, tev.OP_SUB, [-7, -9], [-3, -2])[0] == [-4, -7]


def test_mul_all_sign_cases(keys):
    got, info = _run(keys, tev.OP_MUL, [3, 11], [5, 13])
    assert got == [15, 143] and info["out_width"] == 16
    assert _run(keys, tev.OP_MUL, [-3, -11], [5, 13])[0] == [-15, -143]
    assert _run(keys, tev.OP_MUL, [3, 11], [-5, -13])[0] == [-15, -143]
    assert _run(keys, tev.OP_MUL, [-3, -11], [-5, -13])[0] == [15, 143]


def test_opcode_3_is_multiply(keys):
    got, info = _run(keys, 3, [3, -11], [5, 13])
    assert got == [15, -143] and info["out_width"] == 16


def test_widths_differ_takes_max(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0x3D])
    a = both.enc([200, 90], 8, prng.derive(s, 0))
    b = both.enc([3000, 1500], 12, prng.derive(s, 1))
    ans, info = both.compute(tev.OP_ADD, a, b)
    assert info["width"] == 12 and info["out_width"] == 12
    assert both.decrypt(ans, tev.OP_ADD) == [3200, 1590]
    b2 = both.enc([1800, 1500], 12, prng.derive(s, 2))
    ans, _ = both.compute(tev.OP_SUB, a, b2)
    assert both.decrypt(ans, tev.OP_SUB) == [200 - 1800, 90 - 1500]


def test_mul_widths_differ_doubles_max(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0x3E])
    a = both.enc([9, 13], 4, prng.derive(s, 0))
    b = both.enc([200, 3], 8, prng.derive(s, 1))
    ans, info = both.compute(tev.OP_MUL, a, b)
    assert info["out_width"] == 16
    assert both.decrypt(ans, tev.OP_MUL) == [1800, 39]


def test_mul_256bit_rejected(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([1])
    a = both.enc([1], 256, prng.derive(s, 0))
    b = both.enc([1], 256, prng.derive(s, 1))
    with pytest.raises(jev.MulWidthError):
        both.j.compute(jev.OP_MUL, a[0], b[0])
    with pytest.raises(tev.MulWidthError):
        both.t.compute(tev.OP_MUL, a[1], b[1])
    assert both.t.gate_count == both.j.gate_count == 0


def test_mixed_sign_batch_per_lane(keys):
    a_vals = [3, -3, 3, -3, 9, -100]
    b_vals = [5, 5, -5, -5, -2, 5]
    got, info = _run(keys, tev.OP_ADD, a_vals, b_vals)
    assert got == [x + y for x, y in zip(a_vals, b_vals)]
    assert set(info["neg_codes"]) == {0, 1, 2, 4}
    got, _ = _run(keys, tev.OP_SUB, a_vals, b_vals)
    assert got == [x - y for x, y in zip(a_vals, b_vals)]
    am = [3, -3, 3, -3, 9, -10]
    bm = [5, 5, -5, -5, -2, 5]
    got, _ = _run(keys, tev.OP_MUL, am, bm, width=4)
    assert got == [x * y for x, y in zip(am, bm)]


def test_mixed_sign_chained_answer(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0x51])
    a = both.enc([3, -3], 8, prng.derive(s, 0))
    b = both.enc([5, -5], 8, prng.derive(s, 1))
    c = both.enc([7, 2], 8, prng.derive(s, 2))
    ab, info = both.compute(tev.OP_ADD, a, b)
    assert set(info["neg_codes"]) == {0, 4}
    abc, _ = both.compute(tev.OP_ADD, ab, c)
    assert both.decrypt(abc, tev.OP_ADD) == [8 + 7, -8 + 2]


def test_invalid_negativity_code_rejected(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0x52])
    a = both.enc([3], 8, prng.derive(s, 0))
    b = both.enc([5], 8, prng.derive(s, 1))
    bad = jenc.encrypt_bits(keys.jpair.nbit,
                            jwords.values_to_bits([3], jev.META_WIDTH),
                            jprng.derive(s, 3))
    ja = jev.Operand(jnp.asarray(bad), a[0].bit_word, a[0].value,
                     a[0].carry_word)
    ta = tev.Operand(torch.from_numpy(np.asarray(bad)), a[1].bit_word,
                     a[1].value, a[1].carry_word)
    with pytest.raises(ValueError, match="invalid negativity codes"):
        both.j.compute(jev.OP_ADD, ja, b[0])
    with pytest.raises(ValueError, match="invalid negativity codes"):
        both.t.compute(tev.OP_ADD, ta, b[1])


def test_compute_chain_matches_sequential(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0xC4A])
    a_vals, b_vals, c_vals = [3, -9, 7], [5, -5, 2], [10, -4, 6]
    ops3 = [tev.OP_ADD, tev.OP_SUB]
    a, b, c = (both.enc(v, 8, prng.derive(s, i))
               for i, v in enumerate((a_vals, b_vals, c_vals)))
    ab, _ = both.compute(ops3[0], a, b)
    seq, _ = both.compute(ops3[1], ab, c)
    want = both.decrypt(seq, ops3[1])
    chained, _ = both.chain(ops3, [a, b, c])
    assert both.decrypt(chained, ops3[1]) == want == [
        x + y - z for x, y, z in zip(a_vals, b_vals, c_vals)]

    am = both.enc([6, 8], 4, prng.derive(s, 3))
    bm = both.enc([2, 3], 4, prng.derive(s, 4))
    cm = both.enc([5, -7], 4, prng.derive(s, 5))
    ab2, _ = both.compute(tev.OP_SUB, am, bm)
    seq2, _ = both.compute(tev.OP_MUL, ab2, cm)
    want2 = both.decrypt(seq2, tev.OP_MUL)
    ch2, _ = both.chain([tev.OP_SUB, tev.OP_MUL], [am, bm, cm])
    assert both.decrypt(ch2, tev.OP_MUL) == want2 == [(6 - 2) * 5,
                                                      (8 - 3) * -7]


def test_compute_steps_mul_first_tree(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0xABC])
    a_vals, b_vals, c_vals = [7, 100, 3], [3, 5, 9], [2, 9, 8]
    a, b, c = (both.enc(v, 8, prng.derive(s, i))
               for i, v in enumerate((a_vals, b_vals, c_vals)))
    bc, _ = both.compute(tev.OP_MUL, b, c)
    seq, _ = both.compute(tev.OP_SUB, a, bc)
    want = both.decrypt(seq, tev.OP_SUB)
    steps = [(tev.OP_MUL, ("opnd", 1), ("opnd", 2)),
             (tev.OP_SUB, ("opnd", 0), ("step", 0))]
    ch, info = both.steps(steps, [a, b, c])
    assert both.decrypt(ch, tev.OP_SUB) == want == [
        x - y * z for x, y, z in zip(a_vals, b_vals, c_vals)]
    assert info["out_width"] == 16


def test_compute_chain_exact_on_representation_hazard_lanes(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0xC4B])
    a = both.enc([3, -9, 7], 8, prng.derive(s, 0))
    b = both.enc([5, 5, -2], 8, prng.derive(s, 1))
    c = both.enc([10, -4, 6], 8, prng.derive(s, 2))
    chained, _ = both.chain([tev.OP_ADD, tev.OP_SUB], [a, b, c])
    assert both.decrypt(chained, tev.OP_SUB) == [3 + 5 - 10, -9 + 5 + 4,
                                                 7 - 2 - 6]
    # the per-op path keeps the reference's predicted-code semantics
    ab, _ = both.compute(tev.OP_ADD, a, b)
    seq, _ = both.compute(tev.OP_SUB, ab, c)
    assert both.decrypt(seq, tev.OP_SUB)[0] == 3 + 5 - 10


def test_chained_answer_zero_extends_to_wider_operand(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0xE7])
    a = both.enc([3, 4], 4, prng.derive(s, 0))
    b = both.enc([5, 6], 4, prng.derive(s, 1))
    c = both.enc([200, 100], 8, prng.derive(s, 2))
    ab, info = both.compute(tev.OP_ADD, a, b)
    assert info["out_width"] == 4
    abc, _ = both.compute(tev.OP_ADD, ab, c)
    assert both.decrypt(abc, tev.OP_ADD) == [3 + 5 + 200, 4 + 6 + 100]


def test_answer_chains_as_operand(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([2])
    a = both.enc([3, 4], 8, prng.derive(s, 0))
    b = both.enc([5, 6], 8, prng.derive(s, 1))
    c = both.enc([7, 8], 8, prng.derive(s, 2))
    ab, _ = both.compute(tev.OP_ADD, a, b)
    abc, _ = both.compute(tev.OP_ADD, ab, c)
    assert both.decrypt(abc, tev.OP_ADD) == [3 + 5 + 7, 4 + 6 + 8]


def test_mul_mul_chain_asymmetric_widths(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0x77])
    a = both.enc([5, 7], 4, prng.derive(s, 0))
    b = both.enc([6, 3], 4, prng.derive(s, 1))
    c = both.enc([10, 2], 4, prng.derive(s, 2))
    ans, _ = both.steps([(tev.OP_MUL, ("opnd", 0), ("opnd", 1)),
                         (tev.OP_MUL, ("step", 0), ("opnd", 2))], [a, b, c])
    assert both.decrypt(ans, tev.OP_MUL) == [300, 42]
    pb = tfused.ADDER_BOOTSTRAPS_PER_BIT[tfused.adder_mode()]
    assert both.t.gate_count == (tfused._csa_bootstraps_xy(4, 4, pb)
                                 + tfused._csa_bootstraps_xy(8, 4, pb)) * 2


def test_chain_memory_analysis_reports_memory_accounting(keys):
    """Same keys as the JAX audit, gate_count unchanged; on CPU tensors
    the port runs nothing and counts only the sizes of its tensors."""
    both = Both(keys)
    s = prng.key_from_seed_words([0xAD])
    ops = [both.enc([3, 5], 8, prng.derive(s, i)) for i in range(3)]
    steps = [(tev.OP_MUL, ("opnd", 0), ("opnd", 1)),
             (tev.OP_SUB, ("step", 0), ("opnd", 2))]
    jma = both.j.chain_memory_analysis(steps, [o[0] for o in ops])
    tma = both.t.chain_memory_analysis(steps, [o[1] for o in ops])
    assert both.t.gate_count == both.j.gate_count == 0
    assert tma.keys() == jma.keys()
    assert jma["temp_size_in_bytes"] > 0 and jma["argument_size_in_bytes"] > 0
    n = keys.main.params.n
    key_bytes = (keys.dck.bk.numel() * 4 + keys.dck.ks_limbs.numel())
    # value words (2, 256, n+1) int32, 2 comps (bool) and 2 sexts (int32)
    assert tma["argument_size_in_bytes"] == (
        key_bytes + 3 * 2 * 256 * (n + 1) * 4 + 2 * 2 + 2 * 2 * 4)
    assert tma["output_size_in_bytes"] == 2 * 16 * (n + 1) * 4
    assert tma["alias_size_in_bytes"] == 0
    assert tma["temp_size_in_bytes"] == -1
    assert tma["generated_code_size_in_bytes"] == -1
    assert tma["peak_bytes_estimate"] == -1


def test_chain_honors_kogge_stone_adder(keys):
    s = prng.key_from_seed_words([0xAC])
    rng = np.random.RandomState(5)
    av, bv, cv = (rng.randint(1, 60, 4) for _ in range(3))
    want = [int(x) + int(y) - int(z) for x, y, z in zip(av, bv, cv)]
    counts = {}
    for adder in ("ripple", "kogge_stone"):
        both = Both(keys, adder=adder)
        ops = [both.enc(v, 8, prng.derive(s, i))
               for i, v in enumerate((av, bv, cv))]
        ans, _ = both.chain([tev.OP_ADD, tev.OP_SUB], ops)
        assert both.decrypt(ans, tev.OP_SUB) == want, adder
        counts[adder] = both.t.gate_count
    assert counts["kogge_stone"] == (3 * 8 + 87) * 4
    assert counts["ripple"] == 2 * 8 * 2 * 4


def test_chain_widening_per_lane_extension(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0xD1])
    a = both.enc([7, 3], 4, prng.derive(s, 0))
    b = both.enc([7, -6], 4, prng.derive(s, 1))
    c = both.enc([100, 100], 8, prng.derive(s, 2))
    ans, _ = both.chain([tev.OP_ADD, tev.OP_ADD], [a, b, c])
    assert both.decrypt(ans, tev.OP_ADD) == [7 + 7 + 100, 3 - 6 + 100]


def test_code5_answer_reimports_as_operand(keys):
    both = Both(keys)
    s = prng.key_from_seed_words([0xD2])
    a = both.enc([3, -9], 8, prng.derive(s, 0))
    b = both.enc([5, 5], 8, prng.derive(s, 1))
    c = both.enc([10, -4], 8, prng.derive(s, 2))
    ans, info = both.chain([tev.OP_ADD, tev.OP_SUB], [a, b, c])
    assert 5 in info["neg_codes"]
    assert both.decrypt(ans, tev.OP_SUB) == [3 + 5 - 10, -9 + 5 + 4]
    d = both.enc([1, 1], 8, prng.derive(s, 3))
    # the re-import follows the magnitude heuristic in both packages
    re, _ = both.compute(tev.OP_ADD, ans, d)
    both.decrypt(re, tev.OP_ADD)


# -- beyond the JAX suite -------------------------------------------------


def test_code4_multiply_intermediate_reads_negative_in_a_chain(keys):
    """A multiply of two negative operands has answer code 4.  The JAX
    package hands that code on to a later step of the same chain, which
    reads it as negative, so A - B*C with B, C < 0 gives A + B*C there.
    The port hands on the product's exact sign and answers the plain
    integers; both read code 4 alike as a final answer's."""
    both = Both(keys)
    s = prng.key_from_seed_words([0xD3])
    a = both.enc([3, -9, 7], 8, prng.derive(s, 0))
    b = both.enc([5, -5, 2], 8, prng.derive(s, 1))
    c = both.enc([10, -4, -6], 8, prng.derive(s, 2))
    steps = [(tev.OP_MUL, ("opnd", 1), ("opnd", 2)),
             (tev.OP_SUB, ("opnd", 0), ("step", 0))]
    jans, _ = both.j.compute_steps(steps, [a[0], b[0], c[0]])
    tans, _ = both.t.compute_steps(steps, [a[1], b[1], c[1]])
    assert jev.decrypt_answer(keys.jpair.main, keys.jpair.nbit, jans,
                              tev.OP_SUB) == [3 - 50, -9 + 20, 7 + 12]
    assert tev.decrypt_answer(keys.main, keys.nbit, tans,
                              tev.OP_SUB) == [3 - 50, -9 - 20, 7 + 12]
    # the product alone: code 4 read as +|B||C| by both packages
    ans, info = both.compute(tev.OP_MUL, b, c)
    assert 4 in info["neg_codes"]
    assert both.decrypt(ans, tev.OP_MUL) == [50, 20, -12]


def test_answer_words_differ_without_deterministic_mode(keys, monkeypatch):
    """fresh_stream draws entropy: two runs of one chain give different
    negativity and bit-count words and the same value word and lanes."""
    monkeypatch.delenv("IEACHE_DETERMINISTIC")
    cloud = tev.CloudEvaluator(keys.dck, keys.nbit)
    s = prng.key_from_seed_words([0xD4])
    ops = [tev.encrypt_operand(keys.main, keys.nbit, v, 4, prng.derive(s, i),
                               CPU) for i, v in enumerate(([3, -2], [5, 6]))]
    (x, _), (y, _) = (cloud.compute(tev.OP_ADD, *ops) for _ in range(2))
    assert torch.equal(x.value, y.value)
    assert not torch.equal(x.neg_word, y.neg_word)
    assert not torch.equal(x.bit_word, y.bit_word)
    for ans in (x, y):
        assert tev.decrypt_answer(keys.main, keys.nbit, ans,
                                  tev.OP_ADD) == [8, 4]


@pytest.mark.parametrize("adder", ["ripple", "kogge_stone"])
def test_non_fused_evaluator_matches_jax(keys, adder):
    """fused=False: the gate-by-gate circuits of circuits/arith.py."""
    both = Both(keys, adder=adder, fused=False)
    s = prng.key_from_seed_words([0xD5])
    a = both.enc([3, -2], 3, prng.derive(s, 0))
    b = both.enc([-1, -3], 3, prng.derive(s, 1))
    ans, _ = both.compute(tev.OP_SUB, a, b)
    assert both.decrypt(ans, tev.OP_SUB) == [4, 1]
    if adder == "ripple":
        ans, _ = both.compute(tev.OP_MUL, a, b)
        assert both.decrypt(ans, tev.OP_MUL) == [-3, 6]


@pytest.mark.parametrize("amode,mmode,lanes", [("ref5", "csa", 3),
                                               ("ref5", "shift", 5)])
def test_compute_under_adder_and_multiply_modes(keys, monkeypatch, amode,
                                                mmode, lanes):
    """compute() under IEACHE_ADDER and IEACHE_MUL other than the default:
    the same words, lanes and gate count as JAX.  The JAX multipliers read
    the adder mode when they are traced, so each case has a shape (5-bit
    operands, its own lane count) that no other test traces."""
    monkeypatch.setenv("IEACHE_ADDER", amode)
    monkeypatch.setenv("IEACHE_MUL", mmode)
    both = Both(keys)
    s = prng.key_from_seed_words([0xD8, lanes])
    av, bv = [3, -5, 9, -1, 15][:lanes], [-6, 7, 11, -13, 2][:lanes]
    a = both.enc(av, 5, prng.derive(s, 0))
    b = both.enc(bv, 5, prng.derive(s, 1))
    ans, _ = both.compute(tev.OP_SUB, a, b)
    assert both.decrypt(ans, tev.OP_SUB) == [x - y for x, y in zip(av, bv)]
    ans, _ = both.compute(tev.OP_MUL, a, b)
    assert both.decrypt(ans, tev.OP_MUL) == [x * y for x, y in zip(av, bv)]


def test_operand_from_jax_chains_a_jax_answer(keys):
    """A JAX answer carried over by operand_from_jax and chained by the
    port equals the JAX package chaining it."""
    both = Both(keys)
    s = prng.key_from_seed_words([0xD6])
    a = both.enc([3, -9], 8, prng.derive(s, 0))
    b = both.enc([5, 5], 8, prng.derive(s, 1))
    c = both.enc([10, -4], 8, prng.derive(s, 2))
    jab, _ = jev.CloudEvaluator(keys.jdck, keys.jpair.nbit).compute(
        jev.OP_SUB, a[0], b[0])
    tab = tev.operand_from_jax(*(np.asarray(w) for w in (
        jab.neg_word, jab.bit_word, jab.value, jab.carry_word)), CPU)
    _same_operand(tab, jab)
    ans, _ = both.chain([tev.OP_ADD], [(jab, tab), c])
    assert both.decrypt(ans, tev.OP_ADD) == [3 - 5 + 10, -9 - 5 - 4]


#: the six Fig. 7 expressions as step lists
FIG7_STEPS = {
    "A+B+C": [(1, ("opnd", 0), ("opnd", 1)), (1, ("step", 0), ("opnd", 2))],
    "A+B-C": [(1, ("opnd", 0), ("opnd", 1)), (2, ("step", 0), ("opnd", 2))],
    "A-B-C": [(2, ("opnd", 0), ("opnd", 1)), (2, ("step", 0), ("opnd", 2))],
    "A+B*C": [(4, ("opnd", 1), ("opnd", 2)), (1, ("opnd", 0), ("step", 0))],
    "A-B*C": [(4, ("opnd", 1), ("opnd", 2)), (2, ("opnd", 0), ("step", 0))],
    "A*B*C": [(4, ("opnd", 0), ("opnd", 1)), (4, ("step", 0), ("opnd", 2))],
}

#: (widths of A, B, C, lanes): the Wallace regime of the latency
#: multiply (B*(W+1) <= 64) and the windowed one
PLAN_SHAPES = {"w8-6-8 B8": ((8, 6, 8), 8), "w16 B8": ((16, 16, 16), 8)}


#: the Fig. 7 expressions whose first step is a product a later step
#: consumes: the operands it multiplies
CHAINED_PRODUCTS = {"A+B*C": (1, 2), "A-B*C": (1, 2), "A*B*C": (0, 1)}


def plain_sign_lanes(expr: str, lanes: int) -> np.ndarray:
    """For each lane of :func:`plan_operands` (lane i signed as
    ``product((1, -1), repeat=3)[i % 8]``), the lane of the same signs
    but where ``expr``'s chained product multiplies two negative
    operands: there the lane whose two operands are positive.  Its
    product has the sign of the plain integers', which the port hands
    on, where the JAX package hands on code 4 and reads it as negative;
    so the port's plan at lane i is JAX's at this lane."""
    signs = list(itertools.product((1, -1), repeat=3))
    pair = CHAINED_PRODUCTS.get(expr)
    out = []
    for i in range(lanes):
        s = list(signs[i % 8])
        if pair and s[pair[0]] < 0 and s[pair[1]] < 0:
            s[pair[0]] = s[pair[1]] = 1
        out.append(signs.index(tuple(s)) + i - i % 8)
    return np.array(out)


@pytest.fixture(scope="module")
def plan_operands(keys):
    """Per PLAN_SHAPES entry, three operand pairs whose lanes run through
    every sign combination."""
    out = {}
    for name, (widths, lanes) in PLAN_SHAPES.items():
        both = Both(keys)
        s = prng.key_from_seed_words([0xF7, lanes] + list(widths))
        signs = list(itertools.product((1, -1), repeat=3))
        out[name] = [both.enc([signs[i % 8][k] * (3 + i + k)
                               for i in range(lanes)], w, prng.derive(s, k))
                     for k, w in enumerate(widths)]
    return out


@pytest.mark.parametrize("mmode", ["csa", "shift"])
@pytest.mark.parametrize("amode", ["maj2", "ref5"])
@pytest.mark.parametrize("adder", ["ripple", "kogge_stone"])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
@pytest.mark.parametrize("expr", sorted(FIG7_STEPS))
def test_plan_steps_matches_jax(keys, plan_operands, monkeypatch, expr, shape,
                                adder, amode, mmode):
    """_plan_steps on the host: JAX's plan tuple, masks, answer codes,
    effective signs, step widths and gate count, for each Fig. 7 shape
    under every adder and multiply mode; on the lanes where a chained
    product multiplies two negative operands the port's lane is JAX's
    lane of the plain integers' signs (:func:`plain_sign_lanes`)."""
    monkeypatch.setenv("IEACHE_ADDER", amode)
    monkeypatch.setenv("IEACHE_MUL", mmode)
    both = Both(keys, adder=adder)
    ops = plan_operands[shape]
    jplan = both.j._plan_steps(FIG7_STEPS[expr], [o[0] for o in ops])
    tplan = both.t._plan_steps(FIG7_STEPS[expr], [o[1] for o in ops])
    lane = plain_sign_lanes(expr, PLAN_SHAPES[shape][1])
    assert tplan[0] == jplan[0]                        # the plan tuple
    for got, want in zip(tplan[1] + tplan[2], jplan[1] + jplan[2]):
        np.testing.assert_array_equal(got, np.asarray(want)[lane])
    for k in (3, 4):                                   # codes, combined
        np.testing.assert_array_equal(tplan[k], np.asarray(jplan[k])[lane])
    assert tplan[5] == jplan[5]
    assert both.t.gate_count == both.j.gate_count > 0
    assert tev._csa3_fusable(tuple(tplan[0])) == jev._csa3_fusable(
        tuple(jplan[0]))


def test_take_width_lane_at_the_7_plus_7_case(keys):
    """7+7 = 14 at w=4 (a pure lane, MSB set) zero-extends, 3-6 = -3 (an
    impure lane) sign-extends, widened to 8; _take_width zero-extends."""
    both = Both(keys)
    n = keys.main.params.n
    s = prng.key_from_seed_words([0xD7])
    # the 4-bit two's-complement bits of 14 and -3 (13)
    _, word = both.enc([14, 13], 4, prng.derive(s, 0))
    val = word.value[:, :4, :]
    sext = np.array([0, 1], np.int32)
    got = tev._take_width_lane(val, 8, n, torch.from_numpy(sext))
    want = jev._take_width_lane(jnp.asarray(val.numpy()), 8, n,
                                jnp.asarray(sext))
    _same(got, want)
    bits = tenc.decrypt_bits(keys.main, got)
    assert [int(sum(int(b) << i for i, b in enumerate(r))) for r in bits] \
        == [14, 253]
    _same(tev._take_width_lane(val, 8, n, None),
          jev._take_width_lane(jnp.asarray(val.numpy()), 8, n, None))
    _same(tev._take_width(val, 8, n),
          jev._take_width(jnp.asarray(val.numpy()), 8, n))
    _same(tev._take_width(word.value, 6, n),
          jev._take_width(jnp.asarray(word.value.numpy()), 6, n))


def test_sign_plan_codes_and_counts_match_jax():
    combined = np.array([0, 1, 2, 3, 3, 0])
    for op in (tev.OP_ADD, tev.OP_SUB, tev.OP_MUL):
        for got, want in zip(tev._sign_plan(op, combined),
                             jev._sign_plan(op, combined)):
            np.testing.assert_array_equal(got, want)
    codes = np.array([0, 1, 2, 4, 5, 0])
    np.testing.assert_array_equal(tev._normalized_neg(codes),
                                  jev._normalized_neg(codes))
    with pytest.raises(ValueError):
        tev._normalized_neg(np.array([0, 3]))
    for w in range(1, 70):
        assert tev._kogge_count(w) == jev._kogge_count(w)
    assert (tev.OP_ADD, tev.OP_SUB, tev.OP_MUL, tev.VALUE_SLOTS,
            tev.META_WIDTH) == (jev.OP_ADD, jev.OP_SUB, jev.OP_MUL,
                                jev.VALUE_SLOTS, jev.META_WIDTH)


def test_host_helpers_match_jax(keys):
    """encrypt.phase_of, and fused._kogge_count_fz."""
    bits = np.array([[1, 0, 1], [0, 0, 1]])
    ct = tenc.encrypt_bits(keys.main, bits, prng.key_from_seed_words([3]),
                           CPU)
    got = tenc.phase_of(keys.main, ct)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jenc.phase_of(keys.jpair.main,
                                                     ct.numpy()))
    assert jfused._kogge_count_fz(16) == tfused._kogge_count_fz(16)
