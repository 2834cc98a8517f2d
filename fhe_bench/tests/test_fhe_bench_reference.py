"""The plain reference: its frozen key derivation, its decryption and
its integer semantics, held to the port at TEST_TINY on CPU tensors."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from fhe_bench import harness
from fhe_bench.reference import answer as R
from fhe_bench.reference import keys as K
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.lwe import keygen_device
from ieache_tpu_torch.params import TEST_TINY, TFHEParams
from ieache_tpu_torch.utils import prng

CPU = torch.device("cpu")


@pytest.mark.parametrize("words", [(314, 1592, 657), (0, 2**32 - 1, 7),
                                   K.seed_words(2**31 + 12345, "main"),
                                   K.seed_words(2**40 + 3, "nbit")])
def test_frozen_derivation_is_the_port_keygens(words):
    master = prng.key_from_seed_words(words)
    assert tuple(map(int, K.key_from_seed_words(words))) == \
        tuple(map(int, master))
    for n in (8, 500):
        params = TFHEParams(n=n, N=64, k=1, bg_bit=8, l=2, ks_basebit=4,
                            ks_t=4, lwe_noise_scale=0, tlwe_noise_scale=0)
        keyset = keygen_device.generate_secret_keyset_device(params, CPU,
                                                             words)
        assert np.array_equal(keyset.lwe_key.s, K.lwe_secret(words, n))


def test_seed_words_take_seeds_beyond_32_bits():
    assert K.seed_words(2**31 + 9, "main")[1:] == (2**31 + 9, 0)
    assert K.seed_words(2**33 + 1, "nbit")[1:] == (1, 2)
    with pytest.raises(ValueError):
        K.seed_words(-1, "main")


@pytest.fixture(scope="module")
def pair():
    return harness.make_keys(TEST_TINY, 2**31 + 77, CPU)


POSTFIXES = ["AB+C-", "AB-C+", "AB*C-", "AB*", "AB+"]


@pytest.mark.parametrize("postfix", POSTFIXES)
def test_reference_decodes_as_the_port(pair, postfix):
    """Every lane the reference reads from an answer equals the port's
    ``decrypt_answer``, with lanes of every sign combination."""
    from ieache_tpu_torch.mp import scheduler

    signs = [(x, y, z) for x in (1, -1) for y in (1, -1) for z in (1, -1)]
    vals = {"A": [s[0] * (3 + i) for i, s in enumerate(signs)],
            "B": [s[1] * (250 + 7 * i) for i, s in enumerate(signs)],
            "C": [s[2] * (11 * i + 1) for i, s in enumerate(signs)]}
    letters, ops, steps = scheduler.plan_postfix(postfix)
    stream = prng.key_from_seed_words([0xBE])
    operands = [ev.encrypt_operand(pair.main, pair.nbit, vals[x], 12,
                                   prng.derive(stream, i), CPU)
                for i, x in enumerate(letters)]
    evaluator = ev.CloudEvaluator(
        harness.pack_cloud_key(pair.main.cloud, CPU), pair.nbit)
    answer, _ = evaluator.compute_steps(
        [(scheduler.OPCODES[c], lhs, rhs) for c, lhs, rhs in steps],
        operands)
    port = ev.decrypt_answer(pair.main, pair.nbit, answer,
                             scheduler.OPCODES[ops[-1]])
    main_s = K.lwe_secret(K.seed_words(2**31 + 77, "main"), TEST_TINY.n)
    nbit_s = K.lwe_secret(K.seed_words(2**31 + 77, "nbit"), TEST_TINY.n)
    ours = R.decode(answer.neg_word, answer.bit_word, answer.value, main_s,
                    nbit_s, ops[-1])
    assert [v for _, _, v in ours] == port
    assert {w for _, w, _ in ours} == {R.result_width(postfix, 12)}


def test_decrypt_bits_reads_the_phase_sign():
    s = np.array([1, 0, 1, 1], np.int32)
    a = np.array([[5, 9, -7, 2**30], [0, 0, 0, 0], [1, 1, 1, 1]], np.int64)
    mu = np.array([1 << 29, -(1 << 29), 1 << 29])
    b = (a @ s + mu + 2**31) % 2**32 - 2**31
    word = torch.from_numpy(np.concatenate([a, b[:, None]], 1)
                            .astype(np.int32))
    assert R.decrypt_bits(word, s).tolist() == [1, 0, 1]


def test_integer_semantics():
    assert R.plain_value("AB+C-", {"A": 5, "B": -7, "C": 3}) == -5
    assert R.plain_value("AB*C-", {"A": -5, "B": -7, "C": 3}) == 32
    assert R.result_width("AB+C-", 32) == 32
    assert R.result_width("AB*C-", 32) == 64
    assert R.result_width("ABC*-", 16) == 32
    assert R.bits_to_ints(np.array([[1, 0, 1], [0, 0, 1]])) == [5, 4]


@pytest.mark.parametrize("got,want,width,ok", [
    (5, 5, 8, True), (-3, -3, 8, True), (6, 5, 8, False),
    (200, 200, 8, True),            # beyond the signed range: mod 2^8
    (200 - 256, 200, 8, True),
    (201 - 256, 200, 8, False),
    (-100, 156, 8, True),
    (-100, -100 + 256, 8, True),
    (3, 3 + 256, 8, True),          # the plain value has left 8 bits
    (100, -100, 8, False),          # inside the range: exactly
    (None, 0, 8, False),
])
def test_lane_ok(got, want, width, ok):
    assert R.lane_ok(got, want, width) is ok


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import fhe_bench.reference.answer, "
            "fhe_bench.reference.keys; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=harness.ROOT).stdout
    tops = set(eval(out))
    assert not tops & {"ieache_tpu_torch", "ieache_tpu", "jax", "jaxlib"}
