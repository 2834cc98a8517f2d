"""The port's bootstrap, keyswitch, gates and bit encryption against
the JAX package (and the C++ oracle), array for array.

Same numpy inputs (made from a seed) go to both backends, on identical
keys; all arithmetic is exact mod 2^32, so the tolerance is exact
equality.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ieache_tpu.boot.bootstrap as JB
from ieache_tpu import params as P
from ieache_tpu.boot import gates as JG
from ieache_tpu.lwe import encrypt as jenc
from ieache_tpu.lwe import keygen
from ieache_tpu.native import lib as native
from ieache_tpu.ops import keyswitch as jks
from ieache_tpu.utils import prng
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch.boot import gates as TG
from ieache_tpu_torch.lwe import encrypt as tenc
from ieache_tpu_torch.ops import keyswitch as tks

EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                 np.int32)

PARAMS = [P.TEST_TINY, P.TEST_SMALL_NOISY]

#: the compat gadget (two int8 limbs per digit) at TEST_TINY size
TINY_COMPAT = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")

#: full N=1024 geometry with a small LWE dimension, as in
#: tests/test_oracle_parity.py
FULLGEO_L2 = dataclasses.replace(P.IEACHE_110_FAST, n=32, name="fullgeo_l2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _keys(p):
    """(secret keyset, JAX DeviceCloudKey, port DeviceCloudKey) per
    parameter set, built once per process."""
    ks = keygen.generate_secret_keyset(p)
    return ks, JB.pack_cloud_key(ks.cloud), TB.pack_cloud_key(ks.cloud, "cpu")


def _enc(ks, bits, *seed):
    """The same ciphertexts for both backends (port encryption; a test
    below pins it to the JAX host encryption)."""
    return tenc.encrypt_bits(ks, np.asarray(bits),
                             prng.key_from_seed_words(list(seed)), "cpu")


def _rand_i32(rng, shape):
    x = rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return x


def _jax(x):
    return jnp.asarray(x.numpy())


def test_mu_and_gate_table_match_jax():
    assert TB.MU == JB.MU
    assert TG.GATE_TABLE == JG.GATE_TABLE
    assert TG.GATE_OPCODES == JG.GATE_OPCODES


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_mod_switch_2n_matches_jax_at_edges(p):
    x = _rand_i32(np.random.RandomState(1), (9, 40))
    np.testing.assert_array_equal(
        TB.mod_switch_2n(torch.from_numpy(x), p).numpy(),
        np.asarray(JB.mod_switch_2n(jnp.asarray(x), p)))


def test_rotated_test_vector_matches_jax():
    p = P.TEST_TINY
    barb = np.arange(2 * p.N, dtype=np.int32)
    np.testing.assert_array_equal(
        TB._rotated_test_vector(torch.from_numpy(barb), TB.MU, p).numpy(),
        np.asarray(JB._rotated_test_vector(jnp.asarray(barb), JB.MU, p)))


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_sample_extract_matches_jax_at_edges(p):
    acc = _rand_i32(np.random.RandomState(2), (6, p.k + 1, p.N))
    np.testing.assert_array_equal(
        TB.sample_extract(torch.from_numpy(acc), p).numpy(),
        np.asarray(JB.sample_extract(jnp.asarray(acc), p)))


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_keyswitch_matches_jax_at_edges(p):
    ks, dck, tk = _keys(p)
    lwe_ext = _rand_i32(np.random.RandomState(3), (7, p.kN + 1))
    lwe_ext[:, p.kN] = EDGES
    np.testing.assert_array_equal(
        tks.keyswitch(torch.from_numpy(lwe_ext), tk.ks_limbs, p).numpy(),
        np.asarray(jks.keyswitch(jnp.asarray(lwe_ext), dck.ks_limbs, p)))


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_packed_keys_match_jax(p):
    ks, dck, tk = _keys(p)
    np.testing.assert_array_equal(tk.bk.numpy(), np.asarray(dck.bk))
    jl = np.asarray(dck.ks_limbs)
    assert tk.ks_limbs.shape[-1] % 8 == 0
    np.testing.assert_array_equal(tk.ks_limbs[..., : p.n + 1].numpy(), jl)
    assert not tk.ks_limbs[..., p.n + 1:].any()
    conv = TB.from_jax_cloud_key((np.asarray(dck.bk), jl), p, "cpu")
    assert torch.equal(conv.bk, tk.bk)
    assert torch.equal(conv.ks_limbs, tk.ks_limbs)
    assert dict(tk.named_buffers()).keys() == {"bk", "ks_limbs"}


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_encrypt_decrypt_match_jax_host(p):
    ks, _, _ = _keys(p)
    stream = prng.key_from_seed_words([77])
    bits = prng.uniform_bits01(prng.derive(stream, 5), 33).reshape(3, 11)
    want = jenc.encrypt_bits(ks, bits, prng.derive(stream, 6))
    got = tenc.encrypt_bits(ks, bits, prng.derive(stream, 6), "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, got), bits)
    edge = _rand_i32(np.random.RandomState(4), (5, p.n + 1))
    np.testing.assert_array_equal(
        tenc.decrypt_bits(ks, torch.from_numpy(edge)),
        jenc.decrypt_bits(ks, edge))


@pytest.mark.parametrize("p", PARAMS + [TINY_COMPAT], ids=lambda p: p.name)
def test_bootstrap_matches_jax(p):
    ks, dck, tk = _keys(p)
    bits = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    ct = _enc(ks, bits, 88)
    want = np.asarray(JB.bootstrap(_jax(ct), dck))
    got = TB.bootstrap(ct, tk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, got), bits)
    np.testing.assert_array_equal(
        TB.bootstrap_no_ks(ct, tk).numpy(),
        np.asarray(JB.bootstrap_no_ks(_jax(ct), dck)))


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("gate", list(JG.GATE_TABLE))
def test_gate_matches_jax(p, gate):
    ks, dck, tk = _keys(p)
    x = np.array([0, 0, 1, 1, 0, 1])
    y = np.array([0, 1, 0, 1, 1, 1])
    cx, cy = _enc(ks, x, 1), _enc(ks, y, 2)
    want = np.asarray(getattr(JG, gate)(_jax(cx), _jax(cy), dck))
    got = getattr(TG, gate)(cx, cy, tk)
    np.testing.assert_array_equal(got.numpy(), want)
    a1, a2, beta = TG.GATE_TABLE[gate]
    # the gate's truth table from its linear form: the sign of the phase
    # in units of MU = 1/8, on the torus (wrapped into (-4, 4])
    pre = a1 * (2 * x - 1) + a2 * (2 * y - 1) + beta // TB.MU
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, got),
                                  (pre + 3) % 8 - 3 > 0)


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_mux_apply_gate_batch_and_trivial_gates_match_jax(p):
    ks, dck, tk = _keys(p)
    s = np.array([0, 1, 0, 1, 1, 0])
    x = np.array([0, 0, 1, 1, 0, 1])
    y = np.array([1, 0, 1, 0, 1, 1])
    cs, cx, cy = _enc(ks, s, 3), _enc(ks, x, 4), _enc(ks, y, 5)

    got = TG.MUX(cs, cx, cy, tk)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JG.MUX(_jax(cs), _jax(cx), _jax(cy), dck)))
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, got),
                                  np.where(s != 0, x, y))

    ops = np.array([JG.GATE_OPCODES[g] for g in
                    ("AND", "XOR", "NOR", "ORYN", "XNOR", "ANDNY")], np.int32)
    got = TG.apply_gate_batch(torch.from_numpy(ops), cx, cy, tk)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JG.apply_gate_batch(jnp.asarray(ops), _jax(cx), _jax(cy),
                                       dck)))

    np.testing.assert_array_equal(TG.NOT(cx).numpy(),
                                  np.asarray(JG.NOT(_jax(cx))))
    assert TG.COPY(cx) is cx
    np.testing.assert_array_equal(
        TG.CONSTANT(torch.from_numpy(s.astype(np.int32)), p.n).numpy(),
        np.asarray(JG.CONSTANT(jnp.asarray(s), p.n)))


def test_bootstrap_full_geometry_matches_jax_and_oracle():
    """N=1024, production noise, the (8, 2) gadget: port == JAX == C++
    oracle, as tests/test_oracle_parity.py holds JAX to the oracle."""
    try:
        native.get_lib()
    except (OSError, subprocess.CalledProcessError) as e:  # pragma: no cover
        pytest.skip(f"native build failed: {e}")
    p = FULLGEO_L2
    ks = keygen.generate_secret_keyset(p)
    dck = JB.pack_cloud_key(ks.cloud)
    tk = TB.from_jax_cloud_key((np.asarray(dck.bk), np.asarray(dck.ks_limbs)),
                               p, "cpu")
    stream = prng.key_from_seed_words([90, p.bg_bit, p.l])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 4)
    ct = tenc.encrypt_bits(ks, bits, prng.derive(stream, 1), "cpu")

    got = TB.bootstrap(ct, tk).numpy()
    np.testing.assert_array_equal(got, np.asarray(JB.bootstrap(_jax(ct), dck)))
    np.testing.assert_array_equal(
        got, native.oracle_bootstrap(p, ks.cloud.bk, ks.cloud.ks, ct.numpy()))
    np.testing.assert_array_equal(tenc.decrypt_bits(ks, torch.from_numpy(got)),
                                  bits)


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _Block())

    import numpy as np
    from ieache_tpu import params as P
    from ieache_tpu.lwe import keygen
    from ieache_tpu.utils import prng
    from ieache_tpu_torch.boot import bootstrap, gates
    from ieache_tpu_torch.circuits import arith, words
    from ieache_tpu_torch.lwe import encrypt

    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, "cpu")
    x, y = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    s = prng.key_from_seed_words([5])
    cx = encrypt.encrypt_bits(ks, x, prng.derive(s, 0), "cpu")
    cy = encrypt.encrypt_bits(ks, y, prng.derive(s, 1), "cpu")
    got = encrypt.decrypt_bits(ks, gates.NAND(cx, cy, key))
    assert got.tolist() == (1 - (x & y)).tolist(), got
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    print("NAND-OK")
""")


def test_port_runs_without_jax():
    """With every jax import refused, the port keygens, encrypts, runs
    a NAND bootstrap and decrypts: it needs no JAX."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NAND-OK" in proc.stdout
