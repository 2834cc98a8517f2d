"""The port's own host modules against the JAX package's originals.

``ieache_tpu_torch`` imports nothing of ``ieache_tpu``: it keeps copies
of ``params``, the NumPy part of ``utils/prng``, ``lwe/types``,
``lwe/keygen`` and ``codec/files``.  Each copy is pinned to its original
here: equal fields, equal streams, equal keysets, equal bytes; and a
subprocess with ``ieache_tpu``, ``jax`` and ``jaxlib`` refused imports
every module of the port and runs its main paths.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ieache_tpu import params as JP
from ieache_tpu.codec import files as jfiles
from ieache_tpu.lwe import keygen as jkeygen
from ieache_tpu.lwe import types as jtypes
from ieache_tpu.utils import prng as jprng
import ieache_tpu_torch
import ieache_tpu_torch.boot.bootstrap as TB
from ieache_tpu_torch import params as TP
from ieache_tpu_torch.codec import files as tfiles
from ieache_tpu_torch.lwe import keygen as tkeygen
from ieache_tpu_torch.lwe import types as ttypes
from ieache_tpu_torch.utils import prng as tprng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRESETS = ["IEACHE_110", "IEACHE_110_TFHE_COMPAT", "IEACHE_110_FAST",
           "TEST_TINY", "TEST_SMALL_NOISY"]

#: keys and counters at the edges of uint32
EDGE_WORDS = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keyset_arrays(ks):
    return {"lwe_s": ks.lwe_key.s, "trlwe_k": ks.trlwe_key.coefs,
            "bk": ks.cloud.bk, "ks": ks.cloud.ks}


def _assert_keysets_equal(a, b):
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    for (name, x), y in zip(_keyset_arrays(a).items(),
                            _keyset_arrays(b).values()):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_package_reexports_its_own_modules():
    assert ieache_tpu_torch.params is TP
    assert ieache_tpu_torch.prng is tprng
    assert ieache_tpu_torch.keygen is tkeygen
    assert ieache_tpu_torch.types is ttypes
    assert ieache_tpu_torch.files is tfiles
    assert TP.TFHEParams is not JP.TFHEParams


@pytest.mark.parametrize("name", PRESETS)
def test_params_presets_match_field_for_field(name):
    t, j = getattr(TP, name), getattr(JP, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    for prop in ("bg", "ks_base", "kN", "log2_2N", "trgsw_rows",
                 "lwe_sigma_torus", "tlwe_sigma_torus", "digit_limbs"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert hash(t) == hash(TP.TFHEParams(**dataclasses.asdict(j)))


@pytest.mark.parametrize("bad", [dict(N=100), dict(bg_bit=9, l=4),
                                 dict(ks_basebit=5, ks_t=7),
                                 dict(bg_bit=16, l=1)])
def test_params_validation_matches(bad):
    for mod in (TP, JP):
        with pytest.raises(ValueError):
            mod.TFHEParams(**bad)


def test_threefry_derive_and_seed_folding_match():
    words = np.array(EDGE_WORDS, np.uint32)
    for k0 in EDGE_WORDS:
        for k1 in (0, 0xFFFFFFFF, 0x80000000):
            got = tprng.threefry2x32((k0, k1), (words, words[::-1]))
            want = jprng.threefry2x32((k0, k1), (words, words[::-1]))
            for g, w in zip(got, want):
                assert g.dtype == np.uint32
                np.testing.assert_array_equal(g, w)
    for seed in ([], [0], [314, 1592, 657], EDGE_WORDS):
        key = tprng.key_from_seed_words(seed)
        assert key == jprng.key_from_seed_words(seed)
        for i in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF):
            assert tprng.derive(key, i) == jprng.derive(key, i)
    key = jprng.key_from_seed_words([7])
    idx = np.array(EDGE_WORDS, np.uint32)
    for g, w in zip(tprng.derive_multi(key, idx),
                    jprng.derive_multi(key, idx)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 64])
def test_random_streams_match(n):
    key = jprng.key_from_seed_words([2026, n])
    for name in ("random_bits", "uniform_torus32", "uniform_bits01"):
        got, want = getattr(tprng, name)(key, n), getattr(jprng, name)(key, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    keys = jprng.derive_multi(key, np.arange(5))
    np.testing.assert_array_equal(tprng.random_bits_multi(keys, n),
                                  jprng.random_bits_multi(keys, n))
    for scale, bits in ((0, 1024), (3, 64), (6550, 1024)):
        np.testing.assert_array_equal(
            tprng.binomial_noise(key, n, scale, bits),
            jprng.binomial_noise(key, n, scale, bits))
        np.testing.assert_array_equal(
            tprng.binomial_noise_multi(keys, n, scale, bits),
            jprng.binomial_noise_multi(keys, n, scale, bits))
    w = np.array(EDGE_WORDS, np.uint32)
    np.testing.assert_array_equal(tprng._popcount32(w), jprng._popcount32(w))


def test_deterministic_mode_reads_the_environment_each_time(monkeypatch):
    monkeypatch.delenv("IEACHE_DETERMINISTIC", raising=False)
    assert tprng.deterministic_mode() is jprng.deterministic_mode() is False
    assert tprng.fresh_stream(1, 2) != tprng.fresh_stream(1, 2)
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "1")
    assert tprng.deterministic_mode() is jprng.deterministic_mode() is True
    assert tprng.fresh_stream(1, -2) == jprng.fresh_stream(1, -2)
    assert tprng.fresh_stream(1, -2) == tprng.key_from_seed_words(
        [1, 0xFFFFFFFE])
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "0")
    assert tprng.deterministic_mode() is False


@pytest.mark.parametrize("name", ["TEST_TINY", "TEST_SMALL_NOISY"])
def test_host_keygen_matches_array_for_array(name):
    t = tkeygen.generate_secret_keyset(getattr(TP, name))
    j = jkeygen.generate_secret_keyset(getattr(JP, name))
    assert isinstance(t, ttypes.SecretKeySet)
    assert isinstance(t.params, TP.TFHEParams)
    _assert_keysets_equal(t, j)
    np.testing.assert_array_equal(t.trlwe_key.extracted,
                                  j.trlwe_key.extracted)
    assert tkeygen.MAIN_SEED == jkeygen.MAIN_SEED
    assert tkeygen.NBIT_SEED == jkeygen.NBIT_SEED
    for fn in ("gadget_h", "ks_gadget_h"):
        np.testing.assert_array_equal(getattr(tkeygen, fn)(t.params),
                                      getattr(jkeygen, fn)(j.params))


def test_gate_keypair_matches():
    t = tkeygen.generate_gate_keypair(TP.TEST_TINY)
    j = jkeygen.generate_gate_keypair(JP.TEST_TINY)
    _assert_keysets_equal(t.main, j.main)
    _assert_keysets_equal(t.nbit, j.nbit)
    assert not np.array_equal(t.main.lwe_key.s, t.nbit.lwe_key.s)


def test_cached_gate_keypair_is_the_jax_gate_keypair(tmp_path, monkeypatch):
    """The port's key cache (``serve --keycache`` and the tools) writes
    the JAX gate keypair's two keysets as ``<name>_.iek`` and
    ``<name>_nbit.iek`` and, once written, loads them without keygen."""
    j = jkeygen.generate_gate_keypair(JP.TEST_TINY)
    t = tfiles.cached_gate_keypair(str(tmp_path), TP.TEST_TINY)
    assert sorted(os.listdir(tmp_path)) == ["test_tiny_.iek",
                                            "test_tiny_nbit.iek"]
    monkeypatch.setattr(tkeygen, "generate_secret_keyset", None)
    again = tfiles.cached_gate_keypair(str(tmp_path), TP.TEST_TINY)
    for got in (t, again):
        _assert_keysets_equal(got.main, j.main)
        _assert_keysets_equal(got.nbit, j.nbit)
    _assert_keysets_equal(tfiles.cached_keyset(str(tmp_path), TP.TEST_TINY),
                          j.main)


def test_from_jax_keyset_carries_a_keyset_across():
    j = jkeygen.generate_secret_keyset(JP.TEST_TINY)
    t = TB.from_jax_keyset(j)
    assert isinstance(t, ttypes.SecretKeySet)
    assert isinstance(t.params, TP.TFHEParams) and t.params == TP.TEST_TINY
    assert t.cloud.params is t.params
    _assert_keysets_equal(t, j)
    # the packed key takes either package's cloud keyset
    a = TB.pack_cloud_key(t.cloud, "cpu")
    b = TB.pack_cloud_key(j.cloud, "cpu")
    assert torch.equal(a.bk, b.bk) and torch.equal(a.ks_limbs, b.ks_limbs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_key_files_cross_load_byte_for_byte(tmp_path, writer):
    """A secret and a cloud key file written by either package load in
    the other, and both packages write the same bytes."""
    t = tkeygen.generate_secret_keyset(TP.TEST_TINY)
    j = jkeygen.generate_secret_keyset(JP.TEST_TINY)
    (wmod, wks), (rmod, rtypes) = (
        ((tfiles, t), (jfiles, jtypes)) if writer == "port"
        else ((jfiles, j), (tfiles, ttypes)))
    sec, cloud = str(tmp_path / "secret.iek"), str(tmp_path / "cloud.iek")
    wmod.save_secret_keyset(sec, wks)
    wmod.save_cloud_keyset(cloud, wks.cloud)
    got = rmod.load_secret_keyset(sec)
    assert isinstance(got, rtypes.SecretKeySet)
    _assert_keysets_equal(got, wks)
    got_cloud = rmod.load_cloud_keyset(cloud)
    assert isinstance(got_cloud, rtypes.CloudKeySet)
    np.testing.assert_array_equal(got_cloud.bk, wks.cloud.bk)
    np.testing.assert_array_equal(got_cloud.ks, wks.cloud.ks)
    # the other package's writer gives the same bytes
    other_sec = str(tmp_path / "other_secret.iek")
    other_cloud = str(tmp_path / "other_cloud.iek")
    rmod.save_secret_keyset(other_sec, got)
    rmod.save_cloud_keyset(other_cloud, got_cloud)
    for x, y in ((sec, other_sec), (cloud, other_cloud)):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()


def test_containers_and_lwe_arrays_match(tmp_path):
    rng = np.random.RandomState(0)
    lwe = rng.randint(-2**31, 2**31, (3, 9), dtype=np.int64).astype(np.int32)
    arrays = {"a": lwe, "b": np.arange(5, dtype=np.uint8),
              "c": np.float64(2.5)}
    tb = tfiles.dumps_container(TP.TEST_TINY, arrays, "thing", {"x": 1})
    jb = jfiles.dumps_container(JP.TEST_TINY, arrays, "thing", {"x": 1})
    assert tb == jb and tb[:4] == tfiles.MAGIC == jfiles.MAGIC
    p, got, header = tfiles.loads_container(jb, "thing")
    assert p == TP.TEST_TINY and header["extra"] == {"x": 1}
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    with pytest.raises(ValueError, match="kind"):
        tfiles.loads_container(jb, "other")
    with pytest.raises(ValueError, match="magic"):
        tfiles.loads_container(b"XXXX" + jb[4:])
    meta = {"width": 8, "op": "add"}
    tpath, jpath = str(tmp_path / "t.lwe"), str(tmp_path / "j.lwe")
    tfiles.save_lwe_array(tpath, TP.TEST_TINY, lwe, meta)
    jfiles.save_lwe_array(jpath, JP.TEST_TINY, lwe, meta)
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        assert ft.read() == fj.read()
    for mod, path in ((tfiles, jpath), (jfiles, tpath)):
        p, arr, m = mod.load_lwe_array(path)
        assert dataclasses.asdict(p) == dataclasses.asdict(TP.TEST_TINY)
        np.testing.assert_array_equal(arr, lwe)
        assert m == meta
    with pytest.raises(ValueError, match="magic"):
        bad = str(tmp_path / "bad")
        with open(bad, "wb") as f:
            f.write(b"nope")
        tfiles.load_container(bad)


_SEALED = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = ("ieache_tpu", "jax", "jaxlib")

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _Block())

    import numpy as np
    import torch
    import ieache_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        ieache_tpu_torch.__path__, "ieache_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    assert len(names) > 25, names
    assert not any(m.split(".")[0] in REFUSED for m in sys.modules), [
        m for m in sys.modules if m.split(".")[0] in REFUSED]

    from ieache_tpu_torch import params as P, prng
    from ieache_tpu_torch.boot import bootstrap, gates
    from ieache_tpu_torch.circuits import fused, words
    from ieache_tpu_torch.lwe import encrypt, keygen_device

    torch.set_num_threads(1)
    p = P.TEST_TINY
    ks = keygen_device.generate_secret_keyset_device(p, "cpu")
    host = ieache_tpu_torch.keygen.generate_secret_keyset(p)
    assert np.array_equal(ks.cloud.bk, host.cloud.bk)
    assert np.array_equal(ks.cloud.ks, host.cloud.ks)
    key = bootstrap.pack_cloud_key(ks.cloud, "cpu")
    x, y = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    s = prng.key_from_seed_words([5])
    cx = encrypt.encrypt_bits_device(ks, x, prng.derive(s, 0), "cpu")
    cy = encrypt.encrypt_bits(ks, y, prng.derive(s, 1), "cpu")
    out = encrypt.decrypt_bits_device(ks, gates.NAND(cx, cy, key))
    assert out.tolist() == (1 - (x & y)).tolist(), out
    a, b = [3, 15, 0, 9], [5, 15, 7, 11]
    ca = words.encrypt_word(ks, a, 4, prng.derive(s, 2), "cpu")
    cb = words.encrypt_word(ks, b, 4, prng.derive(s, 3), "cpu")
    prod = words.decrypt_word(ks, fused.schoolbook_mul_csa(ca, cb, key))
    assert prod == [u * v for u, v in zip(a, b)], prod
    new = ("circuits.evaluator", "tools.bench", "tools.margin_probe",
           "tools.width_bench", "tools.expr_bench")
    assert {"ieache_tpu_torch." + m for m in new} <= set(names), names
    from ieache_tpu_torch.circuits import evaluator as ev
    pair = keygen_device.generate_gate_keypair_device(p, "cpu")
    cloud = ev.CloudEvaluator(bootstrap.pack_cloud_key(pair.main.cloud,
                                                       "cpu"), pair.nbit)
    ops = [ev.encrypt_operand(pair.main, pair.nbit, v, 4, prng.derive(s, i),
                              "cpu")
           for i, v in enumerate(([3, -2], [5, 2], [-4, 6]))]
    ans, _ = cloud.compute_chain([ev.OP_ADD, ev.OP_SUB], ops)
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB)
    assert got == [3 + 5 + 4, -2 + 2 - 6], got
    protocol = ("codec.ber", "codec.schema", "codec.asn_schema", "utils.log",
                "utils.trace", "native.lib", "mp.config", "mp.keywrap",
                "mp.liveness", "mp.supervisor", "mp.dragonfly",
                "mp.transport", "mp.wire", "mp.scheduler", "mp.nodes",
                "mp.sim", "cli.convert", "cli.fixtures", "cli.main",
                "tools.e2e_bench")
    assert {"ieache_tpu_torch." + m for m in protocol} <= set(names), names
    from ieache_tpu_torch.codec import asn_schema
    from ieache_tpu_torch.mp import dragonfly, sim
    assert asn_schema.load_module()["DataUserInput"]
    assert dragonfly._native_ec_mul() is not None  # the port's own build
    res = sim.run_full_flow("AB+C-", {"A": [3, -2], "B": [5, 2],
                                      "C": [-4, 6]}, 4, p, device="cpu")
    assert res.values == [3 + 5 + 4, -2 + 2 - 6], res.values
    dist_layer = ("dist", "dist.mesh", "dist.launch", "dist.shard",
                  "dist.batch", "dist.pipeline", "dist.multihost",
                  "dist.dryrun", "tools.keyplane_bench",
                  "tools.scaling_bench", "tools.comm_model",
                  "tools.multihost_demo")
    assert {"ieache_tpu_torch." + m for m in dist_layer} <= set(names), names
    from ieache_tpu_torch.dist import dryrun
    (report,) = dryrun.dryrun_multichip(1, device="cpu")
    assert report["launches"]["split"] == {"rot_diff_decompose": 0,
                                           "external_product": 0}, report
    from ieache_tpu_torch.ops import kernels
    rng = np.random.RandomState(3)
    acc = torch.from_numpy(rng.randint(-2**31, 2**31, (2, 40, 64),
                                       dtype=np.int64).astype(np.int32))
    bara = torch.from_numpy(rng.randint(0, 128, (40, 2)).astype(np.int32))
    bk = torch.from_numpy(rng.randint(-2**31, 2**31, (2, 4, 2, 64),
                                      dtype=np.int64).astype(np.int32))
    step = kernels.step_shape(40, 2, 64, 4, "wgmma", 64, 2)
    one = bara[:, 0].contiguous()
    assert torch.equal(kernels.cmux_step_as(acc, one, bk[0], p, step),
                       kernels.cmux_step_plain(acc, one, bk[0], p))
    scan = kernels.scan_wgmma_shape(40, 2, 64, 64, 2, 1)
    assert torch.equal(kernels.blind_rotate_scan_as(acc, bara, bk, p, scan),
                       kernels.blind_rotate_scan_plain(acc, bara, bk, p))
    assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
    print("SEALED-OK", len(names))
""")


def test_port_imports_nothing_of_the_jax_package():
    """With ieache_tpu, jax and jaxlib refused by a meta-path hook,
    every submodule of the port (the evaluator, the tools that drive it,
    the codec, the native binding, the protocol and the CLI among them)
    and chip_smoke import, and a TEST_TINY device keygen, NAND, 4-bit
    multiply, ``A + B - C`` through the evaluator and through the
    six-role flow (SAE on the port's native scalar multiplication), the
    dist layer's dry run on one gloo rank, and the wgmma step's and scan's
    plain models run and decrypt (or equal their twins) right."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SEALED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "SEALED-OK" in proc.stdout
