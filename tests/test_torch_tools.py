"""The port's measurement tools that drive the evaluator and the gate
batch (bench, margin_probe, width_bench, expr_bench), on the CPU.

Each tool's ``run`` function at a small size: the JSON line carries the
keys tests/test_tools.py pins for the JAX tool, plus ``backend``,
``card`` and ``step_mode``, and every lane decrypts right.  The noise
probe's σ per round equals the same XOR chain computed by the JAX
package.  Each ``main()`` refuses to run without a CUDA device.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ieache_tpu.boot.bootstrap as JB
from ieache_tpu import params as JP
from ieache_tpu.boot import gates as JG
from ieache_tpu.lwe import encrypt as jenc
from ieache_tpu.lwe import keygen as jkeygen
from ieache_tpu.utils import prng as jprng
from ieache_tpu_torch import params as P
from ieache_tpu_torch.tools import bench, expr_bench, margin_probe, width_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

#: the fields every line of the port's tools adds
PORT_FIELDS = {"backend", "card", "step_mode"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def contracts():
    """The JSON contracts tests/test_tools.py pins for the JAX tools."""
    return _load("tests/test_tools.py", "_jax_tool_contracts")


def _has_fields(rec, required):
    missing = (required | PORT_FIELDS) - set(rec)
    assert not missing, missing
    assert rec["backend"] == "torch" and rec["step_mode"] == "split"
    assert rec["card"] is None and rec["device"] == "cpu"


def test_bench_line(contracts):
    rec = bench.run(P.TEST_TINY, 64, 2, CPU)
    _has_fields(rec, contracts.BENCH_REQUIRED)
    assert rec["metric"] == "gate_bootstraps_per_sec_per_chip"
    assert rec["decrypt_errors"] == 0 and rec["platform"] == "cpu"
    assert len(rec["repeats"]) == bench.REPEATS >= 5
    assert rec["min"] <= rec["median"] == rec["value"] <= rec["max"]
    assert rec["vs_baseline"] == round(rec["value"] / 40.0, 2)


def test_margin_probe_sigmas_match_jax():
    """σ per round of the port's XOR chain equals the chain computed by
    the JAX package's gates.XOR and encrypt.phase_of on the same keyset
    and inputs."""
    p, batch, rounds = P.TEST_SMALL_NOISY, 64, 2
    rec = margin_probe.run(p, batch, rounds, CPU)
    _has_fields(rec, {"metric", "value", "unit", "sigma_torus",
                      "sigmas_per_round", "batch", "rounds", "errors",
                      "params", "platform"})
    assert rec["errors"] == 0 and rec["rounds"] == rounds

    ks = jkeygen.generate_secret_keyset(JP.TEST_SMALL_NOISY)
    dck = JB.pack_cloud_key(ks.cloud)
    stream = jprng.key_from_seed_words([0x3A6])
    xb = jprng.uniform_bits01(jprng.derive(stream, 0), batch)
    yb = jprng.uniform_bits01(jprng.derive(stream, 1), batch)
    cx = jnp.asarray(jenc.encrypt_bits(ks, xb, jprng.derive(stream, 2)))
    cy = jnp.asarray(jenc.encrypt_bits(ks, yb, jprng.derive(stream, 3)))
    want, out, sigmas = xb ^ yb, JG.XOR(cx, cy, dck), []
    for r in range(rounds):
        ph = jenc.phase_of(ks, np.asarray(out)).astype(np.float64)
        err = np.where(want == 1, ph - JB.MU, ph + JB.MU)
        sigmas.append(float(err.std()))
        if r + 1 < rounds:
            want = want ^ yb
            out = JG.XOR(out, cy, dck)
    assert rec["sigmas_per_round"] == [round(s / 2**32, 6) for s in sigmas]
    margin = 2**32 / 16 / (2 * np.sqrt(2) * max(sigmas))
    assert rec["value"] == round(float(margin), 2)


def test_width_bench_lines(contracts):
    jax_tool = _load("tools/width_bench.py", "_jax_width_bench")
    assert width_bench.CASES == jax_tool.CASES
    cases = {"mul6": ("mul", 6, 3), "add12": ("add", 12, 4)}
    recs = width_bench.run(list(cases), P.TEST_TINY, CPU, cases=cases)
    for rec, name in zip(recs, cases):
        _has_fields(rec, contracts.WIDTH_REQUIRED)
        assert rec["case"] == name and rec["errors"] == 0
        assert rec["gates_per_pass"] > 0 and rec["seconds_decrypt"] >= 0


@pytest.mark.parametrize("expr", sorted(expr_bench.FIG7))
def test_expr_bench_line(contracts, expr):
    rec = expr_bench.run(expr, P.TEST_TINY, 4, 8, CPU)
    _has_fields(rec, contracts.EXPR_REQUIRED)
    assert rec["expr"] == expr_bench.FIG7[expr][0]
    assert rec["errors"] == 0 and rec["dp"] == 1 and rec["chained"]


def test_expr_bench_per_op_in_chunks(contracts):
    """EB_CHAIN=0 (one compute per op) over two chunks, with the
    parallel-prefix adder."""
    rec = expr_bench.run("add_mul", P.TEST_TINY, 4, 6, CPU,
                         adder="kogge_stone", chain=False, chunk=2)
    _has_fields(rec, contracts.EXPR_REQUIRED)
    assert rec["errors"] == 0 and rec["chunk"] == 2 and not rec["chained"]
    with pytest.raises(ValueError, match="EB_CHUNK"):
        expr_bench.run("add_sub", P.TEST_TINY, 4, 6, CPU, chunk=3)


@pytest.mark.parametrize("tool", [bench, margin_probe, width_bench,
                                  expr_bench])
def test_main_refuses_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main()
