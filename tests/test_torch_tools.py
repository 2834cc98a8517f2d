"""The port's measurement tools that drive the evaluator and the gate
batch (bench, margin_probe, width_bench, expr_bench) and the key plane
and the dist layer (keyplane_bench, scaling_bench, comm_model,
multihost_demo), on the CPU.

Each tool's ``run`` function at a small size: the JSON line carries the
keys tests/test_tools.py pins for the JAX tool, plus ``backend``,
``card`` and ``step_mode``, and every lane decrypts right.  The noise
probe's σ per round equals the same XOR chain computed by the JAX
package.  expr_bench's dp-sharded run and scaling_bench's dp = 1, 2, 4
run on gloo ranks (``dist/launch.py``).  Each ``main()`` refuses to run
without a CUDA device.
"""

import importlib.util
import json
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
from ieache_tpu_torch.tools import (
    bench,
    comm_model,
    expr_bench,
    keyplane_bench,
    margin_probe,
    multihost_demo,
    scaling_bench,
    width_bench,
)

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
    # vs_baseline is the unrounded rate over 40, rounded to 2 places (as
    # in the JAX tool), and value the rate rounded to 2 places: the two
    # roundings bound their difference
    assert abs(rec["vs_baseline"] - rec["value"] / 40.0) <= 0.005 + 0.005 / 40


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


def test_expr_bench_dp_sharded(contracts):
    """EB_DP=2: the batch over two gloo ranks, the key replicated, two
    chunks a rank; every lane right, the gates of the unsharded run."""
    rec = expr_bench.run("add_sub", P.TEST_TINY, 8, 6, CPU, chunk=4, dp=2)
    _has_fields(rec, contracts.EXPR_REQUIRED)
    assert rec["errors"] == 0 and rec["dp"] == 2 and rec["chunk"] == 4
    one = expr_bench.run("add_sub", P.TEST_TINY, 8, 6, CPU)
    assert rec["gates_per_pass"] == one["gates_per_pass"]
    with pytest.raises(ValueError, match="EB_DP"):
        expr_bench.run("add_sub", P.TEST_TINY, 8, 6, CPU, dp=3)


#: the keys of a key plane's phases for one client count
KEYPLANE_PHASES = {"keygen_node_blobs_s", "output_exchange_s",
                   "clients_concurrent_wall_s", "client_exchange_s",
                   "cloud_exchange_s", "total_s", "speedup_vs_fig10"}


@pytest.mark.parametrize("proc_clients", [True, False],
                         ids=["process_clients", "thread_clients"])
def test_keyplane_bench_line(tmp_path, proc_clients):
    """tests/test_tools.py's key-plane contract at TEST_TINY, the
    clients as spawned processes (KB_PROC_CLIENTS=1) or threads, the
    Cloud's key on the CPU; the keysets written to and read back from
    the given key cache."""
    counts = [1, 2] if proc_clients else [1]
    rec = keyplane_bench.run(P.TEST_TINY, counts, 1, CPU,
                             proc_clients=proc_clients,
                             keycache=str(tmp_path))
    _has_fields(rec, {"probe", "params", "secret_blob_mb", "cloud_blob_mb",
                      "material_once_s", "per_clients",
                      "job_flow_tiny_total_s", "reference", "mode",
                      "host_cores"})
    assert rec["probe"] == "keyplane_fig9_fig10"
    for nc in counts:
        one = rec["per_clients"][str(nc)]
        assert KEYPLANE_PHASES <= set(one)
        assert one["total_s"] > 0 and len(one["client_exchange_s"]) == nc
        assert ("client_start_s" in one) == proc_clients
    assert sorted(os.listdir(tmp_path)) == ["test_tiny_.iek",
                                            "test_tiny_nbit.iek"]


def test_keyplane_bench_subprocess_total(tmp_path):
    """KB_SUBPROC: keygen, two clients and the Cloud as ``serve``
    processes, Output here; the tiny expression answers 42."""
    assert keyplane_bench.subproc_total(CPU) > 0


def test_scaling_bench_dp_1_2_4(tmp_path):
    """dp = 1, 2, 4 on four gloo ranks: a line per dp with no wrong
    lane, then the efficiency summary; the keyset written to the given
    key cache."""
    recs = scaling_bench.run(P.TEST_TINY, 8, 1, 4, CPU,
                             keycache=str(tmp_path))
    assert os.listdir(tmp_path) == ["test_tiny_.iek"]
    assert [r["dp"] for r in recs[:-1]] == [1, 2, 4]
    for r in recs[:-1]:
        assert r["metric"] == "scaling_bootstraps_per_sec"
        assert r["errors"] == 0 and r["batch"] == 8 * r["dp"]
        assert r["backend"] == "torch" and r["platform"] == "cpu"
        assert r["launches"] == {}                 # the CPU's twins
    assert recs[-1]["metric"] == "scaling_efficiency"
    assert recs[-1]["dp_max"] == 4 and recs[-1]["value"] > 0


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_scaling_bench_sharded(axis, tmp_path):
    """SB_TP=2 (the tp-sharded bootstrap) and SB_SP=4 (the sp-sharded
    one) on four gloo ranks: no wrong lane at any dp."""
    kw = {"tp": 2} if axis == "tp" else {"sp": 4}
    recs = scaling_bench.run(P.TEST_TINY, 8, 1, 4, CPU,
                             keycache=str(tmp_path), **kw)
    assert [r["dp"] for r in recs[:-1]] == ([1, 2] if axis == "tp" else [1])
    assert all(r["errors"] == 0 and r[axis] == kw[axis] for r in recs[:-1])
    assert recs[-1]["metric"] == "scaling_efficiency"
    with pytest.raises(ValueError, match="mutually exclusive"):
        scaling_bench.run(P.TEST_TINY, 8, 1, 4, CPU, tp=2, sp=2)


def test_comm_model_on_h100_figures():
    """tests/test_tools.py's comm-model contract on the H100's fabrics:
    dp needs no per-step collective; the chunked tp all_reduce beats the
    unoverlapped bound and reaches 0.9 at C=4 on NVLink; tp over NDR
    loses to NVLink; every constant cited; no TPU figure carried over."""
    rec = comm_model.run()
    assert rec["probe"] == "comm_model_h100"
    rows = {(r["axis"], r["ways"], r["gpus"], r["batch_per_gpu"],
             r["overlap_chunks"], r["fabric"]): r for r in rec["rows"]}
    assert rows[("dp", 16, 16, 1024, 1, "nvlink")][
        "projected_efficiency"] >= 0.99
    un = rows[("tp", 2, 8, 1024, 1, "nvlink")]["projected_efficiency"]
    ov = rows[("tp", 2, 8, 1024, 4, "nvlink")]["projected_efficiency"]
    assert 0 < un < ov and ov >= 0.9
    assert rows[("sp", 4, 16, 8, 1, "nvlink")]["comm_bytes_per_step"] > 0
    assert rows[("dp", 16, 16, 1024, 1, "ndr")][
        "projected_efficiency"] >= 0.99
    assert rows[("tp", 2, 16, 1024, 4, "ndr")]["projected_efficiency"] < ov
    assert rows[("tp", 2, 8, 1024, 4, "pcie")]["projected_efficiency"] < ov
    assert set(rec["assumptions"]["citations"]) == {
        "nvlink", "pcie", "ndr", "ring_factor", "measured_step"}
    assert comm_model.MEASURED_STEP_MS == pytest.approx(0.0934 + 0.0040)
    text = json.dumps(rec).lower()
    assert "v5e" not in text and "tpu" not in text
    assert "0.2348" not in text and "200000000000" not in text


def test_multihost_demo_refuses_an_uneven_batch():
    with pytest.raises(ValueError, match="MH_BATCH"):
        multihost_demo.run(0, 3, CPU, batch=16)


@pytest.mark.parametrize("tool,argv", [
    (keyplane_bench, []), (scaling_bench, []),
    (multihost_demo, ["0", "2", "1234"])],
    ids=["keyplane_bench", "scaling_bench", "multihost_demo"])
def test_dist_tool_refuses_cuda_without_a_card(tool, argv, monkeypatch):
    """``--device cuda``, the default, exits without a card: no
    fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(argv)
