"""The port's roles as real OS processes (``python -m
ieache_tpu_torch.cli.main serve``) and ``e2e_bench`` on the CPU.

Counterparts of ``tests/test_deploy.py`` through the port's CLI with
``--device cpu``: keygen, the clients and the Cloud as separate
processes on loopback, Output driving an expression from the test
process.  ``e2e_bench.run`` at TEST_TINY gives ``decrypt_ok`` for every
run, and its ``main()`` refuses to run without a CUDA device.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from ieache_tpu_torch.mp import nodes
from ieache_tpu_torch.tools import e2e_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _spawn(args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "ieache_tpu_torch.cli.main", "serve"] + args,
        cwd=cwd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )


def _stop(procs):
    for p in procs:  # exact PIDs we spawned, never by pattern
        p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def test_multiprocess_expression_flow(tmp_path):
    pk, pc1, pc2, pcl, po = _free_ports(5)
    kaddr = f"127.0.0.1:{pk}"
    procs = []
    try:
        procs.append(_spawn(
            ["--role", "keygen", "--params", "test_tiny",
             "--bind", "127.0.0.1", "--port", str(pk),
             "--expect-peers", "4", "--output-addr", f"127.0.0.1:{po}",
             "--clients", "127.0.0.1,127.0.0.1", "--discover-port", str(pk)],
            tmp_path))
        for idx, port, val in [(1, pc1, 30), (2, pc2, 12)]:
            procs.append(_spawn(
                ["--role", "client", "--index", str(idx),
                 "--keygen-addr", kaddr, "--bind", "127.0.0.1",
                 "--port", str(port), "--value", str(val), "--width", "8",
                 "--device", "cpu"], tmp_path))
        procs.append(_spawn(
            ["--role", "cloud", "--keygen-addr", kaddr, "--bind", "127.0.0.1",
             "--port", str(pcl), "--device", "cpu"], tmp_path))

        out = nodes.OutputNode()
        out.start_indicator_server("127.0.0.1", po)
        out.receive_keys(("127.0.0.1", pk))
        out.wait_finished(timeout=120)
        got = out.submit_job(
            ("127.0.0.1", pcl), "AB-",
            {"A": ("127.0.0.1", pc1), "B": ("127.0.0.1", pc2)}, timeout=120)
        assert got == [30 - 12]
        for p in procs:
            assert p.poll() is None, p.stdout.read()
        out.stop()
    finally:
        _stop(procs)


def test_serve_keygen_prints_hostup_and_finished(tmp_path):
    pk, po, dead = _free_ports(3)
    p = _spawn(
        ["--role", "keygen", "--params", "test_tiny",
         "--bind", "127.0.0.1", "--port", str(pk), "--expect-peers", "1",
         "--output-addr", f"127.0.0.1:{po}",
         "--clients", "127.0.0.1", "--discover-port", str(dead)],
        tmp_path)
    try:
        out = nodes.OutputNode()
        out.start_indicator_server("127.0.0.1", po)
        out.receive_keys(("127.0.0.1", pk))
        out.wait_finished(timeout=120)
        assert out.main_ks is not None
        out.stop()
        p.kill()
        stdout = p.stdout.read()
        assert "hostup: 0/1" in stdout
        assert f"keygen serving on 127.0.0.1:{pk}" in stdout
        assert "finished signal sent" in stdout
    finally:
        _stop([p])


def test_cloud_process_exits_when_a_job_fails_on_its_device(tmp_path):
    """A fault of the evaluation in the Cloud process (IEACHE_PALLAS=1
    on the CPU, where no kernel runs) fails Output's job with its
    message, and the serve process exits nonzero rather than serve on."""
    pk, pc1, pc2, pcl, po = _free_ports(5)
    kaddr = f"127.0.0.1:{pk}"
    procs = [_spawn(
        ["--role", "keygen", "--params", "test_tiny", "--bind", "127.0.0.1",
         "--port", str(pk), "--expect-peers", "4",
         "--output-addr", f"127.0.0.1:{po}"], tmp_path)]
    try:
        for idx, port in [(1, pc1), (2, pc2)]:
            procs.append(_spawn(
                ["--role", "client", "--index", str(idx),
                 "--keygen-addr", kaddr, "--bind", "127.0.0.1",
                 "--port", str(port), "--value", "3", "--width", "4",
                 "--device", "cpu"], tmp_path))
        cloud = subprocess.Popen(
            [sys.executable, "-m", "ieache_tpu_torch.cli.main", "serve",
             "--role", "cloud", "--keygen-addr", kaddr, "--bind",
             "127.0.0.1", "--port", str(pcl), "--device", "cpu"],
            cwd=tmp_path, env=dict(_env(), IEACHE_PALLAS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(cloud)
        out = nodes.OutputNode()
        out.start_indicator_server("127.0.0.1", po)
        out.receive_keys(("127.0.0.1", pk))
        out.wait_finished(timeout=120)
        with pytest.raises(RuntimeError, match="IEACHE_PALLAS=1"):
            out.submit_job(("127.0.0.1", pcl), "AB+",
                           {"A": ("127.0.0.1", pc1),
                            "B": ("127.0.0.1", pc2)}, timeout=120)
        out.stop()
        assert cloud.wait(timeout=30) != 0
        assert "a job failed on cpu" in cloud.stdout.read()
    finally:
        _stop(procs)


def test_e2e_bench_runs_on_the_cpu(tmp_path):
    """The six-process harness at TEST_TINY: the JAX tool's JSON keys
    and phase rows, every run decrypted right, the Cloud's spans."""
    rec = e2e_bench.run("test_tiny", 2, 8, ["AB+C-", "AB*C-"], "cpu",
                        timeout=300, keycache=str(tmp_path / "keycache"),
                        logdir=str(tmp_path / "logs"))
    assert rec["probe"] == "e2e_lambda110"
    assert rec["decrypt_errors"] == 0
    assert [(r["postfix"], r["attempt"], r["decrypt_ok"])
            for r in rec["runs"]] == [
        (pf, at, True) for pf in ("AB+C-", "AB*C-") for at in ("cold", "warm")]
    for key in ("key_exchange", "user_input_processing",
                "data_request_per_operand", "compute_total_warm[AB+C-]",
                "compute_total_warm[AB*C-]"):
        assert rec["baseline_rows"][key]["speedup"] > 0, key
    names = {s["name"] for s in rec["cloud_spans"]}
    assert {"job_receive", "data_request", "compute_chain",
            "answer_ship"} <= names
    assert rec["backend"] == "torch" and rec["card"] is None
    assert rec["cloud_launches"] == {}
    assert sorted(os.listdir(tmp_path / "keycache")) == [
        "test_tiny_.iek", "test_tiny_nbit.iek"]


def test_e2e_bench_expected_lanes():
    vals = {"A": [5, -2], "B": [3, 4], "C": [7, -1]}
    assert e2e_bench.expected("AB+C-", vals) == [1, 3]
    assert e2e_bench.expected("AB*C-", vals) == [8, -7]
    assert e2e_bench.expected("ABC*-", vals) == [-16, 2]
    assert e2e_bench.expected("AB/", vals) == [15, -8]
    lo, hi = 1 << 29, 1 << 30
    assert all(lo <= v < hi for vs in e2e_bench.operand_values(32, 3).values()
               for v in vs)


def test_e2e_bench_main_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        e2e_bench.main()
