"""chip_smoke.py's phases rehearsed on the CPU at TEST_TINY, and its
refusal to run without a CUDA device.

The script's correctness phases take a device argument, so their
control flow, shapes and checks run here on the kernels' plain twins;
only the build, the kernels themselves and the timing need the card.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.lwe import keygen
from ieache_tpu_torch.boot import bootstrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phases_pass_on_cpu_twins():
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    assert cs.check_kernels(p, dev, [1, 5, 8]) == {
        name: 0 for name, _, _ in cs.KERNELS}

    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, dev)
    nand_in = cs.nand_inputs(ks, 16, dev)
    want = cs.bootstrap_vs_plain(key, nand_in[2], dev)
    # IEACHE_PALLAS=0/interpret equal and launch nothing; 1 raises here
    cs.routes_vs_plain(key, nand_in[2], want, dev)
    errors, _ = cs.run_nand(ks, key, nand_in, dev)
    assert errors == 0
    got, want, _ = cs.run_expression(
        ks, key, cs.expression_inputs(ks, 8, 4, dev), dev)
    assert got == want


def test_step_mode_phases_pass_on_cpu_twins():
    """Phases 4-6 under every step mode (tr and ntt included), and the
    compat rotation."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    saved = os.environ.get("IEACHE_PALLAS_STEP")
    cs.compat_vs_plain(
        dataclasses.replace(p, bg_bit=10, name="tiny_compat"), dev, 3)
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, dev)
    nand_in = cs.nand_inputs(ks, 16, dev)
    expr_in = cs.expression_inputs(ks, 8, 4, dev)
    for mode in cs.MODES:
        errors, _, expr_s, launches = cs.run_mode(ks, key, mode, nand_in,
                                                  expr_in, dev)
        assert errors == 0
        assert (expr_s is not None) == (mode in cs.EXPRESSION_MODES)
        assert not any(launches.values())
    assert os.environ.get("IEACHE_PALLAS_STEP") == saved
    assert {"tr", "ntt"} <= set(cs.MODES)


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout
