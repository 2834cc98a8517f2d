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

from ieache_tpu_torch import keygen
from ieache_tpu_torch import params as P
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
    errs = cs.check_kernels(p, dev, [1, 5, 8])
    errs.update(cs.check_mm_kernels(dev, [(128, 128, 128, 1),
                                          (128, 256, 384, 3)]))
    assert errs.keys() == {name for name, _, _ in cs.KERNELS}
    assert len(cs.KERNELS) == 11
    assert all(errs[name] == 0 for name in errs if name != "mm_bf16")
    # the twin against itself on CPU tensors
    assert errs["mm_bf16"] == 0

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


def test_keygen_and_multiply_phases_pass_on_cpu_twins():
    """The keygen phase (device keygen and encryption against the
    host's), the fused A + B - C and the three multiply shapes: windowed,
    latency above the Wallace gate, latency inside it."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    assert cs.keygen_vs_host(ks, dev) > 0
    enc_s, host_s = cs.encrypt_vs_host(ks, 64, dev)
    assert enc_s > 0 and host_s > 0
    key = bootstrap.pack_cloud_key(ks.cloud, dev)
    got, want, _ = cs.run_fused_expression(
        ks, key, cs.expression_inputs(ks, 6, 3, dev), dev)
    assert got == want
    for batch, width, latency in ((2, 4, False), (17, 3, True), (2, 4, True)):
        inputs = cs.multiply_inputs(ks, width, batch, dev)
        assert inputs[0][0][0] == inputs[0][1][0] == (1 << width) - 1
        got, want, _ = cs.run_multiply(ks, key, inputs, latency, dev)
        assert got == want and len(got) == batch
    # a keyset that differs in one word is caught
    ks.cloud.bk[0, 0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="bk differs"):
        cs.keygen_vs_host(ks, dev)


def test_bounds_are_the_larger_of_bytes_and_operations():
    cs = _chip_smoke()
    p = P.IEACHE_110_FAST
    moved = [torch.empty(1024, 1024, dtype=torch.int8)] * 2 + [
        torch.empty(1024, 1024, dtype=torch.int32)]
    ms, by = cs.bound_ms(moved, 512 * 2 * 1024**3, "int8")
    assert by == "operations" and abs(ms - 0.5556) < 1e-3
    ms, by = cs.bound_ms(moved, 512 * 2 * 1024**3, "bf16")
    assert by == "operations" and abs(ms - 1.1117) < 1e-3
    ms, by = cs.bound_ms(moved, 0, "int8")
    assert by == "bytes" and abs(ms - 6 * 2**20 / 3.35e12 * 1e3) < 1e-9
    # the external product at B=1024: 68.7 GOP, as the JAX kernel does it
    assert cs.external_product_ops(p, 1024) == 4 * 4 * 2 * 2 * 1024**3
    assert cs.external_product_ops(p, 8, p.n) == 500 * 4 * 4 * 2 * 2 * 8 * 1024**2


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
    mul_in = [("mul3", cs.multiply_inputs(ks, 3, 2, dev), False)]
    for mode in cs.MODES:
        errors, _, expr_s, nand_launches, launches = cs.run_mode(
            ks, key, mode, nand_in, expr_in, mul_in, dev)
        assert errors == 0
        assert set(expr_s) == ({"A+B-C", "A+B-C fused", "mul3"}
                               if mode in cs.EXPRESSION_MODES else set())
        assert not any(launches.values())
        assert not any(nand_launches.values())
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
