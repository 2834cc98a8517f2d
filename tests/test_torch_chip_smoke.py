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

import numpy as np
import pytest
import torch

from ieache_tpu_torch import keygen
from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.lwe import keygen_device
from ieache_tpu_torch.ops import kernels, tile_models

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


def test_rotation_launch_phase_passes_on_cpu_models():
    """Phase 3's check of both redesigned rotations on every launch shape
    (here their plain models) and on an accumulator only 4-byte aligned,
    at the residue amounts of rot_amounts."""
    cs = _chip_smoke()
    p = P.TEST_TINY
    assert cs.rot_amounts(p.N) == (0, 1, 2, 3, 64, 65, 127)
    errs = cs.check_rotation_launches(p, torch.device("cpu"), (1, 5, 24))
    assert errs == {"rot_diff_decompose": 0, "rotate_sublane": 0}


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


def test_small_n_phase_passes_on_cpu_twins():
    """Phase 4's blind rotation at N=32 under every step mode and under
    the interpret route: equal to plain=True, nothing launched, and
    IEACHE_PALLAS=1 raises for the modes whose kernels refuse it."""
    cs = _chip_smoke()
    saved = (os.environ.get("IEACHE_PALLAS_STEP"),
             os.environ.get("IEACHE_PALLAS"))
    assert cs.SMALL_N_PARAMS.N == 32 and cs.SMALL_N_PARAMS.n == 8
    cs.small_n_vs_plain(cs.SMALL_N_PARAMS, torch.device("cpu"), batch=2)
    assert (os.environ.get("IEACHE_PALLAS_STEP"),
            os.environ.get("IEACHE_PALLAS")) == saved
    # a shape every mode's kernels take is no small-N case
    with pytest.raises(AssertionError, match="kernels_take"):
        cs.small_n_vs_plain(P.TEST_TINY, torch.device("cpu"))


def test_fused2_runs_the_expressions_of_the_counted_path():
    """Phase 6 under fused2: A + B - C (ripple and fused) in the mode's
    counted run, every lane right, no launch on CPU tensors."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    assert cs.EXPRESSION_MODES == ("split", "fused2", "scan")
    assert set(cs.TIMED_EXPRESSION_MODES) >= {"split", "fused2", "overlap",
                                              "scan"}
    assert {"cmux_step", "cmux_step_overlap", "external_product",
            "rot_diff_decompose"} <= set(cs.SMALL_BATCH_KERNELS)
    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, dev)
    errors, _, expr_s, _, launches = cs.run_mode(
        ks, key, "fused2", cs.nand_inputs(ks, 8, dev),
        cs.expression_inputs(ks, 6, 3, dev), [], dev)
    assert errors == 0 and set(expr_s) == {"A+B-C", "A+B-C fused"}
    assert not any(launches.values())


def test_wgmma_nand_phase_passes_on_cpu_twins():
    """Phase 5's second NAND batch: under fused2 and scan at a batch where
    both take their wgmma form (at TEST_TINY, the first such batch),
    every bit right and no launch on CPU tensors; a batch where either
    keeps mma.sync is refused."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    assert cs.WGMMA_NAND_MODES == ("fused2", "scan")
    fast = P.IEACHE_110_FAST
    for mode_launch in (kernels.step_launch, kernels.scan_launch):
        assert mode_launch(cs.WGMMA_NAND_B, fast.k + 1, fast.N,
                           fast.trgsw_rows).form == "wgmma"
    b = next(b for b in range(1, 4096)
             if kernels.step_launch(b, p.k + 1, p.N,
                                    p.trgsw_rows).form == "wgmma")
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, dev)
    out = cs.run_wgmma_nand(ks, key, p, cs.nand_inputs(ks, b, dev), dev)
    assert set(out) == {"fused2", "scan"}
    assert not any(n for _, counts in out.values() for n in counts.values())
    with pytest.raises(AssertionError, match="form, not wgmma"):
        cs.run_wgmma_nand(ks, key, p, cs.nand_inputs(ks, b - 1, dev), dev)


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


@pytest.mark.parametrize("rows", [4, 6])
def test_scan_turns_phase_passes_on_cpu_twins(rows):
    """Phase 3's scan check over 1 to 4 steps, either side of the split,
    on the twin: equal, and the input accumulator unchanged."""
    cs = _chip_smoke()
    p = dataclasses.replace(P.TEST_TINY, l=rows // 2, name=f"tiny_{rows}rows")
    errs = cs.check_scan_turns(p, torch.device("cpu"), batches=(8, 24))
    assert errs == {"blind_rotate_scan": 0}
    assert cs.SCAN_TURN_BATCHES == (8, 24, 256, 272)
    assert cs.SCAN_TURN_STEPS == (1, 2, 3, 4)


@pytest.mark.parametrize("rows", [4, 6])
def test_tensor_core_tile_phase_passes_on_cpu_twins(rows):
    """Phase 3's second pass over the five kernels on the tensor-core
    tile and the tr rotation (extreme operands and accumulators, 4 and 6
    TRGSW rows, a batch either side of the split), on the twins."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = dataclasses.replace(P.TEST_TINY, l=rows // 2, name=f"tiny_{rows}rows")
    assert p.trgsw_rows == rows
    errs = cs.check_mma_kernels(p, dev, (1, 5, 8), split_edge=(16, 17))
    assert errs == {"external_product": 0, "blind_rotate_scan": 0,
                    "cmux_step": 0, "cmux_step_overlap": 0,
                    "external_product_tr": 0, "rot_diff_decompose_tr": 0}
    # the extreme accumulators decompose to what their names say
    at = {name: cs.kernels.rot_diff_decompose_plain(acc, bara, p)
          for name, acc, bara, _ in cs.extreme_accumulators(
              p, 3, dev, np.random.RandomState(0))}
    assert len(at) == 4
    assert {(int(d.min()), int(d.max())) for name, d in at.items()
            if name.startswith("digits -128")} == {(-128, -128)}
    assert {(int(d.min()), int(d.max())) for name, d in at.items()
            if name.startswith("digits +127")} == {(127, 127)}
    names = [name for name, _, _ in cs.extreme_operands(
        p, 3, dev, np.random.RandomState(0))]
    assert len(names) == 4 and len(set(names)) == 4
    # the operand sets are what they say
    for name, d, bk_i in cs.extreme_operands(
            p, 3, dev, np.random.RandomState(0)):
        assert d.shape == (rows, 3, p.N) and d.dtype == torch.int8
        assert bk_i.shape == (rows, p.k + 1, p.N)
        if name.startswith("d=-128"):
            assert int(d.max()) == -128
    assert set(cs.MMA_BATCHES) == {1, 5, 8, 16, 1024, 1056}
    assert [q.trgsw_rows for q in cs.MMA_PARAMS] == [4, 6]


@pytest.mark.parametrize("rows", [4, 6])
def test_product_launch_phase_passes_on_cpu_models(rows):
    """Phase 3's pass over every launch shape of external_product (the
    mma.sync tile and each wgmma tile, random and extreme operands, with
    and without the accumulator), on the forms' plain models at 4 and 6
    TRGSW rows, batches either side of a wgmma tile."""
    cs = _chip_smoke()
    p = dataclasses.replace(P.TEST_TINY, l=rows // 2, name=f"tiny_{rows}rows")
    errs = cs.check_product_launches(p, torch.device("cpu"), (1, 5, 33))
    assert errs == {"external_product": 0}
    assert cs.PRODUCT_BATCHES == (24, 64)


def test_keyswitch_phase_passes_on_cpu_models():
    """Phase 3's keyswitch check (the wrapper, the plain chain on CPU
    tensors, and every tile of ``keyswitch_launch_shapes`` on the
    kernel's plain model, random and extreme operands) at TEST_TINY, and
    the operations phase 7's bound counts."""
    cs = _chip_smoke()
    errs = cs.check_keyswitch(P.TEST_TINY, torch.device("cpu"), (1, 17, 33))
    assert errs == {"keyswitch": 0}
    assert cs.KS_CHECK_BATCHES == (1, 32, 33, 1024, 1025)
    # 4 limbs x 2 x 1024 x 8192 x 504: 33.8 GOP at λ=110
    assert cs.keyswitch_ops(P.IEACHE_110, 1024, 504) == \
        4 * 2 * 1024 * 8192 * 504


@pytest.mark.parametrize("rows", [4, 6])
def test_step_launch_phase_passes_on_cpu_models(rows):
    """Phase 3's pass over every launch shape of cmux_step (the mma.sync
    form and each wgmma tile and cluster, random and extreme
    accumulators), on the forms' plain models at 4 and 6 TRGSW rows,
    batches either side of a wgmma tile; and the crossover batches it
    adds are where step_launch changes form (the H100's clusters)."""
    cs = _chip_smoke()
    p = dataclasses.replace(P.TEST_TINY, l=rows // 2, name=f"tiny_{rows}rows")
    errs = cs.check_step_launches(p, torch.device("cpu"), (1, 8, 33))
    assert errs == {"cmux_step": 0}
    assert cs.step_crossovers(P.IEACHE_110_FAST) == [257, 513]
    assert cs.step_crossovers(P.IEACHE_110) == [257, 449]


def test_step_calls_and_lines_of_the_timing_phase():
    """Phase 7's per-step calls at a small batch run and agree with
    their twins on CPU tensors, and its line names what it times."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    assert "rotate_sublane" in cs.SMALL_BATCH_KERNELS
    for b in cs.SMALL_BATCHES:
        calls = cs.step_calls(p, dev, b, probe_b=b)
        assert set(cs.SMALL_BATCH_KERNELS) <= set(calls)
        # the small-batch line of the sublane rotation times it at B=b
        assert calls["rotate_sublane"][2][0].shape == (p.k + 1, p.N, b)
        for name, (kern, plain, inputs, ops) in calls.items():
            got, want = kern(), plain()
            assert torch.equal(got, want), name
            ms, by = cs.bound_ms((*inputs, got), ops, "int8")
            assert ms > 0 and by in ("bytes", "operations")
        assert calls["external_product"][3] == cs.external_product_ops(p, b)
    line = cs.step_line("external_product", 8, {
        "ms": 0.007, "plain_ms": 0.2, "host_ms": 0.02, "plain_host_ms": 0.3,
        "bound_ms": 0.0003, "bound_by": "operations"})
    assert line.startswith("phase 7 external_product B=8: kernel 0.0070 ms")
    assert "bound 0.0003 ms (operations)" in line


def test_cold_calls_cycle_copies_of_the_rotations_inputs():
    """Phase 7's cold timing: each rotation on enough copies of its
    accumulator that a cycle moves four times the L2, every copy equal
    to the first and each call equal to the twin; its line gives the
    share of the bound."""
    from ieache_tpu_torch.tools._common import COLD_BYTES, cold_copies
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    calls = cs.cold_calls(p, dev, 8, probe_b=16, cycle=40_000)
    assert set(calls) == {name for name, _, _ in cs.COLD_KERNELS}
    twins = {"rot_diff_decompose": kernels.rot_diff_decompose_plain,
             "rot_diff_decompose_tr": kernels.rot_diff_decompose_tr_plain,
             "rotate_lane": lambda a, t, p: kernels.rotate_lane_plain(a, t),
             "rotate_sublane":
                 lambda a, t, p: kernels.rotate_sublane_plain(a, t)}
    for name, (b, fns, (acc, bara)) in calls.items():
        assert b == (16 if name.startswith("rotate_") else 8)
        assert len(fns) == cold_copies(acc.numel() * 4, 40_000) >= 2
        assert len(fns) * acc.numel() * 4 >= 40_000
        want = twins[name](acc, bara, p)
        for fn in fns:
            assert torch.equal(fn(), want), name
    assert cold_copies(16_800_000) == 12 and cold_copies(10**9) == 2
    assert cold_copies(COLD_BYTES // 4) == 4
    line = cs.cold_line("rotate_sublane", {"b": 2048, "copies": 12,
                                           "ms": 0.02, "bound_ms": 0.01})
    assert line.startswith("phase 7 rotate_sublane B=2048 L2 cold: kernel "
                           "0.0200 ms/call")
    assert line.endswith("bound 0.0100 ms (bytes at the HBM rate), 50% "
                         "of it")


def test_profile_gate_runs_on_cpu_twins():
    """The profiling tool's two workloads under split and scan, at
    TEST_TINY on the CPU: each record names its mode and workload, its
    result decrypts right, and no device figure is made up."""
    from ieache_tpu_torch.tools import profile_gate

    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    saved = os.environ.get("IEACHE_PALLAS_STEP")
    seen = []
    recs = profile_gate.run(ks, ["split", "scan"], 8, 2, 5,
                            torch.device("cpu"), top=3, emit=seen.append)
    assert recs == seen and len(recs) == 4
    assert [(r["mode"], r["workload"]) for r in recs] == [
        ("split", "NAND B=8"), ("split", "A+B-C width 5 B=2"),
        ("scan", "NAND B=8"), ("scan", "A+B-C width 5 B=2")]
    for r in recs:
        assert r["decrypt_errors"] == 0 and r["wall_ms"] > 0
        assert len(r["rows"]) == 3 and r["events"] > 0
        assert "busy_ms" not in r and "idle_share" not in r
    assert os.environ.get("IEACHE_PALLAS_STEP") == saved


def test_tile_bench_checks_on_cpu_twins():
    """The tile benchmark's operands and its comparison with the twins,
    untimed, at TEST_TINY on the CPU."""
    from ieache_tpu_torch.tools import tile_bench

    dev = torch.device("cpu")
    p = P.TEST_TINY
    rec = tile_bench.run(p, [1, 8], [5], dev, check=True, timed=False,
                         step_b=[3, 16, 17], ks_b=[1, 33])
    assert rec == {"params": p.name, "external_product_ms": {},
                   "cmux_step_ms": {}, "cmux_step_overlap_ms": {},
                   "blind_rotate_scan_ms": {}, "rot_diff_decompose_ms": {},
                   "rot_diff_decompose_tr_ms": {},
                   "external_product_tr_ms": {}, "rotate_sublane_ms": {},
                   "rot_diff_decompose_launch_ms": {},
                   "rotate_sublane_route_ms": {},
                   "blind_rotate_scan_launch_ms": {},
                   "external_product_launch_ms": {},
                   "cmux_step_launch_ms": {}, "keyswitch_ms": {},
                   "keyswitch_launch_ms": {}}
    # the launch variants it times: both run lengths of the split
    # rotation, the sublane rotation's slab and gather
    acc, bara, _ = tile_bench.step_inputs(p, 5, dev, np.random.RandomState(1))
    variants = tile_bench.rotation_variants(
        p, acc, bara, acc.transpose(1, 2).contiguous())
    assert set(variants) == {"rot_diff_decompose run 4",
                             "rot_diff_decompose run 8",
                             "rotate_sublane gather",
                             "rotate_sublane slab, splits 4"}
    acc, bara, bk_i = tile_bench.step_inputs(p, 3, dev,
                                             np.random.RandomState(0))
    assert acc.shape == (p.k + 1, 3, p.N) and bara.shape == (3,)
    assert bk_i.shape == (p.trgsw_rows, p.k + 1, p.N)
    rng = np.random.RandomState(0)
    d, bk_i, acc = tile_bench.product_inputs(p, 3, dev, rng)
    assert d.shape == (p.trgsw_rows, 3, p.N) and d.dtype == torch.int8
    assert bk_i.shape == (p.trgsw_rows, p.k + 1, p.N)
    acc, bara, bk = tile_bench.scan_inputs(p, 3, dev, rng)
    assert bara.shape == (3, p.n) and int(bara.max()) < 2 * p.N
    assert bk.shape == (p.n, p.trgsw_rows, p.k + 1, p.N)
    assert set(tile_bench.PARAMS) == {"ieache_110", "ieache_110_l2",
                                      "ieache_110_tfhe_compat"}
    # the product's launch shapes it times beside the pick: all but the
    # pick's, each held against the twin on its plain model above
    q = P.IEACHE_110_FAST
    for b in (8, 1024):
        pick = kernels.product_launch(b, q.k + 1, q.N, q.trgsw_rows)
        variants = tile_bench.product_launch_variants(q, b)
        assert set(variants) == set(tile_models.product_launch_shapes(
            b, q.k + 1, q.N, q.trgsw_rows)) - {
                f"wgmma {pick.tile} x {pick.cols}"
                if pick.form == "wgmma" else "mma"}
        # the fused step's: every form, tile and cluster but the pick
        pick = kernels.step_launch(b, q.k + 1, q.N, q.trgsw_rows)
        variants = tile_bench.step_launch_variants(q, b)
        shapes = tile_models.step_launch_shapes(b, q.k + 1, q.N, q.trgsw_rows)
        assert set(variants) == {k for k, s in shapes.items() if s != pick}
        assert len(variants) == len(shapes) - 1
        # the keyswitch's: every tile but the pick's
        pick = kernels.keyswitch_launch(b, q)
        variants = tile_bench.keyswitch_launch_variants(q, b)
        assert set(variants) == {f"{t} lanes"
                                 for t in tile_models.KS_TILE_LANES
                                 if t != pick.lanes}


def test_compat_nand_phase_decrypts_on_cpu_twins():
    """Phase 4's NAND at a two-limb gadget under split: no error, and no
    launch on CPU tensors (the twins run)."""
    cs = _chip_smoke()
    p = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")
    errors, _, counts, rates = cs.compat_nand(p, torch.device("cpu"), 16)
    assert errors == 0 and not any(counts.values()) and len(rates) == 3


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


def test_evaluator_phase_passes_on_cpu_twins():
    """Phase 8 rehearsed at TEST_TINY on 8-bit operands: the three
    expressions under two modes and both adders (every lane right, answer
    codes 0, 1, 2, 4 and 5, nothing launched on the CPU), the plain path's
    value words equal to the kernel path's, each kernel against its twin
    at every batch the modes called it with, the per-lane widening, the
    memory analysis (-1 where the CPU has no counter) and the tools'
    lines at small sizes."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    pair = keygen_device.generate_gate_keypair_device(p, dev)
    key = bootstrap.pack_cloud_key(pair.main.cloud, dev)
    ev_in = cs.evaluator_inputs(pair, 8, dev)
    assert [len(v) for vals, _ in ev_in.values() for v in vals] == [8] * 9
    wrapper = kernels.rot_diff_decompose
    with kernels.recording_batches() as seen:
        recs, launches = cs.evaluator_modes(pair, key, ev_in, dev,
                                            modes=("split", "scan"))
        assert kernels.rot_diff_decompose.launches == wrapper.launches
    assert kernels.rot_diff_decompose is wrapper
    # among the waves, 8 (a ripple wave: one bit of 8 lanes) and 64 (a
    # parallel-prefix wave: 8 bits of 8 lanes); fused2 did not run
    assert {8, 64} <= seen["rot_diff_decompose"] == seen["external_product"]
    assert seen["blind_rotate_scan"] == seen["rot_diff_decompose"]
    assert seen["cmux_step"] == set()
    assert cs.check_wave_kernels(p, dev, seen) == {
        name: 0 for name in ("rot_diff_decompose", "external_product",
                             "blind_rotate_scan")}
    assert set(recs) == {(m, a) for m in ("split", "scan")
                         for a in cs.ADDERS}
    assert not any(n for counts in launches.values()
                   for n in counts.values())
    plain = cs.evaluator_vs_plain(pair, key, dev)
    assert set(plain) == {"A+B-C", "A-B*C"}
    assert cs.widening_case(pair, key, dev) == [114, 97]
    ma = cs.chain_memory(pair, key, dev, batch=4, width=4)
    assert ma["temp_size_in_bytes"] == -1 and ma["output_size_in_bytes"] > 0
    lines = cs.tool_lines(p, dev, bench_b=16, margin_b=32, expr_b=4,
                          width_cases=("mul6", "add12"),
                          cases={"mul6": ("mul", 6, 2),
                                 "add12": ("add", 12, 4)})
    assert [t for t, _ in lines] == ["bench", "margin_probe", "width_bench",
                                     "width_bench", "expr_bench"]
    assert all(rec["backend"] == "torch" for _, rec in lines)


def test_protocol_phase_passes_on_cpu_twins(tmp_path):
    """Phase 9 rehearsed at TEST_TINY: the in-process flows under split
    and scan on 6-bit operands (every lane right, the Cloud's and the
    Output's spans, nothing launched on the CPU), e2e_bench's shapes at
    8 bits, the keysets written for e2e_bench's keygen role, e2e_bench's
    OS processes with every decrypt_ok, and each kernel against its twin
    at every batch the flows called it with.  Under IEACHE_PALLAS=1 the
    Cloud process's kernels cannot run on the CPU: the job fails, and
    the failure reaches this process."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    pair = keygen_device.generate_gate_keypair_device(p, dev)
    with kernels.recording_batches() as seen:
        flows = cs.protocol_flows(pair, p, dev, width=6)
        replica = cs.e2e_replica(pair, p, dev, width=8, batch=1)
    assert set(flows) == {(m, n) for m in cs.PROTOCOL_MODES
                          for n, _ in cs.PROTOCOL_EXPRESSIONS}
    for rec in [*flows.values(), *replica.values()]:
        assert set(rec["cloud"]) == set(cs.CLOUD_SPANS)
        assert set(rec["output"]) == set(cs.OUTPUT_SPANS)
        assert not any(rec["launches"].values())
        assert 0 < rec["key_exchange_s"] < rec["seconds"]
    every = set().union(*seen.values())
    assert {1, 8} <= every
    assert cs.check_wave_kernels(p, dev, {
        name: every for name in ("rot_diff_decompose", "external_product",
                                 "blind_rotate_scan")}) == {
        name: 0 for name in ("rot_diff_decompose", "external_product",
                             "blind_rotate_scan")}
    keycache = str(tmp_path / "keycache")
    cs.ensure_e2e_keycache(pair, p, keycache)
    assert sorted(os.listdir(keycache)) == [f"{p.name}_.iek",
                                            f"{p.name}_nbit.iek"]
    rec = cs.e2e_line(p, dev, keycache, width=8, batch=1,
                      logdir=str(tmp_path / "logs"), pallas=None)
    assert [r["decrypt_ok"] for r in rec["runs"]] == [True] * 4
    assert rec["cloud_launches"] == {}
    with pytest.raises(RuntimeError, match="IEACHE_PALLAS=1"):
        cs.e2e_line(p, dev, keycache, width=8, batch=1,
                    logdir=str(tmp_path / "logs1"))


def test_distribution_phase_passes_on_cpu_twins():
    """Phase 10 rehearsed at TEST_TINY in a one-rank gloo group: the
    (1, 1) tp and sp bootstraps equal to the unsharded port with no
    wrong lane and no launch, the dp-sharded A + B - C equal to the
    unsharded evaluator's value word, the pp=1 chain equal to
    chain_unpipelined, each kernel against its twin at the batches they
    called it with; then the dry run on a rank of its own (nothing
    launched on the CPU) and its kernels against their twins at the
    batches the rank recorded (on the CPU the mode loop runs the twins
    directly, so only the split pair's waves are recorded)."""
    cs = _chip_smoke()
    dev = torch.device("cpu")
    p = P.TEST_TINY
    pair = keygen_device.generate_gate_keypair_device(p, dev)
    key = bootstrap.pack_cloud_key(pair.main.cloud, dev)
    ev_in = cs.evaluator_inputs(pair, 8, dev)
    recs, _ = cs.evaluator_modes(pair, key, ev_in, dev, modes=("split",))
    want = recs["split", "ripple"]["A+B-C"]["value"]
    nand_in = cs.nand_inputs(pair.main, 16, dev)
    cs.launch.init(0, 1, f"127.0.0.1:{cs.launch.free_port()}", dev)
    try:
        secs = cs.sharded_bootstraps(pair.main, key, nand_in, dev)
        assert set(secs) == {"tp", "sp"}
        with kernels.recording_batches() as seen:
            _, ev_launches = cs.dp_evaluator(pair, key, ev_in, want, dev)
            _, pp_launches = cs.pipeline_chain(pair.main, key, dev, width=6)
    finally:
        torch.distributed.destroy_process_group()
    assert not any(ev_launches.values()) and not any(pp_launches.values())
    assert {4, 8} <= seen["rot_diff_decompose"] == seen["external_product"]
    assert cs.check_wave_kernels(p, dev, seen)["external_product"] == 0
    by_mode, dry_seen, _ = cs.dryrun_line(dev)
    assert set(by_mode) == {"split", "tr", "scan", "ntt"}
    assert set(dry_seen) == {"rot_diff_decompose", "external_product"}
    assert 16 in dry_seen["rot_diff_decompose"]
    errs = cs.check_wave_kernels(p, dev, dry_seen)
    assert errs == {"rot_diff_decompose": 0, "external_product": 0}
