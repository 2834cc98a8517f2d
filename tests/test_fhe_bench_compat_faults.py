"""The check that decides ``correct`` in the two cells of the published
gadget and the multiply, as ``fhe_bench/tests/test_fhe_bench_faults.py``
does it for the others: a whole run (set-up, window, check) at a tiny
size on the CPU, sound and correct, then with one fault each way these
cells can break, and not correct.

* the two-limb gadget (Bg = 2^10, l = 2 at TEST_TINY's other sizes) on
  the split path with the high limb's products dropped (its digit rows
  zeroed): the kernels' twins on the CPU take the same rows the card's
  kernels do;
* ``A * B - C`` with the JAX package's code-4 sign put back: a product
  of two negative operands handed on to the subtraction as negative.
"""

import json

import numpy as np
import pytest
import torch

from fhe_bench import traffic
from fhe_bench.tests import tiny
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.ops import kernels

COMPAT, MUL = "tiny_compat.interactive", "tiny.interactive_mul"

MUL_MIX = {"entry": "protocol", "postfix": "AB*C-", "lanes": 1, "width": 32,
           "magnitude_bits": 31, "negative_share": 0.5, "loop": "closed",
           "warm_batches": [1, 32, 33], "why": "test"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root with a two-limb configuration and a one-lane multiply
    mix, and a cell of each."""
    path = tiny.make_root(tmp_path_factory.mktemp("root"))
    cfg = {"name": "tiny_compat", "source": "test",
           "params_name": "tiny_compat",
           "params": dict(tiny.TINY_PARAMS, bg_bit=10),
           "operand_width": 32, "assumed": [], "reduced": []}
    (path / "fhe_bench/configs/tiny_compat.json").write_text(json.dumps(cfg))
    (path / "fhe_bench/traffic/tiny_mul.json").write_text(
        json.dumps(MUL_MIX))
    spec = json.loads((path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_compat", "source": "test",
                            "file": "fhe_bench/configs/tiny_compat.json",
                            "reduced": [], "why": "test"})
    spec["workloads"] += [
        {"name": COMPAT, "config": "tiny_compat",
         "traffic": "tiny_interactive", "chips": 1, "why": "test"},
        {"name": MUL, "config": "tiny", "traffic": "tiny_mul", "chips": 1,
         "why": "test"}]
    (path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return path


def both_negative_seed() -> int:
    """The first seed from 2^31 whose first job multiplies A < 0 by
    B < 0."""
    seed = 2**31
    while not all(traffic.operand_values(MUL_MIX, seed, 0, x)[0] < 0
                  for x in "AB"):
        seed += 1
    return seed


def checks(line):
    return {k: c["value"] for k, c in line["checks"].items()}


@pytest.mark.parametrize("cell", [COMPAT, MUL])
def test_sound_run_is_correct(root, cell):
    seed = both_negative_seed() if cell == MUL else 2**31 + 808
    line, _ = tiny.run(root, cell, seed)
    assert line["correct"] and checks(line) == {"wrong_lanes": 0,
                                                "failed_jobs": 0}


def test_high_limb_dropped_is_not_correct(root, monkeypatch):
    real = kernels.digit_limb_rows

    def low_limbs_only(d, params):
        rows = real(d, params)
        if params.digit_limbs != 1:
            rows[:, 1::2] = 0
        return rows
    monkeypatch.setattr(kernels, "digit_limb_rows", low_limbs_only)
    line, _ = tiny.run(root, COMPAT, 2**31 + 808)
    assert not line["correct"] and checks(line)["wrong_lanes"] > 0


def test_code4_sign_handed_on_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(ev, "_chained_product_code",
                        lambda n1, n2: np.array([0, 1, 2, 4])[n1 + 2 * n2])
    line, _ = tiny.run(root, MUL, both_negative_seed())
    assert not line["correct"] and checks(line)["wrong_lanes"] == 1
