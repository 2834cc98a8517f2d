"""No run of the benchmark holds JAX or the JAX package, compared by
whole top-level module name (``ieache_tpu_torch`` begins with
``ieache_tpu``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from fhe_bench import harness


@pytest.mark.parametrize("name,held", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("ieache_tpu", True), ("ieache_tpu.params", True),
    ("ieache_tpu_torch", False), ("ieache_tpu_torch.ops.kernels", False),
    ("jaxtyping", False), ("fhe_bench.run", False), ("ieache_tpux", False),
])
def test_forbidden_by_whole_top_level_name(name, held):
    assert (harness.forbidden_modules([name]) == [name]) is held


RUN_TINY = """
import sys, tempfile
from pathlib import Path
import fhe_bench.run, fhe_bench.control
from fhe_bench import harness
from fhe_bench.tests import tiny
root = tiny.make_root(Path(tempfile.mkdtemp(dir=sys.argv[1])))
for cell in (tiny.BATCH, tiny.INTERACTIVE):
    for trace in (False, True):
        line, _ = tiny.run(root, cell, trace=trace)
        assert line["correct"], line
print(harness.forbidden_modules(sys.modules))
"""


def test_a_run_holds_no_jax(tmp_path):
    """Both entries, traced and not, in a process of their own: what the
    port and the harness load holds no forbidden module."""
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(tmp_path)],
                         check=True, capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "fhe_bench.run", "--workload",
         "ieache_110.batch_add", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_run_refuses_with_only_the_benchmarks_files(tmp_path):
    """A directory holding only BENCHMARK.json and the files under
    ``paths`` lacks the program: the run exits nonzero with no result."""
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for path in spec["paths"]:
        shutil.copytree(harness.ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, *spec["command"][1:], "--workload",
         spec["workloads"][0]["name"], "--seed", str(2**31 + 2),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    """One short run of each cell on the card: exit 0, a result line
    with ``correct`` true, platform gpu."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        proc = subprocess.run(
            [sys.executable, *spec["command"][1:], "--workload",
             cell["name"], "--seed", str(2**31 + 3), "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True,
            cwd=harness.ROOT, timeout=900)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
