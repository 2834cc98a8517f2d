"""A benchmark root at TEST_TINY sizes for the CPU tests: a copy of the
benchmark's data files and readers, a configuration of the port's
noiseless test sizes and small mixes, with cells that use them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from fhe_bench import harness

TINY_PARAMS = {"n": 8, "N": 64, "k": 1, "bg_bit": 8, "l": 2,
               "ks_basebit": 4, "ks_t": 4, "lwe_noise_scale": 0,
               "tlwe_noise_scale": 0, "noise_bits": 1024}

MIXES = {
    "tiny_batch": {"entry": "evaluator", "postfix": "AB+C-", "lanes": 4,
                   "width": 32, "magnitude_bits": 31, "negative_share": 0.5,
                   "loop": "closed", "operand_pool": 2, "warm_batches": [4],
                   "why": "test"},
    "tiny_interactive": {"entry": "protocol", "postfix": "AB+C-",
                         "lanes": 1, "width": 32, "magnitude_bits": 31,
                         "negative_share": 0.5, "loop": "closed",
                         "warm_batches": [1], "why": "test"},
}

BATCH, INTERACTIVE = "tiny.batch", "tiny.interactive"


def make_root(path: Path) -> Path:
    """A root at ``path`` holding the benchmark's files and the tiny
    configuration, mixes and cells."""
    shutil.copytree(harness.ROOT / "fhe_bench", path / "fhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cfg = {"name": "tiny", "source": "the port's TEST_TINY sizes",
           "params_name": "test_tiny", "params": TINY_PARAMS,
           "operand_width": 32, "assumed": [], "reduced": []}
    (path / "fhe_bench/configs/tiny.json").write_text(json.dumps(cfg))
    for name, mix in MIXES.items():
        (path / f"fhe_bench/traffic/{name}.json").write_text(json.dumps(mix))
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "fhe_bench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    for cell, mix, like in ((BATCH, "tiny_batch", "batch"),
                            (INTERACTIVE, "tiny_interactive",
                             "interactive")):
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": mix, "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if any(w.split(".", 1)[1].startswith(like)
                   for w in m.get("workloads", ())):
                m["workloads"].append(cell)
    (path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return path


def run(root: Path, cell: str, seed: int = 2**31 + 5, trace: bool = False,
        tamper=None, seconds: float = 0.0):
    """One run of ``cell`` on the CPU: its line and record."""
    import time
    return harness.run(harness.Bench(root), cell, seed, seconds, trace,
                       "cpu", time.perf_counter(), tamper)
