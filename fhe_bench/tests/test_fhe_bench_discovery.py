"""Discovery by name: a configuration, a traffic mix and a per-layer
metric are added as new files, and a run of a new cell finds them, with
no file of the benchmark edited."""

import hashlib
import json

from fhe_bench import harness
from fhe_bench.tests import tiny

NEW_METRIC = '''"""Jobs a run's window held."""


def read(record):
    return float(len(record["jobs"]))
'''


def digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "fhe_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    root = tiny.make_root(tmp_path)
    before = digest(root)
    cfg = json.loads((root / "fhe_bench/configs/tiny.json").read_text())
    cfg.update(name="tiny_l3", params=dict(cfg["params"], l=3))
    files = {"fhe_bench/configs/tiny_l3.json": json.dumps(cfg),
             "fhe_bench/traffic/tiny_sub.json": json.dumps(
                 dict(tiny.MIXES["tiny_batch"], postfix="AB-C-", lanes=2,
                      warm_batches=[2])),
             "fhe_bench/metrics/jobs_per_window.batch.py": NEW_METRIC}
    for rel, text in files.items():
        (root / rel).write_text(text)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_l3", "source": "test",
                            "file": "fhe_bench/configs/tiny_l3.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_l3.sub", "config": "tiny_l3",
                              "traffic": "tiny_sub", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "lanes_per_s":
            m["workloads"].append("tiny_l3.sub")
    spec["per_layer"].append({
        "name": "jobs_per_window.batch", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "Evaluator",
        "moves": "lanes_per_s", "workloads": ["tiny_l3.sub"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    line, record = tiny.run(root, "tiny_l3.sub", trace=True)
    assert line["correct"], line
    assert record["params"]["l"] == 3
    assert line["metrics"]["jobs_per_window.batch"]["value"] == 1.0
    assert set(line["metrics"]) == {"jobs_per_window.batch"}
    line, _ = tiny.run(root, "tiny_l3.sub")
    assert set(line["metrics"]) == {"lanes_per_s", "setup_s"}
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == set(files)


def test_metrics_by_cell(tmp_path):
    bench = harness.Bench(tiny.make_root(tmp_path))
    names = lambda cell, trace: {m["name"] for m in  # noqa: E731
                                 bench.metrics(cell, trace)}
    assert names(tiny.BATCH, False) == {"lanes_per_s", "setup_s"}
    assert names(tiny.INTERACTIVE, False) == {"answer_latency_s", "setup_s"}
    assert names(tiny.INTERACTIVE, True) == {
        "protocol_s_per_job.interactive", "device_idle_share.interactive",
        "kernel_launches_per_job.interactive"}
    spec = bench.spec
    spec["per_layer"].append({"name": "x", "moves": "answer_latency_s"})
    assert "x" in names(tiny.INTERACTIVE, True)
    assert "x" not in names(tiny.BATCH, True)


def test_the_benchmark_json_names_what_exists():
    bench = harness.Bench(harness.ROOT)
    spec = bench.spec
    for cell in spec["workloads"]:
        assert bench.config(cell["config"])["name"] == cell["config"]
        mix = bench.mix(cell["traffic"])
        assert mix["width"] == bench.config(cell["config"])["operand_width"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for cfg in spec["configs"]:
        body = json.loads((harness.ROOT / cfg["file"]).read_text())
        assert body["name"] == cfg["name"]
        assert body["source"] == cfg["source"]
        assert body["reduced"] == cfg["reduced"]
