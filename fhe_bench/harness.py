"""One run of one cell: set-up, the measured window, the check.

Everything is found by name from ``BENCHMARK.json``: the cell, its
configuration's file, its traffic mix in ``traffic/<mix>.json`` and a
reader per metric in ``metrics/<metric>.py`` (a module with
``read(record) -> float | None``).  The harness builds the system under
test from the program's public entry points, times it, and hands each
reader one record of the run; a reader that finds nothing to read
returns None and its metric is left out of the line.

The record a reader gets: ``entry``, ``setup_s``, ``phases`` (seconds
of set-up's parts and of the check), ``window_s`` (from
the window's start to its last job's end), ``lanes`` (a job's),
``params`` (the configuration's sizes), ``jobs`` (one dict a job of the
window: ``seconds``, ``lanes``, ``boots`` (the evaluator's
``gate_count`` delta), ``launches`` (``kernels.launch_counts()``
delta), and under the protocol entry ``compute_s``, the Cloud's
computation spans in that job) and, in a traced run, ``slice``: one
more job run under the profiler (``busy_s``, ``wall_s``, ``boots``,
``breakdown``).
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import torch

from fhe_bench import profiling, topology, traffic
from fhe_bench.reference import answer as reference
from fhe_bench.reference import keys as ref_keys
from ieache_tpu_torch.boot.bootstrap import bootstrap, pack_cloud_key
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.lwe.keygen_device import generate_secret_keyset_device
from ieache_tpu_torch.lwe.types import GateKeyPair
from ieache_tpu_torch.mp import scheduler
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import prng
from ieache_tpu_torch.utils.trace import sync

#: the top-level module names a run may not hold: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ieache_tpu")

#: the Cloud's adder, as ``serve`` runs it by default
ADDER = "ripple"

#: the root of the checkout: ``BENCHMARK.json`` and this package
ROOT = Path(__file__).resolve().parent.parent


def forbidden_modules(names) -> list:
    """The names among ``names`` whose top-level name, the part before
    the first dot, is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted(n for n in names
                  if n.split(".", 1)[0] in FORBIDDEN_MODULES)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "fhe_bench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def workload(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def mix(self, name: str) -> dict:
        return traffic.load(self.dir / "traffic" / f"{name}.json")

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"fhe_bench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` reports: its end-to-end ones,
        or with ``trace`` its per-layer ones."""
        def listed(m):
            return "workloads" not in m or cell in m["workloads"]
        e2e = [m for m in self.spec["end_to_end"] if listed(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def make_keys(params: TFHEParams, seed: int, device) -> GateKeyPair:
    """The main and nbit keysets, from the seed, by the device keygen."""
    return GateKeyPair(*(generate_secret_keyset_device(
        params, device, ref_keys.seed_words(seed, name))
        for name in ("main", "nbit")))


def warm(dck, batches, device) -> None:
    """One bootstrap wave at each batch a job uses."""
    n = dck.params.n
    for b in batches:
        bootstrap(torch.zeros((b, n + 1), dtype=torch.int32, device=device),
                  dck)
    sync(device)


def _counts(evaluator) -> tuple:
    return evaluator.gate_count, sum(kernels.launch_counts().values())


class EvaluatorCell:
    """Jobs into the Cloud's evaluator on operands resident on the
    device: the pool of operands is encrypted in set-up by the clients'
    ``encrypt_operand``."""

    def __init__(self, params, mix, seed, device):
        self.mix, self.device = mix, device
        t0 = time.perf_counter()
        pair = make_keys(params, seed, device)
        t1 = time.perf_counter()
        self.evaluator = ev.CloudEvaluator(
            pack_cloud_key(pair.main.cloud, device), pair.nbit, adder=ADDER)
        letters, _, steps = scheduler.plan_postfix(mix["postfix"])
        self.letters = letters
        self.steps = [(scheduler.OPCODES[c], lhs, rhs)
                      for c, lhs, rhs in steps]
        self.pool = mix["operand_pool"]
        self.values, self.operands = {}, {}
        for li, letter in enumerate(letters):
            self.values[letter] = [
                traffic.operand_values(mix, seed, k, letter)
                for k in range(self.pool)]
            self.operands[letter] = [
                ev.encrypt_operand(
                    pair.main, pair.nbit, v, mix["width"],
                    prng.key_from_seed_words(
                        [0x6F70, seed & 0xFFFFFFFF, seed >> 32, li, k]),
                    device)
                for k, v in enumerate(self.values[letter])]
        sync(device)
        t2 = time.perf_counter()
        warm(self.evaluator.dck, mix["warm_batches"], device)
        self.phases = {"keys": t1 - t0, "operands": t2 - t1,
                       "warm": time.perf_counter() - t2}

    def job(self, j: int) -> dict:
        picks = traffic.pool_picks(j, self.letters, self.pool)
        operands = [self.operands[x][picks[x]] for x in self.letters]
        gates, launches = _counts(self.evaluator)
        t0 = time.perf_counter()
        answer, _ = self.evaluator.compute_steps(self.steps, operands)
        sync(self.device)
        seconds = time.perf_counter() - t0
        gates2, launches2 = _counts(self.evaluator)
        return {"seconds": seconds, "lanes": self.mix["lanes"],
                "boots": gates2 - gates, "launches": launches2 - launches,
                "values": {x: self.values[x][picks[x]] for x in self.letters},
                "answer": (answer.neg_word, answer.bit_word, answer.value)}

    def close(self):
        self.operands = self.evaluator = None


class ProtocolCell:
    """Jobs through the in-process protocol, timed on the Output's
    side; the key plane runs once, in set-up."""

    def __init__(self, params, mix, seed, device):
        self.mix, self.seed, self.device = mix, seed, device
        self.letters = scheduler.plan_postfix(mix["postfix"])[0]
        t0 = time.perf_counter()
        pair = make_keys(params, seed, device)
        t1 = time.perf_counter()
        self.net = topology.Topology(params, pair, self.letters, device,
                                     adder=ADDER)
        t2 = time.perf_counter()
        warm(self.evaluator.dck, mix["warm_batches"], device)
        self.phases = {"keys": t1 - t0, "key_plane": t2 - t1,
                       "warm": time.perf_counter() - t2}

    @property
    def evaluator(self):
        return self.net.cloud.evaluator

    @evaluator.setter
    def evaluator(self, value):
        self.net.cloud.evaluator = value

    def job(self, j: int) -> dict:
        values = {x: traffic.operand_values(self.mix, self.seed, j, x)
                  for x in self.letters}
        cloud = self.net.cloud
        gates, launches = _counts(self.evaluator)
        spans, answers = len(cloud.trace.spans), len(cloud.answers)
        try:
            reported, seconds = self.net.submit(self.mix["postfix"], values,
                                                self.mix["width"])
        except RuntimeError as e:        # the Cloud's job failed
            return {"error": str(e), "values": values}
        gates2, launches2 = _counts(self.evaluator)
        compute = [s["seconds"] for s in cloud.trace.spans[spans:]
                   if s["name"].startswith("compute")]
        answer = cloud.answers[answers]
        return {"seconds": seconds, "lanes": self.mix["lanes"],
                "boots": gates2 - gates, "launches": launches2 - launches,
                "compute_s": sum(compute), "values": values,
                "reported": reported,
                "answer": (answer.neg_word, answer.bit_word, answer.value)}

    def close(self):
        self.net.close()
        self.net.cloud.evaluator = None


CELLS = {"evaluator": EvaluatorCell, "protocol": ProtocolCell}


def run(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
        device, started: float, tamper=None) -> tuple:
    """One run of cell ``name``; returns its result line and the record
    its metrics were read from.  ``started``
    is the process's start on the ``time.perf_counter`` clock.
    ``tamper(cell)``, where given, is called on the set-up cell before
    the window: the control and the tests' faults put their stand-in
    there."""
    device = torch.device(device)
    cell_spec = bench.workload(name)
    cfg = bench.config(cell_spec["config"])
    mix = bench.mix(cell_spec["traffic"])
    if cfg["operand_width"] != mix["width"]:
        raise ValueError(f"{name}: the mix's width is not the config's")
    params = TFHEParams(name=cfg["params_name"], **cfg["params"])
    t_card = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_cell = time.perf_counter()
    cell = CELLS[mix["entry"]](params, mix, seed, device)
    phases = {"start": t_card - started, "card": t_cell - t_card,
              **cell.phases}
    if tamper is not None:
        tamper(cell)
    t0 = time.perf_counter()
    setup_s = t0 - started
    jobs = []
    while True:
        jobs.append(cell.job(len(jobs)))
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
    window_s = now - t0
    window_jobs = list(jobs)

    sliced = None
    if trace:
        sliced = profiling.profile(lambda: jobs.append(cell.job(len(jobs))),
                                   device)
        if sliced is not None:
            sliced["boots"] = jobs[-1].get("boots", 0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.close()
    del cell
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, on what the window's jobs (and the profiled one) produced
    t_check = time.perf_counter()
    main_s, nbit_s = (ref_keys.lwe_secret(ref_keys.seed_words(seed, k),
                                          params.n)
                      for k in ("main", "nbit"))
    wrong = failed = 0
    for job in jobs:
        if "answer" not in job:
            failed += 1
            wrong += mix["lanes"]
            continue
        bad = reference.judge_job(mix["postfix"], job.pop("values"),
                                  mix["width"], job.pop("answer"),
                                  main_s, nbit_s, job.pop("reported", None))
        wrong += bad
        failed += bad > 0

    phases["check"] = time.perf_counter() - t_check
    record = {"entry": mix["entry"], "setup_s": setup_s, "phases": phases,
              "window_s": window_s, "lanes": mix["lanes"],
              "params": cfg["params"], "jobs": window_jobs,
              "slice": sliced}
    metrics = {}
    for m in bench.metrics(name, trace):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": wrong == 0 and failed == 0 and bool(jobs),
            "attempted": len(jobs), "failed": failed, "metrics": metrics,
            "device": dev}
    if sliced is not None:
        dev.update(busy_s=sliced["busy_s"], window_s=sliced["wall_s"])
        line["breakdown"] = sliced["breakdown"]
    line["checks"] = {"wrong_lanes": {"value": wrong, "limit": 0},
                      "failed_jobs": {"value": failed, "limit": 0}}
    return line, record
