"""A cell's run with the program's tracer on: the span metrics, the
idle time by span, and what tracing costs.

    python3 -m fhe_bench.span_probe --workload <name> --seed <n> --seconds <s> [--turns 4]

Run from the root of a checkout, on the card.  It sets the cell up as
a benchmark run does, then runs ``--turns`` windows of ``--seconds``
each, the program's tracer (``ieache_tpu_torch.utils.trace``) off and
on in turns (off, on, on, off, ...), then one more job with the tracer
on under ``torch.profiler`` (CUDA activity, as the benchmark's traced
run).  Every job is judged as a benchmark run judges it.  It prints
one JSON line: each window's rate, the difference the tracer makes, a
span's host cost off and on, the metrics of ``NEW_METRICS`` read by
their readers in ``metrics/`` from the traced windows and the profiled
job (the record those readers expect: the window's ``spans``, and the
profiled ``slice`` with the keys :func:`fhe_bench.spans.slice_keys`
adds), and the profiled job's breakdown with ``idle_by_span``.

The benchmark's own run (``fhe_bench.run``) records no span: a traced
run that calls ``trace.enable()`` before its window and keeps the spans
in its record is what would report these metrics in every cell.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from fhe_bench import harness, profiling, spans
from fhe_bench.reference import answer as reference
from fhe_bench.reference import keys as ref_keys
from ieache_tpu_torch.ops import blind_rotate, kernels
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import trace

#: the span metrics a cell of each entry reports
NEW_METRICS = {
    "evaluator": ["dispatch_us_per_launch.batch",
                  "bootstrapped_per_lane.batch", "plan_s_per_job.batch",
                  "rotation_roofline_share.batch",
                  "idle_in_dispatch_share.batch"],
    "protocol": ["dispatch_us_per_launch.interactive",
                 "idle_in_dispatch_share.interactive"],
}

#: spans timed for a span's host cost
COST_SPANS = 50_000


def span_cost_ns() -> dict:
    """A span's host nanoseconds with the tracer off and on (one
    ``trace.span`` entered and left, in a loop)."""
    out = {}
    for state in ("off", "on"):
        if state == "on":
            trace.enable()
        t0 = time.perf_counter_ns()
        for _ in range(COST_SPANS):
            with trace.span("cost", lanes=1):
                pass
        out[state] = (time.perf_counter_ns() - t0) / COST_SPANS
        trace.disable()
    return out


def window(cell, seconds: float, first: int, traced: bool) -> dict:
    """Jobs back to back for ``seconds``, job numbers from ``first``."""
    record = trace.enable() if traced else None
    try:
        jobs, t0 = [], time.perf_counter()
        while True:
            jobs.append(cell.job(first + len(jobs)))
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
    finally:
        trace.disable()
    return {"traced": traced, "jobs": jobs, "window_s": now - t0,
            "spans": record.spans if traced else None}


def profiled(fn, device, rotation_kernels) -> dict | None:
    """``fn()`` with the tracer on under the profiler (CUDA activity),
    ended by a device synchronize: the keys of the benchmark's profiled
    slice and those :func:`fhe_bench.spans.slice_keys` adds; None on
    the CPU, where nothing is profiled."""
    device = torch.device(device)
    record = trace.enable()
    try:
        if device.type != "cuda":
            fn()
            return None
        torch.cuda.synchronize(device)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start = trace.now_ns()
            fn()
            torch.cuda.synchronize(device)
            end = trace.now_ns()
    finally:
        trace.disable()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
            e.correlation_id()) for e in events if e.device_type() == cuda]
    wanted = {o[3] for o in ops}
    launches = {}
    for e in events:
        if e.device_type() != cuda and e.correlation_id() in wanted:
            c = e.correlation_id()
            launches[c] = min(launches.get(c, e.start_ns()), e.start_ns())
    intervals = [(s * 1e-9, e * 1e-9, name) for s, e, name, _ in ops]
    sliced = {"busy_s": profiling.busy_seconds(intervals),
              "wall_s": (end - start) * 1e-9,
              "breakdown": profiling.breakdown(intervals)}
    sliced.update(spans.slice_keys(spans.between(record.spans, start, end),
                                   ops, launches, start, end,
                                   rotation_kernels))
    sliced["breakdown"]["idle_by_span"] = sliced["idle_by_span"]
    return sliced


def rate(w: dict, lanes: int) -> dict:
    done = [j for j in w["jobs"] if "seconds" in j]
    return {"traced": w["traced"], "jobs": len(w["jobs"]),
            "lanes_per_s": lanes * len(done) / w["window_s"],
            "answer_latency_s": (statistics.fmean(j["seconds"] for j in done)
                                 if done else None)}


def run(bench, name: str, seed: int, seconds: float, turns: int,
        device) -> dict:
    """The probe's line for cell ``name``."""
    device = torch.device(device)
    cell_spec = bench.workload(name)
    cfg = bench.config(cell_spec["config"])
    mix = bench.mix(cell_spec["traffic"])
    params = TFHEParams(name=cfg["params_name"], **cfg["params"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell = harness.CELLS[mix["entry"]](params, mix, seed, device)
    mode = blind_rotate.step_mode()
    cost = span_cost_ns()
    windows = []
    for t in range(turns):
        first = sum(len(w["jobs"]) for w in windows)
        windows.append(window(cell, seconds, first, t % 4 in (1, 2)))
    jobs = [j for w in windows for j in w["jobs"]]
    sliced = profiled(lambda: jobs.append(cell.job(len(jobs))), device,
                      kernels.MODE_KERNELS[mode])
    if sliced is not None:
        sliced["boots"] = jobs[-1].get("boots", 0)
    cell.close()

    main_s, nbit_s = (ref_keys.lwe_secret(ref_keys.seed_words(seed, k),
                                          params.n)
                      for k in ("main", "nbit"))
    wrong = 0
    for job in jobs:
        if "answer" not in job:
            wrong += mix["lanes"]
            continue
        wrong += reference.judge_job(
            mix["postfix"], job.pop("values"), mix["width"],
            job.pop("answer"), main_s, nbit_s, job.pop("reported", None))

    traced = [w for w in windows if w["traced"]]
    record = {"entry": mix["entry"], "lanes": mix["lanes"],
              "params": cfg["params"],
              "jobs": [j for w in traced for j in w["jobs"]],
              "window_s": sum(w["window_s"] for w in traced),
              "spans": [s for w in traced for s in w["spans"]],
              "slice": sliced}
    # the span metrics, and the accepted per-layer ones on the same jobs
    metrics, accepted = {}, {}
    for names, out in ((NEW_METRICS[mix["entry"]], metrics),
                       ([m["name"] for m in bench.metrics(name, True)],
                        accepted)):
        for m in names:
            value = bench.reader(m)(record)
            if value is not None:
                out[m] = value
    rates = [rate(w, mix["lanes"]) for w in windows]
    key = "lanes_per_s" if mix["entry"] == "evaluator" else \
        "answer_latency_s"
    on = [r[key] for r in rates if r["traced"] and r[key] is not None]
    off = [r[key] for r in rates if not r["traced"] and r[key] is not None]
    line = {"workload": name, "seed": seed, "step_mode": mode,
            "correct": wrong == 0, "wrong_lanes": wrong,
            "windows": rates, "span_cost_ns": cost, "metrics": metrics,
            "accepted_metrics": accepted,
            "on_against_off": {
                "metric": key,
                "off": statistics.median(off) if off else None,
                "on": statistics.median(on) if on else None,
                "change_pct": (100.0 * (statistics.median(on)
                                        / statistics.median(off) - 1.0)
                               if on and off else None)}}
    if sliced is not None:
        line["slice"] = {k: sliced[k] for k in (
            "busy_s", "wall_s", "idle_s", "attribution", "bootstrapped",
            "idle_s_by_span", "device_s_by_span")}
        line["breakdown"] = sliced["breakdown"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fhe_bench.span_probe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fhe_bench.span_probe: needs a CUDA device", file=sys.stderr)
        return 2
    line = run(harness.Bench(harness.ROOT), args.workload, args.seed,
               args.seconds, args.turns, torch.device("cuda", 0))
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
