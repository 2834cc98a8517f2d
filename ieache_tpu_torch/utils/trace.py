"""Tracing / profiling utilities.

The port's counterpart of :mod:`ieache_tpu.utils.trace`.  The
reference's observability is wall-clock prints and two append-only
files (``timings.txt``, ``averagestandard.txt`` — SURVEY §5.1).  This
module provides the structured counterpart:

* :class:`Timings` — named spans + counters, JSONL export (the
  timings.txt replacement used by the CLI and nodes), as in the JAX
  package;
* :func:`device_trace` — context manager around ``torch.profiler``
  (CPU and CUDA activities), a Chrome trace exported to the log dir;
* :func:`sync` — the fence a span around device work ends with:
  ``torch.cuda.synchronize`` on a CUDA device, so that the span covers
  the computation and not its enqueue;
* :func:`bootstraps_per_sec` — the framework's headline counter.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class Timings:
    def __init__(self):
        self.spans = []
        self.counters = {}

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(
                {"name": name, "seconds": time.perf_counter() - t0, **meta}
            )

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def dump(self, path: str = "timings.txt"):
        with open(path, "a") as f:
            f.write(json.dumps(
                {"spans": self.spans, "counters": self.counters}
            ) + "\n")

    def total(self, name: str) -> float:
        return sum(s["seconds"] for s in self.spans if s["name"] == name)


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on
    the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(logdir: str, name: str = "trace"):
    """``torch.profiler`` trace of the block (CPU activity, and CUDA's
    where a CUDA device is present), written to ``logdir/<name>.json``
    as a Chrome trace (``chrome://tracing``, Perfetto).  Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def bootstraps_per_sec(gates: int, seconds: float) -> float:
    return gates / seconds if seconds > 0 else float("inf")
