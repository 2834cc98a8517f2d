"""Tracing utilities.

The port's counterpart of :mod:`ieache_tpu.utils.trace`.  The
reference's observability is wall-clock prints and two append-only
files (``timings.txt``, ``averagestandard.txt`` — SURVEY §5.1).  This
module provides the structured counterpart:

* :class:`Timings` — named spans + counters, JSONL export (the
  timings.txt replacement used by the CLI and nodes).  Every span is
  one record: ``name``, ``start_ns`` and ``end_ns`` (on the clock
  ``torch.profiler`` gives device operations, see :func:`now_ns`),
  ``seconds``, ``id``, ``parent`` (the ``id`` of the span open around
  it on the same thread, or None), ``job`` (see :func:`job`, or None)
  and its attributes;
* the process tracer, off by default: :func:`enable`, :func:`disable`,
  :func:`recorded`, and :func:`span`, which records into it while it
  is on and is one shared no-op while it is off.  While it is on, the
  spans of every :class:`Timings` (the nodes') are recorded in it too,
  so that one job's spans form one tree;
* :func:`job` — tags the spans opened inside it, on this thread, with
  a job id;
* :func:`sync` — the fence a span around device work ends with:
  ``torch.cuda.synchronize`` on a CUDA device, so that the span covers
  the computation and not its enqueue;
* :func:`bootstraps_per_sec` — the framework's headline counter.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import time

import torch

#: span ids, unique in the process
_ids = itertools.count(1)
#: the id of the span open on this thread (each thread has its own
#: context), and the job its spans belong to
_parent = contextvars.ContextVar("ieache_trace_parent", default=None)
_job = contextvars.ContextVar("ieache_trace_job", default=None)

#: the process tracer while it is on, and the last one enabled
_process = None
_recorded = None

#: what :func:`span` returns while the process tracer is off
_NOOP = contextlib.nullcontext()


def now_ns() -> int:
    """The spans' clock: CLOCK_REALTIME in nanoseconds since the epoch,
    the clock ``torch.profiler`` (kineto) puts host and device events
    on, so that a span and a device operation compare directly."""
    return time.time_ns()


class Timings:
    def __init__(self):
        self.spans = []
        self.counters = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Records the block as a span; yields its record, to which the
        block may add attributes."""
        rec = {"name": name, "id": next(_ids), "parent": _parent.get(),
               "job": _job.get(), **attrs}
        token = _parent.set(rec["id"])
        rec["start_ns"] = start = now_ns()
        try:
            yield rec
        finally:
            rec["end_ns"] = end = now_ns()
            rec["seconds"] = (end - start) * 1e-9
            _parent.reset(token)
            self.spans.append(rec)
            process = _process
            if process is not None and process is not self:
                process.spans.append(rec)

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def dump(self, path: str = "timings.txt"):
        with open(path, "a") as f:
            f.write(json.dumps(
                {"spans": self.spans, "counters": self.counters}
            ) + "\n")

    def total(self, name: str) -> float:
        return sum(s["seconds"] for s in self.spans if s["name"] == name)


def enable() -> Timings:
    """Turns the process tracer on, with a new record; returns it."""
    global _process, _recorded
    _process = _recorded = Timings()
    return _process


def disable() -> Timings | None:
    """Turns the process tracer off; returns what it recorded."""
    global _process
    _process = None
    return _recorded


def recorded() -> Timings | None:
    """The process tracer's record since the last :func:`enable` (None
    if it was never on)."""
    return _recorded


def span(name: str, **attrs):
    """A span of the process tracer, yielding its record; while the
    tracer is off, one shared no-op that yields None."""
    process = _process
    if process is None:
        return _NOOP
    return process.span(name, **attrs)


@contextlib.contextmanager
def job(job_id: str | None):
    """Tags every span opened inside the block on this thread, in any
    :class:`Timings`, with ``job_id``."""
    token = _job.set(job_id)
    try:
        yield
    finally:
        _job.reset(token)


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on
    the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bootstraps_per_sec(gates: int, seconds: float) -> float:
    return gates / seconds if seconds > 0 else float("inf")
