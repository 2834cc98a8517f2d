"""The profiled slice: what the device did while the host ran one job.

The pattern of the program's ``tools/profile_gate.py``: ``torch.profiler``
on the card, here with the CUDA activity alone (a kernel, copy or set
is one event; the host's ops are not recorded, which keeps the cost per
launch low).  The busy time is the union of the device events'
intervals, so that work on two streams is not counted twice; the idle
share is one less busy time over the slice's wall time.  The slice's
breakdown gives the device operations that took most time and the idle
gaps, summed by the pair of operations they lie between: that pair
says what the host was launching while the device waited.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import torch

TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name.split(" ")[-1][:64] or "?"


def merge(intervals: list) -> list:
    """(start, end, name) intervals -> disjoint blocks
    [start, end, first name, name of the interval that ends last]."""
    blocks = []
    for s, e, name in sorted(intervals):
        if blocks and s <= blocks[-1][1]:
            if e > blocks[-1][1]:
                blocks[-1][1], blocks[-1][3] = e, name
        else:
            blocks.append([s, e, name, name])
    return blocks


def busy_seconds(intervals: list) -> float:
    """The length of the union of the intervals."""
    return sum(e - s for s, e, _, _ in merge(intervals))


def top(totals: dict) -> list:
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:TOP]


def breakdown(intervals: list) -> dict:
    """The device operations by summed time, and the gaps between
    busy blocks summed by the operations on either side."""
    ops = defaultdict(float)
    for s, e, name in intervals:
        ops[short_name(name)] += e - s
    gaps = defaultdict(float)
    blocks = merge(intervals)
    for prev, nxt in zip(blocks, blocks[1:]):
        gaps[f"{short_name(prev[3])} -> {short_name(nxt[2])}"] += \
            nxt[0] - prev[1]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _device_intervals(prof) -> list:
    """(start s, end s, name) of every device event of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        return [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9,
                 e.name())
                for e in results.events() if e.device_type() == cuda]
    return [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
            for e in prof.events() if e.device_type == cuda]


def profile(fn, device) -> dict | None:
    """``fn()`` under the profiler, ended by a device synchronize:
    {busy_s, wall_s, breakdown}, or None on a device the profiler does
    not trace (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    intervals = _device_intervals(prof)
    if not intervals:
        raise RuntimeError("the profiler recorded no device operation")
    return {"busy_s": busy_seconds(intervals), "wall_s": wall,
            "breakdown": breakdown(intervals)}
