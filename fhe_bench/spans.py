"""What the program's own spans say about a run.

The program records its spans (``ieache_tpu_torch.utils.trace``: name,
``start_ns``, ``end_ns``, ``id``, ``parent``, ``job`` and the counts
they are for) on the epoch clock that ``torch.profiler`` gives device
operations, so a span and a device interval compare directly.  This
module reads them: the window's spans, for the dispatch, bootstrap and
planning metrics, and the profiled job's device trace attributed to
spans:

* idle time: each gap in which no operation ran on the device (and the
  stretches before the first and after the last) is split over the
  innermost span open during it, by overlap; the innermost of several
  open spans is the deepest (its chain of parents the longest), the
  later started of two as deep (spans of two threads);
* device time: each device operation is credited to the innermost span
  open when the host launched it, found by the profiler's correlation of
  the launch (the runtime's ``cudaLaunchKernel``, ``cudaMemcpyAsync``,
  ...) with the operation; where the trace carries no such launch, the
  operations whose kernel is one of the step mode's wrappers are
  credited to ``blind_rotate`` and the rest to no span.

A record a reader gets may lack every key this module reads (a run of
a program that records no span): the functions then return None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from fhe_bench import profiling

#: where time under no span goes
UNSPANNED = "(no span)"
#: device time whose launch the trace does not show
UNMATCHED = "(launch not traced)"


def named(spans, name: str) -> list:
    """The spans called ``name``."""
    return [s for s in spans or () if s["name"] == name]


def between(spans, start_ns: int, end_ns: int) -> list:
    """The spans that start inside [start_ns, end_ns]."""
    return [s for s in spans if start_ns <= s["start_ns"] <= end_ns]


def _depths(spans) -> dict:
    """{id: the length of its chain of parents among ``spans``}."""
    parent = {s["id"]: s["parent"] for s in spans}
    depth = {}
    for sid in parent:
        chain, d = sid, 0
        while parent.get(chain) is not None and parent[chain] in parent:
            chain, d = parent[chain], d + 1
        depth[sid] = d
    return depth


def timeline(spans) -> list:
    """Disjoint (start_ns, end_ns, name) segments, each under one
    innermost span, in time order; stretches under no span left out."""
    depth = _depths(spans)
    cuts = sorted({t for s in spans for t in (s["start_ns"], s["end_ns"])})
    by_start = sorted(spans, key=lambda s: s["start_ns"])
    segments, open_, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(by_start) and by_start[k]["start_ns"] <= a:
            open_.append(by_start[k])
            k += 1
        open_ = [s for s in open_ if s["end_ns"] > a]
        if not open_:
            continue
        top = max(open_, key=lambda s: (depth[s["id"]], s["start_ns"]))
        if segments and segments[-1][2] == top["name"] and \
                segments[-1][1] == a:
            segments[-1][1] = b
        else:
            segments.append([a, b, top["name"]])
    return [tuple(s) for s in segments]


def split_over(segments: list, intervals: list) -> dict:
    """{span name: ns} of the (start_ns, end_ns) ``intervals`` under
    each name of ``segments``; what lies under none, under
    :data:`UNSPANNED`."""
    out = defaultdict(int)
    starts = [s[0] for s in segments]
    for a, b in intervals:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segments) and segments[i][0] < b:
            s0, s1, name = segments[i]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                out[name] += overlap
                covered += overlap
            i += 1
        if b - a > covered:
            out[UNSPANNED] += b - a - covered
    return dict(out)


def span_at(segments: list, t: int, starts=None) -> str:
    """The innermost span open at ``t``, or :data:`UNSPANNED`;
    ``starts``, where given, the segments' starts."""
    if starts is None:
        starts = [s[0] for s in segments]
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t < segments[i][1]:
        return segments[i][2]
    return UNSPANNED


def idle_gaps(ops: list, start_ns: int, end_ns: int) -> list:
    """The (start_ns, end_ns) stretches of [start_ns, end_ns] in which
    none of the device operations ``ops`` ((start_ns, end_ns, ...))
    ran."""
    gaps, t = [], start_ns
    for s, e in sorted((o[0], o[1]) for o in ops):
        if s > t:
            gaps.append((t, min(s, end_ns)))
        t = max(t, e)
    if end_ns > t:
        gaps.append((t, end_ns))
    return [g for g in gaps if g[1] > g[0]]


def device_by_span(ops: list, launches: dict, segments: list,
                   rotation_kernels) -> tuple:
    """({span name: device ns}, how): each operation (start_ns, end_ns,
    name, correlation) credited to the span in which the host launched
    it, ``launches`` {correlation: launch ns} (``how`` "correlation");
    where the trace holds no launch of any operation, credited by
    kernel name (``how`` "kernel_names"): an operation whose kernel
    starts with one of ``rotation_kernels`` to ``blind_rotate``."""
    out = defaultdict(int)
    if any(o[3] in launches for o in ops):
        starts = [s[0] for s in segments]
        for s, e, _, corr in ops:
            t = launches.get(corr)
            out[UNMATCHED if t is None
                else span_at(segments, t, starts)] += e - s
        return dict(out), "correlation"
    for s, e, name, _ in ops:
        kernel = profiling.short_name(name)
        rotation = any(kernel.startswith(k) for k in rotation_kernels)
        out["blind_rotate" if rotation else UNSPANNED] += e - s
    return dict(out), "kernel_names"


def slice_keys(spans: list, ops: list, launches: dict, start_ns: int,
               end_ns: int, rotation_kernels) -> dict:
    """The keys a profiled job gains from the spans recorded during it:
    ``idle_s`` (its idle seconds), ``idle_s_by_span``,
    ``device_s_by_span``, ``attribution`` (how device time was
    credited), ``bootstrapped`` (Σ ``lanes`` of its ``bootstrap``
    spans) and ``idle_by_span`` (the top ten of ``idle_s_by_span``, as
    the breakdown lists them)."""
    segments = timeline(spans)
    gaps = idle_gaps(ops, start_ns, end_ns)
    idle = {k: v * 1e-9 for k, v in split_over(segments, gaps).items()}
    device, how = device_by_span(ops, launches, segments, rotation_kernels)
    return {"idle_s": sum(b - a for a, b in gaps) * 1e-9,
            "idle_s_by_span": idle,
            "device_s_by_span": {k: v * 1e-9 for k, v in device.items()},
            "attribution": how,
            "bootstrapped": sum(s["lanes"]
                                for s in named(spans, "bootstrap")),
            "idle_by_span": profiling.top(idle)}


# -- the readers' arithmetic, shared by a metric's cells ---------------------

def dispatch_us_per_launch(record):
    """Σ seconds of the window's ``blind_rotate`` spans over Σ their
    ``launches``, in µs; None without them."""
    rot = named(record.get("spans"), "blind_rotate")
    launches = sum(s.get("launches", 0) for s in rot)
    if not launches:
        return None
    return 1e6 * sum(s["seconds"] for s in rot) / launches


def idle_in_dispatch_share(record):
    """Percent of the profiled job's idle time under ``blind_rotate``
    spans; None without a profiled job whose idle time was split."""
    sliced = record.get("slice") or {}
    if not sliced.get("idle_s") or "idle_s_by_span" not in sliced:
        return None
    return 100.0 * sliced["idle_s_by_span"].get("blind_rotate", 0.0) \
        / sliced["idle_s"]
