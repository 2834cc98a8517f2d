"""The span metrics: the attribution of idle and device time to the
program's spans (``fhe_bench/spans.py``), each of the seven readers on
synthetic records and on a record without spans, and the probe that
runs a cell with the tracer on, at TEST_TINY on the CPU."""

import importlib.util

import pytest

from fhe_bench import harness, roofline, span_probe, spans
from fhe_bench.tests import tiny

L2 = {"n": 500, "N": 1024, "k": 1, "l": 2, "ks_t": 8}

NEW = ("dispatch_us_per_launch.batch", "dispatch_us_per_launch.interactive",
       "bootstrapped_per_lane.batch", "plan_s_per_job.batch",
       "rotation_roofline_share.batch", "idle_in_dispatch_share.batch",
       "idle_in_dispatch_share.interactive")


def reader(name):
    path = harness.ROOT / "fhe_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "span_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def span(sid, name, start, end, parent=None, **attrs):
    return {"id": sid, "name": name, "start_ns": start, "end_ns": end,
            "seconds": (end - start) * 1e-9, "parent": parent, "job": "j",
            **attrs}


#: a job: compute_chain over two waves, each bootstrap > blind_rotate,
#: then a keyswitch; the Output's answer_wait around it on its thread
JOB = [
    span(1, "compute_chain", 100, 1000),
    span(2, "evaluator.plan", 110, 150, parent=1, lanes=4, steps=2),
    span(3, "bootstrap", 200, 500, parent=1, lanes=4),
    span(4, "blind_rotate", 210, 480, parent=3, lanes=4, steps=10,
         launches=20),
    span(5, "keyswitch", 500, 550, parent=1, lanes=4),
    span(6, "bootstrap", 600, 900, parent=1, lanes=4),
    span(7, "blind_rotate", 610, 890, parent=6, lanes=4, steps=10,
         launches=20),
    span(8, "evaluator.finish", 950, 990, parent=1, lanes=4),
    span(9, "answer_wait", 50, 1100),
]


def test_the_timeline_takes_the_innermost_span():
    seg = spans.timeline(JOB)
    assert seg[0] == (50, 100, "answer_wait")
    assert (110, 150, "evaluator.plan") in seg
    assert (210, 480, "blind_rotate") in seg
    assert (200, 210, "bootstrap") in seg
    assert (150, 200, "compute_chain") in seg
    assert seg[-1] == (1000, 1100, "answer_wait")
    for (a, b, _), (c, _, _) in zip(seg, seg[1:]):
        assert a < b <= c
    assert spans.span_at(seg, 300) == "blind_rotate"
    assert spans.span_at(seg, 20) == spans.UNSPANNED
    assert spans.span_at(seg, 1100) == spans.UNSPANNED


def test_two_threads_as_deep_take_the_later_span():
    seg = spans.timeline([span(1, "a", 0, 100), span(2, "b", 50, 150)])
    assert seg == [(0, 50, "a"), (50, 150, "b")]


def test_idle_gaps_cover_what_no_operation_ran_in():
    ops = [(10, 20, "k", 1), (15, 30, "k", 2), (50, 60, "k", 3)]
    assert spans.idle_gaps(ops, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert spans.idle_gaps(ops, 10, 60) == [(30, 50)]
    assert spans.idle_gaps([], 0, 5) == [(0, 5)]


def test_gaps_split_over_spans_by_overlap():
    seg = spans.timeline(JOB)
    out = spans.split_over(seg, [(0, 120), (470, 520), (1050, 1200)])
    assert out == {spans.UNSPANNED: 50 + 100, "answer_wait": 50 + 50,
                   "compute_chain": 10, "evaluator.plan": 10,
                   "blind_rotate": 10, "bootstrap": 20, "keyswitch": 20}
    assert sum(out.values()) == 120 + 50 + 150


def test_device_time_goes_to_the_span_of_its_launch():
    seg = spans.timeline(JOB)
    ops = [(300, 400, "void rot_diff_decompose_kernel<8>(int)", 1),
           (500, 700, "void external_product_wgmma_kernel<64>()", 2),
           (950, 960, "Memcpy DtoH (Device -> Pinned)", 3),
           (960, 970, "void at::native::copy()", 4)]
    launches = {1: 220, 2: 470, 3: 120}
    out, how = spans.device_by_span(ops, launches, seg,
                                    ("rot_diff_decompose",
                                     "external_product"))
    assert how == "correlation"
    # the product ran after its span closed: its launch decides
    assert out == {"blind_rotate": 300, "evaluator.plan": 10,
                   spans.UNMATCHED: 10}
    out, how = spans.device_by_span(ops, {}, seg, ("rot_diff_decompose",
                                                   "external_product"))
    assert how == "kernel_names"
    assert out == {"blind_rotate": 300, spans.UNSPANNED: 20}


def test_slice_keys():
    ops = [(220, 470, "void rot_diff_decompose_kernel<8>(int)", 1),
           (620, 880, "void external_product_kernel<4>(int)", 2)]
    keys = spans.slice_keys(JOB, ops, {1: 215, 2: 615}, 100, 1000,
                            ("rot_diff_decompose", "external_product"))
    assert keys["idle_s"] == pytest.approx((900 - 250 - 260) * 1e-9)
    assert sum(keys["idle_s_by_span"].values()) == \
        pytest.approx(keys["idle_s"])
    assert keys["idle_s_by_span"]["blind_rotate"] == \
        pytest.approx((10 + 10 + 10 + 10) * 1e-9)
    assert keys["device_s_by_span"] == {"blind_rotate": pytest.approx(
        510e-9)}
    assert keys["bootstrapped"] == 8 and keys["attribution"] == \
        "correlation"
    assert [k for k, _ in keys["idle_by_span"]][0] == "compute_chain"


def _record(window_spans, sliced=None, jobs=2, lanes=4):
    return {"spans": window_spans, "slice": sliced, "lanes": lanes,
            "params": L2, "window_s": 1.0,
            "jobs": [{"seconds": 1.0, "lanes": lanes, "boots": 8}] * jobs}


def test_dispatch_us_per_launch():
    record = _record(JOB + JOB)
    want = 1e6 * 2 * (270 + 280) * 1e-9 / 80
    for name in ("dispatch_us_per_launch.batch",
                 "dispatch_us_per_launch.interactive"):
        assert reader(name)(record) == pytest.approx(want)
        no_launch = [dict(s, launches=0) for s in JOB]
        assert reader(name)(_record(no_launch)) is None


def test_bootstrapped_per_lane_and_plan_seconds():
    record = _record(JOB + JOB)
    assert reader("bootstrapped_per_lane.batch")(record) == 16 / 8
    assert reader("boots_per_lane.batch")(record) == 16 / 8
    assert reader("plan_s_per_job.batch")(record) == \
        pytest.approx(2 * (40 + 40) * 1e-9 / 2)


def test_rotation_roofline_share():
    sliced = {"bootstrapped": 128 * 1024, "busy_s": 4.0,
              "device_s_by_span": {"blind_rotate": 3.5, "keyswitch": 0.1}}
    record = dict(_record(JOB, sliced, lanes=1024))
    least = 128 * 1024 * roofline.ops_per_bootstrap(L2) / 1979e12
    assert reader("rotation_roofline_share.batch")(record) == \
        pytest.approx(100 * least / 3.5)
    sliced["device_s_by_span"] = {"keyswitch": 0.1}
    assert reader("rotation_roofline_share.batch")(record) is None


def test_idle_in_dispatch_share():
    sliced = {"idle_s": 2.0, "idle_s_by_span": {"blind_rotate": 1.5,
                                                "keyswitch": 0.5}}
    for name in ("idle_in_dispatch_share.batch",
                 "idle_in_dispatch_share.interactive"):
        assert reader(name)(_record(JOB, sliced)) == pytest.approx(75.0)
        assert reader(name)(_record(JOB, {"idle_s": 0.0,
                                          "idle_s_by_span": {}})) is None


@pytest.mark.parametrize("name", NEW)
def test_a_record_without_spans_reads_nothing(name):
    """The record of a run that records no span (the benchmark's run,
    a program without spans): every reader returns None, none raises."""
    record = {"entry": "evaluator", "setup_s": 1.0, "phases": {},
              "window_s": 1.0, "lanes": 4, "params": L2,
              "jobs": [{"seconds": 1.0, "lanes": 4, "boots": 8,
                        "launches": 0}],
              "slice": {"busy_s": 0.5, "wall_s": 1.0, "boots": 8,
                        "breakdown": {}}}
    assert reader(name)(record) is None
    assert reader(name)(dict(record, slice=None)) is None


def test_the_probe_on_the_cpu(tmp_path):
    """The probe at TEST_TINY: every job judged right, the windows off
    and on in turns, the bootstraps its spans count equal to the
    evaluator's ``gate_count``; nothing profiled, no launch counted."""
    root = tiny.make_root(tmp_path)
    line = span_probe.run(harness.Bench(root), tiny.BATCH, 2**31 + 9, 0.0,
                          3, "cpu")
    assert line["correct"] and line["wrong_lanes"] == 0
    assert [w["traced"] for w in line["windows"]] == [False, True, True]
    assert line["metrics"]["bootstrapped_per_lane.batch"] == \
        line["accepted_metrics"]["boots_per_lane.batch"] == 128
    assert line["metrics"]["plan_s_per_job.batch"] > 0
    assert "dispatch_us_per_launch.batch" not in line["metrics"]
    assert "slice" not in line
    assert line["span_cost_ns"]["off"] > 0
    line = span_probe.run(harness.Bench(root), tiny.INTERACTIVE,
                          2**31 + 9, 0.0, 2, "cpu")
    assert line["correct"]
    assert line["on_against_off"]["metric"] == "answer_latency_s"
