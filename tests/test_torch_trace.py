"""The port's tracer (``ieache_tpu_torch.utils.trace``) and the spans
inside the port: the span record, the process tracer off and on, the
job id the Output and the Cloud share, and the counts the ``bootstrap``
and ``blind_rotate`` spans carry, all on the CPU at TEST_TINY.  The
clock test, a span around a kernel's device interval, is in
``tests/test_torch_gpu.py``."""

import threading

import pytest
import torch

from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap as boot
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.lwe import keygen_device
from ieache_tpu_torch.mp import nodes, scheduler, sim
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.utils import prng, trace

CPU = torch.device("cpu")

SPAN_KEYS = {"name", "start_ns", "end_ns", "seconds", "id", "parent", "job"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    """The process tracer, on for the test and off after it."""
    record = trace.enable()
    try:
        yield record
    finally:
        trace.disable()


@pytest.fixture(scope="module")
def tiny_keys():
    pair = keygen_device.generate_gate_keypair_device(P.TEST_TINY, CPU)
    return pair, boot.pack_cloud_key(pair.main.cloud, CPU)


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


# -- the span record ---------------------------------------------------

def test_spans_nest_with_their_parent_on_one_thread():
    t = trace.Timings()
    with t.span("outer", k=1) as outer:
        with t.span("inner") as inner:
            with t.span("leaf"):
                pass
        with t.span("second"):
            pass
    spans = {s["name"]: s for s in t.spans}
    assert [s["name"] for s in t.spans] == ["leaf", "inner", "second",
                                            "outer"]
    assert spans["outer"]["parent"] is None
    assert spans["inner"]["parent"] == outer["id"]
    assert spans["leaf"]["parent"] == inner["id"]
    assert spans["second"]["parent"] == outer["id"]
    assert len({s["id"] for s in t.spans}) == 4
    for s in t.spans:
        assert SPAN_KEYS <= set(s)
        assert s["start_ns"] <= s["end_ns"]
        assert s["seconds"] == pytest.approx(
            (s["end_ns"] - s["start_ns"]) * 1e-9)
        assert s["job"] is None
    assert spans["outer"]["k"] == 1
    o, i = spans["outer"], spans["inner"]
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]
    # after the block, a new span has no parent again
    with t.span("after"):
        pass
    assert t.spans[-1]["parent"] is None


def test_a_span_on_another_thread_has_no_parent_there():
    t = trace.Timings()
    with t.span("main"):
        def other():
            with t.span("other"):
                pass
        th = threading.Thread(target=other)
        th.start()
        th.join(10)
        assert not th.is_alive()
    (other,) = _by_name(t.spans, "other")
    assert other["parent"] is None


def test_a_span_is_recorded_when_its_block_raises():
    t = trace.Timings()
    with pytest.raises(ValueError):
        with t.span("fails"):
            raise ValueError("x")
    (s,) = t.spans
    assert s["name"] == "fails" and s["start_ns"] <= s["end_ns"]
    with t.span("next"):
        pass
    assert t.spans[-1]["parent"] is None


def test_the_clock_is_the_epoch_clock():
    import time

    before = time.time_ns()
    t = trace.Timings()
    with t.span("x"):
        pass
    after = time.time_ns()
    assert before <= t.spans[0]["start_ns"] <= t.spans[0]["end_ns"] <= after


def test_the_job_tags_spans_opened_inside_it():
    t = trace.Timings()
    with trace.job("abc"):
        with t.span("in"):
            with trace.job("def"):
                with t.span("nested"):
                    pass
            with t.span("in2"):
                pass
    with t.span("out"):
        pass
    jobs = {s["name"]: s["job"] for s in t.spans}
    assert jobs == {"in": "abc", "nested": "def", "in2": "abc", "out": None}


# -- the process tracer ------------------------------------------------

def test_with_the_tracer_off_a_span_is_one_shared_noop():
    trace.disable()
    before = trace.recorded()
    n = len(before.spans) if before is not None else 0
    a, b = trace.span("a", lanes=3), trace.span("b")
    assert a is b
    with a as rec:
        assert rec is None
    with trace.span("c") as rec:
        assert rec is None
    after = trace.recorded()
    assert after is before
    assert (len(after.spans) if after is not None else 0) == n


def test_the_tracer_records_its_spans_and_the_nodes(tracer):
    node = trace.Timings()
    with node.span("compute_chain") as chain:
        with trace.span("evaluator.plan", lanes=4) as plan:
            assert plan is not None
    assert trace.recorded() is tracer
    names = [s["name"] for s in tracer.spans]
    assert names == ["evaluator.plan", "compute_chain"]
    assert [s["name"] for s in node.spans] == ["compute_chain"]
    assert tracer.spans[0]["parent"] == chain["id"]
    assert tracer.spans[0]["lanes"] == 4
    assert tracer.spans[1] is node.spans[0]
    assert trace.disable() is tracer
    assert trace.span("x") is trace.span("y")
    with node.span("later"):
        pass
    assert len(tracer.spans) == 2          # off: the node's span alone
    assert trace.recorded() is tracer


def test_enable_starts_a_new_record(tracer):
    with trace.span("one"):
        pass
    again = trace.enable()
    assert again is not tracer and again.spans == []
    assert trace.recorded() is again


# -- the job id --------------------------------------------------------

def test_the_job_id_is_derived_from_the_pmk():
    a, b = bytes(range(32)), bytes(range(1, 33))
    assert nodes.job_id(a) == nodes.job_id(bytes(a))
    assert len(nodes.job_id(a)) == 16
    int(nodes.job_id(a), 16)
    assert nodes.job_id(a) != nodes.job_id(b)
    assert a.hex()[:16] not in nodes.job_id(a)


def test_the_output_and_the_cloud_share_each_jobs_id(tracer):
    flows = [sim.run_full_flow("AB+C-", {"A": [30], "B": [12], "C": [50]},
                               width=8, params=P.TEST_TINY, device=CPU)
             for _ in range(2)]
    ids = []
    for res in flows:
        assert res.values == [-8]
        spans = res.output_spans + res.cloud_spans
        assert [s["name"] for s in res.output_spans] == [
            "user_input_processing", "answer_wait", "verify"]
        (job,) = {s["job"] for s in spans}
        assert job is not None
        ids.append(job)
        for s in spans:
            assert SPAN_KEYS <= set(s) and s["start_ns"] <= s["end_ns"]
        # the spans inside the Cloud's evaluation carry the job too, and
        # hang under its compute_chain span
        node_ids = {s["id"] for s in spans}
        inner = [s for s in tracer.spans if s["job"] == job
                 and s["id"] not in node_ids]
        names = {s["name"] for s in inner}
        assert {"evaluator.plan", "bootstrap", "blind_rotate", "keyswitch",
                "evaluator.finish"} <= names
        (chain,) = _by_name(res.cloud_spans, "compute_chain")
        by_id = {s["id"]: s for s in tracer.spans}
        for s in inner:
            top = s
            while top["parent"] is not None:
                top = by_id[top["parent"]]
            assert top is chain
        for s in _by_name(inner, "blind_rotate"):
            assert by_id[s["parent"]]["name"] == "bootstrap"
    assert ids[0] != ids[1]


# -- counts where the work happens --------------------------------------

def _operands(pair, width, letters):
    key = prng.key_from_seed_words([0x7EACE])
    values = ([30, -2], [12, 5], [-7, 6])
    return [ev.encrypt_operand(pair.main, pair.nbit, values[i], width,
                               prng.derive(key, i), CPU)
            for i in range(len(letters))]


@pytest.mark.parametrize("postfix,adder,env", [
    ("AB+C-", "ripple", {}),
    ("AB+C-", "ripple", {"IEACHE_ADDER": "ref5"}),
    ("AB+C-", "kogge_stone", {}),
    ("AB*", "ripple", {}),
], ids=["maj2", "ref5", "kogge_stone", "multiply"])
def test_bootstrapped_lanes_equal_the_gate_count(tiny_keys, tracer,
                                                 monkeypatch, postfix,
                                                 adder, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pair, dck = tiny_keys
    evaluator = ev.CloudEvaluator(dck, pair.nbit, adder=adder)
    letters, _, steps = scheduler.plan_postfix(postfix)
    steps = [(scheduler.OPCODES[c], lhs, rhs) for c, lhs, rhs in steps]
    operands = _operands(pair, 8, letters)
    evaluator.compute_steps(steps, operands)
    boots = _by_name(tracer.spans, "bootstrap")
    assert sum(s["lanes"] for s in boots) == evaluator.gate_count > 0
    (plan,) = _by_name(tracer.spans, "evaluator.plan")
    (finish,) = _by_name(tracer.spans, "evaluator.finish")
    assert plan["lanes"] == finish["lanes"] == 2
    assert plan["steps"] == len(steps)
    assert len(_by_name(tracer.spans, "keyswitch")) == len(boots)


def test_mux_counts_its_two_bootstraps(tiny_keys, tracer):
    from ieache_tpu_torch.boot import gates

    pair, dck = tiny_keys
    n = P.TEST_TINY.n
    c = gates.CONSTANT(torch.tensor([0, 1, 1]), n)
    gates.MUX(c, c, c, dck)
    assert [s["lanes"] for s in _by_name(tracer.spans, "bootstrap")] == \
        [3, 3]
    assert [s["lanes"] for s in _by_name(tracer.spans, "keyswitch")] == [3]


class _Counting:
    """Stands in for a kernel wrapper: counts a launch a call, and runs
    the wrapper (its plain twin on CPU tensors)."""

    def __init__(self, wrapper):
        self.wrapper, self.launches = wrapper, 0

    def __call__(self, *args, **kwargs):
        self.launches += 1
        return self.wrapper(*args, **kwargs)


@pytest.mark.parametrize("mode,per_step,per_rotation", [
    ("split", 2, 0), ("fused2", 1, 0), ("overlap", 1, 0), ("scan", 0, 1),
    ("tr", 2, 0)])
def test_each_rotation_span_counts_the_wrappers_launches(
        tiny_keys, tracer, monkeypatch, mode, per_step, per_rotation):
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
    for name in kernels.MODE_KERNELS[mode]:
        monkeypatch.setattr(kernels, name,
                            _Counting(getattr(kernels, name)))
    _, dck = tiny_keys
    p = P.TEST_TINY
    lwe = torch.randint(-2**31, 2**31, (3, p.n + 1), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(5)
                        ).to(torch.int32)
    before = sum(kernels.launch_counts().values())
    plain = boot.bootstrap(lwe, dck, plain=True)
    assert sum(kernels.launch_counts().values()) == before
    out = boot.bootstrap(lwe, dck)
    out2 = boot.bootstrap(lwe[:2], dck)
    delta = sum(kernels.launch_counts().values()) - before
    assert torch.equal(out, plain) and torch.equal(out2, plain[:2])
    spans = _by_name(tracer.spans, "blind_rotate")
    assert [s["lanes"] for s in spans] == [3, 2]
    assert all(s["mode"] == mode and s["steps"] == p.n for s in spans)
    assert [s["launches"] for s in spans] == \
        [per_step * p.n + per_rotation] * 2
    assert sum(s["launches"] for s in spans) == delta


def test_the_rotation_span_reads_no_launch_on_the_plain_twins(tiny_keys,
                                                              tracer):
    _, dck = tiny_keys
    p = P.TEST_TINY
    lwe = torch.zeros((2, p.n + 1), dtype=torch.int32)
    before = kernels.launch_counts()
    boot.bootstrap(lwe, dck)
    assert kernels.launch_counts() == before
    (span,) = _by_name(tracer.spans, "blind_rotate")
    assert span["launches"] == 0 and span["mode"] == "split"
    # the plain path has no dispatch loop, hence no rotation span
    boot.bootstrap(lwe, dck, plain=True)
    assert len(_by_name(tracer.spans, "blind_rotate")) == 1
    assert len(_by_name(tracer.spans, "bootstrap")) == 2
