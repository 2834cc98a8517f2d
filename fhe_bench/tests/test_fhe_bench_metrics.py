"""The metrics' arithmetic: the union idle share, the least time of a
bootstrap from shapes, and each reader on a record."""

import importlib.util

import pytest

from fhe_bench import harness, profiling, roofline

L2 = {"n": 500, "N": 1024, "k": 1, "l": 2, "ks_t": 8}
L3 = dict(L2, l=3)


def reader(name):
    path = harness.ROOT / "fhe_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_union_of_intervals():
    iv = [(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "c"),
          (3.5, 3.6, "d"), (6.0, 6.5, "a")]
    assert profiling.busy_seconds(iv) == pytest.approx(3.5)
    blocks = profiling.merge(iv)
    assert [b[:2] for b in blocks] == [[0.0, 2.0], [3.0, 4.0], [6.0, 6.5]]
    assert [b[2:] for b in blocks] == [["a", "b"], ["c", "c"], ["a", "a"]]


def test_breakdown_sums_ops_and_names_gaps():
    iv = [(0.0, 1.0, "void k1<4>(int*)"), (2.0, 2.5, "k2(int)"),
          (3.0, 4.0, "void k1<4>(int*)"), (5.0, 5.5, "k2(int)")]
    bd = profiling.breakdown(iv)
    assert bd["device_ops"] == [["k1", 2.0], ["k2", 1.0]]
    assert bd["idle_gaps"] == [["k1 -> k2", 2.0], ["k2 -> k1", 0.5]]
    assert profiling.short_name("void ns::f<1, (T)2>(float*, int)") == "ns::f"
    assert profiling.short_name(
        "void (anonymous namespace)::ext_kernel<4>(int const*)") == \
        "ext_kernel"
    assert profiling.short_name(
        "void at::native::(anonymous namespace)::fill<int>(int)") == \
        "at::native::fill"


def test_idle_share_reader():
    record = {"slice": {"busy_s": 0.3, "wall_s": 0.5}}
    for name in ("device_idle_share.batch", "device_idle_share.interactive"):
        assert reader(name)(record) == pytest.approx(40.0)
        assert reader(name)({"slice": None}) is None


@pytest.mark.parametrize("params,us", [(L2, 16.95), (L3, 25.4)])
def test_least_time_of_a_bootstrap(params, us):
    ops = roofline.ops_per_bootstrap(params)
    assert ops / roofline.H100["int8_ops_per_s"] * 1e6 == \
        pytest.approx(us, rel=2e-3)
    # at waves of 1024 the keys' bytes bound far less
    assert roofline.least_seconds(params, 1024, 1024) == \
        pytest.approx(1024 * ops / roofline.H100["int8_ops_per_s"])
    assert roofline.bytes_per_wave(params, 1024) / 3.35e12 < \
        2e-3 * 1024 * us * 1e-6


def test_product_of_a_step_at_b1024_is_68_7_gop():
    step = roofline.ops_per_bootstrap(L2) / L2["n"] * 1024
    assert step == pytest.approx(68.7e9, rel=1e-3)


def test_roofline_reader():
    record = {"params": L2, "lanes": 1024,
              "slice": {"boots": 128 * 1024, "busy_s": 4.0}}
    least = 128 * 1024 * roofline.ops_per_bootstrap(L2) / 1979e12
    assert reader("boot_roofline_share.batch")(record) == \
        pytest.approx(100 * least / 4.0)
    assert reader("boot_roofline_share.batch")(
        dict(record, slice=None)) is None


def jobs(*seconds, lanes=1024, **extra):
    return [{"seconds": s, "lanes": lanes, "boots": 128 * lanes,
             "launches": 1000, **extra} for s in seconds]


def test_lanes_per_s_is_all_work_over_all_time():
    record = {"jobs": jobs(6.0, 7.0, 20.0), "window_s": 33.5}
    assert reader("lanes_per_s")(record) == pytest.approx(3 * 1024 / 33.5)


def test_answer_latency_is_the_mean_over_all_jobs():
    record = {"jobs": jobs(4.0, 4.5, 9.5, lanes=1)}
    assert reader("answer_latency_s")(record) == pytest.approx(6.0)
    assert reader("answer_latency_s")(
        {"jobs": jobs(4.0, lanes=1) + [{"error": "x"}]}) is None


def test_counter_readers():
    record = {"jobs": jobs(1.0, 2.0, lanes=4, compute_s=0.75)}
    assert reader("boots_per_lane.batch")(record) == 128
    assert reader("kernel_launches_per_job.interactive")(record) == 1000
    assert reader("protocol_s_per_job.interactive")(record) == \
        pytest.approx(0.75)
    assert reader("protocol_s_per_job.interactive")(
        {"jobs": jobs(1.0)}) is None
    assert reader("setup_s")({"setup_s": 12.5}) == 12.5
