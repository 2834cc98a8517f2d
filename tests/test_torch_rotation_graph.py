"""The blind rotation as one CUDA graph (``ops/blind_rotate.py``): the
cache's policy (a key's first rotation runs the loop, its second
captures, later ones replay; what is evicted and what is not), the
launch counts it keeps, the copies it returns and where it never
engages, on the CPU at TEST_TINY.

No graph is captured on the CPU: ``_capture`` is replaced by a stand-in
whose "graph" replays the loop's plain twins into the output it
captured (counting no launch), and ``_graph_stream`` by one that names
a stream, so that the kernel path's cache runs as it does on the card.
The card's own graph is held to the loop and to the plain path in
``tests/test_torch_gpu.py``."""

import threading

import numpy as np
import pytest
import torch

from ieache_tpu_torch import params as P
from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.utils import trace

p = P.TEST_TINY

#: the modes whose loop the graph replays, the steps' wrappers of each
LOOPED = {m: kernels.MODE_KERNELS[m] for m in br.GRAPHED_MODES}


class _FakeGraph:
    """A captured rotation on the CPU: ``replay`` runs the captured loop
    again into the output it captured, its launches uncounted, as a
    CUDA graph replays kernels without calling a wrapper."""

    def __init__(self, run, acc, bara, out):
        self.run, self.acc, self.bara, self.out = run, acc, bara, out

    def replay(self):
        counts = kernels.launch_counts()
        self.out.copy_(self.run(self.acc, self.bara))
        for name, n in counts.items():
            getattr(kernels, name).launches = n


class _Counting:
    """A wrapper that counts its calls as the CUDA wrappers count their
    launches."""

    def __init__(self, wrapper):
        self.wrapper, self.launches = wrapper, 0

    def __call__(self, *args, **kwargs):
        self.launches += 1
        return self.wrapper(*args, **kwargs)


@pytest.fixture
def graphs(monkeypatch):
    """The kernel path's graph cache on CPU tensors, empty, with the
    stand-in capture; yields {"captures": [...], "stream": handle}, the
    runs captured and the stream the rotations see (set it to change
    it)."""
    state = {"captures": [], "stream": 11}

    def capture(run, acc, bara):
        out = run(acc, bara)
        state["captures"].append(run)
        return _FakeGraph(run, acc, bara, out), out

    monkeypatch.setattr(br, "_capture", capture)
    monkeypatch.setattr(
        br, "_graph_stream",
        lambda acc0, bk, mode, route: state["stream"]
        if mode in br.GRAPHED_MODES and route in ("auto", "1") else None)
    monkeypatch.setattr(br, "_graphs", type(br._graphs)())
    monkeypatch.setattr(br, "_seen", type(br._seen)())
    br.reset_graph_counts()
    yield state
    br.reset_graph_counts()


def _case(seed, b, steps=None):
    rng = np.random.RandomState(seed)
    steps = p.n if steps is None else steps

    def rand(shape, lo, hi):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int32))

    acc0 = rand((b, p.k + 1, p.N), -2**31, 2**31)
    bara = rand((b, steps), 0, 2 * p.N)
    bk = rand((steps, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31)
    return acc0, bara, bk


def _rotate(monkeypatch, mode, acc0, bara, bk):
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
    return br.blind_rotate(acc0, bara, bk, p)


# -- the loop first, then capture once, replay after -----------------------

@pytest.mark.parametrize("mode", br.GRAPHED_MODES)
@pytest.mark.parametrize("b", [1, 3])
def test_a_key_runs_the_loop_then_captures_then_replays(
        graphs, monkeypatch, mode, b):
    acc0, bara, bk = _case(1, b)
    record = trace.enable()
    try:
        outs = [_rotate(monkeypatch, mode, acc0, bara, bk) for _ in range(4)]
    finally:
        trace.disable()
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    assert all(torch.equal(o, want) for o in outs)
    assert len(graphs["captures"]) == 1
    spans = [s for s in record.spans if s["name"] == "blind_rotate"]
    assert [s["graph"] for s in spans] == ["eager", "capture", "replay",
                                           "replay"]
    assert br.graph_counts() == {"captures": 1, "replays": 2, "eager": 1,
                                 "evictions": 0}


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", ["split", "tr", "fused2"])
def test_a_result_is_a_copy_that_a_later_replay_leaves_alone(
        graphs, monkeypatch, mode, b):
    """At B=1 the result in the caller's layout has the graph output's
    layout: it must still be a copy, not the memory the next replay
    writes."""
    bk = _case(2, b)[2]
    cases = [(*_case(2 + i, b)[:2], bk) for i in range(3)]   # one key
    gots = [_rotate(monkeypatch, mode, *c) for c in cases]
    assert len(graphs["captures"]) == 1
    for got, c in zip(gots, cases):
        assert torch.equal(got, br.blind_rotate(*c, p, plain=True))
    (entry,) = br._graphs.values()
    for got in gots[1:]:                               # capture, replay
        assert got.is_contiguous()
        assert got.untyped_storage().data_ptr() != \
            entry.out.untyped_storage().data_ptr()
    # the inputs are copied in: the caller's tensors are not the graph's
    assert entry.acc.data_ptr() != cases[2][0].data_ptr()
    assert entry.bara.data_ptr() != cases[2][1].data_ptr()


@pytest.mark.parametrize("mode", br.GRAPHED_MODES)
def test_launch_counts_move_by_the_loops_amounts(graphs, monkeypatch, mode):
    """A capture launches nothing (its counts are taken back); each
    rotation, the loop's, the one that captured and the replays, adds
    what the loop launches: a launch a wrapper a step.  The span reads
    the same."""
    for name in LOOPED[mode]:
        monkeypatch.setattr(kernels, name, _Counting(getattr(kernels, name)))
    acc0, bara, bk = _case(4, 2)
    record = trace.enable()
    try:
        for expect in (1, 2, 3, 4):
            _rotate(monkeypatch, mode, acc0, bara, bk)
            assert [getattr(kernels, n).launches for n in LOOPED[mode]] == \
                [expect * p.n] * len(LOOPED[mode])
    finally:
        trace.disable()
    spans = [s for s in record.spans if s["name"] == "blind_rotate"]
    assert [s["launches"] for s in spans] == [len(LOOPED[mode]) * p.n] * 4
    (entry,) = br._graphs.values()
    assert entry.launches == tuple((n, p.n) for n in LOOPED[mode])


# -- the key --------------------------------------------------------------

@pytest.mark.parametrize("change", ["bk", "lanes", "mode", "stream",
                                    "steps"])
def test_another_key_misses_and_the_first_still_replays(
        graphs, monkeypatch, change):
    acc0, bara, bk = _case(5, 3)
    mode = "split"
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    for _ in range(2):
        assert torch.equal(_rotate(monkeypatch, mode, acc0, bara, bk), want)
    other = {"acc0": acc0, "bara": bara, "bk": bk, "mode": mode}
    if change == "bk":
        other["bk"] = bk.clone()                       # same shape and values
    elif change == "lanes":
        other["acc0"], other["bara"] = acc0[:2], bara[:2]
    elif change == "mode":
        other["mode"] = "fused2"
    elif change == "steps":
        other["bara"], other["bk"] = bara[:, :4].contiguous(), bk[:4]
    else:
        graphs["stream"] = 12
    for _ in range(2):
        got = _rotate(monkeypatch, other["mode"], other["acc0"],
                      other["bara"], other["bk"])
        assert torch.equal(got, br.blind_rotate(
            other["acc0"], other["bara"], other["bk"], p, plain=True))
    assert len(graphs["captures"]) == 2 and len(br._graphs) == 2
    graphs["stream"] = 11
    assert torch.equal(_rotate(monkeypatch, mode, acc0, bara, bk), want)
    assert br.graph_counts() == {"captures": 2, "replays": 1, "eager": 2,
                                 "evictions": 0}


def test_overlap_and_overlap2_share_a_graph(graphs, monkeypatch):
    """The two modes call the one wrapper, so the key is theirs alike."""
    acc0, bara, bk = _case(12, 2)
    for mode in ("overlap", "overlap", "overlap2"):
        _rotate(monkeypatch, mode, acc0, bara, bk)
    assert len(br._graphs) == 1
    assert br.graph_counts() == {"captures": 1, "replays": 1, "eager": 1,
                                 "evictions": 0}


def test_the_key_holds_its_bk(graphs, monkeypatch):
    """The entry keeps ``bk`` alive, so no other tensor can take its
    address (part of the key) while the graph is cached."""
    acc0, bara, bk = _case(6, 2)
    for _ in range(2):
        _rotate(monkeypatch, "split", acc0, bara, bk)
    (entry,) = br._graphs.values()
    assert entry.bk is bk


# -- what the cache keeps --------------------------------------------------

@pytest.mark.parametrize("touch", [False, True])
def test_the_least_recently_used_graph_is_evicted_at_the_bound(
        graphs, monkeypatch, touch):
    """One graph a batch for B = 1 .. size (the loop, then the capture
    each); a new key's capture evicts B=1, or B=2 where B=1 was replayed
    just before (and so used more recently); the evicted key starts
    again from the loop."""
    size = br.GRAPH_CACHE_SIZE
    acc0, bara, bk = _case(7, size + 1, steps=2)
    for b in range(1, size + 1):
        for _ in range(2):
            _rotate(monkeypatch, "split", acc0[:b], bara[:b], bk)
    assert len(br._graphs) == size and br.graph_counts()["evictions"] == 0
    if touch:
        _rotate(monkeypatch, "split", acc0[:1], bara[:1], bk)
    br.reset_graph_counts()
    for _ in range(2):
        _rotate(monkeypatch, "split", acc0, bara, bk)
    assert br.graph_counts() == {"captures": 1, "replays": 0, "eager": 1,
                                 "evictions": 1}
    assert len(br._graphs) == size
    gone, kept = (2, 1) if touch else (1, 2)
    for b in (kept, gone, gone):
        got = _rotate(monkeypatch, "split", acc0[:b], bara[:b], bk)
        assert torch.equal(got, br.blind_rotate(acc0[:b], bara[:b], bk, p,
                                                plain=True))
    assert br.graph_counts() == {"captures": 2, "replays": 1, "eager": 2,
                                 "evictions": 2}


def test_a_batch_size_seen_once_costs_the_loop_and_no_capture(
        graphs, monkeypatch):
    """Keys that come once each (more of them than the cache holds) run
    the loop and capture nothing."""
    size = br.GRAPH_CACHE_SIZE
    acc0, bara, bk = _case(13, size + 5, steps=2)
    for b in range(1, size + 6):
        got = _rotate(monkeypatch, "split", acc0[:b], bara[:b], bk)
        assert torch.equal(got, br.blind_rotate(acc0[:b], bara[:b], bk, p,
                                                plain=True))
    assert br.graph_counts() == {"captures": 0, "replays": 0,
                                 "eager": size + 5, "evictions": 0}
    assert len(br._graphs) == 0 and len(graphs["captures"]) == 0


def test_a_key_seen_once_is_forgotten_past_the_bound(graphs, monkeypatch):
    """The cache remembers the GRAPH_CACHE_SIZE keys last seen once: past
    that, the oldest's next rotation is a first one again."""
    size = br.GRAPH_CACHE_SIZE
    acc0, bara, bk = _case(14, size + 1, steps=2)
    for b in range(1, size + 2):
        _rotate(monkeypatch, "split", acc0[:b], bara[:b], bk)
    assert len(br._seen) == size
    _rotate(monkeypatch, "split", acc0[:1], bara[:1], bk)    # forgotten
    _rotate(monkeypatch, "split", acc0[:3], bara[:3], bk)    # remembered
    assert br.graph_counts() == {"captures": 1, "replays": 0,
                                 "eager": size + 2, "evictions": 0}
    assert [k[4][0] for k in br._graphs] == [3]


def test_a_capture_that_raises_caches_nothing(graphs, monkeypatch):
    """A wrapper that refuses its operands raises from the loop and from
    the capture alike, and leaves no entry."""
    acc0, bara, bk = _case(8, 2)
    for _ in range(2):
        with pytest.raises(TypeError, match="int32"):
            _rotate(monkeypatch, "split", acc0, bara.to(torch.int64), bk)
    assert len(br._graphs) == 0 and len(graphs["captures"]) == 0
    for _ in range(2):
        _rotate(monkeypatch, "split", acc0, bara, bk)
    assert len(br._graphs) == 1 and len(graphs["captures"]) == 1


def test_rotations_on_many_threads_are_each_counted(graphs, monkeypatch):
    """Four threads rotating at one key: every rotation is counted once,
    and each answer is right."""
    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")
    acc0, bara, bk = _case(15, 2, steps=2)
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    wrong = []

    def rotate():
        for _ in range(25):
            if not torch.equal(br.blind_rotate(acc0, bara, bk, p), want):
                wrong.append(1)

    threads = [threading.Thread(target=rotate) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong
    counts = br.graph_counts()
    assert counts["captures"] == 1 and counts["eager"] >= 1
    assert counts["captures"] + counts["replays"] + counts["eager"] == 100


# -- where the path never engages ------------------------------------------

@pytest.mark.parametrize("mode", br.STEP_MODES)
@pytest.mark.parametrize("route", br.PALLAS_ROUTES)
def test_cpu_tensors_never_take_a_graph(mode, route):
    acc0, _, bk = _case(9, 2)
    assert br._graph_stream(acc0, bk, mode, route) is None


@pytest.mark.parametrize("how", ["cpu", "interpret", "scan", "ntt", "plain"])
def test_the_other_paths_run_eagerly(monkeypatch, how):
    """CPU tensors (the real ``_graph_stream``), interpret, scan, ntt and
    plain=True capture nothing: their rotation spans read
    ``graph="eager"``, and ntt and plain have no such span.  (Which modes
    and routes take a graph on CUDA tensors is held on the card.)"""
    def refuse(*args):
        raise AssertionError("captured")

    monkeypatch.setattr(br, "_capture", refuse)
    if how != "cpu":
        monkeypatch.setattr(
            br, "_graph_stream",
            lambda acc0, bk, mode, route: 11
            if mode in br.GRAPHED_MODES and route in ("auto", "1")
            else None)
    mode = {"scan": "scan", "ntt": "ntt"}.get(how, "split")
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
    if how == "interpret":
        monkeypatch.setenv("IEACHE_PALLAS", "interpret")
    acc0, bara, bk = _case(10, 2)
    br.reset_graph_counts()
    record = trace.enable()
    try:
        got = br.blind_rotate(acc0, bara, bk, p, plain=how == "plain")
    finally:
        trace.disable()
    assert torch.equal(got, br.blind_rotate(acc0, bara, bk, p, plain=True))
    spans = [s for s in record.spans if s["name"] == "blind_rotate"]
    if how in ("ntt", "plain"):
        assert spans == [] and br.graph_counts()["eager"] == 0
    else:
        assert [s["graph"] for s in spans] == ["eager"]
        assert br.graph_counts() == {"captures": 0, "replays": 0, "eager": 1,
                                     "evictions": 0}


# -- the counter -----------------------------------------------------------

def test_graph_counts_read_and_reset(graphs, monkeypatch):
    acc0, bara, bk = _case(11, 2)
    for _ in range(3):
        _rotate(monkeypatch, "split", acc0, bara, bk)
    _rotate(monkeypatch, "scan", acc0, bara, bk)
    counts = br.graph_counts()
    assert counts == {"captures": 1, "replays": 1, "eager": 2,
                      "evictions": 0}
    counts["replays"] = 99                             # a copy
    assert br.graph_counts()["replays"] == 1
    br.reset_graph_counts()
    assert br.graph_counts() == dict.fromkeys(counts, 0)
    _rotate(monkeypatch, "split", acc0, bara, bk)
    assert br.graph_counts()["replays"] == 1
