"""The scan kernel's launch policy and schedule (``csrc/blind_rotate_scan.cu``)
as far as a CPU can hold them: ``scan_launch`` at the full size and against
the fused step's policy it reuses, and ``blind_rotate_scan_schedule_model``
(the work items of each step in an order the test chooses, the buffers the
accumulator turns through, wrapping adds into zeroed buffers, the part that
holds pair 0 adding the current accumulator) against the plain twin and the
JAX package's ``blind_rotate_scan_pallas`` run in interpret mode on the same
numpy inputs.

All arithmetic is exact mod 2^32: the tolerance is exact equality.  The CUDA
kernel itself is held against the twin on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.ops.pallas_kernels import blind_rotate_scan_pallas
from ieache_tpu_torch import params as TP
from ieache_tpu_torch.ops import kernels

#: INT32_MIN, -1 and 2^31-1 and their neighbours
EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                 np.int32)

#: the parts of a step in the order the kernel lists them, reversed, and
#: shuffled from a seed: its blocks run them in any order
ORDERS = {"forward": None, "reversed": lambda items: items[::-1],
          "shuffled": lambda items: random.Random(7).sample(items,
                                                            len(items))}

#: cards of 132 SMs (every tile's sum split at these sizes), of 8 (fewer
#: parts, some spanning digit rows) and of 2 (one part a tile, clusters of
#: two, fewer blocks than work items)
SMS = (132, 8, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test workers on one CPU,
    and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_i32(rng, shape):
    x = rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return x


def _inputs(p, b, nsteps, word=None):
    """acc (k+1, B, N), bara (B, nsteps) with the edge amounts first, bk
    (nsteps, rows, k+1, N): random with the edge words, or ``word``
    everywhere in acc and the key."""
    rng = np.random.RandomState(1000 * b + nsteps)
    acc = _rand_i32(rng, (p.k + 1, b, p.N))
    bara = rng.randint(0, 2 * p.N, (b, nsteps)).astype(np.int32)
    bara[:, :min(nsteps, 3)] = (0, p.N, 2 * p.N - 1)[:min(nsteps, 3)]
    bk = _rand_i32(rng, (nsteps, p.trgsw_rows, p.k + 1, p.N))
    if word is not None:
        acc[...] = word
        bk[...] = word
    return acc, bara, bk


@functools.cache
def _pallas(name, b, nsteps, word):
    p = {"test_tiny": P.TEST_TINY, "test_small_noisy": P.TEST_SMALL_NOISY}[
        name]
    acc, bara, bk = _inputs(p, b, nsteps, word)
    return np.asarray(blind_rotate_scan_pallas(
        jnp.asarray(acc), jnp.asarray(bara), jnp.asarray(bk), p,
        interpret=True))


def _check_model(p, b, nsteps, order, word=None):
    tp = getattr(TP, p.name.upper())
    acc, bara, bk = _inputs(p, b, nsteps, word)
    want = _pallas(p.name, b, nsteps, word)
    acc_t = _t(acc)
    np.testing.assert_array_equal(
        kernels.blind_rotate_scan_plain(acc_t, _t(bara), _t(bk), tp).numpy(),
        want)
    for sms in SMS:
        got = kernels.blind_rotate_scan_schedule_model(
            acc_t, _t(bara), _t(bk), tp, sms=sms, order=ORDERS[order])
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(acc_t.numpy(), acc)   # acc not written


# ---------------------------------------------------------------------------
# the launch policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,split,grid", [(8, 16, 128), (256, 2, 256),
                                          (272, 1, 136), (1024, 1, 256)])
def test_scan_launch_at_the_full_size(b, split, grid):
    """N=1024, k=1, 4 rows, 132 SMs holding two blocks each, the mma.sync
    form (the policy's pick but where the wgmma form's grid fits the card
    in one wave, 272 to 512 lanes): 8 lanes split each tile's sum 16 ways
    (8 tiles, 128 parts), 256 lanes 2 ways; from 272 lanes each tile is
    whole, the runs of a row group in clusters of two."""
    pick = kernels.scan_launch(b, 2, 1024, 4, 132, 2)
    assert pick.form == ("wgmma" if 272 <= b <= 512 else "mma")
    launch = kernels.scan_launch_shapes(b, 2, 1024, 4, 132, 2)["mma"]
    assert launch.form == "mma" and (pick.form == "wgmma" or launch == pick)
    assert (launch.split, launch.grid) == (split, grid)
    nbt = -(-b // 16)
    assert launch.cluster == (2 if split == 1 else 1)
    items = kernels.scan_work_items(launch, b, 1024, 2)
    assert len(items) == nbt * 8 * split // launch.per_item
    if b == 8:
        assert launch.per_item == 1 and len(items) == 128


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 24, 100, 256, 257, 272, 1024, 1056,
                               2048])
def test_scan_launch_agrees_with_the_fused_step(b, per_sm):
    """The mma.sync form's launch (the policy's pick where the fused step
    takes mma.sync or the batch is below SCAN_WGMMA_MIN_BATCH, the form
    scan_launch picks from elsewhere): the split
    is ``mma_split_for``'s; with one part a tile the runs are
    ``step_work_items``' and the cluster ``step_cluster_shares``'; every
    block is resident (grid <= SMs x blocks an SM) in whole clusters; the
    work items cover every output tile of every part once."""
    n, kp1, rows, sms = 1024, 2, 4, 132
    launch = kernels.scan_launch_shapes(b, kp1, n, rows, sms, per_sm)["mma"]
    pick = kernels.scan_launch(b, kp1, n, rows, sms, per_sm)
    assert pick.form == (kernels.step_launch(b, kp1, n, rows, sms).form
                         if b >= kernels.SCAN_WGMMA_MIN_BATCH else "mma")
    assert pick == launch or pick.form == "wgmma"
    nbt = -(-b // 16)
    assert launch.split == kernels.mma_split_for(nbt * 8, 16, sms)
    items = kernels.scan_work_items(launch, b, n, kp1)
    nper = len(items) // (nbt * launch.split)
    assert launch.cluster == len(kernels.step_cluster_shares(
        nper, launch.split))
    if launch.split == 1:
        fused = kernels.step_work_items(b, n, kp1, sms * per_sm)
        assert [(b0, tiles) for b0, _, tiles in items] == fused
    assert launch.grid <= sms * per_sm and launch.grid % launch.cluster == 0
    assert launch.grid == min(len(items), sms * per_sm)
    seen = [(b0, q, tile) for b0, q, tiles in items for tile in tiles]
    assert sorted(seen) == sorted(
        (b0, q, (jb, o)) for b0 in range(0, b, 16)
        for q in range(launch.split) for jb in range(0, n, 256)
        for o in range(kp1))


def test_scan_launch_takes_a_split():
    """``scan_shape`` gives the launch of any split and run of tiles (the
    shapes tile_bench times beside the policy's): the runs follow the
    split, and the grid is every work item or every resident block."""
    launch = kernels.scan_shape(8, 2, 1024, 4, 1, 264)
    assert launch == kernels.ScanLaunch(4, 1, 32, 1)
    assert launch == (4, 1, 32, 1, "mma", 16)
    assert kernels.scan_shape(8, 2, 1024, 16, 8, 264) == (16, 8, 16, 1,
                                                          "mma", 16)
    assert kernels.scan_shape(1024, 2, 1024, 1, 1, 264) == (1, 1, 264, 2,
                                                            "mma", 16)
    assert kernels.scan_shape(1024, 2, 1024, 1, 8, 264) == (1, 8, 64, 1,
                                                            "mma", 16)


def test_tile_bench_times_the_smaller_splits():
    """tools/tile_bench.py times the scan kernel's mma.sync form at every
    split that divides a tile's 16 pairs and every run of 1, 2, 4 or 8 of
    a row group's 8 tiles but the form's own pick, and every other shape
    scan_launch picks from (the mma.sync form's pick where the policy
    takes the wgmma form, each wgmma tile and cluster), but the policy's
    pick."""
    from ieache_tpu_torch.tools import tile_bench

    p = TP.IEACHE_110_FAST
    for b in (8, 256, 1024):
        shapes = tile_bench.scan_launch_variants(p, b, 132)
        pick = kernels.scan_launch(b, 2, 1024, 4, 132, 2)
        mma = kernels.scan_launch_shapes(b, 2, 1024, 4, 132, 2)["mma"]
        splits = {k: s for k, s in shapes.items() if k.startswith("split")}
        assert len(splits) == 19 and mma not in splits.values()
        assert pick not in shapes.values()
        assert {(s.split, s.per_item) for s in splits.values()} | {
            (mma.split, mma.per_item)} == {
            (s, q) for s in (1, 2, 4, 8, 16) for q in (1, 2, 4, 8)}
        assert all(s.grid <= 264 for s in splits.values())
        others = {k for k in shapes if not k.startswith("split")}
        assert others == set(kernels.scan_launch_shapes(
            b, 2, 1024, 4, 132, 2)) - {
            k for k, s in kernels.scan_launch_shapes(
                b, 2, 1024, 4, 132, 2).items() if s == pick}
    assert "split 16, per_item 2" in tile_bench.scan_launch_variants(p, 8)


@pytest.mark.parametrize("p,split", [
    (P.TEST_TINY, 1), (P.TEST_TINY, 2), (P.TEST_TINY, 4),
    (P.TEST_SMALL_NOISY, 1), (P.TEST_SMALL_NOISY, 2),
    (P.TEST_SMALL_NOISY, 3), (P.TEST_SMALL_NOISY, 6)],
    ids=lambda x: getattr(x, "name", x))
def test_schedule_model_under_every_launch_shape(p, split):
    """The schedule under each split of a tile's pairs and each run of
    tiles a work item (the shapes tile_bench times), the parts shuffled:
    equal to the twin over three steps at 8 and 24 lanes."""
    tp = getattr(TP, p.name.upper())
    group = tp.k + 1
    for b in (8, 24):
        acc, bara, bk = (_t(x) for x in _inputs(p, b, 3))
        want = kernels.blind_rotate_scan_plain(acc, bara, bk, tp)
        for per_item in (1, group):
            launch = kernels.scan_shape(b, tp.k + 1, tp.N, split, per_item,
                                        264)
            got = kernels.blind_rotate_scan_schedule_model(
                acc, bara, bk, tp, order=ORDERS["shuffled"], launch=launch)
            assert torch.equal(got, want), (b, launch)


def test_scan_holds_its_digit_tile_to_a_block_s_shared_memory():
    """The kernel keeps fused2's one digit tile beside the byte planes,
    and 16 amounts beside those: it takes the rows fused2 takes at
    N=1024, 12 but not 13.  A launch that splits each tile's sum also
    holds a 16 x 264 word tile of the accumulator, which fits beside 11
    rows but not 12: there the policy keeps each tile whole."""
    assert kernels.SCAN_EXTRA_BYTES == 64
    assert kernels.kernels_refusal("scan", 12, 1024) is None
    assert "shared memory" in kernels.kernels_refusal("scan", 13, 1024)
    assert kernels.kernels_refusal("fused2", 12, 1024) is None
    assert kernels.kernels_refusal("fused2", 13, 1024) is not None
    assert kernels.scan_add_tile_fits(11, 1024)
    assert not kernels.scan_add_tile_fits(12, 1024)
    assert kernels.scan_launch(8, 2, 1024, 11).split == 22
    assert kernels.scan_launch(8, 2, 1024, 12) == (1, 1, 8, 2, "mma", 16)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("nsteps", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [8, 16, 24])
@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
def test_schedule_model_matches_twin_and_pallas(p, b, nsteps, order):
    """Every phase of the three-buffer turn (1 to 4 steps), the parts in
    three orders, on cards where a step splits each tile's sum and where
    it does not: equal to the twin and to the Pallas kernel, and the
    input accumulator unchanged."""
    _check_model(p, b, nsteps, order)


@pytest.mark.parametrize("word", [-2**31, -1, 2**31 - 1])
@pytest.mark.parametrize("b", [8, 24])
@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
def test_schedule_model_on_edge_words(p, b, word):
    """INT32_MIN, -1 and 2^31-1 in every word of the accumulator and the
    key, over three steps."""
    _check_model(p, b, 3, "shuffled", word)


def test_schedule_model_sees_a_missing_part():
    """A step whose work items leave one out does not cover every output
    word: the model raises rather than returning a wrong sum."""
    p = TP.TEST_TINY
    acc, bara, bk = (_t(x) for x in _inputs(P.TEST_TINY, 8, 2))
    with pytest.raises(AssertionError, match="cover"):
        kernels.blind_rotate_scan_schedule_model(
            acc, bara, bk, p, order=lambda items: items[1:])


def test_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the wrapper runs the plain twin and counts no
    launch."""
    p = TP.TEST_TINY
    acc, bara, bk = (_t(x) for x in _inputs(P.TEST_TINY, 8, 4))
    before = kernels.blind_rotate_scan.launches
    got = kernels.blind_rotate_scan(acc, bara, bk, p)
    assert kernels.blind_rotate_scan.launches == before
    assert torch.equal(got, kernels.blind_rotate_scan_plain(acc, bara, bk,
                                                            p))
    assert torch.equal(got, kernels.blind_rotate_scan_schedule_model(
        acc, bara, bk, p))
