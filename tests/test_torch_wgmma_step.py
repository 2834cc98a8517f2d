"""The fused CMux step on the warpgroup tile (``csrc/wgmma_step.cuh``:
``cmux_step.cu``'s and ``blind_rotate_scan.cu``'s wgmma forms) and the
step's launch policy, as far as a CPU can hold them: the plain model in
``ieache_tpu_torch.ops.tile_models`` (each cluster rank's rows of a unit
decomposed into its own stages in the swizzled layout the wgmma descriptor
reads, then copied into every peer's; the consumers' arithmetic of
``external_product_wgmma_model``; the scan's clusters walking their work
items step by step) against the plain twins and the JAX package's
``cmux_step_pallas`` and ``blind_rotate_scan_pallas`` run in interpret
mode on the same numpy inputs, and ``step_launch`` pinned by batch.

All arithmetic is exact mod 2^32: the tolerance is exact equality.  The
CUDA kernels themselves are held against the twins on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.ops.pallas_kernels import (
    blind_rotate_scan_pallas,
    cmux_step_pallas,
)
from ieache_tpu_torch import params as TP
from ieache_tpu_torch.ops import kernels, tile_models

#: key words at which a carry between int8 limbs goes wrong (chip_smoke's
#: EDGE_KEY_WORDS): INT32_MIN, -1, 2^31 - 1, 0x7F7F7F7F, 0x80808080, 0
EDGE_KEY_WORDS = (-2**31, -1, 2**31 - 1, 0x7F7F7F7F, 0x80808080 - 2**32, 0)

#: TEST_TINY with three gadget levels: 6 TRGSW rows, units of 3 stages
TINY_6ROWS = dataclasses.replace(P.TEST_TINY, l=3, name="tiny_6rows")

#: the work items of a scan step in the kernel's order, reversed, and
#: shuffled from a seed: its clusters run them in any order
ORDERS = {"forward": None, "reversed": lambda items: items[::-1],
          "shuffled": lambda items: random.Random(3).sample(items,
                                                            len(items))}


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


def _tp(p):
    """The port's parameter set of the JAX package's ``p``."""
    if p is TINY_6ROWS:
        return dataclasses.replace(TP.TEST_TINY, l=3, name="tiny_6rows")
    return getattr(TP, p.name.upper())


def _step_inputs(p, b, case="random"):
    """acc (k+1, B, N), bara (B,) with the edge amounts first, bk_i (rows,
    k+1, N): random, the key of EDGE_KEY_WORDS in turn, or an accumulator
    whose digits are all -128 or +127 at bara = N on the key whose limbs
    drive every limb sum to its ends."""
    rng = np.random.RandomState(17 * b + len(case))
    acc = rng.randint(-2**31, 2**31, (p.k + 1, b, p.N),
                      dtype=np.int64).astype(np.int32)
    bara = rng.randint(0, 2 * p.N, (b,)).astype(np.int32)
    bara[:3] = (0, p.N, 2 * p.N - 1)[:b]
    bk_i = rng.randint(-2**31, 2**31, (p.trgsw_rows, p.k + 1, p.N),
                       dtype=np.int64).astype(np.int32)
    if case == "edge key words":
        bk_i = np.resize(np.array(EDGE_KEY_WORDS, np.int32), bk_i.shape)
    elif case.startswith("digits"):
        digit, limbs = ((-128, 0x80808080 - 2**32) if case == "digits-128"
                        else (127, 0x7F7F7F7F))
        acc = tile_models.accumulator_for_digits(_tp(p), digit,
                                                 acc.shape).numpy()
        bara[:] = p.N
        bk_i[...] = limbs
    return acc, bara, bk_i


@functools.cache
def _step_pallas(name, b, case):
    p = {q.name: q for q in (P.TEST_TINY, P.TEST_SMALL_NOISY, TINY_6ROWS)}[
        name]
    acc, bara, bk_i = _step_inputs(p, b, case)
    return np.asarray(cmux_step_pallas(jnp.asarray(acc), jnp.asarray(bara),
                                       jnp.asarray(bk_i), p, interpret=True))


def _wgmma_shapes(p, b, sms=132):
    return {name: launch for name, launch in tile_models.step_launch_shapes(
        b, p.k + 1, p.N, p.trgsw_rows, sms).items()
        if launch.form == "wgmma"}


# ---------------------------------------------------------------------------
# the producer: each rank's rows, into every rank's stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("kc", [64, 128, 256])
@pytest.mark.parametrize("bn", [64])
def test_rank_shares_cover_every_staged_byte_once(bn, kc, cluster):
    """The ranks' rows are disjoint and cover the tile; each rank's copies
    are whole 16-byte pieces, lie on its own rows, and together write
    every byte of every stage of a unit once; and what a rank decomposes
    is exactly what its copies send."""
    l = 3
    rows = [tile_models.wgmma_step_rank_rows(bn, cluster, r)
            for r in range(cluster)]
    assert rows[0][0] == 0 and rows[-1][1] == bn
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    count = np.zeros(l * bn * kc, np.int64)
    p = dataclasses.replace(TP.TEST_TINY, N=max(kc, 64), l=l)
    rng = np.random.RandomState(kc + bn)
    acc = _t(rng.randint(-2**31, 2**31, (2, bn, p.N),
                         dtype=np.int64).astype(np.int32))
    bara = _t(rng.randint(0, 2 * p.N, (bn,)).astype(np.int32))
    for rank in range(cluster):
        ranges = tile_models.wgmma_step_copy_ranges(bn, kc, cluster, rank, l)
        written = np.zeros_like(count)
        for jl, (at, _) in enumerate(tile_models.wgmma_step_unit_model(
                acc, bara, p, 0, 0, 0, bn, kc, rank, cluster)):
            written[jl * bn * kc + at.numpy()] += 1
        sent = np.zeros_like(count)
        for start, size in ranges:
            assert start % 16 == 0 and size % 16 == 0
            sent[start:start + size] += 1
            count[start:start + size] += 1
        np.testing.assert_array_equal(sent, written)
    np.testing.assert_array_equal(count, 1)


@pytest.mark.parametrize("b", [1, 33, 64])
@pytest.mark.parametrize("p", [TP.TEST_TINY, TP.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
def test_unit_stages_read_as_the_digit_rows(p, b):
    """A unit's stage jl, read through the B descriptor of each k-step,
    is digit row u l + jl of the twin's decomposition over the chunk's
    columns and the tile's batch rows (rows past the batch zero), for
    every cluster size."""
    rng = np.random.RandomState(b)
    acc = _t(rng.randint(-2**31, 2**31, (p.k + 1, b, p.N),
                         dtype=np.int64).astype(np.int32))
    bara = _t(rng.randint(0, 2 * p.N, (b,)).astype(np.int32))
    d = kernels.rot_diff_decompose_plain(acc, bara, p)
    kc = kernels.wgmma_chunk_cols(p.N)
    for bn in (kernels.WG_STEP_TILE,):
        reads = torch.cat([tile_models.wgmma_descriptor_reads(bn, kc, ks)
                           for ks in range(kc // 32)])       # (kc, bn)
        for cluster in kernels.WG_STEP_CLUSTERS:
            for b0 in range(0, b, bn):
                nb = min(bn, b - b0)
                for u in range(p.k + 1):
                    for ch in range(p.N // kc):
                        stages = tile_models.wgmma_step_stages(
                            acc, bara, p, u, ch, b0, bn, kc, cluster)
                        for jl in range(p.l):
                            got = stages[jl][reads]          # (kc, bn)
                            want = torch.zeros_like(got)
                            want[:, :nb] = d[u * p.l + jl, b0:b0 + nb,
                                             ch * kc:(ch + 1) * kc].T
                            assert torch.equal(got, want), (bn, cluster, u,
                                                            ch, jl)


# ---------------------------------------------------------------------------
# the step: the model under every wgmma launch shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 5, 24, 40, 72])
@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY, TINY_6ROWS],
                         ids=lambda p: p.name)
def test_wgmma_model_matches_twin_and_pallas(p, b):
    """cmux_step_wgmma_model under every wgmma shape step_launch picks
    from (every cluster), at ragged batches (a batch
    tile part full, rows past the batch zero), equals the twin and, where
    JAX's kernel takes the batch (a multiple of 8), JAX's cmux_step_pallas
    in interpret mode; so does cmux_step_as, which runs that model on CPU
    tensors."""
    tp = _tp(p)
    acc, bara, bk_i = _step_inputs(p, b)
    args = (_t(acc), _t(bara), _t(bk_i), tp)
    want = kernels.cmux_step_plain(*args).numpy()
    if b % 8 == 0:
        np.testing.assert_array_equal(want,
                                      _step_pallas(p.name, b, "random"))
    shapes = _wgmma_shapes(tp, b)
    assert shapes
    for name, launch in shapes.items():
        got = tile_models.cmux_step_wgmma_model(*args, launch=launch)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        assert torch.equal(tile_models.cmux_step_as(*args, launch), got)
    np.testing.assert_array_equal(acc, args[0].numpy())   # acc not written


@pytest.mark.parametrize("case", ["edge key words", "digits-128",
                                  "digits+127"])
@pytest.mark.parametrize("p", [P.TEST_TINY, TINY_6ROWS],
                         ids=lambda p: p.name)
def test_wgmma_model_on_edge_operands(p, case):
    """The key of EDGE_KEY_WORDS, and accumulators whose digits are all
    -128 or +127 on the key whose limbs drive every limb sum to its ends:
    the model equals the twin and JAX's kernel."""
    tp = _tp(p)
    acc, bara, bk_i = _step_inputs(p, 40, case)
    want = _step_pallas(p.name, 40, case)
    for launch in _wgmma_shapes(tp, 40).values():
        got = tile_models.cmux_step_wgmma_model(_t(acc), _t(bara), _t(bk_i),
                                                tp, launch=launch)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(launch))


@pytest.mark.parametrize("p", [TP.IEACHE_110_FAST, TP.IEACHE_110],
                         ids=lambda p: p.name)
def test_one_tile_at_the_full_size(p):
    """N=1024 (chunks of 256 columns, the 128-byte swizzle, two consumer
    warpgroups): one 64 x 128 tile of the last component and coefficient
    block, in clusters of 4 and 8, equals the twin's (JAX's kernels are
    not run at N=1024 on the CPU)."""
    rng = np.random.RandomState(5)
    b = 8
    acc = _t(rng.randint(-2**31, 2**31, (p.k + 1, b, p.N),
                         dtype=np.int64).astype(np.int32))
    bara = _t(rng.randint(0, 2 * p.N, (b,)).astype(np.int32))
    bk_i = _t(np.resize(np.array(EDGE_KEY_WORDS, np.int32),
                        (p.trgsw_rows, p.k + 1, p.N)))
    want = kernels.cmux_step_plain(acc, bara, bk_i, p)
    o, jb = p.k, p.N - 128
    for cluster in (4, 8):
        got = acc[o, :, jb:] + tile_models._wgmma_step_tile(
            acc, bara, bk_i, p, 0, 64, 128, o, jb, cluster)
        assert torch.equal(got, want[o, :, jb:])


def test_model_refuses_what_the_form_refuses():
    """A launch that splits a tile's sum, or a unit of more than
    WG_STEP_MAX_LEVELS stages, is not the wgmma form's."""
    p = TP.TEST_TINY
    acc = torch.zeros((2, 8, 64), dtype=torch.int32)
    bara = torch.zeros(8, dtype=torch.int32)
    bk_i = torch.zeros((4, 2, 64), dtype=torch.int32)
    split = kernels.StepLaunch("wgmma", 64, 64, 2, 1, 1, 4)
    with pytest.raises(ValueError, match="whole tiles"):
        tile_models.cmux_step_wgmma_model(acc, bara, bk_i, p, launch=split)
    deep = dataclasses.replace(TP.TEST_TINY, bg_bit=4, l=5)
    assert kernels.wgmma_step_refusal(deep.trgsw_rows, 2, 64)
    with pytest.raises(ValueError, match="gadget levels"):
        tile_models.cmux_step_wgmma_model(
            torch.zeros((2, 8, 64), dtype=torch.int32), bara,
            torch.zeros((10, 2, 64), dtype=torch.int32), deep)


# ---------------------------------------------------------------------------
# the launch policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [4, 6])
@pytest.mark.parametrize("b", [1, 8, 16, 24, 256, 257, 264, 272, 384, 448,
                               449, 512, 513, 768, 1024, 1056, 2048])
def test_step_launch_by_batch(rows, b):
    """N=1024, k=1, 132 SMs holding two mma.sync blocks each and the
    H100's clusters of wgmma blocks (30 of 4, 66 of 2): the wgmma form's
    64-row tile where the mma.sync form keeps every tile whole (from 257
    lanes) and the card holds the wgmma grid in one wave, in clusters of
    4 up to 7 batch tiles (B <= 448), of 2 up to 8 (B <= 512; at 6 rows a
    cluster of 2 does not fit a block); elsewhere mma.sync, its tiles'
    sums split over the SMs up to 256 lanes."""
    launch = kernels.step_launch(b, 2, 1024, rows, 132, 2)
    mma = kernels.step_shape(b, 2, 1024, rows, "mma", 16, sms=132, per_sm=2)
    assert mma.split == kernels.mma_split_for(-(-b // 16) * 8, rows * 4, 132)
    blocks = -(-b // 64) * 16
    cluster = (4 if blocks <= 120 else
               2 if blocks <= 132 and rows == 4 else None)
    if b <= 256 or cluster is None:
        assert launch == mma
    else:
        assert launch == kernels.StepLaunch("wgmma", 64, 128, 1, 1, cluster,
                                            blocks)
    assert launch.form == ("wgmma" if 257 <= b <= (512 if rows == 4 else 448)
                           else "mma")


def test_step_launch_reads_the_card_s_clusters():
    """The policy takes the clusters the occupancy query says the card
    holds: with fewer, a grid that no longer fits in one wave goes back
    to mma.sync, or to a smaller cluster."""
    held = ((2, 60), (4, 25), (8, 12))
    assert kernels.step_launch(512, 2, 1024, 4, 132, 2, held).form == "mma"
    assert kernels.step_launch(384, 2, 1024, 4, 132, 2, held).cluster == 4
    assert kernels.step_launch(384, 2, 1024, 4, 132, 2, held).form == "wgmma"
    assert kernels.step_launch(448, 2, 1024, 4, 132, 2, held).cluster == 2


def test_step_launch_keeps_mma_where_the_wgmma_form_refuses():
    """Five gadget levels: a unit would hold more stages than the wgmma
    step's; the policy keeps mma.sync at every batch."""
    for b in (8, 1024):
        assert kernels.step_launch(b, 2, 1024, 10).form == "mma"


@pytest.mark.parametrize("b", [8, 64, 256, 272, 1024])
def test_overlap_route_runs_the_fused_parts_below_the_card(b):
    """The overlap kernel's small-batch route: where its whole tiles are
    fewer than the SMs, the fused2 kernel's mma.sync launch (each tile's
    sum split over the SMs), else its own kernel (None)."""
    route = kernels.overlap_parts_launch(b, 2, 1024, 4, 132, 2)
    if -(-b // 16) * 8 >= 132:
        assert route is None
    else:
        assert route == kernels.step_shape(b, 2, 1024, 4, "mma", 16,
                                           sms=132, per_sm=2)
        assert route.split > 1 and route.per_item == 1


@pytest.mark.parametrize("l", [2, 3])
def test_clusters_fit_a_block(l):
    """The clusters the wgmma step takes at N=1024 are those whose rows of
    the accumulator fit beside the stages: from 2 at 4 rows, from 4 at 6
    rows; the policy's cluster is one of them, and one more row of a
    cluster of 1 does not fit."""
    bn = kernels.WG_STEP_TILE
    takes = kernels.wgmma_step_clusters(bn, 1024, 2, l)
    assert takes == ((2, 4, 8) if l == 2 else (4, 8))
    for c in takes:
        assert kernels.wgmma_step_smem_bytes(bn, 1024, l, c) <= \
            kernels.SMEM_BLOCK_BYTES
    assert kernels.wgmma_step_smem_bytes(bn, 1024, l, 1) > \
        kernels.SMEM_BLOCK_BYTES
    assert kernels.wgmma_step_cluster(bn, 1024, 2, l) in takes


@pytest.mark.parametrize("held", [None, ((2, 66), (4, 28), (8, 14))])
@pytest.mark.parametrize("b", [8, 256, 257, 272, 384, 512, 1024, 1056])
def test_scan_launch_takes_the_step_form(b, held):
    """The scan kernel takes the fused step's form, tile and cluster (on
    the same clusters held at once) from SCAN_WGMMA_MIN_BATCH lanes, and
    its mma.sync form below; in the wgmma form a grid of those clusters,
    or of every work item's cluster where they are fewer (the cooperative
    launch needs every block resident)."""
    step = kernels.step_launch(b, 2, 1024, 4, 132, 2, held)
    launch = kernels.scan_launch(b, 2, 1024, 4, 132, 2, held)
    if b < kernels.SCAN_WGMMA_MIN_BATCH:
        assert launch.form == "mma"
    else:
        assert (launch.form, launch.tile) == (step.form, step.tile)
    if launch.form == "mma":
        assert launch == tile_models.scan_launch_shapes(b, 2, 1024, 4, 132,
                                                        2)["mma"]
        return
    resident = dict(held or kernels.H100_RESIDENT_CLUSTERS)[step.cluster]
    items = -(-b // step.tile) * (16 // step.cluster)
    assert launch == kernels.ScanLaunch(
        1, 1, min(items, resident) * step.cluster, step.cluster, "wgmma",
        step.tile)
    assert len(tile_models.scan_work_items(launch, b, 1024, 2)) == items


@pytest.mark.parametrize("rows", [4, 6])
@pytest.mark.parametrize("b", [257, 271, 272, 448])
def test_scan_takes_the_wgmma_form_from_its_fewest_lanes(rows, b):
    """At 4 and 6 rows the fused step takes its wgmma form from 257 lanes
    and the scan from SCAN_WGMMA_MIN_BATCH = 272 (at 257 the mma.sync
    scan won on the H100): below it the scan's pick is its mma.sync
    form's, from it the step's tile and cluster."""
    assert kernels.SCAN_WGMMA_MIN_BATCH == 272
    step = kernels.step_launch(b, 2, 1024, rows, 132, 2)
    pick = kernels.scan_launch(b, 2, 1024, rows, 132, 2)
    assert step.form == "wgmma"
    if b < 272:
        assert pick == tile_models.scan_launch_shapes(b, 2, 1024, rows, 132,
                                                      2)["mma"]
    else:
        assert (pick.form, pick.tile, pick.cluster) == (
            "wgmma", step.tile, step.cluster)


# ---------------------------------------------------------------------------
# the scan: the clusters' work items, step by step
# ---------------------------------------------------------------------------


def _scan_inputs(p, b, nsteps):
    rng = np.random.RandomState(100 * b + nsteps)
    acc = rng.randint(-2**31, 2**31, (p.k + 1, b, p.N),
                      dtype=np.int64).astype(np.int32)
    bara = rng.randint(0, 2 * p.N, (b, nsteps)).astype(np.int32)
    bara[:, :min(nsteps, 3)] = (0, p.N, 2 * p.N - 1)[:min(nsteps, 3)]
    bk = rng.randint(-2**31, 2**31, (nsteps, p.trgsw_rows, p.k + 1, p.N),
                     dtype=np.int64).astype(np.int32)
    return acc, bara, bk


@functools.cache
def _scan_pallas(name, b, nsteps):
    p = {"test_tiny": P.TEST_TINY, "test_small_noisy": P.TEST_SMALL_NOISY}[
        name]
    acc, bara, bk = _scan_inputs(p, b, nsteps)
    return np.asarray(blind_rotate_scan_pallas(
        jnp.asarray(acc), jnp.asarray(bara), jnp.asarray(bk), p,
        interpret=True))


@pytest.mark.parametrize("nsteps", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [8, 40])
@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
def test_scan_schedule_under_the_wgmma_form(p, b, nsteps):
    """The scan's schedule model under the wgmma form (each batch tile and
    cluster, on a card holding one cluster, or all of them), its items in
    the kernel's order, reversed and shuffled, over 1 to 4 steps (the two
    buffers' every turn), equals the twin and JAX's blind_rotate_scan_pallas
    in interpret mode, its input accumulator unchanged."""
    tp = _tp(p)
    acc, bara, bk = _scan_inputs(p, b, nsteps)
    want = _scan_pallas(p.name, b, nsteps)
    args = (_t(acc), _t(bara), _t(bk), tp)
    np.testing.assert_array_equal(
        kernels.blind_rotate_scan_plain(*args).numpy(), want)
    for bn in (kernels.WG_STEP_TILE,):
        for cluster in kernels.wgmma_step_clusters(bn, p.N, p.k + 1, p.l):
            for resident in (1, 64):
                launch = kernels.scan_wgmma_shape(b, p.k + 1, p.N, bn,
                                                  cluster, resident)
                for name, order in ORDERS.items():
                    got = tile_models.blind_rotate_scan_schedule_model(
                        *args, launch=launch, order=order)
                    np.testing.assert_array_equal(
                        got.numpy(), want, err_msg=f"{launch} {name}")
    np.testing.assert_array_equal(args[0].numpy(), acc)


def test_scan_schedule_sees_a_missing_item():
    """A schedule that drops a cluster's work item leaves output words
    unwritten: the model raises."""
    p = TP.TEST_TINY
    acc, bara, bk = (_t(x) for x in _scan_inputs(P.TEST_TINY, 8, 2))
    launch = kernels.scan_wgmma_shape(8, 2, 64, 64, 1, 4)
    with pytest.raises(AssertionError, match="cover"):
        tile_models.blind_rotate_scan_schedule_model(acc, bara, bk, p,
                                                     launch=launch,
                                                     order=lambda i: i[1:])
