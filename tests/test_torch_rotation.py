"""The two rotation kernels of the port as far as a CPU can hold them: the
plain models in ``ieache_tpu_torch.ops.tile_models`` of
``csrc/rot_diff_decompose.cu`` (a thread's run of coefficients: aligned
quads shifted by the polynomial's one amount, whole quads negated, each
digit row packed by byte permutes into one store; and the launch policy
that picks the run and the block) and of the sublane kernel of
``csrc/rotate_probe.cu`` (the shared-memory slab of ``csrc/rot_slab.cuh``,
or the gather), against the port's plain twins and the JAX package's
``rot_diff_decompose_pallas`` in interpret mode and
``negacyclic_rotate_batch`` on the same numpy inputs.

All arithmetic is exact mod 2^32: the tolerance is exact equality.  The
CUDA kernels themselves are held against the twins on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ieache_tpu import params as P
from ieache_tpu.ops.blind_rotate import negacyclic_rotate_batch
from ieache_tpu.ops.pallas_kernels import rot_diff_decompose_pallas
from ieache_tpu_torch.ops import kernels, tile_models

#: compiled once a shape: the amounts of a test share it
_rotate_batch = jax.jit(negacyclic_rotate_batch)

PARAMS = [P.TEST_TINY, P.IEACHE_110_FAST]

#: the amounts named by the run's shift: every residue mod 4 and the
#: edges of X^N = -1; "random" is one amount a lane
AMOUNTS = ["0", "1", "2", "3", "N-1", "N", "N+1", "2N-1", "random"]

#: words at the edges of int32
EDGE_WORDS = [-2**31, -1, 2**31 - 1]


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
    return rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _bara(name, n, b, rng):
    fixed = {"0": 0, "1": 1, "2": 2, "3": 3, "N-1": n - 1, "N": n,
             "N+1": n + 1, "2N-1": 2 * n - 1}
    if name == "random":
        return rng.randint(0, 2 * n, (b,)).astype(np.int32)
    return np.full((b,), fixed[name], np.int32)


def _runs(n):
    """Every run length the split rotation's kernel takes at N."""
    return [run for run in tile_models.ROT_RUNS if run <= n]


def _with_n(p, n):
    return dataclasses.replace(p, N=n, name=f"{p.name}_n{n}")


# ---------------------------------------------------------------------------
# rot_diff_decompose: runs of coefficients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amount", AMOUNTS)
@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_run_model_matches_the_twin(p, b, amount):
    """Both run lengths, at every residue of the amount."""
    rng = np.random.RandomState(b + len(amount))
    acc = _t(_rand_i32(rng, (p.k + 1, b, p.N)))
    bara = _t(_bara(amount, p.N, b, rng))
    want = kernels.rot_diff_decompose_plain(acc, bara, p)
    for run in _runs(p.N):
        got = tile_models.rot_diff_decompose_run_model(acc, bara, p,
                                                       run=run)
        assert got.dtype == torch.int8
        assert torch.equal(got, want), run


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_run_model_matches_pallas(p):
    """The launch the policy picks, against the JAX Pallas kernel in
    interpret mode, at every amount of :data:`AMOUNTS` (B = 8: the Pallas
    kernel takes whole sublane groups)."""
    rng = np.random.RandomState(3)
    acc = _rand_i32(rng, (p.k + 1, 8, p.N))
    for amount in AMOUNTS:
        bara = _bara(amount, p.N, 8, rng)
        want = np.asarray(rot_diff_decompose_pallas(
            jnp.asarray(acc), jnp.asarray(bara), p, interpret=True))
        got = tile_models.rot_diff_decompose_run_model(_t(acc), _t(bara), p)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=amount)


@pytest.mark.parametrize("word", EDGE_WORDS)
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_run_model_on_extreme_operands(p, word):
    """An accumulator of INT32_MIN, -1 or 2^31 - 1 everywhere (negated
    whole quads wrap), and one that cycles through the three, against
    the twin and the Pallas kernel."""
    rng = np.random.RandomState(word % 97)
    shape = (p.k + 1, 8, p.N)
    cycled = np.array(EDGE_WORDS, np.int32)[
        np.arange(int(np.prod(shape))) % 3].reshape(shape)
    for acc in (np.full(shape, word, np.int32), cycled):
        bara = rng.randint(0, 2 * p.N, (8,)).astype(np.int32)
        want = np.asarray(rot_diff_decompose_pallas(
            jnp.asarray(acc), jnp.asarray(bara), p, interpret=True))
        for run in _runs(p.N):
            got = tile_models.rot_diff_decompose_run_model(
                _t(acc), _t(bara), p, run=run)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_run_model_at_small_degrees(n):
    """N = 8, 16 and 32: both runs, every amount of the ring, a ragged
    batch."""
    p = _with_n(P.TEST_TINY, n)
    rng = np.random.RandomState(n)
    acc = _t(_rand_i32(rng, (p.k + 1, 3, n)))
    for a in range(2 * n):
        bara = _t(np.array([a, (a + 5) % (2 * n), 2 * n - 1 - a], np.int32))
        want = kernels.rot_diff_decompose_plain(acc, bara, p)
        for run in _runs(n):
            assert torch.equal(tile_models.rot_diff_decompose_run_model(
                acc, bara, p, run=run), want), (a, run)


@pytest.mark.parametrize("bg_bit,l", [(8, 4), (6, 3), (4, 8), (7, 2)])
def test_run_model_at_other_gadgets(bg_bit, l):
    """Digits of other widths take gadget_digit byte by byte; Bg = 2^8
    with l = 4 reaches byte 0 of every word."""
    p = dataclasses.replace(P.TEST_TINY, bg_bit=bg_bit, l=l,
                            name=f"tiny_bg{bg_bit}_l{l}")
    rng = np.random.RandomState(bg_bit * l)
    acc = _rand_i32(rng, (p.k + 1, 8, p.N))
    bara = rng.randint(0, 2 * p.N, (8,)).astype(np.int32)
    want = np.asarray(rot_diff_decompose_pallas(
        jnp.asarray(acc), jnp.asarray(bara), p, interpret=True))
    for run in _runs(p.N):
        got = tile_models.rot_diff_decompose_run_model(_t(acc), _t(bara), p,
                                                       run=run)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,want", [
    (1, 4), (8, 4), (16, 4), (256, 4), (528, 4), (529, 8), (1024, 8),
    (1056, 8)])
def test_rot_launch_policy(b, want):
    """At IEACHE_110_FAST (k + 1 = 2, N = 1024) on 132 SMs: runs of 8 once
    runs of 4 would need more threads than the SMs hold at once (B > 528:
    the throughput batch and its windowed-multiply cousin 1056), runs of
    4 below (the small batches of A + B - C)."""
    assert kernels.rot_launch(b, 2, 1024) == want


def test_rot_launch_policy_at_small_degrees_and_other_cards():
    """A run of 8 fits every N the kernel takes; fewer SMs take runs of 8
    sooner."""
    assert kernels.rot_launch(1 << 17, 2, 8) == 8
    assert kernels.rot_launch(1 << 16, 2, 8) == 4
    assert kernels.rot_launch(1, 2, 8) == 4
    assert kernels.rot_launch(16, 2, 1024, sms=1) == 8
    assert kernels.rot_launch(16, 2, 1024, sms=16) == 4
    for b in (1, 3, 8, 16, 100, 1000, 5000):
        assert kernels.rot_launch(b, 2, 256) in tile_models.ROT_RUNS


def test_run_model_refuses_launches_the_kernel_refuses():
    p = P.TEST_TINY
    acc = torch.zeros((p.k + 1, 1, p.N), dtype=torch.int32)
    bara = torch.zeros((1,), dtype=torch.int32)
    for run in (0, 1, 2, 3, 16):
        with pytest.raises(ValueError):
            tile_models.rot_diff_decompose_run_model(acc, bara, p, run=run)


def test_byte_perm_model():
    """__byte_perm's selector picks bytes of y:x, x the low four."""
    x, y = torch.tensor([0x33221100]), torch.tensor([0x77665544])
    assert int(tile_models.byte_perm(x, y, 0x5410)) == 0x55441100
    assert int(tile_models.byte_perm(x, y, 0x0123)) == 0x00112233
    assert int(tile_models.byte_perm(x, y, 0x7654)) == 0x77665544
    assert int(tile_models.byte_perm(x, y, 0x73)) == 0x00007733


@settings(max_examples=100, deadline=None)
@given(words=st.lists(st.integers(0, 2**32 - 1), min_size=4, max_size=4),
       jl=st.integers(0, 3))
def test_digit_word_model_packs_gadget_digits(words, jl):
    """With Bg = 2^8 the byte permutes give what gadget_digit gives,
    digit s in byte s."""
    v = torch.tensor(words, dtype=torch.int64)
    word = int(tile_models.digit_word_model(v, jl, 8))
    for s in range(4):
        digit = ((words[s] >> (24 - 8 * jl)) & 0xFF) - 128
        assert ((word >> (8 * s)) & 0xFF) == digit & 0xFF


# ---------------------------------------------------------------------------
# rotate_sublane: the slab, or the gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,b", [(8, 5), (8, 16), (8, 40), (64, 5),
                                 (64, 16), (64, 40), (1024, 5), (1024, 40),
                                 (4096, 5), (4096, 16)])
def test_sublane_slab_model_matches_jax(n, b):
    """The gather and the slab shared by 1, 2 and N / 16 blocks, against
    the twin and JAX's negacyclic_rotate_batch, at every amount of
    :data:`AMOUNTS`; N = 4096's slab does not fit a block, so its policy
    gathers."""
    rng = np.random.RandomState(n + b)
    acc = _rand_i32(rng, (2, n, b))
    routes = [0]
    if kernels.rot_tr_slab_bytes(n) <= kernels.SMEM_BLOCK_BYTES:
        routes += sorted({1, min(2, max(1, n // 16)), max(1, n // 16)})
    if n == 4096:
        assert kernels.rot_tr_route(b, 2, n) == 0 and routes == [0]
    for amount in AMOUNTS:
        bara = _bara(amount, n, b, rng)
        want = np.asarray(_rotate_batch(
            jnp.asarray(acc.transpose(2, 0, 1)), jnp.asarray(bara))) \
            .transpose(1, 2, 0)
        plain = kernels.rotate_sublane_plain(_t(acc), _t(bara))
        np.testing.assert_array_equal(plain.numpy(), want)
        for splits in routes:
            got = tile_models.rot_tr_slab_model(_t(acc), _t(bara),
                                                splits=splits)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{amount} {splits}")
        np.testing.assert_array_equal(
            tile_models.rot_tr_slab_model(_t(acc), _t(bara)).numpy(), want)


@pytest.mark.parametrize("word", EDGE_WORDS)
def test_sublane_slab_model_on_extreme_operands(word):
    rng = np.random.RandomState(5)
    acc = np.full((2, 64, 20), word, np.int32)
    bara = rng.randint(0, 128, (20,)).astype(np.int32)
    want = kernels.rotate_sublane_plain(_t(acc), _t(bara))
    for splits in (0, 1, 4):
        assert torch.equal(tile_models.rot_tr_slab_model(
            _t(acc), _t(bara), splits=splits), want)


@pytest.mark.parametrize("b,n,want", [
    (2048, 1024, 1), (1024, 1024, 2), (129, 1024, 8), (128, 1024, 0),
    (16, 1024, 0), (5, 8, 1), (2048, 8, 1), (2048, 2048, 1),
    (2048, 4096, 0), (16, 4096, 0)])
def test_sublane_route(b, n, want):
    """At k + 1 = 2 on 132 SMs: one block a slab at the probe's B = 2048;
    blocks sharing a slab below that; the gather from 16 blocks a slab
    (B <= 128 at N = 1024) and wherever the slab does not fit (N =
    4096); at N = 8 and 16 a slab has one row of a block's threads or
    fewer, so it is never shared."""
    assert kernels.rot_tr_route(b, 2, n) == want


@settings(max_examples=200, deadline=None)
@given(logn=st.integers(3, 11), j0=st.integers(0, 2047),
       bara=st.lists(st.integers(0, 2**31 - 1), min_size=16, max_size=16))
def test_slab_reads_are_free_of_bank_conflicts_at_every_degree(logn, j0,
                                                               bara):
    """The sublane kernel reads its slab as the tr rotation does, from N
    = 8 to 2048: a warp's two rows x 16 lanes fall on 32 distinct banks,
    rotated and plain, whatever each lane's amount."""
    n = 1 << logn
    j0 = (j0 % n) & ~1
    amounts = torch.tensor(bara) % (2 * n)
    rot, plain = tile_models.rot_tr_slab_banks(j0, amounts, n)
    assert len(set(rot.tolist())) == 32
    assert len(set(plain.tolist())) == 32


def test_tr_rotation_takes_the_same_route():
    """The tr step's rotation launches by the same policy: its model
    gathers where the route is 0 and equals the twin either way."""
    p = P.TEST_SMALL_NOISY
    rng = np.random.RandomState(11)
    acc = _t(_rand_i32(rng, (p.k + 1, p.N, 24)))
    bara = _t(rng.randint(0, 2 * p.N, (24,)).astype(np.int32))
    want = kernels.rot_diff_decompose_tr_plain(acc, bara, p)
    for sms in (1, 4, 132):
        assert torch.equal(
            tile_models.rot_diff_decompose_tr_slab_model(acc, bara, p,
                                                         sms=sms),
            want)
    assert kernels.rot_tr_route(24, 2, p.N) == 0
    assert kernels.rot_tr_route(24, 2, p.N, sms=4) == 1
