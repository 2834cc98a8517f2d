"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips it
when no CUDA device is present.  This file imports no JAX and nothing
of the JAX package, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest`` because tests/conftest.py configures JAX).  All
integer arithmetic is exact mod 2^32: kernel and twin must be equal.
``mm_bf16`` alone is held to a tolerance (``MM_BF16_RTOL`` of the
largest |o| of a float64 product of the same bf16 operands): its
float32 sums run in another order than the twin's.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from ieache_tpu_torch import keygen, prng
from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.lwe import encrypt, keygen_device
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools import mosaic_mm_probe, tile_bench

pytestmark = pytest.mark.gpu

PARAMS = [P.TEST_TINY, P.TEST_SMALL_NOISY, P.IEACHE_110_FAST]

WRAPPERS = {name: getattr(kernels, name) for name in kernels.WRAPPERS}

#: mm_bf16 against a float64 product, relative to its largest |o|
MM_BF16_RTOL = 1e-2

#: the kernels each step mode launches
MODES = kernels.MODE_KERNELS


#: key words whose int8 limbs are all -128 / all +127
LIMBS_LO, LIMBS_HI = 0x80808080 - 2**32, 0x7F7F7F7F

#: words at which a carry between limbs goes wrong
EDGE_KEY_WORDS = (-2**31, -1, 2**31 - 1, LIMBS_HI, LIMBS_LO, 0)


def _edge_key(shape, device):
    edge = torch.tensor(EDGE_KEY_WORDS, dtype=torch.int32, device=device)
    idx = torch.arange(int(np.prod(shape)), device=device)
    return edge[idx % len(edge)].reshape(shape)


@contextlib.contextmanager
def _env(name, value):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _step_mode(mode):
    return _env("IEACHE_PALLAS_STEP", mode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _rand(rng, shape, lo, hi, dtype, device):
    return torch.from_numpy(
        rng.randint(lo, hi, shape, dtype=np.int64).astype(dtype)).to(device)


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 64, 1056])
def test_rot_diff_decompose_kernel_matches_plain(cuda, p, b):
    rng = np.random.RandomState(b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    for bara in (_rand(rng, (b,), 0, 2 * p.N, np.int32, cuda),
                 *(torch.full((b,), a, dtype=torch.int32, device=cuda)
                   for a in (0, p.N, 2 * p.N - 1))):
        before = kernels.rot_diff_decompose.launches
        got = kernels.rot_diff_decompose(acc, bara, p)
        assert kernels.rot_diff_decompose.launches == before + 1
        want = kernels.rot_diff_decompose_plain(acc, bara, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 64, 1056])
@pytest.mark.parametrize("with_acc", [False, True])
def test_external_product_kernel_matches_plain(cuda, p, b, with_acc):
    rng = np.random.RandomState(100 + b)
    d = _rand(rng, (p.trgsw_rows, b, p.N), -128, 128, np.int8, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                 np.int32, cuda)
    acc = (_rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
           if with_acc else None)
    before = kernels.external_product.launches
    got = kernels.external_product(d, bk_i, p, acc=acc)
    assert kernels.external_product.launches == before + 1
    want = kernels.external_product_plain(d, bk_i, p, acc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _small_noisy_case(cuda):
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, cuda)
    bits = prng.uniform_bits01(prng.key_from_seed_words([3]), 37)
    ct = encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([4]), cuda)
    return ks, key, bits, ct


def _launched(counts):
    return {name for (name, w), c in zip(WRAPPERS.items(), counts)
            if w.launches != c}


@pytest.mark.parametrize("mode", list(MODES))
def test_bootstrap_kernel_path_matches_plain_path(cuda, mode):
    """The bootstrap under each step mode equals the plain path, and
    launched the mode's kernels and no other (ntt: none)."""
    ks, key, bits, ct = _small_noisy_case(cuda)
    want = bootstrap.bootstrap(ct, key, plain=True)
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode(mode):
        got = bootstrap.bootstrap(ct, key)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, got), bits)
    assert _launched(counts) == set(MODES[mode])


@pytest.mark.parametrize("route", ["0", "interpret", "1"])
@pytest.mark.parametrize("mode", ["split", "scan", "tr"])
def test_pallas_routes_on_the_card(cuda, route, mode):
    """IEACHE_PALLAS on CUDA tensors: 0 (the plain step) and interpret
    (the mode's plain twins) launch nothing, 1 the mode's kernels; all
    equal the plain path."""
    ks, key, bits, ct = _small_noisy_case(cuda)
    want = bootstrap.bootstrap(ct, key, plain=True)
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode(mode), _env("IEACHE_PALLAS", route):
        got = bootstrap.bootstrap(ct, key)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)
    assert _launched(counts) == (set(MODES[mode]) if route == "1" else set())


def test_compat_gadget_refused_on_cuda(cuda):
    """The kernel wrappers refuse the two-limb compat gadget; the
    blind rotation takes the plain step for it on the card, as the JAX
    package takes its XLA step on any device, and equals plain=True."""
    p = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")
    rng = np.random.RandomState(5)
    acc = _rand(rng, (p.k + 1, 3, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (3,), 0, 2 * p.N, np.int32, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 cuda)
    with pytest.raises(ValueError, match="single-limb"):
        kernels.rot_diff_decompose(acc, bara, p)
    for step in (kernels.cmux_step, kernels.cmux_step_overlap):
        with pytest.raises(ValueError, match="single-limb"):
            step(acc, bara, bk_i, p)
    from ieache_tpu_torch.ops.blind_rotate import blind_rotate

    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, cuda)
    bara_n = _rand(rng, (3, p.n), 0, 2 * p.N, np.int32, cuda)
    acc0 = acc.transpose(0, 1).contiguous()
    want = blind_rotate(acc0, bara_n, bk, p, plain=True)
    for mode in MODES:
        with _step_mode(mode):
            got = blind_rotate(acc0, bara_n, bk, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 64, 1056])
@pytest.mark.parametrize("step", ["cmux_step", "cmux_step_overlap"])
def test_cmux_step_kernels_match_plain(cuda, p, b, step):
    kern = getattr(kernels, step)
    rng = np.random.RandomState(200 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                 np.int32, cuda)
    for bara in (_rand(rng, (b,), 0, 2 * p.N, np.int32, cuda),
                 *(torch.full((b,), a, dtype=torch.int32, device=cuda)
                   for a in (0, p.N, 2 * p.N - 1))):
        before = kern.launches
        got = kern(acc, bara, bk_i, p)
        assert kern.launches == before + 1
        want = kernels.cmux_step_plain(acc, bara, bk_i, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


#: the batches at which the step kernels' launches change shape at
#: N=1024: split parts up to 256 lanes, whole tiles from 257
STEP_BATCHES = [1, 5, 8, 16, 256, 257, 1024, 1056]


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", STEP_BATCHES)
@pytest.mark.parametrize("step", ["cmux_step", "cmux_step_overlap"])
def test_cmux_step_kernels_extreme_accumulators(cuda, p, b, step):
    """Both fused kernels on the tensor-core tile: accumulators that
    decompose to -128 and to +127 everywhere (bara = N) on key limbs at
    their ends, a random accumulator on the edge key words, and random
    operands; equal to the twin, one launch a call."""
    kern = getattr(kernels, step)
    rng = np.random.RandomState(600 + b)
    shape_a = (p.k + 1, b, p.N)
    shape_k = (p.trgsw_rows, p.k + 1, p.N)
    at_n = torch.full((b,), p.N, dtype=torch.int32, device=cuda)
    cases = []
    for digit, limbs in ((-128, LIMBS_LO), (127, LIMBS_HI), (-128, LIMBS_HI)):
        acc = kernels.accumulator_for_digits(p, digit, shape_a, cuda)
        d = kernels.rot_diff_decompose_plain(acc, at_n, p)
        assert int(d.min()) == int(d.max()) == digit
        cases.append((acc, at_n, torch.full(shape_k, limbs,
                                            dtype=torch.int32, device=cuda)))
    for key in (_edge_key(shape_k, cuda),
                _rand(rng, shape_k, -2**31, 2**31, np.int32, cuda)):
        cases.append((_rand(rng, shape_a, -2**31, 2**31, np.int32, cuda),
                      _rand(rng, (b,), 0, 2 * p.N, np.int32, cuda), key))
    for i, (acc, bara, bk_i) in enumerate(cases):
        before = kern.launches
        got = kern(acc, bara, bk_i, p)
        assert kern.launches == before + 1
        want = kernels.cmux_step_plain(acc, bara, bk_i, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert got.data_ptr() != acc.data_ptr()


@pytest.mark.parametrize("p", [
    dataclasses.replace(P.TEST_TINY, bg_bit=6, l=3, name="tiny_bg6"),
    dataclasses.replace(P.TEST_SMALL_NOISY, bg_bit=4, l=4, name="small_bg4"),
    dataclasses.replace(P.IEACHE_110, name="ieache_110_6rows"),
    dataclasses.replace(P.TEST_TINY, N=128, name="tiny_n128")],
    ids=lambda p: p.name)
@pytest.mark.parametrize("b", [3, 40, 1056])
@pytest.mark.parametrize("step", ["cmux_step", "cmux_step_overlap"])
def test_cmux_step_kernels_other_gadgets_and_sizes(cuda, p, b, step):
    """A gadget base below 2^8 (digits by shift and mask, not by byte
    permutes), 6 TRGSW rows at N=1024 (one fused2 block an SM), and the
    N=128 tile."""
    rng = np.random.RandomState(700 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 cuda)
    for bara in (_rand(rng, (b,), 0, 2 * p.N, np.int32, cuda),
                 torch.full((b,), p.N, dtype=torch.int32, device=cuda)):
        got = getattr(kernels, step)(acc, bara, bk_i, p)
        want = kernels.cmux_step_plain(acc, bara, bk_i, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


#: the smallest input that showed the fault: N below the tile's 64
SMALL_N = P.TFHEParams(n=8, N=32, k=1, bg_bit=8, l=2, ks_basebit=4, ks_t=4,
                       lwe_noise_scale=0, tlwe_noise_scale=0, name="n32")


@pytest.mark.parametrize("route", ["auto", "interpret"])
@pytest.mark.parametrize("mode", list(MODES))
def test_small_n_takes_the_plain_step_on_the_card(cuda, mode, route):
    """At N=32 the blind rotation on CUDA tensors equals plain=True under
    every step mode; no mode launches anything (every mode's kernels
    refuse the shape, and the plain step runs; ntt has no kernel)."""
    from ieache_tpu_torch.ops.blind_rotate import blind_rotate

    p = SMALL_N
    rng = np.random.RandomState(32)
    acc0 = _rand(rng, (1, p.k + 1, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (1, p.n), 0, 2 * p.N, np.int32, cuda)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, cuda)
    want = blind_rotate(acc0, bara, bk, p, plain=True)
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode(mode), _env("IEACHE_PALLAS", route):
        got = blind_rotate(acc0, bara, bk, p)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)
    takes = kernels.kernels_take(mode, p)
    assert takes == (mode == "ntt")
    assert _launched(counts) == (set(MODES[mode])
                                 if takes and route == "auto" else set())
    if not takes:
        with _step_mode(mode), _env("IEACHE_PALLAS", "1"):
            with pytest.raises(ValueError, match="refuse this shape"):
                blind_rotate(acc0, bara, bk, p)


def test_small_n_bootstrap_runs_on_the_card(cuda):
    """The whole gate bootstrap at N=32 under the default mode, which
    raised before the blind rotation asked the predicate."""
    ks = keygen.generate_secret_keyset(SMALL_N)
    key = bootstrap.pack_cloud_key(ks.cloud, cuda)
    bits = prng.uniform_bits01(prng.key_from_seed_words([3]), 9)
    ct = encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([4]), cuda)
    counts = [w.launches for w in WRAPPERS.values()]
    got = bootstrap.bootstrap(ct, key)
    torch.cuda.synchronize()
    assert torch.equal(got, bootstrap.bootstrap(ct, key, plain=True))
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, got), bits)
    assert _launched(counts) == set()


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 64, 1056])
def test_blind_rotate_scan_kernel_matches_plain(cuda, p, b):
    """All n steps of ``p``, edge amounts in the first three."""
    rng = np.random.RandomState(300 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, cuda)
    bara[:, :3] = torch.tensor([0, p.N, 2 * p.N - 1], dtype=torch.int32,
                               device=cuda)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, cuda)
    before = kernels.blind_rotate_scan.launches
    got = kernels.blind_rotate_scan(acc, bara, bk, p)
    assert kernels.blind_rotate_scan.launches == before + 1
    want = kernels.blind_rotate_scan_plain(acc, bara, bk, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 64, 1056])
def test_tr_kernels_match_plain(cuda, p, b):
    """Both tr kernels, the rotation at each edge amount and the
    product with and without the accumulator."""
    rng = np.random.RandomState(400 + b)
    acc = _rand(rng, (p.k + 1, p.N, b), -2**31, 2**31, np.int32, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                 np.int32, cuda)
    for bara in (_rand(rng, (b,), 0, 2 * p.N, np.int32, cuda),
                 *(torch.full((b,), a, dtype=torch.int32, device=cuda)
                   for a in (0, p.N, 2 * p.N - 1))):
        before = kernels.rot_diff_decompose_tr.launches
        got = kernels.rot_diff_decompose_tr(acc, bara, p)
        assert kernels.rot_diff_decompose_tr.launches == before + 1
        want = kernels.rot_diff_decompose_tr_plain(acc, bara, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    d = _rand(rng, (p.trgsw_rows, p.N, b), -128, 128, np.int8, cuda)
    for a in (None, acc):
        before = kernels.external_product_tr.launches
        got = kernels.external_product_tr(d, bk_i, p, acc=a)
        assert kernels.external_product_tr.launches == before + 1
        want = kernels.external_product_tr_plain(d, bk_i, p, a)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("p", [P.IEACHE_110_FAST, P.IEACHE_110],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("b", [8, 16, 128, 129, 256, 257])
def test_tr_kernels_extreme_operands(cuda, p, b):
    """Both tr kernels at 4 and 6 TRGSW rows, either side of where the
    product's launch splits a tile's sum over blocks (8 and 16 lanes: 8
    tiles; 256: 128 tiles, still split; 257: 136 tiles, not split) and of
    where the rotation turns from its gather (up to 128 lanes) to slabs:
    every limb sum at its ends, the edge key words and random operands,
    with and without the accumulator; the rotation at the edge
    amounts."""
    rng = np.random.RandomState(800 + b)
    shape_d, shape_k = (p.trgsw_rows, p.N, b), (p.trgsw_rows, p.k + 1, p.N)
    acc = _rand(rng, (p.k + 1, p.N, b), -2**31, 2**31, np.int32, cuda)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=cuda)

    cases = [
        (full(shape_d, -128, torch.int8), full(shape_k, LIMBS_LO, torch.int32)),
        (full(shape_d, 127, torch.int8), full(shape_k, LIMBS_HI, torch.int32)),
        (full(shape_d, -128, torch.int8), full(shape_k, LIMBS_HI, torch.int32)),
        (_rand(rng, shape_d, -128, 128, np.int8, cuda), _edge_key(shape_k, cuda)),
        (_rand(rng, shape_d, -128, 128, np.int8, cuda),
         _rand(rng, shape_k, -2**31, 2**31, np.int32, cuda)),
    ]
    for i, (d, bk_i) in enumerate(cases):
        for a in (None, acc):
            before = kernels.external_product_tr.launches
            got = kernels.external_product_tr(d, bk_i, p, acc=a)
            assert kernels.external_product_tr.launches == before + 1
            want = kernels.external_product_tr_plain(d, bk_i, p, a)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (i, a is not None)
    for amount in (0, p.N, 2 * p.N - 1):
        bara = torch.full((b,), amount, dtype=torch.int32, device=cuda)
        got = kernels.rot_diff_decompose_tr(acc, bara, p)
        want = kernels.rot_diff_decompose_tr_plain(acc, bara, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), amount


def test_tr_kernels_refuse_shapes_over_their_bounds(cuda):
    """N below the tensor-core tile's 64, rows * N >= 2^17, and a slab
    over a block's shared memory (N = 4096): both tr wrappers raise on
    CUDA tensors and launch nothing; the C entry points refuse the
    first."""
    counts = [w.launches for w in WRAPPERS.values()]
    for p in (dataclasses.replace(P.TEST_TINY, N=32, name="n32"),
              dataclasses.replace(P.IEACHE_110_FAST, k=63, name="rows128"),
              dataclasses.replace(P.IEACHE_110_FAST, N=4096, name="n4096")):
        rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
        acc = torch.zeros((kp1, n, 1), dtype=torch.int32, device=cuda)
        bara = torch.zeros((1,), dtype=torch.int32, device=cuda)
        d = torch.zeros((rows, n, 1), dtype=torch.int8, device=cuda)
        bk_i = torch.zeros((rows, kp1, n), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError):
            kernels.rot_diff_decompose_tr(acc, bara, p)
        with pytest.raises(ValueError):
            kernels.external_product_tr(d, bk_i, p, acc=acc)
    assert _launched(counts) == set()
    lib = kernels._build.library()
    stream = torch.cuda.current_stream().cuda_stream
    acc = torch.zeros((2, 32, 1), dtype=torch.int32, device=cuda)
    d = torch.zeros((4, 32, 1), dtype=torch.int8, device=cuda)
    out = torch.empty_like(acc)
    assert lib.ieache_external_product_tr(
        d.data_ptr(), acc.data_ptr(), None, out.data_ptr(), 4, 2, 1, 32,
        stream) != 0
    assert lib.ieache_rot_diff_decompose_tr(
        acc.data_ptr(), acc.data_ptr(), d.data_ptr(), 2, 1, 32, 8, 2, 0, 0,
        stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 64, 1056])
def test_rotate_probe_kernels_match_plain(cuda, p, b):
    rng = np.random.RandomState(500 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    acc_t = acc.transpose(1, 2).contiguous()
    for bara in (_rand(rng, (b,), 0, 2 * p.N, np.int32, cuda),
                 *(torch.full((b,), a, dtype=torch.int32, device=cuda)
                   for a in (0, p.N, 2 * p.N - 1))):
        for kern, plain, x in (
                (kernels.rotate_lane, kernels.rotate_lane_plain, acc),
                (kernels.rotate_sublane, kernels.rotate_sublane_plain,
                 acc_t)):
            before = kern.launches
            got = kern(x, bara)
            assert kern.launches == before + 1
            want = plain(x, bara)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def _rot_amounts(n):
    """Every residue of the amount mod 4 and the edges of X^N = -1."""
    return (0, 1, 2, 3, n - 1, n, n + 1, 2 * n - 1)


def _rot_cases(rng, shape, b, n, device):
    """(name, acc, bara): a random accumulator at the amounts of
    :func:`_rot_amounts` and random ones, then one of INT32_MIN, -1 and
    2^31 - 1 in turn at random amounts."""
    acc = _rand(rng, shape, -2**31, 2**31, np.int32, device)
    yield "random", acc, _rand(rng, (b,), 0, 2 * n, np.int32, device)
    for a in _rot_amounts(n):
        yield a, acc, torch.full((b,), a, dtype=torch.int32, device=device)
    edge = torch.tensor([-2**31, -1, 2**31 - 1], dtype=torch.int32,
                        device=device)
    idx = torch.arange(int(np.prod(shape)), device=device)
    yield ("INT32_MIN/-1/2^31-1", edge[idx % 3].reshape(shape),
           _rand(rng, (b,), 0, 2 * n, np.int32, device))


@pytest.mark.parametrize("n", [8, 64, 1024, 2048])
@pytest.mark.parametrize("b", [1, 5, 8, 16, 256, 257, 1024, 1056])
def test_rot_diff_decompose_kernel_by_batch_and_degree(cuda, b, n):
    """The split rotation's runs of 4 or 8 coefficients, as its
    launch policy picks them, at every residue of the amount and on
    extreme operands."""
    p = dataclasses.replace(P.IEACHE_110_FAST, N=n, name=f"l2_n{n}")
    rng = np.random.RandomState(b * n)
    for amount, acc, bara in _rot_cases(rng, (p.k + 1, b, n), b, n, cuda):
        before = kernels.rot_diff_decompose.launches
        got = kernels.rot_diff_decompose(acc, bara, p)
        assert kernels.rot_diff_decompose.launches == before + 1
        want = kernels.rot_diff_decompose_plain(acc, bara, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), amount


@pytest.mark.parametrize("n", [8, 1024, 4096])
@pytest.mark.parametrize("b", [5, 16, 128, 129, 2048])
def test_rotate_sublane_kernel_by_slab_and_gather(cuda, b, n):
    """The sublane rotation through its slab, or its gather at small
    batches and at N = 4096 (whose slab does not fit a block)."""
    rng = np.random.RandomState(700 + b + n)
    for amount, acc, bara in _rot_cases(rng, (2, n, b), b, n, cuda):
        before = kernels.rotate_sublane.launches
        got = kernels.rotate_sublane(acc, bara)
        assert kernels.rotate_sublane.launches == before + 1
        want = kernels.rotate_sublane_plain(acc, bara)
        torch.cuda.synchronize()
        assert torch.equal(got, want), amount


@pytest.mark.parametrize("n,b", [(8, 5), (64, 40), (1024, 8), (1024, 257),
                                 (2048, 16)])
def test_rotation_launch_variants_match_plain(cuda, n, b):
    """Every launch shape of the two rotations, whatever their policies
    pick: rot_diff_decompose at each run length,
    rotate_sublane by slab and by gather (uncounted launches)."""
    p = dataclasses.replace(P.IEACHE_110_FAST, N=n, name=f"l2_n{n}")
    rng = np.random.RandomState(900 + n + b)
    counts = [w.launches for w in WRAPPERS.values()]
    for amount, acc, bara in _rot_cases(rng, (p.k + 1, b, n), b, n, cuda):
        acc_tr = acc.transpose(1, 2).contiguous()
        for name, (kern, plain) in tile_bench.rotation_variants(
                p, acc, bara, acc_tr).items():
            got = kern()
            torch.cuda.synchronize()
            assert torch.equal(got, plain()), (name, amount)
    assert _launched(counts) == set()


@pytest.mark.parametrize("b", [4, 5, 1024])
def test_rotations_on_an_accumulator_only_4_byte_aligned(cuda, b):
    """An accumulator one word into its allocation: no 16-byte loads
    (split) or copies (the slab); the same digits and words."""
    p = P.IEACHE_110_FAST
    rng = np.random.RandomState(b)
    for x, kern, plain, args in (
            ((p.k + 1, b, p.N), kernels.rot_diff_decompose,
             kernels.rot_diff_decompose_plain, (p,)),
            ((p.k + 1, p.N, b), kernels.rotate_sublane,
             kernels.rotate_sublane_plain, ()),
            ((p.k + 1, p.N, b), kernels.rot_diff_decompose_tr,
             kernels.rot_diff_decompose_tr_plain, (p,))):
        acc = _rand(rng, x, -2**31, 2**31, np.int32, cuda)
        off = torch.empty(acc.numel() + 1, dtype=torch.int32,
                          device=cuda)[1:].view(x)
        off.copy_(acc)
        assert off.data_ptr() % 16 == 4
        bara = _rand(rng, (b,), 0, 2 * p.N, np.int32, cuda)
        got = kern(off, bara, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(acc, bara, *args)), kern.__name__


def test_rotation_entries_refuse_bad_launches(cuda):
    """The C entry points take the launch shape they are given, and
    refuse one they cannot run: a run other than 4 or 8, N not a power of
    two or below 8; splits that do not divide N."""
    lib = kernels._build.library()
    stream = torch.cuda.current_stream().cuda_stream
    acc = torch.zeros((2, 1, 64), dtype=torch.int32, device=cuda)
    bara = torch.zeros((1,), dtype=torch.int32, device=cuda)
    d = torch.zeros((4, 1, 64), dtype=torch.int8, device=cuda)
    ptrs = (acc.data_ptr(), bara.data_ptr(), d.data_ptr())
    for n, run in ((64, 2), (64, 16), (48, 4), (4, 4), (12, 8)):
        assert lib.ieache_rot_diff_decompose(*ptrs, 2, 1, n, 8, 2, 0, run,
                                             stream) != 0
    for run in kernels.ROT_RUNS:
        assert lib.ieache_rot_diff_decompose(*ptrs, 2, 1, 64, 8, 2, 0, run,
                                             stream) == 0
    out = torch.empty_like(acc)
    for n, splits in ((64, 3), (64, -1), (64, 128), (4, 0)):
        assert lib.ieache_rotate_sublane(acc.data_ptr(), bara.data_ptr(),
                                         out.data_ptr(), 2, 1, n, splits,
                                         stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,k,n,g", [(128, 128, 128, 1), (128, 256, 384, 3),
                                     (256, 128, 128, 7),
                                     (256, 2048, 128, 2),
                                     (128, 1408, 128, 3),
                                     (128, 4096, 128, 2),
                                     (128, 512, 256, 5),
                                     (1024, 1024, 1024, 1),
                                     (1024, 1024, 1024, 512)])
def test_mm_probe_kernels_match_plain(cuda, m, k, n, g):
    """mm_s8 equal to its twin and to numpy's int64 sums truncated to
    32 bits; mm_bf16 within tolerance of float64.  The cases run the
    three kernels of each type: resident on the wide tile (s8 up to
    k = 1024, bf16 up to 512), resident on the narrow tile with k split
    over the warps (up to twice that; 1408 gives a warp an odd number
    of k-steps), and streaming."""
    ins = mosaic_mm_probe.make_inputs(m, k, n, cuda)
    a, b = ins["s8"]
    before = kernels.mm_s8.launches
    got = kernels.mm_s8(a, b, g)
    assert kernels.mm_s8.launches == before + 1
    want = kernels.mm_s8_plain(a, b, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    full = g * (a.cpu().numpy().astype(np.int64)
                @ b.cpu().numpy().astype(np.int64))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        (full & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    a, b = ins["bf16"]
    before = kernels.mm_bf16.launches
    got = kernels.mm_bf16(a, b, g)
    assert kernels.mm_bf16.launches == before + 1
    torch.cuda.synchronize()
    ref = g * (a.double() @ b.double())
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= MM_BF16_RTOL * scale
    twin = kernels.mm_bf16_plain(a, b, g)
    assert float((twin.double() - ref).abs().max()) <= MM_BF16_RTOL * scale


def test_mm_s8_kernel_wraps_like_an_int32_accumulator(cuda):
    """Extreme operands: every product entry is +-2^24 at k = 1024, so
    g = 300 passes 2^32 and the sum must wrap, not saturate."""
    a, b = mosaic_mm_probe.extreme_inputs(1024, 1024, 1024, cuda)
    g = 300
    got = kernels.mm_s8(a, b, g)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.mm_s8_plain(a, b, g))
    full = g * (a.cpu().numpy().astype(np.int64)
                @ b.cpu().numpy().astype(np.int64))
    assert np.abs(full).min() >= 2**32
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        (full & 0xFFFFFFFF).astype(np.uint32).view(np.int32))


def test_mm_probe_wrappers_refuse_bad_shapes_on_cuda(cuda):
    a = torch.zeros((128, 192), dtype=torch.int8, device=cuda)
    b = torch.zeros((192, 128), dtype=torch.int8, device=cuda)
    before = kernels.mm_s8.launches
    with pytest.raises(ValueError, match="multiples of 128"):
        kernels.mm_s8(a, b)
    with pytest.raises(ValueError):
        kernels.mm_s8(torch.zeros((128, 128), dtype=torch.int8),
                      torch.zeros((128, 128), dtype=torch.int8, device=cuda))
    assert kernels.mm_s8.launches == before


@pytest.mark.parametrize("p", [P.TEST_TINY, P.TEST_SMALL_NOISY],
                         ids=lambda p: p.name)
def test_device_keygen_and_encrypt_match_host_on_the_card(cuda, p):
    """The device keygen's arrays equal the host generator's; device
    encryption equals host encryption and stays on the card."""
    host = keygen.generate_secret_keyset(p)
    dev = keygen_device.generate_secret_keyset_device(p, cuda)
    for got, want in ((dev.lwe_key.s, host.lwe_key.s),
                      (dev.trlwe_key.coefs, host.trlwe_key.coefs),
                      (dev.cloud.bk, host.cloud.bk),
                      (dev.cloud.ks, host.cloud.ks)):
        np.testing.assert_array_equal(got, want)
    stream = prng.key_from_seed_words([8])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 300)
    got = encrypt.encrypt_bits_device(host, bits, prng.derive(stream, 1), cuda)
    assert got.is_cuda
    assert torch.equal(
        got, encrypt.encrypt_bits(host, bits, prng.derive(stream, 1), cuda))
    dec = encrypt.decrypt_bits_device(host, got)
    assert dec.is_cuda
    np.testing.assert_array_equal(dec.cpu().numpy(), bits)


# ---------------------------------------------------------------------------
# the tensor-core tile (csrc/mma_tile.cuh): external_product and
# blind_rotate_scan on random and extreme operands
# ---------------------------------------------------------------------------

MMA_BATCHES = [1, 5, 8, 16, 64, 1056]


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", MMA_BATCHES)
@pytest.mark.parametrize("with_acc", [False, True])
def test_external_product_kernel_extreme_operands(cuda, p, b, with_acc):
    """Every limb sum at its largest and smallest, the key words where a
    carry between limbs goes wrong, and random operands: equal to the
    twin, and the launch counter moves by one a call."""
    rng = np.random.RandomState(200 + b)
    shape_d = (p.trgsw_rows, b, p.N)
    shape_k = (p.trgsw_rows, p.k + 1, p.N)
    acc = (_rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
           if with_acc else None)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=cuda)

    cases = [
        (full(shape_d, -128, torch.int8), full(shape_k, LIMBS_LO, torch.int32)),
        (full(shape_d, 127, torch.int8), full(shape_k, LIMBS_HI, torch.int32)),
        (full(shape_d, -128, torch.int8), full(shape_k, LIMBS_HI, torch.int32)),
        (_rand(rng, shape_d, -128, 128, np.int8, cuda),
         _edge_key(shape_k, cuda)),
        (_rand(rng, shape_d, -128, 128, np.int8, cuda),
         _rand(rng, shape_k, -2**31, 2**31, np.int32, cuda)),
    ]
    for i, (d, bk_i) in enumerate(cases):
        before = kernels.external_product.launches
        got = kernels.external_product(d, bk_i, p, acc=acc)
        assert kernels.external_product.launches == before + 1
        want = kernels.external_product_plain(d, bk_i, p, acc)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i


@pytest.mark.parametrize("p", [P.IEACHE_110_FAST, P.IEACHE_110],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("b", [256, 257])
def test_external_product_kernel_either_side_of_the_split(cuda, p, b):
    """At N=1024, 256 lanes are 128 tiles (fewer than the SMs: each
    tile's sum is split over two blocks that add atomically) and 257
    lanes 136 tiles (one block a tile)."""
    rng = np.random.RandomState(b)
    d = _rand(rng, (p.trgsw_rows, b, p.N), -128, 128, np.int8, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 cuda)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    for a in (None, acc):
        got = kernels.external_product(d, bk_i, p, acc=a)
        want = kernels.external_product_plain(d, bk_i, p, a)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", MMA_BATCHES)
def test_blind_rotate_scan_kernel_edge_key_words(cuda, p, b):
    """The whole rotation on a key of edge words (20 steps at the full
    size), equal to the twin."""
    p = dataclasses.replace(p, n=min(p.n, 20))
    rng = np.random.RandomState(300 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, cuda)
    bk = _edge_key((p.n, p.trgsw_rows, p.k + 1, p.N), cuda)
    before = kernels.blind_rotate_scan.launches
    got = kernels.blind_rotate_scan(acc, bara, bk, p)
    assert kernels.blind_rotate_scan.launches == before + 1
    want = kernels.blind_rotate_scan_plain(acc, bara, bk, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["split", "scan", "fused2", "overlap",
                                  "overlap2"])
def test_nand_decrypts_under_the_tensor_core_modes(cuda, mode):
    """NAND through the bootstrap under the five modes on the tensor-core
    tile decrypts to the truth table, and launched the mode's kernels and
    no other."""
    from ieache_tpu_torch.boot import gates

    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, cuda)
    x = prng.uniform_bits01(prng.key_from_seed_words([5]), 37)
    y = prng.uniform_bits01(prng.key_from_seed_words([6]), 37)
    cx = encrypt.encrypt_bits(ks, x, prng.key_from_seed_words([7]), cuda)
    cy = encrypt.encrypt_bits(ks, y, prng.key_from_seed_words([8]), cuda)
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode(mode):
        out = gates.NAND(cx, cy, key)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, out), 1 - (x & y))
    assert _launched(counts) == set(MODES[mode])


@pytest.mark.parametrize("p", [
    dataclasses.replace(P.IEACHE_110_FAST, k=63, name="rows128"),
    dataclasses.replace(P.TEST_TINY, N=32, name="n32")], ids=lambda p: p.name)
def test_tensor_core_kernels_refuse_shapes_over_their_bounds(cuda, p):
    """rows * N >= 2^17 (a limb's sum could leave int32), or an N below
    64: the four wrappers on the tile raise on CUDA tensors and launch
    nothing."""
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    d = torch.zeros((rows, 1, n), dtype=torch.int8, device=cuda)
    bk = torch.zeros((1, rows, kp1, n), dtype=torch.int32, device=cuda)
    acc = torch.zeros((kp1, 1, n), dtype=torch.int32, device=cuda)
    bara = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    counts = [w.launches for w in WRAPPERS.values()]
    with pytest.raises(ValueError, match="tensor-core external product"):
        kernels.external_product(d, bk[0], p, acc=acc)
    with pytest.raises(ValueError, match="tensor-core external product"):
        kernels.blind_rotate_scan(acc, bara, bk, p)
    for step in (kernels.cmux_step, kernels.cmux_step_overlap):
        with pytest.raises(ValueError, match="tensor-core external product"):
            step(acc, bara[0], bk[0], p)
    assert _launched(counts) == set()
    # the C entry points refuse it too, whatever the wrapper checked
    lib = kernels._build.library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(acc)
    assert lib.ieache_external_product(
        d.data_ptr(), bk.data_ptr(), None, out.data_ptr(), rows, kp1, 1, n,
        stream) != 0
    for entry in (lib.ieache_cmux_step, lib.ieache_cmux_step_overlap):
        assert entry(acc.data_ptr(), bara.data_ptr(), bk.data_ptr(),
                     out.data_ptr(), rows, kp1, 1, n, p.bg_bit, p.l, 0,
                     stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("step,rows", [("cmux_step", 13),
                                       ("cmux_step_overlap", 7)])
def test_step_kernels_refuse_digit_tiles_over_shared_memory(cuda, step, rows):
    """At N=1024 a fused2 block holds one digit tile of up to 12 TRGSW
    rows and an overlap block two of up to 6: one row more is refused by
    the wrapper and by the C entry point, and the blind rotation takes
    the plain step."""
    from ieache_tpu_torch.ops.blind_rotate import blind_rotate

    p = dataclasses.replace(P.IEACHE_110_FAST, k=rows - 1, l=1, n=2,
                            name=f"rows{rows}")
    assert p.trgsw_rows == rows
    mode = "fused2" if step == "cmux_step" else "overlap"
    assert not kernels.kernels_take(mode, p)
    assert kernels.kernels_take(mode, dataclasses.replace(p, k=rows - 2))
    rng = np.random.RandomState(rows)
    acc = _rand(rng, (rows, 2, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (2, p.n), 0, 2 * p.N, np.int32, cuda)
    bk = _rand(rng, (p.n, rows, rows, p.N), -2**31, 2**31, np.int32, cuda)
    counts = [w.launches for w in WRAPPERS.values()]
    with pytest.raises(ValueError, match="shared memory"):
        getattr(kernels, step)(acc, bara[:, 0].contiguous(), bk[0], p)
    lib = kernels._build.library()
    out = torch.empty_like(acc)
    assert getattr(lib, "ieache_" + step)(
        acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), out.data_ptr(), rows,
        rows, 2, p.N, p.bg_bit, p.l, 0,
        torch.cuda.current_stream().cuda_stream) != 0
    acc0 = acc.transpose(0, 1).contiguous()
    with _step_mode(mode):
        got = blind_rotate(acc0, bara, bk, p)
    torch.cuda.synchronize()
    assert torch.equal(got, blind_rotate(acc0, bara, bk, p, plain=True))
    assert _launched(counts) == set()


#: the evaluator's cases on the card: ``A - B * C`` (multiply first, then
#: a chained subtract) with the parallel-prefix adder, 8 lanes, A of both
#: signs against B > 0 and C of both signs (B and C both negative read as
#: negative inside a chain, the JAX package's quirk): (params, width, A,
#: B, C).  "cpu" is held word for word to the port on the CPU, whose
#: kernels' plain twins take about 10 s for it at TEST_SMALL_NOISY;
#: "plain" at IEACHE_110_FAST to IEACHE_PALLAS=0 on the card (about half
#: a second a bootstrap wave)
EV_CASES = {
    "cpu": (P.TEST_SMALL_NOISY, 6, [25, -31, 7, -13, 30, -2, 11, -20],
            [3, 5, 31, 1, 17, 9, 2, 14], [7, -4, 1, -31, 12, -9, 30, -5]),
    "plain": (P.IEACHE_110_FAST, 4, [5, -7, 3, -1, 7, -4, 2, -6],
              [3, 5, 7, 1, 6, 2, 4, 7], [7, -4, 1, -7, 3, -5, 6, -2]),
}


def _evaluator_answer(case, device):
    """``A - B * C`` of ``EV_CASES[case]`` by compute_steps on
    ``device``, keys from the device keygen: (answer, decrypted lanes,
    the Python result)."""
    from ieache_tpu_torch.circuits import evaluator as ev

    p, width, *vals = EV_CASES[case]
    pair = keygen_device.generate_gate_keypair_device(p, device)
    cloud = ev.CloudEvaluator(bootstrap.pack_cloud_key(pair.main.cloud,
                                                       device), pair.nbit,
                              adder="kogge_stone")
    s = prng.key_from_seed_words([0xE5])
    steps = [(ev.OP_MUL, ("opnd", 1), ("opnd", 2)),
             (ev.OP_SUB, ("opnd", 0), ("step", 0))]
    with _env("IEACHE_DETERMINISTIC", "1"):
        ops = [ev.encrypt_operand(pair.main, pair.nbit, v, width,
                                  prng.derive(s, i), device)
               for i, v in enumerate(vals)]
        ans, _ = cloud.compute_steps(steps, ops)
    return (ans, ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB),
            [x - y * z for x, y, z in zip(*vals)])


def _same_answer(got, want):
    from ieache_tpu_torch.circuits import evaluator as ev

    assert isinstance(got, ev.Operand)
    for field in ("neg_word", "bit_word", "value", "carry_word"):
        assert torch.equal(getattr(got, field).cpu(),
                           getattr(want, field).cpu()), field


@pytest.fixture(scope="module")
def evaluator_on_cpu():
    """The port's answer to case "cpu" on the CPU, under split: the
    kernels' plain twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with _step_mode("split"):
        return _evaluator_answer("cpu", torch.device("cpu"))


@pytest.mark.parametrize("mode", ["split", "fused2", "scan"])
def test_evaluator_on_the_card_matches_the_cpu(cuda, evaluator_on_cpu, mode):
    """The evaluator under each mode of its main path on the card: every
    word of the answer equal to the port's on the CPU, the lanes right,
    the mode's kernels launched and no other."""
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode(mode):
        ans, lanes, want = _evaluator_answer("cpu", cuda)
    assert _launched(counts) == set(MODES[mode])
    ref, ref_lanes, _ = evaluator_on_cpu
    assert lanes == ref_lanes == want
    _same_answer(ans, ref)


@pytest.fixture(scope="module")
def evaluator_plain_on_card():
    """The answer to case "plain" on the card under IEACHE_PALLAS=0,
    which launches no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode("split"), _env("IEACHE_PALLAS", "0"):
        out = _evaluator_answer("plain", torch.device("cuda"))
    assert _launched(counts) == set()
    return out


@pytest.mark.parametrize("mode", ["split", "fused2", "scan"])
def test_evaluator_on_the_card_matches_the_plain_step(
        cuda, evaluator_plain_on_card, mode):
    """At IEACHE_110_FAST each mode's kernels give the plain step's
    answer on the card, every word, and the lanes decrypt right."""
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode(mode):
        ans, lanes, want = _evaluator_answer("plain", cuda)
    assert _launched(counts) == set(MODES[mode])
    ref, ref_lanes, _ = evaluator_plain_on_card
    assert lanes == ref_lanes == want
    _same_answer(ans, ref)


def test_chain_memory_analysis_on_the_card(cuda):
    """On the card the audit runs the chain: every byte count positive,
    the argument and output sizes those the CPU counts, the output size
    that of the word the chain returns, no gate counted."""
    from ieache_tpu_torch.circuits import evaluator as ev

    p = P.TEST_SMALL_NOISY
    results = {}
    for device in (torch.device("cpu"), cuda):
        pair = keygen_device.generate_gate_keypair_device(p, device)
        cloud = ev.CloudEvaluator(bootstrap.pack_cloud_key(pair.main.cloud,
                                                           device), pair.nbit)
        s = prng.key_from_seed_words([0xE6])
        ops = [ev.encrypt_operand(pair.main, pair.nbit, [3, 5, 7], 4,
                                  prng.derive(s, i), device)
               for i in range(3)]
        steps = [(ev.OP_MUL, ("opnd", 0), ("opnd", 1)),
                 (ev.OP_MUL, ("step", 0), ("opnd", 2))]
        results[device.type] = cloud.chain_memory_analysis(steps, ops)
        assert cloud.gate_count == 0
    # the output size from the plan against the result the chain returns
    result = ev._chain_exec(*cloud._chain_args(steps, ops, False)[0])
    on_card, on_cpu = results["cuda"], results["cpu"]
    assert on_card.keys() == on_cpu.keys()
    for field in ("temp_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "peak_bytes_estimate"):
        assert on_card[field] > 0, on_card
    for field in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert on_card[field] == on_cpu[field]
    assert on_cpu["temp_size_in_bytes"] == -1
    assert on_card["output_size_in_bytes"] == result.numel() * 4 \
        == 3 * 12 * (p.n + 1) * 4


# ---------------------------------------------------------------------------
# the protocol: the six-role flow and the CLI with the Cloud on the card
# ---------------------------------------------------------------------------

#: A + B - C through the in-process flow: params, width, client values
FLOW_CASE = (P.TEST_SMALL_NOISY, 6, {"A": [30, -7, 12, 1], "B": [12, 20, -9, 2],
                                     "C": [50, 3, 4, -30]})


def _flow_blobs(device):
    """``A + B - C`` through ``mp/sim.py`` with the clients and the Cloud
    on ``device`` under IEACHE_DETERMINISTIC=1: (the lanes, every operand
    and answer blob in the order the flow wrote them)."""
    from ieache_tpu_torch.mp import sim, wire

    p, width, values = FLOW_CASE
    blobs = []
    real = wire.operand_to_bytes

    def recording(*args):
        blob = real(*args)
        blobs.append(blob)
        return blob

    wire.operand_to_bytes = recording
    try:
        with _env("IEACHE_DETERMINISTIC", "1"), _step_mode("split"):
            res = sim.run_full_flow("AB+C-", values, width, p,
                                    pair=keygen.generate_gate_keypair(p),
                                    device=device)
    finally:
        wire.operand_to_bytes = real
    return res, blobs


def test_protocol_flow_on_the_card_matches_the_cpu(cuda):
    """The six-role flow with the clients and the Cloud on the card: the
    lanes right, split's kernels launched (the Cloud's spans carry them),
    and every operand blob and the answer blob byte for byte those of
    the same flow on the CPU."""
    counts = [w.launches for w in WRAPPERS.values()]
    res, blobs = _flow_blobs(cuda)
    assert _launched(counts) == set(MODES["split"])
    (chain,) = [s for s in res.cloud_spans if s["name"] == "compute_chain"]
    assert set(chain["launches"]) == set(MODES["split"])
    ref, ref_blobs = _flow_blobs(torch.device("cpu"))
    values = FLOW_CASE[2]
    assert res.values == ref.values == [
        a + b - c for a, b, c in zip(values["A"], values["B"], values["C"])]
    assert len(blobs) == len(ref_blobs) == 4
    assert blobs == ref_blobs


def test_cli_cloud_on_the_card_reads_files_made_on_the_cpu(cuda, tmp_path):
    """keygen, fixtures and encrypt on the CPU; ``cloud --device cuda``
    evaluates them on the card into an answer file byte for byte that of
    ``cloud --device cpu`` (IEACHE_DETERMINISTIC=1), and verify reads
    it."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, IEACHE_DETERMINISTIC="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    d = str(tmp_path)

    def cli(*args):
        r = subprocess.run(
            [sys.executable, "-m", "ieache_tpu_torch.cli.main", *args],
            cwd=d, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    cli("keygen", "--params", "test_tiny", "--out", d)
    for name, value in (("a", 1000), ("b", -234)):
        cli("fixtures", "--width", "32", "--value", str(value),
            "--out", os.path.join(d, f"{name}.txt"))
        cli("encrypt", "--keys", d, "--values", os.path.join(d, f"{name}.txt"),
            "--out", os.path.join(d, f"{name}.data"), "--seed", "7",
            "--device", "cpu")
    answers = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"answer_{device}.data")
        cli("cloud", os.path.join(d, "a.data"), os.path.join(d, "b.data"),
            "--keys", d, "--op", "2", "--out", out, "--device", device)
        with open(out, "rb") as f:
            answers[device] = f.read()
    assert answers["cuda"] == answers["cpu"]
    got = cli("verify", "--keys", d, "--answer",
              os.path.join(d, "answer_cuda.data"), "--op", "2")
    assert "Answer: 1234" in got


@pytest.fixture(scope="module")
def one_rank():
    """This process as the one rank of an NCCL group: one card gives one
    rank, so each sharded path runs at (1, 1)."""
    from ieache_tpu_torch.dist import launch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = launch.init(0, 1, f"127.0.0.1:{launch.free_port()}", "cuda")
    yield device
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("p", [P.TEST_TINY, P.IEACHE_110_FAST],
                         ids=lambda p: p.name)
def test_sharded_bootstraps_at_one_rank_on_the_card(one_rank, p):
    """The (1, 1) tp and sp bootstraps on NCCL equal the unsharded
    bootstrap (split, on its kernels) and launch no kernel: their steps
    are plain ops, as in the JAX package."""
    from ieache_tpu_torch.dist import mesh as dmesh
    from ieache_tpu_torch.dist import shard as dshard

    ks = keygen.generate_secret_keyset(dataclasses.replace(p, n=16))
    key = bootstrap.pack_cloud_key(ks.cloud, one_rank)
    bits = np.arange(24) % 2
    lwe = encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([9]),
                               one_rank)
    with _step_mode("split"):
        want = bootstrap.bootstrap(lwe, key)
    m, m_sp = dmesh.make_mesh(1, tp=1), dshard.make_sp_mesh(1, sp=1)
    counts = [w.launches for w in WRAPPERS.values()]
    bk, ksl = dshard.shard_cloud_key(key, m)
    got_tp = dshard.make_sharded_bootstrap(m, ks.params)(lwe, bk, ksl)
    got_sp = dshard.make_sharded_bootstrap_sp(m_sp, ks.params)(
        lwe, key.bk, key.ks_limbs)
    assert _launched(counts) == set()
    assert torch.equal(got_tp, want) and torch.equal(got_sp, want)


def test_dp_evaluator_and_pp_chain_at_one_rank_on_the_card(one_rank):
    """dist/batch.py on a (1, 1) mesh: the key replicated, the operands
    sharded, A + B - C equal to the unsharded evaluator's value word and
    decrypted right; the pp=1 chain equal to chain_unpipelined; split's
    kernels launched and no other."""
    from ieache_tpu_torch.circuits import evaluator as ev
    from ieache_tpu_torch.circuits import words
    from ieache_tpu_torch.dist import batch as dbatch
    from ieache_tpu_torch.dist import mesh as dmesh
    from ieache_tpu_torch.dist import pipeline as ppl

    p = P.TEST_TINY
    pair = keygen_device.generate_gate_keypair_device(p, one_rank)
    key = bootstrap.pack_cloud_key(pair.main.cloud, one_rank)
    s = prng.key_from_seed_words([0xD9])
    vals = ([3, -2, 5, 1], [5, 2, -7, 0], [-4, 6, 1, 3])
    ops = [ev.encrypt_operand(pair.main, pair.nbit, v, 6, prng.derive(s, i),
                              one_rank) for i, v in enumerate(vals)]
    m = dmesh.make_mesh(1, tp=1)
    counts = [w.launches for w in WRAPPERS.values()]
    with _step_mode("split"):
        want, _ = ev.CloudEvaluator(key, pair.nbit).compute_chain(
            [ev.OP_ADD, ev.OP_SUB], ops)
        ans, _ = ev.CloudEvaluator(dbatch.replicate_cloud_key(key, m),
                                   pair.nbit).compute_chain(
            [ev.OP_ADD, ev.OP_SUB], [dbatch.shard_operand(o, m) for o in ops])
        ans = dbatch.gather_operand(ans, m)
        flow0, y = (words.encrypt_word(pair.main, v, 6, prng.derive(s, 5 + i),
                                       one_rank)
                    for i, v in enumerate(([7, 3, 9, 1], [2, 5, 4, 1])))
        comps = torch.tensor([[0, 1, 0, 1]], dtype=torch.int32,
                             device=one_rank)
        piped = ppl.make_pipelined_chain(ppl.make_pp_mesh(1), p, n_micro=2)(
            flow0, y[None], comps, key.bk, key.ks_limbs)
        plain = ppl.chain_unpipelined(flow0, y[None], comps, key.bk,
                                      key.ks_limbs, p)
    assert _launched(counts) == set(MODES["split"])
    assert torch.equal(ans.value, want.value)
    assert ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB) == [
        a + b - c for a, b, c in zip(*vals)]
    assert torch.equal(piped, plain)
    assert words.decrypt_word(pair.main, piped) == [9, 62, 13, 0]


def test_dryrun_on_one_card_launches_each_modes_kernels(cuda):
    """dryrun_multichip(1) on the card, a rank process of its own: every
    decrypt assert holds, and under split, tr and scan the dp bootstrap
    launched that mode's kernels (ntt none)."""
    from ieache_tpu_torch.dist import dryrun

    (report,) = dryrun.dryrun_multichip(1, device="cuda")
    for mode in dryrun.MODES:
        assert set(report["launches"][mode]) == set(MODES[mode])
        assert all(report["launches"][mode].values()), (mode, report)
    assert set(report["batches"]) == {k for m in dryrun.MODES
                                      for k in MODES[m]}


def _four_card_rank(device, ks):
    """One of four ranks, a card each: the (2, 2) tp bootstrap at every
    overlap_chunks and the (2, 2) sp bootstrap against the unsharded
    bootstrap of the rank's dp slice."""
    from ieache_tpu_torch.dist import mesh as dmesh
    from ieache_tpu_torch.dist import shard as dshard

    key = bootstrap.pack_cloud_key(ks.cloud, device)
    stream = prng.key_from_seed_words([77])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 64)
    ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1), device)
    m = dmesh.make_mesh(4, tp=2)
    local = dshard.shard_batch(ct, m)
    want = bootstrap.bootstrap(local, key)
    bk, ksl = dshard.shard_cloud_key(key, m)
    got = {f"tp2 chunks={c}": torch.equal(dshard.make_sharded_bootstrap(
        m, ks.params, overlap_chunks=c)(local, bk, ksl), want)
        for c in (1, 2, 4)}
    m_sp = dshard.make_sp_mesh(4, sp=2)
    local = dshard.shard_batch(ct, m_sp)
    got["sp2"] = torch.equal(dshard.make_sharded_bootstrap_sp(m_sp, ks.params)(
        local, key.bk, key.ks_limbs), bootstrap.bootstrap(local, key))
    return got


@pytest.fixture
def four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")


def test_sharded_bootstraps_on_four_cards(four_cards):
    """Four ranks on NCCL, a card each: the (2, 2) tp bootstrap (all_reduce
    over NVLink, overlap_chunks 1, 2 and 4) and the (2, 2) sp bootstrap
    (all_gather) equal the unsharded bootstrap on every rank."""
    from ieache_tpu_torch.dist import launch

    ks = keygen.generate_secret_keyset(
        dataclasses.replace(P.IEACHE_110_FAST, n=16, name="l2_n16"))
    for rank, got in enumerate(launch.run(_four_card_rank, 4, ks,
                                          device="cuda", timeout=300)):
        assert all(got.values()), (rank, got)


def test_dryrun_on_four_cards(four_cards):
    """dryrun_multichip(4): the (2, 2) NAND, the (1, 4) sp NAND, the dp
    circuits, the four-stage chain (send/recv between cards) and each
    step mode's kernels on every rank."""
    from ieache_tpu_torch.dist import dryrun

    for report in dryrun.dryrun_multichip(4, device="cuda"):
        for mode in dryrun.MODES:
            assert set(report["launches"][mode]) == set(MODES[mode])
            assert all(report["launches"][mode].values()), (mode, report)
