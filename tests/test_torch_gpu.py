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
    """The kernel wrappers of every mode but split refuse the two-limb
    compat gadget; split's take it.  The blind rotation runs split's
    kernels for it and the plain step under every other mode, as the
    JAX package takes its XLA step, and equals plain=True."""
    p = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")
    rng = np.random.RandomState(5)
    acc = _rand(rng, (p.k + 1, 3, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (3,), 0, 2 * p.N, np.int32, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 cuda)
    d = kernels.rot_diff_decompose(acc, bara, p)
    assert d.shape == (2 * p.trgsw_rows, 3, p.N)
    assert torch.equal(d, kernels.rot_diff_decompose_plain(acc, bara, p))
    for step in (kernels.cmux_step, kernels.cmux_step_overlap):
        with pytest.raises(ValueError, match="single-limb"):
            step(acc, bara, bk_i, p)
    with pytest.raises(ValueError, match="single-limb"):
        kernels.rot_diff_decompose_tr(acc.transpose(1, 2).contiguous(), bara,
                                      p)
    from ieache_tpu_torch.ops.blind_rotate import blind_rotate

    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, cuda)
    bara_n = _rand(rng, (3, p.n), 0, 2 * p.N, np.int32, cuda)
    acc0 = acc.transpose(0, 1).contiguous()
    want = blind_rotate(acc0, bara_n, bk, p, plain=True)
    for mode in MODES:
        counts = [w.launches for w in WRAPPERS.values()]
        with _step_mode(mode), (pytest.warns(UserWarning)
                                if mode == "ntt"
                                else contextlib.nullcontext()):
            got = blind_rotate(acc0, bara_n, bk, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode
        assert _launched(counts) == (set(MODES[mode]) if mode == "split"
                                     else set()), mode


#: the compat gadget (Bg = 2^10, l = 2: two int8 limbs a digit) at N=1024
COMPAT = P.IEACHE_110_TFHE_COMPAT


@pytest.mark.parametrize("b", [1, 5, 64, 1056])
def test_compat_split_kernels_match_their_twins(cuda, b):
    """The two-limb rotation (8 digit rows) and the product at 8 rows,
    under the launch the policy picks and every other launch shape, equal
    their twins; an accumulator whose digits reach -512 and 511."""
    p = COMPAT
    rng = np.random.RandomState(900 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    acc[:, :, ::7] = -2**31
    acc[:, :, 1::7] = 2**31 - 1
    for bara in (_rand(rng, (b,), 0, 2 * p.N, np.int32, cuda),
                 torch.full((b,), p.N, dtype=torch.int32, device=cuda)):
        got = kernels.rot_diff_decompose(acc, bara, p)
        want = kernels.rot_diff_decompose_plain(acc, bara, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert int(want.min()) == -128 and int(want.max()) == 127
    bk_i = kernels.limb_key(_edge_key((p.trgsw_rows, p.k + 1, p.N), cuda), p)
    want = kernels.external_product_plain(got, bk_i, p, acc)
    before = kernels.external_product.launches
    assert torch.equal(kernels.external_product(got, bk_i, p, acc=acc), want)
    assert kernels.external_product.launches == before + 1
    for launch in kernels.product_launch_shapes(
            b, p.k + 1, p.N, kernels.digit_rows(p)).values():
        out = kernels.external_product_as(got, bk_i, p, acc, launch)
        torch.cuda.synchronize()
        assert torch.equal(out, want), launch


@pytest.mark.parametrize("b", [1, 1024])
def test_compat_kernel_path_equals_the_reference(cuda, graphs, monkeypatch,
                                                 b):
    """At N=1024, a few CMux steps on the kernels (the loop, the capture,
    a replay), the plain step and ``fhe_bench/reference/cmux.py`` (plain
    int64, nothing of the program) agree bit for bit; the key holds the
    edge words INT32_MIN, -1 and 2^31-1."""
    from fhe_bench.reference import cmux

    br = graphs
    p = COMPAT
    acc0, bara, bk = _rotation_case(p, b, 950 + b, cuda, steps=4)
    bk[1] = _edge_key(bk[1].shape, cuda)
    want = cmux.blind_rotate(acc0, bara, bk, p.bg_bit, p.l)
    assert torch.equal(br.blind_rotate(acc0, bara, bk, p, plain=True), want)
    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")
    limbs = kernels.limb_key(bk, p)
    gots = [br.blind_rotate(acc0, bara, bk, p, bk_limbs=limbs)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, want) for g in gots)


@pytest.mark.parametrize("b", [1, 8, 33, 272, 1024])
def test_compat_bootstrap_graphed_equals_the_plain_path(cuda, graphs, b):
    """A bootstrap at the compat gadget through a packed key: the
    rotation on split's kernels, as the loop, then a graph captured and
    replayed, 500 + 500 launches each, every answer equal to the plain
    path's; the key packs its two-limb layout once."""
    br = graphs
    p = COMPAT
    rng = np.random.RandomState(990 + b)
    bk = _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, cuda)
    ks = _rand(rng, (p.kN * p.ks_t, p.n + 1), -2**31, 2**31, np.int32,
               "cpu")
    from ieache_tpu_torch.ops.keyswitch import pack_ks_limbs

    key = bootstrap.DeviceCloudKey(bk, pack_ks_limbs(ks.numpy(), cuda), p)
    assert torch.equal(key.bk_limbs, kernels.limb_key(bk, p))
    ct = _rand(rng, (b, p.n + 1), -2**31, 2**31, np.int32, cuda)
    want = bootstrap.bootstrap(ct, key, plain=True)
    before = br.graph_counts()
    counts = [w.launches for w in WRAPPERS.values()]
    for how in ({"eager": 1}, {"eager": 1, "captures": 1},
                {"eager": 1, "captures": 1, "replays": 1}):
        with _step_mode("split"):
            got = bootstrap.bootstrap(ct, key)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert _graph_delta(before) == how
    assert [w.launches - c for w, c in zip(WRAPPERS.values(), counts)
            if w.launches != c] == [3 * p.n, 3 * p.n]


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


#: the scan kernel's batches: ragged ones, and 8, 24, 256 and 272 either
#: side of where its launch stops splitting a tile's sum into parts
SCAN_BATCHES = [1, 5, 8, 16, 24, 64, 256, 272, 1056]

#: its step counts: all n of the parameter set, and 1 to 3, the phases of
#: its turn through three buffers
SCAN_STEPS = [None, 1, 2, 3]


def _scan_call(p, acc, bara, bk):
    """The scan kernel on its inputs, held to its twin: one launch, the
    input accumulator unchanged."""
    before, acc0 = kernels.blind_rotate_scan.launches, acc.clone()
    got = kernels.blind_rotate_scan(acc, bara, bk, p)
    assert kernels.blind_rotate_scan.launches == before + 1
    want = kernels.blind_rotate_scan_plain(acc, bara, bk, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(acc, acc0)


@pytest.mark.parametrize("steps", SCAN_STEPS)
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", SCAN_BATCHES)
def test_blind_rotate_scan_kernel_matches_plain(cuda, p, b, steps):
    """All n steps of ``p``, or the first ``steps``, edge amounts in the
    first three."""
    n = p.n if steps is None else steps
    rng = np.random.RandomState(300 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (b, n), 0, 2 * p.N, np.int32, cuda)
    bara[:, :3] = torch.tensor([0, p.N, 2 * p.N - 1], dtype=torch.int32,
                               device=cuda)[:n]
    bk = _rand(rng, (n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
               np.int32, cuda)
    _scan_call(p, acc, bara, bk)


def test_blind_rotate_scan_allocates_no_digit_tensor(cuda):
    """The kernel's device memory is the accumulator's buffers and the
    grid barrier's word (one 512-byte block of the allocator): two
    buffers at B=1024 (one part a tile), three at B=8 (the parts add into
    a zeroed buffer); no (rows, B, N) int8 digit tensor."""
    p = P.IEACHE_110_FAST
    rng = np.random.RandomState(17)
    for b, buffers in ((1024, 2), (8, 3)):
        acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
        bara = _rand(rng, (b, 4), 0, 2 * p.N, np.int32, cuda)
        bk = _rand(rng, (4, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                   np.int32, cuda)
        kernels.blind_rotate_scan(acc, bara, bk, p)    # built, policy read
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        before = torch.cuda.memory_allocated(cuda)
        out = kernels.blind_rotate_scan(acc, bara, bk, p)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(cuda) - before
        assert out.nbytes <= peak <= buffers * acc.nbytes + 512, (b, peak)


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
    """At N=1024, 256 lanes are 128 tiles of the launch's 32 x 128 wgmma
    tile (fewer than the SMs: each tile's sum is split over two blocks
    that add atomically) and 257 lanes 144 tiles (one block a tile)."""
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


@pytest.mark.parametrize("p", [P.IEACHE_110_FAST, P.IEACHE_110],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("b", [1, 5, 8, 1024])
def test_external_product_every_form_and_launch(cuda, p, b):
    """Both forms of the product (csrc/external_product.cu): every launch
    shape product_launch picks from at its default split, and each wgmma
    tile whole and split over every (p, chunk) pair, through the uncounted
    entry, with and without the accumulator, on random operands and on
    key words where a carry between limbs goes wrong: equal to the twin,
    and no launch counted."""
    rng = np.random.RandomState(400 + b)
    rows, kp1 = p.trgsw_rows, p.k + 1
    d = _rand(rng, (rows, b, p.N), -128, 128, np.int8, cuda)
    acc = _rand(rng, (kp1, b, p.N), -2**31, 2**31, np.int32, cuda)
    sms = kernels._sm_count(cuda)
    shapes = dict(kernels.product_launch_shapes(b, kp1, p.N, rows, sms))
    nchunks = rows * p.N // kernels.wgmma_chunk_cols(p.N)
    for bn, cols in kernels.wgmma_tiles(p.N):
        for split in (1, nchunks):
            shapes[f"wgmma {bn} x {cols} split {split}"] = \
                kernels.product_shape(b, kp1, p.N, rows, "wgmma", bn, cols,
                                      split=split)
    assert {launch.form for launch in shapes.values()} == {"mma", "wgmma"}
    counts = [w.launches for w in WRAPPERS.values()]
    for bk_i in (_rand(rng, (rows, kp1, p.N), -2**31, 2**31, np.int32, cuda),
                 _edge_key((rows, kp1, p.N), cuda)):
        for a in (None, acc):
            want = kernels.external_product_plain(d, bk_i, p, a)
            for name, launch in shapes.items():
                got = kernels._external_product_entry(d, bk_i, p, a, launch)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, a is not None)
    assert [w.launches for w in WRAPPERS.values()] == counts


def test_external_product_entry_refuses_bad_launches(cuda):
    """The C entry takes the launch it is given and refuses what neither
    form has: an unknown form, a tile or a coefficient count the form does
    not have, a split outside 1 .. a tile's (p, chunk) pairs."""
    p = P.IEACHE_110_FAST
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    d = torch.zeros((rows, 8, n), dtype=torch.int8, device=cuda)
    bk = torch.zeros((rows, kp1, n), dtype=torch.int32, device=cuda)
    out = torch.empty((kp1, 8, n), dtype=torch.int32, device=cuda)
    lib = kernels._build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def entry(form, tile, cols, split):
        return lib.ieache_external_product(
            d.data_ptr(), bk.data_ptr(), None, out.data_ptr(), rows, kp1, 8,
            n, form, tile, cols, split, stream)

    assert entry(0, 16, 256, 1) == 0 and entry(1, 64, 128, 16) == 0
    for bad in ((2, 16, 256, 1), (0, 32, 256, 1), (0, 16, 128, 1),
                (1, 16, 128, 1), (1, 64, 256, 1), (1, 32, 128, 0),
                (1, 32, 128, 17), (0, 16, 256, 17)):
        assert entry(*bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("steps", SCAN_STEPS)
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", SCAN_BATCHES)
def test_blind_rotate_scan_kernel_edge_key_words(cuda, p, b, steps):
    """The whole rotation on a key of edge words (20 steps at the full
    size, or the first ``steps``), equal to the twin."""
    p = dataclasses.replace(p, n=min(p.n, 20) if steps is None else steps)
    rng = np.random.RandomState(300 + b)
    acc = _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, cuda)
    bk = _edge_key((p.n, p.trgsw_rows, p.k + 1, p.N), cuda)
    _scan_call(p, acc, bara, bk)


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
    for form, tile, cols in ((0, 16, min(n, 256)), (1, 32, min(n, 128))):
        assert lib.ieache_external_product(
            d.data_ptr(), bk.data_ptr(), None, out.data_ptr(), rows, kp1, 1,
            n, form, tile, cols, 1, stream) != 0
    args = (acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), out.data_ptr(),
            rows, kp1, 1, n, p.bg_bit, p.l, 0)
    for form, cluster in ((0, 1), (1, 2)):
        assert lib.ieache_cmux_step(*args, form, 1, 1, cluster, stream) != 0
    assert lib.ieache_cmux_step_overlap(*args, 0, 0, 0, stream) != 0
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
    launch = kernels.step_shape(2, rows, p.N, rows, "mma", 16)
    extra = ((0, 16, 256, launch.split, launch.per_item, launch.cluster)
             if step == "cmux_step" else (0, 0, 0))
    assert getattr(lib, "ieache_" + step)(
        acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), out.data_ptr(), rows,
        rows, 2, p.N, p.bg_bit, p.l, 0, *extra,
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


#: the parameter sets of the wgmma step's checks: 4 and 6 TRGSW rows at
#: N=1024, 8 rows with digits by shift and mask, and N=128
WG_STEP_PARAMS = [P.IEACHE_110_FAST, P.IEACHE_110,
                  dataclasses.replace(P.TEST_SMALL_NOISY, bg_bit=4, l=4,
                                      name="small_bg4"),
                  dataclasses.replace(P.TEST_TINY, N=128, name="tiny_n128")]


@pytest.mark.parametrize("p", WG_STEP_PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [8, 40, 257, 1056])
def test_cmux_step_every_form_and_launch(cuda, p, b):
    """Both forms of the fused step (csrc/cmux_step.cu): every launch
    shape step_launch picks from (mma.sync, and the wgmma tile in each
    cluster that fits), through the uncounted entry, on random operands
    and on key words where a carry between limbs goes wrong: equal to the
    twin, and no launch counted."""
    rng = np.random.RandomState(700 + b)
    rows, kp1 = p.trgsw_rows, p.k + 1
    acc = _rand(rng, (kp1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (b,), 0, 2 * p.N, np.int32, cuda)
    bara[:3] = torch.tensor([0, p.N, 2 * p.N - 1], dtype=torch.int32,
                            device=cuda)[:b]
    shapes = kernels.step_launch_shapes(b, kp1, p.N, rows,
                                        kernels._sm_count(cuda))
    assert {launch.form for launch in shapes.values()} == {"mma", "wgmma"}
    counts = [w.launches for w in WRAPPERS.values()]
    for bk_i in (_rand(rng, (rows, kp1, p.N), -2**31, 2**31, np.int32, cuda),
                 _edge_key((rows, kp1, p.N), cuda)):
        want = kernels.cmux_step_plain(acc, bara, bk_i, p)
        for name, launch in shapes.items():
            got = kernels._cmux_step_entry(acc, bara, bk_i, p, launch)
            torch.cuda.synchronize()
            assert torch.equal(got, want), name
    assert [w.launches for w in WRAPPERS.values()] == counts


@pytest.mark.parametrize("p", WG_STEP_PARAMS, ids=lambda p: p.name)
@pytest.mark.parametrize("b", [40, 272])
def test_blind_rotate_scan_every_wgmma_launch(cuda, p, b):
    """The scan kernel's wgmma form over 3 steps in each cluster that
    fits, its grid of the clusters the card holds at once and of a single
    cluster (which walks every work item), equal to the twin, its input
    unchanged."""
    p = dataclasses.replace(p, n=3)
    rng = np.random.RandomState(800 + b)
    rows, kp1 = p.trgsw_rows, p.k + 1
    acc = _rand(rng, (kp1, b, p.N), -2**31, 2**31, np.int32, cuda)
    bara = _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, cuda)
    bk = _rand(rng, (p.n, rows, kp1, p.N), -2**31, 2**31, np.int32, cuda)
    want = kernels.blind_rotate_scan_plain(acc, bara, bk, p)
    before = acc.clone()
    bn = kernels.WG_STEP_TILE
    for c in kernels.wgmma_step_clusters(bn, p.N, kp1, p.l):
        most = kernels._wgmma_clusters(cuda, "blind_rotate_scan", rows, kp1,
                                       p.N, c)
        for resident in (most, 1):
            launch = kernels.scan_wgmma_shape(b, kp1, p.N, bn, c, resident)
            got = kernels._blind_rotate_scan_entry(acc, bara, bk, p, launch)
            torch.cuda.synchronize()
            assert torch.equal(got, want), launch
    assert torch.equal(acc, before)


def test_cmux_step_entry_refuses_bad_launches(cuda):
    """The C entry takes the launch it is given and refuses what neither
    form has: an unknown form, a wgmma tile split into parts, a cluster
    that does not divide a batch tile's blocks or whose rows do not fit,
    an mma.sync split or run out of range."""
    p = P.IEACHE_110_FAST
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    acc = torch.zeros((kp1, 64, n), dtype=torch.int32, device=cuda)
    bara = torch.zeros(64, dtype=torch.int32, device=cuda)
    bk = torch.zeros((rows, kp1, n), dtype=torch.int32, device=cuda)
    out = torch.empty_like(acc)
    lib = kernels._build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def entry(*launch):
        return lib.ieache_cmux_step(
            acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), out.data_ptr(),
            rows, kp1, 64, n, p.bg_bit, p.l, 0, *launch, stream)

    assert entry(0, 4, 1, 1) == 0
    assert entry(1, 1, 1, 4) == 0 and entry(1, 1, 1, 2) == 0
    for bad in ((2, 1, 1, 1), (1, 2, 1, 4), (1, 1, 2, 4), (1, 1, 1, 3),
                (1, 1, 1, 1), (1, 1, 1, 16), (0, 17, 1, 1), (0, 1, 9, 1),
                (0, 2, 2, 1)):
        assert entry(*bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("step", ["cmux_step", "cmux_step_overlap",
                                  "blind_rotate_scan"])
def test_step_wrappers_count_no_launch_at_an_empty_batch(cuda, step):
    """At B=0 the fused steps and scan launch nothing, so their counts,
    which chip_smoke reads, stay as they were; each returns an
    accumulator of the right shape."""
    p = P.IEACHE_110_FAST
    rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
    acc = torch.zeros((kp1, 0, n), dtype=torch.int32, device=cuda)
    bk = torch.zeros((2, rows, kp1, n), dtype=torch.int32, device=cuda)
    counts = [w.launches for w in WRAPPERS.values()]
    if step == "blind_rotate_scan":
        bara = torch.zeros((0, 2), dtype=torch.int32, device=cuda)
        got = kernels.blind_rotate_scan(acc, bara, bk, p)
    else:
        bara = torch.zeros(0, dtype=torch.int32, device=cuda)
        got = getattr(kernels, step)(acc, bara, bk[0], p)
    torch.cuda.synchronize()
    assert got.shape == acc.shape and got.is_cuda
    assert _launched(counts) == set()


def test_a_span_holds_its_kernels_device_interval(cuda):
    """The tracer's clock is the profiler's: a span of the process
    tracer around one launched and synchronised ``external_product``
    contains that kernel's interval in a ``torch.profiler`` trace, each
    end of it on the epoch clock the spans read."""
    from ieache_tpu_torch.utils import trace

    p = P.IEACHE_110_FAST
    rng = np.random.RandomState(7)
    d = _rand(rng, (p.trgsw_rows, 1024, p.N), -128, 128, np.int8, cuda)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                 np.int32, cuda)
    kernels.external_product(d, bk_i, p)          # built and warm
    torch.cuda.synchronize()
    record = trace.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with trace.span("product"):
                kernels.external_product(d, bk_i, p)
                torch.cuda.synchronize()
    finally:
        trace.disable()
    (span,) = record.spans
    device = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == device and "external_product" in e.name()]
    assert len(ops) == 1, [e.name() for e in ops]
    start, end = ops[0].start_ns(), ops[0].start_ns() + ops[0].duration_ns()
    assert span["start_ns"] <= start <= end <= span["end_ns"], \
        (span["start_ns"], start, end, span["end_ns"])


# -- the blind rotation as one CUDA graph (ops/blind_rotate.py) ------------

@pytest.fixture
def graphs(monkeypatch):
    """The graph cache empty for one test, the process's own put back
    after it: a key's first rotation runs the loop, its second captures,
    later ones replay, whatever earlier tests rotated."""
    from ieache_tpu_torch.ops import blind_rotate as br

    monkeypatch.setattr(br, "_graphs", type(br._graphs)())
    monkeypatch.setattr(br, "_seen", type(br._seen)())
    return br


def _rotation_case(p, b, seed, device, steps=None):
    """Random acc0 (B, k+1, N), bara (B, steps), bk (steps, rows, k+1, N)
    on ``device``; a new ``bk`` is a new key of the graph cache."""
    rng = np.random.RandomState(seed)
    steps = p.n if steps is None else steps
    return (_rand(rng, (b, p.k + 1, p.N), -2**31, 2**31, np.int32, device),
            _rand(rng, (b, steps), 0, 2 * p.N, np.int32, device),
            _rand(rng, (steps, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                  np.int32, device))


def _loop(monkeypatch, acc0, bara, bk, p):
    """The rotation through the kernels' loop, no graph taken."""
    from ieache_tpu_torch.ops import blind_rotate as br

    with monkeypatch.context() as m:
        m.setattr(br, "_graph_stream", lambda *args: None)
        return br.blind_rotate(acc0, bara, bk, p)


def _graph_delta(before):
    """What became of the rotations since ``before`` (``graph_counts()``
    then)."""
    from ieache_tpu_torch.ops import blind_rotate as br

    return {k: v - before[k] for k, v in br.graph_counts().items()
            if v != before[k]}


def _kernel_counts(prof, names):
    """{wrapper: the kernels of a ``torch.profiler`` trace it launches}
    for the wrappers ``names``: a kernel whose name holds
    ``<wrapper>_`` as a word counts for the longest such wrapper."""
    import re

    counts = dict.fromkeys(names, 0)
    device = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != device:
            continue
        hits = [n for n in names
                if re.search(rf"(?<![A-Za-z0-9_]){n}_", e.name())]
        if hits:
            counts[max(hits, key=len)] += 1
    return counts


def _on_another_thread(fn):
    """``fn()`` on a new thread, joined: None, or the text of the
    ``RuntimeError`` it raised."""
    import threading

    raised = [None]

    def run():
        try:
            fn()
        except RuntimeError as e:
            raised[0] = str(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    return raised[0]


@pytest.mark.parametrize("p,mode,b", [
    *[(p, "split", b) for p in (P.IEACHE_110_FAST, P.IEACHE_110)
      for b in (1, 8, 272, 1024)],
    (P.IEACHE_110_FAST, "fused2", 272), (P.IEACHE_110_FAST, "tr", 8)],
    ids=lambda v: getattr(v, "name", v))
def test_graphed_rotation_equals_the_loop_and_the_plain_path(
        cuda, graphs, monkeypatch, p, mode, b):
    """At both gadgets (4 and 6 rows), a key's rotations (the loop, the
    capture, a replay) are bit for bit the kernels' loop and the plain
    path."""
    br = graphs
    acc0, bara, bk = _rotation_case(p, b, 300 + b, cuda)
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
    loop = _loop(monkeypatch, acc0, bara, bk, p)
    before = br.graph_counts()
    gots = []
    for how in ({"eager": 1}, {"eager": 1, "captures": 1},
                {"eager": 1, "captures": 1, "replays": 1}):
        gots.append(br.blind_rotate(acc0, bara, bk, p))
        assert _graph_delta(before) == how
    torch.cuda.synchronize()
    assert torch.equal(loop, want)
    assert all(torch.equal(g, want) for g in gots)


@pytest.mark.parametrize("b", [1, 1024])
def test_a_graphed_result_survives_later_replays(cuda, graphs, monkeypatch,
                                                 b):
    """A result is a copy, never the graph's output: at B=1 the caller's
    layout is the graph's too, and a replay with other inputs must leave
    the earlier answers (the capture's, a replay's) as they were."""
    br = graphs
    p = P.IEACHE_110_FAST
    acc0, bara, bk = _rotation_case(p, b, 400 + b, cuda)
    inputs = [(acc0, bara)] + [_rotation_case(p, b, 410 + b + i, cuda)[:2]
                               for i in range(3)]
    wants = [br.blind_rotate(a, x, bk, p, plain=True) for a, x in inputs]
    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")
    before = br.graph_counts()
    gots = [br.blind_rotate(a, x, bk, p) for a, x in inputs]
    torch.cuda.synchronize()
    assert _graph_delta(before) == {"eager": 1, "captures": 1, "replays": 2}
    assert all(torch.equal(g, w) for g, w in zip(gots, wants))
    assert len({g.data_ptr() for g in gots}) == 4


def test_a_second_key_at_the_same_shape_gets_its_own_answer(cuda, graphs,
                                                            monkeypatch):
    br = graphs
    p = P.IEACHE_110_FAST
    acc0, bara, bk1 = _rotation_case(p, 8, 500, cuda)
    bk2 = _rotation_case(p, 8, 501, cuda)[2]
    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")
    before = br.graph_counts()
    keys = (bk1, bk2) * 3
    got = [br.blind_rotate(acc0, bara, bk, p) for bk in keys]
    torch.cuda.synchronize()
    assert _graph_delta(before) == {"eager": 2, "captures": 2, "replays": 2}
    for g, bk in zip(got, keys):
        assert torch.equal(g, br.blind_rotate(acc0, bara, bk, p, plain=True))
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("mode", ["split", "fused2", "tr"])
def test_graph_launch_counts_move_by_the_loops_amounts(cuda, graphs,
                                                       monkeypatch, mode):
    """launch_counts() moves by what the loop launches, a launch a
    wrapper a step, over a key's first rotation, its capture and a
    replay alike; and a replay runs, under the profiler, as many
    kernels of each wrapper as the capture counted."""
    br = graphs
    p = P.IEACHE_110_FAST
    acc0, bara, bk = _rotation_case(p, 16, 600, cuda)
    monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)

    def delta(fn):
        before = kernels.launch_counts()
        fn()
        return {k: v - before[k] for k, v in kernels.launch_counts().items()
                if v != before[k]}

    loop = delta(lambda: _loop(monkeypatch, acc0, bara, bk, p))
    assert loop == {name: p.n for name in MODES[mode]}
    before = br.graph_counts()
    for _ in range(2):
        assert delta(lambda: br.blind_rotate(acc0, bara, bk, p)) == loop
    assert _graph_delta(before) == {"eager": 1, "captures": 1}
    (entry,) = br._graphs.values()
    assert dict(entry.launches) == loop
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        assert delta(lambda: br.blind_rotate(acc0, bara, bk, p)) == loop
        torch.cuda.synchronize()
    assert _graph_delta(before) == {"eager": 1, "captures": 1, "replays": 1}
    assert _kernel_counts(prof, MODES[mode]) == loop


def test_a_graph_captures_and_replays_while_another_thread_works(
        cuda, graphs, monkeypatch):
    """Another thread allocating (new sizes: cudaMalloc) and launching
    on the card breaks neither the capture (thread-local mode) nor the
    replays' answers.  (It draws from no torch generator: see
    test_a_capture_makes_other_threads_torch_cuda_draws_raise.)"""
    import threading

    br = graphs
    p = P.IEACHE_110_FAST
    acc0, bara, bk = _rotation_case(p, 64, 700, cuda)
    inputs = [(acc0, bara)] + [_rotation_case(p, 64, 701 + i, cuda)[:2]
                               for i in range(5)]
    wants = [br.blind_rotate(a, x, bk, p, plain=True) for a, x in inputs]
    torch.cuda.synchronize()
    stop, errors = threading.Event(), []

    def work():
        try:
            torch.cuda.set_device(cuda)
            size = 1 << 20
            while not stop.is_set():
                a = torch.ones(size // 256, 256, device=cuda)
                (a.t() @ a).sum()                      # (256, 256)
                torch.empty(size, dtype=torch.int8, device=cuda).fill_(1)
                size = size * 3 // 2 if size < 1 << 28 else 1 << 20
        except BaseException as e:                      # noqa: BLE001
            errors.append(e)

    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")
    thread = threading.Thread(target=work)
    thread.start()
    try:
        before = br.graph_counts()
        gots = [br.blind_rotate(a, x, bk, p) for a, x in inputs]
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    assert not errors, errors
    assert _graph_delta(before) == {"eager": 1, "captures": 1, "replays": 4}
    assert all(torch.equal(g, w) for g, w in zip(gots, wants))


def test_a_capture_makes_other_threads_torch_cuda_draws_raise(
        cuda, graphs, monkeypatch):
    """The constraint the module's docstring states, pinned: PyTorch
    registers its default CUDA generator with every capture, so while
    the port captures a rotation another thread's draw from that
    generator raises; during and between the replays draws succeed; and
    a replay on another thread while this one captures a graph of its
    own runs, and answers right."""
    import threading

    br = graphs
    p = P.IEACHE_110_FAST
    acc0, bara, bk = _rotation_case(p, 8, 900, cuda)
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")

    def draw():
        torch.randn(1 << 10, device=cuda)

    during_capture = []
    real_capture = br._capture

    def capture(run, acc_t, bara_t):
        def run_and_draw(a, x):
            out = run(a, x)                            # under the capture
            during_capture.append(_on_another_thread(draw))
            return out
        return real_capture(run_and_draw, acc_t, bara_t)

    monkeypatch.setattr(br, "_capture", capture)
    before = br.graph_counts()
    for _ in range(2):                                 # the loop, a capture
        br.blind_rotate(acc0, bara, bk, p)
    assert len(during_capture) == 1 and during_capture[0] is not None
    assert "outside graph capture" in during_capture[0], during_capture

    stop, raised, draws = threading.Event(), [], [0]

    def draw_on():
        while not stop.is_set():
            try:
                draw()
                draws[0] += 1
            except RuntimeError as e:
                raised.append(str(e))

    thread = threading.Thread(target=draw_on)
    thread.start()
    try:
        gots = [br.blind_rotate(acc0, bara, bk, p) for _ in range(10)]
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    assert not raised and draws[0] > 0, (raised[:3], draws)
    assert all(torch.equal(g, want) for g in gots)

    replayed, raised = [], []
    graph, x = torch.cuda.CUDAGraph(), torch.zeros(4, device=cuda)
    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            x.add_(1)
            raised.append(_on_another_thread(
                lambda: replayed.append(br.blind_rotate(acc0, bara, bk, p))))
        finally:
            graph.capture_end()
    torch.cuda.synchronize()
    assert raised == [None] and torch.equal(replayed[0], want), raised
    assert _graph_delta(before) == {"eager": 1, "captures": 1,
                                    "replays": 11}


def test_the_graph_engages_only_on_the_per_step_kernel_modes(cuda,
                                                            monkeypatch):
    """On CUDA tensors: split, tr, fused2, overlap and overlap2 under
    the routes auto and 1 take a graph; scan, ntt and the routes 0 and
    interpret do not, nor an empty batch or a stream already being
    captured.  Under scan and interpret the rotation counts as eager."""
    from ieache_tpu_torch.ops import blind_rotate as br

    p = P.TEST_SMALL_NOISY
    acc0, bara, bk = _rotation_case(p, 4, 800, cuda)
    for mode in br.STEP_MODES:
        for route in br.PALLAS_ROUTES:
            takes = br._graph_stream(acc0, bk, mode, route) is not None
            assert takes == (mode in br.GRAPHED_MODES
                             and route in ("auto", "1")), (mode, route)
    assert br._graph_stream(acc0[:0], bk, "split", "auto") is None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        inside = br._graph_stream(acc0, bk, "split", "auto")
        acc0.add(1)                                    # a graph not empty
    assert inside is None
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    for mode, route in (("scan", "auto"), ("split", "interpret")):
        monkeypatch.setenv("IEACHE_PALLAS_STEP", mode)
        monkeypatch.setenv("IEACHE_PALLAS", route)
        before = br.graph_counts()
        got = br.blind_rotate(acc0, bara, bk, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert _graph_delta(before) == {"eager": 1}


def test_a_fresh_process_runs_the_loop_then_captures(cuda, tmp_path):
    """A process's first rotation (the benchmark's warm-up wave) runs
    the loop, which loads the kernels, raises the shared-memory limit
    and encodes the tensor map; its second captures and its third
    replays, each equal to the plain path, under split and fused2."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "first.py"
    script.write_text(
        "import sys, torch\n"
        "from ieache_tpu_torch import params as P\n"
        "from ieache_tpu_torch.ops import blind_rotate as br\n"
        "p = P.IEACHE_110_FAST\n"
        "g = torch.Generator().manual_seed(int(sys.argv[2]))\n"
        "def r(shape, hi, lo=0):\n"
        "    return torch.randint(lo, hi, shape, generator=g,\n"
        "        dtype=torch.int64).to(torch.int32).cuda()\n"
        "acc0 = r((1024, p.k + 1, p.N), 2**31, -2**31)\n"
        "bara = r((1024, p.n), 2 * p.N)\n"
        "bk = r((p.n, p.trgsw_rows, p.k + 1, p.N), 2**31, -2**31)\n"
        "gots = [br.blind_rotate(acc0, bara, bk, p) for _ in range(3)]\n"
        "assert br.graph_counts() == {'captures': 1, 'replays': 1,\n"
        "    'eager': 1, 'evictions': 0}, br.graph_counts()\n"
        "want = br.blind_rotate(acc0, bara, bk, p, plain=True)\n"
        "assert all(torch.equal(got, want) for got in gots)\n"
        "print('ok', sys.argv[1])\n")
    env = dict(os.environ,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for seed, mode in enumerate(("split", "fused2")):
        r = subprocess.run([sys.executable, str(script), mode, str(seed)],
                           env=dict(env, IEACHE_PALLAS_STEP=mode),
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0 and f"ok {mode}" in r.stdout, \
            r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the keyswitch (csrc/keyswitch.cu) against its plain twin
# ---------------------------------------------------------------------------

KS_BATCHES = [1, 32, 33, 1024, 1025]


def _ks_operands(p, b, kind, device, seed=0):
    """(lwe_ext (B, kN+1) int32, packed key limbs) on ``device``: random
    words with the edge words first, or every word one edge word (mask
    and key a different one)."""
    from ieache_tpu_torch.ops.keyswitch import pack_ks_limbs

    rng = np.random.RandomState(seed + b)
    shape_x, shape_k = (b, p.kN + 1), (p.kN * p.ks_t, p.n + 1)
    if kind == "random":
        x = rng.randint(-2**31, 2**31, shape_x, dtype=np.int64).astype(
            np.int32)
        ks = rng.randint(-2**31, 2**31, shape_k, dtype=np.int64).astype(
            np.int32)
        x.reshape(-1)[: len(EDGE_KEY_WORDS)] = EDGE_KEY_WORDS
        ks.reshape(-1)[: len(EDGE_KEY_WORDS)] = EDGE_KEY_WORDS
    else:
        i = int(kind)
        x = np.full(shape_x, EDGE_KEY_WORDS[i], np.int32)
        ks = np.full(shape_k, EDGE_KEY_WORDS[(i + 1) % len(EDGE_KEY_WORDS)],
                     np.int32)
    return torch.from_numpy(x).to(device), pack_ks_limbs(ks, device)


@pytest.mark.parametrize("kind", ["random", "0", "1", "2", "3", "4"])
@pytest.mark.parametrize("b", KS_BATCHES)
@pytest.mark.parametrize("p", [P.TEST_SMALL_NOISY, P.IEACHE_110],
                         ids=lambda p: p.name)
def test_keyswitch_kernel_matches_its_twin(cuda, p, b, kind):
    """The kernel under the policy's launch and under every tile of
    ``keyswitch_launch_shapes`` equals ``keyswitch_plain`` bit for bit,
    on random words and on masks and keys of extreme words (INT32_MIN,
    -1, 2^31 - 1, limbs all -128 or +127): sums that wrap mod 2^32."""
    from ieache_tpu_torch.ops import keyswitch as ks

    x, limbs = _ks_operands(p, b, kind, cuda)
    want = ks.keyswitch_plain(x, limbs, p)
    got = ks.keyswitch(x, limbs, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for name, launch in kernels.keyswitch_launch_shapes(
            b, p, kernels._sm_count(cuda)).items():
        assert torch.equal(kernels.keyswitch_as(x, limbs, p, launch), want), \
            name
    for split in (1, 3):
        launch = kernels.keyswitch_shape(b, p, 64, split)
        if kernels.keyswitch_smem_bytes(
                kernels.keyswitch_cols(p), 64,
                -(-kernels.keyswitch_units(p) // split)) <= \
                kernels.SMEM_BLOCK_BYTES:
            assert torch.equal(kernels.keyswitch_as(x, limbs, p, launch),
                               want), split


def test_keyswitch_counts_its_launches_and_names_its_form(cuda):
    """One launch a call on ``keyswitch.launches``, none on the step
    wrappers that ``kernel_launches_per_job`` sums; the span's ``form``
    names the policy's launch."""
    from ieache_tpu_torch.ops import keyswitch as ks
    from ieache_tpu_torch.utils import trace

    p = P.IEACHE_110
    counts = [w.launches for w in WRAPPERS.values()]
    before = ks.keyswitch.launches
    tracer = trace.enable()
    try:
        for b in (1, 33, 1024):
            x, limbs = _ks_operands(p, b, "random", cuda)
            ks.keyswitch(x, limbs, p)
    finally:
        trace.disable()
    torch.cuda.synchronize()
    assert ks.keyswitch.launches == before + 3
    assert _launched(counts) == set()
    spans = [s for s in tracer.spans if s["name"] == "keyswitch"]
    assert [(s["lanes"], s["form"]) for s in spans] == [
        (b, kernels.keyswitch_launch(b, p, kernels._sm_count(cuda)).form)
        for b in (1, 33, 1024)]
    assert all(s["form"] != "plain" for s in spans)


def test_keyswitch_refuses_bad_operands_on_the_card(cuda):
    """Wrong dtype, shape, device, contiguity or alignment, or a shape
    the kernel refuses, raises; nothing falls back to the plain chain
    and nothing is launched."""
    from ieache_tpu_torch.ops import keyswitch as ks

    p = P.TEST_SMALL_NOISY
    x, limbs = _ks_operands(p, 3, "random", cuda)
    before = ks.keyswitch.launches
    bad = [
        (TypeError, x.to(torch.int64), limbs, p),
        (TypeError, x, limbs.to(torch.int32), p),
        (ValueError, x[:, :-1].contiguous(), limbs, p),
        (ValueError, x, limbs[:, :-2].contiguous(), p),
        (ValueError, x.cpu(), limbs, p),
        (ValueError, x, limbs.cpu(), p),
        (ValueError, torch.cat([x, x], 1)[:, ::2], limbs, p),
        (ValueError, x,
         limbs.transpose(1, 2).contiguous().transpose(1, 2), p),
    ]
    raw = torch.empty(limbs.numel() + 8, dtype=torch.int8, device=cuda)
    shifted = raw[8:].view(limbs.shape)
    shifted.copy_(limbs)
    bad.append((ValueError, x, shifted, p))
    wide = dataclasses.replace(p, ks_basebit=9, ks_t=3, name="ks9")
    xw, lw = _ks_operands(wide, 3, "random", cuda)
    bad.append((ValueError, xw, lw, wide))
    for err, *args in bad:
        with pytest.raises(err):
            ks.keyswitch(*args)
    assert ks.keyswitch.launches == before


@pytest.mark.parametrize("p", [P.TEST_SMALL_NOISY, P.IEACHE_110_FAST],
                         ids=lambda p: p.name)
def test_nand_wave_through_the_keyswitch_kernel_decrypts(cuda, p):
    """A whole NAND wave through ``boot/gates`` with keys from the device
    keygen: one keyswitch launch, its output equal to the plain path's
    (``plain=True``: plain rotation, plain keyswitch), 0 errors."""
    from ieache_tpu_torch.boot import gates
    from ieache_tpu_torch.ops import keyswitch as ks

    sk = keygen_device.generate_secret_keyset_device(p, cuda)
    key = bootstrap.pack_cloud_key(sk.cloud, cuda)
    b = 1024
    x = prng.uniform_bits01(prng.key_from_seed_words([15]), b)
    y = prng.uniform_bits01(prng.key_from_seed_words([16]), b)
    cx = encrypt.encrypt_bits_device(sk, x, prng.key_from_seed_words([17]),
                                     cuda)
    cy = encrypt.encrypt_bits_device(sk, y, prng.key_from_seed_words([18]),
                                     cuda)
    before = ks.keyswitch.launches
    out = gates.NAND(cx, cy, key)
    torch.cuda.synchronize()
    assert ks.keyswitch.launches == before + 1
    errors = int((encrypt.decrypt_bits_device(sk, out).cpu().numpy()
                  != 1 - (x & y)).sum())
    assert errors == 0
    a1, a2, beta = gates.GATE_TABLE["NAND"]
    pre = a1 * cx + a2 * cy
    pre[:, p.n] += beta
    assert torch.equal(out, bootstrap.bootstrap(pre, key, plain=True))
