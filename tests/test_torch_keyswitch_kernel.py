"""The plain model of ``csrc/keyswitch.cu`` and its launch policy.

``tile_models.keyswitch_kernel_model`` walks the kernel's blocks at the
level of the warps' fragments (the digits in the A fragments' order,
each stage as its bulk copy leaves it, the byte transpose into B
fragments, the MMAs, Horner's shift at each limb, the epilogue's
atomic adds); it must equal ``ops/keyswitch.keyswitch_plain`` and the
JAX package's keyswitch array for array under every launch
``kernels.keyswitch_launch`` can pick, its blocks' parts added in any
order.  The kernel itself is held to ``keyswitch_plain`` on the card
(tests/test_torch_gpu.py).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.ops import keyswitch as jks
from ieache_tpu_torch import params as TP
from ieache_tpu_torch.ops import decompose, kernels, tile_models
from ieache_tpu_torch.ops import keyswitch as tks
from ieache_tpu_torch.utils import trace

PARAMS = [P.TEST_TINY, P.TEST_SMALL_NOISY]

#: the words at which a digit, a limb or a carry goes wrong
EDGES = np.array([-2**31, -1, 2**31 - 1, 0x7F7F7F7F, 0x80808080 - 2**32, 0],
                 np.int32)

#: a ragged batch: more than one 64-lane tile, the last one short
RAGGED = 70


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(p):
    return TP.TFHEParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})


def _case(p, b, seed):
    """(mask words (B, kN+1), key (K, n+1)) int32 with the edge words at
    the front of both, and the port's padded limbs of the key."""
    rng = np.random.RandomState(seed)
    lwe = rng.randint(-2**31, 2**31, (b, p.kN + 1), dtype=np.int64).astype(
        np.int32)
    ks = rng.randint(-2**31, 2**31, (p.kN * p.ks_t, p.n + 1),
                     dtype=np.int64).astype(np.int32)
    for a in (lwe, ks):
        flat = a.reshape(-1)
        flat[: len(EDGES)] = EDGES[: flat.size]
    lwe[:, 0] = EDGES[np.arange(b) % len(EDGES)]
    lwe[:, p.kN] = EDGES[(np.arange(b) + 1) % len(EDGES)]
    return lwe, ks, tks.pack_ks_limbs(ks, "cpu")


def _jax(p, lwe, ks):
    return np.asarray(jks.keyswitch(jnp.asarray(lwe), jks.pack_ks_limbs(ks),
                                    p))


@pytest.mark.parametrize("b", [1, 2, 16, 17, 33, RAGGED])
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_plain_model_equals_the_plain_chain_and_jax(p, b):
    """The policy's launch at 132 and at 8 SMs, each equal to the plain
    chain and to the JAX package's keyswitch."""
    tp = _port(p)
    lwe, ks, limbs = _case(p, b, 10 + b)
    x = torch.from_numpy(lwe)
    want = tks.keyswitch_plain(x, limbs, tp)
    np.testing.assert_array_equal(want.numpy(), _jax(p, lwe, ks))
    for sms in (132, 8):
        got = tile_models.keyswitch_kernel_model(x, limbs, tp, sms=sms)
        assert torch.equal(got, want), sms


@pytest.mark.parametrize("b", [1, 17, 33, RAGGED])
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_plain_model_under_every_launch_in_any_order(p, b):
    """Every tile of ``keyswitch_launch_shapes`` and every split from one
    slice to one a unit, the blocks' parts added in shuffled order: the
    atomic adds wrap, so the order does not matter."""
    tp = _port(p)
    lwe, _, limbs = _case(p, b, 20 + b)
    x = torch.from_numpy(lwe)
    want = tks.keyswitch_plain(x, limbs, tp)
    units = kernels.keyswitch_units(tp)
    launches = list(tile_models.keyswitch_launch_shapes(b, tp).values())
    launches += [kernels.keyswitch_shape(b, tp, 16, split)
                 for split in sorted({1, 3, units})]
    rng = random.Random(b)
    for launch in launches:
        tiles = -(-b // launch.lanes)
        order = [(s, t) for s in range(launch.split) for t in range(tiles)]
        rng.shuffle(order)
        got = tile_models.keyswitch_kernel_model(x, limbs, tp, launch,
                                                 order=order)
        assert torch.equal(got, want), launch


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_a_block_part_is_its_share_of_the_sum(p):
    """A block's part is minus its slice's rows of the product, plus the
    body in slice 0 alone; whatever the stages held before adds
    nothing."""
    tp = _port(p)
    b = 5
    lwe, _, limbs = _case(p, b, 31)
    x = torch.from_numpy(lwe)
    launch = kernels.keyswitch_shape(b, tp, 16, 3)
    d8, body = tks.keyswitch_digits(x, tp)
    units = kernels.keyswitch_units(tp)
    for s in range(3):
        u0, u1 = tile_models.keyswitch_slice(units, 3, s)
        k0 = u0 * kernels.KS_UNIT_ROWS
        k1 = min(u1 * kernels.KS_UNIT_ROWS, tp.kN * tp.ks_t)
        acc = tks.keyswitch_products(d8[:, k0:k1].contiguous(),
                                     limbs[:, k0:k1])
        want = -acc[:, : tp.n + 1].to(torch.int64)
        if s == 0:
            want[:, tp.n] += body
        parts = [tile_models.keyswitch_part_model(x, limbs, tp, launch, s, 0,
                                                  fill=fill)
                     for fill in (0x00, 0x5A, 0xFF)]
        for part in parts:
            assert torch.equal(part, want & 0xFFFFFFFF), s


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_digit_words_decode_to_the_gadget_digits(p):
    """Byte i of word [kk, mt, lane, r] is the digit of lane
    16 mt + lane / 4 + 8 (r & 1) at row 32 kk + 4 (lane % 4) +
    16 (r >> 1) + i of the slice: the A fragment's layout."""
    tp = _port(p)
    b, k0, rows = 21, 64, 96
    lwe, _, _ = _case(p, b, 41)
    x = torch.from_numpy(lwe)
    words = tile_models.keyswitch_digit_words(x, tp, 0, 32, k0, rows, 4)
    d = decompose.gadget_decompose(x[:, : tp.kN], tp.ks_basebit, tp.ks_t)
    d = d.reshape(b, -1)
    for kk, mt, ln, r, i in np.ndindex(4, 2, 32, 4, 4):
        lane = 16 * mt + ln // 4 + 8 * (r & 1)
        k = 32 * kk + 4 * (ln % 4) + 16 * (r >> 1) + i
        got = ((int(words[kk, mt, ln, r]) >> (8 * i)) & 0xFF ^ 0x80) - 0x80
        want = int(d[lane, k0 + k]) if lane < b and k < rows else 0
        assert got == want, (kk, mt, ln, r, i)


def test_key_words_are_the_transposed_key():
    """Byte i of register h of tile c, thread 4 g + q, k-step ks of warp
    w, is the staged key at row 32 ks + 16 h + 4 q + i and column
    32 w + 4 g + c."""
    m, strips = 72, 3
    rng = np.random.RandomState(5)
    stage = torch.from_numpy(rng.randint(
        0, 256, kernels.KS_UNIT_ROWS * m + kernels.KS_STAGE_PAD))
    words = tile_models.keyswitch_key_words(stage, m, strips)
    assert words.shape == (2, strips, 32, 4, 2)
    for ks, w, ln, c, h, i in np.ndindex(2, strips, 32, 4, 2, 4):
        row = 32 * ks + 16 * h + 4 * (ln % 4) + i
        col = 32 * w + 4 * (ln // 4) + c
        got = (int(words[ks, w, ln, c, h]) >> (8 * i)) & 0xFF
        assert got == int(stage[row * m + col]), (ks, w, ln, c, h, i)


def test_mma_model_is_the_matrix_product_mod_2_32():
    """The fragment layout of m16n8k32: A, B and C laid out by hand from
    PTX's tables, the product with C added, wrapping."""
    rng = np.random.RandomState(6)
    a8 = rng.randint(-128, 128, (16, 32))
    b8 = rng.randint(-128, 128, (32, 8))
    c32 = rng.randint(0, 2**32, (16, 8), dtype=np.int64)
    c32[0, 0] = 2**32 - 1                              # wraps
    a = torch.zeros((32, 4), dtype=torch.int64)
    b = torch.zeros((32, 2), dtype=torch.int64)
    c = torch.zeros((32, 4), dtype=torch.int64)
    for ln in range(32):
        g, q = divmod(ln, 4)
        for r in range(4):
            row, k = g + 8 * (r & 1), 4 * q + 16 * (r >> 1)
            a[ln, r] = sum((int(a8[row, k + i]) & 0xFF) << (8 * i)
                           for i in range(4))
            c[ln, r] = int(c32[g + 8 * (r >> 1), 2 * q + (r & 1)])
        for h in range(2):
            b[ln, h] = sum((int(b8[4 * q + 16 * h + i, g]) & 0xFF) << (8 * i)
                           for i in range(4))
    d = tile_models.mma_s8_model(a, b, c)
    want = (a8 @ b8 + c32) % 2**32
    for ln in range(32):
        g, q = divmod(ln, 4)
        for r in range(4):
            assert int(d[ln, r]) == want[g + 8 * (r >> 1), 2 * q + (r & 1)]


def test_epilogue_puts_the_columns_back_in_order():
    """Register r of tile c, thread 4 g + q, is lane g + 8 (r >> 1) of
    the tile and column 8 q + 4 (r & 1) + c of the warp's strip (tile
    c's fragment column j is the strip's column 4 j + c)."""
    acc = torch.arange(2 * 3 * 4 * 32 * 4).reshape(2, 3, 4, 32, 4)
    tile = tile_models.keyswitch_epilogue_model(acc)
    assert tile.shape == (32, 96)
    for mt, w, c, ln, r in np.ndindex(2, 3, 4, 32, 4):
        g, q = divmod(ln, 4)
        j = 2 * q + (r & 1)
        assert tile[16 * mt + g + 8 * (r >> 1), 32 * w + 4 * j + c] == \
            acc[mt, w, c, ln, r]


#: keyswitch_launch at λ=110 (K = 8192, M = 504): (lanes, split, grid)
#: by batch, on 132 SMs and on 8
PINNED = {
    132: {1: (16, 128, 128), 16: (16, 128, 128), 17: (16, 66, 132),
          32: (16, 66, 132), 33: (16, 44, 132), 64: (16, 33, 132),
          65: (32, 44, 132), 128: (32, 33, 132), 129: (64, 44, 132),
          1024: (64, 8, 128), 1025: (64, 7, 119), 1536: (64, 11, 264),
          2048: (64, 8, 256), 4096: (64, 6, 384)},
    8: {1: (16, 8, 8), 17: (16, 4, 8), 33: (16, 2, 6), 65: (32, 5, 15),
        129: (64, 8, 24), 1024: (64, 6, 96), 1025: (64, 6, 102)},
}


@pytest.mark.parametrize("sms", sorted(PINNED))
@pytest.mark.parametrize("p", [TP.IEACHE_110, TP.IEACHE_110_FAST,
                               TP.IEACHE_110_TFHE_COMPAT],
                         ids=lambda p: p.name)
def test_keyswitch_launch_pinned_by_batch(p, sms):
    """The three configurations share the keyswitch's shapes, and so its
    launches: 16 lanes a tile up to 64 lanes, 32 up to 128, 64 beyond;
    then as many K-slices as keep one block an SM, but enough that the
    slice's digits fit shared memory, and then whole waves of blocks."""
    for b, want in PINNED[sms].items():
        launch = kernels.keyswitch_launch(b, p, sms)
        assert tuple(launch) == want, b
        assert launch.form == f"{want[0]} lanes x {want[1]} slices"


@pytest.mark.parametrize("p", [TP.IEACHE_110, TP.TEST_SMALL_NOISY,
                               TP.TEST_TINY], ids=lambda p: p.name)
def test_every_launch_fits_a_block(p):
    """The launch's shared memory (ring, the largest slice's digits, or
    the epilogue's tiles) fits a block at every batch and tile, and the
    grid's y extent the card's limit."""
    m, units = kernels.keyswitch_cols(p), kernels.keyswitch_units(p)
    assert kernels.keyswitch_refusal(p, m) is None
    for sms in (132, 8):
        for b in list(range(1, 130)) + [1023, 1024, 1025, 2048, 4097]:
            for launch in [kernels.keyswitch_launch(b, p, sms),
                           *tile_models.keyswitch_launch_shapes(b, p,
                                                                sms).values()]:
                assert 1 <= launch.split <= units
                assert kernels.keyswitch_smem_bytes(
                    m, launch.lanes, -(-units // launch.split)) <= \
                    kernels.SMEM_BLOCK_BYTES
                assert launch.grid == launch.split * -(-b // launch.lanes)


def test_keyswitch_refusal():
    p = TP.TEST_TINY
    assert kernels.keyswitch_refusal(p, 16) is None
    for m in (8, 20, 520):
        assert "columns" in kernels.keyswitch_refusal(p, m)
    wide = TP.TFHEParams(**{**{f: getattr(p, f)
                               for f in p.__dataclass_fields__},
                            "ks_basebit": 9, "ks_t": 3})
    assert "int8" in kernels.keyswitch_refusal(wide, 16)


def test_wrapper_refuses_bad_operands_on_the_cpu():
    """The wrapper's checks run on every device: wrong dtype, shape or
    contiguity raises, nothing is converted."""
    p = TP.TEST_TINY
    lwe, _, limbs = _case(P.TEST_TINY, 3, 7)
    x = torch.from_numpy(lwe)
    with pytest.raises(TypeError):
        tks.keyswitch(x.to(torch.int64), limbs, p)
    with pytest.raises(TypeError):
        tks.keyswitch(x, limbs.to(torch.int32), p)
    with pytest.raises(ValueError):
        tks.keyswitch(x[:, :-1].contiguous(), limbs, p)
    with pytest.raises(ValueError):
        tks.keyswitch(x, limbs[:, :-2].contiguous(), p)
    with pytest.raises(ValueError):
        tks.keyswitch(x, limbs[..., : p.n].contiguous(), p)
    with pytest.raises(ValueError):
        tks.keyswitch(torch.cat([x, x], 1)[:, ::2], limbs, p)
    with pytest.raises(ValueError):
        tks.keyswitch(x, limbs.transpose(1, 2).contiguous().transpose(1, 2),
                      p)


def test_cpu_keyswitch_is_plain_and_counts_no_launch():
    """On CPU tensors the wrapper runs the plain chain: no launch
    counted, the span's form ``plain``; its counter is not one of the
    step wrappers that ``kernel_launches_per_job`` sums."""
    p = TP.TEST_TINY
    lwe, _, limbs = _case(P.TEST_TINY, 4, 8)
    x = torch.from_numpy(lwe)
    before = tks.keyswitch.launches
    tracer = trace.enable()
    try:
        got = tks.keyswitch(x, limbs, p)
    finally:
        trace.disable()
    assert torch.equal(got, tks.keyswitch_plain(x, limbs, p))
    assert tks.keyswitch.launches == before
    (span,) = [s for s in tracer.spans if s["name"] == "keyswitch"]
    assert span["form"] == "plain" and span["lanes"] == 4
    assert "keyswitch" not in kernels.WRAPPERS
    assert "keyswitch" not in kernels.launch_counts()
