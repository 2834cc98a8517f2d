"""The two-limb gadget on the split kernels' path, at a small size.

A digit of the compat gadget (Bg = 2^10, l = 2) takes two int8 limbs:
``rot_diff_decompose`` writes it as two digit rows, its signed low byte
and (d - d_lo) / 2^8, and ``external_product`` runs unchanged at twice
the rows against the key with (2^8·b) mod 2^32 beside each row b.  Held
here, bit for bit, on seeded random keys and accumulators: the port's
plain step (``external_product_step``), the kernels' CPU twins and plain
models on that path, the benchmark's plain int64 reference
(``fhe_bench/reference/cmux.py``, nothing of the program) and the JAX
package's ``external_product_step``; the edge digits -512, -1, 0 and
511 and the key words INT32_MIN, -1 and 2^31-1 pinned.  The CUDA
kernels are held to the same on the card in tests/test_torch_gpu.py.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_bench import harness, limbs, roofline
from fhe_bench.reference import cmux
from ieache_tpu.ops import blind_rotate as jbr
from ieache_tpu_torch import params as P
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.core.poly import make_step_gmatrix
from ieache_tpu_torch.ops import blind_rotate as br
from ieache_tpu_torch.ops import decompose as tdec
from ieache_tpu_torch.ops import kernels, tile_models
from ieache_tpu_torch.params import TFHEParams
from ieache_tpu_torch.utils import prng, trace

#: the compat gadget at a small size, noiseless: this file's own preset
SMALL_COMPAT = TFHEParams(n=8, N=64, k=1, bg_bit=10, l=2, ks_basebit=4,
                          ks_t=4, lwe_noise_scale=0, tlwe_noise_scale=0,
                          noise_bits=1024, name="small_compat")

#: the key words at which a limb's carry goes wrong
EDGE_WORDS = (-2**31, -1, 2**31 - 1)

#: the edge digits of Bg = 2^10: its least, -1, 0 and its largest
EDGE_DIGITS = (-512, -1, 0, 511)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, lo=-2**31, hi=2**31):
    return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                            .astype(np.int32))


def _case(seed, b, p=SMALL_COMPAT, steps=None):
    """acc0 (B, k+1, N), bara (B, steps), bk (steps, rows, k+1, N); the
    first words of the key and the accumulator the edge words."""
    rng = np.random.RandomState(seed)
    steps = p.n if steps is None else steps
    acc0 = _rand(rng, (b, p.k + 1, p.N))
    bk = _rand(rng, (steps, p.trgsw_rows, p.k + 1, p.N))
    edges = torch.tensor(EDGE_WORDS, dtype=torch.int32)
    bk.view(-1)[:3 * 64] = edges.repeat(64)
    acc0.view(-1)[:3] = edges
    return acc0, _rand(rng, (b, steps), 0, 2 * p.N), bk


def test_reference_cmux_imports_nothing_of_the_program():
    code = ("import sys; import fhe_bench.reference.cmux; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=harness.ROOT).stdout
    assert not set(eval(out)) & {"ieache_tpu_torch", "ieache_tpu", "jax",
                                 "jaxlib"}


@pytest.mark.parametrize("b", [1, 5, 16])
def test_one_step_agrees_five_ways(b):
    """One CMux step: the port's plain step, the kernels' twins (rotation,
    product with the accumulator fused) and their models (the rotation's
    runs of 4 and 8, the mma.sync and wgmma tiles), the reference and
    JAX's step."""
    p = SMALL_COMPAT
    acc0, bara, bk = _case(10 + b, b, steps=1)
    want = br.external_product_step(acc0, bara[:, 0], bk[0], p)
    assert torch.equal(cmux.as_int32(cmux.cmux_step(acc0, bara[:, 0], bk[0],
                                                    p.bg_bit, p.l)), want)
    jax = jbr.external_product_step(jnp.asarray(acc0.numpy()),
                                    jnp.asarray(bara[:, 0].numpy()),
                                    jnp.asarray(bk[0].numpy()), p)
    np.testing.assert_array_equal(np.asarray(jax), want.numpy())
    acc_t = acc0.transpose(0, 1).contiguous()
    a = bara[:, 0].contiguous()
    d = kernels.rot_diff_decompose(acc_t, a, p)
    assert d.shape == (kernels.digit_rows(p), b, p.N) == (8, b, p.N)
    for run in tile_models.ROT_RUNS:
        assert torch.equal(tile_models.rot_diff_decompose_run_model(
            acc_t, a, p, run=run), d)
    key = kernels.limb_key(bk[0], p)
    got = kernels.external_product(d, key, p, acc=acc_t)
    assert torch.equal(got.transpose(0, 1), want)
    for model in (tile_models.external_product_mma_model,
                  tile_models.external_product_wgmma_model):
        assert torch.equal(model(d, key, p, acc_t), got)


@pytest.mark.parametrize("b", [1, 3])
def test_rotation_agrees_four_ways(b):
    """The whole rotation: split's twins (route auto on the CPU), the
    plain step loop, the reference and JAX's blind_rotate."""
    p = SMALL_COMPAT
    acc0, bara, bk = _case(20 + b, b)
    want = br.blind_rotate(acc0, bara, bk, p, plain=True)
    assert torch.equal(br.blind_rotate(acc0, bara, bk, p), want)
    assert torch.equal(br.blind_rotate(
        acc0, bara, bk, p, bk_limbs=kernels.limb_key(bk, p)), want)
    assert torch.equal(cmux.blind_rotate(acc0, bara, bk, p.bg_bit, p.l),
                       want)
    jax = jbr.blind_rotate(jnp.asarray(acc0.numpy()),
                           jnp.asarray(bara.numpy()),
                           jnp.asarray(bk.numpy()), p)
    np.testing.assert_array_equal(np.asarray(jax), want.numpy())


def _with_digits(digits, bg_bit, l):
    """Torus values (int64) whose l digits are ``digits`` (..., l), each
    in [-Bg/2, Bg/2): the offset taken back from their weighted sum."""
    weights = torch.tensor([1 << (32 - (j + 1) * bg_bit) for j in range(l)],
                           dtype=torch.int64)
    raw = ((digits + (1 << (bg_bit - 1))) * weights).sum(-1)
    return (raw - cmux.offset(bg_bit, l)) % (1 << 32)


def test_edge_digits_and_key_words_are_pinned():
    """Values whose digits are -512, -1, 0 and 511 at both levels: the
    reference's decomposition, the port's, its two int8 rows and the
    product of those digits with a key of INT32_MIN, -1 and 2^31-1 by
    the kernels' twin, the plain step's limb products and the
    reference."""
    p = SMALL_COMPAT
    pairs = torch.tensor([(x, y) for x in EDGE_DIGITS for y in EDGE_DIGITS],
                         dtype=torch.int64)                    # (16, 2)
    x = _with_digits(pairs, p.bg_bit, p.l)
    assert torch.equal(cmux.decompose(x, p.bg_bit, p.l), pairs)
    ported = tdec.gadget_decompose(cmux.as_int32(x), p.bg_bit, p.l)
    assert torch.equal(ported.to(torch.int64), pairs)
    lo, hi = kernels.digit_limb_rows(
        ported.t().reshape(1, 2, 16), p)[0].reshape(2, 2, 16).unbind(1)
    assert torch.equal(lo.to(torch.int64) + 256 * hi.to(torch.int64),
                       pairs.t())
    assert int(lo.min()) >= -128 and int(hi.abs().max()) <= 2
    # digits (B, rows, N): every edge digit in every row, N = 64
    d = pairs.t().reshape(1, 2, 16).repeat(1, 2, 4).to(torch.int32)
    d = torch.cat([d, d.roll(1, -1)])                          # (2, 4, 64)
    words = torch.tensor(EDGE_WORDS, dtype=torch.int32)
    key = words[torch.arange(4 * 2 * 64) % 3].reshape(4, 2, 64)
    want = cmux.as_int32(cmux.negacyclic_products(
        d.to(torch.int64), key.to(torch.int64) % (1 << 32)))
    g = make_step_gmatrix(key, p)
    assert torch.equal(br._digit_products(d, g, p), want)
    got = kernels.external_product(
        kernels.digit_limb_rows(d, p).transpose(0, 1).contiguous(),
        kernels.limb_key(key, p), p)
    assert torch.equal(got.transpose(0, 1), want)


def test_limb_key_and_digit_rows():
    """Row 2p + h of the two-limb key is (2^(8h)·b_p) mod 2^32; the
    single-limb gadget keeps its key and rows."""
    rng = np.random.RandomState(3)
    bk = _rand(rng, (2, 4, 2, 8))
    key = kernels.limb_key(bk, SMALL_COMPAT)
    assert key.shape == (2, 8, 2, 8)
    assert torch.equal(key[:, 0::2], bk)
    assert torch.equal(key[:, 1::2].to(torch.int64) % (1 << 32),
                       (bk.to(torch.int64) << 8) % (1 << 32))
    assert kernels.limb_key(bk, P.TEST_TINY) is bk
    assert kernels.digit_rows(P.IEACHE_110_FAST) == 4
    assert kernels.digit_rows(P.IEACHE_110) == 6
    assert kernels.digit_rows(P.IEACHE_110_TFHE_COMPAT) == 8


def test_two_limbs_run_under_split_alone():
    """split takes two limbs at twice the rows (8 at N=1024, far inside
    the tile's limit); every other kernel mode refuses with a reason and
    the rotation takes the plain step there."""
    assert kernels.kernels_refusal("split", 4, 1024, 2) is None
    assert kernels.kernels_take("split", P.IEACHE_110_TFHE_COMPAT)
    for mode in ("fused2", "overlap", "overlap2", "scan", "tr"):
        assert "single-limb" in kernels.kernels_refusal(mode, 4, 1024, 2)
        assert not kernels.kernels_take(mode, P.IEACHE_110_TFHE_COMPAT)
    assert "rows * N" in kernels.kernels_refusal("split", 64, 1024, 2)
    assert kernels.kernels_refusal("split", 64, 1024) is None
    assert kernels.product_launch(1, 2, 1024, 8).form == "mma"
    assert kernels.product_launch(1024, 2, 1024, 8).form == "wgmma"


def test_the_rotation_span_names_its_limbs_and_rows(monkeypatch):
    """The ``blind_rotate`` span carries ``digit_limbs`` and the ``rows``
    the kernels ran: 8 at the two-limb gadget, 4 at one."""
    monkeypatch.setenv("IEACHE_PALLAS_STEP", "split")
    trace.enable()
    try:
        for p in (SMALL_COMPAT, P.TEST_TINY):
            acc0, bara, bk = _case(40, 2, p, steps=2)
            br.blind_rotate(acc0, bara, bk, p)
        spans = [s for s in trace.recorded().spans if s["name"] == "blind_rotate"]
    finally:
        trace.disable()
    assert [(s["digit_limbs"], s["rows"], s["launches"]) for s in spans] == \
        [(2, 8, 0), (1, 4, 0)]


@pytest.mark.parametrize("steps,signed", [
    ([(4, ("opnd", 0), ("opnd", 1)), (2, ("step", 0), ("opnd", 2))], 1),
    ([(1, ("opnd", 0), ("opnd", 1)), (2, ("step", 0), ("opnd", 2))], 0),
    ([(4, ("opnd", 0), ("opnd", 1))], 0),
    ([(4, ("opnd", 0), ("opnd", 1)), (4, ("step", 0), ("opnd", 2)),
      (1, ("step", 1), ("opnd", 0))], 2)])
def test_signed_products_counts_the_chained_products(steps, signed):
    assert ev._signed_products(steps) == signed


def test_the_plan_span_names_its_signed_products():
    """``evaluator.plan`` of A*B-C carries ``signed_products`` 1, and the
    answer is the plain integers' where A and B are both negative."""
    pair = harness.make_keys(P.TEST_TINY, 2**31 + 20, torch.device("cpu"))
    evaluator = ev.CloudEvaluator(
        harness.pack_cloud_key(pair.main.cloud, torch.device("cpu")),
        pair.nbit)
    vals = ([-3, 5, -7], [-4, -6, 2], [10, 1, -2])
    s = prng.key_from_seed_words([0x5A])
    ops = [ev.encrypt_operand(pair.main, pair.nbit, v, 6, prng.derive(s, i),
                              torch.device("cpu"))
           for i, v in enumerate(vals)]
    trace.enable()
    try:
        ans, _ = evaluator.compute_steps(
            [(ev.OP_MUL, ("opnd", 0), ("opnd", 1)),
             (ev.OP_SUB, ("step", 0), ("opnd", 2))], ops)
        plans = [s for s in trace.recorded().spans if s["name"] == "evaluator.plan"]
    finally:
        trace.disable()
    assert [s["signed_products"] for s in plans] == [1]
    assert ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB) == \
        [12 - 10, -30 - 1, -14 + 2]


def test_limb_yardstick():
    """At one limb the yardstick is the roofline's; at two, 7/4 of it
    (7 limb pairs below 2^32 against 4); its bytes are the roofline's."""
    cfg = harness.Bench(harness.ROOT).config
    one = cfg("ieache_110_l2")["params"]
    two = cfg("ieache_110_tfhe_compat")["params"]
    assert limbs.limb_pairs(one) == 4 and limbs.limb_pairs(two) == 7
    assert limbs.ops_per_bootstrap(one) == roofline.ops_per_bootstrap(one)
    assert 4 * limbs.ops_per_bootstrap(two) == \
        7 * roofline.ops_per_bootstrap(two)
    assert limbs.least_seconds(one, 1024, 1024) == \
        roofline.least_seconds(one, 1024, 1024)
    # one lane: operations-bound still (58.7 GOP against 32.8 MB)
    assert limbs.least_seconds(two, 1, 1) == pytest.approx(
        limbs.ops_per_bootstrap(two) / roofline.H100["int8_ops_per_s"])


def test_the_compat_configuration_is_the_published_gadget():
    """Nothing cut: the file's sizes are tfhe-lib's λ=110 with its
    gadget, the port's preset, and its source sizes."""
    bench = harness.Bench(harness.ROOT)
    cfg = bench.config("ieache_110_tfhe_compat")
    params = TFHEParams(name=cfg["params_name"], **cfg["params"])
    assert params == P.IEACHE_110_TFHE_COMPAT
    assert cfg["reduced"] == [] and len(cfg["assumed"]) == 2
    assert {k: cfg["source_sizes"][k] for k in cfg["params"]
            if k in cfg["source_sizes"]} == \
        {k: v for k, v in cfg["params"].items() if k in cfg["source_sizes"]}
    cells = {c["name"]: c for c in bench.spec["workloads"]}
    assert cells["ieache_110_tfhe_compat.interactive_add"]["chips"] == 1
    assert cells["ieache_110_l2.interactive_mul"]["traffic"] == \
        "interactive_mul"
    assert json.loads((harness.ROOT / "fhe_bench/traffic/interactive_mul"
                       ".json").read_text())["warm_batches"] == [1, 32, 33]
