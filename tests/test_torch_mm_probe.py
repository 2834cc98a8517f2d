"""The matmul-rate probe's plain twins and its tool, on the CPU.

The JAX tool (tools/mosaic_mm_probe.py) keeps its operands in TPU VMEM
and has no CPU form, so the twins of ``mm_s8`` and ``mm_bf16`` are held
against numpy (int64 sums truncated to int32; float64 for bf16) and, at
m = k = n = 128, g = 3, against ``jax.lax.dot_general`` with the tool's
``preferred_element_type``, repeated g times.  ``mm_s8`` is exact.
``mm_bf16`` is the one function of the port that is not: the order of
its float32 sums differs, so it is held to ``MM_BF16_RTOL`` of the
largest |o| of a float64 product of the same bf16 operands, which a
wrong fragment layout (an O(1) error) cannot meet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools import mosaic_mm_probe as probe

#: the bf16 product's tolerance, relative to max |o| of the f64 product
MM_BF16_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wrapped(a, b, g):
    """(g * (A @ B)) mod 2^32 as int32, from int64 sums."""
    full = g * (a.astype(np.int64) @ b.astype(np.int64))
    return (full & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("m,k,n,g", [(128, 128, 128, 1), (128, 256, 384, 3),
                                     (256, 128, 128, 7)])
def test_mm_s8_twin_matches_numpy(m, k, n, g):
    a, b = probe.make_inputs(m, k, n, "cpu")["s8"]
    got = kernels.mm_s8(a, b, g)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  _wrapped(a.numpy(), b.numpy(), g))
    assert torch.equal(got, kernels.mm_s8_plain(a, b, g))


def test_mm_s8_twin_wraps_like_an_int32_accumulator():
    """All-extreme operands: one product is 128 * 2^14 = 2^21 per entry,
    so g = 1100 passes 2^31 and the sum must wrap, not saturate."""
    a, b = probe.extreme_inputs(128, 128, 128, "cpu")
    g = 1100
    got = kernels.mm_s8(a, b, g).numpy()
    want = _wrapped(a.numpy(), b.numpy(), g)
    np.testing.assert_array_equal(got, want)
    assert g * 128 * 128 * 128 > 2**31 and want[0, 0] < 0 < want[0, 1]


@pytest.mark.parametrize("m,k,n,g", [(128, 128, 128, 1), (128, 256, 384, 3)])
def test_mm_bf16_twin_within_tolerance_of_float64(m, k, n, g):
    a, b = probe.make_inputs(m, k, n, "cpu")["bf16"]
    assert a.dtype == b.dtype == torch.bfloat16
    got = kernels.mm_bf16(a, b, g)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    ref = g * (a.double() @ b.double())
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= MM_BF16_RTOL, err
    # a transposed B fragment is an O(1) error, far outside the tolerance
    if k == n:
        wrong = g * (a.double() @ b.double().T)
        assert float((wrong - ref).abs().max() / ref.abs().max()) > 0.5


def test_twins_match_jax_dot_general():
    """The TPU kernel's body, on the CPU: o += dot_general(a, b) with
    the tool's preferred_element_type, g = 3 times, m = k = n = 128."""
    g = 3
    ins = probe.make_inputs(128, 128, 128, "cpu")
    dims = (((1,), (0,)), ((), ()))

    a8, b8 = ins["s8"]
    o = jnp.zeros((128, 128), jnp.int32)
    for _ in range(g):
        o = o + jax.lax.dot_general(jnp.asarray(a8.numpy()),
                                    jnp.asarray(b8.numpy()), dims,
                                    preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(kernels.mm_s8(a8, b8, g).numpy(),
                                  np.asarray(o))

    abf, bbf = ins["bf16"]
    ja = jnp.asarray(abf.float().numpy(), dtype=jnp.bfloat16)
    jb = jnp.asarray(bbf.float().numpy(), dtype=jnp.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(ja.astype(jnp.float32)), abf.float().numpy())
    o = jnp.zeros((128, 128), jnp.float32)
    for _ in range(g):
        o = o + jax.lax.dot_general(ja, jb, dims,
                                    preferred_element_type=jnp.float32)
    got = kernels.mm_bf16(abf, bbf, g).numpy()
    want = np.asarray(o)
    assert np.abs(got - want).max() <= MM_BF16_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name,dtype", [("mm_s8", torch.int8),
                                        ("mm_bf16", torch.bfloat16)])
def test_wrappers_refuse_what_the_kernels_do_not_take(name, dtype):
    mm = getattr(kernels, name)
    ok = torch.zeros((128, 128), dtype=dtype)
    before = mm.launches
    assert mm(ok, ok).shape == (128, 128)      # g defaults to 1
    for shape_a, shape_b in (((100, 128), (128, 128)),
                             ((128, 192), (192, 128)),
                             ((128, 128), (128, 64)),
                             ((0, 128), (128, 128))):
        with pytest.raises(ValueError, match="multiples of 128"):
            mm(torch.zeros(shape_a, dtype=dtype),
               torch.zeros(shape_b, dtype=dtype))
    with pytest.raises(ValueError):            # inner dimensions differ
        mm(ok, torch.zeros((256, 128), dtype=dtype))
    with pytest.raises(ValueError, match="contiguous"):
        mm(torch.zeros((128, 256), dtype=dtype)[:, ::2], ok)
    with pytest.raises(TypeError):
        mm(ok.to(torch.int32), ok)
    with pytest.raises(ValueError, match="g must be"):
        mm(ok, ok, 0)
    assert mm.launches == before               # the twins count nothing


def test_probe_tool_inputs_types_and_record_keys(monkeypatch):
    ins = probe.make_inputs(128, 256, 384, "cpu")
    assert ins["s8"][0].shape == (128, 256) and ins["s8"][1].shape == (256, 384)
    assert ins["bf16"][0].shape == (128, 256)
    # the JAX tool's first draw from its seed
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        ins["s8"][0].numpy(), rng.randint(-128, 128, (128, 256)).astype(np.int8))
    assert probe.selected("both") == ["s8", "bf16"]
    assert probe.selected("bf16") == ["bf16"]
    with pytest.raises(ValueError, match="PM_DT"):
        probe.selected("fp8")
    assert [probe.TYPES[t][0] for t in ("s8", "bf16")] == ["s8s8_s32",
                                                           "bf16_f32"]
    # the timers need the card: run() on the CPU must fail, not fall back
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            probe.run(128, 128, 128, 1, "s8", torch.device("cpu"), iters=1)
        with pytest.raises(SystemExit, match="no CUDA device"):
            probe.main()
