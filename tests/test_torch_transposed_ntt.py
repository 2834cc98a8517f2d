"""The ``tr`` step mode's twins, the CRT-NTT core, the ``IEACHE_PALLAS``
routes and the two tools of the port, against the JAX package.

Same numpy inputs (made from a seed, with the INT32 edge values) go to
both packages.  The JAX ``tr`` Pallas kernels run with
``interpret=True``, as tests/test_pallas_kernels.py runs them.  All
arithmetic is exact (mod 2^32, or mod the NTT primes), so the tolerance
is exact equality.  The CUDA kernels themselves are held to these twins
in tests/test_torch_gpu.py and by chip_smoke.py.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.core import ntt as jntt
from ieache_tpu.core import poly as jpoly
from ieache_tpu.ops import blind_rotate as jbr
from ieache_tpu.ops.pallas_kernels import (
    external_product_pallas_tr,
    rot_diff_decompose_pallas_tr,
)
from ieache_tpu_torch.core import ntt as tntt
from ieache_tpu_torch.ops import blind_rotate as tbr
from ieache_tpu_torch.ops import kernels
from ieache_tpu_torch.tools import step_bench, transposed_probe

#: INT32_MIN, -1 and 2^31-1 and their neighbours
EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                 np.int32)

#: every wrapper's launch counter
ALL_WRAPPERS = (kernels.rot_diff_decompose, kernels.external_product,
                kernels.cmux_step, kernels.cmux_step_overlap,
                kernels.blind_rotate_scan, kernels.rot_diff_decompose_tr,
                kernels.external_product_tr, kernels.rotate_lane,
                kernels.rotate_sublane)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and torch's intra-op threads would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _env(**values):
    """Set (or, for None, unset) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_i32(rng, shape):
    x = rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return x


def _launches():
    return [w.launches for w in ALL_WRAPPERS]


# ---------------------------------------------------------------------------
# tr: the twins against the interpreted Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [8, 128])
def test_rot_diff_decompose_tr_plain_matches_pallas(b):
    p = P.TEST_TINY
    rng = np.random.RandomState(80 + b)
    acc = _rand_i32(rng, (p.k + 1, p.N, b))
    before = _launches()
    for bara in (rng.randint(0, 2 * p.N, (b,)),
                 *(np.full((b,), a) for a in (0, p.N, 2 * p.N - 1))):
        bara = bara.astype(np.int32)
        want = np.asarray(rot_diff_decompose_pallas_tr(
            jnp.asarray(acc), jnp.asarray(bara), p, interpret=True))
        got = kernels.rot_diff_decompose_tr_plain(_t(acc), _t(bara), p)
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            kernels.rot_diff_decompose_tr(_t(acc), _t(bara), p).numpy(), want)
    assert _launches() == before


@pytest.mark.parametrize("b", [8, 128])
@pytest.mark.parametrize("with_acc", [False, True])
def test_external_product_tr_plain_matches_pallas(b, with_acc):
    """Without acc the port adds nothing; JAX's kernel always adds its
    accumulator, so it gets zeros."""
    p = P.TEST_TINY
    rng = np.random.RandomState(90 + b)
    d = rng.randint(-128, 128, (p.trgsw_rows, p.N, b)).astype(np.int8)
    d.reshape(-1)[:2] = (-128, 127)
    bk_i = _rand_i32(rng, (p.trgsw_rows, p.k + 1, p.N))
    acc = (_rand_i32(rng, (p.k + 1, p.N, b)) if with_acc
           else np.zeros((p.k + 1, p.N, b), np.int32))
    want = np.asarray(external_product_pallas_tr(
        jnp.asarray(d), jnp.asarray(bk_i), p, jnp.asarray(acc),
        interpret=True))
    a = _t(acc) if with_acc else None
    before = _launches()
    got = kernels.external_product_tr_plain(_t(d), _t(bk_i), p, a)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kernels.external_product_tr(_t(d), _t(bk_i), p, acc=a).numpy(), want)
    assert _launches() == before


def test_tr_wrappers_reject_bad_inputs():
    p = P.TEST_TINY
    b = 4
    acc = torch.zeros((p.k + 1, p.N, b), dtype=torch.int32)
    bara = torch.zeros((b,), dtype=torch.int32)
    d = torch.zeros((p.trgsw_rows, p.N, b), dtype=torch.int8)
    bk_i = torch.zeros((p.trgsw_rows, p.k + 1, p.N), dtype=torch.int32)
    with pytest.raises(ValueError):      # the (k+1, B, N) layout
        kernels.rot_diff_decompose_tr(acc.transpose(1, 2).contiguous(),
                                      bara, p)
    with pytest.raises(TypeError):
        kernels.rot_diff_decompose_tr(acc.to(torch.int64), bara, p)
    with pytest.raises(ValueError):
        kernels.external_product_tr(d, bk_i, p, acc=acc[:, :, :3])
    with pytest.raises(TypeError):
        kernels.external_product_tr(d.to(torch.int32), bk_i, p)
    with pytest.raises(ValueError):
        kernels.rotate_sublane(acc.transpose(1, 2).contiguous(), bara[:3])
    with pytest.raises(ValueError, match="power of two"):
        kernels.rotate_lane(acc[:, :, :3].contiguous(),
                            torch.zeros((p.N,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the CRT-NTT core, function by function
# ---------------------------------------------------------------------------

NS = [64, 256, 1024]


@pytest.mark.parametrize("n", NS)
def test_ntt_tables_match_jax(n):
    assert tntt.PRIMES == jntt.PRIMES
    assert (tntt.R, tntt.R_BITS) == (jntt.R, jntt.R_BITS)
    assert tntt._LIMB_BIAS_NTT == jntt._LIMB_BIAS_NTT
    want, got = jntt._host_tables(n), tntt._host_tables(n)
    assert got["logn"] == want["logn"]
    assert got["crt"] == want["crt"]
    for g, w in zip(got["per"], want["per"]):
        # JAX's _dev_tables adds its device copies (``*_j``) to the cached
        # host tables once any test has run a JAX transform at this n
        assert set(g) == {key for key in w if not key.endswith("_j")}
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    dev = tntt._tables(n, "cpu")
    for i, w in enumerate(want["per"]):
        np.testing.assert_array_equal(dev["psi_br_m"][i].numpy(),
                                      w["psi_br_m"])
        assert int(dev["pinv"][i]) == w["pinv"]


def test_ntt_montgomery_primitives_at_edges():
    """_mont_mul, _add_mod and _sub_mod over every residue class edge:
    0, 1, p-1 and random residues, against the JAX uint32 primitives
    and against Python integers."""
    rng = np.random.RandomState(3)
    for per in jntt._host_tables(64)["per"]:
        p, pinv = per["p"], per["pinv"]
        vals = np.concatenate([[0, 1, 2, p // 2, p - 2, p - 1],
                               rng.randint(0, p, 58)]).astype(np.int64)
        a, b = (x.reshape(-1) for x in np.meshgrid(vals, vals))
        ja, jb = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
        ta, tb = _t(a.astype(np.int32)), _t(b.astype(np.int32))
        got = tntt._mont_mul(ta, tb, p, pinv).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jntt._mont_mul(ja, jb, p, pinv)))
        np.testing.assert_array_equal(
            got, a * b * pow(1 << 16, -1, p) % p)
        np.testing.assert_array_equal(
            tntt._add_mod(ta, tb, p).numpy(), (a + b) % p)
        np.testing.assert_array_equal(
            tntt._sub_mod(ta, tb, p).numpy(), (a - b) % p)


@functools.cache
def _ntt_case(n):
    """Inputs for the function-by-function NTT tests at length ``n``,
    and every JAX function's result on them, from one jitted chain
    (JAX's eager dispatch of the transforms' small ops takes seconds)."""
    rng = np.random.RandomState(n + 1)
    d = rng.randint(-128, 128, (3, n)).astype(np.int32)
    d[0, :2] = (-128, 127)
    g = _rand_i32(rng, (2, 3, n))
    # JAX caches its device tables in a module dict on first use: fill it
    # outside the trace, or the cache would keep tracers
    jntt._dev_tables(n)

    @jax.jit
    def chain(d, g):
        dh = jntt.ntt_forward_digits(d, n)
        gh = jntt.ntt_forward_torus_limbs(g, n)
        prod = [jntt.ntt_pointwise(dh[i], gh[i, 1, 0], i, n) for i in (0, 1)]
        inv = [jntt.ntt_inverse(prod[i], i, n) for i in (0, 1)]
        return {"dh": dh, "gh": gh, "prod": jnp.stack(prod),
                "inv": jnp.stack(inv),
                "inv_r": jnp.stack([jntt.ntt_inverse(prod[i], i, n,
                                                     extra_r=False)
                                    for i in (0, 1)]),
                "crt": jntt.crt_to_int32(inv[0], inv[1], n=n)}

    want = {k: np.asarray(v) for k, v in
            chain(jnp.asarray(d), jnp.asarray(g)).items()}
    return d, g, want


@pytest.mark.parametrize("n", NS)
def test_ntt_forward_matches_jax(n):
    d, g, want = _ntt_case(n)
    np.testing.assert_array_equal(
        tntt.ntt_forward_digits(_t(d), n).numpy(), want["dh"])
    np.testing.assert_array_equal(
        tntt.ntt_forward_torus_limbs(_t(g), n).numpy(), want["gh"])
    limbs = tntt.torus_limbs(_t(g)).numpy().astype(np.int64)
    assert limbs.min() >= -128 and limbs.max() <= 127
    recomb = sum(limbs[v] << (8 * v) for v in range(4))
    np.testing.assert_array_equal(recomb.astype(np.uint32),
                                  g.astype(np.uint32))


@pytest.mark.parametrize("n", NS)
def test_ntt_pointwise_inverse_crt_match_jax(n):
    d, g, want = _ntt_case(n)
    td = tntt.ntt_forward_digits(_t(d), n)
    tg = tntt.ntt_forward_torus_limbs(_t(g), n)
    prod = [tntt.ntt_pointwise(td[i], tg[i, 1, 0], i, n) for i in (0, 1)]
    np.testing.assert_array_equal(torch.stack(prod).numpy(), want["prod"])
    inv = [tntt.ntt_inverse(prod[i], i, n) for i in (0, 1)]
    np.testing.assert_array_equal(torch.stack(inv).numpy(), want["inv"])
    np.testing.assert_array_equal(
        torch.stack([tntt.ntt_inverse(prod[i], i, n, extra_r=False)
                     for i in (0, 1)]).numpy(), want["inv_r"])
    # both primes in one stacked inverse, as the blind rotation runs it
    np.testing.assert_array_equal(
        tntt.ntt_inverse_stack(torch.stack(prod), n).numpy(), want["inv"])
    # the forward transform inverts exactly
    for i, p in enumerate(tntt.PRIMES):
        np.testing.assert_array_equal(
            tntt.ntt_inverse(td[i], i, n, extra_r=False).numpy(),
            np.mod(d, p))
    got = tntt.crt_to_int32(inv[0], inv[1], n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want["crt"])


@pytest.mark.parametrize("n", NS)
def test_negacyclic_mul_ntt_matches_numpy_oracle(n):
    rng = np.random.RandomState(n)
    d = rng.randint(-128, 128, (4, n)).astype(np.int32)
    g = rng.randint(-2**31, 2**31, (n,)).astype(np.int32)
    want = jpoly.negacyclic_mul_np(d, g)
    np.testing.assert_array_equal(
        tntt.negacyclic_mul_ntt(_t(d), _t(g)).numpy(), want)


def test_negacyclic_mul_ntt_edge_values():
    """The cases of tests/test_ntt.py: extreme digits against INT32_MIN
    and 2^31-1, zero, and a single unit digit."""
    n = 128
    one = np.zeros((1, n), np.int32)
    one[0, 0] = 1
    cases = [
        (np.full((1, n), 127, np.int32), np.full((n,), -2**31, np.int32)),
        (np.full((1, n), -128, np.int32), np.full((n,), 2**31 - 1, np.int32)),
        (np.zeros((1, n), np.int32), np.ones((n,), np.int32)),
        (one, np.arange(n, dtype=np.int32) - n // 2),
    ]
    for d, g in cases:
        np.testing.assert_array_equal(
            tntt.negacyclic_mul_ntt(_t(d), _t(g)).numpy(),
            jpoly.negacyclic_mul_np(d, g))


def test_ntt_range_guard_raises():
    """A gadget whose limb convolutions leave the CRT range is refused,
    as in the JAX package."""
    import dataclasses

    p = dataclasses.replace(P.TEST_TINY, N=1024, l=4, name="wide")
    acc0 = torch.zeros((1, p.k + 1, p.N), dtype=torch.int32)
    bara = torch.zeros((1, 1), dtype=torch.int32)
    bk = torch.zeros((1, p.trgsw_rows, p.k + 1, p.N), dtype=torch.int32)
    with _env(IEACHE_PALLAS_STEP="ntt"):
        with pytest.raises(ValueError, match="CRT-NTT range"):
            tbr.blind_rotate(acc0, bara, bk, p)


# ---------------------------------------------------------------------------
# IEACHE_PALLAS
# ---------------------------------------------------------------------------

def _rotation_inputs(seed, b=5):
    p = P.TEST_TINY
    rng = np.random.RandomState(seed)
    return (p, _t(_rand_i32(rng, (b, p.k + 1, p.N))),
            _t(rng.randint(0, 2 * p.N, (b, p.n)).astype(np.int32)),
            _t(_rand_i32(rng, (p.n, p.trgsw_rows, p.k + 1, p.N))))


def test_pallas_0_runs_the_plain_step(monkeypatch):
    """IEACHE_PALLAS=0 runs external_product_step, the JAX package's XLA
    step, once per CMux step, in every kernel mode, and equals the
    default route."""
    p, acc0, bara, bk = _rotation_inputs(100)
    calls = []
    plain_step = tbr.external_product_step

    def counted(*args):
        calls.append(1)
        return plain_step(*args)

    want = tbr.blind_rotate(acc0, bara, bk, p)
    monkeypatch.setattr(tbr, "external_product_step", counted)
    for mode in ("split", "fused2", "overlap", "scan", "tr"):
        calls.clear()
        with _env(IEACHE_PALLAS="0", IEACHE_PALLAS_STEP=mode):
            got = tbr.blind_rotate(acc0, bara, bk, p)
        assert len(calls) == p.n, mode
        assert torch.equal(got, want), mode
    calls.clear()
    with _env(IEACHE_PALLAS=None, IEACHE_PALLAS_STEP="split"):
        tbr.blind_rotate(acc0, bara, bk, p)
    assert not calls


@pytest.mark.parametrize("route", ["0", "interpret"])
def test_pallas_routes_launch_nothing(route):
    p, acc0, bara, bk = _rotation_inputs(101)
    want = tbr.blind_rotate(acc0, bara, bk, p, plain=True)
    before = _launches()
    for mode in tbr.STEP_MODES:
        with _env(IEACHE_PALLAS=route, IEACHE_PALLAS_STEP=mode):
            assert torch.equal(tbr.blind_rotate(acc0, bara, bk, p), want)
    assert _launches() == before


def test_pallas_interpret_calls_the_twins(monkeypatch):
    """IEACHE_PALLAS=interpret reaches the mode's plain twins directly,
    never a wrapper (which would launch on a CUDA tensor)."""
    p, acc0, bara, bk = _rotation_inputs(102)
    want = tbr.blind_rotate(acc0, bara, bk, p, plain=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran")

    for name in ("rot_diff_decompose", "external_product", "cmux_step",
                 "cmux_step_overlap", "blind_rotate_scan",
                 "rot_diff_decompose_tr", "external_product_tr"):
        monkeypatch.setattr(kernels, name, refuse)
    for mode in tbr.STEP_MODES:
        with _env(IEACHE_PALLAS="interpret", IEACHE_PALLAS_STEP=mode):
            assert torch.equal(tbr.blind_rotate(acc0, bara, bk, p), want)


def test_pallas_1_on_cpu_and_unknown_values_raise():
    p, acc0, bara, bk = _rotation_inputs(103)
    for mode in ("split", "tr", "scan"):
        with _env(IEACHE_PALLAS="1", IEACHE_PALLAS_STEP=mode):
            with pytest.raises(RuntimeError, match="IEACHE_PALLAS=1"):
                tbr.blind_rotate(acc0, bara, bk, p)
    with _env(IEACHE_PALLAS="yes"):
        with pytest.raises(ValueError, match="IEACHE_PALLAS"):
            tbr.blind_rotate(acc0, bara, bk, p)
    for route in (None, "auto"):
        with _env(IEACHE_PALLAS=route):
            assert tbr.pallas_route() == "auto"
    # ntt is chosen before IEACHE_PALLAS is read, as in the JAX package
    with _env(IEACHE_PALLAS="1", IEACHE_PALLAS_STEP="ntt"):
        assert torch.equal(tbr.blind_rotate(acc0, bara, bk, p),
                           tbr.blind_rotate(acc0, bara, bk, p, plain=True))


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def test_transposed_probe_layouts_agree_with_jax():
    """Both layouts' rotations give the same array and checksum, equal
    to JAX's negacyclic_rotate_batch applied step by step."""
    steps, b, n = 6, 16, 64
    acc, acc_t, bara = transposed_probe.make_inputs(b, steps, "cpu", n=n)
    bara[:3, 0] = torch.tensor([0, n, 2 * n - 1], dtype=torch.int32)
    lane = transposed_probe.rotate_steps(kernels.rotate_lane, acc, bara)
    sub = transposed_probe.rotate_steps(kernels.rotate_sublane, acc_t, bara)
    assert torch.equal(sub, lane.transpose(1, 2))
    assert transposed_probe.checksum(lane) == transposed_probe.checksum(sub)
    want = jnp.transpose(jnp.asarray(acc.numpy()), (1, 0, 2))
    for s in range(steps):
        want = jbr.negacyclic_rotate_batch(want, jnp.asarray(bara[s].numpy()))
    np.testing.assert_array_equal(
        lane.numpy(), np.asarray(jnp.transpose(want, (1, 0, 2))))
    assert transposed_probe.checksum(lane) == int(
        np.asarray(jnp.sum(want, dtype=jnp.int32)).astype(np.int64)
        & 0xFFFFFFFF)


def test_step_bench_modes_agree_with_jax():
    """Every step mode's rotation in the tool gives one checksum, that
    of the JAX blind rotation on the same inputs."""
    p = P.TEST_TINY
    records = step_bench.run(tbr.STEP_MODES, p, 16, 5, 1, "cpu")
    assert [r["mode"] for r in records] == list(tbr.STEP_MODES)
    summary = step_bench.summary(records)
    assert summary["checksums_match"]
    assert summary["speedup_vs_split"]["split"] == 0
    acc0, bara, bk = step_bench.make_inputs(p, 16, 5, "cpu")
    with _env(IEACHE_PALLAS=None, IEACHE_PALLAS_STEP=None):
        jax.clear_caches()
        want = jbr.blind_rotate(jnp.asarray(acc0.numpy()),
                                jnp.asarray(bara.numpy()),
                                jnp.asarray(bk.numpy()), p)
    assert records[0]["checksum"] == int(
        np.asarray(jnp.sum(want, dtype=jnp.int32)).astype(np.int64)
        & 0xFFFFFFFF)
