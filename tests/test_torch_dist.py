"""The port's distribution layer against the JAX package's, on the CPU.

Counterparts of tests/test_dist.py: the (dp, tp) mesh and its refusals,
the tp-sharded bootstrap (tp = 2 and 4, overlap_chunks 1, 2 and 4, and
tp = 2 at the full N=1024 geometry), the sp-sharded bootstrap (sp = 2
and 4), the dp-sharded evaluator and the uneven batch refused; and, new
here, ``make_step_gmatrix_local`` for every shard,
``external_product_step_sharded`` against JAX's under ``shard_map``, and
int32 sums over ranks that wrap at the edge values.  The same
numpy-seeded inputs go to both packages; every array must be equal.

The ranks are four gloo processes (``dist/launch.py``), one process
group for the whole module, started once by a fixture that runs every
check and hands the results to the tests.  A spawned rank imports this
module to find its program, so JAX is imported only inside the fixtures
that compute the references: a rank imports no JAX.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.boot.bootstrap import DeviceCloudKey
from ieache_tpu_torch.circuits import evaluator as tev
from ieache_tpu_torch.core.poly import make_step_gmatrix
from ieache_tpu_torch.dist import batch as dbatch
from ieache_tpu_torch.dist import launch
from ieache_tpu_torch.dist import mesh as dmesh
from ieache_tpu_torch.dist import shard as dshard
from ieache_tpu_torch.ops import blind_rotate as tbr

WORLD = 4
#: tests/test_dist.py's full geometry: IEACHE_110_FAST with n cut to 32
FULLGEO = dataclasses.replace(P.IEACHE_110_FAST, n=32, name="fullgeo_l2")
#: the two-limb gadget (Bg = 2^10) at TEST_TINY's size
TINY_COMPAT = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")
#: external_product_step_sharded's cases: (tp, parameter set)
EP_CASES = ((2, P.TEST_TINY), (4, P.TEST_TINY), (2, TINY_COMPAT))
#: int32 edge values summed over the ranks
EDGES = np.array([2**31 - 1, -2**31, -1, 864197523, 0], np.int32)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _key(arrays, p, device):
    return bootstrap.from_jax_cloud_key(arrays, p, device)


def _tp_boot(m, key, ct, p, chunks=2):
    """The (dp, tp)-sharded bootstrap of ``ct``, gathered over dp."""
    fn = dshard.make_sharded_bootstrap(m, p, overlap_chunks=chunks)
    bk, ksl = dshard.shard_cloud_key(key, m)
    out = fn(dshard.shard_batch(torch.from_numpy(ct), m), bk, ksl)
    return dmesh.all_gather_cat(out, m.group("dp"), 0).numpy()


def _sp_boot(sp, key, ct, p):
    m = dshard.make_sp_mesh(WORLD, sp=sp)
    out = dshard.make_sharded_bootstrap_sp(m, p)(
        dshard.shard_batch(torch.from_numpy(ct), m), key.bk, key.ks_limbs)
    return m.shape, dmesh.all_gather_cat(out, m.group("dp"), 0).numpy()


def _ranks(device, inp):
    """Every rank's program: the results of all the module's checks."""
    r = {"rank": dist.get_rank()}
    tiny = P.TEST_TINY
    key = _key(inp["tiny_key"], tiny, device)

    m22 = dmesh.make_mesh(WORLD, tp=2)
    m14 = dmesh.make_mesh(WORLD, tp=4)
    m21 = dmesh.make_mesh(2, tp=2)
    r["mesh_shapes"] = [m22.shape, m14.shape, m21.shape]
    r["coordinates"] = [m22.coordinate, m21.coordinate]
    r["mesh_refusals"] = [_raises(lambda: dmesh.make_mesh(8, tp=2)),
                          _raises(lambda: dmesh.make_mesh(WORLD, tp=3)),
                          _raises(lambda: dshard.make_sp_mesh(WORLD, 3))]
    m33 = dmesh.make_mesh(3, tp=3)
    r["boot_refusals"] = [
        _raises(lambda: dshard.make_sharded_bootstrap(m33, tiny)),
        _raises(lambda: dshard.make_sharded_bootstrap_sp(
            dshard.make_sp_mesh(3, 3), tiny))]

    r["tp2"] = _tp_boot(m22, key, inp["ct16"], tiny)
    r["tp4"] = _tp_boot(m14, key, inp["ct8"], tiny)
    r["chunks"] = {c: _tp_boot(m22, key, inp["ct16"], tiny, chunks=c)
                   for c in (1, 2, 4)}
    r["fullgeo"] = _tp_boot(m22, _key(inp["full_key"], FULLGEO, device),
                            inp["ct_full"], FULLGEO)
    r["sp"] = {sp: _sp_boot(sp, key, inp["ct8"], tiny) for sp in (2, 4)}

    # the dp-sharded evaluator: ranks other than the first start from a
    # zeroed key, which replicate_cloud_key must overwrite
    m41 = dmesh.make_mesh(WORLD, tp=1)
    mine = key if dist.get_rank() == 0 else DeviceCloudKey(
        torch.zeros_like(key.bk), torch.zeros_like(key.ks_limbs), tiny)
    cloud = tev.CloudEvaluator(dbatch.replicate_cloud_key(mine, m41),
                               inp["nbit"])
    a, b, short = (tev.Operand(*map(torch.from_numpy, arrays))
                   for arrays in inp["operands"])
    ans, _ = cloud.compute(tev.OP_ADD, dbatch.shard_operand(a, m41),
                           dbatch.shard_operand(b, m41))
    r["dp_value"] = dbatch.gather_operand(ans, m41).value.numpy()
    r["uneven_refused"] = [
        _raises(lambda: dbatch.shard_operand(short, m41)),
        _raises(lambda: dshard.shard_batch(short.value, m41))]

    r["ep_step"] = []
    for tp, p in EP_CASES:
        acc, bara_i, bk_i = inp["ep_inputs"][(tp, p.name)]
        m = dmesh.make_mesh(tp, tp=tp)
        got = None
        if m.coordinate is not None:
            rows = bk_i.shape[0] // tp
            t = m.index("tp")
            got = tbr.external_product_step_sharded(
                torch.from_numpy(acc), torch.from_numpy(bara_i),
                torch.from_numpy(bk_i[t * rows:(t + 1) * rows]), p,
                m.group("tp")).numpy()
        r["ep_step"].append(got)

    x = torch.from_numpy(EDGES.copy())
    dist.all_reduce(x)
    y = torch.from_numpy(EDGES * np.int32(dist.get_rank() + 1))
    dist.all_reduce(y, async_op=True).wait()
    r["sums"] = (x.numpy(), y.numpy())
    return r


def _bits(seed, count):
    from ieache_tpu.utils import prng as jprng

    return np.asarray(jprng.uniform_bits01(jprng.key_from_seed_words([seed]),
                                           count))


@pytest.fixture(scope="module")
def refs():
    """The inputs, from numpy seeds and the JAX package's keygen and
    encryption, and the JAX package's arrays for each check."""
    import jax.numpy as jnp

    import ieache_tpu.boot.bootstrap as JB
    from ieache_tpu import params as JP
    from ieache_tpu.circuits import evaluator as jev
    from ieache_tpu.dist import mesh as jmesh
    from ieache_tpu.dist import shard as jshard
    from ieache_tpu.lwe import encrypt as jenc
    from ieache_tpu.lwe import keygen as jkeygen
    from ieache_tpu.utils import prng as jprng

    ks = jkeygen.generate_secret_keyset(JP.TEST_TINY)
    dck = JB.pack_cloud_key(ks.cloud)
    bits16, bits8 = _bits(3, 16), np.array([0, 1, 1, 0, 1, 1, 0, 0])
    ct16 = np.asarray(jenc.encrypt_bits(ks, bits16,
                                        jprng.key_from_seed_words([4])))
    ct8 = np.asarray(jenc.encrypt_bits(ks, bits8,
                                       jprng.key_from_seed_words([5])))
    m = jmesh.make_mesh(8, tp=2)
    bk, ksl = jshard.shard_cloud_key(dck, m)
    jax_tp2 = np.asarray(jshard.make_sharded_bootstrap(m, JP.TEST_TINY)(
        jshard.shard_batch(jnp.asarray(ct16), m), bk, ksl))
    jax_sp4 = np.asarray(jshard.make_sharded_bootstrap_sp(
        jshard.make_sp_mesh(8, sp=4), JP.TEST_TINY)(
            jnp.asarray(ct8), dck.bk, dck.ks_limbs))

    pf = dataclasses.replace(JP.IEACHE_110_FAST, n=32, name="fullgeo_l2")
    ks_full = jkeygen.generate_secret_keyset(pf)
    dck_full = JB.pack_cloud_key(ks_full.cloud)
    ct_full = np.asarray(jenc.encrypt_bits(ks_full, bits8,
                                           jprng.key_from_seed_words([6])))

    pair = jkeygen.generate_gate_keypair(JP.TEST_TINY)
    rng = np.random.RandomState(7)
    a_vals, b_vals = rng.randint(1, 50, 16), rng.randint(1, 50, 16)
    s = jprng.key_from_seed_words([0xD9])
    ja, jb = (jev.encrypt_operand(pair.main, pair.nbit, v, 8,
                                  jprng.derive(s, i))
              for i, v in enumerate((a_vals, b_vals)))
    jshort = jev.encrypt_operand(pair.main, pair.nbit, [1, 2, 3], 8,
                                 jprng.derive(s, 2))
    dck_pair = JB.pack_cloud_key(pair.main.cloud)
    jans, _ = jev.CloudEvaluator(dck_pair, pair.nbit).compute(jev.OP_ADD,
                                                              ja, jb)

    def operand_arrays(o):
        return tuple(np.asarray(getattr(o, f.name))
                     for f in dataclasses.fields(tev.Operand))

    ep_inputs, ep_want = {}, []
    rng = np.random.RandomState(41)
    for tp, p in EP_CASES:
        jp = dataclasses.replace(JP.TEST_TINY, bg_bit=p.bg_bit, name=p.name)
        acc = rng.randint(-2**31, 2**31, (5, p.k + 1, p.N)).astype(np.int32)
        bara_i = rng.randint(0, 2 * p.N, 5).astype(np.int32)
        bk_i = rng.randint(-2**31, 2**31,
                           (p.trgsw_rows, p.k + 1, p.N)).astype(np.int32)
        ep_inputs[(tp, p.name)] = (acc, bara_i, bk_i)
        ep_want.append(_jax_ep_step(acc, bara_i, bk_i, jp, tp))

    return {
        "inputs": {
            "tiny_key": (np.asarray(dck.bk), np.asarray(dck.ks_limbs)),
            "ct16": ct16, "ct8": ct8,
            "full_key": (np.asarray(dck_full.bk),
                         np.asarray(dck_full.ks_limbs)),
            "ct_full": ct_full,
            "nbit": bootstrap.from_jax_keyset(pair.nbit),
            "operands": [operand_arrays(o) for o in (ja, jb, jshort)],
            "ep_inputs": ep_inputs,
        },
        "bits16": bits16, "bits8": bits8,
        "ref16": np.asarray(JB.bootstrap(jnp.asarray(ct16), dck)),
        "ref8": np.asarray(JB.bootstrap(jnp.asarray(ct8), dck)),
        "ref_full": np.asarray(JB.bootstrap(jnp.asarray(ct_full), dck_full)),
        "jax_tp2": jax_tp2, "jax_sp4": jax_sp4,
        "ks": ks, "ks_full": ks_full,
        "dp_value": np.asarray(jans.value),
        "dp_sums": [int(x) + int(y) for x, y in zip(a_vals, b_vals)],
        "pair": pair, "jans": jans,
        "ep_want": ep_want,
    }


def _jax_ep_step(acc, bara_i, bk_i, p, tp):
    """JAX's external_product_step_sharded under shard_map, on a (1, tp)
    mesh, bk_i's rows sharded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from ieache_tpu.dist import mesh as jmesh
    from ieache_tpu.dist import shard as jshard
    from ieache_tpu.ops import blind_rotate as jbr

    fn = jshard.shard_map(
        lambda a, b, k: jbr.external_product_step_sharded(a, b, k, p, "tp"),
        mesh=jmesh.make_mesh(tp, tp=tp),
        in_specs=(PS(), PS(), PS("tp", None, None)), out_specs=PS())
    return np.asarray(jax.jit(fn)(jnp.asarray(acc), jnp.asarray(bara_i),
                                  jnp.asarray(bk_i)))


@pytest.fixture(scope="module")
def ranks(refs):
    """The four ranks' results (one process group for the module); the
    ranks agree on every gathered array."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = launch.run(_ranks, WORLD, refs["inputs"], device="cpu",
                         timeout=300)
    finally:
        torch.set_num_threads(n)
    assert [r["rank"] for r in out] == list(range(WORLD))
    for r in out[1:]:
        np.testing.assert_array_equal(r["tp2"], out[0]["tp2"])
        np.testing.assert_array_equal(r["dp_value"], out[0]["dp_value"])
    return out


def test_mesh_shapes_and_refusals(ranks):
    first = ranks[0]
    assert first["mesh_shapes"] == [{"dp": 2, "tp": 2}, {"dp": 1, "tp": 4},
                                    {"dp": 1, "tp": 2}]
    assert [r["coordinates"][0] for r in ranks] == [
        {"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}, {"dp": 1, "tp": 0},
        {"dp": 1, "tp": 1}]
    # a mesh over the first two ranks: the others are outside it
    assert [r["coordinates"][1] is None for r in ranks] == [False, False,
                                                            True, True]
    assert all(all(r["mesh_refusals"]) for r in ranks)
    assert all(all(r["boot_refusals"]) for r in ranks)


def test_sharded_bootstrap_tp2_matches_jax(ranks, refs):
    from ieache_tpu.lwe import encrypt as jenc

    got = ranks[0]["tp2"]
    np.testing.assert_array_equal(got, refs["jax_tp2"])
    np.testing.assert_array_equal(got, refs["ref16"])
    np.testing.assert_array_equal(jenc.decrypt_bits(refs["ks"], got),
                                  refs["bits16"])


def test_sharded_bootstrap_tp2_equals_the_unsharded_port(ranks, refs):
    key = bootstrap.from_jax_cloud_key(refs["inputs"]["tiny_key"],
                                       P.TEST_TINY, "cpu")
    want = bootstrap.bootstrap(torch.from_numpy(refs["inputs"]["ct16"]), key)
    np.testing.assert_array_equal(ranks[0]["tp2"], want.numpy())


def test_sharded_bootstrap_tp4(ranks, refs):
    from ieache_tpu.lwe import encrypt as jenc

    got = ranks[0]["tp4"]
    np.testing.assert_array_equal(got, refs["ref8"])
    np.testing.assert_array_equal(jenc.decrypt_bits(refs["ks"], got),
                                  refs["bits8"])


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_sharded_bootstrap_tp_overlap_chunks_bit_exact(ranks, refs, chunks):
    np.testing.assert_array_equal(ranks[0]["chunks"][chunks], refs["ref16"])


def test_sharded_bootstrap_tp2_full_geometry(ranks, refs):
    from ieache_tpu.lwe import encrypt as jenc

    got = ranks[0]["fullgeo"]
    np.testing.assert_array_equal(got, refs["ref_full"])
    np.testing.assert_array_equal(jenc.decrypt_bits(refs["ks_full"], got),
                                  refs["bits8"])


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_bootstrap_sp_polynomial_axis(ranks, refs, sp):
    from ieache_tpu.lwe import encrypt as jenc

    shape, got = ranks[0]["sp"][sp]
    assert shape == {"dp": WORLD // sp, "sp": sp}
    np.testing.assert_array_equal(got, refs["ref8"])
    if sp == 4:
        np.testing.assert_array_equal(got, refs["jax_sp4"])
    np.testing.assert_array_equal(jenc.decrypt_bits(refs["ks"], got),
                                  refs["bits8"])


def test_dp_sharded_evaluator_bit_exact(ranks, refs):
    """The dp-sharded evaluator, the key broadcast from the first rank:
    the value word of JAX's unsharded answer (tests/test_dist.py pins
    JAX's dp-sharded one to it), decrypting to the sums."""
    from ieache_tpu.circuits import evaluator as jev

    got = ranks[0]["dp_value"]
    np.testing.assert_array_equal(got, refs["dp_value"])
    ans = dataclasses.replace(refs["jans"], value=got)
    pair = refs["pair"]
    assert jev.decrypt_answer(pair.main, pair.nbit, ans,
                              jev.OP_ADD) == refs["dp_sums"]


def test_shard_operand_rejects_uneven_batch(ranks):
    assert all(all(r["uneven_refused"]) for r in ranks)


@pytest.mark.parametrize("case", range(len(EP_CASES)),
                         ids=[f"tp{tp}-{p.name}" for tp, p in EP_CASES])
def test_external_product_step_sharded_matches_shard_map(ranks, refs, case):
    """Each tp rank's step (its rows of the digits and the key, the
    partials all-reduced) equals JAX's under shard_map, on every rank of
    the group, the two-limb gadget's dropped shifts included."""
    tp = EP_CASES[case][0]
    for r in ranks[:tp]:
        np.testing.assert_array_equal(r["ep_step"][case],
                                      refs["ep_want"][case])
    assert all(r["ep_step"][case] is None for r in ranks[tp:])


def test_int32_sums_over_ranks_wrap(ranks):
    """gloo's int32 all_reduce (SUM), blocking and async, wraps mod
    2^32 at INT32_MIN, -1 and 2^31-1."""
    wide = EDGES.astype(np.int64)
    want_x = (WORLD * wide).astype(np.int32)
    want_y = (sum(range(1, WORLD + 1)) * wide).astype(np.int32)
    for r in ranks:
        np.testing.assert_array_equal(r["sums"][0], want_x)
        np.testing.assert_array_equal(r["sums"][1], want_y)


@pytest.mark.parametrize("sp", [2, 4])
def test_step_gmatrix_local_blocks_match_full(sp):
    """make_step_gmatrix_local at every shard offset equals JAX's and a
    column slice of the full operand."""
    import jax.numpy as jnp

    from ieache_tpu import params as JP
    from ieache_tpu.ops import blind_rotate as jbr

    p = P.TEST_TINY
    rng = np.random.RandomState(21)
    bk_i = rng.randint(-2**31, 2**31,
                       (p.trgsw_rows, p.k + 1, p.N)).astype(np.int32)
    full = make_step_gmatrix(torch.from_numpy(bk_i), p).numpy()
    nl = p.N // sp
    for s in range(sp):
        got = tbr.make_step_gmatrix_local(torch.from_numpy(bk_i), p, s * nl,
                                          nl).numpy()
        want = np.asarray(jbr.make_step_gmatrix_local(
            jnp.asarray(bk_i), JP.TEST_TINY, jnp.int32(s * nl), nl))
        np.testing.assert_array_equal(got, want, err_msg=f"shard {s}")
        np.testing.assert_array_equal(got, full[..., s * nl:(s + 1) * nl])


def test_step_gmatrix_local_refuses_a_block_that_does_not_divide_n():
    bk_i = torch.zeros((4, 2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide N"):
        tbr.make_step_gmatrix_local(bk_i, P.TEST_TINY, 0, 24)


def _dies(device):
    os._exit(3)


def _raises_in_rank(device):
    raise ValueError(f"boom on rank {dist.get_rank()}")


def _dies_after_a_peer_reports(device):
    if dist.get_rank() == 1:
        raise ValueError("a peer's symptom")
    time.sleep(1.0)
    os._exit(3)


@pytest.mark.parametrize("program,match", [
    (_dies, "exited without a result"), (_raises_in_rank, "ValueError: boom"),
    (_dies_after_a_peer_reports, r"exited without a result: \{0: 3\}")],
    ids=["dies", "raises", "dies-after-a-peer-reports"])
def test_launch_fails_fast_on_a_failed_rank(program, match):
    """A rank that raises reports its traceback, and one that dies
    without a result fails the run at once, not at the time limit, and
    is named with its exit code even where a peer's report of the
    failure it caused arrives first."""
    with pytest.raises(RuntimeError, match=match):
        launch.run(program, 2, device="cpu", timeout=120)


def test_launch_refuses_cuda_ranks_without_cards(monkeypatch):
    """Ranks asked for cuda on a host with fewer cards raise; there is
    no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        launch.run(_raises, 2, device="cuda")
