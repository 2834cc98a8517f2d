"""The port's pipelined expression chain against the JAX package's, on
the CPU.

Counterparts of tests/test_pipeline.py's four tests: the 4-stage ``+ -
+ -`` chain over four microbatches, per-lane mixed add/sub flags, the
stage count refused where it differs from the mesh's, and a multiply
stage (the reference's A+B*C shape).  The pipelined chain must return
the very ciphertexts of the unpipelined one, in both packages, and
decrypt to the plaintext chain mod 2^W.

The stages are ranks: four gloo processes (``dist/launch.py``), one
process group for the module, started once by a fixture.  A spawned
rank imports this module to find its program, so JAX is imported only
inside the fixtures: a rank imports no JAX.
"""

import numpy as np
import pytest
import torch

from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.dist import launch
from ieache_tpu_torch.dist import pipeline as ppl

WORLD = 4

#: name -> (stages, microbatches, stage_ops, width, batch, values seed,
#: encryption seed)
CHAINS = {
    "add_sub_4": (4, 4, None, 6, 8, 11, 0xA1),
    "mixed_2": (2, 2, None, 5, 8, 3, 0xB2),
    "mul_add_2": (2, 2, ("*", "+"), 8, 4, 7, 0xD4),
}


def _raises(fn, match="") -> bool:
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def _ranks(device, inp):
    """Every rank's program: each chain on its pp mesh (ranks outside a
    mesh run nothing), and the refusals."""
    p = P.TEST_TINY
    key = bootstrap.from_jax_cloud_key(inp["key"], p, device)
    r = {}
    for name, (stages, micro, ops, *_) in CHAINS.items():
        flow0, operands, comps = map(torch.from_numpy, inp["chains"][name])
        m = ppl.make_pp_mesh(stages)
        fn = ppl.make_pipelined_chain(m, p, n_micro=micro, stage_ops=ops)
        r[name] = (None if m.coordinate is None else
                   fn(flow0, operands, comps, key.bk, key.ks_limbs).numpy())
    flow0, operands, comps = map(torch.from_numpy, inp["four_on_two"])
    m2 = ppl.make_pp_mesh(2)
    fn = ppl.make_pipelined_chain(m2, p, n_micro=2)
    fn3 = ppl.make_pipelined_chain(m2, p, n_micro=3)
    r["refused"] = {
        "stage_count": _raises(lambda: fn(flow0, operands, comps, key.bk,
                                          key.ks_limbs), "must match"),
        "comps": _raises(lambda: fn(flow0, operands[:2], comps, key.bk,
                                    key.ks_limbs), "comps has 4 stages"),
        "micro": _raises(lambda: fn3(flow0, operands[:2], comps[:2], key.bk,
                                     key.ks_limbs), "n_micro=3"),
        "ops_count": _raises(lambda: ppl.make_pipelined_chain(
            m2, p, 2, stage_ops=("+",)), "1 stage_ops for 2 stages"),
        "ops_kind": _raises(lambda: ppl.make_pipelined_chain(
            m2, p, 2, stage_ops=("+", "-")), "must be '+'/'*'"),
        "mesh": _raises(lambda: ppl.make_pp_mesh(8), "need 8 ranks"),
    }
    return r


@pytest.fixture(scope="module")
def refs():
    """Each chain's inputs (numpy seeds, the JAX package's keygen and
    encryption) and the JAX package's pipelined and unpipelined arrays."""
    import jax.numpy as jnp

    import ieache_tpu.boot.bootstrap as JB
    from ieache_tpu import params as JP
    from ieache_tpu.circuits import words as jwords
    from ieache_tpu.dist import pipeline as jpp
    from ieache_tpu.lwe import keygen as jkeygen
    from ieache_tpu.utils import prng as jprng

    ks = jkeygen.generate_secret_keyset(JP.TEST_TINY)
    dck = JB.pack_cloud_key(ks.cloud)

    def encrypted(values, width, seed):
        s = jprng.key_from_seed_words([seed])
        return [np.array(jwords.encrypt_word(ks, v, width,
                                             jprng.derive(s, i)))
                for i, v in enumerate(values)]

    chains, want = {}, {}
    for name, (stages, micro, ops, width, batch, vseed, eseed) in \
            CHAINS.items():
        rng = np.random.RandomState(vseed)
        hi = {"add_sub_4": 40, "mixed_2": 16, "mul_add_2": 14}[name]
        vals = [rng.randint(0, hi, batch) for _ in range(stages + 1)]
        if name == "mixed_2":
            flags = (np.arange(batch) % 2).astype(np.int32)
            comps = np.stack([flags, 1 - flags])
        else:
            comps = np.zeros((stages, batch), np.int32)
            if name == "add_sub_4":
                comps[1::2] = 1                   # + - + -
        words = encrypted(vals, width, eseed)
        flow0, operands = words[0], np.stack(words[1:])
        chains[name] = (flow0, operands, comps)
        args = (jnp.asarray(flow0), jnp.asarray(operands),
                jnp.asarray(comps), dck.bk, dck.ks_limbs)
        piped = np.asarray(jpp.make_pipelined_chain(
            jpp.make_pp_mesh(stages), JP.TEST_TINY, n_micro=micro,
            stage_ops=ops)(*args))
        plain = np.asarray(jpp.chain_unpipelined(*args, JP.TEST_TINY,
                                                 stage_ops=ops))
        value = [int(x) for x in vals[0]]
        for s in range(stages):
            y = vals[s + 1]
            if (ops or "+" * stages)[s] == "*":
                value = [v * int(b) for v, b in zip(value, y)]
            else:
                value = [v - int(b) if c else v + int(b)
                         for v, b, c in zip(value, y, comps[s])]
        want[name] = (piped, plain, [v % (1 << width) for v in value])

    fv = [np.arange(4) for _ in range(5)]
    four = encrypted(fv, 4, 0xC3)
    return {"inputs": {"key": (np.asarray(dck.bk), np.asarray(dck.ks_limbs)),
                       "chains": chains,
                       "four_on_two": (four[0], np.stack(four[1:]),
                                       np.zeros((4, 4), np.int32))},
            "want": want, "ks": ks}


@pytest.fixture(scope="module")
def ranks(refs):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return launch.run(_ranks, WORLD, refs["inputs"], device="cpu",
                          timeout=300)
    finally:
        torch.set_num_threads(n)


def _check_chain(ranks, refs, name):
    from ieache_tpu.circuits import words as jwords

    stages = CHAINS[name][0]
    piped, plain, values = refs["want"][name]
    got = ranks[0][name]
    np.testing.assert_array_equal(got, piped)
    np.testing.assert_array_equal(got, plain)
    for r in ranks[1:stages]:
        np.testing.assert_array_equal(r[name], got)
    assert all(r[name] is None for r in ranks[stages:])
    assert jwords.decrypt_word(refs["ks"], got) == values


def test_pipelined_chain_bit_exact_and_correct(ranks, refs):
    """4-stage chain v0+v1-v2+v3-v4 over four ranks, 4 microbatches."""
    _check_chain(ranks, refs, "add_sub_4")


def test_pipelined_chain_mixed_ops_per_lane(ranks, refs):
    """A stage adds for some lanes and subtracts for others."""
    _check_chain(ranks, refs, "mixed_2")


def test_stage_count_must_match_mesh(ranks):
    """A 4-stage chain on a 2-rank mesh, comps of the wrong length, a
    batch n_micro does not divide, stage_ops of the wrong length or kind
    and a mesh over more ranks than there are: each refused."""
    for r in ranks:
        assert all(r["refused"].values()), r["refused"]


def test_pipelined_chain_with_mul_stage(ranks, refs):
    """B (*C) (+A): a carry-save multiply as stage 0."""
    _check_chain(ranks, refs, "mul_add_2")


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_unpipelined_matches_jax(refs, name):
    """The port's one-device chain equals JAX's chain_unpipelined."""
    p = P.TEST_TINY
    key = bootstrap.from_jax_cloud_key(refs["inputs"]["key"], p, "cpu")
    flow0, operands, comps = map(torch.from_numpy,
                                 refs["inputs"]["chains"][name])
    got = ppl.chain_unpipelined(flow0, operands, comps, key.bk, key.ks_limbs,
                                p, stage_ops=CHAINS[name][2])
    np.testing.assert_array_equal(got.numpy(), refs["want"][name][1])
