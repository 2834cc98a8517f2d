"""The multi-rank dry run: one sharded evaluation of every kind, on
real TEST_TINY keys, every result decrypted and asserted.

Counterpart of ``__graft_entry__.py:dryrun_multichip``.  On
``n_ranks`` ranks (:mod:`~ieache_tpu_torch.dist.launch`), each rank
runs, on its own slices:

* the (dp, tp)-sharded bootstrap of a batched NAND (tp = 2 where the
  rank count is even);
* the (dp, sp)-sharded bootstrap of the same NAND, where sp in (4, 2)
  divides the rank count;
* a dp-sharded 4-bit ripple add and 2-bit carry-save multiply, the key
  replicated;
* the pipelined chain over all ranks: stage 0 a carry-save multiply,
  the others add or subtract per lane, two microbatches;
* the dp-sharded bootstrap under the step modes ``split``, ``tr``,
  ``scan`` and ``ntt``, with ``IEACHE_PALLAS`` set as the JAX package
  sets it on its CPU mesh (``interpret``, ``0`` for ntt) on the CPU, and
  to ``1`` on a card, where each mode must launch its own kernels and
  no other (the launch counters are set to 0 before each mode and read
  after it).

A rank raises on the first wrong lane; :func:`dryrun_multichip` returns
each rank's launches by mode and the batches at which it called each
step kernel's wrapper
(:func:`~ieache_tpu_torch.ops.kernels.recording_batches`), at which a
caller holds the kernels to their twins.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ieache_tpu_torch import keygen, prng
from ieache_tpu_torch import params as P
from ieache_tpu_torch.boot import bootstrap, gates
from ieache_tpu_torch.circuits import fused, words
from ieache_tpu_torch.dist import batch as dbatch
from ieache_tpu_torch.dist import launch
from ieache_tpu_torch.dist import mesh as dmesh
from ieache_tpu_torch.dist import pipeline as ppl
from ieache_tpu_torch.dist import shard as dshard
from ieache_tpu_torch.lwe import encrypt
from ieache_tpu_torch.ops import kernels

#: the step modes the dry run runs dp-sharded (their kernels:
#: ``kernels.MODE_KERNELS``)
MODES = ("split", "tr", "scan", "ntt")


def _expect(got, want, what):
    if list(got) != list(want):
        raise AssertionError(f"{what}: decrypted {list(got)}, want "
                             f"{list(want)}")


def _local(values, mesh):
    """This rank's dp slice of a per-lane host array."""
    b = len(values) // mesh.shape["dp"]
    r = mesh.index("dp")
    return np.asarray(values)[r * b:(r + 1) * b]


def _dryrun_rank(device, ks, n: int) -> dict:
    with kernels.recording_batches() as seen:
        launches = _dryrun_steps(device, ks, n)
    return {"launches": launches,
            "batches": {k: sorted(b) for k, b in seen.items() if b}}


def _dryrun_steps(device, ks, n: int) -> dict:
    """The dry run's evaluations on this rank; returns {mode: {kernel:
    launches}} of the mode loop."""
    p = P.TEST_TINY                       # trgsw_rows = 4, kN*t = 256
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    m = dmesh.make_mesh(n, tp=tp)
    dck = bootstrap.pack_cloud_key(ks.cloud, device)
    rng = np.random.RandomState(1)
    batch = max(16, 2 * n)
    stream = prng.key_from_seed_words([0xD3])

    # the (dp, tp)-sharded bootstrap of a batched NAND
    abits = rng.randint(0, 2, batch)
    bbits = rng.randint(0, 2, batch)
    ca = encrypt.encrypt_bits(ks, abits, prng.derive(stream, 0), device)
    cb = encrypt.encrypt_bits(ks, bbits, prng.derive(stream, 1), device)
    pre = -ca - cb
    pre[:, p.n] += bootstrap.MU
    want = 1 - (abits & bbits)
    boot_fn = dshard.make_sharded_bootstrap(m, p)
    bk, ksl = dshard.shard_cloud_key(dck, m)
    out = boot_fn(dshard.shard_batch(pre, m), bk, ksl)
    _expect(encrypt.decrypt_bits(ks, out), _local(want, m), "(dp, tp) NAND")

    # the (dp, sp)-sharded bootstrap, where sp divides the rank count
    sp = next((s for s in (4, 2) if n % s == 0 and p.N % s == 0), None)
    if sp is not None:
        m_sp = dshard.make_sp_mesh(n, sp=sp)
        out = dshard.make_sharded_bootstrap_sp(m_sp, p)(
            dshard.shard_batch(pre, m_sp), dck.bk, dck.ks_limbs)
        _expect(encrypt.decrypt_bits(ks, out), _local(want, m_sp),
                f"(dp, sp={sp}) NAND")

    # a dp-sharded ripple add and carry-save multiply, the key replicated
    dck_rep = dbatch.replicate_cloud_key(dck, m)
    w = 4
    xv = rng.randint(0, 1 << (w - 1), batch)
    yv = rng.randint(0, 1 << (w - 1), batch)
    xw = dshard.shard_batch(words.encrypt_word(ks, xv, w,
                                               prng.derive(stream, 2),
                                               device), m)
    yw = dshard.shard_batch(words.encrypt_word(ks, yv, w,
                                               prng.derive(stream, 3),
                                               device), m)
    carry0 = gates.CONSTANT(torch.zeros(xw.shape[0], dtype=torch.int32,
                                        device=device), p.n)
    s, _ = fused.ripple_add(xw, yw, carry0, dck_rep)
    _expect(words.decrypt_word(ks, s),
            [(int(a) + int(b)) % (1 << w) for a, b in
             zip(_local(xv, m), _local(yv, m))], "dp ripple add")
    prod = fused.schoolbook_mul_csa(xw[:, :2], yw[:, :2], dck_rep)
    _expect(words.decrypt_word(ks, prod),
            [(int(a) % 4) * (int(b) % 4) for a, b in
             zip(_local(xv, m), _local(yv, m))], "dp carry-save multiply")

    # the pipelined chain over all ranks: * then + / - per lane
    pmesh = ppl.make_pp_mesh(n)
    cw = 8
    vals = [rng.randint(0, 10, batch) for _ in range(n + 1)]
    wordlist = [words.encrypt_word(ks, v, cw, prng.derive(stream, 4 + i),
                                   device) for i, v in enumerate(vals)]
    flow0, operands = wordlist[0], torch.stack(wordlist[1:])
    comps_np = np.zeros((n, batch), np.int32)
    if n > 1:
        comps_np[1] = np.arange(batch) % 2         # stage 1 mixes +/-
    stage_ops = ("*",) + ("+",) * (n - 1)
    chain_fn = ppl.make_pipelined_chain(pmesh, p, n_micro=2,
                                        stage_ops=stage_ops)
    res = chain_fn(flow0, operands, torch.from_numpy(comps_np).to(device),
                   dck.bk, dck.ks_limbs)
    expect = []
    for lane in range(batch):
        acc = int(vals[0][lane]) * int(vals[1][lane])
        for s_i in range(1, n):
            sign = -1 if comps_np[s_i, lane] else 1
            acc += sign * int(vals[s_i + 1][lane])
        expect.append(acc % (1 << cw))
    _expect(words.decrypt_word(ks, res), expect, "pp chain")

    # the dp-sharded bootstrap under each step mode
    m_dp = dmesh.make_mesh(n, tp=1)
    pre_dp = dshard.shard_batch(pre, m_dp)
    saved = {k: os.environ.get(k)
             for k in ("IEACHE_PALLAS", "IEACHE_PALLAS_STEP")}
    on_card = torch.device(device).type == "cuda"
    launches = {}
    try:
        for mode in MODES:
            names = kernels.MODE_KERNELS[mode]
            os.environ["IEACHE_PALLAS"] = (
                "0" if mode == "ntt" else "1" if on_card else "interpret")
            os.environ["IEACHE_PALLAS_STEP"] = mode
            kernels.reset_launch_counts()
            out = bootstrap.bootstrap(pre_dp, dck)
            counts = kernels.launch_counts()
            _expect(encrypt.decrypt_bits(ks, out), _local(want, m_dp),
                    f"dp NAND under {mode}")
            launched = {k for k, c in counts.items() if c}
            if launched != (set(names) if on_card else set()):
                raise AssertionError(f"dp NAND under {mode} launched "
                                     f"{sorted(launched)}")
            launches[mode] = {k: counts[k] for k in names}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


def dryrun_multichip(n_ranks: int, device="cuda") -> list:
    """The dry run on ``n_ranks`` ranks on ``device`` (``cuda``: one card
    a rank); returns each rank's ``{"launches": {mode: {kernel: n}},
    "batches": {kernel: sorted batches of its calls}}``."""
    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    return launch.run(_dryrun_rank, n_ranks, ks, n_ranks, device=device)
