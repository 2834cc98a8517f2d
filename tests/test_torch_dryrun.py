"""The port's multi-rank dry run (``dist/dryrun.py``) on CPU ranks.

Counterpart of ``__graft_entry__.py:dryrun_multichip`` run on the JAX
package's virtual CPU mesh: on real TEST_TINY keys, the (dp, tp) NAND,
the (dp, sp) NAND where sp divides the ranks, a dp-sharded ripple add
and carry-save multiply, the pipelined chain over every rank and the
dp-sharded bootstrap under split, tr, scan and ntt, each decrypted and
asserted inside the ranks.  On the CPU the kernel modes run under
``IEACHE_PALLAS=interpret`` (ntt under ``0``), as the JAX package runs
its own, and launch nothing.
"""

import os

import pytest
import torch

from ieache_tpu_torch.dist import dryrun
from ieache_tpu_torch.ops import kernels


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(n_ranks):
    """Every decrypt assert holds on every rank (a wrong lane raises in
    the rank, and the launch fails); no kernel launches on the CPU; each
    rank records the batches of its wrappers' calls; the caller's
    IEACHE_PALLAS settings are left as they were."""
    before = {k: os.environ.get(k)
              for k in ("IEACHE_PALLAS", "IEACHE_PALLAS_STEP")}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reports = dryrun.dryrun_multichip(n_ranks, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert len(reports) == n_ranks
    for rep in reports:
        assert set(rep["launches"]) == set(dryrun.MODES)
        for mode, counts in rep["launches"].items():
            assert set(counts) == set(kernels.MODE_KERNELS[mode])
            assert not any(counts.values()), (mode, counts)
        # the split pair's waves go through the wrappers (their twins on
        # the CPU); the mode loop's interpret route calls the twins
        assert set(rep["batches"]) == {"rot_diff_decompose",
                                       "external_product"}
    assert before == {k: os.environ.get(k) for k in before}


def test_dryrun_refuses_cuda_ranks_without_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dryrun.dryrun_multichip(1)
