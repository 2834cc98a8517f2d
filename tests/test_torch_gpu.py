"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips it
when no CUDA device is present.  This file imports no JAX, so it also
runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest`` because tests/conftest.py configures JAX).  All
arithmetic is exact mod 2^32: kernel and twin must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ieache_tpu import params as P
from ieache_tpu.lwe import keygen
from ieache_tpu.utils import prng
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.lwe import encrypt
from ieache_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu

PARAMS = [P.TEST_TINY, P.TEST_SMALL_NOISY, P.IEACHE_110_FAST]


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


def test_bootstrap_kernel_path_matches_plain_path(cuda):
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    key = bootstrap.pack_cloud_key(ks.cloud, cuda)
    bits = prng.uniform_bits01(prng.key_from_seed_words([3]), 37)
    ct = encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([4]), cuda)
    got = bootstrap.bootstrap(ct, key)
    want = bootstrap.bootstrap(ct, key, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, got), bits)


def test_compat_gadget_refused_on_cuda(cuda):
    p = dataclasses.replace(P.TEST_TINY, bg_bit=10, name="tiny_compat")
    acc = torch.zeros((p.k + 1, 3, p.N), dtype=torch.int32, device=cuda)
    bara = torch.zeros((3,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="single-limb"):
        kernels.rot_diff_decompose(acc, bara, p)
    from ieache_tpu_torch.ops.blind_rotate import blind_rotate

    bk = torch.zeros((p.n, p.trgsw_rows, p.k + 1, p.N), dtype=torch.int32,
                     device=cuda)
    with pytest.raises(ValueError, match="single-limb"):
        blind_rotate(acc.transpose(0, 1).contiguous(),
                     torch.zeros((3, p.n), dtype=torch.int32, device=cuda),
                     bk, p)
