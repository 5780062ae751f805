"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card: they carry the `cuda` marker and skip
without one (decided in a fixture, at run time). They import no JAX, so on
the card's machine they run without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch.lu.single import lu_factor_blocked
from conflux_tpu_torch.ops import hopper_kernels as hk
from conflux_tpu_torch.validation import lu_residual_device, make_test_matrix, residual_bound

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rand(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 128, 384), (100, 60, 130),
                                   (1000, 1024, 777)])
def test_gemm_kernel_matches_plain(cuda, M, K, N):
    a, b, c = _rand((M, K), 1, cuda), _rand((K, N), 2, cuda), _rand((M, N), 3, cuda)
    before = hk.LAUNCHES["gemm"]
    got = hk.gemm(a, b, c=c, alpha=-1.0, beta=0.5)
    assert hk.LAUNCHES["gemm"] == before + 1
    want = hk.gemm_plain(a, b, c, alpha=-1.0, beta=0.5)
    # f32 sums in another order: relative Frobenius 1e-5
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-5


def test_gemm_kernel_strided_in_place(cuda):
    big = _rand((300, 401), 4, cuda)
    a, b = big[3:103, 5:65], big[110:170, 7:138]
    c = big[180:280, 200:331]
    want = hk.gemm_plain(a, b, c, alpha=-1.0)
    hk.gemm(a, b, c=c, alpha=-1.0, out=c)
    assert float(torch.linalg.norm(c - want) / torch.linalg.norm(want)) <= 1e-5


def test_gemm_kernel_bf16(cuda):
    a, b = _rand((512, 256), 5, cuda, torch.bfloat16), _rand((256, 384), 6, cuda, torch.bfloat16)
    got = hk.gemm(a, b)
    want = hk.gemm_plain(a, b)
    assert got.dtype == torch.bfloat16
    err = torch.linalg.norm((got - want).float()) / torch.linalg.norm(want.float())
    assert float(err) <= 2 ** -8  # one bf16 rounding of the f32 sum


def test_gemm_kernel_rejects_float64(cuda):
    x = torch.zeros((8, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        hk.gemm(x, x)


@pytest.mark.parametrize("m", [192, 300, 2048, 4096])
@pytest.mark.parametrize("dead", [0.0, 0.3])
def test_lu_block_kernel_matches_plain(cuda, m, dead):
    a = _rand((m, 256), m, cuda)[:, 128:]  # a strided view, as the panel passes it
    alive = torch.from_numpy(
        (np.random.default_rng(m + 1).random((m, 1)) >= dead).astype(np.int32)).to(cuda)
    before = hk.LAUNCHES["lu_block"]
    out, al, piv = hk.lu_block(a, alive)
    assert hk.LAUNCHES["lu_block"] == before + 1
    out_p, al_p, piv_p = hk.lu_block_plain(a, alive)
    assert torch.equal(piv, piv_p) and torch.equal(al, al_p)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,v", [(512, 128), (2048, 256)])
def test_lu_factor_blocked_cuda_matches_cpu(cuda, N, v):
    A = make_test_matrix(N, N, seed=7).astype(np.float32)
    LU_g, perm_g = lu_factor_blocked(torch.from_numpy(A).to(cuda), v)
    LU_c, perm_c = lu_factor_blocked(torch.from_numpy(A), v)
    assert torch.equal(perm_g.cpu(), perm_c)
    # the same pivots; the factors differ by the two devices' summation
    # orders, amplified in the trailing corner by the leading blocks'
    # conditioning (entrywise up to ~1e-2 at N=2048), so compare norm-wise
    diff = torch.linalg.norm(LU_g.cpu() - LU_c) / torch.linalg.norm(LU_c)
    assert float(diff) <= 1e-4
    res = lu_residual_device(torch.from_numpy(A).to(cuda), LU_g, perm_g)
    assert res < residual_bound(N, np.float32)
