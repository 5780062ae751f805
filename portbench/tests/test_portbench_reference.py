"""The plain references against torch.linalg.solve at small N, and the
TF32 rounding they use for the control."""

import pytest
import torch

from portbench.matrices import spd_sym_uniform_plus_ni as spd
from portbench.matrices import hplmxp_diag_dominant as gen
from portbench.reference import cholesky, common, lu


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("N,v", [(256, 64), (200, 64), (128, 128)])
def test_lu_reference_solves(N, v):
    A = gen.draw(N, _gen(1), "cpu")
    b = torch.empty(N).uniform_(-1, 1, generator=_gen(2))
    x, (LU, perm) = lu.solve(A, b, v, sweeps=2)
    want = torch.linalg.solve(A.double(), b.double())
    assert torch.allclose(x, want, rtol=1e-9, atol=1e-9)
    L = torch.tril(LU, -1) + torch.eye(N)
    assert torch.allclose(A[perm], L @ torch.triu(LU), atol=1e-4)
    assert float(common.relative_residuals(A, x, b)) < 1e-10


@pytest.mark.parametrize("N,v", [(256, 64), (192, 128)])
def test_cholesky_reference_solves(N, v):
    A = spd.draw(N, _gen(3), "cpu")
    assert torch.equal(A, A.mT)
    B = torch.empty(N, 4).uniform_(-1, 1, generator=_gen(4))
    X, L = cholesky.solve(A, B, v, sweeps=0)
    want = torch.linalg.solve(A.double(), B.double())
    assert torch.allclose(X, want, rtol=1e-6, atol=1e-9)
    r = cholesky.factor_residual(A, L)
    dense = torch.tril(A.double() - L.double() @ L.double().mT, -1)
    assert r["residual_offdiag_f"] == pytest.approx(float(torch.linalg.norm(dense)), rel=1e-9)
    assert r["a_offdiag_f"] == pytest.approx(float(torch.linalg.norm(torch.tril(A.double(), -1))))


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11, -2.5], dtype=torch.float32)
    y = common.round_tf32(x)
    # 10 mantissa bits, ties to even
    assert y.tolist() == [1.0, 1.0, 1.0 + 2**-10, 1.0 + 2**-9, -2.5]
    z = torch.randn(1000, generator=_gen(5))
    assert float(((common.round_tf32(z) - z).abs() / z.abs()).max()) <= 2**-11


def test_tf32_control_shows_in_the_factor_not_the_answer():
    """The LU control at a CPU size: with TF32 trailing updates the
    refined answer still meets the bar on this diagonally dominant class,
    but the factor's off-diagonal residual reads many times float32's."""
    N, v = 1024, 128
    for seed in (4, 5):
        A = gen.draw(N, _gen(seed), "cpu")
        b = torch.empty(N).uniform_(-1, 1, generator=_gen(seed + 100))
        x, (LU, perm) = lu.solve(A, b, v, sweeps=4)
        xc, (LUc, permc) = lu.solve(A, b, v, sweeps=4, tf32=True)
        assert float(common.relative_residuals(A, x, b)) < 1e-12
        assert float(common.relative_residuals(A, xc, b)) < 1e-12
        r, rc = lu.factor_residual(A, LU, perm), lu.factor_residual(A, LUc, permc)
        assert rc["residual_offdiag_f"] > 30 * r["residual_offdiag_f"]
        assert r["residual_offdiag_f"] / r["a_offdiag_f"] < 1e-6


def test_lu_factor_residual_against_a_dense_one():
    N = 320
    A = gen.draw(N, _gen(8), "cpu")
    LU, perm = lu.factor(A, 128)
    r = lu.factor_residual(A, LU, perm)
    R = A[perm].double() - (torch.tril(LU.double(), -1) + torch.eye(N)) @ torch.triu(LU.double())
    off = ~torch.eye(N, dtype=torch.bool)
    assert r["residual_f"] == pytest.approx(float(torch.linalg.norm(R)), rel=1e-9)
    assert r["residual_offdiag_f"] == pytest.approx(float(torch.linalg.norm(R[off])), rel=1e-9)
    assert r["a_offdiag_f"] == pytest.approx(float(torch.linalg.norm(A[perm].double()[off])))


def test_the_lu_class_is_diagonally_dominant():
    """Each diagonal entry is its row's absolute sum as drawn, so partial
    pivoting keeps every row in place."""
    A = gen.draw(512, _gen(9), "cpu")
    off = A.abs().sum(1) - A.diagonal().abs()
    assert bool((A.diagonal() > off).all())
    assert float(A.abs().max() - A.diagonal().max()) <= 0
    _, perm = lu.factor(A, 128)
    assert torch.equal(perm, torch.arange(512))
