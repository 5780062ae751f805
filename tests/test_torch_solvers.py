"""The port's solver API (`solvers.solve`, `fgmres`, `lu_solve_transposed`,
`slogdet_from_lu`, `cond_estimate_1`, `inv_from_lu`), `debug.py` and
`validation.make_hpd_matrix` on the CPU, against the JAX package's
functions on the same seeded inputs (the setups of tests/test_solve.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import debug as jdebug
from conflux_tpu import solvers as jsolvers
from conflux_tpu import validation as jval
from conflux_tpu.lu.single import lu_factor_blocked as jlu
from conflux_tpu.ops import blas as jblas
from conflux_tpu_torch import debug as tdebug
from conflux_tpu_torch import solvers as tsolvers
from conflux_tpu_torch import validation as tval
from conflux_tpu_torch.lu.single import lu_factor_blocked as tlu
from conflux_tpu_torch.ops import blas as tblas
from torch_registry_guard import registry_guard  # noqa: F401


@pytest.fixture
def library_route():
    jb, ja = jblas.get_backend(), jblas.get_panel_algo()
    tb, ta = tblas.get_backend(), tblas.get_panel_algo()
    jblas.set_backend("xla")
    jblas.set_panel_algo("auto")
    tblas.set_backend("xla")
    tblas.set_panel_algo("auto")
    yield
    tblas.set_backend(tb)
    tblas.set_panel_algo(ta)
    jblas.set_backend(jb)
    jblas.set_panel_algo(ja)


def _relerr(A, x, b):
    r = np.asarray(A, np.float64) @ np.asarray(x, np.float64) - np.asarray(b, np.float64)
    return np.linalg.norm(r) / np.linalg.norm(np.asarray(b, np.float64))


@pytest.mark.parametrize("N,spd", [(128, False), (101, False), (97, True)])
def test_solve_pads_and_matches_jax(library_route, N, spd):
    """A prime N is padded with an identity extension to a multiple of v."""
    A = (jval.make_spd_matrix(N) if spd else jval.make_test_matrix(N, N, seed=1))
    b = np.linspace(-1, 1, N)
    x_j = np.asarray(jsolvers.solve(jnp.asarray(A), jnp.asarray(b), v=32, spd=spd))
    x_t = tsolvers.solve(torch.from_numpy(A), torch.from_numpy(b), v=32, spd=spd)
    assert tuple(x_t.shape) == (N,)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-12, atol=1e-12)
    assert _relerr(A, x_t, b) < 1e-12
    B = np.stack([b, b[::-1]], 1)
    X = tsolvers.solve(torch.from_numpy(A), torch.from_numpy(B), v=32, spd=spd)
    assert tuple(X.shape) == (N, 2) and _relerr(A, X, B) < 1e-12


def test_solve_bf16_factors_refine(library_route):
    """The HPL-MxP recipe: bf16 factors alone are bf16-grade, refinement
    brings f32 grade (tests/test_solve.py's bars)."""
    N = 96
    A = jval.make_test_matrix(N, N, seed=3, dtype=np.float32) + 4 * np.eye(N, dtype=np.float32)
    b = np.ones(N, np.float32)
    errs = []
    for refine in (0, 3):
        x_t = tsolvers.solve(torch.from_numpy(A), torch.from_numpy(b), v=32,
                             factor_dtype=torch.bfloat16, refine=refine)
        x_j = jsolvers.solve(jnp.asarray(A), jnp.asarray(b), v=32,
                             factor_dtype=jnp.bfloat16, refine=refine)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-2, atol=1e-3)
        errs.append(_relerr(A, x_t, b))
    assert errs[0] > 1e-4 and errs[1] < 1e-5


def test_fgmres_exact_preconditioner_one_cycle():
    rng = np.random.default_rng(7)
    N = 96
    A = rng.standard_normal((N, N)) + 4 * np.eye(N)
    b = rng.standard_normal(N)
    Ad, Ainv = torch.from_numpy(A), torch.from_numpy(np.linalg.inv(A))
    x, info = tsolvers.fgmres(lambda v: Ad @ v, lambda r: Ainv @ r, torch.from_numpy(b),
                              tol=1e-12, restart=4)
    assert info["restarts"] == 1 and info["residual"] < 1e-12
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-9)
    xj, infoj = jsolvers.fgmres(lambda v: jnp.asarray(A) @ v,
                                lambda r: jnp.asarray(np.linalg.inv(A)) @ r,
                                jnp.asarray(b), tol=1e-12, restart=4, rdtype=jnp.float64)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10)
    assert infoj["restarts"] == info["restarts"]


def test_fgmres_beats_classic_ir_on_bf16_factors(library_route):
    """tests/test_solve.py's GMRES-IR claim on the port: bf16 factors of
    make_test_matrix(512) (cond ~1.4e3), v=64; 6 classic sweeps stay above
    1e-4, FGMRES preconditioned by the same factors reaches 1e-6."""
    N = 512
    A = jval.make_test_matrix(N, N, dtype=np.float32)
    b = np.ones(N, np.float32)
    LU, perm = tlu(torch.from_numpy(A).bfloat16(), 64)
    Ad = torch.from_numpy(A)
    b_r = torch.from_numpy(b).double()
    x = tsolvers.lu_solve(LU, perm, torch.from_numpy(b)).double()
    for _ in range(6):
        r = tsolvers._residual_strips(Ad, x, b_r, torch.float64)
        x = x + tsolvers.lu_solve(LU, perm, r.float()).double()
    r = tsolvers._residual_strips(Ad, x, b_r, torch.float64)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b_r)) > 1e-4
    xg, info = tsolvers.fgmres(lambda v: Ad.double() @ v,
                               lambda rr: tsolvers.lu_solve(LU, perm, rr.float()),
                               b_r, tol=1e-6, restart=16, max_restarts=8, rdtype=torch.float64)
    assert info["residual"] <= 1e-6, info
    assert _relerr(A, xg, b) < 1e-6


def test_lu_solve_transposed_slogdet_cond_inv_match_jax(library_route):
    rng = np.random.default_rng(73)
    N = 96
    A = rng.standard_normal((N, N)) + 3 * np.eye(N)
    LU_j, perm_j = jlu(jnp.asarray(A), v=16)
    LU, perm = tlu(torch.from_numpy(A), 16)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    b = rng.standard_normal(N)
    x = tsolvers.lu_solve_transposed(LU, perm, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(A.T @ x, b, atol=1e-9)
    np.testing.assert_allclose(x, np.asarray(jsolvers.lu_solve_transposed(
        LU_j, perm_j, jnp.asarray(b))), rtol=1e-12, atol=1e-12)
    sign, logabs = tsolvers.slogdet_from_lu(LU, perm)
    s_ref, l_ref = np.linalg.slogdet(A)
    assert sign == s_ref == jsolvers.slogdet_from_lu(LU_j, perm_j)[0]
    np.testing.assert_allclose(logabs, l_ref, rtol=1e-10)
    est = tsolvers.cond_estimate_1(torch.from_numpy(A), LU, perm)
    exact = np.abs(A).sum(0).max() * np.abs(np.linalg.inv(A)).sum(0).max()
    assert 0.1 * exact <= est <= 1.01 * exact
    np.testing.assert_allclose(est, jsolvers.cond_estimate_1(A, LU_j, perm_j), rtol=1e-10)
    Ainv = tsolvers.inv_from_lu(LU, perm).numpy()
    np.testing.assert_allclose(A @ Ainv, np.eye(N), atol=1e-9)
    np.testing.assert_allclose(Ainv, np.asarray(jsolvers.inv_from_lu(LU_j, perm_j)),
                               rtol=1e-10, atol=1e-12)
    Z = np.zeros((4, 4))
    assert tsolvers.slogdet_from_lu(torch.from_numpy(Z), torch.arange(4)) == (0.0, float("-inf"))


def test_solver_utilities_complex(library_route):
    rng = np.random.default_rng(103)
    N = 48
    A = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))) + 4 * np.eye(N)
    LU, perm = tlu(torch.from_numpy(A), 16)
    LU_j, perm_j = jlu(jnp.asarray(A), v=16)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    x = tsolvers.lu_solve_transposed(LU, perm, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(A.T @ x, b, atol=1e-9)
    sign, logabs = tsolvers.slogdet_from_lu(LU, perm)
    s_ref, l_ref = np.linalg.slogdet(A)
    np.testing.assert_allclose(sign, s_ref, rtol=1e-10)
    np.testing.assert_allclose(logabs, l_ref, rtol=1e-10)
    np.testing.assert_allclose(A @ tsolvers.inv_from_lu(LU, perm).numpy(), np.eye(N), atol=1e-9)


@pytest.mark.parametrize("N,seed", [(8, 7), (33, 11), (64, 7)])
def test_make_hpd_matrix_bitwise(N, seed):
    A = tval.make_hpd_matrix(N, seed=seed)
    want = jval.make_hpd_matrix(N, seed=seed)
    assert A.dtype == torch.complex128 and np.array_equal(A.numpy(), want)
    assert np.array_equal(A.numpy(), A.numpy().conj().T)


def test_debug_checks_match_jax():
    good = np.arange(6.0).reshape(2, 3)
    bad = good.copy()
    bad[1, 2] = np.inf
    for x in (good, bad):
        assert tdebug.has_valid_data(torch.from_numpy(x)) == jdebug.has_valid_data(x)
    tdebug.assert_valid(torch.from_numpy(good))
    with pytest.raises(FloatingPointError, match="1 non-finite"):
        tdebug.assert_valid(torch.from_numpy(bad), "A")
    tdebug.assert_nonzero_pivots(torch.eye(3))
    with pytest.raises(ZeroDivisionError, match="position 1"):
        tdebug.assert_nonzero_pivots(torch.diag(torch.tensor([1.0, 0.0, 2.0])))
    tdebug.assert_pivot_conservation(torch.tensor([2, 0, 1]), 3)
    for piv, msg in (([0, 0, 1], "duplicate"), ([0, 1, 3], "out of range")):
        with pytest.raises(AssertionError, match=msg):
            tdebug.assert_pivot_conservation(torch.tensor(piv), 3)
        with pytest.raises(AssertionError, match=msg):
            jdebug.assert_pivot_conservation(np.asarray(piv), 3)
    t = torch.ones(4)
    assert tdebug.checked_isfinite(t, "x") is t
    with pytest.raises(FloatingPointError, match="x: non-finite"):
        tdebug.checked_isfinite(torch.tensor([1.0, float("nan")]), "x")
