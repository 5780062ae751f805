"""Parity of the port's single-device LU slice (`conflux_tpu_torch.lu.single`,
`.solvers`, `.validation`) with the JAX package on the CPU. The JAX side runs
the kernel configuration (`set_backend("pallas")`, `set_panel_algo("pallas")`,
Pallas in interpret mode), which is the port's main path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import solvers as jsolvers
from conflux_tpu.lu import single as jsingle
from conflux_tpu.ops import blas as jblas
from conflux_tpu.validation import lu_residual, make_test_matrix, residual_bound
from conflux_tpu_torch import solvers as tsolvers
from conflux_tpu_torch.lu import single as tsingle
from conflux_tpu_torch.validation import lu_residual_device


@pytest.fixture
def jax_kernel_config():
    jblas.set_backend("pallas")
    jblas.set_panel_algo("pallas")
    yield
    jblas.set_backend("xla")
    jblas.set_panel_algo("auto")


def _factor_both(A, v):
    LU_j, perm_j = jsingle.lu_factor_blocked(jnp.asarray(A), v=v)
    LU_t, perm_t = tsingle.lu_factor_blocked(torch.from_numpy(A), v)
    return (np.asarray(LU_j), np.asarray(perm_j)), (LU_t.numpy(), perm_t.numpy())


@pytest.mark.parametrize("route", ["swap_minimal", "full_gather"])
def test_lu_factor_blocked_matches_jax(jax_kernel_config, route, monkeypatch):
    N, v = 256, 128
    if route == "full_gather":
        # M > _SWAP_SCATTER_MAX in both packages; the JAX program caches its
        # trace without this module value in the key, so drop the caches
        monkeypatch.setattr(jsingle, "_SWAP_SCATTER_MAX", 128)
        monkeypatch.setattr(tsingle, "_SWAP_SCATTER_MAX", 128)
        jax.clear_caches()
    try:
        A = make_test_matrix(N, N, seed=13).astype(np.float32)
        (LU_j, perm_j), (LU_t, perm_t) = _factor_both(A, v)
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_allclose(LU_t, LU_j, rtol=1e-4, atol=1e-4)
    assert lu_residual(A, LU_t, perm_t) < residual_bound(N, np.float32)


def test_lu_factor_blocked_tall_matches_jax(jax_kernel_config):
    M, N, v = 384, 256, 128
    A = make_test_matrix(M, N, seed=21).astype(np.float32)
    (LU_j, perm_j), (LU_t, perm_t) = _factor_both(A, v)
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_allclose(LU_t, LU_j, rtol=1e-4, atol=1e-4)
    assert lu_residual(A, LU_t, perm_t) < residual_bound(N, np.float32)


def test_lu_factor_blocked_leaves_input_untouched():
    A = torch.from_numpy(make_test_matrix(256, 256, seed=2).astype(np.float32))
    before = A.clone()
    LU1, perm1 = tsingle.lu_factor_blocked(A, 128)
    LU2, perm2 = tsingle.lu_factor_blocked(A, 128)
    assert torch.equal(A, before)
    assert torch.equal(LU1, LU2) and torch.equal(perm1, perm2)


def test_lu_factor_blocked_rejects_float64():
    A = torch.from_numpy(make_test_matrix(256, 256, seed=2))
    with pytest.raises(ValueError):
        tsingle.lu_factor_blocked(A, 128)


def test_lu_solve_on_jax_factors(jax_kernel_config):
    N, v = 256, 128
    A = make_test_matrix(N, N, seed=23).astype(np.float32)
    LU_j, perm_j = jsingle.lu_factor_blocked(jnp.asarray(A), v=v)
    b = np.random.default_rng(4).standard_normal((N, 3)).astype(np.float32)
    want = np.asarray(jsolvers.lu_solve(LU_j, perm_j, jnp.asarray(b)))
    LU_t, perm_t = tsingle.state_from_numpy(np.asarray(LU_j), np.asarray(perm_j),
                                            device="cpu")
    assert perm_t.dtype == torch.int64
    # norm-wise rtol 1e-5: cond(A) ~1e4 here, so the two f32 substitutions
    # (another summation order) differ by ~cond * eps in the small entries
    got = tsolvers.lu_solve(LU_t, perm_t, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    got1 = tsolvers.lu_solve(LU_t, perm_t, torch.from_numpy(b[:, 0])).numpy()
    assert got1.shape == (N,)
    assert np.linalg.norm(got1 - want[:, 0]) <= 1e-5 * np.linalg.norm(want[:, 0])


def test_refine_classic_reaches_solve_bar():
    N = 256
    A = make_test_matrix(N, N, seed=29).astype(np.float32)
    At = torch.from_numpy(A)
    LU, perm = tsingle.lu_factor_blocked(At, 128)
    b = torch.ones(N, dtype=torch.float32)
    x = tsolvers.refine_classic(lambda r: tsolvers.lu_solve(LU, perm, r), At, b,
                                3, torch.float64, torch.float32)
    r = tsolvers._residual_strips(At, x, b.double(), torch.float64)
    assert float(r.norm() / b.double().norm()) <= 1e-6


@pytest.mark.parametrize("shape", [(256, 256), (384, 256)])
def test_device_residual_matches_host_oracle(shape):
    M, N = shape
    A = make_test_matrix(M, N, seed=31).astype(np.float32)
    LU, perm = tsingle.lu_factor_blocked(torch.from_numpy(A), 128)
    want = lu_residual(A.astype(np.float64), LU.double().numpy(), perm.numpy())
    got = lu_residual_device(torch.from_numpy(A), LU, perm, strip=96)
    assert abs(got - want) <= 1e-10 * want


def test_from_numpy_without_card_raises(monkeypatch):
    # an entry point that did not ask for the CPU never carries on there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsingle.from_numpy(np.zeros((4, 4), np.float32))
    assert tsingle.from_numpy(np.zeros((4, 4), np.float32), "cpu").device.type == "cpu"
