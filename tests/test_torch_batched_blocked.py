"""The port's batched blocked factor (`lu_factor_blocked` and
`cholesky_blocked` on a (B, N, N) batch) and the batched solves of
`batched.py` on the CPU, against the JAX package's `jax.vmap` of its
blocked bodies and its batched entries on the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import batched as jbatched
from conflux_tpu.cholesky.single import _cholesky_blocked as jchol_body
from conflux_tpu.lu.single import _lu_factor_blocked as jlu_body
from conflux_tpu.ops import blas as jblas
from conflux_tpu_torch import batched as tbatched
from conflux_tpu_torch.cholesky import cholesky_blocked
from conflux_tpu_torch.lu.single import lu_factor_blocked
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.validation import lu_residual
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


def _gen(B, N, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, N)) / np.sqrt(N) + 2 * np.eye(N)).astype(dtype)


def _spd(B, N, seed, dtype=np.float64):
    M = _gen(B, N, seed, np.float64)
    return (np.einsum("bij,bkj->bik", M, M) + np.eye(N)).astype(dtype)


def _jax_lu(A, v):
    return jax.vmap(lambda a: jlu_body(a, v, jblas.matmul_precision(), "xla", "auto"))(
        jnp.asarray(A))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-4)])
@pytest.mark.parametrize("B,N,v", [(3, 64, 16), (2, 96, 32)])
def test_batched_lu_matches_jax_vmap(library_route, dtype, rtol, B, N, v):
    A = _gen(B, N, B * N + v, dtype)
    LU_j, perm_j = _jax_lu(A, v)
    LU_t, perm_t = lu_factor_blocked(torch.from_numpy(A), v)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(LU_t.numpy(), np.asarray(LU_j), rtol=rtol,
                               atol=rtol * np.abs(A).max())
    # slot i of the batch is the factor of A[i] alone
    for i in range(B):
        LU_i, perm_i = lu_factor_blocked(torch.from_numpy(A[i]), v)
        assert torch.equal(perm_i, perm_t[i])
        np.testing.assert_allclose(LU_i.numpy(), LU_t[i].numpy(), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_batched_cholesky_matches_jax_vmap(library_route, dtype):
    B, N, v = 2, 64, 16
    A = _spd(B, N, 5).astype(dtype)
    if dtype == np.complex128:
        H = np.random.default_rng(6).standard_normal((B, N, N)) * 1e-2
        A = A + 1j * (H - np.swapaxes(H, 1, 2))
    L_j = jax.vmap(lambda a: jchol_body(a, v, jblas.matmul_precision(), "xla"))(jnp.asarray(A))
    L_t = cholesky_blocked(torch.from_numpy(A), v)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-12, atol=1e-12)


def test_batched_blocked_bf16_storage_on_the_kernel_route():
    """bf16 storage on "kernel": K2 (plain version here) elects each
    column block of every slot in one batched call, K1 (plain) updates
    each slot; at bf16 accuracy, as the JAX package's vmapped bf16 factor
    is (residual bar, the JAX route beside it)."""
    B, N, v = 2, 256, 128
    A = _gen(B, N, 12, np.float32)
    Ab = torch.from_numpy(A).bfloat16()
    LU_t, perm_t = lu_factor_blocked(Ab, v, backend="kernel", panel_algo="kernel")
    assert LU_t.dtype == torch.bfloat16
    LU_j, perm_j = jax.vmap(lambda a: jlu_body(a, v, jblas.matmul_precision(), "xla", "auto"))(
        jnp.asarray(Ab.float().numpy()).astype(jnp.bfloat16))
    for i in range(B):
        Ai = Ab[i].double().numpy()
        res_t = lu_residual(Ai, LU_t[i].double().numpy(), perm_t[i].numpy())
        res_j = lu_residual(Ai, np.asarray(LU_j[i].astype(jnp.float64)), np.asarray(perm_j[i]))
        assert res_t <= 1e-2 and res_j <= 1e-2
    # the batched kernel route's slot i is the 2D call's, pivots equal
    LU0, perm0 = lu_factor_blocked(Ab[0], v, backend="kernel", panel_algo="kernel")
    assert torch.equal(perm0, perm_t[0])
    L0 = cholesky_blocked(torch.from_numpy(_spd(1, N, 3, np.float32)[0]).bfloat16(), v,
                          backend="kernel")
    assert L0.dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["kernel", "xla"])
def test_batched_factor_entries_route(library_route, backend):
    """float32 / float64 on "kernel" ride K4 / K5; bf16 or "xla" the
    batched blocked factor, as the JAX package routes them."""
    A = _gen(2, 128, 21, np.float32)
    if backend == "kernel":
        LU, perm = tbatched.lu_factor_batched(torch.from_numpy(A), 128, backend="kernel")
        kLU, kperm = tblas.batched_lu_factor(torch.from_numpy(A), backend="kernel")
        assert torch.equal(LU, kLU) and torch.equal(perm, kperm)
        tblas.set_panel_algo("kernel")
        with pytest.raises(ValueError, match="panel algo 'kernel'"):
            tbatched.lu_factor_batched(torch.from_numpy(A).bfloat16(), 16, backend="kernel")
        return
    LU_j, perm_j = jbatched.lu_factor_batched(jnp.asarray(A), 32)
    LU_t, perm_t = tbatched.lu_factor_batched(torch.from_numpy(A), 32)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(LU_t.numpy(), np.asarray(LU_j), rtol=1e-4, atol=1e-4)
    S = _spd(2, 128, 22, np.float32)
    L_j = jbatched.cholesky_factor_batched(jnp.asarray(S), 32)
    L_t = tbatched.cholesky_factor_batched(torch.from_numpy(S), 32)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [None, 3])
def test_lu_and_cholesky_solve_batched_match_jax(k):
    B, N = 3, 64
    A = _gen(B, N, 31)
    rng = np.random.default_rng(32)
    b = rng.standard_normal((B, N) if k is None else (B, N, k))
    LU_j, perm_j = jbatched.lu_factor_batched(jnp.asarray(A), 16, backend="xla")
    x_j = jbatched.lu_solve_batched(LU_j, perm_j, jnp.asarray(b))
    x_t = tbatched.lu_solve_batched(torch.from_numpy(np.array(LU_j)),
                                    torch.from_numpy(np.array(perm_j)), torch.from_numpy(b))
    assert x_t.shape == b.shape
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-12, atol=1e-12)
    S = _spd(B, N, 33)
    L = np.linalg.cholesky(S)
    xc_j = jbatched.cholesky_solve_batched(jnp.asarray(L), jnp.asarray(b))
    xc_t = tbatched.cholesky_solve_batched(torch.from_numpy(L), torch.from_numpy(b))
    np.testing.assert_allclose(xc_t.numpy(), np.asarray(xc_j), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="rhs"):
        tbatched.lu_solve_batched(torch.from_numpy(L), torch.from_numpy(np.array(perm_j)),
                                  torch.from_numpy(b[:, :8]))


@pytest.mark.parametrize("substitution", ["trsm", "blocked"])
@pytest.mark.parametrize("spd", [False, True])
def test_solve_batched_with_refine_matches_jax(library_route, substitution, spd):
    """factor in bf16 + 2 refinement sweeps (the HPL-MxP recipe) and a
    plain f32 solve, both against the JAX pipeline of the same options."""
    B, N = 2, 64
    A = (_spd(B, N, 41) / N + np.eye(N) if spd else _gen(B, N, 41)).astype(np.float32)
    b = np.random.default_rng(42).standard_normal((B, N)).astype(np.float32)
    for fdt, jfdt, refine, tol in ((None, None, 0, 1e-4), (torch.bfloat16, jnp.bfloat16, 2, 1e-4)):
        x_j = jbatched.solve_batched(jnp.asarray(A), jnp.asarray(b), v=16, factor_dtype=jfdt,
                                     refine=refine, spd=spd, substitution=substitution)
        x_t = tbatched.solve_batched(torch.from_numpy(A), torch.from_numpy(b), v=16,
                                     factor_dtype=fdt, refine=refine, spd=spd,
                                     substitution=substitution)
        assert x_t.shape == b.shape and x_t.dtype == torch.float32
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=tol, atol=tol)
        assert np.abs(np.einsum("bij,bj->bi", A, x_t.numpy()) - b).max() < 1e-4
    with pytest.raises(ValueError, match="substitution"):
        tbatched.solve_batched(torch.from_numpy(A), torch.from_numpy(b), substitution="inv")
    # the Woodbury entry is ported (tests/test_torch_update.py): it checks
    # its update factors' shape
    At = torch.from_numpy(A)
    with pytest.raises(ValueError, match="update factors"):
        tbatched.solve_updated_batched(At, At[0], At[0], torch.from_numpy(b))
