"""Parity of the port's blocked triangular solves
(`conflux_tpu_torch.ops.batched_trsm`) with the JAX package's
(`conflux_tpu.ops.batched_trsm`), on the CPU: the same seeded numpy inputs
through both. The port's batched `blocked_trsm` runs the K3 kernel's plain
version here (`hopper_kernels.btrsm_plain`), held to the JAX Pallas kernel
in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import batched_trsm as jbt
from conflux_tpu_torch.ops import batched_trsm as tbt
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels


def _mat(rng, B, N, dtype):
    return (rng.standard_normal((B, N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def test_default_block_size_matches():
    for n in range(1, 301):
        assert tbt.default_block_size(n) == jbt.default_block_size(n), n
    with pytest.raises(ValueError):
        tbt.default_block_size(0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("N,lower,unit", [(64, True, True), (64, False, False),
                                          (48, True, True), (48, False, False),
                                          (48, True, False)])
def test_diag_block_inverses_match(dtype, N, lower, unit):
    # a packed operand: both triangles hold data, as a packed LU does
    A = _mat(np.random.default_rng(N + 2 * lower + unit), 1, N, dtype)[0]
    want = np.asarray(jbt.diag_block_inverses(jnp.asarray(A), lower=lower,
                                              unit_diagonal=unit))
    got = tbt.diag_block_inverses(_t(A), lower=lower, unit_diagonal=unit)
    assert got.dtype == _t(A).dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("lower", [True, False])
def test_blocked_solve_matches(lower):
    rng = np.random.default_rng(7 + lower)
    A = _mat(rng, 1, 64, np.float32)[0]
    b = rng.standard_normal((64, 3)).astype(np.float32)
    jd = jbt.diag_block_inverses(jnp.asarray(A), lower=lower, unit_diagonal=lower)
    want = np.asarray(jbt.blocked_solve(jnp.asarray(A), jd, jnp.asarray(b), lower=lower))
    got = tbt.blocked_solve(_t(A), _t(jd), _t(b), lower=lower)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_blocked_solve_batch_axis_replaces_vmap():
    rng = np.random.default_rng(8)
    A = _mat(rng, 3, 48, np.float32)
    b = rng.standard_normal((3, 48, 2)).astype(np.float32)
    D = tbt.diag_block_inverses(_t(A), lower=False)
    got = tbt.blocked_solve(_t(A), D, _t(b), lower=False)
    for i in range(3):
        one = tbt.blocked_solve(_t(A[i]), D[i], _t(b[i]), lower=False)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-6, atol=1e-7)


def test_blocked_solve_probe_matches():
    """x, xsum and wAx, as tests/test_batched_trsm.py checks them."""
    rng = np.random.default_rng(21)
    T = np.triu(_mat(rng, 1, 64, np.float32)[0])
    b = rng.standard_normal((64, 2)).astype(np.float32)
    wA = rng.standard_normal(64).astype(np.float32)
    jd = jbt.diag_block_inverses(jnp.asarray(T), lower=False)
    jx, jsum, jwax = jbt.blocked_solve_probe(jnp.asarray(T), jd, jnp.asarray(b),
                                             jnp.asarray(wA), lower=False,
                                             stats_dtype=jnp.float32)
    x, xsum, wAx = tbt.blocked_solve_probe(_t(T), _t(jd), _t(b), _t(wA), lower=False,
                                           stats_dtype=torch.float32)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    # the epilogue leaves x exactly the unfused solve's bits
    assert torch.equal(x, tbt.blocked_solve(_t(T), _t(jd), _t(b), lower=False))
    assert np.isclose(float(xsum), float(jsum), rtol=1e-4)
    assert np.isclose(float(xsum), float(x.sum()), rtol=1e-4)
    assert np.isclose(float(wAx), float(jwax), rtol=1e-3, atol=1e-4)
    assert np.isclose(float(wAx), float(np.dot(wA, x.numpy()[:, 0])), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("N,k,lower", [(128, 1, True), (128, 4, False), (48, 2, True)])
def test_blocked_trsm_kernel_route_matches_pallas(N, k, lower):
    """The batched route (the K3 kernel's plain version on the CPU) against
    the JAX Pallas kernel in interpret mode, at the cases of
    tests/test_batched_trsm.py."""
    rng = np.random.default_rng(9 + N + k)
    A = _mat(rng, 4, N, np.float32)
    T = np.tril(A) if lower else np.triu(A)
    b = rng.standard_normal((4, N, k)).astype(np.float32)
    want = np.asarray(jbt.blocked_trsm(jnp.asarray(T), jnp.asarray(b), lower=lower,
                                       backend="pallas"))
    before = hopper_kernels.LAUNCHES["btrsm"]
    got = tbt.blocked_trsm(_t(T), _t(b), lower=lower, backend="kernel")
    assert hopper_kernels.LAUNCHES["btrsm"] == before  # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    via_blas = tblas.blocked_trsm(_t(T), _t(b), lower=lower)
    assert torch.equal(via_blas, got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_trsm_packed_lu_matches(dtype):
    """A packed LU operand: the unit-lower and upper solves read only their
    own triangle."""
    rng = np.random.default_rng(33)
    A = _mat(rng, 2, 64, dtype)
    b = rng.standard_normal((2, 64, 3)).astype(dtype)
    for lower in (True, False):
        want = np.asarray(jbt.blocked_trsm(jnp.asarray(A), jnp.asarray(b), lower=lower,
                                           unit_diagonal=lower, backend="pallas"))
        got = tbt.blocked_trsm(_t(A), _t(b), lower=lower, unit_diagonal=lower)
        assert got.dtype == _t(b).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=_TOL[dtype] * 10,
                                   atol=_TOL[dtype])


def test_btrsm_plain_matches_block_loop():
    """The K3 kernel's plain version, which leaves a ragged n's pad columns
    of T unread, is the JAX block loop's function on the identity-extended
    T, system by system."""
    rng = np.random.default_rng(41)
    A = _t(_mat(rng, 3, 200, np.float32))
    b = _t(rng.standard_normal((3, 200, 5)).astype(np.float32))
    b0 = b.clone()
    for lower in (True, False):
        D = tbt.diag_block_inverses(A, lower=lower, unit_diagonal=lower)
        got = hopper_kernels.btrsm_plain(A, D, b, lower=lower)
        for i in range(3):
            want = jbt.blocked_solve(jnp.asarray(A[i].numpy()), jnp.asarray(D[i].numpy()),
                                     jnp.asarray(b[i].numpy()), lower=lower)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        assert torch.equal(b, b0)  # b is left untouched


def test_blocked_trsm_vector_rhs_and_shape_checks():
    rng = np.random.default_rng(5)
    T = _t(np.tril(_mat(rng, 2, 64, np.float32)))
    b = _t(rng.standard_normal((2, 64)).astype(np.float32))
    x = tbt.blocked_trsm(T, b)
    assert tuple(x.shape) == (2, 64)
    want = np.asarray(jbt.blocked_trsm(jnp.asarray(T.numpy()), jnp.asarray(b.numpy())))
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-5, atol=1e-6)
    x1 = tbt.blocked_trsm(T[0], b[0])
    assert tuple(x1.shape) == (64,)
    np.testing.assert_allclose(x1.numpy(), x[0].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="rhs"):
        tbt.blocked_trsm(T, b[:, :32])
    with pytest.raises(ValueError, match="T must be"):
        tbt.blocked_trsm(T[:, :32, :], b)
    # backend "xla" runs the same blocked solve (K3 on the card)
    assert torch.equal(tbt.blocked_trsm(T, b, backend="xla"), x)
