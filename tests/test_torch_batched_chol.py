"""Parity of the port's batched Cholesky (`conflux_tpu_torch.ops.batched_factor.
kernel_cholesky_factor_batched`, the K5 kernel's plain version on the CPU)
with the JAX package's `pallas_cholesky_factor_batched` in interpret mode,
on the same seeded numpy inputs; and the port's own per-slot contracts
(identity slots, batch and neighbour invariance, a non-SPD slot failing
alone). N stays <= 64: JAX interpret mode at N=256 costs ~13 s a cell.

Tolerances: the plain version rounds the product, the division and the
subtraction of each update separately, as the kernel does; XLA rewrites
some of the interpret path's arithmetic, so the two packages agree to
5e-6 (f32) and 1e-13 (f64) max abs on O(1) entries, not bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import pallas_factor as pf
from conflux_tpu_torch import batched as tbatched
from conflux_tpu_torch.ops import batched_factor as tbf
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels

_TOL = {np.float32: 5e-6, np.float64: 1e-13}


def _spd(rng, b, n, dtype):
    """SPD systems with O(1) entries: M M^T / n + I, M standard normal."""
    M = rng.standard_normal((b, n, n))
    return (np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype,b,n", [
    (np.float32, 4, 8), (np.float32, 4, 48), (np.float32, 32, 64), (np.float64, 4, 64)])
def test_cholesky_matches_pallas(dtype, b, n):
    rng = np.random.default_rng(11 * n + b)
    A = _spd(rng, b, n, dtype)
    w = np.sign(rng.standard_normal(n)).astype(dtype)
    jL, jwa = pf.pallas_cholesky_factor_batched(jnp.asarray(A), probe_w=jnp.asarray(w))
    L, wa = tbf.kernel_cholesky_factor_batched(_t(A), probe_w=_t(w))
    assert L.dtype == _t(A).dtype and tuple(L.shape) == (b, n, n)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=0, atol=_TOL[dtype])
    assert not np.triu(L.numpy(), 1).any()  # strict upper triangle exactly zero
    np.testing.assert_allclose(wa.numpy(), np.asarray(jwa), rtol=1e-5, atol=1e-5)
    # and the factors reconstruct A (accumulated in f64)
    Ln = L.numpy().astype(np.float64)
    np.testing.assert_allclose(np.einsum("bij,bkj->bik", Ln, Ln), A,
                               atol=1e-5 if dtype == np.float32 else 1e-12)


def test_both_triangles_are_read():
    """An input whose upper triangle differs from its lower one gives the
    TPU kernel's result (which updates both triangles), not the factor of
    its lower triangle alone."""
    rng = np.random.default_rng(5)
    A = _spd(rng, 2, 64, np.float32)
    P = A + np.triu(1e-3 * rng.standard_normal((2, 64, 64)), 1).astype(np.float32)
    jL = np.asarray(pf.pallas_cholesky_factor_batched(jnp.asarray(P)))
    L = tbf.kernel_cholesky_factor_batched(_t(P)).numpy()
    np.testing.assert_allclose(L, jL, rtol=0, atol=_TOL[np.float32])
    lower_only = np.linalg.cholesky(np.tril(P) + np.swapaxes(np.tril(P, -1), 1, 2))
    assert np.abs(L - lower_only).max() > 1e-5  # the perturbation reached L


def test_probe_is_bit_neutral():
    rng = np.random.default_rng(31)
    A = _t(_spd(rng, 4, 48, np.float32))
    w = _t(np.sign(rng.standard_normal(48)).astype(np.float32))
    L0 = tbf.kernel_cholesky_factor_batched(A)
    L1, wa = tbf.kernel_cholesky_factor_batched(A, probe_w=w)
    assert torch.equal(L0, L1)
    np.testing.assert_allclose(wa.numpy().astype(np.float64),
                               w.double().numpy() @ A.double().numpy(), rtol=1e-5, atol=1e-5)


def test_identity_slots_factor_to_exact_bits():
    rng = np.random.default_rng(3)
    eye = np.eye(64, dtype=np.float32)
    A = np.stack([_spd(rng, 1, 64, np.float32)[0], eye])
    L = tbf.kernel_cholesky_factor_batched(_t(A))
    assert torch.equal(L[1], _t(eye))


def test_slots_invariant_to_batch_and_neighbours():
    """Slot 0's bits do not depend on B (including B=1) or on the other
    slots (ragged N=48, which the reference identity-pads to 64 and the
    port runs as it is)."""
    rng = np.random.default_rng(29)
    A = _spd(rng, 4, 48, np.float32)
    junk = _spd(rng, 3, 48, np.float32) * 1e3
    L1 = tbf.kernel_cholesky_factor_batched(_t(A[:1]))
    L4 = tbf.kernel_cholesky_factor_batched(_t(A))
    Lj = tbf.kernel_cholesky_factor_batched(_t(np.concatenate([A[:1], junk])))
    assert torch.equal(L1[0], L4[0]) and torch.equal(L1[0], Lj[0])


def test_non_spd_slot_is_nan_alone():
    rng = np.random.default_rng(61)
    A = _spd(rng, 4, 32, np.float32)
    bad = A.copy()
    bad[1] = -bad[1]  # negative definite: the first pivot is negative
    Lc = tbf.kernel_cholesky_factor_batched(_t(A))
    Lb = tbf.kernel_cholesky_factor_batched(_t(bad))
    assert torch.isnan(Lb[1]).any()
    keep = [0, 2, 3]
    assert torch.equal(Lb[keep], Lc[keep])
    # the JAX kernel poisons the same slot and only it
    jL = np.asarray(pf.pallas_cholesky_factor_batched(jnp.asarray(bad)))
    assert np.isnan(jL[1]).any() and np.isfinite(jL[keep]).all()
    # an indefinite slot whose trouble starts mid-way
    late = A.copy()
    late[2, 20, 20] = -5.0
    Ll = tbf.kernel_cholesky_factor_batched(_t(late))
    assert torch.isnan(Ll[2]).any() and torch.equal(Ll[[0, 1, 3]], Lc[[0, 1, 3]])


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="batched factor"):
        tbf.kernel_cholesky_factor_batched(torch.eye(8))
    with pytest.raises(ValueError, match="probe_w"):
        tbf.kernel_cholesky_factor_batched(torch.eye(8)[None], probe_w=torch.ones(7))
    with pytest.raises(ValueError, match="float32 or float64"):
        tbf.kernel_cholesky_factor_batched(torch.eye(8, dtype=torch.bfloat16)[None])


def test_registry_and_batched_entries_route_to_the_kernel_function():
    rng = np.random.default_rng(41)
    A = _t(_spd(rng, 3, 64, np.float32))
    kL = tbf.kernel_cholesky_factor_batched(A)
    for L in (tblas.batched_cholesky_factor(A),
              tblas.batched_cholesky_factor(A, backend="kernel"),
              tbatched.cholesky_factor_batched(A, 16)):
        assert torch.equal(L, kL)
    # the library route (it raised before it was ported) against the JAX
    # "xla" route, and the batched blocked factor for a bf16 batch
    from conflux_tpu.ops import blas as jblas

    xL = tblas.batched_cholesky_factor(A, backend="xla")
    jL = jblas.batched_cholesky_factor(jnp.asarray(A.numpy()), backend="xla")
    np.testing.assert_allclose(xL.numpy(), np.asarray(jL), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="tile size"):
        tbatched.cholesky_factor_batched(A, 48)
    bL = tbatched.cholesky_factor_batched(A.bfloat16(), 16)
    assert bL.dtype == torch.bfloat16
    assert float(torch.linalg.norm(bL.float() - kL) / torch.linalg.norm(kL)) < 2 ** -6
    with pytest.raises(NotImplementedError, match="not ported"):
        tbatched.cholesky_factor_batched(A, 16, mesh=object())


def test_cholesky_solve_batched_matches_jax():
    from conflux_tpu import batched as jbatched

    rng = np.random.default_rng(43)
    A = _spd(rng, 3, 32, np.float32)
    b = rng.standard_normal((3, 32)).astype(np.float32)
    L = tbatched.cholesky_factor_batched(_t(A), 16)
    x = tbatched.cholesky_solve_batched(L, _t(b)).numpy()
    jx = np.asarray(jbatched.cholesky_solve_batched(jnp.asarray(L.numpy()), jnp.asarray(b)))
    np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-4
    xk = tbatched.cholesky_solve_batched(L, _t(b[:, :, None]))
    assert tuple(xk.shape) == (3, 32, 1) and torch.equal(xk[..., 0], _t(x))
    with pytest.raises(ValueError, match="rhs"):
        tbatched.cholesky_solve_batched(L, _t(b[:2]))


def test_plain_version_is_what_the_cpu_runs():
    rng = np.random.default_rng(47)
    A = _t(_spd(rng, 2, 32, np.float64))
    before = dict(hopper_kernels.LAUNCHES)
    L, wa = hopper_kernels.batched_chol(A)
    Lp, wap = hopper_kernels.batched_chol_plain(A)
    assert hopper_kernels.LAUNCHES == before and wa is None and wap is None
    assert torch.equal(L, Lp)
