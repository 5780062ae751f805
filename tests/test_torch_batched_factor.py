"""Parity of the port's batched LU factor (`conflux_tpu_torch.ops.batched_factor`,
the K4 kernel's plain version on the CPU) with the JAX package's
`pallas_lu_factor_batched` in interpret mode, on the same seeded numpy
inputs; and the port's own per-slot contracts (identity slots, batch and pad
invariance, a NaN slot failing alone). N stays <= 64: JAX interpret mode at
N=256 costs ~13 s a cell."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import pallas_factor as pf
from conflux_tpu_torch import batched as tbatched
from conflux_tpu_torch.ops import batched_factor as tbf
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels


def _gen(rng, b, n, dtype):
    return (rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


_TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dtype,n,b", [
    (np.float32, 8, 1), (np.float32, 8, 4), (np.float32, 48, 1), (np.float32, 48, 4),
    (np.float32, 64, 1), (np.float32, 64, 4), (np.float64, 8, 4), (np.float64, 64, 4)])
def test_lu_matches_pallas(dtype, n, b):
    rng = np.random.default_rng(7 * n + b)
    A = _gen(rng, b, n, dtype)
    w = np.sign(rng.standard_normal(n)).astype(dtype)
    jLU, jperm, jwa = pf.pallas_lu_factor_batched(jnp.asarray(A), probe_w=jnp.asarray(w))
    LU, perm, wa = tbf.kernel_lu_factor_batched(_t(A), probe_w=_t(w))
    assert LU.dtype == _t(A).dtype and tuple(perm.shape) == (b, n)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(LU.numpy(), np.asarray(jLU), rtol=0, atol=_TOL[dtype])
    np.testing.assert_allclose(wa.numpy(), np.asarray(jwa), rtol=1e-5, atol=1e-5)
    # and the factors reconstruct A[perm] (accumulated in f64)
    LUn = LU.numpy().astype(np.float64)
    for i in range(b):
        L = np.tril(LUn[i], -1) + np.eye(n)
        np.testing.assert_allclose(L @ np.triu(LUn[i]), A[i][perm[i].numpy()],
                                   atol=5e-4 if dtype == np.float32 else 1e-10)


def test_probe_is_bit_neutral():
    rng = np.random.default_rng(31)
    A = _t(_gen(rng, 4, 48, np.float32))
    w = _t(np.sign(rng.standard_normal(48)).astype(np.float32))
    LU0, p0 = tbf.kernel_lu_factor_batched(A)
    LU1, p1, wa = tbf.kernel_lu_factor_batched(A, probe_w=w)
    assert torch.equal(LU0, LU1) and torch.equal(p0, p1)
    np.testing.assert_allclose(wa.numpy().astype(np.float64),
                               w.double().numpy() @ A.double().numpy(), rtol=1e-4, atol=1e-4)


def test_identity_slots_factor_to_exact_bits():
    rng = np.random.default_rng(3)
    eye = np.eye(64, dtype=np.float32)
    A = np.stack([_gen(rng, 1, 64, np.float32)[0], eye])
    LU, perm = tbf.kernel_lu_factor_batched(_t(A))
    assert torch.equal(LU[1], _t(eye))
    assert torch.equal(perm[1], torch.arange(64))


def test_slots_invariant_to_batch_and_pad_contents():
    """Slot 0's bits do not depend on B or on the other slots (ragged N=48,
    which the reference identity-pads to 64 and the port runs as it is)."""
    rng = np.random.default_rng(29)
    A = _gen(rng, 4, 48, np.float32)
    junk = 1e3 * rng.standard_normal((3, 48, 48)).astype(np.float32)
    LU1, p1 = tbf.kernel_lu_factor_batched(_t(A[:1]))
    LU4, p4 = tbf.kernel_lu_factor_batched(_t(A))
    LUj, pj = tbf.kernel_lu_factor_batched(_t(np.concatenate([A[:1], junk])))
    for LU, p in ((LU4, p4), (LUj, pj)):
        assert torch.equal(LU1[0], LU[0]) and torch.equal(p1[0], p[0])


def test_nan_slot_fails_alone():
    rng = np.random.default_rng(61)
    A = _gen(rng, 4, 32, np.float32)
    bad = A.copy()
    bad[1] = np.nan
    LUc, pc = tbf.kernel_lu_factor_batched(_t(A))
    LUp, pp = tbf.kernel_lu_factor_batched(_t(bad))
    assert not torch.isfinite(LUp[1]).any()
    assert bool(((pp[1] >= 0) & (pp[1] < 32)).all())  # nothing out of range
    keep = [0, 2, 3]
    assert torch.equal(LUp[keep], LUc[keep]) and torch.equal(pp[keep], pc[keep])
    # a single NaN entry poisons its slot too
    one = A.copy()
    one[2, 5, 7] = np.nan
    LUo, _po = tbf.kernel_lu_factor_batched(_t(one))
    assert not torch.isfinite(LUo[2]).all()
    assert torch.equal(LUo[[0, 1, 3]], LUc[[0, 1, 3]])


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="batched factor"):
        tbf.kernel_lu_factor_batched(torch.eye(8))
    with pytest.raises(ValueError, match="batched factor"):
        tbf.kernel_lu_factor_batched(torch.zeros((2, 8, 4)))
    with pytest.raises(ValueError, match="probe_w"):
        tbf.kernel_lu_factor_batched(torch.zeros((2, 8, 8)), probe_w=torch.ones(7))
    with pytest.raises(ValueError, match="float32 or float64"):
        tbf.kernel_lu_factor_batched(torch.zeros((2, 8, 8), dtype=torch.bfloat16))


def test_registry_and_batched_entry_route_to_the_kernel_function():
    rng = np.random.default_rng(41)
    A = _t(_gen(rng, 3, 64, np.float32))
    kLU, kperm = tbf.kernel_lu_factor_batched(A)
    for LU, perm in (tblas.batched_lu_factor(A), tblas.batched_lu_factor(A, backend="kernel"),
                     tbatched.lu_factor_batched(A, 16)):
        assert torch.equal(LU, kLU) and torch.equal(perm, kperm)
    # the library route (it raised before it was ported): the JAX "xla"
    # route's pivots, and the batched blocked factor for a bf16 batch
    from conflux_tpu.ops import blas as jblas

    xLU, xperm = tblas.batched_lu_factor(A, backend="xla")
    jLU, jperm = jblas.batched_lu_factor(jnp.asarray(A.numpy()), backend="xla")
    np.testing.assert_array_equal(xperm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(xLU.numpy(), np.asarray(jLU), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="tile size"):
        tbatched.lu_factor_batched(A, 48)
    tblas.set_panel_algo("auto")
    try:
        bLU, bperm = tbatched.lu_factor_batched(A.bfloat16(), 16, backend="xla")
    finally:
        tblas.set_panel_algo("kernel")
    assert bLU.dtype == torch.bfloat16 and tuple(bperm.shape) == (3, 64)
    with pytest.raises(NotImplementedError, match="not ported"):
        tbatched.lu_factor_batched(A, 16, mesh=object())


def test_plain_version_is_what_the_cpu_runs():
    rng = np.random.default_rng(43)
    A = _t(_gen(rng, 2, 32, np.float64))
    before = dict(hopper_kernels.LAUNCHES)
    LU, perm, wa = hopper_kernels.batched_lu(A)
    LUp, permp, wap = hopper_kernels.batched_lu_plain(A)
    assert hopper_kernels.LAUNCHES == before and wa is None and wap is None
    assert torch.equal(LU, LUp) and torch.equal(perm, permp)


def test_stack_and_unstack_trees_round_trip():
    rng = np.random.default_rng(47)
    trees = [(_t(rng.standard_normal((3, 3))), None, _t(np.arange(3) + i)) for i in range(4)]
    st = tbatched.stack_trees(trees)
    assert st[1] is None and tuple(st[0].shape) == (4, 3, 3)
    back = tbatched.unstack_tree(st, 4)
    for got, want in zip(back, trees):
        assert got[1] is None
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
