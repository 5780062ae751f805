"""Complex128 on grids of several ranks: the port's grid LU, Cholesky and
QR, and the LU and Cholesky solves, against the JAX package's programs on
its 8-device CPU mesh in this process, at the sizes of the JAX package's
complex grid tests (`tests/test_dtypes.py`: N=64, v=8). Every grid runs
as a threaded world of gloo ranks (`parallel.mesh.run_threaded`), and
every collective there carries complex tensors as their real and
imaginary parts (`Mesh.all_gather`, `Mesh.ppermute`, the sums).

Tolerances: factors and solves allclose 1e-10 to the JAX package's at
Pz = 1, 1e-9 at Pz > 1 (gloo and XLA sum the z partials in their own
orders), and each within the JAX test's own residual bar. Every rank
returns the same gathered factor, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conflux_tpu import solvers as jsolvers
from conflux_tpu.cholesky.distributed import cholesky_factor_distributed as jchol
from conflux_tpu.geometry import CholeskyGeometry as JCholeskyGeometry
from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu.lu.distributed import lu_factor_distributed as jlu
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.qr.distributed import qr_blocked_distributed_host as jqr_host
from conflux_tpu_torch import solvers, validation
from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import lu_distributed_host, lu_factor_distributed
from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards, run_threaded
from conflux_tpu_torch.qr.distributed import qr_blocked_distributed_host
from conflux_tpu_torch.validation import residual_bound

XLA = dict(backend="xla", panel_algo="auto")  # the routes complex runs on
TIMEOUT = 120.0
SEGS = (2, 2)  # the JAX program's compile time; the math of any segs
N, V = 64, 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _complex_matrix(n: int, seed: int) -> np.ndarray:
    """`tests/test_dtypes.py`'s make_complex_matrix."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
    A[np.arange(n), np.arange(n)] += 2.0 + 2.0j
    return A.astype(np.complex128)


def _tol(gridspec) -> float:
    return 1e-10 if gridspec[2] == 1 else 1e-9


def _same_on_every_rank(results) -> None:
    for r in results[1:]:
        for a, b in zip(r, results[0]):
            np.testing.assert_array_equal(a, b)


def _jax_lu(A, gridspec):
    grid = JGrid3(*gridspec)
    geom = JLUGeometry.create(N, N, V, grid)
    mesh = jmake_mesh(grid, devices=jax.devices()[: grid.P])
    out, perm = jlu(jnp.asarray(geom.scatter(A)), geom, mesh, segs=SEGS)
    return geom, mesh, out, perm


@pytest.mark.parametrize("gridspec", [(2, 2, 1), (2, 1, 2)], ids=str)
def test_lu_distributed_complex(gridspec):
    """`test_dtypes.py::test_lu_distributed_complex` (2x2x1), and on 2x1x2."""
    A = _complex_matrix(N, seed=5)
    jgeom, _jmesh, jout, jperm = _jax_lu(A, gridspec)
    LUj = jgeom.gather(np.asarray(jout))
    grid = Grid3(*gridspec)

    def fn(mesh):
        LU, perm, geom = lu_distributed_host(A, grid, V, mesh=mesh, segs=SEGS, **XLA)
        return LU, perm

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    _same_on_every_rank(results)
    LU, perm = results[0]
    assert LU.dtype == np.complex128
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    tol = _tol(gridspec)
    np.testing.assert_allclose(LU[perm], LUj, rtol=tol, atol=tol)
    assert validation.lu_residual(A, LU[perm], perm) < residual_bound(N, np.float64)


def test_lu_solve_distributed_complex():
    """`test_dtypes.py::test_lu_solve_distributed_complex`: factor, the grid
    residual and the grid solve of a complex right-hand side, 2x2x1."""
    gridspec = (2, 2, 1)
    A = _complex_matrix(N, seed=23)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    jgeom, jmesh, jout, jperm = _jax_lu(A, gridspec)
    jx = np.asarray(jsolvers.lu_solve_distributed(jout, jperm, jgeom, jmesh, jnp.asarray(b)))
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, V, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        out, perm = lu_factor_distributed(shard, geom, mesh, segs=SEGS, **XLA)
        res = validation.lu_residual_distributed(shard, out, perm, geom, mesh)
        x = solvers.lu_solve_distributed(out, perm, geom, mesh, torch.from_numpy(b))
        return geom.gather(gather_shards(out, mesh).numpy()), perm.numpy(), x.numpy(), res

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    _same_on_every_rank(results)
    LUp, perm, x, res = results[0]
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    np.testing.assert_allclose(LUp, jgeom.gather(np.asarray(jout)), rtol=1e-10, atol=1e-10)
    assert res < residual_bound(N, np.float64), res
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-10)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def _cholesky(gridspec, seed, b=None):
    A = validation.make_hpd_matrix(N, seed=seed).numpy()
    jgrid = JGrid3(*gridspec)
    jgeom = JCholeskyGeometry.create(N, V, jgrid)
    jmesh = jmake_mesh(jgrid, devices=jax.devices()[: jgrid.P])
    jout = jchol(jnp.asarray(jgeom.scatter(A)), jgeom, jmesh, segs=SEGS)
    jx = None if b is None else np.asarray(
        jsolvers.cholesky_solve_distributed(jout, jgeom, jmesh, jnp.asarray(b)))
    grid = Grid3(*gridspec)
    geom = CholeskyGeometry.create(N, V, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        out = cholesky_factor_distributed(shard, geom, mesh, backend="xla", segs=SEGS)
        res = validation.cholesky_residual_distributed(shard, out, geom, mesh)
        L = np.tril(geom.gather(gather_shards(out, mesh).numpy()))
        if b is None:
            return L, res
        return L, res, solvers.cholesky_solve_distributed(
            out, geom, mesh, torch.from_numpy(b)).numpy()

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    _same_on_every_rank(results)
    return A, np.tril(jgeom.gather(np.asarray(jout))), jx, results[0]


@pytest.mark.parametrize("gridspec", [(2, 2, 1), (2, 2, 2)], ids=str)
def test_cholesky_distributed_complex(gridspec):
    """`test_dtypes.py::test_cholesky_distributed_complex` (2x2x2), and on
    2x2x1."""
    A, Lj, _, (L, res) = _cholesky(gridspec, seed=13)
    assert L.dtype == np.complex128
    tol = _tol(gridspec)
    np.testing.assert_allclose(L, Lj, rtol=tol, atol=tol)
    assert res < residual_bound(N, np.float64), res
    assert validation.cholesky_residual(A, L) < residual_bound(N, np.float64)
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-8)


def test_cholesky_solve_distributed_complex():
    """`test_dtypes.py::test_cholesky_solve_distributed_complex`, 2x2x1."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    A, Lj, jx, (L, res, x) = _cholesky((2, 2, 1), seed=17, b=b)
    np.testing.assert_allclose(L, Lj, rtol=1e-10, atol=1e-10)
    assert res < residual_bound(N, np.float64), res
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-10)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def test_qr_distributed_complex():
    """`test_dtypes.py::test_qr_distributed_complex`: a (64, 32) complex
    block-cyclic QR on 2x2x1, with the JAX test's bars."""
    rng = np.random.default_rng(67)
    A = (rng.standard_normal((64, 32)) + 1j * rng.standard_normal((64, 32))
         ).astype(np.complex128)
    Qj, Rj, _ = jqr_host(A, JGrid3(2, 2, 1), V)
    grid = Grid3(2, 2, 1)

    def fn(mesh):
        Q, R, _geom = qr_blocked_distributed_host(A, grid, V, mesh=mesh, backend="xla")
        return Q, R

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    _same_on_every_rank(results)
    Q, R = results[0]
    assert Q.dtype == np.complex128
    np.testing.assert_allclose(Q, np.asarray(Qj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(R, np.asarray(Rj), rtol=1e-10, atol=1e-10)
    assert np.linalg.norm(Q @ R - A) / np.linalg.norm(A) < 1e-13
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(32)) < 1e-12


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=str)
def test_mesh_collectives_carry_complex_tensors(dtype):
    """`all_gather` and `ppermute` of complex tensors on two ranks return
    the caller's complex dtype with every value; `pmax` still refuses
    complex values, and the wire itself takes real tensors only."""
    grid = Grid3(2, 1, 1)

    def fn(mesh):
        x = mesh.x
        t = torch.tensor([1 + 2j * x, -3j + x], dtype=dtype)
        g = mesh.all_gather(t, "x")
        p = mesh.ppermute(t.conj(), "x", [(0, 1), (1, 0)])
        with pytest.raises(TypeError, match="max of complex"):
            mesh.pmax(t.clone(), "x")
        with pytest.raises(TypeError, match="real tensors"):
            mesh._wire(t)
        return g, p

    for x, (g, p) in enumerate(run_threaded(grid, fn, timeout=TIMEOUT)):
        want = [torch.tensor([1 + 2j * r, -3j + r], dtype=dtype) for r in (0, 1)]
        assert g.dtype == p.dtype == dtype
        torch.testing.assert_close(g, torch.stack(want), rtol=0, atol=0)
        torch.testing.assert_close(p, want[1 - x].conj(), rtol=0, atol=0)
