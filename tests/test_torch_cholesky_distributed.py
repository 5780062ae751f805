"""The port's distributed Cholesky (`conflux_tpu_torch.cholesky.distributed`)
on the CPU, each grid a threaded world of gloo ranks, against the JAX
package's program on its 8-device CPU mesh in this process (float64:
lower triangles allclose 1e-10 at Pz = 1, 1e-9 at Pz > 1) and within
itself (lookahead bitwise, `cholesky_factor_steps` resuming bitwise at
Pz = 1), with the grid residual and solve, the tile-local SPD generator
and a complex Hermitian system."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conflux_tpu import solvers as jsolvers
from conflux_tpu import validation as jval
from conflux_tpu.cholesky.distributed import cholesky_factor_distributed as jchol
from conflux_tpu.geometry import CholeskyGeometry as JCholeskyGeometry
from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu_torch import io as tio
from conflux_tpu_torch import solvers, validation
from conflux_tpu_torch.cholesky.distributed import (
    cholesky_distributed_host,
    cholesky_factor_distributed,
    cholesky_factor_steps,
)
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3
from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards, run_threaded
from conflux_tpu_torch.validation import residual_bound

TIMEOUT = 120.0
SEGS = (2, 2)  # the JAX program's compile time; the math of any segs


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: these small problems gain nothing from
    more, and the suite runs beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(N, seed=7):
    return validation.make_spd_matrix(N, seed=seed).numpy()


@pytest.mark.parametrize("gridspec", [(2, 2, 2), (3, 2, 1)], ids=str)
def test_cholesky_matches_the_jax_program_with_residual_and_solve(gridspec):
    N, v = 64, 8
    A = _spd(N)
    jgrid = JGrid3(*gridspec)
    jgeom = JCholeskyGeometry.create(N, v, jgrid)
    jmesh = jmake_mesh(jgrid, devices=jax.devices()[: jgrid.P])
    jS = jnp.asarray(jgeom.scatter(A))
    jout = jchol(jS, jgeom, jmesh, segs=SEGS)
    jres = jval.cholesky_residual_distributed(jS, jout, jgeom, jmesh)
    b = np.random.default_rng(1).standard_normal(jgeom.N)
    jx = np.asarray(jsolvers.cholesky_solve_distributed(jout, jgeom, jmesh, jnp.asarray(b)))
    grid = Grid3(*gridspec)
    geom = CholeskyGeometry.create(N, v, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        out = cholesky_factor_distributed(shard, geom, mesh, backend="xla", segs=SEGS)
        res = validation.cholesky_residual_distributed(shard, out, geom, mesh)
        x = solvers.cholesky_solve_distributed(out, geom, mesh, torch.from_numpy(b))
        return geom.gather(gather_shards(out, mesh).numpy()), res, x.numpy()

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    L, res, x = results[0]
    tol = 1e-10 if grid.Pz == 1 else 1e-9
    np.testing.assert_allclose(np.tril(L), np.tril(jgeom.gather(np.asarray(jout))),
                               rtol=tol, atol=tol)
    assert res == pytest.approx(jres, rel=1e-6, abs=1e-16)
    assert res < residual_bound(N, np.float64)
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-10)
    for r in results[1:]:
        np.testing.assert_array_equal(r[2], x)


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 2, 1), (3, 2, 1)], ids=str)
def test_lookahead_is_bitwise_and_steps_resume(gridspec):
    """float32 on the kernel GEMM's plain version: lookahead bitwise the
    plain loop; two halves of `cholesky_factor_steps` bitwise the
    uninterrupted run (Pz = 1)."""
    N, v = 64, 8
    grid = Grid3(*gridspec)
    geom = CholeskyGeometry.create(N, v, grid)
    A = _spd(geom.N).astype(np.float32)
    S = geom.scatter(A)
    half = geom.Kappa // 2

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        plain = cholesky_factor_distributed(shard, geom, mesh, backend="kernel")
        la = cholesky_factor_distributed(shard, geom, mesh, backend="kernel", lookahead=True)
        s1 = cholesky_factor_steps(shard, geom, mesh, 0, half, backend="kernel")
        s2 = cholesky_factor_steps(s1, geom, mesh, half, geom.Kappa, backend="kernel")
        return plain.numpy(), la.numpy(), s2.numpy()

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    for plain, la, resumed in results:
        np.testing.assert_array_equal(plain, la)
        np.testing.assert_array_equal(resumed, plain)
    # Pz = 1: rank x Py + y holds shard (x, y)
    L = np.tril(geom.gather(np.stack([r[0] for r in results])
                            .reshape(grid.Px, grid.Py, geom.Ml, geom.Nl)))
    assert validation.cholesky_residual(A.astype(np.float64), L) < residual_bound(N, np.float32)
    with pytest.raises(ValueError, match="outside"):
        cholesky_factor_steps(S, geom, None, 0, geom.Kappa + 1)


def test_tile_local_generator_on_the_2p5d_grid():
    """Each rank builds only its own shard (`io.generate_spd_local`, the
    multihost path) on a 2.5D grid; the residual holds, and the segment
    counts do not change the factor beyond rounding."""
    N, v = 64, 8
    grid = Grid3(2, 1, 2)
    geom = CholeskyGeometry.create(N, v, grid)
    calls = []

    def fill(px, py):
        calls.append((px, py))
        return tio.generate_spd_local(geom, px, py)

    def fn(mesh):
        shard = distribute_shards(fill, mesh, shape=(grid.Px, grid.Py, geom.Ml, geom.Nl),
                                  dtype=np.float64)
        a = cholesky_factor_distributed(shard, geom, mesh, backend="xla", segs=(1, 1))
        b = cholesky_factor_distributed(shard, geom, mesh, backend="xla", segs=(3, 2))
        return validation.cholesky_residual_distributed(shard, a, geom, mesh), \
            float((torch.tril(a) - torch.tril(b)).abs().max())

    for res, diff in run_threaded(grid, fn, timeout=TIMEOUT):
        assert res < residual_bound(N, np.float64) and diff < 1e-12
    assert sorted(calls) == [(0, 0), (0, 0), (1, 0), (1, 0)]  # each rank its own shard


def test_host_entry_pads_and_factors_a_complex_hermitian_matrix():
    N, v = 50, 8
    A = validation.make_hpd_matrix(N).numpy()
    L, geom = cholesky_distributed_host(A, Grid3(1, 1, 1), v, backend="xla", device="cpu")
    assert geom.N == 56
    Ap = np.eye(geom.N, dtype=A.dtype)
    Ap[:N, :N] = A
    assert validation.cholesky_residual(Ap, L) < residual_bound(N, np.float64)
    with pytest.raises(ValueError, match="square"):
        cholesky_distributed_host(A[:, :40], Grid3(1, 1, 1), v, device="cpu")
