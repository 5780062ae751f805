"""The port's distributed LU (`conflux_tpu_torch.lu.distributed`) on the
CPU: every grid runs as a threaded world of gloo ranks
(`parallel.mesh.run_threaded`), at the JAX package's test sizes (N = 32 to
64, v = 8), against

- the JAX package's program on its 8-device CPU mesh, in this process:
  pivots equal at every grid, factors allclose 1e-10 (float64 on the
  library route, Pz = 1) or 1e-9 (Pz > 1, where gloo and XLA sum the z
  partials in their own orders), and at float32 on the kernel
  configuration (the kernels' plain versions) within the port's float32
  bar, residual_bound(N, f32), per entry;
- the numpy executable spec (`conflux_tpu/spec/numpy_lu.simulate_lu`) in
  the chunked election regime;
- itself: lookahead bitwise the plain loop, `segs` and `update` invariant
  pivots, `lu_factor_steps` resuming bitwise at Pz = 1, the flat tree's
  height guard.

Float64 runs the JAX package's default route (backend "xla", the library
LU in the tournament): `XLA`, below.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conflux_tpu import solvers as jsolvers
from conflux_tpu import validation as jval
from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu.lu.distributed import lu_factor_distributed as jlu_factor
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.spec.numpy_lu import simulate_lu
from conflux_tpu_torch import solvers, validation
from conflux_tpu_torch.geometry import Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import (
    build_program,
    full_permutation,
    lu_distributed_host,
    lu_factor_distributed,
    lu_factor_steps,
)
from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards, run_threaded
from conflux_tpu_torch.validation import make_test_matrix, residual_bound

XLA = dict(backend="xla", panel_algo="auto")
TIMEOUT = 120.0  # seconds a threaded world may take
# the JAX package's parity runs use 2 x 2 segments: the same math as its
# default 16 x 16 (held within the port below) at a fraction of its
# program's compile time
SEGS = (2, 2)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: these small problems gain nothing from
    more, and the suite runs beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_factor(A, gridspec, v, **kw):
    grid = JGrid3(*gridspec)
    geom = JLUGeometry.create(A.shape[0], A.shape[1], v, grid)
    mesh = jmake_mesh(grid, devices=jax.devices()[: grid.P])
    out, perm = jlu_factor(jnp.asarray(geom.scatter(A)), geom, mesh, **kw)
    return geom.gather(np.asarray(out)), np.asarray(perm), geom, mesh, out, perm


def _port_factor(A, gridspec, v, **kw):
    """(gathered factors, perm) of every rank: the caller checks they agree."""
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(A.shape[0], A.shape[1], v, grid)
    S = geom.scatter(A)

    def fn(mesh):
        out, perm = lu_factor_distributed(distribute_shards(S, mesh), geom, mesh, **kw)
        return geom.gather(gather_shards(out, mesh).numpy()), perm.numpy()

    res = run_threaded(grid, fn, timeout=TIMEOUT)
    for LUp, perm in res[1:]:
        np.testing.assert_array_equal(perm, res[0][1])
        np.testing.assert_array_equal(LUp, res[0][0])
    return res[0][0], res[0][1], geom


@pytest.mark.parametrize("gridspec,election", [
    ((1, 1, 1), "gather"), ((2, 2, 1), "gather"), ((2, 1, 2), "gather"),
    ((2, 2, 2), "gather"), ((3, 2, 1), "butterfly")], ids=str)
def test_lu_matches_the_jax_program_float64(gridspec, election):
    N, v = 64, 8
    A = make_test_matrix(N, N, seed=3 + sum(gridspec))
    LUj, permj, *_ = _jax_factor(A, gridspec, v, election=election, segs=SEGS)
    LUp, perm, geom = _port_factor(A, gridspec, v, election=election, segs=SEGS, **XLA)
    np.testing.assert_array_equal(perm, permj)
    tol = 1e-10 if gridspec[2] == 1 else 1e-9
    np.testing.assert_allclose(LUp, LUj, rtol=tol, atol=tol)
    assert validation.lu_residual(geom.gather(geom.scatter(A)), LUp, perm) \
        < residual_bound(N, np.float64)


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 1, 1)], ids=str)
def test_lu_kernel_configuration_matches_the_jax_program_float32(gridspec):
    """The port's defaults (K1 trailing GEMMs, K2 elections: their plain
    versions on the CPU) against the JAX package's default float32
    program: the same pivots, factors within the float32 bar."""
    N, v = 256, 128
    A = make_test_matrix(N, N, seed=11, dtype=np.float32)
    LUj, permj, *_ = _jax_factor(A, gridspec, v, segs=SEGS)
    LUp, perm, _ = _port_factor(A, gridspec, v, backend="kernel", panel_algo="kernel",
                                segs=SEGS)
    np.testing.assert_array_equal(perm, permj)
    assert np.abs(LUp - LUj).max() <= residual_bound(N, np.float32)
    assert validation.lu_residual(A.astype(np.float64), LUp, perm) \
        < residual_bound(N, np.float32)


@pytest.mark.parametrize("gridspec", [(2, 1, 1), (2, 2, 1)], ids=str)
def test_lu_matches_the_numpy_spec_chunked(gridspec):
    """The chunked election regime (Ml > chunk locally, Px v > chunk in the
    election), as tests/test_spec.py holds the JAX program to the spec."""
    N, v, chunk = 64, 8, 16
    A = make_test_matrix(N, N, seed=101)
    LU_spec, piv_spec = simulate_lu(A, JGrid3(*gridspec), v, pivoting="tournament",
                                    panel_chunk=chunk)
    LU, perm, _ = _host_threaded(A, gridspec, v, panel_chunk=chunk)
    np.testing.assert_array_equal(perm[: piv_spec.size].reshape(piv_spec.shape), piv_spec)
    np.testing.assert_allclose(LU, LU_spec, atol=1e-10)


def _host_threaded(A, gridspec, v, **kw):
    """lu_distributed_host on every rank of a threaded world (rank 0's)."""
    grid = Grid3(*gridspec)
    res = run_threaded(grid, lambda mesh: lu_distributed_host(A, grid, v, mesh=mesh,
                                                              **XLA, **kw),
                       timeout=TIMEOUT)
    return res[0]


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 2, 1), (2, 2, 2), (3, 2, 1)], ids=str)
def test_lookahead_is_bitwise_the_plain_loop(gridspec):
    """float32 on the kernel GEMM (its plain version) with the library
    elections: the lookahead loop computes the next panel's slab in the
    same GEMMs as the plain loop, so every bit agrees."""
    N, v = 64, 8
    A = make_test_matrix(N, N, dtype=np.float32)
    a, pa, geom = _port_factor(A, gridspec, v, backend="kernel", panel_algo="auto")
    b, pb, _ = _port_factor(A, gridspec, v, backend="kernel", panel_algo="auto",
                            lookahead=True)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a, b)
    if gridspec == (3, 2, 1):  # odd Px: the butterfly's fold, under lookahead
        c, pc, _ = _port_factor(A, gridspec, v, backend="kernel", panel_algo="auto",
                                lookahead=True, election="butterfly", update="block")
        Ap = geom.gather(geom.scatter(A))
        assert validation.lu_residual(Ap, c, pc) < residual_bound(N, np.float32)


def test_segs_and_update_keep_the_pivots():
    """Segmentation partitions the same per-element math: any (row, col)
    segment counts and the one-block update give the same permutation and
    a correct factorization (2.5D grid)."""
    N, v = 64, 8
    A = make_test_matrix(N, N, seed=9)
    base = None
    for kw in ({"segs": (4, 8)}, {"segs": (1, 1)}, {"segs": (3, 5)},
               {"segs": (16, 16), "update": "block"}):
        LUp, perm, _ = _port_factor(A, (2, 2, 2), v, **XLA, **kw)
        assert validation.lu_residual(A, LUp, perm) < residual_bound(N, np.float64), kw
        if base is None:
            base = perm
        np.testing.assert_array_equal(perm, base)


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 2, 1), (2, 1, 2)], ids=str)
def test_factor_steps_resume(gridspec):
    """Two halves through the row-origin state: bitwise the uninterrupted
    run at Pz = 1 (the JAX package's contract), allclose at Pz > 1."""
    N, v = 64, 8
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, v, grid)
    A = make_test_matrix(N, N, seed=21, dtype=np.float32)
    S = geom.scatter(A)
    half = geom.n_steps // 2

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        full, perm = lu_factor_distributed(shard, geom, mesh, backend="kernel",
                                           panel_algo="auto")
        s1, o1, _ = lu_factor_steps(shard, geom, mesh, 0, half, backend="kernel",
                                    panel_algo="auto")
        # the orig state round-trips as the JAX package's (Px, Ml) map too
        o_all = mesh.all_gather(o1, "x").numpy()
        s2, o2, perm2 = lu_factor_steps(s1, geom, mesh, half, geom.n_steps, orig=o_all,
                                        backend="kernel", panel_algo="auto")
        return full.numpy(), perm.numpy(), s2.numpy(), perm2.numpy()

    for full, perm, resumed, perm2 in run_threaded(grid, fn, timeout=TIMEOUT):
        np.testing.assert_array_equal(perm, perm2)
        if grid.Pz == 1:
            np.testing.assert_array_equal(full, resumed)
        else:
            np.testing.assert_allclose(full, resumed, atol=1e-5)
    with pytest.raises(ValueError, match="orig state"):
        lu_factor_steps(S, geom, None, 1, 2)
    with pytest.raises(ValueError, match="outside"):
        lu_factor_steps(S, geom, None, 0, geom.n_steps + 1)


def test_flat_tree_and_its_height_guard():
    N, v = 64, 8
    A = make_test_matrix(N, N, seed=5)
    LUp, perm, _ = _port_factor(A, (2, 2, 1), v, tree="flat", panel_chunk=16, **XLA)
    assert validation.lu_residual(A, LUp, perm) < residual_bound(N, np.float64)
    with pytest.raises(ValueError, match="tree='flat' would stack"):
        # 32 nominee blocks of 1024 rows: above the 8192-row single call
        build_program(LUGeometry.create(32768, 32768, 1024, Grid3(1, 1, 1)), tree="flat",
                      panel_chunk=1024, **XLA)
    geom = LUGeometry.create(4096, 4096, 8, Grid3(1, 1, 1))
    for bad, msg in (({"election": "x"}, "election"), ({"segs": (0, 4)}, "segs"),
                     ({"tree": "x"}, "tree"), ({"update": "x"}, "update")):
        with pytest.raises(ValueError, match=msg):
            build_program(geom, **XLA, **bad)
    with pytest.raises(ValueError, match="K2"):  # v = 8 is no K2 panel
        build_program(geom, backend="kernel", panel_algo="kernel")
    with pytest.raises(ValueError, match="backend 'xla'"):
        build_program(geom, backend="kernel", panel_algo="auto", dtype=torch.float64)


def test_residual_and_solves_match_the_jax_package():
    """lu_residual_distributed, lu_solve_distributed and solve_distributed
    (classic refinement and GMRES-IR) at 2x2x1, float64."""
    N, v, gridspec = 64, 8, (2, 2, 1)
    A = make_test_matrix(N, N, seed=3)
    b = np.random.default_rng(0).standard_normal(N)
    _LUj, _pj, jgeom, jmesh, jout, jperm = _jax_factor(A, gridspec, v, segs=SEGS)
    jres = jval.lu_residual_distributed(jnp.asarray(jgeom.scatter(A)), jout, jperm,
                                        jgeom, jmesh)
    jx = np.asarray(jsolvers.lu_solve_distributed(jout, jperm, jgeom, jmesh, jnp.asarray(b)))
    jxr = np.asarray(jsolvers.solve_distributed(jnp.asarray(A), jnp.asarray(b),
                                                grid=JGrid3(*gridspec), v=v, mesh=jmesh,
                                                refine=2, segs=SEGS))
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, v, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        out, perm = lu_factor_distributed(shard, geom, mesh, segs=SEGS, **XLA)
        res = validation.lu_residual_distributed(shard, out, perm, geom, mesh)
        x = solvers.lu_solve_distributed(out, perm, geom, mesh, torch.from_numpy(b))
        X = solvers.lu_solve_distributed(out, perm, geom, mesh,
                                         torch.from_numpy(np.stack([b, 2 * b], 1)))
        xr = solvers.solve_distributed(torch.from_numpy(A), torch.from_numpy(b), grid=grid,
                                       v=v, mesh=mesh, refine=2, segs=SEGS, **XLA)
        xg = solvers.solve_distributed(torch.from_numpy(A), torch.from_numpy(b), grid=grid,
                                       v=v, mesh=mesh, ir="gmres", **XLA)
        return res, x.numpy(), X.numpy(), xr.numpy(), xg.numpy()

    results = run_threaded(grid, fn, timeout=TIMEOUT)
    res, x, X, xr, xg = results[0]
    assert res == pytest.approx(jres, rel=1e-6, abs=1e-16)
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(X, np.stack([jx, 2 * jx], 1), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(xr, jxr, rtol=1e-10, atol=1e-10)
    assert np.abs(A @ xg - b).max() < 1e-9
    for r in results[1:]:  # replicated on every rank
        np.testing.assert_array_equal(r[1], x)
    with pytest.raises(ValueError, match="unknown ir"):
        solvers.solve_distributed(torch.from_numpy(A), torch.from_numpy(b), grid=grid,
                                  ir="x")


def test_residual_catches_a_corrupted_factor():
    N, v, gridspec = 64, 8, (2, 2, 1)
    A = make_test_matrix(N, N, seed=13)
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, v, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        out, perm = lu_factor_distributed(shard, geom, mesh, **XLA)
        good = validation.lu_residual_distributed(shard, out, perm, geom, mesh)
        if mesh.rank == 1:
            out[3, 5] += 1.0
        bad = validation.lu_residual_distributed(shard, out, perm, geom, mesh)
        return good, bad

    good, bad = run_threaded(grid, fn, timeout=TIMEOUT)[0]
    assert good < residual_bound(N, np.float64) < 1e-3 < bad


def test_host_entry_padding_and_full_permutation():
    """Non-divisible N exercises the identity-padded corner (one rank);
    `full_permutation` appends the never-chosen rows."""
    N, v = 50, 8
    A = make_test_matrix(N, N, seed=5)
    LU, perm, geom = lu_distributed_host(A, Grid3(1, 1, 1), v, device="cpu", **XLA)
    assert geom.M == 56 and sorted(perm.tolist()) == list(range(56))
    Ap = np.eye(geom.M)
    Ap[:N, :N] = A
    assert validation.lu_residual(Ap, LU[perm], perm) < residual_bound(geom.M, np.float64)
    np.testing.assert_array_equal(full_permutation(np.array([[2, 0]]), 4), [2, 0, 1, 3])
