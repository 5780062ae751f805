"""The port's distributed QR (`conflux_tpu_torch.qr.distributed`), its grid
residual and its least-squares solves on the CPU: every grid a threaded
world of gloo ranks (`parallel.mesh.run_threaded`), at the JAX package's
test sizes (tests/test_qr.py, test_resume.py), against

- the JAX package's programs on its 8-device CPU mesh, in this process:
  nothing is pivoted, so Q and R are compared allclose, float64 within
  1e-10 (scaled by max |R|) where Pz = 1 and 1e-9 where Pz > 1 (gloo and
  XLA sum the z partials in their own orders); float32 on the kernel
  route (K1's plain version here) within residual_bound(N, f32) per entry;
- itself: R bitwise identical on every rank, lookahead bitwise the plain
  loop, `qr_factor_steps` resuming bitwise at Pz = 1, csegs invariance.

Float64 runs backend "xla" (the JAX package's default route; K1 has no
float64 instance)."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import solvers as jsolvers
from conflux_tpu import validation as jval
from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.qr import distributed as jqr
from conflux_tpu_torch import solvers, validation
from conflux_tpu_torch.geometry import Grid3, LUGeometry
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.parallel.mesh import (
    distribute_shards,
    gather_shards,
    make_mesh,
    run_threaded,
)
from conflux_tpu_torch.qr.distributed import (
    build_program,
    cholesky_qr2_distributed,
    qr_blocked_distributed_host,
    qr_distributed_host,
    qr_factor_distributed,
    qr_factor_steps,
    r_geometry,
    tsqr_distributed,
)
from conflux_tpu_torch.qr.single import _tree_r
from conflux_tpu_torch.validation import residual_bound

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 120.0
XLA = dict(backend="xla")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: these small problems gain nothing from
    more, and the suite runs beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(t, j, tol):
    """allclose scaled by max |j| (tests/test_qr.py's bar against numpy)."""
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, atol=tol * np.abs(j).max(),
                               rtol=0)


def _same_on_every_rank(results):
    for r in results[1:]:
        for a, b in zip(r, results[0]):
            np.testing.assert_array_equal(a, b)


def _jmesh(grid):
    return jmake_mesh(JGrid3(*grid), devices=jax.devices()[: int(np.prod(grid))])


# --------------------------------------------------------------------------- #
# tall-skinny: TSQR and CholeskyQR2 over x
# --------------------------------------------------------------------------- #


def _tall(A, Px, fn):
    """fn(mesh, shards) -> (Q_shard, R) on every rank of a Px x 1 x 1 world;
    returns (Q, R) gathered, with R checked bitwise on every rank."""
    Ml = A.shape[0] // Px
    shards = A.reshape(Px, Ml, -1)

    def rank(mesh):
        Q, R = fn(mesh, shards)
        return mesh.all_gather(Q, "x").numpy().reshape(A.shape), R.numpy()

    res = run_threaded(Grid3(Px, 1, 1), rank, timeout=TIMEOUT)
    _same_on_every_rank(res)
    return res[0]


@pytest.mark.parametrize("Px", [1, 2, 4, 8])
def test_tsqr_matches_the_jax_program(Px):
    rng = np.random.default_rng(11 + Px)
    M, n = 64 * Px, 24
    A = rng.standard_normal((M, n))
    jQ, jR = jqr.tsqr_distributed(A.reshape(Px, M // Px, n), _jmesh((Px, 1, 1)))
    Q, R = _tall(A, Px, lambda mesh, s: tsqr_distributed(s, mesh))
    _close(R, jR, 1e-10)
    _close(Q, np.asarray(jQ).reshape(M, n), 1e-10)
    assert np.linalg.norm(Q @ R - A) / np.linalg.norm(A) < residual_bound(n, np.float64)


@pytest.mark.parametrize("Px", [4, 3])
def test_tsqr_butterfly_matches_the_jax_butterfly_and_the_gather_tree(Px):
    """The hypercube reduction (Px = 3 folds its overflow rank in and out)
    against the JAX butterfly, and allclose the gather tree."""
    rng = np.random.default_rng(101 + Px)
    Ml, n = 48, 16
    A = rng.standard_normal((Px * Ml, n))
    jQ, jR = jqr.tsqr_distributed(A.reshape(Px, Ml, n), _jmesh((Px, 1, 1)),
                                  tree="butterfly")
    Q, R = _tall(A, Px, lambda mesh, s: tsqr_distributed(s, mesh, tree="butterfly"))
    _close(R, jR, 1e-10)
    _close(Q, np.asarray(jQ).reshape(-1, n), 1e-10)
    _, Rg = _tall(A, Px, lambda mesh, s: tsqr_distributed(s, mesh))
    _close(R, Rg, 1e-10)


def test_tree_of_an_all_zero_stack_is_finite():
    """The butterfly's zero-fill contract: the reducer stays total on zeros."""
    R = _tree_r(torch.zeros((32, 16), dtype=torch.float64), 16)
    assert torch.isfinite(R).all() and not R.any()


def test_cholesky_qr2_and_host_padding_match_the_jax_programs():
    rng = np.random.default_rng(17)
    Px, Ml, n = 4, 32, 16
    A = rng.standard_normal((Px * Ml, n))
    jQ, jR = jqr.cholesky_qr2_distributed(A.reshape(Px, Ml, n), _jmesh((Px, 1, 1)))
    Q, R = _tall(A, Px, lambda mesh, s: cholesky_qr2_distributed(s, mesh))
    _close(R, jR, 1e-10)
    _close(Q, np.asarray(jQ).reshape(-1, n), 1e-10)
    # M = 50 not a multiple of Px = 4: zero rows padded, dropped from Q
    B = rng.standard_normal((50, 8))
    jQb, jRb = jqr.qr_distributed_host(B, 4, mesh=_jmesh((4, 1, 1)))
    res = run_threaded(Grid3(4, 1, 1), lambda mesh: qr_distributed_host(B, 4, mesh=mesh),
                       timeout=TIMEOUT)
    _same_on_every_rank(res)
    Qb, Rb = res[0]
    assert Qb.shape == (50, 8)
    _close(Rb, jRb, 1e-10)
    _close(Qb, jQb, 1e-10)
    with pytest.raises(ValueError, match="M >= n"):
        qr_distributed_host(np.zeros((4, 8)), 1, device="cpu")


# --------------------------------------------------------------------------- #
# block-cyclic QR
# --------------------------------------------------------------------------- #


def _jax_host(A, gridspec, v):
    grid = JGrid3(*gridspec)
    Q, R, _ = jqr.qr_blocked_distributed_host(A, grid, v, mesh=_jmesh(gridspec))
    return Q, R


def _port_host(A, gridspec, v, **kw):
    grid = Grid3(*gridspec)
    res = run_threaded(grid, lambda mesh: qr_blocked_distributed_host(A, grid, v, mesh=mesh,
                                                                      **kw)[:2],
                       timeout=TIMEOUT)
    _same_on_every_rank(res)
    return res[0]


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 2, 1), (2, 1, 2), (2, 2, 2), (4, 2, 1)],
                         ids=str)
def test_qr_factor_distributed_matches_the_jax_program(gridspec):
    N, v = 64, 8
    A = np.random.default_rng(29 + int(np.prod(gridspec))).standard_normal((N, N))
    jQ, jR = _jax_host(A, gridspec, v)
    Q, R = _port_host(A, gridspec, v, **XLA)
    tol = 1e-10 if gridspec[2] == 1 else 1e-9
    _close(R, jR, tol)
    _close(Q, jQ, tol)
    assert np.linalg.norm(Q @ R - A) / np.linalg.norm(A) < residual_bound(N, np.float64)


@pytest.mark.parametrize("shape,gridspec", [
    ((128, 48), (2, 2, 1)),  # rectangular
    ((96, 48), (4, 2, 1)),   # Nt % Px != 0: R's pad tiles sliced away
    ((50, 20), (2, 2, 1)),   # ragged: the identity pad fits the row padding
    ((70, 33), (2, 2, 1)),   # ragged: the row padding grows to hold it
], ids=str)
def test_rectangular_and_ragged_sizes_match_the_jax_program(shape, gridspec):
    A = np.random.default_rng(sum(shape)).standard_normal(shape)
    jQ, jR = _jax_host(A, gridspec, 8)
    Q, R = _port_host(A, gridspec, 8, **XLA)
    assert Q.shape == shape and R.shape == (shape[1], shape[1])
    _close(R, jR, 1e-10)
    _close(Q, jQ, 1e-10)


def _port_shards(A, gridspec, v, dtype=None, **kw):
    """(Q, R) gathered from qr_factor_distributed on this rank's shards."""
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(A.shape[0], A.shape[1], v, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        if dtype is not None:
            shard = shard.to(dtype)
        Qs, Rs = qr_factor_distributed(shard, geom, mesh, **kw)
        return (gather_shards(Qs.float() if dtype else Qs, mesh).numpy(),
                gather_shards(Rs.float() if dtype else Rs, mesh).numpy(), str(Qs.dtype))

    res = run_threaded(grid, fn, timeout=TIMEOUT)
    _same_on_every_rank([r[:2] for r in res])
    Qs, Rs, dt = res[0]
    N = A.shape[1]
    return geom.gather(Qs), np.triu(r_geometry(geom).gather(Rs)[:N, :N]), dt


def test_float32_kernel_route_and_bfloat16_shards():
    """float32 on the kernel route (K1's plain version) against the JAX
    float32 program within residual_bound(N, f32); bfloat16 shards compute
    their panels in float32 and store bfloat16, as the JAX test holds."""
    N, v, gridspec = 64, 8, (2, 2, 1)
    A = np.random.default_rng(89).standard_normal((N, N)).astype(np.float32)
    jgeom = JLUGeometry.create(N, N, v, JGrid3(*gridspec))
    jmesh = _jmesh(gridspec)
    jQs, jRs = jqr.qr_factor_distributed(jnp.asarray(jgeom.scatter(A)), jgeom, jmesh)
    jQ = jgeom.gather(np.asarray(jQs))
    jR = np.triu(jqr.r_geometry(jgeom).gather(np.asarray(jRs))[:N])
    Q, R, dt = _port_shards(A, gridspec, v, backend="kernel")
    assert dt == "torch.float32"
    bar = residual_bound(N, np.float32)
    assert np.abs(Q - jQ).max() <= bar and np.abs(R - jR).max() / np.abs(jR).max() <= bar
    Qb, Rb, dt = _port_shards(A, gridspec, v, dtype=torch.bfloat16, backend="kernel")
    assert dt == "torch.bfloat16"
    eps = 2.0 ** -7
    A64 = A.astype(np.float64)
    rec = np.linalg.norm(Qb @ Rb - A64) / np.linalg.norm(A64)
    orth = np.linalg.norm(Qb.T @ Qb - np.eye(N)) / np.sqrt(N)
    assert 1e-6 < rec < 0.5 * eps * np.sqrt(N) and orth < 0.5 * eps * np.sqrt(N), (rec, orth)
    jQb, jRb = jqr.qr_factor_distributed(jnp.asarray(jgeom.scatter(A)).astype(jnp.bfloat16),
                                         jgeom, jmesh)
    jrec = np.linalg.norm(jgeom.gather(np.asarray(jQb, np.float64))
                          @ np.triu(jqr.r_geometry(jgeom).gather(
                              np.asarray(jRb, np.float64))[:N]) - A64) / np.linalg.norm(A64)
    assert rec < 4 * jrec, (rec, jrec)


@pytest.mark.parametrize("gridspec", [(2, 2, 2), (4, 2, 1)], ids=str)
def test_grid_residual_matches_the_jax_oracle_and_flags_a_corrupted_q(gridspec):
    N, v = 64, 8
    grid = Grid3(*gridspec)
    A = np.random.default_rng(grid.P).standard_normal((N, N))
    jgeom = JLUGeometry.create(N, N, v, JGrid3(*gridspec))
    jmesh = _jmesh(gridspec)
    jS = jnp.asarray(jgeom.scatter(A))
    jQs, jRs = jqr.qr_factor_distributed(jS, jgeom, jmesh)
    jres, jorth = jval.qr_residual_distributed(jS, jQs, jRs, jgeom, jmesh)
    geom = LUGeometry.create(N, N, v, grid)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        Q, R = qr_factor_distributed(shard, geom, mesh, **XLA)
        good = validation.qr_residual_distributed(shard, Q, R, geom, mesh)
        if mesh.rank == 0:
            Q[:4, :4] += 5.0
        bad = validation.qr_residual_distributed(shard, Q, R, geom, mesh)
        return good, bad

    res = run_threaded(grid, fn, timeout=TIMEOUT)
    (rec, orth), (brec, borth) = res[0]
    assert all(r[0] == res[0][0] for r in res)
    assert rec < 1e-13 and orth < 1e-13
    assert abs(rec - jres) < 1e-14 + 0.05 * jres and abs(orth - jorth) < 1e-14 + 0.05 * jorth
    assert brec > 1e-2 and borth > 1e-2


def test_least_squares_solves_match_the_jax_package():
    """lstsq_distributed (tall, x-sharded; TSQR and CholeskyQR2) and
    qr_lstsq_distributed (block-cyclic factors) with a vector b and a
    matrix B, float64."""
    rng = np.random.default_rng(7)
    Px, Ml, n = 4, 32, 12
    A = rng.standard_normal((Px * Ml, n))
    b = rng.standard_normal(Px * Ml)
    B = rng.standard_normal((Px * Ml, 3))
    jm = _jmesh((Px, 1, 1))
    jx = np.asarray(jsolvers.lstsq_distributed(A.reshape(Px, Ml, n), jm, b))
    jX = np.asarray(jsolvers.lstsq_distributed(A.reshape(Px, Ml, n), jm, B, algo="cholesky"))

    def tall(mesh):
        x = solvers.lstsq_distributed(A.reshape(Px, Ml, n), mesh, torch.from_numpy(b))
        X = solvers.lstsq_distributed(A.reshape(Px, Ml, n), mesh, torch.from_numpy(B),
                                      algo="cholesky")
        return x.numpy(), X.numpy()

    res = run_threaded(Grid3(Px, 1, 1), tall, timeout=TIMEOUT)
    _same_on_every_rank(res)
    x, X = res[0]
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(X, jX, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(x, np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-10)

    M, N, v, gridspec = 96, 48, 8, (2, 2, 1)
    G = rng.standard_normal((M, N))
    g = rng.standard_normal(M)
    Gm = rng.standard_normal((M, 2))
    jgeom = JLUGeometry.create(M, N, v, JGrid3(*gridspec))
    jmesh = _jmesh(gridspec)
    jQs, jRs = jqr.qr_factor_distributed(jnp.asarray(jgeom.scatter(G)), jgeom, jmesh)
    jy = np.asarray(jsolvers.qr_lstsq_distributed(jQs, jRs, jgeom, jmesh, g))
    jY = np.asarray(jsolvers.qr_lstsq_distributed(jQs, jRs, jgeom, jmesh, Gm))
    geom = LUGeometry.create(M, N, v, Grid3(*gridspec))
    S = geom.scatter(G)

    def full(mesh):
        Q, R = qr_factor_distributed(distribute_shards(S, mesh), geom, mesh, **XLA)
        y = solvers.qr_lstsq_distributed(Q, R, geom, mesh, torch.from_numpy(g))
        Y = solvers.qr_lstsq_distributed(Q, R, geom, mesh, torch.from_numpy(Gm))
        return y.numpy(), Y.numpy()

    res = run_threaded(Grid3(*gridspec), full, timeout=TIMEOUT)
    _same_on_every_rank(res)
    y, Y = res[0]
    np.testing.assert_allclose(y, jy, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(Y, jY, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(y, np.linalg.lstsq(G, g, rcond=None)[0], atol=1e-10)
    one = make_mesh(Grid3(1, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="rows"):
        solvers.lstsq_distributed(A.reshape(Px, Ml, n)[:1], one, b[:10])
    with pytest.raises(ValueError, match="rhs has"):
        solvers.qr_lstsq_distributed(None, None, geom, None, g[:10])


# --------------------------------------------------------------------------- #
# within the port
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 1)], ids=str)
def test_lookahead_is_bitwise_the_plain_loop(gridspec):
    """float32 on the kernel GEMM (its plain version): the lookahead loop
    computes the next panel's slab in the same GEMM as the plain loop and
    elects from the same finished Q columns, so every bit agrees."""
    N, v = 64, 8
    A = np.random.default_rng(41).standard_normal((N, N)).astype(np.float32)
    Qa, Ra, _ = _port_shards(A, gridspec, v, backend="kernel")
    Qb, Rb, _ = _port_shards(A, gridspec, v, backend="kernel", lookahead=True)
    np.testing.assert_array_equal(Qa, Qb)
    np.testing.assert_array_equal(Ra, Rb)


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (2, 2, 1), (2, 2, 2)], ids=str)
def test_factor_steps_resume(gridspec):
    """Three legs through the (shard, R) state: bitwise the uninterrupted
    run at Pz = 1, allclose at Pz > 1 (tests/test_resume.py's bars)."""
    v, Nt = 8, 8
    N = v * Nt
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, v, grid)
    A = validation.make_test_matrix(N, N, dtype=np.float32)
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        Qf, Rf = qr_factor_distributed(shard, geom, mesh)
        Qs, Rs = qr_factor_steps(shard, geom, mesh, 0, 3)
        # the R state round-trips as the full (Px, Py, Nlr, Nl) array too
        Qs, Rs = qr_factor_steps(Qs, geom, mesh, 3, 5, R=gather_shards(Rs, mesh).numpy())
        Qs, Rs = qr_factor_steps(Qs, geom, mesh, 5, geom.Nt, R=Rs)
        return Qf.numpy(), Rf.numpy(), Qs.numpy(), Rs.numpy()

    for Qf, Rf, Qs, Rs in run_threaded(grid, fn, timeout=TIMEOUT):
        if grid.Pz == 1:
            np.testing.assert_array_equal(Qs, Qf)
            np.testing.assert_array_equal(Rs, Rf)
        else:
            np.testing.assert_allclose(Qs, Qf, atol=1e-5)
            np.testing.assert_allclose(Rs, Rf, atol=1e-4)
    small = LUGeometry.create(32, 32, 8, Grid3(1, 1, 1))
    zeros = np.zeros((1, 1, 32, 32), np.float32)
    with pytest.raises(ValueError, match="outside"):
        qr_factor_steps(zeros, small, None, 2, 1)
    with pytest.raises(ValueError, match="R state"):
        qr_factor_steps(zeros, small, None, 2, 4)  # R=None at k0 > 0


def test_csegs_invariance_and_program_checks():
    """Segmentation partitions the same per-column math: any csegs gives
    the same factors to rounding (float64, 2.5D grid); csegs < 1 raises;
    the chunk default follows the compute dtype (float64 halves it)."""
    N, v, gridspec = 64, 8, (2, 2, 2)
    A = np.random.default_rng(3).standard_normal((N, N))
    base = _port_shards(A, gridspec, v, **XLA)
    for csegs in (1, 3):
        Q, R, _ = _port_shards(A, gridspec, v, csegs=csegs, **XLA)
        _close(Q, base[0], 1e-12)
        _close(R, base[1], 1e-12)
    geom = LUGeometry.create(256, 256, 64, Grid3(1, 1, 1))
    with pytest.raises(ValueError, match="csegs"):
        build_program(geom, csegs=0)
    with pytest.raises(ValueError, match="backend 'xla'"):
        build_program(geom, backend="kernel", dtype=torch.float64)
    with pytest.raises(ValueError, match="M >= N"):
        build_program(LUGeometry.create(64, 128, 8, Grid3(1, 1, 1)))
    for dt in (torch.float32, torch.float64):
        assert build_program(geom, dtype=dt, **XLA).chunk == \
            blas.batched_call_rows(64, blas.compute_dtype(dt))
    assert build_program(geom, dtype=torch.float64, **XLA).chunk == \
        build_program(geom, **XLA).chunk // 2


@pytest.mark.parametrize("gridspec,csegs", [((1, 1, 1), 8), ((2, 2, 1), 3), ((2, 1, 2), 8),
                                            ((1, 3, 1), 2)], ids=str)
def test_gemm_launch_prediction_counts_every_trailing_piece(gridspec, csegs, monkeypatch):
    """`gemm_launches` (what chip_smoke.py holds the card's K1 count to)
    equals the trailing-update GEMMs the kernel route makes, summed over
    the ranks, for a whole run and a resumed leg."""
    from conflux_tpu_torch.qr import distributed as tqr

    calls = []
    real = blas.gemm
    monkeypatch.setattr(blas, "gemm", lambda *a, **k: calls.append(k["backend"]) or real(*a, **k))
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(96, 96, 8, grid)
    S = geom.scatter(np.random.default_rng(1).standard_normal((96, 96)).astype(np.float32))

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        qr_factor_distributed(shard, geom, mesh, csegs=csegs)
        qr_factor_steps(shard, geom, mesh, 0, 5, csegs=csegs)

    run_threaded(grid, fn, timeout=TIMEOUT)
    assert set(calls) == {"kernel"}
    assert len(calls) == tqr.gemm_launches(geom, csegs) + tqr.gemm_launches(geom, csegs, 0, 5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_tsqr():
    """Two OS processes, gloo over env:// (the twin of
    tests/test_multihost.py's two-process TSQR): the (n, n) R all_gather
    crosses the process boundary; each rank checks its own block's
    reconstruction and the Gram matrix summed over x, with no global
    matrix anywhere."""
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"), "qr"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=120)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (out, rc) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"rank {rank}: qr rec=" in out
