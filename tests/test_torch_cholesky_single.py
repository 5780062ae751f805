"""The port's single-device Cholesky path (`conflux_tpu_torch.cholesky.single`,
`solvers.cholesky_solve`, the Cholesky validation helpers and geometry, and
the `cholesky_miniapp` CLI) on the CPU, against the JAX package on the same
seeded inputs. On the CPU the trailing update runs K1's plain version."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import geometry as jgeom
from conflux_tpu import validation as jval
from conflux_tpu.cholesky.single import cholesky_blocked as jchol
from conflux_tpu.solvers import cholesky_solve as jcholesky_solve
from conflux_tpu_torch import geometry as tgeom
from conflux_tpu_torch import solvers as tsolvers
from conflux_tpu_torch import validation as tval
from conflux_tpu_torch.cholesky import cholesky_blocked
from conflux_tpu_torch.cli import cholesky_miniapp


def _rel_fro(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("N,v", [(256, 64), (192, 64), (128, 128)])
def test_cholesky_blocked_matches_jax(N, v):
    A = tval.make_spd_matrix(N, dtype=np.float32).numpy()
    L = cholesky_blocked(torch.from_numpy(A), v)
    Lj = np.asarray(jchol(jnp.asarray(A), v))
    assert L.dtype == torch.float32 and not np.triu(L.numpy(), 1).any()
    assert _rel_fro(L.numpy(), Lj) <= 1e-5
    res = tval.cholesky_residual(A.astype(np.float64), L.numpy())
    assert res <= tval.residual_bound(N, np.float32)


def test_cholesky_blocked_leaves_its_input_and_rejects_bad_shapes():
    A = tval.make_spd_matrix(128, dtype=np.float32)
    A0 = A.clone()
    cholesky_blocked(A, 64)
    assert torch.equal(A, A0)
    with pytest.raises(ValueError, match="multiple"):
        cholesky_blocked(A, 48)
    with pytest.raises(ValueError, match="square"):
        cholesky_blocked(A[:64], 64)


def test_cholesky_blocked_bfloat16_storage():
    """bf16 storage, f32 panel math: the JAX package's mixed-precision
    factor; both sit at bf16 accuracy."""
    A = tval.make_spd_matrix(256, dtype=np.float32).numpy()
    L = cholesky_blocked(torch.from_numpy(A).bfloat16(), 64)
    assert L.dtype == torch.bfloat16
    Lj = np.asarray(jchol(jnp.asarray(A).astype(jnp.bfloat16), 64).astype(jnp.float32))
    assert _rel_fro(L.float().numpy(), Lj) <= 2 ** -7
    assert tval.cholesky_residual(A.astype(np.float64), L.float().numpy()) <= 1e-2


@pytest.mark.parametrize("k", [None, 3])
def test_cholesky_solve_matches_jax(k):
    rng = np.random.default_rng(3)
    A = tval.make_spd_matrix(128, dtype=np.float32).numpy()
    L = cholesky_blocked(torch.from_numpy(A), 64)
    b = rng.standard_normal((128,) if k is None else (128, k)).astype(np.float32)
    x = tsolvers.cholesky_solve(L, torch.from_numpy(b)).numpy()
    xj = np.asarray(jcholesky_solve(jnp.asarray(L.numpy()), jnp.asarray(b)))
    assert x.shape == b.shape
    np.testing.assert_allclose(x, xj, rtol=1e-5, atol=1e-7)
    assert np.abs(A.astype(np.float64) @ x - b).max() < 1e-4
    with pytest.raises(ValueError, match="rows"):
        tsolvers.cholesky_solve(L, torch.from_numpy(b[:64]))


def test_make_spd_matrix_is_the_jax_packages_bit_for_bit():
    for dtype in (np.float32, np.float64):
        A = tval.make_spd_matrix(96, seed=3, dtype=dtype)
        assert isinstance(A, torch.Tensor) and A.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        np.testing.assert_array_equal(A.numpy(), jval.make_spd_matrix(96, seed=3, dtype=dtype))


def test_cholesky_residuals_host_and_device_agree_with_jax():
    A = tval.make_spd_matrix(160, dtype=np.float32).numpy()
    L = cholesky_blocked(torch.from_numpy(A), 32)
    L = L + torch.triu(torch.ones_like(L), 1)  # an upper triangle to ignore
    r_host = tval.cholesky_residual(A.astype(np.float64), L.numpy())
    r_jax = jval.cholesky_residual(A.astype(np.float64), L.numpy())
    assert r_host == pytest.approx(r_jax, rel=1e-12)
    # the device version forms L L^T in float64; the host oracle forms it in
    # L's dtype, so hold the device version to the host one on f64 factors
    r_host64 = tval.cholesky_residual(A.astype(np.float64), L.double().numpy())
    r_dev = tval.cholesky_residual_device(torch.from_numpy(A), L, strip=64)
    assert r_dev == pytest.approx(r_host64, rel=1e-9)
    assert r_host < tval.residual_bound(160, np.float32)


def test_cholesky_geometry_is_the_jax_packages():
    for N in (100, 256, 4096, 8192, 32768, 100000):
        for P in (1, 2, 4, 8, 16):
            assert tgeom.choose_cholesky_tile(N, P) == jgeom.choose_cholesky_tile(N, P)
    for P in (1, 2, 4, 6, 8, 12, 16):
        g, jg = tgeom.choose_cholesky_grid(P), jgeom.choose_cholesky_grid(P)
        assert (g.Px, g.Py, g.Pz) == (jg.Px, jg.Py, jg.Pz)
    for N, v, grid in ((4096, 256, (1, 1, 1)), (1000, 128, (2, 2, 1)), (777, 64, (4, 2, 2))):
        t = tgeom.CholeskyGeometry.create(N, v, tgeom.Grid3(*grid))
        j = jgeom.CholeskyGeometry.create(N, v, jgeom.Grid3(*grid))
        for f in ("N", "Nbase", "v", "Kappa"):
            assert getattr(t, f) == getattr(j, f), f


def test_miniapp_result_residual_and_refine_lines(capsys):
    rc = cholesky_miniapp.main(["--platform", "cpu", "--dim", "256", "--tile", "64",
                                "--run", "1", "--validate", "--refine", "2"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert "    PROBLEM PARAMETERS:" in out and "    Tile size: 64" in out
    lines = [l for l in out if l.startswith("_result_")]
    assert len(lines) == 1
    assert re.match(r"_result_ cholesky,conflux_tpu_torch,256,256,1,1x1x1,time,weak,"
                    r"([\d.]+),64,float32$", lines[0]), lines[0]
    res = [l for l in out if l.startswith("_residual_")]
    assert len(res) == 1 and float(res[0].split()[1]) < tval.residual_bound(256, np.float32)
    solve = [l for l in out if l.startswith("_solve_residual_")]
    assert len(solve) == 1 and "PASS" in solve[0], solve


def test_miniapp_default_tile_and_bfloat16(capsys):
    rc = cholesky_miniapp.main(["--platform", "cpu", "--dim", "512", "--run", "0",
                                "--dtype", "bfloat16", "--validate", "--refine", "3"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert f"    Tile size: {tgeom.choose_cholesky_tile(512, 1)}" in out
    res = [l for l in out if l.startswith("_residual_")]
    assert float(res[0].split()[1]) < 1e-2  # bf16 storage
    assert "PASS" in [l for l in out if l.startswith("_solve_residual_")][0]


def test_miniapp_float64_runs_the_library_product(capsys):
    """--dtype float64 runs the trailing update on the library product
    (backend "xla"), named on a `_route_` line; the factor is the JAX
    package's to rtol 1e-12."""
    rc = cholesky_miniapp.main(["--platform", "cpu", "--dim", "256", "--tile", "64",
                                "--run", "1", "--dtype", "float64", "--validate",
                                "--refine", "2"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert "_route_ backend=xla panel_algo=auto (float64)" in out
    assert re.match(r"_result_ cholesky,conflux_tpu_torch,256,256,1,1x1x1,time,weak,"
                    r"([\d.]+),64,float64$", [l for l in out if l.startswith("_result_")][0])
    res = [l for l in out if l.startswith("_residual_")]
    assert float(res[0].split()[1]) <= tval.residual_bound(256, np.float64)
    assert "PASS" in [l for l in out if l.startswith("_solve_residual_")][0]
    A = tval.make_spd_matrix(256)
    L = cholesky_blocked(A, 64, backend="xla")
    Lj = np.asarray(jchol(jnp.asarray(A.numpy()), 64))
    np.testing.assert_allclose(L.numpy(), Lj, rtol=1e-12, atol=1e-12)


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the grid routes' small problems,
    which run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("argv,name", [
    (["--grid", "2,2,1"], "grid"),
    (["--lookahead"], "--lookahead"),
    (["--segs", "8x8"], "--segs"),
    (["--auto"], "--auto"),
    (["--lookahead", "--auto"], "--lookahead"),
    (["--dim", "520", "--tile", "8"], "Kappa"),  # 65 tile columns: the distributed program's job
])
def test_miniapp_unported_routes_exit_naming_themselves(argv, name, capsys, one_thread):
    """The routes that exited before the distributed program was ported
    now run: a grid of several ranks and more than 64 tile columns on the
    distributed program (its `_grid_` line names the grid), the
    distributed knobs on the single route, where they do not apply (as in
    the JAX miniapp); --auto names the measurement it applied, none."""
    rc = cholesky_miniapp.main(["--platform", "cpu", "--run", "1", "--dim", "64", "--tile", "8",
                                "--dtype", "float64", *argv])
    assert rc == 0
    out = capsys.readouterr().out
    want = {"grid": "_grid_ 2x2x1", "Kappa": "_grid_ 1x1x1"}.get(name, "_result_ cholesky")
    assert want in out and ("_grid_" in out) == (name in ("grid", "Kappa")), out
    if "--auto" in argv:
        assert "_auto_provenance_ library defaults" in out


def test_miniapp_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cholesky_miniapp.main(["--dim", "256", "--tile", "64", "--run", "0"])
