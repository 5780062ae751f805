"""`scripts/torch_accuracy_demo.py` on the CPU against the JAX package's
`solvers.solve_distributed`, the solve `scripts/accuracy_demo.py` refines
incrementally: N=256, v=64, float32 A = randn + 2 I from a numpy seed,
b = 1, float64 residuals (x64 is on in the tests, as the reference script
turns it on), the JAX package's library route on both sides (backend
"xla", panel algo "auto": v=64 is below K2's width).

- the perm of the port's factorization equals the JAX program's exactly;
- x at depth 0 within 1e-4 of the reference's (relative, in norm: two
  float32 factorizations of a matrix of condition ~1e3);
- the relative residual <= 1e-6 at depths 2 and 4, the port's and the
  reference's;
- A is intact after the donated factorization;
- the CLI prints the reference's `_accuracy_` lines, and raises without a
  card unless given `--platform cpu`.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch_registry_guard import registry_guard  # noqa: F401

import jax.numpy as jnp

from conflux_tpu import solvers as jsolvers
from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu.lu.distributed import lu_factor_distributed as jlu_factor
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.parallel.mesh import mesh_cache_key
from conflux_tpu_torch.ops import blas

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
N, V = 256, 64


@pytest.fixture(scope="module")
def demo():
    path = os.path.join(REPO, "scripts", "torch_accuracy_demo.py")
    spec = importlib.util.spec_from_file_location("torch_accuracy_demo_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _library_route():
    prev = blas.get_backend(), blas.get_panel_algo()
    blas.set_backend("xla")
    blas.set_panel_algo("auto")
    try:
        yield
    finally:
        blas.set_backend(prev[0])
        blas.set_panel_algo(prev[1])


def _system():
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((N, N)) + 2 * np.eye(N)).astype(np.float32)
    return A, np.ones(N, np.float32)


def _rel(A, x, b) -> float:
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(b64 - A64 @ np.asarray(x, np.float64)) / np.linalg.norm(b64))


def test_sweeps_match_the_reference(demo):
    A, b = _system()
    At = torch.from_numpy(A.copy())
    with _library_route():
        got = demo.accuracy_sweeps(At, torch.from_numpy(b), V, [4, 0, 2], torch.float32,
                                   "cpu")
    assert torch.equal(At, torch.from_numpy(A))  # the donated factor worked on a copy
    assert sorted(got["rel"]) == [0, 2, 4]

    grid = JGrid3(1, 1, 1)
    mesh = jmake_mesh(grid)
    want = {k: np.asarray(jsolvers.solve_distributed(jnp.asarray(A), jnp.asarray(b),
                                                     grid=grid, v=V, mesh=mesh, refine=k))
            for k in (0, 2, 4)}
    # the perm of the factorization solve_distributed runs, from the same
    # call (its scatter, its program)
    geom = JLUGeometry.create(N, N, V, grid)
    shards = jsolvers._build_scatter(geom, mesh_cache_key(mesh), "float32")(jnp.asarray(A))
    _out, jperm = jlu_factor(shards, geom, mesh, donate=True)
    np.testing.assert_array_equal(got["perm"].numpy(), np.asarray(jperm))

    x0 = got["x"][0].numpy()
    assert np.linalg.norm(x0 - want[0]) <= 1e-4 * np.linalg.norm(want[0])
    for k in (0, 2, 4):
        assert got["x"][k].dtype == torch.float64
        assert got["rel"][k] == pytest.approx(_rel(A, got["x"][k].numpy(), b), rel=1e-6)
    for k in (2, 4):
        assert got["rel"][k] <= 1e-6, (k, got["rel"])
        assert _rel(A, want[k], b) <= 1e-6, k
    assert got["rel"][0] > got["rel"][2]  # the sweeps did the work


def test_cli_prints_the_reference_lines(demo, capsys):
    assert demo.main(["--dim", "128", "--tile", "128", "--refine", "0", "4",
                      "--platform", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("_accuracy_")]
    assert [l.split()[4] for l in lines] == ["refine=0", "refine=4"]
    assert lines[1].startswith("_accuracy_ N=128 v=128 factors=float32 refine=4 ")
    assert "[PASS <=1e-6]" in lines[1]
    assert demo.main(["--dim", "128", "--tile", "128", "--refine", "2",
                      "--factor_dtype", "bfloat16", "--platform", "cpu"]) == 0
    assert "factors=bfloat16 refine=2" in capsys.readouterr().out


def test_cli_without_card_raises(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        demo.main(["--dim", "256", "--tile", "128"])
