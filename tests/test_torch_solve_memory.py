"""What the port's grid solve holds beside the factor, and
`scripts/torch_solve_memory.py` on the CPU.

- `solvers._lu_solver`, which refinement sweeps and GMRES-IR solve
  through, allocates no more than the (v, v) diagonal blocks and its index
  vectors when it is made (n v^2 + 8 (Nl + N) elements: the columns'
  global indices take a few temporaries of Nl), on grids with one and with
  several rows of ranks: no row tile of the factor is taken (all n of them
  are n v Nl elements, Px times the shard); its solves match
  `lu_solve_distributed` bitwise;
- the script prints one JSON line per (N, grid) with a solved system, no
  peak on the CPU, and raises without a card unless given `--platform cpu`.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from conflux_tpu_torch import solvers
from conflux_tpu_torch.geometry import Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import lu_factor_distributed
from conflux_tpu_torch.parallel.mesh import run_threaded

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
XLA = dict(backend="xla", panel_algo="auto")
N, V = 64, 8


class _Allocations(TorchDispatchMode):
    """Elements of every op output that holds storage of its own (a view
    or an in-place result of an input is not counted)."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        self.numel += sum(t.numel() for t in pytree.tree_leaves(out)
                          if isinstance(t, torch.Tensor)
                          and t.untyped_storage().data_ptr() not in ins)
        return out


@pytest.mark.parametrize("gridspec", [(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1)])
def test_grid_solver_keeps_no_row_tiles(gridspec):
    rng = np.random.default_rng(4)
    A = (rng.standard_normal((N, N)) + 3 * np.eye(N)).astype(np.float32)
    b = rng.standard_normal((N, 2)).astype(np.float32)
    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, V, grid)

    def fn(mesh):
        shard = solvers._scatter_local(torch.from_numpy(A), geom, mesh, torch.float32)
        out, perm = lu_factor_distributed(shard, geom, mesh, segs=(2, 2), **XLA)
        with _Allocations() as made:
            solve = solvers._lu_solver(out, perm, geom, mesh)
        x = solve(torch.from_numpy(b))
        return made.numel, x, solvers.lu_solve_distributed(out, perm, geom, mesh,
                                                           torch.from_numpy(b))

    for numel, x, want in run_threaded(grid, fn, timeout=120.0):
        assert numel <= geom.n_steps * V * V + 8 * (geom.Nl + N), (gridspec, numel)
        assert torch.equal(x, want)
    assert np.linalg.norm(A @ x.numpy() - b) <= 1e-4 * np.linalg.norm(b)


@pytest.fixture(scope="module")
def script():
    path = os.path.join(REPO, "scripts", "torch_solve_memory.py")
    spec = importlib.util.spec_from_file_location("torch_solve_memory_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_script_prints_a_line_per_run(script, capsys):
    assert script.main(["--dim", "256", "--tile", "128", "--refine", "2",
                        "--grid", "1", "1", "1", "--grid", "2", "1", "1",
                        "--platform", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["grid"] for r in rows] == [[1, 1, 1], [2, 1, 1]]
    for r in rows:
        assert (r["N"], r["v"], r["refine"]) == (256, 128, 2)
        assert r["peak_over_inputs_bytes"] is None and r["factor_bytes"] == 256 * 256 * 4
        assert r["rel_residual"] <= 1e-10 and r["seconds"] > 0


def test_script_without_card_raises(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        script.main(["--dim", "256"])
