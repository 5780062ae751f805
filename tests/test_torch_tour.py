"""`examples/torch_tour.py` on the CPU, in process: `main(device="cpu")`
runs all eight steps on threaded gloo worlds and checks the JAX tour's bars
itself (a missed bar raises). Against the JAX package on its 8-device CPU
mesh, on the tour's inputs:

- step 1's pivots (N=256, v=16, 2x2x2, `make_test_matrix` in float32)
  equal the reference's `lu_factor_distributed` perm;
- step 8's butterfly pivots (N=384, v=64, 3x2x1, seed 8) equal the
  reference's with `election="butterfly"`.

The JAX programs run at 2 x 2 trailing-update segments, not the tour's
default 16 x 16: the segments cut the same products into other pieces,
which leaves the pivots as they are, at a fraction of the compile time.
"""

import concurrent.futures
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu.lu.distributed import lu_factor_distributed as jlu_factor
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.validation import make_test_matrix

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module")
def tour():
    path = os.path.join(REPO, "examples", "torch_tour.py")
    spec = importlib.util.spec_from_file_location("torch_tour_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_perm(N: int, v: int, grid: tuple, seed: int, **kw) -> np.ndarray:
    g = JGrid3(*grid)
    geom = JLUGeometry.create(N, N, v, g)
    mesh = jmake_mesh(g, devices=jax.devices()[: g.P])
    A = make_test_matrix(N, N, seed=seed, dtype=np.float32)
    _out, perm = jlu_factor(jnp.asarray(geom.scatter(A)), geom, mesh, segs=(2, 2), **kw)
    return np.asarray(perm)


def test_tour_runs_on_the_cpu_with_the_reference_pivots(tour, capsys):
    # the JAX programs compile and run on a thread of their own meanwhile
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        want = ex.submit(lambda: (_jax_perm(256, 16, (2, 2, 2), 42),
                                  _jax_perm(384, 64, (3, 2, 1), 8, election="butterfly")))
        out = tour.main(device="cpu")
        want_perm, want_odd = want.result()
    text = capsys.readouterr().out
    assert text.rstrip().endswith("Tour complete.")
    assert text.count("\n== ") == 8
    np.testing.assert_array_equal(out["perm"], want_perm)
    np.testing.assert_array_equal(out["odd_perm"], want_odd)
    assert out["lu_residual"] < 1e-5 and out["odd_residual"] < 1e-5
    assert out["bf16_ir_residual"] < out["bf16_residual"] / 10
    assert out["gmres_residual"] < 5e-4


def test_tour_without_card_raises(tour, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tour.main()
