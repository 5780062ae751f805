"""The port's factor entry points take the JAX package's positional
parameters in its order, `precision` at its position: read from both
sources with `ast`, a reference-order call on a 1x1x1 CPU mesh, and the
precisions the port refuses (ROADMAP item 16)."""

import ast
import os

import numpy as np
import pytest
import torch

from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
from conflux_tpu_torch.cholesky.single import cholesky_blocked
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import build_program as lu_program
from conflux_tpu_torch.lu.distributed import lu_factor_distributed
from conflux_tpu_torch.lu.single import lu_factor_blocked
from conflux_tpu_torch.parallel.mesh import make_mesh
from conflux_tpu_torch.qr.distributed import qr_factor_distributed
from conflux_tpu_torch.validation import make_spd_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# module (under both packages) -> the public functions whose positional
# parameters must start with the reference's
SHARED = {
    "lu/single.py": ("lu_factor_blocked",),
    "cholesky/single.py": ("cholesky_blocked",),
    "lu/distributed.py": ("lu_factor_distributed", "lu_factor_steps",
                          "lu_distributed_host", "build_program"),
    "cholesky/distributed.py": ("cholesky_factor_distributed", "cholesky_factor_steps",
                                "cholesky_distributed_host", "build_program"),
    "qr/distributed.py": ("qr_factor_distributed", "qr_factor_steps",
                          "qr_blocked_distributed_host", "build_program"),
}
CASES = [(mod, fn) for mod, fns in SHARED.items() for fn in fns]


def _positional(package: str, module: str, name: str) -> list:
    with open(os.path.join(REPO, package, module)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return [a.arg for a in node.args.posonlyargs + node.args.args]
    raise AssertionError(f"{package}/{module} defines no {name}")


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}:{n}" for m, n in CASES])
def test_positional_parameters_start_with_the_reference(module, name):
    ref = _positional("conflux_tpu", module, name)
    port = _positional("conflux_tpu_torch", module, name)
    assert "precision" in ref
    assert port[:len(ref)] == ref


def test_reference_order_call_leaves_the_shard_and_matches_keywords():
    """`cholesky_factor_distributed(shard, geom, mesh, None, "xla")` is
    precision=None, backend="xla": the caller's shard stays untouched (no
    donation) and the factor is bitwise the keyword call's."""
    N, v = 256, 64
    geom = CholeskyGeometry.create(N, v, Grid3(1, 1, 1))
    mesh = make_mesh(Grid3(1, 1, 1), device="cpu")
    shard = torch.from_numpy(geom.scatter(make_spd_matrix(N, dtype=np.float64).numpy())[0, 0])
    before = shard.clone()
    out = cholesky_factor_distributed(shard, geom, mesh, None, "xla")
    assert torch.equal(shard, before)
    ref = cholesky_factor_distributed(shard, geom, mesh, backend="xla")
    assert torch.equal(out, ref)


def _refusals():
    A = torch.eye(64)
    lu_geom = LUGeometry.create(64, 64, 16, Grid3(1, 1, 1))
    chol_geom = CholeskyGeometry.create(64, 16, Grid3(1, 1, 1))
    mesh = make_mesh(Grid3(1, 1, 1), device="cpu")
    return {
        "lu_factor_blocked": lambda p: lu_factor_blocked(A, 16, p, "xla", panel_algo="auto"),
        "cholesky_blocked": lambda p: cholesky_blocked(A, 16, p, "xla"),
        "lu_factor_distributed": lambda p: lu_factor_distributed(
            A.clone(), lu_geom, mesh, p, "xla", panel_algo="auto"),
        "cholesky_factor_distributed": lambda p: cholesky_factor_distributed(
            A.clone(), chol_geom, mesh, p, "xla"),
        "qr_factor_distributed": lambda p: qr_factor_distributed(A.clone(), lu_geom, mesh, p,
                                                                 "xla"),
        "build_program": lambda p: lu_program(lu_geom, mesh, p, "xla", panel_algo="auto"),
    }


@pytest.mark.parametrize("name", ["lu_factor_blocked", "cholesky_blocked",
                                  "lu_factor_distributed", "cholesky_factor_distributed",
                                  "qr_factor_distributed", "build_program"])
def test_precision_highest_runs_and_others_raise(name):
    call = _refusals()[name]
    for ok in (None, "highest", "HIGHEST"):
        call(ok)
    with pytest.raises(NotImplementedError, match="item 16"):
        call("default")
