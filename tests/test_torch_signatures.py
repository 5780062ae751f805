"""The port's entry points that take `precision=` take the JAX package's
positional parameters in its order, `precision` at its position, and its
keyword-only parameters: read from both sources with `ast`; a
reference-order call on a 1x1x1 CPU mesh; and each factor entry point at
every precision name held against the JAX function (a name neither
package knows raises in both)."""

import ast
import os

import numpy as np
import pytest
import torch
from jax import lax

from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
from conflux_tpu_torch.cholesky.single import cholesky_blocked
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import build_program as lu_program
from conflux_tpu_torch.lu.distributed import lu_factor_distributed
from conflux_tpu_torch.lu.single import lu_factor_blocked
from conflux_tpu_torch.ops import blas as tblas
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
    "ops/blas.py": ("gemm", "blocked_trsm"),
    "ops/batched_trsm.py": ("blocked_solve", "blocked_solve_probe", "blocked_trsm"),
    "batched.py": ("lu_factor_batched", "cholesky_factor_batched", "solve_batched",
                   "solve_updated_batched"),
    "solvers.py": ("solve_distributed",),
}
CASES = [(mod, fn) for mod, fns in SHARED.items() for fn in fns]


def _parameters(package: str, module: str, name: str) -> tuple[list, list]:
    """(positional, keyword-only) parameter names of a module's function."""
    with open(os.path.join(REPO, package, module)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ([a.arg for a in node.args.posonlyargs + node.args.args],
                    [a.arg for a in node.args.kwonlyargs])
    raise AssertionError(f"{package}/{module} defines no {name}")


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}:{n}" for m, n in CASES])
def test_positional_parameters_start_with_the_reference(module, name):
    ref, ref_kw = _parameters("conflux_tpu", module, name)
    port, port_kw = _parameters("conflux_tpu_torch", module, name)
    assert "precision" in ref + ref_kw
    assert port[:len(ref)] == ref
    # a keyword-only parameter of the reference is one of the port's too
    # (keyword-only in both where the reference has `precision` so)
    assert set(ref_kw) <= set(port + port_kw)
    if "precision" in ref_kw:
        assert "precision" in port_kw


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


# every precision name of the JAX package's `lax.Precision`, the enum names
# in capitals (which the port reads case-blind) and the port's own enum
PRECISIONS = (None, "highest", "HIGHEST", "float32", "high", "bfloat16_3x", "tensorfloat32",
              "default", "fastest", "bfloat16", "DEFAULT", tblas.Precision.HIGH)


def _entry_points():
    A = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 64))) + 8 * torch.eye(
        64, dtype=torch.float64)
    S = A @ A.T
    lu_geom = LUGeometry.create(64, 64, 16, Grid3(1, 1, 1))
    chol_geom = CholeskyGeometry.create(64, 16, Grid3(1, 1, 1))
    mesh = make_mesh(Grid3(1, 1, 1), device="cpu")
    return {
        "lu_factor_blocked": lambda p: lu_factor_blocked(A, 16, p, "xla", panel_algo="auto"),
        "cholesky_blocked": lambda p: cholesky_blocked(S, 16, p, "xla"),
        "lu_factor_distributed": lambda p: lu_factor_distributed(
            torch.from_numpy(lu_geom.scatter(A.numpy())[0, 0]), lu_geom, mesh, p, "xla",
            panel_algo="auto"),
        "cholesky_factor_distributed": lambda p: cholesky_factor_distributed(
            torch.from_numpy(chol_geom.scatter(S.numpy())[0, 0]), chol_geom, mesh, p, "xla"),
        "qr_factor_distributed": lambda p: qr_factor_distributed(
            torch.from_numpy(lu_geom.scatter(A.numpy())[0, 0]), lu_geom, mesh, p, "xla"),
        "build_program": lambda p: lu_program(lu_geom, mesh, p, "xla", panel_algo="auto")(
            torch.from_numpy(lu_geom.scatter(A.numpy())[0, 0]), mesh),
    }


def _tensors(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", ["lu_factor_blocked", "cholesky_blocked",
                                  "lu_factor_distributed", "cholesky_factor_distributed",
                                  "qr_factor_distributed", "build_program"])
def test_precision_highest_runs_and_others_raise(name):
    """Every precision name the JAX package takes runs, at the reference's
    position, and names the level `lax.Precision` names; on the CPU every
    level computes in IEEE float64 here, so each call is bitwise the
    HIGHEST one. A name neither package knows raises ValueError in both."""
    call = _entry_points()[name]
    want = _tensors(call(None))
    for p in PRECISIONS[1:]:
        got = _tensors(call(p))
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)), p
        if isinstance(p, str) and p.islower():
            assert tblas.resolve_precision(p).name == lax.Precision(p).name
    with pytest.raises(ValueError, match="matmul precision"):
        call("nope")
    with pytest.raises(ValueError):
        lax.Precision("nope")
