"""The port's miniapp CLI on the CPU (the `_result_` protocol of
tests/test_cli.py with `conflux_tpu_torch` as the implementation), and the
port's package boundary: no JAX and nothing of the JAX package."""

import ast
import glob
import os
import re

import pytest
import torch

from conflux_tpu_torch.cli import conflux_miniapp
from conflux_tpu_torch.validation import residual_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the grid routes' small problems,
    which run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_miniapp_result_line_validate_refine(capsys):
    rc = conflux_miniapp.main(["--platform", "cpu", "-N", "256", "-b", "128",
                               "-r", "1", "--validate", "--refine", "2"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    lines = [l for l in out if l.startswith("_result_")]
    assert len(lines) == 1
    assert re.match(r"_result_ lu,conflux_tpu_torch,256,256,1,1x1x1,time,weak,"
                    r"([\d.]+),128,float32$", lines[0]), lines[0]
    res = [l for l in out if l.startswith("_residual_")]
    assert len(res) == 1
    assert float(res[0].split()[1]) < residual_bound(256, torch.float32)
    solve = [l for l in out if l.startswith("_solve_residual_")]
    assert len(solve) == 1 and "PASS" in solve[0], solve


@pytest.mark.parametrize("argv", [
    ["--p_grid", "2,2,1"],
    ["--lookahead"],
    ["--tree", "flat"],
    ["--update", "x"],
    ["-N", "520", "-b", "8"],  # 65 steps: the distributed program's job
])
def test_miniapp_unported_routes_exit(argv, capsys, one_thread):
    """The routes that exited before the distributed program was ported
    now run: a grid of several ranks and more than 64 supersteps on the
    distributed program (its `_grid_` line), the distributed knobs on the
    single route, where they do not apply (as in the JAX miniapp); only a
    value outside a flag's choices still exits (argparse)."""
    base = ["--platform", "cpu", "-r", "0", "-N", "64", "-b", "8", "--dtype", "float64"]
    if "x" in argv:
        with pytest.raises(SystemExit) as e:
            conflux_miniapp.main([*base, *argv])
        assert e.value.code == 2
        return
    assert conflux_miniapp.main([*base, *argv]) == 0
    out = capsys.readouterr().out
    grid = "2,2,1" in argv or "520" in argv
    want = "_grid_ 2x2x1" if "2,2,1" in argv else "_grid_ 1x1x1" if grid else "_route_ "
    assert want in out and ("_grid_" in out) == grid, out


def test_miniapp_float64_runs_the_library_route(capsys):
    """--dtype float64 runs the JAX miniapp's own route (backend "xla",
    panel algo "auto"), named on a `_route_` line before the result line;
    its factors are the JAX route's (equal pivots, rtol 1e-12)."""
    import jax.numpy as jnp
    import numpy as np

    from conflux_tpu.lu.single import lu_factor_blocked as jlu
    from conflux_tpu.validation import make_test_matrix
    from conflux_tpu_torch.lu.single import lu_factor_blocked

    rc = conflux_miniapp.main(["--platform", "cpu", "-N", "256", "-b", "64", "-r", "1",
                               "--dtype", "float64", "--validate", "--refine", "2"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    route = [i for i, l in enumerate(out) if l.startswith("_route_")]
    result = [i for i, l in enumerate(out) if l.startswith("_result_")]
    assert len(route) == 1 and route[0] < result[0]
    assert out[route[0]] == "_route_ backend=xla panel_algo=auto (float64)"
    assert re.match(r"_result_ lu,conflux_tpu_torch,256,256,1,1x1x1,time,weak,"
                    r"([\d.]+),64,float64$", out[result[0]]), out[result[0]]
    res = [l for l in out if l.startswith("_residual_")]
    assert float(res[0].split()[1]) < residual_bound(256, torch.float64)
    assert "PASS" in [l for l in out if l.startswith("_solve_residual_")][0]
    A = make_test_matrix(256, 256)
    LU, perm = lu_factor_blocked(torch.from_numpy(A), 64, backend="xla", panel_algo="auto")
    LUj, permj = jlu(jnp.asarray(A), 64)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(permj))
    np.testing.assert_allclose(LU.numpy(), np.asarray(LUj), rtol=1e-12, atol=1e-12)


def test_miniapp_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        conflux_miniapp.main(["-N", "256", "-b", "128", "-r", "0"])


def _port_files():
    root = os.path.join(REPO, "conflux_tpu_torch")
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for pattern in ("scripts/torch_*.py", "examples/torch_*.py"):
        yield from sorted(glob.glob(os.path.join(REPO, pattern)))


def _forbidden(name: str) -> bool:
    # exact module names: conflux_tpu_torch itself starts with "conflux_tpu"
    return any(name == m or name.startswith(m + ".") for m in ("jax", "conflux_tpu"))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_port_files())
    rel = {os.path.relpath(p, REPO) for p in files}
    # the JAX-free modules the port keeps its own copies of (conflint's
    # among them), and every scripts/torch_*.py and examples/torch_*.py,
    # are walked like every other file
    assert {"conflux_tpu_torch/tier.py", "conflux_tpu_torch/control.py",
            "conflux_tpu_torch/io.py", "conflux_tpu_torch/analysis/core.py",
            "conflux_tpu_torch/analysis/rules.py", "conflux_tpu_torch/analysis/lockcheck.py",
            "scripts/torch_ckpt_roundtrip.py", "scripts/torch_soak.py",
            "scripts/torch_tune.py", "scripts/torch_fabric_drill.py",
            "scripts/torch_accuracy_demo.py", "scripts/torch_replay.py",
            "examples/torch_tour.py"} <= rel
    assert sum(p.startswith("scripts/torch_") for p in rel) >= 14
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []
