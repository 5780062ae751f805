"""The port's miniapp CLI on the CPU (the `_result_` protocol of
tests/test_cli.py with `conflux_tpu_torch` as the implementation), and the
port's package boundary: no JAX and nothing of the JAX package."""

import ast
import os
import re

import pytest
import torch

from conflux_tpu_torch.cli import conflux_miniapp
from conflux_tpu_torch.validation import residual_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    ["-N", "16384", "-b", "128"],  # 128 steps: the distributed program's job
])
def test_miniapp_unported_routes_exit(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        conflux_miniapp.main(["--platform", "cpu", "-r", "0", *argv])


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
    yield os.path.join(REPO, "scripts", "torch_lu_profile.py")
    yield os.path.join(REPO, "scripts", "torch_ckpt_roundtrip.py")


def _forbidden(name: str) -> bool:
    # exact module names: conflux_tpu_torch itself starts with "conflux_tpu"
    return any(name == m or name.startswith(m + ".") for m in ("jax", "conflux_tpu"))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_port_files())
    rel = {os.path.relpath(p, REPO) for p in files}
    # the JAX-free modules the port keeps its own copies of, and the
    # checkpoint round trip's script, are walked like every other file
    assert {"conflux_tpu_torch/tier.py", "conflux_tpu_torch/control.py",
            "conflux_tpu_torch/io.py", "scripts/torch_ckpt_roundtrip.py"} <= rel
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
