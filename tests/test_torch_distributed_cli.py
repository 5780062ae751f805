"""The miniapps' grid routes on the CPU (threaded gloo worlds): `--p_grid`
/ `--grid` of several ranks, more than 64 supersteps on 1x1x1 (the JAX
miniapps' own switch to the distributed program), the distributed knobs,
`--auto` over the empty dispatch table, and the Cholesky helper's
generate / factor / compare round trip."""

import re

import numpy as np
import pytest
import torch

from conflux_tpu_torch.cli import cholesky_helper, cholesky_miniapp, conflux_miniapp
from conflux_tpu_torch.validation import residual_bound

CPU = ["--platform", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: these small problems gain nothing from
    more, and the suite runs beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("argv,grid,ranks,N,v", [
    (["--p_grid", "2,2,1", "-N", "64", "-b", "8", "--election", "butterfly", "--lookahead",
      "--segs", "3x2", "--tree", "flat", "--update", "block"], "2x2x1", 4, 64, 8),
    (["--p_grid", "2,1,2", "-N", "64", "-b", "8", "--refine", "2"], "2x1x2", 4, 64, 8),
    # 65 supersteps on one rank: the distributed program, as the JAX miniapp
    (["-N", "520", "-b", "8"], "1x1x1", 1, 520, 8),
])
def test_lu_miniapp_grid_routes(capsys, argv, grid, ranks, N, v):
    rc = conflux_miniapp.main([*CPU, "--dtype", "float64", "-r", "1", "--validate", *argv])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert "_route_ backend=xla panel_algo=auto (float64)" in out
    g = [line for line in out if line.startswith("_grid_")]
    assert g == [f"_grid_ {grid} ranks={ranks} world={'threads' if ranks > 1 else 'single'} "
                 f"transport={'gloo' if ranks > 1 else 'none'} device=cpu"], g
    res = [line for line in out if line.startswith("_result_")]
    assert len(res) == 1 and re.match(
        rf"_result_ lu,conflux_tpu_torch,{N},\d+,{ranks},{grid},time,weak,[\d.]+,{v},float64$",
        res[0]), res
    r = [line for line in out if line.startswith("_residual_")]
    assert len(r) == 1 and float(r[0].split()[1]) < residual_bound(N, np.float64)
    if "--refine" in argv:
        s = [line for line in out if line.startswith("_solve_residual_")]
        assert len(s) == 1 and "PASS" in s[0], s


def test_lu_miniapp_kernel_route_on_a_grid_with_auto(capsys):
    """float32 on the grid runs the kernel routes (their plain versions
    here); --auto over the empty table applies the library defaults and
    says that nothing was measured."""
    rc = conflux_miniapp.main([*CPU, "-N", "256", "-b", "128", "--p_grid", "2,1,1", "-r", "1",
                               "--validate", "--auto"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert "_auto_ election=gather segs=16x16 tree=pairwise update=segments lookahead=off" \
        in out
    assert any(line.startswith("_auto_provenance_ library defaults") for line in out)
    assert "_route_ backend=kernel panel_algo=kernel (float32)" in out
    r = [line for line in out if line.startswith("_residual_")]
    assert float(r[0].split()[1]) < residual_bound(256, torch.float32)


@pytest.mark.parametrize("argv,grid,ranks,N,v", [
    (["--grid", "2,2,1", "--dim", "64", "--tile", "8", "--lookahead", "--segs", "3x2",
      "--refine", "2"], "2x2x1", 4, 64, 8),
    (["--dim", "520", "--tile", "8", "--auto"], "1x1x1", 1, 520, 8),  # Kappa = 65
])
def test_cholesky_miniapp_grid_routes(capsys, argv, grid, ranks, N, v):
    rc = cholesky_miniapp.main([*CPU, "--dtype", "float64", "--run", "1", "--validate", *argv])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert f"    Grid: {grid} on {ranks} devices" in out
    res = [line for line in out if line.startswith("_result_")]
    assert len(res) == 1 and re.match(
        rf"_result_ cholesky,conflux_tpu_torch,{N},\d+,{ranks},{grid},time,weak,[\d.]+,{v},"
        r"float64$", res[0]), res
    r = [line for line in out if line.startswith("_residual_")]
    assert len(r) == 1 and float(r[0].split()[1]) < residual_bound(N, np.float64)
    if "--refine" in argv:
        s = [line for line in out if line.startswith("_solve_residual_")]
        assert len(s) == 1 and "PASS" in s[0], s
    if "--auto" in argv:
        assert "_auto_ segs=8x8 lookahead=off" in out


def test_cholesky_helper_round_trip_on_a_grid(tmp_path, capsys):
    inp, ref, mine = (str(tmp_path / n) for n in ("in.bin", "ref.bin", "mine.bin"))
    assert cholesky_helper.main(["generate", "--dim", "96", "--out", inp, "--result", ref,
                                 "--dtype", "float64"]) == 0
    assert cholesky_helper.main(["factor", inp, mine, "--tile", "16", "--grid", "2,2,1",
                                 *CPU, "--dtype", "float64"]) == 0
    assert cholesky_helper.main(["compare", mine, ref, "--lower", "--tol", "1e-12"]) == 0
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("_compare_")]
    assert len(line) == 1 and float(line[0].split(",")[-1]) < 1e-12
    stream = str(tmp_path / "s.bin")
    assert cholesky_helper.main(["generate", "--dim", "64", "--stream", "--tile", "16",
                                 "--out", stream]) == 0
    assert cholesky_helper.main(["factor", stream, mine, "--tile", "16", *CPU,
                                 "--dtype", "float64"]) == 0
    assert cholesky_helper.main(["compare", mine, stream, "--tol", "1e-30"]) == 1
