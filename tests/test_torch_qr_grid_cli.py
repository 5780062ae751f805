"""The QR miniapp's grid routes on the CPU (threaded gloo worlds): the tall
mode over x (TSQR with both trees, CholeskyQR2, zero-padded rows) and
`--full` through `qr.distributed.qr_factor_distributed` at 1x1x1 and on
grids of several ranks, with `--lookahead`, `--csegs` and `--auto` (the
twins of tests/test_cli.py's QR cases)."""

import re

import numpy as np
import pytest
import torch

from conflux_tpu_torch.cli import qr_miniapp
from conflux_tpu_torch.validation import residual_bound

CPU = ["--platform", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(capsys, argv):
    assert qr_miniapp.main([*CPU, *argv]) == 0
    return capsys.readouterr().out.splitlines()


def _residuals(out):
    (line,) = [l for l in out if l.startswith("_residual_ ")]
    return float(line.split("orth=")[1].split()[0]), float(line.split("reconstruction=")[1])


def test_tall_and_full_float64(capsys):
    """tests/test_cli.py's tall 4x1x1 and --full 2x2x1 float64 runs."""
    out = _run(capsys, ["-M", "128", "--cols", "16", "-r", "2", "--p_grid", "4,1,1",
                        "--validate", "--dtype", "float64"])
    res = [l for l in out if l.startswith("_result_")]
    assert len(res) == 2 and re.match(
        r"_result_ qr-tsqr,conflux_tpu_torch,128,64,4,4x1x1,time,weak,[\d.]+,16,float64$",
        res[0]), res
    assert "_grid_ 4x1x1 ranks=4 world=threads transport=gloo device=cpu" in out
    assert _residuals(out)[0] < 1e-12
    out = _run(capsys, ["-M", "64", "--cols", "64", "--full", "-b", "16", "--p_grid", "2,2,1",
                        "-r", "1", "--validate", "--dtype", "float64"])
    assert any(l.startswith("_result_ qr,conflux_tpu_torch,64,") for l in out), out
    assert _residuals(out)[1] < 1e-12


@pytest.mark.parametrize("argv,algo,n_field,ranks,grid,tile", [
    (["-M", "512", "--cols", "16", "--p_grid", "4,1,1", "--tree", "butterfly"],
     "qr-tsqr", 512, 4, "4x1x1", 16),
    (["-M", "130", "--cols", "16", "--p_grid", "3,1,1", "--tree", "butterfly"],
     "qr-tsqr", 132, 3, "3x1x1", 16),  # rows padded 130 -> 132
    (["-M", "256", "--cols", "32", "--p_grid", "2,1,1", "--algo", "cholesky"],
     "qr-cholesky", 256, 2, "2x1x1", 32),
    (["-M", "64", "--cols", "64", "--full", "-b", "8", "--p_grid", "2,2,1"],
     "qr", 64, 4, "2x2x1", 8),
    (["-M", "64", "--cols", "64", "--full", "-b", "8", "--p_grid", "4,1,1", "--lookahead",
      "--csegs", "3"], "qr", 64, 4, "4x1x1", 8),
    (["-M", "64", "--cols", "64", "--full", "-b", "8", "--p_grid", "2,1,2"],
     "qr", 64, 4, "2x1x2", 8),
    (["-M", "128", "--cols", "128", "--full", "-b", "16"], "qr", 128, 1, "1x1x1", 16),
    (["-M", "64", "--cols", "64", "--full", "-b", "8", "--p_grid", "2,2,1", "--dtype",
      "bfloat16"], "qr", 64, 4, "2x2x1", 8),
], ids=lambda a: "-".join(a) if isinstance(a, list) else None)
def test_grid_routes_float32(capsys, argv, algo, n_field, ranks, grid, tile):
    out = _run(capsys, ["-r", "1", "--validate", *argv])
    world = "threads transport=gloo" if ranks > 1 else "single transport=none"
    assert f"_grid_ {grid} ranks={ranks} world={world} device=cpu" in out, out
    (res,) = [l for l in out if l.startswith("_result_")]
    f = res.split()[1].split(",")
    assert f[0] == algo and f[1] == "conflux_tpu_torch" and int(f[2]) == n_field
    assert int(f[4]) == ranks and f[5] == grid and int(f[9]) == tile
    bf16 = "bfloat16" in argv
    n = n_field if "--full" in argv else tile
    bound = 0.5 * 2.0 ** -7 * np.sqrt(n) if bf16 else residual_bound(n, np.float32)
    orth, rec = _residuals(out)
    assert orth <= bound and rec <= bound, (orth, rec, bound)


def test_auto_applies_each_modes_knobs(capsys):
    """--auto over the port's dispatch table (card rules empty): the --full
    loop's knobs and the tall tsqr mode's tree; the tall CholeskyQR2 mode
    has none and says so (tests/test_cli.py's empty-mode case)."""
    out = _run(capsys, ["-M", "64", "--cols", "64", "--full", "-b", "8", "--p_grid", "2,1,1",
                        "-r", "1", "--auto"])
    (auto,) = [l for l in out if l.startswith("_auto_ ")]
    assert auto == "_auto_ csegs=8 lookahead=off", auto
    assert any(l.startswith("_auto_provenance_ ") for l in out)
    out = _run(capsys, ["-M", "128", "--cols", "16", "-r", "1", "--auto"])
    assert "_auto_ tree=gather" in out
    out = _run(capsys, ["-M", "256", "--cols", "64", "--algo", "cholesky", "-r", "1", "--auto"])
    assert "_auto_ (no auto-tunable knobs for this mode)" in out
    assert not any("(all knobs pinned)" in l or l.startswith("_auto_provenance_") for l in out)


@pytest.mark.parametrize("argv,msg", [
    (["--p_grid", "2,2,1"], "tall mode"),
    (["--full", "--tree", "butterfly"], "--tree"),
    (["--algo", "cholesky", "--tree", "butterfly"], "--tree"),
    (["--full", "-M", "16", "--cols", "16", "-b", "8", "--p_grid", "1,4,1"], "M >= N"),
])
def test_routes_refuse_what_they_cannot_run(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        qr_miniapp.main([*CPU, "-r", "0", *argv])
    with pytest.raises(SystemExit):  # a non-positive csegs fails at parse
        qr_miniapp.main([*CPU, "--full", "--csegs", "0"])
