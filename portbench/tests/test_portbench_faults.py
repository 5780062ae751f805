"""A run with the timed path broken underneath must come out not
correct: one test per fault these cells can have, and the control (the
reference one precision below, in the program's place). One card, so no
exchange between chips to leave out. The card's own control, the
program's TF32 path at precision 'high', runs where there is a card."""

import time

import pytest
import torch

from conflux_tpu_torch import solvers
from conflux_tpu_torch.cholesky import distributed as chol_dist
from conflux_tpu_torch.lu import distributed as lu_dist
from portbench import harness


def run(cell, device="cpu", N=256, v=128, entry=None, **kw):
    over = {"N": N, "v": v, **({"entry": entry} if entry else {})}
    return harness.run_cell(cell, 2**33 + 1, 0.2, False, t_start=time.perf_counter(),
                            device=device, cfg_overrides=over, **kw)


def test_sound_runs_are_correct():
    for cell in ("lu32k.solve", "chox32k.solve", "lu32k.resolve"):
        assert run(cell)["correct"] is True


@pytest.mark.parametrize("cell", ["lu32k.solve", "lu32k.resolve"])
def test_lu_factor_returning_its_state_unchanged(monkeypatch, cell):
    def unchanged(shard, geom, mesh, *a, **k):
        return shard.clone(), torch.arange(geom.M, device=shard.device)

    monkeypatch.setattr(lu_dist, "lu_factor_distributed", unchanged)
    r = run(cell)
    assert r["correct"] is False and r["failed"] == r["attempted"]


def test_cholesky_factor_returning_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(chol_dist, "cholesky_factor_distributed",
                        lambda shard, *a, **k: shard.clone())
    assert run("chox32k.solve")["correct"] is False


@pytest.mark.parametrize("cell", ["lu32k.solve", "chox32k.solve", "lu32k.resolve"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell):
    real = solvers.refine_classic

    def altered(*a, **k):
        x = real(*a, **k)
        x.view(-1)[7] += 1e-3 * float(x.abs().max())
        return x

    monkeypatch.setattr(solvers, "refine_classic", altered)
    r = run(cell)
    assert r["correct"] is False and r["failed"] >= 1


def test_half_the_right_hand_sides_left_out(monkeypatch):
    real = solvers.lu_solve_distributed

    def half(shard, perm, geom, mesh, b):
        x = real(shard, perm, geom, mesh, b)
        x[:, x.shape[1] // 2:] = 0
        return x

    monkeypatch.setattr(solvers, "lu_solve_distributed", half)
    assert run("lu32k.resolve")["correct"] is False


@pytest.mark.parametrize("cell", ["lu32k.solve", "chox32k.solve", "lu32k.resolve"])
def test_tf32_reference_in_the_programs_place(cell):
    """The plain reference with its trailing updates as TF32 products,
    put in the program's place (entries/plain_reference.py)."""
    r = run(cell, N=1024, entry="plain_reference", entry_knobs={"tf32": True})
    assert r["correct"] is False
    assert r["checks"]["factor_residual"]["value"] > r["checks"]["factor_residual"]["limit"]


def test_float32_reference_in_the_programs_place_is_correct():
    for cell in ("lu32k.solve", "chox32k.solve", "lu32k.resolve"):
        assert run(cell, N=1024, entry="plain_reference")["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lu32k.solve", "chox32k.solve", "lu32k.resolve"])
def test_programs_tf32_path_fails_on_the_card(cuda, cell):
    """The control on the card, at N=8192: the program with its TF32
    library products switched on (precision 'high', backend 'xla')."""
    cfg = harness.load_cell(cell).cfg
    r = run(cell, device="cuda", N=8192, v=1024, entry_knobs=cfg["control"])
    assert r["correct"] is False


@pytest.mark.parametrize("mode", ["program", "control", "reference", "reference_control"])
def test_calibration_readings_at_a_cpu_size(mode):
    """calibrate.py's four kinds of reading, each a run of the harness with
    its checks and `correct`; on the CPU the program's 'control' options
    compute as at 'highest'."""
    from portbench import calibrate

    rec = calibrate.reading("lu32k.solve", 7, "cpu", mode, {"N": 256, "v": 128})
    assert rec["residual_max"] < 1e-12
    limit = harness.load_cell("lu32k.solve").cfg["limits"]["factor_residual"]
    assert (rec["factor_residual"] > limit) == (mode == "reference_control")
    assert rec["correct"] is (mode != "reference_control")


def test_calibration_prints_nothing_once_jax_is_loaded(monkeypatch, capsys):
    import sys
    import types

    from portbench import calibrate

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        calibrate.emit({"mode": "program"}, None)
    assert e.value.code == 3 and capsys.readouterr().out == ""
