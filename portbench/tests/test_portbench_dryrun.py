"""Each cell's whole run at a tiny size on the CPU (the kernels' plain
versions): set-up, window, traced systems, the check, the result line;
and the import guard."""

import json
import subprocess
import sys
import time

import pytest

from portbench import harness

TINY = {"N": 256, "v": 128}
CELLS = ["lu32k.solve", "chox32k.solve", "lu32k.resolve"]


def run(cell, trace, seed=2**31 + 17, **kw):
    return harness.run_cell(cell, seed, 0.2, trace, t_start=time.perf_counter(),
                            device="cpu", cfg_overrides=TINY, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell):
    r = run(cell, False)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"solve_ms", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks" and r["checks"]["residual_max"]["limit"] == 1e-6
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    json.loads(json.dumps(r, allow_nan=False))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    r = run(cell, True)
    assert r["correct"] is True
    # no device events on the CPU: the trace readers find nothing to read
    assert set(r["metrics"]) == {"system_mfu"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["attempted"] > harness.load_cell(cell).extra["trace_systems"]


def test_same_seed_same_systems():
    cell = harness.load_cell("lu32k.solve")
    cell.cfg = {**cell.cfg, **TINY}
    a, b = harness.Inputs(cell, 5, "cpu"), harness.Inputs(cell, 5, "cpu")
    assert bool((a.matrix_of(3) == b.matrix_of(3)).all())
    assert bool((a.rhs_of(3) == b.rhs_of(3)).all())
    assert not bool((a.rhs_of(3) == a.rhs_of(4)).all())


def test_import_guard_compares_whole_names():
    assert harness.forbidden_modules(["conflux_tpu_torch", "conflux_tpu_torch.ops",
                                      "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "conflux_tpu.lu", "flax",
                                      "jaxlib"]) == ["conflux_tpu.lu", "flax", "jax.numpy",
                                                     "jaxlib"]


def test_a_run_loads_no_jax():
    """A whole run in a fresh process, then the guard over its modules."""
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "r = harness.run_cell('chox32k.solve', 3, 0.1, False, t_start=time.perf_counter(),"
            " device='cpu', cfg_overrides={'N': 256, 'v': 128});"
            "print(r['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_cli_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "lu32k.solve",
                          "--seed", "1", "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a card is visible here")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("plant", [False, True])
def test_the_cli_prints_no_result_once_jax_is_loaded(monkeypatch, capsys, plant):
    """run.py, its look for a card skipped, runs a cell at a tiny size on
    the CPU; a metric reader that loads a module named `jax` (after the
    window, as a late import would) leaves no result and exit code 3."""
    import types

    import torch

    sys.path.insert(0, harness.HERE)
    import run as cli

    real_run, real_load = harness.run_cell, harness.load_module

    def load(kind, name):
        mod = real_load(kind, name)
        if plant and kind == "metrics" and name == "setup_s":
            read = mod.read

            def planted(run):
                sys.modules["jax"] = types.ModuleType("jax")
                return read(run)

            mod.read = planted
        return mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: real_run(
        *a, **k, device="cpu", cfg_overrides=TINY))
    monkeypatch.setattr(harness, "load_module", load)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc = cli.main(["--workload", "chox32k.solve", "--seed", "3", "--seconds", "0.1"])
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    if plant:
        assert rc == 3 and out.out == "" and "jax" in out.err
    else:
        assert rc == 0 and json.loads(out.out.splitlines()[-1])["correct"] is True
