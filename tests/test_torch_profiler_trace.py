"""The port's trace half (`conflux_tpu_torch.profiler`: `trace`, `scope`,
`op_name_map`, `_trace_durations`, `launch_phases`, `phase_table`) on the
CPU: the phase names the port's grid LU, CONFCHOX and QR record under
`trace` equal the named-scope phases the JAX package's compiled programs
carry (N=256, v=64, 1x1x1, both loops); the trace readers on a
hand-written chrome trace (nested ranges, two threads, an unattributed
kernel, a memcpy, a graph launch); a CPU trace has no device events; and
an untraced `region` opens no range."""

import json
import re
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conflux_tpu import profiler as jprofiler
from conflux_tpu.cholesky.distributed import build_program as jchol_program
from conflux_tpu.geometry import CholeskyGeometry as JCholeskyGeometry
from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu.lu.distributed import build_program as jlu_program
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.qr.distributed import build_program as jqr_program
from conflux_tpu_torch import profiler
from conflux_tpu_torch.cholesky.distributed import build_program as chol_program
from conflux_tpu_torch.cli.common import phase_profile
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import build_program as lu_program
from conflux_tpu_torch.parallel.mesh import make_mesh
from conflux_tpu_torch.qr.distributed import build_program as qr_program
from conflux_tpu_torch.validation import make_spd_matrix

N, V = 256, 64


def _reference_phases(kind: str, lookahead: bool) -> set:
    """The phase names of the JAX package's compiled grid program."""
    jmesh = jmake_mesh(JGrid3(1, 1, 1), devices=jax.devices()[:1])
    A = _matrix(kind)
    if kind == "chol":
        geom = JCholeskyGeometry.create(N, V, JGrid3(1, 1, 1))
        prog = jchol_program(geom, jmesh, lookahead=lookahead)
    else:
        geom = JLUGeometry.create(N, N, V, JGrid3(1, 1, 1))
        build = jlu_program if kind == "lu" else jqr_program
        prog = build(geom, jmesh, lookahead=lookahead, dtype=np.float32)
    hlo = prog.lower(jnp.asarray(geom.scatter(A))).compile().as_text()
    phase_re = profiler.QR_PHASE_RE if kind == "qr" else jprofiler._PHASE_RE
    return set(jprofiler._scope_map(hlo, phase_re).values())


def _range_names(trace_dir) -> set:
    """The names of the record_function ranges of the newest trace."""
    return {e["name"] for e in profiler._trace_events(str(trace_dir))
            if e.get("cat") == "user_annotation"}


def _matrix(kind: str) -> np.ndarray:
    if kind == "chol":
        return make_spd_matrix(N, dtype=np.float32).numpy()
    return np.random.default_rng(0).standard_normal((N, N)).astype(np.float32)


def _port_program(kind: str, lookahead: bool):
    grid = Grid3(1, 1, 1)
    if kind == "chol":
        geom = CholeskyGeometry.create(N, V, grid)
        return geom, chol_program(geom, backend="xla", lookahead=lookahead)
    geom = LUGeometry.create(N, N, V, grid)
    if kind == "lu":
        return geom, lu_program(geom, backend="xla", panel_algo="auto",
                                lookahead=lookahead)
    return geom, qr_program(geom, backend="xla", lookahead=lookahead)


@pytest.mark.parametrize("lookahead", [False, True], ids=["plain", "lookahead"])
@pytest.mark.parametrize("kind", ["lu", "chol", "qr"])
def test_phase_names_match_the_reference_program(kind, lookahead, tmp_path):
    geom, prog = _port_program(kind, lookahead)
    mesh = make_mesh(Grid3(1, 1, 1), device="cpu")
    shard = torch.from_numpy(geom.scatter(_matrix(kind))[0, 0])
    with profiler.trace(str(tmp_path)):
        prog(shard, mesh)
    phase = re.compile(profiler.QR_PHASE_RE if kind == "qr" else profiler._PHASE_RE)
    recorded = {n for n in _range_names(tmp_path) if phase.fullmatch(n)}
    assert recorded == _reference_phases(kind, lookahead)


def test_cpu_trace_has_no_device_events(tmp_path, capsys):
    """A CPU trace raises ValueError, as the reference's does; the grid
    routes' `phase_profile` prints the reference's message instead."""
    geom, prog = _port_program("lu", False)
    mesh = make_mesh(Grid3(1, 1, 1), device="cpu")
    shard = torch.from_numpy(geom.scatter(_matrix("lu"))[0, 0])
    with profiler.trace(str(tmp_path)):
        prog(shard, mesh)
    with pytest.raises(ValueError, match="no device op events"):
        profiler._trace_durations(str(tmp_path))
    with pytest.raises(ValueError, match="no device op events"):
        profiler.phase_table(str(tmp_path))
    assert phase_profile(prog, shard, mesh) is None
    assert "(no device phase table: trace has no device op events" in capsys.readouterr().out


def _ev(cat, name, tid, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _fixture(path) -> None:
    """Thread 1: step0_reduce around a launch (corr 1) and, nested in it,
    inner/step1_pivoting around two launches (2, a kernel; 3, a memcpy);
    after the ranges close, a launch outside every range (4). Thread 2:
    step6_dgemm around a graph launch of two kernels (5). A kernel whose
    runtime call the trace lacks (6), a device annotation and a CPU op
    that are no device work. The kernels run long after their ranges
    closed on the host."""
    events = [
        _ev("user_annotation", "step0_reduce", 1, 100.0, 100.0),
        _ev("user_annotation", "inner", 1, 120.0, 50.0),
        _ev("user_annotation", "step1_pivoting", 1, 130.0, 30.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 110.0, 2.0, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 135.0, 2.0, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1, 165.0, 2.0, corr=3),
        _ev("cuda_driver", "cuLaunchKernelEx", 1, 300.0, 2.0, corr=4),
        _ev("user_annotation", "step6_dgemm", 2, 105.0, 20.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 2, 110.0, 2.0, corr=5),
        _ev("cpu_op", "aten::mm", 1, 112.0, 5.0),
        _ev("kernel", "lu_block_kernel", 0, 1000.0, 500.0, corr=2),
        _ev("kernel", "gemm_tma_kernel", 0, 900.0, 250.0, corr=1),
        _ev("gpu_memcpy", "Memcpy DtoD", 0, 1600.0, 1000.0, corr=3),
        _ev("kernel", "gemm_simt_kernel", 0, 2000.0, 3000.0, corr=4),
        _ev("kernel", "gemm_tma_kernel", 0, 5000.0, 2000.0, corr=5),
        _ev("kernel", "gemm_tma_kernel", 0, 7000.0, 2000.0, corr=5),
        _ev("kernel", "orphan_kernel", 0, 9000.0, 750.0, corr=6),
        _ev("gpu_user_annotation", "step6_dgemm", 0, 5000.0, 4000.0),
    ]
    with open(path / "host.1.1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_readers_on_a_chrome_trace_fixture(tmp_path, capsys):
    _fixture(tmp_path)
    durs = profiler._trace_durations(str(tmp_path))
    assert durs == {1: ("gemm_tma_kernel", 0.25, 1), 2: ("lu_block_kernel", 0.5, 1),
                    3: ("Memcpy DtoD", 1.0, 1), 4: ("gemm_simt_kernel", 3.0, 1),
                    5: ("gemm_tma_kernel", 4.0, 2), 6: ("orphan_kernel", 0.75, 1)}
    assert profiler.op_name_map(str(tmp_path)) == {
        1: "step0_reduce", 2: "step0_reduce/inner/step1_pivoting",
        3: "step0_reduce/inner", 4: "", 5: "step6_dgemm"}
    phases = profiler.launch_phases(str(tmp_path))
    assert {c: p[0] for c, p in phases.items()} == {
        1: "step0_reduce", 2: "step1_pivoting", 3: "step0_reduce", 4: "(other)",
        5: "step6_dgemm", 6: "(other)"}
    table = profiler.phase_table(str(tmp_path))
    assert table == {"step0_reduce": (1.25, 2), "step1_pivoting": (0.5, 1),
                     "step6_dgemm": (4.0, 2), "(other)": (3.75, 2)}
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["PHASE", "OPS", "DEVICE", "ms", "%"]
    assert out[1].split()[0] == "step6_dgemm" and len(out) == 5
    # every device event counted once
    assert sum(n for _ms, n in table.values()) == 7
    with pytest.raises(ValueError, match="no HLO"):
        profiler.phase_table(str(tmp_path), "HloModule m")
    with pytest.raises(FileNotFoundError):
        profiler.phase_table(str(tmp_path / "missing"))


def test_region_opens_no_range_while_no_profiler_runs(tmp_path, monkeypatch):
    """`region`/`scope` open a record_function only while a profiler records
    this thread; `region` calls the lockcheck dispatch hook either way."""
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    seen = []
    monkeypatch.setattr(profiler, "_dispatch_hook", seen.append)
    with profiler.region("serve.solve"):
        pass
    assert profiler.scope("step6_dgemm") is profiler._NO_SCOPE
    assert opened == [] and seen == ["serve.solve"]
    others = []

    def other_thread():  # a thread the profiler does not record
        with profiler.region("serve.factor"):
            others.append(profiler.scope("x") is profiler._NO_SCOPE)

    with profiler.trace(str(tmp_path)):
        with profiler.region("serve.update"):
            with profiler.scope("step6_dgemm"):
                torch.ones(4).sum()
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and others == [True]
    assert opened == ["serve.update", "step6_dgemm"]
    assert seen == ["serve.solve", "serve.update", "serve.factor"]
    assert {"serve.update", "step6_dgemm"} <= _range_names(tmp_path)
    assert "serve.factor" not in _range_names(tmp_path)
    assert profiler.timings()["serve.update"][0] >= 1
