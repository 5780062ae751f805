"""The frozen trace arithmetic on a synthetic chrome trace."""

import json

import pytest

from portbench import trace as tr


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events():
    """Two traced systems. System 0: a pivoting launch inside
    step1_pivoting (inside an outer step0_reduce range, so the innermost
    phase wins), a GEMM in step6_dgemm, a copy outside every phase, and a
    fill inside the benchmark's inputs range. System 1: one solve kernel.
    The device is idle from 400 to 500 and from 700 to 800."""
    return [
        _x(tr.RANGE_CAT, "portbench.system.0", 0, 500),
        _x(tr.RANGE_CAT, "portbench.inputs", 0, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 2, corr=1),
        _x(tr.RANGE_CAT, "step0_reduce", 30, 100),
        _x(tr.RANGE_CAT, "step1_pivoting", 40, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=2),
        _x(tr.RANGE_CAT, "step6_dgemm", 150, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 2, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 260, 2, corr=4),
        _x(tr.CPU_OP_CAT, "aten::item", 390, 110),
        _x(tr.RANGE_CAT, "portbench.system.1", 600, 300),
        _x("cuda_runtime", "cudaLaunchKernel", 610, 2, corr=5),
        _x(tr.CPU_OP_CAT, "aten::norm", 690, 120),
        _x("gpu_memset", "fill", 10, 40, tid=7, corr=1),
        _x("kernel", "lu_block_kernel", 60, 140, tid=7, corr=2),
        _x("kernel", "gemm_tma_kernel", 200, 150, tid=7, corr=3),
        _x("gpu_memcpy", "Memcpy DtoD", 350, 50, tid=7, corr=4),
        _x("kernel", "trsm_kernel", 600, 100, tid=7, corr=5),
        _x("kernel", "orphan", 850, 50, tid=7),
    ]


def test_union_and_merge():
    assert tr.union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert tr.union_us([]) == 0
    assert tr.merged([(5, 20), (0, 10), (30, 40), (40, 41)]) == [(0, 20), (30, 41)]


def test_phase_attribution_innermost_scope():
    t = tr.Trace(_events())
    ph = t.phase_ms()
    assert ph["step1_pivoting"] == (0.14, 1)
    assert ph["step6_dgemm"] == (0.15, 1)
    assert ph[tr.OTHER][1] == 4  # fill, memcpy, trsm, the orphan
    assert t.events_per_system() == {0: 4, 1: 1, None: 1}


def test_window_busy_and_gaps():
    t = tr.Trace(_events())
    assert t.window == (0, 900)
    assert t.window_s() == pytest.approx(900e-6)
    # busy: 10-50, 60-400, 600-700, 850-900
    assert t.busy_s() == pytest.approx((40 + 340 + 100 + 50) * 1e-6)
    # idle: 0-10, 50-60, 400-600, 700-850, each named at its middle
    gaps = t.idle_gaps()
    assert [g[0] for g in gaps] == ["portbench.system.0 > aten::item",
                                    "portbench.system.1 > aten::norm",
                                    "portbench.inputs > -", "step1_pivoting > -"]
    assert [g[1] for g in gaps] == pytest.approx([200e-6, 150e-6, 10e-6, 10e-6])
    top = t.top_device_ops(2)
    assert top[0] == ["gemm_tma_kernel", pytest.approx(150e-6)]


def test_ms_where_excludes_inputs_and_phases(tmp_path):
    import re
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    t = tr.Trace(tr.load_events(str(p)))
    pat = re.compile(tr.FACTOR_PHASE_RE)
    ms = t.ms_where(lambda path: not any(x == "portbench.inputs" or pat.search(x)
                                         for x in path))
    assert ms == pytest.approx((50 + 100 + 50) / 1e3)  # the copy, trsm, orphan


def test_empty_trace_reads_nothing():
    t = tr.Trace([_x(tr.RANGE_CAT, "portbench.system.0", 0, 10)])
    assert t.busy_s() == 0 and t.top_device_ops() == [] and t.phase_ms() == {}
