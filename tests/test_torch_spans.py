"""The port's spans and host-sync counter on the CPU (no JAX): the ranges
the grid solves, the classic refinement and the panel election open under
a profiler, where every device-to-host read sits (inside a `sync.*`
range), the untraced `sync.set_rows` count of a grid LU, and the
benchmark's four readers of them on a hand-written chrome trace."""

import json
import re
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conflux_tpu_torch import profiler, solvers
from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
from conflux_tpu_torch.lu.distributed import lu_factor_distributed
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.parallel.mesh import make_mesh
from portbench import harness
from portbench import trace as tr

N = 512
GRID = Grid3(1, 1, 1)
SWEEPS = 2
FACTOR_PHASES = {"step0_reduce", "step1_pivoting", "step2_pivotrows", "step4_dtrsm",
                 "step5_dtrsm", "step6_dgemm", "step7_writes", "reduceA11", "choleskyA00",
                 "updateA10", "scatterA11", "computeA11"}
SPANS = {"solve.distributed", "solve.scatter", "solve.forward", "solve.backward",
         "refine.classic", "refine.residual", "refine.check", "tournament.chunks",
         "tournament.tree", "panel.between", "panel.order", "sync.set_rows",
         "sync.refine_check", "sync.potrf_nan"}


def _system(spd: bool):
    g = torch.Generator().manual_seed(7)
    A = torch.rand((N, N), generator=g, dtype=torch.float32) - 0.5
    A = (A + A.T) / 2 if spd else A
    A += N * torch.eye(N)
    b = torch.rand((N,), generator=g, dtype=torch.float32) - 0.5
    return A, b


def _solve_distributed(v):
    A, b = _system(False)
    mesh = make_mesh(GRID, device="cpu")
    return lambda: solvers.solve_distributed(A, b, grid=GRID, v=v, mesh=mesh, refine=SWEEPS)


def _lu_resolve(v):
    A, b = _system(False)
    mesh = make_mesh(GRID, device="cpu")
    geom = LUGeometry.create(N, N, v, GRID)
    out, perm = lu_factor_distributed(geom.local_block(A, 0, 0).clone(), geom, mesh)
    return lambda: solvers.refine_classic(
        lambda r: solvers.lu_solve_distributed(out, perm, geom, mesh, r), A, b, SWEEPS,
        torch.float64, blas.compute_dtype(out.dtype))


def _chol_solve(v):
    A, b = _system(True)
    mesh = make_mesh(GRID, device="cpu")
    geom = CholeskyGeometry.create(N, v, GRID)

    def run():
        L = cholesky_factor_distributed(geom.local_block(A, 0, 0).clone(), geom, mesh)
        return solvers.refine_classic(
            lambda r: solvers.cholesky_solve_distributed(L, geom, mesh, r), A, b, 0,
            torch.float64, blas.compute_dtype(L.dtype))
    return run


def _expected(path, v):
    """{span: count} of one call of `path`: a solve forward and back per
    solve (one, then one a sweep), a residual a sweep and one more in the
    closing check, with its three reads; three reads in each of the three
    `_set_rows` of an LU step; a Cholesky step's potrf copies its NaN
    from the host."""
    steps = N // v
    if path == "chol_solve":
        return {"refine.classic": 1, "solve.forward": 1, "solve.backward": 1,
                "sync.potrf_nan": steps}
    out = {"refine.classic": 1, "solve.forward": SWEEPS + 1, "solve.backward": SWEEPS + 1,
           "refine.residual": SWEEPS + 1, "refine.check": 1, "sync.refine_check": 3}
    if path == "solve_distributed":
        out.update({"solve.distributed": 1, "solve.scatter": 1, "sync.set_rows": 9 * steps,
                    "tournament.chunks": steps, "tournament.tree": steps})
    return out


PATHS = {"solve_distributed": _solve_distributed, "lu_resolve": _lu_resolve,
         "chol_solve": _chol_solve}


@pytest.mark.parametrize("v", [128, 256])
@pytest.mark.parametrize("path", list(PATHS))
def test_spans_counts_and_syncs(path, v, tmp_path):
    run = PATHS[path](v)
    untraced = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    assert torch.equal(untraced, traced)  # the ranges change no bit
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = tr.load_events(str(tmp_path / "t.json"))
    ranges = [r for rs in tr.host_ranges(events).values() for r in rs]
    names = [name for _t0, _t1, name in ranges]
    counts = {s: names.count(s) for s in SPANS if s in names}
    want = _expected(path, v)
    assert {s: counts.get(s, 0) for s in want} == want
    assert set(counts) - set(want) <= {"panel.between", "panel.order"}
    # K2's column blocks: one panel.between after each 128-wide block but
    # the last, in every batched panel factorization (one panel.order each)
    assert counts.get("panel.between", 0) == (v // 128 - 1) * counts.get("panel.order", 0)
    assert (counts.get("panel.order", 0) > 0) == (path == "solve_distributed")

    # every device-to-host read inside a sync.* range, and one in each of
    # those around a read (the potrf NaN is a copy to the card)
    syncs = [(t0, t1) for t0, t1, name in ranges if name.startswith("sync.")]
    reads = [t0 for rs in tr.host_ranges(events, tr.CPU_OP_CAT).values()
             for t0, _t1, name in rs if name == "aten::_local_scalar_dense"]
    assert len(reads) == len(syncs) - counts.get("sync.potrf_nan", 0)
    assert all(any(s0 <= t <= s1 for s0, s1 in syncs) for t in reads)

    # the benchmark's phase pattern matches the factor phases only
    phase = re.compile(tr.FACTOR_PHASE_RE)
    assert {n for n in names if phase.search(n)} <= FACTOR_PHASES
    assert not any(phase.search(s) or s.startswith("portbench.") for s in SPANS)


def test_set_rows_syncs_untraced():
    v = 128
    A, _b = _system(False)
    geom = LUGeometry.create(N, N, v, GRID)
    profiler.clear()
    lu_factor_distributed(geom.local_block(A, 0, 0).clone(), geom, make_mesh(GRID, device="cpu"))
    calls, seconds = profiler.timings()["sync.set_rows"]
    assert calls == 9 * geom.n_steps and seconds > 0
    assert "sync.refine_check" not in profiler.timings()
    profiler.clear()


# --------------------------------------------------------------------------- #
# the benchmark's readers on a hand-written trace
# --------------------------------------------------------------------------- #

def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr)


def _events():
    """Two traced systems. System 0 factors: a K2 launch in
    tournament.chunks, a GEMM in panel.between inside it (both in
    step1_pivoting), then two sync.set_rows reads in step2_pivotrows.
    Both systems solve forward and back and take a residual, system 1's
    in refine.check with a sync.refine_check read. A sync range outside
    the window and one on another thread do not count."""
    R = tr.RANGE_CAT
    return [
        _x(R, "sync.set_rows", 0, 5),
        _x(R, "portbench.system.0", 10, 500),
        _x(R, "solve.distributed", 11, 490),
        _x(R, "step1_pivoting", 20, 60),
        _x(R, "tournament.chunks", 21, 50),
        _launch(22, 1),
        _x(R, "panel.between", 30, 20),
        _launch(31, 2),
        _x(R, "step2_pivotrows", 100, 40),
        _x(R, "sync.set_rows", 105, 5),
        _x(R, "sync.set_rows", 115, 5),
        _x(R, "refine.classic", 200, 300),
        _x(R, "solve.forward", 210, 30),
        _launch(211, 3),
        _x(R, "solve.backward", 250, 30),
        _launch(251, 4),
        _x(R, "refine.residual", 300, 30),
        _launch(301, 5),
        _x(R, "portbench.system.1", 600, 300),
        _x(R, "refine.classic", 601, 290),
        _x(R, "solve.forward", 610, 20),
        _launch(611, 6),
        _x(R, "refine.check", 700, 100),
        _x(R, "sync.refine_check", 701, 5),
        _x(R, "refine.residual", 710, 30),
        _launch(711, 7),
        _x(R, "sync.refine_check", 705, 5, tid=3),
        _x("kernel", "lu_block_kernel", 40, 100, tid=7, corr=1),
        _x("kernel", "gemm", 140, 20, tid=7, corr=2),
        _x("kernel", "trsm", 215, 40, tid=7, corr=3),
        _x("kernel", "trsm", 260, 60, tid=7, corr=4),
        _x("kernel", "cast_f64", 320, 80, tid=7, corr=5),
        _x("kernel", "trsm", 620, 10, tid=7, corr=6),
        _x("kernel", "cast_f64", 720, 50, tid=7, corr=7),
    ]


def _read(metric, events, systems=2, factorizations=2):
    run = types.SimpleNamespace(trace=tr.Trace(events), traced_systems=systems,
                                traced_factorizations=factorizations)
    return harness.load_module("metrics", metric).read(run)


def test_readers_on_a_trace(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    events = tr.load_events(str(p))
    assert _read("solve.grid_ms", events) == pytest.approx((40 + 60 + 10) / 1e3 / 2)
    assert _read("refine.residual_ms", events) == pytest.approx((80 + 50) / 1e3 / 2)
    assert _read("lu.elect_between_ms", events, factorizations=1) == pytest.approx(0.02)
    assert _read("host.syncs", events) == 3 / 2  # 2 set_rows + 1 refine_check
    # solve.refine_ms, the complement of the factor phases, holds both
    assert _read("solve.refine_ms", events) == pytest.approx((40 + 60 + 80 + 10 + 50) / 1e3 / 2)


def test_readers_read_nothing_without_device_events_or_spans():
    host_only = [ev for ev in _events() if ev["cat"] != "kernel"]
    for metric in ("solve.grid_ms", "refine.residual_ms", "lu.elect_between_ms",
                   "host.syncs"):
        assert _read(metric, host_only) is None
    # a program without the spans (the parent's): device time, no ranges
    bare = [ev for ev in _events() if not (ev["cat"] == tr.RANGE_CAT
                                           and not ev["name"].startswith("portbench."))]
    for metric in ("solve.grid_ms", "refine.residual_ms", "lu.elect_between_ms",
                   "host.syncs"):
        assert _read(metric, bare) is None
    # a program that solves and reads nothing back counts 0
    no_sync = [ev for ev in _events() if not ev["name"].startswith("sync.")]
    assert _read("host.syncs", no_sync) == 0
