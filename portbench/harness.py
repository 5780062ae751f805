"""One run of one cell: set-up, the measured window, the traced systems,
the check of every answer, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: the cell in `BENCHMARK.json`, its configuration file, the
traffic file `traffic/<traffic>.json`, the cell's file
`workloads/<name>.json`, the entry `entries/<entry>.py` and matrix class
`matrices/<matrix>.py` that the configuration names, and one reader
`metrics/<metric>.py` per metric.

A system is one A x = b (A X = B with a block of right-hand sides) solved
to the configuration's accuracy. Its inputs come from `--seed` and the
system's index alone, so the same seed gives the same systems, and every
seed the same sizes.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# --------------------------------------------------------------------------- #
# finding a cell's parts by name
# --------------------------------------------------------------------------- #

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    bench: dict
    workload: dict
    cfg: dict
    traffic: dict
    extra: dict

    def metrics(self, section: str) -> list[dict]:
        """The metrics of `section` ("end_to_end" or "per_layer") this cell
        reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str) -> Cell:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    extra = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    return Cell(name, bench, w, cfg, traffic, extra)


# --------------------------------------------------------------------------- #
# inputs from the seed
# --------------------------------------------------------------------------- #

def stream_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit generator seed for one input of one system: any --seed
    (negative or past 64 bits too) gives its own streams."""
    h = hashlib.blake2b(f"{seed}/{stream}/{index}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


class Inputs:
    """The systems of one seed: A_i and B_i, drawn on the device."""

    def __init__(self, cell: Cell, seed: int, device):
        self.N = cell.cfg["N"]
        self.nrhs = cell.traffic["nrhs"]
        self.fresh = cell.traffic["matrix"] == "fresh"
        self.seed, self.device = seed, torch.device(device)
        self.matrix = load_module("matrices", cell.cfg["matrix"])

    def _gen(self, stream: str, index: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, stream, index))
        return g

    def matrix_of(self, index: int) -> torch.Tensor:
        return self.matrix.draw(self.N, self._gen("A", index if self.fresh else 0), self.device)

    def rhs_of(self, index: int) -> torch.Tensor:
        shape = (self.N,) if self.nrhs == 1 else (self.N, self.nrhs)
        B = torch.empty(shape, dtype=torch.float32, device=self.device)
        return B.uniform_(-1.0, 1.0, generator=self._gen("b", index))


# --------------------------------------------------------------------------- #
# the run
# --------------------------------------------------------------------------- #

WARMUP = -1  # the warm-up system's index: its own streams, never a window's


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: Cell
    entry: object
    setup_s: float = 0.0
    window_s: float = 0.0
    systems: int = 0
    trace: object = None
    traced_systems: int = 0

    @property
    def refactor(self) -> bool:
        return self.cell.traffic["matrix"] == "fresh"

    @property
    def traced_factorizations(self) -> int:
        return self.traced_systems if self.refactor else 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _range(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class System:
    """Runs systems of one cell: fresh ones factor and solve, the others
    solve against the factor made in set-up."""

    def __init__(self, entry, inputs: Inputs):
        self.entry, self.inputs = entry, inputs
        self.fresh = inputs.fresh
        self.A = None

    def setup(self) -> None:
        if not self.fresh:
            self.A = self.inputs.matrix_of(0)
            self.entry.factor(self.A)

    def run(self, index: int, traced: bool = False):
        with _range(f"portbench.system.{index}", traced):
            with _range("portbench.inputs", traced):
                A = self.inputs.matrix_of(index) if self.fresh else self.A
                B = self.inputs.rhs_of(index)
            X = (self.entry.factor_solve if self.fresh else self.entry.solve)(A, B)
            _sync(self.inputs.device)
        return X


def _launch_counts() -> dict:
    from conflux_tpu_torch.ops import hopper_kernels

    return dict(hopper_kernels.LAUNCHES)


def _alloc_counts(cuda: bool) -> dict:
    """The caching allocator's retries (a cache flush: a synchronize and
    cudaFree) and its cudaMalloc and cudaFree calls so far."""
    if not cuda:
        return {}
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                      "num_device_free")}


def _trace_systems(sysrun: System, first: int, count: int, device) -> tuple:
    """Run `count` systems under torch.profiler; return (answers, Trace).
    The chrome trace goes under TMPDIR and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import Trace, load_events

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        answers = []
        with profile(activities=acts) as prof:
            for i in range(first, first + count):
                answers.append((i, sysrun.run(i, traced=True)))
        path = os.path.join(tmp, "trace.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        del prof
        size = os.path.getsize(path)
        parsed = Trace(load_events(path))
        log(f"trace file {size} bytes, written and read in {time.perf_counter() - t0:.3f} s")
        return answers, parsed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (`conflux_tpu_torch` is not `conflux_tpu`). Read
    after the run has loaded its last module, just before a result is
    printed."""
    banned = {"jax", "jaxlib", "flax", "conflux_tpu"}
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in banned})


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def finite(x: float) -> float:
    """x, with NaN and infinities read as the largest float: a JSON number
    that fails every limit."""
    return x if abs(x) <= sys.float_info.max else sys.float_info.max


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", cfg_overrides: dict | None = None,
             entry_knobs: dict | None = None) -> dict:
    """One run of cell `name`; returns the result line's object. `t_start`
    is the process's start on the perf_counter clock. `entry_knobs` (the
    program's options: the control's) and `cfg_overrides` (another entry,
    such as the plain reference, or the tests' sizes) are for the
    calibration and the tests; the benchmark's runs pass neither. The
    caller checks `forbidden_modules()` once this has returned."""
    from portbench.reference import common as ref

    cell = load_cell(name)
    if cfg_overrides:
        cell.cfg = {**cell.cfg, **cfg_overrides}
    entry = load_module("entries", cell.cfg["entry"]).Entry(cell.cfg, device, entry_knobs)
    inputs = Inputs(cell, seed, device)
    sysrun = System(entry, inputs)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        log(f"card: {power_line()}")

    # ---- set-up: the factor of a fixed matrix, one warm-up system -------- #
    sysrun.setup()
    sysrun.run(WARMUP)
    run = Run(cell, entry)
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    # ---- the measured window ------------------------------------------- #
    answers, ends = [], []
    l0, m0 = _launch_counts(), _alloc_counts(cuda)
    t0 = time.perf_counter()
    while True:
        i = len(answers)
        answers.append((i, sysrun.run(i)))
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    t1 = ends[-1]
    run.window_s, run.systems = t1 - t0, len(answers)
    l1, m1 = _launch_counts(), _alloc_counts(cuda)
    log(f"window: {run.systems} systems in {run.window_s:.6f} s; kernel launches a "
        f"system: { {k: (l1[k] - l0[k]) / run.systems for k in l1} }; caching allocator "
        f"in the window: { {k: m1[k] - m0[k] for k in m1} }")
    log("window: ms a system: " + " ".join(
        f"{(b - a) * 1e3:.3f}" for a, b in zip([t0] + ends[:-1], ends)))

    # ---- traced systems (--trace 1) ------------------------------------ #
    if trace:
        run.traced_systems = int(cell.extra["trace_systems"])
        traced, run.trace = _trace_systems(sysrun, len(answers), run.traced_systems, device)
        answers += traced
        log(f"trace: {run.traced_systems} systems in {run.trace.window_s():.6f} s, device "
            f"busy {run.trace.busy_s():.6f} s; device events by system: "
            f"{dict(sorted(run.trace.events_per_system().items(), key=str))}")
        for ph, (ms, n) in sorted(run.trace.phase_ms().items(), key=lambda kv: -kv[1][0]):
            log(f"  phase {ph:<20} {ms:12.3f} ms {n:8d} events")

    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- the check: every answer against the reference's residual ------ #
    factor = entry.factor_out
    entry.release()
    ref.no_tf32()
    limit = float(cell.cfg["accuracy"])
    worst, failed, fixed_A = 0.0, 0, sysrun.A
    sysrun.A = None
    for i, X in answers:
        A = fixed_A if fixed_A is not None else inputs.matrix_of(i)
        res = finite(float(ref.relative_residuals(A, X, inputs.rhs_of(i)).max()))
        worst = max(worst, res)
        failed += not res <= limit
        del A
    checks = {"residual_max": {"value": worst, "limit": limit}}
    ref_mod = load_module("reference", cell.cfg["reference"])
    if factor is not None:
        # the last system's factor, against that system's matrix
        last = answers[-1][0]
        A = fixed_A if fixed_A is not None else inputs.matrix_of(last)
        checks.update({k: {"value": finite(c["value"]), "limit": c["limit"]}
                       for k, c in ref_mod.extra_checks(cell.cfg, A, factor).items()})
        del A
    del factor, fixed_A, answers

    # ---- metrics -------------------------------------------------------- #
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": run.systems + run.traced_systems,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s(), run.trace.window_s()
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = bool(ok and failed == 0 and result["attempted"] > 0)
    result["checks"] = checks
    return result
