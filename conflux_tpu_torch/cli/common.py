"""Shared CLI plumbing for the port's miniapps."""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from conflux_tpu_torch.device import resolve_device, sync  # noqa: F401 (sync re-exported)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--platform", default="gpu", choices=["gpu", "cpu"],
        help="where to run (default gpu: the CUDA card, and an error without "
        "one); cpu runs the kernels' plain PyTorch versions")
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64", "bfloat16"],
        help="element type. LU and Cholesky miniapps: float32 and bfloat16 "
        "(bf16 storage, f32 panel math) run the kernel route (backend and "
        "panel algo 'kernel'); float64 runs the JAX package's default "
        "library route (backend 'xla', panel algo 'auto'), as K1 and K2 "
        "have no float64 instance. QR miniapp: the library QR in the dtype "
        "(bfloat16 computes in float32); --full's trailing GEMMs run K1 at "
        "float32 and bfloat16 and the library product at float64")
    p.add_argument("--profile", action="store_true", help="print region timings")


def platform_device(args) -> torch.device:
    """The device `--platform` names; raises without a card unless the
    caller asked for the CPU."""
    return resolve_device("cpu" if args.platform == "cpu" else "cuda")


def print_route(dtype: str) -> tuple[str, str]:
    """(backend, panel algo) a miniapp runs `dtype` on, printed as its
    `_route_` line: the kernels take float32 and bfloat16, and float64
    takes the library route the JAX miniapp itself runs."""
    backend, panel_algo = ("xla", "auto") if dtype == "float64" else ("kernel", "kernel")
    print(f"_route_ backend={backend} panel_algo={panel_algo} ({dtype})")
    return backend, panel_algo


def np_dtype(name: str):
    return {"float32": np.float32, "float64": np.float64, "bfloat16": np.float32}[name]


def refine_report(solve_fn, A: torch.Tensor, out_dtype: torch.dtype,
                  sweeps: int, emit: bool = True) -> float:
    """--refine epilogue: solve A x = 1 with `sweeps` classic-IR rounds
    (float64 residuals, the HPL-MxP recipe), print the `_solve_residual_`
    line (with `emit`: the grid routes print on rank 0 only), return the
    relative residual. A is the matrix that was factored, on the factors'
    device; corrections ride the factors' compute dtype."""
    from conflux_tpu_torch import solvers
    from conflux_tpu_torch.ops import blas

    n = A.shape[0]
    b = torch.ones((n,), dtype=A.dtype, device=A.device)
    corr_dtype = blas.compute_dtype(out_dtype)
    x = solvers.refine_classic(solve_fn, A, b, sweeps, torch.float64, corr_dtype)
    b64 = b.to(torch.float64)
    r = solvers._residual_strips(A, x, b64, torch.float64)
    rel = float(torch.linalg.norm(r) / torch.linalg.norm(b64))
    flag = "PASS" if rel <= 1e-6 else "----"
    if emit:
        print(f"_solve_residual_ refine={sweeps} rel={rel:.3e} [{flag} <=1e-6]")
    return rel


class WallTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3


def phase_profile(program, shard, mesh, phase_re: str | None = None) -> dict | None:
    """Per-phase device-time table of a grid program (the reference's
    per-step semiprof table, `README.md:120-165`): one extra run of
    `program(shard, mesh)` (a `build_program` of the timed run, not
    donating), traced by `profiler.trace` on rank 0 while the other ranks
    run it beside, then `profiler.phase_table` (`phase_re` defaults to the
    LU and Cholesky phases). Every rank calls it; rank 0 returns the table.

    On the CPU the trace has no device work, and this prints `(no device
    phase table: ...)` as the reference does; on a card a trace without
    device work or without a phase raises. torch records the ranges of the
    tracing thread only, so in a threaded world the other ranks' launches
    count under '(other)'."""
    import tempfile

    from conflux_tpu_torch import profiler

    if mesh.rank != 0:
        program(shard, mesh)
        sync(mesh.device)
        return None
    phase_re = profiler._PHASE_RE if phase_re is None else phase_re
    with tempfile.TemporaryDirectory(prefix="conflux-phases-") as trace_dir:
        with profiler.trace(trace_dir):
            program(shard, mesh)
            sync(mesh.device)
        try:
            table = profiler.phase_table(trace_dir, phase_re=phase_re)
        except ValueError as e:
            if mesh.device.type == "cuda":
                raise
            print(f"(no device phase table: {e})")
            return None
    if set(table) <= {"(other)"}:
        raise RuntimeError("the traced run launched device work inside no phase range")
    if mesh.grid.P > 1:
        print(f"(rank 0's phases; the other {mesh.grid.P - 1} ranks' launches are under "
              "'(other)' in a threaded world, and on their own processes otherwise)")
    return table


def add_experiment_type_arg(p) -> None:
    """The reference's -t vocabulary (`examples/conflux_miniapp.cpp:63-66`)."""
    p.add_argument(
        "-t", "--type", default="weak", choices=["weak", "strong"],
        help="experiment type: sets the reported N_base (reference "
        "convention: N / int(sqrt(P)) for weak scaling, N for strong)")


def result_line(algo: str, N: int, P: int, grid, exp_type: str,
                ms: float, v: int, dtype: str) -> str:
    """Reference line shape (`examples/conflux_miniapp.cpp:136-165`):
    `_result_ <algo>,<impl>,<N>,<N_base>,<P>,<grid>,time,<weak|strong>,<ms>,<v>`
    with N_base = N // int(sqrt(P)) under weak scaling, and the dtype
    appended as an 11th field fixed-width parsers ignore."""
    n_base = N // math.isqrt(P) if exp_type == "weak" else N
    return (f"_result_ {algo},conflux_tpu_torch,{N},{n_base},{P},"
            f"{grid},time,{exp_type},{ms:.3f},{v},{dtype}")


def positive_int(text: str) -> int:
    """argparse type for counts that must be >= 1."""
    try:
        n = int(text)
    except ValueError:
        n = 0
    if n < 1:
        raise argparse.ArgumentTypeError(f"expected a positive integer, got {text!r}")
    return n


def segs_arg(text: str) -> tuple[int, int]:
    """argparse type for --segs RxC (e.g. '16x16'): two positive ints."""
    r, sep, c = text.lower().partition("x")
    try:
        segs = (int(r), int(c))
    except ValueError:
        segs = None
    if not sep or segs is None or segs[0] < 1 or segs[1] < 1:
        raise argparse.ArgumentTypeError(
            f"expected RxC with positive integers (e.g. 16x16), got {text!r}")
    return segs


def add_auto_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--auto", action="store_true",
        help="resolve the tuning knobs you did not pass from the measured dispatch "
        "table (conflux_tpu_torch.autotune; its card rules start empty, so today "
        "this prints the library defaults and says so); any flag you pass pins "
        "its knob, even at the library default value")


def add_grid_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--transport", default=None, choices=["gloo", "nccl", "staged"],
        help="collectives of a grid of several ranks (default: gloo on the CPU; on "
        "cards nccl under torchrun, one card per rank, and 'staged', gloo through "
        "host copies, for the ranks of one process sharing one card)")


def apply_auto(args, algo: str, N: int, P: int, dtype: str, flag_knobs: dict) -> None:
    """--auto: every (args attribute -> (knob name, library default)) in
    `flag_knobs` whose flag was not passed (its None sentinel) takes the
    measured recommendation's knob (None knobs never overwrite). Follow it
    with :func:`resolve_knob_defaults`. Prints `_auto_` lines: one
    space-free key=value token per applied knob (tuples as RxC, bools
    on/off) and the recommendation's provenance."""
    if not flag_knobs:
        print("_auto_ (no auto-tunable knobs for this mode)")
        return
    from conflux_tpu_torch import autotune

    device_kind = "cpu" if getattr(args, "platform", "gpu") == "cpu" else None
    rec = autotune.recommended(algo, N, P=P, dtype=str(dtype), device_kind=device_kind)

    def fmt(v):
        if isinstance(v, bool):
            return "on" if v else "off"
        return "x".join(map(str, v)) if isinstance(v, tuple) else v

    applied = []
    for attr, (knob, _default) in flag_knobs.items():
        if getattr(args, attr) is None and rec.knobs.get(knob) is not None:
            setattr(args, attr, rec.knobs[knob])
            applied.append(f"{attr}={fmt(rec.knobs[knob])}")
    print(f"_auto_ {' '.join(applied) if applied else '(all knobs pinned)'}")
    print(f"_auto_provenance_ {rec.provenance}")


def resolve_knob_defaults(args, flag_knobs: dict) -> None:
    """Fill every auto-eligible attribute still at its None sentinel with
    its library default (after :func:`apply_auto`, or instead of it)."""
    for attr, (_knob, default) in flag_knobs.items():
        if getattr(args, attr) is None:
            setattr(args, attr, default)


def run_on_grid(grid, args, body):
    """Run body(mesh) on every rank of `grid` and return rank 0's result
    (None on the other processes of a torchrun world).

    Under torchrun (WORLD_SIZE > 1) each process is one rank: the world
    comes from its environment (`initialize_multihost`), on
    `cuda:$LOCAL_RANK` or the CPU. In one process a grid of several ranks
    runs as threads (`parallel.mesh.run_threaded`), all on the one card or
    the CPU. Rank 0 prints a `_grid_` line naming the world and its
    transport."""
    import os

    from conflux_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, run_threaded

    cpu = args.platform == "cpu"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        import torch.distributed as dist

        transport = args.transport or ("gloo" if cpu else "nccl")
        initialize_multihost(backend="nccl" if transport == "nccl" else "gloo")
        device = "cpu" if cpu else torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        try:
            mesh = make_mesh(grid, device=device, transport=transport)
            if mesh.rank == 0:
                print(f"_grid_ {grid} ranks={grid.P} world=processes transport={transport} "
                      f"device={mesh.device}")
            out = body(mesh)
        finally:
            dist.destroy_process_group()
        return out if mesh.rank == 0 else None
    device = platform_device(args)
    if grid.P == 1:
        print(f"_grid_ {grid} ranks=1 world=single transport=none device={device}")
        return body(make_mesh(grid, device=device))
    transport = args.transport or ("gloo" if cpu else "staged")
    print(f"_grid_ {grid} ranks={grid.P} world=threads transport={transport} device={device}")
    return run_threaded(grid, body, device=device, transport=transport, timeout=3600.0)[0]
