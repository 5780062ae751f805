"""Cholesky miniapp on one device — the port of
`conflux_tpu.cli.cholesky_miniapp` (the role of the reference's
`examples/cholesky_miniapp.cpp`).

Same CLI vocabulary (--dim, --tile, --grid, --run), the printTimings-style
report and the machine-parsable result protocol:

    _result_ cholesky,conflux_tpu_torch,<N>,<N_base>,<P>,<PxxPyxPz>,time,<type>,<ms>,<v>,<dtype>

plus --validate (||A - L L^T||_F / ||A||_F, computed on the device in
float64 strips) and --refine K (solve A x = 1 with K refinement sweeps).
A `_route_` line names the route before the result lines: float32 and
bfloat16 run the trailing update on K1, float64 on the library product
(backend "xla").

A grid of more than one rank (`--grid`), and more than 64 tile columns on
1x1x1, run the distributed program (`cholesky.distributed`) as the JAX
miniapp does, with `--lookahead`, `--segs` and `--auto`; `--validate` is
then the gather-free grid residual and `--refine` the grid solve. Under
torchrun every rank runs the miniapp and rank 0 prints; in one process the
ranks are threads (`--transport`).

Examples:
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 32768 --tile 1024 --run 1 --validate
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 256 --tile 64 --platform cpu --validate
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 4096 --tile 256 --dtype float64 --validate
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 256 --tile 16 --grid 2,2,1 \
        --platform cpu --dtype float64 --validate --refine 2
"""

from __future__ import annotations

import argparse

from conflux_tpu_torch.cli.common import (
    WallTimer,
    add_auto_arg,
    add_common_args,
    add_experiment_type_arg,
    add_grid_args,
    apply_auto,
    np_dtype,
    phase_profile,
    platform_device,
    print_route,
    resolve_knob_defaults,
    result_line,
    run_on_grid,
    segs_arg,
    sync,
)

# the JAX miniapp sends deeper factorizations to the distributed program
_SINGLE_MAX_KAPPA = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser("cholesky_miniapp", description=__doc__)
    p.add_argument("--dim", type=int, default=2048, help="matrix dimension N")
    p.add_argument("--tile", type=int, default=None, help="tile size v (default: heuristic)")
    p.add_argument("--grid", default=None,
                   help="Px,Py,Pz (default 1,1,1: one rank; several ranks run the "
                   "distributed program)")
    p.add_argument("--run", type=int, default=2, help="timed repetitions")
    p.add_argument("--validate", action="store_true", help="residual ||A-LL^T||_F check")
    p.add_argument(
        "--refine", type=int, default=None, metavar="K",
        help="after factoring, solve A x = 1 with K iterative-refinement "
        "sweeps (f64 residuals; pairs with --dtype bfloat16) and report the "
        "solve residual")
    p.add_argument("--lookahead", action="store_true", default=None,
                   help="software-pipelined loop: the next panel's reduce before the "
                   "rest of the trailing update")
    p.add_argument("--segs", default=None, metavar="RxC", type=segs_arg,
                   help="trailing-update row x col segment counts, e.g. 8x8")
    add_auto_arg(p)
    add_grid_args(p)
    add_experiment_type_arg(p)
    add_common_args(p)
    return p.parse_args(argv)


def _timings_block(geom, grid, times) -> None:
    """printTimings-style report (reference cholesky_miniapp.cpp:34-50)
    and the `_result_` lines."""
    print("==========================================")
    print("    PROBLEM PARAMETERS:")
    print(f"    Matrix dimension: {geom.N} (requested {geom.Nbase})")
    print(f"    Tile size: {geom.v}")
    print(f"    Grid: {grid} on {grid.P} devices")
    print(f"    Runs: {len(times)}")
    print("    TIMINGS [ms]:")
    for ms in times:
        print(f"       {ms:.3f}")
    print("==========================================")


def main(argv=None) -> int:
    args = parse_args(argv)

    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, choose_cholesky_tile

    grid = Grid3.parse(args.grid) if args.grid else Grid3(1, 1, 1)
    if args.refine is not None and args.refine < 0:
        raise SystemExit("--refine needs a sweep count >= 0")
    knob_map = {"tile": ("v", None), "segs": ("segs", (8, 8)),
                "lookahead": ("lookahead", False)}
    if args.auto:
        apply_auto(args, "cholesky", args.dim, grid.P, args.dtype, knob_map)
    resolve_knob_defaults(args, knob_map)
    v = args.tile or choose_cholesky_tile(args.dim, grid.P)
    geom = CholeskyGeometry.create(args.dim, v, grid)
    # the dedicated single-device path up to 64 tile columns, as the JAX
    # miniapp; beyond, and on any grid of several ranks, the distributed
    # program
    if grid.P == 1 and geom.Kappa <= _SINGLE_MAX_KAPPA:
        return _single(args, geom, grid)
    backend, _panel_algo = print_route(args.dtype)
    run_on_grid(grid, args, lambda mesh: _distributed(mesh, args, geom, backend))
    if args.profile:
        from conflux_tpu_torch import profiler

        profiler.report()
    return 0


def _distributed(mesh, args, geom, backend) -> None:
    """The miniapp on one rank of the grid (every rank runs it; rank 0
    prints)."""
    import contextlib

    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
    from conflux_tpu_torch.validation import cholesky_residual_distributed, make_spd_matrix

    rank0 = mesh.rank == 0
    grid = geom.grid

    def region(name):
        return profiler.region(name) if rank0 else contextlib.nullcontext()

    dtype = np_dtype(args.dtype)
    with region("init_matrix"):
        # the JAX miniapp's matrix, made on the device, each rank taking its shard
        A = make_spd_matrix(geom.N, dtype=dtype, device=mesh.device)
        shard = geom.local_block(A, mesh.x, mesh.y).clone(memory_format=torch.contiguous_format)
        if args.dtype == "bfloat16":
            shard = shard.to(torch.bfloat16)
        if args.refine is None:
            del A
        sync(mesh.device)
    times = []
    for rep in range(args.run + 1):  # rep 0 is the warm-up
        mesh.barrier()
        with WallTimer() as t:
            with region("cholesky_factorization"):
                out = cholesky_factor_distributed(shard, geom, mesh, backend=backend,
                                                  lookahead=args.lookahead, segs=args.segs)
                sync(mesh.device)
                mesh.barrier()
        if rep > 0:
            times.append(t.ms)
    if rank0:
        _timings_block(geom, grid, times)
        for ms in times:
            print(result_line("cholesky", geom.N, grid.P, grid, args.type, ms, geom.v,
                              args.dtype))
    if args.validate:
        with region("validation"):
            res = cholesky_residual_distributed(shard, out, geom, mesh)
        if rank0:
            print(f"_residual_ {res:.3e}")
    if args.refine is not None:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.cli.common import refine_report

        with region("refine_solve"):
            refine_report(lambda r: solvers.cholesky_solve_distributed(out, geom, mesh, r),
                          A, out.dtype, args.refine, emit=rank0)
    if args.profile:
        from conflux_tpu_torch.cholesky.distributed import build_program

        phase_profile(build_program(geom, mesh, backend=backend, lookahead=args.lookahead,
                                    segs=args.segs, dtype=shard.dtype), shard, mesh)


def _single(args, geom, grid) -> int:
    """The dedicated single-device route (`cholesky.single`; the distributed
    program's knobs do not apply to it, as in the JAX miniapp)."""
    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.cholesky.single import cholesky_blocked
    from conflux_tpu_torch.validation import cholesky_residual_device, make_spd_matrix

    device = platform_device(args)
    with profiler.region("init_matrix"):
        # built on the device, the JAX package's bits
        A_dev = make_spd_matrix(geom.N, dtype=np_dtype(args.dtype), device=device)
        dev = A_dev.to(torch.bfloat16) if args.dtype == "bfloat16" else A_dev
        sync(device)

    backend, _panel_algo = print_route(args.dtype)
    times = []
    for rep in range(args.run + 1):  # rep 0 is the warm-up
        with WallTimer() as t:
            with profiler.region("cholesky_factorization"):
                out = cholesky_blocked(dev, v=geom.v, backend=backend)
                sync(device)
        if rep > 0:
            times.append(t.ms)

    _timings_block(geom, grid, times)
    for ms in times:
        print(result_line("cholesky", geom.N, grid.P, grid, args.type, ms,
                          geom.v, args.dtype))

    if args.validate:
        with profiler.region("validation"):
            res = cholesky_residual_device(A_dev, out)
        print(f"_residual_ {res:.3e}")

    if args.refine is not None:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.cli.common import refine_report

        with profiler.region("refine_solve"):
            refine_report(lambda r: solvers.cholesky_solve(out, r), A_dev,
                          out.dtype, args.refine)

    if args.profile:
        profiler.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
