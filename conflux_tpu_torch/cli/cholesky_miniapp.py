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
(backend "xla"). Only the single-device route is ported: the flags of the distributed
program exit with a message naming it.

Examples:
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 32768 --tile 1024 --run 1 --validate
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 256 --tile 64 --platform cpu --validate
    python -m conflux_tpu_torch.cli.cholesky_miniapp --dim 4096 --tile 256 --dtype float64 --validate
"""

from __future__ import annotations

import argparse

from conflux_tpu_torch.cli.common import (
    WallTimer,
    add_common_args,
    add_experiment_type_arg,
    np_dtype,
    platform_device,
    print_route,
    result_line,
    sync,
)

# the JAX miniapp sends deeper factorizations to the distributed program
_SINGLE_MAX_KAPPA = 64

# flags of the distributed program: not ported yet, never silently ignored
_DISTRIBUTED_FLAGS = ("lookahead", "segs", "auto")


def parse_args(argv=None):
    p = argparse.ArgumentParser("cholesky_miniapp", description=__doc__)
    p.add_argument("--dim", type=int, default=2048, help="matrix dimension N")
    p.add_argument("--tile", type=int, default=None, help="tile size v (default: heuristic)")
    p.add_argument("--grid", default=None,
                   help="Px,Py,Pz (only 1,1,1: the distributed route is not "
                   "ported yet)")
    p.add_argument("--run", type=int, default=2, help="timed repetitions")
    p.add_argument("--validate", action="store_true", help="residual ||A-LL^T||_F check")
    p.add_argument(
        "--refine", type=int, default=None, metavar="K",
        help="after factoring, solve A x = 1 with K iterative-refinement "
        "sweeps (f64 residuals; pairs with --dtype bfloat16) and report the "
        "solve residual")
    p.add_argument("--lookahead", action="store_true", default=None,
                   help="distributed route only (not ported yet)")
    p.add_argument("--segs", default=None, metavar="RxC",
                   help="distributed route only (not ported yet)")
    p.add_argument("--auto", action="store_true", default=None,
                   help="distributed route only (not ported yet)")
    add_experiment_type_arg(p)
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.cholesky.single import cholesky_blocked
    from conflux_tpu_torch.geometry import (
        CholeskyGeometry,
        Grid3,
        choose_cholesky_grid,
        choose_cholesky_tile,
    )
    from conflux_tpu_torch.validation import cholesky_residual_device, make_spd_matrix

    for flag in _DISTRIBUTED_FLAGS:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} belongs to the distributed Cholesky route, "
                             "which conflux_tpu_torch has not ported yet")
    grid = Grid3.parse(args.grid) if args.grid else choose_cholesky_grid(1)
    if grid.P != 1:
        raise SystemExit(f"grid {grid}: the distributed Cholesky route is not "
                         "ported yet; conflux_tpu_torch runs on one device")
    if args.refine is not None and args.refine < 0:
        raise SystemExit("--refine needs a sweep count >= 0")
    v = args.tile or choose_cholesky_tile(args.dim, grid.P)
    geom = CholeskyGeometry.create(args.dim, v, grid)
    if geom.Kappa > _SINGLE_MAX_KAPPA:
        raise SystemExit(
            f"Kappa = {geom.Kappa} tile columns > {_SINGLE_MAX_KAPPA}: the JAX "
            "package runs these on the distributed program, which is not "
            "ported yet")
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

    # printTimings-style block (reference cholesky_miniapp.cpp:34-50)
    print("==========================================")
    print("    PROBLEM PARAMETERS:")
    print(f"    Matrix dimension: {geom.N} (requested {args.dim})")
    print(f"    Tile size: {geom.v}")
    print(f"    Grid: {grid} on {grid.P} devices")
    print(f"    Runs: {len(times)}")
    print("    TIMINGS [ms]:")
    for ms in times:
        print(f"       {ms:.3f}")
    print("==========================================")
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
