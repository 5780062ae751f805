"""LU miniapp on one device — the port of `conflux_tpu.cli.conflux_miniapp`
(the role of the reference's `examples/conflux_miniapp.cpp`).

Same CLI vocabulary and the same machine-parsable result protocol:

    _result_ lu,conflux_tpu_torch,<N>,<N_base>,<P>,<PxxPyxPz>,time,<type>,<ms>,<v>,<dtype>

plus --validate (||A[perm] - L U||_F / ||A||_F, computed on the device in
float64 strips) and --refine K (solve A x = 1 with K refinement sweeps).
Only the single-device route is ported: the flags of the distributed
program exit with a message naming it.

Examples:
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 32768 -b 1024 -r 1 --validate
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 256 -b 128 --platform cpu --validate
"""

from __future__ import annotations

import argparse

import numpy as np

from conflux_tpu_torch.cli.common import (
    WallTimer,
    add_common_args,
    add_experiment_type_arg,
    np_dtype,
    platform_device,
    result_line,
    sync,
)

# the JAX miniapp sends larger step counts to the distributed program
_SINGLE_MAX_STEPS = 64

# flags of the distributed program: not ported yet, never silently ignored
_DISTRIBUTED_FLAGS = ("lookahead", "election", "segs", "tree", "update", "auto")


def parse_args(argv=None):
    p = argparse.ArgumentParser("conflux_miniapp", description=__doc__)
    p.add_argument("-M", type=int, default=None, help="rows (default: N)")
    p.add_argument("-N", type=int, default=2048, help="matrix dimension")
    p.add_argument("-b", "--block_size", type=int, default=128, help="tile size v")
    p.add_argument("--p_grid", default=None,
                   help="Px,Py,Pz (only 1,1,1: the distributed route is not "
                   "ported yet)")
    p.add_argument("-r", "--n_rep", type=int, default=2, help="timed repetitions")
    p.add_argument(
        "-l", "--print_limit", type=int, default=30,
        help="print the input matrix and packed factors when max(M, N) is "
        "below this limit")
    p.add_argument("--validate", action="store_true", help="residual ||PA-LU||_F check")
    p.add_argument(
        "--refine", type=int, default=None, metavar="K",
        help="after factoring, solve A x = 1 with K iterative-refinement "
        "sweeps (f64 residuals) and report the solve residual")
    for flag in ("lookahead", "auto"):
        p.add_argument(f"--{flag}", action="store_true", default=None,
                       help="distributed route only (not ported yet)")
    for flag in ("election", "segs", "tree", "update"):
        p.add_argument(f"--{flag}", default=None,
                       help="distributed route only (not ported yet)")
    add_experiment_type_arg(p)
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.lu.single import from_numpy, lu_factor_blocked
    from conflux_tpu_torch.validation import lu_residual_device, make_test_matrix

    for flag in _DISTRIBUTED_FLAGS:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} belongs to the distributed LU route, "
                             "which conflux_tpu_torch has not ported yet")
    grid = Grid3.parse(args.p_grid) if args.p_grid else Grid3(1, 1, 1)
    if grid.P != 1:
        raise SystemExit(f"grid {grid}: the distributed LU route is not "
                         "ported yet; conflux_tpu_torch runs on one device")
    if args.dtype == "float64":
        raise SystemExit("--dtype float64 needs the library panel LU "
                         "(panel algo 'partial'), which is not ported yet")
    device = platform_device(args)

    M = args.M or args.N
    geom = LUGeometry.create(M, args.N, args.block_size, grid)
    if geom.n_steps > _SINGLE_MAX_STEPS:
        raise SystemExit(
            f"{geom.n_steps} supersteps > {_SINGLE_MAX_STEPS}: the JAX "
            "package runs these on the distributed program, which is not "
            "ported yet")
    if args.refine is not None:
        if args.refine < 0:
            raise SystemExit("--refine needs a sweep count >= 0")
        if geom.M != geom.N:
            raise SystemExit("--refine needs a square system")

    dtype = np_dtype(args.dtype)
    with profiler.region("init_matrix"):
        A = make_test_matrix(geom.M, geom.N, dtype=dtype)
        A_dev = from_numpy(A, device)
        dev = A_dev.to(torch.bfloat16) if args.dtype == "bfloat16" else A_dev
        sync(device)

    times = []
    for rep in range(args.n_rep + 1):  # rep 0 is the mandatory warm-up
        with WallTimer() as t:
            with profiler.region("lu_factorization"):
                out, perm_dev = lu_factor_blocked(dev, v=geom.v)
                sync(device)
        if rep > 0:
            times.append(t.ms)

    for ms in times:
        print(result_line("lu", geom.N, grid.P, grid, args.type, ms, geom.v,
                          args.dtype))

    if max(geom.M, geom.N) < args.print_limit:
        np.set_printoptions(precision=4, suppress=True, linewidth=200)
        print("input matrix:")
        print(A)
        print("packed LU factors (pivoted row order):")
        print(out.float().cpu().numpy())
        print("perm:", perm_dev.cpu().tolist())

    if args.validate:
        with profiler.region("validation"):
            res = lu_residual_device(A_dev, out, perm_dev)
        print(f"_residual_ {res:.3e}")

    if args.refine is not None:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.cli.common import refine_report

        with profiler.region("refine_solve"):
            refine_report(lambda r: solvers.lu_solve(out, perm_dev, r),
                          A_dev, out.dtype, args.refine)

    if args.profile:
        profiler.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
