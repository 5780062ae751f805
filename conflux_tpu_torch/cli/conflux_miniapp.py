"""LU miniapp on one device — the port of `conflux_tpu.cli.conflux_miniapp`
(the role of the reference's `examples/conflux_miniapp.cpp`).

Same CLI vocabulary and the same machine-parsable result protocol:

    _result_ lu,conflux_tpu_torch,<N>,<N_base>,<P>,<PxxPyxPz>,time,<type>,<ms>,<v>,<dtype>

plus --validate (||A[perm] - L U||_F / ||A||_F, computed on the device in
float64 strips) and --refine K (solve A x = 1 with K refinement sweeps).
A `_route_ backend=... panel_algo=... (<dtype>)` line names the route
before the result lines: float32 and bfloat16 run the kernels, float64
the JAX package's default library route (backend "xla", panel algo
"auto").

A grid of more than one rank (`--p_grid`), and more than 64 supersteps on
1x1x1, run the distributed program (`lu.distributed`) as the JAX miniapp
does, with `--lookahead`, `--election`, `--segs`, `--tree`, `--update` and
`--auto`; `--validate` is then the gather-free grid residual and
`--refine` the grid solve. Under torchrun every rank runs the miniapp and
rank 0 prints; in one process the ranks are threads (`--transport`).

Examples:
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 32768 -b 1024 -r 1 --validate
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 256 -b 128 --platform cpu --validate
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 2048 -b 128 --dtype float64 --validate --refine 2
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 32768 -b 256 --p_grid 1,1,1 --validate
    python -m conflux_tpu_torch.cli.conflux_miniapp -N 256 -b 16 --p_grid 2,2,1 --platform cpu \
        --dtype float64 --validate --refine 2
    torchrun --nproc_per_node 2 -m conflux_tpu_torch.cli.conflux_miniapp -N 512 -b 16 \
        --p_grid 2,1,1 --platform cpu --dtype float64 --validate
"""

from __future__ import annotations

import argparse

import numpy as np

from conflux_tpu_torch.cli.common import (
    WallTimer,
    add_auto_arg,
    add_common_args,
    add_experiment_type_arg,
    add_grid_args,
    apply_auto,
    np_dtype,
    platform_device,
    print_route,
    resolve_knob_defaults,
    result_line,
    run_on_grid,
    segs_arg,
    sync,
)

# the JAX miniapp sends larger step counts to the distributed program
_SINGLE_MAX_STEPS = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser("conflux_miniapp", description=__doc__)
    p.add_argument("-M", type=int, default=None, help="rows (default: N)")
    p.add_argument("-N", type=int, default=2048, help="matrix dimension")
    p.add_argument("-b", "--block_size", type=int, default=None,
                   help="tile size v (default 128; un-passed = auto-eligible under --auto)")
    p.add_argument("--p_grid", default=None,
                   help="Px,Py,Pz (default 1,1,1: one rank; several ranks run the "
                   "distributed program)")
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
    p.add_argument("--lookahead", action="store_true", default=None,
                   help="software-pipelined loop: the next step's panel and pivot "
                   "election before the rest of the trailing update")
    p.add_argument("--election", default=None, choices=["gather", "butterfly"],
                   help="cross-x pivot election (default gather): one all_gather "
                   "tournament, or the reference's log2(Px) ppermute hypercube")
    p.add_argument("--segs", default=None, metavar="RxC", type=segs_arg,
                   help="trailing-update row x col segment counts, e.g. 16x16")
    p.add_argument("--tree", default=None, choices=["pairwise", "flat"],
                   help="pivot election reduction (default pairwise)")
    p.add_argument("--update", default=None, choices=["segments", "block"],
                   help="trailing-update partitioning (default segments)")
    add_auto_arg(p)
    add_grid_args(p)
    add_experiment_type_arg(p)
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from conflux_tpu_torch.geometry import Grid3, LUGeometry

    grid = Grid3.parse(args.p_grid) if args.p_grid else Grid3(1, 1, 1)
    M = args.M or args.N
    # auto-eligible knobs: None = un-passed (an explicit flag always pins)
    knob_map = {
        "block_size": ("v", 128),
        "election": ("election", "gather"),
        "segs": ("segs", (16, 16)),
        "tree": ("tree", "pairwise"),
        "update": ("update", "segments"),
        "lookahead": ("lookahead", False),
    }
    if args.auto:
        apply_auto(args, "lu", args.N, grid.P, args.dtype, knob_map)
    resolve_knob_defaults(args, knob_map)
    geom = LUGeometry.create(M, args.N, args.block_size, grid)
    if args.refine is not None:
        if args.refine < 0:
            raise SystemExit("--refine needs a sweep count >= 0")
        if geom.M != geom.N:
            raise SystemExit("--refine needs a square system")
    # the dedicated single-device path up to 64 supersteps, as the JAX
    # miniapp; beyond, and on any grid of several ranks, the distributed
    # program
    if grid.P == 1 and geom.n_steps <= _SINGLE_MAX_STEPS:
        return _single(args, geom, grid)
    route = print_route(args.dtype)
    run_on_grid(grid, args, lambda mesh: _distributed(mesh, args, geom, route))
    if args.profile:
        from conflux_tpu_torch import profiler

        profiler.report()
    return 0


def _distributed(mesh, args, geom, route) -> None:
    """The miniapp on one rank of the grid (every rank runs it; rank 0
    prints)."""
    import contextlib

    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.lu.single import from_numpy
    from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards
    from conflux_tpu_torch.validation import lu_residual_distributed, make_test_matrix

    backend, panel_algo = route
    rank0 = mesh.rank == 0
    grid = geom.grid

    def region(name):
        return profiler.region(name) if rank0 else contextlib.nullcontext()

    dtype = np_dtype(args.dtype)
    with region("init_matrix"):
        A = make_test_matrix(geom.M, geom.N, dtype=dtype)
        shard = distribute_shards(lambda px, py: geom.local_block(A, px, py), mesh,
                                  shape=(grid.Px, grid.Py, geom.Ml, geom.Nl), dtype=dtype)
        if args.dtype == "bfloat16":
            shard = shard.to(torch.bfloat16)
        sync(mesh.device)
    times = []
    for rep in range(args.n_rep + 1):  # rep 0 is the mandatory warm-up
        mesh.barrier()
        with WallTimer() as t:
            with region("lu_factorization"):
                out, perm = lu_factor_distributed(
                    shard, geom, mesh, backend=backend, panel_algo=panel_algo,
                    lookahead=args.lookahead, election=args.election, segs=args.segs,
                    tree=args.tree, update=args.update)
                sync(mesh.device)
                mesh.barrier()
        if rep > 0:
            times.append(t.ms)
    if rank0:
        for ms in times:
            print(result_line("lu", geom.N, grid.P, grid, args.type, ms, geom.v, args.dtype))
    if max(geom.M, geom.N) < args.print_limit:
        full = gather_shards(out, mesh)
        if rank0:
            np.set_printoptions(precision=4, suppress=True, linewidth=200)
            print("input matrix:")
            print(A)
            print("packed LU factors (pivoted row order):")
            print(geom.gather(full.float().cpu().numpy()))
            print("perm:", perm.cpu().tolist())
    if args.validate:
        with region("validation"):
            # gather-free grid oracle: `shard` still holds the original
            # (the timed runs do not donate it)
            res = lu_residual_distributed(shard, out, perm, geom, mesh)
        if rank0:
            print(f"_residual_ {res:.3e}")
    if args.refine is not None:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.cli.common import refine_report

        with region("refine_solve"):
            refine_report(lambda r: solvers.lu_solve_distributed(out, perm, geom, mesh, r),
                          from_numpy(A, mesh.device), out.dtype, args.refine, emit=rank0)


def _single(args, geom, grid) -> int:
    """The dedicated single-device route (`lu.single`; the distributed
    program's knobs do not apply to it, as in the JAX miniapp)."""
    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.lu.single import from_numpy, lu_factor_blocked
    from conflux_tpu_torch.validation import lu_residual_device, make_test_matrix

    device = platform_device(args)
    dtype = np_dtype(args.dtype)
    with profiler.region("init_matrix"):
        A = make_test_matrix(geom.M, geom.N, dtype=dtype)
        A_dev = from_numpy(A, device)
        dev = A_dev.to(torch.bfloat16) if args.dtype == "bfloat16" else A_dev
        sync(device)

    backend, panel_algo = print_route(args.dtype)
    times = []
    for rep in range(args.n_rep + 1):  # rep 0 is the mandatory warm-up
        with WallTimer() as t:
            with profiler.region("lu_factorization"):
                out, perm_dev = lu_factor_blocked(dev, v=geom.v, backend=backend,
                                                  panel_algo=panel_algo)
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
