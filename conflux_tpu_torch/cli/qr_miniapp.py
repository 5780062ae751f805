"""QR miniapp — the port of `conflux_tpu.cli.qr_miniapp` (the third
factorization family's command line).

Same flags and the same machine-parsable lines as the JAX miniapp:

    _result_ <qr|qr-tsqr|qr-cholesky>,conflux_tpu_torch,<N>,<N_base>,<P>,<PxxPyxPz>,time,<type>,<ms>,<v>,<dtype>
    _residual_ orth=<||Q^H Q - I||_F / sqrt(n)> reconstruction=<||A - Q R||_F / ||A||_F>

Modes:
  - tall (default, `--cols` < rows): `--algo tsqr` (`qr.distributed.
    tsqr_distributed`, `--tree gather` or `butterfly`) or `--algo cholesky`
    (`cholesky_qr2_distributed`) on x-block rows, over x only: rows are
    zero-padded to a multiple of Px (zero rows leave R unchanged); the N
    field carries the padded row count, the tile field the column count;
  - `--full`: `qr.distributed.qr_factor_distributed` on the (Px, Py, Pz)
    grid at every grid, 1x1x1 included, as the JAX miniapp does (block
    Gram-Schmidt with the BCGS2 re-projection, its trailing GEMMs on K1 at
    float32 and bfloat16, the library product at float64), with
    `--block`, `--csegs` and `--lookahead`.

`--auto` resolves the knobs of the mode (the --full loop's block, csegs
and lookahead; the tall tsqr mode's tree; none for cholesky) from the
port's dispatch table, whose card rules start empty. The matrix is
standard normal, drawn on each rank's device from torch's generator
seeded 42 (the JAX miniapp draws numpy's; the two matrices differ); each
rank keeps its own shard. `--validate` is `validation.
qr_residual_distributed` for --full (gather-free, one SUMMA loop) and the
tall mode's sums over x (float64), both on the grid. A grid of several
ranks runs them as threads of this process (`--transport`), or one per
process under torchrun; rank 0 prints, after a `_grid_` line naming the
world.

Examples:
    python -m conflux_tpu_torch.cli.qr_miniapp -M 1048576 --cols 256 --validate
    python -m conflux_tpu_torch.cli.qr_miniapp -M 32768 --cols 32768 --full -b 1024 --validate
    python -m conflux_tpu_torch.cli.qr_miniapp --platform cpu -M 64 --cols 64 --full -b 8 \
        --p_grid 2,2,1 --validate
    python -m conflux_tpu_torch.cli.qr_miniapp --platform cpu -M 512 --cols 16 \
        --p_grid 4,1,1 --tree butterfly --validate
    torchrun --nproc_per_node 2 -m conflux_tpu_torch.cli.qr_miniapp --platform cpu \
        -M 256 --cols 256 --full -b 16 --p_grid 2,1,1 --dtype float64 --validate
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
    phase_profile,
    positive_int,
    resolve_knob_defaults,
    result_line,
    run_on_grid,
    sync,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("qr_miniapp", description=__doc__)
    p.add_argument("-M", type=int, default=8192, help="rows")
    p.add_argument("--cols", type=int, default=256, help="columns (<= rows)")
    p.add_argument("-b", "--block", type=int, default=None,
                   help="panel width v for --full (default 256)")
    p.add_argument("--p_grid", default=None,
                   help="Px,Py,Pz (default 1,1,1; tall mode takes Py = Pz = 1)")
    p.add_argument("--algo", default="tsqr", choices=["tsqr", "cholesky"],
                   help="tall-mode election (QR tree vs Gram/CholeskyQR2)")
    p.add_argument("--tree", default=None, choices=["gather", "butterfly"],
                   help="tsqr cross-x reduction (default gather): one all_gather, or the "
                   "log2(Px) ppermute hypercube (any Px; odd grids fold their overflow "
                   "ranks with two extra rounds)")
    p.add_argument("--full", action="store_true",
                   help="general block-cyclic QR on the (x, y, z) grid")
    p.add_argument("--lookahead", action="store_true", default=None,
                   help="--full only: the next panel's election from a separately "
                   "updated column slab before the rest of the trailing update "
                   "(bitwise the plain loop)")
    p.add_argument("--csegs", type=positive_int, default=None, metavar="C",
                   help="trailing-update column segment count for --full (default 8)")
    p.add_argument("-r", "--run", type=int, default=2, help="timed reps")
    p.add_argument("--validate", action="store_true",
                   help="orthogonality + reconstruction residuals")
    add_auto_arg(p)
    add_grid_args(p)
    add_experiment_type_arg(p)
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from conflux_tpu_torch.geometry import Grid3, LUGeometry

    if args.cols > args.M:
        raise SystemExit(f"--cols {args.cols} > rows {args.M}: QR needs M >= n")
    if args.tree not in (None, "gather") and (args.full or args.algo != "tsqr"):
        raise SystemExit("--tree applies to the tall tsqr mode only (the Gram and "
                         "block-cyclic paths have no cross-x R tree)")
    if args.lookahead and not args.full:
        raise SystemExit("--lookahead applies to the --full block-cyclic loop only "
                         "(the tall-skinny paths have no superstep loop to pipeline)")
    grid = Grid3.parse(args.p_grid) if args.p_grid else Grid3(1, 1, 1)

    # the auto-eligible knobs and their library defaults; --auto consults the
    # mode's subset (block, csegs and lookahead are read by the --full loop
    # only, the cross-x tree by the tall tsqr mode only)
    knob_map = {"block": ("v", None), "csegs": ("csegs", 8),
                "lookahead": ("lookahead", False), "tree": ("tree", "gather")}
    if args.full:
        mode_knobs = {k: knob_map[k] for k in ("block", "csegs", "lookahead")}
    elif args.algo == "tsqr":
        mode_knobs = {"tree": knob_map["tree"]}
    else:
        mode_knobs = {}
    if args.auto:
        apply_auto(args, "qr", args.M, grid.P, args.dtype, mode_knobs)
    resolve_knob_defaults(args, knob_map)

    if args.full:
        geom = LUGeometry.create(args.M, args.cols, args.block or 256, grid)
        if geom.M < geom.N:
            raise SystemExit(
                f"after grid padding the problem is {geom.M}x{geom.N} (requested "
                f"{args.M}x{args.cols}, tile {geom.v}, grid {grid}): QR needs M >= N; "
                "raise -M or shrink the y axis")
    else:
        if (grid.Py, grid.Pz) != (1, 1):
            raise SystemExit(f"tall mode distributes rows over 'x' only; grid {grid} "
                             "has Py/Pz > 1 (use --full for the 2.5D grid)")
        geom = None
    run_on_grid(grid, args, lambda mesh: _run(mesh, args, geom))
    if args.profile:
        from conflux_tpu_torch import profiler

        profiler.report()
    return 0


def _tall_residuals(A, Q, R, mesh) -> tuple[float, float]:
    """(reconstruction, orthogonality) of the tall factors on the grid:
    each rank's row block in float64 strips, the sums and the Gram matrix
    summed over x."""
    import numpy as np
    import torch

    n = R.shape[0]
    R64 = R.to(torch.float64)
    sums = torch.zeros(2, dtype=torch.float64, device=A.device)
    G = torch.zeros((n, n), dtype=torch.float64, device=A.device)
    for i in range(0, A.shape[0], 4096):
        Qi = Q[i:i + 4096].to(torch.float64)
        Ai = A[i:i + 4096].to(torch.float64)
        sums[0] += ((Ai - Qi @ R64) ** 2).sum()
        sums[1] += (Ai ** 2).sum()
        G += Qi.mT @ Qi
    mesh.psum(sums, "x")
    mesh.psum(G, "x")
    G -= torch.eye(n, dtype=torch.float64, device=A.device)
    rec = float(torch.sqrt(sums[0]) / torch.clamp(torch.sqrt(sums[1]), min=1e-30))
    return rec, float(torch.linalg.norm(G) / np.sqrt(n))


def _run(mesh, args, geom) -> None:
    """The miniapp on one rank of the grid (every rank runs it; rank 0
    prints)."""
    import contextlib

    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.qr.distributed import (
        cholesky_qr2_distributed,
        qr_factor_distributed,
        tsqr_distributed,
    )
    from conflux_tpu_torch.validation import qr_residual_distributed

    rank0 = mesh.rank == 0
    grid = mesh.grid
    dev = mesh.device
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device=dev).manual_seed(42)

    def region(name):
        return profiler.region(name) if rank0 else contextlib.nullcontext()

    with region("init_matrix"):
        if args.full:
            A = torch.randn((geom.M, geom.N), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            shard = geom.local_block(A, mesh.x, mesh.y).clone(
                memory_format=torch.contiguous_format)
            del A
            backend = "xla" if dtype == torch.float64 else "kernel"
            algo_name, N_rep, vrep = "qr", geom.N, geom.v

            def factor():
                return qr_factor_distributed(shard, geom, mesh, backend=backend,
                                             csegs=args.csegs, lookahead=args.lookahead)
        else:
            Px = grid.Px
            Ml = -(-args.M // Px)
            # rows pad with zeros to a multiple of Px (qr_distributed_host's
            # convention), so the factored problem is exactly the requested one
            A = torch.zeros((Px * Ml, args.cols), dtype=dtype, device=dev)
            A[:args.M] = torch.randn((args.M, args.cols), generator=gen, device=dev,
                                     dtype=torch.float32).to(dtype)
            shard = A[mesh.x * Ml:(mesh.x + 1) * Ml].clone()
            del A
            if rank0 and Px * Ml != args.M:
                print(f"rows padded {args.M} -> {Px * Ml} (zero rows)")
            algo_name, N_rep, vrep = f"qr-{args.algo}", Px * Ml, args.cols

            def factor():
                if args.algo == "tsqr":
                    return tsqr_distributed(shard, mesh, tree=args.tree)
                return cholesky_qr2_distributed(shard, mesh)
        sync(dev)

    times = []
    for rep in range(args.run + 1):  # rep 0 is the mandatory warm-up
        mesh.barrier()
        with WallTimer() as t:
            with region("qr_factorization"):
                Q, R = factor()
                sync(dev)
                mesh.barrier()
        if rep > 0:
            times.append(t.ms)
    if rank0:
        for ms in times:
            print(result_line(algo_name, N_rep, grid.P, grid, args.type, ms, vrep,
                              args.dtype))

    if args.validate:
        with region("validation"):
            if args.full:
                rec, orth = qr_residual_distributed(shard, Q, R, geom, mesh)
            else:
                rec, orth = _tall_residuals(shard, Q, R, mesh)
        if rank0:
            print(f"_residual_ orth={orth:.3e} reconstruction={rec:.3e}")
    if args.profile and args.full:
        # per-phase device table of the grid loop (its qr_* ranges), as the
        # LU and Cholesky miniapps print theirs
        from conflux_tpu_torch.qr.distributed import build_program

        phase_profile(build_program(geom, mesh, backend=backend, csegs=args.csegs,
                                    lookahead=args.lookahead, dtype=shard.dtype),
                      shard, mesh, profiler.QR_PHASE_RE)


if __name__ == "__main__":
    raise SystemExit(main())
