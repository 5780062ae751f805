"""QR miniapp on one device — the port of the 1x1x1 routes of
`conflux_tpu.cli.qr_miniapp` (the third factorization family's driver).

Same flags and the same machine-parsable lines as the JAX miniapp:

    _result_ <qr|qr-tsqr|qr-cholesky>,conflux_tpu_torch,<N>,<N_base>,1,1x1x1,time,<type>,<ms>,<v>,<dtype>
    _residual_ orth=<||Q^H Q - I||_F / sqrt(n)> reconstruction=<||A - Q R||_F / ||A||_F>

Modes:
  - tall (default, `--cols` < rows): `--algo tsqr` (`qr.single.tall_qr`,
    the JAX tall TSQR's arithmetic at Px=1: the chunked tree and two
    passes, with no cross-x step) or `--algo cholesky`
    (`qr.single.cholesky_qr2`); the N field carries the row count, the
    tile field the column count, as in the JAX miniapp;
  - `--full`: `qr.single.qr_factor_blocked(v=--block, reproject=True)` on
    grid 1x1x1: block Gram-Schmidt with each panel re-orthogonalized once,
    the role of the re-projection in the JAX miniapp's `--full` loop
    (`qr_factor_distributed`, BCGS2), without which a float32 Gaussian
    matrix misses the orthogonality bar from N ~ 1024 on.

The matrix is standard normal, drawn on the device from torch's generator
seeded 42 (the JAX miniapp draws numpy's; the two matrices differ).
`--validate` computes both residuals on the device in float64 strips
(`validation.qr_residual_device`). Every other grid, `--tree butterfly`,
`--lookahead`, `--csegs` and `--auto` belong to the distributed route,
which is not ported yet: they exit naming it.

Examples:
    python -m conflux_tpu_torch.cli.qr_miniapp -M 1048576 --cols 256 --validate
    python -m conflux_tpu_torch.cli.qr_miniapp -M 32768 --cols 32768 --full -b 1024 --validate
    python -m conflux_tpu_torch.cli.qr_miniapp --platform cpu -M 512 --cols 64 \
        --algo cholesky --validate
"""

from __future__ import annotations

import argparse

from conflux_tpu_torch.cli.common import (
    WallTimer,
    add_common_args,
    add_experiment_type_arg,
    platform_device,
    result_line,
    sync,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("qr_miniapp", description=__doc__)
    p.add_argument("-M", type=int, default=8192, help="rows")
    p.add_argument("--cols", type=int, default=256, help="columns (<= rows)")
    p.add_argument("-b", "--block", type=int, default=None,
                   help="panel width v for --full (default 256)")
    p.add_argument("--p_grid", default=None,
                   help="Px,Py,Pz (only 1,1,1: the distributed route is not ported yet)")
    p.add_argument("--algo", default="tsqr", choices=["tsqr", "cholesky"],
                   help="tall-mode election (QR tree vs Gram/CholeskyQR2)")
    p.add_argument("--tree", default=None, choices=["gather", "butterfly"],
                   help="tsqr cross-x reduction; at Px=1 there is none ('gather' is "
                   "accepted, 'butterfly' is the distributed route's)")
    p.add_argument("--full", action="store_true",
                   help="general blocked QR (grid 1x1x1)")
    p.add_argument("--lookahead", action="store_true", default=None,
                   help="distributed route only (not ported yet)")
    p.add_argument("--csegs", type=int, default=None, metavar="C",
                   help="distributed route only (not ported yet)")
    p.add_argument("--auto", action="store_true", default=None,
                   help="distributed route only (not ported yet)")
    p.add_argument("-r", "--run", type=int, default=2, help="timed reps")
    p.add_argument("--validate", action="store_true",
                   help="orthogonality + reconstruction residuals")
    add_experiment_type_arg(p)
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.qr.single import cholesky_qr2, qr_factor_blocked, tall_qr
    from conflux_tpu_torch.validation import qr_residual_device

    if args.cols > args.M:
        raise SystemExit(f"--cols {args.cols} > rows {args.M}: QR needs M >= n")
    if args.tree not in (None, "gather") and (args.full or args.algo != "tsqr"):
        raise SystemExit("--tree applies to the tall tsqr mode only (the Gram and "
                         "block-cyclic paths have no cross-x R tree)")
    if args.lookahead and not args.full:
        raise SystemExit("--lookahead applies to the --full block-cyclic loop only "
                         "(the tall-skinny paths have no superstep loop to pipeline)")
    unported = [f for f, on in (("--tree butterfly", args.tree == "butterfly"),
                                ("--lookahead", args.lookahead),
                                ("--csegs", args.csegs is not None),
                                ("--auto", args.auto)) if on]
    if unported:
        raise SystemExit(f"{unported[0]} belongs to the distributed QR route, which "
                         "conflux_tpu_torch has not ported yet")
    grid = Grid3.parse(args.p_grid) if args.p_grid else Grid3(1, 1, 1)
    if grid.P != 1:
        raise SystemExit(f"grid {grid}: the distributed QR route is not ported yet; "
                         "conflux_tpu_torch runs on one device")
    device = platform_device(args)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device=device).manual_seed(42)

    if args.full:
        v = args.block or 256
        geom = LUGeometry.create(args.M, args.cols, v, grid)
        M, N = geom.M, geom.N
        algo_name, N_rep, vrep = "qr", N, v

        def factor(A):
            return qr_factor_blocked(A, v=v, reproject=True)
    else:
        M, N = args.M, args.cols
        algo_name, N_rep, vrep = f"qr-{args.algo}", M, N

        def factor(A):
            if args.algo == "tsqr":
                return tall_qr(A)
            return cholesky_qr2(A)

    with profiler.region("init_matrix"):
        A = torch.randn((M, N), generator=gen, device=device,
                        dtype=torch.float32).to(dtype)
        sync(device)

    times = []
    for rep in range(args.run + 1):  # rep 0 is the mandatory warm-up
        with WallTimer() as t:
            with profiler.region("qr_factorization"):
                Q, R = factor(A)
                sync(device)
        if rep > 0:
            times.append(t.ms)

    for ms in times:
        print(result_line(algo_name, N_rep, grid.P, grid, args.type, ms, vrep, args.dtype))

    if args.validate:
        with profiler.region("validation"):
            rec, orth = qr_residual_device(A, Q, R)
        print(f"_residual_ orth={orth:.3e} reconstruction={rec:.3e}")

    if args.profile:
        profiler.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
