"""Offline SPD matrix generator / result comparator (the port of
`conflux_tpu.cli.cholesky_helper`: the role of the reference's
`examples/cholesky_helper.cpp` and `python/compare_res.py`).

Subcommands:
    generate  write input_N.bin (SPD, deterministic) and optionally
              result_N.bin (its lower Cholesky factor, host LAPACK)
    compare   relative Frobenius distance between two matrix files
    factor    read an input file, factor it with the port (on the card, or
              the CPU with --platform cpu), write the lower factor

Files are the JAX package's binary format (`conflux_tpu_torch.io`, byte for
byte its writer's): int64 header (M, N, dtype code) + row-major data.
Reading also accepts the reference helper's raw headerless dumps
(dim*dim float64, detected by exact file size).

Examples:
    python -m conflux_tpu_torch.cli.cholesky_helper generate --dim 4096 \\
        --out /tmp/input_4096.bin --result /tmp/result_4096.bin
    python -m conflux_tpu_torch.cli.cholesky_helper factor /tmp/input_4096.bin \\
        /tmp/mine_4096.bin --tile 256
    python -m conflux_tpu_torch.cli.cholesky_helper compare /tmp/mine_4096.bin \\
        /tmp/result_4096.bin --tol 1e-5
"""

from __future__ import annotations

import argparse

import numpy as np

from conflux_tpu_torch.cli.common import add_common_args, add_grid_args, np_dtype
from conflux_tpu_torch.io import load_matrix_auto, save_matrix


def parse_args(argv=None):
    p = argparse.ArgumentParser("cholesky_helper", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a deterministic SPD input file")
    g.add_argument("--dim", type=int, required=True)
    g.add_argument("--seed", type=int, default=7)
    g.add_argument("--out", required=True, help="input matrix path")
    g.add_argument("--result", default=None,
                   help="also write the reference lower factor here (host LAPACK)")
    g.add_argument("--stream", action="store_true",
                   help="tile-strip streaming writer: the matrix never exists in "
                   "memory (very large N; the tile-replicated SPD construction, "
                   "incompatible with --result)")
    g.add_argument("--tile", type=int, default=256, help="strip height for --stream")
    add_common_args(g)

    c = sub.add_parser("compare", help="relative Frobenius distance of two files")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--tol", type=float, default=None,
                   help="exit 1 if the distance exceeds this")
    c.add_argument("--lower", action="store_true",
                   help="compare only the lower triangles (factor files)")

    f = sub.add_parser("factor", help="factor an input file with the port")
    f.add_argument("infile")
    f.add_argument("outfile")
    f.add_argument("--tile", type=int, default=None)
    f.add_argument("--grid", default=None, help="Px,Py,Pz (default 1,1,1)")
    add_common_args(f)
    add_grid_args(f)
    return p.parse_args(argv)


def _generate(args) -> int:
    from conflux_tpu_torch.validation import make_spd_matrix

    dtype = np_dtype(args.dtype)
    if args.stream:
        if args.result:
            raise SystemExit("--stream cannot also write --result "
                             "(the factor would need the full matrix)")
        from conflux_tpu_torch.io import generate_spd_file

        generate_spd_file(args.out, args.dim, v=args.tile, seed=args.seed, dtype=dtype)
        print(f"wrote {args.out}: SPD {args.dim}x{args.dim} {np.dtype(dtype).name} (streamed)")
        return 0
    A = make_spd_matrix(args.dim, seed=args.seed, dtype=dtype).numpy()
    save_matrix(args.out, A)
    print(f"wrote {args.out}: SPD {args.dim}x{args.dim} {np.dtype(dtype).name}")
    if args.result:
        import scipy.linalg

        L = scipy.linalg.cholesky(A.astype(np.float64), lower=True)
        save_matrix(args.result, L.astype(dtype))
        print(f"wrote {args.result}: reference lower factor")
    return 0


def _compare(args) -> int:
    A = load_matrix_auto(args.a).astype(np.float64)
    B = load_matrix_auto(args.b).astype(np.float64)
    if A.shape != B.shape:
        print(f"shape mismatch: {A.shape} vs {B.shape}")
        return 1
    if args.lower:
        A, B = np.tril(A), np.tril(B)
    dist = float(np.linalg.norm(A - B) / max(np.linalg.norm(B), 1e-30))
    print(f"_compare_ {args.a},{args.b},{dist:.6e}")
    if args.tol is not None and dist > args.tol:
        print(f"FAIL: {dist:.3e} > tol {args.tol:.3e}")
        return 1
    return 0


def _factor(args) -> int:
    from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
    from conflux_tpu_torch.cli.common import platform_device, print_route, run_on_grid
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, choose_cholesky_tile
    from conflux_tpu_torch.lu.single import from_numpy
    from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards

    A = load_matrix_auto(args.infile)
    N = A.shape[0]
    grid = Grid3.parse(args.grid) if args.grid else Grid3(1, 1, 1)
    v = args.tile or choose_cholesky_tile(N, grid.P)
    geom = CholeskyGeometry.create(N, v, grid)
    backend, _ = print_route(args.dtype)
    if args.dtype == "bfloat16":
        raise SystemExit("factor writes float32 or float64 files: --dtype bfloat16 "
                         "has no file format")
    A = A.astype(np_dtype(args.dtype))
    if grid.P == 1 and geom.N == N and geom.Kappa <= 64:
        from conflux_tpu_torch.cholesky.single import cholesky_blocked

        L = cholesky_blocked(from_numpy(A, platform_device(args)), v=geom.v,
                             backend=backend).cpu().numpy()
    else:
        if geom.N != N:  # identity-padded, as the distributed host path pads
            Ap = np.eye(geom.N, dtype=A.dtype)
            Ap[:N, :N] = A
            A = Ap

        def body(mesh):
            shard = distribute_shards(geom.scatter(A), mesh)
            out = cholesky_factor_distributed(shard, geom, mesh, backend=backend,
                                              donate=True)
            return gather_shards(out, mesh).cpu().numpy()

        L = np.tril(geom.gather(run_on_grid(grid, args, body)))[:N, :N]
    save_matrix(args.outfile, L.astype(np_dtype(args.dtype)))
    print(f"wrote {args.outfile}: lower factor of {args.infile} (grid {grid}, tile {geom.v})")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return {"generate": _generate, "compare": _compare, "factor": _factor}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
