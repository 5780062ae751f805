"""Accuracy demonstration at bench scale on the card, the BASELINE.md
acceptance bar: the port's counterpart of `scripts/accuracy_demo.py`.

Runs the at-scale solve path on a 1x1x1 grid: the float32 (or bfloat16)
factorization `lu.distributed.lu_factor_distributed` of a donated copy of
A (its `LUGeometry.local_block`), the grid solve
`solvers.lu_solve_distributed`, then classic iterative refinement with
float64 residuals taken one row strip at a time (no (N, N) float64 copy
of A) and float32 corrections through the same factors (the HPL-MxP
recipe). Prints the
relative residual ||A x - b|| / ||b|| at each requested depth; each depth
is the solve `solvers.solve_distributed(refine=k)` returns, without
factoring again per depth.

Acceptance: N >= 16384 solved to a relative residual <= 1e-6 with float32
factors. bfloat16 factors print the same lines with no bar of their own.

    python scripts/torch_accuracy_demo.py --dim 16384 --tile 1024 --refine 0 2 4
    python scripts/torch_accuracy_demo.py --dim 256 --tile 128 --platform cpu

A is randn + 2 I in float32 from a `torch.Generator` seeded 0, drawn on
the device it runs on: the draws are torch's, not the JAX package's. Runs
on the card; `--platform cpu` runs the kernels' plain versions on the CPU.
The exit status is 0 once every depth printed (the bar is printed, as the
reference prints it).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

BAR = 1e-6
STRIP = 4096  # rows of A cast to float64 at a time by `residual`


def make_matrix(N: int, device, seed: int = 0) -> torch.Tensor:
    """randn(N, N) + 2 I in float32, drawn on `device` from a generator
    seeded `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((N, N), generator=gen, device=device, dtype=torch.float32)
    A.diagonal().add_(2.0)
    return A


def residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b - A x in float64, casting A one row strip of STRIP rows at a time."""
    x, b = x.to(torch.float64), b.to(torch.float64)
    return torch.cat([b[i:i + STRIP] - A[i:i + STRIP].to(torch.float64) @ x
                      for i in range(0, A.shape[0], STRIP)])


def accuracy_sweeps(A: torch.Tensor, b: torch.Tensor, v: int, depths, factor_dtype=None,
                    device=None) -> dict:
    """Factor A once on a 1x1x1 grid with tile `v` in `factor_dtype`
    (default A's dtype), solve, and refine incrementally up to the deepest
    of `depths`, taking the float64 relative residual at each requested
    depth. A is read again by every residual, so the factorization works
    on a copy of its block and A stays as given. `device`
    (default: the card) is the mesh's.

    Returns {"perm": (N,) int64 on the CPU, "x": {depth: (N,) float64},
    "rel": {depth: float}, "seconds": {depth: s since the factorization
    started}}."""
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.parallel.mesh import make_mesh
    from conflux_tpu_torch.solvers import lu_solve_distributed

    N = A.shape[0]
    grid = Grid3(1, 1, 1)
    geom = LUGeometry.create(N, N, v, grid)
    if (geom.M, geom.N) != (N, N):
        raise ValueError(f"N={N} must be a multiple of the tile {v}")
    mesh = make_mesh(grid, device=device)
    A = A.to(mesh.device)
    b = b.to(mesh.device)
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    depths = sorted(set(int(d) for d in depths))
    out = {"x": {}, "rel": {}, "seconds": {}}
    t0 = time.perf_counter()
    shard = torch.empty((geom.Ml, geom.Nl), dtype=fdtype, device=mesh.device)
    shard.copy_(geom.local_block(A, mesh.x, mesh.y))  # the factorization takes it
    LU, perm = lu_factor_distributed(shard, geom, mesh, donate=True)
    del shard
    x = lu_solve_distributed(LU, perm, geom, mesh, b).to(torch.float64)
    nb = torch.linalg.norm(b.to(torch.float64))
    for sweep in range(depths[-1] + 1):
        r = residual(A, x, b)
        if sweep in depths:
            out["rel"][sweep] = float(torch.linalg.norm(r) / nb)
            out["x"][sweep] = x.cpu()
            out["seconds"][sweep] = time.perf_counter() - t0
        if sweep < depths[-1]:
            corr = lu_solve_distributed(LU, perm, geom, mesh, r.to(torch.float32))
            x = x + corr.to(torch.float64)
    out["perm"] = perm.cpu()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_accuracy_demo", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dim", type=int, default=16384)
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--refine", type=int, nargs="+", default=[0, 2, 4])
    p.add_argument("--factor_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="run the kernels' plain versions on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.platform is None and not torch.cuda.is_available():
        raise RuntimeError("torch_accuracy_demo: no card (pass --platform cpu for the "
                           "plain versions on the CPU)")
    device = "cpu" if args.platform == "cpu" else "cuda"
    N = args.dim
    A = make_matrix(N, device)
    b = torch.ones(N, dtype=torch.float32, device=device)
    fname = args.factor_dtype
    res = accuracy_sweeps(A, b, args.tile, args.refine, getattr(torch, fname), device)
    for depth, rel in res["rel"].items():
        flag = "PASS" if rel <= BAR else "----"
        print(f"_accuracy_ N={N} v={args.tile} factors={fname} refine={depth} "
              f"rel_residual={rel:.3e} [{flag} <=1e-6] ({res['seconds'][depth]:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
