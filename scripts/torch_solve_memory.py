"""Peak device memory and wall time of `solvers.solve_distributed`, the
grid factor + solve + refinement, on the card.

For each N of `--dim` and each grid of `--grid`: A = randn + 2 I in
float32 (a `torch.Generator` seeded 0, drawn on the device), b = 1, then
`solve_distributed(A, b, grid=..., v=--tile, refine=--refine)` on a world
of grid.P ranks: the call alone on a 1x1x1 grid, threads sharing the card
over the "staged" transport on a larger one (`parallel.mesh.run_threaded`).
Prints one JSON line each:

  {"N", "grid", "v", "refine", "seconds" (the call's wall time, the
   factorization included), "peak_over_inputs_bytes" (the card's peak
   allocation during the call less what A and b held before it; every
   rank's, since they share the card), "factor_bytes" (all ranks' shards
   together: N^2 elements of A's dtype), "rel_residual" (||A x - b|| /
   ||b|| in float64)}

    python scripts/torch_solve_memory.py --dim 16384 32768 --grid 1 1 1 --grid 2 1 1
    python scripts/torch_solve_memory.py --dim 256 --tile 64 --platform cpu

Runs on the card; `--platform cpu` runs the kernels' plain versions on the
CPU, where no peak is read (null).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def measure(N: int, grid: tuple, v: int, refine: int, device: str) -> dict:
    """One solve_distributed run of N on `grid` (Px, Py, Pz); see the
    module docstring for the keys."""
    from conflux_tpu_torch import solvers
    from conflux_tpu_torch.geometry import Grid3
    from conflux_tpu_torch.parallel.mesh import run_threaded

    gen = torch.Generator(device=device).manual_seed(0)
    A = torch.randn((N, N), generator=gen, device=device, dtype=torch.float32)
    A.diagonal().add_(2.0)
    b = torch.ones(N, device=device)
    g = Grid3(*grid)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if g.P == 1:
        x = solvers.solve_distributed(A, b, grid=g, v=v, refine=refine, device=device)
    else:
        x = run_threaded(g, lambda mesh: solvers.solve_distributed(
            A, b, grid=g, v=v, mesh=mesh, refine=refine),
            device=device, transport="staged" if cuda else None, timeout=1800.0)[0]
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    r = b.double() - torch.cat([A[i:i + 4096].double() @ x.double()
                                for i in range(0, N, 4096)])
    return {"N": N, "grid": list(grid), "v": v, "refine": refine, "seconds": seconds,
            "peak_over_inputs_bytes": peak, "factor_bytes": N * N * A.element_size(),
            "rel_residual": float(torch.linalg.norm(r) / torch.linalg.norm(b.double()))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_solve_memory", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dim", type=int, nargs="+", default=[16384, 32768])
    p.add_argument("--grid", type=int, nargs=3, action="append", metavar=("PX", "PY", "PZ"),
                   help="a grid to run on (repeatable; default 1 1 1)")
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--refine", type=int, default=4)
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="run the kernels' plain versions on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.platform is None and not torch.cuda.is_available():
        raise RuntimeError("torch_solve_memory: no card (pass --platform cpu for the "
                           "plain versions on the CPU)")
    device = "cpu" if args.platform == "cpu" else "cuda"
    for N in args.dim:
        for grid in args.grid or [(1, 1, 1)]:
            print(json.dumps(measure(N, tuple(grid), args.tile, args.refine, device)),
                  flush=True)
            if device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
