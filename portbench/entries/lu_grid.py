"""The port's grid LU (CONFLUX) through its public entry points. A fresh
system is `solvers.solve_distributed(A, b, grid, v, refine, precision)`:
the shard's scatter, `lu.distributed.lu_factor_distributed` (tournament
pivoting on the grid), the grid triangular solves and the classic sweeps
with float64 residuals, all in the one call a user makes. Solves against a
factor made once (`.resolve`) are `lu_factor_distributed` in set-up, then
`solvers.lu_solve_distributed` inside `solvers.refine_classic` per system.

The check judges the factor as well as the answer. `solve_distributed`
keeps its factor to itself, so while it runs, the module attribute
`lu_factor_distributed` that it calls is wrapped by one that keeps a
reference to what the real function returned (no copy, no other work).
Every knob the configuration does not state is left at the port's
default.
"""

from __future__ import annotations

import torch

from portbench import roofline


class Entry:
    def __init__(self, cfg: dict, device, knobs: dict | None = None):
        from conflux_tpu_torch.geometry import Grid3, LUGeometry
        from conflux_tpu_torch.parallel.mesh import make_mesh

        self.cfg, self.device = cfg, torch.device(device)
        self.knobs = {"precision": cfg["precision"], **(knobs or {})}
        self.grid = Grid3(*cfg["grid"])
        self.geom = LUGeometry.create(cfg["N"], cfg["N"], cfg["v"], self.grid)
        self.mesh = make_mesh(self.grid, device=self.device)
        self.factor_out = None  # the last factor the program made, (shard, perm)

    def factor_solve(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.lu import distributed as lu_dist

        real = lu_dist.lu_factor_distributed

        def keeping(*a, **k):
            self.factor_out = real(*a, **k)
            return self.factor_out

        self.factor_out = None
        lu_dist.lu_factor_distributed = keeping
        try:
            return solvers.solve_distributed(A, B, grid=self.grid, v=self.cfg["v"],
                                             mesh=self.mesh, refine=self.cfg["sweeps"],
                                             **self.knobs)
        finally:
            lu_dist.lu_factor_distributed = real

    def factor(self, A: torch.Tensor) -> None:
        from conflux_tpu_torch.lu.distributed import lu_factor_distributed

        self.factor_out = None
        shard = self.geom.local_block(A, self.mesh.x, self.mesh.y).clone(
            memory_format=torch.contiguous_format)
        self.factor_out = lu_factor_distributed(shard, self.geom, self.mesh, donate=True,
                                                **self.knobs)

    def solve(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.ops import blas

        out, perm = self.factor_out
        return solvers.refine_classic(
            lambda r: solvers.lu_solve_distributed(out, perm, self.geom, self.mesh, r),
            A, B, self.cfg["sweeps"], torch.float64, blas.compute_dtype(out.dtype))

    def release(self) -> None:
        self.factor_out = None

    def system_flops(self, refactor: bool, nrhs: int) -> float:
        """The work one system needs: the factorization where it is fresh,
        the sweeps' solves and residuals (one more residual closes the
        loop) for its right-hand sides."""
        N, s = self.cfg["N"], self.cfg["sweeps"]
        flops = roofline.solve_flops(N, nrhs, s + 1, s + 1 if s else 0)
        return flops + (roofline.lu_factor_flops(N) if refactor else 0.0)
