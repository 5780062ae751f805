"""The port's grid Cholesky (CONFCHOX) through its public entry points,
composed as the Cholesky miniapp composes them: this rank's block of A,
`cholesky.distributed.cholesky_factor_distributed`, then
`solvers.cholesky_solve_distributed` inside `solvers.refine_classic`
(no sweep when the configuration states none: one grid solve). Every knob
the configuration does not state is left at the port's default.
"""

from __future__ import annotations

import torch

from portbench import roofline


class Entry:
    def __init__(self, cfg: dict, device, knobs: dict | None = None):
        from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3
        from conflux_tpu_torch.parallel.mesh import make_mesh

        self.cfg, self.device = cfg, torch.device(device)
        self.knobs = {"precision": cfg["precision"], **(knobs or {})}
        self.grid = Grid3(*cfg["grid"])
        self.geom = CholeskyGeometry.create(cfg["N"], cfg["v"], self.grid)
        self.mesh = make_mesh(self.grid, device=self.device)
        self.factor_out = None  # the last factor this entry made: the shard, L below

    def factor(self, A: torch.Tensor) -> None:
        from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed

        shard = self.geom.local_block(A, self.mesh.x, self.mesh.y).clone(
            memory_format=torch.contiguous_format)
        self.factor_out = None
        self.factor_out = cholesky_factor_distributed(shard, self.geom, self.mesh,
                                                      **self.knobs)

    def solve(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        from conflux_tpu_torch import solvers
        from conflux_tpu_torch.ops import blas

        out = self.factor_out
        return solvers.refine_classic(
            lambda r: solvers.cholesky_solve_distributed(out, self.geom, self.mesh, r),
            A, B, self.cfg["sweeps"], torch.float64, blas.compute_dtype(out.dtype))

    def factor_solve(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        self.factor(A)
        return self.solve(A, B)

    def release(self) -> None:
        self.factor_out = None

    def system_flops(self, refactor: bool, nrhs: int) -> float:
        N, s = self.cfg["N"], self.cfg["sweeps"]
        flops = roofline.solve_flops(N, nrhs, s + 1, s + 1 if s else 0)
        return flops + (roofline.cholesky_factor_flops(N) if refactor else 0.0)
