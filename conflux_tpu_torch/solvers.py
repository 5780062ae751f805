"""Direct solves on the factorization, with iterative refinement (the
single-device half of `conflux_tpu/solvers.py`).

`lu_solve` is the triangular-substitution half for factors from
`lu_factor_blocked`; `refine_classic` is the HPL-MxP recipe's refinement
loop: cheap factors, residuals in a higher precision.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import blas


def lu_solve(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given packed LU factors with A[perm] == L @ U (the
    contract of `lu_factor_blocked`, square A). b is (N,) or (N, k)."""
    M, N = LU.shape
    if M != N:
        raise ValueError(
            f"lu_solve needs square factors, got {tuple(LU.shape)} (an M > N "
            "factorization has no unique solve)")
    if b.shape[0] != N:
        raise ValueError(f"b has {b.shape[0]} rows, factors need {N}")
    cdtype = blas.compute_dtype(LU.dtype)
    Lu = LU.to(cdtype)
    squeeze = b.dim() == 1
    b2 = b.to(cdtype)[:, None] if squeeze else b.to(cdtype)
    y = blas.trsm_left_lower_unit(Lu, b2[perm.long()])
    x = blas.trsm_left_upper(Lu, y)
    return x[:, 0] if squeeze else x


def refine_classic(solve_fn, A: torch.Tensor, b: torch.Tensor, sweeps: int,
                   rdtype: torch.dtype, corr_dtype: torch.dtype) -> torch.Tensor:
    """Classic (Richardson) iterative refinement: x0 = solve(b), then
    `sweeps` rounds of x += solve(b - A x). x and b stay in the residual
    precision `rdtype` (a downcast b would make the iteration converge to
    A x = low(b)); only the corrections ride the factors through
    `solve_fn`, cast to `corr_dtype`."""
    b_r = b.to(rdtype)
    x = solve_fn(b.to(corr_dtype)).to(rdtype)
    for _ in range(sweeps):
        r = _residual_strips(A, x, b_r, rdtype)
        x = x + solve_fn(r.to(corr_dtype)).to(rdtype)
    return x


def _residual_strips(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                     rdtype: torch.dtype) -> torch.Tensor:
    """r = b - A x with the matvec accumulated in `rdtype`, casting A one
    row strip at a time (a full (N, N) float64 copy would double the
    matrix footprint)."""
    N = A.shape[0]
    strip = max(1, min(4096, N))
    xr = x.to(rdtype)
    return torch.cat([b[i:i + strip].to(rdtype) - A[i:i + strip].to(rdtype) @ xr
                      for i in range(0, N, strip)])
