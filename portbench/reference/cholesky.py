"""The plain reference of a dense SPD solve: blocked right-looking
Cholesky in float32, the two triangular solves, float64 refinement; and
the factor's own residual in float64.

`tf32=True` computes the trailing updates as TF32 products: the control,
the precision one step below the configuration's.
"""

from __future__ import annotations

import torch

from portbench.reference.common import STRIP, matmul, no_tf32, refine


def factor(A: torch.Tensor, v: int, tf32: bool = False) -> torch.Tensor:
    """L, lower, with A = L L^T (the upper triangle is zero)."""
    no_tf32()
    L = A.to(torch.float32).clone()
    N = L.shape[0]
    for k in range(0, N, v):
        kb = min(v, N - k)
        L00 = torch.linalg.cholesky(L[k:k + kb, k:k + kb])
        L[k:k + kb, k:k + kb] = L00
        if k + kb < N:
            L10 = torch.linalg.solve_triangular(L00.mT, L[k + kb:, k:k + kb], upper=True,
                                                left=False)
            L[k + kb:, k:k + kb] = L10
            L[k + kb:, k + kb:] -= matmul(L10, L10.mT, tf32)
    return torch.tril(L)


def solve_factored(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    vec = B.dim() == 1
    Y = B[:, None] if vec else B
    Y = torch.linalg.solve_triangular(L, Y, upper=False)
    X = torch.linalg.solve_triangular(L.mT, Y, upper=True)
    return X[:, 0] if vec else X


def solve(A: torch.Tensor, B: torch.Tensor, v: int, sweeps: int, tf32: bool = False):
    """x of A x = b, float64, after `sweeps` rounds of refinement; also
    returns L."""
    L = factor(A, v, tf32)
    return refine(lambda r: solve_factored(L, r), A, B, sweeps), L


def factor_residual(A: torch.Tensor, L: torch.Tensor) -> dict:
    """The factor's residual A - L L^T in float64 (the factor's upper
    triangle is not read): the Frobenius norms of its lower triangle and of
    its strictly lower part, beside ||tril(A)||_F and ||tril(A, -1)||_F.
    Computed a row strip at a time: strip rows i0..i1 against columns
    0..i1, where L's columns end."""
    N = A.shape[0]
    Lw = torch.tril(L.to(torch.float64))
    num = num_off = den = off = 0.0
    for i0 in range(0, N, STRIP):
        i1 = min(i0 + STRIP, N)
        R = A[i0:i1, :i1].to(torch.float64) - Lw[i0:i1, :i1] @ Lw[:i1, :i1].mT
        Ai = A[i0:i1, :i1].to(torch.float64)
        low = torch.tril(torch.ones(i1 - i0, i1, dtype=torch.bool, device=A.device),
                         diagonal=i0)
        num += float(torch.linalg.norm(R[low])) ** 2
        den += float(torch.linalg.norm(Ai[low])) ** 2
        strict = torch.tril(low, diagonal=i0 - 1)
        num_off += float(torch.linalg.norm(R[strict])) ** 2
        off += float(torch.linalg.norm(Ai[strict])) ** 2
        del R, Ai
    return {"residual_f": num ** 0.5, "residual_offdiag_f": num_off ** 0.5,
            "a_f": den ** 0.5, "a_offdiag_f": off ** 0.5}


def extra_checks(cfg: dict, A: torch.Tensor, L: torch.Tensor) -> dict:
    """The factor's residual beside the solve's, on the strictly lower
    part: ||tril(A - L L^T, -1)||_F / ||tril(A, -1)||_F. The off-diagonal
    entries are what the trailing updates carry; the diagonal (N here) and
    its rounding would hide their precision."""
    r = factor_residual(A, L)
    return {"factor_residual": {"value": r["residual_offdiag_f"] / r["a_offdiag_f"],
                                "limit": float(cfg["limits"]["factor_residual"])}}
