"""The plain reference of a dense LU solve: blocked right-looking LU with
partial pivoting in float32, triangular solves, float64 refinement.

Not the program's algorithm (CONFLUX elects each panel's pivots by a
tournament; this is LAPACK's partial pivoting), so the two factors differ;
both solve A x = b to the stated accuracy, and that is what is compared.
`tf32=True` computes the trailing updates as TF32 products: the control,
the precision one step below the configuration's.
"""

from __future__ import annotations

import torch

from portbench.reference.common import STRIP, matmul, no_tf32, refine


def factor(A: torch.Tensor, v: int, tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(LU, perm): packed factors with A[perm] = L U, L unit lower."""
    no_tf32()
    LU = A.to(torch.float32).clone()
    N = LU.shape[0]
    perm = torch.arange(N, device=LU.device)
    for k in range(0, N, v):
        kb = min(v, N - k)
        lu_p, piv = torch.linalg.lu_factor(LU[k:, k:k + kb])
        # LAPACK's row interchanges, in order, as one permutation of rows k..
        p = list(range(N - k))
        for i, t in enumerate(piv.tolist()):
            p[i], p[t - 1] = p[t - 1], p[i]
        p = torch.tensor(p, device=LU.device)
        LU[k:] = LU[k:][p]
        perm[k:] = perm[k:][p]
        LU[k:, k:k + kb] = lu_p
        if k + kb < N:
            L00 = LU[k:k + kb, k:k + kb]
            LU[k:k + kb, k + kb:] = torch.linalg.solve_triangular(
                L00, LU[k:k + kb, k + kb:], upper=False, unitriangular=True)
            LU[k + kb:, k + kb:] -= matmul(LU[k + kb:, k:k + kb], LU[k:k + kb, k + kb:], tf32)
    return LU, perm


def solve_factored(LU: torch.Tensor, perm: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    vec = B.dim() == 1
    Y = B[perm][:, None] if vec else B[perm]
    Y = torch.linalg.solve_triangular(LU, Y, upper=False, unitriangular=True)
    X = torch.linalg.solve_triangular(LU, Y, upper=True)
    return X[:, 0] if vec else X


def solve(A: torch.Tensor, B: torch.Tensor, v: int, sweeps: int, tf32: bool = False):
    """x of A x = b (B (N,) or (N, k)), float64, after `sweeps` rounds of
    refinement; also returns the factors."""
    LU, perm = factor(A, v, tf32)
    return refine(lambda r: solve_factored(LU, perm, r), A, B, sweeps), (LU, perm)


def factor_residual(A: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor) -> dict:
    """The factor's residual A[perm] - L U in float64 (L unit lower, U
    upper, packed in LU, the getrf layout): the Frobenius norms of all of
    it and of its off-diagonal part, beside ||A||_F and the off-diagonal
    part's of A[perm]. A row strip at a time: strip rows i0..i1 of L end
    at column i1."""
    N = A.shape[0]
    U = torch.triu(LU.to(torch.float64))
    num = num_off = den = off = 0.0
    for i0 in range(0, N, STRIP):
        i1 = min(i0 + STRIP, N)
        L = torch.tril(LU[i0:i1, :i1].to(torch.float64), diagonal=i0 - 1)
        L[:, i0:i1].diagonal().fill_(1.0)
        Ap = A[perm[i0:i1]].to(torch.float64)
        R = Ap - L @ U[:i1]
        num += float(torch.linalg.norm(R)) ** 2
        den += float(torch.linalg.norm(Ap)) ** 2
        # the strip's diagonal entries are (r, i0 + r)
        R[:, i0:i1].diagonal().zero_()
        Ap[:, i0:i1].diagonal().zero_()
        num_off += float(torch.linalg.norm(R)) ** 2
        off += float(torch.linalg.norm(Ap)) ** 2
        del L, Ap, R
    return {"residual_f": num ** 0.5, "residual_offdiag_f": num_off ** 0.5,
            "a_f": den ** 0.5, "a_offdiag_f": off ** 0.5}


def extra_checks(cfg: dict, A: torch.Tensor, factor) -> dict:
    """The factor's residual beside the solve's, on the off-diagonal part:
    ||offdiag(A[perm] - L U)||_F / ||offdiag(A[perm])||_F. `factor` is
    (packed LU in pivoted row order, perm), one rank's shard on a 1x1x1
    grid, where the shard is the whole matrix. The off-diagonal entries
    are what the trailing updates carry; a dominant diagonal (N/4 here)
    and its rounding would hide their precision."""
    if list(cfg["grid"]) != [1, 1, 1]:
        raise ValueError("the LU factor check reads a 1x1x1 grid's shard as the whole factor")
    LU, perm = factor
    r = factor_residual(A, LU, perm)
    return {"factor_residual": {"value": r["residual_offdiag_f"] / r["a_offdiag_f"],
                                "limit": float(cfg["limits"]["factor_residual"])}}
