"""Correctness oracles: factorization residuals (the single-device half of
`conflux_tpu/validation.py`, the reference's CONFLUX_WITH_VALIDATION role).

`lu_residual` is the host numpy oracle. `lu_residual_device` computes the
same ||A[perm] - L U||_F / ||A||_F where the factors lie, in float64 row and
column strips, so a full-size check needs neither a host product nor an
(M, N) float64 copy of anything.
"""

from __future__ import annotations

import numpy as np
import torch


def lu_residual(A, LU, perm) -> float:
    """Normalized ||A[perm] - L U||_F / ||A||_F for packed LU factors, on the
    host. L is (M, K) unit-lower and U (K, N) upper with K = min(M, N)."""
    A = np.asarray(A)
    LU = np.asarray(LU)
    perm = np.asarray(perm)
    M, N = LU.shape
    K = min(M, N)
    L = np.tril(LU, -1)[:, :K] + np.eye(M, K, dtype=LU.dtype)
    U = np.triu(LU[:K, :])
    R = A[perm, :] - L @ U
    return float(np.linalg.norm(R) / max(np.linalg.norm(A), 1e-30))


def lu_residual_device(A: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
                       strip: int = 4096) -> float:
    """:func:`lu_residual` computed on the factors' device in float64.

    A is the matrix that was factored (original row order, any float dtype,
    on LU's device). Each (strip x strip) block of L U is the product of an
    L row strip and a U column strip, cut to the k range where both can be
    nonzero; A[perm] is gathered one row strip at a time. Peak extra memory
    is a few float64 strips.
    """
    M, N = LU.shape
    K = min(M, N)
    perm = perm.to(LU.device).long()
    cols = torch.arange(K, device=LU.device)
    rss = torch.zeros((), dtype=torch.float64, device=LU.device)
    ass = torch.zeros((), dtype=torch.float64, device=LU.device)
    for j in range(0, N, strip):
        je = min(j + strip, N)
        kj = min(je, K)  # U[k, j:je] is zero for k >= je
        Uj = torch.triu(LU[:kj, j:je].double(), diagonal=-j)
        for i in range(0, M, strip):
            ie = min(i + strip, M)
            kmax = min(kj, ie)  # L[i:ie, k] is zero for k >= ie
            Li = LU[i:ie, :kmax].double()
            rows = torch.arange(i, ie, device=LU.device)[:, None]
            Li = torch.where(rows > cols[None, :kmax], Li, 0.0)
            Li += (rows == cols[None, :kmax]).double()
            Ai = A[perm[i:ie], j:je].double()
            R = Ai - Li @ Uj[:kmax]
            rss += (R * R).sum()
            ass += (Ai * Ai).sum()
    return float(torch.sqrt(rss) / torch.clamp(torch.sqrt(ass), min=1e-30))


def residual_bound(n: int, dtype) -> float:
    """Acceptance threshold: c * sqrt(n) * eps, with headroom for pivot growth."""
    if isinstance(dtype, torch.dtype):
        eps = torch.finfo(dtype).eps
    else:
        eps = float(np.finfo(dtype).eps)
    return 100.0 * np.sqrt(n) * eps


def make_test_matrix(M: int, N: int, seed: int = 42, dtype=np.float64) -> np.ndarray:
    """Deterministic well-conditioned random matrix (the JAX package's
    generator, bit for bit: uniform(-1, 1) plus 2 on the diagonal)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 1.0, size=(M, N)).astype(dtype)
    d = min(M, N)
    A[np.arange(d), np.arange(d)] += 2.0
    return A
