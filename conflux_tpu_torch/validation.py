"""Correctness oracles: factorization residuals and test matrices (the
single-device half of `conflux_tpu/validation.py`, the reference's
CONFLUX_WITH_VALIDATION role).

`lu_residual` and `cholesky_residual` are the host numpy oracles.
`lu_residual_device` and `cholesky_residual_device` compute the same
normalized residuals where the factors lie, in float64 row and column
strips, so a full-size check needs neither a host product nor an (N, N)
float64 copy of anything; `qr_residual_device` gives a QR's reconstruction
and orthogonality residuals the same way.
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


def cholesky_residual(A, L) -> float:
    """Normalized ||A - L L^T||_F / ||A||_F for a lower Cholesky factor, on
    the host (L's strict upper triangle is ignored)."""
    A = np.asarray(A)
    L = np.tril(np.asarray(L))
    R = A - L @ L.T
    return float(np.linalg.norm(R) / max(np.linalg.norm(A), 1e-30))


def cholesky_residual_device(A: torch.Tensor, L: torch.Tensor,
                             strip: int = 4096) -> float:
    """:func:`cholesky_residual` computed on the factor's device in float64.

    A is the matrix that was factored (any float dtype, on L's device).
    Each (strip x strip) block of L L^T is the product of two L row strips,
    cut to the k range where both can be nonzero and masked to the lower
    triangle. Peak extra memory is a few float64 strips.
    """
    N = L.shape[0]
    rss = torch.zeros((), dtype=torch.float64, device=L.device)
    ass = torch.zeros((), dtype=torch.float64, device=L.device)
    for j in range(0, N, strip):
        je = min(j + strip, N)
        for i in range(0, N, strip):
            ie = min(i + strip, N)
            k = min(ie, je)  # L[r, c] is zero for c > r
            Li = torch.tril(L[i:ie, :k].double(), diagonal=i)
            Lj = torch.tril(L[j:je, :k].double(), diagonal=j)
            Ai = A[i:ie, j:je].double()
            R = Ai - Li @ Lj.T
            rss += (R * R).sum()
            ass += (Ai * Ai).sum()
    return float(torch.sqrt(rss) / torch.clamp(torch.sqrt(ass), min=1e-30))


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def qr_residual_device(A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
                       strip: int = 4096) -> tuple[float, float]:
    """(||A - Q R||_F / ||A||_F, ||Q^H Q - I||_F / sqrt(N)) of a thin QR
    (A, Q (M, N), R (N, N) upper) on the factors' device, in float64
    (complex128 for complex input): the one-device counterpart of the JAX
    package's `qr_residual_distributed`. One pass per column strip J of
    width `strip`: over the row strips i, the block A_iJ - Q_i R_J (R_J
    cut to its rows that can be nonzero) and the Gram strip Q^H Q_J
    accumulate; nothing (M, N) or (N, N) is formed."""
    M, N = Q.shape
    dev = Q.device
    rss = torch.zeros((), dtype=torch.float64, device=dev)
    ass = torch.zeros((), dtype=torch.float64, device=dev)
    oss = torch.zeros((), dtype=torch.float64, device=dev)
    for j in range(0, N, strip):
        je = min(j + strip, N)
        RJ = torch.triu(_wide(R[:je, j:je]), diagonal=-j)  # R[r, c] is zero for r > c
        G = None
        for i in range(0, M, strip):
            ie = min(i + strip, M)
            Qi = _wide(Q[i:ie])
            Ai = _wide(A[i:ie, j:je])
            E = Ai - Qi[:, :je] @ RJ
            rss += (E.abs() ** 2).sum()
            ass += (Ai.abs() ** 2).sum()
            g = Qi.mH @ Qi[:, j:je]
            G = g if G is None else G + g
        idx = torch.arange(j, je, device=dev)
        G[idx, idx - j] -= 1
        oss += (G.abs() ** 2).sum()
    rec = torch.sqrt(rss) / torch.clamp(torch.sqrt(ass), min=1e-30)
    return float(rec), float(torch.sqrt(oss) / np.sqrt(N))


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


def make_spd_matrix(N: int, seed: int = 7, dtype=np.float64, device="cpu") -> torch.Tensor:
    """Deterministic SPD matrix (the JAX package's generator, bit for bit:
    the symmetric part of a uniform(-1, 1) matrix plus N on the diagonal).

    The symmetrization and the diagonal shift run on `device`, so at
    N=32768 the host holds only the random draw, not the (N, N)
    temporaries of a host-side symmetrization."""
    rng = np.random.default_rng(seed)
    Bt = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(N, N)).astype(dtype)).to(device)
    A = Bt + Bt.T
    del Bt
    A /= 2
    A.diagonal().add_(N)
    return A


def make_hpd_matrix(N: int, seed: int = 7, dtype=np.complex128, device="cpu") -> torch.Tensor:
    """Deterministic Hermitian positive-definite matrix (the JAX package's
    generator, bit for bit: the Hermitian part of a complex uniform(-1, 1)
    matrix plus N on the diagonal, the diagonal real by construction),
    built on the host in numpy and put on `device`."""
    rng = np.random.default_rng(seed)
    B = (rng.uniform(-1.0, 1.0, size=(N, N))
         + 1j * rng.uniform(-1.0, 1.0, size=(N, N))).astype(dtype)
    A = (B + B.conj().T) / 2
    A[np.arange(N), np.arange(N)] += N
    return torch.from_numpy(A).to(device)
