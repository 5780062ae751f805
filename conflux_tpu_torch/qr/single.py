"""Single-device QR: a height-bounded TSQR tree and the blocked panel
factorization (the port of `conflux_tpu/qr/single.py`), plus CholeskyQR2.

- `tall_qr` factors a tall-skinny panel: R from a chunked QR reduction tree
  (only R factors move up the tree; every QR call is at most
  max(chunk, 2n) rows tall), Q = A R^{-1} by a triangular solve, and a
  second pass on Q itself (the CholeskyQR2 argument with the tree in place
  of the Gram matrix), so Q is orthogonal to eps whatever cond(A).
- `qr_factor_blocked` is block Gram-Schmidt over v-wide panels: `tall_qr`
  on each panel, then the rank-v update A -= Qp (Qp^H A) of the trailing
  columns.
- `cholesky_qr2` is the Gram route, `passes` times G = A^H A, R = chol(G)^H,
  A = A R^{-1}: the single-device body of the JAX
  `cholesky_qr2_distributed` (valid while cond(A)^2 eps < 1).

The JAX package runs no Pallas kernel for QR, so neither does the port:
the chunk round is one batched `torch.linalg.qr(mode="r")` (the library's
QR, where the JAX package calls `jnp.linalg.qr`), the solves
`torch.linalg.solve_triangular`, the products `torch.matmul` in IEEE
float32 (`ops.blas` switches TF32 off). Chunk heights come from
`blas.batched_call_rows`, pinned to the JAX package's ceiling, so the
tree has the reference's shapes. All results carry diag(R) >= 0 (real),
which makes thin Q and R unique.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import blas


def _tree_r(panel: torch.Tensor, chunk: int) -> torch.Tensor:
    """Upper-triangular R (n, n) of a tall (m, n) panel by a chunked QR
    reduction tree. Rows are zero-padded to whole chunks (zero rows leave R
    unchanged); each level is one batched library QR of its chunks."""
    m, n = panel.shape
    ch = max(min(chunk, m), 2 * n)
    while True:
        nch = -(-m // ch)
        if nch * ch != m:
            panel = torch.nn.functional.pad(panel, (0, 0, 0, nch * ch - m))
        if nch == 1:
            return torch.linalg.qr(panel, mode="r")[1][:n]
        rs = torch.linalg.qr(panel.reshape(nch, ch, n), mode="r")[1][:, :n]
        panel = rs.reshape(nch * n, n)
        m = nch * n
        if m <= ch:
            return torch.linalg.qr(panel, mode="r")[1][:n]


def _positive_diag(Q: torch.Tensor, R: torch.Tensor):
    """Normalize so diag(R) is real and >= 0, the unique thin QR: a sign
    flip per column for real dtypes, the diagonal's conjugate phase
    |d| / d for complex ones."""
    d = R.diagonal()
    if R.is_complex():
        mag = d.abs()
        one = torch.ones((), dtype=R.dtype, device=R.device)
        s = torch.where(mag > 0, d.conj() / torch.where(mag > 0, mag, 1.0), one)
    else:
        s = torch.where(d < 0, -1.0, 1.0).to(R.dtype)
    return Q * s.conj()[None, :], R * s[:, None]


def tall_qr(panel: torch.Tensor, chunk: int | None = None, passes: int = 2):
    """(Q, R) of a tall-skinny panel (m >= n): tree R and refined Q. Pass 1:
    R1 = tree_r(A), Q1 = A R1^{-1}; pass 2 (default) the same on Q1, with
    R = R2 R1. Computes in the compute dtype (float32 for bfloat16) and
    returns the panel's dtype. `chunk` defaults to the batched-call height
    of the width (4096 rows at n=1024 float32)."""
    m, n = panel.shape
    if m < n:
        raise ValueError(f"tall_qr needs m >= n, got {tuple(panel.shape)}")
    cdtype = blas.compute_dtype(panel.dtype)
    if chunk is None:
        chunk = blas.batched_call_rows(n, cdtype)
    A = panel.to(cdtype)
    R = None
    for _ in range(max(1, passes)):
        Ri = _tree_r(A, chunk)
        A = blas.trsm_right_upper(Ri, A)
        R = Ri if R is None else torch.matmul(Ri, R)
    Q, R = _positive_diag(A, R)
    return Q.to(panel.dtype), R.to(panel.dtype)


def qr_factor_blocked(A: torch.Tensor, v: int = 256, chunk: int | None = None,
                      passes: int = 2, reproject: bool = False):
    """Blocked (Q, R) of an (M, N) matrix, M >= N: thin Q (M, N) and upper
    R (N, N) with diag(R) >= 0. Each v-wide panel is factored by `tall_qr`
    and the trailing columns take the rank-v update A -= Qp (Qp^H A), in
    place in one working copy of A in the compute dtype, whose finished
    columns become Q.

    One sweep of block Gram-Schmidt loses orthogonality between panels as
    cond(A) grows (Q^H Q - I ~ eps cond; a float32 Gaussian matrix at
    N=1024 misses 100 sqrt(N) eps). `reproject=True` re-orthogonalizes
    each panel's Qp once (the second sweep of BCGS2, the role of the
    re-projection in the JAX package's block-cyclic loop, which its
    miniapp's `--full` runs at every grid): Qp -= Q_done (Q_done^H Qp),
    then one more tree pass (`tall_qr(passes=1)`) on the nearly orthonormal
    result, with R's rows and diagonal block corrected to match. It costs
    a second GEMM pair per panel. The default keeps the JAX
    `qr_factor_blocked` arithmetic."""
    M, N = A.shape
    if M < N:
        raise ValueError(f"qr_factor_blocked needs M >= N, got {tuple(A.shape)}")
    v = min(v, N)
    cdtype = blas.compute_dtype(A.dtype)
    if chunk is None:
        chunk = blas.batched_call_rows(v, cdtype)
    W = A.to(cdtype, copy=True)
    R = torch.zeros((N, N), dtype=cdtype, device=A.device)
    for j0 in range(0, N, v):
        j1 = min(j0 + v, N)
        Qp, Rp = tall_qr(W[:, j0:j1], chunk=chunk, passes=passes)
        if reproject and j0:
            # P = Qp Rp and Qp = Q_done Wk + Qp2 Rp2, so
            # P = Q_done (Wk Rp) + Qp2 (Rp2 Rp)
            Wk = torch.matmul(W[:, :j0].mH, Qp)
            Qp = torch.addmm(Qp, W[:, :j0], Wk, alpha=-1)
            Qp, Rp2 = tall_qr(Qp, chunk=chunk, passes=1)
            R[:j0, j0:j1] += torch.matmul(Wk, Rp)
            Rp = torch.matmul(Rp2, Rp)
        R[j0:j1, j0:j1] = Rp
        if j1 < N:
            C = torch.matmul(Qp.mH, W[:, j1:])
            R[j0:j1, j1:] = C
            W[:, j1:].addmm_(Qp, C, alpha=-1)
        W[:, j0:j1] = Qp
    return W.to(A.dtype), torch.triu(R).to(A.dtype)


def cholesky_qr2(A: torch.Tensor, passes: int = 2):
    """(Q, R) of a tall (M, n) matrix by Gram-matrix CholeskyQR with
    `passes` sweeps: G = A^H A, R_i = chol(G)^H (`blas.potrf`),
    A = A R_i^{-1} (`blas.trsm_right_upper`), R = R_i R. Everything is a
    product or a solve; valid while cond(A)^2 eps < 1 (`tall_qr`
    otherwise). diag(R) >= 0; returns A's dtype."""
    M, n = A.shape
    if M < n:
        raise ValueError(f"cholesky_qr2 needs M >= n, got {tuple(A.shape)}")
    cdtype = blas.compute_dtype(A.dtype)
    W = A.to(cdtype)
    R = None
    for _ in range(max(1, passes)):
        Ri = blas.potrf(torch.matmul(W.mH, W)).mH
        W = blas.trsm_right_upper(Ri, W)
        R = Ri if R is None else torch.matmul(Ri, R)
    Q, R = _positive_diag(W, R)
    return Q.to(A.dtype), R.to(A.dtype)
