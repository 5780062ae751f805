"""Single-device blocked right-looking Cholesky (the port of
`conflux_tpu/cholesky/single.py`).

The reference's per-iteration phases (`Cholesky.cpp:743-784`: dpotrf ->
dtrsm -> dgemm low-rank update) as a Python loop of eager PyTorch calls,
with exact shapes per step. The trailing update runs on the GEMM kernel
(K1, `ops/hopper_kernels`). Unlike the JAX package's functional program,
the factorization updates one working copy of its input in place: the
trailing block is written by the GEMM kernel where it lies.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import blas


def cholesky_blocked(A: torch.Tensor, v: int, backend: str | None = None) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (N x N, N a multiple of v).

    Runs on A's device and leaves A untouched. Returns L (N, N) lower
    triangular with the strict upper triangle zero. Each step factors the
    diagonal tile (`potrf`, lower triangle read), solves the panel below it
    (`trsm_right_lower_t`) and updates the whole trailing square,
    A22 -= L10 L10^T, as the JAX package does.
    """
    N = A.shape[0]
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"matrix must be square, got {tuple(A.shape)}")
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size {v}")
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    cdtype = blas.compute_dtype(A.dtype)

    A = A.clone()  # the one working copy, updated in place below
    for k in range(N // v):
        off = k * v
        # (1) the diagonal tile (reference `Cholesky.cpp:188-194`); panel
        # math in the compute dtype (f32 when storage is bf16)
        L00 = blas.potrf(A[off:off + v, off:off + v].to(cdtype))
        A[off:off + v, off:off + v] = L00.to(A.dtype)
        if off + v < N:
            # (2) the panel: X L00^T = A10 (reference `Cholesky.cpp:449-452`)
            L10 = blas.trsm_right_lower_t(
                L00, A[off + v:, off:off + v].to(cdtype)).to(A.dtype).contiguous()
            A[off + v:, off:off + v] = L10
            # (3) the trailing update (reference `Cholesky.cpp:333-355`), in
            # place; K1 takes operands with contiguous rows, so L10^T is
            # copied
            trail = A[off + v:, off + v:]
            blas.gemm(L10, L10.T.contiguous(), c=trail, alpha=-1.0,
                      backend=backend, out=trail)
    return A.tril_()
