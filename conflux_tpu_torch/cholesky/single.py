"""Single-device blocked right-looking Cholesky (the port of
`conflux_tpu/cholesky/single.py`).

The reference's per-iteration phases (`Cholesky.cpp:743-784`: dpotrf ->
dtrsm -> dgemm low-rank update) as a Python loop of eager PyTorch calls,
with exact shapes per step. The trailing update runs on the GEMM kernel
(K1, `ops/hopper_kernels`) on backend "kernel" (float32 and bfloat16
storage), on the library product on backend "xla" (any dtype, float64
and complex Hermitian systems included). Unlike the JAX package's
functional program, the factorization updates one working copy of its
input in place: the trailing block is written by the GEMM where it lies.
A (B, N, N) batch runs each step for all its systems at once (the JAX
package vmaps the body).
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import blas


def cholesky_blocked(A: torch.Tensor, v: int, precision=None,
                     backend: str | None = None) -> torch.Tensor:
    """Lower Cholesky factor of SPD (complex: HPD) A (N x N, N a multiple
    of v), or of each system of a (B, N, N) batch.

    Runs on A's device and leaves A untouched. Returns L (N, N) lower
    triangular with the strict upper triangle zero (a leading B for a
    batch). Each step factors the diagonal tile (`potrf`, lower triangle
    read; a tile that is not positive definite comes out NaN), solves the
    panel below it (`trsm_right_lower_t`) and updates the whole trailing
    square, A22 -= L10 L10^H, as the JAX package does: one K1 launch per
    system on "kernel", one batched library product on "xla". `precision`
    is the library product's (`blas.gemm`; None: the registry's): DEFAULT
    and HIGH run it as one TF32 pass on the card, K1 is IEEE float32 at
    every level.
    """
    precision = blas.resolve_precision(precision)
    batched = A.dim() == 3
    if A.dim() not in (2, 3) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"matrix must be square, got {tuple(A.shape)}")
    N = A.shape[-1]
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size {v}")
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    blas.check_gemm_route(backend, A.dtype)
    cdtype = blas.compute_dtype(A.dtype)

    # the one working copy, updated in place below
    X = A.clone() if batched else A[None].clone()
    for k in range(N // v):
        off = k * v
        # (1) the diagonal tile (reference `Cholesky.cpp:188-194`); panel
        # math in the compute dtype (f32 when storage is bf16)
        L00 = blas.potrf(X[:, off:off + v, off:off + v].to(cdtype))
        X[:, off:off + v, off:off + v] = L00.to(X.dtype)
        if off + v < N:
            # (2) the panel: X L00^H = A10 (reference `Cholesky.cpp:449-452`)
            L10 = blas.trsm_right_lower_t(
                L00, X[:, off + v:, off:off + v].to(cdtype)).to(X.dtype)
            X[:, off + v:, off:off + v] = L10
            # (3) the trailing update (reference `Cholesky.cpp:333-355`), in
            # place; K1 takes operands with contiguous rows, so L10 and
            # L10^T are copied
            trail = X[:, off + v:, off + v:]
            if backend == "kernel":
                for i in range(X.shape[0]):
                    Li = L10[i].contiguous()
                    blas.gemm(Li, Li.T.contiguous(), trail[i], -1.0, 1.0, precision,
                              backend, out=trail[i])
            else:
                blas.gemm(L10, L10.mH, trail, -1.0, 1.0, precision, backend, out=trail)
    X.tril_()
    return X if batched else X[0]
