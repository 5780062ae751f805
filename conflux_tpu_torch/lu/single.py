"""Single-device blocked right-looking LU with partial pivoting (the port of
`conflux_tpu/lu/single.py`).

The reference's `LU_rep` superstep (`conflux_opt.hpp:343-1827`) on a 1x1x1
grid: panel pivot election, row placement, two TRSMs and the trailing GEMM,
as a Python loop of eager PyTorch calls. On the kernel routes the panel runs
on the elimination kernel (K2) and the trailing update on the GEMM kernel
(K1, `ops/hopper_kernels`); the JAX package's library routes (backend
"xla", panel algos "partial", "tournament", "auto") on the library LU and
product, in any dtype.
Unlike the JAX package's functional program, the factorization updates one
working copy of its input in place: the trailing block is written by the
GEMM where it lies. A (B, M, N) batch runs each superstep for all its
systems at once (the JAX package vmaps the body).
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.device import resolve_device
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.ops.permute import swap_minimal_perm

# Largest M that uses swap-minimal row placement (see the strategy comment
# inside lu_factor_blocked); module-level so tests can exercise both paths.
_SWAP_SCATTER_MAX = 16384


def from_numpy(x: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array (an input matrix, a right-hand side) as a tensor on
    `device` (default: the card)."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # e.g. a JAX array's host view
        x = x.copy()
    if x.dtype.name == "bfloat16":  # numpy's bfloat16 extension type, by its bits
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(x).to(dev)


def state_from_numpy(LU: np.ndarray, perm: np.ndarray, device=None):
    """Packed factors and their row permutation, from numpy (for example as
    the JAX package produced them), as the port's (LU, perm) tensors on
    `device`: LU keeps its dtype, perm becomes int64."""
    return from_numpy(LU, device), from_numpy(np.asarray(perm, np.int64), device)


def lu_factor_blocked(A: torch.Tensor, v: int, backend: str | None = None,
                      panel_algo: str | None = None):
    """Factor A (M x N, M >= N, both multiples of v) as P A = L U, or each
    system of a (B, M, N) batch (the JAX package's `jax.vmap` of its body).

    Runs on A's device and leaves A untouched. Returns (LU, perm):
      LU   — (M, N) packed factors: strictly-lower part of column-block k
             holds L, upper part holds U (LAPACK getrf layout).
      perm — (M,) int64 row indices such that A[perm, :] == L @ U.
    A batch gives both with a leading B. Backend "kernel" (float32 or
    bfloat16 storage) runs the trailing update on K1, one launch per
    system and superstep; "xla" (any dtype) on the library product, one
    batched call a superstep. Panel algo "kernel" elects on K2, one
    batched launch per column block for all the systems (float32 panel
    math); the library algos on the batched library LU.
    """
    batched = A.dim() == 3
    if A.dim() not in (2, 3):
        raise ValueError(f"A must be (M, N) or (B, M, N), got {tuple(A.shape)}")
    M, N = A.shape[-2:]
    if M % v or N % v:
        raise ValueError(f"shape {tuple(A.shape)} not a multiple of tile size {v}")
    if M < N:
        raise ValueError("lu_factor_blocked requires M >= N")
    backend = blas.get_backend() if backend is None else backend
    panel_algo = blas.get_panel_algo() if panel_algo is None else panel_algo
    blas.check_gemm_route(backend, A.dtype)
    cdtype = blas.compute_dtype(A.dtype)
    blas._resolve_panel_algo(cdtype, M, v, panel_algo)

    # the one working copy, updated in place below
    X = A.clone() if batched else A[None].clone()
    B = X.shape[0]
    dev = X.device
    perm = torch.arange(M, device=dev).repeat(B, 1)
    n_steps = N // v
    # Row placement strategy. LAPACK semantics move at most 2v rows per
    # superstep, so scattering just the changed slots (swap-minimal) avoids
    # the O(m*N) trailing-block gather. Large problems keep the
    # full-gather formulation, as the JAX package does: the tournament's
    # "winners first" permutation (and so the pivots) follows that choice.
    swap_minimal = M <= _SWAP_SCATTER_MAX
    for k in range(n_steps):
        off = k * v
        m = M - off
        # --- pivot election (reference step 1) ---------------------------- #
        panel = X[:, off:, off:off + v].to(cdtype)
        if swap_minimal:
            lu00, gpiv = blas.panel_winners(panel, algo=panel_algo)
            sperm = swap_minimal_perm(gpiv, m)
            nsel = min(2 * v, m)
            fixed = sperm == torch.arange(m, device=dev)
            moved = torch.argsort(fixed.to(torch.int8), dim=1, stable=True)[:, :nsel]
            rows = _rows(X, off + torch.gather(sperm, 1, moved))
            X.scatter_(1, (off + moved)[:, :, None].expand(B, nsel, N), rows)
            perm[:, off:] = torch.gather(perm[:, off:], 1, sperm)
            X[:, off:off + v, off:off + v] = lu00.to(X.dtype)
            U00 = torch.triu(lu00)
            if m > v:
                # --- L10 TRSM (reference step 4) -------------------------- #
                L10 = blas.trsm_right_upper(U00, X[:, off + v:, off:off + v].to(cdtype))
                X[:, off + v:, off:off + v] = L10.to(X.dtype)
        else:
            lu_panel, pperm = blas.panel_lu(panel, algo=panel_algo)
            lu00 = lu_panel[:, :v]
            X[:, off:, :] = _rows(X, off + pperm)
            perm[:, off:] = torch.gather(perm[:, off:], 1, pperm)
            X[:, off:, off:off + v] = lu_panel.to(X.dtype)
            L10 = lu_panel[:, v:, :]
        if off + v < N:
            # --- A01 TRSM (reference step 5) ------------------------------ #
            L00 = blas.unit_lower(lu00)
            X[:, off:off + v, off + v:] = blas.trsm_left_lower_unit(
                L00, X[:, off:off + v, off + v:].to(cdtype)).to(X.dtype)
            # --- trailing GEMM (reference step 6, the hot op), in place --- #
            _trailing_update(X, L10.to(X.dtype), off, v, backend)
    return (X, perm) if batched else (X[0], perm[0])


def _rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X[b, idx[b], :] for each system b: (B, r, N) from (B, r) row ids.
    One matrix (the miniapp's main path) keeps its whole-row gather
    (`index_select`), which reads no per-element index."""
    if X.shape[0] == 1:
        return X[0].index_select(0, idx[0])[None]
    return torch.gather(X, 1, idx[:, :, None].expand(-1, -1, X.shape[-1]))


def _trailing_update(X: torch.Tensor, L10: torch.Tensor, off: int, v: int,
                     backend: str) -> None:
    """X[:, off+v:, off+v:] -= L10 @ X[:, off:off+v, off+v:] in place: one
    K1 launch per system on "kernel" (K1 takes 2D operands), one batched
    library product on "xla"."""
    trail = X[:, off + v:, off + v:]
    A01 = X[:, off:off + v, off + v:]
    if backend == "kernel":
        for i in range(X.shape[0]):
            blas.gemm(L10[i].contiguous(), A01[i], c=trail[i], alpha=-1.0,
                      backend=backend, out=trail[i])
    else:
        blas.gemm(L10, A01, c=trail, alpha=-1.0, backend=backend, out=trail)


def unpack_lu(LU: torch.Tensor):
    """Split packed factors into (L (M, N) unit-lower, U (N, N) upper)."""
    M, N = LU.shape
    L = torch.tril(LU, -1)[:, :N].clone()
    L[:N, :] += torch.eye(N, dtype=LU.dtype, device=LU.device)
    U = torch.triu(LU[:N, :])
    return L, U
