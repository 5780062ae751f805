"""Single-device blocked right-looking LU with partial pivoting (the port of
`conflux_tpu/lu/single.py`).

The reference's `LU_rep` superstep (`conflux_opt.hpp:343-1827`) on a 1x1x1
grid: panel pivot election, row placement, two TRSMs and the trailing GEMM,
as a Python loop of eager PyTorch calls. The panel runs on the elimination
kernel and the trailing update on the GEMM kernel (`ops/hopper_kernels`).
Unlike the JAX package's functional program, the factorization updates one
working copy of its input in place: the trailing block is written by the
GEMM kernel where it lies.
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
    return torch.from_numpy(x).to(dev)


def state_from_numpy(LU: np.ndarray, perm: np.ndarray, device=None):
    """Packed factors and their row permutation, from numpy (for example as
    the JAX package produced them), as the port's (LU, perm) tensors on
    `device`: LU keeps its dtype, perm becomes int64."""
    return from_numpy(LU, device), from_numpy(np.asarray(perm, np.int64), device)


def lu_factor_blocked(A: torch.Tensor, v: int, backend: str | None = None,
                      panel_algo: str | None = None):
    """Factor A (M x N, M >= N, both multiples of v) as P A = L U.

    Runs on A's device and leaves A untouched. Returns (LU, perm):
      LU   — (M, N) packed factors: strictly-lower part of column-block k
             holds L, upper part holds U (LAPACK getrf layout).
      perm — (M,) int64 row indices such that A[perm, :] == L @ U.
    """
    M, N = A.shape
    if M % v or N % v:
        raise ValueError(f"shape {tuple(A.shape)} not a multiple of tile size {v}")
    if M < N:
        raise ValueError("lu_factor_blocked requires M >= N")
    backend = blas.get_backend() if backend is None else backend
    panel_algo = blas.get_panel_algo() if panel_algo is None else panel_algo
    cdtype = blas.compute_dtype(A.dtype)
    blas._resolve_panel_algo(cdtype, M, v, panel_algo)

    A = A.clone()  # the one working copy, updated in place below
    perm = torch.arange(M, device=A.device)
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
        panel = A[off:, off:off + v].to(cdtype)
        if swap_minimal:
            lu00, gpiv = blas.panel_winners(panel, algo=panel_algo)
            sperm = swap_minimal_perm(gpiv, m)
            nsel = min(2 * v, m)
            moved = torch.argsort(
                (sperm == torch.arange(m, device=A.device)).to(torch.int8),
                stable=True)[:nsel]
            A[off + moved, :] = A[off + sperm[moved], :]
            perm[off:] = perm[off:][sperm]
            A[off:off + v, off:off + v] = lu00.to(A.dtype)
            U00 = torch.triu(lu00)
            if m > v:
                # --- L10 TRSM (reference step 4) -------------------------- #
                L10 = blas.trsm_right_upper(U00, A[off + v:, off:off + v].to(cdtype))
                A[off + v:, off:off + v] = L10.to(A.dtype)
        else:
            lu_panel, pperm = blas.panel_lu(panel, algo=panel_algo)
            lu00 = lu_panel[:v]
            A[off:, :] = A[off:, :][pperm]
            perm[off:] = perm[off:][pperm]
            A[off:, off:off + v] = lu_panel.to(A.dtype)
            L10 = lu_panel[v:, :]
        if off + v < N:
            # --- A01 TRSM (reference step 5) ------------------------------ #
            L00 = blas.unit_lower(lu00)
            A[off:off + v, off + v:] = blas.trsm_left_lower_unit(
                L00, A[off:off + v, off + v:].to(cdtype)).to(A.dtype)
            # --- trailing GEMM (reference step 6, the hot op), in place --- #
            trail = A[off + v:, off + v:]
            blas.gemm(L10.to(A.dtype).contiguous(), A[off:off + v, off + v:], c=trail,
                      alpha=-1.0, backend=backend, out=trail)
    return A, perm


def unpack_lu(LU: torch.Tensor):
    """Split packed factors into (L (M, N) unit-lower, U (N, N) upper)."""
    M, N = LU.shape
    L = torch.tril(LU, -1)[:, :N].clone()
    L[:N, :] += torch.eye(N, dtype=LU.dtype, device=LU.device)
    U = torch.triu(LU[:N, :])
    return L, U
