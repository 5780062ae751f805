"""Batched factors of the serve plans (the port of
`conflux_tpu/ops/pallas_factor.py`).

- :func:`kernel_lu_factor_batched` is the counterpart of
  `pallas_lu_factor_batched`: partial-pivot LU of a (B, N, N) batch on the
  K4 kernel (`hopper_kernels.batched_lu`, a CTA cluster per slot);
- :func:`kernel_cholesky_factor_batched` is the counterpart of
  `pallas_cholesky_factor_batched`: lower Cholesky of a (B, N, N) SPD
  batch on the K5 kernel (`hopper_kernels.batched_chol`, a CTA cluster per
  slot).

Both fuse the Freivalds probe row wA = w^T A of each untouched input into
the same launch. Per-slot outputs depend only on the slot's own input, not
on B or on the other slots, which is the bucket/pad contract the factor
lane rests on.

The TPU kernels' two Mosaic workarounds are gone: N is not padded to a
power of two (ragged N runs as it is, with the same pivots and bits as the
identity-padded reference), and B=1 needs no second identity slot.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import hopper_kernels


def _check_batched_square(A: torch.Tensor) -> None:
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(
            f"batched factor kernels take (B, N, N), got {tuple(A.shape)}")


def _probe_input(probe_w, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The caller's length-n probe vector as the kernel's w operand."""
    w = torch.as_tensor(probe_w)
    if tuple(w.shape) != (n,):
        raise ValueError(f"probe_w has shape {tuple(w.shape)}, need ({n},)")
    return w.to(device=device, dtype=dtype)


def kernel_lu_factor_batched(A: torch.Tensor, *, probe_w=None):
    """Pivoted LU of a (B, N, N) float32 or float64 batch on the K4 kernel:
    returns (LU, perm), packed factors in LAPACK order and the permutation
    with A[i][perm[i]] == L_i @ U_i; with `probe_w` (length N) also wA
    (B, N) = w^T A_i, accumulated in the kernel off the untouched input."""
    _check_batched_square(A)
    w = None if probe_w is None else _probe_input(
        probe_w, A.shape[-1], A.dtype, A.device)
    LU, perm, wa = hopper_kernels.batched_lu(A, w)
    if probe_w is None:
        return LU, perm
    return LU, perm, wa


def kernel_cholesky_factor_batched(A: torch.Tensor, *, probe_w=None):
    """Lower Cholesky factors of a (B, N, N) float32 or float64 SPD batch on
    the K5 kernel: returns L (B, N, N) with the strict upper triangles zero
    (the `cholesky_blocked` contract per slot); with `probe_w` (length N)
    also wA (B, N) = w^T A_i, accumulated in the kernel off the untouched
    input."""
    _check_batched_square(A)
    w = None if probe_w is None else _probe_input(
        probe_w, A.shape[-1], A.dtype, A.device)
    L, wa = hopper_kernels.batched_chol(A, w)
    if probe_w is None:
        return L
    return L, wa
