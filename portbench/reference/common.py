"""What the plain references share: the float64 residual, the TF32
rounding of a product's operands, and the refinement loop.

Plain PyTorch, written for the benchmark: nothing here imports the port or
takes anything the port made. The residual is computed as the port's
`solvers._residual_strips` computes it (float64, one row strip of A cast
at a time, so no (N, N) float64 copy), rewritten here so that the
yardstick does not move when the program does.
"""

from __future__ import annotations

import torch

STRIP = 4096


def no_tf32() -> None:
    """IEEE float32 products: on the card a float32 matmul may run in TF32
    unless these are off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def residual(A: torch.Tensor, X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """B - A X in float64, A cast one row strip at a time. X and B are
    (N,) or (N, k)."""
    X64 = X.to(torch.float64)
    return torch.cat([B[i:i + STRIP].to(torch.float64) - A[i:i + STRIP].to(torch.float64) @ X64
                      for i in range(0, A.shape[0], STRIP)])


def relative_residuals(A: torch.Tensor, X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """||b - A x||_2 / ||b||_2 of each column (one value for a vector b):
    the repo's solve bar (BASELINE.md, HPL-MxP's 1e-6)."""
    R = residual(A, X, B)
    B64 = B.to(torch.float64)
    if R.dim() == 1:
        return (torch.linalg.norm(R) / torch.linalg.norm(B64)).reshape(1)
    return torch.linalg.norm(R, dim=0) / torch.linalg.norm(B64, dim=0)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TensorFloat-32 (10 explicit mantissa bits, round
    to nearest even), as the tensor cores read a TF32 product's operands:
    the unit roundoff goes from 2^-24 to 2^-11."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b in IEEE float32, or as a TF32 product (operands rounded,
    float32 accumulation)."""
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def refine(solve, A: torch.Tensor, B: torch.Tensor, sweeps: int) -> torch.Tensor:
    """x0 = solve(b), then `sweeps` rounds of x += solve(b - A x) with the
    residual in float64 and the correction in float32 (the HPL-MxP
    recipe)."""
    X = solve(B.to(torch.float32)).to(torch.float64)
    for _ in range(sweeps):
        X = X + solve(residual(A, X, B).to(torch.float32)).to(torch.float64)
    return X
