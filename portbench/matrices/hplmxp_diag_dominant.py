"""HPL-MxP's class of matrix (https://hpl-mxp.org): a random matrix made
diagonally dominant, so that its LU factorization is stable and mixed-
precision refinement converges on every draw. Entries uniform(-0.5, 0.5),
HPL's range; each diagonal entry then set to the sum of the absolute
values of its row as drawn. Drawn on the device in float32.

Its condition number is about (N/4 + r) / (N/4 - r), N/4 the diagonal's
mean and r ~ sqrt(N/3) the off-diagonal part's largest singular value:
1.03 at N = 32768, at any seed. Partial pivoting keeps every row in place.
The JAX package's LU test class (uniform(-1, 1) + 2 I) has a heavy-tailed
condition number at that N, on which no fixed number of classic sweeps
of a float32 factor reaches 1e-6 on every draw (PERF.md)."""

from __future__ import annotations

import torch


def draw(N: int, gen: torch.Generator, device) -> torch.Tensor:
    A = torch.empty((N, N), dtype=torch.float32, device=device)
    A.uniform_(-0.5, 0.5, generator=gen)
    A.diagonal().copy_(torch.linalg.vector_norm(A, ord=1, dim=1))
    return A
