"""The SPD class of the JAX package's `validation.make_spd_matrix` (the
upstream's `CholeskyIO::generateInputMatrixDistributed`): the symmetric part
of uniform(-1, 1) entries with N added on the diagonal, drawn and
symmetrized on the device in float32. Its condition number is near 1."""

from __future__ import annotations

import torch


def draw(N: int, gen: torch.Generator, device) -> torch.Tensor:
    B = torch.empty((N, N), dtype=torch.float32, device=device)
    B.uniform_(-1.0, 1.0, generator=gen)
    A = B + B.mT
    del B
    A.mul_(0.5)
    A.diagonal().add_(float(N))
    return A
