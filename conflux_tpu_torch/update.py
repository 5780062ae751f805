"""Serving-side health checks and drift policy (the port of the non-Woodbury
part of `conflux_tpu/update.py`).

`rank_bucket` sizes the serve programs' buckets; `DriftPolicy` is the
session's drift knob set, kept as data (the Sherman-Morrison-Woodbury
`update` path it governs is not ported yet). The rest is the resilience
layer's Freivalds-style output guard: a fixed Rademacher probe w per size,
the session-resident probe row wA = w^T A0, and the (2,) verdict
[finite_flag, residual] a checked solve returns beside its answer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from conflux_tpu_torch.ops import blas


def rank_bucket(k: int) -> int:
    """Next power of two >= k: the program bucket for RHS width (and update
    rank), so a traffic mix of widths builds O(log) programs."""
    if k < 1:
        raise ValueError(f"bucket needs a positive size, got {k}")
    return 1 << (int(k) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """When the Woodbury correction of a drifting session stops paying for
    itself (data only: the update path is not ported yet).

    max_rank: accumulated-rank cap (None -> max(8, N // 8)).
    cond_limit: 1-norm condition cap on the capacitance matrix.
    refine: refinement sweeps added to the plan's own on updated solves.
    """

    max_rank: int | None = None
    cond_limit: float = 1e6
    refine: int = 0

    def resolved_max_rank(self, n: int) -> int:
        if self.max_rank is not None:
            return int(self.max_rank)
        return max(8, n // 8)


def probe_vector(n: int) -> np.ndarray:
    """The fixed Rademacher probe w (host numpy, float32 +-1, the JAX
    package's bits): E[(w . r)^2] = ||r||^2, so the projected residual
    estimates the true one at the same relative scale."""
    rng = np.random.default_rng(0xC0FFEE)
    return rng.choice(np.float32([-1.0, 1.0]), size=n)


def probe_row(w: torch.Tensor, A0: torch.Tensor) -> torch.Tensor:
    """wA = w^T A0, paid once per base matrix; batch-generic over A0's
    leading axes."""
    cdtype = blas.compute_dtype(A0.dtype)
    return torch.matmul(w.to(cdtype), A0.to(cdtype))


def _verdict(finite: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    return torch.stack([finite.to(torch.float32), residual.to(torch.float32)])


def health_spot_check(w, wA, x, b) -> torch.Tensor:
    """Fused finite/projected-residual verdict of one solve: a (2,) float32
    [finite_flag, residual]. finite_flag is 1.0 iff every element of x is
    finite; residual is |w . b0 - wA . x0| / ||b0|| on column 0 (max over
    leading batch axes), two O(N) dots through the cached probe row instead
    of an O(N^2) residual matvec. (The JAX package's Up/Vp drift terms
    come with the Woodbury update path.)"""
    cdtype = x[..., 0].dtype
    finite = torch.isfinite(x.sum())
    x0 = x[..., 0].to(cdtype)
    b0 = b[..., 0].to(cdtype)
    wc = w.to(cdtype)
    ax = (wA.to(cdtype) * x0).sum(-1)
    num = torch.abs((wc * b0).sum(-1) - ax)
    den = torch.sqrt((b0.abs() ** 2).sum(-1)) + torch.finfo(cdtype).tiny
    return _verdict(finite, (num / den).max())


def health_verdict_from_stats(w, xsum, wAx, b) -> torch.Tensor:
    """:func:`health_spot_check`'s verdict from accumulators taken during
    the back substitution (xsum = sum(x), wAx = wA . x[:, 0]), so only the
    two b-side dots remain. Leading batch axes max-reduce."""
    cdtype = wAx.dtype
    finite = torch.isfinite(xsum.sum())
    b0 = b[..., 0].to(cdtype)
    wc = w.to(cdtype)
    num = torch.abs((wc * b0).sum(-1) - wAx)
    den = torch.sqrt((b0.abs() ** 2).sum(-1)) + torch.finfo(cdtype).tiny
    return _verdict(finite, (num / den).max())
