"""Debug-build assertions (the port of `conflux_tpu/debug.py`): the
reference's -DDEBUG in-situ checks.

The reference guards its superstep loop with NaN/Inf scans
(`has_valid_data`, `memory_utils.hpp:37-49`, used at
`conflux_opt.hpp:592-601`), post-tournament non-zero-pivot asserts
(`conflux_opt.hpp:793-800`), and a global row-count conservation check
(`conflux_opt.hpp:980-1000`). Here they are host-side helpers over tensors
or arrays; `checked_isfinite` is the in-graph check of the JAX package,
which eager PyTorch runs as a plain check (it reads the verdict back, so
it waits for the card).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def has_valid_data(x) -> bool:
    """NaN/Inf-free scan (reference `memory_utils.hpp:37-49`)."""
    return bool(np.isfinite(_host(x)).all())


def assert_valid(x, what: str = "buffer") -> None:
    if not has_valid_data(x):
        bad = int((~np.isfinite(_host(x))).sum())
        raise FloatingPointError(f"{what} contains {bad} non-finite values")


def assert_nonzero_pivots(LU, what: str = "LU") -> None:
    """Post-factorization zero-pivot check (reference
    `conflux_opt.hpp:793-800`)."""
    d = np.abs(np.diag(_host(LU)))
    if (d == 0).any():
        k = int(np.argmin(d != 0))
        raise ZeroDivisionError(f"{what}: zero pivot at position {k}")


def assert_pivot_conservation(pivots, M: int) -> None:
    """Every row is eliminated exactly once (the row-count conservation
    check, reference `conflux_opt.hpp:980-1000`)."""
    p = _host(pivots).reshape(-1)
    uniq = np.unique(p)
    if uniq.size != p.size:
        raise AssertionError(f"duplicate pivot rows: {p.size - uniq.size}")
    if p.min() < 0 or p.max() >= M:
        raise AssertionError(f"pivot row out of range [0, {M}): {p.min()}..{p.max()}")


def checked_isfinite(x: torch.Tensor, what: str) -> torch.Tensor:
    """Return x, raising FloatingPointError first if it holds a non-finite
    value (the JAX package's jit-time callback, as an eager check)."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"{what}: non-finite values")
    return x
