"""Peaks of the card and the work the algorithms need, counted from their
shapes: the benchmark's frozen copy.

The peaks and the bound rule are copied from `chip_smoke.py`
(`PEAK_F32_FLOPS`, `PEAK_BYTES`, `_bound`). The work is counted from N, v
and the right-hand sides, never from the calls the program makes, so a
later program that computes the same result another way is held to the
same count.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense: float32 outside the tensor cores
# (the K1 GEMM computes IEEE float32, and the cells run at precision
# "highest"), and HBM3 bandwidth. Both at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, ms, and which of the two bounds
    it: operations over the peak rate or bytes over the bandwidth."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _trailing_sizes(N: int, v: int) -> list[int]:
    """The trailing block's side after each of the N / v steps."""
    return [N - (k + 1) * v for k in range(N // v)]


def lu_update_work(N: int, v: int, itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes) of LU's trailing updates, every step: the (m, v) by
    (v, m) product into the (m, m) block, m = N - (k+1) v; each input
    byte read once, the block read and written once."""
    flops = sum(2.0 * v * m * m for m in _trailing_sizes(N, v))
    nbytes = sum(float(itemsize) * (2 * m * m + 2 * m * v) for m in _trailing_sizes(N, v))
    return flops, nbytes


def cholesky_update_work(N: int, v: int, itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes) of Cholesky's trailing updates on the lower triangle:
    v m^2 flops a step (half of the full block's 2 v m^2); the lower
    triangle read and written once and the (m, v) panel read once."""
    flops = sum(float(v) * m * m for m in _trailing_sizes(N, v))
    nbytes = sum(float(itemsize) * (m * m + m * v) for m in _trailing_sizes(N, v))
    return flops, nbytes


def lu_factor_flops(N: int) -> float:
    return 2.0 * N ** 3 / 3.0


def cholesky_factor_flops(N: int) -> float:
    return N ** 3 / 3.0


def solve_flops(N: int, nrhs: int, solves: int, residuals: int) -> float:
    """Triangular solves (forward and back: 2 N^2 a column) and residuals
    b - A x (2 N^2 a column)."""
    return 2.0 * N * N * nrhs * (solves + residuals)
