"""The flop sums against a brute count of the blocked loops at small N and
v, and the flagship's numbers."""

import pytest

from portbench import roofline


def _brute_lu(N, v):
    """Multiply-adds of each step's trailing update, entry by entry."""
    flops = 0
    for k in range(0, N, v):
        for i in range(k + v, N):
            for j in range(k + v, N):
                flops += 2 * v
    return flops


def _brute_chol(N, v):
    """The lower triangle's entries (diagonal included) of each step's
    trailing block, v multiply-adds each, less the diagonal's half-count:
    v m^2 a step is the m (m + 1) / 2 entries' 2 v flops, less v m."""
    flops = 0
    for k in range(0, N, v):
        for i in range(k + v, N):
            for j in range(k + v, i + 1):
                flops += 2 * v
        flops -= v * (N - k - v)
    return flops


@pytest.mark.parametrize("N,v", [(64, 8), (96, 32), (40, 8), (16, 16)])
def test_update_flops_match_brute_count(N, v):
    assert roofline.lu_update_work(N, v)[0] == _brute_lu(N, v)
    assert roofline.cholesky_update_work(N, v)[0] == _brute_chol(N, v)


def test_flagship_numbers():
    lu, lu_bytes = roofline.lu_update_work(32768, 1024)
    ch, _ = roofline.cholesky_update_work(32768, 1024)
    assert lu == pytest.approx(2.237e13, rel=1e-3)
    assert ch == pytest.approx(1.118e13, rel=1e-3)
    ms, by = roofline.bound_ms(lu, lu_bytes)
    assert by == "operations" and ms == pytest.approx(333.9, rel=1e-3)
    assert roofline.bound_ms(1.0, 3.35e12) == (1000.0, "bytes")


def test_solve_flops():
    assert roofline.solve_flops(10, 2, 5, 5) == 2 * 100 * 2 * 10
    assert roofline.lu_factor_flops(3) == pytest.approx(18.0)
