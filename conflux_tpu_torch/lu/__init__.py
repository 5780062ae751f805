"""LU factorization with pivoting — the CONFLUX side (single device so far)."""

from conflux_tpu_torch.lu.single import lu_factor_blocked

__all__ = ["lu_factor_blocked"]
