"""LU factorization with pivoting — the CONFLUX side: one device
(`single`) and the process grid (`distributed`)."""

from conflux_tpu_torch.lu.single import lu_factor_blocked

__all__ = ["lu_factor_blocked"]
