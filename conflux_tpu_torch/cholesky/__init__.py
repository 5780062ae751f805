"""Cholesky factorization — the CONFCHOX side: one device (`single`) and
the process grid (`distributed`)."""

from conflux_tpu_torch.cholesky.single import cholesky_blocked

__all__ = ["cholesky_blocked"]
