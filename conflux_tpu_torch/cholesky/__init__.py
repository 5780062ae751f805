"""Cholesky factorization — the CONFCHOX side (single device so far)."""

from conflux_tpu_torch.cholesky.single import cholesky_blocked

__all__ = ["cholesky_blocked"]
