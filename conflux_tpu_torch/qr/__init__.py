"""QR factorization: the TSQR tree and CholeskyQR2 (single device so far)."""

from conflux_tpu_torch.qr.single import cholesky_qr2, qr_factor_blocked, tall_qr

__all__ = ["cholesky_qr2", "qr_factor_blocked", "tall_qr"]
