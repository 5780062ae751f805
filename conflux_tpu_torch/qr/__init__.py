"""QR factorization: the TSQR tree and CholeskyQR2 on one device
(`single`) and on the process grid (`distributed`: tall-skinny over x and
the block-cyclic loop)."""

from conflux_tpu_torch.qr.distributed import (
    cholesky_qr2_distributed,
    qr_blocked_distributed_host,
    qr_distributed_host,
    qr_factor_distributed,
    qr_factor_steps,
    r_geometry,
    tsqr_distributed,
)
from conflux_tpu_torch.qr.single import cholesky_qr2, qr_factor_blocked, tall_qr

__all__ = [
    "cholesky_qr2",
    "cholesky_qr2_distributed",
    "qr_blocked_distributed_host",
    "qr_distributed_host",
    "qr_factor_blocked",
    "qr_factor_distributed",
    "qr_factor_steps",
    "r_geometry",
    "tall_qr",
    "tsqr_distributed",
]
