"""Blocked batched triangular solves (the port of
`conflux_tpu/ops/batched_trsm.py`).

Split the triangular axis into `bs`-wide blocks, invert only the (bs, bs)
diagonal blocks (once, at factor time), and substitute block by block, so
each of the O(n / bs) steps is one (bs, bs) product against a diagonal
inverse plus one trailing-panel product: N serial one-column substitutions
become O(N / bs) batched GEMMs, with error growth bounded by the diagonal
blocks' conditioning instead of cond(L) cond(U).

Two implementations share the contract:

- the block loop of `torch.matmul` (:func:`blocked_solve`,
  :func:`blocked_solve_probe`), batch-generic: leading batch axes take the
  place of the JAX package's `vmap`. It is K3's plain version,
  `hopper_kernels.btrsm_plain`;
- the hand-written CUDA kernel K3 (`hopper_kernels.btrsm`, and
  `hopper_kernels.btrsm_pair` for a whole solve round), which runs the
  step loop in a thread-block cluster per system with the running
  right-hand side in shared memory. :func:`blocked_trsm` sends every
  operand there (the plain version on a CPU tensor).
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import hopper_kernels


def default_block_size(n: int) -> int:
    """The deterministic block width for an (n, n) triangle: 32, shrunk to
    the next power of two >= n for tiny systems. A function of n only: the
    diagonal-inverse stack's shape is part of a blocked plan's factors, so
    it must be the same in every process."""
    if n < 1:
        raise ValueError(f"triangular solve needs n >= 1, got {n}")
    return min(32, 1 << (int(n) - 1).bit_length())


def _nblocks(n: int, bs: int) -> int:
    return -(-n // bs)


def _pad_identity(T: torch.Tensor, np_: int) -> torch.Tensor:
    """Extend an (..., n, n) triangle to (..., np_, np_) with an identity
    tail: pad rows solve to exactly zero against a zero right-hand-side pad
    and couple into no real row, so padded answers slice back bitwise."""
    n = T.shape[-1]
    if np_ == n:
        return T
    Tp = T.new_zeros(T.shape[:-2] + (np_, np_))
    Tp[..., :n, :n] = T
    idx = torch.arange(n, np_, device=T.device)
    Tp[..., idx, idx] = 1
    return Tp


def diag_block_inverses(T: torch.Tensor, *, lower: bool = True,
                        unit_diagonal: bool = False,
                        block_size: int | None = None) -> torch.Tensor:
    """Invert the (bs, bs) diagonal blocks of an (..., n, n) triangle: the
    factor-time half of the blocked engine. Returns (..., nb, bs, bs)
    triangular inverses (nb = ceil(n / bs), the tail block identity-
    extended). T may be a packed factor: each block is masked to its
    triangle first, and `unit_diagonal=True` rebuilds the implicit unit
    diagonal. One batched triangular solve against the identity."""
    n = T.shape[-1]
    bs = default_block_size(n) if block_size is None else int(block_size)
    nb = _nblocks(n, bs)
    Tp = _pad_identity(T, nb * bs)
    D = torch.stack([Tp[..., i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
                     for i in range(nb)], dim=-3)
    eye = torch.eye(bs, dtype=D.dtype, device=D.device)
    if unit_diagonal:
        D = (torch.tril(D, -1) if lower else torch.triu(D, 1)) + eye
    else:
        D = torch.tril(D) if lower else torch.triu(D)
    return torch.linalg.solve_triangular(D, eye.expand(D.shape), upper=not lower)


def blocked_solve(T, dinv, b, *, lower: bool = True, precision=None):
    """Blocked substitution with precomputed diagonal-block inverses
    (`dinv` from :func:`diag_block_inverses`). T is (..., n, n) (packed
    factors fine), b is (..., n, k); leading axes are batch axes. The
    block loop is K3's plain version, `hopper_kernels.btrsm_plain`, run in
    promote(T.dtype, b.dtype), its products the library's at `precision`
    (None: HIGHEST, as the JAX package's; `blas.matmul`)."""
    from conflux_tpu_torch.ops import blas

    dt = torch.promote_types(T.dtype, b.dtype)
    p = blas.Precision.HIGHEST if precision is None else blas.resolve_precision(precision)
    return hopper_kernels.btrsm_plain(T.to(dt), dinv.to(dt), b.to(dt), lower,
                                      matmul=lambda x, y: blas.matmul(x, y, p))


def probe_stats(x, wA, stats_dtype=None):
    """The Freivalds stats of a solve's x (..., n, k), per system:
    xsum = sum(x) (NaN/Inf anywhere in x poisons it) and wAx = wA . x[..., 0],
    both in `stats_dtype` (x's dtype by default)."""
    xc = x if stats_dtype is None else x.to(stats_dtype)
    return xc.sum(dim=(-2, -1)), (wA.to(xc.dtype) * xc[..., 0]).sum(-1)


def blocked_solve_probe(T, dinv, b, wA, *, lower: bool = False,
                        precision=None, stats_dtype=None):
    """:func:`blocked_solve` plus the Freivalds probe stats of its x:
    returns (x, xsum, wAx) (:func:`probe_stats`). The JAX package
    accumulates the stats inside its block loop, as K3's round does
    (`hopper_kernels.btrsm_pair`); here they are taken from x after the
    loop. Defaults to the back solve, the last of a factorization's
    substitutions."""
    x = blocked_solve(T, dinv, b, lower=lower, precision=precision)
    return (x, *probe_stats(x, wA, stats_dtype))


def blocked_trsm(T, b, *, lower: bool = True, unit_diagonal: bool = False,
                 dinv=None, block_size: int | None = None, precision=None,
                 backend: str | None = None):
    """Solve T x = b for a triangle or a batch of triangles: the public
    blocked-trsm entry (also `blas.blocked_trsm`).

    T is (n, n) or (B, n, n); b matches with an optional trailing RHS axis
    ((n,), (n, k), (B, n), (B, n, k)); x comes back in b's shape. `dinv`
    passes precomputed diagonal-block inverses (per system, or stacked
    (B, nb, bs, bs)), computed here when omitted. The solve is the K3
    kernel's on either backend, a single triangle as a batch of one; K3
    computes in IEEE float32 at every `precision`, as the JAX package's
    Pallas substitution takes none (a name it does not know raises)."""
    from conflux_tpu_torch.ops import blas

    if T.dim() not in (2, 3) or T.shape[-1] != T.shape[-2]:
        raise ValueError(f"T must be (n, n) or (B, n, n), got {tuple(T.shape)}")
    batched = T.dim() == 3
    squeeze = b.dim() == T.dim() - 1
    if squeeze:
        b = b[..., None]
    if b.dim() != T.dim() or b.shape[:-1] != T.shape[:-1]:
        raise ValueError(f"rhs {tuple(b.shape)} does not match T {tuple(T.shape)}")
    blas.check_backend(blas.get_backend() if backend is None else backend)
    blas.resolve_precision(precision)
    if dinv is None:
        dinv = diag_block_inverses(T, lower=lower, unit_diagonal=unit_diagonal,
                                   block_size=block_size)
    if batched:
        x = hopper_kernels.btrsm(T, dinv, b, lower=lower)
    else:
        x = hopper_kernels.btrsm(T[None], dinv[None], b[None], lower=lower)[0]
    return x[..., 0] if squeeze else x
