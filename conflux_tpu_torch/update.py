"""Incremental low-rank refresh and serving-side health checks (the port of
`conflux_tpu/update.py`).

With A1 = A0 + U V^H (U, V of shape (N, k), k << N), the Woodbury identity

    A1^{-1} b = A0^{-1} b - A0^{-1} U (I_k + V^H A0^{-1} U)^{-1} V^H A0^{-1} b

turns a drifted solve into the base substitution plus O(N k) work through
the k x k capacitance C = I + V^H A0^{-1} U: `capacitance` assembles the
state, `woodbury_apply` and `woodbury_solve` use it, `updated_matvec` is
the drifted matrix's residual matvec, and `DriftPolicy` says when a true
refactorization should replace the correction (`SolveSession.update` in
`serve`). The base substitution is the caller's: in a blocked serve plan
one K3 round (`hopper_kernels.btrsm_pair`), which the capacitance runs
with the kb columns of U as right-hand sides. Every float32 product here
is IEEE float32 (no TF32, `ops.blas` switches it off), as the JAX package
pins `Precision.HIGHEST`; every function is batch-generic over leading
axes, the port's counterpart of the JAX package's vmap.

The rest is the resilience layer's Freivalds-style output guard: a fixed
Rademacher probe w per size, the session-resident probe row wA = w^T A0
(for least squares the pair (u, uA) of `probe_lstsq`), and the (2,)
verdict [finite_flag, residual] a checked solve returns beside its answer
(per slot, (2, S), for stacked solves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from conflux_tpu_torch.ops import blas


def rank_bucket(k: int) -> int:
    """Next power of two >= k: the program bucket for RHS width (and update
    rank), so a traffic mix of widths builds O(log) programs."""
    if k < 1:
        raise ValueError(f"bucket needs a positive size, got {k}")
    return 1 << (int(k) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """When the Woodbury correction of a drifting session stops paying for
    itself.

    max_rank: accumulated-rank cap (None -> max(8, N // 8)); past it the
        session refactors.
    cond_limit: 1-norm condition cap on the capacitance matrix (a
        non-finite estimate also refactors).
    refine: refinement sweeps added to the plan's own on updated solves,
        their residuals against the drifted matrix.
    """

    max_rank: int | None = None
    cond_limit: float = 1e6
    refine: int = 0

    def resolved_max_rank(self, n: int) -> int:
        if self.max_rank is not None:
            return int(self.max_rank)
        return max(8, n // 8)


def capacitance(base_apply, U, V):
    """The Woodbury state against the base factors: (Y, Cinv, cond1) with
    Y = A0^{-1} U (..., N, k), C = I_k + V^H Y, Cinv = C^{-1} (explicit:
    k is small, and every later solve is then two products) and
    cond1 = ||C||_1 ||C^{-1}||_1, the drift policy's trigger (per system:
    a leading batch axis gives one per system). base_apply(r) applies
    A0^{-1}; zero-padded columns of U, V add an identity block to C."""
    Y = base_apply(U.to(torch.promote_types(U.dtype, torch.float32)))
    cdtype = Y.dtype
    Vc = V.to(cdtype)
    k = U.shape[-1]
    C = torch.eye(k, dtype=cdtype, device=Y.device) + torch.matmul(Vc.mH, Y)
    Cinv = torch.linalg.inv(C)

    def norm1(M):
        return M.abs().sum(-2).amax(-1)
    return Y, Cinv, norm1(C) * norm1(Cinv)


def woodbury_apply(base_apply, Y, Cinv, V, b):
    """A1^{-1} b through the base factors and the capacitance state:
    z - Y (Cinv (V^H z)) with z = A0^{-1} b; b is (..., N, nrhs)."""
    z = base_apply(b)
    w = torch.matmul(V.to(z.dtype).mH, z)
    return z - torch.matmul(Y.to(z.dtype), torch.matmul(Cinv.to(z.dtype), w))


def updated_matvec(A0, U, V, x):
    """(A0 + U V^H) x without forming the drifted matrix: the refinement
    backstop's residual matvec, O(N^2 + N k) a column."""
    cdtype = x.dtype
    w = torch.matmul(V.to(cdtype).mH, x)
    return torch.matmul(A0.to(cdtype), x) + torch.matmul(U.to(cdtype), w)


def woodbury_solve(base_apply, A0, U, V, b, refine: int = 0):
    """Solve (A0 + U V^H) x = b given the base substitution `base_apply`
    (r -> A0^{-1} r); `refine` sweeps take residuals against the drifted
    matrix and correct through the same Woodbury apply. A0 is read only
    when refine > 0 (pass None otherwise). b is (..., N, nrhs)."""
    Y, Cinv, _ = capacitance(base_apply, U, V)
    x = woodbury_apply(base_apply, Y, Cinv, V, b)
    cdtype = x.dtype
    bc = b.to(cdtype)
    for _ in range(refine):
        r = bc - updated_matvec(A0, U, V, x)
        x = x + woodbury_apply(base_apply, Y, Cinv, V, r).to(cdtype)
    return x


def probe_vector(n: int) -> np.ndarray:
    """The fixed Rademacher probe w (host numpy, float32 +-1, the JAX
    package's bits): E[(w . r)^2] = ||r||^2, so the projected residual
    estimates the true one at the same relative scale."""
    rng = np.random.default_rng(0xC0FFEE)
    return rng.choice(np.float32([-1.0, 1.0]), size=n)


def probe_row(w: torch.Tensor, A0: torch.Tensor) -> torch.Tensor:
    """wA = w^T A0, paid once per base matrix; batch-generic over A0's
    leading axes."""
    cdtype = blas.compute_dtype(A0.dtype)
    return torch.matmul(w.to(cdtype), A0.to(cdtype))


def probe_lstsq(w: torch.Tensor, A0: torch.Tensor):
    """(u, uA): the least-squares counterpart of :func:`probe_row` for a
    QR session (M, N). The residual of min ||A x - b|| is not small, it is
    orthogonal to range(A0); so the probe lives in range(A0): u = A0 w,
    normalized to the Rademacher scale ||u|| = sqrt(M), and uA = u^T A0.
    At the least-squares solution u . b - uA . x vanishes, and
    :func:`health_spot_check` takes (u, uA) in the (w, wA) slots."""
    cdtype = blas.compute_dtype(A0.dtype)
    Ac = A0.to(cdtype)
    u = torch.matmul(Ac, w.to(cdtype))
    scale = torch.sqrt(torch.tensor(float(A0.shape[-2]), dtype=cdtype, device=u.device))
    u = u * (scale / (torch.sqrt((u.abs() ** 2).sum()) + torch.finfo(cdtype).tiny))
    return u, torch.matmul(u, Ac)


def _verdict(finite: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    return torch.stack([finite.to(torch.float32), residual.to(torch.float32)])


def _projected(w, wA, x, b, Up, Vp):
    """(num, den) of the projected residual |w . b0 - w^T A1 x0| / ||b0||
    per system, on column 0, with w^T A1 = wA + (w^T Up) Vp^H when the
    drift factors are given (zero-padded columns inert)."""
    cdtype = x[..., 0].dtype
    x0 = x[..., 0].to(cdtype)
    b0 = b[..., 0].to(cdtype)
    wc = w.to(cdtype)
    ax = (wA.to(cdtype) * x0).sum(-1)
    if Up is not None:
        wU = (wc[:, None] * Up.to(cdtype)).sum(-2)
        vx = (Vp.to(cdtype).conj() * x0[..., :, None]).sum(-2)
        ax = ax + (wU * vx).sum(-1)
    num = torch.abs((wc * b0).sum(-1) - ax)
    den = torch.sqrt((b0.abs() ** 2).sum(-1)) + torch.finfo(cdtype).tiny
    return num, den


def health_spot_check(w, wA, x, b, Up=None, Vp=None) -> torch.Tensor:
    """Fused finite/projected-residual verdict of one solve: a (2,) float32
    [finite_flag, residual]. finite_flag is 1.0 iff every element of x is
    finite; residual is |w . b0 - wA . x0| / ||b0|| on column 0 (max over
    leading batch axes), two O(N) dots through the cached probe row instead
    of an O(N^2) residual matvec. Up/Vp (the session's padded drift
    factors) project through the drifted matrix instead."""
    num, den = _projected(w, wA, x, b, Up, Vp)
    return _verdict(torch.isfinite(x.sum()), (num / den).max())


def health_spot_check_slots(w, wA, x, b, Up=None, Vp=None) -> torch.Tensor:
    """Per-slot verdict of a stacked solve: x, b (S, N, w), wA (S, N),
    Up/Vp (S, N, kb). Returns (2, S) float32, row 0 each slot's finite
    flag, row 1 its projected residual; slot i's depends on slot i
    alone, and an idle slot (zero RHS) is finite with residual 0."""
    num, den = _projected(w, wA, x, b, Up, Vp)
    return _verdict(torch.isfinite(x.sum(dim=tuple(range(1, x.dim())))), num / den)


def health_verdict_from_stats(w, xsum, wAx, b) -> torch.Tensor:
    """:func:`health_spot_check`'s verdict from accumulators taken during
    the back substitution (xsum = sum(x), wAx = wA . x[:, 0]), so only the
    two b-side dots remain. Leading batch axes max-reduce."""
    cdtype = wAx.dtype
    finite = torch.isfinite(xsum.sum())
    b0 = b[..., 0].to(cdtype)
    wc = w.to(cdtype)
    num = torch.abs((wc * b0).sum(-1) - wAx)
    den = torch.sqrt((b0.abs() ** 2).sum(-1)) + torch.finfo(cdtype).tiny
    return _verdict(finite, (num / den).max())


def health_verdict_from_stats_slots(w, xsum, wAx, b) -> torch.Tensor:
    """Per-slot verdict from the back substitution's accumulators, the
    stacked counterpart of :func:`health_verdict_from_stats`: xsum, wAx
    (S,), b (S, N, w); returns (2, S)."""
    cdtype = wAx.dtype
    b0 = b[..., 0].to(cdtype)
    wc = w.to(cdtype)
    num = torch.abs((wc * b0).sum(-1) - wAx)
    den = torch.sqrt((b0.abs() ** 2).sum(-1)) + torch.finfo(cdtype).tiny
    return _verdict(torch.isfinite(xsum), num / den)


def pad_update_state(Up, Vp, Y, Cinv, kb: int):
    """One session's Woodbury state zero-padded from its rank bucket
    k0 = Up.shape[-1] up to bucket kb: U, V and Y gain zero columns and
    Cinv extends block-diagonally with the identity, the inverse of the
    capacitance the padded U, V would give (C = [C_k0, 0; 0, I])."""
    k0 = Up.shape[-1]
    if k0 == kb:
        return Up, Vp, Y, Cinv
    if k0 > kb:
        raise ValueError(f"cannot pad rank {k0} down to bucket {kb}")

    def pad(x):
        return torch.nn.functional.pad(x, (0, kb - k0))
    C2 = torch.eye(kb, dtype=Cinv.dtype, device=Cinv.device).expand(
        Cinv.shape[:-2] + (kb, kb)).clone()
    C2[..., :k0, :k0] = Cinv
    return pad(Up), pad(Vp), pad(Y), C2


def zero_update_state(n: int, kb: int, dtype, factor_dtype=None, device="cpu"):
    """The Woodbury state of an undrifted slot at rank bucket kb: zero U,
    V (in `dtype`), zero Y and an identity Cinv (in the compute dtype of
    `factor_dtype`, default `dtype`), whose correction is exactly zero."""
    cdtype = blas.compute_dtype(factor_dtype or dtype)
    z = torch.zeros((n, kb), dtype=dtype, device=device)
    return (z, z, torch.zeros((n, kb), dtype=cdtype, device=device),
            torch.eye(kb, dtype=cdtype, device=device))


def apply_update(A0, U, V):
    """The drifted matrix A0 + U V^H in A0's dtype, the refactor's input:
    one `addmm` (`baddbmm` for a batch) in the compute dtype, so a session
    that updates its own base in place (`addmm_`) gets the same bits."""
    cdtype = blas.compute_dtype(A0.dtype)
    Vh = V.to(cdtype).mH
    add = torch.addmm if A0.dim() == 2 else torch.baddbmm
    return add(A0.to(cdtype), U.to(cdtype), Vh).to(A0.dtype)
