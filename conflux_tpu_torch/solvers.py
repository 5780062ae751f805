"""Direct solves on the factorization, with iterative refinement (the
single-device half of `conflux_tpu/solvers.py`).

    x = solve(A, b)                                         # direct
    x = solve(A, b, factor_dtype=torch.bfloat16, refine=3)  # HPL-MxP mode

`lu_solve` is the triangular-substitution half for factors from
`lu_factor_blocked`, `cholesky_solve` the same for a lower Cholesky factor;
`refine_classic` is the HPL-MxP recipe's refinement loop (cheap factors,
residuals in a higher precision) and `fgmres` its GMRES-IR engine for
systems where the classic loop stalls. `lu_solve_transposed`,
`slogdet_from_lu`, `cond_estimate_1` and `inv_from_lu` are the LAPACK
getrs-T / det / gecon / getri roles on the same factors. `solve_updated`
solves a drifted system (A + U V^H) x = b through the factors of A alone
(the Woodbury correction, `update`), and `lstsq` is least squares through
the QR route (`qr.single.tall_qr`). The distributed solvers are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.ops import blas


def lu_solve(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given packed LU factors with A[perm] == L @ U (the
    contract of `lu_factor_blocked`, square A). b is (N,) or (N, k)."""
    M, N = LU.shape
    if M != N:
        raise ValueError(
            f"lu_solve needs square factors, got {tuple(LU.shape)} (an M > N "
            "factorization has no unique solve)")
    if b.shape[0] != N:
        raise ValueError(f"b has {b.shape[0]} rows, factors need {N}")
    cdtype = blas.compute_dtype(LU.dtype)
    Lu = LU.to(cdtype)
    squeeze = b.dim() == 1
    b2 = b.to(cdtype)[:, None] if squeeze else b.to(cdtype)
    y = blas.trsm_left_lower_unit(Lu, b2[perm.long()])
    x = blas.trsm_left_upper(Lu, y)
    return x[:, 0] if squeeze else x


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor L (A = L L^T): two
    triangular solves in the compute dtype. b is (N,) or (N, k)."""
    if b.shape[0] != L.shape[0]:
        raise ValueError(f"b has {b.shape[0]} rows, factor needs {L.shape[0]}")
    cdtype = blas.compute_dtype(L.dtype)
    Lc = L.to(cdtype)
    squeeze = b.dim() == 1
    b2 = b.to(cdtype)[:, None] if squeeze else b.to(cdtype)
    y = blas.trsm_left_lower(Lc, b2)
    x = blas.trsm_left_lower_t(Lc, y)
    return x[:, 0] if squeeze else x


def refine_classic(solve_fn, A: torch.Tensor, b: torch.Tensor, sweeps: int,
                   rdtype: torch.dtype, corr_dtype: torch.dtype) -> torch.Tensor:
    """Classic (Richardson) iterative refinement: x0 = solve(b), then
    `sweeps` rounds of x += solve(b - A x). x and b stay in the residual
    precision `rdtype` (a downcast b would make the iteration converge to
    A x = low(b)); only the corrections ride the factors through
    `solve_fn`, cast to `corr_dtype`."""
    b_r = b.to(rdtype)
    x = solve_fn(b.to(corr_dtype)).to(rdtype)
    for _ in range(sweeps):
        r = _residual_strips(A, x, b_r, rdtype)
        x = x + solve_fn(r.to(corr_dtype)).to(rdtype)
    return x


def _residual_strips(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                     rdtype: torch.dtype) -> torch.Tensor:
    """r = b - A x with the matvec accumulated in `rdtype`, casting A one
    row strip at a time (a full (N, N) float64 copy would double the
    matrix footprint)."""
    N = A.shape[0]
    strip = max(1, min(4096, N))
    xr = x.to(rdtype)
    return torch.cat([b[i:i + strip].to(rdtype) - A[i:i + strip].to(rdtype) @ xr
                      for i in range(0, N, strip)])


def _as_2d(b: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (b[:, None], True) if b.dim() == 1 else (b, False)


def _identity_extend(A: torch.Tensor, pad: int) -> torch.Tensor:
    """A padded to N + pad with an identity-extended diagonal (the extra
    rows and columns are decoupled unit pivots)."""
    N = A.shape[0]
    Ap = A.new_zeros((N + pad, N + pad))
    Ap[:N, :N] = A
    idx = torch.arange(N, N + pad, device=A.device)
    Ap[idx, idx] = 1
    return Ap


def _base_solver(Af: torch.Tensor, v: int, spd: bool):
    """Factor Af (LU, or Cholesky with `spd`) and return r -> Af^{-1} r."""
    if spd:
        from conflux_tpu_torch.cholesky.single import cholesky_blocked

        L = cholesky_blocked(Af, v)
        return lambda r: cholesky_solve(L, r)
    from conflux_tpu_torch.lu.single import lu_factor_blocked

    LU, perm = lu_factor_blocked(Af, v)
    return lambda r: lu_solve(LU, perm, r)


def solve(A: torch.Tensor, b: torch.Tensor, *, v: int = 256, factor_dtype=None,
          refine: int = 0, spd: bool = False) -> torch.Tensor:
    """Solve A x = b by blocked factorization plus optional refinement, on
    A's device with the registry's backend and panel algo.

    `factor_dtype` (default A's dtype) is the dtype the factorization runs
    in: bfloat16 with 2-3 `refine` sweeps is the HPL-MxP trade (each
    sweep's residual in A's compute dtype, the correction through the cheap
    factors). `spd` factors by Cholesky. N need not be a multiple of v:
    the system is padded to one with an identity-extended diagonal (the
    extra rows and columns are decoupled unit pivots) and x sliced back.
    """
    N = A.shape[0]
    v = min(v, N)
    pad = (-N) % v
    if pad:
        A = _identity_extend(A, pad)
        b2, squeezed = _as_2d(b)
        b = torch.nn.functional.pad(b2, (0, 0, 0, pad))
        if squeezed:
            b = b[:, 0]
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    solve_corr = _base_solver(A.to(fdtype), v, spd)
    cdtype = blas.compute_dtype(A.dtype)
    Ac, bc = A.to(cdtype), b.to(cdtype)
    x = solve_corr(b).to(cdtype)
    for _ in range(refine):
        x = x + solve_corr(bc - torch.matmul(Ac, x)).to(cdtype)
    return x[:N] if pad else x


def solve_updated(A: torch.Tensor, U: torch.Tensor, V: torch.Tensor, b: torch.Tensor, *,
                  v: int = 256, factor_dtype=None, refine: int = 0,
                  spd: bool = False) -> torch.Tensor:
    """Solve (A + U V^H) x = b through the factors of A alone: A is
    factored once (the `solve` recipe: `v`, `factor_dtype`, `spd` for A
    itself) and the rank-k drift rides a k x k capacitance system
    (`update.woodbury_solve`). U, V are (N, k); `refine` sweeps take their
    residuals against the drifted matrix. N need not be a multiple of v:
    A is identity-extended and U, V gain zero rows, which leave the
    extension's unit pivots alone."""
    from conflux_tpu_torch.update import woodbury_solve

    N = A.shape[0]
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("solve_updated needs a square A")
    if tuple(U.shape) != tuple(V.shape) or U.dim() != 2 or U.shape[0] != N:
        raise ValueError(f"update factors must both be ({N}, k), got {tuple(U.shape)} "
                         f"and {tuple(V.shape)}")
    v = min(v, N)
    pad = (-N) % v
    b2, squeeze = _as_2d(b)
    if pad:
        A = _identity_extend(A, pad)
        U = torch.nn.functional.pad(U, (0, 0, 0, pad))
        V = torch.nn.functional.pad(V, (0, 0, 0, pad))
        b2 = torch.nn.functional.pad(b2, (0, 0, 0, pad))
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    base = _base_solver(A.to(fdtype), v, spd)
    x = woodbury_solve(base, A if refine else None, U, V, b2, refine=refine)
    if pad:
        x = x[:N]
    return x[:, 0] if squeeze else x


def lstsq(A: torch.Tensor, b: torch.Tensor, chunk: int | None = None, passes: int = 2,
          factor_dtype=None, refine: int = 0) -> torch.Tensor:
    """Least squares min_x ||A x - b|| for a tall full-rank A (M >= n)
    through the QR route (`qr.single.tall_qr`): x = R^{-1} (Q^H b).
    `factor_dtype` and `refine` are the HPL-MxP recipe for least squares:
    factor in a cheap dtype (bfloat16 computes its QR in float32 and
    stores Q, R in bfloat16, as the JAX package does), then `refine`
    sweeps of r = b - A x in A's compute dtype, each correction solved
    through the same factors."""
    from conflux_tpu_torch.qr.single import tall_qr

    M = A.shape[0]
    if b.shape[0] != M:
        raise ValueError(f"b has {b.shape[0]} rows, A has {M}")
    Af = A.to(factor_dtype) if factor_dtype is not None else A
    Q, R = tall_qr(Af, chunk=chunk, passes=passes)
    cdtype = blas.compute_dtype(A.dtype)
    Qc, Rc = Q.to(cdtype), R.to(cdtype)
    b2, squeeze = _as_2d(b.to(cdtype))

    def solve_ls(rhs):
        return blas.trsm_left_upper(Rc, torch.matmul(Qc.mH, rhs))

    x = solve_ls(b2)
    if refine:
        Ac = A.to(cdtype)
        for _ in range(refine):
            x = x + solve_ls(b2 - torch.matmul(Ac, x))
    return x[:, 0] if squeeze else x


def fgmres(matvec, precond, b: torch.Tensor, *, args=(), x0=None, tol: float = 1e-6,
           restart: int = 16, max_restarts: int = 12, rdtype=torch.float64):
    """Flexible GMRES with right preconditioning: the GMRES-IR engine.

    Solves A x = b where `matvec(x, *args)` applies A (accumulating in
    `rdtype`) and `precond(r, *args)` applies an approximate inverse,
    typically a low-precision LU solve (classic refinement diverges once
    cond(A) eps_factor nears 1; FGMRES with the same factors converges
    where the preconditioned spectrum clusters). Each restart cycle is the
    Arnoldi process with masked reorthogonalized Gram-Schmidt (CGS2) as a
    loop of tensor ops on b's device; the (m+1, m) least squares of a
    cycle runs on the host in numpy, as the JAX package runs it. `rdtype`
    is explicit (float64 by default): the JAX default follows its x64
    switch, which the port does not have.

    Returns (x, info) with info = {'restarts', 'residual'}, residual the
    ||b - A x|| / ||b|| of the final x, measured with `matvec`.
    """
    b_r = b.to(rdtype)
    N = b_r.shape[0]
    m = int(restart)
    if m < 1:
        raise ValueError(f"restart must be >= 1, got {restart}")
    dev = b_r.device
    x = torch.zeros((N,), dtype=rdtype, device=dev) if x0 is None else x0.to(rdtype)
    done_restarts = 0
    bnorm = float(torch.sqrt((b_r * b_r).sum()))
    if bnorm == 0:
        return x, {"restarts": 0, "residual": 0.0}
    rows = torch.arange(m + 1, device=dev)
    for k in range(max_restarts):
        beta, H, Z = _fgmres_cycle(matvec, precond, m, x, b_r, args, rdtype, rows)
        beta_f = float(beta)
        done_restarts = k + 1
        if beta_f / bnorm <= tol:
            break
        # small (m+1, m) least squares on the host; breakdown columns (a
        # zero subdiagonal) are harmless, lstsq handles the rank
        Hh = H.cpu().numpy().astype(np.float64)
        e1 = np.zeros(m + 1)
        e1[0] = beta_f
        y, *_ = np.linalg.lstsq(Hh, e1, rcond=None)
        x = x + Z.T @ torch.from_numpy(y).to(device=dev, dtype=rdtype)
        # projected residual estimate: no further cycle if this one converged
        if np.linalg.norm(e1 - Hh @ y) / bnorm <= tol:
            break
    r = b_r - matvec(x, *args).to(rdtype)
    rel = float(torch.sqrt((r * r).sum())) / bnorm
    return x, {"restarts": done_restarts, "residual": rel}


def _fgmres_cycle(matvec, precond, m: int, x, b_r, args, rdtype, rows):
    """One restart cycle of :func:`fgmres`: (beta, H (m+1, m), Z (m, N))."""
    N = b_r.shape[0]
    r = b_r - matvec(x, *args).to(rdtype)
    beta = torch.sqrt((r * r).sum())
    V = b_r.new_zeros((m + 1, N))
    V[0] = r / torch.where(beta > 0, beta, 1)
    Z = b_r.new_zeros((m, N))
    H = b_r.new_zeros((m + 1, m))
    for j in range(m):
        z = precond(V[j], *args).to(rdtype)
        w = matvec(z, *args).to(rdtype)
        # masked classical Gram-Schmidt with reorthogonalization (CGS2):
        # two projection passes against the whole basis, rows > j masked
        mask = rows <= j
        h = torch.where(mask, V @ w, 0)
        w = w - V.T @ h
        h2 = torch.where(mask, V @ w, 0)
        w = w - V.T @ h2
        h = h + h2
        hn = torch.sqrt((w * w).sum())
        V[j + 1] = w / torch.where(hn > 0, hn, 1)
        H[:, j] = h
        H[j + 1, j] = hn
        Z[j] = z
    return beta, H, Z


def lu_solve_transposed(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A^T x = b from the packed LU factors of A (the getrs 'T'
    path: A[perm] = L U, so A^T = U^T L^T P and x = P^T (L^T \\ (U^T \\ b)))."""
    N = LU.shape[0]
    if LU.shape[0] != LU.shape[1] or b.shape[0] != N:
        raise ValueError(f"square factors and matching rhs required, got "
                         f"{tuple(LU.shape)} and {tuple(b.shape)}")
    cdtype = blas.compute_dtype(LU.dtype)
    Lu = LU.to(cdtype)
    b2, squeeze = _as_2d(b.to(cdtype))
    z = blas.trsm_left_lower_unit_t(Lu, blas.trsm_left_upper_t(Lu, b2))
    x = torch.empty_like(z)
    x[perm.long()] = z  # apply P^T
    return x[:, 0] if squeeze else x


def slogdet_from_lu(LU, perm):
    """(sign, log|det|) from packed LU factors (the LAPACK getrf -> det
    recipe: det = sign(perm) prod(diag U)), with `np.linalg.slogdet`'s
    conventions: sign 0 for an exactly singular matrix, complex for complex
    input. On the host; the permutation's parity by cycle count."""
    d = torch.as_tensor(LU).diagonal().cpu().numpy()
    p = torch.as_tensor(perm).cpu().numpy()
    n = p.shape[0]
    seen = np.zeros(n, dtype=bool)
    transpositions = 0
    for i in range(n):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = p[j]
            clen += 1
        transpositions += clen - 1
    sign = -1.0 if transpositions % 2 else 1.0
    if (d == 0).any():
        return (0j if np.iscomplexobj(d) else 0.0), float("-inf")
    if np.iscomplexobj(d):
        sign = sign * np.exp(1j * np.angle(d).sum())
    else:
        sign = sign * (-1.0 if int((d < 0).sum()) % 2 else 1.0)
    return sign, float(np.log(np.abs(d)).sum())


def cond_estimate_1(A: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
                    iters: int = 5) -> float:
    """1-norm condition estimate from the factors (the `gecon` role):
    ||A||_1 times Hager's power-iteration estimate of ||A^{-1}||_1, each
    step one solve and one transposed solve through the factors."""
    n = A.shape[0]
    anorm = float(A.abs().sum(0).max())
    x = torch.full((n,), 1.0 / n, dtype=blas.compute_dtype(A.dtype), device=A.device)
    est = 0.0
    iters = max(1, iters)
    for it in range(iters):
        y = lu_solve(LU, perm, x)                      # y = A^{-1} x
        est_new = float(y.abs().sum())
        if est_new <= est:  # converged: skip the dead solve pair
            break
        est = est_new
        if it == iters - 1:  # count exit: the x update has no consumer
            break
        xi = torch.sign(torch.where(y == 0, 1.0, y))
        z = lu_solve_transposed(LU, perm, xi)          # z = A^{-T} xi
        j = int(z.abs().argmax())
        x = torch.zeros_like(x)
        x[j] = 1.0
    return anorm * est


def inv_from_lu(LU: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """A^{-1} from packed LU factors (the `getri` role): the substitutions
    with the identity as the right-hand side."""
    N = LU.shape[0]
    if LU.shape[0] != LU.shape[1]:
        raise ValueError(f"inverse needs square factors, got {tuple(LU.shape)}")
    return lu_solve(LU, perm, torch.eye(N, dtype=LU.dtype, device=LU.device))
