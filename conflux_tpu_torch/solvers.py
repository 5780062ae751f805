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
the QR route (`qr.single.tall_qr`). `lu_solve_distributed` and
`cholesky_solve_distributed` solve on a process grid from the distributed
factorizations' shards, and `solve_distributed` is the at-scale path:
factor on the grid, solve there, refine (classic or GMRES-IR).
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
    `solve_fn`, cast to `corr_dtype`. One more residual is taken after
    the last sweep, and a RuntimeWarning names a refinement that left
    ||b - A x|| above twice x0's and above sqrt(eps) ||b|| in `rdtype`
    (the factor's error times cond(A) is past 1; below that line the
    residual is at its rounding floor)."""
    b_r = b.to(rdtype)
    x = solve_fn(b.to(corr_dtype)).to(rdtype)
    first = None
    for _ in range(sweeps):
        r = _residual_strips(A, x, b_r, rdtype)
        if first is None:
            first = torch.linalg.norm(r)
        x = x + solve_fn(r.to(corr_dtype)).to(rdtype)
    if sweeps:
        first, last = float(first), float(torch.linalg.norm(_residual_strips(A, x, b_r, rdtype)))
        floor = torch.finfo(rdtype).eps ** 0.5 * float(torch.linalg.norm(b_r))
        if not (last <= 2 * first or last <= floor):
            import warnings

            warnings.warn(
                f"classic refinement diverged: ||b - A x|| went from {first:.3e} to "
                f"{last:.3e} over {sweeps} sweeps; the factor is too coarse for this "
                "matrix's condition (a factor at precision 'highest', or GMRES-IR)",
                RuntimeWarning, stacklevel=3)
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


# --------------------------------------------------------------------------- #
# On a process grid
# --------------------------------------------------------------------------- #


def _check_solve_rhs(geom, b) -> None:
    """Both grid solves read b by padded global position: a shorter rhs is
    refused (pad A and b with an identity extension first)."""
    rows = b.shape[0] if b.dim() else 0
    if rows != geom.N:
        raise ValueError(
            f"rhs has {rows} rows, the (padded) factorization needs {geom.N}; pad the "
            "system identity-extended before factoring")


def _grid_rhs(b, mesh, dtype) -> tuple[torch.Tensor, bool]:
    b = torch.as_tensor(b)
    b2, squeeze = _as_2d(b)
    return b2.to(device=mesh.device, dtype=dtype), squeeze


def _diag_tile_rows(Aloc, k, mesh, v, Px, Py, Nl):
    """Step k's diagonal row tile, shared by the grid solves: its (v, Nl)
    local columns by a sum over x, and its (v, v) diagonal block by a sum
    over y."""
    li = (k // Px) * v
    rows = (Aloc[li:li + v].clone() if mesh.x == k % Px
            else Aloc.new_zeros((v, Nl)))
    mesh.psum(rows, "x")
    lj = (k // Py) * v
    diag = rows[:, lj:lj + v].clone() if mesh.y == k % Py else Aloc.new_zeros((v, v))
    return rows, mesh.psum(diag, "y")


def _replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    return mesh.replicate(x.contiguous(), ("x", "y", "z"))


def _lu_solver(shard: torch.Tensor, perm: torch.Tensor, geom, mesh):
    """:func:`lu_solve_distributed` of one factorization as a function of
    b, for the callers that solve against it more than once (refinement
    sweeps, GMRES-IR). A solve reads each step's diagonal row tile twice,
    forward and back. With Px == 1 a rank holds every step's rows: they
    are views of its shard, and the (v, v) diagonal blocks, summed over y,
    are taken once here (n v^2 elements beside the shard). With Px > 1 a
    row tile is a sum over x, and holding all n of them would take Px times
    the shard, so a solve gathers each one where it reads it."""
    v, Px, Py, Nl, n = geom.v, geom.grid.Px, geom.grid.Py, geom.Nl, geom.n_steps
    Aloc = shard.to(blas.compute_dtype(shard.dtype))  # z-replicated, pivoted order
    if Px == 1:
        tiles = []
        for k in range(n):
            rows, lj = Aloc[k * v:(k + 1) * v], (k // Py) * v
            diag = rows[:, lj:lj + v].clone() if mesh.y == k % Py else Aloc.new_zeros((v, v))
            tiles.append((rows, mesh.psum(diag, "y")))
        tile = tiles.__getitem__
    else:
        def tile(k):
            return _diag_tile_rows(Aloc, k, mesh, v, Px, Py, Nl)
    lc = torch.arange(Nl, device=mesh.device)
    gcol = ((lc // v) * Py + mesh.y) * v + lc % v
    pv = perm.to(mesh.device).long()

    def solve(b) -> torch.Tensor:
        b2, squeeze = _grid_rhs(b, mesh, Aloc.dtype)
        bp = b2[pv]  # rhs in pivoted row order
        yv = torch.zeros_like(bp)
        for k in range(n):
            rows, diag = tile(k)
            s = rows @ torch.where((gcol < k * v)[:, None], yv[gcol], 0)
            mesh.psum(s, "y")
            yv[k * v:(k + 1) * v] = blas.trsm_left_lower_unit(blas.unit_lower(diag),
                                                              bp[k * v:(k + 1) * v] - s)
        xv = torch.zeros_like(bp)
        for k in range(n - 1, -1, -1):
            rows, diag = tile(k)
            s = rows @ torch.where((gcol >= (k + 1) * v)[:, None], xv[gcol], 0)
            mesh.psum(s, "y")
            xv[k * v:(k + 1) * v] = blas.trsm_left_upper(torch.triu(diag),
                                                         yv[k * v:(k + 1) * v] - s)
        xv = _replicated(xv, mesh)
        return xv[:, 0] if squeeze else xv

    return solve


def lu_solve_distributed(shard: torch.Tensor, perm: torch.Tensor, geom, mesh, b) -> torch.Tensor:
    """Solve A x = b on the grid from `lu_factor_distributed`'s outputs,
    every rank together (the reference has no distributed solve). The
    factors are block-cyclic in pivoted row order, so the solve is block
    forward and back substitution over tile steps: per step the diagonal
    tile's v rows are summed over x, each rank dots them against its
    already-solved column entries, and a sum over y completes the inner
    products. b is (N,) or (N, nrhs) (getrs semantics); returns x of b's
    shape on the mesh's device, identical on every rank."""
    if geom.M != geom.N:
        raise ValueError("distributed solve needs a square factorization")
    _check_solve_rhs(geom, torch.as_tensor(b))
    return _lu_solver(shard, perm, geom, mesh)(b)


def cholesky_solve_distributed(shard: torch.Tensor, geom, mesh, b) -> torch.Tensor:
    """Solve A x = b on the grid from `cholesky_factor_distributed`'s shard
    (lower triangle = L), every rank together: block forward substitution
    with L, then block back substitution with L^H (potrs semantics; no
    permutation). b is (N,) or (N, nrhs); returns x of b's shape,
    identical on every rank."""
    _check_solve_rhs(geom, torch.as_tensor(b))
    v, Px, Py, Ml, Nl, n = geom.v, geom.grid.Px, geom.grid.Py, geom.Ml, geom.Nl, geom.Kappa
    dtype = blas.compute_dtype(shard.dtype)
    Aloc = shard.to(dtype)
    b2, squeeze = _grid_rhs(b, mesh, dtype)
    dev = mesh.device
    lr = torch.arange(Ml, device=dev)
    grow = ((lr // v) * Px + mesh.x) * v + lr % v
    lc = torch.arange(Nl, device=dev)
    gcol = ((lc // v) * Py + mesh.y) * v + lc % v
    yv = torch.zeros_like(b2)
    for k in range(n):
        rows, diag = _diag_tile_rows(Aloc, k, mesh, v, Px, Py, Nl)
        s = rows @ torch.where((gcol < k * v)[:, None], yv[gcol], 0)
        mesh.psum(s, "y")
        yv[k * v:(k + 1) * v] = blas.trsm_left_lower(torch.tril(diag),
                                                     b2[k * v:(k + 1) * v] - s)
    xv = torch.zeros_like(b2)
    for k in range(n - 1, -1, -1):
        # column tile k of L: this rank's rows of those v columns
        lj = (k // Py) * v
        cols = (Aloc[:, lj:lj + v].clone(memory_format=torch.contiguous_format)
                if mesh.y == k % Py else Aloc.new_zeros((Ml, v)))
        mesh.psum(cols, "y")
        ahead = torch.where((grow >= (k + 1) * v)[:, None], xv[grow], 0)
        s = (cols.mH if cols.is_complex() else cols.mT) @ ahead
        mesh.psum(s, "x")  # (v, nrhs)
        ld = (k // Px) * v
        diag = cols[ld:ld + v].clone() if mesh.x == k % Px else Aloc.new_zeros((v, v))
        mesh.psum(diag, "x")
        xv[k * v:(k + 1) * v] = blas.trsm_left_lower_t(torch.tril(diag),
                                                       yv[k * v:(k + 1) * v] - s)
    xv = _replicated(xv, mesh)
    return xv[:, 0] if squeeze else xv


def lstsq_distributed(shards, mesh, b, algo: str = "tsqr", chunk: int | None = None,
                      passes: int = 2) -> torch.Tensor:
    """Least squares min_x ||A x - b|| on x-sharded rows, every rank
    together. `shards` is this rank's (Ml, n) row block or the full
    (Px, Ml, n) array (the `qr.distributed` tall layout); b is (M,) or
    (M, k) with M = Px Ml, the whole right-hand side on every rank. TSQR
    (or CholeskyQR2) gives (Q_shard, R); c = Q^H b is one (n, k) sum over
    x, the only communication beyond the factorization's; then
    x = R^{-1} c, identical on every rank."""
    from conflux_tpu_torch.qr.distributed import (
        _row_shard,
        cholesky_qr2_distributed,
        tsqr_distributed,
    )

    A = _row_shard(shards, mesh)
    Ml = A.shape[0]
    Px = mesh.grid.Px
    cdtype = blas.compute_dtype(A.dtype)
    b2, squeeze = _grid_rhs(b, mesh, cdtype)
    if b2.shape[0] != Px * Ml:
        # before the factorization: the error should be free
        raise ValueError(f"b has {b2.shape[0]} rows, shards hold {Px * Ml}")
    if algo == "tsqr":
        Q, R = tsqr_distributed(A, mesh, chunk=chunk, passes=passes)
    elif algo == "cholesky":
        Q, R = cholesky_qr2_distributed(A, mesh, passes=passes)
    else:
        raise ValueError(f"unknown algo {algo!r} (tsqr|cholesky)")
    bl = b2[mesh.x * Ml:(mesh.x + 1) * Ml]
    c = mesh.psum(torch.matmul(Q.to(cdtype).mH, bl).contiguous(), "x")
    x = blas.trsm_left_upper(R.to(cdtype), c)
    return x[:, 0] if squeeze else x


def qr_lstsq_distributed(Q_shard, R_shard, geom, mesh, b) -> torch.Tensor:
    """Least squares min_x ||A x - b|| on the grid from the block-cyclic
    QR factors (`qr.distributed.qr_factor_distributed`'s outputs), every
    rank together: the general-matrix counterpart of
    :func:`lstsq_distributed`. c = Q^H b is one (Nl, k) partial per rank
    summed over x, assembled over y; then R x = c is block back
    substitution over R's own geometry (the grid solves' diagonal-tile
    machinery on the upper factor). b is (M,) or (M, k) at the padded
    geometry's M; x comes back (N,) or (N, k), identical on every rank."""
    from conflux_tpu_torch.qr.distributed import _rank_shard, r_geometry

    b = torch.as_tensor(b)
    rows = b.shape[0] if b.dim() else 0
    if rows != geom.M:
        raise ValueError(f"rhs has {rows} rows, the (padded) factorization needs {geom.M}")
    Q_shard = _rank_shard(Q_shard, geom, mesh, "Q_shards")
    R_shard = _rank_shard(R_shard, r_geometry(geom), mesh, "R_shards")
    v, Px, Py, Ml, Nl = geom.v, geom.grid.Px, geom.grid.Py, geom.Ml, geom.Nl
    dtype = blas.compute_dtype(Q_shard.dtype)
    Qloc, Rloc = Q_shard.to(dtype), R_shard.to(dtype)
    b2, squeeze = _grid_rhs(b, mesh, dtype)
    dev = mesh.device
    lr = torch.arange(Ml, device=dev)
    grow = ((lr // v) * Px + mesh.x) * v + lr % v
    lc = torch.arange(Nl, device=dev)
    gcol = ((lc // v) * Py + mesh.y) * v + lc % v
    part = mesh.psum(torch.matmul(Qloc.mH, b2[grow]).contiguous(), "x")  # (Nl, k)
    cv = torch.zeros((geom.N, b2.shape[1]), dtype=dtype, device=dev)
    cv[gcol] = part
    mesh.psum(cv, "y")  # each y owns disjoint global columns
    xv = torch.zeros_like(cv)
    for k in range(geom.Nt - 1, -1, -1):
        rows, diag = _diag_tile_rows(Rloc, k, mesh, v, Px, Py, Nl)
        s = rows @ torch.where((gcol >= (k + 1) * v)[:, None], xv[gcol], 0)
        mesh.psum(s, "y")
        xv[k * v:(k + 1) * v] = blas.trsm_left_upper(torch.triu(diag),
                                                     cv[k * v:(k + 1) * v] - s)
    xv = _replicated(xv, mesh)
    return xv[:, 0] if squeeze else xv


def _scatter_local(A: torch.Tensor, geom, mesh, dtype) -> torch.Tensor:
    """This rank's (Ml, Nl) block-cyclic shard of an (M, N) matrix on the
    mesh's device, cast to `dtype` (the role of the JAX package's
    `_build_scatter`: no host round trip, no other rank's shard)."""
    blk = geom.local_block(A.to(device=mesh.device), mesh.x, mesh.y)
    return blk.to(dtype).clone(memory_format=torch.contiguous_format)


def _matvec_strips(A: torch.Tensor, x: torch.Tensor, rdtype: torch.dtype) -> torch.Tensor:
    """A @ x accumulated in `rdtype`, casting A one row strip at a time
    (no (N, N) copy in the residual dtype)."""
    N = A.shape[0]
    strip = max(1, min(4096, N))
    xr = x.to(rdtype)
    return torch.cat([A[i:i + strip].to(rdtype) @ xr for i in range(0, N, strip)])


def _gmres_ops(rdtype: torch.dtype):
    """(matvec, precond) of GMRES-IR on the grid: the matrix and the
    factorization's grid solve (`_lu_solver`) ride as fgmres's `args`."""
    def matvec(x, A, solve):
        return _matvec_strips(A, x, rdtype)

    def precond(r, A, solve):
        return solve(r)

    return matvec, precond


def solve_distributed(A, b, *, grid=None, v: int = 1024, mesh=None, refine: int = 0,
                      factor_dtype=None, residual_dtype=torch.float64,
                      panel_chunk: int | None = None, precision=None,
                      segs: tuple = (16, 16), tree: str = "pairwise",
                      ir: str = "classic", tol: float = 1e-6, restart: int = 16,
                      max_restarts: int = 12, backend: str | None = None,
                      panel_algo: str | None = None, device=None):
    """Factor + solve + iterative refinement on a process grid, every rank
    together: the at-scale solve path. Each rank takes its shard of A (the
    (N, N) original, on every rank), the factorization and the triangular
    solves run on the grid, and each refinement sweep computes r = b - A x
    in `residual_dtype` (float64 by default: the JAX package's default
    when its x64 switch is on), strip-wise.

    `ir="gmres"` runs GMRES-IR (FGMRES preconditioned by the grid solve,
    `tol`/`restart`/`max_restarts`; `refine` is ignored there), which
    converges where classic refinement diverges (cond(A) eps_factor ~ 1).
    `factor_dtype` (bfloat16: the HPL-MxP fast factor), `panel_chunk`,
    `precision`, `segs`, `tree`, `backend` and `panel_algo` reach the
    factorization; the residuals and the sweeps stay IEEE, with float64
    residuals. `precision="high"` on backend "xla" runs the factor's
    library products as one TF32 pass on the card (unit roundoff 2^-11),
    and such a factor is no HPL-MxP factor on a matrix like bench.py's
    (randn + 2 I): on an H100 at N=16384 three classic sweeps diverged to
    ||A x - b|| / ||b|| = 4.981e3 and GMRES-IR stalled at 0.889, where the
    HIGHEST factor reached 1.023e-8 (chip_smoke.py phase 41). Classic
    refinement that leaves the residual above the unrefined solve's warns
    (RuntimeWarning), as a GMRES-IR stall does.
    `grid` defaults to `choose_grid` over the world's ranks, `mesh` to
    `make_mesh(grid, device=device)`. Returns x (N,) in the residual
    dtype, identical on every rank."""
    import warnings

    from conflux_tpu_torch.geometry import LUGeometry, choose_grid
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.parallel.mesh import make_mesh

    A = torch.as_tensor(A)
    N = A.shape[0]
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("solve_distributed needs a square A")
    if ir not in ("classic", "gmres"):
        # before the O(N^3) factorization: a typo fails in microseconds
        raise ValueError(f"unknown ir {ir!r} (classic|gmres)")
    if grid is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        grid = choose_grid(world, N, N)
    geom = LUGeometry.create(N, N, v, grid)
    if (geom.M, geom.N) != (N, N):
        raise ValueError(
            f"N={N} must be a multiple of v*Px and v*Py (got padding to "
            f"{geom.M}x{geom.N}); pre-pad with an identity extension")
    if mesh is None:
        mesh = make_mesh(grid, device=device)
    A = A.to(mesh.device)
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    cdtype = blas.compute_dtype(A.dtype)
    shard = _scatter_local(A, geom, mesh, fdtype)
    out, perm = lu_factor_distributed(shard, geom, mesh, precision, backend,
                                      panel_algo=panel_algo, panel_chunk=panel_chunk,
                                      donate=True, segs=segs, tree=tree)
    b = torch.as_tensor(b).to(mesh.device)
    _check_solve_rhs(geom, b)
    solve = _lu_solver(out, perm, geom, mesh)  # every solve below goes through it
    if ir == "gmres":
        matvec, precond = _gmres_ops(residual_dtype)
        x, info = fgmres(matvec, precond, b.to(residual_dtype), args=(A, solve),
                         tol=tol, restart=restart, max_restarts=max_restarts,
                         rdtype=residual_dtype)
        if info["residual"] > tol:
            warnings.warn(
                f"GMRES-IR stalled at residual {info['residual']:.3e} (> tol {tol:.1e}) "
                f"after {info['restarts']} restarts; raise max_restarts/restart or "
                "improve the factors", RuntimeWarning, stacklevel=2)
        return x
    return refine_classic(solve, A, b, refine, residual_dtype, cdtype)
