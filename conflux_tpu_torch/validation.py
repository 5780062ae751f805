"""Correctness oracles: factorization residuals and test matrices (the
single-device half of `conflux_tpu/validation.py`, the reference's
CONFLUX_WITH_VALIDATION role).

`lu_residual` and `cholesky_residual` are the host numpy oracles.
`lu_residual_device` and `cholesky_residual_device` compute the same
normalized residuals where the factors lie, in float64 row and column
strips, so a full-size check needs neither a host product nor an (N, N)
float64 copy of anything; `qr_residual_device` gives a QR's reconstruction
and orthogonality residuals the same way. `lu_residual_distributed` and
`cholesky_residual_distributed` are the same oracles on a process grid,
every rank holding its own shards: nothing (M, N)-sized exists anywhere.
"""

from __future__ import annotations

import numpy as np
import torch


def lu_residual(A, LU, perm) -> float:
    """Normalized ||A[perm] - L U||_F / ||A||_F for packed LU factors, on the
    host. L is (M, K) unit-lower and U (K, N) upper with K = min(M, N)."""
    A = np.asarray(A)
    LU = np.asarray(LU)
    perm = np.asarray(perm)
    M, N = LU.shape
    K = min(M, N)
    L = np.tril(LU, -1)[:, :K] + np.eye(M, K, dtype=LU.dtype)
    U = np.triu(LU[:K, :])
    R = A[perm, :] - L @ U
    return float(np.linalg.norm(R) / max(np.linalg.norm(A), 1e-30))


def lu_residual_device(A: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
                       strip: int = 4096) -> float:
    """:func:`lu_residual` computed on the factors' device in float64.

    A is the matrix that was factored (original row order, any float dtype,
    on LU's device). Each (strip x strip) block of L U is the product of an
    L row strip and a U column strip, cut to the k range where both can be
    nonzero; A[perm] is gathered one row strip at a time. Peak extra memory
    is a few float64 strips.
    """
    M, N = LU.shape
    K = min(M, N)
    perm = perm.to(LU.device).long()
    cols = torch.arange(K, device=LU.device)
    rss = torch.zeros((), dtype=torch.float64, device=LU.device)
    ass = torch.zeros((), dtype=torch.float64, device=LU.device)
    for j in range(0, N, strip):
        je = min(j + strip, N)
        kj = min(je, K)  # U[k, j:je] is zero for k >= je
        Uj = torch.triu(LU[:kj, j:je].double(), diagonal=-j)
        for i in range(0, M, strip):
            ie = min(i + strip, M)
            kmax = min(kj, ie)  # L[i:ie, k] is zero for k >= ie
            Li = LU[i:ie, :kmax].double()
            rows = torch.arange(i, ie, device=LU.device)[:, None]
            Li = torch.where(rows > cols[None, :kmax], Li, 0.0)
            Li += (rows == cols[None, :kmax]).double()
            Ai = A[perm[i:ie], j:je].double()
            R = Ai - Li @ Uj[:kmax]
            rss += (R * R).sum()
            ass += (Ai * Ai).sum()
    return float(torch.sqrt(rss) / torch.clamp(torch.sqrt(ass), min=1e-30))


def cholesky_residual(A, L) -> float:
    """Normalized ||A - L L^H||_F / ||A||_F for a lower Cholesky factor, on
    the host (L's strict upper triangle is ignored; ^H == ^T for real
    dtypes)."""
    A = np.asarray(A)
    L = np.tril(np.asarray(L))
    R = A - L @ L.conj().T
    return float(np.linalg.norm(R) / max(np.linalg.norm(A), 1e-30))


def cholesky_residual_device(A: torch.Tensor, L: torch.Tensor,
                             strip: int = 4096) -> float:
    """:func:`cholesky_residual` computed on the factor's device in float64.

    A is the matrix that was factored (any float dtype, on L's device).
    Each (strip x strip) block of L L^T is the product of two L row strips,
    cut to the k range where both can be nonzero and masked to the lower
    triangle. Peak extra memory is a few float64 strips.
    """
    N = L.shape[0]
    rss = torch.zeros((), dtype=torch.float64, device=L.device)
    ass = torch.zeros((), dtype=torch.float64, device=L.device)
    for j in range(0, N, strip):
        je = min(j + strip, N)
        for i in range(0, N, strip):
            ie = min(i + strip, N)
            k = min(ie, je)  # L[r, c] is zero for c > r
            Li = torch.tril(L[i:ie, :k].double(), diagonal=i)
            Lj = torch.tril(L[j:je, :k].double(), diagonal=j)
            Ai = A[i:ie, j:je].double()
            R = Ai - Li @ Lj.T
            rss += (R * R).sum()
            ass += (Ai * Ai).sum()
    return float(torch.sqrt(rss) / torch.clamp(torch.sqrt(ass), min=1e-30))


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def qr_residual_device(A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
                       strip: int = 4096) -> tuple[float, float]:
    """(||A - Q R||_F / ||A||_F, ||Q^H Q - I||_F / sqrt(N)) of a thin QR
    (A, Q (M, N), R (N, N) upper) on the factors' device, in float64
    (complex128 for complex input): the one-device counterpart of the JAX
    package's `qr_residual_distributed`. One pass per column strip J of
    width `strip`: over the row strips i, the block A_iJ - Q_i R_J (R_J
    cut to its rows that can be nonzero) and the Gram strip Q^H Q_J
    accumulate; nothing (M, N) or (N, N) is formed."""
    M, N = Q.shape
    dev = Q.device
    rss = torch.zeros((), dtype=torch.float64, device=dev)
    ass = torch.zeros((), dtype=torch.float64, device=dev)
    oss = torch.zeros((), dtype=torch.float64, device=dev)
    for j in range(0, N, strip):
        je = min(j + strip, N)
        RJ = torch.triu(_wide(R[:je, j:je]), diagonal=-j)  # R[r, c] is zero for r > c
        G = None
        for i in range(0, M, strip):
            ie = min(i + strip, M)
            Qi = _wide(Q[i:ie])
            Ai = _wide(A[i:ie, j:je])
            E = Ai - Qi[:, :je] @ RJ
            rss += (E.abs() ** 2).sum()
            ass += (Ai.abs() ** 2).sum()
            g = Qi.mH @ Qi[:, j:je]
            G = g if G is None else G + g
        idx = torch.arange(j, je, device=dev)
        G[idx, idx - j] -= 1
        oss += (G.abs() ** 2).sum()
    rec = torch.sqrt(rss) / torch.clamp(torch.sqrt(ass), min=1e-30)
    return float(rec), float(torch.sqrt(oss) / np.sqrt(N))


def _norm_ratio(R_parts, A: torch.Tensor, mesh) -> float:
    """sqrt(sum |R|^2 / sum |A|^2) over the (x, y) plane of the grid: each
    rank's sums in float64 row strips (no float64 copy of a shard), summed
    over (x, y); the z layers hold the same sums."""
    sums = torch.zeros(2, dtype=torch.float64, device=A.device)
    for R in R_parts:
        sums[0] += (_wide(R).abs() ** 2).sum()
    for i in range(0, A.shape[0], 4096):
        sums[1] += (_wide(A[i:i + 4096]).abs() ** 2).sum()
    mesh.psum(sums, ("x", "y"))
    return float(torch.sqrt(sums[0]) / torch.clamp(torch.sqrt(sums[1]), min=1e-30))


def _grid_index(geom, mesh, dev):
    """(gp, gcol, first_row, first_col): the global index of every local row
    and column of this rank, and the first local row (column) whose tile
    index is at least t, as functions of t."""
    from conflux_tpu_torch.geometry import first_local_tile

    v, Px, Py = geom.v, geom.grid.Px, geom.grid.Py
    lr = torch.arange(geom.Ml, device=dev)
    lc = torch.arange(geom.Nl, device=dev)
    gp = ((lr // v) * Px + mesh.x) * v + lr % v
    gcol = ((lc // v) * Py + mesh.y) * v + lc % v
    return (gp, gcol, lambda t: min(first_local_tile(t, mesh.x, Px) * v, geom.Ml),
            lambda t: min(first_local_tile(t, mesh.y, Py) * v, geom.Nl))


def lu_residual_distributed(A_shard: torch.Tensor, LU_shard: torch.Tensor,
                            perm: torch.Tensor, geom, mesh) -> float:
    """Gather-free ||A[perm] - L U||_F / ||A||_F on the grid, every rank
    together (the reference's ScaLAPACK validation role: COSTA transforms
    + two `pdgemm_` calls, `examples/conflux_miniapp.cpp:404-500`).

    A_shard: this rank's shard of the original matrix (original row
    order); LU_shard, perm: `lu_factor_distributed`'s outputs (factors in
    pivoted order). Two passes of (v, Nl)/(Ml, v)-sized collectives:

      1. SUMMA product: for each column tile t, the owner column of L and
         the owner row of U are summed over y and over x, and every rank
         accumulates its share of L U (its rows and columns that tile t
         reaches: the rest of the product is zero);
      2. row permutation: for each tile t of positions, the original rows
         A[perm[t v:(t+1) v]] are summed over x and handed to the
         position's owner, the pattern of the factorization's pivot rows.

    Products in the compute dtype (float32 for bfloat16 storage) with TF32
    off, as the JAX package's HIGHEST matmuls."""
    from conflux_tpu_torch.lu.distributed import _take_rows
    from conflux_tpu_torch.ops.blas import compute_dtype

    v, Px, Py = geom.v, geom.grid.Px, geom.grid.Py
    Ml, Nl = geom.Ml, geom.Nl
    dev = LU_shard.device
    dtype = compute_dtype(LU_shard.dtype)
    Aloc, LUloc = A_shard.to(dtype), LU_shard.to(dtype)
    gp, gcol, frow, fcol = _grid_index(geom, mesh, dev)
    prod = torch.zeros((Ml, Nl), dtype=dtype, device=dev)
    for t in range(geom.Nt):
        rt, ct = frow(t), fcol(t)
        colt = t * v + torch.arange(v, device=dev)
        ly, lx = (t // Py) * v, (t // Px) * v
        if mesh.y == t % Py:
            Lcol = torch.where(gp[rt:, None] > colt[None, :], LUloc[rt:, ly:ly + v], 0)
            Lcol += (gp[rt:, None] == colt[None, :]).to(dtype)
        else:
            Lcol = torch.zeros((Ml - rt, v), dtype=dtype, device=dev)
        mesh.psum(Lcol, "y")
        if mesh.x == t % Px and lx < Ml:
            Urow = torch.where(colt[:, None] <= gcol[None, ct:], LUloc[lx:lx + v, ct:], 0)
        else:
            Urow = torch.zeros((v, Nl - ct), dtype=dtype, device=dev)
        mesh.psum(Urow, "x")
        if rt < Ml and ct < Nl:
            prod[rt:, ct:].addmm_(Lcol, Urow)
    Ap = torch.zeros((Ml, Nl), dtype=dtype, device=dev)
    perm = perm.to(dev).long()
    for t in range(geom.Mt):
        pv = perm[t * v:(t + 1) * v]  # original rows (A is in original order)
        owned = (pv // v) % Px == mesh.x
        li = torch.where(owned, ((pv // v) // Px) * v + pv % v, Ml)
        rows = mesh.psum(_take_rows(Aloc, li, Ml), "x")
        if mesh.x == t % Px:
            Ap[(t // Px) * v:(t // Px + 1) * v] = rows
    return _norm_ratio((Ap[i:i + 4096] - prod[i:i + 4096] for i in range(0, Ml, 4096)),
                       Aloc, mesh)


def cholesky_residual_distributed(A_shard: torch.Tensor, L_shard: torch.Tensor,
                                  geom, mesh) -> float:
    """Gather-free ||A - L L^H||_F / ||A||_F on the grid, every rank
    together: the Cholesky counterpart of :func:`lu_residual_distributed`.
    One SUMMA pass: for each column tile t, the lower-triangular column
    slab of L is summed over y, and its rows for this rank's columns come
    from their x-owners by a sum over x (the factorization's scatterA11
    exchange); every rank accumulates its share of L L^H."""
    from conflux_tpu_torch.ops.blas import compute_dtype

    v, Px, Py = geom.v, geom.grid.Px, geom.grid.Py
    Ml, Nl = geom.Ml, geom.Nl
    dev = L_shard.device
    dtype = compute_dtype(L_shard.dtype)
    Aloc, Lloc = A_shard.to(dtype), L_shard.to(dtype)
    gp, gcol, frow, fcol = _grid_index(geom, mesh, dev)
    col_owner_x = (gcol // v) % Px
    col_local_row = ((gcol // v) // Px) * v + gcol % v
    prod = torch.zeros((Ml, Nl), dtype=dtype, device=dev)
    for t in range(geom.Kappa):
        rt, ct = frow(t), fcol(t)
        colt = t * v + torch.arange(v, device=dev)
        ly = (t // Py) * v
        if mesh.y == t % Py:
            Lcol = torch.where(gp[rt:, None] >= colt[None, :], Lloc[rt:, ly:ly + v], 0)
        else:
            Lcol = torch.zeros((Ml - rt, v), dtype=dtype, device=dev)
        mesh.psum(Lcol, "y")
        # rows of L for my columns (tile >= t), from each row's x-owner
        own = col_owner_x[ct:] == mesh.x
        src = (col_local_row[ct:] - rt).clamp(0, max(Ml - rt - 1, 0))
        Lr = (torch.where(own[:, None], Lcol.index_select(0, src), 0) if Ml > rt
              else torch.zeros((Nl - ct, v), dtype=dtype, device=dev))
        mesh.psum(Lr, "x")
        if rt < Ml and ct < Nl:
            prod[rt:, ct:].addmm_(Lcol, Lr.mH if Lr.is_complex() else Lr.mT)
    return _norm_ratio((Aloc[i:i + 4096] - prod[i:i + 4096] for i in range(0, Ml, 4096)),
                       Aloc, mesh)


def residual_bound(n: int, dtype) -> float:
    """Acceptance threshold: c * sqrt(n) * eps, with headroom for pivot growth."""
    if isinstance(dtype, torch.dtype):
        eps = torch.finfo(dtype).eps
    else:
        eps = float(np.finfo(dtype).eps)
    return 100.0 * np.sqrt(n) * eps


def make_test_matrix(M: int, N: int, seed: int = 42, dtype=np.float64) -> np.ndarray:
    """Deterministic well-conditioned random matrix (the JAX package's
    generator, bit for bit: uniform(-1, 1) plus 2 on the diagonal)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 1.0, size=(M, N)).astype(dtype)
    d = min(M, N)
    A[np.arange(d), np.arange(d)] += 2.0
    return A


def make_spd_matrix(N: int, seed: int = 7, dtype=np.float64, device="cpu") -> torch.Tensor:
    """Deterministic SPD matrix (the JAX package's generator, bit for bit:
    the symmetric part of a uniform(-1, 1) matrix plus N on the diagonal).

    The symmetrization and the diagonal shift run on `device`, so at
    N=32768 the host holds only the random draw, not the (N, N)
    temporaries of a host-side symmetrization."""
    rng = np.random.default_rng(seed)
    Bt = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(N, N)).astype(dtype)).to(device)
    A = Bt + Bt.T
    del Bt
    A /= 2
    A.diagonal().add_(N)
    return A


def make_hpd_matrix(N: int, seed: int = 7, dtype=np.complex128, device="cpu") -> torch.Tensor:
    """Deterministic Hermitian positive-definite matrix (the JAX package's
    generator, bit for bit: the Hermitian part of a complex uniform(-1, 1)
    matrix plus N on the diagonal, the diagonal real by construction),
    built on the host in numpy and put on `device`."""
    rng = np.random.default_rng(seed)
    B = (rng.uniform(-1.0, 1.0, size=(N, N))
         + 1j * rng.uniform(-1.0, 1.0, size=(N, N))).astype(dtype)
    A = (B + B.conj().T) / 2
    A[np.arange(N), np.arange(N)] += N
    return torch.from_numpy(A).to(device)
