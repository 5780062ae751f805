"""Distributed 2.5D Cholesky over the (x, y, z) process grid (the port of
`conflux_tpu/cholesky/distributed.py`, CONFCHOX itself).

The reference's CONFCHOX driver (`Cholesky.cpp:743-784` phases:
choleskyA00 -> updateComputeA10 -> computeA11 -> reduceA11 -> scatterA11)
as the C++ original runs it: one rank per process (or thread), each holding
its own block-cyclic (Ml, Nl) shard and running the same eager code, in the
same design as `lu.distributed` minus pivoting:

 - block-cyclic (x, y) tile shards holding z-partial sums; the true matrix
   is the sum over z; factors are written on layer z == 0 only;
 - panel column k: one sum over (y, z) of its live rows (reduceA11 +
   scatterA11 rolled into one collective);
 - the diagonal tile: a sum over x of the owner's rows (the reference's
   shrinking-bcast communicators, `Processor.cpp:131-250`), then potrf;
 - the L10^T redistribution from row owners to column owners (the
   reference's MPI_SUBTILE Isend mesh, `Cholesky.cpp:459-480`): a sum over
   x delivering exactly the rows each rank's columns need;
 - the trailing update: each z layer multiplies its nlayr-wide slab of the
   panel (the reference's subtile split `l = v/Pz`), on exact live pieces
   cut at the `segs` bounds, skipping segments entirely above the diagonal
   (never read again), each piece one GEMM in place (K1 on the kernel
   route).
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.geometry import (
    CholeskyGeometry,
    Grid3,
    check_shards,
    first_local_tile,
    ragged_segments,
)
from conflux_tpu_torch.lu.distributed import _cuts
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.parallel.mesh import (
    AXIS_X,
    distribute_shards,
    gather_shards,
    make_mesh,
)
from conflux_tpu_torch.profiler import scope


def _ht(x: torch.Tensor) -> torch.Tensor:
    """Transpose, Hermitian for complex dtypes (A = L L^H)."""
    return x.mH if x.is_complex() else x.mT


def _factor(geom: CholeskyGeometry, shard: torch.Tensor, mesh, backend: str, donate: bool,
            lookahead: bool, segs: tuple, k0: int, k_end: int, precision) -> torch.Tensor:
    v = geom.v
    Px, Py = geom.grid.Px, geom.grid.Py
    Ml, Nl = geom.Ml, geom.Nl
    nlayr = geom.nlayr
    x, y, z = mesh.coords
    dev = shard.device
    dtype = shard.dtype
    cdtype = blas.compute_dtype(dtype)
    z0 = z == 0
    row_segs = ragged_segments(Ml // v, v, segs[0])
    col_segs = ragged_segments(Nl // v, v, segs[1])

    if z0:
        Aloc = shard if donate else shard.clone(memory_format=torch.contiguous_format)
    else:
        Aloc = torch.zeros((Ml, Nl), dtype=dtype, device=dev)
    lc = torch.arange(Nl, device=dev)
    gcol = ((lc // v) * Py + y) * v + lc % v  # global index of each local column
    col_owner_x = (gcol // v) % Px  # the x-rank holding row gcol
    col_local_row = ((gcol // v) // Px) * v + gcol % v

    def frow(t):
        return first_local_tile(t, x, Px) * v

    def fcol(t):
        return first_local_tile(t, y, Py) * v

    def panel_reduce(k):
        """Live rows (tile >= k) of panel column k, summed over (y, z)."""
        r0, lj = frow(k), (k // Py) * v
        if y == k % Py:
            part = Aloc[r0:, lj:lj + v].clone(memory_format=torch.contiguous_format)
        else:
            part = torch.zeros((Ml - r0, v), dtype=dtype, device=dev)
        return mesh.psum(part, ("y", "z")).to(cdtype)

    def touches_lower(rhi, clo):
        # the segment's last row tile reaches its first column tile: false
        # means every tile is strictly upper, never read again
        return ((rhi - 1) // v) * Px + x >= (clo // v) * Py + y

    def step(k, panel):
        xo, yo = k % Px, k % Py
        lj, ldiag = (k // Py) * v, (k // Px) * v
        r0, r1, c0, c1 = frow(k), frow(k + 1), fcol(k), fcol(k + 1)

        # ---- diagonal tile: sum over x + potrf (choleskyA00) ------------ #
        with scope("choleskyA00"):
            Akk = (panel[ldiag - r0:ldiag - r0 + v].clone() if x == xo
                   else torch.zeros((v, v), dtype=cdtype, device=dev))
            L00 = blas.potrf(mesh.psum(Akk, AXIS_X))

        # ---- L10 for the rows below the diagonal (updateA10) ------------ #
        with scope("updateA10"):
            L10 = blas.trsm_right_lower_t(L00, panel[r1 - r0:]).contiguous()  # (Ml - r1, v)

        # ---- L10^T to the column owners over x (scatterA11) ------------- #
        # my live columns' rows of the panel (tile > k: from L10 on the row
        # owner; the diagonal tile's columns take L00's rows)
        with scope("scatterA11"):
            own = (col_owner_x[c0:] == x) & (col_local_row[c0:] >= r1)
            src = (col_local_row[c0:] - r1).clamp(0, max(Ml - r1 - 1, 0))
            Lc = (torch.where(own[:, None], L10.index_select(0, src),
                              torch.zeros((), dtype=cdtype, device=dev))
                  if Ml > r1 else torch.zeros((Nl - c0, v), dtype=cdtype, device=dev))
            mesh.psum(Lc, AXIS_X)  # (Nl - c0, v): L's rows for my columns
            if c1 > c0:  # the diagonal tile's columns are mine
                Lc[:c1 - c0] = L00
            Lc = Lc[c1 - c0:]

        # ---- trailing update on this layer's slab (computeA11) ---------- #
        z_lo, z_hi = min(z * nlayr, v), min((z + 1) * nlayr, v)
        L10s = L10[:, z_lo:z_hi].to(dtype)
        with scope("computeA11"):
            LcsT = _ht(Lc[:, z_lo:z_hi]).to(dtype).contiguous()  # (nl, Nl - c1)
        kn = k + 1
        # a piece of its own whether or not this run goes on to step k+1:
        # a resumed factor is bitwise the one-shot one
        slab = kn < geom.Kappa and y == kn % Py
        lj1 = (kn // Py) * v
        pieces = []
        for rlo, rhi in row_segs:
            for clo, chi in col_segs:
                if not touches_lower(rhi, clo):
                    continue
                for ca, cb in _cuts(max(clo, c1), chi, [lj1, lj1 + v] if slab else []):
                    if max(rlo, r1) < rhi:
                        pieces.append((max(rlo, r1), rhi, ca, cb))
        nxt = None

        def run(ps):
            for ra, rb, ca, cb in ps:
                blk = Aloc[ra:rb, ca:cb]
                blas.gemm(L10s[ra - r1:rb - r1], LcsT[:, ca - c1:cb - c1], blk, -1.0, 1.0,
                          precision, backend, out=blk)

        if lookahead and kn < k_end:
            # the next panel's column slab first: its sum over (y, z) has no
            # data dependence on the rest of the update (the slab's GEMMs
            # are the next reduce's, as in the reference)
            with scope("reduceA11"):
                if z_hi > z_lo and slab:
                    run([p for p in pieces if (p[2], p[3]) == (lj1, lj1 + v)])
                    pieces = [p for p in pieces if (p[2], p[3]) != (lj1, lj1 + v)]
                nxt = panel_reduce(kn)
        with scope("computeA11"):
            if z_hi > z_lo:
                run(pieces)

        # ---- factor writes: panel column on layer 0 --------------------- #
        if y == yo:
            if x == xo:
                Aloc[ldiag:ldiag + v, lj:lj + v] = (torch.tril(L00).to(dtype) if z0 else 0)
            Aloc[r1:, lj:lj + v] = L10.to(dtype) if z0 else 0
        return nxt

    panel = None
    for k in range(k0, k_end):
        if panel is None:
            with scope("reduceA11"):
                panel = panel_reduce(k)
        panel = step(k, panel)
    return mesh.psum(Aloc, "z")


def build_program(geom: CholeskyGeometry, mesh=None, precision=None,
                  backend: str | None = None, donate: bool = False,
                  resumable: bool = False, lookahead: bool = False,
                  segs: tuple = (8, 8), dtype=None):
    """The distributed Cholesky program of one configuration, its defaults
    and argument checks resolved (`cholesky_factor_distributed` and
    `cholesky_factor_steps` go through it): a callable (shard, mesh, k0,
    k1) -> shard_out. `backend` picks the trailing GEMM ("kernel": K1,
    "xla": the library product; default the registry's). `precision` is
    the library trailing update's (`blas.gemm`; None: the registry's):
    DEFAULT and HIGH run it as one TF32 pass on the card, K1 is IEEE
    float32 at every level."""
    precision = blas.resolve_precision(precision)
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    blas.check_gemm_route(backend, torch.float32 if dtype is None else dtype)
    if len(segs) != 2 or segs[0] < 1 or segs[1] < 1:
        raise ValueError(
            f"segs must be two positive segment counts, got {segs!r} "
            "(non-positive counts would silently skip trailing updates)")
    segs = tuple(segs)

    def program(shard, mesh, k0: int = 0, k1: int | None = None):
        k1 = geom.Kappa if k1 is None else k1
        return _factor(geom, shard, mesh, backend, donate, lookahead, segs, k0, k1,
                       precision)

    return program


def _rank_shard(shards, geom, mesh) -> torch.Tensor:
    check_shards(shards, geom)
    if tuple(shards.shape) == (geom.Ml, geom.Nl) and isinstance(shards, torch.Tensor):
        return shards
    return distribute_shards(shards, mesh)


def cholesky_factor_distributed(shards, geom: CholeskyGeometry, mesh, precision=None,
                                backend: str | None = None, donate: bool = False,
                                lookahead: bool = False, segs: tuple = (8, 8)):
    """Factor this rank's block-cyclic shard of an SPD (HPD) matrix; every
    rank of `mesh`'s world calls it together. `shards` is this rank's
    (Ml, Nl) tensor (or the full (Px, Py, Ml, Nl) array). Returns the
    rank's factored shard, z-replicated (lower triangle = L, upper
    triangle unspecified). `donate=True` factors the caller's shard in
    place (layer 0); `lookahead=True` reduces step k+1's panel from a
    separately updated column slab before the rest of step k's update
    (bitwise the plain loop); `segs` = (row, col) trailing-update segment
    counts."""
    shard = _rank_shard(shards, geom, mesh)
    fn = build_program(geom, mesh, precision, backend=backend, donate=donate,
                       lookahead=lookahead,
                       segs=segs, dtype=shard.dtype)
    return fn(shard, mesh)


def cholesky_factor_steps(shards, geom: CholeskyGeometry, mesh, k0: int, k1: int,
                          precision=None, backend: str | None = None,
                          donate: bool = False, segs: tuple = (8, 8)):
    """Factor supersteps [k0, k1) only: checkpoint/restart for Cholesky (no
    pivot state to carry): feed each call's output shard into the next;
    after the last call the lower triangle holds L as
    `cholesky_factor_distributed` computes it, bit-identically when
    Pz == 1 (with Pz > 1 the state consolidates the z-partial sums, so a
    resumed run re-associates them)."""
    if not (0 <= k0 < k1 <= geom.Kappa):
        raise ValueError(f"step range [{k0}, {k1}) outside [0, {geom.Kappa})")
    shard = _rank_shard(shards, geom, mesh)
    fn = build_program(geom, mesh, precision, backend=backend, donate=donate,
                       resumable=True,
                       segs=segs, dtype=shard.dtype)
    return fn(shard, mesh, k0, k1)


def cholesky_distributed_host(A: np.ndarray, grid: Grid3, v: int, mesh=None,
                              precision=None, backend: str | None = None,
                              segs: tuple = (8, 8), *, device=None):
    """Scatter an SPD matrix, factor on the grid, gather L back, on every
    rank together (the reference's initialize/parallelCholesky/finalize
    sequence, `Cholesky.h:19-23`). Returns (L (N, N) lower-triangular numpy,
    geom); `mesh` defaults to `make_mesh(grid, device=device)`."""
    A = np.asarray(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"matrix must be square, got {A.shape}")
    geom = CholeskyGeometry.create(A.shape[0], v, grid)
    if mesh is None:
        mesh = make_mesh(grid, device=device)
    if geom.N != A.shape[0]:
        Ap = np.eye(geom.N, dtype=A.dtype)
        Ap[: A.shape[0], : A.shape[0]] = A
        A = Ap
    shard = distribute_shards(geom.scatter(A), mesh)
    out = cholesky_factor_distributed(shard, geom, mesh, precision, backend=backend,
                                      donate=True, segs=segs)
    L = np.tril(geom.gather(gather_shards(out, mesh).cpu().numpy()))
    return L, geom
