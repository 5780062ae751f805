"""Distributed QR over the (x, y, z) process grid (the port of
`conflux_tpu/qr/distributed.py`): tall-skinny TSQR and CholeskyQR2 over
the x axis, and the general block-cyclic QR (the CAQR role).

One rank per process (or thread), each holding its own shard and running
the same eager code, as `lu.distributed` and `cholesky.distributed` do:
the JAX package's `shard_map` programs become Python code on exact slices,
its `fori_loop` a Python loop, and its named-axis collectives go to the
rank's process groups (`parallel.mesh.Mesh`).

Tall-skinny (rows block-distributed over x; no pivoting, so no cyclic
interleave): only (n, n) R factors cross ranks.

 - `tsqr_distributed`: the local chunked QR tree, then the (n, n) Rs
   reduced across x, by one `all_gather` in x-coordinate order and the
   same tree on every rank (`tree="gather"`), or by the reference's
   log2(Px) hypercube (`tree="butterfly"`, `butterfly_allreduce` with the
   tree as the reducer); Q by a triangular solve, refined over `passes`.
 - `cholesky_qr2_distributed`: G = sum over x of A_loc^H A_loc, R =
   chol(G)^H, Q = A R^{-1}, `passes` times (valid while cond(A)^2 eps < 1).

Every rank reduces the same gathered bytes with the same tree, so R comes
back bitwise identical on every rank without a broadcast (the tests check
it). diag(R) >= 0.

Block-cyclic (`qr_factor_distributed`): block Gram-Schmidt over v-wide
column panels on the LU geometry's (Ml, Nl) shards, with the z-partial-sum
invariant of the LU and Cholesky loops (the sum over z is the true matrix;
factors are written on layer 0):

 - panel k: one sum over (y, z) gives every rank the (Ml, v) panel;
 - BCGS2 re-projection: W = Q_done^H P summed over (x, z), then
   P -= Q_done W summed over (y, z), against the finished Q columns
   (the trailing update below is the first sweep);
 - the panel's two-pass TSQR election over x (the tall-skinny machinery);
 - C = Qp^H A on the live columns, summed over (x, z), then A -= Qp C on
   this layer's nlayr = v/Pz slab of Qp, cut into exact column pieces at
   the `csegs` bounds, each piece one GEMM in place (K1 on the kernel
   route);
 - R on its own (N, N) block-cyclic geometry (`r_geometry`): C lands in
   R's row tile k, Rp on the diagonal block, and W moves from the column
   owners to R's row owners by a sum over y.

A rank whose segment is dead skips its GEMM but still joins every
collective, contributing zeros where the JAX program masks. The products
C, W and Q_done W, the TSQR trees (`torch.linalg.qr`), the triangular
solves and the Gram potrf are library calls, as they are XLA ops in the
reference; float32 products run without TF32 (`ops.blas`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from conflux_tpu_torch.geometry import (
    Grid3,
    LUGeometry,
    check_shards,
    first_local_tile,
    ragged_segments,
)
from conflux_tpu_torch.lu.distributed import _cuts
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.parallel.mesh import (
    AXIS_X,
    butterfly_allreduce,
    distribute_shards,
    gather_shards,
    make_mesh,
)
from conflux_tpu_torch.profiler import scope
from conflux_tpu_torch.qr.single import _positive_diag, _tree_r


def _two_pass_tsqr(mesh, A: torch.Tensor, Px: int, chunk: int, passes: int, prec,
                   tree: str = "gather"):
    """Replicated TSQR election: the local chunked tree, then the cross-x
    reduction of the (n, n) R factors; Q by a triangular solve, refined
    over `passes` sweeps; positive-diagonal normalized. Shared by the
    tall-skinny entry points and the block-cyclic loop's panel step.

    tree="gather": one all_gather in x order and the tree on every rank.
    tree="butterfly": log2(Px) ppermute rounds, each QR-reducing a
    pair-ordered (2n, n) stack (any Px: odd axes fold their overflow ranks
    in and out with two extra rounds, `butterfly_allreduce`). `prec` is
    the precision of the R products (`blas.matmul`)."""
    n = A.shape[1]
    R = None
    for _ in range(max(1, passes)):
        Ri = _tree_r(A, chunk)
        if tree == "butterfly":
            (Ri,) = butterfly_allreduce(
                mesh, (Ri,), Px, AXIS_X,
                lambda top, bot: (_tree_r(torch.cat([top[0], bot[0]]), chunk),))
        elif Px > 1:
            Ri = _tree_r(mesh.all_gather(Ri, AXIS_X).reshape(Px * n, n), chunk)
        A = blas.trsm_right_upper(Ri, A)
        R = Ri if R is None else blas.matmul(Ri, R, prec)
    return _positive_diag(A, R)


def _row_shard(shards, mesh) -> torch.Tensor:
    """This rank's (Ml, n) row block: `shards` is that block (a tensor) or
    the full (Px, Ml, n) array of x-shards."""
    if isinstance(shards, torch.Tensor) and shards.dim() == 2:
        return shards
    if shards.ndim != 3:
        raise ValueError(f"expected (Px, Ml, n) row-block shards or one rank's (Ml, n) "
                         f"block, got {tuple(shards.shape)}")
    if shards.shape[0] != mesh.grid.Px:
        raise ValueError(
            f"shards leading dim {shards.shape[0]} != mesh x extent {mesh.grid.Px}")
    blk = shards[mesh.x]
    if isinstance(blk, torch.Tensor):
        return blk.to(mesh.device).clone()
    from conflux_tpu_torch.lu.single import from_numpy

    return from_numpy(np.ascontiguousarray(blk), mesh.device)


def _factor(shards, mesh, algo: str, chunk: int | None, passes: int,
            tree: str = "gather"):
    A = _row_shard(shards, mesh)
    Px = mesh.grid.Px
    Ml, n = A.shape
    if Px * Ml < n:
        raise ValueError(f"need M = {Px * Ml} >= n = {n}")
    if tree not in ("gather", "butterfly"):
        raise ValueError(f"unknown tree {tree!r} (gather|butterfly)")
    dtype = A.dtype
    cdtype = blas.compute_dtype(dtype)
    if chunk is None:
        chunk = blas.batched_call_rows(n, cdtype)
    A = A.to(cdtype)
    prec = blas.matmul_precision()
    if algo == "tsqr":
        Q, R = _two_pass_tsqr(mesh, A, Px, chunk, passes, prec, tree=tree)
    else:  # the Gram sum over x and a potrf election per pass
        R = None
        for _ in range(max(1, passes)):
            G = mesh.psum(blas.matmul(A.mH, A, prec), AXIS_X)
            Ri = blas.potrf(G).mH  # G = L L^H: the upper factor is L^H
            A = blas.trsm_right_upper(Ri, A)
            R = Ri if R is None else blas.matmul(Ri, R, prec)
        Q, R = _positive_diag(A, R)
    return Q.to(dtype), R.to(dtype)


def tsqr_distributed(shards, mesh, chunk: int | None = None, passes: int = 2,
                     tree: str = "gather"):
    """(Q_shard, R) of an x-sharded tall matrix by the QR reduction tree,
    every rank of `mesh`'s world together. `shards` is this rank's (Ml, n)
    row block (a tensor on its device) or the full (Px, Ml, n) array;
    Q_shard is the rank's (Ml, n) block of Q, R (n, n) is bitwise the same
    on every rank. Every QR call is at most max(chunk, 2n) rows tall
    (`chunk` defaults to `blas.batched_call_rows(n)` of the compute
    dtype); robust at any conditioning. tree="butterfly" runs the log-depth
    ppermute hypercube (any Px)."""
    return _factor(shards, mesh, "tsqr", chunk, passes, tree)


def cholesky_qr2_distributed(shards, mesh, passes: int = 2):
    """(Q_shard, R) by Gram-matrix CholeskyQR with `passes` refinement
    sweeps: one (n, n) sum over x per pass, everything else GEMM and TRSM.
    Requires cond(A)^2 eps < 1 (use `tsqr_distributed` otherwise)."""
    return _factor(shards, mesh, "cholesky", None, passes)


def qr_distributed_host(A: np.ndarray, Px: int, mesh=None, algo: str = "tsqr",
                        chunk: int | None = None, passes: int = 2, device=None):
    """Host convenience, every rank together: block-row scatter, factor on
    the grid, gather. Returns (Q (M, n), R (n, n)) as numpy on every rank.
    M is zero-padded up to a multiple of Px (zero rows leave R unchanged;
    the pad rows of Q are dropped). `mesh` defaults to
    `make_mesh(Grid3(Px, 1, 1), device=device)`."""
    A = np.asarray(A)
    M, n = A.shape
    if M < n:
        # the padded row count could pass _factor's check while the true
        # matrix is rank-deficient by shape: a non-orthogonal Q
        raise ValueError(f"need M >= n, got {A.shape}")
    if algo not in ("tsqr", "cholesky"):
        raise ValueError(f"unknown algo {algo!r} (tsqr|cholesky)")
    Ml = -(-M // Px)
    if mesh is None:
        mesh = make_mesh(Grid3(Px, 1, 1), device=device)
    Ap = np.zeros((Px * Ml, n), A.dtype)
    Ap[:M] = A
    shards = Ap.reshape(Px, Ml, n)
    if algo == "tsqr":
        Qs, R = tsqr_distributed(shards, mesh, chunk=chunk, passes=passes)
    else:
        Qs, R = cholesky_qr2_distributed(shards, mesh, passes=passes)
    Q = mesh.all_gather(Qs, AXIS_X).cpu().numpy().reshape(Px * Ml, n)[:M]
    return Q, R.cpu().numpy()


# --------------------------------------------------------------------------- #
# General (block-cyclic) distributed QR: the CAQR role
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class _Program:
    """The resolved configuration of one block-cyclic QR; calling it runs
    this rank's share of column panels [k0, k1)."""

    geom: LUGeometry
    backend: str
    chunk: int
    donate: bool
    csegs: int
    lookahead: bool
    precision: object  # blas.Precision of the library products

    def __call__(self, shard: torch.Tensor, mesh, R=None, k0: int = 0,
                 k1: int | None = None):
        k1 = self.geom.Nt if k1 is None else k1
        return _factor_full(self, shard, R, mesh, k0, k1)


def _factor_full(prog: _Program, shard: torch.Tensor, rshard, mesh, k0: int, k_end: int):
    geom = prog.geom
    v = geom.v
    Px, Py = geom.grid.Px, geom.grid.Py
    Ml, Nl = geom.Ml, geom.Nl
    nlayr = geom.nlayr
    # R's local row count: every x-rank holds whole tiles (`r_geometry`
    # pads the same way; pad tiles are never written)
    Nlr = -(-geom.Nt // Px) * v
    x, y, z = mesh.coords
    dev = shard.device
    dtype = shard.dtype
    cdtype = blas.compute_dtype(dtype)
    prec = prog.precision
    z0 = z == 0

    # z-partial invariant: data enters on layer 0 (a resumed state is
    # z-replicated: layer 0 restores it); R is only ever written on layer 0
    if z0:
        Aloc = shard if prog.donate else shard.clone(memory_format=torch.contiguous_format)
        Rloc = (torch.zeros((Nlr, Nl), dtype=dtype, device=dev) if rshard is None
                else rshard.to(device=dev, dtype=dtype).clone(
                    memory_format=torch.contiguous_format))
    else:
        Aloc = torch.zeros((Ml, Nl), dtype=dtype, device=dev)
        Rloc = torch.zeros((Nlr, Nl), dtype=dtype, device=dev)
    # R-local rows -> global R row ids, and the y-rank and local column
    # holding that global column (the W exchange)
    lrr = torch.arange(Nlr, device=dev)
    grow_r = ((lrr // v) * Px + x) * v + lrr % v
    wsrc_y = (grow_r // v) % Py
    wsrc_col = (((grow_r // v) // Py) * v + grow_r % v).clamp(max=Nl - 1)

    def fcol(t):  # first local column whose tile index is >= t
        return min(first_local_tile(t, y, Py) * v, Nl)

    def panel_reduce(k):
        """Column panel k on every rank: one sum over (y, z)."""
        lj = (k // Py) * v
        if y == k % Py:
            part = Aloc[:, lj:lj + v].clone(memory_format=torch.contiguous_format)
        else:
            part = torch.zeros((Ml, v), dtype=dtype, device=dev)
        return mesh.psum(part, ("y", "z")).to(cdtype)

    def reproject(P, k):
        """BCGS2 re-projection of panel P against the finished Q columns
        (tiles < k, on layer 0): (W, P - Q_done W)."""
        cd = fcol(k)  # this rank's done columns are the prefix [0, cd)
        mine = z0 and cd > 0
        W = torch.zeros((Nl, v), dtype=cdtype, device=dev)
        if mine:
            Qd = Aloc[:, :cd].to(cdtype)
            W[:cd] = blas.matmul(Qd.mH, P, prec)
        mesh.psum(W, ("x", "z"))  # (Nl, v), replicated over x and z
        D = (blas.matmul(Qd, W[:cd], prec) if mine
             else torch.zeros((Ml, v), dtype=cdtype, device=dev))
        return W, P - mesh.psum(D, ("y", "z"))

    def elect(k):
        """The whole per-step panel pipeline: panel reduce, BCGS2
        re-projection and the two-pass TSQR election over x."""
        with scope("qr_panel_reduce"):
            P = panel_reduce(k)
        with scope("qr_reproject"):
            W, P = reproject(P, k)
        with scope("qr_panel_tsqr"):
            Qp, Rp = _two_pass_tsqr(mesh, P, Px, prog.chunk, 2, prog.precision)
        return W, Qp, Rp

    def step(k, W, Qp, Rp):
        """Panel k's trailing update and writes, given its election;
        returns step k+1's election when it computed it (lookahead)."""
        yo, xo = k % Py, k % Px
        lj, lir = (k // Py) * v, (k // Px) * v
        c1 = fcol(k + 1)  # this rank's live columns are the suffix [c1, Nl)

        # ---- trailing projection C = Qp^H A (the first GS sweep) ------- #
        with scope("qr_trailing_c"):
            C = torch.zeros((v, Nl), dtype=cdtype, device=dev)
            if c1 < Nl:
                C[:, c1:] = blas.matmul(Qp.mH, Aloc[:, c1:].to(cdtype), prec)
            mesh.psum(C, ("x", "z"))  # (v, Nl)

        # ---- trailing update A -= Qp C on this layer's z-slab ---------- #
        z_lo, z_hi = min(z * nlayr, v), min((z + 1) * nlayr, v)
        Qps = Qp[:, z_lo:z_hi].to(dtype).contiguous()  # (Ml, nl)
        Cs = C[z_lo:z_hi].to(dtype)  # (nl, Nl)
        kn = k + 1
        slab = kn < geom.Nt and y == kn % Py
        lj1 = (kn // Py) * v
        cuts = _update_pieces(geom, prog.csegs, y, k)

        def run(pieces):
            for ca, cb in pieces:
                blk = Aloc[:, ca:cb]
                blas.gemm(Qps, Cs[:, ca:cb], blk, -1.0, 1.0, prec, backend=prog.backend,
                          out=blk)

        nxt = None
        if z_hi > z_lo and prog.lookahead and slab:
            # the next panel's slab GEMM is the next reduce's, as in the
            # reference
            with scope("qr_panel_reduce"):
                run([(lj1, lj1 + v)])
            cuts = [c for c in cuts if c != (lj1, lj1 + v)]

        # ---- Q panel write (layer 0, column owner) --------------------- #
        with scope("qr_writes"):
            if y == yo:
                Aloc[:, lj:lj + v] = Qp.to(dtype) if z0 else 0
        if prog.lookahead and kn < k_end:
            # the next election reads the updated slab and the finished Q
            # columns only: no data dependence on the rest of the update
            nxt = elect(kn)
        with scope("qr_trailing_update"):
            if z_hi > z_lo:
                run(cuts)

        # ---- R writes: C into row tile k (live columns), Rp on the
        # diagonal block, W into column panel k (done rows) --------------- #
        with scope("qr_writes"):
            if z0 and x == xo:
                Rloc[lir:lir + v, c1:] = C[:, c1:].to(dtype)
                if y == yo:
                    Rloc[lir:lir + v, lj:lj + v] = Rp.to(dtype)
            # W transpose-exchange: my R rows' corrections live on the y-rank
            # owning that global column; a sum over y delivers them
            take = (wsrc_y == y) & (grow_r < k * v)
            Wr = torch.where(take[:, None], W.index_select(0, wsrc_col),
                             torch.zeros((), dtype=cdtype, device=dev))
            mesh.psum(Wr, "y")  # (Nlr, v), complete on every y
            if z0 and y == yo:
                Rloc[:, lj:lj + v] += Wr.to(dtype)
        return nxt

    carry = None
    for k in range(k0, k_end):
        if carry is None:
            carry = elect(k)
        carry = step(k, *carry)
    # all factors live on layer 0: the sums make the outputs z-replicated
    return mesh.psum(Aloc, "z"), mesh.psum(Rloc, "z")


def _update_pieces(geom: LUGeometry, csegs: int, y: int, k: int) -> list:
    """The (start, stop) local column pieces of step k's trailing update on
    y-rank y: its live columns cut at the `csegs` segment bounds and around
    the next panel's column slab, which is a piece of its own in the plain
    loop as under lookahead, and in a run that stops before panel k+1 as in
    one that goes on (all compute it in the same GEMM, so a resumed factor
    is bitwise the one-shot one)."""
    v, Py = geom.v, geom.grid.Py
    bounds = [lo for lo, _ in ragged_segments(geom.Ntl, v, csegs)]
    kn = k + 1
    if kn < geom.Nt and y == kn % Py:
        lj1 = (kn // Py) * v
        bounds += [lj1, lj1 + v]
    return _cuts(min(first_local_tile(kn, y, Py) * v, geom.Nl), geom.Nl, bounds)


def gemm_launches(geom: LUGeometry, csegs: int = 8, k0: int = 0,
                  k1: int | None = None) -> int:
    """K1 launches of one run of panels [k0, k1) on the kernel route,
    summed over the grid's ranks: one per trailing-update piece on every
    rank whose z-slab of the panel is not empty."""
    k1 = geom.Nt if k1 is None else k1
    layers = sum(1 for z in range(geom.grid.Pz) if z * geom.nlayr < geom.v)
    return geom.grid.Px * layers * sum(len(_update_pieces(geom, csegs, y, k))
                                       for k in range(k0, k1) for y in range(geom.grid.Py))


def build_program(geom: LUGeometry, mesh=None, precision=None, backend: str | None = None,
                  chunk: int | None = None, donate: bool = False,
                  resumable: bool = False, csegs: int = 8, lookahead: bool = False,
                  dtype=None) -> _Program:
    """The block-cyclic QR program of one configuration, every default and
    argument check resolved here (`qr_factor_distributed` and
    `qr_factor_steps` go through it). Pass the input `dtype` the program
    will run: the TSQR chunk default is `blas.batched_call_rows(v)` of its
    compute dtype (float64 halves it), so a resumed run chunks like the
    run it resumes, and the route is checked against it. `backend` picks
    the trailing GEMM ("kernel": K1, float32 and bfloat16; "xla": the
    library product, any dtype; default the registry's). `mesh` and
    `resumable` are accepted for the reference's signature (every program
    takes the resume state R); `precision` is the library products'
    (`blas.gemm`; None: the registry's): DEFAULT and HIGH run them as one
    TF32 pass on the card, K1 is IEEE float32 at every level."""
    precision = blas.resolve_precision(precision)
    if geom.M < geom.N:
        raise ValueError(f"distributed QR needs M >= N, got {geom.M}x{geom.N}")
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    tdtype = torch.float32 if dtype is None else dtype
    blas.check_gemm_route(backend, tdtype)
    if chunk is None:
        chunk = blas.batched_call_rows(geom.v, blas.compute_dtype(tdtype))
    if csegs < 1:
        raise ValueError(
            f"csegs must be a positive segment count, got {csegs} "
            "(non-positive counts would silently skip trailing updates)")
    return _Program(geom, backend, chunk, donate, csegs, lookahead, precision)


def _rank_shard(shards, geom, mesh, what: str = "shards") -> torch.Tensor:
    check_shards(shards, geom, what)
    if tuple(shards.shape) == (geom.Ml, geom.Nl) and isinstance(shards, torch.Tensor):
        return shards
    return distribute_shards(shards, mesh)


def qr_factor_distributed(shards, geom: LUGeometry, mesh, precision=None,
                          backend: str | None = None, chunk: int | None = None,
                          donate: bool = False, csegs: int = 8, lookahead: bool = False):
    """Blocked QR of this rank's block-cyclic shard on the grid; every rank
    of `mesh`'s world calls it together. `shards` is this rank's (Ml, Nl)
    tensor (or the full (Px, Py, Ml, Nl) array).

    Returns (Q_shard, R_shard), both z-replicated: Q thin (M, N) in A's
    layout, R upper-triangular (N, N) block-cyclic over its own geometry
    (gather it with `r_geometry(geom)`). A = Q R with diag(R) >= 0.
    Rank-deficient panels leave their block's columns and rows unspecified.
    `donate=True` factors the caller's shard in place (layer 0); `csegs`
    is the trailing update's column segment count; `lookahead=True` runs
    the next panel's election from a separately updated column slab before
    the rest of the trailing update (bitwise the plain loop)."""
    shard = _rank_shard(shards, geom, mesh)
    fn = build_program(geom, mesh, precision, backend=backend, chunk=chunk, donate=donate,
                       csegs=csegs, lookahead=lookahead, dtype=shard.dtype)
    return fn(shard, mesh)


def qr_factor_steps(shards, geom: LUGeometry, mesh, k0: int, k1: int, R=None,
                    precision=None, backend: str | None = None, chunk: int | None = None,
                    donate: bool = False, csegs: int = 8):
    """Factor column panels [k0, k1) only: checkpoint/restart for the QR
    loop. State = (shard, R): after k panels, columns with tile id < k hold
    finished Q columns, the rest the projected trailing matrix, and R holds
    its first k tile rows. Pass R=None only when k0 == 0 and feed each
    call's outputs to the next; `R` is this rank's (Nlr, Nl) block of R's
    geometry or the full (Px, Py, Nlr, Nl) array. Pz == 1 round-trips
    bitwise; with Pz > 1 the state consolidates the z-partial sums, so a
    resumed run re-associates them."""
    if not (0 <= k0 < k1 <= geom.Nt):
        raise ValueError(f"step range [{k0}, {k1}) outside [0, {geom.Nt})")
    if R is None and k0 != 0:
        raise ValueError("resuming at k0 > 0 requires the R state returned by the "
                         "previous qr_factor_steps call")
    shard = _rank_shard(shards, geom, mesh)
    if R is not None:
        R = _rank_shard(R, r_geometry(geom), mesh, "R")
    fn = build_program(geom, mesh, precision, backend=backend, chunk=chunk, donate=donate,
                       resumable=True, csegs=csegs, dtype=shard.dtype)
    return fn(shard, mesh, R, k0, k1)


def r_geometry(geom: LUGeometry) -> LUGeometry:
    """The (N, N) block-cyclic geometry R comes back in."""
    return LUGeometry.create(geom.N, geom.N, geom.v, geom.grid)


def qr_blocked_distributed_host(A: np.ndarray, grid: Grid3, v: int, mesh=None,
                                precision=None, backend: str | None = None,
                                chunk: int | None = None, *, device=None):
    """Host convenience, every rank together: scatter, factor, gather.
    Returns (Q (M, N), R (N, N), geom) for the original shape, as numpy on
    every rank. `mesh` defaults to `make_mesh(grid, device=device)`.

    Sizes off the grid go through the block-diagonal identity extension:
    QR(blockdiag(A, I)) == blockdiag(Q, I) blockdiag(R, I) exactly, so the
    padded problem's leading blocks are the answer (zero-column padding
    would feed singular panels to the triangular solves). The identity
    lives in padded rows x padded columns, so rows are padded at least as
    far as columns."""
    A = np.asarray(A)
    M, N = A.shape
    if M < N:
        raise ValueError(f"distributed QR needs M >= N, got {A.shape}")
    geom = LUGeometry.create(M, N, v, grid)
    col_pad = geom.N - N
    if geom.M - M < col_pad:  # one identity row per pad column
        geom = LUGeometry.create(M + col_pad, N, v, grid)
    if (geom.M, geom.N) != A.shape:
        Ap = np.zeros((geom.M, geom.N), A.dtype)
        Ap[:M, :N] = A
        Ap[np.arange(M, M + col_pad), np.arange(N, geom.N)] = 1
        A = Ap
    if mesh is None:
        mesh = make_mesh(grid, device=device)
    shard = distribute_shards(geom.scatter(A), mesh)
    Qs, Rs = qr_factor_distributed(shard, geom, mesh, precision, backend=backend,
                                   chunk=chunk, donate=True)
    Q = geom.gather(gather_shards(Qs, mesh).cpu().numpy())[:M, :N]
    # R's geometry pads its rows to whole tiles per x-rank; the pad tiles
    # are never written, so slicing restores the (N, N) contract
    R = r_geometry(geom).gather(gather_shards(Rs, mesh).cpu().numpy())[:N, :N]
    return Q, np.triu(R), geom
