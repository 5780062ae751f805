"""Distributed LU with tournament pivoting over the (x, y, z) process grid
(the port of `conflux_tpu/lu/distributed.py`, CONFLUX itself).

The reference's `LU_rep` superstep loop (`conflux_opt.hpp:343-1827`) as
the C++ original runs it: one rank per process (or thread), each holding
its own block-cyclic (Ml, Nl) shard and running the same eager code. The
JAX package's single `shard_map` program with a `fori_loop`, masks and
`lax.cond` becomes a Python loop over supersteps on exact shrinking slices,
and its named-axis collectives go to the rank's process groups
(`parallel.mesh.Mesh`). The semantics are the JAX package's:

 - the matrix lives in *currently-pivoted global row order* (LAPACK getrf
   layout): after step k, global positions < k*v hold frozen factor rows
   and positions >= k*v are active. Each step performs LAPACK-style row
   swaps (elected pivot rows move into the step's diagonal block, the
   displaced occupants move to the vacated slots) as two (v, Nl) sums over
   (x, z) plus row scatters, so eliminated rows occupy a tile-aligned
   *prefix* of every rank's local rows and the live rows a suffix: every
   step works on exact slices;
 - the z-layer 2.5D replication: each rank holds a *partial sum* shard
   (the sum over z is the true matrix); panel reads are sums over (y, z),
   factor writes land on layer z == 0 only, and the output is summed over
   z;
 - tournament pivoting: chunked CALU nomination over each rank's live
   rows (chunk boundaries where the whole local panel's are, dead chunks
   nominating zero rows: `ops.blas.tournament_winners_live`), then an
   election across x, by `all_gather` of the nominees or by the
   reference's log2(Px) butterfly (`parallel.mesh.butterfly_allreduce`),
   computed identically on every rank so the winners need no broadcast;
 - the trailing update (step 6) runs on each rank's nlayr = v/Pz slab of
   the panel, cut into row x column pieces at the `segs` segment bounds
   (`update="segments"`) or as one block (`update="block"`), each piece
   one GEMM in place on a view of the local shard (K1 on the kernel
   route).

Routes: backend "kernel" runs the trailing GEMMs on K1, panel algo
"kernel" the elections on K2 (float32, v a multiple of 128); backend
"xla" and the library panel algos run the library product and LU in any
dtype (the JAX package's defaults). TRSMs are library calls, as they are
XLA ops in the reference.

Factors come back in *pivoted row order* together with `perm` (M,), the
original row index at each global position: A[perm] == L @ U.
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
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.parallel.mesh import (
    AXIS_X,
    butterfly_allreduce,
    distribute_shards,
    gather_shards,
    make_mesh,
)
from conflux_tpu_torch.profiler import scope, sync

_GRI_SENTINEL = int(np.iinfo(np.int32).max)


def _take_rows(src: torch.Tensor, idx: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """src[idx] with rows idx >= n read as `fill` (the JAX `mode="fill"`
    gather); src has n rows."""
    valid = idx < n
    if n == 0:
        return torch.full((idx.shape[0],) + tuple(src.shape[1:]), fill,
                          dtype=src.dtype, device=src.device)
    rows = src.index_select(0, idx.clamp(0, n - 1))
    mask = valid.view((-1,) + (1,) * (rows.dim() - 1))
    return torch.where(mask, rows, torch.full((), fill, dtype=src.dtype, device=src.device))


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """dst[idx] = vals, dropping the entries with idx >= dst's row count (the
    JAX `mode="drop"` scatter), in place: a dropped entry rewrites the
    first kept entry's row with that entry's value (or row 0 with its own
    value when none is kept), so duplicate targets only ever carry one
    value. It syncs with the host three times, each a `sync.set_rows`
    region: indexing by the 0-d tensor `first` reads it on the host
    (torch turns a 0-d integer index into `.item()`), twice for `idx`
    and once for `vals`."""
    n = dst.shape[0]
    if n == 0:
        return
    valid = idx < n
    any_valid = valid.any()
    first = torch.argmax(valid.to(torch.int8))
    with sync("set_rows"):
        fb_first = idx[first]
    with sync("set_rows"):
        fb_zero = torch.zeros_like(idx[first])
    fb_idx = torch.where(any_valid, fb_first, fb_zero)
    with sync("set_rows"):
        fb_vals = vals[first]
    fb_val = torch.where(any_valid, fb_vals, dst[0])
    mask = valid.view((-1,) + (1,) * (vals.dim() - 1))
    dst.index_copy_(0, torch.where(valid, idx, fb_idx), torch.where(mask, vals, fb_val))


def _cuts(lo: int, hi: int, bounds) -> list:
    """[lo, hi) cut at every bound strictly inside it: (start, stop) pairs
    (none where lo >= hi)."""
    if lo >= hi:
        return []
    pts = sorted({lo, hi, *(b for b in bounds if lo < b < hi)})
    return [(a, b) for a, b in zip(pts, pts[1:]) if b > a]


@dataclasses.dataclass(frozen=True)
class _Program:
    """The resolved configuration of one distributed LU; calling it runs
    this rank's share of supersteps [k0, k1)."""

    geom: LUGeometry
    backend: str
    kernel_panel: bool
    panel_chunk: int
    donate: bool
    resumable: bool
    lookahead: bool
    election: str
    segs: tuple
    tree: str
    update: str
    precision: object  # blas.Precision of the library products

    def __call__(self, shard: torch.Tensor, mesh, orig=None, k0: int = 0, k1: int | None = None):
        k1 = self.geom.n_steps if k1 is None else k1
        return _factor(self, shard, mesh, orig, k0, k1)


def _factor(prog: _Program, shard: torch.Tensor, mesh, orig, k0: int, k_end: int):
    geom = prog.geom
    v = geom.v
    Px, Py, Pz = geom.grid.Px, geom.grid.Py, geom.grid.Pz
    Ml, Nl = geom.Ml, geom.Nl
    nlayr = geom.nlayr
    Mcap = geom.M  # positions are < Mcap; the sentinel exceeds it
    x, y, z = mesh.coords
    dev = shard.device
    dtype = shard.dtype
    cdtype = blas.compute_dtype(dtype)
    z0 = z == 0
    row_bounds = [lo for lo, _ in ragged_segments(geom.Mtl, v, prog.segs[0])]
    col_bounds = [lo for lo, _ in ragged_segments(geom.Ntl, v, prog.segs[1])]

    # z-partial invariant: the sum over z is the true matrix; data enters
    # on layer 0 (a resumed state is z-replicated: layer 0 restores it)
    if z0:
        Aloc = shard if prog.donate else shard.clone(memory_format=torch.contiguous_format)
    else:
        Aloc = torch.zeros((Ml, Nl), dtype=dtype, device=dev)
    lr = torch.arange(Ml, device=dev)
    gp = ((lr // v) * Px + x) * v + lr % v  # global POSITION of each local row
    # original row id at each local position (rows start in original order)
    orig = gp.clone() if orig is None else orig.to(device=dev, dtype=torch.int64).clone()
    kernel = prog.kernel_panel
    elect_chunk = min(prog.panel_chunk, blas.batched_call_rows(v, cdtype))

    def frow(t):  # first local row whose tile index is >= t
        return first_local_tile(t, x, Px) * v

    def fcol(t):  # first local column whose tile index is >= t
        return first_local_tile(t, y, Py) * v

    def loc_of(pos):
        """Local row of each global position; Ml where another x-rank owns
        it or it is the sentinel."""
        tile = pos // v
        owned = (tile % Px == x) & (pos < Mcap)
        return torch.where(owned, (tile // Px) * v + pos % v, torch.full_like(pos, Ml))

    def panel_reduce(k):
        """Live rows of panel column k: z-reduce + y-broadcast in one sum
        over (y, z) (ref step 0)."""
        r0, lj = frow(k), (k // Py) * v
        if y == k % Py:
            part = Aloc[r0:, lj:lj + v].clone(memory_format=torch.contiguous_format)
        else:
            part = torch.zeros((Ml - r0, v), dtype=dtype, device=dev)
        return mesh.psum(part, ("y", "z")).to(cdtype)

    def elect(panel, k):
        """Tournament pivoting over x (ref step 1): (lu00, wpos), the
        winners' packed LU and global positions in pivot order."""
        r0 = frow(k)
        n_live = Ml - r0
        lu00, top = blas.tournament_winners_live(panel, Ml, chunk=prog.panel_chunk,
                                                 use_pallas=kernel, tree=prog.tree)
        ok = (top >= r0) & (top < Ml)
        wpos = torch.where(ok, gp[top.clamp(0, Ml - 1)], _GRI_SENTINEL)
        if Px == 1:  # single x-rank: the local nomination IS the election
            return lu00, wpos
        nom = _take_rows(panel, torch.where(ok, top - r0, n_live), n_live)
        if prog.election == "butterfly":
            # the reference's hypercube exchange (`conflux_opt.hpp:220-336`):
            # log2(Px) ppermute rounds of pair-ordered (2v, v) stacks;
            # off-subcube ranks of odd Px fold in and out
            def reduce_pair(top_, bot_):
                stack = torch.cat([top_[0], bot_[0]])
                ids = torch.cat([top_[1], bot_[1]])
                lu00_, wid = blas.tournament_winners(stack, chunk=elect_chunk,
                                                     use_pallas=kernel)
                return (_take_rows(stack, wid, 2 * v), _take_rows(ids, wid, 2 * v,
                                                                  _GRI_SENTINEL), lu00_)

            _nom, wpos, lu00 = butterfly_allreduce(
                mesh, (nom, wpos, torch.zeros((v, v), dtype=cdtype, device=dev)), Px,
                AXIS_X, reduce_pair)
            return lu00, wpos
        blks = mesh.all_gather(nom, AXIS_X)  # (Px, v, v)
        poss = mesh.all_gather(wpos, AXIS_X)  # (Px, v)
        lu00, wid = blas.tournament_winners(blks.reshape(Px * v, v), chunk=elect_chunk,
                                            use_pallas=kernel, tree=prog.tree)
        return lu00, _take_rows(poss.reshape(Px * v), wid, Px * v, _GRI_SENTINEL)

    def gemm_piece(L10s, U01s, r1, c1, ra, rb, ca, cb):
        blk = Aloc[ra:rb, ca:cb]
        blas.gemm(L10s[ra - r1:rb - r1], U01s[:, ca - c1:cb - c1], blk, -1.0, 1.0,
                  prog.precision, prog.backend, out=blk)

    def step(k, panel, lu00, wpos):
        """Superstep k on this rank, given its panel and the election;
        returns step k+1's (panel, lu00, wpos) when it computed them
        (lookahead), else None."""
        j_owner, lj = k % Py, (k // Py) * v
        own_d, li = x == k % Px, (k // Px) * v
        r0, r1, c1 = frow(k), frow(k + 1), fcol(k + 1)
        U00 = torch.triu(lu00)
        L00 = blas.unit_lower(lu00)

        # ---- LAPACK-style row swaps (ref push_pivots_up, step 2) --------- #
        # winners move into the step's diagonal block (positions k*v..
        # (k+1)*v); the non-winner occupants move to the slots vacated by
        # external winners (i-th displaced occupant -> i-th vacated
        # position, both ascending)
        with scope("step2_pivotrows"):
            slots = k * v + torch.arange(v, device=dev)
            occ_is_winner = (wpos[None, :] == slots[:, None]).any(1)
            is_ext = wpos >= (k + 1) * v
            both = is_ext[None, :] & is_ext[:, None]
            rank = (both & (wpos[None, :] < wpos[:, None])).sum(1)
            ext_sorted = torch.full((v + 1,), _GRI_SENTINEL, dtype=torch.int64, device=dev)
            ext_sorted.scatter_(0, torch.where(is_ext, rank, v), wpos)  # slot v: dropped
            disp_rank = torch.cumsum((~occ_is_winner).to(torch.int64), 0) - 1
            dest_disp = torch.where(~occ_is_winner, ext_sorted[disp_rank.clamp(min=0)],
                                    _GRI_SENTINEL)

            # winners' full rows and the displaced occupants' rows, reduced over
            # (x, z) in one sum; their row ids and the occupants' panel rows
            # over x (ref step 3)
            wloc = loc_of(wpos)
            rows = torch.cat([_take_rows(Aloc, wloc, Ml),
                              Aloc[li:li + v] if own_d
                              else torch.zeros((v, Nl), dtype=dtype, device=dev)])
            mesh.psum(rows, ("x", "z"))
            Prows, Drows = rows[:v], rows[v:]
            ids = torch.cat([_take_rows(orig, wloc, Ml),
                             orig[li:li + v] if own_d else torch.zeros_like(orig[:v])])
            mesh.psum(ids, AXIS_X)
            worig, dorig = ids[:v], ids[v:]
            diag_panel = (panel[li - r0:li - r0 + v].clone() if own_d
                          else torch.zeros((v, v), dtype=cdtype, device=dev))
            mesh.psum(diag_panel, AXIS_X)

            # swap writes: vacated positions take the displaced rows (they stay
            # active and take the trailing update, their z-summed value on
            # layer 0); the diagonal rows are rewritten after the update
            didx = loc_of(dest_disp)
            _set_rows(Aloc, didx, Drows if z0 else torch.zeros_like(Drows))
            if own_d:
                orig[li:li + v] = worig
            _set_rows(orig, didx, dorig)
            # the panel after the swap, for the L10 solve (displaced rows only
            # matter: the diagonal rows are not in the live suffix)
            panel_post = panel.clone()
            _set_rows(panel_post, didx - r0, diag_panel)

        # ---- L10 on the live rows, U01 on the live columns (steps 4, 5) -- #
        with scope("step4_dtrsm"):
            L10 = blas.trsm_right_upper(U00, panel_post[r1 - r0:]).contiguous()  # (Ml-r1, v)
        with scope("step5_dtrsm"):
            U01 = blas.trsm_left_lower_unit(L00, Prows[:, c1:].to(cdtype)).contiguous()

        # ---- trailing update on this layer's slab (ref step 6) ---------- #
        z_lo, z_hi = min(z * nlayr, v), min((z + 1) * nlayr, v)
        L10s = L10[:, z_lo:z_hi].to(dtype)
        U01s = U01[z_lo:z_hi].to(dtype)
        if prog.update == "block":
            rcuts, cbounds = [(r1, Ml)], []
        else:
            rcuts, cbounds = _cuts(r1, Ml, row_bounds), col_bounds
        # the next panel's column slab is a piece of its own, in the plain
        # loop as under lookahead, and in a run that stops before step k+1
        # as in one that goes on: all compute it in the same GEMMs (a
        # resumed factor is bitwise the one-shot one)
        kn = k + 1
        slab = kn < geom.n_steps and y == kn % Py
        lj1 = (kn // Py) * v
        ccuts = _cuts(c1, Nl, list(cbounds) + ([lj1, lj1 + v] if slab else []))
        nxt = None
        if prog.lookahead and kn < k_end:
            # the next step's panel and election come from the updated slab
            # alone: no data dependence on the rest of this step's GEMMs
            # (the slab's GEMMs are the next reduce's, as in the reference)
            with scope("step0_reduce"):
                if z_hi > z_lo and r1 < Ml and slab:
                    for ra, rb in rcuts:
                        gemm_piece(L10s, U01s, r1, c1, ra, rb, lj1, lj1 + v)
                    ccuts = [(a, b) for a, b in ccuts if (a, b) != (lj1, lj1 + v)]
                panel_n = panel_reduce(kn)
            with scope("step1_pivoting"):
                nxt = (panel_n,) + elect(panel_n, kn)
        with scope("step6_dgemm"):
            if z_hi > z_lo and r1 < Ml:
                for ca, cb in ccuts:
                    for ra, rb in rcuts:
                        gemm_piece(L10s, U01s, r1, c1, ra, rb, ca, cb)

        # ---- factor writes (z == 0 carries the factors) ------------------ #
        # diagonal block rows: leading columns keep the winners' frozen L
        # prefix (Prows), trailing columns take U01; the panel tile itself
        # takes the packed lu00 below
        with scope("step7_writes"):
            if own_d:
                if z0:
                    Aloc[li:li + v, :c1] = Prows[:, :c1]
                    Aloc[li:li + v, c1:] = U01.to(dtype)
                else:
                    Aloc[li:li + v] = 0
            if y == j_owner:
                if z0:
                    Aloc[r1:, lj:lj + v] = L10.to(dtype)
                    if own_d:
                        Aloc[li:li + v, lj:lj + v] = lu00.to(dtype)
                else:
                    Aloc[:, lj:lj + v] = 0
        return nxt

    carry = None
    for k in range(k0, k_end):
        if carry is None:
            with scope("step0_reduce"):
                panel = panel_reduce(k)
            with scope("step1_pivoting"):
                carry = (panel,) + elect(panel, k)
        carry = step(k, *carry)
    # all factors live on layer 0: the sum makes the output z-replicated
    Aout = mesh.psum(Aloc, "z")
    # the permutation: original row id at every global position
    perm = torch.zeros((Mcap,), dtype=torch.int64, device=dev)
    perm[gp] = orig
    mesh.psum(perm, AXIS_X)
    mesh.pmax(perm, ("y", "z"))  # identical already; re-establishes replication
    if not prog.resumable:
        return Aout, perm
    return Aout, mesh.pmax(orig, ("y", "z")), perm


def build_program(geom: LUGeometry, mesh=None, precision=None, backend: str | None = None,
                  panel_chunk: int | None = None, donate: bool = False,
                  resumable: bool = False, lookahead: bool = False,
                  election: str = "gather", segs: tuple = (16, 16),
                  tree: str = "pairwise", update: str = "segments", dtype=None, *,
                  panel_algo: str | None = None) -> _Program:
    """The distributed LU program of one configuration, every default and
    argument check resolved here (`lu_factor_distributed` and
    `lu_factor_steps` go through it). Pass the input `dtype` the program
    will run: the panel_chunk default and the tree='flat' height guard
    resolve chunk ceilings with its compute dtype, and the routes check it.

    `backend` picks the trailing GEMM ("kernel": K1, "xla": the library
    product; default the registry's), `panel_algo` the election's LU
    ("kernel": K2, float32 with v a multiple of 128; "auto", "partial" or
    "tournament": the library LU; default the registry's). `mesh` is
    accepted for the reference's signature; a program runs on any rank's
    mesh of the geometry's grid. `precision` is the library trailing
    update's (`blas.gemm`; None: the registry's): DEFAULT and HIGH run it
    as one TF32 pass on the card, K1 is IEEE float32 at every level; the
    parameters up to `dtype` stand where the JAX package has them, and the
    port's own (`panel_algo`) are keyword-only."""
    precision = blas.resolve_precision(precision)
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    panel_algo = blas.get_panel_algo() if panel_algo is None else panel_algo
    if panel_algo not in ("kernel", "auto", "partial", "tournament"):
        raise ValueError(f"unknown panel algo {panel_algo!r}")
    tdtype = torch.float32 if dtype is None else dtype
    cdtype = blas.compute_dtype(tdtype)
    blas.check_gemm_route(backend, tdtype)
    kernel_panel = panel_algo == "kernel"
    if kernel_panel and (cdtype != torch.float32 or geom.v % 128):
        raise ValueError(
            f"panel algo 'kernel' runs the elections on the K2 kernel, which takes "
            f"float32 panels of width a multiple of 128, got {cdtype} v={geom.v}; "
            "other dtypes and widths run the library panel algos ('auto', 'partial', "
            "'tournament')")
    if panel_chunk is None:
        panel_chunk = blas.single_call_rows(geom.v, cdtype)
    if election not in ("gather", "butterfly"):
        raise ValueError(f"unknown election {election!r} (gather|butterfly)")
    if len(segs) != 2 or segs[0] < 1 or segs[1] < 1:
        raise ValueError(
            f"segs must be two positive segment counts, got {segs!r} "
            "(non-positive counts would silently skip trailing updates)")
    if tree not in ("pairwise", "flat"):
        raise ValueError(f"unknown tree {tree!r} (pairwise|flat)")
    if tree == "flat":
        # the flat election is ONE (nch v, v) LU of all the nominees; keep
        # every such stack within the single-call height the JAX package
        # derives (the local nomination over Ml rows, and with the gather
        # election at Px > 1 the cross-x election over Px v nominees)
        v = geom.v
        stacks = []
        _, nch = blas.chunk_layout(geom.Ml, v, panel_chunk)
        if nch > 1:
            stacks.append(nch * v)
        if geom.grid.Px > 1 and election == "gather":
            _, nch2 = blas.chunk_layout(geom.grid.Px * v, v,
                                        min(panel_chunk, blas.batched_call_rows(v, cdtype)))
            if nch2 > 1:
                stacks.append(nch2 * v)
        if stacks and max(stacks) > blas.single_call_rows(v, cdtype):
            raise ValueError(
                f"tree='flat' would stack {max(stacks)} nominee rows of width {v} in "
                f"one LU call (> the {blas.single_call_rows(v, cdtype)}-row "
                f"single-call height for {cdtype}); raise panel_chunk or use "
                "tree='pairwise'")
    if update not in ("segments", "block"):
        raise ValueError(f"unknown update {update!r} (segments|block)")
    return _Program(geom, backend, kernel_panel, panel_chunk, donate, resumable,
                    lookahead, election, tuple(segs), tree, update, precision)


def _rank_shard(shards, geom, mesh) -> torch.Tensor:
    """This rank's (Ml, Nl) shard: `shards` is that shard (a tensor) or the
    full (Px, Py, Ml, Nl) array."""
    check_shards(shards, geom)
    if tuple(shards.shape) == (geom.Ml, geom.Nl) and isinstance(shards, torch.Tensor):
        return shards
    return distribute_shards(shards, mesh)


def lu_factor_distributed(shards, geom: LUGeometry, mesh, precision=None,
                          backend: str | None = None, panel_chunk: int | None = None,
                          donate: bool = False, lookahead: bool = False,
                          election: str = "gather", segs: tuple = (16, 16),
                          tree: str = "pairwise", update: str = "segments", *,
                          panel_algo: str | None = None):
    """Factor this rank's block-cyclic shard in place on the grid; every
    rank of `mesh`'s world calls it together.

    `shards` is this rank's (Ml, Nl) tensor on its device (or the full
    (Px, Py, Ml, Nl) array, of which the rank takes its own). Returns
    (shard_out, perm): shard_out the rank's shard of the packed factors in
    *pivoted row order* (LAPACK getrf layout: global position p holds the
    factor row of original row perm[p]), z-replicated; perm (M,) int64,
    identical on every rank. Rows eliminated at step k occupy positions
    k*v..(k+1)*v, so perm[:n_steps*v] reshaped to (n_steps, v) is the
    elimination record.

    Rank-deficient inputs: supersteps whose candidates are exactly zero
    elect no valid rows, leaving that block's perm entries unspecified and
    its factor rows garbage (the getrf `info > 0` situation).

    `panel_chunk` bounds the height of every nomination chunk (default
    `blas.single_call_rows(v)`, the JAX package's, so the chunks and with
    them the pivots are its); `donate=True` factors the caller's shard in
    place (on layer 0) instead of a copy. `lookahead=True` runs the
    software-pipelined loop: step k+1's panel and election come from a
    separately updated column slab before the rest of step k's trailing
    update (bitwise the plain loop's results). `election` "gather" or
    "butterfly", `tree` "pairwise" or "flat" (CALU elections both; pivots
    can differ on ties), `segs` (row, col) trailing-update segment counts
    and `update` "segments" or "block" (one piece per step) as in the JAX
    package.
    """
    shard = _rank_shard(shards, geom, mesh)
    fn = build_program(geom, mesh, precision, backend=backend, panel_algo=panel_algo,
                       panel_chunk=panel_chunk, donate=donate, lookahead=lookahead,
                       election=election, segs=segs, tree=tree, update=update,
                       dtype=shard.dtype)
    return fn(shard, mesh)


def lu_factor_steps(shards, geom: LUGeometry, mesh, k0: int, k1: int, orig=None,
                    precision=None, backend: str | None = None,
                    panel_chunk: int | None = None, donate: bool = False,
                    election: str = "gather", segs: tuple = (16, 16),
                    tree: str = "pairwise", update: str = "segments", *,
                    panel_algo: str | None = None):
    """Factor supersteps [k0, k1) only: the checkpoint/restart primitive.

    After k steps the matrix lives in LAPACK-order positions: global
    positions < k*v hold frozen factor rows and the rest is the updated
    trailing problem. State = (shard, orig): `orig` is this rank's (Ml,)
    row-origin map (original row id at each local position; the full
    (Px, Ml) map of the JAX package is accepted too, and the rank takes
    its row). Pass orig=None when k0 == 0; feed each call's outputs to the
    next. Returns (shard_out, orig_out, perm); perm is the final
    permutation once k1 == geom.n_steps.

    Bitwise caveat: the state consolidates the 2.5D z-partial sums into
    one z-replicated copy, so with Pz > 1 a resumed run re-associates those
    sums (equivalent, not bit-identical). Pz == 1 round-trips exactly.
    """
    if not (0 <= k0 < k1 <= geom.n_steps):
        raise ValueError(f"step range [{k0}, {k1}) outside [0, {geom.n_steps})")
    if orig is None and k0 != 0:
        raise ValueError("resuming at k0 > 0 requires the orig state returned by the "
                         "previous lu_factor_steps call")
    shard = _rank_shard(shards, geom, mesh)
    if orig is not None:
        orig = torch.as_tensor(orig)
        if orig.dim() == 2:
            orig = orig[mesh.x]
    fn = build_program(geom, mesh, precision, backend=backend, panel_algo=panel_algo,
                       panel_chunk=panel_chunk, donate=donate, resumable=True,
                       election=election, segs=segs, tree=tree, update=update,
                       dtype=shard.dtype)
    return fn(shard, mesh, orig, k0, k1)


def lu_distributed_host(A: np.ndarray, grid: Grid3, v: int, mesh=None, precision=None,
                        backend: str | None = None, panel_chunk: int | None = None,
                        segs: tuple = (16, 16), tree: str = "pairwise",
                        update: str = "segments", *, panel_algo: str | None = None,
                        device=None):
    """Host-level convenience, called by every rank together: scatter a
    global matrix, factor on the grid, gather back. Returns (LU_packed
    (M, N) in original row order, perm (M,), geom) as numpy, on every
    rank. `mesh` defaults to `make_mesh(grid, device=device)` (the card
    unless `device="cpu"`). The role of the reference's `lu_params` +
    `LU_rep` + validation-gather pipeline
    (`examples/conflux_miniapp.cpp:92-167`)."""
    geom = LUGeometry.create(A.shape[0], A.shape[1], v, grid)
    if mesh is None:
        mesh = make_mesh(grid, device=device)
    shard = distribute_shards(geom.scatter(np.asarray(A)), mesh)
    out, perm = lu_factor_distributed(shard, geom, mesh, precision, backend=backend,
                                      panel_algo=panel_algo, panel_chunk=panel_chunk,
                                      donate=True, segs=segs, tree=tree, update=update)
    perm = perm.cpu().numpy()
    LUp = geom.gather(gather_shards(out, mesh).cpu().numpy())  # pivoted order
    LU = np.empty_like(LUp)
    LU[perm] = LUp  # back to original row order (LU[perm] == L@U packing)
    return LU, perm, geom


def full_permutation(pivots: np.ndarray, M: int) -> np.ndarray:
    """Elimination order -> row permutation of length M: pivots is
    (n_steps, v) global row indices; rows never chosen (only when M > N)
    are appended in ascending order as pure-L rows."""
    order = pivots.reshape(-1)
    if order.size < M:
        rest = np.setdiff1d(np.arange(M), order)
        order = np.concatenate([order, rest])
    return order
