"""Layout descriptors and redistribution — the COSTA role (the port's own
numpy copy of `conflux_tpu/layout.py`, on its own `Grid3` and its own
native tile packing, `conflux_tpu_torch.native`).

The reference delegates grid/layout redistribution to the vendored COSTA
library via its `conflux_layout` adapter (`src/conflux/lu/layout.cpp:31-135`):
a conflux tile distribution is described either as a ScaLAPACK-style
`block_cyclic_layout` or as a `custom_layout` with explicit per-tile owners,
and `costa::transform` moves data between any two such layouts.

Here a layout is a small descriptor over a host matrix, and `transform`
re-buckets tiles between two block-cyclic layouts (different tile sizes
and/or grids) in one vectorized pass. On the devices each rank holds its
own shard (`parallel.mesh.distribute_shards`); this module is the
host-side half, the ScaLAPACK-interop surface.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from conflux_tpu_torch.geometry import Grid3


@dataclasses.dataclass(frozen=True)
class BlockCyclicLayout:
    """ScaLAPACK-descriptor-style block-cyclic layout over a (Prows, Pcols)
    grid (role of `costa::block_cyclic_layout` as used in `layout.cpp:63-113`).
    """

    M: int
    N: int
    vr: int  # row tile size
    vc: int  # col tile size
    Prows: int
    Pcols: int

    @classmethod
    def for_grid(cls, M: int, N: int, v: int, grid: Grid3) -> "BlockCyclicLayout":
        return cls(M=M, N=N, vr=v, vc=v, Prows=grid.Px, Pcols=grid.Py)

    def owner(self, ti: int, tj: int) -> tuple[int, int]:
        """Owning grid coordinate of tile (ti, tj) — the conflux
        owner-computes map (`layout.cpp:114-123`)."""
        return ti % self.Prows, tj % self.Pcols

    def tile_counts(self) -> tuple[int, int]:
        return -(-self.M // self.vr), -(-self.N // self.vc)

    def local_shape(self, p: int, q: int) -> tuple[int, int]:
        """Local buffer extent on grid coordinate (p, q), numroc-style
        (role of `examples/utils.hpp` local-size math)."""
        Mt, Nt = self.tile_counts()
        nrt = (Mt - p + self.Prows - 1) // self.Prows
        nct = (Nt - q + self.Pcols - 1) // self.Pcols
        last_r = self.M - (Mt - 1) * self.vr
        last_c = self.N - (Nt - 1) * self.vc
        rows = nrt * self.vr - (last_r != self.vr and self.owner(Mt - 1, 0)[0] == p) * (self.vr - last_r)
        cols = nct * self.vc - (last_c != self.vc and self.owner(0, Nt - 1)[1] == q) * (self.vc - last_c)
        return rows, cols

    def owner_map(self) -> np.ndarray:
        """(Mt, Nt, 2) explicit per-tile owner array — the
        `costa::custom_layout` form (`layout.cpp:114-135`)."""
        Mt, Nt = self.tile_counts()
        ti = np.arange(Mt)[:, None]
        tj = np.arange(Nt)[None, :]
        return np.stack(
            np.broadcast_arrays(ti % self.Prows, tj % self.Pcols), axis=-1
        )


@dataclasses.dataclass(frozen=True)
class CustomLayout:
    """Explicit per-tile owner layout — the `costa::custom_layout` role
    (`src/conflux/lu/layout.cpp:114-135`): uniform (vr, vc) tiles whose
    owners form an ARBITRARY (Mt, Nt, 2) array rather than the cyclic
    `(ti % Prows, tj % Pcols)` rule. conflux itself only ever builds the
    cyclic form, but COSTA accepts any owner array; this closes that
    last sliver of the adapter surface.

    Local storage convention: because an arbitrary owner set is not a
    product of row/col tile sets, a coordinate's tiles do not pack into
    one rectangle — storage is `{(p, q): {(ti, tj): tile}}` with each
    tile row-major and trailing tiles short, matching COSTA's
    block-pointer representation rather than ScaLAPACK's dense local
    matrix."""

    M: int
    N: int
    vr: int
    vc: int
    owners: tuple  # hashable (Mt, Nt, 2) owner entries; use .owner()

    @classmethod
    def from_owner_map(cls, M: int, N: int, vr: int, vc: int,
                       owners: np.ndarray) -> "CustomLayout":
        owners = np.asarray(owners, dtype=np.int64)
        Mt, Nt = -(-M // vr), -(-N // vc)
        if owners.shape != (Mt, Nt, 2):
            raise ValueError(
                f"owner map shape {owners.shape} != tile grid {(Mt, Nt, 2)}")
        if owners.min() < 0:
            raise ValueError("owner coordinates must be non-negative")
        return cls(M=M, N=N, vr=vr, vc=vc,
                   owners=tuple(map(tuple, owners.reshape(-1, 2).tolist())))

    def tile_counts(self) -> tuple[int, int]:
        return -(-self.M // self.vr), -(-self.N // self.vc)

    def owner(self, ti: int, tj: int) -> tuple[int, int]:
        _, Nt = self.tile_counts()
        return self.owners[ti * Nt + tj]

    def tile_shape(self, ti: int, tj: int) -> tuple[int, int]:
        return (min((ti + 1) * self.vr, self.M) - ti * self.vr,
                min((tj + 1) * self.vc, self.N) - tj * self.vc)

    def scatter(self, A: np.ndarray) -> dict:
        """Split a host matrix into the per-owner tile stores."""
        out: dict = {}
        Mt, Nt = self.tile_counts()
        for ti in range(Mt):
            for tj in range(Nt):
                r0, c0 = ti * self.vr, tj * self.vc
                h, w = self.tile_shape(ti, tj)
                out.setdefault(self.owner(ti, tj), {})[(ti, tj)] = (
                    A[r0 : r0 + h, c0 : c0 + w].copy())
        return out

    def gather(self, store: dict) -> np.ndarray:
        """Inverse of :meth:`scatter`."""
        some = next(iter(next(iter(store.values())).values()))
        A = np.zeros((self.M, self.N), some.dtype)
        Mt, Nt = self.tile_counts()
        for ti in range(Mt):
            for tj in range(Nt):
                tile = store[self.owner(ti, tj)][(ti, tj)]
                A[ti * self.vr : ti * self.vr + tile.shape[0],
                  tj * self.vc : tj * self.vc + tile.shape[1]] = tile
        return A


def _src_view(shards, src, r: int, r_end: int, c: int, c_end: int):
    """View of global region [r:r_end, c:c_end] — which must lie within
    ONE source tile — from either layout kind's storage."""
    sti, stj = r // src.vr, c // src.vc
    sp, sq = src.owner(sti, stj)
    if isinstance(src, CustomLayout):
        tile = shards[sp, sq][(sti, stj)]
        return tile[r - sti * src.vr : r_end - sti * src.vr,
                    c - stj * src.vc : c_end - stj * src.vc]
    sbuf = shards[sp][sq]
    sr = ((sti - sp) // src.Prows) * src.vr + (r - sti * src.vr)
    sc = ((stj - sq) // src.Pcols) * src.vc + (c - stj * src.vc)
    return sbuf[sr : sr + (r_end - r), sc : sc + (c_end - c)]


def _copy_region(shards, src, r0: int, r1: int, c0: int, c1: int,
                 out: np.ndarray, or0: int, oc0: int) -> None:
    """Walk the source tiles covering [r0:r1, c0:c1] and copy into
    out[or0.., oc0..] — the shared kernel of every transform direction."""
    r = r0
    while r < r1:
        r_end = min((r // src.vr + 1) * src.vr, r1)
        c = c0
        while c < c1:
            c_end = min((c // src.vc + 1) * src.vc, c1)
            out[or0 + (r - r0) : or0 + (r - r0) + (r_end - r),
                oc0 + (c - c0) : oc0 + (c - c0) + (c_end - c)] = (
                _src_view(shards, src, r, r_end, c, c_end))
            c = c_end
        r = r_end


def numroc(n: int, nb: int, iproc: int, isrcproc: int, nprocs: int) -> int:
    """NUMber of Rows Or Columns: ScaLAPACK's exact `numroc` formula
    (the reference links it via `examples/utils.hpp` local-size math).
    Rows/cols of a block-cyclically distributed dimension owned by
    process `iproc` when the first block lives on `isrcproc`."""
    mydist = (nprocs + iproc - isrcproc) % nprocs
    nblocks = n // nb
    num = (nblocks // nprocs) * nb
    extrablks = nblocks % nprocs
    if mydist < extrablks:
        num += nb
    elif mydist == extrablks:
        num += n % nb
    return num


def scalapack_desc(layout: BlockCyclicLayout, p: int = 0,
                   ctxt: int = 0) -> np.ndarray:
    """The 9-integer ScaLAPACK array descriptor for this layout, as a
    caller in process row p would pass to p?gemm/descinit_
    (`examples/conflux_miniapp.cpp:404-500` builds these for the pdgemm
    validation). Entries: [DTYPE_, CTXT_, M_, N_, MB_, NB_, RSRC_, CSRC_,
    LLD_]; LLD_ is the caller's local leading dimension (column-major,
    ScaLAPACK convention), i.e. its numroc row count — it depends only on
    the process ROW, so no column coordinate is taken.
    """
    lld = max(1, numroc(layout.M, layout.vr, p, 0, layout.Prows))
    return np.array(
        [1, ctxt, layout.M, layout.N, layout.vr, layout.vc, 0, 0, lld],
        dtype=np.int64,
    )


def indxg2p(ig: int, nb: int, isrcproc: int, nprocs: int) -> int:
    """Owning process coordinate of global index `ig` (0-based form of
    ScaLAPACK TOOLS `INDXG2P`, the coordinate half of the
    `examples/utils.hpp` glue)."""
    return (isrcproc + ig // nb) % nprocs


def indxg2l(ig: int, nb: int, nprocs: int) -> int:
    """Local index of global index `ig` on its owning process (0-based
    `INDXG2L`). Together with `indxg2p` this defines ScaLAPACK's local
    element placement; `to_scalapack` is verified against it."""
    return (ig // (nb * nprocs)) * nb + ig % nb


def to_scalapack(A: np.ndarray, layout: BlockCyclicLayout
                 ) -> tuple[list[list[np.ndarray]], list[list[np.ndarray]]]:
    """Distribute a host matrix into ScaLAPACK-convention local buffers.

    Returns (locals, descs): `locals[p][q]` is the column-major
    (Fortran-order) local matrix process (p, q) would pass to a p?gemm /
    p?getrf call, `descs[p][q]` its 9-integer array descriptor. The
    reference hands matrices to ScaLAPACK for its pdgemm-based validation
    (`examples/conflux_miniapp.cpp:404-500`); this is the equivalent
    export surface, so factors computed here can be consumed by an
    existing ScaLAPACK pipeline (and vice versa via `from_scalapack`).

    Element placement: ScaLAPACK's local matrix is the owned blocks
    packed densely in global order — the same index map as our row-major
    shard buffers — so the conversion is a memory-order change plus the
    descriptor, not a re-bucketing.
    """
    shards = scatter(A, layout)
    locals_ = [[np.asfortranarray(shards[p][q])
                for q in range(layout.Pcols)] for p in range(layout.Prows)]
    descs = [[scalapack_desc(layout, p=p) for _q in range(layout.Pcols)]
             for p in range(layout.Prows)]
    return locals_, descs


def from_scalapack(locals_: list[list[np.ndarray]],
                   layout: BlockCyclicLayout) -> np.ndarray:
    """Assemble a host matrix from ScaLAPACK-convention local buffers
    (inverse of :func:`to_scalapack`; accepts any memory order — gather's
    sliced reads are order-agnostic, so no copy is made)."""
    return gather(locals_, layout)


def scatter(A: np.ndarray, layout: BlockCyclicLayout) -> list[list[np.ndarray]]:
    """Split a global matrix into per-coordinate local buffers (tiles in
    local block-cyclic order, row-major within)."""
    return [
        [_gather_tiles(A, layout, p, q) for q in range(layout.Pcols)]
        for p in range(layout.Prows)
    ]


def _gather_tiles(A: np.ndarray, lay: BlockCyclicLayout, p: int, q: int) -> np.ndarray:
    Mt, Nt = lay.tile_counts()
    row_tiles = range(p, Mt, lay.Prows)
    col_tiles = range(q, Nt, lay.Pcols)
    if not len(row_tiles) or not len(col_tiles):
        # this coordinate owns no tiles (grid larger than the tile grid);
        # the empty buffer still carries the one-sided numroc extents so
        # ScaLAPACK consumers see shape[0] == LLD row count
        return np.zeros(lay.local_shape(p, q), A.dtype)
    blocks = [
        np.concatenate(
            [r[:, tj * lay.vc : min((tj + 1) * lay.vc, lay.N)] for tj in col_tiles],
            axis=1,
        )
        for r in (A[ti * lay.vr : min((ti + 1) * lay.vr, lay.M)] for ti in row_tiles)
    ]
    return np.concatenate(blocks, axis=0)


def gather(shards: list[list[np.ndarray]], layout: BlockCyclicLayout) -> np.ndarray:
    """Inverse of :func:`scatter`."""
    dtype = shards[0][0].dtype
    A = np.zeros((layout.M, layout.N), dtype=dtype)
    Mt, Nt = layout.tile_counts()
    for p in range(layout.Prows):
        for q in range(layout.Pcols):
            loc = shards[p][q]
            for li, ti in enumerate(range(p, Mt, layout.Prows)):
                r0, r1 = ti * layout.vr, min((ti + 1) * layout.vr, layout.M)
                for lj, tj in enumerate(range(q, Nt, layout.Pcols)):
                    c0, c1 = tj * layout.vc, min((tj + 1) * layout.vc, layout.N)
                    A[r0:r1, c0:c1] = loc[
                        li * layout.vr : li * layout.vr + (r1 - r0),
                        lj * layout.vc : lj * layout.vc + (c1 - c0),
                    ]
    return A


def transform(shards, src, dst):
    """Redistribute between layouts (the `costa::transform` role,
    `examples/conflux_miniapp.cpp:349-353`). Either side may be a
    :class:`BlockCyclicLayout` (list-of-lists local rectangles) or a
    :class:`CustomLayout` (per-owner tile stores); tile sizes and grids
    may differ; shapes must agree.

    Streams tile intersections directly from source local buffers into
    each destination local buffer — COSTA's whole reason to exist is
    moving between layouts *without* materializing the global matrix
    (`src/conflux/lu/layout.cpp:48`), so peak extra memory here is one
    destination-coordinate buffer (block-cyclic) or one tile (custom),
    never (M, N). Exception: for uniform-square-tile transforms below
    `_NATIVE_TRANSFORM_MAX_BYTES`, an OpenMP fast path trades ~2x the
    matrix of transient memory for one native pass (conflux_tpu_torch.native);
    larger matrices keep the constant-memory walk.
    """
    if (src.M, src.N) != (dst.M, dst.N):
        raise ValueError(f"layout shapes differ: {(src.M, src.N)} vs {(dst.M, dst.N)}")
    if isinstance(dst, CustomLayout):
        fast = _native_bc_to_custom(shards, src, dst)
        if fast is not None:
            return fast
        dtype = _src_dtype(shards, src)
        out: dict = {}
        Mt, Nt = dst.tile_counts()
        for ti in range(Mt):
            for tj in range(Nt):
                h, w = dst.tile_shape(ti, tj)
                tile = np.zeros((h, w), dtype)
                _copy_region(shards, src, ti * dst.vr, ti * dst.vr + h,
                             tj * dst.vc, tj * dst.vc + w, tile, 0, 0)
                out.setdefault(dst.owner(ti, tj), {})[(ti, tj)] = tile
        return out
    fast = _native_custom_to_bc(shards, src, dst)
    if fast is not None:
        return fast
    return [
        [_build_local(shards, src, dst, p, q) for q in range(dst.Pcols)]
        for p in range(dst.Prows)
    ]


# above this source size the native fast paths (which stage ~2x the
# matrix of transient buffers) yield to the constant-extra-memory walk
_NATIVE_TRANSFORM_MAX_BYTES = 1 << 30


def _uniform_square_tiles(src, dst) -> bool:
    """One tile size throughout and exact tiling on both grids — the
    regime the native tile-pack kernel handles (conflux's own layouts;
    everything else runs the Python region walk)."""
    bc, cl = (src, dst) if isinstance(dst, CustomLayout) else (dst, src)
    v = bc.vr
    return (bc.vr == bc.vc == cl.vr == cl.vc
            and bc.M % (v * bc.Prows) == 0 and bc.N % (v * bc.Pcols) == 0)


def _native_bc_to_custom(shards, src, dst):
    """Native fast path: block-cyclic -> packed tiles (one OpenMP pass),
    then per-owner VIEWS of the packed buffer — owner-array-agnostic."""
    from conflux_tpu_torch import native

    if not isinstance(src, BlockCyclicLayout) or not _uniform_square_tiles(src, dst):
        return None
    dtype = np.dtype(_src_dtype(shards, src))
    # probe everything cheap BEFORE staging O(M*N) buffers: an unsupported
    # dtype must not double the walk's cost
    if (dtype not in (np.float32, np.float64)
            or src.M * src.N * dtype.itemsize > _NATIVE_TRANSFORM_MAX_BYTES):
        return None
    stacked = np.stack([np.stack([np.ascontiguousarray(shards[p][q])
                                  for q in range(src.Pcols)])
                        for p in range(src.Prows)])
    tiles = native.bc_to_tiles(stacked, src.vr, src.Prows, src.Pcols)
    if tiles is None:
        return None
    Mt, Nt = dst.tile_counts()
    out: dict = {}
    for ti in range(Mt):
        for tj in range(Nt):
            out.setdefault(dst.owner(ti, tj), {})[(ti, tj)] = (
                tiles[ti * Nt + tj])
    return out


def _native_custom_to_bc(store, src, dst):
    """Native fast path for the reverse direction: pack the tile stores
    into global order, then one OpenMP pass into the block-cyclic
    buffer."""
    from conflux_tpu_torch import native

    if not isinstance(src, CustomLayout) or not _uniform_square_tiles(src, dst):
        return None
    dtype = np.dtype(_src_dtype(store, src))
    if (dtype not in (np.float32, np.float64)
            or src.M * src.N * dtype.itemsize > _NATIVE_TRANSFORM_MAX_BYTES):
        return None
    Mt, Nt = src.tile_counts()
    v = src.vr
    tiles = np.empty((Mt * Nt, v, v), dtype)
    for ti in range(Mt):
        for tj in range(Nt):
            tiles[ti * Nt + tj] = store[src.owner(ti, tj)][(ti, tj)]
    out4 = native.tiles_to_bc(tiles, dst.M, dst.N, v, dst.Prows, dst.Pcols)
    if out4 is None:
        return None
    return [[out4[p, q] for q in range(dst.Pcols)]
            for p in range(dst.Prows)]


def _src_dtype(shards, src):
    if isinstance(src, CustomLayout):
        return next(iter(next(iter(shards.values())).values())).dtype
    return shards[0][0].dtype


def _build_local(shards, src, dst: BlockCyclicLayout, p: int,
                 q: int) -> np.ndarray:
    """One destination coordinate's local buffer, assembled from the source
    tiles intersecting each of its tiles. Short trailing tiles are safe on
    both sides: a block-cyclic owner's short tile is always its LAST local
    tile, so full-tile local offsets (li*vr, lj*vc) are exact."""
    Mt, Nt = dst.tile_counts()
    row_tiles = range(p, Mt, dst.Prows)
    col_tiles = range(q, Nt, dst.Pcols)
    dtype = _src_dtype(shards, src)
    if not len(row_tiles) or not len(col_tiles):
        # same one-sided numroc extents as scatter's empty shards
        return np.zeros(dst.local_shape(p, q), dtype)
    loc = np.zeros(dst.local_shape(p, q), dtype)
    for li, ti in enumerate(row_tiles):
        r0, r1 = ti * dst.vr, min((ti + 1) * dst.vr, dst.M)
        for lj, tj in enumerate(col_tiles):
            c0, c1 = tj * dst.vc, min((tj + 1) * dst.vc, dst.N)
            _copy_region(shards, src, r0, r1, c0, c1,
                         loc, li * dst.vr, lj * dst.vc)
    return loc
