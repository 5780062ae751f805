"""Problem geometry: 3D grids, the LU tile geometry and the Cholesky tile
geometry.

The port's copy of the grid, LU-geometry and Cholesky-geometry parts of
`conflux_tpu/geometry.py` (the reference's `lu_params.hpp:21-138` and
`CholeskyProperties`) and its block-cyclic tile maps. Pure host-side
Python: no communication happens here. The chosen (Px, Py, Pz) is the
process grid of `parallel.mesh.Mesh`, axes ('x', 'y', 'z').

Tile distribution is 2D block-cyclic over the (x, y) plane: tile (i, j) of
the global tile grid lives on grid coordinate (i mod Px, j mod Py) at local
tile slot (i // Px, j // Py). The z axis does not own distinct tiles: it
carries 2.5D replicated partial sums of the trailing matrix. Scatter and
gather run the port's native tile copies (`conflux_tpu_torch.native`,
float32 and float64 on the tile grid) and the JAX package's numpy path
otherwise; both give the JAX package's shards bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid3:
    """A 3D processor/device grid (Px, Py, Pz)."""

    Px: int
    Py: int
    Pz: int

    @property
    def P(self) -> int:
        return self.Px * self.Py * self.Pz

    def __post_init__(self):
        if self.Px < 1 or self.Py < 1 or self.Pz < 1:
            raise ValueError(f"grid dims must be >= 1, got {self}")

    def __str__(self) -> str:
        return f"{self.Px}x{self.Py}x{self.Pz}"

    @classmethod
    def parse(cls, s: str) -> "Grid3":
        """Parse 'Px,Py,Pz' or 'PxxPyxPz' CLI syntax."""
        sep = "," if "," in s else "x"
        parts = [int(t) for t in s.split(sep)]
        if len(parts) != 3:
            raise ValueError(f"expected 3 grid dims, got {s!r}")
        return cls(*parts)


def _best_grid(P: int, target_ratio: float) -> Grid3:
    """Exhaustive search over factor triples of P with Px >= Py >= Pz,
    minimizing |log((Px/Py) / target_ratio)| + 0.35 * ln(Pz): match the
    matrix aspect ratio in the 2D plane, with a mild penalty on
    replication depth."""
    if P < 1:
        raise ValueError("P must be >= 1")
    best = None
    best_key = None
    for Pz in range(1, P + 1):
        if P % Pz:
            continue
        Q = P // Pz
        for Py in range(1, Q + 1):
            if Q % Py:
                continue
            Px = Q // Py
            if not (Px >= Py >= Pz):
                continue
            score = abs(math.log((Px / Py) / target_ratio)) + 0.35 * math.log(Pz)
            key = (score, Pz, Px)
            if best_key is None or key < best_key:
                best_key, best = key, Grid3(Px, Py, Pz)
    assert best is not None  # (P, 1, 1) always qualifies
    return best


def choose_grid(P: int, M: int, N: int) -> Grid3:
    """Pick (Px, Py, Pz) for an LU factorization of an M x N matrix on P
    devices (role of the reference auto-pick, `lu_params.hpp:21-47`)."""
    ratio = max(M, N) / max(1, min(M, N))
    return _best_grid(P, ratio)


def choose_cholesky_grid(P: int) -> Grid3:
    """Pick (Px, Py, Pz) for Cholesky on P devices (role of the reference
    driver's grid pick, `Cholesky.cpp:76-114`, generalized to any P)."""
    return _best_grid(P, 1.0)


# --------------------------------------------------------------------------- #
# Block-cyclic index math
# --------------------------------------------------------------------------- #


def tile_owner(t: int, Pdim: int) -> int:
    """Grid coordinate along one axis owning global tile index t."""
    return t % Pdim


def tile_local(t: int, Pdim: int) -> int:
    """Local tile slot of global tile t on its owner."""
    return t // Pdim


def tile_global(p: int, lt: int, Pdim: int) -> int:
    """Global tile index of local slot lt on grid coordinate p."""
    return lt * Pdim + p


def row_owner(r: int, v: int, Pdim: int) -> int:
    """Grid x-coordinate owning global row r (tile size v)."""
    return (r // v) % Pdim


def row_local(r: int, v: int, Pdim: int) -> int:
    """Local row index of global row r on its owner."""
    return (r // v) // Pdim * v + r % v


def row_global(p: int, lr: int, v: int, Pdim: int) -> int:
    """Global row index of local row lr on grid coordinate p."""
    return (lr // v * Pdim + p) * v + lr % v


def local_row_indices(p: int, Ml: int, v: int, Pdim: int) -> np.ndarray:
    """Global row indices (length Ml) owned by x-coordinate p, in local order."""
    lr = np.arange(Ml)
    return (lr // v * Pdim + p) * v + lr % v


def first_local_tile(t: int, p: int, Pdim: int) -> int:
    """Local tile slots on coordinate p whose global tile index is below t:
    the local tiles of p are a prefix below t and a suffix from it on."""
    return max(0, -(-(t - p) // Pdim))


def ragged_segments(n_tiles: int, v: int, max_seg: int) -> list[tuple[int, int]]:
    """Ceil-divide n_tiles tiles of width v into at most max_seg contiguous
    (start, stop) element ranges, the last one ragged. The distributed
    trailing updates cut their live block at these bounds."""
    n = min(max_seg, n_tiles)
    per = -(-n_tiles // n)
    return [(g * per * v, min((g + 1) * per, n_tiles) * v)
            for g in range(n) if g * per < n_tiles]


def check_shards(shards, geom, what: str = "shards") -> None:
    """Reject mis-shaped shards with a geometry-aware message: the full
    (Px, Py, Ml, Nl) array, or one rank's (Ml, Nl) shard."""
    shape = tuple(shards.shape) if hasattr(shards, "shape") else None
    Ml, Nl = geom.Ml, geom.Nl
    full = (geom.grid.Px, geom.grid.Py, Ml, Nl)
    if shape not in (full, (Ml, Nl)):
        raise ValueError(
            f"{what} shape {shape} does not match the geometry's "
            f"block-cyclic layout {full} or one rank's shard {(Ml, Nl)} "
            f"(grid {geom.grid}, local {Ml}x{Nl}); build shards with "
            "geom.scatter or distribute_shards")


@dataclasses.dataclass(frozen=True)
class LUGeometry:
    """All derived sizes for an LU problem (the reference's `lu_params`
    container, `lu_params.hpp:49-138`, minus communicators and storage)."""

    M: int  # padded global rows
    N: int  # padded global cols
    Mbase: int  # requested rows before padding
    Nbase: int  # requested cols before padding
    v: int  # tile size
    grid: Grid3

    @classmethod
    def create(cls, M: int, N: int, v: int, grid: Grid3) -> "LUGeometry":
        """Pad M, N up to multiples of v*Px / v*Py (reference `lu_params.hpp:67-71`)."""
        if v < 1:
            raise ValueError("tile size v must be >= 1")
        Mp = v * grid.Px * math.ceil(M / (v * grid.Px))
        Np = v * grid.Py * math.ceil(N / (v * grid.Py))
        return cls(M=Mp, N=Np, Mbase=M, Nbase=N, v=v, grid=grid)

    @property
    def Mt(self) -> int:
        return self.M // self.v

    @property
    def Nt(self) -> int:
        return self.N // self.v

    @property
    def Mtl(self) -> int:
        return self.Mt // self.grid.Px

    @property
    def Ntl(self) -> int:
        return self.Nt // self.grid.Py

    @property
    def Ml(self) -> int:
        return self.Mtl * self.v

    @property
    def Nl(self) -> int:
        return self.Ntl * self.v

    @property
    def nlayr(self) -> int:
        """Columns of each z-layer's slab of a v-wide panel (2.5D split)."""
        return -(-self.v // self.grid.Pz)

    @property
    def n_steps(self) -> int:
        """Number of supersteps = number of v-wide panels to factor."""
        return min(self.Mt, self.Nt)

    # ---------------- host-side scatter/gather ---------------- #

    def scatter(self, A: np.ndarray) -> np.ndarray:
        """Distribute a global (M, N) matrix into per-rank block-cyclic
        shards (Px, Py, Ml, Nl): shard [pi, pj] holds the tiles {(i, j) :
        i mod Px == pi, j mod Py == pj} in local tile order. A smaller A is
        padded, with ones on the padding diagonal (keeps the padded LU
        well-posed). The z axis is not represented: layer 0 owns the data,
        the other layers start at zero."""
        M, N = self.M, self.N
        if A.shape != (M, N):
            padded = np.zeros((M, N), dtype=A.dtype)
            padded[: A.shape[0], : A.shape[1]] = A
            for d in range(min(A.shape[0], A.shape[1]), min(M, N)):
                padded[d, d] = 1.0
            A = padded
        from conflux_tpu_torch import native

        fast = native.scatter(A, self.v, self.grid.Px, self.grid.Py)
        if fast is not None:
            return fast
        shards = self.scatter_blocks(A)
        # a 1 x 1 grid's blocks are A itself: the shards never alias the input
        return shards.copy() if np.shares_memory(shards, A) else np.ascontiguousarray(shards)

    def scatter_blocks(self, A):
        """Pure reshape/transpose core of :meth:`scatter` (tile index
        i = lt*Px + px): works on numpy arrays and torch tensors alike; A
        must already be (M, N)."""
        Px, Py, v = self.grid.Px, self.grid.Py, self.v
        # (M, N) -> (Mtl, Px, v, Ntl, Py, v) -> (Px, Py, Ml, Nl)
        T = A.reshape(self.Mtl, Px, v, self.Ntl, Py, v)
        return T.transpose(1, 4, 0, 2, 3, 5).reshape(Px, Py, self.Ml, self.Nl) \
            if isinstance(A, np.ndarray) else \
            T.permute(1, 4, 0, 2, 3, 5).reshape(Px, Py, self.Ml, self.Nl)

    def local_block(self, A, px: int, py: int):
        """Rank (px, py)'s (Ml, Nl) shard of an (M, N) matrix (numpy or
        torch): :meth:`scatter_blocks` of one coordinate, without
        materializing the others."""
        Px, Py, v = self.grid.Px, self.grid.Py, self.v
        T = A.reshape(self.Mtl, Px, v, self.Ntl, Py, v)[:, px, :, :, py, :]
        return T.reshape(self.Ml, self.Nl)

    def gather(self, shards: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`scatter`: (Px, Py, Ml, Nl) -> (M, N)."""
        from conflux_tpu_torch import native

        Px, Py, v = self.grid.Px, self.grid.Py, self.v
        shards = np.asarray(shards)
        fast = native.gather(shards, v, Px, Py)
        if fast is not None:
            return fast
        T = shards.reshape(Px, Py, self.Mtl, v, self.Ntl, v)
        T = np.transpose(T, (2, 0, 3, 4, 1, 5))  # (Mtl, Px, v, Ntl, Py, v)
        return np.ascontiguousarray(T.reshape(self.M, self.N))

    def global_row_index(self) -> np.ndarray:
        """(Px, Ml): global row index of each local row per x-coordinate
        (the reference's `gri` tracking, `conflux_opt.hpp:427-440`)."""
        return np.stack([local_row_indices(p, self.Ml, self.v, self.grid.Px)
                         for p in range(self.grid.Px)])


# --------------------------------------------------------------------------- #
# Cholesky geometry
# --------------------------------------------------------------------------- #

def choose_cholesky_tile(N: int, P: int, *, itemsize: int = 4,
                         hbm_bytes: int = 16 << 30) -> int:
    """Tile-size heuristic for Cholesky (the JAX package's, value for
    value, so both packages pick the same v; its defaults are 4-byte
    elements and a TPU's 16 GiB of memory).

    The reference derives v from a memory ratio: it grows the tile until
    the per-rank tile buffers reach a target fraction of the rank's memory
    (`Cholesky.cpp:116-134`). v is grown from 128 while (a) the panel slab
    (Ml x v) stays under ~1/8 of the local matrix share (~N^2/P elements
    of `itemsize` bytes, at most `hbm_bytes`), and (b) at least two tile
    columns per device axis remain; it is capped at 1024.
    """
    if N <= 0:
        return max(1, N)
    px = max(1, math.isqrt(P))
    local_share = min(max(1, N * N // max(1, P)) * itemsize, hbm_bytes)
    v = 128
    while v * 2 <= 1024:
        nv = v * 2
        ml = -(-N // (nv * px)) * nv  # local panel height at tile nv
        if N // (nv * px) < 2:  # (b) keep >= 2 tile cols per device
            break
        if ml * nv * itemsize * 8 > local_share:  # (a) slab <= 1/8 share
            break
        v = nv
    return min(v, max(1, N))


@dataclasses.dataclass(frozen=True)
class CholeskyGeometry:
    """Derived sizes for Cholesky (the reference's `CholeskyProperties`)."""

    N: int  # padded global dimension
    Nbase: int  # requested dimension before padding
    v: int  # tile size
    grid: Grid3

    @classmethod
    def create(cls, N: int, v: int, grid: Grid3) -> "CholeskyGeometry":
        """Pad N up to a multiple of lcm(v Px, v Py)."""
        lcm = v * grid.Px * grid.Py // math.gcd(grid.Px, grid.Py)
        Np = lcm * math.ceil(N / lcm)
        return cls(N=Np, Nbase=N, v=v, grid=grid)

    @property
    def Kappa(self) -> int:
        """Number of tile columns = supersteps (reference calls this Kappa)."""
        return self.N // self.v

    @property
    def Mtl(self) -> int:
        return self.Kappa // self.grid.Px

    @property
    def Ntl(self) -> int:
        return self.Kappa // self.grid.Py

    @property
    def Ml(self) -> int:
        return self.Mtl * self.v

    @property
    def Nl(self) -> int:
        return self.Ntl * self.v

    @property
    def nlayr(self) -> int:
        return -(-self.v // self.grid.Pz)

    def lu_geometry(self) -> LUGeometry:
        """The square LU geometry with the same block-cyclic layout."""
        return LUGeometry.create(self.N, self.N, self.v, self.grid)

    def scatter(self, A: np.ndarray) -> np.ndarray:
        return self.lu_geometry().scatter(A)

    def local_block(self, A, px: int, py: int):
        return self.lu_geometry().local_block(A, px, py)

    def gather(self, shards: np.ndarray) -> np.ndarray:
        return self.lu_geometry().gather(shards)
