"""Problem geometry: 3D grids and the LU tile geometry.

The port's copy of the grid and LU-geometry half of
`conflux_tpu/geometry.py` (the reference's `lu_params.hpp:21-138`). Pure
host-side Python. Only the single-device route is ported, so the
block-cyclic scatter/gather helpers stay behind with the distributed
programs that use them.
"""

from __future__ import annotations

import dataclasses
import math


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
