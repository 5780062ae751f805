"""Matrix files: the headered binary format of the JAX package's `io.py`.

The port's own copy of the codec half of `conflux_tpu/io.py`
(`_write_header`, `_read_header`, `save_matrix`, `load_matrix`,
`load_matrix_auto`): an int64 header (M, N, dtype code) and the row-major
data, byte for byte what the JAX copy writes, so each copy reads the
other's files. The tier layer's spill and checkpoint records
(`tier.py`) store every leaf through it. The scatter half
(`load_and_scatter`, `load_scattered`, `save_scattered`: the reference's
`CholeskyIO.cpp:185-501` file parse, tile scatter and dumps) and the
deterministic SPD generators (`generate_spd_local`, `_shards`, `_tiles`,
`_file`: `CholeskyIO.cpp:100-172`) give the JAX package's shards and
files bit for bit: the file scatter and gather stream through the port's
native mmap tile copies (`conflux_tpu_torch.native`, float32 and float64),
other dtypes through an `np.memmap` one tile strip at a time.
"""

from __future__ import annotations

import math
import os

import numpy as np

# Binary file format: int64 header (M, N, dtype code) + row-major data.
# int32 is a first-class code so integer state (row maps, permutations
# viewed as words) round-trips exactly at any scale.
_HEADER_BYTES = 3 * 8
_DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.int32)]


def _write_header(f, M: int, N: int, dtype) -> None:
    dtype = np.dtype(dtype)
    if dtype not in _DTYPES:
        names = ", ".join(d.name for d in _DTYPES)
        raise ValueError(
            f"matrix files store {names} only, got {dtype.name}; "
            "cast narrow storage dtypes (e.g. bfloat16) to float32 first")
    np.array([M, N, _DTYPES.index(dtype)], dtype=np.int64).tofile(f)


def _read_header(path: str) -> tuple[int, int, np.dtype]:
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int64, count=3)
    if header.size != 3:
        raise ValueError(f"{path!r} is too short to hold a matrix header")
    M, N, code = (int(x) for x in header)
    size = os.path.getsize(path)
    if (M < 0 or N < 0 or not 0 <= code < len(_DTYPES)
            or size != _HEADER_BYTES + M * N * _DTYPES[code].itemsize):
        # a raw headerless dump (dim*dim doubles) misparses its first
        # doubles as header fields; the size check catches the rare bit
        # patterns that would otherwise look valid
        raise ValueError(
            f"{path!r} is not a conflux_tpu matrix file (header reads "
            f"M={M}, N={N}, dtype code={code}, file size {size}); raw "
            "headerless dumps (e.g. the reference cholesky_helper format) "
            "must be converted by prepending the int64 (M, N, dtype) header")
    return M, N, _DTYPES[code]


def save_matrix(path: str, A) -> None:
    """Row-major binary dump of a 2-D array (numpy, or a CPU tensor of a
    storable dtype)."""
    A = np.ascontiguousarray(A)
    with open(path, "wb") as f:
        _write_header(f, A.shape[0], A.shape[1], A.dtype)
        A.tofile(f)


def load_matrix(path: str) -> np.ndarray:
    M, N, dtype = _read_header(path)
    with open(path, "rb") as f:
        f.seek(_HEADER_BYTES)
        return np.fromfile(f, dtype=dtype).reshape(M, N)


def load_matrix_auto(path: str) -> np.ndarray:
    """Load a matrix from either format: the headered file, or a raw
    headerless square dump of float64 (the reference cholesky_helper's)
    or float32, told apart by exact file size. A valid header demands size
    == 24 + M*N*itemsize and a raw square size == dim^2*itemsize; the
    loader falls back to the raw forms only when the header is
    rejected."""
    try:
        return load_matrix(path)
    except ValueError as header_err:
        size = os.path.getsize(path)
        for np_t in (np.float64, np.float32):
            n2, rem = divmod(size, np.dtype(np_t).itemsize)
            dim = math.isqrt(n2)
            if rem == 0 and dim * dim == n2 and dim > 0:
                return np.fromfile(path, dtype=np_t).reshape(dim, dim)
        raise ValueError(
            f"{path!r} is neither a conflux_tpu matrix file nor a raw "
            f"square float64/float32 dump ({size} bytes)") from header_err


# --------------------------------------------------------------------------- #
# Deterministic SPD inputs and the block-cyclic scatter half
# --------------------------------------------------------------------------- #


def _spd_base_tile(geom, seed: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tile = rng.uniform(-1.0, 1.0, size=(geom.v, geom.v)).astype(dtype)
    return (tile + tile.T) / 2


def generate_spd_local(geom, px: int, py: int, seed: int = 2020,
                       dtype=np.float64) -> np.ndarray:
    """ONE rank's (Ml, Nl) SPD shard, built tile-locally: every
    off-diagonal tile is the *same* seeded v x v symmetrized block (any rank
    materializes its tiles without communication) and the diagonal tiles
    get an N-scaled identity boost (the reference generator's scheme,
    `CholeskyIO.cpp:100-172`). Peak memory is this shard plus one tile."""
    N, v = geom.N, geom.v
    Px, Py = geom.grid.Px, geom.grid.Py
    sym = _spd_base_tile(geom, seed, dtype)
    boost = N * np.eye(v, dtype=dtype)
    loc = np.tile(sym, (geom.Mtl, geom.Ntl))
    for i in range(geom.Mtl):  # global-diagonal tiles owned here: i*Px+px == j*Py+py
        gt = i * Px + px
        j, rem = divmod(gt - py, Py)
        if rem == 0 and 0 <= j < geom.Ntl:
            loc[i * v:(i + 1) * v, j * v:(j + 1) * v] += boost
    return loc


def generate_spd_shards(geom, seed: int = 2020, dtype=np.float64) -> np.ndarray:
    """All shards (Px, Py, Ml, Nl) in `CholeskyGeometry.scatter`'s layout (a
    host convenience that holds N^2 elements; :func:`generate_spd_local`
    per rank stays tile-local)."""
    shards = np.empty((geom.grid.Px, geom.grid.Py, geom.Ml, geom.Nl), dtype)
    for px in range(geom.grid.Px):
        for py in range(geom.grid.Py):
            shards[px, py] = generate_spd_local(geom, px, py, seed, dtype)
    return shards


def generate_spd_tiles(geom, seed: int = 2020, dtype=np.float64) -> np.ndarray:
    """The full (N, N) SPD input of the same construction as
    :func:`generate_spd_local`."""
    N, v = geom.N, geom.v
    A = np.tile(_spd_base_tile(geom, seed, dtype), (N // v, N // v))
    A[np.arange(N), np.arange(N)] += N
    return A


def generate_spd_file(path: str, N: int, v: int = 256, seed: int = 7,
                      dtype=np.float64) -> None:
    """Stream a deterministic SPD matrix to disk one tile strip at a time
    (the reference's offline `cholesky_helper` generator for very large N):
    one seeded symmetric v x v tile replicated everywhere plus an N-scaled
    diagonal boost; the matrix never exists in memory."""
    if N % v:
        raise ValueError(f"N={N} must be a multiple of the tile size {v}")
    rng = np.random.default_rng(seed)
    tile = rng.uniform(-1.0, 1.0, size=(v, v)).astype(dtype)
    sym = ((tile + tile.T) / 2).astype(dtype)
    strip = np.tile(sym, (1, N // v))  # (v, N), identical for every tile row
    r = np.arange(v)
    with open(path, "wb") as f:
        _write_header(f, N, N, dtype)
        for ti in range(N // v):
            # boost this strip's diagonal in place, write, restore the v
            # entries (a strip copy would double peak memory)
            saved = strip[r, ti * v + r].copy()
            strip[r, ti * v + r] += N
            strip.tofile(f)
            strip[r, ti * v + r] = saved


def load_and_scatter(path: str, geom) -> np.ndarray:
    """File parse + tile scatter (role of `CholeskyIO.cpp:185-375`)."""
    return geom.scatter(load_matrix(path))


def load_scattered(path: str, geom) -> np.ndarray:
    """Stream a matrix file straight into (Px, Py, Ml, Nl) shards, one
    (v, N) tile strip resident at a time through an `np.memmap`: the
    global matrix is never materialized (the role of the reference's
    collective MPI-IO reads). The file's shape must be the geometry's
    padded (M, N)."""
    M, N, dtype = _read_header(path)
    gM = getattr(geom, "M", geom.N)
    gN = geom.N
    if (M, N) != (gM, gN):
        raise ValueError(f"file is {M}x{N}, geometry needs {gM}x{gN}")
    Px, Py, v = geom.grid.Px, geom.grid.Py, geom.v
    from conflux_tpu_torch import native

    fast = native.file_scatter(path, _HEADER_BYTES, gM, gN, v, Px, Py, dtype)
    if fast is not None:
        return fast
    A = np.memmap(path, dtype=dtype, mode="r", offset=_HEADER_BYTES, shape=(gM, gN))
    Ml, Nl, Ntl = gM // Px, gN // Py, gN // (v * Py)
    shards = np.empty((Px, Py, Ml, Nl), dtype=dtype)
    for ti in range(gM // v):
        px, lt = ti % Px, ti // Px
        strip = np.asarray(A[ti * v:(ti + 1) * v]).reshape(v, Ntl, Py, v)
        shards[px, :, lt * v:(lt + 1) * v] = strip.transpose(2, 0, 1, 3).reshape(Py, v, Nl)
    return shards


def save_scattered(path: str, shards, geom) -> None:
    """Inverse of :func:`load_scattered`: stream (Px, Py, Ml, Nl) shards to
    a matrix file one tile strip at a time (the role of the reference's
    MPI-IO dumps, `CholeskyIO.cpp:384-501`)."""
    shards = np.asarray(shards)
    gM = getattr(geom, "M", geom.N)
    gN = geom.N
    Px, Py, v = geom.grid.Px, geom.grid.Py, geom.v
    if shards.shape != (Px, Py, gM // Px, gN // Py):
        raise ValueError(f"shards shape {shards.shape} does not match geometry "
                         f"({Px}, {Py}, {gM // Px}, {gN // Py})")
    with open(path, "wb") as f:
        _write_header(f, gM, gN, shards.dtype)
    from conflux_tpu_torch import native

    if native.file_gather(path, shards, _HEADER_BYTES, v, Px, Py):
        return
    with open(path, "r+b") as f:  # grow to full size for the memmap
        f.truncate(_HEADER_BYTES + gM * gN * shards.dtype.itemsize)
    A = np.memmap(path, dtype=shards.dtype, mode="r+", offset=_HEADER_BYTES, shape=(gM, gN))
    Ntl = gN // (v * Py)
    for ti in range(gM // v):
        px, lt = ti % Px, ti // Px
        strip = shards[px, :, lt * v:(lt + 1) * v]  # (Py, v, Nl)
        A[ti * v:(ti + 1) * v] = strip.reshape(Py, v, Ntl, v).transpose(1, 2, 0, 3).reshape(v, gN)
    A.flush()
    del A
