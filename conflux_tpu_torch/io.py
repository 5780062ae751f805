"""Matrix files: the headered binary format of the JAX package's `io.py`.

The port's own copy of the codec half of `conflux_tpu/io.py`
(`_write_header`, `_read_header`, `save_matrix`, `load_matrix`,
`load_matrix_auto`): an int64 header (M, N, dtype code) and the row-major
data, byte for byte what the JAX copy writes, so each copy reads the
other's files. The tier layer's spill and checkpoint records
(`tier.py`) store every leaf through it. The scatter halves
(`load_and_scatter`, `load_scattered`, `save_scattered`) and the
`generate_spd_*` shard helpers wait for the port of `layout.py` (ROADMAP,
Slice 7).
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
