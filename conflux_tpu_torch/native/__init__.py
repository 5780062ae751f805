"""The native host runtime: OpenMP C++ scatter/gather between a row-major
matrix and block-cyclic shards (the port's own copy of
`conflux_tpu/native/`, the reference's COSTA role on the host).

`layout_native.cpp` (in-memory scatter, gather and tile packing) and
`io_native.cpp` (the same tile copies through an mmap of a matrix file)
share `tile_copy.hpp`. They are built at first use with the host C++
compiler (`$CXX`, else g++ or c++: `-O3 -march=native -fopenmp -shared
-fPIC -std=c++17`) into `native/_build/<hash>/` (git-ignored), keyed by a
hash of the sources, the flags, the compiler and this machine's CPU, so a
build is reused only where it was made; the build lands in a temporary
directory first and moves into place with `os.replace`, so processes that
build at once do not corrupt each other. Loaded with ctypes. A missing
compiler or a failed build raises: nothing falls back quietly. A compiler
that cannot link an OpenMP program (no libgomp) builds the same sources
without `-fopenmp`: the tile copies then run on one thread, with the same
bits, and `nthreads()` says 1.

Each entry returns None (or False) for what the native code does not take,
a dtype other than float32/float64 or a shape off the tile grid, and the
caller runs its numpy path, which gives the same bits (the tests hold the
two to each other).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("layout_native.cpp", "io_native.cpp", "tile_copy.hpp")
_OUT_ROOT = os.path.join(_HERE, "_build")
_LIB_NAME = "libconflux_layout.so"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None  # guarded-by: _lock
build_seconds = None  # wall time of this process's build, None if reused


def _cxx() -> str:
    name = os.environ.get("CXX")
    cxx = shutil.which(name) if name else shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler found ({'CXX=' + name if name else 'g++, c++'}): "
                           "the native scatter/gather library is built from "
                           "conflux_tpu_torch/native at first use")
    return cxx


def _machine() -> str:
    """What -march=native depends on: the architecture and the CPU model."""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    model += line
    except OSError:
        pass
    return f"{platform.machine()}\n{platform.processor()}\n{model}"


def _digest(cxx: str) -> str:
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    h.update(version.encode())
    h.update(_machine().encode())
    for name in _SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _links_openmp(cxx: str, tmp: str) -> bool:
    """Whether the compiler builds and links an OpenMP program."""
    src = os.path.join(tmp, "omp_probe.cpp")
    with open(src, "w") as f:
        f.write("#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
    run = subprocess.run([cxx, "-fopenmp", src, "-o", os.path.join(tmp, "omp_probe")],
                         capture_output=True, text=True)
    for name in ("omp_probe.cpp", "omp_probe"):
        if os.path.exists(os.path.join(tmp, name)):
            os.remove(os.path.join(tmp, name))
    return run.returncode == 0


def _compile(cxx: str, out_dir: str) -> str:
    global build_seconds
    import time

    t0 = time.perf_counter()
    tmp = f"{out_dir}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    srcs = [os.path.join(_HERE, s) for s in _SOURCES if s.endswith(".cpp")]
    flags = [f for f in CXX_FLAGS if f != "-fopenmp" or _links_openmp(cxx, tmp)]
    cmd = [cxx, *flags, *srcs, "-o", os.path.join(tmp, _LIB_NAME)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n{run.stdout}{run.stderr}")
    # a concurrent build may have finished first; both builds are equal
    try:
        os.replace(tmp, out_dir)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return os.path.join(out_dir, _LIB_NAME)


def _declare(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    for prefix, restype, head in (
            ("conflux_scatter_", None, ()), ("conflux_gather_", None, ()),
            ("conflux_bc_to_tiles_", None, ()), ("conflux_tiles_to_bc_", None, ()),
            ("conflux_file_scatter_", ctypes.c_int, (ctypes.c_char_p,)),
            ("conflux_file_gather_", ctypes.c_int, (ctypes.c_char_p,))):
        for suffix, ct in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, prefix + suffix)
            fn.restype = restype
            ptr = ctypes.POINTER(ct)
            if head:  # path, shards, header, M, N, v, Px, Py
                fn.argtypes = [*head, ptr] + [i64] * 6
            else:  # src, dst, M, N, v, Px, Py
                fn.argtypes = [ptr, ptr] + [i64] * 5
    lib.conflux_native_nthreads.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The loaded library, building it first where this machine has no
    build of the current sources."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _cxx()
            out_dir = os.path.join(_OUT_ROOT, _digest(cxx))
            path = os.path.join(out_dir, _LIB_NAME)
            if not os.path.exists(path):
                path = _compile(cxx, out_dir)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


def nthreads() -> int:
    """OpenMP threads the tile copies run on (1 in a build without OpenMP)."""
    return load().conflux_native_nthreads()


def _fn(name: str, dtype):
    return getattr(load(), f"{name}_{'f32' if dtype == np.float32 else 'f64'}")


def _ptr(a: np.ndarray):
    ct = ctypes.c_float if a.dtype == np.float32 else ctypes.c_double
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _takes(dtype) -> bool:
    return np.dtype(dtype) in (np.float32, np.float64)


def _check_grid(shards: np.ndarray, Px: int, Py: int) -> None:
    if shards.ndim != 4 or shards.shape[:2] != (Px, Py):
        raise ValueError(f"shards shape {shards.shape} does not match grid "
                         f"({Px}, {Py}, Ml, Nl)")


def scatter(A: np.ndarray, v: int, Px: int, Py: int) -> np.ndarray | None:
    """(M, N) row-major -> (Px, Py, Ml, Nl) shards; None if not applicable."""
    if not _takes(A.dtype):
        return None
    M, N = A.shape
    if M % (v * Px) or N % (v * Py):
        return None
    A = np.ascontiguousarray(A)
    out = np.empty((Px, Py, M // Px, N // Py), dtype=A.dtype)
    _fn("conflux_scatter", A.dtype)(_ptr(A), _ptr(out), M, N, v, Px, Py)
    return out


def gather(shards: np.ndarray, v: int, Px: int, Py: int) -> np.ndarray | None:
    """(Px, Py, Ml, Nl) shards -> (M, N) row-major; None if not applicable."""
    if not _takes(shards.dtype):
        return None
    _check_grid(shards, Px, Py)
    _, _, Ml, Nl = shards.shape
    if Ml % v or Nl % v:
        return None
    M, N = Ml * Px, Nl * Py
    shards = np.ascontiguousarray(shards)
    out = np.empty((M, N), dtype=shards.dtype)
    _fn("conflux_gather", shards.dtype)(_ptr(shards), _ptr(out), M, N, v, Px, Py)
    return out


def file_scatter(path: str, header: int, M: int, N: int, v: int, Px: int, Py: int,
                 dtype) -> np.ndarray | None:
    """Stream a row-major matrix file (after `header` bytes) straight into
    (Px, Py, Ml, Nl) shards through an mmap: the global matrix is never
    materialized. None if not applicable."""
    dtype = np.dtype(dtype)
    if not _takes(dtype) or M % (v * Px) or N % (v * Py):
        return None
    out = np.empty((Px, Py, M // Px, N // Py), dtype=dtype)
    rc = _fn("conflux_file_scatter", dtype)(path.encode(), _ptr(out), header, M, N, v, Px, Py)
    if rc != 0:
        raise OSError(f"native file_scatter({path!r}) failed with code {rc}")
    return out


def file_gather(path: str, shards: np.ndarray, header: int, v: int, Px: int,
                Py: int) -> bool:
    """Stream shards into a row-major matrix file after `header` bytes (the
    file exists with its header written; it is grown to full size).
    False if not applicable."""
    if not _takes(shards.dtype):
        return False
    _check_grid(shards, Px, Py)
    _, _, Ml, Nl = shards.shape
    if Ml % v or Nl % v:
        return False
    shards = np.ascontiguousarray(shards)
    rc = _fn("conflux_file_gather", shards.dtype)(path.encode(), _ptr(shards), header,
                                                  Ml * Px, Nl * Py, v, Px, Py)
    if rc != 0:
        raise OSError(f"native file_gather({path!r}) failed with code {rc}")
    return True


def bc_to_tiles(shards: np.ndarray, v: int, Px: int, Py: int) -> np.ndarray | None:
    """(Px, Py, Ml, Nl) block-cyclic shards -> (Mt*Nt, v, v) tiles packed in
    global (ti, tj) row-major order (owner-agnostic: the custom-layout
    transform takes per-owner views of the result). None if not
    applicable."""
    if not _takes(shards.dtype):
        return None
    _check_grid(shards, Px, Py)
    _, _, Ml, Nl = shards.shape
    if Ml % v or Nl % v:
        return None
    M, N = Ml * Px, Nl * Py
    shards = np.ascontiguousarray(shards)
    out = np.empty(((M // v) * (N // v), v, v), dtype=shards.dtype)
    _fn("conflux_bc_to_tiles", shards.dtype)(_ptr(shards), _ptr(out), M, N, v, Px, Py)
    return out


def tiles_to_bc(tiles: np.ndarray, M: int, N: int, v: int, Px: int,
                Py: int) -> np.ndarray | None:
    """Inverse of :func:`bc_to_tiles`. None if not applicable."""
    if not _takes(tiles.dtype) or M % (v * Px) or N % (v * Py):
        return None
    if tiles.shape != ((M // v) * (N // v), v, v):
        raise ValueError(f"tiles shape {tiles.shape} does not match {M}x{N} at tile {v}")
    tiles = np.ascontiguousarray(tiles)
    out = np.empty((Px, Py, M // Px, N // Py), dtype=tiles.dtype)
    _fn("conflux_tiles_to_bc", tiles.dtype)(_ptr(tiles), _ptr(out), M, N, v, Px, Py)
    return out
