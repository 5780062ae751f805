"""Build and load the port's CUDA kernels.

`ops/csrc/*.cu` are compiled at first use with nvcc, one process per source
started together, then linked into one shared library with a plain C
interface that `ctypes` loads. The library lands in `ops/_kernels/<hash>/`
(git-ignored), keyed by a hash of the sources and flags, so a checkout
builds everything on its first kernel call and reuses the build after.
There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_OUT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_kernels")
_LIB_NAME = "libconflux_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None  # guarded-by: _lock
build_seconds = None  # wall time of this process's build, None if reused
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from ops/csrc at first use and need it")
    return path


def _sources() -> list[str]:
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(out_dir: str, sources: list[str]) -> str:
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = f"{out_dir}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    cu = [s for s in sources if s.endswith(".cu")]
    objs = [os.path.join(tmp, os.path.basename(s)[:-3] + ".o") for s in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", s, "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    for src, p, log in zip(cu, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    lib = os.path.join(tmp, _LIB_NAME)
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", *objs, "-o", lib],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    # a concurrent build may have finished first; both builds are equal
    try:
        os.replace(tmp, out_dir)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    from conflux_tpu_torch import profiler

    profiler.note_build()
    return os.path.join(out_dir, _LIB_NAME)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.conflux_gemm.argtypes = [
        i, i,  # dtype code, device
        i, i, i,  # M, N, K
        p, i, p, i,  # a, lda, b, ldb
        p, i, p, i,  # c (may be NULL), ldc, out, ldo
        f, f, p]  # alpha, beta, stream
    lib.conflux_gemm.restype = i
    lib.conflux_gemm_tma.argtypes = lib.conflux_gemm.argtypes
    lib.conflux_gemm_tma.restype = i
    lib.conflux_lu_block.argtypes = [
        i, i, i, i,  # device, slots, m, w
        p, i, ctypes.c_longlong, p,  # a, lda, slot stride of a, alive_in
        p, p, p,  # out, alive_out, piv
        p, p,  # words, cand_rows (scratch)
        p]  # stream
    lib.conflux_lu_block.restype = i
    lib.conflux_lu_block_ctas.argtypes = [i]
    lib.conflux_lu_block_ctas.restype = i
    lib.conflux_lu_block_wave_slots.argtypes = [i, i]  # device, m
    lib.conflux_lu_block_wave_slots.restype = i
    lib.conflux_btrsm.argtypes = [
        i, i, i,  # dtype code, device, batch
        i, i, i, i,  # n, nb, bs, k
        i, i,  # mode (0 lower, 1 upper, 2 round), trans
        p, p, p, p, p, p,  # t, d1, d2 (may be NULL), b, perm (may be NULL), wa (may be NULL)
        p, p, p,  # x, xsum, wax (both NULL without wa)
        p]  # stream
    lib.conflux_btrsm.restype = i
    lib.conflux_batched_lu.argtypes = [
        i, i, i, i,  # dtype code, device, batch, n
        p, p, p,  # a, out, piv
        p, p,  # w, wa (both may be NULL)
        p]  # stream
    lib.conflux_batched_lu.restype = i
    lib.conflux_batched_chol.argtypes = [
        i, i, i, i,  # dtype code, device, batch, n
        p, p,  # a, out
        p, p,  # w, wa (both may be NULL)
        p]  # stream
    lib.conflux_batched_chol.restype = i
    for name in ("conflux_batched_lu_geometry", "conflux_batched_chol_geometry"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, i, i, p, p, p]  # dtype, device, batch, n; kb, cs, global_panel
        fn.restype = i


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if this checkout has
    no build for the current sources."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            out_dir = os.path.join(_OUT_ROOT, _digest(sources))
            path = os.path.join(out_dir, _LIB_NAME)
            if not os.path.exists(path):
                path = _compile(out_dir, sources)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib
