"""The port's native host runtime (`conflux_tpu_torch.native`: its copies of
the OpenMP C++ scatter/gather, the mmap file streaming and the tile
packing) against its numpy path, the plain version it is held to: the
same bits for float32 and float64 (tolerance 0: both only copy), the
numpy path for what the native code does not take, and the port's shards
equal to the JAX package's `geometry.scatter`. The library builds at
first use with the host compiler (twins of tests/test_native.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conflux_tpu.geometry import Grid3 as JGrid3
from conflux_tpu.geometry import LUGeometry as JLUGeometry
from conflux_tpu_torch import io as tio
from conflux_tpu_torch import native
from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_only(monkeypatch):
    """Send every native entry to its numpy path."""
    for name in ("scatter", "gather", "file_scatter", "bc_to_tiles", "tiles_to_bc"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)
    monkeypatch.setattr(native, "file_gather", lambda *a, **k: False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 2)], ids=str)
def test_native_is_bitwise_the_numpy_path(grid, dtype, monkeypatch, tmp_path):
    """In memory (LUGeometry.scatter/gather) and through a file
    (io.load_scattered/save_scattered), on a ragged size the scatter pads;
    the shards also equal the JAX package's."""
    Px, Py = grid
    v = 8
    geom = LUGeometry.create(v * Px * 3 - 5, v * Py * 2 + 3, v, Grid3(Px, Py, 1))
    A = np.random.default_rng(Px * 10 + Py).standard_normal(
        (geom.Mbase, geom.Nbase)).astype(dtype)
    fast = geom.scatter(A)
    back = geom.gather(fast)
    path, out = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    tio.save_matrix(path, back)
    fshards = tio.load_scattered(path, geom)
    tio.save_scattered(out, fshards, geom)
    fback = tio.load_matrix(out)
    assert native.scatter(back, v, Px, Py) is not None  # the native path ran
    jgeom = JLUGeometry.create(geom.Mbase, geom.Nbase, v, JGrid3(Px, Py, 1))
    np.testing.assert_array_equal(fast, jgeom.scatter(A))

    _numpy_only(monkeypatch)
    slow = geom.scatter(A)
    for got, want in ((fast, slow), (back, geom.gather(slow)),
                      (fshards, tio.load_scattered(path, geom))):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    tio.save_scattered(str(tmp_path / "c.bin"), slow, geom)
    with open(out, "rb") as f1, open(str(tmp_path / "c.bin"), "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(fback[:geom.Mbase, :geom.Nbase], A)


def test_what_the_native_code_does_not_take_runs_the_numpy_path():
    assert native.scatter(np.zeros((8, 8), np.int32), 4, 1, 1) is None  # dtype
    assert native.scatter(np.zeros((10, 8)), 4, 1, 1) is None  # extent off the grid
    assert native.gather(np.zeros((1, 1, 6, 8)), 4, 1, 1) is None
    assert native.file_scatter("x", 24, 8, 8, 4, 1, 1, np.int32) is None
    with pytest.raises(ValueError, match="grid"):
        native.gather(np.zeros((2, 1, 8, 8)), 4, 1, 1)
    # int32 and bfloat16-free storage keep working through numpy
    geom = LUGeometry.create(16, 16, 4, Grid3(2, 2, 1))
    A = np.arange(256, dtype=np.int32).reshape(16, 16)
    np.testing.assert_array_equal(geom.gather(geom.scatter(A)), A)
    cg = CholeskyGeometry.create(16, 4, Grid3(2, 2, 1))
    np.testing.assert_array_equal(cg.gather(cg.scatter(A.astype(np.float32))), A)


def test_tile_packing_is_bitwise_the_layout_walk(monkeypatch):
    """bc_to_tiles / tiles_to_bc against the packed tiles of the numpy
    scatter, and transform()'s native paths against its region walk."""
    from conflux_tpu_torch import layout

    rng = np.random.default_rng(21)
    M, N, v = 64, 48, 8
    bc = layout.BlockCyclicLayout(M=M, N=N, vr=v, vc=v, Prows=2, Pcols=2)
    Mt, Nt = bc.tile_counts()
    owners = np.stack([rng.integers(0, 3, (Mt, Nt)), rng.integers(0, 2, (Mt, Nt))], axis=-1)
    cl = layout.CustomLayout.from_owner_map(M, N, v, v, owners)
    A = rng.standard_normal((M, N)).astype(np.float32)
    shards = layout.scatter(A, bc)
    stacked = np.stack([np.stack(row) for row in shards])
    tiles = native.bc_to_tiles(stacked, v, 2, 2)
    np.testing.assert_array_equal(
        tiles, A.reshape(Mt, v, Nt, v).transpose(0, 2, 1, 3).reshape(Mt * Nt, v, v))
    np.testing.assert_array_equal(native.tiles_to_bc(tiles, M, N, v, 2, 2), stacked)
    store = layout._native_bc_to_custom(shards, bc, cl)
    back = layout._native_custom_to_bc(store, cl, bc)
    assert store is not None and back is not None
    _numpy_only(monkeypatch)
    walk = layout.transform(shards, bc, cl)
    for o in walk:
        for t in walk[o]:
            np.testing.assert_array_equal(store[o][t], walk[o][t])
    for got, want in zip(back, layout.transform(walk, cl, bc)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


_BUILD = """
import sys
sys.path.insert(0, {root!r})
from conflux_tpu_torch import native
native._OUT_ROOT = {out!r}
import numpy as np
A = np.arange(64.0).reshape(8, 8)
assert (native.gather(native.scatter(A, 2, 2, 2), 2, 2, 2) == A).all()
print("built" if native.build_seconds is not None else "reused")
"""


def test_concurrent_builds_are_atomic_and_failures_raise(tmp_path, monkeypatch):
    """Four processes building into one empty directory at once all load a
    whole library (each builds into its own temporary directory and moves
    it into place); a missing compiler and a failed build raise."""
    out = str(tmp_path / "build")
    code = _BUILD.format(root=ROOT, out=out)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    built = os.listdir(out)
    assert len(built) == 1 and not built[0].count(".tmp"), built
    rerun = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert rerun.stdout.strip() == "reused", rerun.stdout + rerun.stderr

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_OUT_ROOT", str(tmp_path / "other"))
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load()
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(native, "CXX_FLAGS", [*native.CXX_FLAGS, "-no-such-flag"])
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load()
    assert not os.path.exists(str(tmp_path / "other")) or not any(
        n.count(".tmp") for n in os.listdir(str(tmp_path / "other")))


def test_a_compiler_without_openmp_builds_the_serial_copies(tmp_path, monkeypatch):
    """Where the compiler cannot link OpenMP (no libgomp), the same sources
    build without -fopenmp: one thread, the same bits."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_OUT_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "_links_openmp", lambda cxx, tmp: False)
    assert native.nthreads() == 1
    geom = LUGeometry.create(48, 32, 8, Grid3(3, 2, 1))
    A = np.random.default_rng(5).standard_normal((48, 32)).astype(np.float32)
    np.testing.assert_array_equal(native.scatter(A, 8, 3, 2), geom.scatter_blocks(A))
    np.testing.assert_array_equal(native.gather(native.scatter(A, 8, 3, 2), 8, 3, 2), A)
