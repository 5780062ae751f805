"""The port's copy of the matrix file codec (`conflux_tpu_torch.io`) against
the JAX package's (`conflux_tpu.io`) on the CPU: the same arrays written by
both copies give equal bytes, each copy reads the other's files, and both
refuse the same malformed files."""

import numpy as np
import pytest
import torch

from conflux_tpu import io as jio
from conflux_tpu_torch import io as tio


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((5, 7)).astype(np.float32),
        "f64": rng.standard_normal((3, 4)),
        "i32": rng.integers(-(2 ** 31), 2 ** 31 - 1, size=(2, 9)).astype(np.int32),
        "row": rng.standard_normal((1, 33)).astype(np.float32),
        "empty": np.zeros((0, 3), np.float64),
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_both_copies_write_equal_bytes_and_read_each_other(tmp_path, name):
    A = _arrays()[name]
    pt, pj = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tio.save_matrix(pt, A)
    jio.save_matrix(pj, A)
    with open(pt, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    for load in (tio.load_matrix, tio.load_matrix_auto):
        B = load(pj)
        assert B.dtype == A.dtype and B.shape == A.shape
        np.testing.assert_array_equal(B, A)
    np.testing.assert_array_equal(jio.load_matrix(pt), A)
    assert tio._read_header(pt) == jio._read_header(pt)


def test_a_cpu_tensor_saves_as_its_numpy_array(tmp_path):
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tio.save_matrix(str(tmp_path / "t.bin"), t)
    jio.save_matrix(str(tmp_path / "j.bin"), t.numpy())
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_raw_square_dumps_load_auto_in_both_copies(tmp_path):
    rng = np.random.default_rng(1)
    for dt in (np.float64, np.float32):
        A = rng.standard_normal((6, 6)).astype(dt)
        p = str(tmp_path / f"raw_{np.dtype(dt).name}.bin")
        A.tofile(p)
        B = tio.load_matrix_auto(p)
        np.testing.assert_array_equal(B, jio.load_matrix_auto(p))
        np.testing.assert_array_equal(B, A)


def test_both_copies_refuse_the_same_files(tmp_path):
    short = tmp_path / "short.bin"
    short.write_bytes(b"\x00" * 8)
    bad = tmp_path / "bad.bin"
    np.array([2, 2, 7], np.int64).tofile(str(bad))  # unknown dtype code
    odd = tmp_path / "odd.bin"
    odd.write_bytes(b"\x01" * 13)
    for p in (short, bad):
        for mod in (tio, jio):
            with pytest.raises(ValueError):
                mod.load_matrix(str(p))
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="neither"):
            mod.load_matrix_auto(str(odd))
        with pytest.raises(ValueError, match="bfloat16"):
            mod.save_matrix(str(tmp_path / "x.bin"), np.zeros((2, 2), np.float16))
