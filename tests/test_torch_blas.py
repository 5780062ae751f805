"""Parity of the port's panel family and permutation ops
(`conflux_tpu_torch.ops.blas`, `.permute`) with the JAX package's, on the
CPU: the JAX side runs its Pallas kernels in interpret mode, the port its
kernels' plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import blas as jblas
from conflux_tpu.ops import permute as jpermute
from conflux_tpu.validation import make_test_matrix
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import permute as tpermute


def _assert_panel_equal(jax_out, torch_out):
    lu_j, perm_j = (np.asarray(x) for x in jax_out)
    lu_t, perm_t = torch_out
    np.testing.assert_array_equal(perm_t.numpy(), perm_j)
    # the inter-block matmuls sum in another order than XLA's: entries of
    # the U rows reach ~20, so the bound is relative as well as absolute
    np.testing.assert_allclose(lu_t.numpy(), lu_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(160, 128), (384, 256)])
def test_panel_lu_pallas_matches(shape):
    panel = make_test_matrix(*shape, seed=11).astype(np.float32)
    _assert_panel_equal(jblas.panel_lu_pallas(jnp.asarray(panel)),
                        tblas.panel_lu_pallas(torch.from_numpy(panel)))


@pytest.fixture
def shrunk_kernel_rows():
    # Taller than the kernel's ceiling: panel_lu chunks through the
    # tournament. 256 (not the JAX test's 64) keeps the chunks and the
    # (2v, v) tree rounds on the kernel in both packages; at 64 the JAX
    # package factors them with the library LU, which the port defers.
    old = (jblas._PALLAS_MAX_ROWS, tblas._PALLAS_MAX_ROWS)
    jblas._PALLAS_MAX_ROWS = tblas._PALLAS_MAX_ROWS = 256
    yield
    jblas._PALLAS_MAX_ROWS, tblas._PALLAS_MAX_ROWS = old


@pytest.mark.parametrize("m", [512, 640])
def test_panel_lu_tournament_matches(shrunk_kernel_rows, m):
    # m=640: three chunks, so the tree pads a zero block with id mp
    panel = make_test_matrix(m, 128, seed=17).astype(np.float32)
    _assert_panel_equal(jblas.panel_lu(jnp.asarray(panel), algo="pallas"),
                        tblas.panel_lu(torch.from_numpy(panel), algo="kernel"))


def test_panel_winners_tournament_matches(shrunk_kernel_rows):
    panel = make_test_matrix(640, 128, seed=19).astype(np.float32)
    lu_j, gpiv_j = jblas.panel_winners(jnp.asarray(panel), algo="pallas")
    lu_t, gpiv_t = tblas.panel_winners(torch.from_numpy(panel), algo="kernel")
    np.testing.assert_array_equal(gpiv_t.numpy(), np.asarray(gpiv_j))
    np.testing.assert_allclose(lu_t.numpy(), np.asarray(lu_j), rtol=1e-4, atol=1e-4)


def test_chunk_ceilings_pinned_to_the_jax_values():
    for v in (128, 256, 1024):
        assert tblas.single_call_rows(v) == jblas.single_call_rows(
            v, budget=jblas._SCOPED_VMEM_DEFAULT)
        assert tblas.batched_call_rows(v) == jblas.batched_call_rows(
            v, budget=jblas._SCOPED_VMEM_DEFAULT)
        for m in (1024, 5000, 32768):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jblas, "_SCOPED_VMEM_BYTES", jblas._SCOPED_VMEM_DEFAULT)
                assert tblas.chunk_layout(m, v) == jblas.chunk_layout(m, v)


def test_panel_algos_not_ported_raise():
    panel = torch.zeros((256, 128))
    for algo in ("auto", "partial", "tournament"):
        with pytest.raises(NotImplementedError):
            tblas.panel_lu(panel, algo=algo)
    with pytest.raises(ValueError):
        tblas.panel_lu(panel.double(), algo="kernel")


@pytest.mark.parametrize("m,v", [(16, 4), (64, 8), (256, 32)])
def test_swap_minimal_perm_matches(m, v):
    rng = np.random.default_rng(m)
    for _ in range(10):
        gpiv = rng.choice(m, size=v, replace=False)
        want = np.asarray(jpermute.swap_minimal_perm(jnp.asarray(gpiv), m))
        got = tpermute.swap_minimal_perm(torch.from_numpy(gpiv), m)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gpiv", [[10, 3], [3, 8, 1], [9, 9, 2]])
def test_swap_minimal_perm_out_of_range_matches(gpiv):
    # pad ids >= m (rank-deficient tournament) must still give a permutation
    gpiv = np.asarray(gpiv)
    want = np.asarray(jpermute.swap_minimal_perm(jnp.asarray(gpiv), 8))
    got = tpermute.swap_minimal_perm(torch.from_numpy(gpiv), 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(8))


def test_permute_ops_match():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((12, 7))
    perm = rng.permutation(12)
    mask = rng.random(12) < 0.4
    At, pt = torch.from_numpy(A), torch.from_numpy(perm)
    for jf, tf in ((jpermute.permute_rows, tpermute.permute_rows),
                   (jpermute.inverse_permute_rows, tpermute.inverse_permute_rows)):
        np.testing.assert_array_equal(tf(At, pt).numpy(),
                                      np.asarray(jf(jnp.asarray(A), jnp.asarray(perm))))
    np.testing.assert_array_equal(tpermute.invert_permutation(pt).numpy(),
                                  np.asarray(jpermute.invert_permutation(jnp.asarray(perm))))
    out_j, perm_j = jpermute.push_pivots_up(jnp.asarray(A), jnp.asarray(mask))
    out_t, perm_t = tpermute.push_pivots_up(At, torch.from_numpy(mask))
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    col = np.arange(12)
    np.testing.assert_array_equal(
        tpermute.prepend_column(At, torch.from_numpy(col)).numpy(),
        np.asarray(jpermute.prepend_column(jnp.asarray(A), jnp.asarray(col))))
