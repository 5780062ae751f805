"""The port's library routes on the CPU (`backend="xla"`, panel algos
"partial", "tournament" and "auto", float64 and complex), against the JAX
package's default configuration on the same seeded inputs. Both sides run
LAPACK's getrf on the CPU, so the pivots must be equal; packed factors
agree to rtol 1e-12 (float64) or 1e-4 (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.cholesky.single import cholesky_blocked as jchol
from conflux_tpu.lu import single as jsingle
from conflux_tpu.ops import blas as jblas
from conflux_tpu_torch.cholesky import cholesky_blocked
from conflux_tpu_torch.lu import single as tsingle
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.validation import lu_residual, residual_bound

RTOL = {np.float64: 1e-12, np.float32: 1e-4}


@pytest.fixture
def library_route():
    """The port on the JAX package's default route, xla / auto, and back
    to kernel / kernel after."""
    jb, ja = jblas.get_backend(), jblas.get_panel_algo()
    jblas.set_backend("xla")
    jblas.set_panel_algo("auto")
    tblas.set_backend("xla")
    tblas.set_panel_algo("auto")
    yield
    tblas.set_backend("kernel")
    tblas.set_panel_algo("kernel")
    jblas.set_backend(jb)
    jblas.set_panel_algo(ja)


def _panel(m, v, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, v)).astype(dtype)


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(want).max())


def test_registry_takes_the_library_names(library_route):
    assert tblas.get_backend() == "xla" and tblas.get_panel_algo() == "auto"
    for algo in ("partial", "tournament", "kernel"):
        tblas.set_panel_algo(algo)
    with pytest.raises(ValueError, match="unknown backend"):
        tblas.set_backend("pallas")
    with pytest.raises(ValueError, match="unknown panel algo"):
        tblas.set_panel_algo("pallas")


@pytest.mark.parametrize("m,v", [(64, 8), (5000, 128), (20000, 1024), (70000, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_auto_resolves_by_the_jax_rule(m, v, dtype):
    want = "tournament" if m > 2 * max(jblas.batched_call_rows(
        v, jnp.float32 if dtype != torch.float64 else jnp.float64,
        budget=jblas._SCOPED_VMEM_DEFAULT), v) else "partial"
    assert tblas._resolve_panel_algo(tblas.compute_dtype(dtype), m, v, "auto") == want


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,v", [(64, 8), (96, 16), (33, 33)])
def test_partial_panel_lu_and_winners_match(dtype, m, v):
    P = _panel(m, v, m + v, dtype)
    lu_j, perm_j = jblas.panel_lu(jnp.asarray(P), algo="partial")
    lu_t, perm_t = tblas.panel_lu(torch.from_numpy(P), algo="partial")
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    _close(lu_t.numpy(), lu_j, dtype)
    w_j = jblas.panel_winners(jnp.asarray(P), algo="partial")
    w_t = tblas.panel_winners(torch.from_numpy(P), algo="partial")
    np.testing.assert_array_equal(w_t[1].numpy(), np.asarray(w_j[1]))
    _close(w_t[0].numpy(), w_j[0], dtype)


@pytest.mark.parametrize("m,v,chunk", [(32, 8, 8), (64, 8, 16), (96, 16, 32), (80, 16, 32)])
@pytest.mark.parametrize("tree", ["pairwise", "flat"])
def test_library_tournament_matches(m, v, chunk, tree):
    P = _panel(m, v, m * v + chunk)
    lu_j, g_j = jblas.tournament_winners(jnp.asarray(P), chunk=chunk, tree=tree)
    lu_t, g_t = tblas.tournament_winners(torch.from_numpy(P), chunk=chunk,
                                         use_pallas=False, tree=tree)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    _close(lu_t.numpy(), lu_j, np.float64)
    lp_j, perm_j = jblas.panel_lu_tournament(jnp.asarray(P), chunk=chunk)
    lp_t, perm_t = tblas.panel_lu_tournament(torch.from_numpy(P), chunk=chunk,
                                             use_pallas=False)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    _close(lp_t.numpy(), lp_j, np.float64)


@pytest.mark.parametrize("live", [[True, False, True, True, False], [False, True, False, False, True],
                                  [True] * 5])
def test_library_tournament_chunk_live(live):
    """Dead chunks skip their LU and nominate their first v rows in
    identity order with a zero packed LU, as the JAX `lax.cond` does."""
    P = _panel(80, 8, 11)
    P[16:32] = 0.0  # a dead chunk's rows are zero in the callers
    lu_j, g_j = jblas.tournament_winners(jnp.asarray(P), chunk=16,
                                         chunk_live=jnp.asarray(live))
    lu_t, g_t = tblas.tournament_winners(torch.from_numpy(P), chunk=16, use_pallas=False,
                                         chunk_live=torch.tensor(live))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    _close(lu_t.numpy(), lu_j, np.float64)
    with pytest.raises(ValueError, match="chunk_live"):
        tblas.tournament_winners(torch.from_numpy(P), chunk=16, use_pallas=False,
                                 chunk_live=[True, False])


def test_library_tournament_pad_rows_lose_and_keep_their_ids():
    """A rank-deficient panel (zero rows past a full-rank block) still
    elects only real rows, and the tree's pad blocks keep the id mp."""
    P = np.zeros((48, 8))
    P[:8] = np.random.default_rng(5).standard_normal((8, 8)) + 4 * np.eye(8)
    _lu, g_t = tblas.tournament_winners(torch.from_numpy(P), chunk=16, use_pallas=False)
    _lu, g_j = jblas.tournament_winners(jnp.asarray(P), chunk=16)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert sorted(g_t.tolist()) == list(range(8))


def test_swaps_to_perm_is_lapack_order():
    rng = np.random.default_rng(3)
    for m, k in ((10, 4), (64, 64), (100, 7)):
        A = torch.from_numpy(rng.standard_normal((3, m, k)))
        LU, piv, _ = torch.linalg.lu_factor_ex(A)
        P, _L, _U = torch.lu_unpack(LU, piv)
        want = P.mT.argmax(-1)  # A[perm] = P^T A
        assert torch.equal(tblas._swaps_to_perm(piv, m), want)


@pytest.mark.parametrize("lead", [(), (1,), (5,), (2, 3)])
def test_swaps_to_perm_one_panel_and_batches(lead):
    """A single panel (the dict replay) and batches of any leading shape
    (all slots swapped at once) give LAPACK's order, slot by slot."""
    rng = np.random.default_rng(4)
    m, k = 300, 40
    A = torch.from_numpy(rng.standard_normal(lead + (m, k)))
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    P, _L, _U = torch.lu_unpack(LU, piv)
    got = tblas._swaps_to_perm(piv, m)
    assert got.shape == lead + (m,) and got.dtype == torch.int64
    assert torch.equal(got, P.mT.argmax(-1))
    assert torch.equal(torch.gather(A, -2, got[..., None].expand(A.shape)), P.mT @ A)


@pytest.mark.parametrize("shape,backend", [
    ((4096, 1024), "cusolver"), ((8, 4096, 1024), "cusolver"), ((9, 2048, 1024), "default"),
    ((32, 1024, 256), "default"), ((16, 4096, 256), "cusolver"), ((2, 5, 256, 64), "default")])
def test_library_lu_backend_rule(shape, backend):
    """On the card up to `_CUSOLVER_MAX_BATCH` panels, and any batch of
    panels taller than MAGMA's batched limit (whose banner would go to
    stdout), factor on cuSOLVER; other batches on torch's default."""
    assert tblas._library_lu_backend(shape) == backend


@pytest.mark.parametrize("swap_max", [16384, 0])
@pytest.mark.parametrize("N,v", [(128, 32), (96, 32)])
def test_lu_factor_blocked_f64_matches_jax(library_route, monkeypatch, swap_max, N, v):
    """float64 on the library route, swap-minimal row placement and the
    full-gather one: equal pivots, packed factors to rtol 1e-12."""
    monkeypatch.setattr(jsingle, "_SWAP_SCATTER_MAX", swap_max)
    monkeypatch.setattr(tsingle, "_SWAP_SCATTER_MAX", swap_max)
    A = np.random.default_rng(N + swap_max).standard_normal((N, N))
    LU_j, perm_j = jsingle.lu_factor_blocked(jnp.asarray(A), v)
    LU_t, perm_t = tsingle.lu_factor_blocked(torch.from_numpy(A), v)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    _close(LU_t.numpy(), LU_j, np.float64)
    assert lu_residual(A, LU_t.numpy(), perm_t.numpy()) <= residual_bound(N, np.float64)


def test_lu_factor_blocked_f32_xla_tall_tournament_matches_jax(library_route, monkeypatch):
    """A tall f32 panel under "auto" takes the library tournament (the
    ceiling shrunk so a small panel is tall)."""
    monkeypatch.setattr(jblas, "_SCOPED_VMEM_BYTES", 1 << 19)
    monkeypatch.setattr(tblas, "_SCOPED_VMEM_DEFAULT", 1 << 19)
    v = 64
    assert tblas._resolve_panel_algo(torch.float32, 4 * 1024, v, "auto") == "tournament"
    A = np.random.default_rng(8).standard_normal((4096, 128)).astype(np.float32)
    LU_j, perm_j = jsingle.lu_factor_blocked(jnp.asarray(A), v)
    LU_t, perm_t = tsingle.lu_factor_blocked(torch.from_numpy(A), v)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    _close(LU_t.numpy(), LU_j, np.float32)


def test_float64_on_the_kernel_route_raises_naming_it():
    A = torch.eye(256, dtype=torch.float64)
    with pytest.raises(ValueError, match="backend 'xla'"):
        tsingle.lu_factor_blocked(A, 128, backend="kernel", panel_algo="auto")
    with pytest.raises(ValueError, match="panel algo 'kernel'"):
        tsingle.lu_factor_blocked(A, 128, backend="xla", panel_algo="kernel")
    with pytest.raises(ValueError, match="backend 'xla'"):
        cholesky_blocked(A.to(torch.complex128), 128, backend="kernel")


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_cholesky_blocked_f64_and_complex_match_jax(library_route, dtype):
    from conflux_tpu import validation as jval
    from conflux_tpu_torch import validation as tval

    N, v = 96, 32
    A = (tval.make_hpd_matrix(N).numpy() if dtype == np.complex128
         else tval.make_spd_matrix(N).numpy())
    if dtype == np.complex128:
        assert np.array_equal(A, jval.make_hpd_matrix(N))
    L_t = cholesky_blocked(torch.from_numpy(A), v)
    L_j = np.asarray(jchol(jnp.asarray(A), v))
    _close(L_t.numpy(), L_j, np.float64)
    assert np.linalg.norm(L_t.numpy() @ L_t.numpy().conj().T - A) / np.linalg.norm(A) < 1e-14


def test_xla_gemm_matches_jax_in_every_dtype(library_route):
    rng = np.random.default_rng(4)
    for dt, jdt, tol in ((torch.float64, jnp.float64, 1e-13), (torch.float32, jnp.float32, 1e-6),
                         (torch.complex128, jnp.complex128, 1e-13)):
        a = rng.standard_normal((40, 24)) + (1j * rng.standard_normal((40, 24))
                                             if dt.is_complex else 0)
        b = rng.standard_normal((24, 32)) + (1j * rng.standard_normal((24, 32))
                                             if dt.is_complex else 0)
        c = rng.standard_normal((40, 32))
        ta, tb, tc = (torch.from_numpy(np.asarray(x)).to(dt) for x in (a, b, c))
        want = np.asarray(jblas.gemm(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                                     jnp.asarray(c, jdt), alpha=-1.0))
        got = tblas.gemm(ta, tb, tc, alpha=-1.0)
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
        out = tc.clone()
        assert tblas.gemm(ta, tb, c=out, alpha=-1.0, out=out) is out
        assert np.abs(out.numpy() - want).max() <= tol * np.abs(want).max()
    a, b = (torch.from_numpy(rng.standard_normal(s)).bfloat16() for s in ((16, 8), (8, 12)))
    want = np.asarray(jblas.gemm(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(b.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    got = tblas.gemm(a, b)
    assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)


def test_transposed_and_hermitian_trsms_match_jax():
    rng = np.random.default_rng(6)
    for dt in (np.float64, np.complex128):
        T = rng.standard_normal((12, 12)) + 4 * np.eye(12)
        B = rng.standard_normal((12, 3))
        if dt == np.complex128:
            T = T + 1j * rng.standard_normal((12, 12))
            B = B + 1j * rng.standard_normal((12, 3))
        L, U = np.tril(T), np.triu(T)
        for name, M in (("trsm_left_upper_t", U), ("trsm_left_lower_unit_t", L),
                        ("trsm_left_lower_t", L)):
            want = np.asarray(getattr(jblas, name)(jnp.asarray(M), jnp.asarray(B)))
            got = getattr(tblas, name)(torch.from_numpy(M), torch.from_numpy(B)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        want = np.asarray(jblas.trsm_right_lower_t(jnp.asarray(L), jnp.asarray(B.T)))
        got = tblas.trsm_right_lower_t(torch.from_numpy(L), torch.from_numpy(B.T.copy())).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_xla_batched_lu_factor_matches_jax(dtype):
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((3, 48, 48)) + 2 * np.eye(48)).astype(dtype)
    w = np.where(rng.random(48) < 0.5, -1.0, 1.0).astype(np.float32)
    LU_j, perm_j, wa_j = jblas.batched_lu_factor(jnp.asarray(A), probe_w=jnp.asarray(w),
                                                 backend="xla")
    LU_t, perm_t, wa_t = tblas.batched_lu_factor(torch.from_numpy(A), probe_w=torch.from_numpy(w),
                                                 backend="xla")
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    _close(LU_t.numpy(), LU_j, dtype)
    _close(wa_t.numpy(), wa_j, dtype)
    LU2, perm2 = tblas.batched_lu_factor(torch.from_numpy(A), backend="xla")
    assert torch.equal(LU2, LU_t) and torch.equal(perm2, perm_t)


def test_xla_batched_cholesky_factor_nan_where_not_spd():
    """A slot that is not positive definite comes out NaN, as the JAX CPU
    Cholesky returns it; the others match the JAX factors."""
    rng = np.random.default_rng(10)
    M = rng.standard_normal((4, 32, 32))
    A = np.einsum("bij,bkj->bik", M, M) / 32 + np.eye(32)
    A[1, 3, 3] = -5.0
    w = np.ones(32, np.float32)
    L_j, wa_j = jblas.batched_cholesky_factor(jnp.asarray(A), probe_w=jnp.asarray(w),
                                              backend="xla")
    L_t, wa_t = tblas.batched_cholesky_factor(torch.from_numpy(A), probe_w=torch.from_numpy(w),
                                              backend="xla")
    L_j = np.asarray(L_j)
    np.testing.assert_array_equal(L_t[1].numpy(), L_j[1])  # NaN lower, zero upper
    for i in (0, 2, 3):
        _close(L_t[i].numpy(), L_j[i], np.float64)
    _close(wa_t.numpy(), wa_j, np.float64)
