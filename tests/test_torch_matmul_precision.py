"""Matmul precision in the port (`blas.set_matmul_precision`, `precision=`
on every entry point that takes it) against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
counterpart at each level, DEFAULT, HIGH and HIGHEST, by name and by enum.
On the CPU both packages compute every level in IEEE arithmetic (XLA:CPU
ignores the precision; the port's TF32 product runs on the card only), so
the port is bitwise its own HIGHEST call at every level and within the
float32 or float64 rounding of the JAX result: rtol 1e-4 / atol 1e-5 for
float32 factors and solves (two libraries' sums in different orders, the
bar of the other parity tests), rtol 1e-10 for float64. The plan codec
round-trips between the two packages at every level; the JAX package's
keyword calls of `choose_cholesky_tile`, `enable_persistent_cache` and
`FactorPlan.create(persistent_cache=)`, and `FactorPlan.solve`, run in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conflux_tpu import batched as jbatched
from conflux_tpu import cache as jcache
from conflux_tpu import geometry as jgeometry
from conflux_tpu import serve as jserve
from conflux_tpu import solvers as jsolvers
from conflux_tpu.cholesky.distributed import cholesky_factor_distributed as jchol_dist
from conflux_tpu.cholesky.single import cholesky_blocked as jchol
from conflux_tpu.lu.distributed import lu_factor_distributed as jlu_dist
from conflux_tpu.lu.single import lu_factor_blocked as jlu
from conflux_tpu.ops import batched_trsm as jbt
from conflux_tpu.ops import blas as jblas
from conflux_tpu.parallel.mesh import make_mesh as jmake_mesh
from conflux_tpu.qr import single as jqr_single
from conflux_tpu.qr.distributed import qr_factor_distributed as jqr_dist
from conflux_tpu_torch import batched as tbatched
from conflux_tpu_torch import cache as tcache
from conflux_tpu_torch import geometry as tgeometry
from conflux_tpu_torch import serve as tserve
from conflux_tpu_torch import solvers as tsolvers
from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed as tchol_dist
from conflux_tpu_torch.cholesky.single import cholesky_blocked as tchol
from conflux_tpu_torch.lu.distributed import lu_factor_distributed as tlu_dist
from conflux_tpu_torch.lu.single import lu_factor_blocked as tlu
from conflux_tpu_torch.ops import batched_trsm as tbt
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from conflux_tpu_torch.qr import single as tqr_single
from conflux_tpu_torch.qr.distributed import qr_factor_distributed as tqr_dist
from torch_registry_guard import registry_guard  # noqa: F401

# the three levels by name, and the port's enum
LEVELS = ("default", "high", "highest")
F32 = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture
def library_route():
    """Backend "xla" and panel algo "auto" in both packages (the JAX
    package's defaults), put back after."""
    jb, ja = jblas.get_backend(), jblas.get_panel_algo()
    tb, ta = tblas.get_backend(), tblas.get_panel_algo()
    jblas.set_backend("xla")
    jblas.set_panel_algo("auto")
    tblas.set_backend("xla")
    tblas.set_panel_algo("auto")
    yield
    tblas.set_backend(tb)
    tblas.set_panel_algo(ta)
    jblas.set_backend(jb)
    jblas.set_panel_algo(ja)


@pytest.fixture
def registry_precision():
    """Sets the matmul precision of both registries; puts both back."""
    jp, tp = jblas.matmul_precision(), tblas.matmul_precision()

    def set_both(p):
        jblas.set_matmul_precision(p)
        tblas.set_matmul_precision(p)

    yield set_both
    jblas.set_matmul_precision(jp)
    tblas.set_matmul_precision(tp)


def _gen(rng, shape, dtype=np.float32):
    n = shape[-1]
    return (rng.standard_normal(shape) / np.sqrt(n) + 2.0 * np.eye(n)).astype(dtype)


def _spd(rng, shape, dtype=np.float32):
    M = _gen(rng, shape)
    return (M @ np.swapaxes(M, -1, -2) + np.eye(shape[-1])).astype(dtype)


def _enum(name: str):
    """The level as each package's own enum: (lax.Precision, blas.Precision)."""
    return lax.Precision(name), tblas.Precision(name)


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["default", "fastest", "bfloat16", "high", "bfloat16_3x",
                                  "tensorfloat32", "highest", "float32"])
def test_names_resolve_as_lax_precision(name):
    assert tblas.resolve_precision(name).name == lax.Precision(name).name
    assert tblas.Precision(name).name == lax.Precision(name).name
    assert str(tblas.Precision(name)) == str(lax.Precision(name))


def test_set_and_read_the_registry_like_the_reference(registry_precision):
    assert tblas.matmul_precision().name == jblas.matmul_precision().name == "HIGHEST"
    assert tblas.resolve_precision(None) is tblas.Precision.HIGHEST
    for p in ("high", "default", "highest"):
        registry_precision(p)
        assert tblas.matmul_precision() == jblas.matmul_precision() == p
        assert tblas.resolve_precision(None).name == lax.Precision(p).name
    registry_precision(lax.Precision.HIGH)
    assert tblas.resolve_precision(None) is tblas.Precision.HIGH  # the enum, by name
    with pytest.raises(ValueError, match="matmul precision"):
        tblas.set_matmul_precision("nope")
    with pytest.raises(ValueError):
        lax.Precision("nope")


def test_no_process_wide_tf32_switch_after_a_low_precision_call():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)) for _ in range(2))
    x = tblas.gemm(a, b, None, 1.0, 1.0, "default", "xla")
    assert torch.equal(x, tblas.gemm(a, b, None, 1.0, 1.0, "highest", "xla"))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert tblas.TF32_CALLS == 0  # the CPU never takes the TF32 product
    with pytest.raises(ValueError, match="CUDA float32"):
        tblas.tf32_gemm(a, b)


# --------------------------------------------------------------------------- #
# ops: gemm, blocked_trsm, blocked_solve(_probe)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gemm_matches_jax_at_every_level(level, dtype):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 24, 16)).astype(dtype)
    b = rng.standard_normal((16, 20)).astype(dtype)
    c = rng.standard_normal((3, 24, 20)).astype(dtype)
    tol = F32 if dtype == np.float32 else F64
    jp, tp = _enum(level)
    want = np.asarray(jblas.gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), -1.0, 0.5,
                                 jp, "xla"))
    ta, tb_, tc = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)
    got = tblas.gemm(ta, tb_, tc, -1.0, 0.5, level, "xla")  # the reference's positions
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert torch.equal(tblas.gemm(ta, tb_, tc, -1.0, 0.5, tp, "xla"), got)
    assert torch.equal(tblas.gemm(ta, tb_, tc, -1.0, 0.5, None, "xla"), got)
    # in place on c, and the kernel backend (K1's plain version here), which
    # takes no precision
    inplace = tc.clone()
    tblas.gemm(ta, tb_, inplace, -1.0, 0.5, level, "xla", out=inplace)
    np.testing.assert_allclose(inplace.numpy(), want, **tol)
    if dtype == np.float32:
        k = tblas.gemm(ta[0], tb_, tc[0], -1.0, 0.5, level, "kernel")
        assert torch.equal(k, tblas.gemm(ta[0], tb_, tc[0], -1.0, 0.5, "highest", "kernel"))
        np.testing.assert_allclose(k.numpy(), want[0], **F32)


@pytest.mark.parametrize("level", LEVELS)
def test_blocked_trsm_and_solves_match_jax(level):
    rng = np.random.default_rng(3)
    B, n, k = 3, 40, 2
    T = np.tril(_gen(rng, (B, n, n)))
    b = rng.standard_normal((B, n, k)).astype(np.float32)
    jp, tp = _enum(level)
    want = np.asarray(jblas.blocked_trsm(jnp.asarray(T), jnp.asarray(b), lower=True,
                                         precision=jp, backend="xla"))
    got = tblas.blocked_trsm(torch.from_numpy(T), torch.from_numpy(b), lower=True,
                             precision=level, backend="xla")
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # the block loop itself, per system (the JAX package's is 2D, vmap-safe)
    Tt = torch.from_numpy(T)
    dinv = tbt.diag_block_inverses(Tt, lower=True)
    jdinv = jbt.diag_block_inverses(jnp.asarray(T[0]), lower=True)
    np.testing.assert_allclose(dinv[0].numpy(), np.asarray(jdinv), **F32)
    x = tbt.blocked_solve(Tt, dinv, torch.from_numpy(b), lower=True, precision=level)
    xj = np.stack([np.asarray(jbt.blocked_solve(jnp.asarray(T[i]), jnp.asarray(dinv[i].numpy()),
                                                jnp.asarray(b[i]), lower=True, precision=jp))
                   for i in range(B)])
    np.testing.assert_allclose(x.numpy(), xj, **F32)
    assert torch.equal(x, tbt.blocked_solve(Tt, dinv, torch.from_numpy(b), lower=True))
    wA = rng.standard_normal(n).astype(np.float32)
    U = torch.from_numpy(np.triu(_gen(rng, (n, n))))
    du = tbt.diag_block_inverses(U, lower=False)
    xp, xs, wx = tbt.blocked_solve_probe(U, du, torch.from_numpy(b[0]), torch.from_numpy(wA),
                                         precision=tp)
    jx, js, jw = jbt.blocked_solve_probe(jnp.asarray(U.numpy()), jnp.asarray(du.numpy()),
                                         jnp.asarray(b[0]), jnp.asarray(wA), precision=jp)
    np.testing.assert_allclose(xp.numpy(), np.asarray(jx), **F32)
    np.testing.assert_allclose([float(xs), float(wx)], [float(js), float(jw)], rtol=1e-4)


# --------------------------------------------------------------------------- #
# the factor entry points
# --------------------------------------------------------------------------- #


def test_single_device_factors_match_jax_at_every_level(library_route):
    rng = np.random.default_rng(4)
    N, v = 32, 8
    A = _gen(rng, (N, N), np.float64)
    S = _spd(rng, (N, N), np.float64)
    LUj, permj = jlu(jnp.asarray(A), v, lax.Precision.HIGH, "xla")
    Lj = np.asarray(jchol(jnp.asarray(S), v, lax.Precision.HIGH, "xla"))
    base = None
    for level in (*LEVELS, *(_enum(n)[1] for n in LEVELS)):
        LU, perm = tlu(torch.from_numpy(A), v, level, "xla", panel_algo="auto")
        L = tchol(torch.from_numpy(S), v, level, "xla")
        np.testing.assert_array_equal(perm.numpy(), np.asarray(permj))
        np.testing.assert_allclose(LU.numpy(), np.asarray(LUj), **F64)
        np.testing.assert_allclose(L.numpy(), Lj, **F64)
        if base is None:
            base = (LU, L)
        assert torch.equal(LU, base[0]) and torch.equal(L, base[1])


def test_grid_factors_match_jax_at_every_level():
    """The three grid factors on a 1x1x1 mesh: the JAX program once (at
    HIGH; XLA:CPU computes every level alike), the port at every level,
    each bitwise its HIGHEST run."""
    from conflux_tpu.geometry import CholeskyGeometry as JCG
    from conflux_tpu.geometry import Grid3 as JGrid3
    from conflux_tpu.geometry import LUGeometry as JLG
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry

    rng = np.random.default_rng(5)
    N, v = 64, 16
    A = _gen(rng, (N, N), np.float64)
    S = _spd(rng, (N, N), np.float64)
    jmesh = jmake_mesh(JGrid3(1, 1, 1), devices=jax.devices()[:1])
    tmesh = tmake_mesh(Grid3(1, 1, 1), device="cpu")
    jlg, tlg = JLG.create(N, N, v, JGrid3(1, 1, 1)), LUGeometry.create(N, N, v, Grid3(1, 1, 1))
    jcg, tcg = JCG.create(N, v, JGrid3(1, 1, 1)), CholeskyGeometry.create(N, v, Grid3(1, 1, 1))
    hi = lax.Precision.HIGH
    jlu_out, jperm = jlu_dist(jnp.asarray(jlg.scatter(A)), jlg, jmesh, hi, "xla")
    jch_out = jchol_dist(jnp.asarray(jcg.scatter(S)), jcg, jmesh, hi, "xla")
    jQ, jR = jqr_dist(jnp.asarray(jlg.scatter(A)), jlg, jmesh, hi, "xla")
    jQ = jlg.gather(np.asarray(jQ))
    runs = {}
    for level in LEVELS:
        out, perm = tlu_dist(torch.from_numpy(tlg.scatter(A)[0, 0]), tlg, tmesh, level, "xla",
                             panel_algo="auto")
        ch = tchol_dist(torch.from_numpy(tcg.scatter(S)[0, 0]), tcg, tmesh, level, "xla")
        Q, R = tqr_dist(torch.from_numpy(tlg.scatter(A)[0, 0]), tlg, tmesh, level, "xla")
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_allclose(out.numpy(), np.asarray(jlu_out)[0, 0], **F64)
        np.testing.assert_allclose(ch.numpy(), np.asarray(jch_out)[0, 0], **F64)
        np.testing.assert_allclose(tlg.gather(Q.numpy()[None, None]), jQ, **F64)
        np.testing.assert_allclose(R.numpy(), np.asarray(jR)[0, 0], **F64)
        runs[level] = (out, ch, Q, R)
    for level in ("default", "high"):
        assert all(torch.equal(x, y) for x, y in zip(runs[level], runs["highest"]))


@pytest.mark.parametrize("level", LEVELS)
def test_batched_entry_points_match_jax(level, library_route):
    rng = np.random.default_rng(6)
    B, N, v, k = 3, 32, 8, 2
    A = _gen(rng, (B, N, N), np.float64)
    S = _spd(rng, (B, N, N), np.float64)
    b = rng.standard_normal((B, N)).astype(np.float64)
    U = rng.standard_normal((B, N, k)) / N
    V = rng.standard_normal((B, N, k)) / N
    jp, tp = _enum(level)
    t = torch.from_numpy
    LU, perm = tbatched.lu_factor_batched(t(A), v, precision=level)
    LUj, permj = jbatched.lu_factor_batched(jnp.asarray(A), v, precision=jp)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(permj))
    np.testing.assert_allclose(LU.numpy(), np.asarray(LUj), **F64)
    L = tbatched.cholesky_factor_batched(t(S), v, precision=tp)
    np.testing.assert_allclose(
        L.numpy(), np.asarray(jbatched.cholesky_factor_batched(jnp.asarray(S), v, precision=jp)),
        **F64)
    x = tbatched.solve_batched(t(A), t(b), v=v, refine=1, precision=level)
    xj = jbatched.solve_batched(jnp.asarray(A), jnp.asarray(b), v=v, refine=1, precision=jp)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **F64)
    y = tbatched.solve_updated_batched(t(A), t(U), t(V), t(b), v=v, precision=level)
    yj = jbatched.solve_updated_batched(jnp.asarray(A), jnp.asarray(U), jnp.asarray(V),
                                        jnp.asarray(b), v=v, precision=jp)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F64)


def test_solve_distributed_high_matches_jax_and_refines():
    """`precision=` reaches the grid factor; the sweeps stay IEEE with
    float64 residuals (the HPL-MxP recipe)."""
    from conflux_tpu.geometry import Grid3 as JGrid3
    from conflux_tpu_torch.geometry import Grid3

    rng = np.random.default_rng(7)
    N, v = 64, 16
    A = _gen(rng, (N, N), np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    jmesh = jmake_mesh(JGrid3(1, 1, 1), devices=jax.devices()[:1])
    xj = np.asarray(jsolvers.solve_distributed(jnp.asarray(A), jnp.asarray(b),
                                               grid=JGrid3(1, 1, 1), v=v, mesh=jmesh, refine=2,
                                               precision=lax.Precision.HIGH))
    x = tsolvers.solve_distributed(torch.from_numpy(A), torch.from_numpy(b), grid=Grid3(1, 1, 1),
                                   v=v, refine=2, precision="high", backend="xla",
                                   panel_algo="auto", device="cpu")
    assert x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-9, atol=1e-12)
    r = np.abs(A.astype(np.float64) @ x.numpy() - b).max() / np.abs(b).max()
    assert r <= 1e-6


@pytest.mark.parametrize("fdtype,diverges", [(torch.bfloat16, True), (None, False)])
def test_solve_distributed_warns_when_classic_refinement_diverges(fdtype, diverges):
    """A factor too coarse for the matrix (bfloat16 at N=512 on randn + 2 I,
    cond(A) eps_factor past 1) makes classic sweeps grow the residual:
    the solve warns instead of returning that x silently. A float32 factor
    converges and does not warn."""
    import warnings

    from conflux_tpu_torch.geometry import Grid3

    N = 512 if diverges else 256
    g = torch.Generator().manual_seed(0)
    A = torch.randn((N, N), generator=g)
    A.diagonal().add_(2.0)
    b = torch.ones(N)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x = tsolvers.solve_distributed(A, b, grid=Grid3(1, 1, 1), v=64, refine=3,
                                       factor_dtype=fdtype, backend="xla",
                                       panel_algo="partial", device="cpu")
    diverged = [w for w in caught if "classic refinement diverged" in str(w.message)]
    rel = float(torch.linalg.norm(b.double() - A.double() @ x) / np.sqrt(N))
    assert bool(diverged) == diverges, [str(w.message) for w in caught]
    assert (rel > 1.0) if diverges else (rel <= 1e-12)
    if diverged:
        assert diverged[0].category is RuntimeWarning


def test_tf32_factor_bar_is_below_one_and_float32_bar_unchanged():
    """The TF32 factor bar is TF32_BOUND_C sqrt(n) 2^-10: below 1 where it
    exists (0.707 at N=32768), refused from n=65536 where it would reach
    1; HIGHEST and float64 keep the reference's 100 sqrt(n) eps."""
    from conflux_tpu.validation import residual_bound as jbound
    from conflux_tpu_torch import validation as tval

    for level in ("default", "high", tblas.Precision.HIGH, "tensorfloat32"):
        bar = tval.residual_bound(32768, torch.float32, precision=level)
        assert bar == pytest.approx(4.0 * np.sqrt(32768) * 2.0 ** -10) and 0.2997 < bar < 1
        assert tval.residual_bound(65535, np.float32, precision=level) < 1
        with pytest.raises(ValueError, match="no TF32 residual bar"):
            tval.residual_bound(65536, torch.float32, precision=level)
    for n, dt, level in ((32768, np.float32, "highest"), (32768, np.float32, None),
                         (4096, np.float64, "high"), (4096, np.complex64, None)):
        assert tval.residual_bound(n, dt, precision=level) == pytest.approx(jbound(n, dt))


def test_qr_reads_the_registry_precision(registry_precision):
    rng = np.random.default_rng(8)
    A = rng.standard_normal((96, 32)).astype(np.float32)
    Q0, R0 = tqr_single.qr_factor_blocked(torch.from_numpy(A), v=16)
    registry_precision("high")
    Q, R = tqr_single.qr_factor_blocked(torch.from_numpy(A), v=16)
    Qj, Rj = jqr_single.qr_factor_blocked(jnp.asarray(A), v=16)
    assert torch.equal(Q, Q0) and torch.equal(R, R0)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=1e-4, atol=1e-4)
    Qp, Rp = tqr_single.tall_qr(torch.from_numpy(A))
    Qpj, Rpj = jqr_single.tall_qr(jnp.asarray(A))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rpj), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# plans and the codec
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("p", ["DEFAULT", "HIGH", "HIGHEST", "default", "high", "highest",
                               "tensorfloat32"])
def test_plan_codec_round_trips_between_the_packages(p, library_route):
    """A JAX plan at each level (the enum, tagged in the record, or a
    string name, kept as it is) and the port's plan at the same level
    write the same record; each package decodes the other's to its own
    plan at that level, a plan of its own beside the default's."""
    N, V = 32, 16
    jprec = lax.Precision[p] if p.isupper() else p
    tprec = tblas.Precision[p] if p.isupper() else p
    jserve.clear_plans()
    tserve.clear_plans()
    jp = jserve.FactorPlan.create((N, N), jnp.float32, v=V, precision=jprec,
                                  persistent_cache=False)
    tp = tserve.FactorPlan.create((N, N), torch.float32, v=V, precision=tprec,
                                  persistent_cache=False)
    jd, td = jserve.plan_spec(jp), tp.spec()
    assert td == jd
    assert td["precision"] == (["precision", p] if p.isupper() else p)
    assert tserve.plan_from_spec(jd) is tp
    assert jserve.plan_from_spec(td) is jp
    default = tserve.FactorPlan.create((N, N), torch.float32, v=V, persistent_cache=False)
    assert (default is tp) == (p == "HIGHEST")


def test_xla_and_kernel_plans_at_default_match_their_highest_plans_and_jax(library_route):
    """On the CPU an "xla" plan at DEFAULT factors and solves bitwise its
    HIGHEST plan (both IEEE here); a kernel plan at DEFAULT is bitwise its
    HIGHEST plan everywhere (K4 and K3 take no precision). Both within
    float32 rounding of the JAX plan at DEFAULT."""
    rng = np.random.default_rng(9)
    N, V = 32, 16
    A = _gen(rng, (N, N))
    b = rng.standard_normal((N, 2)).astype(np.float32)
    tserve.clear_plans()
    jserve.clear_plans()
    xj = np.asarray(jserve.FactorPlan.create((N, N), jnp.float32, v=V,
                                             precision=lax.Precision.DEFAULT)
                    .factor(jnp.asarray(A)).solve(jnp.asarray(b)))
    for backend in ("xla", "kernel"):
        low = tserve.FactorPlan.create((N, N), torch.float32, v=V, backend=backend,
                                       precision=tblas.Precision.DEFAULT)
        high = tserve.FactorPlan.create((N, N), torch.float32, v=V, backend=backend)
        assert low is not high
        x = low.factor(A, device="cpu").solve(b)
        assert torch.equal(x, high.factor(A, device="cpu").solve(b))
        np.testing.assert_allclose(x.numpy(), xj, **F32)


def test_plan_solve_matches_the_reference():
    """`FactorPlan.solve(A, b)`, the one-shot factor and solve."""
    rng = np.random.default_rng(10)
    N, V = 32, 16
    A = _gen(rng, (N, N))
    b = rng.standard_normal(N).astype(np.float32)
    tserve.clear_plans()
    jserve.clear_plans()
    tp = tserve.FactorPlan.create((N, N), torch.float32, v=V, persistent_cache=False)
    x = tp.solve(A, b, device="cpu")
    xj = jserve.FactorPlan.create((N, N), jnp.float32, v=V, backend="pallas",
                                  persistent_cache=False).solve(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **F32)
    assert torch.equal(x, tp.factor(A, device="cpu").solve(b))


@pytest.mark.parametrize("N,P,kw", [(32768, 1, {}), (32768, 4, {"itemsize": 8}),
                                    (65536, 8, {"itemsize": 8, "hbm_bytes": 1 << 30}),
                                    (8192, 1, {"hbm_bytes": 1 << 20}), (300, 2, {})])
def test_choose_cholesky_tile_takes_the_reference_keywords(N, P, kw):
    assert tgeometry.choose_cholesky_tile(N, P, **kw) == jgeometry.choose_cholesky_tile(N, P, **kw)


def test_persistent_cache_keywords_of_the_reference(monkeypatch, tmp_path):
    """`enable_persistent_cache(path, min_compile_secs=)` and
    `FactorPlan.create(..., persistent_cache=)` take the JAX package's
    calls. The JAX latch is held set, so its call changes no compile
    cache of this process; the port's latch and build roots are put back
    after."""
    from conflux_tpu_torch import native
    from conflux_tpu_torch.ops import _build

    monkeypatch.setattr(jcache, "_ENABLED_AT", str(tmp_path / "jax"))
    assert jcache.enable_persistent_cache(str(tmp_path / "j2"), min_compile_secs=1.0) \
        == str(tmp_path / "jax")
    monkeypatch.setattr(tcache, "_ENABLED_AT", None)
    monkeypatch.setattr(_build, "_OUT_ROOT", _build._OUT_ROOT)
    monkeypatch.setattr(native, "_OUT_ROOT", native._OUT_ROOT)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CONFLUX_TPU_CACHE_DIR", str(tmp_path / "root"))
    tserve.clear_plans()
    jserve.clear_plans()
    tserve.FactorPlan.create((16, 16), torch.float32, v=8, persistent_cache=False)
    jserve.FactorPlan.create((16, 16), jnp.float32, v=8, persistent_cache=False)
    assert not tcache.cache_enabled()
    tserve.FactorPlan.create((16, 16), torch.float32, v=8)  # the default, True
    assert tcache.cache_dir() == str(tmp_path / "root")
    assert _build._OUT_ROOT == str(tmp_path / "root" / "ops" / "_kernels")
    assert tcache.enable_persistent_cache(str(tmp_path / "other"), min_compile_secs=1.0) \
        == str(tmp_path / "root")


# --------------------------------------------------------------------------- #
# the tuning sweep's command line
# --------------------------------------------------------------------------- #


def _tune_module():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_tune.py")
    spec = importlib.util.spec_from_file_location("torch_tune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bad", ["fast:8192:1024", "high:x:1024", "high:0:0",
                                 "highest:8192:1024:16:flat", "high:8192:1024:-:star",
                                 "high:0:1024:-:flat@cholesky"])
def test_tune_configs_are_checked_before_the_card(bad, capsys, monkeypatch):
    """The JAX sweep's config grammar, refused at parse time (exit 2 with
    the config named) before any device work: the card check is never
    reached, on a box with or without one."""
    mod = _tune_module()
    cfg, _, algo = bad.partition("@")
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: pytest.fail("the card was probed before the configs"))
    with pytest.raises(SystemExit) as ei:
        mod.main(["--configs", cfg, "--algo", algo or "lu"])
    assert ei.value.code == 2 and "config" in capsys.readouterr().err


def test_tune_parses_the_reference_grammar_and_needs_a_card(monkeypatch):
    mod = _tune_module()
    ap = mod._parser()
    assert mod.parse_configs(ap, "highest:8192:1024,high:0:512:8x4:flat,high:0:256:-:-",
                             "lu") == [("highest", 8192, 1024, None, "pairwise"),
                                       ("high", None, 512, (8, 4), "flat"),
                                       ("high", None, 256, None, "pairwise")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--configs", "highest:8192:1024", "-N", "1024"]) == 2
