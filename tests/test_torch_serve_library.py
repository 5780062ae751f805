"""Serve plans outside the batched factor kernels' gate on the CPU:
`backend="xla"` plans, bfloat16 storage and `factor_dtype != dtype` (the
HPL-MxP `factor_dtype=bfloat16, refine=2` plan), factored by the batched
blocked factor; against the JAX plans of the same key on the same seeded
numpy inputs (factors, solves, checked verdicts and the factor lane)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import serve as jserve
from conflux_tpu.ops import blas as jblas
from conflux_tpu.resilience import HealthPolicy
from conflux_tpu_torch import serve
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels

N, V = 64, 16


@pytest.fixture
def library_route():
    ja = jblas.get_panel_algo()
    jblas.set_panel_algo("auto")
    tblas.set_panel_algo("auto")
    yield
    tblas.set_panel_algo("kernel")
    jblas.set_panel_algo(ja)


def _gen(rng, b, n=N, dtype=np.float32):
    return (rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(dtype)


def _spd(rng, b, n=N, dtype=np.float32):
    M = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    return (np.einsum("bij,bkj->bik", M, M) + np.eye(n)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _plans(shape, dtype, **kw):
    serve.clear_plans()
    jserve.clear_plans()
    jd = {np.float32: jnp.float32, np.float64: jnp.float64}[dtype]
    jkw = dict(kw)
    tkw = dict(kw)
    if "factor_dtype" in kw:
        jkw["factor_dtype"] = {torch.bfloat16: jnp.bfloat16,
                               torch.float64: jnp.float64}[kw["factor_dtype"]]
    jp = jserve.FactorPlan.create(shape, jd, v=V, backend="xla", **jkw)
    tp = serve.FactorPlan.create(shape, dtype, v=V, backend="xla", **tkw)
    return jp, tp


CASES = [  # (kind, dtype, extra plan options, tolerance on x)
    ("lu", np.float32, {}, 2e-4),
    ("lu", np.float64, {}, 1e-10),
    ("chol", np.float32, {}, 2e-4),
    ("chol", np.float64, {}, 1e-10),
    ("lu", np.float32, {"factor_dtype": torch.float64}, 1e-5),
    ("chol", np.float32, {"factor_dtype": torch.float64}, 1e-5),
    ("lu", np.float32, {"factor_dtype": torch.bfloat16, "refine": 2}, 1e-4),
    ("chol", np.float32, {"factor_dtype": torch.bfloat16, "refine": 2}, 1e-4),
]


@pytest.mark.parametrize("kind,dtype,kw,tol", CASES)
@pytest.mark.parametrize("substitution", ["blocked", "trsm"])
def test_xla_plans_match_the_jax_plan(library_route, kind, dtype, kw, tol, substitution):
    jp, tp = _plans((N, N), dtype, kind=kind, substitution=substitution, **kw)
    assert tp.key.backend == "xla" and not tp._kernel_factor
    rng = np.random.default_rng(7)
    A = (_spd if kind == "chol" else _gen)(rng, 1, dtype=dtype)[0]
    b = rng.standard_normal((N, 2)).astype(dtype)
    s = tp.factor(A, device="cpu")
    js = jp.factor(jnp.asarray(A))
    if kind == "lu":  # equal pivots: LAPACK's getrf on both sides
        np.testing.assert_array_equal(s.factors[-1].numpy(), np.asarray(js.factors[-1]))
    f_t, f_j = s.factors[0], js.factors[0]
    np.testing.assert_allclose(f_t.float().numpy(), np.asarray(f_j.astype(jnp.float32)),
                               rtol=1e-2 if "factor_dtype" in kw else tol,
                               atol=1e-2 if "factor_dtype" in kw else tol)
    x = s.solve(b)
    xj = np.asarray(js.solve(jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), xj, rtol=tol, atol=tol)
    assert np.abs(A @ x.numpy() - b).max() < (1e-4 if dtype == np.float32 else 1e-10)
    xc, v = s.solve_checked(b)
    xcj, vj = js.solve_checked(jnp.asarray(b))
    np.testing.assert_allclose(xc.numpy(), np.asarray(xcj), rtol=tol, atol=tol)
    limit = HealthPolicy().resolved_residual_limit(dtype, N)
    assert float(v[0]) == float(np.asarray(vj)[0]) == 1.0
    assert float(v[1]) <= limit and float(np.asarray(vj)[1]) <= limit


@pytest.mark.parametrize("kind", ["lu", "chol"])
def test_xla_factor_lane_verdicts_agree_with_jax_and_trip_alone(library_route, kind):
    jp, tp = _plans((N, N), np.float32, kind=kind)
    rng = np.random.default_rng(59)
    A = (_spd if kind == "chol" else _gen)(rng, 4)
    bad = A.copy()
    if kind == "chol":
        bad[2, 5, 5] = -1e3  # not positive definite: its slot comes out NaN
    else:
        bad[2, :, 5] = 0.0  # exactly singular
    limit = HealthPolicy().resolved_residual_limit(np.float32, N)
    for X in (A, bad):
        F, wA, vt = tp._factor_health_fn(4)(_t(X))
        Fj, wAj, vj = jp._factor_health_fn(4)(jnp.asarray(X))
        vt, vj = vt.numpy(), np.asarray(vj)
        np.testing.assert_array_equal(vt[0], vj[0])
        np.testing.assert_array_equal((vt[0] >= 0.5) & (vt[1] <= limit),
                                      (vj[0] >= 0.5) & (vj[1] <= limit))
        np.testing.assert_allclose(wA.numpy(), np.asarray(wAj), rtol=1e-5, atol=1e-5)
    assert (vt[0] >= 0.5)[[0, 1, 3]].all() and not ((vt[0] >= 0.5) & (vt[1] <= limit))[2]
    if kind == "chol":  # the slot's factor NaN where the JAX one is
        assert bool(torch.isnan(F[0][2]).any())
        np.testing.assert_array_equal(np.isnan(F[0][2].numpy()), np.isnan(np.asarray(Fj[0][2])))


def test_kernel_plan_with_bf16_factors_refines_to_the_jax_answer():
    """The HPL-MxP plan on the kernel route (K2 panels and K1 updates on
    the bf16 factor; plain versions here): after 2 sweeps its answers
    agree with the JAX xla plan of the same options and hold the f32
    bar."""
    n, v = 256, 128
    serve.clear_plans()
    jserve.clear_plans()
    tp = serve.FactorPlan.create((2, n, n), torch.float32, v=v, factor_dtype=torch.bfloat16,
                                 refine=2)
    jp = jserve.FactorPlan.create((2, n, n), jnp.float32, v=v, factor_dtype=jnp.bfloat16,
                                  refine=2, backend="xla")
    assert tp.key.backend == "kernel" and tp.key.panel_algo == "kernel"
    rng = np.random.default_rng(71)
    A = _gen(rng, 2, n)
    b = rng.standard_normal((2, n)).astype(np.float32)
    hopper_kernels.reset_launches()
    s = tp.factor(A, device="cpu")
    assert s.factors[0].dtype == torch.bfloat16
    x = s.solve(b).numpy()
    assert all(c == 0 for c in hopper_kernels.LAUNCHES.values())  # plain versions on the CPU
    xj = np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=1e-4, atol=1e-4)
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-4
    xc, verdict = s.solve_checked(b)
    assert float(verdict[0]) == 1.0 and float(verdict[1]) < 1e-4


def test_bf16_storage_plan_matches_jax(library_route):
    serve.clear_plans()
    jserve.clear_plans()
    tp = serve.FactorPlan.create((N, N), torch.bfloat16, v=V, backend="xla", refine=1)
    jp = jserve.FactorPlan.create((N, N), jnp.bfloat16, v=V, backend="xla", refine=1)
    rng = np.random.default_rng(73)
    A = torch.from_numpy(_gen(rng, 1)[0]).bfloat16()
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).bfloat16()
    x = tp.factor(A, device="cpu").solve(b)
    xj = np.asarray(jp.factor(jnp.asarray(A.float().numpy()).astype(jnp.bfloat16)).solve(
        jnp.asarray(b.float().numpy()).astype(jnp.bfloat16)))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-3, atol=1e-3)


def test_session_from_numpy_takes_the_jax_bf16_factors(library_route):
    jp, tp = _plans((N, N), np.float32, factor_dtype=torch.bfloat16, refine=2)
    rng = np.random.default_rng(79)
    A = _gen(rng, 1)[0]
    b = rng.standard_normal(N).astype(np.float32)
    js = jp.factor(jnp.asarray(A))
    s = serve.session_from_numpy(tp, [np.asarray(f) for f in js.factors], A, device="cpu")
    assert s.factors[0].dtype == torch.bfloat16
    assert np.array_equal(s.factors[0].float().numpy(),
                          np.asarray(js.factors[0].astype(jnp.float32)))
    np.testing.assert_allclose(s.solve(b).numpy(), np.asarray(js.solve(jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)


def test_batched_xla_plan_stacks_and_folds(library_route):
    jp, tp = _plans((3, N, N), np.float64)
    rng = np.random.default_rng(83)
    A = _gen(rng, 2 * 3, dtype=np.float64).reshape(2, 3, N, N)
    F, wA, v = tp._factor_health_fn(2)(_t(A))
    assert tuple(F[0].shape) == (2, 3, N, N) and tuple(v.shape) == (2, 2)
    s = tp.factor(A[1], device="cpu")
    for got, ref in zip(F, s.factors):
        np.testing.assert_allclose(got[1].numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    b = rng.standard_normal((3, N))
    np.testing.assert_allclose(s.solve(b).numpy(),
                               np.asarray(jp.factor(jnp.asarray(A[1])).solve(jnp.asarray(b))),
                               rtol=1e-10, atol=1e-10)


def test_plan_routes_refuse_what_their_kernels_do_not_take(library_route):
    serve.clear_plans()
    with pytest.raises(ValueError, match="backend 'xla'"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, factor_dtype=torch.float64)
    tblas.set_panel_algo("kernel")
    with pytest.raises(ValueError, match="panel algo 'kernel'"):
        serve.FactorPlan.create((N, N), torch.float64, v=V, backend="xla")
    tblas.set_panel_algo("auto")
    p = serve.FactorPlan.create((N, N), torch.float32, v=V, backend="xla")
    assert p.key.backend == "xla"
    with pytest.raises(ValueError, match="unknown backend"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, backend="pallas")
