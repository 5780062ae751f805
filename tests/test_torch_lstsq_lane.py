"""QR-backed least-squares sessions of the port (`serve` kind='qr') on the
CPU, beside JAX sessions on the same seeded numpy inputs (the session
cases of tests/test_lstsq_lane.py): solves, the (u, uA) checked verdict
and its trip on corrupted factors, the factor lane's checked program,
the refinement rung, and the refusals (Woodbury updates, batched and wide
shapes).

Tolerances: float32 answers allclose rtol 1e-5 / atol 1e-5 to the JAX
session's, float64 rtol 1e-12; the numpy oracle within the JAX test's 1e-4
(float32). Bits are held only between port paths.
"""

import numpy as np
import pytest
import torch

from conflux_tpu import serve as jserve
from conflux_tpu_torch import serve

M, N = 512, 256


def _lstsq_system(m=M, n=N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)).astype(dtype), rng.standard_normal(m).astype(dtype))


def _oracle(A, b):
    return np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64), rcond=None)[0]


def _plans(dtype=np.float32, **kw):
    serve.clear_plans()
    jserve.clear_plans()
    return (jserve.FactorPlan.create((M, N), dtype, kind="qr", **kw),
            serve.FactorPlan.create((M, N), torch.float32 if dtype == np.float32
                                    else torch.float64, kind="qr", **kw))


@pytest.mark.parametrize("dtype,tol", [(np.float32, dict(rtol=1e-5, atol=1e-5)),
                                       (np.float64, dict(rtol=1e-12, atol=1e-12))])
def test_qr_session_solves_least_squares_like_jax(dtype, tol):
    A, b = _lstsq_system(dtype=dtype)
    jp, tp = _plans(dtype)
    assert tp.key.kind == "qr" and tp.key.substitution == "trsm"
    assert tp.M == M and tp.N == N and not tp._kernel_factor
    s = tp.factor(A, device="cpu")
    js = jp.factor(A)
    x = s.solve(b)
    assert tuple(x.shape) == (N,)
    assert np.abs(x.numpy().astype(np.float64) - _oracle(A, b)).max() < 1e-4
    np.testing.assert_allclose(x.numpy(), np.asarray(js.solve(b)), **tol)
    B2 = np.random.default_rng(1).standard_normal((M, 3)).astype(dtype)
    X = s.solve(B2)
    assert tuple(X.shape) == (N, 3)
    for j in range(3):
        assert np.abs(X[:, j].numpy().astype(np.float64) - _oracle(A, B2[:, j])).max() < 1e-4
    np.testing.assert_allclose(X.numpy(), np.asarray(js.solve(B2)), **tol)
    with pytest.raises(ValueError, match=str(M)):
        s.solve(b[:N])
    Q, R = s.factors
    assert tuple(Q.shape) == (M, N) and tuple(R.shape) == (N, N)


def test_qr_checked_verdict_trips_on_corruption():
    A, b = _lstsq_system(seed=2)
    jp, tp = _plans()
    s = tp.factor(A, device="cpu")
    x, v = s.solve_checked(b)
    _xj, vj = jp.factor(A).solve_checked(b)
    assert torch.equal(x, s.solve(b))
    assert float(v[0]) == 1.0 and float(v[1]) < 1e-4
    assert float(np.asarray(vj)[0]) == 1.0 and float(np.asarray(vj)[1]) < 1e-4
    u, uA = s._probe
    assert abs(float(torch.linalg.norm(u)) - np.sqrt(M)) < 1e-2
    # a corrupted R (its upper-right block lost, as a dropped trailing
    # update would leave it): finite, but a residual past the JAX
    # HealthPolicy's default limit 1e4 eps sqrt(N)
    Q, R = s.factors
    R2 = R.clone()
    R2[:N // 2, N // 2:] = 0
    with s._lock:
        s._factors = (Q, R2)
    _x, bad = s.solve_checked(b)
    limit = 1e4 * np.finfo(np.float32).eps * np.sqrt(N)
    assert float(bad[0]) == 1.0 and float(bad[1]) > limit
    # NaN factors: the finite flag trips
    with s._lock:
        s._factors = tuple(f * float("nan") for f in s._factors)
    _x, nan = s.solve_checked(b)
    assert float(nan[0]) == 0.0
    # rung 1 rebuilds the factors from the base, rung 2 refines and re-checks
    s.refactor()
    x2, v2 = s.refine_checked(b, s.solve(b))
    assert float(v2[0]) == 1.0 and float(v2[1]) < 1e-4
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=1e-4, atol=1e-4)
    assert tp.trace_counts["refine"] == 1


def test_qr_factor_lane_is_bucket_invariant_and_checked():
    """The factor lane's checked program of a QR plan: per-slot (u, uA)
    probes and verdicts, each slot's factors bitwise `plan.factor`'s; a
    NaN slot trips alone, as the JAX lane's does."""
    rng = np.random.default_rng(3)
    As = rng.standard_normal((4, M, N)).astype(np.float32)
    jp, tp = _plans()
    F, (u, uA), verdict = tp._factor_health_fn(4)(torch.from_numpy(As))
    jF, (ju, juA), jv = jp._factor_health_fn(4)(As)
    assert tuple(verdict.shape) == (2, 4)
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-4
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(verdict.numpy()[0], np.asarray(jv)[0])
    s = tp.factor(As[2], device="cpu")
    assert all(torch.equal(f[2], g) for f, g in zip(F, s.factors))
    F1 = tp._stacked_factor_fn(1)(torch.from_numpy(As[2:3]))
    assert all(torch.equal(f[0], g) for f, g in zip(F1, s.factors))
    bad = As.copy()
    bad[1, 5, 7] = np.nan
    _F, _p, vb = tp._factor_health_fn(4)(torch.from_numpy(bad))
    assert vb[0].tolist() == [1.0, 0.0, 1.0, 1.0]
    assert tp.trace_counts["factor_health"] == 1


def test_qr_plan_tiers_and_refine():
    """A QR plan's served tiers factor at the tier's dtype (no kernel, no
    route change), and its `refine` sweeps refine the least-squares
    answer."""
    A, b = _lstsq_system(seed=4)
    jp, tp = _plans(refine=1)
    s = tp.factor(A, device="cpu")
    x = s.solve(b)
    np.testing.assert_allclose(x.numpy(), np.asarray(jp.factor(A).solve(b)), rtol=1e-5,
                               atol=1e-5)
    x64 = s.solve(b, precision="f64")
    assert s._tier_factors["f64"][0].dtype == torch.float64
    assert np.abs(x64.numpy() - _oracle(A, b)).max() < 1e-5
    tb = tp.factor(A, device="cpu", precision="bf16_ir")
    assert tb.factors[0].dtype == torch.bfloat16 and tb.nbytes < s.nbytes
    assert np.abs(tb.solve(b).numpy() - _oracle(A, b)).max() < 1e-2


def test_qr_sessions_reject_woodbury_updates():
    A, _b = _lstsq_system(seed=3)
    _jp, tp = _plans()
    s = tp.factor(A, device="cpu")
    with pytest.raises(ValueError, match="qr"):
        s.update(np.zeros((M, 1), np.float32), np.zeros((N, 1), np.float32))


@pytest.mark.parametrize("shape,kw", [((4, M, N), {}), ((N, M), {}),
                                      ((M, N), {"substitution": "blocked"})])
def test_qr_rejects_batched_wide_and_square_engines(shape, kw):
    serve.clear_plans()
    with pytest.raises(ValueError):
        serve.FactorPlan.create(shape, torch.float32, kind="qr", **kw)
