"""The port's served precision ladder (`serve.PRECISION_TIERS`, `factor`/
`solve`/`solve_checked` with `precision=`) and the escalation rungs of its
`resilience` copy on the CPU, beside the JAX package's on the same seeded
numpy inputs (the setups of tests/test_precision.py).

Tolerances: float32 and float64 tiers allclose rtol 1e-5 / atol 1e-5 to
the JAX answer (both answer in the plan's float32); the bf16_ir tier is
held to the JAX test's residual bar (1e-2: bfloat16 factors and one
sweep), as the two packages' bfloat16 factors round differently. Bits are
held only between port paths.
"""

import numpy as np
import pytest
import torch

from conflux_tpu import resilience as jres
from conflux_tpu import serve as jserve
from conflux_tpu_torch import resilience as tres
from conflux_tpu_torch import serve

N, V = 256, 256
F32 = dict(rtol=1e-5, atol=1e-5)


def _system(n=N, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return A, b


def _ill_conditioned(n=N, seed=3, cond=1e6):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sv = np.logspace(0, -np.log10(cond), n)
    return ((U * sv) @ U.T).astype(np.float32)


def _resid(A, x, b):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(A.astype(np.float64) @ x - b) / np.linalg.norm(b)


def _plans(shape=(N, N), **kw):
    serve.clear_plans()
    jserve.clear_plans()
    return (jserve.FactorPlan.create(shape, np.float32, v=V, **kw),
            serve.FactorPlan.create(shape, torch.float32, v=V, **kw))


def test_precision_request_validation_and_ladder_match_jax():
    assert serve.PRECISION_TIERS == jserve.PRECISION_TIERS
    for ok in (None, "auto") + serve.PRECISION_TIERS:
        assert serve.check_precision_request(ok) == ok
    for bad in ("fp8", 16):
        with pytest.raises(ValueError, match=str(bad)):
            serve.check_precision_request(bad)
    for t in serve.PRECISION_TIERS:
        assert serve.next_precision_tier(t) == jserve.next_precision_tier(t)
    assert serve.next_precision_tier("f64") is None


@pytest.mark.parametrize("plan_kw,tier,route", [
    ({}, "bf16_ir", (torch.bfloat16, "kernel", "kernel")),
    ({}, "f32", (torch.float32, "kernel", "kernel")),
    ({}, "f64", (torch.float64, "xla", "auto")),
    ({"kind": "chol"}, "f64", (torch.float64, "xla", "auto")),
    ({"backend": "xla"}, "f64", (torch.float64, "xla", "kernel")),
    ({"dtype": torch.float64}, "f64", (torch.float64, "kernel", "kernel")),
])
def test_tier_routes_by_dtype(plan_kw, tier, route):
    """A tier factors on the plan's own route where that route takes its
    dtype; K1 and K2 have no float64 instance, so a float64 tier outside
    the K4/K5 gate takes the library route ("xla", and "auto" for the
    registry's "kernel" panel algo). A float64 plan's f64 tier is its K4
    factor."""
    kw = dict(plan_kw)
    dtype = kw.pop("dtype", torch.float32)
    serve.clear_plans()
    plan = serve.FactorPlan.create((N, N), dtype, v=V, refine=1, **kw)
    fd, sweeps, got = plan._tier_spec(tier)
    assert got == route and fd == route[0]
    assert sweeps == 1
    assert plan._kernel_gate(fd, got[1]) == (fd == dtype and got[1] == "kernel")
    with pytest.raises(ValueError, match="served tier"):
        plan._tier_spec("fp8")


def test_f32_tier_of_a_kernel_plan_is_the_native_factor():
    """`_tier_factor_once('f32')` of a kernel-route float32 plan rides K4,
    as the native factor does: the same bits."""
    A, b = _system(seed=7)
    _jp, tp = _plans(refine=1)
    At = torch.from_numpy(A)
    native = tp._factor_once(At)
    tier = tp._tier_factor_once("f32", At)
    assert all(torch.equal(x, y) for x, y in zip(native, tier))
    s = tp.factor(A, device="cpu")
    assert torch.equal(s.solve(b, precision="f32"), s.solve(b))


def test_default_precision_bitwise_and_tier_routing_like_jax():
    A, b = _system(seed=1)
    jp, tp = _plans(refine=1)
    s = tp.factor(A, device="cpu")
    js = jp.factor(A)
    x0 = s.solve(b)
    assert torch.equal(x0, s.solve(b, precision=None))
    assert s.served_tier is None
    for tier in ("f32", "f64"):
        x = s.solve(b, precision=tier)
        assert x.dtype == torch.float32 and _resid(A, x, b) < 1e-5
        np.testing.assert_allclose(x.numpy(), np.asarray(js.solve(b, precision=tier)), **F32)
    xb = s.solve(b, precision="bf16_ir")
    assert _resid(A, xb, b) < 1e-2 and _resid(A, np.asarray(js.solve(b, precision="bf16_ir")),
                                              b) < 1e-2
    assert s._tier_factors["bf16_ir"][0].dtype == torch.bfloat16
    assert s._tier_factors["f64"][1].dtype == torch.float64  # K3's float64 Dinv
    with pytest.raises(ValueError, match="fp8"):
        s.solve(b, precision="fp8")
    # each tier program once per bucket: solve and solve_checked
    t = dict(tp.trace_counts)
    for tier in ("bf16_ir", "f32", "f64"):
        s.solve(b, precision=tier)
    assert tp.trace_counts == t
    for tier in ("bf16_ir", "f32", "f64"):
        x, v = s.solve_checked(b, precision=tier)
        assert torch.equal(x, s.solve(b, precision=tier))
        assert float(v[0]) == 1.0
    assert tp.trace_counts["health"] == t.get("health", 0) + 3


def test_factor_at_tier_opens_smaller_session():
    A, b = _system(seed=2)
    jp, tp = _plans(refine=1)
    native = tp.factor(A, device="cpu")
    tiered = tp.factor(A, device="cpu", precision="bf16_ir")
    jtiered = jp.factor(A, precision="bf16_ir")
    assert native.served_tier is None and tiered.served_tier == "bf16_ir"
    assert tiered.factors[0].dtype == torch.bfloat16
    assert tiered.nbytes < 0.85 * native.nbytes
    assert tiered.nbytes / native.nbytes == pytest.approx(jtiered.nbytes / jp.factor(A).nbytes,
                                                          rel=0.05)
    assert _resid(A, tiered.solve(b), b) < 1e-2
    xf = tiered.solve(b, precision="f32")
    assert torch.equal(xf, native.solve(b, precision="f32"))
    np.testing.assert_allclose(xf.numpy(), np.asarray(jtiered.solve(b, precision="f32")), **F32)
    auto = tp.factor(A, device="cpu", precision="auto")
    assert auto.served_tier == "bf16_ir" and auto.auto_rung == 0


def test_drifted_session_cross_tier_falls_back_counted():
    A, b = _system(seed=4)
    rng = np.random.default_rng(4)
    jp, tp = _plans(refine=1)
    u = (rng.standard_normal((N, 1)) * 0.01).astype(np.float32)
    v = (rng.standard_normal((N, 1)) * 0.01).astype(np.float32)
    s = tp.factor(A, device="cpu").update(u, v)
    js = jp.factor(A).update(u, v)
    A1 = A + u @ v.T
    x = s.solve(b, precision="bf16_ir")
    assert _resid(A1, x, b) < 1e-4
    assert s.precision_fallbacks == 1
    np.testing.assert_allclose(x.numpy(), np.asarray(js.solve(b, precision="bf16_ir")), **F32)
    _x, verdict = s.solve_checked(b, precision="f64")
    assert s.precision_fallbacks == 2 and float(verdict[0]) == 1.0
    assert "bf16_ir" not in s._tier_factors


def test_tier_session_refactors_at_its_tier():
    """A tier session's refactors (rung 1 and the drift policy's) rebuild
    its factors at its own tier, never the native dtype."""
    A, b = _system(seed=5)
    _jp, tp = _plans(refine=1)
    s = tp.factor(A, device="cpu", precision="bf16_ir")
    s.refactor()
    assert s.factors[0].dtype == torch.bfloat16 and s.refactors == 1
    rng = np.random.default_rng(5)
    u = (rng.standard_normal((N, 2)) * 0.01).astype(np.float32)
    s.update(u, u)
    x = s.solve(b)
    assert _resid(A + u @ u.T, x, b) < 1e-2
    s.refactor()
    assert s.factors[0].dtype == torch.bfloat16 and s.update_rank == 0
    assert _resid(A + u @ u.T, s.solve(b), b) < 1e-2


def test_escalate_precision_ladder_direct():
    """bf16 verdict evidence on an ill-conditioned system -> the ladder
    climbs to f32 (the JAX test's recipe), the 'auto' rung sticks, the
    evidence chain carries the tier rung; the JAX ladder does the same."""
    Abad = _ill_conditioned(seed=10)
    b = np.random.default_rng(10).standard_normal(N).astype(np.float32)
    jp, tp = _plans(refine=1)
    s = tp.factor(Abad, device="cpu")
    js = jp.factor(Abad)
    x, verdict = s.solve_checked(b, precision="auto")
    finite, res = float(verdict[0]), float(verdict[1])
    pol = tres.HealthPolicy()
    limit = pol.resolved_residual_limit(np.dtype(np.float32), N)
    assert limit == jres.HealthPolicy().resolved_residual_limit(np.dtype(np.float32), N)
    assert res > limit
    ok, fin, r = tres.evaluate(verdict, limit)
    assert (ok, fin, r) == (False, finite == 1.0, res)
    out = tres.escalate_precision(s, b[:, None], "auto", pol, limit,
                                  evidence0={"rung": "bf16_ir", "finite": finite,
                                             "residual": res})
    jout = jres.escalate_precision(js, b[:, None], "auto", jres.HealthPolicy(), limit,
                                   evidence0={"rung": "bf16_ir", "finite": finite,
                                              "residual": res})
    assert isinstance(out, np.ndarray) and _resid(Abad, out[..., 0], b) < 1e-2
    assert s.auto_rung == js.auto_rung >= 1
    assert s.precision_escalations == js.precision_escalations >= 1
    # cond 1e6 in float32: the two answers agree only as far as the
    # conditioning lets them; both meet the JAX test's residual bar
    assert _resid(Abad, np.asarray(jout)[..., 0], b) < 1e-2
    # the rung sticks: the next auto request starts at f32
    x2, v2 = s.solve_checked(b, precision="auto")
    assert float(v2[1]) <= limit and torch.equal(x2, s.solve(b, precision="f32"))


def test_escalate_falls_through_to_native_rungs_with_evidence():
    """With every verdict forced unhealthy (a FaultPlan at the 'solve'
    site), the ladder climbs the tiers, then runs refactor and refine and
    raises SolveUnhealthy carrying each rung, as the JAX ladder does."""
    Abad = _ill_conditioned(seed=11)
    b = np.random.default_rng(11).standard_normal(N).astype(np.float32)
    _jp, tp = _plans(refine=1)
    s = tp.factor(Abad, device="cpu")
    pol = tres.HealthPolicy()
    faults = tres.FaultPlan([tres.FaultSpec("solve", "unhealthy")])
    before = tres.health_stats()
    with pytest.raises(tres.SolveUnhealthy) as e:
        tres.escalate_precision(s, b[:, None], "bf16_ir", pol, 1.0, faults=faults)
    rungs = [r["rung"] for r in e.value.evidence["rungs"]]
    assert rungs == ["precision:f32", "precision:f64", "refactor", "refine"]
    after = tres.health_stats()
    assert after["precision_escalations"] == before.get("precision_escalations", 0) + 2
    assert after["unhealthy"] == before["unhealthy"] + 1
    assert s.auto_rung == 0  # explicit tiers climb without moving the rung
    assert faults.injected[("solve", "unhealthy")] == 4
