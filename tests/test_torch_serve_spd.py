"""The port's SPD serving plans (`conflux_tpu_torch.serve`, kind="chol") on
the CPU, against a JAX plan made with backend="pallas" and kind="chol" on
the same seeded numpy inputs; and the port's own contracts: `plan.factor`
bitwise the checked coalesced bucket, a non-SPD slot failing alone.

Bars: factors agree to rtol 1e-5, atol 1e-6; solves hold the JAX serve
tests' bar (tests/test_serve.py: each system's relative residual within
4x that of the one-shot `solvers.solve(..., spd=True)`, or 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import serve as jserve
from conflux_tpu.resilience import HealthPolicy
from conflux_tpu.solvers import solve as jsolve
from conflux_tpu_torch import serve
from conflux_tpu_torch.ops import hopper_kernels
from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

N, V = 64, 16


def _spd(rng, b, n=N, dtype=np.float32):
    """The JAX serve tests' SPD class: M M^T + I, M = normal / sqrt(n) + 2 I."""
    M = (rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(np.float32)
    return (np.einsum("bij,bkj->bik", M, M) + np.eye(n, dtype=np.float32)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _plans(shape=(N, N), dtype=np.float32, **kw):
    serve.clear_plans()
    jserve.clear_plans()
    jp = jserve.FactorPlan.create(shape, dtype, v=V, backend="pallas", kind="chol", **kw)
    tp = serve.FactorPlan.create(shape, dtype, v=V, kind="chol", **kw)
    return jp, tp


def _residuals(A, x, b):
    r = np.einsum("bij,bj->bi", A.astype(np.float64), np.asarray(x, np.float64)) \
        - b.astype(np.float64)
    return np.linalg.norm(r, axis=1) / np.linalg.norm(b.astype(np.float64), axis=1)


def _hold_the_jax_bar(A, x, b):
    bars = _residuals(A, np.stack([np.asarray(jsolve(jnp.asarray(A[i]), jnp.asarray(b[i]),
                                                     v=V, spd=True))
                                   for i in range(A.shape[0])]), b)
    res = _residuals(A, x, b)
    assert (res <= np.maximum(4 * bars, 1e-6)).all(), (res, bars)


def test_spd_spelling_and_kind_agree():
    serve.clear_plans()
    p = serve.FactorPlan.create((N, N), torch.float32, v=V, spd=True)
    assert p.key.kind == "chol" and p._kernel_factor and p.key.substitution == "blocked"
    assert serve.FactorPlan.create((N, N), torch.float32, v=V, kind="chol") is p
    with pytest.raises(ValueError, match="contradicts"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, kind="lu", spd=True)


@pytest.mark.parametrize("substitution", ["blocked", "trsm", "inv"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_spd_solves_hold_the_jax_bar(substitution, batched):
    Bp = 4
    shape = (Bp, N, N) if batched else (N, N)
    jp, tp = _plans(shape, substitution=substitution)
    rng = np.random.default_rng(7 + batched)
    A = _spd(rng, Bp)
    b = rng.standard_normal((Bp, N)).astype(np.float32)
    if batched:
        x = tp.factor(A, device="cpu").solve(b).numpy()
        xj = np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b)))
    else:
        x = np.stack([tp.factor(A[i], device="cpu").solve(b[i]).numpy() for i in range(Bp)])
        xj = np.stack([np.asarray(jp.factor(jnp.asarray(A[i])).solve(jnp.asarray(b[i])))
                       for i in range(Bp)])
    _hold_the_jax_bar(A, x, b)
    np.testing.assert_allclose(x, xj, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("substitution", ["blocked", "trsm", "inv"])
def test_spd_factors_match_the_jax_pallas_plan(substitution):
    jp, tp = _plans(substitution=substitution)
    A = _spd(np.random.default_rng(41), 1)[0]
    jf = jp.factor(jnp.asarray(A)).factors
    tf = tp.factor(A, device="cpu").factors
    assert len(jf) == len(tf) == {"blocked": 2, "trsm": 1, "inv": 1}[substitution]
    for got, want in zip(tf, jf):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if substitution != "inv":
        assert not np.triu(tf[0].numpy(), 1).any()


def test_spd_float64_plan_matches_jax():
    jp, tp = _plans(dtype=np.float64)
    rng = np.random.default_rng(43)
    A = _spd(rng, 1, dtype=np.float64)[0]
    b = rng.standard_normal(N)
    s = tp.factor(A, device="cpu")
    assert s.factors[0].dtype == torch.float64
    js = jp.factor(jnp.asarray(A))
    np.testing.assert_allclose(s.factors[0].numpy(), np.asarray(js.factors[0]),
                               rtol=1e-12, atol=1e-13)
    x = s.solve(b).numpy()
    assert np.abs(A @ x - b).max() < 1e-12
    np.testing.assert_allclose(x, np.asarray(js.solve(jnp.asarray(b))), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("substitution", ["blocked", "trsm", "inv"])
def test_port_solves_on_jax_spd_factors(substitution):
    """`session_from_numpy` opens a port session on the JAX SPD session's
    own factor pytree (no permutation leaf to cast)."""
    jp, tp = _plans(substitution=substitution)
    rng = np.random.default_rng(37)
    A = _spd(rng, 1)[0]
    b = rng.standard_normal((N, 2)).astype(np.float32)
    js = jp.factor(jnp.asarray(A))
    leaves = [np.asarray(f) for f in js.factors]
    s = serve.session_from_numpy(tp, leaves, A, device="cpu")
    assert all(f.dtype == torch.float32 for f in s.factors)
    np.testing.assert_allclose(s.solve(b).numpy(), np.asarray(js.solve(jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="leaves"):
        serve.session_from_numpy(tp, leaves + leaves, A, device="cpu")


def test_spd_refine_plan_solves_and_checks():
    jp, tp = _plans(refine=2)
    rng = np.random.default_rng(47)
    A = _spd(rng, 1)[0]
    b = rng.standard_normal((N, 3)).astype(np.float32)
    s = tp.factor(A, device="cpu")
    assert s._A is not None and not tp._fused_probe
    x = s.solve(b).numpy()
    assert np.abs(A @ x - b).max() < 1e-4
    np.testing.assert_allclose(x, np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b))),
                               rtol=2e-4, atol=1e-5)
    xc, v = s.solve_checked(b)
    assert torch.equal(xc, s.solve(b)) and float(v[0]) == 1.0 and float(v[1]) < 1e-4


def test_spd_solve_checked_verdicts_agree_with_jax():
    jp, tp = _plans()
    rng = np.random.default_rng(53)
    A = _spd(rng, 1)[0]
    b = rng.standard_normal((N, 2)).astype(np.float32)
    s = tp.factor(A, device="cpu")
    js = jp.factor(jnp.asarray(A))
    bad = b.copy()
    bad[3, 1] = np.nan
    for rhs in (b, bad):
        x, v = s.solve_checked(rhs)
        xj, vj = js.solve_checked(jnp.asarray(rhs))
        vj = np.asarray(vj)
        assert float(v[0]) == float(vj[0])
    x, v = s.solve_checked(b)
    assert float(v[0]) == 1.0 and float(v[1]) < 1e-4 and torch.equal(x, s.solve(b))
    assert set(tp._trsm_cache) == {("health", 2)}


def test_spd_plan_factor_matches_checked_coalesced_bitwise():
    """The twin of the JAX lane's bitwise contract for chol plans: each
    slot of a checked coalesced bucket carries `plan.factor`'s bits."""
    _jp, tp = _plans()
    A = _spd(np.random.default_rng(59), 4)
    F, wA, verdict = tp._factor_health_fn(4)(_t(A))
    assert len(F) == 2 and tuple(verdict.shape) == (2, 4)
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-3
    for i in range(4):
        s = tp.factor(A[i], device="cpu")
        for got, ref in zip(F, s.factors):
            assert torch.equal(got[i], ref)
        np.testing.assert_allclose(wA[i].numpy(), s._probe_row().numpy(),
                                   rtol=1e-5, atol=1e-4)
    F1 = tp._stacked_factor_fn(1)(_t(A[:1]))
    for l1, l4 in zip(F1, F):
        assert torch.equal(l1[0], l4[0])
    assert torch.equal(F[1][2], diag_block_inverses(F[0][2], lower=True))


@pytest.mark.parametrize("substitution", ["blocked", "trsm"])
def test_spd_factor_health_verdict_agrees_with_jax_and_trips_alone(substitution):
    jp, tp = _plans(substitution=substitution)
    rng = np.random.default_rng(61)
    A = _spd(rng, 4)
    limit = HealthPolicy().resolved_residual_limit(np.float32, N)
    bad = A.copy()
    bad[1] = -bad[1]  # not positive definite
    for X in (A, bad):
        vt = tp._factor_health_fn(4)(_t(X))[2].numpy()
        vj = np.asarray(jp._factor_health_fn(4)(jnp.asarray(X))[2])
        np.testing.assert_array_equal(vt[0], vj[0])
        healthy_t = (vt[0] >= 0.5) & (vt[1] <= limit)
        healthy_j = (vj[0] >= 0.5) & (vj[1] <= limit)
        np.testing.assert_array_equal(healthy_t, healthy_j)
    assert not healthy_t[1] and healthy_t[[0, 2, 3]].all()
    Fc = tp._factor_health_fn(4)(_t(A))[0]
    Fb = tp._factor_health_fn(4)(_t(bad))[0]
    for lc, lb in zip(Fc, Fb):
        assert torch.equal(lc[[0, 2, 3]], lb[[0, 2, 3]])


def test_spd_batched_plan_folds_the_stack_into_one_kernel_batch():
    Bp = 4
    jp, tp = _plans(shape=(Bp, N, N))
    rng = np.random.default_rng(67)
    A = _spd(rng, Bp)
    s = tp.factor(A, device="cpu")
    Ast = np.stack([A, _spd(rng, Bp)])
    F, wA, verdict = tp._factor_health_fn(2)(_t(Ast))
    assert tuple(wA.shape) == (2, Bp, N) and tuple(verdict.shape) == (2, 2)
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-3
    for got, ref in zip(F, s.factors):
        assert torch.equal(got[0], ref)
    b = rng.standard_normal((Bp, N)).astype(np.float32)
    xc, v = s.solve_checked(b)
    xj, vj = jp.factor(jnp.asarray(A)).solve_checked(jnp.asarray(b))
    assert float(v[0]) == float(np.asarray(vj)[0]) == 1.0 and float(v[1]) < 1e-4
    np.testing.assert_allclose(xc.numpy(), np.asarray(xj), rtol=2e-4, atol=1e-5)


def test_spd_cpu_serving_runs_no_kernel():
    _jp, tp = _plans()
    rng = np.random.default_rng(83)
    before = dict(hopper_kernels.LAUNCHES)
    s = tp.factor(_spd(rng, 1)[0], device="cpu")
    s.solve_checked(rng.standard_normal(N).astype(np.float32))
    assert hopper_kernels.LAUNCHES == before
    assert s.nbytes == sum(t.numel() * t.element_size()
                           for t in (*s.factors, s._A0, s._probe))
