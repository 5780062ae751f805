"""The port's serving core (`conflux_tpu_torch.serve`) on the CPU, against a
JAX plan made with backend="pallas" (the plan family the port's kernel
plans are the counterpart of), on the same seeded numpy inputs; and the
port's own contracts: bucket/pad bitwise invariance of the factor lane,
`plan.factor` bitwise the coalesced bucket, programs built once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import serve as jserve
from conflux_tpu.resilience import HealthPolicy
from conflux_tpu_torch import serve
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels
from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

N, V = 64, 16


def _gen(rng, b, n=N, dtype=np.float32):
    return (rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _plans(shape=(N, N), **kw):
    serve.clear_plans()
    jserve.clear_plans()
    jp = jserve.FactorPlan.create(shape, jnp.float32, v=V, backend="pallas", **kw)
    tp = serve.FactorPlan.create(shape, torch.float32, v=V, **kw)
    return jp, tp


def test_auto_resolves_to_blocked_and_explicit_substitutions_stay():
    serve.clear_plans()
    single = serve.FactorPlan.create((N, N), torch.float32, v=V)
    batched = serve.FactorPlan.create((4, N, N), np.float32, v=V)
    assert single.key.substitution == "blocked" == batched.key.substitution
    assert single.key.backend == "kernel" and single._kernel_factor
    assert serve.FactorPlan.create((N, N), "float32", v=V) is single
    for sub in ("inv", "trsm", "blocked"):
        p = serve.FactorPlan.create((N, N), torch.float32, v=V, substitution=sub)
        assert p.key.substitution == sub
    with pytest.raises(ValueError, match="substitution"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, substitution="nope")
    with pytest.raises(ValueError, match="multiple"):
        serve.FactorPlan.create((N, N), torch.float32, v=48)


@pytest.mark.parametrize("kw", [
    {"kind": "chol", "mesh": object()}, {"kind": "chol", "precision": "default"},
    {"kind": "qr", "mesh": object()}, {"mesh": object()},
    {"kind": "qr", "precision": "default"}, {"precision": "default"}])
def test_unported_plans_raise(kw):
    """A matmul precision other than the registry's is a plan of its own,
    as in the JAX package: the key and the record keep the name as given,
    and a kernel plan (K4/K5 and K3, which take no precision) factors and
    solves bitwise the HIGHEST plan, within the serving tolerance of the
    JAX plan at the same precision. Mesh plans: a `mesh=` that is not a
    `batch_mesh` is a type error, and a real mesh keeps the JAX package's
    refusals (QR plans, single-system plans, a batch the shard count does
    not divide)."""
    serve.clear_plans()
    if "mesh" not in kw:
        jp, tp = _plans(**kw)
        base = serve.FactorPlan.create((N, N), torch.float32, v=V, kind=kw.get("kind"))
        assert tp is not base and tp.key.precision == jp.key.precision == "default"
        assert tp.spec()["precision"] == jserve.plan_spec(jp)["precision"] == "default"
        assert serve.plan_from_spec(tp.spec()) is tp
        rng = np.random.default_rng(41)
        M = _gen(rng, 1)[0]
        A = M @ M.T + np.eye(N, dtype=np.float32) if kw.get("kind") == "chol" else M
        b = rng.standard_normal((N, 2)).astype(np.float32)
        x = tp.factor(A, device="cpu").solve(b)
        assert torch.equal(x, base.factor(A, device="cpu").solve(b))
        xj = np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b)))
        np.testing.assert_allclose(x.numpy(), xj, rtol=2e-4, atol=1e-5)
        return
    from conflux_tpu_torch.batched import batch_mesh

    with pytest.raises(TypeError, match="batch_mesh"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, **kw)
    real = {**kw, "mesh": batch_mesh(["cpu", "cpu"])}
    qr = kw.get("kind") == "qr"
    with pytest.raises(ValueError, match="unsharded" if qr else "batched"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, **real)
    if not qr:
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            serve.FactorPlan.create((3, N, N), torch.float32, v=V, **real)
        plan = serve.FactorPlan.create((4, N, N), torch.float32, v=V, **real)
        assert plan.mesh.size == 2 and plan.key.mesh_key == (
            (("cpu", 0), ("cpu", 0)), ("b",))


def test_unported_session_features_raise():
    """Every session feature is ported: the precision ladder, the Woodbury
    update, the codec, the bucket lifecycle and device moves
    (`test_torch_precision.py`, `test_torch_update.py`,
    `test_torch_stacked.py`), matmul precision (a JAX record naming
    DEFAULT decodes to the port's plan at DEFAULT) and mesh plans: a plan
    record naming a mesh round-trips to the same plan. A malformed
    precision payload still raises, naming it."""
    from conflux_tpu_torch.batched import batch_mesh

    _jp, tp = _plans()
    d = tp.spec()
    jd = jserve.plan_spec(jserve.FactorPlan.create((N, N), jnp.float32, v=V, backend="pallas",
                                                   precision=jax.lax.Precision.DEFAULT))
    assert jd["precision"] == ["precision", "DEFAULT"]
    low = serve.plan_from_spec({**d, "precision": jd["precision"]})
    assert low is not tp and low.key.precision is tblas.Precision.DEFAULT
    assert low is serve.FactorPlan.create((N, N), torch.float32, v=V,
                                          precision=tblas.Precision.DEFAULT)
    with pytest.raises(ValueError, match="malformed"):
        serve.plan_from_spec({**d, "precision": ["precision", "LOWEST"]})
    mp = serve.FactorPlan.create((4, N, N), torch.float32, v=V, mesh=batch_mesh(["cpu"]))
    md = mp.spec()
    assert md["mesh"] == {"device_ids": [0], "axis_names": ["b"], "device_shape": [1],
                          "platform": "cpu"}
    assert serve.plan_from_spec(md) is mp


@pytest.mark.parametrize("substitution", ["blocked", "trsm", "inv"])
def test_solves_hold_the_residual_bar_and_match_jax(substitution):
    jp, tp = _plans(substitution=substitution)
    rng = np.random.default_rng(31)
    A = _gen(rng, 1)[0]
    b = rng.standard_normal((N, 3)).astype(np.float32)
    s = tp.factor(A, device="cpu")
    x = s.solve(b).numpy()
    assert np.abs(A @ x - b).max() < 1e-4
    xj = np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=2e-4, atol=1e-5)
    # vector rhs and a width that pads to its bucket
    np.testing.assert_allclose(s.solve(b[:, 0]).numpy(), x[:, 0], rtol=1e-6, atol=1e-7)
    assert s.solves == 2 and s.factorizations == 1


@pytest.mark.parametrize("substitution", ["blocked", "trsm", "inv"])
def test_port_solves_on_jax_factors(substitution):
    """`session_from_numpy` opens a port session on the JAX session's own
    factor pytree: the port's solve programs then agree with the JAX
    session's answers to rtol 1e-5."""
    jp, tp = _plans(substitution=substitution)
    rng = np.random.default_rng(37)
    A = _gen(rng, 1)[0]
    b = rng.standard_normal((N, 2)).astype(np.float32)
    js = jp.factor(jnp.asarray(A))
    s = serve.session_from_numpy(tp, [np.asarray(f) for f in js.factors], A, device="cpu")
    np.testing.assert_allclose(s.solve(b).numpy(), np.asarray(js.solve(jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="leaves"):
        serve.session_from_numpy(tp, [np.asarray(f) for f in js.factors][:1], A,
                                 device="cpu")


def test_port_factors_match_the_jax_pallas_plan():
    jp, tp = _plans()
    rng = np.random.default_rng(41)
    A = _gen(rng, 1)[0]
    jf = jp.factor(jnp.asarray(A)).factors
    tf = tp.factor(A, device="cpu").factors
    assert len(jf) == len(tf) == 4
    np.testing.assert_array_equal(tf[3].numpy(), np.asarray(jf[3]))  # pivots
    for got, want in zip(tf[:3], jf[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_solve_checked_verdicts_and_program_cache():
    jp, tp = _plans()
    rng = np.random.default_rng(43)
    A = _gen(rng, 1)[0]
    b = rng.standard_normal((N, 2)).astype(np.float32)
    s = tp.factor(A, device="cpu")
    x, v = s.solve_checked(b)
    assert v.dtype == torch.float32 and tuple(v.shape) == (2,)
    assert float(v[0]) == 1.0 and float(v[1]) < 1e-4
    assert torch.equal(x, s.solve(b))
    xj, vj = jp.factor(jnp.asarray(A)).solve_checked(jnp.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=2e-4, atol=1e-5)
    assert float(np.asarray(vj)[0]) == 1.0
    bad = b.copy()
    bad[3, 1] = np.nan
    _x, vb = s.solve_checked(bad)
    assert float(vb[0]) == 0.0
    # the fused checked programs live in _trsm_cache, apart from _solve_cache
    assert set(tp._trsm_cache) == {("health", 2)}
    assert ("health", 2) not in tp._solve_cache
    np.testing.assert_allclose(s._probe_row().numpy(), np.asarray(jp.probe_w) @ A,
                               rtol=1e-5, atol=1e-5)
    assert s.nbytes == sum(t.numel() * t.element_size()
                           for t in (*s.factors, s._A0, s._probe))


def test_refine_plan_solves_and_checks():
    jp, tp = _plans(refine=2)
    rng = np.random.default_rng(47)
    A = _gen(rng, 1)[0]
    b = rng.standard_normal((N, 3)).astype(np.float32)
    s = tp.factor(A, device="cpu")
    assert s._A is not None and not tp._fused_probe
    x = s.solve(b).numpy()
    assert np.abs(A @ x - b).max() < 1e-5
    np.testing.assert_allclose(x, np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b))),
                               rtol=2e-4, atol=1e-5)
    xc, v = s.solve_checked(b)
    assert torch.equal(xc, s.solve(b)) and float(v[0]) == 1.0 and float(v[1]) < 1e-4
    assert ("health", 4) in tp._solve_cache and not tp._trsm_cache


def test_plan_factor_is_bitwise_the_checked_bucket():
    _jp, tp = _plans()
    rng = np.random.default_rng(53)
    A = _gen(rng, 4)
    F, wA, verdict = tp._factor_health_fn(4)(_t(A))
    assert tuple(verdict.shape) == (2, 4)
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-3
    for i in range(4):
        s = tp.factor(A[i], device="cpu")
        for got, ref in zip(F, s.factors):
            assert torch.equal(got[i], ref)
        np.testing.assert_allclose(wA[i].numpy(), s._probe_row().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_factor_health_verdict_agrees_with_jax_and_trips_alone():
    jp, tp = _plans()
    rng = np.random.default_rng(59)
    A = _gen(rng, 4)
    limit = HealthPolicy().resolved_residual_limit(np.float32, N)
    bad = A.copy()
    bad[2, :, 5] = 0.0  # exactly singular
    nan = A.copy()
    nan[1] = np.nan
    for X in (A, bad, nan):
        vt = tp._factor_health_fn(4)(_t(X))[2].numpy()
        vj = np.asarray(jp._factor_health_fn(4)(jnp.asarray(X))[2])
        np.testing.assert_array_equal(vt[0], vj[0])
        healthy_t = (vt[0] >= 0.5) & (vt[1] <= limit)
        healthy_j = (vj[0] >= 0.5) & (vj[1] <= limit)
        np.testing.assert_array_equal(healthy_t, healthy_j)
    assert not healthy_t[1] and healthy_t[[0, 2, 3]].all()
    Fc = tp._factor_health_fn(4)(_t(A))[0]
    Fn = tp._factor_health_fn(4)(_t(nan))[0]
    for lc, ln in zip(Fc, Fn):
        assert torch.equal(lc[[0, 2, 3]], ln[[0, 2, 3]])


def test_stacked_factor_bucket_and_pad_invariance():
    _jp, tp = _plans()
    rng = np.random.default_rng(61)
    A = _gen(rng, 4)
    F1 = tp._stacked_factor_fn(1)(_t(A[:1]))
    F4 = tp._stacked_factor_fn(4)(_t(A))
    Fp = tp._stacked_factor_fn(2)(_t(np.stack([A[0], np.eye(N, dtype=np.float32)])))
    for l1, l4, lp in zip(F1, F4, Fp):
        assert torch.equal(l1[0], l4[0]) and torch.equal(l1[0], lp[0])
    with pytest.raises(AssertionError, match="power-of-two"):
        # conflint: disable=CFX-RECOMPILE asserting the bucket contract rejects 3
        tp._stacked_factor_fn(3)


def test_inv_plan_factor_lane_is_bucket_invariant():
    """'inv' plans invert each slot's triangles in a library call of its
    own, so a slot's inverses do not depend on the bucket."""
    serve.clear_plans()
    tp = serve.FactorPlan.create((N, N), torch.float32, v=V, substitution="inv")
    A = _gen(np.random.default_rng(63), 16)
    F16 = tp._stacked_factor_fn(16)(_t(A))
    for i in (0, 15):
        for got, ref in zip(F16, tp.factor(A[i], device="cpu").factors):
            assert torch.equal(got[i], ref)


def test_batched_plan_folds_the_stack_into_one_kernel_batch():
    Bp = 4
    jp, tp = _plans(shape=(Bp, N, N))
    rng = np.random.default_rng(67)
    A = _gen(rng, Bp)
    s = tp.factor(A, device="cpu")
    b = rng.standard_normal((Bp, N)).astype(np.float32)
    x = s.solve(b).numpy()
    assert x.shape == (Bp, N)
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-4
    np.testing.assert_allclose(x, np.asarray(jp.factor(jnp.asarray(A)).solve(jnp.asarray(b))),
                               rtol=2e-4, atol=1e-5)
    Ast = np.stack([A, _gen(rng, Bp)])
    F, wA, verdict = tp._factor_health_fn(2)(_t(Ast))
    assert tuple(wA.shape) == (2, Bp, N) and tuple(verdict.shape) == (2, 2)
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-3
    for got, ref in zip(F, s.factors):
        assert torch.equal(got[0], ref)
    xc, v = s.solve_checked(b)
    assert float(v[0]) == 1.0 and np.allclose(xc.numpy(), x, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="rhs"):
        s.solve(b[:2])


def test_fused_dinv_matches_a_second_pass():
    _jp, tp = _plans()
    rng = np.random.default_rng(71)
    LU, Dl, Du, _perm = tp._stacked_factor_fn(2)(_t(_gen(rng, 2)))
    for i in range(2):
        assert torch.equal(Dl[i], diag_block_inverses(LU[i], lower=True, unit_diagonal=True))
        assert torch.equal(Du[i], diag_block_inverses(LU[i], lower=False))


def test_bucket_programs_are_built_once():
    _jp, tp = _plans()
    rng = np.random.default_rng(73)
    A = _gen(rng, 2)
    b = rng.standard_normal((N, 3)).astype(np.float32)
    s = tp.factor(A[0], device="cpu")
    s.solve(b)
    s.solve_checked(b)
    tp._stacked_factor_fn(2)(_t(A))
    tp._factor_health_fn(2)(_t(A))
    snapshot = dict(tp.trace_counts)
    assert snapshot == {"factor": 2, "solve": 1, "health": 1, "factor_health": 1}
    for _ in range(3):
        tp.factor(A[1], device="cpu").solve(b)
        s.solve_checked(b[:, :1])  # bucket 1: one more build, once
        tp._stacked_factor_fn(2)(_t(A))
        tp._factor_health_fn(2)(_t(A))
    snapshot["health"] += 1
    assert dict(tp.trace_counts) == snapshot
    assert all(fn.warm for fn in tp._factor_cache.values())


def test_factor_without_a_card_raises(monkeypatch):
    _jp, tp = _plans()
    A = _gen(np.random.default_rng(79), 1)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.factor(A)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.session_from_numpy(tp, [np.zeros((N, N)), np.zeros((2, 32, 32)),
                                      np.zeros((2, 32, 32)), np.arange(N)], A)
    assert tp.factor(A, device="cpu").device == torch.device("cpu")


def test_cpu_serving_runs_no_kernel():
    _jp, tp = _plans()
    rng = np.random.default_rng(83)
    before = dict(hopper_kernels.LAUNCHES)
    s = tp.factor(_gen(rng, 1)[0], device="cpu")
    s.solve_checked(rng.standard_normal(N).astype(np.float32))
    assert hopper_kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="shape"):
        tp.factor(_gen(rng, 2), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tp.factor(_gen(rng, 1, dtype=np.float64)[0], device="cpu")
