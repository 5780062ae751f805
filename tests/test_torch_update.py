"""The port's Woodbury drift path (`conflux_tpu_torch.update`, the update
programs and `SolveSession.update`/`refactor` of `serve`, `solve_updated`,
`solve_updated_batched`) on the CPU, against the JAX package's on the same
seeded numpy inputs: each function of `update.py`, then the session cases
of tests/test_update.py beside a JAX session on the same inputs.

Tolerances: float32 allclose rtol 1e-5 / atol 1e-5 between the port and the
JAX package, float64 rtol 1e-12; bits are held only between port paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import batched as jbatched
from conflux_tpu import serve as jserve
from conflux_tpu import solvers as jsolvers
from conflux_tpu import update as jupdate
from conflux_tpu_torch import batched as tbatched
from conflux_tpu_torch import resilience as tres
from conflux_tpu_torch import serve
from conflux_tpu_torch import solvers as tsolvers
from conflux_tpu_torch import update as tupdate
from conflux_tpu_torch.ops import blas as tblas

B, N, V, K = 4, 32, 16, 3
F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)


def _systems(b=B, n=N, seed=0, spd=False, k=K):
    """tests/test_update.py's generator."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    A = (rng.standard_normal(lead + (n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(np.float32)
    if spd:
        A = (A @ np.swapaxes(A, -1, -2) + np.eye(n, dtype=np.float32)).astype(np.float32)
    U = (rng.standard_normal(lead + (n, k)) / np.sqrt(n)).astype(np.float32)
    Vm = (rng.standard_normal(lead + (n, k)) / np.sqrt(n)).astype(np.float32)
    rhs = rng.standard_normal(lead + (n,)).astype(np.float32)
    return A, U, Vm, rhs


def _res(A1, x, b):
    A64 = np.asarray(A1, np.float64)
    x64, b64 = np.asarray(x, np.float64), np.asarray(b, np.float64)
    if A64.ndim == 2:
        return np.linalg.norm(A64 @ x64 - b64) / np.linalg.norm(b64)
    r = np.einsum("bij,bj->bi", A64, x64) - b64
    return np.linalg.norm(r, axis=1) / np.linalg.norm(b64, axis=1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _plans(shape, **kw):
    serve.clear_plans()
    jserve.clear_plans()
    return (jserve.FactorPlan.create(shape, jnp.float32, v=V, **kw),
            serve.FactorPlan.create(shape, torch.float32, v=V, **kw))


# --------------------------------------------------------------------------- #
# update.py, function by function
# --------------------------------------------------------------------------- #


def _base(A):
    """The same base substitution both packages' capacitance wraps: a
    dense inverse in float64 (exact enough that only the Woodbury
    arithmetic is compared)."""
    Ainv = np.linalg.inv(A.astype(np.float64))
    return (lambda r: jnp.matmul(jnp.asarray(Ainv), r)), (lambda r: torch.matmul(_t(Ainv), r))


@pytest.mark.parametrize("case", ["capacitance", "woodbury_apply", "updated_matvec",
                                  "woodbury_solve", "probe_lstsq", "spot_check_drifted",
                                  "spot_check_slots", "verdict_from_stats_slots",
                                  "pad_update_state", "zero_update_state", "apply_update"])
def test_update_function_matches_jax(case):
    A, U, Vm, b = _systems(b=None, seed=31)
    A64, U64, V64 = A.astype(np.float64), U.astype(np.float64), Vm.astype(np.float64)
    jb, tb = _base(A)
    b2 = np.stack([b, -2 * b], 1).astype(np.float64)
    if case == "capacitance":
        jY, jC, jc = jupdate.capacitance(jb, jnp.asarray(U64), jnp.asarray(V64))
        tY, tC, tc = tupdate.capacitance(tb, _t(U64), _t(V64))
        for t, j in ((tY, jY), (tC, jC), (tc, jc)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)
    elif case == "woodbury_apply":
        jY, jC, _ = jupdate.capacitance(jb, jnp.asarray(U64), jnp.asarray(V64))
        tY, tC, _ = tupdate.capacitance(tb, _t(U64), _t(V64))
        j = jupdate.woodbury_apply(jb, jY, jC, jnp.asarray(V64), jnp.asarray(b2))
        t = tupdate.woodbury_apply(tb, tY, tC, _t(V64), _t(b2))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)
    elif case == "updated_matvec":
        j = jupdate.updated_matvec(jnp.asarray(A), jnp.asarray(U), jnp.asarray(Vm),
                                   jnp.asarray(b2.astype(np.float32)))
        t = tupdate.updated_matvec(_t(A), _t(U), _t(Vm), _t(b2.astype(np.float32)))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)
    elif case == "woodbury_solve":
        j = jupdate.woodbury_solve(jb, jnp.asarray(A64), jnp.asarray(U64), jnp.asarray(V64),
                                   jnp.asarray(b2), refine=2)
        t = tupdate.woodbury_solve(tb, _t(A64), _t(U64), _t(V64), _t(b2), refine=2)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)
        assert _res(A64 + U64 @ V64.T, t.numpy()[:, 0], b2[:, 0]) < 1e-13
    elif case == "probe_lstsq":
        T = np.random.default_rng(32).standard_normal((96, N)).astype(np.float32)
        w = tupdate.probe_vector(N)
        ju, juA = jupdate.probe_lstsq(jnp.asarray(w), jnp.asarray(T))
        tu, tuA = tupdate.probe_lstsq(_t(w), _t(T))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **F32)
        np.testing.assert_allclose(tuA.numpy(), np.asarray(juA), rtol=1e-5, atol=1e-4)
        assert abs(float(torch.linalg.norm(tu)) - np.sqrt(96)) < 1e-4
    elif case in ("spot_check_drifted", "spot_check_slots"):
        rng = np.random.default_rng(33)
        S = 3
        w = tupdate.probe_vector(N)
        wA = rng.standard_normal((S, N)).astype(np.float32)
        x = rng.standard_normal((S, N, 2)).astype(np.float32)
        bb = rng.standard_normal((S, N, 2)).astype(np.float32)
        Up = rng.standard_normal((S, N, 4)).astype(np.float32)
        Vp = rng.standard_normal((S, N, 4)).astype(np.float32)
        jf = jupdate.health_spot_check if case == "spot_check_drifted" \
            else jupdate.health_spot_check_slots
        tf = tupdate.health_spot_check if case == "spot_check_drifted" \
            else tupdate.health_spot_check_slots
        for drift in ((), (Up, Vp)):
            j = jf(jnp.asarray(w), jnp.asarray(wA), jnp.asarray(x), jnp.asarray(bb),
                   *map(jnp.asarray, drift))
            t = tf(_t(w), _t(wA), _t(x), _t(bb), *map(_t, drift))
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)
        x[1, 3, 1] = np.nan
        t = tupdate.health_spot_check_slots(_t(w), _t(wA), _t(x), _t(bb))
        assert t[0].tolist() == [1.0, 0.0, 1.0]
    elif case == "verdict_from_stats_slots":
        rng = np.random.default_rng(34)
        w = tupdate.probe_vector(N)
        xsum = np.array([1.0, np.inf, -2.0], np.float32)
        wAx = rng.standard_normal(3).astype(np.float32)
        bb = rng.standard_normal((3, N, 1)).astype(np.float32)
        j = jupdate.health_verdict_from_stats_slots(jnp.asarray(w), jnp.asarray(xsum),
                                                    jnp.asarray(wAx), jnp.asarray(bb))
        t = tupdate.health_verdict_from_stats_slots(_t(w), _t(xsum), _t(wAx), _t(bb))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)
    elif case == "pad_update_state":
        jY, jC, _ = jupdate.capacitance(jb, jnp.asarray(U64), jnp.asarray(V64))
        tY, tC, _ = tupdate.capacitance(tb, _t(U64), _t(V64))
        j = jupdate.pad_update_state(jnp.asarray(U64), jnp.asarray(V64), jY, jC, 8)
        t = tupdate.pad_update_state(_t(U64), _t(V64), tY, tC, 8)
        for tt, jj in zip(t, j):
            assert tuple(tt.shape) == jj.shape
            np.testing.assert_allclose(tt.numpy(), np.asarray(jj), **F64)
        # the padded state applies the same correction
        x8 = tupdate.woodbury_apply(tb, t[2], t[3], t[1], _t(b2))
        x3 = tupdate.woodbury_apply(tb, tY, tC, _t(V64), _t(b2))
        np.testing.assert_allclose(x8.numpy(), x3.numpy(), **F64)
        with pytest.raises(ValueError, match="pad rank"):
            tupdate.pad_update_state(*t, 4)
    elif case == "zero_update_state":
        j = jupdate.zero_update_state(N, 4, jnp.bfloat16)
        t = tupdate.zero_update_state(N, 4, torch.bfloat16)
        assert [x.dtype for x in t] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                        torch.float32]
        for tt, jj in zip(t, j):
            np.testing.assert_array_equal(tt.float().numpy(), np.asarray(jj, np.float32))
    else:
        Ab, Ub, Vb, _ = _systems(seed=35)
        j = jupdate.apply_update(jnp.asarray(Ab), jnp.asarray(Ub), jnp.asarray(Vb))
        t = tupdate.apply_update(_t(Ab), _t(Ub), _t(Vb))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32)
        t1 = tupdate.apply_update(_t(A), _t(U), _t(Vm))
        np.testing.assert_allclose(t1.numpy(), A + U @ Vm.T, **F32)


# --------------------------------------------------------------------------- #
# the session cases of tests/test_update.py, beside a JAX session
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape_kind", ["single", "batched", "spd", "bf16_factor", "inv",
                                        "trsm", "refine"])
def test_session_update_solves_drifted_system_like_jax(shape_kind):
    """An updated session answers the drifted system (the JAX session's
    answer, F32), without refactoring; the un-drifted base is no longer
    what it solves."""
    b_lead = B if shape_kind == "batched" else None
    A, U, Vm, b = _systems(b=b_lead, seed=1, spd=shape_kind == "spd")
    shape = A.shape
    kw = {"spd": True} if shape_kind == "spd" else {}
    if shape_kind in ("inv", "trsm"):
        kw["substitution"] = shape_kind
    if shape_kind == "refine":
        kw["refine"] = 1
    if shape_kind == "bf16_factor":
        # the blocked factor's K2 panels need 128-wide blocks: the library route
        tblas.set_panel_algo("auto")
    try:
        serve.clear_plans()
        jserve.clear_plans()
        jkw = dict(kw, factor_dtype=jnp.bfloat16) if shape_kind == "bf16_factor" else kw
        tkw = dict(kw, factor_dtype=torch.bfloat16) if shape_kind == "bf16_factor" else kw
        jp = jserve.FactorPlan.create(shape, jnp.float32, v=V, **jkw)
        tp = serve.FactorPlan.create(shape, torch.float32, v=V, **tkw)
        js = jp.factor(jnp.asarray(A))
        ts = tp.factor(A, device="cpu")
        js.update(jnp.asarray(U), jnp.asarray(Vm))
        ts.update(U, Vm)
        assert ts.update_rank == K and ts.updates == 1 and ts.factorizations == 1
        np.testing.assert_allclose(ts.last_cond, js.last_cond, rtol=1e-4)
        xj, xt = np.asarray(js.solve(jnp.asarray(b))), ts.solve(b).numpy()
        A1 = np.asarray(jupdate.apply_update(jnp.asarray(A), jnp.asarray(U), jnp.asarray(Vm)))
        bf16 = shape_kind == "bf16_factor"
        np.testing.assert_allclose(xt, xj, **(dict(rtol=2e-2, atol=2e-2) if bf16 else F32))
        assert np.all(_res(A1, xt, b) <= (1e-2 if bf16 else 1e-5))
        assert np.all(_res(A, xt, b) > 1e-4)
        # the checked solve: the same answer, a clean verdict projected
        # through the drifted matrix, the JAX session's
        xc, vt = ts.solve_checked(b)
        _xj, vj = js.solve_checked(jnp.asarray(b))
        assert torch.equal(xc, torch.from_numpy(xt))
        assert float(vt[0]) == 1.0 == float(np.asarray(vj)[0])
        assert float(vt[1]) < (1e-2 if bf16 else 1e-5)
    finally:
        tblas.set_panel_algo("kernel")


def test_session_update_accumulates_and_replaces():
    A, U, Vm, b = _systems(b=None, seed=5)
    jp, tp = _plans((N, N))
    s1 = tp.factor(A, device="cpu")
    s1.update(U[:, :1], Vm[:, :1])
    s1.update(U[:, 1:], Vm[:, 1:])
    assert s1.update_rank == K
    s2 = tp.factor(A, device="cpu")
    s2.update(U, Vm)
    # two stacked updates == one combined update, bitwise
    assert torch.equal(s1.solve(b), s2.solve(b))
    s1.update(U, Vm, replace=True)
    assert s1.update_rank == K and torch.equal(s1.solve(b), s2.solve(b))
    js = jp.factor(jnp.asarray(A))
    js.update(jnp.asarray(U[:, :1]), jnp.asarray(Vm[:, :1]))
    js.update(jnp.asarray(U[:, 1:]), jnp.asarray(Vm[:, 1:]))
    np.testing.assert_allclose(s1.solve(b).numpy(), np.asarray(js.solve(jnp.asarray(b))), **F32)


def test_session_update_refine_backstop():
    A, U, Vm, b = _systems(b=None, seed=6)
    A1 = A + U @ Vm.T
    jp, tp = _plans((N, N))
    plain = tp.factor(A, device="cpu").update(U, Vm).solve(b)
    pol = tupdate.DriftPolicy(refine=2)
    refined = tp.factor(A, device="cpu", policy=pol).update(U, Vm).solve(b)
    assert _res(A1, refined, b) <= max(float(_res(A1, plain, b)), 1e-7)
    jref = jp.factor(jnp.asarray(A), policy=jupdate.DriftPolicy(refine=2)) \
        .update(jnp.asarray(U), jnp.asarray(Vm)).solve(jnp.asarray(b))
    np.testing.assert_allclose(refined.numpy(), np.asarray(jref), **F32)
    assert tp.trace_counts["update_solve"] == 2  # sweeps 0 and 2: two programs


def test_session_update_rejects_bad_shapes():
    A, U, Vm, _ = _systems(seed=7)
    _jp, tp = _plans((B, N, N))
    s = tp.factor(A, device="cpu")
    with pytest.raises(ValueError, match="must agree"):
        s.update(U, Vm[:, :, :1])
    with pytest.raises(ValueError, match="rank axis"):
        s.update(U[0], Vm[0])
    with pytest.raises(ValueError, match="rank axis"):
        s.update(U[:2], Vm[:2])


def test_update_builds_once_per_bucket():
    """update() and corrected solves build one program per (rank bucket,
    RHS bucket), as the JAX package traces one; counted under its names."""
    A, U, Vm, b = _systems(b=None, seed=8)
    rng = np.random.default_rng(80)
    jp, tp = _plans((N, N))
    s = tp.factor(A, device="cpu")
    js = jp.factor(jnp.asarray(A))
    for sess, put in ((s, np.asarray), (js, jnp.asarray)):
        sess.update(put(U), put(Vm))
        sess.solve(put(b))
    t = dict(tp.trace_counts)
    assert t["update"] == 1 == jp.trace_counts["update"]
    assert t["update_solve"] == 1 == jp.trace_counts["update_solve"]
    for k in (3, 4, 3):
        Un = (rng.standard_normal((N, k)) / np.sqrt(N)).astype(np.float32)
        Vn = (rng.standard_normal((N, k)) / np.sqrt(N)).astype(np.float32)
        s.update(Un, Vn, replace=True)
        s.solve(rng.standard_normal(N).astype(np.float32))
    assert tp.trace_counts == t
    tp.factor(A, device="cpu").update(U, Vm).solve(b)
    assert tp.trace_counts == t
    U8 = (rng.standard_normal((N, 8)) / np.sqrt(N)).astype(np.float32)
    s.update(U8, U8, replace=True)
    s.solve(b)
    assert tp.trace_counts["update"] == t["update"] + 1
    assert tp.trace_counts["update_solve"] == t["update_solve"] + 1
    s.solve_checked(b)
    assert tp.trace_counts["health"] == 1


def _near_singular_drift(A, delta=1e-7):
    """U = [e0, e1], V = [-(1 - delta) A^T e0, 0]: the capacitance is
    diag(delta, 1) (cond1 = 1/delta) and the drifted matrix scales A's row
    0 by delta (ill-conditioned, still factorable with pivoting)."""
    n = A.shape[-1]
    U = np.eye(n, dtype=np.float32)[:, :2]
    Vm = np.zeros((n, 2), np.float32)
    Vm[:, 0] = -(1 - delta) * A[0]
    return U, Vm


@pytest.mark.parametrize("trigger", ["rank", "cond", "near_singular"])
def test_drift_policy_triggers_refactor_once(trigger):
    """The rank trigger, a cond_limit below 1 (cond1 >= 1 always refactors)
    and a near-singular drift under the default policy (cond ~1e7 > 1e6)
    each pay one true refactor, as the JAX session does."""
    A, U, Vm, b = _systems(b=None, seed=9)
    jp, tp = _plans((N, N))
    kw = {"rank": {"max_rank": 2 * K - 1}, "cond": {"cond_limit": 0.5},
          "near_singular": {}}[trigger]
    s = tp.factor(A, device="cpu", policy=tupdate.DriftPolicy(**kw))
    js = jp.factor(jnp.asarray(A), policy=jupdate.DriftPolicy(**kw))
    if trigger == "near_singular":
        U, Vm = _near_singular_drift(A)
    before = tres.health_stats()["cond_refactors"]
    for sess, put in ((s, np.asarray), (js, jnp.asarray)):
        sess.update(put(U), put(Vm))
    A2 = A + U @ Vm.T
    if trigger == "rank":
        assert s.refactors == 0 and s.update_rank == K
        for sess, put in ((s, np.asarray), (js, jnp.asarray)):
            sess.update(put(U), put(Vm))
        A2 = A + 2.0 * (U @ Vm.T)
    else:
        assert tres.health_stats()["cond_refactors"] == before + 1
    if trigger == "near_singular":
        # C[0, 0] is rounding-sized: both estimates are huge, not equal
        assert s.last_cond > 1e6 and js.last_cond > 1e6
    assert s.refactors == 1 == js.refactors and s.factorizations == 2
    assert s.update_rank == 0
    x = s.solve(b)
    assert tp.trace_counts["factor"] == 1
    if trigger == "near_singular":
        # row 0 of A + U V^T is rounding-sized, so each package factors its
        # own rounding of it: hold each answer to a normwise backward error
        # against its own refactored base instead
        for x_, A_ in ((x.numpy(), s._A0.numpy()), (np.asarray(js.solve(jnp.asarray(b))),
                                                     np.asarray(js._A0))):
            A64, x64 = A_.astype(np.float64), x_.astype(np.float64)
            berr = np.linalg.norm(A64 @ x64 - b) / (np.linalg.norm(A64, 2)
                                                    * np.linalg.norm(x64) + np.linalg.norm(b))
            assert berr < 1e-5
        return
    assert _res(A2, x, b) < 1e-5
    np.testing.assert_allclose(x.numpy(), np.asarray(js.solve(jnp.asarray(b))), **F32)


def test_drift_policy_default_max_rank():
    for pol in (tupdate.DriftPolicy(), jupdate.DriftPolicy()):
        assert pol.resolved_max_rank(1024) == 128
        assert pol.resolved_max_rank(32) == 8
    assert tupdate.DriftPolicy(max_rank=5).resolved_max_rank(1024) == 5
    assert [tupdate.rank_bucket(k) for k in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 16]


@pytest.mark.parametrize("batched", [False, True])
def test_refactor_bits_owned_and_borrowed_base(batched):
    """A refactor's factors are bitwise `plan.factor` of the drifted base
    A0 + U V^T (`update.apply_update`), whether the session borrowed its
    base (the caller's tensor, left untouched) or owns it (updated in
    place); the explicit `refactor()` too, and the JAX session's answer."""
    A, U, Vm, b = _systems(b=B if batched else None, seed=21, k=4)
    jp, tp = _plans(A.shape)
    At = torch.from_numpy(A.copy())
    s = tp.factor(At, device="cpu", policy=tupdate.DriftPolicy(max_rank=1))
    s.update(U, Vm)  # k=4 > max_rank: a true refactor, on the borrowed base
    assert s.refactors == 1 and s._owns_base
    assert torch.equal(At, torch.from_numpy(A)), "the caller's base was written"
    A1 = tupdate.apply_update(At, torch.from_numpy(U), torch.from_numpy(Vm))
    ref1 = tp.factor(A1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(s.factors, ref1.factors))
    owned = s._A0
    s.update(U, Vm)  # the owned base is updated in place
    assert s._A0 is owned and s.refactors == 2
    A2 = tupdate.apply_update(A1, torch.from_numpy(U), torch.from_numpy(Vm))
    assert torch.equal(s._A0, A2)
    ref2 = tp.factor(A2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(s.factors, ref2.factors))
    # rung 1 on a drifted session (max_rank allows the update) absorbs it
    s3 = tp.factor(At, device="cpu")
    s3.update(U, Vm).refactor()
    assert s3.update_rank == 0 and s3.refactors == 1
    assert all(torch.equal(x, y) for x, y in zip(s3.factors, ref1.factors))
    js = jp.factor(jnp.asarray(A), policy=jupdate.DriftPolicy(max_rank=1))
    js.update(jnp.asarray(U), jnp.asarray(Vm)).update(jnp.asarray(U), jnp.asarray(Vm))
    np.testing.assert_allclose(s.solve(b).numpy(), np.asarray(js.solve(jnp.asarray(b))), **F32)


def test_nbytes_counts_the_woodbury_state():
    A, U, Vm, _b = _systems(b=None, seed=22)
    _jp, tp = _plans((N, N))
    s = tp.factor(A, device="cpu")
    base = s.nbytes
    s.update(U, Vm)
    kb = 4
    extra = 2 * N * kb * 4 + N * kb * 4 + kb * kb * 4  # Up, Vp, Y, Cinv
    assert s.nbytes == base + extra


def test_refine_checked_after_refactor_and_the_ladder():
    """`refine_checked` (rung 2) refuses a drifted session, then refines
    against the refactored base; `resilience.escalate` runs rung 1 and
    returns a host answer, the JAX ladder's."""
    A, U, Vm, b = _systems(b=None, seed=23)
    jp, tp = _plans((N, N))
    s = tp.factor(A, device="cpu").update(U, Vm)
    with pytest.raises(AssertionError, match="refactor"):
        s.refine_checked(b, s.solve(b))
    s.refactor()
    x = s.solve(b)
    x2, v = s.refine_checked(b, x)
    A1 = A + U @ Vm.T
    assert float(v[0]) == 1.0 and float(v[1]) < 1e-5 and _res(A1, x2, b) < 1e-6
    assert tp.trace_counts["refine"] == 1
    pol = tres.HealthPolicy()
    limit = pol.resolved_residual_limit(np.float32, N)
    s2 = tp.factor(A, device="cpu").update(U, Vm)
    js = jp.factor(jnp.asarray(A)).update(jnp.asarray(U), jnp.asarray(Vm))
    from conflux_tpu import resilience as jres

    out = tres.escalate(s2, b[:, None], pol, limit)
    jout = jres.escalate(js, jnp.asarray(b[:, None]), jres.HealthPolicy(), limit)
    assert isinstance(out, np.ndarray) and s2.refactors == 1 == js.refactors
    np.testing.assert_allclose(out, np.asarray(jout), **F32)


@pytest.fixture
def library_panels():
    """The JAX package's default library route (backend "xla", panel algo
    "auto"): `solvers` factors at v=16, which the K2 kernel (128-wide
    blocks) does not take, and in float64, which K1 does not."""
    tblas.set_backend("xla")
    tblas.set_panel_algo("auto")
    yield
    tblas.set_backend("kernel")
    tblas.set_panel_algo("kernel")


def test_solve_updated_matches_jax_and_pads(library_panels):
    A, U, Vm, b = _systems(b=None, seed=11)
    A1 = A + U @ Vm.T
    xt = tsolvers.solve_updated(_t(A), _t(U), _t(Vm), _t(b), v=V)
    xj = jsolvers.solve_updated(jnp.asarray(A), jnp.asarray(U), jnp.asarray(Vm),
                                jnp.asarray(b), v=V)
    assert _res(A1, xt, b) < 1e-5
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **F32)
    bk = np.stack([b, 2 * b], 1)
    xk = tsolvers.solve_updated(_t(A), _t(U), _t(Vm), _t(bk), v=V, refine=1)
    assert tuple(xk.shape) == (N, 2)
    np.testing.assert_allclose(xk[:, 1].numpy(), 2 * xk[:, 0].numpy(), rtol=1e-5, atol=1e-6)
    # identity-extended pad: N-2 is no multiple of v
    Ap, Up, Vp, bp = _systems(b=None, n=N - 2, seed=12)
    xp = tsolvers.solve_updated(_t(Ap), _t(Up), _t(Vp), _t(bp), v=V)
    assert tuple(xp.shape) == (N - 2,) and _res(Ap + Up @ Vp.T, xp, bp) < 1e-5
    with pytest.raises(ValueError, match="update factors"):
        tsolvers.solve_updated(_t(A), _t(U), _t(Vm[:, :1]), _t(b))
    # float64, against the JAX package's float64
    x64 = tsolvers.solve_updated(_t(A.astype(np.float64)), _t(U.astype(np.float64)),
                                 _t(Vm.astype(np.float64)), _t(b.astype(np.float64)), v=V,
                                 spd=False)
    j64 = jsolvers.solve_updated(jnp.asarray(A, jnp.float64), jnp.asarray(U, jnp.float64),
                                 jnp.asarray(Vm, jnp.float64), jnp.asarray(b, jnp.float64), v=V)
    np.testing.assert_allclose(x64.numpy(), np.asarray(j64), **F64)


@pytest.mark.parametrize("substitution,spd", [("trsm", False), ("blocked", False),
                                              ("blocked", True)])
def test_solve_updated_batched_matches_jax(library_panels, substitution, spd):
    A, U, Vm, b = _systems(seed=13, spd=spd)
    A1 = A + np.einsum("bik,bjk->bij", U, Vm)
    xt = tbatched.solve_updated_batched(_t(A), _t(U), _t(Vm), _t(b), v=V, spd=spd,
                                        substitution=substitution, refine=1)
    xj = jbatched.solve_updated_batched(jnp.asarray(A), jnp.asarray(U), jnp.asarray(Vm),
                                        jnp.asarray(b), v=V, spd=spd,
                                        substitution=substitution, refine=1)
    assert tuple(xt.shape) == (B, N) and (_res(A1, xt, b) < 1e-5).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **F32)
    with pytest.raises(ValueError, match="update factors"):
        tbatched.solve_updated_batched(_t(A), _t(U[0]), _t(Vm[0]), _t(b), v=V)
