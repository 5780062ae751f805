"""The port's factor lane (coalesced cold start, `ServeEngine.submit_factor`)
on the CPU: twins of the reference's tests/test_factor_lane.py.

Sessions opened by a coalesced factor dispatch are bitwise `plan.factor`
sessions (`plan.factor` rides bucket 1 of the same stacked program family,
and the factor's slots do not depend on the bucket): on the CPU through the
plain K4, on the card through K4 itself (`chip_smoke.py` phase 26). Every
engine is closed in a `with` or `finally`; every wait has a timeout.
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch import profiler, resilience, serve
from conflux_tpu_torch.batched import stack_trees, unstack_tree
from conflux_tpu_torch.engine import EngineClosed, ServeEngine
from conflux_tpu_torch.resilience import (
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    HealthPolicy,
    RhsNonFinite,
    SolveUnhealthy,
)

B, N, V = 4, 32, 16
T = 60
CPU = "cpu"


def _systems(b, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(np.float32)


def _delta(h0, h1):
    return {k: h1[k] - h0.get(k, 0) for k in h1}


def _plan(shape=(N, N), **kw):
    serve.clear_plans()
    return serve.FactorPlan.create(shape, torch.float32, v=V, **kw)


def _same(s, ref, b):
    np.testing.assert_array_equal(s.solve(b).numpy(), ref.solve(b).numpy())


def test_unstack_stack_roundtrip_bitwise():
    plan = _plan()
    F = plan._stacked_factor_fn(4)(torch.from_numpy(_systems(4, seed=13)))
    trees = unstack_tree(F, 4)
    again = stack_trees(trees)
    for a, b in zip(F, again):
        assert torch.equal(a, b)
    assert len(unstack_tree(F, 3)) == 3


def test_stacked_factor_bucket_and_pad_invariance():
    plan = _plan()
    A = torch.from_numpy(_systems(4, seed=17))
    F1 = plan._stacked_factor_fn(1)(A[:1])
    F4 = plan._stacked_factor_fn(4)(A)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(F1, F4))
    F2 = plan._stacked_factor_fn(2)(torch.stack([A[0], torch.eye(N)]))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(F1, F2))
    with pytest.raises(AssertionError, match="power-of-two"):
        # conflint: disable=CFX-RECOMPILE asserting the bucket contract rejects 3
        plan._stacked_factor_fn(3)


@pytest.mark.parametrize("health", [None, HealthPolicy()], ids=["plain", "checked"])
def test_factor_lane_bitwise_vs_plan_factor(health):
    A = _systems(3, seed=19)
    Ab = _systems(B, seed=23)
    plan = _plan()
    bplan = serve.FactorPlan.create((B, N, N), torch.float32, v=V)
    rng = np.random.default_rng(23)
    b1 = rng.standard_normal((N, 2)).astype(np.float32)
    bb = rng.standard_normal((B, N)).astype(np.float32)
    with ServeEngine(max_batch_delay=0.05, max_factor_batch=4, health=health,
                     device=CPU) as eng:
        futs = [eng.submit_factor(plan, A[i]) for i in range(3)]
        bfut = eng.submit_factor(bplan, Ab)
        sessions = [f.result(timeout=T) for f in futs]
        bsession = bfut.result(timeout=T)
        for i, s in enumerate(sessions):
            _same(s, plan.factor(A[i], device=CPU), b1)
        _same(bsession, bplan.factor(Ab, device=CPU), bb)
        stats = eng.stats()
    assert stats["factor_requests"] == 4 and stats["factor_batches"] == 2
    assert stats["factor_pad_slots"] == 1
    if health is not None:
        assert sessions[0]._probe is not None
        _x, verdict = sessions[0].solve_checked(b1)
        ok, finite, _r = resilience.evaluate(
            verdict, health.resolved_residual_limit(np.float32, N))
        assert ok and finite


def test_factor_lane_spd_plan_bitwise_vs_plan_factor():
    rng = np.random.default_rng(24)
    M = _systems(3, seed=24)
    S = (M @ np.swapaxes(M, -1, -2) + np.eye(N)).astype(np.float32)
    plan = _plan(kind="chol")
    b = rng.standard_normal(N).astype(np.float32)
    with ServeEngine(max_batch_delay=0.05, max_factor_batch=4, device=CPU) as eng:
        sessions = [f.result(timeout=T) for f in [eng.submit_factor(plan, a) for a in S]]
        assert eng.stats()["factor_batches"] == 1
    for s, a in zip(sessions, S):
        _same(s, plan.factor(a, device=CPU), b)


def test_factor_lane_session_full_downstream_behavior():
    A = _systems(2, seed=29)
    plan = _plan()
    rng = np.random.default_rng(29)
    b = rng.standard_normal((N, 2)).astype(np.float32)
    U = (0.01 * rng.standard_normal((N, 2))).astype(np.float32)
    Vf = (0.01 * rng.standard_normal((N, 2))).astype(np.float32)
    with ServeEngine(max_batch_delay=0.02, device=CPU) as eng:
        s_eng = eng.factor(plan, A[0], timeout=T, sid="user-1")
        s_ref = plan.factor(A[0], device=CPU)
        assert s_eng.sid == "user-1" and s_eng.device == torch.device("cpu")
        for s in (s_eng, s_ref):
            s.update(U, Vf)
        _same(s_eng, s_ref, b)
        for s in (s_eng, s_ref):
            s.refactor()
        _same(s_eng, s_ref, b)
        assert s_eng.factorizations == s_ref.factorizations == 2
        np.testing.assert_array_equal(eng.solve(s_eng, b, timeout=T), s_ref.solve(b).numpy())


def test_factor_admission_rejects_nonfinite_A():
    plan = _plan()
    Abad = _systems(1, seed=31)[0]
    Abad[0, 0] = np.inf
    h0 = resilience.health_stats()
    with ServeEngine(max_batch_delay=0.0, health=HealthPolicy(), device=CPU) as eng:
        with pytest.raises(RhsNonFinite, match="admission"):
            eng.submit_factor(plan, Abad)
        assert eng.stats()["pending"] == 0
    assert _delta(h0, resilience.health_stats())["factor_rejects"] == 1


def test_factor_staging_poison_isolated_survivors_bitwise():
    A = _systems(3, seed=37)
    plan = _plan()
    b = np.random.default_rng(37).standard_normal(N).astype(np.float32)
    faults = FaultPlan([FaultSpec("factor", "nan", count=1)])
    h0 = resilience.health_stats()
    with ServeEngine(max_batch_delay=0.1, max_factor_batch=4, health=HealthPolicy(),
                     fault_plan=faults, device=CPU) as eng:
        futs = [eng.submit_factor(plan, A[i]) for i in range(3)]
        with pytest.raises(RhsNonFinite, match="staging"):
            futs[0].result(timeout=T)
        for i in (1, 2):
            _same(futs[i].result(timeout=T), plan.factor(A[i], device=CPU), b)
    assert _delta(h0, resilience.health_stats())["factor_isolations"] == 1
    assert faults.injected[("factor", "nan")] == 1


def test_singular_matrix_fails_alone_with_evidence():
    A = _systems(2, seed=41)
    plan = _plan()
    h0 = resilience.health_stats()
    with ServeEngine(max_batch_delay=0.1, max_factor_batch=4, health=HealthPolicy(),
                     device=CPU) as eng:
        f_good = eng.submit_factor(plan, A[0])
        f_sick = eng.submit_factor(plan, np.zeros((N, N), np.float32))
        s = f_good.result(timeout=T)
        with pytest.raises(SolveUnhealthy) as ei:
            f_sick.result(timeout=T)
        rungs = ei.value.evidence["rungs"]
        assert rungs and rungs[-1]["rung"] == "factor" and not rungs[-1]["finite"]
        _same(s, plan.factor(A[0], device=CPU), np.ones(N, np.float32))
    assert _delta(h0, resilience.health_stats())["factor_unhealthy"] == 2


def test_forced_unhealthy_verdict_recovers_via_solo_redispatch():
    A = _systems(2, seed=43)
    plan = _plan()
    faults = FaultPlan([FaultSpec("factor", "unhealthy", count=1)])
    h0 = resilience.health_stats()
    with ServeEngine(max_batch_delay=0.1, max_factor_batch=2, health=HealthPolicy(),
                     fault_plan=faults, device=CPU) as eng:
        sessions = [f.result(timeout=T) for f in [eng.submit_factor(plan, a) for a in A]]
    assert all(s.solves == 0 and s.factorizations == 1 for s in sessions)
    assert _delta(h0, resilience.health_stats())["factor_unhealthy"] == 2


def test_prewarmed_churn_trace_zero_builds():
    A = _systems(6, seed=47)
    plan = _plan()
    rng = np.random.default_rng(47)
    with ServeEngine(max_batch_delay=0.02, max_factor_batch=4, max_coalesce_width=4,
                     device=CPU) as eng:
        seed_session = plan.factor(A[0], device=CPU)
        eng.prewarm(seed_session, widths=(1, 2, 4), factor_batches=(1, 2, 4))
        snapshot, builds = dict(plan.trace_counts), profiler.compile_count()
        fleet, futs = [seed_session], []
        for i in range(1, 6):
            futs.append(eng.submit_factor(plan, A[i]))
            b = rng.standard_normal((N, 1 + i % 2)).astype(np.float32)
            futs.append(eng.submit(fleet[rng.integers(len(fleet))], b))
            if i % 2 == 0:
                fleet.append(futs[-2].result(timeout=T))
        for f in futs:
            f.result(timeout=T)
        assert plan.trace_counts == snapshot and profiler.compile_count() == builds
        stats = eng.stats()
    assert stats["factor_batches"] >= 1 and stats["factor_coalesced_mean"] >= 1.0
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng2:
        eng2.prewarm(plan, factor_batches=(2,))
        snapshot = dict(plan.trace_counts)
        eng2.factor(plan, A[1], timeout=T)
        assert plan.trace_counts == snapshot


def test_close_answers_queued_factor_requests():
    A = _systems(2, seed=53)
    plan = _plan()
    eng = ServeEngine(max_batch_delay=60.0, device=CPU)
    try:
        futs = [eng.submit_factor(plan, A[i]) for i in range(2)]
    finally:
        eng.close(timeout=T)
    b = np.ones(N, np.float32)
    for i, f in enumerate(futs):
        assert f.done(), "close() dropped a queued factor request"
        _same(f.result(0), plan.factor(A[i], device=CPU), b)
    with pytest.raises(EngineClosed):
        eng.submit_factor(plan, A[0])


def test_wedged_close_fails_pending_factor_futures():
    A = _systems(1, seed=59)
    plan = _plan()
    faults = FaultPlan([FaultSpec("drain", "delay", delay_s=3.0)])
    eng = ServeEngine(max_batch_delay=0.0, fault_plan=faults, watchdog_interval=0,
                      device=CPU)
    f = eng.submit_factor(plan, A[0])
    wedged = eng.close(timeout=0.4)
    assert wedged, "drain should still be sleeping in the injected delay"
    with pytest.raises(EngineClosed, match="wedged"):
        f.result(timeout=10)
    eng.close(timeout=T)  # the delayed drain finishes; nothing is left running
    assert not any(t.is_alive() for t in (eng.lanes[0]._dispatcher, eng.lanes[0]._drainer))


def test_factor_deadline_lazy_eviction():
    A = _systems(1, seed=61)
    plan = _plan()
    eng = ServeEngine(max_batch_delay=60.0, device=CPU)
    try:
        h0 = resilience.health_stats()
        with pytest.raises(DeadlineExceeded):
            eng.submit_factor(plan, A[0], deadline=0.01).result(timeout=T)
        with pytest.raises(DeadlineExceeded):
            eng.factor(plan, A[0], timeout=T, deadline=0.01)
        assert _delta(h0, resilience.health_stats())["evictions"] == 2
        assert eng.stats()["pending"] == 0
    finally:
        eng.close(timeout=T)


def test_factor_lane_rejects_bad_inputs():
    plan = _plan()
    session = plan.factor(_systems(1, seed=67)[0], device=CPU)
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        with pytest.raises(ValueError, match="shape"):
            eng.submit_factor(plan, np.zeros((N, N + 1), np.float32))
        with pytest.raises(TypeError, match="FactorPlan"):
            eng.submit_factor(session, np.zeros((N, N), np.float32))
        with pytest.raises(ValueError, match="lane device"):
            eng.submit_factor(plan, np.eye(N, dtype=np.float32), device="cuda:3")


def test_factor_lane_tier_cold_start_opens_at_the_tier():
    A = _systems(2, seed=69)
    plan = _plan()
    b = np.ones(N, np.float32)
    with ServeEngine(max_batch_delay=0.05, device=CPU) as eng:
        eng.prewarm(plan, factor_batches=(2,), precisions=("f64",))
        futs = [eng.submit_factor(plan, a, precision="f64") for a in A]
        sessions = [f.result(timeout=T) for f in futs]
    for s, a in zip(sessions, A):
        assert s.served_tier == "f64" and s._A is not None
        ref = plan.factor(a, device=CPU, precision="f64")
        _same(s, ref, b)


def test_factor_counters_in_serve_stats():
    A = _systems(3, seed=71)
    plan = _plan()
    with ServeEngine(max_batch_delay=0.05, max_factor_batch=4, device=CPU) as eng:
        for f in [eng.submit_factor(plan, A[i]) for i in range(3)]:
            f.result(timeout=T)
        merged = profiler.serve_stats()["engine"]
        mine = eng.stats()
    assert mine["factor_requests"] == 3 and mine["factor_batches"] >= 1
    assert mine["factor_coalesced_mean"] >= 1.0 and 0.0 <= mine["factor_pad_waste"] < 1.0
    assert mine["factor_latency_p99_ms"] >= mine["factor_latency_p50_ms"] > 0.0
    assert merged["factor_requests"] >= mine["factor_requests"]
    assert merged["factor_latency_p99_ms"] >= merged["factor_latency_p50_ms"] > 0.0
