"""Gang-resident session stacks in the port (`conflux_tpu_torch.gang`,
`ServeEngine(stack_sessions=True)`) on the CPU: twins of the reference's
tests/test_gang.py, one lane. The reference's spill/revive and controller
cases are in test_torch_tier.py and test_torch_control.py; its per-lane-slice
cases wait for several lanes.

Gang answers are allclose the solo dispatch here (rtol 2e-5 plain, 5e-5
drifted, the reference's bars) and bitwise invariant to the stack bucket
and the pad slots; on the card a gang answer is also bitwise the
session's own solve (`chip_smoke.py` phase 27). Every engine is closed in
a `with` or `finally`; every wait has a timeout.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from conflux_tpu_torch import profiler, resilience, serve
from conflux_tpu_torch.batched import stack_trees
from conflux_tpu_torch.engine import ServeEngine
from conflux_tpu_torch.gang import SessionGang
from conflux_tpu_torch.resilience import HealthPolicy

N, V = 32, 16
T = 60
CPU = "cpu"


def _fleet(n, seed=0, policy=None, **kw):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
    serve.clear_plans()
    plan = serve.FactorPlan.create((N, N), torch.float32, v=V, **kw)
    return plan, [plan.factor(A[i], policy=policy, device=CPU) for i in range(n)], A


def _rhs(n, seed=1, width=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, width)).astype(np.float32) for _ in range(n)]


def _gang_of(eng, plan):
    return eng.lanes[0]._gangs.get(id(plan))


def _one_window(eng, fleet, bs):
    """Submit into a parked window and let close() flush it as one batch."""
    try:
        futs = [eng.submit(s, b) for s, b in zip(fleet, bs)]
    finally:
        eng.close(timeout=T)
    return [f.result(0) for f in futs]


def test_gang_matches_direct_and_bitwise_within_bucket():
    plan, fleet, _A = _fleet(5, seed=11)
    bs = _rhs(5, seed=12)
    direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, max_stack=8, device=CPU)
    res = _one_window(eng, fleet, bs)
    for r, d in zip(res, direct):
        np.testing.assert_allclose(r, d, rtol=2e-5, atol=1e-6)
    st = eng.stats()
    assert st["gang_batches"] == st["batches"] == 1
    assert st["gang"]["sessions"] == 5 and st["gang"]["capacity_slots"] == 8
    g = _gang_of(eng, plan)
    F = stack_trees([fleet[3].factors, fleet[0].factors])
    buf = torch.zeros((2, N, 1))
    buf[0] = torch.from_numpy(bs[3])
    ref = plan._stacked_solve_fn(2, 1)(F, None, buf)[0].numpy()
    np.testing.assert_array_equal(res[3], ref)
    assert g.slot_of(fleet[3]) is not None


def test_gang_resident_steady_state_no_restack_no_build():
    plan, fleet, _A = _fleet(4, seed=21)
    bs = _rhs(4, seed=22)
    eng = ServeEngine(max_batch_delay=0.05, stack_sessions=True, max_stack=4, device=CPU)
    try:
        for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]:
            f.result(T)
        g = _gang_of(eng, plan)
        st0, traces0, builds = g.stats(), dict(plan.trace_counts), profiler.compile_count()
        for _ in range(3):
            for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]:
                f.result(T)
        st1 = g.stats()
    finally:
        eng.close(timeout=T)
    assert plan.trace_counts == traces0 and profiler.compile_count() == builds
    assert st1["adopts"] == st0["adopts"] and st1["rebuilds"] == st0["rebuilds"]
    assert st1["refreshes"] == st0["refreshes"] == 0
    assert eng.stats()["gang_batches"] >= 4


def test_gang_drifted_and_checked_sessions_stack():
    plan, fleet, _A = _fleet(4, seed=31)
    rng = np.random.default_rng(32)
    U = (0.01 * rng.standard_normal((N, 3))).astype(np.float32)
    Vm = (0.01 * rng.standard_normal((N, 3))).astype(np.float32)
    fleet[0].update(U, Vm)
    fleet[2].update(2 * U, Vm)
    bs = _rhs(4, seed=33, width=2)
    direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, max_stack=4,
                      health=HealthPolicy(), device=CPU)
    res = _one_window(eng, fleet, bs)
    for r, d in zip(res, direct):
        np.testing.assert_allclose(r, d, rtol=5e-5, atol=1e-6)
    st = eng.stats()
    assert st["stack_exclusions"]["upd_pending"] == 0
    assert st["stack_exclusions"]["checked"] == 0
    assert st["gang_batches"] == 1
    g = _gang_of(eng, plan)
    assert g.stats()["rank_bucket"] == 4 and g.stats()["checked"]


def test_gang_prewarm_covers_stacked_woodbury_and_checked_programs():
    """Prewarming stacks with update ranks on a guarded engine builds every
    stacked program a drifting checked gang dispatches: no build after."""
    plan, fleet, _A = _fleet(4, seed=35)
    rng = np.random.default_rng(36)
    U = (0.01 * rng.standard_normal((N, 3))).astype(np.float32)
    fleet[1].update(U, U)
    bs = _rhs(4, seed=37)
    for health in (None, HealthPolicy()):
        eng = ServeEngine(max_batch_delay=0.05, stack_sessions=True, max_stack=4,
                          health=health, device=CPU)
        try:
            eng.prewarm(fleet[0], widths=(1,), stacks=(4,), update_ranks=(3,))
            builds = profiler.compile_count()
            for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]:
                f.result(T)
            assert profiler.compile_count() == builds
            assert plan.bucket_ready(stack=(4, 1), checked=health is not None)
        finally:
            eng.close(timeout=T)


def test_gang_refresh_after_mutation():
    plan, fleet, _A = _fleet(3, seed=41)
    bs = _rhs(3, seed=42)
    eng = ServeEngine(max_batch_delay=0.05, stack_sessions=True, max_stack=4, device=CPU)
    try:
        for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]:
            f.result(T)
        g = _gang_of(eng, plan)
        r0 = g.stats()["refreshes"]
        U = (0.05 * np.random.default_rng(43).standard_normal((N, 2))).astype(np.float32)
        fleet[1].update(U, U)
        direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
        res = [f.result(T) for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]]
        assert g.stats()["refreshes"] == r0 + 1
        for r, d in zip(res, direct):
            np.testing.assert_allclose(r, d, rtol=5e-5, atol=1e-6)
        fleet[1].refactor()
        direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
        res = [f.result(T) for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]]
        assert g.stats()["refreshes"] == r0 + 2
        for r, d in zip(res, direct):
            np.testing.assert_allclose(r, d, rtol=5e-5, atol=1e-6)
    finally:
        eng.close(timeout=T)


def test_gang_slot_reuse_after_release_and_collection():
    """A released slot (a device move) and a garbage-collected member's
    slot are reused by the next adoptee: the capacity does not grow."""
    plan, fleet, A = _fleet(4, seed=51)
    bs = _rhs(4, seed=52)
    eng = ServeEngine(max_batch_delay=0.05, stack_sessions=True, max_stack=8, device=CPU)
    try:
        for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]:
            f.result(T)
        g = _gang_of(eng, plan)
        assert g.members == 4 and g.cap == 4
        slot1 = fleet[1]._gang_slot
        with fleet[1]._lock:
            g.release(fleet[1])
        assert fleet[1]._gang is None and g.members == 3
        extra = plan.factor(A[0], device=CPU)
        for f in [eng.submit(s, bs[0]) for s in (fleet[0], fleet[2], extra)]:
            f.result(T)
        assert g.cap == 4 and extra._gang_slot == slot1
        slot3 = fleet[3]._gang_slot
        fleet[3] = None
        gc.collect()
        assert g.members == 3
        newcomer = plan.factor(A[2], device=CPU)
        futs = [eng.submit(s, bs[0]) for s in (fleet[0], extra, newcomer)]
        for f in futs:
            f.result(T)
        assert g.cap == 4 and newcomer._gang_slot == slot3
        assert g.stats()["releases"] == 2
    finally:
        eng.close(timeout=T)


def test_gang_stack_cap_exclusion_counted():
    plan, fleet, _A = _fleet(3, seed=61)
    bs = _rhs(3, seed=62)
    direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, max_stack=2, device=CPU)
    res = _one_window(eng, fleet, bs)
    for r, d in zip(res, direct):
        np.testing.assert_allclose(r, d, rtol=2e-5, atol=1e-6)
    st = eng.stats()
    assert st["stack_exclusions"]["stack_cap"] >= 1 and st["gang"]["sessions"] == 2


def test_gang_counted_exclusions_qr_and_tier():
    """QR plans and tier-routed requests never stack: counted exclusions,
    answered solo."""
    plan, fleet, _A = _fleet(2, seed=63)
    bs = _rhs(2, seed=64)
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, device=CPU)
    try:
        futs = [eng.submit(s, b, precision="f32") for s, b in zip(fleet, bs)]
    finally:
        eng.close(timeout=T)
    for s, b, f in zip(fleet, bs, futs):
        np.testing.assert_allclose(f.result(0), s.solve(b, precision="f32").numpy(),
                                   rtol=2e-5, atol=1e-6)
    assert eng.stats()["stack_exclusions"]["precision"] == 2
    serve.clear_plans()
    qplan = serve.FactorPlan.create((2 * N, N), torch.float32, kind="qr")
    rng = np.random.default_rng(65)
    qs = [qplan.factor(rng.standard_normal((2 * N, N)).astype(np.float32), device=CPU)
          for _ in range(2)]
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, device=CPU)
    try:
        futs = [eng.submit(s, rng.standard_normal(2 * N).astype(np.float32)) for s in qs]
    finally:
        eng.close(timeout=T)
    assert all(f.result(0).shape == (N,) for f in futs)
    assert eng.stats()["stack_exclusions"]["kind"] == 2


def test_gang_sick_slot_isolated_gangmates_settle():
    plan, fleet, _A = _fleet(3, seed=71)
    bs = _rhs(3, seed=72)
    eng = ServeEngine(max_batch_delay=0.05, stack_sessions=True, max_stack=4,
                      health=HealthPolicy(), device=CPU)
    try:
        for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]:
            f.result(T)
        direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
        with fleet[1]._lock:  # corrupt the resident factors
            fleet[1]._factors = tuple(torch.full_like(f, float("nan"))
                                      if f.is_floating_point() else f
                                      for f in fleet[1]._factors)
            fleet[1]._gang_ver += 1
        h0 = resilience.health_stats()
        res = [f.result(T) for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]]
        h1 = resilience.health_stats()
    finally:
        eng.close(timeout=T)
    for r, d in zip(res, direct):
        np.testing.assert_allclose(r, d, rtol=5e-5, atol=1e-6)
    assert h1["gang_unhealthy_slots"] > h0["gang_unhealthy_slots"]
    assert h1["refactor_escalations"] > h0["refactor_escalations"]


def test_gang_concurrent_adopt_update_solve_hammer():
    plan, fleet, _A = _fleet(4, seed=101)
    eng = ServeEngine(max_batch_delay=0.001, stack_sessions=True, max_stack=8,
                      max_pending=4096, device=CPU)
    rng = np.random.default_rng(102)
    bs = _rhs(4, seed=103)
    errors: list = []
    stop = threading.Event()

    def submitter(idx):
        try:
            for _ in range(15):
                eng.submit(fleet[idx], bs[idx]).result(T)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def mutator():
        try:
            k = 0
            while not stop.is_set() and k < 6:
                s = fleet[k % len(fleet)]
                U = (0.01 * rng.standard_normal((N, 2))).astype(np.float32)
                s.update(U, U, replace=True)
                if k % 3 == 0:
                    s.refactor()
                k += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(len(fleet))]
    threads.append(threading.Thread(target=mutator))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        stop.set()
        assert not any(t.is_alive() for t in threads), "hammer wedged"
        assert not errors, errors
        direct = [s.solve(b).numpy() for s, b in zip(fleet, bs)]
        for f, d in zip([eng.submit(s, b) for s, b in zip(fleet, bs)], direct):
            np.testing.assert_allclose(f.result(T), d, rtol=5e-5, atol=1e-6)
    finally:
        stop.set()
        eng.close(timeout=T)


def test_unganged_session_unchanged_and_gang_detach_on_to_device():
    plan, fleet, _A = _fleet(2, seed=111)
    bs = _rhs(2, seed=112)
    eng = ServeEngine(max_batch_delay=60.0, device=CPU)
    _one_window(eng, fleet, bs)
    assert not eng.lanes[0]._gangs
    st = eng.stats()
    assert st["gang_batches"] == 0 and st["gang_opportunity"] >= 1
    eng2 = ServeEngine(max_batch_delay=60.0, stack_sessions=True, max_stack=4, device=CPU)
    _one_window(eng2, fleet, bs)
    g = _gang_of(eng2, plan)
    assert g.members == 2
    fleet[0].device = torch.device("meta")  # pretend elsewhere, so the move runs
    fleet[0].to_device(CPU)
    assert fleet[0]._gang is None and g.members == 1


def test_gang_module_refuses_batched_plans():
    serve.clear_plans()
    bplan = serve.FactorPlan.create((4, N, N), torch.float32, v=V)
    with pytest.raises(AssertionError, match="single-system"):
        bplan._stacked_solve_health_fn(2, 1)
    with pytest.raises(AssertionError, match="single-system"):
        bplan._stacked_update_solve_fn(2, 2, 1, 0)
    g = SessionGang(bplan, None)
    assert g.members == 0 and g.stats()["cap"] == 0
