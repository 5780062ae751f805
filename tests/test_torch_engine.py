"""The port's serving engine (`conflux_tpu_torch.engine.ServeEngine`, one
lane) on the CPU: twins of the reference's engine tests
(tests/test_engine.py), the placement helpers of tests/test_fleet.py,
engine-level QoS, the profiler's serving counters, the keywords that wait
for later slices, and one parity test of the port's engine against the
JAX engine on the same trace.

Bits on the CPU: the engine coalesces requests of one session into one
wider solve. On the card K3 computes each column independently of the
launch's width, so there an engine answer is bitwise the direct solve
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 25). On the CPU the
plain version's products run through torch's CPU matmul, whose summation
order within a column changes with the width (the cause of the reference
engine's one-ulp bitwise failures on the CPU), so coalesced answers are
held to allclose (rtol 1e-5, atol 1e-6) here, and bitwise where a request
rides its own width bucket alone.

Every engine is closed in a `with` or `finally`, and every wait has a
timeout.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import engine as jengine
from conflux_tpu import serve as jserve
from conflux_tpu_torch import engine as tengine
from conflux_tpu_torch import profiler, resilience, serve
from conflux_tpu_torch.engine import EngineClosed, EngineSaturated, ServeEngine
from conflux_tpu_torch.qos import QosClass
from conflux_tpu_torch.resilience import (
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    HealthPolicy,
    RhsNonFinite,
    TenantThrottled,
)

B, N, V = 4, 32, 16
T = 60  # seconds: the bound of every wait
CPU = "cpu"


def _close(a, b):
    # the CPU bar of coalesced answers (module docstring)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _systems(b, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(np.float32)


def _trace(rng, n_req, widths=(1, 2, 3, 4)):
    out = []
    for i in range(n_req):
        w = widths[i % len(widths)]
        out.append((w, rng.standard_normal((N, w) if w > 1 else (N,)).astype(np.float32)))
    return out


def _plan(shape=(N, N)):
    serve.clear_plans()
    return serve.FactorPlan.create(shape, torch.float32, v=V)


def _direct(s, b):
    return s.solve(b).numpy()


def test_engine_matches_direct_solve():
    """Mixed widths, sessions and plans (single and batched): coalesced
    answers allclose the direct solves (bitwise on the card); a batched
    request alone in its window runs the very same program, bitwise."""
    A = _systems(3, seed=41)
    Ab = _systems(B, seed=43)
    plan = _plan()
    bplan = serve.FactorPlan.create((B, N, N), torch.float32, v=V)
    sessions = [plan.factor(A[i], device=CPU) for i in range(3)]
    bsession = bplan.factor(Ab, device=CPU)
    rng = np.random.default_rng(47)
    reqs = [(sessions[i % 3], b) for i, (_w, b) in enumerate(_trace(rng, 12))]
    reqs += [(bsession, rng.standard_normal((B, N)).astype(np.float32)) for _ in range(3)]
    direct = [_direct(s, b) for s, b in reqs]
    with ServeEngine(max_batch_delay=0.05, max_coalesce_width=8, device=CPU) as eng:
        futs = [eng.submit(s, b) for s, b in reqs]
        results = [f.result(timeout=T) for f in futs]
        assert eng.stats()["batches"] < len(reqs)
    for d, r in zip(direct, results):
        assert d.shape == r.shape
        _close(r, d)
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        b1 = reqs[-1][1]
        np.testing.assert_array_equal(eng.solve(bsession, b1, timeout=T), _direct(bsession, b1))


def test_engine_prewarm_zero_builds_in_steady_state():
    plan = _plan()
    session = plan.factor(_systems(1, seed=53)[0], device=CPU)
    rng = np.random.default_rng(53)
    with ServeEngine(max_batch_delay=0.02, max_coalesce_width=4, device=CPU) as eng:
        eng.prewarm(session, widths=(1, 2, 4))
        snapshot, builds = dict(plan.trace_counts), profiler.compile_count()
        futs = [eng.submit(session, b) for _, b in _trace(rng, 16, widths=(1, 2, 1, 1))]
        for f in futs:
            f.result(timeout=T)
        assert plan.trace_counts == snapshot, "steady-state traffic built after prewarm"
        assert profiler.compile_count() == builds
        stats = eng.stats()
    assert stats["completed"] == 16 and stats["batches"] >= 1
    assert stats["coalesced_mean"] >= 1.0 and stats["queue_peak"] >= 1


def test_engine_backpressure_sheds_not_deadlocks():
    plan = _plan()
    session = plan.factor(_systems(1, seed=59)[0], device=CPU)
    b = np.ones(N, np.float32)
    eng = ServeEngine(max_batch_delay=60.0, max_pending=2, device=CPU)
    try:
        f1, f2 = eng.submit(session, b), eng.submit(session, b)
        with pytest.raises(EngineSaturated, match="max_pending") as ei:
            eng.submit(session, b)
        assert ei.value.retry_after > 0 and ei.value.tenant is None
        assert eng.stats()["shed"] == 1
    finally:
        eng.close(timeout=T)
    assert f1.done() and f2.done()
    np.testing.assert_array_equal(f1.result(0), f2.result(0))
    with pytest.raises(EngineClosed):
        eng.submit(session, b)


def test_engine_block_policy_backpressures():
    plan = _plan()
    session = plan.factor(_systems(1, seed=61)[0], device=CPU)
    rng = np.random.default_rng(61)
    futs = []
    with ServeEngine(max_batch_delay=0.0, max_pending=2, on_full="block", device=CPU) as eng:
        def pump():
            for _, b in _trace(rng, 12, widths=(1,)):
                futs.append(eng.submit(session, b))

        t = threading.Thread(target=pump)
        t.start()
        t.join(timeout=T)
        assert not t.is_alive(), "blocked submitter never released"
        for f in futs:
            f.result(timeout=T)
    assert eng.stats()["completed"] == 12 and eng.stats()["shed"] == 0


def test_engine_block_policy_submit_many_frame_no_deadlock():
    """A submit_many frame larger than max_pending under 'block' never
    deadlocks itself, and every item completes."""
    plan = _plan()
    session = plan.factor(_systems(1, seed=63)[0], device=CPU)
    rng = np.random.default_rng(63)
    items = [(session, b, None) for _, b in _trace(rng, 8, widths=(1,))]
    futs = []
    with ServeEngine(max_batch_delay=0.0, max_pending=2, on_full="block", device=CPU) as eng:
        t = threading.Thread(target=lambda: futs.extend(eng.submit_many(items)))
        t.start()
        t.join(timeout=T)
        assert not t.is_alive(), "batched frame wedged at the pending bound"
        for (s, b, _q), f in zip(items, futs):
            _close(f.result(timeout=T), _direct(s, b))
    assert eng.stats()["completed"] == 8 and eng.stats()["shed"] == 0


def test_engine_close_drains_in_flight():
    plan = _plan()
    sessions = [plan.factor(a, device=CPU) for a in _systems(2, seed=67)]
    rng = np.random.default_rng(67)
    eng = ServeEngine(max_batch_delay=60.0, device=CPU)  # everything queued at close
    try:
        pairs = [(sessions[i % 2], b) for i, (_, b) in enumerate(_trace(rng, 10))]
        futs = [eng.submit(s, b) for s, b in pairs]
    finally:
        eng.close(timeout=T)
    assert all(f.done() for f in futs), "close() dropped queued requests"
    for (s, b), f in zip(pairs, futs):
        _close(f.result(0), _direct(s, b))


def test_engine_stacked_sessions_match_direct():
    """Cross-session stacking: one dispatch answers many single-system
    sessions off the gang's stack, one stacked bucket program."""
    plan = _plan()
    sessions = [plan.factor(a, device=CPU) for a in _systems(3, seed=71)]
    rng = np.random.default_rng(71)
    bs = [rng.standard_normal((N, w)).astype(np.float32) for w in (1, 2, 2)]
    direct = [_direct(s, b) for s, b in zip(sessions, bs)]
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, max_stack=4, device=CPU)
    try:
        futs = [eng.submit(s, b) for s, b in zip(sessions, bs)]
    finally:
        eng.close(timeout=T)
    for f, d in zip(futs, direct):
        r = f.result(0)
        assert r.shape == d.shape
        np.testing.assert_allclose(r, d, rtol=2e-5, atol=1e-6)
    st = eng.stats()
    assert st["batches"] == st["gang_batches"] == 1, "stack did not coalesce"
    assert st["bucket_hits"] == {2: 1}
    bplan = serve.FactorPlan.create((B, N, N), torch.float32, v=V)
    with pytest.raises(AssertionError, match="single-system"):
        bplan._stacked_solve_fn(2, 1)


def test_engine_bad_rhs_fails_that_request_only():
    plan = _plan()
    session = plan.factor(_systems(1, seed=73)[0], device=CPU)
    good = np.ones(N, np.float32)
    with ServeEngine(max_batch_delay=0.01, device=CPU) as eng:
        with pytest.raises(ValueError, match="session needs"):
            eng.submit(session, np.zeros((N + 1,), np.float32))
        np.testing.assert_array_equal(eng.submit(session, good).result(timeout=T),
                                      _direct(session, good))


def test_engine_counters_in_serve_stats_and_windows():
    plan = _plan()
    session = plan.factor(_systems(1, seed=79)[0], device=CPU)
    b = np.ones(N, np.float32)
    with ServeEngine(max_batch_delay=0.01, device=CPU) as eng:
        win = profiler.StatsWindow(eng)
        for _ in range(4):
            eng.solve(session, b, timeout=T)
        merged = profiler.serve_stats()["engine"]
        mine = eng.stats()
        d = win.delta()
        assert d["engine"]["requests"] == d["engine"]["completed"] == 4
        assert d["engine"]["latency_samples"] == 4 and d["engine"]["backlog_delta"] == 0
        assert win.delta()["engine"]["requests"] == 0
    assert merged["engines"] >= 1
    assert merged["requests"] >= mine["requests"] >= 4
    assert merged["batches"] >= mine["batches"] >= 1
    assert merged["latency_p99_ms"] >= merged["latency_p50_ms"] > 0.0
    profiler.clear()  # phases reset, the engines' own counters survive
    assert profiler.serve_stats()["engine"]["requests"] >= 4
    cw = profiler.CounterWindow()
    cw.feed({"a": 5, "tag": "x"})
    out = cw.feed({"a": 7, "tag": "y"})
    assert out["a"] == 2 and out["tag"] == "y" and out["seconds"] > 0
    assert cw.feed({"a": 1})["a"] == 1  # a reset reports the post-reset count


def test_engine_guards_deadlines_and_staging_isolation():
    """The health policy's guards: a NaN rhs is refused at submit; a request
    poisoned after admission (the 'staging' fault site) fails alone while
    its batch-mates answer; an expired request is evicted."""
    plan = _plan()
    session = plan.factor(_systems(1, seed=83)[0], device=CPU)
    rng = np.random.default_rng(83)
    bs = [rng.standard_normal(N).astype(np.float32) for _ in range(4)]
    h0 = resilience.health_stats()
    faults = FaultPlan([FaultSpec("staging", "nan", count=1)])
    with ServeEngine(max_batch_delay=0.05, health=HealthPolicy(), fault_plan=faults,
                     device=CPU) as eng:
        bad = bs[0].copy()
        bad[3] = np.nan
        with pytest.raises(RhsNonFinite, match="admission"):
            eng.submit(session, bad)
        futs = [eng.submit(session, b) for b in bs]
        with pytest.raises(RhsNonFinite, match="staging"):
            futs[0].result(timeout=T)
        for b, f in zip(bs[1:], futs[1:]):
            np.testing.assert_array_equal(f.result(timeout=T), _direct(session, b))
    with ServeEngine(max_batch_delay=60.0, device=CPU) as eng:
        with pytest.raises(DeadlineExceeded):
            eng.solve(session, bs[0], timeout=T, deadline=0.01)
        assert eng.stats()["pending"] == 0
    h1 = resilience.health_stats()
    assert h1["rhs_rejects"] - h0["rhs_rejects"] == 1
    assert h1["evictions"] - h0["evictions"] == 1
    assert h1["survivor_redispatches"] > h0["survivor_redispatches"]


def test_engine_sick_session_escalates_and_recovers():
    """A session whose factors went bad answers through the escalation
    ladder (a forced refactor from its base) on a guarded engine."""
    plan = _plan()
    session = plan.factor(_systems(1, seed=89)[0], device=CPU)
    b = np.ones(N, np.float32)
    ref = _direct(session, b)
    with session._lock:
        session._factors = tuple(torch.full_like(f, float("nan")) if f.is_floating_point()
                                 else f for f in session._factors)
    h0 = resilience.health_stats()
    with ServeEngine(max_batch_delay=0.0, health=HealthPolicy(), device=CPU) as eng:
        np.testing.assert_allclose(eng.solve(session, b, timeout=T), ref, rtol=1e-5,
                                   atol=1e-6)
    assert resilience.health_stats()["refactor_escalations"] > h0["refactor_escalations"]
    assert session.refactors == 1


def test_refactor_never_updates_in_place_a_base_an_engine_read():
    """A refactor updates a base the session owns in place (one resident
    base at the peak), but not once an engine lane has read it: the lane's
    queued work may still read the old base on its own stream, which a
    caller's in-place update on the default stream is not ordered before.
    The old base keeps its bits; the next refactor donates again."""
    serve.clear_plans()
    plan = serve.FactorPlan.create((N, N), torch.float32, v=V, refine=1)
    session = plan.factor(_systems(1, seed=95)[0], device=CPU)
    rng = np.random.default_rng(96)

    def drift_and_refactor():
        U, W = (0.02 * rng.standard_normal((N, 2)).astype(np.float32) for _ in range(2))
        session.update(U, W)
        old = session._A0
        before = old.clone()
        session.refactor()
        return old, before

    drift_and_refactor()  # the base is the session's own from here on
    old, before = drift_and_refactor()
    assert session._A0 is old  # no engine read it: updated in place
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        eng.solve(session, np.ones(N, np.float32), timeout=T)
        old, before = drift_and_refactor()
        assert session._A0 is not old and torch.equal(old, before)
    old, before = drift_and_refactor()
    assert session._A0 is old  # the new base was never read by a lane


def test_engine_qos_classified_answers_and_throttles():
    """QoS classes route and meter, never change programs: a classified
    answer equals the unclassified one; an over-share tenant on a
    contended engine is throttled with structured attributes."""
    plan = _plan()
    session = plan.factor(_systems(1, seed=97)[0], device=CPU)
    b = np.ones(N, np.float32)
    gold = QosClass(tenant="gold", tier="latency", slo=0.5, weight=8.0)
    bulk = QosClass(tenant="bulk", tier="batch", priority=1, weight=0.01)
    with ServeEngine(max_batch_delay=60.0, max_pending=8, device=CPU) as eng:
        assert "qos" not in eng.counters()
        eng.set_knobs(max_batch_delay=0.0)
        x_plain = eng.solve(session, b, timeout=T)
        np.testing.assert_array_equal(eng.solve(session, b, qos=gold, timeout=T), x_plain)
        eng.set_knobs(max_batch_delay=60.0, qos_contention=0.25)
        futs, throttled = [], None
        for _ in range(8):
            try:
                futs.append(eng.submit(session, b, qos=bulk))
            except TenantThrottled as e:
                throttled = e
                break
            except EngineSaturated:
                break
        assert throttled is not None
        assert throttled.tenant == "bulk" and throttled.qos_class == "bulk/batch"
        assert throttled.retry_after >= 0
        eng.set_knobs(max_batch_delay=0.0)
        eng.submit(session, b)  # wakes the parked window
        for f in futs:  # coalesced into one wider bucket: the CPU bar
            _close(f.result(timeout=T), x_plain)
        st = eng.stats()["qos"]
    assert st["classes"]["gold/latency"]["completed"] == 1
    assert st["classes"]["bulk/batch"]["throttled"] == 1
    assert st["tenants"]["bulk"]["pending"] == 0
    assert profiler.qos_stats()["engines"] >= 1


def test_engine_knobs_and_unported_keywords():
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        k = eng.set_knobs(stack_sessions=True, max_stack=4)
        assert k["stack_sessions"] and k["max_stack"] == 4
        assert eng.knobs() == k and k["lanes"] == 1
        assert eng.set_knobs(lane=0, max_batch_delay=0.001)["lane_delays"] == {0: 0.001}
        with pytest.raises(ValueError, match="max_stack"):
            eng.set_knobs(max_stack=0)
        with pytest.raises(ValueError, match="lane"):
            eng.set_knobs(lane=0, max_batch_delay=0.001, stack_sessions=True)
        # ported since: checkpoint needs a fleet (sessions= or a residency)
        with pytest.raises(ValueError, match="residency"):
            eng.checkpoint("x")
    from conflux_tpu_torch.control import AdaptiveController
    from conflux_tpu_torch.tier import ResidentSet

    rs, ctl = ResidentSet(), AdaptiveController(interval=60.0)
    with ServeEngine(device=CPU, residency=rs, controller=ctl) as eng:
        assert rs.engine is eng and "tier" in eng.stats() and "controller" in eng.stats()
    for kw, what in (({"lanes": 2}, "mesh lane"), ({"lanes": "auto"}, "mesh lane"),
                     ({"devices": ["cpu", "cpu"]}, "mesh lane")):
        with pytest.raises(NotImplementedError, match=what):
            ServeEngine(device=CPU, **kw)
    with ServeEngine(devices=["cpu"]) as eng:
        assert eng.devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        # entry points run on the card unless asked for the CPU: no card, no engine
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine()


@pytest.mark.parametrize("mod", [jengine, tengine], ids=["jax", "torch"])
def test_rendezvous_is_deterministic_and_remaps_only_the_removed_node(mod):
    """The placement helpers of tests/test_fleet.py, over both copies: the
    same (sid, node set) always picks the same node, ranked order heads
    with it, and removing a node remaps only the sids it owned."""
    nodes = [f"host-{i}" for i in range(8)]
    sids = [f"user-{i}" for i in range(200)]
    before = {sid: mod.rendezvous(sid, nodes) for sid in sids}
    assert before == {sid: mod.rendezvous(sid, list(reversed(nodes))) for sid in sids}
    for sid in sids[:20]:
        ranked = mod.rendezvous_ranked(sid, nodes)
        assert ranked[0] == before[sid] and sorted(ranked) == sorted(nodes)
        assert mod.rendezvous_ranked(sid, nodes, k=3) == ranked[:3]
    survivors = [n for n in nodes if n != "host-3"]
    moved = [sid for sid in sids if mod.rendezvous(sid, survivors) != before[sid]]
    assert moved == [sid for sid in sids if before[sid] == "host-3"]
    assert 0 < len(moved) < len(sids)


def test_rendezvous_agrees_across_the_two_copies():
    nodes = [f"n{i}" for i in range(5)]
    for sid in range(64):
        assert tengine.rendezvous(sid, nodes) == jengine.rendezvous(sid, nodes)
        assert tengine.rendezvous_ranked(sid, nodes) == jengine.rendezvous_ranked(sid, nodes)


def test_place_session_over_card_identities():
    devs = [torch.device("cuda", i) for i in range(8)]
    sids = [f"user-{i}" for i in range(64)]
    first = {sid: tengine.place_session(sid, devs) for sid in sids}
    assert first == {sid: tengine.place_session(sid, devs) for sid in sids}
    assert len({str(d) for d in first.values()}) > 1
    assert tengine.place_session("x", devs[:1]) is devs[0]
    survivors = devs[:3] + devs[4:]
    moved = [s for s in sids if tengine.place_session(s, survivors) != first[s]]
    assert moved == [s for s in sids if first[s] == devs[3]]
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        assert eng.placement("user-42") == torch.device("cpu")


def test_engine_trace_matches_the_jax_engine():
    """The same mixed-width, mixed-plan trace through the JAX engine and the
    port's engine, on the same factors (`session_from_numpy`): answers
    allclose at 1e-5 relative."""
    serve.clear_plans()
    jserve.clear_plans()
    A = _systems(2, seed=101)
    Ab = _systems(B, seed=103)
    jp = jserve.FactorPlan.create((N, N), jnp.float32, v=V)
    jbp = jserve.FactorPlan.create((B, N, N), jnp.float32, v=V)
    tp = serve.FactorPlan.create((N, N), torch.float32, v=V)
    tbp = serve.FactorPlan.create((B, N, N), torch.float32, v=V)
    js = [jp.factor(jnp.asarray(a)) for a in A] + [jbp.factor(jnp.asarray(Ab))]
    ts = [serve.session_from_numpy(p, [np.asarray(f) for f in s.factors], a, device=CPU)
          for p, s, a in ((tp, js[0], A[0]), (tp, js[1], A[1]), (tbp, js[2], Ab))]
    rng = np.random.default_rng(107)
    trace = []
    for i in range(15):
        k = i % 3
        w = (1, 2, 3, 4, 1)[i % 5]
        lead = (B, N) if k == 2 else (N,)
        trace.append((k, rng.standard_normal(lead if w == 1 else lead + (w,))
                      .astype(np.float32)))
    jeng = jengine.ServeEngine(max_batch_delay=0.05, max_coalesce_width=8)
    try:
        jfuts = [jeng.submit(js[k], jnp.asarray(b)) for k, b in trace]
        jx = [np.asarray(f.result(timeout=T)) for f in jfuts]
    finally:
        jeng.close(timeout=T)
    with ServeEngine(max_batch_delay=0.05, max_coalesce_width=8, device=CPU) as eng:
        tx = [f.result(timeout=T) for f in [eng.submit(ts[k], b) for k, b in trace]]
    for a, b in zip(tx, jx):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
