"""Several lanes behind one admission front (`ServeEngine(lanes=,
devices=)`), the port's twins of `tests/test_fleet.py` and of
`test_gang.py::test_lane_pending_slice_sheds_hot_lane_only`, on the CPU.

The JAX package runs one lane per device of its 8-device CPU mesh; torch
has one CPU device, so the port runs its lanes on the CPU repeated
(`lanes=n, device="cpu"` or `devices=["cpu"] * n`), lane i keyed ("cpu",
i), the key the JAX package gives its i-th CPU device: a sid lands on the
same lane index in both packages. Within the port, a several-lane engine's
answers are bitwise the one-lane engine's on the same trace; a dead lane
fails only its own live requests and revives; pooled cold starts all
resolve, each bitwise `plan.factor`'s, and `close` drains the pool. Every
engine here uses 2-4 lanes (each lane is two threads) and closes in a
`finally` or a `with`.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import engine as jengine
from conflux_tpu_torch import profiler, resilience, serve, tier
from conflux_tpu_torch.batched import batch_mesh
from conflux_tpu_torch.engine import EngineClosed, EngineSaturated, ServeEngine, rendezvous
from conflux_tpu_torch.resilience import (
    FaultPlan,
    FaultSpec,
    HealthPolicy,
    MeshPlanUnsupported,
    RhsNonFinite,
)
from conflux_tpu_torch.tier import ResidentSet

N, V = 32, 16
CPU = "cpu"
T = 120


def _mk(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(np.float32)


def _rhs(seed, w=1):
    b = np.random.default_rng(seed).standard_normal((N, w) if w > 1 else (N,))
    return b.astype(np.float32)


def _plan():
    return serve.FactorPlan.create((N, N), torch.float32, v=V)


def _sids_on(eng, lane_index, n=1, prefix="s"):
    """The first `n` sids `eng` places on lane `lane_index`."""
    out, i = [], 0
    while len(out) < n:
        sid = f"{prefix}{i}"
        if eng.placement_lane(sid).index == lane_index:
            out.append(sid)
        i += 1
    return out


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [2, 4])
def test_place_session_deterministic_across_engines(n):
    """A pure function of (sid, lane keys): equal across engines
    ("restarts"), spread over more than one lane, and the lane index the
    JAX package's `place_session` picks over its first n devices."""
    sids = [str(i) for i in range(32)] + ["user-1", "user-2", "a-long-session-id"]
    picks = []
    for _ in range(2):
        eng = ServeEngine(max_batch_delay=0.0, lanes=n, device=CPU)
        try:
            picks.append({sid: eng.placement_lane(sid).index for sid in sids})
            assert all(eng.placement(sid) == torch.device("cpu") for sid in sids[:3])
        finally:
            eng.close(timeout=T)
    assert picks[0] == picks[1]
    assert len(set(picks[0].values())) > 1
    devs = jax.devices()[:n]
    want = {sid: devs.index(jengine.place_session(sid, devs)) for sid in sids}
    assert picks[0] == want


def test_place_session_remap_only_removed_device():
    """The rendezvous property: dropping one lane remaps only the sids
    that lane owned."""
    eng = ServeEngine(max_batch_delay=0.0, lanes=4, device=CPU)
    try:
        lanes = list(eng.lanes)
        sids = [f"user-{i}" for i in range(200)]
        before = {sid: eng._sid_lane(sid, lanes) for sid in sids}
        gone = lanes[3]
        after = {sid: eng._sid_lane(sid, [ln for ln in lanes if ln is not gone])
                 for sid in sids}
        moved = [sid for sid in sids if after[sid] is not before[sid]]
        assert moved == [sid for sid in sids if before[sid] is gone]
        assert 0 < len(moved) < len(sids)
        keyed = {sid: rendezvous(sid, [ln.key for ln in lanes]) for sid in sids}
        assert all(keyed[sid] == before[sid].key for sid in sids)
    finally:
        eng.close(timeout=T)


def test_sid_pinned_factor_and_resubmit_route_to_same_lane():
    serve.clear_plans()
    plan = _plan()
    with ServeEngine(max_batch_delay=0.0, lanes=3, device=CPU) as eng:
        want = eng.placement_lane("user-42")
        s = eng.factor(plan, _mk(1), sid="user-42", timeout=T)
        assert s.sid == "user-42" and s._lane_key == want.key
        assert s.device == torch.device("cpu")
        assert eng._lane_for(s) is want
        b = _rhs(2, 2)
        np.testing.assert_array_equal(eng.solve(s, b, timeout=T), s.solve(b).numpy())
        assert [r["batches"] for r in eng.stats()["lanes"]][want.index] == 1
    with ServeEngine(max_batch_delay=0.0, lanes=3, device=CPU) as eng2:
        assert eng2.placement_lane("user-42").index == want.index


def test_explicit_device_override_wins():
    """A session factored on a device stays there; among several lanes of
    that device its sid picks the lane, and the pin is kept."""
    serve.clear_plans()
    plan = _plan()
    s = plan.factor(_mk(3), device=CPU, sid="pinme")
    assert s.device == torch.device("cpu")
    with ServeEngine(max_batch_delay=0.0, devices=[CPU, CPU], device=CPU) as eng:
        s2 = eng.factor(plan, _mk(4), device=CPU, sid="pinned", timeout=T)
        assert s2.device == torch.device("cpu")
        assert s2._lane_key == eng.placement_lane("pinned").key
        b = _rhs(5)
        np.testing.assert_array_equal(eng.solve(s2, b, timeout=T), s2.solve(b).numpy())
        lane = eng._lane_for(s)
        assert s._lane_key == lane.key == eng.placement_lane("pinme").key
        with pytest.raises(ValueError, match="lane devices"):
            eng.submit_factor(plan, _mk(4), device="cuda:3")


# --------------------------------------------------------------------- #
# bitwise parity: several lanes vs one
# --------------------------------------------------------------------- #


def test_fleet_bitwise_parity_mixed_trace():
    """A mixed factor/update/solve trace through a 4-lane engine gives
    bitwise the one-lane engine's answers (the same staged bytes and the
    same programs on each lane)."""
    serve.clear_plans()
    plan = _plan()
    mats = [_mk(100 + i) for i in range(6)]
    widths = [1, 2, 1, 4, 1, 2]
    answers = {}
    for lanes in (1, 4):
        rng = np.random.default_rng(11)  # identical drift on both legs
        eng = ServeEngine(max_batch_delay=0.01, lanes=lanes, device=CPU)
        try:
            sessions = [eng.factor(plan, mats[i], sid=f"u{i}", timeout=T) for i in range(6)]
            for i in (1, 4):
                U = (rng.standard_normal((N, 2)) * 0.01).astype(np.float32)
                Vv = (rng.standard_normal((N, 2)) * 0.01).astype(np.float32)
                sessions[i].update(U, Vv)
            futs = [eng.submit(sessions[i], _rhs(200 + i, widths[i])) for i in range(6)]
            answers[lanes] = [f.result(T) for f in futs]
            if lanes > 1:
                assert len({s._lane_key for s in sessions}) > 1, "the trace spread"
        finally:
            eng.close(timeout=T)
    for a, b in zip(answers[1], answers[4]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# fault domains: lanes
# --------------------------------------------------------------------- #


def test_poisoned_request_fails_alone_across_lanes():
    """A request poisoned after admission fails alone; every other request
    of the trace answers bitwise its session's direct solve. Each request
    has a session of its own: two requests against one session may
    coalesce into one wider dispatch depending on the window's timing,
    and the twin holds bitwise answers that do not depend on it."""
    serve.clear_plans()
    plan = _plan()
    faults = FaultPlan([FaultSpec("staging", "nan", count=1)])
    eng = ServeEngine(max_batch_delay=0.005, lanes=3, device=CPU,
                      health=HealthPolicy(check_output=False), fault_plan=faults)
    try:
        sessions = [eng.factor(plan, _mk(20 + i), sid=f"p{i}", timeout=T) for i in range(8)]
        bs = [_rhs(300 + i) for i in range(8)]
        futs = [eng.submit(sessions[i], bs[i]) for i in range(8)]
        failed, ok = [], []
        for i, f in enumerate(futs):
            try:
                ok.append((i, f.result(timeout=T)))
            except RhsNonFinite:
                failed.append(i)
        assert len(failed) == 1, "exactly the poisoned request fails"
        for i, x in ok:
            np.testing.assert_array_equal(x, sessions[i].solve(bs[i]).numpy())
        assert len({s._lane_key for s in sessions}) > 1
    finally:
        eng.close(timeout=T)


def test_lane_thread_death_fails_only_its_lane_then_revives():
    """An injected kill on lane 0's dispatcher fails only that lane's
    pending work; the watchdog respawns the lane's workers and both the
    victim lane and the rest keep serving (the engine never closes)."""
    serve.clear_plans()
    plan = _plan()
    faults = FaultPlan([FaultSpec("dispatch", "kill", count=1)])
    eng = ServeEngine(max_batch_delay=0.0, lanes=2, device=CPU, watchdog_interval=0.05,
                      fault_plan=faults)
    try:
        (sid_a,), (sid_b,) = _sids_on(eng, 0), _sids_on(eng, 1)
        # opened outside the engine: the kill is spent by lane 0's solve
        sa = plan.factor(_mk(31), device=CPU, sid=sid_a)
        sb = plan.factor(_mk(32), device=CPU, sid=sid_b)
        lane_a, lane_b = eng.lanes
        assert eng._lane_for(sa) is lane_a and eng._lane_for(sb) is lane_b
        f_bad = eng.submit(sa, _rhs(40))
        with pytest.raises(EngineClosed, match="lane"):
            f_bad.result(timeout=30)
        b = _rhs(41)
        np.testing.assert_array_equal(eng.solve(sb, b, timeout=T), sb.solve(b).numpy())
        deadline = time.time() + 30
        while time.time() < deadline:
            if lane_a._dispatcher.is_alive() and lane_a.revives >= 1:
                break
            time.sleep(0.02)
        assert lane_a.revives >= 1 and lane_a._dispatcher.is_alive()
        assert lane_a._dispatcher.name == "serve-engine-dispatch-L0"
        b2 = _rhs(42)
        np.testing.assert_array_equal(eng.solve(sa, b2, timeout=T), sa.solve(b2).numpy())
        st = eng.stats()
        assert [ln for ln in st["lanes"] if ln["revives"]]
        h = profiler.serve_stats()["health"]
        assert h["lane_revives"] >= 1 and h["watchdog_trips"] >= 1
    finally:
        eng.close(timeout=T)


def test_lane_death_past_revive_budget_routes_around_it():
    """With no revival budget the dead lane is marked dead: its sessions
    are served by the first live lane, and the engine stays open."""
    serve.clear_plans()
    plan = _plan()
    faults = FaultPlan([FaultSpec("dispatch", "kill", count=1)])
    eng = ServeEngine(max_batch_delay=0.0, lanes=2, device=CPU, watchdog_interval=0.05,
                      fault_plan=faults, max_lane_revives=0)
    try:
        (sid_a,) = _sids_on(eng, 0)
        sa = plan.factor(_mk(33), device=CPU, sid=sid_a)
        with pytest.raises(EngineClosed, match="lane"):
            eng.submit(sa, _rhs(43)).result(timeout=30)
        deadline = time.time() + 30
        while time.time() < deadline and not eng.lanes[0].dead:
            time.sleep(0.02)
        assert eng.lanes[0].dead and not eng.lanes[1].dead
        b = _rhs(44)
        np.testing.assert_array_equal(eng.solve(sa, b, timeout=T), sa.solve(b).numpy())
        assert eng._lane_for(sa) is eng.lanes[1]
    finally:
        eng.close(timeout=T)


# --------------------------------------------------------------------- #
# prewarm: every lane, deduplicated, nothing built after
# --------------------------------------------------------------------- #


def test_prewarm_warms_every_lane_and_dedupes(monkeypatch):
    serve.clear_plans()
    plan = _plan()
    with ServeEngine(max_batch_delay=0.01, devices=[CPU] * 3, max_coalesce_width=4,
                     device=CPU) as eng:
        sids = [_sids_on(eng, i, prefix=f"w{i}-")[0] for i in range(3)]
        sessions = [eng.factor(plan, _mk(50 + i), sid=sids[i], timeout=T) for i in range(3)]
        assert [eng._lane_for(s).index for s in sessions] == [0, 1, 2]
        eng.prewarm(sessions[0], widths=(1, 2, 4), factor_batches=(2,))
        for wb in (1, 2, 4):
            for ln in eng.lanes:
                assert plan.device_warm("solve", wb, ln.key)
        for ln in eng.lanes:
            assert plan.device_warm("factor", 2, ln.key)
        # dedupe: a second prewarm (another session) dispatches nothing
        calls = []
        real = plan._solve_fn
        monkeypatch.setattr(plan, "_solve_fn", lambda nb: calls.append(nb) or real(nb))
        c0 = profiler.compile_count()
        eng.prewarm(sessions[1], widths=(1, 2, 4), factor_batches=(2,))
        assert calls == [] and profiler.compile_count() == c0
        monkeypatch.undo()
        traces0 = dict(plan.trace_counts)
        futs = [eng.submit(sessions[i % 3], _rhs(400 + i, 1 + i % 2)) for i in range(12)]
        for f in futs:
            f.result(timeout=T)
        assert profiler.compile_count() == c0, "a lane built after prewarm"
        assert plan.trace_counts == traces0
        assert len([ln for ln in eng.stats()["lanes"] if ln["batches"]]) == 3


# --------------------------------------------------------------------- #
# telemetry and knobs
# --------------------------------------------------------------------- #


def test_lane_telemetry_in_stats_counters_and_serve_stats():
    serve.clear_plans()
    plan = _plan()
    with ServeEngine(max_batch_delay=0.005, devices=[CPU, CPU], device=CPU) as eng:
        sids = [_sids_on(eng, i, prefix=f"t{i}-")[0] for i in range(2)]
        ss = [eng.factor(plan, _mk(60 + i), sid=sids[i], timeout=T) for i in range(2)]
        for i in range(6):
            eng.solve(ss[i % 2], _rhs(500 + i), timeout=T)
        cnt = eng.counters()
        rows = cnt["lanes"]
        assert [r["lane"] for r in rows] == [0, 1]
        assert all("latency_p50_ms" not in r for r in rows)
        assert sum(r["batches"] for r in rows) == cnt["batches"]
        st = eng.stats()
        for r in st["lanes"]:
            assert r["batches"] >= 1 and 0.0 <= r["occupancy"] <= 1.0
            assert r["coalesced_mean"] >= 1.0 and r["device"] == "cpu"
        merged = profiler.serve_stats()["engine"]
        assert merged["lanes"] >= 2
        assert merged["lane_batches_max"] >= merged["lane_batches_min"]
        names = {ln._dispatcher.name for ln in eng.lanes}
        assert names == {"serve-engine-dispatch-L0", "serve-engine-dispatch-L1"}


def test_set_knobs_lane_scope():
    with ServeEngine(max_batch_delay=0.002, devices=[CPU, CPU], device=CPU) as eng:
        k = eng.set_knobs(lane=1, max_batch_delay=0.01)
        assert k["lane_delays"] == {1: 0.01}
        assert eng.lanes[1].delay == 0.01 and eng.lanes[0].delay == 0.002
        assert eng.max_batch_delay == 0.002
        with pytest.raises(ValueError, match="out of range"):
            eng.set_knobs(lane=7, max_batch_delay=0.01)
        with pytest.raises(ValueError, match="exactly one knob"):
            eng.set_knobs(lane=0, max_batch_delay=0.01, max_pending=64)
        with pytest.raises(ValueError, match="exactly one knob"):
            eng.set_knobs(lane=0)
        assert eng.set_knobs(max_lane_pending=3)["max_lane_pending"] == 3
        with pytest.raises(ValueError, match="max_lane_pending"):
            eng.set_knobs(max_lane_pending=0)


def test_controller_tunes_lane_delay_independently():
    from conflux_tpu_torch.control import AdaptiveController

    serve.clear_plans()
    eng = ServeEngine(max_batch_delay=0.001, devices=[CPU, CPU], device=CPU)
    try:
        ctl = AdaptiveController(interval=60.0).attach(eng)
        d = AdaptiveController.blank_delta()
        rows = [
            {"lane": 0, "batches": 10, "coalesced_requests": 40,
             "queue_depth": 0, "delay": 0.001, "dead": False},
            {"lane": 1, "batches": 10, "coalesced_requests": 10,
             "queue_depth": 4, "delay": 0.001, "dead": False},
        ]
        base = eng.counters()

        def counters(rows=rows):
            out = dict(base)
            out["lanes"] = [dict(r) for r in rows]
            return out

        eng.counters = counters  # scripted per-lane telemetry
        ctl._decide_lane_delays(eng, d, d["engine"])  # window 1: baseline
        for n, r0, r1 in ((20, 80, 20), (30, 120, 30)):
            rows[0].update(batches=n, coalesced_requests=r0)
            rows[1].update(batches=n, coalesced_requests=r1)
            ctl._decide_lane_delays(eng, d, d["engine"])
        k = eng.knobs()
        assert 1 in k["lane_delays"] and k["lane_delays"][1] > 0.001
        assert 0 not in k["lane_delays"], "lane 0 stays on the default"
    finally:
        del eng.counters
        eng.close(timeout=T)


def test_lane_pending_slice_sheds_hot_lane_only():
    serve.clear_plans()
    plan = _plan()
    eng = ServeEngine(max_batch_delay=60.0, lanes=2, max_pending=64, max_lane_pending=2,
                      device=CPU)
    b = np.ones((N, 1), np.float32)
    futs = []
    try:
        (hot,), (cold,) = _sids_on(eng, 0), _sids_on(eng, 1)
        s0 = plan.factor(_mk(81), device=CPU, sid=hot)
        other = plan.factor(_mk(82), device=CPU, sid=cold)
        lane = eng._lane_for(s0)
        futs = [eng.submit(s0, b) for _ in range(2)]
        with pytest.raises(EngineSaturated, match="max_lane_pending"):
            eng.submit(s0, b)
        futs.append(eng.submit(other, b))  # the other lane still admits
        rows = {r["lane"]: r for r in eng.stats()["lanes"]}
        assert rows[lane.index]["sheds"] == 1 and rows[lane.index]["pending"] == 2
        assert rows[1 - lane.index]["pending"] == 1
    finally:
        eng.close(timeout=T)
    for f in futs:
        assert f.result(T) is not None
    assert eng.knobs()["max_lane_pending"] == 2
    assert all(r["pending"] == 0 for r in eng.stats()["lanes"])


# --------------------------------------------------------------------- #
# the mesh residue, tier caps, checkpoints, the cold-start pool
# --------------------------------------------------------------------- #


def test_mesh_plan_unsupported_is_residue_only():
    """The factor lane serves mesh plans; `MeshPlanUnsupported` is kept
    for the residue: moving sharded state off its mesh."""
    serve.clear_plans()
    mplan = serve.FactorPlan.create((8, N, N), torch.float32, v=V,
                                    mesh=batch_mesh([CPU] * 4))
    A = np.zeros((8, N, N), np.float32) + np.eye(N, dtype=np.float32)
    outside = "cuda:7"
    h0 = resilience.health_stats().get("mesh_plan_unsupported", 0)
    with ServeEngine(max_batch_delay=0.0, lanes=2, device=CPU) as eng:
        s = eng.factor(mplan, A, timeout=T)
        assert s.plan is mplan and s.device is None
        with pytest.raises(MeshPlanUnsupported) as ei:
            eng.submit_factor(mplan, A, device=outside)
        assert isinstance(ei.value, ValueError) and ei.value.surface == "factor_lane"
        assert eng.factor(mplan, A, device=CPU, timeout=T).plan is mplan
        # the mesh lane rides the first live lane, never the pool
        assert eng._lane_for(s) is eng.lanes[0]
    with pytest.raises(MeshPlanUnsupported) as ei:
        mplan.factor(A, device=outside)
    assert ei.value.surface == "factor"
    with pytest.raises(MeshPlanUnsupported) as ei:
        s.to_device(outside)
    assert ei.value.surface == "to_device"
    assert s.to_device(CPU) is s
    assert resilience.health_stats()["mesh_plan_unsupported"] >= h0 + 3
    assert "mesh_plan_unsupported" in profiler.serve_stats()["health"]


def test_tier_per_device_caps_count_mesh_shards_on_their_device():
    """The per-device caps with one device (torch's CPU): a mesh session
    counts against its shards' device with the sum of its shards' bytes,
    and the cap holds for the device's whole population."""
    serve.clear_plans()
    plan = _plan()
    mplan = serve.FactorPlan.create((4, N, N), torch.float32, v=V,
                                    mesh=batch_mesh([CPU] * 2))
    ms = mplan.factor(np.stack([_mk(70 + i) for i in range(4)]), device=CPU)
    singles = [plan.factor(_mk(80 + i), device=CPU, sid=f"h{i}") for i in range(4)]
    assert tier._session_devkey(ms) == ("cpu", 0)
    rs = ResidentSet(max_sessions_per_device=2, evict_batch=1)
    rs.adopt(ms)
    per = rs.stats()["per_device"]
    assert per == {"('cpu', 0)": {"sessions": 1, "bytes": ms.nbytes}}
    rs.adopt(*singles)
    for g in rs.stats()["per_device"].values():
        assert g["sessions"] <= 2
    spilled = [s for s in [ms, *singles] if s.tier != "device"]
    assert spilled
    x = spilled[0].solve(np.ones(tuple(spilled[0].plan.key.shape[:-1]), np.float32))
    assert torch.isfinite(x).all()
    for g in rs.stats()["per_device"].values():
        assert g["sessions"] <= 2


def test_checkpoint_restores_sid_for_deterministic_replacement(tmp_path):
    serve.clear_plans()
    plan = _plan()
    s = plan.factor(_mk(95), device=CPU, sid="user-7")
    tier.save_fleet(str(tmp_path / "ck"), [s])
    (r,) = tier.load_fleet(str(tmp_path / "ck"), device=CPU)
    assert r.sid == "user-7"
    with ServeEngine(max_batch_delay=0.0, lanes=3, device=CPU) as eng:
        assert eng._lane_for(r) is eng.placement_lane("user-7")


def test_pooled_cold_start_all_resolve_and_close_drains():
    """Cold starts without sid or device join the shared pool; every one
    resolves (close answers the pooled backlog), each session on a lane
    of the engine and bitwise `plan.factor`'s."""
    serve.clear_plans()
    plan = _plan()
    eng = ServeEngine(max_batch_delay=0.02, lanes=3, max_factor_batch=4, device=CPU)
    try:
        mats = [_mk(600 + i) for i in range(10)]
        futs = [eng.submit_factor(plan, a) for a in mats]
    finally:
        eng.close(timeout=T)
    sessions = [f.result(timeout=0) for f in futs]
    keys = {ln.key for ln in eng.lanes}
    b = _rhs(700)
    for a, s in zip(mats, sessions):
        assert s._lane_key in keys and s.device == torch.device("cpu")
        ref = plan.factor(a, device=CPU)
        for f, g in zip(s.factors, ref.factors):
            assert torch.equal(f, g)
        assert torch.equal(s.solve(b), ref.solve(b))
    st = eng.stats()
    assert st["factor_requests"] == 10 and st["pending"] == 0
    assert sum(r["factor_coalesced_requests"] for r in st["lanes"]) == 10
