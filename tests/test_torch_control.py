"""The adaptive controller in the port (`conflux_tpu_torch.control`) on the
CPU: twins of the reference's tests/test_control.py, of the controller case
of tests/test_gang.py and of the operating-point and controller cases of
tests/test_qos.py, and the decision sequences of both packages' controllers
on one synthetic delta stream, which must be equal (same knob, same old and
new values).

The controller is driven through `step()` with scripted windows
(`AdaptiveController.blank_delta` edits), never through wall-clock loops,
except the one lifecycle test that waits for two real ticks. Every engine
runs with ``device="cpu"`` and is closed in a `with` or `finally`.
"""

import copy
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import control as jcontrol
from conflux_tpu import engine as jengine
from conflux_tpu import resilience as jresilience
from conflux_tpu import serve as jserve
from conflux_tpu_torch import control, profiler, resilience, serve
from conflux_tpu_torch.control import AdaptiveController, ControlLimits
from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
from conflux_tpu_torch.qos import QosClass
from conflux_tpu_torch.resilience import HealthPolicy, RhsNonFinite

N, V = 32, 16
CPU = "cpu"
T = 60


def _A(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)


def _session(seed=0, v=V):
    plan = serve.FactorPlan.create((N, N), torch.float32, v=v)
    return plan, plan.factor(_A(seed), device=CPU)


def _eng(**kw):
    return ServeEngine(device=CPU, **kw)


class _FakeWindow:
    """A scripted StatsWindow: yields each delta once, then repeats the
    last."""

    def __init__(self, deltas):
        self.deltas = list(deltas)

    def delta(self):
        if len(self.deltas) > 1:
            return self.deltas.pop(0)
        return self.deltas[0]


def _ctl(eng, mod=control, **kw):
    kw.setdefault("slo_p99_ms", 25.0)
    kw.setdefault("interval", 60.0)  # never ticks on its own
    ctl = mod.AdaptiveController(**kw)
    ctl.attach(eng)
    return ctl


# --------------------------------------------------------------------- #
# the opt-in contract
# --------------------------------------------------------------------- #


def test_controller_none_default_unchanged():
    serve.clear_plans()
    _plan, s = _session(seed=3)
    b = np.ones((N, 1), np.float32)
    with _eng(max_batch_delay=0.01) as eng:
        x = eng.solve(s, b, timeout=T)
        st = eng.stats()
        names = {t.name for t in threading.enumerate()}
    assert "controller" not in st
    assert "serve-engine-controller" not in names
    np.testing.assert_array_equal(x, s.solve(b).numpy())


def test_controller_lifecycle_and_stats():
    serve.clear_plans()
    _plan, s = _session(seed=5)
    ctl = AdaptiveController(slo_p99_ms=25.0, interval=0.01)
    eng = _eng(max_batch_delay=0.0, controller=ctl)
    try:
        eng.solve(s, np.ones((N, 1), np.float32), timeout=T)
        wait = threading.Event()
        for _ in range(500):  # wait for a couple of real ticks
            if ctl.stats()["ticks"] >= 2:
                break
            wait.wait(0.01)
        st = eng.stats()
        assert st["controller"]["ticks"] >= 2
        assert st["controller"]["errors"] == 0
        assert st["knobs"]["max_batch_delay"] == eng.max_batch_delay
    finally:
        eng.close(timeout=T)
    assert not ctl._thread.is_alive(), "close() left the controller running"
    eng.close()  # idempotent with the controller attached


def test_attach_twice_raises():
    with _eng(max_batch_delay=0.0) as e1, _eng(max_batch_delay=0.0) as e2:
        ctl = AdaptiveController()
        ctl.attach(e1)
        with pytest.raises(RuntimeError, match="already attached"):
            ctl.attach(e2)


# --------------------------------------------------------------------- #
# knob setters and retry_after
# --------------------------------------------------------------------- #


def test_set_knobs_validates_and_buckets():
    with _eng(max_batch_delay=0.002) as eng:
        with pytest.raises(ValueError, match="max_batch_delay"):
            eng.set_knobs(max_batch_delay=-1.0)
        with pytest.raises(ValueError, match=">= 1"):
            eng.set_knobs(max_pending=0)
        with pytest.raises(ValueError, match="staging_stride"):
            eng.set_knobs(staging_stride=0)
        k = eng.set_knobs(max_batch_delay=0.004, max_pending=99, max_factor_batch=9)
        assert k["max_batch_delay"] == 0.004
        assert k["max_pending"] == 99
        assert k["max_factor_batch"] == 16  # rounds to its pow2 bucket
        assert eng.knobs() == k


def test_retry_after_measured_drain_rate_with_fallback():
    serve.clear_plans()
    _plan, s = _session(seed=7)
    b = np.ones(N, np.float32)
    eng = _eng(max_batch_delay=60.0, max_pending=2)  # parks the dispatcher
    try:
        eng.submit(s, b)
        eng.submit(s, b)
        with pytest.raises(EngineSaturated, match="backoff") as ei:
            eng.submit(s, b)
        assert ei.value.retry_after == pytest.approx(1e-3)
        eng.set_knobs(drain_rate=100.0)
        with pytest.raises(EngineSaturated, match="drain rate") as ei:
            eng.submit(s, b)
        assert ei.value.retry_after == pytest.approx(2 / 100.0)
    finally:
        eng.close(timeout=T)


# --------------------------------------------------------------------- #
# decision blocks, through step() on scripted windows
# --------------------------------------------------------------------- #


def test_delay_shrinks_when_p99_near_slo():
    with _eng(max_batch_delay=0.008) as eng:
        ctl = _ctl(eng)
        d = AdaptiveController.blank_delta()
        d["engine"].update(latency_samples=64, latency_p99_ms=24.0, requests=64,
                           completed=64, batches=8, coalesced_requests=64,
                           coalesced_mean=8.0)
        ctl._window = _FakeWindow([d])
        ctl.step()
        assert eng.max_batch_delay == pytest.approx(0.004)
        ctl.step()
        assert eng.max_batch_delay == pytest.approx(0.002)
        assert any(e["knob"] == "max_batch_delay" and "shrink" in e["reason"]
                   for e in ctl.stats()["decisions_log"])


def test_delay_widens_when_under_coalesced_and_backlogged():
    with _eng(max_batch_delay=0.0) as eng:
        ctl = _ctl(eng)
        d = AdaptiveController.blank_delta()
        d["engine"].update(latency_samples=64, latency_p99_ms=3.0, requests=100,
                           completed=60, batches=60, coalesced_requests=60,
                           coalesced_mean=1.0, backlog_delta=40, pending=40)
        ctl._window = _FakeWindow([d])
        ctl.step()  # one window of pressure is a clump, not a regime
        assert eng.max_batch_delay == 0.0
        ctl.step()
        first = eng.max_batch_delay
        assert first > 0.0
        ctl.step()
        assert eng.max_batch_delay > first
        assert eng.max_batch_delay <= ctl.limits.max_batch_delay


def test_delay_decays_on_light_solo_traffic():
    with _eng(max_batch_delay=0.008) as eng:
        ctl = _ctl(eng)
        d = AdaptiveController.blank_delta()
        d["engine"].update(latency_samples=10, latency_p99_ms=9.0, requests=10,
                           completed=10, batches=10, coalesced_requests=10,
                           coalesced_mean=1.0, backlog_delta=0, pending=0)
        ctl._window = _FakeWindow([d])
        ctl.step()
        assert eng.max_batch_delay == pytest.approx(0.004)


def test_max_pending_sized_from_drain_rate_with_deadband():
    with _eng(max_batch_delay=0.0, max_pending=1024) as eng:
        ctl = _ctl(eng, pending_slack=1.5)
        d = AdaptiveController.blank_delta(seconds=1.0)
        d["engine"].update(requests=1000, completed=1000, batches=100,
                           coalesced_requests=1000, coalesced_mean=10.0,
                           latency_samples=100, latency_p99_ms=5.0)
        ctl._window = _FakeWindow([d])
        ctl.step()
        assert eng.max_pending == 37  # 1000/s x 25 ms x 1.5
        assert eng.knobs()["drain_rate"] == pytest.approx(1000.0)
        before = eng.max_pending
        ctl.step()  # the same window: inside the deadband
        assert eng.max_pending == before
        assert len([e for e in ctl.stats()["decisions_log"]
                    if e["knob"] == "max_pending"]) == 1


def test_width_growth_is_prewarm_gated_and_compile_free_at_switch():
    """The cap grows only onto a bucket `bucket_ready` reports warm, and
    the switch is build-free: no kernel build and no new program between
    the bucket's readiness and the cap move, nor under traffic after it."""
    serve.clear_plans()
    plan, s = _session(seed=11)
    with _eng(max_batch_delay=0.0, max_coalesce_width=4) as eng:
        eng.prewarm(s, widths=(1, 2, 4))
        b = np.ones((N, 1), np.float32)
        eng.solve(s, b, timeout=T)  # registers the session
        ctl = _ctl(eng, grow_after=1, limits=ControlLimits(max_coalesce_width=8))
        d = AdaptiveController.blank_delta()
        d["engine"].update(requests=50, completed=50, batches=20, coalesced_requests=50,
                           coalesced_mean=2.5, width_capped=10, latency_samples=50,
                           latency_p99_ms=2.0)
        ctl._window = _FakeWindow([d])
        assert not plan.bucket_ready(width=8)
        ctl.step()  # launches the background prewarm; the cap stays
        assert eng.max_coalesce_width == 4
        pre = ctl._width_prewarm
        assert pre is not None and pre[0] == 8
        pre[1].join(timeout=120)
        assert plan.bucket_ready(width=8), "prewarm did not warm bucket 8"
        snapshot, builds = dict(plan.trace_counts), profiler.compile_count()
        ctl.step()  # the prewarm is done: the cap moves, making nothing
        assert eng.max_coalesce_width == 8
        assert plan.trace_counts == snapshot, "the knob move made a program"
        assert profiler.compile_count() == builds
        for f in [eng.submit(s, b) for _ in range(8)]:
            f.result(timeout=T)
        assert plan.trace_counts == snapshot


def test_width_retirement_releases_cold_bucket_programs():
    serve.clear_plans()
    plan, s = _session(seed=13)
    with _eng(max_batch_delay=0.0, max_coalesce_width=4) as eng:
        rng = np.random.default_rng(13)
        for w in (1, 4):
            eng.solve(s, rng.standard_normal((N, w)).astype(np.float32), timeout=T)
        assert {1, 4} <= set(plan._solve_cache)
        ctl = _ctl(eng, retire_after=2)
        hot = AdaptiveController.blank_delta()
        hot["engine"].update(requests=6, completed=6, batches=6, coalesced_requests=6,
                             coalesced_mean=1.0)
        hot["bucket_hits"] = {1: 3, 4: 3}
        cold = AdaptiveController.blank_delta()
        cold["engine"].update(requests=3, completed=3, batches=3, coalesced_requests=3,
                              coalesced_mean=1.0)
        cold["bucket_hits"] = {1: 3}
        ctl._window = _FakeWindow([hot, cold])
        ctl.step()
        assert 4 in plan._solve_cache
        ctl.step()  # bucket 4 cold x1
        assert 4 in plan._solve_cache
        ctl.step()  # cold x2 == retire_after: retired
        assert 4 not in plan._solve_cache and 1 in plan._solve_cache
        assert eng.max_coalesce_width == 1
        x = eng.solve(s, rng.standard_normal((N, 4)).astype(np.float32), timeout=T)
        assert x.shape == (N, 4)  # retirement is eviction, not prohibition


def test_health_relaxes_after_calm_and_restores_instantly_on_trip():
    serve.clear_plans()
    _plan, s = _session(seed=17)
    strict = HealthPolicy(submit_guard_sample=4096)
    with _eng(max_batch_delay=0.0, health=strict) as eng:
        eng.prewarm(s, widths=(1,))
        ctl = _ctl(eng, relax_health_after=3)
        ctl._window = _FakeWindow([AdaptiveController.blank_delta()])
        for _ in range(3):
            assert eng.health is strict
            ctl.step()
        assert eng.health is not strict
        assert eng.health.submit_guard_sample == ctl.limits.relaxed_guard_sample
        assert eng._staging_stride == ctl.limits.staging_stride
        assert ctl.stats()["relaxed_guards"] is True
        bad = np.ones(N, np.float32)
        bad[0] = np.nan
        with pytest.raises(RhsNonFinite):
            eng.submit(s, bad)
        assert eng.health is strict  # restored on the tripping thread
        assert eng._staging_stride == 1
        tripped = AdaptiveController.blank_delta()
        tripped["health"] = {"rhs_rejects": 1}
        ctl._window = _FakeWindow([tripped])
        ctl.step()
        assert ctl.stats()["relaxed_guards"] is False
        good = np.ones(N, np.float32)
        np.testing.assert_array_equal(eng.solve(s, good, timeout=T), s.solve(good).numpy())


def test_knob_moves_compile_nothing():
    serve.clear_plans()
    plan, s = _session(seed=19)
    with _eng(max_batch_delay=0.002, max_coalesce_width=4) as eng:
        eng.prewarm(s, widths=(1, 2, 4))
        b = np.ones((N, 1), np.float32)
        eng.solve(s, b, timeout=T)
        snapshot, builds = dict(plan.trace_counts), profiler.compile_count()
        ctl = _ctl(eng)
        busy = AdaptiveController.blank_delta()
        busy["engine"].update(requests=100, completed=60, batches=60, coalesced_requests=60,
                              coalesced_mean=1.0, backlog_delta=40, pending=40,
                              latency_samples=60, latency_p99_ms=30.0)
        ctl._window = _FakeWindow([busy])
        for _ in range(4):
            ctl.step()
        for f in [eng.submit(s, b) for _ in range(8)]:
            f.result(timeout=T)
        assert plan.trace_counts == snapshot
        assert profiler.compile_count() == builds


# --------------------------------------------------------------------- #
# FactorPlan.release_buckets and bucket_ready, against the JAX plan
# --------------------------------------------------------------------- #


def test_release_buckets_grow_then_shrink_leaves_no_stale_programs():
    serve.clear_plans()
    plan, s = _session(seed=23)
    jserve.clear_plans()
    jplan = jserve.FactorPlan.create((N, N), jnp.float32, v=V)
    js = jplan.factor(jnp.asarray(_A(23)))
    rng = np.random.default_rng(23)
    for w in (1, 2, 4, 8):
        b = rng.standard_normal((N, w)).astype(np.float32)
        np.testing.assert_allclose(s.solve(b).numpy(), np.asarray(js.solve(b)),
                                   rtol=1e-5, atol=1e-5)
    assert set(plan._solve_cache) == set(jplan._solve_cache) == {1, 2, 4, 8}
    for p in (plan, jplan):
        assert p.release_buckets(widths=(4, 8)) == 2
        assert set(p._solve_cache) == {1, 2}
        assert p.release_buckets(widths=(4, 8)) == 0
        p._stacked_factor_fn(2)
        assert p.release_buckets(factor_batches=(2,)) == 1
        with pytest.raises(ValueError, match="bucket 1"):
            p.release_buckets(factor_batches=(1,))
    assert s.solve(rng.standard_normal((N, 8)).astype(np.float32)).shape == (N, 8)


def test_bucket_ready_reflects_warmth():
    serve.clear_plans()
    plan, s = _session(seed=29)
    assert not plan.bucket_ready(width=2) and not plan.bucket_ready()
    s.solve(np.ones((N, 2), np.float32))
    assert plan.bucket_ready(width=2)
    assert not plan.bucket_ready(width=2, checked=True)
    s.solve_checked(np.ones((N, 2), np.float32))
    assert plan.bucket_ready(width=2, checked=True)
    assert not plan.bucket_ready(factor_batch=2)
    plan._stacked_factor_fn(2)  # built but never called: not ready
    assert not plan.bucket_ready(factor_batch=2)


# --------------------------------------------------------------------- #
# the windowed profiler API
# --------------------------------------------------------------------- #


def test_stats_window_engine_deltas_and_tokens():
    serve.clear_plans()
    _plan, s = _session(seed=31)
    b = np.ones((N, 1), np.float32)
    with _eng(max_batch_delay=0.0) as eng:
        for f in [eng.submit(s, b) for _ in range(4)]:
            f.result(timeout=T)
        w = profiler.StatsWindow(eng)  # baseline after the first 4
        for f in [eng.submit(s, b) for _ in range(3)]:
            f.result(timeout=T)
        d = w.delta()
        assert d["engine"]["completed"] == 3 and d["engine"]["requests"] == 3
        assert d["engine"]["latency_samples"] == 3
        assert d["engine"]["latency_p50_ms"] > 0.0
        d2 = w.delta()
        assert d2["engine"]["completed"] == 0
        assert d2["engine"]["latency_samples"] == 0
        assert d2["engine"]["latency_p99_ms"] == 0.0
        assert eng.stats()["completed"] == 7
        assert "tier" in d2 and "tier_gauges" in d2  # the controller's input shape


def test_stats_window_concurrent_writers_sum_to_cumulative():
    profiler.clear()
    w = profiler.StatsWindow()
    h0 = resilience.health_stats()["rhs_rejects"]
    c0 = profiler.serve_stats()["solve"]["count"]
    PER, WORKERS = 200, 4
    stop = threading.Event()
    sums = {"rhs_rejects": 0, "solve": 0}

    def hammer():
        for _ in range(PER):
            resilience.bump("rhs_rejects")
            with profiler.region("serve.solve"):
                pass

    def window_taker():
        while not stop.is_set():
            d = w.delta()
            sums["rhs_rejects"] += d["health"].get("rhs_rejects", 0)
            sums["solve"] += d["phases"]["solve"]["count"]

    ts = [threading.Thread(target=hammer) for _ in range(WORKERS)]
    taker = threading.Thread(target=window_taker)
    taker.start()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    stop.set()
    taker.join(timeout=120)
    d = w.delta()
    sums["rhs_rejects"] += d["health"].get("rhs_rejects", 0)
    sums["solve"] += d["phases"]["solve"]["count"]
    assert sums["rhs_rejects"] == sums["solve"] == WORKERS * PER
    assert resilience.health_stats()["rhs_rejects"] - h0 == WORKERS * PER
    assert profiler.serve_stats()["solve"]["count"] - c0 == WORKERS * PER
    profiler.clear()


def test_stats_window_clear_clamps_not_negates():
    profiler.clear()
    w = profiler.StatsWindow()
    for _ in range(5):
        resilience.bump("rhs_rejects")
    assert w.delta()["health"]["rhs_rejects"] == 5
    for _ in range(3):
        resilience.bump("rhs_rejects")
    profiler.clear()
    for _ in range(2):
        resilience.bump("rhs_rejects")
    d = w.delta()
    assert d["health"]["rhs_rejects"] == 2
    assert all(v >= 0 for v in d["health"].values())
    assert resilience.health_stats()["rhs_rejects"] == 2
    profiler.clear()


# --------------------------------------------------------------------- #
# gang stacking steered by the controller (tests/test_gang.py)
# --------------------------------------------------------------------- #


def test_controller_steers_stacking_prewarm_gated():
    serve.clear_plans()
    plan = serve.FactorPlan.create((N, N), torch.float32, v=V)
    fleet = [plan.factor(_A(91 + i), device=CPU) for i in range(2)]
    eng = _eng(max_batch_delay=0.0)
    ctl = AdaptiveController(slo_p99_ms=25.0, interval=60.0, stack_after=2, unstack_after=2)
    ctl.attach(eng)
    try:
        eng.solve(fleet[0], np.ones((N, 1), np.float32), timeout=T)
        opp = AdaptiveController.blank_delta()
        opp["engine"]["gang_opportunity"] = 4
        opp["engine"]["batches"] = 4
        opp["bucket_hits"] = {1: 4}
        ctl._window = _FakeWindow([opp])
        assert not eng.stack_sessions
        ctl.step()  # pressure 1
        ctl.step()  # pressure 2: background prewarm launched
        pre = ctl._stack_prewarm
        assert pre is not None
        target, wb, thread = pre
        thread.join(120)
        assert plan.bucket_ready(stack=(target, wb))
        builds = profiler.compile_count()
        ctl.step()  # the gate passes: the knob flips
        assert eng.stack_sessions
        assert eng.max_stack == target == 4
        assert profiler.compile_count() == builds
        idle = AdaptiveController.blank_delta()
        idle["engine"]["batches"] = 3
        idle["engine"]["gang_batches"] = 0
        ctl._window = _FakeWindow([idle])
        ctl.step()
        ctl.step()
        assert not eng.stack_sessions
        assert "stack_sessions" in [d["knob"] for d in ctl.stats()["decisions_log"]]
    finally:
        eng.close(timeout=T)


# --------------------------------------------------------------------- #
# the operating-point store and QoS steering (tests/test_qos.py)
# --------------------------------------------------------------------- #


def test_operating_point_store_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("CONFLUX_TPU_TORCH_OPERATING_POINT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert control.operating_point_path() == os.path.join(
        str(tmp_path), ".cache", "conflux_tpu_torch", "operating_point.json")
    # the JAX package's override names the JAX store, never the port's
    monkeypatch.setenv("CONFLUX_TPU_OPERATING_POINT", str(tmp_path / "jax.json"))
    assert control.operating_point_path() != str(tmp_path / "jax.json")
    monkeypatch.setenv("CONFLUX_TPU_TORCH_OPERATING_POINT", str(tmp_path / "port.json"))
    assert control.operating_point_path() == str(tmp_path / "port.json")


def test_operating_point_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "op.json")
    monkeypatch.setenv("CONFLUX_TPU_TORCH_OPERATING_POINT", path)
    assert control.load_operating_point("r1") == {}
    control.save_operating_point("r1", {
        "max_batch_delay": 0.004, "max_pending": 256, "qos_contention": 0.3,
        "qos_tier_delay": {"batch": 0.01}, "drain_rate": 120.0, "max_coalesce_width": 64})
    assert control.load_operating_point("r1") == {
        "max_batch_delay": 0.004, "max_pending": 256, "qos_contention": 0.3,
        "qos_tier_delay": {"batch": 0.01}}
    control.save_operating_point("r2", {"max_pending": 64})
    control.save_operating_point("r1", {"max_pending": 128})
    assert control.load_operating_point("r1") == {"max_pending": 128}
    assert control.load_operating_point("r2") == {"max_pending": 64}
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == control._OP_VERSION == jcontrol._OP_VERSION
    assert len(doc["rows"]) == 2
    # the row format is the JAX package's (its reader accepts the file)
    assert jcontrol.load_operating_point("r2", path=path) == {"max_pending": 64}


def test_operating_point_rejects_malformed(tmp_path, monkeypatch):
    path = str(tmp_path / "op.json")
    monkeypatch.setenv("CONFLUX_TPU_TORCH_OPERATING_POINT", path)
    with open(path, "w") as f:
        f.write("{not json")
    assert control.load_operating_point("r") == {}
    control.save_operating_point("r", {"max_pending": 64})
    assert control.load_operating_point("r") == {"max_pending": 64}
    with open(path) as f:
        doc = json.load(f)
    doc["rows"].append({"regime": "bad", "knobs": {"max_stack": 8}, "updated": "now"})
    doc["rows"].append({"regime": "worse", "knobs": {"qos_tier_delay": {"oops": 1.0}},
                        "updated": "now"})
    with open(path, "w") as f:
        json.dump(doc, f)
    assert control.load_operating_point("bad") == {}
    assert control.load_operating_point("worse") == {}
    assert control.load_operating_point("r") == {"max_pending": 64}


def test_controller_reseeds_and_persists(tmp_path, monkeypatch):
    path = str(tmp_path / "op.json")
    monkeypatch.setenv("CONFLUX_TPU_TORCH_OPERATING_POINT", path)
    control.save_operating_point("slo25-l1", {
        "max_batch_delay": 0.004, "max_pending": 128, "qos_contention": 0.3})
    ctl = AdaptiveController(persist=True, interval=60.0)
    eng = _eng(max_batch_delay=0.0, controller=ctl)
    try:
        assert ctl._regime == "slo25-l1"
        k = eng.knobs()
        assert k["max_batch_delay"] == 0.004
        assert k["max_pending"] == 128
        assert k["qos_contention"] == 0.3
        st = ctl.stats()
        assert st["persist"]["enabled"]
        assert st["persist"]["reseeded"]["max_pending"] == 128
        eng.set_knobs(max_pending=96)
    finally:
        eng.close()
    assert control.load_operating_point("slo25-l1")["max_pending"] == 96


def test_controller_default_regime_never_persists_without_optin(tmp_path, monkeypatch):
    path = str(tmp_path / "op.json")
    monkeypatch.setenv("CONFLUX_TPU_TORCH_OPERATING_POINT", path)
    ctl = AdaptiveController(interval=60.0)  # persist=False
    eng = _eng(max_batch_delay=0.0, controller=ctl)
    try:
        assert ctl.stats()["persist"] == {"enabled": False}
    finally:
        eng.close()
    assert not os.path.exists(path)


def test_controller_steers_qos_contention_down_under_slo_pressure():
    serve.clear_plans()
    _plan, s = _session(seed=18)
    b = np.ones(N, np.float32)
    ctl = AdaptiveController(interval=60.0, min_window_samples=1)
    eng = _eng(max_batch_delay=0.0, controller=ctl)
    try:
        slow = QosClass(tenant="gold", tier="latency", slo=1e-9)
        for _ in range(3):  # every sample blows a 1 ns SLO
            eng.solve(s, b, qos=slow, timeout=T)
        before = eng.knobs()["qos_contention"]
        for _ in range(3):
            eng.solve(s, b, qos=slow, timeout=T)
            ctl.step()
        assert eng.knobs()["qos_contention"] < before
        assert any(d["knob"] == "qos_contention" for d in ctl.stats()["decisions_log"])
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# both packages' controllers on one synthetic delta stream
# --------------------------------------------------------------------- #


def _delta_stream(blank):
    """A scripted stream through every engine-local decision block: light
    solo traffic, a backlog under narrow dispatches, p99 at the SLO, a
    measured drain rate, calm windows, a guard trip."""
    out = []

    def d(seconds=0.25, health=None, **eng):
        x = copy.deepcopy(blank)
        x["seconds"] = seconds
        x["engine"].update(eng)
        if health:
            x["health"] = health
        out.append(x)

    d(requests=10, completed=10, batches=10, coalesced_requests=10, coalesced_mean=1.0,
      latency_samples=10, latency_p99_ms=2.0)
    for _ in range(3):
        d(requests=200, completed=120, batches=120, coalesced_requests=120,
          coalesced_mean=1.0, backlog_delta=80, pending=80, latency_samples=120,
          latency_p99_ms=6.0)
    d(seconds=1.0, requests=900, completed=900, batches=90, coalesced_requests=900,
      coalesced_mean=10.0, latency_samples=900, latency_p99_ms=24.0)
    d(seconds=1.0, requests=300, completed=300, batches=300, coalesced_requests=300,
      coalesced_mean=1.0, latency_samples=300, latency_p99_ms=1.0)
    for _ in range(3):
        d()
    d(health={"rhs_rejects": 2})
    d(requests=40, completed=40, batches=40, coalesced_requests=40, coalesced_mean=1.0,
      latency_samples=40, latency_p99_ms=30.0)
    return out


def test_decision_sequences_equal_the_jax_controllers():
    serve.clear_plans()
    jserve.clear_plans()
    logs = []
    for ctl_mod, eng_mod, policy in (
            (control, None, HealthPolicy(submit_guard_sample=4096)),
            (jcontrol, jengine, jresilience.HealthPolicy(submit_guard_sample=4096))):
        kw = dict(max_batch_delay=0.004, max_pending=1024, health=policy)
        eng = ServeEngine(device=CPU, **kw) if eng_mod is None else eng_mod.ServeEngine(**kw)
        try:
            ctl = _ctl(eng, ctl_mod, relax_health_after=3)
            stream = _delta_stream(ctl_mod.AdaptiveController.blank_delta())
            ctl._window = _FakeWindow(stream[:])
            for _ in stream:
                ctl.step()
            logs.append([(k, o, n) for _t, k, o, n, _r in ctl._log]
                        + [("final", None, eng.knobs()["max_batch_delay"])])
        finally:
            eng.close(timeout=T)
    port, jax_log = logs
    assert len(port) > 4
    knobs = {k for k, _o, _n in port}
    assert {"max_batch_delay", "max_pending", "health"} <= knobs
    assert port == jax_log
