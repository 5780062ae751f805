"""The host-only functions of `resilience.py`, parametrized over both copies
(the JAX package's `conflux_tpu.resilience` and the port's own
`conflux_tpu_torch.resilience`, which imports nothing of the JAX package):
the structured exceptions and their counters, `HealthPolicy`,
`rhs_finite`, `CircuitBreaker`/`breaker_for`, `FaultSpec`/`FaultPlan` and
the installed plan, `evaluate`/`evaluate_slots` (numpy, and in the port's
copy torch tensors), and the ladder drivers on a stub session. Both copies
must give the same results on the same inputs."""

import math

import numpy as np
import pytest
import torch

from conflux_tpu import resilience as jres
from conflux_tpu_torch import resilience as tres

COPIES = pytest.mark.parametrize("res", [jres, tres], ids=["jax", "port"])


def test_both_copies_have_the_same_surface():
    names = {n for n in dir(jres) if not n.startswith("__") and n not in ("np", "cmath",
                                                                          "math", "time",
                                                                          "threading",
                                                                          "dataclasses",
                                                                          "annotations")}
    assert names - set(dir(tres)) == set()
    assert tres.FAULT_SITES == jres.FAULT_SITES and tres.FAULT_KINDS == jres.FAULT_KINDS
    assert tres._HEALTH_KEYS == jres._HEALTH_KEYS


@COPIES
def test_counters_bump_snapshot_and_clear(res):
    res.clear_health()
    res.bump("refactor_escalations")
    res.bump("refactor_escalations", 2)
    res.bump("a_new_key")
    h = res.health_stats()
    assert h["refactor_escalations"] == 3 and h["a_new_key"] == 1 and h["unhealthy"] == 0
    h["unhealthy"] = 99  # a snapshot, not the live dict
    assert res.health_stats()["unhealthy"] == 0
    res.clear_health()
    assert all(v == 0 for v in res.health_stats().values())


@COPIES
def test_structured_exceptions_carry_evidence_and_count(res):
    res.clear_health()
    e = res.HostUnavailable("down", retry_after=1.5, host="h1")
    assert (e.retry_after, e.host) == (1.5, "h1") and isinstance(e, RuntimeError)
    w = res.WireCorrupt("torn", kind="overrun", host="h2")
    assert isinstance(w, ConnectionError) and w.kind == "overrun"
    t = res.TenantThrottled("shed", retry_after=0.1, tenant="t", qos_class="t/batch")
    f = res.FleetDegraded("few", retry_after=2.0, live=1, total=3)
    m = res.MeshPlanUnsupported("no", surface="factor")
    assert isinstance(m, ValueError) and m.surface == "factor"
    assert (t.tenant, f.live, f.total) == ("t", 1, 3)
    su = res.SolveUnhealthy("bad", {"rungs": []})
    assert su.evidence == {"rungs": []}
    assert res.RestoreCorrupt("x").evidence == {}
    assert res.SessionQuarantined("q", 3.0).retry_after == 3.0
    assert issubclass(res.InjectedKill, BaseException)
    assert not issubclass(res.InjectedKill, Exception)
    h = res.health_stats()
    for k in ("host_unavailable", "wire_corrupt", "wire_corrupt[overrun]", "tenant_throttled",
              "tenant_throttled[t/batch]", "fleet_degraded", "mesh_plan_unsupported"):
        assert h[k] == 1, k
    res.clear_health()


@COPIES
@pytest.mark.parametrize("dtype,n,limit", [(np.float32, 256, None), (np.float64, 1024, None),
                                           (np.float32, 64, 0.5)])
def test_health_policy_limits(res, dtype, n, limit):
    pol = res.HealthPolicy(residual_limit=limit)
    got = pol.resolved_residual_limit(dtype, n)
    want = limit if limit is not None else 1e4 * np.finfo(dtype).eps * math.sqrt(n)
    assert got == pytest.approx(want)
    assert got == jres.HealthPolicy(residual_limit=limit).resolved_residual_limit(dtype, n)
    assert res.HealthPolicy().resolved_residual_limit(np.int32, 100) == pytest.approx(1e4 * 1e-7
                                                                                     * 10)


@COPIES
def test_rhs_finite(res):
    b = np.ones((64, 2), np.float32)
    assert res.rhs_finite(b)
    b[50, 1] = np.nan
    assert not res.rhs_finite(b)
    assert res.rhs_finite(b, sample=10)  # the sampled guard misses it by design
    big = np.full(8, 3e38, np.float32)  # the sum overflows; the exact scan clears it
    assert res.rhs_finite(big)
    c = np.ones(4, np.complex64)
    c[2] = complex(np.inf, 0)
    assert not res.rhs_finite(c)
    assert res.rhs_finite(np.arange(5))


@COPIES
def test_breaker_sick_probe_reopens(res):
    res.clear_health()
    clock = [0.0]
    br = res.CircuitBreaker(threshold=2, cooldown=10.0, clock=lambda: clock[0])
    assert br.allow() == (True, 0.0)
    br.record_failure()
    br.record_failure()
    assert br.state == "open"
    ok, retry = br.allow()
    assert not ok and retry == pytest.approx(10.0)
    clock[0] = 11.0
    assert br.allow()[0]
    assert not br.allow()[0]
    br.record_failure()
    assert br.state == "open"
    clock[0] = 22.0
    assert br.allow()[0]
    br.record_success()
    assert br.state == "closed"
    h = res.health_stats()
    assert (h["quarantine_opened"], h["quarantine_probes"], h["quarantine_recoveries"]) == (1, 2, 1)

    class Stub:
        _breaker = None

    s = Stub()
    b1 = res.breaker_for(s, res.HealthPolicy(quarantine_after=5, quarantine_cooldown=1.0))
    assert res.breaker_for(s, res.HealthPolicy()) is b1 and b1.threshold == 5
    res.clear_health()


@COPIES
def test_fault_spec_validation_determinism_and_installed_plan(res):
    with pytest.raises(ValueError, match="unknown fault site"):
        res.FaultSpec("nowhere", "nan")
    with pytest.raises(ValueError, match="unknown fault kind"):
        res.FaultSpec("staging", "meteor")
    a = res.FaultPlan([res.FaultSpec("dispatch", "delay", prob=0.5)], seed=3)
    b = jres.FaultPlan([jres.FaultSpec("dispatch", "delay", prob=0.5)], seed=3)
    fires = [(a.fire("dispatch") is not None, b.fire("dispatch") is not None)
             for _ in range(64)]
    assert all(x == y for x, y in fires)
    assert any(x for x, _ in fires) and not all(x for x, _ in fires)
    p = res.FaultPlan([{"site": "refresh", "kind": "crash", "count": 1},
                       res.FaultSpec("refresh", "kill", count=1),
                       res.FaultSpec("solve", "unhealthy", count=2)])
    assert res.active_faults() is None
    res.maybe_fault(None, "refresh")  # no plan: a no-op
    res.install_faults(p)
    try:
        assert res.active_faults() is p
        with pytest.raises(res.InjectedFault):
            res.maybe_fault(None, "refresh")
        with pytest.raises(res.InjectedKill):
            res.maybe_fault(None, "refresh")
        res.maybe_fault(None, "refresh")  # budgets spent
        assert res.data_fault(None, "solve", "unhealthy") is not None
        assert res.data_fault(None, "solve", "nan") is None
    finally:
        res.install_faults(None)
    assert p.injected == {("refresh", "crash"): 1, ("refresh", "kill"): 1,
                          ("solve", "unhealthy"): 1}
    assert res.data_fault(None, "solve", "unhealthy") is None


@COPIES
def test_evaluate_and_evaluate_slots(res):
    v = np.array([1.0, 1e-6], np.float32)
    assert res.evaluate(v, 1e-4) == (True, True, pytest.approx(1e-6))
    assert res.evaluate(np.array([0.0, 0.0], np.float32), 1e-4)[:2] == (False, False)
    assert res.evaluate(np.array([1.0, 1.0], np.float32), 1e-4)[0] is False
    slots = np.array([[1.0, 0.0, 1.0, 1.0], [1e-7, 0.0, np.nan, 2.0]], np.float32)
    got = res.evaluate_slots(slots, 1e-4)
    assert [g[:2] for g in got] == [(True, True), (False, False), (False, True),
                                    (False, True)]
    assert [g[:2] for g in got] == [g[:2] for g in jres.evaluate_slots(slots, 1e-4)]
    if res is tres:
        # the port's verdicts are tensors: read on the host the same way
        assert res.evaluate(torch.from_numpy(v), 1e-4)[0] is True
        assert [g[:2] for g in res.evaluate_slots(torch.from_numpy(slots), 1e-4)] == \
            [g[:2] for g in got]


class _StubSession:
    """The session surface the ladder drives: refactor, solve_checked at
    a tier, refine_checked; verdicts scripted per call."""

    import threading as _threading

    def __init__(self, verdicts, tiers=(None,)):
        self._lock = self._threading.RLock()
        self.verdicts = list(verdicts)
        self.calls = []
        self.refactors = 0
        self.last_cond = 2.0
        self.update_rank = 0
        self._auto_rung = 0
        self._ckpt_ver = 0
        self.precision_escalations = 0
        self._served = tiers[0]

    def _resolve_tier(self, precision):
        return "bf16_ir" if precision in ("auto", "bf16_ir") else self._served

    def refactor(self):
        self.calls.append("refactor")
        self.refactors += 1

    def solve_checked(self, buf, precision=None):
        self.calls.append(f"solve:{precision}")
        return buf * 2, np.array(self.verdicts.pop(0), np.float32)

    def refine_checked(self, buf, x):
        self.calls.append("refine")
        return x + 1, np.array(self.verdicts.pop(0), np.float32)


@COPIES
@pytest.mark.parametrize("script,want_calls,ok", [
    ([(1.0, 0.0)], ["refactor", "solve:None"], True),
    ([(1.0, 1.0), (1.0, 0.0)], ["refactor", "solve:None", "refine"], True),
    ([(0.0, 1.0)], ["refactor", "solve:None"], False),
    ([(1.0, 1.0), (1.0, 1.0)], ["refactor", "solve:None", "refine"], False),
])
def test_escalate_rungs_on_a_stub(res, script, want_calls, ok):
    s = _StubSession(script)
    buf = np.ones((4, 1), np.float32)
    if ok:
        out = res.escalate(s, buf, res.HealthPolicy(), 1e-3)
        assert isinstance(out, np.ndarray)
    else:
        with pytest.raises(res.SolveUnhealthy) as e:
            res.escalate(s, buf, res.HealthPolicy(), 1e-3, evidence0={"finite": True,
                                                                      "residual": 5.0})
        ev = e.value.evidence
        assert ev["cond"] == 2.0 and ev["refactors"] == 1 and len(ev["rungs"]) == 1 + len(script)
    assert s.calls == want_calls


@COPIES
def test_escalate_precision_climbs_and_ratchets_on_a_stub(res):
    s = _StubSession([(1.0, 1.0), (1.0, 0.0)])
    out = res.escalate_precision(s, np.ones((4, 1), np.float32), "auto", None, 1e-3)
    assert isinstance(out, np.ndarray)
    assert s.calls == ["solve:f32", "solve:f64"]
    assert s._auto_rung == 2 and s.precision_escalations == 2 and s._ckpt_ver == 2
