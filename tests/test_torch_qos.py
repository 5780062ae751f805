"""The port's copy of the QoS policy layer (`conflux_tpu_torch/qos.py`)
held to the reference's host-only QoS tests (tests/test_qos.py, the
QosClass, collect-delay and FairShareLedger cases): each runs over both
copies, the JAX package's and the port's, on the same inputs."""

import pytest

from conflux_tpu import qos as jqos
from conflux_tpu_torch import qos as tqos


@pytest.fixture(params=[jqos, tqos], ids=["jax", "torch"])
def q(request):
    return request.param



def test_qos_class_validation(q):
    c = q.QosClass(tenant="gold", tier="latency", slo=0.025, weight=3.0)
    assert c.key == "gold/latency"
    with pytest.raises(ValueError, match="tier"):
        q.QosClass(tier="interactive")
    with pytest.raises(ValueError, match="tenant"):
        q.QosClass(tenant="")
    with pytest.raises(ValueError, match="'/'"):
        q.QosClass(tenant="a/b")
    with pytest.raises(ValueError, match="slo"):
        q.QosClass(slo=0.0)
    with pytest.raises(ValueError, match="weight"):
        q.QosClass(weight=0.0)
    with pytest.raises(ValueError, match="collect_delay"):
        q.QosClass(collect_delay=-1e-3)


def test_qos_class_wire_round_trip(q):
    c = q.QosClass(tenant="gold", tier="latency", priority=-1,
                 slo=0.025, weight=2.5, collect_delay=0.001)
    assert q.class_from_wire(c.to_wire()) == c
    assert q.class_from_wire(None) is None
    assert q.class_from_wire(c) is c  # already-built classes pass through
    # wire dicts with missing keys fall back to the defaults
    assert q.class_from_wire({"tenant": "t"}) == q.QosClass(tenant="t")


def test_collect_delay_resolution(q):
    eng_delay = 0.002
    # tier defaults: latency dispatches now, throughput rides the
    # engine window, batch stretches it (clamped at the ceiling)
    assert q.collect_delay(None, eng_delay, {}) == eng_delay
    assert q.collect_delay(q.QosClass(tier="latency"), eng_delay, {}) == 0.0
    assert q.collect_delay(q.QosClass(tier="throughput"),
                         eng_delay, {}) == eng_delay
    assert q.collect_delay(q.QosClass(tier="batch"), eng_delay, {}) == \
        pytest.approx(eng_delay * q.BATCH_STRETCH)
    assert q.collect_delay(q.QosClass(tier="batch"), 1.0, {}) == \
        q.MAX_TIER_DELAY
    # the controller's per-tier override trumps the default...
    assert q.collect_delay(q.QosClass(tier="batch"), eng_delay,
                         {"batch": 0.016}) == 0.016
    # ...and the request's own override trumps everything (clamped)
    c = q.QosClass(tier="batch", collect_delay=0.001)
    assert q.collect_delay(c, eng_delay, {"batch": 0.016}) == 0.001
    assert q.collect_delay(q.QosClass(collect_delay=1.0), eng_delay,
                         {}) == q.MAX_TIER_DELAY


# --------------------------------------------------------------------------- #
# FairShareLedger math (pure, no engine)
# --------------------------------------------------------------------------- #


def test_ledger_work_conserving_below_contention(q):
    led = q.FairShareLedger(contention=0.5)
    bulk = q.QosClass(tenant="bulk", tier="batch")
    # an idle engine admits everything, share or no share
    for pend in range(7):
        assert led.try_admit(bulk, pend, 16) is None


def test_ledger_sheds_over_share_when_contended(q):
    led = q.FairShareLedger(contention=0.5)
    gold = q.QosClass(tenant="gold", weight=1.0)
    bulk = q.QosClass(tenant="bulk", weight=1.0, priority=1)
    led.note(gold)
    led.note(bulk)
    # equal weights, max_pending=8: share is 4 each
    assert led.share("bulk", 8) == 4.0
    assert led.frac("bulk") == 0.5
    for _ in range(4):  # fill bulk to its share (engine uncontended)
        assert led.try_admit(bulk, 0, 8) is None
    # contended + at share + background priority: shed, with the
    # over-share backlog as the hint basis
    over = led.try_admit(bulk, 4, 8)
    assert over == pytest.approx(1.0)
    # the under-share tenant still admits while contended
    assert led.try_admit(gold, 4, 8) is None
    st = led.stats(8)
    assert st["bulk"]["throttled"] == 1 and st["bulk"]["pending"] == 4
    assert st["gold"]["admitted"] == 1


def test_ledger_deficit_readmits_priority_zero(q):
    led = q.FairShareLedger(contention=0.25)
    gold = q.QosClass(tenant="gold", weight=1.0)
    bulk = q.QosClass(tenant="bulk", weight=1.0, priority=1)
    bulk0 = q.QosClass(tenant="bulk", weight=1.0, priority=0)
    for _ in range(4):
        assert led.try_admit(bulk, 0, 8) is None
    assert led.try_admit(gold, 4, 8) is None
    # at the share line while contended: background bulk sheds
    assert led.try_admit(bulk, 5, 8) is not None
    # releases distribute credit by weight; after enough quanta the
    # tenant's PRIORITY-0 traffic readmits while still over share
    for _ in range(4):
        led.release(bulk)
        led.try_admit(bulk, 5, 8)  # pending returns to the share line
    assert led.try_admit(bulk0, 8, 8) is None
    # ...but only by spending credit: the next one sheds again
    led._deficit["bulk"] = 0.0
    assert led.try_admit(bulk0, 8, 8) is not None


def test_ledger_release_never_goes_negative(q):
    led = q.FairShareLedger()
    c = q.QosClass(tenant="t")
    led.note(c)
    led.release(c)
    assert led.stats(8)["t"]["pending"] == 0
