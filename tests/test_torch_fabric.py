"""Twins of tests/test_fabric.py for the port's serve fabric
(`conflux_tpu_torch/fabric.py`), with its parity against the JAX
package's fabric on the same seeded inputs.

Every engine runs on the CPU (`device="cpu"`). The port's fabric is held
to the JAX one where both answer the same question: equal owners maps
(rendezvous is a pure function of the sid and the host ids), answers
within 1e-5 (f32) and 1e-12 (f64), and equal `adopted`/`lost` counts in
the recovery records. Between the port's own paths the contracts are
bitwise: before and after fail-over, before and after migration, and a
1-host against a 3-host fabric.

Unlike the reference tests, no fault plan is armed before the fleet is
open, survivors get room to answer heartbeats on a loaded box, and a
kill drill waits for the recovery record, not for the dead flip that
precedes it. The `ProcessHost` cases at the end spawn CPU workers
(`python -m conflux_tpu_torch.fabric --worker`).
"""


import os
import threading
import time

import numpy as np
import pytest

from conflux_tpu_torch import fabric, profiler, resilience
from conflux_tpu_torch.engine import rendezvous
from conflux_tpu_torch.fabric import FabricPolicy, LocalHost, ServeFabric
from conflux_tpu_torch.resilience import (
    FaultPlan,
    FaultSpec,
    FleetDegraded,
    HostUnavailable,
    InjectedFault,
)
from conflux_tpu_torch.serve import FactorPlan

N, V = 24, 8


def _mk(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) / np.sqrt(n)
            + 2.0 * np.eye(n)).astype(np.float32)


def _rhs(seed, w=1):
    b = np.random.default_rng(1000 + seed).standard_normal(
        (N, w) if w > 1 else (N,))
    return b.astype(np.float32)


def _plan():
    return FactorPlan.create((N, N), "float32", v=V)


ENGINE = {"max_batch_delay": 0.0, "device": "cpu"}


def _fab(tmp_path, n=3, fault_plan=None, **pol):
    # a survivor's ping must not be a miss on a loaded box: only the
    # killed host may die (a kill tears its transport, dead at once)
    kw = dict(heartbeat_interval=0.05, heartbeat_timeout=30.0,
              suspect_after=2, dead_after=4)
    kw.update(pol)
    return fabric.local_fabric(
        n, str(tmp_path), policy=FabricPolicy(**kw),
        fault_plan=fault_plan, engine_kwargs=ENGINE)


def _wait_dead(fab, hid, timeout=20.0):
    """Wait until `hid` is dead AND its fail-over has recorded itself
    (the state flips before the fail-over runs)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if fab.host_state(hid) == "dead" and any(
                r["host"] == hid for r in fab.stats()["recoveries"]):
            return time.perf_counter() - t0
        time.sleep(0.02)
    raise AssertionError(f"host {hid} never declared dead and recovered")


# --------------------------------------------------------------------------- #
# routing
# --------------------------------------------------------------------------- #


def test_router_determinism(tmp_path):
    """Placement is a pure function of (sid, live host ids): the owner
    map matches bare rendezvous() and reproduces across fabrics."""
    sids = [f"user-{i}" for i in range(12)]
    with _fab(tmp_path / "a") as fa:
        hosts = sorted(fa._hosts)
        for s in sids:
            fa.open(s, _plan(), _mk(1))
        owners_a = {s: fa.owner_of(s) for s in sids}
    assert owners_a == {s: rendezvous(s, hosts) for s in sids}
    with _fab(tmp_path / "b") as fb:
        for s in sids:
            fb.open(s, _plan(), _mk(1))
        assert {s: fb.owner_of(s) for s in sids} == owners_a


def test_rendezvous_remap_only_removed_host():
    """The HRW property the fail-over story rides: dropping one host
    moves ONLY that host's sids; every other mapping is unchanged."""
    hosts = ["h0", "h1", "h2", "h3"]
    sids = [f"s{i}" for i in range(200)]
    before = {s: rendezvous(s, hosts) for s in sids}
    survivors = [h for h in hosts if h != "h2"]
    after = {s: rendezvous(s, survivors) for s in sids}
    for s in sids:
        if before[s] == "h2":
            assert after[s] in survivors
        else:
            assert after[s] == before[s]
    # and the dead host owned a nontrivial share (the hash spreads)
    assert sum(1 for s in sids if before[s] == "h2") > 10


def test_open_duplicate_sid_refused(tmp_path):
    with _fab(tmp_path, n=2) as fab:
        fab.open("dup", _plan(), _mk(2))
        with pytest.raises(ValueError, match="already open"):
            fab.open("dup", _plan(), _mk(2))
        with pytest.raises(KeyError, match="unknown sid"):
            fab.solve("never-opened", _rhs(0))


# --------------------------------------------------------------------------- #
# the kill-one-host drill
# --------------------------------------------------------------------------- #


def test_kill_one_host_failover_bitwise_and_bounded(tmp_path):
    """The tentpole drill: kill the host owning sessions; detection +
    fail-over re-home its fleet on survivors from the last checkpoint;
    every session (including revived ones) solves BITWISE as before;
    recovery time is measured and bounded."""
    with _fab(tmp_path) as fab:
        ref, rhs = {}, {}
        for i in range(9):
            sid = f"drill-{i}"
            fab.open(sid, _plan(), _mk(10 + i))
            rhs[sid] = _rhs(i, w=2)
            ref[sid] = np.asarray(fab.solve(sid, rhs[sid]))
        victim = fab.owner_of("drill-0")
        moved = [s for s in ref if fab.owner_of(s) == victim]
        stay = {s: fab.owner_of(s) for s in ref
                if fab.owner_of(s) != victim}
        assert moved, "victim owned nothing — hash degenerated"
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        # bounded recovery: the fail-over measured itself
        rec = fab.stats()["recoveries"]
        assert rec and rec[-1]["host"] == victim
        assert rec[-1]["adopted"] == len(moved)
        assert rec[-1]["lost"] == 0
        assert rec[-1]["seconds"] < 30.0
        # every session answers bitwise; survivors never moved
        for sid in ref:
            assert np.array_equal(
                np.asarray(fab.solve(sid, rhs[sid])), ref[sid]), sid
        for sid, h in stay.items():
            assert fab.owner_of(sid) == h
        for sid in moved:
            assert fab.owner_of(sid) != victim
            assert fab.host_state(fab.owner_of(sid)) == "alive"


def test_dead_host_requests_fail_structured_not_hang(tmp_path):
    """With detection disabled (huge heartbeat interval), a request
    routed at a killed host surfaces HostUnavailable immediately —
    the transport tear maps to a structured error, never a hang."""
    with _fab(tmp_path, n=2, heartbeat_interval=60.0) as fab:
        fab.open("s", _plan(), _mk(3))
        hid = fab.owner_of("s")
        fab._hosts[hid].kill()
        t0 = time.perf_counter()
        with pytest.raises(HostUnavailable) as ei:
            fab.solve("s", _rhs(3))
        assert time.perf_counter() - t0 < 10.0
        assert ei.value.retry_after >= 0.0
        assert ei.value.host == hid
        assert resilience.health_stats()["host_unavailable"] >= 1


def test_never_checkpointed_session_reported_lost(tmp_path):
    """durable_open off + no background checkpointing: a killed host's
    sessions are unrecoverable — the fabric says so (structured, with
    the reason), conserves the count in stats, and lets the sid be
    reopened."""
    with _fab(tmp_path, n=2, durable_open=False) as fab:
        fab.open("gone", _plan(), _mk(4))
        victim = fab.owner_of("gone")
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        assert fab.stats()["lost_sessions"] == 1
        with pytest.raises(HostUnavailable, match="lost"):
            fab.solve("gone", _rhs(4))
        # a lost sid may be reopened (fresh state, back in service)
        fab.open("gone", _plan(), _mk(4))
        fab.solve("gone", _rhs(4))
        assert fab.stats()["lost_sessions"] == 0


def test_failover_bounded_staleness_of_updates(tmp_path):
    """Background checkpointing bounds fail-over staleness: drift
    updates checkpointed before the kill survive it (the revived
    session solves bitwise WITH the update applied)."""
    with _fab(tmp_path, n=2, checkpoint_interval=0.1) as fab:
        fab.open("drift", _plan(), _mk(5))
        rng = np.random.default_rng(5)
        U = rng.standard_normal((N, 2)).astype(np.float32) * 0.1
        Vm = rng.standard_normal((N, 2)).astype(np.float32) * 0.1
        fab.update("drift", U, Vm)
        want = np.asarray(fab.solve("drift", _rhs(5)))
        victim = fab.owner_of("drift")
        # wait for two FULL background rounds started after the update
        base = fab.stats()["checkpoint_rounds"]
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            if fab.stats()["checkpoint_rounds"] >= base + 2:
                break
            time.sleep(0.05)
        assert fab.stats()["checkpoint_rounds"] >= base + 2
        assert fabric.latest_checkpoint(
            fab._hosts[victim].ckpt_dir) is not None
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        # 'dead' flips before the synchronous fail-over lands: ride the
        # structured in-flight window on its own retry hints (the
        # fabric_drill pattern), bounded — a genuinely lost session
        # still surfaces as the final HostUnavailable
        deadline = time.perf_counter() + 20.0
        while True:
            try:
                got = np.asarray(fab.solve("drift", _rhs(5)))
                break
            except HostUnavailable as e:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(min(max(e.retry_after, 0.01), 0.25))
        assert np.array_equal(got, want)


# --------------------------------------------------------------------------- #
# live migration
# --------------------------------------------------------------------------- #


def test_migration_bitwise_with_drift(tmp_path):
    """A migrated session — drift updates and all — answers bitwise on
    its new host; ownership flips; the source forgets it."""
    with _fab(tmp_path) as fab:
        fab.open("mig", _plan(), _mk(6))
        rng = np.random.default_rng(6)
        U = rng.standard_normal((N, 2)).astype(np.float32) * 0.1
        Vm = rng.standard_normal((N, 2)).astype(np.float32) * 0.1
        fab.update("mig", U, Vm)
        b = _rhs(6, w=3)
        want = np.asarray(fab.solve("mig", b))
        src = fab.owner_of("mig")
        tgt = fab.migrate("mig")
        assert tgt != src and fab.owner_of("mig") == tgt
        assert np.array_equal(np.asarray(fab.solve("mig", b)), want)
        # the source host no longer has the session
        with pytest.raises(KeyError):
            fab._hosts[src].solve("mig", b)
        assert resilience.health_stats()["sessions_migrated"] >= 1


def test_migration_crash_leaves_source_intact(tmp_path):
    """An injected crash at the hand-off barrier (record written, not
    yet adopted) aborts the migration with the session still owned by
    — and solving bitwise on — the source."""
    plan = FaultPlan([FaultSpec(site="migrate", kind="crash", count=1)])
    with _fab(tmp_path, fault_plan=plan) as fab:
        fab.open("crash", _plan(), _mk(7))
        b = _rhs(7)
        want = np.asarray(fab.solve("crash", b))
        src = fab.owner_of("crash")
        with pytest.raises(InjectedFault):
            fab.migrate("crash")
        assert fab.owner_of("crash") == src
        assert np.array_equal(np.asarray(fab.solve("crash", b)), want)
        # fault budget consumed: the retry goes through
        tgt = fab.migrate("crash")
        assert fab.owner_of("crash") == tgt != src
        assert np.array_equal(np.asarray(fab.solve("crash", b)), want)


def test_migrate_picks_least_loaded_target(tmp_path):
    # heartbeats off (huge interval) so the manual load feeds below
    # aren't overwritten by real probe deltas mid-test
    with _fab(tmp_path, heartbeat_interval=60.0) as fab:
        fab.open("ll", _plan(), _mk(8))
        src = fab.owner_of("ll")
        others = [h for h in sorted(fab._hosts) if h != src]
        # seed the load estimator: others[0] busy, others[1] idle
        fab.load.feed(others[0], {"solves": 0, "seconds": 1.0,
                                  "pending": 50})
        fab.load.feed(others[1], {"solves": 100, "seconds": 1.0,
                                  "pending": 0})
        assert fab.migrate("ll") == others[1]


# --------------------------------------------------------------------------- #
# degraded admission + retry hints
# --------------------------------------------------------------------------- #


def test_degraded_admission_below_min_live(tmp_path):
    """Below min_live, `open` refuses with FleetDegraded (structured,
    counted) while existing sessions keep answering on survivors."""
    with _fab(tmp_path, n=2, min_live=2) as fab:
        fab.open("pre", _plan(), _mk(9))
        victim = [h for h in sorted(fab._hosts)
                  if h != fab.owner_of("pre")][0]
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        with pytest.raises(FleetDegraded) as ei:
            fab.open("post", _plan(), _mk(9))
        assert ei.value.live == 1 and ei.value.total == 2
        assert ei.value.retry_after >= 0.0
        fab.solve("pre", _rhs(9))  # survivors still serve
        assert resilience.health_stats()["fleet_degraded"] >= 1


def test_retry_after_rides_measured_drain_rate(tmp_path):
    """The HostUnavailable retry hint comes from the load estimator's
    smoothed drain rates (clamped to the policy band)."""
    with _fab(tmp_path, n=2, heartbeat_interval=60.0) as fab:
        # seed measured rates: the fleet drains 20 solves/s
        for hid in sorted(fab._hosts):
            fab.load.feed(hid, {"solves": 10, "seconds": 1.0,
                                "pending": 0})
        hint = fab._retry_hint(backlog=10)
        assert hint == pytest.approx(10 / 20.0, rel=0.01)
        pol = fab.policy
        assert pol.retry_floor <= hint <= pol.retry_ceil


def test_route_fault_maps_to_host_unavailable(tmp_path):
    with _fab(tmp_path, n=2) as fab:
        fab.open("r", _plan(), _mk(11))
        # arm the fault AFTER open (open routes too and would eat it)
        fab._faults = FaultPlan(
            [FaultSpec(site="route", kind="crash", count=1)])
        with pytest.raises(HostUnavailable):
            fab.solve("r", _rhs(11))
        fab.solve("r", _rhs(11))  # budget consumed; traffic resumes


# --------------------------------------------------------------------------- #
# heartbeat hysteresis
# --------------------------------------------------------------------------- #


def test_heartbeat_hysteresis_suspect_then_recover(tmp_path):
    """Two injected probe failures walk the host alive -> suspect
    (below dead_after it is NOT declared dead and loses nothing); the
    next healthy probe walks it back to alive with misses reset."""
    base = resilience.health_stats()
    plan = FaultPlan([FaultSpec(site="heartbeat", kind="crash",
                                count=2)])
    with _fab(tmp_path, n=1, fault_plan=plan, suspect_after=2,
              dead_after=6) as fab:
        fab.open("hys", _plan(), _mk(12))
        # the suspect transition bumps a monotone counter — poll that
        # (the suspect WINDOW itself is one heartbeat wide and a state
        # poll could miss it)
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            h = resilience.health_stats()
            if h["hosts_suspected"] > base["hosts_suspected"]:
                break
            time.sleep(0.02)
        h = resilience.health_stats()
        assert h["hosts_suspected"] > base["hosts_suspected"], \
            "host never reached suspect"
        assert h["heartbeat_misses"] >= base["heartbeat_misses"] + 2
        # fault budget spent: the next healthy probe walks it back
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            if fab.host_state("h0") == "alive":
                break
            time.sleep(0.02)
        assert fab.host_state("h0") == "alive"
        # suspect never escalated: no fail-over ran, sessions in place
        assert fab.stats()["recoveries"] == []
        fab.solve("hys", _rhs(12))


def test_host_kill_fault_site_drives_failover(tmp_path):
    """The seeded host_kill fault kills a whole host from inside the
    heartbeat loop; detection + fail-over then run end-to-end."""
    plan = FaultPlan([FaultSpec(site="host_kill", kind="kill",
                                count=1)])
    with _fab(tmp_path, durable_open=True) as fab:
        ref, rhs = {}, {}
        for i in range(4):
            sid = f"hk-{i}"
            fab.open(sid, _plan(), _mk(20 + i))
            rhs[sid] = _rhs(20 + i)
            ref[sid] = np.asarray(fab.solve(sid, rhs[sid]))
        # armed only once the fleet is open: the kill must not race
        # an admission (the heartbeat fires it on its next round)
        fab._faults = plan
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            if any(fab.host_state(h) == "dead"
                   for h in sorted(fab._hosts)):
                break
            time.sleep(0.02)
        dead = [h for h in sorted(fab._hosts)
                if fab.host_state(h) == "dead"]
        assert len(dead) == 1
        _wait_dead(fab, dead[0])
        for sid in ref:
            assert np.array_equal(
                np.asarray(fab.solve(sid, rhs[sid])), ref[sid]), sid
        assert resilience.health_stats()["host_failovers"] >= 1


def test_kill_during_a_checkpoint_barrier_is_transport_shaped(tmp_path):
    """A solve held at admission by a checkpoint's drain barrier when its
    host is killed fails transport-shaped (ConnectionError at the host,
    HostUnavailable at the front, retryable), never with the engine's own
    EngineClosed (the replay harness's chaos leg on the card met three)."""
    with _fab(tmp_path, n=1) as fab:
        fab.open("cb-0", _plan(), _mk(40))
        host = fab._hosts["h0"]
        eng = host.core.eng
        with eng._lock:
            eng._draining = True  # a checkpoint holding its barrier
        errors = []

        def call(fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — the error under test
                errors.append(e)

        threads = [threading.Thread(target=call, args=(fn,)) for fn in (
            lambda: host.solve("cb-0", _rhs(40)),
            lambda: fab.solve("cb-0", _rhs(40)))]
        for t in threads:
            t.start()
        time.sleep(0.3)  # both requests reach the barrier and wait there
        assert all(t.is_alive() for t in threads)
        host.kill()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
    assert len(errors) == 2
    kinds = sorted(type(e).__name__ for e in errors)
    assert kinds == ["ConnectionError", "HostUnavailable"], errors


# --------------------------------------------------------------------------- #
# telemetry surfaces
# --------------------------------------------------------------------------- #


def test_fabric_stats_merge_into_serve_stats(tmp_path):
    with _fab(tmp_path, n=2) as fab:
        fab.open("tel", _plan(), _mk(13))
        ss = profiler.serve_stats()
        fs = ss["fabric"]
        assert fs["fabrics"] >= 1
        assert fs["hosts"] >= 2
        assert fs["sessions"] >= 1
        for k in ("host_unavailable", "fleet_degraded",
                  "heartbeat_misses", "hosts_died", "host_failovers",
                  "sessions_failed_over", "sessions_migrated"):
            assert k in ss["health"]
    # closed fabrics drop out of the aggregate census
    assert fab._closed
    assert fab not in [f for f in list(fabric._FABRICS)
                       if not f._closed]


def test_host_load_estimator_window_plumbing(tmp_path):
    """Heartbeats feed CounterWindow deltas into the estimator: after
    traffic, the owning host reports a positive drain rate."""
    with _fab(tmp_path, n=2) as fab:
        fab.open("load", _plan(), _mk(14))
        hid = fab.owner_of("load")
        for i in range(10):
            fab.solve("load", _rhs(30 + i))
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            rates = fab.load.stats()
            if rates.get(hid, {}).get("drain_per_s", 0.0) > 0.0:
                break
            time.sleep(0.05)
        assert fab.load.stats()[hid]["drain_per_s"] > 0.0


def test_checkpoint_generations_pruned(tmp_path):
    # compact_every=1: every generation self-contained, so the prune
    # bound is exactly checkpoint_keep (the pre-§35 contract; delta
    # chains are covered in tests/test_scale.py)
    with _fab(tmp_path, n=1, checkpoint_keep=2,
              checkpoint_compact_every=1) as fab:
        fab.open("gen", _plan(), _mk(15))
        for _ in range(4):
            fab.checkpoint_all()
        ckpt_dir = fab._hosts["h0"].ckpt_dir
        gens = [d for d in os.listdir(ckpt_dir)
                if d.startswith("fleet-")]
        assert len(gens) <= 2
        snap = fabric.latest_checkpoint(ckpt_dir)
        assert snap is not None
        assert fabric.checkpoint_sids(snap) == {
            "gen": fabric.record_name("gen")}


# --------------------------------------------------------------------------- #
# ProcessHost request plumbing: timeout composition + wire
# --------------------------------------------------------------------------- #


class _NeverReplies:
    """A Connection stand-in that accepts sends and never answers —
    the shape of a wedged (not dead) worker."""

    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


def test_processhost_per_op_timeout_is_transport_shaped(tmp_path):
    """Regression: on Python 3.10
    `concurrent.futures.TimeoutError` is NOT the builtin TimeoutError
    (and not an OSError), so ProcessHost._call's old `except
    TimeoutError` never caught it — the pending entry leaked and the
    raw futures timeout escaped `_TRANSPORT_ERRORS`, reaching callers
    unstructured. Now a slow op under a tight per-op timeout raises
    the BUILTIN TimeoutError (OSError-shaped, so the front maps it to
    HostUnavailable), pops its pending entry, and the per-op timeout
    beats call_timeout."""
    h = fabric.ProcessHost("hx", str(tmp_path / "hx"),
                           call_timeout=30.0, wire="pickle")
    h._conn = _NeverReplies()
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError) as ei:
        h._call("stats", timeout=0.15)
    dt = time.perf_counter() - t0
    assert isinstance(ei.value, fabric._TRANSPORT_ERRORS)
    assert 0.1 < dt < 5.0          # the per-op timeout won, not 30s
    assert h._pending == {}        # no pending-entry leak
    assert h._conn.sent            # the op really went out


def test_processhost_call_timeout_fallback(tmp_path):
    """timeout=None composes predictably: the handle's call_timeout
    applies, through the same single `_deadline` rule as per-op
    timeouts."""
    h = fabric.ProcessHost("hy", str(tmp_path / "hy"),
                           call_timeout=0.15, wire="pickle")
    h._conn = _NeverReplies()
    with pytest.raises(TimeoutError):
        h._call("stats")
    assert h._pending == {}


def test_processhost_rejects_unknown_wire():
    with pytest.raises(ValueError, match="wire"):
        fabric.ProcessHost("hz", "unused-hz", wire="carrier-pigeon")


class _AlwaysFullWire:
    """A WireClient stand-in whose request ring never drains — the
    shape of a torn pipe with replies that will never land. Optionally
    fails the owning host mid-pacing, like the recv thread observing
    the pipe EOF while echo_many retries."""

    def __init__(self, host=None, fail_on_call=None):
        self._host = host
        self._fail_on_call = fail_on_call
        self.calls = 0
        self.failed_with = None

    def payload_fits(self, nbytes):
        return True

    def submit_many(self, entries):
        self.calls += 1
        if self.calls == self._fail_on_call:
            self._host._fail(ConnectionError("pipe torn mid-pacing"))
        raise fabric.wire_mod.RingFull("ring full", retry_after=1e-3)

    def fail(self, exc):
        self.failed_with = exc


def test_processhost_fail_also_fails_wire_client(tmp_path):
    """Regression: `_fail` (a torn pipe) must also
    fail the shm wire client — otherwise the ring-backpressure retry
    loops keep pacing against a ring no reply will ever drain."""
    h = fabric.ProcessHost("hw", str(tmp_path / "hw"))
    w = _AlwaysFullWire()
    h._wire = w
    h._fail(ConnectionError("torn"))
    assert isinstance(w.failed_with, ConnectionError)


def test_echo_many_ring_full_pacing_observes_death(tmp_path):
    """Regression: echo_many's RingFull pacing loop
    re-checks host death each lap — a pipe torn mid-burst raises a
    structured ConnectionError instead of spinning forever, and the
    unsent tail's pending entries are reclaimed."""
    h = fabric.ProcessHost("hv", str(tmp_path / "hv"))
    h._wire = _AlwaysFullWire(host=h, fail_on_call=2)
    with pytest.raises(ConnectionError, match="pacing|torn"):
        h.echo_many([np.ones(8, np.float32)] * 3)
    assert h._pending == {}


def test_echo_many_ring_full_pacing_bounded_by_op_timeout(tmp_path):
    """A ring that stays full with the host still alive cannot pace
    past the op timeout: echo_many raises the builtin TimeoutError
    (transport-shaped) and reclaims the unsent pending entries."""
    h = fabric.ProcessHost("hu", str(tmp_path / "hu"),
                           call_timeout=0.15)
    h._wire = _AlwaysFullWire()
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="stayed full"):
        h.echo_many([np.ones(8, np.float32)] * 3)
    assert time.perf_counter() - t0 < 5.0
    assert h._pending == {}


def test_wire_corrupt_codec_rehydrates_kind_and_host():
    """Regression: a worker-side WireCorrupt (corrupt
    REQUEST record) crosses the pickle control plane intact — the front
    re-raises the ConnectionError-shaped type with kind/host, not a
    generic RuntimeError."""
    e = resilience.WireCorrupt("request record torn",
                               kind="stale_generation", host="h9")
    with pytest.raises(resilience.WireCorrupt) as ei:
        fabric._raise_wire(fabric._encode_exc(e))
    assert ei.value.kind == "stale_generation"
    assert ei.value.host == "h9"
    assert isinstance(ei.value, ConnectionError)


# --------------------------------------------------------------------------- #
# twins of test_qos.py's fabric cases and test_scale.py's delta chain
# --------------------------------------------------------------------------- #


def test_fabric_wire_round_trip_tenant_throttled():
    from conflux_tpu_torch.engine import EngineSaturated
    from conflux_tpu_torch.fabric import _encode_exc, _raise_wire
    from conflux_tpu_torch.resilience import TenantThrottled

    e = TenantThrottled("over", retry_after=0.07, tenant="bulk",
                        qos_class="bulk/batch")
    enc = _encode_exc(e)
    assert enc["etype"] == "TenantThrottled"
    with pytest.raises(TenantThrottled) as ei:
        _raise_wire(enc)
    assert ei.value.retry_after == 0.07
    assert ei.value.tenant == "bulk"
    assert ei.value.qos_class == "bulk/batch"
    e2 = EngineSaturated("full", retry_after=0.1, tenant="t",
                         qos_class="t/latency")
    with pytest.raises(EngineSaturated) as ei2:
        _raise_wire(_encode_exc(e2))
    assert ei2.value.tenant == "t"
    assert ei2.value.qos_class == "t/latency"


def test_fabric_local_host_carries_qos(tmp_path):
    from conflux_tpu_torch.qos import QosClass

    A = _mk(19)
    hosts = [LocalHost("h0", str(tmp_path / "h0"), engine_kwargs=ENGINE)]
    fab = ServeFabric(hosts)
    try:
        fab.start()
        fab.open("s0", _plan().spec(), A)
        gold = QosClass(tenant="gold", tier="latency", slo=1.0)
        b = np.ones((N,), np.float32)
        plain = np.asarray(fab.solve("s0", b))
        tagged = np.asarray(fab.solve("s0", b, qos=gold))
        np.testing.assert_array_equal(plain, tagged)
        with pytest.raises(TypeError, match="QosClass"):
            fab.solve("s0", b, qos={"tenant": "gold"})
        # the heartbeat payload grows flat per-tier drain counters
        ping = hosts[0].ping()
        assert ping["counters"]["qos_latency_solves"] == 1
        row = hosts[0].core.eng.counters()["qos"]["classes"]["gold/latency"]
        assert row["completed"] == 1
    finally:
        fab.close()


def test_failover_recovers_from_delta_chain(tmp_path):
    """Kill the owner after a full -> delta -> delta checkpoint chain: the
    survivor adopts every session (carried records resolved through the
    chain) and the recovered solves answer bitwise."""
    rng = np.random.default_rng(12)
    b = rng.standard_normal((N, 1)).astype(np.float32)
    with _fab(tmp_path, n=2, replicas=2, checkpoint_compact_every=100,
              durable_open=False) as fab:
        sids = [f"user-{i}" for i in range(6)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(40 + i))
        fab.checkpoint_all()  # gen0: full
        for s in sids[:2]:
            u = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
            w = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
            fab.update(s, u, w)
        fab.checkpoint_all()  # gen1: delta (2 written, the rest carried)
        fab.checkpoint_all()  # gen2: delta (all carried)
        want = {s: np.asarray(fab.solve(s, b)) for s in sids}
        victim = fab.owner_of(sids[0])
        assert [s for s in sids if fab.owner_of(s) == victim]
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        assert fab.stats()["lost_sessions"] == 0
        for s in sids:
            assert np.array_equal(np.asarray(fab.solve(s, b)), want[s]), s


# --------------------------------------------------------------------------- #
# parity with the JAX package's fabric, and bitwise contracts between ports
# --------------------------------------------------------------------------- #


def _ref_fab(tmp_path, n=3, **pol):
    from conflux_tpu import fabric as ref_fabric

    kw = dict(heartbeat_interval=0.05, heartbeat_timeout=30.0,
              suspect_after=2, dead_after=4)
    kw.update(pol)
    return ref_fabric.local_fabric(
        n, str(tmp_path), policy=ref_fabric.FabricPolicy(**kw),
        engine_kwargs={"max_batch_delay": 0.0})


def _ref_plan(dtype="float32"):
    from conflux_tpu.serve import FactorPlan as RefPlan

    return RefPlan.create((N, N), dtype, v=V)


def test_owners_and_answers_match_the_jax_fabric(tmp_path):
    """Same sids, same seeded matrices: the two fabrics place every
    session on the same host id and answer within 1e-5 (f32)."""
    sids = [f"user-{i}" for i in range(8)]
    with _fab(tmp_path / "p") as fp, _ref_fab(tmp_path / "r") as fr:
        for i, s in enumerate(sids):
            fp.open(s, _plan(), _mk(60 + i))
            fr.open(s, _ref_plan(), _mk(60 + i))
        assert ({s: fp.owner_of(s) for s in sids}
                == {s: fr.owner_of(s) for s in sids})
        for i, s in enumerate(sids):
            b = _rhs(60 + i, w=2)
            np.testing.assert_allclose(
                np.asarray(fp.solve(s, b)), np.asarray(fr.solve(s, b)),
                rtol=1e-5, atol=1e-5)


def test_failover_matches_the_jax_fabric(tmp_path):
    """Kill the same host id in both fabrics: the recovery records
    adopt and lose the same counts, the survivors' owners agree, and the
    revived answers agree within 1e-5 (and are bitwise the port's own
    answers from before the kill)."""
    sids = [f"drill-{i}" for i in range(9)]
    rhs = {s: _rhs(70 + i, w=2) for i, s in enumerate(sids)}
    with _fab(tmp_path / "p") as fp, _ref_fab(tmp_path / "r") as fr:
        for i, s in enumerate(sids):
            fp.open(s, _plan(), _mk(70 + i))
            fr.open(s, _ref_plan(), _mk(70 + i))
        before = {s: np.asarray(fp.solve(s, rhs[s])) for s in sids}
        victim = fp.owner_of(sids[0])
        assert fr.owner_of(sids[0]) == victim
        fp._hosts[victim].kill()
        fr._hosts[victim].kill()
        _wait_dead(fp, victim)
        _wait_dead(fr, victim)
        rp = [r for r in fp.stats()["recoveries"] if r["host"] == victim][-1]
        rr = [r for r in fr.stats()["recoveries"] if r["host"] == victim][-1]
        assert (rp["adopted"], rp["lost"]) == (rr["adopted"], rr["lost"])
        assert rp["adopted"] >= 1 and rp["lost"] == 0
        assert ({s: fp.owner_of(s) for s in sids}
                == {s: fr.owner_of(s) for s in sids})
        for s in sids:
            got = np.asarray(fp.solve(s, rhs[s]))
            assert np.array_equal(got, before[s]), s
            np.testing.assert_allclose(
                got, np.asarray(fr.solve(s, rhs[s])), rtol=1e-5, atol=1e-5)


def test_float64_fleet_matches_the_jax_fabric_and_survives_migration(tmp_path):
    """float64 sessions agree with the JAX fabric within 1e-12, and a
    migrated float64 session answers bitwise (the suite's conftest runs
    JAX with x64 on)."""
    A = _mk(80).astype(np.float64)
    b = _rhs(80, w=2).astype(np.float64)
    with _fab(tmp_path / "p", n=2) as fp, _ref_fab(tmp_path / "r", n=2) as fr:
        fp.open("f64", FactorPlan.create((N, N), "float64", v=V), A)
        fr.open("f64", _ref_plan("float64"), A)
        got = np.asarray(fp.solve("f64", b))
        assert got.dtype == np.float64
        ref = np.asarray(fr.solve("f64", b))
        assert ref.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
        fp.migrate("f64")
        assert np.array_equal(np.asarray(fp.solve("f64", b)), got)


def test_one_host_and_three_host_fabrics_answer_bitwise(tmp_path):
    """Where a session lives does not change its bits: a 1-host and a
    3-host fabric answer every session identically."""
    sids = [f"s{i}" for i in range(6)]
    with _fab(tmp_path / "one", n=1) as f1, _fab(tmp_path / "three") as f3:
        for i, s in enumerate(sids):
            f1.open(s, _plan(), _mk(90 + i))
            f3.open(s, _plan(), _mk(90 + i))
        assert len({f3.owner_of(s) for s in sids}) > 1
        for i, s in enumerate(sids):
            for w in (1, 3):
                b = _rhs(90 + i, w=w)
                assert np.array_equal(np.asarray(f1.solve(s, b)),
                                      np.asarray(f3.solve(s, b))), (s, w)


# --------------------------------------------------------------------------- #
# worker processes (python -m conflux_tpu_torch.fabric --worker) on the CPU
# --------------------------------------------------------------------------- #


def _shm_segments():
    try:
        return {f for f in os.listdir("/dev/shm") if f.startswith("cfxw-")}
    except FileNotFoundError:
        return set()


def test_process_fabric_shm_wire_bitwise_migration_and_sigkill(tmp_path):
    """Two CPU workers over the shm wire: answers agree with this
    process's direct solves, a migration and a SIGKILL fail-over answer
    bitwise as before, a request routed at the killed worker raises
    HostUnavailable inside its op timeout, a torn reply reads as
    WireCorrupt, and no ring segment is left behind."""
    import signal

    before_shm = _shm_segments()
    # heartbeats driven by hand: the contract here is the fail-over,
    # not the clock
    pol = FabricPolicy(heartbeat_interval=3600.0, heartbeat_timeout=30.0,
                       call_timeout=60.0)
    fab = fabric.process_fabric(2, str(tmp_path), engine_kwargs=ENGINE,
                                policy=pol, start_timeout=120.0)
    try:
        # both workers start together (the front's start is idempotent)
        ts = [threading.Thread(target=h.start) for h in fab._hosts.values()]
        for t in ts:
            t.start()
        for t in ts:
            t.join(150.0)
        fab.start()
        assert len(_shm_segments() - before_shm) == 4
        # three sessions on each worker
        by = {"h0": [], "h1": []}
        for c in (f"p{i}" for i in range(40)):
            if len(by[rendezvous(c, ["h0", "h1"])]) < 3:
                by[rendezvous(c, ["h0", "h1"])].append(c)
        sids = sorted(by["h0"] + by["h1"])
        rhs = {s: _rhs(100 + i, w=2) for i, s in enumerate(sids)}
        want = {}
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(100 + i))
            want[s] = np.asarray(fab.solve(s, rhs[s]))
            direct = np.asarray(_plan().factor(_mk(100 + i), device="cpu")
                                .solve(rhs[s]))
            np.testing.assert_allclose(want[s], direct, rtol=1e-5, atol=1e-6)
        assert len({fab.owner_of(s) for s in sids}) == 2
        st = fab._hosts["h0"].stats(timeout=30.0)
        assert st["launches"]["btrsm"] == 0  # the CPU runs plain versions
        m, k = sids[0], sids[1]
        src = fab.owner_of(m)
        assert fab.migrate(m) != src
        assert np.array_equal(np.asarray(fab.solve(m, rhs[m])), want[m])

        victim = fab.owner_of(k)
        os.kill(fab._hosts[victim]._proc.pid, signal.SIGKILL)
        t0 = time.perf_counter()
        with pytest.raises(HostUnavailable):
            fab.solve(k, rhs[k], timeout=20.0)
        assert time.perf_counter() - t0 < 25.0
        fab._hb_round()  # the torn pipe: dead at once, fail-over inline
        _wait_dead(fab, victim)
        rec = [r for r in fab.stats()["recoveries"] if r["host"] == victim][-1]
        assert rec["lost"] == 0 and rec["adopted"] >= 1
        for s in sids:
            assert np.array_equal(np.asarray(fab.solve(s, rhs[s])), want[s]), s

        survivor = fab.owner_of(k)
        h = fab._hosts[survivor]
        h.debug_wire("torn_reply")
        deadline = time.perf_counter() + 20.0
        while h._dead is None and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert isinstance(h._dead, resilience.WireCorrupt)
        assert h._dead.kind == "torn_segment"
        with pytest.raises(HostUnavailable):
            fab.solve(k, rhs[k], timeout=20.0)
        fab._hb_round()
        assert fab.host_state(survivor) == "dead"
    finally:
        fab.close()
    assert not (_shm_segments() - before_shm)


def test_process_host_pickle_wire_echo_order_and_solve(tmp_path):
    """The pickle wire is an explicit choice: no segments, `echo_many`
    keeps order, and a solve answers like the session's direct solve."""
    before_shm = _shm_segments()
    h = fabric.ProcessHost("pk", str(tmp_path / "pk"), engine_kwargs=ENGINE,
                           wire="pickle", start_timeout=120.0)
    try:
        h.start()
        assert _shm_segments() == before_shm
        payloads = [np.full((5,), float(i), np.float32) for i in range(9)]
        out = h.echo_many(payloads, timeout=30.0)
        assert all(np.array_equal(a, b) for a, b in zip(out, payloads))
        assert h._pending == {}
        h.open("s", _plan().spec(), _mk(110), timeout=60.0)
        b = _rhs(110, w=2)
        np.testing.assert_allclose(
            h.solve("s", b, timeout=60.0),
            np.asarray(_plan().factor(_mk(110), device="cpu").solve(b)),
            rtol=1e-5, atol=1e-6)
    finally:
        h.close()


def test_process_host_start_raises_when_the_worker_has_no_card(tmp_path):
    """A worker whose engine would run on the card, started where no
    card is visible, exits non-zero before it connects, and `start`
    raises at once with its log; it never serves on the CPU instead."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    h = fabric.ProcessHost("nc", str(tmp_path / "nc"),
                           engine_kwargs={"max_batch_delay": 0.0},
                           env=env, start_timeout=120.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited with code"):
        h.start()
    assert time.perf_counter() - t0 < 60.0
    assert not [f for f in os.listdir(str(tmp_path / "nc"))
                if f.endswith(".sock")]


def test_host_load_estimator_matches_the_jax_one():
    """The same heartbeat deltas give the same per-host rates, retry
    hints and least-loaded pick in both packages."""
    from conflux_tpu import control as ref_control
    from conflux_tpu_torch import control

    feeds = [("h0", {"seconds": 2.0, "solves": 10, "pending": 1,
                     "qos_latency_solves": 4, "qos_batch_solves": 6}),
             ("h1", {"seconds": 1.0, "solves": 40, "pending": 0,
                     "wire_used_frac": 0.5}),
             ("h0", {"seconds": 0.5, "solves": 3, "pending": 7})]
    est, ref = control.HostLoadEstimator(), ref_control.HostLoadEstimator()
    for hid, d in feeds:
        est.feed(hid, dict(d))
        ref.feed(hid, dict(d))
    assert est.stats() == ref.stats()
    assert est.stats()["h0"]["qos_drain_per_s"] == {"batch": 3.0,
                                                    "latency": 2.0}
    for backlog in (1, 10, 1000):
        assert est.retry_after(backlog=backlog) == ref.retry_after(
            backlog=backlog)
    assert est.least_loaded(["h0", "h1"]) == ref.least_loaded(["h0", "h1"])
    est.forget("h0")
    assert "h0" not in est.stats()
