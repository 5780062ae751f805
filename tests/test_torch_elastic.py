"""Twins of tests/test_elastic.py for the port's elastic fabric:
runtime membership (`add_host`, `remove_host`), the rebalancer, K-replica
re-point fail-over and the autoscaler (`control.AutoscalePolicy`,
`control.FabricAutoscaler`), all on `LocalHost`s with CPU engines
(`device="cpu"`). Fail-over and migration answers are bitwise between
the port's own paths.

As in tests/test_torch_fabric.py, survivors get room to answer heartbeats
on a loaded box, and a kill drill waits for the recovery record rather
than the dead flip that precedes it. The worker-process replicated kill
runs on the card in scripts/torch_fabric_drill.py.
"""


import os
import threading
import time

import numpy as np
import pytest

from conflux_tpu_torch import fabric, resilience
from conflux_tpu_torch.control import AutoscalePolicy, FabricAutoscaler
from conflux_tpu_torch.engine import rendezvous, rendezvous_ranked
from conflux_tpu_torch.fabric import FabricPolicy, LocalHost
from conflux_tpu_torch.resilience import FleetDegraded, HostUnavailable
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
        fault_plan=fault_plan,
        engine_kwargs=ENGINE)


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


def _counter(key):
    return resilience.health_stats().get(key, 0)


def _wait_recovery(fab, hid, timeout=20.0):
    """The recovery record lands after the dead flip; poll for it."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        for rec in reversed(fab.stats()["recoveries"]):
            if rec["host"] == hid:
                return rec
        time.sleep(0.02)
    raise AssertionError(f"no recovery record for {hid}")


def _local(hid, root, **kw):
    return LocalHost(hid, os.path.join(str(root), hid),
                     engine_kwargs=ENGINE, **kw)


# --------------------------------------------------------------------------- #
# ranked rendezvous
# --------------------------------------------------------------------------- #


def test_rendezvous_ranked_properties():
    """ranked[0] is the classic owner; removing the winner promotes
    EXACTLY the next-ranked survivor, and only the removed node's
    sids remap (the §34 no-reshuffle extension down the list)."""
    nodes = [f"h{i}" for i in range(5)]
    for sid in range(64):
        order = rendezvous_ranked(sid, nodes)
        assert order[0] == rendezvous(sid, nodes)
        assert sorted(order) == sorted(nodes)
        # drop the winner: the survivors' relative order is unchanged
        survivors = [n for n in nodes if n != order[0]]
        assert rendezvous_ranked(sid, survivors) == order[1:]
        assert rendezvous(sid, survivors) == order[1]
        # k truncates without changing the prefix
        assert rendezvous_ranked(sid, nodes, k=2) == order[:2]
    # dropping ONE node remaps only its own sids
    moved = sum(1 for sid in range(200)
                if rendezvous(sid, nodes) != rendezvous(sid, nodes[:-1])
                and rendezvous(sid, nodes) != nodes[-1])
    assert moved == 0


# --------------------------------------------------------------------------- #
# runtime membership: join
# --------------------------------------------------------------------------- #


class _SlowStart(LocalHost):
    """LocalHost whose start() is slow and counted — the TOCTOU
    window probe: under the old check-then-insert add_host, two
    racing joins with one id BOTH reached start()."""

    started = 0
    _count_lock = threading.Lock()

    def start(self):
        time.sleep(0.15)
        with _SlowStart._count_lock:
            _SlowStart.started += 1
        return super().start()


def test_add_host_toctou_reservation(tmp_path):
    """Two concurrent add_host calls with the same id: exactly one
    wins the reservation and starts a worker; the loser fails before
    owning any resource."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        _SlowStart.started = 0
        errs = []

        def join(sub):
            try:
                fab.add_host(_SlowStart(
                    "hx", os.path.join(str(tmp_path), sub),
                    engine_kwargs=ENGINE))
            except ValueError as e:
                errs.append(e)

        t1 = threading.Thread(target=join, args=("hx-a",))
        t2 = threading.Thread(target=join, args=("hx-b",))
        t1.start(); t2.start(); t1.join(); t2.join()
        assert len(errs) == 1 and "already present" in str(errs[0])
        assert _SlowStart.started == 1
        assert fab.host_state("hx") == "alive"
        # the winner serves: place a session on the enlarged set
        fab.open("sx", _plan(), _mk(0))
        np.asarray(fab.solve("sx", _rhs(0)))
    finally:
        fab.close()


def test_add_host_failed_start_releases_reservation(tmp_path):
    """A handle whose start() raises must not burn the id: the
    reservation is released (not retired) and a later join with the
    same id succeeds."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        class _Boom(LocalHost):
            def start(self):
                raise RuntimeError("provision failed")

        with pytest.raises(RuntimeError):
            fab.add_host(_Boom("hy", os.path.join(str(tmp_path), "y")))
        assert "hy" not in fab.taken_ids()
        fab.add_host(_local("hy", tmp_path))
        assert fab.host_state("hy") == "alive"
    finally:
        fab.close()


def test_add_host_adopt_on_arrival_no_reshuffle(tmp_path):
    """Scale-out does not move existing owners; new sessions HRW over
    the enlarged set."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(6)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        before = {s: fab.owner_of(s) for s in sids}
        added = _counter("fabric_hosts_added")
        fab.add_host(_local("h9", tmp_path))
        assert _counter("fabric_hosts_added") == added + 1
        assert {s: fab.owner_of(s) for s in sids} == before
        for i, s in enumerate(sids):
            assert np.isfinite(np.asarray(fab.solve(s, _rhs(i)))).all()
    finally:
        fab.close()


# --------------------------------------------------------------------------- #
# runtime membership: leave
# --------------------------------------------------------------------------- #


def test_remove_host_drain_bitwise_and_counted(tmp_path):
    """Scale-in drains every owned session over the migrate barrier;
    drained sessions solve BITWISE identically, the id is retired,
    and the storm is counted."""
    fab = _fab(tmp_path, n=3)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(8)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        before = {s: np.asarray(fab.solve(s, _rhs(i)))
                  for i, s in enumerate(sids)}
        census = fab.owner_census()
        victim = max(census, key=lambda h: (census[h], h))
        owned = sorted((s for s in sids if fab.owner_of(s) == victim),
                       key=str)
        d0 = _counter("fabric_drain_migrations")
        r0 = _counter("fabric_hosts_removed")
        moved = fab.remove_host(victim)
        assert sorted(moved, key=str) == owned
        assert _counter("fabric_drain_migrations") == d0 + len(owned)
        assert _counter("fabric_hosts_removed") == r0 + 1
        assert victim not in fab.owner_census()
        with pytest.raises(KeyError):
            fab.host_state(victim)
        for i, s in enumerate(sids):
            assert np.array_equal(before[s],
                                  np.asarray(fab.solve(s, _rhs(i))))
        st = fab.stats()
        assert st["retired_hosts"] == 1
        assert st["lost_sessions"] == 0
    finally:
        fab.close()


def test_remove_host_refusals(tmp_path):
    """Unknown id -> KeyError; below min_live -> FleetDegraded (the
    fleet is never drained under its own floor)."""
    fab = _fab(tmp_path, n=2, min_live=2)
    fab.start()
    try:
        with pytest.raises(KeyError):
            fab.remove_host("nope")
        with pytest.raises(FleetDegraded):
            fab.remove_host("h0")
        assert fab.host_state("h0") == "alive"
    finally:
        fab.close()


def test_remove_dead_host_is_bookkeeping_and_id_never_resurrects(tmp_path):
    """Removing an already-dead host waits out fail-over and retires
    the entry; add_host under the dead id is refused FOREVER."""
    fab = _fab(tmp_path, n=3)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(6)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        census = fab.owner_census()
        victim = max(census, key=lambda h: (census[h], h))
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        # remove during / right after the in-flight fail-over: pure
        # bookkeeping, no drain storm
        assert fab.remove_host(victim) == []
        with pytest.raises(KeyError):
            fab.host_state(victim)
        with pytest.raises(ValueError, match="never resurrect"):
            fab.add_host(LocalHost(
                victim, os.path.join(str(tmp_path), victim + "-again"),
                engine_kwargs=ENGINE))
        assert fab.stats()["lost_sessions"] == 0
        for i, s in enumerate(sids):
            assert np.isfinite(np.asarray(fab.solve(s, _rhs(i)))).all()
    finally:
        fab.close()


def test_remove_while_suspect_abandons_not_half_applies(tmp_path):
    """remove_host on a host that is (secretly dead and) suspect:
    the drain storm cannot move anything, so scale-in is ABANDONED —
    either the host returns to service (HostUnavailable with a retry
    hint) or the concurrent death detection takes over. Never a
    half-applied membership change; zero lost either way."""
    fab = _fab(tmp_path, n=3)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(6)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        census = fab.owner_census()
        victim = max(census, key=lambda h: (census[h], h))
        fab._hosts[victim].kill()
        t0 = time.perf_counter()
        while (fab.host_state(victim) == "alive"
               and time.perf_counter() - t0 < 20.0):
            time.sleep(0.01)
        try:
            fab.remove_host(victim)
        except HostUnavailable as e:
            # undrained sessions stayed on the (still-listed) source
            assert e.retry_after > 0
            _wait_dead(fab, victim)
            assert fab.remove_host(victim) == []
        with pytest.raises(KeyError):
            fab.host_state(victim)
        # heartbeat fail-over re-homed everything; nothing lost
        t0 = time.perf_counter()
        while (fab.stats()["sessions"] < len(sids)
               and time.perf_counter() - t0 < 20.0):
            time.sleep(0.02)
        assert fab.stats()["lost_sessions"] == 0
        for i, s in enumerate(sids):
            assert np.isfinite(np.asarray(fab.solve(s, _rhs(i)))).all()
    finally:
        fab.close()


def test_close_session_census_conservation(tmp_path):
    """close_session is the load-recede half of elasticity: admitted
    == open + failed-over-lost + closed, and closed sids are really
    gone."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        for i in range(6):
            fab.open(f"s{i}", _plan(), _mk(i))
        c0 = _counter("fabric_sessions_closed")
        for i in range(4):
            assert fab.close_session(f"s{i}") is True
        assert _counter("fabric_sessions_closed") == c0 + 4
        st = fab.stats()
        assert st["closed_sessions"] == 4
        assert st["admitted_sessions"] == 6
        assert (st["admitted_sessions"]
                == st["sessions"] + st["lost_sessions"]
                + st["closed_sessions"])
        with pytest.raises(KeyError):
            fab.solve("s0", _rhs(0))
        assert np.isfinite(np.asarray(fab.solve("s5", _rhs(5)))).all()
    finally:
        fab.close()


# --------------------------------------------------------------------------- #
# the shared target picker (wire congestion)
# --------------------------------------------------------------------------- #


def test_pick_target_and_migrate_avoid_full_wire(tmp_path):
    """migrate and the rebalancer share one picker: a host whose shm
    ring is >= 90% full is never chosen while a clear host exists,
    and the rebalancer refuses OUTRIGHT when nothing has headroom."""
    fab = _fab(tmp_path, n=3)
    fab.start()
    try:
        fab.open("s0", _plan(), _mk(0))
        src = fab.owner_of("s0")
        others = sorted(h for h in fab.stats()["hosts"] if h != src)
        full, clear = others
        fab.load.feed(full, {"seconds": 1.0, "solves": 0,
                             "pending": 0, "wire_used_frac": 0.95})
        assert fab._pick_target(exclude={src}) == clear
        assert fab._pick_target(
            exclude={src}, require_wire_headroom=True) == clear
        tgt = fab.migrate("s0")
        assert tgt == clear
        # every candidate congested: soft mode degrades, the
        # rebalancer's hard mode refuses
        fab.load.feed(clear, {"seconds": 1.0, "solves": 0,
                              "pending": 0, "wire_used_frac": 0.92})
        fab.load.feed(src, {"seconds": 1.0, "solves": 0,
                            "pending": 0, "wire_used_frac": 0.92})
        assert fab._pick_target(exclude={tgt}) is not None
        assert fab._pick_target(
            exclude={tgt}, require_wire_headroom=True) is None
        assert fab.rebalance(max_moves=2, ratio=0.1, floor=1) == []
    finally:
        fab.close()


def test_rebalance_bounded_and_no_reshuffle(tmp_path):
    """The skew detector moves at most max_moves sids off ONE hot
    host per pass; untouched sessions keep their owners, moved ones
    solve bitwise, and a skew-free fleet is left alone."""
    fab = _fab(tmp_path, n=1, min_live=1)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(6)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        before = {s: np.asarray(fab.solve(s, _rhs(i)))
                  for i, s in enumerate(sids)}
        fab.add_host(_local("hb", tmp_path))
        assert fab.owner_census() == {"h0": 6}  # adopt-on-arrival
        b0 = _counter("fabric_rebalance_migrations")
        moved = fab.rebalance(max_moves=2, ratio=1.5, floor=4)
        assert len(moved) == 2
        assert _counter("fabric_rebalance_migrations") == b0 + 2
        for s in moved:
            assert fab.owner_of(s) == "hb"
        for s in (set(sids) - set(moved)):
            assert fab.owner_of(s) == "h0"
        # bounded convergence, then stable: no further skew -> no moves
        while fab.rebalance(max_moves=2, ratio=1.2, floor=2):
            pass
        census = fab.owner_census()
        assert max(census.values()) - min(census.values()) <= 2
        assert fab.rebalance(max_moves=2, ratio=2.0, floor=4) == []
        for i, s in enumerate(sids):
            assert np.array_equal(before[s],
                                  np.asarray(fab.solve(s, _rhs(i))))
    finally:
        fab.close()


# --------------------------------------------------------------------------- #
# K-replica placement + instant fail-over
# --------------------------------------------------------------------------- #


def test_replica_repoint_failover_bitwise(tmp_path):
    """K=2: kill a host and its sessions re-point to standbys that
    adopt from LOCAL replica records — zero snapshot restores, zero
    lost, bitwise answers."""
    fab = _fab(tmp_path, n=3, replicas=2)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(8)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        assert fab.stats()["replicated_sessions"] == len(sids)
        before = {s: np.asarray(fab.solve(s, _rhs(i)))
                  for i, s in enumerate(sids)}
        census = fab.owner_census()
        victim = max(census, key=lambda h: (census[h], h))
        owned = census[victim]
        s0 = _counter("fabric_snapshot_restores")
        p0 = _counter("fabric_replica_repoints")
        fab._hosts[victim].kill()
        _wait_dead(fab, victim)
        rec = _wait_recovery(fab, victim)
        assert rec["lost"] == 0
        assert rec["adopted"] == rec["repointed"] == owned
        assert _counter("fabric_snapshot_restores") == s0
        assert _counter("fabric_replica_repoints") == p0 + owned
        for i, s in enumerate(sids):
            assert np.array_equal(before[s],
                                  np.asarray(fab.solve(s, _rhs(i))))
    finally:
        fab.close()


def test_replica_survives_double_death(tmp_path):
    """The post-fail-over durability pass: adopters re-checkpoint and
    re-push, so a SECOND death immediately after re-point still loses
    nothing."""
    fab = _fab(tmp_path, n=3, replicas=2)
    fab.start()
    try:
        sids = [f"s{i}" for i in range(6)]
        for i, s in enumerate(sids):
            fab.open(s, _plan(), _mk(i))
        before = {s: np.asarray(fab.solve(s, _rhs(i)))
                  for i, s in enumerate(sids)}
        census = fab.owner_census()
        first = max(census, key=lambda h: (census[h], h))
        fab._hosts[first].kill()
        _wait_dead(fab, first)
        _wait_recovery(fab, first)
        census = fab.owner_census()
        second = max(census, key=lambda h: (census[h], h))
        fab._hosts[second].kill()
        _wait_dead(fab, second)
        _wait_recovery(fab, second)
        assert fab.stats()["lost_sessions"] == 0
        for i, s in enumerate(sids):
            assert np.array_equal(before[s],
                                  np.asarray(fab.solve(s, _rhs(i))))
    finally:
        fab.close()


def test_both_top2_dead_falls_back_to_snapshot(tmp_path):
    """Kill the STANDBY first (its death moves nothing), then the
    primary: at fail-over no live standby holds the record, so the
    counted snapshot-restore fallback recovers the session — still
    zero lost."""
    fab = _fab(tmp_path, n=3, replicas=2)
    fab.start()
    try:
        fab.open("s0", _plan(), _mk(0))
        before = np.asarray(fab.solve("s0", _rhs(0)))
        primary = fab.owner_of("s0")
        with fab._lock:
            standbys = sorted(fab._replicas["s0"])
        assert len(standbys) == 1 and primary not in standbys
        standby = standbys[0]
        s0 = _counter("fabric_snapshot_restores")
        fab._hosts[standby].kill()
        _wait_dead(fab, standby)
        assert fab.owner_of("s0") == primary
        fab._hosts[primary].kill()
        _wait_dead(fab, primary)
        rec = _wait_recovery(fab, primary)
        assert rec["lost"] == 0
        assert rec["repointed"] == 0 and rec["adopted"] == 1
        assert _counter("fabric_snapshot_restores") == s0 + 1
        assert np.array_equal(before,
                              np.asarray(fab.solve("s0", _rhs(0))))
    finally:
        fab.close()


def test_replica_push_failure_is_counted_not_fatal(tmp_path):
    """An injected fault on the replicate site leaves the standby a
    generation stale (counted); the session itself stays healthy."""
    from conflux_tpu_torch.resilience import FaultPlan, FaultSpec

    plan = FaultPlan([FaultSpec(site="replicate", kind="crash",
                                count=1)])
    fab = _fab(tmp_path, n=3, replicas=2, fault_plan=plan)
    fab.start()
    try:
        f0 = _counter("fabric_replica_push_failures")
        fab.open("s0", _plan(), _mk(0))
        assert _counter("fabric_replica_push_failures") == f0 + 1
        assert np.isfinite(np.asarray(fab.solve("s0", _rhs(0)))).all()
        # the next checkpoint round heals the standby
        fab.checkpoint_all()
        assert fab.stats()["replicated_sessions"] == 1
    finally:
        fab.close()


# --------------------------------------------------------------------------- #
# autoscaler
# --------------------------------------------------------------------------- #


def _auto(fab, root, made, **kw):
    def provider(hid):
        made.append(hid)
        return _local(hid, root)

    base = dict(min_hosts=2, max_hosts=4, low_water=0.25,
                high_water=0.6, sustain=2, cooldown=10.0,
                bytes_per_session=525e3, host_bytes=4 * 525e3)
    base.update(kw)
    apol = AutoscalePolicy(**base)
    return FabricAutoscaler(fab, provider, policy=apol)


def test_autoscaler_scale_out_hysteresis_and_cooldown(tmp_path):
    """Sustained overload grows the fleet by ONE host; the very next
    tick is inside the cooldown and only rebalances."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        made = []
        auto = _auto(fab, tmp_path, made)
        for i in range(8):          # 8 sessions / 2 hosts: mean 1.0
            fab.open(f"s{i}", _plan(), _mk(i))
        a0 = _counter("fabric_autoscale_out")
        assert auto.step(now=0.0)["action"] == "none"      # streak 1
        out = auto.step(now=1.0)                           # streak 2
        assert out["action"] == "scale_out"
        assert made == [out["detail"]]
        assert fab.host_state(out["detail"]) == "alive"
        assert _counter("fabric_autoscale_out") == a0 + 1
        assert auto.step(now=2.0)["action"] == "cooldown"
        assert len(made) == 1
        st = auto.stats()
        assert st["scale_out"] == 1 and st["errors"] == 0
    finally:
        fab.close()


def test_autoscaler_poisson_clump_never_resizes(tmp_path):
    """Hysteresis by construction: a clump shorter than `sustain`
    resets the streak on the next mid-band tick — the host set is
    untouched."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        made = []
        auto = _auto(fab, tmp_path, made, sustain=3)
        for i in range(8):
            fab.open(f"s{i}", _plan(), _mk(i))      # mean 1.0: hot
        assert auto.step(now=0.0)["action"] == "none"
        assert auto.step(now=1.0)["action"] == "none"
        for i in range(5):                          # clump recedes
            fab.close_session(f"s{i}")              # mean 0.375: mid
        assert auto.step(now=2.0)["action"] == "none"
        for i in range(8, 13):                      # clump again
            fab.open(f"s{i}", _plan(), _mk(i))
        assert auto.step(now=3.0)["action"] == "none"
        assert auto.step(now=4.0)["action"] == "none"
        assert made == []
        assert sorted(fab.stats()["hosts"]) == ["h0", "h1"]
        st = auto.stats()
        assert st["scale_out"] == st["scale_in"] == 0
    finally:
        fab.close()


def test_autoscaler_scale_in_drains_least_loaded(tmp_path):
    """Sustained idleness drains ONE host (the least loaded) through
    remove_host; surviving sessions solve bitwise and the retired id
    is never reused by the id allocator."""
    fab = _fab(tmp_path, n=3)
    fab.start()
    try:
        made = []
        auto = _auto(fab, tmp_path, made)
        for i in range(3):
            fab.open(f"s{i}", _plan(), _mk(i))   # mean 0.25 @ n=3
        before = {f"s{i}": np.asarray(fab.solve(f"s{i}", _rhs(i)))
                  for i in range(3)}
        fab.close_session("s2")                  # mean 2/12 < 0.25
        i0 = _counter("fabric_autoscale_in")
        assert auto.step(now=0.0)["action"] == "none"
        out = auto.step(now=1.0)
        assert out["action"] == "scale_in"
        victim = out["detail"]
        assert victim not in fab.stats()["hosts"]
        assert victim in fab.taken_ids()          # retired, not free
        assert _counter("fabric_autoscale_in") == i0 + 1
        assert fab.stats()["lost_sessions"] == 0
        for i in range(2):
            assert np.array_equal(
                before[f"s{i}"],
                np.asarray(fab.solve(f"s{i}", _rhs(i))))
        assert auto.step(now=2.0)["action"] == "cooldown"
        # min_hosts floor: once at 2 hosts, shrink is refused
        fab.close_session("s0"); fab.close_session("s1")
        assert auto.step(now=20.0)["action"] == "none"
        out = auto.step(now=21.0)
        assert out["action"] == "refused" and "min_hosts" in out["detail"]
    finally:
        fab.close()


def test_autoscaler_full_wave_round_trip(tmp_path):
    """A load wave out and back: grow under pressure, shrink when it
    recedes, sessions bitwise across BOTH membership changes."""
    fab = _fab(tmp_path, n=2)
    fab.start()
    try:
        made = []
        auto = _auto(fab, tmp_path, made)
        for i in range(8):
            fab.open(f"s{i}", _plan(), _mk(i))
        before = np.asarray(fab.solve("s7", _rhs(7)))
        auto.step(now=0.0)
        assert auto.step(now=1.0)["action"] == "scale_out"
        for i in range(7):
            fab.close_session(f"s{i}")
        auto.step(now=20.0)
        out = auto.step(now=21.0)
        assert out["action"] == "scale_in"
        assert np.array_equal(before,
                              np.asarray(fab.solve("s7", _rhs(7))))
        log = auto.stats()["decisions_log"]
        assert [e["action"] for e in log] == ["scale_out", "scale_in"]
    finally:
        fab.close()
