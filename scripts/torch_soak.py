"""Chaos soak of the port's serving stack, against per-session float64
oracles: the port's counterpart of `scripts/soak.py --serve`, `--tier`,
`--fabric` and `--elastic`, and of its `--lockcheck`.

    python scripts/torch_soak.py --serve   [--trials 20] [--seed 0] [--platform cpu]
    python scripts/torch_soak.py --tier    [--time-budget 30] [--lockcheck]
    python scripts/torch_soak.py --fabric  [--trials 20] [--seed 0] [--platform cpu]
    python scripts/torch_soak.py --elastic [--trials 20] [--seed 0] [--platform cpu]
    python scripts/torch_soak.py --fabric --replay SEED

`--serve`: each trial serves a fleet of 1-3 (possibly drifted) sessions
through a `ServeEngine` with the full `HealthPolicy` under the serve
fault menu (NaN at staging, delays and crashes at dispatch, drain, d2h and
refresh, forced-unhealthy verdicts), with clean, poisoned and born-expired
requests. `--tier`: Zipf traffic over a fleet larger than the device tier
through a `ResidentSet`-managed engine while the spill, revive, disk_write
and disk_read sites inject crashes, delays and corrupt records.

`--fabric`: each trial builds a `LocalHost` fabric (2-3 engine hosts, fast
heartbeat, durable admission) and serves solve, drift-update and migrate
traffic while the fabric fault menu fires (heartbeat crashes and delays,
route crashes, migrate crashes at the hand-off barrier, whole-host kills
from the heartbeat loop); dead hosts are sometimes replaced through
`add_host`. Then it hammers the shared-memory wire (`wire.InProcWire`)
under the ring_full / torn_segment / stale_generation fault sites.
`--elastic`: a diurnal load wave over a fleet whose host set a
deterministic `control.FabricAutoscaler` grows and shrinks, under join,
leave, kill and drain storms and the fabric and replicate fault menu.

Invariants: failures are structured resilience errors only, every session
answers against its own float64 oracle (a fail-over may legally revive its
last durable state, nothing else), recovery windows end, and the session
census is conserved with zero lost sessions (`--serve`/`--tier`: every
future resolves, no pending slot leaks, the engine closes un-wedged, the
tier conserves its session count). Each trial line carries its seed;
`--replay SEED` re-runs one trial. `--lockcheck` runs the trials under
`conflux_tpu_torch.analysis.lockcheck` (the locks of this process, not of
fabric workers) and fails on a lock-order cycle or an engine lock held
across a `serve.*` dispatch region. Engines run on the card unless
`--platform cpu`. The exit status is the gate.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

# the hosts' engine keywords; main() sets the device from --platform
ENGINE: dict = {"max_batch_delay": 0.0}


def run_serve_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the serving engine under injected faults.

    A fleet of 1-3 (possibly drifted) sessions behind a `ServeEngine` with
    the full `HealthPolicy` on, under a seeded `FaultPlan` sampled from the
    serve menu (NaN at staging, delay/crash at dispatch, drain, d2h and
    refresh, forced-unhealthy verdicts), serves mixed clean, poisoned and
    born-expired traffic. Invariants (graceful degradation, never silent
    corruption): every admitted request's future resolves; failures are
    STRUCTURED resilience errors; answers match the float64 oracle of the
    session's (possibly drifted) matrix; the engine closes un-wedged with
    zero pending and coherent counters."""
    from conflux_tpu_torch import resilience, serve
    from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
    from conflux_tpu_torch.resilience import (
        DeadlineExceeded,
        FaultPlan,
        FaultSpec,
        HealthPolicy,
        InjectedFault,
        RhsNonFinite,
        SessionQuarantined,
        SolveUnhealthy,
    )

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    N = int(rng.choice([32, 64]))
    S = int(rng.integers(1, 4))
    plan = serve.FactorPlan.create((N, N), torch.float32, v=16)
    As, sessions = [], []
    for _ in range(S):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        sess = plan.factor(A, device=ENGINE["device"])
        if rng.integers(2):  # pre-traffic Woodbury drift on this session
            k = int(rng.integers(1, 4))
            U = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
            Vm = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
            sess.update(U, Vm)
            A = A + U @ Vm.T
        As.append(A.astype(np.float64))
        sessions.append(sess)
    # sample the fault menu AFTER the fleet is built, so set-up is clean
    menu = [
        FaultSpec("staging", "nan", prob=0.3, count=int(rng.integers(1, 4))),
        FaultSpec("dispatch", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("drain", "crash", prob=0.5, count=1),
        FaultSpec("d2h", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("d2h", "crash", prob=0.5, count=1),
        FaultSpec("solve", "unhealthy", prob=0.4, count=int(rng.integers(1, 3))),
        FaultSpec("refresh", "delay", prob=0.5, delay_s=0.002, count=2),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    label = f"seed={seed} serve N={N} S={S} faults={[(f.site, f.kind) for f in picks]}"
    eng = ServeEngine(
        max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=64,
        max_coalesce_width=8,
        health=HealthPolicy(quarantine_after=2, quarantine_cooldown=0.05),
        fault_plan=faults, watchdog_interval=0.05, device=ENGINE["device"])
    resilience.install_faults(faults)  # the serve layer's 'refresh' site
    reqs = []
    try:
        for _ in range(24):
            si = int(rng.integers(S))
            w = int(rng.choice([1, 1, 2, 3]))
            b = rng.standard_normal((N, w)).astype(np.float32)
            kind = int(rng.integers(8))
            deadline = None
            if kind == 0:  # poisoned at the source: admission guard food
                b[int(rng.integers(N)), 0] = np.nan
            elif kind == 1:  # born expired: lazy-eviction food
                deadline = 0.0
            try:
                fut = eng.submit(sessions[si], b, deadline=deadline)
            except (RhsNonFinite, SessionQuarantined, EngineSaturated):
                continue  # structured admission outcomes are fine
            reqs.append((si, b, fut))
        wedged = eng.close(timeout=120)
        if wedged:
            return False, f"{label}: close() wedged {wedged}"
    finally:
        resilience.install_faults(None)
        eng.close(timeout=10)
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              InjectedFault)
    answered = 0
    for si, b, fut in reqs:
        if not fut.done():
            return False, f"{label}: close() left a future unresolved"
        try:
            x = np.asarray(fut.result(0))
        except ok_exc:
            continue
        except Exception as e:  # noqa: BLE001 — any other leak is a bug
            return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
        want = np.linalg.solve(As[si], b.astype(np.float64))
        err = np.linalg.norm(x - want) / max(np.linalg.norm(want), 1e-30)
        if not err < 1e-3:
            return False, f"{label}: answer off oracle ({err:.2e})"
        answered += 1
    stats = eng.stats()
    if stats["pending"] != 0:
        return False, f"{label}: {stats['pending']} pending slots leaked"
    if stats["completed"] + stats["failed"] != stats["requests"]:
        return False, f"{label}: counters incoherent {stats}"
    h = resilience.health_stats()
    return True, (f"{label}: ok {answered}/{len(reqs)} answered, "
                  f"injected={sum(faults.injected.values())}, "
                  f"redispatches={h['survivor_redispatches']}, evictions={h['evictions']}")


def run_tier_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the tiered residency layer.

    A Zipf-popular request stream drives a fleet far larger than the
    device-resident capacity through a `ResidentSet`-managed engine while
    the tier fault sites (spill, revive, disk_write, disk_read) inject
    crashes, delays and record corruption. Invariants: every future
    resolves with an answer or a STRUCTURED error; answers match each
    session's own float64 oracle (a spill or revive that leaked state
    between sessions would miss it); the managed session count is
    conserved across tiers; the resident high-water respects the capacity
    unless a spill crash was injected (a failed spill keeps its session
    resident by design); the engine closes un-wedged with zero pending."""
    import tempfile

    from conflux_tpu_torch import serve, tier
    from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
    from conflux_tpu_torch.resilience import (
        DeadlineExceeded,
        FaultPlan,
        FaultSpec,
        HealthPolicy,
        InjectedFault,
        RestoreCorrupt,
        RhsNonFinite,
        SessionQuarantined,
        SessionSpilled,
        SolveUnhealthy,
    )

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    N = int(rng.choice([24, 32]))
    F = int(rng.integers(6, 10))
    C = int(rng.integers(1, 3))
    plan = serve.FactorPlan.create((N, N), torch.float32, v=8)
    As, fleet = [], []
    for _ in range(F):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        sess = plan.factor(A, device=ENGINE["device"])
        A64 = A.astype(np.float64)
        if rng.integers(2):  # pre-traffic Woodbury drift on this session
            k = int(rng.integers(1, 3))
            U = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
            Vm = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
            sess.update(U, Vm)
            A64 = A64 + U.astype(np.float64) @ Vm.astype(np.float64).T
        As.append(A64)
        fleet.append(sess)
    menu = [
        FaultSpec("spill", "crash", prob=0.3, count=2),
        FaultSpec("spill", "delay", prob=0.3, delay_s=0.001, count=3),
        FaultSpec("revive", "crash", prob=0.3, count=2),
        FaultSpec("revive", "delay", prob=0.3, delay_s=0.001, count=3),
        FaultSpec("disk_write", "nan", prob=0.3, count=1),
        FaultSpec("disk_write", "crash", prob=0.3, count=1),
        FaultSpec("disk_read", "crash", prob=0.4, count=1),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    label = f"seed={seed} tier N={N} F={F} C={C} faults={[(f.site, f.kind) for f in picks]}"
    pmf = 1.0 / np.arange(1, F + 1) ** 1.1
    pmf /= pmf.sum()
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              InjectedFault, SessionSpilled, RestoreCorrupt)
    with tempfile.TemporaryDirectory() as tmp:
        rs = tier.ResidentSet(
            max_sessions=C, host_max_sessions=max(2, F // 2), disk_dir=tmp,
            evict_batch=max(1, C), max_concurrent_revives=2,
            revive_refactor_rank=(1 if rng.integers(2) else None), fault_plan=faults)
        eng = ServeEngine(
            max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=64,
            max_coalesce_width=8,
            health=HealthPolicy(quarantine_after=3, quarantine_cooldown=0.05),
            residency=rs, revive_wait=5.0, watchdog_interval=0.05,
            device=ENGINE["device"])
        rs.adopt(*fleet)
        reqs = []
        try:
            for _ in range(28):
                si = int(rng.choice(F, p=pmf))
                w = int(rng.choice([1, 1, 2]))
                b = rng.standard_normal((N, w)).astype(np.float32)
                deadline = 0.0 if rng.integers(8) == 0 else None
                if rng.integers(4) == 0:
                    # a direct client-thread touch: the transparent
                    # session-level revival path (engine-free)
                    try:
                        x = fleet[si].solve(b).cpu().numpy()
                    except ok_exc:
                        continue
                    reqs.append((si, b, None, x))
                    continue
                try:
                    fut = eng.submit(fleet[si], b, deadline=deadline)
                except (RhsNonFinite, SessionQuarantined, EngineSaturated, SessionSpilled,
                        RestoreCorrupt):
                    continue
                reqs.append((si, b, fut, None))
            wedged = eng.close(timeout=120)
            if wedged:
                return False, f"{label}: close() wedged {wedged}"
        finally:
            eng.close(timeout=10)
        answered = 0
        for si, b, fut, x in reqs:
            if fut is not None:
                if not fut.done():
                    return False, f"{label}: close() left a future unresolved"
                try:
                    x = np.asarray(fut.result(0))
                except ok_exc:
                    continue
                except Exception as e:  # noqa: BLE001 — a leak is a bug
                    return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
            want = np.linalg.solve(As[si], b.astype(np.float64))
            err = np.linalg.norm(x - want) / max(np.linalg.norm(want), 1e-30)
            if not err < 1e-3:
                return False, (f"{label}: answer off its own oracle ({err:.2e}): "
                               "cross-session corruption or a torn revive")
            answered += 1
        stats = eng.stats()
        if stats["pending"] != 0:
            return False, f"{label}: {stats['pending']} slots leaked"
        st = rs.stats()
        conserved = (st["resident_sessions"] + st["host_sessions"] + st["disk_sessions"]
                     + st["corrupt_sessions"])
        if conserved != F or st["managed_sessions"] != F:
            return False, f"{label}: session count not conserved ({conserved}/{F}: {st})"
        if st["resident_high_water"] > C and ("spill", "crash") not in faults.injected:
            return False, (f"{label}: resident high-water {st['resident_high_water']} > "
                           f"cap {C} with no spill fault injected")
        h = tier.tier_stats()
        return True, (f"{label}: ok {answered}/{len(reqs)} answered, "
                      f"injected={sum(faults.injected.values())}, "
                      f"spills={h['spills_host']}+{h['spills_disk']}d, "
                      f"revives={h['revives_h2d']}h/{h['revives_refactor']}rf, "
                      f"corrupt={st['corrupt_sessions']}")


def run_fabric_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the multi-host serve fabric.

    A LocalHost fabric (2-3 engine hosts, fast heartbeat, durable
    admission) serves mixed solve / drift-update / migrate traffic
    while the fabric fault menu fires: heartbeat crashes and delays
    (hysteresis food), route crashes (structured HostUnavailable
    food), migrate crashes at the hand-off barrier, and whole-host
    kills from inside the heartbeat loop. Dead hosts are sometimes
    replaced via `add_host` (the revive arm). Invariants: failures are
    STRUCTURED resilience errors only; every session keeps answering
    against its OWN f64 oracle (a fail-over or migration that leaked
    state across hosts/sessions would miss it — zero cross-host
    corruption); a request window during fail-over ends in recovery
    (bounded, not permanent unavailability); and the session census is
    conserved (open sessions + lost == admitted, with durable
    admission making lost == 0)."""
    import tempfile

    from conflux_tpu_torch import fabric as fabric_mod
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import EngineSaturated
    from conflux_tpu_torch.fabric import FabricPolicy, LocalHost
    from conflux_tpu_torch.resilience import (
        FaultPlan,
        FaultSpec,
        FleetDegraded,
        HostUnavailable,
        InjectedFault,
    )

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    N = int(rng.choice([24, 32]))
    H = int(rng.integers(2, 4))
    S = int(rng.integers(4, 8))
    plan = serve.FactorPlan.create((N, N), torch.float32, v=8)
    menu = [
        FaultSpec("heartbeat", "crash", prob=0.4,
                  count=int(rng.integers(1, 4))),
        FaultSpec("heartbeat", "delay", prob=0.3, delay_s=0.002,
                  count=3),
        FaultSpec("route", "crash", prob=0.4,
                  count=int(rng.integers(1, 3))),
        FaultSpec("migrate", "crash", prob=0.5, count=1),
        FaultSpec("host_kill", "kill", prob=0.6, count=1),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    killful = any(f.site == "host_kill" for f in picks)
    label = (f"seed={seed} fabric N={N} H={H} S={S} "
             f"faults={[(f.site, f.kind) for f in picks]}")
    # EngineSaturated: a background checkpoint's drain barrier briefly
    # pauses admission — structured and retryable, exactly like a
    # fail-over window
    ok_exc = (HostUnavailable, FleetDegraded, InjectedFault,
              EngineSaturated)

    def solve_retry(fab, sid, b, deadline_s=30.0):
        """Route with fail-over patience: HostUnavailable during a
        detection/fail-over window is expected — but it must END."""
        t0 = time.time()
        while True:
            try:
                return np.asarray(fab.solve(sid, b))
            except ok_exc as e:
                if time.time() - t0 > deadline_s:
                    raise TimeoutError(
                        f"recovery never completed for {sid}: {e}")
                time.sleep(min(0.05, max(0.01,
                                         getattr(e, "retry_after", 0.0))))

    pol = FabricPolicy(heartbeat_interval=0.02, heartbeat_timeout=1.0,
                       suspect_after=2, dead_after=3,
                       checkpoint_interval=float(rng.choice([0.0, 0.1])))
    answered = migrations = revived = rollbacks = 0
    with tempfile.TemporaryDirectory() as tmp:
        fab = fabric_mod.local_fabric(
            H, tmp, policy=pol, fault_plan=faults,
            engine_kwargs=ENGINE)
        try:
            with fab:
                # per-sid oracle CANDIDATES: durable admission pins the
                # pre-drift state; a post-admission update is durable
                # only once a later checkpoint covers it, so until then
                # a fail-over may legitimately revive the pre-drift
                # snapshot (the documented staleness bound). The soak
                # therefore accepts EITHER state — but nothing else: a
                # blend or another session's answer misses both.
                As, pre, rhs = {}, {}, {}
                for i in range(S):
                    sid = f"soak-{seed}-{i}"
                    A = (rng.standard_normal((N, N)) / np.sqrt(N)
                         + 2.0 * np.eye(N)).astype(np.float32)
                    A64 = A.astype(np.float64)
                    t0 = time.time()
                    while True:  # admission retries route faults too
                        try:
                            fab.open(sid, plan, A)
                            break
                        except ok_exc as e:
                            if time.time() - t0 > 30.0:
                                return False, (f"{label}: admission "
                                               f"never recovered: {e}")
                            time.sleep(0.01)
                    pre[sid] = A64
                    if rng.integers(2):  # pre-traffic SMW drift
                        k = int(rng.integers(1, 3))
                        U = (0.01 * rng.standard_normal((N, k))
                             ).astype(np.float32)
                        Vm = (0.01 * rng.standard_normal((N, k))
                              ).astype(np.float32)
                        try:
                            fab.update(sid, U, Vm)
                            A64 = (A64 + U.astype(np.float64)
                                   @ Vm.astype(np.float64).T)
                        except ok_exc:
                            pass  # structured refusal: no drift applied
                    As[sid] = A64
                    rhs[sid] = rng.standard_normal(
                        (N, int(rng.choice([1, 2])))).astype(np.float32)
                sids = sorted(As)
                for _phase in range(3):
                    for sid in sids:
                        op = int(rng.integers(6))
                        if op == 0:  # live migration under chaos
                            try:
                                fab.migrate(sid)
                                migrations += 1
                            except ok_exc:
                                pass  # crash at the barrier: session
                                # stays on the source (checked below)
                            except ValueError:
                                pass  # no distinct target available
                        b = rhs[sid]
                        try:
                            x = solve_retry(fab, sid, b)
                        except TimeoutError as e:
                            return False, f"{label}: {e}"
                        except Exception as e:  # noqa: BLE001 — leak
                            return False, (f"{label}: UNSTRUCTURED "
                                           f"{type(e).__name__}: {e}")
                        want = np.linalg.solve(As[sid],
                                               b.astype(np.float64))
                        err = (np.linalg.norm(x - want)
                               / max(np.linalg.norm(want), 1e-30))
                        if not (err < 1e-3):
                            wpre = np.linalg.solve(
                                pre[sid], b.astype(np.float64))
                            epre = (np.linalg.norm(x - wpre)
                                    / max(np.linalg.norm(wpre), 1e-30))
                            if killful and epre < 1e-3:
                                # a fail-over revived the pre-drift
                                # snapshot: legal staleness, and it is
                                # now the session's authoritative state
                                As[sid] = pre[sid]
                                rollbacks += 1
                            else:
                                return False, (f"{label}: {sid} off "
                                               f"its own oracle "
                                               f"({err:.2e}) — cross-"
                                               "host corruption?")
                        answered += 1
                    # the revive arm: replace one dead host
                    dead = [h for h in sorted(fab._hosts)
                            if fab.host_state(h) == "dead"]
                    if dead and rng.integers(2):
                        hid = f"r{revived}"
                        fab.add_host(LocalHost(
                            hid, os.path.join(tmp, hid),
                            engine_kwargs=ENGINE))
                        revived += 1
                st = fab.stats()
                if st["sessions"] + st["lost_sessions"] != S:
                    return False, (f"{label}: census not conserved "
                                   f"({st['sessions']}+"
                                   f"{st['lost_sessions']} != {S})")
                if st["lost_sessions"]:
                    return False, (f"{label}: durable admission lost "
                                   f"{st['lost_sessions']} sessions")
                deaths = sum(1 for h in st["hosts"].values()
                             if h["state"] == "dead")
                if deaths and not killful:
                    return False, (f"{label}: {deaths} hosts died "
                                   "without a host_kill fault")
        finally:
            fab.close()

    # ---- wire hammer: the shm payload wire under its own menu --------- #
    # (DESIGN §31) An InProcWire — real shared segments,
    # real generation/backpressure protocol — serving per-sid f64
    # solves while the wire fault sites fire: ring_full (alloc
    # refusal), torn_segment / stale_generation (reader-integrity
    # trips). Invariants: RingFull is retryable backpressure (the wire
    # SURVIVES it), WireCorrupt is instant structural death (pending
    # futures fail NOW; a fresh wire is the fail-over analogue), and
    # every answer that lands is BITWISE its sid's own f64 oracle —
    # zero cross-request corruption through the shared segments.
    from concurrent.futures import Future

    from conflux_tpu_torch.wire import (
        InProcWire,
        RingFull,
        WireConfig,
        WireCorrupt,
    )
    wrng = np.random.default_rng(seed + 7)
    wire_menu = [
        FaultSpec("ring_full", "crash", prob=0.5,
                  count=int(wrng.integers(1, 3))),
        FaultSpec("torn_segment", "crash", prob=1.0, count=1),
        FaultSpec("stale_generation", "crash", prob=1.0, count=1),
    ]
    wire_picks = [m for m in wire_menu if wrng.integers(2)]
    wire_faults = FaultPlan(wire_picks, seed=seed + 7)
    label += f" wire={[(f.site, f.kind) for f in wire_picks]}"
    W = int(wrng.integers(3, 6))
    wAs = {f"w{j}": (wrng.standard_normal((N, N)) / np.sqrt(N)
                     + 2.0 * np.eye(N))
           for j in range(W)}

    def hook(batch):
        futs = []
        for sid, view, _q in batch:
            f: Future = Future()
            try:
                f.set_result(np.linalg.solve(
                    wAs[sid], np.asarray(view, np.float64)))
            # conflint: disable=CFX-EXCEPT soak hook mirrors the worker op boundary
            except BaseException as e:
                f.set_exception(e)
            futs.append(f)
        return futs

    def mk():
        return InProcWire(hook, config=WireConfig(ring_bytes=1 << 20),
                          fault_plan=wire_faults,
                          host_id=f"soak{seed % 10000}")

    w = mk()
    wire_answers = wire_deaths = wire_backpressure = 0
    try:
        for j in range(24):
            sid = f"w{j % W}"
            b = wrng.standard_normal((N, int(wrng.choice([1, 2]))))
            want = np.linalg.solve(wAs[sid], b)
            t0, fut = time.time(), None
            while fut is None:
                try:
                    fut = w.solve(sid, b)
                except RingFull as e:
                    wire_backpressure += 1
                    if time.time() - t0 > 10.0:
                        return False, (f"{label}: wire backpressure "
                                       "never cleared")
                    time.sleep(min(0.01, max(1e-4, e.retry_after)))
                except ConnectionError:
                    w.close()
                    wire_deaths += 1
                    w = mk()
            try:
                x = fut.result(timeout=30.0)
            except (WireCorrupt, ConnectionError):
                # instant structural death with pending work — the
                # request fails NOW (never a hang, never a silent
                # retry into a corrupt segment); fail-over = new wire
                w.close()
                wire_deaths += 1
                w = mk()
                continue
            except Exception as e:  # noqa: BLE001 — soak records, not raises
                return False, (f"{label}: UNSTRUCTURED wire failure "
                               f"{type(e).__name__}: {e}")
            if not np.array_equal(np.asarray(x), want):
                return False, (f"{label}: wire answer for {sid} not "
                               "bitwise its own f64 oracle — cross-"
                               "request corruption through the ring")
            wire_answers += 1
    finally:
        w.close()
    corrupt_picked = sum(1 for f in wire_picks
                         if f.site in ("torn_segment",
                                       "stale_generation"))
    if wire_deaths < corrupt_picked:
        return False, (f"{label}: {corrupt_picked} corrupt-site "
                       f"faults picked but only {wire_deaths} "
                       "structural wire deaths observed")
    return True, (f"{label}: ok {answered} solves, "
                  f"{migrations} migrations, {revived} revives, "
                  f"{rollbacks} rollbacks, "
                  f"injected={sum(faults.injected.values())}; wire "
                  f"{wire_answers} answers, {wire_deaths} deaths, "
                  f"{wire_backpressure} backpressure retries, "
                  f"injected={sum(wire_faults.injected.values())}")


def run_elastic_trial(seed: int) -> tuple[bool, str]:
    """One diurnal-wave chaos trial of the ELASTIC fabric.

    A LocalHost fabric (2 seed hosts, K ∈ {1, 2} replica placement,
    durable admission) rides a load wave up and back down while a
    deterministic `FabricAutoscaler` (fake clock, one `step()` per
    wave beat) grows and shrinks the host set, and the fabric fault
    menu fires underneath: heartbeat crashes/delays, route crashes,
    migrate crashes at the hand-off barrier, replica-push crashes
    (the standby goes one generation stale — the coherence gate's
    food) and whole-host kills. On top of the autoscaler's own
    membership traffic the trial injects join/leave/kill storms:
    random `add_host` joins, random drain-removals (an incomplete
    drain must ABANDON, not half-apply) and abrupt kills.

    Invariants: failures are STRUCTURED resilience errors only; every
    session answers against its OWN f64 oracle (rollback-aware — a
    fail-over may legally revive the last durable state, nothing
    else); recovery windows END (bounded retries); the session census
    is EXACTLY conserved through every join/leave/kill/drain/resize
    (admitted == open + lost + closed) with durable admission making
    lost == 0; and a removed/dead id never resurrects."""
    import tempfile

    from conflux_tpu_torch import fabric as fabric_mod
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.control import AutoscalePolicy, FabricAutoscaler
    from conflux_tpu_torch.engine import EngineSaturated
    from conflux_tpu_torch.fabric import FabricPolicy, LocalHost
    from conflux_tpu_torch.resilience import (
        FaultPlan,
        FaultSpec,
        FleetDegraded,
        HostUnavailable,
        InjectedFault,
    )

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    N = int(rng.choice([24, 32]))
    K = int(rng.choice([1, 2]))
    plan = serve.FactorPlan.create((N, N), torch.float32, v=8)
    menu = [
        FaultSpec("heartbeat", "crash", prob=0.4,
                  count=int(rng.integers(1, 4))),
        FaultSpec("heartbeat", "delay", prob=0.3, delay_s=0.002,
                  count=3),
        FaultSpec("route", "crash", prob=0.4,
                  count=int(rng.integers(1, 3))),
        FaultSpec("migrate", "crash", prob=0.5, count=1),
        FaultSpec("replicate", "crash", prob=0.6,
                  count=int(rng.integers(1, 3))),
        FaultSpec("host_kill", "kill", prob=0.5, count=1),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    killful = any(f.site == "host_kill" for f in picks)
    label = (f"seed={seed} elastic N={N} K={K} "
             f"faults={[(f.site, f.kind) for f in picks]}")
    ok_exc = (HostUnavailable, FleetDegraded, InjectedFault,
              EngineSaturated)

    def with_patience(fn, what, deadline_s=30.0):
        t0 = time.time()
        while True:
            try:
                return fn()
            except ok_exc as e:
                if time.time() - t0 > deadline_s:
                    raise TimeoutError(
                        f"{what} never recovered: {e}")
                time.sleep(min(0.05, max(0.01,
                                         getattr(e, "retry_after",
                                                 0.0))))

    pol = FabricPolicy(heartbeat_interval=0.02, heartbeat_timeout=1.0,
                       suspect_after=2, dead_after=3, replicas=K)
    answered = joins = leaves = kills = abandons = rollbacks = 0
    opened = closed = 0
    with tempfile.TemporaryDirectory() as tmp:
        fab = fabric_mod.local_fabric(
            2, tmp, policy=pol, fault_plan=faults,
            engine_kwargs=ENGINE)

        def provider(hid):
            return LocalHost(hid, os.path.join(tmp, hid),
                             engine_kwargs=ENGINE)

        # util = sessions/host / 4 under this capacity model, so the
        # wave's peak (~5 sids/host) forces scale-out and its trough
        # (<1 sid/host) forces drain-and-shrink
        auto = FabricAutoscaler(fab, provider, policy=AutoscalePolicy(
            min_hosts=2, max_hosts=4, low_water=0.25, high_water=0.8,
            sustain=2, cooldown=3.0, bytes_per_session=525e3,
            host_bytes=4 * 525e3,
            max_rebalance_moves=2, rebalance_floor=3,
            rebalance_ratio=1.5))
        clock = 0.0
        try:
            with fab:
                As, pre, rhs = {}, {}, {}

                def admit(i):
                    nonlocal opened
                    sid = f"el-{seed}-{i}"
                    A = (rng.standard_normal((N, N)) / np.sqrt(N)
                         + 2.0 * np.eye(N)).astype(np.float32)
                    with_patience(lambda: fab.open(sid, plan, A),
                                  f"admission of {sid}")
                    As[sid] = pre[sid] = A.astype(np.float64)
                    rhs[sid] = rng.standard_normal(
                        (N, int(rng.choice([1, 2])))).astype(
                            np.float32)
                    opened += 1
                    if rng.integers(3) == 0:  # drift (oracle tracks)
                        k = int(rng.integers(1, 3))
                        U = (0.01 * rng.standard_normal((N, k))
                             ).astype(np.float32)
                        Vm = (0.01 * rng.standard_normal((N, k))
                              ).astype(np.float32)
                        try:
                            fab.update(sid, U, Vm)
                            As[sid] = (As[sid]
                                       + U.astype(np.float64)
                                       @ Vm.astype(np.float64).T)
                        except ok_exc:
                            pass
                    return sid

                def check(sid):
                    nonlocal answered, rollbacks
                    b = rhs[sid]
                    x = with_patience(lambda: np.asarray(
                        fab.solve(sid, b)), f"solve of {sid}")
                    want = np.linalg.solve(As[sid],
                                           b.astype(np.float64))
                    err = (np.linalg.norm(x - want)
                           / max(np.linalg.norm(want), 1e-30))
                    if not (err < 1e-3):
                        wpre = np.linalg.solve(pre[sid],
                                               b.astype(np.float64))
                        epre = (np.linalg.norm(x - wpre)
                                / max(np.linalg.norm(wpre), 1e-30))
                        if epre < 1e-3:
                            # fail-over revived the last durable
                            # state: legal rollback, now authoritative
                            As[sid] = pre[sid]
                            rollbacks += 1
                        else:
                            raise AssertionError(
                                f"{sid} off its own oracle "
                                f"({err:.2e}) — cross-host "
                                "corruption?")
                    answered += 1

                def chaos():
                    nonlocal joins, leaves, kills, abandons
                    arm = int(rng.integers(5))
                    hosts = sorted(fab.stats()["hosts"])
                    alive = [h for h in hosts
                             if fab.host_state(h) == "alive"]
                    if arm == 0:  # join storm
                        hid = f"j{seed % 1000}-{joins}"
                        fab.add_host(provider(hid))
                        joins += 1
                    elif arm == 1 and len(alive) > 2:  # drain-leave
                        victim = alive[int(rng.integers(len(alive)))]
                        try:
                            fab.remove_host(victim)
                            leaves += 1
                        except (HostUnavailable, FleetDegraded,
                                ValueError, KeyError):
                            abandons += 1  # abandoned, never half-done
                    elif arm == 2 and len(alive) > 2:  # abrupt kill
                        victim = alive[int(rng.integers(len(alive)))]
                        fab._hosts[victim].kill()
                        kills += 1

                # ---- the diurnal wave ----------------------------- #
                sids: list = []
                peak = int(rng.integers(8, 12))
                for i in range(peak):          # morning ramp
                    sids.append(admit(i))
                    if rng.integers(2):
                        check(sids[int(rng.integers(len(sids)))])
                    auto.step(now=clock)
                    clock += 1.0
                chaos()
                for _ in range(4):             # midday plateau
                    for sid in sids:
                        check(sid)
                    auto.step(now=clock)
                    clock += 1.0
                    chaos()
                rng.shuffle(sids)
                while len(sids) > 2:           # evening recede
                    sid = sids.pop()
                    with_patience(lambda: fab.close_session(sid),
                                  f"close of {sid}")
                    closed += 1
                    del As[sid], pre[sid], rhs[sid]
                    auto.step(now=clock)
                    clock += 1.0
                for _ in range(6):             # night: shrink beats
                    for sid in sids:
                        check(sid)
                    auto.step(now=clock)
                    clock += 1.0

                # ---- conservation + zero-lost gates --------------- #
                st = fab.stats()
                if (st["admitted_sessions"] != st["sessions"]
                        + st["lost_sessions"] + st["closed_sessions"]):
                    return False, (f"{label}: census identity broken "
                                   f"({st['admitted_sessions']} != "
                                   f"{st['sessions']}+"
                                   f"{st['lost_sessions']}+"
                                   f"{st['closed_sessions']})")
                if st["sessions"] != len(sids) or st["closed_sessions"] != closed:
                    return False, (f"{label}: census drifted from the "
                                   f"trial's own ledger "
                                   f"({st['sessions']} open != "
                                   f"{len(sids)} or "
                                   f"{st['closed_sessions']} closed "
                                   f"!= {closed})")
                if st["lost_sessions"]:
                    return False, (f"{label}: elastic churn lost "
                                   f"{st['lost_sessions']} sessions")
                deaths = sum(1 for h in st["hosts"].values()
                             if h["state"] == "dead")
                if deaths > kills + (1 if killful else 0):
                    return False, (f"{label}: {deaths} deaths exceed "
                                   f"{kills} explicit + injected "
                                   "kills")
                for sid in sids:
                    check(sid)
                ast = auto.stats()
        finally:
            fab.close()

    return True, (f"{label}: ok {answered} solves, {opened} opened, "
                  f"{closed} closed, {rollbacks} rollbacks; "
                  f"membership {joins} joins, {leaves} leaves, "
                  f"{kills} kills, {abandons} abandoned drains; "
                  f"autoscaler out={ast['scale_out']} "
                  f"in={ast['scale_in']} "
                  f"rebalanced={ast['rebalanced']} "
                  f"ticks={ast['ticks']}; "
                  f"injected={sum(faults.injected.values())}")


TRIALS = {"serve": run_serve_trial, "tier": run_tier_trial, "fabric": run_fabric_trial,
          "elastic": run_elastic_trial}


def soak(mode: str, trials: int = 20, seed: int = 0, time_budget: float | None = None,
         keep_going: bool = False, lockcheck: bool = False, replay: int | None = None,
         emit=print) -> dict:
    """Run `mode`'s trials (seeds seed, seed+1, ...; or the one seed
    `replay`) until `trials` ran, `time_budget` seconds passed or, without
    `keep_going`, one failed; with `lockcheck` under
    `conflux_tpu_torch.analysis.lockcheck.watch()` (this process's locks
    only: fabric workers are processes of their own). Returns {"trials",
    "fails", "seconds", "lockcheck": the watch's report or None}."""
    import contextlib

    trial = TRIALS[mode]
    cm = contextlib.nullcontext(None)
    if lockcheck:
        from conflux_tpu_torch.analysis import lockcheck as lockcheck_mod

        cm = lockcheck_mod.watch()
    t0 = time.time()
    ran = fails = 0
    with cm as lc:
        seeds = [replay] if replay is not None else range(seed, seed + trials)
        for s in seeds:
            if replay is None and time_budget and time.time() - t0 > time_budget:
                emit(f"time budget reached after {ran} trials")
                break
            ok, msg = trial(s)
            ran += 1
            emit(("PASS " if ok else "FAIL ") + msg)
            if not ok:
                fails += 1
                if not keep_going:
                    break
    rep = None
    if lc is not None:
        rep = lc.report()
        emit(f"lockcheck: {rep['locks']} locks, {rep['acquisitions']} acquisitions, "
             f"{rep['order_edges']} order edges, {rep['stash_edges']} victim-stash edges, "
             f"{len(rep['violations'])} violation(s)")
        for v in rep["violations"]:
            emit("LOCKCHECK " + v)
    return {"trials": ran, "fails": fails, "seconds": time.time() - t0, "lockcheck": rep}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--serve", action="store_true",
                      help="the engine with the full HealthPolicy under the serve fault "
                      "menu (staging NaN, dispatch/drain/d2h/refresh delays and crashes, "
                      "unhealthy verdicts) over clean, poisoned and expired traffic")
    mode.add_argument("--tier", action="store_true",
                      help="Zipf traffic over a fleet larger than the device tier through a "
                      "ResidentSet-managed engine, under the spill/revive/disk fault sites")
    mode.add_argument("--fabric", action="store_true",
                      help="kill/revive/migrate chaos over LocalHost fleets, then the shm "
                      "wire under its fault sites")
    mode.add_argument("--elastic", action="store_true",
                      help="diurnal waves over an autoscaled fleet with join/leave/kill/"
                      "drain storms")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--time-budget", type=float, default=None,
                    help="stop after this many seconds")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; trial i uses seed base+i")
    ap.add_argument("--replay", type=int, default=None,
                    help="re-run exactly one trial seed and exit")
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--lockcheck", action="store_true",
                    help="run the trials under conflux_tpu_torch.analysis.lockcheck: every "
                    "lock the port creates is instrumented, and a lock-order cycle or an "
                    "engine lock held across a serve.* dispatch region fails the soak")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    if args.platform == "gpu" and not torch.cuda.is_available():
        print("torch_soak: no card (pass --platform cpu for the plain versions)")
        return 2
    ENGINE["device"] = "cpu" if args.platform == "cpu" else "cuda"
    name = next(m for m in TRIALS if getattr(args, m))
    out = soak(name, args.trials, args.seed, args.time_budget, args.keep_going,
               args.lockcheck, args.replay, emit=lambda m: print(m, flush=True))
    if args.replay is None:
        print(f"torch_soak: {out['fails']} failures / {out['trials']} trials in "
              f"{out['seconds']:.0f}s on {ENGINE['device']}", flush=True)
    bad_locks = out["lockcheck"] is not None and out["lockcheck"]["violations"]
    return 1 if out["fails"] or bad_locks else 0


if __name__ == "__main__":
    sys.exit(main())
