"""Production-scale replay on the card: the port's counterpart of
`scripts/replay.py`, the macro harness of the serving stack.

Drives 10^4-10^5 sessions through the whole serving stack at once
(tiering, gangs, lanes, QoS, the adaptive controller and the multi-host
fabric) from an open-loop scenario generator (Zipf session popularity,
diurnal arrival waves, drift storms, tenant mixes, chaos events from the
tier and fabric fault menus), and prints the capacity model. Three legs,
under the reference's function names:

(a) control plane (`control_plane_leg`): the O(log F) victim pick against
    the materialize-and-sort baseline, on one live `ResidentSet` of
    --fleet metadata-only sessions, flipping `_lru_impl` between
    interleaved adjacent picks on the same fleet state (alternating
    order, median of per-pair ratios). Every pair also checks that both
    picks chose the same victim set. Gate: the heap pick >=
    --speedup-gate x cheaper per victim.

(b) macro serve (`make_schedule`, `build_fabric`, `open_fleet`,
    `adopt_and_warm`, `run_trace`, `residual_check`,
    `checkpoint_contrast`): --fleet sessions open on a `LocalHost` fabric
    whose per-host engines run tiered residency at --device-cap (the
    capacity model: fleet >= --capacity-gate x device slots), then an
    open-loop diurnal trace of classed solves and drift storms. Latency
    counts from the scheduled arrival (queueing included), attainment per
    QoS class against its SLO. Gates: >= --attainment-gate % of requests
    inside their SLO; the resident high-water never above the cap. The
    leg closes with one full checkpoint generation against one delta
    generation after a storm dirties ~--storm-frac of the fleet.

(c) chaos (`chaos_leg`): a smaller fleet under the tier fault menu, a
    mid-traffic host kill with K=2 replicas and background delta
    checkpoints: fail-over adopts from the delta chain, the census
    (admitted == open + lost + closed) holds exactly, zero sessions are
    lost, and sampled survivors still solve against the numpy oracle.

The hosts are `LocalHost`s in this process, their engines all on one card
(cuda:0); `--platform cpu` runs them on the CPU with the kernels' plain
versions. The closing line is the reference's JSON summary, followed by
each gate's reading; `--out PATH` also writes the whole record there (no
file is written otherwise). Exits nonzero when any gate or invariant
fails.

Usage:
    python scripts/torch_replay.py [--smoke] [--fleet 10000] [--hosts 2]
        [--device-cap 5] [--duration 40] [--rate 70] [--seed 0]
        [--platform cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from conflux_tpu_torch import profiler, serve  # noqa: E402
from conflux_tpu_torch import tier as tier_mod  # noqa: E402
from conflux_tpu_torch.control import AdaptiveController  # noqa: E402
from conflux_tpu_torch.engine import EngineSaturated, ServeEngine  # noqa: E402
from conflux_tpu_torch.fabric import FabricPolicy, LocalHost, ServeFabric  # noqa: E402
from conflux_tpu_torch.qos import QosClass  # noqa: E402
from conflux_tpu_torch.resilience import (  # noqa: E402
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    FleetDegraded,
    HostUnavailable,
    InjectedFault,
    RestoreCorrupt,
    RhsNonFinite,
    SessionQuarantined,
    SessionSpilled,
    SolveUnhealthy,
)
from conflux_tpu_torch.tier import ResidentSet  # noqa: E402

# structured (expected) request failures: retried with patience where the
# scenario allows, never counted as invariant violations
OK_EXC = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy,
          SessionQuarantined, SessionSpilled, RestoreCorrupt,
          InjectedFault, EngineSaturated, HostUnavailable, FleetDegraded)


# --------------------------------------------------------------------------- #
# leg (a): control-plane micro-bench on a metadata-only fleet
# --------------------------------------------------------------------------- #


class _StubSession:
    """The tier layer's view of a session (lock, LRU stamp, byte gauge,
    checkpoint version, spill record, placement) with no device state, so
    a 10^5 fleet of them costs kilobytes and `_pick_victims` (which only
    marks victims) runs the production control path with no device
    traffic. `device` None: the session counts in no device's domain."""

    __slots__ = ("_lock", "_residency", "_tier_stamp", "_spill",
                 "_ckpt_ver", "nbytes", "device")

    def __init__(self, nbytes: int) -> None:
        self._lock = threading.RLock()
        self._residency = None
        self._tier_stamp = 0
        self._spill = None
        self._ckpt_ver = 0
        self.nbytes = nbytes
        self.device = None


def control_plane_leg(fleet: int, pairs: int, victims_per_pick: int,
                      touches_per_round: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    rs = ResidentSet(evict_batch=1, max_concurrent_revives=None)
    stubs = [_StubSession(25_000) for _ in range(fleet)]
    rs.adopt(*stubs)

    # Zipf touch popularity over a shuffled rank order (hot head, long
    # cold tail: the shape that makes LRU maintenance interesting)
    order = rng.permutation(fleet)
    pmf = 1.0 / np.arange(1, fleet + 1) ** 1.1
    pmf /= pmf.sum()

    def touch_round() -> None:
        for r in rng.choice(fleet, size=touches_per_round, p=pmf):
            stubs[order[r]]._tier_stamp = rs._tick()

    def one_pick(impl: str) -> tuple[float, frozenset]:
        rs._lru_impl = impl
        t0 = time.perf_counter()
        victims = rs._pick_victims(0, 0)
        dt = time.perf_counter() - t0
        sids = frozenset(id(s) for s in victims)
        with rs._lock:  # revert: stamps untouched, invariants kept
            for s in victims:
                rs._set_state(id(s), s, "resident")
        return dt, sids

    # count pressure of exactly `victims_per_pick` per wave
    rs.max_sessions = fleet - victims_per_pick
    touch_round()
    one_pick("sort"), one_pick("heap")  # warm both paths
    ratios, sort_us, heap_us, mismatches = [], [], [], 0
    for i in range(pairs):
        touch_round()
        legs = ("sort", "heap") if i % 2 == 0 else ("heap", "sort")
        res = {impl: one_pick(impl) for impl in legs}
        if res["sort"][1] != res["heap"][1]:
            mismatches += 1
        su = res["sort"][0] / victims_per_pick * 1e6
        hu = res["heap"][0] / victims_per_pick * 1e6
        sort_us.append(su)
        heap_us.append(hu)
        ratios.append(su / hu)
    rs._lru_impl = "heap"
    return {
        "fleet": fleet,
        "pairs": pairs,
        "victims_per_pick": victims_per_pick,
        "sort_us_per_victim_p50": round(statistics.median(sort_us), 2),
        "heap_us_per_victim_p50": round(statistics.median(heap_us), 2),
        "speedup_x": round(statistics.median(ratios), 2),
        "victim_set_mismatches": mismatches,
    }


# --------------------------------------------------------------------------- #
# scenario generation (leg b)
# --------------------------------------------------------------------------- #

# tenant mix: (name, tier, slo seconds, weight, arrival share), the
# reference's: a solve is ms-scale, but the first stacked-gang width
# builds mid-trace once per bucket and the open-loop clock charges
# queueing to the request
TENANTS = (
    ("gold", "latency", 2.0, 3.0, 0.2),
    ("silver", "throughput", 4.0, 2.0, 0.5),
    ("bronze", "batch", 8.0, 1.0, 0.3),
)


def make_schedule(rng: np.random.Generator, fleet: int, duration: float,
                  rate: float, storms: int, storm_frac: float) -> list:
    """Open-loop event list [(t, kind, session index, tenant index)],
    sorted by t, the reference's draw for draw. Arrivals follow a diurnal
    wave lambda(t) = rate (1 + 0.6 sin(2 pi t / (duration/2))); session
    popularity is Zipf(1.1) over a shuffled rank order; drift storms each
    dirty ~storm_frac of the fleet over a front of 8% of the duration."""
    pmf = 1.0 / np.arange(1, fleet + 1) ** 1.1
    pmf /= pmf.sum()
    order = rng.permutation(fleet)
    shares = np.array([t[4] for t in TENANTS])
    events = []
    slots = 100
    dt = duration / slots
    for k in range(slots):
        t0 = k * dt
        lam = rate * (1.0 + 0.6 * np.sin(2 * np.pi * t0 / (duration / 2)))
        n = rng.poisson(max(lam, 1.0) * dt)
        for _ in range(n):
            sess = int(order[rng.choice(fleet, p=pmf)])
            ten = int(rng.choice(len(TENANTS), p=shares))
            events.append((t0 + float(rng.random()) * dt, "solve", sess, ten))
    for s in range(storms):
        t = duration * (s + 0.4) / storms
        width = duration * 0.08  # a storm front, not one instant
        for idx in rng.choice(fleet, size=max(1, int(fleet * storm_frac)),
                              replace=False):
            events.append((t + float(rng.random()) * width, "update", int(idx), 0))
    events.sort(key=lambda e: e[0])
    return events


def build_fabric(root: str, hosts: int, device_cap: int, *,
                 replicas: int = 1, checkpoint_interval: float = 0.0,
                 compact_every: int = 8, fault_plan=None,
                 heartbeat: float = 0.5, slo_ms: float = 1000.0,
                 dead_after: int = 6, device=None) -> ServeFabric:
    """A LocalHost fabric whose hosts each run the full serving stack:
    tiered residency at `device_cap`, session-stacking gangs, the adaptive
    controller, QoS classification. `device` is every host engine's
    (default: the card)."""
    hs = []
    for i in range(hosts):
        rs = ResidentSet(max_sessions=device_cap, evict_batch=2,
                         max_concurrent_revives=4, fault_plan=fault_plan)
        eng = ServeEngine(max_batch_delay=0.0, residency=rs,
                          stack_sessions=True,
                          controller=AdaptiveController(slo_p99_ms=slo_ms, interval=0.5),
                          fault_plan=fault_plan, device=device)
        hs.append(LocalHost(f"h{i}", os.path.join(root, f"h{i}"), engine=eng))
    pol = FabricPolicy(heartbeat_interval=heartbeat,
                       heartbeat_timeout=2.0,
                       suspect_after=2, dead_after=dead_after,
                       checkpoint_interval=checkpoint_interval,
                       checkpoint_keep=3,
                       checkpoint_compact_every=compact_every,
                       replicas=replicas,
                       # a per-open fleet snapshot is O(F): at 10^4
                       # sessions durability comes from the periodic
                       # (incremental) rounds instead
                       durable_open=False)
    return ServeFabric(hs, policy=pol, fault_plan=fault_plan, root=root)


def _retry(call, what: str, patience: float = 30.0, pause=None):
    """call() until it returns, retrying the structured refusals for
    `patience` seconds (then TimeoutError naming `what`). `pause` is the
    wait between tries (default: the refusal's retry hint within [5, 50]
    ms)."""
    t0 = time.time()
    while True:
        try:
            return call()
        except OK_EXC as e:
            if time.time() - t0 > patience:
                raise TimeoutError(f"{what}: {e}") from e
            time.sleep(pause if pause is not None
                       else min(0.05, max(0.005, getattr(e, "retry_after", 0.0))))


def open_fleet(fab: ServeFabric, plan, rng: np.random.Generator,
               n: int, nsize: int, oracle_every: int) -> dict:
    """Admit n sessions; keep float64 copies of every `oracle_every`-th A
    for the residual spot checks. Returns {index: A64}."""
    oracles = {}
    eye = 2.0 * np.eye(nsize, dtype=np.float64)
    for i in range(n):
        A = (rng.standard_normal((nsize, nsize)) / np.sqrt(nsize) + eye).astype(np.float32)
        # a background checkpoint's drain barrier briefly pauses
        # admission: structured, retryable
        _retry(lambda: fab.open(f"s{i:06d}", plan, A),
               f"admission of s{i:06d} never landed")
        if i % oracle_every == 0:
            oracles[i] = A.astype(np.float64)
    return oracles


def adopt_and_warm(fab: ServeFabric, nsize: int, warm: int = 16) -> None:
    """Bring every host's registry under its tiered ResidentSet (the fabric
    registers sessions; tiering them is the deployment's call), then run
    a few unmeasured solves so the one-time kernel builds and revive paths
    don't land inside the open-loop latency clock."""
    for h in fab._hosts.values():
        core = h.core
        with core._lock:
            sess = list(core._registry.values())
        rs = core.eng.residency
        if rs is not None and sess:
            rs.adopt(*sess)
    rng = np.random.default_rng(7)
    for i in range(warm):
        b = rng.standard_normal((nsize, 1)).astype(np.float32)
        _retry(lambda: fab.solve(f"s{i:06d}", b), f"warm-up solve of s{i:06d}", pause=0.01)


def run_trace(fab: ServeFabric, events: list, nsize: int, *,
              workers: int, rng_seed: int,
              retry_deadline: float = 30.0) -> dict:
    """Replay the open-loop schedule through the fabric front. Latency
    counts from the scheduled arrival; structured refusals are retried
    inside the request's patience window."""
    qos_by_tenant = [QosClass(tenant=t[0], tier=t[1], slo=t[2], weight=t[3])
                     for t in TENANTS]
    lat: dict[str, list] = {t[0]: [] for t in TENANTS}
    errors: list[str] = []
    updated: set[int] = set()
    cursor = [0]
    lock = threading.Lock()
    t_start = time.time()

    def worker(wid: int) -> None:
        rng = np.random.default_rng(rng_seed + wid)
        while True:
            with lock:
                i = cursor[0]
                if i >= len(events):
                    return
                cursor[0] = i + 1
            t, kind, sess, ten = events[i]
            delay = t_start + t - time.time()
            if delay > 0:
                time.sleep(delay)
            sid = f"s{sess:06d}"
            try:
                if kind == "solve":
                    b = rng.standard_normal((nsize, 1)).astype(np.float32)
                    _retry(lambda: fab.solve(sid, b, qos=qos_by_tenant[ten]),
                           f"{sid}: no answer inside patience", retry_deadline)
                    with lock:
                        lat[TENANTS[ten][0]].append(time.time() - (t_start + t))
                else:
                    u = (rng.standard_normal((nsize, 1)) / nsize).astype(np.float32)
                    v = rng.standard_normal((nsize, 1)).astype(np.float32)
                    _retry(lambda: fab.update(sid, u, v), f"{sid}: update never landed",
                           retry_deadline)
                    with lock:
                        updated.add(sess)
            except Exception as e:  # noqa: BLE001 — tallied, not raised
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    out: dict = {"wall_s": round(time.time() - t_start, 2),
                 "updates": len(updated), "updated_sessions": updated,
                 "errors": errors}
    total = inside = 0
    by_class = {}
    for name, _tier, slo, _w, _share in TENANTS:
        ls = lat[name]
        n_in = sum(1 for v in ls if v <= slo)
        total += len(ls)
        inside += n_in
        by_class[name] = {
            "requests": len(ls),
            "slo_s": slo,
            "attainment_pct": round(100.0 * n_in / len(ls), 2) if ls else 100.0,
            "p50_ms": round(1e3 * float(np.median(ls)), 2) if ls else 0.0,
            "p99_ms": round(1e3 * float(np.percentile(ls, 99)), 2) if ls else 0.0,
        }
    out["requests"] = total
    out["attainment_pct"] = round(100.0 * inside / total, 2) if total else 100.0
    out["by_class"] = by_class
    return out


def residual_check(fab: ServeFabric, oracles: dict, nsize: int,
                   seed: int, bound: float = 1e-3) -> list:
    """Sampled end-to-end correctness: every oracle session must solve to a
    small float64 residual through the full stack (a fault-in from
    whatever tier it sits in included)."""
    rng = np.random.default_rng(seed)
    bad = []
    for idx, A64 in oracles.items():
        sid = f"s{idx:06d}"
        b = rng.standard_normal((nsize, 1)).astype(np.float32)
        try:
            x = np.asarray(_retry(lambda: fab.solve(sid, b), f"{sid}: unanswerable",
                                  pause=0.02), dtype=np.float64)
        except TimeoutError as e:
            bad.append(str(e))
            continue
        r = np.linalg.norm(A64 @ x - b.astype(np.float64))
        r /= np.linalg.norm(b) + 1e-30
        if not np.isfinite(r) or r > bound:
            bad.append(f"{sid}: residual {r:.2e} > {bound:g}")
    return bad


def checkpoint_contrast(fab: ServeFabric, fleet: int, nsize: int,
                        storm_frac: float, seed: int) -> tuple[dict, set]:
    """One full checkpoint generation against one delta generation after a
    drift storm dirties ~storm_frac of the fleet. Clean sessions are
    carried as fleet.json pointers (no serialization, no file copy), so
    the delta's wall-clock tracks the dirty population, not the fleet.
    Returns (the contrast, the dirtied session indices)."""
    rng = np.random.default_rng(seed)

    def tick() -> dict:
        s = tier_mod.tier_stats()
        return {"written": s.get("checkpoint_records_written", 0),
                "carried": s.get("checkpoint_records_carried", 0)}

    t0 = time.time()
    fab.checkpoint_all()
    full_s = time.time() - t0
    base = tick()
    dirty = rng.choice(fleet, size=max(1, int(fleet * storm_frac)), replace=False)
    for idx in dirty:
        u = (rng.standard_normal((nsize, 1)) / nsize).astype(np.float32)
        v = rng.standard_normal((nsize, 1)).astype(np.float32)
        _retry(lambda: fab.update(f"s{int(idx):06d}", u, v),
               f"storm update of s{int(idx):06d}", pause=0.01)
    t0 = time.time()
    fab.checkpoint_all()
    delta_s = time.time() - t0
    after = tick()
    return {
        "full_s": round(full_s, 3),
        "delta_s": round(delta_s, 3),
        "delta_speedup_x": round(full_s / max(delta_s, 1e-9), 2),
        "storm_dirty_sessions": int(len(dirty)),
        "delta_records_written": after["written"] - base["written"],
        "delta_records_carried": after["carried"] - base["carried"],
    }, {int(i) for i in dirty}


# --------------------------------------------------------------------------- #
# leg (c): chaos — fault menu + host kill over delta-chain checkpoints
# --------------------------------------------------------------------------- #


def chaos_leg(tmp: str, fleet: int, nsize: int, seed: int, *, device=None) -> dict:
    """The chaos leg on `device` (default: the card). Returns its readings
    with "violations", the invariants it found broken."""
    rng = np.random.default_rng(seed)
    faults = FaultPlan([
        FaultSpec(site="spill", kind="delay", prob=0.05, delay_s=0.002),
        FaultSpec(site="revive", kind="delay", prob=0.05, delay_s=0.002),
        FaultSpec(site="revive", kind="crash", prob=0.01, count=8),
        FaultSpec(site="dispatch", kind="delay", prob=0.02, delay_s=0.002),
    ], seed=seed)
    plan = serve.FactorPlan.create((nsize, nsize), torch.float32, v=8)
    root = os.path.join(tmp, "chaos")
    fab = build_fabric(root, 3, 8, replicas=2,
                       checkpoint_interval=0.25, compact_every=3,
                       fault_plan=faults, heartbeat=0.05, slo_ms=500.0,
                       dead_after=3, device=device)
    out: dict = {"fleet": fleet}
    violations: list[str] = []
    with fab:
        oracles = open_fleet(fab, plan, rng, fleet, nsize, oracle_every=max(1, fleet // 16))
        adopt_and_warm(fab, nsize, warm=8)
        # let the background loop lay down a full + delta chain
        deadline = time.time() + 6.0
        while time.time() < deadline:
            s = tier_mod.tier_stats()
            if (s.get("checkpoint_records_carried", 0) > 0
                    and fab.stats()["checkpoint_rounds"] >= 3):
                break
            time.sleep(0.1)
        events = make_schedule(rng, fleet, 6.0, 40.0, storms=2, storm_frac=0.05)
        killed = []

        def killer() -> None:
            time.sleep(2.0)
            hid = max(fab.stats()["hosts"].items(), key=lambda kv: kv[1]["sessions"])[0]
            killed.append(hid)
            fab._hosts[hid].kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        trace = run_trace(fab, events, nsize, workers=6, rng_seed=seed + 17)
        kt.join()
        # fail-over must complete: the corpse declared dead, sessions
        # re-pointed at replica records off the delta chain
        deadline = time.time() + 20.0
        while time.time() < deadline:
            if fab.stats()["hosts"][killed[0]]["state"] == "dead":
                break
            time.sleep(0.1)
        st = fab.stats()
        carried = tier_mod.tier_stats().get("checkpoint_records_carried", 0)
        out["killed_host"] = killed[0]
        out["recoveries"] = len(st["recoveries"])
        out["recovery_s_max"] = st["recovery_s_max"]
        out["lost_sessions"] = st["lost_sessions"]
        out["census"] = {k: st[k] for k in ("admitted_sessions", "sessions",
                                             "lost_sessions", "closed_sessions")}
        out["trace"] = {k: trace[k] for k in ("requests", "attainment_pct", "updates",
                                              "wall_s")}
        out["faults_injected"] = {f"{k[0]}/{k[1]}": v for k, v in faults.injected.items()}
        if st["hosts"][killed[0]]["state"] != "dead":
            violations.append("chaos: killed host never declared dead")
        if st["lost_sessions"]:
            violations.append(f"chaos: {st['lost_sessions']} sessions lost despite "
                              f"K=2 replicas + delta chain")
        if (st["admitted_sessions"]
                != st["sessions"] + st["lost_sessions"] + st["closed_sessions"]):
            violations.append(
                f"chaos: census identity broken: admitted={st['admitted_sessions']} != "
                f"open={st['sessions']} + lost={st['lost_sessions']} "
                f"+ closed={st['closed_sessions']}")
        if carried <= 0:
            violations.append("chaos: no carried records — the delta chain was never "
                              "exercised")
        if trace["errors"]:
            violations.append(f"chaos: {len(trace['errors'])} unstructured request "
                              f"failures, first: {trace['errors'][0]}")
        sampled = {i: a for i, a in oracles.items() if i not in trace["updated_sessions"]}
        bad = residual_check(fab, sampled, nsize, seed + 23)
        out["oracle_sessions"], out["oracle_failures"] = len(sampled), len(bad)
        if bad:
            violations.append(f"chaos: {len(bad)} survivors failed the oracle, "
                              f"first: {bad[0]}")
    out["violations"] = violations
    return out


# --------------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------------- #


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fleet", type=int, default=10_000,
                    help="macro + control-plane fleet size")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--device-cap", type=int, default=5,
                    help="resident sessions per host engine: the device tier of the "
                    "capacity model")
    ap.add_argument("-N", type=int, default=48, help="system size")
    ap.add_argument("--duration", type=float, default=40.0,
                    help="open-loop trace length (seconds)")
    ap.add_argument("--rate", type=float, default=70.0,
                    help="mean arrival rate (requests/s) of the wave")
    ap.add_argument("--workers", type=int, default=12, help="open-loop client threads")
    ap.add_argument("--pairs", type=int, default=40,
                    help="interleaved sort/heap pick pairs (leg a)")
    ap.add_argument("--storm-frac", type=float, default=0.01,
                    help="fleet fraction dirtied per drift storm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speedup-gate", type=float, default=5.0,
                    help="min median sort/heap victim-pick cost ratio")
    ap.add_argument("--attainment-gate", type=float, default=99.0,
                    help="min %% of classed requests inside SLO")
    ap.add_argument("--capacity-gate", type=float, default=1000.0,
                    help="min fleet / device-slot ratio the macro leg must run at")
    ap.add_argument("--smoke", action="store_true",
                    help="CI shape: fleet ~2k, seconds not minutes, looser gates")
    ap.add_argument("--out", default=None, help="write the whole record here as JSON")
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="run the host engines on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, record: dict | None = None) -> int:
    """Run the three legs; `record`, when given, receives the whole record
    (the dict `--out` writes). Returns the exit status."""
    args = parse_args(argv)
    if args.platform is None and not torch.cuda.is_available():
        raise RuntimeError("torch_replay: no card (pass --platform cpu for the plain "
                           "versions on the CPU)")
    device = "cpu" if args.platform == "cpu" else None
    if args.smoke:
        args.fleet = min(args.fleet, 2000)
        args.duration = min(args.duration, 10.0)
        args.rate = min(args.rate, 50.0)
        args.pairs = min(args.pairs, 12)
        args.workers = min(args.workers, 8)
        args.speedup_gate = min(args.speedup_gate, 1.5)
        args.attainment_gate = min(args.attainment_gate, 90.0)
        args.capacity_gate = min(args.capacity_gate, 100.0)
    chaos_fleet = 96 if args.smoke else 240
    rng = np.random.default_rng(args.seed)
    violations: list[str] = []

    print(f"[replay] leg a: control plane, F={args.fleet}, {args.pairs} interleaved pairs",
          flush=True)
    ctl = control_plane_leg(args.fleet, args.pairs, victims_per_pick=8,
                            touches_per_round=2000, seed=args.seed)
    if ctl["victim_set_mismatches"]:
        violations.append(f"control plane: {ctl['victim_set_mismatches']} pairs where heap "
                          f"and sort picked different victim sets")

    capacity = args.hosts * args.device_cap
    ratio = args.fleet / capacity
    print(f"[replay] leg b: macro serve, F={args.fleet} on {args.hosts} hosts x "
          f"{args.device_cap} slots ({ratio:.0f}x capacity)", flush=True)
    profiler.clear()
    tier_mod.clear_tier()
    plan = serve.FactorPlan.create((args.N, args.N), torch.float32, v=8)
    with tempfile.TemporaryDirectory() as tmp:
        fab = build_fabric(os.path.join(tmp, "macro"), args.hosts, args.device_cap,
                           device=device)
        with fab:
            t0 = time.time()
            oracles = open_fleet(fab, plan, rng, args.fleet, args.N,
                                 oracle_every=max(1, args.fleet // 32))
            adopt_and_warm(fab, args.N)
            open_s = time.time() - t0
            events = make_schedule(rng, args.fleet, args.duration, args.rate, storms=3,
                                   storm_frac=args.storm_frac)
            trace = run_trace(fab, events, args.N, workers=args.workers,
                              rng_seed=args.seed + 1)
            fab.rebalance(max_moves=4)
            ckpt, ckpt_dirty = checkpoint_contrast(fab, args.fleet, args.N,
                                                   args.storm_frac, args.seed + 2)
            # drifted sessions' float64 oracles are stale by design: the
            # spot check covers the untouched ones
            stale = trace["updated_sessions"] | ckpt_dirty
            sampled = {i: a for i, a in oracles.items() if i not in stale}
            bad = residual_check(fab, sampled, args.N, args.seed + 3)
            st = fab.stats()
            tstats = tier_mod.tier_stats()
            gang: dict = {}
            mesh_unsupported = 0
            for hid in sorted(fab._hosts):
                eng = fab._hosts[hid].core.eng
                c = eng.counters()
                for k, v in c.items():
                    if ("gang" in k or "stack" in k) and isinstance(v, (int, float)):
                        gang[k] = gang.get(k, 0) + v
                mesh_unsupported += c.get("mesh_plan_unsupported", 0)
                hw = eng.residency.stats()["resident_high_water"]
                if hw > args.device_cap:
                    violations.append(f"{hid}: resident high-water {hw} > cap "
                                      f"{args.device_cap}")
            if mesh_unsupported:
                violations.append(f"macro: mesh_plan_unsupported={mesh_unsupported}")
            if trace["errors"]:
                violations.append(f"macro: {len(trace['errors'])} unstructured request "
                                  f"failures, first: {trace['errors'][0]}")
            if bad:
                violations.append(f"macro: {len(bad)} oracle sessions failed the residual "
                                  f"check, first: {bad[0]}")
            census = {k: st[k] for k in ("admitted_sessions", "sessions", "lost_sessions",
                                         "closed_sessions")}
            if (st["admitted_sessions"]
                    != st["sessions"] + st["lost_sessions"] + st["closed_sessions"]):
                violations.append(f"macro: census identity broken: {census}")
            churn = {k: tstats.get(k, 0) for k in ("spills_host", "revives_h2d",
                                                   "revives_refactor", "revive_rejects")}
            rstats = [fab._hosts[h].core.eng.residency.stats() for h in sorted(fab._hosts)]
            memory = {
                "device_bytes_high_water": max(r["device_bytes_high_water"] for r in rstats),
                "resident_high_water": max(r["resident_high_water"] for r in rstats),
                "resident_cap": args.device_cap,
            }

        print(f"[replay] leg c: chaos, F={chaos_fleet}", flush=True)
        chaos = chaos_leg(tmp, chaos_fleet, args.N, args.seed + 5, device=device)
        violations.extend(chaos.pop("violations"))

    speedup = ctl["speedup_x"]
    attainment = trace["attainment_pct"]
    gates = {
        "speedup": (speedup >= args.speedup_gate, f"{speedup} >= {args.speedup_gate}"),
        "attainment": (attainment >= args.attainment_gate,
                       f"{attainment} >= {args.attainment_gate}"),
        "capacity": (ratio >= args.capacity_gate, f"{ratio:.1f} >= {args.capacity_gate}"),
        "invariants": (not violations, f"{len(violations)} violations"),
    }
    out = {
        "metric": (f"control-plane replay F={args.fleet} at {ratio:.0f}x device capacity, "
                   f"N={args.N} f32 (heap vs sort victim pick, interleaved)"),
        "value": speedup,
        "unit": "x median per-victim pick cost, sort/heap",
        "device": (torch.cuda.get_device_name(0) if device is None else "cpu"),
        "control_plane_speedup_x": speedup,
        "speedup_gate_x": args.speedup_gate,
        "slo_attainment_pct": attainment,
        "attainment_gate_pct": args.attainment_gate,
        "capacity_model": {
            "fleet_sessions": args.fleet,
            "hosts": args.hosts,
            "device_slots_per_host": args.device_cap,
            "device_slots_total": capacity,
            "capacity_ratio_x": round(ratio, 1),
            "capacity_gate_x": args.capacity_gate,
            "bytes_per_session": int(memory["device_bytes_high_water"]
                                     / max(memory["resident_high_water"], 1)),
            "open_s": round(open_s, 1),
        },
        "control_plane": ctl,
        "trace": {k: trace[k] for k in ("requests", "attainment_pct", "updates", "wall_s",
                                        "by_class")},
        "checkpoint": ckpt,
        "churn": churn,
        "gang": gang,
        "memory": memory,
        "census": census,
        "oracle": {"sessions": len(sampled), "failures": len(bad)},
        "chaos": chaos,
        "gates": {name: ok for name, (ok, _r) in gates.items()},
        "invariant_violations": len(violations),
        "violations": violations,
        "config": {"seed": args.seed, "duration_s": args.duration,
                   "rate_per_s": args.rate, "workers": args.workers,
                   "smoke": bool(args.smoke)},
    }
    if record is not None:
        record.update(out)
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({k: out[k] for k in ("metric", "value", "slo_attainment_pct",
                                          "invariant_violations")}))
    for name, (ok, reading) in gates.items():
        print(f"[replay] gate {name}: {'PASS' if ok else 'FAIL'} ({reading})")
    for v in violations:
        print(f"[replay] VIOLATION: {v}")
    return 0 if all(ok for ok, _r in gates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
