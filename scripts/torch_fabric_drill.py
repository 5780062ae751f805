"""Worker-process drill of the port's serve fabric on one card: kill ->
detect -> fail-over -> migrate, over the shared-memory wire.

    python scripts/torch_fabric_drill.py [--dir DIR] [--ring-mib 8] [--json OUT]
    python scripts/torch_fabric_drill.py --platform cpu     # plain versions, small shapes

Each host is a worker process (`python -m conflux_tpu_torch.fabric
--worker`) with its own CUDA context on the one card; all six are started
together. The fleet (`fleet()`): six (32, 256, 256) float32 LU plans,
v=128 (the reference's serving shape), two (1024, 1024) float32 LU plans,
v=256, one of them drifted by rank 16, and two (32, 256, 256) float32 SPD
plans, v=128. Opens go through each worker's factor lane (K4, K5 for
SPD), solves through its solve lane (K3).

  1. healthy pass  - 192 requests of widths 1, 1, 2, 4 from 8 front
                     threads through a 2-worker fabric and a 1-worker
                     fabric: answers bitwise equal, the drifted session's
                     too (allclose 1e-5 on the CPU, whose plain products
                     sum in a width-dependent order), max |A x - b| < 1e-4;
                     each fabric's solves/s;
  2. migration     - one session hands off between the live workers and
                     answers bitwise;
  3. SIGKILL       - one worker of the 2-worker fabric is killed (the
                     handle is not told): a request routed at it raises
                     HostUnavailable inside the op timeout, the heartbeat
                     declares it dead, its fleet revives on the survivor
                     from its last checkpoint, every session answers
                     bitwise, none is lost;
  4. replicas      - a 3-worker fabric with K=2 replica placement: a
                     SIGKILLed worker's sessions are re-pointed to their
                     standbys (repointed == adopted >= 1), with no snapshot
                     restore, and answer bitwise;
  5. wire          - on that fabric, a worker emits a torn reply record:
                     the front reads WireCorrupt, declares it dead at once,
                     fails over bitwise, and no /dev/shm/cfxw-* segment is
                     left once the fabrics close.

Every worker's K3/K4/K5 launches come back through the host `stats` op
(a killed worker's from its last read before the kill). The exit status is
the gate; the last line is a JSON summary. Times are host times of this
run, printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from conflux_tpu_torch import resilience  # noqa: E402
from conflux_tpu_torch.engine import rendezvous  # noqa: E402
from conflux_tpu_torch.fabric import FabricPolicy, ProcessHost, ServeFabric  # noqa: E402
from conflux_tpu_torch.resilience import HostUnavailable  # noqa: E402
from conflux_tpu_torch.wire import WireConfig  # noqa: E402

WIDTHS = (1, 1, 2, 4)
REQUESTS, THREADS = 192, 8
DRIFT_RANK = 16
RECOVERY_BOUND_S = 60.0
KERNELS = ("btrsm", "batched_lu", "batched_chol")


def fleet(platform: str, bigs: int = 2) -> list:
    """[(sid, plan spec kwargs, seed)] of the drill's fleet with `bigs`
    single-system sessions; the CPU gets the same kinds at small shapes."""
    if platform == "cpu":
        small, big = ((4, 64, 64), 32), ((128, 128), 64)
    else:
        small, big = ((32, 256, 256), 128), ((1024, 1024), 256)
    out = [(f"lu-{i}", dict(shape=small[0], v=small[1], kind="lu"), 10 + i)
           for i in range(6)]
    out += [(f"big-{i}", dict(shape=big[0], v=big[1], kind="lu"), 20 + i) for i in range(bigs)]
    out += [(f"spd-{i}", dict(shape=small[0], v=small[1], kind="chol"), 30 + i)
            for i in range(2)]
    return out


def matrix(spec: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape, n = spec["shape"], spec["shape"][-1]
    M = rng.standard_normal(shape) / np.sqrt(n)
    if spec["kind"] == "chol":
        return (M @ np.swapaxes(M, -1, -2) + np.eye(n)).astype(np.float32)
    return (M + 2.0 * np.eye(n)).astype(np.float32)


def drift(spec: dict, seed: int) -> tuple:
    """A rank-DRIFT_RANK update (U, V) of a single-system plan."""
    rng = np.random.default_rng(500 + seed)
    n = spec["shape"][-1]
    U = (0.01 * rng.standard_normal((n, DRIFT_RANK))).astype(np.float32)
    V = (0.01 * rng.standard_normal((n, DRIFT_RANK))).astype(np.float32)
    return U, V


def make_plan(spec: dict):
    import torch

    from conflux_tpu_torch.serve import FactorPlan

    return FactorPlan.create(spec["shape"], torch.float32, v=spec["v"], kind=spec["kind"])


def trace(sessions: list, seed: int, R: int = REQUESTS) -> list:
    """(sid, rhs) pairs: request i to session i mod len at width
    WIDTHS[i mod 4] (width 1 as a vector)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(R):
        sid, spec, _s = sessions[i % len(sessions)]
        lead = tuple(spec["shape"][:-1])
        w = WIDTHS[i % len(WIDTHS)]
        out.append((sid, rng.standard_normal(lead if w == 1 else lead + (w,))
                    .astype(np.float32)))
    return out


def residual(A: np.ndarray, x: np.ndarray, b: np.ndarray) -> float:
    A64, x64, b64 = A.astype(np.float64), np.asarray(x, np.float64), b.astype(np.float64)
    if x64.ndim == A64.ndim - 1:
        x64, b64 = x64[..., None], b64[..., None]
    return float(np.abs(A64 @ x64 - b64).max())


def run_traffic(fab: ServeFabric, reqs: list, threads: int = THREADS) -> tuple:
    """Send `reqs` from `threads` front threads; (answers, seconds)."""
    out: list = [None] * len(reqs)
    errs: list = []

    def worker(k: int) -> None:
        try:
            for i in range(k, len(reqs), threads):
                sid, b = reqs[i]
                out[i] = np.asarray(fab.solve(sid, b, timeout=120.0))
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600.0)
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return out, dt


def answer_through_failover(fab: ServeFabric, sid, b, bad: list, tag: str,
                            bound: float = 90.0):
    """Solve riding out a fail-over on HostUnavailable's retry hints; a
    hang or a stall past `bound` is the failure."""
    t0 = time.perf_counter()
    while True:
        try:
            return np.asarray(fab.solve(sid, b, timeout=30.0))
        except HostUnavailable as e:
            if time.perf_counter() - t0 >= bound:
                bad.append(f"{tag}: {sid} unanswered after {bound}s")
                return None
            time.sleep(min(0.05, max(0.01, e.retry_after)))


def wait_recovery(fab: ServeFabric, hid: str, bound: float = RECOVERY_BOUND_S):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < bound:
        for r in reversed(fab.stats()["recoveries"]):
            if r["host"] == hid:
                return r
        time.sleep(0.02)
    return None


def shm_room(hosts: int, ring_bytes: int) -> dict:
    need = hosts * 2 * ring_bytes
    try:
        du = shutil.disk_usage("/dev/shm")
    except OSError:
        return {"need": need, "total": None, "free": None}
    info = {"need": need, "total": du.total, "free": du.free}
    print(f"[drill] /dev/shm total {du.total} free {du.free} bytes; the rings of "
          f"{hosts} hosts need {need}", flush=True)
    if du.free < need:
        raise SystemExit(f"[drill] FAIL: /dev/shm has {du.free} bytes free, {hosts} hosts x "
                         f"2 rings x {ring_bytes} bytes need {need}; pass a smaller "
                         "--ring-mib or give the machine a larger /dev/shm")
    return info


def open_fleet(fab: ServeFabric, sessions: list, drifted: tuple = ("big-0",)) -> dict:
    """Open every session (drifting `drifted`), one checkpoint round after;
    returns {sid: the matrix it answers for}."""
    mats = {}
    for sid, spec, seed in sessions:
        A = matrix(spec, seed)
        fab.open(sid, make_plan(spec), A)
        if sid in drifted:
            U, V = drift(spec, seed)
            fab.update(sid, U, V)
            A = A + U @ V.T
        mats[sid] = A
    fab.checkpoint_all()
    return mats


def sequential_refs(fab: ServeFabric, sessions: list, seed: int) -> tuple:
    """One width-2 request per session, one at a time: (rhs, answers)."""
    rng = np.random.default_rng(seed)
    rhs, ref = {}, {}
    for sid, spec, _s in sessions:
        rhs[sid] = rng.standard_normal(tuple(spec["shape"][:-1]) + (2,)).astype(np.float32)
        ref[sid] = np.asarray(fab.solve(sid, rhs[sid], timeout=120.0))
    return rhs, ref


def launches(h: ProcessHost) -> dict:
    st = h.stats(timeout=60.0)["launches"]
    return {k: int(st.get(k, 0)) for k in KERNELS}


def spread_sids(prefix: str, ids: list, per: int) -> list:
    by = {h: [] for h in ids}
    i = 0
    while min(len(v) for v in by.values()) < per:
        sid = f"{prefix}-{i}"
        by[rendezvous(sid, ids)].append(sid)
        i += 1
    return sorted(sum((v[:per] for v in by.values()), []))


def drill(root: str, platform: str, ring_bytes: int) -> dict:
    t_all = time.perf_counter()
    bad: list[str] = []
    out: dict = {"platform": platform}
    exact = platform != "cpu"
    eng = {"max_batch_delay": 0.002, "device": "cpu" if platform == "cpu" else "cuda"}
    wcfg = WireConfig(ring_bytes=ring_bytes)
    out["shm"] = shm_room(6, ring_bytes)
    shm_before = set(glob.glob("/dev/shm/cfxw-*"))
    if platform != "cpu":
        from conflux_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load()  # workers reuse this build instead of compiling at once
        print(f"[drill] kernel library ready in {time.perf_counter() - t0:.1f} s", flush=True)

    def host(hid: str) -> ProcessHost:
        return ProcessHost(hid, os.path.join(root, hid), engine_kwargs=eng,
                           start_timeout=300.0, call_timeout=120.0, wire="shm",
                           wire_config=wcfg)

    handles = {h: host(h) for h in ("h0", "h1", "b0", "r0", "r1", "r2")}
    starts: dict = {}
    errs: list = []

    def start(h: ProcessHost) -> None:
        t0 = time.perf_counter()
        try:
            h.start()
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)
        starts[h.host_id] = round(time.perf_counter() - t0, 3)

    ts = [threading.Thread(target=start, args=(h,)) for h in handles.values()]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    out["start_s"] = starts
    out["start_all_s"] = round(time.perf_counter() - t0, 3)
    print(f"[drill] 6 workers started together in {out['start_all_s']} s; each {starts}",
          flush=True)
    if errs:
        for h in handles.values():
            h.kill()
        raise errs[0]

    pol = dict(heartbeat_interval=0.5, heartbeat_timeout=30.0, suspect_after=2,
               dead_after=4, call_timeout=120.0)
    fab_a = ServeFabric([handles["h0"], handles["h1"]], policy=FabricPolicy(**pol),
                        root=os.path.join(root, "a"))
    fab_b = ServeFabric([handles["b0"]], policy=FabricPolicy(**pol),
                        root=os.path.join(root, "b"))
    fab_c = ServeFabric([handles["r0"], handles["r1"], handles["r2"]],
                        policy=FabricPolicy(**pol, replicas=2), root=os.path.join(root, "c"))
    worker_launches: dict = {}
    sessions = fleet(platform)
    try:
        fab_a.start()
        fab_b.start()
        fab_c.start()
        # ---- 1. healthy pass: 2 workers against 1 --------------------- #
        drifted = ("big-0",)
        mats = open_fleet(fab_a, sessions, drifted)
        open_fleet(fab_b, sessions, drifted)
        owners = {sid: fab_a.owner_of(sid) for sid, _p, _s in sessions}
        if len(set(owners.values())) < 2:
            bad.append(f"placement degenerated: {owners}")
        rhs, ref = sequential_refs(fab_a, sessions, seed=7)
        _b_rhs, ref_b = sequential_refs(fab_b, sessions, seed=7)
        for sid in ref:
            if not np.array_equal(ref[sid], ref_b[sid]):
                bad.append(f"sequential answer of {sid}: 2 workers != 1 worker")
        reqs = trace(sessions, seed=1)
        run_traffic(fab_a, reqs[:32])  # warm both fabrics' width buckets
        run_traffic(fab_b, reqs[:32])
        xa, dta = run_traffic(fab_a, reqs)
        xb, dtb = run_traffic(fab_b, reqs)
        worst = max(residual(mats[sid], x, b) for (sid, b), x in zip(reqs, xa))
        # bitwise on the card, drifted sessions too (the Woodbury
        # correction runs each column alone, whatever width the two
        # fabrics coalesce to); every differing answer is reported
        differ: dict = {}
        for (sid, _b), p, q in zip(reqs, xa, xb):
            if not np.array_equal(p, q):
                rel = float(np.abs(p - q).max() / max(np.abs(q).max(), 1e-30))
                differ[sid] = max(differ.get(sid, 0.0), rel)
        diff = len([1 for p, q in zip(xa, xb) if not np.array_equal(p, q)])
        for sid, rel in sorted(differ.items()):
            if exact or not rel <= 1e-5:
                bad.append(f"healthy pass: {sid}'s answers differ between 2 workers and "
                           f"1 (max rel {rel:.3e})")
        if not worst < 1e-4:
            bad.append(f"healthy pass: max |A x - b| {worst:.3e} >= 1e-4")
        out["healthy"] = {"requests": len(reqs), "max_resid": worst, "differ": diff,
                          "differ_max_rel_by_sid": differ,
                          "solves_per_s_2_workers": round(len(reqs) / dta, 1),
                          "solves_per_s_1_worker": round(len(reqs) / dtb, 1)}
        print(f"[drill] healthy: {len(reqs)} requests from {THREADS} threads, max |Ax-b| "
              f"{worst:.3e}, 2 workers {len(reqs) / dta:.1f} solves/s, 1 worker "
              f"{len(reqs) / dtb:.1f} solves/s, answers differing {diff} {differ}",
              flush=True)

        # ---- 2. live migration ----------------------------------------- #
        mig = sessions[0][0]
        src = fab_a.owner_of(mig)
        tgt = fab_a.migrate(mig)
        if tgt == src or not np.array_equal(np.asarray(fab_a.solve(mig, rhs[mig])), ref[mig]):
            bad.append(f"migration of {mig} from {src} to {tgt} not bitwise")
        out["migrated"] = {"sid": mig, "from": src, "to": tgt}

        # ---- 3. SIGKILL a worker ---------------------------------------- #
        fab_a.checkpoint_all()
        for hid in ("h0", "h1"):
            worker_launches[hid] = launches(handles[hid])
        victim = fab_a.owner_of("big-0")
        doomed = sorted(s for s in ref if fab_a.owner_of(s) == victim)
        proc = handles[victim]._proc
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(30.0)
        t0 = time.perf_counter()
        try:
            fab_a.solve(doomed[0], rhs[doomed[0]], timeout=30.0)
            bad.append(f"a request routed at the killed {victim} was answered")
        except HostUnavailable as e:
            if not e.retry_after >= 0.0:
                bad.append(f"HostUnavailable without a retry hint: {e}")
        hu_ms = (time.perf_counter() - t0) * 1e3
        if hu_ms > 30e3:
            bad.append(f"the request at the killed worker took {hu_ms:.0f} ms")
        rec = wait_recovery(fab_a, victim)
        if rec is None:
            bad.append(f"no recovery recorded for {victim}")
            rec = {}
        elif rec["lost"] or rec["adopted"] != len(doomed):
            bad.append(f"kill recovery {rec} for {len(doomed)} owned sessions")
        for sid in ref:
            got = answer_through_failover(fab_a, sid, rhs[sid], bad, "post-kill")
            if got is not None and not np.array_equal(got, ref[sid]):
                bad.append(f"post-kill answer of {sid} not bitwise")
        st = fab_a.stats()
        if st["sessions"] != len(sessions) or st["lost_sessions"]:
            bad.append(f"kill census: {st['sessions']} sessions, {st['lost_sessions']} lost")
        survivor = "h1" if victim == "h0" else "h0"
        worker_launches[survivor] = launches(handles[survivor])
        out["kill"] = {"victim": victim, "owned": len(doomed), "host_unavailable_ms":
                       round(hu_ms, 3), "recovery": rec}
        print(f"[drill] SIGKILL {victim} ({len(doomed)} sessions): HostUnavailable in "
              f"{hu_ms:.1f} ms, recovery {rec.get('seconds', float('nan')):.3f} s, adopted "
              f"{rec.get('adopted')}, lost {rec.get('lost')}", flush=True)

        # ---- 4. replicas: re-point to standbys -------------------------- #
        rsess = [(sid, spec, seed) for sid, (_n, spec, seed) in
                 zip(spread_sids("rep", ["r0", "r1", "r2"], 2),
                     [s for s in sessions if s[1]["kind"] == "lu"][:6])]
        open_fleet(fab_c, rsess, drifted=())
        rrhs, rref = sequential_refs(fab_c, rsess, seed=9)
        if fab_c.stats()["replicated_sessions"] != len(rsess):
            bad.append(f"replicas: {fab_c.stats()['replicated_sessions']} of {len(rsess)} "
                       "sessions replicated")
        restores0 = resilience.health_stats().get("fabric_snapshot_restores", 0)
        for hid in ("r0", "r1", "r2"):
            worker_launches[hid] = launches(handles[hid])
        rvictim = fab_c.owner_of(rsess[0][0])
        rdoomed = [s for s in rref if fab_c.owner_of(s) == rvictim]
        rproc = handles[rvictim]._proc
        os.kill(rproc.pid, signal.SIGKILL)
        rproc.wait(30.0)
        fab_c._hb_round()  # the torn pipe: dead at once, fail-over inline
        rrec = wait_recovery(fab_c, rvictim) or {}
        restores = resilience.health_stats().get("fabric_snapshot_restores", 0) - restores0
        if not (rrec.get("repointed") == rrec.get("adopted") == len(rdoomed) >= 1
                and rrec.get("lost") == 0 and restores == 0):
            bad.append(f"replica drill: {rrec}, {restores} snapshot restores, "
                       f"{len(rdoomed)} owned")
        for sid in rref:
            got = answer_through_failover(fab_c, sid, rrhs[sid], bad, "replica")
            if got is not None and not np.array_equal(got, rref[sid]):
                bad.append(f"replica drill: {sid} not bitwise after re-point")
        out["replica"] = {"victim": rvictim, "recovery": rrec, "snapshot_restores": restores}
        print(f"[drill] replicas K=2: SIGKILL {rvictim}, re-pointed {rrec.get('repointed')} "
              f"of {len(rdoomed)} in {rrec.get('seconds', float('nan')):.3f} s, snapshot "
              f"restores {restores}", flush=True)

        # ---- 5. wire: a torn reply record -------------------------------- #
        fab_c.checkpoint_all()
        live = [h for h in ("r0", "r1", "r2") if fab_c.host_state(h) == "alive"]
        wvictim = next(fab_c.owner_of(s) for s in rref if fab_c.owner_of(s) in live)
        worker_launches[wvictim] = launches(handles[wvictim])
        corrupt0 = resilience.health_stats().get("wire_corrupt", 0)
        t0 = time.perf_counter()
        handles[wvictim].debug_wire("torn_reply")
        while handles[wvictim]._dead is None and time.perf_counter() - t0 < 30.0:
            time.sleep(0.005)
        dead_ms = (time.perf_counter() - t0) * 1e3
        if not isinstance(handles[wvictim]._dead, resilience.WireCorrupt):
            bad.append(f"wire drill: {wvictim} died of {handles[wvictim]._dead!r}")
        fab_c._hb_round()
        wrec = wait_recovery(fab_c, wvictim) or {}
        if wrec.get("lost", 1) != 0:
            bad.append(f"wire drill recovery {wrec}")
        for sid in rref:
            got = answer_through_failover(fab_c, sid, rrhs[sid], bad, "wire")
            if got is not None and not np.array_equal(got, rref[sid]):
                bad.append(f"wire drill: {sid} not bitwise after the fail-over")
        corrupt = resilience.health_stats().get("wire_corrupt", 0) - corrupt0
        if corrupt < 1:
            bad.append("wire drill: no wire_corrupt event counted")
        last = [h for h in ("r0", "r1", "r2") if fab_c.host_state(h) == "alive"]
        for hid in last:
            worker_launches[hid] = launches(handles[hid])
        worker_launches["b0"] = launches(handles["b0"])
        out["wire"] = {"victim": wvictim, "dead_ms": round(dead_ms, 3), "recovery": wrec,
                       "wire_corrupt": corrupt}
        print(f"[drill] wire: torn reply on {wvictim} read as WireCorrupt, dead in "
              f"{dead_ms:.1f} ms, recovery {wrec.get('seconds', float('nan')):.3f} s, "
              f"adopted {wrec.get('adopted')}", flush=True)
    finally:
        for f in (fab_a, fab_b, fab_c):
            f.close()
    leaked = sorted(set(glob.glob("/dev/shm/cfxw-*")) - shm_before)
    if leaked:
        bad.append(f"leaked shm segments: {leaked}")
    out["shm_leaks"] = len(leaked)
    out["launches"] = worker_launches
    out["launches_total"] = {k: sum(w.get(k, 0) for w in worker_launches.values())
                             for k in KERNELS}
    if platform != "cpu":
        lt = out["launches_total"]
        if not (lt["btrsm"] > 0 and lt["batched_lu"] > 0 and lt["batched_chol"] > 0):
            bad.append(f"the workers did not run K3, K4 and K5: {lt}")
    out["failures"] = bad
    out["elapsed_s"] = round(time.perf_counter() - t_all, 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None, help="checkpoint root (a temporary one by default)")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--ring-mib", type=int, default=8,
                    help="each shm ring's size in MiB (WireConfig.ring_bytes)")
    ap.add_argument("--json", default=None, help="also write the summary here")
    args = ap.parse_args(argv)
    if args.platform == "gpu":
        import torch

        if not torch.cuda.is_available():
            print("[drill] FAIL: no card (pass --platform cpu for the plain versions)")
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[drill] {smi.stdout.strip()}", flush=True)
    root = args.dir or tempfile.mkdtemp(prefix="fabric-drill-")
    try:
        out = drill(root, args.platform, args.ring_mib << 20)
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
    for line in out["failures"]:
        print(f"[drill] FAIL {line}", flush=True)
    out["ok"] = not out["failures"]
    print(json.dumps(out, sort_keys=True, default=str))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
