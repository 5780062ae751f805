"""Randomized soaks of the port, against float64 oracles: the port's
counterpart of every mode of `scripts/soak.py` and of its `--lockcheck`.

    python scripts/torch_soak.py [--trials 20] [--seed 0] [--platform cpu]   # configurations
    python scripts/torch_soak.py --serve     [--trials 20] [--seed 0] [--platform cpu]
    python scripts/torch_soak.py --precision [--trials 20] [--lockcheck]
    python scripts/torch_soak.py --qos | --adaptive | --gang | --fleet | --mesh | --scale
    python scripts/torch_soak.py --tier      [--time-budget 30] [--lockcheck]
    python scripts/torch_soak.py --fabric | --elastic [--trials 20] [--platform cpu]
    python scripts/torch_soak.py [--fabric] --replay SEED

With no mode flag the soak walks the grid programs' configurations: each
trial samples (core, grid, v, N, dtype) and the knobs of its core
(election, tree, update, segs, lookahead, panel_chunk; csegs; a resume in
two checkpointed halves) with the reference's generator, draw for draw, so
a seed names the same configuration in both packages; then the port's
backend and panel algo. It runs the grid LU, Cholesky or QR on a threaded
world of grid.P ranks (`parallel.mesh.run_threaded`: gloo on the CPU,
transport "staged" on the card) and holds the gathered factors to the
residual oracles, a resume to the one-shot factor (bitwise at Pz = 1) and
every rank to the same factor.

The serving modes each build a fleet behind a `ServeEngine` and fire a
seeded `FaultPlan` while mixed clean, poisoned and born-expired traffic
runs. `--serve`: the full `HealthPolicy` under the serve fault menu (NaN at
staging, delays and crashes at dispatch, drain, d2h and refresh,
forced-unhealthy verdicts). `--precision`: random per-request tiers of the
precision ladder over a mixed fleet. `--qos`: tenants across the three
classes under the fair-share ledger. `--adaptive`: the `AdaptiveController`
in the loop. `--gang`: `stack_sessions=True` with drift, refactor and
spill/revive churn between phases. `--fleet`: several lanes of one device
with lane kills. `--mesh`: batch-mesh sessions over several shards of one
device under the tier fault sites. `--tier`: Zipf traffic over a fleet
larger than the device tier through a `ResidentSet`-managed engine while
the spill, revive, disk_write and disk_read sites inject crashes, delays
and corrupt records. `--scale`: the LRU flipped live between "heap" and
"sort" and an incremental checkpoint chain restored cold.

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
census is conserved with zero lost sessions (the engine modes: every
future resolves, no pending slot leaks, the engine closes un-wedged, the
tier conserves its session count). Each trial line carries its seed;
`--replay SEED` re-runs one trial. `--lockcheck` runs the trials under
`conflux_tpu_torch.analysis.lockcheck` (the locks of this process, not of
fabric workers) and fails on a lock-order cycle or an engine lock held
across a `serve.*` dispatch region. Everything runs on the card unless
`--platform cpu`. The exit status is the gate.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

# the hosts' engine keywords; main() sets the device from --platform
ENGINE: dict = {"max_batch_delay": 0.0}


def _rel_err(x, want) -> float:
    return float(np.linalg.norm(x - want) / max(np.linalg.norm(want), 1e-30))


def _drifted(rng, sess, A: np.ndarray, N: int, kmax: int) -> np.ndarray:
    """A pre-traffic Woodbury drift of rank 1..kmax-1 on `sess`; returns the
    drifted matrix in float64."""
    k = int(rng.integers(1, kmax))
    U = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
    Vm = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
    sess.update(U, Vm)
    return A.astype(np.float64) + U.astype(np.float64) @ Vm.astype(np.float64).T


# --------------------------------------------------------------------------- #
# the configuration soak: the grid programs over their options' cross-product
# --------------------------------------------------------------------------- #

# the reference's grids and dtypes, in its order: the draws index them
GRIDS = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 1),
         (3, 1, 1), (3, 2, 1), (5, 1, 1), (2, 1, 2), (3, 1, 2),
         (6, 1, 1), (4, 1, 2), (1, 2, 1), (2, 4, 1)]
DTYPES = [np.float32, np.float64, "bfloat16", np.complex64]
BACKENDS = ("kernel", "xla")
PANEL_ALGOS = ("auto", "partial", "tournament")
_TORCH_DTYPES = {np.float32: torch.float32, np.float64: torch.float64,
                 "bfloat16": torch.bfloat16, np.complex64: torch.complex64}
# residual scale per storage dtype (bf16 factors carry f32 panels but bf16
# trailing updates); a trial's bar is eps sqrt(N) 10
_EPS = {np.float32: 1e-4, np.float64: 1e-9, np.complex64: 1e-4, "bfloat16": 5e-2}
# trials of the configuration soak by (core, dtype, backend) since the last clear
DRAWS: collections.Counter = collections.Counter()


def _rand_config(rng: np.random.Generator) -> dict:
    """One configuration: the reference's draws, in its order and from its
    ranges (`scripts/soak.py`'s `_rand_config`), then the port's own knobs
    from the same generator.

    - `backend`: "kernel" (the K1 GEMM) or "xla" (the library product) when
      the trial's storage dtype is float32 or bfloat16, the dtypes K1
      takes; "xla", with no draw, for float64 and complex64.
    - `panel_algo` (LU only): one of the library LU's algos "auto",
      "partial" and "tournament". The K2 panel kernel (panel algo
      "kernel") takes float32 panels whose width is a multiple of 128,
      and every width drawn here (v <= 32, the reference's) is below that
      gate, so K2 is never drawn; `chip_smoke.py` holds K2 elsewhere.
    """
    grid = GRIDS[rng.integers(len(GRIDS))]
    v = int(rng.choice([4, 8, 16, 32]))
    # tile counts chosen so every geometry regime appears: fewer tiles
    # than ranks (degenerate), exact, ragged, and deep
    tiles = int(rng.integers(1, 9))
    N = v * max(1, tiles)
    dtype = DTYPES[rng.integers(len(DTYPES))]
    core = ["lu", "cholesky", "qr"][rng.integers(3)]
    cfg = dict(core=core, grid=grid, v=v, N=N, dtype=dtype)
    if core == "lu":
        cfg.update(
            election=["gather", "butterfly"][rng.integers(2)],
            tree=["pairwise", "flat"][rng.integers(2)],
            update=["segments", "block"][rng.integers(2)],
            segs=(int(rng.integers(1, 5)), int(rng.integers(1, 5))),
            lookahead=bool(rng.integers(2)),
            panel_chunk=int(v * rng.integers(1, 4)),
        )
    elif core == "cholesky":
        cfg.update(segs=(int(rng.integers(1, 5)), int(rng.integers(1, 5))),
                   lookahead=bool(rng.integers(2)))
    else:
        cfg.update(csegs=int(rng.integers(1, 5)), lookahead=bool(rng.integers(2)))
    # ~1/4 of trials factor in two checkpointed halves (*_factor_steps) and
    # compare against the one-shot program: the resume entry points carry no
    # lookahead, so it is cleared for the comparison to be meaningful
    cfg["resume"] = bool(rng.integers(4) == 0)
    if cfg["resume"]:
        cfg["lookahead"] = False
        if core == "qr":
            # qr_factor_steps runs its default csegs: pin it so the one-shot
            # comparison program matches
            cfg["csegs"] = 8
    # the port's knobs (the Cholesky core runs a complex64 draw as float32)
    real = np.float32 if core == "cholesky" and dtype is np.complex64 else dtype
    cfg["backend"] = (BACKENDS[rng.integers(2)] if real in (np.float32, "bfloat16")
                      else "xla")
    if core == "lu":
        cfg["panel_algo"] = PANEL_ALGOS[rng.integers(3)]
    return cfg


def config(seed: int) -> dict:
    """Trial `seed`'s configuration: `_rand_config` on its own generator,
    and the reference trial's one change: the Cholesky core keeps the soak
    real (a complex draw runs float32; Hermitian grids have their own
    tests)."""
    cfg = _rand_config(np.random.default_rng(seed))
    if cfg["core"] == "cholesky" and cfg["dtype"] is np.complex64:
        cfg["dtype"] = np.float32
    return cfg


def _dtype_name(d) -> str:
    return d if isinstance(d, str) else np.dtype(d).name


def _host_dtype(d):
    """numpy dtype of a trial's host matrix: bfloat16 values travel as
    float32 (exact) and are rounded on each rank."""
    return np.float32 if d == "bfloat16" else d


def _stored(A: np.ndarray, d) -> np.ndarray:
    """A's values as the trial stores them, in float64 (bfloat16 rounded;
    complex64 as it is)."""
    if d is np.complex64:
        return A
    if d == "bfloat16":
        A = torch.from_numpy(np.ascontiguousarray(A)).to(torch.bfloat16).double().numpy()
    return A.astype(np.float64)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """The same shape and the same bits."""
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _gathered(t: torch.Tensor, geom, mesh) -> np.ndarray:
    """The global array of every rank's shard t, on every rank (bfloat16
    widened to float32 first: exact)."""
    from conflux_tpu_torch.parallel.mesh import gather_shards

    if t.dtype == torch.bfloat16:
        t = t.float()
    return geom.gather(gather_shards(t.contiguous(), mesh).cpu().numpy())


def _lu_ranks(cfg: dict, seed: int, grid):
    from conflux_tpu_torch.geometry import LUGeometry
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed, lu_factor_steps
    from conflux_tpu_torch.parallel.mesh import distribute_shards
    from conflux_tpu_torch.validation import make_test_matrix

    N, v, d = cfg["N"], cfg["v"], cfg["dtype"]
    cplx = d is np.complex64
    geom = LUGeometry.create(N, N, v, grid)
    A = make_test_matrix(N, N, seed=seed, dtype=np.complex64 if cplx else np.float64)
    host = geom.scatter(A.astype(_host_dtype(d)))
    kw = dict(election=cfg["election"], tree=cfg["tree"], update=cfg["update"],
              segs=cfg["segs"], panel_chunk=cfg["panel_chunk"], backend=cfg["backend"],
              panel_algo=cfg["panel_algo"])
    resume = cfg["resume"] and geom.n_steps >= 2

    def rank(mesh):
        shard = distribute_shards(host, mesh).to(_TORCH_DTYPES[d])
        out, perm = lu_factor_distributed(shard, geom, mesh, lookahead=cfg["lookahead"],
                                          **kw)
        res = {"LU": _gathered(out, geom, mesh), "perm": perm.cpu().numpy()}
        if resume:
            k = geom.n_steps // 2
            s1, o1, _ = lu_factor_steps(shard, geom, mesh, 0, k, **kw)
            s2, _, p2 = lu_factor_steps(s1, geom, mesh, k, geom.n_steps, orig=o1, **kw)
            res["LU_resumed"] = _gathered(s2, geom, mesh)
            res["perm_resumed"] = p2.cpu().numpy()
        return res

    # the padded problem, identity tail included, as stored
    return rank, {"A": _stored(geom.gather(host), d), "geom": geom}


def _cholesky_ranks(cfg: dict, seed: int, grid):
    from conflux_tpu_torch.cholesky.distributed import (
        cholesky_factor_distributed,
        cholesky_factor_steps,
    )
    from conflux_tpu_torch.geometry import CholeskyGeometry
    from conflux_tpu_torch.parallel.mesh import distribute_shards
    from conflux_tpu_torch.validation import cholesky_residual_distributed, make_spd_matrix

    N, v, d = cfg["N"], cfg["v"], cfg["dtype"]
    geom = CholeskyGeometry.create(N, v, grid)
    S = make_spd_matrix(geom.N, dtype=np.float64 if d is np.float64 else np.float32).numpy()
    host = geom.scatter(_stored(S, d).astype(_host_dtype(d)))
    kw = dict(segs=cfg["segs"], backend=cfg["backend"])
    resume = cfg["resume"] and geom.Kappa >= 2

    def rank(mesh):
        sh = distribute_shards(host, mesh).to(_TORCH_DTYPES[d])
        L = cholesky_factor_distributed(sh, geom, mesh, lookahead=cfg["lookahead"], **kw)
        res = {"L": _gathered(L, geom, mesh),
               "residual": float(cholesky_residual_distributed(sh, L, geom, mesh))}
        if resume:
            k = geom.Kappa // 2
            s1 = cholesky_factor_steps(sh, geom, mesh, 0, k, **kw)
            s2 = cholesky_factor_steps(s1, geom, mesh, k, geom.Kappa, **kw)
            res["L_resumed"] = _gathered(s2, geom, mesh)
            res["residual_resumed"] = float(cholesky_residual_distributed(sh, s2, geom, mesh))
        return res

    return rank, {"A": _stored(S, d), "geom": geom}


def _qr_ranks(cfg: dict, seed: int, grid):
    from conflux_tpu_torch.geometry import LUGeometry
    from conflux_tpu_torch.parallel.mesh import distribute_shards
    from conflux_tpu_torch.qr.distributed import qr_factor_distributed, qr_factor_steps, r_geometry
    from conflux_tpu_torch.validation import make_test_matrix

    N, v, d = cfg["N"], cfg["v"], cfg["dtype"]
    geom = LUGeometry.create(N, N, v, grid)
    if geom.M < geom.N:
        # y-axis padding widened N past M (Py > Px grids): the entry point
        # rejects that, so soak the valid tall problem instead
        geom = LUGeometry.create(geom.N, N, v, grid)
    rgeom = r_geometry(geom)
    A = make_test_matrix(geom.Mbase, N, seed=seed, dtype=np.float64)
    # complex64 storage holds a real-valued test matrix (imag == 0)
    host = geom.scatter(A.astype(_host_dtype(d)))
    resume = cfg["resume"] and geom.Nt >= 2

    def rank(mesh):
        sh = distribute_shards(host, mesh).to(_TORCH_DTYPES[d])
        Qs, Rs = qr_factor_distributed(sh, geom, mesh, backend=cfg["backend"],
                                       csegs=cfg["csegs"], lookahead=cfg["lookahead"])
        res = {"Q": _gathered(Qs, geom, mesh), "R": _gathered(Rs, rgeom, mesh)}
        if resume:
            k = geom.Nt // 2
            s1, R1 = qr_factor_steps(sh, geom, mesh, 0, k, backend=cfg["backend"])
            s2, R2 = qr_factor_steps(s1, geom, mesh, k, geom.Nt, R=R1, backend=cfg["backend"])
            res["Q_resumed"] = _gathered(s2, geom, mesh)
            res["R_resumed"] = _gathered(R2, rgeom, mesh)
        return res

    return rank, {"A": _stored(geom.gather(host), d).real.astype(np.float64), "geom": geom}


def factor_config(cfg: dict, seed: int, device=None) -> dict:
    """Factor configuration `cfg` (see `config`) of trial `seed` on a
    threaded world of grid.P ranks on `device` (default the soak's:
    transport gloo on the CPU, "staged" on the card) and return the
    gathered outputs, numpy, after checking that every rank returned the
    same bits:

    - LU: "LU" the packed factors in pivoted row order, "perm";
    - Cholesky: "L" the factored matrix (lower triangle = L) and
      "residual", the on-grid ||A - L L^H|| / ||A||;
    - QR: "Q" and "R" (R on `r_geometry`, rows padded to whole tiles);

    each with its "*_resumed" twin when the trial resumes; "A" the padded
    problem as stored (float64 or complex64; QR's real part) and "geom"."""
    from conflux_tpu_torch.geometry import Grid3
    from conflux_tpu_torch.parallel.mesh import run_threaded

    device = ENGINE["device"] if device is None else device
    grid = Grid3(*cfg["grid"])
    build = {"lu": _lu_ranks, "cholesky": _cholesky_ranks, "qr": _qr_ranks}[cfg["core"]]
    rank, meta = build(cfg, seed, grid)
    cpu = torch.device(device).type == "cpu"
    results = run_threaded(grid, rank, device=device, transport="gloo" if cpu else "staged")
    for r, res in enumerate(results[1:], 1):
        for key, val in res.items():
            if isinstance(val, np.ndarray) and not _same(val, results[0][key]):
                raise AssertionError(f"rank {r} gathered another {key} than rank 0")
    return {**results[0], **meta}


def run_trial(seed: int) -> tuple[bool, str]:
    """One configuration trial (the reference's `run_trial`): factor
    `config(seed)` on its grid and hold the result to the oracles.

    LU: perm a permutation and ||A[perm] - L U|| / ||A|| under the bar;
    Cholesky: the on-grid residual; QR: ||Q R - A|| / ||A|| and the
    orthogonality ||Q^T Q - I||; a resumed factor (two checkpointed halves)
    bitwise the one-shot factor where Pz = 1, else within the residual bar
    eps sqrt(N) 10. Every rank returned the same factor (`factor_config`).
    Any exception fails the trial, a kernel's included."""
    from conflux_tpu_torch.validation import lu_residual

    cfg = config(seed)
    d = cfg["dtype"]
    DRAWS[(cfg["core"], _dtype_name(d), cfg["backend"])] += 1
    eps = _EPS[d]
    label = f"seed={seed} " + " ".join(f"{k}={v}" for k, v in cfg.items())
    N, Pz = cfg["N"], cfg["grid"][2]
    bound = eps * np.sqrt(N) * 10
    try:
        out = factor_config(cfg, seed)
        A = out["A"]
        if cfg["core"] == "lu":
            perm = out["perm"]
            if sorted(perm.tolist()) != list(range(out["geom"].M)):
                return False, f"{label}: perm not a permutation"
            res = lu_residual(A, out["LU"], perm)
            if "LU_resumed" in out:
                if Pz == 1:  # the bitwise round-trip contract
                    if not (_same(out["LU_resumed"], out["LU"])
                            and _same(out["perm_resumed"], perm)):
                        return False, f"{label}: resume != one-shot"
                else:  # Pz > 1: the z partial sums re-associate
                    rres = lu_residual(A, out["LU_resumed"], out["perm_resumed"])
                    if not rres < bound:
                        return False, f"{label}: resume residual {rres:.3e}"
        elif cfg["core"] == "cholesky":
            res = out["residual"]
            if "L_resumed" in out:
                if Pz == 1:
                    if not _same(out["L_resumed"], out["L"]):
                        return False, f"{label}: resume != one-shot"
                elif not out["residual_resumed"] < bound:
                    return False, f"{label}: resume residual {out['residual_resumed']:.3e}"
        else:
            n = out["geom"].N

            def qr_res(Q, R):
                Q = Q.real.astype(np.float64)
                R = np.triu(R.real.astype(np.float64)[:n, :n])
                return (np.linalg.norm(Q @ R - A) / max(np.linalg.norm(A), 1e-30),
                        np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])))

            res, orth = qr_res(out["Q"], out["R"])
            if "Q_resumed" in out:
                if Pz == 1:
                    if not (_same(out["Q_resumed"], out["Q"])
                            and _same(out["R_resumed"], out["R"])):
                        return False, f"{label}: resume != one-shot"
                else:
                    rres, _ = qr_res(out["Q_resumed"], out["R_resumed"])
                    if not rres < bound:
                        return False, f"{label}: resume residual {rres:.3e}"
            if orth > eps * 100:
                return False, f"{label}: orthogonality {orth:.2e}"
    except Exception as e:  # noqa: BLE001 — any crash is a finding
        return False, f"{label}: EXCEPTION {type(e).__name__}: {e}"
    if not res < bound:
        return False, f"{label}: residual {res:.3e} > {bound:.1e}"
    return True, f"{label}: ok residual={res:.2e}"


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
        # pre-traffic Woodbury drift on this session
        As.append(_drifted(rng, sess, A, N, 4) if rng.integers(2) else A.astype(np.float64))
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
        err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
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
        # pre-traffic Woodbury drift on this session
        As.append(_drifted(rng, sess, A, N, 3) if rng.integers(2) else A.astype(np.float64))
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
            err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
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


@contextlib.contextmanager
def _library_panel_algo():
    """Plans made inside take the library LU ("auto") as their panel algo:
    the bf16_ir tier's blocked factor runs its elections there, since the
    K2 panel kernel takes widths that are multiples of 128 and these plans'
    v is 16 (the native tiers still factor on K4)."""
    from conflux_tpu_torch.ops import blas

    prev = blas.get_panel_algo()
    blas.set_panel_algo("auto")
    try:
        yield
    finally:
        blas.set_panel_algo(prev)


def run_precision_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the precision ladder under injected faults.

    A mixed fleet (native, bf16+IR-opened and f32-opened sessions, some
    Woodbury-drifted) serves random per-request tiers (None, 'auto',
    'bf16_ir', 'f32', 'f64') through a guarded engine while the serve fault
    menu fires. Invariants: every admitted future resolves; failures are
    STRUCTURED resilience errors only; answers land within their served
    tier's tolerance of the float64 oracle (bf16+IR is loose, every other
    rung float32-tight); the engine's escalation and fallback roll-ups equal
    the per-session sums. The plan's panel algo is the library LU's
    (`_library_panel_algo`)."""
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
    S = int(rng.integers(2, 5))
    with _library_panel_algo():
        plan = serve.FactorPlan.create((N, N), torch.float32, v=16)
    opens = [None, "auto", "f32"]
    As, sessions, drifted = [], [], []
    for si in range(S):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        sess = plan.factor(A, device=ENGINE["device"], precision=opens[si % 3])
        drift = bool(rng.integers(2))
        # pre-traffic drift: a cross-tier request on a drifted session must
        # fall back to the resident path, counted, never answer stale bits
        As.append(_drifted(rng, sess, A, N, 4) if drift else A.astype(np.float64))
        sessions.append(sess)
        drifted.append(drift)
    menu = [
        FaultSpec("staging", "nan", prob=0.3, count=int(rng.integers(1, 4))),
        FaultSpec("dispatch", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("drain", "crash", prob=0.5, count=1),
        FaultSpec("d2h", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("d2h", "crash", prob=0.5, count=1),
        FaultSpec("solve", "unhealthy", prob=0.4, count=int(rng.integers(1, 3))),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    label = f"seed={seed} precision N={N} S={S} faults={[(f.site, f.kind) for f in picks]}"
    tiers = [None, "auto", "auto", "bf16_ir", "f32", "f64"]
    eng = ServeEngine(
        max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=64,
        max_coalesce_width=8,
        health=HealthPolicy(quarantine_after=3, quarantine_cooldown=0.05),
        fault_plan=faults, watchdog_interval=0.05, device=ENGINE["device"])
    reqs = []
    try:
        for _ in range(24):
            si = int(rng.integers(S))
            prec = tiers[int(rng.integers(len(tiers)))]
            w = int(rng.choice([1, 1, 2, 3]))
            b = rng.standard_normal((N, w)).astype(np.float32)
            if int(rng.integers(8)) == 0:  # admission-guard food
                b[int(rng.integers(N)), 0] = np.nan
            try:
                fut = eng.submit(sessions[si], b, precision=prec)
            except (RhsNonFinite, SessionQuarantined, EngineSaturated):
                continue
            reqs.append((si, prec, b, fut))
        wedged = eng.close(timeout=120)
        if wedged:
            return False, f"{label}: close() wedged {wedged}"
    finally:
        eng.close(timeout=10)
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              InjectedFault)
    answered = 0
    for si, prec, b, fut in reqs:
        if not fut.done():
            return False, f"{label}: close() left a future unresolved"
        try:
            x = np.asarray(fut.result(0))
        except ok_exc:
            continue
        except Exception as e:  # noqa: BLE001 — any other leak is a bug
            return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
        err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
        # the tolerance keys on the rung that could have served the answer:
        # 'auto'/'bf16_ir' requests may ride bf16 factors; precision=None on
        # a bf16-opened session serves its own bf16+IR factors; a cross-tier
        # request on a drifted bf16 session falls back to the resident
        # bf16+Woodbury path. Everything else (clean cross-tier requests
        # rebuild from the full-precision base) is float32-tight.
        st = sessions[si].served_tier
        loose = prec in ("auto", "bf16_ir") or (st == "bf16_ir" and (prec is None
                                                                     or drifted[si]))
        bound = 2e-2 if loose else 1e-3
        if not err < bound:
            return False, (f"{label}: {prec} answer off oracle ({err:.2e} > {bound:.0e}, "
                           f"served tier {st})")
        answered += 1
    stats = eng.stats()
    if stats["pending"] != 0:
        return False, f"{label}: {stats['pending']} pending slots leaked"
    if stats["completed"] + stats["failed"] != stats["requests"]:
        return False, f"{label}: counters incoherent {stats}"
    # the ladder's books: the engine's roll-ups are the per-session sums
    esc = sum(s.precision_escalations for s in sessions)
    fb = sum(s.precision_fallbacks for s in sessions)
    if stats["precision_escalations"] != esc:
        return False, (f"{label}: escalation roll-up {stats['precision_escalations']} != "
                       f"session sum {esc}")
    if stats["precision_fallbacks"] != fb:
        return False, (f"{label}: fallback roll-up {stats['precision_fallbacks']} != "
                       f"session sum {fb}")
    h = resilience.health_stats()
    return True, (f"{label}: ok {answered}/{len(reqs)} answered, "
                  f"injected={sum(faults.injected.values())}, escalations={esc}, "
                  f"fallbacks={fb}, redispatches={h['survivor_redispatches']}")


def run_qos_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the serving stack with multi-tenant QoS in the
    loop.

    Random tenants across the latency, throughput and batch classes submit
    mixed traffic (a quarter of it unclassified) under the serve fault menu
    while the fair-share ledger admits and sheds. Invariants: every
    admitted future resolves to a structured outcome; answers match the
    float64 oracle whatever the tenant (no cross-tenant corruption);
    `TenantThrottled` surfaces only at admission, with retry_after, tenant
    and qos_class; after close() the engine has zero pending, each class's
    counters are coherent (requests == completed + failed) and the ledger's
    per-tenant pending is zero."""
    from conflux_tpu_torch import resilience, serve
    from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
    from conflux_tpu_torch.qos import QosClass
    from conflux_tpu_torch.resilience import (
        DeadlineExceeded,
        FaultPlan,
        FaultSpec,
        HealthPolicy,
        InjectedFault,
        RhsNonFinite,
        SessionQuarantined,
        SolveUnhealthy,
        TenantThrottled,
    )

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    N = int(rng.choice([32, 64]))
    S = int(rng.integers(1, 4))
    plan = serve.FactorPlan.create((N, N), torch.float32, v=16)
    As, sessions = [], []
    for _ in range(S):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        sessions.append(plan.factor(A, device=ENGINE["device"]))
        As.append(A.astype(np.float64))
    tiers = ("latency", "throughput", "batch")
    T = int(rng.integers(2, 4))
    classes = []
    for t in range(T):
        tier = tiers[int(rng.integers(3))]
        classes.append(QosClass(
            tenant=f"t{t}", tier=tier, priority=int(rng.integers(-1, 2)),
            slo=float(rng.choice([0.05, 0.25])) if tier == "latency" else None,
            weight=float(rng.choice([0.25, 1.0, 4.0]))))
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
    label = (f"seed={seed} qos N={N} S={S} classes={[c.key for c in classes]} "
             f"faults={[(f.site, f.kind) for f in picks]}")
    eng = ServeEngine(
        max_batch_delay=float(rng.choice([0.0, 0.002])),
        max_pending=int(rng.choice([8, 64])), max_coalesce_width=8,
        health=HealthPolicy(quarantine_after=2, quarantine_cooldown=0.05),
        fault_plan=faults, watchdog_interval=0.05, device=ENGINE["device"])
    resilience.install_faults(faults)
    reqs, throttled = [], 0
    try:
        for _ in range(32):
            si = int(rng.integers(S))
            # 3 in 4 submissions carry a class; the rest ride the
            # unclassified path through the same queue
            cls = classes[int(rng.integers(T))] if rng.integers(4) else None
            w = int(rng.choice([1, 1, 2, 3]))
            b = rng.standard_normal((N, w)).astype(np.float32)
            kind = int(rng.integers(8))
            deadline = None
            if kind == 0:  # poisoned at the source
                b[int(rng.integers(N)), 0] = np.nan
            elif kind == 1:  # born expired
                deadline = 0.0
            try:
                fut = eng.submit(sessions[si], b, deadline=deadline, qos=cls)
            except TenantThrottled as e:
                if e.retry_after < 0 or e.tenant is None or e.qos_class is None:
                    return False, f"{label}: malformed TenantThrottled {e!r}"
                throttled += 1
                continue
            except (RhsNonFinite, SessionQuarantined, EngineSaturated):
                continue  # other structured admission outcomes are fine
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
        except TenantThrottled:
            return False, f"{label}: TenantThrottled leaked past admission into a future"
        except ok_exc:
            continue
        except Exception as e:  # noqa: BLE001 — any other leak is a bug
            return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
        err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
        if not err < 1e-3:
            return False, f"{label}: answer off oracle ({err:.2e})"
        answered += 1
    stats = eng.stats()
    if stats["pending"] != 0:
        return False, f"{label}: {stats['pending']} pending slots leaked"
    if stats["completed"] + stats["failed"] != stats["requests"]:
        return False, f"{label}: counters incoherent {stats}"
    q = eng.counters().get("qos")
    if q is not None:
        for key, row in q["classes"].items():
            if row["requests"] != row["completed"] + row["failed"]:
                return False, f"{label}: class {key} counters incoherent {row}"
        for tname, row in q["tenants"].items():
            if row["pending"] != 0:
                return False, (f"{label}: ledger pending leaked for tenant {tname}: "
                               f"{row['pending']}")
    h = resilience.health_stats()
    return True, (f"{label}: ok {answered}/{len(reqs)} answered, throttled={throttled}, "
                  f"injected={sum(faults.injected.values())}, evictions={h['evictions']}")


def run_adaptive_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the serving stack with the `AdaptiveController` in
    the loop.

    The serve trial's shape (a fleet of possibly drifted sessions, a sampled
    `FaultPlan`, clean, poisoned and expired traffic) plus a controller
    ticking every 10 ms against a random SLO while the faults fire, under a
    traffic profile that shifts mid-trial (a quiet dribble, then a tight
    burst) so the knobs move. Beyond the serve invariants: no tick errors;
    every knob left inside its `ControlLimits`; a guard trip puts the engine
    back at full guarding at once (the strict policy, staging stride 1);
    close() stops the controller's thread.

    The reference reads the guarding at close whenever the process's
    cumulative trip counters are non-zero, but the controller may relax
    the guards again after `relax_health_after` trip-free windows that
    follow the last trip (seed 3 relaxed 22.7 ms after its last trip, on
    the CPU and on the card), so that reading depends on timing. The port
    probes the contract itself: with the traffic done, a request poisoned
    in its first entry, against a fresh session of an engine relaxed as the
    controller relaxes it, must be refused at admission and leave full
    guarding on."""
    import dataclasses

    from conflux_tpu_torch import serve
    from conflux_tpu_torch.control import AdaptiveController, ControlLimits
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
        As.append(_drifted(rng, sess, A, N, 4) if rng.integers(2) else A.astype(np.float64))
        sessions.append(sess)
    menu = [
        FaultSpec("staging", "nan", prob=0.3, count=int(rng.integers(1, 4))),
        FaultSpec("dispatch", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("drain", "crash", prob=0.5, count=1),
        FaultSpec("d2h", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("solve", "unhealthy", prob=0.4, count=int(rng.integers(1, 3))),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    limits = ControlLimits(max_batch_delay=0.008, min_pending=8, max_pending=256,
                           max_coalesce_width=16)
    ctl = AdaptiveController(
        slo_p99_ms=float(rng.choice([10.0, 25.0, 50.0])), interval=0.01, limits=limits,
        grow_after=1, relax_health_after=2, retire_after=10**6)
    label = (f"seed={seed} adaptive N={N} S={S} slo={ctl.slo_p99_ms:g} "
             f"faults={[(f.site, f.kind) for f in picks]}")
    strict = HealthPolicy(quarantine_after=3, quarantine_cooldown=0.05)
    eng = ServeEngine(
        max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=64,
        max_coalesce_width=8, health=strict, fault_plan=faults,
        watchdog_interval=0.05, controller=ctl, device=ENGINE["device"])
    reqs = []
    try:
        for i in range(36):
            si = int(rng.integers(S))
            w = int(rng.choice([1, 1, 2, 3]))
            b = rng.standard_normal((N, w)).astype(np.float32)
            kind = int(rng.integers(8))
            deadline = None
            if kind == 0:
                b[int(rng.integers(N)), 0] = np.nan
            elif kind == 1:
                deadline = 0.0
            try:
                fut = eng.submit(sessions[si], b, deadline=deadline)
            except (RhsNonFinite, SessionQuarantined, EngineSaturated):
                continue
            reqs.append((si, b, fut))
            if i < 12:
                time.sleep(0.002)  # a quiet dribble, then a burst as fast as the
                # loop runs, so the controller sees the regime shift mid-faults
        # relaxed as the controller relaxes, if it has not, so the probe
        # always has guarding to restore
        eng.set_knobs(health=dataclasses.replace(
            strict, submit_guard_sample=limits.relaxed_guard_sample),
            staging_stride=limits.staging_stride)
        probe = plan.factor(2.0 * np.eye(N, dtype=np.float32), device=ENGINE["device"])
        poisoned = np.zeros((N, 1), np.float32)
        poisoned[0, 0] = np.nan
        try:
            eng.submit(probe, poisoned)
            return False, f"{label}: a poisoned request was admitted"
        except RhsNonFinite:
            pass
        if eng.health is not strict or eng._staging_stride != 1:
            return False, (f"{label}: a guard trip did not restore full guarding at once "
                           "(the instant-restore contract)")
        wedged = eng.close(timeout=120)
        if wedged:
            return False, f"{label}: close() wedged {wedged}"
    finally:
        eng.close(timeout=10)
    if ctl._thread is not None and ctl._thread.is_alive():
        return False, f"{label}: close() left the controller running"
    cst = ctl.stats()
    if cst["errors"]:
        return False, f"{label}: {cst['errors']} controller tick errors"
    knobs = eng.knobs()
    if not limits.min_batch_delay <= knobs["max_batch_delay"] <= limits.max_batch_delay:
        return False, f"{label}: max_batch_delay escaped its limits"
    if knobs["max_pending"] > limits.max_pending \
            or knobs["max_pending"] < min(limits.min_pending, 64):
        return False, f"{label}: max_pending escaped its limits"
    if knobs["max_coalesce_width"] > limits.max_coalesce_width:
        return False, f"{label}: max_coalesce_width escaped its limits"
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
        err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
        if not err < 1e-3:
            return False, f"{label}: answer off oracle ({err:.2e})"
        answered += 1
    stats = eng.stats()
    if stats["pending"] != 0:
        return False, f"{label}: {stats['pending']} pending slots leaked"
    if stats["completed"] + stats["failed"] != stats["requests"]:
        return False, f"{label}: counters incoherent"
    return True, (f"{label}: ok {answered}/{len(reqs)} answered, ticks={cst['ticks']}, "
                  f"decisions={cst['decisions']}, injected={sum(faults.injected.values())}")


def run_gang_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the gang-resident stacked serving path.

    A same-plan single-system fleet serves round-barriered phases through a
    `stack_sessions=True` engine while the serve fault menu fires; between
    phases sessions mutate (Woodbury drift, forced refactors) and, when
    tiered, the tier spills and revives gang members, churning slot
    assignments. Invariants: every future resolves; failures are
    STRUCTURED resilience errors only; answers match each session's own
    float64 oracle (a gang slot leaking state between sessions would miss
    it); the closed exclusion holes stay closed (`upd_pending` == `checked`
    == 0: drifted and checked sessions ride the stacked path); a spilled
    session is never a gang member; membership never exceeds `max_stack`;
    the engine closes un-wedged with zero pending and coherent counters.

    The substitution is drawn from "blocked" (the default, on K3), "trsm"
    and "inv"; the reference draws the last two, written before the
    blocked engine became the default."""
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
        SessionSpilled,
        SolveUnhealthy,
    )
    from conflux_tpu_torch.tier import ResidentSet

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    N = int(rng.choice([32, 64]))
    S = int(rng.integers(3, 8))
    sub = str(rng.choice(["blocked", "trsm", "inv"]))
    max_stack = int(rng.choice([2, 4, 8]))
    tiered = bool(rng.integers(2))
    checked = bool(rng.integers(2))
    plan = serve.FactorPlan.create((N, N), torch.float32, v=16, substitution=sub)
    As, fleet = [], []
    for i in range(S):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        sess = plan.factor(A, device=ENGINE["device"], sid=f"gang-{i}")
        # pre-traffic drift: upd_pending food
        As.append(_drifted(rng, sess, A, N, 4) if rng.integers(2) else A.astype(np.float64))
        fleet.append(sess)
    rs = None
    if tiered:
        # capacity holds the whole fleet: a gang stacks only what is
        # resident, so the churn comes from the explicit inter-phase
        # spill_lru / revive_many cycles over freed gang slots
        rs = ResidentSet(max_sessions=S)
        rs.adopt(*fleet)
    menu = [
        FaultSpec("dispatch", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("drain", "crash", prob=0.5, count=1),
        FaultSpec("d2h", "crash", prob=0.5, count=1),
        FaultSpec("refresh", "delay", prob=0.5, delay_s=0.002, count=2),
    ]
    if checked:
        # data faults need the guards: an unguarded engine answering a
        # request poisoned after admission with NaN is correct behaviour
        menu += [
            FaultSpec("staging", "nan", prob=0.3, count=int(rng.integers(1, 4))),
            FaultSpec("solve", "unhealthy", prob=0.3, count=int(rng.integers(1, 3))),
        ]
    if tiered:
        menu += [
            FaultSpec("spill", "crash", prob=0.4, count=1),
            FaultSpec("revive", "delay", prob=0.4, delay_s=0.002, count=2),
        ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    label = (f"seed={seed} gang N={N} S={S} sub={sub} max_stack={max_stack} "
             f"tiered={tiered} checked={checked} faults={[(f.site, f.kind) for f in picks]}")
    eng = ServeEngine(
        # a real coalescing window always: stacked dispatch is the path under
        # test (zero-delay traffic degenerates to singletons)
        max_batch_delay=0.002, max_pending=256, max_coalesce_width=8,
        stack_sessions=True, max_stack=max_stack,
        health=HealthPolicy(quarantine_after=3, quarantine_cooldown=0.05) if checked else None,
        fault_plan=faults, residency=rs, watchdog_interval=0.05, device=ENGINE["device"])
    resilience.install_faults(faults)
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              SessionSpilled, InjectedFault)
    answered = total = 0
    try:
        for _phase in range(4):
            reqs = []
            for _rnd in range(3):
                for si in range(S):
                    w = int(rng.choice([1, 1, 2]))
                    b = rng.standard_normal((N, w)).astype(np.float32)
                    kind = int(rng.integers(12))
                    deadline = None
                    if kind == 0 and checked:
                        # admission-guard food (only meaningful with guards)
                        b[int(rng.integers(N)), 0] = np.nan
                    elif kind == 1:
                        deadline = 0.0
                    try:
                        fut = eng.submit(fleet[si], b, deadline=deadline)
                    except (RhsNonFinite, SessionQuarantined, EngineSaturated):
                        continue
                    reqs.append((si, b, fut))
            total += len(reqs)
            for si, b, fut in reqs:
                try:
                    x = np.asarray(fut.result(120))
                except ok_exc:
                    continue
                except Exception as e:  # noqa: BLE001
                    return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
                err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
                if not err < 1e-3:
                    return False, f"{label}: session {si} off its oracle ({err:.2e}): slot leak?"
                answered += 1
            # quiesced inter-phase mutations: drift, refactor, tiering
            for si in range(S):
                r = int(rng.integers(6))
                try:
                    if r == 0:
                        As[si] = _drifted(rng, fleet[si], As[si], N, 4)
                    elif r == 1:
                        fleet[si].refactor()
                except (InjectedFault, SessionSpilled):
                    continue  # structured mutation outcomes are fine
            if tiered and rng.integers(2):
                rs.spill_lru(int(rng.integers(1, S)))
                for s in fleet:
                    if s.tier != "device" and s._gang is not None:
                        return False, f"{label}: spilled session kept its gang slot"
                if rng.integers(2):
                    rs.revive_many(fleet)
        wedged = eng.close(timeout=120)
        if wedged:
            return False, f"{label}: close() wedged {wedged}"
    finally:
        resilience.install_faults(None)
        eng.close(timeout=10)
    st = eng.stats()
    if st["pending"] != 0:
        return False, f"{label}: {st['pending']} pending slots leaked"
    if st["completed"] + st["failed"] != st["requests"]:
        return False, f"{label}: counters incoherent"
    excl = st["stack_exclusions"]
    for key in ("upd_pending", "checked", "mesh", "batched"):
        if excl.get(key, 0):
            return False, f"{label}: exclusion hole reopened: {key}={excl[key]} ({excl})"
    gang = st["gang"]
    if gang["gangs"] and gang["sessions"] > gang["gangs"] * max_stack:
        return False, (f"{label}: gang membership {gang['sessions']} exceeds "
                       f"max_stack={max_stack}")
    return True, (f"{label}: ok {answered}/{total} answered, "
                  f"gang_batches={st['gang_batches']}, adopts={gang['adopts']}, "
                  f"releases={gang['releases']}, injected={sum(faults.injected.values())}")


def run_fleet_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of a several-lane engine: mixed solve and cold-start
    traffic over 2-4 `DeviceLane`s of the soak's one device (a third of the
    sessions pinned by sid hash, the rest opened on the device unpinned;
    cold starts through the work-stealing pool) under the serve fault menu
    plus lane-thread kills.

    The reference runs `lanes="auto"` over eight simulated devices; the
    port's "auto" is one lane per card, so the trial draws the lane count
    and puts every lane on the one device (`devices=[device] * lanes`, as
    `chip_smoke.py` runs two lanes on cuda:0): lanes, not devices, are the
    fault domains here. Invariants: every future resolves; failures are
    STRUCTURED resilience errors (EngineClosed only for work on a killed
    lane); answers match the float64 oracle whichever lane served them; a
    killed lane's workers are respawned and the fleet keeps serving (the
    engine never closes); zero pending and coherent counters at close."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import EngineClosed, EngineSaturated, ServeEngine
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
    S = int(rng.integers(2, 5))
    L = int(rng.integers(2, 5))
    dev = ENGINE["device"]
    plan = serve.FactorPlan.create((N, N), torch.float32, v=16)
    As, sessions = [], []
    for si in range(S):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        # placement mix: sid hash, or unpinned (the reference's third mode,
        # an explicit device of several, is the same call on one device)
        pinned = int(rng.integers(3)) == 0
        sess = plan.factor(A, device=dev, sid=f"soak-{seed}-{si}" if pinned else None)
        As.append(A.astype(np.float64))
        sessions.append(sess)
    menu = [
        FaultSpec("staging", "nan", prob=0.3, count=int(rng.integers(1, 4))),
        FaultSpec("factor", "nan", prob=0.3, count=1),
        FaultSpec("dispatch", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("dispatch", "kill", prob=0.3, count=1),
        FaultSpec("drain", "crash", prob=0.4, count=1),
        FaultSpec("d2h", "crash", prob=0.4, count=1),
        FaultSpec("solve", "unhealthy", prob=0.3, count=int(rng.integers(1, 3))),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    killful = any(f.site == "dispatch" and f.kind == "kill" for f in picks)
    label = (f"seed={seed} fleet N={N} S={S} lanes={L} (of one device) "
             f"faults={[(f.site, f.kind) for f in picks]}")
    eng = ServeEngine(
        max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=128,
        max_coalesce_width=8, max_factor_batch=4, devices=[dev] * L,
        health=HealthPolicy(quarantine_after=2, quarantine_cooldown=0.05),
        fault_plan=faults, watchdog_interval=0.02, device=dev)
    reqs, cold = [], []
    try:
        for _ in range(24):
            if rng.integers(4) == 0:  # a cold start through the pool
                Ac = (rng.standard_normal((N, N)) / np.sqrt(N)
                      + 2.0 * np.eye(N)).astype(np.float32)
                try:
                    cold.append((Ac.astype(np.float64), eng.submit_factor(plan, Ac)))
                except (RhsNonFinite, EngineSaturated):
                    pass
                continue
            si = int(rng.integers(S))
            w = int(rng.choice([1, 1, 2, 3]))
            b = rng.standard_normal((N, w)).astype(np.float32)
            deadline = None
            kind = int(rng.integers(8))
            if kind == 0:
                b[int(rng.integers(N)), 0] = np.nan
            elif kind == 1:
                deadline = 0.0
            try:
                reqs.append((si, b, eng.submit(sessions[si], b, deadline=deadline)))
            except (RhsNonFinite, SessionQuarantined, EngineSaturated, EngineClosed):
                continue
        # a killed lane must not take the fleet down: the engine still admits
        # and answers (possibly on other lanes) after the menu
        time.sleep(0.1)
        if killful and not any(ln.revives for ln in eng.lanes) \
                and faults.injected.get(("dispatch", "kill"), 0):
            time.sleep(0.2)  # the kill fired, no lane revived yet: one more interval
        b = rng.standard_normal((N, 1)).astype(np.float32)
        try:
            x = np.asarray(eng.solve(sessions[0], b, timeout=60))
        except (SolveUnhealthy, SessionQuarantined, InjectedFault, RhsNonFinite,
                EngineClosed) as e:
            if isinstance(e, EngineClosed) and not killful:
                return False, f"{label}: engine died without a kill"
        else:
            err = _rel_err(x, np.linalg.solve(As[0], b.astype(np.float64)))
            if not err < 1e-3:
                return False, f"{label}: post-chaos answer off oracle ({err:.2e})"
        wedged = eng.close(timeout=120)
        if wedged:
            return False, f"{label}: close() wedged {wedged}"
    finally:
        eng.close(timeout=10)
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              InjectedFault, EngineClosed)
    answered = 0
    for si, b, fut in reqs:
        if not fut.done():
            return False, f"{label}: close() left a future unresolved"
        try:
            x = np.asarray(fut.result(0))
        except ok_exc as e:
            if isinstance(e, EngineClosed) and not killful and "lane" in str(e):
                return False, f"{label}: lane died without a kill"
            continue
        except Exception as e:  # noqa: BLE001 — any other leak is a bug
            return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
        err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
        if not err < 1e-3:
            return False, f"{label}: answer off oracle ({err:.2e})"
        answered += 1
    opened = 0
    for Ad, fut in cold:
        if not fut.done():
            return False, f"{label}: cold-start future unresolved"
        try:
            s = fut.result(0)
        except ok_exc:
            continue
        except Exception as e:  # noqa: BLE001
            return False, f"{label}: UNSTRUCTURED cold-start {type(e).__name__}: {e}"
        b = rng.standard_normal((N, 1)).astype(np.float32)
        err = _rel_err(s.solve(b).cpu().numpy(), np.linalg.solve(Ad, b.astype(np.float64)))
        if not err < 1e-3:
            return False, f"{label}: cold-start session off oracle ({err:.2e})"
        opened += 1
    stats = eng.stats()
    if stats["pending"] != 0:
        return False, f"{label}: {stats['pending']} pending slots leaked"
    if stats["completed"] + stats["failed"] != stats["requests"]:
        return False, f"{label}: counters incoherent"
    revives = sum(ln["revives"] for ln in stats["lanes"])
    return True, (f"{label}: ok {answered}/{len(reqs)} solves, {opened}/{len(cold)} cold "
                  f"starts, lanes={len(stats['lanes'])}, lane_revives={revives}, "
                  f"injected={sum(faults.injected.values())}")


def run_mesh_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the serving mesh lane.

    A small fleet of mesh-sharded sessions (one (B, N, N) batched plan over
    a batch mesh of 2-4 shards, factors resident as `batched.Sharded`) is
    served through a tiered engine while the serve fault menu (staging NaN,
    dispatch and d2h delays, forced-unhealthy verdicts) and the tier fault
    sites (spill, revive, disk_write and disk_read crashes and delays)
    fire, with explicit spill/demote churn between requests so revives must
    put the factors back on their shards. The reference shards over the
    eight simulated devices of its CPU mesh; the port draws the shard count
    and puts every shard on the soak's one device (as `chip_smoke.py`
    phase 37 runs two shards of cuda:0), one batch element a shard.
    Invariants: every future resolves with an answer or a STRUCTURED
    error; answers match each batch element's own float64 oracle (a torn
    reshard would scramble elements); the session count is conserved
    across tiers; the engine closes un-wedged with zero pending; and
    `mesh_plan_unsupported` stays at zero."""
    import tempfile

    from conflux_tpu_torch import batched, resilience, serve, tier
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
    B = int(rng.integers(2, 5))
    N = int(rng.choice([24, 32]))
    F = int(rng.integers(1, 3))  # mesh sessions are heavyweight tenants
    dev = ENGINE["device"]
    mesh = batched.batch_mesh([dev] * B)
    plan = serve.FactorPlan.create((B, N, N), torch.float32, v=8, mesh=mesh)
    As, fleet = [], []
    for _ in range(F):
        A = (rng.standard_normal((B, N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        fleet.append(plan.factor(A, device=dev))
        As.append(A.astype(np.float64))
    menu = [
        FaultSpec("staging", "nan", prob=0.3, count=int(rng.integers(1, 3))),
        FaultSpec("dispatch", "delay", prob=0.3, delay_s=0.002, count=3),
        FaultSpec("d2h", "delay", prob=0.3, delay_s=0.002, count=2),
        FaultSpec("solve", "unhealthy", prob=0.4, count=int(rng.integers(1, 3))),
        FaultSpec("spill", "crash", prob=0.3, count=1),
        FaultSpec("spill", "delay", prob=0.3, delay_s=0.001, count=2),
        FaultSpec("revive", "crash", prob=0.3, count=1),
        FaultSpec("revive", "delay", prob=0.3, delay_s=0.001, count=2),
        FaultSpec("disk_write", "crash", prob=0.3, count=1),
        FaultSpec("disk_read", "crash", prob=0.3, count=1),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    label = (f"seed={seed} mesh B={B} (shards of one device) N={N} F={F} "
             f"faults={[(f.site, f.kind) for f in picks]}")
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              InjectedFault, SessionSpilled, RestoreCorrupt)
    h0 = resilience.health_stats().get("mesh_plan_unsupported", 0)
    with tempfile.TemporaryDirectory() as tmp:
        rs = tier.ResidentSet(max_sessions=1, host_max_sessions=max(2, F), disk_dir=tmp,
                              max_concurrent_revives=2, fault_plan=faults)
        eng = ServeEngine(
            max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=64,
            max_coalesce_width=4,
            health=HealthPolicy(quarantine_after=3, quarantine_cooldown=0.05),
            residency=rs, revive_wait=5.0, fault_plan=faults, watchdog_interval=0.05,
            device=dev)
        resilience.install_faults(faults)
        rs.adopt(*fleet)
        reqs = []
        try:
            for _ in range(16):
                si = int(rng.integers(F))
                w = int(rng.choice([1, 1, 2]))
                b = rng.standard_normal((B, N, w)).astype(np.float32)
                if w == 1 and rng.integers(2):
                    b = b[..., 0]  # a vector right-hand side is legal too
                kind = int(rng.integers(8))
                deadline = None
                if kind == 0:  # poisoned: admission guard food
                    b.reshape(-1)[int(rng.integers(b.size))] = np.nan
                elif kind == 1:  # born expired: lazy-eviction food
                    deadline = 0.0
                if rng.integers(3) == 0:
                    # tier churn mid-traffic: the revive must put the factors
                    # back on their shards, not gathered
                    victim = fleet[int(rng.integers(F))]
                    try:
                        if rng.integers(2):
                            rs.spill(victim)
                        else:
                            rs.demote(victim)
                    except ok_exc:
                        pass
                if kind >= 2 and rng.integers(4) == 0:
                    # a direct client-thread touch: transparent revival (clean
                    # requests only: session.solve has no admission guard)
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
            resilience.install_faults(None)
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
            b64 = b.astype(np.float64)
            want = np.stack([np.linalg.solve(As[si][j], b64[j]) for j in range(B)])
            err = _rel_err(x, want)
            if not err < 1e-3:
                return False, (f"{label}: answer off its own oracle ({err:.2e}): torn "
                               "reshard or cross-batch corruption")
            answered += 1
        stats = eng.stats()
        if stats["pending"] != 0:
            return False, f"{label}: {stats['pending']} slots leaked"
        st = rs.stats()
        conserved = (st["resident_sessions"] + st["host_sessions"] + st["disk_sessions"]
                     + st["corrupt_sessions"])
        if conserved != F or st["managed_sessions"] != F:
            return False, f"{label}: session count not conserved ({conserved}/{F}: {st})"
        h1 = resilience.health_stats().get("mesh_plan_unsupported", 0)
        if h1 != h0:
            return False, (f"{label}: mesh_plan_unsupported bumped {h1 - h0}x on a "
                           "healthy mesh trace")
        th = tier.tier_stats()
        return True, (f"{label}: ok {answered}/{len(reqs)} answered, "
                      f"injected={sum(faults.injected.values())}, "
                      f"spills={th['spills_host']}+{th['spills_disk']}d, "
                      f"revives={th['revives_h2d']}h, unsupported=0")


def run_scale_trial(seed: int) -> tuple[bool, str]:
    """One chaos trial of the scale control plane.

    A Zipf stream drives a fleet larger than the device tier through a
    tiered engine while the spill and revive fault sites fire, the LRU's
    implementation is flipped live between "heap" and "sort" each wave
    (`ResidentSet._lru_impl`, seeded from `CONFLUX_TIER_LRU`: both must
    serve the same fleet interchangeably), and an incremental checkpoint
    chain (full, delta, then delta or compaction) runs at the engine's drain
    barrier between waves. Invariants: structured failures only and
    per-session float64 oracle answers; every generation covers the fleet
    (records written + carried == F); a generation after solve-only
    traffic writes zero records (solves never touch the dirty clock); the
    last generation, restored through the delta chain with cold plan
    caches, answers bitwise as the live fleet does."""
    import tempfile

    from conflux_tpu_torch import serve, tier
    from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
    from conflux_tpu_torch.resilience import (
        DeadlineExceeded,
        FaultPlan,
        FaultSpec,
        InjectedFault,
        RestoreCorrupt,
        RhsNonFinite,
        SessionQuarantined,
        SessionSpilled,
        SolveUnhealthy,
    )

    rng = np.random.default_rng(seed)
    serve.clear_plans()
    tier.clear_tier()
    N = int(rng.choice([24, 32]))
    F = int(rng.integers(8, 13))
    C = int(rng.integers(2, 4))
    dev = ENGINE["device"]
    plan = serve.FactorPlan.create((N, N), torch.float32, v=8)
    As, fleet = [], []
    for _ in range(F):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        fleet.append(plan.factor(A, device=dev))
        As.append(A.astype(np.float64))
    menu = [
        FaultSpec("spill", "crash", prob=0.3, count=2),
        FaultSpec("spill", "delay", prob=0.3, delay_s=0.001, count=3),
        FaultSpec("revive", "crash", prob=0.3, count=2),
        FaultSpec("revive", "delay", prob=0.3, delay_s=0.001, count=3),
    ]
    picks = [m for m in menu if rng.integers(2)]
    faults = FaultPlan(picks, seed=seed)
    label = f"seed={seed} scale N={N} F={F} C={C} faults={[(f.site, f.kind) for f in picks]}"
    pmf = 1.0 / np.arange(1, F + 1) ** 1.1
    pmf /= pmf.sum()
    ok_exc = (RhsNonFinite, DeadlineExceeded, SolveUnhealthy, SessionQuarantined,
              InjectedFault, SessionSpilled, RestoreCorrupt)

    def ckpt_counters():
        h = tier.tier_stats()
        return h.get("checkpoint_records_written", 0), h.get("checkpoint_records_carried", 0)

    names = [f"m{i}" for i in range(F)]
    with tempfile.TemporaryDirectory() as tmp:
        rs = tier.ResidentSet(max_sessions=C, disk_dir=os.path.join(tmp, "tier"),
                              evict_batch=max(1, C - 1), max_concurrent_revives=2,
                              fault_plan=faults)
        eng = ServeEngine(
            max_batch_delay=float(rng.choice([0.0, 0.002])), max_pending=64,
            max_coalesce_width=8, residency=rs, revive_wait=5.0, watchdog_interval=0.05,
            device=dev)
        rs.adopt(*fleet)
        gens, reqs, updates = [], [], 0
        try:
            for wave in range(3):
                rs._lru_impl = "sort" if rng.integers(2) else "heap"
                for _ in range(int(rng.integers(6, 10))):
                    si = int(rng.choice(F, p=pmf))
                    b = rng.standard_normal((N, int(rng.choice([1, 2])))).astype(np.float32)
                    try:
                        fut = eng.submit(fleet[si], b)
                    except (RhsNonFinite, SessionQuarantined, EngineSaturated,
                            SessionSpilled, RestoreCorrupt):
                        continue
                    reqs.append((si, b, fut))
                if wave < 2 and rng.integers(2):
                    # drift: food for the delta generations (the dirty clock
                    # must single these sessions out); wave 2 stays solve-only
                    # so its generation is a provable zero-write
                    si = int(rng.choice(F, p=pmf))
                    U = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
                    Vm = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
                    try:
                        fleet[si].update(U, Vm)
                        As[si] = As[si] + U.astype(np.float64) @ Vm.astype(np.float64).T
                        updates += 1
                    except ok_exc:
                        pass
                path = os.path.join(tmp, f"fleet-{wave:06d}")
                full = wave == 0 or (wave == 2 and bool(rng.integers(2)))
                w0, c0 = ckpt_counters()
                eng.checkpoint(path, sessions=fleet, names=names,
                               base=gens[-1] if gens else None, gen=wave, full=full)
                w1, c1 = ckpt_counters()
                if (w1 - w0) + (c1 - c0) != F:
                    return False, (f"{label}: gen {wave} covers {(w1 - w0) + (c1 - c0)}/{F} "
                                   "sessions")
                if wave == 2 and not full and w1 - w0 != 0:
                    return False, (f"{label}: solve-only delta wrote {w1 - w0} records: "
                                   "solves touched the dirty clock")
                gens.append(path)
            wedged = eng.close(timeout=120)
            if wedged:
                return False, f"{label}: close() wedged {wedged}"
        finally:
            eng.close(timeout=10)
        answered = 0
        for si, b, fut in reqs:
            if not fut.done():
                return False, f"{label}: close() left a future open"
            try:
                x = np.asarray(fut.result(0))
            except ok_exc:
                continue
            except Exception as e:  # noqa: BLE001 — a leak is a bug
                return False, f"{label}: UNSTRUCTURED {type(e).__name__}: {e}"
            err = _rel_err(x, np.linalg.solve(As[si], b.astype(np.float64)))
            if not err < 1e-3:
                return False, f"{label}: answer off its own oracle ({err:.2e})"
            answered += 1
        # the last generation sits on the delta chain: restored with cold
        # caches it must answer bitwise as the live fleet does
        b = rng.standard_normal((N, 1)).astype(np.float32)
        live = []
        for s in fleet:
            t0 = time.time()
            while True:
                try:
                    live.append(s.solve(b).cpu().numpy())
                    break
                except ok_exc:
                    if time.time() - t0 > 20.0:
                        return False, f"{label}: live solve never recovered"
                    time.sleep(0.01)
        serve.clear_plans()
        restored = tier.load_fleet(gens[-1], device=dev)
        for i, r in enumerate(restored):
            if not np.array_equal(live[i], r.solve(b).cpu().numpy()):
                return False, (f"{label}: restore from the delta chain not bitwise "
                               f"(session {i})")
        h = tier.tier_stats()
        return True, (f"{label}: ok {answered}/{len(reqs)} answered, {updates} updates, "
                      f"ckpt written={h['checkpoint_records_written']} "
                      f"carried={h['checkpoint_records_carried']}, "
                      f"spills={h['spills_host']}, revives={h['revives_h2d']}, "
                      f"injected={sum(faults.injected.values())}")


TRIALS = {"config": run_trial, "serve": run_serve_trial, "precision": run_precision_trial,
          "qos": run_qos_trial, "adaptive": run_adaptive_trial, "gang": run_gang_trial,
          "fleet": run_fleet_trial, "mesh": run_mesh_trial, "tier": run_tier_trial,
          "scale": run_scale_trial, "fabric": run_fabric_trial,
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--serve", action="store_true",
                      help="the engine with the full HealthPolicy under the serve fault "
                      "menu (staging NaN, dispatch/drain/d2h/refresh delays and crashes, "
                      "unhealthy verdicts) over clean, poisoned and expired traffic")
    mode.add_argument("--adaptive", action="store_true",
                      help="chaos-soak the serving stack WITH the AdaptiveController in the "
                      "loop: fast control ticks against a random SLO while faults fire and "
                      "the traffic shifts; asserts the serve invariants plus controller-"
                      "specific ones (zero tick errors, knobs inside their ControlLimits "
                      "envelope, instant guard restore after any trip, controller stops "
                      "with close())")
    mode.add_argument("--fleet", action="store_true",
                      help="chaos-soak a several-lane engine (2-4 DeviceLanes of the one "
                      "device): mixed solve + cold-start traffic (pooled work-stealing cold "
                      "starts, sid/device placement mix) under the serve fault menu PLUS "
                      "lane-thread kills; asserts per-lane fault domains (a killed lane's "
                      "work fails alone, the lane revives, the fleet keeps serving), "
                      "structured failures only, and per-session f64 oracle answers on "
                      "every lane")
    mode.add_argument("--gang", action="store_true",
                      help="chaos-soak the gang-resident stacked serving path: a same-plan "
                      "single-system fleet under a stack_sessions=True engine with drift/"
                      "refactor mutations and (when tiered) spill/revive slot churn between "
                      "phases; asserts structured failures only, per-session f64 oracle "
                      "answers (zero cross-slot corruption), the closed exclusion holes "
                      "staying closed, and slot/membership accounting")
    mode.add_argument("--mesh", action="store_true",
                      help="chaos-soak the mesh lane: a fleet of mesh-sharded (B, N, N) "
                      "sessions (2-4 shards of the one device) served through a tiered "
                      "engine under the serve fault menu PLUS the spill/revive/disk fault "
                      "sites, with explicit spill/demote churn so revives must reshard; "
                      "asserts structured failures only, per-batch-element f64 oracle "
                      "answers (a torn reshard scrambles elements), session-count "
                      "conservation and mesh_plan_unsupported == 0")
    mode.add_argument("--precision", action="store_true",
                      help="chaos-soak the precision ladder: a mixed native/bf16+IR/f32 "
                      "fleet (some members drifted) serving random per-request tiers "
                      "(None, 'auto', 'bf16_ir', 'f32', 'f64') under the serve fault menu; "
                      "asserts structured failures only, per-tier f64 oracle tolerances, "
                      "and coherent escalation/fallback counters (engine roll-up == "
                      "per-session sums)")
    mode.add_argument("--qos", action="store_true",
                      help="chaos-soak the multi-tenant QoS layer: random tenants across the "
                      "latency/throughput/batch tiers (mixed with unclassified traffic) "
                      "under the serve fault menu while the fair-share ledger admits and "
                      "sheds; asserts structured failures only, TenantThrottled only at "
                      "admission with retry_after/tenant/qos_class attached, per-request "
                      "f64 oracle answers (zero cross-tenant corruption), coherent per-class "
                      "counters and a fully drained ledger after close()")
    mode.add_argument("--scale", action="store_true",
                      help="chaos-soak the scale control plane: Zipf traffic over a fleet >> "
                      "device capacity with the LRU implementation flipped live between "
                      "heap and sort mid-trial and an incremental checkpoint chain (full → "
                      "delta → delta-or-compaction) taken at the engine drain barrier "
                      "between waves; asserts structured failures only, per-session f64 "
                      "oracles, every generation covering the fleet (written + carried == "
                      "F), solve-only deltas writing zero records, and a cold-cache restore "
                      "from the delta chain answering bitwise vs the live fleet")
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
    name = next((m for m in TRIALS if m != "config" and getattr(args, m)), "config")
    out = soak(name, args.trials, args.seed, args.time_budget, args.keep_going,
               args.lockcheck, args.replay, emit=lambda m: print(m, flush=True))
    if args.replay is None:
        print(f"torch_soak: {out['fails']} failures / {out['trials']} trials in "
              f"{out['seconds']:.0f}s on {ENGINE['device']}", flush=True)
    bad_locks = out["lockcheck"] is not None and out["lockcheck"]["violations"]
    return 1 if out["fails"] or bad_locks else 0


if __name__ == "__main__":
    sys.exit(main())
