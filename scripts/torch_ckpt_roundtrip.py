"""Checkpoint -> kill -> restore round trip of the port's serving fleet, in
two processes (a real process death, not a simulated one):

    python scripts/torch_ckpt_roundtrip.py --save    DIR
    python scripts/torch_ckpt_roundtrip.py --restore DIR

`--save` builds a fleet of 8 (N, N) float32 LU sessions (N=1024 by
default: plain, drifted and refine=1 sessions) behind a
`ServeEngine(residency=ResidentSet(...))`, with two members spilled to the
host tier and two demoted to the disk tier; it records every session's
plain and checked answers, counters and drift rank, and checkpoints at the
engine's drain barrier (generation 0, `DIR/fleet-000000`). Then it drifts
two sessions, records them again and writes the delta generation 1
against generation 0 (`full=False`): 2 records written, 6 carried.
`--restore`, in a fresh process, rebuilds both generations through
`engine.restore` (lazily, host-tier) and checks every session's answers,
verdicts, counters and drift rank bitwise against the recorded ones. The
exit status is the gate; the last line is a JSON summary (with the
process's kernel launches).

Runs on the card; `--platform cpu` runs the plain versions on the CPU
(with a smaller `-N` for a quick check).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from conflux_tpu_torch import serve, tier  # noqa: E402
from conflux_tpu_torch.engine import ServeEngine  # noqa: E402
from conflux_tpu_torch.ops import hopper_kernels  # noqa: E402
from conflux_tpu_torch.tier import ResidentSet  # noqa: E402

FLEET = 8
DRIFTED = (2, 3, 6)     # Woodbury state must survive
HOST = (1, 3)           # spilled to the host tier before the checkpoint
DISK = (5, 6)           # demoted to the disk tier before the checkpoint
TOUCHED = (0, 5)        # drifted between generation 0 and generation 1


def _gen(path: str, g: int) -> str:
    return os.path.join(path, f"fleet-{g:06d}")


def _fleet(N: int, v: int, device):
    rng = np.random.default_rng(0)
    plans = [serve.FactorPlan.create((N, N), torch.float32, v=v),
             serve.FactorPlan.create((N, N), torch.float32, v=v, refine=1)]
    sessions = []
    for i in range(FLEET):
        A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
        s = plans[i % 2].factor(A, device=device)
        s.sid = f"s{i}"
        if i in DRIFTED:
            k = 1 + i % 3
            U = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
            Vm = (0.01 * rng.standard_normal((N, k))).astype(np.float32)
            s.update(U, Vm)
        sessions.append(s)
    return sessions, rng


def _record(s, b) -> dict:
    x = s.solve(b).cpu().numpy()
    xc, v = s.solve_checked(b)
    return {"plain": x, "checked": xc.cpu().numpy(), "verdict": v.cpu().numpy(),
            "counters": [s.factorizations, s.solves, s.updates, s.refactors],
            "rank": s.update_rank}


def _save_expected(path: str, recs: list) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "expected.npz"),
             **{f"{k}{i}": r[k] for i, r in enumerate(recs)
                for k in ("plain", "checked", "verdict")})
    with open(os.path.join(path, "expected.json"), "w") as f:
        json.dump({"counters": [r["counters"] for r in recs],
                   "ranks": [r["rank"] for r in recs]}, f)


def save(path: str, N: int, v: int, device) -> int:
    sessions, rng = _fleet(N, v, device)
    b = rng.standard_normal((N, 2)).astype(np.float32)
    np.save(os.path.join(path, "b.npy"), b)
    spill_dir = tempfile.mkdtemp(prefix="spill-", dir=path)
    rs = ResidentSet(max_sessions=FLEET, disk_dir=spill_dir)
    eng = ServeEngine(max_batch_delay=0.0, residency=rs, device=device)
    try:
        rs.adopt(*sessions)
        recs = [_record(s, b) for s in sessions]
        rs.spill(*[sessions[i] for i in set(HOST) | set(DISK)])
        rs.demote(*[sessions[i] for i in DISK])
        tiers0 = [s.tier for s in sessions]
        eng.checkpoint(_gen(path, 0), sessions, [s.sid for s in sessions], gen=0)
        _save_expected(_gen(path, 0), recs)
        # generation 1: two sessions drift (one of them off the disk tier)
        for i in TOUCHED:
            U = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
            sessions[i].update(U, U)
            recs[i] = _record(sessions[i], b)
        w0 = tier.tier_stats()
        eng.checkpoint(_gen(path, 1), sessions, [s.sid for s in sessions],
                       base=_gen(path, 0), gen=1, full=False)
        w1 = tier.tier_stats()
        _save_expected(_gen(path, 1), recs)
    finally:
        eng.close()
    written = w1["checkpoint_records_written"] - w0["checkpoint_records_written"]
    carried = w1["checkpoint_records_carried"] - w0["checkpoint_records_carried"]
    ok = (written == len(TOUCHED) and carried == FLEET - len(TOUCHED)
          and all(tiers0[i] == "host" for i in HOST)
          and all(tiers0[i] == "disk" for i in DISK))
    print(f"torch_ckpt_roundtrip: saved {FLEET} sessions (N={N}, tiers {tiers0}); "
          f"generation 1 wrote {written} records and carried {carried}")
    print(json.dumps({"phase": "save", "ok": ok, "sessions": FLEET, "N": N,
                      "tiers": tiers0, "written": written, "carried": carried,
                      "launches": dict(hopper_kernels.LAUNCHES)}))
    return 0 if ok else 1


def _check(path: str, b: np.ndarray, device) -> int:
    """Restore one generation in this process and count divergences."""
    exp = np.load(os.path.join(path, "expected.npz"))
    with open(os.path.join(path, "expected.json")) as f:
        meta = json.load(f)
    rs = ResidentSet(max_sessions=FLEET)
    eng = ServeEngine(max_batch_delay=0.0, residency=rs, device=device)
    bad = 0
    try:
        sessions = eng.restore(path)
        if len(sessions) != FLEET or any(s.tier != "host" for s in sessions):
            print(f"  {path}: {len(sessions)} sessions, tiers {[s.tier for s in sessions]} "
                  "(want every one host-tier: the restore is lazy)")
            bad += 1
        for i, s in enumerate(sessions):
            got_c = [s.factorizations, s.solves, s.updates, s.refactors]
            if got_c != meta["counters"][i] or s.update_rank != meta["ranks"][i]:
                print(f"  {path} session {i}: counters {got_c} rank {s.update_rank}, "
                      f"want {meta['counters'][i]} rank {meta['ranks'][i]}")
                bad += 1
            x = s.solve(b).cpu().numpy()
            xc, v = s.solve_checked(b)
            for name, got in (("plain", x), ("checked", xc.cpu().numpy()),
                              ("verdict", v.cpu().numpy())):
                if not np.array_equal(got, exp[f"{name}{i}"]):
                    print(f"  {path} session {i}: {name} answer not bitwise")
                    bad += 1
    finally:
        eng.close()
    return bad


def restore(path: str, device) -> int:
    b = np.load(os.path.join(path, "b.npy"))
    bad = {g: _check(_gen(path, g), b, device) for g in (0, 1)}
    ok = not any(bad.values())
    print(f"torch_ckpt_roundtrip: generations 0 and 1 restored in a fresh process, "
          f"{FLEET} sessions each: divergences {bad}")
    print(json.dumps({"phase": "restore", "ok": ok, "sessions": FLEET,
                      "divergences": {str(g): n for g, n in bad.items()},
                      "launches": dict(hopper_kernels.LAUNCHES)}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--save", action="store_true")
    g.add_argument("--restore", action="store_true")
    ap.add_argument("dir")
    ap.add_argument("-N", type=int, default=1024)
    ap.add_argument("-v", type=int, default=256)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.dir, exist_ok=True)
    device = "cpu" if args.platform == "cpu" else None
    return save(args.dir, args.N, args.v, device) if args.save else restore(args.dir, device)


if __name__ == "__main__":
    sys.exit(main())
