"""Host-clock times of the serving rounds of `conflux_tpu_torch` on the card.

    python scripts/torch_serve_rounds.py [--serve a|c] [--trials 10] [--repeat 1] [--root DIR]

Builds `chip_smoke.py`'s serving configuration (a), a (32, 256, 256) f32
LU plan with v=128, or (c), the same shape as an SPD plan (kind="chol"),
factors it once, and then in each trial times 16 `solve` rounds and 16
`solve_checked` rounds (one right-hand side per system) with the host clock
and one synchronize per 16 rounds, as `chip_smoke.py` does; `--repeat R`
runs the 16 rounds R times in each timing, one synchronize at the end (a
longer window: the host clock of one 16-round window varies by tens of
percent between trials and processes). `--root` imports
the package from another checkout, so that two commits can be compared on
one card in one call: run parent, change, change, parent. Prints one JSON
line: the microseconds per round of every trial, their medians, and the
card's name and power limit. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_serve_rounds", description=__doc__)
    p.add_argument("--serve", choices=("a", "c"), default="a")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--rounds", type=int, default=16)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="checkout whose conflux_tpu_torch is imported")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_rounds needs an NVIDIA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from conflux_tpu_torch import serve

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    B, n = 32, 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    kind = "chol" if args.serve == "c" else "lu"
    if kind == "chol":  # the JAX serve tests' SPD class
        A = A @ np.swapaxes(A, 1, 2) + np.eye(n)
    A = torch.from_numpy(A.astype(np.float32)).to("cuda")
    rhs = [torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32)).to("cuda")
           for _ in range(args.rounds)]
    plan = (serve.FactorPlan.create((B, n, n), torch.float32, v=128) if kind == "lu" else
            serve.FactorPlan.create((B, n, n), torch.float32, v=128, kind=kind))
    s = plan.factor(A)
    for b in rhs:  # warm-up: kernel build, allocator
        s.solve(b)
        s.solve_checked(b)
    torch.cuda.synchronize()

    def per_round_us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(args.repeat):
            for b in rhs:
                fn(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (args.rounds * args.repeat) * 1e6

    solve_us, checked_us = [], []
    for _ in range(args.trials):
        solve_us.append(per_round_us(s.solve))
        checked_us.append(per_round_us(s.solve_checked))
    print(json.dumps({
        "root": os.path.abspath(args.root), "serve": args.serve, "nvidia_smi": smi,
        "rounds": args.rounds, "repeat": args.repeat, "solve_us": solve_us, "checked_us": checked_us,
        "solve_us_median": statistics.median(solve_us),
        "checked_us_median": statistics.median(checked_us)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
