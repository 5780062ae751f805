"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload lu32k.solve --seed 7 --seconds 20 --trace 0

The cell's configuration, traffic and metrics are found by name from
`BENCHMARK.json` (see `harness.py`). Runs on one NVIDIA card and refuses
without one. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`: each number compared with its limit); the
last lines of standard error repeat the checks. A run after which
`sys.modules` holds JAX or the JAX package prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    chips = harness.load_cell(args.workload).workload["chips"]  # an unknown name fails here
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"portbench: the cell needs {chips} CUDA card(s) and "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                    "are visible; the benchmark runs on the card only")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: JAX or the JAX package is loaded, so no result: {found}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r} "
                    f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
