"""The readings a cell's limits are set from, at the cell's own sizes: the
numbers its check compares, over many seeds of the program as the
configuration states it, and over a few seeds of the control.

    python3 portbench/calibrate.py --workload chox32k.solve --seeds 101-112 \
        --control-seeds 201-203 --reference-control-seeds 301-303

Each reading is one run of the cell through `harness.run_cell`, the
benchmark's own run and check, with a window of no length: set-up, the
warm-up system, one system of that seed, and the check. `--seeds` run the
program as the configuration states it; `--control-seeds` with the
configuration's `control` options (its own path one precision below);
`--reference-seeds` put the plain reference in the program's place
(`entries/plain_reference.py`), and `--reference-control-seeds` the same
with its trailing updates as TF32 products. One JSON line a reading, with
the checks and `correct`, on standard output and appended to `--out`. The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402

MODES = {
    "program": (None, None),
    "control": ("control", None),
    "reference": ({"tf32": False}, "plain_reference"),
    "reference_control": ({"tf32": True}, "plain_reference"),
}


def seeds(text: str) -> list[int]:
    if not text:
        return []
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def reading(name: str, seed: int, device, mode: str, cfg_overrides: dict | None = None) -> dict:
    """One run of cell `name` with a window of no length, as `mode` says:
    the program ("program"), its control path ("control"), the plain
    reference ("reference") or the TF32 reference ("reference_control")."""
    knobs, entry = MODES[mode]
    if knobs == "control":
        knobs = harness.load_cell(name).cfg["control"]
    over = dict(cfg_overrides or {})
    if entry:
        over["entry"] = entry
    t0 = time.perf_counter()
    r = harness.run_cell(name, seed, 0.0, False, t_start=t0, device=device,
                         cfg_overrides=over or None, entry_knobs=knobs)
    rec = {"workload": name, "mode": mode, "seed": seed, "seconds": time.perf_counter() - t0,
           "correct": r["correct"]}
    rec.update({k: c["value"] for k, c in r["checks"].items()})
    return rec


def emit(rec: dict, out: str | None) -> None:
    """Print one reading, unless JAX or the JAX package has been loaded."""
    found = harness.forbidden_modules()
    if found:
        harness.log(f"calibrate: JAX or the JAX package is loaded, so no reading: {found}")
        raise SystemExit(3)
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("calibrate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="program seeds, a-b")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--reference-seeds", default="", help="the plain reference, float32")
    p.add_argument("--reference-control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.load_cell(args.workload)  # an unknown name fails here
    if not torch.cuda.is_available():
        harness.log("calibrate: no CUDA card visible; the readings are the card's")
        return 2
    harness.log(f"card: {harness.power_line()}")
    plan = ([("program", s) for s in seeds(args.seeds)]
            + [("control", s) for s in seeds(args.control_seeds)]
            + [("reference", s) for s in seeds(args.reference_seeds)]
            + [("reference_control", s) for s in seeds(args.reference_control_seeds)])
    for mode, s in plan:
        emit(reading(args.workload, s, "cuda", mode), args.out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
