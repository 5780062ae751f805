"""solve.refine_ms: device ms a system spends outside every factorization
phase and outside the benchmark's own drawing of its inputs: the grid
triangular solves, the float64 residual strips of the refinement sweeps,
the copy of A into the grid's shard."""

import re

from portbench.trace import FACTOR_PHASE_RE

_PHASE = re.compile(FACTOR_PHASE_RE)


def _outside(path):
    return not any(p == "portbench.inputs" or _PHASE.search(p) for p in path)


def read(run):
    t, n = run.trace, run.traced_systems
    if t is None or not n or not t.device:
        return None
    ms = t.ms_where(_outside)
    return ms / n if ms > 0 else None
