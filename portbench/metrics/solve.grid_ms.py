"""solve.grid_ms: device ms a system spends in the grid triangular solves:
the events launched inside the program's `solve.forward` or
`solve.backward` ranges (`solvers._lu_solver` and
`cholesky_solve_distributed`: the rhs's pivoted gather, the row-tile
products, the diagonal-block TRSMs, the gathers of the solved entries)."""

_SPANS = ("solve.forward", "solve.backward")


def read(run):
    t, n = run.trace, run.traced_systems
    if t is None or not n or not t.device:
        return None
    ms = t.ms_where(lambda path: any(p in _SPANS for p in path))
    return ms / n if ms > 0 else None
