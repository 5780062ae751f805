"""refine.residual_ms: device ms a system spends on the float64 residuals
r = b - A x of classic refinement: the events launched inside the
program's `refine.residual` ranges (every sweep's residual strips and the
closing check's, each strip's cast of A and its product)."""


def read(run):
    t, n = run.trace, run.traced_systems
    if t is None or not n or not t.device:
        return None
    ms = t.ms_where(lambda path: "refine.residual" in path)
    return ms / n if ms > 0 else None
