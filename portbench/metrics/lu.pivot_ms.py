"""lu.pivot_ms: device ms a factorization spends electing the panel's
pivots (step1_pivoting: the tournament, K2, the library LUs, gathers,
sorts) and exchanging the pivot rows (step2_pivotrows)."""


def read(run):
    t, n = run.trace, run.traced_factorizations
    if t is None or not n:
        return None
    ph = t.phase_ms()
    ms = sum(ph.get(p, (0.0, 0))[0] for p in ("step1_pivoting", "step2_pivotrows"))
    return ms / n if ms > 0 else None
