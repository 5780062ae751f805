"""chol.panel_ms: device ms a factorization spends on its panels: the
diagonal tile's factor (choleskyA00) and the column below it
(updateA10)."""


def read(run):
    t, n = run.trace, run.traced_factorizations
    if t is None or not n:
        return None
    ph = t.phase_ms()
    ms = sum(ph.get(p, (0.0, 0))[0] for p in ("choleskyA00", "updateA10"))
    return ms / n if ms > 0 else None
