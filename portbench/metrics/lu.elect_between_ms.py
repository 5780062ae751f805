"""lu.elect_between_ms: device ms a factorization spends between the K2
launches of the panel elections: the events launched inside the program's
`panel.between` ranges (`blas._panel_lu_rows`: the row-gathered TRSM,
the gathers, the masked GEMM and the scatter after each 128-wide column
block but the last)."""


def read(run):
    t, n = run.trace, run.traced_factorizations
    if t is None or not n or not t.device:
        return None
    ms = t.ms_where(lambda path: "panel.between" in path)
    return ms / n if ms > 0 else None
