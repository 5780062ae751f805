"""solve_ms: the measured window's wall time, from its start to the end of
its last whole system, over the systems solved (host clock)."""


def read(run):
    return run.window_s / run.systems * 1e3 if run.systems else None
