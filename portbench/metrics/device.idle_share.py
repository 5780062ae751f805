"""device.idle_share: the share of a system's wall time in which no
operation ran on the card, in percent: 1 - (seconds a traced system kept
the card busy, the union of its device intervals) / (the untraced
window's wall seconds a system). The untraced window is the denominator
because the profiler's own host cost stretches the traced systems; the
result line's `device.busy_s` and `window_s` give the traced view."""


def read(run):
    t, n = run.trace, run.traced_systems
    if t is None or not n or not t.device or not run.systems:
        return None
    return 100.0 * (1.0 - (t.busy_s() / n) / (run.window_s / run.systems))
