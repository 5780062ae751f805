"""host.syncs: the program's host syncs a system: the `sync.*` ranges
(`profiler.sync`) that the thread running the traced systems opened
inside their window, over the systems traced. Each is a read of a device
value on the host or a copy from pageable host memory, and waits for the
card to drain its queue. Nothing where the program opens no such range
and no `solve.forward` range either (a program without the counter); 0
where it solves and syncs nowhere."""

from portbench.trace import host_ranges


def read(run):
    t, n = run.trace, run.traced_systems
    if t is None or not n or not t.device or t.window is None:
        return None
    lo, hi = t.window
    names = [name for t0, _t1, name in host_ranges(t.events).get(t._main_thread(), [])
             if lo <= t0 <= hi]
    syncs = sum(name.startswith("sync.") for name in names)
    if not syncs and "solve.forward" not in names:
        return None
    return syncs / n
