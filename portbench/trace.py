"""Reading a `torch.profiler` chrome trace back into device time: the
benchmark's frozen copy of the port's trace arithmetic.

Copied from `conflux_tpu_torch/profiler.py` (`_trace_durations`,
`_host_ranges`, `op_name_map`, `launch_phases`, the phase pattern and the
trace categories) and from `scripts/torch_engine_profile.py` (`_union_us`),
and rewritten to work on one parsed event list. The program may change its
own copies; this one is the yardstick and stays as it is.

The rule: each device event (kernel, memcpy, memset) is charged to the
launch whose correlation id it carries, and a launch to the ranges
(`record_function`) open around its runtime call on the host thread that
made it. The phase of a launch is the innermost enclosing range that
matches the phase pattern, "(other)" where none does.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict

# the grid LU's loop scopes (step0_reduce .. step7_writes) and CONFCHOX's
# (reduceA11 choleskyA00 updateA10 scatterA11 computeA11)
FACTOR_PHASE_RE = r"(step\d+_[a-z0-9]+|(?:reduce|cholesky|update|compute|scatter)A\d\d)"
OTHER = "(other)"

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
RANGE_CAT = "user_annotation"
CPU_OP_CAT = "cpu_op"


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(events: list) -> list:
    """(start us, end us, name, correlation or None) of every device event."""
    out = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            t0 = float(ev["ts"])
            out.append((t0, t0 + float(ev.get("dur", 0.0)), ev.get("name", ""),
                        ev.get("args", {}).get("correlation")))
    return out


def host_ranges(events: list, cat: str = RANGE_CAT) -> dict:
    """(pid, tid) -> that thread's ranges of category `cat` as (start, end,
    name), in start order (outer before inner at one start)."""
    ranges: dict = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == cat:
            t0 = float(ev["ts"])
            ranges[(ev.get("pid"), ev.get("tid"))].append(
                (t0, t0 + float(ev.get("dur", 0.0)), ev["name"]))
    for rs in ranges.values():
        rs.sort(key=lambda r: (r[0], -r[1]))
    return ranges


def launch_paths(events: list) -> dict:
    """Launch (correlation id) -> the names of the ranges that enclosed its
    runtime call on the host thread that made it, outermost first. The
    join goes by launch, not by time on the device: a kernel runs long
    after its range closed on the host."""
    ranges = host_ranges(events)
    calls: dict = defaultdict(list)  # (pid, tid) -> [(ts, corr)]
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                calls[(ev.get("pid"), ev.get("tid"))].append((float(ev["ts"]), corr))
    out: dict = {}
    for thread, cs in calls.items():
        rs = ranges.get(thread, [])
        stack: list = []  # the open ranges at the sweep's time, outer first
        i = 0
        for ts, corr in sorted(cs, key=lambda c: c[0]):
            while i < len(rs) and rs[i][0] <= ts:
                while stack and stack[-1][1] < rs[i][0]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = tuple(r[2] for r in stack)
    return out


def innermost(path: tuple, pattern: re.Pattern) -> str | None:
    """The innermost name of `path` that `pattern` matches (its first
    group), or None."""
    for part in reversed(path):
        m = pattern.search(part)
        if m:
            return m.group(1)
    return None


class Trace:
    """One traced window, parsed once: device events, their launches'
    range paths, the benchmark's system ranges and the window's bounds.

    `system_re` matches the ranges the harness opens around each traced
    system (its first group is the system's index); the window runs from
    the first such range's start to the last one's end."""

    def __init__(self, events: list, system_re: str = r"^portbench\.system\.(\d+)$",
                 phase_re: str = FACTOR_PHASE_RE):
        self.events = events
        self.device = device_events(events)
        self.paths = launch_paths(events)
        self._phase = re.compile(phase_re)
        self._system = re.compile(system_re)
        spans = []
        for rs in host_ranges(events).values():
            for t0, t1, name in rs:
                if self._system.search(name):
                    spans.append((t0, t1))
        self.window = (min(s for s, _ in spans), max(e for _, e in spans)) if spans else None

    def path(self, corr) -> tuple:
        return self.paths.get(corr, ()) if corr is not None else ()

    def phase_of(self, corr) -> str:
        return innermost(self.path(corr), self._phase) or OTHER

    def system_of(self, corr) -> int | None:
        for part in self.path(corr):
            m = self._system.search(part)
            if m:
                return int(m.group(1))
        return None

    def phase_ms(self) -> dict:
        """{phase: (device ms, events)} over the whole trace."""
        agg: dict = defaultdict(lambda: (0.0, 0))
        for t0, t1, _name, corr in self.device:
            ph = self.phase_of(corr)
            ms, n = agg[ph]
            agg[ph] = (ms + (t1 - t0) / 1e3, n + 1)
        return dict(agg)

    def ms_where(self, keep) -> float:
        """Device ms of the events whose launch path `keep(path)` accepts."""
        return sum((t1 - t0) / 1e3 for t0, t1, _n, corr in self.device
                   if keep(self.path(corr)))

    def events_per_system(self) -> dict:
        counts: dict = defaultdict(int)
        for *_rest, corr in self.device:
            counts[self.system_of(corr)] += 1
        return dict(counts)

    def busy_s(self) -> float:
        """Seconds in which some device event ran, inside the window."""
        if self.window is None:
            return 0.0
        lo, hi = self.window
        return union_us((max(t0, lo), min(t1, hi)) for t0, t1, *_ in self.device
                        if t1 > lo and t0 < hi) / 1e6

    def window_s(self) -> float:
        return 0.0 if self.window is None else (self.window[1] - self.window[0]) / 1e6

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        agg: dict = defaultdict(float)
        for t0, t1, name, _corr in self.device:
            agg[name[:160]] += (t1 - t0) / 1e6
        return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds]]: the device's idle gaps inside the
        window, each named by what the host thread that launches the work
        was doing at the gap's middle (innermost range / innermost CPU
        op), summed by name, longest first."""
        if self.window is None:
            return []
        lo, hi = self.window
        busy = merged((max(t0, lo), min(t1, hi)) for t0, t1, *_ in self.device
                      if t1 > lo and t0 < hi)
        gaps, cur = [], lo
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        main = self._main_thread()
        mids = [(s + e) / 2 for s, e in gaps]
        rngs = _innermost_at(host_ranges(self.events).get(main, []), mids)
        ops = _innermost_at(host_ranges(self.events, CPU_OP_CAT).get(main, []), mids)
        agg: dict = defaultdict(float)
        for (s, e), rng, op in zip(gaps, rngs, ops):
            agg[f"{rng or '-'} > {op or '-'}"[:160]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]

    def _main_thread(self):
        for thread, rs in host_ranges(self.events).items():
            if any(self._system.search(name) for _t0, _t1, name in rs):
                return thread
        return None


def _innermost_at(ranges: list, times: list) -> list:
    """For each of the ascending `times`, the name of the innermost range of
    one thread's nested `ranges` (start order) that holds it, or None: the
    sweep of `launch_paths`."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out
