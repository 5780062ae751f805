"""Scoped host wall-clock regions (the role of the reference's semiprof).

`region(name)` accumulates host-side wall time and call counts; `report()`
prints a semiprof-style table sorted by total time; `clear()` resets.
Region times are host clocks: a region that must include device work ends
in a synchronize (the miniapp's timed regions do).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_PROF_LOCK = threading.Lock()
_times: dict[str, float] = defaultdict(float)    # guarded-by: _PROF_LOCK
_counts: dict[str, int] = defaultdict(int)       # guarded-by: _PROF_LOCK


@contextlib.contextmanager
def region(name: str):
    """Profiled named scope: `with profiler.region('lu_factorization'): ...`"""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    with _PROF_LOCK:
        _times[name] += dt
        _counts[name] += 1


def _snapshot() -> tuple[dict, dict]:
    with _PROF_LOCK:
        return dict(_times), dict(_counts)


def report() -> str:
    """semiprof-style table (reference README.md:120-165 output shape)."""
    times, counts = _snapshot()
    lines = [f"{'REGION':<32}{'CALLS':>8}{'THREAD':>12}{'WALL':>12}{'%':>8}"]
    total = sum(times.values()) or 1.0
    for name, t in sorted(times.items(), key=lambda kv: -kv[1]):
        lines.append(
            f"{name:<32}{counts[name]:>8}{t:>12.3f}{t:>12.3f}{100 * t / total:>8.1f}"
        )
    out = "\n".join(lines)
    print(out)
    return out


def clear() -> None:
    with _PROF_LOCK:
        _times.clear()
        _counts.clear()


def timings() -> dict[str, tuple[int, float]]:
    times, counts = _snapshot()
    return {k: (counts[k], times[k]) for k in times}
