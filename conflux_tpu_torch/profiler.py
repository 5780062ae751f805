"""Scoped host wall-clock regions (the role of the reference's semiprof),
the build counter, and the serving counters (the port of the serving half
of `conflux_tpu/profiler.py`).

`region(name)` accumulates host-side wall time and call counts (`profiled`
is its decorator form); `report()` prints a semiprof-style table sorted by
total time; `clear()` resets. Region times are host clocks: a region that
must include device work ends in a synchronize (the miniapp's timed
regions do).

`compile_count()` counts what the port compiles: each build of the
kernel library (`ops/_build.py`, nvcc). It is the instrument of the
engine's zero-build gate after prewarm, the role XLA's compile counter
plays in the JAX package. A plan's serve programs are Python callables
over the kernels, made per bucket without compiling anything; they are
counted apart, in `FactorPlan.trace_counts`.

The serving half: `serve_stats()` reads the `serve.*` regions as per-phase
counters beside the live engines' counters (`engine_stats`), the
resilience outcome counters, the QoS rows (`qos_stats`) and the tier
layer's counters and gauges (`tier.tier_stats`) and the serve fabrics'
census (`fabric.fabric_stats`); `StatsWindow` and `CounterWindow` give
rolling deltas of them. Its XLA tools
(`phase_table`, `op_name_map`, the trace readers) read HLO and XLA traces
and have no counterpart yet (ROADMAP, Slice 7 tooling).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import weakref
from collections import defaultdict

# the region tables are written from every serve-engine worker thread
# (dispatcher, drain, watchdog) and the caller's
_PROF_LOCK = threading.Lock()
_times: dict[str, float] = defaultdict(float)    # guarded-by: _PROF_LOCK
_counts: dict[str, int] = defaultdict(int)       # guarded-by: _PROF_LOCK
_enabled = True
_builds = 0  # guarded-by: _PROF_LOCK


def enable(on: bool = True) -> None:
    """Switch region timing on or off (the reference's
    CONFLUX_WITH_PROFILING)."""
    global _enabled
    _enabled = on


def note_build() -> None:
    """Count one build of the kernel library."""
    global _builds
    with _PROF_LOCK:
        _builds += 1


def compile_count() -> int:
    """Kernel library builds this process has paid (monotone; window it by
    differencing)."""
    with _PROF_LOCK:
        return _builds


@contextlib.contextmanager
def region(name: str):
    """Profiled named scope: `with profiler.region('lu_factorization'): ...`"""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    with _PROF_LOCK:
        _times[name] += dt
        _counts[name] += 1


def profiled(name: str):
    """Decorator form of :func:`region`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with region(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


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
    """Reset the region tables and, global like them, the resilience and
    tier outcome counters (engine counters and the ResidentSet gauges live
    on their objects and survive)."""
    with _PROF_LOCK:
        _times.clear()
        _counts.clear()
    from conflux_tpu_torch import resilience, tier

    resilience.clear_health()
    tier.clear_tier()


def timings() -> dict[str, tuple[int, float]]:
    times, counts = _snapshot()
    return {k: (counts[k], times[k]) for k in times}


# --------------------------------------------------------------------------- #
# serving counters
# --------------------------------------------------------------------------- #

# the serve layer wraps its call sites in region("serve.<phase>")
SERVE_PHASES = ("factor", "solve", "update", "refactor")

# live ServeEngines register here, weakly (an engine dies with its owner)
_ENGINE_REFS: list = []  # guarded-by: _PROF_LOCK


def register_engine(engine) -> None:
    """Called by ServeEngine.__init__; weak, so engines are collectable."""
    ref = weakref.ref(engine)
    with _PROF_LOCK:
        _ENGINE_REFS.append(ref)


def _live_engines() -> list:
    """The live engines, pruning dead refs. Only the registry walk holds
    the lock: callers talk to the engines (their own locks) outside it."""
    alive = []
    with _PROF_LOCK:
        dead = []
        for ref in _ENGINE_REFS:
            e = ref()
            if e is None:
                dead.append(ref)
            else:
                alive.append(e)
        for ref in dead:
            _ENGINE_REFS.remove(ref)
    return alive


def _percentiles(out: dict, xs: list, prefix: str) -> None:
    from conflux_tpu_torch.engine import _percentile

    xs.sort()
    for pct in (50, 95, 99):
        out[f"{prefix}_p{pct}_ms"] = 1e3 * _percentile(xs, pct)


def engine_stats() -> dict:
    """ServeEngine counters merged across live engines: queue high-water
    (max), requests / completions / sheds / batches (sums), the mean
    coalesced batch (request-weighted), p50/p95/p99 latency over the merged
    rolling windows, the factor lane's counters merged the same way, the
    gang counters and the per-reason stack exclusions, and the lane rows'
    extremes. Zeroes when no engine is alive."""
    engines = _live_engines()
    out = {"engines": len(engines), "requests": 0, "completed": 0,
           "shed": 0, "batches": 0, "queue_peak": 0,
           "coalesced_mean": 0.0, "latency_p50_ms": 0.0,
           "latency_p95_ms": 0.0, "latency_p99_ms": 0.0,
           "factor_requests": 0, "factor_batches": 0,
           "factor_coalesced_mean": 0.0, "factor_pad_waste": 0.0,
           "factor_latency_p50_ms": 0.0, "factor_latency_p95_ms": 0.0,
           "factor_latency_p99_ms": 0.0,
           "lanes": 0, "lane_batches_max": 0, "lane_batches_min": 0,
           "lane_occupancy_max": 0.0, "lane_sheds": 0,
           "gang_batches": 0, "gang_coalesced_mean": 0.0,
           "gang_sessions": 0, "gang_opportunity": 0,
           "stack_exclusions": {}}
    coalesced = fcoalesced = fslots = fpad = gcoalesced = 0
    samples: list = []
    fsamples: list = []
    for e in engines:
        s = e.stats()
        for k in ("requests", "completed", "shed", "batches", "factor_requests",
                  "factor_batches", "gang_batches", "gang_opportunity"):
            out[k] += s[k]
        out["queue_peak"] = max(out["queue_peak"], s["queue_peak"])
        coalesced += s["coalesced_requests"]
        fcoalesced += s["factor_coalesced_requests"]
        fslots += s["factor_slots"]
        fpad += s["factor_pad_slots"]
        gcoalesced += s["gang_coalesced_requests"]
        out["gang_sessions"] += s["gang"]["sessions"]
        for k, v in s["stack_exclusions"].items():
            out["stack_exclusions"][k] = out["stack_exclusions"].get(k, 0) + v
        samples.extend(e.latency_samples())
        fsamples.extend(e.factor_latency_samples())
        for ln in s["lanes"]:
            out["lanes"] += 1
            b = ln["batches"] + ln["factor_batches"]
            out["lane_batches_max"] = max(out["lane_batches_max"], b)
            out["lane_batches_min"] = (b if out["lanes"] == 1
                                       else min(out["lane_batches_min"], b))
            out["lane_occupancy_max"] = max(out["lane_occupancy_max"], ln["occupancy"])
            out["lane_sheds"] += ln["sheds"]
    if out["batches"]:
        out["coalesced_mean"] = coalesced / out["batches"]
    if out["gang_batches"]:
        out["gang_coalesced_mean"] = gcoalesced / out["gang_batches"]
    if out["factor_batches"]:
        out["factor_coalesced_mean"] = fcoalesced / out["factor_batches"]
    if fslots:
        out["factor_pad_waste"] = fpad / fslots
    if samples:
        _percentiles(out, samples, "latency")
    if fsamples:
        _percentiles(out, fsamples, "factor_latency")
    return out


def qos_stats() -> dict:
    """Multi-tenant QoS rows merged across live engines: per-class
    counters summed, per-class latency percentiles and SLO attainment over
    the merged per-class windows, per-tenant ledger totals. Engines that
    never saw classified traffic add nothing."""
    engines = _live_engines()
    out: dict = {"engines": 0, "classes": {}, "tenants": {}}
    samples: dict = {}
    for e in engines:
        q = e.counters().get("qos")
        if not q:
            continue
        out["engines"] += 1
        for k, row in q["classes"].items():
            dst = out["classes"].setdefault(k, {
                "tenant": row["tenant"], "tier": row["tier"],
                "priority": row["priority"], "weight": row["weight"],
                "slo_ms": row["slo_ms"], "requests": 0,
                "completed": 0, "failed": 0, "throttled": 0})
            for c in ("requests", "completed", "failed", "throttled"):
                dst[c] += row[c]
        for t, row in q["tenants"].items():
            dst = out["tenants"].setdefault(t, {
                "weight": row["weight"], "pending": 0, "admitted": 0,
                "throttled": 0})
            for c in ("pending", "admitted", "throttled"):
                dst[c] += row[c]
        for k, xs in e.qos_latency_samples().items():
            samples.setdefault(k, []).extend(xs)
    for k, xs in samples.items():
        row = out["classes"].get(k)
        if row is None or not xs:
            continue
        row["latency_samples"] = len(xs)
        _percentiles(row, xs, "latency")
        slo_ms = row.get("slo_ms")
        if slo_ms is not None:
            within = sum(1 for x in xs if 1e3 * x <= slo_ms)
            row["slo_attainment_pct"] = round(100.0 * within / len(xs), 2)
    return out


def serve_stats() -> dict:
    """Per-phase serving counters from the `serve.*` regions:
    {phase: {'count', 'wall_s'}} for factor / solve / update / refactor,
    the amortization ratios 'solves_per_factor' and
    'updates_per_refactor', and five sub-dicts: 'engine' (the live
    engines' counters, :func:`engine_stats`; they live on the engines, so
    `clear()` leaves them), 'health' (the resilience outcome counters,
    global like the region tables, reset by `clear()`), 'qos'
    (:func:`qos_stats`) and 'tier' (`tier.tier_stats`: spill and revive
    counters with the fault-in p50/p95/p99, reset by `clear()`, and the
    live ResidentSets' population and byte gauges, which survive it), and
    'fabric' (`fabric.fabric_stats`: the host census and fail-over gauges
    of the live ServeFabric fronts, which survive `clear()`; the fabric's
    event counters ride 'health')."""
    times, counts = _snapshot()
    out: dict = {}
    for ph in SERVE_PHASES:
        key = f"serve.{ph}"
        out[ph] = {"count": counts.get(key, 0), "wall_s": times.get(key, 0.0)}
    factors = out["factor"]["count"] + out["refactor"]["count"]
    out["solves_per_factor"] = out["solve"]["count"] / factors if factors else 0.0
    refac = out["refactor"]["count"]
    out["updates_per_refactor"] = (out["update"]["count"] / refac if refac
                                   else float("inf") if out["update"]["count"] else 0.0)
    out["engine"] = engine_stats()
    from conflux_tpu_torch import resilience, tier

    out["health"] = resilience.health_stats()
    out["qos"] = qos_stats()
    out["tier"] = tier.tier_stats()
    from conflux_tpu_torch import fabric

    out["fabric"] = fabric.fabric_stats()
    return out


# --------------------------------------------------------------------------- #
# windowed telemetry
# --------------------------------------------------------------------------- #

# engine counters (windowed by differencing); everything else in the
# engine dict is a gauge or a derived ratio
_ENGINE_COUNTERS = (
    "requests", "completed", "failed", "shed", "batches",
    "coalesced_requests", "width_capped", "factor_requests",
    "factor_batches", "factor_coalesced_requests", "factor_slots",
    "factor_pad_slots", "gang_batches", "gang_coalesced_requests",
    "gang_opportunity",
)
# the per-class counters a qos_class= window adds
_QOS_WINDOW_COUNTERS = ("qos_requests", "qos_completed", "qos_failed", "qos_throttled")
# tier.tier_stats() keys that are not counters: the managers' population
# and byte gauges and the fault-in percentiles (cumulative)
_TIER_GAUGES = frozenset({
    "managed_sessions", "resident_sessions", "host_sessions", "disk_sessions",
    "corrupt_sessions", "device_bytes", "device_bytes_high_water",
    "resident_high_water", "host_bytes", "disk_bytes", "fault_in_p50_ms",
    "fault_in_p95_ms", "fault_in_p99_ms",
})


def _diff(cur: dict, prev: dict, keys=None) -> dict:
    """Per-key counter deltas with reset detection: a counter that went
    backwards was reset mid-window, so the window reports the post-reset
    count instead of a negative (what landed between the previous window
    and the reset is lost with the reset)."""
    if keys is None:
        keys = [k for k, v in cur.items() if isinstance(v, (int, float))]
    out = {}
    for k in keys:
        c, p = cur.get(k, 0), prev.get(k, 0)
        out[k] = c - p if c >= p else c
    return out


class StatsWindow:
    """Rolling-window deltas of the serving telemetry.

    Construction snapshots the cumulative counters; each `delta()` returns
    what changed since the previous `delta()` (or construction) and
    advances the window. Counters are differenced (clamped at zero across
    `clear()`, `_diff`); latency percentiles are over the samples that
    completed inside the window only (per-engine sequence tokens,
    `ServeEngine.latency_window`). Windows never disturb each other or the
    cumulative readers. `engine=None` windows every live engine; an engine
    windows its own counters. `qos_class=` ('tenant/tier') scopes the
    latency half to one class's ring and adds its `qos_*` counters.
    """

    def __init__(self, engine=None, qos_class: str | None = None):
        self._engine = None if engine is None else weakref.ref(engine)
        self._qos_class = qos_class
        self._tokens: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._prev: dict | None = None
        self._t_prev = time.perf_counter()
        self.delta()  # prime the baseline snapshot

    def _engines(self) -> list:
        if self._engine is not None:
            e = self._engine()
            return [] if e is None else [e]
        return _live_engines()

    def _snapshot(self) -> tuple[dict, list, list]:
        eng = {k: 0 for k in _ENGINE_COUNTERS}
        if self._qos_class is not None:
            eng.update({k: 0 for k in _QOS_WINDOW_COUNTERS})
        eng["pending"] = 0
        bucket_hits: dict[int, int] = {}
        fbucket_hits: dict[int, int] = {}
        lats: list = []
        flats: list = []
        for e in self._engines():
            s = e.counters()
            for k in _ENGINE_COUNTERS:
                eng[k] += s.get(k, 0)
            eng["pending"] += s["pending"]
            for w, n in s["bucket_hits"].items():
                bucket_hits[w] = bucket_hits.get(w, 0) + n
            for bb, n in s["factor_bucket_hits"].items():
                fbucket_hits[bb] = fbucket_hits.get(bb, 0) + n
            tok, ftok = self._tokens.get(e, (None, None))
            if self._qos_class is None:
                tok, new = e.latency_window(tok)
            else:
                tok, new = e.qos_latency_window(self._qos_class, tok)
                row = (s.get("qos") or {}).get("classes", {}).get(self._qos_class, {})
                for c in ("requests", "completed", "failed", "throttled"):
                    eng[f"qos_{c}"] += row.get(c, 0)
            ftok, fnew = e.factor_latency_window(ftok)
            self._tokens[e] = (tok, ftok)
            lats.extend(new)
            flats.extend(fnew)
        times, counts = _snapshot()
        from conflux_tpu_torch import resilience, tier

        t = tier.tier_stats()
        cur = {
            "engine": eng,
            "bucket_hits": bucket_hits,
            "factor_bucket_hits": fbucket_hits,
            "phases": {ph: {"count": counts.get(f"serve.{ph}", 0),
                            "wall_s": times.get(f"serve.{ph}", 0.0)}
                       for ph in SERVE_PHASES},
            "health": resilience.health_stats(),
            "tier": {k: v for k, v in t.items() if k not in _TIER_GAUGES},
            "tier_gauges": {k: t[k] for k in _TIER_GAUGES if k in t},
        }
        return cur, lats, flats

    def delta(self) -> dict:
        """The windowed telemetry since the last call; advances the
        window."""
        now = time.perf_counter()
        cur, lats, flats = self._snapshot()
        prev = self._prev
        if prev is None:
            prev = {"engine": {}, "bucket_hits": {}, "factor_bucket_hits": {},
                    "phases": {ph: {} for ph in SERVE_PHASES}, "health": {}, "tier": {}}
        dt = max(1e-9, now - self._t_prev)
        keys = (_ENGINE_COUNTERS if self._qos_class is None
                else _ENGINE_COUNTERS + _QOS_WINDOW_COUNTERS)
        eng = _diff(cur["engine"], prev["engine"], keys)
        eng["pending"] = cur["engine"]["pending"]
        # queue growth over the window: admissions minus resolutions
        eng["backlog_delta"] = eng["requests"] - eng["completed"] - eng["failed"]
        eng["arrival_per_s"] = eng["requests"] / dt
        eng["drain_per_s"] = eng["completed"] / dt
        eng["coalesced_mean"] = (eng["coalesced_requests"] / eng["batches"]
                                 if eng["batches"] else 0.0)
        eng["factor_coalesced_mean"] = (
            eng["factor_coalesced_requests"] / eng["factor_batches"]
            if eng["factor_batches"] else 0.0)
        for xs, prefix in ((lats, "latency"), (flats, "factor_latency")):
            _percentiles(eng, xs, prefix)
        eng["latency_samples"] = len(lats)
        eng["factor_latency_samples"] = len(flats)
        out = {
            "seconds": dt,
            "engine": eng,
            "bucket_hits": _diff(cur["bucket_hits"], prev["bucket_hits"]),
            "factor_bucket_hits": _diff(cur["factor_bucket_hits"],
                                        prev["factor_bucket_hits"]),
            "phases": {ph: _diff(cur["phases"][ph], prev["phases"].get(ph, {}),
                                 ("count", "wall_s"))
                       for ph in SERVE_PHASES},
            "health": _diff(cur["health"], prev["health"]),
            "tier": _diff(cur["tier"], prev["tier"]),
            "tier_gauges": cur["tier_gauges"],
        }
        self._prev = cur
        self._t_prev = now
        return out


class CounterWindow:
    """Reset-aware rolling deltas over any monotone-counter dict, the
    cross-process sibling of :class:`StatsWindow`: each `feed(counters)`
    differences the numeric keys against the previous feed with `_diff`'s
    reset clamp, passes the other keys through, and adds `seconds` (the
    window's wall span). Thread-safe: a feed is atomic under the window's
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev: dict | None = None   # guarded-by: _lock
        self._t_prev = time.perf_counter()  # guarded-by: _lock

    def feed(self, counters: dict, t: float | None = None) -> dict:
        now = time.perf_counter() if t is None else t
        num = {k: v for k, v in counters.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
        with self._lock:
            prev = self._prev if self._prev is not None else {}
            dt = max(1e-9, now - self._t_prev)
            out = _diff(num, prev)
            out.update({k: v for k, v in counters.items() if k not in num})
            out["seconds"] = dt
            self._prev = num
            self._t_prev = now
        return out
