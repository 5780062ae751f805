"""Closed-loop autotuning of the serve engine from live telemetry (the
port of the controller half of `conflux_tpu/control.py`).

The serving stack's throughput comes from spending a little buffering and
latency to buy fewer, larger device operations, and the knobs that price
that trade are static by default: `max_batch_delay` (how long a request
waits for company), the prewarmed width/stack/factor bucket sets (which
coalesced shapes launch without a first-use build), `max_pending` (how
much backlog admission tolerates) and the health guards' sampling.
`profiler.serve_stats()` already measures what a controller needs (queue
depth, coalesced means, pad waste, p50/p95/p99), and real open-loop
traffic shifts (ramps, bursts, width-mix drift).

:class:`AdaptiveController` closes the loop. It runs on its own daemon
thread inside a :class:`~conflux_tpu_torch.engine.ServeEngine`
(``ServeEngine(controller=...)``), consumes windowed deltas of the
engine/health/tier telemetry (`profiler.StatsWindow`: each tick sees what
changed, not lifetime averages), and retunes a declared knob set against a
latency SLO:

- **max_batch_delay**: hill-climbed: widen the window when the coalesced
  mean is low while the backlog builds, shrink it when the window p99
  approaches the SLO or traffic is light.
- **max_pending / EngineSaturated.retry_after**: sized from the measured
  drain rate: admission holds roughly what can drain inside the SLO, and
  shed clients get a retry hint spaced at the measured completion rate.
- **active bucket sets**: grown only through background prewarm: when the
  width cap keeps splitting chunks the controller prewarms the next
  power-of-two bucket on the engine's recently served sessions and plans
  and moves the cap only once `FactorPlan.bucket_ready` reports it warm.
  On the port "warm" means two things at the switch: no kernel build
  (`profiler.compile_count`) and no new `FactorPlan.trace_counts` entry
  between the bucket's `bucket_ready` and the cap move. Cold buckets (no
  hits for `retire_after` windows) are retired through
  `FactorPlan.release_buckets`. The factor lane's batch buckets and the
  gang stacking switch get the same treatment.
- **health guard sampling**: after `relax_health_after` trip-free windows
  the submit-time guard's sample shrinks and the staging guard thins to
  1-in-`staging_stride` batches; any trip restores full guarding at once,
  engine-side (`ServeEngine._restore_guards`), and the controller re-syncs
  its bookkeeping.
- **QoS**: `qos_contention` and the batch tier's delay override, from
  per-class windows.

The controller is advisory and opt-in: every write goes through the
engine's validated, thread-safe :meth:`~conflux_tpu_torch.engine.
ServeEngine.set_knobs`; a tick that throws is counted and skipped; a dead
or detached controller freezes the knobs; ``controller=None`` engines
carry no behavioral change.

    ctl = AdaptiveController(slo_p99_ms=25.0, interval=0.25)
    eng = ServeEngine(max_batch_delay=0.002, controller=ctl)
    ...traffic...
    eng.stats()["controller"]   # ticks, decisions, window, knobs

Decisions are recorded in a bounded log (`stats()['decisions_log']`), each
entry (t, knob, old, new, reason). The fabric's autoscaling half
(`HostLoadEstimator`, `AutoscalePolicy`, `FabricAutoscaler`) waits for the
port of `fabric.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from conflux_tpu_torch import profiler
from conflux_tpu_torch import qos as qos_mod
from conflux_tpu_torch.update import rank_bucket

# the health counters whose window deltas count as "guard trips" — any
# nonzero sum vetoes (and reverts) guard relaxation
_TRIP_KEYS = (
    "rhs_rejects", "staging_isolations", "factor_rejects",
    "factor_isolations", "output_failures", "factor_unhealthy",
)


def _pow2_at_most(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


# --------------------------------------------------------------------------- #
# persistent operating point (autotune.py-style rule rows on disk)
# --------------------------------------------------------------------------- #
#
# A restarted engine would start at the cold constructor defaults and
# spend the controller's first dozen windows re-climbing to wherever
# yesterday's traffic had settled. With `AdaptiveController(persist=True)`
# the controller dumps its current knob vector per REGIME to a small JSON
# in the user's cache directory and re-seeds it at `attach`: strict row
# validation, most-recent-wins per regime, an env-var override, and
# unreadable or invalid files degrade to the cold defaults (the store is
# advisory, never load-bearing). The store is the port's own: its rows
# describe an NVIDIA card, so a port process never reads or writes the
# JAX package's rows (`~/.cache/conflux_tpu/`), which describe another
# device.

_OP_VERSION = 1

# the knob subset a restart may safely re-seed: window/admission/QoS
# knobs apply instantly and never put a build or a first launch on the
# serving path. Bucket caps (max_coalesce_width, max_factor_batch,
# max_stack) are deliberately EXCLUDED: growing them is only ever allowed
# behind the controller's prewarm gate, and a re-seeded cap would point
# at buckets the restarted process has not warmed yet.
_SEED_KNOBS = ("max_batch_delay", "max_pending", "qos_contention")


def operating_point_path() -> str:
    """Where the operating-point rows live:
    `~/.cache/conflux_tpu_torch/operating_point.json` by default, or
    wherever `$CONFLUX_TPU_TORCH_OPERATING_POINT` points."""
    p = os.environ.get("CONFLUX_TPU_TORCH_OPERATING_POINT")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "conflux_tpu_torch",
                        "operating_point.json")


def _validate_op_row(row) -> bool:
    """One rule row: {'regime': str, 'knobs': dict, 'updated': str}.
    Unknown fields reject the row (the autotune.py strictness: a
    half-understood row is worse than a cold start)."""
    if not isinstance(row, dict) or set(row) != {"regime", "knobs",
                                                "updated"}:
        return False
    if not isinstance(row["regime"], str) or not row["regime"]:
        return False
    if not isinstance(row["updated"], str):
        return False
    k = row["knobs"]
    if not isinstance(k, dict):
        return False
    for key, v in k.items():
        if key == "qos_tier_delay":
            if not (isinstance(v, dict)
                    and all(t in qos_mod.TIERS for t in v)
                    and all(isinstance(x, (int, float)) and x >= 0
                            for x in v.values())):
                return False
        elif key not in _SEED_KNOBS \
                or not isinstance(v, (int, float)) \
                or isinstance(v, bool):
            return False
    return True


def load_operating_point(regime: str, path: str | None = None) -> dict:
    """The saved knob vector for `regime` ({} when absent/invalid —
    callers fall back to the cold defaults)."""
    path = operating_point_path() if path is None else path
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != _OP_VERSION \
            or not isinstance(doc.get("rows"), list):
        return {}
    for row in doc["rows"]:
        if _validate_op_row(row) and row["regime"] == regime:
            return dict(row["knobs"])
    return {}


def save_operating_point(regime: str, knobs: dict,
                         path: str | None = None) -> str:
    """Upsert `regime`'s row (read-modify-write, atomic tmp+rename so
    a crashed writer never leaves a torn table) and return the path."""
    path = operating_point_path() if path is None else path
    row = {"regime": regime,
           "knobs": {k: v for k, v in knobs.items()
                     if k in _SEED_KNOBS + ("qos_tier_delay",)
                     and v is not None},
           "updated": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if not _validate_op_row(row):
        raise ValueError(f"unsaveable knob vector {knobs!r}")
    rows = []
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, dict) and doc.get("version") == _OP_VERSION:
            rows = [r for r in doc.get("rows", ())
                    if _validate_op_row(r) and r["regime"] != regime]
    except (OSError, ValueError):
        pass
    rows.append(row)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": _OP_VERSION, "rows": rows}, f, indent=1)
    os.replace(tmp, path)
    return path


@dataclasses.dataclass(frozen=True)
class ControlLimits:
    """Hard bounds every controller move respects — the declared
    actuation envelope. The controller hill-climbs INSIDE this box; it
    never widens it, so an operator reading the limits knows the worst
    case of every knob regardless of what traffic does.

    min/max_batch_delay: the coalescing-window range (seconds).
    min/max_pending: the admission-bound range.
    max_coalesce_width / max_factor_batch: the widest buckets the
        controller may grow to (and therefore prewarm); growth past the
        engine's construction values happens only through the
        prewarm-gated path.
    relaxed_guard_sample: the submit-guard sample size while guards are
        relaxed (elements scanned per request; the strict policy's own
        value is the restore point).
    staging_stride: staging-guard thinning while relaxed (exact check
        runs on 1-in-stride batches).
    """

    min_batch_delay: float = 0.0
    max_batch_delay: float = 0.032
    min_pending: int = 32
    max_pending: int = 8192
    max_coalesce_width: int = 64
    max_factor_batch: int = 64
    max_stack: int = 16
    relaxed_guard_sample: int = 256
    staging_stride: int = 8


class AdaptiveController:
    """The feedback controller: windowed telemetry in, validated knob
    moves out.

    slo_p99_ms: the latency objective. The controller treats it as a
        ceiling to stay under, not a target to fill: knobs that buy
        throughput (wider windows, deeper admission) grow only while
        the window p99 keeps `headroom` of slack.
    interval: seconds between control ticks (each tick one
        `StatsWindow.delta()`).
    limits: a :class:`ControlLimits` actuation envelope.
    headroom: fraction of the SLO at which p99 is "approaching" —
        shrink-the-window territory.
    coalesce_target: mean requests/batch below which the window is
        considered under-coalescing (the widen signal, gated on a
        building backlog).
    delay_grow / delay_shrink: multiplicative hill-climb steps for
        `max_batch_delay`; `delay_floor_step` seeds the climb out of a
        zero window.
    pending_slack: admission sizes to `drain_rate * slo * slack` —
        >1 keeps the pipe full, large values re-grow the mis-sized
        queues the sizing exists to prevent.
    pending_deadband: relative change below which max_pending is left
        alone (actuation hysteresis).
    ema: weight of the newest window in the drain-rate estimate.
    grow_after: consecutive windows of width-cap pressure before a
        bucket grows (debounce — one burst must not inflate the
        warm bucket set).
    retire_after: consecutive hit-less windows before a bucket is
        retired. Retirement drops the bucket's programs; a later touch
        makes them again (a first launch on the serving path), so this
        defaults LONG.
    relax_health_after: consecutive trip-free windows before guard
        sampling relaxes.
    min_window_samples: latency samples a window needs before its p99
        is trusted to steer the delay knob.
    persist: opt into the on-disk operating point (see
        :func:`operating_point_path`): `attach` re-seeds the safe knob
        subset from the saved row for `regime`, and every
        `persist_every`-th tick (and `close`) dumps the current vector
        back. Default off: a `persist=False` controller touches no
        files.
    regime: the operating-point row key (defaults to a key derived
        from the SLO and the engine's lane count at attach — restarts
        of the same deployment shape share a row; distinct shapes
        never cross-seed).
    """

    def __init__(self, *, slo_p99_ms: float = 25.0,
                 interval: float = 0.25,
                 limits: ControlLimits | None = None,
                 headroom: float = 0.8,
                 coalesce_target: float = 2.0,
                 delay_grow: float = 1.6,
                 delay_shrink: float = 0.5,
                 delay_floor_step: float = 5e-4,
                 pending_slack: float = 1.5,
                 pending_deadband: float = 0.25,
                 ema: float = 0.5,
                 grow_after: int = 2,
                 retire_after: int = 120,
                 relax_health_after: int = 20,
                 stack_after: int = 2,
                 unstack_after: int = 30,
                 min_window_samples: int = 8,
                 decision_log: int = 256,
                 persist: bool = False,
                 regime: str | None = None,
                 persist_every: int = 40):
        if slo_p99_ms <= 0 or interval <= 0:
            raise ValueError("slo_p99_ms and interval must be > 0")
        if not 0 < headroom <= 1:
            raise ValueError("headroom must be in (0, 1]")
        if delay_grow <= 1 or not 0 < delay_shrink < 1:
            raise ValueError("need delay_grow > 1 and 0 < delay_shrink < 1")
        self.slo_p99_ms = float(slo_p99_ms)
        self.interval = float(interval)
        self.limits = ControlLimits() if limits is None else limits
        self.headroom = float(headroom)
        self.coalesce_target = float(coalesce_target)
        self.delay_grow = float(delay_grow)
        self.delay_shrink = float(delay_shrink)
        self.delay_floor_step = float(delay_floor_step)
        self.pending_slack = float(pending_slack)
        self.pending_deadband = float(pending_deadband)
        self.ema = float(ema)
        self.grow_after = int(grow_after)
        self.retire_after = int(retire_after)
        self.relax_health_after = int(relax_health_after)
        self.stack_after = int(stack_after)
        self.unstack_after = int(unstack_after)
        self.min_window_samples = int(min_window_samples)

        # cross-thread state: step() runs on the controller thread,
        # stats() on any caller's — everything below is guarded
        self._lock = threading.Lock()
        self._engine_ref = None         # guarded-by: _lock (weakref)
        self._window = None             # guarded-by: _lock
        self._ticks = 0                 # guarded-by: _lock
        self._errors = 0                # guarded-by: _lock
        self._decisions = 0             # guarded-by: _lock
        self._log: list = []            # guarded-by: _lock (bounded)
        self._log_cap = int(decision_log)
        self._last_window: dict = {}    # guarded-by: _lock
        self._drain_rate: float | None = None  # guarded-by: _lock
        # decision state machines (controller-thread only, but kept
        # under the lock so stats() reads a consistent picture)
        self._widen_pressure = 0        # guarded-by: _lock
        self._cap_pressure = 0          # guarded-by: _lock
        self._fcap_pressure = 0         # guarded-by: _lock
        self._calm_windows = 0          # guarded-by: _lock
        self._relaxed = False           # guarded-by: _lock
        self._strict_health = None      # guarded-by: _lock
        # bucket -> consecutive hit-less windows (solve / factor lanes)
        self._cold: dict = {}           # guarded-by: _lock
        self._fcold: dict = {}          # guarded-by: _lock
        # in-flight background prewarm: (target_bucket, Thread) or None
        self._width_prewarm = None      # guarded-by: _lock
        self._fbatch_prewarm = None     # guarded-by: _lock
        # gang-stacking steering state: consecutive
        # windows of missed stacking opportunity / of an idle enabled
        # gang path, and the in-flight stacked-bucket prewarm
        # ((max_stack target, width, Thread) or None)
        self._stack_pressure = 0        # guarded-by: _lock
        self._stack_idle = 0            # guarded-by: _lock
        self._stack_prewarm = None      # guarded-by: _lock
        # per-lane delay tuning state (multi-lane engines):
        # the previous tick's per-lane counter rows and each lane's
        # debounced widen-pressure count
        self._lane_prev: dict = {}      # guarded-by: _lock
        self._lane_widen: dict = {}     # guarded-by: _lock
        # multi-tenant QoS steering state: one per-class
        # StatsWindow (key -> window) opened lazily once the engine
        # reports QoS traffic, plus the debounce counters for the
        # contention / batch-stretch knobs
        self._qos_windows: dict = {}    # guarded-by: _lock
        self._qos_hot = 0               # guarded-by: _lock
        self._qos_calm = 0              # guarded-by: _lock
        self._qos_batch_pressure = 0    # guarded-by: _lock
        self._qos_batch_idle = 0        # guarded-by: _lock
        # persistent operating point: the regime row this
        # controller seeds from / dumps to, or None when persist=False
        self.persist = bool(persist)
        self._regime = regime           # resolved at attach when None
        self._persist_every = max(1, int(persist_every))
        self._reseeded: dict = {}       # guarded-by: _lock (last seed)

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ #
    # lifecycle (engine start/close own these; tests drive step() bare)
    # ------------------------------------------------------------------ #

    def attach(self, engine) -> "AdaptiveController":
        """Bind to an engine (weakly — the controller must never keep a
        dead engine alive) and prime the telemetry window. Called by
        ``ServeEngine(controller=...)``; tests may attach manually and
        drive :meth:`step` without ever starting the thread."""
        import weakref

        with self._lock:
            if self._engine_ref is not None and self._engine_ref() is not None:
                raise RuntimeError("controller is already attached — one "
                                   "controller steers one engine")
            self._engine_ref = weakref.ref(engine)
            self._window = profiler.StatsWindow(engine)
            self._strict_health = engine.health
            if self._regime is None:
                # same deployment shape -> same row; distinct shapes
                # (different SLO or lane fan-out) never cross-seed
                self._regime = (f"slo{self.slo_p99_ms:g}"
                                f"-l{max(1, len(engine._lanes))}")
        if self.persist:
            self._reseed(engine)
        return self

    def _reseed(self, engine) -> None:
        """Apply the saved operating point for this regime (if any),
        clamped to the limits envelope so a stale or hand-edited row
        can never steer outside what the live controller would."""
        row = load_operating_point(self._regime)
        if not row:
            return
        lim = self.limits
        seed: dict = {}
        if "max_batch_delay" in row:
            seed["max_batch_delay"] = min(
                lim.max_batch_delay,
                max(lim.min_batch_delay, float(row["max_batch_delay"])))
        if "max_pending" in row:
            seed["max_pending"] = min(
                lim.max_pending,
                max(lim.min_pending, int(row["max_pending"])))
        if "qos_contention" in row:
            seed["qos_contention"] = min(
                1.0, max(0.05, float(row["qos_contention"])))
        if "qos_tier_delay" in row:
            seed["qos_tier_delay"] = {
                t: min(lim.max_batch_delay, float(v))
                for t, v in row["qos_tier_delay"].items()}
        if not seed:
            return
        try:
            engine.set_knobs(**seed)
        except Exception:  # noqa: BLE001 — a bad row must not kill attach
            with self._lock:
                self._errors += 1
            return
        with self._lock:
            self._reseeded = seed
        self._record("operating_point", None, seed,
                     f"re-seeded regime {self._regime!r} from "
                     f"{operating_point_path()}")

    def _persist_tick(self, eng, final: bool = False) -> None:
        """Dump the current knob vector for this regime — every
        `persist_every`-th tick and once at close."""
        if not self.persist or self._regime is None:
            return
        with self._lock:
            due = final or (self._ticks % self._persist_every == 0)
        if not due:
            return
        try:
            save_operating_point(self._regime, eng.knobs())
        except Exception:  # noqa: BLE001 — persistence is best-effort
            with self._lock:
                self._errors += 1

    def start(self) -> None:
        """Spawn the control-loop daemon thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-engine-controller", daemon=True)
        self._thread.start()

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop the control loop and join it (idempotent). The engine's
        close() calls this before tearing down the workers; the knobs
        stay wherever the last tick left them."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        if self.persist:
            with self._lock:
                ref = self._engine_ref
            eng = None if ref is None else ref()
            if eng is not None:
                self._persist_tick(eng, final=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                ref = self._engine_ref
            eng = None if ref is None else ref()
            if eng is None or eng._closed:
                return  # the watchdog tie-in: a closed engine ends us
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the controller is advisory
                with self._lock:
                    self._errors += 1

    # ------------------------------------------------------------------ #
    # the control tick
    # ------------------------------------------------------------------ #

    def step(self) -> dict | None:
        """One control tick: take the telemetry window, run every
        decision block, actuate through `engine.set_knobs`. Public so
        tests and benches can drive the loop deterministically (no
        thread, no timing). Returns the window it acted on (None when
        the engine is gone)."""
        with self._lock:
            ref = self._engine_ref
            window = self._window
        eng = None if ref is None else ref()
        if eng is None or window is None:
            return None
        d = window.delta()
        with self._lock:
            self._ticks += 1
            self._last_window = d
        e = d["engine"]
        self._decide_drain_rate(eng, d, e)
        self._decide_pending(eng, d, e)
        self._decide_delay(eng, d, e)
        self._decide_lane_delays(eng, d, e)
        self._decide_widths(eng, d, e)
        self._decide_factor_batches(eng, d, e)
        self._decide_stacking(eng, d, e)
        self._decide_health(eng, d, e)
        self._decide_qos(eng, d, e)
        self._persist_tick(eng)
        return d

    def _record(self, knob: str, old, new, reason: str) -> None:
        with self._lock:
            self._decisions += 1
            self._log.append((time.perf_counter(), knob, old, new, reason))
            if len(self._log) > self._log_cap:
                del self._log[: len(self._log) - self._log_cap]

    # -- drain rate (feeds retry_after and the admission sizing) -------- #

    def _decide_drain_rate(self, eng, d, e) -> None:
        if not e["completed"] or d["seconds"] <= 0:
            return  # nothing drained: keep the last estimate
        rate = e["completed"] / d["seconds"]
        with self._lock:
            prev = self._drain_rate
            rate = (rate if prev is None
                    else self.ema * rate + (1 - self.ema) * prev)
            self._drain_rate = rate
        eng.set_knobs(drain_rate=rate)

    # -- admission bound: hold what can drain inside the SLO ------------ #

    def _decide_pending(self, eng, d, e) -> None:
        with self._lock:
            rate = self._drain_rate
        if rate is None or rate <= 0:
            return
        lim = self.limits
        want = int(rate * (self.slo_p99_ms * 1e-3) * self.pending_slack)
        want = max(lim.min_pending, min(lim.max_pending, want))
        cur = eng.max_pending
        if abs(want - cur) <= self.pending_deadband * cur:
            return  # hysteresis: don't thrash the bound over noise
        eng.set_knobs(max_pending=want)
        self._record(
            "max_pending", cur, want,
            f"drain {rate:.0f}/s x SLO {self.slo_p99_ms:.0f}ms x "
            f"slack {self.pending_slack:g} — admission holds what can "
            "drain inside the SLO")

    # -- batch-delay hill climb ----------------------------------------- #

    def _decide_delay(self, eng, d, e) -> None:
        lim = self.limits
        cur = eng.max_batch_delay
        have_p99 = e["latency_samples"] >= self.min_window_samples
        p99 = e["latency_p99_ms"]
        if have_p99 and p99 >= self.headroom * self.slo_p99_ms:
            # p99 approaching the SLO: the window is latency we can
            # refund — shrink it first (cheapest reversible lever)
            new = max(lim.min_batch_delay, cur * self.delay_shrink)
            if new < self.delay_floor_step / 4:
                new = lim.min_batch_delay  # snap out of the decay tail
            if cur > lim.min_batch_delay and new < cur:
                eng.set_knobs(max_batch_delay=new)
                self._record("max_batch_delay", cur, new,
                             f"window p99 {p99:.1f}ms >= "
                             f"{self.headroom:.0%} of SLO "
                             f"{self.slo_p99_ms:.0f}ms — shrink")
            return
        # "backlog building" must mean it, not a 2-deep transient: a
        # busy-but-stable regime leaves a few requests in flight at any
        # instant, and widening the window there trades p50/p99 for
        # nothing (the over-eager version of this test cost the bench's
        # ramp tail ~60% p99). Require either a meaningful fraction of
        # the window's arrivals left unserved, or a queue deep relative
        # to the admission bound.
        backlog_rising = (
            e["backlog_delta"] > max(2.0, 0.05 * e["requests"])
            or e["pending"] > 0.5 * eng.max_pending)
        under_coalesced = (e["batches"] > 0
                           and e["coalesced_mean"] < self.coalesce_target)
        with self._lock:
            if under_coalesced and backlog_rising:
                self._widen_pressure += 1
            else:
                self._widen_pressure = 0
            widen = self._widen_pressure >= 2
        if widen:
            # demand outpaces narrow dispatches for two consecutive
            # windows (one Poisson clump must not widen the window —
            # a transient costs every later request the full delay):
            # widen so each dispatch amortizes over more requests
            new = min(lim.max_batch_delay,
                      max(cur * self.delay_grow,
                          self.delay_floor_step))
            if new > cur:
                eng.set_knobs(max_batch_delay=new)
                self._record(
                    "max_batch_delay", cur, new,
                    f"coalesced mean {e['coalesced_mean']:.1f} < "
                    f"{self.coalesce_target:g} with backlog "
                    f"{e['backlog_delta']:+d} — widen")
            return
        if (e["requests"] and not backlog_rising
                and e["coalesced_mean"] <= 1.5
                and cur > lim.min_batch_delay):
            # light traffic arriving alone: the window buys nothing and
            # costs its full length in p50 — decay it
            new = max(lim.min_batch_delay, cur * self.delay_shrink)
            if new < self.delay_floor_step / 4:
                new = lim.min_batch_delay  # snap out of the decay tail
            if new < cur:
                eng.set_knobs(max_batch_delay=new)
                self._record("max_batch_delay", cur, new,
                             "light solo traffic — the window is pure "
                             "added latency; decay")

    # -- per-lane batch-delay trim (mesh-sharded fleets) ---- #

    def _decide_lane_delays(self, eng, d, e) -> None:
        """Tune each lane's coalescing window INDEPENDENTLY on a
        multi-lane engine: the fleet's devices see different traffic
        (hot sessions pin to one lane), so the engine-wide window that
        `_decide_delay` hill-climbs is only the default — a lane whose
        own dispatches stay narrow while ITS queue builds widens its
        override (debounced two windows, like the global climb), and a
        lane coalescing fine on solo traffic decays back toward the
        engine-wide value. Writes ride the same `set_knobs` rails
        (`lane=` scope), inside the same `ControlLimits` envelope."""
        lanes = eng.counters().get("lanes", ())
        if len(lanes) < 2:
            return
        lim = self.limits
        base = eng.max_batch_delay
        with self._lock:
            prev = self._lane_prev
            self._lane_prev = {ln["lane"]: ln for ln in lanes}
        for ln in lanes:
            i = ln["lane"]
            if ln.get("dead"):
                continue
            p = prev.get(i, {})
            batches = ln["batches"] - p.get("batches", 0)
            coalesced = (ln["coalesced_requests"]
                         - p.get("coalesced_requests", 0))
            mean = coalesced / batches if batches else 0.0
            depth = ln.get("queue_depth", 0)
            cur = ln.get("delay", base)
            under = (batches > 0 and mean < self.coalesce_target
                     and depth > 1)
            with self._lock:
                n = self._lane_widen.get(i, 0) + 1 if under else 0
                self._lane_widen[i] = n
            if n >= 2:
                new = min(lim.max_batch_delay,
                          max(cur * self.delay_grow,
                              self.delay_floor_step))
                if new > cur:
                    eng.set_knobs(lane=i, max_batch_delay=new)
                    self._record(
                        f"lane{i}.max_batch_delay", cur, new,
                        f"lane {i} coalesced mean {mean:.1f} < "
                        f"{self.coalesce_target:g} with queue depth "
                        f"{depth} — widen this lane only")
                continue
            if (batches > 0 and depth == 0 and mean <= 1.5
                    and cur > base):
                # solo traffic on an over-widened lane: decay its
                # override toward the engine-wide default
                new = max(base, cur * self.delay_shrink)
                eng.set_knobs(lane=i, max_batch_delay=new)
                self._record(
                    f"lane{i}.max_batch_delay", cur, new,
                    f"lane {i} light solo traffic — decay toward the "
                    f"engine-wide window {base * 1e3:.1f}ms")

    # -- bucket growth (prewarm-gated) + retirement --------------------- #

    def _decide_widths(self, eng, d, e) -> None:
        lim = self.limits
        cur = eng.max_coalesce_width
        with self._lock:
            pre = self._width_prewarm
        # 1. an in-flight growth completes only when every active plan's
        # target bucket is warm — the knob NEVER moves onto a cold
        # program (a failed prewarm just drops the attempt)
        if pre is not None:
            target, thread = pre
            if thread.is_alive():
                return  # still warming in the background
            sessions, _plans = eng.active_targets()
            checked = eng.health is not None and eng.health.check_output
            ready = [s.plan.bucket_ready(width=target, checked=checked)
                     for s in sessions]
            with self._lock:
                self._width_prewarm = None
            if ready and all(ready) and target > eng.max_coalesce_width:
                eng.set_knobs(max_coalesce_width=target)
                self._record("max_coalesce_width", cur, target,
                             f"bucket {target} prewarmed on "
                             f"{len(ready)} session(s) — cap grows "
                             "onto warm programs only")
            return
        # 2. growth pressure: the cap keeps splitting chunks
        with self._lock:
            if e.get("width_capped", 0) > 0:
                self._cap_pressure += 1
            else:
                self._cap_pressure = 0
            pressure = self._cap_pressure
        have_p99 = e["latency_samples"] >= self.min_window_samples
        p99_ok = (not have_p99
                  or e["latency_p99_ms"] < self.headroom * self.slo_p99_ms)
        if pressure >= self.grow_after and p99_ok \
                and cur < lim.max_coalesce_width:
            target = min(lim.max_coalesce_width, 2 * _pow2_at_most(cur))
            if target > cur:
                self._launch_width_prewarm(eng, target)
            return
        # 3. retirement: buckets with a long zero-hit history drop
        # their programs and the cap shrinks to what traffic
        # actually uses
        self._retire_widths(eng, d, e)

    def _launch_width_prewarm(self, eng, target: int) -> None:
        sessions, _plans = eng.active_targets()
        if not sessions:
            return  # nothing served yet — nothing to warm against
        # one representative session per plan (warmth is per plan; any
        # session of it warms the bucket)
        per_plan: dict = {}
        for s in sessions:
            per_plan.setdefault(id(s.plan), s)

        def run():
            for s in per_plan.values():
                eng.prewarm(s, widths=(target,))

        t = threading.Thread(target=run, daemon=True,
                             name="serve-engine-controller-prewarm")
        with self._lock:
            self._width_prewarm = (target, t)
        t.start()
        self._record("prewarm", None, target,
                     f"width cap pressure: background-prewarming "
                     f"bucket {target} on {len(per_plan)} plan(s) "
                     "before any cap move")

    def _retire_widths(self, eng, d, e) -> None:
        hits = d.get("bucket_hits", {})
        with self._lock:
            seen = set(self._cold) | set(hits)
            for b in seen:
                self._cold[b] = 0 if hits.get(b, 0) else \
                    self._cold.get(b, 0) + 1
            cold = sorted(b for b, n in self._cold.items()
                          if n >= self.retire_after and b > 1)
            hot = [b for b, n in self._cold.items()
                   if n < self.retire_after]
        if not cold:
            return
        sessions, plans = eng.active_targets()
        all_plans = {id(p): p for p in plans}
        for s in sessions:
            all_plans.setdefault(id(s.plan), s.plan)
        dropped = 0
        for p in all_plans.values():
            dropped += p.release_buckets(widths=cold)
        cur = eng.max_coalesce_width
        new_cap = max([1] + hot)
        if new_cap < cur:
            eng.set_knobs(max_coalesce_width=new_cap)
        with self._lock:
            for b in cold:
                self._cold.pop(b, None)
        self._record(
            "release_widths", cur,
            new_cap if new_cap < cur else cur,
            f"buckets {cold} cold for {self.retire_after} windows — "
            f"released {dropped} program(s)"
            + (f", cap {cur} -> {new_cap}" if new_cap < cur else ""))

    def _decide_factor_batches(self, eng, d, e) -> None:
        lim = self.limits
        cur = eng.max_factor_batch
        with self._lock:
            pre = self._fbatch_prewarm
        if pre is not None:
            target, thread = pre
            if thread.is_alive():
                return
            _sessions, plans = eng.active_targets()
            checked = eng.health is not None and eng.health.check_output
            ready = [p.bucket_ready(factor_batch=target, checked=checked)
                     for p in plans]
            with self._lock:
                self._fbatch_prewarm = None
            if ready and all(ready) and target > eng.max_factor_batch:
                eng.set_knobs(max_factor_batch=target)
                self._record("max_factor_batch", cur, target,
                             f"factor bucket {target} prewarmed on "
                             f"{len(ready)} plan(s)")
            return
        # growth pressure: factor batches keep filling the cap while
        # cold-start work queues behind them
        full = (e["factor_batches"] > 0
                and e["factor_coalesced_mean"] >= 0.9 * cur)
        with self._lock:
            self._fcap_pressure = self._fcap_pressure + 1 if full else 0
            pressure = self._fcap_pressure
        if pressure >= self.grow_after and cur < lim.max_factor_batch:
            _sessions, plans = eng.active_targets()
            if plans:
                target = min(lim.max_factor_batch, 2 * cur)

                def run():
                    for p in plans:
                        eng.prewarm(p, widths=(),
                                    factor_batches=(target,))

                t = threading.Thread(
                    target=run, daemon=True,
                    name="serve-engine-controller-prewarm")
                with self._lock:
                    self._fbatch_prewarm = (target, t)
                t.start()
                self._record("prewarm", None, target,
                             f"factor cap pressure: background-"
                             f"prewarming batch bucket {target}")
            return
        # retirement (never bucket 1 — plan.factor's own path)
        hits = d.get("factor_bucket_hits", {})
        with self._lock:
            for b in set(self._fcold) | set(hits):
                self._fcold[b] = 0 if hits.get(b, 0) else \
                    self._fcold.get(b, 0) + 1
            cold = sorted(b for b, n in self._fcold.items()
                          if n >= self.retire_after and b > 1)
        if not cold:
            return
        _sessions, plans = eng.active_targets()
        dropped = sum(p.release_buckets(factor_batches=cold)
                      for p in plans)
        with self._lock:
            for b in cold:
                self._fcold.pop(b, None)
        if dropped:
            self._record("release_factor_batches", None, cold,
                         f"factor buckets {cold} cold for "
                         f"{self.retire_after} windows — released "
                         f"{dropped} program(s)")

    # -- gang stacking: enable on missed opportunity, prewarm-gated ----- #

    def _decide_stacking(self, eng, d, e) -> None:
        """Steer `stack_sessions` / `max_stack`: with
        stacking OFF the engine counts, per window, the same-plan
        sessions it dispatched solo that a gang would have stacked
        (`gang_opportunity`); sustained opportunity prewarms the
        stacked bucket for the traffic's dominant width on every
        active single-system plan (BACKGROUND thread) and flips the
        knob only once `FactorPlan.bucket_ready(stack=...)` reports
        every program warm — the same prewarm-gated discipline as
        every other bucket move, so the switch itself never puts a
        first use on the serving path. With stacking ON, sustained
        windows of dispatches with ZERO stacked batches mean the
        fleet stopped offering pairs — disable, refunding the (tiny)
        per-window grouping work."""
        lim = self.limits
        with self._lock:
            pre = self._stack_prewarm
        if pre is not None:
            target, wb, thread = pre
            if thread.is_alive():
                return
            sessions, _plans = eng.active_targets()
            checked = eng.health is not None and eng.health.check_output
            ready = [s.plan.bucket_ready(stack=(target, wb),
                                         checked=checked)
                     for s in sessions
                     if not s.plan.batched and s.plan.key.mesh_key is None]
            with self._lock:
                self._stack_prewarm = None
            if ready and all(ready) and not eng.stack_sessions:
                eng.set_knobs(stack_sessions=True, max_stack=target)
                self._record(
                    "stack_sessions", False, target,
                    f"stacked bucket ({target}, {wb}) prewarmed on "
                    f"{len(ready)} session(s) — gang stacking enabled "
                    "onto warm programs only")
            return
        opp = e.get("gang_opportunity", 0)
        if not eng.stack_sessions:
            with self._lock:
                self._stack_pressure = (self._stack_pressure + 1
                                        if opp >= 2 else 0)
                pressure = self._stack_pressure
            if pressure < self.stack_after:
                return
            sessions, _plans = eng.active_targets()
            targets = {}
            for s in sessions:
                if not s.plan.batched and s.plan.key.mesh_key is None:
                    targets.setdefault(id(s.plan), s)
            if not targets:
                return
            target = max(2, min(_pow2_at_most(lim.max_stack),
                                rank_bucket(max(2, opp))))
            hits = d.get("bucket_hits", {})
            wb = max(hits, key=hits.get) if hits else 1
            reps = list(targets.values())

            def run():
                for s in reps:
                    eng.prewarm(s, widths=(wb,), stacks=(target,))

            t = threading.Thread(target=run, daemon=True,
                                 name="serve-engine-controller-prewarm")
            with self._lock:
                self._stack_pressure = 0
                self._stack_prewarm = (target, wb, t)
            t.start()
            self._record(
                "prewarm", None, (target, wb),
                f"{opp} stackable session(s) dispatched solo this "
                f"window: background-prewarming the ({target}, {wb}) "
                "stacked bucket before any knob move")
            return
        # stacking is on: watch for a fleet that stopped pairing up
        idle = (e["batches"] > 0 and e.get("gang_batches", 0) == 0)
        with self._lock:
            self._stack_idle = self._stack_idle + 1 if idle else 0
            idle_n = self._stack_idle
        if idle_n >= self.unstack_after:
            eng.set_knobs(stack_sessions=False)
            with self._lock:
                self._stack_idle = 0
            self._record(
                "stack_sessions", True, False,
                f"{idle_n} consecutive windows dispatched without a "
                "single stacked batch — gang stacking disabled (gangs "
                "keep their resident state for a later re-enable)")

    # -- guard sampling: back off on silence, restore on any trip ------- #

    def _decide_health(self, eng, d, e) -> None:
        with self._lock:
            strict = self._strict_health
        if strict is None or not strict.check_rhs:
            return  # nothing to relax
        trips = sum(d["health"].get(k, 0) for k in _TRIP_KEYS)
        with self._lock:
            if trips:
                self._calm_windows = 0
                was_relaxed = self._relaxed
                self._relaxed = False
            else:
                self._calm_windows += 1
                was_relaxed = self._relaxed
        if trips:
            # the ENGINE already restored strict guarding on the
            # tripping thread (`_restore_guards`); this just re-syncs
            # the controller's bookkeeping and records the event
            if was_relaxed:
                eng.set_knobs(health=strict, staging_stride=1)
                self._record("health", "relaxed", "strict",
                             f"{trips} guard trip(s) in the window — "
                             "full guarding restored (engine-side, "
                             "instantly; this records it)")
            return
        with self._lock:
            calm = self._calm_windows
            relaxed = self._relaxed
        if relaxed or calm < self.relax_health_after:
            return
        lim = self.limits
        sample = strict.submit_guard_sample
        relaxed_sample = (lim.relaxed_guard_sample if sample is None
                          else min(sample, lim.relaxed_guard_sample))
        relaxed_policy = dataclasses.replace(
            strict, submit_guard_sample=relaxed_sample)
        eng.set_knobs(health=relaxed_policy,
                      staging_stride=lim.staging_stride)
        with self._lock:
            self._relaxed = True
        self._record(
            "health", "strict", "relaxed",
            f"{calm} trip-free windows — submit guard sample -> "
            f"{relaxed_sample}, staging guard 1-in-"
            f"{lim.staging_stride} batches (device verdict still "
            "exact; any trip restores instantly)")

    # -- per-class QoS steering ---------------------------- #

    def _decide_qos(self, eng, d, e) -> None:
        """Steer the two QoS knobs off per-class telemetry windows:

        * SLO pressure: any latency-SLO class whose windowed p99 runs
          inside `headroom` of its SLO for two consecutive ticks means
          bulk work is crowding it out — halve `qos_contention` so the
          fair-share ledger bites earlier; relax it back (x1.5, cap
          0.5) after `relax_health_after` comfortable windows.
        * Batch stretch: batch-tier traffic that still coalesces under
          `coalesce_target` can afford to wait longer — grow the
          `batch` tier delay override; clear it after `unstack_after`
          batch-idle windows.
        """
        qc = eng.counters().get("qos")
        if qc is None:
            return  # no classified traffic yet: nothing to steer
        with self._lock:
            for key in qc.get("classes", {}):
                if key not in self._qos_windows:
                    # same lock shape as attach(): a per-class window
                    # constructed under the controller lock takes the
                    # engine lock once to snapshot
                    self._qos_windows[key] = profiler.StatsWindow(
                        eng, qos_class=key)
            windows = dict(self._qos_windows)
        hot = comfortable = False
        batch_busy = batch_under = False
        slo_by_key = {k: row.get("slo_ms")
                      for k, row in qc.get("classes", {}).items()}
        tier_by_key = {k: row.get("tier")
                       for k, row in qc.get("classes", {}).items()}
        for key, w in windows.items():
            we = w.delta()["engine"]
            slo_ms = slo_by_key.get(key)
            if (slo_ms is not None
                    and we["latency_samples"] >= self.min_window_samples):
                p99 = we["latency_p99_ms"]
                if p99 >= self.headroom * slo_ms:
                    hot = True
                elif p99 < 0.5 * self.headroom * slo_ms:
                    comfortable = True
            if tier_by_key.get(key) == "batch" and we["qos_requests"]:
                batch_busy = True
                if (e["coalesced_mean"]
                        and e["coalesced_mean"] < self.coalesce_target):
                    batch_under = True
        knobs = eng.knobs()
        contention = knobs.get("qos_contention", 0.5)
        tier_delay = knobs.get("qos_tier_delay") or {}
        with self._lock:
            self._qos_hot = self._qos_hot + 1 if hot else 0
            self._qos_calm = (0 if hot or not comfortable
                              else self._qos_calm + 1)
            self._qos_batch_pressure = (
                self._qos_batch_pressure + 1 if batch_under else 0)
            self._qos_batch_idle = (
                0 if batch_busy else self._qos_batch_idle + 1)
            hot_n, calm_n = self._qos_hot, self._qos_calm
            bp, bi = self._qos_batch_pressure, self._qos_batch_idle
        if hot_n >= 2 and contention > 0.1:
            new = max(0.1, 0.5 * contention)
            eng.set_knobs(qos_contention=new)
            self._record(
                "qos_contention", contention, new,
                f"{hot_n} windows with a latency class p99 inside "
                f"{self.headroom:g}x of its SLO — the fair-share "
                "ledger now bites earlier")
            with self._lock:
                self._qos_hot = 0
        elif calm_n >= self.relax_health_after and contention < 0.5:
            new = min(0.5, 1.5 * contention)
            eng.set_knobs(qos_contention=new)
            self._record(
                "qos_contention", contention, new,
                f"{calm_n} comfortable windows — admission pressure "
                "relaxed toward the default")
            with self._lock:
                self._qos_calm = 0
        cur_batch = tier_delay.get("batch")
        if bp >= self.grow_after:
            base = (cur_batch if cur_batch is not None else min(
                eng.max_batch_delay * qos_mod.BATCH_STRETCH,
                qos_mod.MAX_TIER_DELAY))
            new_delay = min(self.limits.max_batch_delay,
                            max(base * self.delay_grow,
                                base + self.delay_floor_step))
            if new_delay > (cur_batch or 0.0):
                eng.set_knobs(qos_tier_delay={"batch": new_delay})
                self._record(
                    "qos_tier_delay[batch]", cur_batch, new_delay,
                    f"{bp} windows of batch-tier traffic coalescing "
                    f"under target {self.coalesce_target:g} — batch "
                    "classes wait longer for fuller devices")
            with self._lock:
                self._qos_batch_pressure = 0
        elif cur_batch is not None and bi >= self.unstack_after:
            eng.set_knobs(qos_tier_delay={"batch": None})
            self._record(
                "qos_tier_delay[batch]", cur_batch, None,
                f"{bi} windows without batch-tier traffic — the "
                "stretch override is retired until it earns its way "
                "back")
            with self._lock:
                self._qos_batch_idle = 0

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Controller counters for `engine.stats()['controller']`:
        ticks taken, decisions made, tick errors, the guard-relaxation
        state, the last telemetry window it acted on, and the tail of
        the decision log."""
        with self._lock:
            return {
                "ticks": self._ticks,
                "decisions": self._decisions,
                "errors": self._errors,
                "relaxed_guards": self._relaxed,
                "drain_rate": self._drain_rate,
                "slo_p99_ms": self.slo_p99_ms,
                "qos_windows": sorted(self._qos_windows),
                "persist": {
                    "enabled": self.persist,
                    "regime": self._regime,
                    "reseeded": dict(self._reseeded),
                } if self.persist else {"enabled": False},
                "last_window": dict(self._last_window),
                "decisions_log": [
                    {"t": t, "knob": k, "old": o, "new": n, "reason": r}
                    for t, k, o, n, r in self._log[-16:]],
            }

    @staticmethod
    def blank_delta(seconds: float = 0.25) -> dict:
        """A zeroed `StatsWindow.delta()`-shaped dict — the test/bench
        harness hook for driving `step()` with synthetic telemetry
        (stub the attached window's `delta` with edits of this)."""
        eng = {k: 0 for k in profiler._ENGINE_COUNTERS}
        eng.update(pending=0, backlog_delta=0, arrival_per_s=0.0,
                   drain_per_s=0.0, coalesced_mean=0.0,
                   factor_coalesced_mean=0.0, latency_samples=0,
                   factor_latency_samples=0)
        for prefix in ("latency", "factor_latency"):
            for pct in (50, 95, 99):
                eng[f"{prefix}_p{pct}_ms"] = 0.0
        return {
            "seconds": seconds,
            "engine": eng,
            "bucket_hits": {},
            "factor_bucket_hits": {},
            "phases": {ph: {"count": 0, "wall_s": 0.0}
                       for ph in profiler.SERVE_PHASES},
            "health": {},
            "tier": {},
            "tier_gauges": {},
        }
