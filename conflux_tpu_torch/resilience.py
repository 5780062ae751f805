"""Serve-path resilience: health guards, escalation, quarantine, faults
(the port's own copy of `conflux_tpu/resilience.py`, which imports no JAX;
the port keeps a copy so that it imports nothing of the JAX package).

The one change: a verdict or an answer may be a CUDA tensor, so
:func:`evaluate`, :func:`evaluate_slots` and the escalation rungs read it
through :func:`_host` (one device-to-host copy, the one host sync of the
failure path, where the JAX package calls `np.asarray`), and
:func:`escalate_precision` drives the port's `serve`.

The serving stack (`FactorPlan`/`SolveSession`/`ServeEngine`) is fast but
trusting: one NaN/Inf RHS host-staged into a coalesced batch silently
corrupts every co-batched answer, an ill-conditioned SMW-drifted session
returns garbage with no residual check, a queued request has no deadline
(an abandoned `result(timeout)` still burns its `max_pending` slot), and
a dead dispatcher thread queues work forever. This module holds the
host-side resilience machinery the engine wires through those layers:

- :class:`HealthPolicy` — the knobs: RHS finite guards at admission and
  staging (blast-radius isolation: a poisoned request fails its OWN
  future, never the batch), the fused finite/spot-residual output check
  (`update.health_spot_check`, fused INTO the solve program
  so the clean path pays no extra dispatch), the escalation ladder
  budget, and the quarantine circuit breaker.

- :func:`escalate` — the ladder run when a dispatched solve fails its
  health check: (1) one forced refactorization through the plan's CACHED
  factor program (`SolveSession.refactor` — absorbs any SMW drift, the
  usual culprit), (2) one round of iterative refinement riding the
  resident factors (`SolveSession.refine_checked`), (3) a structured
  :class:`SolveUnhealthy` carrying the residual/cond evidence of every
  rung. Rare by construction, so it may block (the engine runs it on the
  drain thread).

- :class:`CircuitBreaker` — per-session quarantine: after
  `quarantine_after` consecutive ladder failures the session fast-fails
  (:class:`SessionQuarantined`) instead of burning whole batches on a
  sick system; after `quarantine_cooldown` seconds ONE probe request is
  let through (half-open) and a healthy answer closes the circuit.

- :class:`FaultPlan` — deterministic, seeded fault injection for tests
  and the chaos soak (`scripts/soak.py --serve`): NaN at staging,
  delay/crash/kill at the named engine sites (dispatch, drain, d2h,
  refresh), forced-unhealthy verdicts at the solve check. The engine and
  `SolveSession._refactor` consult the installed plan at each site;
  production code never pays more than a None check.

Every outcome — guard trips, isolations, retries, refactor/refine
escalations, evictions, quarantine transitions, watchdog trips, injected
faults — is counted here and surfaces through
`profiler.serve_stats()['health']` so reliability is one coherent,
observable surface next to the throughput counters.
"""

from __future__ import annotations

import cmath
import dataclasses
import math
import threading
import time

import numpy as np

# --------------------------------------------------------------------------- #
# structured failures
# --------------------------------------------------------------------------- #


class RhsNonFinite(ValueError):
    """A request's RHS carries NaN/Inf — rejected at admission or
    isolated at staging so it never contaminates a coalesced batch."""


class MeshPlanUnsupported(ValueError):
    """A mesh-sharded (batch-sharded) plan hit one of the GENUINE
    residue surfaces — operations whose semantics contradict sharded
    state, not missing plumbing (DESIGN §32). The serve stack itself
    (factor lane, coalescing, tiering, checkpoint, QoS, fabric) serves
    mesh plans directly; what remains is migration: pinning sharded
    state onto one device (``device=`` naming a device OUTSIDE the
    plan's mesh, ``to_device``) and restoring a sharded checkpoint on
    a host that lacks the mesh's devices (cross-host migration).
    Structured (a ValueError subclass, so legacy string-matching
    callers keep working) so callers can route programmatically: the
    fix is a topology fix — drop the pin or restore on a matching
    host — not a fallback code path. Every raise is counted in
    ``profiler.serve_stats()['health']['mesh_plan_unsupported']``
    (zero on a healthy mesh trace, asserted by ``bench_engine
    --mesh``). `surface` names the rejecting surface (e.g.
    'factor_lane', 'factor', 'to_device', 'plan_codec')."""

    def __init__(self, msg: str, surface: str = ""):
        super().__init__(msg)
        self.surface = surface
        bump("mesh_plan_unsupported")


class HostUnavailable(RuntimeError):
    """A fabric request targeted an engine host that cannot answer —
    its process died mid-flight, its heartbeat lease lapsed (suspect or
    dead), its circuit breaker is open after repeated transport
    failures, or its sessions are mid-fail-over onto survivors. The
    request NEVER hangs: in-flight futures on a declared-dead host fail
    with this error the moment the fabric declares it. `retry_after`
    rides the fabric's measured signals (the PR 8 pattern): during
    fail-over it is the measured per-session revival rate times the
    sessions still queued, otherwise the heartbeat/breaker window that
    must elapse before the host can be trusted again. `host` names the
    unavailable host id. Counted in
    ``profiler.serve_stats()['health']['host_unavailable']``."""

    def __init__(self, msg: str, retry_after: float = 0.0,
                 host: str | None = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.host = host
        bump("host_unavailable")


class FleetDegraded(RuntimeError):
    """Fabric admission refused: fewer than `min_live` engine hosts are
    alive, so the fabric is running in degraded mode — existing
    sessions on live hosts keep answering, but NEW session opens (and,
    below quorum, all traffic) are shed until capacity recovers.
    `retry_after` hints when the next heartbeat round could restore a
    suspect host or finish a fail-over; `live`/`total` carry the
    observed host census. Counted in
    ``profiler.serve_stats()['health']['fleet_degraded']``."""

    def __init__(self, msg: str, retry_after: float = 0.0,
                 live: int = 0, total: int = 0):
        super().__init__(msg)
        self.retry_after = retry_after
        self.live = live
        self.total = total
        bump("fleet_degraded")


class WireCorrupt(ConnectionError):
    """A shared-memory wire segment failed its integrity check
    (DESIGN §31): a reply/request record's generation tag does not
    match its descriptor (a SIGKILL mid-write left a torn record, or a
    stale descriptor points at a recycled slot), or the descriptor
    names bytes outside the segment (overrun). Deliberately a
    ConnectionError subclass — the payload channel to that host can no
    longer be trusted, so the front treats it exactly like a torn
    pipe: the host is declared structurally dead on the spot, every
    pending reply future fails instantly (never a hang), and fail-over
    revives its sessions from the last checkpoint. That condemnation
    applies to REPLY-side corruption (the front's decode); a corrupt
    REQUEST record detected worker-side instead fails only its own
    item — shipped back as a structured error the front rehydrates to
    this type — because the front wrote that record and its
    frame-mates validated fine, so the channel itself is still
    trusted. `kind` is one of 'torn_segment' | 'stale_generation' |
    'overrun'; `host` names the host whose wire tore. Counted in
    ``profiler.serve_stats()['health']['wire_corrupt']``."""

    def __init__(self, msg: str, kind: str = "torn_segment",
                 host: str | None = None):
        super().__init__(msg)
        self.kind = kind
        self.host = host
        bump("wire_corrupt")
        bump(f"wire_corrupt[{kind}]")


class TenantThrottled(RuntimeError):
    """Weighted fair-share admission shed this tenant's request: the
    engine is contended and the tenant is at/over its declared share of
    `max_pending` with no deficit credit left (DESIGN §30). The shed is
    a POLICY outcome, not a failure — other tenants' traffic (and the
    latency class in particular) is admitted untouched, which is the
    point. `retry_after` is sized from the tenant's weighted fraction
    of the engine's measured drain rate: by then roughly one of the
    tenant's own slots should have freed. `tenant`/`qos_class` carry
    the shed attribution (`qos_class` is the 'tenant/tier' key).
    Counted globally in
    ``profiler.serve_stats()['health']['tenant_throttled']`` and
    per class under ``tenant_throttled[<tenant>/<tier>]``."""

    def __init__(self, msg: str, retry_after: float = 0.0,
                 tenant: str | None = None,
                 qos_class: str | None = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.tenant = tenant
        self.qos_class = qos_class
        bump("tenant_throttled")
        if qos_class is not None:
            bump(f"tenant_throttled[{qos_class}]")


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed while it was queued; its pending
    slot has been released (lazy eviction, `ServeEngine.submit`)."""


class SessionQuarantined(RuntimeError):
    """The session's circuit breaker is open after repeated escalation
    failures: fast-fail instead of burning another batch. `retry_after`
    hints when the half-open probe window opens."""

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


class SolveUnhealthy(RuntimeError):
    """A dispatched solve failed its health check and the whole
    escalation ladder (forced refactor, then iterative refinement) could
    not recover it. `evidence` carries the per-rung verdicts:
    {'rungs': [{'rung', 'finite', 'residual'}...], 'residual_limit',
    'cond', 'update_rank', 'refactors'}."""

    def __init__(self, msg: str, evidence: dict):
        super().__init__(msg)
        self.evidence = evidence


class SessionSpilled(RuntimeError):
    """A request touched a spilled (host/disk-tier) session whose
    revival could not run — the revive lane's admission timed out, the
    request's deadline expired while the session was faulting in, or no
    residency manager is attached. The session's spill record is INTACT
    and it stays fully spilled (never half-resident): a later request
    revives it normally. `retry_after` hints when a revive slot should
    free up (0.0 = unknown)."""

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


class RestoreCorrupt(RuntimeError):
    """A spill/checkpoint record failed its integrity check on read
    (CRC mismatch, truncated leaf, undecodable manifest). Blast radius
    is the OWNING session only: its requests fail with this error and
    every other session — co-batched or not — is untouched. `evidence`
    carries {'path', 'leaf', 'expected_crc', 'got_crc'} (fields absent
    when the manifest itself was unreadable)."""

    def __init__(self, msg: str, evidence: dict | None = None):
        super().__init__(msg)
        self.evidence = {} if evidence is None else evidence


class InjectedFault(RuntimeError):
    """Raised by a FaultPlan 'crash' spec at an instrumented site —
    never by production code. Engine per-item handling catches it like
    any other failure (the worker thread survives)."""


class InjectedKill(BaseException):
    """A FaultPlan 'kill' spec: simulates a worker thread dying.
    BaseException on purpose — it sails through the engine's per-item
    `except Exception` handling and out of the worker loop, exercising
    the watchdog path."""


# --------------------------------------------------------------------------- #
# health counters (merged into profiler.serve_stats()['health'])
# --------------------------------------------------------------------------- #

_HEALTH_KEYS = (
    "rhs_rejects",            # submit()-time finite-guard trips
    "staging_isolations",     # poisoned requests failed alone at staging
    "output_failures",        # dispatched solves that failed the check
    "gang_unhealthy_slots",   # gang-stacked slots failing their per-slot
                              # verdict (requests re-dispatched solo)
    "survivor_redispatches",  # innocent requests re-dispatched solo
    "factor_rejects",         # submit_factor()-time A finite-guard trips
    "factor_isolations",      # poisoned A matrices failed alone at staging
    "factor_unhealthy",       # coalesced factorizations failing the verdict
    "refactor_escalations",   # ladder rung 1 runs
    "refine_escalations",     # ladder rung 2 runs
    "unhealthy",              # SolveUnhealthy raised (ladder exhausted)
    "evictions",              # deadline evictions
    "cond_refactors",         # DriftPolicy cond-limit guard trips
    "quarantine_opened",
    "quarantine_probes",
    "quarantine_recoveries",
    "watchdog_trips",
    "lane_revives",           # per-lane watchdog trips that respawned a lane
    "mesh_plan_unsupported",  # MeshPlanUnsupported raised (mesh plan routed
                              # at an unsharded-only serving surface)
    # the multi-host serve fabric (DESIGN §28)
    "host_unavailable",       # HostUnavailable raised (dead/suspect host,
                              # open breaker, or mid-fail-over routing)
    "fleet_degraded",         # FleetDegraded raised (admission below the
                              # live-host quorum)
    "heartbeat_misses",       # heartbeat probes that timed out / errored
    "hosts_suspected",        # alive -> suspect transitions
    "hosts_died",             # suspect/alive -> dead declarations
    "host_failovers",         # fail-over drills run (one per dead host)
    "sessions_failed_over",   # sessions revived on survivors from the
                              # dead host's last checkpoint
    "sessions_migrated",      # live drain-barrier session hand-offs
    # the zero-copy shm wire (DESIGN §31)
    "wire_corrupt",           # WireCorrupt raised (torn/stale/overrun
                              # ring record — host declared dead)
    "wire_ring_full",         # shm ring allocations refused (backpressure
                              # shed with a measured-drain retry hint)
    "wire_pickle_fallbacks",  # payloads that rode the pickle wire because
                              # they did not fit / the ring was saturated
    # multi-tenant QoS (DESIGN §30): fair-share admission sheds. The
    # per-class attributions ride lazy keys — tenant_throttled[t/tier]
    # and engine_saturated[t/tier] — next to these global totals
    "tenant_throttled",       # TenantThrottled raised (over-share tenant
                              # shed while the engine was contended)
    "faults_injected",
)

_HEALTH_LOCK = threading.Lock()
_HEALTH: dict[str, int] = {k: 0 for k in _HEALTH_KEYS}  # guarded-by: _HEALTH_LOCK


def bump(key: str, n: int = 1) -> None:
    """Count one health outcome (unknown keys appear lazily)."""
    with _HEALTH_LOCK:
        _HEALTH[key] = _HEALTH.get(key, 0) + n


def health_stats() -> dict:
    """Snapshot of the resilience counters (profiler.serve_stats()
    exposes this as the 'health' sub-dict)."""
    with _HEALTH_LOCK:
        return dict(_HEALTH)


def clear_health() -> None:
    """Reset the counters (profiler.clear() calls this too)."""
    with _HEALTH_LOCK:
        for k in list(_HEALTH):
            _HEALTH[k] = 0


# --------------------------------------------------------------------------- #
# the policy
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """What the engine guards, and how hard it fights before giving up.

    check_rhs: finite-guard every request's RHS at `submit()` (raises
        :class:`RhsNonFinite` synchronously) and AGAIN at staging (a
        request poisoned after admission fails its own future and is
        excluded from the staged buffer — blast-radius isolation).
    check_output: run the fused finite/spot-residual check on every
        dispatched solve (`SolveSession.solve_checked`). The check rides
        the SAME compiled program as the solve — zero extra dispatches —
        and its verdict crosses to the host with the drain thread's
        existing copy.
    submit_guard_sample: elements of each request's RHS the submit-time
        guard scans (None = exact, every element). The default samples:
        the staging guard re-checks the whole coalesced buffer exactly
        (amortized to one summation per BATCH) and the device-side
        finite verdict is exact for free, so sampling at submit only
        moves where a sparse poison is reported, never whether.
    residual_limit: relative-residual trip wire for the spot check
        (column 0 of the staged buffer, the systemic sentinel — see
        `update.health_spot_check`). None resolves per dtype/N via
        :meth:`resolved_residual_limit`; for bf16 the resolved limit is
        so loose the finite check is effectively the only output guard.
    max_refactor_retries / max_refine_retries: escalation-ladder budget
        (rung 1: forced refactor through the cached factor program;
        rung 2: one iterative-refinement sweep each).
    quarantine_after: consecutive ladder failures before the session's
        circuit breaker opens (fast-fail with
        :class:`SessionQuarantined`).
    quarantine_cooldown: seconds the breaker stays open before admitting
        ONE half-open probe request.
    """

    check_rhs: bool = True
    check_output: bool = True
    submit_guard_sample: int | None = 4096
    residual_limit: float | None = None
    max_refactor_retries: int = 1
    max_refine_retries: int = 1
    quarantine_after: int = 3
    quarantine_cooldown: float = 5.0

    def resolved_residual_limit(self, dtype, n: int) -> float:
        """1e4 * eps(dtype) * sqrt(N): loose enough that the 'inv'
        substitution engine's cond(L)cond(U)-scaled residuals never trip
        it on healthy traffic, tight enough to catch the O(1) garbage an
        ill-conditioned SMW correction or corrupted factor produces."""
        if self.residual_limit is not None:
            return float(self.residual_limit)
        eps = float(np.finfo(np.dtype(dtype)).eps) \
            if np.dtype(dtype).kind in "fc" else 1e-7
        return 1e4 * eps * math.sqrt(max(1, n))


def rhs_finite(b2: np.ndarray, sample: int | None = None) -> bool:
    """Host-side finite guard. Exact mode (sample=None) is one
    vectorized native-dtype summation instead of `isfinite().all()`:
    NaN/Inf anywhere poisons the accumulator (opposite-sign infinities
    meet as NaN), there is no bool temporary, and a non-finite verdict
    is confirmed with the exact scan so (rare) accumulator overflow of
    legitimate huge-magnitude data can never cause a false reject.

    `sample=k` checks only the first k elements — the SUBMIT guard's
    mode: at production request sizes an exact per-request pass re-reads
    every byte a second time and alone eats most of the <5% clean-path
    overhead budget (BENCH_RESILIENCE.json). The sampled check still
    rejects wholesale-poisoned requests synchronously; anything that
    slips it is caught EXACTLY by the per-batch staging guard (one
    amortized summation of the coalesced buffer, culprits isolated to
    their own futures) and by the device-side finite verdict, which
    costs nothing extra. Detection is never lost — only the reporting
    point moves."""
    kind = b2.dtype.kind
    if kind not in "fc":
        return True
    v = b2 if sample is None else b2.ravel()[:sample]
    # one SIMD summation, read with C-level isfinite — no ufunc round
    # trips, no temporaries
    if kind == "f":
        if math.isfinite(v.sum()):
            return True
    elif cmath.isfinite(complex(v.sum())):
        return True
    # non-finite sum: real poison, or accumulator overflow — confirm
    # exactly, so the full scan only ever runs on suspicion
    with np.errstate(invalid="ignore", over="ignore"):
        return bool(np.isfinite(v).all())


# --------------------------------------------------------------------------- #
# circuit breaker (session quarantine)
# --------------------------------------------------------------------------- #


class CircuitBreaker:
    """Closed → (K consecutive failures) → open → (cooldown) → half-open
    probe → closed again on a healthy answer, re-open on a sick one.

    `clock` is injectable for deterministic tests. Thread-safe: `allow`
    consumes the single half-open probe slot atomically; a probe that
    never resolves (evicted, engine died) re-arms after another
    cooldown instead of wedging the breaker half-open forever.
    """

    def __init__(self, threshold: int = 3, cooldown: float = 5.0,
                 clock=time.monotonic):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0     # guarded-by: _lock
        self._state = "closed"  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        # clock() of the outstanding half-open probe
        self._probe_at = None  # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> tuple[bool, float]:
        """(admit?, retry_after). Open circuits refuse until the cooldown
        elapses, then admit exactly one probe per cooldown window."""
        with self._lock:
            if self._state == "closed":
                return True, 0.0
            now = self._clock()
            since = now - (self._probe_at if self._state == "half-open"
                           else self._opened_at)
            if since >= self.cooldown:
                self._state = "half-open"
                self._probe_at = now
                bump("quarantine_probes")
                return True, 0.0
            return False, self.cooldown - since

    def record_success(self) -> None:
        with self._lock:
            if self._state != "closed":
                self._state = "closed"
                self._probe_at = None
                bump("quarantine_recoveries")
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half-open":  # sick probe: straight back open
                self._state = "open"
                self._opened_at = self._clock()
                self._probe_at = None
                return
            self._failures += 1
            if self._state == "closed" and self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = self._clock()
                bump("quarantine_opened")


_ATTACH_LOCK = threading.Lock()


def breaker_for(session, policy: HealthPolicy,
                clock=time.monotonic) -> CircuitBreaker:
    """Get-or-attach the session's breaker (sessions outlive engines, so
    the breaker lives on the session; first policy to touch it wins)."""
    br = session._breaker
    if br is None:
        with _ATTACH_LOCK:
            br = session._breaker
            if br is None:
                br = CircuitBreaker(policy.quarantine_after,
                                    policy.quarantine_cooldown, clock)
                session._breaker = br
    return br


# --------------------------------------------------------------------------- #
# deterministic fault injection
# --------------------------------------------------------------------------- #

FAULT_SITES = ("staging", "dispatch", "drain", "d2h", "solve", "refresh",
               "factor", "spill", "revive", "disk_write", "disk_read",
               "heartbeat", "route", "migrate", "host_kill",
               # the shm wire (DESIGN §31): alloc refusal + reader-side
               # integrity trips, injected in conflux_tpu/wire.py
               "ring_full", "torn_segment", "stale_generation",
               # the elastic fabric (DESIGN §34): 'replicate' fires on the
               # front's per-standby replica push (kinds 'crash'/'delay' —
               # a failed push leaves the standby one generation stale,
               # which the gen-coherence rule then refuses at fail-over;
               # the drain storm itself is exercised via 'migrate', whose
               # barrier remove_host rides unchanged).
               "replicate")
FAULT_KINDS = ("nan", "delay", "crash", "kill", "unhealthy")


@dataclasses.dataclass
class FaultSpec:
    """One injection rule. Sites: 'staging' (kind 'nan' poisons a
    request's staged RHS), 'dispatch'/'drain'/'d2h'/'refresh' (kinds
    'delay'/'crash'/'kill'), 'solve' (kind 'unhealthy' forces the health
    verdict false), 'factor' (the cold-start lane: kind 'nan' poisons a
    factor request's staged A matrix upstream of the staging guard,
    kind 'unhealthy' forces the post-factor verdict false). The tier
    layer (`conflux_tpu.tier`) adds 'spill'/'revive' (kinds
    'delay'/'crash'/'kill' — a crash at spill leaves the session
    resident, a crash at revive leaves it fully spilled, record intact)
    and 'disk_write'/'disk_read' ('delay'/'crash' plus, at disk_write,
    kind 'nan': corrupt the written record's bytes so the next revive
    fails its CRC with :class:`RestoreCorrupt`). 'crash'
    raises :class:`InjectedFault` where the
    engine's per-item handling catches it (survivor re-dispatch / batch
    failure, thread survives); 'kill' escapes the loop entirely so the
    watchdog path runs. `prob` draws from the plan's seeded stream;
    `count` bounds total injections (None = unlimited)."""

    site: str
    kind: str
    prob: float = 1.0
    delay_s: float = 0.0
    count: int | None = None
    # The fabric layer (`conflux_tpu.fabric`, DESIGN §28) adds
    # 'heartbeat' (kinds 'delay'/'crash' — a slow or failed probe, the
    # hysteresis driver), 'route' (kinds 'crash'/'delay' on the front's
    # per-request host call), 'migrate' (kinds 'crash'/'delay' at the
    # hand-off barrier: a crash before the target adopts leaves the
    # session intact on the source) and 'host_kill' (kind 'kill': the
    # whole engine host dies, exercising detection + fail-over).

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"({'|'.join(FAULT_SITES)})")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"({'|'.join(FAULT_KINDS)})")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules. `fire(site, kinds)`
    consults the rules in order and returns the first that triggers
    (consuming its budget); with `prob=1.0` / `count` specs the firing
    sequence is fully deterministic, which is what the regression tests
    pin. `injected` records every firing as {(site, kind): n}."""

    def __init__(self, specs, seed: int = 0):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.injected: dict[tuple[str, str], int] = {}  # guarded-by: _lock

    def fire(self, site: str, kinds=None) -> FaultSpec | None:
        with self._lock:
            for s in self.specs:
                if s.site != site:
                    continue
                if kinds is not None and s.kind not in kinds:
                    continue
                if s.count is not None and s.count <= 0:
                    continue
                if s.prob < 1.0 and self._rng.random() >= s.prob:
                    continue
                if s.count is not None:
                    s.count -= 1
                key = (s.site, s.kind)
                self.injected[key] = self.injected.get(key, 0) + 1
                bump("faults_injected")
                return s
        return None


# one process-wide installed plan: sites outside the engine (the serve
# layer's refactor/refresh path) consult this; the engine prefers its own
# `fault_plan=` and falls back here
_ACTIVE_FAULTS: FaultPlan | None = None


def install_faults(plan: FaultPlan | None) -> None:
    """Install (or clear, with None) the process-wide fault plan."""
    global _ACTIVE_FAULTS
    _ACTIVE_FAULTS = plan


def active_faults() -> FaultPlan | None:
    return _ACTIVE_FAULTS


def maybe_fault(plan: FaultPlan | None, site: str) -> None:
    """Run the delay/crash/kill faults of `site` (engine plan first,
    then the installed one). No-op — one None check — without a plan."""
    p = plan if plan is not None else _ACTIVE_FAULTS
    if p is None:
        return
    s = p.fire(site, kinds=("delay", "crash", "kill"))
    if s is None:
        return
    if s.kind == "delay":
        time.sleep(s.delay_s)
        return
    if s.kind == "kill":
        raise InjectedKill(f"injected kill at {site}")
    raise InjectedFault(f"injected crash at {site}")


def data_fault(plan: FaultPlan | None, site: str, kind: str) -> FaultSpec | None:
    """Fire a data-shaped fault ('nan' at staging, 'unhealthy' at solve)
    without raising — the caller applies the corruption."""
    p = plan if plan is not None else _ACTIVE_FAULTS
    if p is None:
        return None
    return p.fire(site, kinds=(kind,))


# --------------------------------------------------------------------------- #
# the escalation ladder
# --------------------------------------------------------------------------- #


def _host(x) -> np.ndarray:
    """x as a host numpy array: a tensor (on the card or the CPU) is
    copied to the host, which waits for the work that produces it."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def evaluate(verdict, limit: float) -> tuple[bool, bool, float]:
    """Host-side read of a checked solve's (2,) verdict array
    [finite_flag, spot_residual]: (healthy, finite, residual)."""
    v = _host(verdict)
    finite = bool(v[0] >= 0.5)
    res = float(v[1])
    return finite and res <= limit, finite, res


def evaluate_slots(verdict, limit: float) -> list[tuple[bool, bool, float]]:
    """Host-side read of a per-slot (2, S) verdict block — row 0 the
    per-slot finite flags, row 1 the per-slot probe residuals. Three
    device-side producers emit this contract and are indistinguishable
    here by design: the factor lane's checked program
    (`FactorPlan._factor_health_fn` — vmapped probe solve, or the §27
    fused stats epilogue, or the §29 Pallas factor kernel with the
    in-kernel probe row) and the gang's stacked solve verdicts
    (`update.health_spot_check_slots` / `health_verdict_from_stats_slots`).
    Returns one (healthy, finite, residual) triple per slot so the
    drain thread can settle the healthy sessions and isolate the sick
    ones individually (slot verdicts are independent by construction).
    A NaN residual (non-finite factors poison their own probe solve)
    compares unhealthy through the same `res <= limit` predicate
    `evaluate` uses; the slot sweep is vectorized — one bulk comparison,
    not S python reads — because a 32-wide factor drain runs this on
    every coalesced dispatch."""
    v = _host(verdict)
    finite = v[0] >= 0.5
    res = v[1].astype(float)
    with np.errstate(invalid="ignore"):
        healthy = finite & (res <= limit)
    return [(bool(healthy[i]), bool(finite[i]), float(res[i]))
            for i in range(v.shape[-1])]


def escalate(session, buf, policy: HealthPolicy, limit: float,
             evidence0: dict | None = None, faults: FaultPlan | None = None):
    """Fight for one staged chunk `buf` (numpy, already bucket-width)
    whose first answer failed the health check. Returns the recovered
    HOST answer array; raises :class:`SolveUnhealthy` with the full
    per-rung evidence when the ladder is exhausted.

    Rung 1 (x max_refactor_retries): force one true refactorization
    through the plan's CACHED factor program — absorbs any accumulated
    SMW drift (the usual systemic culprit) — and re-solve checked.
    Rung 2 (x max_refine_retries): one iterative-refinement sweep
    against the refreshed base factors. Both rungs re-run the fused
    check; a finite=False answer skips refinement (NaN cannot be
    refined away). Runs under the session's lock so a concurrent
    dispatcher never observes half-swapped factors. Blocking is fine:
    this is the failure path.

    `evidence0` seeds the per-rung evidence chain: one dict (the
    failed dispatch) or a list of dicts (a precision ladder that
    already climbed, :func:`escalate_precision`).
    """
    if evidence0 is None:
        rungs: list[dict] = []
    elif isinstance(evidence0, dict):
        rungs = [dict(evidence0)]
    else:
        rungs = [dict(r) for r in evidence0]

    def check(verdict, rung):
        ok, finite, res = evaluate(verdict, limit)
        # the 'solve' fault site covers every health verdict, ladder
        # rungs included — how the chaos tests force a full-ladder loss
        if data_fault(faults, "solve", "unhealthy") is not None:
            ok = False
        rungs.append({"rung": rung, "finite": finite, "residual": res})
        return ok

    x = None
    with session._lock:
        for _ in range(policy.max_refactor_retries):
            bump("refactor_escalations")
            session.refactor()
            x, verdict = session.solve_checked(buf)
            if check(verdict, "refactor"):
                return _host(x)
        for _ in range(policy.max_refine_retries):
            if x is None or not rungs[-1]["finite"]:
                break
            bump("refine_escalations")
            x, verdict = session.refine_checked(buf, x)
            if check(verdict, "refine"):
                return _host(x)
    bump("unhealthy")
    evidence = {
        "rungs": rungs,
        "residual_limit": limit,
        "cond": session.last_cond,
        "update_rank": session.update_rank,
        "refactors": session.refactors,
    }
    raise SolveUnhealthy(
        f"solve unhealthy after {len(rungs)} rung(s): "
        + "; ".join(f"{r.get('rung', 'dispatch')}: finite={r['finite']} "
                    f"res={r['residual']:.3e}" for r in rungs)
        + f" (limit {limit:.3e})", evidence)


def escalate_precision(session, buf, precision, policy, limit,
                       evidence0: dict | None = None,
                       faults: FaultPlan | None = None):
    """The precision ladder's escalation rungs (DESIGN §33): fight for
    one staged chunk whose TIER-routed answer failed the §20 verdict by
    re-solving checked at each HIGHER served tier first — cheap rungs
    (a derived factor set + one substitution per tier, no refactor) —
    and only when the ladder tops out falling through to the native
    :func:`escalate` rungs (refactor + refine), carrying the
    accumulated per-rung evidence.

    'auto' requests additionally RATCHET the session's sticky rung
    (`SolveSession._auto_rung`), so a session that needed f32 once
    starts there on its next auto request instead of re-failing bf16.
    Explicit-tier requests climb without moving the rung (the caller
    asked for that tier; the ladder is the rescue, not the new
    default). `policy` may be None (an unguarded engine serving 'auto'
    traffic) — the native rungs then run under the default
    :class:`HealthPolicy`."""
    from conflux_tpu_torch import serve

    rungs: list[dict] = [] if evidence0 is None else [dict(evidence0)]
    x = None
    with session._lock:
        tier = session._resolve_tier(precision)
        while tier is not None:
            nxt = serve.next_precision_tier(tier)
            if nxt is None:
                break
            bump("precision_escalations")
            session.precision_escalations += 1
            if precision == "auto":
                rung = serve.PRECISION_TIERS.index(nxt)
                if rung > session._auto_rung:
                    session._auto_rung = rung
                    # the persisted auto-rung changed: the session is
                    # checkpoint-dirty even though this is a solve path
                    session._ckpt_ver += 1
            x, verdict = session.solve_checked(buf, precision=nxt)
            ok, finite, res = evaluate(verdict, limit)
            if data_fault(faults, "solve", "unhealthy") is not None:
                ok = False
            rungs.append({"rung": f"precision:{nxt}", "finite": finite,
                          "residual": res})
            if ok:
                return _host(x)
            tier = nxt
    return escalate(session, buf,
                    policy if policy is not None else HealthPolicy(),
                    limit, evidence0=rungs, faults=faults)
