"""Multi-tenant quality of service: SLO classes, weighted fair-share
admission, and per-tenant isolation (the port's own copy of
`conflux_tpu/qos.py`, host code only; the port imports nothing of the JAX
package, so it keeps this copy, and `tests/test_torch_qos.py` runs the
reference's host-only QoS tests over both).

Every request through the serve stack has been equal until now — one
global p99 SLO, one admission policy, per-session breakers as the only
isolation. Production traffic at the ROADMAP's scale is tiered: a
paying tenant's interactive solves must hold a tight latency SLO while
a bulk tenant's offline backfill floods the same engine. This module
is the policy layer that prices that difference on the EXISTING rails:

- :class:`QosClass` — the request tag. `engine.submit(session, b,
  qos=QosClass(tenant="gold", tier="latency", slo=0.025))` classifies
  the request; `qos=None` (the default everywhere) keeps the engine
  byte-identical to the pre-QoS stack — the same opt-in discipline as
  `health=None` and `controller=None`.
- :class:`FairShareLedger` — weighted fair-share admission. Each
  tenant's share of `max_pending` is its declared weight over the sum
  of weights; while the engine is CONTENDED (pending above the
  contention fraction) a tenant at/over its share is shed with a
  structured `resilience.TenantThrottled(retry_after=...)` instead of
  queueing in front of everyone else. Below contention admission is
  work-conserving — an idle engine serves the bulk tenant at full
  rate. The deficit-round-robin credit (one quantum distributed by
  weight as each slot frees) lets a throttled tenant's priority-0
  traffic keep admitting at exactly its weighted fraction of the
  measured drain, so "fair share" holds through sustained overload,
  not just at the shed edge.
- :class:`EngineQosState` — the engine-side container: interned
  classes, the ledger, per-class counters and latency rings, and the
  per-tier collect-delay overrides the controller steers. Created
  lazily on the FIRST classified submission; a `qos=None` engine
  never allocates it.

Priority-aware coalescing rides the existing `DeviceLane` window (no
per-class queues or threads): each queued request resolves a per-class
collect delay — `latency` ~0 (dispatch now), `throughput` the engine
window, `batch` a stretched window that pads buckets full — and the
lane's effective deadline is the MIN over the batch's members
(:func:`collect_delay`). A latency-class arrival therefore pulls the
whole window in; batch traffic alone pads it out.

Wire safety: classes cross the fabric's process boundary as plain
dicts (:meth:`QosClass.to_wire` / :func:`class_from_wire`), so
`ServeFabric.solve(..., qos=...)` carries the class to the owning
host's engine unchanged.

All mutable state in :class:`FairShareLedger` and
:class:`EngineQosState` is guarded by the OWNING ENGINE's `_lock` —
the ledger is consulted inside `ServeEngine._admit` and released in
the settle/fail paths, all already under that lock, so QoS adds zero
new locks (and zero new lock-order edges) to the engine's graph.
"""

from __future__ import annotations

import dataclasses
from collections import deque

# the three service tiers, orderd most to least latency-sensitive; the
# tier picks the request's default collect delay inside the lane window
TIERS = ("latency", "throughput", "batch")

# how far the batch tier stretches the engine's coalescing window by
# default (it exists to pad buckets full, not to answer fast); the
# controller's per-tier override and QosClass.collect_delay both trump
BATCH_STRETCH = 4.0

# bound every per-tier delay (override or stretched default) at the
# same ceiling the adaptive controller's envelope uses
MAX_TIER_DELAY = 0.032

# the canonical fleet request the ledger prices against: one solve
# (factor) of the (32, 256, 256) batched plan the serve docs/benches
# are written around. A request's admission cost is its flop volume
# over this reference, clamped at >= 1.0 so lightweight traffic keeps
# the historical one-slot accounting exactly.
REF_SOLVE_UNITS = 32 * 256 * 256
REF_FACTOR_UNITS = 32 * 256 ** 3


def request_cost(shape, width=None, factor=False) -> float:
    """Byte/flop-aware admission cost of one request, in units of the
    canonical fleet request (clamped >= 1.0).

    `shape` is the plan's key shape — (B, M, N) batched/mesh or (M, N)
    single, with M == N for the square kinds and M > N for tall QR
    least-squares plans (DESIGN §33); `width` the request's RHS width
    (solves); `factor=True` prices the O(M N^2) cold start instead of
    the O(M N w) substitution — both reduce exactly to the former
    N^3 / N^2 w pricing when the plan is square. This is what makes a
    large-N mesh session a HEAVYWEIGHT tenant in the
    :class:`FairShareLedger` (DESIGN §32): one N=4096 mesh solve
    occupies the slots its arithmetic actually displaces, so a flood of
    them sheds at the tenant's share line while lightweight interactive
    traffic keeps admitting — instead of both classes queueing as if
    every request were equal."""
    B = shape[0] if len(shape) == 3 else 1
    M = shape[-2]
    N = shape[-1]
    if factor:
        return max(1.0, B * float(M) * float(N) ** 2 / REF_FACTOR_UNITS)
    w = 1 if width is None else max(1, int(width))
    return max(1.0, B * float(M) * float(N) * w / REF_SOLVE_UNITS)


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One request class: who (tenant), how urgent (tier + priority),
    and against what objective (slo).

    tenant: the isolation domain — quota ledgers, throttle attribution
        and the per-tenant counters all key on it.
    tier: 'latency' (near-zero collect delay), 'throughput' (the
        engine's window), or 'batch' (a stretched window that pads
        buckets full).
    priority: intra-tenant importance, smaller = more important.
        Priority-0 traffic may spend the tenant's deficit-round-robin
        credit while over share; background priorities shed at the
        share line exactly.
    slo: per-class latency objective in SECONDS (None = unmanaged).
        Drives the per-class controller targets and the attainment
        column in `stats()['qos']`.
    weight: the tenant's fair-share weight. A tenant's share of
        `max_pending` is weight over the sum of the weights of every
        tenant the engine has seen (latest declaration wins).
    collect_delay: explicit per-request collect-delay override in
        seconds (None = the tier default).
    """

    tenant: str = "default"
    tier: str = "throughput"
    priority: int = 0
    slo: float | None = None
    weight: float = 1.0
    collect_delay: float | None = None

    def __post_init__(self):
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError("qos tenant must be a non-empty string")
        if "/" in self.tenant:
            raise ValueError("qos tenant must not contain '/' (it is "
                             "the tenant/tier key separator)")
        if self.tier not in TIERS:
            raise ValueError(f"qos tier must be one of {TIERS}, "
                             f"got {self.tier!r}")
        if self.slo is not None and not self.slo > 0:
            raise ValueError("qos slo must be > 0 seconds (or None)")
        if not self.weight > 0:
            raise ValueError("qos weight must be > 0")
        if self.collect_delay is not None and self.collect_delay < 0:
            raise ValueError("qos collect_delay must be >= 0 (or None)")

    @property
    def key(self) -> str:
        """The class identity for counters/windows: 'tenant/tier'."""
        return f"{self.tenant}/{self.tier}"

    def to_wire(self) -> dict:
        """A plain-dict encoding safe to pickle/JSON across the fabric
        RPC boundary."""
        return {"tenant": self.tenant, "tier": self.tier,
                "priority": self.priority, "slo": self.slo,
                "weight": self.weight,
                "collect_delay": self.collect_delay}


def class_from_wire(d) -> "QosClass | None":
    """Rebuild a :class:`QosClass` from :meth:`QosClass.to_wire` output
    (None passes through, so wire call sites need no gate)."""
    if d is None:
        return None
    if isinstance(d, QosClass):
        return d
    return QosClass(
        tenant=str(d.get("tenant", "default")),
        tier=str(d.get("tier", "throughput")),
        priority=int(d.get("priority", 0)),
        slo=d.get("slo"),
        weight=float(d.get("weight", 1.0)),
        collect_delay=d.get("collect_delay"))


def collect_delay(cls: "QosClass | None", engine_delay: float,
                  tier_delay: dict) -> float:
    """The class's collect delay inside the lane window.

    Resolution order: the request's own `collect_delay` override, then
    the controller-steered per-tier override (`tier_delay`), then the
    tier default — latency 0, throughput the engine window, batch the
    engine window stretched `BATCH_STRETCH`x (clamped). A `qos=None`
    request resolves to exactly `engine_delay`, the pre-QoS behavior.
    """
    if cls is None:
        return engine_delay
    if cls.collect_delay is not None:
        return min(cls.collect_delay, MAX_TIER_DELAY)
    o = tier_delay.get(cls.tier)
    if o is not None:
        return min(o, MAX_TIER_DELAY)
    if cls.tier == "latency":
        return 0.0
    if cls.tier == "batch":
        return min(engine_delay * BATCH_STRETCH, MAX_TIER_DELAY)
    return engine_delay


class FairShareLedger:
    """Weighted fair-share admission accounting for one engine.

    Every method REQUIRES the owning engine's `_lock` (the ledger is a
    passive structure consulted from `ServeEngine._admit` and released
    from `ServeEngine._take`, both already inside that lock): no lock
    of its own, no new lock-order edges.

    The model: tenant i declares weight w_i (latest declaration wins);
    its share of the admission bound is `w_i / sum(w) * max_pending`.
    While the engine is UNCONTENDED (total pending below `contention`
    x max_pending) every request admits — fair share must never
    throttle an engine with idle capacity. While contended, a tenant
    at/over its share is shed, EXCEPT that priority-0 requests may
    spend the tenant's deficit credit: each slot released distributes
    one quantum across tenants proportional to weight (capped at
    `deficit_cap` x share), so a flooded tenant's interactive traffic
    keeps admitting at its weighted fraction of the drain rate while
    its background tiers take the throttling.
    """

    def __init__(self, contention: float = 0.5,
                 deficit_cap: float = 0.25):
        if not 0 < contention <= 1:
            raise ValueError("contention must be in (0, 1]")
        self.contention = float(contention)   # under the engine lock
        self.deficit_cap = float(deficit_cap)
        self._weight: dict = {}    # tenant -> weight; under engine._lock
        self._pending: dict = {}   # tenant -> in-flight; under engine._lock
        self._deficit: dict = {}   # tenant -> credit; under engine._lock
        self._admitted: dict = {}  # tenant -> total; under engine._lock
        self._throttled: dict = {}  # tenant -> total; under engine._lock

    def note(self, cls: QosClass) -> None:
        """Fold the class's declared weight in (latest wins)."""
        self._weight[cls.tenant] = cls.weight
        self._pending.setdefault(cls.tenant, 0)

    def share(self, tenant: str, max_pending: int) -> float:
        total = sum(self._weight.values())
        if total <= 0:
            return float(max_pending)
        w = self._weight.get(tenant, 0.0)
        return max(1.0, w / total * max_pending)

    def frac(self, tenant: str) -> float:
        """The tenant's weight fraction (its share of the drain)."""
        total = sum(self._weight.values())
        w = self._weight.get(tenant, 0.0)
        return w / total if total > 0 else 1.0

    def try_admit(self, cls: QosClass, engine_pending: int,
                  max_pending: int, cost: float = 1.0) -> "float | None":
        """Admit (count the slot, return None) or throttle (return the
        tenant's over-share backlog for the retry hint). `cost` is the
        request's admission weight in slots (:func:`request_cost`) —
        the default 1.0 keeps the historical one-request-one-slot
        accounting bitwise."""
        self.note(cls)
        t = cls.tenant
        mine = self._pending.get(t, 0)
        share = self.share(t, max_pending)
        if engine_pending < self.contention * max_pending \
                or mine < share:
            self._pending[t] = mine + cost
            self._admitted[t] = self._admitted.get(t, 0) + 1
            return None
        # contended and at/over share: priority-0 may spend credit
        if cls.priority <= 0 and self._deficit.get(t, 0.0) >= cost:
            self._deficit[t] -= cost
            self._pending[t] = mine + cost
            self._admitted[t] = self._admitted.get(t, 0) + 1
            return None
        self._throttled[t] = self._throttled.get(t, 0) + 1
        return mine - share + cost

    def release(self, cls: QosClass, cost: float = 1.0) -> None:
        """One of the tenant's requests resolved: free its slot(s) and
        distribute the freed quantum by weight (the DRR refill — a
        heavyweight settle frees `cost` slots, so it refills `cost`
        quanta)."""
        t = cls.tenant
        self._pending[t] = max(0.0, self._pending.get(t, 0) - cost)
        total = sum(self._weight.values())
        if total <= 0:
            return
        for tt, w in self._weight.items():
            cap = self.deficit_cap * max(1.0, w / total * 64)
            d = self._deficit.get(tt, 0.0) + cost * w / total
            self._deficit[tt] = min(cap, d)

    def stats(self, max_pending: int) -> dict:
        """Per-tenant ledger rows (shares resolved at the current
        admission bound)."""
        return {t: {"weight": self._weight.get(t, 0.0),
                    "share": round(self.share(t, max_pending), 1),
                    "pending": round(self._pending.get(t, 0), 1),
                    "deficit": round(self._deficit.get(t, 0.0), 2),
                    "admitted": self._admitted.get(t, 0),
                    "throttled": self._throttled.get(t, 0)}
                for t in sorted(self._weight)}


class EngineQosState:
    """The engine-side QoS container, created lazily on the first
    classified submission (`ServeEngine._qos`); a `qos=None` engine
    never allocates one. Every mutable field is guarded by the OWNING
    ENGINE's `_lock` — see the module docstring for why that adds no
    lock-order edges."""

    def __init__(self, latency_window: int = 4096):
        self.ledger = FairShareLedger()
        self.classes: dict = {}     # key -> QosClass; under engine._lock
        self.tier_delay: dict = {}  # tier -> s override; under engine._lock
        self.requests: dict = {}    # key -> int; under engine._lock
        self.completed: dict = {}   # key -> int; under engine._lock
        self.failed: dict = {}      # key -> int; under engine._lock
        self.throttled: dict = {}   # key -> int; under engine._lock
        self.latencies: dict = {}   # key -> deque; under engine._lock
        self.lat_seq: dict = {}     # key -> int; under engine._lock
        self._window = int(latency_window)

    def intern(self, cls: QosClass) -> QosClass:
        """Register the class (latest declaration of a key wins — a
        tenant may re-declare weight/slo) and return it."""
        self.classes[cls.key] = cls
        self.ledger.note(cls)
        if cls.key not in self.latencies:
            self.latencies[cls.key] = deque(maxlen=self._window)
            self.lat_seq[cls.key] = 0
        return cls

    def record_admit(self, cls: QosClass) -> None:
        self.requests[cls.key] = self.requests.get(cls.key, 0) + 1

    def record_throttle(self, cls: QosClass) -> None:
        self.throttled[cls.key] = self.throttled.get(cls.key, 0) + 1

    def record_settle(self, cls: QosClass, latency_s: float,
                      cost: float = 1.0) -> None:
        k = cls.key
        self.completed[k] = self.completed.get(k, 0) + 1
        self.latencies[k].append(latency_s)
        self.lat_seq[k] += 1
        self.ledger.release(cls, cost)

    def record_fail(self, cls: QosClass, cost: float = 1.0) -> None:
        self.failed[cls.key] = self.failed.get(cls.key, 0) + 1
        self.ledger.release(cls, cost)

    def counters(self, max_pending: int) -> dict:
        """The sort-free counter rows for `engine.counters()['qos']`."""
        rows = {}
        for k, cls in self.classes.items():
            rows[k] = {
                "tenant": cls.tenant, "tier": cls.tier,
                "priority": cls.priority, "weight": cls.weight,
                "slo_ms": (None if cls.slo is None
                           else 1e3 * cls.slo),
                "requests": self.requests.get(k, 0),
                "completed": self.completed.get(k, 0),
                "failed": self.failed.get(k, 0),
                "throttled": self.throttled.get(k, 0),
            }
        return {"classes": rows,
                "tenants": self.ledger.stats(max_pending),
                "contention": self.ledger.contention,
                "tier_delay": dict(self.tier_delay)}

    def stats(self, max_pending: int) -> dict:
        """`counters()` plus per-class latency percentiles and SLO
        attainment over the rolling rings (the `stats()['qos']` shape).
        """
        from conflux_tpu_torch.engine import _percentile

        out = self.counters(max_pending)
        for k, row in out["classes"].items():
            xs = sorted(self.latencies.get(k, ()))
            row["latency_samples"] = len(xs)
            for pct in (50, 95, 99):
                row[f"latency_p{pct}_ms"] = (
                    1e3 * _percentile(xs, pct) if xs else 0.0)
            cls = self.classes[k]
            if cls.slo is not None and xs:
                within = sum(1 for x in xs if x <= cls.slo)
                row["slo_attainment_pct"] = round(
                    100.0 * within / len(xs), 2)
        return out
