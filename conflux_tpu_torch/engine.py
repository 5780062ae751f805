"""Async serve engine on one card: request coalescing, double-buffered
dispatch, plan prewarming, admission control, QoS and the serve-path
resilience layer (the port of `conflux_tpu/engine.py`, one lane).

A `SolveSession` makes one session fast, but every call is synchronous and
per request: a fleet of sessions under open-loop traffic would launch one
device program per request and leave the card idle between host round
trips. :class:`ServeEngine` trades a little buffering for fewer, larger
device operations:

- **Coalescing**: requests that arrive within a ``max_batch_delay`` window
  are grouped. Requests against the same session concatenate their RHS
  columns into one wider substitution, one K3 launch per chunk
  (`hopper_kernels.btrsm_pair`). K3 computes each column independently of
  the launch's width, so on the card a coalesced answer is bitwise the
  direct ``session.solve`` answer, for single-system and batched plans
  alike. With ``stack_sessions=True``, requests against different
  sessions of one single-system plan also ride one dispatch off a
  device-resident gang (`gang.SessionGang`): one K3 launch over the
  resident stack, drifted sessions through the stacked Woodbury
  correction, checked engines with a verdict per slot.

- **Double-buffered async dispatch**: a dispatcher thread stages and
  dispatches batch i+1 while a drain thread waits for batch i; the
  handoff queue holds two batches, so host staging overlaps device work
  without unbounded work in flight. On the card the dispatcher queues
  everything on the lane's own CUDA stream (the current stream is per
  thread in torch, and the kernels launch on it) and never waits for the
  card: RHS buffers are staged in pinned host memory and copied with
  ``non_blocking=True``, answers and verdicts come back by non-blocking
  copies into pinned host buffers of their own, and a CUDA event marks
  the batch. Only the drain thread waits, on that event.

- **A factor lane (coalesced cold start)**: :meth:`ServeEngine.
  submit_factor` queues factorizations; same-plan requests in one window
  factor in one stacked dispatch at a power-of-two batch bucket (one K4
  launch for an LU plan, one K5 launch for an SPD plan; pad slots carry
  identity matrices), and the drain slices the stack into independent
  sessions. ``plan.factor`` rides bucket 1 of the same program family and
  the kernels' slots do not depend on the bucket, so an engine-factored
  session is bitwise a ``plan.factor`` session. With a health policy every
  slot carries its own post-factor verdict; a sick slot re-dispatches
  solo and fails alone with structured evidence.

- **Prewarming and admission control**: :meth:`ServeEngine.prewarm`
  runs one warm-up dispatch per declared bucket before traffic lands: it
  pays the kernels' first-use build and first launch and fills the lane's
  pinned staging pool at the bucket's sizes, so neither stalls a request
  (the port compiles nothing per bucket); a bounded
  pending count sheds (``on_full='reject'``, :class:`EngineSaturated` with
  a backoff hint) or backpressures (``on_full='block'``).

- **Resilience** (`resilience`): with ``health=HealthPolicy()`` every RHS
  is finite-guarded at ``submit()`` (on the host) and again at staging, so
  a poisoned request fails its own future; every dispatched solve carries
  the fused finite/spot-residual verdict, read by the drain after the
  batch's event; an unhealthy batch re-dispatches its members solo and
  the sick one climbs the escalation ladder (`resilience.escalate`, or
  `escalate_precision` for tier requests) before a structured
  `SolveUnhealthy`; a session that keeps failing is quarantined by its
  circuit breaker. Per-request ``deadline=`` with lazy eviction, a
  watchdog that fails pending work when a worker thread dies, and
  ``close(timeout)`` that names wedged workers complete it.

Streams: a session factored by the caller on the default stream is read
by the lane stream only after the lane waits on the default stream (each
dispatch starts with that wait); a dispatched batch holds references to
the session state it reads until the drain has seen its event, so a
session mutated or refactored meanwhile (the escalation ladder runs on
the drain thread, on the default stream) cannot free memory a queued
kernel still reads; tensors the lane makes and hands to a caller (the
factor lane's sessions, probe rows) are recorded on the default stream
(`record_stream`) so their memory is not reused before the caller's work
on them completes.

- **Tiered residency and the fleet checkpoint** (`tier`): with
  ``residency=ResidentSet(...)`` the engine faults a spilled session back
  in before dispatching to it (deadline-aware: the revive wait is capped
  at the requests' soonest deadline, else ``revive_wait``) and lends its
  factor lane to the manager's stale-drift revivals; ``checkpoint()``
  snapshots the fleet at a drain barrier and ``restore()`` brings it back
  (lazily, host-tier, with a residency; resident without one).

- **The adaptive controller** (`control.AdaptiveController`, attached with
  ``controller=``) retunes the knobs from windowed telemetry on its own
  thread, through :meth:`ServeEngine.set_knobs` only, and grows a bucket
  cap only onto buckets `prewarm` has made ready.

Not ported yet, each raising NotImplementedError naming what it waits
for: ``lanes`` other than 1 or ``devices=`` naming more than one device
(several cards, the serving mesh lane). Mesh plans do not exist in the
port yet.

Sessions mutate under ``update`` and refactor; the engine calls
``session.solve`` / ``solve_checked`` under the session's lock. Do not
call ``session.update`` while requests against that session are in
flight: drain first (``engine.close()`` or wait on the futures).

    engine = ServeEngine(max_batch_delay=0.002, health=HealthPolicy())
    engine.prewarm(session, widths=(1, 2, 4))
    futs = [engine.submit(session, b) for b in rhs]     # non-blocking
    xs = [f.result(60) for f in futs]                   # host arrays
    print(engine.stats())                               # p50/p95/p99, batches
    engine.close()                                      # drains in flight
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
import weakref
import zlib
from collections import deque
from concurrent.futures import Future
from queue import Empty, Full, Queue
from typing import Any

import numpy as np
import torch

from conflux_tpu_torch import profiler, resilience, serve
from conflux_tpu_torch import qos as qos_mod
from conflux_tpu_torch.batched import stack_trees, unstack_tree
from conflux_tpu_torch.device import hand_to_default, order_after_default, resolve_device
from conflux_tpu_torch.gang import SessionGang
from conflux_tpu_torch.resilience import (
    DeadlineExceeded,
    HealthPolicy,
    RhsNonFinite,
    SessionQuarantined,
    SolveUnhealthy,
)
from conflux_tpu_torch.serve import FactorPlan, SolveSession
from conflux_tpu_torch.update import rank_bucket, zero_update_state

_SLICES = {
    "lanes": ("more than one lane (several cards and the serving mesh lane, "
              "ROADMAP Slice 7 item 14)"),
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{_SLICES[what]} is not ported yet")


def _devkey(device):
    """Hashable identity of a torch device (None: none given), the key of
    the per-device warmth registry (`FactorPlan._warm`)."""
    if device is None:
        return None
    device = torch.device(device)
    return (device.type, 0 if device.index is None else device.index)


def rendezvous(sid, nodes, key=None):
    """Rendezvous (highest-random-weight) hashing: the node whose
    (sid, node identity) hash is highest. `key(node)` gives the stable
    identity each node is weighed by (default: the node itself); the
    identities must be distinct and survive restarts.

    When the node set changes only the sids whose winning node vanished
    move: every other sid's per-node weights, and so its argmax, stay.
    Removing one of N nodes remaps about 1/N of the sids (the dead node's
    own). Ties (a CRC collision) break toward the lexically largest
    identity, so the choice is a pure function of (sid, node set)."""
    sb = str(sid).encode()
    best = best_ident = None
    best_w = -1
    for n in nodes:
        ident = str(n if key is None else key(n))
        w = zlib.crc32(sb + b"@" + ident.encode())
        if w > best_w or (w == best_w and (best_ident is None or ident > best_ident)):
            best, best_ident, best_w = n, ident, w
    return best


def rendezvous_ranked(sid, nodes, k=None, key=None):
    """Rendezvous hashing, ranked: the full preference order of `nodes`
    for `sid`, highest weight first (the weights and tie-break of
    :func:`rendezvous`, so `rendezvous_ranked(sid, ns)[0] ==
    rendezvous(sid, ns)`); `k` keeps the top k. Removing a node promotes
    each sid's next-ranked survivor without reordering any other pair."""
    sb = str(sid).encode()
    ranked = sorted(
        nodes,
        key=lambda n: (zlib.crc32(sb + b"@" + str(n if key is None else key(n)).encode()),
                       str(n if key is None else key(n))),
        reverse=True)
    return ranked if k is None else ranked[:k]


def place_session(sid, devices):
    """Deterministic consistent placement: map a stable session id onto one
    of `devices` by rendezvous hashing over the device identities. Equal
    sids land on equal devices for any fixed device list, across engines
    and process restarts; a change of the list remaps only the sids whose
    device vanished."""
    if len(devices) == 1:
        return devices[0]
    return rendezvous(sid, devices, key=_devkey)


class EngineSaturated(RuntimeError):
    """submit() refused: the bounded pending set is full (shed policy).
    `retry_after` is a backoff hint in seconds (it doubles with every
    consecutive shed and resets at the next admission); `tenant` and
    `qos_class` attribute the shed of a classified request (None
    otherwise)."""

    def __init__(self, msg: str, retry_after: float = 0.0,
                 tenant: str | None = None, qos_class: str | None = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.tenant = tenant
        self.qos_class = qos_class


class EngineClosed(RuntimeError):
    """submit() after close(), or pending work failed because the engine
    shut down (a wedged close, a dead worker thread)."""


@dataclasses.dataclass
class _Request:
    session: Any          # the SolveSession the answer comes from
    b2: Any               # host RHS (numpy) with a trailing width axis
    width: int            # column count before coalescing
    squeeze: bool         # drop the width axis in the result
    future: Future        # resolved by the drain thread
    t_submit: float       # perf_counter at admission (latency clock)
    expiry: float | None = None  # perf_counter deadline (lazy eviction)
    carried: bool = False  # deferred once already: never again
    lane: Any = None      # the DeviceLane that owns this request
    lane_slot: bool = False  # counted against the lane's pending slice
    qos: Any = None       # QosClass or None
    cost: float = 1.0     # ledger admission weight (qos.request_cost)
    precision: Any = None  # per-request served tier or 'auto'

    __hash__ = object.__hash__


@dataclasses.dataclass
class _FactorRequest:
    """One cold-start request in the factor lane; shares the request
    surface (`future`, `expiry`, `carried`, `t_submit`) with
    :class:`_Request`, so pruning, carry-over and resolution treat both
    lanes alike."""

    plan: Any             # the FactorPlan whose program factors A
    A: Any                # host matrix (numpy), plan-shaped
    policy: Any           # DriftPolicy for the opened session (or None)
    future: Future        # resolves to a device-resident SolveSession
    t_submit: float       # perf_counter at admission
    expiry: float | None = None
    carried: bool = False
    lane: Any = None
    lane_slot: bool = False
    sid: Any = None       # stable session id for the opened session
    qos: Any = None
    cost: float = 1.0
    precision: Any = None  # served tier the session opens at

    __hash__ = object.__hash__


@dataclasses.dataclass
class _SolveBatch:
    """A dispatched solve batch in flight to the drain thread: the host
    answer buffer its non-blocking copy lands in (and the verdict's, when
    checked), the event after both copies, the staged host RHS (for the
    escalation ladder) and references to the state the dispatch reads,
    held until the drain has seen the event."""

    spec: list            # (request, stack slot or None, column offset)
    xh: Any               # host tensor the answer lands in
    vh: Any               # host tensor the verdict lands in, or None
    event: Any            # CUDA event after the copies (None on the CPU)
    buf: Any = None       # staged host RHS (numpy), None for a gang batch
    keep: Any = None      # device state the dispatch reads


@dataclasses.dataclass
class _StackBatch:
    """A dispatched checked gang batch: the stacked answer, the (2, cap)
    per-slot verdict and the slot -> session map the drain needs to name
    a sick slot without re-dispatching its gang-mates."""

    plan: Any
    spec: list
    xh: Any
    vh: Any
    sessions: dict        # slot -> session, request-carrying slots only
    event: Any
    keep: Any = None


@dataclasses.dataclass
class _FactorBatch:
    """A dispatched coalesced factor batch: the stacked factor tree (and,
    when checked, the stacked probe rows and the host copy of the (2,
    bucket) verdict) plus the staged device A stack the sessions take
    their bases from."""

    plan: Any
    reqs: list            # live requests, in slots 0..n-1
    factors: Any          # stacked factor tree, leading axis = bucket
    wA: Any               # stacked probe rows (checked) or None
    vh: Any               # host verdict (checked) or None
    A: Any                # the staged (bucket,) + shape device A stack
    event: Any
    solo: bool = False    # a solo re-dispatch: no second retry
    tier: Any = None      # served tier the batch factored at


def _host_array(x) -> np.ndarray:
    """A host request payload as numpy (a tensor on the card is copied to
    the host: a wait, in the caller's thread, at admission)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize_rhs(session, b):
    """Mirror `SolveSession._rhs` on the host: (b2, squeeze) with b2 a
    numpy array with an explicit trailing width axis. Staying in numpy
    keeps admission free of device work: the dispatcher copies requests
    into one bucket-width staging buffer per batch, so the card sees one
    transfer per batch however many requests coalesced."""
    plan = session.plan
    b = _host_array(b)
    if plan.batched:
        want = (plan.B, plan.N)
        if b.ndim == 2:
            if b.shape != want:
                raise ValueError(f"rhs {b.shape}, session needs {want}")
            return b[:, :, None], True
        if b.ndim != 3 or b.shape[:2] != want:
            raise ValueError(f"rhs {b.shape}, session needs {want} (+ rhs axis)")
        return b, False
    rows = plan.M  # == N for the square kinds; QR solves take an M-row rhs
    if b.ndim == 1:
        if b.shape[0] != rows:
            raise ValueError(f"rhs {b.shape}, session needs ({rows},)")
        return b[:, None], True
    if b.ndim != 2 or b.shape[0] != rows:
        raise ValueError(f"rhs {b.shape}, session needs ({rows}, k)")
    return b, False


def _torch_dtype_of(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


_STOP = object()


def _percentile(sorted_vals, pct: float) -> float:
    """Nearest-rank percentile of an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(pct / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[idx]


class DeviceLane:
    """One card's worth of the serve engine: a dispatcher/drain pair, the
    lane's CUDA stream, its bucket carry-over and per-lane telemetry.

    The engine keeps the bounded pending set, deadlines, health guards,
    knobs and the resolution-ownership `_live` set; the lane owns its input
    queue, its 2-deep dispatched-batch queue, its worker threads and its
    gangs. Counters shared with the engine are written under the engine's
    admission lock; the `busy_*_s` gauges each have one writer (their own
    worker thread) and are read without a lock.
    """

    def __init__(self, eng: "ServeEngine", index: int, device: torch.device):
        self.eng = eng
        self.index = index
        self.device = device
        self.cuda = device.type == "cuda"
        # the dispatcher's stream: every staged copy, kernel and answer
        # copy of a dispatch is queued here
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        # per-lane coalescing window override (None: the engine's)
        self.delay_override: float | None = None
        self._inq: Queue = Queue()
        # bounded at 2: the double buffer
        self._outq: Queue = Queue(maxsize=2)
        # per-lane telemetry, written under the engine lock
        self.batches = 0
        self.coalesced = 0
        self.bucket_hits: dict = {}
        self.factor_batches = 0
        self.factor_coalesced = 0
        self.gang_batches = 0
        self.gang_coalesced = 0
        self.pending = 0
        self.sheds = 0
        # the lane's gangs, one per plan: the dict changes under the
        # engine lock, each gang carries its own RLock
        self._gangs: dict = {}
        self.queue_hw = 0  # monotone high-water, racy max by design
        self.busy_dispatch_s = 0.0
        self.busy_drain_s = 0.0
        self.t_start = time.perf_counter()
        self.revives = 0
        self.dead = False
        # (thread name, exc) post-mortem, write-once by the dying worker
        self._dead: tuple | None = None
        self._dispatcher: threading.Thread | None = None
        self._drainer: threading.Thread | None = None

    @property
    def delay(self) -> float:
        """This lane's coalescing window: its override when set
        (`ServeEngine.set_knobs(lane=...)`), else the engine's
        `max_batch_delay`."""
        d = self.delay_override
        return self.eng.max_batch_delay if d is None else d

    # hot-path
    def _collect_delay(self, r) -> float:
        """The request's collect delay inside this lane's window: the
        lane's delay for unclassified requests, the class's tier delay
        otherwise (latency ~0, batch a stretched window)."""
        if r.qos is None:
            return self.delay
        st = self.eng._qos
        return qos_mod.collect_delay(r.qos, self.delay,
                                     st.tier_delay if st is not None else {})

    # hot-path
    def _carry_delay(self, reqs) -> float:
        """The window of a batch: the least of its members' collect
        delays (`self.delay` when none is classified)."""
        d = self.delay
        for r in reqs:
            if r.qos is not None:
                d = min(d, self._collect_delay(r))
        return d

    def start(self) -> None:
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="serve-engine-dispatch", daemon=True)
        self._drainer = threading.Thread(target=self._drain_loop,
                                         name="serve-engine-drain", daemon=True)
        self._dispatcher.start()
        self._drainer.start()

    # ------------------------------------------------------------------ #
    # host staging and copies
    # ------------------------------------------------------------------ #

    def _host_buffer(self, shape, dtype):
        """A zeroed host staging tensor (pinned on the card, so its copy
        to the device does not wait) and its numpy view. Each batch gets a
        buffer of its own: the batch holds it until the drain has seen the
        batch's event, and torch's pinned allocator does not reuse it
        before its copies completed."""
        if not isinstance(dtype, torch.dtype):
            dtype = _torch_dtype_of(dtype)
        t = torch.zeros(tuple(shape), dtype=dtype, pin_memory=self.cuda)
        return t, (t.numpy() if dtype != torch.bfloat16 else None)

    def _h2d(self, host: torch.Tensor, device) -> torch.Tensor:
        """A staged host tensor on `device`: one non-blocking copy on the
        current stream from pinned memory, or the host tensor itself on
        the CPU."""
        device = torch.device(device)
        if device.type == "cpu":
            return host
        return host.to(device, non_blocking=True)

    def _d2h(self, x):
        """Queue the copy of a device tensor (or tuple of them) to fresh
        pinned host tensors and return them; on the CPU the tensor itself.
        Nothing waits: the drain reads them after the batch's event."""
        if x is None:
            return None
        if x.device.type == "cpu":
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    def _fence(self, device):
        """A CUDA event after the work queued so far on the current
        stream of `device` (None on the CPU, where the work is done)."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    @contextlib.contextmanager
    def _on_lane_stream(self):
        if self.cuda:
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                yield
        else:
            yield

    # ------------------------------------------------------------------ #
    # dispatcher: collect a window, coalesce, dispatch without waiting
    # ------------------------------------------------------------------ #

    # futures-owner (post-mortem wrapper: escapes reach _thread_died)
    def _dispatch_loop(self) -> None:
        try:
            with self._on_lane_stream():
                self._dispatch_inner()
        except BaseException as e:  # noqa: BLE001 - post-mortem + watchdog
            self._thread_died(threading.current_thread(), e)

    def _thread_died(self, thread, exc: BaseException) -> None:
        """Post-mortem hook on the dying worker thread: record the cause
        and trip the watchdog at once (the polling watchdog is the backstop
        for silent deaths)."""
        self.eng._lane_died(self, thread, exc)

    def _wait_bound(self, reqs, remaining: float) -> float:
        """Cap a collect wait at the soonest request deadline, so lazy
        eviction runs when a deadline passes mid-window."""
        exps = [r.expiry for r in reqs if r.expiry is not None]
        if not exps:
            return remaining
        return min(remaining, max(0.0, min(exps) - time.perf_counter()) + 1e-4)

    def _prune_expired(self, reqs) -> list:
        """Lazy deadline eviction: fail expired requests with
        :class:`DeadlineExceeded` (releasing their pending slots) and
        return the survivors."""
        now = time.perf_counter()
        live = []
        for r in reqs:
            if r.expiry is not None and now > r.expiry:
                resilience.bump("evictions")
                self.eng._fail([r], DeadlineExceeded(
                    f"deadline passed {now - r.expiry:.3f}s before dispatch (lazily "
                    "evicted; pending slot released)"))
            else:
                live.append(r)
        return live

    # hot-path, futures-owner (the dispatcher loop)
    def _dispatch_inner(self) -> None:
        eng = self.eng
        stop = False
        carry: list = []  # small remainder chunks deferred to this round
        while not stop:
            if carry:
                try:
                    first = self._inq.get(
                        timeout=self._wait_bound(carry, self._carry_delay(carry)))
                except Empty:
                    first = None  # the window was spent waiting on the carry
            else:
                first = self._inq.get()
            batch = list(carry)
            carry = []
            collect = True
            if first is _STOP:
                stop = True
                collect = False
            elif first is None:
                collect = False
            else:
                batch.append(first)
            if collect:
                deadline = time.perf_counter() + self._carry_delay(batch)
                while True:
                    batch = self._prune_expired(batch)
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        # the window is over, but what is already queued
                        # still coalesces (a backlog never dispatches one
                        # request at a time)
                        try:
                            r = self._inq.get_nowait()
                        except Empty:
                            break
                    else:
                        try:
                            r = self._inq.get(timeout=self._wait_bound(batch, remaining))
                        except Empty:
                            continue
                    if r is _STOP:
                        stop = True
                        break
                    batch.append(r)
                    if r.qos is not None:
                        # a latency-class arrival pulls the window in
                        deadline = min(deadline,
                                       time.perf_counter() + self._collect_delay(r))
                    if len(batch) >= eng.max_pending:
                        break
            if batch:
                batch = self._prune_expired(batch)
            if batch:
                try:
                    resilience.maybe_fault(eng._faults, "dispatch")
                    t0 = time.perf_counter()
                    carry = self._dispatch(batch,
                                           may_defer=not stop and not self._inq.empty())
                    self.busy_dispatch_s += time.perf_counter() - t0
                except Exception as e:  # noqa: BLE001 - the engine survives
                    eng._fail(batch, e)
        # close-time drain: the carry is answered, not dropped
        tail = self._prune_expired(carry)
        if tail:
            self._dispatch(tail, may_defer=False)
        self._outq.put(_STOP)

    # hot-path, futures-owner
    def _dispatch(self, batch, may_defer: bool = False) -> list:
        """Group a window's requests and dispatch each group as one device
        program (nothing here waits for the card). With `may_defer` (more
        traffic already queued) each session's small remainder chunk rides
        the next window once instead of costing a dispatch of its own.
        Factor requests group per plan and coalesce into stacked factor
        dispatches."""
        eng = self.eng
        freqs = [r for r in batch if isinstance(r, _FactorRequest)]
        deferred: list = []
        if freqs:
            deferred += self._dispatch_factors(freqs, may_defer)
            batch = [r for r in batch if not isinstance(r, _FactorRequest)]
        groups: dict[tuple, list[_Request]] = {}
        order = []
        for r in batch:
            # a coalesced chunk shares one session.solve call, so the
            # group key carries the request's precision route
            key = (id(r.session), r.precision)
            if key not in groups:
                groups[key] = []
                order.append((r.session, r.precision))
            groups[key].append(r)
        stackable: dict[int, list] = {}
        plan_order = []
        opportunity: dict[int, int] = {}
        for session, precision in order:
            reqs = groups[(id(session), precision)]
            plan = session.plan
            tiered = precision is not None or session._served_tier is not None
            if (eng.stack_sessions and not plan.batched and plan.key.kind != "qr"
                    and not tiered):
                # gang eligibility: single-system plans (drifted and
                # checked sessions stack too); QR plans and tier requests
                # are counted exclusions
                pk = id(plan)
                if pk not in stackable:
                    stackable[pk] = []
                    plan_order.append(plan)
                stackable[pk].append((session, reqs))
                continue
            if eng.stack_sessions:
                eng._note_exclusion("kind" if plan.key.kind == "qr"
                                    else "precision" if tiered else "batched")
            elif not plan.batched:
                # stacking off: count the opportunity the window left
                opportunity[id(plan)] = opportunity.get(id(plan), 0) + 1
            deferred += self._dispatch_session(session, reqs, may_defer)
        missed = sum(c for c in opportunity.values() if c >= 2)
        if missed:
            with eng._lock:
                eng._gang_opportunity += missed
        for plan in plan_order:
            entries = stackable[id(plan)]
            if len(entries) == 1:
                eng._note_exclusion("singleton")
                deferred += self._dispatch_session(*entries[0], may_defer)
            else:
                self._dispatch_gang(plan, entries)
        return deferred

    # hot-path
    def _dispatch_session(self, session, reqs, may_defer: bool = False) -> list:
        """Per-session coalescing: concatenate RHS columns up to the width
        cap and run each chunk through `session.solve`. Returns the
        deferred remainder (at most one small chunk, each request deferred
        at most once)."""
        eng = self.eng
        chunks: list[list[_Request]] = []
        chunk: list[_Request] = []
        width = 0
        for r in reqs:
            if chunk and width + r.width > eng.max_coalesce_width:
                chunks.append(chunk)
                chunk, width = [], 0
                with eng._lock:
                    eng._width_capped += 1
            chunk.append(r)
            width += r.width
        deferred: list = []
        if chunk:
            if (may_defer and width <= eng.max_coalesce_width // 2
                    and not any(r.carried for r in chunk)):
                for r in chunk:
                    r.carried = True
                deferred = chunk
            else:
                chunks.append(chunk)
        for c in chunks:
            self._run_chunk(session, c)
        return deferred

    # hot-path
    def _admit_stage(self, reqs) -> list:
        """Pre-staging admission on the dispatch path: lazy deadline
        eviction and the 'staging' fault site (it poisons the request's own
        host copy, upstream of the guard)."""
        eng = self.eng
        reqs = self._prune_expired(reqs)
        if eng._faults is not None or resilience.active_faults():
            for r in reqs:
                if resilience.data_fault(eng._faults, "staging", "nan") is not None:
                    # conflint: disable=CFX-HOSTSYNC fault-injection copy of host-staged numpy
                    poisoned = np.array(r.b2, copy=True)
                    poisoned[..., 0] = np.nan
                    r.b2 = poisoned
        return reqs

    # hot-path, futures-owner
    def _isolate_poisoned(self, reqs) -> list:
        """The staging finite guard's per-request scan: a request poisoned
        after admission fails alone and never reaches the card."""
        eng = self.eng
        live = []
        for r in reqs:
            if resilience.rhs_finite(r.b2):
                live.append(r)
                continue
            resilience.bump("staging_isolations")
            eng._restore_guards()
            eng._fail([r], RhsNonFinite(
                "rhs went non-finite after admission: isolated at staging "
                "(co-batched requests unaffected)"))
        return live

    # hot-path (host staging: one host-to-device copy per batch)
    def _stage(self, reqs):
        """Stage a session chunk on the host: copy every request's columns
        into one zero-padded bucket-width buffer (exactly the padding
        `SolveSession.solve` adds). Returns (host tensor, numpy view,
        spec), spec the (request, stack slot, column offset) scatter plan
        for the drain."""
        W = sum(r.width for r in reqs)
        wb = rank_bucket(W)
        lead = reqs[0].b2.shape[:-1]
        host, buf = self._host_buffer(lead + (wb,), reqs[0].b2.dtype)
        spec = []
        lo = 0
        for r in reqs:
            buf[..., lo:lo + r.width] = r.b2
            spec.append((r, None, lo))
            lo += r.width
        return host, buf, spec

    # hot-path
    def _revive_for(self, session, reqs) -> None:
        """Deadline-aware fault-in ahead of a dispatch to a spilled
        session: the revive-lane wait is capped at the requests' soonest
        deadline (else the engine's `revive_wait`), so a request expiring
        mid-revival fails through the survivor machinery (its admission
        slot released, the session left fully spilled with its record
        intact) instead of wedging the dispatcher. The resident fast path
        costs two attribute reads."""
        rs = session._residency
        # racy fast-path read by design: fault_in re-checks under the
        # session lock
        if rs is None or session._spill is None:
            return
        timeout = self.eng.revive_wait
        exps = [r.expiry for r in reqs if r.expiry is not None]
        if exps:
            timeout = max(0.0, min(exps) - time.perf_counter())
        rs.fault_in(session, timeout=timeout)

    # hot-path
    def _solve_session(self, session, b, precision=None):
        """One dispatch through the session, checked when the policy says
        so (or for an 'auto' request, whose verdict is the ladder's
        signal). Holds the session lock, so a drain-thread escalation is
        atomic against this dispatcher. Returns (x, verdict, keep), keep
        the references to the state the dispatch reads."""
        eng = self.eng
        with session._lock:
            # a caller's update or refactor queued on the default stream
            # comes first; under the lock, so no mutation slips between
            order_after_default(session.device)
            session._lane_reads_base()
            keep = (session._factors, session._A, session._A0, session._probe,
                    session._upd)
            if precision == "auto" or (eng.health is not None and eng.health.check_output):
                x, verdict = session.solve_checked(b, precision=precision)
            else:
                x, verdict = session.solve(b, precision=precision), None
            return x, verdict, keep

    # hot-path, futures-owner
    def _run_chunk(self, session, reqs, solo: bool = False) -> None:
        eng = self.eng
        reqs = self._admit_stage(reqs)
        if not reqs:
            return
        try:
            host, buf, spec = self._stage(reqs)
            if (eng.health is not None and eng.health.check_rhs
                    and not eng.health.check_output and eng._tick_staging()
                    and not resilience.rhs_finite(buf)):
                # no fused output verdict to back the staging guard: one
                # per-batch summation, the per-request scan on suspicion
                # only (with check_output on, the device-side finite
                # verdict catches staged poison and the drain isolates it)
                reqs = self._isolate_poisoned(reqs)
                if not reqs:
                    return
                host, buf, spec = self._stage(reqs)
            self._revive_for(session, reqs)
            bd = self._h2d(host, session.device)
            x, verdict, keep = self._solve_session(session, bd, reqs[0].precision)
            xh, vh = self._d2h(x), self._d2h(verdict)
            item = _SolveBatch(spec, xh, vh, self._fence(x.device), buf, (keep, x, bd, host))
        except Exception as e:  # noqa: BLE001 - the engine must survive
            self._redispatch_survivors(reqs, e, solo)
            return
        wb = buf.shape[-1]
        with eng._lock:
            eng._batches += 1
            eng._coalesced_requests += len(reqs)
            eng._bucket_hits[wb] = eng._bucket_hits.get(wb, 0) + 1
            eng._active_sessions[id(session)] = weakref.ref(session)
            self.batches += 1
            self.coalesced += len(reqs)
            self.bucket_hits[wb] = self.bucket_hits.get(wb, 0) + 1
        self._outq.put(item)

    # futures-owner
    def _redispatch_survivors(self, reqs, exc, solo: bool = False) -> None:
        """A batch-attributable failure re-dispatches each member alone
        instead of failing them all with one exception: the innocent
        members get their answers, only the sick one fails. One level
        deep: a solo request that fails again fails for real."""
        if solo or len(reqs) == 1:
            self.eng._fail(reqs, exc)
            return
        resilience.bump("survivor_redispatches", len(reqs))
        for r in reqs:
            self._run_chunk(r.session, [r], solo=True)

    # ------------------------------------------------------------------ #
    # the factor lane: coalesced cold-start dispatch
    # ------------------------------------------------------------------ #

    # hot-path
    def _dispatch_factors(self, reqs, may_defer: bool = False) -> list:
        """Per-(plan, tier) coalescing of factor requests into chunks of up
        to `max_factor_batch`, each one stacked factor dispatch. Returns
        the deferred remainder (with `may_defer`, a small trailing chunk
        rides the next window once)."""
        eng = self.eng
        groups: dict[tuple, list] = {}
        order = []
        for r in reqs:
            key = (id(r.plan), r.precision)
            if key not in groups:
                groups[key] = []
                order.append((r.plan, key))
            groups[key].append(r)
        deferred: list = []
        for plan, key in order:
            greqs = groups[key]
            cap = eng.max_factor_batch
            chunks = [greqs[i:i + cap] for i in range(0, len(greqs), cap)]
            last = chunks[-1]
            if may_defer and len(last) <= cap // 2 and not any(r.carried for r in last):
                for r in last:
                    r.carried = True
                deferred += last
                chunks = chunks[:-1]
            for c in chunks:
                self._run_factor_chunk(plan, c)
        return deferred

    # hot-path
    def _admit_stage_factor(self, reqs) -> list:
        """Pre-staging admission of the factor lane: lazy deadline eviction
        and the 'factor' nan fault site."""
        eng = self.eng
        reqs = self._prune_expired(reqs)
        if eng._faults is not None or resilience.active_faults():
            for r in reqs:
                if resilience.data_fault(eng._faults, "factor", "nan") is not None:
                    # conflint: disable=CFX-HOSTSYNC fault-injection copy of host-staged numpy
                    poisoned = np.array(r.A, copy=True)
                    poisoned[..., 0, 0] = np.nan
                    r.A = poisoned
        return reqs

    # hot-path, futures-owner
    def _isolate_poisoned_A(self, reqs) -> list:
        """The factor lane's staging guard: a matrix gone non-finite after
        admission fails its own future and leaves the stack."""
        eng = self.eng
        live = []
        for r in reqs:
            if resilience.rhs_finite(r.A):
                live.append(r)
                continue
            resilience.bump("factor_isolations")
            eng._restore_guards()
            eng._fail([r], RhsNonFinite(
                "matrix went non-finite after admission: isolated at staging "
                "(co-batched factorizations unaffected)"))
        return live

    # hot-path (host staging: one host-to-device copy per factor batch)
    def _stage_factor(self, plan, reqs) -> torch.Tensor:
        """Stage a factor chunk on the host: every request's matrix into
        one (bucket,) + shape buffer of the plan's dtype; pad slots carry
        identity matrices (well-conditioned by construction, never a copy
        of a request that might itself be poisoned)."""
        bb = rank_bucket(len(reqs))
        host, _ = self._host_buffer((bb,) + plan.key.shape,
                                    serve._torch_dtype(plan.key.dtype))
        for i, r in enumerate(reqs):
            host[i].copy_(torch.from_numpy(np.ascontiguousarray(r.A)))
        if bb != len(reqs):
            # eye(M, N) for tall QR plans: full column rank
            host[len(reqs):] = torch.eye(*plan.key.shape[-2:], dtype=host.dtype)
        return host

    # hot-path
    def _run_factor_chunk(self, plan, reqs, solo: bool = False) -> None:
        fb = self._build_factor_batch(plan, reqs, solo)
        if fb is not None:
            self._outq.put(fb)

    # hot-path, futures-owner
    def _build_factor_batch(self, plan, reqs, solo: bool = False):
        """Stage and dispatch one coalesced factor chunk (nothing waits
        for the card); returns the :class:`_FactorBatch` for the drain,
        or None when every request was failed or evicted. A
        batch-attributable exception re-dispatches the members solo."""
        eng = self.eng
        reqs = self._admit_stage_factor(reqs)
        if not reqs:
            return None
        try:
            if (eng.health is not None and eng.health.check_rhs and eng._tick_staging()
                    and not all(resilience.rhs_finite(r.A) for r in reqs)):
                # poisoned matrices fail alone before burning a factor
                # dispatch, always as RhsNonFinite
                reqs = self._isolate_poisoned_A(reqs)
                if not reqs:
                    return None
            host = self._stage_factor(plan, reqs)
            tier = reqs[0].precision
            checked = tier is None and eng.health is not None and eng.health.check_output
            Ad = self._h2d(host, self.device)
            with profiler.region("serve.factor"):
                if tier is not None:
                    # tier cold starts ride the unchecked tier family: the
                    # opened session's first checked solve carries the
                    # ladder's verdict
                    F = plan._tier_stacked_factor_fn(tier, host.shape[0])(Ad)
                    wA = verdict = None
                elif checked:
                    F, wA, verdict = plan._factor_health_fn(host.shape[0])(Ad)
                else:
                    F = plan._stacked_factor_fn(host.shape[0])(Ad)
                    wA = verdict = None
            vh = self._d2h(verdict)
            event = self._fence(self.device)
        except Exception as e:  # noqa: BLE001 - the engine must survive
            self._redispatch_factor_survivors(reqs, e, solo)
            return None
        bb = host.shape[0]
        with eng._lock:
            eng._factor_batches += 1
            eng._factor_coalesced += len(reqs)
            eng._factor_slots += bb
            eng._factor_pad += bb - len(reqs)
            eng._factor_bucket_hits[bb] = eng._factor_bucket_hits.get(bb, 0) + 1
            eng._active_plans[id(plan)] = weakref.ref(plan)
            self.factor_batches += 1
            self.factor_coalesced += len(reqs)
        return _FactorBatch(plan, reqs, F, wA, vh, Ad, event, solo, tier)

    # futures-owner
    def _redispatch_factor_survivors(self, reqs, exc, solo: bool = False) -> None:
        """A batch-attributable factor failure: re-dispatch each member
        alone (one level deep)."""
        if solo or len(reqs) == 1:
            self.eng._fail(reqs, exc)
            return
        resilience.bump("survivor_redispatches", len(reqs))
        for r in reqs:
            self._run_factor_chunk(r.plan, [r], solo=True)

    def _gang_for(self, plan) -> SessionGang:
        """This lane's gang for `plan`, created on first stacked contact
        (the dict changes under the engine lock)."""
        g = self._gangs.get(id(plan))
        if g is None:
            with self.eng._lock:
                g = self._gangs.get(id(plan))
                if g is None:
                    g = SessionGang(plan, self.device)
                    self._gangs[id(plan)] = g
        return g

    # hot-path
    def _dispatch_gang(self, plan, entries) -> None:
        """Cross-session coalescing through the plan's gang: per-session
        RHS concatenation first (width-capped; the overflow goes the
        per-session way), then every request-carrying session dispatches
        from its resident slot in one program. What still falls back solo
        is counted per reason (`stack_exclusions`)."""
        eng = self.eng
        ready = []
        for session, reqs in entries:
            reqs = self._admit_stage(reqs)
            chunk: list[_Request] = []
            width = 0
            rest: list[_Request] = []
            for r in reqs:
                if not rest and (not chunk or width + r.width <= eng.max_coalesce_width):
                    chunk.append(r)
                    width += r.width
                else:
                    rest.append(r)
            if chunk:
                ready.append((session, chunk, width))
            if rest:
                self._dispatch_session(session, rest)
        if len(ready) < 2:
            for session, chunk, _w in ready:
                eng._note_exclusion("singleton")
                self._run_chunk(session, chunk)
            return
        gang = self._gang_for(plan)
        checked = eng.health is not None and eng.health.check_output
        try:
            admitted, excluded = gang.ensure([s for s, _c, _w in ready], eng.max_stack,
                                             checked)
        except Exception:  # noqa: BLE001 - adoption is best-effort
            admitted = {}
            excluded = {id(s): "error" for s, _c, _w in ready}
        part = []
        for session, chunk, w in ready:
            if id(session) in admitted:
                part.append((session, chunk, w))
            else:
                eng._note_exclusion(excluded.get(id(session), "error"))
                self._run_chunk(session, chunk)
        if len(part) == 1:
            eng._note_exclusion("singleton")
            self._run_chunk(part[0][0], part[0][1])
            return
        if part:
            self._run_gang(plan, gang, part, checked)

    # hot-path, futures-owner
    def _run_gang(self, plan, gang, part, checked: bool) -> None:
        """One dispatch for the whole gang window: stage the RHS into a
        (cap, N, wb) host buffer (idle slots keep zero columns: pay flops
        on idle slots, move no factor bytes) and solve straight off the
        resident stacks, one K3 launch on a blocked plan. The gang RLock
        is held across the dispatch, so an in-place adopt cannot land
        between the snapshot and the launch."""
        eng = self.eng
        reqs_all = [r for _s, chunk, _w in part for r in chunk]
        verdict = None
        poisoned = False
        try:
            wb = rank_bucket(max(w for _s, _c, w in part))
            with gang._lock:
                snap = gang.prepare([s for s, _c, _w in part])
                cap = snap["cap"]
                host, buf = self._host_buffer((cap, plan.N, wb), part[0][1][0].b2.dtype)
                spec = []
                slot_sessions = {}
                for session, chunk, _w in part:
                    si = snap["slots"][id(session)]
                    slot_sessions[si] = session
                    lo = 0
                    for r in chunk:
                        buf[si, :, lo:lo + r.width] = r.b2
                        spec.append((r, si, lo))
                        lo += r.width
                if (eng.health is not None and eng.health.check_rhs and not checked
                        and eng._tick_staging() and not resilience.rhs_finite(buf)):
                    # no fused verdict to back the staging guard: culprits
                    # isolate per session chunk below, outside the lock
                    poisoned = True
                else:
                    if checked and snap["wA"] is None:
                        # a checked upgrade did not complete: dispatch this
                        # window solo; the next ensure() retries it
                        raise RuntimeError("gang probe stack unavailable for a checked "
                                           "dispatch")
                    bd = self._h2d(host, self.device)
                    A0 = snap["A0"] if plan.key.refine else None
                    with profiler.region("serve.solve"):
                        if snap["kb"]:
                            A0u = snap["A0"] if snap["sweeps"] else None
                            args = (snap["F"], A0u, snap["Up"], snap["Vp"], snap["Y"],
                                    snap["Cinv"])
                            if checked:
                                X, verdict = plan._stacked_update_solve_health_fn(
                                    cap, snap["kb"], wb, snap["sweeps"])(*args, snap["wA"], bd)
                            else:
                                X = plan._stacked_update_solve_fn(
                                    cap, snap["kb"], wb, snap["sweeps"])(*args, bd)
                        elif checked:
                            X, verdict = plan._stacked_solve_health_fn(cap, wb)(
                                snap["F"], A0, snap["wA"], bd)
                        else:
                            X = plan._stacked_solve_fn(cap, wb)(snap["F"], A0, bd)
                    xh, vh = self._d2h(X), self._d2h(verdict)
                    event = self._fence(X.device)
        except Exception as e:  # noqa: BLE001
            self._redispatch_survivors(reqs_all, e)
            return
        if poisoned:
            for session, chunk, _w in part:
                live = self._isolate_poisoned(chunk)
                if live:
                    self._run_chunk(session, live)
            return
        for session, _c, _w in part:
            with session._lock:  # solves is guarded by the session lock
                session.solves += 1
        with eng._lock:
            eng._batches += 1
            eng._coalesced_requests += len(reqs_all)
            eng._gang_batches += 1
            eng._gang_coalesced += len(reqs_all)
            eng._bucket_hits[wb] = eng._bucket_hits.get(wb, 0) + 1
            for session, _c, _w in part:
                eng._active_sessions[id(session)] = weakref.ref(session)
            self.batches += 1
            self.coalesced += len(reqs_all)
            self.gang_batches += 1
            self.gang_coalesced += len(reqs_all)
        keep = (snap, X, bd, host)
        if verdict is None:
            self._outq.put(_SolveBatch(spec, xh, None, event, None, keep))
        else:
            self._outq.put(_StackBatch(plan, spec, xh, vh, slot_sessions, event, keep))

    # ------------------------------------------------------------------ #
    # drain: the only lane thread that waits for the card
    # ------------------------------------------------------------------ #

    # futures-owner (post-mortem wrapper: escapes reach _thread_died)
    def _drain_loop(self) -> None:
        try:
            ctx = torch.cuda.device(self.device) if self.cuda else contextlib.nullcontext()
            with ctx:
                self._drain_inner()
        except BaseException as e:  # noqa: BLE001 - post-mortem + watchdog
            self._thread_died(threading.current_thread(), e)

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            event.synchronize()

    # futures-owner (the drain loop: the one thread that may wait)
    def _drain_inner(self) -> None:
        eng = self.eng
        while True:
            item = self._outq.get()
            if item is _STOP:
                break
            t0 = time.perf_counter()
            try:
                if isinstance(item, _FactorBatch):
                    self._drain_factor(item)
                    continue
                if isinstance(item, _StackBatch):
                    self._drain_stack(item)
                    continue
                spec = item.spec
                reqs = [r for r, _si, _lo in spec]
                try:
                    resilience.maybe_fault(eng._faults, "drain")
                    resilience.maybe_fault(eng._faults, "d2h")
                    # the one wait per batch: its answer (and verdict)
                    # copies are done after the event; the futures get
                    # numpy views of the batch's own host buffer
                    self._wait(item.event)
                    xh = item.xh.numpy()
                except Exception as e:  # noqa: BLE001
                    self._drain_redispatch(reqs, e)
                    continue
                if item.vh is not None:
                    session = reqs[0].session
                    limit = eng._limit(session)
                    healthy, finite, res = resilience.evaluate(item.vh.numpy(), limit)
                    if resilience.data_fault(eng._faults, "solve", "unhealthy") is not None:
                        healthy = False
                    if not healthy:
                        resilience.bump("output_failures")
                        eng._restore_guards()
                        self._drain_unhealthy(session, spec, item.buf, finite, res)
                        continue
                    if session._breaker is not None:
                        session._breaker.record_success()
                eng._settle(spec, xh)
            finally:
                self.busy_drain_s += time.perf_counter() - t0

    # futures-owner
    def _drain_stack(self, sb: _StackBatch) -> None:
        """Drain one checked gang batch: one wait for the stacked answer,
        then the per-slot verdicts (`resilience.evaluate_slots`). Healthy
        slots settle in place; each sick slot's requests re-dispatch solo
        through the escalation ladder (`_solo_drain`), so a sick session
        never costs its gang-mates a re-dispatch."""
        eng = self.eng
        reqs = [r for r, _si, _lo in sb.spec]
        try:
            resilience.maybe_fault(eng._faults, "drain")
            resilience.maybe_fault(eng._faults, "d2h")
            self._wait(sb.event)
            xh = sb.xh.numpy()
            verdicts = resilience.evaluate_slots(sb.vh.numpy(), eng._plan_limit(sb.plan))
            if resilience.data_fault(eng._faults, "solve", "unhealthy") is not None:
                verdicts = [(False, fin, res) for _h, fin, res in verdicts]
        except Exception as e:  # noqa: BLE001
            self._drain_redispatch(reqs, e)
            return
        healthy_spec, sick = [], []
        for r, si, lo in sb.spec:
            if verdicts[si][0]:
                healthy_spec.append((r, si, lo))
            else:
                sick.append(r)
        for slot, session in sb.sessions.items():
            if verdicts[slot][0] and session._breaker is not None:
                session._breaker.record_success()
        if sick:
            nslots = len({si for _r, si, _lo in sb.spec if not verdicts[si][0]})
            resilience.bump("output_failures", nslots)
            resilience.bump("gang_unhealthy_slots", nslots)
            eng._restore_guards()
            resilience.bump("survivor_redispatches", len(sick))
            for r in sick:
                self._solo_drain(r)
        if healthy_spec:
            eng._settle(healthy_spec, xh)

    # futures-owner
    def _drain_factor(self, fb: _FactorBatch) -> None:
        """Drain one coalesced factor batch: one wait for its event (the
        factors never cross to the host; only the small verdict does, when
        checked), the per-slot health verdicts, then the slice-out into
        independent sessions. Healthy neighbours of a sick slot settle in
        place; the sick slot re-runs solo and fails alone with
        evidence."""
        eng = self.eng
        reqs = fb.reqs
        try:
            resilience.maybe_fault(eng._faults, "drain")
            self._wait(fb.event)
            verdicts = None
            if fb.vh is not None:
                verdicts = resilience.evaluate_slots(fb.vh.numpy(),
                                                     eng._plan_limit(fb.plan))
                if resilience.data_fault(eng._faults, "factor", "unhealthy") is not None:
                    verdicts = [(False, fin, res) for _h, fin, res in verdicts]
        except Exception as e:  # noqa: BLE001
            self._drain_factor_redispatch(reqs, e)
            return
        entries = list(enumerate(reqs))
        if verdicts is not None:
            sick = [(i, r) for i, r in entries if not verdicts[i][0]]
            entries = [(i, r) for i, r in entries if verdicts[i][0]]
            for i, r in sick:
                resilience.bump("factor_unhealthy")
                eng._restore_guards()
                _h, finite, res = verdicts[i]
                if fb.solo:
                    limit = eng._plan_limit(fb.plan)
                    eng._fail([r], SolveUnhealthy(
                        f"coalesced factorization unhealthy after solo re-dispatch: "
                        f"finite={finite} res={res:.3e} (limit {limit:.3e})",
                        {"rungs": [{"rung": "factor", "finite": finite, "residual": res}],
                         "residual_limit": limit}))
                else:
                    self._solo_factor_drain(fb.plan, r)
        if entries:
            self._settle_factor(fb, entries)

    # futures-owner
    def _drain_factor_redispatch(self, reqs, exc) -> None:
        """A drain-side batch-attributable factor failure: re-run each
        request solo, inline (the rare path: the drain may wait)."""
        if len(reqs) == 1:
            self.eng._fail(reqs, exc)
            return
        resilience.bump("survivor_redispatches", len(reqs))
        for r in reqs:
            self._solo_factor_drain(r.plan, r)

    # futures-owner
    def _solo_factor_drain(self, plan, r) -> None:
        """One factor request, re-dispatched and drained inline on the
        drain thread with its own verdict (solo: a second failure is
        final)."""
        fb = self._build_factor_batch(plan, [r], solo=True)
        if fb is not None:
            self._drain_factor(fb)

    # futures-owner
    def _settle_factor(self, fb: _FactorBatch, entries) -> None:
        """Resolve a drained factor batch: each live slot's factors, base
        and (checked) probe row are views of the stacked device tensors
        (`batched.unstack_tree`, no copies), and each request gets an
        independent session constructed as `plan.factor` constructs it
        (same keep-A rule, same policy), pinned to this lane's device."""
        eng = self.eng
        now = time.perf_counter()
        owned = eng._take([r for _i, r in entries])
        with eng._lock:
            for _i, r in entries:
                if r in owned:
                    eng._factor_latencies.append(now - r.t_submit)
            eng._flat_seq += len(owned)
            eng._completed += len(owned)
            st = eng._qos
            if st is not None:
                for r in owned:
                    if r.qos is not None:
                        st.record_settle(r.qos, now - r.t_submit, r.cost)
        plan = fb.plan
        # the stacks were made on the lane stream and now belong to
        # callers, who use them on the default stream
        hand_to_default((fb.factors, fb.A, fb.wA))
        trees = unstack_tree(fb.factors, len(fb.reqs))
        for i, r in entries:
            if r not in owned:
                continue
            A_i = fb.A[i]
            # tier sessions keep A: their solves always sweep against it
            keep_A = A_i if (plan.key.refine or fb.tier is not None) else None
            session = SolveSession(plan, trees[i], keep_A, A_i, r.policy,
                                   device=self.device, sid=r.sid, served_tier=fb.tier)
            if fb.wA is not None:
                # the probe row came out of the checked factor dispatch
                session._probe = (tuple(p[i] for p in fb.wA)
                                  if isinstance(fb.wA, tuple) else fb.wA[i])
            r.future.set_result(session)

    # futures-owner
    def _drain_redispatch(self, reqs, exc) -> None:
        """Survivor re-dispatch from the drain side: re-solve each request
        solo, synchronously (the rare failure path)."""
        if len(reqs) == 1:
            self.eng._fail(reqs, exc)
            return
        resilience.bump("survivor_redispatches", len(reqs))
        for r in reqs:
            self._solo_drain(r)

    # futures-owner
    def _solo_drain(self, r) -> None:
        """One request, re-dispatched and drained inline (on the drain
        thread's default stream), with its own verdict and, if needed,
        escalation ladder."""
        eng = self.eng
        session = r.session
        if not self._admit_stage([r]):
            return
        try:
            _host, buf, spec = self._stage([r])
            if eng.health is not None and eng.health.check_rhs \
                    and not self._isolate_poisoned([r]):
                return
            self._revive_for(session, [r])
            x, verdict, _keep = self._solve_session(session, buf, r.precision)
            if verdict is not None:
                limit = eng._limit(session)
                healthy, finite, res = resilience.evaluate(verdict, limit)
                if resilience.data_fault(eng._faults, "solve", "unhealthy") is not None:
                    healthy = False
                if not healthy:
                    resilience.bump("output_failures")
                    eng._restore_guards()
                    self._escalate_settle(session, spec, buf, finite, res)
                    return
                if session._breaker is not None:
                    session._breaker.record_success()
            eng._settle(spec, resilience._host(x))
        except Exception as e:  # noqa: BLE001
            eng._fail([r], e)

    # futures-owner
    def _drain_unhealthy(self, session, spec, buf, finite, res) -> None:
        """An unhealthy verdict on a drained batch: a multi-request batch
        isolates first (a solo re-dispatch finds the sick request); a solo
        batch climbs the escalation ladder directly."""
        reqs = [r for r, _si, _lo in spec]
        if len(reqs) > 1:
            resilience.bump("survivor_redispatches", len(reqs))
            for r in reqs:
                self._solo_drain(r)
            return
        self._escalate_settle(session, spec, buf, finite, res)

    # futures-owner
    def _escalate_settle(self, session, spec, buf, finite, res) -> None:
        """Run the ladder for one request's staged buffer; settle on
        recovery, fail with the structured evidence (and count toward
        quarantine) otherwise. Tier requests climb the precision ladder
        first (`resilience.escalate_precision`)."""
        eng = self.eng
        reqs = [r for r, _si, _lo in spec]
        br = session._breaker
        evidence0 = {"rung": "dispatch", "finite": finite, "residual": res}
        try:
            if reqs[0].precision is not None:
                xh = resilience.escalate_precision(
                    session, buf, reqs[0].precision, eng.health, eng._limit(session),
                    evidence0=evidence0, faults=eng._faults)
            else:
                xh = resilience.escalate(session, buf, eng.health, eng._limit(session),
                                         evidence0=evidence0, faults=eng._faults)
        except Exception as e:  # noqa: BLE001 - SolveUnhealthy et al.
            if br is not None:
                br.record_failure()
            eng._fail(reqs, e)
            return
        if br is not None:
            br.record_success()
        eng._settle(spec, xh)


class ServeEngine:
    """A thread-safe request queue in front of a fleet of SolveSessions on
    one card.

    Knobs:

    max_batch_delay: how long the dispatcher holds the first request of a
        batch while more arrive to coalesce with it (0: no wait; requests
        already queued still coalesce).
    max_pending: admission bound on unanswered requests. `on_full` picks
        the policy at the bound: 'reject' (submit raises
        :class:`EngineSaturated` with a backoff hint) or 'block'
        (backpressure the submitter).
    max_coalesce_width: cap on coalesced RHS columns per dispatch, and the
        widest bucket `prewarm` needs for a build-free steady state.
    max_factor_batch: cap on coalesced factorizations per factor-lane
        dispatch (rounded up to a power of two).
    stack_sessions / max_stack: gang-resident cross-session stacking for
        single-system plans (`max_stack` caps a gang's membership); both
        are live knobs (`set_knobs`).
    latency_window: how many completed-request latencies the percentile
        window keeps.
    health: a :class:`~conflux_tpu_torch.resilience.HealthPolicy` switches
        on the numerical guards (RHS finite checks, fused verdicts,
        escalation, quarantine). None keeps the dispatch path unguarded.
    fault_plan: a :class:`~conflux_tpu_torch.resilience.FaultPlan`
        consulted at the instrumented sites (tests, chaos runs).
    watchdog_interval: poll period of the worker-liveness watchdog (0
        disables it; a worker dying by exception trips it directly). It
        watches thread liveness only, so a kernel build on first use
        (a minute on the card) never trips it.
    device: the card the lane serves (default: the card; "cpu" runs the
        kernels' plain versions, as the tests do). `devices=` with one
        device is the same.
    persistent_cache: kept for the JAX package's signature; the port has
        no XLA cache to switch on, and its kernel build directory
        (`ops/_build.py`) already persists between processes.
    residency: a :class:`~conflux_tpu_torch.tier.ResidentSet` managing the
        served fleet's tiers. The engine then faults spilled sessions back
        in before dispatching to them (deadline-aware) and lends its
        factor lane to the manager's stale-drift revivals; `stats()` gains
        the manager's gauges under 'tier', and `checkpoint()`/`restore()`
        default to this fleet.
    revive_wait: worker-thread cap (seconds) on waiting for a revive slot
        when the faulting requests carry no deadline: how long a saturated
        revive lane may stall the dispatcher before the requests fail with
        `SessionSpilled`.
    controller: a :class:`~conflux_tpu_torch.control.AdaptiveController`,
        attached last and started on its own thread; it writes only
        through :meth:`set_knobs` and stops first in :meth:`close`. None
        leaves every knob as constructed.
    lanes other than 1, devices= of several devices: not ported yet
        (NotImplementedError naming the slice).
    """

    def __init__(self, *, max_batch_delay: float = 0.002,
                 max_pending: int = 1024, on_full: str = "reject",
                 max_coalesce_width: int = 32,
                 max_factor_batch: int = 32,
                 stack_sessions: bool = False, max_stack: int = 8,
                 latency_window: int = 8192,
                 persistent_cache: bool = True,
                 health: HealthPolicy | None = None,
                 fault_plan=None,
                 watchdog_interval: float = 0.2,
                 residency=None, revive_wait: float = 30.0, controller=None,
                 lanes: int | str = 1, devices=None, device=None):
        if on_full not in ("reject", "block"):
            raise ValueError(f"unknown on_full {on_full!r} (reject|block)")
        if max_pending < 1 or max_coalesce_width < 1 or max_stack < 1 \
                or max_factor_batch < 1:
            raise ValueError("max_pending, max_coalesce_width, max_stack and "
                             "max_factor_batch must be >= 1")
        if lanes != 1:
            raise _not_ported("lanes")
        if devices is not None:
            devs = list(devices)
            if not devs:
                raise ValueError("devices must name at least one device")
            if len(devs) > 1:
                raise _not_ported("lanes")
            if device is not None and torch.device(device) != torch.device(devs[0]):
                raise ValueError("device= and devices= name different devices")
            device = devs[0]
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.max_batch_delay = float(max_batch_delay)
        self.max_pending = int(max_pending)
        self.on_full = on_full
        self.max_coalesce_width = int(max_coalesce_width)
        self.max_factor_batch = rank_bucket(int(max_factor_batch))
        self.stack_sessions = bool(stack_sessions)
        self.max_stack = int(max_stack)
        self.health = health
        self._faults = fault_plan
        self.watchdog_interval = float(watchdog_interval)
        self.residency = residency
        self.revive_wait = float(revive_wait)
        if residency is not None and residency.engine is None:
            # lend the factor lane to the manager's stale-drift revivals
            residency.engine = self
        self._lanes: tuple = (DeviceLane(self, 0, dev),)
        # the admission lock: every counter and the live set below are
        # guarded by it; it is never held across a device dispatch
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._closed = False            # guarded-by: _lock
        # the checkpoint drain barrier: admission holds while True, so the
        # snapshot sees a quiesced fleet (pending == 0)
        self._draining = False          # guarded-by: _lock
        # serializes whole checkpoint() calls: two overlapping drains
        # would share the one flag, and the first to finish would reopen
        # admission under the other's snapshot
        self._ckpt_lock = threading.Lock()
        self._pending = 0               # guarded-by: _lock
        self._queue_peak = 0            # guarded-by: _lock
        self._requests = 0              # guarded-by: _lock
        self._completed = 0             # guarded-by: _lock
        self._failed = 0                # guarded-by: _lock
        self._sheds = 0                 # guarded-by: _lock
        self._consec_sheds = 0          # guarded-by: _lock
        self._batches = 0               # guarded-by: _lock
        self._coalesced_requests = 0    # guarded-by: _lock
        self._latencies: deque = deque(maxlen=int(latency_window))  # guarded-by: _lock
        self._factor_requests = 0       # guarded-by: _lock
        self._factor_batches = 0        # guarded-by: _lock
        self._factor_coalesced = 0      # guarded-by: _lock
        self._factor_slots = 0          # guarded-by: _lock
        self._factor_pad = 0            # guarded-by: _lock
        self._factor_latencies: deque = deque(maxlen=int(latency_window))  # guarded-by: _lock
        # window telemetry: samples ever appended to each latency ring
        # (sequence tokens for latency_window()), per-bucket hits, and the
        # chunks the width cap split
        self._lat_seq = 0               # guarded-by: _lock
        self._flat_seq = 0              # guarded-by: _lock
        self._bucket_hits: dict = {}    # guarded-by: _lock
        self._factor_bucket_hits: dict = {}  # guarded-by: _lock
        self._width_capped = 0          # guarded-by: _lock
        # gang telemetry: stacked batches and their requests, per-reason
        # counts of sessions that fell back to a solo dispatch, and (with
        # stacking off) the windows that could have stacked
        self._gang_batches = 0          # guarded-by: _lock
        self._gang_coalesced = 0        # guarded-by: _lock
        self._gang_opportunity = 0      # guarded-by: _lock
        # pre-seeded, so the closed holes read as literal zeros
        self._stack_exclusions: dict = {  # guarded-by: _lock
            k: 0 for k in ("upd_pending", "checked", "mesh", "batched", "singleton",
                           "stack_cap", "error", "kind", "precision")}
        # recently served sessions and factor-lane plans, weakly held (the
        # ladder's roll-up, the controller's prewarm targets)
        self._active_sessions: dict = {}  # guarded-by: _lock
        self._active_plans: dict = {}     # guarded-by: _lock
        # measured drain rate (completions/s) that sizes retry_after
        self._drain_rate: float | None = None  # guarded-by: _lock
        # guard relaxation: staging guard on 1-in-stride batches and a
        # relaxed policy; any trip restores both at once (_restore_guards)
        self._staging_stride = 1
        self._staging_tick = 0          # guarded-by: _lock
        self._health_strict = health
        # every admitted, unanswered request. Resolution ownership: only
        # the path that removed a request from this set under the lock
        # (`_take`) resolves its future, so a late worker can never
        # resolve a future twice
        self._live: set = set()         # guarded-by: _lock
        # (thread name, exc) post-mortem, write-once by the dying worker
        self._dead: tuple | None = None
        # QoS state: None until the first classified submission
        self._qos = None                # guarded-by: _lock
        self._qos_latency_window = int(latency_window)

        profiler.register_engine(self)
        for lane in self._lanes:
            lane.start()
        self._watchdog = None
        if self.watchdog_interval > 0:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="serve-engine-watchdog", daemon=True)
            self._watchdog.start()
        # the adaptive controller attaches last, so its first window sees
        # a whole engine; close() stops it first, and its loop ends by
        # itself when a watchdog trip closes the engine (the knobs keep
        # their last values: the controller is advisory)
        self._controller = None
        if controller is not None:
            controller.attach(self)
            controller.start()
            self._controller = controller

    # ------------------------------------------------------------------ #
    # client surface
    # ------------------------------------------------------------------ #

    # hot-path (admission: host work only, nothing waits for the card)
    def submit(self, session, b, *, deadline: float | None = None,
               qos=None, precision=None) -> Future:
        """Queue one solve against `session`; returns a Future whose result
        is a host (numpy) array with the shape and values `session.solve(b)`
        would have returned. An answer crosses to the host anyway, so the
        engine pays that copy once per coalesced batch; the per-request
        answers are numpy views of it.

        `deadline` (seconds from now) bounds how long the request may wait
        queued: past it the request is lazily evicted (its pending slot
        released, its future failed with :class:`DeadlineExceeded`).
        Raises :class:`EngineSaturated` at the pending bound under
        'reject' (with a `retry_after` hint); blocks under 'block'. With
        a :class:`HealthPolicy` a non-finite RHS raises
        :class:`RhsNonFinite` here and a quarantined session
        :class:`SessionQuarantined`.

        `qos=` classifies the request (:class:`~conflux_tpu_torch.qos.
        QosClass`): the tenant joins the weighted fair-share ledger (an
        over-share tenant on a contended engine is shed with
        `TenantThrottled`) and the tier picks its collect delay.
        `precision=` routes the request through a served tier's programs
        ('auto' starts on the session's sticky rung and always carries the
        verdict); tier requests never stack in a gang (a counted
        exclusion)."""
        return self._admit(self._prepare(session, b, deadline, qos, precision))

    # hot-path (admission prelude: validation and request construction)
    def _prepare(self, session, b, deadline=None, qos=None, precision=None):
        """submit()'s lock-free prelude, shared with :meth:`submit_many`:
        fast-fail checks, RHS normalization and guard, the request."""
        # conflint: disable=CFX-LOCK benign racy fast-fail; _admit re-checks locked
        if self._closed:
            raise EngineClosed("submit() on a closed ServeEngine")
        if self._dead is not None:
            name, exc = self._dead
            raise EngineClosed(f"engine worker {name} died: {exc!r}")
        if self.health is not None:
            br = resilience.breaker_for(session, self.health)
            ok, retry = br.allow()
            if not ok:
                raise SessionQuarantined(
                    f"session quarantined after repeated escalation failures (breaker "
                    f"open; probe in ~{retry:.2f}s)", retry_after=retry)
        b2, squeeze = _normalize_rhs(session, b)
        if (self.health is not None and self.health.check_rhs
                and not resilience.rhs_finite(b2, sample=self.health.submit_guard_sample)):
            resilience.bump("rhs_rejects")
            self._restore_guards()
            raise RhsNonFinite("rhs contains NaN/Inf: rejected at admission (a poisoned "
                               "request would corrupt every co-batched answer)")
        if qos is not None and not isinstance(qos, qos_mod.QosClass):
            raise TypeError(f"qos must be a conflux_tpu_torch.qos.QosClass (or None), got "
                            f"{type(qos).__name__}")
        precision = serve.check_precision_request(precision)
        now = time.perf_counter()
        req = _Request(session, b2, int(b2.shape[-1]), squeeze, Future(), now,
                       None if deadline is None else now + deadline,
                       qos=qos, precision=precision)
        if qos is not None:
            req.cost = qos_mod.request_cost(session.plan.key.shape, width=req.width)
        req.lane = self._lanes[0]
        return req

    # hot-path (batched admission: one lock round trip per frame)
    def submit_many(self, items) -> list:
        """Batched :meth:`submit`: `items` is ``[(session, b, qos)]``;
        returns len(items) futures, aligned. Items that can be admitted
        without waiting are admitted under one acquisition of the
        admission lock and routed outside it. An item that would have to
        wait (the 'block' policy at the bound) first routes its admitted
        frame-mates, then waits alone through :meth:`_admit`: an admitted
        but unrouted request can never complete, so a wait that needs its
        slot would deadlock the frame. Per-item failures are set on that
        item's future instead of raised."""
        reqs: deque = deque()
        futs: list = []
        for session, b, qos in items:
            try:
                req = self._prepare(session, b, qos=qos)
            except Exception as e:
                fut = Future()
                fut.set_exception(e)
                futs.append(fut)
            else:
                reqs.append(req)
                futs.append(req.future)
        while reqs:
            admitted = []
            with self._lock:
                while reqs:
                    req = reqs[0]
                    try:
                        if not self._admit_locked(req, wait=False):
                            break  # would wait: route the admitted first
                    except Exception as e:
                        reqs.popleft()
                        req.future.set_exception(e)
                        continue
                    reqs.popleft()
                    admitted.append(req)
            for req in admitted:
                self._route(req)
            if reqs:
                req = reqs.popleft()
                try:
                    self._admit(req)
                except Exception as e:
                    req.future.set_exception(e)
        return futs

    def _admit(self, req) -> Future:
        """Admission control shared by both lanes: the bounded pending set
        (shed with a backoff hint, or block), registration in `_live`, and
        the queue push."""
        with self._lock:
            self._admit_locked(req)
        self._route(req)
        return req.future

    # requires-lock: _lock
    def _admit_locked(self, req, wait: bool = True) -> bool:
        """The locked body of admission (also the per-item step of
        :meth:`submit_many`). May wait on `_not_full` ('block'); with
        ``wait=False`` a would-wait returns False with nothing committed.
        Returns True when the request was admitted."""
        if self._closed:
            raise EngineClosed("submit() on a closed ServeEngine")
        while self._draining and not self._closed:
            if isinstance(req, _FactorRequest):
                # a factor submission sheds at the drain barrier, never
                # waits: a client's stale-drift revival holds its session
                # lock while it submits here, and the checkpoint needs that
                # lock before the barrier clears. EngineSaturated sends the
                # revival to its direct plan._factor_once path (same bits)
                raise EngineSaturated(
                    "factor lane paused at the checkpoint drain barrier (snapshot "
                    "serializing): retry shortly, or fall back to plan.factor",
                    retry_after=0.05)
            if not wait:
                return False
            # hold admission (both policies) until the snapshot completes
            self._not_full.wait()
        if self._closed:
            raise EngineClosed("engine closed while checkpointing")
        if self._pending >= self.max_pending:
            if self.on_full == "reject":
                self._sheds += 1
                self._consec_sheds += 1
                hint, why = self._shed_hint_locked()
                raise EngineSaturated(
                    f"{self._pending} pending requests >= max_pending={self.max_pending} "
                    f"(shed policy 'reject'; {why})", retry_after=hint,
                    **self._qos_shed_attr(req))
            if not wait:
                return False
            while self._pending >= self.max_pending and not self._closed:
                self._not_full.wait()
            if self._closed:
                raise EngineClosed("engine closed while blocked")
        # weighted fair-share admission runs last, so a throttle has
        # committed nothing to roll back
        if req.qos is not None:
            self._qos_admit_locked(req)
        self._consec_sheds = 0
        self._pending += 1
        self._requests += 1
        if isinstance(req, _FactorRequest):
            self._factor_requests += 1
        self._live.add(req)
        if self._pending > self._queue_peak:
            self._queue_peak = self._pending
        return True

    # requires-lock: _lock
    def _shed_hint_locked(self) -> tuple:
        """(retry_after, reason) for a shed: from the measured drain rate
        when one is installed (`set_knobs(drain_rate=)`), else an
        exponential backoff."""
        rate = self._drain_rate
        if rate is not None and rate > 0.0:
            hint = min(1.0, max(1e-4, self._consec_sheds / rate))
            why = (f"retry in ~{1e3 * hint:.0f}ms, sized from the measured drain rate "
                   f"{rate:.0f}/s")
        else:
            hint = min(1.0, 1e-3 * (1 << min(self._consec_sheds - 1, 10)))
            why = f"retry in ~{1e3 * hint:.0f}ms, backoff hint doubles per consecutive shed"
        return hint, why

    def _qos_shed_attr(self, req) -> dict:
        """Shed attribution: {} for an unclassified request, the tenant and
        class (and the per-class health count) for a classified one."""
        if req.qos is None:
            return {}
        key = req.qos.key
        resilience.bump(f"engine_saturated[{key}]")
        return {"tenant": req.qos.tenant, "qos_class": key}

    # requires-lock: _lock
    def _qos_admit_locked(self, req) -> None:
        """Weighted fair-share admission of a classified request: creates
        the QoS state on first use, interns the class, and consults the
        ledger; a throttle raises `TenantThrottled` with a retry hint from
        the tenant's share of the drain rate. A throttle applies under
        both `on_full` policies."""
        st = self._qos
        if st is None:
            st = self._qos = qos_mod.EngineQosState(self._qos_latency_window)
        cls = st.intern(req.qos)
        req.qos = cls
        over = st.ledger.try_admit(cls, self._pending, self.max_pending, req.cost)
        if over is None:
            st.record_admit(cls)
            return
        st.record_throttle(cls)
        rate = self._drain_rate
        frac = st.ledger.frac(cls.tenant)
        if rate is not None and rate * frac > 0.0:
            hint = min(1.0, max(1e-4, over / (rate * frac)))
            why = (f"retry in ~{1e3 * hint:.0f}ms, sized from the tenant's "
                   f"{100 * frac:.0f}% share of the measured drain rate {rate:.0f}/s")
        else:
            hint = min(1.0, 2e-3 * max(1.0, over))
            why = f"retry in ~{1e3 * hint:.0f}ms, scaled by the tenant's over-share backlog"
        raise resilience.TenantThrottled(
            f"tenant {cls.tenant!r} is at/over its fair share "
            f"({st.ledger.share(cls.tenant, self.max_pending):.0f} of "
            f"max_pending={self.max_pending}) while the engine is contended "
            f"({self._pending} pending; {why})",
            retry_after=hint, tenant=cls.tenant, qos_class=cls.key)

    def _note_exclusion(self, reason: str) -> None:
        """Count one stacking exclusion: a session the gang path could have
        stacked went the solo way."""
        with self._lock:
            self._stack_exclusions[reason] = self._stack_exclusions.get(reason, 0) + 1

    def _route(self, req) -> None:
        """Hand an admitted request to its lane's queue."""
        lane = req.lane
        d = lane._inq.qsize() + 1
        if d > lane.queue_hw:
            lane.queue_hw = d
        lane._inq.put(req)

    @property
    def lanes(self) -> tuple:
        """The engine's :class:`DeviceLane`s (one)."""
        return self._lanes

    @property
    def devices(self) -> tuple:
        """The lane devices."""
        return tuple(ln.device for ln in self._lanes)

    def placement(self, sid):
        """The device `place_session` pins `sid` to on this engine's device
        list."""
        return place_session(sid, [ln.device for ln in self._lanes])

    # hot-path (admission: host work only)
    def submit_factor(self, plan, A, *, policy=None, deadline: float | None = None,
                      sid=None, device=None, qos=None, precision=None) -> Future:
        """Queue one factorization against `plan`; returns a Future whose
        result is a device-resident :class:`~conflux_tpu_torch.serve.
        SolveSession`, what ``plan.factor(A, policy=policy)`` would have
        opened, bit for bit on the kernel route (both ride the same stacked
        factor program family). Same-plan requests in one window coalesce
        into one stacked factor dispatch at a power-of-two bucket.

        `A` is staged on the host (one copy per batch; pad slots carry
        identity matrices). Shares the solve lane's admission control,
        deadlines and close semantics. With a :class:`HealthPolicy` a
        non-finite `A` raises :class:`RhsNonFinite` here (sampled; the
        staging guard re-checks exactly), and every coalesced
        factorization carries a per-slot post-factor verdict: a sick slot
        re-dispatches solo and fails alone with structured evidence
        (:class:`SolveUnhealthy`). `sid=` names the opened session;
        `device=` must be the lane's device. `qos=` classifies the cold
        start as on :meth:`submit`; `precision=` opens the session at a
        served tier ('auto': the cheapest rung)."""
        # conflint: disable=CFX-LOCK benign racy fast-fail; _admit re-checks locked
        if self._closed:
            raise EngineClosed("submit_factor() on a closed ServeEngine")
        if self._dead is not None:
            name, exc = self._dead
            raise EngineClosed(f"engine worker {name} died: {exc!r}")
        if not isinstance(plan, FactorPlan):
            raise TypeError(f"submit_factor takes a FactorPlan, got {type(plan).__name__} "
                            "(submit() serves sessions)")
        lane = self._lanes[0]
        if device is not None and _devkey(device) != _devkey(lane.device):
            raise ValueError(f"device {device} is not this engine's lane device "
                             f"{lane.device}: open the session with plan.factor, or build "
                             "the engine on that device")
        A2 = _host_array(A)
        if tuple(A2.shape) != plan.key.shape:
            raise ValueError(f"A shape {A2.shape} does not match the plan's {plan.key.shape}")
        if plan.key.dtype != "bfloat16" and A2.dtype != np.dtype(plan.key.dtype):
            A2 = A2.astype(plan.key.dtype)  # as plan.factor's tensor would be
        if (self.health is not None and self.health.check_rhs
                and not resilience.rhs_finite(A2, sample=self.health.submit_guard_sample)):
            resilience.bump("factor_rejects")
            self._restore_guards()
            raise RhsNonFinite("matrix contains NaN/Inf: rejected at admission (a poisoned "
                               "system would waste a coalesced factor dispatch)")
        if qos is not None and not isinstance(qos, qos_mod.QosClass):
            raise TypeError(f"qos must be a conflux_tpu_torch.qos.QosClass (or None), got "
                            f"{type(qos).__name__}")
        precision = serve.check_precision_request(precision)
        if precision == "auto":
            # a cold start has no verdict history: 'auto' opens on the
            # cheapest rung and the first checked solve escalates
            precision = serve.PRECISION_TIERS[0]
        now = time.perf_counter()
        req = _FactorRequest(plan, A2, policy, Future(), now,
                             None if deadline is None else now + deadline,
                             sid=sid, qos=qos, precision=precision)
        if qos is not None:
            req.cost = qos_mod.request_cost(plan.key.shape, factor=True)
        req.lane = lane
        return self._admit(req)

    def factor(self, plan, A, timeout: float | None = None, *, policy=None,
               deadline: float | None = None, sid=None, device=None, qos=None):
        """Blocking convenience: ``submit_factor(plan, A).result(timeout)``,
        the opened :class:`~conflux_tpu_torch.serve.SolveSession`."""
        return self.submit_factor(plan, A, policy=policy, deadline=deadline, sid=sid,
                                  device=device, qos=qos).result(timeout)

    def solve(self, session, b, timeout: float | None = None,
              deadline: float | None = None, qos=None, precision=None):
        """Blocking convenience: ``submit(session, b).result(timeout)``."""
        return self.submit(session, b, deadline=deadline, qos=qos,
                           precision=precision).result(timeout)

    # futures-owner
    def close(self, timeout: float | None = None) -> list:
        """Stop admission, drain every request in flight, join the workers.
        Queued requests are answered, not dropped; idempotent. Returns the
        names of wedged worker threads ([] normally): when a join times
        out, the futures still pending fail with :class:`EngineClosed`
        naming the wedged thread instead of hanging."""
        with self._lock:
            already = self._closed
            self._closed = True
            self._not_full.notify_all()
        if self._controller is not None:
            # stop the knob writer before tearing down what it tunes
            self._controller.close()
        if not already:
            for lane in self._lanes:
                lane._inq.put(_STOP)
        wedged = []
        for lane in self._lanes:
            lane._dispatcher.join(timeout)
            lane._drainer.join(timeout)
            wedged += [t.name for t in (lane._dispatcher, lane._drainer)
                       if t.is_alive() and not lane.dead]
        if wedged:
            with self._lock:
                leftover = list(self._live)
            self._fail(leftover, EngineClosed(
                f"close(timeout={timeout}) gave up: worker thread(s) {wedged} wedged; "
                f"{len(leftover)} pending request(s) failed instead of hanging"))
        return wedged

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # knob actuation
    # ------------------------------------------------------------------ #

    def set_knobs(self, *, max_batch_delay: float | None = None,
                  max_pending: int | None = None,
                  max_coalesce_width: int | None = None,
                  max_factor_batch: int | None = None,
                  stack_sessions: bool | None = None,
                  max_stack: int | None = None,
                  health: HealthPolicy | None = None,
                  staging_stride: int | None = None,
                  drain_rate: float | None = None,
                  qos_contention: float | None = None,
                  qos_tier_delay: dict | None = None,
                  lane: int | None = None) -> dict:
        """Thread-safe knob actuation. Writes land under the admission
        lock; the hot paths read each knob once per decision, so a move
        applies at the next window or admission, never mid-batch.
        Validation mirrors the constructor; raising `max_pending` wakes
        blocked submitters. `health` swaps the active policy (the first
        swap records the original as the strict restore point);
        `staging_stride` thins the staging guard to 1-in-stride batches
        (any trip resets it to 1); `drain_rate` installs the completions/s
        estimate that sizes `retry_after`; `qos_contention` and
        `qos_tier_delay` move the fair-share ledger's contention fraction
        and the per-tier collect delays. `lane=` scopes a
        `max_batch_delay` move to one lane. Returns the knob dict."""
        if max_batch_delay is not None and max_batch_delay < 0:
            raise ValueError("max_batch_delay must be >= 0")
        if lane is not None:
            if not 0 <= int(lane) < len(self._lanes):
                raise ValueError(f"lane {lane} out of range (engine has "
                                 f"{len(self._lanes)})")
            if max_batch_delay is None or any(
                    v is not None for v in (max_pending, max_coalesce_width,
                                            max_factor_batch, stack_sessions, max_stack,
                                            health, staging_stride,
                                            drain_rate, qos_contention, qos_tier_delay)):
                raise ValueError("lane= scopes exactly one knob: max_batch_delay")
            with self._lock:
                self._lanes[int(lane)].delay_override = float(max_batch_delay)
                return self._knobs_locked()
        if (max_pending is not None and max_pending < 1) \
                or (max_coalesce_width is not None and max_coalesce_width < 1) \
                or (max_factor_batch is not None and max_factor_batch < 1):
            raise ValueError("max_pending, max_coalesce_width and max_factor_batch must "
                             "be >= 1")
        if staging_stride is not None and staging_stride < 1:
            raise ValueError("staging_stride must be >= 1")
        if max_stack is not None and max_stack < 1:
            raise ValueError("max_stack must be >= 1")
        if qos_contention is not None and not 0 < qos_contention <= 1:
            raise ValueError("qos_contention must be in (0, 1]")
        if qos_tier_delay is not None:
            for tier, v in qos_tier_delay.items():
                if tier not in qos_mod.TIERS:
                    raise ValueError(f"qos_tier_delay key {tier!r} is not one of "
                                     f"{qos_mod.TIERS}")
                if v is not None and v < 0:
                    raise ValueError("qos_tier_delay values must be >= 0 seconds (or "
                                     "None to clear)")
        with self._lock:
            if max_batch_delay is not None:
                self.max_batch_delay = float(max_batch_delay)
            if max_pending is not None:
                self.max_pending = int(max_pending)
                self._not_full.notify_all()
            if max_coalesce_width is not None:
                self.max_coalesce_width = int(max_coalesce_width)
            if max_factor_batch is not None:
                self.max_factor_batch = rank_bucket(int(max_factor_batch))
            if stack_sessions is not None:
                # safe mid-flight: the dispatcher reads it once per window
                self.stack_sessions = bool(stack_sessions)
            if max_stack is not None:
                self.max_stack = int(max_stack)
            if health is not None:
                if self._health_strict is None:
                    self._health_strict = self.health
                self.health = health
            if staging_stride is not None:
                self._staging_stride = int(staging_stride)
            if drain_rate is not None:
                self._drain_rate = float(drain_rate)
            if qos_contention is not None or qos_tier_delay is not None:
                st = self._qos
                if st is None:
                    st = self._qos = qos_mod.EngineQosState(self._qos_latency_window)
                if qos_contention is not None:
                    st.ledger.contention = float(qos_contention)
                if qos_tier_delay is not None:
                    for tier, v in qos_tier_delay.items():
                        if v is None:
                            st.tier_delay.pop(tier, None)
                        else:
                            st.tier_delay[tier] = float(v)
            return self._knobs_locked()

    # requires-lock: _lock
    def _knobs_locked(self) -> dict:
        out = {"max_batch_delay": self.max_batch_delay,
               "max_pending": self.max_pending,
               "max_coalesce_width": self.max_coalesce_width,
               "max_factor_batch": self.max_factor_batch,
               "stack_sessions": self.stack_sessions,
               "max_stack": self.max_stack,
               "staging_stride": self._staging_stride,
               "drain_rate": self._drain_rate,
               "health_relaxed": (self._health_strict is not None
                                  and self.health is not self._health_strict),
               "lanes": len(self._lanes),
               "lane_delays": {ln.index: ln.delay_override for ln in self._lanes
                               if ln.delay_override is not None}}
        if self._qos is not None:
            out["qos_contention"] = self._qos.ledger.contention
            out["qos_tier_delay"] = dict(self._qos.tier_delay)
        return out

    def knobs(self) -> dict:
        """The current knob values (a consistent snapshot)."""
        with self._lock:
            return self._knobs_locked()

    def _restore_guards(self) -> None:
        """Any guard trip restores full-strength guarding at once, on the
        tripping thread."""
        self._staging_stride = 1
        strict = self._health_strict
        if strict is not None and self.health is not strict:
            self.health = strict

    def _tick_staging(self) -> bool:
        """True when this batch runs the exact staging guard (1-in-stride
        while relaxed; every batch by default)."""
        s = self._staging_stride
        if s <= 1:
            return True
        with self._lock:
            self._staging_tick += 1
            return self._staging_tick % s == 0

    def active_targets(self) -> tuple:
        """(sessions, plans) recently served by this engine, live
        references only: the controller's prewarm targets when it grows a
        bucket set. Dead references are pruned as a side effect."""
        with self._lock:
            srefs = list(self._active_sessions.items())
            prefs = list(self._active_plans.items())
        sessions, plans, dead_s, dead_p = [], [], [], []
        for k, ref in srefs:
            obj = ref()
            (sessions.append(obj) if obj is not None else dead_s.append(k))
        for k, ref in prefs:
            obj = ref()
            (plans.append(obj) if obj is not None else dead_p.append(k))
        if dead_s or dead_p:
            with self._lock:
                for k in dead_s:
                    self._active_sessions.pop(k, None)
                for k in dead_p:
                    self._active_plans.pop(k, None)
        return sessions, plans

    def _gang_readopt(self, sessions) -> None:
        """Adopt revived sessions straight back into the lane's gangs: the
        tier layer's grouped-revival hook (`ResidentSet.revive_many`), so a
        revived fleet's first window already dispatches stacked. Advisory:
        a failure leaves adoption to the next stacked dispatch. Called with
        no session lock held."""
        if not self.stack_sessions:
            return
        lane = self._lanes[0]
        groups: dict = {}
        for s in sessions:
            if s.plan.batched or s.plan.key.kind == "qr" or s._served_tier is not None:
                continue
            groups.setdefault(id(s.plan), (s.plan, []))[1].append(s)
        checked = self.health is not None and self.health.check_output
        for plan, group in groups.values():
            try:
                with lane._on_lane_stream():
                    lane._gang_for(plan).ensure(group, self.max_stack, checked)
            except Exception:  # noqa: BLE001 - adoption is advisory
                pass

    def _is_worker_thread(self) -> bool:
        """True on a lane's dispatcher or drain thread: the tier manager's
        refactor-revival must not block on the factor lane from one (a
        worker waiting on its own queue would deadlock)."""
        t = threading.current_thread()
        return any(t is ln._dispatcher or t is ln._drainer for ln in self._lanes)

    # ------------------------------------------------------------------ #
    # durable checkpoint and warm restart
    # ------------------------------------------------------------------ #

    def checkpoint(self, path: str, sessions=None, names=None, *, base=None, gen=None,
                   full=True) -> dict:
        """Snapshot the served fleet to `path` at a drain barrier.

        Admission holds (both `on_full` policies wait briefly; factor
        submissions shed) while the engine waits for `pending == 0`, so the
        snapshot sees no mutation in flight: a consistent cut of every
        session's factors, base, Woodbury state, probe row and counters
        across every tier, without moving anything (`tier.save_fleet`).
        `sessions` defaults to the attached residency's fleet. Restored
        sessions (`restore`) solve bitwise like their pre-checkpoint
        selves. Returns {name: record dir}. `base`/`gen`/`full` pass
        through to `tier.save_fleet`'s incremental generations."""
        if sessions is None and self.residency is None:
            raise ValueError("checkpoint() needs sessions= when the engine has no "
                             "residency-managed fleet")
        from conflux_tpu_torch import tier

        with self._ckpt_lock:
            with self._lock:
                self._draining = True
                while self._pending and not self._closed:
                    self._not_full.wait()
            try:
                if sessions is None:
                    # resolved at the barrier: sessions adopted while this
                    # call queued behind another checkpoint make this one
                    sessions = self.residency.sessions()
                return tier.save_fleet(path, sessions, names, base=base, gen=gen, full=full)
            finally:
                with self._lock:
                    self._draining = False
                    self._not_full.notify_all()

    def restore(self, path: str) -> list:
        """Rebuild a `checkpoint()` fleet on this engine's card: plans
        from their exact specs, sessions with their full state and
        counters. With a residency attached the sessions come back
        host-tier and fault in as traffic touches them (restore costs file
        reads, capacity stays bounded); without one they restore resident.
        Returns the sessions in checkpoint order."""
        from conflux_tpu_torch import tier

        return tier.load_fleet(path, residency=self.residency,
                               device=self._lanes[0].device)

    # ------------------------------------------------------------------ #
    # prewarming
    # ------------------------------------------------------------------ #

    def prewarm(self, target, widths=(1,), stacks=(), factor_batches=(), update_ranks=(),
                precisions=(), wait: bool = True):
        """Warm the declared traffic's buckets before it lands: one warm-up
        dispatch each pays the kernels' first-use build (`ops/_build.py`)
        and first launch, and fills the lane's pinned staging pool at the
        bucket's sizes.

        `target` is a SolveSession (solve-lane warming) or a FactorPlan
        (factor-lane warming only). `widths` are RHS widths (rounded up to
        power-of-two buckets: include the coalesced widths you expect),
        `stacks` gang stack sizes (single-system plans; with
        `update_ranks`, the stacked Woodbury programs of those rank
        buckets too), `factor_batches` coalesced cold-start batch sizes
        (`(1, 2, ..., max_factor_batch)` covers every bucket). Warms the
        checked programs when the engine's policy checks outputs.
        `precisions` warms the served tiers' program families ('auto': the
        whole ladder, checked). Each warming dispatch runs on the lane's
        stream and is waited for. `wait=False` warms on a background
        thread and returns it."""
        plan = target if isinstance(target, FactorPlan) else target.plan
        session = None if isinstance(target, FactorPlan) else target
        tiers: list = []
        auto = False
        for p in precisions:
            p2 = serve.check_precision_request(p)
            if p2 == "auto":
                auto = True
                tiers += [t for t in serve.PRECISION_TIERS if t not in tiers]
            elif p2 is not None and p2 not in tiers:
                tiers.append(p2)

        def run():
            lane = self._lanes[0]
            with profiler.region("engine.prewarm"), lane._on_lane_stream():
                if session is not None:
                    with session._lock:  # a spilled target faults in
                        session._ensure_resident()
                order_after_default(lane.device)
                if session is not None:
                    for wb in sorted({rank_bucket(w) for w in widths}):
                        self._prewarm_width(session, wb)
                        for t in tiers:
                            self._prewarm_tier_width(session, t, wb, auto)
                        for s in stacks:
                            self._prewarm_stack(session, rank_bucket(s), wb, update_ranks)
                for fbk in sorted({rank_bucket(n) for n in factor_batches}):
                    self._prewarm_factor(plan, fbk)
                    for t in tiers:
                        self._prewarm_tier_factor(plan, t, fbk)
                if lane.cuda:
                    lane.stream.synchronize()

        if wait:
            run()
            return None
        t = threading.Thread(target=run, name="serve-engine-prewarm", daemon=True)
        t.start()
        return t

    def _staged(self, host: torch.Tensor, device) -> torch.Tensor:
        """A warm-up input moved to `device` as traffic moves its staged
        buffers (through pinned host memory, a non-blocking copy), so the
        pinned allocator holds buffers of the bucket's sizes before the
        first request needs them."""
        pinned, _ = self._lanes[0]._host_buffer(host.shape, host.dtype)
        pinned.copy_(host)
        return self._lanes[0]._h2d(pinned, device)

    def _collect(self, *outs) -> None:
        """Copy warm-up outputs to pinned host buffers as the drain receives
        answers and verdicts, and wait for the lane."""
        lane = self._lanes[0]
        for x in outs:
            lane._d2h(x)
        if lane.cuda:
            lane.stream.synchronize()

    def _zeros_rhs(self, session, wb: int) -> torch.Tensor:
        plan = session.plan
        shape = (plan.B, plan.N, wb) if plan.batched else (plan.M, wb)
        return self._staged(torch.zeros(shape, dtype=serve._torch_dtype(plan.key.dtype)),
                            session.device)

    def _prewarm_width(self, session, wb: int) -> None:
        """Warm one RHS bucket (deduplicated through the plan's per-device
        warm registry)."""
        plan = session.plan
        checked = self.health is not None and self.health.check_output
        kind = "solve_health" if checked else "solve"
        dk = _devkey(session.device)
        if plan.device_warm(kind, wb, dk):
            return
        b2 = self._zeros_rhs(session, wb)
        with session._lock:
            session._ensure_resident()
            session._lane_reads_base()
            F, A, A0 = session._factors, session._A, session._A0
            probe = session._probe_row() if checked else None
        if checked:
            self._collect(*plan._solve_health_fn(wb)(F, A0, probe, b2))
        else:
            self._collect(plan._solve_fn(wb)(F, A, b2))
        plan.mark_device_warm(kind, wb, dk)

    def _prewarm_stack(self, session, sb: int, wb: int, update_ranks=()) -> None:
        """Warm the gang's stacked programs for one (stack, width) bucket:
        the plain stacked solve (or the checked per-slot form when the
        policy checks outputs) and, per rank bucket of `update_ranks`, the
        stacked Woodbury programs a drifting gang dispatches, fed zero
        drift state (the clean slot's shape)."""
        plan = session.plan
        if plan.batched:
            raise ValueError("stacks= prewarming applies to single-system plans only")
        checked = self.health is not None and self.health.check_output
        kind = "stacked_health" if checked else "stacked"
        # the checked and unchecked Woodbury programs are warmed apart
        ukind = "stacked_usolve_health" if checked else "stacked_usolve"
        dk = _devkey(session.device)
        ranks = sorted({rank_bucket(k) for k in update_ranks
                        if not plan.device_warm(ukind, (sb, rank_bucket(k), wb), dk)})
        if plan.device_warm(kind, (sb, wb), dk) and not ranks:
            return
        with session._lock:
            session._ensure_resident()
            session._lane_reads_base()
            F0, A0, A0full = session._factors, session._A, session._A0
            probe = session._probe_row() if checked else None
        F = stack_trees([F0] * sb)
        A = None if A0 is None else torch.stack([A0] * sb)
        wA = None if probe is None else torch.stack([probe] * sb)
        b = self._staged(torch.zeros((sb, plan.N, wb),
                                     dtype=serve._torch_dtype(plan.key.dtype)),
                         session.device)
        if not plan.device_warm(kind, (sb, wb), dk):
            if checked:
                self._collect(*plan._stacked_solve_health_fn(sb, wb)(F, A, wA, b))
            else:
                self._collect(plan._stacked_solve_fn(sb, wb)(F, A, b))
            plan.mark_device_warm(kind, (sb, wb), dk)
        sweeps = plan.key.refine + session.policy.refine
        A0s = torch.stack([A0full] * sb) if sweeps else None
        for kb in ranks:
            z = zero_update_state(plan.N, kb, serve._torch_dtype(plan.key.dtype),
                                  serve._torch_dtype(plan.key.factor_dtype),
                                  device=session.device)
            Up, Vp, Y, Ci = (torch.stack([t] * sb) for t in z)
            if checked:
                self._collect(*plan._stacked_update_solve_health_fn(sb, kb, wb, sweeps)(
                    F, A0s, Up, Vp, Y, Ci, wA, b))
            else:
                self._collect(plan._stacked_update_solve_fn(sb, kb, wb, sweeps)(
                    F, A0s, Up, Vp, Y, Ci, b))
            plan.mark_device_warm(ukind, (sb, kb, wb), dk)

    def _identity_stack(self, plan, bb: int) -> torch.Tensor:
        """(bb,) + shape identity matrices staged to the lane device: the
        warm-up input (well-conditioned for every kind and substitution),
        the filler the pad slots use."""
        eye = torch.eye(*plan.key.shape[-2:], dtype=serve._torch_dtype(plan.key.dtype))
        return self._staged(eye.expand((bb,) + plan.key.shape), self._lanes[0].device)

    def _prewarm_factor(self, plan, bb: int) -> None:
        checked = self.health is not None and self.health.check_output
        kind = "factor_health" if checked else "factor"
        dk = _devkey(self._lanes[0].device)
        if plan.device_warm(kind, bb, dk):
            return
        Ad = self._identity_stack(plan, bb)
        if checked:
            self._collect(plan._factor_health_fn(bb)(Ad)[2])
        else:
            plan._stacked_factor_fn(bb)(Ad)
            self._collect()
        plan.mark_device_warm(kind, bb, dk)

    def _prewarm_tier_width(self, session, tier: str, wb: int, auto: bool = False) -> None:
        """Warm one served tier's solve program for one RHS bucket ('auto'
        traffic always dispatches the checked tier form). Warming a
        cross-tier bucket also builds the session's derived tier
        factors."""
        plan = session.plan
        checked = auto or (self.health is not None and self.health.check_output)
        kind = "tier_health" if checked else "tier"
        dk = _devkey(session.device)
        if plan.device_warm(kind, (tier, wb), dk):
            return
        b2 = self._zeros_rhs(session, wb)
        with session._lock:
            session._ensure_resident()
            session._lane_reads_base()
            F = (session._factors if tier == session._served_tier
                 else session._tier_factor(tier))
            A0 = session._A0
            probe = session._probe_row() if checked else None
        if checked:
            self._collect(*plan._tier_solve_health_fn(tier, wb)(F, A0, probe, b2))
        else:
            self._collect(plan._tier_solve_fn(tier, wb)(F, A0, b2))
        plan.mark_device_warm(kind, (tier, wb), dk)

    def _prewarm_tier_factor(self, plan, tier: str, bb: int) -> None:
        """Warm one served tier's coalesced factor bucket (tier factor
        batches dispatch unchecked)."""
        dk = _devkey(self._lanes[0].device)
        if plan.device_warm("tier_factor", (tier, bb), dk):
            return
        plan._tier_stacked_factor_fn(tier, bb)(self._identity_stack(plan, bb))
        self._collect()
        plan.mark_device_warm("tier_factor", (tier, bb), dk)

    # ------------------------------------------------------------------ #
    # resolution ownership and failure bookkeeping
    # ------------------------------------------------------------------ #

    def _take(self, reqs) -> set:
        """Claim resolution ownership: only requests still in `_live` are
        returned, and their pending slots are released. The claimer, and
        nobody else, resolves their futures."""
        with self._lock:
            owned = {r for r in reqs if r in self._live}
            self._live.difference_update(owned)
            self._pending -= len(owned)
            self._not_full.notify_all()
        return owned

    def _fail(self, reqs, exc: Exception) -> None:
        owned = self._take(reqs)
        with self._lock:
            self._failed += len(owned)
            st = self._qos
            if st is not None:
                for r in owned:
                    if r.qos is not None:
                        st.record_fail(r.qos, r.cost)
        for r in owned:
            r.future.set_exception(exc)

    def _settle(self, spec, xh) -> None:
        """Resolve a drained batch: each request's answer is a numpy view
        of the batch's one host buffer."""
        now = time.perf_counter()
        owned = self._take([r for r, _si, _lo in spec])
        with self._lock:
            for r in owned:
                self._latencies.append(now - r.t_submit)
            self._lat_seq += len(owned)
            self._completed += len(owned)
            st = self._qos
            if st is not None:
                for r in owned:
                    if r.qos is not None:
                        st.record_settle(r.qos, now - r.t_submit, r.cost)
        for r, si, lo in spec:
            if r not in owned:
                continue
            xs = xh[..., lo:lo + r.width] if si is None else xh[si, :, lo:lo + r.width]
            if r.squeeze:
                xs = xs[..., 0]
            r.future.set_result(xs)

    def _limit(self, session) -> float:
        return self._plan_limit(session.plan)

    def _plan_limit(self, plan) -> float:
        # 'auto' requests carry a verdict even on an unguarded engine: the
        # default HealthPolicy gives the residual limit then
        policy = self.health if self.health is not None else HealthPolicy()
        if plan.key.dtype == "bfloat16":
            if policy.residual_limit is not None:
                return float(policy.residual_limit)
            return 1e4 * torch.finfo(torch.bfloat16).eps * math.sqrt(max(1, plan.N))
        return policy.resolved_residual_limit(np.dtype(plan.key.dtype), plan.N)

    # ------------------------------------------------------------------ #
    # watchdog: a dead worker fails pending work instead of queueing
    # ------------------------------------------------------------------ #

    def _lane_died(self, lane, thread, exc: BaseException) -> None:
        """Post-mortem hook on a dying lane worker: record the cause and
        trip the watchdog at once (one lane: the whole engine trips)."""
        lane._dead = (thread.name, exc)
        self._dead = (thread.name, exc)
        self._watchdog_trip([thread.name], exc)

    # futures-owner
    def _watchdog_trip(self, names, exc) -> None:
        resilience.bump("watchdog_trips")
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            leftover = list(self._live)
        self._fail(leftover, EngineClosed(
            f"engine worker thread(s) {names} died"
            + (f" ({exc!r})" if exc is not None else "")
            + f": {len(leftover)} pending request(s) failed by the watchdog instead of "
            "queueing forever"))
        # unwedge whichever workers survived
        for lane in self._lanes:
            lane._inq.put(_STOP)
            try:
                lane._outq.put_nowait(_STOP)
            # conflint: disable=CFX-FUTURE a full outq already wakes the drain; nothing owned here
            except Full:
                pass

    def _watchdog_loop(self) -> None:
        while True:
            time.sleep(self.watchdog_interval)
            # conflint: disable=CFX-LOCK benign racy poll; a stale read only delays one tick
            if self._closed:
                return
            lane = self._lanes[0]
            dead = [t.name for t in (lane._dispatcher, lane._drainer) if not t.is_alive()]
            if dead:
                exc = lane._dead[1] if lane._dead is not None else None
                self._watchdog_trip(dead, exc)
                return

    # ------------------------------------------------------------------ #
    # observability (merged into profiler.serve_stats()['engine'])
    # ------------------------------------------------------------------ #

    def counters(self) -> dict:
        """The counter and gauge snapshot without the percentile sorts: the
        cheap read windowed telemetry (`profiler.StatsWindow`) takes."""
        with self._lock:
            out = {
                "pending": self._pending,
                "queue_peak": self._queue_peak,
                "requests": self._requests,
                "completed": self._completed,
                "failed": self._failed,
                "shed": self._sheds,
                "batches": self._batches,
                "coalesced_requests": self._coalesced_requests,
                "factor_requests": self._factor_requests,
                "factor_batches": self._factor_batches,
                "factor_coalesced_requests": self._factor_coalesced,
                "factor_slots": self._factor_slots,
                "factor_pad_slots": self._factor_pad,
                "width_capped": self._width_capped,
                "gang_batches": self._gang_batches,
                "gang_coalesced_requests": self._gang_coalesced,
                "gang_opportunity": self._gang_opportunity,
                "stack_exclusions": dict(self._stack_exclusions),
                "gang": self._gang_locked(),
                "bucket_hits": dict(self._bucket_hits),
                "factor_bucket_hits": dict(self._factor_bucket_hits),
                "lanes": self._lane_rows_locked(),
            }
            if self._qos is not None:
                out["qos"] = self._qos.counters(self.max_pending)
            return out

    # requires-lock: _lock
    def _gang_locked(self) -> dict:
        """Gang gauges summed over the lane's gangs (racy reads of monotone
        counters by design)."""
        gangs = members = slots = adopts = releases = refreshes = rebuilds = 0
        for ln in self._lanes:
            for g in ln._gangs.values():
                gangs += 1
                members += len(g._by_id)
                slots += g.cap
                adopts += g.adopts
                releases += g.releases
                refreshes += g.refreshes
                rebuilds += g.rebuilds
        return {"gangs": gangs, "sessions": members, "capacity_slots": slots,
                "adopts": adopts, "releases": releases, "refreshes": refreshes,
                "rebuilds": rebuilds}

    # requires-lock: _lock
    def _lane_rows_locked(self) -> list:
        """Per-lane telemetry rows (no sorting)."""
        now = time.perf_counter()
        rows = []
        for ln in self._lanes:
            wall = max(1e-9, now - ln.t_start)
            busy = max(ln.busy_dispatch_s, ln.busy_drain_s)
            rows.append({
                "lane": ln.index,
                "device": str(ln.device),
                "delay": ln.delay,
                "batches": ln.batches,
                "coalesced_requests": ln.coalesced,
                "coalesced_mean": ln.coalesced / ln.batches if ln.batches else 0.0,
                "factor_batches": ln.factor_batches,
                "factor_coalesced_requests": ln.factor_coalesced,
                "gang_batches": ln.gang_batches,
                "gang_coalesced_requests": ln.gang_coalesced,
                "bucket_hits": dict(ln.bucket_hits),
                "pending": ln.pending,
                "sheds": ln.sheds,
                "queue_depth": ln._inq.qsize(),
                "queue_peak": ln.queue_hw,
                "occupancy": min(1.0, busy / wall),
                "revives": ln.revives,
                "dead": ln.dead,
            })
        return rows

    def stats(self) -> dict:
        """Engine counters: queue high-water, batches, mean coalesced
        batch, sheds, p50/p95/p99 request latency over the rolling window,
        the factor lane's counters (batches, mean coalesced batch, pad
        waste, session-open latency percentiles), the gang counters and
        the knobs. Health outcomes are global:
        `profiler.serve_stats()['health']`."""
        with self._lock:
            lats = sorted(self._latencies)
            flats = sorted(self._factor_latencies)
            batches = self._batches
            fbatches = self._factor_batches
            out = {
                "pending": self._pending,
                "queue_peak": self._queue_peak,
                "requests": self._requests,
                "completed": self._completed,
                "failed": self._failed,
                "shed": self._sheds,
                "batches": batches,
                "coalesced_requests": self._coalesced_requests,
                "coalesced_mean": self._coalesced_requests / batches if batches else 0.0,
                "latency_p50_ms": 1e3 * _percentile(lats, 50),
                "latency_p95_ms": 1e3 * _percentile(lats, 95),
                "latency_p99_ms": 1e3 * _percentile(lats, 99),
                "factor_requests": self._factor_requests,
                "factor_batches": fbatches,
                "factor_coalesced_requests": self._factor_coalesced,
                "factor_coalesced_mean": self._factor_coalesced / fbatches if fbatches else 0.0,
                "factor_slots": self._factor_slots,
                "factor_pad_slots": self._factor_pad,
                "factor_pad_waste": (self._factor_pad / self._factor_slots
                                     if self._factor_slots else 0.0),
                "factor_latency_p50_ms": 1e3 * _percentile(flats, 50),
                "factor_latency_p95_ms": 1e3 * _percentile(flats, 95),
                "factor_latency_p99_ms": 1e3 * _percentile(flats, 99),
                "width_capped": self._width_capped,
                "gang_batches": self._gang_batches,
                "gang_coalesced_requests": self._gang_coalesced,
                "gang_coalesced_mean": (self._gang_coalesced / self._gang_batches
                                        if self._gang_batches else 0.0),
                "gang_opportunity": self._gang_opportunity,
                "stack_exclusions": dict(self._stack_exclusions),
                "gang": self._gang_locked(),
                "bucket_hits": dict(self._bucket_hits),
                "factor_bucket_hits": dict(self._factor_bucket_hits),
                "lanes": self._lane_rows_locked(),
                "knobs": self._knobs_locked(),
            }
            psc = pfb = 0
            for ref in self._active_sessions.values():
                s = ref()
                if s is not None:
                    psc += s.precision_escalations
                    pfb += s.precision_fallbacks
            out["precision_escalations"] = psc
            out["precision_fallbacks"] = pfb
            if self._qos is not None:
                out["qos"] = self._qos.stats(self.max_pending)
        if self.residency is not None:
            # outside the engine lock: the manager takes its own
            out["tier"] = self.residency.stats()
            if self._lanes[0].cuda:
                # the allocator's view beside the tier's accounting (the
                # caching allocator keeps freed blocks)
                out["tier"]["memory_allocated"] = torch.cuda.memory_allocated(
                    self._lanes[0].device)
        if self._controller is not None:
            out["controller"] = self._controller.stats()
        return out

    def latency_samples(self) -> list:
        """The rolling latency window in seconds."""
        with self._lock:
            return list(self._latencies)

    def factor_latency_samples(self) -> list:
        """The factor lane's rolling session-open latency window in
        seconds."""
        with self._lock:
            return list(self._factor_latencies)

    @staticmethod
    def _window(seq: int, ring, token):
        lats = list(ring)
        if token is None:
            return seq, lats
        n = min(len(lats), max(0, seq - token))
        return seq, lats[len(lats) - n:] if n else []

    def latency_window(self, token: int | None = None) -> tuple:
        """(new_token, samples): the latencies recorded since `token` (a
        sequence number from a previous call; None: the whole ring). If
        more samples landed than the ring holds, the ring's contents are
        returned."""
        with self._lock:
            return self._window(self._lat_seq, self._latencies, token)

    def factor_latency_window(self, token: int | None = None) -> tuple:
        """`latency_window` for the factor lane's session-open window."""
        with self._lock:
            return self._window(self._flat_seq, self._factor_latencies, token)

    def qos_latency_samples(self) -> dict:
        """Per-class rolling latency windows in seconds, keyed
        'tenant/tier' ({} on an engine without QoS state)."""
        with self._lock:
            st = self._qos
            if st is None:
                return {}
            return {k: list(d) for k, d in st.latencies.items()}

    def qos_latency_window(self, key: str, token: int | None = None) -> tuple:
        """:meth:`latency_window` for one QoS class's ring; a class the
        engine has not seen reads as (0, [])."""
        with self._lock:
            st = self._qos
            if st is None or key not in st.latencies:
                return 0, []
            return self._window(st.lat_seq[key], st.latencies[key], token)
