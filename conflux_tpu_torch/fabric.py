"""Multi-host serve fabric — federated engines behind one front (DESIGN §28).

One :class:`ServeFabric` federates N engine *hosts* — each a full
serve stack (ServeEngine + its session registry) living in its own
process — behind a single routing front:

- **Routing** rides the same rendezvous hash as device placement
  (`engine.rendezvous`): a session id maps to the live host whose
  (sid, host-id) weight is highest, so a host-set change remaps ONLY
  the dead host's sessions (~1/N of the fleet) instead of reshuffling
  everyone. The owners map is authoritative AFTER placement — fail-over
  and migration move entries explicitly; healthy sessions never move
  just because the live set changed.
- **Detection** is a heartbeat/lease loop with hysteresis: every
  `heartbeat_interval` the front pings each host; a miss moves
  alive → suspect (`suspect_after` misses) → dead (`dead_after`), and a
  torn transport (EOF/conn-reset — the process is demonstrably gone)
  jumps straight to dead. Per-host :class:`~conflux_tpu_torch.resilience.
  CircuitBreaker`s shed request traffic from flapping hosts between
  heartbeats.
- **Fail-over** revives a dead host's fleet on the survivors from its
  last background checkpoint (`tier.load_fleet` with the `names=`
  subset filter — each survivor adopts exactly the records the
  rendezvous hash assigns it). Revived sessions solve BITWISE
  identically (the checkpoint contract); staleness is bounded by one
  `checkpoint_interval` of drift updates. Sessions that were never
  checkpointed are reported lost — their requests fail with a
  structured :class:`~conflux_tpu_torch.resilience.HostUnavailable`, never
  hang.
- **Migration** hands a live session between hosts at a drain barrier:
  the source checkpoints exactly that session (`engine.checkpoint`
  waits out in-flight work), the target adopts the record, ownership
  flips, the source drops its copy. A crash before the target adopts
  leaves the session intact on the source.
- **Elastic membership** (DESIGN §34): `add_host` joins at runtime
  (adopt-on-arrival — nobody reshuffles), `remove_host` leaves via a
  ``draining`` state + per-sid migration storm (a crash mid-drain
  leaves undrained sessions on the still-live source), retired ids
  never resurrect, and `rebalance` drains induced skew at a bounded
  rate. With ``FabricPolicy.replicas`` ≥ 2, each checkpointed
  session's record is also pushed to the next K-1 hosts on its
  rendezvous-RANKED list, and fail-over becomes re-point-to-standby:
  the standby adopts from its LOCAL replica store, no cross-host
  snapshot read, with restore-from-snapshot demoted to the fallback.
  `conflux_tpu_torch.control.FabricAutoscaler` drives grow/shrink/rebalance
  decisions behind a ``HostProvider`` callback.

Request traffic raises structured errors, never hangs:
:class:`~conflux_tpu_torch.resilience.HostUnavailable` (dead/flapping owner,
`retry_after` riding the fleet's measured drain rate —
:class:`~conflux_tpu_torch.control.HostLoadEstimator`) and
:class:`~conflux_tpu_torch.resilience.FleetDegraded` (admission refused
below `min_live` live hosts).

Two host flavors share one op core (:class:`_HostCore`):
:class:`LocalHost` runs the engine in-process (deterministic tests,
lockcheck soaks, fault drills) and :class:`ProcessHost` spawns
``python -m conflux_tpu_torch.fabric --worker`` wired over an authenticated
``multiprocessing.connection`` AF_UNIX pipe (the real fabric; see
scripts/torch_fabric_drill.py). Each host's engine runs on the card unless
its ``engine_kwargs`` say ``"device": "cpu"``; several worker processes may
share one card, each with its own CUDA context. Checkpoint
records live on a filesystem shared by front and hosts (same box or
shared mount) — the front reads a dead host's snapshot directly and
points survivors at it.

Fault injection (`resilience.FaultPlan`) covers the fabric control
plane: 'heartbeat' (delay/crash — a slow or failed probe, the
hysteresis driver), 'route' (crash/delay on the front's per-request
host call), 'migrate' (crash/delay at the hand-off barrier) and
'host_kill' (kill — a whole engine host dies). `scripts/torch_soak.py
--fabric` drives randomized kill/revive/migrate chaos against per-
session float64 oracles.
"""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from multiprocessing.connection import Client, Listener
from typing import Any

import numpy as np

from conflux_tpu_torch import resilience, tier
from conflux_tpu_torch import wire as wire_mod
from conflux_tpu_torch import qos as qos_mod
from conflux_tpu_torch.control import HostLoadEstimator
from conflux_tpu_torch.profiler import CounterWindow
from conflux_tpu_torch.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    FleetDegraded,
    HostUnavailable,
    InjectedFault,
    InjectedKill,
    MeshPlanUnsupported,
    RestoreCorrupt,
    RhsNonFinite,
    SessionQuarantined,
    SessionSpilled,
    SolveUnhealthy,
    TenantThrottled,
    WireCorrupt,
    bump,
    maybe_fault,
)
from conflux_tpu_torch.wire import WireConfig

__all__ = [
    "FabricPolicy", "HostHandle", "LocalHost", "ProcessHost",
    "ServeFabric", "fabric_stats", "latest_checkpoint", "record_name",
    "local_fabric", "process_fabric", "worker_main",
]

# errors raised by the wire/transport layer (NOT by the remote op):
# the front maps these to HostUnavailable + breaker bookkeeping.
# TimeoutError and ConnectionError both subclass OSError.
_TRANSPORT_ERRORS = (OSError, EOFError)

_LATEST = "LATEST"


# --------------------------------------------------------------------------- #
# checkpoint record naming + generation bookkeeping
# --------------------------------------------------------------------------- #


def record_name(sid: Any) -> str:
    """Deterministic, filesystem-safe record name for a session id.

    Successive checkpoints of the same fleet reuse names, so a
    snapshot directory's population tracks the live registry; the
    CRC suffix keeps two sids that sanitize identically apart."""
    s = str(sid)
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in s)
    return f"{safe[:48]}-{zlib.crc32(s.encode()):08x}"


def _write_latest(ckpt_dir: str, dest: str) -> None:
    """Atomically point ckpt_dir/LATEST at `dest` (a fleet snapshot
    subdir). Write-tmp-then-replace: a crash mid-checkpoint leaves
    LATEST on the previous complete snapshot."""
    tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(tmp, "w") as f:
        f.write(os.path.basename(dest))
    os.replace(tmp, os.path.join(ckpt_dir, _LATEST))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The host's newest COMPLETE fleet snapshot dir, or None if it
    never finished one (LATEST is written only after save_fleet
    returns, so the pointer never names a half-written snapshot)."""
    p = os.path.join(ckpt_dir, _LATEST)
    try:
        with open(p) as f:
            name = f.read().strip()
    except OSError:
        return None
    dest = os.path.join(ckpt_dir, name)
    return dest if os.path.isdir(dest) else None


def _snapshot_gen(snap: str | None) -> int:
    """The fleet-NNNNNN sequence number of a snapshot dir — the
    K-replica coherence token (DESIGN §34): a standby's replica is
    trusted at fail-over only when its pushed generation is ≥ the
    corpse's latest snapshot generation, i.e. re-pointing never rolls
    a session back further than the snapshot restore would. -1 when
    the host never completed a snapshot (any replica then wins)."""
    if snap is None:
        return -1
    try:
        return int(os.path.basename(snap).split("-", 1)[1])
    except (IndexError, ValueError):
        return -1


def checkpoint_sids(snapshot: str) -> dict[Any, str]:
    """{sid: record name} for a fleet snapshot — the fail-over front's
    view of WHICH sessions a dead host's checkpoint can revive."""
    with open(os.path.join(snapshot, "fleet.json")) as f:
        fleet = json.load(f)
    return {e["sid"]: e["name"] for e in fleet["sessions"]
            if e.get("sid") is not None}


def checkpoint_manifest(snapshot: str) -> dict[Any, tuple[str, int]]:
    """{sid: (record name, record WRITE generation)} for a fleet
    snapshot — the name for adoption, the generation for the §35
    dirty gates: replica pushes skip standbys already holding the
    record's exact bytes, and fail-over's re-point gate refuses only
    genuinely stale standbys (a session unchanged since generation g
    is coherent on any standby pushed at ≥ g, however many delta
    generations have passed). Format-1 entries (no per-record gen)
    report the snapshot's own generation — the pre-§35 conservative
    gate, bitwise the old behavior."""
    with open(os.path.join(snapshot, "fleet.json")) as f:
        fleet = json.load(f)
    default = int(fleet.get("gen", _snapshot_gen(snapshot)))
    return {e["sid"]: (e["name"], int(e.get("gen", default)))
            for e in fleet["sessions"] if e.get("sid") is not None}


# --------------------------------------------------------------------------- #
# policy
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class FabricPolicy:
    """Fabric-front knobs (TUNING.md "Multi-host fabric").

    heartbeat_interval: seconds between heartbeat rounds.
    heartbeat_timeout: per-ping reply budget; an overrun is a miss.
    suspect_after / dead_after: consecutive-miss thresholds of the
        alive → suspect → dead hysteresis (dead_after > suspect_after;
        worst-case detection ≈ dead_after * (interval + timeout)).
        A torn transport skips the ladder — the process is gone.
    call_timeout: default reply budget for request-path host calls.
    checkpoint_interval: background fleet-checkpoint period per host;
        0 disables (fail-over then recovers only durable opens and
        explicit checkpoints). Bounds fail-over staleness to one
        interval of drift updates.
    checkpoint_keep: completed snapshot generations kept per host.
    checkpoint_compact_every: delta-checkpoint cadence (DESIGN §35) —
        every Nth generation is a self-contained full compaction;
        the generations between carry clean (unmutated) sessions as
        references into earlier generations, so a steady-state
        checkpoint costs O(dirty sessions), not O(fleet). <= 1 makes
        every generation full (the pre-§35 behavior). Disk held
        grows with the reference chain: worst case
        checkpoint_keep + checkpoint_compact_every generations.
    durable_open: checkpoint the owning host synchronously after every
        `open` — every admitted session is recoverable from birth (the
        soak's session-count conservation oracle). Costs one fleet
        snapshot per open; high-churn deployments turn it off and
        lean on the background interval.
    min_live: below this many live hosts, `open` refuses with
        :class:`FleetDegraded` (solves on live owners still run).
    breaker_threshold / breaker_cooldown: per-host CircuitBreaker —
        transport failures on the REQUEST path trip it; a tripped
        host sheds with HostUnavailable until its cooldown probe.
    retry_floor / retry_ceil: clamp on retry_after hints
        (:class:`~conflux_tpu_torch.control.HostLoadEstimator`).
    replicas: K-replica placement (DESIGN §34). 1 (default) is the
        pre-§34 fabric: fail-over restores from the dead host's own
        snapshot. K ≥ 2 pushes each checkpointed session's record to
        the next K-1 hosts on its rendezvous-RANKED candidate list
        (`engine.rendezvous_ranked`), so fail-over re-points to a
        standby that adopts from its LOCAL replica record — no
        cross-host snapshot read; restore-from-snapshot demotes to
        the fallback for sids whose live standbys are stale or gone.
    """

    heartbeat_interval: float = 0.25
    heartbeat_timeout: float = 2.0
    suspect_after: int = 2
    dead_after: int = 4
    call_timeout: float = 120.0
    checkpoint_interval: float = 0.0
    checkpoint_keep: int = 2
    checkpoint_compact_every: int = 8
    durable_open: bool = True
    min_live: int = 1
    breaker_threshold: int = 3
    breaker_cooldown: float = 5.0
    retry_floor: float = 0.05
    retry_ceil: float = 5.0
    replicas: int = 1

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.heartbeat_interval <= 0 or self.heartbeat_timeout <= 0:
            raise ValueError("heartbeat_interval and heartbeat_timeout "
                             "must be > 0")
        if not (1 <= self.suspect_after < self.dead_after):
            raise ValueError("need 1 <= suspect_after < dead_after "
                             f"(got {self.suspect_after}, "
                             f"{self.dead_after})")
        if self.min_live < 1:
            raise ValueError("min_live must be >= 1")
        if self.checkpoint_interval < 0 or self.checkpoint_keep < 1:
            raise ValueError("checkpoint_interval must be >= 0 and "
                             "checkpoint_keep >= 1")
        if self.checkpoint_compact_every < 0:
            raise ValueError("checkpoint_compact_every must be >= 0")


# --------------------------------------------------------------------------- #
# the host op core — shared by LocalHost and the worker process
# --------------------------------------------------------------------------- #


class _HostCore:
    """One engine host's op surface: a ServeEngine plus the sid →
    session registry, with the checkpoint/adopt/migrate rails the
    fabric's robustness story rides. `LocalHost` calls it in-process;
    `worker_main` wraps it behind the wire loop."""

    def __init__(self, host_id: str, ckpt_dir: str, engine) -> None:
        self.host_id = str(host_id)
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self.eng = engine
        self.ckpt_keep = 2
        # delta-checkpoint cadence (DESIGN §35): every Nth generation
        # is a self-contained compaction; the rest carry clean
        # sessions as references into earlier generations. <=1 means
        # every generation is full (the pre-§35 behavior).
        self.ckpt_compact_every = 8
        self._lock = threading.Lock()
        self._registry: dict = {}  # guarded-by: _lock — sid -> session
        self._ckpt_seq = 0         # guarded-by: _lock
        # standby records this host holds for OTHER hosts' sessions
        # (DESIGN §34 K-replica placement): name -> generation. Seeded
        # from disk so a restarted worker still answers adopt_replica
        # for records a previous incarnation accepted.
        self._replicas: dict[str, int] = {}  # guarded-by: _lock
        rep_root = os.path.join(ckpt_dir, "replicas")
        if os.path.isdir(rep_root):
            for name in os.listdir(rep_root):
                try:
                    with open(os.path.join(rep_root, name,
                                           "fleet.json")) as f:
                        self._replicas[name] = int(
                            json.load(f).get("gen", 0))
                except (OSError, ValueError, KeyError):
                    continue  # half-written leftover; replaced on push

    # -- telemetry ----------------------------------------------------- #

    def ping(self) -> dict:
        """Heartbeat payload: a cheap counter snapshot (the front's
        CounterWindow diffs it into rates) + the session census."""
        c = self.eng.counters()
        with self._lock:
            n = len(self._registry)
            nrep = len(self._replicas)
        counters = {"pending": c["pending"],
                    "solves": c["completed"],
                    "requests": c["requests"],
                    "failed": c["failed"],
                    "shed": c["shed"]}
        # per-tier drain counters ride as FLAT keys: CounterWindow on
        # the front differences numeric keys only, so the front sees
        # per-class drain rates without a payload schema change
        qc = c.get("qos")
        if qc is not None:
            tiers: dict[str, int] = {}
            for row in qc.get("classes", {}).values():
                t = row.get("tier")
                tiers[t] = tiers.get(t, 0) + int(row.get("completed", 0))
            for t, done in sorted(tiers.items()):
                counters[f"qos_{t}_solves"] = done
        return {"host_id": self.host_id, "sessions": n,
                "replicas": nrep, "counters": counters}

    def stats(self) -> dict:
        with self._lock:
            sids = sorted(str(s) for s in self._registry)
            seq = self._ckpt_seq
        from conflux_tpu_torch.ops import hopper_kernels

        # the process's kernel launches ride along, so a front can count
        # what its worker processes launched
        return {"host_id": self.host_id, "sids": sids,
                "checkpoints": seq, "engine": self.eng.counters(),
                "launches": dict(hopper_kernels.LAUNCHES)}

    # -- session lifecycle --------------------------------------------- #

    def open(self, sid: Any, spec: dict, A: np.ndarray,
             policy: dict | None = None) -> Any:
        """Factor A under the EXACT plan `spec` describes and register
        the session. The plan rebuilds from its wire spec
        (`serve.plan_from_spec`) so every host compiles the same
        program family — the bitwise hand-off contract."""
        from conflux_tpu_torch.serve import plan_from_spec
        from conflux_tpu_torch.update import DriftPolicy

        with self._lock:
            if sid in self._registry:
                raise ValueError(f"sid {sid!r} already open on host "
                                 f"{self.host_id}")
        # a record naming no platform (the JAX package's mesh) resolves on
        # this host's engine device
        plan = plan_from_spec(spec, device=self.eng.devices[0])
        pol = DriftPolicy(**policy) if policy is not None else None
        s = self.eng.factor(plan, A, sid=sid, policy=pol)
        with self._lock:
            self._registry[sid] = s
        return sid

    def _session(self, sid: Any):
        with self._lock:
            s = self._registry.get(sid)
        if s is None:
            raise KeyError(f"host {self.host_id} has no session "
                           f"{sid!r}")
        return s

    def solve_async(self, sid: Any, b: np.ndarray,
                    qos=None) -> Future:
        return self.eng.submit(self._session(sid), b, qos=qos)

    def update(self, sid: Any, U: np.ndarray, V: np.ndarray,
               replace: bool = False) -> bool:
        self._session(sid).update(U, V, replace=replace)
        return True

    def drop(self, sid: Any) -> bool:
        """Forget a session (the migration source's final step)."""
        with self._lock:
            return self._registry.pop(sid, None) is not None

    # -- checkpoint / adopt / migrate rails ---------------------------- #

    def checkpoint(self) -> str:
        """Snapshot the whole registry at the engine's drain barrier
        into a fresh generation dir, flip LATEST, prune old
        generations. Returns the snapshot dir.

        Incremental (DESIGN §35): against the previous LATEST, clean
        sessions (dirty clock unchanged since their last record) are
        carried as single-hop references instead of re-serialized, so
        a steady-state generation costs O(dirty) d2h/IO. Every
        `ckpt_compact_every`-th generation is a full compaction
        (byte-identical local copies, no d2h) so reference chains stay
        bounded and pruning can retire old generations."""
        with self._lock:
            items = sorted(self._registry.items(), key=lambda kv: str(kv[0]))
            seq = self._ckpt_seq
            self._ckpt_seq += 1
        base = latest_checkpoint(self.ckpt_dir)
        every = int(self.ckpt_compact_every)
        full = base is None or every <= 1 or (seq % every == 0)
        dest = os.path.join(self.ckpt_dir, f"fleet-{seq:06d}")
        self.eng.checkpoint(dest, sessions=[s for _, s in items],
                            names=[record_name(sid) for sid, _ in items],
                            base=base, gen=seq, full=full)
        _write_latest(self.ckpt_dir, dest)
        self._prune()
        return dest

    def _prune(self) -> None:
        # reference-aware (DESIGN §35): a delta generation's carried
        # records physically live in OLDER generation dirs. Keep the
        # newest `ckpt_keep` generations plus every generation a kept
        # fleet.json references, so pruning never strands a record a
        # restorable snapshot still needs.
        keep = self.ckpt_keep
        gens = sorted(d for d in os.listdir(self.ckpt_dir)
                      if d.startswith("fleet-"))
        kept = set(gens[-keep:])
        frontier = sorted(kept)
        while frontier:
            d = frontier.pop()
            try:
                with open(os.path.join(self.ckpt_dir, d,
                                       "fleet.json")) as f:
                    entries = json.load(f)["sessions"]
            except (OSError, ValueError, KeyError):
                continue  # unreadable gen: keeps nothing extra
            for e in entries:
                parts = os.path.normpath(e.get("dir", "")).split(os.sep)
                if (len(parts) >= 2 and parts[0] == ".."
                        and parts[1].startswith("fleet-")
                        and parts[1] not in kept):
                    kept.add(parts[1])
                    frontier.append(parts[1])
        for d in gens:
            if d not in kept:
                shutil.rmtree(os.path.join(self.ckpt_dir, d),
                              ignore_errors=True)

    def adopt(self, src: str, names: list[str]) -> list:
        """Restore a `names` subset of another host's snapshot into
        this host's registry (fail-over / migration target half).
        Returns the adopted sids."""
        sessions = tier.load_fleet(src, names=names,
                                   device=self.eng.devices[0])
        with self._lock:
            for s in sessions:
                self._registry[s.sid] = s
        return [s.sid for s in sessions]

    def migrate_out(self, sid: Any, dest: str) -> str:
        """Checkpoint exactly `sid` to `dest` at the engine's drain
        barrier (in-flight solves finish first; nothing else moves).
        The session STAYS registered — the front drops it only after
        the target adopts, so a crash mid-hand-off loses nothing."""
        s = self._session(sid)
        name = record_name(sid)
        self.eng.checkpoint(dest, sessions=[s], names=[name])
        return name

    # -- K-replica standby store (DESIGN §34) -------------------------- #

    def replicate(self, src: str, names: list[str], gen: int) -> list:
        """Accept standby copies of another host's checkpoint records.

        For each `name`, copy its record dir out of the snapshot `src`
        into this host's local `replicas/<name>/` store as a
        one-session fleet (loadable by `tier.load_fleet` without
        touching `src` again — the whole point: fail-over re-points
        here with zero cross-host reads). The swap is
        copy-aside-then-rename, so a crash mid-push leaves either the
        previous complete replica or a `.tmp` leftover the seeding
        scan skips — never a half record. Generations are monotone:
        a stale push (gen older than what this host already holds) is
        skipped, not applied, so out-of-order rounds cannot roll a
        standby backward. Returns the names actually (re)written."""
        with open(os.path.join(src, "fleet.json")) as f:
            entries = {e["name"]: e for e in json.load(f)["sessions"]}
        rep_root = os.path.join(self.ckpt_dir, "replicas")
        os.makedirs(rep_root, exist_ok=True)
        done: list[str] = []
        for name in names:
            e = entries.get(name)
            if e is None:
                raise KeyError(f"snapshot {src} has no record {name!r}")
            with self._lock:
                if self._replicas.get(name, -1) >= gen:
                    continue
            tmp = os.path.join(rep_root, f"{name}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            # resolve through delta references (a carried entry's dir
            # points into an older generation — DESIGN §35) and store
            # the record under its own name, so the replica fleet is
            # self-contained whatever the source entry's shape
            shutil.copytree(os.path.normpath(
                os.path.join(src, e["dir"])),
                os.path.join(tmp, name))
            e = {**e, "dir": name}
            with open(os.path.join(tmp, "fleet.json"), "w") as f:
                json.dump({"format": 1, "gen": int(gen),
                           "sessions": [e]}, f)
            final = os.path.join(rep_root, name)
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(final):
                os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
            with self._lock:
                self._replicas[name] = int(gen)
            done.append(name)
        return done

    def adopt_replica(self, items: list) -> dict:
        """Fail-over re-point (DESIGN §34): restore sessions from this
        host's LOCAL replica store — no cross-host snapshot read.
        `items` is [[sid, name], ...]; each present replica loads via
        the same `tier.load_fleet` rail as snapshot adoption (bitwise
        contract intact) and registers. Missing/corrupt replicas are
        reported, not raised — the front falls back to the snapshot
        path for exactly those sids."""
        rep_root = os.path.join(self.ckpt_dir, "replicas")
        adopted: list = []
        missing: list = []
        for sid, name in items:
            path = os.path.join(rep_root, name)
            try:
                sessions = tier.load_fleet(path, names=[name],
                                           device=self.eng.devices[0])
            except (OSError, KeyError, ValueError, RestoreCorrupt):
                missing.append(sid)
                continue
            with self._lock:
                for s in sessions:
                    self._registry[s.sid] = s
                gen = self._replicas.pop(name, 0)
            shutil.rmtree(path, ignore_errors=True)
            adopted.append([sid, gen])
        return {"adopted": adopted, "missing": missing}

    def drop_replica(self, names: list[str]) -> int:
        """Retire standby records this host no longer ranks for
        (placement moved, session closed, or the primary itself now
        lives here). Best-effort hygiene — a leftover replica is
        harmless (generation-gated) but wastes disk."""
        rep_root = os.path.join(self.ckpt_dir, "replicas")
        n = 0
        for name in names:
            with self._lock:
                had = self._replicas.pop(name, None)
            shutil.rmtree(os.path.join(rep_root, name),
                          ignore_errors=True)
            if had is not None:
                n += 1
        return n

    def wipe(self) -> None:
        """Drop the whole registry (LocalHost.kill: a dead process's
        un-checkpointed state is simply gone)."""
        with self._lock:
            self._registry.clear()
            self._replicas.clear()

    def close(self) -> bool:
        self.eng.close()
        return True


# --------------------------------------------------------------------------- #
# host handles
# --------------------------------------------------------------------------- #


class HostHandle:
    """The front's view of one engine host. Implementations raise
    transport-shaped errors (ConnectionError/TimeoutError/EOFError)
    when the host is unreachable — the front maps those to
    HostUnavailable + breaker/heartbeat bookkeeping, while structured
    per-request errors (EngineSaturated, SolveUnhealthy, ...) pass
    through untouched."""

    host_id: str
    ckpt_dir: str

    def start(self) -> None:
        raise NotImplementedError

    def ping(self, timeout: float | None = None) -> dict:
        raise NotImplementedError

    def open(self, sid, spec, A, policy=None,
             timeout: float | None = None):
        raise NotImplementedError

    def solve(self, sid, b, timeout: float | None = None, qos=None):
        raise NotImplementedError

    def update(self, sid, U, V, replace: bool = False,
               timeout: float | None = None):
        raise NotImplementedError

    def checkpoint(self, timeout: float | None = None) -> str:
        raise NotImplementedError

    def adopt(self, src, names, timeout: float | None = None) -> list:
        raise NotImplementedError

    def migrate_out(self, sid, dest,
                    timeout: float | None = None) -> str:
        raise NotImplementedError

    def replicate(self, src, names, gen,
                  timeout: float | None = None) -> list:
        raise NotImplementedError

    def adopt_replica(self, items,
                      timeout: float | None = None) -> dict:
        raise NotImplementedError

    def drop_replica(self, names,
                     timeout: float | None = None) -> int:
        raise NotImplementedError

    def drop(self, sid, timeout: float | None = None) -> bool:
        raise NotImplementedError

    def stats(self, timeout: float | None = None) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        """Abrupt host death (tests/soak/bench drills)."""
        raise NotImplementedError


class LocalHost(HostHandle):
    """In-process host: the engine runs on this process's threads.

    Deterministic and cheap — the unit tests, the lockcheck soaks and
    the fault drills run the whole fabric in one process. `kill()`
    simulates abrupt process death: the registry is gone and every
    subsequent call raises ConnectionError (transport-shaped), so the
    front exercises the same detection/fail-over path as a real dead
    worker."""

    def __init__(self, host_id: str, ckpt_dir: str, *,
                 engine=None, engine_kwargs: dict | None = None):
        self.host_id = str(host_id)
        self.ckpt_dir = ckpt_dir
        self._engine = engine
        self._engine_kwargs = dict(engine_kwargs or {})
        self._core: _HostCore | None = None
        self._killed = threading.Event()

    def start(self) -> None:
        if self._core is not None:
            return
        eng = self._engine
        if eng is None:
            from conflux_tpu_torch.engine import ServeEngine

            eng = ServeEngine(**self._engine_kwargs)
        self._core = _HostCore(self.host_id, self.ckpt_dir, eng)

    @property
    def core(self) -> _HostCore:
        if self._core is None:
            raise RuntimeError(f"host {self.host_id} not started")
        return self._core

    def _alive_core(self) -> _HostCore:
        if self._killed.is_set():
            raise ConnectionError(f"host {self.host_id} is dead")
        return self.core

    def ping(self, timeout: float | None = None) -> dict:
        return self._alive_core().ping()

    def _engine_op(self, op, *args):
        """Run one engine-backed core op, mapping EngineClosed during
        a concurrent kill() to the transport shape (a real dead worker
        would have torn the pipe mid-call)."""
        from conflux_tpu_torch.engine import EngineClosed

        core = self._alive_core()
        try:
            return op(core, *args)
        except EngineClosed as e:
            if self._killed.is_set():  # killed mid-flight
                raise ConnectionError(
                    f"host {self.host_id} died mid-call") from e
            raise

    def open(self, sid, spec, A, policy=None,
             timeout: float | None = None):
        return self._engine_op(
            lambda c: c.open(sid, spec, A, policy))

    def solve(self, sid, b, timeout: float | None = None, qos=None):
        # admission is inside the op too: a request held at a checkpoint's
        # drain barrier when the host dies fails transport-shaped
        return self._engine_op(
            lambda c: c.solve_async(sid, b, qos=qos).result(timeout))

    def update(self, sid, U, V, replace: bool = False,
               timeout: float | None = None):
        return self._alive_core().update(sid, U, V, replace)

    def checkpoint(self, timeout: float | None = None) -> str:
        return self._engine_op(lambda c: c.checkpoint())

    def adopt(self, src, names, timeout: float | None = None) -> list:
        return self._alive_core().adopt(src, names)

    def migrate_out(self, sid, dest,
                    timeout: float | None = None) -> str:
        return self._engine_op(lambda c: c.migrate_out(sid, dest))

    def replicate(self, src, names, gen,
                  timeout: float | None = None) -> list:
        return self._alive_core().replicate(src, names, gen)

    def adopt_replica(self, items,
                      timeout: float | None = None) -> dict:
        return self._engine_op(lambda c: c.adopt_replica(items))

    def drop_replica(self, names,
                     timeout: float | None = None) -> int:
        return self._alive_core().drop_replica(names)

    def drop(self, sid, timeout: float | None = None) -> bool:
        return self._alive_core().drop(sid)

    def stats(self, timeout: float | None = None) -> dict:
        return self._alive_core().stats()

    def close(self) -> None:
        if self._core is not None and not self._killed.is_set():
            self._core.close()

    def kill(self) -> None:
        if self._killed.is_set():
            return
        self._killed.set()
        # abrupt: un-checkpointed registry state is gone; the engine's
        # close answers whatever already reached a lane, mirroring
        # requests that raced a real process death
        if self._core is not None:
            self._core.eng.close(timeout=2.0)
            self._core.wipe()


# --------------------------------------------------------------------------- #
# wire codec (ProcessHost <-> worker)
# --------------------------------------------------------------------------- #


def _encode_exc(e: BaseException) -> dict:
    extra: dict = {}
    for k in ("retry_after", "evidence", "live", "total", "host",
              "surface", "tenant", "qos_class", "kind"):
        v = getattr(e, k, None)
        if v is not None:
            extra[k] = v
    return {"ok": False, "etype": type(e).__name__,
            "emsg": str(e), "extra": extra}


_WIRE_TYPES: dict[str, Any] = {
    "EngineSaturated": lambda m, x: _mk_engine_exc(
        "EngineSaturated", m, x.get("retry_after", 0.0),
        tenant=x.get("tenant"), qos_class=x.get("qos_class")),
    "EngineClosed": lambda m, x: _mk_engine_exc("EngineClosed", m),
    "TenantThrottled": lambda m, x: TenantThrottled(
        m, retry_after=x.get("retry_after", 0.0),
        tenant=x.get("tenant"), qos_class=x.get("qos_class")),
    "SessionQuarantined": lambda m, x: SessionQuarantined(
        m, retry_after=x.get("retry_after", 0.0)),
    "SessionSpilled": lambda m, x: SessionSpilled(
        m, retry_after=x.get("retry_after", 0.0)),
    "SolveUnhealthy": lambda m, x: SolveUnhealthy(
        m, x.get("evidence") or {}),
    "RestoreCorrupt": lambda m, x: RestoreCorrupt(m, x.get("evidence")),
    "RhsNonFinite": lambda m, x: RhsNonFinite(m),
    "DeadlineExceeded": lambda m, x: DeadlineExceeded(m),
    "MeshPlanUnsupported": lambda m, x: MeshPlanUnsupported(
        m, x.get("surface", "")),
    "HostUnavailable": lambda m, x: HostUnavailable(
        m, retry_after=x.get("retry_after", 0.0), host=x.get("host")),
    "FleetDegraded": lambda m, x: FleetDegraded(
        m, retry_after=x.get("retry_after", 0.0),
        live=x.get("live", 0), total=x.get("total", 0)),
    "KeyError": lambda m, x: KeyError(m),
    "ValueError": lambda m, x: ValueError(m),
    # a corrupt REQUEST record detected worker-side comes back as a
    # per-item error frame: rehydrate it ConnectionError-shaped with
    # its kind/host intact. Deliberately NOT host death (the
    # asymmetry with reply-side corruption): the front wrote that
    # record and its frame-mates validated fine, so the channel
    # itself is still trusted — only reply-side corruption (decode)
    # condemns the host, because there the front can no longer trust
    # anything it reads out of the reply ring.
    "WireCorrupt": lambda m, x: WireCorrupt(
        m, kind=x.get("kind", "torn_segment"), host=x.get("host")),
}


def _mk_engine_exc(name: str, msg: str, retry_after: float | None = None,
                   **attrs):
    from conflux_tpu_torch import engine as _eng

    cls = getattr(_eng, name)
    if retry_after is None:
        return cls(msg)
    return cls(msg, retry_after=retry_after,
               **{k: v for k, v in attrs.items() if v is not None})


def _raise_wire(reply: dict) -> None:
    et = reply.get("etype", "RuntimeError")
    em = reply.get("emsg", "")
    build = _WIRE_TYPES.get(et)
    if build is not None:
        raise build(em, reply.get("extra") or {})
    raise RuntimeError(f"remote {et}: {em}")


class ProcessHost(HostHandle):
    """An engine host in its own worker process.

    `start()` opens an authenticated AF_UNIX listener under
    ``tempfile.gettempdir()`` (a socket path is limited to 108 bytes, so
    not under the checkpoint dir, which may be deep), spawns ``python -m conflux_tpu_torch.fabric --worker``
    (authkey via the CONFLUX_FABRIC_KEY env var — never on the command
    line) and accepts the worker's connection. Requests are
    id-matched: a sender lock serializes writes, a receiver thread
    resolves reply futures, and a torn pipe fails every pending future
    with ConnectionError — an in-flight request on a dying host gets a
    structured error, never a hang.

    With ``wire="shm"`` (the default) solve payloads ride the
    zero-copy shared-memory wire (DESIGN §31, `conflux_tpu_torch.wire`):
    the RHS is staged straight into a per-host request ring and only
    a descriptor crosses the pipe, batched with its frame-mates; the
    answer comes back through the reply ring the same way. Non-array
    ops, oversized payloads and a worker whose reply ring backs up
    all fall back to the pickle wire transparently; ``wire="pickle"``
    is the escape hatch that turns the rings off entirely. A corrupt
    REPLY record (:class:`~conflux_tpu_torch.resilience.WireCorrupt` —
    torn/stale/overrun) means the payload channel can no longer be
    trusted: the worker is killed and every pending request fails
    structurally, exactly like a torn pipe. A corrupt REQUEST record
    detected worker-side fails only its own item (rehydrated
    front-side as WireCorrupt, kind/host intact) — the asymmetry is
    deliberate, see the `_WIRE_TYPES` entry."""

    def __init__(self, host_id: str, ckpt_dir: str, *,
                 engine_kwargs: dict | None = None,
                 start_timeout: float = 180.0,
                 call_timeout: float = 120.0,
                 env: dict | None = None,
                 wire: str = "shm",
                 wire_config: WireConfig | None = None):
        if wire not in ("shm", "pickle"):
            raise ValueError(f"wire must be 'shm' or 'pickle', "
                             f"got {wire!r}")
        self.host_id = str(host_id)
        self.ckpt_dir = ckpt_dir
        self._engine_kwargs = dict(engine_kwargs or {})
        self._start_timeout = float(start_timeout)
        self._call_timeout = float(call_timeout)
        self._env = env
        self._wire_mode = wire
        self._wire_cfg = (wire_config if wire_config is not None
                          else WireConfig())
        self._wire: wire_mod.WireClient | None = None
        self._proc: subprocess.Popen | None = None
        self._conn = None
        self._listener = None
        self._send_lock = threading.Lock()
        self._pending: dict[int, Future] = {}  # guarded-by: _send_lock
        self._next_id = 0                      # guarded-by: _send_lock
        self._dead: Exception | None = None    # guarded-by: _send_lock
        self._recv_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> None:
        if self._conn is not None:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self._wire_mode == "shm":
            _check_shm_room(2 * self._wire_cfg.ring_bytes, self.host_id)
        sock = os.path.join(tempfile.gettempdir(),
                            f"cfxf-{secrets.token_hex(6)}.sock")
        key = secrets.token_bytes(16)
        self._listener = Listener(sock, family="AF_UNIX", authkey=key)
        env = dict(os.environ if self._env is None else self._env)
        env["CONFLUX_FABRIC_KEY"] = key.hex()
        # the worker imports this very package, whatever its cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "conflux_tpu_torch.fabric", "--worker",
               "--host-id", self.host_id, "--connect", sock,
               "--ckpt-dir", self.ckpt_dir,
               "--engine-json", json.dumps(self._engine_kwargs)]
        req_ring = rep_ring = None
        if self._wire_mode == "shm":
            # the FRONT creates (and always unlinks) the segments, so
            # a SIGKILLed worker can never leak /dev/shm entries
            rq_name, rp_name = wire_mod.segment_names(self.host_id)
            req_ring = wire_mod.Ring.create(
                rq_name, self._wire_cfg.ring_bytes, reclaim="local")
            rep_ring = wire_mod.Ring.create(
                rp_name, self._wire_cfg.ring_bytes, reclaim="shared")
            cmd += ["--wire-json", json.dumps(
                {"req": rq_name, "rep": rp_name,
                 "cfg": self._wire_cfg.to_json()})]
        self._log_path = os.path.join(self.ckpt_dir, "worker.log")
        self._log = open(self._log_path, "ab")
        self._proc = subprocess.Popen(cmd, env=env, stdout=self._log,
                                      stderr=subprocess.STDOUT)
        box: list = []

        def accept():
            try:
                box.append(self._listener.accept())
            except Exception as e:  # noqa: BLE001 — reported below
                box.append(e)

        t = threading.Thread(target=accept, daemon=True,
                             name=f"fabric-accept-{self.host_id}")
        t.start()
        give_up = time.monotonic() + self._start_timeout
        # a worker that exits before it connects (no card, a bad engine
        # spec) fails start at once, with its log
        while (t.is_alive() and self._proc.poll() is None
               and time.monotonic() < give_up):
            t.join(0.05)
        if not box and self._proc.poll() is not None:
            t.join(0.5)  # a connect that raced the exit
        if not box or isinstance(box[0], Exception):
            self._proc.kill()
            self._listener.close()
            if req_ring is not None:
                req_ring.close()
                rep_ring.close()
            tail = b""
            try:
                with open(self._log_path, "rb") as f:
                    tail = f.read()[-2000:]
            except OSError:
                pass
            why = (box[0] if box else
                   f"exited with code {self._proc.returncode}"
                   if self._proc.returncode is not None else "timeout")
            raise RuntimeError(
                f"fabric worker {self.host_id} failed to connect within "
                f"{self._start_timeout}s: {why}"
                f"\n--- worker log tail ---\n{tail.decode(errors='replace')}")
        self._conn = box[0]
        if req_ring is not None:
            self._wire = wire_mod.WireClient(
                req_ring, rep_ring, self._wire_send,
                host_id=self.host_id, config=self._wire_cfg,
                on_send_error=self._wire_send_failed)
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"fabric-recv-{self.host_id}")
        self._recv_thread.start()

    def _wire_send(self, frame: dict) -> None:
        """Control-frame send for the wire pump — serialized with the
        direct _call sends on the one pipe."""
        with self._send_lock:
            if self._dead is not None:
                raise OSError(f"host {self.host_id} is dead")
            self._conn.send(frame)

    # futures-owner
    def _wire_send_failed(self, items: list, exc: Exception) -> None:
        """The wire pump's frame never left: fail exactly its mids
        (the pipe itself is torn, so _recv_loop's _fail follows)."""
        with self._send_lock:
            futs = [self._pending.pop(it["id"], None) for it in items]
        e = ConnectionError(
            f"host {self.host_id} wire send failed: {exc!r}")
        for fut in futs:
            if fut is not None:
                fut.set_exception(e)

    # futures-owner
    def _recv_loop(self) -> None:
        try:
            while True:
                msg = self._conn.recv()
                if msg.get("op") == "reply_many":
                    self._wire_replies(msg)
                    continue
                with self._send_lock:
                    fut = self._pending.pop(msg.get("id"), None)
                if fut is not None:
                    fut.set_result(msg)
        except (EOFError, OSError) as e:
            self._fail(ConnectionError(
                f"host {self.host_id} connection lost: {e!r}"))

    # futures-owner
    def _wire_replies(self, msg: dict) -> None:
        """One batched reply frame off the shm wire: decode validates
        every ring record — a torn/stale/overrun record condemns the
        whole payload channel (DESIGN §31 fault table)."""
        try:
            pairs = self._wire.decode(msg["items"])
        except WireCorrupt as e:
            self._wire_dead(e)
            return
        with self._send_lock:
            futs = [(self._pending.pop(mid, None), reply)
                    for mid, reply in pairs]
        for fut, reply in futs:
            if fut is not None:
                fut.set_result(reply)

    def _wire_dead(self, exc: WireCorrupt) -> None:
        """A corrupt shm record ⇒ instant structural death: kill the
        worker (its view of the rings is no longer trustworthy), fail
        every pending request NOW (WireCorrupt is ConnectionError-
        shaped, so the front maps it like any torn transport), and
        let the heartbeat's torn-pipe detection drive fail-over."""
        if self._wire is not None:
            self._wire.fail(exc)
        if self._proc is not None:
            try:
                self._proc.kill()
            except OSError:
                pass
        self._fail(exc)

    def _fail(self, exc: Exception) -> None:
        """Mark the transport dead and fail every pending reply future
        — no request ever hangs on a torn pipe. The shm wire client
        (when present) is failed FIRST, outside `_send_lock` (it has
        its own lock; never nest the two): a torn pipe means no reply
        will ever drain the rings again, so ring-backpressure retry
        loops and the send pump must observe the death instead of
        pacing forever against a permanently full ring."""
        w = self._wire
        if w is not None:
            w.fail(exc)
        with self._send_lock:
            if self._dead is None:
                self._dead = exc
            stranded = list(self._pending.values())
            self._pending.clear()
        for fut in stranded:
            fut.set_exception(exc)

    # -- request plumbing ---------------------------------------------- #

    def _deadline(self, timeout: float | None) -> float:
        """ONE timeout rule for every op: an explicit per-op timeout
        wins, else the handle's call_timeout — the pickle wire, the
        shm wire and ping all resolve through here, so the two knobs
        compose identically everywhere."""
        return self._call_timeout if timeout is None else float(timeout)

    def _await(self, fut: Future, mid: int, timeout: float | None):
        """Wait out one reply future. A timeout pops the pending entry
        (no leak) and raises the BUILTIN TimeoutError: on Python 3.10
        ``concurrent.futures.TimeoutError`` is a distinct class that
        is NOT an OSError, so re-raising it raw would slip past
        _TRANSPORT_ERRORS and reach the caller unstructured instead of
        mapping to HostUnavailable."""
        secs = self._deadline(timeout)
        try:
            reply = fut.result(secs)
        except FuturesTimeout as e:
            with self._send_lock:
                self._pending.pop(mid, None)
            raise TimeoutError(
                f"host {self.host_id} op timed out after "
                f"{secs:g}s") from e
        if reply.get("ok"):
            return reply.get("value")
        _raise_wire(reply)

    def _call(self, op: str, timeout: float | None = None, **kw):
        fut: Future = Future()
        with self._send_lock:
            if self._dead is not None:
                raise ConnectionError(
                    f"host {self.host_id} is dead: {self._dead}")
            if self._conn is None:
                raise ConnectionError(
                    f"host {self.host_id} not started")
            mid = self._next_id
            self._next_id += 1
            self._pending[mid] = fut
            try:
                self._conn.send({"id": mid, "op": op, **kw})
            except (OSError, ValueError) as e:
                self._pending.pop(mid, None)
                raise ConnectionError(
                    f"host {self.host_id} send failed: {e!r}") from e
        return self._await(fut, mid, timeout)

    # hot-path (one ring memcpy + one outbox append per request)
    def _call_wire(self, op: str, sid, b: np.ndarray,
                   timeout: float | None, qos) -> Any:
        """A payload op over the shm wire: register the mid, stage the
        RHS into the request ring, let the pump batch the descriptor
        out. Ring backpressure maps to HostUnavailable with the ring's
        measured-drain retry hint — never a blocking wait."""
        fut: Future = Future()
        with self._send_lock:
            if self._dead is not None:
                raise ConnectionError(
                    f"host {self.host_id} is dead: {self._dead}")
            mid = self._next_id
            self._next_id += 1
            self._pending[mid] = fut
        try:
            self._wire.submit(mid, sid, b, qos=qos, op=op)
        except wire_mod.RingFull as e:
            with self._send_lock:
                self._pending.pop(mid, None)
            raise HostUnavailable(
                f"host {self.host_id} wire backpressure: {e} "
                f"(retry in ~{e.retry_after * 1e3:.0f}ms at the "
                f"measured drain rate)",
                retry_after=e.retry_after, host=self.host_id) from e
        except ConnectionError:
            with self._send_lock:
                self._pending.pop(mid, None)
            raise
        return self._await(fut, mid, timeout)

    # -- op surface ---------------------------------------------------- #

    def ping(self, timeout: float | None = None) -> dict:
        out = self._call("ping", timeout=timeout)
        w = self._wire
        if w is not None and isinstance(out, dict):
            # ring occupancy rides the heartbeat as a GAUGE — the
            # front-side client sees both rings, no worker round-trip
            st = w.stats()
            frac = max(st["req_used"] / max(1, st["req_cap"]),
                       st["rep_used"] / max(1, st["rep_cap"]))
            out.setdefault("counters", {})["wire_used_frac"] = round(
                frac, 4)
            out["wire"] = st
        return out

    def open(self, sid, spec, A, policy=None,
             timeout: float | None = None):
        return self._call("open", timeout=timeout, sid=sid, spec=spec,
                          A=np.asarray(A), policy=policy)

    def solve(self, sid, b, timeout: float | None = None, qos=None):
        w = self._wire
        if w is not None:
            b2 = np.asarray(b)
            if b2.dtype != object and w.payload_fits(b2.nbytes):
                return self._call_wire(
                    "solve", sid, b2, timeout,
                    None if qos is None else qos.to_wire())
        return self._call("solve", timeout=timeout, sid=sid,
                          b=np.asarray(b),
                          qos=None if qos is None else qos.to_wire())

    def echo(self, b, timeout: float | None = None):
        """RPC-layer probe op: the
        payload round-trips through whichever wire this host runs,
        engine bypassed — isolates transport cost from solve cost."""
        w = self._wire
        if w is not None:
            b2 = np.asarray(b)
            if b2.dtype != object and w.payload_fits(b2.nbytes):
                return self._call_wire("echo", None, b2, timeout, None)
        return self._call("echo", timeout=timeout, b=np.asarray(b))

    def echo_many(self, payloads, timeout: float | None = None):
        """Pipelined batch echo: submit
        EVERY payload before awaiting any reply, so the measured cost
        is the wire itself, not one round-trip latency per request.
        On the shm wire the burst goes through
        :meth:`WireClient.submit_many` — N payloads, one lock, a
        handful of ``solve_many`` frames — honouring ring
        backpressure with the measured-drain retry hint; on the
        pickle wire it is one ``Connection.send`` per payload (that
        per-request serialization IS the baseline being measured).
        Returns the echoed arrays in submission order."""
        arrs = [np.asarray(b) for b in payloads]
        w = self._wire
        pend: list[tuple[int, Future]] = []
        if w is not None and all(
                a.dtype != object and w.payload_fits(a.nbytes)
                for a in arrs):
            with self._send_lock:
                if self._dead is not None:
                    raise ConnectionError(
                        f"host {self.host_id} is dead: {self._dead}")
                for a in arrs:
                    mid = self._next_id
                    self._next_id += 1
                    fut: Future = Future()
                    self._pending[mid] = fut
                    pend.append((mid, fut))
            entries = [(mid, None, a, None, "echo")
                       for (mid, _f), a in zip(pend, arrs)]
            sent = 0
            secs = self._deadline(timeout)
            give_up = time.perf_counter() + secs
            try:
                while sent < len(entries):
                    try:
                        sent += w.submit_many(entries[sent:])
                    except wire_mod.RingFull as e:
                        # bounded, measured-drain pacing: the ring is
                        # full because replies are still in flight —
                        # they free records as they land. Re-check
                        # death each lap (a torn pipe means no reply
                        # will EVER free a record) and bound the total
                        # pacing by the op timeout: never spin forever
                        with self._send_lock:
                            dead = self._dead
                        if dead is not None:
                            raise ConnectionError(
                                f"host {self.host_id} died while "
                                f"pacing a full ring: {dead}") from dead
                        if time.perf_counter() >= give_up:
                            with self._send_lock:
                                for mid, _f in pend[sent:]:
                                    self._pending.pop(mid, None)
                            raise TimeoutError(
                                f"host {self.host_id} request ring "
                                f"stayed full past the {secs:g}s op "
                                f"timeout") from e
                        time.sleep(min(0.05, max(1e-4, e.retry_after)))
            except ConnectionError:
                with self._send_lock:
                    for mid, _f in pend[sent:]:
                        self._pending.pop(mid, None)
                raise
        else:
            with self._send_lock:
                if self._dead is not None:
                    raise ConnectionError(
                        f"host {self.host_id} is dead: {self._dead}")
                for a in arrs:
                    mid = self._next_id
                    self._next_id += 1
                    fut = Future()
                    self._pending[mid] = fut
                    try:
                        self._conn.send({"id": mid, "op": "echo",
                                         "b": a})
                    except (OSError, ValueError) as e:
                        self._pending.pop(mid, None)
                        raise ConnectionError(
                            f"host {self.host_id} send failed: "
                            f"{e!r}") from e
                    pend.append((mid, fut))
        return [self._await(f, m, timeout) for m, f in pend]

    def debug_wire(self, mode: str) -> None:
        """Fire-and-forget drill trigger (scripts/torch_fabric_drill.py):
        ask the worker to emit a deliberately corrupt wire reply. No
        reply is waited for — the corruption's detection IS the
        response."""
        with self._send_lock:
            if self._conn is not None and self._dead is None:
                self._conn.send({"id": -2, "op": "_debug_wire",
                                 "mode": mode})

    def update(self, sid, U, V, replace: bool = False,
               timeout: float | None = None):
        return self._call("update", timeout=timeout, sid=sid,
                          U=np.asarray(U), V=np.asarray(V),
                          replace=replace)

    def checkpoint(self, timeout: float | None = None) -> str:
        return self._call("checkpoint", timeout=timeout)

    def adopt(self, src, names, timeout: float | None = None) -> list:
        return self._call("adopt", timeout=timeout, src=src,
                          names=list(names))

    def migrate_out(self, sid, dest,
                    timeout: float | None = None) -> str:
        return self._call("migrate_out", timeout=timeout, sid=sid,
                          dest=dest)

    def replicate(self, src, names, gen,
                  timeout: float | None = None) -> list:
        return self._call("replicate", timeout=timeout, src=src,
                          names=list(names), gen=int(gen))

    def adopt_replica(self, items,
                      timeout: float | None = None) -> dict:
        return self._call("adopt_replica", timeout=timeout,
                          items=[[s, n] for s, n in items])

    def drop_replica(self, names,
                     timeout: float | None = None) -> int:
        return self._call("drop_replica", timeout=timeout,
                          names=list(names))

    def drop(self, sid, timeout: float | None = None) -> bool:
        return self._call("drop", timeout=timeout, sid=sid)

    def stats(self, timeout: float | None = None) -> dict:
        return self._call("stats", timeout=timeout)

    def close(self) -> None:
        if self._proc is None:
            return
        try:
            self._call("close", timeout=30.0)
        except (ConnectionError, EOFError, OSError):
            pass
        self._teardown()

    def kill(self) -> None:
        """Hard-kill the worker process (drills). The torn pipe fails
        every in-flight request with ConnectionError."""
        if self._proc is None:
            return
        try:
            with self._send_lock:
                if self._dead is None and self._conn is not None:
                    self._conn.send({"id": -1, "op": "kill"})
        except (OSError, ValueError):
            pass
        try:
            self._proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
        self._fail(ConnectionError(f"host {self.host_id} killed"))
        self._teardown(wait=False)

    def _teardown(self, wait: bool = True) -> None:
        if self._wire is not None:
            # closes the pump and UNLINKS both segments (the front
            # created them) — /dev/shm stays clean even when the
            # worker was SIGKILLed mid-write
            self._wire.close()
            self._wire = None
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._proc is not None and wait:
            try:
                self._proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        if getattr(self, "_log", None) is not None:
            self._log.close()
        self._fail(ConnectionError(f"host {self.host_id} closed"))


# --------------------------------------------------------------------------- #
# the worker process
# --------------------------------------------------------------------------- #


def _check_shm_room(nbytes: int, host_id: str) -> None:
    """Refuse to create rings that /dev/shm cannot hold: a segment past
    the filesystem's free space is created fine and faults (SIGBUS) on
    its first write. The shm wire never falls back to pickle."""
    try:
        free = shutil.disk_usage("/dev/shm").free
    except OSError:
        return  # no /dev/shm to measure: shared_memory reports its own errors
    if free < nbytes:
        raise RuntimeError(
            f"host {host_id}: /dev/shm has {free} bytes free, the shm wire "
            f"needs {nbytes} (two rings of WireConfig.ring_bytes); "
            "shrink ring_bytes or pass wire='pickle'")


def _send_locked(conn, lock, payload: dict) -> None:
    with lock:
        conn.send(payload)


def worker_main(argv=None) -> int:
    """``python -m conflux_tpu_torch.fabric --worker`` — one engine host.

    Connects BACK to the front's listener (authkey from the
    CONFLUX_FABRIC_KEY env var), builds its ServeEngine, then serves
    ops. The recv loop stays responsive while heavy ops run: `solve`
    rides the engine's own async submit (reply from the future's done
    callback — coalescing is preserved), and barrier ops
    (open/checkpoint/adopt/migrate_out/update) run on a small op pool
    so a long checkpoint cannot starve heartbeat replies. EOF on the
    pipe (front gone) closes the engine and exits cleanly; the 'kill'
    op exits abruptly (drills)."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m conflux_tpu_torch.fabric")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--host-id", required=True)
    ap.add_argument("--connect", required=True,
                    help="front's AF_UNIX listener path")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--engine-json", default="{}")
    ap.add_argument("--wire-json", default=None,
                    help="shm wire spec: segment names + WireConfig")
    args = ap.parse_args(argv)

    key = bytes.fromhex(os.environ["CONFLUX_FABRIC_KEY"])
    from conflux_tpu_torch.engine import ServeEngine

    # the engine first: a worker that cannot build it (no card for a
    # card engine) exits non-zero before it connects, and the front's
    # start raises with this process's log
    eng = ServeEngine(**json.loads(args.engine_json))
    conn = Client(args.connect, family="AF_UNIX", authkey=key)
    send_lock = threading.Lock()
    core = _HostCore(args.host_id, args.ckpt_dir, eng)
    pool = ThreadPoolExecutor(max_workers=2,
                              thread_name_prefix="fabric-op")

    wire_srv: wire_mod.WireServer | None = None
    if args.wire_json is not None:
        spec = json.loads(args.wire_json)
        cfg = WireConfig.from_json(spec["cfg"])
        # ATTACH only — the front owns creation and unlink, so a
        # worker death (even SIGKILL) can never leak /dev/shm entries
        req_ring = wire_mod.Ring.attach(spec["req"], reclaim="local")
        rep_ring = wire_mod.Ring.attach(spec["rep"], reclaim="shared")
        wire_srv = wire_mod.WireServer(
            req_ring, rep_ring,
            lambda frame: _send_locked(conn, send_lock, frame),
            host_id=args.host_id, config=cfg, encode_exc=_encode_exc)

    def _wire_submit_many(batch):
        """[(sid, b_view, qos_dict)] -> aligned futures. Session and
        qos resolution fail PER ITEM (a bad sid must not poison its
        frame-mates); the survivors ride the engine's single-lock
        batched admission."""
        futs: list[Future | None] = [None] * len(batch)
        live = []
        for i, (sid, b, q) in enumerate(batch):
            try:
                s = core._session(sid)
                qc = None if q is None else qos_mod.class_from_wire(q)
            except Exception as e:
                f: Future = Future()
                f.set_exception(e)
                futs[i] = f
            else:
                live.append((i, s, b, qc))
        if live:
            engine_futs = eng.submit_many(
                [(s, b, qc) for _, s, b, qc in live])
            for (i, _s, _b, _qc), f in zip(live, engine_futs):
                futs[i] = f
        return futs

    def reply_solve(fut: Future, mid: int) -> None:
        try:
            val = fut.result()
        # conflint: disable=CFX-EXCEPT worker op boundary: every failure (kills included) is wired back to the front
        except BaseException as e:
            payload = {"id": mid, **_encode_exc(e)}
        else:
            payload = {"id": mid, "ok": True, "value": val}
        try:
            _send_locked(conn, send_lock, payload)
        except (OSError, ValueError):
            pass  # front is gone; EOF will land on the recv loop

    def run_op(mid: int, op: str, kw: dict) -> None:
        try:
            if op == "ping":
                val: Any = core.ping()
            elif op == "open":
                val = core.open(kw["sid"], kw["spec"], kw["A"],
                                kw.get("policy"))
            elif op == "update":
                val = core.update(kw["sid"], kw["U"], kw["V"],
                                  kw.get("replace", False))
            elif op == "checkpoint":
                val = core.checkpoint()
            elif op == "adopt":
                val = core.adopt(kw["src"], kw["names"])
            elif op == "migrate_out":
                val = core.migrate_out(kw["sid"], kw["dest"])
            elif op == "replicate":
                val = core.replicate(kw["src"], kw["names"], kw["gen"])
            elif op == "adopt_replica":
                val = core.adopt_replica(kw["items"])
            elif op == "drop_replica":
                val = core.drop_replica(kw["names"])
            elif op == "drop":
                val = core.drop(kw["sid"])
            elif op == "stats":
                val = core.stats()
            elif op == "echo":
                val = kw["b"]  # RPC microbench: transport cost only
            else:
                raise ValueError(f"unknown fabric op {op!r}")
        # conflint: disable=CFX-EXCEPT worker op boundary: every failure (kills included) is wired back to the front
        except BaseException as e:
            payload = {"id": mid, **_encode_exc(e)}
        else:
            payload = {"id": mid, "ok": True, "value": val}
        try:
            _send_locked(conn, send_lock, payload)
        except (OSError, ValueError):
            pass

    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            op = msg.get("op")
            mid = msg.get("id")
            if op == "kill":
                os._exit(1)
            if op == "close":
                _send_locked(conn, send_lock,
                             {"id": mid, "ok": True, "value": True})
                break
            if op == "solve_many":
                # the zero-copy wire's batched solve frame: descriptor
                # -> shm view -> single-lock engine admission; replies
                # ride the reply ring via the server's pump
                if wire_srv is not None:
                    wire_srv.handle(msg, _wire_submit_many)
                continue
            if op == "_debug_wire":
                # drill hook: emit a deliberately corrupt wire reply
                # (fire-and-forget — detection is the response)
                if wire_srv is not None:
                    if msg.get("mode") == "die_mid_write":
                        wire_srv.debug_partial_write()
                        os._exit(1)
                    wire_srv.debug_corrupt(msg.get("mode",
                                                   "torn_reply"))
                continue
            if op == "solve":
                try:
                    q = msg.get("qos")
                    fut = core.solve_async(
                        msg["sid"], msg["b"],
                        qos=None if q is None
                        else qos_mod.class_from_wire(q))
                # conflint: disable=CFX-EXCEPT worker op boundary: admission failures are wired back to the front
                except BaseException as e:
                    _send_locked(conn, send_lock,
                                 {"id": mid, **_encode_exc(e)})
                else:
                    fut.add_done_callback(
                        lambda f, mid=mid: reply_solve(f, mid))
                continue
            if op == "ping":
                run_op(mid, op, msg)  # inline: must outrun the op pool
                continue
            pool.submit(run_op, mid, op, dict(msg))
    finally:
        pool.shutdown(wait=False)
        eng.close()
        if wire_srv is not None:
            wire_srv.close()  # detach only; the front unlinks
        try:
            conn.close()
        except OSError:
            pass
    return 0


# --------------------------------------------------------------------------- #
# the fabric front
# --------------------------------------------------------------------------- #

_FABRICS: "weakref.WeakSet[ServeFabric]" = weakref.WeakSet()


class ServeFabric:
    """The routing front over a fleet of engine hosts (DESIGN §28).

    Construct with started-or-not :class:`HostHandle`s, call
    :meth:`start`, then `open`/`solve`/`update` by session id. The
    heartbeat, background-checkpoint and fail-over machinery runs on
    two daemon threads; `close()` stops them and the hosts.
    """

    def __init__(self, hosts, *, policy: FabricPolicy | None = None,
                 fault_plan=None, root: str | None = None):
        handles = list(hosts)
        if not handles:
            raise ValueError("a fabric needs at least one host")
        ids = [h.host_id for h in handles]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids: {ids}")
        self.policy = policy if policy is not None else FabricPolicy()
        self._hosts: dict[str, HostHandle] = {h.host_id: h
                                              for h in handles}
        if root is None:
            import tempfile

            root = tempfile.mkdtemp(prefix="conflux-fabric-")
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._faults = fault_plan
        self._lock = threading.Lock()
        self._state = {h: "alive" for h in self._hosts}  # guarded-by: _lock
        self._misses = {h: 0 for h in self._hosts}       # guarded-by: _lock
        self._owners: dict[Any, str] = {}                # guarded-by: _lock
        # inverted ownership index + capacity pricing (DESIGN §35):
        # `_owned[hid]` mirrors `_owners` per host, `_sid_cost` is the
        # session's qos.request_cost weight fixed at admission, and
        # `_host_cost[hid]` the per-host sum — so fail-over, drain,
        # replica pushes and the rebalancer read a host's load in
        # O(owned)/O(hosts) instead of scanning the fleet-wide map,
        # and a large-N mesh tenant weighs as the capacity it
        # actually consumes.
        self._owned: dict[str, set] = {}                 # guarded-by: _lock
        self._sid_cost: dict[Any, float] = {}            # guarded-by: _lock
        self._host_cost: dict[str, float] = {}           # guarded-by: _lock
        self._lost: dict[Any, str] = {}                  # guarded-by: _lock
        self._recoveries: list[dict] = []                # guarded-by: _lock
        self._mig_seq = 0                                # guarded-by: _lock
        self._ckpt_rounds = 0                            # guarded-by: _lock
        self._closed_sids = 0                            # guarded-by: _lock
        self._admitted_sids = 0                          # guarded-by: _lock
        # elastic membership (DESIGN §34). _reserved: ids an in-flight
        # add_host claimed in its first critical section (the TOCTOU
        # fix — a racing duplicate add fails BEFORE starting a second
        # worker). _retired: ids that died or were removed; they never
        # resurrect — a returning/zombie process must come back under
        # a fresh identity or stale routing state could alias it.
        # _failing: hosts whose fail-over is in flight (remove_host of
        # a corpse waits this out instead of yanking the handle the
        # fail-over is still reading).
        self._reserved: set[str] = set()                 # guarded-by: _lock
        self._retired: set[str] = set()                  # guarded-by: _lock
        self._failing: set[str] = set()                  # guarded-by: _lock
        # sid -> {standby host id: replica generation} (K-replica
        # placement; generations are the primary's fleet-NNNNNN seq,
        # the coherence token fail-over's re-point gate checks)
        self._replicas: dict[Any, dict[str, int]] = {}   # guarded-by: _lock
        self._breakers = {h: CircuitBreaker(self.policy.breaker_threshold,
                                            self.policy.breaker_cooldown)
                          for h in self._hosts}
        self._windows = {h: CounterWindow() for h in self._hosts}
        self.load = HostLoadEstimator(floor=self.policy.retry_floor,
                                      ceil=self.policy.retry_ceil)
        self._stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._ckpt_thread: threading.Thread | None = None
        self._closed = False
        _FABRICS.add(self)

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> "ServeFabric":
        for h in self._hosts.values():
            h.start()
            if isinstance(h, LocalHost):
                h.core.ckpt_keep = self.policy.checkpoint_keep
                h.core.ckpt_compact_every = \
                    self.policy.checkpoint_compact_every
        self._hb_thread = threading.Thread(
            target=self._hb_loop, daemon=True, name="fabric-heartbeat")
        self._hb_thread.start()
        if self.policy.checkpoint_interval > 0:
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_loop, daemon=True, name="fabric-ckpt")
            self._ckpt_thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        self._stop.set()
        for t in (self._hb_thread, self._ckpt_thread):
            if t is not None:
                t.join(timeout=10.0)
        for h in self._hosts.values():
            try:
                h.close()
            except (ConnectionError, EOFError, OSError):
                pass

    def __enter__(self) -> "ServeFabric":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- host census --------------------------------------------------- #

    def _live(self) -> list[str]:
        """Hosts eligible for NEW placement and fail-over adoption:
        alive or suspect (a suspect host still answers most traffic;
        only DEATH moves sessions — the hysteresis half of the
        no-reshuffle story). Draining hosts (scale-in in progress,
        DESIGN §34) are excluded — they keep serving the sessions
        they still own but take nothing new."""
        with self._lock:
            return sorted(h for h, s in self._state.items()
                          if s not in ("dead", "draining"))

    def _alive(self) -> list[str]:
        with self._lock:
            return sorted(h for h, s in self._state.items()
                          if s == "alive")

    def host_state(self, host_id: str) -> str:
        with self._lock:
            return self._state[host_id]

    def owner_of(self, sid) -> str | None:
        with self._lock:
            return self._owners.get(sid)

    # requires-lock: _lock
    def _own(self, sid, hid: str) -> None:
        """Single writer for the ownership map: keeps `_owned` and the
        per-host cost gauge in lockstep with `_owners` (DESIGN §35) —
        every ownership change MUST route through here or `_disown`."""
        old = self._owners.get(sid)
        c = self._sid_cost.get(sid, 1.0)
        if old is not None:
            s = self._owned.get(old)
            if s is not None:
                s.discard(sid)
            self._host_cost[old] = self._host_cost.get(old, 0.0) - c
        self._owners[sid] = hid
        self._owned.setdefault(hid, set()).add(sid)
        self._host_cost[hid] = self._host_cost.get(hid, 0.0) + c

    # requires-lock: _lock
    def _disown(self, sid) -> None:
        """Retire a session from the ownership map + index (close,
        loss, voided admission). Drops its cost entry — a re-admission
        re-prices at open."""
        hid = self._owners.pop(sid, None)
        c = self._sid_cost.pop(sid, 1.0)
        if hid is None:
            return
        s = self._owned.get(hid)
        if s is not None:
            s.discard(sid)
        self._host_cost[hid] = self._host_cost.get(hid, 0.0) - c

    def owner_census(self) -> dict[str, int]:
        """{host id: owned-session count} — the autoscaler's memory
        axis and the rebalancer's skew input. O(hosts) off the
        inverted index, not O(fleet)."""
        with self._lock:
            return {h: len(s) for h, s in self._owned.items() if s}

    def taken_ids(self) -> set[str]:
        """Every host id that would be refused by :meth:`add_host` —
        present, reserved by an in-flight add, or permanently retired.
        The autoscaler mints fresh ids against this set."""
        with self._lock:
            return set(self._hosts) | self._reserved | self._retired

    def add_host(self, handle: HostHandle) -> None:
        """Grow the live set at runtime (scale-out, DESIGN §34). New
        sessions HRW over the enlarged set; existing owners do not
        move — scale-out is adopt-on-arrival, with :meth:`rebalance`
        draining induced skew deliberately.

        The id is RESERVED in the first critical section, so two
        concurrent add_host calls with the same id race on the
        reservation, not on `handle.start()` — exactly one starts a
        worker, the loser fails before owning any resource (the old
        check-then-insert TOCTOU leaked a started handle). Retired
        ids (died or removed) are refused permanently: a dead host's
        identity never resurrects."""
        hid = handle.host_id
        with self._lock:
            if hid in self._hosts or hid in self._reserved:
                raise ValueError(f"host id {hid!r} already present")
            if hid in self._retired:
                raise ValueError(
                    f"host id {hid!r} is retired (it died or was "
                    "removed) — dead ids never resurrect; rejoin "
                    "under a fresh id")
            self._reserved.add(hid)
        try:
            handle.start()
            self._breakers[hid] = CircuitBreaker(
                self.policy.breaker_threshold,
                self.policy.breaker_cooldown)
            self._windows[hid] = CounterWindow()
        except BaseException:
            with self._lock:
                self._reserved.discard(hid)
            raise
        if isinstance(handle, LocalHost):
            handle.core.ckpt_keep = self.policy.checkpoint_keep
        with self._lock:
            self._reserved.discard(hid)
            self._hosts[hid] = handle
            self._state[hid] = "alive"
            self._misses[hid] = 0
        bump("fabric_hosts_added")

    def remove_host(self, host_id: str, *, drain: bool = True) -> list:
        """Leave the fleet at runtime (scale-in, DESIGN §34).

        A live host first moves to the ``draining`` state — it keeps
        serving the sessions it owns but is excluded from new
        placement, fail-over adoption and migration targets — then a
        drain-barrier migration storm rides the §28 :meth:`migrate`
        path once per owned sid (HRW remaps only the departing host's
        sessions; nobody else reshuffles). Only when the host owns
        nothing is it retired: handle closed, id permanently refused
        by :meth:`add_host`. A crash (of this caller or a migration
        target) mid-drain leaves every undrained session owned by the
        still-live source, which returns to ``alive`` — scale-in is
        abandoned, not half-applied — and the partial storm raises
        :class:`HostUnavailable` with a retry hint.

        Removing an already-dead host is pure bookkeeping: it waits
        out any in-flight fail-over reading the corpse's snapshot,
        then retires the entry. Returns the sids migrated off."""
        with self._lock:
            if host_id not in self._hosts:
                raise KeyError(f"unknown host {host_id!r}")
            st = self._state[host_id]
            if st == "draining":
                raise ValueError(f"host {host_id!r} is already "
                                 "draining")
        if st == "dead":
            # fail-over (heartbeat thread) may still be reading the
            # corpse's checkpoint via self._hosts[hid] — wait it out
            deadline = time.monotonic() + self.policy.call_timeout
            while time.monotonic() < deadline:
                with self._lock:
                    busy = host_id in self._failing
                if not busy:
                    break
                time.sleep(0.01)
            self._retire(host_id, close=False)
            return []
        if len(self._live()) - 1 < self.policy.min_live:
            raise FleetDegraded(
                f"removing {host_id} would leave "
                f"{len(self._live()) - 1} live hosts, below min_live="
                f"{self.policy.min_live}",
                retry_after=self._retry_hint(),
                live=len(self._live()), total=len(self._hosts))
        with self._lock:
            self._state[host_id] = "draining"
        moved: list = []
        if drain:
            with self._lock:
                owned = sorted(self._owned.get(host_id) or (), key=str)
            for sid in owned:
                try:
                    self.migrate(sid)
                # conflint: disable=CFX-EXCEPT an injected kill fails ONE drain migration; the storm's partial-result accounting below abandons the scale-in and the monitor owns the death
                except (HostUnavailable, FleetDegraded, InjectedFault,
                        InjectedKill):
                    continue  # undrained: stays on the live source
                moved.append(sid)
        with self._lock:
            undrained = sorted(self._owned.get(host_id) or (), key=str)
            died = self._state.get(host_id) == "dead"
        if undrained and not died:
            # put the host back in service; the caller retries
            with self._lock:
                if self._state.get(host_id) == "draining":
                    self._state[host_id] = "alive"
            if moved:
                bump("fabric_drain_migrations", len(moved))
            raise HostUnavailable(
                f"drain of {host_id} incomplete: {len(undrained)} "
                f"session(s) still owned (moved {len(moved)}) — host "
                "stays in service; retry",
                retry_after=self._retry_hint(len(undrained)),
                host=host_id)
        if died:
            # the host died mid-drain: its heartbeat fail-over has
            # (or will) re-home the rest; retire bookkeeping only
            self._retire(host_id, close=False)
        else:
            self._retire(host_id, close=True)
        if moved:
            bump("fabric_drain_migrations", len(moved))
        bump("fabric_hosts_removed")
        return moved

    def _retire(self, hid: str, *, close: bool) -> None:
        """Purge a host's entry and permanently retire its id."""
        with self._lock:
            handle = self._hosts.pop(hid, None)
            self._state.pop(hid, None)
            self._misses.pop(hid, None)
            self._retired.add(hid)
            for reps in self._replicas.values():
                reps.pop(hid, None)
        self._breakers.pop(hid, None)
        self._windows.pop(hid, None)
        self.load.forget(hid)
        if close and handle is not None:
            try:
                handle.close()
            except (ConnectionError, EOFError, OSError):
                pass

    def _pick_target(self, exclude: "set[str] | tuple" = (), *,
                     require_wire_headroom: bool = False) -> str | None:
        """THE migration-target picker — migrate, the drain storm and
        background rebalancing all route through here so placement
        policy lives in one place. Alive hosts only (suspect and
        draining hosts take nothing new), wire-congestion aware:
        hosts whose shm ring is ≥ 90% full are avoided, and with
        `require_wire_headroom` (the rebalancer — a HOT-host fix must
        not aim at a host about to shed RingFull) they are refused
        outright. Returns None when no candidate qualifies."""
        cands = [h for h in self._alive() if h not in exclude]
        if not cands:
            return None
        clear = [h for h in cands if self.load.wire_frac(h) < 0.9]
        if require_wire_headroom:
            return self.load.least_loaded(clear) if clear else None
        return self.load.least_loaded(clear or cands)

    # -- admission + request routing ----------------------------------- #

    def _fault_plan(self):
        return (self._faults if self._faults is not None
                else resilience.active_faults())

    def _retry_hint(self, backlog: int = 1) -> float:
        return self.load.retry_after(backlog, self._alive() or None)

    def open(self, sid, plan_or_spec, A, *, policy: dict | None = None,
             timeout: float | None = None):
        """Admit a session: place it on the rendezvous-chosen live
        host, factor there, optionally checkpoint it durable
        (`durable_open`). Refuses with :class:`FleetDegraded` below
        `min_live` live hosts and ValueError on a duplicate sid."""
        from conflux_tpu_torch.engine import rendezvous
        from conflux_tpu_torch.serve import FactorPlan, plan_spec

        spec = (plan_spec(plan_or_spec)
                if isinstance(plan_or_spec, FactorPlan)
                else dict(plan_or_spec))
        with self._lock:
            if sid in self._owners:
                raise ValueError(f"sid {sid!r} already open on host "
                                 f"{self._owners[sid]}")
            # reopening a lost sid is legal: the loss accounting is
            # resolved so the census identity admitted == open + lost
            # + closed stays EXACT across re-admission
            if self._lost.pop(sid, None) is not None:
                self._admitted_sids -= 1
            total = len(self._hosts)
        live = self._live()
        if len(live) < self.policy.min_live:
            raise FleetDegraded(
                f"{len(live)}/{total} hosts live, below min_live="
                f"{self.policy.min_live} — admission refused",
                retry_after=self._retry_hint(), live=len(live),
                total=total)
        hid = rendezvous(sid, live)
        self._route_fault(hid)
        host = self._hosts[hid]
        try:
            host.open(sid, spec, A, policy,
                      timeout=timeout if timeout is not None
                      else self.policy.call_timeout)
        except _TRANSPORT_ERRORS as e:
            self._note_request_failure(hid)
            raise HostUnavailable(
                f"host {hid} unreachable during open: {e}",
                retry_after=self._retry_hint(), host=hid) from e
        with self._lock:
            # price the tenant once at admission: the rebalancer and
            # autoscaler weigh this session by the capacity its shape
            # actually consumes (qos.request_cost, DESIGN §32)
            self._sid_cost[sid] = qos_mod.request_cost(
                tuple(spec["shape"]))
            self._own(sid, hid)
        if self.policy.durable_open:
            snap = self._checkpoint_host(hid)
            if snap is not None:
                # K-replica placement (DESIGN §34): the admission
                # snapshot's records land on the next K-1 ranked
                # hosts, so this session is re-pointable from birth
                self._push_replicas(hid, snap)
            else:
                # the host died inside the admission window: the
                # session is NOT durable, so the admission is void —
                # undo it and tell the caller to retry (the next open
                # lands on a survivor). Without this, a kill racing
                # durable_open admits a session that the very next
                # fail-over must declare lost.
                with self._lock:
                    self._disown(sid)
                try:
                    host.drop(sid, timeout=self.policy.call_timeout)
                except _TRANSPORT_ERRORS:
                    pass
                raise HostUnavailable(
                    f"host {hid} died before admission of {sid!r} "
                    "became durable — retry",
                    retry_after=self._retry_hint(), host=hid)
        with self._lock:
            self._admitted_sids += 1
        return sid

    def _route_fault(self, hid: str) -> None:
        try:
            maybe_fault(self._fault_plan(), "route")
        # conflint: disable=CFX-EXCEPT injected transport fault mapped to a structured HostUnavailable
        except (InjectedFault, InjectedKill) as e:
            self._note_request_failure(hid)
            raise HostUnavailable(
                f"host {hid} unreachable (injected route fault)",
                retry_after=self._retry_hint(), host=hid) from e

    def _resolve(self, sid) -> tuple[str, HostHandle]:
        """Route a request: owner lookup + state/breaker gates.
        Structured failures only — never a hang, never a stale pick."""
        with self._lock:
            lost = self._lost.get(sid)
            hid = self._owners.get(sid)
            st = None if hid is None else self._state[hid]
        if lost is not None:
            raise HostUnavailable(
                f"session {sid!r} was lost: {lost}", retry_after=0.0)
        if hid is None:
            raise KeyError(f"unknown sid {sid!r} — open it first")
        if st == "dead":
            raise HostUnavailable(
                f"host {hid} is dead; fail-over for {sid!r} is in "
                "flight", retry_after=self._retry_hint(), host=hid)
        br = self._breakers.get(hid)
        if br is None:  # retired mid-request
            raise HostUnavailable(
                f"host {hid} left the fleet; routing for {sid!r} is "
                "settling", retry_after=self._retry_hint(), host=hid)
        ok, cool = br.allow()
        if not ok:
            raise HostUnavailable(
                f"host {hid} circuit open (repeated transport "
                f"failures); probe in ~{cool:.2f}s",
                retry_after=max(cool, self._retry_hint()), host=hid)
        return hid, self._hosts[hid]

    def _note_request_failure(self, hid: str) -> None:
        br = self._breakers.get(hid)
        if br is not None:
            br.record_failure()

    def solve(self, sid, b, timeout: float | None = None, qos=None):
        """One routed solve. Transport failure on the owning host maps
        to :class:`HostUnavailable` with a measured-drain retry hint;
        the host's own structured errors (including per-tenant
        ``TenantThrottled``, attrs intact) pass through untouched.
        ``qos`` is a :class:`conflux_tpu_torch.qos.QosClass` classifying the
        request on the OWNING host's engine — each host runs its own
        fair-share ledger over the tenants it actually serves."""
        if qos is not None and not isinstance(qos, qos_mod.QosClass):
            raise TypeError(f"qos must be a QosClass or None, got "
                            f"{type(qos).__name__}")
        hid, host = self._resolve(sid)
        self._route_fault(hid)
        try:
            out = host.solve(sid, b,
                             timeout=timeout if timeout is not None
                             else self.policy.call_timeout, qos=qos)
        except _TRANSPORT_ERRORS as e:
            self._note_request_failure(hid)
            raise HostUnavailable(
                f"host {hid} unreachable during solve({sid!r}): {e}",
                retry_after=self._retry_hint(), host=hid) from e
        br = self._breakers.get(hid)
        if br is not None:
            br.record_success()
        return out

    def update(self, sid, U, V, *, replace: bool = False,
               timeout: float | None = None):
        hid, host = self._resolve(sid)
        self._route_fault(hid)
        try:
            out = host.update(sid, U, V, replace=replace,
                              timeout=timeout if timeout is not None
                              else self.policy.call_timeout)
        except _TRANSPORT_ERRORS as e:
            self._note_request_failure(hid)
            raise HostUnavailable(
                f"host {hid} unreachable during update({sid!r}): {e}",
                retry_after=self._retry_hint(), host=hid) from e
        br = self._breakers.get(hid)
        if br is not None:
            br.record_success()
        return out

    def close_session(self, sid, timeout: float | None = None) -> bool:
        """Deliberately retire a session fleet-wide: drop the owner's
        live copy, the ownership entry and every standby replica. The
        load-recede half of elasticity (DESIGN §34) — admitted work
        must be able to END for utilization to fall and the
        autoscaler's scale-in lane to ever fire. The sid becomes
        reusable; the census conserves as
        admitted == open + lost + closed (`stats()['closed_sessions']`,
        the soak's conservation oracle)."""
        hid, host = self._resolve(sid)
        try:
            host.drop(sid, timeout=timeout if timeout is not None
                      else self.policy.call_timeout)
        except _TRANSPORT_ERRORS as e:
            self._note_request_failure(hid)
            raise HostUnavailable(
                f"host {hid} unreachable during close({sid!r}): {e}",
                retry_after=self._retry_hint(), host=hid) from e
        with self._lock:
            self._disown(sid)
            reps = self._replicas.pop(sid, None) or {}
            self._closed_sids += 1
        name = record_name(sid)
        for h in sorted(reps):
            handle = self._hosts.get(h)
            if handle is None:
                continue
            try:
                handle.drop_replica([name],
                                    timeout=self.policy.call_timeout)
            except _TRANSPORT_ERRORS:
                pass  # hygiene only; the generation gate covers it
        bump("fabric_sessions_closed")
        return True

    # -- heartbeat / detection ----------------------------------------- #

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.policy.heartbeat_interval):
            try:
                self._hb_round()
            except Exception:  # noqa: BLE001 — the loop must survive
                bump("fabric_hb_errors")

    def _hb_round(self) -> None:
        plan = self._fault_plan()
        if plan is not None:
            s = plan.fire("host_kill", kinds=("kill",))
            if s is not None:
                victims = self._alive()
                if victims:
                    try:
                        self._hosts[victims[0]].kill()
                    except (ConnectionError, EOFError, OSError):
                        pass
        for hid in sorted(self._hosts):
            if self._closed:
                return
            with self._lock:
                # .get: a concurrent remove_host may retire entries
                # mid-round — a vanished host simply isn't probed
                if self._state.get(hid, "dead") == "dead":
                    continue
            self._probe(hid, plan)

    def _probe(self, hid: str, plan) -> None:
        host = self._hosts.get(hid)
        if host is None:
            return  # retired mid-round
        torn = False
        try:
            maybe_fault(plan, "heartbeat")
            payload = host.ping(timeout=self.policy.heartbeat_timeout)
        except (ConnectionError, EOFError, BrokenPipeError) as e:
            torn, payload = True, None
            del e
        # conflint: disable=CFX-EXCEPT an injected heartbeat kill IS the miss being counted
        except (InjectedFault, InjectedKill, OSError):
            payload = None  # includes TimeoutError: a miss, not a tear
        if payload is not None:
            with self._lock:
                if hid not in self._state:
                    return  # retired mid-probe
                self._misses[hid] = 0
                if self._state[hid] == "suspect":
                    self._state[hid] = "alive"
            win = self._windows.get(hid)
            if win is None:
                return
            counters = dict(payload.get("counters") or {})
            delta = win.feed(counters)
            # pending and wire occupancy are gauges: re-inject the raw
            # values after the window differences the payload
            delta["pending"] = counters.get("pending", 0)
            if "wire_used_frac" in counters:
                delta["wire_used_frac"] = counters["wire_used_frac"]
            self.load.feed(hid, delta)
            return
        bump("heartbeat_misses")
        with self._lock:
            if hid not in self._state:
                return  # retired mid-probe
            self._misses[hid] += 1
            m = self._misses[hid]
            st = self._state[hid]
        if torn or m >= self.policy.dead_after:
            self._declare_dead(hid)
        elif m >= self.policy.suspect_after and st == "alive":
            with self._lock:
                self._state[hid] = "suspect"
            bump("hosts_suspected")

    def _declare_dead(self, hid: str) -> None:
        with self._lock:
            if self._state.get(hid, "dead") == "dead":
                return
            self._state[hid] = "dead"
            # claimed under the SAME lock acquisition that flips the
            # state: remove_host of a corpse waits out _failing, so
            # there must be no window where the state reads dead but
            # the claim isn't visible yet
            self._failing.add(hid)
        bump("hosts_died")
        self.load.forget(hid)
        try:
            self._failover(hid)
        finally:
            with self._lock:
                self._failing.discard(hid)

    # -- fail-over ------------------------------------------------------ #

    def _failover(self, hid: str) -> None:
        """Re-home a dead host's sessions onto the survivors.

        Two rails, re-point first (DESIGN §34): a sid whose live
        standby holds a replica record at a generation ≥ the corpse's
        latest snapshot generation is RE-POINTED — the standby adopts
        from its own local replica store, zero cross-host reads (with
        K ≥ 2 this is the whole fleet's fast path). Everything else
        falls back to the §28 snapshot restore: read the corpse's
        last complete checkpoint, group by rendezvous, one adopt RPC
        per target. The generation gate is the coherence rule — a
        standby whose push failed last round is STALE relative to the
        durable snapshot and re-pointing to it would roll the session
        back further than the documented one-interval bound, so it is
        refused, not trusted. Sids with no record anywhere are
        declared lost with a structured reason."""
        from conflux_tpu_torch.engine import rendezvous

        t0 = time.perf_counter()
        with self._lock:
            owned = sorted(self._owned.get(hid) or (), key=str)
            reps = {sid: dict(self._replicas.get(sid, {}))
                    for sid in owned}
        handle = self._hosts.get(hid)
        snap = (latest_checkpoint(handle.ckpt_dir)
                if handle is not None else None)
        snap_gen = _snapshot_gen(snap)
        manifest = checkpoint_manifest(snap) if snap is not None else {}
        have = {sid: nm for sid, (nm, _g) in manifest.items()}
        adopted: dict[Any, str] = {}
        repointed: dict[Any, str] = {}
        lost: dict[Any, str] = {}

        # rail 1: re-point to live standbys holding coherent replicas.
        # The coherence bar is the RECORD's write generation (§35): a
        # session clean since generation g is current on any standby
        # pushed at ≥ g — delta checkpoints and skipped clean pushes
        # never widen the staleness bound. Sids absent from the
        # snapshot fall back to the snapshot-generation bar.
        live_set = set(self._live())
        groups_rp: dict[str, list] = {}
        for sid in owned:
            ent = manifest.get(sid)
            need = ent[1] if ent is not None else snap_gen
            cands = sorted(
                ((g, h) for h, g in reps[sid].items()
                 if h in live_set and g >= need),
                reverse=True)
            if cands:
                groups_rp.setdefault(cands[0][1], []).append(sid)
        for tgt, sids in sorted(groups_rp.items()):
            try:
                out = self._hosts[tgt].adopt_replica(
                    [[s, record_name(s)] for s in sids],
                    timeout=self.policy.call_timeout)
            except _TRANSPORT_ERRORS:
                # standby dying too — its sids ride the snapshot rail
                self._note_request_failure(tgt)
                continue
            for s, _gen in out.get("adopted", []):
                repointed[s] = tgt
                adopted[s] = tgt
        if repointed:
            with self._lock:
                for s, tgt in repointed.items():
                    self._replicas.get(s, {}).pop(tgt, None)
            bump("fabric_replica_repoints", len(repointed))

        # rail 2: §28 snapshot restore for everything not re-pointed
        for sid in owned:
            if sid not in adopted and sid not in have:
                lost[sid] = (f"host {hid} died before {sid!r} was "
                             "ever checkpointed")
        excluded: set[str] = set()
        remaining = [sid for sid in owned
                     if sid in have and sid not in adopted]
        if remaining:
            bump("fabric_snapshot_restores", len(remaining))
        while remaining:
            live = [h for h in self._live() if h not in excluded]
            if not live:
                for sid in remaining:
                    lost[sid] = (f"host {hid} died and no live host "
                                 f"could adopt {sid!r}")
                break
            groups: dict[str, list] = {}
            for sid in remaining:
                groups.setdefault(rendezvous(sid, live), []).append(sid)
            remaining = []
            for tgt, sids in sorted(groups.items()):
                try:
                    self._hosts[tgt].adopt(
                        snap, [have[s] for s in sids],
                        timeout=self.policy.call_timeout)
                except _TRANSPORT_ERRORS:
                    # the target is dying too: exclude it and re-home
                    # its share on the next pass (its own heartbeat
                    # death will run its own fail-over)
                    self._note_request_failure(tgt)
                    excluded.add(tgt)
                    remaining.extend(sids)
                else:
                    for s in sids:
                        adopted[s] = tgt
        with self._lock:
            for sid, tgt in adopted.items():
                self._own(sid, tgt)
            for sid, why in lost.items():
                self._disown(sid)
                self._replicas.pop(sid, None)
                self._lost[sid] = why
            dt = time.perf_counter() - t0
            self._recoveries.append(
                {"host": hid, "seconds": dt, "adopted": len(adopted),
                 "repointed": len(repointed), "lost": len(lost),
                 "snapshot": os.path.basename(snap) if snap else None})
        bump("host_failovers")
        if adopted:
            bump("sessions_failed_over", len(adopted))
        if adopted and self.policy.durable_open:
            # re-adoption is re-admission: fold the moved sessions
            # into each adopter's own fleet snapshot NOW (and re-seed
            # their standbys) — otherwise an adopter death inside one
            # checkpoint interval would lose the very sessions this
            # fail-over just saved. After the recovery record: the
            # measured recovery time is the adopt, not the re-arm.
            for tgt in sorted(set(adopted.values())):
                snap2 = self._checkpoint_host(tgt)
                if snap2 is not None:
                    self._push_replicas(tgt, snap2)

    # -- migration ------------------------------------------------------ #

    def migrate(self, sid, target: str | None = None) -> str:
        """Hand a live session to another host at a drain barrier.

        Order is crash-safe: (1) the source checkpoints exactly this
        session (its engine drains in-flight work first), (2) the
        target adopts the record, (3) ownership flips, (4) the source
        drops its copy. A failure at or before (2) leaves the session
        intact and owned by the source. Migrated sessions solve
        BITWISE identically (the checkpoint contract). Returns the
        target host id."""
        hid, src = self._resolve(sid)
        if target is None:
            target = self._pick_target(exclude={hid})
            if target is None:
                raise FleetDegraded(
                    f"no live migration target for {sid!r} "
                    f"(source {hid})",
                    retry_after=self._retry_hint(),
                    live=len(self._alive()), total=len(self._hosts))
        elif target == hid:
            raise ValueError(f"migrate target equals source {hid!r}")
        elif self.host_state(target) != "alive":
            raise HostUnavailable(
                f"migrate target {target} is "
                f"{self.host_state(target)}",
                retry_after=self._retry_hint(), host=target)
        with self._lock:
            seq = self._mig_seq
            self._mig_seq += 1
        dest = os.path.join(self.root, "migrate", f"m{seq:06d}")
        try:
            name = src.migrate_out(sid, dest,
                                   timeout=self.policy.call_timeout)
        except _TRANSPORT_ERRORS as e:
            self._note_request_failure(hid)
            raise HostUnavailable(
                f"migration source {hid} unreachable: {e}",
                retry_after=self._retry_hint(), host=hid) from e
        # the hand-off barrier: a crash HERE (record written, target
        # not yet adopting) leaves the session intact on the source
        maybe_fault(self._fault_plan(), "migrate")
        try:
            self._hosts[target].adopt(dest, [name],
                                      timeout=self.policy.call_timeout)
        except _TRANSPORT_ERRORS as e:
            self._note_request_failure(target)
            raise HostUnavailable(
                f"migration target {target} unreachable — {sid!r} "
                f"stays on {hid}", retry_after=self._retry_hint(),
                host=target) from e
        with self._lock:
            self._own(sid, target)
        try:
            src.drop(sid, timeout=self.policy.call_timeout)
        except _TRANSPORT_ERRORS:
            pass  # source copy is unreachable garbage; fail-over skips
            # moved sids because ownership already flipped
        if self.policy.durable_open:
            # migration is re-admission on the target: fold the moved
            # session into the target's own fleet snapshot NOW, or a
            # target death inside one checkpoint interval loses it
            snap = self._checkpoint_host(target)
            if snap is not None:
                # re-seed the moved session's standbys for the new
                # primary (and retire standbys the new ranking drops)
                self._push_replicas(target, snap)
        bump("sessions_migrated")
        return target

    def rebalance(self, *, max_moves: int = 2, ratio: float = 2.0,
                  floor: int = 4) -> list:
        """One bounded background-rebalancing pass (DESIGN §34).

        Skew detector + corrective storm: find the hottest alive host
        by owned CAPACITY COST (each session weighted by its
        `qos.request_cost` at admission — one large-N mesh tenant
        counts as the capacity it actually consumes; with uniform
        shapes this reduces exactly to the
        former session-count greed). When the hot host carries more
        than `ratio` × the alive-host mean cost (and at least `floor`
        sessions — tiny fleets are never 'skewed'), live-migrate up to
        `max_moves` of its costliest sessions through
        :meth:`_pick_target` with the wire-headroom requirement (a
        hot-host fix must not aim at a ≥90% full wire). Everything
        else preserves the no-reshuffle contract: only the hot host's
        sids move, at a bounded rate, each over the §28 crash-safe
        migrate barrier. Returns the sids moved. The
        :class:`~conflux_tpu_torch.control.FabricAutoscaler` calls this
        every tick; it is also a public one-shot knob. Census reads
        ride the inverted `_owned` index — O(hosts + hot-host owned),
        not O(fleet) (DESIGN §35)."""
        alive = self._alive()
        if len(alive) < 2:
            return []
        with self._lock:
            counts = {h: len(self._owned.get(h) or ()) for h in alive}
            costs = {h: self._host_cost.get(h, 0.0) for h in alive}
            hot = max(alive, key=lambda h: (costs[h], counts[h], h))
            # costliest first; str(sid) tie-break keeps uniform-cost
            # fleets on the former deterministic victim order
            victims = sorted(
                self._owned.get(hot) or (),
                key=lambda s: (-self._sid_cost.get(s, 1.0), str(s)))
            vcost = {s: self._sid_cost.get(s, 1.0) for s in victims}
        mean = sum(costs.values()) / len(alive)
        if counts[hot] < floor or costs[hot] <= ratio * max(mean, 1e-9):
            return []
        excess = costs[hot] - mean
        moved_cost = 0.0
        moved: list = []
        for sid in victims:
            if len(moved) >= int(max_moves):
                break
            if moved and moved_cost >= excess:
                break  # enough capacity moved to reach the mean
            tgt = self._pick_target(exclude={hot},
                                    require_wire_headroom=True)
            if tgt is None:
                break  # nobody has headroom: try again next tick
            try:
                self.migrate(sid, target=tgt)
            # conflint: disable=CFX-EXCEPT an injected kill ends THIS rebalance tick (best-effort background bleed); the monitor owns the death
            except (HostUnavailable, FleetDegraded, ValueError,
                    KeyError, InjectedFault, InjectedKill):
                break
            moved.append(sid)
            moved_cost += vcost[sid]
        if moved:
            bump("fabric_rebalance_migrations", len(moved))
        return moved

    # -- checkpointing -------------------------------------------------- #

    def _ckpt_loop(self) -> None:
        while not self._stop.wait(self.policy.checkpoint_interval):
            try:
                self.checkpoint_all()
            except Exception:  # noqa: BLE001 — the loop must survive
                bump("fabric_ckpt_errors")

    def checkpoint_all(self) -> dict[str, str | None]:
        """One background-checkpoint round: snapshot every alive
        host's fleet (each at its own drain barrier). Returns
        {host_id: snapshot dir | None} (None: host unreachable —
        its heartbeat will deal with it)."""
        out: dict[str, str | None] = {}
        for hid in self._alive():
            snap = self._checkpoint_host(hid)
            out[hid] = snap
            if snap is not None:
                self._push_replicas(hid, snap)
        with self._lock:
            self._ckpt_rounds += 1
        return out

    def _push_replicas(self, hid: str, snap: str) -> None:
        """Seed/refresh standby replicas off one host snapshot
        (DESIGN §34 K-replica placement, no-op at K=1).

        For every sid the host owns, the next K-1 hosts on its
        rendezvous-RANKED candidate list (owner excluded) receive a
        local copy of its record, batched one `replicate` RPC per
        standby, all tagged with the snapshot's generation — the
        coherence token `_failover`'s re-point gate checks. Two §35
        scale rails: the push set is DIRTY-ONLY (a standby whose last
        accepted generation is ≥ the record's write generation already
        holds those exact bytes — clean sessions cost zero wire), and
        the per-standby RPCs dispatch CONCURRENTLY, mirroring how
        fail-over batches `adopt_replica` — a push round costs one
        slowest-standby round trip, not the sum. Standbys the new
        ranking drops (membership changed, session migrated) get a
        best-effort `drop_replica`. Push failures are counted, never
        fatal: the session stays durable via the primary snapshot,
        and the stale standby is exactly what the generation gate
        exists to refuse."""
        if self.policy.replicas <= 1:
            return
        from conflux_tpu_torch.engine import rendezvous_ranked

        gen = _snapshot_gen(snap)
        with self._lock:
            owned = sorted(self._owned.get(hid) or (), key=str)
        if not owned:
            return
        try:
            manifest = checkpoint_manifest(snap)
        except (OSError, ValueError, KeyError):
            return
        cands = [h for h in self._live() if h != hid]
        groups: dict[str, list] = {}
        stale: dict[str, list] = {}
        for sid in owned:
            ent = manifest.get(sid)
            if ent is None:
                continue
            name, egen = ent
            standbys = rendezvous_ranked(
                sid, cands, k=self.policy.replicas - 1)
            with self._lock:
                cur = self._replicas.setdefault(sid, {})
                drop = [h for h in cur if h not in standbys]
                for h in drop:
                    cur.pop(h, None)
                known = {h: cur.get(h, -1) for h in standbys}
            for h in drop:
                stale.setdefault(h, []).append(name)
            for tgt in standbys:
                if known[tgt] >= egen:
                    continue  # standby already holds these exact bytes
                groups.setdefault(tgt, []).append((sid, name))
        # fault injection stays on the caller thread in sorted-target
        # order (deterministic under test fault plans); only the real
        # RPCs fan out
        jobs: list = []
        for tgt, pairs in sorted(groups.items()):
            if self._hosts.get(tgt) is None:
                continue
            try:
                maybe_fault(self._fault_plan(), "replicate")
            # conflint: disable=CFX-EXCEPT injected replicate fault: the standby simply stays a generation stale
            except (InjectedFault, InjectedKill):
                bump("fabric_replica_push_failures", len(pairs))
                continue
            jobs.append((tgt, pairs))

        def _push_one(tgt: str, pairs: list) -> None:
            handle = self._hosts.get(tgt)
            if handle is None:
                return
            try:
                handle.replicate(snap, [n for _, n in pairs], gen,
                                 timeout=self.policy.call_timeout)
            except _TRANSPORT_ERRORS:
                self._note_request_failure(tgt)
                bump("fabric_replica_push_failures", len(pairs))
                return
            with self._lock:
                for sid, _n in pairs:
                    self._replicas.setdefault(sid, {})[tgt] = gen
            bump("fabric_replica_pushes", len(pairs))

        if len(jobs) <= 1:
            for tgt, pairs in jobs:
                _push_one(tgt, pairs)
        else:
            with ThreadPoolExecutor(
                    max_workers=min(8, len(jobs)),
                    thread_name_prefix="fabric-replica-push") as ex:
                for f in [ex.submit(_push_one, t, p) for t, p in jobs]:
                    f.result()
        for tgt, names in sorted(stale.items()):
            handle = self._hosts.get(tgt)
            if handle is None:
                continue
            try:
                handle.drop_replica(names,
                                    timeout=self.policy.call_timeout)
            except _TRANSPORT_ERRORS:
                pass  # hygiene only; the generation gate covers it

    def _checkpoint_host(self, hid: str) -> str | None:
        try:
            return self._hosts[hid].checkpoint(
                timeout=self.policy.call_timeout)
        except _TRANSPORT_ERRORS:
            self._note_request_failure(hid)
            return None

    # -- observability -------------------------------------------------- #

    def session_count(self) -> int:
        with self._lock:
            return len(self._owners)

    def stats(self) -> dict:
        """Fabric census: per-host state/misses/sessions/breaker, the
        owners and lost totals, recovery log tail and the per-host
        load estimates — merged into `profiler.serve_stats()['fabric']`
        via :func:`fabric_stats`."""
        with self._lock:
            hosts = {hid: {"state": self._state[hid],
                           "misses": self._misses[hid],
                           "sessions": len(self._owned.get(hid) or ()),
                           "cost": round(
                               self._host_cost.get(hid, 0.0), 3),
                           "breaker": self._breakers[hid].state}
                     for hid in sorted(self._hosts)}
            recoveries = list(self._recoveries[-8:])
            out = {"hosts": hosts,
                   "sessions": len(self._owners),
                   "admitted_sessions": self._admitted_sids,
                   "lost_sessions": len(self._lost),
                   "closed_sessions": self._closed_sids,
                   "retired_hosts": len(self._retired),
                   "replicated_sessions": sum(
                       1 for m in self._replicas.values() if m),
                   "checkpoint_rounds": self._ckpt_rounds,
                   "recoveries": recoveries}
        out["recovery_s_max"] = max(
            (r["seconds"] for r in recoveries), default=0.0)
        out["load"] = self.load.stats()
        return out


def fabric_stats() -> dict:
    """Aggregate census over every live fabric front — the 'fabric'
    sub-dict of :func:`conflux_tpu_torch.profiler.serve_stats`. Gauges live
    on the fabrics (surviving `profiler.clear()`); the EVENT counters
    (host_unavailable, heartbeat_misses, hosts_died,
    sessions_failed_over, ...) ride `resilience.health_stats` in the
    'health' sub-dict."""
    fabs = [f for f in list(_FABRICS) if not f._closed]
    out = {"fabrics": len(fabs), "hosts": 0, "hosts_alive": 0,
           "hosts_suspect": 0, "hosts_dead": 0, "hosts_draining": 0,
           "sessions": 0, "lost_sessions": 0, "recovery_s_max": 0.0}
    for f in fabs:
        s = f.stats()
        out["hosts"] += len(s["hosts"])
        for row in s["hosts"].values():
            out[f"hosts_{row['state']}"] += 1
        out["sessions"] += s["sessions"]
        out["lost_sessions"] += s["lost_sessions"]
        out["recovery_s_max"] = max(out["recovery_s_max"],
                                    s["recovery_s_max"])
    return out


# --------------------------------------------------------------------------- #
# convenience constructors
# --------------------------------------------------------------------------- #


def local_fabric(n: int, root: str, *,
                 engine_kwargs: dict | None = None,
                 policy: FabricPolicy | None = None,
                 fault_plan=None) -> ServeFabric:
    """An n-host single-process fabric (tests, soak, lockcheck)."""
    hosts = [LocalHost(f"h{i}", os.path.join(root, f"h{i}"),
                       engine_kwargs=engine_kwargs) for i in range(n)]
    return ServeFabric(hosts, policy=policy, fault_plan=fault_plan,
                       root=root)


def process_fabric(n: int, root: str, *,
                   engine_kwargs: dict | None = None,
                   policy: FabricPolicy | None = None,
                   fault_plan=None,
                   start_timeout: float = 180.0,
                   wire: str = "shm",
                   wire_config: WireConfig | None = None) -> ServeFabric:
    """An n-host fabric with one worker process per host (the real
    deployment shape; scripts/torch_fabric_drill.py). ``wire`` picks the payload transport (DESIGN §31):
    'shm' (default) stages solve payloads through per-host
    shared-memory rings; 'pickle' is the pre-§31 escape hatch."""
    hosts = [ProcessHost(f"h{i}", os.path.join(root, f"h{i}"),
                         engine_kwargs=engine_kwargs,
                         start_timeout=start_timeout,
                         wire=wire, wire_config=wire_config)
             for i in range(n)]
    return ServeFabric(hosts, policy=policy, fault_plan=fault_plan,
                       root=root)


if __name__ == "__main__":
    sys.exit(worker_main())
