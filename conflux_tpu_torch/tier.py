"""Tiered session residency: device / host / disk, spill and revival (the
port of `conflux_tpu/tier.py`).

A card holds a few thousand resident factor sets at N=256; a larger fleet
does not fit, and without this layer the fleet's only behavior under
memory pressure is an allocator OOM that fails every session at once.
:class:`ResidentSet` bounds the card-resident fleet by session count and
bytes and moves the overflow down a three-tier ladder:

- **device**: a normal :class:`~conflux_tpu_torch.serve.SolveSession`:
  factors, base matrix, Woodbury state and probe row resident, solves
  substitution-only.
- **host**: the session's full state (factors, A0, the Woodbury ``(Up,
  Vp, Y, Cinv)`` correction, the probe row ``wA`` and the drift
  bookkeeping) as CPU tensors (pinned on the card).
  Eviction is batch-amortized: a spill wave stashes every victim's device
  tensors under its own session lock (pointer swaps), then copies the
  whole wave to pinned host tensors on a copy stream and waits for ONE
  event: one host sync per eviction wave, not one per tensor, and never
  more than one session lock held at a time.
- **disk**: cold host records demoted to the headered matrix files of
  `conflux_tpu_torch.io` (one file per leaf plus a JSON manifest with
  shapes, dtypes, encodings and CRC32s). The same records back
  :func:`save_fleet` / :func:`load_fleet`, the engine's checkpoint and
  restore, so a restarted server comes back with its fleet instead of a
  cold-start storm through the factor lane.

Revival is transparent: ``solve``/``update``/``refactor`` on a spilled
session fault it back in under the session lock
(`SolveSession._ensure_resident` -> :meth:`ResidentSet.fault_in`), either

- **h2d restore**: the record's tensors copied back to the card, bitwise
  (a d2h/h2d round trip and the codec never touch payload bits). The copy
  runs non-blocking on the default stream, which every engine dispatch
  waits on (`device.order_after_default`); torch's pinned host allocator
  holds a pinned block back until the copy that reads it has passed, so
  dropping the record after the copy is queued is safe. Grouped restores
  (:meth:`ResidentSet.revive_many`, the checkpoint warm-up) stack a
  same-plan group and move one tensor per leaf position.
- **re-factorization**: when the spilled drift is past
  ``revive_refactor_rank`` the factors are stale anyway, so the drifted
  base ``A0 + U V^H`` is formed on the host and refactored through the
  engine's coalesced factor lane (``engine.factor``: a revival storm
  coalesces into a few stacked K4/K5 launches). Engine worker threads
  (which must not block on their own lane) and engineless managers take
  the direct ``plan._factor_once`` path: the same kernels, the same bits.
  Either way the session gets a new base tensor, never an in-place update
  of one an engine lane may still read.

Robustness rails: a revive-lane semaphore bounds concurrent fault-ins, so
a revival storm degrades to bounded latency instead of device OOM (a
timed-out acquisition raises :class:`~conflux_tpu_torch.resilience.
SessionSpilled`, the record intact); every disk record carries per-leaf
CRCs and a corrupt one fails only its owning session with
:class:`~conflux_tpu_torch.resilience.RestoreCorrupt` evidence; the
`FaultPlan` sites ``spill``/``revive``/``disk_write``/``disk_read`` inject
crashes, delays and byte corruption (a spill crash leaves the session
resident, a revive crash leaves it fully spilled). Every outcome lands in
``profiler.serve_stats()['tier']``.

The byte gauges are accounting (each session's `nbytes`), not the caching
allocator: memory a spill releases returns to torch's cache, and nothing
here calls `torch.cuda.empty_cache`. Mesh plans (the serving mesh lane)
are not ported: their branches raise NotImplementedError.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import shutil
import threading
import time
import weakref
import zlib
from collections import deque
from typing import Any

import numpy as np
import torch

from conflux_tpu_torch import io as cfio
from conflux_tpu_torch import profiler, resilience
from conflux_tpu_torch.device import (hand_to_default, order_after_default, resolve_device,
                                       same_device)
from conflux_tpu_torch.resilience import InjectedFault, RestoreCorrupt, SessionSpilled

# --------------------------------------------------------------------------- #
# tier counters (merged into profiler.serve_stats()['tier'])
# --------------------------------------------------------------------------- #

_TIER_KEYS = (
    "spills_host",        # sessions spilled device -> host
    "spills_disk",        # host records demoted to the disk tier
    "revives_h2d",        # fault-ins restored host -> device
    "revives_disk",       # fault-ins that read the disk tier first
    "revives_refactor",   # fault-ins that re-factored (stale drift)
    "revive_rejects",     # revive-lane admission timeouts (backpressure)
    "spill_faults",       # injected/real spill failures (stayed resident)
    "disk_write_faults",  # demotion failures (record stayed host-tier)
    "restore_corrupt",    # records that failed their CRC on read
    "disk_bytes_written",
    "disk_bytes_read",
    "checkpoints",        # save_fleet calls
    "restores",           # load_fleet calls
    "checkpoint_records_written",  # records freshly serialized (dirty)
    "checkpoint_records_carried",  # clean records carried or copied
)

_TIER_LOCK = threading.Lock()
_TIER: dict[str, int] = {k: 0 for k in _TIER_KEYS}  # guarded-by: _TIER_LOCK
# fault-in wall-clock window (seconds): serve_stats reports p50/p95/p99
_FAULT_LAT: deque = deque(maxlen=8192)  # guarded-by: _TIER_LOCK
# live ResidentSets (weak: a manager dies with its owner) for the gauges
_SET_REFS: list = []  # guarded-by: _TIER_LOCK


def bump(key: str, n: int = 1) -> None:
    """Count one tier outcome (unknown keys appear lazily)."""
    with _TIER_LOCK:
        _TIER[key] = _TIER.get(key, 0) + n


def _note_latency(dt: float) -> None:
    with _TIER_LOCK:
        _FAULT_LAT.append(dt)


def clear_tier() -> None:
    """Reset the global tier counters and the latency window (the gauges
    live on the ResidentSets and survive, like engine counters)."""
    with _TIER_LOCK:
        for k in list(_TIER):
            _TIER[k] = 0
        _FAULT_LAT.clear()


def tier_stats() -> dict:
    """Counters, fault-in latency percentiles and the gauges merged across
    live ResidentSets: the 'tier' sub-dict of `profiler.serve_stats()`."""
    from conflux_tpu_torch.engine import _percentile

    with _TIER_LOCK:
        out: dict[str, Any] = dict(_TIER)
        lats = sorted(_FAULT_LAT)
        alive, dead = [], []
        for ref in _SET_REFS:
            rs = ref()
            (alive if rs is not None else dead).append(rs if rs is not None else ref)
        for ref in dead:
            _SET_REFS.remove(ref)
    for pct in (50, 95, 99):
        out[f"fault_in_p{pct}_ms"] = 1e3 * _percentile(lats, pct)
    gauges = {"managed_sessions": 0, "resident_sessions": 0, "host_sessions": 0,
              "disk_sessions": 0, "corrupt_sessions": 0, "device_bytes": 0,
              "device_bytes_high_water": 0, "resident_high_water": 0,
              "host_bytes": 0, "disk_bytes": 0}
    for rs in alive:  # each stats() takes only that manager's lock
        s = rs.stats()
        for k in gauges:
            if k in ("device_bytes_high_water", "resident_high_water"):
                gauges[k] = max(gauges[k], s[k])
            else:
                gauges[k] += s[k]
    out.update(gauges)
    return out


def _register_set(rs) -> None:
    ref = weakref.ref(rs)
    with _TIER_LOCK:
        _SET_REFS.append(ref)


# --------------------------------------------------------------------------- #
# leaf codec: any session leaf <-> the io.py headered format
# --------------------------------------------------------------------------- #

# io.py stores float32/float64/int32. Every other leaf dtype maps onto them
# losslessly, with the JAX package's encoding: complex views as real pairs,
# 64-bit and unsigned 32-bit ints view as int32 words, and the sub-32-bit
# floats and bool widen exactly (bf16/f16 -> f32, bool -> i32 are
# injective). 'enc' in the leaf meta names the inverse.
_IO_NATIVE = ("float32", "float64", "int32")
_VIEW_AS = {"complex64": "float32", "complex128": "float64",
            "int64": "int32", "uint64": "int32", "uint32": "int32"}
_CAST_AS = {"bfloat16": "float32", "float16": "float32", "bool": "int32"}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _dense_strides(t: torch.Tensor):
    """`t`'s strides when it is dense and non-overlapping but not
    row-major (a transposed block, a column-major inverse), else None. A
    record keeps such a leaf's layout: torch's CPU products sum in a
    layout-dependent order, so a revived leaf must have its strides for
    the revived solves to be bitwise."""
    if t.is_contiguous():
        return None
    expected = 1
    for d in sorted(range(t.dim()), key=lambda d: t.stride(d)):
        if t.shape[d] == 1:
            continue
        if t.stride(d) != expected:
            return None
        expected *= t.shape[d]
    return tuple(t.stride())


def _host_like(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """An empty host tensor with `t`'s shape, dtype and dense layout."""
    st = _dense_strides(t)
    if st is None:
        return torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=pin)
    return torch.empty_strided(tuple(t.shape), st, dtype=t.dtype, pin_memory=pin)


def _as_host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


def _encode_leaf(a) -> tuple[np.ndarray, dict]:
    """One host leaf (a CPU tensor, or numpy) -> ((1, size) io.py-storable
    numpy array, leaf meta). Bit-lossless: 'raw' stores as is, 'view'
    reinterprets the bytes, 'cast' widens through an injective map. The
    payload is row-major (the JAX package's bytes); a dense leaf of another
    layout also records its 'strides'."""
    t = _as_host_tensor(a)
    name = _dtype_name(t)
    meta = {"shape": list(t.shape), "dtype": name}
    st = _dense_strides(t)
    if st is not None:
        meta["strides"] = list(st)
    flat = t.contiguous().reshape(-1)
    if name in _IO_NATIVE:
        enc, how = flat, "raw"
    elif name in _VIEW_AS:
        enc = (torch.view_as_real(flat).reshape(-1) if flat.is_complex()
               else flat.view(getattr(torch, _VIEW_AS[name])))
        how = "view"
    elif name in _CAST_AS:
        enc, how = flat.to(getattr(torch, _CAST_AS[name])), "cast"
    else:
        raise ValueError(f"tier codec cannot store dtype {name} (extend _VIEW_AS/"
                         "_CAST_AS with a lossless mapping)")
    meta["enc"] = how
    enc = enc.numpy()
    return enc.reshape(1, enc.size), meta


def _decode_leaf(flat: np.ndarray, meta: dict) -> torch.Tensor:
    """Inverse of :func:`_encode_leaf`, bitwise: a CPU tensor."""
    dt = getattr(torch, meta["dtype"])
    how = meta["enc"]
    t = torch.from_numpy(np.ascontiguousarray(flat).reshape(-1))
    if how == "view":
        t = (torch.view_as_complex(t.reshape(-1, 2)) if dt.is_complex
             else t.view(dt))
    elif how == "cast":
        t = t.to(dt)
    t = t.reshape(tuple(meta["shape"]))
    if meta.get("strides") is not None:
        t = torch.empty_strided(t.shape, tuple(meta["strides"]), dtype=dt).copy_(t)
    return t


# --------------------------------------------------------------------------- #
# session state <-> leaves dict (+ structural meta)
# --------------------------------------------------------------------------- #


# requires-lock: session._lock
def _extract_state(session) -> tuple[dict, dict]:
    """Read-only snapshot of a resident session's state as ({leaf name:
    tensor}, structural meta). The caller holds the session lock."""
    leaves: dict[str, Any] = {}
    for i, f in enumerate(session._factors):
        leaves[f"f{i}"] = f
    leaves["A0"] = session._A0
    probe_parts = 0
    if session._probe is not None:
        if isinstance(session._probe, tuple):
            # a QR plan's (u, uA) probe: one leaf per part
            probe_parts = len(session._probe)
            for i, p in enumerate(session._probe):
                leaves[f"probe{i}"] = p
        else:
            leaves["probe"] = session._probe
    upd = session._upd
    if upd is not None:
        for k in ("Up", "Vp", "Y", "Cinv"):
            leaves[k] = upd[k]
    meta = {
        "n_factors": len(session._factors),
        "keep_A": session._A is not None,
        "has_probe": session._probe is not None,
        "probe_parts": probe_parts,
        "upd": None if upd is None else {"k": int(upd["k"]), "kb": int(upd["kb"])},
        "owns_base": bool(session._owns_base),
        "last_cond": session.last_cond,
        "precision": session._served_tier,
        "auto_rung": int(session._auto_rung),
        "counters": {"factorizations": session.factorizations,
                     "solves": session.solves,
                     "updates": session.updates,
                     "refactors": session.refactors},
    }
    return leaves, meta


# requires-lock: session._lock
def _implant(session, leaves: dict, meta: dict, counters: bool = False,
             base_shared: bool = False) -> None:
    """Install a state snapshot (device tensors) into `session`, the inverse
    of :func:`_extract_state`; the caller holds the session lock.
    `counters=True` also restores the bookkeeping counters (the checkpoint
    restore; a same-process fault-in keeps the live ones). `base_shared`
    carries the base's engine-lane read mark over a reclaimed transit
    record (its tensors are the ones a lane may have read)."""
    session._factors = tuple(leaves[f"f{i}"] for i in range(meta["n_factors"]))
    session._A0 = leaves["A0"]
    session._A = session._A0 if meta["keep_A"] else None
    pp = int(meta.get("probe_parts", 0) or 0)
    session._probe = (tuple(leaves[f"probe{i}"] for i in range(pp)) if pp
                      else leaves.get("probe"))
    session._served_tier = meta.get("precision")
    session._auto_rung = int(meta.get("auto_rung", 0) or 0)
    session._tier_factors = {}  # derived cross-tier cache: rebuilt lazily
    u = meta["upd"]
    session._upd = (None if u is None else
                    {"k": u["k"], "kb": u["kb"], "Up": leaves["Up"], "Vp": leaves["Vp"],
                     "Y": leaves["Y"], "Cinv": leaves["Cinv"]})
    session._owns_base = meta["owns_base"]
    session._base_shared = base_shared
    # new tensors: any gang slot written from the pre-spill state is stale
    session._gang_ver += 1
    if counters:
        c = meta["counters"]
        session.factorizations = c["factorizations"]
        session.solves = c["solves"]
        session.updates = c["updates"]
        session.refactors = c["refactors"]
        session.last_cond = meta["last_cond"]


# --------------------------------------------------------------------------- #
# disk records: one io.py file per leaf + a JSON manifest with CRCs
# --------------------------------------------------------------------------- #


def _write_record(dirpath: str, leaves: dict, meta: dict, faults=None) -> int:
    """Serialize a host-tier state snapshot to `dirpath` (one io.py file per
    leaf + manifest.json naming shapes, dtypes, encodings and CRC32s).
    Returns the bytes written. The 'disk_write' fault site injects a delay
    or crash before any byte lands and, with kind 'nan', corrupts the
    written record afterwards (the next read fails its CRC)."""
    resilience.maybe_fault(faults, "disk_write")
    os.makedirs(dirpath, exist_ok=True)
    manifest: dict[str, Any] = {"format": 1, "meta": meta, "leaves": {}}
    total = 0
    for name, a in leaves.items():
        enc, lmeta = _encode_leaf(a)
        fname = f"{name}.bin"
        cfio.save_matrix(os.path.join(dirpath, fname), enc)
        lmeta["file"] = fname
        lmeta["crc"] = zlib.crc32(enc.tobytes()) & 0xFFFFFFFF
        manifest["leaves"][name] = lmeta
        total += enc.nbytes
    with open(os.path.join(dirpath, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if resilience.data_fault(faults, "disk_write", "nan") is not None:
        # corrupt the first leaf's payload in the written file (a torn
        # write's stand-in); detection happens at read time, by the CRC
        first = sorted(manifest["leaves"])[0]
        fpath = os.path.join(dirpath, manifest["leaves"][first]["file"])
        with open(fpath, "r+b") as f:
            f.seek(24)  # just past the io.py header
            f.write(b"\xde\xad\xbe\xef")
    return total


def _read_record(dirpath: str, faults=None) -> tuple[dict, dict]:
    """Deserialize a disk record: (host leaves as CPU tensors, meta).
    Integrity failures (missing or truncated files, CRC mismatch,
    undecodable manifest) raise :class:`RestoreCorrupt` with evidence; the
    caller fails only the owning session."""
    resilience.maybe_fault(faults, "disk_read")
    mpath = os.path.join(dirpath, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise RestoreCorrupt(f"spill record manifest unreadable: {mpath!r} ({e})",
                             {"path": dirpath}) from e
    leaves: dict[str, Any] = {}
    total = 0
    for name, lmeta in manifest["leaves"].items():
        fpath = os.path.join(dirpath, lmeta["file"])
        try:
            enc = cfio.load_matrix(fpath)
        except (OSError, ValueError) as e:
            raise RestoreCorrupt(f"spill record leaf unreadable: {fpath!r} ({e})",
                                 {"path": dirpath, "leaf": name}) from e
        crc = zlib.crc32(enc.tobytes()) & 0xFFFFFFFF
        if crc != lmeta["crc"]:
            raise RestoreCorrupt(
                f"spill record leaf {name!r} failed its integrity check (crc "
                f"{crc:#010x} != recorded {lmeta['crc']:#010x}): the record is "
                "corrupt and only this session fails",
                {"path": dirpath, "leaf": name, "expected_crc": lmeta["crc"],
                 "got_crc": crc})
        leaves[name] = _decode_leaf(enc, lmeta)
        total += enc.nbytes
    bump("disk_bytes_read", total)
    return leaves, manifest["meta"]


# --------------------------------------------------------------------------- #
# host copies: the one-sync spill wave
# --------------------------------------------------------------------------- #


_COPY_STREAMS: dict = {}  # device index -> the spill waves' copy stream
_COPY_LOCK = threading.Lock()


def _copy_stream(dev: torch.device):
    with _COPY_LOCK:
        s = _COPY_STREAMS.get(dev.index or 0)
        if s is None:
            s = _COPY_STREAMS[dev.index or 0] = torch.cuda.Stream(dev)
        return s


def _device_get(trees: list, engine=None) -> list:
    """Copy a wave's leaf dicts to the host. Card leaves land in pinned
    tensors through non-blocking copies on a copy stream that first waits
    on the default stream and on every engine lane stream (where the
    sessions' last writes may be queued); the host waits once per card that
    the wave touches, for that copy stream (a stream synchronize, which
    torch's sync debug mode counts). The wave's device tensors stay referenced by the
    callers' transit records until this returns. CPU leaves are cloned
    (the host record must not alias a tensor the caller may keep). Every
    host leaf keeps its device leaf's dense layout (`_dense_strides`)."""
    out = [dict() for _ in trees]
    by_dev: dict = {}
    for i, tree in enumerate(trees):
        for k, v in tree.items():
            if v.device.type == "cuda":
                by_dev.setdefault(v.device.index or 0, []).append((i, k, v))
            else:
                out[i][k] = v.clone()
    for idx, items in by_dev.items():
        dev = torch.device("cuda", idx)
        s = _copy_stream(dev)
        s.wait_stream(torch.cuda.default_stream(dev))
        if engine is not None:
            for lane in engine.lanes:
                if lane.cuda and same_device(lane.device, dev):
                    s.wait_stream(lane.stream)
        with torch.cuda.stream(s):
            for i, k, v in items:
                h = _host_like(v, pin=True)
                h.copy_(v, non_blocking=True)
                out[i][k] = h
        s.synchronize()
    return out


# --------------------------------------------------------------------------- #
# the spill record
# --------------------------------------------------------------------------- #


def _session_devkey(s):
    """Hashable identity of a session's placement (None: no device), the
    per-device cap accounting key: (type, index), index 0 for a bare
    'cuda'."""
    d = getattr(s, "device", None)
    return None if d is None else (d.type, d.index or 0)


class _SpillRecord:
    """Where a non-resident session's state lives. `tier` walks 'transit'
    (device tensors stashed, d2h pending: a racing fault-in reclaims them
    at once) -> 'host' (CPU tensors) -> 'disk' (path only). 'corrupt' pins
    the RestoreCorrupt a failed read produced, so every later touch of the
    session re-raises it."""

    __slots__ = ("tier", "leaves", "meta", "path", "nbytes", "error", "base_shared")

    def __init__(self, tier, leaves, meta, path=None, nbytes=0, error=None,
                 base_shared=False):
        self.tier = tier
        self.leaves = leaves
        self.meta = meta
        self.path = path
        self.nbytes = nbytes
        self.error = error
        self.base_shared = base_shared


def _host_nbytes(leaves: dict) -> int:
    return sum(int(t.numel() * t.element_size()) for t in leaves.values())


def _mesh_refused(session) -> None:
    if session.plan.key.mesh_key is not None:
        from conflux_tpu_torch.serve import _MESH_SLICE

        raise NotImplementedError(f"tiering {_MESH_SLICE} is not ported yet")


def _leaves_to_device(session, leaves: dict) -> dict:
    """Host leaves -> tensors on the session's device. On the card each
    copy runs non-blocking on the default stream (the current stream, when
    it is an engine lane's, then waits on it); torch's pinned host
    allocator keeps a pinned leaf's block from reuse until its copy has
    passed, so the caller may drop the host record at once. A copy moves
    bytes, never computes: bitwise. Mesh plans raise (not ported)."""
    _mesh_refused(session)
    dev = resolve_device(session.device)
    if dev.type != "cuda":
        return dict(leaves)
    default = torch.cuda.default_stream(dev)
    with torch.cuda.stream(default):
        out = {k: v.to(dev, non_blocking=True) for k, v in leaves.items()}
    order_after_default(dev)
    return out


# --------------------------------------------------------------------------- #
# ResidentSet: the tier manager
# --------------------------------------------------------------------------- #


class ResidentSet:
    """Bounds card-resident sessions by count and bytes; spills overflow to
    the host, demotes cold host records to disk, and revives on touch.

    Knobs:

    max_sessions / max_bytes: the device-tier caps. Eviction makes room
        before a fault-in implants, so the byte gauge's high-water never
        exceeds the cap. None: that dimension unbounded.
    max_sessions_per_device / max_bytes_per_device: the same caps per card
        (key `(type, index)`); with one card the same domain as the global
        caps.
    host_max_sessions / host_max_bytes: host-tier caps; overflow demotes
        the coldest records to `disk_dir` (the host tier grows when no
        disk_dir is configured).
    evict_batch: sessions spilled per count-pressure wave (one host sync a
        wave).
    max_concurrent_revives: the revive-lane admission bound: at most this
        many fault-ins materialize device state at once. A fault-in that
        cannot get a slot within its caller's deadline fails with
        :class:`SessionSpilled` (record intact). Engine worker threads
        always wait a bounded time (the requests' soonest deadline, else
        the engine's `revive_wait`). 0/None disables.
    revive_refactor_rank: spilled drift rank at which revival refactors
        (through the engine's factor lane when one is attached) instead of
        restoring stale factors and a fat Woodbury correction. None
        resolves past `DriftPolicy.resolved_max_rank`, so default revivals
        are h2d and bitwise.
    engine: the ServeEngine whose factor lane coalesces refactor-revivals
        (attached by ``ServeEngine(residency=)``).
    fault_plan: consulted at the 'spill'/'revive'/'disk_write'/'disk_read'
        sites (falls back to the installed global plan).

    Lock order: session lock -> manager lock, never the reverse. The
    manager lock guards only registry and gauge state and is never held
    across a device copy or another session's lock.
    """

    def __init__(self, *, max_sessions: int | None = None,
                 max_bytes: int | None = None,
                 max_sessions_per_device: int | None = None,
                 max_bytes_per_device: int | None = None,
                 host_max_sessions: int | None = None,
                 host_max_bytes: int | None = None,
                 disk_dir: str | None = None,
                 evict_batch: int = 4,
                 max_concurrent_revives: int | None = 4,
                 revive_refactor_rank: int | None = None,
                 engine=None, fault_plan=None):
        if max_sessions is not None and max_sessions < 1:
            raise ValueError("max_sessions must be >= 1 (a zero-session device tier "
                             "cannot serve)")
        if max_sessions_per_device is not None and max_sessions_per_device < 1:
            raise ValueError("max_sessions_per_device must be >= 1")
        if evict_batch < 1:
            raise ValueError("evict_batch must be >= 1")
        self.max_sessions = max_sessions
        self.max_bytes = max_bytes
        self.max_sessions_per_device = max_sessions_per_device
        self.max_bytes_per_device = max_bytes_per_device
        self.host_max_sessions = host_max_sessions
        self.host_max_bytes = host_max_bytes
        self.disk_dir = disk_dir
        self.evict_batch = int(evict_batch)
        self.revive_refactor_rank = revive_refactor_rank
        self.engine = engine
        self._faults = fault_plan
        slots = max_concurrent_revives
        if slots and max_sessions is not None:
            # more in-flight revivals than resident slots could land
            # together and overshoot the cap
            slots = min(int(slots), int(max_sessions))
        self._revive_sem = threading.BoundedSemaphore(int(slots)) if slots else None
        self._lock = threading.Lock()
        self._sessions: dict[int, Any] = {}  # guarded-by: _lock
        # id -> resident|spilling|reviving|host|disk|corrupt. A session
        # mid-fault-in is 'reviving' and never an eviction victim, so two
        # concurrent fault-ins cannot pick each other; 'spilling' claims a
        # victim so concurrent enforcers do not double-spill it
        self._state: dict[int, str] = {}     # guarded-by: _lock
        self._bytes: dict[int, int] = {}     # guarded-by: _lock
        # in-flight capacity claims {token: (bytes, sessions, devkey)}: a
        # fault-in or adopt registers its incoming footprint before making
        # room, so concurrent revivals see each other's reservations
        self._claims: dict[int, tuple] = {}  # guarded-by: _lock
        self._claim_seq = itertools.count()
        # incremental views kept coherent by `_set_state`, so no hot path
        # scans the fleet under `_lock`: per-state counts, running claim
        # totals (global and per device), the per-device resident census
        # and lazy-invalidation min-heap LRU orders, each a (heap, entry)
        # pair: the heap holds (stamp, sid) hints and entry[sid] the stamp
        # of the sid's one canonical hint; valid pops come out in live
        # stamp order, the order a full sort would give
        self._state_counts: dict[str, int] = {}     # guarded-by: _lock
        self._claimed_n = 0                         # guarded-by: _lock
        self._claimed_b = 0                         # guarded-by: _lock
        self._claims_dev: dict[Any, list] = {}      # guarded-by: _lock
        self._dev_res: dict[Any, list] = {}         # guarded-by: _lock
        self._devkey: dict[int, Any] = {}           # guarded-by: _lock
        self._lru_dev: tuple[list, dict] = ([], {})   # guarded-by: _lock
        self._lru_host: tuple[list, dict] = ([], {})  # guarded-by: _lock
        self._lru_by_dev: dict[Any, tuple] = {}       # guarded-by: _lock
        # per-device and host-tier LRU maintenance is armed only when a
        # cap can consume it; arming later rebuilds in one O(F) pass
        self._per_dev_lru = (max_sessions_per_device is not None
                             or max_bytes_per_device is not None)
        self._host_lru = (disk_dir is not None
                          and (host_max_sessions is not None or host_max_bytes is not None))
        # victim pick: 'heap' (O(victims log F)) or 'sort' (the full-sort
        # baseline, kept as the equivalence oracle)
        self._lru_impl = os.environ.get("CONFLUX_TIER_LRU", "heap")
        self._device_bytes = 0               # guarded-by: _lock
        self._device_hw = 0                  # guarded-by: _lock
        self._resident_hw = 0                # guarded-by: _lock
        self._host_bytes = 0                 # guarded-by: _lock
        self._disk_bytes = 0                 # guarded-by: _lock
        self._clock = itertools.count(1)
        self._disk_seq = itertools.count()
        _register_set(self)

    def _tick(self) -> int:
        return next(self._clock)

    # -------------------------------------------------------------- #
    # incremental bookkeeping: every `_state` mutation goes through
    # `_set_state`, every `_bytes` mutation through `_set_bytes`, every
    # `_claims` mutation through the `_claims_*` helpers
    # -------------------------------------------------------------- #

    @staticmethod
    # requires-lock: _lock
    def _lru_push(dom: tuple, sid: int, stamp: int) -> None:
        """Install sid's canonical LRU hint at `stamp`; compaction rebuilds
        the heap from the canonical map when garbage outgrows the live
        population (amortized O(1))."""
        heap, entry = dom
        entry[sid] = stamp
        heapq.heappush(heap, (stamp, sid))
        if len(heap) > 2 * len(entry) + 64:
            heap[:] = [(st, d) for d, st in entry.items()]
            heapq.heapify(heap)

    @staticmethod
    # requires-lock: _lock
    def _lru_drop(dom: tuple, sid: int) -> None:
        dom[1].pop(sid, None)  # the heap hint dies lazily on pop

    # requires-lock: _lock
    def _lru_min(self, dom: tuple):
        """The live LRU minimum of one order domain as (sid, session), or
        None. Pops discard non-canonical hints and refresh canonical but
        stale ones (a touch bumped `_tier_stamp`) at the live stamp."""
        heap, entry = dom
        while heap:
            stamp, sid = heap[0]
            if entry.get(sid) != stamp:
                heapq.heappop(heap)
                continue
            s = self._sessions.get(sid)
            if s is None:
                heapq.heappop(heap)
                entry.pop(sid, None)
                continue
            live = s._tier_stamp
            if live != stamp:
                heapq.heapreplace(heap, (live, sid))
                entry[sid] = live
                continue
            return sid, s
        return None

    # requires-lock: _lock
    def _dev_dom(self, devkey) -> tuple:
        dom = self._lru_by_dev.get(devkey)
        if dom is None:
            dom = ([], {})
            self._lru_by_dev[devkey] = dom
        return dom

    # requires-lock: _lock
    def _enable_per_dev_lru(self) -> None:
        """Arm per-device LRU maintenance after construction: one O(F)
        rebuild from the resident census, incremental after."""
        self._per_dev_lru = True
        self._lru_by_dev.clear()
        for sid, dk in self._devkey.items():
            s = self._sessions.get(sid)
            if s is None:
                continue
            heap, entry = self._dev_dom(dk)
            entry[sid] = s._tier_stamp
            heap.append((s._tier_stamp, sid))
        for heap, _entry in self._lru_by_dev.values():
            heapq.heapify(heap)

    # requires-lock: _lock
    def _enable_host_lru(self) -> None:
        """Arm host-tier LRU maintenance after construction."""
        self._host_lru = True
        heap, entry = self._lru_host
        heap.clear()
        entry.clear()
        for sid, st in self._state.items():
            if st != "host":
                continue
            s = self._sessions.get(sid)
            if s is None:
                continue
            entry[sid] = s._tier_stamp
            heap.append((s._tier_stamp, sid))
        heapq.heapify(heap)

    # requires-lock: _lock
    def _set_state(self, sid: int, s, new: str) -> None:
        """The single writer of `_state[sid]`: transitions update the
        per-state counts, the per-device census and the LRU domains."""
        old = self._state.get(sid)
        self._state[sid] = new
        if old == new:
            return
        cnt = self._state_counts
        if old is not None:
            cnt[old] = cnt.get(old, 1) - 1
        cnt[new] = cnt.get(new, 0) + 1
        if old == "resident":
            self._lru_drop(self._lru_dev, sid)
            dk = self._devkey.pop(sid, None)
            dom = self._lru_by_dev.get(dk)
            if dom is not None:
                self._lru_drop(dom, sid)
            d = self._dev_res.get(dk)
            if d is not None:
                d[0] -= 1
                d[1] -= self._bytes.get(sid, 0)
                if d[0] <= 0:
                    self._dev_res.pop(dk, None)
        elif old == "host":
            self._lru_drop(self._lru_host, sid)
        if new == "resident":
            stamp = s._tier_stamp
            self._lru_push(self._lru_dev, sid, stamp)
            dk = _session_devkey(s)
            self._devkey[sid] = dk
            if self._per_dev_lru:
                self._lru_push(self._dev_dom(dk), sid, stamp)
            d = self._dev_res.get(dk)
            if d is None:
                self._dev_res[dk] = [1, self._bytes.get(sid, 0)]
            else:
                d[0] += 1
                d[1] += self._bytes.get(sid, 0)
        elif new == "host" and self._host_lru:
            self._lru_push(self._lru_host, sid, s._tier_stamp)

    # requires-lock: _lock
    def _set_bytes(self, sid: int, nbytes: int) -> None:
        """The single writer of `_bytes[sid]`: keeps the per-device byte
        census true while a resident session's footprint changes."""
        old = self._bytes.get(sid, 0)
        self._bytes[sid] = nbytes
        if self._state.get(sid) == "resident":
            d = self._dev_res.get(self._devkey.get(sid))
            if d is not None:
                d[1] += nbytes - old

    # requires-lock: _lock
    def _claims_add(self, token: int, nbytes: int, count: int, devkey) -> None:
        self._claims[token] = (int(nbytes), int(count), devkey)
        self._claimed_b += int(nbytes)
        self._claimed_n += int(count)
        d = self._claims_dev.get(devkey)
        if d is None:
            self._claims_dev[devkey] = [int(count), int(nbytes)]
        else:
            d[0] += int(count)
            d[1] += int(nbytes)

    # requires-lock: _lock
    def _claims_remove(self, token: int) -> None:
        c = self._claims.pop(token, None)
        if c is None:
            return
        cb, cn, dk = c
        self._claimed_b -= cb
        self._claimed_n -= cn
        d = self._claims_dev.get(dk)
        if d is not None:
            d[0] -= cn
            d[1] -= cb
            if d[0] <= 0 and d[1] <= 0:
                self._claims_dev.pop(dk, None)

    # requires-lock: _lock
    def _claim_retire_one(self, token: int, nbytes: int) -> None:
        """Retire one landed slot's share of a multi-session claim
        (`revive_many` chunks); the last slot retires the claim."""
        cb, cn, dk = self._claims.get(token, (0, 0, None))
        if cn > 1:
            freed = min(cb, int(nbytes))
            self._claims[token] = (cb - freed, cn - 1, dk)
            self._claimed_b -= freed
            self._claimed_n -= 1
            d = self._claims_dev.get(dk)
            if d is not None:
                d[0] -= 1
                d[1] -= freed
        else:
            self._claims_remove(token)

    def adopt(self, *sessions) -> "ResidentSet":
        """Bring sessions under management. Resident ones count against the
        caps at once and may be evicted; spilled ones (the lazy restore)
        register in their current tier. Chainable."""
        for s in sessions:
            if s._residency is not None and s._residency is not self:
                raise ValueError("session is already managed by a different ResidentSet")
            sid = id(s)
            token = None
            with s._lock:
                s._residency = self
                s._tier_stamp = self._tick()
                # the manager is persisted identity: checkpoint-dirty
                s._ckpt_ver += 1
                rec = s._spill
                nb = s.nbytes
                with self._lock:
                    fresh = sid not in self._sessions
                    self._sessions[sid] = s
                    if rec is None:
                        state = self._state.get(sid)
                        if fresh or state is None:
                            # register as 'reviving' with a capacity claim:
                            # concurrent victim math sees the incoming
                            # footprint but never picks the adoptee. The
                            # eviction wave runs after this session lock
                            # is released (two adopts holding their own
                            # adoptee's lock could pick each other)
                            token = next(self._claim_seq)
                            self._claims_add(token, nb, 1, _session_devkey(s))
                            self._set_state(sid, s, "reviving")
                        elif state == "resident":
                            # re-adoption: refresh the byte gauge; the
                            # _enforce below re-applies the caps
                            self._device_bytes += nb - self._bytes.get(sid, 0)
                            self._set_bytes(sid, nb)
                            self._device_hw = max(self._device_hw, self._device_bytes)
                    else:
                        self._set_state(sid, s, rec.tier
                                        if rec.tier in ("host", "disk", "corrupt")
                                        else "host")
                        self._set_bytes(sid, rec.nbytes)
                        if fresh and rec.tier == "host":
                            self._host_bytes += rec.nbytes
                        elif fresh and rec.tier == "disk":
                            self._disk_bytes += rec.nbytes
            if token is not None:
                # session lock released: make room for the claim, then land
                try:
                    self._make_room(0, 0)
                finally:
                    with self._lock:
                        self._claims_remove(token)
                        if self._state.get(sid) == "reviving":
                            self._set_state(sid, s, "resident")
                            self._set_bytes(sid, nb)
                            self._device_bytes += nb
                            self._device_hw = max(self._device_hw, self._device_bytes)
                            self._resident_hw = max(self._resident_hw, self._resident_now())
        self._enforce()
        return self

    def sessions(self) -> list:
        """Every managed session, in adoption order."""
        with self._lock:
            return list(self._sessions.values())

    def _note_bytes(self, session) -> None:
        """Refresh one resident session's byte gauge (the serve layer calls
        it after updates and refactors change the footprint; the caller
        holds the session lock)."""
        nb = session.nbytes
        sid = id(session)
        with self._lock:
            if self._state.get(sid) == "resident":
                self._device_bytes += nb - self._bytes.get(sid, 0)
                self._set_bytes(sid, nb)
                self._device_hw = max(self._device_hw, self._device_bytes)

    # -------------------------------------------------------------- #
    # spill: device -> host (one sync a wave), host -> disk
    # -------------------------------------------------------------- #

    def spill(self, *sessions) -> int:
        """Spill sessions to the host tier (idle-set trimming; capacity
        eviction runs the same machinery). Returns how many moved."""
        victims = []
        with self._lock:
            for s in sessions:
                sid = id(s)
                if self._state.get(sid) == "resident":
                    self._set_state(sid, s, "spilling")
                    victims.append(s)
        return self._spill_batch(victims)

    def spill_lru(self, n: int) -> int:
        """Spill the n least-recently-used resident sessions, off the LRU
        heap (no fleet sort)."""
        victims: list = []
        with self._lock:
            if self._lru_impl == "sort":
                resident = [s for sid, s in self._sessions.items()
                            if self._state.get(sid) == "resident"]
                resident.sort(key=lambda s: s._tier_stamp)
                for s in resident[:n]:
                    self._set_state(id(s), s, "spilling")
                    victims.append(s)
            else:
                while len(victims) < n:
                    nxt = self._lru_min(self._lru_dev)
                    if nxt is None:
                        break
                    sid, s = nxt
                    self._set_state(sid, s, "spilling")
                    victims.append(s)
        return self._spill_batch(victims)

    def _spill_batch(self, victims: list) -> int:
        """The two-phase batch spill. Phase 1, per victim under its own
        session lock: stash the device state in a 'transit' record and null
        the session's fields (pointer swaps, no device work; a gang slot is
        released). Phase 2, no session lock held: one `_device_get` moves
        the wave to pinned host tensors (one host sync), then each record
        flips to 'host' under a brief re-acquire (skipping any a fault-in
        reclaimed meanwhile). A queued engine batch keeps its own
        references to the state it reads, so dropping the session's does
        not free memory under it."""
        recs = []
        for s in victims:
            sid = id(s)
            with s._lock:
                if s._spill is not None:  # raced: already off the card
                    t = s._spill.tier
                    with self._lock:
                        if self._state.get(sid) == "spilling":
                            self._set_state(sid, s, t if t in ("host", "disk", "corrupt")
                                            else "host")
                    continue
                try:
                    resilience.maybe_fault(self._faults, "spill")
                except InjectedFault:
                    bump("spill_faults")
                    with self._lock:  # fail-safe: stays resident, old stamp
                        self._set_state(sid, s, "resident")
                    continue
                leaves, meta = _extract_state(s)
                rec = _SpillRecord("transit", leaves, meta, base_shared=s._base_shared)
                s._spill = rec
                s._factors = None
                s._A = None
                s._A0 = None
                s._probe = None
                s._upd = None
                s._tier_factors = {}  # derived: dropped, not spilled
                g = s._gang
                if g is not None:
                    # eviction frees the gang slot, under this session
                    # lock (the session -> gang lock order); revival
                    # re-adopts (grouped revivals through
                    # engine._gang_readopt, singles at the next dispatch)
                    g.release(s)
            with self._lock:
                if self._state.get(sid) == "spilling":
                    self._set_state(sid, s, "host")
                self._device_bytes -= self._bytes.get(sid, 0)
            recs.append((s, rec))
        if not recs:
            return 0
        with profiler.region("serve.spill"):
            host = _device_get([rec.leaves for _s, rec in recs], self.engine)
        moved = 0
        for (s, rec), hl in zip(recs, host):
            # try-acquire, never block: the holder is mid-touch, and every
            # touch path reclaims the transit record itself
            if not s._lock.acquire(timeout=0.05):
                continue
            try:
                if s._spill is not rec or rec.tier != "transit":
                    continue  # a fault-in reclaimed the transit record
                rec.leaves = hl
                rec.tier = "host"
                rec.nbytes = _host_nbytes(hl)
            finally:
                s._lock.release()
            with self._lock:
                self._set_bytes(id(s), rec.nbytes)
                self._host_bytes += rec.nbytes
            bump("spills_host")
            moved += 1
        self._demote_overflow()
        return moved

    def demote(self, *sessions) -> int:
        """Demote host-tier sessions to the disk tier."""
        return sum(self._demote_one(s) for s in sessions)

    def _demote_one(self, s) -> int:
        if self.disk_dir is None:
            raise ValueError("demotion needs a disk_dir")
        sid = id(s)
        # try-acquire, never block: demotion is best-effort housekeeping,
        # and a host-tier session's lock may be held by a client waiting
        # on the revive lane
        if not s._lock.acquire(timeout=0.05):
            return 0
        try:
            rec = s._spill
            if rec is None or rec.tier != "host":
                return 0
            d = os.path.join(self.disk_dir, f"sess-{sid:x}-{next(self._disk_seq)}")
            try:
                nbytes = _write_record(d, rec.leaves, rec.meta, self._faults)
            except InjectedFault:
                bump("disk_write_faults")
                shutil.rmtree(d, ignore_errors=True)
                return 0  # fail-safe: the record stays host-tier
            host_nb = rec.nbytes
            rec.tier = "disk"
            rec.path = d
            rec.leaves = None
            rec.nbytes = nbytes
        finally:
            s._lock.release()
        with self._lock:
            self._set_state(sid, s, "disk")
            self._host_bytes -= host_nb
            self._disk_bytes += nbytes
            self._set_bytes(sid, nbytes)
        bump("spills_disk")
        bump("disk_bytes_written", nbytes)
        return 1

    def _demote_overflow(self) -> None:
        if self.disk_dir is None:
            return
        while True:
            victims: list = []
            with self._lock:
                if not self._host_lru:
                    self._enable_host_lru()
                over = 0
                if self.host_max_sessions is not None:
                    over = max(over, self._state_counts.get("host", 0) - self.host_max_sessions)
                if self.host_max_bytes is not None and self._host_bytes > self.host_max_bytes:
                    over = max(over, 1)
                if over <= 0:
                    return
                heap, entry = self._lru_host
                while len(victims) < over:
                    nxt = self._lru_min(self._lru_host)
                    if nxt is None:
                        break
                    # off the order (demotion may fail: failures re-enter)
                    heapq.heappop(heap)
                    entry.pop(nxt[0], None)
                    victims.append(nxt[1])
            if not victims:
                return
            moved = sum(self._demote_one(s) for s in victims)
            with self._lock:
                for s in victims:
                    sid = id(s)
                    if self._state.get(sid) == "host":
                        # demotion failed: back into the LRU at its stamp
                        self._lru_push(self._lru_host, sid, s._tier_stamp)
            if moved == 0:
                return  # nothing demotable: stop, do not spin

    # -------------------------------------------------------------- #
    # capacity enforcement
    # -------------------------------------------------------------- #

    # requires-lock: _lock
    def _resident_now(self) -> int:
        """Device-tier occupancy for the high-water gauge: 'resident'
        sessions plus every in-flight capacity claim (a 'reviving' session
        is its claim; a 'spilling' victim is not counted)."""
        return self._state_counts.get("resident", 0) + self._claimed_n

    def _claim(self, nbytes: int, count: int, devkey=None) -> int:
        """Reserve incoming device capacity ahead of a fault-in or adopt;
        the reservation joins every concurrent caller's victim math until
        released. Returns the token for :meth:`_unclaim`."""
        token = next(self._claim_seq)
        with self._lock:
            self._claims_add(token, nbytes, count, devkey)
        return token

    def _unclaim(self, token: int) -> None:
        with self._lock:
            self._claims_remove(token)

    def _pick_victims(self, incoming_bytes: int, incoming_count: int) -> list:
        """Under the manager lock, claim the LRU resident sessions that must
        spill to fit `incoming_count` sessions of `incoming_bytes` plus
        every in-flight claim under the caps (global, then per device:
        each device's overage is relieved by victims on that device). A
        session mid-fault-in is 'reviving', never picked. The 'sort' impl
        (`_pick_victims_sorted`) picks the same sets."""
        if self._lru_impl == "sort":
            return self._pick_victims_sorted(incoming_bytes, incoming_count)
        with self._lock:
            need_n = 0
            if self.max_sessions is not None:
                need_n = (self._state_counts.get("resident", 0) + self._claimed_n
                          + incoming_count - self.max_sessions)
            need_b = 0
            if self.max_bytes is not None:
                need_b = (self._device_bytes + self._claimed_b + incoming_bytes
                          - self.max_bytes)
            victims: list = []
            freed = 0
            while len(victims) < need_n or freed < need_b:
                nxt = self._lru_min(self._lru_dev)
                if nxt is None:
                    break
                sid, s = nxt
                victims.append(s)
                freed += self._bytes.get(sid, 0)
                self._set_state(sid, s, "spilling")
            # round small count-pressure waves up to the amortization batch
            # (never byte-pressure ones: bytes freed beyond need thrash)
            if victims and need_n > 0 and need_b <= 0:
                while len(victims) < self.evict_batch:
                    nxt = self._lru_min(self._lru_dev)
                    if nxt is None:
                        break
                    sid, s = nxt
                    victims.append(s)
                    self._set_state(sid, s, "spilling")
            if self.max_sessions_per_device is not None \
                    or self.max_bytes_per_device is not None:
                if not self._per_dev_lru:
                    self._enable_per_dev_lru()
                for dk in list(self._dev_res):
                    d = self._dev_res.get(dk)
                    if d is None:
                        continue
                    cl = self._claims_dev.get(dk, (0, 0))
                    need_n_d = need_b_d = 0
                    if self.max_sessions_per_device is not None:
                        need_n_d = d[0] + cl[0] - self.max_sessions_per_device
                    if self.max_bytes_per_device is not None:
                        need_b_d = d[1] + cl[1] - self.max_bytes_per_device
                    dom = self._lru_by_dev.get(dk)
                    while dom is not None and (need_n_d > 0 or need_b_d > 0):
                        nxt = self._lru_min(dom)
                        if nxt is None:
                            break
                        sid, s = nxt
                        victims.append(s)
                        need_n_d -= 1
                        need_b_d -= self._bytes.get(sid, 0)
                        self._set_state(sid, s, "spilling")
        return victims

    def _pick_victims_sorted(self, incoming_bytes: int, incoming_count: int) -> list:
        """The full-sort victim picker: materialize and sort the resident
        list under the manager lock. The equivalence oracle of the heap
        path, O(F log F) a pick."""
        with self._lock:
            resident = [(sid, s) for sid, s in self._sessions.items()
                        if self._state.get(sid) == "resident"]
            resident.sort(key=lambda e: e[1]._tier_stamp)
            claimed_b = claimed_n = 0
            for cb, cn, _dk in self._claims.values():
                claimed_b += cb
                claimed_n += cn
            need_n = 0
            if self.max_sessions is not None:
                need_n = len(resident) + claimed_n + incoming_count - self.max_sessions
            need_b = 0
            if self.max_bytes is not None:
                need_b = self._device_bytes + claimed_b + incoming_bytes - self.max_bytes
            victims = []
            freed = 0
            for sid, s in resident:
                if len(victims) >= need_n and freed >= need_b:
                    break
                victims.append(s)
                freed += self._bytes.get(sid, 0)
            if victims and need_n > 0 and need_b <= 0:
                for sid, s in resident[len(victims):]:
                    if len(victims) >= self.evict_batch:
                        break
                    victims.append(s)
            if self.max_sessions_per_device is not None \
                    or self.max_bytes_per_device is not None:
                picked = {id(s) for s in victims}
                by_dev: dict = {}
                for sid, s in resident:
                    by_dev.setdefault(_session_devkey(s), []).append((sid, s))
                cl_n: dict = {}
                cl_b: dict = {}
                for cb, cn, dk in self._claims.values():
                    cl_n[dk] = cl_n.get(dk, 0) + cn
                    cl_b[dk] = cl_b.get(dk, 0) + cb
                for dk, members in by_dev.items():
                    need_n_d = need_b_d = 0
                    if self.max_sessions_per_device is not None:
                        need_n_d = len(members) + cl_n.get(dk, 0) - self.max_sessions_per_device
                    if self.max_bytes_per_device is not None:
                        res_b = sum(self._bytes.get(sid, 0) for sid, _s in members)
                        need_b_d = res_b + cl_b.get(dk, 0) - self.max_bytes_per_device
                    taken = freed_d = 0
                    for sid, s in members:
                        if sid in picked:
                            taken += 1
                            freed_d += self._bytes.get(sid, 0)
                    for sid, s in members:  # members keep LRU order
                        if taken >= need_n_d and freed_d >= need_b_d:
                            break
                        if sid in picked:
                            continue
                        victims.append(s)
                        picked.add(sid)
                        taken += 1
                        freed_d += self._bytes.get(sid, 0)
            for s in victims:
                self._set_state(id(s), s, "spilling")
        return victims

    def _make_room(self, incoming_bytes: int, incoming_count: int) -> None:
        victims = self._pick_victims(incoming_bytes, incoming_count)
        if victims:
            self._spill_batch(victims)

    def _enforce(self) -> None:
        self._make_room(0, 0)
        self._demote_overflow()

    # -------------------------------------------------------------- #
    # fault-in (revival)
    # -------------------------------------------------------------- #

    def _refactor_rank(self, session) -> int:
        if self.revive_refactor_rank is not None:
            return int(self.revive_refactor_rank)
        # past the DriftPolicy trigger: update() refactors beyond
        # resolved_max_rank, so default revivals are always h2d (bitwise)
        return session.policy.resolved_max_rank(session.plan.N) + 1

    def fault_in(self, session, timeout: float | None = None) -> bool:
        """Revive a spilled session in place, under its lock (the entry of
        `SolveSession._ensure_resident` and of the engine's pre-dispatch
        hook). Returns True when a record was revived, False when the
        session was already resident. Atomic: the session ends fully
        revived or fully spilled with its record intact. `timeout` bounds
        both waits, the session lock and the revive-lane slot; expiry
        raises :class:`SessionSpilled`. Engine worker threads never wait
        unbounded (a None timeout from one is the engine's `revive_wait`):
        a client refactor-revival holds its session lock and a lane slot
        while it waits on the engine's factor lane, so a dispatcher blocked
        here unbounded would close the cycle."""
        t0 = time.perf_counter()
        if timeout is None:
            eng = self.engine
            if eng is not None and eng._is_worker_thread():
                timeout = eng.revive_wait
        if timeout is None:
            session._lock.acquire()
        elif not session._lock.acquire(timeout=max(0.0, timeout)):
            bump("revive_rejects")
            raise SessionSpilled(
                f"session busy: another thread held its lock past the {timeout:.3f}s "
                "revive budget (likely a revival in flight); the record is intact, "
                "retry shortly", retry_after=timeout)
        try:
            rec = session._spill
            if rec is None:
                return False
            if rec.tier == "corrupt":
                # a fresh copy of the pinned error: one instance raised
                # from several threads would share a traceback
                err = rec.error
                raise RestoreCorrupt(str(err), dict(err.evidence)) from err
            sid = id(session)
            if self._revive_sem is not None:
                ok = (self._revive_sem.acquire() if timeout is None
                      else self._revive_sem.acquire(timeout=timeout))
                if not ok:
                    bump("revive_rejects")
                    raise SessionSpilled(
                        f"revive lane saturated: no admission slot within {timeout:.3f}s; "
                        "the session stays spilled (record intact), retry after an "
                        "in-flight revival completes")
            try:
                with self._lock:
                    self._set_state(sid, session, "reviving")
                self._fault_in_admitted(session, rec, sid)
            except RestoreCorrupt as e:
                bump("restore_corrupt")
                tier0, nb0, path0 = rec.tier, rec.nbytes, rec.path
                rec.tier = "corrupt"
                rec.error = e
                rec.leaves = None
                rec.path = None
                rec.nbytes = 0
                if path0 is not None:
                    # a CRC failure is permanent: reclaim the disk space
                    # (the pinned error keeps the path as evidence)
                    shutil.rmtree(path0, ignore_errors=True)
                with self._lock:
                    self._set_state(sid, session, "corrupt")
                    if tier0 == "disk":
                        self._disk_bytes -= nb0
                    elif tier0 == "host":
                        self._host_bytes -= nb0
                    self._set_bytes(sid, 0)
                raise
            except BaseException:
                # revive failure: fully spilled, record intact; the next
                # touch retries
                with self._lock:
                    if self._state.get(sid) == "reviving":
                        self._set_state(sid, session, rec.tier
                                        if rec.tier in ("host", "disk") else "host")
                raise
            finally:
                if self._revive_sem is not None:
                    self._revive_sem.release()
            session._tier_stamp = self._tick()
        finally:
            session._lock.release()
        _note_latency(time.perf_counter() - t0)
        return True

    # requires-lock: session._lock (held by fault_in)
    def _fault_in_admitted(self, session, rec, sid) -> None:
        resilience.maybe_fault(self._faults, "revive")
        with profiler.region("serve.revive"):
            if rec.tier in ("transit", "host"):
                leaves, meta = rec.leaves, rec.meta
                from_disk = False
            else:  # disk
                leaves, meta = _read_record(rec.path, self._faults)
                from_disk = True
            u = meta["upd"]
            stale = u is not None and u["k"] >= self._refactor_rank(session)
            # reserve the incoming footprint before sizing eviction, so a
            # concurrent fault-in's victim math sees it
            incoming = 0 if rec.tier == "transit" else _host_nbytes(leaves)
            token = self._claim(incoming, 1, _session_devkey(session))
            try:
                self._make_room(0, 0)
                if stale and rec.tier != "transit":
                    self._revive_refactor(session, leaves, meta)
                    bump("revives_refactor")
                elif rec.tier == "transit":
                    _implant(session, leaves, meta, base_shared=rec.base_shared)
                    bump("revives_h2d")
                else:
                    _implant(session, _leaves_to_device(session, leaves), meta)
                    bump("revives_h2d")
                if from_disk:
                    bump("revives_disk")
                    if rec.path is not None:
                        shutil.rmtree(rec.path, ignore_errors=True)
                session._spill = None
                nb = session.nbytes
                with self._lock:
                    # atomic claim -> gauge transfer
                    self._claims_remove(token)
                    self._set_state(sid, session, "resident")
                    if rec.tier == "host":
                        self._host_bytes -= rec.nbytes
                    elif rec.tier == "disk":
                        self._disk_bytes -= rec.nbytes
                    self._set_bytes(sid, nb)
                    self._device_bytes += nb
                    self._device_hw = max(self._device_hw, self._device_bytes)
                    self._resident_hw = max(self._resident_hw, self._resident_now())
            finally:
                self._unclaim(token)

    # requires-lock: session._lock (held by fault_in)
    def _revive_refactor(self, session, leaves, meta) -> None:
        """The stale-drift revival: form A1 = A0 + U V^H on the host and
        refactor it, through the engine's coalesced factor lane when one is
        attached and the caller is not an engine worker (a worker blocking
        on its own lane would deadlock), else through the plan's bucket-1
        factor program (the same kernels). The session absorbs the drift as
        a DriftPolicy refactor does: a new base tensor (never one an engine
        lane has read, updated in place), no Woodbury state, counters
        bumped."""
        plan = session.plan
        A0 = leaves["A0"].cpu()
        u = meta["upd"]
        if u is not None:
            k = u["k"]
            Up = leaves["Up"].cpu()[..., :k]
            Vp = leaves["Vp"].cpu()[..., :k]
            A1 = (A0 + Up @ Vp.conj().transpose(-1, -2)).to(A0.dtype)
        else:
            A1 = A0
        eng = self.engine
        fresh = None
        tier = meta.get("precision")
        target = session.device
        # the lane honors a session's placement only when it serves that
        # card; tier-opened sessions refactor directly at their tier (the
        # lane would rebuild them native: a silent precision change)
        servable = target is None or any(same_device(target, d) for d in getattr(
            eng, "devices", ()))
        if (eng is not None and tier is None and servable and A1.dtype != torch.bfloat16
                and not eng._is_worker_thread()):
            from conflux_tpu_torch.engine import EngineClosed, EngineSaturated

            try:
                fresh = eng.factor(plan, A1.numpy(), policy=session.policy, device=target)
            except (EngineClosed, EngineSaturated):
                fresh = None  # lane unavailable: the direct path below
        if fresh is not None:
            session._factors = fresh._factors
            session._A0 = fresh._A0
            session._probe = fresh._probe
        else:
            _mesh_refused(session)
            Ad = A1.to(resolve_device(target))
            with profiler.region("serve.refactor"):
                session._factors = (plan._factor_once(Ad) if tier is None
                                    else plan._tier_factor_once(tier, Ad))
            # made on an engine lane's stream when a worker revives: the
            # callers use them on the default stream
            hand_to_default((session._factors, Ad))
            session._A0 = Ad
            session._probe = None
        session._A = session._A0 if (meta["keep_A"] or tier is not None) else None
        session._upd = None
        session._owns_base = True
        session._base_shared = False
        session._served_tier = tier
        session._auto_rung = int(meta.get("auto_rung", 0) or 0)
        session._tier_factors = {}
        session._gang_ver += 1
        session.factorizations += 1
        session.refactors += 1

    def _group_chunks(self, recs: list) -> list:
        """Split a grouped revival into chunks the device caps can hold: a
        chunk lands in one stacked copy, so an unbounded group would
        overshoot the caps with nothing left to evict. Later chunks evict
        earlier ones (LRU); an oversized singleton lands anyway."""
        cap_n = self.max_sessions
        if self.max_sessions_per_device is not None:
            cap_n = (self.max_sessions_per_device if cap_n is None
                     else min(cap_n, self.max_sessions_per_device))
        cap_b = self.max_bytes
        if self.max_bytes_per_device is not None:
            cap_b = (self.max_bytes_per_device if cap_b is None
                     else min(cap_b, self.max_bytes_per_device))
        out: list = []
        cur: list = []
        cb = 0
        for s, rec in recs:
            over_n = cap_n is not None and len(cur) >= cap_n
            over_b = cap_b is not None and cur and cb + rec.nbytes > cap_b
            if cur and (over_n or over_b):
                out.append(cur)
                cur, cb = [], 0
            cur.append((s, rec))
            cb += rec.nbytes
        if cur:
            out.append(cur)
        return out

    def revive_many(self, sessions, timeout: float | None = None) -> int:
        """Grouped revival of spilled sessions: the checkpoint warm-up and
        prefetch path. Same-plan, undrifted host-tier records stack
        (`batched.stack_host_trees`) and cross in one copy per leaf
        position, then each session takes its slot (views; bitwise what a
        per-session `fault_in` restores). Groups are chunked to the device
        caps. Drifted, disk-tier or mismatched sessions fault in one by
        one. Returns how many sessions were revived (no-ops do not count;
        revive-lane backpressure skips a session or group, record intact,
        `revive_rejects` bumped; a corrupt record keeps raising)."""
        from conflux_tpu_torch.batched import stack_host_trees, unstack_tree

        groups: dict[tuple, list] = {}
        rest = []
        landed: list = []
        for s in sessions:
            with s._lock:
                rec = s._spill
                if rec is None:
                    continue
                if (rec.tier != "host" or rec.meta["upd"] is not None
                        or not all(t.is_contiguous() for t in rec.leaves.values())):
                    # drifted, disk-tier and non-row-major leaves (a
                    # stacked copy would not keep their layout) revive
                    # one by one
                    rest.append(s)
                    continue
                key = (id(s.plan), rec.meta["n_factors"], rec.meta["has_probe"],
                       rec.meta.get("probe_parts", 0), rec.meta.get("precision"),
                       rec.meta["keep_A"], _session_devkey(s))
                groups.setdefault(key, []).append(s)
        n = 0
        for group in groups.values():
            if len(group) == 1:
                rest.append(group[0])
                continue
            t0 = time.perf_counter()
            if self._revive_sem is not None:
                ok = (self._revive_sem.acquire() if timeout is None
                      else self._revive_sem.acquire(timeout=timeout))
                if not ok:
                    # this group stays spilled; the rest still get a try
                    bump("revive_rejects")
                    continue
            try:
                recs = []
                for s in group:
                    with s._lock:
                        rec = s._spill
                        if rec is not None and rec.tier == "host":
                            recs.append((s, rec))
                if not recs:
                    continue
                for chunk in self._group_chunks(recs):
                    token = self._claim(sum(rec.nbytes for _s, rec in chunk), len(chunk),
                                        _session_devkey(chunk[0][0]))
                    try:
                        with profiler.region("serve.revive"):
                            self._make_room(0, 0)
                            _mesh_refused(chunk[0][0])
                            dev = resolve_device(chunk[0][0].device)
                            stacked = stack_host_trees([rec.leaves for _s, rec in chunk], dev)
                            order_after_default(dev)
                            slots = unstack_tree(stacked, len(chunk))
                        for (s, rec), leaves in zip(chunk, slots):
                            with s._lock:
                                if s._spill is not rec:
                                    continue  # raced a direct fault_in
                                _implant(s, leaves, rec.meta)
                                s._spill = None
                                s._tier_stamp = self._tick()
                                nb = s.nbytes
                            sid = id(s)
                            with self._lock:
                                self._claim_retire_one(token, rec.nbytes)
                                self._set_state(sid, s, "resident")
                                self._host_bytes -= rec.nbytes
                                self._set_bytes(sid, nb)
                                self._device_bytes += nb
                                self._device_hw = max(self._device_hw, self._device_bytes)
                                self._resident_hw = max(self._resident_hw,
                                                        self._resident_now())
                            bump("revives_h2d")
                            _note_latency(time.perf_counter() - t0)
                            landed.append(s)
                            n += 1
                    finally:
                        self._unclaim(token)
            finally:
                if self._revive_sem is not None:
                    self._revive_sem.release()
        for s in rest:
            try:
                if self.fault_in(s, timeout=timeout):
                    landed.append(s)
                    n += 1
            except SessionSpilled:
                continue  # per-session backpressure: stays spilled
        eng = self.engine
        if landed and eng is not None:
            # grouped revivals land straight in gang slots, so the revived
            # fleet's first window already dispatches stacked (advisory;
            # no session lock is held here)
            eng._gang_readopt(landed)
        return n

    # -------------------------------------------------------------- #
    # observability
    # -------------------------------------------------------------- #

    def stats(self) -> dict:
        """Gauges: population per tier, byte totals and the device-tier
        high-water marks the caps are judged by."""
        with self._lock:
            cnt = self._state_counts
            resident = (cnt.get("resident", 0) + cnt.get("spilling", 0)
                        + cnt.get("reviving", 0))
            out = {
                "managed_sessions": len(self._sessions),
                "resident_sessions": resident,
                "host_sessions": cnt.get("host", 0),
                "disk_sessions": cnt.get("disk", 0),
                "corrupt_sessions": cnt.get("corrupt", 0),
                "device_bytes": self._device_bytes,
                "device_bytes_high_water": self._device_hw,
                "resident_high_water": self._resident_hw,
                "host_bytes": self._host_bytes,
                "disk_bytes": self._disk_bytes,
                "max_sessions": self.max_sessions,
                "max_bytes": self.max_bytes,
                "max_sessions_per_device": self.max_sessions_per_device,
                "max_bytes_per_device": self.max_bytes_per_device,
                "per_device": {str(dk): {"sessions": d[0], "bytes": d[1]}
                               for dk, d in self._dev_res.items() if d[0] > 0},
            }
        return out


# --------------------------------------------------------------------------- #
# fleet checkpoint / restore (ServeEngine.checkpoint / .restore)
# --------------------------------------------------------------------------- #


def _policy_fields(policy) -> dict:
    return {"max_rank": policy.max_rank, "cond_limit": policy.cond_limit,
            "refine": policy.refine}


def _load_base_entries(base: str) -> dict:
    """Previous-generation fleet.json entries by name, or {} when the base
    is missing or unreadable (the caller then writes in full: a broken base
    must never break the next checkpoint)."""
    try:
        with open(os.path.join(base, "fleet.json")) as f:
            return {e["name"]: e for e in json.load(f)["sessions"]}
    except (OSError, ValueError, KeyError, TypeError):
        return {}


def save_fleet(path: str, sessions, names=None, *, base=None, gen=None,
               full=True) -> dict:
    """Serialize a fleet snapshot to `path`: one disk record per session
    (the spill format, CRCs and all) plus fleet.json naming each record
    dir, plan spec and drift policy. Works across tiers without moving
    anything: resident sessions copy their state to the host, host records
    serialize directly, disk records are re-read (the engine's
    `checkpoint()` provides the drain barrier that makes the snapshot
    consistent). Returns {name: record dir}.

    Incremental generations: with `base` (the previous generation's dir) a
    session whose `_ckpt_ver` dirty clock (and sid) matches its base entry
    is clean. With ``full=False`` a clean session's entry points at the
    existing record through a single-hop relative dir (re-based every
    generation, so chains never deepen): a delta generation costs O(dirty)
    copies and IO. With ``full=True`` (compaction, and the only mode
    without a base) every record lands locally, clean ones by a byte copy
    of the files. Every entry carries ``ver`` (the dirty clock it holds)
    and ``gen`` (the generation whose write produced the bytes; copies
    keep it). `gen` is this generation's number (None stamps 0)."""
    from conflux_tpu_torch.serve import plan_spec

    os.makedirs(path, exist_ok=True)
    prev_map = _load_base_entries(base) if base is not None else {}
    this_gen = int(gen) if gen is not None else 0
    entries = []
    carried = 0
    for i, s in enumerate(sessions):
        name = names[i] if names is not None else f"s{i:04d}"
        sid = getattr(s, "sid", None)
        with s._lock:
            rec = s._spill
            if rec is not None and rec.tier == "corrupt":
                # no state to persist (carrying a stale base record would
                # silently resurrect it)
                raise RestoreCorrupt(str(rec.error), dict(rec.error.evidence)) from rec.error
            ver = s._ckpt_ver
            prev = prev_map.get(name)
            clean = prev is not None and prev.get("ver") == ver and prev.get("sid") == sid
            src = os.path.normpath(os.path.join(base, prev["dir"])) if clean else None
            if clean and not os.path.isdir(src):
                clean = False  # base record gone: write it again
            if clean:
                entry = {"name": name, "plan": plan_spec(s.plan), "nbytes": prev["nbytes"],
                         "sid": sid, "ver": ver, "gen": prev.get("gen", 0)}
                if full:
                    # compaction: a byte copy, no device copy, no CRC work
                    shutil.copytree(src, os.path.join(path, name))
                    entry["dir"] = name
                else:
                    entry["dir"] = os.path.relpath(src, path)  # delta carry
                entries.append(entry)
                carried += 1
                continue
            if rec is None:
                leaves, meta = _extract_state(s)
                (leaves,) = _device_get([leaves])
            elif rec.tier == "transit":
                (leaves,) = _device_get([rec.leaves])
                meta = rec.meta
            elif rec.tier == "host":
                leaves, meta = rec.leaves, rec.meta
            else:  # disk
                leaves, meta = _read_record(rec.path)
            meta = dict(meta)
            meta["policy"] = _policy_fields(s.policy)
            meta["ckpt_ver"] = ver
            # the stable session id rides the checkpoint (placement
            # identity); devices are not persisted
            if sid is not None:
                meta["sid"] = sid
            nbytes = _write_record(os.path.join(path, name), leaves, meta)
        entries.append({"name": name, "dir": name, "plan": plan_spec(s.plan),
                        "nbytes": nbytes, "sid": sid, "ver": ver, "gen": this_gen})
    doc = {"format": 2, "gen": this_gen, "carried": carried, "sessions": entries}
    if base is not None:
        doc["base"] = os.path.basename(os.path.normpath(base))
    with open(os.path.join(path, "fleet.json"), "w") as f:
        json.dump(doc, f, indent=1)
    bump("checkpoints")
    bump("checkpoint_records_carried", carried)
    bump("checkpoint_records_written", len(entries) - carried)
    return {e["name"]: e["dir"] for e in entries}


def load_fleet(path: str, *, residency: ResidentSet | None = None, names=None,
               device=None):
    """Rebuild a fleet from a :func:`save_fleet` snapshot. Plans come back
    from their exact specs; each session with its counters, drift policy,
    Woodbury state and probe row, and it solves bitwise like its
    pre-checkpoint self (plain and checked paths).

    Sessions are placed on `device` (the card by default: without one this
    raises, it never carries on on the CPU; pass ``device="cpu"`` for the
    plain versions). With `residency=None` every session is restored
    resident (eager copies); with a ResidentSet they register host-tier and
    fault in on first touch (the scalable warm restart: restore costs file
    reads, traffic pulls in the working set). Returns the sessions in
    checkpoint order. A corrupt record raises :class:`RestoreCorrupt`.
    `names` restores a subset (checkpoint order kept); unknown names raise
    KeyError."""
    from conflux_tpu_torch.serve import SolveSession, plan_from_spec
    from conflux_tpu_torch.update import DriftPolicy

    dev = resolve_device(device)
    with open(os.path.join(path, "fleet.json")) as f:
        fleet = json.load(f)
    entries = fleet["sessions"]
    if names is not None:
        want = set(names)
        have = {e["name"] for e in entries}
        if not want <= have:
            raise KeyError(f"snapshot {path} has no session(s) {sorted(want - have)}")
        entries = [e for e in entries if e["name"] in want]
    sessions = []
    for e in entries:
        plan = plan_from_spec(e["plan"])
        leaves, meta = _read_record(os.path.join(path, e["dir"]))
        pol = DriftPolicy(**meta["policy"]) if meta.get("policy") is not None else None
        s = SolveSession(plan, None, None, None, pol, device=dev, sid=meta.get("sid"))
        rec = _SpillRecord("host", leaves, meta, nbytes=_host_nbytes(leaves))
        with s._lock:
            c = meta["counters"]
            s.factorizations = c["factorizations"]
            s.solves = c["solves"]
            s.updates = c["updates"]
            s.refactors = c["refactors"]
            s.last_cond = meta["last_cond"]
            s._owns_base = meta["owns_base"]
            # resume the dirty clock where the record left it
            s._ckpt_ver = int(meta.get("ckpt_ver", 0) or 0)
            s._factors = None
            s._spill = rec
        sessions.append(s)
    if residency is not None:
        residency.adopt(*sessions)
    else:
        for s in sessions:
            with s._lock:
                rec = s._spill
                _implant(s, _leaves_to_device(s, rec.leaves), rec.meta)
                s._spill = None
            bump("revives_h2d")
    bump("restores")
    return sessions
