"""Zero-copy fabric wire: shm payload rings + batched control plane
(DESIGN §31).

The §28 fabric's ``ProcessHost`` originally pickled every RHS and every
solution over its AF_UNIX pipe — four buffer copies and one pipe
round-trip per request, paid per message. This module re-applies the
paper's communication discipline (move bytes once, in bulk — PAPER.md
§1) and the §19 staging lesson (host-stage in numpy, batch the
boundary crossing) at the RPC layer:

- **Payload rings** (:class:`Ring`): one ``multiprocessing.
  shared_memory`` segment per direction per host. The front stages a
  numpy RHS directly into a ring-allocated record (ONE memcpy) and
  ships only a compact descriptor (offset, size, generation, dtype,
  shape) over the control pipe; the worker maps a numpy view onto the
  same bytes and feeds it straight to the engine — the next copy is
  the h2d staging the engine pays anyway. Results come back the same
  way through the reply ring.
- **Generation tags**: every record carries its allocation generation
  in a header AND a footer; the descriptor carries it too. A reader
  whose record fails the check — a SIGKILL mid-write left the footer
  unwritten (torn), a stale descriptor points at a recycled slot, or
  the descriptor names bytes outside the segment (overrun) — raises a
  structured :class:`~conflux_tpu_torch.resilience.WireCorrupt` instantly.
  The payload channel can no longer be trusted, so the front treats it
  exactly like a torn pipe: instant structural death, never a hang.
- **Cursor reclaim, no scanning**: records are bump-allocated off a
  monotonic u64 write cursor (wrap = skip the tail). The request ring
  is reclaimed entirely by the front (records freed when their reply
  lands, out-of-order safe); the reply ring's read cursor is the one
  shared word — the front advances it in the segment header after
  copying a reply out, the worker reads it when sizing free space. A
  torn cursor read can at worst mis-size an allocation, and the
  generation check turns that into a structured error, not silent
  corruption.
- **Backpressure, never a blocking wait**: a full request ring raises
  :class:`RingFull` with a ``retry_after`` sized from the ring's own
  measured drain rate (bytes freed per second, EMA) — the fabric front
  maps it to ``HostUnavailable(retry_after=)``. The worker's reply
  side may briefly wait for the front to drain, then falls back to
  shipping the value inline on the control frame (pickle) so progress
  is never gated on ring space.
- **Batched control plane**: descriptors ride ``solve_many`` /
  ``reply_many`` frames. Both pumps batch opportunistically — while
  one frame is in flight on the pipe, every submission that arrives
  queues into the next frame — so the per-message pipe overhead
  amortizes across the coalescing window instead of being paid per
  request (zero added latency when idle; ``batch_window_s`` can
  stretch the window deliberately).

Fault sites (`resilience.FaultPlan`): ``ring_full`` forces an
allocation refusal, ``torn_segment`` / ``stale_generation`` force the
reader-side integrity trips — `scripts/torch_soak.py --fabric` drives them
through real shared segments via :class:`InProcWire`.

``ProcessHost(wire="pickle")`` is the escape hatch: the pre-§31 wire,
byte-identical behavior, no segments.
"""

from __future__ import annotations

import dataclasses
import secrets
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future
from multiprocessing import shared_memory
from typing import Any, Callable

import numpy as np

from conflux_tpu_torch import resilience
from conflux_tpu_torch.resilience import WireCorrupt, bump

__all__ = ["Ring", "RingFull", "WireConfig", "WireClient", "WireServer",
           "InProcWire", "WireCorrupt"]

_MAGIC = 0x43465857        # "CFXW"
_VERSION = 1
_ALIGN = 64                # record spans round up to cache lines
_CTRL = 64                 # segment control header bytes
# control header: magic u32, version u32, capacity u64, R u64, W u64
_CTRL_FMT = struct.Struct("<IIQQQ")
_CTRL_R_OFF = 16           # byte offset of the shared read cursor
_CTRL_W_OFF = 24
# record header: magic u32, generation u32, payload bytes u64, span u64
_HDR = struct.Struct("<IIQQ")
# record footer: generation u32, ~generation u32 — written LAST, so a
# writer killed mid-copy leaves a detectable tear
_FTR = struct.Struct("<II")
_U64 = struct.Struct("<Q")


def _round_up(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def _fire(plan, site: str) -> bool:
    """True when the installed/explicit FaultPlan fires `site` (wire
    faults use the generic 'crash' kind). One None check in
    production."""
    p = plan if plan is not None else resilience.active_faults()
    if p is None:
        return False
    return p.fire(site, kinds=("crash",)) is not None


class RingFull(RuntimeError):
    """A ring allocation was refused — the segment holds `needed` more
    bytes than `capacity` minus what is still in flight. NEVER a
    blocking wait on the hot path: `retry_after` is sized from the
    ring's measured drain rate (bytes freed per second), so a retrying
    caller lands as space actually frees up. The fabric front maps
    this to ``HostUnavailable(retry_after=)``."""

    def __init__(self, msg: str, retry_after: float = 0.0,
                 needed: int = 0, capacity: int = 0):
        super().__init__(msg)
        self.retry_after = retry_after
        self.needed = needed
        self.capacity = capacity
        bump("wire_ring_full")


@dataclasses.dataclass
class WireConfig:
    """Knobs for one host's shm wire (TUNING.md "Zero-copy wire").

    ring_bytes: capacity of EACH payload ring (request + reply).
    max_payload_frac: payloads larger than this fraction of the ring
        ride the pickle wire instead (a single huge RHS must not be
        able to wedge the ring).
    batch_window_s: deliberate control-frame coalescing window on top
        of the opportunistic batching (0 = opportunistic only — zero
        added latency when idle).
    reply_wait_s: how long the worker's reply pump may wait for ring
        space before falling back to an inline (pickle) value — bounds
        the reply path, never a hang.
    max_frame_items: cap on descriptors per control frame. A burst
        bigger than this is sliced into consecutive frames so the
        worker starts draining the FIRST slice while the front is
        still staging the rest — unbounded frames collapse the
        pipeline into lockstep phases (stage-all, serve-all,
        decode-all).
    """

    ring_bytes: int = 8 << 20
    max_payload_frac: float = 0.25
    batch_window_s: float = 0.0
    reply_wait_s: float = 0.25
    max_frame_items: int = 64

    def __post_init__(self):
        if self.ring_bytes < 4096:
            raise ValueError("ring_bytes must be >= 4096")
        if not (0.0 < self.max_payload_frac <= 1.0):
            raise ValueError("max_payload_frac must be in (0, 1]")
        if self.batch_window_s < 0 or self.reply_wait_s < 0:
            raise ValueError("windows must be >= 0")
        if self.max_frame_items < 1:
            raise ValueError("max_frame_items must be >= 1")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "WireConfig":
        return cls(**d)


class Ring:
    """One shared-memory payload ring (single writer, single reader).

    NOT internally locked: the owning endpoint serializes access (the
    WireClient guards its request ring with its own lock; the reply
    ring's writer and reader each live on exactly one thread).
    `reclaim='local'` keeps the free list on the writer (out-of-order
    frees — the request ring); `reclaim='shared'` trusts the segment's
    shared read cursor, advanced by the reader via :meth:`release`
    (FIFO — the reply ring)."""

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int,
                 *, created: bool, reclaim: str = "local"):
        self._shm = shm
        # alias, not a new export: shm.buf returns its one stored
        # memoryview, and the hot paths touch it several times per
        # record — skip the property walk
        self._buf = shm.buf
        self.name = shm.name
        self.capacity = capacity
        self._created = created
        self._reclaim = reclaim
        self._closed = False
        self._unlinked = False
        # writer state (meaningful on the writing side only)
        self._w = 0                      # monotonic byte cursor
        self._gen = 0
        self._free_floor = 0             # all records before this freed
        self._inflight: deque = deque()  # [start, span, freed]
        self._by_start: dict[int, list] = {}
        # reader state (reply ring): last released cursor, monotonic
        self._released = 0

    # -- lifecycle ------------------------------------------------------ #

    @classmethod
    def create(cls, name: str, capacity: int,
               reclaim: str = "local") -> "Ring":
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=_CTRL + capacity)
        _CTRL_FMT.pack_into(shm.buf, 0, _MAGIC, _VERSION, capacity, 0, 0)
        return cls(shm, capacity, created=True, reclaim=reclaim)

    @classmethod
    def attach(cls, name: str, reclaim: str = "local") -> "Ring":
        shm = shared_memory.SharedMemory(name=name, create=False)
        # Python <= 3.12 registers ATTACHED segments with this
        # process's resource tracker, whose exit-time cleanup would
        # unlink a segment the creator still owns — unregister; the
        # creating side keeps its registration as the leak backstop.
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker layout varies
            pass
        magic, ver, cap, _r, _w = _CTRL_FMT.unpack_from(shm.buf, 0)
        if magic != _MAGIC or ver != _VERSION:
            shm.close()
            raise WireCorrupt(
                f"segment {name} is not a conflux wire ring "
                f"(magic {magic:#x} ver {ver})", kind="overrun")
        return cls(shm, cap, created=False, reclaim=reclaim)

    def close(self, unlink: bool | None = None) -> None:
        """Detach (and, for the creator by default, unlink) the
        segment. Never raises — teardown runs on corpse-cleanup
        paths. Detach and unlink are tracked separately so a shared
        Ring (the loopback harness) unlinks even when a detach-only
        close landed first."""
        if unlink is None:
            unlink = self._created
        if not self._closed:
            self._closed = True
            try:
                self._shm.close()
            except BufferError:
                # a payload view is still exported (a solve racing
                # shutdown); the fd stays open until the view dies,
                # but the NAME must go away now
                pass
            except OSError:
                pass
        if unlink and not self._unlinked:
            self._unlinked = True
            try:
                self._shm.unlink()
            except (FileNotFoundError, OSError):
                pass

    # -- shared cursors -------------------------------------------------- #

    def _shared_r(self) -> int:
        return _U64.unpack_from(self._buf, _CTRL_R_OFF)[0]

    def _set_shared_r(self, v: int) -> None:
        _U64.pack_into(self._buf, _CTRL_R_OFF, v)

    def _shared_w(self) -> int:
        return _U64.unpack_from(self._buf, _CTRL_W_OFF)[0]

    def _set_shared_w(self, v: int) -> None:
        _U64.pack_into(self._buf, _CTRL_W_OFF, v)

    def used_bytes(self) -> int:
        """In-flight bytes (either side — reads the shared mirrors)."""
        try:
            return max(0, self._shared_w() - self._shared_r())
        except (ValueError, OSError):
            return 0

    # -- writer side ----------------------------------------------------- #

    def _floor(self) -> int:
        return (self._free_floor if self._reclaim == "local"
                else self._shared_r())

    def stage(self, arr: np.ndarray) -> dict:
        """Allocate a record and copy `arr` into it (the ONE host-side
        copy of the send path). Returns the descriptor the control
        frame ships: offset/size/generation/cursor/span/dtype/shape.
        Raises :class:`RingFull` (retry_after=0 — the owning endpoint
        enriches it with the measured drain hint)."""
        arr = np.ascontiguousarray(arr)
        size = int(arr.nbytes)
        rec = _HDR.size + _round_up(size + _FTR.size, _ALIGN)
        cap = self.capacity
        pos = self._w % cap
        skip = cap - pos if pos + rec > cap else 0
        span = skip + rec
        if span > cap - (self._w - self._floor()):
            raise RingFull(
                f"ring {self.name} full: need {span} bytes, "
                f"{cap - (self._w - self._floor())} free of {cap}",
                needed=span, capacity=cap)
        off = 0 if skip else pos
        base = _CTRL + off
        self._gen = gen = (self._gen % 0xFFFFFFFF) + 1
        buf = self._buf
        _HDR.pack_into(buf, base, _MAGIC, gen, size, span)
        if size:
            dst = np.ndarray(arr.shape, arr.dtype, buffer=buf,
                             offset=base + _HDR.size)
            np.copyto(dst, arr)
            del dst
        _FTR.pack_into(buf, base + _HDR.size + size,
                       gen, gen ^ 0xFFFFFFFF)
        start = self._w
        self._w = start + span
        self._set_shared_w(self._w)
        if self._reclaim == "local":
            ent = [start, span, False]
            self._inflight.append(ent)
            self._by_start[start] = ent
        return {"o": off, "n": size, "g": gen, "c": start, "p": span,
                "t": arr.dtype.str, "s": tuple(arr.shape)}

    def free(self, desc: dict) -> int:
        """Reclaim a staged record (local mode; out-of-order safe —
        the floor advances over the contiguous freed prefix). Returns
        the bytes actually reclaimed by this call."""
        ent = self._by_start.pop(desc["c"], None)
        if ent is None:
            return 0
        ent[2] = True
        freed = 0
        while self._inflight and self._inflight[0][2]:
            start, span, _ = self._inflight.popleft()
            self._free_floor = start + span
            freed += span
        if freed:
            self._set_shared_r(self._free_floor)
        return freed

    # -- reader side ----------------------------------------------------- #

    def read(self, desc: dict, *, copy: bool,
             fault_plan=None, host: str | None = None) -> np.ndarray:
        """Map a descriptor back to its payload, VALIDATED: magic,
        descriptor-vs-header generation (stale slot), footer
        generation (torn write), bounds (overrun). `copy=False`
        returns a live view into the segment — the caller must hold
        the record allocated until done with it."""
        off, size, gen = desc["o"], desc["n"], desc["g"]
        if (off < 0 or size < 0
                or off + _HDR.size + size + _FTR.size > self.capacity):
            raise WireCorrupt(
                f"descriptor names bytes outside ring {self.name} "
                f"(off={off} size={size} cap={self.capacity})",
                kind="overrun", host=host)
        base = _CTRL + off
        buf = self._buf
        magic, hgen, hsize, _span = _HDR.unpack_from(buf, base)
        if _fire(fault_plan, "stale_generation"):
            hgen = gen + 1  # injected: descriptor outlived its slot
        if magic != _MAGIC or hgen != gen or hsize != size:
            raise WireCorrupt(
                f"stale record in ring {self.name}: descriptor "
                f"gen={gen} size={size}, header gen={hgen} "
                f"size={hsize} (slot recycled under a live "
                "descriptor)", kind="stale_generation", host=host)
        fgen, finv = _FTR.unpack_from(buf, base + _HDR.size + size)
        if _fire(fault_plan, "torn_segment"):
            fgen = 0  # injected: writer died before the footer landed
        if fgen != gen or finv != gen ^ 0xFFFFFFFF:
            raise WireCorrupt(
                f"torn record in ring {self.name}: footer gen={fgen} "
                f"!= {gen} — the writer died mid-copy",
                kind="torn_segment", host=host)
        view = np.ndarray(desc["s"], np.dtype(desc["t"]), buffer=buf,
                          offset=base + _HDR.size)
        return view.copy() if copy else view

    def release(self, desc: dict) -> None:
        """Reader-side acknowledge (shared mode): advance the shared
        read cursor past this record. Replies are decoded in frame
        order, so the cursor is monotonic by construction."""
        end = desc["c"] + desc["p"]
        if end > self._released:
            self._released = end
            self._set_shared_r(end)


# --------------------------------------------------------------------------- #
# endpoints
# --------------------------------------------------------------------------- #


class WireClient:
    """The front half of one host's shm wire.

    Owns the request ring (stage on submit, free when the reply
    lands), decodes reply frames against the reply ring, and runs the
    send pump that batches descriptors into ``solve_many`` control
    frames. Future bookkeeping stays with the owner (ProcessHost's
    pending map / InProcWire) — the client only moves bytes and
    descriptors."""

    def __init__(self, req: Ring, rep: Ring,
                 send: Callable[[dict], None], *,
                 host_id: str = "?",
                 config: WireConfig | None = None,
                 fault_plan=None,
                 on_send_error: Callable[[list, Exception], None]
                 | None = None):
        self.host_id = host_id
        self.config = config if config is not None else WireConfig()
        self._req = req
        self._rep = rep
        self._send = send
        self._faults = fault_plan
        self._on_send_error = on_send_error
        self._lock = threading.Lock()
        self._have = threading.Condition(self._lock)
        self._outbox: list[dict] = []        # guarded-by: _lock
        self._by_mid: dict[int, dict] = {}   # guarded-by: _lock
        self._dead: Exception | None = None  # guarded-by: _lock
        # measured drain: bytes freed per second, EMA (retry hints)
        self._drain_ema = 0.0                # guarded-by: _lock
        self._drain_t0 = time.perf_counter()  # guarded-by: _lock
        self._drain_bytes = 0                # guarded-by: _lock
        self.staged = 0                      # guarded-by: _lock
        self.frames = 0                      # guarded-by: _lock
        self.replies = 0                     # guarded-by: _lock
        self._pump = threading.Thread(
            target=self._send_loop, daemon=True,
            name=f"wire-send-{host_id}")
        self._pump.start()

    # -- submit path ----------------------------------------------------- #

    def payload_fits(self, nbytes: int) -> bool:
        return nbytes <= self.config.max_payload_frac * self._req.capacity

    def submit(self, mid: int, sid, arr: np.ndarray, qos=None,
               op: str = "solve") -> None:
        """Stage one request payload and enqueue its descriptor for
        the next control frame. Raises :class:`RingFull` (with a
        measured-drain retry hint) or ConnectionError (wire dead)."""
        with self._lock:
            if self._dead is not None:
                raise ConnectionError(
                    f"wire to host {self.host_id} is dead: "
                    f"{self._dead}")
            if _fire(self._faults, "ring_full"):
                raise RingFull(
                    f"ring {self._req.name} full (injected)",
                    retry_after=self._retry_hint_locked(1),
                    needed=int(arr.nbytes), capacity=self._req.capacity)
            try:
                desc = self._req.stage(arr)
            except RingFull as e:
                e.retry_after = self._retry_hint_locked(e.needed)
                raise
            self._by_mid[mid] = desc
            item = {"id": mid, "sid": sid, "d": desc}
            if qos is not None:
                item["q"] = qos
            if op != "solve":
                item["op"] = op
            self._outbox.append(item)
            self.staged += 1
            self._have.notify()

    def submit_many(self, entries: list) -> int:
        """Stage a BURST of requests under one lock acquisition —
        `entries` is [(mid, sid, arr, qos, op)]. Returns how many of
        the leading entries were staged; a short count means the ring
        filled mid-burst and the caller resubmits the tail after the
        drain hint. Raises :class:`RingFull` only when NOTHING could
        be staged (enriched with the measured-drain retry hint) and
        ConnectionError when the wire is dead. This is the front half
        of the batched control plane: N payloads, one lock, one pump
        wakeup, (opportunistically) one ``solve_many`` frame."""
        staged = 0
        with self._lock:
            if self._dead is not None:
                raise ConnectionError(
                    f"wire to host {self.host_id} is dead: "
                    f"{self._dead}")
            if _fire(self._faults, "ring_full"):
                raise RingFull(
                    f"ring {self._req.name} full (injected)",
                    retry_after=self._retry_hint_locked(1),
                    needed=int(entries[0][2].nbytes),
                    capacity=self._req.capacity)
            for mid, sid, arr, qos, op in entries:
                try:
                    desc = self._req.stage(arr)
                except RingFull as e:
                    if staged == 0:
                        e.retry_after = self._retry_hint_locked(
                            e.needed)
                        raise
                    break
                self._by_mid[mid] = desc
                item = {"id": mid, "sid": sid, "d": desc}
                if qos is not None:
                    item["q"] = qos
                if op != "solve":
                    item["op"] = op
                self._outbox.append(item)
                staged += 1
            self.staged += staged
            if staged:
                self._have.notify()
        return staged

    # requires-lock: _lock
    def _retry_hint_locked(self, needed: int) -> float:
        rate = self._drain_ema
        if rate <= 0.0:
            return 0.01
        return min(1.0, max(1e-4, needed / rate))

    # requires-lock: _lock
    def _note_drain_locked(self, nbytes: int) -> None:
        self._drain_bytes += nbytes
        now = time.perf_counter()
        dt = now - self._drain_t0
        if dt >= 0.05:
            rate = self._drain_bytes / dt
            self._drain_ema = (rate if self._drain_ema == 0.0
                               else 0.3 * rate + 0.7 * self._drain_ema)
            self._drain_t0 = now
            self._drain_bytes = 0

    def _send_loop(self) -> None:
        window = self.config.batch_window_s
        cap_items = self.config.max_frame_items
        while True:
            with self._lock:
                while not self._outbox and self._dead is None:
                    self._have.wait()
                if self._dead is not None:
                    return
                items = self._outbox[:cap_items]
                del self._outbox[:cap_items]
            if window > 0.0 and len(items) < cap_items:
                # deliberate coalescing on top of the opportunistic
                # batching: widen this frame's window
                time.sleep(window)
                with self._lock:
                    take = cap_items - len(items)
                    items.extend(self._outbox[:take])
                    del self._outbox[:take]
            try:
                self._send({"op": "solve_many", "items": items})
                with self._lock:
                    self.frames += 1
            except (OSError, ValueError) as e:
                if self._on_send_error is not None:
                    self._on_send_error(items, e)
                self.fail(ConnectionError(
                    f"wire send to host {self.host_id} failed: {e!r}"))
                return

    # -- reply path (recv thread only) ------------------------------------ #

    def decode(self, items: list) -> list[tuple[int, dict]]:
        """Decode one ``reply_many`` frame into [(mid, reply-dict)]
        pairs shaped exactly like the pickle wire's replies. Frees the
        matching request records and releases the reply records.
        Raises :class:`WireCorrupt` on a torn/stale/overrun reply —
        the owner must then declare the host structurally dead."""
        out: list[tuple[int, dict]] = []
        with self._lock:
            # one lock for the whole frame: pop + free every matching
            # request record, then read the reply payloads unlocked
            # (the reply ring's reader side is this thread only)
            for it in items:
                req_desc = self._by_mid.pop(it["id"], None)
                if req_desc is not None:
                    self._note_drain_locked(self._req.free(req_desc))
            self.replies += len(items)
        for it in items:
            mid = it["id"]
            d = it.get("d")
            if d is None:
                if it.get("ok"):
                    # inline (pickle-fallback) value: same reply shape
                    # as a ring-borne one
                    out.append((mid, {"id": mid, "ok": True,
                                      "value": it.get("v")}))
                else:
                    out.append((mid, it))  # structured error frame
                continue
            try:
                arr = self._rep.read(d, copy=True,
                                     fault_plan=self._faults,
                                     host=self.host_id)
            except WireCorrupt:
                raise
            finally:
                # even a torn record's span must not wedge the cursor
                self._rep.release(d)
            out.append((mid, {"id": mid, "ok": True, "value": arr}))
        return out

    # NOTE: there is deliberately no per-mid "forget" — an abandoned
    # (timed-out) request's ring record is reclaimed by its LATE reply
    # (decode frees unconditionally), so forgetting the mid early
    # would leak the record until the wire dies.

    # -- lifecycle / telemetry -------------------------------------------- #

    def fail(self, exc: Exception) -> None:
        with self._lock:
            if self._dead is None:
                self._dead = exc
            self._outbox = []
            self._by_mid.clear()
            self._have.notify_all()

    def close(self) -> None:
        self.fail(ConnectionError(
            f"wire to host {self.host_id} closed"))
        self._pump.join(timeout=5.0)
        self._req.close()
        self._rep.close()

    def stats(self) -> dict:
        with self._lock:
            staged, frames, replies = self.staged, self.frames, \
                self.replies
            drain = self._drain_ema
        return {"req_used": self._req.used_bytes(),
                "req_cap": self._req.capacity,
                "rep_used": self._rep.used_bytes(),
                "rep_cap": self._rep.capacity,
                "staged": staged, "frames": frames,
                "replies": replies,
                "drain_bytes_per_s": round(drain, 1)}


class WireServer:
    """The worker half: maps request descriptors to payload views,
    feeds them to a caller-supplied batched submit, and runs the reply
    pump that stages results into the reply ring (bounded wait, inline
    pickle fallback — progress is never gated on ring space) and
    batches reply descriptors into ``reply_many`` frames."""

    def __init__(self, req: Ring, rep: Ring,
                 send: Callable[[dict], None], *,
                 host_id: str = "?",
                 config: WireConfig | None = None,
                 encode_exc: Callable[[BaseException], dict]
                 | None = None,
                 fault_plan=None):
        self.host_id = host_id
        self.config = config if config is not None else WireConfig()
        self._req = req
        self._rep = rep
        self._send = send
        self._faults = fault_plan
        self._encode_exc = encode_exc or (lambda e: {
            "ok": False, "etype": type(e).__name__, "emsg": str(e),
            "extra": {}})
        self._lock = threading.Lock()
        self._have = threading.Condition(self._lock)
        # the reply ring has TWO staging threads (the recv thread's
        # inline echo path and the reply pump) — writer-side cursor
        # state is serialized here, never held across a drain wait
        self._rep_lock = threading.Lock()
        self._outbox: list[tuple[int, Any, BaseException | None]] = []  # guarded-by: _lock
        self._stop = False                   # guarded-by: _lock
        self.fallbacks = 0                   # guarded-by: _lock
        self._pump = threading.Thread(
            target=self._reply_loop, daemon=True,
            name=f"wire-reply-{host_id}")
        self._pump.start()

    # -- request path (recv thread) --------------------------------------- #

    def handle(self, msg: dict,
               submit_many: Callable[[list], list[Future]]) -> None:
        """One ``solve_many`` frame. `submit_many` takes
        [(sid, b_view, qos_dict)] and returns aligned futures (per-item
        failures set ON the futures). Views stay valid until the reply
        is staged — the front frees a request record only when its
        reply lands, and replies are staged only after completion."""
        batch: list[tuple[int, Any, Any, Any]] = []
        inline: list[dict] = []
        for it in msg["items"]:
            mid = it["id"]
            try:
                view = self._req.read(it["d"], copy=False,
                                      fault_plan=self._faults,
                                      host=self.host_id)
            # conflint: disable=CFX-EXCEPT wire op boundary: a corrupt request record fails ITS item structurally
            except BaseException as e:
                inline.append({"id": mid, **self._encode_exc(e)})
                continue
            if it.get("op") == "echo":
                # the wire microbench: payload straight back out,
                # engine bypassed — isolates the RPC layer. The reply
                # is staged and framed INLINE (this thread): an echo
                # is complete the moment it is read, so routing it
                # through the reply pump would buy a thread hop and a
                # per-item lock for nothing.
                inline.append(self._encode_reply(mid, view))
                continue
            batch.append((mid, it["sid"], view, it.get("q")))
        if inline:
            try:
                self._send({"op": "reply_many", "items": inline})
            except (OSError, ValueError):
                return  # front is gone; the recv loop sees the EOF
        if not batch:
            return
        futs = submit_many([(sid, b, q) for _, sid, b, q in batch])
        for (mid, _sid, _b, _q), fut in zip(batch, futs):
            fut.add_done_callback(
                lambda f, mid=mid: self._done(mid, f))

    def _done(self, mid: int, fut: Future) -> None:
        try:
            val = fut.result()
        # conflint: disable=CFX-EXCEPT wire op boundary: every failure (kills included) is wired back to the front
        except BaseException as e:
            self.reply(mid, exc=e)
        else:
            self.reply(mid, value=val)

    def reply(self, mid: int, value: Any = None,
              exc: BaseException | None = None) -> None:
        with self._lock:
            if self._stop:
                return
            self._outbox.append((mid, value, exc))
            self._have.notify()

    def debug_corrupt(self, mode: str = "torn_reply",
                      mid: int = -999) -> None:
        """Drill hook (scripts/torch_fabric_drill.py, tests): emit one reply
        whose ring record is deliberately corrupted — 'torn_reply'
        zeroes the footer (a writer killed mid-copy), 'stale_reply'
        bumps the header generation past the descriptor's (a recycled
        slot). The front's decode must raise WireCorrupt and declare
        the host structurally dead. Assumes a quiescent wire (the
        reply ring's writer cursor is pump-owned in production)."""
        arr = np.zeros(64, np.float32)
        desc = self._rep.stage(arr)
        base = _CTRL + desc["o"]
        buf = self._rep._shm.buf
        if mode == "stale_reply":
            _HDR.pack_into(buf, base, _MAGIC, desc["g"] + 1,
                           desc["n"], desc["p"])
        else:
            _FTR.pack_into(buf, base + _HDR.size + desc["n"], 0, 0)
        self._send({"op": "reply_many",
                    "items": [{"id": mid, "ok": True, "d": desc}]})

    def debug_partial_write(self) -> None:
        """Drill hook: leave the reply ring exactly as a SIGKILL
        mid-copy would — a header landed at the write head, the
        payload and footer never did (the caller dies right after)."""
        rep = self._rep
        base = _CTRL + rep._w % rep.capacity
        rep._gen += 1
        _HDR.pack_into(rep._shm.buf, base, _MAGIC, rep._gen,
                       1 << 20, 0)

    # -- reply pump -------------------------------------------------------- #

    def _stage_reply(self, arr: np.ndarray) -> dict | None:
        """Reply-ring allocation with a BOUNDED wait for the front to
        drain; None = fall back to an inline value."""
        deadline = time.perf_counter() + self.config.reply_wait_s
        while True:
            try:
                with self._rep_lock:
                    return self._rep.stage(arr)
            except RingFull:
                if time.perf_counter() >= deadline:
                    return None
                time.sleep(0.001)

    def _encode_reply(self, mid: int, val: Any) -> dict:
        """One successful reply → its frame item: ring-staged
        descriptor when the payload fits (bounded wait for drain),
        inline pickled value otherwise — progress is never gated on
        ring space."""
        arr = val if isinstance(val, np.ndarray) else None
        if (arr is not None and arr.dtype != object
                and arr.nbytes <= self.config.max_payload_frac
                * self._rep.capacity):
            desc = self._stage_reply(arr)
            if desc is not None:
                return {"id": mid, "ok": True, "d": desc}
            with self._lock:
                self.fallbacks += 1
            bump("wire_pickle_fallbacks")
        return {"id": mid, "ok": True, "v": val}

    def _reply_loop(self) -> None:
        while True:
            with self._lock:
                while not self._outbox and not self._stop:
                    self._have.wait()
                if self._stop and not self._outbox:
                    return
                pending = self._outbox
                self._outbox = []
            items = []
            for mid, val, exc in pending:
                if exc is not None:
                    items.append({"id": mid,
                                  **self._encode_exc(exc)})
                else:
                    items.append(self._encode_reply(mid, val))
            try:
                self._send({"op": "reply_many", "items": items})
            except (OSError, ValueError):
                return  # front is gone; the recv loop sees the EOF

    # -- lifecycle / telemetry --------------------------------------------- #

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._have.notify_all()
        self._pump.join(timeout=5.0)
        # the worker only ATTACHED: detach, never unlink — the front
        # owns the segment names (and unlinks them even if this
        # process is SIGKILLed before getting here)
        self._req.close(unlink=False)
        self._rep.close(unlink=False)

    def stats(self) -> dict:
        with self._lock:
            fallbacks = self.fallbacks
        return {"rep_used": self._rep.used_bytes(),
                "rep_cap": self._rep.capacity,
                "fallbacks": fallbacks}


# --------------------------------------------------------------------------- #
# segment naming + in-process loopback (tests, soak)
# --------------------------------------------------------------------------- #


def segment_names(host_id: str) -> tuple[str, str]:
    """(request, reply) segment names for one host — unique per
    start(), filesystem-visible under /dev/shm for leak audits. The
    host-id slice is capped at 10 chars so the full name stays <= 27:
    macOS limits POSIX shm names to 31 bytes (PSHMNAMLEN) including
    the leading '/' the stdlib prepends, and a longer host id must
    not make Ring.create fail there — the random token, not the id,
    carries uniqueness."""
    tok = secrets.token_hex(4)
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(host_id))[:10]
    return (f"cfxw-{safe}-{tok}-rq", f"cfxw-{safe}-{tok}-rp")


class InProcWire:
    """A single-process loopback of the whole wire — REAL shared
    segments, real generation/backpressure protocol, control frames
    crossing on in-process queues. `submit_many([(sid, b, qos)])`
    is supplied by the caller (an engine hook, or an echo). Used by
    the wire unit tests and the `scripts/torch_soak.py --fabric` wire
    hammer; the ProcessHost path wires the same two endpoint classes
    across the pipe instead."""

    def __init__(self, submit_many: Callable[[list], list[Future]], *,
                 config: WireConfig | None = None,
                 fault_plan=None, host_id: str = "loop"):
        cfg = config if config is not None else WireConfig()
        rq_name, rp_name = segment_names(host_id)
        self._req = Ring.create(rq_name, cfg.ring_bytes,
                                reclaim="local")
        self._rep = Ring.create(rp_name, cfg.ring_bytes,
                                reclaim="shared")
        self._submit_many = submit_many
        self._lock = threading.Lock()
        self._pending: dict[int, Future] = {}  # guarded-by: _lock
        self._next = 0                         # guarded-by: _lock
        self._dead: Exception | None = None    # guarded-by: _lock
        self.server = WireServer(self._req, self._rep,
                                 self._on_reply_frame, host_id=host_id,
                                 config=cfg)
        self.client = WireClient(self._req, self._rep,
                                 self._on_request_frame,
                                 host_id=host_id, config=cfg,
                                 fault_plan=fault_plan,
                                 on_send_error=self._on_send_error)

    # frames "cross the pipe": request frames run the server handler
    # on the client pump thread, reply frames decode on the server's
    # reply pump thread — same thread topology as the process wire
    def _on_request_frame(self, msg: dict) -> None:
        self.server.handle(msg, self._submit_many)

    def _on_reply_frame(self, msg: dict) -> None:
        try:
            pairs = self.client.decode(msg["items"])
        except WireCorrupt as e:
            self.fail(e)
            return
        for mid, reply in pairs:
            with self._lock:
                fut = self._pending.pop(mid, None)
            if fut is None:
                continue
            if reply.get("ok"):
                fut.set_result(reply.get("value", reply.get("v")))
            else:
                fut.set_exception(RuntimeError(
                    f"remote {reply.get('etype')}: "
                    f"{reply.get('emsg')}"))

    def _on_send_error(self, items: list, exc: Exception) -> None:
        self.fail(ConnectionError(f"loopback send failed: {exc!r}"))

    def solve(self, sid, b, qos=None, op: str = "solve") -> Future:
        fut: Future = Future()
        with self._lock:
            if self._dead is not None:
                raise ConnectionError(f"wire dead: {self._dead}")
            mid = self._next
            self._next += 1
            self._pending[mid] = fut
        try:
            self.client.submit(mid, sid, np.asarray(b), qos=qos, op=op)
        except BaseException:
            with self._lock:
                self._pending.pop(mid, None)
            raise
        return fut

    def fail(self, exc: Exception) -> None:
        """Instant structural death: every pending future fails NOW —
        the never-hang contract of the process wire, in-process."""
        with self._lock:
            if self._dead is None:
                self._dead = exc
            stranded = list(self._pending.values())
            self._pending.clear()
        self.client.fail(exc)
        for fut in stranded:
            if not fut.done():
                fut.set_exception(exc)

    def stats(self) -> dict:
        out = self.client.stats()
        out.update(self.server.stats())
        return out

    def close(self) -> None:
        self.fail(ConnectionError("wire closed"))
        self.server.close()
        self.client.close()
