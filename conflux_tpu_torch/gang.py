"""Gang residency: device-resident stacked fleets for cross-session serving
(the port of `conflux_tpu/gang.py`).

The engine's ``stack_sessions`` path answers requests against different
sessions of one single-system plan in one dispatch. Re-stacking the
member sessions' factors for every window would pay in data movement what
the dispatch saves, so a :class:`SessionGang` keeps the stacked state
resident: same-plan sessions adopt into a shared stacked factor tree (plus
base, probe and drift stacks) on their device. Slots are assigned at
adopt and freed on release (a device move, or a spill of the member to
the host tier: `tier.ResidentSet`) or garbage collection; pad slots repeat slot
0; a slot round-trips bitwise (`batched.write_slot_tree` /
`unstack_tree`). A stacked solve reads the resident stack directly: no
restacking and no factor movement per dispatch beyond the RHS staging
every dispatch pays. Session mutations (``update``, ``refactor``, a drift
refactor) bump the session's `_gang_ver`, and the gang rewrites the
owning slot before the next dispatch, in place (`write_slot_tree` writes
one row of the gang-owned stack, the role of XLA's buffer donation in the
JAX package).

Drifted sessions stack too: the gang keeps a stacked rank-bucketed
Woodbury state (each slot's U, V, Y zero-padded to the gang's rank bucket,
Cinv extended with the identity, `update.pad_update_state`); a checked
gang keeps the stacked probe rows wA so the Freivalds verdict comes out
per slot (`update.health_verdict_from_stats_slots` on a blocked plan).

On the card, every write into a stack is queued on the current stream of
the thread that makes it, which is the engine lane's stream for the
dispatcher: the writes are ordered with the stacked dispatches that read
the stacks.

Locking: the gang RLock orders after any session RLock. Paths that hold a
session lock (`SolveSession.to_device`) may call :meth:`release`; the
adopt and refresh path (:meth:`ensure`) therefore never takes a session
lock while it holds the gang lock (its snapshot phase runs between two
gang-locked phases). The gang lock may be held across the stacked
dispatch, which keeps the in-place writes from overtaking a dispatch's
snapshot.
"""

from __future__ import annotations

import threading
import weakref

import torch

from conflux_tpu_torch.batched import grow_stack_tree, stack_trees, write_slot_tree
from conflux_tpu_torch.device import order_after_default, read_on_current
from conflux_tpu_torch.update import pad_update_state, rank_bucket


def _eye_stack(cap: int, kb: int, like: torch.Tensor) -> torch.Tensor:
    """(cap, kb, kb) identities in `like`'s dtype and device."""
    return torch.eye(kb, dtype=like.dtype, device=like.device).expand(cap, kb, kb).clone()


class SessionGang:
    """One plan's device-resident stacked fleet on one lane device.

    Owned by a `DeviceLane` (one gang per plan and lane): the lane's
    dispatcher adopts sessions on first stacked contact, refreshes stale
    slots (version mismatch) before dispatching, and slots free when a
    member is released or garbage-collected (weakref callbacks append to
    a lock-free list). Every stacked tensor is gang-owned: it comes out of
    the gang's own builds and writes, never out of a caller's hands, which
    is what licenses the in-place slot writes.
    """

    def __init__(self, plan, device):
        self.plan = plan
        self.device = device
        # the gang RLock: every attribute below is guarded by it
        self._lock = threading.RLock()
        self.cap = 0                    # guarded-by: _lock
        self._slots: list = []          # guarded-by: _lock (weakref|None)
        self._vers: list = []           # guarded-by: _lock (applied ver)
        self._free: list = []           # guarded-by: _lock
        self._by_id: dict = {}          # guarded-by: _lock (id -> slot)
        self._cancelled: set = set()    # guarded-by: _lock
        # per-slot drift occupancy: the slot's accumulated rank (0 = clean)
        # and its DriftPolicy.refine
        self._upd_kb: list = []         # guarded-by: _lock
        self._upd_refine: list = []     # guarded-by: _lock
        # the stacked device state
        self._F = None                  # guarded-by: _lock
        self._A0 = None                 # guarded-by: _lock
        self._wA = None                 # guarded-by: _lock
        self._KB = 0                    # guarded-by: _lock
        self._Up = None                 # guarded-by: _lock
        self._Vp = None                 # guarded-by: _lock
        self._Y = None                  # guarded-by: _lock
        self._Cinv = None               # guarded-by: _lock
        self._checked = False           # guarded-by: _lock
        # GC-freed slots: (slot, id) appended by weakref callbacks without
        # any lock (list.append holds the GIL; callbacks never block),
        # drained under the lock
        self._dead: list = []
        # counters (read by engine.stats/counters)
        self.adopts = 0                 # guarded-by: _lock
        self.releases = 0               # guarded-by: _lock
        self.refreshes = 0              # guarded-by: _lock
        self.rebuilds = 0               # guarded-by: _lock

    # ------------------------------------------------------------------ #
    # membership bookkeeping
    # ------------------------------------------------------------------ #

    @property
    def members(self) -> int:
        with self._lock:
            self._drain_dead_locked()
            return len(self._by_id)

    def slot_of(self, session):
        """The session's slot, or None (not a member)."""
        with self._lock:
            return self._by_id.get(id(session))

    def _make_ref(self, session, slot: int):
        dead = self._dead
        sid = id(session)

        def cb(_ref, dead=dead, slot=slot, sid=sid):
            # garbage-collector context: append only
            dead.append((slot, sid))

        return weakref.ref(session, cb)

    # requires-lock: _lock
    def _drain_dead_locked(self) -> None:
        while self._dead:
            try:
                slot, sid = self._dead.pop()
            except IndexError:  # a racing append emptied it
                break
            # id() reuse guard: free only when the id still maps to the
            # slot the dead session held
            if self._by_id.get(sid) == slot:
                del self._by_id[sid]
                self._free_slot_locked(slot)
                self.releases += 1

    # requires-lock: _lock
    def _free_slot_locked(self, slot: int) -> None:
        self._slots[slot] = None
        self._vers[slot] = -1
        self._upd_kb[slot] = 0
        self._upd_refine[slot] = 0
        self._free.append(slot)
        if not self._by_id:
            self._reset_locked()

    # requires-lock: _lock
    def _reset_locked(self) -> None:
        """Empty gang: drop every stacked tensor (frees the device memory)
        and return to the unbuilt state."""
        self.cap = 0
        self._slots = []
        self._vers = []
        self._free = []
        self._upd_kb = []
        self._upd_refine = []
        self._F = self._A0 = self._wA = None
        self._Up = self._Vp = self._Y = self._Cinv = None
        self._KB = 0

    def release(self, session) -> None:
        """Free the session's slot (`to_device`, a spill). The
        caller holds the session's RLock: release is the one gang entry
        reached from under a session lock, which is why `ensure` never
        nests the locks the other way. A release that races a pending
        adoption cancels it. The freed slot's stale contents are inert
        (slots never interact; a later adopt overwrites them)."""
        sid = id(session)
        with self._lock:
            self._drain_dead_locked()
            slot = self._by_id.pop(sid, None)
            if slot is None:
                self._cancelled.add(sid)
            else:
                self._free_slot_locked(slot)
                self.releases += 1
        session._gang = None
        session._gang_slot = None

    # ------------------------------------------------------------------ #
    # adopt / refresh (the dispatcher's pre-dispatch sync)
    # ------------------------------------------------------------------ #

    def _snap(self, session, checked: bool) -> dict:
        """One session's resident state, read under its lock (no gang
        lock held). Marks tentative membership, so that a concurrent
        release cancels the pending adoption."""
        with session._lock:
            # a spilled member revives first (from the dispatcher, a
            # bounded wait: `ResidentSet.fault_in`)
            session._ensure_resident()
            session._gang = self
            # the state is copied into the stacks on this thread's stream:
            # after the caller's work that made it, and kept from reuse
            # until the copies ran
            order_after_default(session._A0.device)
            session._lane_reads_base()
            probe = session._probe_row() if checked else None
            u = session._upd
            upd = None
            if u is not None:
                upd = (u["kb"], u["Up"], u["Vp"], u["Y"], u["Cinv"],
                       int(session.policy.refine))
            snap = {"session": session, "ver": session._gang_ver,
                    "F": session._factors, "A0": session._A0,
                    "probe": probe, "upd": upd}
            read_on_current((snap["F"], snap["A0"], probe, upd and upd[1:5]))
            return snap

    def ensure(self, sessions, max_stack: int, checked: bool):
        """Adopt the non-member `sessions` (as capacity allows), refresh
        stale members (a member mutated since its slot was written), and
        upgrade the gang to checked residency when the engine's health
        policy asks for it. Returns ``(admitted, excluded)``: admitted maps
        id(session) -> slot for every requested session that is a member
        after the call; excluded maps id(session) -> reason ('stack_cap',
        'singleton' or 'error') for the rest. Never takes a session lock
        while holding the gang lock."""
        # ---- phase A (gang lock): plan the work -----------------------
        with self._lock:
            self._drain_dead_locked()
            nmem = len(self._by_id)
            space = max(0, int(max_stack) - nmem)
            news, excluded = [], {}
            seen = set()
            for s in sessions:
                sid = id(s)
                if sid in seen:
                    continue
                seen.add(sid)
                if sid in self._by_id:
                    continue
                if space > 0:
                    news.append(s)
                    space -= 1
                else:
                    excluded[sid] = "stack_cap"
            total = nmem + len(news)
            rebuild = total >= 2 and (
                self.cap == 0
                or (checked and not self._checked)
                or self.cap > 2 * rank_bucket(max(2, total)))
            if checked:
                self._checked = True
            use_checked = self._checked
            dirty = []
            if not rebuild:
                for s in sessions:
                    slot = self._by_id.get(id(s))
                    if slot is not None and self._vers[slot] != s._gang_ver:
                        dirty.append(s)
            live = []
            if rebuild:
                for ref in self._slots:
                    s = None if ref is None else ref()
                    if s is not None:
                        live.append(s)
        # ---- phase B (no gang lock): snapshot under session locks -----
        need = (live + news) if rebuild else (news + dirty)
        snaps: dict[int, dict] = {}
        for s in need:
            sid = id(s)
            if sid in snaps:
                continue
            try:
                snaps[sid] = self._snap(s, use_checked)
            except Exception:  # noqa: BLE001 - adoption is best-effort
                excluded[sid] = "error"
        # ---- phase C (gang lock): apply -------------------------------
        with self._lock:
            self._drain_dead_locked()
            for sid in list(snaps):
                if sid in self._cancelled:
                    self._cancelled.discard(sid)
                    snaps.pop(sid)
            if rebuild:
                order = [snaps[id(s)] for s in (live + news) if id(s) in snaps]
                if len(order) >= 2:
                    self._install_build_locked(order)
                # members whose snapshot failed mid-rebuild left the stack
                for s in live:
                    if id(s) not in snaps and id(s) in self._by_id:
                        del self._by_id[id(s)]
            else:
                for s in news:
                    snap = snaps.get(id(s))
                    if snap is None:
                        continue
                    if self.cap == 0:
                        # a lone adoptee cannot build a stack: the engine
                        # dispatches it solo
                        excluded.setdefault(id(s), "singleton")
                        continue
                    self._adopt_one_locked(snap)
                for s in dirty:
                    snap = snaps.get(id(s))
                    if snap is None:
                        continue
                    slot = self._by_id.get(id(s))
                    if slot is not None:
                        self._write_slot_locked(slot, snap)
                        self.refreshes += 1
            admitted = {}
            for s in sessions:
                slot = self._by_id.get(id(s))
                if slot is not None:
                    admitted[id(s)] = slot
                    s._gang_slot = slot
                elif id(s) not in excluded:
                    excluded[id(s)] = "error"
            return admitted, excluded

    # requires-lock: _lock
    def _install_build_locked(self, snaps: list) -> None:
        """(Re)build every stacked tensor: the first adoption of a pair, a
        checked upgrade (the probe stack must cover every member), or a
        compaction after the live set shrank well below the bucket. Pad
        slots repeat slot 0."""
        n = len(snaps)
        cap = rank_bucket(max(2, n))
        pads = cap - n
        self._F = stack_trees([s["F"] for s in snaps] + [snaps[0]["F"]] * pads)
        self._A0 = torch.stack([s["A0"] for s in snaps] + [snaps[0]["A0"]] * pads)
        if self._checked:
            self._wA = torch.stack([s["probe"] for s in snaps]
                                   + [snaps[0]["probe"]] * pads)
        else:
            self._wA = None
        self.cap = cap
        self._by_id = {}
        self._slots = [None] * cap
        self._vers = [-1] * cap
        self._free = list(range(n, cap))[::-1]
        self._upd_kb = [0] * cap
        self._upd_refine = [0] * cap
        self._KB = 0
        self._Up = self._Vp = self._Y = self._Cinv = None
        drifted = [s["upd"] for s in snaps if s["upd"] is not None]
        if drifted:
            self._alloc_drift_locked(max(u[0] for u in drifted), drifted[0])
        for i, snap in enumerate(snaps):
            session = snap["session"]
            self._by_id[id(session)] = i
            self._slots[i] = self._make_ref(session, i)
            self._vers[i] = snap["ver"]
            if self._KB:
                self._write_drift_locked(i, snap["upd"])
            self.adopts += 1
        self.rebuilds += 1

    # requires-lock: _lock
    def _adopt_one_locked(self, snap: dict) -> None:
        """Adopt one session into a free slot (growing the bucket when none
        is free): one in-place row write per stacked component."""
        session = snap["session"]
        if not self._free:
            self._grow_locked(rank_bucket(self.cap + 1))
        slot = self._free.pop()
        self._by_id[id(session)] = slot
        self._slots[slot] = self._make_ref(session, slot)
        self._write_slot_locked(slot, snap)
        self.adopts += 1

    # requires-lock: _lock
    def _grow_locked(self, new_cap: int) -> None:
        self._F = grow_stack_tree(self._F, new_cap)
        self._A0 = grow_stack_tree(self._A0, new_cap)
        if self._wA is not None:
            self._wA = grow_stack_tree(self._wA, new_cap)
        if self._KB:
            self._Up = grow_stack_tree(self._Up, new_cap, fill="zero")
            self._Vp = grow_stack_tree(self._Vp, new_cap, fill="zero")
            self._Y = grow_stack_tree(self._Y, new_cap, fill="zero")
            self._Cinv = grow_stack_tree(self._Cinv, new_cap)
        grown = new_cap - self.cap
        self._free.extend(range(self.cap, new_cap)[::-1])
        self._slots += [None] * grown
        self._vers += [-1] * grown
        self._upd_kb += [0] * grown
        self._upd_refine += [0] * grown
        self.cap = new_cap

    # requires-lock: _lock
    def _write_slot_locked(self, slot: int, snap: dict) -> None:
        """Write one session's state into its slot, in place in the
        gang-owned stacks (adopt and refresh share this). Bitwise: the slot
        reads back exactly the session's resident bits."""
        self._F = write_slot_tree(self._F, snap["F"], slot)
        self._A0 = write_slot_tree(self._A0, snap["A0"], slot)
        if self._wA is not None:
            if snap["probe"] is None:
                raise AssertionError("checked gang snapshot without a probe row")
            self._wA = write_slot_tree(self._wA, snap["probe"], slot)
        u = snap["upd"]
        if u is not None and u[0] > self._KB:
            if self._KB == 0:
                self._alloc_drift_locked(u[0], u)
            else:
                self._repad_drift_locked(u[0])
        if self._KB:
            self._write_drift_locked(slot, u)
        self._vers[slot] = snap["ver"]

    # requires-lock: _lock
    def _alloc_drift_locked(self, kb: int, template: tuple) -> None:
        """First drifted member: allocate the stacked Woodbury state at
        rank bucket kb, zero U, V, Y (inert) and identity Cinv, in the
        template's dtypes (Y and Cinv in the plan's compute dtype)."""
        _kb, Up, Vp, Y, Cinv, _r = template
        n = Up.shape[-2]
        self._Up = Up.new_zeros((self.cap, n, kb))
        self._Vp = Vp.new_zeros((self.cap, n, kb))
        self._Y = Y.new_zeros((self.cap, n, kb))
        self._Cinv = _eye_stack(self.cap, kb, Cinv)
        self._KB = kb

    # requires-lock: _lock
    def _repad_drift_locked(self, kb2: int) -> None:
        """Grow the gang's rank bucket: zero-pad the U, V, Y columns and
        extend Cinv with the identity (inert for every slot: the
        `pad_update_state` algebra on the whole stack). The bucket stays
        until the gang rebuilds, so refactors do not thrash it."""
        kb = self._KB

        def pad(x):
            return torch.nn.functional.pad(x, (0, kb2 - kb))
        self._Up, self._Vp, self._Y = pad(self._Up), pad(self._Vp), pad(self._Y)
        C = _eye_stack(self.cap, kb2, self._Cinv)
        C[:, :kb, :kb] = self._Cinv
        self._Cinv = C
        self._KB = kb2

    # requires-lock: _lock
    def _write_drift_locked(self, slot: int, upd) -> None:
        kb = self._KB
        if upd is None:
            up = self._Up.new_zeros(self._Up.shape[1:])
            vp = self._Vp.new_zeros(self._Vp.shape[1:])
            y = self._Y.new_zeros(self._Y.shape[1:])
            ci = torch.eye(kb, dtype=self._Cinv.dtype, device=self._Cinv.device)
            self._upd_kb[slot] = 0
            self._upd_refine[slot] = 0
        else:
            k0, Up, Vp, Y, Cinv, refine = upd
            up, vp, y, ci = pad_update_state(Up, Vp, Y, Cinv, kb)
            self._upd_kb[slot] = k0
            self._upd_refine[slot] = refine
        self._Up = write_slot_tree(self._Up, up, slot)
        self._Vp = write_slot_tree(self._Vp, vp, slot)
        self._Y = write_slot_tree(self._Y, y, slot)
        self._Cinv = write_slot_tree(self._Cinv, ci, slot)

    # ------------------------------------------------------------------ #
    # dispatch-side reads
    # ------------------------------------------------------------------ #

    # requires-lock: _lock
    def prepare(self, sessions) -> dict:
        """A consistent dispatch snapshot (references only, no device
        work) for the request-carrying `sessions`. The caller holds the
        gang lock across this and the dispatch itself, so an in-place
        adopt cannot land between the two. Raises KeyError when a session
        lost its slot since `ensure` (a racing release); the engine then
        answers it solo."""
        slots = {id(s): self._by_id[id(s)] for s in sessions}
        drifted = [r for k, r in zip(self._upd_kb, self._upd_refine) if k]
        kb = self._KB if drifted else 0
        sweeps = self.plan.key.refine + (max(drifted) if drifted else 0)
        return {"cap": self.cap, "slots": slots, "F": self._F,
                "A0": self._A0, "wA": self._wA, "kb": kb,
                "sweeps": sweeps, "Up": self._Up, "Vp": self._Vp,
                "Y": self._Y, "Cinv": self._Cinv, "checked": self._checked}

    def stats(self) -> dict:
        with self._lock:
            self._drain_dead_locked()
            return {"members": len(self._by_id), "cap": self.cap,
                    "rank_bucket": self._KB, "checked": self._checked,
                    "adopts": self.adopts, "releases": self.releases,
                    "refreshes": self.refreshes, "rebuilds": self.rebuilds}
