"""Runtime lock-order / dispatch-discipline harness (conflint's
dynamic half, the port's copy of `conflux_tpu/analysis/lockcheck.py`).

Static CFX-LOCK proves guarded attributes are touched under their
lock, but two properties are only visible at run time: the ORDER in
which threads nest different locks (an A->B edge in one thread and a
B->A edge in another is a potential deadlock even if the test run gets
lucky), and whether a no-dispatch lock (the engine's admission lock)
is ever held across a device dispatch (which would serialize the
double-buffered pipeline behind the launch and can deadlock against
`on_full='block'` submitters).

`watch()` monkeypatches `threading.Lock`/`threading.RLock` so every
lock CREATED inside the context by the port's code (`_should_wrap`) is
wrapped with bookkeeping:

- each acquisition records held->acquired edges into a global
  lock-order graph; an edge that closes a cycle is reported as a
  potential deadlock with both lock names;
- locks created from the files in `forbid_dispatch_files` (default:
  the engine module) are marked no-dispatch; if one is held when a
  `serve.*` profiler region is entered (the dispatch sites, through
  `profiler._dispatch_hook`), that is a violation. Session RLocks are
  deliberately NOT forbidden: holding the session lock across a
  dispatch is the precision escalation's design.

Locks created before the context (module-level registry locks, and
those CUDA's lazy initialization and `torch.multiprocessing` make in
torch's own modules) are untouched; wrappers created inside keep
working after exit, they just stop reporting into a live state. One
process only: the serve fabric's worker processes (`ProcessHost`) run
their own engines, unwatched. Opt-in: production code never imports
this module; `scripts/torch_soak.py --lockcheck` and
`tests/test_torch_analysis.py` do.
"""

from __future__ import annotations

import contextlib
import os
import queue
import sys
import threading
from _thread import allocate_lock, get_ident

_STDLIB_QUEUE = os.path.abspath(queue.__file__)


class LockCheckState:
    """The shared books of one `watch()` session."""

    def __init__(self, forbid_dispatch_files=("engine.py",)):
        self.forbid_dispatch_files = tuple(forbid_dispatch_files)
        self._raw = allocate_lock()  # raw lock: never instrumented
        self._held: dict[int, list] = {}     # thread id -> wrapper stack
        # locks are keyed by a serial number given at creation, never by
        # id(): a dead wrapper's id is reused by a new one, which would
        # inherit its edges and report cycles that never happened
        self._adj: dict[int, set] = {}       # lock serial -> successor serials
        self._names: dict[int, str] = {}
        self._edges: set = set()
        self._seen_dispatch: set = set()
        self.locks = 0
        self.acquisitions = 0
        self.stash_edges = 0
        self.violations: list[str] = []

    # -- bookkeeping (called by the wrappers) ------------------------- #

    def _register(self, wrapper) -> None:
        with self._raw:
            self.locks += 1
            wrapper.serial = self.locks
            self._names[wrapper.serial] = wrapper.name

    def _reachable(self, src: int, dst: int) -> bool:
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._adj.get(n, ()))
        return False

    def note_acquire(self, wrapper, stash: bool = False) -> None:
        tid = get_ident()
        with self._raw:
            self.acquisitions += 1
            held = self._held.setdefault(tid, [])
            b = wrapper.serial
            if stash and held:
                # a victim-stash acquisition (tier._spill_batch): the
                # ONE deliberate session-lock -> session-lock nesting.
                # It is leaf-bounded — while holding the victim's lock
                # the spill path only ever takes the tier manager's
                # leaf lock, never blocks on another session or the
                # engine (phase 2 try-acquires), and a reviving
                # session is never a victim — so no realizable cycle
                # can pass through it (the lockdep 'nested' annotation,
                # applied by call site instead of at the call). Counted
                # but kept out of the order graph.
                self.stash_edges += 1
                held.append(wrapper)
                return
            for w in held:
                a = w.serial
                if a == b or (a, b) in self._edges:
                    continue
                # adding a->b: if b already reaches a, this edge closes
                # a cycle — two threads disagree on nesting order
                if self._reachable(b, a):
                    self.violations.append(
                        f"lock-order cycle: {w.name} -> {wrapper.name} "
                        f"while the reverse order exists elsewhere — "
                        "potential deadlock")
                self._edges.add((a, b))
                self._adj.setdefault(a, set()).add(b)
            held.append(wrapper)

    def note_release(self, wrapper) -> None:
        tid = get_ident()
        with self._raw:
            held = self._held.get(tid, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i] is wrapper:
                    del held[i]
                    break

    def note_dispatch(self, region: str) -> None:
        """profiler.region hook: a `serve.*` region is a device
        dispatch site — no-dispatch locks must not be held here."""
        if not region.startswith("serve."):
            return
        tid = get_ident()
        with self._raw:
            for w in self._held.get(tid, ()):
                if not w.no_dispatch:
                    continue
                key = (w.serial, region)
                if key in self._seen_dispatch:
                    continue
                self._seen_dispatch.add(key)
                self.violations.append(
                    f"no-dispatch lock {w.name} held across dispatch "
                    f"region '{region}' — the admission lock must "
                    "never cover device work")

    # -- public surface ------------------------------------------------ #

    def mark_no_dispatch(self, wrapper) -> None:
        """Explicitly forbid a wrapped lock across dispatch (tests)."""
        wrapper.no_dispatch = True

    def report(self) -> dict:
        with self._raw:
            return {"locks": self.locks,
                    "acquisitions": self.acquisitions,
                    "order_edges": len(self._edges),
                    "stash_edges": self.stash_edges,
                    "violations": list(self.violations)}


_STASH_SITES = (("tier.py", "_spill_batch"), ("tier.py", "_demote_one"))


def _is_stash_acquire() -> bool:
    """True when the acquisition call chain bottoms out in a blessed
    victim-stash site (see note_acquire). Walks past this module's own
    frames (wrapper acquire/__enter__)."""
    here = os.path.dirname(os.path.abspath(__file__))
    f = sys._getframe(1)
    for _ in range(6):
        if f is None:
            return False
        fn = os.path.abspath(f.f_code.co_filename)
        if os.path.dirname(fn) != here:
            return (os.path.basename(fn), f.f_code.co_name) \
                in _STASH_SITES
        f = f.f_back
    return False


class _LockWrap:
    """threading.Lock stand-in that reports into a LockCheckState."""

    _KIND = "Lock"

    def __init__(self, state, inner, name, no_dispatch):
        self._st = state
        self._inner = inner
        self.name = name
        self.no_dispatch = no_dispatch
        self.serial = 0  # set by LockCheckState._register

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._st.note_acquire(self, stash=_is_stash_acquire())
        return ok

    def release(self):
        self._st.note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<lockcheck {self._KIND} {self.name}>"


class _RLockWrap(_LockWrap):
    """threading.RLock stand-in: re-entrant acquisitions record one
    edge set (depth changes are invisible to lock ordering). Exposes
    the private Condition protocol (`_is_owned`/`_release_save`/
    `_acquire_restore`) by delegation, so `threading.Condition` built
    on a wrapped RLock waits correctly."""

    _KIND = "RLock"

    def acquire(self, blocking=True, timeout=-1):
        owned = self._inner._is_owned()
        ok = self._inner.acquire(blocking, timeout)
        if ok and not owned:
            self._st.note_acquire(self, stash=_is_stash_acquire())
        return ok

    def release(self):
        self._inner.release()
        if not self._inner._is_owned():
            self._st.note_release(self)

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        # Condition.wait: the full release bypasses our books on
        # purpose — the thread sleeps, so it can add no false edges,
        # and _acquire_restore rebalances before it runs again
        return self._inner._release_save()

    def _acquire_restore(self, state):
        return self._inner._acquire_restore(state)


def _creation_site() -> tuple:
    """(filename, lineno) of the frame that called threading.Lock()."""
    f = sys._getframe(2)
    here = os.path.dirname(os.path.abspath(__file__))
    while f is not None and os.path.dirname(
            os.path.abspath(f.f_code.co_filename)) == here:
        f = f.f_back
    if f is None:
        return ("<unknown>", 0)
    return (f.f_code.co_filename, f.f_lineno)


def _should_wrap(fname: str) -> bool:
    """Instrument locks created by the code under contract: the
    conflux_tpu_torch package, its tests (`test_torch_*`) and soak
    (`torch_soak.py`), and the stdlib queue module the engine builds on.
    Locks born inside torch (CUDA lazy init, `torch.multiprocessing`,
    whose own `queue.py` is not the stdlib's) stay raw: their ordering is
    not our contract, and wrapping them would report cycles this repo
    cannot fix."""
    torch = sys.modules.get("torch")
    if torch is not None and os.path.abspath(fname).startswith(
            os.path.dirname(os.path.abspath(torch.__file__)) + os.sep):
        return False
    base = os.path.basename(fname)
    return ("conflux_tpu_torch" in fname.split(os.sep)
            or os.path.abspath(fname) == _STDLIB_QUEUE
            or base.startswith("test_torch_")
            or base == "torch_soak.py")


@contextlib.contextmanager
def watch(forbid_dispatch_files=("engine.py",)):
    """Instrument every lock created inside the context (by the files
    `_should_wrap` selects); yields the :class:`LockCheckState` whose
    `violations` the caller asserts empty. Nesting watch() contexts is
    not supported."""
    from conflux_tpu_torch import profiler  # lazy: profiler imports torch

    state = LockCheckState(forbid_dispatch_files)
    orig_lock, orig_rlock = threading.Lock, threading.RLock

    def make(cls, factory):
        def build():
            fname, lineno = _creation_site()
            if not _should_wrap(fname):
                return factory()
            nd = (cls is _LockWrap and os.path.basename(fname)
                  in state.forbid_dispatch_files)
            w = cls(state, factory(),
                    f"{cls._KIND}@{os.path.basename(fname)}:{lineno}",
                    nd)
            state._register(w)
            return w

        return build

    threading.Lock = make(_LockWrap, orig_lock)
    threading.RLock = make(_RLockWrap, orig_rlock)
    prev_hook = profiler._dispatch_hook
    profiler._dispatch_hook = state.note_dispatch
    try:
        yield state
    finally:
        threading.Lock = orig_lock
        threading.RLock = orig_rlock
        profiler._dispatch_hook = prev_hook
