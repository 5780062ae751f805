"""conflint rules in torch form: the port's serve-stack conventions as AST
checks (the port's copy of `conflux_tpu/analysis/rules.py`, with the
device-sync, donation and rebuild rules rewritten for PyTorch and CUDA).

| rule          | enforces                                               |
|---------------|--------------------------------------------------------|
| CFX-LOCK      | `# guarded-by: L` attrs touched only under `with L`    |
| CFX-DONATE    | donated tensors never read after the donating call     |
| CFX-HOSTSYNC  | no waits for the card inside `# hot-path` functions    |
| CFX-FUTURE    | `# futures-owner` except-edges resolve owned futures   |
| CFX-RECOMPILE | bucket programs at power-of-two keys, graphs built once|
| CFX-EXCEPT    | InjectedKill (BaseException) reaches the watchdog      |

Every rule is conservative where static analysis runs out of road
(documented per rule); the runtime half (`analysis.lockcheck`) covers
the dynamic remainder (lock-order cycles, lock-held-across-dispatch).
"""

from __future__ import annotations

import ast

from conflux_tpu_torch.analysis.core import Finding, SourceFile  # noqa: F401


def _is_pow2(n) -> bool:
    return isinstance(n, int) and not isinstance(n, bool) and n >= 1 \
        and not (n & (n - 1))


def _func_defs(tree):
    """(node, class_name_or_None) once per def in the module (ast.walk
    visits methods again after their ClassDef: deduped), memoized on the
    tree, which every rule walks."""
    memo = getattr(tree, "_conflint_defs", None)
    if memo is not None:
        return memo
    out = []
    seen: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    seen.add(id(item))
                    out.append((item, node.name))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) not in seen:
            out.append((node, None))
    tree._conflint_defs = out
    return out


def _self_attr(node) -> str | None:
    """'X' for an `self.X` attribute node, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


class Rule:
    id = "CFX-NONE"
    description = ""

    def check(self, sf: SourceFile, out: list) -> None:
        raise NotImplementedError


# --------------------------------------------------------------------- #
# CFX-LOCK — guarded attributes accessed only under their lock
# --------------------------------------------------------------------- #


class LockRule(Rule):
    """Attributes annotated `# guarded-by: L` on their initializing
    assignment must only be read/written inside `with self.L` (class
    attrs) / `with L` (module globals) — the discipline the engine's
    counters, the session's factor/drift state, and the profiler tables
    live by. `__init__` is exempt (construction happens-before
    publication); `# requires-lock: L` on a def marks helpers whose
    CALLERS hold the lock (trusted, not verified — keep such helpers
    private). Scope limit: only `self.`/module-global accesses are
    checked; cross-object accesses (`session._factors` from the engine)
    are the runtime harness's job."""

    id = "CFX-LOCK"
    description = "guarded-by attribute accessed outside its lock"

    def check(self, sf: SourceFile, out: list) -> None:
        # pass 1: collect guarded attrs per class, and module globals
        class_guards: dict[str, dict[str, str]] = {}
        mod_guards: dict[str, str] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                guards: dict[str, str] = {}
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        lock = sf.guard_on(sub)
                        if lock is None:
                            continue
                        targets = (sub.targets
                                   if isinstance(sub, ast.Assign)
                                   else [sub.target])
                        for t in targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                guards[attr] = lock
                if guards:
                    class_guards[node.name] = guards
        for stmt in sf.tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                lock = sf.guard_on(stmt)
                if lock is None:
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        mod_guards[t.id] = lock
        if not class_guards and not mod_guards:
            return

        # pass 2: walk every function with a held-locks context
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                guards = class_guards.get(node.name)
                if not guards:
                    continue
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and item.name != "__init__":
                        self._walk(sf, out, item.body, guards, "self",
                                   sf.required_locks(item))
        if mod_guards:
            for stmt in sf.tree.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self._walk(sf, out, stmt.body, mod_guards, None,
                               sf.required_locks(stmt))

    def _with_locks(self, stmt: ast.With, owner) -> set:
        got = set()
        for item in stmt.items:
            e = item.context_expr
            if owner == "self":
                attr = _self_attr(e)
                if attr is not None:
                    got.add(attr)
            elif isinstance(e, ast.Name):
                got.add(e.id)
        return got

    def _walk(self, sf, out, body, guards, owner, held) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure may run on another thread — conservative:
                # it holds nothing (its own withs still count)
                self._walk(sf, out, stmt.body, guards, owner,
                           sf.required_locks(stmt))
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held | self._with_locks(stmt, owner)
                for item in stmt.items:
                    self._scan_expr(sf, out, item.context_expr, guards,
                                    owner, held)
                self._walk(sf, out, stmt.body, guards, owner, inner)
                continue
            # expressions of this statement (conditions included) run
            # under `held`; child statement lists recurse
            for field, value in ast.iter_fields(stmt):
                if isinstance(value, ast.expr):
                    self._scan_expr(sf, out, value, guards, owner, held)
                elif isinstance(value, list):
                    if value and isinstance(value[0], ast.stmt):
                        self._walk(sf, out, value, guards, owner, held)
                    else:
                        for v in value:
                            if isinstance(v, ast.expr):
                                self._scan_expr(sf, out, v, guards,
                                                owner, held)
                            elif isinstance(v, ast.excepthandler):
                                self._walk(sf, out, v.body, guards,
                                           owner, held)

    def _scan_expr(self, sf, out, expr, guards, owner, held) -> None:
        for node in ast.walk(expr):
            name = None
            if owner == "self":
                attr = _self_attr(node)
                if attr in guards:
                    name = attr
            elif isinstance(node, ast.Name) and node.id in guards:
                name = node.id
            if name is None:
                continue
            lock = guards[name]
            if lock in held:
                continue
            who = f"self.{name}" if owner == "self" else name
            lockname = f"self.{lock}" if owner == "self" else lock
            sf.emit(out, self.id, node.lineno,
                    f"{who} accessed outside 'with {lockname}' "
                    f"(declared '# guarded-by: {lock}')")


# --------------------------------------------------------------------- #
# CFX-DONATE — donated tensors are dead after the donating call
# --------------------------------------------------------------------- #


class DonateRule(Rule):
    """A variable passed in a donated argument position must not be
    read again until reassigned: the callee factors that tensor in place,
    so a later read observes the factors, not the input. Covers (a) the
    port's factor entry points called with `donate` not the literal False
    (`lu_factor_distributed`, `lu_factor_steps`,
    `cholesky_factor_distributed`, `cholesky_factor_steps`,
    `qr_factor_distributed`, `qr_factor_steps`: the shard, argument 0, by
    keyword or at its position), (b) `fn = build_program(...,
    donate=True)` then `fn(shard, ...)` and the immediately-invoked form,
    and (c) the serve convention `plan._refresh_fn(kb, donate)(A0, ...)`,
    whose argument 0 is donated whenever the session owns the base.
    Conservative: only Name / `self.X` arguments are tracked, linearly by
    line within one function."""

    id = "CFX-DONATE"
    description = "donated tensor referenced after the donating call"

    # entry point -> position of its `donate` parameter
    DONATING = {
        "lu_factor_distributed": 6, "lu_factor_steps": 9,
        "cholesky_factor_distributed": 5, "cholesky_factor_steps": 7,
        "qr_factor_distributed": 6, "qr_factor_steps": 9,
    }

    def check(self, sf: SourceFile, out: list) -> None:
        if "donate" not in sf.text:  # no donating call can be in the file
            return
        for func, _cls in _func_defs(sf.tree):
            self._check_func(sf, out, func)

    @staticmethod
    def _donates(call: ast.Call, pos: int | None) -> bool:
        """`donate` given (by keyword, or at `pos`) and not literal False."""
        dn = next((kw.value for kw in call.keywords if kw.arg == "donate"), None)
        if dn is None and pos is not None and len(call.args) > pos:
            dn = call.args[pos]
        return dn is not None and not (isinstance(dn, ast.Constant) and not dn.value)

    def _program_donated(self, call: ast.Call) -> bool:
        return _call_name(call) == "build_program" and self._donates(call, None)

    @staticmethod
    def _key(node):
        if isinstance(node, ast.Name):
            return ("name", node.id)
        attr = _self_attr(node)
        if attr is not None:
            return ("self", attr)
        return None

    def _check_func(self, sf, out, func) -> None:
        programs: set = set()  # names bound to a donating build_program(...)
        events = []  # (end_line, key, desc)
        # a call's result assigned back to the donated name closes the
        # window at once (`s = lu_factor_steps(s, ..., donate=True)`)
        rebinds: dict = {}  # id(call) -> keys its statement assigns
        for node in ast.walk(func):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                keys = {self._key(t) for tgt in targets for t in ast.walk(tgt)}
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Call):
                        rebinds[id(sub)] = keys
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and self._program_donated(node.value) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                programs.add(node.targets[0].id)
            if not isinstance(node, ast.Call):
                continue
            donated = False
            inner = node.func
            name = _call_name(node)
            if name in self.DONATING:
                donated = self._donates(node, self.DONATING[name])
            elif isinstance(inner, ast.Name) and inner.id in programs:
                donated = True
            elif isinstance(inner, ast.Call):
                if self._program_donated(inner):
                    donated = True
                elif _call_name(inner) == "_refresh_fn":
                    donated = self._donates(inner, 1)
            if not donated or not node.args:
                continue
            key = self._key(node.args[0])
            if key is not None and key not in rebinds.get(id(node), ()):
                events.append((getattr(node, "end_lineno", node.lineno), key,
                               ast.unparse(node.args[0])))
        # linear order by line: a Store to the key closes the window,
        # a Load inside it is a use-after-donate
        for end, key, desc in events:
            store_line = None
            for node in ast.walk(func):
                if self._key(node) != key:
                    continue
                if isinstance(node.ctx, ast.Store) and node.lineno > end:
                    if store_line is None or node.lineno < store_line:
                        store_line = node.lineno
            for node in ast.walk(func):
                if self._key(node) != key or not isinstance(node.ctx, ast.Load):
                    continue
                if node.lineno <= end:
                    continue
                if store_line is not None and node.lineno >= store_line:
                    continue
                sf.emit(out, self.id, node.lineno,
                        f"'{desc}' was donated to a call on line {end} and read "
                        "again before reassignment: the callee factored it in place")


# --------------------------------------------------------------------- #
# CFX-HOSTSYNC — no host syncs on the dispatch hot path
# --------------------------------------------------------------------- #


class HostSyncRule(Rule):
    """Inside a `# hot-path` function, forbid the calls that wait for the
    card (the engine's dispatcher only launches; the drain thread waits):
    `.item()`, `.tolist()`, `.cpu()`, `.numpy()` and `.to("cpu")` (a
    device->host copy that waits when handed a device tensor),
    `.synchronize()` (`torch.cuda.synchronize()`, `Event.synchronize()`,
    `Stream.synchronize()`), `np.asarray`/`np.array` (a copy of a device
    tensor), and `float(...)`/`int(...)`/`bool(...)` of a call result (a
    scalar readback when the call is device-valued). Drain-side sites are
    allowlisted by NOT being marked; marked functions that legitimately
    touch host tensors carry an inline suppression naming why."""

    id = "CFX-HOSTSYNC"
    description = "host sync inside a # hot-path function"

    _NP_NAMES = {"np", "numpy"}
    _SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        """`.to("cpu")`, `.to(device="cpu")` or `.to(torch.device("cpu"))`."""
        vals = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
        for v in vals:
            if isinstance(v, ast.Call) and _call_name(v) == "device" and v.args:
                v = v.args[0]
            if isinstance(v, ast.Constant) and v.value == "cpu":
                return True
        return False

    def check(self, sf: SourceFile, out: list) -> None:
        for func, _cls in _func_defs(sf.tree):
            if not sf.is_hot_path(func):
                continue
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute):
                    if f.attr in self._SYNC_ATTRS:
                        sf.emit(out, self.id, node.lineno,
                                f".{f.attr}() waits for the card inside hot-path "
                                f"'{func.name}'")
                    elif f.attr == "to" and self._to_cpu(node):
                        sf.emit(out, self.id, node.lineno,
                                f".to('cpu') copies to the host (a wait when handed a "
                                f"device tensor) inside hot-path '{func.name}'")
                    elif f.attr in ("asarray", "array") and \
                            isinstance(f.value, ast.Name) and f.value.id in self._NP_NAMES:
                        sf.emit(out, self.id, node.lineno,
                                f"np.{f.attr}() forces a device->host copy when handed "
                                f"a device tensor, inside hot-path '{func.name}'")
                elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                        and node.args and isinstance(node.args[0], ast.Call):
                    sf.emit(out, self.id, node.lineno,
                            f"{f.id}(<call>) is a scalar readback (host sync) when the "
                            f"call is device-valued, inside hot-path '{func.name}'")


# --------------------------------------------------------------------- #
# CFX-FUTURE — exception edges must resolve owned futures
# --------------------------------------------------------------------- #


class FutureRule(Rule):
    """In a `# futures-owner` function (a worker body that owns request
    futures), an `except` edge must leave every owned future on a
    resolution path: the handler must resolve/fail/re-queue (a call to
    one of the RESOLVERS below), or re-raise so the worker wrapper's
    post-mortem (`_thread_died`) fails the pending set. Flagged:
    broad handlers (`Exception`/`BaseException`/bare) that do neither,
    and narrow handlers that silently swallow (`pass`-only body) — a
    narrow handler with real recovery logic is trusted. This is the
    static half of the engine's resolution-ownership (`_live`) discipline."""

    id = "CFX-FUTURE"
    description = "exception edge can strand an owned future"

    RESOLVERS = {
        "set_result", "set_exception", "_fail", "_settle",
        "_settle_factor", "_redispatch_survivors",
        "_redispatch_factor_survivors", "_drain_redispatch",
        "_drain_factor_redispatch", "_solo_drain", "_solo_factor_drain",
        "_escalate_settle", "_thread_died", "_run_chunk",
        "_run_factor_chunk", "_drain_unhealthy", "_drain_factor",
    }
    _BROAD = {"Exception", "BaseException"}

    def _handler_types(self, h: ast.ExceptHandler) -> list:
        t = h.type
        if t is None:
            return []
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        names = []
        for e in elts:
            if isinstance(e, ast.Name):
                names.append(e.id)
            elif isinstance(e, ast.Attribute):
                names.append(e.attr)
        return names

    def check(self, sf: SourceFile, out: list) -> None:
        for func, _cls in _func_defs(sf.tree):
            if not sf.is_futures_owner(func):
                continue
            for node in ast.walk(func):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                names = self._handler_types(node)
                broad = not names or any(n in self._BROAD
                                         for n in names)
                resolves = any(
                    isinstance(sub, ast.Call)
                    and _call_name(sub) in self.RESOLVERS
                    for sub in ast.walk(node))
                reraises = any(isinstance(sub, ast.Raise)
                               for sub in ast.walk(node))
                swallow = all(isinstance(s, ast.Pass)
                              for s in node.body)
                if resolves or reraises:
                    continue
                if broad:
                    sf.emit(out, self.id, node.lineno,
                            f"broad except in futures-owner "
                            f"'{func.name}' neither resolves owned "
                            "futures nor re-raises — pending requests "
                            "would hang forever")
                elif swallow:
                    sf.emit(out, self.id, node.lineno,
                            f"except {'/'.join(names) or '<bare>'} in "
                            f"futures-owner '{func.name}' swallows "
                            "silently (pass-only body) — if a future "
                            "was in flight it is stranded")


# --------------------------------------------------------------------- #
# CFX-RECOMPILE — programs built once, keyed at power-of-two buckets
# --------------------------------------------------------------------- #


class RecompileRule(Rule):
    """Three shapes of per-call rebuilding, invisible to the plan trace
    counters:
    (a) a bucket-program getter (`_solve_fn`, `_stacked_factor_fn`, ...)
    fed a key that is provably not a power-of-two bucket: the memo keys
    programs by exact value, so per-call-varying keys build (and on the
    card warm up and allocate for) one program per distinct value.
    Accepted keys: pow2 literals, `rank_bucket(...)` calls, names locally
    assigned from either, and `<staged buffer>.shape[i]` (stages pad to
    buckets). Unresolvable names (parameters, tuple unpacks) pass: the
    getters check the pow2 contract at run time;
    (b) a CUDA graph (`torch.cuda.CUDAGraph()`, `torch.cuda.graph(...)`)
    or a load of the kernel library (`_build.load()`) inside a for/while
    body: a capture (or a library lookup) per iteration;
    (c) a CUDA graph captured and replayed in the same function: built
    and called per call, where a graph pays only when captured once and
    replayed many times."""

    id = "CFX-RECOMPILE"
    description = "per-call rebuild hazard"

    BUCKET_GETTERS = {
        "_solve_fn", "_stacked_solve_fn", "_stacked_solve_health_fn",
        "_stacked_factor_fn", "_factor_health_fn", "_solve_health_fn",
        "_refine_fn", "_update_fn",
    }

    def check(self, sf: SourceFile, out: list) -> None:
        graphs = any(t in sf.text for t in ("CUDAGraph", ".graph(", "_build"))
        getters = "_fn(" in sf.text
        if not (graphs or getters):
            return  # no getter, capture or library load to check
        for func, _cls in _func_defs(sf.tree):
            self._check_func(sf, out, func, graphs, getters)

    @staticmethod
    def _is_graph(call: ast.Call) -> bool:
        """`CUDAGraph()` or `<cuda>.graph(...)`."""
        f = call.func
        if isinstance(f, ast.Name):
            return f.id == "CUDAGraph"
        return isinstance(f, ast.Attribute) and (
            f.attr == "CUDAGraph" or (f.attr == "graph" and isinstance(f.value, ast.Attribute)
                                      and f.value.attr == "cuda"))

    @staticmethod
    def _is_load(call: ast.Call) -> bool:
        f = call.func
        return (isinstance(f, ast.Attribute) and f.attr == "load"
                and isinstance(f.value, ast.Name) and f.value.id == "_build")

    @staticmethod
    def _is_shape_sub(node) -> bool:
        return (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "shape")

    def _bucket_ok(self, func, call_line, arg) -> bool | None:
        """True = provably bucketed, False = provably not, None =
        unresolvable (conservative pass)."""
        if isinstance(arg, ast.Constant):
            return _is_pow2(arg.value)
        if isinstance(arg, ast.Call):
            return True if _call_name(arg) == "rank_bucket" else None
        if self._is_shape_sub(arg):
            return True
        if isinstance(arg, ast.Name):
            last = None
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and node.lineno < call_line and \
                        any(isinstance(t, ast.Name) and t.id == arg.id
                            for t in node.targets):
                    if last is None or node.lineno > last.lineno:
                        last = node
            if last is None:
                return None  # parameter / out-of-scope: trust run time
            return self._bucket_ok(func, last.lineno, last.value)
        return None

    @staticmethod
    def _own_nodes(node):
        """`node`'s body (a def's or a statement's) outside nested defs and
        lambdas, which run later."""
        stack = list(node.body) if isinstance(node, (ast.FunctionDef,
                                                     ast.AsyncFunctionDef)) else [node]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.Lambda)):
                    stack.append(child)

    def _check_func(self, sf, out, func, graphs: bool, getters: bool) -> None:
        if graphs:
            self._check_graphs(sf, out, func)
        if not getters:
            return
        # (a) bucket getters fed un-bucketed keys
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in self.BUCKET_GETTERS and node.args:
                for arg in node.args:
                    if self._bucket_ok(func, node.lineno, arg) is False:
                        sf.emit(out, self.id, node.lineno,
                                f"{name}({ast.unparse(arg)}): bucket keys must be "
                                "power-of-two (route through update.rank_bucket), else "
                                "every distinct value builds its own program")

    def _check_graphs(self, sf, out, func) -> None:
        # (b) a capture or a library load under a loop
        def loops(body):
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # a nested def delays execution
                if isinstance(stmt, (ast.For, ast.While)):
                    for sub in self._own_nodes(stmt):
                        if isinstance(sub, ast.Call) and self._is_graph(sub):
                            sf.emit(out, self.id, sub.lineno,
                                    "CUDA graph captured inside a loop: a capture per "
                                    "iteration; capture once and replay")
                        elif isinstance(sub, ast.Call) and self._is_load(sub):
                            sf.emit(out, self.id, sub.lineno,
                                    "_build.load() inside a loop: load the kernel "
                                    "library once, outside it")
                    continue
                for _f, v in ast.iter_fields(stmt):
                    if isinstance(v, list) and v and isinstance(v[0], ast.stmt):
                        loops(v)
                    elif isinstance(v, list):
                        for h in v:
                            if isinstance(h, ast.excepthandler):
                                loops(h.body)

        loops(func.body)
        own = list(self._own_nodes(func))
        # (c) captured and replayed per call
        captures = [n for n in own if isinstance(n, ast.Call) and self._is_graph(n)]
        replays = any(isinstance(n, ast.Call) and _call_name(n) == "replay" for n in own)
        if captures and replays:
            sf.emit(out, self.id, min(n.lineno for n in captures),
                    f"CUDA graph captured and replayed in '{func.name}': a capture per "
                    "call; capture once, memoize the graph and replay it")


# --------------------------------------------------------------------- #
# CFX-EXCEPT — InjectedKill must reach the watchdog
# --------------------------------------------------------------------- #


class ExceptRule(Rule):
    """`InjectedKill` is a BaseException on purpose: it must
    sail through per-item `except Exception` handling and out of the
    worker loop so the watchdog path runs. A bare `except:` or
    `except BaseException` swallows it — allowed only when the handler
    re-raises or IS the sanctioned post-mortem (calls `_thread_died`).
    Explicitly catching `InjectedKill` without re-raising is flagged
    for the same reason."""

    id = "CFX-EXCEPT"
    description = "BaseException/bare except defeats the watchdog"

    def check(self, sf: SourceFile, out: list) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            elts = (t.elts if isinstance(t, ast.Tuple)
                    else [] if t is None else [t])
            names = [(e.id if isinstance(e, ast.Name) else
                      e.attr if isinstance(e, ast.Attribute) else "")
                     for e in elts]
            bare = t is None
            base = "BaseException" in names
            kill = "InjectedKill" in names
            if not (bare or base or kill):
                continue
            reraises = any(isinstance(sub, ast.Raise)
                           for sub in ast.walk(node))
            postmortem = any(
                isinstance(sub, ast.Call)
                and _call_name(sub) == "_thread_died"
                for sub in ast.walk(node))
            if reraises or postmortem:
                continue
            what = ("bare except:" if bare
                    else "except BaseException" if base
                    else "except InjectedKill")
            sf.emit(out, self.id, node.lineno,
                    f"{what} swallows InjectedKill (a BaseException) — "
                    "the watchdog never learns the worker died; "
                    "re-raise or route through _thread_died")


ALL_RULES = (LockRule(), DonateRule(), HostSyncRule(), FutureRule(),
             RecompileRule(), ExceptRule())
