"""conflint in torch form (`conflux_tpu_torch.analysis`), the twin of
tests/test_analysis.py: fixture coverage for every rule (a hit, a
non-hit, a suppression honored), in the port's torch idiom where the rule
is torch's (donation, waits for the card, graph captures); the port's
tree scanned clean; the report's JSON shape; and the runtime lock-order
harness (`analysis.lockcheck`) on the CPU, with the port's serve engine
under it, and the regression hammers of the port's guarded state."""

import json
import os
import textwrap
import threading

import numpy as np
import pytest
import torch

from conflux_tpu_torch import analysis, profiler, serve
from conflux_tpu_torch.analysis import lockcheck
from conflux_tpu_torch.engine import ServeEngine
from conflux_tpu_torch.resilience import HealthPolicy


def hits(src: str, rule: str, suppressed: bool = False):
    return [f for f in analysis.scan_source(textwrap.dedent(src))
            if f.rule == rule and f.suppressed == suppressed]


# --------------------------------------------------------------------- #
# CFX-LOCK
# --------------------------------------------------------------------- #


LOCK_FIXTURE = """
    import threading

    class Eng:
        def __init__(self):
            self._lock = threading.Lock()
            self._pending = 0  # guarded-by: _lock

        def bad(self):
            return self._pending

        def good(self):
            with self._lock:
                return self._pending

        # requires-lock: _lock
        def helper_called_under_lock(self):
            self._pending += 1
"""


def test_lock_rule_positive_negative():
    # the bad access is the only hit: good() and the requires-lock
    # helper are clean, __init__ is exempt
    found = hits(LOCK_FIXTURE, "CFX-LOCK")
    assert len(found) == 1
    assert "self._pending" in found[0].message


def test_lock_rule_module_globals():
    src = """
        import threading
        _L = threading.Lock()
        _TABLE = {}  # guarded-by: _L

        def bad():
            _TABLE["x"] = 1

        def good():
            with _L:
                _TABLE["x"] = 1
    """
    found = hits(src, "CFX-LOCK")
    assert len(found) == 1
    assert "_TABLE" in found[0].message


def test_lock_rule_suppression_counted():
    src = """
        import threading

        class Eng:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded-by: _lock

            def racy(self):
                # conflint: disable=CFX-LOCK fixture reason
                return self._n
    """
    assert hits(src, "CFX-LOCK") == []
    sup = hits(src, "CFX-LOCK", suppressed=True)
    assert len(sup) == 1 and sup[0].reason == "fixture reason"


def test_lock_rule_closure_is_conservative():
    # a closure may run on another thread: the enclosing with does not
    # bless its accesses
    src = """
        import threading

        class Eng:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded-by: _lock

            def spawn(self):
                with self._lock:
                    def worker():
                        return self._n
                    return worker
    """
    assert len(hits(src, "CFX-LOCK")) == 1


# --------------------------------------------------------------------- #
# CFX-DONATE
# --------------------------------------------------------------------- #


def test_donate_rule_use_after_donate():
    src = """
        def f(shard, geom, mesh):
            out, perm = lu_factor_distributed(shard, geom, mesh, donate=True)
            return shard.sum() + out
    """
    found = hits(src, "CFX-DONATE")
    assert len(found) == 1 and "'shard'" in found[0].message


def test_donate_rule_positional_and_program_forms():
    src = """
        def f(shard, geom, mesh, s2, s3):
            out = cholesky_factor_distributed(shard, geom, mesh, None, "kernel", True)
            fn = build_program(geom, mesh, donate=True)
            res = fn(s2, mesh)
            res2 = build_program(geom, mesh, donate=True)(s3, mesh)
            return shard, s2, s3, out, res, res2
    """
    found = hits(src, "CFX-DONATE")
    assert sorted(f.message.split("'")[1] for f in found) == ["s2", "s3", "shard"]


def test_donate_rule_not_donated_and_reassignment_clear():
    src = """
        def f(shard, geom, mesh, s1):
            out = qr_factor_distributed(shard, geom, mesh, donate=False)
            keep = lu_factor_distributed(shard, geom, mesh)
            s1, o1, perm = lu_factor_steps(s1, geom, mesh, 0, 2, donate=True)
            return shard, out, keep, s1
    """
    assert hits(src, "CFX-DONATE") == []


def test_donate_rule_refresh_convention():
    # the serve convention: _refresh_fn(kb, donate)(A0, ...) donates arg 0
    src = """
        def refactor(self, plan, kb, Up, Vp):
            A_new = plan._refresh_fn(kb, donate=True)(self._A0, Up, Vp)
            leak = self._A0 + 1
            self._A0 = A_new
            return leak
    """
    found = hits(src, "CFX-DONATE")
    assert len(found) == 1 and "self._A0" in found[0].message
    clean = """
        def refactor(self, plan, kb, Up, Vp):
            A_new = plan._refresh_fn(kb, donate=True)(self._A0, Up, Vp)
            self._A0 = A_new
            return self._A0
    """
    assert hits(clean, "CFX-DONATE") == []


def test_donate_rule_suppression():
    src = """
        def f(shard, geom, mesh):
            out = qr_factor_distributed(shard, geom, mesh, donate=True)
            # conflint: disable=CFX-DONATE fixture knows better
            return shard.sum() + out
    """
    assert hits(src, "CFX-DONATE") == []
    assert len(hits(src, "CFX-DONATE", suppressed=True)) == 1


# --------------------------------------------------------------------- #
# CFX-HOSTSYNC
# --------------------------------------------------------------------- #


def test_hostsync_rule_positive():
    src = """
        import numpy as np
        import torch

        # hot-path
        def stage(x, v, ev, stream):
            a = np.asarray(x)
            s = float(v.sum())
            ok = bool(v.isfinite().all())
            torch.cuda.synchronize()
            ev.synchronize()
            stream.synchronize()
            h = x.cpu()
            c = x.to("cpu")
            d = x.to(device="cpu")
            return a, s, ok, h, c, d, x.item(), x.tolist(), x.numpy()
    """
    found = hits(src, "CFX-HOSTSYNC")
    kinds = " ".join(f.message for f in found)
    assert len(found) == 12
    for k in ("np.asarray", "float(<call>)", "bool(<call>)", ".synchronize()", ".cpu()",
              ".to('cpu')", ".item()", ".tolist()", ".numpy()"):
        assert k in kinds, k


def test_hostsync_rule_device_work_and_unmarked_function_are_free():
    src = """
        import numpy as np

        # hot-path
        def dispatch(x, stream):
            y = x.to("cuda", non_blocking=True)
            z = y.to(torch.float32)
            stream.wait_stream(stream)
            return y @ z

        def drain(x):
            return np.asarray(x.cpu()), x.item()
    """
    assert hits(src, "CFX-HOSTSYNC") == []


def test_hostsync_rule_suppression():
    src = """
        # hot-path
        def stage(x):
            # conflint: disable=CFX-HOSTSYNC a host tensor, no device wait
            return x.numpy()
    """
    assert hits(src, "CFX-HOSTSYNC") == []
    assert len(hits(src, "CFX-HOSTSYNC", suppressed=True)) == 1


# --------------------------------------------------------------------- #
# CFX-FUTURE
# --------------------------------------------------------------------- #


def test_future_rule_broad_swallow():
    src = """
        # futures-owner
        def worker(self, reqs):
            try:
                dispatch(reqs)
            except Exception:
                pass
    """
    assert len(hits(src, "CFX-FUTURE")) == 1


def test_future_rule_resolver_and_reraise_pass():
    src = """
        # futures-owner
        def worker(self, reqs):
            try:
                dispatch(reqs)
            except Exception as e:
                self._fail(reqs, e)
            try:
                drain(reqs)
            except Exception:
                raise
    """
    assert hits(src, "CFX-FUTURE") == []


def test_future_rule_narrow_handlers():
    src = """
        # futures-owner
        def worker(self, reqs):
            try:
                dispatch(reqs)
            except KeyError:
                pass
            try:
                stage(reqs)
            except KeyError:
                reqs = recover(reqs)
    """
    found = hits(src, "CFX-FUTURE")
    # pass-only narrow handler flagged; narrow handler with real
    # recovery logic trusted
    assert len(found) == 1 and "KeyError" in found[0].message


def test_future_rule_unmarked_function_is_free():
    src = """
        def not_a_worker(reqs):
            try:
                dispatch(reqs)
            except Exception:
                pass
    """
    assert hits(src, "CFX-FUTURE") == []


def test_future_rule_suppression():
    src = """
        # futures-owner
        def worker(self, reqs):
            try:
                dispatch(reqs)
            # conflint: disable=CFX-FUTURE nothing owned here
            except Exception:
                pass
    """
    assert hits(src, "CFX-FUTURE") == []
    assert len(hits(src, "CFX-FUTURE", suppressed=True)) == 1


# --------------------------------------------------------------------- #
# CFX-RECOMPILE
# --------------------------------------------------------------------- #


def test_recompile_rule_graph_and_load_in_a_loop():
    src = """
        import torch
        from conflux_tpu_torch.ops import _build

        def f(xs, fn):
            for x in xs:
                g = torch.cuda.CUDAGraph()
                lib = _build.load()
            while xs:
                with torch.cuda.graph(xs.pop()):
                    fn()
    """
    found = hits(src, "CFX-RECOMPILE")
    msgs = " ".join(f.message for f in found)
    assert len(found) == 3
    assert "captured inside a loop" in msgs and "_build.load() inside a loop" in msgs


def test_recompile_rule_graph_built_and_replayed_per_call():
    src = """
        import torch

        def per_call(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            g.replay()

        def capture_once(self, fn):
            self._g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._g):
                fn()
            return self._g

        def replay(self):
            self._g.replay()
    """
    found = hits(src, "CFX-RECOMPILE")
    assert len(found) == 1 and "'per_call'" in found[0].message


def test_recompile_rule_bucket_literals():
    src = """
        def f(plan, b):
            plan._solve_fn(3)(b)
            w = 5
            plan._solve_fn(w)(b)
            plan._stacked_solve_health_fn(6, 1)(b)
    """
    assert len(hits(src, "CFX-RECOMPILE")) == 3


def test_recompile_rule_bucketed_keys_pass():
    src = """
        from conflux_tpu_torch.update import rank_bucket

        def f(plan, b, nrhs, wb):
            plan._solve_fn(rank_bucket(nrhs))(b)
            nb = rank_bucket(nrhs)
            plan._solve_fn(nb)(b)
            plan._solve_fn(4)(b)
            plan._solve_fn(wb)(b)  # parameter: checked at run time
            plan._factor_health_fn(b.shape[0])(b)
            plan._update_solve_fn(4, 1, 3)(b)  # not a bucket getter's key set
    """
    assert hits(src, "CFX-RECOMPILE") == []


def test_recompile_rule_suppression():
    src = """
        def f(plan, b):
            # conflint: disable=CFX-RECOMPILE asserting the contract
            plan._solve_fn(3)(b)
    """
    assert hits(src, "CFX-RECOMPILE") == []
    assert len(hits(src, "CFX-RECOMPILE", suppressed=True)) == 1


# --------------------------------------------------------------------- #
# CFX-EXCEPT
# --------------------------------------------------------------------- #


def test_except_rule_bare_and_base():
    src = """
        def worker():
            try:
                run()
            except:
                pass

        def worker2():
            try:
                run()
            except (ValueError, BaseException):
                pass
    """
    assert len(hits(src, "CFX-EXCEPT")) == 2


def test_except_rule_sanctioned_forms_pass():
    src = """
        def loop(self):
            try:
                run()
            except BaseException as e:
                self._thread_died("drain", e)

        def passthrough():
            try:
                run()
            except BaseException:
                raise

        def normal():
            try:
                run()
            except Exception:
                pass
    """
    assert hits(src, "CFX-EXCEPT") == []


def test_except_rule_injected_kill():
    src = """
        def worker():
            try:
                run()
            except InjectedKill:
                pass
    """
    found = hits(src, "CFX-EXCEPT")
    assert len(found) == 1 and "InjectedKill" in found[0].message


def test_except_rule_suppression():
    src = """
        def worker():
            try:
                run()
            # conflint: disable=CFX-EXCEPT fixture
            except BaseException:
                pass
    """
    assert hits(src, "CFX-EXCEPT") == []
    assert len(hits(src, "CFX-EXCEPT", suppressed=True)) == 1


# --------------------------------------------------------------------- #
# the self-run: the port's tree is conflint-clean
# --------------------------------------------------------------------- #


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_report():
    return analysis.run_paths(analysis.default_paths())


def test_port_tree_is_conflint_clean(port_report):
    assert port_report.errors == [], port_report.errors
    assert port_report.findings == [], "\n".join(str(f) for f in port_report.findings)


def test_port_report_shape(port_report, tmp_path):
    s = port_report.summary()
    assert s["rules_run"] == len(analysis.RULE_IDS) == 6
    assert s["files_scanned"] > 100
    assert s["findings"] == 0
    # the annotated tree carries real, reasoned suppressions: counted,
    # not hidden
    assert s["suppressions"] >= 5
    assert set(s["by_rule"]) >= set(analysis.RULE_IDS)
    for f in port_report.suppressions:
        assert f.reason, f"suppression without a reason: {f}"
    out = tmp_path / "report.json"
    port_report.to_json(str(out))
    data = json.loads(out.read_text())
    assert data["tool"] == "conflint" and data["summary"] == s
    assert {"rule", "path", "line", "message", "reason"} <= set(data["suppressions"][0])


def test_default_paths_are_the_port_and_the_cli_exits_on_a_finding(tmp_path, capsys):
    from conflux_tpu_torch.analysis.__main__ import main

    paths = [os.path.relpath(p, REPO) for p in analysis.default_paths()]
    assert paths[0] == "conflux_tpu_torch" and "chip_smoke.py" in paths
    assert all(p.startswith(("conflux_tpu_torch", "chip_smoke", "scripts/torch_",
                             "examples/torch_", "tests/test_torch_")) for p in paths)
    assert {"tests/test_torch_analysis.py", "examples/torch_tour.py",
            "scripts/torch_replay.py", "scripts/torch_accuracy_demo.py"} <= set(paths)
    bad = tmp_path / "bad.py"
    bad.write_text("def worker():\n    try:\n        run()\n    except BaseException:\n"
                   "        pass\n")
    assert main([str(bad), "--json", str(tmp_path / "r.json")]) == 1
    assert "CFX-EXCEPT" in capsys.readouterr().out
    assert json.loads((tmp_path / "r.json").read_text())["summary"]["findings"] == 1


def test_annotations_present_in_the_port_serve_stack():
    """The contract surface is annotated (a refactor that drops the
    comments would silently disable the rules)."""
    def read(name):
        with open(os.path.join(REPO, "conflux_tpu_torch", name)) as f:
            return f.read()

    eng, srv, prof = read("engine.py"), read("serve.py"), read("profiler.py")
    assert eng.count("guarded-by: _lock") >= 15
    assert eng.count("# hot-path") >= 10
    assert eng.count("# futures-owner") + eng.count(", futures-owner") >= 10
    assert srv.count("guarded-by: _lock") >= 8
    assert prof.count("guarded-by: _PROF_LOCK") >= 2
    assert read("resilience.py").count("guarded-by:") >= 3


# --------------------------------------------------------------------- #
# lockcheck: the runtime lock-order / dispatch harness
# --------------------------------------------------------------------- #


def test_lockcheck_detects_order_cycle():
    with lockcheck.watch() as lc:
        a = threading.Lock()
        b = threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        t = threading.Thread(target=ab)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with b:
            with a:
                pass
    assert any("cycle" in v for v in lc.violations), lc.report()


def test_lockcheck_consistent_order_is_green():
    with lockcheck.watch() as lc:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
    assert lc.violations == []
    assert lc.report()["order_edges"] >= 1


def test_lockcheck_dead_locks_leave_no_edges_to_new_ones():
    """Locks are keyed by a creation serial, not id(): a dead lock's
    address reused by a new lock must not hand it the dead one's edges
    (thousands of short-lived engine and plan locks in a long soak read
    as hundreds of cycles under id keys)."""
    with lockcheck.watch() as lc:
        for _ in range(200):
            a, b = threading.Lock(), threading.Lock()
            with a:
                with b:
                    pass
            del a, b
            c, d = threading.Lock(), threading.Lock()
            with c:
                with d:
                    pass
            del c, d
    rep = lc.report()
    assert rep["locks"] == 800 and rep["order_edges"] == 400
    assert lc.violations == []


def test_lockcheck_flags_an_engine_file_lock_held_across_dispatch():
    """A lock created from a no-dispatch file (here this one, standing in
    for engine.py) held when a `serve.*` region is entered: a violation,
    seen through the port's `profiler._dispatch_hook`."""
    with lockcheck.watch(forbid_dispatch_files=("test_torch_analysis.py",)) as lc:
        lk = threading.Lock()
        with profiler.region("serve.solve"):
            pass  # not held: clean
        assert lc.violations == []
        with lk:
            with profiler.region("engine.prewarm"):
                pass  # not a dispatch region
            with profiler.region("serve.solve"):
                pass
    assert len(lc.violations) == 1 and "held across dispatch" in lc.violations[0]
    assert profiler._dispatch_hook is None


def test_lockcheck_wraps_the_port_not_torch():
    import queue

    assert lockcheck._should_wrap(os.path.join(REPO, "conflux_tpu_torch", "engine.py"))
    assert lockcheck._should_wrap(queue.__file__)
    assert lockcheck._should_wrap(__file__)
    torch_dir = os.path.dirname(torch.__file__)
    assert not lockcheck._should_wrap(os.path.join(torch_dir, "cuda", "__init__.py"))
    assert not lockcheck._should_wrap(os.path.join(torch_dir, "multiprocessing", "queue.py"))
    assert not lockcheck._should_wrap(os.path.join(REPO, "conflux_tpu", "engine.py"))


def test_lockcheck_condition_protocol():
    # a Condition built on a wrapped RLock must wait/notify correctly
    with lockcheck.watch():
        cond = threading.Condition(threading.RLock())
        box = []

        def producer():
            with cond:
                box.append(1)
                cond.notify()

        t = threading.Thread(target=producer)
        with cond:
            t.start()
            assert cond.wait_for(lambda: box, timeout=10)
        t.join(timeout=60)
        assert not t.is_alive()


def test_lockcheck_engine_workload_green():
    """The port's serve engine under real traffic holds no engine lock
    across a dispatch and keeps one global lock order."""
    serve.clear_plans()
    with lockcheck.watch() as lc:
        plan = serve.FactorPlan.create((16, 16), torch.float32, v=8)
        rng = np.random.default_rng(0)
        A = (rng.standard_normal((16, 16)) / 4 + 2.0 * np.eye(16)).astype(np.float32)
        eng = ServeEngine(max_batch_delay=0.0, health=HealthPolicy(),
                          watchdog_interval=0.05, device="cpu")
        try:
            sess = eng.factor(plan, A, timeout=60)
            futs = [eng.submit(sess, rng.standard_normal((16, 2)).astype(np.float32))
                    for _ in range(6)]
            for f in futs:
                f.result(60)
        finally:
            eng.close(timeout=60)
    rep = lc.report()
    assert lc.violations == [], rep
    assert rep["acquisitions"] > 0 and rep["locks"] > 0


@pytest.mark.parametrize("mode,trials", [("serve", 3), ("tier", 1)])
def test_soak_under_lockcheck_on_the_cpu(mode, trials):
    """`scripts/torch_soak.py --serve|--tier --lockcheck` on the CPU: every
    trial passes (a wrong answer fails its trial) and the watch reports no
    lock-order cycle and no engine lock held across a dispatch."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_soak_under_test", os.path.join(REPO, "scripts", "torch_soak.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    soak.ENGINE["device"] = "cpu"
    lines = []
    out = soak.soak(mode, trials=trials, seed=0, lockcheck=True, emit=lines.append)
    assert out["trials"] == trials and out["fails"] == 0, lines
    assert out["lockcheck"]["violations"] == [] and out["lockcheck"]["acquisitions"] > 0
    assert lines[-1].startswith("lockcheck:")


# --------------------------------------------------------------------- #
# regression hammers of the port's guarded state
# --------------------------------------------------------------------- #


def test_profiler_region_counters_thread_safe():
    """`_times[name] += dt` is a read-modify-write from every worker
    thread: exact counts must survive a thread hammer."""
    profiler.clear()
    n_threads, n_iter = 8, 200

    def worker():
        for _ in range(n_iter):
            with profiler.region("test.hammer"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert profiler.timings()["test.hammer"][0] == n_threads * n_iter
    profiler.clear()


def test_engine_registry_prune_thread_safe():
    """Concurrent engine_stats() calls must not both prune the same dead
    weakref from _ENGINE_REFS (ValueError from list.remove)."""

    class Dummy:
        def stats(self):
            return {"requests": 1, "completed": 1, "shed": 0, "batches": 1,
                    "queue_peak": 1, "coalesced_requests": 1, "factor_requests": 0,
                    "factor_batches": 0, "factor_coalesced_requests": 0,
                    "factor_slots": 0, "factor_pad_slots": 0, "gang_batches": 0,
                    "gang_opportunity": 0, "gang_coalesced_requests": 0,
                    "gang": {"sessions": 0}, "stack_exclusions": {}, "lanes": []}

        def latency_samples(self):
            return [0.001]

        def factor_latency_samples(self):
            return []

    errors = []

    def churn():
        try:
            for _ in range(100):
                profiler.register_engine(Dummy())  # dies immediately
                profiler.engine_stats()
        except Exception as e:  # noqa: BLE001 — the race under test
            errors.append(e)

    threads = [threading.Thread(target=churn) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_session_state_swap_atomic_against_solve():
    """A direct solve racing refactor() must never dispatch on swapped-out
    state: every answer matches the oracle and the guarded counters are
    exact."""
    serve.clear_plans()
    plan = serve.FactorPlan.create((16, 16), torch.float32, v=8)
    rng = np.random.default_rng(1)
    A = (rng.standard_normal((16, 16)) / 4 + 2.0 * np.eye(16)).astype(np.float32)
    session = plan.factor(A, device="cpu")
    b = rng.standard_normal((16, 2)).astype(np.float32)
    want = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    n_iter, errors = 30, []

    def solver():
        try:
            for _ in range(n_iter):
                x = np.asarray(session.solve(torch.from_numpy(b)))
                err = np.linalg.norm(x - want) / np.linalg.norm(want)
                assert err < 1e-4, err
        except Exception as e:  # noqa: BLE001 — the race under test
            errors.append(e)

    def refactorer():
        try:
            for _ in range(n_iter):
                session.refactor()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=solver), threading.Thread(target=refactorer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert session.solves == n_iter
    assert session.refactors == n_iter
