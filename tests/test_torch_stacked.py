"""The serve layer's gang and lifecycle surface in the port, on the CPU:
the four stacked programs against the JAX package's on the same stacked
factors and right-hand sides; the stack trees' bitwise round trips; the
plan codec against the JAX `plan_spec`; the bucket lifecycle; device moves;
and the kernel launch counter under concurrent launchers."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import batched as jbatched
from conflux_tpu import serve as jserve
from conflux_tpu.ops import blas as jblas
from conflux_tpu.resilience import evaluate_slots as jevaluate_slots
from conflux_tpu_torch import batched as tbatched
from conflux_tpu_torch import serve
from conflux_tpu_torch.engine import ServeEngine
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels
from conflux_tpu_torch.resilience import HealthPolicy, evaluate_slots

N, V, S, K = 32, 16, 4, 3
# f32 parity bar of the stacked programs: the port and the JAX package sum
# the blocked substitution's products in different orders
RTOL = 1e-5


def _gen(rng, b, n=N, spd=False):
    M = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    if spd:
        M = M @ np.swapaxes(M, -1, -2) + np.eye(n)
    return M.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fleet(kind="lu", refine=0, seed=0):
    """S JAX sessions of one (N, N) plan and the port's sessions on the
    same factors (`session_from_numpy`), with their matrices."""
    serve.clear_plans()
    jserve.clear_plans()
    jp = jserve.FactorPlan.create((N, N), jnp.float32, v=V, kind=kind, refine=refine)
    tp = serve.FactorPlan.create((N, N), torch.float32, v=V, kind=kind, refine=refine)
    A = _gen(np.random.default_rng(seed), S, spd=kind == "chol")
    js = [jp.factor(jnp.asarray(a)) for a in A]
    ts = [serve.session_from_numpy(tp, [np.asarray(f) for f in s.factors], a, device="cpu")
          for s, a in zip(js, A)]
    return jp, tp, js, ts, A


def _stacks(js, A):
    """The stacked factors, bases and probe rows, JAX and port, from the
    same numpy values."""
    Fj = jbatched.stack_trees([s.factors for s in js])
    Ft = tuple(_t(f) for f in Fj)
    Ft = Ft[:-1] + (Ft[-1].long(),) if len(Ft) == 4 else Ft
    wA = np.stack([np.asarray(s._probe_row()) for s in js])
    return Fj, Ft, jnp.asarray(A), _t(A), wA


def _rhs(seed, w=2):
    return np.random.default_rng(seed).standard_normal((S, N, w)).astype(np.float32)


@pytest.mark.parametrize("kind,refine", [("lu", 0), ("lu", 1), ("chol", 0)])
def test_stacked_solve_and_checked_match_jax(kind, refine):
    jp, tp, js, ts, A = _fleet(kind, refine, seed=1)
    Fj, Ft, Aj, At, wA = _stacks(js, A)
    b = _rhs(2)
    A0j, A0t = (Aj, At) if refine else (None, None)
    xj = np.asarray(jp._stacked_solve_fn(S, 2)(Fj, A0j, jnp.asarray(b)))
    xt = tp._stacked_solve_fn(S, 2)(Ft, A0t, _t(b)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=RTOL, atol=RTOL * np.abs(xj).max())
    # the checked form, with slot 2's factors poisoned: the verdicts agree
    # slot by slot (finite flags exactly, residuals to f32 scale)
    Fj2 = tuple(f.at[2].set(jnp.nan) if jnp.issubdtype(f.dtype, jnp.floating) else f
                for f in Fj)
    Ft2 = tuple(_t(f) for f in Fj2)
    Ft2 = Ft2[:-1] + (Ft2[-1].long(),) if len(Ft2) == 4 else Ft2
    xj2, vj = jp._stacked_solve_health_fn(S, 2)(Fj2, A0j, jnp.asarray(wA), jnp.asarray(b))
    xt2, vt = tp._stacked_solve_health_fn(S, 2)(Ft2, A0t, _t(wA), _t(b))
    vj, vt = np.asarray(vj), vt.numpy()
    assert vt.shape == vj.shape == (2, S)
    np.testing.assert_array_equal(vt[0], vj[0])
    assert vt[0].tolist() == [1.0, 1.0, 0.0, 1.0]
    ok = [0, 1, 3]
    np.testing.assert_allclose(vt[1, ok], vj[1, ok], atol=1e-5)
    limit = HealthPolicy().resolved_residual_limit(np.float32, N)
    assert ([h for h, _f, _r in evaluate_slots(vt, limit)]
            == [h for h, _f, _r in jevaluate_slots(vj, limit)] == [True, True, False, True])
    np.testing.assert_allclose(xt2[ok], np.asarray(xj2)[ok], rtol=RTOL,
                               atol=RTOL * np.abs(xj).max())
    # a blocked plan without sweeps takes each slot's stats from the
    # substitution itself (the fused form); one callable serves every bucket
    calls = []
    body = tp._blocked_probe_body
    tp._blocked_probe_body = lambda *a: calls.append(1) or body(*a)
    try:
        tp._stacked_solve_health_fn(S, 2)(Ft, A0t, _t(wA), _t(b))
    finally:
        del tp._blocked_probe_body
    assert bool(calls) == tp._fused_probe
    assert tp._stacked_solve_health_fn(S, 2) == tp._stacked_solve_health_fn(2 * S, 1)


@pytest.mark.parametrize("refine", [0, 1])
def test_stacked_update_programs_match_jax(refine):
    """The stacked Woodbury programs on a stack of two drifted slots (rank
    3, the gang's rank bucket 4) and two clean ones (zero U, V and the
    identity Cinv), checked and unchecked."""
    from conflux_tpu.update import pad_update_state, zero_update_state

    jp, tp, js, ts, A = _fleet("lu", 0, seed=3)
    rng = np.random.default_rng(4)
    kb = 4
    ups = []
    for i, s in enumerate(js):
        if i in (0, 2):
            U = (0.01 * rng.standard_normal((N, K))).astype(np.float32)
            s.update(jnp.asarray(U), jnp.asarray(U))
            u = s._upd
            ups.append(pad_update_state(u["Up"], u["Vp"], u["Y"], u["Cinv"], kb))
        else:
            ups.append(zero_update_state(N, kb, "float32"))
    Up, Vp, Y, Ci = (np.stack([np.asarray(u[j]) for u in ups]) for j in range(4))
    Fj, Ft, Aj, At, wA = _stacks(js, A)
    b = _rhs(5)
    A0j, A0t = (Aj, At) if refine else (None, None)
    jargs = (Fj, A0j, *(jnp.asarray(x) for x in (Up, Vp, Y, Ci)))
    targs = (Ft, A0t, *(_t(x) for x in (Up, Vp, Y, Ci)))
    xj = np.asarray(jp._stacked_update_solve_fn(S, kb, 2, refine)(*jargs, jnp.asarray(b)))
    xt = tp._stacked_update_solve_fn(S, kb, 2, refine)(*targs, _t(b)).numpy()
    scale = np.abs(xj).max()
    np.testing.assert_allclose(xt, xj, rtol=RTOL, atol=RTOL * scale)
    xj2, vj = jp._stacked_update_solve_health_fn(S, kb, 2, refine)(
        *jargs, jnp.asarray(wA), jnp.asarray(b))
    xt2, vt = tp._stacked_update_solve_health_fn(S, kb, 2, refine)(*targs, _t(wA), _t(b))
    np.testing.assert_allclose(xt2.numpy(), np.asarray(xj2), rtol=RTOL, atol=RTOL * scale)
    vj, vt = np.asarray(vj), vt.numpy()
    np.testing.assert_array_equal(vt[0], vj[0])
    np.testing.assert_allclose(vt[1], vj[1], atol=1e-5)
    # each drifted slot solves its drifted system
    for i in (0, 2):
        A1 = A[i] + Up[i] @ Vp[i].T
        assert np.abs(A1 @ xt[i] - b[i]).max() < 1e-4


def test_stacked_programs_refuse_batched_plans_and_ragged_buckets():
    serve.clear_plans()
    bplan = serve.FactorPlan.create((4, N, N), torch.float32, v=V)
    for call in (lambda: bplan._stacked_solve_fn(2, 1),
                 lambda: bplan._stacked_solve_health_fn(2, 1),
                 lambda: bplan._stacked_update_solve_fn(2, 2, 1, 0),
                 lambda: bplan._stacked_update_solve_health_fn(2, 2, 1, 0)):
        with pytest.raises(AssertionError, match="single-system"):
            call()
    plan = serve.FactorPlan.create((N, N), torch.float32, v=V)
    with pytest.raises(AssertionError, match="power-of-two"):
        # conflint: disable=CFX-RECOMPILE asserting the bucket contract rejects 3
        plan._stacked_solve_fn(3, 1)


def test_stacked_slot_is_bitwise_invariant_to_bucket_and_pad():
    """Slots never interact: a slot's answer at bucket 4 equals the one at
    bucket 2 with another session in the pad slot, bit for bit."""
    _jp, tp, _js, ts, _A = _fleet("lu", 0, seed=6)
    b = _rhs(7, w=1)
    F4 = tbatched.stack_trees([s.factors for s in ts])
    x4 = tp._stacked_solve_fn(4, 1)(F4, None, _t(b))
    F2 = tbatched.stack_trees([ts[1].factors, ts[3].factors])
    b2 = _t(np.stack([b[1], b[0]]))
    x2 = tp._stacked_solve_fn(2, 1)(F2, None, b2)
    assert torch.equal(x4[1], x2[0])


# --------------------------------------------------------------------------- #
# stack trees
# --------------------------------------------------------------------------- #


def test_write_slot_and_grow_stack_round_trips_bitwise():
    rng = np.random.default_rng(8)
    trees = [(_t(rng.standard_normal((N, N)).astype(np.float32)),
              _t(rng.integers(0, N, N)))
             for _ in range(3)]
    stack = tbatched.stack_trees(trees[:2])
    kept = tbatched.write_slot_tree(stack, trees[2], 1, donate=False)
    assert torch.equal(stack[0][1], trees[1][0])  # donate=False: a copy
    out = tbatched.write_slot_tree(stack, trees[2], 1)
    assert out[0] is stack[0]  # in place: the gang's write-back
    back = tbatched.unstack_tree(out, 2)
    for a, b in zip(back[0], trees[0]):
        assert torch.equal(a, b)
    for a, b, c in zip(back[1], trees[2], tbatched.unstack_tree(kept, 2)[1]):
        assert torch.equal(a, b) and torch.equal(a, c)
    grown = tbatched.grow_stack_tree(out, 4)
    gb = tbatched.unstack_tree(grown, 4)
    for a, b in zip(gb[1], trees[2]):
        assert torch.equal(a, b)
    for a, b in zip(gb[3], back[0]):  # pad slots repeat slot 0
        assert torch.equal(a, b)
    z = tbatched.grow_stack_tree(out[0], 4, fill="zero")
    assert float(z[2:].abs().sum()) == 0.0 and torch.equal(z[:2], out[0])
    assert tbatched.grow_stack_tree(out, 2) == out


def test_put_tree_and_stack_host_trees_keep_bits_and_aliases():
    rng = np.random.default_rng(9)
    base = _t(rng.standard_normal((N, N)).astype(np.float32))
    tree = {"f": (base.clone(), None), "A": base, "A0": base, "upd": None}
    moved = tbatched.put_tree(tree, "cpu")
    assert moved["A"] is moved["A0"] and moved["f"][1] is None and moved["upd"] is None
    assert torch.equal(moved["f"][0], tree["f"][0])
    assert tbatched.put_tree(tree, None) is tree
    hosts = [(rng.standard_normal((N, N)).astype(np.float32), rng.integers(0, N, N))
             for _ in range(3)]
    st = tbatched.stack_host_trees(hosts, "cpu")
    for i, (a, p) in enumerate(hosts):
        np.testing.assert_array_equal(st[0][i].numpy(), a)
        np.testing.assert_array_equal(st[1][i].numpy(), p)


# --------------------------------------------------------------------------- #
# the plan codec
# --------------------------------------------------------------------------- #


_CODEC_CASES = [
    dict(kind="lu", dtype="float32", refine=0, algo="partial"),
    dict(kind="lu", dtype="float64", refine=2, algo="tournament"),
    dict(kind="lu", dtype="float32", refine=1, algo="auto", factor_dtype="bfloat16"),
    dict(kind="lu", dtype="bfloat16", refine=0, algo="auto", substitution="trsm"),
    dict(kind="chol", dtype="float32", refine=1, algo="auto", substitution="inv"),
    dict(kind="qr", dtype="float32", refine=0, algo="auto", shape=(2 * N, N)),
]


@pytest.mark.parametrize("case", _CODEC_CASES,
                         ids=[f"{c['kind']}-{c['dtype']}-{c['algo']}" for c in _CODEC_CASES])
def test_plan_spec_matches_the_jax_codec(case):
    """On backend "xla" (a name both packages use) the port's spec dict is
    the JAX package's, key for key; it decodes back to the same plan, and
    the JAX spec decodes in the port to it too."""
    shape = case.get("shape", (N, N))
    kw = dict(v=V, kind=case["kind"], refine=case["refine"], backend="xla",
              substitution=case.get("substitution", "auto"))
    fd = case.get("factor_dtype")
    jalgo, talgo = jblas.get_panel_algo(), tblas.get_panel_algo()
    jblas.set_panel_algo(case["algo"])
    tblas.set_panel_algo(case["algo"])
    try:
        serve.clear_plans()
        jp = jserve.FactorPlan.create(shape, jnp.dtype(case["dtype"]), precision="highest",
                                      factor_dtype=None if fd is None else jnp.dtype(fd), **kw)
        tp = serve.FactorPlan.create(shape, getattr(torch, case["dtype"]),
                                     factor_dtype=None if fd is None else getattr(torch, fd),
                                     **kw)
    finally:
        jblas.set_panel_algo(jalgo)
        tblas.set_panel_algo(talgo)
    assert tp.spec() == serve.plan_spec(tp) == jserve.plan_spec(jp)
    assert serve.plan_from_spec(serve.plan_spec(tp)) is tp
    assert serve.FactorPlan.from_spec(jserve.plan_spec(jp)) is tp
    assert serve.FactorPlan.from_key(tp.key) is tp


@pytest.mark.parametrize("kind", ["lu", "chol"])
def test_plan_spec_of_the_kernel_route_matches_the_jax_pallas_plan(kind):
    """The port's kernel route is the counterpart of the JAX package's
    "pallas" backend and panel algo: the spec dicts agree key for key once
    "kernel" is read as "pallas"."""
    jalgo = jblas.get_panel_algo()
    jblas.set_panel_algo("pallas")
    try:
        serve.clear_plans()
        jp = jserve.FactorPlan.create((N, N), jnp.float32, v=V, kind=kind, refine=1,
                                      precision="highest", backend="pallas")
    finally:
        jblas.set_panel_algo(jalgo)
    tp = serve.FactorPlan.create((N, N), torch.float32, v=V, kind=kind, refine=1)
    d = {k: ("pallas" if v == "kernel" else v) for k, v in tp.spec().items()}
    assert d == jserve.plan_spec(jp)


def test_plan_codec_shims_and_refusals():
    serve.clear_plans()
    tp = serve.FactorPlan.create((N, N), torch.float32, v=V, kind="chol")
    d = tp.spec()
    assert d["backend"] == "kernel" and d["panel_algo"] == tblas.get_panel_algo()
    # records written before plans had a kind spell it as 'spd'
    legacy = {k: v for k, v in d.items() if k != "kind"}
    assert serve.plan_from_spec({**legacy, "spd": True}) is tp
    lu = serve.plan_from_spec({**legacy, "spd": False})
    assert lu.key.kind == "lu" and lu.key.spd is False and tp.key.spd is True
    # the JAX package's tagged enum pair names the port's 'highest'
    assert serve.plan_from_spec({**d, "precision": ["precision", "HIGHEST"]}) is tp
    with pytest.raises(NotImplementedError, match="mesh"):
        serve.plan_from_spec({**d, "mesh": {"device_ids": [0]}})
    with pytest.raises(ValueError, match="kind"):
        serve.plan_from_spec({**d, "kind": "svd"})
    with pytest.raises(ValueError, match="malformed"):
        serve.plan_from_spec({**d, "precision": ["nope"]})
    with pytest.raises(ValueError, match="dtype"):
        serve.plan_from_spec({**d, "dtype": "float17"})
    with pytest.raises(TypeError, match="PlanKey"):
        serve.FactorPlan.from_key(d)


# --------------------------------------------------------------------------- #
# the bucket lifecycle and device moves
# --------------------------------------------------------------------------- #


def _session(seed=10, **kw):
    serve.clear_plans()
    plan = serve.FactorPlan.create((N, N), torch.float32, v=V, **kw)
    return plan, plan.factor(_gen(np.random.default_rng(seed), 1)[0], device="cpu")


def test_release_buckets_grow_then_shrink_leaves_no_stale_programs():
    """The JAX package's contract (tests/test_control.py): retired width
    buckets leave every program family, the probe stays, factor bucket 1 is
    refused, a released width still answers (built again)."""
    plan, s = _session()
    rng = np.random.default_rng(11)
    for w in (1, 2, 4, 8):
        s.solve(rng.standard_normal((N, w)).astype(np.float32))
    assert set(plan._solve_cache) == {1, 2, 4, 8}
    assert plan.release_buckets(widths=(4, 8)) == 2
    assert set(plan._solve_cache) == {1, 2}
    assert plan.release_buckets(widths=(4, 8)) == 0
    s.solve_checked(np.ones(N, np.float32))
    assert ("health", 1) in plan._trsm_cache and ("probe",) in plan._solve_cache
    plan.release_buckets(widths=(1,))
    assert ("health", 1) not in plan._trsm_cache and 1 not in plan._solve_cache
    assert ("probe",) in plan._solve_cache
    plan._stacked_factor_fn(2)
    assert plan.release_buckets(factor_batches=(2,)) == 1
    assert ("factor", 2) not in plan._factor_cache
    with pytest.raises(ValueError, match="bucket 1"):
        plan.release_buckets(factor_batches=(1,))
    traces = plan.trace_counts["solve"]
    assert s.solve(rng.standard_normal((N, 8)).astype(np.float32)).shape == (N, 8)
    assert plan.trace_counts["solve"] == traces + 1  # the released bucket, made again
    assert plan.bucket_ready(width=8)


def test_bucket_ready_reflects_warmth_for_every_family():
    plan, s = _session(seed=12)
    assert not plan.bucket_ready(width=2) and not plan.bucket_ready()
    s.solve(np.ones((N, 2), np.float32))
    assert plan.bucket_ready(width=2) and not plan.bucket_ready(width=2, checked=True)
    s.solve_checked(np.ones((N, 2), np.float32))
    assert plan.bucket_ready(width=2, checked=True)
    plan._stacked_factor_fn(2)  # built but never called: not ready
    assert not plan.bucket_ready(factor_batch=2)
    plan._stacked_factor_fn(2)(torch.eye(N).expand(2, N, N).contiguous())
    assert plan.bucket_ready(factor_batch=2)
    # a stack bucket is warmed by an engine (one callable serves them all)
    assert not plan.bucket_ready(stack=(2, 2))
    for health in (None, HealthPolicy()):
        with ServeEngine(max_batch_delay=0.0, health=health, device="cpu") as eng:
            eng.prewarm(s, widths=(2,), stacks=(2,))
    assert plan.bucket_ready(stack=(2, 2)) and plan.bucket_ready(stack=(2, 2), checked=True)
    assert not plan.bucket_ready(stack=(4, 2))
    with pytest.raises(ValueError, match="auto"):
        plan.bucket_ready(width=2, precision="auto")
    with pytest.raises(ValueError, match="gang"):
        plan.bucket_ready(stack=(2, 2), precision="f32")
    assert not plan.bucket_ready(width=2, precision="f32")
    s.solve(np.ones((N, 2), np.float32), precision="f32")
    assert plan.bucket_ready(width=2, precision="f32")
    # the plain, checked and f32 tier programs of width 2 (the stacked
    # buckets hold no program, only warm records)
    assert plan.release_buckets(widths=(2,)) == 3
    assert not any(plan.bucket_ready(width=2, **kw) for kw in
                   ({}, {"checked": True}, {"precision": "f32"}))
    assert not plan.bucket_ready(stack=(2, 2))


def test_device_warmth_registry_and_release():
    plan, _s = _session(seed=13)
    dk = ("cuda", 0)
    assert not plan.device_warm("solve", 2, dk)
    plan.mark_device_warm("solve", 2, dk)
    plan.mark_device_warm("stacked", (4, 2), dk)
    plan.mark_device_warm("tier", ("f32", 2), dk)
    plan.mark_device_warm("factor", 4, dk)
    assert plan.device_warm("solve", 2, dk) and not plan.device_warm("solve", 2, None)
    assert plan.device_warm("tier", ("f32", 2), dk)
    plan.release_buckets(widths=(2,), factor_batches=(4,))
    assert not any(plan.device_warm(k, b, dk) for k, b in
                   (("solve", 2), ("stacked", (4, 2)), ("tier", ("f32", 2)), ("factor", 4)))


def test_to_device_keeps_the_alias_and_drops_derived_state():
    plan, s = _session(seed=14, refine=1)
    assert s._A is s._A0
    s.solve(np.ones(N, np.float32), precision="f64")
    assert s._tier_factors
    ver, ckpt, nbytes = s._gang_ver, s._ckpt_ver, s.nbytes
    assert s.to_device(None) is s and s.to_device("cpu") is s  # no-ops
    assert (s._gang_ver, s._ckpt_ver) == (ver, ckpt)
    s.device = torch.device("meta")  # pretend elsewhere: the move runs
    s.to_device("cpu")
    assert s._A is s._A0 and s.nbytes == nbytes and not s._tier_factors
    assert s._gang_ver == ver + 1 and s._ckpt_ver == ckpt + 1
    assert s.device == torch.device("cpu")


# --------------------------------------------------------------------------- #
# the launch counter under concurrent launchers
# --------------------------------------------------------------------------- #


def test_launch_counter_is_exact_under_threads():
    """Eight threads bump K3's counter (the path every kernel wrapper
    counts through, `_count_launch`) while the plain dispatch runs beside
    them, which counts nothing: the total is exact. A tiny switch interval
    makes the interpreter interleave the threads' read-add-write."""
    rng = np.random.default_rng(15)
    T = _t(rng.standard_normal((2, N, N)).astype(np.float32))
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    D = diag_block_inverses(T, lower=True, unit_diagonal=True)
    Du = diag_block_inverses(T, lower=False)
    b = _t(rng.standard_normal((2, N, 1)).astype(np.float32))
    hopper_kernels.reset_launches()
    per, nthreads = 20000, 8

    def bump():
        for _ in range(per):
            hopper_kernels._count_launch("btrsm")

    def plain():
        for _ in range(20):
            hopper_kernels.btrsm_pair(T, D, Du, b)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(nthreads)]
        threads.append(threading.Thread(target=plain))
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert hopper_kernels.LAUNCHES["btrsm"] == per * nthreads
    hopper_kernels.reset_launches()
    assert all(v == 0 for v in hopper_kernels.LAUNCHES.values())
