"""The serving mesh lane of the port (`batched.batch_mesh`, mesh plans
through `batched`, `serve`, `tier` and the engine) against the JAX
package's and against its own contracts, on the CPU.

The JAX package shards a plan's batch over its 8-device CPU mesh
(`tests/conftest.py`); the port runs k shards on the CPU
(`batch_mesh(["cpu"] * k)`, a device may repeat), each shard the
one-device program of the (B/k, N, N) shard plan. The twins of
`tests/test_mesh_lane.py` (served answers bitwise the bare plan loop,
coalesced slices bitwise their window, spill/revive and checkpoint/restore
bitwise with the shards back on their devices, deadlines, poison, zero
programs after prewarm, QoS), of the mesh cases of `tests/test_serve.py`
and `test_tier.py`, and against the JAX package: mesh factors and solves
allclose (float32 at 1e-5 relative, float64 at 1e-10; pivots equal on the
library route, where both packages run the same partial-pivoting panel),
and the JAX package's mesh records read by the port's codec. Within the
port, a mesh plan's factors and solves are bitwise the one-device plan's
on the CPU (the plain versions' batched calls do not depend on the batch
count at these sizes).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import batched as jbatched
from conflux_tpu import qos as jqos
from conflux_tpu import serve as jserve
from conflux_tpu.ops import blas as jblas
from conflux_tpu_torch import batched, profiler, qos, resilience, serve, tier
from conflux_tpu_torch.batched import Sharded, batch_mesh
from conflux_tpu_torch.engine import ServeEngine
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.resilience import (
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    HealthPolicy,
    MeshPlanUnsupported,
    RhsNonFinite,
)
from conflux_tpu_torch.tier import ResidentSet

B, N, V = 8, 32, 16
K = 2  # shards
CPU = "cpu"
T = 120


def _mesh(k=K):
    return batch_mesh([CPU] * k)


def _mesh_plan(k=K, **kw):
    return serve.FactorPlan.create((B, N, N), torch.float32, v=V, mesh=_mesh(k), **kw)


def _systems(seed=0, b=B, dtype=np.float32, spd=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, N, N)) / np.sqrt(N) + 2.0 * np.eye(N)
    if spd:
        A = np.einsum("bij,bkj->bik", A, A) + np.eye(N)
    return A.astype(dtype)


def _rhs(seed=0, w=None, b=B, dtype=np.float32):
    rng = np.random.default_rng(1000 + seed)
    shape = (b, N) if w is None else (b, N, w)
    return rng.standard_normal(shape).astype(dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unsupported_delta(h0):
    return (resilience.health_stats().get("mesh_plan_unsupported", 0)
            - h0.get("mesh_plan_unsupported", 0))


def _residuals(A, x, b):
    r = np.einsum("bij,bj->bi", A.astype(np.float64), np.asarray(x, np.float64)) - b
    return np.linalg.norm(r, axis=1) / np.linalg.norm(b.astype(np.float64), axis=1)


def _sharded_on_mesh(x, mesh):
    return (isinstance(x, Sharded) and len(x.shards) == mesh.size
            and all(s.device == d for s, d in zip(x.shards, mesh.devices)))


@pytest.fixture
def library_route():
    ja = jblas.get_panel_algo()
    jblas.set_panel_algo("auto")
    tblas.set_panel_algo("auto")
    yield
    tblas.set_panel_algo("kernel")
    jblas.set_panel_algo(ja)


# --------------------------------------------------------------------- #
# the mesh itself, and the one-shot batched entry points
# --------------------------------------------------------------------- #


def test_batch_mesh_repeats_devices_and_keys_by_position():
    from conflux_tpu_torch.parallel.mesh import lookup_mesh, mesh_cache_key

    m = _mesh(4)
    assert m.size == 4 and m.axis_names == ("b",) and m.device_shape == (4,)
    key = mesh_cache_key(m)
    assert key == ((("cpu", 0),) * 4, ("b",))
    assert mesh_cache_key(_mesh(4)) == key and lookup_mesh(key).devices == m.devices
    assert mesh_cache_key(_mesh(2)) != key  # repeats are part of the key
    if not torch.cuda.is_available():
        # every card, and no card here: it raises, never a CPU mesh
        with pytest.raises(RuntimeError, match="device='cpu'"):
            batch_mesh()
    with pytest.raises(ValueError, match="at least one"):
        batch_mesh([])
    A = torch.from_numpy(_systems(1))
    (S,) = batched._shard_batch((A,), m)
    assert _sharded_on_mesh(S, m) and tuple(S.shape) == (B, N, N)
    assert S.shards[0].data_ptr() == A.data_ptr()  # a shard on its device is a view
    assert torch.equal(batched.gather_batch(S), A)
    with pytest.raises(ValueError, match="does not split"):
        batched._shard_batch((A[:3],), m)
    (P,), Bp = batched._pad_batch((A[:3],), 3, 4)
    assert Bp == 4 and torch.equal(P[3], A[0])
    (E,), _ = batched._pad_batch((A[:3],), 3, 4, fill="eye")
    assert torch.equal(E[3], torch.eye(N))
    tree = {"a": A, "b": A, "c": None}
    host = batched.shard_host_tree(tree, m)
    assert host["a"] is host["b"] and host["c"] is None and _sharded_on_mesh(host["a"], m)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_batched_lu_matches_loop_oracle(use_mesh, library_route):
    """`solve_batched` over a mesh: bitwise the unsharded call within the
    port, allclose the JAX package's over its own mesh (1e-5 relative)."""
    A, b = _systems(2), _rhs(2)
    x0 = tbatched_solve(A, b, None)
    x = tbatched_solve(A, b, _mesh() if use_mesh else None)
    np.testing.assert_array_equal(_np(x), _np(x0))
    jmesh = jbatched.batch_mesh(jax.devices()[:K]) if use_mesh else None
    xj = np.asarray(jbatched.solve_batched(A, b, v=V, mesh=jmesh))
    np.testing.assert_allclose(_np(x), xj, rtol=1e-5, atol=1e-6)
    assert (_residuals(A, _np(x), b) < 1e-5).all()


def tbatched_solve(A, b, mesh, **kw):
    return batched.solve_batched(torch.from_numpy(A), torch.from_numpy(b), v=V, mesh=mesh,
                                 **kw)


def test_batched_ragged_batch_pads_and_slices(library_route):
    # 5 systems on 4 shards: padded to 8 with copies of system 0, sliced back
    A, b = _systems(3, b=5), _rhs(3, b=5)
    x = tbatched_solve(A, b, _mesh(4))
    assert tuple(x.shape) == (5, N)
    assert (_residuals(A, _np(x), b) < 1e-5).all()
    np.testing.assert_array_equal(_np(x), _np(tbatched_solve(A, b, None)))
    L = batched.cholesky_factor_batched(torch.from_numpy(_systems(4, b=5, spd=True)), V,
                                        mesh=_mesh(4))
    assert tuple(L.shape) == (5, N, N)


def test_batch_sharding_on_cpu_mesh(library_route):
    """The batch really shards: each shard's factor is the one-device
    factor of its rows, and the gathered result is bitwise the unsharded
    one; on the library route the pivots equal the JAX package's mesh
    factor's."""
    A = _systems(5)
    m = _mesh(4)
    (S,) = batched._shard_batch((torch.from_numpy(A),), m)
    LUs, perms = batched.mesh_map(lambda a: batched.lu_factor_batched(a, V, backend="xla"),
                                  None, S)
    assert _sharded_on_mesh(LUs, m) and [s.shape[0] for s in LUs.shards] == [2] * 4
    LU, perm = batched.lu_factor_batched(torch.from_numpy(A), V, mesh=m, backend="xla")
    LU0, perm0 = batched.lu_factor_batched(torch.from_numpy(A), V, backend="xla")
    assert torch.equal(LU, LU0) and torch.equal(perm, perm0)
    assert torch.equal(batched.gather_batch(LUs), LU0)
    jLU, jperm = jbatched.lu_factor_batched(A, v=V, mesh=jbatched.batch_mesh(jax.devices()[:4]))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(LU.numpy(), np.asarray(jLU), rtol=1e-5, atol=1e-6)


def test_batched_updated_and_substitution_entries_on_a_mesh(library_route):
    A, b = _systems(6), _rhs(6, w=2)
    rng = np.random.default_rng(6)
    U = (rng.standard_normal((B, N, 2)) * 0.01).astype(np.float32)
    t = torch.from_numpy
    x0 = batched.solve_updated_batched(t(A), t(U), t(U), t(b), v=V)
    x = batched.solve_updated_batched(t(A), t(U), t(U), t(b), v=V, mesh=_mesh())
    assert torch.equal(x, x0)
    LU, perm = batched.lu_factor_batched(t(A), V)
    assert torch.equal(batched.lu_solve_batched(LU, perm, t(b), mesh=_mesh()),
                       batched.lu_solve_batched(LU, perm, t(b)))
    S = t(_systems(7, spd=True))
    L = batched.cholesky_factor_batched(S, V)
    assert torch.equal(batched.cholesky_solve_batched(L, t(b), mesh=_mesh()),
                       batched.cholesky_solve_batched(L, t(b)))


# --------------------------------------------------------------------- #
# plans and sessions: against the one-device plan and the JAX package
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["lu", "chol"])
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_plan_is_bitwise_the_one_device_plan(kind, k):
    """One K4/K5 program per shard, one K3 round per shard: the mesh
    plan's factors, solves, checked verdict, Woodbury update and refactor
    are bitwise the one-device plan's of the same (B, N, N)."""
    serve.clear_plans()
    A = _systems(8, spd=kind == "chol")
    mp = serve.FactorPlan.create((B, N, N), torch.float32, v=V, kind=kind, mesh=_mesh(k))
    op = serve.FactorPlan.create((B, N, N), torch.float32, v=V, kind=kind)
    s, o = mp.factor(A, device=CPU), op.factor(A, device=CPU)
    assert s.device is None and all(_sharded_on_mesh(f, mp.mesh) for f in s.factors)
    for f, g in zip(s.factors, o.factors):
        assert torch.equal(batched.gather_batch(f), g)
    b = _rhs(8, w=3)
    assert torch.equal(s.solve(b), o.solve(b))
    (xs, vs), (xo, vo) = s.solve_checked(b), o.solve_checked(b)
    assert torch.equal(xs, xo) and torch.equal(vs, vo) and vs[0] == 1.0
    U = (np.random.default_rng(9).standard_normal((B, N, 3)) * 0.01).astype(np.float32)
    s.update(U, U)
    o.update(U, U)
    assert s.update_rank == 3 and torch.equal(s.solve(b), o.solve(b))
    s.refactor()
    o.refactor()
    assert s.refactors == 1 and torch.equal(s.solve(b), o.solve(b))
    assert s.nbytes == o.nbytes
    assert mp.trace_counts["factor"] == 1


@pytest.mark.parametrize("use_mesh", [False, True])
def test_session_solutions_match_oracle(use_mesh):
    """A mesh session against the JAX package's mesh session (default
    routes: the port's K4 plain version, the JAX package's blocked
    tournament body): both within the loop oracle's residual bar, and
    allclose."""
    serve.clear_plans()
    jserve.clear_plans()
    A, b = _systems(10), _rhs(10)
    plan = serve.FactorPlan.create((B, N, N), torch.float32, v=V,
                                   mesh=_mesh() if use_mesh else None)
    jplan = jserve.FactorPlan.create(
        (B, N, N), jnp.float32, v=V,
        mesh=jbatched.batch_mesh(jax.devices()[:K]) if use_mesh else None)
    x = _np(plan.factor(A, device=CPU).solve(b))
    xj = np.asarray(jplan.factor(jnp.asarray(A)).solve(jnp.asarray(b)))
    assert (_residuals(A, x, b) < 1e-5).all() and (_residuals(A, xj, b) < 1e-5).all()
    np.testing.assert_allclose(x, xj, rtol=1e-5, atol=1e-5)
    b2 = np.ascontiguousarray(b[::-1])
    assert (_residuals(A, _np(plan.factor(A, device=CPU).solve(b2)), b2) < 1e-5).all()


@pytest.mark.parametrize("kind,dtype,tol", [("lu", np.float32, 1e-5),
                                            ("lu", np.float64, 1e-10),
                                            ("chol", np.float32, 1e-5),
                                            ("chol", np.float64, 1e-10)])
def test_xla_mesh_plan_matches_jax_mesh_plan(kind, dtype, tol, library_route):
    """The port's backend='xla' mesh plan against the JAX package's mesh
    plan (both on the library route): factors and solves allclose, pivots
    equal."""
    serve.clear_plans()
    jserve.clear_plans()
    A, b = _systems(11, dtype=dtype, spd=kind == "chol"), _rhs(11, w=2, dtype=dtype)
    jd = {np.float32: jnp.float32, np.float64: jnp.float64}[dtype]
    jplan = jserve.FactorPlan.create((B, N, N), jd, v=V, kind=kind, backend="xla",
                                     mesh=jbatched.batch_mesh(jax.devices()[:K]))
    tplan = serve.FactorPlan.create((B, N, N), torch.from_numpy(A).dtype, v=V, kind=kind,
                                    backend="xla", mesh=_mesh())
    js, ts = jplan.factor(jnp.asarray(A)), tplan.factor(A, device=CPU)
    F = [batched.gather_batch(f).numpy() for f in ts.factors]
    JF = [np.asarray(f) for f in js._factors]
    if kind == "lu":
        np.testing.assert_array_equal(F[-1], JF[-1])  # pivots
    np.testing.assert_allclose(F[0], JF[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(ts.solve(b)), np.asarray(js.solve(jnp.asarray(b))),
                               rtol=tol, atol=tol)


def test_mesh_plan_refusals_and_pins():
    serve.clear_plans()
    with pytest.raises(ValueError, match="mesh only applies"):
        serve.FactorPlan.create((N, N), torch.float32, v=V, mesh=_mesh())
    with pytest.raises(ValueError, match="unsharded"):
        serve.FactorPlan.create((64, N), torch.float32, kind="qr", mesh=_mesh())
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        serve.FactorPlan.create((6, N, N), torch.float32, v=V, mesh=_mesh(4))
    plan = _mesh_plan()
    A = _systems(12)
    h0 = resilience.health_stats()
    with pytest.raises(ValueError, match="native precision"):
        plan.factor(A, device=CPU, precision="f32")
    with pytest.raises(ValueError, match="native precision"):
        plan._tier_spec("f32")
    with pytest.raises(AssertionError, match="unsharded"):
        plan._stacked_factor_fn(1)
    with pytest.raises(AssertionError, match="unsharded"):
        plan._factor_health_fn(1)
    s = plan.factor(A, device=CPU)  # an in-mesh device is a placement no-op
    with pytest.raises(MeshPlanUnsupported) as ei:
        plan.factor(A, device="cuda:3")
    assert ei.value.surface == "factor"
    with pytest.raises(MeshPlanUnsupported) as ei:
        s.to_device("cuda:3")
    assert ei.value.surface == "to_device"
    assert s.to_device(CPU) is s and s.device is None
    assert _unsupported_delta(h0) == 2


def test_jax_mesh_records_through_the_port_codec():
    """The JAX package's mesh `plan_spec` read by the port: ids are its
    global device ids, resolved on the caller's platform (the CPU, one
    device here). A 2-device record raises MeshPlanUnsupported (surface
    'plan_codec'); a 1-device record maps onto cpu:0 and round-trips."""
    serve.clear_plans()
    jserve.clear_plans()
    j2 = jserve.FactorPlan.create((B, N, N), jnp.float32, v=V,
                                  mesh=jbatched.batch_mesh(jax.devices()[:2]))
    d2 = jserve.plan_spec(j2)
    d2 = {**d2, "backend": "kernel", "panel_algo": tblas.get_panel_algo()}
    with pytest.raises(MeshPlanUnsupported, match="device ids") as ei:
        serve.plan_from_spec(d2, device=CPU)
    assert ei.value.surface == "plan_codec"
    j1 = jserve.FactorPlan.create((B, N, N), jnp.float32, v=V,
                                  mesh=jbatched.batch_mesh(jax.devices()[:1]))
    d1 = {**jserve.plan_spec(j1), "backend": "kernel",
          "panel_algo": tblas.get_panel_algo()}
    p = serve.plan_from_spec(d1, device=CPU)
    assert p.mesh.devices == (torch.device("cpu", 0),) and p.key.shape == (B, N, N)
    assert serve.plan_from_spec(p.spec()) is p  # the port's record names its platform
    # a record naming cuda ids this process lacks is the same residue
    with pytest.raises(MeshPlanUnsupported):
        serve.plan_from_spec({**p.spec(), "mesh": {**p.spec()["mesh"], "platform": "cuda",
                                                   "device_ids": [0, 7]}})


def test_mesh_plan_key_roundtrips_fleet_codec(tmp_path):
    serve.clear_plans()
    plan = _mesh_plan(4)
    key0 = plan.key
    A, b = _systems(13), _rhs(13)
    s = plan.factor(A, device=CPU)
    x0 = s.solve(b)
    tier.save_fleet(str(tmp_path / "ck"), [s], names=["m"])
    serve.clear_plans()  # a cold process: the codec carries it all
    (back,) = tier.load_fleet(str(tmp_path / "ck"), device=CPU)
    assert back.plan.key == key0 and back.plan.mesh.devices == plan.mesh.devices
    assert back.device is None
    assert torch.equal(back.solve(b), x0)
    assert all(_sharded_on_mesh(f, back.plan.mesh) for f in back._factors)


# --------------------------------------------------------------------- #
# the engine serves the mesh (twins of tests/test_mesh_lane.py)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("checked", [False, True])
def test_mesh_submit_bitwise_vs_bare_plan(checked):
    serve.clear_plans()
    plan = _mesh_plan()
    A, b = _systems(14), _rhs(14)
    oracle = plan.factor(A, device=CPU)
    x0 = oracle.solve(b).numpy()
    h0 = resilience.health_stats()
    kw = {"health": HealthPolicy()} if checked else {}
    with ServeEngine(max_batch_delay=0.0, device=CPU, **kw) as eng:
        sess = eng.factor(plan, A, timeout=T)
        assert sess.plan is plan and sess.plan.mesh is not None
        assert sess.device is None  # unpinned: the state spans the mesh
        np.testing.assert_array_equal(eng.solve(sess, b, timeout=T), x0)
        for f, g in zip(sess.factors, oracle.factors):
            assert all(torch.equal(x, y) for x, y in zip(f.shards, g.shards))
        c = eng.counters()
        assert c["factor_requests"] == 1
        assert c["factor_bucket_hits"] == {1: 1}  # one sharded dispatch
    assert _unsupported_delta(h0) == 0


def test_mesh_factors_stay_sharded_through_engine():
    serve.clear_plans()
    plan = _mesh_plan(4)
    with ServeEngine(max_batch_delay=0.0, device=CPU, health=HealthPolicy()) as eng:
        sess = eng.factor(plan, _systems(15), timeout=T)
    assert all(_sharded_on_mesh(f, plan.mesh) for f in sess._factors)
    assert _sharded_on_mesh(sess._A0, plan.mesh) and _sharded_on_mesh(sess._probe, plan.mesh)


def test_mesh_rhs_coalesced_dispatch_bitwise_per_request():
    serve.clear_plans()
    plan = _mesh_plan()
    sess = plan.factor(_systems(16), device=CPU)
    bs = [_rhs(30), _rhs(31, 2), _rhs(32)]
    cols = [b[..., None] if b.ndim == 2 else b for b in bs]
    # the oracle is the bare session solving the same merged window
    # (widths 1+2+1 -> the bucket-4 dispatch), sliced back per request
    merged = sess.solve(np.concatenate(cols, axis=-1)).numpy()
    direct, off = [], 0
    for b, c in zip(bs, cols):
        w = c.shape[-1]
        d = merged[..., off:off + w]
        direct.append(d[..., 0] if b.ndim == 2 else d)
        off += w
    solo = [sess.solve(b).numpy() for b in bs]
    h0 = resilience.health_stats()
    eng = ServeEngine(max_batch_delay=60.0, max_coalesce_width=8, device=CPU)
    futs = [eng.submit(sess, b) for b in bs]  # one window
    assert eng.close(timeout=T) == []
    for f, d, s in zip(futs, direct, solo):
        x = f.result(0)
        np.testing.assert_array_equal(x, d)
        # and the solo programs: bitwise too on the CPU's plain path
        np.testing.assert_array_equal(x, s)
    c = eng.counters()
    assert c["batches"] == 1, "the window must merge into one dispatch"
    assert c["coalesced_requests"] == 3
    assert c["bucket_hits"] == {4: 1}
    assert _unsupported_delta(h0) == 0


def test_mesh_spill_revive_bitwise_and_resharded(tmp_path):
    serve.clear_plans()
    plan = _mesh_plan()
    A, b = _systems(17), _rhs(17, 2)
    sess = plan.factor(A, device=CPU)
    x0 = sess.solve(b)
    rs = ResidentSet(disk_dir=str(tmp_path))
    rs.adopt(sess)
    assert rs.spill(sess) == 1
    assert sess.tier == "host" and sess._factors is None
    assert sess.nbytes == 0 and sess._spill.nbytes > 0
    # the host record holds the whole batch, one tensor a leaf
    assert tuple(sess._spill.leaves["A0"].shape) == (B, N, N)
    assert torch.equal(sess.solve(b), x0)  # transparent fault-in
    assert sess.tier == "device"
    assert all(_sharded_on_mesh(f, plan.mesh) for f in sess._factors)
    rs.spill(sess)
    assert rs.demote(sess) == 1 and sess.tier == "disk"
    assert torch.equal(sess.solve(b), x0)
    per = rs.stats()["per_device"]
    assert per == {"('cpu', 0)": {"sessions": 1, "bytes": sess.nbytes}}


def test_mesh_spill_revive_through_engine_traffic():
    serve.clear_plans()
    plan = _mesh_plan()
    A, b = _systems(18), _rhs(18)
    rs = ResidentSet()
    with ServeEngine(max_batch_delay=0.0, residency=rs, device=CPU) as eng:
        sess = eng.factor(plan, A, timeout=T)
        rs.adopt(sess)
        x0 = eng.solve(sess, b, timeout=T)
        rs.spill(sess)
        assert sess.tier == "host"
        np.testing.assert_array_equal(eng.solve(sess, b, timeout=T), x0)
        assert sess.tier == "device"
        # a stale drift revives by refactor through the mesh lane
        U = (np.random.default_rng(18).standard_normal((B, N, 2)) * 0.01).astype(np.float32)
        sess.update(U, U)
        want = sess.solve(b)
        rs.revive_refactor_rank = 1
        rs.spill(sess)
        x = eng.solve(sess, b, timeout=T)
        assert sess.update_rank == 0 and sess.refactors == 1
        np.testing.assert_allclose(x, want.numpy(), rtol=1e-4, atol=1e-5)
    st = tier.tier_stats()
    assert st["revives_h2d"] > 0 and st["revives_refactor"] > 0


def test_mesh_checkpoint_restore_bitwise(tmp_path):
    serve.clear_plans()
    plan = _mesh_plan()
    A, b = _systems(19), _rhs(19)
    d = str(tmp_path / "ckpt")
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        sess = eng.factor(plan, A, timeout=T)
        x0 = eng.solve(sess, b, timeout=T)
        solves = sess.solves
        eng.checkpoint(d, sessions=[sess], names=["m0"])
    serve.clear_plans()  # a cold process: the plan rebuilds from disk
    with ServeEngine(max_batch_delay=0.0, device=CPU) as eng:
        (back,) = eng.restore(d)
        assert back.plan.mesh is not None and back.solves == solves
        np.testing.assert_array_equal(eng.solve(back, b, timeout=T), x0)
        assert all(_sharded_on_mesh(f, back.plan.mesh) for f in back._factors)


def test_mesh_lazy_restore_faults_in_on_first_touch(tmp_path):
    serve.clear_plans()
    plan = _mesh_plan()
    A, b = _systems(20), _rhs(20)
    sess = plan.factor(A, device=CPU)
    x0 = sess.solve(b)
    d = str(tmp_path / "fleet")
    tier.save_fleet(d, [sess], names=["z"])
    serve.clear_plans()
    rs = ResidentSet()
    (back,) = tier.load_fleet(d, residency=rs, device=CPU)
    assert back.tier == "host"
    assert torch.equal(back.solve(b), x0)
    assert back.tier == "device"


def test_mesh_deadline_evicts_mid_window():
    serve.clear_plans()
    plan = _mesh_plan()
    sess = plan.factor(_systems(21), device=CPU)
    h0 = resilience.health_stats()
    eng = ServeEngine(max_batch_delay=60.0, device=CPU)
    t0 = time.perf_counter()
    fut = eng.submit(sess, _rhs(21), deadline=0.1)
    with pytest.raises(DeadlineExceeded, match="slot released"):
        fut.result(30)
    assert time.perf_counter() - t0 < 30
    assert eng.stats()["pending"] == 0
    assert eng.close(timeout=T) == []
    assert resilience.health_stats()["evictions"] - h0.get("evictions", 0) == 1


def test_mesh_poisoned_rhs_rejected_at_admission():
    serve.clear_plans()
    plan = _mesh_plan()
    sess = plan.factor(_systems(22), device=CPU)
    bad = _rhs(22)
    bad[3, 5] = np.nan
    with ServeEngine(max_batch_delay=0.0, health=HealthPolicy(), device=CPU) as eng:
        with pytest.raises(RhsNonFinite):
            eng.submit(sess, bad)
        with pytest.raises(RhsNonFinite):
            eng.submit_factor(plan, np.where(np.isnan(bad[..., None]), np.nan,
                                             _systems(23)))
        good = _rhs(23)
        np.testing.assert_array_equal(eng.solve(sess, good, timeout=T),
                                      sess.solve(good).numpy())
        with pytest.raises(MeshPlanUnsupported) as ei:
            eng.submit(sess, good, precision="f32")
        assert ei.value.surface == "submit"
        with pytest.raises(MeshPlanUnsupported) as ei:
            eng.submit_factor(plan, _systems(23), precision="f32")
        assert ei.value.surface == "factor_lane"
        with pytest.raises(MeshPlanUnsupported) as ei:
            eng.submit_factor(plan, _systems(23), device="cuda:3")
        assert ei.value.surface == "factor_lane"
        # an in-mesh device is a placement no-op
        assert eng.factor(plan, _systems(23), device=CPU, timeout=T).device is None


def test_mesh_staging_poison_isolated_survivors_bitwise():
    """A request poisoned after admission (a seeded staging fault) fails
    its own future; the co-batched mesh requests of the same window get
    bitwise the answers they get alone."""
    serve.clear_plans()
    plan = _mesh_plan()
    sess = plan.factor(_systems(24), device=CPU)
    bs = [_rhs(40, 2), _rhs(41), _rhs(42)]
    direct = [sess.solve(b).numpy() for b in bs]
    faults = FaultPlan([FaultSpec("staging", "nan", count=1)])
    h0 = resilience.health_stats()
    eng = ServeEngine(max_batch_delay=60.0, health=HealthPolicy(), fault_plan=faults,
                      device=CPU)
    futs = [eng.submit(sess, b) for b in bs]
    assert eng.close(timeout=T) == []
    with pytest.raises(RhsNonFinite, match="staging"):
        futs[0].result(0)
    for f, d in zip(futs[1:], direct[1:]):
        np.testing.assert_array_equal(f.result(0), d)
    h1 = resilience.health_stats()
    assert h1["staging_isolations"] - h0.get("staging_isolations", 0) == 1


@pytest.mark.parametrize("checked", [False, True])
def test_mesh_zero_compile_steady_state_after_prewarm(checked):
    serve.clear_plans()
    plan = _mesh_plan()
    A = _systems(25)
    kw = {"health": HealthPolicy()} if checked else {}
    with ServeEngine(max_batch_delay=0.01, max_coalesce_width=8, device=CPU, **kw) as eng:
        eng.prewarm(plan, factor_batches=(1, 4))  # a mesh warms bucket 1 only
        assert plan.bucket_ready(factor_batch=1, checked=checked)
        sess = eng.factor(plan, A, timeout=T)
        eng.prewarm(sess, widths=(1, 2, 4))
        tc0, c0 = dict(plan.trace_counts), profiler.compile_count()
        eng.solve(sess, _rhs(50), timeout=T)
        futs = [eng.submit(sess, _rhs(51 + i)) for i in range(4)]
        for f in futs:
            f.result(T)
        eng.solve(sess, _rhs(55, 2), timeout=T)
        assert eng.factor(plan, A, timeout=T).plan is plan  # steady-state refit
        assert dict(plan.trace_counts) == tc0, "mesh traffic must build nothing"
        assert profiler.compile_count() == c0
        # a second prewarm of the same buckets dispatches nothing
        n0 = eng.counters()["factor_batches"]
        eng.prewarm(sess, widths=(1, 2, 4), factor_batches=(1,))
        assert dict(plan.trace_counts) == tc0 and eng.counters()["factor_batches"] == n0


def test_mesh_request_cost_is_flop_aware():
    """The ledger weight of a request (`qos.request_cost`) is the JAX
    package's: a large-N mesh tenant weighs as the capacity it
    displaces."""
    for shape, kw in (((256, 256), {"width": 1}), ((8, 1024, 1024), {"width": 4}),
                      ((8, 1024, 1024), {"factor": True}), ((32, 256, 256), {"width": 1}),
                      ((2, 4096, 4096), {"width": 1})):
        assert qos.request_cost(shape, **kw) == jqos.request_cost(shape, **kw)
    assert qos.request_cost((8, 1024, 1024), width=4) == 16.0
    led = qos.FairShareLedger()
    big = qos.QosClass(tenant="mesh")
    led.try_admit(big, 0, 64, cost=16.0)
    assert led._pending["mesh"] == 16.0
    led.release(big, cost=16.0)
    assert led._pending["mesh"] == 0.0


def test_mixed_mesh_and_fleet_trace_on_one_engine():
    serve.clear_plans()
    mplan = _mesh_plan()
    fplan = serve.FactorPlan.create((N, N), torch.float32, v=V)
    rng = np.random.default_rng(60)
    Af = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
    bf = rng.standard_normal((N,)).astype(np.float32)
    Am, bm = _systems(61), _rhs(61)
    mesh_cls = qos.QosClass(tenant="mesh", tier="throughput")
    fleet_cls = qos.QosClass(tenant="fleet", tier="latency")
    h0 = resilience.health_stats()
    with ServeEngine(max_batch_delay=0.005, device=CPU) as eng:
        ms = eng.factor(mplan, Am, qos=mesh_cls, timeout=T)
        fs = eng.factor(fplan, Af, qos=fleet_cls, timeout=T)
        xm, xf = ms.solve(bm).numpy(), fs.solve(bf).numpy()
        for _ in range(3):
            fm = eng.submit(ms, bm, qos=mesh_cls)
            ff = eng.submit(fs, bf, qos=fleet_cls)
            np.testing.assert_array_equal(fm.result(T), xm)
            np.testing.assert_array_equal(ff.result(T), xf)
        st = eng.stats()["qos"]
        assert {"mesh/throughput", "fleet/latency"} <= set(st["classes"])
        for row in st["tenants"].values():
            assert row["pending"] == 0
    assert _unsupported_delta(h0) == 0


# --------------------------------------------------------------------- #
# the fabric: mesh sessions as heavyweight tenants
# --------------------------------------------------------------------- #


def test_fabric_serves_mesh_sessions_and_maps_the_residue(tmp_path):
    """A fabric host opens a mesh session from its record (the port's
    record names its platform), answers bitwise the direct session and
    migrates it bitwise; the session is priced as the capacity its shape
    takes (`qos.request_cost`). A record naming cards this host lacks is
    refused with MeshPlanUnsupported, which crosses the process wire with
    its surface."""
    from conflux_tpu_torch import fabric
    from conflux_tpu_torch.fabric import FabricPolicy

    serve.clear_plans()
    plan = _mesh_plan()
    A, b = _systems(70), _rhs(70, w=2)
    x0 = plan.factor(A, device=CPU).solve(b).numpy()
    fab = fabric.local_fabric(
        2, str(tmp_path), policy=FabricPolicy(heartbeat_interval=0.05,
                                              heartbeat_timeout=30.0),
        engine_kwargs={"max_batch_delay": 0.0, "device": CPU})
    try:
        fab.start()
        fab.open("m", plan.spec(), A)
        np.testing.assert_array_equal(np.asarray(fab.solve("m", b)), x0)
        assert fab._sid_cost["m"] == qos.request_cost((B, N, N))
        fab.migrate("m")
        np.testing.assert_array_equal(np.asarray(fab.solve("m", b)), x0)
        bad = {**plan.spec(), "mesh": {**plan.spec()["mesh"], "platform": "cuda",
                                       "device_ids": [0, 7]}}
        with pytest.raises(MeshPlanUnsupported) as ei:
            fab.open("m2", bad, A)
        assert ei.value.surface == "plan_codec"
    finally:
        fab.close()
    with pytest.raises(MeshPlanUnsupported) as ei:
        fabric._raise_wire(fabric._encode_exc(MeshPlanUnsupported("x", surface="plan_codec")))
    assert ei.value.surface == "plan_codec"
