"""Tiered session residency and the fleet checkpoint in the port
(`conflux_tpu_torch.tier`) on the CPU: twins of the reference's
tests/test_tier.py, of the tier cases of tests/test_scale.py and of
tests/test_gang.py's spill/revive slot case, with the port held against
the JAX package on the same seeded inputs.

- The leaf codec round-trips every dtype bitwise (bfloat16 and int64
  included) with the JAX package's encoding, and each package reads the
  other's disk records.
- Spill -> transparent revive is bitwise against the never-spilled session
  (plain and checked, drifted, from host and disk); checkpoint -> restore
  is bitwise against the pre-checkpoint session; both answer allclose the
  JAX session on the same inputs (1e-5 float32, 1e-12 float64).
- Capacity: LRU eviction under count and byte caps, high-water at most the
  cap, a spilled session's `nbytes` is 0; the heap victim picks equal the
  full-sort oracle's; delta checkpoint generations carry clean records.
- Faults fail only the owning session (`SessionSpilled`, `RestoreCorrupt`,
  `InjectedFault`); deadlines release admission slots; the checkpoint's
  drain barrier never deadlocks a revival.

Every engine is closed in a `finally`; every wait has a timeout.
"""

import json
import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import serve as jserve
from conflux_tpu import tier as jtier
from conflux_tpu_torch import profiler, serve, tier
from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
from conflux_tpu_torch.resilience import (
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    RestoreCorrupt,
    SessionSpilled,
)
from conflux_tpu_torch.tier import ResidentSet, _decode_leaf, _encode_leaf

N, V = 32, 16
CPU = "cpu"
T = 60


def _plan(dtype=torch.float32, **kw):
    return serve.FactorPlan.create((N, N), dtype, v=V, **kw)


def _mk(rng, n=N, dtype=np.float32):
    return (rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(dtype)


def _fleet(plan, count, seed=0, drift_rank=0, dtype=np.float32):
    """(session, A as float64 with its drift, A, U, V) per system."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        A = _mk(rng, dtype=dtype)
        s = plan.factor(A, device=CPU)
        A64 = A.astype(np.float64)
        U = Vm = None
        if drift_rank:
            U = (0.01 * rng.standard_normal((N, drift_rank))).astype(dtype)
            Vm = (0.01 * rng.standard_normal((N, drift_rank))).astype(dtype)
            s.update(U, Vm)
            A64 = A64 + U.astype(np.float64) @ Vm.astype(np.float64).T
        out.append((s, A64, A, U, Vm))
    return out


def _jax_session(jplan, A, U=None, Vm=None):
    s = jplan.factor(jnp.asarray(A))
    if U is not None:
        s.update(U, Vm)
    return s


def _close_to_jax(x, jx, dtype=np.float32):
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(x, np.asarray(jx), rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# the codec
# --------------------------------------------------------------------- #


def _codec_leaves():
    g = torch.Generator().manual_seed(0)
    return [
        torch.randn((3, 5), generator=g),
        torch.randn((2, 3, 4), generator=g, dtype=torch.float64),
        torch.randint(-(2 ** 30), 2 ** 30, (7,), generator=g, dtype=torch.int32),
        torch.randint(-(2 ** 60), 2 ** 60, (4, 2), generator=g, dtype=torch.int64),
        torch.randn((3, 3), generator=g, dtype=torch.complex64),
        torch.randn((4, 4), generator=g).to(torch.bfloat16),
        torch.randn((5,), generator=g).to(torch.float16),
        torch.tensor([True, False, True]),
    ]


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_leaf_codec_bitwise_all_dtypes():
    for a in _codec_leaves():
        enc, meta = _encode_leaf(a)
        dec = _decode_leaf(enc, meta)
        assert dec.dtype == a.dtype and dec.shape == a.shape
        assert _bits(dec) == _bits(a), a.dtype
        # the on-disk encoding is the JAX package's: same words, same meta
        if a.dtype == torch.bfloat16:
            ja = np.asarray(jnp.asarray(a.float().numpy(), jnp.bfloat16))
        else:
            ja = a.numpy()
        jenc, jmeta = jtier._encode_leaf(ja)
        assert jmeta == meta
        np.testing.assert_array_equal(jenc, enc)


def test_disk_record_roundtrip_and_crc_and_reads_across_packages(tmp_path):
    g = torch.Generator().manual_seed(1)
    leaves = {"f0": torch.randn((4, 4), generator=g),
              "A0": torch.randn((4, 4), generator=g),
              "perm": torch.randperm(4, generator=g)}
    meta = {"n_factors": 1, "keep_A": False, "has_probe": False, "upd": None,
            "owns_base": False, "last_cond": None,
            "counters": {"factorizations": 1, "solves": 0, "updates": 0, "refactors": 0}}
    d = str(tmp_path / "rec")
    tier._write_record(d, leaves, meta)
    back, meta2 = tier._read_record(d)
    assert meta2 == meta
    for k in leaves:
        assert torch.equal(back[k], leaves[k]) and back[k].dtype == leaves[k].dtype
    # the JAX package reads the port's record, and the port reads its
    jback, _ = jtier._read_record(d)
    for k in leaves:
        np.testing.assert_array_equal(np.asarray(jback[k]), leaves[k].numpy())
    d2 = str(tmp_path / "jrec")
    jtier._write_record(d2, {k: v.numpy() for k, v in leaves.items()}, meta)
    back2, _ = tier._read_record(d2)
    for k in leaves:
        assert torch.equal(back2[k], leaves[k])
    # flip a payload byte: the CRC catches it, with evidence
    with open(str(tmp_path / "rec" / "f0.bin"), "r+b") as f:
        f.seek(30)
        f.write(b"\xff")
    with pytest.raises(RestoreCorrupt) as ei:
        tier._read_record(d)
    assert ei.value.evidence["leaf"] == "f0"
    assert "expected_crc" in ei.value.evidence


# --------------------------------------------------------------------- #
# nbytes accounting
# --------------------------------------------------------------------- #


def test_nbytes_accounting():
    plan = _plan()
    rng = np.random.default_rng(2)
    s = _fleet(plan, 1, seed=2)[0][0]
    base = s.nbytes
    assert base >= 2 * N * N * 4
    U = rng.standard_normal((N, 2)).astype(np.float32)
    s.update(U, U)
    grown = s.nbytes
    assert grown > base  # Up/Vp/Y/Cinv joined the footprint
    rs = ResidentSet()
    rs.adopt(s)
    rs.spill(s)
    assert s.nbytes == 0
    assert s._spill.nbytes > 0
    assert rs.stats()["host_bytes"] == s._spill.nbytes


def test_spilled_session_nbytes_is_zero_and_update_rank_reads_the_record():
    """A spilled session holds no factors: `nbytes` is 0 (it used to build
    its leaf list from the factors and raised TypeError), and
    `update_rank` reads the record without faulting in."""
    plan = _plan()
    s = _fleet(plan, 1, seed=40, drift_rank=3)[0][0]
    rs = ResidentSet()
    rs.adopt(s)
    assert rs.spill(s) == 1
    assert s._factors is None
    assert s.nbytes == 0
    assert s.update_rank == 3 and s.tier == "host"


def test_nbytes_in_engine_stats():
    plan = _plan()
    s = _fleet(plan, 1, seed=3)[0][0]
    rs = ResidentSet(max_sessions=4)
    rs.adopt(s)
    eng = ServeEngine(max_batch_delay=0.0, residency=rs, device=CPU)
    try:
        st = eng.stats()["tier"]
        assert st["resident_sessions"] == 1
        assert st["device_bytes"] == s.nbytes
        assert rs.engine is eng
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# spill / revive: bitwise transparency, and the JAX session's answers
# --------------------------------------------------------------------- #


def test_spill_revive_bitwise_plain_and_checked():
    plan = _plan()
    rng = np.random.default_rng(4)
    s, _A64, A, _U, _V = _fleet(plan, 1, seed=4)[0]
    b = rng.standard_normal((N, 3)).astype(np.float32)
    x0 = s.solve(b).clone()
    xc0, v0 = s.solve_checked(b)
    rs = ResidentSet()
    rs.adopt(s)
    assert rs.spill(s) == 1
    assert s.tier == "host" and s._factors is None
    x1 = s.solve(b)  # transparent fault-in
    assert s.tier == "device"
    assert torch.equal(x0, x1)
    rs.spill(s)
    xc1, v1 = s.solve_checked(b)
    assert torch.equal(xc0, xc1) and torch.equal(v0, v1)
    js = _jax_session(jserve.FactorPlan.create((N, N), jnp.float32, v=V), A)
    _close_to_jax(x1.numpy(), js.solve(b))


def test_spill_revive_bitwise_with_drift():
    plan = _plan()
    rng = np.random.default_rng(5)
    s, _A64, A, U, Vm = _fleet(plan, 1, seed=5, drift_rank=2)[0]
    b = rng.standard_normal((N, 2)).astype(np.float32)
    x0 = s.solve(b).clone()
    rs = ResidentSet()
    rs.adopt(s)
    rs.spill(s)
    x1 = s.solve(b)
    assert torch.equal(x0, x1)
    assert s.update_rank == 2  # the Woodbury state came back whole
    js = _jax_session(jserve.FactorPlan.create((N, N), jnp.float32, v=V), A, U, Vm)
    _close_to_jax(x1.numpy(), js.solve(b))


def test_disk_tier_revive_bitwise(tmp_path):
    plan = _plan()
    rng = np.random.default_rng(6)
    s = _fleet(plan, 1, seed=6, drift_rank=1)[0][0]
    b = rng.standard_normal((N, 1)).astype(np.float32)
    x0 = s.solve(b).clone()
    h0 = tier.tier_stats()
    rs = ResidentSet(disk_dir=str(tmp_path))
    rs.adopt(s)
    rs.spill(s)
    assert rs.demote(s) == 1
    assert s.tier == "disk"
    assert rs.stats()["disk_bytes"] > 0
    assert torch.equal(x0, s.solve(b))
    h1 = tier.tier_stats()
    assert h1["spills_disk"] - h0.get("spills_disk", 0) == 1
    assert h1["revives_disk"] - h0.get("revives_disk", 0) == 1
    assert h1["disk_bytes_written"] > h0.get("disk_bytes_written", 0)
    assert h1["disk_bytes_read"] > h0.get("disk_bytes_read", 0)


def test_float64_spill_disk_and_restore_bitwise_and_match_jax(tmp_path):
    plan = _plan(torch.float64)
    rng = np.random.default_rng(41)
    s, _A64, A, U, Vm = _fleet(plan, 1, seed=41, drift_rank=2, dtype=np.float64)[0]
    b = rng.standard_normal((N, 2))
    x0 = s.solve(b).clone()
    rs = ResidentSet(disk_dir=str(tmp_path / "spill"))
    rs.adopt(s)
    rs.spill(s)
    rs.demote(s)
    assert torch.equal(x0, s.solve(b))
    tier.save_fleet(str(tmp_path / "ck"), [s])
    (r,) = tier.load_fleet(str(tmp_path / "ck"), device=CPU)
    assert torch.equal(x0, r.solve(b))
    js = _jax_session(jserve.FactorPlan.create((N, N), jnp.float64, v=V), A, U, Vm)
    _close_to_jax(r.solve(b).numpy(), js.solve(b), np.float64)


def test_update_and_refactor_on_spilled_session():
    """update()/refactor() fault a spilled session in first: every
    state-touching entry revives, not just solve."""
    plan = _plan()
    rng = np.random.default_rng(7)
    s = _fleet(plan, 1, seed=7)[0][0]
    rs = ResidentSet()
    rs.adopt(s)
    rs.spill(s)
    U = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
    s.update(U, U)
    assert s.tier == "device" and s.update_rank == 1
    rs.spill(s)
    s.refactor()
    assert s.tier == "device" and s.refactors >= 1


def test_revive_many_stacked_bitwise():
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 4, seed=8)]
    rng = np.random.default_rng(8)
    b = rng.standard_normal((N, 2)).astype(np.float32)
    want = [s.solve(b).clone() for s in fleet]
    rs = ResidentSet()
    rs.adopt(*fleet)
    rs.spill(*fleet)
    assert rs.revive_many(fleet) == 4
    for s, w in zip(fleet, want):
        assert s.tier == "device"
        assert torch.equal(w, s.solve(b))


# --------------------------------------------------------------------- #
# capacity: LRU under count/byte caps, bounded high-water
# --------------------------------------------------------------------- #


def test_lru_eviction_count_cap():
    plan = _plan()
    rs = ResidentSet(max_sessions=2, evict_batch=1)
    fleet = [f[0] for f in _fleet(plan, 5, seed=9)]
    for s in fleet:
        rs.adopt(s)
    st = rs.stats()
    assert st["resident_sessions"] <= 2
    assert st["resident_high_water"] <= 2
    assert st["managed_sessions"] == 5
    # the two most recently adopted survive; the LRU spilled
    assert fleet[0].tier == "host"
    assert fleet[-1].tier == "device"
    b = np.random.default_rng(9).standard_normal((N,)).astype(np.float32)
    fleet[0].solve(b)  # touching a spilled one evicts the coldest resident
    assert fleet[0].tier == "device"
    assert rs.stats()["resident_sessions"] <= 2


def test_byte_cap_bounds_high_water():
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 4, seed=10)]
    per = fleet[0].nbytes
    cap = 2 * per
    rs = ResidentSet(max_bytes=cap, evict_batch=1)
    for s in fleet:
        rs.adopt(s)
    b = np.random.default_rng(10).standard_normal((N,)).astype(np.float32)
    for s in fleet * 2:  # churn through the fleet twice
        s.solve(b)
    st = rs.stats()
    assert st["device_bytes"] <= cap
    assert st["device_bytes_high_water"] <= cap, st
    h = tier.tier_stats()
    assert h["spills_host"] > 0 and h["revives_h2d"] > 0


def test_host_cap_demotes_to_disk(tmp_path):
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 5, seed=11)]
    rs = ResidentSet(max_sessions=1, host_max_sessions=2, disk_dir=str(tmp_path),
                     evict_batch=1)
    for s in fleet:
        rs.adopt(s)
    st = rs.stats()
    assert st["resident_sessions"] <= 1
    assert st["host_sessions"] <= 2
    assert st["disk_sessions"] >= 2
    total = (st["resident_sessions"] + st["host_sessions"] + st["disk_sessions"]
             + st["corrupt_sessions"])
    assert total == st["managed_sessions"] == 5  # conservation


# --------------------------------------------------------------------- #
# stale-drift revival through the factor lane
# --------------------------------------------------------------------- #


def test_revive_refactor_direct():
    plan = _plan()
    s, A64, A, U, Vm = _fleet(plan, 1, seed=12, drift_rank=2)[0]
    rs = ResidentSet(revive_refactor_rank=2)
    rs.adopt(s)
    rs.spill(s)
    b = np.random.default_rng(12).standard_normal((N, 1)).astype(np.float32)
    h0 = tier.tier_stats()
    x = s.solve(b).numpy()
    h1 = tier.tier_stats()
    assert h1["revives_refactor"] - h0.get("revives_refactor", 0) == 1
    assert s.update_rank == 0 and s.refactors == 1  # drift absorbed
    want = np.linalg.solve(A64, b.astype(np.float64))
    assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-4
    # the JAX revival refactors the same drifted base
    jrs = jtier.ResidentSet(revive_refactor_rank=2)
    js = _jax_session(jserve.FactorPlan.create((N, N), jnp.float32, v=V), A, U, Vm)
    jrs.adopt(js)
    jrs.spill(js)
    _close_to_jax(x, js.solve(b))


def test_revive_refactor_coalesces_through_factor_lane():
    plan = _plan()
    fleet = _fleet(plan, 3, seed=13, drift_rank=1)
    rs = ResidentSet(revive_refactor_rank=1)
    # a window wide enough that the three revivals meet in it on a loaded box
    eng = ServeEngine(max_batch_delay=0.25, residency=rs, device=CPU)
    b = np.random.default_rng(13).standard_normal((N, 1)).astype(np.float32)
    try:
        rs.adopt(*[f[0] for f in fleet])
        rs.spill(*[f[0] for f in fleet])
        errs = []

        def touch(s):
            try:
                s.solve(b)
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                errs.append(e)

        ts = [threading.Thread(target=touch, args=(f[0],)) for f in fleet]
        for t in ts:
            t.start()
        for t in ts:
            t.join(T)
        assert not errs, errs
        st = eng.stats()
        # the storm coalesced: fewer factor dispatches than sessions
        assert st["factor_batches"] < 3
        assert st["factor_coalesced_requests"] == 3
        for s, A64, *_ in fleet:
            assert s.update_rank == 0 and s.refactors == 1
            x = s.solve(b).numpy()
            want = np.linalg.solve(A64, b.astype(np.float64))
            assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-4
    finally:
        eng.close(timeout=T)


# --------------------------------------------------------------------- #
# checkpoint / restore
# --------------------------------------------------------------------- #


def test_checkpoint_restore_bitwise(tmp_path):
    plan = _plan(refine=1)
    fleet = _fleet(plan, 2, seed=14) + _fleet(plan, 1, seed=15, drift_rank=2)
    sessions = [f[0] for f in fleet]
    b = np.random.default_rng(14).standard_normal((N, 2)).astype(np.float32)
    want_plain = [s.solve(b).clone() for s in sessions]
    want_checked = [tuple(t.clone() for t in s.solve_checked(b)) for s in sessions]
    counters = [(s.factorizations, s.solves, s.updates, s.refactors) for s in sessions]
    tier.save_fleet(str(tmp_path / "ck"), sessions)
    serve.clear_plans()  # a cold process: the codec carries the plans
    restored = tier.load_fleet(str(tmp_path / "ck"), device=CPU)
    jplan = jserve.FactorPlan.create((N, N), jnp.float32, v=V, refine=1)
    for i, r in enumerate(restored):
        assert (r.factorizations, r.solves, r.updates, r.refactors) == counters[i]
        x = r.solve(b)
        assert torch.equal(want_plain[i], x)
        xc, v = r.solve_checked(b)
        assert torch.equal(want_checked[i][0], xc) and torch.equal(want_checked[i][1], v)
        _s, _A64, A, U, Vm = fleet[i]
        _close_to_jax(x.numpy(), _jax_session(jplan, A, U, Vm).solve(b))
    assert restored[2].update_rank == 2  # drift state survived


def test_load_fleet_places_on_the_card_by_default(tmp_path, monkeypatch):
    """Entry points run on the card unless asked for the CPU: without a
    card, `load_fleet` and `engine.restore`'s default raise, never carry
    on on the CPU."""
    plan = _plan()
    s = _fleet(plan, 1, seed=42)[0][0]
    tier.save_fleet(str(tmp_path / "ck"), [s])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tier.load_fleet(str(tmp_path / "ck"))


def test_engine_checkpoint_drain_barrier_and_lazy_restore(tmp_path):
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 3, seed=16)]
    rs = ResidentSet(max_sessions=2)
    rs.adopt(*fleet)
    eng = ServeEngine(max_batch_delay=0.002, residency=rs, device=CPU)
    b = np.random.default_rng(16).standard_normal((N, 1)).astype(np.float32)
    want = [s.solve(b).numpy().copy() for s in fleet]
    try:
        # the checkpoint races live traffic: the barrier drains first
        futs = [eng.submit(fleet[i % 3], b) for i in range(9)]
        eng.checkpoint(str(tmp_path / "ck"))
        for f in futs:
            f.result(T)
        # restored through a residency: host-tier, faulting in on touch
        rs2 = ResidentSet(max_sessions=2)
        eng2 = ServeEngine(max_batch_delay=0.0, residency=rs2, device=CPU)
        try:
            restored = eng2.restore(str(tmp_path / "ck"))
            assert all(r.tier == "host" for r in restored)
            for i, r in enumerate(restored):
                x = eng2.solve(r, b, timeout=T)
                np.testing.assert_array_equal(want[i], x)
            assert rs2.stats()["resident_sessions"] <= 2
        finally:
            eng2.close(timeout=T)
    finally:
        eng.close(timeout=T)


def test_mesh_plan_fleet_record_is_refused_naming_the_mesh_lane(tmp_path):
    """The JAX package's mesh plans ride its fleet codec, and so do the
    port's. Its 8-device CPU mesh names device ids 0..7; torch has one CPU
    device, so restoring that record on the CPU raises MeshPlanUnsupported
    naming the ids it lacks (the mesh lane's cross-host residue), while a
    port mesh session's leaves re-scatter onto its own mesh, bitwise."""
    from conflux_tpu.batched import batch_mesh

    from conflux_tpu_torch.batched import Sharded
    from conflux_tpu_torch.batched import batch_mesh as tbatch_mesh
    from conflux_tpu_torch.resilience import MeshPlanUnsupported

    jserve.clear_plans()
    jplan = jserve.FactorPlan.create((8, N, N), jnp.float32, v=V, mesh=batch_mesh())
    rng = np.random.default_rng(17)
    A = np.stack([_mk(rng) for _ in range(8)])
    js = jplan.factor(jnp.asarray(A))
    jtier.save_fleet(str(tmp_path / "ck"), [js], names=["m"])
    with pytest.raises(MeshPlanUnsupported, match="device ids") as ei:
        tier.load_fleet(str(tmp_path / "ck"), device=CPU)
    assert ei.value.surface == "plan_codec"

    serve.clear_plans()
    tplan = serve.FactorPlan.create((8, N, N), torch.float32, v=V,
                                    mesh=tbatch_mesh(["cpu"] * 2))
    s = tplan.factor(A, device=CPU)
    host = {k: v.clone() for k, v in tier._device_get([{"A0": s._A0}])[0].items()}
    assert torch.equal(host["A0"], torch.from_numpy(A))
    back = tier._leaves_to_device(s, host)
    assert isinstance(back["A0"], Sharded) and len(back["A0"].shards) == 2
    assert all(torch.equal(a, b) for a, b in zip(back["A0"].shards, s._A0.shards))


# --------------------------------------------------------------------- #
# fault injection: blast radius is one session
# --------------------------------------------------------------------- #


def test_spill_fault_leaves_session_resident():
    plan = _plan()
    s = _fleet(plan, 1, seed=18)[0][0]
    rs = ResidentSet(fault_plan=FaultPlan([FaultSpec("spill", "crash", count=1)]))
    rs.adopt(s)
    h0 = tier.tier_stats()
    assert rs.spill(s) == 0  # the crash aborted the spill
    assert s.tier == "device"  # fail-safe: still resident
    assert tier.tier_stats()["spill_faults"] - h0.get("spill_faults", 0) == 1
    s.solve(np.random.default_rng(18).standard_normal((N,)).astype(np.float32))
    assert rs.spill(s) == 1  # budget spent: the next spill works


def test_revive_fault_structured_and_record_intact():
    plan = _plan()
    s = _fleet(plan, 1, seed=19)[0][0]
    b = np.random.default_rng(19).standard_normal((N, 1)).astype(np.float32)
    x0 = s.solve(b).clone()
    rs = ResidentSet(fault_plan=FaultPlan([FaultSpec("revive", "crash", count=1)]))
    rs.adopt(s)
    rs.spill(s)
    with pytest.raises(InjectedFault):
        s.solve(b)
    assert s.tier == "host"  # fully spilled, record intact
    assert torch.equal(x0, s.solve(b))  # the retry revives


def test_revive_fault_fails_only_owner_in_engine():
    plan = _plan()
    sick, ok = (f[0] for f in _fleet(plan, 2, seed=20))
    b = np.random.default_rng(20).standard_normal((N, 1)).astype(np.float32)
    x_ok = ok.solve(b).numpy().copy()
    rs = ResidentSet(fault_plan=FaultPlan([FaultSpec("revive", "crash", count=2)]))
    eng = ServeEngine(max_batch_delay=0.01, residency=rs, device=CPU)
    try:
        rs.adopt(sick, ok)
        rs.spill(sick)
        f_sick = eng.submit(sick, b)
        f_ok = eng.submit(ok, b)
        np.testing.assert_array_equal(x_ok, f_ok.result(T))
        with pytest.raises(InjectedFault):
            f_sick.result(T)
        assert sick.tier == "host"
    finally:
        eng.close(timeout=T)


def test_disk_corruption_restorecorrupt_only_owner(tmp_path):
    plan = _plan()
    bad, good = (f[0] for f in _fleet(plan, 2, seed=21))
    b = np.random.default_rng(21).standard_normal((N, 1)).astype(np.float32)
    x_good = good.solve(b).clone()
    rs = ResidentSet(disk_dir=str(tmp_path),
                     fault_plan=FaultPlan([FaultSpec("disk_write", "nan", count=1)]))
    rs.adopt(bad, good)
    rs.spill(bad, good)
    rs.demote(bad)   # this write corrupts (the injected 'nan')
    rs.demote(good)  # budget spent: a clean record
    with pytest.raises(RestoreCorrupt) as ei:
        bad.solve(b)
    assert "expected_crc" in ei.value.evidence
    assert bad.tier == "corrupt"
    assert tier.tier_stats()["restore_corrupt"] >= 1
    with pytest.raises(RestoreCorrupt):  # pinned: every touch re-raises
        bad.solve(b)
    assert torch.equal(x_good, good.solve(b))  # the sibling, bitwise
    st = rs.stats()
    assert st["corrupt_sessions"] == 1
    assert (st["resident_sessions"] + st["host_sessions"] + st["disk_sessions"]
            + st["corrupt_sessions"]) == 2


def test_disk_read_fault_then_recovers(tmp_path):
    plan = _plan()
    s = _fleet(plan, 1, seed=22)[0][0]
    b = np.random.default_rng(22).standard_normal((N, 1)).astype(np.float32)
    x0 = s.solve(b).clone()
    rs = ResidentSet(disk_dir=str(tmp_path),
                     fault_plan=FaultPlan([FaultSpec("disk_read", "crash", count=1)]))
    rs.adopt(s)
    rs.spill(s)
    rs.demote(s)
    with pytest.raises(InjectedFault):
        s.solve(b)
    assert s.tier == "disk"  # record intact on disk
    assert torch.equal(x0, s.solve(b))


# --------------------------------------------------------------------- #
# deadline x revival + backpressure
# --------------------------------------------------------------------- #


def test_deadline_expiring_during_fault_in_releases_slot():
    plan = _plan()
    s = _fleet(plan, 1, seed=23)[0][0]
    b = np.random.default_rng(23).standard_normal((N, 1)).astype(np.float32)
    x0 = s.solve(b).numpy().copy()
    rs = ResidentSet(max_concurrent_revives=1)
    eng = ServeEngine(max_batch_delay=0.0, residency=rs, device=CPU)
    try:
        rs.adopt(s)
        rs.spill(s)
        assert rs._revive_sem.acquire(timeout=1)  # saturate the lane
        try:
            fut = eng.submit(s, b, deadline=0.1)
            with pytest.raises((SessionSpilled, DeadlineExceeded)):
                fut.result(30)
            # the admission slot is released and the session fully spilled
            assert eng.stats()["pending"] == 0
            assert s.tier == "host" and s._factors is None
            assert tier.tier_stats()["revive_rejects"] >= 1
        finally:
            rs._revive_sem.release()
        np.testing.assert_array_equal(x0, eng.solve(s, b, timeout=T))
    finally:
        eng.close(timeout=T)


def test_direct_fault_in_timeout_structured():
    plan = _plan()
    s = _fleet(plan, 1, seed=24)[0][0]
    rs = ResidentSet(max_concurrent_revives=1)
    rs.adopt(s)
    rs.spill(s)
    assert rs._revive_sem.acquire(timeout=1)
    try:
        with pytest.raises(SessionSpilled):
            rs.fault_in(s, timeout=0.05)
        assert s.tier == "host"
    finally:
        rs._revive_sem.release()
    rs.fault_in(s)
    assert s.tier == "device"


# --------------------------------------------------------------------- #
# barrier x revival, concurrent checkpoints and adopts, corrupt-record
# accounting, revive_many partial progress
# --------------------------------------------------------------------- #


def test_factor_lane_sheds_at_drain_barrier():
    """A factor submission during a checkpoint drain sheds instead of
    waiting (a stale-drift revival holds its session lock while it
    submits, and the snapshot needs that lock)."""
    plan = _plan()
    A = _mk(np.random.default_rng(32))
    eng = ServeEngine(max_batch_delay=0.0, device=CPU)
    try:
        with eng._lock:
            eng._draining = True
        try:
            t0 = time.perf_counter()
            with pytest.raises(EngineSaturated):
                eng.submit_factor(plan, A)
            assert time.perf_counter() - t0 < 5.0  # shed, not waited
        finally:
            with eng._lock:
                eng._draining = False
                eng._not_full.notify_all()
        s = eng.factor(plan, A, timeout=T)
        assert s.solve(np.zeros(N, np.float32)).shape == (N,)
    finally:
        eng.close(timeout=T)


def test_checkpoint_vs_stale_revival_no_deadlock(tmp_path, monkeypatch):
    plan = _plan()
    fleet = _fleet(plan, 2, seed=33, drift_rank=1)
    rs = ResidentSet(revive_refactor_rank=1)
    eng = ServeEngine(max_batch_delay=0.0, residency=rs, device=CPU)
    b = np.random.default_rng(33).standard_normal((N, 1)).astype(np.float32)
    in_barrier = threading.Event()
    client_done = threading.Event()
    real_save = tier.save_fleet

    def slow_save(path, sessions, names=None, **kw):
        in_barrier.set()
        client_done.wait(30)  # hold the barrier across the revival
        return real_save(path, sessions, names, **kw)

    monkeypatch.setattr(tier, "save_fleet", slow_save)
    try:
        rs.adopt(*[f[0] for f in fleet])
        rs.spill(*[f[0] for f in fleet])
        errs, xs = [], []

        def ckpt():
            try:
                eng.checkpoint(str(tmp_path / "ck"))
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                errs.append(e)

        def touch():
            try:
                xs.append(fleet[0][0].solve(b).numpy())
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                errs.append(e)

        ct = threading.Thread(target=ckpt, daemon=True)
        ct.start()
        assert in_barrier.wait(30)
        tt = threading.Thread(target=touch, daemon=True)
        tt.start()
        tt.join(30)
        revived = not tt.is_alive()
        client_done.set()
        ct.join(T)
        assert revived, "revival deadlocked against the drain barrier"
        assert not ct.is_alive(), "checkpoint deadlocked"
        assert not errs, errs
        want = np.linalg.solve(fleet[0][1], b.astype(np.float64))
        assert np.linalg.norm(xs[0] - want) / np.linalg.norm(want) < 1e-4
        assert fleet[0][0].refactors == 1  # the direct fallback ran
    finally:
        client_done.set()
        eng.close(timeout=T)


def test_concurrent_checkpoints_serialize(tmp_path, monkeypatch):
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 2, seed=34)]
    rs = ResidentSet()
    eng = ServeEngine(max_batch_delay=0.0, residency=rs, device=CPU)
    b = np.random.default_rng(34).standard_normal((N, 1)).astype(np.float32)
    real_save = tier.save_fleet
    alock = threading.Lock()
    active, peak = [0], [0]

    def counted_save(path, sessions, names=None, **kw):
        with alock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            time.sleep(0.05)
            return real_save(path, sessions, names, **kw)
        finally:
            with alock:
                active[0] -= 1

    monkeypatch.setattr(tier, "save_fleet", counted_save)
    try:
        rs.adopt(*fleet)
        want = [s.solve(b).clone() for s in fleet]
        errs = []

        def ck(d):
            try:
                eng.checkpoint(str(d))
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                errs.append(e)

        ts = [threading.Thread(target=ck, args=(tmp_path / f"ck{i}",), daemon=True)
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(T)
        assert not any(t.is_alive() for t in ts)
        assert not errs, errs
        assert peak[0] == 1, "snapshots overlapped under one barrier"
        with eng._lock:
            assert not eng._draining  # the barrier fully cleared
        np.testing.assert_array_equal(want[0].numpy(), eng.solve(fleet[0], b, timeout=T))
        for i in range(2):
            restored = tier.load_fleet(str(tmp_path / f"ck{i}"), device=CPU)
            for j, r in enumerate(restored):
                assert torch.equal(want[j], r.solve(b))
    finally:
        eng.close(timeout=T)


def test_concurrent_adopt_touch_churn_consistent():
    """Concurrent re-adopts and touches under count pressure: liveness and
    resident <-> record consistency."""
    plan = _plan()
    fleet = _fleet(plan, 3, seed=35)
    rs = ResidentSet(max_sessions=1, evict_batch=1)
    rs.adopt(*[f[0] for f in fleet])
    b = np.random.default_rng(35).standard_normal((N,)).astype(np.float32)
    stop = time.perf_counter() + 1.0
    errs = []

    def churn(s):
        try:
            while time.perf_counter() < stop:
                rs.adopt(s)
                s.solve(b)
        except Exception as e:  # noqa: BLE001 - recorded, asserted
            errs.append(e)

    ts = [threading.Thread(target=churn, args=(f[0],), daemon=True) for f in fleet]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts), "adopt churn deadlocked"
    assert not errs, errs
    st = rs.stats()
    assert (st["resident_sessions"] + st["host_sessions"] + st["disk_sessions"]
            + st["corrupt_sessions"]) == 3
    with rs._lock:
        states = {id(f[0]): rs._state.get(id(f[0])) for f in fleet}
    for s, *_ in fleet:
        if states[id(s)] == "resident":
            assert s._spill is None  # never resident with a record
        elif states[id(s)] in ("host", "disk"):
            assert s._spill is not None
    for s, A64, *_ in fleet:
        x = s.solve(b).numpy()
        want = np.linalg.solve(A64, b.astype(np.float64))
        assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-4


def test_corrupt_record_retires_gauges_and_disk_space(tmp_path):
    plan = _plan()
    s = _fleet(plan, 1, seed=36)[0][0]
    b = np.random.default_rng(36).standard_normal((N, 1)).astype(np.float32)
    rs = ResidentSet(disk_dir=str(tmp_path),
                     fault_plan=FaultPlan([FaultSpec("disk_write", "nan", count=1)]))
    rs.adopt(s)
    rs.spill(s)
    rs.demote(s)
    rec_path = s._spill.path
    assert rs.stats()["disk_bytes"] > 0
    with pytest.raises(RestoreCorrupt) as e1:
        s.solve(b)
    assert rs.stats()["disk_bytes"] == 0
    assert not os.path.exists(rec_path)
    with pytest.raises(RestoreCorrupt) as e2:
        s.solve(b)
    assert e2.value is not e1.value
    assert e2.value.__cause__ is e1.value
    assert e2.value.evidence == e1.value.evidence


def test_fault_in_reports_noop_and_revive_many_counts_real_work():
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 3, seed=37)]
    rs = ResidentSet()
    rs.adopt(*fleet)
    assert rs.fault_in(fleet[0]) is False  # resident: a no-op
    rs.spill(*fleet)
    assert rs.fault_in(fleet[0]) is True
    assert rs.fault_in(fleet[0]) is False  # already back
    assert rs.revive_many(fleet) == 2  # only the two still spilled
    assert all(s.tier == "device" for s in fleet)


def test_revive_many_respects_device_caps():
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 6, seed=39)]
    b = np.random.default_rng(39).standard_normal((N, 1)).astype(np.float32)
    want = [s.solve(b).clone() for s in fleet]
    rs = ResidentSet(max_sessions=3)
    rs.adopt(*fleet)
    rs.spill(*fleet)
    assert rs.revive_many(fleet) == 6
    st = rs.stats()
    assert st["resident_sessions"] <= 3, st
    assert st["resident_high_water"] <= 3, st
    for s, w in zip(fleet, want):
        assert torch.equal(w, s.solve(b))
    assert rs.stats()["resident_high_water"] <= 3


def test_revive_many_partial_progress_under_backpressure():
    plan = _plan()
    fleet = [f[0] for f in _fleet(plan, 2, seed=38, drift_rank=1)]  # the rest path
    rs = ResidentSet(max_concurrent_revives=1)
    rs.adopt(*fleet)
    rs.spill(*fleet)
    h0 = tier.tier_stats()
    assert rs._revive_sem.acquire(timeout=1)  # saturate the lane
    try:
        assert rs.revive_many(fleet, timeout=0.05) == 0
        assert all(s.tier == "host" for s in fleet)
        assert tier.tier_stats()["revive_rejects"] - h0.get("revive_rejects", 0) >= 2
    finally:
        rs._revive_sem.release()
    assert rs.revive_many(fleet) == 2
    assert all(s.tier == "device" for s in fleet)


# --------------------------------------------------------------------- #
# observability
# --------------------------------------------------------------------- #


def test_tier_counters_in_serve_stats(tmp_path):
    plan = _plan()
    s = _fleet(plan, 1, seed=25)[0][0]
    b = np.random.default_rng(25).standard_normal((N, 1)).astype(np.float32)
    rs = ResidentSet(disk_dir=str(tmp_path))
    rs.adopt(s)
    rs.spill(s)
    s.solve(b)
    st = profiler.serve_stats()["tier"]
    assert st["spills_host"] >= 1
    assert st["revives_h2d"] >= 1
    assert st["fault_in_p50_ms"] > 0
    assert st["managed_sessions"] >= 1
    assert st["device_bytes_high_water"] > 0
    # clear() resets the counters; the manager's gauges survive
    profiler.clear()
    st2 = profiler.serve_stats()["tier"]
    assert st2["spills_host"] == 0 and st2["revives_h2d"] == 0
    assert st2["managed_sessions"] >= 1
    # windows see the tier: counters differenced, gauges as read
    w = profiler.StatsWindow()
    rs.spill(s)
    d = w.delta()
    assert d["tier"]["spills_host"] == 1 and d["tier_gauges"]["host_sessions"] >= 1


# --------------------------------------------------------------------- #
# gang slots across spill and revive (tests/test_gang.py's case)
# --------------------------------------------------------------------- #


def test_gang_slot_reuse_after_spill_and_revive_bitwise():
    serve.clear_plans()
    plan = _plan()
    rng = np.random.default_rng(51)
    A = (rng.standard_normal((4, N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
    fleet = [plan.factor(A[i], device=CPU) for i in range(4)]
    rng = np.random.default_rng(52)
    bs = [rng.standard_normal((N, 1)).astype(np.float32) for _ in range(4)]
    rs = ResidentSet(max_sessions=16)
    eng = ServeEngine(max_batch_delay=0.05, stack_sessions=True, max_stack=4, residency=rs,
                      device=CPU)
    try:
        rs.adopt(*fleet)
        futs = [eng.submit(s, b) for s, b in zip(fleet, bs)]
        before = [f.result(T) for f in futs]
        g = eng.lanes[0]._gangs[id(plan)]
        assert g.members == 4 and g.cap == 4
        slot1 = fleet[1]._gang_slot
        assert rs.spill(fleet[1]) == 1
        assert fleet[1].tier == "host"
        assert fleet[1]._gang is None, "spill must free the gang slot"
        assert g.members == 3
        # a new session reuses the freed slot: capacity does not grow
        extra = plan.factor(A[0], device=CPU)
        for f in [eng.submit(s, bs[0]) for s in (fleet[0], fleet[2], extra)]:
            f.result(T)
        assert g.cap == 4
        assert extra._gang_slot == slot1, "freed slot not reused"
        rs.adopt(extra)
        assert rs.spill(extra) == 1
        assert extra._gang is None and g.members == 3
        # the grouped revival lands straight back in the slot
        assert rs.revive_many([fleet[1]]) == 1
        assert fleet[1].tier == "device"
        assert fleet[1]._gang is g and fleet[1]._gang_slot == slot1, \
            "grouped revival did not land straight into the gang slot"
        after = [f.result(T) for f in [eng.submit(s, b) for s, b in zip(fleet, bs)]]
        np.testing.assert_array_equal(after[1], before[1])
    finally:
        eng.close(timeout=T)


# --------------------------------------------------------------------- #
# tests/test_scale.py's tier cases: the LRU heaps vs the sort oracle
# --------------------------------------------------------------------- #


class _Stub:
    """Metadata-only session: `_pick_victims` only marks victims."""

    __slots__ = ("_lock", "_residency", "_tier_stamp", "_spill", "_ckpt_ver", "nbytes",
                 "device")

    def __init__(self, nbytes, device=None):
        self._lock = threading.RLock()
        self._residency = None
        self._tier_stamp = 0
        self._spill = None
        self._ckpt_ver = 0
        self.nbytes = nbytes
        self.device = device


def _pick_both(rs, incoming_bytes, incoming_count):
    """One victim pick per impl on the same tier state: pick, record,
    revert. Returns (sort_ids, heap_ids)."""
    out = {}
    for impl in ("sort", "heap"):
        rs._lru_impl = impl
        victims = rs._pick_victims(incoming_bytes, incoming_count)
        out[impl] = frozenset(id(s) for s in victims)
        with rs._lock:
            for s in victims:
                rs._set_state(id(s), s, "resident")
    return out["sort"], out["heap"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_victim_sets_match_sort_oracle_randomized(seed):
    rng = np.random.default_rng(seed)
    F = 160
    rs = ResidentSet(evict_batch=int(rng.integers(1, 4)))
    stubs = [_Stub(int(rng.integers(1_000, 50_000))) for _ in range(F)]
    rs.adopt(*stubs)
    for wave in range(30):
        for i in rng.choice(F, size=40):
            stubs[i]._tier_stamp = rs._tick()
        rs.max_sessions = int(rng.integers(F - 12, F + 4))
        rs.max_bytes = None if rng.random() < 0.5 else int(rng.integers(1, F) * 25_000)
        sort_ids, heap_ids = _pick_both(rs, int(rng.integers(0, 100_000)),
                                        int(rng.integers(0, 4)))
        assert sort_ids == heap_ids, f"wave {wave}: victim sets differ"


def test_victim_sets_match_with_per_device_caps():
    rng = np.random.default_rng(7)
    devs = [torch.device("cuda", i) for i in range(3)]  # descriptors only
    rs = ResidentSet(evict_batch=1)
    stubs = [_Stub(10_000, device=devs[i % 3]) for i in range(60)]
    rs.adopt(*stubs)  # cap set after adopt: stubs mark, never spill
    for wave in range(20):
        for i in rng.choice(60, size=15):
            stubs[i]._tier_stamp = rs._tick()
        rs.max_sessions_per_device = int(rng.integers(5, 22))
        sort_ids, heap_ids = _pick_both(rs, 0, 0)
        assert sort_ids == heap_ids, f"wave {wave}: victim sets differ"
        with rs._lock:
            assert all(d[0] >= 0 for d in rs._dev_res.values())
            assert set(rs._dev_res) <= {("cuda", 0), ("cuda", 1), ("cuda", 2)}


def test_spill_lru_uses_heap_order():
    plan = _plan()
    sessions = [f[0] for f in _fleet(plan, 5, seed=3)]
    rs = ResidentSet()
    rs.adopt(*sessions)
    for i in (2, 4):  # freshen 2 and 4: the spill takes 0, 1, 3
        with sessions[i]._lock:
            sessions[i]._tier_stamp = rs._tick()
    assert rs.spill_lru(3) == 3
    st = [rs._state[id(s)] for s in sessions]
    assert st == ["host", "host", "resident", "host", "resident"]


# --------------------------------------------------------------------- #
# the checkpoint dirty clock and delta generations
# --------------------------------------------------------------------- #


def test_solves_stay_clean_mutations_dirty():
    plan = _plan()
    s = _fleet(plan, 1, seed=5)[0][0]
    rng = np.random.default_rng(5)
    b = rng.standard_normal((N, 1)).astype(np.float32)
    v0 = s._ckpt_ver
    s.solve(b)
    s.solve_checked(b)
    assert s._ckpt_ver == v0  # solve-only traffic leaves it untouched
    u = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
    w = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
    s.update(u, w)
    assert s._ckpt_ver > v0
    v1 = s._ckpt_ver
    ResidentSet().adopt(s)
    assert s._ckpt_ver > v1  # so is the manager identity


def _counters():
    st = tier.tier_stats()
    return st.get("checkpoint_records_written", 0), st.get("checkpoint_records_carried", 0)


def _named_fleet(plan, count, seed):
    sessions = [f[0] for f in _fleet(plan, count, seed=seed)]
    for i, s in enumerate(sessions):
        s.sid = f"sess{i}"  # records carry by (sid, ver) identity
    return sessions


def test_delta_generation_skips_clean_sessions(tmp_path):
    plan = _plan()
    sessions = _named_fleet(plan, 3, 6)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((N, 2)).astype(np.float32)
    for s in sessions:
        s.solve(b)
    p0, p1 = str(tmp_path / "g0"), str(tmp_path / "g1")
    tier.save_fleet(p0, sessions, gen=0)
    want = [s.solve(b).clone() for s in sessions]  # stays clean
    u = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
    w = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
    sessions[1].update(u, w)
    want[1] = sessions[1].solve(b).clone()
    w0, c0 = _counters()
    tier.save_fleet(p1, sessions, base=p0, gen=1, full=False)
    w1, c1 = _counters()
    assert w1 - w0 == 1 and c1 - c0 == 2  # only the dirty one written
    with open(os.path.join(p1, "fleet.json")) as f:
        doc = json.load(f)
    assert doc["format"] == 2 and doc["carried"] == 2
    dirs = {e["sid"]: e["dir"] for e in doc["sessions"]}
    gens = {e["sid"]: e["gen"] for e in doc["sessions"]}
    assert dirs["sess0"].startswith("..")  # carried: a pointer
    assert not dirs["sess1"].startswith("..")  # dirty: fresh bytes
    assert gens["sess1"] == 1 and gens["sess0"] == 0
    serve.clear_plans()
    for i, r in enumerate(tier.load_fleet(p1, device=CPU)):
        assert torch.equal(want[i], r.solve(b))


def test_delta_chain_rebases_and_compaction_localizes(tmp_path):
    plan = _plan()
    sessions = _named_fleet(plan, 3, 8)
    rng = np.random.default_rng(8)
    b = rng.standard_normal((N, 1)).astype(np.float32)
    paths = [str(tmp_path / f"g{i}") for i in range(4)]
    tier.save_fleet(paths[0], sessions, gen=0)

    def drift(i):
        u = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
        w = (0.01 * rng.standard_normal((N, 1))).astype(np.float32)
        sessions[i].update(u, w)

    drift(0)
    tier.save_fleet(paths[1], sessions, base=paths[0], gen=1, full=False)
    drift(1)
    tier.save_fleet(paths[2], sessions, base=paths[1], gen=2, full=False)
    with open(os.path.join(paths[2], "fleet.json")) as f:
        doc2 = json.load(f)
    for e in doc2["sessions"]:
        d = os.path.normpath(e["dir"])
        if d.startswith(".."):  # re-based: one hop, never a chain
            assert d.count("..") == 1
            assert os.path.isdir(os.path.normpath(os.path.join(paths[2], d)))
    assert {e["sid"]: e["gen"] for e in doc2["sessions"]}["sess2"] == 0
    tier.save_fleet(paths[3], sessions, base=paths[2], gen=3, full=True)
    with open(os.path.join(paths[3], "fleet.json")) as f:
        doc3 = json.load(f)
    assert all(not os.path.normpath(e["dir"]).startswith("..") for e in doc3["sessions"])
    assert {e["sid"]: e["gen"] for e in doc3["sessions"]}["sess2"] == 0
    want = [s.solve(b).clone() for s in sessions]
    for p in (paths[2], paths[3]):
        serve.clear_plans()
        for i, r in enumerate(tier.load_fleet(p, device=CPU)):
            assert torch.equal(want[i], r.solve(b)), p


def test_missing_base_degrades_to_full_write(tmp_path):
    plan = _plan()
    sessions = [f[0] for f in _fleet(plan, 2, seed=9)]
    p0, p1 = str(tmp_path / "g0"), str(tmp_path / "g1")
    tier.save_fleet(p0, sessions, gen=0)
    shutil.rmtree(p0)  # the base vanished (pruned, or a lost disk)
    w0, _ = _counters()
    tier.save_fleet(p1, sessions, base=p0, gen=1, full=False)
    w1, _ = _counters()
    assert w1 - w0 == 2  # every record freshly written, no broken link
    b = np.random.default_rng(9).standard_normal((N, 1)).astype(np.float32)
    want = [s.solve(b).clone() for s in sessions]
    serve.clear_plans()
    for i, r in enumerate(tier.load_fleet(p1, device=CPU)):
        assert torch.equal(want[i], r.solve(b))


def _prune(ckpt_dir: str, keep: int) -> None:
    """The reference fabric's reference-aware prune (fabric.py `_prune`):
    keep the newest `keep` generations plus every generation a kept
    fleet.json's carried records point into."""
    gens = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("fleet-"))
    kept = set(gens[-keep:])
    frontier = sorted(kept)
    while frontier:
        d = frontier.pop()
        with open(os.path.join(ckpt_dir, d, "fleet.json")) as f:
            entries = json.load(f)["sessions"]
        for e in entries:
            parts = os.path.normpath(e.get("dir", "")).split(os.sep)
            if len(parts) >= 2 and parts[0] == ".." and parts[1].startswith("fleet-") \
                    and parts[1] not in kept:
                kept.add(parts[1])
                frontier.append(parts[1])
    for d in gens:
        if d not in kept:
            shutil.rmtree(os.path.join(ckpt_dir, d))


def test_prune_keeps_delta_referenced_generations(tmp_path):
    """A gen0-full / delta chain of the port's records, pruned to the
    newest 2 generations: the kept deltas pin gen0 (their carried records
    live there), the middle deltas go, and every kept generation restores
    bitwise; the JAX package's chain under the same schedule keeps the same
    generations."""
    plan = _plan()
    sessions = _named_fleet(plan, 3, 11)
    jplan = jserve.FactorPlan.create((N, N), jnp.float32, v=V)
    rng = np.random.default_rng(11)
    jsessions = []
    for i in range(3):
        js = jplan.factor(jnp.asarray(_mk(np.random.default_rng(100 + i))))
        js.sid = f"sess{i}"
        jsessions.append(js)
    b = rng.standard_normal((N, 1)).astype(np.float32)
    kept = {}
    for mod, fleet, root in ((tier, sessions, tmp_path / "port"),
                             (jtier, jsessions, tmp_path / "jax")):
        os.makedirs(root)
        base = None
        for g in range(5):  # gen0 full, gens 1.. deltas touching session 0
            if g:
                u = (0.01 * np.random.default_rng(g).standard_normal((N, 1))).astype(np.float32)
                fleet[0].update(u, u)
            dest = str(root / f"fleet-{g:06d}")
            mod.save_fleet(dest, fleet, [s.sid for s in fleet], base=base, gen=g,
                           full=base is None)
            base = dest
        _prune(str(root), keep=2)
        kept[mod] = sorted(os.listdir(root))
    assert kept[tier] == kept[jtier] == ["fleet-000000", "fleet-000003", "fleet-000004"]
    want = [s.solve(b).clone() for s in sessions]
    for g in ("fleet-000003", "fleet-000004"):
        serve.clear_plans()
        restored = tier.load_fleet(str(tmp_path / "port" / g), device=CPU)
        if g == "fleet-000004":
            for i, r in enumerate(restored):
                assert torch.equal(want[i], r.solve(b))


def test_ckpt_roundtrip_script_on_the_cpu(tmp_path, capsys):
    """scripts/torch_ckpt_roundtrip.py at a small size: the save writes a
    full generation and a delta (2 written, 6 carried), the restore
    reproduces both bitwise (here in one process; on the card in two)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_ckpt_roundtrip.py")
    spec = importlib.util.spec_from_file_location("torch_ckpt_roundtrip", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = str(tmp_path / "ck")
    argv = ["-N", "32", "-v", "16", "--platform", "cpu", d]
    assert mod.main(["--save", *argv]) == 0
    serve.clear_plans()
    assert mod.main(["--restore", *argv]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines[0]["written"] == 2 and lines[0]["carried"] == 6
    assert lines[1]["ok"] and lines[1]["divergences"] == {"0": 0, "1": 0}
