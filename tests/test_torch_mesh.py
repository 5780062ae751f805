"""The port's process grid (`conflux_tpu_torch.parallel.mesh`) on the CPU:
the collectives of a threaded gloo world against their JAX meanings
(sums and maxes over axis subsets, `all_gather` in axis-coordinate
order, `ppermute`'s zero fill, the butterfly at odd Px with the real CALU
reducer), the transports' refusals, `run_threaded`'s bounded failures, a
two-process world through `initialize_multihost` (gloo, env://), and the
host-side pieces this slice copied from the JAX package (block-cyclic
geometry, the scatter half of `io.py`, the empty `autotune` table)
against it. The twins of tests/test_multihost.py's other cases carry its
`slow` mark."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conflux_tpu import geometry as jgeometry
from conflux_tpu import io as jio
from conflux_tpu_torch import autotune
from conflux_tpu_torch import io as tio
from conflux_tpu_torch.geometry import (
    CholeskyGeometry,
    Grid3,
    LUGeometry,
    check_shards,
    local_row_indices,
    ragged_segments,
    row_global,
    row_local,
    row_owner,
    tile_global,
    tile_local,
    tile_owner,
)
from conflux_tpu_torch.ops import blas
from conflux_tpu_torch.parallel.mesh import (
    butterfly_allreduce,
    distribute_shards,
    gather_shards,
    make_mesh,
    run_threaded,
)

TIMEOUT = 60.0
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: these small problems gain nothing from
    more, and the suite runs beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_collectives_over_axis_subsets():
    grid = Grid3(3, 2, 2)

    def fn(m):
        t = torch.full((2,), float(m.rank))
        s_yz = m.psum(t.clone(), ("y", "z"))
        s_x = m.psum(t.clone(), "x")
        mx = m.pmax(t.clone(), ("x", "y", "z"))
        g = m.all_gather(torch.tensor([m.x, m.y, m.z]), "x")
        c = m.replicate(torch.full((2,), complex(m.rank, -m.rank)), ("x", "y", "z"))
        return s_yz.tolist(), s_x.tolist(), mx.tolist(), g.tolist(), c.tolist(), m.stats

    for r, (s_yz, s_x, mx, g, c, stats) in enumerate(run_threaded(grid, fn, timeout=TIMEOUT)):
        x, y, z = r // 4, (r // 2) % 2, r % 2
        assert s_yz == [float(sum(x * 4 + k for k in range(4)))] * 2
        assert s_x == [float(sum(i * 4 + y * 2 + z for i in range(3)))] * 2
        assert mx == [11.0, 11.0]
        assert g == [[i, y, z] for i in range(3)]  # axis-coordinate order
        assert c == [complex(11, 0)] * 2  # max of the parts: real 11, imaginary -0
        assert stats["collectives"] == 5 and stats["staged_bytes"] == 0


def test_ppermute_zero_fill_and_world_size_one():
    def fn(m):
        t = torch.tensor([float(m.x + 1)])
        shifted = m.ppermute(t, "x", [(0, 1), (1, 2)])  # x=0 receives nothing
        swapped = m.ppermute(t, "x", [(0, 2), (2, 0), (1, 1)])
        return shifted.item(), swapped.item()

    assert run_threaded(Grid3(3, 1, 1), fn, timeout=TIMEOUT) == [(0.0, 3.0), (1.0, 2.0),
                                                                 (2.0, 1.0)]
    one = make_mesh(Grid3(1, 1, 1), device="cpu")
    t = torch.arange(3.0)
    assert one.psum(t, ("x", "y", "z")) is t and torch.equal(t, torch.arange(3.0))
    assert torch.equal(one.all_gather(t, "x"), t[None])
    assert torch.equal(one.ppermute(t, "x", [(0, 0)]), t)
    assert torch.equal(one.ppermute(t, "x", []), torch.zeros(3))
    with pytest.raises(ValueError, match="not a permutation"):
        one.ppermute(t, "x", [(0, 0), (0, 1)])
    with pytest.raises(ValueError, match="axes"):
        one.psum(t, "w")


@pytest.mark.parametrize("Px", [3, 5])
def test_butterfly_at_odd_px_with_the_real_reducer(Px):
    """The CALU reducer over ppermute rounds at non-power-of-two Px: every
    rank ends with the same winners (the lower coordinate's stack first),
    which are rows of the nominees; the reducer runs on the zero fill of
    an off-subcube lane without raising (finite garbage, discarded)."""
    v = 8
    rng = np.random.default_rng(Px)
    noms = rng.standard_normal((Px, v, v))
    ids = np.arange(Px * v).reshape(Px, v)

    def reduce_pair(top, bot):
        stack = torch.cat([top[0], bot[0]])
        sid = torch.cat([top[1], bot[1]])
        lu00, wid = blas.tournament_winners(stack, use_pallas=False)
        return stack[wid], sid[wid], lu00

    z = torch.zeros(v, v, dtype=torch.float64)
    out = reduce_pair((z, torch.zeros(v, dtype=torch.int64), z),
                      (z, torch.zeros(v, dtype=torch.int64), z))
    assert all(torch.isfinite(o.double()).all() for o in out)

    def fn(m):
        vals = (torch.from_numpy(noms[m.x].copy()), torch.from_numpy(ids[m.x].copy()),
                torch.zeros(v, v, dtype=torch.float64))
        return [t.numpy() for t in butterfly_allreduce(m, vals, Px, "x", reduce_pair)]

    res = run_threaded(Grid3(Px, 1, 1), fn, timeout=TIMEOUT)
    for r in res[1:]:
        for a, b in zip(r, res[0]):
            np.testing.assert_array_equal(a, b)
    win, wid, lu00 = res[0]
    np.testing.assert_array_equal(win, noms.reshape(-1, v)[wid])
    assert len(set(wid.tolist())) == v
    L = np.tril(lu00, -1) + np.eye(v)
    np.testing.assert_allclose(L @ np.triu(lu00), win, atol=1e-12)


def test_transports_refuse_what_they_cannot_carry():
    with pytest.raises(ValueError, match="unknown transport"):
        make_mesh(Grid3(1, 1, 1), device="cpu", transport="mpi")
    with pytest.raises(ValueError, match="needs a card per rank"):
        make_mesh(Grid3(1, 1, 1), device="cpu", transport="nccl")
    if not torch.cuda.is_available():  # entry points never carry on on the CPU
        with pytest.raises(RuntimeError, match="--platform cpu"):
            make_mesh(Grid3(1, 1, 1))

    def fn(m):
        with pytest.raises(TypeError, match="transport 'gloo' carries CPU tensors"):
            m._wire(torch.zeros(1, device="meta"))
        return True

    assert run_threaded(Grid3(2, 1, 1), fn, timeout=TIMEOUT) == [True, True]


def test_run_threaded_fails_a_raising_rank_and_times_out_a_hung_one():
    def boom(m):
        if m.rank == 1:
            raise KeyError("rank one")
        return m.rank

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_threaded(Grid3(2, 1, 1), boom, timeout=30.0)

    def hang(m):
        if m.rank == 0:
            m.psum(torch.ones(1), "x")  # its peer never joins
        return m.rank

    with pytest.raises((TimeoutError, RuntimeError)):
        run_threaded(Grid3(2, 1, 1), hang, timeout=3.0)
    assert time.monotonic() - t0 < 20.0


def test_distribute_shards_both_forms_and_gather():
    grid = Grid3(2, 3, 1)
    geom = LUGeometry.create(48, 48, 8, grid)
    A = np.random.default_rng(0).standard_normal((48, 48))
    S = geom.scatter(A)
    calls = []

    def fill(px, py):
        calls.append((px, py))
        return geom.local_block(A, px, py)

    def fn(m):
        a = distribute_shards(S, m)
        b = distribute_shards(fill, m, shape=S.shape, dtype=np.float64)
        assert torch.equal(a, b) and torch.equal(a, torch.from_numpy(S[m.x, m.y]))
        return gather_shards(a, m).numpy()

    for full in run_threaded(grid, fn, timeout=TIMEOUT):
        np.testing.assert_array_equal(geom.gather(full), A)
    assert sorted(calls) == [(x, y) for x in range(2) for y in range(3)]
    with pytest.raises(ValueError, match="shape= and dtype="):
        distribute_shards(fill, make_mesh(Grid3(1, 1, 1), device="cpu"))
    with pytest.raises(ValueError, match="block-cyclic layout"):
        check_shards(np.zeros((2, 2, 3, 3)), geom)


def test_block_cyclic_geometry_is_the_jax_packages():
    for M, N, v, g in ((50, 50, 8, (2, 3, 1)), (64, 32, 8, (2, 2, 2)), (40, 72, 4, (3, 1, 1))):
        tg = LUGeometry.create(M, N, v, Grid3(*g))
        jg = jgeometry.LUGeometry.create(M, N, v, jgeometry.Grid3(*g))
        A = np.random.default_rng(M).standard_normal((M, N))
        np.testing.assert_array_equal(tg.scatter(A), jg.scatter(A))
        np.testing.assert_array_equal(tg.gather(tg.scatter(A)), jg.gather(jg.scatter(A)))
        np.testing.assert_array_equal(tg.global_row_index(), jg.global_row_index())
        cg = CholeskyGeometry.create(M, v, Grid3(*g))
        jcg = jgeometry.CholeskyGeometry.create(M, v, jgeometry.Grid3(*g))
        assert (cg.N, cg.Ml, cg.Nl, cg.nlayr) == (jcg.N, jcg.Ml, jcg.Nl, jcg.nlayr)
    for n, v, s in ((32, 8, 16), (7, 8, 3), (5, 4, 5)):
        assert ragged_segments(n, v, s) == jgeometry.ragged_segments(n, v, s)
    for args in ((13, 3), (0, 2)):
        assert tile_owner(*args) == jgeometry.tile_owner(*args)
        assert tile_local(*args) == jgeometry.tile_local(*args)
    assert tile_global(1, 4, 3) == jgeometry.tile_global(1, 4, 3)
    for r in (0, 17, 95):
        assert row_owner(r, 8, 3) == jgeometry.row_owner(r, 8, 3)
        assert row_local(r, 8, 3) == jgeometry.row_local(r, 8, 3)
    assert row_global(2, 13, 8, 3) == jgeometry.row_global(2, 13, 8, 3)
    np.testing.assert_array_equal(local_row_indices(1, 16, 8, 2),
                                  jgeometry.local_row_indices(1, 16, 8, 2))
    # a 1 x 1 grid's shards are a copy: factoring them in place leaves A
    A = np.ones((16, 16))
    S = LUGeometry.create(16, 16, 8, Grid3(1, 1, 1)).scatter(A)
    S[...] = 0
    assert A.sum() == 256


def test_io_scatter_half_is_the_jax_packages(tmp_path):
    g = CholeskyGeometry.create(48, 8, Grid3(2, 3, 1))
    jg = jgeometry.CholeskyGeometry.create(48, 8, jgeometry.Grid3(2, 3, 1))
    np.testing.assert_array_equal(tio.generate_spd_shards(g), jio.generate_spd_shards(jg))
    np.testing.assert_array_equal(tio.generate_spd_tiles(g), jio.generate_spd_tiles(jg))
    np.testing.assert_array_equal(g.gather(tio.generate_spd_shards(g)),
                                  tio.generate_spd_tiles(g))
    tio.generate_spd_file(str(tmp_path / "a.bin"), 48, v=8)
    jio.generate_spd_file(str(tmp_path / "b.bin"), 48, v=8)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    S = tio.load_scattered(str(tmp_path / "a.bin"), g)
    np.testing.assert_array_equal(S, jio.load_scattered(str(tmp_path / "a.bin"), jg))
    np.testing.assert_array_equal(S, tio.load_and_scatter(str(tmp_path / "a.bin"), g))
    tio.save_scattered(str(tmp_path / "c.bin"), S, g)
    assert (tmp_path / "c.bin").read_bytes() == (tmp_path / "a.bin").read_bytes()
    with pytest.raises(ValueError, match="geometry needs"):
        tio.load_scattered(str(tmp_path / "a.bin"), CholeskyGeometry.create(64, 8, Grid3(1, 1, 1)))


def test_autotune_table_starts_empty_and_loads_rules(tmp_path):
    autotune.reset_loaded_table()
    rec = autotune.recommended("lu", 32768, P=1, device_kind="nvidia h100 80gb hbm3")
    assert rec.knobs["segs"] == (16, 16) and rec.knobs["v"] is None
    assert "no measurement" in rec.provenance
    table = tmp_path / "t.json"
    table.write_text('[{"algo": "lu", "device": "h100", "P": 1, "knobs": '
                     '{"v": 1024, "segs": [8, 8]}, "provenance": "a card run"}]')
    try:
        assert autotune.load_table(str(table)) == 1
        rec = autotune.recommended("lu", 32768, P=1, device_kind="nvidia h100 80gb hbm3")
        assert rec.knobs == {"v": 1024, "segs": (8, 8)} and rec.provenance == "a card run"
        assert "no measurement" in autotune.recommended("lu", 4096, P=2,
                                                        device_kind="cpu").provenance
    finally:
        autotune.reset_loaded_table()
    for bad in ("x", '[{"algo": "svd", "knobs": {}}]', '[{"algo": "lu", "knobs": {}, "z": 1}]'):
        table.write_text(bad if bad != "x" else "{}")
        with pytest.raises(ValueError):
            autotune.load_table(str(table))
    with pytest.raises(ValueError, match="unknown algo"):
        autotune.recommended("svd", 10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(args, nproc: int, timeout: float = 120.0):
    """One worker process per rank with torchrun's environment; returns
    (returncode, output) of each, killing stragglers on the way out."""
    port = str(_free_port())
    procs = []
    for rank in range(nproc):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(nproc),
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"), *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE))
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def test_two_process_world_through_initialize_multihost():
    """Two OS processes, gloo over env://, grid 2x1x1: each builds only its
    own shard, factors and validates on the grid."""
    for rank, (rc, out) in enumerate(_run_world(["lu", "2,1,1", "gather"], 2)):
        assert rc == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"rank {rank}: coords=({rank}, 0, 0)" in out and "residual=" in out


@pytest.mark.slow
@pytest.mark.parametrize("gridspec,election", [
    ("4,2,1", "gather"), ("2,2,2", "gather"), ("3,2,1", "butterfly"), ("3,2,2", "butterfly")])
def test_multi_process_lu(gridspec, election):
    P = Grid3.parse(gridspec).P
    for rank, (rc, out) in enumerate(_run_world(["lu", gridspec, election], P, 360.0)):
        assert rc == 0, f"rank {rank} failed:\n{out[-3000:]}"


@pytest.mark.slow
def test_multi_process_cholesky():
    for rank, (rc, out) in enumerate(_run_world(["chol", "2,2,2"], 8, 360.0)):
        assert rc == 0, f"rank {rank} failed:\n{out[-3000:]}"


@pytest.mark.slow
def test_peer_failure_detected_in_bounded_time():
    """A lost rank: the survivor's next collective fails within its
    timeout, never hangs."""
    port = str(_free_port())
    procs = []
    t0 = time.time()
    for rank, role in enumerate(("survive", "die")):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"), role],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE))
    try:
        out_s, _ = procs[0].communicate(timeout=120)
        procs[1].communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == 17
    assert procs[0].returncode == 0, out_s[-2000:]
    assert "peer loss detected" in out_s and time.time() - t0 < 110


@pytest.mark.slow
def test_failure_recovery_new_processes_resume_from_checkpoint(tmp_path):
    for phase, want in ((1, "phase1 checkpointed"), (2, "phase2 residual=")):
        for rank, (rc, out) in enumerate(_run_world(["resume", str(phase), str(tmp_path)], 2)):
            assert rc == 0, f"phase {phase} rank {rank}:\n{out[-3000:]}"
            assert want in out
