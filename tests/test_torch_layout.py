"""The port's layout descriptors and redistribution (`conflux_tpu_torch.
layout`, the COSTA role) against the JAX package's `conflux_tpu.layout`:
the same operations on the same seeded numpy matrices give the same
buffers bit for bit (both are numpy, the port's tile packing native),
with the twins of tests/test_layout_io.py's layout cases."""

import numpy as np
import pytest

from conflux_tpu import layout as jlay
from conflux_tpu_torch import layout as lay
from conflux_tpu_torch.geometry import Grid3


def _same(a, b):
    """Equal buffers: numpy arrays, lists of lists, or owner -> tile stores."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape


def _bc(mod, *args):
    return mod.BlockCyclicLayout(*args)


@pytest.mark.parametrize("shape,src,dst", [
    ((20, 12), (4, 4, 2, 3), None),          # round trip
    ((10, 7), (4, 3, 2, 2), None),           # ragged edges
    ((24, 24), (4, 4, 2, 2), (8, 8, 3, 1)),  # between tile sizes
    ((22, 17), (5, 4, 2, 3), (3, 7, 3, 2)),  # ragged extents, unaligned tiles
    ((16, 16), (8, 8, 4, 4), None),          # grid larger than the tile grid
], ids=str)
def test_block_cyclic_scatter_gather_transform_match_the_jax_package(shape, src, dst):
    A = np.random.default_rng(sum(shape)).standard_normal(shape)
    s, js = _bc(lay, *shape, *src), _bc(jlay, *shape, *src)
    shards = lay.scatter(A, s)
    _same(shards, jlay.scatter(A, js))
    np.testing.assert_array_equal(lay.gather(shards, s), A)
    if dst is not None:
        d, jd = _bc(lay, *shape, *dst), _bc(jlay, *shape, *dst)
        moved = lay.transform(shards, s, d)
        _same(moved, jlay.transform(jlay.scatter(A, js), js, jd))
        np.testing.assert_array_equal(lay.gather(moved, d), A)
        np.testing.assert_array_equal(lay.gather(lay.transform(moved, d, s), s), A)


def test_transform_shape_mismatch_and_owner_map():
    src = lay.BlockCyclicLayout(M=8, N=8, vr=4, vc=4, Prows=1, Pcols=1)
    dst = lay.BlockCyclicLayout(M=16, N=8, vr=4, vc=4, Prows=1, Pcols=1)
    with pytest.raises(ValueError):
        lay.transform(lay.scatter(np.zeros((8, 8)), src), src, dst)
    om = lay.BlockCyclicLayout(M=16, N=16, vr=4, vc=4, Prows=2, Pcols=2).owner_map()
    assert om.shape == (4, 4, 2) and om[2, 3].tolist() == [0, 1]
    g = lay.BlockCyclicLayout.for_grid(64, 32, 8, Grid3(2, 4, 1))
    assert (g.vr, g.vc, g.Prows, g.Pcols) == (8, 8, 2, 4)


@pytest.mark.parametrize("dims", [(20, 12, 4, 4, 2, 3), (10, 7, 4, 3, 2, 2),
                                  (17, 33, 5, 8, 3, 2), (8, 8, 8, 8, 2, 2)], ids=str)
def test_numroc_desc_and_scalapack_placement(dims):
    """numroc agrees with the shard extents and the JAX package's; the
    exported ScaLAPACK locals put every element where INDXG2P/INDXG2L say
    and equal the JAX package's export."""
    M, N, vr, vc, Pr, Pc = dims
    bc = lay.BlockCyclicLayout(M=M, N=N, vr=vr, vc=vc, Prows=Pr, Pcols=Pc)
    A = np.arange(M * N, dtype=np.float64).reshape(M, N)
    shards = lay.scatter(A, bc)
    for p in range(Pr):
        assert lay.scalapack_desc(bc, p=p, ctxt=5).tolist() == \
            jlay.scalapack_desc(_bc(jlay, M, N, vr, vc, Pr, Pc), p=p, ctxt=5).tolist()
        for q in range(Pc):
            rows, cols = lay.numroc(M, vr, p, 0, Pr), lay.numroc(N, vc, q, 0, Pc)
            assert (rows, cols) == (jlay.numroc(M, vr, p, 0, Pr), jlay.numroc(N, vc, q, 0, Pc))
            assert shards[p][q].shape == (rows, cols) == bc.local_shape(p, q)
    locals_, descs = lay.to_scalapack(A, bc)
    jlocals, jdescs = jlay.to_scalapack(A, _bc(jlay, M, N, vr, vc, Pr, Pc))
    _same(locals_, jlocals)
    for i in range(M):
        for j in range(N):
            p, q = lay.indxg2p(i, vr, 0, Pr), lay.indxg2p(j, vc, 0, Pc)
            assert locals_[p][q][lay.indxg2l(i, vr, Pr), lay.indxg2l(j, vc, Pc)] == A[i, j]
    assert all(descs[p][q][8] == max(1, locals_[p][q].shape[0])
               for p in range(Pr) for q in range(Pc))
    np.testing.assert_array_equal(lay.from_scalapack(locals_, bc), A)


def test_scalapack_export_of_the_ports_factors():
    """Factors of the port's distributed LU exported to ScaLAPACK locals
    reassemble to the same packed LU (the role of the reference's COSTA
    transforms before its pdgemm validation)."""
    from conflux_tpu_torch.lu.distributed import lu_distributed_host
    from conflux_tpu_torch.parallel.mesh import run_threaded
    from conflux_tpu_torch.validation import make_test_matrix

    N, v, grid = 32, 8, Grid3(2, 2, 1)
    A = make_test_matrix(N, N, seed=12)
    LU, _perm, _geom = run_threaded(
        grid, lambda mesh: lu_distributed_host(A, grid, v, mesh=mesh, backend="xla",
                                               panel_algo="auto"), timeout=120.0)[0]
    bc = lay.BlockCyclicLayout.for_grid(N, N, v, grid)
    locals_, descs = lay.to_scalapack(LU, bc)
    assert all(d[4] == v and d[5] == v for row in descs for d in row)
    np.testing.assert_array_equal(lay.from_scalapack(locals_, bc), LU)


def _owners(rng, Mt, Nt, P, Q):
    return np.stack([rng.integers(0, P, (Mt, Nt)), rng.integers(0, Q, (Mt, Nt))], axis=-1)


def test_custom_layout_round_trip_and_transforms_match_the_jax_package():
    """CustomLayout (costa::custom_layout): arbitrary owners, tile stores
    round-trip; block-cyclic <-> custom both ways at other tile sizes (the
    region walk) and at one tile size (the native tile packing), each
    equal to the JAX package's."""
    rng = np.random.default_rng(11)
    M, N, vr, vc = 50, 38, 8, 16
    owners = _owners(rng, -(-M // vr), -(-N // vc), 3, 2)
    cl = lay.CustomLayout.from_owner_map(M, N, vr, vc, owners)
    A = rng.standard_normal((M, N)).astype(np.float32)
    store = cl.scatter(A)
    _same(store, jlay.CustomLayout.from_owner_map(M, N, vr, vc, owners).scatter(A))
    np.testing.assert_array_equal(cl.gather(store), A)

    M, N = 64, 48
    for tiles in ((16, 12), (8, 8)):  # region walk, then the native packing
        bc = lay.BlockCyclicLayout(M=M, N=N, vr=8, vc=8, Prows=2, Pcols=2)
        jbc = _bc(jlay, M, N, 8, 8, 2, 2)
        owners = _owners(rng, -(-M // tiles[0]), -(-N // tiles[1]), 2, 3)
        cl = lay.CustomLayout.from_owner_map(M, N, *tiles, owners)
        jcl = jlay.CustomLayout.from_owner_map(M, N, *tiles, owners)
        A = rng.standard_normal((M, N)).astype(np.float32)
        store = lay.transform(lay.scatter(A, bc), bc, cl)
        _same(store, jlay.transform(jlay.scatter(A, jbc), jbc, jcl))
        np.testing.assert_array_equal(cl.gather(store), A)
        bc2 = lay.BlockCyclicLayout(M=M, N=N, vr=8 if tiles == (8, 8) else 4,
                                    vc=8 if tiles == (8, 8) else 16, Prows=3 - 2 * (
                                        tiles == (8, 8)), Pcols=1 + (tiles == (8, 8)))
        back = lay.transform(store, cl, bc2)
        np.testing.assert_array_equal(lay.gather(back, bc2), A)


def test_custom_layout_matches_the_cyclic_owner_map_and_rejects_bad_maps():
    rng = np.random.default_rng(13)
    M, N, v = 40, 40, 8
    bc = lay.BlockCyclicLayout(M=M, N=N, vr=v, vc=v, Prows=2, Pcols=2)
    cl = lay.CustomLayout.from_owner_map(M, N, v, v, bc.owner_map())
    A = rng.standard_normal((M, N)).astype(np.float32)
    store = lay.transform(lay.scatter(A, bc), bc, cl)
    for ti in range(bc.tile_counts()[0]):
        for tj in range(bc.tile_counts()[1]):
            assert cl.owner(ti, tj) == bc.owner(ti, tj)
            np.testing.assert_array_equal(store[cl.owner(ti, tj)][(ti, tj)],
                                          A[ti * v:(ti + 1) * v, tj * v:(tj + 1) * v])
    with pytest.raises(ValueError, match="shape"):
        lay.CustomLayout.from_owner_map(32, 32, 8, 8, np.zeros((3, 4, 2)))
    bad = np.zeros((4, 4, 2), np.int64)
    bad[0, 0, 0] = -1
    with pytest.raises(ValueError, match="non-negative"):
        lay.CustomLayout.from_owner_map(32, 32, 8, 8, bad)
