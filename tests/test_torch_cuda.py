"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card: they carry the `cuda` marker and skip
without one (decided in a fixture, at run time). They import no JAX, so on
the card's machine they run without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch.lu.single import lu_factor_blocked
from conflux_tpu_torch.ops import hopper_kernels as hk
from conflux_tpu_torch.validation import lu_residual_device, make_test_matrix, residual_bound

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rand(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 128, 384), (100, 60, 130),
                                   (1000, 1024, 777)])
def test_gemm_kernel_matches_plain(cuda, M, K, N):
    a, b, c = _rand((M, K), 1, cuda), _rand((K, N), 2, cuda), _rand((M, N), 3, cuda)
    before = hk.LAUNCHES["gemm"]
    got = hk.gemm(a, b, c=c, alpha=-1.0, beta=0.5)
    assert hk.LAUNCHES["gemm"] == before + 1
    want = hk.gemm_plain(a, b, c, alpha=-1.0, beta=0.5)
    # f32 sums in another order: relative Frobenius 1e-5
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-5


def test_gemm_kernel_strided_in_place(cuda):
    big = _rand((300, 401), 4, cuda)
    a, b = big[3:103, 5:65], big[110:170, 7:138]
    c = big[180:280, 200:331]
    want = hk.gemm_plain(a, b, c, alpha=-1.0)
    hk.gemm(a, b, c=c, alpha=-1.0, out=c)
    assert float(torch.linalg.norm(c - want) / torch.linalg.norm(want)) <= 1e-5


def test_gemm_kernel_bf16(cuda):
    a, b = _rand((512, 256), 5, cuda, torch.bfloat16), _rand((256, 384), 6, cuda, torch.bfloat16)
    got = hk.gemm(a, b)
    want = hk.gemm_plain(a, b)
    assert got.dtype == torch.bfloat16
    err = torch.linalg.norm((got - want).float()) / torch.linalg.norm(want.float())
    assert float(err) <= 2 ** -8  # one bf16 rounding of the f32 sum


def test_gemm_kernel_rejects_float64(cuda):
    x = torch.zeros((8, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        hk.gemm(x, x)


# the cluster route (192 ... 4096; 2304: a non-portable cluster of 9), the
# grid route (4352, 8192, and 33792: the tallest block the card holds)
@pytest.mark.parametrize("m", [192, 300, 2048, 2304, 4096, 4352, 8192, 33792])
@pytest.mark.parametrize("dead", [0.0, 0.3])
def test_lu_block_kernel_matches_plain(cuda, m, dead):
    a = _rand((m, 256), m, cuda)[:, 128:]  # a strided view, as the panel passes it
    alive = torch.from_numpy(
        (np.random.default_rng(m + 1).random((m, 1)) >= dead).astype(np.int32)).to(cuda)
    before = hk.LAUNCHES["lu_block"]
    out, al, piv = hk.lu_block(a, alive)
    assert hk.LAUNCHES["lu_block"] == before + 1
    out_p, al_p, piv_p = hk.lu_block_plain(a, alive)
    assert torch.equal(piv, piv_p) and torch.equal(al, al_p)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)


def _nan_blocks(m=512):
    """(m, 128) blocks whose elections meet NaN scores: all zero (column 1
    turns NaN after the first elimination), column 0 all NaN, one NaN in
    column 0 of a random block, and a NaN in column 3 after row m - 1 was
    column 1's pivot (the NaN election reads row m - 1 as it stood when it
    died, with the updates the kernel held back)."""
    rng = np.random.default_rng(61)
    zero = np.zeros((m, 128), np.float32)
    nan_col = rng.uniform(-1, 1, (m, 128)).astype(np.float32)
    nan_col[:, 0] = np.nan
    one_nan = rng.uniform(-1, 1, (m, 128)).astype(np.float32)
    one_nan[300, 0] = np.nan
    late = rng.uniform(-1, 1, (m, 128)).astype(np.float32)
    late[0, 0], late[m - 1, 1], late[5, 3] = 100.0, 1000.0, np.nan
    return [zero, nan_col, one_nan, late]


def _k2_equal(got, want):
    """piv and alive equal, NaNs of out in the same places and its other
    entries within the K2 tolerance (the plain version emulates the FMA)."""
    (out, al, piv), (out_p, al_p, piv_p) = got, want
    if not (torch.equal(piv, piv_p) and torch.equal(al, al_p)):
        return False
    if not torch.equal(torch.isnan(out), torch.isnan(out_p)):
        return False
    return torch.allclose(out, out_p, rtol=1e-5, atol=1e-5, equal_nan=True)


_NAN_CASES = ["all_zero", "nan_column", "one_nan", "pivot_then_nan"]


@pytest.mark.parametrize("m", [512, 8192])  # the cluster route, the grid route
@pytest.mark.parametrize("case", _NAN_CASES)
def test_lu_block_nan_election_matches_plain(cuda, case, m):
    """A NaN score wins the election as in jnp.max: the step records m,
    reads row m - 1 as its pivot row and kills no row, as the plain
    version does; alone (B = 1) and as slot 2 of a batch of live random
    blocks, whose other slots keep their bits."""
    blk = torch.from_numpy(_nan_blocks(m)[_NAN_CASES.index(case)]).to(cuda)
    alive = torch.ones((m, 1), dtype=torch.int32, device=cuda)
    want = hk.lu_block_plain(blk, alive)
    got = hk.lu_block(blk, alive)
    assert _k2_equal(got, want)
    piv = want[2][0]
    if case == "all_zero":
        assert int(piv[0]) == 0 and bool((piv[1:] == m).all())
    elif case == "pivot_then_nan":
        assert piv[:2].tolist() == [0, m - 1] and bool((piv[3:] == m).all())
    else:
        assert bool((piv == m).all())
    batch = _rand((4, m, 128), 62, cuda)
    batch[2] = blk
    alive4 = torch.ones((4, m, 1), dtype=torch.int32, device=cuda)
    out, al, piv4 = hk.lu_block(batch, alive4)
    for i in range(4):
        one = hk.lu_block(batch[i], alive4[i])
        assert all(_same_bits(x, y) for x, y in zip((out[i], al[i], piv4[i]), one))
    assert _k2_equal((out[2], al[2], piv4[2]), want)


@pytest.mark.parametrize("M,K,N", [(1000, 1000, 777), (300, 70, 516), (129, 33, 260),
                                   (256, 1024, 512)])
def test_gemm_tma_instance_matches_plain(cuda, M, K, N):
    # ragged M, N and K (K not a multiple of the 32-deep stage), views
    # with 16-byte row pitches: the TMA instance
    def view(rows, cols, seed):
        return _rand((rows, -(-cols // 4) * 4 + 4), seed, cuda)[:, :cols]

    a, b, c = view(M, K, 1), view(K, N, 2), view(M, N, 3)
    assert hk.gemm_instance(a, b, c, c) == "tma"
    want = hk.gemm_plain(a, b, c, alpha=-1.0, beta=0.5)
    before = dict(hk.LAUNCHES)
    got = hk.gemm(a, b, c=c, alpha=-1.0, beta=0.5, out=c)  # in place: out is c
    assert got is c
    assert hk.LAUNCHES["gemm_tma"] == before["gemm_tma"] + 1
    assert hk.LAUNCHES["gemm"] == before["gemm"] + 1
    # f32 sums in another order: relative Frobenius 1e-5
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-5


def test_gemm_tma_instance_bf16(cuda):
    a = _rand((520, 200), 5, cuda, torch.bfloat16)  # K=200: not a multiple of 64
    b = _rand((200, 392), 6, cuda, torch.bfloat16)
    c = _rand((520, 392), 7, cuda, torch.bfloat16)
    assert hk.gemm_instance(a, b, c, c) == "tma"
    want = hk.gemm_plain(a, b, c, alpha=-1.0)
    before = hk.LAUNCHES["gemm_tma"]
    got = hk.gemm(a, b, c=c, alpha=-1.0)
    assert hk.LAUNCHES["gemm_tma"] == before + 1 and got.dtype == torch.bfloat16
    err = torch.linalg.norm((got - want).float()) / torch.linalg.norm(want.float())
    assert float(err) <= 2 ** -8  # one bf16 rounding of the f32 sum


def test_gemm_unaligned_view_runs_simt_instance(cuda):
    big = _rand((300, 401), 4, cuda)
    a, b, c = big[3:103, 5:65], big[110:170, 7:138], big[180:280, 200:331]
    assert hk.gemm_instance(a, b, c, c) == "simt"
    want = hk.gemm_plain(a, b, c, alpha=-1.0)
    before = dict(hk.LAUNCHES)
    hk.gemm(a, b, c=c, alpha=-1.0, out=c)
    assert hk.LAUNCHES["gemm"] == before["gemm"] + 1
    assert hk.LAUNCHES["gemm_tma"] == before["gemm_tma"]
    assert float(torch.linalg.norm(c - want) / torch.linalg.norm(want)) <= 1e-5


# the tournament's shapes: 8192-row chunks (the grid route) and 2048-row
# tree rounds (the cluster route); 2304 (a cluster of 9) and 4352 (17 CTAs);
# (8, 4096) fills one grid wave and (12, 4096) two waves of clusters of 16
@pytest.mark.parametrize("B,m", [(8, 4096), (4, 2048), (12, 4096), (1, 2048), (2, 2048),
                                 (4, 8192), (2, 2304), (2, 4352)])
def test_lu_block_batched_slots_bitwise_alone(cuda, B, m):
    # each slot of a batched launch has the bits of a launch on that block
    # alone, whatever the route and however many waves the batch takes
    a = _rand((B, m, 256), B * m, cuda)[:, :, 128:]  # strided, as the panel passes it
    a[:, ::8] += 2.0
    alive = torch.from_numpy(
        (np.random.default_rng(m).random((B, m, 1)) >= 0.25).astype(np.int32)).to(cuda)
    route = hk.lu_block_route(m, B, cuda)
    before = hk.LAUNCHES["lu_block"]
    out, al, piv = hk.lu_block(a, alive)
    assert hk.LAUNCHES["lu_block"] == before + hk.lu_block_launch_count(m, B, cuda)
    if B == 12:  # the case reaches a second wave of clusters
        assert route.cluster and hk.lu_block_resident(route.cluster, cuda) < B
    assert out.shape == (B, m, 128) and al.shape == (B, m, 1) and piv.shape == (B, 1, 128)
    for i in range(B):
        o1, a1, p1 = hk.lu_block(a[i], alive[i])
        assert torch.equal(out[i], o1) and torch.equal(al[i], a1) and torch.equal(piv[i], p1)
    for i in (0, B - 1):
        o_p, a_p, p_p = hk.lu_block_plain(a[i], alive[i])
        assert torch.equal(piv[i], p_p) and torch.equal(al[i], a_p)
        torch.testing.assert_close(out[i], o_p, rtol=1e-5, atol=1e-5)


def test_lu_block_counts_each_route(cuda):
    """`LAUNCHES` counts a call's launches under its route, as
    `lu_block_route` picks it: the cell's 2048-row tree rounds on the
    cluster route, its 8192-row chunks on the grid route, one launch each;
    the two route counts add up to "lu_block"."""
    for B, m, route in ((1, 2048, "cluster"), (2, 2048, "cluster"), (4, 8192, "grid"),
                        (8, 4096, "grid"), (1, 4096, "cluster")):
        assert ("cluster" if hk.lu_block_route(m, B, cuda).cluster else "grid") == route
        before = dict(hk.LAUNCHES)
        hk.lu_block(_rand((B, m, 128), m, cuda), torch.ones((B, m, 1), dtype=torch.int32,
                                                            device=cuda))
        moved = {k: hk.LAUNCHES[k] - before[k] for k in ("lu_block", "lu_block.cluster",
                                                         "lu_block.grid")}
        assert moved == {"lu_block": 1, f"lu_block.{route}": 1,
                         "lu_block." + ("grid" if route == "cluster" else "cluster"): 0}


@pytest.mark.parametrize("nch", [3, 8])
def test_tournament_winners_cuda_matches_cpu(cuda, nch, monkeypatch):
    from conflux_tpu_torch.ops import blas

    monkeypatch.setattr(blas, "_PALLAS_MAX_ROWS", 512)
    panel = make_test_matrix(512 * nch, 256, seed=nch).astype(np.float32)
    before = hk.LAUNCHES["lu_block"]
    lu_g, gpiv_g = blas.tournament_winners(torch.from_numpy(panel).to(cuda), chunk=512)
    assert hk.LAUNCHES["lu_block"] - before == blas.lu_block_launches(512 * nch, 256, cuda)
    lu_c, gpiv_c = blas.tournament_winners(torch.from_numpy(panel), chunk=512)
    assert torch.equal(gpiv_g.cpu(), gpiv_c)
    torch.testing.assert_close(lu_g.cpu(), lu_c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N,v", [(512, 128), (2048, 256)])
def test_lu_factor_blocked_cuda_matches_cpu(cuda, N, v):
    A = make_test_matrix(N, N, seed=7).astype(np.float32)
    LU_g, perm_g = lu_factor_blocked(torch.from_numpy(A).to(cuda), v)
    LU_c, perm_c = lu_factor_blocked(torch.from_numpy(A), v)
    assert torch.equal(perm_g.cpu(), perm_c)
    # the same pivots; the factors differ by the two devices' summation
    # orders, amplified in the trailing corner by the leading blocks'
    # conditioning (entrywise up to ~1e-2 at N=2048), so compare norm-wise
    diff = torch.linalg.norm(LU_g.cpu() - LU_c) / torch.linalg.norm(LU_c)
    assert float(diff) <= 1e-4
    res = lu_residual_device(torch.from_numpy(A).to(cuda), LU_g, perm_g)
    assert res < residual_bound(N, np.float32)


def _systems(B, n, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    return torch.from_numpy(A).to(device, dtype)


@pytest.mark.parametrize("B,n,k", [(32, 256, 16), (4, 200, 3), (2, 1024, 1), (3, 48, 40)])
@pytest.mark.parametrize("lower", [True, False])
def test_btrsm_kernel_matches_plain(cuda, B, n, k, lower):
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    T = _systems(B, n, n + k, cuda)  # a packed operand: both triangles hold data
    D = diag_block_inverses(T, lower=lower, unit_diagonal=lower)
    b = _rand((B, n, k), 9, cuda)
    before = hk.LAUNCHES["btrsm"]
    got = hk.btrsm(T, D, b, lower=lower)
    assert hk.LAUNCHES["btrsm"] == before + 1
    want = hk.btrsm_plain(T, D, b, lower=lower)
    # f32 sums in another order: relative Frobenius 1e-5
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-5


def _round_case(kind, B, n, seed, device, dtype=torch.float32):
    """The operands of a serving round: a packed LU and its permutation
    from K4, or a Cholesky factor from K5, with the diagonal-block
    inverses the plans keep."""
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    if kind == "lu":
        LU, perm, _ = hk.batched_lu(_systems(B, n, seed, device, dtype))
        return (LU, diag_block_inverses(LU, lower=True, unit_diagonal=True),
                diag_block_inverses(LU, lower=False), perm)
    L, _ = hk.batched_chol(_spd_systems(B, n, seed, device, dtype))
    return L, diag_block_inverses(L, lower=True), None, None


# the serving shapes (32, 256) and (2, 1024) at k = 1, 16 columns, a ragged
# n with 3 columns, f64, and 40 columns (three column tiles, walked by one
# cluster when the probe is on)
PAIR_SHAPES = [(32, 256, 1, torch.float32), (32, 256, 16, torch.float32),
               (2, 1024, 1, torch.float32), (4, 200, 3, torch.float32),
               (8, 256, 1, torch.float64), (3, 48, 40, torch.float32)]


@pytest.mark.parametrize("B,n,k,dtype", PAIR_SHAPES)
@pytest.mark.parametrize("kind", ["lu", "spd"])
def test_btrsm_pair_kernel_matches_plain(cuda, kind, B, n, k, dtype):
    T, Dl, Du, perm = _round_case(kind, B, n, n + k, cuda, dtype)
    b = _rand((B, n, k), 13, cuda, dtype)
    wA = _rand((B, n), 14, cuda, dtype)
    spd = kind == "spd"
    before = hk.LAUNCHES["btrsm"]
    x = hk.btrsm_pair(T, Dl, Du, b, perm=perm, trans_back=spd)
    assert hk.LAUNCHES["btrsm"] == before + 1
    want, xs_p, wax_p = hk.btrsm_pair_plain(T, Dl, Du, b, perm, spd, wA)
    # sums in another order: relative Frobenius 1e-5 (f32), 1e-12 (f64)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float(torch.linalg.norm(x - want) / torch.linalg.norm(want)) <= tol
    # the probe epilogue: one launch, x's bits unchanged, the stats within
    # the summation order's error of the plain version's
    before = hk.LAUNCHES["btrsm"]
    xp, xsum, wAx = hk.btrsm_pair(T, Dl, Du, b, perm=perm, trans_back=spd, wA=wA)
    assert hk.LAUNCHES["btrsm"] == before + 1
    assert torch.equal(xp, x)
    scale = x.abs().sum(dim=(1, 2))
    assert bool(((xsum - xs_p).abs() <= 1e-4 * scale).all())
    assert bool(((wAx - wax_p).abs() <= 1e-4 * (wA * x[:, :, 0]).abs().sum(1)).all())
    # a B=1 launch (another cluster geometry) is bitwise slot i of the batch
    for i in (0, B - 1):
        one = hk.btrsm_pair(T[i:i + 1], Dl[i:i + 1], None if spd else Du[i:i + 1],
                            b[i:i + 1], perm=None if spd else perm[i:i + 1],
                            trans_back=spd, wA=wA[i:i + 1])
        assert all(torch.equal(got[0], ref) for got, ref in
                   zip(one, (x[i], xsum[i], wAx[i])))


def test_btrsm_pair_nan_poisons_its_slot_alone(cuda):
    T, Dl, Du, perm = _round_case("lu", 32, 256, 3, cuda)
    b = _rand((32, 256, 1), 15, cuda)
    wA = _rand((32, 256), 16, cuda)
    x, xsum, _ = hk.btrsm_pair(T, Dl, Du, b, perm=perm, wA=wA)
    bad = b.clone()
    bad[5, 17, 0] = float("nan")
    xn, xsn, _ = hk.btrsm_pair(T, Dl, Du, bad, perm=perm, wA=wA)
    keep = [i for i in range(32) if i != 5]
    assert bool(torch.isnan(xsn[5])) and torch.equal(xsn[keep], xsum[keep])
    assert torch.equal(xn[keep], x[keep])


def _packed_lu(B, n, seed, device):
    """A well-conditioned packed LU made on the card: unit lower and upper
    triangles with off-diagonal entries ~ N(0, 1) / n, upper diagonal 3
    (no factorization, so that n may be large), and a row permutation."""
    gen = torch.Generator(device=device).manual_seed(seed)
    T = torch.randn((B, n, n), generator=gen, device=device) / n
    T.diagonal(dim1=-2, dim2=-1).add_(3.0)
    perm = torch.stack([torch.randperm(n, generator=gen, device=device) for _ in range(B)])
    return T, perm


def _rel(x, ref):
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def test_btrsm_pair_kernel_x_blocks_in_global_memory(cuda):
    """n = 20000 f32: a round's x blocks do not fit shared memory at any
    cluster size, so they go to global memory; same function, a B=1
    launch bitwise slot 1 of a batch of 2, x's bits kept with the probe.
    One substitution at that n (x blocks still in shared memory) too."""
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    B, n = 2, 20000
    T, perm = _packed_lu(B, n, 21, cuda)
    Dl = diag_block_inverses(T, lower=True, unit_diagonal=True)
    Du = diag_block_inverses(T, lower=False)
    b = _rand((B, n, 1), 22, cuda)
    wA = _rand((B, n), 23, cuda)
    x = hk.btrsm_pair(T, Dl, Du, b, perm=perm)
    assert _rel(x, hk.btrsm_pair_plain(T, Dl, Du, b, perm)) <= 1e-5
    xp, xsum, wAx = hk.btrsm_pair(T, Dl, Du, b, perm=perm, wA=wA)
    assert torch.equal(xp, x)
    one = hk.btrsm_pair(T[1:], Dl[1:], Du[1:], b[1:], perm=perm[1:], wA=wA[1:])
    assert all(torch.equal(g[0], r) for g, r in zip(one, (x[1], xsum[1], wAx[1])))
    L = T[:1]  # SPD plans' round: back through L^T, read in place
    Dc = diag_block_inverses(L, lower=True)
    xs = hk.btrsm_pair(L, Dc, None, b[:1], trans_back=True)
    assert _rel(xs, hk.btrsm_pair_plain(L, Dc, None, b[:1], trans_back=True)) <= 1e-5
    for lower, D in ((True, Dl), (False, Du)):
        got = hk.btrsm(T[:1], D[:1], b[:1], lower=lower)
        assert _rel(got, hk.btrsm_plain(T[:1], D[:1], b[:1], lower)) <= 1e-5


def test_btrsm_kernel_wide_rhs_in_global_memory(cuda):
    """One substitution whose 16-column x blocks do not fit shared memory
    at n = 12000 (any column tile): the global-memory instance, walking
    its column tiles in parallel clusters."""
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    T, _ = _packed_lu(1, 12000, 24, cuda)
    b = _rand((1, 12000, 16), 25, cuda)
    for lower in (True, False):
        D = diag_block_inverses(T, lower=lower, unit_diagonal=lower)
        got = hk.btrsm(T, D, b, lower=lower)
        assert _rel(got, hk.btrsm_plain(T, D, b, lower)) <= 1e-5


@pytest.mark.parametrize("bs", [48, 64])
@pytest.mark.parametrize("n", [256, 200])
def test_btrsm_kernel_wide_diagonal_blocks(cuda, n, bs):
    """Diagonal blocks wider than 32 run as their diagonal sub-blocks (24
    or 32 wide): btrsm, btrsm_pair with and without trans_back, and the
    public blocked_trsm, each against its plain version on the wide
    blocks, one launch a call."""
    from conflux_tpu_torch.ops.batched_trsm import blocked_trsm, diag_block_inverses

    T, perm = _packed_lu(4, n, 26, cuda)
    b = _rand((4, n, 3), 27, cuda)
    Dl = diag_block_inverses(T, lower=True, unit_diagonal=True, block_size=bs)
    Du = diag_block_inverses(T, lower=False, block_size=bs)
    Dc = diag_block_inverses(T, lower=True, block_size=bs)
    before = hk.LAUNCHES["btrsm"]
    got = [hk.btrsm(T, Du, b, lower=False), hk.btrsm_pair(T, Dl, Du, b, perm=perm),
           hk.btrsm_pair(T, Dc, None, b, trans_back=True),
           blocked_trsm(T, b, lower=True, unit_diagonal=True, block_size=bs)]
    assert hk.LAUNCHES["btrsm"] == before + 4
    want = [hk.btrsm_plain(T, Du, b, False), hk.btrsm_pair_plain(T, Dl, Du, b, perm),
            hk.btrsm_pair_plain(T, Dc, None, b, trans_back=True), hk.btrsm_plain(T, Dl, b, True)]
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


# shapes across the kernels' 32-column blocks, 64-wide trailing tiles and
# cluster sizes: one block (1, 31), a one-column trailing square (33), a
# ragged (1000), f64 at the top size, and B = 33 (clusters in waves)
FACTOR_SHAPES = [(32, 256, torch.float32), (4, 200, torch.float32), (2, 1024, torch.float32),
                 (8, 256, torch.float64), (3, 1, torch.float32), (3, 31, torch.float32),
                 (3, 33, torch.float32), (3, 1000, torch.float32), (2, 1024, torch.float64),
                 (33, 256, torch.float32)]


@pytest.mark.parametrize("B,n,dtype", FACTOR_SHAPES)
def test_batched_lu_kernel_matches_plain(cuda, B, n, dtype):
    A = _systems(B, n, n + B, cuda, dtype)
    w = torch.from_numpy(np.sign(np.random.default_rng(1).standard_normal(n))).to(cuda, dtype)
    before = hk.LAUNCHES["batched_lu"]
    LU, perm, wa = hk.batched_lu(A, w)
    assert hk.LAUNCHES["batched_lu"] == before + 1
    LU_p, perm_p, wa_p = hk.batched_lu_plain(A, w)
    assert torch.equal(perm, perm_p)
    # f32: the plain version's FMA is exact but for double-rounding ties;
    # f64 rounds its update twice, the kernel once
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(LU, LU_p, rtol=tol, atol=tol)
    assert float(torch.linalg.norm(wa - wa_p) / torch.linalg.norm(wa_p)) <= 1e-5
    # a B=1 launch (another cluster size) gives the slot's bits of the batch
    for i in (0, B - 1):
        LU1, p1, _ = hk.batched_lu(A[i:i + 1], w)
        assert torch.equal(LU1[0], LU[i]) and torch.equal(p1[0], perm[i])


def test_batched_lu_kernel_panel_in_global_memory(cuda):
    """n = 5000 in float64: a CTA's share of the panel rows fits shared
    memory at no cluster size, so K4 keeps the panel in the output; the
    same pivots and factors as the plain version, and a B=1 launch gives
    the slot's bits of the batch."""
    A = _systems(2, 5000, 11, cuda, torch.float64)
    assert hk.batched_factor_geometry("batched_lu", A)[2]
    assert not hk.batched_factor_geometry("batched_lu", A[:, :1024, :1024])[2]
    before = hk.LAUNCHES["batched_lu"]
    LU, perm, _ = hk.batched_lu(A)
    assert hk.LAUNCHES["batched_lu"] == before + 1
    LU_p, perm_p, _ = hk.batched_lu_plain(A)
    assert torch.equal(perm, perm_p)
    torch.testing.assert_close(LU, LU_p, rtol=1e-12, atol=1e-12)
    LU1, p1, _ = hk.batched_lu(A[1:2])
    assert torch.equal(LU1[0], LU[1]) and torch.equal(p1[0], perm[1])


def test_batched_lu_kernel_slots_are_independent(cuda):
    A = _systems(32, 256, 5, cuda)
    LU32, p32, _ = hk.batched_lu(A)
    bad = A.clone()
    bad[3] = float("nan")
    LUn, pn, _ = hk.batched_lu(bad)
    for i in (0, 5, 31):
        LU1, p1, _ = hk.batched_lu(A[i:i + 1])
        assert torch.equal(LU1[0], LU32[i]) and torch.equal(p1[0], p32[i])
    keep = [i for i in range(32) if i != 3]
    assert torch.equal(LUn[keep], LU32[keep]) and torch.equal(pn[keep], p32[keep])
    assert not torch.isfinite(LUn[3]).all()
    assert bool(((pn[3] >= 0) & (pn[3] < 256)).all())


def test_serve_bucket_is_bitwise_plan_factor(cuda):
    from conflux_tpu_torch import serve

    serve.clear_plans()
    plan = serve.FactorPlan.create((256, 256), torch.float32, v=128)
    A = _systems(8, 256, 11, cuda)
    F, wA, verdict = plan._factor_health_fn(8)(A)
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-3
    for i in (0, 7):
        s = plan.factor(A[i])
        for got, ref in zip(F, s.factors):
            assert torch.equal(got[i], ref)
    b = _rand((256, 3), 12, cuda)
    x = s.solve(b)
    assert float((A[7] @ x - b).abs().max()) < 1e-4


@pytest.mark.parametrize("substitution", ["blocked", "inv"])
@pytest.mark.parametrize("bb", [2, 32])
def test_serve_factor_epilogue_is_bucket_invariant(cuda, substitution, bb):
    """The factor epilogue's batched library solves (the Dinv blocks, or
    the full inverses) run on the whole bucket: slot i's factors are bit
    for bit those of `plan.factor` alone, whatever the bucket size."""
    from conflux_tpu_torch import serve

    serve.clear_plans()
    plan = serve.FactorPlan.create((256, 256), torch.float32, v=128,
                                   substitution=substitution)
    A = _systems(bb, 256, 20 + bb, cuda)
    F = plan._stacked_factor_fn(bb)(A)
    for i in (0, bb - 1):
        for got, ref in zip(F, plan.factor(A[i]).factors):
            assert torch.equal(got[i], ref)


def test_single_triangle_blocked_trsm_launches_k3(cuda):
    from conflux_tpu_torch.ops.batched_trsm import blocked_trsm

    T = _systems(2, 200, 31, cuda)
    b = _rand((2, 200, 3), 32, cuda)
    before = hk.LAUNCHES["btrsm"]
    x1 = blocked_trsm(T[1], b[1], lower=False)
    assert hk.LAUNCHES["btrsm"] == before + 1
    torch.testing.assert_close(x1, blocked_trsm(T, b, lower=False)[1], rtol=1e-5, atol=1e-6)


def _spd_systems(B, n, seed, device, dtype=torch.float32):
    """SPD systems with O(1) entries: M M^T / n + I, M standard normal."""
    M = np.random.default_rng(seed).standard_normal((B, n, n))
    return torch.from_numpy(np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)).to(device, dtype)


def _same_bits(x, y):
    """Equal values and NaNs in the same places."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])


@pytest.mark.parametrize("B,n,dtype", FACTOR_SHAPES)
def test_batched_chol_kernel_matches_plain_bitwise(cuda, B, n, dtype):
    A = _spd_systems(B, n, n + B, cuda, dtype)
    w = torch.from_numpy(np.sign(np.random.default_rng(1).standard_normal(n))).to(cuda, dtype)
    before = hk.LAUNCHES["batched_chol"]
    L, wa = hk.batched_chol(A, w)
    assert hk.LAUNCHES["batched_chol"] == before + 1
    L_p, wa_p = hk.batched_chol_plain(A, w)
    # the same three roundings per update and one per scale, none fused
    assert torch.equal(L, L_p)
    assert not torch.triu(L, 1).any()
    assert float(torch.linalg.norm(wa - wa_p) / torch.linalg.norm(wa_p)) <= 1e-5
    for i in (0, B - 1):  # a B=1 launch gives the slot's bits of the batch
        assert torch.equal(hk.batched_chol(A[i:i + 1], w)[0][0], L[i])


def _off_range_spd_slots(n, seed, device):
    """SPD slots whose operands leave the range of K5's reciprocal-and-FMA
    division (entries in [2^-30, 2^31), diagonals in [2^-60, 2^61)), so
    that tiles and panel groups take __fdiv_rn: the identity, a
    block-diagonal and a banded matrix (exact zeros), D S D with D powers of
    two from 2^-20 to 2^20 (entries from ~2^-40 to ~2^40, across both
    edges, fast and slow tiles in one slot), and a dense O(1) slot S."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    S = M @ M.T / n + np.eye(n)
    idx = np.arange(n)
    blocks = S * (idx[:, None] // 100 == idx[None, :] // 100)
    R = rng.uniform(-1, 1, (n, n))
    band = (R + R.T) / 2 * (np.abs(idx[:, None] - idx[None, :]) <= 40) + 82.0 * np.eye(n)
    d = 2.0 ** rng.integers(-20, 21, n)
    wide = d[:, None] * S * d[None, :]
    return torch.from_numpy(np.stack([np.eye(n), blocks, band, wide, S])).to(device,
                                                                          torch.float32)


@pytest.mark.parametrize("n", [1000, 1024])
def test_batched_chol_kernel_off_range_operands_bitwise(cuda, n):
    A = _off_range_spd_slots(n, n, cuda)
    assert hk.batched_factor_geometry("batched_chol", A)[1] > 1  # a cluster per slot
    L, _ = hk.batched_chol(A)
    assert torch.equal(L, hk.batched_chol_plain(A)[0])
    for i in range(A.shape[0]):  # each slot alone (B=1) gives its bits of the batch
        assert torch.equal(hk.batched_chol(A[i:i + 1])[0][0], L[i])


def test_batched_chol_kernel_slots_are_independent(cuda):
    A = _spd_systems(32, 256, 5, cuda)
    L32, _ = hk.batched_chol(A)
    bad = A.clone()
    bad[3] = -bad[3]  # not positive definite
    bad[9, 100, 100] = -50.0  # indefinite from column 100 on
    Ln, _ = hk.batched_chol(bad)
    for i in (0, 5, 31):
        assert torch.equal(hk.batched_chol(A[i:i + 1])[0][0], L32[i])
    keep = [i for i in range(32) if i not in (3, 9)]
    assert torch.equal(Ln[keep], L32[keep])
    assert torch.isnan(Ln[3]).any() and torch.isnan(Ln[9]).any()
    assert _same_bits(Ln, hk.batched_chol_plain(bad)[0])


@pytest.mark.parametrize("substitution", ["blocked", "inv"])
@pytest.mark.parametrize("bb", [2, 32])
def test_serve_spd_bucket_is_bitwise_plan_factor(cuda, substitution, bb):
    from conflux_tpu_torch import serve

    serve.clear_plans()
    plan = serve.FactorPlan.create((256, 256), torch.float32, v=128, kind="chol",
                                   substitution=substitution)
    A = _spd_systems(bb, 256, 40 + bb, cuda)
    before = dict(hk.LAUNCHES)
    F, wA, verdict = plan._factor_health_fn(bb)(A)
    assert hk.LAUNCHES["batched_chol"] == before["batched_chol"] + 1
    assert bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) < 1e-3
    for i in (0, bb - 1):
        s = plan.factor(A[i])
        for got, ref in zip(F, s.factors):
            assert torch.equal(got[i], ref)
    b = _rand((256, 3), 12, cuda)
    x = s.solve(b)
    assert float((A[bb - 1] @ x - b).abs().max()) < 1e-4


@pytest.mark.parametrize("N,v", [(512, 128), (2048, 256)])
def test_cholesky_blocked_cuda_matches_cpu(cuda, N, v):
    from conflux_tpu_torch.cholesky import cholesky_blocked
    from conflux_tpu_torch.validation import cholesky_residual_device, make_spd_matrix

    A = make_spd_matrix(N, dtype=np.float32)
    before = hk.LAUNCHES["gemm"]
    L_g = cholesky_blocked(A.to(cuda), v)
    assert hk.LAUNCHES["gemm"] == before + N // v - 1
    L_c = cholesky_blocked(A, v)
    # the two devices sum in other orders; Cholesky needs no pivots and
    # stays close norm-wise
    assert float(torch.linalg.norm(L_g.cpu() - L_c) / torch.linalg.norm(L_c)) <= 1e-5
    res = cholesky_residual_device(A.to(cuda), L_g)
    assert res < residual_bound(N, np.float32)
    assert torch.equal(make_spd_matrix(N, dtype=np.float32, device=cuda).cpu(), A)


@pytest.mark.parametrize("B,n,k", [(32, 256, 1), (4, 200, 3), (4, 203, 3), (2, 1024, 1), (3, 48, 40)])
@pytest.mark.parametrize("kind", ["lu", "spd"])
def test_btrsm_pair_bf16_factor_matches_plain_and_f32_bitwise(cuda, kind, B, n, k):
    """K3's bfloat16-T instance: a bf16 factor read as it is stored, held
    to the plain version, and bit for bit the float32 instance on the
    upcast factor (bf16 -> f32 is exact)."""
    T, Dl, Du, perm = _round_case(kind, B, n, n + k, cuda)
    Tb = T.bfloat16()
    Tu = Tb.float()
    b = _rand((B, n, k), 15, cuda)
    wA = _rand((B, n), 16, cuda)
    spd = kind == "spd"
    before = hk.LAUNCHES["btrsm"]
    x, xsum, wAx = hk.btrsm_pair(Tb, Dl, Du, b, perm=perm, trans_back=spd, wA=wA)
    assert hk.LAUNCHES["btrsm"] == before + 1
    want = hk.btrsm_pair_plain(Tb, Dl, Du, b, perm, spd)
    assert float(torch.linalg.norm(x - want) / torch.linalg.norm(want)) <= 1e-5
    ref = hk.btrsm_pair(Tu, Dl, Du, b, perm=perm, trans_back=spd, wA=wA)
    assert all(torch.equal(got, r) for got, r in zip((x, xsum, wAx), ref))
    for lower in (True, False):
        d = Dl if lower or spd else Du
        if spd and not lower:
            continue
        got = hk.btrsm(Tb, d, b, lower=lower)
        assert torch.equal(got, hk.btrsm(Tu, d, b, lower=lower))


@pytest.mark.parametrize("backend,dtype", [("kernel", torch.bfloat16), ("kernel", torch.float32),
                                           ("xla", torch.float64)])
def test_batched_blocked_lu_cuda_matches_cpu(cuda, backend, dtype):
    """The batched blocked factor on the card: on "kernel" one K1 launch
    per system and superstep and one batched K2 launch per column block;
    on "xla" the library routes. Held to its CPU run by residual."""
    from conflux_tpu_torch.validation import lu_residual

    B, N, v = 3, 512, 128
    A = torch.stack([torch.from_numpy(make_test_matrix(N, N, seed=s, dtype=np.float32))
                     for s in range(B)]).to(dtype)
    algo = "kernel" if backend == "kernel" else "auto"
    hk.reset_launches()
    LU, perm = lu_factor_blocked(A.to(cuda), v, backend=backend, panel_algo=algo)
    counts = dict(hk.LAUNCHES)
    if backend == "kernel":
        assert counts["gemm"] == B * (N // v - 1)
        assert counts["lu_block"] == (N // v) * (v // 128)
    else:
        assert counts["gemm"] == 0 and counts["lu_block"] == 0
    LUc, permc = lu_factor_blocked(A, v, backend=backend, panel_algo=algo)
    for i in range(B):
        Ai = A[i].double().numpy()
        res_g = lu_residual(Ai, LU[i].cpu().double().numpy(), perm[i].cpu().numpy())
        res_c = lu_residual(Ai, LUc[i].double().numpy(), permc[i].numpy())
        if dtype == torch.bfloat16:
            # every trailing update rounds to bf16 (2^-8): ~3e-2 at N=512,
            # within a factor 2 of the CPU run's (other sums, other ties)
            assert res_c <= 0.1 and res_g <= 2 * res_c
        else:
            assert max(res_g, res_c) <= residual_bound(N, dtype)


def test_xla_batched_cholesky_poisons_a_non_spd_slot_with_nan(cuda):
    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.validation import make_spd_matrix

    A = torch.stack([make_spd_matrix(64, seed=s, dtype=np.float64) for s in range(4)]).to(cuda)
    A[2, 5, 5] = -1e3
    L, wA = blas.batched_cholesky_factor(A, probe_w=torch.ones(64), backend="xla")
    # as the JAX Cholesky returns it: NaN on and below the diagonal, zero above
    lower = torch.ones(64, 64, dtype=torch.bool, device=cuda).tril()
    assert bool(torch.isnan(L[2][lower]).all()) and not bool(L[2][~lower].any())
    for i in (0, 1, 3):
        assert bool(torch.isfinite(L[i]).all())
        assert float(torch.linalg.norm(L[i] @ L[i].mT - A[i]) / torch.linalg.norm(A[i])) < 1e-14
    assert torch.allclose(wA, A.sum(1))


def test_library_lu_keeps_the_linalg_preference_across_threads(cuda):
    """Concurrent library-route factors (cuSOLVER batches, which set torch's
    process-wide linear-algebra preference for the call, beside default
    ones) leave the preference as they found it, and a preference the
    caller set stays in force; each thread's factor is right."""
    import threading

    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.validation import lu_residual

    shapes = [(1, 512, 64), (4, 512, 64), (12, 256, 64), (12, 2304, 32)] * 3
    panels = [torch.from_numpy(np.random.default_rng(s).standard_normal(shape)).to(cuda)
              for s, shape in enumerate(shapes)]
    for pref in ("default", "magma"):
        torch.backends.cuda.preferred_linalg_library(pref)
        was = torch.backends.cuda.preferred_linalg_library()
        out = [None] * len(panels)

        def run(i):
            for _ in range(4):
                out[i] = blas._library_lu(panels[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(panels))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert torch.backends.cuda.preferred_linalg_library() == was
        for P, (LU, perm) in zip(panels, out):
            for i in (0, P.shape[0] - 1):
                assert lu_residual(P[i].cpu().numpy(), LU[i].cpu().numpy(),
                                   perm[i].cpu().numpy()) <= residual_bound(P.shape[1],
                                                                            torch.float64)
    torch.backends.cuda.preferred_linalg_library("default")


def _rel(x, ref):
    return float(torch.linalg.norm((x - ref).double()) / torch.linalg.norm(ref.double()))


@pytest.mark.parametrize("k", [16, 128])
def test_woodbury_capacitance_and_round_through_k3_match_plain(cuda, k):
    """The Woodbury path's K3 rounds at the drift's width on a (1024, 1024)
    plan's factors: the capacitance (k right-hand sides; k=128, the
    max_rank bucket at N=1024, takes K3's global-memory instance) and a
    Woodbury solve round, one launch each, against the same programs on
    the plain version (rel_fro 1e-5: only the summation order differs);
    each column's bits do not depend on the launch's width."""
    from conflux_tpu_torch import serve

    n = 1024
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=256)
    A = _rand((n, n), 40, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    F = plan._factor_once(A)
    U, V = _rand((n, k), 41, cuda) / np.sqrt(n), _rand((n, k), 42, cuda) / np.sqrt(n)
    b = _rand((n, 1), 43, cuda)
    before = hk.LAUNCHES["btrsm"]
    Y, Cinv, cond = plan._update_fn(k)(F, U, V)
    x = plan._update_solve_fn(k, 1, 0)(F, None, U, V, Y, Cinv, b)
    assert hk.LAUNCHES["btrsm"] == before + 2
    kernel = hk.btrsm_pair
    hk.btrsm_pair = lambda T, Dl, Du, r, perm=None, trans_back=False, wA=None: \
        hk.btrsm_pair_plain(T, Dl, Du, r, perm, trans_back, wA)
    try:
        Yp, Cp, condp = plan._update_fn(k)(F, U, V)
        xp = plan._update_solve_fn(k, 1, 0)(F, None, U, V, Yp, Cp, b)
    finally:
        hk.btrsm_pair = kernel
    assert _rel(Y, Yp) <= 1e-5 and _rel(Cinv, Cp) <= 1e-4 and _rel(x, xp) <= 1e-5
    assert abs(float(cond) - float(condp)) <= 1e-3 * float(condp)
    A1 = A.double() + U.double() @ V.double().T
    assert float((A1 @ x.double() - b.double()).abs().max()) < 1e-4
    narrow = plan._update_fn(16)(F, U[:, :16].contiguous(), V[:, :16].contiguous())[0]
    assert torch.equal(Y[:, :16], narrow)


def test_bf16_ir_tier_factor_kernels_match_plain(cuda):
    """A bf16_ir tier factor of a kernel-route (4, 512, 512) f32 plan runs
    the batched blocked factor on K2 and K1 in bf16 storage: each K1 and K2
    call against its plain version on the same operands (K1 rel_fro 2^-8,
    one bf16 rounding; K2 pivots equal, allclose 1e-5)."""
    from conflux_tpu_torch import serve

    serve.clear_plans()
    plan = serve.FactorPlan.create((4, 512, 512), torch.float32, v=128, refine=1)
    A = _rand((4, 512, 512), 44, cuda) / np.sqrt(512) + 2 * torch.eye(512, device=cuda)
    gemm, lu_block = hk.gemm, hk.lu_block
    seen = {"gemm": 0, "lu_block": 0}

    def held_gemm(a, b, c=None, alpha=1.0, beta=1.0, out=None):
        want = hk.gemm_plain(a, b, c, alpha, beta)
        got = gemm(a, b, c, alpha, beta, out=out)
        assert a.dtype == torch.bfloat16
        assert _rel(got.float(), want.float()) <= 2 ** -8
        seen["gemm"] += 1
        return got

    def held_lu_block(a, alive):
        got, want = lu_block(a, alive), hk.lu_block_plain(a, alive)
        assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        assert torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        seen["lu_block"] += 1
        return got

    hk.gemm, hk.lu_block = held_gemm, held_lu_block
    try:
        F = plan._tier_factor_once("bf16_ir", A)
    finally:
        hk.gemm, hk.lu_block = gemm, lu_block
    assert seen["gemm"] == 4 * 3 and seen["lu_block"] > 0
    assert F[0].dtype == torch.bfloat16
    s = plan.factor(A, precision="bf16_ir")
    b = _rand((4, 512), 45, cuda)
    x = s.solve(b)
    assert float((torch.einsum("bij,bj->bi", A, x) - b).abs().max()) < 1e-3


def test_woodbury_and_tier_solves_do_not_wait_for_the_card(cuda):
    """`solve` and `solve_checked` on the Woodbury and tier paths queue
    their work without a host synchronization (torch's sync debug mode
    raises on one); `update` reads the capacitance's condition on the host
    by design, outside the checked region."""
    from conflux_tpu_torch import serve

    serve.clear_plans()
    n = 512
    plan = serve.FactorPlan.create((8, n, n), torch.float32, v=256, refine=1)
    A = _rand((8, n, n), 46, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    b = _rand((8, n), 47, cuda)
    U, V = _rand((8, n, 4), 48, cuda) / n, _rand((8, n, 4), 49, cuda) / n
    drifted = plan.factor(A).update(U, V)
    tiered = plan.factor(A, precision="bf16_ir")
    calls = [lambda: drifted.solve(b), lambda: drifted.solve_checked(b),
             lambda: tiered.solve(b), lambda: tiered.solve_checked(b, precision="auto")] + [
        (lambda t=t: tiered.solve(b, precision=t)) for t in ("f32", "f64")]
    for call in calls:  # warm: derived tier factors, probe rows
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# the serving engine on the card
# --------------------------------------------------------------------------- #


def _engine_sessions(cuda, seed: int):
    """A (256, 256) and a (4, 256, 256) f32 LU session, v=128."""
    from conflux_tpu_torch import serve

    serve.clear_plans()
    n = 256
    single = serve.FactorPlan.create((n, n), torch.float32, v=128)
    batched = serve.FactorPlan.create((4, n, n), torch.float32, v=128)
    A1 = _rand((n, n), seed, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    A4 = _rand((4, n, n), seed + 1, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    return single.factor(A1), batched.factor(A4)


def test_engine_answers_bitwise_the_direct_solves_at_every_width(cuda):
    """K3's columns do not depend on the launch's width, so an engine
    answer is bitwise the direct `session.solve` at every coalesced width,
    for a single-system and a batched plan, unchecked and checked."""
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.resilience import HealthPolicy

    s1, s4 = _engine_sessions(cuda, 60)
    rng = np.random.default_rng(61)
    reqs = []
    for i, w in enumerate((1, 2, 3, 5, 8, 1, 4, 7, 2, 16)):
        s = (s1, s4)[i % 2]
        lead = (4, 256) if s is s4 else (256,)
        reqs.append((s, rng.standard_normal(lead + (w,)).astype(np.float32)))
    direct = [s.solve(torch.from_numpy(b).to(cuda)).cpu().numpy() for s, b in reqs]
    for health in (None, HealthPolicy()):
        with ServeEngine(max_batch_delay=0.05, max_coalesce_width=32, health=health) as eng:
            futs = [eng.submit(s, b) for s, b in reqs]
            got = [f.result(300) for f in futs]
            assert eng.stats()["coalesced_mean"] > 1.0
        for g, d in zip(got, direct):
            np.testing.assert_array_equal(g, d)


def test_engine_dispatcher_issues_no_host_sync(cuda):
    """After prewarm, the dispatcher stages, launches and copies answers
    back without waiting for the card: torch's sync debug mode ("error")
    would fail any request whose dispatch synchronized; only the drain
    thread waits, on each batch's event."""
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.resilience import HealthPolicy

    s1, s4 = _engine_sessions(cuda, 62)
    rng = np.random.default_rng(63)
    reqs = [((s1, s4)[i % 2], rng.standard_normal(((256,), (4, 256))[i % 2])
             .astype(np.float32)) for i in range(24)]
    for health in (None, HealthPolicy()):
        with ServeEngine(max_batch_delay=0.002, health=health) as eng:
            for s in (s1, s4):
                eng.prewarm(s, widths=(1, 2, 4, 8, 16, 32))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                futs = [eng.submit(s, b) for s, b in reqs]
                got = [f.result(300) for f in futs]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for (s, b), g in zip(reqs, got):
            np.testing.assert_array_equal(g, s.solve(torch.from_numpy(b).to(cuda)).cpu().numpy())


def test_gang_pad_and_bucket_invariance_on_the_card(cuda):
    """A gang slot's answer does not depend on the stack bucket or on what
    the pad slots hold: the resident 8-stack of an engine against a
    hand-built 2-stack whose other slot carries another session; and the
    gang's answers match each session's own solve."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.batched import stack_trees
    from conflux_tpu_torch.engine import ServeEngine

    serve.clear_plans()
    n = 256
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    A = _rand((5, n, n), 64, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    fleet = [plan.factor(A[i]) for i in range(5)]
    rng = np.random.default_rng(65)
    bs = [rng.standard_normal((n, 1)).astype(np.float32) for _ in range(5)]
    eng = ServeEngine(max_batch_delay=60.0, stack_sessions=True, max_stack=8)
    try:
        futs = [eng.submit(s, b) for s, b in zip(fleet, bs)]
    finally:
        eng.close(timeout=300)
    got = [f.result(1) for f in futs]
    assert eng.stats()["gang_batches"] == 1
    g = eng.lanes[0]._gangs[id(plan)]
    si = g.slot_of(fleet[2])
    big = torch.zeros((8, n, 1), device=cuda)
    big[si] = torch.from_numpy(bs[2]).to(cuda)
    x8 = plan._stacked_solve_fn(8, 1)(g._F, None, big)[si]
    two = torch.randn((2, n, 1), device=cuda)
    two[0] = torch.from_numpy(bs[2]).to(cuda)
    x2 = plan._stacked_solve_fn(2, 1)(stack_trees([fleet[2].factors, fleet[4].factors]),
                                      None, two)[0]
    assert torch.equal(x8, x2)
    np.testing.assert_array_equal(got[2], x8.cpu().numpy())
    for s, b, x in zip(fleet, bs, got):
        ref = s.solve(torch.from_numpy(b).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(x, ref, rtol=1e-5, atol=1e-6)


def test_engine_answers_hold_to_their_drifted_matrix_under_update_refactor(cuda):
    """A caller drifts and refactors a refine session on the default
    stream while a guarded engine serves it from its lane stream. A
    refactor never updates in place a base the lane has read, so no queued
    lane work reads a half-drifted base: every answer solves one of the
    matrices the session held (six rank-4 drifts, each refactored), to
    1e-4 relative, and no other of them."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.resilience import HealthPolicy

    serve.clear_plans()
    n, rounds, per = 256, 6, 16
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128, refine=1)
    A = _rand((n, n), 67, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    s = plan.factor(A)
    versions = [A.double().cpu()]
    rng = np.random.default_rng(68)
    bs = [rng.standard_normal((n, 1 + i % 3)).astype(np.float32) for i in range(rounds * per)]
    with ServeEngine(max_batch_delay=0.001, health=HealthPolicy()) as eng:
        eng.prewarm(s, widths=(1, 2, 4, 8, 16, 32))
        futs = []
        for r in range(rounds):
            futs += [eng.submit(s, b) for b in bs[r * per:(r + 1) * per]]
            U = torch.from_numpy(0.03 * rng.standard_normal((n, 4))).float().to(cuda)
            W = torch.from_numpy(0.03 * rng.standard_normal((n, 4))).float().to(cuda)
            s.update(U, W)
            s.refactor()
            versions.append(versions[-1] + (U @ W.mT).double().cpu())
        xs = [f.result(300) for f in futs]
    assert s.refactors == rounds
    for b, x in zip(bs, xs):
        bb, xx = torch.from_numpy(b).double(), torch.from_numpy(x).double()
        res = sorted(float((Av @ xx - bb).norm() / bb.norm()) for Av in versions)
        assert res[0] < 1e-4 and res[1] > 1e-3, res[:2]


def test_to_device_from_the_cpu_to_the_card_and_back_bitwise(cuda):
    """`to_device` moves bytes, never computes: a session moved from the
    CPU to the card and back carries its bits, keeps `_A` aliased to `_A0`
    and counts the base once."""
    from conflux_tpu_torch import serve

    serve.clear_plans()
    n = 128
    plan = serve.FactorPlan.create((n, n), torch.float32, v=64, refine=1)
    rng = np.random.default_rng(66)
    A = (rng.standard_normal((n, n)) / np.sqrt(n) + 2 * np.eye(n)).astype(np.float32)
    s = plan.factor(A, device="cpu")
    s.solve_checked(np.ones(n, np.float32))  # the probe row moves too
    before = [t.clone() for t in (*s.factors, s._A0, s._probe)]
    nbytes = s.nbytes
    s.to_device(cuda)
    assert s._A is s._A0 and s._A0.device.type == "cuda" and s.nbytes == nbytes
    assert all(t.device.type == "cuda" for t in s.factors)
    s.to_device("cpu")
    after = (*s.factors, s._A0, s._probe)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert s._A is s._A0 and s.nbytes == nbytes


# --------------------------------------------------------------------------- #
# tiered residency and the fleet checkpoint on the card
# --------------------------------------------------------------------------- #


def _tier_session(cuda, case: str):
    """A (256, 256) session of each tiered case: an f32 LU plan drifted by
    rank 3 (refine 1), a `bf16_ir` tier session (bf16 factors, int64
    permutation) and an f64 LU plan."""
    from conflux_tpu_torch import serve

    serve.clear_plans()
    n = 256
    dtype = torch.float64 if case == "f64" else torch.float32
    plan = serve.FactorPlan.create((n, n), dtype, v=128, refine=1)
    A = (_rand((n, n), 70, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)).to(dtype)
    if case == "bf16_ir":
        return plan.factor(A, precision="bf16_ir"), n
    s = plan.factor(A)
    if case == "f32_drift":
        U = (0.01 * _rand((n, 3), 71, cuda)).to(dtype)
        s.update(U, U)
    return s, n


@pytest.mark.parametrize("case", ["f32_drift", "bf16_ir", "f64"])
def test_tier_spill_disk_and_checkpoint_round_trips_bitwise(cuda, case, tmp_path):
    """Spill -> revive (host), spill -> demote -> revive (disk) and
    checkpoint -> restore give bitwise the never-spilled session's plain
    and checked answers, bf16 factors and int64 permutations included."""
    from conflux_tpu_torch import tier
    from conflux_tpu_torch.tier import ResidentSet

    s, n = _tier_session(cuda, case)
    dtypes = {str(t.dtype) for t in s.factors}
    if case == "bf16_ir":
        assert "torch.bfloat16" in dtypes and "torch.int64" in dtypes, dtypes
    b = _rand((n, 2), 72, cuda).to(s._A0.dtype)
    x0 = s.solve(b).clone()
    xc0, v0 = (t.clone() for t in s.solve_checked(b))
    leaves0 = {k: t.clone() for k, t in tier._extract_state(s)[0].items()}
    rs = ResidentSet(disk_dir=str(tmp_path / "spill"))
    rs.adopt(s)

    def same():
        xc, v = s.solve_checked(b)
        return torch.equal(x0, s.solve(b)) and torch.equal(xc0, xc) and torch.equal(v0, v)

    assert rs.spill(s) == 1 and s.tier == "host" and s.nbytes == 0
    assert same() and s.tier == "device"
    for k, t in tier._extract_state(s)[0].items():
        assert t.device.type == "cuda" and t.dtype == leaves0[k].dtype
        assert t.stride() == leaves0[k].stride() and torch.equal(t, leaves0[k]), k
    assert rs.spill(s) == 1 and rs.demote(s) == 1 and s.tier == "disk"
    assert same()
    tier.save_fleet(str(tmp_path / "ck"), [s])
    (r,) = tier.load_fleet(str(tmp_path / "ck"))
    xc, v = r.solve_checked(b)
    assert torch.equal(x0, r.solve(b)) and torch.equal(xc0, xc) and torch.equal(v0, v)


def _sync_warnings(fn) -> int:
    """The host syncs `fn` makes, as torch's sync debug mode counts them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def test_tier_spill_wave_makes_one_host_sync_and_dispatch_stays_sync_free(cuda):
    """An eviction wave of 8 sessions waits for the card once (the pinned
    copies ride one copy stream); the revivals queue their copies without
    waiting; and with a residency attached the resident dispatch path of
    the engine makes no host sync at all."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.tier import ResidentSet

    serve.clear_plans()
    n = 256
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    A = _rand((8, n, n), 73, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    fleet = [plan.factor(A[i]) for i in range(8)]
    b = _rand((n, 1), 74, cuda)
    want = [s.solve(b).clone() for s in fleet]
    rs = ResidentSet(evict_batch=8)
    rs.adopt(*fleet)
    rs.spill(*fleet[:2])  # warm the copy stream and the pinned host cache
    for s in fleet[:2]:
        rs.fault_in(s)
    assert _sync_warnings(lambda: rs.spill(*fleet)) == 1
    assert all(s.tier == "host" for s in fleet)
    assert _sync_warnings(lambda: [rs.fault_in(s) for s in fleet]) == 0
    assert all(torch.equal(w, s.solve(b)) for w, s in zip(want, fleet))
    with ServeEngine(max_batch_delay=0.002, residency=rs) as eng:
        eng.prewarm(fleet[0], widths=(1,))
        rng = np.random.default_rng(75)
        reqs = [(fleet[i % 8], rng.standard_normal(n).astype(np.float32)) for i in range(32)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [f.result(300) for f in [eng.submit(s, x) for s, x in reqs]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for (s, x), g in zip(reqs, got):
        np.testing.assert_array_equal(g, s.solve(torch.from_numpy(x).to(cuda)).cpu().numpy())


def test_tier_spill_revive_hammer_under_live_engine_traffic(cuda):
    """12 sessions over 4 resident slots behind an engine: client threads
    submit against random sessions while another thread spills and
    revives; every answer holds to its own session's A."""
    import threading

    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.tier import ResidentSet

    serve.clear_plans()
    n, S = 256, 12
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    A = _rand((S, n, n), 76, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    fleet = [plan.factor(A[i]) for i in range(S)]
    per = fleet[0].nbytes
    rs = ResidentSet(max_sessions=4, evict_batch=2)
    errs, results = [], []
    lock = threading.Lock()
    with ServeEngine(max_batch_delay=0.001, residency=rs, revive_wait=60.0) as eng:
        rs.adopt(*fleet)
        eng.prewarm(fleet[0], widths=(1, 2, 4, 8))
        stop = threading.Event()

        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(40):
                    i = int(rng.integers(S))
                    x = rng.standard_normal(n).astype(np.float32)
                    got = eng.submit(fleet[i], x).result(300)
                    with lock:
                        results.append((i, x, got))
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                errs.append(e)

        def churn():
            rng = np.random.default_rng(77)
            while not stop.is_set():
                rs.spill(fleet[int(rng.integers(S))])
                rs.spill_lru(1)
                rs.fault_in(fleet[int(rng.integers(S))])

        ch = threading.Thread(target=churn, daemon=True)
        ch.start()
        ts = [threading.Thread(target=client, args=(80 + k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        stop.set()
        ch.join(60)
    assert not errs, errs[:3]
    assert len(results) == 160
    worst = 0.0
    for i, x, got in results:
        xx = torch.from_numpy(got).to(cuda)[:, None]
        bb = torch.from_numpy(x).to(cuda)[:, None]
        worst = max(worst, float((A[i] @ xx - bb).abs().max()))
    assert worst < 1e-4, worst
    st = rs.stats()
    assert st["resident_high_water"] <= 4 and st["device_bytes_high_water"] <= 4 * per


# --------------------------------------------------------------------------- #
# the serve fabric on the card
# --------------------------------------------------------------------------- #


def _fabric_fleet(n_sessions=6, n=256, B=32):
    from conflux_tpu_torch.serve import FactorPlan

    plan = FactorPlan.create((B, n, n), torch.float32, v=128)
    mats = []
    for i in range(n_sessions):
        rng = np.random.default_rng(400 + i)
        mats.append((rng.standard_normal((B, n, n)) / np.sqrt(n)
                     + 2.0 * np.eye(n)).astype(np.float32))
    return plan, mats


def test_local_fabric_failover_and_migration_bitwise_on_the_card(cuda, tmp_path):
    """Three in-process hosts on the card: every answer bitwise the
    direct solve, and bitwise again after a host is killed (its fleet
    revived from its checkpoint on the survivors) and after a migration."""
    import time

    from conflux_tpu_torch import fabric

    plan, mats = _fabric_fleet()
    rng = np.random.default_rng(7)
    fab = fabric.local_fabric(3, str(tmp_path), engine_kwargs={"max_batch_delay": 0.0},
                              policy=fabric.FabricPolicy(heartbeat_interval=0.1,
                                                         heartbeat_timeout=30.0))
    try:
        fab.start()
        sids = [f"s{i}" for i in range(len(mats))]
        rhs = {s: rng.standard_normal((32, 256, 2)).astype(np.float32) for s in sids}
        ref = {}
        for s, A in zip(sids, mats):
            fab.open(s, plan, A)
            ref[s] = np.asarray(fab.solve(s, rhs[s]))
            direct = plan.factor(A).solve(torch.from_numpy(rhs[s]).to(cuda)).cpu().numpy()
            assert np.array_equal(ref[s], direct), s
        victim = fab.owner_of("s0")
        owned = [s for s in sids if fab.owner_of(s) == victim]
        fab._hosts[victim].kill()
        t0 = time.perf_counter()
        rec = None
        while rec is None and time.perf_counter() - t0 < 60.0:
            rec = next((r for r in fab.stats()["recoveries"] if r["host"] == victim), None)
            time.sleep(0.02)
        assert rec is not None and rec["adopted"] == len(owned) and rec["lost"] == 0
        for s in sids:
            assert np.array_equal(np.asarray(fab.solve(s, rhs[s])), ref[s]), s
        mig = next(s for s in sids if s not in owned)
        src = fab.owner_of(mig)
        assert fab.migrate(mig) != src
        assert np.array_equal(np.asarray(fab.solve(mig, rhs[mig])), ref[mig])
    finally:
        fab.close()


def test_process_fabric_two_workers_on_the_card_answer_bitwise(cuda, tmp_path):
    """Two worker processes on the one card over the shm wire answer
    bitwise the direct solves of this process, and each worker's K3 and
    K4 launches come back through the host `stats` op."""
    from conflux_tpu_torch import fabric
    from conflux_tpu_torch.engine import rendezvous
    from conflux_tpu_torch.ops import _build

    _build.load()  # the workers reuse this build
    plan, mats = _fabric_fleet(n_sessions=4)
    rng = np.random.default_rng(8)
    sids, i = [], 0
    while len({rendezvous(s, ["h0", "h1"]) for s in sids}) < 2 or len(sids) < 4:
        sids = [f"w{j}" for j in range(i, i + 4)]
        i += 1
    fab = fabric.process_fabric(2, str(tmp_path), engine_kwargs={"max_batch_delay": 0.0},
                                policy=fabric.FabricPolicy(heartbeat_timeout=60.0),
                                start_timeout=300.0)
    try:
        fab.start()
        for s, A in zip(sids, mats):
            fab.open(s, plan, A)
            b = rng.standard_normal((32, 256)).astype(np.float32)
            got = np.asarray(fab.solve(s, b))
            direct = plan.factor(A).solve(torch.from_numpy(b).to(cuda)).cpu().numpy()
            assert np.array_equal(got, direct), s
        for hid in ("h0", "h1"):
            st = fab._hosts[hid].stats()
            assert st["launches"]["batched_lu"] == len(st["sids"]) >= 1
            assert st["launches"]["btrsm"] >= len(st["sids"])
    finally:
        fab.close()


# --------------------------------------------------------------------------- #
# the distributed factorizations on the card
# --------------------------------------------------------------------------- #


def _grid_factor(kind, device, gridspec=(1, 1, 1), transport=None, N=1024, v=128):
    """(gathered factors, perm) of a distributed LU or Cholesky on the
    kernel routes over a threaded world on `device` (the kernels on the
    card, their plain versions on the CPU), on the same operands."""
    from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards, run_threaded
    from conflux_tpu_torch.validation import make_spd_matrix

    grid = Grid3(*gridspec)
    if kind == "lu":
        geom = LUGeometry.create(N, N, v, grid)
        A = make_test_matrix(N, N, seed=7, dtype=np.float32)
    else:
        geom = CholeskyGeometry.create(N, v, grid)
        A = make_spd_matrix(N, dtype=np.float32).numpy()
    S = geom.scatter(A)

    def fn(mesh):
        shard = distribute_shards(S, mesh)
        if kind == "lu":
            out, perm = lu_factor_distributed(shard, geom, mesh)
        else:
            out, perm = cholesky_factor_distributed(shard, geom, mesh), None
        return gather_shards(out, mesh).cpu().numpy(), perm

    full, perm = run_threaded(grid, fn, device=device, transport=transport, timeout=600.0)[0]
    return A, geom.gather(full), None if perm is None else perm.cpu().numpy()


@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_distributed_factor_on_the_card_matches_its_plain_version_run(cuda, kind):
    """1x1x1 at N=1024, v=128: K1 and K2 on the card against the same code
    on the CPU (the plain versions), on the same operands: the same pivots,
    factors within the float32 bar, and the launches counted."""
    from conflux_tpu_torch.validation import cholesky_residual

    before = dict(hk.LAUNCHES)
    A, got, perm = _grid_factor(kind, "cuda")
    assert hk.LAUNCHES["gemm"] > before["gemm"]
    if kind == "lu":
        assert hk.LAUNCHES["lu_block"] > before["lu_block"]
    _, want, perm_cpu = _grid_factor(kind, "cpu")
    bar = residual_bound(1024, np.float32)
    if kind == "lu":
        from conflux_tpu_torch.validation import lu_residual

        np.testing.assert_array_equal(perm, perm_cpu)
        assert lu_residual(A.astype(np.float64), got, perm) < bar
    else:
        got, want = np.tril(got), np.tril(want)
        assert cholesky_residual(A.astype(np.float64), got) < bar
    assert np.abs(got - want).max() <= bar * np.abs(want).max()


def test_two_ranks_on_one_card_over_the_staged_transport(cuda):
    """A threaded 2x1x1 world on cuda:0 ("staged": gloo on host copies of
    the messages): the pivots of the CPU world, the residual within the
    bar."""
    from conflux_tpu_torch.validation import lu_residual

    A, got, perm = _grid_factor("lu", "cuda", (2, 1, 1), "staged", N=512)
    _, _want, perm_cpu = _grid_factor("lu", "cpu", (2, 1, 1), "gloo", N=512)
    np.testing.assert_array_equal(perm, perm_cpu)
    assert lu_residual(A.astype(np.float64), got, perm) < residual_bound(512, np.float32)


def _grid_qr(device, gridspec=(1, 1, 1), transport=None, N=1024, v=128,
             dtype=torch.float32):
    """(A, Q, R) of the block-cyclic QR on the kernel route over a threaded
    world on `device` (K1 on the card, its plain version on the CPU)."""
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards, run_threaded
    from conflux_tpu_torch.qr.distributed import qr_factor_distributed, r_geometry

    grid = Grid3(*gridspec)
    geom = LUGeometry.create(N, N, v, grid)
    A = make_test_matrix(N, N, seed=9, dtype=np.float32)
    S = geom.scatter(A)

    def fn(mesh):
        Q, R = qr_factor_distributed(distribute_shards(S, mesh).to(dtype), geom, mesh)
        return (gather_shards(Q.float(), mesh).cpu().numpy(),
                gather_shards(R.float(), mesh).cpu().numpy())

    Qs, Rs = run_threaded(grid, fn, device=device, transport=transport, timeout=600.0)[0]
    return A, geom.gather(Qs), np.triu(r_geometry(geom).gather(Rs)[:N, :N])


def test_distributed_qr_on_the_card_matches_its_plain_version_run(cuda):
    """1x1x1 at N=1024, v=128: the trailing update on K1 (the launches the
    code predicts) against the same code on the CPU, where K1's plain
    version runs, on the same operands: Q and R within the float32 bar."""
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.qr.distributed import gemm_launches

    before = hk.LAUNCHES["gemm"]
    A, Q, R = _grid_qr("cuda")
    assert hk.LAUNCHES["gemm"] - before == gemm_launches(
        LUGeometry.create(1024, 1024, 128, Grid3(1, 1, 1)))
    _, Qc, Rc = _grid_qr("cpu")
    bar = residual_bound(1024, np.float32)
    A64 = A.astype(np.float64)
    assert np.linalg.norm(Q @ R - A64) / np.linalg.norm(A64) < bar
    assert np.linalg.norm(Q.T.astype(np.float64) @ Q - np.eye(1024)) / 32 < bar
    assert np.abs(Q - Qc).max() <= bar and np.abs(R - Rc).max() <= bar * np.abs(Rc).max()


def test_distributed_qr_bf16_shards_on_the_card(cuda):
    """bfloat16 shards: panels in float32, the trailing update on K1's
    bfloat16 instance; reconstruction and orthogonality within the bf16
    bar (tests/test_qr.py's), as the same code on the CPU."""
    before = hk.LAUNCHES["gemm"]
    A, Q, R = _grid_qr("cuda", N=512, v=64, dtype=torch.bfloat16)
    assert hk.LAUNCHES["gemm"] > before
    A64 = A.astype(np.float64)
    bar = 0.5 * 2.0 ** -7 * np.sqrt(512)
    for Qx, Rx in ((Q, R), _grid_qr("cpu", N=512, v=64, dtype=torch.bfloat16)[1:]):
        assert np.linalg.norm(Qx @ Rx - A64) / np.linalg.norm(A64) < bar
        assert np.linalg.norm(Qx.T.astype(np.float64) @ Qx - np.eye(512)) / np.sqrt(512) < bar


def test_tsqr_two_ranks_on_one_card_bitwise_r(cuda):
    """A threaded 2x1x1 tsqr_distributed on cuda:0 over "staged": R bitwise
    on both ranks, Q R = A within the float32 bar, both trees."""
    from conflux_tpu_torch.geometry import Grid3
    from conflux_tpu_torch.parallel.mesh import run_threaded
    from conflux_tpu_torch.qr.distributed import tsqr_distributed

    A = make_test_matrix(8192, 64, seed=3, dtype=np.float32)
    for tree in ("gather", "butterfly"):
        def fn(mesh):
            Q, R = tsqr_distributed(A.reshape(2, 4096, 64), mesh, tree=tree)
            return mesh.all_gather(Q, "x").cpu().numpy().reshape(8192, 64), R.cpu().numpy()

        (Q, R), (Q1, R1) = run_threaded(Grid3(2, 1, 1), fn, device="cuda", transport="staged",
                                        timeout=600.0)
        np.testing.assert_array_equal(R, R1)
        A64 = A.astype(np.float64)
        assert np.linalg.norm(Q @ R - A64) / np.linalg.norm(A64) < residual_bound(64, np.float32)


def test_native_scatter_is_bitwise_numpy_on_the_cards_machine(monkeypatch):
    """The native host library built on this machine (its own CPU: the
    build is keyed by it) against the numpy path, f32 and f64."""
    from conflux_tpu_torch import native
    from conflux_tpu_torch.geometry import Grid3, LUGeometry

    for dtype in (np.float32, np.float64):
        geom = LUGeometry.create(1024, 768, 64, Grid3(2, 3, 1))
        A = np.random.default_rng(0).standard_normal((1024, 768)).astype(dtype)
        fast = geom.scatter(A)
        assert native.scatter(A, 64, 2, 3) is not None
        back = geom.gather(fast)
        with monkeypatch.context() as m:
            m.setattr(native, "scatter", lambda *a: None)
            m.setattr(native, "gather", lambda *a: None)
            np.testing.assert_array_equal(fast, geom.scatter(A))
            np.testing.assert_array_equal(back, geom.gather(fast))
        np.testing.assert_array_equal(back, A)


def test_drifted_engine_answers_bitwise_alone_and_coalesced_on_the_card(cuda):
    """The Woodbury correction runs each column alone: a drifted session's
    answers are bitwise the same alone and coalesced (2 and 16 requests
    of width 2 into one solve)."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import ServeEngine

    serve.clear_plans()
    N, k = 1024, 16
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
    session = serve.FactorPlan.create((N, N), torch.float32, v=256).factor(A)
    session.update((rng.standard_normal((N, k)) / N).astype(np.float32),
                   (rng.standard_normal((N, k)) / N).astype(np.float32))
    reqs = [rng.standard_normal((N, 2)).astype(np.float32) for _ in range(16)]
    with ServeEngine(max_batch_delay=0.0) as eng:
        alone = [eng.solve(session, b, timeout=120) for b in reqs]
    for burst in (2, 16):
        with ServeEngine(max_batch_delay=0.5, max_coalesce_width=2 * burst) as eng:
            got = [f.result(timeout=120) for f in [eng.submit(session, b)
                                                   for b in reqs[:burst]]]
            assert eng.stats()["batches"] < burst
        for x, ref in zip(got, alone):
            np.testing.assert_array_equal(x, ref)


# --------------------------------------------------------------------------- #
# the mesh lane and several lanes on one card
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["lu", "chol"])
def test_mesh_plan_over_two_shards_of_one_card_bitwise_the_one_device_plan(cuda, kind):
    """A (8, 256, 256) mesh plan over two shards of cuda:0: its factor
    launches K4 (K5) once per shard, each solve round K3 once per shard,
    and factors, plain and checked solves are bitwise the one-device
    plan's of the same batch (K3, K4 and K5 run one cluster per slot)."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.batched import batch_mesh, gather_batch

    serve.clear_plans()
    B, n = 8, 256
    fac = "batched_lu" if kind == "lu" else "batched_chol"
    A = _rand((B, n, n), 71, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
    if kind == "chol":
        A = A @ A.mT + torch.eye(n, device=cuda)
    mp = serve.FactorPlan.create((B, n, n), torch.float32, v=128, kind=kind,
                                 mesh=batch_mesh([cuda, cuda]))
    op = serve.FactorPlan.create((B, n, n), torch.float32, v=128, kind=kind)
    hk.reset_launches()
    s = mp.factor(A)
    torch.cuda.synchronize()
    assert hk.LAUNCHES[fac] == 2 and s.device is None
    o = op.factor(A)
    for f, g in zip(s.factors, o.factors):
        assert torch.equal(gather_batch(f), g)
    b = _rand((B, n, 3), 72, cuda)
    hk.reset_launches()
    x = s.solve(b)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["btrsm"] == 2
    assert torch.equal(x, o.solve(b))
    (xs, vs), (xo, vo) = s.solve_checked(b), o.solve_checked(b)
    assert torch.equal(xs, xo) and torch.equal(vs, vo) and float(vs[0]) == 1.0


def test_two_lane_engine_bitwise_the_one_lane_engine(cuda):
    """Two lanes on one card (two streams): the answers of a mixed trace
    and of pooled cold starts are bitwise the one-lane engine's, and both
    lanes serve."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import ServeEngine

    serve.clear_plans()
    B, n = 8, 256
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    rng = np.random.default_rng(73)
    mats = [(rng.standard_normal((B, n, n)) / np.sqrt(n) + 2 * np.eye(n)).astype(np.float32)
            for _ in range(6)]
    trace = [(i % 4, rng.standard_normal((B, n, 1 + i % 3)).astype(np.float32))
             for i in range(48)]
    answers, opened = {}, {}
    for devices in ([cuda], [cuda, cuda]):
        with ServeEngine(max_batch_delay=0.002, devices=devices) as eng:
            sessions = [plan.factor(mats[i], sid=f"lane-{i}") for i in range(4)]
            eng.prewarm(sessions[0], widths=(1, 2, 4, 8, 16, 32), factor_batches=(1, 2))
            futs = [eng.submit(sessions[i], b) for i, b in trace]
            answers[len(devices)] = [f.result(300) for f in futs]
            cold = [eng.submit_factor(plan, m) for m in mats[4:]]
            opened[len(devices)] = [f.result(300).solve(trace[0][1]).cpu() for f in cold]
            if len(devices) == 2:
                assert all(r["batches"] >= 1 for r in eng.stats()["lanes"])
    for a, b in zip(answers[1], answers[2]):
        assert np.array_equal(a, b)
    for a, b in zip(opened[1], opened[2]):
        assert torch.equal(a, b)


def test_refactor_under_traffic_on_two_lanes_holds_to_the_drifted_matrix(cuda):
    """The stream race class of the one-lane engine, on two lanes of one
    card: callers drift and refactor two refine sessions, each pinned to
    its own lane, on the default stream while the lanes serve them. Every
    answer solves one of the matrices its session held, to 1e-4, and no
    other of them."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.resilience import HealthPolicy

    serve.clear_plans()
    n, rounds, per = 256, 4, 12
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128, refine=1)
    rng = np.random.default_rng(74)
    with ServeEngine(max_batch_delay=0.001, health=HealthPolicy(),
                     devices=[cuda, cuda]) as eng:
        sids = []
        i = 0
        while len(sids) < 2:
            if eng.placement_lane(f"r{i}").index == len(sids):
                sids.append(f"r{i}")
            i += 1
        ss, versions = [], []
        for k, sid in enumerate(sids):
            A = _rand((n, n), 75 + k, cuda) / np.sqrt(n) + 2 * torch.eye(n, device=cuda)
            ss.append(plan.factor(A, sid=sid))
            versions.append([A.double().cpu()])
        assert [eng._lane_for(s).index for s in ss] == [0, 1]
        eng.prewarm(ss[0], widths=(1, 2, 4, 8, 16, 32))
        bs = [rng.standard_normal((n, 1 + j % 3)).astype(np.float32)
              for j in range(rounds * per)]
        futs = []
        for r in range(rounds):
            for j in range(r * per, (r + 1) * per):
                futs.append((j % 2, bs[j], eng.submit(ss[j % 2], bs[j])))
            for k, s in enumerate(ss):
                U = torch.from_numpy(0.03 * rng.standard_normal((n, 4))).float().to(cuda)
                W = torch.from_numpy(0.03 * rng.standard_normal((n, 4))).float().to(cuda)
                s.update(U, W)
                s.refactor()
                versions[k].append(versions[k][-1] + (U @ W.mT).double().cpu())
        xs = [(k, b, f.result(300)) for k, b, f in futs]
    for k, b, x in xs:
        bb, xx = torch.from_numpy(b).double(), torch.from_numpy(x).double()
        res = sorted(float((Av @ xx - bb).norm() / bb.norm()) for Av in versions[k])
        assert res[0] < 1e-4 and res[1] > 1e-3, res[:2]


def test_phase_table_of_a_traced_grid_lu_attributes_every_k1_and_k2_launch(cuda, tmp_path):
    """The grid LU at N=4096 (v=512, 1x1x1) traced on the card: every
    phase of the reference's program in the table, every device event
    counted once, every K1 launch under step6_dgemm and every K2 launch
    under step1_pivoting, and the traced factor bitwise the untraced."""
    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.lu.distributed import build_program
    from conflux_tpu_torch.parallel.mesh import make_mesh

    geom = LUGeometry.create(4096, 4096, 512, Grid3(1, 1, 1))
    mesh = make_mesh(Grid3(1, 1, 1))
    A = _rand((4096, 4096), 71, cuda)
    A.diagonal().add_(2.0)
    prog = build_program(geom, mesh, dtype=torch.float32)
    want, want_perm = prog(A, mesh)
    torch.cuda.synchronize()
    hk.reset_launches()
    with profiler.trace(str(tmp_path)):
        got, perm = prog(A, mesh)
    launched = dict(hk.LAUNCHES)
    assert torch.equal(got, want) and torch.equal(perm, want_perm)
    table = profiler.phase_table(str(tmp_path))
    assert {"step0_reduce", "step1_pivoting", "step2_pivotrows", "step4_dtrsm",
            "step5_dtrsm", "step6_dgemm", "step7_writes"} <= set(table)
    durs = profiler._trace_durations(str(tmp_path))
    assert sum(n for _ms, n in table.values()) == sum(n for _nm, _ms, n in durs.values())
    phases = profiler.launch_phases(str(tmp_path))
    k1 = [p for p, name, _ms, _n in phases.values()
          if "gemm_tma_kernel" in name or "gemm_simt_kernel" in name]
    k2 = [p for p, name, _ms, _n in phases.values() if "lu_block_kernel" in name]
    assert len(k1) == launched["gemm"] > 0 and set(k1) == {"step6_dgemm"}
    assert len(k2) == launched["lu_block"] > 0 and set(k2) == {"step1_pivoting"}


def test_serve_engine_under_lockcheck_on_the_card(cuda):
    """A short engine run on the card (a factor through the factor lane,
    coalesced solves) under the runtime lock-order harness: no lock-order
    cycle, no engine lock held across a serve.* dispatch region, answers
    within the solve bar."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.analysis import lockcheck
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.resilience import HealthPolicy

    serve.clear_plans()
    rng = np.random.default_rng(72)
    N = 256
    A = (rng.standard_normal((N, N)) / 16 + 2.0 * np.eye(N)).astype(np.float32)
    bs = [rng.standard_normal((N, w)).astype(np.float32) for w in (1, 2, 1, 4) * 4]
    with lockcheck.watch() as lc:
        plan = serve.FactorPlan.create((N, N), torch.float32, v=128)
        eng = ServeEngine(max_batch_delay=0.002, health=HealthPolicy(),
                          watchdog_interval=0.05)
        try:
            sess = eng.factor(plan, A, timeout=300)
            xs = [f.result(300) for f in [eng.submit(sess, b) for b in bs]]
        finally:
            eng.close(timeout=300)
    rep = lc.report()
    assert rep["violations"] == [] and rep["acquisitions"] > 0, rep
    for x, b in zip(xs, bs):
        assert float(np.abs(A.astype(np.float64) @ x - b).max()) < 1e-4


# --------------------------------------------------------------------------- #
# matmul precision: the TF32 library product
# --------------------------------------------------------------------------- #


def _tf32_operands(cuda, M=1024, K=512, N=768):
    g = torch.Generator(device="cpu").manual_seed(16)
    return (torch.randn(M, K, generator=g).to(cuda), torch.randn(K, N, generator=g).to(cuda))


def test_tf32_product_error_lies_between_ieee_and_the_tf32_bar(cuda):
    """HIGH on backend "xla" is one TF32 pass: its error against a float64
    product is at least 10x the IEEE product's and within the TF32 bar
    (unit roundoff 2^-11 times sqrt(K) of the largest entry, a loose
    bound on the sum of K rounded products)."""
    from conflux_tpu_torch.ops import blas

    a, b = _tf32_operands(cuda)
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    calls = blas.TF32_CALLS
    tf = blas.gemm(a, b, None, 1.0, 1.0, "high", "xla")
    ie = blas.gemm(a, b, None, 1.0, 1.0, "highest", "xla")
    assert blas.TF32_CALLS == calls + 1
    err_tf = float((tf.double() - ref).abs().max()) / scale
    err_ie = float((ie.double() - ref).abs().max()) / scale
    assert 10 * err_ie <= err_tf <= 2 ** -11 * a.shape[1] ** 0.5
    assert not torch.backends.cuda.matmul.allow_tf32


def test_highest_library_product_is_bitwise_torch_matmul_with_tf32_off(cuda):
    from conflux_tpu_torch.ops import blas

    a, b = _tf32_operands(cuda)
    assert torch.equal(blas.gemm(a, b, None, 1.0, 1.0, "highest", "xla"), a @ b)
    c = torch.randn(a.shape[0], b.shape[1], device=cuda)
    want = torch.addmm(c, a, b, beta=0.5, alpha=-1.0)
    blas.gemm(a, b, c, -1.0, 0.5, None, "xla", out=c)
    assert torch.equal(c, want)


def test_tf32_product_batched_in_place_complex_and_broadcast(cuda):
    from conflux_tpu_torch.ops import blas

    g = torch.Generator(device="cpu").manual_seed(17)
    A = torch.randn(3, 96, 64, generator=g).to(cuda)
    B = torch.randn(64, 80, generator=g).to(cuda)
    C = torch.randn(3, 96, 80, generator=g).to(cuda)
    want = 0.5 * C.double() - (A.double() @ B.double())
    got = C.clone()
    blas.gemm(A, B, got, -1.0, 0.5, "default", "xla", out=got)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 2 ** -9
    Z = torch.randn(40, 24, dtype=torch.complex64, generator=g).to(cuda)
    zw = (Z.mH.to(torch.complex128) @ Z.to(torch.complex128))
    zg = blas.matmul(Z.mH, Z, "high")
    assert zg.dtype == torch.complex64
    assert float((zg.to(torch.complex128) - zw).abs().max() / zw.abs().max()) <= 2 ** -9


@pytest.mark.parametrize("batched", [False, True])
def test_tf32_product_into_a_strided_block_of_a_larger_matrix(cuda, batched):
    """The grid programs' trailing update on backend "xla" at HIGH: C -= A B
    in place (alpha -1, beta 1) on a block of a larger matrix (ldc > N),
    with A and B strided views too. The block is within the TF32 product
    bar of a float64 product; every entry outside it is untouched."""
    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.validation import TF32_EPS

    g = torch.Generator(device="cpu").manual_seed(19)
    lead = (3,) if batched else ()
    M, K, N = 200, 96, 152
    G = torch.randn(*lead, 512, 640, generator=g).to(cuda)
    P = torch.randn(*lead, 384, 320, generator=g).to(cuda)
    Q = torch.randn(256, 448, generator=g).to(cuda)
    C = G[..., 64:64 + M, 128:128 + N]
    A = P[..., 32:32 + M, 16:16 + K]
    B = Q[40:40 + K, 8:8 + N]
    assert C.stride(-2) == 640 > N and A.stride(-2) > K and B.stride(-2) > N
    G0 = G.clone()
    want = C.double() - A.double() @ B.double()
    scale = float((A.double() @ B.double()).abs().max())
    calls = blas.TF32_CALLS
    got = blas.gemm(A, B, C, -1.0, 1.0, "high", "xla", out=C)
    torch.cuda.synchronize()
    assert got.data_ptr() == C.data_ptr() and blas.TF32_CALLS == calls + 1
    assert float((C.double() - want).abs().max()) / scale <= TF32_EPS * K ** 0.5
    outside = torch.ones_like(G, dtype=torch.bool)
    outside[..., 64:64 + M, 128:128 + N] = False
    assert torch.equal(G[outside], G0[outside])


def test_ieee_products_stay_bitwise_while_another_thread_runs_tf32(cuda):
    """The TF32 choice is the call's own compute type: 200 IEEE products in
    one thread stay bitwise while another thread runs TF32 products."""
    import threading

    from conflux_tpu_torch.ops import blas

    a, b = _tf32_operands(cuda)
    want = blas.gemm(a, b, None, 1.0, 1.0, "highest", "xla")
    torch.cuda.synchronize()
    bad = []

    def ieee():
        torch.cuda.set_device(a.device)
        for i in range(200):
            if not torch.equal(blas.gemm(a, b, None, 1.0, 1.0, "highest", "xla"), want):
                bad.append(i)

    def tf32():
        torch.cuda.set_device(a.device)
        for _ in range(200):
            blas.gemm(a, b, None, 1.0, 1.0, "high", "xla")

    ts = [threading.Thread(target=ieee), threading.Thread(target=tf32)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    torch.cuda.synchronize()
    assert not bad


@pytest.mark.parametrize("kind", ["lu", "chol"])
def test_default_kernel_plan_is_bitwise_the_highest_plan(cuda, kind):
    """K4/K5 and K3 take no precision: a kernel plan at DEFAULT factors and
    solves bitwise the HIGHEST plan, through the same launches."""
    from conflux_tpu_torch import serve

    rng = np.random.default_rng(18)
    B, N = 4, 256
    M = (rng.standard_normal((B, N, N)) / np.sqrt(N) + 2 * np.eye(N)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + np.eye(N, dtype=np.float32) if kind == "chol" else M
    b = rng.standard_normal((B, N)).astype(np.float32)
    serve.clear_plans()
    low = serve.FactorPlan.create((B, N, N), torch.float32, v=128, kind=kind,
                                  precision="default")
    high = serve.FactorPlan.create((B, N, N), torch.float32, v=128, kind=kind)
    assert low is not high
    hk.reset_launches()
    x_low = low.factor(A).solve(b)
    counts = dict(hk.LAUNCHES)
    x_high = high.factor(A).solve(b)
    assert torch.equal(x_low, x_high)
    assert counts["btrsm"] == 1 and counts["batched_lu" if kind == "lu" else "batched_chol"] == 1


def test_tuning_sweep_smallest_config_on_both_backends(cuda):
    """`scripts/torch_tune.py` at its smallest config on each backend: one
    record each, finite, the HIGHEST LU within residual_bound(N, f32) and
    the TF32 one (HIGH on "xla") within the TF32 bar."""
    import importlib.util
    import os

    from conflux_tpu_torch.ops import blas

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_tune.py")
    spec = importlib.util.spec_from_file_location("torch_tune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    prev = blas.get_backend()
    rows = []
    try:
        for backend in ("kernel", "xla"):
            blas.set_backend(backend)
            assert mod.main(["-N", "4096", "--reps", "1", "--configs",
                             "highest:0:1024,high:0:1024"], rows) == 0
    finally:
        blas.set_backend(prev)
    assert [(r["backend"], r["precision"]) for r in rows] == [
        ("kernel", "highest"), ("kernel", "high"), ("xla", "highest"), ("xla", "high")]
    assert all(np.isfinite(r["residual"]) and r["gflops"] > 0 for r in rows)
    assert rows[0]["meets_f32_bar"] and rows[1]["meets_f32_bar"] and rows[2]["meets_f32_bar"]
    assert all(r["meets_bar"] for r in rows)  # the TF32 factor within the TF32 bar


# --------------------------------------------------------------------------- #
# complex grids and the soaks (`scripts/torch_soak.py`) on the card
# --------------------------------------------------------------------------- #


def test_complex64_grid_lu_over_staged_ranks(cuda):
    """A complex64 LU on a threaded 2x2x1 world sharing cuda:0 over "staged"
    (the collectives carry complex tensors as their real and imaginary
    parts): the pivots of the same code on the CPU, factors within the
    float32 bar of each other, the residual within it."""
    from conflux_tpu_torch.geometry import Grid3
    from conflux_tpu_torch.lu.distributed import lu_distributed_host
    from conflux_tpu_torch.parallel.mesh import run_threaded
    from conflux_tpu_torch.validation import lu_residual

    N, v, grid = 64, 8, Grid3(2, 2, 1)
    rng = np.random.default_rng(5)
    A = (rng.uniform(-1, 1, (N, N)) + 1j * rng.uniform(-1, 1, (N, N))).astype(np.complex64)
    A[np.arange(N), np.arange(N)] += 2.0 + 2.0j

    def run(device, transport):
        return run_threaded(grid, lambda mesh: lu_distributed_host(
            A, grid, v, mesh=mesh, backend="xla", panel_algo="auto")[:2],
            device=device, transport=transport, timeout=600.0)

    got = run("cuda", "staged")
    for LU, perm in got[1:]:
        np.testing.assert_array_equal(LU, got[0][0])
    LU, perm = got[0]
    LUc, perm_c = run("cpu", "gloo")[0]
    bar = residual_bound(N, np.float32)
    assert LU.dtype == np.complex64
    np.testing.assert_array_equal(perm, perm_c)
    assert np.abs(LU - LUc).max() <= bar
    assert lu_residual(A, LU[perm], perm) < bar


def _soak_module():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts",
                        "torch_soak.py")
    spec = importlib.util.spec_from_file_location("torch_soak_on_the_card", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ENGINE["device"] = "cuda"
    return mod


@pytest.mark.parametrize("seed,core", [(114, "lu"), (7, "cholesky"), (176, "qr")])
def test_configuration_soak_trial_on_the_card(cuda, seed, core):
    """One configuration trial per core on threaded ranks sharing cuda:0
    over "staged", each a float32 draw on backend "kernel": the trial's
    oracles pass and its trailing updates launch K1."""
    mod = _soak_module()
    cfg = mod.config(seed)
    assert cfg["core"] == core and cfg["backend"] == "kernel" and cfg["grid"] != (1, 1, 1)
    before = hk.LAUNCHES["gemm"]
    ok, msg = mod.run_trial(seed)
    assert ok, msg
    assert hk.LAUNCHES["gemm"] > before


@pytest.mark.parametrize("mode", ["fleet", "mesh"])
def test_serving_soak_trial_on_the_card(cuda, mode):
    """One trial of `torch_soak.py --fleet` (several lanes of cuda:0, lane
    kills) and of `--mesh` (batch-mesh shards of cuda:0 under the tier
    fault sites): the trial's invariants hold, and K3 and K4 launch."""
    mod = _soak_module()
    before = dict(hk.LAUNCHES)
    ok, msg = mod.TRIALS[mode](0)
    assert ok, msg
    assert hk.LAUNCHES["btrsm"] > before["btrsm"]
    assert hk.LAUNCHES["batched_lu"] > before["batched_lu"]
