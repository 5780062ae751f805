"""Parity of the port's whole blocked solve round (`hopper_kernels.btrsm_pair`,
K3's round mode, and its plain version) with the JAX package's composition
of two blocked solves, on the CPU: the same seeded numpy inputs through
both. LU rounds solve T y = b[perm] through the unit lower triangle and
its block inverses Dl, then T x = y through the upper triangle and Du;
SPD rounds solve L y = b, then L^T x = y through Dl^T (read transposed in
place, no copy). n = 48 is ragged against the 32-wide blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import batched_trsm as jbt
from conflux_tpu_torch.ops import batched_trsm as tbt
from conflux_tpu_torch.ops import hopper_kernels as hk

# relative Frobenius: the two packages sum in other orders
# (tests/test_torch_batched_trsm.py's _TOL)
_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _case(kind, B, n, k, dtype, seed):
    """(T, Dl, Du, b, perm) as numpy: a packed LU-like operand (both
    triangles hold data) for "lu", a Cholesky factor for "spd"."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    if kind == "spd":
        A = np.linalg.cholesky(A @ np.swapaxes(A, 1, 2) + np.eye(n))
    T = torch.from_numpy(A.astype(dtype))
    unit = kind == "lu"
    Dl = tbt.diag_block_inverses(T, lower=True, unit_diagonal=unit).numpy()
    Du = tbt.diag_block_inverses(T, lower=False).numpy() if unit else None
    b = rng.standard_normal((B, n, k)).astype(dtype)
    perm = np.stack([rng.permutation(n) for _ in range(B)]) if unit else None
    return T.numpy(), Dl, Du, b, perm


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jax_round(T, Dl, Du, b, perm, solve):
    """The JAX serve programs' round, system by system, through `solve`
    (T, D, rhs, lower) -> x."""
    out = []
    for i in range(T.shape[0]):
        if perm is None:  # SPD: back through L^T and Dl^T
            y = solve(T[i], Dl[i], b[i], True)
            out.append(solve(T[i].T, np.swapaxes(Dl[i], -1, -2), y, False))
        else:
            y = solve(T[i], Dl[i], b[i][perm[i]], True)
            out.append(solve(T[i], Du[i], y, False))
    return np.stack(out)


def _blocked_solve(T, D, r, lower):
    return np.asarray(jbt.blocked_solve(jnp.asarray(T), jnp.asarray(D),
                                        jnp.asarray(np.asarray(r)), lower=lower))


PAIR_CASES = [(kind, n, k, dtype) for kind in ("lu", "spd") for n in (48, 64)
              for k in (1, 3) for dtype in (np.float32, np.float64)]


@pytest.mark.parametrize("kind,n,k,dtype", PAIR_CASES)
def test_pair_plain_matches_jax_blocked_solves(kind, n, k, dtype):
    T, Dl, Du, b, perm = _case(kind, 3, n, k, dtype, n + k)
    want = _jax_round(T, Dl, Du, b, perm, _blocked_solve)
    before = hk.LAUNCHES["btrsm"]
    got = hk.btrsm_pair(_t(T), _t(Dl), _t(Du), _t(b), perm=_t(perm),
                        trans_back=kind == "spd")
    assert hk.LAUNCHES["btrsm"] == before  # the CPU runs no kernel
    assert got.dtype == _t(b).dtype and tuple(got.shape) == b.shape
    assert _rel(got.numpy(), want) <= _TOL[dtype]


@pytest.mark.parametrize("kind,n", [("lu", 48), ("spd", 64)])
def test_pair_plain_matches_pallas_interpret(kind, n):
    """Both substitutions of the JAX round through the Pallas kernel
    (interpret mode off the TPU), batched."""
    T, Dl, Du, b, perm = _case(kind, 4, n, 3, np.float32, 5 + n)
    r = b if perm is None else np.take_along_axis(b, perm[:, :, None], 1)
    y = jbt.pallas_blocked_trsm(jnp.asarray(T), jnp.asarray(Dl), jnp.asarray(r), lower=True)
    if kind == "spd":
        want = jbt.pallas_blocked_trsm(jnp.asarray(np.swapaxes(T, 1, 2)),
                                       jnp.asarray(np.swapaxes(Dl, -1, -2)), y, lower=False)
    else:
        want = jbt.pallas_blocked_trsm(jnp.asarray(T), jnp.asarray(Du), y, lower=False)
    got = hk.btrsm_pair(_t(T), _t(Dl), _t(Du), _t(b), perm=_t(perm),
                        trans_back=kind == "spd")
    assert _rel(got.numpy(), np.asarray(want)) <= _TOL[np.float32]


@pytest.mark.parametrize("kind,n,dtype", [("lu", 48, np.float32), ("lu", 64, np.float64),
                                          ("spd", 48, np.float64), ("spd", 64, np.float32)])
def test_pair_probe_stats_match_jax(kind, n, dtype):
    """xsum and wAx against the JAX fused epilogue (`blocked_solve_probe`
    in the back solve), at tests/test_torch_batched_trsm.py's tolerances;
    x is bitwise the same with and without the probe row."""
    T, Dl, Du, b, perm = _case(kind, 2, n, 3, dtype, 70 + n)
    wA = np.random.default_rng(n).standard_normal((2, n)).astype(dtype)
    spd = kind == "spd"
    x, xsum, wAx = hk.btrsm_pair(_t(T), _t(Dl), _t(Du), _t(b), perm=_t(perm),
                                 trans_back=spd, wA=_t(wA))
    assert torch.equal(x, hk.btrsm_pair(_t(T), _t(Dl), _t(Du), _t(b), perm=_t(perm),
                                        trans_back=spd))
    assert xsum.shape == (2,) and wAx.shape == (2,) and xsum.dtype == x.dtype
    for i in range(2):
        if spd:
            y = _blocked_solve(T[i], Dl[i], b[i], True)
            Tb, Db = T[i].T, np.swapaxes(Dl[i], -1, -2)
        else:
            y = _blocked_solve(T[i], Dl[i], b[i][perm[i]], True)
            Tb, Db = T[i], Du[i]
        _jx, jsum, jwax = jbt.blocked_solve_probe(
            jnp.asarray(Tb), jnp.asarray(Db), jnp.asarray(y), jnp.asarray(wA[i]),
            lower=False, stats_dtype=jnp.dtype(dtype))
        assert np.isclose(float(xsum[i]), float(jsum), rtol=1e-4)
        assert np.isclose(float(wAx[i]), float(jwax), rtol=1e-3, atol=1e-4)
        assert np.isclose(float(wAx[i]), float(np.dot(wA[i], x[i, :, 0].numpy())),
                          rtol=1e-3, atol=1e-4)


def test_pair_probe_nan_poisons_xsum():
    T, Dl, Du, b, perm = _case("lu", 3, 48, 1, np.float32, 9)
    b[1, 7, 0] = np.nan
    wA = np.ones((3, 48), np.float32)
    x, xsum, wAx = hk.btrsm_pair(_t(T), _t(Dl), _t(Du), _t(b), perm=_t(perm), wA=_t(wA))
    assert bool(torch.isnan(xsum[1])) and bool(torch.isfinite(xsum[[0, 2]]).all())
    assert bool(torch.isnan(x[1]).any()) and bool(torch.isfinite(x[[0, 2]]).all())


@pytest.mark.parametrize("kind,n,k", [("lu", 48, 1), ("lu", 64, 3), ("spd", 48, 3),
                                      ("spd", 64, 1)])
def test_pair_is_bitwise_two_plain_substitutions(kind, n, k):
    """x is what the serving round computed before: two `btrsm_plain`
    calls, forward on the gathered rows, back through T (or L^T)."""
    T, Dl, Du, b, perm = _case(kind, 4, n, k, np.float32, 30 + n + k)
    Tt, Dlt, bt = _t(T), _t(Dl), _t(b)
    if kind == "spd":
        y = hk.btrsm_plain(Tt, Dlt, bt, lower=True)
        want = hk.btrsm_plain(Tt.mT, Dlt.mT, y, lower=False)
    else:
        pt = _t(perm)
        y = hk.btrsm_plain(Tt, Dlt, torch.gather(bt, 1, pt[:, :, None].expand(bt.shape)),
                           lower=True)
        want = hk.btrsm_plain(Tt, _t(Du), y, lower=False)
    got = hk.btrsm_pair(Tt, Dlt, _t(Du), bt, perm=_t(perm), trans_back=kind == "spd")
    assert torch.equal(got, want)


def test_pair_checks_shapes_and_operands():
    T, Dl, Du, b, perm = (_t(x) for x in _case("lu", 2, 48, 2, np.float32, 3))
    with pytest.raises(ValueError, match="rhs"):
        hk.btrsm_pair(T, Dl, Du, b[:, :32], perm=perm)
    with pytest.raises(ValueError, match="Du"):
        hk.btrsm_pair(T, Dl, None, b, perm=perm)
    with pytest.raises(ValueError, match="Du"):
        hk.btrsm_pair(T, Dl, Du[:, :1], b, perm=perm)
    with pytest.raises(ValueError, match="trans_back"):
        hk.btrsm_pair(T, Dl, Du, b, trans_back=True)
    with pytest.raises(ValueError, match="perm"):
        hk.btrsm_pair(T, Dl, Du, b, perm=perm[:, :40])
    with pytest.raises(ValueError, match="perm"):
        hk.btrsm_pair(T, Dl, Du, b, perm=perm.double())
    with pytest.raises(ValueError, match="wA"):
        hk.btrsm_pair(T, Dl, Du, b, perm=perm, wA=torch.ones(2, 40))
    with pytest.raises(ValueError, match="dinv"):
        hk.btrsm_pair(T, Dl[:, :1], Du, b, perm=perm)
    with pytest.raises(ValueError, match="cuda or cpu"):
        hk.btrsm_pair(T.to("meta"), Dl.to("meta"), Du.to("meta"), b.to("meta"))


@pytest.mark.parametrize("n,bs", [(128, 64), (100, 64), (90, 48)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_narrowed_blocks_solve_as_jax_wide_blocks(n, bs, dtype):
    """The card runs diagonal blocks wider than 32 as their diagonal
    sub-blocks (`hopper_kernels._narrow_blocks`): a round through those
    matches the JAX package's round through the wide blocks."""
    rng = np.random.default_rng(n + bs)
    A = rng.standard_normal((2, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    T = torch.from_numpy(A.astype(dtype))
    Dl = tbt.diag_block_inverses(T, lower=True, unit_diagonal=True, block_size=bs)
    Du = tbt.diag_block_inverses(T, lower=False, block_size=bs)
    b = rng.standard_normal((2, n, 2)).astype(dtype)
    perm = np.stack([rng.permutation(n) for _ in range(2)])
    want = _jax_round(T.numpy(), Dl.numpy(), Du.numpy(), b, perm, _blocked_solve)
    Dn = [hk._narrow_blocks(D, n) for D in (Dl, Du)]
    w = Dn[0].shape[-1]
    assert w <= 32 and bs % w == 0 and Dn[0].shape[1] == -(-n // w)
    got = hk.btrsm_pair_plain(T, Dn[0], Dn[1], _t(b), _t(perm))
    assert _rel(got.numpy(), want) <= _TOL[dtype]
