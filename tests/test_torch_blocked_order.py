"""The blocked order of the batched factor kernels keeps every bit.

K5 (`csrc/batched_chol.cu`) and K4 (`csrc/batched_lu.cu`) hold the trailing
updates of kb columns back and apply them per element in column order,
after a panel step. This file emulates each kernel's order with tensor ops
and the plain versions' own arithmetic, and holds it against
`hopper_kernels.batched_chol_plain` / `batched_lu_plain` bit for bit (equal
pivots too): the chain of roundings of every element is the same, so kb
(and how a kernel splits the work) changes no bit.

K5, per block J = [j0, j1):
  1. the diagonal block, unscaled, column by column;
  2. the column panel below it, each row a chain over j in J (no scratch:
     column j keeps its pre-scale values);
  3. the row panel right of it, each column a chain over the rows of J;
  4. the trailing square, kb updates per element in column order;
  5. the deferred scaling of the block's columns by sqrt(d_j).
K4, per block J:
  1. the panel: for j in J, the pivot election over the live rows of the
     (current) column j, the multipliers, the in-panel updates;
  2. the row panel: the pivot rows p_j brought up to step j over the
     columns after J;
  3. the trailing rows still live: kb FMAs per element in column order.
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch.ops import hopper_kernels as hk

NS = [1, 7, 33, 64, 200]
KBS = [1, 8, 16, 32]
DTYPES = [torch.float32, torch.float64]


def _chol_update(a, c, r, d):
    """The plain version's update: a - (c * r) / d, each step rounded."""
    return a - (c * r) / d


def chol_blocked(A: torch.Tensor, kb: int) -> torch.Tensor:
    """K5's blocked order with the plain version's arithmetic."""
    X = A.clone()
    n = X.shape[-1]
    for j0 in range(0, n, kb):
        j1 = min(j0 + kb, n)
        w = j1 - j0
        D = X[:, j0:j1, j0:j1]  # views: updated in place
        for j in range(w):
            D[:, j + 1:, j + 1:] = _chol_update(
                D[:, j + 1:, j + 1:], D[:, j + 1:, j, None].clone(),
                D[:, None, j, j + 1:].clone(), D[:, j, j, None, None].clone())
        d = torch.diagonal(D, dim1=1, dim2=2).clone()  # (B, w), unscaled
        C = X[:, j1:, j0:j1]
        for j in range(w):  # each row of the column panel: a chain over j
            C[:, :, j + 1:] = _chol_update(C[:, :, j + 1:], C[:, :, j, None].clone(),
                                           D[:, None, j, j + 1:], d[:, j, None, None])
        R = X[:, j0:j1, j1:]
        for i in range(w):  # each column of the row panel: a chain over rows
            for j in range(i):
                R[:, i] = _chol_update(R[:, i], D[:, i, j, None], R[:, j], d[:, j, None])
        T = X[:, j1:, j1:]
        for j in range(w):  # per element, kb updates in column order
            T[:] = _chol_update(T, C[:, :, j, None], R[:, None, j, :], d[:, j, None, None])
        # the deferred scaling, and the diagonal as d / sqrt(d)
        s = torch.sqrt(d)
        low = torch.tril(torch.ones(w, w, dtype=torch.bool), -1)
        D[:] = torch.where(low, D / s[:, None, :], D)
        D[:, range(w), range(w)] = d / s
        C[:] = C / s[:, None, :]
    return torch.tril(X)


def _fma(a, l, u):
    """The plain version's fused multiply-add a - l * u: in float64, rounded
    once to float32, for float32; two roundings for float64."""
    if a.dtype == torch.float32:
        return (a.double() - l.double() * u.double()).float()
    return a - l * u


def lu_blocked(A: torch.Tensor, kb: int):
    """K4's blocked order with the plain version's arithmetic; returns
    (LU, perm) in LAPACK order, as `batched_lu_plain` does."""
    X = A.clone()
    Bn, n, _ = X.shape
    rows = torch.arange(n)
    slots = torch.arange(Bn)
    live = torch.ones((Bn, n), dtype=torch.bool)
    pivs = []
    for j0 in range(0, n, kb):
        j1 = min(j0 + kb, n)
        w = j1 - j0
        P = X[:, :, j0:j1]
        prows = []
        for j in range(w):
            col = P[:, :, j]
            score = col.abs()
            score = torch.where(torch.isnan(score), -1.0, score)
            score = torch.where(live, score, -2.0)
            best = score.max(dim=1, keepdim=True).values
            p = torch.where(score == best, rows, n).min(dim=1).values
            prows.append(p)
            prow = P[slots, p].clone()  # (B, w)
            live[slots, p] = False
            lmul = col / prow[:, j:j + 1]
            upd = _fma(P[:, :, j + 1:], lmul[:, :, None], prow[:, None, j + 1:])
            P[:, :, j + 1:] = torch.where(live[:, :, None], upd, P[:, :, j + 1:])
            P[:, :, j] = torch.where(live, lmul, col)
        pivs += prows
        # the row panel: pivot row p_j brought up to step j
        U = torch.stack([X[slots, p, j1:] for p in prows], 1)  # (B, w, n - j1)
        for j in range(w):
            for jp in range(j):
                U[:, j] = _fma(U[:, j], P[slots, prows[j], jp][:, None], U[:, jp])
            X[slots, prows[j], j1:] = U[:, j]
        # the trailing rows still live: kb FMAs per element in column order
        T = X[:, :, j1:]
        for j in range(w):
            T[:] = torch.where(live[:, :, None],
                               _fma(T, P[:, :, j, None], U[:, None, j, :]), T)
    return hk._lapack_order(X, torch.stack(pivs, 1))


def _same_bits(x, y):
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])


def _spd(B, n, seed, dtype, unsym=False):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    A = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n)
    if unsym:  # an upper triangle that differs from the lower one
        A = A + np.triu(1e-3 * rng.standard_normal((B, n, n)), 1)
    return torch.from_numpy(A).to(dtype)


def _general(B, n, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, n, n)) / np.sqrt(n)
                            + 0.5 * np.eye(n)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kb", KBS)
def test_chol_blocked_order_is_the_plain_bits(dtype, n, kb):
    A = _spd(2, n, 10 * n + kb, dtype)
    assert torch.equal(chol_blocked(A, kb), hk.batched_chol_plain(A)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kb", KBS)
def test_lu_blocked_order_is_the_plain_bits(dtype, n, kb):
    A = _general(2, n, 20 * n + kb, dtype)
    LU, perm = lu_blocked(A, kb)
    LU_p, perm_p, _ = hk.batched_lu_plain(A)
    assert torch.equal(perm, perm_p) and torch.equal(LU, LU_p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb", [8, 32])
def test_chol_blocked_order_unsymmetric_input(dtype, kb):
    """Both triangles are read and updated, in the same order."""
    A = _spd(2, 64, 7, dtype, unsym=True)
    assert torch.equal(chol_blocked(A, kb), hk.batched_chol_plain(A)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb", [8, 32])
def test_chol_blocked_order_non_spd_slots(dtype, kb):
    """A slot that is not positive definite (from the first column, and from
    column 40 on) turns NaN where the plain version does, and alone."""
    A = _spd(3, 64, 9, dtype)
    A[0] = -A[0]
    A[2, 40, 40] = -5.0
    got, want = chol_blocked(A, kb), hk.batched_chol_plain(A)[0]
    assert _same_bits(got, want)
    assert torch.isnan(got[0]).any() and torch.isnan(got[2]).any()
    assert torch.isfinite(got[1]).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb", [8, 32])
def test_lu_blocked_order_nan_slot(dtype, kb):
    """A NaN slot still elects a live row in range at every step, with the
    plain version's pivots and NaNs, and leaves its neighbour's bits."""
    A = _general(2, 64, 11, dtype)
    A[1] = float("nan")
    LU, perm = lu_blocked(A, kb)
    LU_p, perm_p, _ = hk.batched_lu_plain(A)
    assert torch.equal(perm, perm_p) and _same_bits(LU, LU_p)
    assert sorted(perm[1].tolist()) == list(range(64))
    assert torch.isfinite(LU[0]).all() and not torch.isfinite(LU[1]).any()
