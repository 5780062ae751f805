"""Batched systems (the port of the single-device part of
`conflux_tpu/batched.py`).

The pytree helpers of the serve layer over tuples of tensors (a factor
pytree in the port is a tuple, with None for absent leaves),
`lu_factor_batched` and `cholesky_factor_batched` on the kernel route
(mesh-less, float32 or float64, the batch in the K4 or K5 kernel's grid),
and `cholesky_solve_batched`. The vmapped blocked body, mesh sharding and
the batched LU solves are not ported yet.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import blas


def _tree_map(fn, *trees):
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_trees(trees):
    """Stack identical-structure trees along a new leading axis (None
    leaves must agree and stay None)."""
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_tree(tree, B: int):
    """The first `B` slots of a stacked tree as a list of per-slot trees:
    the inverse of :func:`stack_trees`, views with no arithmetic, so slot i
    carries exactly the bits of the stack."""
    return [_tree_map(lambda l, i=i: l[i], tree) for i in range(B)]


def _check_kernel_batch(A: torch.Tensor, v: int, mesh) -> None:
    """The kernel route's gate: a (B, N, N) batch, N a multiple of v, no
    mesh, float32 or float64."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, N, N), got {tuple(A.shape)}")
    N = A.shape[1]
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")
    if A.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"{A.dtype} batches take the vmapped blocked factor, which is not "
            "ported yet (the kernel route takes float32 and float64)")


def lu_factor_batched(A: torch.Tensor, v: int, *, mesh=None,
                      backend: str | None = None):
    """Pivoted LU of a (B, N, N) batch: (LU (B, N, N), perm (B, N)) with
    A[i][perm[i]] == L_i @ U_i. Runs on the K4 kernel
    (`blas.batched_lu_factor`); mesh sharding and the vmapped blocked body
    (other dtypes) are not ported yet."""
    _check_kernel_batch(A, v, mesh)
    return blas.batched_lu_factor(A, backend=backend)


def cholesky_factor_batched(A: torch.Tensor, v: int, *, mesh=None,
                            backend: str | None = None):
    """Lower Cholesky factors of a (B, N, N) SPD batch: L (B, N, N), strict
    upper parts zero. Runs on the K5 kernel (`blas.batched_cholesky_factor`);
    mesh sharding and the vmapped blocked body (other dtypes) are not
    ported yet."""
    _check_kernel_batch(A, v, mesh)
    return blas.batched_cholesky_factor(A, backend=backend)


def cholesky_solve_batched(L: torch.Tensor, b: torch.Tensor, *, mesh=None):
    """Batched substitution through lower Cholesky factors L (B, N, N): b
    is (B, N) or (B, N, k); returns x of b's shape. Each system runs
    `solvers.cholesky_solve`."""
    from conflux_tpu_torch.solvers import cholesky_solve

    if L.dim() != 3 or L.shape[1] != L.shape[2]:
        raise ValueError(f"L must be a (B, N, N) batch of square systems, got "
                         f"{tuple(L.shape)}")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")
    B, N = L.shape[0], L.shape[1]
    if b.dim() not in (2, 3) or tuple(b.shape[:2]) != (B, N):
        raise ValueError(f"rhs {tuple(b.shape)} does not match batch ({B}, {N}[, k])")
    return torch.stack([cholesky_solve(L[i], b[i]) for i in range(B)])
