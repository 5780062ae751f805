"""Batched systems (the port of the single-device part of
`conflux_tpu/batched.py`).

The pytree helpers of the serve layer over tuples of tensors (a factor
pytree in the port is a tuple, with None for absent leaves), and
`lu_factor_batched` on the kernel route: mesh-less, float32 or float64, the
batch in the K4 kernel's grid. The vmapped blocked body, mesh sharding and
the batched solves are not ported yet.
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


def lu_factor_batched(A: torch.Tensor, v: int, *, mesh=None,
                      backend: str | None = None):
    """Pivoted LU of a (B, N, N) batch: (LU (B, N, N), perm (B, N)) with
    A[i][perm[i]] == L_i @ U_i. Runs on the K4 kernel
    (`blas.batched_lu_factor`); mesh sharding and the vmapped blocked body
    (other dtypes) are not ported yet."""
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
    return blas.batched_lu_factor(A, backend=backend)
