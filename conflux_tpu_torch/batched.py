"""Batched systems (the port of the single-device part of
`conflux_tpu/batched.py`).

The pytree helpers of the serve layer over tuples of tensors (a factor
pytree in the port is a tuple, with None for absent leaves; dicts and
lists nest): stacking and slicing (`stack_trees`, `unstack_tree`), the
gang's resident stacks (`write_slot_tree`, an in-place row write into a
stack the gang owns, and `grow_stack_tree`), device moves that keep
aliased leaves aliased (`put_tree`) and the host-stacked transfer
(`stack_host_trees`); the batched
factors `lu_factor_batched` and `cholesky_factor_batched`, the batched
substitutions `lu_solve_batched` and `cholesky_solve_batched`, and the
one-shot pipeline `solve_batched`. A factor on backend "kernel" with a
float32 or float64 batch runs in the K4 or K5 kernel's grid (the JAX
`_pallas_factor_eligible` route); every other batch (bfloat16 storage, or
backend "xla") runs the batched blocked factor (`lu.single`,
`cholesky.single` on a (B, N, N) batch), the counterpart of the JAX
package's `jax.vmap` of its blocked body. `solve_updated_batched` solves
a fleet of drifted systems through the factors of their bases (the
Woodbury correction, `update`). Mesh sharding is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.ops import blas


def _tree_map(fn, *trees):
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
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


def put_tree(tree, device):
    """Move a tree's tensors to `device`, keeping aliasing: leaves that are
    one tensor on the way in are one tensor on the way out, so a session
    whose `_A` is its `_A0` still holds one base (and its deduplicated
    `nbytes` counts it once). `device=None` is the identity. A copy moves
    bytes only: every leaf arrives with its bits."""
    if device is None:
        return tree
    device = torch.device(device)
    seen: dict[int, torch.Tensor] = {}

    def put(leaf):
        got = seen.get(id(leaf))
        if got is None:
            got = seen[id(leaf)] = leaf.to(device)
        return got

    return _tree_map(put, tree)


def stack_host_trees(trees, device):
    """Stack identical-structure trees of host leaves (numpy, or CPU
    tensors: the tier layer's records, bfloat16 included) along a new
    leading axis on the host, then move each stacked leaf to `device` once:
    one host-to-device copy per leaf position instead of one per tree and
    leaf. Bitwise the per-leaf transfer (a memcpy and a copy never touch
    the bits). None leaves must agree (they stay None)."""
    device = torch.device(device)

    def one(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack([x.cpu() for x in xs]).to(device)
        return torch.from_numpy(np.stack([np.asarray(x) for x in xs])).to(device)

    return _tree_map(one, *trees)


def write_slot_tree(stack, sub, i: int, donate: bool = True):
    """Write the per-slot tree `sub` into slot `i` of the stacked tree
    `stack`, leaf by leaf, and return the stack. With `donate` (the
    default) the write lands in place, one row copy per leaf: the gang's
    write-back, licensed because the gang owns its stacks (they come out
    of its own builds and writes, never out of a caller's hands), the role
    of XLA's buffer donation in the JAX package. `donate=False` writes into
    a copy and leaves `stack` as it was. Bitwise: the slot reads back
    exactly the bits of `sub` (:func:`unstack_tree`). On the card the write
    is ordered on the caller's current stream, after the work already
    queued there that reads the stack."""
    def one(S, x):
        if not donate:
            S = S.clone()
        S[i].copy_(x)
        return S

    return _tree_map(one, stack, sub)


def grow_stack_tree(stack, cap: int, fill: str = "first"):
    """Grow a stacked tree's leading axis to `cap` slots (the tree as it is
    when already that large). `fill='first'` pads with copies of slot 0,
    the gang's pad rule; `fill='zero'` with zeros, the drift state's pad
    (zero U and V columns leave the Woodbury correction unchanged). Slots
    0..n-1 keep their bits (a concatenation moves, never computes)."""
    if fill not in ("first", "zero"):
        raise ValueError(f"unknown fill {fill!r} (first|zero)")

    def one(S):
        n = S.shape[0]
        if n >= cap:
            return S
        if fill == "zero":
            pad = S.new_zeros((cap - n,) + tuple(S.shape[1:]))
        else:
            pad = S[:1].expand((cap - n,) + tuple(S.shape[1:]))
        return torch.cat([S, pad], 0)

    return _tree_map(one, stack)


def _check_batch(A: torch.Tensor, v: int, mesh) -> None:
    """A (B, N, N) batch, N a multiple of v, no mesh."""
    _check_batched_square(A)
    N = A.shape[1]
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")


def _check_batched_square(A: torch.Tensor, what: str = "A") -> None:
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{what} must be a (B, N, N) batch of square systems, got "
                         f"{tuple(A.shape)}")


def _kernel_factor_eligible(A: torch.Tensor, backend: str) -> bool:
    """Whether a batched factor runs in the K4 / K5 kernel's grid: backend
    "kernel" and a float32 or float64 batch (the JAX package's
    `_pallas_factor_eligible`)."""
    return backend == "kernel" and A.dtype in (torch.float32, torch.float64)


def _rhs_3d(b: torch.Tensor, B: int, N: int):
    """A batched rhs as (B, N, k); returns (b3, squeeze)."""
    if b.dim() == 2:
        if tuple(b.shape) != (B, N):
            raise ValueError(f"rhs {tuple(b.shape)} does not match batch ({B}, {N})")
        return b[:, :, None], True
    if b.dim() == 3:
        if tuple(b.shape[:2]) != (B, N):
            raise ValueError(f"rhs {tuple(b.shape)} does not match batch ({B}, {N}, k)")
        return b, False
    raise ValueError(f"rhs must be (B, N) or (B, N, k), got {tuple(b.shape)}")


def lu_factor_batched(A: torch.Tensor, v: int, *, mesh=None,
                      backend: str | None = None):
    """Pivoted LU of a (B, N, N) batch: (LU (B, N, N), perm (B, N)) with
    A[i][perm[i]] == L_i @ U_i. Backend "kernel" with float32 or float64
    runs the K4 kernel (`blas.batched_lu_factor`); any other batch the
    batched blocked factor (`lu.single.lu_factor_blocked`) with the
    registry's panel algo."""
    from conflux_tpu_torch.lu.single import lu_factor_blocked

    _check_batch(A, v, mesh)
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    if _kernel_factor_eligible(A, backend):
        return blas.batched_lu_factor(A, backend=backend)
    return lu_factor_blocked(A, v, backend=backend)


def cholesky_factor_batched(A: torch.Tensor, v: int, *, mesh=None,
                            backend: str | None = None):
    """Lower Cholesky factors of a (B, N, N) SPD batch: L (B, N, N), strict
    upper parts zero. Backend "kernel" with float32 or float64 runs the K5
    kernel (`blas.batched_cholesky_factor`); any other batch the batched
    blocked factor (`cholesky.single.cholesky_blocked`)."""
    from conflux_tpu_torch.cholesky.single import cholesky_blocked

    _check_batch(A, v, mesh)
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    if _kernel_factor_eligible(A, backend):
        return blas.batched_cholesky_factor(A, backend=backend)
    return cholesky_blocked(A, v, backend=backend)


def lu_solve_batched(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor, *,
                     mesh=None) -> torch.Tensor:
    """Batched substitution through packed LU factors (B, N, N) with
    A[i][perm[i]] == L_i U_i: b is (B, N) or (B, N, k); returns x of b's
    shape, in the factors' compute dtype. Two batched library triangular
    solves, as the JAX package vmaps `solvers.lu_solve`."""
    _check_batched_square(LU, "LU")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")
    B, N = LU.shape[0], LU.shape[1]
    b3, squeeze = _rhs_3d(b, B, N)
    cdtype = blas.compute_dtype(LU.dtype)
    Lu = LU.to(cdtype)
    r = torch.gather(b3.to(cdtype), 1, perm.long()[:, :, None].expand(b3.shape))
    x = blas.trsm_left_upper(Lu, blas.trsm_left_lower_unit(Lu, r))
    return x[:, :, 0] if squeeze else x


def cholesky_solve_batched(L: torch.Tensor, b: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """Batched substitution through lower Cholesky factors L (B, N, N): b
    is (B, N) or (B, N, k); returns x of b's shape. Two batched library
    triangular solves (forward through L, back through L^H)."""
    _check_batched_square(L, "L")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")
    B, N = L.shape[0], L.shape[1]
    b3, squeeze = _rhs_3d(b, B, N)
    cdtype = blas.compute_dtype(L.dtype)
    Lc = L.to(cdtype)
    x = blas.trsm_left_lower_t(Lc, blas.trsm_left_lower(Lc, b3.to(cdtype)))
    return x[:, :, 0] if squeeze else x


def _batched_corr(spd: bool, substitution: str, backend: str, Af: torch.Tensor,
                  v: int, panel_algo: str):
    """Factor a (B, N, N) batch with the blocked body and return its
    substitution closure r -> A^{-1} r. `substitution='blocked'` runs a
    whole solve round in one K3 launch (`hopper_kernels.btrsm_pair`, the
    plain version on the CPU) through diagonal-block inverses made here;
    'trsm' the batched library substitutions."""
    from conflux_tpu_torch.cholesky.single import cholesky_blocked
    from conflux_tpu_torch.lu.single import lu_factor_blocked
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    cdtype = blas.compute_dtype(Af.dtype)
    if spd:
        L = cholesky_blocked(Af, v, backend=backend)
        if substitution != "blocked":
            return lambda r: cholesky_solve_batched(L, r)
        Dl = diag_block_inverses(L.to(cdtype), lower=True)
        return lambda r: hopper_kernels.btrsm_pair(L, Dl, None, r.to(cdtype), trans_back=True)
    LU, perm = lu_factor_blocked(Af, v, backend=backend, panel_algo=panel_algo)
    if substitution != "blocked":
        return lambda r: lu_solve_batched(LU, perm, r)
    LUc = LU.to(cdtype)
    Dl = diag_block_inverses(LUc, lower=True, unit_diagonal=True)
    Du = diag_block_inverses(LUc, lower=False)
    return lambda r: hopper_kernels.btrsm_pair(LU, Dl, Du, r.to(cdtype), perm=perm)


def solve_batched(A: torch.Tensor, b: torch.Tensor, *, v: int = 256, factor_dtype=None,
                  refine: int = 0, spd: bool = False, mesh=None,
                  backend: str | None = None, substitution: str = "trsm") -> torch.Tensor:
    """Solve B independent systems A[i] x[i] = b[i]: the batched
    counterpart of `solvers.solve` (the same `factor_dtype` / `refine`
    HPL-MxP recipe and `spd` Cholesky switch). A is (B, N, N), b (B, N)
    or (B, N, k); returns x of b's shape in A's compute dtype. The batch
    is factored in `factor_dtype` by the blocked body (as the JAX
    package's vmapped program does, whatever the backend), substituted
    by `substitution` ('trsm' or 'blocked'), and `refine` classic sweeps
    take their residuals in A's compute dtype."""
    if substitution not in ("trsm", "blocked"):
        raise ValueError(f"unknown substitution {substitution!r} (trsm|blocked)")
    _check_batched_square(A)
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")
    B, N = A.shape[0], A.shape[1]
    v = min(v, N)
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}; pre-pad the batch "
                         "with an identity extension (cf. solvers.solve)")
    b3, squeeze = _rhs_3d(b, B, N)
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    corr = _batched_corr(spd, substitution, backend, A.to(fdtype), v, blas.get_panel_algo())
    cdtype = blas.compute_dtype(A.dtype)
    Ac, bc = A.to(cdtype), b3.to(cdtype)
    x = corr(b3).to(cdtype)
    for _ in range(refine):
        x = x + corr(bc - torch.matmul(Ac, x)).to(cdtype)
    return x[:, :, 0] if squeeze else x


def solve_updated_batched(A: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                          b: torch.Tensor, *, v: int = 256, factor_dtype=None,
                          refine: int = 0, spd: bool = False, mesh=None,
                          backend: str | None = None,
                          substitution: str = "trsm") -> torch.Tensor:
    """Solve B drifted systems (A[i] + U[i] V[i]^H) x[i] = b[i]: the
    batched counterpart of `solvers.solve_updated`. A is (B, N, N), U and V
    (B, N, k) with k << N, b (B, N) or (B, N, nrhs); only the bases are
    factored (the `solve_batched` recipe and `substitution`), and the
    corrections ride k x k capacitance systems (`update.woodbury_solve`,
    batched over the systems). `spd` refers to the bases."""
    from conflux_tpu_torch.update import woodbury_solve

    if substitution not in ("trsm", "blocked"):
        raise ValueError(f"unknown substitution {substitution!r} (trsm|blocked)")
    _check_batched_square(A)
    if mesh is not None:
        raise NotImplementedError("mesh-sharded batches are not ported yet")
    B, N = A.shape[0], A.shape[1]
    if tuple(U.shape) != tuple(V.shape) or U.dim() != 3 or tuple(U.shape[:2]) != (B, N):
        raise ValueError(f"update factors must both be ({B}, {N}, k), got "
                         f"{tuple(U.shape)} and {tuple(V.shape)}")
    v = min(v, N)
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}; pre-pad the batch "
                         "with an identity extension (cf. solvers.solve)")
    b3, squeeze = _rhs_3d(b, B, N)
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    base = _batched_corr(spd, substitution, backend, A.to(fdtype), v, blas.get_panel_algo())
    x = woodbury_solve(base, A if refine else None, U, V, b3, refine=refine)
    return x[:, :, 0] if squeeze else x
