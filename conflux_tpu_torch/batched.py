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
Woodbury correction, `update`).

Batch meshes: `batch_mesh(devices)` is an ordered tuple of torch devices,
one per shard, axis 'b' (the JAX package's 1D `Mesh`). A device may
repeat (k shards on one card, or on the CPU, which torch counts as one
device), so shards are named by position, never by device. A
mesh-sharded tensor (:class:`Sharded`) is the tuple of its shards along
the batch axis, shard i on device i; a mesh program (:func:`mesh_map`)
runs the one-device program on each shard in turn, each on its device's
current stream. The problems are independent, so no collective is
needed. Every batched entry point takes `mesh=`: the batch is padded to
a multiple of the shard count (copies of element 0, as in the JAX
package), sharded, run per shard, gathered and sliced back.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from conflux_tpu_torch.device import resolve_device
from conflux_tpu_torch.ops import blas

AXIS_B = "b"  # the data-parallel batch axis of `batch_mesh`


def _tree_map(fn, *trees):
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class BatchMesh:
    """A flat 1D mesh of torch devices, axis 'b': the serving counterpart
    of the JAX package's `Mesh(devices, ('b',))`. `devices` is ordered,
    one entry per shard, and may repeat a device (several shards on one
    card or on the CPU). Built by :func:`batch_mesh`; identified by
    `parallel.mesh.mesh_cache_key`."""

    __slots__ = ("devices",)
    axis_names = (AXIS_B,)

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a batch mesh needs at least one device")

    @property
    def size(self) -> int:
        """The shard count."""
        return len(self.devices)

    @property
    def device_shape(self) -> tuple:
        return (len(self.devices),)

    def __repr__(self) -> str:
        return f"BatchMesh({[str(d) for d in self.devices]})"


def _mesh_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_mesh(devices=None) -> BatchMesh:
    """A flat 1D mesh over every card (None) or the given devices, axis
    name 'b'. A device may be named several times: `batch_mesh(["cpu"] *
    4)` is four shards on the CPU, `batch_mesh(["cuda:0", "cuda:0"])` two
    on one card. None on a machine without a card raises, as every entry
    point does: a mesh is never built on the CPU unless asked for."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 1:
            resolve_device(None)  # raises, naming device='cpu'
        return BatchMesh([torch.device("cuda", i) for i in range(n)])
    devs = [_mesh_device(d) for d in devices]
    if not devs:
        raise ValueError("batch_mesh needs at least one device")
    return BatchMesh(devs)


def check_mesh(mesh) -> None:
    """Refuse a `mesh=` that is not a :class:`BatchMesh` (None is fine)."""
    if mesh is not None and not isinstance(mesh, BatchMesh):
        raise TypeError(f"mesh must be a batch_mesh(...) (BatchMesh) or None, got "
                        f"{type(mesh).__name__}")


class Sharded:
    """A tensor sharded along its leading (batch) axis over a
    :class:`BatchMesh`: shard i, a tensor of B/k rows, lives on
    mesh.devices[i]. The leaf type of a mesh session's state. It carries
    the whole tensor's shape, dtype and byte count (`numel`,
    `element_size`), and indexing that leaves the batch axis alone
    (``x[..., :k]``) applies to every shard."""

    __slots__ = ("shards", "mesh")

    def __init__(self, shards, mesh: BatchMesh):
        self.shards = tuple(shards)
        self.mesh = mesh
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {mesh.size}")

    @property
    def shape(self) -> torch.Size:
        s0 = self.shards[0].shape
        return torch.Size((sum(s.shape[0] for s in self.shards),) + tuple(s0[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device (where :func:`gather_batch` lands)."""
        return self.shards[0].device

    def dim(self) -> int:
        return self.shards[0].dim()

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def __getitem__(self, idx):
        if not (isinstance(idx, tuple) and idx and idx[0] is Ellipsis):
            raise TypeError("a Sharded tensor takes trailing-axis indexing only "
                            "(x[..., i]): its batch axis is split over the mesh")
        return Sharded(tuple(s[idx] for s in self.shards), self.mesh)

    def __repr__(self) -> str:
        return f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, mesh={self.mesh})"


def _shard_one(a, mesh: BatchMesh, non_blocking: bool = False) -> Sharded:
    if isinstance(a, Sharded):
        return a
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    k = mesh.size
    if a.dim() < 1 or a.shape[0] % k:
        raise ValueError(f"batch {tuple(a.shape)[:1]} does not split over {k} shards "
                         "(pad it first: _pad_batch)")
    parts = a.split(a.shape[0] // k) if a.shape[0] else (a,) * k
    return Sharded(tuple(p.to(d, non_blocking=non_blocking)
                         for p, d in zip(parts, mesh.devices)), mesh)


def _shard_batch(arrs, mesh, non_blocking: bool = False):
    """Split (B, ...) tensors (or numpy arrays) along the batch axis and
    put shard i on mesh.devices[i]: a tuple of :class:`Sharded` (the
    tensors themselves for mesh None). A shard already on its device is
    a view of the input, not a copy; an already sharded input passes
    through."""
    if mesh is None:
        return tuple(arrs)
    return tuple(_shard_one(a, mesh, non_blocking) for a in arrs)


def gather_batch(x):
    """A :class:`Sharded` tensor as one tensor on its first shard's device
    (the shards concatenated along the batch axis; a copy moves bytes
    only, so the result carries every shard's bits). Anything else
    passes through."""
    if not isinstance(x, Sharded):
        return x
    if len(x.shards) == 1:
        return x.shards[0]
    d0 = x.shards[0].device
    return torch.cat([s.to(d0) for s in x.shards])


def _pad_batch(arrs, B: int, nshards: int, fill: str = "first"):
    """Pad every (B, ...) tensor to the next multiple of `nshards`;
    returns (padded, Bp). `fill='first'` pads with copies of element 0
    (a real problem, well-conditioned: the data-parallel sharding pad);
    `fill='eye'` pads square (B, N, N) batches with identity matrices
    (the factor lane's pad: a poisoned element 0 never leaks into the
    padding)."""
    if fill not in ("first", "eye"):
        raise ValueError(f"unknown fill {fill!r} (first|eye)")
    Bp = nshards * (-(-B // nshards))
    if Bp == B:
        return list(arrs), B
    out = []
    for a in arrs:
        if fill == "eye":
            if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
                raise ValueError(f"fill='eye' pads square trailing dims, got "
                                 f"{tuple(a.shape)}")
            one = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            pad = one.expand((Bp - B,) + tuple(a.shape[1:]))
        else:
            pad = a[:1].expand((Bp - B,) + tuple(a.shape[1:]))
        out.append(torch.cat([a, pad], 0))
    return out, Bp


def _device_ctx(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _join_streams(mesh: BatchMesh) -> None:
    """Order the first shard device's current stream after every other
    card's current stream (by event), so work queued next on the first
    device (a gather, an answer copy, a fence) follows every shard. Only
    a mesh over several cards does anything; one card or the CPU is
    ordered already."""
    d0 = mesh.devices[0]
    if d0.type != "cuda":
        return
    cur = torch.cuda.current_stream(d0)
    seen = {d0.index}
    for d in mesh.devices[1:]:
        if d.type != "cuda" or d.index in seen:
            continue
        seen.add(d.index)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        cur.wait_event(ev)


def _pick(i: int):
    def pick(leaf):
        return leaf.shards[i] if isinstance(leaf, Sharded) else leaf
    return pick


def _find_mesh(tree):
    if isinstance(tree, Sharded):
        return tree.mesh
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        for x in tree:
            m = _find_mesh(x)
            if m is not None:
                return m
    return None


def mesh_map(fn, mesh, *args):
    """Run the one-device program `fn` on each shard in turn: call i gets
    shard i of every :class:`Sharded` leaf of `args` (other leaves as
    they are), on mesh.devices[i]'s current stream; the outputs' tensor
    leaves come back as :class:`Sharded` (None stays None). `mesh` None
    takes the mesh of the first sharded argument, and with none the call
    is `fn(*args)` unchanged."""
    if mesh is None:
        mesh = _find_mesh(args)
        if mesh is None:
            return fn(*args)
    outs = []
    for i, dev in enumerate(mesh.devices):
        with _device_ctx(dev):
            outs.append(fn(*_tree_map(_pick(i), args)))
    _join_streams(mesh)
    return _tree_map(lambda *xs: Sharded(xs, mesh), *outs)


def shard_host_tree(tree, mesh):
    """Host leaves (CPU tensors or numpy) of a tree back onto a batch
    mesh, leaf-wise batch-sharded: the tier and checkpoint revival of a
    mesh session (every state leaf is batch-axis-leading). A copy moves
    bytes, never computes: bitwise. Aliased leaves move once (the
    :func:`put_tree` contract); None stays None; `mesh` None gives CPU
    tensors."""
    seen: dict[int, object] = {}

    def put(leaf):
        got = seen.get(id(leaf))
        if got is None:
            t = (leaf if isinstance(leaf, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(leaf)))
            got = seen[id(leaf)] = t if mesh is None else _shard_one(t, mesh, True)
        return got

    return _tree_map(put, tree)


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
    """A (B, N, N) batch, N a multiple of v, and a batch mesh or None."""
    check_mesh(mesh)
    _check_batched_square(A)
    N = A.shape[1]
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}")


def _on_mesh(fn, mesh: BatchMesh, arrs, B: int):
    """The one-shot entry points' mesh route: pad the (B, ...) inputs to
    a multiple of the shard count (copies of element 0), shard them, run
    `fn` on each shard (:func:`mesh_map`), then gather every output and
    slice the padding off."""
    padded, _Bp = _pad_batch(arrs, B, mesh.size)
    out = mesh_map(fn, mesh, *_shard_batch(padded, mesh))
    return _tree_map(lambda x: gather_batch(x)[:B], out)


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


def _resolve(precision, backend):
    """(precision, backend) with None read from the registry, as the JAX
    package's `_resolve`."""
    precision = blas.matmul_precision() if precision is None else precision
    backend = blas.check_backend(blas.get_backend() if backend is None else backend)
    blas.resolve_precision(precision)
    return precision, backend


def lu_factor_batched(A: torch.Tensor, v: int, *, mesh=None, precision=None,
                      backend: str | None = None):
    """Pivoted LU of a (B, N, N) batch: (LU (B, N, N), perm (B, N)) with
    A[i][perm[i]] == L_i @ U_i. Backend "kernel" with float32 or float64
    runs the K4 kernel (`blas.batched_lu_factor`); any other batch the
    batched blocked factor (`lu.single.lu_factor_blocked`) with the
    registry's panel algo. With a `batch_mesh` each shard runs that
    factor on its device (K4 once per shard on "kernel": the JAX
    package's Pallas-under-sharding exclusion is dropped), and the
    result comes back gathered on the mesh's first device. `precision`
    reaches the blocked factor's library products; K4 takes none."""
    from conflux_tpu_torch.lu.single import lu_factor_blocked

    _check_batch(A, v, mesh)
    precision, backend = _resolve(precision, backend)
    if mesh is not None:
        return _on_mesh(lambda a: lu_factor_batched(a, v, precision=precision,
                                                    backend=backend), mesh, (A,),
                        A.shape[0])
    if _kernel_factor_eligible(A, backend):
        return blas.batched_lu_factor(A, backend=backend)
    return lu_factor_blocked(A, v, precision, backend)


def cholesky_factor_batched(A: torch.Tensor, v: int, *, mesh=None, precision=None,
                            backend: str | None = None):
    """Lower Cholesky factors of a (B, N, N) SPD batch: L (B, N, N), strict
    upper parts zero. Backend "kernel" with float32 or float64 runs the K5
    kernel (`blas.batched_cholesky_factor`); any other batch the batched
    blocked factor (`cholesky.single.cholesky_blocked`), its library
    products at `precision` (K5 takes none)."""
    from conflux_tpu_torch.cholesky.single import cholesky_blocked

    _check_batch(A, v, mesh)
    precision, backend = _resolve(precision, backend)
    if mesh is not None:
        return _on_mesh(lambda a: cholesky_factor_batched(a, v, precision=precision,
                                                          backend=backend), mesh,
                        (A,), A.shape[0])
    if _kernel_factor_eligible(A, backend):
        return blas.batched_cholesky_factor(A, backend=backend)
    return cholesky_blocked(A, v, precision, backend)


def lu_solve_batched(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor, *,
                     mesh=None) -> torch.Tensor:
    """Batched substitution through packed LU factors (B, N, N) with
    A[i][perm[i]] == L_i U_i: b is (B, N) or (B, N, k); returns x of b's
    shape, in the factors' compute dtype. Two batched library triangular
    solves, as the JAX package vmaps `solvers.lu_solve`."""
    _check_batched_square(LU, "LU")
    check_mesh(mesh)
    B, N = LU.shape[0], LU.shape[1]
    b3, squeeze = _rhs_3d(b, B, N)
    if mesh is not None:
        x = _on_mesh(lu_solve_batched, mesh, (LU, perm, b3), B)
        return x[:, :, 0] if squeeze else x
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
    check_mesh(mesh)
    B, N = L.shape[0], L.shape[1]
    b3, squeeze = _rhs_3d(b, B, N)
    if mesh is not None:
        x = _on_mesh(cholesky_solve_batched, mesh, (L, b3), B)
        return x[:, :, 0] if squeeze else x
    cdtype = blas.compute_dtype(L.dtype)
    Lc = L.to(cdtype)
    x = blas.trsm_left_lower_t(Lc, blas.trsm_left_lower(Lc, b3.to(cdtype)))
    return x[:, :, 0] if squeeze else x


def _batched_corr(spd: bool, substitution: str, precision, backend: str,
                  Af: torch.Tensor, v: int, panel_algo: str):
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
        L = cholesky_blocked(Af, v, precision, backend)
        if substitution != "blocked":
            return lambda r: cholesky_solve_batched(L, r)
        Dl = diag_block_inverses(L.to(cdtype), lower=True)
        return lambda r: hopper_kernels.btrsm_pair(L, Dl, None, r.to(cdtype), trans_back=True)
    LU, perm = lu_factor_blocked(Af, v, precision, backend, panel_algo=panel_algo)
    if substitution != "blocked":
        return lambda r: lu_solve_batched(LU, perm, r)
    LUc = LU.to(cdtype)
    Dl = diag_block_inverses(LUc, lower=True, unit_diagonal=True)
    Du = diag_block_inverses(LUc, lower=False)
    return lambda r: hopper_kernels.btrsm_pair(LU, Dl, Du, r.to(cdtype), perm=perm)


def solve_batched(A: torch.Tensor, b: torch.Tensor, *, v: int = 256, factor_dtype=None,
                  refine: int = 0, spd: bool = False, mesh=None, precision=None,
                  backend: str | None = None, substitution: str = "trsm") -> torch.Tensor:
    """Solve B independent systems A[i] x[i] = b[i]: the batched
    counterpart of `solvers.solve` (the same `factor_dtype` / `refine`
    HPL-MxP recipe and `spd` Cholesky switch). A is (B, N, N), b (B, N)
    or (B, N, k); returns x of b's shape in A's compute dtype. The batch
    is factored in `factor_dtype` by the blocked body (as the JAX
    package's vmapped program does, whatever the backend), substituted
    by `substitution` ('trsm' or 'blocked'), and `refine` classic sweeps
    take their residuals in A's compute dtype, IEEE at every `precision`
    (which reaches the factor's library products)."""
    if substitution not in ("trsm", "blocked"):
        raise ValueError(f"unknown substitution {substitution!r} (trsm|blocked)")
    _check_batched_square(A)
    check_mesh(mesh)
    B, N = A.shape[0], A.shape[1]
    v = min(v, N)
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}; pre-pad the batch "
                         "with an identity extension (cf. solvers.solve)")
    b3, squeeze = _rhs_3d(b, B, N)
    precision, backend = _resolve(precision, backend)
    if mesh is not None:
        x = _on_mesh(lambda a, r: solve_batched(
            a, r, v=v, factor_dtype=factor_dtype, refine=refine, spd=spd,
            precision=precision, backend=backend, substitution=substitution),
            mesh, (A, b3), B)
        return x[:, :, 0] if squeeze else x
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    corr = _batched_corr(spd, substitution, precision, backend, A.to(fdtype), v,
                         blas.get_panel_algo())
    cdtype = blas.compute_dtype(A.dtype)
    Ac, bc = A.to(cdtype), b3.to(cdtype)
    x = corr(b3).to(cdtype)
    for _ in range(refine):
        x = x + corr(bc - torch.matmul(Ac, x)).to(cdtype)
    return x[:, :, 0] if squeeze else x


def solve_updated_batched(A: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                          b: torch.Tensor, *, v: int = 256, factor_dtype=None,
                          refine: int = 0, spd: bool = False, mesh=None,
                          precision=None, backend: str | None = None,
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
    check_mesh(mesh)
    B, N = A.shape[0], A.shape[1]
    if tuple(U.shape) != tuple(V.shape) or U.dim() != 3 or tuple(U.shape[:2]) != (B, N):
        raise ValueError(f"update factors must both be ({B}, {N}, k), got "
                         f"{tuple(U.shape)} and {tuple(V.shape)}")
    v = min(v, N)
    if N % v:
        raise ValueError(f"N={N} not a multiple of tile size v={v}; pre-pad the batch "
                         "with an identity extension (cf. solvers.solve)")
    b3, squeeze = _rhs_3d(b, B, N)
    precision, backend = _resolve(precision, backend)
    if mesh is not None:
        x = _on_mesh(lambda a, u, w, r: solve_updated_batched(
            a, u, w, r, v=v, factor_dtype=factor_dtype, refine=refine, spd=spd,
            precision=precision, backend=backend, substitution=substitution),
            mesh, (A, U, V, b3), B)
        return x[:, :, 0] if squeeze else x
    fdtype = A.dtype if factor_dtype is None else factor_dtype
    base = _batched_corr(spd, substitution, precision, backend, A.to(fdtype), v,
                         blas.get_panel_algo())
    x = woodbury_solve(base, A if refine else None, U, V, b3, refine=refine)
    return x[:, :, 0] if squeeze else x
