"""The 3D process grid and the six communicator patterns, on
`torch.distributed` (the port of `conflux_tpu/parallel/mesh.py`).

The reference builds one 3D Cartesian communicator plus five
sub-communicators (`lu_params.hpp:84-108`): lu (xyz), jk (yz), ik (xz),
ij (xy), k (z), i (x). The JAX package names them as axis subsets of one
`shard_map` program. The port is SPMD as the reference is: one rank per
process (or per thread), each holding its own (Ml, Nl) shard and running
the same eager code, and each rank's `Mesh` holds one process group for
every axis subset it belongs to. A collective over a subset of axes runs
on the group of the ranks that share this rank's coordinates on the other
axes.

| reference comm | axes      | used for                                        |
|----------------|-----------|-------------------------------------------------|
| `lu_comm`      | x, y, z   | whole-grid ops                                  |
| `jk_comm`      | y, z      | panel broadcast / A10 slab scatter              |
| `ik_comm`      | x, z      | pivot-row reduce + distribute / A01 slab scatter|
| `ij_comm`      | x, y      | validation-layout assembly                      |
| `k_comm`       | z         | 2.5D partial-sum reduction                      |
| `i_comm`       | x         | tournament pivoting butterfly                   |

Transports, named by the caller and never chosen silently:

- `"gloo"` carries CPU tensors (a CUDA tensor raises);
- `"nccl"` carries CUDA tensors, one card per rank (a CPU tensor raises);
- `"staged"` runs gloo on host copies of CUDA tensors: several ranks on
  one card, where NCCL refuses two ranks of one device. Only the message
  goes through the host; every computation stays on the card, and
  `Mesh.stats["staged_bytes"]` counts the bytes copied each way.

Groups are built over a store the caller may pass (`make_mesh(...,
store=)`), so a world can also run as threads of one process
(`run_threaded`, the tests' and `chip_smoke.py`'s world). At world size 1
the mesh has no group and every collective is the identity.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from datetime import timedelta

import torch

from conflux_tpu_torch.geometry import Grid3

AXIS_X = "x"  # row dimension of the tile grid (Px)
AXIS_Y = "y"  # column dimension of the tile grid (Py)
AXIS_Z = "z"  # 2.5D replication depth (Pz)
_AXES = (AXIS_X, AXIS_Y, AXIS_Z)

comm = {
    "lu": (AXIS_X, AXIS_Y, AXIS_Z),
    "jk": (AXIS_Y, AXIS_Z),
    "ik": (AXIS_X, AXIS_Z),
    "ij": (AXIS_X, AXIS_Y),
    "k": (AXIS_Z,),
    "i": (AXIS_X,),
}


_MESH_REGISTRY: dict = {}
_MESH_LOCK = threading.Lock()


def mesh_cache_key(mesh) -> tuple:
    """Hashable identity of a serving batch mesh (`batched.BatchMesh`),
    registered for :func:`lookup_mesh`: ((type, index) of each shard's
    device, in shard order, repeats kept; axis names). Two equal meshes
    share one key, so a plan key (and its programs) is the same whichever
    mesh object built it. The registry holds one mesh per key, bounded by
    the number of distinct device layouts. (The per-rank grid :class:`Mesh`
    above is unrelated.)"""
    key = (tuple((d.type, 0 if d.index is None else d.index) for d in mesh.devices),
           tuple(mesh.axis_names))
    with _MESH_LOCK:
        _MESH_REGISTRY.setdefault(key, mesh)
    return key


def lookup_mesh(key):
    """The batch mesh registered under a :func:`mesh_cache_key`."""
    with _MESH_LOCK:
        return _MESH_REGISTRY[key]


TRANSPORTS = ("gloo", "nccl", "staged")
_DEFAULT_TIMEOUT = 300.0  # seconds a collective may wait for its peers


def _norm_axes(axes) -> tuple:
    """A collective's axes as a tuple in (x, y, z) order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    bad = [a for a in axes if a not in _AXES]
    if bad or not axes:
        raise ValueError(f"axes must be a non-empty subset of {_AXES}, got {axes!r}")
    return tuple(a for a in _AXES if a in axes)


class Mesh:
    """One rank's view of the (x, y, z) process grid: its `Grid3`, its
    coordinates, its device, its transport and a process group per axis
    subset it belongs to (none where the subset spans one rank).

    Collectives take axis names, as the JAX package's do: `psum`, `pmax`,
    `all_gather` (stacked in axis-coordinate order), `ppermute` (zero
    fill on ranks that receive nothing) and `replicate`. Every rank of a
    group must make the same collectives in the same order with tensors
    of one shape and dtype."""

    def __init__(self, grid: Grid3, coords: tuple, device: torch.device,
                 transport: str, groups: dict):
        self.grid = grid
        self.coords = tuple(coords)
        self.device = torch.device(device)
        self.transport = transport
        self._groups = groups  # axes -> process group (subsets of > 1 rank)
        self.stats = {"collectives": 0, "bytes": 0, "staged_bytes": 0}

    def __repr__(self) -> str:
        return (f"Mesh(grid={self.grid}, coords={self.coords}, device={self.device}, "
                f"transport={self.transport!r})")

    @property
    def rank(self) -> int:
        x, y, z = self.coords
        return (x * self.grid.Py + y) * self.grid.Pz + z

    @property
    def x(self) -> int:
        return self.coords[0]

    @property
    def y(self) -> int:
        return self.coords[1]

    @property
    def z(self) -> int:
        return self.coords[2]

    def coord(self, axis: str) -> int:
        return self.coords[_AXES.index(axis)]

    def size(self, axes) -> int:
        dims = dict(zip(_AXES, (self.grid.Px, self.grid.Py, self.grid.Pz)))
        n = 1
        for a in _norm_axes(axes):
            n *= dims[a]
        return n

    # ------------------------------------------------------------------ #
    # the wire: a transport carries the tensors it can, or raises
    # ------------------------------------------------------------------ #

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """t as the transport carries it: itself, or a host copy (staged)."""
        if t.is_complex():
            raise TypeError("collectives carry real tensors; pass complex ones "
                            "as torch.view_as_real")
        if self.transport == "gloo" and t.device.type != "cpu":
            raise TypeError(f"transport 'gloo' carries CPU tensors, got one on {t.device}; "
                            "name transport 'staged' (host copies) or 'nccl'")
        if self.transport == "nccl" and t.device.type != "cuda":
            raise TypeError(f"transport 'nccl' carries CUDA tensors, got one on {t.device}")
        if self.transport == "staged" and t.device.type == "cuda":
            self.stats["staged_bytes"] += t.nbytes
            return t.to("cpu")
        return t

    def _unwire(self, wire: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if wire is not t:
            self.stats["staged_bytes"] += wire.nbytes
            t.copy_(wire)
        return t

    def _count(self, t: torch.Tensor) -> None:
        self.stats["collectives"] += 1
        self.stats["bytes"] += t.nbytes

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        import torch.distributed as dist

        pg = self._groups.get(_norm_axes(axes))
        if pg is None:
            return t
        real = torch.view_as_real(t) if t.is_complex() else t
        if not real.is_contiguous():
            raise ValueError("collectives reduce contiguous tensors")
        self._count(real)
        wire = self._wire(real)
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        pg.allreduce([wire], opts).wait()
        self._unwire(wire, real)
        return t

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum of t over the ranks of `axes`, in place on t (contiguous,
        owned by the caller), which is returned. Complex tensors sum as
        their real and imaginary parts."""
        import torch.distributed as dist

        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise max of t over the ranks of `axes`, in place."""
        import torch.distributed as dist

        if t.is_complex():
            raise TypeError("no reduction takes the max of complex values; use replicate")
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def replicate(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Re-establish replication over `axes` of an already identical
        value (a pmax, in place). Complex values ride as their real and
        imaginary parts: no backend reduces a complex max."""
        import torch.distributed as dist

        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *t.shape): every rank's t along `axis`, stacked in
        axis-coordinate order. Complex tensors ride as their real and
        imaginary parts."""
        pg = self._groups.get(_norm_axes(axis))
        if pg is None:
            return t[None].clone()
        if t.is_complex():
            return torch.view_as_complex(
                self.all_gather(torch.view_as_real(t.resolve_conj()), axis))
        t = t.contiguous()
        n = self.size(axis)
        self._count(t)
        wire = self._wire(t)
        out = [torch.empty_like(wire) for _ in range(n)]
        pg.allgather([out], [wire]).wait()
        res = torch.stack(out)
        if res.device != t.device:
            self.stats["staged_bytes"] += res.nbytes
            res = res.to(t.device)
        return res

    def ppermute(self, t: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """Send t along `axis` by the (source, destination) coordinate
        pairs of `perm` (each coordinate a source once and a destination
        once at most) and return what this rank received: zeros of t's
        shape on a rank that receives nothing, as the JAX ppermute
        fills. Complex tensors ride as their real and imaginary parts."""
        if t.is_complex():
            return torch.view_as_complex(
                self.ppermute(torch.view_as_real(t.resolve_conj()), axis, perm))
        perm = [(int(s), int(d)) for s, d in perm]
        c = self.coord(axis)
        srcs = [s for s, d in perm if d == c]
        dsts = [d for s, d in perm if s == c]
        if len(srcs) > 1 or len(dsts) > 1:
            raise ValueError(f"ppermute pairs are not a permutation: {perm}")
        t = t.contiguous()
        out = torch.zeros_like(t)
        pg = self._groups.get(_norm_axes(axis))
        if pg is None:
            return t.clone() if (c, c) in perm else out
        self._count(t)
        works, recv_wire = [], None
        if dsts:
            if dsts[0] == c:
                out.copy_(t)
            else:
                works.append(pg.send([self._wire(t)], dsts[0], 0))
        if srcs and srcs[0] != c:
            recv_wire = self._wire(out)
            works.append(pg.recv([recv_wire], srcs[0], 0))
        for w in works:
            w.wait()
        if recv_wire is not None:
            self._unwire(recv_wire, out)
        return out

    def barrier(self) -> None:
        pg = self._groups.get(_AXES)
        if pg is not None:
            pg.barrier().wait()


def butterfly_allreduce(mesh: Mesh, vals: tuple, Px: int, axis: str, reduce_pair):
    """Hypercube all-reduce over a grid axis (the reference's tournament
    butterfly shape, `conflux_opt.hpp:220-336`): each round, partners
    exchange `vals` by `ppermute` and `reduce_pair(top, bot)` combines the
    two tuples into the next `vals`.

    The pair is ordered by the LOWER coordinate, so both partners reduce
    bit-identical inputs and the result converges replicated across the
    axis without a broadcast (tie-stable for order-dependent reducers like
    the CALU tournament).

    Non-power-of-two Px, as the reference patches odd grids with
    compensating sends (`conflux_opt.hpp:266-280`): with p the largest
    power of two <= Px and r = Px - p, a pre-round folds each overflow rank
    p+i into rank i (i < r), the log2(p) butterfly runs over the [0, p)
    subcube, and a post-round sends the replicated result back to the
    overflow ranks. Every rank makes every round's ppermute; a rank whose
    reduction the JAX package discards by a coordinate select (it reduced
    the zero fill) skips it here."""
    x = mesh.coord(axis)
    p = 1 << (Px.bit_length() - 1)  # largest power of two <= Px
    r = Px - p
    if r:
        recv = tuple(mesh.ppermute(v, axis, [(p + i, i) for i in range(r)]) for v in vals)
        if x < r:  # overflow rank p+x's contribution joins this rank's
            vals = tuple(reduce_pair(vals, recv))
    for rnd in range(p.bit_length() - 1):
        bit = 1 << rnd
        others = tuple(mesh.ppermute(v, axis, [(i, i ^ bit) for i in range(p)])
                       for v in vals)
        if x < p:
            low_first = (x & bit) == 0
            top, bot = (vals, others) if low_first else (others, vals)
            vals = tuple(reduce_pair(top, bot))
    if r:
        recv = tuple(mesh.ppermute(v, axis, [(i, p + i) for i in range(r)]) for v in vals)
        if x >= p:
            vals = recv
    return vals


def _group_name(axes: tuple, coords: tuple) -> str:
    fixed = ",".join(f"{a}={c}" for a, c in zip(_AXES, coords) if a not in axes)
    return f"conflux/{''.join(axes)}/{fixed}/"


def _group_rank(grid: Grid3, axes: tuple, coords: tuple) -> int:
    dims = dict(zip(_AXES, (grid.Px, grid.Py, grid.Pz)))
    r = 0
    for a, c in zip(_AXES, coords):
        if a in axes:
            r = r * dims[a] + c
    return r


def _default_device(transport: str | None) -> torch.device:
    from conflux_tpu_torch.device import resolve_device

    if transport == "gloo":
        return torch.device("cpu")
    resolve_device("cuda")  # raises on a machine without a card
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(grid: Grid3, *, rank: int | None = None, store=None, device=None,
              transport: str | None = None, timeout: float = _DEFAULT_TIMEOUT) -> Mesh:
    """This rank's `Mesh` of the (x, y, z) grid.

    At grid.P == 1 no process group is made. Else the groups are built
    over `store` with this rank's `rank` (both given: a threaded world,
    see `run_threaded`), or over the default process group's store and
    rank (`initialize_multihost`, whose world size must be grid.P). Rank
    r has coordinates x = r // (Py Pz), y = (r // Pz) % Py, z = r % Pz.

    `device` is the rank's device (default: the card, `cuda:$LOCAL_RANK`,
    or the CPU under transport "gloo"); `transport` "gloo", "nccl" or
    "staged" (default: "gloo" for a CPU device, "nccl" for a card; several
    ranks on one card must name "staged"). Every rank of the world makes
    its mesh at the same time: group construction meets its peers."""
    import torch.distributed as dist

    if transport is not None and transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; valid: {TRANSPORTS}")
    if device is None:
        device = _default_device(transport)
    else:
        from conflux_tpu_torch.device import resolve_device

        device = resolve_device(device)
    if transport is None:
        transport = "gloo" if device.type == "cpu" else "nccl"
    if transport == "gloo" and device.type != "cpu":
        raise ValueError("transport 'gloo' carries CPU tensors; a card's ranks name "
                         "'nccl' (one card per rank) or 'staged'")
    if transport == "nccl" and device.type != "cuda":
        raise ValueError("transport 'nccl' needs a card per rank")
    P = grid.P
    if P == 1:
        return Mesh(grid, (0, 0, 0), device, transport, {})
    if store is None:
        if not dist.is_initialized():
            raise RuntimeError(
                f"grid {grid} spans {P} ranks: call initialize_multihost() first "
                "(torchrun sets its environment), or pass store= and rank=")
        store = dist.distributed_c10d._get_default_store()
        if rank is None:
            rank = dist.get_rank()
        if dist.get_world_size() != P:
            raise ValueError(f"grid {grid} needs {P} ranks, the world has "
                             f"{dist.get_world_size()}")
    if rank is None or not 0 <= rank < P:
        raise ValueError(f"rank {rank} outside the grid's {P} ranks")
    coords = (rank // (grid.Py * grid.Pz), (rank // grid.Pz) % grid.Py, rank % grid.Pz)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    groups = {}
    dims = dict(zip(_AXES, (grid.Px, grid.Py, grid.Pz)))
    # every rank builds its groups in one order: a subset's groups partition
    # the world, so each construction meets all of its members
    for n in (1, 2, 3):
        for axes in itertools.combinations(_AXES, n):
            size = 1
            for a in axes:
                size *= dims[a]
            if size == 1:
                continue
            sub = dist.PrefixStore(_group_name(axes, coords), store)
            grank = _group_rank(grid, axes, coords)
            if transport == "nccl":
                opts = dist.ProcessGroupNCCL.Options()
                if hasattr(opts, "_timeout"):
                    opts._timeout = timedelta(seconds=timeout)
                groups[axes] = dist.ProcessGroupNCCL(sub, grank, size, opts)
            else:
                groups[axes] = dist.ProcessGroupGloo(sub, grank, size,
                                                     timedelta(seconds=timeout))
    return Mesh(grid, coords, device, transport, groups)


def run_threaded(grid: Grid3, fn, *, device="cpu", transport: str | None = None,
                 timeout: float = 120.0) -> list:
    """Run fn(mesh) on grid.P ranks as threads of this process, over one
    in-memory store: the world of the tests and of `chip_smoke.py`.
    Returns each rank's result, by rank. A rank that raises fails the run
    at once (its error re-raised); a run not done within `timeout`
    seconds raises TimeoutError, as does a collective that waits longer
    for its peers: a hung rank fails, it never hangs the caller. On the
    CPU each rank runs torch on one intra-op thread for the run (the
    ranks are the parallelism)."""
    import torch.distributed as dist

    P = grid.P
    store = dist.HashStore()
    missing = object()
    results: list = [missing] * P
    errors: list = [None] * P

    def body(r):
        try:
            mesh = make_mesh(grid, rank=r, store=store, device=device,
                             transport=transport, timeout=timeout)
            results[r] = fn(mesh)
        except Exception as e:  # re-raised by the caller's thread
            errors[r] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"conflux-rank-{r}") for r in range(P)]
    cpu = torch.device(device).type == "cpu"
    if not cpu:
        # torch loads its CUDA linear-algebra library at the first call, and
        # that lazy load must not race between the ranks' threads
        eye = torch.eye(2, device=device)
        torch.linalg.solve_triangular(eye, eye, upper=False)
        torch.linalg.lu_factor_ex(eye)
        torch.linalg.cholesky_ex(eye)
    prev = torch.get_num_threads()
    if cpu and P > 1:  # the ranks are the parallelism
        torch.set_num_threads(1)
    try:
        deadline = time.monotonic() + timeout
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            failed = [r for r in range(P) if errors[r] is not None]
            if failed or time.monotonic() > deadline:
                break
            for t in threads:
                t.join(timeout=0.01)
    finally:
        if cpu and P > 1:
            torch.set_num_threads(prev)
    failed = [r for r in range(P) if errors[r] is not None]
    if failed:
        raise RuntimeError(f"rank {failed[0]} of {P} failed: {errors[failed[0]]!r}") \
            from errors[failed[0]]
    alive = [r for r, t in enumerate(threads) if t.is_alive()]
    if alive:
        raise TimeoutError(f"ranks {alive} of grid {grid} did not finish within {timeout} s")
    lost = [r for r in range(P) if results[r] is missing]
    if lost:  # a thread ended by a BaseException
        raise RuntimeError(f"ranks {lost} of grid {grid} ended without a result")
    return results


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         **kwargs) -> None:
    """Bring up the process world: the role of `MPI_Init`
    (`examples/conflux_miniapp.cpp:90`). With no arguments the world comes
    from the environment torchrun sets (env://: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK); `coordinator_address` "host:port" with
    `num_processes` and `process_id` names it explicitly. `backend`
    defaults to "nccl" on a machine with a card, else "gloo"; `make_mesh`
    then builds the grid's groups over this world's store."""
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def distribute_shards(shards, mesh: Mesh, *, shape: tuple | None = None,
                      dtype=None) -> torch.Tensor:
    """This rank's (Ml, Nl) block-cyclic shard, on the mesh's device.

    Two forms:

    - `shards` is the full (Px, Py, Ml, Nl) host array (numpy or torch):
      this rank takes [x, y] (every process holds the whole thing: fine on
      one host);
    - `shards` is a callable `(px, py) -> (Ml, Nl) array` and
      `shape`/`dtype` give the global (Px, Py, Ml, Nl) spec: it is called
      for THIS rank's coordinates only, so no rank ever materializes the
      global matrix (the reference's per-rank `InitMatrix` fill,
      `lu_params.hpp:141-376`).

    Layer z != 0 ranks get the same shard; the factorizations read it on
    layer 0 only."""
    import numpy as np

    from conflux_tpu_torch.lu.single import from_numpy

    x, y = mesh.x, mesh.y
    if callable(shards):
        if shape is None or dtype is None:
            raise ValueError("callable form requires shape= and dtype=")
        blk = np.asarray(shards(x, y), dtype=dtype)
        if tuple(blk.shape) != tuple(shape[2:]):
            raise ValueError(f"shard of ({x}, {y}) is {blk.shape}, the spec "
                             f"{tuple(shape)} wants {tuple(shape[2:])}")
        return from_numpy(blk, mesh.device)
    if isinstance(shards, torch.Tensor):
        return shards[x, y].to(mesh.device).clone()
    return from_numpy(np.asarray(shards)[x, y], mesh.device)


def gather_shards(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (Ml, Nl) shard as the (Px, Py, Ml, Nl) stack, on every
    rank (the shards must be z-replicated, as the factorizations' outputs
    are): two all_gathers, over y then x."""
    return mesh.all_gather(mesh.all_gather(shard, AXIS_Y), AXIS_X)
