"""Tile kernels behind a backend registry (the port of `conflux_tpu/ops/blas.py`).

Every tile-level flop of the factorization goes through these entry points.
The registry keeps the JAX package's knobs under the same names:

- `set_backend` picks the GEMM: `"kernel"` (the default and, so far, the
  only backend: the port's counterpart of the JAX `"pallas"` backend) runs
  the hand-written CUDA kernel `hopper_kernels.gemm`.
- `set_panel_algo` picks the panel factorization: `"kernel"` (the default,
  the counterpart of the JAX `"pallas"` panel algorithm) eliminates 128-wide
  column blocks with `hopper_kernels.lu_block`. The JAX package's
  `"partial"`, `"tournament"` and `"auto"` run the library LU
  (`lax.linalg.lu`) and are not ported yet: they raise.

A kernel gets a CUDA tensor or raises; a CPU tensor runs the kernel's plain
PyTorch version (see `hopper_kernels`). float32 matmuls run in full IEEE
float32: TF32 is switched off below, as the JAX package pins
`Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops import hopper_kernels

# the JAX package pins Precision.HIGHEST: ~1e-2 LU residuals follow without it
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_BACKEND = "kernel"
_VALID_BACKENDS = ("kernel",)

_PANEL_ALGO = "kernel"
_PANEL_ALGOS = ("kernel",)
# the JAX package's library-LU panel algorithms, waiting for a later slice
_DEFERRED_PANEL_ALGOS = ("auto", "partial", "tournament")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _VALID_BACKENDS:
        raise ValueError(f"unknown backend {name!r}; valid: {_VALID_BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def set_panel_algo(name: str) -> None:
    global _PANEL_ALGO
    _check_panel_algo(name)
    _PANEL_ALGO = name


def get_panel_algo() -> str:
    return _PANEL_ALGO


def _check_panel_algo(name: str) -> None:
    if name in _DEFERRED_PANEL_ALGOS:
        raise NotImplementedError(
            f"panel algo {name!r} runs the library LU and is not ported yet; "
            f"the port has {_PANEL_ALGOS}")
    if name not in _PANEL_ALGOS:
        raise ValueError(f"unknown panel algo {name!r}")


# --------------------------------------------------------------------------- #
# GEMM
# --------------------------------------------------------------------------- #


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
         alpha: float = 1.0, beta: float = 1.0, backend: str | None = None,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """alpha * a @ b (+ beta * c): the trailing-update hot op.

    The kernel folds the epilogue into its store and may write into `out`
    (which may be `c`); inputs keep their dtype (float32, or bfloat16 with
    f32 accumulation).
    """
    backend = _BACKEND if backend is None else backend
    if backend not in _VALID_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: {_VALID_BACKENDS}")
    return hopper_kernels.gemm(a, b, c, alpha, beta, out=out)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype for panel factorizations and triangular solves: bfloat16 and
    float16 storage use float32 panel math (panel accuracy sets the
    factorization's accuracy); the trailing GEMMs stay in the storage
    dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


# --------------------------------------------------------------------------- #
# Triangular solves
# --------------------------------------------------------------------------- #


def trsm_left_lower_unit(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L unit lower triangular (A01 panel update)."""
    return torch.linalg.solve_triangular(L, B, upper=False, left=True,
                                         unitriangular=True)


def trsm_right_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve X U = B with U upper triangular (L10 panel update)."""
    return torch.linalg.solve_triangular(U, B, upper=True, left=False)


def trsm_left_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U X = B with U upper triangular (LU back-substitution)."""
    return torch.linalg.solve_triangular(U, B, upper=True, left=True)


# --------------------------------------------------------------------------- #
# Chunk ceilings
# --------------------------------------------------------------------------- #

# The JAX package sizes its tournament chunks from the TPU's 32 MiB scoped
# VMEM budget. The chunking decides which rows the tournament nominates, so
# the port pins the same budget (no device detection): pivots then match
# the JAX package's on every device. An H100-derived chunk is later work.
_SCOPED_VMEM_DEFAULT = 32 << 20


def single_call_rows(v: int, dtype=torch.float32, budget: int | None = None
                     ) -> int:
    """Max rows of ONE (m, v) panel LU call within the pinned budget,
    tile-rounded, at least one tile (1024 -> 8192 at f32)."""
    budget = _SCOPED_VMEM_DEFAULT if budget is None else budget
    elems = budget // torch.empty((), dtype=dtype).element_size()
    return max(v, (elems // v) // v * v)


def batched_call_rows(v: int, dtype=torch.float32, budget: int | None = None
                      ) -> int:
    """Max per-element rows of a BATCHED (b, m, v) call: half the
    single-call height (1024 -> 4096 at f32)."""
    budget = _SCOPED_VMEM_DEFAULT if budget is None else budget
    elems = budget // torch.empty((), dtype=dtype).element_size() // 2
    return max(v, (elems // v) // v * v)


# --------------------------------------------------------------------------- #
# Panel factorizations
# --------------------------------------------------------------------------- #

# Tallest panel the elimination kernel factors in one pass. The TPU kernel's
# VMEM limit (the JAX package's value, kept so the tournament chunking and
# so the pivots match); module-level so tests can shrink it.
_PALLAS_MAX_ROWS = 4096


def _pallas_panel_ok(dtype, m: int, v: int) -> bool:
    """Whether the elimination kernel can factor an (m, v) panel."""
    return dtype == torch.float32 and v % hopper_kernels._PANEL_W == 0 \
        and m <= _PALLAS_MAX_ROWS


def _resolve_panel_algo(dtype, m: int, v: int, algo: str) -> str:
    """Validate `algo` and gate the kernel's eligibility (float32, width a
    multiple of 128)."""
    _check_panel_algo(algo)
    if not _pallas_panel_ok(dtype, min(m, _PALLAS_MAX_ROWS), v):
        raise ValueError(
            f"the panel kernel supports float32 with width a multiple of "
            f"{hopper_kernels._PANEL_W}, got {dtype} ({m}, {v})")
    return algo


def panel_lu(panel: torch.Tensor, algo: str | None = None):
    """Pivoted LU of an (m, v) panel.

    Returns (lu_packed, perm): perm is a length-m row permutation such that
    panel[perm] == L @ U with L unit-lower (m, v) and U upper (v, v) packed
    into lu_packed. Panels taller than `_PALLAS_MAX_ROWS` go through the
    tournament with kernel-factored chunks.
    """
    m, v = panel.shape
    _resolve_panel_algo(panel.dtype, m, v, _PANEL_ALGO if algo is None else algo)
    if m > _PALLAS_MAX_ROWS:
        return panel_lu_tournament(panel, chunk=_PALLAS_MAX_ROWS,
                                   use_pallas=True)
    return panel_lu_pallas(panel)


def chunk_layout(m: int, v: int, chunk: int | None = None) -> tuple[int, int]:
    """(chunk height c, chunk count nch) of :func:`tournament_winners` for
    an (m, v) panel."""
    c = chunk if chunk is not None else batched_call_rows(v)
    c = min(c, -(-m // v) * v)  # never taller than the (tile-rounded) panel
    c = max(v, c // v * v)  # multiple of v, at least one tile tall
    return c, -(-m // c)


def tournament_winners(panel: torch.Tensor, chunk: int | None = None,
                       use_pallas: bool = True):
    """Elect v pivot rows of an (m, v) panel by tournament (CALU).

    Rows are split into chunks; each chunk's pivoted LU nominates its top v
    rows, and a pairwise reduction tree of stacked (2v, v) LUs elects the
    winners. Returns (lu00, gpiv): the packed (v, v) LU of the winners in
    pivot order and their row ids in `panel`. Pad rows (zero rows with the
    out-of-range id `mp`) lose every contest against full-rank data.

    Only the kernel route (`use_pallas=True`) is ported; the library-LU
    route, `tree='flat'` and `chunk_live` wait for a later slice.
    """
    if not use_pallas:
        raise NotImplementedError(
            "tournament_winners without the panel kernel runs the library "
            "LU and is not ported yet")
    m, v = panel.shape
    if m < v:
        raise ValueError(
            f"tournament_winners needs m >= v, got ({m}, {v})")
    c, nch = chunk_layout(m, v, chunk)
    if not _pallas_panel_ok(panel.dtype, c, v):
        raise ValueError(f"chunk ({c}, {v}) {panel.dtype} does not fit the "
                         "panel kernel")
    mp = nch * c
    dev = panel.device
    if mp != m:
        panel = torch.cat([panel, panel.new_zeros((mp - m, v))])
    ids = torch.arange(mp, device=dev)
    cand = panel.reshape(nch, c, v)
    cid = ids.reshape(nch, c)
    outs = [panel_lu_pallas(cand[i]) for i in range(nch)]
    top = torch.stack([o[1][:v] for o in outs])  # (nch, v)
    win = torch.gather(cand, 1, top[:, :, None].expand(nch, v, v))
    wid = torch.gather(cid, 1, top)

    if nch == 1:  # single chunk: its local LU already decided everything
        return outs[0][0][:v], wid[0]

    n = 1 << (nch - 1).bit_length()
    if n != nch:
        # pad blocks: zero rows with out-of-range ids, losing every contest
        win = torch.cat([win, win.new_zeros((n - nch, v, v))])
        wid = torch.cat([wid, wid.new_full((n - nch, v), mp)])

    lu_top = None
    while n > 1:
        stacked = win.reshape(n // 2, 2 * v, v)
        sid = wid.reshape(n // 2, 2 * v)
        outs = [panel_lu_pallas(stacked[i]) for i in range(n // 2)]
        top = torch.stack([o[1][:v] for o in outs])
        lu_top = torch.stack([o[0][:v] for o in outs])
        win = torch.gather(stacked, 1, top[:, :, None].expand(n // 2, v, v))
        wid = torch.gather(sid, 1, top)
        n //= 2
    # the final round's packed LU rows 0..v are the winners, factored
    return lu_top[0], wid[0]


def _winners_first(gpiv: torch.Tensor, m: int) -> torch.Tensor:
    """Permutation with the winners first (in pivot order) and the other
    rows after them in their original order. Ids outside [0, m) are
    dropped, as the JAX package's `mode="drop"` scatters drop them."""
    v = gpiv.shape[0]
    dev = gpiv.device
    ids = torch.arange(m, device=dev)
    ok = (gpiv >= 0) & (gpiv < m)
    tgt = torch.where(ok, gpiv, m)  # out-of-range ids land in a dropped slot
    is_piv = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    is_piv[tgt] = True
    pos = torch.zeros(m + 1, dtype=torch.long, device=dev)
    pos[tgt] = torch.arange(v, device=dev)
    key = torch.where(is_piv[:m], pos[:m], v + ids)
    return torch.argsort(key, stable=True)


def panel_lu_pallas(panel: torch.Tensor):
    """Blocked panel LU with full-height partial pivoting on the elimination
    kernel (the port of the JAX `panel_lu_pallas`; same contract as
    :func:`panel_lu`).

    The (m, v) panel is factored in 128-wide column blocks, each eliminated
    by `hopper_kernels.lu_block` with no row movement: pivot rows keep their
    positions and an alive mask shrinks. Between blocks, a row-gathered
    TRSM and one masked GEMM update the columns to the right. Rows are
    gathered into LAPACK order once, at the end. m <= `_PALLAS_MAX_ROWS`.
    """
    w = hopper_kernels._PANEL_W
    m, v = panel.shape
    if v % w:
        raise ValueError(f"panel width {v} not a multiple of {w}")
    A = panel.clone(memory_format=torch.contiguous_format)
    alive = torch.ones((m, 1), dtype=torch.int32, device=panel.device)
    pivs = []
    for off in range(0, v, w):
        out, alive_new, piv = hopper_kernels.lu_block(A[:, off:off + w], alive)
        A[:, off:off + w] = out
        pivrows = piv[0].long()  # (w,) absolute row ids in pivot order
        pivs.append(pivrows)
        if off + w < v:
            L00 = out[pivrows]  # (w, w) packed rows in pivot order
            rest = A[:, off + w:]
            U01 = trsm_left_lower_unit(unit_lower(L00), rest[pivrows])
            # multipliers of still-live rows only (pivot rows contribute 0)
            L10 = torch.where(alive_new != 0, out, 0.0)
            rest -= torch.matmul(L10, U01)
            rest[pivrows] = U01
        alive = alive_new
    perm = _winners_first(torch.cat(pivs), m)
    return A[perm], perm


def panel_winners(panel: torch.Tensor, algo: str = "kernel"):
    """Elect the v pivot rows of an (m, v) panel and factor them: the
    selection half of :func:`panel_lu`. Returns (lu00, gpiv), the packed
    (v, v) LU of the winners in pivot order and their rows in `panel`."""
    m, v = panel.shape
    _resolve_panel_algo(panel.dtype, m, v, algo)
    if m <= _PALLAS_MAX_ROWS:
        lu_packed, perm = panel_lu_pallas(panel)
        return lu_packed[:v], perm[:v]
    return tournament_winners(panel, chunk=_PALLAS_MAX_ROWS, use_pallas=True)


def panel_lu_tournament(panel: torch.Tensor, chunk: int | None = None,
                        use_pallas: bool = True):
    """Tournament-pivoted (CALU) LU of a tall (m, v) panel; same contract
    as :func:`panel_lu`."""
    m, v = panel.shape
    lu00, gpiv = tournament_winners(panel, chunk, use_pallas)
    perm = _winners_first(gpiv, m)
    rest = panel[perm[v:]]
    L10 = trsm_right_upper(torch.triu(lu00), rest)
    return torch.cat([lu00, L10], dim=0), perm


def unit_lower(lu00: torch.Tensor) -> torch.Tensor:
    """Extract the unit-lower L00 from a packed (v, v) LU diagonal block."""
    v = lu00.shape[0]
    return torch.tril(lu00, -1) + torch.eye(v, dtype=lu00.dtype,
                                            device=lu00.device)
