"""Tile kernels behind a backend registry (the port of `conflux_tpu/ops/blas.py`).

Every tile-level flop of the factorization goes through these entry points.
The registry keeps the JAX package's knobs under the same names:

- `set_backend` picks the GEMM: `"kernel"` (the port's default, the
  counterpart of the JAX `"pallas"` backend) runs the hand-written CUDA
  kernel `hopper_kernels.gemm` (float32 and bfloat16); `"xla"` (the JAX
  package's default) runs the library product `torch.matmul`, the plain
  large product the JAX package leaves to XLA, in every dtype (float64 and
  complex included).
- `set_panel_algo` picks the panel factorization: `"kernel"` (the port's
  default, the counterpart of the JAX `"pallas"` panel algorithm)
  eliminates 128-wide column blocks with `hopper_kernels.lu_block`
  (float32 only); the JAX package's `"partial"`, `"tournament"` and
  `"auto"` run the library LU (`torch.linalg.lu_factor_ex`, where the JAX
  package runs `lax.linalg.lu`) in any dtype.

- `set_matmul_precision` picks the precision of the library products, the
  JAX package's `lax.Precision` levels under the port's own
  :class:`Precision`: HIGHEST (the default) is IEEE float32; DEFAULT and
  HIGH run a float32 or complex64 library product on the card as one
  TensorFloat-32 tensor-core pass (what XLA runs for them on a GPU of
  this class). The kernels run IEEE float32 at every level, as the JAX
  package's Pallas kernels take no precision, and so does the CPU.

A kernel gets a CUDA tensor or raises; a CPU tensor runs the kernel's plain
PyTorch version (see `hopper_kernels`). torch's process-wide TF32 switches
stay off (below): a TF32 product is chosen per call, through its own cuBLAS
compute type (:func:`tf32_gemm`), so an IEEE product in another thread
stays IEEE.
"""

from __future__ import annotations

import ctypes
import enum
import threading

import numpy as np
import torch

from conflux_tpu_torch.ops import hopper_kernels
from conflux_tpu_torch.profiler import scope, sync

# IEEE float32 unless a call asks for TF32 (`gemm` at DEFAULT or HIGH): these
# switches are process-wide, so a product in another thread would follow them
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_BACKEND = "kernel"
_VALID_BACKENDS = ("kernel", "xla")

_PANEL_ALGO = "kernel"
_PANEL_ALGOS = ("kernel", "auto", "partial", "tournament")


def set_backend(name: str) -> None:
    global _BACKEND
    _BACKEND = check_backend(name)


def check_backend(name: str) -> str:
    """Validate a `backend=` name ("kernel" or "xla")."""
    if name not in _VALID_BACKENDS:
        raise ValueError(f"unknown backend {name!r}; valid: {_VALID_BACKENDS}")
    return name


def get_backend() -> str:
    return _BACKEND


class Precision(enum.Enum):
    """The JAX package's matmul precision levels (`lax.Precision`), the
    port's own copy, with the same string names: 'default', 'fastest' and
    'bfloat16' are DEFAULT; 'high', 'bfloat16_3x' and 'tensorfloat32' HIGH;
    'highest' and 'float32' HIGHEST."""

    DEFAULT = 0
    HIGH = 1
    HIGHEST = 2

    @classmethod
    def _missing_(cls, value):
        return _PRECISION_NAMES.get(value)

    def __repr__(self) -> str:
        return f"Precision.{self.name}"

    def __str__(self) -> str:
        return self.name


_PRECISION_NAMES = {
    "default": Precision.DEFAULT, "fastest": Precision.DEFAULT,
    "bfloat16": Precision.DEFAULT, "high": Precision.HIGH,
    "bfloat16_3x": Precision.HIGH, "tensorfloat32": Precision.HIGH,
    "highest": Precision.HIGHEST, "float32": Precision.HIGHEST}

# HIGHEST, as the JAX package pins it: TF32 rounds both operands of every
# product (unit roundoff 2^-11, float32's 2^-24), and an LU factored so
# reads ~2^14 times the float32 residual
_MATMUL_PRECISION = Precision.HIGHEST


def set_matmul_precision(p) -> None:
    """Set the precision the entry points resolve `precision=None` to: a
    :class:`Precision`, its name, or one of its string names. The value
    is kept as given (a plan key records it so)."""
    global _MATMUL_PRECISION
    resolve_precision(p)
    _MATMUL_PRECISION = p


def matmul_precision():
    """The registry's matmul precision, as it was set."""
    return _MATMUL_PRECISION


def resolve_precision(precision=None) -> Precision:
    """`precision=` as a :class:`Precision`: None is the registry's value;
    a :class:`Precision`, an enum member of the same name (the JAX
    package's `lax.Precision`), a string name of `lax.Precision` or an
    enum name in any case. Another value raises ValueError."""
    p = _MATMUL_PRECISION if precision is None else precision
    if isinstance(p, Precision):
        return p
    name = getattr(p, "name", None)
    if isinstance(name, str) and name in Precision.__members__:
        return Precision[name]
    if isinstance(p, str):
        if p in _PRECISION_NAMES:
            return _PRECISION_NAMES[p]
        if p.upper() in Precision.__members__:
            return Precision[p.upper()]
    raise ValueError(f"unknown matmul precision {p!r}: expected a Precision, one of "
                     f"{sorted(Precision.__members__)} or {sorted(_PRECISION_NAMES)}")


def check_gemm_route(backend: str, dtype: torch.dtype) -> None:
    """Refuse a dtype the backend's GEMM does not take: the K1 kernel
    (backend "kernel") has float32 and bfloat16 instances only, as the
    JAX Pallas GEMM; float64 and complex run on backend "xla"."""
    if check_backend(backend) == "kernel" and dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"backend 'kernel' runs the K1 GEMM kernel, which takes float32 and "
            f"bfloat16; {dtype} runs on backend 'xla'")


def set_panel_algo(name: str) -> None:
    global _PANEL_ALGO
    _check_panel_algo(name)
    _PANEL_ALGO = name


def get_panel_algo() -> str:
    return _PANEL_ALGO


def _check_panel_algo(name: str) -> None:
    if name not in _PANEL_ALGOS:
        raise ValueError(f"unknown panel algo {name!r}; valid: {_PANEL_ALGOS}")


# --------------------------------------------------------------------------- #
# GEMM
# --------------------------------------------------------------------------- #


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
         alpha: float = 1.0, beta: float = 1.0, precision=None,
         backend: str | None = None, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """alpha * a @ b (+ beta * c): the trailing-update hot op.

    Backend "kernel": the K1 kernel, 2D float32 or bfloat16 operands with
    f32 accumulation, its epilogue folded into the store; it takes no
    precision, as the JAX package's Pallas GEMM takes none. Backend
    "xla": the library product in a's dtype with leading batch axes
    allowed; bfloat16 and float16 accumulate in float32 and the product
    is rounded back before the epilogue, as the JAX `jnp.matmul(...,
    preferred_element_type=f32).astype(a.dtype)` does. On the card a
    float32 or complex64 library product at `precision` DEFAULT or HIGH
    (None: the registry's, :func:`resolve_precision`) is one TF32
    tensor-core pass (:func:`tf32_gemm`), at HIGHEST IEEE float32; other
    dtypes and the CPU compute as at HIGHEST. Either backend may write
    into `out`, which may be `c` itself (the trailing block updated in
    place).
    """
    backend = _BACKEND if backend is None else backend
    precision = resolve_precision(precision)
    check_gemm_route(backend, a.dtype)
    if backend == "kernel":
        return hopper_kernels.gemm(a, b, c, alpha, beta, out=out)
    return _library_gemm(a, b, c, alpha, beta, precision, out)


def matmul(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """a @ b as the library product at `precision` (None: the
    registry's): the JAX package's `jnp.matmul(a, b, precision=...)`,
    :func:`gemm` on backend "xla"."""
    return _library_gemm(a, b, None, 1.0, 1.0, resolve_precision(precision), None)


def _library_gemm(a, b, c, alpha, beta, precision: Precision, out):
    """:func:`gemm`'s backend "xla"."""
    if (precision is not Precision.HIGHEST and a.device.type == "cuda"
            and a.dtype in _TF32_CODES and b.dtype == a.dtype):
        return tf32_gemm(a, b, c, alpha, beta, out=out)
    narrow = a.dtype in (torch.bfloat16, torch.float16)
    if c is not None and out is c and not narrow and c.dim() <= 3:
        # in place, the library GEMM's own epilogue: no temporary the size
        # of the trailing block (8.6 GB at N=32768 in float64)
        if c.dim() == 2:
            return c.addmm_(a, b, beta=beta, alpha=alpha)
        lead = c.shape[:1]
        return c.baddbmm_(a.expand(*lead, *a.shape[-2:]), b.expand(*lead, *b.shape[-2:]),
                          beta=beta, alpha=alpha)
    res = torch.matmul(a.float(), b.float()).to(a.dtype) if narrow else torch.matmul(a, b)
    if alpha != 1.0:
        res = alpha * res
    if c is not None:
        res = res + (beta * c if beta != 1.0 else c)
    return res if out is None else out.copy_(res)


# --------------------------------------------------------------------------- #
# The TF32 library product
# --------------------------------------------------------------------------- #

_TF32_CODES = {torch.float32: 0, torch.complex64: 1}
# TF32 library products issued, for a run to show that a path took them
TF32_CALLS = 0
_TF32_COUNT_LOCK = threading.Lock()


def _batch_operand(x: torch.Tensor, batch: tuple):
    """x (..., r, c) as cuBLAS reads a row-major batch: (tensor with unit
    column stride, row pitch, batch stride in elements); a 2D operand is
    one matrix for every batch entry (stride 0)."""
    r, c = x.shape[-2:]
    if x.dim() > 2:
        x = x.expand(*batch, r, c).reshape(-1, r, c)
    x = x.resolve_conj()
    if x.stride(-1) != 1 or (r > 1 and x.stride(-2) < c):
        x = x.contiguous()
    ld = max(x.stride(-2) if r > 1 else c, 1)
    return x, ld, (x.stride(0) if x.dim() == 3 and x.shape[0] > 1 else 0)


def tf32_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
              alpha: float = 1.0, beta: float = 1.0, *,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """alpha * a @ b (+ beta * c) on CUDA float32 or complex64 tensors as
    one TensorFloat-32 tensor-core pass: cuBLAS's
    `cublasGemmStridedBatchedEx` with `CUBLAS_COMPUTE_32F_FAST_TF32`
    (`ops/csrc/tf32_gemm.cu`), on torch's own cuBLAS handle of this
    thread and a's card (`torch.cuda.current_blas_handle`: its workspace
    comes from torch's allocator) and a's current stream. The compute
    type is the call's own, so the handle's math mode does not matter and
    torch's process-wide TF32 switches stay off. A library product, not
    a kernel of the port: it stands where the JAX package leaves a
    DEFAULT or HIGH `jnp.matmul` to XLA. Leading batch axes broadcast; `out` may
    be `c` (in place). A failed build or call raises; there is no
    fallback."""
    global TF32_CALLS
    if a.device.type != "cuda" or a.dtype not in _TF32_CODES or b.dtype != a.dtype:
        raise ValueError(f"tf32_gemm takes CUDA float32 or complex64 operands of one "
                         f"dtype, got {a.dtype} on {a.device} and {b.dtype}")
    M, K = a.shape[-2:]
    K2, N = b.shape[-2:]
    if K != K2:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    oshape = (*batch, M, N)
    nb = 1
    for s in batch:
        nb *= s
    if c is not None and out is c and tuple(c.shape) == oshape and c.dim() <= 3 \
            and c.stride(-1) == 1 and (M < 2 or c.stride(-2) >= N):
        dst, beta_eff = c, beta
    else:
        dst = torch.empty(oshape, dtype=a.dtype, device=a.device)
        beta_eff = 0.0
        if c is not None:
            dst.copy_(c.expand(oshape))
            beta_eff = beta
    if M and N and nb:
        from conflux_tpu_torch.ops import _build

        lib = _build.load()
        a3, lda, sa = _batch_operand(a, batch)
        b3, ldb, sb = _batch_operand(b, batch)
        d3 = dst if dst.dim() == 3 else dst.view(-1, M, N)
        ldc = max(d3.stride(-2) if M > 1 else N, 1)
        sc = d3.stride(0) if nb > 1 else 0
        with torch.cuda.device(a.device):
            rc = lib.conflux_tf32_gemm(
                torch.cuda.current_blas_handle(), _TF32_CODES[a.dtype], nb, M, N, K,
                a3.data_ptr(), lda, sa, b3.data_ptr(), ldb, sb,
                d3.data_ptr(), ldc, sc, float(alpha), float(beta_eff),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"TF32 library product failed: cuBLAS status {rc}")
        with _TF32_COUNT_LOCK:
            TF32_CALLS += 1
    if out is None or out is dst:
        return dst
    return out.copy_(dst)


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


def _ht(x: torch.Tensor) -> torch.Tensor:
    """The transpose of the last two axes, Hermitian for complex dtypes
    (the A = L L^H convention)."""
    return x.mH if x.is_complex() else x.mT


def trsm_right_lower_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve X L^T = B with L lower triangular (Cholesky A10 update); for
    complex dtypes X L^H = B. The result is column-major: `.contiguous()`
    it for the GEMM kernel."""
    return torch.linalg.solve_triangular(_ht(L), B, upper=True, left=False)


def trsm_left_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L lower triangular (Cholesky forward solve)."""
    return torch.linalg.solve_triangular(L, B, upper=False, left=True)


def trsm_left_lower_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = B with L lower triangular (Cholesky back solve); for
    complex dtypes L^H X = B."""
    return torch.linalg.solve_triangular(_ht(L), B, upper=True, left=True)


def trsm_left_upper_t(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U^T X = B with U upper triangular (the transposed-system
    solve, getrs 'T'); a plain transpose for complex dtypes too, as the
    JAX package's."""
    return torch.linalg.solve_triangular(U.mT, B, upper=False, left=True)


def trsm_left_lower_unit_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = B with L unit lower triangular."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True, left=True,
                                         unitriangular=True)


def potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a v x v SPD (HPD) tile or a batch of them
    (reference dpotrf, `Cholesky.cpp:188-194`). Reads the lower triangle
    only, as the JAX package's `symmetrize_input=False` does. A tile that
    is not positive definite comes out NaN (its lower triangle), as the
    JAX Cholesky returns it: no host check, no raise."""
    return _nan_where_failed(*torch.linalg.cholesky_ex(a))


def _nan_where_failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """L with every system whose factorization failed (info != 0) NaN on
    and below the diagonal and zero above, as the JAX Cholesky returns
    it."""
    n = L.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=L.device).tril()
    with sync("potrf_nan"):  # a copy from pageable host memory waits for the card
        nan = torch.tensor(float("nan"), dtype=L.dtype, device=L.device)
    failed = torch.where(lower, nan, torch.zeros((), dtype=L.dtype, device=L.device))
    return torch.where((info != 0)[..., None, None], failed, L)


def blocked_trsm(T: torch.Tensor, B: torch.Tensor, *, lower: bool = True,
                 unit_diagonal: bool = False, dinv=None,
                 block_size: int | None = None, precision=None,
                 backend: str | None = None) -> torch.Tensor:
    """Blocked batched triangular solve through diagonal-block inverses
    (`ops.batched_trsm`): T is (n, n) or (B, n, n), packed factors fine.
    Either backend runs the K3 kernel (`hopper_kernels.btrsm`) on the
    card: the computation is the JAX `blocked_solve` either way, in IEEE
    float32 at every `precision` (None: the registry's)."""
    from conflux_tpu_torch.ops import batched_trsm

    precision = _MATMUL_PRECISION if precision is None else precision
    return batched_trsm.blocked_trsm(
        T, B, lower=lower, unit_diagonal=unit_diagonal, dinv=dinv,
        block_size=block_size, precision=precision, backend=backend)


def _probe_product(probe_w, A: torch.Tensor) -> torch.Tensor:
    """wA = w^T A per slot of a (B, n, n) batch, accumulated as the JAX
    route does (f32 for narrow dtypes, else A's dtype)."""
    acc = compute_dtype(A.dtype)
    w = torch.as_tensor(probe_w).to(device=A.device, dtype=acc)
    return torch.matmul(w, A.to(acc))


def batched_lu_factor(A: torch.Tensor, *, probe_w=None,
                      backend: str | None = None):
    """Batched pivoted LU of (B, n, n) systems: the serve plans' factor.
    Backend "kernel" runs the K4 kernel (`ops.batched_factor`); "xla" the
    batched library LU (`torch.linalg.lu_factor_ex`, as the JAX package
    vmaps `lax.linalg.lu`). Returns (LU, perm), or (LU, perm, wA) with the
    probe row wA = w^T A when `probe_w` is given."""
    backend = check_backend(_BACKEND if backend is None else backend)
    if backend == "xla":
        LU, perm = _library_lu(A)
        if probe_w is None:
            return LU, perm
        return LU, perm, _probe_product(probe_w, A)
    from conflux_tpu_torch.ops import batched_factor

    return batched_factor.kernel_lu_factor_batched(A, probe_w=probe_w)


def batched_cholesky_factor(A: torch.Tensor, *, probe_w=None,
                            backend: str | None = None):
    """Batched lower Cholesky of (B, n, n) SPD systems: the SPD serve
    plans' factor. Backend "kernel" runs the K5 kernel
    (`ops.batched_factor`); "xla" the batched library Cholesky
    (`torch.linalg.cholesky_ex`), a slot that is not positive definite
    coming out NaN as the JAX Cholesky returns it. Returns L, or (L, wA)
    when `probe_w` is given."""
    backend = check_backend(_BACKEND if backend is None else backend)
    if backend == "xla":
        L = potrf(A)
        return L if probe_w is None else (L, _probe_product(probe_w, A))
    from conflux_tpu_torch.ops import batched_factor

    return batched_factor.kernel_cholesky_factor_batched(A, probe_w=probe_w)


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
    """Validate `algo`, resolve "auto" and gate the kernel's eligibility
    (float32, width a multiple of 128). "auto" takes the JAX rule: the
    tournament for panels taller than twice the batched-call height of
    the compute dtype, else partial pivoting. Returns the algo to run."""
    _check_panel_algo(algo)
    if algo == "auto":
        cd = compute_dtype(dtype)
        algo = "tournament" if m > 2 * max(batched_call_rows(v, cd), v) else "partial"
    if algo == "kernel" and not _pallas_panel_ok(dtype, min(m, _PALLAS_MAX_ROWS), v):
        raise ValueError(
            f"panel algo 'kernel' runs the K2 elimination kernel, which takes "
            f"float32 with width a multiple of {hopper_kernels._PANEL_W}, got "
            f"{dtype} ({m}, {v}); other dtypes run the library panel algos "
            "('auto', 'partial', 'tournament')")
    return algo


def _swaps_to_perm(piv: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK pivots (..., k), 1-based row swaps applied in order, as the
    (..., m) int64 permutation perm with A[perm] the swapped rows. One host
    copy of the pivots a call, then a host loop over the k pivot
    positions: one panel swaps the entries of a dict of the rows touched,
    a batch swaps every slot's pair at once (numpy, slot-minor layout, so
    a step's rows are one contiguous run); no dense (m, m) permutation
    matrix."""
    lead = tuple(piv.shape[:-1])
    p = piv.reshape(-1, piv.shape[-1]).cpu().numpy().astype(np.int64) - 1
    B, k = p.shape
    if B == 1:
        moved: dict[int, int] = {}
        for i, j in enumerate(p[0].tolist()):
            if i != j:
                moved[i], moved[j] = moved.get(j, j), moved.get(i, i)
        perm = np.arange(m, dtype=np.int64)[None]
        if moved:
            perm[0, list(moved)] = list(moved.values())
    else:
        flat = np.repeat(np.arange(m, dtype=np.int64), B)  # (m, B) slot-minor
        dst = (p * B + np.arange(B)[:, None]).T.copy()  # (k, B) flat ids of rows p
        for i in range(k):
            here = flat[i * B:(i + 1) * B].copy()
            flat[i * B:(i + 1) * B] = flat[dst[i]]
            flat[dst[i]] = here
        perm = flat.reshape(m, B).T
    return torch.from_numpy(np.ascontiguousarray(perm)).reshape(lead + (m,)).to(piv.device)


# Panels in a batch above which the library LU on the card keeps torch's
# default backend (MAGMA's batched getrf) rather than cuSOLVER's getrf a
# panel at a time. On an H100 (`scripts/torch_library_lu_times.py`, f64):
# cuSOLVER factors (4096, 1024) in 3.65 ms where the default took 25.6,
# (8, 4096, 1024) in 29.0 against 60.0; the default wins at serving's
# (32, 1024, 256), 9.9 against 18.6 ms.
_CUSOLVER_MAX_BATCH = 8
# Tallest panel MAGMA's batched getrf takes without printing its "batched
# routines are designed for small sizes" banner to the process's stdout
# (MAGMA's own limit); taller batches go to cuSOLVER whatever their size.
_MAGMA_BATCH_MAX_ROWS = 2048
# torch's linear-algebra backend preference is one setting of the process:
# `_library_lu` sets it and puts it back under this lock, so that two
# threads' library LUs never interleave their save and restore
_LINALG_LOCK = threading.Lock()


def _library_lu_backend(shape) -> str:
    """The backend the library LU of (..., m, v) panels takes on the card:
    "cusolver" (a panel at a time) for up to `_CUSOLVER_MAX_BATCH` panels
    or panels taller than `_MAGMA_BATCH_MAX_ROWS`, else torch's
    "default" (MAGMA's batched getrf)."""
    batch = int(np.prod(shape[:-2], dtype=np.int64))
    if batch <= _CUSOLVER_MAX_BATCH or shape[-2] > _MAGMA_BATCH_MAX_ROWS:
        return "cusolver"
    return "default"


def _library_lu(a: torch.Tensor):
    """Pivoted library LU of (..., m, v) panels, m >= v: (LU, perm), the
    packed factors in LAPACK order and the (..., m) permutation with
    a[perm] == L U. `lu_factor_ex` does not raise on a zero pivot (the
    JAX `lax.linalg.lu` does not either): the tournament's all-pad blocks
    are such panels. On the card the backend is `_library_lu_backend`'s,
    set for the call and put back under `_LINALG_LOCK` while torch's
    preference is "default"; a preference the caller set is kept."""
    if a.device.type == "cuda" and _library_lu_backend(a.shape) == "cusolver":
        with _LINALG_LOCK:
            prev = torch.backends.cuda.preferred_linalg_library()
            if prev == torch._C._LinalgBackend.Default:
                torch.backends.cuda.preferred_linalg_library("cusolver")
            try:
                LU, piv, _info = torch.linalg.lu_factor_ex(a)
            finally:
                torch.backends.cuda.preferred_linalg_library(prev)
    else:
        LU, piv, _info = torch.linalg.lu_factor_ex(a)
    return LU, _swaps_to_perm(piv, a.shape[-2])


def _per_slot(fn, panels: torch.Tensor):
    """fn of each (m, v) panel of a (B, m, v) batch, results stacked."""
    outs = [fn(p) for p in panels]
    return tuple(torch.stack(x) for x in zip(*outs))


def panel_lu(panel: torch.Tensor, algo: str | None = None):
    """Pivoted LU of an (m, v) panel, or of each panel of a (B, m, v)
    batch.

    Returns (lu_packed, perm): perm is a length-m row permutation such that
    panel[perm] == L @ U with L unit-lower (m, v) and U upper (v, v) packed
    into lu_packed (with a leading B for a batch). "kernel": panels taller
    than `_PALLAS_MAX_ROWS` go through the tournament with kernel-factored
    chunks, else one batched K2 elimination per column block; "partial":
    the library LU; "tournament": the library tournament. Tall panels of a
    batch run the tournament one slot at a time.
    """
    m, v = panel.shape[-2:]
    algo = _resolve_panel_algo(panel.dtype, m, v, _PANEL_ALGO if algo is None else algo)
    if algo == "partial":
        return _library_lu(panel)
    if algo == "tournament" or m > _PALLAS_MAX_ROWS:
        kernel = algo == "kernel"

        def one(p):
            return panel_lu_tournament(p, chunk=_PALLAS_MAX_ROWS if kernel else None,
                                       use_pallas=kernel)
        return one(panel) if panel.dim() == 2 else _per_slot(one, panel)
    if panel.dim() == 2:
        return panel_lu_pallas(panel)
    return panel_lu_pallas_batched(panel)


def chunk_layout(m: int, v: int, chunk: int | None = None) -> tuple[int, int]:
    """(chunk height c, chunk count nch) of :func:`tournament_winners` for
    an (m, v) panel."""
    c = chunk if chunk is not None else batched_call_rows(v)
    c = min(c, -(-m // v) * v)  # never taller than the (tile-rounded) panel
    c = max(v, c // v * v)  # multiple of v, at least one tile tall
    return c, -(-m // c)


def tournament_winners(panel: torch.Tensor, chunk: int | None = None,
                       use_pallas: bool = True, chunk_live=None,
                       tree: str = "pairwise"):
    """Elect v pivot rows of an (m, v) panel by tournament (CALU).

    Rows are split into chunks; each chunk's pivoted LU nominates its top v
    rows, and a reduction elects the winners among the nominees: `tree=
    "pairwise"`, a binary tree of stacked (2v, v) LUs, one batched
    factorization a level; `"flat"`, one (nch v, v) library LU of all the
    nominees. Returns (lu00, gpiv): the packed (v, v) LU of the winners in
    pivot order and their row ids in `panel`. Pad rows (zero rows, ids
    from m up; pad blocks of the tree carry the id `mp`) lose every contest
    against full-rank data.

    `use_pallas=True` (the port's default) factors the chunks and the tree
    levels on the K2 kernel, each round one batched factorization (float32
    only); `use_pallas=False` on the library LU, the chunk round one
    batched call over (nch, c, v) and each level one over (n/2, 2v, v).
    `chunk_live`, a length-nch bool vector (read on the host), skips the
    library LU of every dead chunk, which nominates its first v rows in
    identity order with a zero packed LU, as the JAX `lax.cond` does; as
    in the JAX package the kernel route factors every chunk.
    """
    m, v = panel.shape
    if m < v:
        raise ValueError(
            f"tournament_winners needs m >= v, got ({m}, {v})")
    if tree not in ("pairwise", "flat"):
        raise ValueError(f"unknown tree {tree!r} (pairwise|flat)")
    c, nch = chunk_layout(m, v, chunk)
    if use_pallas and not _pallas_panel_ok(panel.dtype, c, v):
        raise ValueError(f"chunk ({c}, {v}) {panel.dtype} does not fit the "
                         "panel kernel; use_pallas=False runs the library LU")
    mp = nch * c
    dev = panel.device
    with scope("tournament.chunks"):
        if mp != m:
            panel = torch.cat([panel, panel.new_zeros((mp - m, v))])
        ids = torch.arange(mp, device=dev)
        cand = panel.reshape(nch, c, v)
        cid = ids.reshape(nch, c)
        # the chunks are independent: one batched factorization for the round
        if use_pallas:
            lu_top, top = _panel_lu_winners(cand)  # (nch, v, v), (nch, v)
        else:
            if chunk_live is None:
                lu_c, perm_c = _library_lu(cand)
            else:
                live = [bool(x) for x in torch.as_tensor(chunk_live).reshape(-1).tolist()]
                if len(live) != nch:
                    raise ValueError(f"chunk_live has {len(live)} entries, the panel "
                                     f"{nch} chunks")
                lu_c = torch.zeros_like(cand)
                perm_c = torch.arange(c, device=dev).expand(nch, c).clone()
                idx = [i for i, ok in enumerate(live) if ok]
                if idx:
                    lu_l, perm_l = _library_lu(cand[idx])
                    lu_c[idx], perm_c[idx] = lu_l, perm_l
            lu_top, top = lu_c[:, :v], perm_c[:, :v]
        win = torch.gather(cand, 1, top[:, :, None].expand(nch, v, v))
        wid = torch.gather(cid, 1, top)
    return _elect_nominees(win, wid, lu_top, mp, use_pallas, tree)


def tournament_winners_live(panel_live: torch.Tensor, m: int, chunk: int | None = None,
                            use_pallas: bool = True, tree: str = "pairwise"):
    """:func:`tournament_winners` of an (m, v) panel whose leading rows are
    dead, given its live rows only: `panel_live` is rows [m - n, m) of the
    panel, and the rows before them are zero and their chunks dead (the
    distributed LU's LAPACK-order layout, where eliminated rows form a
    tile-aligned prefix of every rank's local rows).

    The chunks are cut where the whole panel's are (`chunk_layout(m, v,
    chunk)`): a chunk is live where its last row is, a live chunk's dead
    rows ride as zeros, and each dead chunk nominates its first v rows, all
    zero, in identity order with a zero packed LU, as the JAX package's
    `chunk_live` predicate makes it; the reduction then runs over every
    chunk's nominees, the bracket of the whole panel. Only the live chunks
    are factored: on the K2 kernel with `use_pallas` (float32, v a
    multiple of 128; a chunk may be as tall as the kernel takes, where the
    JAX kernel route stops at its VMEM's 4096 rows), else in one batched
    library LU. Returns (lu00, gpiv), gpiv the winners' row ids in the
    whole (m, v) panel (ids from m up name pad rows)."""
    n_live, v = panel_live.shape
    if m < v or n_live > m:
        raise ValueError(f"tournament_winners_live needs m >= v and at most m live rows, "
                         f"got m={m}, ({n_live}, {v})")
    if tree not in ("pairwise", "flat"):
        raise ValueError(f"unknown tree {tree!r} (pairwise|flat)")
    if use_pallas and not (panel_live.dtype == torch.float32 and v % hopper_kernels._PANEL_W == 0):
        raise ValueError(f"the K2 kernel takes float32 panels of width a multiple of "
                         f"{hopper_kernels._PANEL_W}, got {panel_live.dtype} width {v}; "
                         "use_pallas=False runs the library LU")
    c, nch = chunk_layout(m, v, chunk)
    mp = nch * c
    r0 = m - n_live
    fl = r0 // c if n_live else nch  # chunks before fl end before row r0: dead
    dev = panel_live.device
    nl = nch - fl
    with scope("tournament.chunks"):
        win = panel_live.new_zeros((nch, v, v))
        wid = (torch.arange(nch, device=dev)[:, None] * c
               + torch.arange(v, device=dev)[None, :])  # dead chunks: identity order
        lu_top = panel_live.new_zeros((nch, v, v))
        if nl:
            cand = panel_live.new_zeros((nl * c, v))
            cand[r0 - fl * c:r0 - fl * c + n_live] = panel_live
            cand = cand.reshape(nl, c, v)
            if use_pallas:
                lu_l, top = _panel_lu_winners(cand)
            else:
                lu_c, perm_c = _library_lu(cand)
                lu_l, top = lu_c[:, :v], perm_c[:, :v]
            lu_top[fl:] = lu_l
            win[fl:] = torch.gather(cand, 1, top[:, :, None].expand(nl, v, v))
            wid[fl:] = fl * c + torch.arange(nl, device=dev)[:, None] * c + top
    return _elect_nominees(win, wid, lu_top, mp, use_pallas, tree)


def _elect_nominees(win: torch.Tensor, wid: torch.Tensor, lu_top: torch.Tensor, mp: int,
                    use_pallas: bool, tree: str):
    """The reduction of a tournament: (nch, v, v) nominee rows `win` with
    their ids `wid` and their chunks' packed LUs `lu_top` -> (lu00, gpiv).
    `mp` is the pad id of the tree's pad blocks."""
    with scope("tournament.tree"):
        nch, v = win.shape[0], win.shape[-1]
        if nch == 1:  # single chunk: its local LU already decided everything
            return lu_top[0], wid[0]

        if tree == "flat":
            # one (nch v, v) LU elects straight from all the nominees
            lu_f, perm_f = _library_lu(win.reshape(nch * v, v))
            return lu_f[:v], wid.reshape(nch * v)[perm_f[:v]]

        n = 1 << (nch - 1).bit_length()
        if n != nch:
            # pad blocks: zero rows with out-of-range ids, losing every contest
            win = torch.cat([win, win.new_zeros((n - nch, v, v))])
            wid = torch.cat([wid, wid.new_full((n - nch, v), mp)])

        while n > 1:
            stacked = win.reshape(n // 2, 2 * v, v)
            sid = wid.reshape(n // 2, 2 * v)
            # one batched call a round
            if use_pallas:
                lu_top, top = _panel_lu_winners(stacked)
            else:
                lu_r, perm_r = _library_lu(stacked)
                lu_top, top = lu_r[:, :v], perm_r[:, :v]
            win = torch.gather(stacked, 1, top[:, :, None].expand(n // 2, v, v))
            wid = torch.gather(sid, 1, top)
            n //= 2
        # the final round's packed LU rows 0..v are the winners, factored
        return lu_top[0], wid[0]


def _winners_first(gpiv: torch.Tensor, m: int) -> torch.Tensor:
    """Permutation with the winners first (in pivot order) and the other
    rows after them in their original order. Ids outside [0, m) are
    dropped, as the JAX package's `mode="drop"` scatters drop them. gpiv
    (v,) gives (m,); a batch (B, v) gives (B, m), row by row."""
    g = gpiv if gpiv.dim() == 2 else gpiv[None]
    B, v = g.shape
    dev = g.device
    ids = torch.arange(m, device=dev)
    ok = (g >= 0) & (g < m)
    tgt = torch.where(ok, g, m)  # out-of-range ids land in a dropped slot
    is_piv = torch.zeros((B, m + 1), dtype=torch.bool, device=dev)
    is_piv.scatter_(1, tgt, True)
    pos = torch.zeros((B, m + 1), dtype=torch.long, device=dev)
    pos.scatter_(1, tgt, torch.arange(v, device=dev).expand(B, v))
    key = torch.where(is_piv[:, :m], pos[:, :m], v + ids)
    perm = torch.argsort(key, dim=1, stable=True)
    return perm if gpiv.dim() == 2 else perm[0]


def _panel_lu_rows(panels: torch.Tensor):
    """The batched core of :func:`panel_lu_pallas`: a (B, m, v) batch of
    independent panels factored in 128-wide column blocks, each block of
    every panel eliminated by one batched `hopper_kernels.lu_block` call
    with no row movement. Between blocks, a batched row-gathered TRSM and
    one batched masked GEMM update the columns to the right (library
    calls, as the JAX package leaves them to XLA). Returns (A, gpiv): the
    factored panels with rows in place, and the (B, v) pivot rows in
    pivot order."""
    w = hopper_kernels._PANEL_W
    B, m, v = panels.shape
    if v % w:
        raise ValueError(f"panel width {v} not a multiple of {w}")
    A = panels.clone(memory_format=torch.contiguous_format)
    alive = torch.ones((B, m, 1), dtype=torch.int32, device=panels.device)
    pivs = []
    for off in range(0, v, w):
        out, alive_new, piv = hopper_kernels.lu_block(A[:, :, off:off + w], alive)
        A[:, :, off:off + w] = out
        pivrows = piv[:, 0].long()  # (B, w) row ids in pivot order
        pivs.append(pivrows)
        if off + w < v:
            with scope("panel.between"):
                rest = A[:, :, off + w:]
                # a NaN column's pivots may leave [0, m): read and write such a
                # row clamped (the JAX package clamps the reads and drops the
                # writes; the values are NaN either way)
                pr = pivrows.clamp(0, m - 1)
                L00 = torch.gather(out, 1, pr[:, :, None].expand(B, w, w))
                idx = pr[:, :, None].expand(B, w, v - off - w)
                U01 = trsm_left_lower_unit(unit_lower(L00), torch.gather(rest, 1, idx))
                # multipliers of still-live rows only (pivot rows contribute 0)
                L10 = torch.where(alive_new != 0, out, 0.0)
                rest -= torch.matmul(L10, U01)
                rest.scatter_(1, idx, U01)
        alive = alive_new
    return A, torch.cat(pivs, 1)


def _panel_lu_winners(panels: torch.Tensor):
    """(lu00, top) of each panel of a (B, m, v) batch: the first v rows of
    :func:`panel_lu_pallas_batched`'s results, the packed (v, v) LU of its
    pivot rows in pivot order, (B, v, v), and their rows, (B, v)."""
    A, gpiv = _panel_lu_rows(panels)
    B, m, v = panels.shape
    with scope("panel.order"):
        top = _winners_first(gpiv, m)[:, :v]
        return torch.gather(A, 1, top[:, :, None].expand(B, v, v)), top


def panel_lu_pallas_batched(panels: torch.Tensor):
    """:func:`panel_lu_pallas` of each panel of a (B, m, v) batch, in one
    batched elimination per column block: (LU (B, m, v), perm (B, m)),
    slot i the factorization of panels[i]."""
    A, gpiv = _panel_lu_rows(panels)
    perm = _winners_first(gpiv, panels.shape[1])
    return torch.gather(A, 1, perm[:, :, None].expand(-1, -1, A.shape[-1])), perm


def panel_lu_pallas(panel: torch.Tensor):
    """Blocked panel LU with full-height partial pivoting on the elimination
    kernel (the port of the JAX `panel_lu_pallas`; same contract as
    :func:`panel_lu`).

    The (m, v) panel is factored in 128-wide column blocks, each eliminated
    by `hopper_kernels.lu_block` with no row movement: pivot rows keep their
    positions and an alive mask shrinks. Between blocks, a row-gathered
    TRSM and one masked GEMM update the columns to the right. Rows are
    gathered into LAPACK order once, at the end. m <= `_PALLAS_MAX_ROWS`.
    The one-panel case of :func:`panel_lu_pallas_batched`.
    """
    LU, perm = panel_lu_pallas_batched(panel[None])
    return LU[0], perm[0]


def lu_block_launches(m: int, v: int, device: torch.device | None = None) -> int:
    """K2 launches that one :func:`panel_lu` or :func:`panel_winners` of an
    (m, v) panel makes: v / 128 column blocks per batched factorization,
    one factorization for a panel within `_PALLAS_MAX_ROWS` rows, else one
    per tournament round (the chunks, then log2 n tree levels), each as
    many launches as its route on the card `device` takes
    (`hopper_kernels.lu_block_launch_count`; one without a device)."""
    blocks = v // hopper_kernels._PANEL_W

    def calls(slots: int, rows: int) -> int:
        if device is None:
            return blocks
        return blocks * hopper_kernels.lu_block_launch_count(rows, slots, device)

    if m <= _PALLAS_MAX_ROWS:
        return calls(1, m)
    c, nch = chunk_layout(m, v, _PALLAS_MAX_ROWS)
    total = calls(nch, c)
    n = 1 << (nch - 1).bit_length()
    while n > 1:
        total += calls(n // 2, 2 * v)
        n //= 2
    return total


def panel_winners(panel: torch.Tensor, algo: str = "kernel"):
    """Elect the v pivot rows of an (m, v) panel, or of each panel of a
    (B, m, v) batch, and factor them: the selection half of
    :func:`panel_lu`. Returns (lu00, gpiv), the packed (v, v) LU of the
    winners in pivot order and their rows in `panel` (with a leading B
    for a batch)."""
    m, v = panel.shape[-2:]
    algo = _resolve_panel_algo(panel.dtype, m, v, algo)
    if algo == "partial":
        LU, perm = _library_lu(panel)
        return LU[..., :v, :], perm[..., :v]
    if algo == "kernel" and m <= _PALLAS_MAX_ROWS:
        if panel.dim() == 2:
            lu00, gpiv = _panel_lu_winners(panel[None])
            return lu00[0], gpiv[0]
        return _panel_lu_winners(panel)
    kernel = algo == "kernel"

    def one(p):
        return tournament_winners(p, chunk=_PALLAS_MAX_ROWS if kernel else None,
                                  use_pallas=kernel)
    return one(panel) if panel.dim() == 2 else _per_slot(one, panel)


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
    """Extract the unit-lower L00 from a packed (v, v) LU diagonal block
    (or a batch of them, (..., v, v))."""
    v = lu00.shape[-1]
    return torch.tril(lu00, -1) + torch.eye(v, dtype=lu00.dtype,
                                            device=lu00.device)
