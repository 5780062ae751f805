"""Hand-written Hopper kernels for the factorization's hot tile ops.

The port's counterpart of `conflux_tpu/ops/pallas_kernels.py`. Each kernel
is CUDA C++ for sm_90a under `ops/csrc/`, built at first use by
`ops/_build.py` and called through ctypes on PyTorch's current stream:

- `gemm` (`csrc/gemm.cu`) replaces `pallas_kernels._gemm`: the trailing
  update, alpha * a @ b + beta * c with f32 accumulation;
- `lu_block` (`csrc/lu_block.cu`) replaces `pallas_kernels._lu_block`: the
  masked panel elimination of one (m, 128) column block.

Beside each kernel sits its plain PyTorch version (`gemm_plain`,
`lu_block_plain`), the same function written with tensor ops. The dispatch
rule: a CUDA tensor goes to the kernel (or the call raises), a CPU tensor
goes to the plain version; nothing falls back. `LAUNCHES` counts each
kernel's launches, and only launches.
"""

from __future__ import annotations

import torch

_PANEL_W = 128  # column-block width of lu_block (one TPU lane tile)

# launches per kernel since the last reset_launches(), counted where the
# kernel is launched and nowhere else
LAUNCHES = {"gemm": 0, "lu_block": 0}

_GEMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _row_major_ld(x: torch.Tensor, name: str) -> int:
    """Leading dimension of a 2D operand whose rows are contiguous."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2D, got shape {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} needs contiguous rows (stride {x.stride()})")
    return max(x.stride(0), x.shape[1], 1)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# --------------------------------------------------------------------------- #
# K1: GEMM
# --------------------------------------------------------------------------- #


def gemm_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
               alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """alpha * a @ b (+ beta * c) with f32 accumulation, returned in
    a.dtype: the plain version of :func:`gemm`."""
    out = torch.matmul(a.float(), b.float())
    if alpha != 1.0:
        out = alpha * out
    if c is not None:
        out = out + (beta * c.float() if beta != 1.0 else c.float())
    return out.to(a.dtype)


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
         alpha: float = 1.0, beta: float = 1.0,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """out = alpha * a @ b (+ beta * c), f32 accumulation, in a.dtype.

    float32 or bfloat16 operands of one dtype, each 2D with contiguous rows
    (views with a leading dimension are fine). `out` may be `c` itself: the
    kernel reads each element of c before writing the same element of out,
    which is how the factorization updates its trailing block in place.
    """
    if a.dtype not in _GEMM_DTYPES or b.dtype != a.dtype:
        raise ValueError(
            f"gemm kernel takes float32 or bfloat16 operands of one dtype, "
            f"got {a.dtype} and {b.dtype}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, x in (("c", c), ("out", out)):
        if x is not None and (tuple(x.shape) != (M, N) or x.dtype != a.dtype):
            raise ValueError(f"{name} must be ({M}, {N}) {a.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if a.device.type == "cpu":
        res = gemm_plain(a, b, c, alpha, beta)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on cuda or cpu tensors, got {a.device}")
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    from conflux_tpu_torch.ops import _build

    lib = _build.load()
    rc = lib.conflux_gemm(
        _GEMM_DTYPES[a.dtype], a.device.index or 0, M, N, K,
        a.data_ptr(), _row_major_ld(a, "a"), b.data_ptr(), _row_major_ld(b, "b"),
        None if c is None else c.data_ptr(),
        0 if c is None else _row_major_ld(c, "c"),
        out.data_ptr(), _row_major_ld(out, "out"),
        float(alpha), float(beta), _stream(a))
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: cudaError {rc}")
    LAUNCHES["gemm"] += 1
    return out


# --------------------------------------------------------------------------- #
# K2: masked panel elimination
# --------------------------------------------------------------------------- #


def lu_block_plain(a: torch.Tensor, alive: torch.Tensor):
    """The plain version of :func:`lu_block`, column by column with tensor
    ops and the kernel's arithmetic: an IEEE division for the multiplier,
    then one fused multiply-add per element, a - l * p rounded once. The
    FMA is computed in float64, where the product of two floats is exact,
    and rounded to float32 (equal to the fused result except on a
    double-rounding tie, ~2^-29 of the operations)."""
    m, w = a.shape
    A = a.to(torch.float32).clone()
    live = alive.reshape(m, -1)[:, 0] != 0
    rows = torch.arange(m, device=a.device)
    neg1 = torch.tensor(-1.0, device=a.device)
    pivs = []
    for j in range(w):
        cand = torch.where(live, A[:, j].abs(), neg1)
        p = torch.where(cand == cand.max(), rows, m).min()
        pivs.append(p)
        prow = A.index_select(0, p.view(1))[0]
        upd = live & (rows != p)
        l = A[:, j] / prow[j]
        fma = (A[:, j + 1:].double()
               - l.double()[:, None] * prow[None, j + 1:].double()).float()
        A[:, j + 1:] = torch.where(upd[:, None], fma, A[:, j + 1:])
        A[:, j] = torch.where(upd, l, A[:, j])
        live = upd
    piv = torch.stack(pivs).to(torch.int32)[None, :]
    return A, live.to(torch.int32)[:, None], piv


def lu_block(a: torch.Tensor, alive: torch.Tensor):
    """Eliminate one (m, 128) float32 column block (no row movement).

    `alive` marks rows still eligible as pivots: (m,), (m, 1) or (m, 128)
    (column 0 is read). Returns (out, alive_out, piv): `out` (m, 128) f32
    holds U-row values at the pivot rows' original positions and L
    multipliers at the rows live before the call; `alive_out` (m, 1)
    int32; `piv` (1, 128) int32, the pivot row of each elimination step.
    """
    m, w = a.shape
    if w != _PANEL_W or a.dtype != torch.float32:
        raise ValueError(f"lu_block takes an (m, {_PANEL_W}) float32 block, "
                         f"got {tuple(a.shape)} {a.dtype}")
    if alive.shape[0] != m:
        raise ValueError(f"alive has {alive.shape[0]} rows, block has {m}")
    if a.device.type == "cpu":
        return lu_block_plain(a, alive)
    if a.device.type != "cuda":
        raise ValueError(f"lu_block runs on cuda or cpu tensors, got {a.device}")
    from conflux_tpu_torch.ops import _build

    lib = _build.load()
    dev = a.device
    alive_in = alive.reshape(m, -1)[:, 0].to(torch.int32).contiguous()
    out = torch.empty((m, w), dtype=torch.float32, device=dev)
    alive_out = torch.empty((m,), dtype=torch.int32, device=dev)
    piv = torch.empty((1, w), dtype=torch.int32, device=dev)
    if m == 0:
        return out, alive_out[:, None], piv
    g = lib.conflux_lu_block_ctas(m)
    # per column and CTA: one (score, row) word, zero until published, and
    # the candidate row
    words = torch.zeros((w * g,), dtype=torch.int64, device=dev)
    cand = torch.empty((w * g * w,), dtype=torch.float32, device=dev)
    rc = lib.conflux_lu_block(
        dev.index or 0, m, w, a.data_ptr(), _row_major_ld(a, "a"),
        alive_in.data_ptr(), out.data_ptr(), alive_out.data_ptr(),
        piv.data_ptr(), words.data_ptr(), cand.data_ptr(), _stream(a))
    if rc != 0:
        raise RuntimeError(f"lu_block kernel launch failed: cudaError {rc}")
    LAUNCHES["lu_block"] += 1
    return out, alive_out[:, None], piv
