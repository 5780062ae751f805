"""Hand-written Hopper kernels for the factorization's hot tile ops.

The port's counterpart of `conflux_tpu/ops/pallas_kernels.py`. Each kernel
is CUDA C++ for sm_90a under `ops/csrc/`, built at first use by
`ops/_build.py` and called through ctypes on PyTorch's current stream:

- `gemm` (`csrc/gemm.cu`) replaces `pallas_kernels._gemm`: the trailing
  update, alpha * a @ b + beta * c with f32 accumulation, on a TMA-fed
  warp-specialised instance for 16-byte-aligned operands and a SIMT
  instance for the rest (`gemm_instance` says which);
- `lu_block` (`csrc/lu_block.cu`) replaces `pallas_kernels._lu_block`: the
  masked panel elimination of one (m, 128) column block, or of a batch of
  independent blocks in one cooperative launch;
- `btrsm` and `btrsm_pair` (`csrc/btrsm.cu`) replace
  `batched_trsm._pallas_btrsm`: the batched blocked triangular solve
  through diagonal-block inverses, one substitution or a whole solve round
  (forward on the permuted right-hand side, back, the probe stats) in one
  launch of a thread-block cluster per system;
- `batched_lu` (`csrc/batched_lu.cu`) replaces `pallas_factor._pallas_blu`:
  the batched partial-pivot LU of the LU serve plans' factor, with the
  fused probe row;
- `batched_chol` (`csrc/batched_chol.cu`) replaces
  `pallas_factor._pallas_bchol`: the batched lower Cholesky of the SPD
  serve plans' factor, with the fused probe row.

The two batched factors run a thread-block cluster per slot and hold the
trailing updates back `kb` columns, applied per element in column order
(`batched_factor_geometry` reports kb and the cluster size of a launch):
the same chain of roundings per element as their plain versions.

Beside each kernel sits its plain PyTorch version (`gemm_plain`,
`lu_block_plain`, `btrsm_plain`, `btrsm_pair_plain`, `batched_lu_plain`,
`batched_chol_plain`),
the same function written with tensor ops. The dispatch
rule: a CUDA tensor goes to the kernel (or the call raises), a CPU tensor
goes to the plain version; nothing falls back. `LAUNCHES` counts each
kernel's launches, and only launches, exactly under concurrent launchers
(the serving engine's dispatcher and drain threads both launch): every
bump holds `_LAUNCH_LOCK`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_PANEL_W = 128  # column-block width of lu_block (one TPU lane tile)

# launches per kernel since the last reset_launches(), counted where the
# kernel is launched and nowhere else; "gemm" counts both instances of K1,
# "gemm_tma" the TMA instance's share
LAUNCHES = {"gemm": 0, "gemm_tma": 0, "lu_block": 0, "btrsm": 0, "batched_lu": 0,
            "batched_chol": 0}
# a dict item's += is a read, an add and a write: two threads launching at
# once would lose a count without the lock
_LAUNCH_LOCK = threading.Lock()

_GEMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32_F64 = {torch.float32: 0, torch.float64: 1}


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    """Add one to kernel `name`'s launch count; called right after the
    launch returned, and nowhere else."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


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
    tma = gemm_instance(a, b, c, out) == "tma"
    launch = lib.conflux_gemm_tma if tma else lib.conflux_gemm
    rc = launch(
        _GEMM_DTYPES[a.dtype], a.device.index or 0, M, N, K,
        a.data_ptr(), _row_major_ld(a, "a"), b.data_ptr(), _row_major_ld(b, "b"),
        None if c is None else c.data_ptr(),
        0 if c is None else _row_major_ld(c, "c"),
        out.data_ptr(), _row_major_ld(out, "out"),
        float(alpha), float(beta), _stream(a))
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: cudaError {rc}")
    _count_launch("gemm")
    if tma:
        _count_launch("gemm_tma")
    return out


def gemm_instance(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
                  out: torch.Tensor) -> str:
    """Which instance of K1 :func:`gemm` runs on these operands: "tma"
    where every operand's base address and row pitch are multiples of 16
    bytes (what a TMA tensor map can describe), else "simt"."""
    ops = [(a, "a"), (b, "b"), (out, "out")] + ([] if c is None else [(c, "c")])
    aligned = all(x.data_ptr() % 16 == 0 and _row_major_ld(x, n) * x.element_size() % 16 == 0
                  for x, n in ops)
    return "tma" if aligned else "simt"


# --------------------------------------------------------------------------- #
# K2: masked panel elimination
# --------------------------------------------------------------------------- #


def lu_block_plain(a: torch.Tensor, alive: torch.Tensor):
    """The plain version of :func:`lu_block`, column by column with tensor
    ops and the kernel's arithmetic: an IEEE division for the multiplier,
    then one fused multiply-add per element, a - l * p rounded once. The
    FMA is computed in float64, where the product of two floats is exact,
    and rounded to float32 (equal to the fused result except on a
    double-rounding tie, ~2^-29 of the operations). A batch (B, m, w) of
    blocks runs the same steps on every slot at once."""
    batched = a.dim() == 3
    A = (a if batched else a[None]).to(torch.float32).clone()
    B, m, w = A.shape
    live = alive.reshape(B, m, -1)[:, :, 0] != 0
    rows = torch.arange(m, device=a.device)
    slots = torch.arange(B, device=a.device)
    neg1 = torch.tensor(-1.0, device=a.device)
    pivs = []
    for j in range(w):
        cand = torch.where(live, A[:, :, j].abs(), neg1)
        # m where no row ties the max (a NaN column), as the JAX kernel
        # records it; its pivot row is then read clamped, as its slice is
        p = torch.where(cand == cand.amax(1, keepdim=True), rows, m).amin(1)
        pivs.append(p)
        prow = A[slots, p.clamp(max=m - 1)]  # (B, w)
        upd = live & (rows != p[:, None])
        l = A[:, :, j] / prow[:, j:j + 1]
        fma = (A[:, :, j + 1:].double()
               - l.double()[:, :, None] * prow[:, None, j + 1:].double()).float()
        A[:, :, j + 1:] = torch.where(upd[:, :, None], fma, A[:, :, j + 1:])
        A[:, :, j] = torch.where(upd, l, A[:, :, j])
        live = upd
    piv = torch.stack(pivs, 1).to(torch.int32)[:, None, :]
    alive_out = live.to(torch.int32)[:, :, None]
    if not batched:
        return A[0], alive_out[0], piv[0]
    return A, alive_out, piv


_WAVE_SLOTS: dict = {}  # (device index, m) -> slots one cooperative launch holds


def lu_block_wave_slots(m: int, device: torch.device) -> int:
    """Blocks of m rows that one cooperative K2 launch eliminates together
    on the card `device` (its CTAs all resident at once): a batch of more
    slots runs in several launches, one a wave. Raises where one block's
    ceil(m / 256) CTAs do not fit the card (m > 33792 on an H100)."""
    key = (device.index or 0, m)
    if key not in _WAVE_SLOTS:
        from conflux_tpu_torch.ops import _build

        n = _build.load().conflux_lu_block_wave_slots(key[0], m)
        if n < 0:
            raise RuntimeError(f"lu_block occupancy query failed: cudaError {-n}")
        if n == 0:
            raise ValueError(f"lu_block: a block of {m} rows needs more CTAs than "
                             "the card holds at once")
        _WAVE_SLOTS[key] = n
    return _WAVE_SLOTS[key]


def lu_block(a: torch.Tensor, alive: torch.Tensor):
    """Eliminate one (m, 128) float32 column block (no row movement), or a
    batch (B, m, 128) of independent blocks in one call.

    `alive` marks rows still eligible as pivots: (m,), (m, 1) or (m, 128)
    (column 0 is read), with a leading B for a batch. Returns (out,
    alive_out, piv): `out` (m, 128) f32 holds U-row values at the pivot
    rows' original positions and L multipliers at the rows live before the
    call; `alive_out` (m, 1) int32; `piv` (1, 128) int32, the pivot row of
    each elimination step; each with a leading B for a batch. A batch is
    one cooperative launch per wave of slots that fit the card together
    (:func:`lu_block_wave_slots`), and each slot's bits are those of a
    call on that block alone.
    """
    batched = a.dim() == 3
    if a.dim() not in (2, 3) or a.shape[-1] != _PANEL_W or a.dtype != torch.float32:
        raise ValueError(f"lu_block takes an (m, {_PANEL_W}) or (B, m, {_PANEL_W}) "
                         f"float32 block, got {tuple(a.shape)} {a.dtype}")
    if tuple(alive.shape[:a.dim() - 1]) != tuple(a.shape[:-1]):
        raise ValueError(f"alive {tuple(alive.shape)} does not match the block "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return lu_block_plain(a, alive)
    if a.device.type != "cuda":
        raise ValueError(f"lu_block runs on cuda or cpu tensors, got {a.device}")
    from conflux_tpu_torch.ops import _build

    lib = _build.load()
    dev = a.device
    a3 = a if batched else a[None]
    B, m, w = a3.shape
    if m > 1 and a3.stride(2) != 1:
        raise ValueError(f"lu_block needs contiguous rows (stride {a.stride()})")
    lda, sa = max(a3.stride(1), w), a3.stride(0)
    alive_in = alive.reshape(B, m, -1)[:, :, 0].to(torch.int32).contiguous()
    out = torch.empty((B, m, w), dtype=torch.float32, device=dev)
    alive_out = torch.empty((B, m, 1), dtype=torch.int32, device=dev)
    piv = torch.empty((B, 1, w), dtype=torch.int32, device=dev)
    if B and m:
        g = lib.conflux_lu_block_ctas(m)
        per = lu_block_wave_slots(m, dev)
        # per slot, column and CTA: one (score, row) word, zero until
        # published, and the candidate row; per column a flag raised where
        # a NaN election publishes row m - 1; one memset for the whole batch
        words = torch.zeros((B, w * g + w), dtype=torch.int64, device=dev)
        cand = torch.empty((B, w * g * w), dtype=torch.float32, device=dev)
        for s0 in range(0, B, per):
            rc = lib.conflux_lu_block(
                dev.index or 0, min(per, B - s0), m, w,
                a3.data_ptr() + s0 * sa * a3.element_size(), lda, sa,
                alive_in[s0].data_ptr(), out[s0].data_ptr(), alive_out[s0].data_ptr(),
                piv[s0].data_ptr(), words[s0].data_ptr(), cand[s0].data_ptr(),
                _stream(a))
            if rc != 0:
                raise RuntimeError(f"lu_block kernel launch failed: cudaError {rc}")
            _count_launch("lu_block")
    if not batched:
        return out[0], alive_out[0], piv[0]
    return out, alive_out, piv


# --------------------------------------------------------------------------- #
# K3: batched blocked triangular solve, one substitution or a whole round
# --------------------------------------------------------------------------- #

_BTRSM_MAX_BS = 32  # widest diagonal block of a K3 launch (wider ones are split)
_BTRSM_MODES = {"lower": 0, "upper": 1, "pair": 2}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _check_btrsm(T: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor) -> None:
    if T.dim() != 3 or T.shape[-1] != T.shape[-2]:
        raise ValueError(f"btrsm takes T (B, n, n), got {tuple(T.shape)}")
    B, n = T.shape[0], T.shape[-1]
    if dinv.dim() != 4 or dinv.shape[0] != B or dinv.shape[-1] != dinv.shape[-2] \
            or dinv.shape[1] != -(-n // dinv.shape[-1]):
        raise ValueError(f"dinv {tuple(dinv.shape)} is not the (B, nb, bs, bs) "
                         f"diagonal-block stack of T {tuple(T.shape)}")
    if b.dim() != 3 or tuple(b.shape[:2]) != (B, n):
        raise ValueError(f"rhs {tuple(b.shape)} does not match T {tuple(T.shape)}")


def btrsm_plain(T: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor,
                lower: bool = True) -> torch.Tensor:
    """The plain version of :func:`btrsm`: the same block steps with
    tensor ops, in the accumulation dtype promote(T.dtype, f32). Leading
    axes of T (..., n, n), dinv (..., nb, bs, bs) and b (..., n, k) are
    batch axes. Per step j: x_j = Dinv_j r_j, then the rows not yet
    solved are downdated by T's j-block panel, so only the strictly-lower
    (lower) or strictly-upper (upper) panels are read and a packed LU
    needs no masking. Pad rows of a ragged n are zero and pad columns of T
    are never read, which is the result of an identity-extended T. This is
    also the port's block loop (`batched_trsm.blocked_solve`)."""
    n, k = b.shape[-2:]
    nb, bs = dinv.shape[-3], dinv.shape[-1]
    acc = _acc_dtype(T.dtype)
    Tc, Dc = T.to(acc), dinv.to(acc)
    rest = b.to(acc, copy=True)  # downdated in place below
    if nb * bs != n:
        rest = torch.cat([rest, rest.new_zeros(rest.shape[:-2] + (nb * bs - n, k))], -2)
    xs = [None] * nb
    for s in range(nb):
        j = s if lower else nb - 1 - s
        j0 = j * bs
        xj = torch.matmul(Dc[..., j, :, :], rest[..., j0:j0 + bs, :])
        xs[j] = xj
        lo, hi = (j0 + bs, n) if lower else (0, j0)
        if hi > lo:
            q = min(bs, n - j0)
            rest[..., lo:hi, :] -= torch.matmul(Tc[..., lo:hi, j0:j0 + q], xj[..., :q, :])
    return torch.cat(xs, -2)[..., :n, :].to(b.dtype)


def _operand(x: torch.Tensor | None, dtype: torch.dtype, device: torch.device, name: str):
    """x as the kernel reads it: on `device`, contiguous, of `dtype` (no
    copy where it already is)."""
    if x is None:
        return None
    if x.device != device:
        raise ValueError(f"btrsm: {name} is on {x.device}, T on {device}")
    if x.dtype != dtype:
        x = x.to(dtype)
    return x if x.is_contiguous() else x.contiguous()


def _narrow_blocks(d: torch.Tensor, n: int) -> torch.Tensor:
    """The (w, w) diagonal sub-blocks of a (B, nb, bs, bs) stack of
    diagonal-block inverses, w the widest of 32 or less that divides bs,
    as a (B, ceil(n / w), w, w) stack. The inverse of a block triangle has
    the inverses of its diagonal blocks on its diagonal, so a launch with
    blocks w wide (panels inside the wide blocks read from T) solves the
    same triangle."""
    B, nb, bs = d.shape[0], d.shape[1], d.shape[-1]
    w = next(w for w in range(_BTRSM_MAX_BS, 0, -1) if bs % w == 0)
    m = bs // w
    sub = d.reshape(B, nb, m, w, m, w).diagonal(dim1=2, dim2=4)  # (B, nb, w, w, m)
    return sub.permute(0, 1, 4, 2, 3).reshape(B, nb * m, w, w)[:, :-(-n // w)]


def _btrsm_launch(mode: str, T, d1, d2, b, perm=None, trans=False, wA=None):
    """One K3 launch on the card. Returns x (B, n, k) in the accumulation
    dtype and, with wA, the stats (2, B): xsum and wAx of the final solve.
    A bfloat16 T is read as it is stored (the instance converts each
    element where it reads it, exactly), everything else in the
    accumulation dtype."""
    acc = _acc_dtype(T.dtype)
    if acc not in _F32_F64:
        raise ValueError(f"btrsm accumulates in float32 or float64, got {acc}")
    t_bf16 = T.dtype == torch.bfloat16
    B, n, k = b.shape
    if d1.shape[-1] > _BTRSM_MAX_BS:
        d1 = _narrow_blocks(d1, n)
        d2 = None if d2 is None else _narrow_blocks(d2, n)
    nb, bs = d1.shape[1], d1.shape[-1]
    dev = T.device
    Tc = _operand(T, torch.bfloat16 if t_bf16 else acc, dev, "T")
    D1 = _operand(d1, acc, dev, "dinv")
    D2 = _operand(d2, acc, dev, "Du")
    bc = _operand(b, acc, dev, "b")
    wc = _operand(wA, acc, dev, "wA")
    pc = _operand(perm, torch.int64, dev, "perm")
    x = torch.empty((B, n, k), dtype=acc, device=dev)
    stats = None if wA is None else torch.empty((2, B), dtype=acc, device=dev)
    if B == 0 or n == 0 or k == 0:
        return x, None if stats is None else stats.zero_()
    from conflux_tpu_torch.ops import _build

    sp = None if stats is None else stats.data_ptr()
    rc = _build.load().conflux_btrsm(
        2 if t_bf16 else _F32_F64[acc], dev.index or 0, B, n, nb, bs, k,
        _BTRSM_MODES[mode], int(trans),
        Tc.data_ptr(), D1.data_ptr(), None if D2 is None else D2.data_ptr(), bc.data_ptr(),
        None if pc is None else pc.data_ptr(), None if wc is None else wc.data_ptr(),
        x.data_ptr(), sp, None if sp is None else sp + B * stats.element_size(), _stream(T))
    if rc != 0:
        raise RuntimeError(f"btrsm kernel launch failed: cudaError {rc} (n={n} {acc}, k={k})")
    _count_launch("btrsm")
    return x, stats


def btrsm(T: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor,
          lower: bool = True) -> torch.Tensor:
    """Solve T x = b for a batch of triangles through their diagonal-block
    inverses: T (B, n, n) (a packed LU is fine: the other triangle is never
    read; float32, float64, or bfloat16 read as stored), dinv (B, nb, bs,
    bs) from `batched_trsm.diag_block_inverses`, b (B, n, k). Accumulates
    in promote(T.dtype, f32); returns x (B, n, k) in b.dtype. One K3
    launch."""
    _check_btrsm(T, dinv, b)
    if T.device.type == "cpu":
        return btrsm_plain(T, dinv, b, lower)
    if T.device.type != "cuda":
        raise ValueError(f"btrsm runs on cuda or cpu tensors, got {T.device}")
    return _btrsm_launch("lower" if lower else "upper", T, dinv, None, b)[0].to(b.dtype)


def _check_pair(T, Dl, Du, b, perm, trans_back, wA) -> None:
    _check_btrsm(T, Dl, b)
    if trans_back:
        if Du is not None:
            raise ValueError("btrsm_pair with trans_back reads Dl transposed: pass Du=None")
    elif Du is None or Du.shape != Dl.shape:
        raise ValueError(f"Du {None if Du is None else tuple(Du.shape)} must match Dl "
                         f"{tuple(Dl.shape)}")
    want = tuple(b.shape[:2])
    if perm is not None and (tuple(perm.shape) != want or perm.is_floating_point()):
        raise ValueError(f"perm must be integer {want}, got {tuple(perm.shape)} {perm.dtype}")
    if wA is not None and tuple(wA.shape) != want:
        raise ValueError(f"wA must be {want}, got {tuple(wA.shape)}")


def btrsm_pair_plain(T: torch.Tensor, Dl: torch.Tensor, Du: torch.Tensor | None,
                     b: torch.Tensor, perm: torch.Tensor | None = None,
                     trans_back: bool = False, wA: torch.Tensor | None = None):
    """The plain version of :func:`btrsm_pair`: :func:`btrsm_plain` forward
    through (T, Dl) on b[perm], then back through (T, Du), or through
    (T^T, Dl^T) with `trans_back`. With wA, the probe stats of the back
    solve are added per block in its order (the last block first), in the
    accumulation dtype, as the JAX `_blocked_core(..., wA=...)` adds them
    in its block loop. Leading axes are batch axes."""
    r = b if perm is None else torch.gather(b, -2, perm[..., None].expand(b.shape))
    y = btrsm_plain(T, Dl, r, lower=True)
    if trans_back:
        x = btrsm_plain(T.mT, Dl.mT, y, lower=False)
    else:
        x = btrsm_plain(T, Du, y, lower=False)
    if wA is None:
        return x
    acc = _acc_dtype(T.dtype)
    xc, wc = x.to(acc), wA.to(acc)
    nb, bs = Dl.shape[-3], Dl.shape[-1]
    xsum = xc.new_zeros(xc.shape[:-2])
    wAx = xc.new_zeros(xc.shape[:-2])
    for j in range(nb - 1, -1, -1):
        blk = xc[..., j * bs:(j + 1) * bs, :]
        xsum = xsum + blk.sum(dim=(-2, -1))
        wAx = wAx + (wc[..., j * bs:(j + 1) * bs] * blk[..., 0]).sum(-1)
    return x, xsum, wAx


def btrsm_pair(T: torch.Tensor, Dl: torch.Tensor, Du: torch.Tensor | None,
               b: torch.Tensor, *, perm: torch.Tensor | None = None,
               trans_back: bool = False, wA: torch.Tensor | None = None):
    """A whole solve round in one K3 launch: T_fwd y = b[perm], then
    T_bwd x = y. T (B, n, n) is a packed LU (forward through its unit
    lower triangle's inverses Dl, back through its upper triangle's Du)
    or, with `trans_back`, the Cholesky factor L (back through L^T and
    Dl^T, read transposed in place: pass Du=None). perm (B, n), when
    given, picks b's rows as they are read. With the probe row wA (B, n),
    returns (x, xsum, wAx): xsum = sum(x) per system (NaN or Inf anywhere
    in x poisons it) and wAx = wA . x[:, 0], accumulated per block of the
    back solve in its order; x's bits do not depend on whether wA is
    given. Else returns x (B, n, k) in b.dtype."""
    _check_pair(T, Dl, Du, b, perm, trans_back, wA)
    if T.device.type == "cpu":
        return btrsm_pair_plain(T, Dl, Du, b, perm, trans_back, wA)
    if T.device.type != "cuda":
        raise ValueError(f"btrsm_pair runs on cuda or cpu tensors, got {T.device}")
    x, stats = _btrsm_launch("pair", T, Dl, Du, b, perm, trans_back, wA)
    x = x.to(b.dtype)
    return x if wA is None else (x, stats[0], stats[1])


# --------------------------------------------------------------------------- #
# K4: batched partial-pivot LU
# --------------------------------------------------------------------------- #


def batched_factor_geometry(name: str, A: torch.Tensor) -> tuple[int, int, bool]:
    """(kb, cluster size, global panel) of the `name` kernel ("batched_lu"
    or "batched_chol") launched on the CUDA batch A: the block width of its
    held-back updates, the CTAs per slot, and whether its panel rows stay
    in global memory (K4 where a CTA's share does not fit shared memory).
    None of them changes a bit."""
    if name not in ("batched_lu", "batched_chol"):
        raise ValueError(f"no batched factor kernel named {name!r}")
    if A.device.type != "cuda":
        raise ValueError(f"{name} geometry is that of a launch on the card, got {A.device}")
    from conflux_tpu_torch.ops import _build

    geometry = getattr(_build.load(), f"conflux_{name}_geometry")
    kb, cs, gp = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = geometry(_F32_F64[A.dtype], A.device.index or 0, A.shape[0], A.shape[-1],
                  ctypes.byref(kb), ctypes.byref(cs), ctypes.byref(gp))
    if rc != 0:
        raise RuntimeError(f"{name} geometry failed: cudaError {rc}")
    return kb.value, cs.value, bool(gp.value)


def _check_batched_factor(name: str, A: torch.Tensor, w: torch.Tensor | None) -> None:
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{name} takes (B, N, N), got {tuple(A.shape)}")
    if A.dtype not in _F32_F64:
        raise ValueError(f"{name} takes float32 or float64, got {A.dtype}")
    if w is not None and tuple(w.shape) != (A.shape[-1],):
        raise ValueError(f"probe w {tuple(w.shape)}, need ({A.shape[-1]},)")


def _lapack_order(out: torch.Tensor, piv: torch.Tensor):
    """Rows into LAPACK order, outside the kernel: position k takes the
    step-k pivot row (square elimination freezes every row once)."""
    perm = piv.long()
    LU = torch.gather(out, 1, perm[:, :, None].expand(-1, -1, out.shape[-1]))
    return LU, perm


def batched_lu_plain(A: torch.Tensor, w: torch.Tensor | None = None):
    """The plain version of :func:`batched_lu`, column by column with
    tensor ops and the kernel's arithmetic: the pivot is the live row with
    the largest |a| (ties to the smallest row, NaN below every number), the
    multiplier an IEEE division, the update one fused multiply-add per
    element. For float32 the FMA is computed in float64, where the product
    of two floats is exact, and rounded once (equal to the fused result
    except on a double-rounding tie); float64 has no wider type, so there
    the update rounds twice."""
    B, n, _ = A.shape
    X = A.clone()
    dev = A.device
    rows = torch.arange(n, device=dev)
    slots = torch.arange(B, device=dev)
    live = torch.ones((B, n), dtype=torch.bool, device=dev)
    wide = torch.float64 if A.dtype == torch.float32 else None
    pivs = []
    for j in range(n):
        col = X[:, :, j]
        score = col.abs()
        score = torch.where(torch.isnan(score), -1.0, score)
        score = torch.where(live, score, -2.0)
        best = score.max(dim=1, keepdim=True).values
        p = torch.where(score == best, rows, n).min(dim=1).values
        pivs.append(p)
        prow = X[slots, p]  # (B, n)
        live[slots, p] = False
        lmul = col / prow[:, j:j + 1]
        tail = X[:, :, j + 1:]
        if wide is not None:
            upd = (tail.to(wide) - lmul.to(wide)[:, :, None]
                   * prow[:, None, j + 1:].to(wide)).to(A.dtype)
        else:
            upd = tail - lmul[:, :, None] * prow[:, None, j + 1:]
        X[:, :, j + 1:] = torch.where(live[:, :, None], upd, tail)
        X[:, :, j] = torch.where(live, lmul, col)
    LU, perm = _lapack_order(X, torch.stack(pivs, 1))
    wa = None if w is None else torch.matmul(w.to(A.dtype), A)
    return LU, perm, wa


def batched_lu(A: torch.Tensor, w: torch.Tensor | None = None):
    """Partial-pivot LU of each slot of a (B, N, N) float32 or float64
    batch. Returns (LU, perm, wA): packed factors in LAPACK order with
    A[i][perm[i]] == L_i @ U_i, perm (B, N) int64, and, when the probe
    vector w (N,) is given, wA (B, N) = w^T A_i off the untouched input
    (else None). Each slot's bits depend only on that slot's input. On
    the card, n must leave the live list of n rows within a CTA's shared
    memory (n up to 42096 in float32, 37760 in float64); a larger n
    raises."""
    _check_batched_factor("batched_lu", A, w)
    if w is not None:
        w = w.to(A.dtype)
    if A.device.type == "cpu":
        return batched_lu_plain(A, w)
    if A.device.type != "cuda":
        raise ValueError(f"batched_lu runs on cuda or cpu tensors, got {A.device}")
    B, n, _ = A.shape
    dev = A.device
    a = A.contiguous()
    out = torch.empty_like(a)
    piv = torch.empty((B, n), dtype=torch.int32, device=dev)
    wa = None if w is None else torch.empty((B, n), dtype=A.dtype, device=dev)
    if B == 0 or n == 0:
        return out, piv.long(), wa
    w = None if w is None else w.to(dev).contiguous()
    from conflux_tpu_torch.ops import _build

    lib = _build.load()
    rc = lib.conflux_batched_lu(
        _F32_F64[A.dtype], dev.index or 0, B, n, a.data_ptr(), out.data_ptr(),
        piv.data_ptr(), None if w is None else w.data_ptr(),
        None if wa is None else wa.data_ptr(), _stream(A))
    if rc != 0:
        raise RuntimeError(f"batched_lu kernel launch failed: cudaError {rc}")
    _count_launch("batched_lu")
    LU, perm = _lapack_order(out, piv)
    return LU, perm, wa


# --------------------------------------------------------------------------- #
# K5: batched Cholesky
# --------------------------------------------------------------------------- #


def batched_chol_plain(A: torch.Tensor, w: torch.Tensor | None = None):
    """The plain version of :func:`batched_chol`, column by column with
    tensor ops and the kernel's arithmetic: per column j, the trailing
    square of both triangles takes A[i,k] - (A[i,j] * A[j,k]) / a_jj (a
    product, a division and a subtraction, each rounded), then column j
    from the diagonal down is divided by sqrt(a_jj). The same roundings as
    the kernel's _rn intrinsics, so the two agree bit for bit."""
    n = A.shape[-1]
    X = A.clone()
    for j in range(n):
        ajj = X[:, j, j].clone()
        ljj = torch.sqrt(ajj)
        col = X[:, j + 1:, j].clone()
        X[:, j + 1:, j + 1:] -= (col[:, :, None] * X[:, None, j, j + 1:]) / ajj[:, None, None]
        X[:, j + 1:, j] = col / ljj[:, None]
        X[:, j, j] = ajj / ljj
    L = torch.tril(X)
    wa = None if w is None else torch.matmul(w.to(A.dtype), A)
    return L, wa


def batched_chol(A: torch.Tensor, w: torch.Tensor | None = None):
    """Lower Cholesky factor of each slot of a (B, N, N) float32 or float64
    batch. Returns (L, wA): L (B, N, N) with the strict upper triangles
    zero, and, when the probe vector w (N,) is given, wA (B, N) = w^T A_i
    off the untouched input (else None). Both triangles of A are read, as
    the TPU kernel reads them. A slot that is not positive definite comes
    out with NaN; each slot's bits depend only on that slot's input."""
    _check_batched_factor("batched_chol", A, w)
    if w is not None:
        w = w.to(A.dtype)
    if A.device.type == "cpu":
        return batched_chol_plain(A, w)
    if A.device.type != "cuda":
        raise ValueError(f"batched_chol runs on cuda or cpu tensors, got {A.device}")
    B, n, _ = A.shape
    dev = A.device
    a = A.contiguous()
    out = torch.empty_like(a)
    wa = None if w is None else torch.empty((B, n), dtype=A.dtype, device=dev)
    if B == 0 or n == 0:
        return out, wa
    w = None if w is None else w.to(dev).contiguous()
    from conflux_tpu_torch.ops import _build

    lib = _build.load()
    rc = lib.conflux_batched_chol(
        _F32_F64[A.dtype], dev.index or 0, B, n, a.data_ptr(), out.data_ptr(),
        None if w is None else w.data_ptr(), None if wa is None else wa.data_ptr(),
        _stream(A))
    if rc != 0:
        raise RuntimeError(f"batched_chol kernel launch failed: cudaError {rc}")
    _count_launch("batched_chol")
    return out, wa
