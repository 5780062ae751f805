"""Drive the PyTorch/CUDA port (`conflux_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device: the card's name, count and power limit (fails without a card);
  2. build: the hand-written kernels from `conflux_tpu_torch/ops/csrc`;
  3. K1 (`hopper_kernels.gemm`) against its plain version at the main
     path's first trailing update, a ragged shape, a strided view and bf16;
  4. K2 (`hopper_kernels.lu_block`) against its plain version at the main
     path's (4096, 128) and (2048, 128) blocks, all-live and partly dead;
  5. the main path through the miniapp's `main(argv)`: N=32768 f32 v=1024
     with --validate, then N=8192 with --validate --refine 4, with each
     kernel's launches counted over each run;
  6. CUDA-event times of each kernel, its plain version and one library
     call at the main path's shapes, beside each kernel's bound.

The line before the last is the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

K1_TOL_F32 = 1e-5     # relative Frobenius: only the summation order differs
K1_TOL_BF16 = 2 ** -8  # relative Frobenius: one bf16 rounding of the f32 sum
K2_TOL = 1e-5         # allclose atol and rtol: kernel and plain share arithmetic


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def rel_fro(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(f"[device] {device['kind']} x{device['count']}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)  # name, power limit
    return device


def phase_build() -> None:
    from conflux_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    took = _build.build_seconds
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'%.1f s' % took if took is not None else 'reused a build'})",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_k1(rec: dict) -> None:
    from conflux_tpu_torch.ops.hopper_kernels import gemm, gemm_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    # the main path's first trailing update: L10 (31744, 1024) @ A01 (1024,
    # 31744) subtracted from the trailing block in place
    M, K = 32768 - 1024, 1024
    a = torch.rand((M, K), generator=gen, device=dev) * 2 - 1
    b = torch.rand((K, M), generator=gen, device=dev) * 2 - 1
    c = torch.rand((M, M), generator=gen, device=dev) * 2 - 1
    want = gemm_plain(a, b, c, alpha=-1.0)
    got = c.clone()
    gemm(a, b, c=got, alpha=-1.0, out=got)
    torch.cuda.synchronize()
    err = rel_fro(got, want)
    rec["max_abs_err"] = float((got - want).abs().max())
    print(f"[K1] {M}x{K} @ {K}x{M} f32 in place: rel_fro {err:.2e} "
          f"max_abs {rec['max_abs_err']:.2e} (bound {K1_TOL_F32:g})", flush=True)
    check(err <= K1_TOL_F32, f"K1 f32 main-path shape rel_fro {err:.3e}")
    del want, got

    # ragged, strided (ld not a multiple of 4: the scalar load path) and bf16
    big = torch.rand((300, 401), generator=gen, device=dev) * 2 - 1
    cases = [
        ("ragged (100, 60, 130)", big[:100, :60].contiguous(),
         big[100:160, :130].contiguous(), None, K1_TOL_F32),
        ("strided views ld=401", big[3:103, 5:65], big[110:170, 7:138],
         big[180:280, 200:331], K1_TOL_F32),
    ]
    ab = (torch.rand((4096, 1024), generator=gen, device=dev) * 2 - 1).bfloat16()
    bb = (torch.rand((1024, 4096), generator=gen, device=dev) * 2 - 1).bfloat16()
    cb = (torch.rand((4096, 4096), generator=gen, device=dev) * 2 - 1).bfloat16()
    cases.append(("bf16 (4096, 1024, 4096)", ab, bb, cb, K1_TOL_BF16))
    for name, x, y, z, tol in cases:
        want = gemm_plain(x, y, z, alpha=-1.0)
        got = gemm(x, y, c=z, alpha=-1.0)
        torch.cuda.synchronize()
        err = rel_fro(got, want)
        print(f"[K1] {name}: rel_fro {err:.2e} (bound {tol:.2g})", flush=True)
        check(got.dtype == x.dtype and err <= tol, f"K1 {name} rel_fro {err:.3e}")

    # times at the main path's first-step shape
    work = c.clone()
    rec["ms"] = time_ms(lambda: gemm(a, b, c=work, alpha=-1.0, out=work), 3)
    rec["plain_ms"] = time_ms(lambda: gemm_plain(a, b, c, alpha=-1.0), 3)
    rec["library_ms"] = time_ms(lambda: torch.addmm(c, a, b, alpha=-1.0), 3)
    flops = 2.0 * M * M * K
    nbytes = 4.0 * (M * K + K * M + 2 * M * M)
    _bound(rec, flops, nbytes)
    print(f"[K1] times at {M}x{K}x{M}: kernel {rec['ms']:.3f} ms "
          f"({flops / rec['ms'] / 1e9:.1f} TFLOP/s), plain {rec['plain_ms']:.3f} ms, "
          f"torch.addmm {rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
          f"({rec['bound_by']})", flush=True)


def _bound(rec: dict, flops: float, nbytes: float) -> None:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    rec["bound_ms"] = max(t_ops, t_bytes)
    rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"


def _lu_block_flops(alive: torch.Tensor, w: int) -> float:
    """Flops this block's elimination does: per column, one division and
    2 * (w - j - 1) for each live non-pivot row."""
    live = int(alive.sum())
    total = 0.0
    for j in range(w):
        rows = max(live - 1, 0)
        total += rows * (1 + 2 * (w - j - 1))
        live = max(live - 1, 0)
    return total


def phase_k2(rec: dict) -> None:
    from conflux_tpu_torch.ops.hopper_kernels import _PANEL_W, lu_block, lu_block_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    w = _PANEL_W
    worst = 0.0
    for m in (4096, 2048):
        # a (m, 1024) panel chunk whose second column block is the input,
        # a strided view as panel_lu_pallas passes it
        chunk = torch.rand((m, 1024), generator=gen, device="cuda") * 2 - 1
        chunk[torch.arange(0, m, 8, device="cuda"), 128:256] += 2.0
        blk = chunk[:, w:2 * w]
        for dead in (0.0, 0.25):
            alive = (torch.rand((m, 1), generator=gen, device="cuda") >= dead).to(torch.int32)
            out, al, piv = lu_block(blk, alive)
            out_p, al_p, piv_p = lu_block_plain(blk, alive)
            torch.cuda.synchronize()
            same_piv = torch.equal(piv, piv_p)
            same_alive = torch.equal(al, al_p)
            err = float((out - out_p).abs().max())
            close = torch.allclose(out, out_p, rtol=K2_TOL, atol=K2_TOL)
            worst = max(worst, err)
            print(f"[K2] ({m}, {w}) dead={dead:.2f}: piv equal {same_piv}, alive "
                  f"equal {same_alive}, max_abs {err:.2e} (allclose {K2_TOL:g}: "
                  f"{close})", flush=True)
            check(same_piv and same_alive and close, f"K2 ({m}, {w}) dead={dead}")
        if m == 4096:
            ones = torch.ones((m, 1), dtype=torch.int32, device="cuda")
            rec["ms"] = time_ms(lambda: lu_block(blk, ones), 20)
            rec["plain_ms"] = time_ms(lambda: lu_block_plain(blk, ones), 3)
            # cuSOLVER's getrf (MAGMA's batched path prints warnings here)
            lib_was = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")
            rec["library_ms"] = time_ms(lambda: torch.linalg.lu_factor(blk), 10)
            torch.backends.cuda.preferred_linalg_library(lib_was)
            nbytes = 4.0 * (2 * m * w + 2 * m + w)
            _bound(rec, _lu_block_flops(ones, w), nbytes)
        else:
            ones = torch.ones((m, 1), dtype=torch.int32, device="cuda")
            ms2048 = time_ms(lambda: lu_block(blk, ones), 20)
            print(f"[K2] time at (2048, {w}): kernel {ms2048:.3f} ms", flush=True)
    rec["max_abs_err"] = worst
    print(f"[K2] times at (4096, {w}): kernel {rec['ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, torch.linalg.lu_factor {rec['library_ms']:.3f} ms, "
          f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})", flush=True)


def run_miniapp(argv: list[str]) -> tuple[list[str], dict]:
    """One miniapp run with every launch count set to 0 just before it;
    returns its output lines and the counts read just after."""
    from conflux_tpu_torch.cli import conflux_miniapp
    from conflux_tpu_torch.ops import hopper_kernels

    buf = io.StringIO()
    hopper_kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = conflux_miniapp.main(argv)
    counts = dict(hopper_kernels.LAUNCHES)
    check(rc == 0, f"miniapp {argv} returned {rc}")
    lines = buf.getvalue().splitlines()
    print(f"[main] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for line in lines:
        if line.startswith(("_result_", "_residual_", "_solve_residual_")):
            print(f"[main]   {line}", flush=True)
    print(f"[main]   launches: {counts} (warm-up + 1 timed factorization)", flush=True)
    check(all(n > 0 for n in counts.values()), f"a kernel never launched: {counts}")
    return lines, counts


def _field(lines: list[str], prefix: str) -> str:
    hits = [l for l in lines if l.startswith(prefix)]
    check(len(hits) >= 1, f"no {prefix} line")
    return hits[-1]


def phase_main() -> dict:
    from conflux_tpu_torch.validation import residual_bound

    lines, counts = run_miniapp(["-N", "32768", "-b", "1024", "-r", "1", "--validate"])
    ms = float(_field(lines, "_result_").split(",")[8])
    res = float(_field(lines, "_residual_").split()[1])
    bar = residual_bound(32768, torch.float32)
    check(math.isfinite(res) and res <= bar, f"N=32768 residual {res:.3e} > {bar:.3e}")
    print(f"[main]   N=32768: {ms:.1f} ms per factorization = "
          f"{2 / 3 * 32768 ** 3 / ms / 1e9:.1f} TFLOP/s; residual {res:.3e} <= {bar:.3e}",
          flush=True)

    lines2, counts2 = run_miniapp(["-N", "8192", "-b", "1024", "-r", "1", "--validate",
                                   "--refine", "4"])
    res2 = float(_field(lines2, "_residual_").split()[1])
    bar2 = residual_bound(8192, torch.float32)
    check(math.isfinite(res2) and res2 <= bar2, f"N=8192 residual {res2:.3e}")
    check("PASS" in _field(lines2, "_solve_residual_"), "N=8192 solve residual not PASS")
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    device = phase_device()
    # importing the port only after the card check: without a card, or in a
    # directory without the package, the script fails before any result
    import conflux_tpu_torch  # noqa: F401

    phase_build()
    k1 = {"name": "gemm", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/gemm.cu",
          "replaces": "conflux_tpu/ops/pallas_kernels.py:38"}
    k2 = {"name": "lu_block", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/lu_block.cu",
          "replaces": "conflux_tpu/ops/pallas_kernels.py:153"}
    from conflux_tpu_torch.ops import blas  # noqa: F401 (sets the TF32 flags)

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    phase_k1(k1)
    torch.cuda.empty_cache()
    phase_k2(k2)
    torch.cuda.empty_cache()
    counts = phase_main()
    k1["launches"], k2["launches"] = counts["gemm"], counts["lu_block"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
