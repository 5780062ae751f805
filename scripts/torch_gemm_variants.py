"""K1's TMA instance against one-line variants of its source, on the card.

    python scripts/torch_gemm_variants.py [--reps 3] [--out FILE.json]

Each variant is `csrc/gemm.cu` with one exact text replaced (a text that
is not there once is an error), built alone with the port's nvcc flags
into `conflux_tpu_torch/ops/_kernels/variants/gemm_<name>/` and loaded
with ctypes; `base` is the unchanged source built the same way. Every
build's ptxas report for the TMA instance (registers, spills) is printed.
Each variant must agree with the plain version (relative Frobenius 1e-5)
at the LU main path's first trailing update, 31744x1024 @ 1024x31744 in
place, and at a ragged (1000, 1000, 777); then base and the variant are
timed alternately (base, variant, variant, base), each turn the median of
--reps launches timed with CUDA events, and the script prints the median
of each side's two turns. The variants:

- regs_56_224: setmaxnreg gives the producer warpgroup 56 registers and
  the consumers 224 (instead of 40 and 232);
- no_setmaxnreg: every thread keeps the launch's 168 registers;
- unroll2: the k groups of a stage unrolled by 2 (instead of not);
- group16: 16 tile rows a raster group instead of 8;
- stages3: a ring of 3 stages instead of 4.

Also times the base build's SIMT instance and `torch.addmm` at the main
shape, and samples the SM clock (`nvidia-smi`) over the base turns. Prints
the card's name and power limit first. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from conflux_tpu_torch.ops import _build  # noqa: E402
from conflux_tpu_torch.ops.hopper_kernels import gemm_plain  # noqa: E402

VARIANTS = {
    "regs_56_224": ("constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;",
                    "constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;"),
    "no_setmaxnreg": ("constexpr bool SETMAXNREG = true;", "constexpr bool SETMAXNREG = false;"),
    "unroll2": ("#pragma unroll 1  // k groups of a stage", "#pragma unroll 2"),
    "group16": ("constexpr int GROUP_M = 8;", "constexpr int GROUP_M = 16;"),
    "stages3": ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
}
M = 32768 - 1024
K = 1024


def _start_build(name: str, edit: tuple[str, str] | None):
    with open(os.path.join(_build._CSRC, "gemm.cu")) as f:
        text = f.read()
    if edit is not None:
        if text.count(edit[0]) != 1:
            raise RuntimeError(f"{name}: {edit[0]!r} is not once in gemm.cu")
        text = text.replace(*edit)
    out = os.path.join(_build._OUT_ROOT, "variants", f"gemm_{name}")
    os.makedirs(out, exist_ok=True)
    cu, lib = os.path.join(out, "gemm.cu"), os.path.join(out, "lib.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-shared",
                             cu, "-o", lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, lib, proc


def _finish_build(name: str, lib: str, proc):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    lines = log.splitlines()
    report = []
    for k, ln in enumerate(lines):  # the TMA instance's f32 entry and its report
        if "Compiling entry" in ln and "gemm_tma_kernelIf" in ln:
            report = [x.strip() for x in lines[k + 1:k + 4]
                      if re.search(r"spill|Used \d+ registers", x)]
    L = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (L.conflux_gemm_tma, L.conflux_gemm):
        fn.argtypes = [i, i, i, i, i, p, i, p, i, p, i, p, i, f, f, p]
        fn.restype = i
    return L, report


def _call(fn, a, b, c, out):
    m, k = a.shape
    n = b.shape[1]
    rc = fn(0, 0, m, n, k, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), c.data_ptr(),
            c.stride(0), out.data_ptr(), out.stride(0), -1.0, 1.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def _median_ms(fn, a, b, c, reps: int) -> float:
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        _call(fn, a, b, c, c)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _rel(x, ref) -> float:
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    started = [_start_build(name, edit) for name, edit in [("base", None), *VARIANTS.items()]]
    builds = {}
    for name, lib, proc in started:
        builds[name] = _finish_build(name, lib, proc)
        print(f"[{name}] ptxas (TMA instance, f32):", *builds[name][1], sep="\n  ", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.rand((M, K), generator=gen, device="cuda") * 2 - 1
    b = torch.rand((K, M), generator=gen, device="cuda") * 2 - 1
    c = torch.rand((M, M), generator=gen, device="cuda") * 2 - 1
    want = gemm_plain(a, b, c, alpha=-1.0)
    ra = torch.rand((1000, 1000), generator=gen, device="cuda")
    rb = torch.rand((1000, 780), generator=gen, device="cuda")[:, :777]
    rc = torch.rand((1000, 780), generator=gen, device="cuda")[:, :777]
    rgot = torch.empty((1000, 780), device="cuda")[:, :777]  # a 16-byte pitch, as rc's
    rwant = gemm_plain(ra, rb, rc, alpha=-1.0)
    base = builds["base"][0]
    work = c.clone()  # the timed launches update this copy in place
    rows = []
    for name in ["base", *VARIANTS]:
        L = builds[name][0]
        got = c.clone()
        rgot.copy_(rc)
        _call(L.conflux_gemm_tma, a, b, got, got)
        _call(L.conflux_gemm_tma, ra, rb, rgot, rgot)
        torch.cuda.synchronize()
        err, rerr = _rel(got, want), _rel(rgot, rwant)
        del got
        if max(err, rerr) > 1e-5:
            print(f"{name}: WRONG, rel_fro {err:.3e} / ragged {rerr:.3e} above 1e-5; not timed",
                  flush=True)
            rows.append({"variant": name, "rel_fro": err, "ragged_rel_fro": rerr, "wrong": True})
            if name == "base":
                return 1
            continue
        if name == "base":
            clk = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                                    "--format=csv,noheader", "-lms", "200"],
                                   stdout=subprocess.PIPE, text=True)
            ms = [_median_ms(base.conflux_gemm_tma, a, b, work, args.reps) for _ in range(2)]
            clk.terminate()
            clocks = [ln.strip() for ln in clk.communicate()[0].splitlines() if ln.strip()]
            simt = _median_ms(base.conflux_gemm, a, b, work, args.reps)
            torch.addmm(c, a, b, alpha=-1.0)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.reps):
                torch.addmm(c, a, b, alpha=-1.0)
            e1.record()
            torch.cuda.synchronize()
            addmm = e0.elapsed_time(e1) / args.reps
            # the part of a launch that does not grow with K (the epilogue,
            # the ring's fill and drain): the base at K and at K / 2
            half = _median_ms(base.conflux_gemm_tma, a[:, :K // 2], b[:K // 2], work, args.reps)
            fixed = 2 * half - statistics.median(ms)
            row = {"variant": "base", "tma_ms": statistics.median(ms), "simt_ms": simt,
                   "addmm_ms": addmm, "rel_fro": err, "clocks": clocks[-3:],
                   "half_k_ms": half, "fixed_ms": fixed}
            print(f"base: TMA {row['tma_ms']:.3f} ms ({2 * M * M * K / row['tma_ms'] / 1e9:.1f} "
                  f"TFLOP/s), SIMT {simt:.3f} ms, torch.addmm {addmm:.3f} ms; SM clock, max, "
                  f"power: {clocks[-1] if clocks else 'not read'}; at K={K // 2} {half:.3f} ms, "
                  f"so {fixed:.3f} ms of a launch does not grow with K", flush=True)
        else:
            turns = {"base": [], name: []}
            for side in ("base", name, name, "base"):
                fn = (base if side == "base" else L).conflux_gemm_tma
                turns[side].append(_median_ms(fn, a, b, work, args.reps))
            row = {"variant": name, "base_ms": statistics.median(turns["base"]),
                   "variant_ms": statistics.median(turns[name]), "rel_fro": err}
            print(f"{name}: base {row['base_ms']:.3f} ms, variant {row['variant_ms']:.3f} ms "
                  f"({row['variant_ms'] / row['base_ms']:.3f}x)", flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows,
                       "ptxas": {k: v[1] for k, v in builds.items()}}, f, indent=1)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
