"""The library LU on the card by linear-algebra backend, and the nvcc
time of each kernel source.

    python scripts/torch_library_lu_times.py [--build] [--root DIR]

Times `torch.linalg.lu_factor_ex` of the panel batches the library
routes factor (a tournament's chunk and tree rounds at v=1024, a single
tall panel, serving (e)'s (32, m, 256) panels) in float64 and float32,
under torch's default backend, with cuSOLVER preferred and with MAGMA
preferred, and the port's own route (`blas._library_lu`: the backend it
picks for the batch, and the pivots turned into a permutation on the
host): CUDA events, the median of three runs of 3 calls after a
warm-up. `--build` also times nvcc on each `.cu` of the checkout's
`ops/csrc` with the port's flags, one source at a time, and of `--root
DIR`'s (another checkout, e.g. the parent unpacked with `git archive`).
Prints the card's name and power limit first and one JSON line last.
Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from conflux_tpu_torch.ops import _build, blas  # noqa: E402

SHAPES = [(8, 4096, 1024), (4, 2048, 1024), (2, 2048, 1024), (1, 4096, 1024),
          (16, 2048, 1024), (32, 1024, 256), (32, 256, 256)]


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            fn()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / 3)
    return statistics.median(runs)


def _lu_times() -> list[dict]:
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        for shape in SHAPES:
            P = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            row = {"dtype": str(dtype).removeprefix("torch."), "shape": list(shape)}
            for lib in ("default", "cusolver", "magma"):
                torch.backends.cuda.preferred_linalg_library(lib)
                row[lib] = _ms(lambda: torch.linalg.lu_factor_ex(P))
            torch.backends.cuda.preferred_linalg_library("default")
            row["port"] = _ms(lambda: blas._library_lu(P))
            rows.append(row)
            print(f"{row['dtype']} {tuple(shape)}: default {row['default']:.2f} ms, cuSOLVER "
                  f"{row['cusolver']:.2f} ms, MAGMA {row['magma']:.2f} ms; the port's "
                  f"_library_lu (with the pivots' conversion) {row['port']:.2f} ms", flush=True)
            del P
    return rows


def _build_times(csrc: str) -> dict:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for f in sorted(os.listdir(csrc)):
            if not f.endswith(".cu"):
                continue
            t0 = time.perf_counter()
            r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-c",
                                os.path.join(csrc, f), "-o", os.path.join(tmp, f + ".o")],
                               capture_output=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {f}")
            out[f] = time.perf_counter() - t0
            print(f"nvcc {csrc}/{f}: {out[f]:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    res = {"card": card, "lu": _lu_times()}
    if args.build:
        res["nvcc_s"] = {"this": _build_times(_build._CSRC)}
        if args.root:
            res["nvcc_s"]["root"] = _build_times(
                os.path.join(args.root, "conflux_tpu_torch", "ops", "csrc"))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
