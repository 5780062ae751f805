"""K5 and K4 against one-line variants of their sources, on the card.

    python scripts/torch_factor_variants.py [--reps 10] [--out FILE.json]

Each variant is a kernel source with one exact text replaced (a text that
is not there is an error), built alone with the port's nvcc flags into
`conflux_tpu_torch/ops/_kernels/variants/<name>/` and loaded with ctypes.
`base` is the unchanged source built the same way, so every build's ptxas
report (registers, spills) is printed beside its times. Each variant must
give base's bits on the same inputs (K4: the factors and the pivots); then
base and the variant are timed alternately (base, variant, variant, base),
each turn the median of --reps launches timed with CUDA events, and the
script prints the median of each side's two turns. The variants:

- chol_rn_division: K5 with `__fdiv_rn` for every division (no reciprocal
  with FMA corrections);
- chol_one_cta_per_sm, lu_one_cta_per_sm: K5 / K4 under
  `__launch_bounds__(NT, 1)` (float32 free to use up to 255 registers, one
  CTA an SM) instead of `(NT, 2)` (128 registers, two CTAs an SM);
- lu_global_panel: K4 with its panel rows in global memory at every n
  (the instance otherwise taken only where they do not fit shared memory).

Shapes: the serving cells' (32, 256, 256) and (32, 1024, 1024) float32.
Also times base K4 on (2, 5000, 5000) float64, whose panel rows do not fit
shared memory (the global-panel instance). Prints the card's name and
power limit first. Needs an NVIDIA card.
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

_BOUNDS = ("__launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)", "__launch_bounds__(NT, 1)")
VARIANTS = {
    "chol_rn_division": ("batched_chol.cu",
                         ("constexpr bool kFast = sizeof(T) == sizeof(float);",
                          "constexpr bool kFast = false;")),
    "chol_one_cta_per_sm": ("batched_chol.cu", _BOUNDS),
    "lu_one_cta_per_sm": ("batched_lu.cu", _BOUNDS),
    "lu_global_panel": ("batched_lu.cu", ("  const int cs = pick<T, false>(device, batch, n);",
                                          "  const int cs = 0;")),
}
SHAPES = [(32, 256), (32, 1024)]


def _start_build(name: str, source: str, edit: tuple[str, str] | None):
    """Writes the variant's source and starts its nvcc."""
    with open(os.path.join(_build._CSRC, source)) as f:
        text = f.read()
    if edit is not None:
        if text.count(edit[0]) != 1:
            raise RuntimeError(f"{name}: {edit[0]!r} is not once in {source}")
        text = text.replace(*edit)
    out = os.path.join(_build._OUT_ROOT, "variants", name)
    os.makedirs(out, exist_ok=True)
    cu, lib = os.path.join(out, source), os.path.join(out, "lib.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-shared",
                             cu, "-o", lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, source, lib, proc


def _finish_build(name: str, source: str, lib: str, proc):
    """Waits for the build; returns the launch and geometry functions and
    the ptxas report."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    report = [ln.strip() for ln in log.splitlines()
              if re.search(r"Compiling entry|spill|Used \d+ registers", ln)]
    L = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    if source == "batched_chol.cu":
        fn, geo = L.conflux_batched_chol, L.conflux_batched_chol_geometry
        fn.argtypes = [i, i, i, i, p, p, p, p, p]
    else:
        fn, geo = L.conflux_batched_lu, L.conflux_batched_lu_geometry
        fn.argtypes = [i, i, i, i, p, p, p, p, p, p]
    fn.restype = i
    geo.argtypes, geo.restype = [i, i, i, i, p, p, p], i
    return fn, geo, report


def _call(fn, source: str, A: torch.Tensor):
    B, n, _ = A.shape
    out = torch.empty_like(A)
    dt = 0 if A.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream
    if source == "batched_chol.cu":
        rc = fn(dt, 0, B, n, A.data_ptr(), out.data_ptr(), None, None, stream)
        res = (out,)
    else:
        piv = torch.empty((B, n), dtype=torch.int32, device=A.device)
        rc = fn(dt, 0, B, n, A.data_ptr(), out.data_ptr(), piv.data_ptr(), None, None, stream)
        res = (out, piv)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return res


def _geometry(geo, A: torch.Tensor) -> str:
    kb, cs, gp = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    dt = 0 if A.dtype == torch.float32 else 1
    rc = geo(dt, 0, A.shape[0], A.shape[-1], ctypes.byref(kb), ctypes.byref(cs), ctypes.byref(gp))
    if rc != 0:
        raise RuntimeError(f"geometry failed: cudaError {rc}")
    return f"kb {kb.value}, cluster {cs.value}" + (", panel in global memory" if gp.value else "")


def _median_ms(fn, source: str, A: torch.Tensor, reps: int) -> float:
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        _call(fn, source, A)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _inputs(source: str, B: int, n: int, dtype=torch.float32) -> torch.Tensor:
    import numpy as np

    rng = np.random.default_rng(B * 7919 + n)
    M = torch.from_numpy(rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).cuda()
    if source == "batched_chol.cu":  # the serving cells' SPD class, M M^T + I
        M = M @ M.mT + torch.eye(n, dtype=torch.float64, device="cuda")
    return M.to(dtype).contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    started = [_start_build(name, source, edit) for name, (source, edit) in
               [("chol_base", ("batched_chol.cu", None)), ("lu_base", ("batched_lu.cu", None)),
                *VARIANTS.items()]]  # all nvcc processes at once
    builds = {}
    for name, source, lib, proc in started:
        builds[name] = (source, *_finish_build(name, source, lib, proc))
        print(f"[{name}] ptxas:", *builds[name][3], sep="\n  ", flush=True)
    rows = []
    for name in VARIANTS:
        source, fn, geo, _ = builds[name]
        _, bfn, bgeo, _ = builds["chol_base" if source == "batched_chol.cu" else "lu_base"]
        for B, n in SHAPES:
            A = _inputs(source, B, n)
            want, got = _call(bfn, source, A), _call(fn, source, A)
            same = all(torch.equal(x, y) for x, y in zip(want, got))
            turns = {"base": [], name: []}
            for side in ("base", name, name, "base"):
                turns[side].append(_median_ms(bfn if side == "base" else fn, source, A, args.reps))
            row = {"variant": name, "shape": [B, n, n], "same_bits": same,
                   "base_ms": statistics.median(turns["base"]),
                   "variant_ms": statistics.median(turns[name]),
                   "base_geometry": _geometry(bgeo, A), "variant_geometry": _geometry(geo, A)}
            rows.append(row)
            print(f"{name} ({B}, {n}, {n}): base {row['base_ms']:.3f} ms "
                  f"({row['base_geometry']}), variant {row['variant_ms']:.3f} ms "
                  f"({row['variant_geometry']}), same bits {same}", flush=True)
            if not same:
                print(f"{name}: the variant changed bits", file=sys.stderr)
                return 1
    _, lfn, lgeo, _ = builds["lu_base"]
    A = _inputs("batched_lu.cu", 2, 5000, torch.float64)
    _call(lfn, "batched_lu.cu", A)
    gp_ms = _median_ms(lfn, "batched_lu.cu", A, 3)
    torch.linalg.lu_factor(A)  # the library's warm-up
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.linalg.lu_factor(A)
    e1.record()
    torch.cuda.synchronize()
    lib_ms = e0.elapsed_time(e1)
    print(f"lu_base (2, 5000, 5000) float64 ({_geometry(lgeo, A)}): {gp_ms:.3f} ms; "
          f"torch.linalg.lu_factor {lib_ms:.3f} ms", flush=True)
    rows.append({"variant": "lu_base", "shape": [2, 5000, 5000], "dtype": "float64",
                 "base_ms": gp_ms, "library_ms": lib_ms, "base_geometry": _geometry(lgeo, A)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi.stdout.strip(), "rows": rows,
                       "ptxas": {k: v[3] for k, v in builds.items()}}, f, indent=1)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
