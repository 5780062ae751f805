"""K3 (`csrc/btrsm.cu`) against variants of its source, on the card.

    python scripts/torch_btrsm_variants.py [--reps 3] [--out FILE.json] [--trace]

Each variant is the kernel source with exact texts replaced (a text that is
not there once is an error), built alone with the port's nvcc flags into
`conflux_tpu_torch/ops/_kernels/variants/<name>/` (all builds at once) and
called through ctypes. `base` is the unchanged source built the same way;
every build's ptxas report (registers, spills) is printed. Each variant
must give base's bits on the same inputs; then base and the variant are
timed alternately (base, variant, variant, base), each turn the median of
--reps runs of 20 back-to-back launches timed with CUDA events, and the
script prints the median of each side's two turns. The variants:

- ring16: 16 tiles in the ring instead of 8;
- ahead1: one unit of tiles in flight past the one read, instead of 7;
- unit8: 8 panel tiles a unit instead of 4 (and a ring of 16);
- two_ctas_an_sm: registers for two CTAs an SM instead of three (float32);
- cap4: clusters of 4 CTAs at most instead of 8;
- skip_loads, skip_downdates: timing probes whose bits are wrong (no tile
  loads; no downdates), what is left of a launch without that work.

--trace builds the base source with a clock read at two points of each
step's owner in system 0 (after its wait for the previous block's x, and
after it has stored its own), and prints the medians of the gaps: the
exchange's latency and the owner's critical work.

Shapes: a serving round (`btrsm_pair`, LU with the row permutation) at
(32, 256, 256) and (32, 1024, 1024) float32, one right-hand side. Prints the card's name and power limit first.
Needs an NVIDIA card.
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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from conflux_tpu_torch.ops import _build  # noqa: E402
from conflux_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses  # noqa: E402

VARIANTS = {
    "ring16": [("const int ring = 2 * MAX_UNIT;", "const int ring = 4 * MAX_UNIT;")],
    "ahead1": [("constexpr int MAX_AHEAD = 7;", "constexpr int MAX_AHEAD = 1;")],
    "unit8": [("constexpr int MAX_UNIT = 4;", "constexpr int MAX_UNIT = 8;")],
    "two_ctas_an_sm": [("__launch_bounds__(NT, sizeof(T) == 4 ? 3 : 2)",
                        "__launch_bounds__(NT, 2)")],
    "cap4": [("constexpr int MAX_CS = 8;", "constexpr int MAX_CS = 4;")],
    # timing probes only, their bits are wrong: no tile loads at all, and
    # no downdates (x_j = Dinv_j b_j)
    "skip_loads": [("  const int bs = g.bs, n = a.n;\n  if (isD) {",
                    "  const int bs = g.bs, n = a.n;\n  return;\n  if (isD) {")],
    "skip_downdates": [("  const int qmax = min(bs, a.n - st.jp * bs);\n",
                        "  const int qmax = min(bs, a.n - st.jp * bs);\n  return;\n")],
}
PROBES = ("skip_loads", "skip_downdates")
# --trace: the base source with the owner's clock (%globaltimer, ns) read
# after its wait for x_jp and after it has stored x_j, step by step, in
# system 0; the gaps between give the exchange's latency and the owner's
# critical work
TRACE = [
    ("namespace cg = cooperative_groups;\n\nnamespace {\n",
     "namespace cg = cooperative_groups;\n\nnamespace {\n"
     "__device__ unsigned long long g_trace[2][256];\n"
     "__device__ long long g_clk[4][256];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("          mbar_wait<GM>(xr + st.jp, parity);\n          downdate",
     "          mbar_wait<GM>(xr + st.jp, parity);\n"
     "          if (sys == 0 && tid == 0 && s < 256) g_trace[0][s] = gtime();\n          downdate"),
    ("  for (int e = tid; e < nsol * a.nb; e += NT) mbar_init(xready + e, 1);\n",
     "  if (sys == 0 && tid == 0 && rank == 0) g_trace[0][255] = gtime();\n"
     "  for (int e = tid; e < nsol * a.nb; e += NT) mbar_init(xready + e, 1);\n"),
    ("    parity ^= 1;\n    cluster.sync();\n",
     "    parity ^= 1;\n    cluster.sync();\n"
     "    if (sys == 0 && tid == 0 && rank == 0) g_trace[1][255] = gtime();\n"),
    ("  cluster.sync();  // every CTA of the cluster runs, its mbarriers set\n",
     "  cluster.sync();  // every CTA of the cluster runs, its mbarriers set\n"
     "  if (sys == 0 && tid == 0 && rank == 0) g_trace[0][254] = gtime();\n"),
    ("    for (int s = 0; s < S; ++s) {\n",
     "    if (sys == 0 && tid == 0 && rank == 0) g_trace[0][253] = gtime();\n"
     "    for (int s = 0; s < S; ++s) {\n"),
    ("        const int g0 = begin_unit(nt, false);\n",
     "        const int g0 = begin_unit(nt, false);\n"
     "        if (sys == 0 && tid == 0 && s == 0) g_trace[0][252] = gtime();\n"),
    ("        refill(g0);\n",
     "        if (sys == 0 && tid == 0 && s < 256) g_trace[1][s] = gtime();\n"
     "        if (sys == 0 && tid == 0 && s < 256) g_clk[3][s] = clock64();\n        refill(g0);\n"),
    ("          downdate<T, TS, KC, BS, GM>(a, g, st, 0, 1, ring, g0, xprev, acc);\n"
     "          __syncthreads();\n",
     "          if (sys == 0 && tid == 0 && s < 256) g_clk[0][s] = clock64();\n"
     "          downdate<T, TS, KC, BS, GM>(a, g, st, 0, 1, ring, g0, xprev, acc);\n"
     "          if (sys == 0 && tid == 0 && s < 256) g_clk[1][s] = clock64();\n"
     "          __syncthreads();\n"
     "          if (sys == 0 && tid == 0 && s < 256) g_clk[2][s] = clock64();\n"),
    ("}  // namespace\n\n// dtype 0",
     "}  // namespace\n\nextern \"C\" int conflux_btrsm_trace(void* out) {\n"
     "  return cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));\n}\n\n"
     "extern \"C\" int conflux_btrsm_clocks(void* out) {\n"
     "  return cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n\n// dtype 0"),
]
SHAPES = [(32, 256), (32, 1024)]


def _start_build(name: str, edits: list[tuple[str, str]]):
    with open(os.path.join(_build._CSRC, "btrsm.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in btrsm.cu")
        text = text.replace(old, new)
    out = os.path.join(_build._OUT_ROOT, "variants", name)
    os.makedirs(out, exist_ok=True)
    cu, lib = os.path.join(out, "btrsm.cu"), os.path.join(out, "lib.so")
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
    report = [ln.strip() for ln in log.splitlines()
              if re.search(r"Compiling entry|spill|Used \d+ registers", ln)]
    L = ctypes.CDLL(lib)
    L.conflux_btrsm.argtypes = _build.load().conflux_btrsm.argtypes
    L.conflux_btrsm.restype = ctypes.c_int
    return L.conflux_btrsm, report


def _round(fn, ops) -> torch.Tensor:
    LU, Dl, Du, b, perm = ops
    B, n, k = b.shape
    x = torch.empty_like(b)
    rc = fn(0, 0, B, n, Dl.shape[1], Dl.shape[-1], k, 2, 0, LU.data_ptr(), Dl.data_ptr(),
            Du.data_ptr(), b.data_ptr(), perm.data_ptr(), None, x.data_ptr(), None, None,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return x


def _median_us(fn, ops, reps: int) -> float:
    _round(fn, ops)
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            _round(fn, ops)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 20 * 1e3)
    return statistics.median(times)


def _inputs(B: int, n: int):
    rng = np.random.default_rng(B * 7919 + n)
    A = torch.from_numpy(rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n))
    LU, perm, _ = hk.batched_lu(A.to("cuda", torch.float32))
    Dl = diag_block_inverses(LU, lower=True, unit_diagonal=True)
    Du = diag_block_inverses(LU, lower=False)
    b = torch.from_numpy(rng.standard_normal((B, n, 1)).astype(np.float32)).cuda()
    return LU, Dl, Du, b, perm.contiguous()


def _trace(args) -> int:
    name, lib, proc = _start_build("trace", TRACE)
    fn, _ = _finish_build(name, lib, proc)
    get = ctypes.CDLL(lib).conflux_btrsm_trace
    get.argtypes, get.restype = [ctypes.c_void_p], ctypes.c_int
    clk = ctypes.CDLL(lib).conflux_btrsm_clocks
    clk.argtypes, clk.restype = [ctypes.c_void_p], ctypes.c_int
    rows = []
    for B, n in SHAPES:
        for Bs in (B, 1):
            ops = tuple(x[:Bs] for x in _inputs(B, n))
            _round(fn, ops)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 512)()
            if get(buf) != 0:
                raise RuntimeError("trace copy failed")
            t = np.array(buf, dtype=np.int64).reshape(2, 256)
            cbuf = (ctypes.c_longlong * 1024)()
            if clk(cbuf) != 0:
                raise RuntimeError("clock copy failed")
            ck = np.array(cbuf, dtype=np.int64).reshape(4, 256)
            nb = n // 32
            steps = [s for s in range(1, 2 * nb) if s != nb]  # each solve's first has no wait
            link = [int(t[0][s] - t[1][s - 1]) for s in steps]
            crit = [int(t[1][s] - t[0][s]) for s in steps]
            row = {"shape": [Bs, n, n], "steps": len(steps),
                   "round_ns": int(t[1][2 * nb - 1] - t[1][0]),
                   # system 0's rank 0: from its start to the first x, and
                   # from the last x to the end of its pass
                   "start_to_first_ns": int(t[1][0] - t[0][255]),
                   "last_to_end_ns": int(t[1][255] - t[1][2 * nb - 1]),
                   # the start's parts: the mbarriers' set-up and the cluster
                   # barrier, the first tiles' issue and the right-hand
                   # sides, the first tile's wait, x_0
                   "start_parts_ns": [int(t[0][254] - t[0][255]), int(t[0][253] - t[0][254]),
                                      int(t[0][252] - t[0][253]), int(t[1][0] - t[0][252])],
                   "link_ns_median": int(np.median(link)),
                   "crit_ns_median": int(np.median(crit)),
                   # SM clocks of the owner's critical work: the downdate of
                   # block j, the barrier after it, x_j and its stores
                   "crit_cycles_median": [int(np.median([ck[p + 1][s] - ck[p][s]
                                                         for s in steps]))
                                          for p in range(3)]}
            rows.append(row)
            print(f"trace ({Bs}, {n}, {n}): {row['round_ns'] / 1e3:.1f} us from the "
                  f"first x to the last ({row['start_to_first_ns'] / 1e3:.1f} us from the start "
                  f"to it: {row['start_parts_ns']} ns, {row['last_to_end_ns'] / 1e3:.1f} us from the "
                  f"last to the end); a step: x_jp's arrival after the owner of jp stored "
                  f"it {row['link_ns_median']} ns, the owner's downdate and x_j "
                  f"{row['crit_ns_median']} ns (medians of {len(steps)} steps); its cycles: "
                  f"downdate, barrier, x_j {row['crit_cycles_median']}", flush=True)
    print(json.dumps({"trace": rows}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="only the step trace of the base source (no variants)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    if args.trace:
        return _trace(args)
    started = [_start_build(name, edits) for name, edits in [("base", []), *VARIANTS.items()]]
    builds = {}
    for name, lib, proc in started:
        builds[name] = _finish_build(name, lib, proc)
        print(f"[{name}] ptxas:", *[r for r in builds[name][1] if "btrsm" in r or "Used" in r],
              sep="\n  ", flush=True)
    base = builds["base"][0]
    rows = []
    for B, n in SHAPES:
        ops = _inputs(B, n)
        want = _round(base, ops)
        for name in VARIANTS:
            fn = builds[name][0]
            same = torch.equal(want, _round(fn, ops))
            turns = {"base": [], name: []}
            for side in ("base", name, name, "base"):
                turns[side].append(_median_us(base if side == "base" else fn, ops,
                                              args.reps))
            row = {"variant": name, "shape": [B, n, n], "same_bits": same,
                   "base_us": statistics.median(turns["base"]),
                   "variant_us": statistics.median(turns[name])}
            rows.append(row)
            print(f"{name} ({B}, {n}, {n}): base {row['base_us']:.1f} us, "
                  f"variant {row['variant_us']:.1f} us, same bits {same}", flush=True)
            if not same and name not in PROBES:
                print(f"{name}: the variant changed bits", file=sys.stderr)
                return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi.stdout.strip(), "rows": rows,
                       "ptxas": {k: v[1] for k, v in builds.items()}}, f, indent=1)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
