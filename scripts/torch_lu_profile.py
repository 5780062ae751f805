"""Where the time of one `conflux_tpu_torch` LU factorization goes on the card.

    python scripts/torch_lu_profile.py [-N 32768] [-b 1024] [--out FILE.json]

Factors the miniapp's test matrix once as a warm-up, once timed with the
host clock (tracing off), and once under `torch.profiler` (CPU and CUDA
activity). Prints the device time of every kernel name over the traced
factorization, the share of the kernels of this repository (K1 `gemm`, K2
`lu_block`), the device's busy and idle shares of the traced wall time,
and the tracing overhead (traced wall minus untraced wall); with --out,
writes the same as JSON. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dev_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_lu_profile", description=__doc__)
    p.add_argument("-N", type=int, default=32768)
    p.add_argument("-b", "--block_size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default=None, help="also write the record as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_lu_profile needs an NVIDIA card")

    from torch.profiler import ProfilerActivity, profile

    from conflux_tpu_torch.lu.single import from_numpy, lu_factor_blocked
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.validation import make_test_matrix

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    A = from_numpy(make_test_matrix(args.N, args.N, seed=args.seed,
                                    dtype="float32"), "cuda")
    lu_factor_blocked(A, args.block_size)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()

    hopper_kernels.reset_launches()
    t0 = time.perf_counter()
    lu_factor_blocked(A, args.block_size)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(hopper_kernels.LAUNCHES)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lu_factor_blocked(A, args.block_size)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3

    kernels = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels.append({"name": evt.key, "calls": evt.count,
                            "device_ms": _dev_time_us(evt) / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy_ms = sum(k["device_ms"] for k in kernels)

    def share(tag):
        return sum(k["device_ms"] for k in kernels if tag in k["name"])

    rec = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "N": args.N, "v": args.block_size, "launches": launches,
        "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
        "tracing_overhead_ms": traced_ms - wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "k1_gemm_ms": share("gemm_kernel"), "k2_lu_block_ms": share("lu_block_kernel"),
        "kernels": kernels,
    }
    print(smi)
    print(f"N={args.N} v={args.block_size}: {wall_ms:.1f} ms untraced, {traced_ms:.1f} ms "
          f"traced; device busy {busy_ms:.1f} ms (idle {100 * rec['device_idle_share']:.1f}%)")
    print(f"K1 gemm {rec['k1_gemm_ms']:.1f} ms over {launches['gemm']} launches; "
          f"K2 lu_block {rec['k2_lu_block_ms']:.1f} ms over {launches['lu_block']} launches")
    print(f"{'device ms':>10} {'calls':>7}  kernel")
    for k in kernels[:args.top]:
        print(f"{k['device_ms']:>10.2f} {k['calls']:>7}  {k['name'][:110]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
