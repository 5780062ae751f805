"""Where the time of one `conflux_tpu_torch` LU factorization, or of one
serving run, goes on the card.

    python scripts/torch_lu_profile.py [-N 32768] [-b 1024] [--out FILE.json]
    python scripts/torch_lu_profile.py --serve a|b|c|d [--out FILE.json]
    python scripts/torch_lu_profile.py --qr [-N 32768] [-b 1024] [--out FILE.json]

Runs the work once as a warm-up, once timed with the host clock (tracing
off), and once under `torch.profiler` (CPU and CUDA activity). The work is
one factorization of the miniapp's test matrix, or with --serve a serving
configuration of `chip_smoke.py`: (a) a (32, 256, 256) f32 plan factored
once and served 16 rounds of `solve` and 16 of `solve_checked`, one
right-hand side per system; (b) 32 (1024, 1024) f32 systems through the
factor lane's checked bucket `_factor_health_fn(32)`; (c) and (d) the same
with SPD plans (kind="chol") on SPD systems; with --qr, one
`qr.distributed.qr_factor_distributed` on a world-size-1 1x1x1 mesh of an
(N, N) standard normal f32 matrix. Prints the device time of
every kernel name over the traced run, the time and launches of each
kernel of this repository (K1 `gemm`, both instances, and `gemm_tma`,
its TMA instance; K2 `lu_block`, K3 `btrsm`, K4 `batched_lu`, K5
`batched_chol`), the device's busy and idle shares of the
traced wall time,
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


def _serve_work(cfg: str):
    """The work of serving configuration `cfg` and its label."""
    import numpy as np

    from conflux_tpu_torch import serve

    rng = np.random.default_rng(0)

    kind = "chol" if cfg in ("c", "d") else "lu"

    def systems(B, n):
        A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        if kind == "chol":  # the JAX serve tests' SPD class
            A = A @ np.swapaxes(A, 1, 2) + np.eye(n)
        return torch.from_numpy(A.astype(np.float32)).to("cuda")

    if cfg in ("a", "c"):
        plan = serve.FactorPlan.create((32, 256, 256), torch.float32, v=128, kind=kind)
        A = systems(32, 256)
        rhs = [torch.from_numpy(rng.standard_normal((32, 256)).astype(np.float32)).to("cuda")
               for _ in range(16)]

        def run():
            s = plan.factor(A)
            for b in rhs:
                s.solve(b)
            for b in rhs:
                s.solve_checked(b)
        return run, (f"serving ({cfg}): (32, 256, 256) kind={kind} factor + 16 solve + "
                     "16 checked rounds")
    plan = serve.FactorPlan.create((1024, 1024), torch.float32, v=128, kind=kind)
    A = systems(32, 1024)
    return (lambda: plan._factor_health_fn(32)(A),
            f"serving ({cfg}): 32 x (1024, 1024) kind={kind} through _factor_health_fn(32)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_lu_profile", description=__doc__)
    p.add_argument("-N", type=int, default=32768)
    p.add_argument("-b", "--block_size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default=None, help="also write the record as JSON here")
    p.add_argument("--serve", choices=("a", "b", "c", "d"), default=None,
                   help="profile serving configuration a, b, c or d instead")
    p.add_argument("--qr", action="store_true",
                   help="profile the distributed QR (qr_factor_distributed on 1x1x1) instead")
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
    if args.qr:
        from conflux_tpu_torch.geometry import Grid3, LUGeometry
        from conflux_tpu_torch.parallel.mesh import make_mesh
        from conflux_tpu_torch.qr.distributed import qr_factor_distributed

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        A = torch.randn((args.N, args.N), generator=gen, device="cuda")
        geom = LUGeometry.create(args.N, args.N, args.block_size, Grid3(1, 1, 1))
        mesh = make_mesh(Grid3(1, 1, 1))

        def work():
            qr_factor_distributed(A, geom, mesh)
        label = f"qr_factor_distributed N={args.N} v={args.block_size}"
    elif args.serve is None:
        A = from_numpy(make_test_matrix(args.N, args.N, seed=args.seed,
                                        dtype="float32"), "cuda")

        def work():
            lu_factor_blocked(A, args.block_size)
        label = f"N={args.N} v={args.block_size}"
    else:
        work, label = _serve_work(args.serve)
    work()  # warm-up: kernel build, allocator
    torch.cuda.synchronize()

    hopper_kernels.reset_launches()
    t0 = time.perf_counter()
    work()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(hopper_kernels.LAUNCHES)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3

    kernels = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels.append({"name": evt.key, "calls": evt.count,
                            "device_ms": _dev_time_us(evt) / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy_ms = sum(k["device_ms"] for k in kernels)

    def share(name):
        # K1's two instances are gemm_tma_kernel and gemm_simt_kernel
        tags = ("gemm_tma_kernel", "gemm_simt_kernel") if name == "gemm" else (f"{name}_kernel",)
        return sum(k["device_ms"] for k in kernels if any(t in k["name"] for t in tags))

    rec = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "work": label, "launches": launches,
        "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
        "tracing_overhead_ms": traced_ms - wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "repo_kernel_ms": {k: share(k) for k in launches},
        "kernels": kernels,
    }
    print(smi)
    print(f"{label}: {wall_ms:.3f} ms untraced, {traced_ms:.3f} ms traced; device busy "
          f"{busy_ms:.3f} ms (idle {100 * rec['device_idle_share']:.1f}%)")
    print("; ".join(f"{k} {ms:.3f} ms over {launches[k]} launches"
                    for k, ms in rec["repo_kernel_ms"].items()))
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
