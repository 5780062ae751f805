"""Shared CLI plumbing for the port's miniapps."""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from conflux_tpu_torch.device import resolve_device, sync  # noqa: F401 (sync re-exported)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--platform", default="gpu", choices=["gpu", "cpu"],
        help="where to run (default gpu: the CUDA card, and an error without "
        "one); cpu runs the kernels' plain PyTorch versions")
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64", "bfloat16"],
        help="element type (float64 needs the library panel LU, not ported "
        "yet; bfloat16 stores the matrix in bf16 with f32 panel math)")
    p.add_argument("--profile", action="store_true", help="print region timings")


def platform_device(args) -> torch.device:
    """The device `--platform` names; raises without a card unless the
    caller asked for the CPU."""
    return resolve_device("cpu" if args.platform == "cpu" else "cuda")


def np_dtype(name: str):
    return {"float32": np.float32, "float64": np.float64, "bfloat16": np.float32}[name]


def refine_report(solve_fn, A: torch.Tensor, out_dtype: torch.dtype,
                  sweeps: int) -> float:
    """--refine epilogue: solve A x = 1 with `sweeps` classic-IR rounds
    (float64 residuals, the HPL-MxP recipe), print the `_solve_residual_`
    line, return the relative residual. A is the matrix that was factored,
    on the factors' device; corrections ride the factors' compute dtype."""
    from conflux_tpu_torch import solvers
    from conflux_tpu_torch.ops import blas

    n = A.shape[0]
    b = torch.ones((n,), dtype=A.dtype, device=A.device)
    corr_dtype = blas.compute_dtype(out_dtype)
    x = solvers.refine_classic(solve_fn, A, b, sweeps, torch.float64, corr_dtype)
    b64 = b.to(torch.float64)
    r = solvers._residual_strips(A, x, b64, torch.float64)
    rel = float(torch.linalg.norm(r) / torch.linalg.norm(b64))
    flag = "PASS" if rel <= 1e-6 else "----"
    print(f"_solve_residual_ refine={sweeps} rel={rel:.3e} [{flag} <=1e-6]")
    return rel


class WallTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3


def add_experiment_type_arg(p) -> None:
    """The reference's -t vocabulary (`examples/conflux_miniapp.cpp:63-66`)."""
    p.add_argument(
        "-t", "--type", default="weak", choices=["weak", "strong"],
        help="experiment type: sets the reported N_base (reference "
        "convention: N / int(sqrt(P)) for weak scaling, N for strong)")


def result_line(algo: str, N: int, P: int, grid, exp_type: str,
                ms: float, v: int, dtype: str) -> str:
    """Reference line shape (`examples/conflux_miniapp.cpp:136-165`):
    `_result_ <algo>,<impl>,<N>,<N_base>,<P>,<grid>,time,<weak|strong>,<ms>,<v>`
    with N_base = N // int(sqrt(P)) under weak scaling, and the dtype
    appended as an 11th field fixed-width parsers ignore."""
    n_base = N // math.isqrt(P) if exp_type == "weak" else N
    return (f"_result_ {algo},conflux_tpu_torch,{N},{n_base},{P},"
            f"{grid},time,{exp_type},{ms:.3f},{v},{dtype}")
