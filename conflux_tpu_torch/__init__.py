"""conflux_tpu_torch — the PyTorch/CUDA port of conflux_tpu for NVIDIA Hopper.

A second package beside `conflux_tpu` (the JAX reference, unchanged). Plain
tensor code is PyTorch; every Pallas kernel of the JAX package on a ported
path becomes a kernel written by hand for sm_90a (`ops/hopper_kernels.py`,
sources in `ops/csrc/`). Module layout mirrors `conflux_tpu`, so each
module's counterpart sits under the same path. Entry points run on the
card unless the caller asks for the CPU (`device="cpu"`), where the
kernels' plain PyTorch versions run instead.

Ported so far: the single-device LU factorization path of the
`conflux_miniapp` CLI (`lu_factor_blocked`, `lu_solve`, validation), the
single-device Cholesky path of the `cholesky_miniapp` CLI
(`cholesky_blocked`, `cholesky_solve`), both on the kernel routes and on
the JAX package's library routes (backend "xla", panel algos "partial",
"tournament", "auto"; float64 and complex), with batched forms; the
batched entries (`batched.py`); the single-device solver API (`solve`,
`fgmres`, `lu_solve_transposed`, `slogdet_from_lu`, `cond_estimate_1`,
`inv_from_lu`); and the serving core (`FactorPlan` -> `SolveSession`,
`serve.py`) for LU and SPD plans, through the batched factor kernels or
the batched blocked factor, and the blocked triangular-solve kernel.
"""

from conflux_tpu_torch.geometry import Grid3, LUGeometry, choose_grid


def __getattr__(name):
    # lazy top-level API: keep `import conflux_tpu_torch` free of torch
    _lazy = {
        "lu_factor_blocked": ("conflux_tpu_torch.lu.single", "lu_factor_blocked"),
        "unpack_lu": ("conflux_tpu_torch.lu.single", "unpack_lu"),
        "from_numpy": ("conflux_tpu_torch.lu.single", "from_numpy"),
        "state_from_numpy": ("conflux_tpu_torch.lu.single", "state_from_numpy"),
        "cholesky_blocked": ("conflux_tpu_torch.cholesky.single", "cholesky_blocked"),
        "lu_solve": ("conflux_tpu_torch.solvers", "lu_solve"),
        "cholesky_solve": ("conflux_tpu_torch.solvers", "cholesky_solve"),
        "refine_classic": ("conflux_tpu_torch.solvers", "refine_classic"),
        "solve": ("conflux_tpu_torch.solvers", "solve"),
        "fgmres": ("conflux_tpu_torch.solvers", "fgmres"),
        "lu_solve_transposed": ("conflux_tpu_torch.solvers", "lu_solve_transposed"),
        "slogdet_from_lu": ("conflux_tpu_torch.solvers", "slogdet_from_lu"),
        "cond_estimate_1": ("conflux_tpu_torch.solvers", "cond_estimate_1"),
        "inv_from_lu": ("conflux_tpu_torch.solvers", "inv_from_lu"),
        "lu_factor_batched": ("conflux_tpu_torch.batched", "lu_factor_batched"),
        "cholesky_factor_batched": ("conflux_tpu_torch.batched", "cholesky_factor_batched"),
        "lu_solve_batched": ("conflux_tpu_torch.batched", "lu_solve_batched"),
        "cholesky_solve_batched": ("conflux_tpu_torch.batched", "cholesky_solve_batched"),
        "solve_batched": ("conflux_tpu_torch.batched", "solve_batched"),
        "make_hpd_matrix": ("conflux_tpu_torch.validation", "make_hpd_matrix"),
        "set_backend": ("conflux_tpu_torch.ops.blas", "set_backend"),
        "set_panel_algo": ("conflux_tpu_torch.ops.blas", "set_panel_algo"),
        "lu_residual": ("conflux_tpu_torch.validation", "lu_residual"),
        "lu_residual_device": (
            "conflux_tpu_torch.validation", "lu_residual_device"),
        "cholesky_residual": ("conflux_tpu_torch.validation", "cholesky_residual"),
        "cholesky_residual_device": (
            "conflux_tpu_torch.validation", "cholesky_residual_device"),
        "resolve_device": ("conflux_tpu_torch.device", "resolve_device"),
        "FactorPlan": ("conflux_tpu_torch.serve", "FactorPlan"),
        "SolveSession": ("conflux_tpu_torch.serve", "SolveSession"),
    }
    if name in _lazy:
        import importlib

        mod, attr = _lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'conflux_tpu_torch' has no attribute {name!r}")


__all__ = [
    "Grid3",
    "LUGeometry",
    "choose_grid",
    "lu_factor_blocked",
    "unpack_lu",
    "from_numpy",
    "state_from_numpy",
    "cholesky_blocked",
    "lu_solve",
    "cholesky_solve",
    "refine_classic",
    "solve",
    "fgmres",
    "lu_solve_transposed",
    "slogdet_from_lu",
    "cond_estimate_1",
    "inv_from_lu",
    "lu_factor_batched",
    "cholesky_factor_batched",
    "lu_solve_batched",
    "cholesky_solve_batched",
    "solve_batched",
    "make_hpd_matrix",
    "set_backend",
    "set_panel_algo",
    "lu_residual",
    "lu_residual_device",
    "cholesky_residual",
    "cholesky_residual_device",
    "resolve_device",
    "FactorPlan",
    "SolveSession",
]
