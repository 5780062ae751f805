"""conflux_tpu_torch — the PyTorch/CUDA port of conflux_tpu for NVIDIA Hopper.

A second package beside `conflux_tpu` (the JAX reference, unchanged). Plain
tensor code is PyTorch; every Pallas kernel of the JAX package on a ported
path becomes a kernel written by hand for sm_90a (`ops/hopper_kernels.py`,
sources in `ops/csrc/`). Module layout mirrors `conflux_tpu`, so each
module's counterpart sits under the same path. Entry points run on the
card unless the caller asks for the CPU (`device="cpu"`), where the
kernels' plain PyTorch versions run instead.

Ported so far: the single-device LU factorization path of the
`conflux_miniapp` CLI (`lu_factor_blocked`, `lu_solve`, validation).
"""

from conflux_tpu_torch.geometry import Grid3, LUGeometry, choose_grid


def __getattr__(name):
    # lazy top-level API: keep `import conflux_tpu_torch` free of torch
    _lazy = {
        "lu_factor_blocked": ("conflux_tpu_torch.lu.single", "lu_factor_blocked"),
        "unpack_lu": ("conflux_tpu_torch.lu.single", "unpack_lu"),
        "from_numpy": ("conflux_tpu_torch.lu.single", "from_numpy"),
        "state_from_numpy": ("conflux_tpu_torch.lu.single", "state_from_numpy"),
        "lu_solve": ("conflux_tpu_torch.solvers", "lu_solve"),
        "refine_classic": ("conflux_tpu_torch.solvers", "refine_classic"),
        "lu_residual": ("conflux_tpu_torch.validation", "lu_residual"),
        "lu_residual_device": (
            "conflux_tpu_torch.validation", "lu_residual_device"),
        "resolve_device": ("conflux_tpu_torch.device", "resolve_device"),
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
    "lu_solve",
    "refine_classic",
    "lu_residual",
    "lu_residual_device",
    "resolve_device",
]
