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
`inv_from_lu`, `solve_updated`, `lstsq`); the QR family on one device
(`qr/`: `tall_qr`, `qr_factor_blocked`, `cholesky_qr2`, and the
`qr_miniapp` CLI at 1x1x1); and the serving core (`FactorPlan` ->
`SolveSession`, `serve.py`) for LU, SPD and QR plans, through the
batched factor kernels or the batched blocked factor and the blocked
triangular-solve kernel, with Woodbury drift updates (`update.py`), the
precision ladder and the resilience layer's escalation rungs
(`resilience.py`, the port's own copy); the plan codec (`plan_spec`,
`plan_from_spec`); and the serving engine on one card (`engine.py`:
`ServeEngine` with its solve and factor lanes, gang-resident stacks
`gang.SessionGang`, QoS admission `qos.py`, prewarm, and the profiler's
serving counters); tiered session residency and the fleet checkpoint
(`tier.py`: `ResidentSet`, `save_fleet`, `load_fleet`, over the port's
copy of `io.py`'s matrix files) and the adaptive controller
(`control.py`: `AdaptiveController`, `ControlLimits`).
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
        "solve_updated_batched": ("conflux_tpu_torch.batched", "solve_updated_batched"),
        "solve_updated": ("conflux_tpu_torch.solvers", "solve_updated"),
        "lstsq": ("conflux_tpu_torch.solvers", "lstsq"),
        "qr_factor_blocked": ("conflux_tpu_torch.qr.single", "qr_factor_blocked"),
        "tall_qr": ("conflux_tpu_torch.qr.single", "tall_qr"),
        "cholesky_qr2": ("conflux_tpu_torch.qr.single", "cholesky_qr2"),
        "qr_residual_device": ("conflux_tpu_torch.validation", "qr_residual_device"),
        "DriftPolicy": ("conflux_tpu_torch.update", "DriftPolicy"),
        "HealthPolicy": ("conflux_tpu_torch.resilience", "HealthPolicy"),
        "FaultPlan": ("conflux_tpu_torch.resilience", "FaultPlan"),
        "FaultSpec": ("conflux_tpu_torch.resilience", "FaultSpec"),
        "RhsNonFinite": ("conflux_tpu_torch.resilience", "RhsNonFinite"),
        "SolveUnhealthy": ("conflux_tpu_torch.resilience", "SolveUnhealthy"),
        "PRECISION_TIERS": ("conflux_tpu_torch.serve", "PRECISION_TIERS"),
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
        "plan_spec": ("conflux_tpu_torch.serve", "plan_spec"),
        "plan_from_spec": ("conflux_tpu_torch.serve", "plan_from_spec"),
        "ServeEngine": ("conflux_tpu_torch.engine", "ServeEngine"),
        "EngineSaturated": ("conflux_tpu_torch.engine", "EngineSaturated"),
        "EngineClosed": ("conflux_tpu_torch.engine", "EngineClosed"),
        "place_session": ("conflux_tpu_torch.engine", "place_session"),
        "rendezvous_ranked": ("conflux_tpu_torch.engine", "rendezvous_ranked"),
        "SessionGang": ("conflux_tpu_torch.gang", "SessionGang"),
        "StatsWindow": ("conflux_tpu_torch.profiler", "StatsWindow"),
        "QosClass": ("conflux_tpu_torch.qos", "QosClass"),
        "TenantThrottled": ("conflux_tpu_torch.resilience", "TenantThrottled"),
        "ResidentSet": ("conflux_tpu_torch.tier", "ResidentSet"),
        "save_fleet": ("conflux_tpu_torch.tier", "save_fleet"),
        "load_fleet": ("conflux_tpu_torch.tier", "load_fleet"),
        "SessionSpilled": ("conflux_tpu_torch.resilience", "SessionSpilled"),
        "RestoreCorrupt": ("conflux_tpu_torch.resilience", "RestoreCorrupt"),
        "AdaptiveController": ("conflux_tpu_torch.control", "AdaptiveController"),
        "ControlLimits": ("conflux_tpu_torch.control", "ControlLimits"),
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
    "solve_updated_batched",
    "solve_updated",
    "lstsq",
    "qr_factor_blocked",
    "tall_qr",
    "cholesky_qr2",
    "qr_residual_device",
    "DriftPolicy",
    "HealthPolicy",
    "FaultPlan",
    "FaultSpec",
    "RhsNonFinite",
    "SolveUnhealthy",
    "PRECISION_TIERS",
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
    "plan_spec",
    "plan_from_spec",
    "ServeEngine",
    "EngineSaturated",
    "EngineClosed",
    "place_session",
    "rendezvous_ranked",
    "SessionGang",
    "StatsWindow",
    "QosClass",
    "TenantThrottled",
    "ResidentSet",
    "save_fleet",
    "load_fleet",
    "SessionSpilled",
    "RestoreCorrupt",
    "AdaptiveController",
    "ControlLimits",
]
