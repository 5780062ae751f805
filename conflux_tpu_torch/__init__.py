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
(`qr/`: `tall_qr`, `qr_factor_blocked`, `cholesky_qr2`); and the serving core (`FactorPlan` ->
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
(`control.py`: `AdaptiveController`, `ControlLimits`); and the serve
fabric (`fabric.py`: `ServeFabric` over in-process `LocalHost`s or
`ProcessHost` worker processes, with fail-over, migration, elastic
membership and replicas; `wire.py`, the shared-memory payload rings; and
`control.py`'s `HostLoadEstimator`, `AutoscalePolicy`, `FabricAutoscaler`);
and CONFLUX and CONFCHOX on a process grid (`parallel/mesh.py` on
`torch.distributed`: `make_mesh`, `distribute_shards`,
`initialize_multihost`; `lu/distributed.py`, `cholesky/distributed.py`,
their grid solves and residuals, `solve_distributed`, the scatter half of
`io.py`, `autotune.py`, and the miniapps' grid routes); distributed QR
and least squares on the grid (`qr/distributed.py`: `tsqr_distributed`,
`cholesky_qr2_distributed`, `qr_factor_distributed`, `qr_factor_steps`;
`lstsq_distributed`, `qr_lstsq_distributed`, `qr_residual_distributed`,
and the QR miniapp's grid route); and the host layout layer (`layout.py`,
the COSTA role, and `native/`, the C++ scatter/gather built at first use);
and the serving mesh lane and several lanes (`batch_mesh`, mesh plans
through `batched`, `serve`, `tier` and the engine; `ServeEngine(lanes=,
devices=)`), and the persistent build cache (`cache.py`:
`enable_persistent_cache`).
"""

from conflux_tpu_torch.geometry import Grid3, LUGeometry, choose_cholesky_grid, choose_grid


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
        "set_matmul_precision": ("conflux_tpu_torch.ops.blas", "set_matmul_precision"),
        "matmul_precision": ("conflux_tpu_torch.ops.blas", "matmul_precision"),
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
        "CholeskyGeometry": ("conflux_tpu_torch.geometry", "CholeskyGeometry"),
        "CounterWindow": ("conflux_tpu_torch.profiler", "CounterWindow"),
        "DeadlineExceeded": ("conflux_tpu_torch.resilience", "DeadlineExceeded"),
        "SessionQuarantined": ("conflux_tpu_torch.resilience", "SessionQuarantined"),
        "MeshPlanUnsupported": ("conflux_tpu_torch.resilience", "MeshPlanUnsupported"),
        "HostUnavailable": ("conflux_tpu_torch.resilience", "HostUnavailable"),
        "FleetDegraded": ("conflux_tpu_torch.resilience", "FleetDegraded"),
        "FairShareLedger": ("conflux_tpu_torch.qos", "FairShareLedger"),
        "batch_mesh": ("conflux_tpu_torch.batched", "batch_mesh"),
        "enable_persistent_cache": ("conflux_tpu_torch.cache", "enable_persistent_cache"),
        "stack_trees": ("conflux_tpu_torch.batched", "stack_trees"),
        "unstack_tree": ("conflux_tpu_torch.batched", "unstack_tree"),
        "write_slot_tree": ("conflux_tpu_torch.batched", "write_slot_tree"),
        "grow_stack_tree": ("conflux_tpu_torch.batched", "grow_stack_tree"),
        "DeviceLane": ("conflux_tpu_torch.engine", "DeviceLane"),
        "HostLoadEstimator": ("conflux_tpu_torch.control", "HostLoadEstimator"),
        "AutoscalePolicy": ("conflux_tpu_torch.control", "AutoscalePolicy"),
        "FabricAutoscaler": ("conflux_tpu_torch.control", "FabricAutoscaler"),
        "ServeFabric": ("conflux_tpu_torch.fabric", "ServeFabric"),
        "FabricPolicy": ("conflux_tpu_torch.fabric", "FabricPolicy"),
        "LocalHost": ("conflux_tpu_torch.fabric", "LocalHost"),
        "ProcessHost": ("conflux_tpu_torch.fabric", "ProcessHost"),
        "make_mesh": ("conflux_tpu_torch.parallel.mesh", "make_mesh"),
        "distribute_shards": ("conflux_tpu_torch.parallel.mesh", "distribute_shards"),
        "initialize_multihost": ("conflux_tpu_torch.parallel.mesh", "initialize_multihost"),
        "run_threaded": ("conflux_tpu_torch.parallel.mesh", "run_threaded"),
        "lu_factor_distributed": ("conflux_tpu_torch.lu.distributed", "lu_factor_distributed"),
        "lu_factor_steps": ("conflux_tpu_torch.lu.distributed", "lu_factor_steps"),
        "lu_distributed_host": ("conflux_tpu_torch.lu.distributed", "lu_distributed_host"),
        "cholesky_factor_distributed": (
            "conflux_tpu_torch.cholesky.distributed", "cholesky_factor_distributed"),
        "cholesky_factor_steps": (
            "conflux_tpu_torch.cholesky.distributed", "cholesky_factor_steps"),
        "cholesky_distributed_host": (
            "conflux_tpu_torch.cholesky.distributed", "cholesky_distributed_host"),
        "lu_solve_distributed": ("conflux_tpu_torch.solvers", "lu_solve_distributed"),
        "cholesky_solve_distributed": (
            "conflux_tpu_torch.solvers", "cholesky_solve_distributed"),
        "solve_distributed": ("conflux_tpu_torch.solvers", "solve_distributed"),
        "lu_residual_distributed": ("conflux_tpu_torch.validation", "lu_residual_distributed"),
        "cholesky_residual_distributed": (
            "conflux_tpu_torch.validation", "cholesky_residual_distributed"),
        "tsqr_distributed": ("conflux_tpu_torch.qr.distributed", "tsqr_distributed"),
        "cholesky_qr2_distributed": (
            "conflux_tpu_torch.qr.distributed", "cholesky_qr2_distributed"),
        "qr_distributed_host": ("conflux_tpu_torch.qr.distributed", "qr_distributed_host"),
        "qr_factor_distributed": ("conflux_tpu_torch.qr.distributed", "qr_factor_distributed"),
        "qr_factor_steps": ("conflux_tpu_torch.qr.distributed", "qr_factor_steps"),
        "lstsq_distributed": ("conflux_tpu_torch.solvers", "lstsq_distributed"),
        "qr_lstsq_distributed": ("conflux_tpu_torch.solvers", "qr_lstsq_distributed"),
        "qr_residual_distributed": ("conflux_tpu_torch.validation", "qr_residual_distributed"),
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
    "set_matmul_precision",
    "matmul_precision",
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
    "CholeskyGeometry",
    "CounterWindow",
    "DeadlineExceeded",
    "SessionQuarantined",
    "MeshPlanUnsupported",
    "HostUnavailable",
    "FleetDegraded",
    "FairShareLedger",
    "batch_mesh",
    "enable_persistent_cache",
    "stack_trees",
    "unstack_tree",
    "write_slot_tree",
    "grow_stack_tree",
    "DeviceLane",
    "HostLoadEstimator",
    "AutoscalePolicy",
    "FabricAutoscaler",
    "ServeFabric",
    "FabricPolicy",
    "LocalHost",
    "ProcessHost",
    "choose_cholesky_grid",
    "make_mesh",
    "distribute_shards",
    "initialize_multihost",
    "run_threaded",
    "lu_factor_distributed",
    "lu_factor_steps",
    "lu_distributed_host",
    "cholesky_factor_distributed",
    "cholesky_factor_steps",
    "cholesky_distributed_host",
    "lu_solve_distributed",
    "cholesky_solve_distributed",
    "solve_distributed",
    "lu_residual_distributed",
    "cholesky_residual_distributed",
    "tsqr_distributed",
    "cholesky_qr2_distributed",
    "qr_distributed_host",
    "qr_factor_distributed",
    "qr_factor_steps",
    "lstsq_distributed",
    "qr_lstsq_distributed",
    "qr_residual_distributed",
]
