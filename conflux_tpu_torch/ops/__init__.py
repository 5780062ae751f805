"""Tile-level compute kernels (the pluggable BLAS boundary): the backend
registry in `blas`, the hand-written Hopper kernels in `hopper_kernels`
(CUDA sources in `csrc/`, built by `_build`), and the permutation ops."""

_LAZY = {
    "gemm": "blas",
    "trsm_left_lower_unit": "blas",
    "trsm_right_upper": "blas",
    "panel_lu": "blas",
    "blocked_trsm": "blas",
    "batched_lu_factor": "blas",
    "batched_cholesky_factor": "blas",
    "potrf": "blas",
    "trsm_right_lower_t": "blas",
    "trsm_left_lower": "blas",
    "trsm_left_lower_t": "blas",
    "set_backend": "blas",
    "get_backend": "blas",
    "set_panel_algo": "blas",
    "get_panel_algo": "blas",
}


def __getattr__(name):
    # lazy: importing a submodule must not pull in the others
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"conflux_tpu_torch.ops.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'conflux_tpu_torch.ops' has no attribute {name!r}")


__all__ = list(_LAZY)
