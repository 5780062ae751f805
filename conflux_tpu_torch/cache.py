"""The persistent build cache (the port of `conflux_tpu/cache.py`).

The JAX package points XLA's persistent compilation cache at a durable
directory so a cold process reuses warm compiles. The port compiles
nothing per program: what a cold process pays is the build of its two
native libraries, the CUDA kernel library (`ops/_build.py`, nvcc, about
a minute on the card) and the host tile-copy library (`native/`, g++).
Both are keyed by a hash of their sources and flags, so a build made once
is reused by every later process that finds it. This module is the one
switch that says where they live: a cache root R holds the kernel builds
under `R/ops/_kernels/<hash>/` and the host library under
`R/native/_build/<hash>/`.

The root resolves, in order:

1. an explicit `path=` argument,
2. `$CONFLUX_TPU_CACHE_DIR`,
3. the package directory itself, where the builds land today (so nothing
   moves unless asked).

The first call wins: later calls return the live root and change nothing,
and so does a call made after either library has loaded (its build is
where it is). A root that cannot be made returns None, as the JAX
package's does, and the builds stay in the package directory: a cache
that is not there costs build time, and never skips a kernel.
"""

from __future__ import annotations

import os

_PKG = os.path.dirname(os.path.abspath(__file__))
_ENABLED_AT: str | None = None


def default_cache_dir() -> str:
    """The root a call without `path=` uses (no filesystem side effects):
    `$CONFLUX_TPU_CACHE_DIR`, else the package directory."""
    env = os.environ.get("CONFLUX_TPU_CACHE_DIR")
    return env if env else _PKG


def _live_root() -> str | None:
    """The root a loaded library was built in, or None when neither has
    loaded yet."""
    from conflux_tpu_torch import native
    from conflux_tpu_torch.ops import _build

    for mod, tail in ((_build, os.path.join("ops", "_kernels")),
                      (native, os.path.join("native", "_build"))):
        if mod._lib is not None:
            root = mod._OUT_ROOT
            return root[:-len(tail)].rstrip(os.sep) if root.endswith(tail) else root
    return None


def enable_persistent_cache(path: str | None = None, *,
                            min_compile_secs: float = 10.0) -> str | None:
    """Point the kernel and host library builds at the cache root `path`
    (default :func:`default_cache_dir`), creating it on demand. Returns
    the live root, or None when it cannot be made (the builds then stay
    in the package directory). Safe to call many times: the first call
    wins, and once a library has loaded its root is the live one.
    `min_compile_secs` is the JAX package's admission threshold for XLA
    compiles; the port's builds have no compile-time threshold (each
    library is one build, always kept), so it is accepted and unused."""
    global _ENABLED_AT
    if _ENABLED_AT is not None:
        return _ENABLED_AT
    live = _live_root()
    if live is not None:
        _ENABLED_AT = live
        return live
    root = path or default_cache_dir()
    kernels = os.path.join(root, "ops", "_kernels")
    host = os.path.join(root, "native", "_build")
    try:
        os.makedirs(kernels, exist_ok=True)
        os.makedirs(host, exist_ok=True)
    except OSError:
        return None
    from conflux_tpu_torch import native
    from conflux_tpu_torch.ops import _build

    _build._OUT_ROOT = kernels
    native._OUT_ROOT = host
    _ENABLED_AT = root
    return root


def cache_enabled() -> bool:
    return _ENABLED_AT is not None


def cache_dir() -> str | None:
    """The live cache root, or None when no call has enabled one."""
    return _ENABLED_AT
