"""The port's persistent build cache (`conflux_tpu_torch/cache.py`), the
twin of `tests/test_cache.py`: where the JAX package points XLA's
compilation cache at a directory, the port points the builds of its
kernel library (`ops/_build.py`) and host library (`native/`) at a cache
root. The enable latch and both build roots are monkeypatched around each
test (no library loads here), so the order against other tests does not
matter.
"""

import os

import pytest
import torch

from conflux_tpu_torch import cache, native, serve
from conflux_tpu_torch.engine import ServeEngine
from conflux_tpu_torch.ops import _build

PKG = os.path.dirname(os.path.abspath(cache.__file__))


@pytest.fixture
def fresh_cache(monkeypatch, tmp_path):
    """Un-latch the switch, with both build roots restored afterwards and
    neither library loaded."""
    monkeypatch.setattr(cache, "_ENABLED_AT", None)
    monkeypatch.setattr(_build, "_OUT_ROOT", _build._OUT_ROOT)
    monkeypatch.setattr(native, "_OUT_ROOT", native._OUT_ROOT)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("CONFLUX_TPU_CACHE_DIR", raising=False)
    return tmp_path


def test_default_cache_dir_env_override(monkeypatch):
    monkeypatch.setenv("CONFLUX_TPU_CACHE_DIR", "/tmp/conflux-cache-test")
    assert cache.default_cache_dir() == "/tmp/conflux-cache-test"
    monkeypatch.delenv("CONFLUX_TPU_CACHE_DIR")
    # the in-tree default: the package directory, where the builds land
    assert cache.default_cache_dir() == PKG
    assert _build._OUT_ROOT.startswith(PKG) and native._OUT_ROOT.startswith(PKG)


def test_enable_points_the_build_roots_at_the_directory(fresh_cache):
    target = str(fresh_cache / "cache")
    assert cache.enable_persistent_cache(target) == target
    assert _build._OUT_ROOT == os.path.join(target, "ops", "_kernels")
    assert native._OUT_ROOT == os.path.join(target, "native", "_build")
    assert os.path.isdir(_build._OUT_ROOT) and os.path.isdir(native._OUT_ROOT)
    assert cache.cache_enabled() and cache.cache_dir() == target


def test_enable_is_idempotent_first_call_wins(fresh_cache):
    first = cache.enable_persistent_cache(str(fresh_cache / "a"))
    second = cache.enable_persistent_cache(str(fresh_cache / "b"))
    assert second == first, "a live cache must not be re-pointed"
    assert _build._OUT_ROOT == os.path.join(first, "ops", "_kernels")
    assert not os.path.exists(fresh_cache / "b")


def test_enable_degrades_to_none_on_failure(fresh_cache):
    """A root that cannot be made (a file in the way) returns None and
    leaves the builds where they are: a missing cache costs build time,
    never a kernel."""
    blocker = fresh_cache / "file"
    blocker.write_text("x")
    before = (_build._OUT_ROOT, native._OUT_ROOT)
    assert cache.enable_persistent_cache(str(blocker / "sub")) is None
    assert not cache.cache_enabled()
    assert (_build._OUT_ROOT, native._OUT_ROOT) == before


def test_env_var_resolves_when_no_path_given(fresh_cache, monkeypatch):
    target = str(fresh_cache / "from-env")
    monkeypatch.setenv("CONFLUX_TPU_CACHE_DIR", target)
    assert cache.enable_persistent_cache() == target
    assert native._OUT_ROOT == os.path.join(target, "native", "_build")


def test_a_loaded_library_keeps_its_root(fresh_cache, monkeypatch):
    """After a library has loaded from one root, a call with another path
    returns the live root and moves nothing."""
    monkeypatch.setattr(_build, "_lib", object())
    live = os.path.dirname(os.path.dirname(_build._OUT_ROOT))
    assert cache.enable_persistent_cache(str(fresh_cache / "other")) == live == PKG
    assert _build._OUT_ROOT == os.path.join(PKG, "ops", "_kernels")
    assert not os.path.exists(fresh_cache / "other")


def test_engine_persistent_cache_switches_it_on(fresh_cache, monkeypatch):
    monkeypatch.setenv("CONFLUX_TPU_CACHE_DIR", str(fresh_cache / "eng"))
    with ServeEngine(device="cpu", persistent_cache=False):
        assert cache.cache_dir() is None
    with ServeEngine(device="cpu"):
        assert cache.cache_dir() == str(fresh_cache / "eng")


def test_clear_plans_drops_cached_plans():
    serve.clear_plans()
    plan = serve.FactorPlan.create((16, 16), torch.float32, v=16)
    assert serve.FactorPlan.create((16, 16), torch.float32, v=16) is plan
    serve.clear_plans()
    fresh = serve.FactorPlan.create((16, 16), torch.float32, v=16)
    assert fresh is not plan, "clear_plans left a stale plan behind"
    serve.clear_plans()
