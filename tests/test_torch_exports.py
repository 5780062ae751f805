"""The port's public names against the JAX package's.

`conflux_tpu_torch.__all__` must cover `conflux_tpu.__all__`, less the
names whose modules are not ported yet (the serving mesh lane and the
persistent cache). Each slice that ports one of them takes it off
`NOT_PORTED`. Both lists are read with `ast`, so neither
package's heavy modules are imported for the comparison.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOT_PORTED = frozenset({
    # the serving mesh lane and the persistent cache
    "batch_mesh", "enable_persistent_cache",
})


def _all_of(pkg: str) -> list:
    with open(os.path.join(ROOT, pkg, "__init__.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"{pkg}/__init__.py has no __all__")


def test_port_exports_every_ported_reference_name():
    ref, port = set(_all_of("conflux_tpu")), set(_all_of("conflux_tpu_torch"))
    assert NOT_PORTED <= ref, sorted(NOT_PORTED - ref)
    missing = ref - port - NOT_PORTED
    assert not missing, f"reference names the port does not export: {sorted(missing)}"
    # a name ported since must come off the list
    assert not (NOT_PORTED & port), sorted(NOT_PORTED & port)


def test_port_all_has_no_duplicates():
    names = _all_of("conflux_tpu_torch")
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", _all_of("conflux_tpu_torch"))
def test_port_name_resolves(name):
    mod = importlib.import_module("conflux_tpu_torch")
    assert getattr(mod, name) is not None
