"""An autouse fixture for the port's test files that set a registry knob:
`blas`'s backend, panel algo and matmul precision must be the same after
each test as before it. A test that leaves one changed has its value put
back and fails, naming the knob, so the next test in the same worker
process never runs on another test's setting.

    from torch_registry_guard import registry_guard  # noqa: F401
"""

import pytest

from conflux_tpu_torch.ops import blas as tblas


def _state() -> tuple:
    return (tblas.get_backend(), tblas.get_panel_algo(), tblas.matmul_precision())


@pytest.fixture(autouse=True)
def registry_guard():
    before = _state()
    yield
    after = _state()
    if after != before:
        tblas.set_backend(before[0])
        tblas.set_panel_algo(before[1])
        tblas.set_matmul_precision(before[2])
        names = ("backend", "panel algo", "matmul precision")
        changed = [f"{n} {a!r} -> {b!r}" for n, a, b in zip(names, before, after) if a != b]
        pytest.fail(f"the test left the registry changed: {', '.join(changed)}")
