"""conflint in torch form: the port's static analysis layer.

The port's engine, tier, fabric, gang, wire and profiler modules are
multithreaded, and their correctness rests on conventions the rules
check: lock guards, donation ownership, no waits for the card on the
dispatch hot path, future-resolution ownership, bucket-keyed programs
built once, and BaseException discipline.

    python -m conflux_tpu_torch.analysis                # scan the port, exit 1 on a finding
    python -m conflux_tpu_torch.analysis --json r.json  # and write the report

With no paths it scans `conflux_tpu_torch/`, `chip_smoke.py`,
`scripts/torch_*.py` and `tests/test_torch_*.py` (`default_paths`).
`lockcheck` is the opt-in runtime half (lock-order cycles and
locks held across a dispatch): `scripts/torch_soak.py --serve --lockcheck`.

Rules live in `conflux_tpu_torch.analysis.rules`; this package imports
neither torch nor the code it scans.
"""

from conflux_tpu_torch.analysis.core import (
    Finding,
    Report,
    RULE_IDS,
    run_paths,
    scan_source,
)
from conflux_tpu_torch.analysis.rules import ALL_RULES


def default_paths() -> list[str]:
    """The port's tree: the package, `chip_smoke.py`, `scripts/torch_*.py`
    and `tests/test_torch_*.py` of the checkout that holds this package."""
    import glob
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    paths = [os.path.join(root, "conflux_tpu_torch")]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.isfile(smoke):
        paths.append(smoke)
    for pattern in ("scripts/torch_*.py", "tests/test_torch_*.py"):
        paths.extend(sorted(glob.glob(os.path.join(root, pattern))))
    return paths


__all__ = ["Finding", "Report", "RULE_IDS", "ALL_RULES", "default_paths", "run_paths",
           "scan_source"]
