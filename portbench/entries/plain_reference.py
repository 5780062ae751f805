"""The plain reference (`reference/<cfg["reference"]>.py`) put in the
program's place, for the calibration and the tests: with the knob
`tf32=True` its trailing updates are TF32 products, the control one
precision below the configurations' float32. The benchmark's cells never
name it."""

from __future__ import annotations

from portbench import harness
from portbench.reference.common import refine


class Entry:
    def __init__(self, cfg: dict, device, knobs: dict | None = None):
        self.cfg, self.factor_out = cfg, None
        self.tf32 = bool((knobs or {}).get("tf32", False))
        self.ref = harness.load_module("reference", cfg["reference"])

    def factor(self, A):
        self.factor_out = None
        self.factor_out = self.ref.factor(A, self.cfg["v"], tf32=self.tf32)

    def solve(self, A, B):
        fac = self.factor_out
        args = fac if isinstance(fac, tuple) else (fac,)
        return refine(lambda r: self.ref.solve_factored(*args, r), A, B, self.cfg["sweeps"])

    def factor_solve(self, A, B):
        self.factor(A)
        return self.solve(A, B)

    def release(self) -> None:
        self.factor_out = None
