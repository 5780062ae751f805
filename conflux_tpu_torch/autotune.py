"""Measured variant dispatch: pick factorization knobs from recorded
measurements instead of asking the user (the port of
`conflux_tpu/autotune.py`, the role of the reference's hand-measured
variant switch, `src/conflux/cholesky/Cholesky.cpp:857-921`).

The rules are data: a built-in table, extended or overridden by a JSON
table (`$CONFLUX_TPU_TORCH_TUNE_TABLE`, or :func:`load_table`), so a tuning
session on the card changes dispatch by committing a data file. Lookup is
most-specific-wins (device > P > dtype > bounded N range), later-loaded
rules beating built-ins on ties.

Rules exist only where measurements of this port exist: the library
defaults, and the grid LU on one H100 that `scripts/torch_tune.py`
measured. The JAX package's rules, measured on a TPU and on its CPU mesh,
are not the port's. `recommended()` names its rule's measurement, or says
that none exists, in its provenance.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

_VALID_ALGOS = ("lu", "cholesky", "qr")
_TABLE_ENV = "CONFLUX_TPU_TORCH_TUNE_TABLE"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One measured dispatch rule. `None` fields match anything; `device`
    is a substring of the lowercased device name (e.g. 'h100', 'cpu'), or
    a tuple of them (any of). `n_lo`/`n_hi` bound the (unpadded) matrix
    dimension inclusively."""

    algo: str
    knobs: Mapping[str, Any]
    device: str | tuple | None = None
    P: int | None = None
    n_lo: int = 0
    n_hi: int | None = None
    dtype: str | None = None
    provenance: str = ""

    def matches(self, algo: str, N: int, P: int, dtype: str, device_kind: str) -> bool:
        dev = (self.device,) if isinstance(self.device, str) else self.device
        return (self.algo == algo
                and (dev is None or any(d in device_kind for d in dev))
                and (self.P is None or self.P == P)
                and self.n_lo <= N <= (self.n_hi if self.n_hi is not None else N)
                and (self.dtype is None or self.dtype == dtype))

    def specificity(self) -> int:
        return ((8 if self.device is not None else 0)
                + (4 if self.P is not None else 0)
                + (2 if self.dtype is not None else 0)
                + (1 if (self.n_lo > 0 or self.n_hi is not None) else 0))


@dataclasses.dataclass(frozen=True)
class Recommendation:
    knobs: dict
    provenance: str


# the library defaults, the weakest rule per algo: what the entry points
# do when no knob is passed. `v` is None: the un-passed tile default is
# each miniapp's own (Cholesky's memory heuristic), and None knobs never
# overwrite (`cli.common.apply_auto`)
_DEFAULTS = {
    "lu": dict(precision="highest", v=None, panel_chunk=None, segs=(16, 16),
               tree="pairwise", update="segments", lookahead=False, election="gather"),
    "cholesky": dict(precision="highest", v=None, segs=(8, 8), lookahead=False),
    "qr": dict(precision="highest", v=None, csegs=8, lookahead=False, tree="gather"),
}

_BUILTIN_RULES: list[Rule] = [
    *[Rule(algo=a, knobs=_DEFAULTS[a],
           provenance="library defaults — no measurement matches this configuration")
      for a in _VALID_ALGOS],
    # ----- one H100, the grid LU on 1x1x1: scripts/torch_tune.py -----
    Rule(algo="lu", device=("h100",), P=1, n_lo=8192, n_hi=32768, dtype="float32",
         knobs=dict(_DEFAULTS["lu"], v=1024, panel_chunk=8192, segs=(4, 4)),
         provenance="scripts/torch_tune.py --reps 3 on an NVIDIA H100 80GB HBM3 (power "
         "limit 700.00 W), backend kernel: N=32768 segs=4x4 21643-21991 GFLOP/s against "
         "the 16x16 default's 20529-20884 (4 runs each, alternating; residual 1.841e-05 "
         "either way, segments change no bit), N=16384 12053 against 7001, N=8192 5320 "
         "against 4475; chunk 8192 beat 4096 and 12288, v=1024 beat 512 and 2048; "
         "backend xla at N=32768 (--reps 3, alternating): segs=4x4 21474-21613 against "
         "16x16's 21175-21296; precision=highest: a TF32 factor (HIGH on backend xla) "
         "reads 2.997e-01 at N=32768, past residual_bound(N, float32)"),
]

_loaded_rules: list[Rule] = []
_env_table_loaded = False


def _rules() -> list[Rule]:
    global _env_table_loaded
    if not _env_table_loaded:
        _env_table_loaded = True
        path = os.environ.get(_TABLE_ENV)
        if path:
            load_table(path)
    return _BUILTIN_RULES + _loaded_rules


def load_table(path: str) -> int:
    """Append rules from a JSON file (a list of Rule-shaped objects; only
    `algo` and `knobs` are required). Later rules beat built-ins on
    specificity ties. Returns the number of rules added."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"{path}: tune table must be a JSON list of rules")
    allowed = {f.name for f in dataclasses.fields(Rule)}
    added = []
    for i, r in enumerate(raw):
        if not isinstance(r, dict) or "algo" not in r or "knobs" not in r:
            raise ValueError(f"{path}[{i}]: each rule needs at least algo + knobs")
        if r["algo"] not in _VALID_ALGOS:
            raise ValueError(f"{path}[{i}]: unknown algo {r['algo']!r} "
                             f"(want one of {_VALID_ALGOS})")
        unknown = set(r) - allowed
        if unknown:
            raise ValueError(f"{path}[{i}]: unknown rule fields {sorted(unknown)}")
        knobs = {k: tuple(v) if isinstance(v, list) else v for k, v in r["knobs"].items()}
        dev = r.get("device")
        added.append(Rule(**{**r, "knobs": knobs,
                             "device": tuple(dev) if isinstance(dev, list) else dev}))
    _loaded_rules.extend(added)
    return len(added)


def reset_loaded_table() -> None:
    """Drop the JSON-loaded rules (a test hook; built-ins are immutable)."""
    global _env_table_loaded
    _loaded_rules.clear()
    _env_table_loaded = False


def detect_device_kind() -> str:
    """Lowercased name of the card the port runs on ('nvidia h100 80gb
    hbm3', ...), or 'cpu' on a machine without one."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0).lower()
    return "cpu"


def recommended(algo: str, N: int, P: int = 1, dtype: str = "float32",
                device_kind: str | None = None) -> Recommendation:
    """The measured-best knob set for (algo, N, P, dtype, device): the most
    specific matching rule's knobs and its provenance (which names the
    measurement, or says that none exists). `P` is the grid volume;
    `device_kind=None` detects it (:func:`detect_device_kind`)."""
    if algo not in _VALID_ALGOS:
        raise ValueError(f"unknown algo {algo!r} (want {_VALID_ALGOS})")
    if N < 1 or P < 1:
        raise ValueError(f"need positive N and P, got N={N} P={P}")
    dtype = str(dtype)
    device_kind = (detect_device_kind() if device_kind is None else device_kind).lower()
    best: Rule | None = None
    best_key = (-1, -1)
    for i, rule in enumerate(_rules()):
        if rule.matches(algo, N, P, dtype, device_kind):
            key = (rule.specificity(), i)  # ties: later-loaded wins
            if key > best_key:
                best, best_key = rule, key
    assert best is not None  # the catch-all rules always match
    return Recommendation(knobs=dict(best.knobs), provenance=best.provenance)
