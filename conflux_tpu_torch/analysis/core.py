"""conflint core (the port's copy of `conflux_tpu/analysis/core.py`): source
model, annotations, suppressions, report.

The serve stack's correctness rests on conventions (lock-guarded
attributes, donation ownership, a no-host-sync rule on the dispatch hot
path, future-resolution ownership) that unit tests can only spot-check.
conflint turns each convention into a mechanical rule over the AST (see
`conflux_tpu_torch.analysis.rules`) so the whole tree is re-proved on
every run.

This module is deliberately stdlib-only (ast + tokenize): the analyzer
must run in a bare CI step and never imports torch or the code it
analyzes (importing the package under analysis would skew what it
measures).

Vocabulary (all machine-read from comments, all demonstrated in
`tests/test_torch_analysis.py`):

- ``# guarded-by: _lock`` on an attribute's initializing assignment
  (or a module-global's) declares the lock that must be held at every
  later access. CFX-LOCK enforces it.
- ``# hot-path`` on (or directly above) a ``def`` marks a function on
  the dispatch hot path: CFX-HOSTSYNC forbids host syncs inside.
- ``# futures-owner`` marks a worker-body function that owns request
  futures: CFX-FUTURE forbids exception edges that strand them.
- ``# requires-lock: _lock`` on a ``def`` asserts the caller holds the
  lock (private helpers only called under it).
- ``# conflint: disable=RULE[,RULE] reason`` suppresses a finding on
  its own line (or, on a standalone comment line, on the next line).
  Suppressions are counted in the report: they are visible debt, not
  silence.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

RULE_IDS = ("CFX-LOCK", "CFX-DONATE", "CFX-HOSTSYNC", "CFX-FUTURE",
            "CFX-RECOMPILE", "CFX-EXCEPT")

_SUPPRESS_RE = re.compile(
    r"#\s*conflint:\s*disable=([A-Za-z0-9_\-,]+)(?:\s+(.*))?")
_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_REQ_LOCK_RE = re.compile(r"#\s*requires-lock:\s*([A-Za-z_]\w*)")
_HOT_RE = re.compile(r"#\s*hot-path\b")
_FUT_RE = re.compile(r"#\s*futures-owner\b")

# directories never worth scanning (vendored code, caches, VCS)
EXCLUDE_DIRS = {".git", "__pycache__", ".pytest_cache", ".mypy_cache",
                "libs", "data", "node_modules", ".venv", "venv",
                "build", "dist", ".eggs", "_kernels", "_build"}


@dataclasses.dataclass
class Finding:
    """One rule hit. `suppressed` findings are reported (and counted)
    but do not fail the run; `reason` carries the suppression comment's
    justification text."""

    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def as_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "message": self.message}
        if self.suppressed:
            d["reason"] = self.reason
        return d

    def __str__(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}{tag}: {self.message}"


class SourceFile:
    """One parsed source: AST + per-line comments + the machine-read
    annotation/suppression maps every rule shares."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        # line -> full comment text (tokenize sees only real comments,
        # never string literals — fixture snippets in tests stay inert)
        self.comments: dict[int, str] = {}
        # comment-only lines (annotation/suppression applies to the
        # NEXT line as well)
        self._own_line: set[int] = set()
        lines = text.splitlines()
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    ln = tok.start[0]
                    self.comments[ln] = tok.string
                    if lines[ln - 1].lstrip().startswith("#"):
                        self._own_line.add(ln)
        except tokenize.TokenError:
            pass
        # line -> (set of suppressed rule ids, reason)
        self.suppressions: dict[int, tuple[set, str]] = {}
        self.suppressions_used: list[Finding] = []
        for ln, c in self.comments.items():
            m = _SUPPRESS_RE.search(c)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",")}
            reason = (m.group(2) or "").strip()
            entry = (rules, reason)
            self.suppressions[ln] = entry
            if ln in self._own_line:  # standalone comment covers next line
                self.suppressions.setdefault(ln + 1, entry)

    # -- annotation lookups ------------------------------------------- #

    def comment_at(self, *lines: int) -> str:
        return " ".join(self.comments.get(ln, "") for ln in lines)

    def guard_on(self, node: ast.stmt) -> str | None:
        """`# guarded-by: NAME` on any line the statement spans."""
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        for ln in range(node.lineno, end + 1):
            m = _GUARD_RE.search(self.comments.get(ln, ""))
            if m:
                return m.group(1)
        return None

    def _def_comment(self, node: ast.AST) -> str:
        return self.comment_at(node.lineno, node.lineno - 1)

    def is_hot_path(self, node: ast.AST) -> bool:
        return bool(_HOT_RE.search(self._def_comment(node)))

    def is_futures_owner(self, node: ast.AST) -> bool:
        return bool(_FUT_RE.search(self._def_comment(node)))

    def required_locks(self, node: ast.AST) -> set:
        m = _REQ_LOCK_RE.search(self._def_comment(node))
        return {m.group(1)} if m else set()

    # -- finding emission (suppression-aware) ------------------------- #

    def emit(self, out: list, rule: str, line: int, message: str) -> None:
        sup = self.suppressions.get(line)
        if sup is not None and (rule in sup[0] or "ALL" in sup[0]):
            out.append(Finding(rule, self.path, line, message,
                               suppressed=True, reason=sup[1]))
        else:
            out.append(Finding(rule, self.path, line, message))


def scan_source(text: str, path: str = "<string>",
                rules=None) -> list[Finding]:
    """Run the rules over one in-memory source (fixture tests' entry
    point). Returns every finding, suppressed ones included."""
    from conflux_tpu_torch.analysis.rules import ALL_RULES

    sf = SourceFile(path, text)
    out: list[Finding] = []
    for rule in (ALL_RULES if rules is None else rules):
        rule.check(sf, out)
    return out


def iter_py_files(paths) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in EXCLUDE_DIRS)
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    return files


@dataclasses.dataclass
class Report:
    """One conflint run over a file set. `findings` are live (fail the
    run), `suppressions` are acknowledged hits. `summary()` is the
    diffable trend surface (the `profiler.serve_stats()` shape): rules
    run, findings, suppressions, files scanned, per-rule counts."""

    files_scanned: int
    findings: list[Finding]
    suppressions: list[Finding]
    errors: list[str]

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors

    def summary(self) -> dict:
        by_rule = {r: {"findings": 0, "suppressions": 0}
                   for r in RULE_IDS}
        for f in self.findings:
            by_rule.setdefault(
                f.rule, {"findings": 0, "suppressions": 0})
            by_rule[f.rule]["findings"] += 1
        for f in self.suppressions:
            by_rule.setdefault(
                f.rule, {"findings": 0, "suppressions": 0})
            by_rule[f.rule]["suppressions"] += 1
        return {"rules_run": len(RULE_IDS),
                "files_scanned": self.files_scanned,
                "findings": len(self.findings),
                "suppressions": len(self.suppressions),
                "parse_errors": len(self.errors),
                "by_rule": by_rule}

    def as_dict(self) -> dict:
        return {"tool": "conflint", "version": 1,
                "summary": self.summary(),
                "findings": [f.as_dict() for f in self.findings],
                "suppressions": [f.as_dict() for f in self.suppressions],
                "parse_errors": self.errors}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


def run_paths(paths, rules=None) -> Report:
    """Scan every .py under `paths` and fold the findings into a
    :class:`Report`. Unparseable files are reported as errors (a file
    conflint cannot read is a finding, not a pass)."""
    from conflux_tpu_torch.analysis.rules import ALL_RULES

    rules = ALL_RULES if rules is None else rules
    findings: list[Finding] = []
    suppressions: list[Finding] = []
    errors: list[str] = []
    files = iter_py_files(paths)
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            sf = SourceFile(path, text)
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{path}: {e}")
            continue
        out: list[Finding] = []
        for rule in rules:
            rule.check(sf, out)
        for f in out:
            (suppressions if f.suppressed else findings).append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressions.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(len(files), findings, suppressions, errors)
