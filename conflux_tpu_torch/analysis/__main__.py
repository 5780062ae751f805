"""`python -m conflux_tpu_torch.analysis` — run conflint over the port.

Exit status: 0 when every finding is suppressed (or none), 1 when any
live finding (or parse error) remains. `--json` writes the diffable
report (summary: rules run, findings, suppressions, files scanned)."""

from __future__ import annotations

import argparse
import sys

from conflux_tpu_torch.analysis import default_paths
from conflux_tpu_torch.analysis.core import run_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m conflux_tpu_torch.analysis",
        description="conflint: concurrency/donation/dispatch contract checks "
                    "for the port's serve stack")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: conflux_tpu_torch/, chip_smoke.py, "
                    "scripts/torch_*.py and tests/test_torch_*.py)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the JSON report here")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary only (no per-finding lines)")
    args = ap.parse_args(argv)

    report = run_paths(args.paths or default_paths())
    if not args.quiet:
        for f in report.findings:
            print(f)
        for f in report.suppressions:
            print(f)
        for e in report.errors:
            print(f"parse error: {e}")
    s = report.summary()
    print(f"conflint: {s['files_scanned']} files, {s['rules_run']} "
          f"rules, {s['findings']} finding(s), "
          f"{s['suppressions']} suppression(s)"
          + (f", {s['parse_errors']} parse error(s)"
             if report.errors else ""))
    if args.json:
        report.to_json(args.json)
        print(f"report written to {args.json}")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
