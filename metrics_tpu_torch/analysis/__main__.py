"""CLI: ``python -m metrics_tpu_torch.analysis [paths...]``.

Exit codes: 0 — no findings; 1 — findings (or unparsable files); 2 — usage
error. With no paths, lints the ``metrics_tpu_torch`` package. Imports
neither torch nor jax, so it runs on any machine.
"""
import argparse
import os
import sys
from typing import List

from metrics_tpu_torch.analysis import RULES, analyze_paths, iter_python_files


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.analysis",
        description=(
            "metricslint: static contract checker for metric classes "
            "(mutation discipline, host-sync antipatterns, declaration "
            "hygiene) and collective schedules (rank/data-independent "
            "emission order). Suppress a finding with a "
            "'# metricslint: disable=<rule>' comment on (or above) its line, "
            "or on the enclosing def/class line."
        ),
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the metrics_tpu_torch package)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    parser.add_argument(
        "--no-schedule", action="store_true",
        help="skip the collective-schedule pass (metric-class rules only)",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true", help="suppress the summary line"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rule, desc in RULES.items():
            print(f"{rule:<{width}}  {desc}")
        return 0

    paths = args.paths
    if not paths:
        paths = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such file or directory: {p}", file=sys.stderr)
            return 2

    findings, errors = analyze_paths(paths, schedule=not args.no_schedule)
    for f in findings:
        print(f.format())
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    if not args.quiet:
        n_files = len(iter_python_files(paths))
        print(
            f"metricslint: {len(findings)} finding(s), {len(errors)} error(s) "
            f"across {n_files} file(s)",
            file=sys.stderr,
        )
    return 1 if findings or errors else 0


if __name__ == "__main__":
    sys.exit(main())
