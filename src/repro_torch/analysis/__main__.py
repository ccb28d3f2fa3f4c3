"""CLI of the port's analyzer::

    PYTHONPATH=src python -m repro_torch.analysis [--rules ...] [paths]

Port of ``repro.analysis.__main__``, with the same flags and exit codes.
Exit code 0 when no non-baselined findings; 1 otherwise (so
``--fail-on-regression`` is the default behavior, the flag documents
intent). ``--write-baseline`` accepts the current findings as debt.
``--list-rules`` prints a header line that says why the reference's O002
is not among the rules.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.findings import Baseline
from repro_torch.analysis.registry import rule_table
from repro_torch.analysis.runner import (DEFAULT_BASELINE, run_analysis)


#: the first line of ``--list-rules``
O002_NOTE = ("# the reference's O002 (tracer emission inside a Pallas kernel "
             "body) is not here: the port's kernels are CUDA C++, so it has "
             "no kernel body in Python for the rule to read")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="architecture lint / resource-pairing / async-hazard "
                    "/ kernel-binding / tracing checks of the port "
                    "(L/R/A/K/O rule families)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: src/repro_torch "
                         "chip_smoke.py)")
    ap.add_argument("--rules", default="all",
                    help="comma list of rule ids and/or families "
                         "(e.g. L001,R or 'all')")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON of accepted findings "
                         "(default: analysis_baseline_torch.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current full finding set to the "
                         "baseline file and exit 0")
    ap.add_argument("--fail-on-regression", action="store_true",
                    help="exit 1 on non-baselined findings (this is "
                         "already the default; flag documents CI intent)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(O002_NOTE)
        for r in rule_table():
            print(f"{r['id']}  [{r['family']}/{r['severity']:7s}] "
                  f"{r['description']}")
        return 0

    rules = None if args.rules == "all" \
        else [r for r in args.rules.split(",") if r]
    baseline = None if args.no_baseline else args.baseline
    report = run_analysis(paths=args.paths or None, rules=rules,
                          baseline=None if args.write_baseline
                          else baseline)

    if args.write_baseline:
        Baseline(report.findings).save(args.baseline)
        print(f"wrote {len(report.findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in report.findings],
            "baselined": len(report.baselined),
            "files_checked": report.files_checked,
        }, indent=2))
    else:
        print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
