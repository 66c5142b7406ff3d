"""Static program audit gate over the port's program catalog (port of
``tools/program_audit.py``).

Audits the catalog of :mod:`.catalog` (the trainer's step, the serving
engine's decode steps and prefill chunks, the page copier, the host tier's
window pair, the tensor-parallel and disaggregated programs) with the rule
passes of :mod:`.rules` (dtype promotion, in-place declarations, recapture
hazards, collective axes, constant bloat) over fake-tensor traces, and
diffs the findings against the baseline beside this module. NEW findings
fail the gate; findings the baseline accepts pass; baseline entries that
no longer reproduce are reported as fixed (refresh with
``--write-baseline``). No card is needed.

Usage:
  python -m paddle_tpu_torch.analysis.program_audit              # gate
  python -m paddle_tpu_torch.analysis.program_audit --json out.json
  python -m paddle_tpu_torch.analysis.program_audit --write-baseline
  python -m paddle_tpu_torch.analysis.program_audit --program serving_decode
  python -m paddle_tpu_torch.analysis.program_audit --list
  python -m paddle_tpu_torch.analysis.program_audit --demo-regression
      # also audit the pre-fix AdamW and the mismatched-axis tp decode
      # step (must exit 2)

Exit codes: 0 clean (no new findings), 2 new findings (or a
``--demo-regression`` specimen whose finding did not fire), 3 bad
invocation or broken baseline. A program that fails to trace is itself a
finding (TRACE_ERROR), so 2 covers it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "program_audit_baseline.json")

#: the finding each regression specimen must raise
DEMO_EXPECTED = {"demo_regression_adamw": "F64_PROMOTION",
                 "demo_regression_tp_axis": "UNKNOWN_COLLECTIVE_AXIS"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis.program_audit",
        description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default: the package's "
                         "program_audit_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the diff: report findings, exit 2 on any")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze the current findings as the baseline and "
                         "exit 0")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full findings document to PATH")
    ap.add_argument("--program", action="append", default=None,
                    help="audit only these catalog programs (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="print the catalog's program names and exit")
    ap.add_argument("--demo-regression", action="store_true",
                    help="also audit the two regression specimens: the "
                         "gate must fail")
    ap.add_argument("--quiet", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 3

    from .catalog import (CATALOG_PROGRAMS, build_catalog,
                          build_demo_regression, build_demo_tp_regression)
    if args.list:
        print("\n".join(CATALOG_PROGRAMS))
        return 0
    from .auditor import (audit_spec, diff_findings, findings_to_json,
                          load_baseline, write_baseline)
    if args.write_baseline and args.demo_regression:
        print("[audit] refusing --write-baseline with --demo-regression: "
              "the specimens must never become accepted findings",
              file=sys.stderr)
        return 3
    if args.write_baseline and args.program and os.path.realpath(
            args.baseline) == os.path.realpath(DEFAULT_BASELINE):
        print("[audit] refusing --write-baseline for a --program subset "
              "over the package's baseline: audit the whole catalog, or "
              "point --baseline at another file", file=sys.stderr)
        return 3
    try:
        specs = build_catalog(names=args.program)
    except ValueError as e:
        print(f"[audit] {e}", file=sys.stderr)
        return 3
    if args.demo_regression:
        specs += [build_demo_regression(), build_demo_tp_regression()]
    reports = [audit_spec(s) for s in specs]
    doc = findings_to_json(reports)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    say = (lambda *a: None) if args.quiet else print
    for r in reports:
        launches = r.meta.get("launches") or {}
        extra = (f" ({r.meta.get('nodes')} nodes"
                 + (", launches " + ", ".join(
                     f"{k} x{v}" for k, v in sorted(launches.items()))
                    if launches else "") + ")") if "nodes" in r.meta else ""
        say(f"[audit] {r.program}: {len(r.findings)} finding(s){extra}")
        for f in r.findings:
            say(f"  {f.severity:7s} {f.rule}/{f.code} @ {f.site}")
            say(f"          {f.message}")

    silent = [name for name, code in DEMO_EXPECTED.items()
              if args.demo_regression and not any(
                  f.code == code for r in reports if r.program == name
                  for f in r.findings)]
    for name in silent:
        print(f"[audit] SELF-CHECK FAILED: {name} raised no "
              f"{DEMO_EXPECTED[name]}", file=sys.stderr)
    if args.write_baseline:
        write_baseline(reports, args.baseline)
        say(f"[audit] baseline written: {args.baseline} "
            f"({doc['summary']['findings']} accepted finding(s))")
        return 0
    if args.no_baseline:
        n = doc["summary"]["findings"]
        say(f"[audit] {n} finding(s), no baseline diff")
        return 2 if n or silent else 0
    try:
        baseline = load_baseline(args.baseline)
    except FileNotFoundError:
        say(f"[audit] no baseline at {args.baseline}: every finding is new "
            "(write one with --write-baseline)")
        baseline = {"findings": {}}
    except ValueError as e:
        print(f"[audit] BROKEN BASELINE: {e}", file=sys.stderr)
        return 3

    new, fixed = diff_findings(reports, baseline)
    for fp in fixed:
        say(f"[audit] fixed against the baseline: {fp}")
    if new:
        print(f"[audit] GATE FAILED: {len(new)} new finding(s) against "
              f"{args.baseline}:", file=sys.stderr)
        for f in new:
            print(f"  {f.severity:7s} {f.fingerprint}\n"
                  f"          {f.message}", file=sys.stderr)
        return 2
    if silent:
        return 2
    say(f"[audit] gate clean: {doc['summary']['findings']} finding(s), "
        f"all accepted by the baseline ({len(fixed)} fixed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
