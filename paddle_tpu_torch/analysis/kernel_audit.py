"""Kernel-geometry gate of the port, over every launch it ships.

Captures each kernel's launch plan (grid, tiles of every phase, shared
memory, launcher signature) through its wrapper over meta tensors, at the
tiny and flagship shape classes of :mod:`.kernel_catalog`, evaluates the
tile maps over every work item and proves grid coverage
(GRID_FLOOR_DROP), tile bounds (OOB_BLOCK), write injectivity
(WRITE_RACE), the shared-memory budget (SMEM_OVERCOMMIT) and the ctypes
and Triton signatures (ARG_MISMATCH); and the registry lint
(DISPATCH_KEY_GAP) over every registered op's ``supports()`` predicates
against its declared program-key coverage. Findings diff against the
baseline beside this module, as ``tools/kernel_audit.py`` does for the
JAX package: new findings fail the gate. No card is needed.

Usage:
  python -m paddle_tpu_torch.analysis.kernel_audit                 # gate
  python -m paddle_tpu_torch.analysis.kernel_audit --json out.json
  python -m paddle_tpu_torch.analysis.kernel_audit --write-baseline
  python -m paddle_tpu_torch.analysis.kernel_audit --case fused_linear_ce \\
      --case decode_mlp_block@tiny
  python -m paddle_tpu_torch.analysis.kernel_audit --list
  python -m paddle_tpu_torch.analysis.kernel_audit --demo-regression
      # also audit the floor-divided demo_prefix_mlp_block (must exit 2)

Exit codes: 0 clean (no new findings), 2 new findings, 3 bad invocation
or broken baseline. A case that fails to capture, or a declared launch
it no longer records, is itself a finding, so 2 covers those too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "kernel_audit_baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis.kernel_audit",
        description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default: the package's "
                         "kernel_audit_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the diff: report findings, exit 2 on any")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze the current findings as the baseline and "
                         "exit 0")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full findings document to PATH")
    ap.add_argument("--case", action="append", default=None,
                    help="audit only these cases: an op name (all its "
                         "shape classes) or op@case (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="print the case names and exit")
    ap.add_argument("--demo-regression", action="store_true",
                    help="also audit the floor-divided "
                         "demo_prefix_mlp_block launch: the gate must fail")
    ap.add_argument("--quiet", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 3

    from .auditor import (diff_findings, findings_to_json, load_baseline,
                          write_baseline)
    from .kernel_catalog import (KERNEL_CASE_NAMES, audit_kernels,
                                 build_demo_kernel_regression)
    if args.list:
        print("\n".join(KERNEL_CASE_NAMES
                         + ("flop_formulas", "kernel_registry")))
        return 0
    if args.write_baseline and args.demo_regression:
        print("[kernel-audit] refusing --write-baseline with "
              "--demo-regression: the specimen must never become an "
              "accepted finding", file=sys.stderr)
        return 3
    if args.write_baseline and args.case and os.path.realpath(
            args.baseline) == os.path.realpath(DEFAULT_BASELINE):
        print("[kernel-audit] refusing --write-baseline for a --case "
              "subset over the package's baseline: audit the whole "
              "catalog, or point --baseline at another file",
              file=sys.stderr)
        return 3

    try:
        reports = audit_kernels(names=args.case)
    except ValueError as e:
        print(f"[kernel-audit] {e}", file=sys.stderr)
        return 3
    if args.demo_regression:
        reports.append(build_demo_kernel_regression())
    doc = findings_to_json(reports)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    say = (lambda *a: None) if args.quiet else print
    for r in reports:
        extra = ""
        if r.meta.get("launches") is not None:
            extra = (f" ({r.meta['launches']} launch(es): "
                     f"{', '.join(r.meta.get('kernels', []))})")
        say(f"[kernel-audit] {r.program}: {len(r.findings)} "
            f"finding(s){extra}")
        for f in r.findings:
            say(f"  {f.severity:7s} {f.rule}/{f.code} @ {f.site}")
            say(f"          {f.message}")

    if args.write_baseline:
        write_baseline(reports, args.baseline)
        say(f"[kernel-audit] baseline written: {args.baseline} "
            f"({doc['summary']['findings']} accepted finding(s))")
        return 0
    if args.no_baseline:
        n = doc["summary"]["findings"]
        say(f"[kernel-audit] {n} finding(s), no baseline diff")
        return 2 if n else 0
    try:
        baseline = load_baseline(args.baseline)
    except FileNotFoundError:
        say(f"[kernel-audit] no baseline at {args.baseline}: every "
            "finding is new (write one with --write-baseline)")
        baseline = {"findings": {}}
    except ValueError as e:
        print(f"[kernel-audit] BROKEN BASELINE: {e}", file=sys.stderr)
        return 3

    new, fixed = diff_findings(reports, baseline)
    for fp in fixed:
        say(f"[kernel-audit] fixed against the baseline: {fp}")
    if new:
        print(f"[kernel-audit] GATE FAILED: {len(new)} new finding(s) "
              f"against {args.baseline}:", file=sys.stderr)
        for f in new:
            print(f"  {f.severity:7s} {f.fingerprint}\n"
                  f"          {f.message}", file=sys.stderr)
        return 2
    say(f"[kernel-audit] gate clean: {doc['summary']['findings']} "
        f"finding(s), all accepted by the baseline ({len(fixed)} fixed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
