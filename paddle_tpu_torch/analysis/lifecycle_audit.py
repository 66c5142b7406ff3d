"""Lifecycle model-checker gate over the port's serving state machine.

Explores the scope catalog (:data:`.lifecycle.SCOPES`) exhaustively: every
interleaving of submit/admit/prefill/decode/finish/preempt/expire/evict/
spill/restore/handoff/abort actions at small scopes, driving the port's
``BlockManager``, ``PrefixCache`` and ``AdmissionQueue``, and diffs the
findings against the baseline beside this module, as
``tools/lifecycle_audit.py`` does for the JAX package. NEW findings fail
the gate with exit code 2 and print a BFS-shortest, replayable trace; the
catalog holds 0 findings. It runs on the CPU and imports no device code.

Usage:
  python -m paddle_tpu_torch.analysis.lifecycle_audit          # gate
  python -m paddle_tpu_torch.analysis.lifecycle_audit --json out.json
  python -m paddle_tpu_torch.analysis.lifecycle_audit --write-baseline
  python -m paddle_tpu_torch.analysis.lifecycle_audit --scope disagg
  python -m paddle_tpu_torch.analysis.lifecycle_audit --list
  python -m paddle_tpu_torch.analysis.lifecycle_audit --demo-regression
      # also explore the two injected-bug scopes (the gate must fail)
  python -m paddle_tpu_torch.analysis.lifecycle_audit --fuzz 200 --seed 7
  python -m paddle_tpu_torch.analysis.lifecycle_audit --dump-dir DIR
      # each counterexample as a stall-dump JSON file under DIR

Exit codes: 0 clean (no new findings), 2 new findings (or a demo bug
reproduced: the expected failure of the self-check), 3 bad invocation, a
broken baseline, or a demo scope that did NOT reproduce its injected bug
(the checker itself regressed).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lifecycle_baseline.json")


def _dump_finding(f, dump_dir: str, idx: int) -> str:
    """One counterexample in the JAX package's stall-dump format
    (``observability/stall.dump_stall``): the trace as the timeline tail,
    one entry an action, the end state as the scheduler snapshot."""
    detail = f.detail
    tail = [{"event": "action", "step": i, "action": a, "label": lbl}
            for i, (a, lbl) in enumerate(zip(detail.get("trace", ()),
                                             detail.get("labels", ())))]
    report = {"reason": f"lifecycle:{f.code}", "pid": os.getpid(),
              "time": time.time(),
              "iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
              "scheduler": detail.get("state", {}), "metrics": {},
              "timeline_tail": tail, "fingerprint": f.fingerprint,
              "message": f.message, "scope": detail.get("scope"),
              "injected_bug": detail.get("injected_bug")}
    path = os.path.join(dump_dir, f"lifecycle_ce_{idx}.json")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis.lifecycle_audit",
        description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default: the package's "
                         "lifecycle_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the diff: report findings, exit 2 on any")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze the current findings as the baseline and "
                         "exit 0")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full findings document to PATH")
    ap.add_argument("--scope", action="append", default=None,
                    help="explore only these scopes (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="print the scope names (catalog and demo) and "
                         "exit")
    ap.add_argument("--demo-regression", action="store_true",
                    help="also explore the two injected-bug demo scopes: "
                         "the gate must fail on each")
    ap.add_argument("--fuzz", type=int, metavar="N", default=0,
                    help="N deterministic random walks a scope instead of "
                         "the exhaustive BFS")
    ap.add_argument("--seed", type=int, default=0,
                    help="the fuzz seed (a failing trace replays byte for "
                         "byte from the same seed)")
    ap.add_argument("--max-states", type=int, default=None,
                    help="override every scope's explored-state cap")
    ap.add_argument("--max-depth", type=int, default=None,
                    help="override every scope's BFS depth cap")
    ap.add_argument("--dump-dir", metavar="DIR", default=None,
                    help="write each counterexample as a stall-dump JSON "
                         "file under DIR")
    ap.add_argument("--quiet", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 3

    from . import lifecycle as lc
    from .auditor import (diff_findings, findings_to_json, load_baseline,
                          write_baseline)

    if args.list:
        for name, sc in lc.SCOPES.items():
            print(f"{name}: {sc.note}")
        for name, sc in lc.DEMO_SCOPES.items():
            print(f"{name} [demo, bug={sc.bug}]: {sc.note}")
        return 0
    if args.write_baseline and args.demo_regression:
        print("[lifecycle] refusing --write-baseline with "
              "--demo-regression: the injected bugs must never become "
              "accepted findings", file=sys.stderr)
        return 3
    if args.write_baseline and args.scope and os.path.realpath(
            args.baseline) == os.path.realpath(DEFAULT_BASELINE):
        print("[lifecycle] refusing --write-baseline for a --scope "
              "subset over the package's baseline: explore the whole "
              "catalog, or point --baseline at another file",
              file=sys.stderr)
        return 3

    names = args.scope or list(lc.SCOPES)
    unknown = [n for n in names
               if n not in lc.SCOPES and n not in lc.DEMO_SCOPES]
    if unknown:
        print(f"[lifecycle] unknown scope(s): {', '.join(unknown)} "
              "(see --list)", file=sys.stderr)
        return 3
    scopes = [lc.SCOPES.get(n) or lc.DEMO_SCOPES[n] for n in names]
    if args.demo_regression:
        scopes += [sc for n, sc in lc.DEMO_SCOPES.items() if n not in names]

    say = (lambda *a: None) if args.quiet else print
    reports, results = [], []
    for sc in scopes:
        if args.fuzz > 0:
            res = lc.fuzz(sc, args.fuzz, seed=args.seed)
            say(f"[lifecycle] {sc.name}: {args.fuzz} walk(s), "
                f"{res.transitions} transitions, "
                f"{len(res.report.findings)} finding(s), "
                f"{res.wall_s:.1f}s")
        else:
            res = lc.explore(sc, max_states=args.max_states,
                             max_depth=args.max_depth)
            say(f"[lifecycle] {sc.name}: {res.states} states, "
                f"{res.transitions} transitions"
                f"{' (truncated)' if res.truncated else ''}, "
                f"{len(res.report.findings)} finding(s), "
                f"{res.wall_s:.1f}s")
        reports.append(res.report)
        results.append(res)
        for f in res.report.findings:
            say(f"  error   lifecycle/{f.code} @ {f.site}")
            say(f"          {f.message}")
            say(f"          trace ({len(f.detail['trace'])} actions): "
                f"{f.detail['labels']}")

    # the self-check: a demo scope that no longer reproduces its injected
    # bug means the CHECKER regressed, not the code under test
    if args.demo_regression:
        for res in results:
            bug = res.report.meta.get("injected_bug")
            if bug and not res.report.findings:
                print(f"[lifecycle] SELF-CHECK FAILED: demo scope "
                      f"{res.report.program} (bug={bug}) produced no "
                      "finding: the checker lost its teeth",
                      file=sys.stderr)
                return 3

    doc = findings_to_json(reports)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.dump_dir:
        os.makedirs(args.dump_dir, exist_ok=True)
        i = 0
        for r in reports:
            for f in r.findings:
                say(f"[lifecycle] counterexample dumped: "
                    f"{_dump_finding(f, args.dump_dir, i)}")
                i += 1

    if args.write_baseline:
        write_baseline(reports, args.baseline)
        say(f"[lifecycle] baseline written: {args.baseline} "
            f"({doc['summary']['findings']} accepted finding(s))")
        return 0
    if args.no_baseline:
        n = doc["summary"]["findings"]
        say(f"[lifecycle] {n} finding(s), no baseline diff")
        return 2 if n else 0
    try:
        baseline = load_baseline(args.baseline)
    except FileNotFoundError:
        say(f"[lifecycle] no baseline at {args.baseline}: every finding "
            "is new (write one with --write-baseline)")
        baseline = {"findings": {}}
    except ValueError as e:
        print(f"[lifecycle] BROKEN BASELINE: {e}", file=sys.stderr)
        return 3

    new, fixed = diff_findings(reports, baseline)
    for fp in fixed:
        say(f"[lifecycle] fixed against the baseline: {fp}")
    if new:
        print(f"[lifecycle] GATE FAILED: {len(new)} new finding(s) "
              f"against {args.baseline}:", file=sys.stderr)
        for f in new:
            print(f"  error   {f.fingerprint}\n"
                  f"          {f.message}\n"
                  f"          trace: {f.detail.get('trace')}",
                  file=sys.stderr)
        return 2
    say(f"[lifecycle] gate clean: {doc['summary']['findings']} "
        f"finding(s), all accepted by the baseline ({len(fixed)} fixed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
