"""Audit reports and the baseline diff (port of the report and baseline
half of ``paddle_tpu/analysis/auditor.py``).

``write_baseline`` freezes the current finding fingerprints;
``diff_findings`` splits a later run into (new, fixed). The gate
(``python -m paddle_tpu_torch.analysis.kernel_audit``) fails on NEW
findings only; a fixed finding shrinks the baseline on its next refresh.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .rules import Finding

__all__ = ["AuditReport", "findings_to_json", "write_baseline",
           "load_baseline", "diff_findings", "BASELINE_VERSION"]

BASELINE_VERSION = 1


@dataclass
class AuditReport:
    """Findings and provenance of one audited program (here: one kernel
    case of the catalog)."""
    program: str
    findings: List[Finding] = field(default_factory=list)
    rules_run: List[str] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"program": self.program,
                "findings": [f.to_dict() for f in self.findings],
                "rules_run": list(self.rules_run),
                "meta": dict(self.meta)}


def findings_to_json(reports: List[AuditReport]) -> Dict:
    """The CLI's JSON document: per-program reports and a summary."""
    n_by_sev: Dict[str, int] = {}
    for r in reports:
        for f in r.findings:
            n_by_sev[f.severity] = n_by_sev.get(f.severity, 0) + 1
    return {"version": BASELINE_VERSION,
            "programs": {r.program: r.to_dict() for r in reports},
            "summary": {"programs": len(reports),
                        "findings": sum(len(r.findings) for r in reports),
                        "by_severity": dict(sorted(n_by_sev.items()))}}


def _all_findings(reports: List[AuditReport]) -> List[Finding]:
    return [f for r in reports for f in r.findings]


def write_baseline(reports: List[AuditReport], path: str) -> Dict:
    """Freeze the current fingerprints as the accepted baseline."""
    doc = {"version": BASELINE_VERSION,
           "findings": {f.fingerprint: {
               "rule": f.rule, "code": f.code, "severity": f.severity,
               "program": f.program, "message": f.message}
               for f in _all_findings(reports)}}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc


def load_baseline(path: str) -> Dict:
    """A baseline document; raises ValueError when it is not one."""
    with open(path) as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"baseline {path}: not JSON ({e})") from None
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: version "
            f"{doc.get('version') if isinstance(doc, dict) else None!r} != "
            f"{BASELINE_VERSION}: regenerate with --write-baseline")
    if not isinstance(doc.get("findings"), dict):
        raise ValueError(f"baseline {path}: missing findings dict")
    return doc


def diff_findings(reports: List[AuditReport], baseline: Dict
                  ) -> Tuple[List[Finding], List[str]]:
    """(new findings not in the baseline, baseline fingerprints now
    fixed). The gate fails on ``new`` only."""
    current = _all_findings(reports)
    base = set(baseline.get("findings", {}))
    new = [f for f in current if f.fingerprint not in base]
    have = {f.fingerprint for f in current}
    fixed = sorted(fp for fp in base if fp not in have)
    return new, fixed
