"""The gate's finding schema (port of ``paddle_tpu/analysis/rules.py``'s
``Finding``, field for field).

The JAX package's program rules walk jaxprs; the port has no jaxpr, and
their counterparts over fx or ``torch.export`` graphs are later work
(``ROADMAP.md`` A12). What the port shares with the JAX gates is the
record: the frozen export schema and the fingerprint the baseline diff of
:mod:`.auditor` keys on (``program::rule::code::site``), so message wording
can change without churning a baseline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

__all__ = ["Finding", "SEVERITIES"]

SEVERITIES = ("error", "warning", "info")


@dataclass
class Finding:
    """One audit finding. ``to_dict()`` is the FROZEN export schema:
    rule, code, severity, program, site, message, detail, fingerprint."""
    rule: str
    code: str
    severity: str
    program: str
    message: str
    site: str = ""
    detail: Dict = field(default_factory=dict)

    @property
    def fingerprint(self) -> str:
        return f"{self.program}::{self.rule}::{self.code}::{self.site}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "code": self.code,
                "severity": self.severity, "program": self.program,
                "site": self.site, "message": self.message,
                "detail": dict(self.detail),
                "fingerprint": self.fingerprint}
