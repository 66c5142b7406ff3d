"""Retrace watchdog: steady state is 1 decode program, <=1 per bucket
(port of ``paddle_tpu/observability/watchdog.py``, host code kept as it
is).

The port's engine counts in ``decode_traces``, ``prefill_traces`` and
``calibration_traces`` what the JAX engine's traces count: one build of
each program on the CPU, one CUDA-graph capture on the card (a program
is captured at its second use). A new capture after warm-up (a bucket
first seen, a key that changed the program) costs a capture and a
warm-up step on the card. The watchdog snapshots the trace counters once
warmup is declared and warns (``RuntimeWarning`` + a recorded event) the
moment any program traces again.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

__all__ = ["RetraceWatchdog"]


class RetraceWatchdog:
    """Compare-and-warn over the engine's trace counters.

    ``mark_warmup(counters)`` freezes the baseline; each ``check``
    diffs against it and warns once per *new* retrace (the baseline
    advances, so one storm does not emit per-step noise forever).
    """

    def __init__(self, warn: bool = True):
        self.warn = warn
        self._base: Optional[Dict] = None
        self.events: List[Dict] = []

    @staticmethod
    def _snap(counters: Dict) -> Dict:
        return {"decode": counters.get("decode_traces", 0),
                "calibration": counters.get("calibration_traces", 0),
                "prefill": dict(counters.get("prefill_traces", {}))}

    @property
    def armed(self) -> bool:
        return self._base is not None

    def mark_warmup(self, counters: Dict):
        """Declare warmup complete: any trace-count growth past this
        point is a steady-state retrace."""
        self._base = self._snap(counters)

    def check(self, counters: Dict) -> int:
        """Diff against the warmup baseline; returns the number of new
        retrace findings (0 when disarmed or clean)."""
        if self._base is None:
            return 0
        cur = self._snap(counters)
        findings = []
        if cur["decode"] > self._base["decode"]:
            findings.append(
                {"program": "decode",
                 "traces": cur["decode"] - self._base["decode"]})
        if cur["calibration"] > self._base["calibration"]:
            findings.append(
                {"program": "calibration",
                 "traces": cur["calibration"] - self._base["calibration"]})
        for bucket, n in cur["prefill"].items():
            base_n = self._base["prefill"].get(bucket, 0)
            if n > base_n:
                findings.append({"program": f"prefill[{bucket}]",
                                 "traces": n - base_n})
        if findings:
            self.events.extend(findings)
            self._base = cur       # warn once per retrace, not per step
            if self.warn:
                detail = ", ".join(f"{f['program']} +{f['traces']}"
                                   for f in findings)
                warnings.warn(
                    f"ServingEngine retrace after warmup: {detail} — "
                    "steady state should be 1 decode program and <=1 "
                    "trace per prefill bucket; a retrace storm here "
                    "silently eats the bench window", RuntimeWarning,
                    stacklevel=3)
        return len(findings)
