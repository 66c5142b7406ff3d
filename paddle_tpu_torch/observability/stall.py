"""Stall diagnostics: flight-recorder dumps for a starved scheduler (port
of ``paddle_tpu/observability/stall.py``, host code kept as it is).

When ``drain()`` starves (queued work that can never admit) or a step
blows its deadline, an exception string is not a diagnosis. Reusing
the pattern of ``distributed/flight_recorder.py``: dump the timeline
ring buffer tail plus a scheduler snapshot (queue depth, slot phases,
per-slot seq_len, free pages, prefix-cache state) as one JSON report —
to a file when a path is configured, to stderr otherwise.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

__all__ = ["dump_stall", "dump_path_for"]


def dump_path_for(base: Optional[str], n_files: int, max_dumps: int):
    """The shared dump-retention policy (``Observability.stall_dump``
    and ``FlightRecorder.dump`` — one implementation, so the layers
    cannot diverge): returns ``(path, suppressed)``. ``n_files`` is
    the number of files ALREADY WRITTEN for this ``base`` (the caller
    owns that count — per base path, surviving window resets, so a
    re-enabled recorder can never hand a new hang the first report's
    path to clobber).

    - no ``base`` configured: always stderr (path None), never capped —
      console diagnostics must not go dark on a long-flapping failure;
    - first file lands at ``base``, later ones at uniquely-suffixed
      ``root.N.ext`` so a second report never clobbers the first;
    - only written files count against ``max_dumps``; past the cap the
      report is suppressed (``suppressed=True``) instead of scribbling
      over history or filling the disk.
    """
    if not base:
        return None, False
    if n_files >= max_dumps:
        return None, True
    if n_files:
        # splitext, not rpartition: a dot in a parent directory must
        # not get the counter spliced into it
        root, ext = os.path.splitext(base)
        return f"{root}.{n_files}{ext}", False
    return base, False


def dump_stall(reason: str, scheduler: Dict, timeline_tail,
               metrics: Optional[Dict] = None,
               path: Optional[str] = None,
               extra: Optional[Dict] = None) -> str:
    """Write one stall report; returns the path written (or "" when the
    report went to stderr). Dumping must never raise into the engine —
    a failed write degrades to stderr. ``extra`` merges additional
    top-level fields (the flight recorder rides its ring entries and
    clock base through here so every dump shares ONE format)."""
    report = {
        "reason": reason,
        "pid": os.getpid(),
        "time": time.time(),
        "iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "scheduler": scheduler,
        "metrics": metrics or {},
        "timeline_tail": list(timeline_tail),
    }
    if extra:
        report.update(extra)
    text = json.dumps(report, indent=1, default=str)
    if path:
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
            return path
        except OSError as e:
            sys.stderr.write(f"[stall-dump] write to {path} failed "
                             f"({e}); falling back to stderr\n")
    sys.stderr.write(f"[stall-dump] {reason}\n{text}\n")
    return ""
