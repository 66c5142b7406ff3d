"""Summary tables over collected host events (port of
``paddle_tpu/profiler/statistics.py``, host code kept as it is).

reference: python/paddle/profiler/profiler_statistic.py (EventNode tree +
table summaries). Here events are flat; we aggregate per name and per
event type.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from .record_event import HostEvent, TracerEventType

_UNIT_DIV = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}


def aggregate(events: List[HostEvent]) -> Dict[str, dict]:
    stats: Dict[str, dict] = {}
    for ev in events:
        s = stats.setdefault(ev.name, {
            "calls": 0, "total_ns": 0, "max_ns": 0,
            "min_ns": None, "type": ev.event_type.name,
        })
        s["calls"] += 1
        d = ev.duration_ns
        s["total_ns"] += d
        s["max_ns"] = max(s["max_ns"], d)
        s["min_ns"] = d if s["min_ns"] is None else min(s["min_ns"], d)
    return stats


def build_summary(events: List[HostEvent], time_unit: str = "ms") -> str:
    div = _UNIT_DIV[time_unit]
    stats = aggregate(events)
    if not stats:
        return "(no profiler events recorded)"
    grand_total = sum(s["total_ns"] for s in stats.values()) or 1
    header = (f"{'Name':<40} {'Calls':>7} {'Total(' + time_unit + ')':>12} "
              f"{'Avg(' + time_unit + ')':>12} {'Max(' + time_unit + ')':>12} "
              f"{'Min(' + time_unit + ')':>12} {'Ratio(%)':>9}")
    lines = ["-" * len(header), header, "-" * len(header)]
    for name, s in sorted(stats.items(), key=lambda kv: -kv[1]["total_ns"]):
        lines.append(
            f"{name[:40]:<40} {s['calls']:>7} {s['total_ns'] / div:>12.4f} "
            f"{s['total_ns'] / s['calls'] / div:>12.4f} "
            f"{s['max_ns'] / div:>12.4f} {s['min_ns'] / div:>12.4f} "
            f"{100.0 * s['total_ns'] / grand_total:>9.2f}")
    lines.append("-" * len(header))
    return "\n".join(lines)


def event_type_summary(events: List[HostEvent], time_unit: str = "ms") -> str:
    div = _UNIT_DIV[time_unit]
    per_type = defaultdict(lambda: [0, 0])
    for ev in events:
        per_type[ev.event_type.name][0] += 1
        per_type[ev.event_type.name][1] += ev.duration_ns
    lines = [f"{'EventType':<24} {'Calls':>8} {'Total(' + time_unit + ')':>14}"]
    for t, (calls, total) in sorted(per_type.items(),
                                    key=lambda kv: -kv[1][1]):
        lines.append(f"{t:<24} {calls:>8} {total / div:>14.4f}")
    return "\n".join(lines)
