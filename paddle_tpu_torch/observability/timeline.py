"""Per-request lifecycle timelines in a bounded ring buffer (port of
``paddle_tpu/observability/timeline.py``, host code kept as it is).

Every serving request walks the same life: submit -> queued -> admit ->
prefill chunk(s) -> first_token -> decode steps -> finish. Recording
those transitions (host timestamps only — never a device sync) into a
ring buffer gives three things the flat counters could not:

- TTFT / TPOT / queue-wait *distributions* per request,
- a chrome trace (one row per request, exported through the existing
  ``profiler/`` machinery) a human can scrub in Perfetto,
- a flight-recorder tail: when the engine stalls, the last N events
  ARE the diagnosis.

The buffer is bounded (``capacity`` events, drop-oldest) so an engine
serving millions of requests holds a constant footprint; ``dropped``
counts what rolled off.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["TimelineEvent", "Timeline"]

# canonical event taxonomy (DESIGN.md "observability" section); meta
# keys ride alongside, e.g. prefill_chunk carries pos0/n/bucket and
# train_step carries step/stage_ms/dispatch_ms/sync_ms
EVENT_NAMES = ("submit", "admit", "prefill_chunk", "first_token",
               "decode_step", "finish", "drain_truncated", "stall",
               "retrace", "prefix_evict",
               # training/multichip events
               "train_step", "compile", "host_gap", "collective",
               # fleet routing and telemetry alerts
               "route", "alert")


class TimelineEvent:
    __slots__ = ("t_ns", "name", "req_id", "dur_ms", "meta")

    def __init__(self, t_ns: int, name: str, req_id: Optional[int],
                 dur_ms: Optional[float], meta: Optional[Dict]):
        self.t_ns = t_ns
        self.name = name
        self.req_id = req_id
        self.dur_ms = dur_ms
        self.meta = meta

    def to_dict(self) -> Dict:
        d = {"t_ns": self.t_ns, "name": self.name}
        if self.req_id is not None:
            d["req_id"] = self.req_id
        if self.dur_ms is not None:
            d["dur_ms"] = round(self.dur_ms, 3)
        if self.meta:
            d.update(self.meta)
        return d


class Timeline:
    """Bounded ring of :class:`TimelineEvent` with chrome/JSONL export."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self.t0_ns = time.perf_counter_ns()

    def __len__(self):
        return len(self._ring)

    def record(self, name: str, req_id: Optional[int] = None,
               dur_ms: Optional[float] = None, t_ns: Optional[int] = None,
               **meta):
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(TimelineEvent(
            t_ns if t_ns is not None else time.perf_counter_ns(),
            name, req_id, dur_ms, meta or None))

    def events(self) -> List[TimelineEvent]:
        return list(self._ring)

    def tail(self, n: int = 256) -> List[Dict]:
        evs = list(self._ring)[-n:]
        return [e.to_dict() for e in evs]

    # -- chrome trace (through the profiler/ machinery) ----------------
    def to_host_events(self):
        """Render the ring as profiler ``HostEvent`` spans.

        Per request (one chrome row each, tid = req_id + 1):
        ``queued`` (submit -> admit), ``prefill`` (admit -> first
        token), ``decode`` (first token -> finish), plus each
        ``prefill_chunk`` with its measured duration. Scheduler-wide
        ``decode_step`` spans land on tid 0. Requests still in flight
        render the spans they have completed so far.
        """
        from ..profiler.record_event import HostEvent, TracerEventType

        per_req: Dict[int, Dict[str, TimelineEvent]] = {}
        host_events = []
        for ev in self._ring:
            if ev.req_id is not None and ev.name in (
                    "submit", "admit", "first_token", "finish"):
                per_req.setdefault(ev.req_id, {})[ev.name] = ev
            if ev.dur_ms is not None:
                tid = 0 if ev.req_id is None else ev.req_id + 1
                start = ev.t_ns - int(ev.dur_ms * 1e6)
                host_events.append(HostEvent(
                    ev.name, start, ev.t_ns,
                    TracerEventType.UserDefined, tid=tid))
        spans = (("queued", "submit", "admit"),
                 ("prefill", "admit", "first_token"),
                 ("decode", "first_token", "finish"))
        for rid, evs in per_req.items():
            for name, a, b in spans:
                if a in evs and b in evs:
                    host_events.append(HostEvent(
                        f"req{rid}:{name}", evs[a].t_ns, evs[b].t_ns,
                        TracerEventType.PythonUserDefined, tid=rid + 1))
        host_events.sort(key=lambda e: e.start_ns)
        return host_events

    def export_chrome(self, path: str, gauges: Optional[Dict] = None,
                      process_name: str = "paddle_tpu serving",
                      extra_host_events=None,
                      extra_events: Optional[List[Dict]] = None) -> str:
        """Write a chrome-trace json of the ring (plus gauge series as
        counter tracks, plus any pre-built ``extra_host_events`` spans —
        e.g. the flight recorder's per-rank collective tracks — plus
        raw ``extra_events`` chrome dicts, e.g. the per-kernel roofline
        annotation track) via the profiler's shared trace writer."""
        from ..profiler.profiler import write_chrome_trace

        extra = list(extra_events or ())
        for name, g in (gauges or {}).items():
            for t, v in g.series:
                if t is None:
                    continue
                # no explicit pid: the trace writer assigns the process
                # pid, keeping counters under the same Perfetto process
                # as the request rows
                extra.append({"name": name, "ph": "C",
                              "ts": t * 1e6,
                              "args": {"value": v}})
        host_events = self.to_host_events()
        if extra_host_events:
            host_events = sorted(host_events + list(extra_host_events),
                                 key=lambda e: e.start_ns)
        write_chrome_trace(path, host_events,
                           process_name=process_name, extra_events=extra)
        return path

    # -- JSONL ---------------------------------------------------------
    def write_jsonl(self, path: str, request_records=(),
                    header: Optional[Dict] = None) -> str:
        """Structured per-phase JSONL: one ``meta`` line, one ``event``
        line per ring entry, one ``request`` line per finished-request
        record — the raw material for ``tools/trace_summary.py`` and
        for BENCH captures that carry distributions."""
        with open(path, "w") as f:
            meta = {"kind": "meta", "schema": 1,
                    "t0_ns": self.t0_ns, "events": len(self._ring),
                    "dropped": self.dropped}
            if header:
                meta.update(header)
            f.write(json.dumps(meta) + "\n")
            for ev in self._ring:
                f.write(json.dumps({"kind": "event", **ev.to_dict()})
                        + "\n")
            for rec in request_records:
                f.write(json.dumps({"kind": "request", **rec}) + "\n")
        return path
