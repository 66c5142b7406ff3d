"""Host-side event tracing (port of
``paddle_tpu/profiler/record_event.py``, host code kept as it is).

The analog of the reference host tracer
(paddle/fluid/platform/profiler/host_tracer.cc + RecordEvent at
paddle/fluid/platform/profiler/event_tracing.h): a thread-aware in-process
event collector. Device-side tracing is ``torch.profiler`` with CUDA
activities (CUPTI) -- see profiler.py.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional


class TracerEventType(IntEnum):
    """reference: paddle/fluid/platform/profiler/trace_event.h TracerEventType."""

    Operator = 0
    Dataloader = 1
    ProfileStep = 2
    Forward = 3
    Backward = 4
    Optimization = 5
    Communication = 6
    PythonOp = 7
    PythonUserDefined = 8
    UserDefined = 9


@dataclass
class HostEvent:
    name: str
    start_ns: int
    end_ns: int
    event_type: TracerEventType = TracerEventType.UserDefined
    tid: int = 0
    pid: int = 0

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class HostTracer:
    """Collects HostEvents from all threads; thread-safe append."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[HostEvent] = []
        self.enabled = False

    def start(self):
        self.enabled = True

    def stop(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events = []

    def add_event(self, name: str, start_ns: int, end_ns: int,
                  event_type: TracerEventType = TracerEventType.UserDefined):
        if not self.enabled:
            return
        ev = HostEvent(name, start_ns, end_ns, event_type,
                       tid=threading.get_ident() & 0xFFFFFFFF)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[HostEvent]:
        with self._lock:
            return list(self._events)


# process-global host tracer (reference: singleton tracers registered with
# phi::Profiler in paddle/fluid/platform/profiler/profiler.cc)
_HOST_TRACER = HostTracer()


def get_host_tracer() -> HostTracer:
    return _HOST_TRACER


class RecordEvent:
    """User-facing instrumentation scope.

    reference: python/paddle/profiler/utils.py RecordEvent (wrapping the C++
    platform::RecordEvent). Usable as a context manager or via begin()/end().
    """

    def __init__(self, name: str,
                 event_type: TracerEventType = TracerEventType.PythonUserDefined):
        self.name = name
        self.event_type = event_type
        self._start_ns: Optional[int] = None

    def begin(self):
        self._start_ns = time.perf_counter_ns()

    def end(self):
        if self._start_ns is None:
            return
        _HOST_TRACER.add_event(self.name, self._start_ns,
                               time.perf_counter_ns(), self.event_type)
        self._start_ns = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def load_profiler_result(filename: str):
    """Load a chrome-trace json previously exported (parity helper;
    reference: python/paddle/profiler/profiler.py load_profiler_result)."""
    import json
    with open(filename) as f:
        return json.load(f)
