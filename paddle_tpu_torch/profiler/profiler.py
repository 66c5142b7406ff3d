"""Profiler front-end (port of ``paddle_tpu/profiler/profiler.py``).

The analog of the reference unified profiler
(python/paddle/profiler/profiler.py:358 — states at :89, scheduler-driven
start/stop at :592,641) over pluggable tracers. Host events come from the
in-process HostTracer (record_event.py); with the GPU target the device
side is ``torch.profiler`` with CPU and CUDA activities (CUPTI), started
and stopped where the JAX package starts and stops ``jax.profiler``, its
trace written as a Chrome trace into the trace directory at the end of
each recording cycle (``device_trace_path``). Host code otherwise as in
the JAX package.
"""
from __future__ import annotations

import json
import os
import socket
import time
from enum import IntEnum
from typing import Callable, Iterable, Optional, Union

from .record_event import (TracerEventType, get_host_tracer, RecordEvent,
                           HostEvent)

__all__ = ["ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "export_protobuf", "write_chrome_trace",
           "Profiler", "RecordEvent", "HostEvent"]


class ProfilerState(IntEnum):
    """reference: python/paddle/profiler/profiler.py:89 ProfilerState."""

    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(IntEnum):
    """reference: python/paddle/profiler/profiler.py ProfilerTarget
    (CPU/GPU/XPU/CUSTOM_DEVICE): the host and the CUDA card."""

    CPU = 0
    GPU = 1


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """Build a step-indexed state schedule.

    reference: python/paddle/profiler/profiler.py make_scheduler — cycles
    [closed, ready, record] with the final record step returning
    RECORD_AND_RETURN so the trace is flushed at cycle end.
    """
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("closed/ready must be >=0 and record >=1")
    span = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        cycle = step // span
        if repeat > 0 and cycle >= repeat:
            return ProfilerState.CLOSED
        pos = step % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == span - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None
                          ) -> Callable:
    """on_trace_ready callback writing chrome-trace json.

    reference: python/paddle/profiler/profiler.py export_chrome_tracing →
    chrometracing_logger.cc. Files land in ``dir_name`` as
    ``{worker}_time.json``.
    """
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof: "Profiler"):
        worker = worker_name or f"host_{socket.gethostname()}_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{worker}_{int(time.time() * 1000)}.json")
        prof._export_chrome(path)
        prof._last_export_path = path

    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """Parity alias: the device side's own trace is the Chrome trace
    ``torch.profiler`` writes into the trace directory; host events still
    export as chrome json."""
    return export_chrome_tracing(dir_name, worker_name)


def write_chrome_trace(path: str, events, *,
                       process_name: str = "paddle_tpu host",
                       extra_events=None):
    """Serialize HostEvents (+ optional pre-built chrome event dicts,
    e.g. counter tracks) as one chrome-trace json. Shared by the
    Profiler export and the serving observability timeline, so every
    trace this framework writes opens in the same Perfetto workflow."""
    pid = os.getpid()
    trace = [{
        "name": ev.name, "ph": "X", "cat": ev.event_type.name,
        "ts": ev.start_ns / 1000.0, "dur": ev.duration_ns / 1000.0,
        "pid": pid, "tid": ev.tid,
    } for ev in events]
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": process_name}}]
    for ev in extra_events or ():
        ev.setdefault("pid", pid)
        trace.append(ev)
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + trace,
                   "displayTimeUnit": "ms"}, f)


class Profiler:
    """reference: python/paddle/profiler/profiler.py:358 class Profiler.

    Usage::

        with profiler.Profiler(targets=[ProfilerTarget.CPU,
                                        ProfilerTarget.GPU],
                               scheduler=(2, 5),
                               on_trace_ready=export_chrome_tracing('./log')
                               ) as p:
            for batch in loader:
                train_step(batch)
                p.step()

    ``trace_dir``: where the GPU target's device trace goes (default
    ``./profiler_log``, the JAX package's trace directory).
    """

    def __init__(self,
                 *,
                 targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler: Union[Callable, tuple, None] = None,
                 on_trace_ready: Optional[Callable] = None,
                 record_shapes: bool = False,
                 profile_memory: bool = False,
                 timer_only: bool = False,
                 emit_nvtx: bool = False,
                 trace_dir: Optional[str] = None):
        self.targets = list(targets) if targets is not None else [
            ProfilerTarget.CPU]
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=1 if start > 0 else 0,
                record=end - start, repeat=1)
        else:
            self._scheduler = _default_state_scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._trace_dir: Optional[str] = trace_dir
        self._last_export_path: Optional[str] = None
        self._step_start_ns: Optional[int] = None
        self._device_tracing = False
        self._device_prof = None
        # the device trace of the last recording cycle (GPU target)
        self.device_trace_path: Optional[str] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._start_tracers()
        self._step_start_ns = time.perf_counter_ns()

    def stop(self):
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._end_cycle()
        self.current_state = ProfilerState.CLOSED

    def _end_cycle(self):
        """Stop tracers and flush the trace. Events stay in the host tracer
        (for summary()) until the next recording cycle clears them."""
        self._stop_tracers()
        if self.on_trace_ready and not self.timer_only:
            self.on_trace_ready(self)

    def step(self, num_samples: Optional[int] = None):
        """Advance the schedule one iteration; drives tracer start/stop at
        state transitions (reference: profiler.py:592,641)."""
        now = time.perf_counter_ns()
        if self._step_start_ns is not None and not self.timer_only:
            get_host_tracer().add_event(
                f"ProfileStep#{self.step_num}", self._step_start_ns, now,
                TracerEventType.ProfileStep)
        from .timer import benchmark
        benchmark().step(num_samples)
        prev = self.current_state
        self.step_num += 1
        nxt = self._scheduler(self.step_num)
        recording = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if prev in recording and (nxt not in recording
                                  or prev == ProfilerState.RECORD_AND_RETURN):
            self._end_cycle()
        if nxt in recording and (prev not in recording
                                 or prev == ProfilerState.RECORD_AND_RETURN):
            self._start_tracers()
        self.current_state = nxt
        self._step_start_ns = time.perf_counter_ns()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- tracers ------------------------------------------------------------
    def _start_tracers(self):
        if self.timer_only:
            return
        tracer = get_host_tracer()
        tracer.clear()
        tracer.start()
        if ProfilerTarget.GPU in self.targets:
            import torch
            self._trace_dir = self._trace_dir or os.path.join(
                os.getcwd(), "profiler_log")
            if not torch.cuda.is_available():
                # no card: the host events still record (the JAX
                # package's unsupported-backend case)
                self._device_tracing = False
                return
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            try:
                prof.__enter__()
            except RuntimeError:     # another profiler is already active
                self._device_tracing = False
                return
            self._device_prof = prof
            self._device_tracing = True

    def _stop_tracers(self):
        if self.timer_only:
            return
        get_host_tracer().stop()
        if self._device_tracing:
            import torch
            prof, self._device_prof = self._device_prof, None
            self._device_tracing = False
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(self._trace_dir, exist_ok=True)
            path = os.path.join(
                self._trace_dir,
                f"device_{os.getpid()}_{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(path)
            self.device_trace_path = path

    # -- export / summary ---------------------------------------------------
    def export(self, path: str, format: str = "json"):
        self._export_chrome(path)

    def _export_chrome(self, path: str):
        write_chrome_trace(path, get_host_tracer().events())

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms") -> str:
        """Operator summary table (reference: profiler_statistic.py)."""
        from .statistics import build_summary
        text = build_summary(get_host_tracer().events(), time_unit=time_unit)
        print(text)
        return text
