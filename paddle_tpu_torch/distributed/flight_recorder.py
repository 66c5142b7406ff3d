"""Collective flight recorder + hang watchdog (port of
``paddle_tpu/distributed/flight_recorder.py``, host code kept as it is).

The analog of the reference NCCL flight recorder
(paddle/phi/core/distributed/comm_task_manager.cc + nccl_comm_task.cc):
records every collective with a sequence number, op name, group axis and
tensor shape in a bounded ring buffer; a watchdog thread dumps
still-pending entries when one exceeds the timeout — the classic tool for
diagnosing desynced ranks (rank A entered allreduce #1234, rank B never
did).

The port's serving engine replays its mesh's declared per-step
collective inventory (``ServingMesh.collective_inventory``) around each
dispatched step, so "pending" means the step has not reached its host
sync. Dtypes are named as in the JAX package ("bfloat16", "float32") and
priced through ``torch``'s item sizes.

Unified with ``paddle_tpu_torch.observability``:

- timestamps come from the shared monotonic clock
  (``Observability.now`` = ``time.perf_counter``), so collective spans
  line up with timeline events and durations survive wall-clock
  adjustment; dumps carry a wall/monotonic base pair so absolute times
  are recoverable;
- completed collectives feed per-(op, axis) latency histograms and
  bytes-moved counters into a bound :class:`MetricsRegistry`;
- hang dumps go through the same bounded ``dump_stall`` format (and
  retention policy: uniquely-suffixed files, capped count) as
  ``observability/stall.py``;
- ``to_host_events()`` renders the ring as per-rank chrome-trace
  collective tracks for ``Observability.export_chrome``.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, asdict
from typing import Optional

from ..observability.stall import dump_path_for, dump_stall


def _now() -> float:
    """The shared monotonic clock (== ``Observability.now()``)."""
    return time.perf_counter()


@dataclass
class CommTask:
    seq: int
    op: str
    axis: Optional[str]
    shape: tuple
    dtype: str
    start_ts: float                  # monotonic (Observability.now)
    end_ts: Optional[float] = None   # monotonic

    @property
    def pending(self) -> bool:
        return self.end_ts is None

    @property
    def duration(self) -> Optional[float]:
        return None if self.end_ts is None else self.end_ts - self.start_ts

    @property
    def nbytes(self) -> Optional[int]:
        import torch
        dt = getattr(torch, self.dtype.replace("torch.", ""), None)
        if not isinstance(dt, torch.dtype):
            return None              # exotic dtype string
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * dt.itemsize


class FlightRecorder:
    def __init__(self, capacity: int = 1024,
                 timeout: float = 600.0,
                 dump_path: Optional[str] = None,
                 max_dumps: int = 8):
        self.capacity = capacity
        self.timeout = timeout
        self.dump_path = dump_path
        self.max_dumps = int(max_dumps)
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # serializes whole dumps (watchdog thread vs a main-thread
        # manual dump): concurrent path selection off the same dumps
        # snapshot would hand both writers the SAME file
        self._dump_lock = threading.Lock()
        self._seq = 0
        self.enabled = False
        self._watchdog: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._reported_seqs: set = set()
        # bounded window log of (reason, path) — the stderr route is
        # uncapped by design, so the deque bounds a flapping hang's
        # memory
        self.dumps: deque = deque(maxlen=max(64, self.max_dumps))
        self.dumps_suppressed = 0
        # files written PER base path; survives reset()/re-enable so a
        # later window can never reuse (and clobber) an earlier file
        self._dump_counts: dict = {}
        self._registry = None        # bound MetricsRegistry (optional)
        self._clock = _now
        self._mark_clock_base()

    def _mark_clock_base(self):
        # wall/monotonic pair captured together: absolute time of any
        # monotonic stamp t is wall_base + (t - monotonic_base)
        self._clock_base = {"wall": time.time(),
                            "monotonic": self._clock()}

    # -- configuration ------------------------------------------------------
    def configure(self, timeout: Optional[float] = None,
                  dump_path: Optional[str] = None,
                  capacity: Optional[int] = None,
                  max_dumps: Optional[int] = None) -> "FlightRecorder":
        """Update recorder knobs in place. A capacity change rebuilds
        the ring keeping the most recent entries (pending tasks keep
        their identity — ``end()`` mutates the task object, not the
        ring)."""
        if timeout is not None:
            self.timeout = timeout
        if dump_path is not None:
            self.dump_path = dump_path
        if max_dumps is not None:
            self.max_dumps = int(max_dumps)
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                self._ring = deque(self._ring, maxlen=capacity)
                self.capacity = capacity
        return self

    def reset(self, keep_pending: bool = True) -> "FlightRecorder":
        """Restart the recording window: completed history and reported
        hang seqs clear; in-flight tasks survive by default (their
        ``end()`` must still land, and the watchdog must still be able
        to catch them hanging). The window's dump log clears, but the
        per-path file counts (``_dump_counts``) survive — retention is
        about files on disk, and forgetting written dumps would hand
        the next hang the FIRST report's path to clobber."""
        with self._lock:
            pending = [t for t in self._ring if t.pending] \
                if keep_pending else []
            self._ring = deque(pending, maxlen=self.capacity)
            self._reported_seqs.clear()
        self.dumps = deque(maxlen=max(64, self.max_dumps))
        self.dumps_suppressed = 0
        self._mark_clock_base()
        return self

    def bind(self, registry=None, clock=None) -> "FlightRecorder":
        """Attach a :class:`MetricsRegistry` (per-(op, axis) latency
        histograms + bytes-moved counters) and/or the shared clock."""
        if registry is not None:
            self._registry = registry
        if clock is not None:
            self._clock = clock
            self._mark_clock_base()
        return self

    # -- recording ----------------------------------------------------------
    def begin(self, op: str, axis, shape, dtype) -> Optional[CommTask]:
        if not self.enabled:
            return None
        with self._lock:
            self._seq += 1
            task = CommTask(self._seq, op, axis, tuple(shape), str(dtype),
                            self._clock())
            self._ring.append(task)
        return task

    def end(self, task: Optional[CommTask]):
        if task is None:
            return
        task.end_ts = self._clock()
        reg = self._registry
        if reg is not None:
            key = f"{task.op}@{task.axis or 'world'}"
            reg.histogram(f"collective_{key}_ms").observe(
                (task.end_ts - task.start_ts) * 1e3)
            calls = reg.counters.setdefault("collective_calls", {})
            calls[key] = calls.get(key, 0) + 1
            nbytes = task.nbytes
            if nbytes is not None:
                moved = reg.counters.setdefault("collective_bytes", {})
                moved[key] = moved.get(key, 0) + nbytes

    # -- watchdog -----------------------------------------------------------
    def start_watchdog(self):
        if self._watchdog is not None:
            return
        self._stop_evt.clear()
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()

    def stop_watchdog(self):
        self._stop_evt.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            self._watchdog = None

    def check_once(self) -> int:
        """One watchdog pass (the thread calls this on its interval;
        tests call it directly for determinism): dump whenever a NEW
        collective is stuck past the timeout. Returns the number of
        newly-reported hung tasks."""
        now = self._clock()
        with self._lock:
            stuck = [t for t in self._ring
                     if t.pending and now - t.start_ts > self.timeout]
        # an early slow-but-completing op must not suppress the report
        # for a later hang
        fresh = [t for t in stuck if t.seq not in self._reported_seqs]
        if fresh:
            self.dump(reason=f"collective pending > {self.timeout}s")
            self._reported_seqs.update(t.seq for t in stuck)
        return len(fresh)

    def _watch(self):
        while not self._stop_evt.wait(min(self.timeout / 4, 5.0)):
            self.check_once()

    # -- dump ---------------------------------------------------------------
    def dump(self, reason: str = "manual") -> str:
        """Write one hang report in the shared stall-dump format.

        Retention is ``Observability.stall_dump``'s, via the shared
        ``dump_path_for``: first dump at ``dump_path``, later ones at
        uniquely-suffixed ``base.N.ext`` paths, at most ``max_dumps``
        files (then counted in ``dumps_suppressed``, not written);
        with no ``dump_path`` every report goes to stderr, uncapped —
        a flapping hang can't scribble over the first report or fill
        the disk, and console diagnostics never go dark. Returns the
        path written ("" when the report went to stderr or was
        suppressed)."""
        with self._lock:
            entries = [asdict(t) for t in self._ring]
            pending = [asdict(t) for t in self._ring if t.pending]
        with self._dump_lock:
            base = self.dump_path
            path, suppressed = dump_path_for(
                base, self._dump_counts.get(base, 0), self.max_dumps)
            if suppressed:
                # count, don't append: past the cap a flapping hang
                # must not grow the log without bound
                self.dumps_suppressed += 1
                return ""
            rank = os.environ.get("PADDLE_TRAINER_ID", "0")
            written = dump_stall(
                reason,
                scheduler={"rank": rank, "recorded": len(entries),
                           "pending": len(pending),
                           "capacity": self.capacity,
                           "timeout_s": self.timeout},
                timeline_tail=pending,
                path=path,
                extra={"entries": entries, "rank": rank,
                       "clock": dict(self._clock_base,
                                     monotonic_at_dump=self._clock())})
            if written:
                self._dump_counts[base] = \
                    self._dump_counts.get(base, 0) + 1
            self.dumps.append((reason, written))
            return written

    def tasks(self):
        with self._lock:
            return list(self._ring)

    # -- chrome trace -------------------------------------------------------
    def to_host_events(self):
        """Render completed collectives as profiler ``HostEvent`` spans
        on a per-rank track (tid = 1000 + rank), in the same monotonic
        nanosecond domain as the observability timeline — merged in by
        ``Observability.export_chrome``."""
        from ..profiler.record_event import HostEvent, TracerEventType

        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
        tid = 1000 + rank
        events = []
        for t in self.tasks():
            if t.end_ts is None:
                continue
            events.append(HostEvent(
                f"{t.op}@{t.axis or 'world'}",
                int(t.start_ts * 1e9), int(t.end_ts * 1e9),
                TracerEventType.Communication, tid=tid))
        return events


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def enable_flight_recorder(timeout: float = 600.0,
                           dump_path: Optional[str] = None,
                           capacity: int = 1024,
                           max_dumps: int = 8):
    """Turn on collective recording + the hang watchdog.

    reference: FLAGS_enable_async_trace / comm_task_manager enablement.
    Routed through :meth:`FlightRecorder.configure` +
    :meth:`FlightRecorder.reset`: re-enabling restarts the window but
    keeps in-flight tasks (their ``end()`` still lands; a hang that
    straddles the re-enable is still caught).
    """
    _RECORDER.configure(timeout=timeout, capacity=capacity,
                        max_dumps=max_dumps)
    # assigned directly, NOT via configure (which skips None): enabling
    # with the default must clear a previous caller's stale dump_path,
    # or their (possibly deleted) file silently swallows hang reports
    _RECORDER.dump_path = dump_path
    _RECORDER.reset(keep_pending=True)
    _RECORDER.enabled = True
    _RECORDER.start_watchdog()
    return _RECORDER


def disable_flight_recorder():
    _RECORDER.enabled = False
    _RECORDER.stop_watchdog()
