"""paddle_tpu_torch.observability — metrics, tracing and stall
diagnostics for the port's serving engines and trainer (port of
``paddle_tpu/observability/``).

One lightweight harness threaded through the serving engines (and usable
standalone around ``generate_paged``), through the ``Trainer`` and
through the collective flight recorder: a metrics registry (counters +
gauges + streaming histograms with p50/p95/p99 export), lifecycle
timelines in a bounded ring buffer (chrome-trace export through
``profiler/``), step telemetry (``compile.py``: kernel-build wall time,
new-signature counts, counted-FLOPs MFU, the step's memory breakdown,
host-vs-device gap detection), a retrace watchdog, flight-recorder stall
dumps, the per-launch roofline and the telemetry plane. Everything here
is host-side bookkeeping: recording an event is a timestamp + a deque
append, and **no code path issues a device sync** — the owning component
decides its sync points (the engine's one per-step d2h read of the
sampled tokens; the observed trainer's one per-step wait on the step's
end). When disabled the component holds no harness at all (``None``), so
the disabled hot loop allocates zero event objects.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional, Sequence

from .compile import (CompileWatcher, HostGapDetector, device_peak_flops,
                      device_peak_hbm_bw, live_hbm_bytes)
from .metrics import Gauge, Histogram, MetricsRegistry
from .roofline import (capture_kernel_costs, decode_roofline,
                       decode_step_bytes, kernel_cost,
                       roofline_chrome_events, roofline_point)
from .stall import dump_path_for, dump_stall
from .telemetry import (TelemetryConfig, TelemetryPlane, flatten_metrics,
                        lint_exposition, render_exposition)
from .timeline import Timeline, TimelineEvent
from .watchdog import RetraceWatchdog

__all__ = ["Observability", "MetricsRegistry", "Histogram", "Gauge",
           "Timeline", "TimelineEvent", "RetraceWatchdog", "dump_stall",
           "CompileWatcher", "HostGapDetector", "device_peak_flops",
           "device_peak_hbm_bw", "live_hbm_bytes", "kernel_cost",
           "roofline_point", "capture_kernel_costs", "decode_step_bytes",
           "decode_roofline", "roofline_chrome_events", "LATENCY_HISTOGRAMS",
           "TRAIN_HISTOGRAMS",
           "TelemetryConfig", "TelemetryPlane", "flatten_metrics",
           "render_exposition", "lint_exposition"]

# the latency histograms every engine window reports (schema-stable:
# tests freeze this set — extend deliberately, never ad hoc)
LATENCY_HISTOGRAMS = ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms",
                      "prefill_chunk_ms", "decode_step_ms", "step_ms")

# the per-step phase histograms every trainer window reports (same
# contract): stage = batch h2d staging, dispatch = the eager step's enqueue
# returning (host work while the card runs behind it), sync = the wait
# for the step's end, compile = the kernel builds of a new signature
TRAIN_HISTOGRAMS = ("step_ms", "stage_ms", "dispatch_ms", "sync_ms",
                    "compile_ms")


class Observability:
    """Per-component observability harness.

    Owns one :class:`MetricsRegistry`, one :class:`Timeline` ring, one
    :class:`RetraceWatchdog` and the stall-dump plumbing. The component
    holds either an instance (enabled) or ``None`` (disabled — zero
    overhead, no event objects ever allocated). ``histograms`` selects
    the pre-created latency set: :data:`LATENCY_HISTOGRAMS` (serving,
    default) or :data:`TRAIN_HISTOGRAMS` (trainer).
    """

    def __init__(self, ring_capacity: int = 4096,
                 gauge_window: int = 512,
                 step_deadline_s: Optional[float] = None,
                 stall_dump_path: Optional[str] = None,
                 warn_on_retrace: bool = True,
                 max_request_records: int = 2048,
                 max_stall_dumps: int = 8,
                 histograms: Sequence[str] = LATENCY_HISTOGRAMS):
        self.registry = MetricsRegistry()
        self.timeline = Timeline(ring_capacity)
        self.watchdog = RetraceWatchdog(warn=warn_on_retrace)
        self.gauge_window = int(gauge_window)
        self.step_deadline_s = step_deadline_s
        self.stall_dump_path = stall_dump_path
        self.max_stall_dumps = int(max_stall_dumps)
        # bounded log of (reason, path): with a path configured only
        # written files land here (<= max_stall_dumps); the stderr
        # route is uncapped by design, so the deque bounds a flapping
        # trigger's memory
        self.stall_dumps: deque = deque(
            maxlen=max(64, self.max_stall_dumps))
        self.stall_dumps_suppressed = 0
        self.request_records: deque = deque(maxlen=max_request_records)
        self._flight = None            # bound FlightRecorder, if any
        self._hist_names = tuple(histograms)
        for name in self._hist_names:
            self.registry.histogram(name, unit="ms")

    # -- recording shortcuts ------------------------------------------
    def hist(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    def ensure_histograms(self, names: Sequence[str]):
        """Extend the reported latency set (e.g. an engine feature —
        the KV offload tier's spill_ms/restore_ms — adds its own
        distributions): the names join ``latency_snapshot()``'s output
        and survive ``reset_window()`` like the built-in set."""
        for name in names:
            if name not in self._hist_names:
                self._hist_names += (name,)
            self.registry.histogram(name, unit="ms")

    def sample_gauges(self, t: float, values: Dict[str, float]):
        for name, v in values.items():
            self.registry.gauge(name, self.gauge_window).set(v, t)

    def observe_request(self, record: Dict, stale: bool = False):
        """One finished request: feed the latency histograms and keep
        the record for JSONL export. ``queue_wait_ms`` is observed at
        admission (not here) so requests parked in the queue still
        count the moment they admit. ``stale=True`` (the request was
        submitted before the last window reset, so its latencies span
        the warmup) keeps the record but skips the histograms —
        matching the ttft_ms_mean/max warmup exclusion."""
        if not stale:
            for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
                v = record.get(key)
                if v is not None:
                    self.hist(key).observe(v)
        else:
            record = dict(record, warmup=True)
        self.request_records.append(record)

    # -- flight recorder binding --------------------------------------
    def bind_flight_recorder(self, recorder):
        """Unify a collective :class:`FlightRecorder` with this
        harness: completed collectives feed per-(op, axis) latency
        histograms + bytes-moved counters into this registry, hang
        dumps share the stall-dump retention policy, and chrome-trace
        export gains the recorder's per-rank collective tracks."""
        recorder.bind(registry=self.registry, clock=self.now)
        self._flight = recorder
        return recorder

    # -- stall diagnostics --------------------------------------------
    def stall_dump(self, reason: str, scheduler: Dict,
                   metrics: Optional[Dict] = None) -> str:
        path, suppressed = dump_path_for(
            self.stall_dump_path,
            sum(1 for _, p in self.stall_dumps if p),
            self.max_stall_dumps)
        if suppressed:
            # file-retention bound hit: count, don't append — a
            # flapping trigger past the cap must not grow the log
            # without bound (stderr-routed dumps are never capped —
            # dump_path_for)
            self.stall_dumps_suppressed += 1
            self.timeline.record("stall", reason=reason, suppressed=True)
            return ""
        self.timeline.record("stall", reason=reason)
        written = dump_stall(reason, scheduler, self.timeline.tail(),
                             metrics=metrics, path=path)
        self.stall_dumps.append((reason, written))
        return written

    # -- reporting ----------------------------------------------------
    def reset_window(self):
        """Restart the distribution window (after compile warmup):
        histograms and per-request records clear, the timeline ring and
        gauge series keep rolling (history is cheap and useful)."""
        self.registry.reset_histograms()
        self.request_records.clear()

    def latency_snapshot(self, names: Optional[Sequence[str]] = None
                         ) -> Dict:
        names = self._hist_names if names is None else names
        return {name: self.registry.histogram(name).snapshot()
                for name in names}

    def gauges_snapshot(self) -> Dict:
        return {name: g.snapshot()
                for name, g in sorted(self.registry.gauges.items())}

    def export_chrome(self, path: str,
                      process_name: str = "paddle_tpu serving",
                      extra_events=None) -> str:
        extra = None
        if self._flight is not None:
            extra = self._flight.to_host_events()
        return self.timeline.export_chrome(
            path, gauges=self.registry.gauges,
            process_name=process_name, extra_host_events=extra,
            extra_events=extra_events)

    def write_jsonl(self, path: str, header: Optional[Dict] = None
                    ) -> str:
        return self.timeline.write_jsonl(
            path, request_records=list(self.request_records),
            header=header)

    @staticmethod
    def now() -> float:
        return time.perf_counter()
