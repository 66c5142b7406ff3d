"""paddle_tpu_torch.profiler — unified profiler (port of
``paddle_tpu/profiler/``; reference: python/paddle/profiler/). Host
tracer + ``torch.profiler`` CUDA device traces."""
from .profiler import (Profiler, ProfilerState, ProfilerTarget,
                       make_scheduler, export_chrome_tracing,
                       export_protobuf, write_chrome_trace)
from .record_event import (RecordEvent, TracerEventType, load_profiler_result,
                           get_host_tracer)
from .timer import benchmark, Benchmark
from .statistics import build_summary, event_type_summary

__all__ = [
    "Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
    "export_chrome_tracing", "export_protobuf", "write_chrome_trace",
    "RecordEvent",
    "TracerEventType", "load_profiler_result", "benchmark", "Benchmark",
    "SortedKeys", "SummaryView",
]


class SortedKeys:
    """reference: profiler/profiler_statistic.py SortedKeys — sort keys
    for summary tables."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView:
    """reference: profiler/profiler.py SummaryView — which table
    summary() renders."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8
