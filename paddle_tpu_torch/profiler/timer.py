"""Throughput (ips) benchmark timer (port of ``paddle_tpu/profiler/timer.py``,
host code kept as it is).

reference: python/paddle/profiler/timer.py — `benchmark()` singleton with
step hooks, reader-cost/batch-cost moving averages, and ips. Driven by
Profiler.step(num_samples) or standalone via begin/step/end.
"""
from __future__ import annotations

import time
from typing import Optional


class _MovingAvg:
    """Windowed moving average (reference: timer.py TimeAverager)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.reset()

    def reset(self):
        from collections import deque
        self._records = deque(maxlen=self.window)

    def record(self, seconds: float, num_samples: int = 0):
        self._records.append((seconds, num_samples))

    def get_average(self) -> float:
        if not self._records:
            return 0.0
        return sum(s for s, _ in self._records) / len(self._records)

    def get_ips_average(self) -> float:
        total = sum(s for s, _ in self._records)
        if total <= 0:
            return 0.0
        return sum(n for _, n in self._records) / total


class Benchmark:
    def __init__(self):
        self.reset()

    def reset(self):
        self.batch_cost = _MovingAvg()
        self.reader_cost = _MovingAvg()
        self._last_step_t: Optional[float] = None
        self._reader_t: Optional[float] = None
        self.total_steps = 0
        self.running = False

    def begin(self):
        self.running = True
        self._last_step_t = time.perf_counter()

    def before_reader(self):
        self._reader_t = time.perf_counter()

    def after_reader(self):
        if self._reader_t is not None:
            self.reader_cost.record(time.perf_counter() - self._reader_t)
            self._reader_t = None

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self.batch_cost.record(now - self._last_step_t,
                                   num_samples or 0)
        self._last_step_t = now
        self.total_steps += 1

    def end(self):
        self.running = False

    def step_info(self, unit: str = "samples") -> str:
        ips = self.batch_cost.get_ips_average()
        return (f"avg_batch_cost: {self.batch_cost.get_average():.5f} s, "
                f"avg_reader_cost: {self.reader_cost.get_average():.5f} s, "
                f"ips: {ips:.2f} {unit}/s")


_BENCHMARK = Benchmark()


def benchmark() -> Benchmark:
    """reference: python/paddle/profiler/timer.py benchmark() singleton."""
    return _BENCHMARK
