"""Metrics primitives of the serving engines and the trainer (port of
``paddle_tpu/observability/metrics.py``, host code kept as it is).

A bench window must bank *distributions*, not a flat dict of counters
plus a mean TTFT. This module is the bounded-memory substrate:

- ``Counter`` semantics stay plain dict entries (the engine's hot loop
  increments them at dict speed; a method call there would be pure
  overhead) — the ``MetricsRegistry`` *adopts* the dict and owns its
  export.
- ``Histogram`` is a streaming log-bucketed histogram: O(1) observe,
  O(#buckets) percentile, memory bounded by the dynamic range (~9%
  relative resolution at the default growth). p50 <= p95 <= p99 holds
  by construction because percentiles walk the same bucket array.
- ``Gauge`` keeps the last value plus a bounded time series window so
  allocator pressure / cache effectiveness are visible *over time*
  (and exportable as chrome-trace counter tracks), not just at exit.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

__all__ = ["Histogram", "Gauge", "MetricsRegistry"]


class Histogram:
    """Streaming log-bucketed histogram with percentile export.

    Buckets grow geometrically by ``growth`` per index (default
    2**0.125, ~9% relative width), so a value ``v`` lands in bucket
    ``floor(log(v)/log(growth))`` and percentile queries are exact to
    one bucket width. Non-positive values collapse into a dedicated
    zero bucket. Memory is O(distinct buckets), bounded by the dynamic
    range of the data — never by the observation count.
    """

    __slots__ = ("unit", "_log_g", "_growth", "_buckets", "_zeros",
                 "count", "total", "min", "max")

    def __init__(self, unit: str = "ms", growth: float = 2.0 ** 0.125):
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.unit = unit
        self._growth = growth
        self._log_g = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self._zeros = 0
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float):
        value = float(value)
        self.count += 1
        self.total += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        if value <= 0.0:
            self._zeros += 1
            return
        idx = int(math.floor(math.log(value) / self._log_g))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (bucket geometric midpoint;
        exact min/max returned at the extremes)."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return float(self.min)
        if q >= 1.0:
            return float(self.max)
        rank = max(1, int(math.ceil(q * self.count)))
        seen = self._zeros
        if rank <= seen:
            return 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank <= seen:
                # geometric midpoint of [growth^idx, growth^(idx+1)),
                # clamped to the observed range so p99 <= max always
                mid = self._growth ** (idx + 0.5)
                return float(min(max(mid, self.min), self.max))
        return float(self.max)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict:
        r = lambda v: round(float(v), 3)  # noqa: E731
        return {"count": self.count, "unit": self.unit,
                "mean": r(self.mean),
                "min": r(self.min) if self.count else 0.0,
                "max": r(self.max) if self.count else 0.0,
                "p50": r(self.percentile(0.50)),
                "p95": r(self.percentile(0.95)),
                "p99": r(self.percentile(0.99))}


class Gauge:
    """Last-value gauge with a bounded (t, value) series window."""

    __slots__ = ("value", "series")

    def __init__(self, window: int = 512):
        self.value: Optional[float] = None
        self.series: deque = deque(maxlen=window)

    def set(self, value: float, t: Optional[float] = None):
        self.value = value
        self.series.append((t, value))

    def snapshot(self) -> Dict:
        if not self.series:
            return {"last": None, "min": None, "max": None, "mean": None}
        vals = [v for _, v in self.series]
        return {"last": self.value,
                "min": min(vals), "max": max(vals),
                "mean": round(sum(vals) / len(vals), 3)}


class MetricsRegistry:
    """One owner for a component's counters, gauges and histograms.

    Counters are adopted as a plain dict (``adopt_counters``) so hot
    loops keep dict-speed increments; the registry's job is the *export*:
    ``snapshot()`` renders everything as plain JSON-ready data.
    """

    def __init__(self):
        self.counters: Dict = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def adopt_counters(self, counters: Dict) -> Dict:
        """Register an existing counter dict as this registry's counter
        store (shared by reference — increments stay visible here)."""
        self.counters = counters
        return counters

    def gauge(self, name: str, window: int = 512) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(window)
        return g

    def histogram(self, name: str, unit: str = "ms") -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(unit)
        return h

    def reset_histograms(self):
        """Restart the distribution window (e.g. after compile warmup)
        keeping the histogram identities."""
        for name, h in list(self.histograms.items()):
            self.histograms[name] = Histogram(h.unit, h._growth)

    def snapshot(self) -> Dict:
        return {
            "counters": {k: (dict(v) if isinstance(v, dict) else v)
                         for k, v in self.counters.items()},
            "gauges": {k: g.snapshot() for k, g in self.gauges.items()},
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
        }
