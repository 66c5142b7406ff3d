"""Continuous telemetry plane: time-series sampling over the
``metrics()`` protocol, OpenMetrics exposition, SLO burn-rate alerts
(port of ``paddle_tpu/observability/telemetry.py``, host code kept as it
is, the ``paddle_tpu`` namespace included, so that series names equal the
JAX engine's; one repair: an empty histogram's statistics are not
sampled, :func:`flatten_metrics`).

Every component in the stack (ServingEngine, DisaggregatedEngine,
ServingFleet, Trainer) exposes a pull-on-demand ``metrics()`` snapshot.
This module makes those snapshots *continuous*: a :class:`TelemetryPlane`
holds registered sources, samples them on a step cadence into bounded
in-memory time-series (flattened dotted paths, ``per_class``/
``per_replica`` sub-trees lifted into labels, counter→rate derivation),
and exports two ways —

* ``expose()`` renders a Prometheus/OpenMetrics text exposition
  (``# HELP``/``# TYPE`` per family, ``_total`` counters, sanitized
  names, ``# EOF`` terminator); ``lint_exposition`` checks any such
  text against the scrape grammar so a hostile metric key
  (``collective_psum@tp_ms``) can never silently ship unscrapeable.
* ``write_jsonl()`` / the incremental ``jsonl_path`` bank persist the
  sample log as rotated JSONL next to the existing timeline banks.

On top of the series sit two alerting layers, both evaluated at sample
time on the host (no device syncs, deterministic under an injected
``clock``):

* **multi-window SLO burn-rate** over the scheduler's new
  ``slo_seen``/``slo_attained`` counters — burn = windowed error rate /
  error budget; a *page* fires when BOTH the fast and slow windows
  exceed ``page_burn_rate`` (Google-SRE 14.4 default), a *ticket* at
  ``ticket_burn_rate``. Windows are counted in samples, not seconds,
  so tier-1 tests are exact.
* **robust anomaly detectors** (rolling median + MAD): p95 decode-step
  / TTFT drift, queue-depth growth, warm-hit-ratio collapse,
  preemption storms, tokens/s collapse. Each fire lands an ``alert``
  timeline event and (for pages) a flight-recorder dump via the
  component's ``on_alert`` callback.

The overhead contract is the harness's: a component built with
``telemetry=False`` never constructs a plane; an enabled plane touches
only host-side numbers already materialised by ``metrics()``.
"""
from __future__ import annotations

import io
import json
import math
import os
import re
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "TelemetryConfig", "TelemetryPlane", "TimeSeries",
    "flatten_metrics", "render_exposition", "lint_exposition",
    "DEFAULT_DETECTORS",
]

# ---------------------------------------------------------------------------
# flattening

# metric sub-trees whose keys are dynamic identities, not metric names:
# lift the key into a label so the series name stays a closed set
_LABEL_SUBTREES = {"per_class": "cls", "per_replica": "replica"}

# top-level keys never sampled: "telemetry" is the plane's own snapshot
# (sampling it would recurse), the rest are large static/structural
# blobs with their own dedicated readouts
_DEFAULT_SKIP = ("telemetry", "roofline", "roofline_replicas", "collectives")


def flatten_metrics(tree: Dict[str, Any], skip: Sequence[str] = ()
                    ) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
    """Flatten a ``metrics()`` dict into ``(path, labels, value)`` rows.

    Nested dicts join with ``.``; only finite int/float leaves survive
    (bools/strings/lists are identity, not measurement). ``per_class`` /
    ``per_replica`` sub-trees keep their path segment but move the child
    key into a ``cls`` / ``replica`` label. ``skip`` names top-level
    keys to drop (always includes the plane defaults). A histogram
    snapshot with no observation keeps only its ``count``: its mean and
    percentiles read 0.0 there, which is no measurement (the JAX plane
    samples them, and a TTFT p95 of 0.0 before the first request finishes
    makes the first real p95 a ``drift_up``).
    """
    drop = set(_DEFAULT_SKIP)
    drop.update(skip)
    out: List[Tuple[str, Tuple[Tuple[str, str], ...], float]] = []

    def walk(node, prefix, labels):
        if isinstance(node, dict):
            if node.get("count") == 0 and "unit" in node and "p50" in node:
                node = {"count": 0}      # an empty histogram's snapshot
            for k, v in node.items():
                k = str(k)
                if not prefix and k in drop:
                    continue
                path = prefix + "." + k if prefix else k
                if k in _LABEL_SUBTREES and isinstance(v, dict):
                    lname = _LABEL_SUBTREES[k]
                    for lval, sub in v.items():
                        walk(sub, path, labels + ((lname, str(lval)),))
                    continue
                walk(v, path, labels)
            return
        if isinstance(node, bool) or not isinstance(node, (int, float)):
            return
        v = float(node)
        if math.isfinite(v):
            out.append((prefix, labels, v))

    walk(tree, "", ())
    return out


# ---------------------------------------------------------------------------
# series

class TimeSeries:
    """One bounded series: ``(t, step, value)`` triples for a flattened
    metric path + label set. ``kind`` is ``"counter"`` (monotone source
    counter — gets a derived ``_per_s`` rate sibling and a ``_total``
    exposition suffix) or ``"gauge"``."""

    __slots__ = ("path", "labels", "kind", "samples")

    def __init__(self, path: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, capacity: int):
        self.path = path
        self.labels = labels
        self.kind = kind
        self.samples: Deque[Tuple[float, int, float]] = deque(maxlen=capacity)

    def add(self, t: float, step: int, value: float) -> None:
        self.samples.append((t, step, value))

    @property
    def last(self) -> Optional[Tuple[float, int, float]]:
        return self.samples[-1] if self.samples else None

    def values(self) -> List[float]:
        return [v for _, _, v in self.samples]


class _Source:
    __slots__ = ("name", "fn", "labels", "counter_names", "skip")

    def __init__(self, name, fn, labels, counter_names, skip):
        self.name = name
        self.fn = fn
        self.labels = labels
        self.counter_names = counter_names
        self.skip = skip


# ---------------------------------------------------------------------------
# config

# default anomaly detector specs; ``path`` matches the flattened series
# path exactly (rate series end in ``_per_s``)
DEFAULT_DETECTORS: Tuple[Dict[str, Any], ...] = (
    {"rule": "drift_up", "path": "latency.decode_step_ms.p95",
     "severity": "ticket"},
    {"rule": "drift_up", "path": "latency.ttft_ms.p95",
     "severity": "ticket"},
    {"rule": "growth", "path": "scheduler.queue_depth",
     "severity": "ticket"},
    {"rule": "collapse", "path": "routing.warm_hit_ratio",
     "severity": "ticket"},
    {"rule": "storm", "path": "preemptions_per_s", "severity": "page"},
    {"rule": "collapse", "path": "tokens_per_sec", "severity": "page"},
)


@dataclass
class TelemetryConfig:
    """Knobs for the telemetry plane. All windows count *samples* so
    behaviour is exact under a fake ``clock`` in tests."""

    sample_every: int = 8          # steps between samples
    series_capacity: int = 512     # points kept per series
    namespace: str = "paddle_tpu"  # exposition name prefix

    # --- SLO burn-rate alerting (over scheduler.slo_seen/slo_attained)
    slo_target: float = 0.99
    burn_fast_window: int = 8      # samples
    burn_slow_window: int = 64     # samples (clamped to history)
    page_burn_rate: float = 14.4
    ticket_burn_rate: float = 3.0

    # --- robust anomaly detection
    detectors: Optional[Tuple[Dict[str, Any], ...]] = None  # None → defaults
    anomaly_window: int = 32       # history points fed to median/MAD
    anomaly_min_samples: int = 12  # history required before judging
    anomaly_mad_k: float = 6.0     # drift threshold: med + k*MAD
    collapse_frac: float = 0.5     # collapse: cur < frac*median
    growth_min: float = 4.0        # growth: monotone rise >= this much
    storm_min: float = 1.0         # storm: absolute floor on the rate

    alert_cooldown: int = 8        # samples between re-fires per rule
    page_dumps: bool = True        # page alerts request a stall dump

    # --- export
    jsonl_path: Optional[str] = None   # incremental rotated bank
    jsonl_max_bytes: int = 4 << 20
    jsonl_backups: int = 2
    exposition_path: Optional[str] = None  # rewritten every sample

    # injectable monotonic clock (tests); None → time.perf_counter
    clock: Optional[Callable[[], float]] = None

    @staticmethod
    def coerce(value) -> Optional["TelemetryConfig"]:
        """Normalise a ``telemetry=`` kwarg: falsy → None (disabled),
        ``True`` → defaults, a config instance → itself."""
        if not value:
            return None
        if value is True:
            return TelemetryConfig()
        if isinstance(value, TelemetryConfig):
            return value
        raise TypeError("telemetry= expects bool or TelemetryConfig, got "
                        f"{type(value).__name__}")


# ---------------------------------------------------------------------------
# exposition

_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE_LINE_RE = re.compile(
    r"([^{\s]+)(\{[^}]*\})?\s+([0-9.eE+\-NnAaIiFf]+)\Z")


def _metric_name(namespace: str, path: str, kind: str) -> str:
    name = _SANITIZE_RE.sub("_", f"{namespace}_{path}" if namespace else path)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    if kind == "counter" and not name.endswith("_total"):
        name += "_total"
    return name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render_exposition(series: Sequence[TimeSeries],
                      namespace: str = "paddle_tpu") -> str:
    """Render the latest point of each series as Prometheus/OpenMetrics
    text. Series sharing a (sanitized) family name are grouped under one
    ``# HELP``/``# TYPE`` block; counters win the type vote if mixed."""
    fams: Dict[str, Dict[str, Any]] = {}
    for s in series:
        if not s.samples:
            continue
        name = _metric_name(namespace, s.path, s.kind)
        fam = fams.setdefault(name, {"type": "gauge", "help": s.path,
                                     "rows": []})
        if s.kind == "counter":
            fam["type"] = "counter"
        lbl = ""
        if s.labels:
            pairs = ",".join(f'{_SANITIZE_RE.sub("_", k)}="'
                             f'{_escape_label(str(v))}"'
                             for k, v in s.labels)
            lbl = "{" + pairs + "}"
        fam["rows"].append((lbl, s.samples[-1][2]))
    out = io.StringIO()
    for name in sorted(fams):
        fam = fams[name]
        out.write(f"# HELP {name} sampled from metrics() path "
                  f"{fam['help']}\n")
        out.write(f"# TYPE {name} {fam['type']}\n")
        for lbl, v in sorted(fam["rows"]):
            out.write(f"{name}{lbl} {_fmt_value(v)}\n")
    out.write("# EOF\n")
    return out.getvalue()


def lint_exposition(text: str) -> List[str]:
    """Validate exposition text against the scrape grammar. Returns a
    list of problems (empty == clean): bad metric/label names, samples
    without a preceding ``# TYPE``/``# HELP``, counter families missing
    the ``_total`` suffix, duplicate TYPE lines, missing ``# EOF``."""
    problems: List[str] = []
    lines = text.splitlines()
    if not lines or lines[-1].strip() != "# EOF":
        problems.append("missing # EOF terminator")
    typed: Dict[str, str] = {}
    helped: set = set()
    for ln, line in enumerate(lines, 1):
        if not line.strip():
            continue
        if line.strip() == "# EOF":
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                problems.append(f"line {ln}: HELP without text")
            else:
                helped.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                problems.append(f"line {ln}: malformed TYPE line")
                continue
            name, typ = parts[2], parts[3]
            if not _METRIC_NAME_RE.match(name):
                problems.append(f"line {ln}: invalid metric name {name!r}")
            if typ not in ("counter", "gauge", "histogram", "summary",
                           "untyped", "info"):
                problems.append(f"line {ln}: unknown type {typ!r}")
            if name in typed:
                problems.append(f"line {ln}: duplicate TYPE for {name}")
            if typ == "counter" and not name.endswith("_total"):
                problems.append(f"line {ln}: counter {name} lacks _total")
            typed[name] = typ
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_LINE_RE.match(line.strip())
        if m is None:
            problems.append(f"line {ln}: unparseable sample {line!r}")
            continue
        name, lbl, val = m.group(1), m.group(2), m.group(3)
        if not _METRIC_NAME_RE.match(name):
            problems.append(f"line {ln}: invalid metric name {name!r}")
        if name not in typed:
            problems.append(f"line {ln}: sample for {name} before TYPE")
        if name not in helped:
            problems.append(f"line {ln}: sample for {name} without HELP")
        if lbl:
            for pair in re.findall(r'([^{,=]+)="((?:[^"\\]|\\.)*)"',
                                   lbl):
                if not _LABEL_NAME_RE.match(pair[0]):
                    problems.append(
                        f"line {ln}: invalid label name {pair[0]!r}")
            if not re.match(r'\{([^{,=]+="(?:[^"\\]|\\.)*")'
                            r'(,[^{,=]+="(?:[^"\\]|\\.)*")*\}\Z', lbl):
                problems.append(f"line {ln}: malformed label set {lbl!r}")
        try:
            float(val)
        except ValueError:
            problems.append(f"line {ln}: non-numeric value {val!r}")
    return problems


# ---------------------------------------------------------------------------
# robust statistics

def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _mad(vals: Sequence[float], med: float) -> float:
    return _median([abs(v - med) for v in vals])


# ---------------------------------------------------------------------------
# the plane

class TelemetryPlane:
    """Samples registered ``metrics()`` sources into bounded series and
    evaluates burn-rate + anomaly rules on every sample. See module
    docstring for the full contract."""

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 on_alert: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.config = config or TelemetryConfig()
        cfg = self.config
        self._clock = cfg.clock or time.perf_counter
        self._sources: List[_Source] = []
        self._series: Dict[Tuple[str, Tuple], TimeSeries] = {}
        self._ticks = 0
        self._samples = 0
        self._sample_log: Deque[Dict[str, Any]] = deque(
            maxlen=max(cfg.series_capacity, 16))
        self.alerts: Deque[Dict[str, Any]] = deque(maxlen=256)
        self.alert_counts: Dict[str, int] = {"page": 0, "ticket": 0}
        self.rule_counts: Dict[str, int] = {}
        self._last_fire: Dict[Any, int] = {}
        self._on_alert = on_alert
        self._detectors = tuple(cfg.detectors if cfg.detectors is not None
                                else DEFAULT_DETECTORS)
        self._bank_fresh = True
        self._bank_dead = False

    # -- registration ------------------------------------------------------

    def register(self, name: str, metrics_fn: Callable[[], Dict[str, Any]],
                 labels: Optional[Dict[str, str]] = None,
                 counters: Optional[Dict[str, Any]] = None,
                 skip: Sequence[str] = ()) -> None:
        """Add a source. ``labels`` attach to every series it emits
        (after the implicit ``component`` label); ``counters`` names the
        component's monotone counter dict so its top-level paths get
        counter semantics (rates + ``_total``); ``skip`` drops extra
        top-level metric keys for this source."""
        base = (("component", name),) + tuple(
            sorted((labels or {}).items()))
        cnames = frozenset(str(k) for k in (counters or {}))
        self._sources.append(_Source(name, metrics_fn, base, cnames,
                                     tuple(skip)))

    # -- sampling ----------------------------------------------------------

    def on_step(self) -> None:
        """Per-step tick; samples every ``sample_every`` steps."""
        self._ticks += 1
        if self._ticks % self.config.sample_every == 0:
            self.sample()

    def sample(self) -> None:
        """Take one sample of every source now and run the alert rules."""
        cfg = self.config
        t = self._clock()
        self._samples += 1
        step = self._ticks
        values: Dict[str, float] = {}
        for src in self._sources:
            try:
                tree = src.fn()
            except Exception as e:  # a dying source must not kill the loop
                print(f"paddle_tpu telemetry: source {src.name!r} failed: "
                      f"{e}", file=sys.stderr)
                continue
            for path, extra, v in flatten_metrics(tree, skip=src.skip):
                self._record(src, path, src.labels + extra, v, t, step,
                             values)
        rec = {"kind": "sample", "i": self._samples, "step": step,
               "t": round(t, 6), "values": values}
        self._sample_log.append(rec)
        self._bank(rec)
        for alert in self._evaluate(t, step):
            self._fire(alert)
        if cfg.exposition_path:
            self.write_exposition()

    def _record(self, src, path, labels, v, t, step, values):
        cfg = self.config
        key = (path, labels)
        s = self._series.get(key)
        if s is None:
            kind = ("counter" if path.split(".", 1)[0] in src.counter_names
                    else "gauge")
            s = self._series[key] = TimeSeries(path, labels, kind,
                                               cfg.series_capacity)
        prev = s.last
        s.add(t, step, v)
        values[_series_id(path, labels)] = v
        if s.kind == "counter" and prev is not None:
            dt, dv = t - prev[0], v - prev[2]
            # negative delta == counter reset (reset_metrics): skip
            if dt > 0.0 and dv >= 0.0:
                rpath = path + "_per_s"
                rkey = (rpath, labels)
                rs = self._series.get(rkey)
                if rs is None:
                    rs = self._series[rkey] = TimeSeries(
                        rpath, labels, "gauge", cfg.series_capacity)
                rate = dv / dt
                rs.add(t, step, rate)
                values[_series_id(rpath, labels)] = rate

    # -- alert rules -------------------------------------------------------

    def _evaluate(self, t: float, step: int) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        cfg = self.config
        # 1) multi-window SLO burn rate, per label-set that carries the
        #    scheduler counters (the fleet sees one per replica)
        for (path, labels), seen in list(self._series.items()):
            if path != "scheduler.slo_seen":
                continue
            att = self._series.get(("scheduler.slo_attained", labels))
            if att is None:
                continue
            fast = self._burn_rate(seen, att, cfg.burn_fast_window)
            slow = self._burn_rate(seen, att, cfg.burn_slow_window)
            if fast is None or slow is None:
                continue
            sev = None
            if fast >= cfg.page_burn_rate and slow >= cfg.page_burn_rate:
                sev = "page"
            elif (fast >= cfg.ticket_burn_rate
                  and slow >= cfg.ticket_burn_rate):
                sev = "ticket"
            if sev is None:
                continue
            rid = ("slo_burn_rate", labels)
            if not self._cooldown_ok(rid):
                continue
            thr = (cfg.page_burn_rate if sev == "page"
                   else cfg.ticket_burn_rate)
            out.append({"rule": "slo_burn_rate", "severity": sev,
                        "metric": "scheduler.slo_burn_rate",
                        "labels": dict(labels),
                        "value": round(min(fast, slow), 4),
                        "fast": round(fast, 4), "slow": round(slow, 4),
                        "threshold": thr, "t": round(t, 6), "step": step,
                        "sample": self._samples})
        # 2) robust anomaly detectors
        for i, spec in enumerate(self._detectors):
            for (path, labels), s in list(self._series.items()):
                if path != spec["path"]:
                    continue
                hit = self._eval_detector(spec, s)
                if hit is None:
                    continue
                rid = (i, path, labels)
                if not self._cooldown_ok(rid):
                    continue
                value, threshold = hit
                out.append({"rule": spec["rule"],
                            "severity": spec.get("severity", "ticket"),
                            "metric": path, "labels": dict(labels),
                            "value": round(value, 4),
                            "threshold": round(threshold, 4),
                            "t": round(t, 6), "step": step,
                            "sample": self._samples})
        return out

    def _burn_rate(self, seen: TimeSeries, att: TimeSeries,
                   window: int) -> Optional[float]:
        ss, aa = list(seen.samples), list(att.samples)
        n = min(len(ss), len(aa))
        if n < 2:
            return None
        w = min(window, n - 1)
        s0, s1 = ss[n - 1 - w][2], ss[n - 1][2]
        a0, a1 = aa[n - 1 - w][2], aa[n - 1][2]
        dseen = s1 - s0
        if dseen <= 0:  # idle window or counter reset: nothing to judge
            return 0.0
        dbad = (s1 - a1) - (s0 - a0)
        if dbad < 0:
            return 0.0
        budget = max(1.0 - self.config.slo_target, 1e-9)
        return (dbad / dseen) / budget

    def _eval_detector(self, spec: Dict[str, Any], s: TimeSeries
                       ) -> Optional[Tuple[float, float]]:
        cfg = self.config
        vals = s.values()
        if len(vals) < 2:
            return None
        cur = vals[-1]
        hist = vals[:-1][-cfg.anomaly_window:]
        rule = spec["rule"]
        min_n = spec.get("min_samples", cfg.anomaly_min_samples)
        if rule == "drift_up":
            if len(hist) < min_n:
                return None
            med = _median(hist)
            # floor the spread so a dead-flat history doesn't page on
            # the first nanosecond of jitter
            floor = max(_mad(hist, med), 0.25 * abs(med), 1e-9)
            thr = med + spec.get("k", cfg.anomaly_mad_k) * floor
            return (cur, thr) if cur > thr else None
        if rule == "collapse":
            if len(hist) < min_n:
                return None
            med = _median(hist)
            frac = spec.get("frac", cfg.collapse_frac)
            if med > 1e-9 and cur < frac * med:
                return (cur, frac * med)
            return None
        if rule == "growth":
            need = max(min_n, 4)
            recent = vals[-need:]
            if len(recent) < need:
                return None
            rise = spec.get("min_rise", cfg.growth_min)
            if (all(b >= a for a, b in zip(recent, recent[1:]))
                    and recent[-1] - recent[0] >= rise):
                return (recent[-1], recent[0] + rise)
            return None
        if rule == "storm":
            if len(hist) < min_n:
                return None
            med = _median(hist)
            floor = max(_mad(hist, med), 0.25 * abs(med), 1e-9)
            thr = max(med + spec.get("k", cfg.anomaly_mad_k) * floor,
                      spec.get("min_abs", cfg.storm_min))
            return (cur, thr) if cur >= thr else None
        return None

    def _cooldown_ok(self, rule_id) -> bool:
        last = self._last_fire.get(rule_id)
        if (last is not None
                and self._samples - last < self.config.alert_cooldown):
            return False
        self._last_fire[rule_id] = self._samples
        return True

    def _fire(self, alert: Dict[str, Any]) -> None:
        self.alerts.append(alert)
        sev = alert.get("severity", "ticket")
        self.alert_counts[sev] = self.alert_counts.get(sev, 0) + 1
        rule = alert.get("rule", "?")
        self.rule_counts[rule] = self.rule_counts.get(rule, 0) + 1
        self._bank({"kind": "alert", **alert})
        if self._on_alert is not None:
            try:
                self._on_alert(alert)
            except Exception as e:
                print(f"paddle_tpu telemetry: on_alert failed: {e}",
                      file=sys.stderr)

    # -- export ------------------------------------------------------------

    def expose(self) -> str:
        """Return the current series as OpenMetrics text. Takes an
        initial sample if none has been taken yet."""
        if self._samples == 0:
            self.sample()
        return render_exposition(self._series.values(),
                                 namespace=self.config.namespace)

    def write_exposition(self, path: Optional[str] = None) -> Optional[str]:
        """Atomically write ``expose()`` to ``path`` (default: the
        configured ``exposition_path``). Never raises."""
        path = path or self.config.exposition_path
        if not path:
            return None
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(self.expose())
            os.replace(tmp, path)
            return path
        except OSError as e:
            print(f"paddle_tpu telemetry: exposition write failed: {e}",
                  file=sys.stderr)
            return None

    def write_jsonl(self, path: str) -> Optional[str]:
        """One-shot dump: meta line, the retained sample log, then every
        retained alert. Never raises."""
        try:
            with open(path, "w") as f:
                f.write(json.dumps(self._meta()) + "\n")
                for rec in self._sample_log:
                    f.write(json.dumps(rec) + "\n")
                for alert in self.alerts:
                    f.write(json.dumps({"kind": "alert", **alert}) + "\n")
            return path
        except OSError as e:
            print(f"paddle_tpu telemetry: jsonl write failed: {e}",
                  file=sys.stderr)
            return None

    def _meta(self) -> Dict[str, Any]:
        return {"kind": "telemetry_meta", "schema": 1,
                "namespace": self.config.namespace,
                "sample_every": self.config.sample_every,
                "samples": self._samples, "series": len(self._series),
                "sources": [s.name for s in self._sources]}

    def _bank(self, rec: Dict[str, Any]) -> None:
        """Append one record to the incremental JSONL bank, rotating at
        ``jsonl_max_bytes``. Never raises; a failing filesystem disables
        the bank for the rest of the run."""
        cfg = self.config
        if not cfg.jsonl_path or self._bank_dead:
            return
        path = cfg.jsonl_path
        try:
            if (not self._bank_fresh and os.path.exists(path)
                    and os.path.getsize(path) >= cfg.jsonl_max_bytes):
                self._rotate(path)
                self._bank_fresh = True
            if self._bank_fresh or not os.path.exists(path):
                with open(path, "w") as f:
                    f.write(json.dumps(self._meta()) + "\n")
                self._bank_fresh = False
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:
            self._bank_dead = True
            print(f"paddle_tpu telemetry: bank disabled ({e})",
                  file=sys.stderr)

    def _rotate(self, path: str) -> None:
        backups = max(self.config.jsonl_backups, 0)
        if backups == 0:
            os.remove(path)
            return
        for i in range(backups - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")

    # -- introspection -----------------------------------------------------

    def series(self) -> List[TimeSeries]:
        return list(self._series.values())

    def snapshot(self) -> Dict[str, Any]:
        """The frozen ``metrics()["telemetry"]`` sub-schema."""
        return {"samples": self._samples, "series": len(self._series),
                "alerts": {"page": self.alert_counts.get("page", 0),
                           "ticket": self.alert_counts.get("ticket", 0)},
                "rules": dict(sorted(self.rule_counts.items()))}


def _series_id(path: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return path
    return path + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
