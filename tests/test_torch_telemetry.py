"""The port's telemetry plane (``paddle_tpu_torch/observability/
telemetry.py``) against the JAX package's on the CPU: the same metric
sources, sample sequences and fake clock go to both planes, and the
flattened rows, the series, the counter rates, the OpenMetrics exposition
text, ``lint_exposition``'s findings, the alert records, the snapshot and
the JSONL bank must be equal, exactly (host arithmetic on the same
floats: tolerance 0). Then the planes on the engines and the trainer:
the same exposition families and a clean stream silent on both."""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.observability as jobs
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.inference import GenerationConfig, ServingEngine
from paddle_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port

PKGS = {"jax": jobs, "port": tobs}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _plane(pkg, clock, **kw):
    kw.setdefault("sample_every", 1)
    kw.setdefault("detectors", ())
    kw.setdefault("clock", clock)
    alerts = []
    plane = pkg.TelemetryPlane(pkg.TelemetryConfig(**kw),
                               on_alert=alerts.append)
    return plane, alerts


def _copy(src):
    return json.loads(json.dumps(src))


# -- scenarios: each drives one plane of package ``pkg`` and returns what
# it observed (tests/test_telemetry.py's scenarios) ----------------------

def _rates(pkg, tmp_path):
    clk = _FakeClock()
    plane, alerts = _plane(pkg, clk)
    src = {"tokens": 0, "depth": 5}
    plane.register("eng", lambda: dict(src), counters={"tokens": 0})
    for dt, tok in ((0.0, 0), (1.0, 10), (1.0, 30), (2.0, 30), (1.0, 0)):
        clk.t += dt
        src["tokens"] = tok
        plane.sample()
    return plane, alerts


def _cadence(pkg, tmp_path):
    clk = _FakeClock()
    plane, alerts = _plane(pkg, clk, sample_every=4)
    plane.register("x", lambda: {"v": 1})
    for _ in range(9):
        clk.t += 1.0
        plane.on_step()
    return plane, alerts


def _hostile(pkg, tmp_path):
    clk = _FakeClock()
    plane, alerts = _plane(pkg, clk, namespace="paddle_tpu")
    plane.register("eng", lambda: {
        "collective_psum@tp_ms": 1.5,
        "latency": {"ttft_ms": {"p95": 3.25}},
        "requests": 4,
    }, labels={"replica": "r0"}, counters={"requests": 0})
    for t in (1.0, 2.0):
        clk.t = t
        plane.sample()
    return plane, alerts


def _escaped(pkg, tmp_path):
    clk = _FakeClock()
    plane, alerts = _plane(pkg, clk)
    plane.register("eng", lambda: {"v": 1},
                   labels={"cls": 'quo"te\\back'})
    plane.sample()
    return plane, alerts


def _slo(pkg, tmp_path, phases, **kw):
    clk = _FakeClock()
    plane, alerts = _plane(pkg, clk, burn_fast_window=2,
                           burn_slow_window=4, **kw)
    src = {"scheduler": {"slo_seen": 0, "slo_attained": 0}}
    plane.register("eng", lambda: _copy(src))
    for n, seen, attained in phases:
        for _ in range(n):
            clk.t += 1.0
            src["scheduler"]["slo_seen"] += seen
            src["scheduler"]["slo_attained"] += attained
            plane.sample()
    return plane, alerts


def _slo_clean(pkg, tmp_path):
    return _slo(pkg, tmp_path, ((8, 10, 10), (8, 0, 0)))


def _slo_page(pkg, tmp_path):
    return _slo(pkg, tmp_path, ((4, 10, 10), (4, 10, 0)), slo_target=0.99,
                page_burn_rate=14.4)


def _slo_ticket(pkg, tmp_path):
    return _slo(pkg, tmp_path, ((8, 100, 95),), slo_target=0.99)


def _drift(pkg, tmp_path):
    clk = _FakeClock()
    det = ({"rule": "drift_up", "path": "latency.decode_step_ms.p95",
            "severity": "ticket"},)
    plane, alerts = _plane(pkg, clk, detectors=det, anomaly_min_samples=6)
    src = {"latency": {"decode_step_ms": {"p95": 1.0}}}
    plane.register("eng", lambda: _copy(src))
    for v in (1.0, 1.05, 0.95, 1.1, 1.0, 1.02, 0.98, 1.04, 10.0):
        clk.t += 1.0
        src["latency"]["decode_step_ms"]["p95"] = v
        plane.sample()
    return plane, alerts


def _storms(pkg, tmp_path):
    clk = _FakeClock()
    det = (
        {"rule": "growth", "path": "scheduler.queue_depth",
         "severity": "ticket", "min_samples": 5},
        {"rule": "collapse", "path": "tokens_per_sec",
         "severity": "page", "min_samples": 5},
        {"rule": "storm", "path": "preemptions_per_s",
         "severity": "page", "min_samples": 5},
    )
    plane, alerts = _plane(pkg, clk, detectors=det, anomaly_min_samples=5)
    src = {"scheduler": {"queue_depth": 0}, "tokens_per_sec": 100.0,
           "preemptions": 0}
    plane.register("eng", lambda: dict(src, scheduler=dict(
        src["scheduler"])), counters={"preemptions": 0})
    for i in range(8):
        clk.t += 1.0
        plane.sample()
    for i in range(6):
        clk.t += 1.0
        src["scheduler"]["queue_depth"] += 2
        plane.sample()
    clk.t += 1.0
    src["tokens_per_sec"] = 10.0
    plane.sample()
    for i in range(3):
        clk.t += 1.0
        src["preemptions"] += 50
        plane.sample()
    return plane, alerts


def _bank(pkg, tmp_path):
    clk = _FakeClock()
    path = str(tmp_path / f"bank_{pkg.__name__.split('.')[0]}.jsonl")
    plane, alerts = _plane(pkg, clk, jsonl_path=path, jsonl_max_bytes=600,
                           jsonl_backups=2)
    plane.register("eng", lambda: {"v": clk.t, "w": {"x": 2 * clk.t}})
    for _ in range(12):
        clk.t += 1.0
        plane.sample()
    return plane, alerts


SCENARIOS = {f.__name__[1:]: f for f in (
    _rates, _cadence, _hostile, _escaped, _slo_clean, _slo_page,
    _slo_ticket, _drift, _storms, _bank)}


def _observed(plane, alerts, tmp_path, tag):
    """Everything a plane shows: its series (path, labels, kind, values),
    snapshot, exposition, the lint over it, the alerts and its one-shot
    JSONL, with the file's own path masked."""
    path = str(tmp_path / f"oneshot_{tag}.jsonl")
    plane.write_jsonl(path)
    with open(path) as f:
        bank = [json.loads(ln) for ln in f]
    series = sorted((s.path, tuple(s.labels), s.kind,
                     list(s.values())) for s in plane.series())
    text = plane.expose()
    return {"series": series, "snapshot": plane.snapshot(),
            "exposition": text, "lint": lint(text), "alerts": alerts,
            "jsonl": bank}


def lint(text):
    return tobs.lint_exposition(text)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plane_matches_jax(name, tmp_path):
    """Each scenario through both planes under one fake clock: series,
    rates, snapshot, exposition text, lint findings, alert records and the
    one-shot JSONL equal (tolerance 0: the same host arithmetic)."""
    got = {}
    for tag, pkg in PKGS.items():
        plane, alerts = SCENARIOS[name](pkg, tmp_path)
        got[tag] = _observed(plane, alerts, tmp_path, tag)
        got[tag]["jax_lint"] = jobs.lint_exposition(got[tag]["exposition"])
    assert got["port"] == got["jax"]
    assert got["port"]["lint"] == []


def test_bank_rotation_matches_jax(tmp_path):
    """The incremental bank rotates at the same sizes into the same files
    with the same lines."""
    files = {}
    for tag, pkg in PKGS.items():
        _bank(pkg, tmp_path)
        base = tmp_path / f"bank_{pkg.__name__.split('.')[0]}.jsonl"
        files[tag] = [(p.name.replace(base.name, "BANK"), p.read_text())
                      for p in sorted(tmp_path.glob(base.name + "*"))]
    assert files["port"] == files["jax"] and len(files["port"]) >= 2


@pytest.mark.parametrize("tree", [
    {"tokens": 7, "ratio": 0.5, "name": "fused", "flag": True,
     "nan": float("nan"), "nested": {"a": {"b": 1}},
     "scheduler": {"per_class": {"0": {"admitted": 3}}, "queue_depth": 2},
     "routing": {"per_replica": {"r0": {"queue_depth": 1}}},
     "telemetry": {"samples": 9}, "groups": {"x": 1}},
    {"latency": {"ttft_ms": {"p50": 1.0, "p95": 2.5, "count": 4}},
     "gauges": {"pages_free": {"last": 3, "min": None}},
     "collectives": {"calls": {"psum@tp": 3}}, "inf": float("inf")},
])
def test_flatten_matches_jax(tree):
    """``flatten_metrics`` rows (paths, lifted labels, leaf filtering)."""
    assert tobs.flatten_metrics(tree, skip=("groups",)) == \
        jobs.flatten_metrics(tree, skip=("groups",))


@pytest.mark.parametrize("text", [
    "",
    "# HELP bad@name x\n# TYPE bad@name gauge\nbad@name 1\n# EOF\n",
    "orphan_metric 1\n# EOF\n",
    "# HELP c_thing x\n# TYPE c_thing counter\nc_thing 1\n# EOF\n",
    '# HELP m x\n# TYPE m gauge\nm{bad-label="1"} 1\n# EOF\n',
    "# HELP m x\n# TYPE m gauge\nm 1\n",
    "# HELP ok x\n# TYPE ok gauge\nok 1\n# EOF\n",
])
def test_lint_matches_jax(text):
    """``lint_exposition``'s findings on broken and clean texts."""
    assert tobs.lint_exposition(text) == jobs.lint_exposition(text)


def test_config_coercion_matches_jax():
    """``TelemetryConfig.coerce`` and the defaults: the same config."""
    import dataclasses
    for value in (False, None, 0, True):
        j, t = (pkg.TelemetryConfig.coerce(value) for pkg in (jobs, tobs))
        assert (j is None) == (t is None)
        if j is not None:
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for pkg in (jobs, tobs):
        cfg = pkg.TelemetryConfig(sample_every=3)
        assert pkg.TelemetryConfig.coerce(cfg) is cfg
        with pytest.raises(TypeError, match="expects bool"):
            pkg.TelemetryConfig.coerce({"sample_every": 3})


# -- the planes on the engines -----------------------------------------

CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(vocab_size=97, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=128, dtype=torch.float32)
ENGINE = dict(capacity=2, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jp, device="cpu")


def _families(text):
    return sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE")})


def _stream(eng, gen_cls, n=4, seed=0):
    rng = np.random.RandomState(seed)
    reqs = [eng.submit(rng.randint(0, 97, (int(s),)).astype(np.int32),
                       gen_cls(max_new_tokens=4, greedy=True))
            for s in rng.randint(4, 14, n)]
    eng.drain()
    return reqs


def test_engine_plane_families_and_clean_silence(params):
    """tests/test_telemetry.py's engine stream through both engines with
    ``telemetry=TelemetryConfig(sample_every=1, detectors=())`` (the
    anomaly detectors judge host times, which a loaded CPU makes jitter;
    the burn-rate rules stay live): equal ids, the same telemetry key set
    and sample count, the same exposition families (both lint-clean), no
    alert on either."""
    jp, tp = params
    cfgs = {pkg: pkg.TelemetryConfig(sample_every=1, detectors=())
            for pkg in (jobs, tobs)}
    j = JEngine(jp, CFG, telemetry=cfgs[jobs], **ENGINE)
    t = ServingEngine(tp, TCFG, telemetry=cfgs[tobs], device="cpu", **ENGINE)
    jr, tr = _stream(j, JGen), _stream(t, GenerationConfig)
    assert [r.tokens for r in tr] == [list(map(int, r.tokens)) for r in jr]
    jm, tm = j.metrics(), t.metrics()
    assert set(tm["telemetry"]) == set(jm["telemetry"])
    assert tm["telemetry"]["samples"] == jm["telemetry"]["samples"]
    assert tm["telemetry"]["alerts"] == jm["telemetry"]["alerts"] \
        == {"page": 0, "ticket": 0}
    jt, tt = j.telemetry.expose(), t.telemetry.expose()
    assert tobs.lint_exposition(tt) == [] == jobs.lint_exposition(jt)
    # the series the port's metrics() adds (decode_step_ms_mean; the
    # H100 roofline's variant names) are its own; every JAX family is
    # in the port's exposition
    assert set(_families(jt)) - set(_families(tt)) <= {
        f for f in _families(jt) if "pallas" in f}


def _burst(pkg, tmp_path):
    """The serving phase's burst on the card, in miniature: TTFT's
    histogram stays empty for the first samples (no request has finished),
    then fills with waits that grow as the queued requests admit."""
    clk = _FakeClock()
    det = ({"rule": "drift_up", "path": "latency.ttft_ms.p95",
            "severity": "ticket"},)
    plane, alerts = _plane(pkg, clk, detectors=det, anomaly_min_samples=6)
    h = pkg.Histogram()
    src = {"latency": {"ttft_ms": h.snapshot()}}
    plane.register("eng", lambda: _copy(src))
    for i in range(14):
        clk.t += 1.0
        if i >= 4:
            h.observe(400.0 + 10.0 * i)
            src["latency"]["ttft_ms"] = h.snapshot()
        plane.sample()
    return plane, alerts


def test_empty_histogram_not_sampled():
    """The port's one departure from the JAX plane: an empty histogram's
    snapshot flattens to its count alone (the JAX plane also samples its
    0.0 mean and percentiles); a non-empty one flattens alike."""
    empty = {"latency": {"ttft_ms": tobs.Histogram().snapshot()}}
    assert tobs.flatten_metrics(empty) == [
        ("latency.ttft_ms.count", (), 0.0)]
    assert ("latency.ttft_ms.p95", (), 0.0) in jobs.flatten_metrics(empty)
    h = tobs.Histogram()
    h.observe(3.0)
    full = {"latency": {"ttft_ms": h.snapshot()}}
    assert tobs.flatten_metrics(full) == jobs.flatten_metrics(full)


def test_burst_ttft_fires_no_drift(tmp_path):
    """A TTFT p95 that is 0.0 until the first request finishes is no
    history to drift from: the JAX plane fires drift_up at the first real
    p95's judgement, the port's plane stays silent (its p95 series starts
    at the first observation)."""
    jp, ja = _burst(jobs, tmp_path)
    tp, ta = _burst(tobs, tmp_path)
    assert [a["rule"] for a in ja] == ["drift_up"]
    assert ta == []
    tv = {s.path: s.values() for s in tp.series()}
    jv = {s.path: s.values() for s in jp.series()}
    assert tv["latency.ttft_ms.p95"] == jv["latency.ttft_ms.p95"][4:]
