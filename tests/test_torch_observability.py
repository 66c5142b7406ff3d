"""The port's observability harness (``paddle_tpu_torch/observability/``,
``profiler/record_event.py``, ``distributed/flight_recorder.py``) against
the JAX package's on the CPU.

Host modules: the same observation, event and sample sequences under a
fake clock go to both packages; histogram percentiles, gauge series, the
timeline's JSONL lines and Chrome spans (times masked), stall-dump
contents, watchdog findings and flight-recorder counters must be equal
(tolerance 0: host arithmetic on the same floats).

Engines: the same 2-layer LLaMA (tests/test_observability.py's) and the
same streams through the JAX engine and the port's with
``observability=True`` (then ``telemetry=True``): the frozen metrics key
sets, recursively, enabled and disabled, tp included; the counters, token
ids and request records with their keys; the timeline's event names and
request ids in order; the watchdog on a forced retrace; the starved-drain
and deadline stall dumps; the degradation stream's page alert, its
timeline event and its dump; tools/trace_summary.py's output over both
JSONL files, times masked. The same for ``generate_paged``, the
disaggregated engine and the fleet. The port's own names where the card
differs: the roofline's routes are "cuda_block"/"cuda_fused"/"unfused"
(the JAX engine's "pallas_block"/"pallas_fused"/"unfused"), a fused chunk's
variant "cuda_fused" (JAX "pallas"), and ``metrics()`` adds
``decode_step_ms_mean``."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
import paddle_tpu.observability as jobs
from paddle_tpu.distributed import flight_recorder as jfr
from paddle_tpu.models import llama as jllama
from paddle_tpu.profiler import record_event as jre
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.distributed import flight_recorder as tfr
from paddle_tpu_torch.inference import (DisaggregatedEngine,
                                        GenerationConfig, PagedKVCacheStore,
                                        ServingEngine, ServingFleet,
                                        ServingMesh, generate_paged)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.observability import timeline as ttimeline
from paddle_tpu_torch.profiler import record_event as tre

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"jax": jobs, "port": tobs}

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
# the roofline routes' names: the JAX engine's -> the port's
RENAME = {"pallas_block": "cuda_block", "pallas_fused": "cuda_fused"}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _engine(port, params, **kw):
    jp, tp = params
    kw = dict(ENGINE, **kw)
    if port:
        return ServingEngine(tp, TCFG, device="cpu", **kw)
    return jinf.ServingEngine(jp, CFG, **kw)


def _gen(port, n, **kw):
    cls = GenerationConfig if port else jinf.GenerationConfig
    return cls(max_new_tokens=n, greedy=True, **kw)


def _mixed(eng, port, n=12, seed=14):
    """tests/test_observability.py's mixed-arrival stream (waves of
    submissions between steps), ``n`` requests."""
    rng = np.random.RandomState(seed)
    pending = [(rng.randint(0, 97, (int(rng.randint(3, 17)),))
                .astype(np.int32), int(rng.randint(2, 7)))
               for _ in range(n)]
    reqs = []
    while pending or not eng.idle:
        for _ in range(min(len(pending), 1 + int(rng.randint(0, 3)))):
            p, k = pending.pop(0)
            reqs.append(eng.submit(p, _gen(port, k)))
        eng.step()
    return reqs


def _ids(reqs):
    return [[int(t) for t in r.tokens] for r in reqs]


def _keys(tree, rename=None):
    """The nested key structure of a metrics dict (values dropped;
    ``rename`` maps JAX-only names to the port's)."""
    if not isinstance(tree, dict):
        return None
    rename = rename or {}
    return {str(rename.get(k, k)): _keys(v, rename) for k, v in tree.items()}


def _port_keys(m):
    """The port's keys without the ones it adds to the JAX schema."""
    k = _keys(m)
    k.pop("decode_step_ms_mean", None)
    return k


def _timeline(obs):
    return [(e.name, e.req_id) for e in obs.timeline.events()]


def _mask(x):
    """Floats masked (times), ints and strings kept."""
    if isinstance(x, dict):
        return {k: _mask(v) for k, v in x.items()
                if k not in ("t_ns", "t0_ns", "time", "iso", "pid")}
    if isinstance(x, (list, tuple)):
        return [_mask(v) for v in x]
    if isinstance(x, float):
        return "f"
    return x


# -- host modules --------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_histogram_matches_jax(seed):
    """The same observations (zeros, negatives, a wide dynamic range) give
    the same snapshot and percentiles, exactly."""
    rng = np.random.RandomState(seed)
    vals = np.concatenate([rng.lognormal(seed, 2.0, 300), [0.0, -1.0],
                           rng.uniform(0, 5, 20)]).tolist()
    hs = {tag: pkg.Histogram() for tag, pkg in PKGS.items()}
    for v in vals:
        for h in hs.values():
            h.observe(v)
    qs = (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0)
    assert [hs["port"].percentile(q) for q in qs] == \
        [hs["jax"].percentile(q) for q in qs]
    assert hs["port"].snapshot() == hs["jax"].snapshot()


def test_gauges_and_registry_match_jax():
    regs = {tag: pkg.MetricsRegistry() for tag, pkg in PKGS.items()}
    for reg in regs.values():
        counters = reg.adopt_counters({"steps": 0, "by": {"a": 1}})
        counters["steps"] += 3
        for i in range(700):               # past the 512-point window
            reg.gauge("free", window=512).set(100 - i % 37, t=i * 0.5)
        reg.histogram("x_ms").observe(2.0)
        reg.reset_histograms()
        reg.histogram("x_ms").observe(3.0)
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert list(regs["port"].gauges["free"].series) == \
        list(regs["jax"].gauges["free"].series)


def _timeline_events(pkg):
    tl = pkg.Timeline(capacity=8)
    base = 10 ** 9
    script = [("submit", 0, None, {"prompt_tokens": 5}),
              ("admit", 0, None, {"slot": 0}),
              ("prefill_chunk", 0, 1.5, {"pos0": 0, "n": 5, "bucket": 8}),
              ("first_token", 0, None, {"ttft_ms": 2.0}),
              ("decode_step", None, 0.75, {"live_slots": 1}),
              ("submit", 1, None, {}), ("admit", 1, None, {}),
              ("decode_step", None, 0.5, {"live_slots": 2}),
              ("finish", 0, None, {"gen_tokens": 3}),
              ("first_token", 1, None, {}), ("finish", 1, None, {})]
    for i, (name, rid, dur, meta) in enumerate(script):
        tl.record(name, rid, dur_ms=dur, t_ns=base + i * 1000, **meta)
    return tl


def test_timeline_jsonl_and_spans_match_jax(tmp_path):
    """The bounded ring (drop-oldest), its JSONL lines (t0 masked) and its
    Chrome spans (names, tids, start and end) equal."""
    got = {}
    for tag, pkg in PKGS.items():
        tl = _timeline_events(pkg)
        path = tmp_path / f"{tag}.jsonl"
        tl.write_jsonl(str(path), request_records=[{"req_id": 0}],
                       header={"capacity": 2})
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        lines[0].pop("t0_ns")
        spans = [(e.name, e.start_ns, e.end_ns, e.tid, e.event_type.name)
                 for e in tl.to_host_events()]
        got[tag] = (len(tl), tl.dropped, tl.tail(4), lines, spans)
    assert got["port"] == got["jax"]
    assert got["port"][1] == 3


def test_chrome_export_matches_jax(tmp_path):
    """Timeline.export_chrome through the profiler's trace writer: the
    same events, counter tracks and extra events (pid masked)."""
    got = {}
    for tag, pkg in PKGS.items():
        tl = _timeline_events(pkg)
        g = pkg.Gauge()
        for i in range(3):
            g.set(i, t=1.0 + i)
        path = tmp_path / f"{tag}.json"
        tl.export_chrome(str(path), gauges={"pages_free": g},
                         extra_events=[{"name": "roofline:x", "ph": "C",
                                        "ts": 0.0, "args": {"b": 1}}])
        evs = json.loads(path.read_text())["traceEvents"]
        got[tag] = [{k: v for k, v in e.items() if k != "pid"} for e in evs]
    assert got["port"] == got["jax"]


def test_stall_dump_and_retention_match_jax(tmp_path):
    """dump_path_for's retention and dump_stall's report (time and pid
    masked); Observability.stall_dump's log and suppression."""
    for n_files in range(4):
        assert tobs.stall.dump_path_for("a/b.c/d.json", n_files, 3) == \
            jobs.stall.dump_path_for("a/b.c/d.json", n_files, 3)
    got = {}
    for tag, pkg in PKGS.items():
        obs = pkg.Observability(stall_dump_path=str(tmp_path / f"{tag}.json"),
                                max_stall_dumps=2)
        obs.timeline.record("submit", 3, t_ns=5)
        paths = [obs.stall_dump(f"r{i}", {"queue_depth": i},
                                metrics={"m": i}) for i in range(4)]
        reports = [json.loads(pathlib.Path(p).read_text()) for p in paths
                   if p]
        got[tag] = ([pathlib.Path(p).name.replace(tag, "X") for p in paths],
                    obs.stall_dumps_suppressed, _mask(reports),
                    [e.name for e in obs.timeline.events()])
    assert got["port"] == got["jax"]


def test_watchdog_matches_jax():
    got = {}
    for tag, pkg in PKGS.items():
        wd = pkg.RetraceWatchdog(warn=False)
        c = {"decode_traces": 1, "calibration_traces": 0,
             "prefill_traces": {8: 1}}
        seq = [wd.check(c)]
        wd.mark_warmup(c)
        seq.append(wd.check(c))
        c["decode_traces"] += 1
        c["prefill_traces"][16] = 1
        c["calibration_traces"] = 1
        seq += [wd.check(c), wd.check(c)]
        got[tag] = (seq, wd.events, wd.armed)
    assert got["port"] == got["jax"]


def test_flight_recorder_matches_jax(tmp_path):
    """Begin/end under one fake clock: the registry's per-(op, axis)
    histograms and call/byte counters, the per-rank chrome track, a hang
    dump (entries and retention), the watchdog pass; dtypes named as the
    JAX package names them."""
    got = {}
    for tag, (pkg, fr) in {"jax": (jobs, jfr), "port": (tobs, tfr)}.items():
        clk = FakeClock()
        reg = pkg.MetricsRegistry()
        rec = fr.FlightRecorder(capacity=4, timeout=0.001,
                                dump_path=str(tmp_path / f"{tag}.json"),
                                max_dumps=2)
        rec.bind(registry=reg, clock=clk)
        rec.enabled = True
        done = []
        for i, (op, ax, shape, dt) in enumerate([
                ("psum", "tp", (4, 2, 64), "float32"),
                ("all_gather", "tp", (2, 2, 2, 16), "bfloat16"),
                ("kv_handoff", "xfer", (4, 8, 32), "int8"),
                ("psum", None, (3,), "float32"),
                ("psum", "tp", (1,), "not_a_dtype")]):
            t = rec.begin(op, ax, shape, dt)
            if i != 2:
                rec.end(t)
            done.append(t.nbytes)
        hung = rec.check_once()
        spans = [(e.name, e.end_ns - e.start_ns, e.tid)
                 for e in rec.to_host_events()]
        report = json.loads(pathlib.Path(rec.dumps[0][1]).read_text())
        got[tag] = (done, reg.snapshot()["counters"],
                    {k: h.snapshot() for k, h in reg.histograms.items()},
                    spans, hung, _mask(report["entries"]),
                    report["scheduler"])
    assert got["port"] == got["jax"]


def test_record_event_matches_jax():
    """RecordEvent and the host tracer: the same events kept, in order."""
    got = {}
    for tag, re_ in {"jax": jre, "port": tre}.items():
        tr = re_.get_host_tracer()
        tr.clear()
        tr.start()
        for name in ("a", "b"):
            with re_.RecordEvent(name):
                pass
        ev = re_.RecordEvent("c", re_.TracerEventType.Forward)
        ev.begin()
        ev.end()
        ev.end()                      # a second end records nothing
        tr.stop()
        with re_.RecordEvent("off"):
            pass
        got[tag] = [(e.name, e.event_type.name) for e in tr.events()]
        tr.clear()
    assert got["port"] == got["jax"] == [
        ("a", "PythonUserDefined"), ("b", "PythonUserDefined"),
        ("c", "Forward")]


PEAKS = {"peak_flops": 989e12, "peak_hbm_bw": 3.35e12,
         "peak_source": {"flops": "f", "hbm_bw": "b"}}


@pytest.mark.parametrize("point", [
    (1e6, 2e9, 10.0), (6.7e7, 6.7e7, 30.0), (None, 5e12, 8000.0),
    (4e9, None, None), (0, 0, 1.0), (3e8, 1e12, None)])
def test_roofline_point_matches_jax(point):
    """The roofline classification under the same peaks: intensity,
    bound, the least time and the achieved fractions, exactly."""
    assert tobs.roofline_point(*point, peaks=PEAKS) == \
        jobs.roofline_point(*point, peaks=PEAKS)


def test_kernel_costs_over_captured_plans():
    """``capture_kernel_costs`` runs a wrapper over meta tensors (nothing
    launched, no count moved) and prices its plan: the bytes and FLOPs of
    the catalog's model, the roofline row against the one peak table,
    the measured time's fractions; the chrome track of a decode
    roofline report has one counter a route."""
    from paddle_tpu_torch.analysis.kernel_catalog import modeled_flops
    from paddle_tpu_torch.analysis.kernel_rules import modeled_launch_bytes
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import norms
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    x = torch.empty(4096, 4096, dtype=torch.bfloat16, device="meta")
    w = torch.empty(4096, dtype=torch.bfloat16, device="meta")
    kernels.reset_launches()
    rows = tobs.capture_kernel_costs(norms.rms_norm_fwd_triton, x, w,
                                     times_us={"rms_norm_fwd": 30.0})
    assert kernels.launches()["rms_norm_fwd"] == 0
    with capture_kernel_launches() as specs:
        norms.rms_norm_fwd_triton(x, w)
    (row,) = rows
    bm = modeled_launch_bytes(specs[0])
    assert row["bytes_modeled"] == bm["total_bytes"] == 2 * 4096 * 4096 * 2 \
        + 4096 * 2
    assert row["flops_modeled"] == modeled_flops(specs[0])
    assert row == dict(tobs.kernel_cost(specs[0], time_us=30.0),
                       peak_source=row["peak_source"])
    want = tobs.roofline_point(row["bytes_modeled"], row["flops_modeled"],
                               time_us=30.0)
    assert {k: row[k] for k in want} == want
    assert row["bound"] == "memory"
    peaks = tobs.roofline.peak_snapshot()
    assert (peaks["peak_flops"], peaks["peak_hbm_bw"]) == (989e12, 3.35e12)
    report = tobs.decode_roofline(tobs.decode_step_bytes(
        8, 64, 4, 2, 16, 128, 4, 16))
    assert [e["name"] for e in tobs.roofline.roofline_chrome_events(
        report)] == ["roofline:cuda_block", "roofline:cuda_fused",
                     "roofline:unfused"]


def test_peak_table_order(monkeypatch):
    """The JAX lookup order on the one table: the env override, then the
    card's entry (none here), then the labelled H100 default; the
    kernel gate's bound and the roofline read the same numbers."""
    from paddle_tpu_torch.analysis import kernel_rules
    for var in ("PADDLE_TPU_PEAK_FLOPS", "PADDLE_TPU_PEAK_HBM_BW"):
        monkeypatch.delenv(var, raising=False)
    flops, src = tobs.device_peak_flops()
    assert (flops, src.split(":")[0]) == (989e12, "default")
    assert "H100" in src and tobs.device_peak_hbm_bw()[0] == 3.35e12
    assert tobs.device_peak_flops(default=5.0) == (5.0, src)
    assert kernel_rules.PEAK_OPS_PER_S["bfloat16"] == flops
    assert kernel_rules.HBM_BYTES_PER_S == tobs.device_peak_hbm_bw()[0]
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("PADDLE_TPU_PEAK_HBM_BW", "not a number")
    assert tobs.device_peak_flops() == (1e15, "env")
    assert tobs.device_peak_hbm_bw()[1].startswith("default")
    assert tobs.live_hbm_bytes("cpu") is None


# -- isolation ------------------------------------------------------------

HARNESS = ("paddle_tpu_torch/observability", "paddle_tpu_torch/profiler",
           "paddle_tpu_torch/distributed/flight_recorder.py")


def test_harness_imports_neither_jax_nor_paddle_tpu():
    """No module of the harness names jax or paddle_tpu in an import
    (AST), and the modules import in a fresh interpreter where both are
    made unimportable."""
    files = []
    for h in HARNESS:
        p = ROOT / h
        files += sorted(p.glob("*.py")) if p.is_dir() else [p]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "paddle_tpu"), (f, n)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'paddle_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import paddle_tpu_torch.observability as o\n"
        "import paddle_tpu_torch.observability.compile\n"
        "import paddle_tpu_torch.profiler as p\n"
        "import paddle_tpu_torch.distributed.flight_recorder as f\n"
        "h = o.Histogram(); h.observe(1.0)\n"
        "print('ok', h.count)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 1"


# -- the engine -----------------------------------------------------------

@pytest.fixture(scope="module")
def streams(params, tmp_path_factory):
    """The mixed-arrival stream through both engines, observed, and
    through both disabled; their exports."""
    tmp = tmp_path_factory.mktemp("obs_streams")
    out = {}
    for tag, port in (("jax", False), ("port", True)):
        eng = _engine(port, params, capacity=3, observability=True)
        reqs = _mixed(eng, port)
        off = _engine(port, params)
        off_reqs = _mixed(off, port, n=4)
        jsonl = str(tmp / f"{tag}.jsonl")
        trace = str(tmp / f"{tag}.trace.json")
        eng.write_timeline(jsonl)
        eng.export_trace(trace)
        out[tag] = {"eng": eng, "reqs": reqs, "off": off,
                    "off_reqs": off_reqs, "jsonl": jsonl, "trace": trace}
    return out


def test_metrics_schema_frozen_matches_jax(streams):
    """The enabled and disabled key sets, recursively (latency, gauges,
    scheduler, roofline with the routes renamed)."""
    j, t = streams["jax"], streams["port"]
    assert _port_keys(t["eng"].metrics()) == \
        _keys(j["eng"].metrics(), RENAME)
    assert _port_keys(t["off"].metrics()) == \
        _keys(j["off"].metrics(), RENAME)
    assert set(t["eng"].metrics()) - set(t["off"].metrics()) == {
        "latency", "gauges", "retrace_warnings", "stall_dumps",
        "timeline_events", "timeline_dropped"}


def test_counters_ids_and_request_records_match_jax(streams):
    j, t = streams["jax"], streams["port"]
    assert _ids(t["reqs"]) == _ids(j["reqs"])
    assert _ids(t["off_reqs"]) == _ids(j["off_reqs"])
    assert t["eng"].counters == j["eng"].counters
    jr = list(j["eng"].observability.request_records)
    tr = list(t["eng"].observability.request_records)
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    assert _mask(tr) == _mask(jr)
    jm, tm = j["eng"].metrics(), t["eng"].metrics()
    for name in ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms",
                 "decode_step_ms", "prefill_chunk_ms", "step_ms"):
        assert tm["latency"][name]["count"] == jm["latency"][name]["count"]
    assert tm["gauges"].keys() == jm["gauges"].keys()
    for name, g in tm["gauges"].items():
        if name not in ("slo_attainment",):
            assert g == jm["gauges"][name], name


def test_timeline_events_match_jax(streams):
    """Event names and request ids in order; each event's fields (times
    masked) equal but the variants' names."""
    j, t = streams["jax"], streams["port"]
    assert _timeline(t["eng"].observability) == \
        _timeline(j["eng"].observability)
    for je, te in zip(j["eng"].observability.timeline.events(),
                      t["eng"].observability.timeline.events()):
        assert _mask(te.to_dict()) == _mask(je.to_dict())


def test_trace_summary_matches_jax(streams):
    """tools/trace_summary.py over both JSONL files: the summaries equal
    with times masked and the routes renamed, and both render."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import trace_summary as ts
    finally:
        sys.path.pop(0)
    got = {}
    for tag in ("jax", "port"):
        meta, events, requests = ts.load(streams[tag]["jsonl"])
        meta.pop("roofline", None)
        summary = ts.summarize(meta, events, requests, top=5)
        assert "decode_step" in ts.render(summary)
        # the slowest steps are ranked by their (host) times
        assert len(summary.pop("slowest_steps")) == 5
        got[tag] = _mask(summary)
    assert got["port"] == got["jax"]


def test_chrome_trace_matches_jax(streams):
    """The exported trace: the same spans (names, tids) and counter
    tracks, the roofline tracks renamed."""
    got = {}
    for tag in ("jax", "port"):
        evs = json.loads(open(streams[tag]["trace"]).read())["traceEvents"]
        spans = sorted((e["name"], e["tid"]) for e in evs
                       if e.get("ph") == "X")
        tracks = sorted({RENAME.get(e["name"][9:], e["name"][9:])
                         if e["name"].startswith("roofline:")
                         else e["name"] for e in evs if e.get("ph") == "C"})
        got[tag] = (spans, tracks)
    assert got["port"] == got["jax"]
    assert any(n.endswith(":prefill") for n, _ in got["port"][0])


def test_watchdog_forced_retrace_matches_jax(params):
    """tests/test_observability.py's forced retrace: bucket 8 warmed,
    reset, a prompt needing bucket 16 warns once on both engines with the
    same event; steady traffic stays silent."""
    got = {}
    for tag, port in (("jax", False), ("port", True)):
        eng = _engine(port, params, observability=True)
        rng = np.random.RandomState(10)
        eng.submit(rng.randint(0, 97, (6,)).astype(np.int32),
                   _gen(port, 2))
        eng.drain()
        eng.reset_metrics()
        eng.submit(rng.randint(0, 97, (14,)).astype(np.int32),
                   _gen(port, 2))
        with pytest.warns(RuntimeWarning, match="retrace after warmup"):
            eng.drain()
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("error", RuntimeWarning)
            eng.submit(rng.randint(0, 97, (6,)).astype(np.int32),
                       _gen(port, 2))
            eng.drain()
        got[tag] = (eng.metrics()["retrace_warnings"],
                    eng.observability.watchdog.events,
                    [n for n, _ in _timeline(eng.observability)
                     if n == "retrace"])
    assert got["port"] == got["jax"]
    assert got["port"][1][0]["program"] == "prefill[16]"


def _dump(path):
    r = json.loads(pathlib.Path(path).read_text())
    return {k: _mask(r[k]) for k in ("reason", "scheduler", "timeline_tail")}


def test_stall_dumps_match_jax(params, tmp_path):
    """The starved drain (7 of 9 pages held hostage) and the blown step
    deadline: the same reports (scheduler snapshot, timeline tail; times
    masked) and errors."""
    got = {}
    for tag, port in (("jax", False), ("port", True)):
        st = tmp_path / f"{tag}_starved.json"
        eng = _engine(port, params, num_blocks=10,
                      observability=PKGS[tag].Observability(
                          stall_dump_path=str(st)))
        eng.mgr.allocate(999, 7 * 4)
        eng.submit(np.random.RandomState(11).randint(0, 97, (20,))
                   .astype(np.int32), _gen(port, 4))
        with pytest.raises(RuntimeError, match="starved") as ei:
            eng.drain()
        assert str(st) in str(ei.value)
        dl = tmp_path / f"{tag}_deadline.json"
        eng2 = _engine(port, params, observability=PKGS[tag].Observability(
            step_deadline_s=0.0, stall_dump_path=str(dl)))
        eng2.submit(np.random.RandomState(12).randint(0, 97, (5,))
                    .astype(np.int32), _gen(port, 2))
        eng2.step()
        got[tag] = (_dump(st), eng.metrics()["stall_dumps"],
                    json.loads(dl.read_text())["scheduler"],
                    "deadline" in json.loads(dl.read_text())["reason"])
    assert got["port"] == got["jax"]
    assert got["port"][3]


def test_degradation_page_alert_matches_jax(params, tmp_path):
    """tests/test_telemetry.py's degradation stream: a clean baseline,
    then requests whose 0 s deadline cannot be met: one page alert
    (slo_burn_rate) with the same record, its timeline event and its
    stall dump, on both engines."""
    got = {}
    for tag, port in (("jax", False), ("port", True)):
        pkg = PKGS[tag]
        dump = tmp_path / f"{tag}_page.json"
        eng = _engine(port, params, observability=pkg.Observability(
            stall_dump_path=str(dump)), telemetry=pkg.TelemetryConfig(
                sample_every=1, detectors=(), burn_fast_window=2,
                burn_slow_window=4))
        rng = np.random.RandomState(3)
        for _ in range(2):
            eng.submit(rng.randint(0, 97, (6,)).astype(np.int32),
                       _gen(port, 2))
        eng.drain()
        for _ in range(6):
            eng.submit(rng.randint(0, 97, (6,)).astype(np.int32),
                       _gen(port, 2), deadline_s=0.0)
        eng.drain()
        alerts = [dict(a) for a in eng.telemetry.alerts]
        events = [e.to_dict() for e in eng.observability.timeline.events()
                  if e.name == "alert"]
        got[tag] = (_mask(alerts), _mask(events),
                    json.loads(dump.read_text())["reason"],
                    eng.metrics()["telemetry"]["alerts"])
    assert got["port"] == got["jax"]
    assert got["port"][3]["page"] >= 1
    assert got["port"][2].startswith("telemetry alert: slo_burn_rate")


def test_disabled_mode_allocates_no_event_objects(params, monkeypatch):
    """observability=False allocates no TimelineEvent, Observability or
    TelemetryPlane anywhere in the serving loop, and the exports raise."""
    def boom(*a, **k):
        raise AssertionError("event object allocated in disabled mode")
    monkeypatch.setattr(ttimeline.TimelineEvent, "__init__", boom)
    monkeypatch.setattr(tobs.Observability, "__init__", boom)
    monkeypatch.setattr(tobs.TelemetryPlane, "__init__", boom)
    eng = _engine(True, params)
    assert eng.observability is None and eng.telemetry is None
    reqs = _mixed(eng, True, n=3, seed=13)
    assert all(r.done for r in reqs)
    m = eng.metrics()
    assert "latency" not in m and "telemetry" not in m
    for call in (eng.export_trace, eng.write_timeline):
        with pytest.raises(RuntimeError, match="disabled"):
            call("/nonexistent/never.json")


def test_tp_collectives_match_jax(params):
    """A tp=2 "psum" mesh with observability: the flight recorder's
    calls and bytes per (op, axis) equal the JAX engine's (the declared
    inventory replayed around each step), histogram counts too."""
    jp, tp = params
    j = jinf.ServingEngine(jp, CFG, mesh=jinf.ServingMesh.make(
        tp=2, collective="psum"), observability=True, **ENGINE)
    t = ServingEngine(tp, TCFG, mesh=ServingMesh.make(
        2, collective="psum", devices=["cpu"] * 2), observability=True,
        **ENGINE)
    jr, tr = _mixed(j, False, n=4), _mixed(t, True, n=4)
    assert _ids(tr) == _ids(jr)
    jm, tm = j.metrics(), t.metrics()
    assert _port_keys(tm) == _keys(jm, RENAME)
    assert tm["collectives"]["calls"] == jm["collectives"]["calls"]
    assert tm["collectives"]["bytes"] == jm["collectives"]["bytes"]
    assert {k: v["count"] for k, v in tm["collectives"]["latency_ms"].items()
            } == {k: v["count"]
                  for k, v in jm["collectives"]["latency_ms"].items()}


# -- generate_paged, the disaggregated engine, the fleet -----------------

def test_generate_paged_matches_jax(params):
    """generate_paged with a harness, cold and over a prefix store: the
    same ids as without, the same events, gauges and histogram counts as
    the JAX package's."""
    jp, tp = params
    prompts = np.random.RandomState(5).randint(0, 97, (2, 10)).astype(
        np.int32)
    got = {}
    for tag in ("jax", "port"):
        port = tag == "port"
        obs, obs2 = PKGS[tag].Observability(), PKGS[tag].Observability()
        if port:
            out = generate_paged(tp, prompts, TCFG, _gen(True, 40),
                                 block_size=4, observability=obs,
                                 device="cpu")
            store = PagedKVCacheStore(TCFG, block_size=4, num_blocks=64,
                                      device="cpu")
            out2 = generate_paged(tp, prompts, TCFG, _gen(True, 6),
                                  block_size=4, prefix_cache=store,
                                  observability=obs2)
        else:
            out = jinf.generate_paged(jp, prompts, CFG, _gen(False, 40),
                                      block_size=4, observability=obs)
            store = jinf.PagedKVCacheStore(CFG, block_size=4, num_blocks=64)
            out2 = jinf.generate_paged(jp, prompts, CFG, _gen(False, 6),
                                       block_size=4, prefix_cache=store,
                                       observability=obs2)
        got[tag] = (np.asarray(out).tolist(), np.asarray(out2).tolist(),
                    [_mask(e.to_dict()) for o in (obs, obs2)
                     for e in o.timeline.events()],
                    [o.gauges_snapshot() for o in (obs, obs2)],
                    [{k: v["count"] for k, v in o.latency_snapshot().items()}
                     for o in (obs, obs2)])
    assert got["port"] == got["jax"]


def test_disaggregated_engine_matches_jax(params, tmp_path):
    """The disaggregated engine observed, its groups tp=1 meshes on one
    device each (the JAX groups on two CPU devices): ids, key sets (the
    groups' collectives included), one timeline shared by both groups
    with the same events and request ids in order (handoffs included),
    the handoff histogram's count, the exports."""
    jp, tp = params
    kw = dict(ENGINE, prefill_slots=1)
    j = jinf.DisaggregatedEngine(jp, CFG, observability=True,
                                 prefill_devices=jax.devices()[:1],
                                 decode_devices=jax.devices()[1:2], **kw)
    t = DisaggregatedEngine(tp, TCFG, observability=True,
                            prefill_devices=["cpu"], decode_devices=["cpu"],
                            **kw)
    jr, tr = _mixed(j, False, n=8), _mixed(t, True, n=8)
    assert _ids(tr) == _ids(jr)
    jm, tm = j.metrics(), t.metrics()
    tk = _keys(tm)
    for g in tk["groups"].values():
        g.pop("decode_step_ms_mean")
    assert tk == _keys(jm, RENAME)
    assert _timeline(t.observability) == _timeline(j.observability)
    names = [n for n, _ in _timeline(t.observability)]
    assert "handoff" in names
    assert tm["latency"]["handoff_ms"]["count"] == \
        jm["latency"]["handoff_ms"]["count"] == tm["handoffs"]
    assert tm["collectives"]["calls"] == jm["collectives"]["calls"]
    assert t.prefill.observability.timeline is t.observability.timeline
    for call in ("export_trace", "write_timeline"):
        path = str(tmp_path / call)
        assert getattr(t, call)(path) == path


def test_fleet_matches_jax(params, tmp_path):
    """A fleet of two colocated replicas, observed: ids, key sets, the
    route events, the shared request histograms' counts, the exports'
    meta header."""
    got = {}
    for tag, port in (("jax", False), ("port", True)):
        reps = [_engine(port, params, prefix_cache=True,
                        observability=True), _engine(port, params)]
        cls = ServingFleet if port else jinf.ServingFleet
        fleet = cls(reps, observability=True)
        reqs = _mixed(fleet, port, n=8)
        m = fleet.metrics()
        path = tmp_path / f"{tag}.jsonl"
        fleet.write_timeline(str(path))
        meta = json.loads(path.read_text().splitlines()[0])
        got[tag] = (_ids(reqs), _timeline(fleet.observability),
                    {k: v["count"] for k, v in m["latency"].items()},
                    sorted(meta), m["routing"])
        keys = _keys(m, None if port else RENAME)
        for r in keys["replicas"].values():
            r.pop("decode_step_ms_mean", None)
        got[tag] += (keys,)
    assert got["port"] == got["jax"]
    assert [n for n, _ in got["port"][1]] == ["route"] * 8
