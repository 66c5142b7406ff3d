"""The observed trainer and the collective flight recorder of the port
(``paddle_tpu_torch/distributed/trainer.py``, ``observability/compile.py``,
``distributed/flight_recorder.py``) against the JAX package's on the CPU.

The trainer: the disabled and enabled ``metrics()`` key sets against the
JAX trainer's; the loss and grad norm bit-identical observed and plain
(tolerance 0: the observed step runs the same body); the host-gap dump on
forced per-step staging and none on healthy steps; the step watcher
arming on ``reset_metrics()``; the Chrome trace and JSONL, and
tools/trace_summary.py's train mode over both packages' JSONL (times
masked); the counted FLOPs of one step against the JAX ``CompileWatcher``'s
``flops_per_step`` at one layer (within 0.80-1.00: XLA counts the
elementwise work too, the port the products; measured 0.919); and the
flight recorder's global enable/reset/watchdog/dump contract against the
JAX recorder's. (At two layers the port counts 1.29x the JAX figure: the
JAX model runs its layers in a ``lax.scan``, whose body XLA's cost
analysis counts once.)"""
import json
import os
import pathlib
import sys
import time
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu.observability as jobs
from paddle_tpu.distributed import flight_recorder as jfr
from paddle_tpu.distributed.trainer import MeshConfig, Trainer as JTrainer
from paddle_tpu.distributed.trainer import make_mesh
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.distributed import flight_recorder as tfr
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.observability import timeline as ttimeline

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfgs(D=32, F=64, L=2, S=32):
    j = jllama.LlamaConfig(vocab_size=97, hidden_size=D, intermediate_size=F,
                           num_hidden_layers=L, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=S,
                           dtype=jnp.float32, remat=False)
    t = tllama.LlamaConfig(vocab_size=97, hidden_size=D, intermediate_size=F,
                           num_hidden_layers=L, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=S,
                           dtype=torch.float32, remat=False)
    return j, t


CFG, TCFG = _cfgs()


@pytest.fixture(scope="module", autouse=True)
def no_x64():
    """The JAX trainer's AdamW runs under ``no_x64``, which this jax
    cannot enter with x64 on: the module runs with x64 off."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _jtrainer(cfg=CFG, **kw):
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:1])
    kw.setdefault("data_spec", P())
    kw.setdefault("lr", 1e-3)
    return JTrainer(lambda p, t, l: jllama.loss_fn(p, t, l, cfg), mesh,
                    jllama.param_shardings(mesh, cfg), **kw)


def _trainer(cfg=TCFG, **kw):
    kw.setdefault("lr", 1e-3)
    return Trainer(lambda p, t, l: tllama.loss_fn(p, t, l, cfg),
                   device="cpu", **kw)


def _params(cfg=TCFG, seed=0):
    return tllama.init_params(cfg, seed=seed, device="cpu")


def _batch(seed=0, b=2, s=8):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 97, (b, s)).astype(np.int64)
    return torch.as_tensor(toks), torch.as_tensor(np.roll(toks, -1, -1))


def _jbatch(seed=0, b=2, s=8):
    rng = np.random.RandomState(seed)
    toks = jnp.asarray(rng.randint(0, 97, (b, s)), jnp.int32)
    return toks, jnp.asarray(np.roll(np.asarray(toks), -1, -1))


def _mask(x):
    if isinstance(x, dict):
        return {k: _mask(v) for k, v in x.items()
                if k not in ("t_ns", "t0_ns", "time", "iso", "pid")}
    if isinstance(x, (list, tuple)):
        return [_mask(v) for v in x]
    if isinstance(x, float):
        return "f"
    return x


def _ts():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import trace_summary
    finally:
        sys.path.pop(0)
    return trace_summary


# -- the metrics contract --------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three steps through both trainers, disabled and enabled, and the
    enabled ones' JSONL. The gap detector's wall floor is out of reach
    here (it has tests of its own): a loaded CPU's slow step must not add
    a host_gap event to one trainer's timeline only."""
    tmp = tmp_path_factory.mktemp("train_obs")
    out = {}
    for obs in (False, True):
        jt = _jtrainer(observability=obs, host_gap_min_ms=1e9)
        js = jt.init_state(jllama.init_params(CFG, jax.random.key(0)))
        tt = _trainer(observability=obs, host_gap_min_ms=1e9)
        ts = tt.init_state(_params())
        for i in range(3):
            js, _ = jt.step(js, *_jbatch(i))
            ts, _ = tt.step(ts, *_batch(i))
        out[obs] = (jt, tt)
        if obs:
            for tag, tr in (("jax", jt), ("port", tt)):
                tr.write_timeline(str(tmp / f"{tag}.jsonl"))
                tr.export_trace(str(tmp / f"{tag}.json"))
    out["tmp"] = tmp
    return out


def test_metrics_schema_matches_jax(runs):
    """The disabled and enabled key sets equal the JAX trainer's, the
    latency and memory sub-sets too; ``compile``'s entry has the JAX
    snapshot's keys (``cost.flops`` counted)."""
    for obs in (False, True):
        jm, tm = (tr.metrics() for tr in runs[obs])
        assert set(tm) == set(jm)
        assert tm["steps"] == jm["steps"] == 3
        assert tm["samples"] == jm["samples"] and \
            tm["tokens"] == jm["tokens"]
    jm, tm = (tr.metrics() for tr in runs[True])
    assert set(tm["latency"]) == set(jm["latency"]) == \
        set(tobs.TRAIN_HISTOGRAMS)
    for name, snap in tm["latency"].items():
        assert set(snap) == set(jm["latency"][name])
    assert set(tm["gauges"]) == set(jm["gauges"]) - {"hbm_bytes_in_use"}
    assert set(tm["compile"]) == set(jm["compile"])
    jp, tp = (m["compile"]["programs"]["train_step"] for m in (jm, tm))
    assert set(tp) == set(jp) and tp["count"] == jp["count"] == 1
    assert tp["cost"]["flops"] > 0
    assert set(tm["hbm"]) == {"argument_bytes", "output_bytes",
                              "temp_bytes", "alias_bytes",
                              "generated_code_bytes", "total_bytes"}
    assert set(tm["hbm"]) >= set(jm["hbm"])
    assert tm["hbm"]["argument_bytes"] > 0 and tm["hbm"]["total_bytes"] > 0
    assert set(tm["mfu"]) == set(jm["mfu"])
    assert tm["mfu"]["flops_per_step_per_device"] == tp["cost"]["flops"]
    assert tm["latency"]["step_ms"]["count"] == 3
    for key in ("loss", "grad_norm"):
        assert tm["gauges"][key]["last"] is not None


def test_exports_and_trace_summary_match_jax(runs):
    """The Chrome trace (train_step spans, loss counter track), the JSONL
    (meta mode train with its mesh; one train_step line a step with the
    phase split) and tools/trace_summary.py's train summary, times
    masked, equal the JAX trainer's."""
    tmp, ts = runs["tmp"], _ts()
    got = {}
    for tag in ("jax", "port"):
        evs = json.loads((tmp / f"{tag}.json").read_text())["traceEvents"]
        spans = sorted(e["name"] for e in evs if e.get("ph") == "X")
        tracks = sorted({e["name"] for e in evs if e.get("ph") == "C"}
                        - {"hbm_bytes_in_use"})
        lines = [json.loads(ln) for ln in
                 (tmp / f"{tag}.jsonl").read_text().splitlines()]
        steps = [ln for ln in lines if ln.get("name") == "train_step"]
        assert len(steps) == 3 and all(
            {"stage_ms", "dispatch_ms", "sync_ms", "dur_ms"} <= set(s)
            for s in steps)
        meta, events, requests = ts.load(str(tmp / f"{tag}.jsonl"))
        summary = ts.summarize_train(meta, events, top=3)
        assert "stage_ms" in ts.render_train(summary)
        summary.pop("slowest_steps")     # ranked by host times
        summary.pop("host_device_gap")   # the CPU step is all dispatch
        got[tag] = (spans, tracks, _mask(lines[0]),
                    [n["name"] for n in lines[1:]], _mask(summary))
    assert got["port"] == got["jax"]
    assert "train_step" in got["port"][0] and "loss" in got["port"][1]
    assert got["port"][2]["mode"] == "train" and "mesh" in got["port"][2]


def test_disabled_mode_no_event_objects_no_extra_sync(monkeypatch):
    """observability=False allocates no TimelineEvent or Observability,
    and the exports raise."""
    def boom(*a, **k):
        raise AssertionError("allocated in disabled mode")
    monkeypatch.setattr(ttimeline.TimelineEvent, "__init__", boom)
    monkeypatch.setattr(tobs.Observability, "__init__", boom)
    tr = _trainer()
    assert tr.observability is None and tr.telemetry is None
    state = tr.init_state(_params())
    state, m = tr.step(state, *_batch())
    assert np.isfinite(float(m["loss"]))
    mm = tr.metrics()
    assert "latency" not in mm and "gauges" not in mm
    for call in (tr.export_trace, tr.write_timeline):
        with pytest.raises(RuntimeError, match="disabled"):
            call("/nonexistent/never.json")


@pytest.mark.parametrize("accumulate", [1, 2])
def test_loss_bit_identical_observed_and_plain(accumulate):
    """Ten steps, same init, same batches: loss and grad norm are equal
    bit for bit with observability on and off, the signature's first step
    (the watcher's probe) included."""
    results = []
    for obs in (False, True):
        tr = _trainer(observability=obs, accumulate_steps=accumulate)
        state = tr.init_state(_params(seed=1))
        run = []
        for i in range(10):
            toks, labels = _batch(seed=i, b=2 * accumulate)
            if accumulate > 1:
                toks = toks.reshape(accumulate, 2, -1)
                labels = labels.reshape(accumulate, 2, -1)
            state, m = tr.step(state, toks, labels)
            run.append((float(m["loss"]), float(m["grad_norm"])))
        results.append(run)
    assert results[0] == results[1]


def test_host_gap_dump_on_forced_staging(tmp_path, monkeypatch):
    """The forced per-step staging residual (10 ms a batch leaf) dwarfs
    the wait: a finding and a dump naming the phase split; reset_metrics
    restarts the window."""
    dump = tmp_path / "gap.json"
    obs = tobs.Observability(stall_dump_path=str(dump),
                             histograms=tobs.TRAIN_HISTOGRAMS)
    tr = _trainer(observability=obs, host_gap_factor=1.5,
                  host_gap_min_ms=5.0)
    orig = Trainer._stage

    def slow_stage(self, b):
        time.sleep(0.01)
        return orig(self, b)

    monkeypatch.setattr(Trainer, "_stage", slow_stage)
    state = tr.init_state(_params())
    for _ in range(2):
        state, _ = tr.step(state, *_batch())
    m = tr.metrics()
    assert m["host_gap_findings"] >= 1 and m["stall_dumps"] >= 1
    report = json.loads(dump.read_text())
    assert "host-vs-device gap" in report["reason"]
    split = report["scheduler"]["phase_split"]
    assert split["stage_ms"] > split["device_wait_ms"]
    assert report["scheduler"]["mesh"] == {"pp": 1, "dp": 1, "fsdp": 1,
                                           "sp": 1, "tp": 1}
    assert any(e.name == "host_gap"
               for e in tr.observability.timeline.events())
    tr.reset_metrics()
    assert tr.metrics()["host_gap_findings"] == 0 and tr._gap.dumps == 0


def test_no_gap_dump_on_healthy_steps(monkeypatch):
    """Healthy steps (pre-staged batches, the host's share under 4x the
    wait) leave no finding and no dump, whatever the wall floor; the
    first step (the watcher's probe) is not judged. The harness's clock
    is a fake one advancing 5 ms a read (stage, dispatch and sync 5 ms
    each): on the CPU the eager step is all host work, so real times
    would judge the CPU, not the wiring."""
    clock = [0.0]

    def now():
        clock[0] += 0.005
        return clock[0]

    monkeypatch.setattr(tobs.Observability, "now", staticmethod(now))
    tr = _trainer(observability=True, host_gap_min_ms=1.0)
    state = tr.init_state(_params())
    batch = _batch()
    for _ in range(4):
        state, _ = tr.step(state, *batch)
    m = tr.metrics()
    assert m["host_gap_findings"] == 0 and m["stall_dumps"] == 0
    assert m["latency"]["sync_ms"]["mean"] == pytest.approx(5.0)
    # the same steps with the host's share over the factor: judged
    tr._gap.factor = 0.5
    state, _ = tr.step(state, *batch)
    assert tr.metrics()["host_gap_findings"] == 1


def test_watcher_arms_on_reset():
    """reset_metrics() arms the step watcher: a new batch signature after
    warm-up warns once (a retrace); a steady signature stays silent;
    re-arming starts a fresh window. The JAX trainer counts the same."""
    got = {}
    for tag in ("jax", "port"):
        if tag == "jax":
            tr = _jtrainer(observability=True)
            state = tr.init_state(jllama.init_params(CFG, jax.random.key(0)))
            b1, b2 = _jbatch(), _jbatch(b=4)
        else:
            tr = _trainer(observability=True)
            state = tr.init_state(_params())
            b1, b2 = _batch(), _batch(b=4)
        for _ in range(2):
            state, _ = tr.step(state, *b1)
        tr.reset_metrics()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            state, _ = tr.step(state, *b1)
        seen = [tr.metrics()["retrace_warnings"]]
        with pytest.warns(RuntimeWarning, match="after warmup"):
            state, _ = tr.step(state, *b2)
        seen.append(tr.metrics()["retrace_warnings"])
        seen.append(tr.metrics()["compiles"])
        tr.reset_metrics()
        seen.append(tr.metrics()["retrace_warnings"])
        got[tag] = seen
    assert got["port"] == got["jax"] == [0, 1, 2, 0]


def test_counted_flops_against_jax_watcher():
    """One step's counted FLOPs (the aten products; the CPU route launches
    none of the port's kernels) against the JAX ``CompileWatcher``'s
    cost-analysis ``flops_per_step`` on the same one-layer model and
    batch: within 0.80-1.00 (XLA counts the elementwise work on top of the
    same products; measured 0.919)."""
    jcfg, tcfg = _cfgs(D=64, F=128, L=1, S=32)
    jt = _jtrainer(jcfg, observability=True)
    js = jt.init_state(jllama.init_params(jcfg, jax.random.key(0)))
    js, _ = jt.step(js, *_jbatch(s=16))
    tt = _trainer(tcfg, observability=True)
    ts = tt.init_state(_params(tcfg))
    ts, _ = tt.step(ts, *_batch(s=16))
    j = jt._compile.flops_per_step("train_step")
    t = tt._compile.flops_per_step("train_step")
    assert 0.80 <= t / j <= 1.00, (t, j, t / j)
    assert tt.metrics()["compile"]["programs"]["train_step"]["cost"][
        "kernel_flops"] == 0


def test_trainer_telemetry_matches_jax():
    """``telemetry=TelemetryConfig(sample_every=1)``: both trainers sample
    every step, their expositions lint clean, no alert fires."""
    got = {}
    for tag in ("jax", "port"):
        pkg = jobs if tag == "jax" else tobs
        cfg = pkg.TelemetryConfig(sample_every=1, detectors=())
        if tag == "jax":
            tr = _jtrainer(telemetry=cfg)
            state = tr.init_state(jllama.init_params(CFG, jax.random.key(0)))
            batch = _jbatch()
        else:
            tr = _trainer(telemetry=cfg)
            state = tr.init_state(_params())
            batch = _batch()
        for _ in range(3):
            state, _ = tr.step(state, *batch)
        snap = tr.metrics()["telemetry"]
        text = tr.telemetry.expose()
        assert pkg.lint_exposition(text) == []
        got[tag] = (snap["samples"], snap["alerts"])
    assert got["port"] == got["jax"] == (3, {"page": 0, "ticket": 0})


# -- the flight recorder ---------------------------------------------------

@pytest.fixture
def recorders():
    """Both packages' process-global recorders, disabled again after."""
    yield {"jax": jfr, "port": tfr}
    for fr in (jfr, tfr):
        fr.disable_flight_recorder()
        fr.get_flight_recorder().reset(keep_pending=False)
        fr.get_flight_recorder().dump_path = None


def test_flight_recorder_enable_reset_and_dumps_match_jax(recorders,
                                                          tmp_path):
    """enable_flight_recorder's configure/reset/enable; a pending task
    survives a re-enable; the watchdog pass reports a hang once (then
    stays silent), dumps are retained at most ``max_dumps`` files with
    unique names, later ones counted as suppressed; the dump carries the
    clock base. The same on both packages."""
    got = {}
    for tag, fr in recorders.items():
        base = str(tmp_path / f"{tag}_hang.json")
        # a 60 s timeout while the watchdog thread is up (its first pass
        # comes after 5 s), stopped at once: the test drives check_once
        rec = fr.enable_flight_recorder(timeout=60.0, dump_path=base,
                                        capacity=8, max_dumps=2)
        rec.stop_watchdog()
        t = rec.begin("psum", "dp", (4, 4), "float32")
        rec2 = fr.enable_flight_recorder(timeout=60.0, dump_path=base,
                                         capacity=8, max_dumps=2)
        rec2.stop_watchdog()
        assert rec2 is rec and t in rec.tasks()
        rec.configure(timeout=0.001)
        time.sleep(0.005)
        first = rec.check_once()
        again = rec.check_once()
        for _ in range(3):
            rec.dump("manual")
        rec.end(t)
        names = [pathlib.Path(p).name.replace(tag, "X") if p else p
                 for _, p in rec.dumps]
        report = json.loads(pathlib.Path(base).read_text())
        got[tag] = (first, again, names, rec.dumps_suppressed,
                    sorted(report), sorted(report["clock"]),
                    report["scheduler"]["pending"],
                    [e["op"] for e in report["entries"]])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and got["port"][1] == 0


def test_flight_recorder_bound_to_harness_matches_jax():
    """Observability.bind_flight_recorder: completed collectives feed the
    per-(op, axis) histograms and call/byte counters, the chrome export
    gains the per-rank track."""
    got = {}
    for tag, (pkg, fr) in {"jax": (jobs, jfr), "port": (tobs, tfr)}.items():
        obs = pkg.Observability(histograms=pkg.TRAIN_HISTOGRAMS)
        rec = obs.bind_flight_recorder(fr.FlightRecorder(capacity=16))
        rec.enabled = True
        for op, ax, shape, dt in [("psum", "dp", (8, 16), "float32"),
                                  ("psum", "dp", (8, 16), "float32"),
                                  ("all_gather", "tp", (2, 64), "bfloat16")]:
            rec.end(rec.begin(op, ax, shape, dt))
        host = rec.to_host_events()
        got[tag] = (obs.registry.counters,
                    sorted(k for k in obs.registry.histograms
                           if k.startswith("collective_")),
                    [(e.name, e.tid, e.event_type.name) for e in host])
    assert got["port"] == got["jax"]
    assert got["port"][0]["collective_bytes"] == {"psum@dp": 1024,
                                                 "all_gather@tp": 256}
