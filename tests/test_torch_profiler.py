"""The port's profiler (``paddle_tpu_torch/profiler/``) against the JAX
package's on the CPU: the scheduler's state sequence, the host tracer's
events across scheduler-driven recording cycles, the Chrome trace writer,
the summary tables over the same events and the ips timer must agree
(event times masked; tolerance 0 on counts and states). The GPU target
without a card records the host events and writes no device trace, as the
JAX package's TPU target does on an unsupported backend; on the card
``chip_smoke.py``'s obs phase holds the device trace to the train route's
kernel names."""
import json

import pytest

import paddle_tpu.profiler as jprof
from paddle_tpu.profiler import statistics as jstats
from paddle_tpu.profiler import timer as jtimer
import paddle_tpu_torch.profiler as tprof
from paddle_tpu_torch.profiler import statistics as tstats
from paddle_tpu_torch.profiler import timer as ttimer

pytestmark = pytest.mark.torch_port

PKGS = {"jax": jprof, "port": tprof}


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=2, skip_first=1),
    dict(closed=0, ready=0, record=1),
    dict(closed=2, ready=1, record=3, repeat=0, skip_first=3),
    dict(closed=0, ready=1, record=1, repeat=2),
])
def test_scheduler_matches_jax(kw):
    got = {tag: [int(pkg.make_scheduler(**kw)(i)) for i in range(20)]
           for tag, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


def test_scheduler_refusals_match_jax():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="record >=1"):
            pkg.make_scheduler(closed=0, ready=0, record=0)


def _cycle_run(pkg, tmp_path, tag):
    """A scheduler-driven run (tests/test_profiler.py's): RecordEvent
    scopes in each step, the on-ready callback writing each cycle."""
    exported = []

    def on_ready(prof):
        path = tmp_path / f"{tag}{len(exported)}.json"
        prof._export_chrome(str(path))
        exported.append(path)

    sched = pkg.make_scheduler(closed=0, ready=1, record=2, repeat=2)
    p = pkg.Profiler(targets=[pkg.ProfilerTarget.CPU], scheduler=sched,
                     on_trace_ready=on_ready)
    states = []
    p.start()
    for i in range(8):
        with pkg.RecordEvent(f"work{i % 2}"):
            pass
        states.append(int(p.current_state))
        p.step(num_samples=4)
    p.stop()
    traces = []
    for path in exported:
        evs = json.loads(path.read_text())["traceEvents"]
        traces.append([(e["name"], e["ph"], e.get("cat")) for e in evs])
    return states, traces


def test_profiler_cycles_match_jax(tmp_path):
    """The same states step by step, the same cycles exported, each
    trace with the same events (names, phases, categories)."""
    got = {tag: _cycle_run(pkg, tmp_path, tag) for tag, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"][1]) == 2
    for pkg in PKGS.values():
        pkg.get_host_tracer().clear()


def test_export_chrome_tracing_matches_jax(tmp_path):
    """``export_chrome_tracing(dir)`` as the on-ready callback: one file a
    cycle in ``dir``, the user scope and the step spans in it."""
    got = {}
    for tag, pkg in PKGS.items():
        d = tmp_path / tag
        with pkg.Profiler(targets=[pkg.ProfilerTarget.CPU],
                          on_trace_ready=pkg.export_chrome_tracing(str(d))
                          ) as p:
            with pkg.RecordEvent("user_scope"):
                pass
            p.step()
        files = sorted(d.iterdir())
        names = [e.get("name") for e in
                 json.loads(files[0].read_text())["traceEvents"]]
        got[tag] = (len(files), [n for n in names
                                 if n in ("user_scope", "ProfileStep#0",
                                          "process_name")])
        pkg.get_host_tracer().clear()
    assert got["port"] == got["jax"]
    assert "user_scope" in got["port"][1]


def test_write_chrome_trace_matches_jax(tmp_path):
    """The shared trace writer over the same host events and extra
    counter events: equal JSON but the pid."""
    got = {}
    for tag, pkg in PKGS.items():
        from importlib import import_module
        re_ = import_module(pkg.__name__ + ".record_event")
        evs = [re_.HostEvent("a", 1000, 3500, re_.TracerEventType.Forward,
                             tid=3),
               re_.HostEvent("b", 2000, 2100)]
        path = tmp_path / f"{tag}.json"
        pkg.write_chrome_trace(str(path), evs, process_name="x",
                               extra_events=[{"name": "c", "ph": "C",
                                              "ts": 1.0, "args": {"v": 2}}])
        data = json.loads(path.read_text())
        for e in data["traceEvents"]:
            e.pop("pid")
        got[tag] = data
    assert got["port"] == got["jax"]


def test_summary_tables_match_jax():
    """``aggregate``, ``build_summary`` and ``event_type_summary`` over the
    same events: equal tables."""
    evs = {}
    for tag, pkg in PKGS.items():
        from importlib import import_module
        re_ = import_module(pkg.__name__ + ".record_event")
        T = re_.TracerEventType
        evs[tag] = [re_.HostEvent("alpha", 0, 1_500_000, T.Forward),
                    re_.HostEvent("alpha", 0, 500_000, T.Forward),
                    re_.HostEvent("beta", 10, 2_000_010, T.Backward),
                    re_.HostEvent("gamma" * 12, 5, 105, T.UserDefined)]
    for unit in ("ms", "us"):
        assert tstats.build_summary(evs["port"], unit) == \
            jstats.build_summary(evs["jax"], unit)
        assert tstats.event_type_summary(evs["port"], unit) == \
            jstats.event_type_summary(evs["jax"], unit)
    assert tstats.aggregate(evs["port"]) == jstats.aggregate(evs["jax"])
    assert tstats.build_summary([]) == jstats.build_summary([])


def test_benchmark_timer_matches_jax():
    """The ips timer's bookkeeping: the same step counts and sample
    totals; its text carries the same fields."""
    got = {}
    for tag, tm in (("jax", jtimer), ("port", ttimer)):
        bm = tm.Benchmark()
        bm.begin()
        bm.before_reader()
        bm.after_reader()
        for _ in range(3):
            bm.step(num_samples=32)
        bm.end()
        got[tag] = (bm.total_steps, len(bm.batch_cost._records),
                    sum(n for _, n in bm.batch_cost._records),
                    len(bm.reader_cost._records),
                    [f.split(":")[0] for f in bm.step_info().split(", ")])
    assert got["port"] == got["jax"]


def test_gpu_target_without_card_records_host_events(tmp_path):
    """With no CUDA card the GPU target records the host events and
    writes no device trace (the JAX TPU target's unsupported-backend
    case); the trace directory is the one given."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's obs phase holds "
                    "the device trace")
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU,
                                tprof.ProfilerTarget.GPU],
                       trace_dir=str(tmp_path / "dev"))
    with p:
        with tprof.RecordEvent("scope"):
            pass
        p.step()
    names = [e.name for e in tprof.get_host_tracer().events()]
    assert "scope" in names and "ProfileStep#0" in names
    assert p.device_trace_path is None and not p._device_tracing
    assert p._trace_dir == str(tmp_path / "dev")
    assert "scope" in p.summary()
    tprof.get_host_tracer().clear()


def test_targets_are_cpu_and_gpu():
    assert [t.name for t in tprof.ProfilerTarget] == ["CPU", "GPU"]
    assert [t.name for t in jprof.ProfilerTarget] == ["CPU", "TPU"]
    assert {s.name for s in tprof.ProfilerState} == \
        {s.name for s in jprof.ProfilerState}
