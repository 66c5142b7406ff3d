"""PyTorch/CUDA port, the fleet router (``paddle_tpu_torch/inference/
fleet.py``) and the host-RAM KV tier under it, against the JAX package's
``ServingFleet`` on the streams of tests/test_fleet.py, on the CPU (f32,
tests/test_fleet.py's model, weights carried across from the JAX tree).

Every fleet is built twice, of the same kinds in the same order: the port's
replicas on "cpu" (a disaggregated replica's groups meshless there, the
card's case), the JAX replicas on the conftest's virtual CPU devices (a
disaggregated replica on ``jax.devices()[:1]`` and ``[1:2]``, as
tests/test_fleet.py builds it).

Tolerances: greedy ids, the routing counters (warm, cold, diverted, per
replica), the summed host-tier report, the replicas' prefix-cache
counters and the ``metrics()`` keys are EXACT; a restored page equals its
spilled bytes bit for bit."""
import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (DisaggregatedEngine,
                                        GenerationConfig, ServingEngine,
                                        ServingFleet)
from paddle_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port

CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=160, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
ENGINE = dict(capacity=2, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)
UNDERSIZED = dict(capacity=2, num_blocks=14, max_seq_len=32)
# tests/test_fleet.py's frozen key sets, observability off
FLEET_BASE_KEYS = {
    "replicas_n", "requests_submitted", "requests_completed",
    "tokens_generated", "tokens_per_sec", "wall_time_s", "fleet_steps",
    "drain_truncations", "ttft_ms_mean", "ttft_ms_max", "routing",
    "offload", "replicas", "roofline"}
ROUTING_KEYS = {"policy", "warm", "cold", "diverted", "warm_hit_ratio",
                "per_replica"}
OFFLOAD_KEYS = {"spilled_pages", "restored_pages", "readopted_pages",
                "host_evicted_pages", "host_pages", "spill_bytes",
                "restore_bytes"}


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


class _Kinds:
    """Builds one package's engines: ``coloc(**kw)``, ``disagg(**kw)``
    and ``fleet(replicas, **kw)``."""

    def __init__(self, port: bool, tree):
        self.port, self.tree = port, tree

    def coloc(self, **kw):
        kw = dict(ENGINE, **kw)
        if self.port:
            return ServingEngine(self.tree, TCFG, device="cpu", **kw)
        return jinf.ServingEngine(self.tree, CFG, **kw)

    def disagg(self, **kw):
        kw = dict(ENGINE, prefill_slots=1, **kw)
        if self.port:
            return DisaggregatedEngine(self.tree, TCFG, device="cpu", **kw)
        return jinf.DisaggregatedEngine(
            self.tree, CFG, prefill_devices=jax.devices()[:1],
            decode_devices=jax.devices()[1:2], **kw)

    def fleet(self, replicas, **kw):
        return (ServingFleet if self.port else jinf.ServingFleet)(
            replicas, **kw)


def _both(params):
    return _Kinds(False, params[0]), _Kinds(True, params[1])


def _g(n):
    return GenerationConfig(max_new_tokens=n, greedy=True)


def _stream(fleet_or_eng, n=30, seed=7, max_new=5):
    """tests/test_fleet.py's stream: n greedy requests arriving in waves
    interleaved with steps."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(4, 15, n)
    reqs = []
    for i, s in enumerate(sizes):
        reqs.append(fleet_or_eng.submit(
            rng.randint(0, 97, (int(s),)).astype(np.int32), _g(max_new)))
        if i % 3 == 2:
            fleet_or_eng.step()
            fleet_or_eng.step()
    fleet_or_eng.drain()
    return [r.output_ids.tolist() for r in reqs]


def _routing_held(t, j):
    tm, jm = t.metrics(), j.metrics()
    assert set(tm) == set(jm) == FLEET_BASE_KEYS
    tr, jr = tm["routing"], jm["routing"]
    assert set(tr) == ROUTING_KEYS
    assert tr == jr
    assert tm["offload"] == jm["offload"] and set(tm["offload"]) == \
        OFFLOAD_KEYS
    for k in ("replicas_n", "requests_submitted", "requests_completed",
              "tokens_generated", "fleet_steps", "drain_truncations"):
        assert tm[k] == jm[k], k
    for name, rm in tm["replicas"].items():
        if "prefix_cache" in rm:
            assert rm["prefix_cache"] == jm["replicas"][name][
                "prefix_cache"], name
    return tm


# -- the acceptance stream: mixed-kind parity ----------------------------

def test_fleet_mixed_engine_kinds_match_reference(params):
    """A prefix-cached colocated replica and a prefix-cached disaggregated
    one: the 30-request stream cold and then warm (after reset_metrics)
    through the port's fleet and the JAX fleet: ids, routing counters and
    both replicas' prefix-cache counters equal; the ids equal the JAX
    colocated engine's; one decode build on each replica, the handoff pair
    built once."""
    (jk, tk) = _both(params)
    ref = _stream(jk.coloc(capacity=3))
    runs = []
    for k in (jk, tk):
        fleet = k.fleet([("coloc", k.coloc(prefix_cache=True)),
                         ("disagg", k.disagg(prefix_cache=True))])
        cold = _stream(fleet)
        cold_routing = fleet.metrics()["routing"]
        fleet.reset_metrics()
        warm = _stream(fleet)
        runs.append((fleet, cold, cold_routing, warm))
    (j, jcold, jrc, jwarm), (t, tcold, trc, twarm) = runs
    assert tcold == jcold == ref and twarm == jwarm == ref
    assert trc == jrc and trc["per_replica"]["coloc"]["routed"] > 0 \
        and trc["per_replica"]["disagg"]["routed"] > 0
    m = _routing_held(t, j)
    assert m["routing"]["warm"] > 0 and m["requests_completed"] == 30
    assert m["replicas"]["coloc"]["decode_traces"] == 1
    assert m["replicas"]["disagg"]["groups"]["decode"]["decode_traces"] == 1
    assert m["replicas"]["disagg"]["handoff_traces"] == 2
    assert set(m["roofline"]) == {"coloc", "disagg"}


# -- routing ---------------------------------------------------------------

def _rt_affinity(k):
    """Cold placement spreads, warm requests land on the replica that
    holds their prefix."""
    rng = np.random.RandomState(1)
    fleet = k.fleet([k.coloc(prefix_cache=True),
                     k.coloc(prefix_cache=True)])
    a = rng.randint(0, 97, (12,)).astype(np.int32)
    b = rng.randint(0, 97, (12,)).astype(np.int32)
    reqs = [fleet.submit(a, _g(3)), fleet.submit(b, _g(3))]
    fleet.drain()
    for p in (a, b):
        reqs.append(fleet.submit(np.concatenate(
            [p, rng.randint(0, 97, (4,))]).astype(np.int32), _g(3)))
    fleet.drain()
    m = fleet.metrics()
    assert m["routing"]["warm"] == 2 and \
        m["routing"]["warm_hit_ratio"] == 0.5
    return fleet, reqs


def _rt_policies(k):
    """round_robin alternates; least_loaded takes the idle replica."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 97, (6,)).astype(np.int32) for _ in range(4)]
    rr = k.fleet([k.coloc(), k.coloc()], policy="round_robin")
    reqs = [rr.submit(p, _g(2)) for p in prompts]
    per = rr.metrics()["routing"]["per_replica"]
    assert per["replica0"]["routed"] == per["replica1"]["routed"] == 2
    rr.drain()
    ll = k.fleet([k.coloc(), k.coloc()], policy="least_loaded")
    reqs += [ll.submit(p, _g(2)) for p in prompts[:2]]
    assert ll._replicas[1].routed == 1
    ll.drain()
    return rr, reqs


def _rt_backpressure(k):
    """A warm request whose home replica's queue is full diverts."""
    rng = np.random.RandomState(3)
    eng0 = k.coloc(capacity=1, prefix_cache=True)
    eng1 = k.coloc(capacity=1, prefix_cache=True)
    fleet = k.fleet([eng0, eng1], max_queue_depth=1)
    a = rng.randint(0, 97, (12,)).astype(np.int32)
    reqs = [fleet.submit(a, _g(4))]
    fleet.drain()
    reqs += [eng0.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(4))
             for _ in range(2)]
    reqs.append(fleet.submit(np.concatenate(
        [a, rng.randint(0, 97, (4,))]).astype(np.int32), _g(4)))
    assert fleet.metrics()["routing"]["diverted"] == 1
    fleet.drain()
    return fleet, reqs


def _rt_shorter_match(k):
    """A saturated best-match home: an open replica with a SHORTER warm
    match beats cold placement."""
    rng = np.random.RandomState(7)
    eng0, eng1, eng2 = (k.coloc(capacity=1, prefix_cache=True)
                        for _ in range(3))
    fleet = k.fleet([eng0, eng1, eng2], max_queue_depth=1)
    a = rng.randint(0, 97, (12,)).astype(np.int32)
    reqs = [fleet.submit(a, _g(3))]
    fleet.drain()
    reqs.append(eng1.submit(a[:8], _g(3)))
    eng1.drain()
    reqs += [eng0.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(3))
             for _ in range(2)]
    reqs.append(fleet.submit(np.concatenate(
        [a, rng.randint(0, 97, (4,))]).astype(np.int32), _g(3)))
    m = fleet.metrics()["routing"]
    assert m["diverted"] == 1 and m["warm"] == 1
    assert m["per_replica"]["replica1"]["routed"] == 1
    fleet.drain()
    return fleet, reqs


def _rt_offload_sum(k):
    """The fleet's host-tier report sums every replica's."""
    rng = np.random.RandomState(8)
    fleet = k.fleet([k.coloc(prefix_cache=True, kv_offload=True,
                             **UNDERSIZED) for _ in range(2)])
    reqs = [fleet.submit(rng.randint(0, 97, (16,)).astype(np.int32), _g(4))
            for _ in range(8)]
    fleet.drain()
    off = fleet.metrics()["offload"]
    assert off["spilled_pages"] > 0 and off["spill_bytes"] > 0
    assert off["spilled_pages"] == sum(
        r.engine.offload_metrics()["spilled_pages"]
        for r in fleet._replicas)
    return fleet, reqs


ROUTING = {"prefix_affinity": _rt_affinity, "policies": _rt_policies,
           "backpressure_divert": _rt_backpressure,
           "divert_shorter_match": _rt_shorter_match,
           "offload_aggregation": _rt_offload_sum}


@pytest.mark.parametrize("name", list(ROUTING))
def test_routing_matches_reference(params, name):
    """tests/test_fleet.py's routing streams through both fleets: ids,
    routing counters, host-tier report and prefix-cache counters equal."""
    jk, tk = _both(params)
    (j, jreqs), (t, treqs) = ROUTING[name](jk), ROUTING[name](tk)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.done for r in treqs)
    _routing_held(t, j)


def test_fleet_validation(params):
    tk = _Kinds(True, params[1])
    eng = tk.coloc()
    with pytest.raises(ValueError, match="at least one"):
        ServingFleet([])
    with pytest.raises(ValueError, match="duplicate"):
        ServingFleet([("a", eng), ("a", tk.coloc())])
    with pytest.raises(ValueError, match="twice"):
        ServingFleet([eng, eng])
    with pytest.raises(ValueError, match="policy"):
        ServingFleet([eng], policy="random")
    with pytest.raises(ValueError, match="max_queue_depth"):
        ServingFleet([eng], max_queue_depth=0)


# -- the host-RAM KV tier under the router ---------------------------------

def _off_spill_restore(eng, rng):
    """The whole tree spilled, then hit again: restored bytes equal the
    spilled ones, refcounts and conservation hold."""
    p = rng.randint(0, 97, (12,)).astype(np.int32)
    r1 = eng.submit(p, _g(4))
    eng.drain()
    pc = eng._pcache
    full, _, _ = pc.match(p)
    before = [(np.asarray(eng._k_pools[:, nd.page]),
               np.asarray(eng._v_pools[:, nd.page])) for nd in full]
    spilled = pc.evict(100)
    assert spilled >= 3 and pc.cached_pages == 0
    assert len(eng.mgr.free) + 1 == eng.num_blocks
    r2 = eng.submit(p, _g(4))
    eng.drain()
    full2, _, _ = pc.match(p)
    restored = [(np.asarray(eng._k_pools[:, nd.page]),
                 np.asarray(eng._v_pools[:, nd.page])) for nd in full2[:2]]
    for (kb, vb), (kr, vr) in zip(before[:2], restored):
        assert kb.tobytes() == kr.tobytes() and vb.tobytes() == vr.tobytes()
    return [r1, r2]


def _off_pressure(eng, rng):
    """An undersized pool spills instead of dropping, then serves the
    first prompt warm from the host tier."""
    reqs = [eng.submit(rng.randint(0, 97, (16,)).astype(np.int32), _g(4))
            for _ in range(6)]
    eng.drain()
    assert eng.metrics()["prefix_cache"]["evicted_pages"] == 0
    reqs.append(eng.submit(reqs[0].prompt, _g(4)))
    eng.drain()
    assert eng.metrics()["prefix_cache"]["restored_pages"] > 0
    return reqs


def _off_budget(eng, rng):
    """kv_offload=<int> caps the host tier: the LRU spilled node dies."""
    reqs = [eng.submit(rng.randint(0, 97, (16,)).astype(np.int32), _g(4))
            for _ in range(6)]
    eng.drain()
    m = eng.metrics()["prefix_cache"]
    assert m["host_evicted_pages"] > 0 and m["host_pages"] <= 2
    return reqs


OFFLOAD = {"spill_restore": (_off_spill_restore, 4, dict(kv_offload=True)),
           "eviction_pressure": (_off_pressure, 5,
                                 dict(UNDERSIZED, kv_offload=True)),
           "host_budget": (_off_budget, 6, dict(UNDERSIZED, kv_offload=2))}


@pytest.mark.parametrize("name", list(OFFLOAD))
def test_offload_tier_matches_reference(params, name):
    """tests/test_fleet.py's host-tier streams on one engine of each
    package: ids, the prefix-cache counters, ``offload_metrics()`` and the
    offload counters equal; both checks clean after the stream."""
    stream, seed, kw = OFFLOAD[name]
    jk, tk = _both(params)
    j = jk.coloc(prefix_cache=True, **kw)
    t = tk.coloc(prefix_cache=True, **kw)
    jr = stream(j, np.random.RandomState(seed))
    tr = stream(t, np.random.RandomState(seed))
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert t.metrics()["prefix_cache"] == j.metrics()["prefix_cache"]
    assert t.offload_metrics() == j.offload_metrics()
    for k in ("offload_traces", "kv_spill_bytes", "kv_restore_bytes"):
        assert t.counters[k] == j.counters[k], k
    assert t.mgr.check(False) == [] and t._pcache.check(False) == []


def test_offload_requires_prefix_cache(params):
    with pytest.raises(ValueError, match="prefix_cache"):
        _Kinds(True, params[1]).coloc(kv_offload=True)


# -- schema and the surfaces of later slices -------------------------------

def test_fleet_metrics_schema_frozen(params):
    """The key sets with observability off, the port's against the JAX
    fleet's, and reset_metrics restarting the window."""
    jk, tk = _both(params)
    fleets = [k.fleet([k.coloc(), k.coloc()]) for k in (jk, tk)]
    for f in fleets:
        _stream(f, n=4)
    _routing_held(fleets[1], fleets[0])
    t = fleets[1]
    assert set(t.metrics()["roofline"]) == {"replica0", "replica1"}
    t.reset_metrics()
    _stream(t, n=3, seed=9)
    m = t.metrics()
    assert m["requests_submitted"] == 3 and m["routing"]["cold"] == 3
    assert set(t.scheduler_snapshot()) == {"policy", "queue_depths",
                                           "live_slots", "replicas"}


@pytest.mark.parametrize("call,item", [
    ("observability", "A8"), ("telemetry", "A8"),
    ("write_timeline", "A8"), ("export_trace", "A8"),
    ("program_specs", "A12"), ("audit", "A12")])
def test_later_slices_raise_with_their_item(params, tmp_path, call, item):
    """tests/test_fleet.py's catalog-audit and engine-audit tests, and
    the A8 surfaces: all ported since. The A8 surfaces are held against the
    JAX fleet in tests/test_torch_observability.py: the fleet builds its
    harness and plane, and the exports write their files, or raise
    "disabled" on a fleet built without observability, as the JAX fleet's
    do. The A12 calls: the specs carry the JAX fleet's names
    (``fleet.<replica>.<program>``), the audit a clean report each,
    counted in ``audit_findings``."""
    tk = _Kinds(True, params[1])
    reps = [tk.coloc(prefix_cache=True, kv_offload=True)]
    if item == "A8":
        if call in ("observability", "telemetry"):
            fleet = ServingFleet(reps, **{call: True})
            assert fleet.observability is not None
            assert (fleet.telemetry is not None) == (call == "telemetry")
            return
        path = str(tmp_path / "trace")
        with pytest.raises(RuntimeError, match="disabled"):
            getattr(ServingFleet(reps), call)(path)
        fleet = ServingFleet([tk.coloc(prefix_cache=True,
                                       kv_offload=True)],
                             observability=True)
        _stream(fleet, n=3)
        assert getattr(fleet, call)(path) == path
        text = open(path).read()
        if call == "export_trace":
            assert json.loads(text)["traceEvents"]
        else:
            assert json.loads(text.splitlines()[0])["fleet"] is True
        return
    fleet = ServingFleet(reps)
    out = getattr(fleet, call)(register=False)
    if call == "program_specs":
        assert sorted(s.name for s in out) == sorted(
            f"fleet.replica0.{s.name}"
            for s in reps[0].program_specs(register=False))
        assert "fleet.replica0.serving_kv_restore_insert" in \
            {s.name for s in out}
    else:
        assert out and all(r.findings == [] for r in out)
        assert fleet.counters["audit_findings"] == 0
