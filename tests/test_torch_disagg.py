"""PyTorch/CUDA port, disaggregated prefill/decode serving
(``paddle_tpu_torch/inference/disagg.py``) against the JAX package's
``DisaggregatedEngine`` on the streams of tests/test_disagg.py, on the CPU
(f32, tests/test_disagg.py's model, weights carried across from the JAX
tree).

The JAX groups run on the conftest's virtual CPU devices (``jax.devices()
[:1]`` and ``[1:2]``, as tests/test_disagg.py runs them); the port's both
run on "cpu": meshless (the card's case) or as tp=1 meshes from explicit
device lists. The colocated SLO tests of tests/test_disagg.py hold the
port's ``ServingEngine`` against the JAX one.

Tolerances: greedy ids, every handoff counter, the groups' counters and
the ``metrics()`` keys are EXACT; every handed-off page equals, bit for
bit, the port's own prefill-side page read when its transfer was issued,
and the JAX engine's handed-off page within 1e-5 (f32 products in another
order); the decode group's pools and scales keep their storage
(``data_ptr()``) across a drained stream."""
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
                                        ServingMesh)
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
PAGE_ATOL = 1e-5
# the handoff's counters and the groups' (none of them reads a clock)
HANDOFF_COUNTERS = ("handoffs", "partial_handoffs", "handoff_traces",
                    "kv_bytes_transferred", "requests_submitted",
                    "drain_truncations")
GROUP_COUNTERS = ("decode_traces", "prefill_traces", "calibration_traces",
                  "decode_steps", "prefill_chunks", "prefill_tokens",
                  "live_slot_steps", "tokens_generated",
                  "requests_submitted", "requests_completed",
                  "preemptions", "requeues", "deadline_expired",
                  "drain_truncations")
# tests/test_disagg.py's frozen key set, observability off
DISAGG_BASE_KEYS = {
    "handoffs", "partial_handoffs", "handoff_traces",
    "kv_bytes_transferred", "requests_submitted", "requests_completed",
    "drain_truncations", "wall_time_s", "tokens_generated",
    "tokens_per_sec", "ttft_ms_mean", "ttft_ms_max", "handoff_ms_mean",
    "handoff_ms_max", "scheduler", "groups", "roofline"}
SCHED_KEYS = {"per_class", "slo_attainment", "slo_seen", "slo_attained",
              "queue_depth", "preemptions", "requeues", "deadline_expired",
              "handoff_queue_depth"}


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


ENGINE = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)


def _jcoloc(jp, **kw):
    return jinf.ServingEngine(jp, CFG, **dict(ENGINE, **kw))


def _tcoloc(tp, **kw):
    return ServingEngine(tp, TCFG, device="cpu", **dict(ENGINE, **kw))


def _jdisagg(jp, **kw):
    kw.setdefault("prefill_devices", jax.devices()[:1])
    kw.setdefault("decode_devices", jax.devices()[1:2])
    kw.setdefault("prefill_slots", 2)
    return jinf.DisaggregatedEngine(jp, CFG, **dict(ENGINE, **kw))


def _tdisagg(tp, groups="single", **kw):
    """The port's engine: "single" both groups meshless on "cpu" (the
    card's case); "tp1" explicit one-device lists (tp=1 meshes, as the JAX
    groups)."""
    kw.setdefault("prefill_slots", 2)
    if groups == "single":
        kw.setdefault("device", "cpu")
    elif groups == "tp1":
        kw.setdefault("prefill_devices", ["cpu"])
        kw.setdefault("decode_devices", ["cpu"])
    return DisaggregatedEngine(tp, TCFG, **dict(ENGINE, **kw))


def _g(n):
    return GenerationConfig(max_new_tokens=n, greedy=True)


def _mixed_stream(eng, n=22, seed=7, max_new=5):
    """tests/test_disagg.py's stream: n requests arriving in WAVES
    interleaved with engine steps."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(4, 14, n)
    reqs = []
    for i, s in enumerate(sizes):
        reqs.append(eng.submit(
            rng.randint(0, 97, (int(s),)).astype(np.int32), _g(max_new)))
        if i % 3 == 2:
            eng.step()
            eng.step()
    eng.drain()
    return [r.output_ids.tolist() for r in reqs]


# -- the handed-off pages ----------------------------------------------

def _port_pages(eng, pages):
    """An engine's pages, every layer, both pools, the shards' KV heads
    joined: (k, v) numpy [L, n, BS, KV, hd]."""
    out = []
    for pools in (eng._k_pools, eng._v_pools):
        shards = pools if isinstance(pools, list) else [pools]
        idx = torch.as_tensor(list(pages), dtype=torch.long)
        out.append(torch.cat([p.index_select(1, idx) for p in shards],
                             dim=3).numpy())
    return out


def _watch_port(eng):
    """Record every landed insert's decode-side pages (by request and
    window offset), each checked bit for bit against the prefill-side
    pages read when its transfer was issued."""
    log = {}
    start, complete = eng._start_transfer, eng._complete_transfer

    def started(job):
        st = start(job)
        st["src_bytes"] = _port_pages(eng.prefill,
                                      job.src_pages[job.offset:])
        return st

    def completed(st):
        complete(st)
        if not st["job"].abort:
            got = _port_pages(eng.decode, st["dst"])
            for a, b in zip(got, st["src_bytes"]):
                assert a.tobytes() == b.tobytes(), "handed-off page differs"
            log[(st["job"].req.req_id, st["job"].offset)] = got
    eng._start_transfer, eng._complete_transfer = started, completed
    return log


def _watch_jax(eng):
    log = {}
    complete = eng._complete_transfer

    def completed(st):
        complete(st)
        if not st["job"].abort:
            dst = st["dst_idx"][:st["pages"]]
            log[(st["job"].req.req_id, st["job"].offset)] = [
                np.asarray(p)[:, dst] for p in (eng.decode._k_pools,
                                                eng.decode._v_pools)]
    eng._complete_transfer = completed
    return log


def _pages_held(tlog, jlog):
    assert tlog.keys() == jlog.keys() and tlog
    for key, (tk, tv) in tlog.items():
        jk, jv = jlog[key]
        np.testing.assert_allclose(tk, jk, rtol=0, atol=PAGE_ATOL)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=PAGE_ATOL)


def _storage(eng):
    """The decode group's pools' and scales' addresses."""
    dec = eng.decode
    ts = [*(dec._k_pools if isinstance(dec._k_pools, list)
            else [dec._k_pools]),
          *(dec._v_pools if isinstance(dec._v_pools, list)
            else [dec._v_pools])]
    if dec._kv_scales is not None:
        ts += list(dec._kv_scales) + [s for p in dec._shard_scales
                                      for s in p]
    return [t.data_ptr() for t in ts]


def _counters_held(t, j):
    tm, jm = t.metrics(), j.metrics()
    assert {k: tm[k] for k in HANDOFF_COUNTERS} == \
        {k: jm[k] for k in HANDOFF_COUNTERS}
    for g in ("prefill", "decode"):
        assert {k: tm["groups"][g][k] for k in GROUP_COUNTERS} == \
            {k: jm["groups"][g][k] for k in GROUP_COUNTERS}, g
    for k in ("requests_completed", "tokens_generated"):
        assert tm[k] == jm[k]
    ts, js = tm["scheduler"], jm["scheduler"]
    assert {k: ts[k] for k in SCHED_KEYS - {"per_class"}} == \
        {k: js[k] for k in SCHED_KEYS - {"per_class"}}
    assert {c: v["admitted"] for c, v in ts["per_class"].items()} == \
        {c: v["admitted"] for c, v in js["per_class"].items()}
    return tm


@pytest.fixture(scope="module")
def ref_stream(params):
    """The JAX colocated engine's 22-request stream (the acceptance
    reference of tests/test_disagg.py)."""
    return _mixed_stream(_jcoloc(params[0]))


# -- the disaggregated streams, against the JAX engine ------------------

def _st_mixed(eng):
    return _mixed_stream(eng)


def _st_warm_after_reset(eng):
    """A stream, reset_metrics, another: no new decode or handoff build."""
    _mixed_stream(eng, n=6)
    eng.reset_metrics()
    h0 = eng.counters["handoff_traces"]
    out = _mixed_stream(eng, n=6, seed=11)
    assert eng.counters["handoff_traces"] == h0 == 2
    return out


def _st_prefix_warm(eng):
    """The radix tree on the prefill group across handoffs: a cold stream
    then the same stream warm."""
    return _mixed_stream(eng) + _mixed_stream(eng)


def _st_int8(eng):
    return _mixed_stream(eng, n=8)


def _st_eos_first(eng):
    r = eng.submit(np.arange(1, 9, dtype=np.int32), _g(1))
    eng.drain()
    assert r.done and len(r.tokens) == 1
    return [r.output_ids.tolist()]


def _st_chunked(eng):
    """Prompts longer than the largest bucket: partial windows."""
    rng = np.random.RandomState(9)
    reqs = [eng.submit(rng.randint(0, 97, (21,)).astype(np.int32), _g(6))
            for _ in range(4)]
    eng.drain()
    return [r.output_ids.tolist() for r in reqs]


def _st_abort(eng):
    """A long prompt with a one-token budget ships partials, then the
    abort marker releases its decode-side pages."""
    free0 = len(eng.decode.mgr.free)
    r = eng.submit(np.arange(1, 22, dtype=np.int32), _g(1))
    eng.drain()
    assert not eng.decode.mgr.tables.get(r.req_id)
    assert len(eng.decode.mgr.free) == free0
    return [r.output_ids.tolist()]


def _st_blocked_final(eng):
    """A page-blocked short final ahead of a partially sent long one: the
    allocation-free final must overtake."""
    rng = np.random.RandomState(21)
    tiny = eng.submit(np.arange(1, 5, dtype=np.int32), _g(1))
    long_r = eng.submit(rng.randint(0, 97, (36,)).astype(np.int32), _g(4))
    eng.step()
    eng.step()
    assert long_r.req_id in eng.decode.mgr.tables
    short_r = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(4))
    eng.drain()
    return [r.output_ids.tolist() for r in (tiny, long_r, short_r)]


def _st_preempt(eng):
    """A class-0 handoff preempts a class-2 decode slot on the decode
    group."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 97, (8,)).astype(np.int32) for _ in range(3)]
    r0 = eng.submit(prompts[0], _g(20), priority=2)
    r1 = eng.submit(prompts[1], _g(20), priority=2)
    for _ in range(8):
        eng.step()
    assert not r0.done and not r1.done
    hp = eng.submit(prompts[2], _g(20), priority=0)
    eng.drain()
    assert eng.decode.counters["preemptions"] >= 1
    return [r.output_ids.tolist() for r in (r0, r1, hp)]


def _st_deadline(eng):
    """A request whose deadline passes in the prefill queue expires; SLO
    attainment counts it."""
    rng = np.random.RandomState(8)
    eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(4),
               deadline_s=60.0)
    dead = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(4),
                      deadline_s=0.0)
    eng.drain()
    assert dead.expired and eng.metrics()["scheduler"][
        "slo_attainment"] == 0.5
    return [dead.tokens]


def _st_expiry_only(eng):
    """A drain whose only step expires a request finishes cleanly."""
    dead = eng.submit(np.arange(1, 9, dtype=np.int32), _g(4),
                      deadline_s=0.0)
    eng.drain()
    assert dead.expired and eng.idle
    return [dead.tokens]


# name -> (stream, engine keywords on both sides)
STREAMS = {
    "mixed22": (_st_mixed, {}),
    "warm_after_reset": (_st_warm_after_reset, {}),
    "prefix_cache_warm": (_st_prefix_warm, dict(prefix_cache=True)),
    "int8_pools": (_st_int8, dict(cache_dtype="int8")),
    "eos_first_token": (_st_eos_first, dict(prefill_buckets=(8,))),
    "chunked_partial": (_st_chunked, {}),
    "abort_partial": (_st_abort, {}),
    "blocked_final": (_st_blocked_final, dict(num_blocks=13,
                                              max_seq_len=48)),
    "preempt_decode": (_st_preempt, dict(capacity=2, prefill_slots=1,
                                         prefill_buckets=(8,))),
    "deadline_slo": (_st_deadline, dict(prefill_slots=1,
                                        prefill_buckets=(8,))),
    "expiry_only": (_st_expiry_only, dict(prefill_buckets=(8,))),
}


@pytest.mark.parametrize("name,groups", [(n, "single") for n in STREAMS]
                         + [("mixed22", "tp1"), ("int8_pools", "tp1")])
def test_stream_matches_reference(params, name, groups):
    """Each stream of tests/test_disagg.py through the port's engine and
    the JAX engine: ids, handoff and group counters, scheduler report and
    metrics keys equal; each handed-off page equal to its prefill-side
    page and within 1e-5 of the JAX engine's; the decode group's pools
    and scales never rebound."""
    jp, tp = params
    stream, kw = STREAMS[name]
    j = _jdisagg(jp, **kw)
    jlog = _watch_jax(j)
    want = stream(j)
    t = _tdisagg(tp, groups, **kw)
    tlog = _watch_port(t)
    ptrs = _storage(t)
    got = stream(t)
    assert got == want
    m = _counters_held(t, j)
    assert set(m) == set(j.metrics()) == DISAGG_BASE_KEYS
    if jlog:
        _pages_held(tlog, jlog)
    else:
        assert not tlog
    after = _storage(t)
    assert after[:len(ptrs)] == ptrs
    dm, pm = m["groups"]["decode"], m["groups"]["prefill"]
    assert dm["prefill_chunks"] == 0 and pm["decode_traces"] == 0
    assert dm["decode_traces"] == (1 if dm["decode_steps"] else 0)
    assert all(v == 1 for v in pm["prefill_traces"].values())
    assert not t.prefill._decode_fns and not t.decode._prefill_fns
    if name == "mixed22":
        assert m["handoffs"] == 22 and m["handoff_traces"] == 2
    if name == "prefix_cache_warm":
        assert t.prefill.metrics()["prefix_cache"] == \
            j.prefill.metrics()["prefix_cache"]
        assert t.prefill.metrics()["prefix_cache"]["hits"] > 0
        assert t.prefix_summary() == j.prefix_summary()
    if name == "int8_pools":
        # the scales: the port's prefill group's, copied bit for bit; the
        # JAX engine's calibration forward sums in another order
        for tk, pk, jk in zip(t.decode._kv_scales, t.prefill._kv_scales,
                              j.decode._kv_scales):
            assert torch.equal(tk, pk)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       rtol=1e-6, atol=0)
        assert t.decode._k_pools is not None and (
            (t.decode._k_pools[0] if groups == "tp1"
             else t.decode._k_pools).dtype == torch.int8)
    if name in ("chunked_partial", "abort_partial"):
        assert m["partial_handoffs"] >= 1
    if name in ("eos_first_token", "abort_partial", "expiry_only"):
        assert m["handoffs"] == 0 and dm["decode_steps"] == 0


def test_stream_matches_colocated_reference(params, ref_stream):
    """The acceptance bar of tests/test_disagg.py: the port's engine on
    the 22-request stream equals the JAX colocated engine, with one decode
    build on the decode group, at most one chunk build a bucket on the
    prefill group and the handoff pair built once each."""
    m_got = _mixed_stream(_tdisagg(params[1]))
    assert m_got == ref_stream
    assert _mixed_stream(_tcoloc(params[1])) == ref_stream


@pytest.mark.parametrize("pre,dec,coll", [
    (["cpu"] * 2, ["cpu"] * 2, "gather"),
    (["cpu"], ["cpu"] * 2, "gather"),
    (["cpu"] * 2, ["cpu"], "gather"),
    (["cpu"] * 2, ["cpu"] * 2, "psum"),
])
def test_tp_groups_and_reshard(params, ref_stream, pre, dec, coll):
    """Groups on tp=2 meshes (shards colocated on the CPU) and groups of
    different tp, where the handoff joins the prefill shards' pages on the
    KV-head axis and cuts them for the decode shards: under "gather" the
    ids equal the colocated single-device reference (the placement's
    bit-parity contract), under "psum" a colocated tp=2 "psum" engine
    (the same per-group math); handed-off pages equal their prefill pages
    bit for bit; pools keep their storage."""
    tp = params[1]
    eng = _tdisagg(tp, None, prefill_devices=pre, decode_devices=dec,
                   collective=coll)
    assert eng.prefill._mesh.tp == len(pre)
    assert eng.decode._mesh.tp == len(dec)
    log = _watch_port(eng)
    ptrs = _storage(eng)
    got = _mixed_stream(eng)
    if coll == "gather":
        want = ref_stream
    else:
        want = _mixed_stream(_tcoloc(tp, mesh=ServingMesh.make(
            2, collective="psum", devices=["cpu"] * 2)))
    assert got == want
    assert len(log) == 22 and _storage(eng) == ptrs
    m = eng.metrics()
    assert m["handoff_traces"] == 2
    assert m["groups"]["decode"]["decode_traces"] == 1


def test_async_handoff_lands_next_step(params):
    """Issue at step t, land at the top of step t+1, as in the JAX engine:
    the same queue, in-flight and admission states after each step."""
    jp, tp = params

    def trace(eng):
        eng.submit(np.arange(1, 9, dtype=np.int32), _g(6))
        states = []
        for _ in range(3):
            eng.step()
            states.append((len(eng._handoffs), len(eng._inflight),
                           eng.counters["handoffs"],
                           eng.decode.live_slots))
        eng.drain()
        return states
    want = trace(_jdisagg(jp, prefill_buckets=(8,)))
    assert want == [(1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 1)]
    assert trace(_tdisagg(tp, prefill_buckets=(8,))) == want


def test_inplace_insert_and_scales_keep_storage(params):
    """Regression for the two in-place rules: across a drained int8-pool
    stream the insert writes into the decode pools' storage and
    ``_sync_scales`` binds the decode scales once, before the decode
    group's first step; a handoff that rebinds either fails here."""
    tp = params[1]
    eng = _tdisagg(tp, cache_dtype="int8")
    pools = _storage(eng)
    assert eng.decode._kv_scales is None
    seen = []
    step = eng.decode.step

    def watched():
        if eng.decode._kv_scales is not None:
            seen.append(_storage(eng))
        return step()
    eng.decode.step = watched
    _mixed_stream(eng, n=8)
    assert seen and seen[0][:len(pools)] == pools
    assert all(s == seen[0] for s in seen)
    assert _storage(eng) == seen[0]
    for a, b in zip(eng.decode._kv_scales, eng.prefill._kv_scales):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# -- the colocated engine's SLO admission, against the JAX engine -------

def _co_preempt(eng):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 97, (8,)).astype(np.int32) for _ in range(3)]
    r0 = eng.submit(prompts[0], _g(20), priority=2)
    r1 = eng.submit(prompts[1], _g(20), priority=2)
    for _ in range(5):
        eng.step()
    hp = eng.submit(prompts[2], _g(20), priority=0)
    eng.drain()
    assert hp.first_token_t < max(r0.finish_t, r1.finish_t)
    return [r.output_ids.tolist() for r in (r0, r1, hp)] + [
        [r0.preemptions, r1.preemptions, hp.preemptions]]


def _co_priority(eng):
    rng = np.random.RandomState(5)
    run = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(6),
                     priority=2)
    eng.step()
    eng.step()
    low = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(6),
                     priority=2)
    high = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(6),
                      priority=0)
    eng.step()
    n_pre = eng.metrics()["preemptions"]
    eng.drain()
    assert high.first_token_t < low.first_token_t
    return [r.output_ids.tolist() for r in (run, low, high)] + [[n_pre]]


def _co_starved_head(eng):
    rng = np.random.RandomState(12)
    a = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(25),
                   priority=1)
    eng.step()
    eng.step()
    b = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(4),
                   priority=0)
    c = eng.submit(rng.randint(0, 97, (20,)).astype(np.int32), _g(25),
                   priority=0)
    eng.drain()
    return [r.output_ids.tolist() for r in (a, b, c)] + [[a.preemptions]]


def _co_deadline(eng):
    rng = np.random.RandomState(6)
    run = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(8),
                     deadline_s=60.0)
    eng.step()
    dead = eng.submit(rng.randint(0, 97, (8,)).astype(np.int32), _g(8),
                      deadline_s=0.0)
    eng.drain()
    assert dead.expired and not run.expired
    return [run.output_ids.tolist(), dead.tokens]


def _co_expiry_only(eng):
    dead = eng.submit(np.arange(1, 9, dtype=np.int32), _g(4),
                      deadline_s=0.0)
    assert eng.drain() == 1
    assert dead.expired and eng.idle
    return [dead.tokens]


def _co_gen_defaults(eng):
    g = GenerationConfig(max_new_tokens=4, greedy=True, priority=0,
                         deadline_s=30.0)
    r = eng.submit(np.arange(1, 9, dtype=np.int32), g)
    r2 = eng.submit(np.arange(1, 9, dtype=np.int32), g, priority=2,
                    deadline_s=None)
    return [[r.priority, r.deadline_s, r2.priority, r2.deadline_s]]


COLOCATED = {
    "preempted_resumed": (_co_preempt, dict(capacity=2,
                                            prefill_buckets=(8,))),
    "priority_overtakes": (_co_priority, dict(capacity=1,
                                              prefill_buckets=(8,))),
    "starved_head_resume": (_co_starved_head, dict(
        capacity=1, num_blocks=17, prefill_buckets=(8,))),
    "deadline_expiry": (_co_deadline, dict(capacity=1,
                                           prefill_buckets=(8,))),
    "expiry_only": (_co_expiry_only, {}),
    "gen_config_defaults": (_co_gen_defaults, {}),
}
CO_COUNTERS = ("decode_steps", "prefill_chunks", "tokens_generated",
               "requests_completed", "preemptions", "requeues",
               "deadline_expired")


@pytest.mark.parametrize("name", list(COLOCATED))
def test_colocated_slo_matches_reference(params, name):
    """tests/test_disagg.py's colocated SLO tests through the port's
    ServingEngine and the JAX one: ids, preemption counts and the
    scheduler report equal."""
    jp, tp = params
    stream, kw = COLOCATED[name]
    j, t = _jcoloc(jp, **kw), _tcoloc(tp, **kw)
    assert stream(t) == stream(j)
    tm, jm = t.metrics(), j.metrics()
    assert {k: tm[k] for k in CO_COUNTERS} == {k: jm[k] for k in CO_COUNTERS}
    ts, js = tm["scheduler"], jm["scheduler"]
    assert set(ts) == set(js)
    for k in ("slo_attainment", "slo_seen", "slo_attained", "queue_depth"):
        assert ts[k] == js[k]
    assert {c: v["admitted"] for c, v in ts["per_class"].items()} == \
        {c: v["admitted"] for c, v in js["per_class"].items()}


# -- construction, refusals, schema -------------------------------------

def test_group_resolution_variants(params):
    """The JAX engine's three constructions, on the CPU: explicit lists,
    a split mesh, and the meshless single-device groups; plus the
    refusals."""
    tp = params[1]
    eng = _tdisagg(tp, "tp1")
    assert eng.prefill._mesh.tp == 1 and eng.decode._mesh.tp == 1
    sm = ServingMesh.make(tp=4, collective="gather", devices=["cpu"] * 4)
    eng = DisaggregatedEngine(tp, TCFG, mesh=sm, prefill_tp=2, capacity=2,
                              block_size=4, prefill_buckets=(8,),
                              max_seq_len=32)
    assert eng.prefill._mesh.tp == 2 and eng.decode._mesh.tp == 2
    assert eng.decode._mesh.collective == "gather"
    eng = _tdisagg(tp)
    assert eng.prefill._mesh is None and eng.decode._mesh is None
    assert eng.prefill.device == eng.decode.device == torch.device("cpu")
    # one tree: both groups hold the same parameter tensors
    assert eng.prefill.params["embed_tokens"].data_ptr() == \
        eng.decode.params["embed_tokens"].data_ptr()
    with pytest.raises(ValueError, match="split"):
        ServingMesh.make(tp=2, devices=["cpu"] * 2).split(2)
    with pytest.raises(ValueError, match="non-empty"):
        DisaggregatedEngine(tp, TCFG, prefill_devices=["cpu"],
                            decode_devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 device"):
            DisaggregatedEngine(tp, TCFG, mesh=4, prefill_tp=2)


def test_groups_on_two_cards_refused():
    """A prefill and a decode group on different cards wait for the
    multi-card backend; the refusal cites ROADMAP A10(b)/A11."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    with pytest.raises(ValueError, match=r"A10\(b\)/A11"):
        DisaggregatedEngine._check_one_device((cuda[0], cuda[1]))
    with pytest.raises(ValueError, match=r"A10\(b\)/A11"):
        DisaggregatedEngine._check_one_device((torch.device("cpu"),
                                               cuda[0]))
    DisaggregatedEngine._check_one_device((cuda[0], cuda[0],
                                           torch.device("cuda", 0)))


def test_entry_point_defaults_to_cuda(params):
    """Without device= the engine runs on CUDA; with no card it raises
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DisaggregatedEngine(params[1], TCFG, **ENGINE)


def test_oversized_request_rejected_against_decode_pool(params):
    eng = _tdisagg(params[1], num_blocks=4)
    with pytest.raises(ValueError, match="DECODE"):
        eng.submit(np.arange(1, 30, dtype=np.int32), _g(20))


def test_weight_quant_once_for_both_groups(params):
    """weight_quant quantizes the tree once: both groups serve the same
    quantized leaves, and the ids equal the JAX engine's."""
    jp, tp = params
    t = _tdisagg(tp, weight_quant="int8")
    assert t.prefill._wq == t.decode._wq == "int8"
    leaf = t.prefill.params["layers"]["q_proj"]
    assert leaf["qw8"].data_ptr() == \
        t.decode.params["layers"]["q_proj"]["qw8"].data_ptr()
    assert _mixed_stream(t, n=6) == _mixed_stream(
        _jdisagg(jp, weight_quant="int8"), n=6)


@pytest.mark.parametrize("call,item", [
    ("observability", "A8"), ("telemetry", "A8"),
    ("export_trace", "A8"), ("write_timeline", "A8"),
    ("program_specs", "A12"), ("audit", "A12")])
def test_later_slices_raise_with_their_item(params, tmp_path, call, item):
    """tests/test_disagg.py's catalog-audit and engine-audit tests, and
    the A8 surfaces: all ported since. The A8 surfaces are held against the
    JAX engine in tests/test_torch_observability.py: the engine builds its
    harness and plane, and the exports write their files, or raise
    "disabled" on an engine built without observability, as the JAX
    engine's do. The A12 calls return the JAX engine's program names (the
    specs) and a clean report each (the audit), counted in
    ``audit_findings``."""
    tp = params[1]
    if item == "A8":
        if call in ("observability", "telemetry"):
            eng = _tdisagg(tp, **{call: True})
            assert eng.observability is not None
            assert (eng.telemetry is not None) == (call == "telemetry")
            return
        path = str(tmp_path / "trace.json")
        with pytest.raises(RuntimeError, match="disabled"):
            getattr(_tdisagg(tp), call)(path)
        eng = _tdisagg(tp, observability=True)
        _mixed_stream(eng, n=3)
        assert getattr(eng, call)(path) == path
        text = open(path).read()
        if call == "export_trace":
            assert json.loads(text)["traceEvents"]
        else:
            assert json.loads(text.splitlines()[0])["kind"] == "meta"
        return
    eng = _tdisagg(tp)
    out = getattr(eng, call)(register=False)
    names = sorted(getattr(x, "name", getattr(x, "program", None))
                   for x in out)
    assert names == ["disagg_decode", "disagg_kv_extract",
                     "disagg_kv_insert", "disagg_prefill_16",
                     "disagg_prefill_8"]
    if call == "audit":
        assert all(r.findings == [] for r in out)
        assert eng.counters["audit_findings"] == 0


def test_metrics_schema_and_reset(params):
    """The frozen key set with observability off, the scheduler's keys,
    and reset_metrics restarting the window."""
    eng = _tdisagg(params[1], prefill_buckets=(16,))
    _mixed_stream(eng, n=4)
    m = eng.metrics()
    assert set(m) == DISAGG_BASE_KEYS and set(m["scheduler"]) == SCHED_KEYS
    assert set(m["groups"]) == {"prefill", "decode"}
    assert m["roofline"]["active"] == "unfused"
    assert m["handoff_ms_mean"] is not None and m["ttft_ms_mean"] is not None
    eng.reset_metrics()
    _mixed_stream(eng, n=3, seed=9)
    m = eng.metrics()
    assert m["handoffs"] == 3 and m["requests_submitted"] == 3
    assert m["handoff_traces"] == 2
    snap = eng.scheduler_snapshot()
    assert set(snap) == {"handoff_queue_depth", "handoff_inflight",
                         "handoffs_pending", "prefill", "decode"}
