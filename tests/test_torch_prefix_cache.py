"""PyTorch/CUDA port, radix prefix cache: the port's ``BlockManager`` and
``PrefixCache`` against the JAX package's through the same operations
(tests/test_prefix_cache.py's refcount and radix cases, and the parts the
port added with them: the reclaim hook, ``append_token``,
``table_array``, the host tier's spill/restore and its budget); the
port's ``ServingEngine(prefix_cache=True)`` against the JAX engine on the
streams of tests/test_prefix_cache.py, and with ``kv_offload`` on the
spill/restore streams of tests/test_fleet.py, on the CPU (f32, weights
carried across from the JAX tree).

Tolerances: the host bookkeeping is compared exactly (refcounts, free
lists, tables, ``summary()``, ``metrics()``, ``check()`` after every
operation); greedy ids and every prefix/offload counter are equal; a
restored page equals its spilled bytes bit for bit, and the port's pages
hold the JAX engine's within 1e-5 (f32 products in another order)."""
import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.inference.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.paged_attention import BlockManager as JBlockManager
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        ServingMesh, generate)
from paddle_tpu_torch.inference.prefix_cache import PrefixCache
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
from paddle_tpu_torch.ops.paged_attention import BlockManager

pytestmark = pytest.mark.torch_port

# tests/test_prefix_cache.py's model, and tests/test_fleet.py's
CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, dtype=jnp.float32,
                         remat=False)
FLEET_CFG = dataclasses.replace(CFG, num_key_value_heads=4,
                                max_position_embeddings=160)
PAGE_ATOL = 1e-5


def _port_cfg(cfg):
    return tllama.LlamaConfig(
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(tllama.LlamaConfig)
           if f.name != "dtype"}, dtype=torch.float32)


def _trees(cfg):
    jp = jllama.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


@pytest.fixture(scope="module")
def params():
    return _trees(CFG)


@pytest.fixture(scope="module")
def fleet_params():
    return _trees(FLEET_CFG)


# ---------------------------------------------------------------------------
# the allocator and the tree, operation by operation
# ---------------------------------------------------------------------------
JAX_NS = types.SimpleNamespace(BlockManager=JBlockManager,
                               PrefixCache=JPrefixCache)
PORT_NS = types.SimpleNamespace(BlockManager=BlockManager,
                                PrefixCache=PrefixCache)


class Trace:
    """Records, after every operation, the operation's result and the
    state of the allocator and the tree."""

    def __init__(self):
        self.mgr = self.cache = None
        self.rows = []

    def __call__(self, label, value=None):
        mgr, cache = self.mgr, self.cache
        row = {"op": label, "value": value,
               "refcount": mgr.refcount.tolist(), "free": list(mgr.free),
               "tables": {k: list(v) for k, v in mgr.tables.items()},
               "check": mgr.check(raise_on_violation=False)}
        if cache is not None:
            row.update(summary=cache.summary(), metrics=cache.metrics(),
                       tree_check=cache.check(raise_on_violation=False),
                       version=cache.version)
        self.rows.append(row)
        return value

    def error(self, label, fn):
        try:
            fn()
        except RuntimeError as e:
            return self(label, ("raised", str(e)))
        return self(label, "returned")


def _tree(ns, tr, num_blocks=32, bs=4, offload=False, budget=None):
    """tests/test_prefix_cache.py's ``_tree``; ``offload`` adds a host
    tier whose payloads are ("host", page) and whose restores are
    recorded."""
    tr.mgr = mgr = ns.BlockManager(num_blocks, bs, num_blocks)
    copies = []
    kw = {}
    if offload:
        def spill(pages):
            return [("host", int(p)) for p in pages]

        def restore(payloads, dsts):
            copies.append(("restore", list(payloads), list(dsts)))
        kw = dict(spill_pages=spill, restore_pages=restore,
                  host_budget_pages=budget)
    tr.cache = cache = ns.PrefixCache(
        mgr, bs, copy_page=lambda s, d: copies.append((s, d)), **kw)
    return mgr, cache, copies


def _insert_released(mgr, cache, toks, pages):
    cache.insert(toks, pages)
    for p in pages:
        mgr.decref(p)


def _nodes(got):
    full, tail, c = got
    return ([n.page for n in full], None if tail is None else tail.page, c)


def case_refcount_never_negative(ns, tr):
    tr.mgr = mgr = ns.BlockManager(4, 4, 4)
    p = tr("alloc", mgr.alloc_page())
    tr("decref", mgr.decref(p))
    tr.error("decref again", lambda: mgr.decref(p))


def case_incref_on_free_page_rejected(ns, tr):
    tr.mgr = mgr = ns.BlockManager(4, 4, 4)
    p = tr("alloc", mgr.alloc_page())
    tr("decref", mgr.decref(p))
    tr.error("incref", lambda: mgr.incref(p))


def case_shared_page_survives_one_release(ns, tr):
    tr.mgr = mgr = ns.BlockManager(8, 4, 8)
    t1 = tr("allocate 1", list(mgr.allocate(1, 8)))
    tr("attach 2", list(mgr.attach(2, t1)))
    tr("allocate 2", list(mgr.allocate(2, 8)))
    tr("release 1", mgr.release(1))
    tr("release 2", mgr.release(2))


def case_fork_allocates_fresh_page(ns, tr):
    tr.mgr = mgr = ns.BlockManager(4, 4, 4)
    src = tr("alloc", mgr.alloc_page())
    tr("fork", mgr.fork(src))


def case_insert_match_full_and_tail(ns, tr):
    mgr, cache, _ = _tree(ns, tr)
    toks = list(range(10))
    pages = tr("alloc", [mgr.alloc_page() for _ in range(3)])
    tr("insert", _insert_released(mgr, cache, toks, pages))
    tr("match", _nodes(cache.match(toks)))


def case_acquire_cow_forks_tail_before_any_write(ns, tr):
    mgr, cache, copies = _tree(ns, tr)
    toks = list(range(10))
    pages = tr("alloc", [mgr.alloc_page() for _ in range(3)])
    tr("insert", _insert_released(mgr, cache, toks, pages))
    tr("acquire", cache.acquire(toks + [50, 51], limit=11, total_pages=4))
    tr("copies", list(copies))


def case_match_capped_at_limit(ns, tr):
    mgr, cache, _ = _tree(ns, tr)
    toks = list(range(8))
    pages = tr("alloc", [mgr.alloc_page() for _ in range(2)])
    tr("insert", _insert_released(mgr, cache, toks, pages))
    tr("acquire", cache.acquire(toks, limit=7, total_pages=2))


def case_acquire_waits_when_only_fork_source_is_evictable(ns, tr):
    mgr, cache, copies = _tree(ns, tr, num_blocks=2)
    pages = tr("alloc", [mgr.alloc_page(), mgr.alloc_page()])
    tr("insert", _insert_released(mgr, cache, list(range(6)), pages))
    tr("acquire", cache.acquire(list(range(8)), limit=7, total_pages=2))
    tr("copies", list(copies))


def case_eviction_only_frees_refcount_zero(ns, tr):
    mgr, cache, _ = _tree(ns, tr, num_blocks=8)
    toks = list(range(16))
    pages = tr("alloc", [mgr.alloc_page() for _ in range(4)])
    tr("insert", _insert_released(mgr, cache, toks, pages))
    tr("acquire", cache.acquire(toks[:9], limit=8, total_pages=3))
    tr("evict", cache.evict(100))


def case_lru_evicts_oldest_first(ns, tr):
    mgr, cache, _ = _tree(ns, tr, num_blocks=16)
    a = [mgr.alloc_page() for _ in range(2)]
    b = tr("alloc", [mgr.alloc_page() for _ in range(2)])
    tr("insert a", _insert_released(mgr, cache, [1, 2, 3, 4, 5, 6, 7, 8],
                                    a))
    tr("insert b", _insert_released(
        mgr, cache, [9, 10, 11, 12, 13, 14, 15, 16], b))
    tr("acquire", cache.acquire([9, 10, 11, 12, 13], limit=5,
                                total_pages=2))
    tr("evict", cache.evict(2))


def case_partial_tail_upgrade_rekeys_parent(ns, tr):
    mgr, cache, _ = _tree(ns, tr)
    p1 = tr("alloc", [mgr.alloc_page() for _ in range(2)])
    tr("insert", _insert_released(mgr, cache, [1, 2, 3, 4, 5, 6], p1))
    got = tr("acquire", cache.acquire([1, 2, 3, 4, 5, 6, 7, 8], limit=7,
                                      total_pages=2))
    tr("insert upgrade", _insert_released(
        mgr, cache, [1, 2, 3, 4, 5, 6, 7, 8], got[0]))
    tr("match", _nodes(cache.match([1, 2, 3, 4, 5, 6, 7, 8])))
    tr("evict", cache.evict(100))


def case_divergent_insert_keeps_both_branches(ns, tr):
    mgr, cache, _ = _tree(ns, tr)
    p1 = [mgr.alloc_page() for _ in range(2)]
    p2 = tr("alloc", [mgr.alloc_page() for _ in range(2)])
    tr("insert 1", _insert_released(mgr, cache, [1, 2, 3, 4, 5, 6, 7, 8],
                                    p1))
    tr("insert 2", _insert_released(mgr, cache, [1, 2, 3, 9, 5, 6, 7, 8],
                                    p2))
    tr("match 9", _nodes(cache.match([1, 2, 3, 9, 5])))
    tr("match 4", _nodes(cache.match([1, 2, 3, 4, 5])))


def case_reclaim_hook_in_alloc_and_allocate(ns, tr):
    """A dry free list asks the tree for pages: one at a time in
    ``alloc_page``, the whole shortfall at once in ``allocate``;
    ``append_token`` and ``table_array`` over the result."""
    mgr, cache, _ = _tree(ns, tr, num_blocks=6)
    pages = tr("alloc", [mgr.alloc_page() for _ in range(6)])
    tr("insert", _insert_released(mgr, cache, list(range(24)), pages))
    tr("alloc dry", mgr.alloc_page())
    tr("allocate dry", list(mgr.allocate(7, 13)))
    tr("append_token", list(mgr.append_token(7, 16)))
    tr("table_array", mgr.table_array([7, 3]).tolist())
    tr.error("exhausted", lambda: mgr.allocate(8, 24))


def case_spill_restore_readopt(ns, tr):
    """The host tier at tree level: eviction spills, a hit restores
    through one batched call, a finished sequence re-adopts a spilled
    node, a spilled tail is superseded by a longer page."""
    mgr, cache, copies = _tree(ns, tr, num_blocks=10, offload=True)
    pages = tr("alloc", [mgr.alloc_page() for _ in range(3)])
    tr("insert", _insert_released(mgr, cache, list(range(10)), pages))
    tr("spill", cache.evict(100))
    got = tr("acquire", cache.acquire(list(range(10)) + [60], limit=10,
                                      total_pages=3))
    tr("copies", list(copies))
    tr("spill more", cache.evict(100))
    re = [mgr.alloc_page() for _ in range(3)]
    tr("insert readopt", _insert_released(
        mgr, cache, list(range(10)) + [60, 61], re))
    tr("release acquired", [mgr.decref(p) for p in got[0]])
    tr("spill again", cache.evict(100))
    again = [mgr.alloc_page() for _ in range(3)]
    tr("insert readopt full", _insert_released(
        mgr, cache, list(range(10)) + [60, 61], again))


def case_host_budget_drops_lru(ns, tr):
    mgr, cache, _ = _tree(ns, tr, num_blocks=12, offload=True, budget=2)
    for base in (0, 100, 200):
        pages = [mgr.alloc_page() for _ in range(2)]
        tr(f"insert {base}", _insert_released(
            mgr, cache, list(range(base, base + 8)), pages))
    tr("spill", cache.evict(100))


TREE_CASES = [v for k, v in sorted(globals().items())
              if k.startswith("case_")]


@pytest.mark.parametrize("case", TREE_CASES, ids=lambda f: f.__name__[5:])
def test_tree_and_allocator_match_jax(case):
    """The same operations on the JAX package's BlockManager/PrefixCache
    and the port's: equal results, refcounts, free lists, tables,
    ``summary()``, ``metrics()``, ``version`` and ``check()`` after every
    operation. The allocator's check is clean throughout; the tree's
    reports, as the JAX one does, the references a case holds outside
    any table (pages just allocated or acquired)."""
    want, got = Trace(), Trace()
    case(JAX_NS, want)
    case(PORT_NS, got)
    assert len(got.rows) == len(want.rows) > 1
    for g, w in zip(got.rows, want.rows):
        assert g == w, g["op"]
        assert g["check"] == []


# ---------------------------------------------------------------------------
# the engine: the streams of tests/test_prefix_cache.py
# ---------------------------------------------------------------------------
ENGINE = dict(capacity=2, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64, prefix_cache=True)


def _pair(params, cfg=CFG, **kw):
    """The JAX engine on its unfused route and the port's on its default
    route (the composition on the CPU), same arguments."""
    jp, tp = params
    kw = dict(ENGINE, **kw)
    je = jinf.ServingEngine(jp, cfg, fused_decode=False,
                            fused_prefill=False, **kw)
    te = ServingEngine(tp, _port_cfg(cfg), device="cpu", **kw)
    return je, te


def _submit(pair, prompt, n, greedy=True, temperature=1.0):
    return tuple(
        eng.submit(prompt, G(max_new_tokens=n, greedy=greedy,
                             temperature=temperature))
        for eng, G in zip(pair, (jinf.GenerationConfig, GenerationConfig)))


def _drain(pair):
    for eng in pair:
        eng.drain()


def _held(pair, reqs, dense=None, sampled=False):
    """Greedy ids equal (and to the port's dense ``generate`` where
    ``dense`` holds (params, cfg)), every prefix counter and the tree
    summary equal, the decode step built once and each bucket's chunk
    resolved at most once, both checks clean. With ``sampled`` requests in
    the stream the tree paths their generated tokens make differ between
    the packages (other random numbers), so the summaries are held in
    their path lengths only."""
    je, te = pair
    for jr, tr_ in reqs:
        assert tr_.done and tr_.tokens == jr.tokens
        if dense is not None and tr_.gen.greedy:
            tp, tcfg = dense
            want = generate(tp, tr_.prompt[None], tcfg, tr_.gen,
                            device="cpu")[0, tr_.prompt.size:].tolist()
            assert tr_.tokens == want
    assert te.metrics()["prefix_cache"] == je.metrics()["prefix_cache"]
    assert te.scheduler_snapshot()["prefix_cache"] == \
        je.scheduler_snapshot()["prefix_cache"]
    if sampled:
        assert sorted(te.prefix_summary().values()) == \
            sorted(je.prefix_summary().values())
    else:
        assert te.prefix_summary() == je.prefix_summary()
    assert te.prefix_cache_version == je.prefix_cache_version
    assert te.offload_metrics() == je.offload_metrics()
    for k in ("prefill_chunks", "prefill_tokens", "decode_steps",
              "tokens_generated", "requests_completed"):
        assert te.counters[k] == je.counters[k], k
    assert te.counters["decode_traces"] == je.counters["decode_traces"] == 1
    assert all(n <= 1 for n in te.counters["prefill_traces"].values())
    assert te.mgr.check() == [] and te._pcache.check() == []


def stream_warm_cache(pair, rng):
    p = rng.randint(0, 97, (20,)).astype(np.int32)
    r1 = _submit(pair, p, 5)
    _drain(pair)
    r2 = _submit(pair, p, 5)
    _drain(pair)
    m = pair[1].metrics()["prefix_cache"]
    assert (m["hits"], m["tokens_skipped"], m["cow_forks"]) == (1, 19, 1)
    return [r1, r2]


def stream_three_shared(pair, rng):
    sysp = rng.randint(0, 97, (12,)).astype(np.int32)
    reqs = [_submit(pair, np.concatenate(
        [sysp, rng.randint(0, 97, (5 + i,)).astype(np.int32)]), 5)
        for i in range(3)]
    _drain(pair)
    assert pair[1].metrics()["prefix_cache"]["tokens_skipped"] >= 12
    return reqs


def stream_in_flight(pair, rng):
    p = rng.randint(0, 97, (12,)).astype(np.int32)
    r1 = _submit(pair, p, 8)
    for eng in pair:
        eng.step()
    p2 = np.concatenate([p, rng.randint(0, 97, (4,)).astype(np.int32)])
    r2 = _submit(pair, p2, 8)
    for eng in pair:
        eng.step()               # admits r2 sharing r1's live pages
    te = pair[1]
    slot = next(i for i, s in enumerate(te._slots) if s.req is r2[1])
    shared = te.metrics()["prefix_cache"]["shared_pages"]
    assert shared == 3
    # the write table sends the shared pages to scratch page 0
    assert (te._slot_wtables[slot, :shared] == 0).all()
    assert (te._slot_tables[slot, :shared] > 0).all()
    assert all(te.mgr.refcount[p] >= 2
               for p in te._slot_tables[slot, :shared])
    _drain(pair)
    return [r1, r2]


def stream_eviction_undersized(pair, rng):
    reqs = [_submit(pair, rng.randint(0, 97, (16,)).astype(np.int32), 4)
            for _ in range(6)]
    _drain(pair)
    m = pair[1].metrics()["prefix_cache"]
    assert m["evicted_pages"] > 0
    assert len(pair[1].mgr.free) + m["cached_pages"] + 1 == \
        pair[1].num_blocks
    return reqs


def stream_eviction_after_tail_upgrade(pair, rng):
    reqs = [_submit(pair, rng.randint(0, 97, (10,)).astype(np.int32), 3)
            for _ in range(6)]
    _drain(pair)
    assert pair[1].metrics()["prefix_cache"]["evicted_pages"] > 0
    return reqs


def stream_int8(pair, rng):
    p = rng.randint(0, 97, (12,)).astype(np.int32)
    r1 = _submit(pair, p, 5)
    _drain(pair)
    r2 = _submit(pair, p, 5)
    _drain(pair)
    assert r2[1].tokens == r1[1].tokens
    assert pair[1]._k_pools.dtype == torch.int8
    assert pair[1].metrics()["prefix_cache"]["hits"] == 1
    return [r1, r2]


def stream_mixed(pair, rng):
    """The 12-request mixed stream (shared prefixes, cold prompts, greedy
    and sampled requests) with a step after each submission. The sampled
    requests draw other numbers in the two packages, so only the greedy
    ones' ids are held (the counters still agree: no prompt of the stream
    extends a sampled request's generated tokens)."""
    sysp = rng.randint(0, 97, (8,)).astype(np.int32)
    reqs = []
    for i in range(12):
        S = int(rng.randint(3, 15))
        p = rng.randint(0, 97, (S,)).astype(np.int32)
        if i % 2:
            p = np.concatenate([sysp, p[:6]])
        greedy = bool(i % 3)
        r = _submit(pair, p, int(rng.randint(2, 6)), greedy=greedy,
                    temperature=0.7)
        if greedy:
            reqs.append(r)
        for eng in pair:
            eng.step()
    _drain(pair)
    return reqs


STREAMS = {
    "warm_cache": (stream_warm_cache, 0, {}),
    "three_shared": (stream_three_shared, 1, {}),
    "in_flight": (stream_in_flight, 8, {}),
    "eviction_undersized": (stream_eviction_undersized, 3,
                            dict(num_blocks=14, max_seq_len=32)),
    "eviction_after_tail_upgrade": (stream_eviction_after_tail_upgrade, 7,
                                    dict(num_blocks=14, max_seq_len=32)),
    "int8": (stream_int8, 4, dict(cache_dtype="int8")),
    "mixed": (stream_mixed, 5, dict(capacity=3)),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_engine_stream_matches_jax(params, name, monkeypatch):
    """Each stream of tests/test_prefix_cache.py through the JAX engine and
    the port's: greedy ids equal (and, but over int8 pools, equal to the
    port's dense ``generate``), ``metrics()["prefix_cache"]``,
    ``scheduler_snapshot()["prefix_cache"]``, ``prefix_summary()``,
    ``prefix_cache_version`` and ``offload_metrics()`` equal, one decode
    build, at most one chunk route a bucket, with the per-step
    self-check on (``PADDLE_TPU_CHECK_INVARIANTS=1``) in the port."""
    monkeypatch.setenv("PADDLE_TPU_CHECK_INVARIANTS", "1")
    fn, seed, kw = STREAMS[name]
    pair = _pair(params, **kw)
    assert pair[1]._check_inv
    reqs = fn(pair, np.random.RandomState(seed))
    dense = None if name == "int8" else (params[1], _port_cfg(CFG))
    _held(pair, reqs, dense, sampled=name == "mixed")


def test_divergent_writer_leaves_shared_pages_unchanged(params):
    """tests/test_prefix_cache.py's COW case: a request sharing the
    cached prompt's pages and diverging inside its partial tail writes
    its own fork; the cached pages keep their bytes exactly (the page
    shared in place receives no prefill write: its write-table entry is
    page 0), and the original prompt run again is the cold output."""
    je, te = pair = _pair(params)
    rng = np.random.RandomState(2)
    base = rng.randint(0, 97, (10,)).astype(np.int32)
    r1 = _submit(pair, base, 4)
    _drain(pair)
    full, tail, _ = te._pcache.match(base)
    cached = [n.page for n in full] + [tail.page]
    before = [(te._k_pools[:, p].clone(), te._v_pools[:, p].clone())
              for p in cached]
    div = base.copy()
    div[9] = (div[9] + 1) % 97
    div = np.concatenate([div, rng.randint(0, 97, (6,)).astype(np.int32)])
    r2 = _submit(pair, div, 4)
    for eng in pair:
        eng.step()               # admitted and its first chunk run
    slot = next(i for i, s in enumerate(te._slots) if s.req is r2[1])
    assert te._slot_wtables[slot, 0] == 0
    assert te._slot_tables[slot, 0] == cached[0]
    _drain(pair)
    assert te.metrics()["prefix_cache"]["cow_forks"] >= 1
    for p, (k, v) in zip(cached, before):
        assert torch.equal(te._k_pools[:, p], k)
        assert torch.equal(te._v_pools[:, p], v)
    r3 = _submit(pair, base, 4)
    _drain(pair)
    _held(pair, [r1, r2, r3], (params[1], _port_cfg(CFG)))


def test_fused_chunk_over_a_warm_prefix(params, monkeypatch):
    """tests/test_fused_prefill_block.py's warm-prefix case through the
    port's fused chunk (``_fused_prefill_forward``, its ops' plain
    versions on the CPU: ``prefill_fused_selected`` forced): each suffix
    from ``pos0`` = the matched length, read through the table and
    written through the write table. Ids and every prefix counter equal
    the JAX engine's verbatim chunk."""
    monkeypatch.setattr(fpb, "prefill_fused_selected",
                        lambda meta, mode: True)
    je, te = pair = _pair(params, num_blocks=64)
    assert all(te._fused_buckets.values())
    rng = np.random.RandomState(9)
    sysp = rng.randint(0, 97, (24,)).astype(np.int32)
    reqs = []
    for i in range(4):
        p = np.concatenate([sysp, rng.randint(0, 97, (5 + i,))]).astype(
            np.int32)
        reqs.append(_submit(pair, p, 5))
        _drain(pair)
    assert te.metrics()["prefix_cache"]["tokens_skipped"] >= 3 * 24
    _held(pair, reqs, (params[1], _port_cfg(CFG)))


@pytest.mark.parametrize("coll", ["gather", "psum"])
def test_prefix_cache_under_a_mesh(params, coll):
    """The cache over a tp=2 mesh (CPU shards; page indices are global):
    the three-request shared-prefix stream against the JAX engine on the
    same mesh, greedy ids and counters equal ("psum" sums the shards'
    partial products in another order: its ids are held as the JAX
    engine's)."""
    jp, tp = params
    kw = dict(ENGINE, capacity=2)
    je = jinf.ServingEngine(jp, CFG, fused_decode=False, fused_prefill=False,
                            mesh=jinf.ServingMesh.make(tp=2, collective=coll),
                            **kw)
    te = ServingEngine(tp, _port_cfg(CFG), fused_decode=False,
                       mesh=ServingMesh.make(2, collective=coll,
                                             devices=["cpu"] * 2), **kw)
    reqs = stream_three_shared((je, te), np.random.RandomState(1))
    _held((je, te), reqs)
    assert te.metrics()["prefix_cache"]["hits"] >= 1


# ---------------------------------------------------------------------------
# the host tier: the spill/restore streams of tests/test_fleet.py
# ---------------------------------------------------------------------------
def _pages_close(te, je, pages):
    for p in pages:
        for tpool, jpool in ((te._k_pools, je._k_pools),
                             (te._v_pools, je._v_pools)):
            np.testing.assert_allclose(tpool[:, p].numpy(),
                                       np.asarray(jpool[:, p]),
                                       atol=PAGE_ATOL, rtol=0)


def test_spill_restore_byte_identity(fleet_params):
    """tests/test_fleet.py's byte-identity case: the tree spilled whole,
    then hit again. The restored pages hold the spilled bytes bit for bit
    (and the JAX engine's within PAGE_ATOL), the ids equal the JAX
    engine's and the port's dense ``generate``, every offload counter and
    byte count equals the JAX engine's, ``offload_traces`` 2."""
    je, te = pair = _pair(fleet_params, FLEET_CFG, kv_offload=True)
    rng = np.random.RandomState(4)
    p = rng.randint(0, 97, (12,)).astype(np.int32)
    r1 = _submit(pair, p, 4)
    _drain(pair)
    full, _, _ = te._pcache.match(p)
    assert len(full) == 3
    before = [(te._k_pools[:, n.page].clone(), te._v_pools[:, n.page].clone())
              for n in full]
    spilled = [eng._pcache.evict(100) for eng in pair]
    assert spilled[0] == spilled[1] >= 3
    assert all(n.page is None and n.host is not None for n in full)
    assert len(te.mgr.free) + 1 == te.num_blocks
    r2 = _submit(pair, p, 4)
    _drain(pair)
    full2, _, _ = te._pcache.match(p)
    for n, (k, v) in zip(full2[:2], before[:2]):
        assert n.page is not None
        assert torch.equal(te._k_pools[:, n.page], k)
        assert torch.equal(te._v_pools[:, n.page], v)
    _pages_close(te, je, [n.page for n in full2[:2]])
    assert te.counters["offload_traces"] == je.counters["offload_traces"] \
        == 2
    for k in ("kv_spill_bytes", "kv_restore_bytes"):
        assert te.counters[k] == je.counters[k] > 0, k
    _held(pair, [r1, r2], (fleet_params[1], _port_cfg(FLEET_CFG)))


def test_pressure_spills_then_serves_warm_from_host(fleet_params):
    """tests/test_fleet.py's pressure case: an undersized pool spills
    instead of destroying, and the first prompt again is served warm out
    of the host tier; counters equal the JAX engine's throughout."""
    pair = _pair(fleet_params, FLEET_CFG, num_blocks=14, max_seq_len=32,
                 kv_offload=True)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 97, (16,)).astype(np.int32) for _ in range(6)]
    reqs = [_submit(pair, p, 4) for p in prompts]
    _drain(pair)
    m = pair[1].metrics()["prefix_cache"]
    assert m["spilled_pages"] > 0 and m["evicted_pages"] == 0
    reqs.append(_submit(pair, prompts[0], 4))
    _drain(pair)
    m = pair[1].metrics()["prefix_cache"]
    assert m["restored_pages"] > 0
    assert (len(pair[1].mgr.free) + m["cached_pages"] + 1
            == pair[1].num_blocks)
    _held(pair, reqs, (fleet_params[1], _port_cfg(FLEET_CFG)))


def test_host_budget_drops_lru_spilled_pages(fleet_params):
    """tests/test_fleet.py's budget case: ``kv_offload=2`` bounds the
    tier; past it the LRU childless spilled node dies, as in the JAX
    engine."""
    pair = _pair(fleet_params, FLEET_CFG, num_blocks=14, max_seq_len=32,
                 kv_offload=2)
    rng = np.random.RandomState(6)
    reqs = [_submit(pair, rng.randint(0, 97, (16,)).astype(np.int32), 4)
            for _ in range(6)]
    _drain(pair)
    m = pair[1].metrics()["prefix_cache"]
    assert m["spilled_pages"] > 2 and m["host_evicted_pages"] > 0
    assert m["host_pages"] <= 2
    _held(pair, reqs)


def test_offload_requires_prefix_cache(fleet_params):
    _, tp = fleet_params
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(tp, _port_cfg(FLEET_CFG), device="cpu", capacity=2,
                      block_size=4, max_seq_len=64, kv_offload=True)


def test_reset_metrics_restarts_the_tree_counters(params):
    """``reset_metrics`` zeroes the tree's workload counters and keeps its
    pages, as the JAX engine's does."""
    pair = _pair(params)
    p = np.random.RandomState(9).randint(0, 97, (13,)).astype(np.int32)
    _submit(pair, p, 3)
    _drain(pair)
    for eng in pair:
        eng.reset_metrics()
    jm, tm = (eng.metrics()["prefix_cache"] for eng in pair)
    assert tm == jm and tm["hits"] == tm["misses"] == 0
    assert tm["cached_pages"] > 0
