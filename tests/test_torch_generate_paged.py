"""PyTorch/CUDA port, ``generate_paged`` and top-k/top-p sampling: the
port's paged serving loop against the JAX package's ``generate_paged`` on
the same seeded prompts and weights carried across (f32, on the CPU), on
the dense unfused route, the default route, the two-stage ("pallas")
route (the JAX package's Pallas kernels in interpret mode; the port's
kernels replaced by their plain versions, which is what runs on the CPU),
the int8 cache, int8 weights and a tp=2 CPU mesh; the persistent
``PagedKVCacheStore`` called twice (the second call warm), its suffix
through the fused chunk (plain versions) too; the refusals; and the port's
``sample_token`` against the JAX one.

Tolerances: greedy ids equal, store counters equal. Sampling draws other
random numbers in the two packages, so the samplers are held in
distribution: the ids that 4096 JAX draws a row reach are exactly the ids
the port's filters keep, and the two samplers' frequencies lie within a
total-variation distance of 0.05."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (GenerationConfig, PagedKVCacheStore,
                                        ServingMesh, generate,
                                        generate_paged)
from paddle_tpu_torch.inference import generation as tgen
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
from paddle_tpu_torch.ops.kernels.registry import KERNELS

pytestmark = pytest.mark.torch_port

# tests/test_prefix_cache.py's model (KV 4: tp 2 splits it)
CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=128, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
DRAWS = 4096
TV_MAX = 0.05


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(6).randint(0, 97, (3, 13)).astype(np.int32)


def _pallas(fn, *args, **kw):
    """A call reaching the JAX package's Pallas kernels in interpret mode,
    traced with x64 off (what its ``no_x64`` does through a jax API newer
    releases lack)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The two-stage CUDA kernels replaced by their plain versions, so a
    forced "pallas" route runs on the CPU."""
    for op, fn in (("decode_attn_block", fdb.attn_block_ref),
                   ("decode_mlp_block", fdb.mlp_block_ref)):
        monkeypatch.setattr(KERNELS.variant(op, "cuda_fused"), "fn", fn)


def _jgen(n=6, **kw):
    return jinf.GenerationConfig(max_new_tokens=n, greedy=True, **kw)


def _tgen(n=6, **kw):
    return GenerationConfig(max_new_tokens=n, greedy=True, **kw)


ROUTES = {
    # name: (JAX keywords, port keywords)
    "dense": (dict(fused_decode=False), dict(fused_decode=False)),
    "default": ({}, {}),
    "two_stage": (dict(fused_decode="pallas"), dict(fused_decode="pallas")),
    "int8_cache": (dict(fused_decode=False, cache_dtype="int8"),
                   dict(fused_decode=False, cache_dtype="int8")),
    "int8_cache_default": (dict(cache_dtype="int8"),
                           dict(cache_dtype="int8")),
    "int8_weights": (dict(fused_decode=False, weight_quant="int8"),
                     dict(fused_decode=False, weight_quant="int8")),
    "int8_weights_default": (dict(weight_quant="int8"),
                             dict(weight_quant="int8")),
    "mesh_gather": ("gather", "gather"),
    "mesh_psum": ("psum", "psum"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_generate_paged_matches_jax(params, prompts, route, plain_kernels):
    """Greedy ids of the port's ``generate_paged`` equal the JAX
    package's on each route, and equal the port's dense ``generate``
    (the int8 cache's ids are held against JAX's only: its pools round)."""
    jp, tp = params
    jkw, tkw = ROUTES[route]
    if route.startswith("mesh"):
        jkw = dict(fused_decode=False,
                   mesh=jinf.ServingMesh.make(tp=2, collective=jkw))
        tkw = dict(fused_decode=False,
                   mesh=ServingMesh.make(2, collective=tkw,
                                         devices=["cpu"] * 2))
    else:
        tkw = dict(tkw, device="cpu")
    want = np.asarray(_pallas(jinf.generate_paged, jp, jnp.asarray(prompts),
                              CFG, _jgen(), block_size=4, **jkw))
    got = generate_paged(tp, prompts, TCFG, _tgen(), block_size=4, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    if "int8_cache" not in route and "int8_weights" not in route:
        dense = generate(tp, prompts, TCFG, _tgen(), device="cpu")
        assert torch.equal(got, dense)


def test_generate_paged_chunks_the_decode_loop(params, monkeypatch):
    """More new tokens than one runner call takes: the loop runs in
    chunks of ``_DECODE_CHUNK`` steps, each runner cached once per
    configuration, and the ids equal the JAX package's."""
    jp, tp = params
    monkeypatch.setattr(tgen, "_DECODE_CHUNK", 4)
    tgen._PAGED_CACHE.clear()
    p = np.random.RandomState(3).randint(0, 97, (2, 9)).astype(np.int32)
    want = np.asarray(jinf.generate_paged(jp, jnp.asarray(p), CFG,
                                          _jgen(11), block_size=4,
                                          fused_decode=False))
    for _ in range(2):
        got = generate_paged(tp, p, TCFG, _tgen(11), block_size=4,
                             fused_decode=False, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(tgen._PAGED_CACHE) == 1


@pytest.mark.parametrize("fused_suffix", [False, True])
def test_prefix_store_called_twice(params, prompts, fused_suffix,
                                   monkeypatch):
    """tests/test_prefix_cache.py's store case: a ``PagedKVCacheStore``
    called twice, the second call warm. Ids equal the JAX store's and the
    cold call's, the store's counters (hits, tokens skipped, pages) equal
    the JAX store's after each call, and every request page went back
    (free + tree + scratch == pool). ``fused_suffix``: the warm suffix
    through the fused chunk (``_suffix_prefill_runner``, its ops' plain
    versions on the CPU, the suffix padded to the kernel's 16-row query
    blocks)."""
    jp, tp = params
    if fused_suffix:
        monkeypatch.setattr(fpb, "prefill_fused_selected",
                            lambda meta, mode: True)
    jstore = jinf.PagedKVCacheStore(CFG, block_size=4, num_blocks=64)
    store = PagedKVCacheStore(TCFG, block_size=4, num_blocks=64,
                              device="cpu")
    outs = []
    for _ in range(2):
        want = np.asarray(jinf.generate_paged(
            jp, jnp.asarray(prompts), CFG, _jgen(), block_size=4,
            prefix_cache=jstore, fused_decode=False, fused_prefill=False))
        got = generate_paged(tp, prompts, TCFG, _tgen(), block_size=4,
                             prefix_cache=store)
        np.testing.assert_array_equal(got.numpy(), want)
        assert store.metrics() == jstore.metrics()
        assert store.cache.summary() == jstore.cache.summary()
        outs.append(got)
    assert torch.equal(outs[0], outs[1])
    assert store.cache.stats["tokens_skipped"] > 0
    assert (len(store.mgr.free) + store.cache.cached_pages + 1
            == store.num_blocks)
    assert store.cache.check() == []


def test_refusals(params, prompts):
    """The JAX package's refusals, with its reasons: an int8 cache over a
    store, a mesh with a store, a mesh with quantized weights; and
    ``observability``, which is not ported (ROADMAP A8)."""
    _, tp = params
    store = PagedKVCacheStore(TCFG, block_size=4, num_blocks=32,
                              device="cpu")
    with pytest.raises(ValueError, match="int8"):
        generate_paged(tp, prompts[:1, :6], TCFG, _tgen(2), block_size=4,
                       cache_dtype="int8", prefix_cache=store)
    mesh = ServingMesh.make(2, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="does not take a mesh"):
        generate_paged(tp, prompts, TCFG, _tgen(2), block_size=4,
                       prefix_cache=store, mesh=mesh)
    with pytest.raises(ValueError, match="does not take a mesh"):
        generate_paged(tp, prompts, TCFG, _tgen(2), block_size=4,
                       weight_quant="int8", mesh=mesh)
    with pytest.raises(NotImplementedError, match="A8"):
        generate_paged(tp, prompts, TCFG, _tgen(2), block_size=4,
                       observability=True, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        generate_paged(tp, prompts, TCFG, _tgen(2), block_size=8,
                       prefix_cache=store)


# ---------------------------------------------------------------------------
# top-k / top-p sampling
# ---------------------------------------------------------------------------
def _logits():
    rng = np.random.RandomState(11)
    return (rng.randn(4, 97) * 3.0).astype(np.float32)


def test_top_k_1_is_greedy(params, prompts):
    """top_k=1 keeps only the largest logit: sampling is greedy in both
    packages, through ``sample_token`` and through ``generate_paged``."""
    x = _logits()
    greedy = np.argmax(x, axis=-1)
    g = dict(max_new_tokens=1, temperature=0.8, top_k=1)
    j = jgen.sample_token(jnp.asarray(x), jax.random.key(0),
                          jinf.GenerationConfig(**g))
    t = tgen.sample_token(torch.from_numpy(x), GenerationConfig(**g),
                          torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.asarray(j), greedy)
    np.testing.assert_array_equal(t.numpy(), greedy)
    jp, tp = params
    kw = dict(max_new_tokens=5, temperature=0.8, top_k=1)
    want = np.asarray(jinf.generate_paged(jp, jnp.asarray(prompts), CFG,
                                          _jgen(5), block_size=4,
                                          fused_decode=False))
    got = generate_paged(tp, prompts, TCFG, GenerationConfig(**kw),
                         block_size=4, seed=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


FILTERS = {"top_k": dict(top_k=7), "top_p": dict(top_p=0.8),
           "both": dict(top_k=12, top_p=0.9),
           "top_p_temperature": dict(top_p=0.7, temperature=1.7)}


@pytest.mark.parametrize("name", list(FILTERS))
def test_sampler_distribution_matches_jax(name):
    """On fixed [4, 97] logits: the ids DRAWS JAX draws a row reach are
    exactly the ids the port's filters keep (``_filter_logits``: finite),
    and the port's DRAWS draws a row have frequencies within a total
    variation of TV_MAX of JAX's."""
    x = _logits()
    kw = dict(max_new_tokens=1, temperature=1.0)
    kw.update(FILTERS[name])
    jd = np.asarray(jgen.sample_token(
        jnp.asarray(np.repeat(x, DRAWS, axis=0)), jax.random.key(1),
        jinf.GenerationConfig(**kw))).reshape(4, DRAWS)
    g = GenerationConfig(**kw)
    kept = torch.isfinite(tgen._filter_logits(torch.from_numpy(x), g))
    td = tgen.sample_token(torch.from_numpy(np.repeat(x, DRAWS, axis=0)), g,
                           torch.Generator().manual_seed(1)).numpy()
    td = td.reshape(4, DRAWS)
    for row in range(4):
        assert set(np.unique(jd[row])) == \
            set(np.nonzero(kept[row].numpy())[0])
        assert set(np.unique(td[row])) <= set(np.unique(jd[row]))
        fj = np.bincount(jd[row], minlength=97) / DRAWS
        ft = np.bincount(td[row], minlength=97) / DRAWS
        assert 0.5 * np.abs(fj - ft).sum() <= TV_MAX
