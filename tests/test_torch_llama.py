"""PyTorch/CUDA port, model level: parameters, the dense cached forward,
dense generation, sampling and the paged decode step against the JAX
package on the CPU (port with device="cpu", f32)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import generation as tgen
from paddle_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port

# the tests/test_serving_engine.py model
CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, dtype=jnp.float32,
                         remat=False)


def port_cfg(cfg, dtype=torch.float32):
    names = [f.name for f in dataclasses.fields(tllama.LlamaConfig)
             if f.name != "dtype"]
    return tllama.LlamaConfig(**{n: getattr(cfg, n) for n in names},
                              dtype=dtype)


TCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_copies_every_leaf(dtype):
    jp = jllama.init_params(CFG, jax.random.key(1), dtype=dtype)
    tp = tllama.params_from_jax(jp, device="cpu")
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype)[6:] == str(a.dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


def test_init_params_layout_matches_jax():
    shapes = jax.eval_shape(lambda: jllama.init_params(CFG, None,
                                                       jnp.bfloat16))
    tp = tllama.init_params(port_cfg(CFG, torch.bfloat16), seed=0,
                            device="cpu")
    jl, tl = list(_leaves(shapes)), list(_leaves(tp))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == \
            str(a.dtype), name
    assert torch.equal(tp["final_norm"], torch.ones(64))
    std = float(tp["layers"]["q_proj"].float().std())
    assert 0.015 < std < 0.025


def test_cached_forward_matches_jax(params):
    """Prefill 7 tokens into a 12-position cache, then one more token at
    position 7: logits and both caches agree."""
    jp, tp = params
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 97, (2, 7)).astype(np.int32)
    nxt = rng.randint(0, 97, (2, 1)).astype(np.int32)
    jk, jv = jgen.init_cache(CFG, 2, 12)
    tk, tv = tgen.init_cache(TCFG, 2, 12, device="cpu")
    for t, pos in ((toks, 0), (nxt, 7)):
        jlog, jk, jv = jgen.cached_forward(jp, jnp.asarray(t), CFG, jk,
                                           jv, pos)
        tlog, tk, tv = tgen.cached_forward(tp, torch.from_numpy(t), TCFG,
                                           tk, tv, pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_generate_matches_jax(params):
    jp, tp = params
    ids = np.random.RandomState(1).randint(0, 97, (2, 9)).astype(np.int32)
    g = dict(max_new_tokens=6, greedy=True)
    want = np.asarray(jgen.generate(jp, jnp.asarray(ids), CFG,
                                    jgen.GenerationConfig(**g)))
    got = tgen.generate(tp, ids, TCFG, tgen.GenerationConfig(**g),
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_decode_step_matches_jax(params):
    """One decode step over paged pools holding random history: an active
    slot mid-page, one at a page boundary, and an inactive slot (seq 0,
    table 0 = scratch). Logits and both pools agree."""
    jp, tp = params
    rng = np.random.RandomState(2)
    L, N, BS, KV, hd = 2, 10, 4, 2, 16
    kp = rng.randn(L, N, BS, KV, hd).astype(np.float32)
    vp = rng.randn(L, N, BS, KV, hd).astype(np.float32)
    tables = np.array([[4, 7, 2], [0, 0, 0], [9, 1, 5]], np.int32)
    seq = np.array([6, 0, 8], np.int32)
    tok = np.array([11, 0, 42], np.int32)
    jlog, jk, jv = jgen._paged_decode_step(
        jp, jnp.asarray(tok), CFG, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(seq))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tlog, _, _ = tgen._paged_decode_step(
        tp, torch.from_numpy(tok), TCFG, tk, tv, torch.from_numpy(tables),
        torch.from_numpy(seq))
    active = [0, 2]
    np.testing.assert_allclose(tlog.numpy()[active],
                               np.asarray(jlog)[active], atol=1e-4,
                               rtol=1e-4)
    live = np.ones(N, bool)
    live[0] = False               # scratch page: inactive-slot garbage
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               atol=1e-5)


def test_sample_token_greedy_and_temperature():
    logits = torch.randn(5, 97, generator=torch.Generator().manual_seed(3))
    greedy = tgen.sample_token(logits, tgen.GenerationConfig(greedy=True))
    assert torch.equal(greedy, torch.argmax(logits, -1))
    zero_t = tgen.sample_token(logits,
                               tgen.GenerationConfig(temperature=0.0))
    assert torch.equal(zero_t, greedy)
    g = tgen.GenerationConfig(temperature=0.8)
    a = tgen.sample_token(logits, g, torch.Generator().manual_seed(7))
    b = tgen.sample_token(logits, g, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < 97)).all())
    with pytest.raises(NotImplementedError):
        tgen.sample_token(logits, tgen.GenerationConfig(top_k=5),
                          torch.Generator())
