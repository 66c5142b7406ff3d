"""PyTorch/CUDA port, fused decode route: the plain versions of the two
decode-block kernels against the JAX package's references and its Pallas
kernels (interpret mode), the kernel registry and its predicates, the
fused decode step, and the engine on its default route, on the CPU (f32).

The shapes are tests/test_fused_decode_block.py's; inputs are made with
numpy from a seed and handed to both packages."""
import dataclasses
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        generation as tgen)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels.registry import KERNELS, KernelRegistry

pytestmark = pytest.mark.torch_port

CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
TOL = dict(atol=2e-5, rtol=1e-5)     # the JAX tests' own tolerance


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _rope_tables(T, hd):
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    t = np.arange(T)[:, None] * inv[None, :]
    return np.sin(t).astype(np.float32), np.cos(t).astype(np.float32)


def _attn_case(rng, B, D, KV, groups, hd, BS, MB):
    """tests/test_fused_decode_block.py's ``_attn_case`` in numpy: one slot
    mid-page, one empty (seq 0: only the new token), a permuted table."""
    H = KV * groups
    N = B * MB + 2
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    x = mk(B, D)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    wq, wk, wv = mk(D, H * hd), mk(D, KV * hd), mk(D, KV * hd)
    wo = mk(H * hd, D)
    sin, cos = _rope_tables(BS * MB, hd)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = [int(rng.randint(1, BS * MB)), 0] + \
        [int(rng.randint(0, BS * MB)) for _ in range(B - 2)]
    lens = np.asarray(lens[:B], np.int32)
    kp, vp = mk(N, BS, KV, hd), mk(N, BS, KV, hd)
    return x, nw, wq, wk, wv, wo, sin, cos, kp, vp, bt, lens


def _port(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _pallas(fn, *args, **kw):
    """A JAX Pallas kernel in interpret mode, traced with x64 off: what the
    JAX package's ``no_x64`` does through ``jax.experimental.disable_x64``,
    which newer jax releases no longer have."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# plain versions against the JAX references and Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attn_block_ref_matches_jax(seed):
    rng = np.random.RandomState(seed)
    B = int(rng.randint(1, 4))
    KV = int(rng.choice([1, 2, 4]))
    groups = int(rng.choice([1, 2, 3]))
    hd = int(rng.choice([8, 16, 32]))
    BS = int(rng.choice([4, 8, 16]))
    MB = int(rng.randint(2, 5))
    D = int(rng.choice([32, 48, 64]))
    args = _attn_case(rng, B, D, KV, groups, hd, BS, MB)
    jargs = [jnp.asarray(a) for a in args]
    got = fdb.attn_block_ref(*_port(args))
    for want in (jfdb.attn_block_ref(*jargs),
                 _pallas(jfdb.fused_attn_block_pallas, *jargs)):
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    bare = fdb.attn_block_ref(*_port(args), residual=False)[0]
    _close(bare.numpy(), jfdb.attn_block_ref(*jargs, residual=False)[0])


@pytest.mark.parametrize("D,F", [(32, 64), (64, 256), (48, 96)])
def test_mlp_block_ref_matches_jax(D, F):
    rng = np.random.RandomState(D + F)
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    args = (mk(3, D), (rng.rand(D) + 0.5).astype(np.float32), mk(D, F),
            mk(D, F), mk(F, D))
    jargs = [jnp.asarray(a) for a in args]
    got = fdb.mlp_block_ref(*_port(args)).numpy()
    _close(got, jfdb.mlp_block_ref(*jargs))
    _close(got, _pallas(jfdb.fused_mlp_block_pallas, *jargs))
    _close(got, _pallas(jfdb.fused_mlp_block_pallas, *jargs,
                          block_f=F // 2))
    _close(fdb.mlp_block_ref(*_port(args), residual=False).numpy(),
           jfdb.mlp_block_ref(*jargs, residual=False))


# ---------------------------------------------------------------------------
# registry (tests/test_fused_decode_block.py's registry tests, ported)
# ---------------------------------------------------------------------------
def test_registry_priority_and_fallback():
    reg = KernelRegistry()
    reg.register("op", "fast", lambda: "fast", priority=10,
                 supports=lambda m: (m["n"] < 8, "n too big"))
    reg.register("op", "ref", lambda: "ref", priority=0)
    assert reg.dispatch("op", {"n": 4})[0] == "fast"
    assert reg.dispatch("op", {"n": 100})[0] == "ref"
    ex = reg.explain("op", {"n": 100})
    assert [e["name"] for e in ex] == ["fast", "ref"]
    assert not ex[0]["supported"] and ex[0]["reason"] == "n too big"
    assert ex[1]["selected"]


def test_registry_latest_wins_and_errors():
    reg = KernelRegistry()
    reg.register("op", "v", lambda: 1)
    reg.register("op", "v", lambda: 2)          # replaces, no duplicate
    assert len(reg.variants("op")) == 1
    assert reg.variant("op", "v").fn() == 2
    with pytest.raises(KeyError):
        reg.dispatch("missing", {})
    with pytest.raises(KeyError):
        reg.variant("op", "nope")
    reg.register("op2", "only", lambda: 0, supports=lambda m: False)
    with pytest.raises(RuntimeError, match="no variant"):
        reg.dispatch("op2", {})


def test_registry_force_stacks():
    reg = KernelRegistry()
    reg.register("op", "a", lambda: "a", priority=10)
    reg.register("op", "b", lambda: "b", priority=0)
    assert reg.dispatch("op", {})[0] == "a"
    with reg.force("op", "b"):
        assert reg.dispatch("op", {})[0] == "b"
        with reg.force("op", "a"):
            assert reg.dispatch("op", {})[0] == "a"
        assert reg.dispatch("op", {})[0] == "b"
        seen = []                                  # pins are per thread
        t = threading.Thread(target=lambda: seen.append(
            reg.dispatch("op", {})[0]))
        t.start()
        t.join()
        assert seen == ["a"]
    assert reg.dispatch("op", {})[0] == "a"
    with pytest.raises(KeyError):
        reg.force("op", "typo")


def test_cpu_dispatch_picks_unfused_with_reason():
    meta = fdb.decode_meta(TCFG, B=2, BS=4, MB=4, pool_dtype=torch.float32,
                           quant=False, device="cpu")
    attn_fn, mlp_fn, names = fdb.resolve_decode_blocks(meta, "auto")
    assert names == {"attn": "unfused", "mlp": "unfused"}
    assert attn_fn is fdb.attn_block_ref and mlp_fn is fdb.mlp_block_ref
    for op in ("decode_attn_block", "decode_mlp_block"):
        rej = KERNELS.explain(op, meta)[0]
        assert rej["name"] == "cuda_fused" and not rej["supported"]
        assert rej["reason"] == "plain composition on the CPU"
        assert KERNELS.explain(op, meta)[1]["selected"]
    _, _, forced = fdb.resolve_decode_blocks(meta, "pallas")
    assert forced == {"attn": "cuda_fused", "mlp": "cuda_fused"}
    with pytest.raises(ValueError, match="resolve_decode_step"):
        fdb.resolve_decode_blocks(meta, "block")
    with pytest.raises(ValueError, match="auto|pallas|ref"):
        fdb.resolve_decode_blocks(meta, "bogus")
    b_fn, a_fn, m_fn, names = fdb.resolve_decode_step(meta, "auto")
    assert b_fn is None and a_fn is fdb.attn_block_ref
    assert names == {"block": "composed", "attn": "unfused",
                     "mlp": "unfused"}
    b_fn, a_fn, m_fn, names = fdb.resolve_decode_step(meta, "block")
    assert b_fn is fdb.decode_block_fused_cuda and a_fn is m_fn is None
    assert names == {"block": "cuda_block", "attn": "cuda_block",
                     "mlp": "cuda_block"}


def _cuda_meta(B=8, D=4096, H=32, KV=32, hd=128, F=11008,
               dtype=torch.bfloat16, **kw):
    return fdb.decode_meta_dims(B, D, H, KV, hd, F, 16, 72, dtype,
                                kw.pop("pool_dtype", dtype),
                                kw.pop("quant", False), device="cuda", **kw)


@pytest.mark.parametrize("KV", [32, 8])
def test_predicates_select_cuda_kernels_at_7b(KV):
    """At LLaMA-7B, in bf16 and f32 and for any number of slots, both CUDA
    kernels fit shared memory (one pass of 8 normalised rows), where the
    TPU predicate rejects the attention kernel (its weights exceed the
    VMEM budget): the H100 needs no residency."""
    for B in (1, 8, 32, 64):
        for dt in (torch.bfloat16, torch.float32):
            meta = _cuda_meta(B=B, KV=KV, dtype=dt)
            for op in ("decode_attn_block", "decode_mlp_block"):
                name, _ = KERNELS.dispatch(op, meta)
                assert name == "cuda_fused", KERNELS.explain(op, meta)
    assert fdb.attn_smem_bytes(4096, 32, KV, 128, 16, 2) \
        == fdb.mlp_smem_bytes(4096, 2) \
        == 8 * 4096 * 2 + 8 * 8 * 64 * 4 + 2 * 8 * 64 * 4
    tpu = jfdb.decode_meta_dims(8, 4096, 32, KV, 128, 11008, 16, 72,
                                jnp.bfloat16, jnp.bfloat16, False)
    tpu["interpret"] = False
    ok, why = jfdb._supports_attn(tpu)
    assert not ok and "VMEM" in why


@pytest.mark.parametrize("case,reason", [
    (dict(D=8192, dtype=torch.float32), "shared memory"),
    (dict(quant=True), "int8 cache"),
    (dict(weight_dtype="int4", H=31, KV=31, hd=127), "even H"),
    (dict(H=6, KV=4, D=768), "H not a multiple of KV"),
], ids=["case0-shared memory", "case1-int8 cache / weight-quant",
        "case2-int8 cache / weight-quant", "case3-H not a multiple of KV"])
def test_predicates_refuse_with_reason(case, reason):
    """On CUDA a refusal raises with its reason: the composition is the
    CPU's route, never a silent stand-in for the kernel on the card; only
    an explicit "ref" or a force pin runs it there."""
    meta = _cuda_meta(**case)
    row = KERNELS.explain("decode_attn_block", meta)[0]
    assert not row["supported"] and reason in row["reason"], row
    with pytest.raises(RuntimeError, match=reason):
        KERNELS.dispatch("decode_attn_block", meta)
    with pytest.raises(RuntimeError, match=reason):
        fdb.resolve_decode_step(meta, "auto")
    assert fdb.resolve_decode_step(meta, "ref")[3]["attn"] == "unfused"
    with KERNELS.force("decode_attn_block", "unfused"):
        assert KERNELS.dispatch("decode_attn_block", meta)[0] == "unfused"


def test_mlp_predicate_shared_memory_and_row_width():
    assert fdb._supports_mlp(_cuda_meta(B=64, dtype=torch.float32))[0]
    assert fdb._supports_mlp(_cuda_meta(D=8192, dtype=torch.bfloat16))[0]
    ok, why = fdb._supports_mlp(_cuda_meta(D=8192, dtype=torch.float32))
    assert not ok and "shared memory" in why
    ok, why = fdb._supports_mlp(_cuda_meta(F=11001))
    assert not ok and "16 bytes" in why


def test_wrappers_raise_on_cpu_tensors():
    rng = np.random.RandomState(0)
    args = _port(_attn_case(rng, 2, 32, 2, 2, 16, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        fdb.decode_attn_block_cuda(*args)
    x = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fdb.decode_mlp_block_cuda(x, torch.ones(32), torch.zeros(32, 64),
                                  torch.zeros(32, 64), torch.zeros(64, 32))
    assert fdb.decode_attn_block_cuda.launches == 0
    assert fdb.decode_mlp_block_cuda.launches == 0


# ---------------------------------------------------------------------------
# the fused decode step and the engine on its default route
# ---------------------------------------------------------------------------
def test_fused_mode_matches_jax():
    for v in (None, True, False, "auto", "pallas", "ref", "block"):
        assert tgen._fused_mode(v) == jgen._fused_mode(v), v
    with pytest.raises(ValueError, match="fused_decode"):
        tgen._fused_mode("bogus")
    for fused in (False, "auto", "ref"):
        assert tgen._decode_variant_name(
            TCFG, 2, 4, 4, torch.float32, fused, device="cpu") \
            == jgen._decode_variant_name(CFG, 2, 4, 4, jnp.float32, False,
                                         fused) == "unfused"
    assert tgen._decode_variant_name(TCFG, 8, 16, 72, torch.float32, "auto",
                                     device="cuda") == "cuda_block"
    assert tgen._decode_variant_name(TCFG, 8, 16, 72, torch.float32,
                                     "pallas", device="cuda") == "cuda_fused"


def test_fused_step_bit_identical_to_unfused_and_close_to_jax(params):
    """tests/test_fused_decode_block.py's step inputs (slots at seq 5 and
    seq 0, permuted tables): the port's fused step in "auto" equals its
    unfused step bit for bit, logits and pools, and the JAX fused step
    within 1e-4."""
    jp, tp = params
    rng = np.random.RandomState(6)
    L, KV, hd, B, BS, MB = 2, 2, 16, 2, 4, 4
    N = B * MB + 1
    kp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    vp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    tok = rng.randint(0, 97, (B,)).astype(np.int32)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([5, 0], np.int32)
    ins = [torch.from_numpy(a) for a in (tok, bt, lens)]
    pools = {}
    for name, step in (("unfused", tgen._paged_decode_step),
                       ("fused", tgen._fused_decode_step)):
        k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        logits, _, _ = step(tp, ins[0], TCFG, k, v, ins[1], ins[2])
        pools[name] = (logits, k, v)
    for a, b in zip(pools["unfused"], pools["fused"]):
        assert torch.equal(a, b)
    jl, jk, jv = jgen._fused_decode_step(
        jp, jnp.asarray(tok), CFG, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lens), mode="auto")
    logits, k, v = pools["fused"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


def _finish_order(reqs):
    return sorted(range(len(reqs)), key=lambda i: reqs[i].finish_t)


def _port_names(variant):
    return {k: v.replace("pallas_fused", "cuda_fused")
            for k, v in variant.items()}


def test_engine_stream_matches_jax_on_default_route(params):
    """tests/test_fused_decode_block.py's 22-request stream through both
    engines on their default fused route: equal greedy ids, finish order,
    counters and decode_variant."""
    jp, tp = params
    rng = np.random.RandomState(7)
    specs = [(int(rng.randint(3, 15)), int(rng.randint(2, 6)))
             for _ in range(22)]
    prompts = [rng.randint(0, 97, (S,)).astype(np.int32) for S, _ in specs]
    kw = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64, fused_decode="auto")
    je = jinf.ServingEngine(jp, CFG, **kw)
    te = ServingEngine(tp, TCFG, device="cpu", **kw)
    jr = [je.submit(p, jinf.GenerationConfig(max_new_tokens=N, greedy=True))
          for p, (_, N) in zip(prompts, specs)]
    tr = [te.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
          for p, (_, N) in zip(prompts, specs)]
    je.drain()
    te.drain()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert all(r.done for r in tr)
    assert _finish_order(tr) == _finish_order(jr)
    for k in ("decode_steps", "prefill_chunks", "prefill_tokens",
              "tokens_generated", "requests_completed", "preemptions"):
        assert te.counters[k] == je.counters[k], k
    assert te.decode_variant == _port_names(je.decode_variant) == {
        "mode": "auto", "block": "composed", "attn": "unfused",
        "mlp": "unfused"}


@pytest.mark.parametrize("fused_prefill", [None, False, "auto", "ref"])
@pytest.mark.parametrize("fused", [False, "auto", "ref"])
def test_metrics_variant_schema_matches_jax(params, fused, fused_prefill):
    """metrics() carries the JAX engine's decode_variant, prefill_variant
    and weight_quant_variant, same keys and values (variant names mapped
    pallas_fused -> cuda_fused), before and after a decode step, with the
    same route arguments given to both engines."""
    jp, tp = params
    kw = dict(capacity=2, block_size=4, prefill_buckets=(8,),
              max_seq_len=32, fused_decode=fused,
              fused_prefill=fused_prefill)
    je = jinf.ServingEngine(jp, CFG, **kw)
    te = ServingEngine(tp, TCFG, device="cpu", **kw)
    keys = ("decode_variant", "prefill_variant", "weight_quant_variant")
    for _ in range(2):
        jm, tm = je.metrics(), te.metrics()
        for k in keys:
            assert _port_names(tm[k]) == _port_names(jm[k]), k
        for eng, G in ((je, jinf.GenerationConfig), (te, GenerationConfig)):
            eng.submit(np.arange(5, dtype=np.int32),
                       G(max_new_tokens=3, greedy=True))
            eng.drain()


def test_unhonourable_routes_raise(params):
    _, tp = params
    kw = dict(capacity=2, block_size=4, max_seq_len=32)
    with pytest.raises(ValueError, match="pallas"):
        ServingEngine(tp, TCFG, device="cpu", fused_decode="pallas", **kw)
    with pytest.raises(ValueError, match="block"):
        ServingEngine(tp, TCFG, device="cpu", fused_decode="block", **kw)
    with pytest.raises(ValueError, match="fused_decode"):
        ServingEngine(tp, TCFG, device="cpu", fused_decode="bogus", **kw)
