"""PyTorch/CUDA port, the int8 KV cache: the port's pool quantizers and
quantizing pool writes against the JAX package's (byte for byte),
``paged_attention_decode_quant``, the int8-pool plain versions of
decode_attn_block, decode_block_fused and prefill_attn_block against the
JAX compositions and the JAX Pallas kernels' ``quant`` bodies (interpret
mode, x64 off), the decode steps and the fused chunk over int8 pools, the
engine's ``cache_dtype="int8"`` (calibration, fused against unfused, the
JAX engine's tokens, int8 weights on int8 pools), its metrics and
roofline, and the CUDA dispatch metas and refusals on the CPU (f32).

The model is tests/test_fused_decode_block.py's; inputs are made with
numpy from a seed and handed to both packages. Tolerances: byte equality
for every quantizer and pool write; 3e-5 absolute, 1e-5 relative for the
plain versions against the JAX functions in f32 (the JAX quantized
tests' own); 1e-4 for logits through two layers."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.observability import roofline as jroof
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu.ops.pallas import fused_prefill_block as jfpb
from paddle_tpu.quantization import ptq as jptq
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        generation as tgen)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.observability import roofline as troof
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
from paddle_tpu_torch.ops.kernels import paged_attention as kpa
from paddle_tpu_torch.ops.kernels.registry import KERNELS

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
TOL = dict(atol=3e-5, rtol=1e-5)
ENGINE = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)
WBITS = pytest.mark.parametrize("bits", [0, 8, 4],
                                ids=["fp", "int8", "int4"])


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """numpy/JAX arrays (nested dicts, lists and tuples) as CPU tensors."""
    if isinstance(tree, dict):
        return tllama.params_from_jax(_np(tree), device="cpu")
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port(t) for t in tree)
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pallas(fn, *args, **kw):
    """A JAX Pallas kernel in interpret mode, traced with x64 off (see
    tests/test_torch_fused_decode.py's ``_pallas``)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rope(T, hd, pos=None):
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    t = (np.arange(T) if pos is None else pos)[:, None] * inv[None, :]
    return np.sin(t).astype(np.float32), np.cos(t).astype(np.float32)


def _int8_pools(rng, *shape):
    """Random int8 pools (codes in [-127, 127]) and f32 per-head scales
    [KV] (the JAX tests' int8 cases)."""
    kp = rng.randint(-127, 128, shape).astype(np.int8)
    vp = rng.randint(-127, 128, shape).astype(np.int8)
    KV = shape[-2]
    return kp, vp, ((rng.rand(KV) * 0.01 + 0.001).astype(np.float32),
                    (rng.rand(KV) * 0.01 + 0.001).astype(np.float32))


def _weights(rng, bits, shapes, down=None):
    """f32 weights of ``shapes``, or the JAX harness's quantized leaves of
    them (``down``: the index packed along its output axis)."""
    ws = [(rng.randn(*s) * 0.07).astype(np.float32) for s in shapes]
    if not bits:
        return ws
    return [jptq.quantize_leaf(w, bits, pack_axis=1 if i == down else 0)
            for i, w in enumerate(ws)]


# ---------------------------------------------------------------------------
# the quantizers and the quantizing pool writes, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pools_bytes_match_jax(dtype):
    """Per-head absmax scales and int8 codes of whole pools, one head all
    zeros (the 1e-8 floor)."""
    rng = np.random.RandomState(0)
    k = (rng.randn(5, 4, 3, 16) * 0.3).astype(np.float32)
    v = (rng.randn(5, 4, 3, 16) * 2.0).astype(np.float32)
    k[:, :, 1] = 0.0
    jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jk, jv))
    for got, want in zip(tpa.quantize_pools(tk, tv), jpa.quantize_pools(jk,
                                                                        jv)):
        _same(got.numpy(), want)


def test_quant_and_dequant_cache_bytes_match_jax():
    """The dense view's round trip: ``dequant_cache`` then ``quant_cache``
    gives back the codes (positions only read re-quantize exactly), and
    ``quant_cache`` of new values is the JAX codes."""
    rng = np.random.RandomState(1)
    L, KV = 2, 3
    q = rng.randint(-127, 128, (L, 1, 12, KV, 16)).astype(np.int8)
    s = (rng.rand(L, KV) * 0.02 + 0.001).astype(np.float32)
    deq = tpa.dequant_cache(torch.from_numpy(q), torch.from_numpy(s))
    _same(deq.numpy(), jpa.dequant_cache(q, s))
    _same(tpa.quant_cache(deq, torch.from_numpy(s)).numpy(), q)
    x = (rng.randn(L, 1, 12, KV, 16) * 0.5).astype(np.float32)
    _same(tpa.quant_cache(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
          jpa.quant_cache(x, s))


def test_quantizing_pool_writes_bytes_match_jax():
    """``write_to_pool_quant`` (one token per slot, a padding slot on the
    scratch page) and ``write_chunk_to_pool_quant`` (a chunk past a page
    edge with pad rows sent to page 0) leave the JAX pools' bytes."""
    rng = np.random.RandomState(2)
    N, BS, KV, hd = 7, 4, 2, 16
    kp, vp, (ks, vs) = _int8_pools(rng, N, BS, KV, hd)
    bt = np.asarray([[3, 5], [0, 0]], np.int32)
    lens = np.asarray([6, 0], np.int32)
    kn, vn = (rng.randn(2, KV, hd).astype(np.float32) * 0.5 for _ in "kv")
    got = tpa.write_to_pool_quant(*_port((kp, vp, bt, lens, kn, vn, ks, vs)))
    want = jpa.write_to_pool_quant(*_jax((kp, vp, bt, lens, kn, vn, ks, vs)))
    for g, w in zip(got, want):
        _same(g.numpy(), w)
    wt = np.asarray([2, 6, 1], np.int32)
    kc, vc = (rng.randn(8, KV, hd).astype(np.float32) * 0.5 for _ in "kv")
    got = tpa.write_chunk_to_pool_quant(*_port((kp, vp, wt)), 3, 6,
                                        *_port((kc, vc, ks, vs)))
    want = jpa.write_chunk_to_pool_quant(*_jax((kp, vp, wt)), 3, 6,
                                         *_jax((kc, vc, ks, vs)))
    # rows at/after n_valid all land on scratch page 0: only the others
    # are one write each
    for g, w in zip(got, want):
        _same(g.numpy()[1:], np.asarray(w)[1:])


@pytest.mark.parametrize("KV,groups", [(2, 1), (1, 4), (2, 2)],
                         ids=["mha", "gqa4", "gqa2"])
def test_paged_attention_decode_quant_matches_jax(KV, groups):
    """The gather, the per-head dequantize in f32 and the masked softmax,
    a slot of length 0 included; the CUDA kernel refuses int8 pools with
    the reason that the JAX package runs a composition there too."""
    rng = np.random.RandomState(3 + KV + groups)
    B, hd, BS, MB = 3, 16, 4, 3
    N = B * MB + 1
    kp, vp, (ks, vs) = _int8_pools(rng, N, BS, KV, hd)
    q = rng.randn(B, KV * groups, hd).astype(np.float32)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([5, 0, 12], np.int32)
    args = (q, kp, vp, bt, lens, ks, vs)
    got = tpa.paged_attention_decode_quant(*_port(args))
    _close(got.numpy(), jpa.paged_attention_decode_quant(*_jax(args)))
    assert not got[1].any()
    with pytest.raises(TypeError, match="composition"):
        kpa.paged_attention_decode_cuda(*_port(args[:5]))


# ---------------------------------------------------------------------------
# the int8-pool plain versions against the JAX compositions and kernels
# ---------------------------------------------------------------------------
def _attn_case(rng, B, D, KV, groups, hd, BS, MB, bits):
    """One slot mid-table, one empty (only the new token), more at random;
    int8 pools and scales; fp, int8 or int4 weights."""
    H = KV * groups
    N = B * MB + 2
    x = (rng.randn(B, D) * 0.07).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    ws = _weights(rng, bits, [(D, H * hd), (D, KV * hd), (D, KV * hd),
                              (H * hd, D)])
    sin, cos = _rope(BS * MB, hd)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = ([int(rng.randint(1, BS * MB)), 0]
            + [int(rng.randint(0, BS * MB)) for _ in range(B - 2)])[:B]
    kp, vp, scales = _int8_pools(rng, N, BS, KV, hd)
    return [x, nw, *ws, sin, cos, kp, vp, bt,
            np.asarray(lens, np.int32)], scales


@WBITS
@pytest.mark.parametrize("KV,groups", [(2, 1), (1, 2), (2, 2)],
                         ids=["mha", "gqa2_kv1", "gqa2"])
def test_attn_block_int8_pools_match_jax(bits, KV, groups):
    """attn_block_wq_ref (the kernel's order) against the JAX attention
    kernel's quant body, attn_block_ref against the JAX composition, both
    over int8 pools; both return the raw new-token K/V, and the pools
    they write in place (the quantizing write) are the JAX pools."""
    rng = np.random.RandomState(10 + bits + 3 * KV + groups)
    args, scales = _attn_case(rng, 3, 32, KV, groups, 16, 4, 3, bits)
    jargs, jsc = _jax(args), _jax(scales)
    kernel = _pallas(jfdb.fused_attn_block_pallas, *jargs, kv_scales=jsc)
    targs = _port(args)
    got = fdb.attn_block_wq_ref(*targs, kv_scales=_port(scales))
    for g, w in zip(got, kernel):
        _close(g.numpy(), w)
    targs = _port(args)
    got = fdb.attn_block_ref(*targs, kv_scales=_port(scales))
    jcomp = jfdb.attn_block_ref(*jargs, kv_scales=jsc)
    for g, w in zip(got, jcomp):
        _close(g.numpy(), w)
    kq, vq = jpa.write_to_pool_quant(jargs[8], jargs[9], jargs[10],
                                     jargs[11], jcomp[1], jcomp[2], *jsc)
    _same(targs[8].numpy(), kq)
    _same(targs[9].numpy(), vq)


@WBITS
def test_decode_block_ref_int8_pools_matches_jax_block_kernel(bits):
    """decode_block_ref over int8 pools against the JAX single-launch
    kernel's quant body; decode_block_composed against the JAX
    two-stage composition."""
    rng = np.random.RandomState(30 + bits)
    D, F = 32, 64
    a, scales = _attn_case(rng, 3, D, 2, 2, 16, 4, 3, bits)
    mlp = [(rng.rand(D) + 0.5).astype(np.float32),
           *_weights(rng, bits, [(D, F), (D, F), (F, D)], down=2)]
    args = a[:6] + mlp + a[6:]
    want = _pallas(jfdb.fused_decode_block_pallas, *_jax(args),
                   kv_scales=_jax(scales))
    for g, w in zip(fdb.decode_block_ref(*_port(args),
                                         kv_scales=_port(scales)), want):
        _close(g.numpy(), w)
    jargs = _jax(args)
    xo, kn, vn = jfdb.attn_block_ref(*jargs[:6], *jargs[10:],
                                     kv_scales=_jax(scales))
    jx = jfdb.mlp_block_ref(xo, *jargs[6:10])
    got = fdb.decode_block_composed(*_port(args), kv_scales=_port(scales))
    for g, w in zip(got, (jx, kn, vn)):
        _close(g.numpy(), w)


@WBITS
def test_prefill_attn_block_int8_pools_match_jax(bits):
    """A warm mid-page start and ragged valid rows over int8 history
    pages: prefill_attn_block_wq_ref (history dequantized in f32, the
    chunk's K/V at the model type) against the JAX kernel's quant body,
    prefill_attn_block_ref (history cast to the model type) against the
    JAX composition."""
    rng = np.random.RandomState(40 + bits)
    P, D, H, KV, hd, BS, MB = 16, 32, 4, 2, 16, 8, 5
    N = MB + 3
    x = (rng.randn(P, D) * 0.07).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    ws = _weights(rng, bits, [(D, H * hd), (D, KV * hd), (D, KV * hd),
                              (H * hd, D)])
    pos0, n_valid = 10, 13
    sin, cos = _rope(P, hd, pos=pos0 + np.arange(P))
    kp, vp, scales = _int8_pools(rng, N, BS, KV, hd)
    tab = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    args = [x, nw, *ws, sin, cos, kp, vp, tab]
    jargs = _jax(args) + [jnp.int32(pos0), jnp.int32(n_valid)]
    targs = _port(args) + [pos0, n_valid]
    xk, kk, vk = _pallas(jfpb.fused_prefill_attn_pallas, *jargs,
                         kv_scales=_jax(scales))
    xg, kg, vg = fpb.prefill_attn_block_wq_ref(*targs,
                                               kv_scales=_port(scales))
    _close(xg[:n_valid].numpy(), xk[:n_valid])
    _close(kg.numpy(), kk)
    _close(vg.numpy(), vk)
    for g, w in zip(fpb.prefill_attn_block_ref(*targs,
                                               kv_scales=_port(scales)),
                    jfpb.prefill_attn_block_ref(*jargs,
                                                kv_scales=_jax(scales))):
        _close(g[:n_valid].numpy(), w[:n_valid])


def test_prefill_plain_versions_part_in_bf16_only():
    """The two prefill plain versions agree in f32 (to summation order)
    and part in bf16 by more than roundoff of the output alone: the
    composition casts the dequantized history to bf16, the kernel's order
    keeps it in f32 (each true to its JAX counterpart)."""
    rng = np.random.RandomState(47)
    P, D, H, KV, hd, BS, MB = 16, 32, 4, 2, 16, 8, 5
    N = MB + 3
    x = (rng.randn(P, D) * 0.5).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    ws = _weights(rng, 0, [(D, H * hd), (D, KV * hd), (D, KV * hd),
                           (H * hd, D)])
    sin, cos = _rope(P, hd, pos=24 + np.arange(P))
    kp, vp, scales = _int8_pools(rng, N, BS, KV, hd)
    tab = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    base = _port([x, nw, *ws, sin, cos, kp, vp, tab])
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) if i < 6 else t for i, t in enumerate(base)]
        k = fpb.prefill_attn_block_wq_ref(*args, 24, P,
                                          kv_scales=_port(scales))[0]
        c = fpb.prefill_attn_block_ref(*args, 24, P,
                                       kv_scales=_port(scales))[0]
        if dt == torch.float32:
            _close(k.numpy(), c.numpy(), atol=1e-5, rtol=1e-5)
        else:
            assert not torch.equal(k, c)


# ---------------------------------------------------------------------------
# the decode steps and the fused chunk over int8 pools
# ---------------------------------------------------------------------------
def _step_inputs(rng, B=2, BS=4, MB=4):
    L, KV, hd = 2, 2, 16
    N = B * MB + 1
    kp, vp, _ = _int8_pools(rng, L, N, BS, KV, hd)
    scales = ((rng.rand(L, KV) * 0.1 + 0.01).astype(np.float32),
              (rng.rand(L, KV) * 0.1 + 0.01).astype(np.float32))
    tok = rng.randint(0, 97, (B,)).astype(np.int32)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([5, 0][:B], np.int32)
    return tok, kp, vp, bt, lens, scales


@pytest.mark.parametrize("wq", [None, "int8"], ids=["fp", "int8"])
def test_decode_steps_int8_pools_match_jax(params, wq):
    """The ``quant`` leg of tests/test_fused_decode_block.py's step test:
    the fused step ("auto": the compositions on the CPU) equals the
    unfused step bit for bit over int8 pools, logits and pools; both hold
    the JAX step, whose pools they equal byte for byte."""
    jp, tp = params
    if wq:
        jp = jptq.quantize_weights(jp, bits=8)
        tp = tllama.params_from_jax(_np(jp), device="cpu")
    tok, kp, vp, bt, lens, scales = _step_inputs(np.random.RandomState(6))
    outs = {}
    for name, step in (("unfused", tgen._paged_decode_step),
                       ("fused", tgen._fused_decode_step)):
        k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        logits, _, _ = step(tp, torch.from_numpy(tok), TCFG, k, v,
                            torch.from_numpy(bt), torch.from_numpy(lens),
                            kv_scales=_port(scales))
        outs[name] = (logits, k, v)
    for a, b in zip(outs["unfused"], outs["fused"]):
        assert torch.equal(a, b)
    jl, jk, jv = jgen._paged_decode_step(jp, *_jax((tok,)), CFG,
                                         *_jax((kp, vp, bt, lens)),
                                         kv_scales=_jax(scales))
    logits, k, v = outs["fused"]
    _close(logits.numpy(), jl, atol=1e-4, rtol=1e-4)
    _same(k.numpy(), jk)
    _same(v.numpy(), jv)


@pytest.mark.parametrize("mode", ["block", "pallas"])
def test_kernel_routes_of_the_step_hold_the_jax_kernel_step(params,
                                                            monkeypatch,
                                                            mode):
    """The single-launch and two-stage routes of the step over int8 pools
    (their kernels replaced by the kernel-order plain versions on the
    CPU) against the JAX step forced onto its Pallas kernels (interpret):
    logits to 1e-4, and the pools byte for byte (quantization snaps the
    new token's roundoff back)."""
    jp, tp = params
    tok, kp, vp, bt, lens, scales = _step_inputs(np.random.RandomState(16))
    monkeypatch.setattr(KERNELS.variant("decode_block_fused", "cuda_block"),
                        "fn", fdb.decode_block_ref)
    monkeypatch.setattr(KERNELS.variant("decode_attn_block", "cuda_fused"),
                        "fn", fdb.attn_block_wq_ref)
    monkeypatch.setattr(KERNELS.variant("decode_mlp_block", "cuda_fused"),
                        "fn", fdb.mlp_block_wq_ref)
    k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, _, _ = tgen._fused_decode_step(
        tp, torch.from_numpy(tok), TCFG, k, v, torch.from_numpy(bt),
        torch.from_numpy(lens), mode=mode, kv_scales=_port(scales))
    jl, jk, jv = _pallas(jgen._fused_decode_step, jp, *_jax((tok,)), CFG,
                         *_jax((kp, vp, bt, lens)), kv_scales=_jax(scales),
                         mode=mode)
    _close(logits.numpy(), jl, atol=1e-4, rtol=1e-4)
    _same(k.numpy(), jk)
    _same(v.numpy(), jv)


def test_fused_prefill_forward_int8_pools_matches_jax(params, monkeypatch):
    """``_fused_prefill_forward`` over int8 pools, a warm chunk: on the
    compositions ("auto" on the CPU) against the JAX function on its
    compositions, and on the kernel-order plain version against the JAX
    kernel (interpret): logits to 1e-4 and the pools' written rows byte
    for byte."""
    jp, tp = params
    rng = np.random.RandomState(50)
    L, BS, KV, hd, MB = 2, 4, 2, 16, 8
    N = MB + 2
    kp, vp, _ = _int8_pools(rng, L, N, BS, KV, hd)
    scales = ((rng.rand(L, KV) * 0.1 + 0.01).astype(np.float32),
              (rng.rand(L, KV) * 0.1 + 0.01).astype(np.float32))
    table = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    toks = np.zeros(16, np.int32)
    toks[:11] = rng.randint(0, 97, 11)
    pos0, n = 6, 11
    for mode in ("auto", "pallas"):
        if mode == "pallas":
            monkeypatch.setattr(
                KERNELS.variant("prefill_attn_block", "cuda_fused"), "fn",
                fpb.prefill_attn_block_wq_ref)
            monkeypatch.setattr(
                KERNELS.variant("prefill_mlp_block", "cuda_fused"), "fn",
                fdb.mlp_block_wq_ref)
        k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        logits, _, _ = tgen._fused_prefill_forward(
            tp, torch.from_numpy(toks), TCFG, k, v, torch.from_numpy(table),
            torch.from_numpy(table), pos0, n, mode=mode,
            kv_scales=_port(scales))
        jl, jk, jv = _pallas(jgen._fused_prefill_forward, jp,
                             *_jax((toks,)), CFG, *_jax((kp, vp, table,
                                                         table)),
                             pos0, n, kv_scales=_jax(scales), mode=mode)
        _close(logits[:n].numpy(), np.asarray(jl)[:n], atol=1e-4,
               rtol=1e-4)
        _same(k.numpy()[:, 1:], np.asarray(jk)[:, 1:])
        _same(v.numpy()[:, 1:], np.asarray(jv)[:, 1:])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _stream(seed=7, n=22):
    rng = np.random.RandomState(seed)
    specs = [(int(rng.randint(3, 15)), int(rng.randint(2, 6)))
             for _ in range(n)]
    return [(rng.randint(0, 97, (S,)).astype(np.int32), N)
            for S, N in specs]


def test_engine_calibrated_scales_match_jax(params):
    """The static scales come from the first admitted prompt, padded with
    token 0 to its bucket: equal to the JAX engine's (f32 roundoff of the
    two forwards), calibrated once, before any prefill."""
    jp, tp = params
    prompt = np.random.RandomState(9).randint(0, 97, 11).astype(np.int32)
    je = jinf.ServingEngine(jp, CFG, cache_dtype="int8", **ENGINE)
    te = ServingEngine(tp, TCFG, cache_dtype="int8", device="cpu", **ENGINE)
    for eng, G in ((je, jinf.GenerationConfig), (te, GenerationConfig)):
        eng.submit(prompt, G(max_new_tokens=2, greedy=True))
        eng.submit(prompt[:3], G(max_new_tokens=2, greedy=True))
        eng.step()
    assert te.counters["calibration_traces"] \
        == je.counters["calibration_traces"] == 1
    for g, w in zip(te._kv_scales, je._kv_scales):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 2)
        _close(g.numpy(), w, atol=0, rtol=1e-6)
    te.drain()
    assert te.counters["calibration_traces"] == 1


def test_engine_stream_fused_vs_unfused_int8_pools(params):
    """The ``cdt="int8"`` leg of tests/test_fused_decode_block.py's stream
    test: 22 greedy requests in f32 give the same tokens on the fused
    ("auto") and the unfused engine, with the pools byte-equal after every
    step, one decode route resolution and at most one per bucket."""
    _, tp = params
    engs = [ServingEngine(tp, TCFG, cache_dtype="int8", device="cpu",
                          fused_decode=f, **ENGINE) for f in (None, False)]
    reqs = [[e.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
             for p, N in _stream()] for e in engs]
    steps = 0
    while not all(e.idle for e in engs):
        for e in engs:
            e.step()
        steps += 1
        assert torch.equal(engs[0]._k_pools, engs[1]._k_pools), steps
        assert torch.equal(engs[0]._v_pools, engs[1]._v_pools), steps
    assert [r.tokens for r in reqs[0]] == [r.tokens for r in reqs[1]]
    assert all(r.done for r in reqs[0])
    c = engs[0].counters
    assert c["requests_completed"] == 22 and c["decode_traces"] == 1
    assert set(c["prefill_traces"]) <= {8, 16}
    assert all(n <= 1 for n in c["prefill_traces"].values())
    assert engs[0]._k_pools.dtype == torch.int8


@pytest.mark.parametrize("wq,fused", [(None, None), (None, False),
                                      ("int8", None), ("int4", False)],
                         ids=["fp-auto", "fp-unfused", "int8-auto",
                              "int4-unfused"])
def test_engine_int8_pools_match_jax_engine(params, wq, fused):
    """The port engine's greedy ids over int8 pools equal the JAX engine's
    on the same weights and stream (with int8 or int4 weights too: the
    two quantizations compose, tests/test_quant_serving.py's
    test_engine_int8_weights_with_int8_kv_cache), and so do the
    counters."""
    jp, tp = params
    kw = dict(ENGINE, cache_dtype="int8", fused_decode=fused,
              weight_quant=wq)
    je = jinf.ServingEngine(jp, CFG, **kw)
    te = ServingEngine(tp, TCFG, device="cpu", **kw)
    stream = _stream(seed=11, n=8)
    jr = [je.submit(p, jinf.GenerationConfig(max_new_tokens=N, greedy=True))
          for p, N in stream]
    tr = [te.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
          for p, N in stream]
    je.drain()
    te.drain()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    for k in ("decode_steps", "prefill_chunks", "tokens_generated",
              "calibration_traces", "decode_traces"):
        assert te.counters[k] == je.counters[k], k
    _close(te._kv_scales[0].numpy(), je._kv_scales[0], atol=0, rtol=1e-6)
    assert te.weight_quant_variant["mode"] == (wq or "off")


def test_engine_kernel_routes_on_cpu_hold_unfused_tokens(params,
                                                          monkeypatch):
    """The block decode route and the fused chunk over int8 pools, driven
    on the CPU through their kernels' kernel-order plain versions, give
    the unfused engine's greedy tokens (f32: roundoff flips are snapped
    back by quantization or lost in the argmax) and pools."""
    _, tp = params
    monkeypatch.setattr(KERNELS.variant("decode_block_fused", "cuda_block"),
                        "fn", fdb.decode_block_ref)
    monkeypatch.setattr(KERNELS.variant("prefill_attn_block", "cuda_fused"),
                        "fn", fpb.prefill_attn_block_wq_ref)
    monkeypatch.setattr(KERNELS.variant("prefill_mlp_block", "cuda_fused"),
                        "fn", fdb.mlp_block_wq_ref)
    monkeypatch.setattr(fpb, "prefill_fused_selected", lambda m, mode: True)
    blk = ServingEngine(tp, TCFG, cache_dtype="int8", device="cpu",
                        **ENGINE)
    monkeypatch.setattr(blk, "_fused", "block")
    ref = ServingEngine(tp, TCFG, cache_dtype="int8", device="cpu",
                        fused_decode=False, fused_prefill=False, **ENGINE)
    assert blk._fused_buckets == {8: True, 16: True}
    stream = _stream(seed=12, n=6)
    out = []
    for e in (blk, ref):
        rs = [e.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
              for p, N in stream]
        e.drain()
        out.append([r.tokens for r in rs])
    assert out[0] == out[1]
    assert blk.counters["calibration_traces"] == 1


def test_metrics_schema_and_calibration_counter(params):
    """``metrics()`` keeps the JAX engine's key schema (plus the port's
    ``decode_step_ms_mean``) over int8 pools; ``calibration_traces``
    counts the one calibration and survives ``reset_metrics``."""
    jp, tp = params
    je = jinf.ServingEngine(jp, CFG, cache_dtype="int8", **ENGINE)
    te = ServingEngine(tp, TCFG, cache_dtype="int8", device="cpu", **ENGINE)
    assert te.metrics()["calibration_traces"] == 0
    for eng, G in ((je, jinf.GenerationConfig), (te, GenerationConfig)):
        eng.submit(np.arange(6, dtype=np.int32),
                   G(max_new_tokens=3, greedy=True))
        eng.drain()
    jm, tm = je.metrics(), te.metrics()
    assert set(tm) - set(jm) == {"decode_step_ms_mean"}
    assert set(jm) - set(tm) == set()
    assert tm["calibration_traces"] == jm["calibration_traces"] == 1
    te.reset_metrics()
    assert te.metrics()["calibration_traces"] == 1


def test_roofline_int8_pool_bytes_match_jax_model(params):
    """1-byte pools: the two-stage and unfused arms equal the JAX model's,
    and the engine's roofline counts its int8 pools at the model's
    activation width."""
    dims = (8, 4096, 32, 32, 128, 11008, 16, 72)
    for wbytes in (2.0, 1.0):
        got = troof.decode_step_bytes(*dims, act_itemsize=2,
                                      weight_itemsize=wbytes,
                                      pool_itemsize=1)
        want = jroof.decode_step_bytes(*dims, act_itemsize=2,
                                       weight_itemsize=wbytes,
                                       pool_itemsize=1)
        assert got["cuda_fused"] == want["pallas_fused"]
        assert got["unfused"] == want["unfused"]
    fp = troof.decode_step_bytes(*dims)
    kv8 = troof.decode_step_bytes(*dims, pool_itemsize=1)
    assert fp["cuda_block"] - kv8["cuda_block"] == 2 * 8 * 72 * 16 * 32 * 128
    jp, tp = params
    je = jinf.ServingEngine(jp, CFG, cache_dtype="int8", **ENGINE)
    te = ServingEngine(tp, TCFG, cache_dtype="int8", device="cpu", **ENGINE)
    ja = je.metrics()["roofline"]["variants"]["unfused"]["bytes_per_step"]
    ta = te.metrics()["roofline"]["variants"]["unfused"]["bytes_per_step"]
    assert ta == ja
    off = ServingEngine(tp, TCFG, device="cpu", **ENGINE).metrics()
    L, B, MB, BS, KV, hd = 2, 3, te.max_blocks, 4, 2, 16
    assert off["roofline"]["variants"]["unfused"]["bytes_per_step"] - ta \
        == L * 2 * B * MB * BS * KV * hd * 3


# ---------------------------------------------------------------------------
# CUDA dispatch metas and refusals, on the CPU
# ---------------------------------------------------------------------------
def _cuda_meta(wd=None, dtype=torch.bfloat16, pool=torch.int8, quant=True,
               **dims):
    d = dict(D=4096, H=32, KV=32, hd=128, F=11008)
    d.update(dims)
    return fdb.decode_meta_dims(8, d["D"], d["H"], d["KV"], d["hd"], d["F"],
                                16, 72, dtype, pool, quant, weight_dtype=wd,
                                device="cuda")


@pytest.mark.parametrize("wd", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_metas_take_int8_pools_at_7b(wd, dtype):
    """At LLaMA-7B every weight class over int8 pools selects the three
    kernels that read the pools (and the MLP kernels), each fitting the
    card's shared memory, the reason naming the int8 pools; the decode
    kernels' staged pages shrink against the fp pools'."""
    meta = _cuda_meta(wd, dtype)
    for op in ("decode_attn_block", "decode_mlp_block",
               "decode_block_fused"):
        row = KERNELS.explain(op, meta)[0]
        assert row["selected"], row
        assert "int8 pools" in row["reason"] or op == "decode_mlp_block"
    b_fn, _, _, names = fdb.resolve_decode_step(meta, "auto")
    assert b_fn is fdb.decode_block_fused_cuda and names["block"] == \
        "cuda_block"
    item = meta["itemsize"]
    assert meta["pool_itemsize"] == 1
    assert fdb.block_smem_bytes(4096, 32, 32, 128, 16, item, 1) \
        <= fdb.SMEM_LIMIT
    assert fdb._layout(4096, 1, 128, 16, item, 1)[0] \
        <= fdb._layout(4096, 1, 128, 16, item)[0]
    pmeta = fpb.prefill_meta_dims(128, 4096, 32, 8, 128, 11008, 16, 72,
                                  dtype, torch.int8, True, weight_dtype=wd,
                                  device="cuda")
    assert fpb.prefill_fused_selected(pmeta, "auto")
    assert fpb.prefill_attn_smem_bytes(4096, 32, 8, 128, 16, item, 1) \
        == fpb.prefill_attn_smem_bytes(4096, 32, 8, 128, 16, item)


@pytest.mark.parametrize("case,reason", [
    (dict(quant=False), "int8 pools without quant"),
    (dict(pool=torch.bfloat16), "needs int8 pools"),
    (dict(hd=8, H=32, KV=32), "16 bytes (1-byte elements)"),
], ids=["int8_pool_no_quant", "quant_fp_pool", "int8_rows"])
def test_int8_pool_refusals_give_reasons(case, reason):
    """A pool that does not match ``quant`` is refused with its reason
    by every op that reads the pools, and dispatch on CUDA raises (the
    composition never stands in there)."""
    meta = _cuda_meta(dtype=torch.float32, **case)
    for op in ("decode_attn_block", "decode_block_fused"):
        row = KERNELS.explain(op, meta)[0]
        assert not row["supported"] and reason in row["reason"], row
    with pytest.raises(RuntimeError, match="int8|16 bytes"):
        fdb.resolve_decode_step(meta, "auto")
    pmeta = dict(meta, P=128)
    pmeta.pop("B")
    assert not fpb._supports_prefill_attn(pmeta)[0]


def test_cpu_metas_run_the_composition_over_int8_pools():
    meta = fdb.decode_meta(TCFG, B=2, BS=4, MB=4, pool_dtype=torch.int8,
                           quant=True, device="cpu")
    assert fdb.resolve_decode_step(meta, "auto")[3] == {
        "block": "composed", "attn": "unfused", "mlp": "unfused"}
    assert tgen._decode_variant_name(TCFG, 2, 4, 4, torch.int8, "auto",
                                     device="cuda", quant=True) \
        == "cuda_block"
    assert tgen._decode_variant_name(TCFG, 2, 4, 4, torch.int8, "auto",
                                     device="cpu", quant=True) == "unfused"


def test_wrappers_check_pools_against_scales_first():
    """Scales without int8 pools, and int8 pools without scales, are
    refused before the device is looked at; on CPU tensors a matching
    pair then raises for the device; nothing is counted."""
    rng = np.random.RandomState(60)
    args, scales = _attn_case(rng, 2, 32, 2, 2, 16, 4, 3, 0)
    targs, tsc = _port(args), _port(scales)
    kernels.reset_launches()
    fp_pools = list(targs)
    fp_pools[8], fp_pools[9] = targs[8].float(), targs[9].float()
    with pytest.raises(ValueError, match="need int8 pools"):
        fdb.decode_attn_block_cuda(*fp_pools, kv_scales=tsc)
    with pytest.raises(ValueError, match="need kv_scales"):
        fdb.decode_attn_block_cuda(*targs)
    with pytest.raises(ValueError, match="CUDA"):
        fdb.decode_attn_block_cuda(*targs, kv_scales=tsc)
    with pytest.raises(ValueError, match="need kv_scales"):
        fpb.prefill_attn_block_cuda(targs[0], *targs[1:10], targs[10][0],
                                    0, 1)
    assert set(kernels.launches_by_pool()) == {
        "decode_attn_block", "decode_block_fused", "prefill_attn_block"}
    assert all(v == 0 for by in kernels.launches_by_pool().values()
               for v in by.values())
