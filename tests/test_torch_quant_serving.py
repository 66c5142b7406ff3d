"""PyTorch/CUDA port, weight-quantized serving: the port's PTQ harness
against the JAX package's (byte for byte), the quantized-weight plain
versions of decode_attn_block, decode_mlp_block, decode_block_fused and
prefill_attn_block against the JAX references and Pallas kernels
(interpret mode, x64 off), the quantized decode step, the engine's
``weight_quant`` route against the JAX engine, and the dispatch metas'
``weight_dtype`` on the CPU (f32).

The model is tests/test_quant_serving.py's; inputs are made with numpy
from a seed and handed to both packages. Tolerances are the JAX tests'
own: 3e-5 absolute, 1e-5 relative."""
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
from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu.ops.pallas import fused_prefill_block as jfpb
from paddle_tpu.quantization import ptq as jptq, quanters as jq
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        generate, generation as tgen)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.observability import roofline as troof
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
from paddle_tpu_torch.ops.kernels.registry import KERNELS
from paddle_tpu_torch.quantization import ptq as tptq, quanters as tq

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
BITS = pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
ENGINE = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """numpy/JAX arrays (nested dicts and lists) as CPU tensors."""
    if isinstance(tree, dict):
        return tllama.params_from_jax(_np(tree), device="cpu")
    if isinstance(tree, (list, tuple)):
        return [_port(t) for t in tree]
    return torch.from_numpy(np.array(tree))


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


# ---------------------------------------------------------------------------
# the quantizers and the PTQ harness, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_int4_bytes_match_jax(axis):
    rng = np.random.RandomState(0)
    q = rng.randint(-8, 8, (12, 10)).astype(np.int8)
    got = tq.pack_int4(torch.from_numpy(q), axis=axis)
    _same(got.numpy(), jq.pack_int4(q, axis=axis))
    _same(tq.unpack_int4(got, axis=axis).numpy(),
          jq.unpack_int4(jq.pack_int4(q, axis=axis), axis=axis))
    _same(tq.unpack_int4(got, axis=axis).numpy(), q)
    with pytest.raises(ValueError, match="odd"):
        tq.pack_int4(torch.from_numpy(q[:11]), axis=0)


@pytest.mark.parametrize("axis", [-1, 0])
def test_channel_quantizers_bytes_match_jax(axis):
    rng = np.random.RandomState(1)
    w = rng.randn(16, 6).astype(np.float32)
    w[:, 2] = 0.0                     # an all-zero channel: the 1e-8 floor
    for tfn, jfn in ((tq.quantize_to_int8, jq.quantize_to_int8),
                     (tq.quantize_to_int4, jq.quantize_to_int4)):
        (q, s), (jqv, js) = tfn(torch.from_numpy(w), axis), jfn(w, axis)
        _same(q.numpy(), jqv)
        _same(s.numpy(), js)


@BITS
@pytest.mark.parametrize("pack_axis", [0, 1])
def test_quantize_leaf_and_dequantize_match_jax(bits, pack_axis):
    rng = np.random.RandomState(2 + bits + pack_axis)
    for shape in ((8, 6), (3, 10, 12)):
        w = (rng.randn(*shape) * 0.1).astype(np.float32)
        ax = pack_axis + len(shape) - 2
        got = tptq.quantize_leaf(torch.from_numpy(w), bits, pack_axis=ax)
        want = jptq.quantize_leaf(w, bits, pack_axis=ax)
        assert set(got) == set(want)
        for k in want:
            _same(got[k].numpy(), want[k])
        _same(tq.dequantize_weight(got).numpy(),
              jq.dequantize_weight(want))
        _same(tq.maybe_dequantize(got, torch.float32).numpy(),
              jq.maybe_dequantize(want, jnp.float32))


@BITS
@pytest.mark.parametrize("aware", [False, True], ids=["absmax", "aware"])
def test_quantize_weights_bytes_match_jax(params, bits, aware):
    """The whole tree, with and without the same activation-aware clip
    arrays: integers and scales byte-identical, norms and embedding
    untouched, the same weight bytes."""
    jp, tp = params
    act = None
    if aware:
        prompt = np.random.RandomState(3).randint(0, 97, (12,))
        act = jptq.activation_absmax(jp, CFG, prompt.astype(np.int32))
    want = jptq.quantize_weights(jp, bits=bits, act_absmax=act)
    got = tptq.quantize_weights(
        tp, bits=bits,
        act_absmax=None if act is None else {k: torch.from_numpy(v)
                                             for k, v in act.items()})
    for k in tptq.WQ_KEYS:
        assert set(got["layers"][k]) == set(want["layers"][k])
        for part in want["layers"][k]:
            _same(got["layers"][k][part].numpy(), want["layers"][k][part])
    assert got["layers"]["input_norm"] is tp["layers"]["input_norm"]
    assert got["embed_tokens"] is tp["embed_tokens"]
    assert tptq.weight_hbm_bytes(got) == jptq.weight_hbm_bytes(want)
    assert tptq.weight_hbm_bytes(tp) == jptq.weight_hbm_bytes(jp)
    assert tptq.weight_quant_mode(got) == jptq.weight_quant_mode(want) \
        == {8: "int8", 4: "int4"}[bits]


def test_activation_absmax_matches_jax(params):
    jp, tp = params
    prompt = np.random.RandomState(3).randint(0, 97, (12,)).astype(np.int32)
    want = jptq.activation_absmax(jp, CFG, prompt)
    got = tptq.activation_absmax(tp, TCFG, prompt)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        _close(got[k].numpy(), want[k], atol=1e-5, rtol=1e-5)


def test_ptq_errors_match_jax(params):
    jp, tp = params
    for bad in ("int2", 16, "fp8"):
        with pytest.raises(ValueError) as jerr:
            jptq.normalize_weight_quant(bad)
        with pytest.raises(ValueError) as terr:
            tptq.normalize_weight_quant(bad)
        assert str(terr.value) == str(jerr.value)
    for v in (None, False, 0, 8, "int8", 4, "int4"):
        assert tptq.normalize_weight_quant(v) \
            == jptq.normalize_weight_quant(v)
    jq8, tq8 = jptq.quantize_weights(jp, 8), tptq.quantize_weights(tp, 8)
    for fn, tree in ((jptq, jq8), (tptq, tq8)):
        with pytest.raises(ValueError, match="already"):
            fn.quantize_weights(tree, bits=8)
        with pytest.raises(ValueError, match="bits must be 4 or 8"):
            fn.quantize_weights(jp if fn is jptq else tp, bits=3)
    with pytest.raises(ValueError) as jerr:
        jptq.ensure_quantized(jq8, "int4")
    with pytest.raises(ValueError) as terr:
        tptq.ensure_quantized(tq8, "int4")
    assert str(terr.value) == str(jerr.value)
    same, mode = tptq.ensure_quantized(tq8, None)
    assert same is tq8 and mode == "int8"
    assert tptq.ensure_quantized(tp, None) == (tp, None)


def test_params_from_jax_carries_quantized_leaves(params):
    """A JAX-quantized tree crosses as-is: each leaf an int8 tensor and an
    f32 scale, same shapes and bytes."""
    jp, _ = params
    for bits in (8, 4):
        jt = jptq.quantize_weights(jp, bits=bits)
        tt = tllama.params_from_jax(_np(jt), device="cpu")
        for k in tptq.WQ_KEYS:
            for part, arr in jt["layers"][k].items():
                t = tt["layers"][k][part]
                assert t.dtype == (torch.float32 if part == "scale"
                                   else torch.int8)
                _same(t.numpy(), arr)


def test_weight_dtype_of_rejects_mixed_modes():
    w = np.zeros((4, 4), np.float32)
    leaf = _port(jptq.quantize_leaf(w, 8))
    assert fdb.weight_dtype_of(leaf, leaf) == jfdb.weight_dtype_of(
        jptq.quantize_leaf(w, 8)) == "int8"
    assert fdb.weight_dtype_of(torch.zeros(4, 4)) is None
    with pytest.raises(ValueError, match="one weight-quant mode"):
        fdb.weight_dtype_of(torch.zeros(4, 4), leaf)


# ---------------------------------------------------------------------------
# plain versions against the JAX references and Pallas kernels
# ---------------------------------------------------------------------------
def _rope(T, hd, pos=None):
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    t = (np.arange(T) if pos is None else pos)[:, None] * inv[None, :]
    return np.sin(t).astype(np.float32), np.cos(t).astype(np.float32)


def _attn_case(rng, B, D, KV, groups, hd, BS, MB, bits):
    """tests/test_quant_serving.py's ``_attn_case`` in numpy: one slot
    mid-table, one empty; the weights quantized by the JAX harness."""
    H = KV * groups
    N = B * MB + 2
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    x, nw = mk(B, D), (rng.rand(D) + 0.5).astype(np.float32)
    ws = [jptq.quantize_leaf(w, bits) for w in
          (mk(D, H * hd), mk(D, KV * hd), mk(D, KV * hd), mk(H * hd, D))]
    sin, cos = _rope(BS * MB, hd)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([int(rng.randint(1, BS * MB)), 0][:B], np.int32)
    kp, vp = mk(N, BS, KV, hd), mk(N, BS, KV, hd)
    return [x, nw, *ws, sin, cos, kp, vp, bt, lens]


def _jax_args(args):
    return [jax.tree_util.tree_map(jnp.asarray, a) for a in args]


@BITS
@pytest.mark.parametrize("seed", [0, 1])
def test_attn_block_refs_match_jax(bits, seed):
    """Ragged shapes (D 48 included): the epilogue-order plain version
    against the JAX quantized-weight Pallas kernel, the dequantize
    composition against the JAX composition."""
    rng = np.random.RandomState(seed + bits)
    B, KV = int(rng.randint(1, 3)), int(rng.choice([1, 2]))
    groups, hd = int(rng.choice([1, 2])), int(rng.choice([8, 16]))
    BS, MB = int(rng.choice([4, 8])), int(rng.randint(2, 5))
    D = int(rng.choice([32, 48, 64]))
    args = _attn_case(rng, B, D, KV, groups, hd, BS, MB, bits)
    jargs = _jax_args(args)
    kernel = _pallas(jfdb.fused_attn_block_pallas, *jargs)
    for g, w in zip(fdb.attn_block_wq_ref(*_port(args)), kernel):
        _close(g.numpy(), w)
    for g, w in zip(fdb.attn_block_ref(*_port(args)),
                    jfdb.attn_block_ref(*jargs)):
        _close(g.numpy(), w)


@BITS
@pytest.mark.parametrize("D,F", [(32, 96), (64, 256)])
def test_mlp_block_refs_match_jax(bits, D, F):
    """gate/up packed along D, down along its output D; an F tile of 3
    (odd) is legal under int4 (F is never packed)."""
    rng = np.random.RandomState(D + F + bits)
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    args = [mk(3, D), (rng.rand(D) + 0.5).astype(np.float32),
            jptq.quantize_leaf(mk(D, F), bits),
            jptq.quantize_leaf(mk(D, F), bits),
            jptq.quantize_leaf(mk(F, D), bits, pack_axis=1)]
    jargs = _jax_args(args)
    got = fdb.mlp_block_wq_ref(*_port(args)).numpy()
    for bf in (None, F // 2) + ((3,) if bits == 4 and F % 3 == 0 else ()):
        _close(got, _pallas(jfdb.fused_mlp_block_pallas, *jargs,
                            block_f=bf))
    _close(fdb.mlp_block_ref(*_port(args)).numpy(),
           jfdb.mlp_block_ref(*jargs))
    _close(fpb.prefill_mlp_block_ref(*_port(args)).numpy(),
           jfpb.prefill_mlp_block_ref(*jargs))


@BITS
def test_prefill_attn_block_refs_match_jax(bits):
    """A warm mid-page start and ragged valid rows (the JAX test's case)."""
    rng = np.random.RandomState(20 + bits)
    P, D, H, KV, hd, BS, MB = 16, 32, 4, 2, 16, 8, 5
    N = MB + 3
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    x, nw = mk(P, D), (rng.rand(D) + 0.5).astype(np.float32)
    ws = [jptq.quantize_leaf(w, bits) for w in
          (mk(D, H * hd), mk(D, KV * hd), mk(D, KV * hd), mk(H * hd, D))]
    pos0, n_valid = 10, 13
    sin, cos = _rope(P, hd, pos=pos0 + np.arange(P))
    kp, vp = mk(N, BS, KV, hd), mk(N, BS, KV, hd)
    tab = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    args = [x, nw, *ws, sin, cos, kp, vp, tab]
    jargs = _jax_args(args) + [jnp.int32(pos0), jnp.int32(n_valid)]
    targs = _port(args) + [pos0, n_valid]
    xk, kk, vk = _pallas(jfpb.fused_prefill_attn_pallas, *jargs)
    xg, kg, vg = fpb.prefill_attn_block_wq_ref(*targs)
    _close(xg[:n_valid].numpy(), xk[:n_valid])
    _close(kg.numpy(), kk)
    _close(vg.numpy(), vk)
    for g, w in zip(fpb.prefill_attn_block_ref(*targs),
                    jfpb.prefill_attn_block_ref(*jargs)):
        _close(g[:n_valid].numpy(), w[:n_valid])


@BITS
def test_decode_block_ref_matches_jax_block_kernel(bits):
    """The single-launch kernel's plain version on quantized leaves
    against the JAX single-launch Pallas kernel (its wq_bits body)."""
    rng = np.random.RandomState(30 + bits)
    B, D, KV, groups, hd, BS, MB, F = 2, 32, 2, 2, 16, 4, 3, 64
    a = _attn_case(rng, B, D, KV, groups, hd, BS, MB, bits)
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    mlp = [(rng.rand(D) + 0.5).astype(np.float32),
           jptq.quantize_leaf(mk(D, F), bits),
           jptq.quantize_leaf(mk(D, F), bits),
           jptq.quantize_leaf(mk(F, D), bits, pack_axis=1)]
    args = a[:6] + mlp + a[6:]
    want = _pallas(jfdb.fused_decode_block_pallas, *_jax_args(args))
    for g, w in zip(fdb.decode_block_ref(*_port(args)), want):
        _close(g.numpy(), w)


def test_epilogue_order_differs_from_composition_by_roundoff():
    """x @ (q * s) against (x @ q) * s: the kernels' order is not the
    composition's bit for bit, only to f32 roundoff; on plain weights the
    two products are the same function."""
    rng = np.random.RandomState(4)
    h = torch.from_numpy(rng.randn(5, 48).astype(np.float32))
    w = rng.randn(48, 40).astype(np.float32) * 0.05
    for bits, ax in ((8, 0), (4, 0), (4, 1)):
        leaf = _port(jptq.quantize_leaf(w, bits, pack_axis=ax))
        epi, deq = fdb._f32mm(h, leaf), fdb._deq_mm(h, leaf)
        _close(epi.numpy(), deq.numpy(), atol=1e-5, rtol=1e-5)
    plain = torch.from_numpy(w)
    assert torch.equal(fdb._epi_mm(h, plain), h @ plain)


# ---------------------------------------------------------------------------
# dispatch metas with weight_dtype
# ---------------------------------------------------------------------------
def _cuda_meta(wd, D=4096, H=32, KV=32, hd=128, F=11008,
               dtype=torch.bfloat16):
    return fdb.decode_meta_dims(8, D, H, KV, hd, F, 16, 72, dtype, dtype,
                                False, weight_dtype=wd, device="cuda")


@pytest.mark.parametrize("wd", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_metas_take_quantized_weights_at_7b(wd, dtype):
    """On a CUDA meta every quantized-weight kernel is selected, with its
    weight class in the reason; the shared memory is the fp kernels'."""
    meta = _cuda_meta(wd, dtype=dtype)
    assert meta["weight_dtype"] == wd
    for op in ("decode_attn_block", "decode_mlp_block",
               "decode_block_fused"):
        row = KERNELS.explain(op, meta)[0]
        assert row["selected"] and f"{wd} weights" in row["reason"], row
        fp_row = KERNELS.explain(op, _cuda_meta(None, dtype=dtype))[0]
        assert row["reason"].split(",")[0] == fp_row["reason"]
    pmeta = fpb.prefill_meta_dims(128, 4096, 32, 32, 128, 11008, 16, 72,
                                  dtype, dtype, False, weight_dtype=wd,
                                  device="cuda")
    assert fpb.prefill_fused_selected(pmeta, "auto")
    b_fn, _, _, names = fdb.resolve_decode_step(meta, "auto")
    assert b_fn is fdb.decode_block_fused_cuda
    assert names["block"] == "cuda_block"


@pytest.mark.parametrize("dims,name", [
    (dict(D=33), "hidden_size"),
    (dict(H=31, KV=31, hd=127), "H*head_dim")], ids=["D", "Hhd"])
def test_odd_int4_widths_refused_with_jax_reason(dims, name):
    """An odd packed axis refuses int4 on CUDA with the JAX package's
    reason string, and dispatch raises (never the composition); int8 at
    the same odd width is refused only for its row bytes."""
    meta = _cuda_meta("int4", dtype=torch.float32, **dims)
    jmeta = jfdb.decode_meta_dims(8, meta["D"], meta["H"], meta["KV"],
                                  meta["hd"], 11008, 16, 72, jnp.float32,
                                  jnp.float32, False, weight_dtype="int4")
    want = jfdb._wq_even_reason(jmeta, (("hidden_size", jmeta["D"]), (
        "H*head_dim", jmeta["H"] * jmeta["hd"])))
    assert name in want
    for op in ("decode_attn_block", "decode_block_fused"):
        row = KERNELS.explain(op, meta)[0]
        assert not row["supported"] and row["reason"] == want, row
    with pytest.raises(RuntimeError, match="packed-int4"):
        fdb.resolve_decode_step(meta, "auto")
    if name == "hidden_size":
        assert fdb._supports_mlp(meta) == (False, want)
        pmeta = dict(meta, P=meta.pop("B"))
        assert fpb._supports_prefill_attn(pmeta) == (False, want)
    ok, why = fdb._supports_attn(_cuda_meta("int8", dtype=torch.float32,
                                            **dims))
    assert not ok and "packed-int4" not in why


def test_cpu_metas_run_the_dequantize_composition_and_say_so():
    meta = fdb.decode_meta(TCFG, B=2, BS=4, MB=4, pool_dtype=torch.float32,
                           quant=False, weight_dtype="int4", device="cpu")
    _, _, names = fdb.resolve_decode_blocks(meta, "auto")
    assert names == {"attn": "unfused", "mlp": "unfused"}
    row = KERNELS.explain("decode_attn_block", meta)[1]
    assert row["selected"] and "dequantized" in row["reason"]


def test_wrappers_raise_on_cpu_with_quantized_leaves():
    rng = np.random.RandomState(5)
    args = _port(_attn_case(rng, 2, 32, 2, 2, 16, 4, 3, 8))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fdb.decode_attn_block_cuda(*args)
    leaf = _port(jptq.quantize_leaf(np.zeros((32, 64), np.float32), 8))
    with pytest.raises(ValueError, match="CUDA"):
        fdb.decode_mlp_block_cuda(torch.zeros(2, 32), torch.ones(32), leaf,
                                  leaf, _port(jptq.quantize_leaf(
                                      np.zeros((64, 32), np.float32), 8)))
    assert all(v == 0 for by in kernels.launches_by_weight().values()
               for v in by.values())
    assert set(kernels.launches_by_weight()) == {
        "decode_attn_block", "decode_mlp_block", "decode_block_fused",
        "prefill_attn_block"}


# ---------------------------------------------------------------------------
# steps, generate and the engine
# ---------------------------------------------------------------------------
def _step_inputs(rng, B=2, BS=4, MB=4):
    L, KV, hd = 2, 2, 16
    N = B * MB + 1
    kp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    vp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    tok = rng.randint(0, 97, (B,)).astype(np.int32)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([5, 0][:B], np.int32)
    return tok, kp, vp, bt, lens


@BITS
def test_fused_step_bit_identical_to_unfused_over_quantized_tree(params,
                                                                 bits):
    """The port's form of JAX's
    test_quantized_fallback_bit_identical_to_dequant_matmul: on the CPU
    the fused step ("auto": the compositions) equals the unfused step
    bit for bit, logits and pools; both hold the JAX step."""
    jp, _ = params
    jqp = jptq.quantize_weights(jp, bits=bits)
    tqp = tllama.params_from_jax(_np(jqp), device="cpu")
    tok, kp, vp, bt, lens = _step_inputs(np.random.RandomState(6 + bits))
    ins = [torch.from_numpy(a) for a in (tok, bt, lens)]
    outs = {}
    for name, step in (("unfused", tgen._paged_decode_step),
                       ("fused", tgen._fused_decode_step)):
        k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        logits, _, _ = step(tqp, ins[0], TCFG, k, v, ins[1], ins[2])
        outs[name] = (logits, k, v)
    for a, b in zip(outs["unfused"], outs["fused"]):
        assert torch.equal(a, b)
    jl, jk, jv = jgen._paged_decode_step(
        jqp, jnp.asarray(tok), CFG, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lens))
    logits, k, v = outs["fused"]
    _close(logits.numpy(), jl, atol=1e-4, rtol=1e-4)
    _close(k.numpy(), jk, atol=1e-5, rtol=1e-5)
    _close(v.numpy(), jv, atol=1e-5, rtol=1e-5)


@BITS
def test_block_step_on_cpu_holds_the_jax_kernel_step(params, monkeypatch,
                                                     bits):
    """The single-launch route of the step (its kernel replaced by
    decode_block_ref on the CPU) over a quantized tree, against the JAX
    step forced onto its quantized single-launch kernel (interpret)."""
    jp, _ = params
    jqp = jptq.quantize_weights(jp, bits=bits)
    tqp = tllama.params_from_jax(_np(jqp), device="cpu")
    tok, kp, vp, bt, lens = _step_inputs(np.random.RandomState(16 + bits))
    monkeypatch.setattr(KERNELS.variant("decode_block_fused", "cuda_block"),
                        "fn", fdb.decode_block_ref)
    k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, _, _ = tgen._fused_decode_step(
        tqp, *[torch.from_numpy(a) for a in (tok,)], TCFG, k, v,
        torch.from_numpy(bt), torch.from_numpy(lens), mode="block")
    jl, jk, jv = _pallas(jgen._fused_decode_step, jqp, jnp.asarray(tok),
                         CFG, jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(bt), jnp.asarray(lens), mode="block")
    _close(logits.numpy(), jl, atol=1e-4, rtol=1e-4)
    _close(k.numpy(), jk, atol=1e-5, rtol=1e-5)


def _stream(seed=7, n=8):
    rng = np.random.RandomState(seed)
    specs = [(int(rng.randint(3, 15)), int(rng.randint(2, 6)))
             for _ in range(n)]
    return [(rng.randint(0, 97, (S,)).astype(np.int32), N)
            for S, N in specs]


def _port_names(variant):
    return {k: v.replace("pallas_fused", "cuda_fused")
            for k, v in variant.items()}


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_engine_weight_quant_matches_jax_engine(params, wq):
    """ServingEngine(weight_quant=...) on the same fp tree and stream as
    the JAX engine: equal greedy ids and counters, the same
    weight_quant_variant (names mapped), and the dense generate over the
    engine's quantized tree gives the same ids (both routes are
    dequantize-then-matmul on the CPU)."""
    jp, tp = params
    je = jinf.ServingEngine(jp, CFG, weight_quant=wq, **ENGINE)
    te = ServingEngine(tp, TCFG, weight_quant=wq, device="cpu", **ENGINE)
    stream = _stream()
    jr = [je.submit(p, jinf.GenerationConfig(max_new_tokens=N, greedy=True))
          for p, N in stream]
    tr = [te.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
          for p, N in stream]
    je.drain()
    te.drain()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    for k in ("decode_steps", "prefill_chunks", "tokens_generated"):
        assert te.counters[k] == je.counters[k], k
    jm, tm = je.metrics(), te.metrics()
    assert _port_names(tm["weight_quant_variant"]) \
        == _port_names(jm["weight_quant_variant"]) == {
            "mode": wq, "weight_dtype": wq, "block": "composed",
            "attn": "unfused", "mlp": "unfused"}
    for k in tptq.WQ_KEYS:
        for part, arr in jptq.quantize_weights(
                jp, bits={"int8": 8, "int4": 4}[wq])["layers"][k].items():
            _same(te.params["layers"][k][part].numpy(), arr)
    p, N = stream[0]
    ids = generate(te.params, p[None], TCFG,
                   GenerationConfig(max_new_tokens=N, greedy=True),
                   device="cpu")
    assert ids[0, len(p):].tolist() == tr[0].tokens


def test_engine_takes_a_jax_quantized_tree_as_is(params):
    """A tree the JAX harness quantized (activation-aware) rides through
    params_from_jax unchanged: the engine adopts its mode and matches the
    JAX engine on it; a requested mode that differs raises."""
    jp, _ = params
    prompt = np.random.RandomState(3).randint(0, 97, (12,)).astype(np.int32)
    jqp = jptq.quantize_weights(
        jp, bits=4, act_absmax=jptq.activation_absmax(jp, CFG, prompt))
    tqp = tllama.params_from_jax(_np(jqp), device="cpu")
    te = ServingEngine(tqp, TCFG, device="cpu", **ENGINE)
    je = jinf.ServingEngine(jqp, CFG, **ENGINE)
    assert te.params["layers"]["q_proj"]["qw4"] \
        is tqp["layers"]["q_proj"]["qw4"]
    assert te.weight_quant_variant["mode"] == "int4"
    stream = _stream(seed=8, n=4)
    tr = [te.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
          for p, N in stream]
    jr = [je.submit(p, jinf.GenerationConfig(max_new_tokens=N, greedy=True))
          for p, N in stream]
    te.drain()
    je.drain()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    with pytest.raises(ValueError, match="int4 quantized weights"):
        ServingEngine(tqp, TCFG, weight_quant="int8", device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="weight_quant must be"):
        ServingEngine(tqp, TCFG, weight_quant="int2", device="cpu", **ENGINE)


@pytest.mark.parametrize("fused", [False, "auto", "ref"])
def test_weight_quant_variant_schema_matches_jax(params, fused):
    jp, tp = params
    kw = dict(capacity=2, block_size=4, prefill_buckets=(8,),
              max_seq_len=32, fused_decode=fused, weight_quant="int8")
    je = jinf.ServingEngine(jp, CFG, **kw)
    te = ServingEngine(tp, TCFG, device="cpu", **kw)
    for _ in range(2):
        assert _port_names(te.metrics()["weight_quant_variant"]) \
            == _port_names(je.metrics()["weight_quant_variant"])
        for eng, G in ((je, jinf.GenerationConfig), (te, GenerationConfig)):
            eng.submit(np.arange(5, dtype=np.int32),
                       G(max_new_tokens=3, greedy=True))
            eng.drain()
    off = ServingEngine(tp, TCFG, device="cpu", **dict(kw, weight_quant=None))
    assert off.weight_quant_variant == {"mode": "off"}


@pytest.mark.parametrize("wbytes", [1.0, 0.5], ids=["int8", "int4"])
def test_roofline_quantized_bytes_match_jax_model(wbytes):
    """decode_step_bytes with quantized weights: the two-stage and unfused
    arms equal the JAX model's (scales not counted in either)."""
    dims = (8, 4096, 32, 32, 128, 11008, 16, 72)
    got = troof.decode_step_bytes(*dims, act_itemsize=2,
                                  weight_itemsize=wbytes, pool_itemsize=2)
    want = jroof.decode_step_bytes(*dims, act_itemsize=2,
                                   weight_itemsize=wbytes, pool_itemsize=2)
    assert got["cuda_fused"] == want["pallas_fused"]
    assert got["unfused"] == want["unfused"]
    fp = troof.decode_step_bytes(*dims)
    w = (2 * 4096 * 4096 + 2 * 4096 * 4096 + 3 * 4096 * 11008)
    assert fp["cuda_block"] - got["cuda_block"] == int(w * (2 - wbytes))


def test_engine_roofline_counts_quantized_weights(params):
    _, tp = params
    fp = ServingEngine(tp, TCFG, device="cpu", **ENGINE).metrics()
    i4 = ServingEngine(tp, TCFG, device="cpu", weight_quant="int4",
                       **ENGINE).metrics()
    L, D, F = 2, 64, 128
    w = L * (2 * D * 64 + 2 * D * 32 + 3 * D * F)
    for arm in ("cuda_block", "cuda_fused", "unfused"):
        assert fp["roofline"]["variants"][arm]["bytes_per_step"] \
            - i4["roofline"]["variants"][arm]["bytes_per_step"] \
            == int(w * 3.5)
