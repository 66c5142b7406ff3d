"""PyTorch/CUDA port, the single-launch decode route on the CPU: the plain
version of ``decode_block_fused`` against the JAX Pallas kernel (interpret
mode) and the composed tier against the JAX composed tier, the
single-launch dispatch contract, the decode step and the engine on the
block route against the JAX package's ``fused_decode="block"``, the
engine's ``metrics()`` key set and scheduler surface against the JAX
engine's, and the LayerNorm kernel's plain version against the JAX
LayerNorm kernel.

Inputs are made with numpy from a seed and handed to both packages. The
JAX Pallas kernels run in interpret mode with x64 off (their ``no_x64``
cannot enter under x64 with this jax).

Tolerances: f32 kernel outputs at the JAX block tests' own atol=5e-5,
rtol=1e-5 (the composed tiers of both packages at the port's 2e-5/1e-5);
decode-step logits 1e-4 and pools 1e-5, as tests/test_torch_fused_decode.py
holds the two-stage step; bf16 two ulps (relative 2^-6) of the element
plus two at the tensor's RMS, for the elements a residual add cancels
towards zero (chip_smoke.py's ``bf16_close``; the two frameworks round
bf16 at other places); LayerNorm f32 1e-6 (absolute and relative), bf16
one ulp (relative 2^-7)."""
import dataclasses
import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu import ops as jops
from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.observability import roofline as jroof
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu.ops.pallas import norms as jnorms
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        generation as tgen)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.observability import roofline as troof
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import norms as tnorms
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
KERNEL_TOL = dict(atol=5e-5, rtol=1e-5)
COMPOSED_TOL = dict(atol=2e-5, rtol=1e-5)
BLOCK = {"block": "cuda_block", "attn": "cuda_block", "mlp": "cuda_block"}
ENGINE = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


@pytest.fixture
def no_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def block_on_ref(monkeypatch):
    """The ``cuda_block`` variant runs its plain version: on the CPU it is
    the single-launch route's stand-in for the kernel."""
    monkeypatch.setattr(KERNELS.variant("decode_block_fused", "cuda_block"),
                        "fn", fdb.decode_block_ref)


def _rope_tables(T, hd):
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    t = np.arange(T)[:, None] * inv[None, :]
    return np.sin(t).astype(np.float32), np.cos(t).astype(np.float32)


def _block_case(rng, groups):
    """tests/test_fused_decode_block.py's ``_block_case`` in numpy (B 2,
    D 32, KV 2, hd 16, BS 8, MB 3, F 96): one slot mid-page, one empty
    (seq 0: only the new token), a permuted table."""
    B, D, KV, hd, BS, MB, F = 2, 32, 2, 16, 8, 3, 96
    H = KV * groups
    N = B * MB + 2
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    x = mk(B, D)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    wq, wk, wv, wo = mk(D, H * hd), mk(D, KV * hd), mk(D, KV * hd), \
        mk(H * hd, D)
    sin, cos = _rope_tables(BS * MB, hd)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([int(rng.randint(1, BS * MB)), 0], np.int32)
    kp, vp = mk(N, BS, KV, hd), mk(N, BS, KV, hd)
    pw = (rng.rand(D) + 0.5).astype(np.float32)
    wg, wu, wd = mk(D, F), mk(D, F), mk(F, D)
    return (x, nw, wq, wk, wv, wo, pw, wg, wu, wd, sin, cos, kp, vp, bt,
            lens)


_FLOAT_ARGS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13)   # in the model type


def _port(args, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype) if i in _FLOAT_ARGS
            else torch.from_numpy(np.array(a))
            for i, a in enumerate(args)]


def _jax(args, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) if i in _FLOAT_ARGS
            else jnp.asarray(a) for i, a in enumerate(args)]


def _np(t):
    return np.asarray(t.float()) if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, bf16=False, tol=KERNEL_TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if not bf16:
        np.testing.assert_allclose(g, w, **tol)
        return
    scale = np.maximum(np.abs(g), np.abs(w)) + np.sqrt(np.mean(w * w))
    assert np.all(np.abs(g - w) <= 2.0 ** -6 * scale), \
        float((np.abs(g - w) / scale).max())


def _pallas(fn, *args, **kw):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel; the composed tiers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2], ids=["clamp_edge", "gqa"])
def test_decode_block_ref_matches_pallas(groups, bf16):
    """decode_block_ref (the single-launch kernel's rounding points)
    against fused_decode_block_pallas at pages_per_step=2, block_f=32:
    x_out, k_new, v_new."""
    args = _block_case(np.random.RandomState(20 + groups), groups)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32,
                                                           jnp.float32)
    got = fdb.decode_block_ref(*_port(args, tdt))
    want = _pallas(jfdb.fused_decode_block_pallas, *_jax(args, jdt),
                   pages_per_step=2, block_f=32)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _close(g, w, bf16=bf16)


@pytest.mark.parametrize("groups", [1, 2], ids=["clamp_edge", "gqa"])
def test_decode_block_composed_matches_jax_and_ref(groups):
    """The port's composed tier equals the JAX composed tier (both the
    two-stage compositions on the CPU); the port's plain version of the
    single-launch kernel is a roundoff-level variant of it (f32)."""
    args = _block_case(np.random.RandomState(30 + groups), groups)
    got = fdb.decode_block_composed(*_port(args))
    want = jfdb.decode_block_composed(*_jax(args))
    for g, w in zip(got, want):
        _close(g, w, tol=COMPOSED_TOL)
    ref = fdb.decode_block_ref(*_port(args))
    for r, g in zip(ref, got):
        _close(r, g)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def _cuda_meta(B=8, D=4096, H=32, KV=32, hd=128, F=11008,
               dtype=torch.bfloat16, **kw):
    return fdb.decode_meta_dims(B, D, H, KV, hd, F, 16, 72, dtype,
                                kw.pop("pool_dtype", dtype),
                                kw.pop("quant", False), device="cuda", **kw)


def test_resolve_block_mode_and_cpu_composed_tier():
    """"block" forces the kernel and no stage functions, on any meta;
    "auto" on the CPU takes the composed tier (the compositions, with
    their reason); the two-stage resolver refuses "block"."""
    cpu = fdb.decode_meta(TCFG, B=2, BS=4, MB=4, pool_dtype=torch.float32,
                          quant=False, device="cpu")
    for meta in (cpu, _cuda_meta()):
        b_fn, a_fn, m_fn, names = fdb.resolve_decode_step(meta, "block")
        assert b_fn is fdb.decode_block_fused_cuda
        assert a_fn is None and m_fn is None and names == BLOCK
    b_fn, a_fn, m_fn, names = fdb.resolve_decode_step(cpu, "auto")
    assert b_fn is None
    assert a_fn is fdb.attn_block_ref and m_fn is fdb.mlp_block_ref
    assert names == {"block": "composed", "attn": "unfused",
                     "mlp": "unfused"}
    rows = KERNELS.explain("decode_block_fused", cpu)
    assert [r["name"] for r in rows] == ["cuda_block", "composed"]
    assert not rows[0]["supported"]
    assert rows[0]["reason"] == "plain composition on the CPU"
    assert rows[1]["selected"]
    assert KERNELS.dispatch("decode_block_fused", cpu)[1] \
        is fdb.decode_block_composed
    with pytest.raises(ValueError, match="resolve_decode_step"):
        fdb.resolve_decode_blocks(cpu, "block")


@pytest.mark.parametrize("KV", [32, 8])
def test_supports_block_accepts_7b(KV):
    """At LLaMA-7B the single-launch kernel fits the card's shared memory
    (the attention half's layout: 86,016 B in bf16), for any number of
    slots, so "auto" on the card takes it; the TPU predicate refuses bf16
    there (its VMEM envelope)."""
    for B in (1, 8, 32):
        for dt in (torch.bfloat16, torch.float32):
            meta = _cuda_meta(B=B, KV=KV, dtype=dt)
            ok, why = fdb._supports_block(meta)
            need = fdb.block_smem_bytes(4096, 32, KV, 128, 16,
                                        meta["itemsize"])
            assert ok and why == (f"fits shared memory ({need} of "
                                  f"{fdb.SMEM_LIMIT} B)")
            b_fn, _, _, names = fdb.resolve_decode_step(meta, "auto")
            assert b_fn is fdb.decode_block_fused_cuda and names == BLOCK
    assert fdb.block_smem_bytes(4096, 32, KV, 128, 16, 2) == 86016
    tpu = jfdb.decode_meta_dims(8, 4096, 32, KV, 128, 11008, 16, 72,
                                jnp.bfloat16, jnp.bfloat16, False)
    tpu["interpret"] = False
    assert not jfdb._supports_block(tpu)[0]


@pytest.mark.parametrize("case,reason", [
    (dict(quant=True), "int8 cache"),
    (dict(weight_dtype="int8", quant=True), "int8 cache"),
    (dict(weight_dtype="int4", D=4095), "even hidden_size"),
    (dict(H=6, KV=4, D=768), "H not a multiple of KV"),
    (dict(D=8192, dtype=torch.float32), "shared memory"),
    (dict(hd=12, H=8, KV=8, dtype=torch.float32), "not a multiple of 8"),
], ids=["quant", "int8", "int4", "h_kv", "smem", "head_dim"])
def test_supports_block_refuses_with_reason(case, reason):
    meta = _cuda_meta(**case)
    ok, why = fdb._supports_block(meta)
    assert not ok and reason in why, why
    if case.get("hd") == 12:
        # the two-stage kernels take it: "auto" falls back to them there
        b_fn, a_fn, m_fn, names = fdb.resolve_decode_step(meta, "auto")
        assert b_fn is None and a_fn is fdb.decode_attn_block_cuda
        assert names == {"block": "composed", "attn": "cuda_fused",
                         "mlp": "cuda_fused"}


def test_block_wrapper_raises_on_cpu_and_quant():
    args = _port(_block_case(np.random.RandomState(0), 1))
    with pytest.raises(ValueError, match="CUDA"):
        fdb.decode_block_fused_cuda(*args)
    # scales without int8 pools (the int8 cache) are refused before the
    # device is looked at
    with pytest.raises(ValueError, match="int8 cache"):
        fdb.decode_block_fused_cuda(*args, kv_scales=(None, None))
    assert fdb.decode_block_fused_cuda.launches == 0


def test_engine_block_refused_on_cpu(params):
    """A pin must never silently no-op: "block" forces the CUDA kernel,
    which the CPU cannot run."""
    _, tp = params
    with pytest.raises(ValueError, match='"block" forces the CUDA'):
        ServingEngine(tp, TCFG, device="cpu", fused_decode="block", **ENGINE)


# ---------------------------------------------------------------------------
# the slice as a whole: the decode step and the engine on the block route
# ---------------------------------------------------------------------------
def test_block_step_matches_jax(params, block_on_ref, no_x64):
    """_fused_decode_step(mode="block") against the JAX step on the
    single-launch kernel (interpret): logits and pools."""
    jp, tp = params
    rng = np.random.RandomState(6)
    L, KV, hd, B, BS, MB = 2, 2, 16, 2, 4, 4
    N = B * MB + 1
    kp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    vp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    tok = rng.randint(0, 97, (B,)).astype(np.int32)
    bt = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray([5, 0], np.int32)
    k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, _, _ = tgen._fused_decode_step(
        tp, torch.from_numpy(tok), TCFG, k, v, torch.from_numpy(bt),
        torch.from_numpy(lens), mode="block")
    jl, jk, jv = jgen._fused_decode_step(
        jp, jnp.asarray(tok), CFG, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lens), mode="block")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


def test_block_engine_stream_matches_jax(params, block_on_ref, no_x64):
    """A short greedy stream: the port's engine pinned to the
    single-launch variant (its plain version standing in for the kernel)
    against the JAX engine with fused_decode="block", and against the
    port's own composed route: equal ids."""
    jp, tp = params
    rng = np.random.RandomState(12)
    specs = [(int(rng.randint(3, 15)), int(rng.randint(2, 6)))
             for _ in range(6)]
    prompts = [rng.randint(0, 97, (S,)).astype(np.int32) for S, _ in specs]
    je = jinf.ServingEngine(jp, CFG, fused_decode="block", **ENGINE)
    jr = [je.submit(p, jinf.GenerationConfig(max_new_tokens=N, greedy=True))
          for p, (_, N) in zip(prompts, specs)]
    je.drain()
    streams = {}
    for route in ("block", "composed"):
        te = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
        tr = [te.submit(p, GenerationConfig(max_new_tokens=N, greedy=True))
              for p, (_, N) in zip(prompts, specs)]
        if route == "block":
            with KERNELS.force("decode_block_fused", "cuda_block"):
                te.drain()
            assert te.decode_variant == {"mode": "auto", **BLOCK}
            assert je.decode_variant == {"mode": "block",
                                         **{k: "pallas_block"
                                            for k in BLOCK}}
        else:
            te.drain()
            assert te.decode_variant["block"] == "composed"
        assert all(r.done for r in tr)
        streams[route] = [r.tokens for r in tr]
    assert streams["block"] == [r.tokens for r in jr]
    assert streams["block"] == streams["composed"]


# ---------------------------------------------------------------------------
# metrics() and the scheduler surface against the JAX engine
# ---------------------------------------------------------------------------
def _both(params, **kw):
    jp, tp = params
    kw = {**ENGINE, **kw}
    return (jinf.ServingEngine(jp, CFG, **kw),
            ServingEngine(tp, TCFG, device="cpu", **kw))


def _stream(engines, n=5, seed=3, new=(2, 5)):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 97, (int(rng.randint(3, 20)),)).astype(
        np.int32) for _ in range(n)]
    news = [int(rng.randint(*new)) for _ in range(n)]
    out = []
    for eng, G in zip(engines, (jinf.GenerationConfig, GenerationConfig)):
        out.append([eng.submit(p, G(max_new_tokens=m, greedy=True))
                    for p, m in zip(prompts, news)])
    return out


@pytest.mark.parametrize("fused", [False, "auto"])
def test_metrics_keys_match_jax(params, fused):
    """metrics() has exactly the JAX engine's keys plus the port's one
    documented extra, ``decode_step_ms_mean``; the trace and offload
    counters agree; ``roofline`` has the JAX sub-dict schema, with the
    port's routes and the H100's memory rate, and no achieved share on
    the CPU."""
    je, te = _both(params, fused_decode=fused)
    for _ in range(2):
        jm, tm = je.metrics(), te.metrics()
        assert set(tm) == set(jm) | {"decode_step_ms_mean"}
        assert set(tm["scheduler"]) == set(jm["scheduler"])
        assert set(tm["roofline"]) == set(jm["roofline"])
        assert set(tm["roofline"]["variants"]) == {"cuda_block",
                                                    "cuda_fused", "unfused"}
        for row in tm["roofline"]["variants"].values():
            assert set(row) == set(
                next(iter(jm["roofline"]["variants"].values())))
            assert row["achieved_bw_frac"] is None
        assert set(tm["roofline"]["peak_source"]) == set(
            jm["roofline"]["peak_source"])
        assert tm["roofline"]["peak_hbm_bw"] == 3.35e12
        assert "H100" in tm["roofline"]["peak_source"]["hbm_bw"]
        assert tm["roofline"]["layers"] == 2
        assert tm["roofline"]["active"] == "unfused"
        for k in ("decode_traces", "prefill_traces", "calibration_traces",
                  "offload_traces", "kv_spill_bytes", "kv_restore_bytes"):
            assert tm[k] == jm[k], k
        _stream((je, te))
        je.drain()
        te.drain()
    assert tm["decode_traces"] == 1 and set(tm["prefill_traces"]) == {8, 16}


def test_roofline_bytes_match_jax_model():
    """The port's per-layer byte model: the two-stage and unfused routes
    are the JAX model's pallas_fused and unfused arms; the single-launch
    route reads every weight once (no per-row MLP refetch) and moves the
    f32 residual through device memory once each way."""
    dims = (8, 4096, 32, 32, 128, 11008, 16, 72)
    t = troof.decode_step_bytes(*dims)
    j = jroof.decode_step_bytes(*dims)
    assert t["cuda_fused"] == j["pallas_fused"]
    assert t["unfused"] == j["unfused"]
    assert t["cuda_block"] == t["cuda_fused"] - 2 * 8 * 4096 * 2 \
        + 2 * 8 * 4096 * 4
    r = troof.decode_roofline(t, measured_us={"cuda_block": 400.0})
    row = r["variants"]["cuda_block"]
    assert row["achieved_bw_frac"] == float(
        f"{row['bytes_per_step'] / 3.35e12 * 1e6 / 400.0:.4g}")


def test_request_output_ids_matches_jax(params):
    je, te = _both(params)
    jr, tr = _stream((je, te), n=3)
    je.drain()
    te.drain()
    for a, b in zip(jr, tr):
        assert b.output_ids.dtype == np.int32
        np.testing.assert_array_equal(b.output_ids, a.output_ids)


def test_queue_depth_live_slots_snapshot_match_jax(params):
    """queue_depth, live_slots and scheduler_snapshot() agree with the JAX
    engine's after each step of a stream that overfills the slots."""
    je, te = _both(params)
    _stream((je, te), n=6)
    for _ in range(6):
        assert te.queue_depth == je.queue_depth
        assert te.live_slots == je.live_slots
        assert te.scheduler_snapshot() == je.scheduler_snapshot()
        je.step()
        te.step()
    assert te.queue_depth < 6 and te.live_slots > 0


def test_reset_metrics_matches_jax(params):
    """reset_metrics() zeroes the same counters as the JAX engine's (the
    trace counters stay) and cuts the warm-up TTFTs out of the mean."""
    je, te = _both(params)
    _stream((je, te), n=3)
    je.drain()
    te.drain()
    for eng in (je, te):
        eng.reset_metrics()
    jm, tm = je.metrics(), te.metrics()
    for k, v in jm.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and k not in ("wall_time_s", "tokens_per_sec",
                              "prefill_tokens_per_sec"):
            assert tm[k] == v, k
    assert tm["ttft_ms_mean"] is None and tm["decode_step_ms_mean"] is None
    assert tm["decode_traces"] == je.counters["decode_traces"] == 1
    assert tm["scheduler"] == jm["scheduler"]
    _stream((je, te), n=2, seed=4)
    je.drain()
    te.drain()
    for k in ("decode_steps", "prefill_chunks", "tokens_generated",
              "requests_completed"):
        assert te.counters[k] == je.counters[k] > 0, k
    assert te.metrics()["ttft_ms_mean"] is not None


def test_block_manager_constructor_matches_jax():
    assert list(inspect.signature(tpa.BlockManager).parameters) == list(
        inspect.signature(jpa.BlockManager).parameters)
    t, j = tpa.BlockManager(12, 4, 5), jpa.BlockManager(12, 4, 5)
    assert (t.num_blocks, t.block_size, t.max_blocks_per_seq) == \
        (j.num_blocks, j.block_size, j.max_blocks_per_seq)


# ---------------------------------------------------------------------------
# LayerNorm: the plain version against the JAX kernel and reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,bf16", [((24, 128), False),
                                        ((4096, 1024), False),
                                        ((3, 5, 200), True)],
                         ids=["tiny_f32", "flagship_train_f32",
                              "ragged_bf16"])
def test_layer_norm_ref_matches_jax(shape, bf16):
    """layer_norm_ref against the JAX layer_norm_pallas (interpret) and
    layer_norm_ref: the kernel catalog's two shapes in f32, and a ragged
    bf16 one (rows the JAX kernel pads, a width no power of two)."""
    rng = np.random.RandomState(shape[-1])
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    b = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32,
                                                           jnp.float32)
    got = tnorms.layer_norm_ref(*(torch.from_numpy(a).to(tdt)
                                  for a in (x, w, b)), 1e-5)
    jargs = [jnp.asarray(a).astype(jdt) for a in (x, w, b)]
    for want in (_pallas(jnorms.layer_norm_pallas, *jargs, 1e-5),
                 jops.layer_norm_ref(*jargs, 1e-5)):
        assert got.dtype == tdt and got.shape == want.shape
        g, wn = _np(got), _np(want)
        if bf16:
            assert np.all(np.abs(g - wn) <= 2.0 ** -7 * np.maximum(
                np.abs(g), np.abs(wn)))
        else:
            np.testing.assert_allclose(g, wn, atol=1e-6, rtol=1e-6)


def test_layer_norm_op_and_wrapper():
    """ops.layer_norm is the plain version (as in the JAX package), with
    or without weight and bias; the kernel's wrapper takes CUDA tensors
    only."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 32).astype(np.float32))
    w, b = torch.ones(32) * 1.5, torch.full((32,), 0.25)
    assert torch.equal(tops.layer_norm(x, w, b), tops.layer_norm_ref(x, w, b))
    jx = jnp.asarray(x.numpy())
    np.testing.assert_allclose(tops.layer_norm(x, None, None).numpy(),
                               np.asarray(jops.layer_norm(jx, None, None)),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.layer_norm_fwd_triton(x, w, b)
    assert tnorms.layer_norm_fwd_triton.launches == 0


# ---------------------------------------------------------------------------
# decode_mlp_block at chunk rows: the tensor-core body's plan (the kernel
# runs on the card only; its plain version is mlp_block_wq_ref)
# ---------------------------------------------------------------------------
def _capture_mlp(B, D, F, dtype="bfloat16", wq=None):
    from paddle_tpu_torch.analysis import kernel_catalog as kc
    from paddle_tpu_torch.ops.kernels import _launch
    build = kc._mlp_block_case(B, D, F, dtype, wq=wq)
    with _launch.capture_kernel_launches() as specs:
        build()()
    assert len(specs) == 1
    return specs[0]


@pytest.mark.parametrize("B,dt,floor,body", [
    (8, "bfloat16", None, "ring"), (9, "bfloat16", None, "tc"),
    (32, "bfloat16", None, "tc"), (128, "bfloat16", None, "tc"),
    (128, "float32", None, "cuda_core"), (32, "bfloat16", 64, "cuda_core")])
def test_mlp_body_by_dtype_and_rows(B, dt, floor, body):
    """bf16 from MLP_TC_MIN_ROWS rows on runs the tensor-core body; 8 rows
    (a decode step) the weight ring; f32 and the gate's specimen the
    CUDA-core one; the rule is recorded in the plan."""
    got, why = fdb.mlp_body(B, 4096, 11008, dt, floor)
    assert got == body and why
    if floor is None:
        spec = _capture_mlp(B, 4096, 11008, dt)
        assert spec.plan["body"] == body
        assert spec.plan["body_rule"] == why
    assert fdb.mlp_body(32, 4096, 11000, "bfloat16")[0] == "cuda_core"
    assert fdb.mlp_body(32, 4112, 11008, "bfloat16")[0] == "cuda_core"


@pytest.mark.parametrize("B,D,F", [(20, 160, 208), (128, 4096, 11008),
                                   (130, 96, 80), (24, 64, 400)])
def test_mlp_tc_tiles_cover_rows_and_columns_once(B, D, F):
    """Every (row tile, column tile) of gate/up, and every (row tile, part
    of F, column tile) of down, is one item, exactly once; the tiles cover
    every row and column exactly once and the parts every chunk of F: the
    plan drops and repeats nothing. Down splits F where its tiles are fewer
    than the grid's blocks (LLaMA-7B: 64 tiles in 2 parts on 132)."""
    plan = fdb.mlp_tc_plan(B, D, F, 0, 132)
    R = fdb.TC_TILE_ROWS
    for key, n, T in (("up_tiles", F, plan["up_cols"]),
                      ("down_tiles", D, plan["down_cols"])):
        # the kernel's items: (row tile, column tile), the column fastest
        n_items = plan["row_tiles"] * plan[key]
        items = [(i // plan[key], i % plan[key]) for i in range(n_items)]
        assert len(set(items)) == n_items
        rows = np.zeros(B, int)
        cols = np.zeros(n, int)
        for rt in range(plan["row_tiles"]):
            rows[rt * R:(rt + 1) * R] += 1
        for ct in range(plan[key]):
            cols[ct * T:(ct + 1) * T] += 1
        assert (rows == 1).all() and (cols == 1).all()
    parts, chunks = plan["down_parts"], -(-F // fdb.TC_CHUNK_K)
    per = fdb.part_rows(F, parts) // fdb.TC_CHUNK_K
    seen = np.zeros(chunks, int)
    for p in range(parts):
        seen[p * per:(p + 1) * per] += 1
    assert (seen == 1).all() and (parts - 1) * per < chunks
    assert plan["down_k"] == F
    if (B, D, F) == (128, 4096, 11008):
        assert (plan["down_tiles"], parts) == (64, 2)


@pytest.mark.parametrize("wq,want", [(None, 215040), ("int8", 190464),
                                     ("int4", 165888)])
def test_mlp_tc_smem_within_limit_and_declared(wq, want):
    """The tensor-core body's shared memory (the A stages and each weight's
    stages, the larger phase) is what its launch declares, within the
    card's 227 KB a block, one block an SM."""
    bits = {None: 0, "int8": 8, "int4": 4}[wq]
    assert fdb.mlp_tc_smem(bits) == want <= fdb.SMEM_LIMIT
    spec = _capture_mlp(128, 4096, 11008, wq=wq)
    assert spec.dyn_smem == want
    assert spec.blocks_per_sm == 1 and spec.grid == (132,)
    assert [p.name for p in spec.phases] == ["norm", "gate_up", "down",
                                             "combine"]
    assert spec.phases[1].items == 172 and spec.phases[2].items == 128


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_mlp_chunk_rows_plain_version_matches_jax_kernel(bits):
    """At chunk rows in bf16 the tensor-core body's plain version
    (mlp_block_wq_ref: the products' f32 sums scaled, cast at the JAX
    kernel's points) against the JAX MLP kernel (interpret) on the same
    quantized leaves, to two bf16 ulps."""
    from paddle_tpu.quantization import ptq
    rng = np.random.RandomState(40 + bits)
    D, F, B = 64, 96, 20
    mk = lambda *s: (rng.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    x, nw = mk(B, D), (rng.rand(D) + 0.5).astype(np.float32)
    ws = [mk(D, F), mk(D, F), mk(F, D)]
    jx = jnp.asarray(x, jnp.bfloat16)
    jnw = jnp.asarray(nw, jnp.bfloat16)
    jws = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    if bits:
        jws = [ptq.quantize_leaf(w, bits, pack_axis=1 if i == 2 else 0)
               for i, w in enumerate(jws)]

    def port(leaf):
        if isinstance(leaf, dict):
            return {k: torch.from_numpy(np.array(v)) for k, v in
                    leaf.items()}
        return torch.from_numpy(np.asarray(leaf, np.float32)).to(
            torch.bfloat16)
    got = fdb.mlp_block_wq_ref(port(jx), port(jnw), *map(port, jws))
    want = _pallas(jfdb.fused_mlp_block_pallas, jx, jnw, *jws)
    _close(got, want, bf16=True)
