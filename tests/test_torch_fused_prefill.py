"""PyTorch/CUDA port, fused prefill route: the plain version of the prefill
attention kernel against the JAX package's reference and its Pallas kernel
(interpret mode), the chunk's pool write, the predicates and resolvers,
the fused chunk forward, and the engine's ``fused_prefill`` knob, on the
CPU (f32).

The shapes and ragged cases are tests/test_fused_prefill_block.py's;
inputs are made with numpy from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops.pallas import fused_prefill_block as jfpb
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        generation as tgen,
                                        serving as tserving)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
from paddle_tpu_torch.ops.kernels.registry import KERNELS

pytestmark = pytest.mark.torch_port

CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=160, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
TOL = dict(atol=2e-5, rtol=1e-5)     # the JAX tests' own tolerance
PALLAS_TOL = dict(atol=1e-4, rtol=1e-4)
OPS = ("prefill_attn_block", "prefill_mlp_block")


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _kernel_inputs(P=16, D=32, H=4, KV=2, hd=16, BS=8, MB=6, pos0=0,
                   seed=0):
    """tests/test_fused_prefill_block.py's ``_kernel_inputs`` in numpy:
    the chunk's rope rows for positions pos0.., a permuted table."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    N = MB + 3
    x, nw = f(P, D), np.abs(f(D)) + 0.5
    wq, wk, wv = f(D, H * hd), f(D, KV * hd), f(D, KV * hd)
    wo = f(H * hd, D)
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    ang = (pos0 + np.arange(P))[:, None] * inv[None, :]
    sin, cos = np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)
    kp, vp = f(N, BS, KV, hd), f(N, BS, KV, hd)
    tab = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    return x, nw, wq, wk, wv, wo, sin, cos, kp, vp, tab


def _port(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _pallas(fn, *args, **kw):
    """A JAX Pallas kernel in interpret mode, traced with x64 off (what the
    JAX package's ``no_x64`` does through an API newer jax lacks)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _port_names(variant):
    return {k: v.replace("pallas_fused", "cuda_fused")
            for k, v in variant.items()}


# ---------------------------------------------------------------------------
# the plain version against the JAX reference and Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos0,n_valid", [
    (0, 16), (0, 1), (0, 13), (10, 13), (29, 7), (8, 16)])
def test_prefill_attn_block_ref_matches_jax(pos0, n_valid):
    """The six ragged cases of the JAX kernel tests: cold full chunk, one
    valid row, prime length, warm mid-page start, late warm start, page
    aligned warm start. All rows against the JAX reference, the live rows
    of x_out and all of k/v against the Pallas kernel."""
    args = _kernel_inputs(pos0=pos0, seed=pos0 * 31 + n_valid)
    jargs = [jnp.asarray(a) for a in args]
    got = fpb.prefill_attn_block_ref(*_port(args), pos0, n_valid)
    want = jfpb.prefill_attn_block_ref(*jargs, jnp.int32(pos0),
                                       jnp.int32(n_valid))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    pal = _pallas(jfpb.fused_prefill_attn_pallas, *jargs, jnp.int32(pos0),
                  jnp.int32(n_valid))
    _close(got[0][:n_valid].numpy(), np.asarray(pal[0])[:n_valid],
           **PALLAS_TOL)
    for g, w in zip(got[1:], pal[1:]):
        _close(g.numpy(), w, **PALLAS_TOL)


def test_prefill_attn_block_ref_gqa_two_query_blocks_and_bare():
    """Four query heads per KV head, a 32-row chunk in two 16-row query
    blocks (the second partly valid) at a warm start, and residual=False
    for the bare o_proj."""
    args = _kernel_inputs(P=32, H=8, KV=2, MB=8, pos0=16, seed=9)
    jargs = [jnp.asarray(a) for a in args]
    got = fpb.prefill_attn_block_ref(*_port(args), 16, 19)
    want = jfpb.prefill_attn_block_ref(*jargs, jnp.int32(16), jnp.int32(19))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    pal = _pallas(jfpb.fused_prefill_attn_pallas, *jargs, jnp.int32(16),
                  jnp.int32(19), block_q=16, pages_per_step=2)
    _close(got[0][:19].numpy(), np.asarray(pal[0])[:19], **PALLAS_TOL)
    bare = fpb.prefill_attn_block_ref(*_port(args), 16, 19, residual=False)
    _close(bare[0].numpy(), jfpb.prefill_attn_block_ref(
        *jargs, jnp.int32(16), jnp.int32(19), residual=False)[0])


def test_write_chunk_to_pool_matches_jax():
    """tests/test_fused_prefill_block.py's write: valid rows land at their
    positions through the write table, pad rows on scratch page 0."""
    BS, KV, hd = 8, 2, 16
    wtable = np.asarray([0, 3, 5, 7], np.int32)
    kn = np.ones((16, KV, hd), np.float32)
    vn = np.full((16, KV, hd), 2.0, np.float32)
    want = jpa.write_chunk_to_pool(jnp.zeros((9, BS, KV, hd)),
                                   jnp.zeros((9, BS, KV, hd)),
                                   jnp.asarray(wtable), 8, 10,
                                   jnp.asarray(kn), jnp.asarray(vn))
    kp, vp = torch.zeros(9, BS, KV, hd), torch.zeros(9, BS, KV, hd)
    out = tpa.write_chunk_to_pool(kp, vp, torch.from_numpy(wtable), 8, 10,
                                  torch.from_numpy(kn), torch.from_numpy(vn))
    assert out[0] is kp and out[1] is vp              # in place
    for g, w in zip((kp, vp), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (kp[3] == 1).all() and (kp[5, :2] == 1).all()
    assert (kp[5, 2:] == 0).all() and (kp[0, 2:] == 1).all()   # pad rows
    assert (vp[0, 2:] == 2).all() and (kp[7] == 0).all()


# ---------------------------------------------------------------------------
# knob, predicates and resolvers
# ---------------------------------------------------------------------------
def test_fused_prefill_mode_matches_jax():
    for v in (None, True, False, "auto", "pallas", "ref"):
        assert tgen._fused_prefill_mode(v) == jgen._fused_prefill_mode(v), v
    with pytest.raises(ValueError, match="fused_prefill"):
        tgen._fused_prefill_mode("bogus")


def test_cpu_dispatch_picks_unfused_with_reason():
    meta = fpb.prefill_meta(TCFG, P=16, BS=8, MB=6, pool_dtype=torch.float32,
                            quant=False, device="cpu")
    assert "P" in meta and "B" not in meta
    attn_fn, mlp_fn, names = fpb.resolve_prefill_blocks(meta, "auto")
    assert names == {"attn": "unfused", "mlp": "unfused"}
    assert attn_fn is fpb.prefill_attn_block_ref
    assert mlp_fn is fpb.prefill_mlp_block_ref
    for op in OPS:
        rej, sel = KERNELS.explain(op, meta)
        assert rej["name"] == "cuda_fused" and not rej["supported"]
        assert rej["reason"] == "plain composition on the CPU"
        assert sel["selected"]


def _cuda_meta(P=128, D=4096, H=32, KV=32, hd=128, F=11008,
               dtype=torch.bfloat16, **kw):
    return fpb.prefill_meta_dims(P, D, H, KV, hd, F, 16, 72, dtype,
                                 kw.pop("pool_dtype", dtype),
                                 kw.pop("quant", False), device="cuda", **kw)


@pytest.mark.parametrize("KV", [32, 8])
def test_predicates_select_cuda_kernels_at_7b(KV):
    """At LLaMA-7B both serving buckets, in bf16 and f32, with KV=32 and
    with four query heads per KV head, fit the kernel's shared memory."""
    for P in (32, 128):
        for dt in (torch.bfloat16, torch.float32):
            meta = _cuda_meta(P=P, KV=KV, dtype=dt)
            for op in OPS:
                assert KERNELS.dispatch(op, meta)[0] == "cuda_fused", \
                    KERNELS.explain(op, meta)
            assert fpb.prefill_fused_selected(meta, "auto")
            need = fpb.prefill_attn_smem_bytes(4096, 32, KV, 128, 16,
                                               meta["itemsize"])
            assert need <= fpb._fdb.SMEM_LIMIT
    assert KERNELS.variant("prefill_mlp_block", "cuda_fused").fn \
        is fpb._fdb.decode_mlp_block_cuda


@pytest.mark.parametrize("case,reason", [
    (dict(quant=True), "int8 cache"),
    (dict(weight_dtype="int4", D=4095), "even hidden_size"),
    (dict(dtype=torch.float16), "dtype float16"),
    (dict(pool_dtype=torch.float32), "pool dtype"),
    (dict(H=6, KV=4, D=768), "H not a multiple of KV"),
    (dict(hd=4), "head_dim 4"),
    (dict(D=4100), "hidden 4100"),
    (dict(P=24), "P=24"),
    (dict(D=8192, KV=8, dtype=torch.float32), "shared memory"),
], ids=["case0-int8 cache / weight-quant",
        "case1-int8 cache / weight-quant", "case2-dtype float16",
        "case3-pool dtype", "case4-H not a multiple of KV",
        "case5-head_dim 4", "case6-hidden 4100", "case7-P=24",
        "case8-shared memory"])
def test_predicates_refuse_with_reason(case, reason):
    """On CUDA a refusal raises with its reason, from dispatch and from
    the resolver; only "ref" (or a force pin) runs the composition."""
    meta = _cuda_meta(**case)
    row = KERNELS.explain("prefill_attn_block", meta)[0]
    assert not row["supported"] and reason in row["reason"], row
    with pytest.raises(RuntimeError, match=reason):
        fpb.resolve_prefill_blocks(meta, "auto")
    assert fpb.resolve_prefill_blocks(meta, "ref")[2]["attn"] == "unfused"
    assert not fpb.prefill_fused_selected(meta, "ref")
    with KERNELS.force("prefill_attn_block", "unfused"):
        assert KERNELS.dispatch("prefill_attn_block", meta)[0] == "unfused"


def test_resolve_modes_and_selected_gate_match_jax():
    """The JAX truth table on the CPU (interpret mode there), the port's
    on a CPU meta; "auto" on a CUDA meta selects the fused chunk."""
    jmeta = jfpb.prefill_meta_dims(16, 32, 4, 2, 16, 64, 8, 6, jnp.float32,
                                   jnp.float32, False)
    tmeta = fpb.prefill_meta_dims(16, 32, 4, 2, 16, 64, 8, 6, torch.float32,
                                  torch.float32, False, device="cpu")
    for mode in ("auto", "pallas", "ref"):
        assert fpb.resolve_prefill_blocks(tmeta, mode)[2] == _port_names(
            jfpb.resolve_prefill_blocks(jmeta, mode)[2]), mode
    for mode in (None, False, "auto", "pallas", "ref"):
        assert fpb.prefill_fused_selected(tmeta, mode) \
            == jfpb.prefill_fused_selected(jmeta, mode), mode
    for resolve, meta in ((fpb.resolve_prefill_blocks, tmeta),
                          (jfpb.resolve_prefill_blocks, jmeta)):
        with pytest.raises(ValueError, match="auto|pallas|ref"):
            resolve(meta, "bogus")
    assert fpb.prefill_fused_selected(_cuda_meta(), "auto")
    assert not fpb.prefill_fused_selected(_cuda_meta(), False)


def test_prefill_wrapper_raises_on_cpu_tensors():
    args = _port(_kernel_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        fpb.prefill_attn_block_cuda(*args, 0, 16)
    assert fpb.prefill_attn_block_cuda.launches == 0


# ---------------------------------------------------------------------------
# the fused chunk forward and the engine
# ---------------------------------------------------------------------------
def test_fused_prefill_forward_matches_jax(params):
    """Two chunks of one 20-token prompt (cold, then warm at pos0=16, 4
    real rows of 16) through the port's ``_fused_prefill_forward`` ("ref")
    and the JAX one ("ref", and forced Pallas in interpret mode): the
    logits of the real rows and the pools at the prompt's positions."""
    jp, tp = params
    rng = np.random.RandomState(5)
    L, KV, hd, BS, MB, P = 2, 2, 16, 8, 6, 16
    N = MB + 3
    kp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    vp = (rng.randn(L, N, BS, KV, hd) * 0.1).astype(np.float32)
    table = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    prompt = rng.randint(0, 97, (20,)).astype(np.int32)
    chunks = [(0, 16), (16, 4)]
    pos = np.arange(20)
    page, off = table[pos // BS], pos % BS

    def run_port():
        k, v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        t = torch.from_numpy(table)
        logits = []
        for pos0, n in chunks:
            toks = np.zeros(P, np.int32)
            toks[:n] = prompt[pos0:pos0 + n]
            lg, _, _ = tgen._fused_prefill_forward(
                tp, torch.from_numpy(toks), TCFG, k, v, t, t, pos0, n,
                mode="ref")
            logits.append(lg[:n].numpy())
        return logits, k.numpy(), v.numpy()

    def run_jax(mode):
        k, v = jnp.asarray(kp), jnp.asarray(vp)
        t = jnp.asarray(table)
        logits = []
        for pos0, n in chunks:
            toks = np.zeros(P, np.int32)
            toks[:n] = prompt[pos0:pos0 + n]
            lg, k, v = _pallas(jgen._fused_prefill_forward, jp,
                               jnp.asarray(toks), CFG, k, v, t, t, pos0, n,
                               mode=mode)
            logits.append(np.asarray(lg)[:n])
        return logits, np.asarray(k), np.asarray(v)

    got = run_port()
    for mode in ("ref", "pallas"):
        want = run_jax(mode)
        for g, w in zip(got[0], want[0]):
            _close(g, w, **PALLAS_TOL)
        for g, w in zip(got[1:], want[1:]):
            _close(g[:, page, off], w[:, page, off], **PALLAS_TOL)


def _stream_specs(seed=7, n=22):
    rng = np.random.RandomState(seed)
    specs = [(int(rng.randint(3, 15)), int(rng.randint(2, 6)))
             for _ in range(n)]
    return [(rng.randint(0, 97, (S,)).astype(np.int32), N)
            for S, N in specs]


def _drain(eng, gen_cls, stream):
    reqs = [eng.submit(p, gen_cls(max_new_tokens=N, greedy=True))
            for p, N in stream]
    eng.drain()
    return reqs


def _finish_order(reqs):
    return sorted(range(len(reqs)), key=lambda i: reqs[i].finish_t)


def test_engine_default_stream_matches_jax(params):
    """tests/test_torch_fused_decode.py's 22-request stream through both
    engines with every route argument left at its default: equal ids,
    finish order, counters, decode_variant and prefill_variant."""
    jp, tp = params
    kw = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)
    stream = _stream_specs()
    je = jinf.ServingEngine(jp, CFG, **kw)
    te = ServingEngine(tp, TCFG, device="cpu", **kw)
    jr = _drain(je, jinf.GenerationConfig, stream)
    tr = _drain(te, GenerationConfig, stream)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert all(r.done for r in tr)
    assert _finish_order(tr) == _finish_order(jr)
    jm, tm = je.metrics(), te.metrics()
    for k in ("decode_steps", "prefill_chunks", "prefill_tokens",
              "prefill_pad_tokens", "tokens_generated",
              "requests_completed", "preemptions"):
        assert tm[k] == jm[k], k
    for k in ("decode_variant", "prefill_variant"):
        assert tm[k] == _port_names(jm[k]), k
    assert tm["prefill_variant"] == {"mode": "auto", "attn": "unfused",
                                     "mlp": "unfused"}


def test_engine_fused_chunk_program_on_cpu(params, monkeypatch):
    """With the fused chunk selected (a test-only patch of
    ``prefill_fused_selected``), the engine runs ``_fused_prefill_forward``
    over the composition on the CPU; its greedy ids equal the verbatim
    chunk's, prompts of several chunks included."""
    _, tp = params
    calls = []
    forward = tserving._fused_prefill_forward

    def counted(*a, **kw):
        calls.append(a[7])                        # pos0
        return forward(*a, **kw)

    kw = dict(capacity=2, block_size=8, prefill_buckets=(16, 32),
              max_seq_len=96)
    rng = np.random.RandomState(3)
    stream = [(rng.randint(0, 97, (int(S),)).astype(np.int32), 6)
              for S in rng.randint(4, 70, 8)]
    ref = _drain(ServingEngine(tp, TCFG, device="cpu", fused_prefill=False,
                               **kw), GenerationConfig, stream)
    monkeypatch.setattr(fpb, "prefill_fused_selected", lambda meta, m: True)
    monkeypatch.setattr(tserving, "_fused_prefill_forward", counted)
    eng = ServingEngine(tp, TCFG, device="cpu", **kw)
    got = _drain(eng, GenerationConfig, stream)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert len(calls) == eng.counters["prefill_chunks"] and max(calls) > 0
    assert eng.prefill_variant == {"mode": "auto", "attn": "unfused",
                                   "mlp": "unfused"}


def test_engine_fused_chunk_rope_rows_past_max_positions(params,
                                                         monkeypatch):
    """The last, bucket-padded chunk of a prompt near max_seq_len =
    max_position_embeddings reads rope rows past that bound (here rows
    128..159 of a 150-position model): the engine's table has MB*BS rows,
    so the fused chunk still equals the verbatim one."""
    _, tp = params
    cfg = dataclasses.replace(TCFG, max_position_embeddings=150)
    kw = dict(capacity=1, block_size=8, prefill_buckets=(16, 32),
              max_seq_len=150)
    prompt = np.random.RandomState(4).randint(0, 97, (145,)).astype(np.int32)
    ref = _drain(ServingEngine(tp, cfg, device="cpu", fused_prefill=False,
                               **kw), GenerationConfig, [(prompt, 4)])
    monkeypatch.setattr(fpb, "prefill_fused_selected", lambda meta, m: True)
    eng = ServingEngine(tp, cfg, device="cpu", **kw)
    assert eng._rope[0].shape[0] >= 128 + 32 > cfg.max_position_embeddings
    got = _drain(eng, GenerationConfig, [(prompt, 4)])
    assert got[0].tokens == ref[0].tokens


def test_unhonourable_prefill_routes_raise(params):
    _, tp = params
    kw = dict(capacity=2, block_size=4, max_seq_len=32)
    with pytest.raises(ValueError, match='fused_prefill="pallas"'):
        ServingEngine(tp, TCFG, device="cpu", fused_prefill="pallas", **kw)
    with pytest.raises(ValueError, match="fused_prefill"):
        ServingEngine(tp, TCFG, device="cpu", fused_prefill="bogus", **kw)


# ---------------------------------------------------------------------------
# prefill_attn_block's tensor-core body: its plan (the kernel runs on the
# card only; its plain version is prefill_attn_block_wq_ref)
# ---------------------------------------------------------------------------
def _capture_prefill(P, KV=32, wq=None, quant=False, D=4096, H=32, hd=128):
    from paddle_tpu_torch.analysis import kernel_catalog as kc
    from paddle_tpu_torch.ops.kernels import _launch
    build = kc._prefill_case(P, D, H, KV, hd, 16, 577, 72, "bfloat16", 512,
                             quant=quant, wq=wq)
    with _launch.capture_kernel_launches() as specs:
        build()()
    assert len(specs) == 1
    return specs[0]


@pytest.mark.parametrize("dt,hd,D,body", [
    ("bfloat16", 128, 4096, "tc"), ("float32", 128, 4096, "cuda_core"),
    ("bfloat16", 64, 4096, "cuda_core"), ("bfloat16", 128, 4112,
                                          "cuda_core")])
def test_prefill_body_by_dtype_and_head_dim(dt, hd, D, body):
    """bf16 at head dim 128 runs the tensor-core body, over fp and int8
    pools; f32, another head dim or a D the tiles cannot copy the CUDA-core
    one; the rule is recorded in the plan."""
    for kv_bits in (0, 8):
        got, why = fpb.prefill_body(128, D, 32, 32, hd, 16, dt, 0, kv_bits)
        assert got == body and why
    spec = _capture_prefill(128)
    assert spec.plan["body"] == "tc"
    assert spec.plan["body_rule"] == fpb.prefill_body(
        128, 4096, 32, 32, 128, 16, "bfloat16", 0, 0)[1]


@pytest.mark.parametrize("P,KV", [(128, 32), (32, 8), (144, 8)])
def test_prefill_tc_tiles_and_items_cover_once(P, KV):
    """The tensor-core plan's column tiles cover wq, wk, wv and wo exactly
    once, its row tiles every row, and the attention takes each (16-row
    query block, query head) once, over fp and over int8 pools."""
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    H, hd, D = 32, 128, 4096
    plan = fpb.prefill_tc_plan(P, D, H, KV, hd, 0, 132)
    R = fdb.TC_TILE_ROWS
    for key, n, T in (("q_tiles", H * hd, plan["qkv_cols"]),
                      ("kv_tiles", KV * hd, plan["qkv_cols"]),
                      ("o_tiles", D, plan["o_cols"])):
        assert (plan[key] - 1) * T < n <= plan[key] * T
    assert (plan["row_tiles"] - 1) * R < P <= plan["row_tiles"] * R
    spec = _capture_prefill(P, KV)
    attn = {p.name: p for p in spec.phases}["attention"]
    assert attn.items == -(-P // fpb.BQ) * H
    assert [p.name for p in spec.phases] == ["norm", "qkv", "rope",
                                             "attention", "o_proj",
                                             "combine"][:5 + (
                                                 plan["o_parts"] > 1)]
    assert plan["o_parts"] == (2 if P <= 128 else 1)
    q8 = _capture_prefill(P, KV, quant=True)
    assert {p.name: p for p in q8.phases}["attention"].items == \
        -(-P // fpb.BQ) * H


@pytest.mark.parametrize("KV,quant,wq", [(32, False, None), (8, False, None),
                                         (32, True, None), (8, True, None),
                                         (32, False, "int8"),
                                         (32, False, "int4")])
def test_prefill_tc_smem_within_limit_and_declared(KV, quant, wq):
    """The tensor-core body's shared memory (the larger of its product
    stages and its attention's) is what its launch declares, within the
    card's 227 KB a block, one block an SM."""
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    bits = {None: 0, "int8": 8, "int4": 4}[wq]
    want = fpb.prefill_tc_smem(bits, 8 if quant else 0)
    assert want <= fdb.SMEM_LIMIT
    # the q/k/v stages (64-column tiles), or for int4 weights the
    # attention's Q and two stages of 128 keys' K and V; over int8 pools
    # the attention's, with each warp's converted K and V rows
    assert want == (213248 if quant else
                    {0: 159744, 8: 147456, 4: 143616}[bits])
    spec = _capture_prefill(128, KV, wq=wq, quant=quant)
    assert spec.dyn_smem == want and spec.blocks_per_sm == 1
    assert spec.grid == (132,)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_prefill_body_and_smem_over_int8_pools(bits):
    """Over int8 pools the tensor-core body runs its attention on the
    tensor cores too (the reason says so): its shared memory is the
    attention's Q, two stages of 128 keys' K and V, and each of the 8
    warps' 16 keys converted to bf16, [16 + 512 + 256][136] bf16, in every
    weight class, within the card's limit; the CUDA-core body's rule
    (f32, another head dim) is unchanged."""
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    body, why = fpb.prefill_body(128, 4096, 32, 32, 128, 16, "bfloat16",
                                 bits, 8)
    assert body == "tc" and "int8 pools" in why and "tensor cores" in why
    smem = fpb.prefill_tc_smem(bits, 8)
    assert smem == (16 + 4 * 128 + 2 * 128) * 136 * 2 == 213248
    assert smem <= fdb.SMEM_LIMIT
    assert fpb.prefill_body(128, 4096, 32, 32, 128, 16, "float32", bits,
                            8)[0] == "cuda_core"
    assert fpb.prefill_body(128, 4096, 32, 32, 64, 16, "bfloat16", bits,
                            8)[0] == "cuda_core"


def test_tc_plan_constants_are_the_sources():
    """The Python plans' tile and attention constants are the ones the CUDA
    sources are built with (csrc/tile_mma.cuh, fused_prefill_block.cu)."""
    import re
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\w+);", text)[1])
    tm = (_build.CSRC / "tile_mma.cuh").read_text()
    pf = (_build.CSRC / "fused_prefill_block.cu").read_text()
    dc = (_build.CSRC / "fused_decode_block.cu").read_text()
    assert const(tm, "kTileRows") == fdb.TC_TILE_ROWS
    assert const(tm, "kChunkK") == fdb.TC_CHUNK_K
    assert const(dc, "kUpCols") == fdb.MLP_UP_COLS
    assert const(dc, "kDownCols") == fdb.MLP_DOWN_COLS
    assert const(pf, "kQkvCols") == fpb.QKV_COLS
    assert const(pf, "kOCols") == fpb.O_COLS
    assert const(tm, "kStages") == fdb.TC_STAGES
    assert const(pf, "kHd") == fpb.TC_HEAD_DIM
    assert const(pf, "kQRows") == fpb.BQ
