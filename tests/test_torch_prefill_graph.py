"""PyTorch/CUDA port, the prefill programs (the JAX engine's one jitted
chunk a bucket, a CUDA graph on the card) and ``generate_paged``'s decode
step over fixed buffers. On the CPU every program runs its body eagerly
over the same fixed buffers the card's graphs read, every position taken
from the chunk's bounds buffer, so these tests hold that structure: the
engine's ids and ``prefill_traces`` against the JAX engine's on every
prefill route (a prefix hit at a ``pos0`` off a bucket multiple
included); every composition that takes a device position against the
same call with a host int, bit for bit; the buffers' addresses and what
they hold; a replay's plans at each chunk's own (pos0, n); and
``generate_paged``'s fixed-buffer step against the eager loop it
replaces. Stated tolerances are bitwise."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        ServingMesh, generate_paged)
from paddle_tpu_torch.inference import generation as tgen
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference import tp as ttp
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
from paddle_tpu_torch.ops.rope import build_rope_cache
from paddle_tpu_torch.quantization import quantize_weights

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
ENGINE = dict(capacity=2, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=80)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


ROUTES = {
    "default": {},
    "ref": {"fused_prefill": "ref"},
    "unfused": {"fused_decode": False, "fused_prefill": False},
    "int8_weights": {"weight_quant": "int8"},
    "int8_cache": {"cache_dtype": "int8"},
    "tp1_psum": {"mesh": (1, "psum")},
    "tp2_psum": {"mesh": (2, "psum")},
    "tp2_gather": {"mesh": (2, "gather")},
    "prefix": {"prefix_cache": True},
    # the fused chunk's program (selected by a test-only patch; on the
    # CPU its ops are the compositions) against the JAX verbatim chunk
    "fused_chunk": {},
}


def _knobs(route, port):
    kw = dict(ROUTES[route])
    if "mesh" in kw:
        tp, coll = kw.pop("mesh")
        kw["mesh"] = (ServingMesh.make(tp, collective=coll,
                                       devices=["cpu"] * tp) if port else
                      jinf.ServingMesh.make(tp=tp, collective=coll))
    return kw


def _prompts(route):
    """Prompts that run both buckets and several chunks; on the prefix
    route the later ones share 14 tokens with the first (3 full pages of
    4 and a 2-token tail: their suffix prefills at pos0 14)."""
    rng = np.random.RandomState(5)
    if route == "prefix":
        first = rng.randint(0, 97, (22,)).astype(np.int32)
        return [(first, 4)] + [
            (np.concatenate([first[:14],
                             rng.randint(0, 97, (S,)).astype(np.int32)]), N)
            for S, N in ((11, 5), (25, 3), (3, 4))]
    return [(rng.randint(0, 97, (S,)).astype(np.int32), N)
            for S, N in ((5, 4), (9, 6), (30, 3), (17, 5), (40, 2))]


def _staged(monkeypatch):
    """Record every chunk's (bucket, pos0, n) as the engine stages it."""
    seen = []
    stage = tserving._ChunkBuffers.stage

    def record(self, toks, pos0, n, *a):
        seen.append((toks.shape[0], pos0, n))
        return stage(self, toks, pos0, n, *a)
    monkeypatch.setattr(tserving._ChunkBuffers, "stage", record)
    return seen


@pytest.mark.parametrize("route", list(ROUTES))
def test_prefill_program_matches_jax_engine(params, route, monkeypatch):
    """The port's engine, whose chunks run one program a bucket over that
    bucket's fixed buffers, against the JAX engine's jitted chunks on the
    same requests and route: equal greedy ids and chunk counters, and
    ``prefill_traces`` equal to the JAX engine's (one build a bucket used,
    as the JAX engine traces once a bucket); one program a bucket. On the
    prefix route a hit prefills its suffix at pos0 14, no bucket
    multiple, with a write table that sends the shared pages to
    scratch."""
    jp, tp = params
    seen = _staged(monkeypatch)
    jkw = dict(ENGINE, **_knobs(route, False))
    if route in ("prefix", "fused_chunk"):
        jkw.update(fused_decode=False, fused_prefill=False)
    je = jinf.ServingEngine(jp, CFG, **jkw)
    if route == "fused_chunk":
        monkeypatch.setattr(fpb, "prefill_fused_selected",
                            lambda meta, m: True)
    te = ServingEngine(tp, TCFG, device="cpu", **ENGINE,
                       **_knobs(route, True))
    assert all(te._fused_buckets.values()) == (route == "fused_chunk")
    reqs = []
    for prompt, n in _prompts(route):
        reqs.append([e.submit(prompt, G(max_new_tokens=n, greedy=True))
                     for e, G in ((je, jinf.GenerationConfig),
                                  (te, GenerationConfig))])
        if route == "prefix":       # each prompt indexed before the next
            je.drain()
            te.drain()
    je.drain()
    te.drain()
    assert [t.tokens for _, t in reqs] == [j.tokens for j, _ in reqs]
    for k in ("prefill_chunks", "prefill_tokens", "prefill_pad_tokens",
              "decode_steps", "requests_completed"):
        assert te.counters[k] == je.counters[k], k
    assert te.counters["prefill_traces"] == je.counters["prefill_traces"]
    assert set(te.counters["prefill_traces"]) == {8, 16}
    assert sorted(P for P, *_ in te._prefill_fns) == [8, 16]
    assert len(seen) == te.counters["prefill_chunks"]
    if route == "prefix":
        assert te.metrics()["prefix_cache"] == je.metrics()["prefix_cache"]
        assert any(pos0 % P for P, pos0, _ in seen)
        assert te._pcache.metrics()["cow_forks"] > 0


def _chunk_inputs(seed=0, P=8, MB=6, BS=4, KV=2, hd=16, N=9):
    rng = np.random.RandomState(seed)
    kp = torch.from_numpy(rng.randn(N, BS, KV, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, BS, KV, hd).astype(np.float32))
    k_new = torch.from_numpy(rng.randn(P, KV, hd).astype(np.float32))
    v_new = torch.from_numpy(rng.randn(P, KV, hd).astype(np.float32))
    table = torch.from_numpy((rng.permutation(N - 1)[:MB] + 1)
                             .astype(np.int32))
    return kp, vp, k_new, v_new, table


def _at(pos0, n):
    """(pos0, n) as the bounds buffer holds them: 0-d int32 tensors."""
    b = torch.tensor([pos0, n], dtype=torch.int32)
    return b[0], b[1]


def _case_write_chunk(quant):
    kp, vp, k_new, v_new, table = _chunk_inputs(1)
    wtable = table.clone()
    wtable[:2] = 0                          # shared pages -> scratch
    scales = (torch.rand(2) * 0.1 + 0.01, torch.rand(2) * 0.1 + 0.01)
    if quant:
        kp, vp = (torch.randint(-127, 128, kp.shape, dtype=torch.int8),
                  torch.randint(-127, 128, vp.shape, dtype=torch.int8))

    def run(pos0, n):
        k, v = kp.clone(), vp.clone()
        if quant:
            tpa.write_chunk_to_pool_quant(k, v, wtable, pos0, n, k_new,
                                          v_new, *scales)
        else:
            tpa.write_chunk_to_pool(k, v, wtable, pos0, n, k_new, v_new)
        return k, v
    return run


def _case_cached_forward(params):
    _, tp = params
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 97, (1, 8)))
    caches = [torch.from_numpy(np.random.RandomState(3 + i).randn(
        2, 1, 32, 2, 16).astype(np.float32)) for i in range(2)]

    def run(pos0, n):
        kc, vc = (c.clone() for c in caches)
        logits, kc, vc = tgen.cached_forward(tp, toks, TCFG, kc, vc, pos0)
        return logits, kc, vc
    return run


def _case_tp_cached_forward(params, coll):
    _, tp = params
    mesh = ServingMesh.make(2, collective=coll, devices=["cpu"] * 2)
    shards = mesh.shard(tp, mesh.param_specs(TCFG, tp))
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, 97, (1, 8)))
    caches = [[torch.from_numpy(np.random.RandomState(5 + 2 * i + j).randn(
        2, 1, 32, 1, 16).astype(np.float32)) for j in range(2)]
        for i in range(2)]

    def run(pos0, n):
        kcs, vcs = ([c.clone() for c in cs] for cs in caches)
        logits, kcs, vcs = ttp._tp_cached_forward(shards, toks, TCFG, kcs,
                                                  vcs, pos0, mesh)
        return (logits, *kcs, *vcs)
    return run


def _case_fused_forward(params, wq):
    _, tp = params
    tree = quantize_weights(tp, bits=8) if wq else tp
    kp0, vp0, _, _, table = _chunk_inputs(6, MB=10, N=12)
    L = TCFG.num_hidden_layers
    kps, vps = (torch.stack([p * (i + 1) for i in range(L)])
                for p in (kp0, vp0))
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, 97, (8,)))
    wtable = table.clone()
    wtable[0] = 0
    rope = build_rope_cache(64, TCFG.head_dim)

    def run(pos0, n, bounds=None):
        kp, vp = kps.clone(), vps.clone()
        if bounds is not None:
            pos0, n = int(bounds[0]), int(bounds[1])
        logits, kp, vp = tgen._fused_prefill_forward(
            tree, toks, TCFG, kp, vp, table, wtable, pos0, n, rope=rope,
            mode="ref", bounds=bounds)
        return logits, kp, vp
    return run


def _case_prefill_ref(wq_ref):
    rng = np.random.RandomState(8)
    P, D, H, KV, hd = 8, 32, 4, 2, 16
    kp, vp, _, _, table = _chunk_inputs(9, MB=8, KV=KV, hd=hd)
    f = (lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)
                                     * 0.1))
    x, nw = f(P, D), 1 + f(D)
    wq, wk, wv, wo = f(D, H * hd), f(D, KV * hd), f(D, KV * hd), f(H * hd, D)
    sin, cos = build_rope_cache(32, hd)
    fn = fpb.prefill_attn_block_wq_ref if wq_ref else fpb.prefill_attn_block_ref

    def run(pos0, n, bounds=None):
        rows = slice(int(pos0), int(pos0) + P)
        return fn(x, nw, wq, wk, wv, wo, sin[rows], cos[rows], kp, vp, table,
                  pos0, n, bounds=bounds)
    return run


CASES = ("write_chunk_to_pool", "write_chunk_to_pool_quant",
         "cached_forward", "tp_cached_forward_psum",
         "tp_cached_forward_gather", "fused_prefill_forward",
         "fused_prefill_forward_int8", "prefill_attn_block_ref",
         "prefill_attn_block_wq_ref")


def _case(name, params):
    return {
        "write_chunk_to_pool": lambda: _case_write_chunk(False),
        "write_chunk_to_pool_quant": lambda: _case_write_chunk(True),
        "cached_forward": lambda: _case_cached_forward(params),
        "tp_cached_forward_psum": lambda: _case_tp_cached_forward(params,
                                                                  "psum"),
        "tp_cached_forward_gather": lambda: _case_tp_cached_forward(
            params, "gather"),
        "fused_prefill_forward": lambda: _case_fused_forward(params, False),
        "fused_prefill_forward_int8": lambda: _case_fused_forward(params,
                                                                  True),
        "prefill_attn_block_ref": lambda: _case_prefill_ref(False),
        "prefill_attn_block_wq_ref": lambda: _case_prefill_ref(True),
    }[name]()


@pytest.mark.parametrize("name", CASES)
def test_device_position_matches_host_int(params, name):
    """Each composition a captured chunk runs with its position in device
    memory gives, with (pos0, n) as 0-d tensors (or the kernels' int32
    [2] bounds buffer), exactly what it gives with host ints: bit for bit,
    at pos0 off a page and bucket multiple and with pad rows."""
    run = _case(name, params)
    for pos0, n in ((0, 8), (5, 6), (14, 1), (20, 8)):
        want = run(pos0, n)
        got = run(*_at(pos0, n))
        if name.startswith(("fused_prefill", "prefill_attn")):
            got_b = run(pos0, n, bounds=torch.tensor([pos0, n],
                                                     dtype=torch.int32))
            assert all(torch.equal(a, b) for a, b in zip(got_b, want))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (pos0, n)


def test_host_range_checks_stay_on_the_int_path(params):
    """A host int past the cache raises as before; a tensor position is
    the caller's to check (the engine checks the value it stages)."""
    run = _case_cached_forward(params)
    with pytest.raises(ValueError, match="do not fit"):
        run(30, 8)
    with pytest.raises(ValueError, match="do not fit"):
        tgen._check_span(30, 8, 32)
    tgen._check_span(torch.tensor(30), 8, 32)


def test_prefill_buffers_keep_their_addresses(params, monkeypatch):
    """Each bucket's buffers are made once, at its first program, and
    never move: their ``data_ptr()`` holds across every chunk, request
    and slot. After each chunk they hold the chunk the engine staged:
    its tokens (padded with 0), bounds (pos0, n), the slot's read and
    write tables (int32 for the fused chunk, int64 for the verbatim one)
    and temperature, and the token the chunk sampled."""
    _, tp = params
    for fused in (False, True):
        if fused:
            monkeypatch.setattr(fpb, "prefill_fused_selected",
                                lambda meta, m: True)
        eng = ServingEngine(tp, TCFG, device="cpu", prefix_cache=True,
                            **ENGINE)
        ptrs, staged = {}, []
        real_stage = tserving._ChunkBuffers.stage

        def stage(buf, toks, pos0, n, table, wtable, temp):
            real_stage(buf, toks, pos0, n, table, wtable, temp)
            staged.append((buf, toks.copy(), pos0, n, table.copy(),
                           wtable.copy(), temp))
        monkeypatch.setattr(tserving._ChunkBuffers, "stage", stage)
        first = np.random.RandomState(9).randint(0, 97, (22,)).astype(
            np.int32)
        prompts = [first, np.concatenate([first[:14], first[:9]]),
                   first[:5]]
        for p in prompts:
            eng.submit(p, GenerationConfig(max_new_tokens=3,
                                           temperature=0.5))
        checked = 0
        while not eng.idle:
            n_staged = len(staged)
            eng.step()
            for P, buf in eng._prefill_bufs.items():
                names = ("toks", "bounds", "table", "wtable", "temp", "tok")
                got = {k: getattr(buf, k).data_ptr() for k in names}
                assert ptrs.setdefault(P, got) == got
            if len(staged) == n_staged:
                continue
            buf, toks, pos0, n, table, wtable, temp = staged[-1]
            tdt = torch.int32 if fused else torch.int64
            assert buf.table.dtype == buf.wtable.dtype == tdt
            assert buf.toks.dtype == torch.int64
            np.testing.assert_array_equal(buf.toks.numpy()[0], toks)
            assert (toks[n:] == 0).all()
            assert buf.bounds.tolist() == [pos0, n] and buf.at == (pos0, n)
            np.testing.assert_array_equal(buf.table.numpy(), table)
            np.testing.assert_array_equal(buf.wtable.numpy(), wtable)
            assert buf.temp.item() == pytest.approx(0.5)
            assert 0 <= int(buf.tok[0]) < 97
            checked += 1
        assert checked == eng.counters["prefill_chunks"] >= 5
        assert set(ptrs) == {8, 16}
        monkeypatch.undo()


def test_replay_reports_each_chunks_plan():
    """A replayed chunk's plans: ``prefill_spec_at`` turns a captured
    prefill_attn_block launch's spec into the one a launch at another
    chunk's (pos0, n) records (the spec of that launch, the same object
    from the cache), and leaves other launches' specs alone; a program
    replaying through a stand-in graph reports each call's plans."""
    from paddle_tpu_torch.analysis import kernel_catalog as kc
    from paddle_tpu_torch.inference.program import Program
    case = next(c for c in kc.kernel_cases()
                if c.name == "prefill_attn_block@tiny_ragged")
    specs, err = kc.capture_case(case)
    assert err is None
    sp = next(s for s in specs if s.name == "prefill_attn_block")
    assert (sp.params["pos0"], sp.params["n_valid"]) == (10, 11)
    at = fpb.prefill_spec_at(sp, 3, 7)
    assert (at.params["pos0"], at.params["n_valid"]) == (3, 7)
    assert at.params["live"] == (3,)
    assert fpb.prefill_spec_at(sp, 10, 11) is sp
    assert fpb.prefill_spec_at(at, 10, 11) == sp
    assert at.params != sp.params and at.plan == sp.plan
    assert at.inputs == sp.inputs and at.grid == sp.grid
    assert at.operand("bounds").shape == (2,)
    other = next(c for c in kc.kernel_cases()
                 if c.name.startswith("decode_mlp_block@"))
    osp = kc.capture_case(other)[0][0]
    assert fpb.prefill_spec_at(osp, 3, 7) is osp

    class Replayed:
        def replay(self):
            pass

    prog = Program(lambda: None, torch.device("cpu"), None, None)
    prog.graph, prog.specs = Replayed(), [sp, osp]
    kernels.reset_launches()
    with _launch.capture_kernel_launches() as seen:
        prog(respec=lambda s: fpb.prefill_spec_at(s, 3, 7))
        prog()
    assert seen == [at, osp, sp, osp]
    assert prog.replays == 2


# ---------------------------------------------------------------------------
# generate_paged's decode step over fixed buffers
# ---------------------------------------------------------------------------
GP_ROUTES = {
    "default": {}, "ref": {"fused_decode": "ref"},
    "unfused": {"fused_decode": False},
    "int8_cache": {"cache_dtype": "int8"},
    "int8_weights": {"weight_quant": "int8"},
    "tp2_psum": {"mesh": 2},
    "sampled": {"seed": 3},
}


def _eager_generate_paged(tp, prompts, gen, monkeypatch, **kw):
    """The same call with the former eager loop: each step the route's
    decode step called directly, the sampled tokens, EOS flags and
    lengths rebound as new tensors, the tokens stacked."""
    fused = tgen._fused_mode(kw.get("fused_decode"))
    mesh = kw.get("mesh")

    def logits_of(params, tok, kp, vp, bt, seq, kv_scales, rope):
        if mesh is not None:
            return ttp._tp_decode_step(params, tok, TCFG, kp, vp, bt, seq,
                                       mesh, rope=rope, kv_scales=kv_scales,
                                       fused=fused)[0]
        if fused:
            return tgen._fused_decode_step(params, tok, TCFG, kp, vp, bt,
                                           seq, rope=rope, mode=fused,
                                           kv_scales=kv_scales)[0]
        return tgen._paged_decode_step(params, tok, TCFG, kp, vp, bt, seq,
                                       rope=rope, kv_scales=kv_scales)[0]

    def eager_chunks(step, gen, params, tok, generator, k_pools, v_pools,
                     seq_lens, block_tables, kv_scales, rope):
        out = [tok]
        done = tok == gen.eos_token_id
        for _ in range(gen.max_new_tokens - 1):
            logits = logits_of(params, tok, k_pools, v_pools, block_tables,
                               seq_lens, kv_scales, rope)
            nxt = tgen.sample_token(logits, gen, generator)
            nxt = torch.where(done, gen.eos_token_id, nxt)
            done = done | (nxt == gen.eos_token_id)
            seq_lens = seq_lens + 1
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)
    with monkeypatch.context() as m:
        m.setattr(tgen, "_decode_chunks", eager_chunks)
        return generate_paged(tp, prompts, TCFG, gen, block_size=4,
                              device="cpu", **kw)


@pytest.mark.parametrize("route", list(GP_ROUTES))
def test_generate_paged_fixed_buffers_match_eager(params, route,
                                                  monkeypatch):
    """``generate_paged``'s decode loop as one program over fixed buffers
    (the tokens, EOS flags, lengths and the step index advanced in place,
    every token written into one [N - 1, B] output) gives the former
    eager loop's ids on every route, greedy and sampled (top-k/top-p,
    the same generator draws), and an EOS sequence keeps drawing EOS."""
    _, tp = params
    kw = dict(GP_ROUTES[route])
    if "mesh" in kw:
        kw["mesh"] = ServingMesh.make(kw.pop("mesh"), devices=["cpu"] * 2)
    prompts = np.random.RandomState(11).randint(0, 97, (2, 9)).astype(
        np.int32)
    gen = (GenerationConfig(max_new_tokens=7, temperature=0.8, top_k=20,
                            top_p=0.9)
           if route == "sampled" else
           GenerationConfig(max_new_tokens=7, greedy=True))
    got = generate_paged(tp, prompts, TCFG, gen, block_size=4, device="cpu",
                         **kw)
    want = _eager_generate_paged(tp, prompts, gen, monkeypatch, **kw)
    assert torch.equal(got, want)
    if route == "default":
        eos = int(got[0, 10])
        gen = GenerationConfig(max_new_tokens=7, greedy=True,
                               eos_token_id=eos)
        got = generate_paged(tp, prompts, TCFG, gen, block_size=4,
                             device="cpu")
        assert (got[0, 10:] == eos).all()
        assert torch.equal(got, _eager_generate_paged(tp, prompts, gen,
                                                      monkeypatch))
