"""PyTorch/CUDA port, tensor-parallel serving: ``ServingMesh``, the
per-shard parameter split (byte for byte the JAX package's shards on the
8-device CPU mesh), ``_tp_decode_step`` and ``_tp_cached_forward`` against
the JAX package's shard_map'd bodies, ``ServingEngine(mesh=...)`` on the
22-request mixed-arrival stream of tests/test_serving_tp.py against the
JAX engine (fp and int8 pools, both placements, tp 1, 2 and 4), the
refusals with the JAX engine's reasons, ``metrics()["mesh"]``, the meta's
``tp`` and the launch counters by residual class (f32, on the CPU: every
shard's device is "cpu").

The model is tests/test_serving_tp.py's. Tolerances: byte equality for
shards and specs; 1e-5 absolute for the psum decode step and prefill
forward (the psum sums the shards' partial products in another order
than one product), 1e-6 for the gather placement (the same operands and
reductions, other kernels); greedy ids equal, except that over int8
pools under psum a step may part on a near tie (top-2 logit gap under
1e-4, reported)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu.inference as jinf
from paddle_tpu.core.jax_compat import shard_map_norep
from paddle_tpu.inference import tp as jtp
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu.quantization import ptq as jptq
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        ServingMesh)
from paddle_tpu_torch.inference import tp as ttp
from paddle_tpu_torch.inference.generation import cached_forward, init_cache
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb

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
ENGINE = dict(capacity=3, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)
TOL = {"psum": 1e-5, "gather": 1e-6}
PLACEMENTS = pytest.mark.parametrize("coll", ["psum", "gather"])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_tree(tree):
    return tllama.params_from_jax(_np(tree), device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, _port_tree(jp)


def _mesh(tp, coll="psum"):
    return ServingMesh.make(tp, collective=coll, devices=["cpu"] * tp)


def _mixed_stream(eng, gen_cls, n=22, seed=7, max_new=5):
    """tests/test_serving_tp.py's stream: n requests arriving in waves
    interleaved with engine steps."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(4, 14, n)
    reqs = []
    for i, s in enumerate(sizes):
        reqs.append(eng.submit(
            rng.randint(0, 97, (int(s),)).astype(np.int32),
            gen_cls(max_new_tokens=max_new, greedy=True)))
        if i % 3 == 2:
            eng.step()
            eng.step()
    eng.drain()
    return [r.output_ids for r in reqs]


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.fixture(scope="module")
def jax_streams(params):
    """The JAX engine's greedy outputs, computed once: meshless fp and
    int8 pools, and int8 pools on the tp=2 psum mesh."""
    jp, _ = params
    mk = jinf.ServingMesh.make
    return {
        "fp": _mixed_stream(jinf.ServingEngine(jp, CFG, **ENGINE),
                            jinf.GenerationConfig),
        "int8": _mixed_stream(jinf.ServingEngine(jp, CFG, cache_dtype="int8",
                                                 **ENGINE),
                              jinf.GenerationConfig),
        "int8_psum2": _mixed_stream(
            jinf.ServingEngine(jp, CFG, cache_dtype="int8",
                               mesh=mk(tp=2, collective="psum"), **ENGINE),
            jinf.GenerationConfig),
    }


# -- the split: specs and shards ------------------------------------------

def _dims(jspec_tree, axis="tp"):
    """A JAX PartitionSpec tree read as split dims (the port's specs)."""
    if isinstance(jspec_tree, dict):
        return {k: _dims(v, axis) for k, v in jspec_tree.items()}
    return next((i for i, a in enumerate(jspec_tree) if a == axis), None)


@pytest.mark.parametrize("tp,coll,bits", [
    (1, "psum", 0), (2, "psum", 0), (2, "gather", 0), (4, "psum", 0),
    (4, "gather", 0), (1, "psum", 8), (1, "gather", 4)])
def test_specs_and_shards_equal_jax(params, tp, coll, bits):
    """The port's split dims are the JAX PartitionSpecs' and each shard's
    tensors equal, byte for byte, the JAX mesh's shard on the device of
    the same index (``addressable_shards``), quantized leaves included."""
    jp, _ = params
    if bits:
        jp = jptq.quantize_weights(jp, bits=bits)
    tree = _port_tree(jp)
    jm = jinf.ServingMesh.make(tp=tp, collective=coll)
    jspecs = jm.param_specs(CFG, jp)
    tm = _mesh(tp, coll)
    specs = tm.param_specs(TCFG, tree)
    assert specs == _dims(jspecs)
    jsharded = jm.shard(jp, jspecs)
    shards = tm.shard(tree, specs)
    assert len(shards) == tp
    jleaves, jdef = jax.tree_util.tree_flatten(jsharded)
    for i, shard in enumerate(shards):
        leaves, tdef = jax.tree_util.tree_flatten(shard)
        assert tdef == jdef
        for jl, tl in zip(jleaves, leaves):
            js = next(s for s in jl.addressable_shards
                      if s.device == jm.devices[i])
            want = np.asarray(js.data)
            assert tl.is_contiguous()
            assert tl.dtype == tllama._to_tensor(want).dtype
            assert tl.numpy().tobytes() == want.tobytes()


def test_shard_places_and_shares(params):
    """A split slice is contiguous on its shard's device; a whole leaf is
    one tensor for colocated shards; at tp=1 the split leaves are the
    caller's tensors (a full slice is no copy)."""
    _, tree = params
    m2 = _mesh(2)
    s2 = m2.shard(tree, m2.param_specs(TCFG))
    assert s2[0]["embed_tokens"] is s2[1]["embed_tokens"]
    assert s2[0]["layers"]["q_proj"].shape == (2, 64, 32)
    assert s2[0]["layers"]["o_proj"].shape == (2, 32, 64)
    m1 = _mesh(1)
    s1 = m1.shard(tree, m1.param_specs(TCFG))[0]
    assert s1["layers"]["q_proj"].data_ptr() == \
        tree["layers"]["q_proj"].data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        _mesh(3).shard({"w": torch.zeros(4, 4)}, 1)


def test_collectives_and_mesh_surface():
    m = _mesh(3, "gather")
    parts = [torch.full((2, 2), float(i + 1)) for i in range(3)]
    summed = m.psum(parts)
    assert len(summed) == 3 and summed[0] is summed[2]
    assert torch.equal(summed[0], parts[0] + parts[1] + parts[2])
    cat = m.all_gather(parts, 1)
    assert torch.equal(cat[1], torch.cat(parts, 1))
    assert m.describe() == {"axis": "tp", "tp": 3, "collective": "gather"}
    a, b = m.split(1)
    assert (a.tp, b.tp, b.collective) == (1, 2, "gather")
    with pytest.raises(ValueError, match="split"):
        m.split(3)
    with pytest.raises(ValueError, match="tp=3 but only 2 device"):
        ServingMesh.make(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="collective"):
        _mesh(2, "allgatherz")
    with pytest.raises(TypeError, match="ServingMesh | int | None"):
        ttp.normalize_mesh("tp2")
    assert ttp.normalize_mesh(None) is None and ttp.normalize_mesh(m) is m
    if not torch.cuda.is_available():
        # an int takes the visible CUDA cards: none here
        with pytest.raises(ValueError, match="0 device"):
            ttp.normalize_mesh(2)
    assert m.supports(TCFG) == jinf.ServingMesh.make(
        tp=3, collective="gather").supports(CFG)


@pytest.mark.parametrize("tp,coll", [(2, "psum"), (4, "gather")])
def test_collective_inventory_equals_jax(tp, coll):
    jm = jinf.ServingMesh.make(tp=tp, collective=coll)
    for B, chunk in ((3, 1), (1, 16)):
        assert _mesh(tp, coll).collective_inventory(TCFG, B, chunk) == \
            jm.collective_inventory(CFG, B, chunk)


def test_reject_reason_equals_jax():
    odd = dataclasses.replace(CFG, intermediate_size=101,
                              num_hidden_layers=1)
    todd = dataclasses.replace(TCFG, intermediate_size=101,
                               num_hidden_layers=1)
    for cfg, tcfg in ((CFG, TCFG), (odd, todd)):
        for tp in (1, 2, 3, 4):
            assert ttp.tp_reject_reason(tcfg, tp) == \
                jtp.tp_reject_reason(cfg, tp)


# -- the per-shard bodies against JAX's shard_map'd ones --------------------

def _decode_inputs(rng, KV, quant):
    B, BS, MB, N = 3, 4, 5, 16
    hd = CFG.head_dim
    tables = rng.permutation(np.arange(1, N))[:B * MB].reshape(B, MB)
    tables = tables.astype(np.int32)
    seq = np.array([0, 7, 13], np.int32)
    tok = rng.randint(0, 97, (B,)).astype(np.int32)
    shape = (CFG.num_hidden_layers, N, BS, KV, hd)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        sc = [(rng.rand(CFG.num_hidden_layers, KV) * 0.01 + 0.001
               ).astype(np.float32) for _ in range(2)]
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        sc = None
    return tok, seq, tables, kp, vp, sc


def _split_heads(a, tp, axis):
    n = a.shape[axis] // tp
    return [torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(i * n, (i + 1) * n), axis=axis)))
        for i in range(tp)]


@PLACEMENTS
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_tp_decode_step_matches_jax(params, coll, quant):
    """One decode step at tp=2 over the same pools: logits to TOL, the
    pools after it (each shard's KV heads) to TOL, int8 codes equal."""
    jp, tree = params
    rng = np.random.RandomState(11)
    tok, seq, tables, kp, vp, sc = _decode_inputs(rng, 4, quant)
    jm = jinf.ServingMesh.make(tp=2, collective=coll)
    fn = jax.jit(jm.sharded_decode_fn(CFG, False, quant, params=jp))
    extra = tuple(jnp.asarray(s) for s in sc) if quant else ()
    jlog, jk, jv = fn(jm.shard(jp, jm.param_specs(CFG)), jnp.asarray(tok),
                      jnp.asarray(seq), jnp.asarray(tables),
                      jnp.asarray(kp), jnp.asarray(vp), *extra)
    tm = _mesh(2, coll)
    kps, vps = _split_heads(kp, 2, 3), _split_heads(vp, 2, 3)
    scales = None
    if quant:
        scales = list(zip(_split_heads(sc[0], 2, 1),
                          _split_heads(sc[1], 2, 1)))
    logits, kps, vps = ttp._tp_decode_step(
        tm.shard(tree, tm.param_specs(TCFG)), torch.from_numpy(tok), TCFG,
        kps, vps, torch.from_numpy(tables), torch.from_numpy(seq), tm,
        kv_scales=scales, fused="auto")
    tol = dict(atol=TOL[coll], rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **tol)
    for got, want in ((kps, jk), (vps, jv)):
        got = torch.cat(got, dim=3).numpy()
        if quant:
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            np.testing.assert_allclose(got, np.asarray(want), **tol)


@PLACEMENTS
def test_tp_cached_forward_matches_jax(params, coll):
    """The per-shard prefill body at tp=2 over a dense cache holding a
    history: logits to TOL, each shard's cache slice after it to TOL."""
    jp, tree = params
    rng = np.random.RandomState(12)
    L, KV, hd, T, S, pos = 2, 4, CFG.head_dim, 24, 8, 5
    toks = rng.randint(0, 97, (1, S)).astype(np.int32)
    kc = rng.randn(L, 1, T, KV, hd).astype(np.float32)
    vc = rng.randn(L, 1, T, KV, hd).astype(np.float32)
    jm = jinf.ServingMesh.make(tp=2, collective=coll)
    cspec = P(None, None, None, "tp", None)

    def fwd(p, t, k, v):
        return jtp._tp_cached_forward(p, t, CFG, k, v, pos, axis="tp",
                                      collective=coll)
    fn = jax.jit(shard_map_norep(fwd, jm.mesh,
                                 (jm.param_specs(CFG), P(), cspec, cspec),
                                 (P(), cspec, cspec)))
    jlog, jk, jv = fn(jm.shard(jp, jm.param_specs(CFG)), jnp.asarray(toks),
                      jnp.asarray(kc), jnp.asarray(vc))
    tm = _mesh(2, coll)
    kcs, vcs = _split_heads(kc, 2, 3), _split_heads(vc, 2, 3)
    logits, kcs, vcs = ttp._tp_cached_forward(
        tm.shard(tree, tm.param_specs(TCFG)), torch.from_numpy(toks), TCFG,
        kcs, vcs, pos, tm)
    tol = dict(atol=TOL[coll], rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **tol)
    np.testing.assert_allclose(torch.cat(kcs, 3).numpy(), np.asarray(jk),
                               **tol)
    np.testing.assert_allclose(torch.cat(vcs, 3).numpy(), np.asarray(jv),
                               **tol)


def test_tp_cached_forward_gather_tp1_is_cached_forward(params):
    """A one-shard mesh is the identity: ``_tp_cached_forward`` equals
    the meshless ``cached_forward`` bit for bit, both placements."""
    _, tree = params
    toks = torch.from_numpy(np.random.RandomState(13).randint(0, 97, (1, 8)))
    kc, vc = init_cache(TCFG, 1, 16, device="cpu")
    want, _, _ = cached_forward(tree, toks, TCFG, kc, vc, 0)
    for coll in ("psum", "gather"):
        m = _mesh(1, coll)
        k1, v1 = init_cache(TCFG, 1, 16, device="cpu")
        got, k1, v1 = ttp._tp_cached_forward(
            m.shard(tree, m.param_specs(TCFG)), toks, TCFG, [k1], [v1], 0, m)
        assert torch.equal(got, want) and torch.equal(k1[0], kc)


# -- the engine on the 22-request stream ------------------------------------

@PLACEMENTS
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_engine_stream_equals_jax(params, jax_streams, tp, coll):
    """fp pools: greedy ids equal the JAX meshless engine's; the mesh's
    metrics and variants."""
    _, tree = params
    eng = ServingEngine(tree, TCFG, mesh=_mesh(tp, coll), **ENGINE)
    assert _same(_mixed_stream(eng, GenerationConfig), jax_streams["fp"])
    m = eng.metrics()
    assert m["mesh"] == {"axis": "tp", "tp": tp, "collective": coll}
    assert m["decode_variant"] == {"mode": "auto", "block": "composed",
                                   "attn": "unfused", "mlp": "unfused"}
    assert m["prefill_variant"]["attn"] == "unfused"
    assert eng.device == torch.device("cpu")
    assert len(eng.params) == len(eng._k_pools) == tp
    assert eng._k_pools[0].shape[3] == CFG.num_key_value_heads // tp


def test_engine_tp1_equals_port_meshless(params):
    _, tree = params
    ref = _mixed_stream(ServingEngine(tree, TCFG, device="cpu", **ENGINE),
                        GenerationConfig, n=8)
    for coll in ("psum", "gather"):
        eng = ServingEngine(tree, TCFG, mesh=_mesh(1, coll), **ENGINE)
        assert _same(_mixed_stream(eng, GenerationConfig, n=8), ref), coll


def test_engine_tp1_psum_keeps_the_fused_chunk(params, jax_streams,
                                               monkeypatch):
    """With the fused chunk selected (a test-only patch of
    ``prefill_fused_selected``, which the CPU never selects), a tp=1
    "psum" mesh runs ``_fused_prefill_forward`` on its one shard and a
    tp=2 mesh the verbatim chunk, as in the JAX engine; ids stay the JAX
    engine's."""
    _, tree = params
    monkeypatch.setattr(fpb, "prefill_fused_selected", lambda meta, m: True)
    for tp, coll, fused in ((1, "psum", True), (1, "gather", False),
                            (2, "psum", False)):
        eng = ServingEngine(tree, TCFG, mesh=_mesh(tp, coll), **ENGINE)
        assert all(v is fused for v in eng._fused_buckets.values())
        assert _same(_mixed_stream(eng, GenerationConfig),
                     jax_streams["fp"]), (tp, coll)


def test_engine_int8_gather_equals_jax_and_meshless_scales(params,
                                                           jax_streams):
    """int8 pools at tp=2 "gather": ids equal the JAX meshless int8
    engine's; the calibration runs the meshless op sequence, so the
    scales equal the port's meshless int8 engine's."""
    _, tree = params
    meshless = ServingEngine(tree, TCFG, cache_dtype="int8", device="cpu",
                             **ENGINE)
    assert _same(_mixed_stream(meshless, GenerationConfig),
                 jax_streams["int8"])
    eng = ServingEngine(tree, TCFG, cache_dtype="int8",
                        mesh=_mesh(2, "gather"), **ENGINE)
    assert _same(_mixed_stream(eng, GenerationConfig), jax_streams["int8"])
    for a, b in zip(eng._kv_scales, meshless._kv_scales):
        assert torch.equal(a, b)
    assert eng.metrics()["calibration_traces"] == 1
    assert [s[0].shape for s in eng._shard_scales] == [(2, 2), (2, 2)]
    assert all(p.dtype == torch.int8 for p in eng._k_pools)


def _top2_gap(tree, ids):
    kc, vc = init_cache(TCFG, 1, len(ids), device="cpu")
    logits, _, _ = cached_forward(tree, torch.tensor([ids]), TCFG, kc, vc,
                                  0)
    top2 = torch.topk(logits[0, -1], 2).values
    return float(top2[0] - top2[1])


def test_engine_int8_psum_equals_jax_mesh(params, jax_streams):
    """int8 pools at tp=2 "psum": ids equal the JAX engine's on the same
    mesh and placement; a request that parts must part on a near tie
    (top-2 logit gap of the meshless f32 logits under 1e-4)."""
    _, tree = params
    eng = ServingEngine(tree, TCFG, cache_dtype="int8",
                        mesh=_mesh(2, "psum"), **ENGINE)
    got = _mixed_stream(eng, GenerationConfig)
    parted = []
    for a, b in zip(got, jax_streams["int8_psum2"]):
        if not np.array_equal(a, b):
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            parted.append((j, _top2_gap(tree, [int(t) for t in a[:j]])))
    assert all(gap < 1e-4 for _, gap in parted), parted


# -- refusals, with the JAX engine's reasons --------------------------------

def _error(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


@pytest.mark.parametrize("case", ["tp3", "weight_quant", "block",
                                  "pallas_gather", "prefill_pallas"])
def test_refusals_equal_jax(params, case):
    jp, tree = params
    tp, coll, kw = {
        "tp3": (3, "psum", {}),
        "weight_quant": (2, "psum", {"weight_quant": "int8"}),
        "block": (2, "psum", {"fused_decode": "block"}),
        "pallas_gather": (2, "gather", {"fused_decode": "pallas"}),
        "prefill_pallas": (2, "psum", {"fused_prefill": "pallas"}),
    }[case]
    want = _error(lambda: jinf.ServingEngine(
        jp, CFG, mesh=jinf.ServingMesh.make(tp=tp, collective=coll), **kw,
        **ENGINE))
    got = _error(lambda: ServingEngine(tree, TCFG, mesh=_mesh(tp, coll),
                                       **kw, **ENGINE))
    assert got == want


def test_weight_quant_tp1_and_device_check(params):
    """A quantized tree serves on a tp=1 mesh (ids equal the meshless
    quantized engine's); a ``device`` that is not shard 0's raises."""
    _, tree = params
    ref = _mixed_stream(ServingEngine(tree, TCFG, weight_quant="int8",
                                      device="cpu", **ENGINE),
                        GenerationConfig, n=6)
    eng = ServingEngine(tree, TCFG, weight_quant="int8", mesh=_mesh(1),
                        device="cpu", **ENGINE)
    assert eng.weight_quant_variant["mode"] == "int8"
    assert _same(_mixed_stream(eng, GenerationConfig, n=6), ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(tree, TCFG, mesh=_mesh(1), device="cuda",
                          **ENGINE)


# -- the meta's tp and the counters ----------------------------------------

def test_decode_meta_carries_tp_and_block_refuses_it():
    """``tp`` rides in the meta; the single-launch kernel refuses a shard
    (tp != 1) with the JAX predicate's reason, on a CUDA meta the
    two-stage kernels take."""
    args = (8, 4096, 16, 16, 128, 5504, 16, 72)
    meta = fdb.decode_meta_dims(*args, torch.bfloat16, torch.bfloat16, False,
                                tp=2)
    assert meta["tp"] == 2
    assert fdb.decode_meta(TCFG, 3, 4, 5, torch.float32, False)["tp"] == 1
    jmeta = jfdb.decode_meta_dims(*args, jnp.bfloat16, jnp.bfloat16, False,
                                  tp=2)
    jmeta["interpret"] = False
    assert fdb._supports_block(meta) == jfdb._supports_block(jmeta)
    assert fdb._supports_attn(meta)[0] and fdb._supports_mlp(meta)[0]
    assert fdb._supports_block(dict(meta, tp=1))[0]
    names = fdb.resolve_decode_step(meta, "auto")[3]
    assert names == {"block": "composed", "attn": "cuda_fused",
                     "mlp": "cuda_fused"}


def test_plain_routes_count_no_launch(params):
    """The CPU routes run the plain versions: a psum-mesh engine (the
    residual=False bodies' route) counts no launch in any class, and the
    wrappers raise on CPU tensors before counting."""
    _, tree = params
    kernels.reset_launches()
    eng = ServingEngine(tree, TCFG, mesh=_mesh(2, "psum"), **ENGINE)
    _mixed_stream(eng, GenerationConfig, n=4)
    assert set(kernels.launches_by_residual()) == {
        "decode_attn_block", "decode_mlp_block", "prefill_attn_block"}
    assert all(v == {"full": 0, "partial": 0}
               for v in kernels.launches_by_residual().values())
    assert not any(kernels.launches().values())
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="needs CUDA"):
        fdb.decode_mlp_block_cuda(x, torch.ones(64), torch.zeros(64, 64),
                                  torch.zeros(64, 64), torch.zeros(64, 64),
                                  residual=False)
    assert fdb.decode_mlp_block_cuda.launches_by_residual == {
        "full": 0, "partial": 0}
