"""PyTorch/CUDA port, the train step as one program
(``distributed/trainer.py`` over ``inference/program.Program``) and the
values its kernels read from device memory, against the JAX package on
the CPU; and the public arguments the port had dropped.

On the CPU the program runs its body at every step (no graph), through
the same fixed tensors the captured step reads on the card: the state
(the step count updated in place), the batch buffers of its key, the one
f32 lr word, and the metrics copied out after each step. The card's
capture and replay are held by ``chip_smoke.py train_graph``.

Tolerances: the trainer runs in f32 on both sides, so losses and
parameters agree within ``tests/test_torch_train.py``'s 2e-5 (f32
roundoff compounding through the AdamW updates) and grad norms within its
gradients' bound (5e-4 relative, 5e-5 absolute); the plain kernel
versions are compared bit for bit where their arithmetic is the same;
the Queue C functions within f32 roundoff (1e-6) or, for bf16 tables,
exactly (both round the same f32 values)."""
import dataclasses
import threading
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import ops as jops
from paddle_tpu.distributed import trainer as jtrainer
from paddle_tpu.inference import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import paged_attention as jpaged
from paddle_tpu.ops.rope import build_rope_cache as jrope_cache
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.distributed.trainer import (tree_leaves,
                                                   tree_unflatten)
from paddle_tpu_torch.inference import generation as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.observability.compile import CompileWatcher
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpaged
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.ops.kernels import fused_adamw as kfw
from paddle_tpu_torch.ops.kernels import norms as knorms
from paddle_tpu_torch.ops.rope import build_rope_cache
from paddle_tpu_torch.optimizer import lr as tlr

pytestmark = pytest.mark.torch_port

TOL = 2e-5
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)   # test_torch_train.py's gradients'
STEPS = 5


@pytest.fixture
def no_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(t):
    return (np.asarray(t.detach().float()) if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _port_cfg(tcls, jcfg, **kw):
    names = [f.name for f in dataclasses.fields(tcls) if f.name != "dtype"]
    return dataclasses.replace(
        tcls(**{n: getattr(jcfg, n) for n in names}, dtype=torch.float32),
        **kw)


# model -> (JAX module, port module, JAX tiny config, port config class)
MODELS = {"llama": (jllama, tllama, jllama.LLAMA_TINY, tllama.LlamaConfig),
          "gpt": (jgpt, tgpt, jgpt.GPT_TINY, tgpt.GPTConfig)}


def _setup(model, acc=1):
    """(JAX config, port config, JAX params, (tokens, labels)) at the tiny
    widths in f32, the JAX side on its composition ("ref")."""
    jmod, _, tiny, tcls = MODELS[model]
    jcfg = dataclasses.replace(tiny, dtype=jnp.float32, fused_train="ref")
    tcfg = _port_cfg(tcls, jcfg)
    params = jmod.init_params(jcfg, jax.random.key(3))
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 512, (2 * acc, 16)).astype(np.int32)
    lab = np.roll(toks, -1, -1)
    if acc > 1:
        toks, lab = toks.reshape(acc, 2, 16), lab.reshape(acc, 2, 16)
    return jcfg, tcfg, params, (toks, lab)


def _schedule(mod):
    """lr changing every step: a warm-up into a cosine decay."""
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=8),
                            warmup_steps=3, start_lr=2.5e-4, end_lr=1e-3)


def _jax_run(model, jcfg, params, batch, **kw):
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmod = MODELS[model][0]
    mesh = jtrainer.make_mesh(jtrainer.MeshConfig(),
                              devices=jax.devices()[:1])
    tr = jtrainer.Trainer(lambda p, *b: jmod.loss_fn(p, *b, jcfg), mesh,
                          jmod.param_shardings(mesh, jcfg), data_spec=P(),
                          donate=False, **kw)
    state = tr.init_state(params)
    state.step = jax.device_put(state.step, NamedSharding(mesh, P()))
    sched, out = _schedule(jlr), []
    for _ in range(STEPS):
        tr.lr = sched()
        state, m = tr.step(state, *(jnp.asarray(b) for b in batch))
        sched.step()
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jax.tree_util.tree_leaves(state.params)


# case -> (model, trainer kwargs, accumulation count)
CASES = {
    "llama_fused": ("llama", dict(fused_optimizer=True), 1),
    "llama_per_leaf": ("llama", dict(fused_optimizer=False), 1),
    "llama_accumulate": ("llama", dict(fused_optimizer=False), 2),
    "gpt_fused": ("gpt", dict(fused_optimizer=True), 1),
    "gpt_per_leaf": ("gpt", dict(fused_optimizer=False), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduled_steps_match_jax(case, no_x64):
    """5 steps with a scheduler setting ``trainer.lr`` before each: the
    port's program step against the JAX trainer's jitted one, losses,
    grad norms and the final parameters; one program (the key did not
    change with lr), its lr word holding the last value in f32."""
    model, kw, acc = CASES[case]
    jcfg, tcfg, params, batch = _setup(model, acc)
    want, jparams = _jax_run(model, jcfg, params, batch,
                             accumulate_steps=acc, **kw)
    tmod = MODELS[model][1]
    tr = Trainer(lambda p, *b: tmod.loss_fn(p, *b, tcfg), device="cpu",
                 accumulate_steps=acc, **kw)
    state = tr.init_state(tmodels.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    sched, got = _schedule(tlr), []
    for _ in range(STEPS):
        tr.lr = sched()
        state, m = tr.step(state, *batch)
        sched.step()
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert tr._fused == kw["fused_optimizer"]
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], **GRAD_TOL)
    for a, b in zip(tree_leaves(state.params), jparams):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=TOL, atol=TOL)
    assert len(tr._programs) == 1
    assert float(tr._lr_tensor()) == float(np.float32(tr.lr))


def _llama_trainer(**kw):
    jcfg, tcfg, params, batch = _setup("llama")
    tr = Trainer(lambda p, *b: tllama.loss_fn(p, *b, tcfg), device="cpu",
                 lr=1e-3, **kw)
    tparams = tmodels.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return tr, tparams, batch


@pytest.mark.parametrize("fused", [False, True])
def test_step_count_is_one_tensor(fused):
    """``state.step`` is updated in place on both optimizer paths: the
    same tensor (the address a captured step reads) after N steps,
    holding N."""
    tr, tparams, batch = _llama_trainer(fused_optimizer=fused)
    state = tr.init_state(tparams)
    step, ptr = state.step, state.step.data_ptr()
    for _ in range(3):
        state, _ = tr.step(state, *batch)
    assert state.step is step and step.data_ptr() == ptr
    assert step.dtype == torch.int32 and int(step) == 3


def test_lr_word_keeps_its_storage():
    """One f32 lr word a trainer: a new ``lr`` is written into it (its
    value the f32 rounding of the float), never a new tensor, and every
    program reads that word."""
    tr, tparams, batch = _llama_trainer()
    state = tr.init_state(tparams)
    word = tr._lr_tensor()
    ptr = word.data_ptr()
    for lr in (3e-4, 1e-3 / 3, 0.0, 7e-5):
        tr.lr = lr
        state, _ = tr.step(state, *batch)
        assert tr._lr_tensor() is word and word.data_ptr() == ptr
        assert word.item() == float(np.float32(lr))


def test_step_metrics_outlive_the_next_step():
    """A step's ``loss`` and ``grad_norm`` are its own: copies of the
    program's outputs, which the next step (a replay on the card)
    overwrites; writing over the outputs leaves them as they were."""
    tr, tparams, batch = _llama_trainer()
    state = tr.init_state(tparams)
    state, m1 = tr.step(state, *batch)
    kept = {k: v.clone() for k, v in m1.items()}
    (_, _, out), = tr._programs.values()
    for k in m1:
        assert m1[k].data_ptr() != out[k].data_ptr()
        out[k].fill_(123.0)                 # a replay's overwrite
    state, m2 = tr.step(state, *batch)
    for k in m1:
        assert torch.equal(m1[k], kept[k])
    assert float(m2["loss"]) < float(m1["loss"])


def test_second_state_gets_its_own_program():
    """A second ``init_state`` on the same trainer gets a program of its
    own: its steps leave the first state's tensors as they were, and,
    after ``reset_metrics()``, it is no retrace (the signature is
    known)."""
    tr, tparams, batch = _llama_trainer(observability=True)
    first = tr.init_state(tree_unflatten(
        tparams, [v.clone() for v in tree_leaves(tparams)]))
    first, _ = tr.step(first, *batch)
    snap = [t.clone() for part in first.tree() for t in tree_leaves(part)]
    tr.reset_metrics()
    second = tr.init_state(tparams)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for _ in range(2):
            second, _ = tr.step(second, *batch)
    assert len(tr._programs) == 2
    assert tr.metrics()["retrace_warnings"] == 0
    assert tr.metrics()["compiles"] == 1
    for a, b in zip(snap, [t for part in first.tree()
                           for t in tree_leaves(part)]):
        assert torch.equal(a, b)
    assert int(first.step) == 1 and int(second.step) == 2


def test_batch_is_copied_into_fixed_buffers():
    """Each step's batch lands in its key's buffers (the tensors the
    captured step reads), whatever tensors the caller passed; a new
    batch shape is a new key, with buffers of its own."""
    tr, tparams, (toks, lab) = _llama_trainer()
    state = tr.init_state(tparams)
    state, _ = tr.step(state, toks, lab)
    (_, bufs, _), = tr._programs.values()
    ptrs = [b.data_ptr() for b in bufs]
    toks2 = np.roll(toks, 1, 0)
    state, _ = tr.step(state, torch.from_numpy(toks2), lab)
    assert [b.data_ptr() for b in bufs] == ptrs
    assert np.array_equal(bufs[0].numpy(), toks2)
    state, _ = tr.step(state, toks[:1], lab[:1])
    assert len(tr._programs) == 2


def test_compile_watcher_records_captures_apart():
    """A capture is recorded under its program (seconds and graph nodes)
    and on the timeline, and is no retrace, armed or not."""
    from paddle_tpu_torch.observability import Observability
    obs = Observability()
    w = CompileWatcher(obs.registry, obs.timeline)
    w.arm()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        w.record_capture("train_step", 0.25, 1234)
    snap = w.snapshot()
    assert snap["programs"]["train_step"]["captures"] == [
        {"capture_ms": 250.0, "graph_nodes": 1234}]
    assert snap["retraces_after_warmup"] == 0 and snap["count"] == 0
    assert any(e.name == "capture" for e in obs.timeline.events())


def test_isolated_capture_spans_threads():
    """``capture_kernel_launches(isolated=True, all_threads=True)``: a
    launch on another thread (autograd's, in a train step) lands in it
    alone, hidden from a capture around it; once it ends, launches reach
    the outer capture again."""
    x = torch.empty(8, 64, device="meta")
    w = torch.empty(64, device="meta")
    with _launch.capture_kernel_launches(all_threads=True) as outer:
        with _launch.capture_kernel_launches(isolated=True,
                                             all_threads=True) as inner:
            t = threading.Thread(
                target=lambda: knorms.rms_norm_fwd_triton(x, w))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            knorms.rms_norm_fwd_triton(x, w)
        assert [s.name for s in inner] == ["rms_norm_fwd"] * 2
        assert outer == []
        knorms.rms_norm_fwd_triton(x, w)
    assert [s.name for s in outer] == ["rms_norm_fwd"]


# ---------------------------------------------------------------------------
# values the kernels read from device memory
# ---------------------------------------------------------------------------
def _adamw_state(n=5000, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, generator=g), torch.randn(n, generator=g) * 1e-2,
            torch.randn(n, generator=g) * 1e-3,
            torch.rand(n, generator=g) * 1e-4)


@pytest.mark.parametrize("shadow", [None, torch.bfloat16])
def test_fused_adamw_plain_tensor_lr_is_bit_equal(shadow):
    """The plain version given lr as an f32 word (the trainer's) returns
    the bits it returns for the float; the word rides in the fourth entry
    of the bias corrections, as the kernel reads it."""
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1,
              grad_scale=torch.tensor(0.5), shadow_dtype=shadow)
    lr = 3e-4 / 7
    step = torch.tensor(4.0)
    a = kfw.adamw_update_ref(*_adamw_state(), lr, step, **kw)
    b = kfw.adamw_update_ref(*_adamw_state(), torch.tensor(
        lr, dtype=torch.float32), step, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    bc = kfw.bias_corrections(step, 0.9, 0.95, None, "cpu",
                              torch.tensor(lr, dtype=torch.float32))
    assert bc.shape == (4,) and bc[3].item() == float(np.float32(lr))
    assert kfw.adamw_spec(1024, "float32", "float32", "float32",
                          None).operand("bias_corrections").shape == (4,)


@pytest.mark.parametrize("seed", [12345, 3_000_000_000])
def test_flash_plain_with_a_seed_word_equals_the_int(seed):
    """The plain version keyed by the kernels' int32 seed word (made by
    ``seed_word``; a seed past 2^31 wraps into the word's sign) draws the
    int seed's keep mask, in the mask itself and in the attention."""
    word = kfa.seed_word(seed, "cpu")
    assert word.dtype == torch.int32 and word.shape == (1,)
    qbh = torch.arange(6).reshape(2, 3, 1, 1)
    qpos = torch.arange(40)[:, None]
    kpos = torch.arange(33)[None, :]
    assert torch.equal(kfa.dropout_keep(word, qbh, qpos, kpos, 0.1),
                       kfa.dropout_keep(seed, qbh, qpos, kpos, 0.1))
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 40, 4, 16).astype(np.float32))
               for _ in range(3))
    a = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.1,
                            dropout_seed=seed)
    b = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.1,
                            dropout_seed=word)
    assert torch.equal(a, b)
    o1, _ = kfa.flash_fwd_ref(q, k, v, True, seed=word, rate=0.1)
    o2, _ = kfa.flash_fwd_ref(q, k, v, True, seed=seed, rate=0.1)
    assert torch.equal(o1, o2)


def test_flash_seed_tensor_checked():
    """A seed tensor that is not one int32 element on q's device is
    refused before any launch."""
    q = torch.empty(1, 128, 4, 64, device="meta")
    with _launch.capture_kernel_launches():
        for bad in (torch.zeros(2, dtype=torch.int32, device="meta"),
                    torch.zeros(1, dtype=torch.int64, device="meta")):
            with pytest.raises(ValueError, match="seed tensor"):
                kfa.flash_fwd_cuda(q, q, q, True, seed=bad, rate=0.1)


# ---------------------------------------------------------------------------
# the arguments the port had dropped (ROADMAP Queue C)
# ---------------------------------------------------------------------------
def test_swiglu_one_argument_matches_jax():
    """``swiglu(x)`` splits x's last axis in halves, as the JAX one: [2, 8]
    in, [2, 4] out."""
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    got = tops.swiglu(torch.from_numpy(x))
    want = np.asarray(jops.swiglu(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape == (2, 4)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)


def _paged_inputs(quant):
    rng = np.random.RandomState(5)
    B, H, KV, hd, BS, N, MB = 3, 8, 2, 16, 4, 12, 3
    q = rng.randn(B, H, hd).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (N, BS, KV, hd)).astype(np.int8)
        v = rng.randint(-127, 128, (N, BS, KV, hd)).astype(np.int8)
    else:
        k = rng.randn(N, BS, KV, hd).astype(np.float32)
        v = rng.randn(N, BS, KV, hd).astype(np.float32)
    tables = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.array([5, 12, 0], np.int32)
    scales = (rng.rand(KV).astype(np.float32) * 0.02 + 0.01,
              rng.rand(KV).astype(np.float32) * 0.02 + 0.01)
    return (q, k, v, tables, lens), scales


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_scale_matches_jax(quant):
    """``paged_attention_decode(..., scale=0.3)`` and its int8 form against
    the JAX ones at the same scale; the scale moves the result (0.3 is not
    1/sqrt(16))."""
    arrs, (ks, vs) = _paged_inputs(quant)
    t = [torch.from_numpy(a) for a in arrs]
    if quant:
        got = tpaged.paged_attention_decode_quant(
            *t, torch.from_numpy(ks), torch.from_numpy(vs), scale=0.3)
        want = jpaged.paged_attention_decode_quant(
            *(jnp.asarray(a) for a in arrs), jnp.asarray(ks),
            jnp.asarray(vs), scale=0.3)
        default = tpaged.paged_attention_decode_quant(
            *t, torch.from_numpy(ks), torch.from_numpy(vs))
    else:
        got = tpaged.paged_attention_decode(*t, scale=0.3)
        want = jpaged.paged_attention_decode(
            *(jnp.asarray(a) for a in arrs), scale=0.3)
        default = tpaged.paged_attention_decode(*t)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert not torch.allclose(got, default)


def test_init_cache_dtype_matches_jax():
    """``init_cache(dtype=bfloat16)`` against the JAX one; None keeps the
    config's type."""
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
    tcfg = _port_cfg(tllama.LlamaConfig, jcfg)
    jk, jv = jgen.init_cache(jcfg, 2, 24, dtype=jnp.bfloat16)
    tk, tv = tgen.init_cache(tcfg, 2, 24, dtype=torch.bfloat16,
                             device="cpu")
    for a, b in ((tk, jk), (tv, jv)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
        assert str(b.dtype) == "bfloat16" and not a.any()
    assert tgen.init_cache(tcfg, 2, 24, device="cpu")[0].dtype \
        == torch.float32


def test_build_rope_cache_dtype_matches_jax():
    """``build_rope_cache(dtype=bfloat16)``: the f32 tables rounded to
    bf16, as the JAX one's (the f32 values within 1e-6 of each other;
    the bf16 ones equal where the f32 ones round alike)."""
    ts, tc = build_rope_cache(32, 16, dtype=torch.bfloat16)
    js, jc = jrope_cache(32, 16, dtype=jnp.bfloat16)
    fs, fc = build_rope_cache(32, 16)
    for got, want, f32 in ((ts, js, fs), (tc, jc, fc)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (32, 8)
        assert torch.equal(got, f32.to(torch.bfloat16))
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=2 ** -8, atol=2 ** -8)
