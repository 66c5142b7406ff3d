"""PyTorch/CUDA port, training: the RMSNorm backward, the chunked
cross entropy, LLaMA's logits, loss and gradients, and the one-device
``Trainer`` against the JAX package on the CPU (f32 unless a test says
otherwise), on the ``fused_train="ref"`` route; and the fused-train
dispatch contract.

The JAX side runs with x64 off (its AdamW and Pallas calls are
``no_x64``, which this jax cannot enter under x64). Inputs are made with
numpy from a seed and handed to both packages."""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.distributed import trainer as jtrainer
from paddle_tpu.models import _common as jcommon
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import rms_norm_ref as jrms_norm_ref
from paddle_tpu.ops.pallas import norms as jnorms
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.distributed import trainer as ttrainer
from paddle_tpu_torch.models import _common as tcommon
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import fused_train as tft
from paddle_tpu_torch.ops.kernels import norms as tnorms
from paddle_tpu_torch.ops.kernels.registry import (dispatch_fused_variant,
                                                   fused_train_mode)

pytestmark = pytest.mark.torch_port

TOL = dict(atol=2e-5, rtol=1e-5)          # f32 values, sums reordered
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)     # the JAX fused-train tests' own

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           fused_train="ref")


def port_cfg(cfg, dtype=torch.float32, **kw):
    names = [f.name for f in dataclasses.fields(tllama.LlamaConfig)
             if f.name != "dtype"]
    return dataclasses.replace(
        tllama.LlamaConfig(**{n: getattr(cfg, n) for n in names},
                           dtype=dtype), **kw)


TCFG = port_cfg(JCFG)


@pytest.fixture
def no_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(t):
    return np.asarray(t.detach().float()) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@functools.lru_cache(maxsize=None)
def _jparams(dtype=jnp.float32, seed=0):
    """JAX parameters, made once per (dtype, seed): JAX arrays are
    immutable, the JAX trainer runs with donate=False, and the port copies
    them (params_from_jax)."""
    return jllama.init_params(JCFG, jax.random.key(seed), dtype=dtype)


def _tparams(jp):
    return tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")


def _batch(seed, b=2, s=16, vocab=512):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, -1)


# ---------------------------------------------------------------------------
# RMSNorm backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 48)])
def test_rms_bwd_ref_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    want = jnorms._rms_bwd_ref(1e-6, (jnp.asarray(x), jnp.asarray(w)),
                               jnp.asarray(g))
    got = tnorms.rms_bwd_ref(1e-6, (_t(x), _t(w)), _t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("mode", [None, "ref"])
def test_rms_norm_autograd_matches_jax(mode):
    """ops.rms_norm under autograd runs the RMSNorm function, whose
    backward is the dispatched composition: dx and dw equal jax.grad
    through the JAX composition."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 7, 32).astype(np.float32)
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    g = rng.randn(4, 7, 32).astype(np.float32)
    wants = jax.jit(lambda a, b, c: jax.vjp(
        lambda a, b: jrms_norm_ref(a, b, 1e-6), a, b)[1](c))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    tx, tw = _t(x, True), _t(w, True)
    y = tops.rms_norm(tx, tw, 1e-6, mode=mode)
    assert y.grad_fn is not None and "RMSNorm" in type(y.grad_fn).__name__
    y.backward(_t(g))
    for a, b in zip((tx.grad, tw.grad), wants):
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAD_TOL)


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------
def test_chunked_ce_matches_jax_with_ignored_labels_and_ragged_chunk():
    """26 tokens in chunks of 8 (a ragged last chunk), some labels < 0:
    value and both grads against the JAX scan composition, and equal to
    the unchunked masked CE."""
    rng = np.random.RandomState(4)
    h = rng.randn(2, 13, 32).astype(np.float32)
    head = (rng.randn(32, 97) * 0.1).astype(np.float32)
    lab = rng.randint(0, 97, (2, 13)).astype(np.int32)
    lab[0, :4] = -100
    lab[1, 7] = -1
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda a, b: jcommon.fused_linear_cross_entropy(
            a, b, jnp.asarray(lab), chunk_size=8), argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(head))
    th, thead = _t(h, True), _t(head, True)
    got = tcommon.fused_linear_cross_entropy(th, thead, _t(lab),
                                             chunk_size=8)
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for a, b in zip((th.grad, thead.grad), wgrads):
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAD_TOL)
    full = tcommon.masked_cross_entropy(_t(h) @ _t(head), _t(lab))
    np.testing.assert_allclose(_np(full), np.asarray(
        jcommon.masked_cross_entropy(jnp.asarray(h @ head),
                                     jnp.asarray(lab))), **TOL)
    np.testing.assert_allclose(_np(full), _np(got), **TOL)


def test_ce_with_every_label_ignored_is_zero():
    got = tcommon.fused_linear_cross_entropy(
        torch.randn(5, 8), torch.randn(8, 11), torch.full((5,), -100))
    assert float(got) == 0.0


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------
def test_llama_forward_logits_match_jax():
    jp = _jparams()
    toks, _ = _batch(5)
    pos = np.random.RandomState(9).permutation(toks.shape[1])
    wants = jax.jit(lambda p, t, pos: (
        jllama.forward(p, t, JCFG), jllama.forward(p, t, JCFG,
                                                   positions=pos)))(
        jp, jnp.asarray(toks), jnp.asarray(pos))
    gots = (tllama.forward(_tparams(jp), toks, TCFG),
            tllama.forward(_tparams(jp), toks, TCFG, positions=pos))
    for got, want in zip(gots, wants):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _leaves(tree):
    return ttrainer.tree_leaves(tree)


def test_llama_loss_and_every_grad_match_jax():
    """loss_fn on the fused_train="ref" route, and the gradient of every
    parameter (layers stacked, norms f32), against jax.value_and_grad."""
    jp = _jparams()
    toks, lab = _batch(6)
    lab[0, :3] = -100
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jnp.asarray(toks), jnp.asarray(lab),
                                 JCFG)))(jp)
    tp = _tparams(jp)
    leaves = [v.requires_grad_(True) for v in _leaves(tp)]
    tl = tllama.loss_fn(tp, toks, lab, TCFG)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAD_TOL)


def test_remat_on_and_off_agree():
    tp = _tparams(_jparams(seed=1))
    toks, lab = _batch(7)
    out = []
    for remat in (True, False):
        leaves = [v.detach().requires_grad_(True) for v in _leaves(tp)]
        p = ttrainer.tree_unflatten(tp, leaves)
        loss = tllama.loss_fn(p, toks, lab, dataclasses.replace(
            TCFG, remat=remat))
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def _jax_run(cfg, params, steps, batch, **kw):
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jtrainer.make_mesh(jtrainer.MeshConfig(),
                              devices=jax.devices()[:1])
    tr = jtrainer.Trainer(lambda p, t, l: jllama.loss_fn(p, t, l, cfg),
                          mesh, jllama.param_shardings(mesh, cfg),
                          data_spec=P(), donate=False, **kw)
    state = tr.init_state(params)
    # the step counter on the mesh, as every later step returns it: else
    # the second step traces and compiles the program again
    state.step = jax.device_put(state.step, NamedSharding(mesh, P()))
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, *(jnp.asarray(b) for b in batch))
        losses.append(float(m["loss"]))
    return losses, state


def _port_run(cfg, params, steps, batch, **kw):
    tr = Trainer(lambda p, t, l: tllama.loss_fn(p, t, l, cfg),
                 device="cpu", **kw)
    state = tr.init_state(params)
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, *batch)
        losses.append(float(m["loss"]))
    assert tr.metrics()["steps"] == steps
    return losses, state, tr


# name -> (param dtype, trainer kwargs, loss and param tolerance, moment
# tolerance as a share of the moment tensor's largest magnitude, or None:
# the moments' relative L2 distance below 5e-2). Per-step f32 roundoff
# compounds through 10 AdamW updates; a moment element whose gradient sums
# cancel carries a larger relative error, hence the tensor-scaled bound
TRAIN_CASES = {
    "fused": (jnp.float32, dict(fused_optimizer=True), 2e-5, 1e-4),
    "per_leaf": (jnp.float32, dict(fused_optimizer=False), 2e-5, 1e-4),
    "clipped": (jnp.float32, dict(fused_optimizer=True, grad_clip=1e-3),
                2e-5, 1e-4),
    "accumulate": (jnp.float32, dict(fused_optimizer=False,
                                     accumulate_steps=2), 2e-5, 1e-4),
    # bf16 weights, f32 norms: the shadow slice-back; bf16 products round
    # at other places in the two frameworks, so the bounds are bf16's
    "bf16_tree": (jnp.bfloat16, dict(fused_optimizer=True,
                                     moment_dtype=jnp.bfloat16), 2e-2, None),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_trainer_trajectory_matches_jax(name, no_x64):
    """10 steps on one batch: the loss trajectory, the final params and,
    on the fused path, the flat master/mu/nu element by element (the
    port's flat layout is the JAX package's leaf order)."""
    dtype, kw, p_tol, m_tol = TRAIN_CASES[name]
    acc = kw.get("accumulate_steps", 1)
    toks, lab = _batch(8, b=2 * acc)
    if acc > 1:
        toks, lab = toks.reshape(acc, 2, -1), lab.reshape(acc, 2, -1)
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    tcfg = port_cfg(jcfg, dtype=torch.bfloat16 if dtype == jnp.bfloat16
                    else torch.float32)
    jkw = dict(kw, lr=1e-3)
    tkw = dict(kw, lr=1e-3)
    if "moment_dtype" in kw:
        tkw["moment_dtype"] = torch.bfloat16
    jl, jstate = _jax_run(jcfg, _jparams(dtype), 10, (toks, lab), **jkw)
    tl, tstate, tr = _port_run(tcfg, _tparams(_jparams(dtype)), 10,
                               (toks, lab), **tkw)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=p_tol, atol=p_tol)
    for a, b in zip(_leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        assert str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=p_tol, atol=p_tol)
    if kw.get("fused_optimizer"):
        assert tr._fused and tstate.master.dim() == 1
        for a, b in ((tstate.master, jstate.master), (tstate.mu, jstate.mu),
                     (tstate.nu, jstate.nu)):
            assert a.shape[0] == b.shape[0] and a.shape[0] % 131072 == 0
            w = np.asarray(b, np.float32)
            if m_tol is None:
                assert np.linalg.norm(_np(a) - w) <= 5e-2 * np.linalg.norm(w)
            else:
                np.testing.assert_allclose(
                    _np(a), w, rtol=p_tol,
                    atol=m_tol * float(np.abs(w).max()))
    assert int(tstate.step) == 10


def test_trainer_defaults_and_refusals():
    """fused_optimizer=None is per leaf on the CPU (the JAX rule off the
    TPU); the distributed and observability knobs are not ported and
    raise; a non-floating tree refuses the forced fused path."""
    tp = _tparams(_jparams())
    tr = Trainer(lambda p, t, l: tllama.loss_fn(p, t, l, TCFG),
                 device="cpu")
    tr.init_state(tp)
    assert not tr._fused
    for kw in ({"mesh": object()}, {"param_specs": {}},
               {"observability": True}, {"telemetry": True},
               {"data_spec": ("dp",)}):
        with pytest.raises(NotImplementedError, match="not ported"):
            Trainer(lambda p: p, device="cpu", **kw)
    for call in (lambda: tr.prefetch([]), lambda: tr.audit(None)):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()
    with pytest.raises(ValueError, match="at most one dtype"):
        Trainer(lambda p: p, device="cpu", fused_optimizer=True).init_state(
            {"a": torch.zeros(3, dtype=torch.bfloat16),
             "b": torch.zeros(3, dtype=torch.float16)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(lambda p: p)


def test_tree_leaves_follow_jax_order():
    jp = _jparams()
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    shapes = [tuple(v.shape) for v in _leaves(_tparams(jp))]
    assert shapes == [v.shape for v in jax.tree_util.tree_leaves(jp)]
    assert names[0] == "['embed_tokens']" and names[-1] == "['lm_head']"


# ---------------------------------------------------------------------------
# the fused-train dispatch contract
# ---------------------------------------------------------------------------
def test_fused_train_mode_normalisation():
    for m, want in ((None, "auto"), (True, "auto"), ("auto", "auto"),
                    (False, "ref"), ("ref", "ref"), ("pallas", "pallas")):
        assert fused_train_mode(m) == want
    with pytest.raises(ValueError):
        fused_train_mode("fast")


@pytest.mark.parametrize("op,meta", [
    ("fused_linear_ce", tft.ce_meta(4096, 4096, 32000, torch.bfloat16,
                                    "cuda")),
    ("fused_swiglu", tft.swiglu_meta(4096, 11008, torch.bfloat16, "cuda")),
    ("rms_norm_residual", tnorms.rms_bwd_meta(4096, 4096, torch.bfloat16,
                                              "cuda")),
    ("rms_norm_bwd", tnorms.rms_bwd_meta(4096, 4096, torch.bfloat16,
                                         "cuda"))])
def test_auto_on_cuda_dispatches_the_kernels(op, meta):
    """On a CUDA meta "auto" selects the hand-written kernels
    ("cuda_fused"); a CUDA meta they refuse (f16; for the row kernels a D
    past one register-resident block) raises with their reason, the
    composition never standing in on the card; "pallas" pins the kernels
    and "ref" the composition on either device; on a CPU meta "auto"
    gives the composition."""
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    kernel = KERNELS.variant(op, "cuda_fused").fn
    plain = KERNELS.variant(op, "unfused").fn
    assert KERNELS.dispatch(op, meta)[0] == "cuda_fused"
    assert dispatch_fused_variant(op, meta, None) is kernel
    with pytest.raises(RuntimeError, match="float32 and bfloat16, not "
                                           "torch.float16"):
        dispatch_fused_variant(op, dict(meta, dtype="torch.float16"), None)
    if "d" in meta:
        with pytest.raises(RuntimeError, match="d=32768 passes 16384"):
            dispatch_fused_variant(op, dict(meta, d=32768), "auto")
    for m in (meta, dict(meta, device="cpu")):
        assert dispatch_fused_variant(op, m, "pallas") is kernel
        assert dispatch_fused_variant(op, m, "ref") is plain
    assert dispatch_fused_variant(op, dict(meta, device="cpu"),
                                  "auto") is plain


def test_recomputation_keeps_the_forward_pins(monkeypatch):
    """A checkpointed layer is recomputed in the thread that runs the
    backward (on CUDA, the autograd engine's own): it must dispatch under
    the forward's registry pins. The pinned variant here counts its calls:
    2L with remat (forward and recomputation), whatever thread runs the
    backward."""
    import threading
    from paddle_tpu_torch.ops import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return tfa._ref_attention(*a, **kw)
    monkeypatch.setattr(KERNELS.variant("flash_attention", "cuda"), "fn",
                        counting)
    tp = _tparams(_jparams())
    leaves = [v.requires_grad_(True) for v in _leaves(tp)]
    toks, lab = _batch(10)
    with KERNELS.force("flash_attention", "cuda"):
        loss = tllama.loss_fn(tp, toks, lab, TCFG)
    out = []
    t = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(loss, leaves)))
    t.start()
    t.join(120)
    assert not t.is_alive() and len(out) == 1
    assert TCFG.remat and len(calls) == 2 * TCFG.num_hidden_layers
