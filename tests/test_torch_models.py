"""PyTorch/CUDA port, the GPT, BERT/ERNIE and ViT model families and
``fused_rotary_position_embedding`` against the JAX package on the CPU.

Each model runs at its ``*_TINY`` config on the same weights (the JAX
``init_params``, converted with ``models.params_from_jax``) and the same
inputs (numpy, seeded) through the JAX function and the port's: forward
outputs, the loss and the gradient of every parameter, with ``remat`` on
and off; then 3 ``Trainer`` steps of each against the JAX trainer.

Tolerances: in f32 the loss within 1e-5 relative, every gradient and
forward output within 1e-4 of its largest magnitude (the same
compositions, summed in another order); in bf16 the loss within 2e-2
relative (the JAX fused-train tests' documented bound) and every gradient
leaf held to a relative L2 error, ``|got - want|_2 / |want|_2``: within
2e-2 of the exact gradient (the JAX function in f32 on the same
bf16-rounded weights), and within 2e-2 plus the JAX bf16 run's own error
against that exact gradient of the JAX bf16 run (bf16 products and sums
round at other places in the two frameworks; a bias gradient sums few
rows at these sizes, so its rounding cancels less, and the JAX bf16
run's own error there reaches 2e-2). A leaf whose exact gradient is 0
(BERT's pooler, outside the MLM loss) is 0 on both sides. The JAX
trainer runs with x64 off (its AdamW is ``no_x64``)."""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.distributed import trainer as jtrainer
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import vit as jvit
from paddle_tpu.ops import fused_rotary_position_embedding as jfrope
from paddle_tpu.ops.rope import build_rope_cache as jrope_cache
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.distributed.trainer import tree_leaves
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import vit as tvit
from paddle_tpu_torch.ops.rope import build_rope_cache

pytestmark = pytest.mark.torch_port

F32_LOSS, F32_MAX = 1e-5, 1e-4          # relative; of the largest magnitude
BF16 = 2e-2                             # relative (L2 for grads)


@pytest.fixture
def no_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(t):
    return (np.asarray(t.detach().float()) if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, want, tol):
    """|got - want| <= tol x max|want| elementwise."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= tol * max(float(np.abs(w).max()), 1e-30)


def _port_cfg(tcls, jcfg, dtype, **kw):
    names = [f.name for f in dataclasses.fields(tcls) if f.name != "dtype"]
    return dataclasses.replace(
        tcls(**{n: getattr(jcfg, n) for n in names}, dtype=dtype), **kw)


# name -> (JAX module, port module, tiny config, port config class, seed)
FAMILIES = {
    "gpt": (jgpt, tgpt, jgpt.GPT_TINY, tgpt.GPTConfig, 0),
    "bert": (jbert, tbert, jbert.BERT_TINY, tbert.BertConfig, 1),
    "vit": (jvit, tvit, jvit.VIT_TINY, tvit.ViTConfig, 2),
}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name, dt="float32", remat=True, **kw):
    """(JAX config, port config) at the tiny widths; ``kw`` (GPT's
    ``fused_train``) goes to the port's, the JAX side keeping its
    composition ("ref")."""
    _, _, tiny, tcls, _ = FAMILIES[name]
    jdt, tdt = _DT[dt]
    jkw = {"fused_train": "ref"} if name == "gpt" else {}
    jcfg = dataclasses.replace(tiny, dtype=jdt, remat=remat, **jkw)
    return jcfg, _port_cfg(tcls, jcfg, tdt, **kw)


@functools.lru_cache(maxsize=None)
def _jparams(name, dt="float32"):
    """JAX parameters, made once per (family, dtype): JAX arrays are
    immutable and the port copies them."""
    jmod, _, tiny, _, seed = FAMILIES[name]
    return jmod.init_params(dataclasses.replace(tiny, dtype=_DT[dt][0]),
                            jax.random.key(seed))


def _tparams(jp):
    return tmodels.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")


def _tokens(seed, b=2, s=16, vocab=512):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (b, s)).astype(np.int32)


def _padding_mask(b=2, s=16):
    mask = np.ones((b, s), np.int32)
    mask[1, 11:] = 0                      # the second row padded
    mask[0, 15:] = 0
    return mask


def _batch(name, seed):
    """(args after the params, JAX loss, port loss) of one family."""
    rng = np.random.RandomState(seed)
    if name == "gpt":
        toks = _tokens(seed)
        return (toks, np.roll(toks, -1, -1)), jgpt.loss_fn, tgpt.loss_fn
    if name == "bert":
        toks = _tokens(seed)
        lab = np.full(toks.shape, -100, np.int32)
        lab[:, 1::3] = toks[:, 1::3]          # the masked-LM targets
        return (toks, lab), jbert.mlm_loss, tbert.mlm_loss
    img = rng.randn(3, 3, 32, 32).astype(np.float32)
    return (img, rng.randint(0, 10, 3).astype(np.int32)), jvit.loss_fn, \
        tvit.loss_fn


def _value_and_grads(name, dt, remat, port_kw=None, loss_kw=None):
    jcfg, tcfg = _cfgs(name, dt, remat=remat, **(port_kw or {}))
    args, jloss, tloss = _batch(name, 3)
    loss_kw = loss_kw or {}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        p, *(jnp.asarray(a) for a in args), jcfg,
        **{k: jnp.asarray(v) for k, v in loss_kw.items()})))(
        _jparams(name, dt))
    tp = _tparams(_jparams(name, dt))
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    tl = tloss(tp, *args, tcfg, **loss_kw)
    # BERT's pooler takes no part in the MLM loss: its gradient is 0
    tg = torch.autograd.grad(tl, leaves, allow_unused=True,
                             materialize_grads=True)
    return (tl, tg), (jl, jax.tree_util.tree_leaves(jg))


def _exact_grads(name, remat):
    """The JAX function's gradient in f32 on the bf16-rounded weights."""
    jcfg, _ = _cfgs(name, "float32", remat=remat)
    args, jloss, _ = _batch(name, 3)
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                 _jparams(name, "bfloat16"))
    g = jax.jit(jax.grad(lambda p: jloss(
        p, *(jnp.asarray(a) for a in args), jcfg)))(p32)
    return jax.tree_util.tree_leaves(g)


def _rel_l2(got, want):
    return float(np.linalg.norm(_np(got) - _np(want))
                 / np.linalg.norm(_np(want)))


def _check_loss_and_grads(got, want, dt, exact=None):
    """``exact``: in bf16, the f32 gradient of the same weights."""
    (tl, tg), (jl, jg) = got, want
    tl = float(tl.detach())
    assert np.isfinite(tl) and len(tg) == len(jg)
    if dt == "float32":
        assert abs(tl - float(jl)) <= F32_LOSS * abs(float(jl))
    else:
        np.testing.assert_allclose(tl, float(jl), rtol=BF16)
        assert len(exact) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert str(a.dtype)[6:] == str(b.dtype)
        if dt == "float32":
            _close(a, b, F32_MAX)
        elif not np.any(_np(exact[i])):
            assert not np.any(_np(a)) and not np.any(_np(b))
        else:
            assert _rel_l2(a, exact[i]) <= BF16, i
            assert _rel_l2(a, b) <= BF16 + _rel_l2(b, exact[i]), i


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_params_and_converter_keep_the_jax_layout(name, dt):
    """The port's init_params and a converted JAX tree have the JAX
    tree's keys, shapes and types (f32 norms beside ``dtype`` weights);
    the converted leaves are the JAX values bit for bit."""
    jcfg, tcfg = _cfgs(name, dt)
    jp = _jparams(name, dt)
    mine = FAMILIES[name][1].init_params(tcfg, seed=5, device="cpu")
    conv = _tparams(jp)
    jleaves = jax.tree_util.tree_leaves(jp)
    for tree in (mine, conv):
        leaves = tree_leaves(tree)
        assert [tuple(v.shape) for v in leaves] == [v.shape for v in jleaves]
        assert [str(v.dtype)[6:] for v in leaves] == \
            [str(v.dtype) for v in jleaves]
    for a, b in zip(tree_leaves(conv), jleaves):
        assert np.array_equal(_np(a), np.asarray(b, np.float32))
    emb = {"gpt": "wte", "bert": "word_emb", "vit": "pos_emb"}[name]
    assert float(mine[emb].float().std()) == pytest.approx(0.02, rel=0.1)


def test_ernie_aliases_are_bert():
    assert tbert.ErnieConfig is tbert.BertConfig
    assert tbert.ERNIE_TINY is tbert.BERT_TINY
    assert dataclasses.replace(tbert.ERNIE_TINY, dtype=torch.float32) == \
        _cfgs("bert")[1]


# ---------------------------------------------------------------------------
# forward outputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
def test_gpt_logits_match_jax(remat):
    jcfg, tcfg = _cfgs("gpt", remat=remat)
    toks = _tokens(4)
    want = jax.jit(lambda p, t: jgpt.forward(p, t, jcfg))(
        _jparams("gpt"), jnp.asarray(toks))
    _close(tgpt.forward(_tparams(_jparams("gpt")), toks, tcfg), want,
           F32_MAX)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("remat", [True, False])
def test_bert_sequence_and_pooled_match_jax(remat, masked):
    jcfg, tcfg = _cfgs("bert", remat=remat)
    toks = _tokens(5)
    types = (np.arange(16) >= 8).astype(np.int32)[None].repeat(2, 0)
    mask = _padding_mask() if masked else None
    wants = jax.jit(lambda p, t, ty, m: jbert.forward(
        p, t, jcfg, ty, m))(_jparams("bert"), jnp.asarray(toks),
                            jnp.asarray(types),
                            None if mask is None else jnp.asarray(mask))
    gots = tbert.forward(_tparams(_jparams("bert")), toks, tcfg, types, mask)
    for got, want in zip(gots, wants):
        _close(got, want, F32_MAX)


def test_bert_padding_mask_equals_the_unpadded_rows():
    """With a padding mask, a row's unpadded positions equal the unmasked
    (flash) forward of that row cut to its length: the -1e9 bias leaves
    the padded keys no weight."""
    _, tcfg = _cfgs("bert")
    tp = _tparams(_jparams("bert"))
    toks, mask = _tokens(6), _padding_mask()
    seq, _ = tbert.forward(tp, toks, tcfg, attention_mask=mask)
    for i, n in enumerate(mask.sum(1)):
        alone, _ = tbert.forward(tp, toks[i:i + 1, :n], tcfg)
        _close(seq[i:i + 1, :n], alone, F32_MAX)


@pytest.mark.parametrize("remat", [True, False])
def test_vit_logits_match_jax(remat):
    jcfg, tcfg = _cfgs("vit", remat=remat)
    img = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    want = jax.jit(lambda p, x: jvit.forward(p, x, jcfg))(
        _jparams("vit"), jnp.asarray(img))
    got = tvit.forward(_tparams(_jparams("vit")), img, tcfg)
    assert tuple(got.shape) == (2, 10)
    _close(got, want, F32_MAX)


# ---------------------------------------------------------------------------
# losses and every gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused_train", [None, "ref"])
@pytest.mark.parametrize("remat", [True, False])
def test_gpt_loss_and_every_grad_match_jax(remat, fused_train):
    """The tied head's gradient and the embedding lookup's meet in
    ``wte``; ``fused_train`` None (on the CPU: the composition, as "auto"
    dispatches there) and "ref"."""
    got, want = _value_and_grads("gpt", "float32", remat,
                                 {"fused_train": fused_train})
    _check_loss_and_grads(got, want, "float32")


def test_gpt_kernel_route_on_the_cpu_matches_jax():
    """``fused_train="pallas"`` pins the LinearCE Function (the
    ``linear_ce_*`` kernels on the card), whose plain versions run on the
    CPU: the same loss and gradients."""
    got, want = _value_and_grads("gpt", "float32", True,
                                 {"fused_train": "pallas"})
    _check_loss_and_grads(got, want, "float32")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("remat", [True, False])
def test_bert_mlm_loss_and_every_grad_match_jax(remat, masked):
    kw = {"attention_mask": _padding_mask()} if masked else {}
    got, want = _value_and_grads("bert", "float32", remat, loss_kw=kw)
    _check_loss_and_grads(got, want, "float32")


@pytest.mark.parametrize("remat", [True, False])
def test_vit_loss_and_every_grad_match_jax(remat):
    got, want = _value_and_grads("vit", "float32", remat)
    _check_loss_and_grads(got, want, "float32")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_loss_and_every_grad_match_jax(name):
    got, want = _value_and_grads(name, "bfloat16", True)
    _check_loss_and_grads(got, want, "bfloat16", _exact_grads(name, True))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remat_on_and_off_agree_bit_for_bit(name):
    outs = []
    for remat in (True, False):
        (tl, tg), _ = _value_and_grads(name, "float32", remat)
        outs.append([tl] + list(tg))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# fused_rotary_position_embedding
# ---------------------------------------------------------------------------
def _rope_inputs(seed, b=2, s=12, h=3, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("table", ["2d", "4d_full", "4d_half"])
@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("neox", [True, False])
def test_fused_rotary_position_embedding_matches_jax(neox, positions, table):
    """Both rotary styles; ``position_ids`` [b, s] or none; sin/cos as the
    [s, d/2] table or Paddle's [1, s, 1, d] (first half taken) and
    [1, s, 1, d/2]; q, k and v rotated, a missing one None."""
    q, k, v = _rope_inputs(8)
    d = q.shape[-1]
    sin, cos = (np.asarray(t) for t in jrope_cache(24, d))
    if table == "4d_full":
        sin, cos = (np.concatenate([t, t], -1)[None, :, None]
                    for t in (sin, cos))
    elif table == "4d_half":
        sin, cos = sin[None, :, None], cos[None, :, None]
    pos = (np.random.RandomState(9).randint(0, 24, (2, 12))
           if positions else None)
    if not positions:                     # rows 0..s-1 line up with x
        sin, cos = (t[:12] if table == "2d" else t[:, :12]
                    for t in (sin, cos))
    sin, cos = np.array(sin), np.array(cos)
    jk = {"sin": jnp.asarray(sin), "cos": jnp.asarray(cos),
          "use_neox_rotary_style": neox}
    tk = {"sin": torch.from_numpy(sin), "cos": torch.from_numpy(cos),
          "use_neox_rotary_style": neox}
    if positions:
        jk["position_ids"] = jnp.asarray(pos)
        tk["position_ids"] = torch.from_numpy(pos)
    wants = jfrope(jnp.asarray(q), jnp.asarray(k), None, **jk)
    gots = tops.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), None, **tk)
    assert wants[2] is None and gots[2] is None
    for got, want in zip(gots[:2], wants[:2]):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6,
                                   rtol=1e-5)
    # v rotated alone, and the default table (built over x's sequence)
    (jv,) = [t for t in jfrope(jnp.asarray(v), use_neox_rotary_style=neox)
             if t is not None]
    (tv,) = [t for t in tops.fused_rotary_position_embedding(
        torch.from_numpy(v), use_neox_rotary_style=neox) if t is not None]
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=2e-6,
                               rtol=1e-5)


def test_rope_styles_differ_and_neox_keeps_llama_results():
    """The GPT-J style is not the neox style; the neox style of the
    extended ``apply_rope`` is the rotation LLaMA's calls always had
    (sin/cos [s, d/2], no position ids: rotate halves)."""
    from paddle_tpu_torch.ops.rope import apply_rope
    q = torch.from_numpy(_rope_inputs(10)[0])
    sin, cos = build_rope_cache(12, 16)
    neox = apply_rope(q, sin, cos)
    x1, x2 = q[..., :8], q[..., 8:]
    s, c = sin[None, :, None], cos[None, :, None]
    assert torch.equal(neox, torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                                       -1))
    assert not torch.allclose(neox, apply_rope(
        q, sin, cos, use_neox_rotary_style=False))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def _jax_trainer_losses(name, jcfg, args, steps):
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmod = FAMILIES[name][0]
    jloss = _batch(name, 0)[1]
    mesh = jtrainer.make_mesh(jtrainer.MeshConfig(),
                              devices=jax.devices()[:1])
    tr = jtrainer.Trainer(lambda p, *b: jloss(p, *b, jcfg), mesh,
                          jmod.param_shardings(mesh, jcfg), data_spec=P(),
                          donate=False, lr=1e-3)
    state = tr.init_state(_jparams(name))
    state.step = jax.device_put(state.step, NamedSharding(mesh, P()))
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, *(jnp.asarray(a) for a in args))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_leaves(state.params)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_trainer_three_steps_match_jax(name, fused, no_x64):
    """3 AdamW steps on one batch: the port's Trainer (per leaf and the
    flat fused path, whose kernel's plain version runs on the CPU) against
    the JAX trainer's losses and final params (f32 roundoff compounds
    through the updates: 2e-5, test_torch_train.py's bound)."""
    jcfg, tcfg = _cfgs(name)
    args, _, tloss = _batch(name, 11)
    jl, jparams = _jax_trainer_losses(name, jcfg, args, 3)
    tr = Trainer(lambda p, *b: tloss(p, *b, tcfg), lr=1e-3, device="cpu",
                 fused_optimizer=fused)
    state = tr.init_state(_tparams(_jparams(name)))
    tl = []
    for _ in range(3):
        state, m = tr.step(state, *args)
        tl.append(float(m["loss"]))
    assert tr._fused == fused and all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-5)
    for a, b in zip(tree_leaves(state.params), jparams):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=2e-5, atol=2e-5)
