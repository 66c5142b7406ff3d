"""Fused-op functionals (port of part of
``paddle_tpu/incubate/nn/functional/__init__.py``).

:func:`fused_multi_head_attention` is the one caller in the JAX package
of the flash kernels' additive bias and of its gradient: its attention
mask, broadcast to ``[b|1, h|1, s, s]``, rides the kernels' bias operand
(with ``bias_grad`` when the mask requires grad: a learned
relative-position bias), and its attention dropout is the kernels'
in-kernel dropout. :func:`fused_matmul_bias` is a plain product
(``torch.matmul``, as the JAX package leaves it to XLA).

Queued (ROADMAP A14(b)), raising ``NotImplementedError``: the cached
decode step of ``fused_multi_head_attention`` (``cache_kv``),
``fused_feedforward`` and ``fused_multi_transformer``; they launch no
kernel body that this module does not.
"""
from __future__ import annotations

import torch

from ....nn.functional.common import dropout
from ....ops import layer_norm
from ....ops.flash_attention import flash_attention as _flash

__all__ = ["fused_matmul_bias", "fused_multi_head_attention",
           "fused_feedforward", "fused_multi_transformer"]


def fused_matmul_bias(x, y, bias=None, transpose_x=False,
                      transpose_y=False, name=None):
    """``x @ y + bias`` (either operand transposed on its last two
    axes)."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    return out + bias if bias is not None else out


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None,
        cache_kv=None, attn_mask=None, dropout_rate=0.5,
        attn_dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", ring_id=-1, add_residual=True,
        num_heads=None, name=None, generator=None):
    """The whole MHA block: optional pre-LN, the packed QKV product
    (``qkv_weight`` [3, H, hd, hidden], ``qkv_bias`` [3, H, hd]), flash
    attention (the mask as the kernels' bias, attention dropout
    in-kernel), the out-projection, dropout, the residual and optional
    post-LN. ``generator`` feeds both random draws (the attention
    dropout's seed, then the out-projection's dropout mask)."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention with cache_kv (the cached decode "
            "step) is not ported yet (ROADMAP A14(b))")
    residual = x
    hid = x.shape[-1]
    if pre_layer_norm:
        x = layer_norm(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    b, s, _ = x.shape
    _, nh, hd, _ = qkv_weight.shape
    qkv = torch.einsum("bsd,thed->bsthe", x, qkv_weight)    # [B,S,3,H,hd]
    if qkv_bias is not None:
        qkv = qkv + qkv_bias
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias = None
    if attn_mask is not None:
        # the kernels take explicit query and key axes
        bias = attn_mask.expand(attn_mask.shape[0], attn_mask.shape[1], s,
                                k.shape[1])
    ctx = _flash(q, k, v, causal=False, bias=bias,
                 bias_grad=attn_mask is not None and attn_mask.requires_grad,
                 dropout_rate=attn_dropout_rate if training else 0.0,
                 generator=generator)
    out = fused_matmul_bias(ctx.reshape(b, s, nh * hd), linear_weight,
                            linear_bias)
    out = dropout(out, p=dropout_rate, training=training, mode=mode,
                  generator=generator)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = layer_norm(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(*args, **kwargs):
    raise NotImplementedError(
        "incubate.nn.functional.fused_feedforward is not ported yet "
        "(ROADMAP A14(b))")


def fused_multi_transformer(*args, **kwargs):
    raise NotImplementedError(
        "incubate.nn.functional.fused_multi_transformer is not ported yet "
        "(ROADMAP A14(b))")
