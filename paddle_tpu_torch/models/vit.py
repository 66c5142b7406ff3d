"""Vision Transformer (port of ``paddle_tpu/models/vit.py``).

The parameter dict keeps the JAX package's layout (the patch kernel OIHW,
stacked ``[L, ...]`` layer weights), so a JAX tree converts by copy
(``models.params_from_jax``). Patchify is one strided ``F.conv2d`` (the
JAX package's ``lax.conv_general_dilated``, left to XLA there), then the
patch bias, the class token and the position embedding; the layers are
:func:`._common.prenorm_block` with non-causal flash attention over the
patch tokens plus the class token (197 at 224 / 16, no whole number of
the kernels' tiles), each under ``torch.utils.checkpoint`` when
``cfg.remat``; the head reads token 0 after the final LayerNorm. The mesh
shardings (``param_shardings``) wait for distributed training (ROADMAP
A11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import layer_norm
from ._common import normal_init, prenorm_block, run_layers

__all__ = ["ViTConfig", "VIT_TINY", "init_params", "forward", "loss_fn"]


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_classes: int = 1000
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


VIT_TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                     intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_classes=10)


def init_params(cfg: ViTConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters in the JAX layout and ``cfg.dtype`` (normal, std
    0.02; biases 0; LayerNorm weights 1 and biases 0 in f32), drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dtype = cfg.dtype
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    L, P, C = cfg.num_hidden_layers, cfg.patch_size, cfg.num_channels

    def nrm(shape):
        return normal_init(shape, gen, dtype=dtype, device=device)

    def full(shape, value, dt=torch.float32):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "patch_w": nrm((D, C, P, P)),             # OIHW conv kernel
        "patch_b": full((D,), 0, dtype),
        "cls": nrm((1, 1, D)),
        "pos_emb": nrm((cfg.num_patches + 1, D)),
        "layers": {
            "ln1_w": full((L, D), 1.0), "ln1_b": full((L, D), 0.0),
            "qkv": nrm((L, D, 3 * D)), "qkv_b": full((L, 3 * D), 0, dtype),
            "proj": nrm((L, D, D)), "proj_b": full((L, D), 0, dtype),
            "ln2_w": full((L, D), 1.0), "ln2_b": full((L, D), 0.0),
            "fc": nrm((L, D, F_)), "fc_b": full((L, F_), 0, dtype),
            "fc_out": nrm((L, F_, D)), "fc_out_b": full((L, D), 0, dtype),
        },
        "ln_f_w": full((D,), 1.0), "ln_f_b": full((D,), 0.0),
        "head_w": nrm((D, cfg.num_classes)),
        "head_b": full((cfg.num_classes,), 0, dtype),
    }


def _block(lp, x, cfg: ViTConfig):
    return prenorm_block(lp, x, num_heads=cfg.num_attention_heads,
                         head_dim=cfg.head_dim,
                         eps=cfg.layer_norm_epsilon, causal=False)


def forward(params: Dict, images, cfg: ViTConfig):
    """images [B, C, H, W] -> logits [B, num_classes]."""
    w = params["patch_w"]
    images = torch.as_tensor(images, device=w.device).to(w.dtype)
    x = F.conv2d(images, w, stride=cfg.patch_size)    # [B, D, gh, gw]
    b, D = x.shape[:2]
    x = x.reshape(b, D, -1).transpose(1, 2) + params["patch_b"]
    cls = params["cls"].to(x.dtype).expand(b, 1, D)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"][None]
    x = run_layers(params["layers"], x, _block, cfg.remat, cfg)
    x = layer_norm(x, params["ln_f_w"].to(x.dtype),
                   params["ln_f_b"].to(x.dtype), cfg.layer_norm_epsilon)
    return x[:, 0] @ params["head_w"] + params["head_b"]


def loss_fn(params: Dict, images, labels, cfg: ViTConfig):
    """Mean cross entropy of the class logits, in f32."""
    logp = torch.log_softmax(forward(params, images, cfg).float(), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    return -torch.gather(logp, 1, labels[:, None])[:, 0].mean()
