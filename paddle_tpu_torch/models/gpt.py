"""GPT-2/3-style decoder LM (port of ``paddle_tpu/models/gpt.py``).

The parameter dict keeps the JAX package's layout (stacked ``[L, ...]``
layer weights in the ``[in, out]`` orientation, f32 LayerNorm weights),
so a JAX tree converts by copy (``models.params_from_jax``). The layers
are :func:`._common.prenorm_block` (causal flash attention) in a loop
over the stack, each under ``torch.utils.checkpoint`` when ``cfg.remat``;
the loss is the fused lm-head + CE over the tied head ``wte.T``, which
``cfg.fused_train`` resolves (None or "auto": the ``linear_ce_*`` kernels
on the card, reading the embedding in its own layout, the composition on
the CPU; "ref": the composition; "pallas": the kernels). The head's
gradient and the embedding lookup's meet in ``wte``. The mesh shardings
(``param_shardings``) wait for distributed training (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import resolve_device
from ..ops import layer_norm
from ..ops.fused_train import fused_linear_ce
from ._common import normal_init, prenorm_block, run_layers

__all__ = ["GPTConfig", "GPT_TINY", "init_params", "forward_hidden",
           "forward", "loss_fn"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # the fused linear + CE loss: None/"auto" dispatch, False/"ref" the
    # chunked composition, "pallas" the kernels (the JAX package's knob)
    fused_train: Any = None

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


GPT_TINY = GPTConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                     num_hidden_layers=2, num_attention_heads=4,
                     max_position_embeddings=128)


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters in the JAX layout and ``cfg.dtype`` (normal, std
    0.02; biases 0; LayerNorm weights 1 and biases 0 in f32), drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dtype = cfg.dtype
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L = cfg.num_hidden_layers

    def nrm(shape):
        return normal_init(shape, gen, dtype=dtype, device=device)

    def full(shape, value, dt=torch.float32):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "wte": nrm((V, D)),
        "wpe": nrm((cfg.max_position_embeddings, D)),
        "layers": {
            "ln1_w": full((L, D), 1.0), "ln1_b": full((L, D), 0.0),
            "qkv": nrm((L, D, 3 * D)), "qkv_b": full((L, 3 * D), 0, dtype),
            "proj": nrm((L, D, D)), "proj_b": full((L, D), 0, dtype),
            "ln2_w": full((L, D), 1.0), "ln2_b": full((L, D), 0.0),
            "fc": nrm((L, D, F)), "fc_b": full((L, F), 0, dtype),
            "fc_out": nrm((L, F, D)), "fc_out_b": full((L, D), 0, dtype),
        },
        "ln_f_w": full((D,), 1.0),
        "ln_f_b": full((D,), 0.0),
    }


def _block(lp, x, cfg: GPTConfig):
    return prenorm_block(lp, x, num_heads=cfg.num_attention_heads,
                         head_dim=cfg.head_dim,
                         eps=cfg.layer_norm_epsilon, causal=True)


def forward_hidden(params: Dict, tokens, cfg: GPTConfig):
    """Final-LayerNorm hidden states [B, S, D] for [B, S] int tokens (the
    fused loss applies the tied lm head in chunks instead of holding
    [B, S, V])."""
    tokens = torch.as_tensor(tokens, device=params["wte"].device).long()
    s = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:s][None]
    x = run_layers(params["layers"], x, _block, cfg.remat, cfg)
    return layer_norm(x, params["ln_f_w"].to(x.dtype),
                      params["ln_f_b"].to(x.dtype), cfg.layer_norm_epsilon)


def forward(params: Dict, tokens, cfg: GPTConfig):
    """Logits [B, S, V] over the tied embeddings (GPT-2 convention)."""
    return forward_hidden(params, tokens, cfg) @ params["wte"].T


def loss_fn(params: Dict, tokens, labels, cfg: GPTConfig):
    """Next-token cross entropy through the fused chunked lm-head + CE
    over ``wte.T``: [B, S, V] logits are never held whole; negative labels
    ignored, the f32 mean over the valid tokens."""
    hidden = forward_hidden(params, tokens, cfg)
    labels = torch.as_tensor(labels, device=hidden.device)
    return fused_linear_ce(hidden, params["wte"].T, labels,
                           mode=cfg.fused_train)
