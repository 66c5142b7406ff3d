"""LLaMA parameters for serving (port of ``paddle_tpu/models/llama.py``).

The parameter dict keeps the JAX package's layout exactly, so a JAX tree
converts by copy (:func:`params_from_jax`):

- ``embed_tokens [V, D]``, optional ``lm_head [D, V]``;
- ``layers``: every per-layer weight stacked on a leading ``[L, ...]``
  axis; projections in the ``[in, out]`` orientation so ``h @ w`` is the
  layer, as in the JAX package;
- norm weights (``input_norm``, ``post_norm``, ``final_norm``) in f32.

Only the serving side is here; ``forward``/``loss_fn`` come with training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["LlamaConfig", "LLAMA_7B", "LLAMA_TINY", "init_params",
           "params_from_jax", "params_to"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


LLAMA_7B = LlamaConfig()
LLAMA_TINY = LlamaConfig(vocab_size=512, hidden_size=128,
                         intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256)


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters (normal, std 0.02, norms at one) in the JAX
    layout and ``cfg.dtype``, drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``. The numbers differ from
    ``jax.random``'s; tests that need identical weights convert a JAX
    tree with :func:`params_from_jax`. Weights are drawn one layer at a
    time in f32 and cast, so the f32 transient is one layer's slice, not
    the whole stack."""
    dtype = cfg.dtype
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    L = cfg.num_hidden_layers
    std = 0.02

    def nrm(shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for sl in (out if len(shape) == 3 else (out,)):
            sl.copy_(torch.randn(sl.shape, generator=gen, device=device,
                                 dtype=torch.float32) * std)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    params = {
        "embed_tokens": nrm((V, D)),
        "layers": {
            "input_norm": ones((L, D)),
            "q_proj": nrm((L, D, H * hd)),
            "k_proj": nrm((L, D, KV * hd)),
            "v_proj": nrm((L, D, KV * hd)),
            "o_proj": nrm((L, H * hd, D)),
            "post_norm": ones((L, D)),
            "gate_proj": nrm((L, D, F)),
            "up_proj": nrm((L, D, F)),
            "down_proj": nrm((L, F, D)),
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm((D, V))
    return params


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: reinterpret bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree, device=None) -> Dict:
    """A JAX parameter tree (arrays or numpy arrays, nested dicts) as
    this package's tensors on ``device``. The layouts agree, so every
    leaf is a copy: same shape, same dtype, no transpose."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree).to(device)


def params_to(params: Dict, device) -> Dict:
    """``params`` with every tensor on ``device`` (no copy for a tensor
    that is already there)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)
