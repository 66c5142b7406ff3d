"""LLaMA: parameters, forward and training loss (port of
``paddle_tpu/models/llama.py``'s functional core).

The parameter dict keeps the JAX package's layout exactly, so a JAX tree
converts by copy (:func:`params_from_jax`):

- ``embed_tokens [V, D]``, optional ``lm_head [D, V]``;
- ``layers``: every per-layer weight stacked on a leading ``[L, ...]``
  axis; projections in the ``[in, out]`` orientation so ``h @ w`` is the
  layer, as in the JAX package;
- norm weights (``input_norm``, ``post_norm``, ``final_norm``) in f32.

:func:`forward_hidden`, :func:`forward` and :func:`loss_fn` are the
training side: a Python loop over the stacked layers (the JAX package's
``lax.scan``), each layer under ``torch.utils.checkpoint`` when
``cfg.remat`` (``jax.checkpoint``), RMSNorm and flash attention through
the port's kernels, the residual epilogue, SwiGLU and the lm-head + CE
through the fused-train ops, which ``cfg.fused_train`` resolves (None or
"auto": registry dispatch; "ref": the compositions; "pallas": the
kernels). The serving engine keeps its own layer loop
(``inference/generation.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import rms_norm
from ..ops.flash_attention import flash_attention
from ..ops.fused_train import (fused_linear_ce, fused_swiglu,
                               residual_rms_norm)
from ..ops.kernels.registry import KERNELS
from ..ops.rope import apply_rope, build_rope_cache

__all__ = ["LlamaConfig", "LLAMA_7B", "LLAMA_TINY", "init_params",
           "params_from_jax", "params_to", "tp_param_specs",
           "forward_hidden", "forward", "loss_fn"]


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
    remat: bool = True
    # the fused training kernels: None/"auto" dispatch, False/"ref" the
    # compositions, "pallas" the kernels (the JAX package's knob)
    fused_train: Any = None

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


def tp_param_specs(cfg: LlamaConfig, axis: str = "tp",
                   collective: str = "psum", params=None) -> Dict:
    """Serving tensor parallelism over a 1-D mesh (port of the JAX
    package's ``tp_param_specs``): for each leaf of the stacked tree, the
    tensor dim the mesh axis ``axis`` splits, or None for a leaf every
    shard holds whole (the JAX package's PartitionSpecs, read as dims).

    q/k/v/gate/up split their output columns (dim 2 of ``[L, D, N]``,
    head-major, so a contiguous column range is a contiguous head range);
    under ``collective="psum"`` o_proj/down_proj split their rows (dim 1:
    each shard's partial product is summed, one psum a sub-block), under
    ``"gather"`` they stay whole (the shards' heads and SwiGLU columns
    are gathered before them). Embedding, norms and lm_head stay whole.
    ``params``: the tree, when it may carry quantized leaves (``{"qw8"|
    "qw4": q, "scale": s}``): their specs mirror the dict, the integers
    keep the base weight's dim and the per-output-channel scale [L, N]
    splits dim 1 with the output columns, or stays whole for the row-split
    o/down projections."""
    col, row = 2, (1 if collective == "psum" else None)
    specs = {
        "embed_tokens": None,
        "layers": {"input_norm": None, "q_proj": col, "k_proj": col,
                   "v_proj": col, "o_proj": row, "post_norm": None,
                   "gate_proj": col, "up_proj": col, "down_proj": row},
        "final_norm": None,
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = None
    if params is not None:
        for k, w in params.get("layers", {}).items():
            if isinstance(w, dict):
                base = specs["layers"][k]
                qk = "qw8" if "qw8" in w else "qw4"
                specs["layers"][k] = {qk: base,
                                      "scale": 1 if base == col else None}
    return specs


def _decoder_layer(lp, x, sin, cos, cfg: LlamaConfig):
    """One decoder block on [B, S, D]; ``lp`` holds one layer's weights.
    The f32 norm weights are cast to x's type inside the graph, so their
    gradient comes back through the cast."""
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    h = rms_norm(x, lp["input_norm"].to(x.dtype), cfg.rms_norm_eps,
                 mode=cfg.fused_train)
    b, s, _ = h.shape
    q = apply_rope((h @ lp["q_proj"]).reshape(b, s, H, hd), sin, cos)
    kk = apply_rope((h @ lp["k_proj"]).reshape(b, s, KV, hd), sin, cos)
    v = (h @ lp["v_proj"]).reshape(b, s, KV, hd)
    attn = flash_attention(q, kk, v, causal=True).reshape(b, s, H * hd)
    x, h = residual_rms_norm(attn @ lp["o_proj"], x,
                             lp["post_norm"].to(x.dtype), cfg.rms_norm_eps,
                             mode=cfg.fused_train)
    ff = fused_swiglu(h @ lp["gate_proj"], h @ lp["up_proj"],
                      mode=cfg.fused_train)
    return x + ff @ lp["down_proj"]


def _same_pins():
    """``checkpoint``'s contexts for the forward and the recomputation: the
    recomputation runs in the autograd engine's thread, so it re-enters
    the forward's registry pins there and dispatches as the forward did
    (the JAX package bakes the dispatch into the traced layer)."""
    return contextlib.nullcontext(), KERNELS.pinned(KERNELS.forced_state())


def forward_hidden(params: Dict, tokens, cfg: LlamaConfig,
                   positions=None):
    """Final-norm hidden states [B, S, D] for [B, S] int tokens;
    ``positions`` [S] picks the rope rows (default 0..S-1)."""
    tokens = torch.as_tensor(tokens, device=params["embed_tokens"].device)
    x = params["embed_tokens"][tokens.long()]
    sin, cos = build_rope_cache(tokens.shape[1], cfg.head_dim,
                                base=cfg.rope_theta, device=x.device)
    if positions is not None:
        pos = torch.as_tensor(positions, device=x.device).long()
        if pos.dim() != 1:
            raise ValueError("positions must be [S]")
        sin, cos = sin[pos], cos[pos]
    # unbind: one view per layer, whose backward stacks the L gradients
    # once (indexing the stack per layer would add L full-size zeros)
    stacks = {k: w.unbind(0) for k, w in params["layers"].items()}
    for i in range(cfg.num_hidden_layers):
        lp = {k: w[i] for k, w in stacks.items()}
        if cfg.remat:
            x = checkpoint(_decoder_layer, lp, x, sin, cos, cfg,
                           use_reentrant=False, preserve_rng_state=False,
                           context_fn=_same_pins)
        else:
            x = _decoder_layer(lp, x, sin, cos, cfg)
    return rms_norm(x, params["final_norm"].to(x.dtype), cfg.rms_norm_eps,
                    mode=cfg.fused_train)


def _head(params):
    head = params.get("lm_head")
    return head if head is not None else params["embed_tokens"].T


def forward(params: Dict, tokens, cfg: LlamaConfig, positions=None):
    """Logits [B, S, V] (hidden states @ lm head)."""
    return forward_hidden(params, tokens, cfg, positions) @ _head(params)


def loss_fn(params: Dict, tokens, labels, cfg: LlamaConfig):
    """Next-token cross entropy in f32 through the chunked lm-head + CE:
    [B, S, V] logits are never held whole. Negative labels are
    ignored."""
    hidden = forward_hidden(params, tokens, cfg)
    labels = torch.as_tensor(labels, device=hidden.device)
    return fused_linear_ce(hidden, _head(params), labels,
                           mode=cfg.fused_train)
