"""BERT / ERNIE-style bidirectional encoder with MLM and pooler heads
(port of ``paddle_tpu/models/bert.py``).

The parameter dict keeps the JAX package's layout, so a JAX tree converts
by copy (``models.params_from_jax``). Post-norm encoder layers in a loop
over the stacked ``[L, ...]`` weights, each under
``torch.utils.checkpoint`` when ``cfg.remat``. Without an attention mask
a layer's attention is the port's non-causal flash op (the CUDA kernels
on the card); with one it is the JAX package's dense f32 composition with
an additive ``-1e9`` bias on the padded keys, which runs no kernel, as
there. The MLM head's full logits are plain, as in the JAX package. The
mesh shardings (``param_shardings``) wait for distributed training
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..device import resolve_device
from ..ops import layer_norm
from ..ops.flash_attention import flash_attention
from ._common import gelu, masked_cross_entropy, normal_init, run_layers

__all__ = ["BertConfig", "ErnieConfig", "BERT_TINY", "ERNIE_TINY",
           "init_params", "forward", "mlm_logits", "mlm_loss"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_epsilon: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


BERT_TINY = BertConfig(vocab_size=512, hidden_size=128,
                       intermediate_size=256, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=128)

# ERNIE-3.0 shares the encoder; alias for config parity
ErnieConfig = BertConfig
ERNIE_TINY = BERT_TINY


def init_params(cfg: BertConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters in the JAX layout and ``cfg.dtype`` (normal, std
    0.02; biases 0; LayerNorm weights 1 and biases 0 and the MLM bias in
    f32), drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed``."""
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
        "word_emb": nrm((V, D)),
        "pos_emb": nrm((cfg.max_position_embeddings, D)),
        "type_emb": nrm((cfg.type_vocab_size, D)),
        "emb_ln_w": full((D,), 1.0), "emb_ln_b": full((D,), 0.0),
        "layers": {
            "qkv": nrm((L, D, 3 * D)), "qkv_b": full((L, 3 * D), 0, dtype),
            "proj": nrm((L, D, D)), "proj_b": full((L, D), 0, dtype),
            "attn_ln_w": full((L, D), 1.0), "attn_ln_b": full((L, D), 0.0),
            "fc": nrm((L, D, F)), "fc_b": full((L, F), 0, dtype),
            "fc_out": nrm((L, F, D)), "fc_out_b": full((L, D), 0, dtype),
            "ffn_ln_w": full((L, D), 1.0), "ffn_ln_b": full((L, D), 0.0),
        },
        "pooler_w": nrm((D, D)), "pooler_b": full((D,), 0, dtype),
        "mlm_dense": nrm((D, D)), "mlm_dense_b": full((D,), 0, dtype),
        "mlm_ln_w": full((D,), 1.0), "mlm_ln_b": full((D,), 0.0),
        "mlm_bias": full((V,), 0.0),
    }


def _masked_attention(q, k, v, attn_bias):
    """The JAX package's padding-mask path: dense softmax attention in f32
    with the additive bias [B, 1, 1, S], cast back to q's type."""
    hd = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / (hd ** 0.5)
    probs = torch.softmax(scores + attn_bias, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v.float()).to(q.dtype)


def _encoder_layer(lp, x, cfg: BertConfig, attn_bias=None):
    """Post-norm encoder block (BERT convention)."""
    H, hd = cfg.num_attention_heads, cfg.head_dim
    b, s, D = x.shape
    qkv = x @ lp["qkv"] + lp["qkv_b"]
    q, k, v = (t.reshape(b, s, H, hd) for t in qkv.chunk(3, dim=-1))
    if attn_bias is not None:
        attn = _masked_attention(q, k, v, attn_bias)
    else:
        attn = flash_attention(q, k, v, causal=False)
    eps = cfg.layer_norm_epsilon
    x = layer_norm(x + attn.reshape(b, s, D) @ lp["proj"] + lp["proj_b"],
                   lp["attn_ln_w"].to(x.dtype), lp["attn_ln_b"].to(x.dtype),
                   eps)
    ff = gelu(x @ lp["fc"] + lp["fc_b"])
    return layer_norm(x + ff @ lp["fc_out"] + lp["fc_out_b"],
                      lp["ffn_ln_w"].to(x.dtype),
                      lp["ffn_ln_b"].to(x.dtype), eps)


def forward(params: Dict, input_ids, cfg: BertConfig, token_type_ids=None,
            attention_mask=None):
    """Returns (sequence_output [B, S, D], pooled_output [B, D]).
    ``attention_mask`` [B, S]: keys where it is 0 are masked out."""
    dev = params["word_emb"].device
    ids = torch.as_tensor(input_ids, device=dev).long()
    s = ids.shape[1]
    x = params["word_emb"][ids] + params["pos_emb"][:s][None]
    types = (torch.zeros_like(ids) if token_type_ids is None
             else torch.as_tensor(token_type_ids, device=dev).long())
    x = x + params["type_emb"][types]
    x = layer_norm(x, params["emb_ln_w"].to(x.dtype),
                   params["emb_ln_b"].to(x.dtype), cfg.layer_norm_epsilon)
    attn_bias = None
    if attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=dev)
        attn_bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                                -1e9).float()
    x = run_layers(params["layers"], x, _encoder_layer, cfg.remat, cfg,
                   attn_bias)
    pooled = torch.tanh(x[:, 0] @ params["pooler_w"] + params["pooler_b"])
    return x, pooled


def mlm_logits(params: Dict, seq_out, cfg: BertConfig):
    """MLM head: dense + GELU + LayerNorm + the tied-embedding decoder."""
    h = gelu(seq_out @ params["mlm_dense"] + params["mlm_dense_b"])
    h = layer_norm(h, params["mlm_ln_w"].to(h.dtype),
                   params["mlm_ln_b"].to(h.dtype), cfg.layer_norm_epsilon)
    return h @ params["word_emb"].T + params["mlm_bias"]


def mlm_loss(params: Dict, input_ids, labels, cfg: BertConfig,
             token_type_ids=None, attention_mask=None):
    """Masked-LM cross entropy; labels == -100 (or any negative) ignored
    (BERT-base MLM pretraining)."""
    seq_out, _ = forward(params, input_ids, cfg, token_type_ids,
                         attention_mask)
    labels = torch.as_tensor(labels, device=seq_out.device)
    return masked_cross_entropy(mlm_logits(params, seq_out, cfg), labels)
