"""Rotary position embedding (port of ``paddle_tpu/ops/rope.py``).

Plain PyTorch, as the JAX package kept it plain jnp: the rotation is
elementwise work next to the projections and needs no kernel of its own.
LLaMA's neox style (rotate halves) only.
"""
from __future__ import annotations

import torch

__all__ = ["build_rope_cache", "apply_rope"]


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     device=None):
    """Return f32 (sin, cos) of shape [seq_len, head_dim//2]."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.sin(freqs), torch.cos(freqs)


def apply_rope(x, sin, cos, position_ids=None):
    """x: [batch, seq, heads, head_dim]; ``position_ids`` [batch, seq]
    picks rows of the table per token, else rows 0..seq-1 line up with
    the sequence. The rotation runs in f32 and casts back to x's type."""
    d = x.shape[-1]
    if position_ids is not None:
        idx = position_ids.long()
        sin = sin[idx][:, :, None, :]           # [b, s, 1, d/2]
        cos = cos[idx][:, :, None, :]
    else:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    xf = x.float()
    x1 = xf[..., : d // 2]
    x2 = xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
