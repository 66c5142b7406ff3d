"""Rotary position embedding (port of ``paddle_tpu/ops/rope.py``).

Plain PyTorch, as the JAX package kept it plain jnp: the rotation is
elementwise work next to the projections and needs no kernel of its own.
Both of the JAX package's styles: neox (rotate halves, LLaMA's) and the
GPT-J interleaved pairs; sin/cos as ``[s, d/2]`` tables or in Paddle's
``[1, s, 1, d]`` (or ``[1, s, 1, d/2]``) convention.
"""
from __future__ import annotations

import torch

__all__ = ["build_rope_cache", "apply_rope"]


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     dtype=torch.float32, device=None):
    """Return (sin, cos) of shape [seq_len, head_dim//2], computed in f32
    and cast to ``dtype``, as the JAX package's."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.sin(freqs).to(dtype), torch.cos(freqs).to(dtype)


def apply_rope(x, sin=None, cos=None, position_ids=None,
               use_neox_rotary_style=True, base=10000.0):
    """x: [batch, seq, heads, head_dim]. ``sin``/``cos`` default to
    :func:`build_rope_cache` over x's sequence; a 4-D table is Paddle's
    ``[1, s, 1, d]`` (its first half taken) or ``[1, s, 1, d/2]``.
    ``position_ids`` [batch, seq] picks rows of the table per token, else
    rows 0..seq-1 line up with the sequence. The rotation runs in f32 and
    casts back to x's type."""
    d = x.shape[-1]
    if sin is None or cos is None:
        sin, cos = build_rope_cache(x.shape[1], d, base=base,
                                    device=x.device)
    if sin.dim() == 4:
        sin = sin[0, :, 0, : d // 2]
        cos = cos[0, :, 0, : d // 2]
    if position_ids is not None:
        idx = position_ids.long()
        sin = sin[idx][:, :, None, :]           # [b, s, 1, d/2]
        cos = cos[idx][:, :, None, :]
    else:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    xf = x.float()
    if use_neox_rotary_style:
        x1 = xf[..., : d // 2]
        x2 = xf[..., d // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:                                       # GPT-J interleaved pairs
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)
