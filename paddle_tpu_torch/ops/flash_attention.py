"""Flash attention (port of ``paddle_tpu/ops/flash_attention.py``).

Layout ``[batch, seq, heads, head_dim]``; K/V may carry fewer heads than Q
(GQA). :func:`flash_attention` dispatches through the kernel registry
(op ``"flash_attention"``):

- ``"cuda"`` (priority 10): the three hand-written kernels of
  :mod:`.kernels.flash_attention` as one autograd op, for CUDA tensors
  in f32 or bf16, head_dim a multiple of 8 up to 128, no bias, no segment
  ids, and not causal with ``sq > sk``;
- ``"unfused"`` (priority 0): :func:`_ref_attention`, the plain version,
  for CPU tensors only.

So on the card a call launches the kernels or raises with each variant's
reason (bias and segment ids are not ported there); a ``KERNELS.force``
pin runs the plain version on CUDA tensors on purpose (``chip_smoke.py``'s
whole-step parity does). In-kernel dropout is not ported: a rate above 0
raises ``NotImplementedError`` on every route.
"""
from __future__ import annotations

import math

import torch

from .kernels.flash_attention import flash_attention_cuda, flash_unsupported
from .kernels.registry import KERNELS

__all__ = ["flash_attention", "flash_meta", "segment_ids_from_cu_seqlens",
           "_ref_attention"]


def _no_dropout(rate):
    if rate and rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported: the JAX kernels' hash-seeded "
            "keep mask comes with the slice that trains with it (ROADMAP B7)")


def _ref_attention(q, k, v, causal=False, scale=None, bias=None,
                   segment_ids=None, kv_segment_ids=None,
                   dropout_rate=0.0, dropout_seed=None):
    """Softmax attention in f32 with the JAX package's masking: causal
    bottom-right (``tril(k=sk - sq)``), an additive bias
    ``[b|1, h|1, sq, sk]``, segment ids (keys of another segment are
    masked; a row with no valid key gives 0), GQA by repeating K/V."""
    _no_dropout(dropout_rate)
    d = q.shape[-1]
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if bias is not None:
        logits = logits + bias.float()
    ql, kl = logits.shape[-2], logits.shape[-1]
    mask = torch.ones(ql, kl, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril(kl - ql)
    mask = mask[None, None]
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None \
            else segment_ids
        mask = mask & (segment_ids[:, None, :, None]
                       == kv_seg[:, None, None, :])
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    if segment_ids is not None:
        any_valid = mask.any(-1)                        # [b, 1, q]
        out = torch.where(any_valid.transpose(1, 2)[..., None], out, 0.0)
    return out.to(q.dtype)


def flash_meta(q, k, causal, bias=None, segment_ids=None) -> dict:
    """Static dispatch metadata of one call: the device, bias and segment
    ids, and why the kernels refuse the operands' shapes and type (or
    None)."""
    return {"device": q.device.type, "bias": bias is not None,
            "segments": segment_ids is not None,
            "unsupported": flash_unsupported(q, k, causal)}


def _supports_cuda(meta):
    if meta["device"] != "cuda":
        return False, "the CUDA kernels take CUDA tensors"
    if meta["bias"] or meta["segments"]:
        return False, ("additive bias and segment ids are not ported to "
                       "the CUDA kernels (ROADMAP B7)")
    if meta["unsupported"] is not None:
        return False, meta["unsupported"]
    return True, "CUDA kernels: causal/full, GQA, f32/bf16, d <= 128"


def _supports_plain(meta):
    if meta["device"] != "cpu":
        return False, ("the plain version is the CPU's route; on the card "
                       "the kernels run or the call raises")
    return True, "plain version on the CPU"


KERNELS.register("flash_attention", "cuda", flash_attention_cuda,
                 priority=10, supports=_supports_cuda)
KERNELS.register("flash_attention", "unfused", _ref_attention, priority=0,
                 supports=_supports_plain)


def flash_attention(q, k, v, causal=False, scale=None, bias=None,
                    segment_ids=None, kv_segment_ids=None, bias_grad=False,
                    dropout_rate=0.0, dropout_seed=None):
    """The JAX package's ``flash_attention``: same arguments, same
    results. ``bias`` is a constant unless ``bias_grad``."""
    _no_dropout(dropout_rate)
    if bias is not None and not bias_grad:
        bias = bias.detach()
    _, fn = KERNELS.dispatch("flash_attention",
                             flash_meta(q, k, causal, bias, segment_ids))
    return fn(q, k, v, causal=causal, scale=scale, bias=bias,
              segment_ids=segment_ids, kv_segment_ids=kv_segment_ids)


def segment_ids_from_cu_seqlens(cu_seqlens, total: int):
    """[n+1] cumulative lengths -> [total] int32 segment ids; positions
    past ``cu_seqlens[-1]`` get id -1 (masked against every real
    segment)."""
    cu = torch.as_tensor(cu_seqlens, dtype=torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu, pos, right=True).to(torch.int32) - 1
    n = cu.shape[0] - 1
    return torch.where(seg >= n, -1, seg)
