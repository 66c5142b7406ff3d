"""Flash attention (port of ``paddle_tpu/ops/flash_attention.py``).

Layout ``[batch, seq, heads, head_dim]``; K/V may carry fewer heads than Q
(GQA). :func:`flash_attention` takes the JAX package's arguments whole
(causal, scale, an additive bias ``[b|1, h|1, sq, sk]`` with
``bias_grad``, segment ids, in-kernel dropout) and dispatches through the
kernel registry (op ``"flash_attention"``):

- ``"cuda"`` (priority 10): the three hand-written kernels of
  :mod:`.kernels.flash_attention` as one autograd op, for CUDA tensors in
  f32 or bf16, head_dim a multiple of 8 up to 128, with every body of
  the JAX kernels;
- ``"unfused"`` (priority 0): :func:`_ref_attention`, the plain version,
  for CPU tensors only.

So on the card a call launches the kernels or raises with each variant's
reason; a ``KERNELS.force`` pin runs the plain version on CUDA tensors on
purpose (``chip_smoke.py``'s parity checks do). With dropout and no
``dropout_seed``, the seed is drawn once per call from the ``generator``
(or torch's default one), so the kernels and any plain route of that call
share one keep mask: on the host, or, while a CUDA graph is being
captured, on the device into an int32 word the kernels read (the TPU
kernels' ``seed_ref``), so each replay draws anew from the generator the
graph registered.
"""
from __future__ import annotations

import math

import torch

from .kernels.flash_attention import (dropout_keep, flash_attention_cuda,
                                      flash_unsupported)
from .kernels.registry import KERNELS

__all__ = ["flash_attention", "flash_meta", "segment_ids_from_cu_seqlens",
           "draw_dropout_seed", "draw_dropout_seed_on_device",
           "_ref_attention"]


def _ref_attention(q, k, v, causal=False, scale=None, bias=None,
                   segment_ids=None, kv_segment_ids=None,
                   dropout_rate=0.0, dropout_seed=None):
    """Softmax attention in f32 with the JAX package's masking: causal
    bottom-right (``tril(k=sk - sq)``), an additive bias
    ``[b|1, h|1, sq, sk]``, segment ids (keys of another segment are
    masked; a row with no valid key gives 0), GQA by repeating K/V, and
    dropout with the kernels' keep mask (:func:`dropout_keep` as one block
    spanning the whole matrix, as the JAX ``_ref_attention`` does)."""
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
    if dropout_rate and dropout_rate > 0.0:
        b = q.shape[0]
        qbh = torch.arange(b * h, device=q.device).reshape(b, h, 1, 1)
        keep = dropout_keep(dropout_seed,
                            qbh, torch.arange(ql, device=q.device)[:, None],
                            torch.arange(kl, device=q.device)[None, :],
                            float(dropout_rate))
        p = torch.where(keep, p, 0.0) / (1.0 - dropout_rate)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    if segment_ids is not None:
        any_valid = mask.any(-1)                        # [b, 1, q]
        out = torch.where(any_valid.transpose(1, 2)[..., None], out, 0.0)
    return out.to(q.dtype)


def flash_meta(q, k, causal, bias=None, segment_ids=None,
               dropout=0.0, bias_grad=False) -> dict:
    """Static dispatch metadata of one call: the device, the optional
    bodies it runs (bias, its gradient, segment ids, dropout) and why the
    kernels refuse the operands' shapes and type (or None)."""
    return {"device": q.device.type, "bias": bias is not None,
            "bias_grad": bool(bias is not None and bias_grad),
            "segments": segment_ids is not None,
            "dropout": float(dropout or 0.0),
            "unsupported": flash_unsupported(q, k, causal)}


def _supports_cuda(meta):
    if meta["device"] != "cuda":
        return False, "the CUDA kernels take CUDA tensors"
    if meta["unsupported"] is not None:
        return False, meta["unsupported"]
    return True, ("CUDA kernels: causal/full, GQA, f32/bf16, d <= 128, "
                  "bias and dbias, segment ids, dropout")


def _supports_plain(meta):
    if meta["device"] != "cpu":
        return False, ("the plain version is the CPU's route; on the card "
                       "the kernels run or the call raises")
    return True, "plain version on the CPU"


KERNELS.register("flash_attention", "cuda", flash_attention_cuda,
                 priority=10, supports=_supports_cuda)
KERNELS.register("flash_attention", "unfused", _ref_attention, priority=0,
                 supports=_supports_plain)
# every flash_meta key (``unsupported`` is the kernels' refusal of the
# operands' shapes and type, which a call site fixes)
KERNELS.declare_cache_key("flash_attention", (
    "device", "bias", "bias_grad", "segments", "dropout", "unsupported"))


def _mix64(x: int) -> int:
    """SplitMix64's finalizer: a 64-bit hash of ``x``."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def draw_dropout_seed_on_device(device, generator=None) -> torch.Tensor:
    """A dropout seed in [0, 2^31 - 1) drawn on ``device`` into one int32
    word, from ``generator`` (or the device's default generator): what a
    captured CUDA graph replays, drawing a fresh seed each replay from the
    generator's registered state, with no read on the host."""
    return torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         device=device, generator=generator)


def draw_dropout_seed(generator=None) -> int:
    """A dropout seed in [0, 2^31 - 1), drawn on the host from
    ``generator`` (or torch's default generator): the JAX package draws
    its seed from its framework RNG over the same range. A CUDA generator
    is not read on the device (that would stall the stream once a call):
    the seed hashes its seed and Philox offset, and the draw advances the
    offset by one draw's 4, so each call draws anew and reseeding the
    generator replays the seeds."""
    if generator is None or generator.device.type == "cpu":
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=generator).item())
    off = generator.get_offset()
    generator.set_offset(off + 4)
    return _mix64(generator.initial_seed() * 0x9E3779B97F4A7C15 + off
                  & 0xFFFFFFFFFFFFFFFF) % (2 ** 31 - 1)


def flash_attention(q, k, v, causal=False, scale=None, bias=None,
                    segment_ids=None, kv_segment_ids=None, bias_grad=False,
                    dropout_rate=0.0, dropout_seed=None, generator=None):
    """The JAX package's ``flash_attention``: same arguments, same
    results. ``bias`` is a constant unless ``bias_grad``; dropout is
    in-kernel, keyed by ``dropout_seed`` (an int, or an int32 word on q's
    device; drawn from ``generator`` when None: on the device while a CUDA
    graph is being captured, else on the host)."""
    if bias is not None and not bias_grad:
        bias = bias.detach()
    rate = float(dropout_rate or 0.0)
    if rate > 0.0 and dropout_seed is None:
        # drawn once here, so the kernels and any plain route of this
        # call share one seed
        if q.is_cuda and torch.cuda.is_current_stream_capturing():
            dropout_seed = draw_dropout_seed_on_device(q.device, generator)
        else:
            dropout_seed = draw_dropout_seed(generator)
    seed = dropout_seed if rate > 0.0 else 0
    if not isinstance(seed, torch.Tensor):
        seed = int(seed)
    _, fn = KERNELS.dispatch("flash_attention",
                             flash_meta(q, k, causal, bias, segment_ids,
                                        rate, bias_grad))
    return fn(q, k, v, causal=causal, scale=scale, bias=bias,
              segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
              dropout_rate=rate, dropout_seed=seed)


def segment_ids_from_cu_seqlens(cu_seqlens, total: int):
    """[n+1] cumulative lengths -> [total] int32 segment ids; positions
    past ``cu_seqlens[-1]`` get id -1 (masked against every real
    segment)."""
    cu = torch.as_tensor(cu_seqlens, dtype=torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu, pos, right=True).to(torch.int32) - 1
    n = cu.shape[0] - 1
    return torch.where(seg >= n, -1, seg)
