"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_unpadded`` and the two qkv-packed forms route to
:func:`paddle_tpu_torch.ops.flash_attention.flash_attention`: on the card
the three flash kernels (with in-kernel dropout, and segment ids from
``cu_seqlens`` for the packed varlen forms), on the CPU their plain
version. ``flashmask_attention``, ``sequence_mask`` and
``sparse_attention`` launch no kernel, in the JAX package either, and stay
plain torch.

The port has no Paddle ``Tensor`` yet: the functions take and return
torch tensors (the JAX package's ``_ensure`` and ``dispatch`` are the
identity here), and the fused route is always on (the JAX package's
``use_fused_kernels`` flag defaults to True; the port has no flags).
Every random draw takes an optional ``generator`` (a ``torch.Generator``;
torch's default one when None): the in-kernel dropout's seed, and
``_sdpa_ref``'s Bernoulli mask.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...ops import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "flashmask_attention",
           "sequence_mask", "sparse_attention"]


def _sdpa_ref(q, k, v, mask, dropout_p, is_causal, training, scale=None,
              generator=None):
    """Softmax attention in f32 over [batch, seq, heads, head_dim]: causal
    bottom-right, a boolean mask (True = attend) or an additive one, and
    Bernoulli dropout drawn from ``generator``."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(ql, kl, dtype=torch.bool,
                            device=q.device).tril(kl - ql)
        logits = torch.where(causal, logits, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        keep = torch.bernoulli(torch.full_like(p, 1.0 - dropout_p),
                               generator=generator).bool()
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Layout [batch, seqlen, num_heads, head_dim]. Without a mask the
    flash op runs it, dropout in-kernel; with a mask, ``_sdpa_ref``."""
    rate = dropout_p if (dropout_p and training) else 0.0
    if attn_mask is None:
        return _fa.flash_attention(query, key, value, causal=is_causal,
                                   dropout_rate=rate, generator=generator)
    return _sdpa_ref(query, key, value, attn_mask, dropout_p, is_causal,
                     training, generator=generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, generator=None):
    """(out, None): the softmax is never returned (fused kernel)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training,
                                       generator=generator)
    return out, None


def _same_packing(cu_q, cu_k) -> bool:
    """Whether queries and keys share the packing; one tensor passed twice
    (the self-attention call) is not read, so no device sync."""
    if cu_q is cu_k:
        return True
    a, b = (torch.as_tensor(c) for c in (cu_q, cu_k))
    return a.shape == b.shape and torch.equal(a.cpu().long(),
                                              b.cpu().long())


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """Varlen (packed) flash attention: ``query``/``key``/``value``
    [total_q | total_k, heads, head_dim] are one batch-1 sequence whose
    per-token segment ids, from ``cu_seqlens_q``/``cu_seqlens_k``
    ([batch + 1] cumulative lengths), confine attention (and causality)
    to each original sequence inside the kernels; dropout is in-kernel.
    ``causal=True`` requires ``cu_seqlens_q == cu_seqlens_k``: the kernels
    mask on packed positions, which is the per-sequence causal mask only
    when queries and keys share the packing. Returns (out, None)."""
    if causal and not _same_packing(cu_seqlens_q, cu_seqlens_k):
        raise NotImplementedError(
            "flash_attn_unpadded(causal=True) requires "
            "cu_seqlens_q == cu_seqlens_k (self-attention packing)")
    tq, tk = query.shape[0], key.shape[0]
    dev = query.device
    seg_q = _fa.segment_ids_from_cu_seqlens(
        torch.as_tensor(cu_seqlens_q, device=dev), tq)[None]
    seg_k = _fa.segment_ids_from_cu_seqlens(
        torch.as_tensor(cu_seqlens_k, device=dev), tk)[None]
    rate = dropout if (dropout and dropout > 0.0 and training) else 0.0
    out = _fa.flash_attention(query[None], key[None], value[None],
                              causal=causal, scale=scale,
                              segment_ids=seg_q, kv_segment_ids=seg_k,
                              dropout_rate=rate, generator=generator)
    return out[0], None


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] mask: position j < x[...]."""
    m = int(maxlen) if maxlen is not None else int(x.max())
    ar = torch.arange(m, device=x.device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return (ar < x[..., None]).to(dt)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None,
                         generator=None):
    """qkv packed [B, S, H/Hk + 2, Hk, D]: the leading slices are the query
    heads (GQA groups), the last two K and V. Returns (out, None)."""
    b, s, n, hk, d = qkv.shape
    g = n - 2
    # the op pairs q head j with kv head j // (H // Hk): the query heads of
    # one kv head must be consecutive, [B,S,G,Hk,D] -> [B,S,Hk*G,D]
    q = qkv[:, :, :-2].transpose(2, 3).reshape(b, s, g * hk, d)
    rate = dropout if (dropout and training) else 0.0
    out = _fa.flash_attention(q, qkv[:, :, -2], qkv[:, :, -1],
                              causal=causal, dropout_rate=rate,
                              generator=generator)
    return out, None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False,
                                fixed_seed_offset=None, rng_name="",
                                training=True, varlen_padded=True,
                                name=None, generator=None):
    """The packed varlen form: qkv [total, H/Hk + 2, Hk, D] and
    cu_seqlens, through :func:`flash_attn_unpadded`."""
    t, n, hk, d = qkv.shape
    q = qkv[:, :-2].transpose(1, 2).reshape(t, (n - 2) * hk, d)
    return flash_attn_unpadded(
        q, qkv[:, -2], qkv[:, -1], cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k, scale=scale,
        dropout=dropout, causal=causal, return_softmax=return_softmax,
        training=training, generator=generator)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """FlashMask (arXiv:2410.01359): column-wise row ranges define the mask.

    startend_row_indices [B, Hk, Sk, L]:
    - L=1 + causal: rows >= LTS[c] are masked for column c;
    - L=2 + causal: rows in [LTS[c], LTE[c]) are masked;
    - L=2 + non-causal: rows >= LTS (lower) and rows < UTE (upper);
    - L=4 + non-causal: rows in [LTS, LTE) and [UTS, UTE) masked.

    The ranges expand to a dense additive mask (-1e30, finite, so a fully
    masked row stays defined) for ``_sdpa_ref``; no kernel runs.
    """
    if startend_row_indices is None:
        return flash_attention(query, key, value, dropout=dropout,
                               causal=causal, training=training,
                               generator=generator)[0]
    iv = startend_row_indices
    b, sq, h, d = query.shape
    sk = key.shape[1]
    hk, L = iv.shape[1], iv.shape[-1]
    rows = torch.arange(sq, device=query.device)[:, None]       # [Sq, 1]
    iv = iv.transpose(2, 3)                                     # [B,Hk,L,Sk]

    def col(j):
        return iv[:, :, j][:, :, None, :]
    if causal:
        if L == 1:
            masked = rows >= col(0)
        elif L == 2:
            masked = (rows >= col(0)) & (rows < col(1))
        else:
            raise NotImplementedError(
                "causal flashmask expects 1 or 2 indices")
        base = rows < torch.arange(sk, device=query.device)[None, :]
        masked = masked | base[None, None]
    else:
        if L == 2:
            masked = (rows >= col(0)) | (rows < col(1))
        elif L == 4:
            masked = ((rows >= col(0)) & (rows < col(1))) | \
                     ((rows >= col(2)) & (rows < col(3)))
        else:
            raise NotImplementedError(
                "non-causal flashmask expects 2 or 4 indices")
    masked = torch.repeat_interleave(masked, h // hk, dim=1)  # [B,H,Sq,Sk]
    bias = torch.where(masked, -1e30, 0.0)
    out = _sdpa_ref(query, key, value, bias, dropout if training else 0.0,
                    False, training, generator=generator)
    if return_softmax_lse or return_seed_offset:
        extras = tuple(None for _ in range(
            int(return_softmax_lse) + int(return_seed_offset)))
        return (out,) + extras
    return out


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention with a CSR connectivity pattern per head:
    q/k/v [B, H, S, D]; offset [B, H, S+1]; columns [B, H, nnz]. Positions
    not listed in a row's CSR columns do not attend (a dense boolean mask);
    a row that attends nothing gives 0."""
    b, h, s, d = query.shape
    off, cols = sparse_csr_offset, sparse_csr_columns
    nnz = cols.shape[-1]
    ar = torch.arange(nnz, device=query.device)
    # the row of each nnz entry: the row starts at or before it
    row_of = (ar[None, None, :] >= off[..., 1:-1, None]).sum(-2)
    valid = ar[None, None, :] < off[..., -1:]
    hits = torch.zeros(b, h, s, s, dtype=torch.int32, device=query.device)
    bidx = torch.arange(b, device=query.device)[:, None, None]
    hidx = torch.arange(h, device=query.device)[None, :, None]
    bidx, hidx, valid = torch.broadcast_tensors(bidx, hidx, valid)
    hits.index_put_((bidx, hidx, row_of, cols.long()), valid.int(),
                    accumulate=True)
    mask = hits > 0
    scores = torch.einsum("bhsd,bhtd->bhst", query.float(),
                          key.float()) / np.sqrt(d)
    if key_padding_mask is not None:
        mask = mask & (key_padding_mask[:, None, None, :] > 0)
    scores = torch.where(mask, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isfinite(scores.amax(-1, keepdim=True)), p, 0.0)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        value.float()).to(query.dtype)
