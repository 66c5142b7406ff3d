"""Shared model helpers: the masked cross entropy and the chunked lm-head
+ cross entropy of the training loss (port of
``paddle_tpu/models/_common.py``). Plain PyTorch: the lm head is a large
matrix product (``torch.matmul``, as the JAX package leaves it to XLA),
the rest is a reduction per token."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["masked_cross_entropy", "fused_linear_cross_entropy"]


def masked_cross_entropy(logits, labels):
    """Token cross entropy in f32; negative labels are ignored; the mean
    over the valid count, clamped at 1."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    n = torch.clamp(valid.sum(), min=1)
    return -torch.where(valid, picked, 0.0).sum() / n


def _chunk_ce(x_c, l_c, head):
    logits = (x_c @ head).float()            # [c, V]: the only live chunk
    lse = torch.logsumexp(logits, -1)
    valid = l_c >= 0
    safe = torch.where(valid, l_c, 0)
    picked = torch.gather(logits, 1, safe[:, None])[:, 0]
    ce = torch.where(valid, lse - picked, 0.0)
    return ce.sum(), valid.sum().float()


def fused_linear_cross_entropy(hidden, head, labels,
                               chunk_size: int = 1024):
    """Chunked lm-head + cross entropy that never holds the full [T, V]
    logits: each chunk of ``chunk_size`` tokens computes its logits in f32
    and reduces them to per-token (logsumexp, picked logit); the chunk is
    recomputed in the backward (``torch.utils.checkpoint``, the JAX
    package's ``jax.checkpoint``), so at most one chunk's logits live.
    Same value as ``masked_cross_entropy(hidden @ head, labels)``.

    hidden [..., D], head [D, V], labels [...] int (negative = ignore).
    """
    d = hidden.shape[-1]
    flat = hidden.reshape(-1, d)
    lab = labels.reshape(-1).long()
    t = flat.shape[0]
    c = max(1, min(chunk_size, t))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, t, c):
        cs, cn = checkpoint(_chunk_ce, flat[i:i + c], lab[i:i + c], head,
                            use_reentrant=False, preserve_rng_state=False)
        total = total + cs
        count = count + cn
    return total / torch.clamp(count, min=1.0)
