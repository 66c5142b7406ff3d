"""Shared model helpers (port of ``paddle_tpu/models/_common.py``): the
masked cross entropy and the chunked lm-head + cross entropy of the
training losses, the normal initialiser, the pre-norm transformer block of
GPT and ViT, the loop over stacked layers, and the converter of a JAX
parameter tree. Plain PyTorch: the products are ``torch.matmul`` (the JAX
package leaves them to XLA), LayerNorm and GELU are plain as there, and
attention goes through the port's flash op."""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import layer_norm
from ..ops.flash_attention import flash_attention
from ..ops.kernels.registry import KERNELS

__all__ = ["masked_cross_entropy", "fused_linear_cross_entropy",
           "normal_init", "prenorm_block", "run_layers", "gelu",
           "params_from_jax", "params_to"]


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


def normal_init(shape, generator, std: float = 0.02,
                dtype=torch.bfloat16, device=None):
    """Normal(0, ``std``) drawn in f32 from ``generator`` on ``device``,
    then cast to ``dtype`` (the JAX package's ``normal_init``; the numbers
    differ from ``jax.random``'s). A 3-D stack ``[L, ...]`` is drawn one
    layer at a time, so the f32 transient is one layer's slice."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for sl in (out if len(shape) == 3 else (out,)):
        sl.copy_(torch.randn(sl.shape, generator=generator, device=device,
                             dtype=torch.float32) * std)
    return out


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def prenorm_block(lp, x, *, num_heads, head_dim, eps, causal):
    """Pre-norm transformer block (GPT/ViT convention): LN -> QKV ->
    flash attention -> proj residual; LN -> GELU MLP residual. Layer
    params: ln1_w/b, qkv(+_b), proj(+_b), ln2_w/b, fc(+_b), fc_out(+_b);
    the f32 norm weights are cast to x's type inside the graph, as in the
    JAX package."""
    b, s, D = x.shape
    h = layer_norm(x, lp["ln1_w"].to(x.dtype), lp["ln1_b"].to(x.dtype), eps)
    qkv = h @ lp["qkv"] + lp["qkv_b"]
    q, k, v = (t.reshape(b, s, num_heads, head_dim)
               for t in qkv.chunk(3, dim=-1))
    attn = flash_attention(q, k, v, causal=causal).reshape(b, s, D)
    x = x + attn @ lp["proj"] + lp["proj_b"]
    h = layer_norm(x, lp["ln2_w"].to(x.dtype), lp["ln2_b"].to(x.dtype), eps)
    ff = gelu(h @ lp["fc"] + lp["fc_b"])
    return x + ff @ lp["fc_out"] + lp["fc_out_b"]


class _Pins(TorchDispatchMode):
    """The registry's ``pins`` (None: none) entered as a dispatch mode that
    passes every op through: under a fake-tensor trace (the program audit)
    ``checkpoint`` takes its two contexts only as dispatch modes."""

    def __init__(self, pins=None):
        super().__init__()
        self._pins, self._ctx = pins, None

    def __enter__(self):
        if self._pins is not None:
            self._ctx = KERNELS.pinned(self._pins)
            self._ctx.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _same_pins():
    """``checkpoint``'s contexts for the forward and the recomputation: the
    recomputation runs in the autograd engine's thread, so it re-enters
    the forward's registry pins there and dispatches as the forward did
    (the JAX package bakes the dispatch into the traced layer). Under a
    fake-tensor trace the same, as two pass-through dispatch modes, so that
    the audited graph holds the recomputation as the captured step does."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return _Pins(), _Pins(KERNELS.forced_state())
    return contextlib.nullcontext(), KERNELS.pinned(KERNELS.forced_state())


def run_layers(layers: Dict, x, body, remat: bool, *args):
    """``x`` through ``body(lp, x, *args)`` once per layer of the stacked
    ``[L, ...]`` weights ``layers`` (the JAX package's ``lax.scan``), each
    layer under ``torch.utils.checkpoint`` when ``remat``
    (``jax.checkpoint``)."""
    # unbind: one view per layer, whose backward stacks the L gradients
    # once (indexing the stack per layer would add L full-size zeros)
    stacks = {k: w.unbind(0) for k, w in layers.items()}
    for i in range(len(next(iter(stacks.values())))):
        lp = {k: w[i] for k, w in stacks.items()}
        if remat:
            x = checkpoint(body, lp, x, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=_same_pins)
        else:
            x = body(lp, x, *args)
    return x


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: reinterpret bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree, device=None) -> Dict:
    """A JAX parameter tree of any of the port's models (arrays or numpy
    arrays, nested dicts) as this package's tensors on ``device``. The
    layouts agree, so every leaf is a copy: same shape, same dtype, no
    transpose."""
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
