"""``dropout`` (port of ``paddle_tpu/nn/functional/common.py``'s).

The keep mask is a Bernoulli draw of ``1 - p`` from ``generator`` (or
torch's default generator), as the JAX package's is from its framework
RNG; the two draw different bits from one seed."""
from __future__ import annotations

import torch

__all__ = ["dropout"]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero elements of ``x`` with probability ``p``: scaled by
    ``1 / (1 - p)`` in training ("upscale_in_train"), or left as they are
    and ``x * (1 - p)`` at inference ("downscale_in_infer"). ``axis``
    draws one decision per index of the named axes, shared across the
    others."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.bernoulli(
        torch.full(shape, 1.0 - p, device=x.device),
        generator=generator).bool()
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)
