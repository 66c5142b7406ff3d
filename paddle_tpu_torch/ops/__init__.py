"""Op pack of the port (counterpart of ``paddle_tpu/ops/__init__.py``).

``rms_norm`` dispatches on where its input lies: a CUDA tensor goes to
the Triton kernel (``kernels/norms.py``), a CPU tensor to the plain
version ``rms_norm_ref``. There is no other switch and no fallback: a
kernel that fails raises. Where a gradient is needed it runs as
``kernels.norms.RMSNorm``, whose backward ``mode`` (the fused-train knob)
selects.

``layer_norm`` is ``layer_norm_ref`` on every device, as in the JAX
package, whose runtime routes never launch its LayerNorm kernel; the
port's counterpart, ``kernels.norms.layer_norm_fwd_triton``, is reached
through ``kernels.WRAPPERS``.

``fused_rotary_position_embedding`` is the JAX package's: the rotation of
:mod:`.rope` on each of q, k, v, plain, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.norms import (RMSNorm, layer_norm_ref, rms_norm_fwd_triton,
                           rms_norm_ref)
from .rope import apply_rope

__all__ = ["rms_norm", "rms_norm_ref", "layer_norm", "layer_norm_ref",
           "fused_rotary_position_embedding", "swiglu"]


def rms_norm(x, weight, epsilon=1e-6, mode=None):
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNorm.apply(x, weight, epsilon, mode)
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, epsilon)
    return rms_norm_fwd_triton(x, weight, epsilon)


def layer_norm(x, weight, bias, epsilon=1e-5):
    return layer_norm_ref(x, weight, bias, epsilon)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Paddle's ``incubate.nn.functional.fused_rotary_position_embedding``
    as the JAX package has it: :func:`.rope.apply_rope` on each of q, k, v
    that is given (layout [b, s, h, d]); a None stays None."""
    return tuple(None if t is None else apply_rope(
        t, sin, cos, position_ids, use_neox_rotary_style) for t in (q, k, v))


def swiglu(x, y=None):
    """``silu(x) * y``; with ``y`` None, ``x`` split in two halves on its
    last axis (gate, up), as the JAX package's ``swiglu``."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


from . import flash_attention, fused_train  # noqa: E402,F401
