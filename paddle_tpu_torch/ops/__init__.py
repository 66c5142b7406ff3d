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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.norms import (RMSNorm, layer_norm_ref, rms_norm_fwd_triton,
                           rms_norm_ref)

__all__ = ["rms_norm", "rms_norm_ref", "layer_norm", "layer_norm_ref",
           "swiglu"]


def rms_norm(x, weight, epsilon=1e-6, mode=None):
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNorm.apply(x, weight, epsilon, mode)
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, epsilon)
    return rms_norm_fwd_triton(x, weight, epsilon)


def layer_norm(x, weight, bias, epsilon=1e-5):
    return layer_norm_ref(x, weight, bias, epsilon)


def swiglu(a, b):
    return F.silu(a) * b


from . import flash_attention, fused_train  # noqa: E402,F401
