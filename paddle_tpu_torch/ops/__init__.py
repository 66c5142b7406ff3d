"""Op pack of the port (counterpart of ``paddle_tpu/ops/__init__.py``).

``rms_norm`` dispatches on where its input lies: a CUDA tensor goes to
the Triton kernel (``kernels/norms.py``), a CPU tensor to the plain
version ``rms_norm_ref``. There is no other switch and no fallback: a
kernel that fails raises.
"""
from __future__ import annotations

import torch.nn.functional as F

from .kernels.norms import rms_norm_fwd_triton, rms_norm_ref

__all__ = ["rms_norm", "rms_norm_ref", "swiglu"]


def rms_norm(x, weight, epsilon=1e-6):
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, epsilon)
    return rms_norm_fwd_triton(x, weight, epsilon)


def swiglu(a, b):
    return F.silu(a) * b
