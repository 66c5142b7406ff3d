"""The fused training path's ops, registry-dispatched (port of the op
wrappers of ``paddle_tpu/ops/pallas/fused_train.py`` and of
``paddle_tpu/ops/pallas/norms.py``'s residual epilogue).

Each op resolves through the fused-train mode contract
(:func:`.kernels.registry.dispatch_fused_variant`): "auto" dispatches,
"ref" pins the composition, "pallas" pins the kernels.

- ``fused_linear_ce``: chunked lm-head + cross entropy
  (:func:`linear_ce_ref`, the scan composition of
  ``models/_common.fused_linear_cross_entropy``);
- ``fused_swiglu``: ``silu(gate) * up`` (:func:`swiglu_ref`);
- ``rms_norm_residual``: ``y = x + delta``, ``h = rms_norm(y) * w``
  (:func:`residual_rms_norm_ref`; the norm's backward follows the same
  mode).

Each op has two variants. ``"cuda_fused"`` is the JAX package's fused
route through the hand-written kernels: :class:`.kernels.fused_train.LinearCE`
(``linear_ce_fwd``, ``linear_ce_bwd_dx``, ``linear_ce_bwd_dh``),
:class:`.kernels.fused_train.SwiGLU` (``swiglu_fwd``, ``swiglu_bwd``) and
:class:`.kernels.norms.ResidualRMSNorm` (``residual_rms_norm_fwd``, with
``rms_norm_bwd`` behind it). Its ``supports`` takes CUDA f32/bf16 metas
within the kernels' limits and says why it refuses any other. ``"unfused"``
is the composition, priority 0, for CPU metas. So "auto" runs the kernels
on the card and the compositions on the CPU (as the JAX package runs its
compositions in interpret mode); a CUDA meta the kernels refuse raises
with their reason, the composition never standing in on the card;
"pallas" pins the kernels (on the CPU their Functions run the plain
versions) and "ref" the compositions, on either device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.fused_train import LinearCE, SwiGLU
from .kernels.norms import (ResidualRMSNorm, rms_bwd_meta, supports_cuda,
                            supports_plain)
from .kernels.registry import KERNELS, dispatch_fused_variant

__all__ = ["linear_ce_ref", "swiglu_ref", "residual_rms_norm_ref",
           "fused_linear_ce", "fused_swiglu", "residual_rms_norm",
           "ce_meta", "swiglu_meta"]


def linear_ce_ref(hidden, head, labels):
    """The chunked composition (``models/_common.py``)."""
    from ..models._common import fused_linear_cross_entropy
    return fused_linear_cross_entropy(hidden, head, labels)


def swiglu_ref(gate, up):
    return F.silu(gate) * up


def residual_rms_norm_ref(delta, x, weight, epsilon=1e-6, mode=None):
    """Plain add, then ``ops.rms_norm`` (the Triton forward on CUDA);
    ``mode`` reaches the norm's backward."""
    from . import rms_norm
    y = x + delta
    return y, rms_norm(y, weight, epsilon, mode=mode)


def ce_meta(T, D, V, dtype, device) -> dict:
    return {"T": int(T), "D": int(D), "V": int(V), "dtype": str(dtype),
            "device": torch.device(device).type}


def swiglu_meta(R, F_, dtype, device) -> dict:
    return {"R": int(R), "F": int(F_), "dtype": str(dtype),
            "device": torch.device(device).type}


def _residual_rms_norm_fused(delta, x, weight, epsilon=1e-6, mode=None):
    return ResidualRMSNorm.apply(delta, x, weight, epsilon, mode)


# linear_ce's shared memory is fixed (34 KB fwd, 103 KB dx, 106 KB dh, all
# under the H100's 227 KB a block) and its loops take any D, T and V
KERNELS.register("fused_linear_ce", "cuda_fused", LinearCE.apply,
                 priority=10, supports=supports_cuda(
                     "the linear_ce_fwd/bwd_dx/bwd_dh CUDA kernels"))
KERNELS.register("fused_linear_ce", "unfused", linear_ce_ref, priority=0,
                 supports=supports_plain)
KERNELS.register("fused_swiglu", "cuda_fused", SwiGLU.apply, priority=10,
                 supports=supports_cuda("the swiglu_fwd/bwd Triton kernels"))
KERNELS.register("fused_swiglu", "unfused", swiglu_ref, priority=0,
                 supports=supports_plain)
KERNELS.register("rms_norm_residual", "cuda_fused",
                 _residual_rms_norm_fused, priority=10, supports=supports_cuda(
                     "the residual_rms_norm_fwd and rms_norm_bwd Triton "
                     "kernels", "d"))
KERNELS.register("rms_norm_residual", "unfused", residual_rms_norm_ref,
                 priority=0, supports=supports_plain)
# the JAX declarations, with ``device`` for ``interpret`` (the shared
# memory of these kernels is fixed, so no budget keys them)
KERNELS.declare_cache_key("fused_linear_ce", ("T", "D", "V", "dtype",
                                              "device"))
KERNELS.declare_cache_key("fused_swiglu", ("R", "F", "dtype", "device"))
KERNELS.declare_cache_key("rms_norm_residual", ("rows", "d", "dtype",
                                                "device"))


def _rows(t):
    return t.numel() // t.shape[-1] if t.shape[-1] else 0


def fused_linear_ce(hidden, head, labels, mode=None):
    """Chunked lm-head + cross entropy: the f32 mean over labels >= 0 of
    ``logsumexp(hidden @ head) - (hidden @ head)[label]``."""
    fn = dispatch_fused_variant(
        "fused_linear_ce",
        ce_meta(_rows(hidden), hidden.shape[-1], head.shape[1],
                hidden.dtype, hidden.device), mode)
    return fn(hidden, head, labels)


def fused_swiglu(gate, up, mode=None):
    fn = dispatch_fused_variant(
        "fused_swiglu",
        swiglu_meta(_rows(gate), gate.shape[-1], gate.dtype, gate.device),
        mode)
    return fn(gate, up)


def residual_rms_norm(delta, x, weight, epsilon=1e-6, mode=None):
    """Residual add + RMSNorm epilogue: ``(y, h)``."""
    fn = dispatch_fused_variant(
        "rms_norm_residual",
        rms_bwd_meta(_rows(x), x.shape[-1], x.dtype, x.device), mode)
    return fn(delta, x, weight, epsilon, mode=mode)
