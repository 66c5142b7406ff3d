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

Their CUDA kernels (``linear_ce_*``, ``swiglu_*``,
``residual_rms_norm_fwd``, with ``rms_norm_bwd``) are not ported yet: each
op registers only its composition, for CPU metas. So on the card
``fused_train="auto"`` raises with the reason "not ported (fused-train
slice)", "pallas" raises everywhere, and "ref" runs the compositions on
the card, as the JAX package's ``fused_train="ref"`` runs them on the TPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.norms import rms_bwd_meta
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


def _plain_only(kernels):
    def supports(meta):
        if meta["device"] != "cpu":
            return False, (f"the {kernels} CUDA kernels are not ported "
                           "(fused-train slice); fused_train='ref' runs the "
                           "composition on the card")
        return True, "composition on the CPU"
    return supports


KERNELS.register("fused_linear_ce", "unfused", linear_ce_ref, priority=0,
                 supports=_plain_only("linear_ce_fwd/bwd_dx/bwd_dh"))
KERNELS.register("fused_swiglu", "unfused", swiglu_ref, priority=0,
                 supports=_plain_only("swiglu_fwd/bwd"))
KERNELS.register("rms_norm_residual", "unfused", residual_rms_norm_ref,
                 priority=0,
                 supports=_plain_only("residual_rms_norm_fwd + "
                                      "rms_norm_bwd"))


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
