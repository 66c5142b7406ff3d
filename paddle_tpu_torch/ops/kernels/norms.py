"""RMSNorm: the forward Triton kernel's wrapper, its plain PyTorch version,
and the differentiable op the training path runs.

Replaces ``paddle_tpu/ops/pallas/norms.py``'s ``_rms_fwd_kernel``
(launch ``rms_norm_fwd``, reached through ``rms_norm_pallas``): each row
of ``x [..., D]`` is scaled by the reciprocal root of its mean square,
computed in f32, cast to x's type, then multiplied by the weight (already
in x's type at every call site) -- the rounding order of
:func:`rms_norm_ref`, so kernel and plain version agree to one ulp of
x's type.

What bounds it on the H100: memory, ``rows * D * itemsize * 2 + D *
itemsize`` bytes. At decode shapes (8 x 4096) that is well under a
microsecond of traffic, so the launch itself dominates; nothing is tuned
for that here. Design: one program per row with ``BLOCK =
next_pow2(D)``, so a 4096-wide row is one block held in registers, read
once and written once.

Training: :class:`RMSNorm` is the JAX package's ``rms_norm_pallas``
custom_vjp. Its forward is the kernel on CUDA (the plain version on the
CPU); its backward is the op ``"rms_norm_bwd"``, resolved through the
fused-train mode when the forward runs: the JAX package resolves it at
trace time, and the caller's thread holds the registry pins, which the
autograd engine's thread does not see. :func:`rms_bwd_ref`
(``_rms_bwd_ref``: f32 interior, ``dw`` summed over rows and cast to the
weight's type) is its only variant until the fused-train slice ports the
``rms_norm_bwd`` kernel, so mode "ref" pins it and "auto" raises on CUDA
with that reason.

Triton is imported when the kernel is first launched, never at import:
the CPU tests import this module where Triton is absent.
"""
from __future__ import annotations

import torch

from .registry import KERNELS, dispatch_fused_variant

__all__ = ["rms_norm_ref", "rms_norm_fwd_triton", "rms_bwd_ref",
           "rms_bwd_meta", "RMSNorm"]

_kernel = None
tl = None          # triton.language, bound by _jit() at the first launch


def rms_norm_ref(x, weight, epsilon=1e-6):
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype) * weight


def _rms_fwd_kernel(x_ptr, w_ptr, y_ptr, D, eps, BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0)
    xf = x.to(tl.float32)
    ms = tl.sum(xf * xf, axis=0) / D
    y = (xf * tl.rsqrt(ms + eps)).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    tl.store(y_ptr + row * D + cols, y * w, mask=mask)


def _jit():
    global _kernel, tl
    if _kernel is None:
        import triton
        import triton.language as tl
        _kernel = triton.jit(_rms_fwd_kernel)
    return _kernel


def rms_norm_fwd_triton(x, weight, epsilon=1e-6):
    """Launch the Triton kernel over the rows of ``x``. CUDA tensors
    only; raises for anything the kernel does not take. Never falls
    back."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_fwd_triton needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    D = x.shape[-1]
    if weight.dtype != x.dtype or tuple(weight.shape) != (D,) \
            or weight.device != x.device:
        raise ValueError(f"weight must be [{D}] {x.dtype} on {x.device}, "
                         f"got {tuple(weight.shape)} {weight.dtype} on "
                         f"{weight.device}")
    import triton
    x2 = x.reshape(-1, D).contiguous()
    w = weight.contiguous()
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        block = triton.next_power_of_2(D)
        kernel = _jit()
        with torch.cuda.device(x.device):
            rms_norm_fwd_triton.launches += 1
            kernel[(rows,)](x2, w, y, D, float(epsilon), BLOCK=block,
                            num_warps=8 if block >= 2048 else 4)
    return y.reshape(x.shape)


rms_norm_fwd_triton.launches = 0


def rms_bwd_ref(epsilon, res, g):
    """The JAX package's ``_rms_bwd_ref``: (dx in x's type, dw in the
    weight's type) from the saved ``res = (x, weight)`` and the output's
    cotangent ``g``, all in f32 inside."""
    x, weight = res
    xf, gf, wf = x.float(), g.float(), weight.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + epsilon)
    xhat = xf * inv
    dw = torch.sum(gf * xhat, dim=tuple(range(x.dim() - 1))).to(
        weight.dtype)
    gw = gf * wf
    dx = inv * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw


def rms_bwd_meta(rows, d, dtype, device) -> dict:
    return {"rows": int(rows), "d": int(d), "dtype": str(dtype),
            "device": torch.device(device).type}


def _supports_plain(meta):
    if meta["device"] != "cpu":
        return False, ("rms_norm_bwd's CUDA kernel is not ported "
                       "(fused-train slice); the composition runs on the "
                       "CPU, or on the card when fused_train='ref' pins it")
    return True, "composition on the CPU"


KERNELS.register("rms_norm_bwd", "unfused", rms_bwd_ref, priority=0,
                 supports=_supports_plain)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with the JAX package's custom backward. ``mode`` (the
    fused-train knob) picks the backward variant when the forward runs."""

    @staticmethod
    def forward(ctx, x, weight, epsilon, mode):
        ctx.bwd = dispatch_fused_variant(
            "rms_norm_bwd",
            rms_bwd_meta(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                         x.device), mode)
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        if x.device.type == "cpu":
            return rms_norm_ref(x, weight, epsilon)
        return rms_norm_fwd_triton(x, weight, epsilon)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = ctx.bwd(ctx.epsilon, (x, weight), g)
        return dx, dw, None, None
