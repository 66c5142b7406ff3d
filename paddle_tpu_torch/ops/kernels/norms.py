"""RMSNorm forward: the Triton kernel's wrapper and its plain PyTorch
version.

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

Triton is imported when the kernel is first launched, never at import:
the CPU tests import this module where Triton is absent.
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm_ref", "rms_norm_fwd_triton"]

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
