"""Fused AdamW over flat buffers: the Triton kernel's wrapper, its plain
PyTorch version and the registry-dispatched ``adamw_update`` (port of
``paddle_tpu/ops/pallas/fused_adamw.py``).

Replaces ``fused_adamw`` (kernel ``_adamw_kernel``, launch
``fused_adamw``): one pass over the flattened concatenation of every
parameter updates the f32 master, both moments (stored f32 or bf16) and,
optionally, writes the updated parameter in a low-precision shadow type.
The update runs in f32: the gradient is scaled by ``grad_scale`` (the
clip factor) inside the kernel, and the bias corrections ``1 / (1 -
beta^t)`` are computed outside it, in f32 on the device, as the JAX
package passes them in. The learning rate is read from device memory too
(the TPU kernel's ``lr_ref[0]``), a fourth word beside them: ``lr`` may
be a Python float or an f32 tensor on the device (the trainer's lr word),
so a captured step reads the value its caller wrote before each replay.

What bounds it on the H100: memory. Nothing is reused, so a parameter
costs its bytes once: at the training phase's layout (f32 master read and
written, f32 grad read, bf16 moments read and written, bf16 shadow
written) 22 bytes. Design: one Triton program per 1024 elements with
masked loads and stores (coalesced 16-byte accesses; a ragged tail needs
no padding), f32 arithmetic in the JAX kernel's op order with
floating-point contraction off and correctly rounded division and square
root, so the kernel matches :func:`adamw_update_ref` bit for bit where
the card's float arithmetic allows.

The JAX call aliases param and moments to its outputs; here ``param``,
``moment1`` and ``moment2`` are updated IN PLACE by both the kernel and
the plain version, and returned (with the shadow, when asked for).

Triton is imported when the kernel is first launched, never at import.
"""
from __future__ import annotations

import functools

import torch

from . import _launch
from ._build import DTYPES
from .registry import KERNELS

__all__ = ["adamw_update_ref", "fused_adamw_triton", "adamw_meta",
           "adamw_update", "bias_corrections", "BLOCK"]

BLOCK = 1024
_SOURCE = "paddle_tpu_torch/ops/kernels/fused_adamw.py"
_kernels = {}
tl = None          # triton.language, bound by triton_jit at the first launch


def _f32(x, device) -> torch.Tensor:
    """``x`` as an f32 0-d tensor on ``device``: a tensor converted there,
    a number written by a fill (no copy from the host, which would wait
    for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def bias_corrections(step, beta1, beta2, grad_scale, device, lr):
    """[1/(1-beta1^t), 1/(1-beta2^t), grad_scale, lr] as an f32 tensor on
    ``device``, computed in f32 as the JAX package computes them (``lr``
    a float, or an f32 tensor read on the device)."""
    f32 = torch.float32
    t = _f32(step, device)
    scale = _f32(1.0 if grad_scale is None else grad_scale, device)
    lr32 = _f32(lr, device)
    b1 = torch.full((), beta1, dtype=f32, device=device)
    b2 = torch.full((), beta2, dtype=f32, device=device)
    return torch.stack([1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t),
                        scale, lr32])


def adamw_update_ref(param, grad, moment1, moment2, lr, step, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, weight_decay=0.01,
                     grad_scale=None, shadow_dtype=None):
    """The plain version, op for op the JAX ``adamw_update_ref``: f32
    interior, moments stored back in their own type; ``lr`` read from the
    same f32 word as the kernel's. Updates ``param``, ``moment1`` and
    ``moment2`` in place; returns them (and the shadow)."""
    f32 = torch.float32
    bc = bias_corrections(step, beta1, beta2, grad_scale, param.device, lr)
    lr32 = bc[3]
    p = param.to(f32)
    g = grad.to(f32) * bc[2]
    m = moment1.to(f32)
    v = moment2.to(f32)
    m_n = beta1 * m + (1 - beta1) * g
    v_n = beta2 * v + (1 - beta2) * g * g
    mhat = m_n * bc[0]
    vhat = v_n * bc[1]
    p_n = p * (1.0 - lr32 * weight_decay) \
        - lr32 * mhat / (torch.sqrt(vhat) + epsilon)
    param.copy_(p_n)
    moment1.copy_(m_n)
    moment2.copy_(v_n)
    out = [param, moment1, moment2]
    if shadow_dtype is not None:
        out.append(p_n.to(shadow_dtype))
    return out


def _adamw_kernel(p_ptr, g_ptr, m_ptr, v_ptr, s_ptr, bc_ptr, n, wd, b1,
                  omb1, b2, omb2, eps, BLOCK: "tl.constexpr",
                  SHADOW: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    bc0 = tl.load(bc_ptr)
    bc1 = tl.load(bc_ptr + 1)
    scale = tl.load(bc_ptr + 2)
    lr = tl.load(bc_ptr + 3)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) * scale
    m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    m_n = b1 * m + omb1 * g
    v_n = b2 * v + omb2 * g * g
    mhat = m_n * bc0
    vhat = v_n * bc1
    p_n = p * (1.0 - lr * wd) - tl.div_rn(lr * mhat, tl.sqrt_rn(vhat) + eps)
    tl.store(p_ptr + offs, p_n.to(p_ptr.dtype.element_ty), mask=mask)
    tl.store(m_ptr + offs, m_n.to(m_ptr.dtype.element_ty), mask=mask)
    tl.store(v_ptr + offs, v_n.to(v_ptr.dtype.element_ty), mask=mask)
    if SHADOW:
        tl.store(s_ptr + offs, p_n.to(s_ptr.dtype.element_ty), mask=mask)


def fused_adamw_triton(param, grad, moment1, moment2, lr, step, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, weight_decay=0.01,
                       grad_scale=None, shadow_dtype=None):
    """Launch the Triton kernel over flat 1-D CUDA buffers (same contract
    as :func:`adamw_update_ref`: param, moment1 and moment2 updated in
    place and returned, plus the shadow). ``param`` is f32; the grad and
    the moments f32 or bf16; ``lr`` a float or an f32 tensor on param's
    device (read by the kernel). Raises for anything else; never falls
    back."""
    n = param.numel()
    _launch.check_device("fused_adamw_triton", param.device)
    if param.dtype != torch.float32:
        raise TypeError(f"param (the master) must be float32, got "
                        f"{param.dtype}")
    for name, t in (("grad", grad), ("moment1", moment1),
                    ("moment2", moment2)):
        if t.device != param.device or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous() or t.dtype not in DTYPES:
            raise ValueError(f"{name} must be a contiguous 1-D float32 or "
                             f"bfloat16 [{n}] on {param.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if param.dim() != 1 or not param.is_contiguous():
        raise ValueError("param must be a contiguous 1-D tensor")
    if isinstance(lr, torch.Tensor) and (
            lr.dtype != torch.float32 or lr.numel() != 1
            or lr.device != param.device):
        raise ValueError(f"lr must be a float or one float32 element on "
                         f"{param.device}, got {tuple(lr.shape)} {lr.dtype} "
                         f"on {lr.device}")
    if shadow_dtype is not None and shadow_dtype not in DTYPES:
        raise TypeError(f"shadow_dtype must be float32 or bfloat16, got "
                        f"{shadow_dtype}")
    bc = bias_corrections(step, beta1, beta2, grad_scale, param.device, lr)
    shadow = (torch.empty(n, dtype=shadow_dtype, device=param.device)
              if shadow_dtype is not None else None)
    if n:
        spec = adamw_spec(n, *(_launch.dtype_name(t.dtype) for t in
                               (grad, moment1, moment2)),
                          None if shadow is None
                          else _launch.dtype_name(shadow_dtype))
        if _launch.begin(spec, param.device, (grad, bc),
                         (param, moment1, moment2, shadow)):
            with torch.cuda.device(param.device):
                fused_adamw_triton.launches += 1
                _launch.triton_run(globals(), spec, [(
                    param, grad, moment1, moment2,
                    shadow if shadow is not None else param, bc, n,
                    float(weight_decay), float(beta1),
                    float(1 - beta1), float(beta2), float(1 - beta2),
                    float(epsilon))], enable_fp_fusion=False)
    out = [param, moment1, moment2]
    if shadow is not None:
        out.append(shadow)
    return out


_launch.counted(fused_adamw_triton)


@functools.lru_cache(maxsize=64)
def adamw_spec(n, grad_dt, m_dt, v_dt, shadow_dt):
    """One program per ``BLOCK`` elements of the flat buffers: reads the
    f32 master, the grad and the moments, writes the master and the
    moments back (in place) and the shadow, each tile once; every program
    reads the four f32 words of ``bias_corrections`` (the two
    corrections, the clip scale and lr)."""
    op = _launch.KernelOperand
    ins = (op("param", (n,), "float32"), op("grad", (n,), grad_dt),
           op("moment1", (n,), m_dt), op("moment2", (n,), v_dt),
           op("bias_corrections", (4,), "float32"))
    outs = [op("param_out", (n,), "float32"), op("moment1_out", (n,), m_dt),
            op("moment2_out", (n,), v_dt)]
    if shadow_dt is not None:
        outs.append(op("shadow", (n,), shadow_dt))
    progs = -(-n // BLOCK)
    phase = _launch.KernelPhase(
        "elements", progs,
        tuple(_launch.flat_access(o, BLOCK) for o in ins[:4])
        + (_launch.whole(ins[4]),),
        tuple(_launch.flat_access(o, BLOCK) for o in outs))
    return _launch.triton_spec(
        "fused_adamw", _SOURCE, "float32", (phase,), ins, outs,
        (("_adamw_kernel", 13, (progs,),
          {"BLOCK": BLOCK, "SHADOW": shadow_dt is not None}, 4),))


def adamw_meta(n, dtype, moment_dtype, shadow, device) -> dict:
    """Static dispatch metadata for one fused-AdamW call site."""
    return {"n": int(n), "dtype": str(dtype),
            "moment_dtype": str(moment_dtype), "shadow": bool(shadow),
            "device": torch.device(device).type}


def _supports_triton(meta):
    if meta["device"] != "cuda":
        return False, "the Triton kernel takes CUDA tensors"
    if meta["dtype"] != "torch.float32":
        return False, "the kernel updates an f32 master"
    return True, "flat multi-tensor: any length"


def _supports_plain(meta):
    if meta["device"] != "cpu":
        return False, ("the plain version is the CPU's route; on the card "
                       "the kernel runs or the call raises")
    return True, "plain version on the CPU"


KERNELS.register("fused_adamw", "cuda", fused_adamw_triton, priority=10,
                 supports=_supports_triton)
KERNELS.register("fused_adamw", "unfused", adamw_update_ref, priority=0,
                 supports=_supports_plain)
# the keys of one call site's update, all fixed by its flat buffers (the
# JAX trainer's program key, with ``device`` for ``interpret``)
KERNELS.declare_cache_key(
    "fused_adamw", ("n", "dtype", "moment_dtype", "shadow", "device"))


def adamw_update(param, grad, moment1, moment2, lr, step, **kw):
    """Fused-AdamW update, registry-dispatched: the Triton kernel for
    CUDA buffers, the plain version for CPU ones; ``KERNELS.force`` pins
    a variant. Updates in place (see the module docstring)."""
    _, fn = KERNELS.dispatch(
        "fused_adamw",
        adamw_meta(param.shape[0], param.dtype, moment1.dtype,
                   kw.get("shadow_dtype") is not None, param.device))
    return fn(param, grad, moment1, moment2, lr, step, **kw)
