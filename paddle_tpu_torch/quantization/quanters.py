"""Real int8/int4 weight quantizers (port of the serving half of
``paddle_tpu/quantization/quanters.py``).

Per-output-channel symmetric quantization with FLAT f32 scales (no zero
point), so ``dequant(q) = q * scale`` and the fused kernels can apply the
scale in their product's epilogue: ``x @ (q * s) == (x @ q) * s``. Packed
int4 stores two values a byte along one axis, HALVES and not interleaved
pairs: the first half of the axis in the low nibble, the second half in
the high nibble (``byte = (hi << 4) | (lo & 0xF)``).

Everything here runs on the tensors' own device, in the same f32 and
integer arithmetic as the JAX package's numpy code (f32 division, round
half to even), so the integers and scales it makes are byte-identical to
the JAX package's. The QAT pieces (``fake_quant``,
``FakeQuanterWithAbsMax``, the observers) and ``int8_matmul`` are not
ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_to_int8", "quantize_to_int4", "pack_int4",
           "unpack_int4", "dequantize_weight", "maybe_dequantize"]


def _true_div(a: torch.Tensor, q: float) -> torch.Tensor:
    """``a / q`` correctly rounded on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which rounds
    differently from numpy's division; a tensor divisor divides."""
    return a / torch.full_like(a, q)


def _channel_quantize(v: torch.Tensor, axis: int, qmax: float):
    """Symmetric per-channel quantizer body: FLAT f32 scales along
    ``axis`` and integers in [-qmax, qmax]. -> (q int8, scale f32)."""
    v = v.float()
    ax = axis % v.dim()
    reduce_dims = tuple(i for i in range(v.dim()) if i != ax)
    absmax = v.abs().amax(dim=reduce_dims)
    scale = _true_div(absmax.clamp_min(1e-8), qmax)
    sb = scale.reshape([-1 if i == ax else 1 for i in range(v.dim())])
    q = torch.round(v / sb).clamp_(-qmax, qmax).to(torch.int8)
    return q, scale


def quantize_to_int8(w, axis: int = -1):
    """Per-channel int8 quantization -> (q int8 in [-127, 127], scale f32
    flat along ``axis``)."""
    return _channel_quantize(w, axis, 127.0)


def quantize_to_int4(w, axis: int = -1):
    """Per-channel int4 quantization -> (q int8 in [-7, 7], unpacked;
    scale f32 flat along ``axis``). :func:`pack_int4` packs it."""
    return _channel_quantize(w, axis, 7.0)


def pack_int4(q, axis: int = 0) -> torch.Tensor:
    """Pack int4 values (int8 in [-8, 7]) two a byte along ``axis``: the
    first half of the axis in the low nibble, the second in the high
    nibble. The axis length must be even."""
    v = q.to(torch.int32)
    ax = axis % v.dim()
    n = v.shape[ax]
    if n % 2:
        raise ValueError(f"pack_int4: axis {ax} length {n} is odd — "
                         "int4 packing pairs the two axis halves")
    lo, hi = torch.split(v, n // 2, dim=ax)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(packed, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: both nibbles sign-extended, the halves
    concatenated back along ``axis`` -> int8."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=axis).to(torch.int8)


def _pack_axis(q, scale) -> int:
    """The axis an int4 leaf is packed along, from its byte count against
    the scale length: the output axis (last) when it was halved, else the
    contraction axis (second to last)."""
    return -1 if q.shape[-1] * 2 == scale.shape[-1] else -2


def dequantize_weight(w: dict, dtype=None) -> torch.Tensor:
    """One quantized leaf ``{"qw8"|"qw4": q, "scale": s}`` as a dense
    tensor: ``q * s`` in f32, cast to ``dtype`` when given. The scale is
    per output channel (the last axis); an int4 leaf's pack axis comes
    from :func:`_pack_axis`. The dequantize-then-matmul building block of
    every unfused product."""
    scale = w["scale"].float()
    if "qw4" in w:
        q = unpack_int4(w["qw4"], axis=_pack_axis(w["qw4"], scale))
    else:
        q = w["qw8"]
    deq = q.float() * scale[..., None, :]
    return deq if dtype is None else deq.to(dtype)


def maybe_dequantize(w, dtype):
    """Plain tensors pass through; quantized leaves dequantize to
    ``dtype``. The one helper every unfused product uses, so that route is
    dequantize-then-matmul everywhere."""
    return dequantize_weight(w, dtype) if isinstance(w, dict) else w
