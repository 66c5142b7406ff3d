"""paddle_tpu_torch.quantization: one-shot int8/int4 weight quantization
for serving (port of the PTQ half of ``paddle_tpu/quantization``).

:mod:`.quanters` holds the per-channel quantizers, the int4 packing and
the dequantize helpers; :mod:`.ptq` the harness that quantizes a LLaMA
tree. The QAT half (fake quanters, observers, ``QAT``/``PTQ`` model
wrappers) and ``int8_matmul`` are not ported yet.
"""
from . import ptq, quanters  # noqa: F401
from .ptq import (WQ_KEYS, activation_absmax, ensure_quantized,  # noqa: F401
                  normalize_weight_quant, quantize_leaf, quantize_weights,
                  weight_hbm_bytes, weight_quant_mode)
from .quanters import (dequantize_weight, maybe_dequantize,  # noqa: F401
                       pack_int4, quantize_to_int4, quantize_to_int8,
                       unpack_int4)

__all__ = ["ptq", "quanters", "WQ_KEYS", "activation_absmax",
           "ensure_quantized", "normalize_weight_quant", "quantize_leaf",
           "quantize_weights", "weight_hbm_bytes", "weight_quant_mode",
           "dequantize_weight", "maybe_dequantize", "pack_int4",
           "quantize_to_int4", "quantize_to_int8", "unpack_int4"]
