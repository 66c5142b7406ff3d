"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``):
the attention functions, whose fused routes run the flash kernels, and
``dropout``. They take and return torch tensors."""
from .attention import (flash_attention, flash_attn_qkvpacked,  # noqa: F401
                        flash_attn_unpadded, flash_attn_varlen_qkvpacked,
                        flashmask_attention, scaled_dot_product_attention,
                        sequence_mask, sparse_attention)
from .common import dropout  # noqa: F401

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "flashmask_attention",
           "sequence_mask", "sparse_attention", "dropout"]
