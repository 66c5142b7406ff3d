"""The port's hand-written Hopper kernels, one module per TPU kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
note on what it replaces and what bounds it. A wrapper launches its
kernel for CUDA tensors and raises for anything else; it counts its
launches in a plain integer attribute, ``<wrapper>.launches``.
:data:`KERNELS` maps each TPU launch name to its wrapper.
"""
from .norms import rms_norm_fwd_triton, rms_norm_ref  # noqa: F401
from .paged_attention import (paged_attention_decode_cuda,  # noqa: F401
                              paged_attention_decode_ref)

KERNELS = {
    "paged_attention_decode": paged_attention_decode_cuda,
    "rms_norm_fwd": rms_norm_fwd_triton,
}


def reset_launches():
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launches():
    """``{launch name: count}`` for every kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}
