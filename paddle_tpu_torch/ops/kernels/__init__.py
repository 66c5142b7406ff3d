"""The port's hand-written Hopper kernels, one module per TPU kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
note on what it replaces and what bounds it. A wrapper launches its
kernel for CUDA tensors and raises for anything else; it counts its
launches in a plain integer attribute, ``<wrapper>.launches``.
:data:`WRAPPERS` maps each TPU launch name to its wrapper; the dispatch
registry of ops with several variants is :mod:`.registry`'s ``KERNELS``.
A wrapper whose kernel has classes also counts each launch in one store,
``<wrapper>.launches_by_class``, keyed by (family, class)
(``_launch.counted``, ``_launch.count``), read by
:func:`launches_by_class`. The families: "weight" for the four decode
and prefill block kernels, whose kernels take fp, int8 or int4 weights;
"pool" for the three of them that read the KV pools, which may be int8
(the int8 cache); "residual" for the three with a ``residual`` flag
(decode_attn_block, decode_mlp_block, prefill_attn_block): "full" for
``x + product``, "partial" for the product alone, which a
tensor-parallel shard's step launches (``inference/tp.py``); "body" for
the three flash wrappers (the optional bodies a launch runs, "bias",
"dbias", "seg", "dropout", "causal_sq_gt_sk" joined by commas, or
"plain"), for decode_mlp_block and prefill_attn_block (the body their
plan took: "tc", the tensor cores, chunk rows in bf16, or "cuda_core",
decode_mlp_block "ring" too) and for decode_attn_block and
decode_block_fused ("ring", their weight ring, or "cuda_core").
:func:`launches_by_weight`, :func:`launches_by_pool`,
:func:`launches_by_residual` and :func:`launches_by_body` are one family
each of that store, as are the wrappers' ``launches_by_<family>`` views.
Only a launch counts: a wrapper given CPU tensors raises before it, and
the CPU routes run the plain versions, which count nothing. A program
that replays launches made once (the serving engine's CUDA graph of its
decode step) counts them apart while it captures them
(:func:`launches_apart`) and adds them back at each replay
(:func:`add_launches`).

Every wrapper builds its launch's plan, a ``_launch.KernelLaunchSpec``, and
passes it to ``_launch.begin`` right before the launch; under
``_launch.capture_kernel_launches`` the specs are recorded (and over meta
tensors nothing is launched or counted), which the kernel-geometry gate
(:mod:`paddle_tpu_torch.analysis`) audits. :data:`DEMO_WRAPPERS` holds the
gate's regression specimen, ``demo_prefix_mlp_block``: decode_mlp_block's
kernel under a floor-divided plan that drops the last intermediate
columns. It is no part of :data:`WRAPPERS` and no route or dispatch
reaches it.
"""
import contextlib

from .flash_attention import (flash_bwd_dkv_cuda,  # noqa: F401
                              flash_bwd_dq_cuda, flash_fwd_cuda)
from .fused_adamw import fused_adamw_triton  # noqa: F401
from .fused_decode_block import (attn_block_ref,  # noqa: F401
                                 attn_block_wq_ref, decode_attn_block_cuda,
                                 decode_block_fused_cuda, decode_block_ref,
                                 decode_mlp_block_cuda,
                                 demo_prefix_mlp_block_cuda,
                                 demo_prefix_mlp_block_ref, mlp_block_ref,
                                 mlp_block_wq_ref)
from .fused_train import (linear_ce_bwd_dh_cuda,  # noqa: F401
                          linear_ce_bwd_dx_cuda, linear_ce_fwd_cuda,
                          swiglu_bwd_triton, swiglu_fwd_triton)
from .fused_prefill_block import (prefill_attn_block_cuda,  # noqa: F401
                                  prefill_attn_block_ref,
                                  prefill_attn_block_wq_ref)
from .norms import (layer_norm_fwd_triton,  # noqa: F401
                    layer_norm_ref, residual_rms_norm_fwd_triton,
                    rms_norm_bwd_triton, rms_norm_fwd_triton, rms_norm_ref)
from .paged_attention import (paged_attention_decode_cuda,  # noqa: F401
                              paged_attention_decode_ref)

WRAPPERS = {
    "paged_attention_decode": paged_attention_decode_cuda,
    "rms_norm_fwd": rms_norm_fwd_triton,
    "layer_norm_fwd": layer_norm_fwd_triton,
    "decode_attn_block": decode_attn_block_cuda,
    "decode_mlp_block": decode_mlp_block_cuda,
    "decode_block_fused": decode_block_fused_cuda,
    "prefill_attn_block": prefill_attn_block_cuda,
    "flash_attention_fwd": flash_fwd_cuda,
    "flash_attention_bwd_dq": flash_bwd_dq_cuda,
    "flash_attention_bwd_dkv": flash_bwd_dkv_cuda,
    "fused_adamw": fused_adamw_triton,
    "rms_norm_bwd": rms_norm_bwd_triton,
    "residual_rms_norm_fwd": residual_rms_norm_fwd_triton,
    "swiglu_fwd": swiglu_fwd_triton,
    "swiglu_bwd": swiglu_bwd_triton,
    "linear_ce_fwd": linear_ce_fwd_cuda,
    "linear_ce_bwd_dx": linear_ce_bwd_dx_cuda,
    "linear_ce_bwd_dh": linear_ce_bwd_dh_cuda,
}

#: the kernel-geometry gate's regression specimen (not a runtime kernel)
DEMO_WRAPPERS = {"demo_prefix_mlp_block": demo_prefix_mlp_block_cuda}


def _counted_wrappers():
    return list(WRAPPERS.items()) + list(DEMO_WRAPPERS.items())


def reset_launches():
    """Set every wrapper's launch counts to 0 (the specimen's too)."""
    for _, fn in _counted_wrappers():
        fn.launches = 0
        for k in fn.launches_by_class:
            fn.launches_by_class[k] = 0


def launches():
    """``{launch name: count}`` for every kernel."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launches_by_class():
    """``{launch name: {(family, class): count}}`` for every kernel (empty
    for a kernel without classes): the one store of the by-class counts."""
    return {name: dict(fn.launches_by_class)
            for name, fn in WRAPPERS.items()}


def _family(family):
    return {name: dict(getattr(fn, f"launches_by_{family}"))
            for name, fn in WRAPPERS.items()
            if hasattr(fn, f"launches_by_{family}")}


def launches_by_weight():
    """``{launch name: {"fp"|"int8"|"int4": count}}`` for the kernels that
    take quantized weights."""
    return _family("weight")


def launches_by_pool():
    """``{launch name: {"fp"|"int8": count}}`` for the kernels that read
    the KV pools."""
    return _family("pool")


def launches_by_residual():
    """``{launch name: {"full"|"partial": count}}`` for the kernels with a
    ``residual`` flag."""
    return _family("residual")


def launches_by_body():
    """``{launch name: {body class: count}}`` for the flash kernels (the
    classes launched since the last reset, some perhaps at 0), for
    decode_mlp_block and prefill_attn_block ("tc", "cuda_core";
    decode_mlp_block "ring" too) and for decode_attn_block and
    decode_block_fused ("ring", "cuda_core")."""
    return _family("body")


def _counts():
    return {name: (fn.launches, dict(fn.launches_by_class))
            for name, fn in _counted_wrappers()}


def add_launches(delta, times=1):
    """Add ``times`` x ``delta`` (``{launch name: (launches, {(family,
    class): count})}``, as :func:`launches_apart` records it) to the
    wrappers' counts: the launches a replayed program made without
    running its wrappers."""
    wrappers = dict(_counted_wrappers())
    for name, (n, by) in delta.items():
        fn = wrappers[name]
        fn.launches += times * n
        for k, v in by.items():
            fn.launches_by_class[k] = fn.launches_by_class.get(k, 0) \
                + times * v


@contextlib.contextmanager
def launches_apart():
    """Count the launches the block makes apart from the wrappers'
    counts: yields a dict that, when the block ends, holds what it
    launched (``{launch name: (launches, {(family, class): count})}``,
    wrappers that launched nothing left out), which is taken back out of
    the counts, so that the block itself counts nothing."""
    before = _counts()
    delta = {}
    try:
        yield delta
    finally:
        for name, (n, by) in _counts().items():
            n0, by0 = before[name]
            d = {k: v - by0.get(k, 0) for k, v in by.items()
                 if v != by0.get(k, 0)}
            if n != n0 or d:
                delta[name] = (n - n0, d)
        add_launches(delta, times=-1)
