"""The kernel catalog of the port's geometry gate (port of
``paddle_tpu/analysis/kernel_catalog.py``).

Every launch the port ships, captured at two shape classes: ``tiny`` (the
shapes the CPU tests run; the JAX catalog's tiny cases, where the port's
kernels take them) and ``flagship``: the LLaMA-7B serving shapes (D 4096,
H = KV = 32, hd 128, F 11008, 8 slots, 16-token pages, 72 of them a
sequence, 128-row prefill chunks at position 512) and the "1.07B-h4096"
training rung (batch 2 x 2048 tokens at 7B widths, vocab 32000) of
``PERF.md`` section 4, in the weight (int8, int4), pool (int8) and
tensor-parallel shard (``residual=False``) classes where the launch has
them. Capturing calls each wrapper over meta tensors under
:class:`~paddle_tpu_torch.ops.kernels._launch.capture_kernel_launches`:
no card, no compute, nothing counted; a flagship grid is the H100's (132
SMs times the kernel's blocks an SM).

Each case declares the launch names it must capture; one that stops
capturing a declared kernel is a ``COVERAGE_GAP`` finding, so the gate
cannot shrink silently. :data:`ALL_KERNEL_NAMES` (the 18 launches, the
JAX set) is the union of those declarations.

:data:`FLOP_FORMULAS` copies the JAX package's per-launch FLOP model,
read off the port's spec (:func:`modeled_flops`, the full-table model,
equal to the JAX catalog's at the cases the two share);
:func:`needed_flops` counts what one launch's data needs (causal pairs,
pairs of one segment, live lengths), the operations half of
:func:`.kernel_rules.bound`.

:func:`audit_kernel_registry` runs the registry lint (``DISPATCH_KEY_GAP``,
:func:`.kernel_rules.dispatch_key_rule`) over every registered op at its
flagship meta (:func:`lint_metas`); :func:`audit_kernels` includes it as
the ``kernel_registry`` program.

:func:`build_demo_kernel_regression` audits the deliberate regression
specimen (``demo_prefix_mlp_block``: decode_mlp_block's kernel under a
floor-divided tile count that drops the last intermediate columns), never
part of the default catalog; :func:`build_segment_skip_regression` the
bf16 flash kernels' segment-tile skip with a test that drops a tile two
segments share (their plans given the specimen's ids), likewise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .auditor import AuditReport
from .kernel_rules import check_launch, dispatch_key_rule
from .rules import Finding

__all__ = ["KernelCase", "kernel_cases", "capture_case", "audit_case",
           "audit_kernels", "audit_kernel_registry", "lint_metas",
           "build_demo_kernel_regression",
           "ALL_KERNEL_NAMES", "KERNEL_CASE_NAMES", "FLOP_FORMULAS",
           "modeled_flops", "needed_flops", "flop_formula_findings",
           "DEMO_SHAPE", "SEGMENT_SHAPE", "capture_segment_skip",
           "build_segment_skip_regression"]


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One audited (kernel family, shape class): ``build()`` returns a
    function that calls the family's wrappers over meta tensors;
    ``kernels`` declares the launch names calling it must capture."""
    op: str
    case: str
    kernels: Tuple[str, ...]
    build: Callable[[], Callable[[], object]]

    @property
    def name(self) -> str:
        return f"{self.op}@{self.case}"


def _meta(shape, dtype="bfloat16"):
    import torch
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype),
                       device="meta")


def _wq(shape, wq, pack_axis=0):
    """A weight of logical ``shape``: a plain meta tensor (``wq`` None),
    or a quantized leaf of the PTQ harness (int8; int4 packed along
    ``pack_axis``) with its f32 scale over the last axis."""
    if wq is None:
        return None
    qshape = list(shape)
    if wq == "int4":
        qshape[pack_axis] //= 2
    return {"qw4" if wq == "int4" else "qw8": _meta(qshape, "int8"),
            "scale": _meta((shape[-1],), "float32")}


# -- per-family builders ------------------------------------------------


def _rms_case(rows, d, dtype, residual=False):
    def build():
        from ..ops.kernels import norms

        def fn():
            x, w = _meta((rows, d), dtype), _meta((d,), dtype)
            if residual:
                norms.residual_rms_norm_fwd_triton(x, x, w)
            else:
                norms.rms_norm_fwd_triton(x, w)
            norms.rms_norm_bwd_triton(x, w, x)
        return fn
    return build


def _layer_norm_case(rows, d, dtype):
    def build():
        from ..ops.kernels import norms

        def fn():
            w = _meta((d,), dtype)
            norms.layer_norm_fwd_triton(_meta((rows, d), dtype), w, w)
        return fn
    return build


def _adamw_case(n, grad_dt, m_dt, shadow):
    def build():
        import torch

        from ..ops.kernels import fused_adamw

        def fn():
            # lr the trainer's f32 word, read by the kernel on the device
            fused_adamw.fused_adamw_triton(
                _meta((n,), "float32"), _meta((n,), grad_dt),
                _meta((n,), m_dt), _meta((n,), m_dt), _meta((), "float32"),
                2, shadow_dtype=getattr(torch, shadow) if shadow else None)
        return fn
    return build


def _paged_case(B, H, KV, hd, BS, N, MB, dtype):
    def build():
        from ..ops.kernels import paged_attention

        def fn():
            pool = _meta((N, BS, KV, hd), dtype)
            paged_attention.paged_attention_decode_cuda(
                _meta((B, H, hd), dtype), pool, pool,
                _meta((B, MB), "int32"), _meta((B,), "int32"))
        return fn
    return build


def _flash_case(B, S, H, KVH, hd, dtype, causal=True, sk=None, bias=None,
                seg=False, dbias=False, dropout=False):
    """The three flash launches; ``bias``: its (batch, head) extents (a
    [bias_b, bias_h, S, sk] f32 bias), ``dbias`` its gradient body,
    ``seg`` segment ids, ``dropout`` a rate of 0.1 (the seed an int32
    word on the device, as a captured step draws it)."""
    sk = S if sk is None else sk

    def build():
        from ..ops.kernels import flash_attention as fa

        def fn():
            q, k = _meta((B, S, H, hd), dtype), _meta((B, sk, KVH, hd), dtype)
            st = _meta((B, H, S), "float32")
            kw = {"rate": 0.1 if dropout else 0.0,
                  "seed": _meta((1,), "int32") if dropout else 0}
            if bias is not None:
                kw["bias"] = _meta((*bias, S, sk), "float32")
            if seg:
                kw["seg_q"] = _meta((B, S), "int32")
                kw["seg_k"] = _meta((B, sk), "int32")
            fa.flash_fwd_cuda(q, k, k, causal, **kw)
            fa.flash_bwd_dq_cuda(q, k, k, q, st, st, causal, **kw,
                                 bias_grad=dbias)
            fa.flash_bwd_dkv_cuda(q, k, k, q, st, st, causal, **kw)
        return fn
    return build


def _pools(N, BS, KV, hd, dtype, quant):
    pool = _meta((N, BS, KV, hd), "int8" if quant else dtype)
    scales = ((_meta((KV,), "float32"), _meta((KV,), "float32"))
              if quant else None)
    return pool, scales


def _attn_weights(D, H, KV, hd, dtype, wq):
    shapes = ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D))
    return [_wq(s, wq) or _meta(s, dtype) for s in shapes]


def _mlp_weights(D, F, dtype, wq):
    return [_wq((D, F), wq) or _meta((D, F), dtype),
            _wq((D, F), wq) or _meta((D, F), dtype),
            _wq((F, D), wq, pack_axis=1) or _meta((F, D), dtype)]


def _attn_block_case(B, D, H, KV, hd, BS, N, MB, dtype, quant=False,
                     wq=None, residual=True):
    def build():
        from ..ops.kernels import fused_decode_block as fdb

        def fn():
            pool, scales = _pools(N, BS, KV, hd, dtype, quant)
            rope = _meta((MB * BS + 1, hd // 2), "float32")
            fdb.decode_attn_block_cuda(
                _meta((B, D), dtype), _meta((D,), dtype),
                *_attn_weights(D, H, KV, hd, dtype, wq), rope, rope,
                pool, pool, _meta((B, MB), "int32"), _meta((B,), "int32"),
                kv_scales=scales, residual=residual)
        return fn
    return build


def _mlp_block_case(B, D, F, dtype, wq=None, residual=True):
    def build():
        from ..ops.kernels import fused_decode_block as fdb

        def fn():
            fdb.decode_mlp_block_cuda(
                _meta((B, D), dtype), _meta((D,), dtype),
                *_mlp_weights(D, F, dtype, wq), residual=residual)
        return fn
    return build


def _block_case(B, D, H, KV, hd, F, BS, N, MB, dtype, quant=False, wq=None):
    def build():
        from ..ops.kernels import fused_decode_block as fdb

        def fn():
            pool, scales = _pools(N, BS, KV, hd, dtype, quant)
            rope = _meta((MB * BS + 1, hd // 2), "float32")
            nw = _meta((D,), dtype)
            fdb.decode_block_fused_cuda(
                _meta((B, D), dtype), nw,
                *_attn_weights(D, H, KV, hd, dtype, wq), nw,
                *_mlp_weights(D, F, dtype, wq), rope, rope, pool, pool,
                _meta((B, MB), "int32"), _meta((B,), "int32"),
                kv_scales=scales)
        return fn
    return build


def _prefill_case(P, D, H, KV, hd, BS, N, MB, dtype, pos0, quant=False,
                  wq=None, residual=True, n_valid=None):
    def build():
        from ..ops.kernels import fused_prefill_block as fpb

        def fn():
            pool, scales = _pools(N, BS, KV, hd, dtype, quant)
            rope = _meta((P, hd // 2), "float32")
            fpb.prefill_attn_block_cuda(
                _meta((P, D), dtype), _meta((D,), dtype),
                *_attn_weights(D, H, KV, hd, dtype, wq), rope, rope, pool,
                pool, _meta((MB,), "int32"), pos0,
                P if n_valid is None else n_valid, kv_scales=scales,
                residual=residual, bounds=_meta((2,), "int32"))
        return fn
    return build


def _linear_ce_case(T, D, V, dtype, tied=False, chunk_rows=None):
    """The forward; the backward as LinearCE runs it (dx keeping P, dh
    over it); and dh alone (its own P passes). ``tied``: the head is the
    embedding [V, D] seen transposed; ``chunk_rows`` forces P's token
    chunks."""
    def build():
        from ..ops.kernels import fused_train as ft

        def fn():
            x = _meta((T, D), dtype)
            head = _meta((V, D), dtype).T if tied else _meta((D, V), dtype)
            labels = _meta((T,), "int64")
            lse, coef = _meta((T,), "float32"), _meta((), "float32")
            ft.linear_ce_fwd_cuda(x, head, labels)
            _, p = ft.linear_ce_bwd_dx_cuda(x, head, labels, lse, coef,
                                            chunk_rows=chunk_rows,
                                            keep_p=True)
            ft.linear_ce_bwd_dh_cuda(x, head, labels, lse, coef, p=p,
                                     chunk_rows=chunk_rows)
            ft.linear_ce_bwd_dh_cuda(x, head, labels, lse, coef,
                                     chunk_rows=chunk_rows)
        return fn
    return build


def _swiglu_case(R, F, dtype):
    def build():
        from ..ops.kernels import fused_train as ft

        def fn():
            g = _meta((R, F), dtype)
            ft.swiglu_fwd_triton(g, g)
            ft.swiglu_bwd_triton(g, g, g)
        return fn
    return build


_CE_KERNELS = ("linear_ce_fwd", "linear_ce_bwd_dx", "linear_ce_bwd_dh")
_FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
# the flagship shapes: LLaMA-7B serving (PERF.md section 4) and the
# training rung "1.07B-h4096" (batch 2 x 2048 tokens)
_D, _H, _HD, _F, _B, _BS, _MB = 4096, 32, 128, 11008, 8, 16, 72
_N = _B * _MB + 1
_P, _POS0 = 128, 512
_T, _V = 2 * 2048, 32000
_NPARAM = 1_071_775_744


def kernel_cases() -> List[KernelCase]:
    """The default gate set: every launch at its tiny and flagship shape
    classes (building is import-cheap; capturing happens in
    :func:`capture_case`)."""
    C = KernelCase
    bf, f32 = "bfloat16", "float32"
    attn7 = (_B, _D, _H, _H, _HD, _BS, _N, _MB, bf)
    pre7 = (_P, _D, _H, _H, _HD, _BS, _N, _MB, bf, _POS0)
    block7 = (_B, _D, _H, _H, _HD, _F, _BS, _N, _MB, bf)
    return [
        C("rms_norm", "tiny", ("rms_norm_fwd", "rms_norm_bwd"),
          _rms_case(24, 128, f32)),
        C("rms_norm", "flagship_train", ("rms_norm_fwd", "rms_norm_bwd"),
          _rms_case(_T, _D, bf)),
        C("rms_norm", "flagship_serving", ("rms_norm_fwd", "rms_norm_bwd"),
          _rms_case(_B, _D, bf)),
        # fewer rows than the backward's programs, D no power of two
        C("rms_norm", "ragged_narrow", ("rms_norm_fwd", "rms_norm_bwd"),
          _rms_case(7, 1000, bf)),
        C("rms_norm_residual", "tiny",
          ("residual_rms_norm_fwd", "rms_norm_bwd"),
          _rms_case(24, 128, f32, residual=True)),
        C("rms_norm_residual", "flagship_train",
          ("residual_rms_norm_fwd", "rms_norm_bwd"),
          _rms_case(_T, _D, bf, residual=True)),
        C("layer_norm", "tiny", ("layer_norm_fwd",),
          _layer_norm_case(24, 128, f32)),
        C("layer_norm", "flagship_train", ("layer_norm_fwd",),
          _layer_norm_case(4096, 1024, f32)),
        C("fused_adamw", "tiny", ("fused_adamw",),
          _adamw_case(1024, f32, f32, None)),
        C("fused_adamw", "flagship_train", ("fused_adamw",),
          _adamw_case(_NPARAM, f32, bf, bf)),
        C("paged_attention", "tiny", ("paged_attention_decode",),
          _paged_case(2, 4, 2, 16, 8, 8, 4, f32)),
        C("paged_attention", "flagship_serving",
          ("paged_attention_decode",),
          _paged_case(_B, _H, _H, _HD, _BS, _N, _MB, bf)),
        # the split page stream at GQA 4:1 and a table of pages that is no
        # multiple of the split (a short last split)
        C("paged_attention", "tiny_gqa_short_split",
          ("paged_attention_decode",),
          _paged_case(6, 8, 2, 16, 8, 67, 11, bf)),
        C("paged_attention", "flagship_serving_gqa",
          ("paged_attention_decode",),
          _paged_case(_B, _H, 8, _HD, _BS, _B * 75 + 1, 75, bf)),
        C("flash_attention", "tiny", _FLASH_KERNELS,
          _flash_case(1, 128, 4, 2, 64, f32)),
        C("flash_attention", "tiny_bias_seg", _FLASH_KERNELS,
          _flash_case(1, 128, 4, 2, 64, f32, bias=(1, 1), seg=True,
                      dbias=True)),
        C("flash_attention", "tiny_dropout_gqa", _FLASH_KERNELS,
          _flash_case(1, 128, 4, 1, 64, f32, dropout=True)),
        C("flash_attention", "tiny_causal_sq_gt_sk", _FLASH_KERNELS,
          _flash_case(1, 128, 4, 2, 64, f32, sk=64)),
        C("flash_attention", "flagship_train", _FLASH_KERNELS,
          _flash_case(2, 2048, _H, _H, _HD, bf)),
        # the packed varlen path: 4096 tokens of 8 documents, LLaMA-7B's
        # attention widths, causal within each segment, dropout 0.1
        C("flash_attention", "flagship_varlen", _FLASH_KERNELS,
          _flash_case(1, 4096, _H, _H, _HD, bf, seg=True, dropout=True)),
        # BERT-base attention (8 x 512 tokens, 12 heads of 64): the padding
        # mask broadcast over heads, and a learned relative-position bias
        # with its gradient, both with dropout 0.1
        C("flash_attention", "flagship_bias_mask", _FLASH_KERNELS,
          _flash_case(8, 512, 12, 12, 64, bf, causal=False, bias=(8, 1),
                      dropout=True)),
        C("flash_attention", "flagship_bias_learned", _FLASH_KERNELS,
          _flash_case(8, 512, 12, 12, 64, bf, causal=False, bias=(1, 12),
                      dbias=True, dropout=True)),
        # the model families' attention (12 heads of 64): GPT-2 small,
        # causal, 8 x 1024; BERT-base MLM, 32 x 128; ViT-B/16, 32 images of
        # 197 tokens (3 x 64 + 5: a ragged last tile)
        C("flash_attention", "flagship_gpt", _FLASH_KERNELS,
          _flash_case(8, 1024, 12, 12, 64, bf)),
        C("flash_attention", "flagship_bert", _FLASH_KERNELS,
          _flash_case(32, 128, 12, 12, 64, bf, causal=False)),
        C("flash_attention", "flagship_vit", _FLASH_KERNELS,
          _flash_case(32, 197, 12, 12, 64, bf, causal=False)),
        C("decode_attn_block", "tiny", ("decode_attn_block",),
          _attn_block_case(2, 32, 2, 2, 16, 8, 8, 4, f32)),
        C("decode_attn_block", "tiny_int8_weights", ("decode_attn_block",),
          _attn_block_case(2, 32, 2, 2, 16, 8, 8, 4, f32, wq="int8")),
        C("decode_attn_block", "flagship_serving", ("decode_attn_block",),
          _attn_block_case(*attn7)),
        C("decode_attn_block", "flagship_serving_int8",
          ("decode_attn_block",), _attn_block_case(*attn7, quant=True)),
        C("decode_attn_block", "flagship_serving_int8_weights",
          ("decode_attn_block",), _attn_block_case(*attn7, wq="int8")),
        C("decode_attn_block", "flagship_serving_int4_weights",
          ("decode_attn_block",), _attn_block_case(*attn7, wq="int4")),
        C("decode_attn_block", "flagship_serving_tp2_partial",
          ("decode_attn_block",),
          _attn_block_case(_B, _D, 16, 16, _HD, _BS, _N, _MB, bf,
                           residual=False)),
        # decode_attn_block's weight-ring body (bf16 at up to 8 rows over
        # int8 pools, but for bf16 weights on a tp=4 shard's heads; 7B over
        # int8 pools, flagship_serving_int8 above, runs it too): a tiny case
        # whose K splits into parts in every weight class, 7B with int8 and
        # int4 weights and GQA 4:1, the tp=2 shard's partials with bf16 and
        # int8 weights, the tp=4 shard's with int4; and the tp=4 shard with
        # bf16 weights, which the rule keeps on the CUDA-core body
        C("decode_attn_block", "tiny_ring_int8", ("decode_attn_block",),
          _attn_block_case(5, 256, 4, 2, 64, 8, 41, 8, bf, quant=True)),
        C("decode_attn_block", "tiny_ring_int8_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(5, 256, 4, 2, 64, 8, 41, 8, bf, quant=True,
                           wq="int8")),
        C("decode_attn_block", "tiny_ring_int4_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(5, 256, 4, 2, 64, 8, 41, 8, bf, quant=True,
                           wq="int4")),
        C("decode_attn_block", "flagship_serving_int8_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(*attn7, quant=True, wq="int8")),
        C("decode_attn_block", "flagship_serving_int4_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(*attn7, quant=True, wq="int4")),
        C("decode_attn_block", "flagship_serving_gqa_int8_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(_B, _D, _H, 8, _HD, _BS, _N, _MB, bf,
                           quant=True, wq="int8")),
        C("decode_attn_block",
          "flagship_serving_tp2_partial_int8_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(_B, _D, 16, 16, _HD, _BS, _N, _MB, bf,
                           quant=True, wq="int8", residual=False)),
        C("decode_attn_block",
          "flagship_serving_tp4_partial_int4_weights_int8",
          ("decode_attn_block",),
          _attn_block_case(_B, _D, 8, 8, _HD, _BS, _N, _MB, bf,
                           quant=True, wq="int4", residual=False)),
        C("decode_attn_block", "flagship_serving_tp2_partial_int8",
          ("decode_attn_block",),
          _attn_block_case(_B, _D, 16, 16, _HD, _BS, _N, _MB, bf,
                           quant=True, residual=False)),
        C("decode_attn_block", "flagship_serving_tp4_partial_int8",
          ("decode_attn_block",),
          _attn_block_case(_B, _D, 8, 8, _HD, _BS, _N, _MB, bf,
                           quant=True, residual=False)),
        C("decode_block_fused", "tiny", ("decode_block_fused",),
          _block_case(2, 32, 2, 2, 16, 64, 8, 8, 4, f32)),
        C("decode_block_fused", "flagship_serving", ("decode_block_fused",),
          _block_case(*block7)),
        C("decode_block_fused", "flagship_serving_int8",
          ("decode_block_fused",), _block_case(*block7, quant=True)),
        C("decode_block_fused", "flagship_serving_int8_weights",
          ("decode_block_fused",), _block_case(*block7, wq="int8")),
        C("decode_block_fused", "flagship_serving_int4_weights",
          ("decode_block_fused",), _block_case(*block7, wq="int4")),
        # the weight-ring body (bf16 weights, at most 8 rows): a tiny case
        # whose K splits into parts, GQA 4:1 at 7B, and 5 slots
        C("decode_block_fused", "tiny_ring", ("decode_block_fused",),
          _block_case(5, 512, 4, 2, 64, 640, 8, 41, 8, bf)),
        C("decode_block_fused", "flagship_serving_gqa",
          ("decode_block_fused",),
          _block_case(_B, _D, _H, 8, _HD, _F, _BS, _N, _MB, bf)),
        C("decode_block_fused", "flagship_serving_5_slots",
          ("decode_block_fused",),
          _block_case(5, _D, _H, _H, _HD, _F, _BS, _N, _MB, bf)),
        # the ring over int8 and int4 codes: a tiny case whose K splits into
        # parts (int4: q/k/v, o_proj and gate/up packed along K, down along
        # its output columns), and int8 weights over int8 pools at 7B
        C("decode_block_fused", "tiny_ring_int8_weights",
          ("decode_block_fused",),
          _block_case(5, 512, 4, 2, 64, 640, 8, 41, 8, bf, wq="int8")),
        C("decode_block_fused", "tiny_ring_int4_weights",
          ("decode_block_fused",),
          _block_case(5, 512, 4, 2, 64, 640, 8, 41, 8, bf, wq="int4")),
        C("decode_block_fused", "flagship_serving_int8_weights_int8",
          ("decode_block_fused",),
          _block_case(*block7, quant=True, wq="int8")),
        C("decode_mlp_block", "tiny", ("decode_mlp_block",),
          _mlp_block_case(2, 32, 64, f32)),
        C("decode_mlp_block", "tiny_int4_weights", ("decode_mlp_block",),
          _mlp_block_case(2, 32, 64, f32, wq="int4")),
        C("decode_mlp_block", "flagship_serving", ("decode_mlp_block",),
          _mlp_block_case(_B, _D, _F, bf)),
        C("decode_mlp_block", "flagship_serving_int8_weights",
          ("decode_mlp_block",), _mlp_block_case(_B, _D, _F, bf, wq="int8")),
        C("decode_mlp_block", "flagship_serving_int4_weights",
          ("decode_mlp_block",), _mlp_block_case(_B, _D, _F, bf, wq="int4")),
        C("decode_mlp_block", "flagship_serving_tp2_partial",
          ("decode_mlp_block",),
          _mlp_block_case(_B, _D, _F // 2, bf, residual=False)),
        C("decode_mlp_block", "tiny_ring", ("decode_mlp_block",),
          _mlp_block_case(5, 512, 640, bf)),
        C("decode_mlp_block", "tiny_ring_int8_weights", ("decode_mlp_block",),
          _mlp_block_case(5, 512, 640, bf, wq="int8")),
        C("decode_mlp_block", "tiny_ring_int4_weights", ("decode_mlp_block",),
          _mlp_block_case(5, 512, 640, bf, wq="int4")),
        C("decode_mlp_block", "flagship_serving_tp2_partial_int8_weights",
          ("decode_mlp_block",),
          _mlp_block_case(_B, _D, _F // 2, bf, wq="int8", residual=False)),
        C("prefill_attn_block", "tiny", ("prefill_attn_block",),
          _prefill_case(16, 32, 4, 2, 16, 8, 9, 6, f32, 10)),
        C("prefill_attn_block", "flagship_serving", ("prefill_attn_block",),
          _prefill_case(*pre7)),
        C("prefill_attn_block", "flagship_serving_int8",
          ("prefill_attn_block",), _prefill_case(*pre7, quant=True)),
        C("prefill_attn_block", "flagship_serving_int8_weights",
          ("prefill_attn_block",), _prefill_case(*pre7, wq="int8")),
        C("prefill_attn_block", "flagship_serving_int4_weights",
          ("prefill_attn_block",), _prefill_case(*pre7, wq="int4")),
        # the prefill MLP runs the decode MLP kernel at chunk rows: its
        # tensor-core body in bf16 (csrc/tile_mma.cuh), at the serving
        # buckets' 32 and 128 rows in every weight class
        C("prefill_mlp_block", "flagship_serving", ("decode_mlp_block",),
          _mlp_block_case(_P, _D, _F, bf)),
        C("prefill_mlp_block", "chunk128_int8_weights", ("decode_mlp_block",),
          _mlp_block_case(_P, _D, _F, bf, wq="int8")),
        C("prefill_mlp_block", "chunk128_int4_weights", ("decode_mlp_block",),
          _mlp_block_case(_P, _D, _F, bf, wq="int4")),
        C("prefill_mlp_block", "chunk32", ("decode_mlp_block",),
          _mlp_block_case(32, _D, _F, bf)),
        C("prefill_mlp_block", "chunk32_int8_weights", ("decode_mlp_block",),
          _mlp_block_case(32, _D, _F, bf, wq="int8")),
        C("prefill_mlp_block", "chunk32_int4_weights", ("decode_mlp_block",),
          _mlp_block_case(32, _D, _F, bf, wq="int4")),
        C("prefill_mlp_block", "tiny_tc", ("decode_mlp_block",),
          _mlp_block_case(20, 64, 96, bf)),
        # prefill_attn_block's tensor-core body at the 32-row bucket (the
        # 128-row one is flagship_serving*), and at a tiny width
        C("prefill_attn_block", "chunk32", ("prefill_attn_block",),
          _prefill_case(32, *pre7[1:])),
        C("prefill_attn_block", "chunk32_int8", ("prefill_attn_block",),
          _prefill_case(32, *pre7[1:], quant=True)),
        C("prefill_attn_block", "chunk32_int8_weights",
          ("prefill_attn_block",), _prefill_case(32, *pre7[1:], wq="int8")),
        C("prefill_attn_block", "chunk32_int4_weights",
          ("prefill_attn_block",), _prefill_case(32, *pre7[1:], wq="int4")),
        C("prefill_attn_block", "tiny_tc", ("prefill_attn_block",),
          _prefill_case(32, 64, 2, 1, 128, 8, 9, 12, bf, 10)),
        # the int8-pool attention on the tensor cores: tiny, and the tp=2
        # partial body at 7B (H = KV = 16, o_proj without the residual)
        C("prefill_attn_block", "tiny_tc_int8", ("prefill_attn_block",),
          _prefill_case(32, 64, 2, 1, 128, 8, 9, 12, bf, 10, quant=True)),
        C("prefill_attn_block", "flagship_serving_tp2_partial_int8",
          ("prefill_attn_block",),
          _prefill_case(_P, _D, 16, 16, _HD, _BS, _N, _MB, bf, _POS0,
                        quant=True, residual=False)),
        # a chunk whose last rows are bucket padding (77 real of 128)
        C("prefill_attn_block", "chunk128_ragged", ("prefill_attn_block",),
          _prefill_case(*pre7, n_valid=77)),
        C("prefill_attn_block", "tiny_ragged", ("prefill_attn_block",),
          _prefill_case(16, 32, 4, 2, 16, 8, 9, 6, f32, 10, n_valid=11)),
        C("fused_linear_ce", "tiny", _CE_KERNELS,
          _linear_ce_case(24, 64, 128, f32)),
        C("fused_linear_ce", "flagship_train", _CE_KERNELS,
          _linear_ce_case(_T, _D, _V, bf)),
        # the backward's P pass and products (wgmma) in every layout: the
        # tied head, a ragged V (the head staged to aligned rows), forced
        # token chunks (dh's f32 sum across them), the f32 passes chunked
        C("fused_linear_ce", "tiny_bf16_ragged", _CE_KERNELS,
          _linear_ce_case(200, 64, 300, bf)),
        C("fused_linear_ce", "tiny_tied", _CE_KERNELS,
          _linear_ce_case(130, 64, 256, bf, tied=True)),
        C("fused_linear_ce", "tiny_two_chunks", _CE_KERNELS,
          _linear_ce_case(256, 64, 320, bf, chunk_rows=128)),
        C("fused_linear_ce", "tiny_f32_chunks", _CE_KERNELS,
          _linear_ce_case(300, 48, 131, f32, chunk_rows=128)),
        C("fused_linear_ce", "flagship_train_tied", _CE_KERNELS,
          _linear_ce_case(_T, _D, _V, bf, tied=True)),
        C("fused_linear_ce", "flagship_train_ragged", _CE_KERNELS,
          _linear_ce_case(_T - 1, _D, _V + 3, bf)),
        C("fused_linear_ce", "flagship_train_two_chunks", _CE_KERNELS,
          _linear_ce_case(_T, _D, _V, bf, chunk_rows=_T // 2)),
        # GPT-2 small's loss: 8 x 1024 tokens over the tied 50304-word
        # embedding (196.5 vocab tiles of 256)
        C("fused_linear_ce", "flagship_gpt_tied", _CE_KERNELS,
          _linear_ce_case(8 * 1024, 768, 50304, bf, tied=True)),
        C("fused_swiglu", "tiny", ("swiglu_fwd", "swiglu_bwd"),
          _swiglu_case(16, 64, f32)),
        C("fused_swiglu", "flagship_train", ("swiglu_fwd", "swiglu_bwd"),
          _swiglu_case(_T, _F, bf)),
    ]


KERNEL_CASE_NAMES: Tuple[str, ...] = tuple(c.name for c in kernel_cases())

#: every audited launch name: the 18 launches of the JAX package
ALL_KERNEL_NAMES = frozenset(k for c in kernel_cases() for k in c.kernels)


# -- modeled FLOPs --------------------------------------------------------
# The JAX package's per-launch formulas (a [m,k]x[k,n] product is 2mkn;
# elementwise work at its documented constants), read off the port's
# spec. With ``needed`` False they are the JAX model: full block tables,
# no causal halving. With ``needed`` True they count what the launch's
# data needs: the live lengths of the pools (``live``, tokens a sequence
# already holds; by default the launch's own), the real rows of a prefill
# chunk and the pairs under the causal mask.


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _dims(spec, *names):
    return [spec.operand(n).shape for n in names]


def _table(spec):
    """(sequences, table width MB, page size BS)."""
    table = next(op for op in spec.inputs if op.paged == "pages")
    pool = next(op for op in spec.inputs if op.paged == "tokens")
    rows = table.shape[0] if len(table.shape) == 2 else 1
    return rows, table.shape[-1], pool.shape[1]


def _flops_rms_fwd(spec, needed, live):
    return 4.0 * _prod(spec.operand("x").shape)


def _flops_rms_bwd(spec, needed, live):
    return 10.0 * _prod(spec.operand("x").shape)


def _flops_res_rms_fwd(spec, needed, live):
    return 5.0 * _prod(spec.operand("x").shape)


def _flops_layer_norm_fwd(spec, needed, live):
    return 6.0 * _prod(spec.operand("x").shape)


def _flops_adamw(spec, needed, live):
    return 12.0 * _prod(spec.operand("param").shape)


def _attended(spec, needed, live, new_token):
    """Key positions a head attends over all sequences: the full tables,
    or the live tokens (plus the new one in a decode block)."""
    rows, MB, BS = _table(spec)
    if not needed:
        return rows * MB * BS
    from .kernel_rules import _live
    return sum(n + new_token for n in _live(spec, live))


def _flops_paged_decode(spec, needed, live):
    _, H, hd = spec.operand("q").shape
    return 4.0 * H * hd * _attended(spec, needed, live, 0)


def _attn_products(B, D, Hhd, KVhd):
    return B * (4.0 * D + 2.0 * D * Hhd + 4.0 * D * KVhd + 2.0 * Hhd * D)


def _flops_decode_attn_block(spec, needed, live):
    (B, D), (_, Hhd), (_, KVhd) = _dims(spec, "x", "wq", "wk")
    return (_attn_products(B, D, Hhd, KVhd)
            + 4.0 * Hhd * _attended(spec, needed, live, 1))


def _mlp_flops(B, D, F):
    return B * (4.0 * D + 6.0 * D * F + 4.0 * F)


def _flops_decode_mlp_block(spec, needed, live):
    (B, D), (_, F) = _dims(spec, "x", "wg")
    return _mlp_flops(B, D, F)


def _flops_demo_mlp(spec, needed, live):
    (B, D), = _dims(spec, "x")
    return _mlp_flops(B, D, spec.plan["down_k"])


def _flops_decode_block_fused(spec, needed, live):
    (B, D), (_, Hhd), (_, KVhd), (_, F) = _dims(spec, "x", "wq", "wk", "wg")
    return (_attn_products(B, D, Hhd, KVhd) + 4.0 * B * D
            + 4.0 * Hhd * _attended(spec, needed, live, 1)
            + B * (6.0 * D * F + 4.0 * F))


def _flops_prefill_attn_block(spec, needed, live):
    (P, D), (_, Hhd), (_, KVhd) = _dims(spec, "x", "wq", "wk")
    if not needed:
        _, MB, BS = _table(spec)
        return _attn_products(P, D, Hhd, KVhd) + 4.0 * P * Hhd * MB * BS
    n, pos0 = spec.params["n_valid"], spec.params["pos0"]
    attended = sum(pos0 + r + 1 for r in range(n))
    return _attn_products(n, D, Hhd, KVhd) + 4.0 * Hhd * attended


def _flash_pairs(spec, needed, segments=None):
    """(query, key) pairs the launch's function needs, times b h d: every
    pair, or (``needed``) those under the causal mask and, given the
    launch's ``segments`` (seg_q [b, sq], seg_k [b, sk]), of one id."""
    b, sq, h, d = spec.operand("q").shape
    sk = spec.operand("k").shape[1]
    if needed and segments is not None:
        seg_q, seg_k = (np.asarray(torch.as_tensor(t).cpu())
                        for t in segments)
        seen = seg_q[:, :, None] == seg_k[:, None, :]
        if spec.params["causal"]:
            seen &= np.tri(sq, sk, sk - sq, dtype=bool)
        return float(h * int(seen.sum()) * d)
    if needed and spec.params["causal"]:
        # row r sees keys up to r + sk - sq (none above the diagonal when
        # sq > sk)
        pairs = int(np.clip(np.arange(sq) + sk - sq + 1, 0, sk).sum())
    else:
        pairs = sq * sk
    return float(b * h * pairs * d)


def _flops_flash_fwd(spec, needed, live):
    return 4.0 * _flash_pairs(spec, needed, live)


def _flops_flash_bwd_dq(spec, needed, live):
    return 6.0 * _flash_pairs(spec, needed, live)


def _flops_flash_bwd_dkv(spec, needed, live):
    return 8.0 * _flash_pairs(spec, needed, live)


def _flops_ce_fwd(spec, needed, live):
    (T, D), (_, V) = _dims(spec, "x", "head")
    return 2.0 * T * D * V + 3.0 * T * V


def _flops_ce_bwd(spec, needed, live):
    """The JAX model: the logits and one product, 4 T D V, for either
    pass. Needed: the dx call S and its product; the dh call one product
    and S for the rows of P it is not given (its own P passes)."""
    (T, D), (_, V) = _dims(spec, "x", spec.outputs[0].name
                           if spec.name == "linear_ce_bwd_dh" else "head")
    if not (needed and spec.params.get("p_given")):
        return 4.0 * T * D * V
    rows = spec.plan["chunk_rows"]
    return 2.0 * T * D * V + 2.0 * (T - rows) * D * V


def _flops_swiglu_fwd(spec, needed, live):
    return 5.0 * _prod(spec.operand("gate").shape)


def _flops_swiglu_bwd(spec, needed, live):
    return 10.0 * _prod(spec.operand("gate").shape)


#: launch name -> FLOP formula ``(spec, needed, live)`` (``live``: the
#: data that decides the work, the tokens of each sequence for a paged
#: launch, the segment ids for flash); every member of
#: ALL_KERNEL_NAMES has one (:func:`flop_formula_findings`), and so has
#: the gate's regression specimen
FLOP_FORMULAS: Dict[str, Callable] = {
    "rms_norm_fwd": _flops_rms_fwd,
    "rms_norm_bwd": _flops_rms_bwd,
    "residual_rms_norm_fwd": _flops_res_rms_fwd,
    "layer_norm_fwd": _flops_layer_norm_fwd,
    "fused_adamw": _flops_adamw,
    "paged_attention_decode": _flops_paged_decode,
    "decode_attn_block": _flops_decode_attn_block,
    "decode_mlp_block": _flops_decode_mlp_block,
    "decode_block_fused": _flops_decode_block_fused,
    "prefill_attn_block": _flops_prefill_attn_block,
    "flash_attention_fwd": _flops_flash_fwd,
    "flash_attention_bwd_dq": _flops_flash_bwd_dq,
    "flash_attention_bwd_dkv": _flops_flash_bwd_dkv,
    "linear_ce_fwd": _flops_ce_fwd,
    "linear_ce_bwd_dx": _flops_ce_bwd,
    "linear_ce_bwd_dh": _flops_ce_bwd,
    "swiglu_fwd": _flops_swiglu_fwd,
    "swiglu_bwd": _flops_swiglu_bwd,
    "demo_prefix_mlp_block": _flops_demo_mlp,
}


def modeled_flops(spec) -> Optional[float]:
    """The JAX package's modeled FLOPs of one launch (full tables, no
    causal halving), or None when the launch has no formula (a
    FLOP_FORMULA_GAP finding, not a silent zero)."""
    fn = FLOP_FORMULAS.get(spec.name)
    return None if fn is None else float(fn(spec, False, None))


def needed_flops(spec, seq_lens=None, segments=None) -> float:
    """The operations one launch's data needs: the live lengths
    (``seq_lens``, tokens in the pools of each sequence; by default the
    launch's own, else the full tables), the real rows of a prefill chunk,
    the pairs under the causal mask and, for flash (``segments``: the
    launch's seg_q and seg_k ids), of one segment."""
    if segments is not None and seq_lens is not None:
        raise ValueError("needed_flops: seq_lens (paged launches) and "
                         "segments (flash) do not go together")
    live = segments if segments is not None else seq_lens
    return float(FLOP_FORMULAS[spec.name](spec, True, live))


def flop_formula_findings() -> List[Finding]:
    """A finding for each audited launch without a FLOP formula: it would
    fall out of every bound silently."""
    return [Finding(
        rule="kernel_auditor", code="FLOP_FORMULA_GAP", severity="error",
        program="flop_formulas", site=name,
        message=(f"audited kernel {name!r} has no FLOP formula in "
                 "kernel_catalog.FLOP_FORMULAS: its bound would have no "
                 "operations; register one beside its cases"),
        detail={"kernel": name, "registered": sorted(FLOP_FORMULAS)})
        for name in sorted(ALL_KERNEL_NAMES - set(FLOP_FORMULAS))]


# -- capture and audit ----------------------------------------------------


def capture_case(case: KernelCase):
    """Run one case under launch capture. Returns (specs, error)."""
    from ..ops.kernels._launch import capture_kernel_launches
    try:
        fn = case.build()
        with capture_kernel_launches() as specs:
            fn()
        return specs, None
    except Exception as e:  # noqa: BLE001 - a broken capture is a finding
        return [], e


def audit_specs(specs, program, declared=()) -> AuditReport:
    """Every rule over captured ``specs``; a declared launch name the
    capture lacks is a COVERAGE_GAP finding."""
    report = AuditReport(program=program, rules_run=["kernel_geometry"])
    captured = {s.name for s in specs}
    for missing in sorted(set(declared) - captured):
        report.findings.append(Finding(
            rule="kernel_auditor", code="COVERAGE_GAP", severity="error",
            program=program, site=missing,
            message=(f"case declares kernel {missing!r} but the capture "
                     f"recorded only {sorted(captured)}: a launch stopped "
                     "passing _launch.begin (or the case no longer "
                     "reaches it)"),
            detail={"declared": sorted(declared),
                    "captured": sorted(captured)}))
    seen = set()
    for spec in specs:
        if id(spec) in seen:     # a cached plan recorded twice
            continue
        seen.add(id(spec))
        report.findings.extend(check_launch(spec, program=program))
    report.meta["kernels"] = sorted(captured)
    report.meta["launches"] = len(specs)
    return report


def audit_case(case: KernelCase) -> AuditReport:
    """Capture one case and run every rule; a capture that fails, or a
    declared launch it does not record, is itself a finding."""
    specs, err = capture_case(case)
    if err is not None:
        report = AuditReport(program=case.name,
                             rules_run=["kernel_geometry"])
        report.findings.append(Finding(
            rule="kernel_auditor", code="TRACE_ERROR", severity="error",
            program=case.name, site=type(err).__name__,
            message=(f"kernel case failed to capture: "
                     f"{type(err).__name__}: {err}"),
            detail={"exception": type(err).__name__}))
        report.meta["trace_error"] = str(err)
        return report
    return audit_specs(specs, case.name, case.kernels)


def lint_metas() -> Dict[str, dict]:
    """A flagship meta for each registered op, from the same meta builders
    its call sites use (so the lint reads the real key set): the serving
    shapes (8 slots at LLaMA-7B widths, bf16, 128-row chunks) and the train
    rung's (4096 tokens at D 4096, vocab 32000)."""
    from ..ops.flash_attention import flash_meta
    from ..ops.fused_train import ce_meta, swiglu_meta
    from ..ops.kernels.fused_adamw import adamw_meta
    from ..ops.kernels.fused_decode_block import decode_meta_dims
    from ..ops.kernels.fused_prefill_block import prefill_meta_dims
    from ..ops.kernels.norms import rms_bwd_meta
    bf16 = torch.bfloat16
    decode = decode_meta_dims(_B, _D, _H, _H, _HD, _F, _BS, _MB, bf16, bf16,
                              False)
    prefill = prefill_meta_dims(128, _D, _H, _H, _HD, _F, _BS, _MB, bf16,
                                bf16, False)
    q = torch.empty(2, 2048, _H, _HD, dtype=bf16, device="meta")
    flash = dict(flash_meta(q, q, True), device="cuda")
    return {
        "decode_attn_block": decode, "decode_mlp_block": decode,
        "decode_block_fused": decode, "prefill_attn_block": prefill,
        "prefill_mlp_block": prefill, "flash_attention": flash,
        "fused_linear_ce": ce_meta(4096, _D, 32000, bf16, "cuda"),
        "fused_swiglu": swiglu_meta(4096, _F, bf16, "cuda"),
        "rms_norm_bwd": rms_bwd_meta(4096, _D, bf16, "cuda"),
        "rms_norm_residual": rms_bwd_meta(4096, _D, bf16, "cuda"),
        "fused_adamw": adamw_meta(_NPARAM, torch.float32, torch.float32,
                                  True, "cuda"),
    }


def audit_kernel_registry(registry=None) -> AuditReport:
    """The DISPATCH_KEY_GAP lint over every op of ``registry`` (the port's
    ``KERNELS``) at :func:`lint_metas`. An op without a lint meta is
    itself a finding: a new op teaches the gate its shape class."""
    from ..ops.kernels.registry import KERNELS
    registry = KERNELS if registry is None else registry
    report = AuditReport(program="kernel_registry",
                         rules_run=["dispatch_key"])
    metas = lint_metas()
    for op in registry.ops():
        if op not in metas:
            report.findings.append(Finding(
                rule="kernel_geometry", code="DISPATCH_KEY_GAP",
                severity="error", program="kernel_registry",
                site=f"{op}:no-sample",
                message=(f"registered kernel op {op!r} has no lint meta in "
                         "the kernel catalog: its supports() reads cannot "
                         "be held against its declared program-key "
                         "coverage"),
                detail={"op": op}))
            continue
        report.findings.extend(dispatch_key_rule(
            registry, op, metas[op], program="kernel_registry"))
    report.meta["ops"] = registry.ops()
    return report


def audit_kernels(names: Optional[List[str]] = None) -> List[AuditReport]:
    """Audit the catalog (every case, or the ``op`` / ``op@case``
    subset), plus the FLOP-formula coverage and the registry lint
    (``kernel_registry``). A name the catalog does not know raises
    ValueError instead of gating nothing."""
    cases = kernel_cases()
    extra = {"flop_formulas", "kernel_registry"}
    if names is not None:
        wanted = set(names)
        known = {c.name for c in cases} | {c.op for c in cases} | extra
        unknown = wanted - known
        if unknown:
            raise ValueError(f"unknown kernel case(s): {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        cases = [c for c in cases if c.name in wanted or c.op in wanted]
        extra &= wanted
    reports = [audit_case(c) for c in cases]
    if "flop_formulas" in extra:
        rep = AuditReport(program="flop_formulas",
                          rules_run=["flop_formulas"])
        rep.findings.extend(flop_formula_findings())
        rep.meta["registered"] = sorted(FLOP_FORMULAS)
        reports.append(rep)
    if "kernel_registry" in extra:
        reports.append(audit_kernel_registry())
    return reports


# -- the regression specimen ----------------------------------------------

#: the specimen's shape: the JAX demo's (B 2, D 32, F 96; its tile,
#: ``fused_decode_block.DEMO_TILE``, is 64), in bf16 (the port's f32
#: column tiles are at most 32 wide, and 32 divides 96)
DEMO_SHAPE = {"B": 2, "D": 32, "F": 96, "dtype": "bfloat16"}


def capture_demo():
    """The specimen's spec, captured over meta tensors."""
    from ..ops.kernels import fused_decode_block as fdb
    from ..ops.kernels._launch import capture_kernel_launches
    B, D, F, dt = (DEMO_SHAPE[k] for k in ("B", "D", "F", "dtype"))
    with capture_kernel_launches() as specs:
        fdb.demo_prefix_mlp_block_cuda(
            _meta((B, D), dt), _meta((D,), dt), _meta((D, F), dt),
            _meta((D, F), dt), _meta((F, D), dt))
    return specs


def build_demo_kernel_regression() -> AuditReport:
    """The audit of the PRE-FIX non-divisor MLP launch: decode_mlp_block's
    kernel with its gate/up tiles counted ``F // tile`` (floor) and its
    down phase over the columns those tiles wrote, so the last ``F %
    tile`` = 32 intermediate columns never reach the down projection. The
    gate must report GRID_FLOOR_DROP on wg, wu and wd (the CLI's
    ``--demo-regression`` exits 2)."""
    return audit_specs(capture_demo(), "demo_prefix_mlp_block@tiny",
                       ("demo_prefix_mlp_block",))


# -- the segment-skip specimen ---------------------------------------------

#: the segment-skip specimen: one row of 512 packed tokens at tiny widths
#: (h 4 over kv 2, d 64, bf16, causal), documents starting at 0, 100,
#: 230, 300 and 400, padding (id -1) from 480. Key tile 1 (keys 64-127)
#: and query tile 1 hold two segments each.
SEGMENT_SHAPE = {"b": 1, "s": 512, "h": 4, "kvh": 2, "d": 64,
                 "starts": (0, 100, 230, 300, 400), "pad": 480,
                 "shared_tile": 1}


def segment_specimen_ids():
    """[1, 512] int32 ids of the specimen."""
    s = SEGMENT_SHAPE["s"]
    ids = np.searchsorted(np.asarray(SEGMENT_SHAPE["starts"]), np.arange(s),
                          side="right") - 1
    ids[SEGMENT_SHAPE["pad"]:] = -1
    return ids[None].astype(np.int32)


def capture_segment_skip(broken=False):
    """The plans of the bf16 forward, dq and dkv passes at the specimen's
    ids: the pairs the kernels' id-range test keeps or, ``broken``, a test
    that also drops every pair of the tile two segments share (key tile 1
    in the forward and the dq pass, query tile 1 in the dkv pass)."""
    from ..ops.kernels import flash_attention as fa
    sh = SEGMENT_SHAPE
    ids = segment_specimen_ids()
    specs = []
    for name in _FLASH_KERNELS:
        kept = fa.segment_tiles_kept(ids, ids)
        if broken:
            t = sh["shared_tile"]
            if name != "flash_attention_bwd_dkv":
                kept[:, :, t] = False
            else:
                kept[:, t, :] = False
        tiles = fa.SegTiles.of(ids, ids, True, kept=kept)
        specs.append(fa.flash_spec(name, sh["b"], sh["s"], sh["s"], sh["h"],
                                   sh["kvh"], sh["d"], "bfloat16", True,
                                   seg=tiles))
    return specs


def build_segment_skip_regression() -> AuditReport:
    """The audit of a segment-tile skip that drops a tile two segments
    share (never part of the default catalog): the forward and the dq pass
    never read key tile 1 (k, v, seg_k) and the dkv pass never reads query
    tile 1 (q, do, lse, delta, seg_q), though pairs of one id need them.
    The gate must report GRID_FLOOR_DROP on those operands."""
    return audit_specs(capture_segment_skip(broken=True),
                       "segment_skip@tiny", _FLASH_KERNELS)
