"""Fused decode-block kernels: the three CUDA kernels' wrappers, their
plain versions, the dispatch metas and predicates, and the resolvers
(port of ``paddle_tpu/ops/pallas/fused_decode_block.py``: fp, int8 and
int4 weights; fp and int8 pools).

- ``decode_attn_block`` (:func:`decode_attn_block_cuda`) replaces
  ``fused_attn_block_pallas``: RMSNorm + QKV + RoPE + paged attention with
  the new token folded in + o_proj + residual, in one launch.
- ``decode_mlp_block`` (:func:`decode_mlp_block_cuda`) replaces
  ``fused_mlp_block_pallas``: RMSNorm + gate/up + SwiGLU + down +
  residual, in one launch.
- ``decode_block_fused`` (:func:`decode_block_fused_cuda`) replaces
  ``fused_decode_block_pallas``: both halves, one whole decoder layer, in
  one launch, the attention-to-MLP residual kept in f32.

The kernels are ``paddle_tpu_torch/csrc/fused_decode_block.cu`` (CUDA C++
for ``sm_90a``, built by :mod:`._build` at the first launch and bound with
ctypes); that file's header says what bounds them on the H100 and how
their design follows from it.

Each weight may be a plain tensor or a quantized leaf of the PTQ harness
(``{"qw8"|"qw4": q, "scale": s}``, :mod:`paddle_tpu_torch.quantization`).
The kernels stream the integer weights, convert them in registers and
apply the per-output-channel f32 scale in the product's epilogue, as the
JAX kernels do: ``dot(h, q) * s``, then the cast to the model type where
the fp kernel casts.

The pools may be int8 with static per-head f32 scales (the int8 KV cache:
``kv_scales = (k_scale [KV], v_scale [KV])``, the JAX kernels' ``quant``
bodies). The attention kernels then stage int8 pages and dequantize each
element in f32 (``q * s``) before its product, and they fold the new
token in as ``clip(round(x / s), -127, 127) * s`` in f32: the value the
unfused step reads back from the pool. ``k_new``/``v_new`` stay raw, at
the model type, for the caller's quantizing pool write
(``write_to_pool_quant``).

:func:`attn_block_ref` and :func:`mlp_block_ref` are the registry's
priority-0 ``"unfused"`` variants: op for op the building blocks of
``inference.generation._paged_decode_step`` (quantized leaves through
``maybe_dequantize``, dequantize-then-matmul), so a decode step that
dispatches them is bit-identical to the unfused step. They run the port's
RMSNorm and paged-attention kernels on CUDA tensors and those kernels'
plain versions on the CPU. :func:`attn_block_wq_ref` and
:func:`mlp_block_wq_ref` are the two-stage kernels' plain versions in the
kernels' epilogue order, which differs from dequantize-then-matmul by
roundoff (``q * s`` is never rounded to the model type); on plain weights
they are the compositions up to summation order. :func:`decode_block_ref`
is the single-launch kernel's plain version, written for that kernel's
rounding points (the JAX ``_block_fused_kernel``'s), which differ from the
two-stage route's: a roundoff-level variant of it, as in the JAX package.
:func:`decode_block_composed` is ``decode_block_fused``'s priority-0
variant: the exact two-stage sequence, each stage dispatched through the
registry (the two CUDA kernels on the card, the compositions on the CPU).

Dispatch differs from the TPU's on purpose. The TPU predicates refuse a
block whose weights do not fit the VMEM budget, which rejects the
attention kernel and the single-launch kernel at LLaMA-7B bf16. The CUDA
kernels stream their weights from device memory, so what they need is
shared memory for one pass of 8 normalised rows and the attention scratch
(:func:`attn_smem_bytes`, :func:`mlp_smem_bytes`,
:func:`block_smem_bytes`: the one definition of the kernels' layout
sizes, passed to them at launch) under the card's 227 KB a block. That
need grows with the hidden width, not with the batch or the weight type
(shared memory holds activations, never weights): at LLaMA-7B all three
kernels are selected for any number of slots and every weight class. So
"auto" on the card takes the single-launch kernel where the TPU takes the
two-stage route, and the serving engine's default decode step is
``decode_block_fused``.

The compositions are the CPU's route only. On CUDA tensors a predicate
that refuses a two-stage kernel makes dispatch raise with its reason:
the decode step never gives way to the composition (nor, for a quantized
tree, to dequantize-then-matmul) on the card unless the caller asks for
it (``mode="ref"``, or a ``KERNELS.force`` pin). Where the single-launch
kernel refuses, "auto" takes the two-stage kernels, as the JAX package
does.
"""
from __future__ import annotations

import functools
import math

import torch

from ...quantization.quanters import maybe_dequantize, unpack_int4
from . import _build, _launch
from .registry import KERNELS

__all__ = ["attn_block_ref", "mlp_block_ref", "attn_block_wq_ref",
           "mlp_block_wq_ref", "decode_block_ref", "decode_block_composed",
           "decode_attn_block_cuda", "decode_mlp_block_cuda",
           "decode_block_fused_cuda", "decode_meta", "decode_meta_dims",
           "attn_smem_bytes", "mlp_smem_bytes", "block_smem_bytes",
           "SMEM_LIMIT", "weight_dtype_of", "resolve_decode_blocks",
           "resolve_decode_step", "demo_prefix_mlp_block_cuda",
           "demo_prefix_mlp_block_ref", "DEMO_TILE", "pick_lpr",
           "assumed_grid", "attn_spec", "mlp_spec", "block_spec"]

#: dynamic shared memory one block of an H100 may use (232,448 bytes)
SMEM_LIMIT = _launch.SMEM_BLOCK


# ---------------------------------------------------------------------------
# weight quantization: plain tensors or the PTQ harness's leaves
# ---------------------------------------------------------------------------
def _wq_parts(w):
    """A weight leaf -> (weights, scale, bits, pack_axis): a plain tensor is
    ``(w, None, 0, 0)``; a quantized leaf ``{"qw8"|"qw4": q, "scale": s}``
    its integer tensor, f32 scale [out], 8 or 4, and for int4 the axis it
    is packed along: 1 (the output axis) when the byte count is half the
    scale length, else 0 (the contraction axis)."""
    if isinstance(w, dict):
        scale = w["scale"]
        if "qw4" in w:
            qw = w["qw4"]
            return qw, scale, 4, (1 if qw.shape[-1] * 2 == scale.shape[-1]
                                  else 0)
        return w["qw8"], scale, 8, 0
    return w, None, 0, 0


def weight_dtype_of(*ws):
    """The weight class of a block's leaves: "int8", "int4" or None for
    plain tensors. A block's weights share one class (the kernels stream
    them all in one form)."""
    bits = {_wq_parts(w)[2] for w in ws}
    if len(bits) != 1:
        raise ValueError(
            "all block weights must share one weight-quant mode, got "
            f"bit widths {sorted(bits)}")
    return {8: "int8", 4: "int4"}.get(bits.pop())


def _wq_even_reason(meta, dims):
    """int4 packing pairs the two halves of the pack axis, so every packed
    dimension must be even. ``dims``: (name, value) pairs."""
    if meta.get("weight_dtype") != "int4":
        return None
    for name, v in dims:
        if v % 2:
            return (f"packed-int4 weights need an even {name} "
                    f"(got {v}): packing pairs the axis halves")
    return None


def _f32mm(h, w):
    """``h @ w`` summed in f32, in the kernels' epilogue order: a quantized
    leaf's integers (exact in the model type) in the f32 product, then
    times the per-output-channel f32 scale. f32 result."""
    if not isinstance(w, dict):
        return h.float() @ w.float()
    q, s, bits, axis = _wq_parts(w)
    if bits == 4:
        q = unpack_int4(q, axis)
    return (h.float() @ q.float()) * s.float()


def _epi_mm(h, w):
    """A product landing in h's type as the kernels round it: plain
    weights ``h @ w``; quantized leaves :func:`_f32mm` cast once."""
    if not isinstance(w, dict):
        return h @ w
    return _f32mm(h, w).to(h.dtype)


def _deq_mm(h, w):
    """Dequantize-then-matmul: the unfused step's product."""
    return h @ maybe_dequantize(w, h.dtype)


# ---------------------------------------------------------------------------
# plain versions: the unfused composition, op for op, and the kernels'
# epilogue order
# ---------------------------------------------------------------------------
def _attention(x, nw, wq, wk, wv, sin, cos, k_pool, v_pool, block_tables,
               seq_lens, kv_scales, eps, mm):
    """The attention of a decode block up to the attention rows: (attn
    [B, H*hd] in x's type, k_new, v_new [B, KV, hd]), with the q/k/v
    products of ``mm``. Writes the new token's K/V into the pools first
    (in place), as the JAX version does; int8 pools (``kv_scales``) through
    the quantizing write and the dequantizing attention. That is also the
    kernels' order over int8 pools: pages dequantized to f32 (never to x's
    type), the new token quantized and dequantized in f32 (the pool
    round trip) before its score and its P.V term."""
    from .. import rms_norm
    from ..paged_attention import (paged_attention_decode,
                                   paged_attention_decode_quant,
                                   write_to_pool, write_to_pool_quant)
    from ..rope import apply_rope
    B, D = x.shape
    _, _, KV, hd = k_pool.shape
    H = _wq_parts(wq)[0].shape[1] // hd
    pos_ids = seq_lens[:, None]
    h = rms_norm(x[:, None], nw, eps)[:, 0]
    q = mm(h, wq).reshape(B, 1, H, hd)
    k = mm(h, wk).reshape(B, 1, KV, hd)
    v = mm(h, wv).reshape(B, 1, KV, hd)
    q = apply_rope(q, sin, cos, position_ids=pos_ids)
    k = apply_rope(k, sin, cos, position_ids=pos_ids)
    k_new, v_new = k[:, 0], v[:, 0]
    if kv_scales is None:
        write_to_pool(k_pool, v_pool, block_tables, seq_lens,
                      k_new.to(k_pool.dtype), v_new.to(v_pool.dtype))
        attn = paged_attention_decode(q[:, 0], k_pool, v_pool, block_tables,
                                      seq_lens + 1)
    else:
        ks, vs = kv_scales
        write_to_pool_quant(k_pool, v_pool, block_tables, seq_lens, k_new,
                            v_new, ks, vs)
        attn = paged_attention_decode_quant(q[:, 0], k_pool, v_pool,
                                            block_tables, seq_lens + 1, ks,
                                            vs)
    return attn.reshape(B, H * hd).to(x.dtype), k_new, v_new


def attn_block_ref(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                   block_tables, seq_lens, kv_scales=None, eps=1e-6,
                   residual=True):
    """The attention half of a decode block as the unfused step runs it.

    x [B, D]; nw [D] at x's type; wq [D, H*hd], wk/wv [D, KV*hd],
    wo [H*hd, D] (tensors or quantized leaves, dequantized to x's type
    before their product); sin/cos: full rope tables [T, hd/2] f32; pools
    [N, BS, KV, hd]; block_tables [B, MB]; seq_lens [B]: tokens already in
    the pool (the new token goes at position seq_lens). Returns (x + o
    [B, D], or o alone when ``residual`` is False; k_new, v_new
    [B, KV, hd]). Like the JAX version it writes the new token's K/V into
    the pools before attending (in place here); the caller then makes the
    same write, so the pools end equal either way. ``kv_scales``:
    (k_scale, v_scale) [KV] f32 for int8 pools (the JAX composition's
    ``write_to_pool_quant`` and ``paged_attention_decode_quant``)."""
    attn, k_new, v_new = _attention(x, nw, wq, wk, wv, sin, cos, k_pool,
                                    v_pool, block_tables, seq_lens,
                                    kv_scales, eps, _deq_mm)
    o = _deq_mm(attn, wo)
    return (x + o if residual else o), k_new, v_new


def mlp_block_ref(x, nw, wg, wu, wd, eps=1e-6, residual=True):
    """The MLP half of a decode block as the unfused step runs it:
    x [B, D], nw [D] at x's type, wg/wu [D, F], wd [F, D] (tensors or
    quantized leaves, dequantized first) ->
    x + down(silu(h @ wg) * (h @ wu)), or the product alone when
    ``residual`` is False."""
    from .. import rms_norm, swiglu
    h = rms_norm(x[:, None], nw, eps)[:, 0]
    o = _deq_mm(swiglu(_deq_mm(h, wg), _deq_mm(h, wu)), wd)
    return x + o if residual else o


def attn_block_wq_ref(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                      block_tables, seq_lens, kv_scales=None, eps=1e-6,
                      residual=True):
    """:func:`attn_block_ref`'s contract in decode_attn_block's epilogue
    order (the JAX ``_attn_block_kernel``'s): each q/k/v product ``dot(h,
    q) * s`` in f32, cast to x's type before RoPE; ``o = dot(attn, q) *
    s`` cast to x's type, then the residual add. The kernel's plain
    version for quantized weights and int8 pools (:func:`_attention`)."""
    attn, k_new, v_new = _attention(x, nw, wq, wk, wv, sin, cos, k_pool,
                                    v_pool, block_tables, seq_lens,
                                    kv_scales, eps, _epi_mm)
    o = _f32mm(attn, wo).to(x.dtype)
    return (x + o if residual else o), k_new, v_new


def mlp_block_wq_ref(x, nw, wg, wu, wd, eps=1e-6, residual=True):
    """:func:`mlp_block_ref`'s contract in decode_mlp_block's epilogue
    order (the JAX ``_mlp_block_kernel``'s): g and u as ``dot(h, q) * s``
    cast to x's type, SwiGLU in x's type, ``down = dot(ff, q) * s`` over
    all of F cast to x's type, then the residual add."""
    from .. import rms_norm, swiglu
    dt = x.dtype
    h = rms_norm(x[:, None], nw, eps)[:, 0]
    ff = swiglu(_f32mm(h, wg).to(dt), _f32mm(h, wu).to(dt))
    o = _f32mm(ff, wd).to(dt)
    return x + o if residual else o


def decode_block_ref(x, nw, wq, wk, wv, wo, pw, wg, wu, wd, sin, cos,
                     k_pool, v_pool, block_tables, seq_lens, kv_scales=None,
                     eps=1e-6):
    """One whole decoder layer at the single-launch kernel's rounding
    points (the JAX ``_block_fused_kernel``'s): the attention as
    :func:`attn_block_wq_ref` runs it up to the attention rows in x's
    type T; ``o = attn @ wo`` summed and kept in f32; ``resid = f32(x) +
    o`` (f32); the post-norm of that f32 row cast to T, times ``pw``; gate
    and up f32 products cast to T; ``silu(g) * u`` in T; down summed in
    f32; ``x_out = T(resid + down)``. A quantized leaf's scale multiplies
    its f32 product (the epilogue). Returns (x_out [B, D], k_new, v_new
    [B, KV, hd]); writes the new token's K/V into the pools first, as
    :func:`attn_block_ref` does (int8 pools as :func:`_attention` reads
    them)."""
    import torch.nn.functional as F
    dt = x.dtype
    attn, k_new, v_new = _attention(x, nw, wq, wk, wv, sin, cos, k_pool,
                                    v_pool, block_tables, seq_lens,
                                    kv_scales, eps, _epi_mm)
    resid = x.float() + _f32mm(attn, wo)
    ms = torch.mean(torch.square(resid), dim=-1, keepdim=True)
    h = (resid * torch.rsqrt(ms + eps)).to(dt) * pw
    g = _f32mm(h, wg).to(dt)
    u = _f32mm(h, wu).to(dt)
    down = _f32mm(F.silu(g) * u, wd)
    return (resid + down).to(dt), k_new, v_new


def decode_block_composed(x, nw, wq, wk, wv, wo, pw, wg, wu, wd, sin, cos,
                          k_pool, v_pool, block_tables, seq_lens,
                          kv_scales=None, eps=1e-6):
    """``decode_block_fused``'s priority-0 variant: the exact two-stage
    sequence, each stage dispatched through the registry (on the card the
    two CUDA kernels, on the CPU the compositions), so it is the two-stage
    route it stands in for, bit for bit. The MLP stage reads no pool
    state, so running it before the caller's pool write is the same math
    as the interleaved two-stage order."""
    B, D = x.shape
    _, BS, KV, hd = k_pool.shape
    # q_proj's and gate's output axes are never packed
    meta = decode_meta_dims(B, D, _wq_parts(wq)[0].shape[1] // hd, KV, hd,
                            _wq_parts(wg)[0].shape[1], BS,
                            block_tables.shape[1], x.dtype, k_pool.dtype,
                            kv_scales is not None,
                            weight_dtype=weight_dtype_of(
                                wq, wk, wv, wo, wg, wu, wd),
                            device=x.device)
    attn_fn, mlp_fn, _ = resolve_decode_blocks(meta, "auto")
    xo, k_new, v_new = attn_fn(x, nw, wq, wk, wv, wo, sin, cos, k_pool,
                               v_pool, block_tables, seq_lens, kv_scales,
                               eps)
    return mlp_fn(xo, pw, wg, wu, wd, eps), k_new, v_new


# ---------------------------------------------------------------------------
# shared-memory layout of the kernels (carved as csrc/block_products.cuh
# describes; the sizes are defined here only, for the prefill kernel too)
# ---------------------------------------------------------------------------
_ROWS = 8            # rows (sequences) a product sums per pass
_WARPS = 8           # warps a block (256 threads)
_MAX_LPR = 8         # lanes per weight row, at most
_PAGES_PER_STEP = 4  # KV pages an attention step streams
_SPLIT_PAGES = 8     # KV pages of one attention work item
_PAGE_STAGES = 2     # staged steps of the decode kernels' page stream


def _passes(B):
    return -(-B // _ROWS)


def _layout(D, rows, hd, BS, item, pool_item=None, page_stages=1):
    """(region, total) bytes: the region holds one pass of normalised rows
    [D][8] (or a staged chunk of a product's operand, or the f32 scratch
    and one staged step of K/V pages of one attention item of ``rows``
    query rows, 0 for none: ``attn_scratch_floats`` in
    csrc/paged_stream.cuh, the pages in the pool's type of ``pool_item``
    bytes, x's by default); then the per-warp partial sums and two result
    tiles of the widest column tile. ``page_stages`` staged steps (the
    decode kernels' split page stream stages two) may reach past the
    region into the products' tiles, which no attention phase uses: the
    total covers them, and the region, which sets the products' staged
    chunks, stays what one step needs."""
    attn = attn_all = 0
    if rows:
        sb = _PAGES_PER_STEP * BS
        f = 2 * rows * hd + rows * sb + 3 * rows + hd
        step = 2 * sb * hd * (pool_item or item)
        attn = -(-f // 4) * 4 * 4 + step
        attn_all = attn + (page_stages - 1) * step
    region = -(-max(_ROWS * D * item, attn) // 16) * 16
    tc = _MAX_LPR * (16 // item)
    return region, max(region + (_WARPS + 2) * tc * _ROWS * 4, attn_all)


def attn_smem_bytes(D, H, KV, hd, BS, itemsize, pool_itemsize=None) -> int:
    """Dynamic shared memory of one decode_attn_block block: 8 normalised
    rows of width D, or the attention scratch of one work item (two
    staged steps of pages in the pool's type, x's by default), whichever
    is larger, plus the products' reduction tiles. Independent of B."""
    return _layout(D, H // KV, hd, BS, itemsize, pool_itemsize,
                   _PAGE_STAGES)[1]


def mlp_smem_bytes(D, itemsize) -> int:
    """Dynamic shared memory of one decode_mlp_block block: 8 normalised
    rows of width D plus the reduction tiles. Independent of B."""
    return _layout(D, 0, 0, 0, itemsize)[1]


def block_smem_bytes(D, H, KV, hd, BS, itemsize, pool_itemsize=None) -> int:
    """Dynamic shared memory of one decode_block_fused block: the larger
    of its two halves' layouts, which is the attention half's (its region
    holds 8 normalised rows or an attention item's scratch). Independent
    of B; 86,016 B at LLaMA-7B bf16, fp or int8 pools. The weight-ring
    body's is :func:`ring_smem`."""
    return max(attn_smem_bytes(D, H, KV, hd, BS, itemsize, pool_itemsize),
               mlp_smem_bytes(D, itemsize))


# ---------------------------------------------------------------------------
# the launch plans: tile widths and counts, the cooperative grid, the spec
# ---------------------------------------------------------------------------
_SOURCE = "paddle_tpu_torch/csrc/fused_decode_block.cu"
#: blocks an SM each cooperative kernel is built for (its __launch_bounds__;
#: "_tc": the tensor-core body of decode_mlp_block / prefill_attn_block)
BOUNDS = {"decode_attn_block": 2, "decode_mlp_block": 2,
          "decode_block_fused": 1, "prefill_attn_block": 2,
          "decode_mlp_block_tc": 1, "prefill_attn_block_tc": 1,
          "decode_block_fused_ring": 1, "decode_attn_block_ring": 1,
          "decode_mlp_block_ring": 1}
#: the launchers' ctypes argument codes (pointers, ints, floats, then the
#: dtype code and the stream)
CALLS = {"decode_attn_block": _build.c_codes(25, 22, 2),
         "decode_mlp_block": _build.c_codes(12, 17, 1),
         "decode_block_fused": _build.c_codes(32, 28, 2)}
_GRID_QUERY = {"decode_attn_block": 0, "decode_mlp_block": 1,
               "decode_block_fused": 2, "decode_mlp_block_tc": 3,
               "decode_block_fused_ring": 4, "decode_attn_block_ring": 5,
               "decode_mlp_block_ring": 6}
_GRIDS = {}


def pick_lpr(ncols, vec, grid):
    """Lanes per weight row for a phase of ``ncols`` stored output columns
    of ``vec`` columns a lane, on ``grid`` blocks: the width (8, 4 or 2
    lanes, so a column tile of ``lanes * vec``) that gives the busiest
    block the fewest columns, the wider on a tie. The one definition of
    the tile choice of csrc/fused_decode_block.cu's and
    csrc/fused_prefill_block.cu's product phases."""
    best, best_cost = _MAX_LPR, None
    lpr = _MAX_LPR
    while lpr >= 2:
        tc = lpr * vec
        cost = -(-(-(-ncols // tc)) // grid) * tc
        if best_cost is None or cost < best_cost:
            best, best_cost = lpr, cost
        lpr //= 2
    return best


def assumed_grid(name, smem, bounds=None):
    """The cooperative grid a kernel gets on an H100: 132 SMs times the
    blocks an SM holds, its ``__launch_bounds__`` blocks or fewer where
    ``smem`` bytes a block (plus the card's 1 KB each) do not fit 228 KB.
    The plan of a capture over meta tensors; on the card the launcher's own
    occupancy query gives the grid (:func:`coop_grid`)."""
    per_sm = min(BOUNDS[name] if bounds is None else bounds,
                 _launch.SMEM_SM // (smem + _launch.SMEM_RESERVED))
    return _launch.H100_SMS * max(per_sm, 0)


def coop_grid(name, device, dtype, bits, kv_bits, smem, query=None):
    """The cooperative grid of kernel ``name`` for these arguments: on the
    meta device the H100's (:func:`assumed_grid`); on a card the launcher's
    occupancy query (``decode_coop_grid`` in the source), asked once per
    (kernel, types, shared memory, device) and cached, so a launch pays
    nothing for it."""
    if device.type == "meta":
        return assumed_grid(name, smem)
    key = (name, device.index, dtype, bits, kv_bits, smem)
    grid = _GRIDS.get(key)
    if grid is None:
        with torch.cuda.device(device):
            if query is None:
                fn = _build.c_fn("fused_decode_block", "decode_coop_grid",
                                 ("i",) * 5)
                grid = fn(_GRID_QUERY[name], _build.DTYPES[dtype], bits,
                          kv_bits, smem)
            else:
                grid = query(_build.DTYPES[dtype], bits, kv_bits, smem)
        if grid <= 0:
            raise RuntimeError(f"{name}: no cooperative grid at {smem} B of "
                               f"shared memory (cudaError {-grid})")
        _GRIDS[key] = grid
    return grid


def _stored(k, n, bits, out_packed=False):
    """(shape, dtype name) of a weight of logical shape [k, n] as the
    kernel reads it: T (dtype None), int8, or int4 packed two to a byte
    along k (or along n)."""
    if bits == 4:
        return ((k, n // 2) if out_packed else (k // 2, n)), "int8"
    return (k, n), "int8" if bits == 8 else None


def _op(name, shape, dtype, paged=None):
    return _launch.KernelOperand(name, tuple(int(s) for s in shape), dtype,
                                 paged)


def _const(nd):
    return lambda i: (0,) * nd


def _col(i):
    return (0, i)


def _vec(i):
    return (i,)


def attn_plan(nq, nkv, D, vec, grid):
    """The tile plan of an attention block's two product phases: lanes per
    row and tile counts of q/k/v (``q_tiles`` of wq, ``kv_tiles`` each of
    wk and wv) and of o_proj."""
    lpr = pick_lpr(nq + 2 * nkv, vec, grid)
    tc = lpr * vec
    o_lpr = pick_lpr(D, vec, grid)
    return {"qkv_lpr": lpr, "q_tiles": -(-nq // tc),
            "kv_tiles": -(-nkv // tc), "o_lpr": o_lpr,
            "o_tiles": -(-D // (o_lpr * vec))}


def mlp_plan(D, F, vec, bits, grid, floor_tile=None):
    """The tile plan of an MLP block's two phases: lanes per row and tile
    counts of gate/up (over F) and of down (over D's stored columns, half
    of them for int4 down_proj), and down's contraction depth ``down_k``.
    ``floor_tile``: the gate's regression specimen's plan, gate/up tiles
    of that many columns counted by floor division (``F // tile``) and a
    down phase over the ``(F // tile) * tile`` columns they wrote."""
    nst = D // 2 if bits == 4 else D
    dcols = vec // 2 if bits == 4 else vec
    if floor_tile is None:
        up_lpr = pick_lpr(F, vec, grid)
        up_tiles = -(-F // (up_lpr * vec))
        down_k = F
    else:
        up_lpr = floor_tile // vec
        up_tiles = F // floor_tile
        down_k = up_tiles * floor_tile
    down_lpr = pick_lpr(nst, dcols, grid)
    return {"up_lpr": up_lpr, "up_tiles": up_tiles, "down_lpr": down_lpr,
            "down_tiles": -(-nst // (down_lpr * dcols)), "down_k": down_k}


# ---------------------------------------------------------------------------
# the tensor-core bodies' plans (csrc/tile_mma.cuh): all rows of a row tile
# against each weight tile in one pass, 128 k a stage, 3 stages
# ---------------------------------------------------------------------------
TC_TILE_ROWS = 128   # rows a tile (a chunk's, at most)
TC_CHUNK_K = 128     # logical k a stage
TC_STAGES = 3
#: the tensor-core MLP body's column tiles: gate/up's (of each weight) and
#: down's (the source's kUpCols, kDownCols)
MLP_UP_COLS, MLP_DOWN_COLS = 64, 64
#: split K into at most this many parts (f32 partial sums added in part
#: order after one more grid barrier) where a phase has fewer tiles than
#: the grid has blocks
TC_MAX_PARTS = 8
#: decode_mlp_block takes its tensor-core body in bf16 from this many rows
#: on (the prefill MLP's chunks: 32 and 128 rows); below it the CUDA-core
#: body, whose passes of 8 rows read the weights once at 8 rows
MLP_TC_MIN_ROWS = 9
#: the weight classes of csrc/block_products.cuh
_WFP, _WINT8, _WINT4K, _WINT4N = 0, 1, 2, 3


def wclass(bits, out_packed=False):
    """A product's weight class under a kernel's weight bits."""
    return {8: _WINT8, 4: _WINT4N if out_packed else _WINT4K}.get(bits, _WFP)


def tile_smem_bytes(wc, nmat, tc):
    """tile_mma.cuh's ``tile_smem_bytes<WC, NMAT, TC>``: the A stages
    [3][128][136] bf16, then for each weight its raw stages and, quantized,
    a converted [128][tc + 8] bf16 tile."""
    a = TC_STAGES * TC_TILE_ROWS * (TC_CHUNK_K + 8) * 2
    rows = TC_CHUNK_K // 2 if wc == _WINT4K else TC_CHUNK_K
    cols = tc // 2 if wc == _WINT4N else tc
    ld = (tc + 8) * 2 if wc == _WFP else cols
    cvt = 0 if wc == _WFP else TC_CHUNK_K * (tc + 8) * 2
    return a + nmat * (TC_STAGES * rows * ld + cvt)


def mlp_tc_smem(bits):
    """Shared memory of decode_mlp_block's tensor-core body (the source's
    ``mlp_tc_smem``): gate/up's two weights or down's one, the larger."""
    return max(tile_smem_bytes(wclass(bits), 2, MLP_UP_COLS),
               tile_smem_bytes(wclass(bits, True), 1, MLP_DOWN_COLS))


def mlp_body(B, D, F, dt, floor_tile=None, bits=0):
    """(body, reason): which body of decode_mlp_block a launch runs, the
    rule its plan records. "ring" (csrc/weight_ring.cuh) for bf16 at up to
    RING_MAX_ROWS rows where gate/up and down pass the ring's width test
    (:func:`ring_width_reason` in weight class ``bits``); "tc"
    (csrc/tile_mma.cuh on the tensor cores) for bf16 from MLP_TC_MIN_ROWS
    rows on, with D a multiple of 32 and F of 16 (16-byte copies of every
    class's rows and tiles); "cuda_core" (the 8-row passes) otherwise, and
    for the gate's specimen."""
    if floor_tile is not None:
        return "cuda_core", "the gate's specimen runs the CUDA-core plan"
    if dt != "bfloat16":
        return "cuda_core", (f"{dt}: the ring and tensor-core bodies are "
                             "bf16 only")
    if B <= RING_MAX_ROWS:
        why = ring_width_reason(bits, D, 0, 0, F, MLP_RING_PHASES)
        if why:
            return "cuda_core", why
        return "ring", _ring_reason(B, bits)
    if B < MLP_TC_MIN_ROWS:
        return "cuda_core", (f"{B} rows < {MLP_TC_MIN_ROWS}: one pass of 8 "
                             "rows reads the weights once")
    if D % 32 or F % 16:
        return "cuda_core", (f"D {D} not a multiple of 32 or F {F} of 16: "
                             "the tile copies need both")
    return "tc", f"{B} rows >= {MLP_TC_MIN_ROWS} in bf16"


def tc_parts(items, grid, chunks):
    """The parts a tensor-core phase of ``items`` (row tile, column tile)
    items splits K's ``chunks`` into: as many as the grid has room for,
    at most TC_MAX_PARTS and ``chunks``, at least 1."""
    return max(1, min(TC_MAX_PARTS, chunks, grid // max(items, 1)))


def part_rows(K, parts, packed=False):
    """Stored weight rows of one part of a K split into ``parts`` (the
    tile_mma.cuh ranges: ceil(chunks / parts) chunks of 128 k; int4 packed
    along K: 64 stored rows a chunk)."""
    per_chunk = TC_CHUNK_K // 2 if packed else TC_CHUNK_K
    kn = K // 2 if packed else K
    return -(-(-(-kn // per_chunk)) // parts) * per_chunk


def mlp_tc_plan(B, D, F, bits, grid):
    """The tensor-core body's plan: row tiles of 128 rows, column tiles of
    F (gate/up, ``up_cols`` of each weight) and of D (down, ``down_cols``:
    half as many stored columns for int4, packed along D), down over F in
    ``down_parts`` parts (:func:`tc_parts` on ``grid``), k 128 a stage in
    3 stages."""
    rt, dt = -(-B // TC_TILE_ROWS), -(-D // MLP_DOWN_COLS)
    return {"body": "tc", "row_tiles": rt, "rows_tile": TC_TILE_ROWS,
            "up_cols": MLP_UP_COLS, "down_cols": MLP_DOWN_COLS,
            "up_lpr": 0, "up_tiles": -(-F // MLP_UP_COLS), "down_lpr": 0,
            "down_tiles": dt, "down_k": F,
            "down_parts": tc_parts(rt * dt, grid, -(-F // TC_CHUNK_K)),
            "k_chunk": TC_CHUNK_K, "stages": TC_STAGES}


# ---------------------------------------------------------------------------
# the single-launch kernel's weight-ring body (csrc/weight_ring.cuh): bf16
# activations, bf16, int8 or int4 weights, at most 8 rows; every product
# phase's weights (the stored codes, for int8 and int4) streamed through a
# ring of chunks in shared memory onto mma.sync
# ---------------------------------------------------------------------------
RING_COLS = 128      # stored columns a tile: 256 B of a bf16 weight row
RING_K = 64          # k rows a chunk of bf16 weights (16 KB)
RING_QROWS = 128     # stored rows a chunk of int8 / int4 codes (16 KB)
RING_STAGES = 4      # chunks in the ring (three in flight)
RING_LDW = RING_COLS + 8
RING_STAGE_BYTES = RING_K * RING_LDW * 2 + RING_K * _ROWS * 2
RING_AUX = 512       # the RMSNorm's per-warp sums and the ticket flag
RING_MAX_PARTS = 4
#: decode_block_fused takes the ring body in bf16 up to this many rows (one
#: pass of the 8-row activation operand)
RING_MAX_ROWS = _ROWS
#: the ring's product phases, in the kernels' order (their plans' keys):
#: decode_block_fused runs all four, decode_attn_block the first two and
#: decode_mlp_block the last two
RING_PHASES = ("qkv", "o_proj", "gate_up", "down")
ATTN_RING_PHASES, MLP_RING_PHASES = RING_PHASES[:2], RING_PHASES[2:]
#: the single-launch ring's attention teams (the source's kRingTeams):
#: kThreads / RING_TEAMS threads take a page item each
RING_TEAMS = 2
#: decode_attn_block's ring, over int8 pools only, runs its page and
#: combine phases in this many teams (the source's kAttnRingTeams)
ATTN_RING_TEAMS = 4


def _ring_shapes(D, nq, nkv, F):
    """Each ring phase's (logical columns of each slot, K, paired, packed
    along the output under int4): q, k and v concatenated; gate and up
    paired over F; int4 down packed along its output columns."""
    return {"qkv": ((nq, nkv, nkv), D, False, False),
            "o_proj": ((D,), nq, False, False),
            "gate_up": ((F, F), D, True, False),
            "down": ((D,), F, False, True)}


def ring_width_reason(bits, D, nq, nkv, F, phases=RING_PHASES):
    """Why the weight ring cannot run ``phases`` at these widths in weight
    class ``bits``, or None: the one width test of the three ring bodies
    (the source's ``ring_phase_ok``). Each phase's stored rows of K (K / 2
    for int4 packed along K) must be a whole number of chunks
    (:func:`ring_rows`: 64 of bf16, RING_QROWS of codes) and each stored
    row of each weight (N / 2 for int4 down, packed along its columns)
    whole 16-byte copies."""
    rows, esz = ring_rows(bits), 1 if bits else 2
    for name in phases:
        ns, K, _, out_packed = _ring_shapes(D, nq, nkv, F)[name]
        wc = wclass(bits, out_packed)
        kn = K // 2 if wc == _WINT4K else K
        if K < 1 or (wc == _WINT4K and K % 2) or kn % rows:
            return (f"{name}: {kn} stored rows of K {K} not a multiple of "
                    f"{rows} (the ring's chunk, weight bits {bits})")
        for n in ns:
            st = n // 2 if wc == _WINT4N else n
            if n < 1 or (wc == _WINT4N and n % 2) or (st * esz) % 16:
                return (f"{name}: {st} stored columns of {n} not whole "
                        f"16-byte copies (weight bits {bits})")
    return None


def _ring_reason(B, bits):
    cls = {8: "int8", 4: "int4"}.get(bits, "bf16")
    return f"{cls} weights at {B} <= {RING_MAX_ROWS} rows: the weight ring"


def ring_rows(bits):
    """Stored rows a ring chunk holds under the weight bits: 64 of bf16,
    RING_QROWS of int8 or int4 codes (16 KB of a tile of 128 stored
    columns in every class)."""
    return RING_QROWS if bits else RING_K


def ring_stage_bytes(bits):
    """One stage of the ring (the source's ``RingGeom<WQ>::stage``): the
    staged weight rows (bf16 rows padded by 8; code rows unpadded,
    swizzled), then the staged activation rows [rows][8] bf16 (two ranges
    of them for int4 packed along K)."""
    if not bits:
        return RING_STAGE_BYTES
    return (RING_QROWS * RING_COLS
            + (2 if bits == 4 else 1) * RING_QROWS * _ROWS * 2)


def ring_parts(tiles, chunks, grid, max_parts=RING_MAX_PARTS):
    """The parts a weight-ring phase of ``tiles`` column tiles splits K's
    ``chunks`` chunks into: the fewest chunks for the busiest block of
    ``grid`` (``ceil(tiles * parts / grid) * ceil(chunks / parts)``),
    the fewer parts on a tie; never a part that starts past K."""
    best, cost = 1, None
    for p in range(1, min(max_parts, chunks) + 1):
        per = -(-chunks // p)
        if (p - 1) * per >= chunks:
            continue
        c = -(-tiles * p // grid) * per
        if cost is None or c < cost:
            best, cost = p, c
    return best


def block_body(B, D, H, KV, hd, F, dt, bits):
    """(body, reason): which body of decode_block_fused a launch runs, the
    rule its plan records. "ring" (csrc/weight_ring.cuh) for bf16 at up to
    8 rows where all four product phases pass the ring's width test
    (:func:`ring_width_reason`: bf16 weights with D, F and H * hd multiples
    of RING_K and KV * hd of 8; int8 or int4 weights with every phase's
    stored rows a multiple of RING_QROWS, D and H * hd halved for int4
    along K, and every stored row whole 16-byte copies). "cuda_core"
    (block_products.cuh's passes of 8 rows) otherwise: f32, more than 8
    rows, ragged widths."""
    if dt != "bfloat16":
        return "cuda_core", f"{dt}: the weight-ring body is bf16 only"
    if B > RING_MAX_ROWS:
        return "cuda_core", (f"{B} rows > {RING_MAX_ROWS}: the ring runs one "
                             "pass of 8 rows")
    why = ring_width_reason(bits, D, H * hd, KV * hd, F)
    if why:
        return "cuda_core", why
    return "ring", _ring_reason(B, bits)


#: why decode_attn_block's ring body is not built over bf16 pools
ATTN_RING_FP_POOLS = (
    "bf16 pools: the ring body runs over int8 pools only; over bf16 pools "
    "its page phase at one block an SM (~80 us at LLaMA-7B widths, 8 rows) "
    "takes longer than the CUDA-core body's at two blocks an SM (~60-64) "
    "by more than the ring saves on q/k/v and o_proj: measured slower in "
    "every bf16-pool class (NVIDIA H100, PERF.md section 6)")
#: why it keeps the CUDA-core body for bf16 weights on a narrow shard
ATTN_RING_SHARD = (
    "int8 pools, bf16 weights, H * hd <= D / 4 (a tp=4 shard's heads): "
    "measured slower on the ring than on the CUDA-core body at LLaMA-7B's "
    "tp=4 shard (NVIDIA H100, PERF.md section 6): the products shrink "
    "with the shard and the fewer page items leave the ring's teams idle; "
    "over int8 pools the ring pays with int8 or int4 weights, and with "
    "bf16 weights at full width and at a tp=2 shard")


def attn_ring_pays(bits, pool_item, nq, D):
    """Why decode_attn_block's ring body does not pay in this class, or
    None (the part of :func:`attn_body` its measurements decide, PERF.md
    section 6, ``tools/attn_body_ab.py``): over bf16 pools never (no such
    instance is built); over int8 pools with int8 or int4 weights, and
    with bf16 weights unless ``nq = H * hd`` is a quarter of D or less (a
    tp=4 shard)."""
    if pool_item != 1:
        return ATTN_RING_FP_POOLS
    if not bits and 4 * nq <= D:
        return ATTN_RING_SHARD
    return None


def attn_body(B, D, H, KV, hd, BS, pool_item, dt, bits):
    """(body, reason): which body of decode_attn_block a launch runs, the
    rule its plan records. "ring" (csrc/weight_ring.cuh, the kernel
    decode_attn_ring_kernel) for bf16 at up to RING_MAX_ROWS rows over
    int8 pools (``pool_item`` 1) where q/k/v and o_proj pass the ring's
    width test (:func:`ring_width_reason`), the ring is measured faster
    (:func:`attn_ring_pays`) and its shared memory (:func:`ring_smem`:
    the ring and ATTN_RING_TEAMS attention items) fits a block;
    "cuda_core" (block_products.cuh's passes of 8 rows) otherwise: f32,
    more than 8 rows, ragged widths, bf16 pools, and bf16 weights on a
    tp=4 shard's heads."""
    if dt != "bfloat16":
        return "cuda_core", f"{dt}: the weight-ring body is bf16 only"
    if B > RING_MAX_ROWS:
        return "cuda_core", (f"{B} rows > {RING_MAX_ROWS}: the ring runs one "
                             "pass of 8 rows")
    why = (ring_width_reason(bits, D, H * hd, KV * hd, 0, ATTN_RING_PHASES)
           or attn_ring_pays(bits, pool_item, H * hd, D))
    if why:
        return "cuda_core", why
    need = ring_smem(D, H, KV, hd, BS, pool_item, bits, ATTN_RING_TEAMS)
    if need > SMEM_LIMIT:
        return "cuda_core", (f"the ring and {ATTN_RING_TEAMS} attention "
                             f"items need {need} B of shared memory > "
                             f"{SMEM_LIMIT}")
    return "ring", _ring_reason(B, bits)


def ring_smem(D, H=0, KV=1, hd=0, BS=0, pool_item=0, bits=0,
              teams=RING_TEAMS):
    """Shared memory of a ring body (the source's ``ring_smem``): the ring
    (:func:`ring_stage_bytes` of the weight bits), the RMSNorm's sums and
    the flag, then one region for the resident normalised rows [D][8] or
    the attention scratch of ``teams`` items (the body's teams: RING_TEAMS
    for decode_block_fused, ATTN_RING_TEAMS for decode_attn_block; two
    staged steps of pages each, in the pool's type). decode_mlp_block's
    body has no attention: ``ring_smem(D, bits=bits)``."""
    sb = _PAGES_PER_STEP * BS
    g = H // KV
    f = 2 * g * hd + g * sb + 3 * g + hd
    attn = -(-f // 4) * 16 + _PAGE_STAGES * 2 * sb * hd * pool_item
    attn = -(-attn // 16) * 16
    return (RING_STAGES * ring_stage_bytes(bits) + RING_AUX
            + max(D * _ROWS * 2, teams * attn))


def ring_plan(B, D, H, KV, hd, F, grid, bits=0, phases=RING_PHASES):
    """A ring body's plan for the product ``phases`` it runs (all four for
    decode_block_fused, ATTN_RING_PHASES for decode_attn_block,
    MLP_RING_PHASES for decode_mlp_block): for each its stored column
    tiles of RING_COLS (q, k and v concatenated; gate and up paired over
    F; int4 down packs two output columns a stored column), its K's
    stored rows ``kn`` (K / 2 for int4 packed along K) in chunks of
    :func:`ring_rows`, its parts of K (:func:`ring_parts` on ``grid``:
    each item a column tile of one weight over one part), its items and
    tickets; and the workspaces: the f32 partials of the widest phase and
    one ticket per tile."""
    rows = ring_rows(bits)
    ct = lambda n: -(-n // RING_COLS)   # noqa: E731
    shapes = _ring_shapes(D, H * hd, KV * hd, F)
    plan = {"body": "ring", "ring_cols": RING_COLS, "ring_k": rows,
            "ring_stages": RING_STAGES, "grid": grid, "wbits": bits,
            "phases": tuple(phases)}
    part_ws = tickets = 0
    for name in phases:
        ns, K, paired, out_packed = shapes[name]
        wc = wclass(bits, out_packed)
        stored = [n // 2 if wc == _WINT4N else n for n in ns]
        kn = K // 2 if wc == _WINT4K else K
        tiles = [ct(n) for n in stored]
        chunks = -(-kn // rows)
        ticks = tiles[0] if paired else sum(tiles)
        parts = ring_parts(ticks * (2 if paired else 1), chunks, grid)
        ncols = ns[0] if paired else sum(ns)
        plan[name] = {"tiles": tiles, "parts": parts, "K": K, "kn": kn,
                      "part_rows": -(-chunks // parts) * rows,
                      "items": sum(tiles) * parts, "tickets": ticks,
                      "ncols": ncols, "paired": paired,
                      "stored_cols": stored}
        if parts * (2 if paired else 1) > 1:
            part_ws = max(part_ws, parts * (2 if paired else 1) * _ROWS
                          * ncols)
        tickets = max(tickets, ticks)
    plan["part_ws"], plan["tickets"] = part_ws, tickets
    return plan


def _ring_phases(B, D, plan, bits, extra, pages=(), out="down"):
    """A ring body's phases for the gate (``plan["phases"]``): each product
    phase's items read their weight's (part rows, RING_COLS) tile of stored
    rows and columns, slot-major then part-major; a quantized slot's part-0
    items also read its scales, and the ``out`` phase's part-0 items stand
    for the tile's last item, which writes x_out (the parts' f32 sums lie
    in a workspace the spec does not track); int4 down writes two column
    ranges a tile. ``extra``: phase -> the operands it reads whole (x [B,
    D], a norm weight [D]); ``pages``: the attention phases, after q/k/v."""
    A = _launch.Access
    half = bits == 4
    C = RING_COLS
    slots = {"qkv": (("wq", "sq"), ("wk", "sk"), ("wv", "sv")),
             "o_proj": (("wo", "so"),), "gate_up": (("wg", "sg"),
                                                    ("wu", "su")),
             "down": (("wd", "sd"),)}
    out_phases = []
    for name in plan["phases"]:
        ph = plan[name]
        rows, P = ph["part_rows"], ph["parts"]
        reads, first = [], 0
        for (w, sc), T in zip(slots[name], ph["tiles"]):
            reads.append(A(w, (rows, C),
                           lambda j, T=T: (j // T, j % T), first, T * P))
            if bits and name == "down" and half:
                reads += [A(sc, (1, C), lambda j: (0, j), first, T),
                          A(sc, (1, C), lambda j: (1, j), first, T)]
            elif bits:
                reads.append(A(sc, (C,), lambda j: (j,), first, T))
            first += T * P
        reads += [A(e, (B, D) if e == "x" else (D,),
                    (lambda i: (0, 0)) if e == "x" else (lambda i: (0,)),
                    0, 1) for e in extra.get(name, ())]
        writes = ()
        if name == out:
            T = ph["tiles"][0]
            writes = ((A("x_out", (B, 1, C), lambda j: (0, 0, j), 0, T),
                       A("x_out", (B, 1, C), lambda j: (0, 1, j), 0, T))
                      if half and name == "down" else
                      (A("x_out", (B, C), lambda j: (0, j), 0, T),))
        out_phases.append(_launch.KernelPhase(name, ph["items"],
                                              tuple(reads), writes))
        if name == "qkv":
            out_phases += list(pages)
    return out_phases


def _attn_parts(B, D, H, KV, hd, BS, MB, N, rope_rows, dt, bits, kv_bits,
                plan, x_out):
    """Operands and phases of the attention half (decode_attn_block, and
    the single-launch kernel's first four phases). ``x_out``: whether
    o_proj writes x_out (the single-launch kernel keeps its residual in
    a workspace)."""
    nq, nkv = H * hd, KV * hd
    vec = 16 // _ITEM[dt]
    pool_dt = "int8" if kv_bits else dt
    ins = [_op("x", (B, D), dt), _op("nw", (D,), dt)]
    for name, (k, n) in (("wq", (D, nq)), ("wk", (D, nkv)), ("wv", (D, nkv)),
                         ("wo", (nq, D))):
        shape, wdt = _stored(k, n, bits)
        ins.append(_op(name, shape, wdt or dt))
    if bits:
        ins += [_op("sq", (nq,), "float32"), _op("sk", (nkv,), "float32"),
                _op("sv", (nkv,), "float32"), _op("so", (D,), "float32")]
    ins += [_op("sin", (rope_rows, hd // 2), "float32", "rows"),
            _op("cos", (rope_rows, hd // 2), "float32", "rows"),
            _op("k_pool", (N, BS, KV, hd), pool_dt, "tokens"),
            _op("v_pool", (N, BS, KV, hd), pool_dt, "tokens")]
    if kv_bits:
        ins += [_op("k_scale", (KV,), "float32"),
                _op("v_scale", (KV,), "float32")]
    ins += [_op("block_tables", (B, MB), "int32", "pages"),
            _op("seq_lens", (B,), "int32")]
    outs = [_op("k_new", (B, KV, hd), dt), _op("v_new", (B, KV, hd), dt)]
    kn = D // 2 if bits == 4 else D
    kn_o = nq // 2 if bits == 4 else nq
    tc, tq, tk = plan["qkv_lpr"] * vec, plan["q_tiles"], plan["kv_tiles"]
    otc = plan["o_lpr"] * vec
    A = _launch.Access
    qkv_reads = [_launch.whole(ins[0]), _launch.whole(ins[1]),
                 A("wq", (kn, tc), _col, 0, tq),
                 A("wk", (kn, tc), _col, tq, tk),
                 A("wv", (kn, tc), _col, tq + tk, tk)]
    if bits:
        qkv_reads += [A("sq", (tc,), _vec, 0, tq),
                      A("sk", (tc,), _vec, tq, tk),
                      A("sv", (tc,), _vec, tq + tk, tk)]
    ns = -(-MB // _SPLIT_PAGES)

    def new_kv(i):
        return (i // KV, i % KV, 0)
    page_reads = [A("seq_lens", (B,), _const(1), 0, 1)]
    if kv_bits:
        page_reads += [A("k_scale", (KV,), _const(1), 0, 1),
                       A("v_scale", (KV,), _const(1), 0, 1)]
    o_reads = [A("wo", (kn_o, otc), _col)]
    if bits:
        o_reads.append(A("so", (otc,), _vec))
    o_writes = ()
    if x_out:
        outs.insert(0, _op("x_out", (B, D), dt))
        o_writes = (A("x_out", (B, otc), _col),)
    phases = [
        _launch.KernelPhase("qkv", tq + 2 * tk, tuple(qkv_reads)),
        _launch.KernelPhase(
            "pages", ns * B * KV, tuple(page_reads),
            (A("k_new", (1, 1, hd), new_kv, 0, B * KV),
             A("v_new", (1, 1, hd), new_kv, 0, B * KV))),
        _launch.KernelPhase("combine", B * KV),
        _launch.KernelPhase("o_proj", plan["o_tiles"], tuple(o_reads),
                            o_writes)]
    return ins, outs, phases


def _mlp_operands(B, D, F, dt, bits, x_name, norm_name):
    """The MLP half's operands (inputs, outputs); int4 down_proj writes
    each output row in two column ranges, [0, D/2) and [D/2, D): the spec
    sees the output (and its scale) as [B, 2, D/2]."""
    ins = []
    if x_name:
        ins.append(_op(x_name, (B, D), dt))
    ins.append(_op(norm_name, (D,), dt))
    for name, (k, n), out_packed in (("wg", (D, F), False),
                                     ("wu", (D, F), False),
                                     ("wd", (F, D), True)):
        shape, wdt = _stored(k, n, bits, out_packed)
        ins.append(_op(name, shape, wdt or dt))
    half = bits == 4
    if bits:
        ins += [_op("sg", (F,), "float32"), _op("su", (F,), "float32"),
                _op("sd", (2, D // 2) if half else (D,), "float32")]
    outs = [_op("x_out", (B, 2, D // 2) if half else (B, D), dt)]
    return ins, outs


def _mlp_parts(B, D, F, dt, bits, plan, x_name, norm_name):
    """Operands and phases of the MLP half (decode_mlp_block, and the
    single-launch kernel's last two phases; ``x_name`` None: its rows are
    the single-launch kernel's f32 residual workspace). int4 down_proj
    writes each output row in two column ranges, [0, D/2) and [D/2, D): the
    spec sees the output (and its scale) as [B, 2, D/2]."""
    vec = 16 // _ITEM[dt]
    ins, outs = _mlp_operands(B, D, F, dt, bits, x_name, norm_name)
    half = bits == 4
    kn = D // 2 if half else D
    tc = plan["up_lpr"] * vec
    tcs = plan["down_lpr"] * (vec // 2 if half else vec)
    A = _launch.Access
    up_reads = [_launch.whole(op) for op in ins[:1 + bool(x_name)]]
    up_reads += [A("wg", (kn, tc), _col), A("wu", (kn, tc), _col)]
    if bits:
        up_reads += [A("sg", (tc,), _vec), A("su", (tc,), _vec)]
    down_reads = [A("wd", (plan["down_k"], tcs), _col)]
    if half:
        down_writes = (A("x_out", (B, 1, tcs), lambda i: (0, 0, i)),
                       A("x_out", (B, 1, tcs), lambda i: (0, 1, i)))
        if bits:
            down_reads += [A("sd", (1, tcs), lambda i: (0, i)),
                           A("sd", (1, tcs), lambda i: (1, i))]
    else:
        down_writes = (A("x_out", (B, tcs), _col),)
        if bits:
            down_reads.append(A("sd", (tcs,), _vec))
    phases = [_launch.KernelPhase("gate_up", plan["up_tiles"],
                                  tuple(up_reads)),
              _launch.KernelPhase("down", plan["down_tiles"],
                                  tuple(down_reads), down_writes)]
    return ins, outs, phases


_ITEM = {"float32": 4, "bfloat16": 2}


@functools.lru_cache(maxsize=512)
def attn_spec(B, D, H, KV, hd, BS, MB, N, rope_rows, dt, bits, kv_bits,
              residual, grid, smem, body="cuda_core"):
    """The launch spec of decode_attn_block (cached by its arguments: the
    decode step builds it once per shape). ``body`` "ring": the weight-ring
    body's plan (:func:`ring_plan` of q/k/v and o_proj) and phases."""
    plan = attn_plan(H * hd, KV * hd, D, 16 // _ITEM[dt], grid)
    ins, outs, phases = _attn_parts(B, D, H, KV, hd, BS, MB, N, rope_rows,
                                    dt, bits, kv_bits, plan, True)
    bounds = "decode_attn_block"
    if body == "ring":
        plan = ring_plan(B, D, H, KV, hd, 0, grid, bits, ATTN_RING_PHASES)
        phases = _ring_phases(B, D, plan, bits, {"qkv": ("x", "nw")},
                              phases[1:3], "o_proj")
        bounds = "decode_attn_block_ring"
    else:
        plan["body"] = "cuda_core"
    plan["body_rule"] = attn_body(B, D, H, KV, hd, BS,
                                  1 if kv_bits else _ITEM[dt], dt, bits)[1]
    return _launch.KernelLaunchSpec(
        "decode_attn_block", "cuda", _SOURCE, (grid,), _THREADS,
        tuple(ins), tuple(outs), tuple(phases),
        (("decode_attn_block", CALLS["decode_attn_block"]),), dt,
        blocks_per_sm=BOUNDS[bounds], cooperative=True,
        dyn_smem=smem, params={"residual": bool(residual), "wbits": bits,
                               "kvbits": kv_bits}, plan=plan)


def _mlp_tc_parts(B, D, F, dt, bits, plan):
    """Operands and phases of decode_mlp_block's tensor-core body: the
    RMSNorm of every row, then gate/up and down by (row tile, column
    tile) items, the column fastest (down's: (row tile, part of F, column
    tile))."""
    ins, outs = _mlp_operands(B, D, F, dt, bits, "x", "nw")
    half = bits == 4
    R, tc, dc = TC_TILE_ROWS, plan["up_cols"], plan["down_cols"]
    tcs = dc // 2 if half else dc
    kn = D // 2 if half else D
    A = _launch.Access
    ut, dn, parts = plan["up_tiles"], plan["down_tiles"], plan["down_parts"]
    up_reads = [A("wg", (kn, tc), lambda i: (0, i % ut)),
                A("wu", (kn, tc), lambda i: (0, i % ut))]
    if bits:
        up_reads += [A("sg", (tc,), lambda i: (i % ut,)),
                     A("su", (tc,), lambda i: (i % ut,))]
    # down's items: (row tile, part of F, column tile), the column fastest
    down_reads = [A("wd", (part_rows(F, parts), tcs),
                    lambda i: ((i // dn) % parts, i % dn))]
    if half:
        down_writes = (A("x_out", (R, 1, tcs),
                         lambda i: (i // (dn * parts), 0, i % dn)),
                       A("x_out", (R, 1, tcs),
                         lambda i: (i // (dn * parts), 1, i % dn)))
        if bits:
            down_reads += [A("sd", (1, tcs), lambda i: (0, i % dn)),
                           A("sd", (1, tcs), lambda i: (1, i % dn))]
    else:
        down_writes = (A("x_out", (R, dc),
                         lambda i: (i // (dn * parts), i % dn)),)
        if bits:
            down_reads.append(A("sd", (dc,), lambda i: (i % dn,)))
    items = plan["row_tiles"] * parts * dn
    phases = [
        _launch.KernelPhase("norm", B, (A("x", (1, D), lambda i: (i, 0)),
                                        _launch.whole(ins[1], B))),
        _launch.KernelPhase("gate_up", plan["row_tiles"] * ut,
                            tuple(up_reads))]
    if parts == 1:
        phases.append(_launch.KernelPhase("down", items, tuple(down_reads),
                                          down_writes))
    else:
        # the parts' f32 sums, then the combine writes x_out whole (a
        # workspace the spec does not track lies between)
        phases += [_launch.KernelPhase("down", items, tuple(down_reads)),
                   _launch.KernelPhase("combine", 1, (),
                                       (_launch.whole(outs[0]),))]
    return ins, outs, phases


@functools.lru_cache(maxsize=512)
def mlp_spec(B, D, F, dt, bits, residual, grid, smem, floor_tile=None,
             body="cuda_core"):
    """The launch spec of decode_mlp_block (``floor_tile``: of the gate's
    regression specimen, :func:`demo_prefix_mlp_block_cuda`; ``body``:
    "tc" for the tensor-core body's plan, :func:`mlp_tc_plan`; "ring" for
    the weight-ring body's, :func:`ring_plan` of gate/up and down)."""
    if body == "tc":
        plan = mlp_tc_plan(B, D, F, bits, grid)
        ins, outs, phases = _mlp_tc_parts(B, D, F, dt, bits, plan)
    elif body == "ring":
        plan = ring_plan(B, D, 0, 1, 0, F, grid, bits, MLP_RING_PHASES)
        ins, outs = _mlp_operands(B, D, F, dt, bits, "x", "nw")
        phases = _ring_phases(B, D, plan, bits, {"gate_up": ("x", "nw")})
    else:
        plan = mlp_plan(D, F, 16 // _ITEM[dt], bits, grid, floor_tile)
        plan["body"] = "cuda_core"
        ins, outs, phases = _mlp_parts(B, D, F, dt, bits, plan, "x", "nw")
    plan["body_rule"] = mlp_body(B, D, F, dt, floor_tile, bits)[1]
    name = ("decode_mlp_block" if floor_tile is None
            else "demo_prefix_mlp_block")
    bounds = {"tc": "decode_mlp_block_tc",
              "ring": "decode_mlp_block_ring"}.get(body, "decode_mlp_block")
    return _launch.KernelLaunchSpec(
        name, "cuda", _SOURCE, (grid,), _THREADS, tuple(ins), tuple(outs),
        tuple(phases), (("decode_mlp_block", CALLS["decode_mlp_block"]),),
        dt, blocks_per_sm=BOUNDS[bounds], cooperative=True,
        dyn_smem=smem, params={"residual": bool(residual), "wbits": bits},
        plan=plan)


@functools.lru_cache(maxsize=512)
def block_spec(B, D, H, KV, hd, F, BS, MB, N, rope_rows, dt, bits, kv_bits,
               grid, smem, body="cuda_core"):
    """The launch spec of decode_block_fused: the attention half's phases
    (o_proj into the f32 residual workspace), then the MLP half's (gate/up
    over the post-norm of that residual, down into x_out). ``body`` "ring":
    the weight-ring body's plan (:func:`ring_plan`) and phases."""
    vec = 16 // _ITEM[dt]
    plan = attn_plan(H * hd, KV * hd, D, vec, grid)
    plan.update(mlp_plan(D, F, vec, bits, grid))
    ins, outs, phases = _attn_parts(B, D, H, KV, hd, BS, MB, N, rope_rows,
                                    dt, bits, kv_bits, plan, False)
    m_ins, m_outs, m_phases = _mlp_parts(B, D, F, dt, bits, plan, None, "pw")
    # the MLP weights follow wo (and their scales so's), as the launcher
    # takes them
    at = [op.name for op in ins].index("wo") + 1
    scales = [op for op in m_ins if op.name in ("sg", "su", "sd")]
    ins[at:at] = [op for op in m_ins if op not in scales]
    if bits:
        at = [op.name for op in ins].index("so") + 1
        ins[at:at] = scales
    if body == "ring":
        plan = ring_plan(B, D, H, KV, hd, F, grid, bits)
        phases = _ring_phases(B, D, plan, bits, {"qkv": ("x", "nw"),
                                                 "gate_up": ("pw",)},
                              phases[1:3])
        m_phases = []
        bounds = "decode_block_fused_ring"
    else:
        plan["body"] = "cuda_core"
        bounds = "decode_block_fused"
    plan["body_rule"] = block_body(B, D, H, KV, hd, F, dt, bits)[1]
    return _launch.KernelLaunchSpec(
        "decode_block_fused", "cuda", _SOURCE, (grid,), _THREADS,
        tuple(ins), tuple(m_outs + outs), tuple(phases + m_phases),
        (("decode_block_fused", CALLS["decode_block_fused"]),), dt,
        blocks_per_sm=BOUNDS[bounds], cooperative=True,
        dyn_smem=smem, params={"wbits": bits, "kvbits": kv_bits}, plan=plan)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------
_THREADS = 256


def _check_tensor(name, tname, t, x, want):
    if t.dtype != want:
        raise TypeError(f"{name}: {tname} is {t.dtype}, needs {want}")
    if t.device != x.device:
        raise ValueError(f"{name}: {tname} is on {t.device}, x on "
                         f"{x.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {tname} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {tname} is not 16-byte aligned")


def _check_common(name, x, tensors, dtype_of):
    _launch.check_device(name, x.device)
    if x.dtype not in _build.DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for tname, t in tensors.items():
        _check_tensor(name, tname, t, x, dtype_of.get(tname, x.dtype))


def _shape(name, tname, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                         f"needs {tuple(shape)}")


def _weights(name, x, leaves):
    """Check a block's weight leaves for a kernel and split them.
    ``leaves``: weight name -> (leaf, (in, out)), the leaf's logical
    shape; ``down_proj`` ("wd") is the one int4 leaf packed along its
    output axis, every other along its contraction axis. -> (bits,
    {name: tensor}, {name: scale or None}): the stored integers (or the
    plain tensors) and the f32 scales [out]."""
    bits = {_wq_parts(leaf)[2] for leaf, _ in leaves.values()}
    if len(bits) != 1:
        raise ValueError(f"{name}: the block's weights mix weight-quant "
                         f"modes (bit widths {sorted(bits)})")
    bits = bits.pop()
    ws, scales = {}, {}
    for wname, (leaf, (k, n)) in leaves.items():
        q, s, _, axis = _wq_parts(leaf)
        stored = (k, n)
        if bits == 4:
            want_axis = 1 if wname == "wd" else 0
            if axis != want_axis:
                raise ValueError(
                    f"{name}: int4 {wname} is packed along axis {axis}; "
                    f"the kernel reads it packed along axis {want_axis}")
            if (k, n)[want_axis] % 2:
                raise ValueError(f"{name}: packed-int4 {wname} needs an "
                                 f"even axis {want_axis}, got {(k, n)}")
            stored = (k, n // 2) if want_axis else (k // 2, n)
        _check_tensor(name, wname, q, x, torch.int8 if bits else x.dtype)
        _shape(name, wname, q, stored)
        if bits:
            _check_tensor(name, f"{wname} scale", s, x, torch.float32)
            _shape(name, f"{wname} scale", s, (n,))
        ws[wname], scales[wname] = q, s
    return bits, ws, scales


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pools(name, x, k_pool, kv_scales):
    """Check an attention kernel's pools against its ``kv_scales``: pools
    of x's type without scales, or int8 pools with (k_scale, v_scale), f32
    [KV] each. -> (the pools' dtype, their bits for the launcher: 0 for
    x's type, 8 for int8; k_scale, v_scale or None)."""
    int8 = k_pool.dtype == torch.int8
    if kv_scales is None:
        if int8:
            raise ValueError(f"{name}: int8 pools need kv_scales (the int8 "
                             "cache's per-head scales)")
        return x.dtype, 0, None, None
    if not int8:
        raise ValueError(f"{name}: kv_scales (the int8 cache) need int8 "
                         f"pools, got {k_pool.dtype}")
    ks, vs = kv_scales
    for tname, t in (("k_scale", ks), ("v_scale", vs)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"{name}: {tname} must be a contiguous f32 "
                            f"tensor on {x.device}")
        _shape(name, tname, t, (k_pool.shape[2],))
    return torch.int8, 8, ks, vs


def _count(fn, bits, body, kv_bits=None, residual=None):
    """One launch of ``fn``'s kernel, in weight class ``bits`` and body
    class ``body``; for the kernels that read the pools, in pool class
    ``kv_bits``; for the kernels with a ``residual`` flag, in residual
    class "full" (x + the product) or "partial" (the product alone: a
    tensor-parallel shard's part)."""
    classes = {"weight": {0: "fp", 8: "int8", 4: "int4"}[bits],
               "body": body}
    if kv_bits is not None:
        classes["pool"] = {0: "fp", 8: "int8"}[kv_bits]
    if residual is not None:
        classes["residual"] = "full" if residual else "partial"
    _launch.count(fn, **classes)


def _attn_leaves(x, wq, wk, wv, wo, KV, hd):
    """(H, the attention weights' leaves with their logical shapes)."""
    D = x.shape[1]
    wq_t = _wq_parts(wq)[0]
    H = wq_t.shape[1] // hd if wq_t.dim() == 2 else 0
    return H, {"wq": (wq, (D, H * hd)), "wk": (wk, (D, KV * hd)),
               "wv": (wv, (D, KV * hd)), "wo": (wo, (H * hd, D))}


def _mlp_leaves(x, wg, wu, wd):
    """(F, the MLP weights' leaves with their logical shapes)."""
    D = x.shape[1]
    wg_t = _wq_parts(wg)[0]
    F = wg_t.shape[1] if wg_t.dim() == 2 else 0
    return F, {"wg": (wg, (D, F)), "wu": (wu, (D, F)), "wd": (wd, (F, D))}


def decode_attn_block_cuda(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                           block_tables, seq_lens, kv_scales=None, eps=1e-6,
                           residual=True):
    """Launch the decode_attn_block kernel (the contract of
    :func:`attn_block_wq_ref`, minus its pool write) on PyTorch's current
    stream. Weights are tensors of x's type or quantized leaves (int8, or
    int4 packed along the contraction axis); pools of x's type, or int8
    with ``kv_scales``. Raises for anything the kernel does not take, and
    if the launch is refused. Never falls back."""
    name = "decode_attn_block_cuda"
    pool_dt, kv_bits, ks, vs = _pools(name, x, k_pool, kv_scales)
    _check_common(name, x, {
        "x": x, "nw": nw, "sin": sin, "cos": cos, "k_pool": k_pool,
        "v_pool": v_pool, "block_tables": block_tables,
        "seq_lens": seq_lens},
        {"sin": torch.float32, "cos": torch.float32, "k_pool": pool_dt,
         "v_pool": pool_dt, "block_tables": torch.int32,
         "seq_lens": torch.int32})
    B, D = x.shape
    N, BS, KV, hd = k_pool.shape
    H, leaves = _attn_leaves(x, wq, wk, wv, wo, KV, hd)
    MB = block_tables.shape[1] if block_tables.dim() == 2 else 0
    item = x.element_size()
    if H < 1 or H % KV:
        raise ValueError(f"{name}: H={H} is not a positive multiple of "
                         f"KV={KV}")
    if (hd * item) % 16 or (D * item) % 16 or hd % 16 and kv_bits:
        raise ValueError(f"{name}: head_dim {hd} and hidden {D} rows must "
                         "be multiples of 16 bytes (the load width), in "
                         "x's type and in the pools'")
    bits, w, sc = _weights(name, x, leaves)
    for tname, t, shp in (("nw", nw, (D,)),
                          ("v_pool", v_pool, k_pool.shape),
                          ("cos", cos, sin.shape),
                          ("block_tables", block_tables, (B, MB)),
                          ("seq_lens", seq_lens, (B,))):
        _shape(name, tname, t, shp)
    if sin.dim() != 2 or sin.shape[1] != hd // 2:
        raise ValueError(f"{name}: rope tables must be [T, {hd // 2}], got "
                         f"{tuple(sin.shape)}")
    dt = _launch.dtype_name(x.dtype)
    body, kernel, region, smem = _attn_setup(
        B, D, H, KV, hd, BS, item, k_pool.element_size(), dt, bits,
        _plan_constants())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory a block,"
                         f" over the card's {SMEM_LIMIT}")
    grid = coop_grid(kernel, x.device, x.dtype, bits, kv_bits, smem)
    spec = attn_spec(B, D, H, KV, hd, BS, MB, N, sin.shape[0], dt, bits,
                     kv_bits, bool(residual), grid, smem, body)
    x_out = torch.empty_like(x)
    k_new = torch.empty((B, KV, hd), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    # the kernel's workspaces (layout in csrc/fused_decode_block.cu): the
    # q/k/v rows and the k-major attention rows in x's type; the f32
    # partials of every (sequence, head, chunk of pages) and new-token
    # scores
    n_qkv = -(-B * (H + 2 * KV) * hd // 8) * 8
    ws_t = torch.empty(n_qkv + _passes(B) * _ROWS * H * hd, dtype=x.dtype,
                       device=x.device)
    n_part = B * H * -(-MB // _SPLIT_PAGES)
    ws_f = torch.empty(n_part * (2 + hd) + B * H, dtype=torch.float32,
                       device=x.device)
    pl = spec.plan
    ring = body == "ring"
    if not _launch.begin(spec, x.device):
        return x_out, k_new, v_new
    fn = _build.c_fn("fused_decode_block", *spec.calls[0])
    ring_ws = tickets = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ring:
            ring_ws = _ring_partials(x.device, pl["part_ws"], stream)
            tickets = _ring_tickets(x.device, pl["tickets"], stream)
        _count(decode_attn_block_cuda, bits, body, kv_bits, residual)
        err = fn(x.data_ptr(), nw.data_ptr(), *(w[k].data_ptr() for k in
                                                 ("wq", "wk", "wv", "wo")),
                 *(_ptr(sc[k]) for k in ("wq", "wk", "wv", "wo")),
                 sin.data_ptr(), cos.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), _ptr(ks), _ptr(vs),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 x_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 ws_t.data_ptr(), ws_f.data_ptr(), _ptr(ring_ws),
                 _ptr(tickets), B, D, H, KV, hd, BS, MB,
                 sin.shape[0], int(bool(residual)), region, smem, bits,
                 kv_bits, grid, *(pl.get(k, 0) for k in (
                     "qkv_lpr", "q_tiles", "kv_tiles", "o_lpr", "o_tiles")),
                 int(ring),
                 *(pl[p]["parts"] if ring else 1 for p in ATTN_RING_PHASES),
                 float(eps), 1.0 / math.sqrt(hd), _build.DTYPES[x.dtype],
                 stream)
    if err:
        raise RuntimeError("decode_attn_block launch failed: "
                           + fn.error_string(err).decode())
    return x_out, k_new, v_new


def decode_mlp_block_cuda(x, nw, wg, wu, wd, eps=1e-6, residual=True):
    """Launch the decode_mlp_block kernel (the contract of
    :func:`mlp_block_wq_ref`) on PyTorch's current stream. Weights are
    tensors of x's type or quantized leaves (int8, or int4: gate/up
    packed along the contraction axis, down along its output axis).
    Raises for anything the kernel does not take, and if the launch is
    refused. Never falls back."""
    return _mlp_launch("decode_mlp_block_cuda", decode_mlp_block_cuda, x, nw,
                       wg, wu, wd, eps, residual, None)


def _mlp_launch(name, wrapper, x, nw, wg, wu, wd, eps, residual,
                floor_tile):
    """decode_mlp_block's kernel under its plan (``floor_tile`` None) or
    under the gate's regression specimen's floor-divided one. The plan's
    rule (:func:`mlp_body`) picks the body: the weight ring at up to 8
    rows in bf16, the tensor-core one at chunk rows in bf16, the CUDA-core
    one otherwise; a failed build or launch raises, never falls back to
    another."""
    _check_common(name, x, {"x": x, "nw": nw}, {})
    B, D = x.shape
    F, leaves = _mlp_leaves(x, wg, wu, wd)
    item = x.element_size()
    if F < 1 or (F * item) % 16 or (D * item) % 16:
        raise ValueError(f"{name}: hidden {D} and intermediate {F} rows "
                         "must be multiples of 16 bytes (the load width)")
    bits, w, sc = _weights(name, x, leaves)
    _shape(name, "nw", nw, (D,))
    dt = _launch.dtype_name(x.dtype)
    body, kernel, region, smem = _mlp_setup(B, D, F, item, dt, bits,
                                            floor_tile, _plan_constants())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory a block,"
                         f" over the card's {SMEM_LIMIT}")
    grid = coop_grid(kernel, x.device, x.dtype, bits, 0, smem)
    spec = mlp_spec(B, D, F, dt, bits, bool(residual), grid, smem,
                    floor_tile, body)
    pl = spec.plan
    if body == "tc":
        # silu(g)*u [B][F], the normalised rows [B][D] (bf16), then down's
        # f32 partial sums [parts][B][D], 16-byte aligned (in bf16 elements)
        ws = -(-B * F // 8) * 8 + -(-B * D // 8) * 8
        ws += 2 * pl["down_parts"] * B * D if pl["down_parts"] > 1 else 0
    else:
        # silu(g)*u, k-major rows ([pass][F][8]; the ring's down stages it)
        ws = _passes(B) * _ROWS * F
    ring = body == "ring"
    out = torch.empty_like(x)
    ff_ws = torch.empty(ws, dtype=x.dtype, device=x.device)
    if not _launch.begin(spec, x.device):
        return out
    fn = _build.c_fn("fused_decode_block", *spec.calls[0])
    ring_ws = tickets = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ring:
            ring_ws = _ring_partials(x.device, pl["part_ws"], stream)
            tickets = _ring_tickets(x.device, pl["tickets"], stream)
        if floor_tile is None:
            _count(wrapper, bits, body, residual=residual)
        else:
            wrapper.launches += 1
        if ring:
            parts = tuple(pl[p]["parts"] for p in MLP_RING_PHASES)
        else:
            parts = (1, pl.get("down_parts", 1))
        err = fn(x.data_ptr(), nw.data_ptr(),
                 *(w[k].data_ptr() for k in ("wg", "wu", "wd")),
                 *(_ptr(sc[k]) for k in ("wg", "wu", "wd")),
                 out.data_ptr(), ff_ws.data_ptr(), _ptr(ring_ws),
                 _ptr(tickets), B, D, F, int(bool(residual)), region, smem,
                 bits, grid, {"cuda_core": 0, "tc": 1, "ring": 2}[body],
                 *(pl.get(k, 0) for k in ("up_lpr", "up_tiles", "down_lpr",
                                          "down_tiles")),
                 pl.get("down_k", F), pl.get("row_tiles", 0), *parts,
                 float(eps), _build.DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("decode_mlp_block launch failed: "
                           + fn.error_string(err).decode())
    return out


#: the column tile of the gate's regression specimen (bf16: 8 lanes of 8)
DEMO_TILE = 64


def demo_prefix_mlp_block_ref(x, nw, wg, wu, wd, eps=1e-6):
    """The plain version of :func:`demo_prefix_mlp_block_cuda`: the MLP
    block over the first ``(F // DEMO_TILE) * DEMO_TILE`` intermediate
    columns (:func:`mlp_block_ref` with wg, wu cut to those columns and wd
    to those rows)."""
    k = (wg.shape[1] // DEMO_TILE) * DEMO_TILE
    return mlp_block_ref(x, nw, wg[:, :k], wu[:, :k], wd[:k], eps)


def demo_prefix_mlp_block_cuda(x, nw, wg, wu, wd, eps=1e-6):
    """The kernel-geometry gate's regression specimen on the card: the
    decode_mlp_block kernel run under the PRE-FIX plan of the JAX
    package's ``demo_prefix_mlp_block`` (``paddle_tpu/analysis/
    kernel_catalog.py``), its tile count floor-divided: gate/up run
    ``F // DEMO_TILE`` column tiles and down contracts over the columns
    they wrote, so when DEMO_TILE does not divide F the last ``F %
    DEMO_TILE`` columns of wg and wu and rows of wd are never read, and the
    result is ``x + down(silu(g) * u)`` over the first columns only
    (:func:`demo_prefix_mlp_block_ref`). No workspace it does not write is
    read, so it is deterministic. bf16 only (8 lanes of 8 columns make the
    64-column tile; the f32 tiles are at most 32 wide), plain weights
    only. Counts its launches in ``.launches``; no runtime route or
    dispatch reaches it."""
    if x.dtype != torch.bfloat16 or wg.shape[1] < DEMO_TILE:
        raise ValueError(f"demo_prefix_mlp_block_cuda takes bf16 and F >= "
                         f"{DEMO_TILE}, got {x.dtype} and F={wg.shape[1]}")
    return _mlp_launch("demo_prefix_mlp_block_cuda",
                       demo_prefix_mlp_block_cuda, x, nw, wg, wu, wd, eps,
                       True, DEMO_TILE)


_launch.counted(demo_prefix_mlp_block_cuda)


def decode_block_fused_cuda(x, nw, wq, wk, wv, wo, pw, wg, wu, wd, sin, cos,
                            k_pool, v_pool, block_tables, seq_lens,
                            kv_scales=None, eps=1e-6):
    """Launch the decode_block_fused kernel (the contract of
    :func:`decode_block_ref`, minus its pool write) on PyTorch's current
    stream: one whole decoder layer, ``(x_out, k_new, v_new)``. Weights
    and pools as the two-stage kernels take them. Raises for anything the
    kernel does not take, and if the launch is refused. Never falls
    back."""
    name = "decode_block_fused_cuda"
    pool_dt, kv_bits, ks, vs = _pools(name, x, k_pool, kv_scales)
    _check_common(name, x, {
        "x": x, "nw": nw, "pw": pw, "sin": sin, "cos": cos,
        "k_pool": k_pool, "v_pool": v_pool, "block_tables": block_tables,
        "seq_lens": seq_lens},
        {"sin": torch.float32, "cos": torch.float32, "k_pool": pool_dt,
         "v_pool": pool_dt, "block_tables": torch.int32,
         "seq_lens": torch.int32})
    B, D = x.shape
    N, BS, KV, hd = k_pool.shape
    H, leaves = _attn_leaves(x, wq, wk, wv, wo, KV, hd)
    F, mlp = _mlp_leaves(x, wg, wu, wd)
    leaves.update(mlp)
    MB = block_tables.shape[1] if block_tables.dim() == 2 else 0
    item = x.element_size()
    if H < 1 or H % KV:
        raise ValueError(f"{name}: H={H} is not a positive multiple of "
                         f"KV={KV}")
    if F < 1 or (hd * item) % 16 or (D * item) % 16 or (F * item) % 16 \
            or hd % 16 and kv_bits:
        raise ValueError(f"{name}: head_dim {hd}, hidden {D} and "
                         f"intermediate {F} rows must be multiples of 16 "
                         "bytes (the load width), in x's type and in the "
                         "pools'")
    bits, w, sc = _weights(name, x, leaves)
    for tname, t, shp in (("nw", nw, (D,)), ("pw", pw, (D,)),
                          ("v_pool", v_pool, k_pool.shape),
                          ("cos", cos, sin.shape),
                          ("block_tables", block_tables, (B, MB)),
                          ("seq_lens", seq_lens, (B,))):
        _shape(name, tname, t, shp)
    if sin.dim() != 2 or sin.shape[1] != hd // 2:
        raise ValueError(f"{name}: rope tables must be [T, {hd // 2}], got "
                         f"{tuple(sin.shape)}")
    dt = _launch.dtype_name(x.dtype)
    body, kernel, region, smem = _block_setup(
        B, D, H, KV, hd, F, BS, item, k_pool.element_size(), dt, bits,
        _plan_constants())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory a block,"
                         f" over the card's {SMEM_LIMIT}")
    grid = coop_grid(kernel, x.device, x.dtype, bits, kv_bits, smem)
    spec = block_spec(B, D, H, KV, hd, F, BS, MB, N, sin.shape[0], dt, bits,
                      kv_bits, grid, smem, body)
    pl = spec.plan
    x_out = torch.empty_like(x)
    k_new = torch.empty((B, KV, hd), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    # the workspaces (layout in csrc/fused_decode_block.cu): the q/k/v
    # rows, the k-major attention rows and silu(g)*u rows in x's type; the
    # f32 attention partials and new-token scores, then the f32 residual;
    # the ring body's f32 partial sums and its tickets (kept zero between
    # launches): one buffer of each a stream, _ring_partials and
    # _ring_tickets
    n_qkv = -(-B * (H + 2 * KV) * hd // 8) * 8
    ws_t = torch.empty(n_qkv + _passes(B) * _ROWS * (H * hd + F),
                       dtype=x.dtype, device=x.device)
    n_part = B * H * -(-MB // _SPLIT_PAGES)
    n_f = -(-(n_part * (2 + hd) + B * H) // 4) * 4
    ws_f = torch.empty(n_f + B * D, dtype=torch.float32, device=x.device)
    order = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
    if not _launch.begin(spec, x.device):
        return x_out, k_new, v_new
    fn = _build.c_fn("fused_decode_block", *spec.calls[0])
    ring = body == "ring"
    ring_ws = tickets = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ring:
            ring_ws = _ring_partials(x.device, pl["part_ws"], stream)
            tickets = _ring_tickets(x.device, pl["tickets"], stream)
        _count(decode_block_fused_cuda, bits, body, kv_bits)
        err = fn(x.data_ptr(), nw.data_ptr(),
                 *(w[k].data_ptr() for k in order[:4]), pw.data_ptr(),
                 *(w[k].data_ptr() for k in order[4:]),
                 *(_ptr(sc[k]) for k in order), sin.data_ptr(),
                 cos.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _ptr(ks), _ptr(vs), block_tables.data_ptr(),
                 seq_lens.data_ptr(), x_out.data_ptr(), k_new.data_ptr(),
                 v_new.data_ptr(), ws_t.data_ptr(), ws_f.data_ptr(),
                 _ptr(ring_ws), _ptr(tickets), B, D, H,
                 KV, hd, F, BS, MB, sin.shape[0], region, smem, bits,
                 kv_bits, grid, *(pl.get(k, 0) for k in (
                     "qkv_lpr", "q_tiles", "kv_tiles", "o_lpr", "o_tiles",
                     "up_lpr", "up_tiles", "down_lpr", "down_tiles")),
                 int(ring),
                 *(pl[p]["parts"] if ring else 1 for p in RING_PHASES),
                 float(eps), 1.0 / math.sqrt(hd),
                 _build.DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("decode_block_fused launch failed: "
                           + fn.error_string(err).decode())
    return x_out, k_new, v_new


def _plan_constants():
    """The module's plan constants that a launch's body and shared memory
    follow and that the tools vary (chip_smoke.cuda_core_block, the
    variant and phase tools): part of the setup caches' keys."""
    return (RING_MAX_ROWS, MLP_TC_MIN_ROWS, RING_STAGES, RING_TEAMS,
            ATTN_RING_TEAMS, TC_STAGES, TC_CHUNK_K, MLP_UP_COLS,
            MLP_DOWN_COLS)


@functools.lru_cache(maxsize=512)
def _attn_setup(B, D, H, KV, hd, BS, item, pool_item, dt, bits, consts):
    """(body, kernel, region, shared memory) of a decode_attn_block launch
    at these arguments, cached by them and by the plan constants
    (``consts``, :func:`_plan_constants`), so a decode step decides once a
    shape."""
    body = attn_body(B, D, H, KV, hd, BS, pool_item, dt, bits)[0]
    region, smem = _layout(D, H // KV, hd, BS, item, pool_item,
                           _PAGE_STAGES)
    if body == "ring":
        return (body, "decode_attn_block_ring", region,
                ring_smem(D, H, KV, hd, BS, pool_item, bits,
                          ATTN_RING_TEAMS))
    return body, "decode_attn_block", region, smem


@functools.lru_cache(maxsize=512)
def _mlp_setup(B, D, F, item, dt, bits, floor_tile, consts):
    """(body, kernel, region, shared memory) of a decode_mlp_block launch,
    cached as :func:`_attn_setup`'s."""
    body = mlp_body(B, D, F, dt, floor_tile, bits)[0]
    if body == "tc":
        return body, "decode_mlp_block_tc", 0, mlp_tc_smem(bits)
    if body == "ring":
        return body, "decode_mlp_block_ring", 0, ring_smem(D, bits=bits)
    return (body, "decode_mlp_block", *_layout(D, 0, 0, 0, item))


@functools.lru_cache(maxsize=512)
def _block_setup(B, D, H, KV, hd, F, BS, item, pool_item, dt, bits,
                 consts):
    """(body, kernel, region, shared memory) of a decode_block_fused
    launch, cached as :func:`_attn_setup`'s."""
    body = block_body(B, D, H, KV, hd, F, dt, bits)[0]
    region, smem = _layout(D, H // KV, hd, BS, item, pool_item,
                           _PAGE_STAGES)
    if body == "ring":
        return (body, "decode_block_fused_ring", region,
                ring_smem(D, H, KV, hd, BS, pool_item, bits))
    return body, "decode_block_fused", region, smem


_TICKETS = {}
_PARTIALS = {}


def _ring_buffer(store, device, n, stream, make):
    """``store``'s buffer for (``device``, ``stream``), made (or grown) by
    ``make(n)`` when it holds fewer than ``n`` elements. Never while a
    CUDA graph captures on the stream: the graph would keep reading the
    old buffer, so the warm-up step on that stream sizes it first."""
    key = (device, stream)
    t = store.get(key)
    if t is None or t.numel() < n:
        if device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the weight ring's buffer for stream {stream:#x} needs {n} "
                f"elements, has {0 if t is None else t.numel()}, and a CUDA "
                "graph is capturing there: run the captured step once on "
                "the stream before capturing it (its warm-up)")
        t = store[key] = make(n)
    return t


def _ring_partials(device, n, stream):
    """The ring bodies' f32 partial sums for launches on ``stream`` of
    ``device`` (at least ``n`` floats: the parts of K of the widest phase
    of the launch asking), held as the tickets are (:func:`_ring_tickets`):
    one buffer a (device, stream), shared by the three ring kernels, whose
    launches on one stream run in turn; each launch writes the partials it
    reads. Grown when a launch needs more."""
    return _ring_buffer(_PARTIALS, device, n, stream, lambda m: torch.empty(
        max(m, 4096), dtype=torch.float32, device=device))


def _ring_tickets(device, n, stream):
    """The ring bodies' ticket counters for launches on ``stream`` (a
    stream handle) of ``device``: at least one int32 per tile of the
    widest phase of the launch asking (``n``), zeroed once; each launch
    leaves them zero (the last item of a tile sets its counter back), so
    they are kept across launches. One buffer a (device, stream), shared
    by decode_block_fused, decode_attn_block and decode_mlp_block (a
    tensor-parallel step's shards too, run in turn on one stream):
    launches on one stream run one after another, so no two launches in
    flight count into the same tickets, and the buffer is sized for the
    largest phase any of them has asked for. Grown (zeroed anew) when a
    launch needs more."""
    return _ring_buffer(_TICKETS, device, n, stream, lambda m: torch.zeros(
        max(m, 256), dtype=torch.int32, device=device))


def ring_buffers(device, stream):
    """The ring's partial sums and tickets for launches on ``stream`` of
    ``device`` (those present), the tickets zeroed anew: what a CUDA graph
    captured on that stream reads, which its owner keeps alive. A launch
    stopped mid-way would have left its tickets dirty."""
    key = (device, stream)
    tickets = _TICKETS.get(key)
    if tickets is not None:
        tickets.zero_()
    return tuple(t for t in (_PARTIALS.get(key), tickets) if t is not None)


# the launches by weight class, for the kernels that read the pools by
# pool class, for the two-stage kernels by residual class, and by body:
# "ring" (the weight ring, bf16 at up to 8 rows), "tc" (decode_mlp_block on
# the tensor cores, chunk rows in bf16) or "cuda_core" (the passes of 8 rows)
_WEIGHTS, _POOLS = ("fp", "int8", "int4"), ("fp", "int8")
_RESIDUAL = ("full", "partial")
_launch.counted(decode_attn_block_cuda, weight=_WEIGHTS, pool=_POOLS,
                residual=_RESIDUAL, body=("ring", "cuda_core"))
_launch.counted(decode_mlp_block_cuda, weight=_WEIGHTS, residual=_RESIDUAL,
                body=("tc", "cuda_core", "ring"))
_launch.counted(decode_block_fused_cuda, weight=_WEIGHTS, pool=_POOLS,
                body=("ring", "cuda_core"))


# ---------------------------------------------------------------------------
# dispatch metas and predicates
# ---------------------------------------------------------------------------
def decode_meta_dims(B, D, H, KV, hd, F, BS, MB, dtype, pool_dtype, quant,
                     tp=1, weight_dtype=None, device="cuda") -> dict:
    """Static dispatch metadata from raw dims: the one builder of
    everything the ``supports`` predicates read. ``device`` (a device
    type) takes the place of the JAX package's ``interpret``, and the
    card's shared-memory limit the place of its two VMEM budgets. ``tp``:
    the tensor-parallel degree. The tensor-parallel step passes the
    per-shard dims (H, KV, F of one shard) and its ``tp``, so a shard of
    a tp=N mesh is a shape class apart from a tp=1 model of the same
    local dims; the single-launch kernel refuses tp != 1. Every key is
    fixed when a serving engine is built, so its captured decode step
    (one CUDA graph) is keyed by the force pins alone
    (:data:`DECODE_KEY_FIELDS`, the registry's program-key declaration)."""
    return {
        "tp": int(tp),
        "B": int(B), "D": int(D), "H": int(H), "KV": int(KV),
        "hd": int(hd), "F": int(F), "BS": int(BS), "MB": int(MB),
        "dtype": _launch.dtype_name(dtype),
        "itemsize": torch.empty((), dtype=dtype).element_size(),
        "pool_dtype": _launch.dtype_name(pool_dtype),
        "pool_itemsize": torch.empty((), dtype=pool_dtype).element_size(),
        "quant": bool(quant),
        "weight_dtype": str(weight_dtype) if weight_dtype
        else _launch.dtype_name(dtype),
        "device": torch.device(device).type,
        "smem_limit": SMEM_LIMIT,
    }


def decode_meta(cfg, B, BS, MB, pool_dtype, quant, tp=1, weight_dtype=None,
                device="cuda") -> dict:
    """Static dispatch metadata for one decode step of model ``cfg``."""
    return decode_meta_dims(B, cfg.hidden_size, cfg.num_attention_heads,
                            cfg.num_key_value_heads, cfg.head_dim,
                            cfg.intermediate_size, BS, MB, cfg.dtype,
                            pool_dtype, quant, tp=tp,
                            weight_dtype=weight_dtype, device=device)


def _refusal(meta, wq_dims=()):
    """The reason every kernel refuses ``meta``, or None. ``wq_dims``: the
    dimensions int4 packs along, (name, value) pairs."""
    if meta["device"] != "cuda":
        return "plain composition on the CPU"
    if meta["dtype"] not in ("float32", "bfloat16"):
        return f"dtype {meta['dtype']} is not float32/bfloat16"
    if meta["weight_dtype"] not in (meta["dtype"], "int8", "int4"):
        return (f"weight dtype {meta['weight_dtype']} is neither the model "
                f"dtype nor int8/int4")
    why = _wq_even_reason(meta, wq_dims)
    if why:
        return why
    if meta["quant"]:
        if meta["pool_dtype"] != "int8":
            return (f"quant (the int8 cache's scales) needs int8 pools, got "
                    f"pool dtype {meta['pool_dtype']}")
    elif meta["pool_dtype"] == "int8":
        return "int8 pools without quant (the int8 cache's scales)"
    elif meta["pool_dtype"] != meta["dtype"]:
        return (f"pool dtype {meta['pool_dtype']} differs from the model "
                f"dtype {meta['dtype']}")
    if (meta["D"] * meta["itemsize"]) % 16:
        return f"hidden {meta['D']} rows not a multiple of 16 bytes"
    return None


def _smem_reason(need, limit, meta):
    if need > limit:
        return False, (f"needs {need} B of shared memory a block > the "
                       f"card's {limit}")
    wd = meta["weight_dtype"]
    return True, (f"fits shared memory ({need} of {limit} B)"
                  + (f", {wd} weights scaled in the epilogue"
                     if wd in ("int8", "int4") else "")
                  + (", int8 pools dequantized per head"
                     if meta["quant"] else ""))


def _attn_dims(meta):
    return (("hidden_size", meta["D"]),
            ("H*head_dim", meta["H"] * meta["hd"]))


def _attn_refusal(meta):
    """The reason an attention kernel (decode or prefill) refuses the
    shapes of ``meta`` before its shared memory is counted, or None."""
    why = _refusal(meta, _attn_dims(meta))
    if why:
        return why
    if meta["H"] % meta["KV"]:
        return "H not a multiple of KV"
    for item in (meta["itemsize"], meta["pool_itemsize"]):
        if (meta["hd"] * item) % 16:
            return (f"head_dim {meta['hd']} rows not a multiple of 16 bytes"
                    f" ({item}-byte elements)")
    return None


def _supports_attn(meta):
    why = _attn_refusal(meta)
    if why:
        return False, why
    return _smem_reason(attn_smem_bytes(meta["D"], meta["H"], meta["KV"],
                                        meta["hd"], meta["BS"],
                                        meta["itemsize"],
                                        meta["pool_itemsize"]),
                        meta["smem_limit"], meta)


def _supports_mlp(meta):
    why = _refusal(meta, (("hidden_size", meta["D"]),))
    if why:
        return False, why
    if (meta["F"] * meta["itemsize"]) % 16:
        return False, f"intermediate {meta['F']} rows not a multiple of 16 " \
                      "bytes"
    return _smem_reason(mlp_smem_bytes(meta["D"], meta["itemsize"]),
                        meta["smem_limit"], meta)


def _supports_block(meta):
    """The single-launch kernel's predicate, for Hopper. The TPU's
    (``_supports_block`` of the JAX package) is a VMEM envelope that both
    weight window sets must fit together, so it refuses bf16 at LLaMA-7B.
    Here the weights stream from device memory: what the kernel needs is
    the shared memory of the larger of its two halves' layouts
    (:func:`block_smem_bytes`) for one block, under the card's limit, so
    that every SM holds the one block of the cooperative grid the kernel
    is built for (``__launch_bounds__(256, 1)``: its merged phases spill
    at two blocks an SM; the launch sizes the grid from this kernel's
    occupancy). It carries over the reference's refusals: a head_dim that
    is not a multiple of 8, H not a multiple of KV, the rows the loads
    cannot align and odd int4 pack axes; int8 pools need their scales
    (``quant``); a tensor-parallel shard (tp != 1) runs the two-stage
    kernels, with the reference's reason."""
    why = _attn_refusal(meta)
    if why:
        return False, why
    if meta.get("tp", 1) != 1:
        return False, ("tensor-parallel decode runs the per-stage "
                       "kernels inside shard_map")
    if meta["hd"] % 8:
        return False, f"head_dim {meta['hd']} not a multiple of 8"
    if (meta["F"] * meta["itemsize"]) % 16:
        return False, (f"intermediate {meta['F']} rows not a multiple of "
                       "16 bytes")
    return _smem_reason(block_smem_bytes(meta["D"], meta["H"], meta["KV"],
                                         meta["hd"], meta["BS"],
                                         meta["itemsize"],
                                         meta["pool_itemsize"]),
                        meta["smem_limit"], meta)


def _supports_composition(meta):
    if meta["device"] == "cuda":
        return False, ("the composition is the CPU's route: on CUDA the "
                       "hand-written kernel must take the shapes")
    if meta["weight_dtype"] in ("int8", "int4"):
        return True, (f"plain composition on the CPU ({meta['weight_dtype']}"
                      " weights dequantized before each product)")
    return True, "plain composition on the CPU"


KERNELS.register("decode_attn_block", "cuda_fused", decode_attn_block_cuda,
                 priority=10, supports=_supports_attn)
KERNELS.register("decode_attn_block", "unfused", attn_block_ref, priority=0,
                 supports=_supports_composition)
KERNELS.register("decode_mlp_block", "cuda_fused", decode_mlp_block_cuda,
                 priority=10, supports=_supports_mlp)
KERNELS.register("decode_mlp_block", "unfused", mlp_block_ref, priority=0,
                 supports=_supports_composition)
# the single-launch op sits above the two-stage route: priority 10 is the
# kernel, priority 0 runs the exact two-stage sequence (on the card the
# two kernels), so it takes any meta
KERNELS.register("decode_block_fused", "cuda_block", decode_block_fused_cuda,
                 priority=10, supports=_supports_block)
KERNELS.register("decode_block_fused", "composed", decode_block_composed,
                 priority=0)
# every decode_meta_dims key is fixed when a serving engine is built (the
# shapes, the model's, the pools' and the weights' types, tp, the device,
# the card's shared memory) or is in its decode program's key (the force
# pins, ``KERNELS.forced_state()``): the DISPATCH_KEY_GAP lint holds the
# predicates to this declaration
DECODE_KEY_FIELDS = ("B", "D", "H", "KV", "hd", "F", "BS", "MB", "dtype",
                     "pool_dtype", "quant", "device", "tp", "weight_dtype",
                     "smem_limit")
DECODE_KEY_COVERS = {"itemsize": "dtype", "pool_itemsize": "pool_dtype"}
for _name in ("decode_attn_block", "decode_mlp_block", "decode_block_fused"):
    KERNELS.declare_cache_key(_name, DECODE_KEY_FIELDS,
                              covers=DECODE_KEY_COVERS)


def resolve_decode_blocks(meta: dict, mode="auto"):
    """The two decode-block ops for one step. ``mode``: "auto"/True/None
    dispatches through the registry (the CUDA kernels on CUDA tensors,
    raising with the predicate's reason if one refuses; the composition
    on the CPU); "pallas" forces the hand-written kernels (the JAX
    engine's name for the same knob); "ref" forces the composition.
    Returns (attn_fn, mlp_fn, {"attn": name, "mlp": name})."""
    if mode in ("auto", True, None):
        a_name, a_fn = KERNELS.dispatch("decode_attn_block", meta)
        m_name, m_fn = KERNELS.dispatch("decode_mlp_block", meta)
    elif mode in ("pallas", "ref"):
        a_name = m_name = "cuda_fused" if mode == "pallas" else "unfused"
        a_fn = KERNELS.variant("decode_attn_block", a_name).fn
        m_fn = KERNELS.variant("decode_mlp_block", m_name).fn
    elif mode == "block":
        raise ValueError(
            "fused_decode='block' selects the single-launch kernel: "
            "resolve it through resolve_decode_step")
    else:
        raise ValueError(f"fused_decode mode must be auto|pallas|ref|block,"
                         f" got {mode!r}")
    return a_fn, m_fn, {"attn": a_name, "mlp": m_name}


def resolve_decode_step(meta: dict, mode="auto"):
    """One decode step's kernels: ``(block_fn, attn_fn, mlp_fn,
    variants)`` (port of the JAX package's). Mode "block" forces the
    single-launch kernel; "auto"/True/None dispatch ``decode_block_fused``
    through the registry after the two stages (a refusing two-stage
    kernel on CUDA raises first, as there) and take the single-launch
    kernel when it wins. Then ``block_fn`` is the whole-layer function,
    the stage functions are None and every name is ``"cuda_block"``.
    Otherwise ``block_fn`` is None, the stages come from
    :func:`resolve_decode_blocks` and ``variants`` is ``{"block":
    "composed", "attn": ..., "mlp": ...}``."""
    block = {"block": "cuda_block", "attn": "cuda_block",
             "mlp": "cuda_block"}
    if mode == "block":
        return (KERNELS.variant("decode_block_fused", "cuda_block").fn,
                None, None, block)
    a_fn, m_fn, names = resolve_decode_blocks(meta, mode)
    if mode in ("auto", True, None):
        b_name, b_fn = KERNELS.dispatch("decode_block_fused", meta)
        if b_name == "cuda_block":
            return b_fn, None, None, block
    return None, a_fn, m_fn, {"block": "composed", **names}
