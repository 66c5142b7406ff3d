"""Fused decode-block kernels: the two CUDA kernels' wrappers, their
plain versions, the dispatch metas and predicates, and the resolvers
(port of ``paddle_tpu/ops/pallas/fused_decode_block.py``, two-stage route,
fp weights and fp pools).

- ``decode_attn_block`` (:func:`decode_attn_block_cuda`) replaces
  ``fused_attn_block_pallas``: RMSNorm + QKV + RoPE + paged attention with
  the new token folded in + o_proj + residual, in one launch.
- ``decode_mlp_block`` (:func:`decode_mlp_block_cuda`) replaces
  ``fused_mlp_block_pallas``: RMSNorm + gate/up + SwiGLU + down +
  residual, in one launch.

Both kernels are ``paddle_tpu_torch/csrc/fused_decode_block.cu`` (CUDA C++
for ``sm_90a``, built by :mod:`._build` at the first launch and bound with
ctypes); that file's header says what bounds them on the H100 and how
their design follows from it.

:func:`attn_block_ref` and :func:`mlp_block_ref` are the plain versions
and the registry's priority-0 ``"unfused"`` variants: op for op the
building blocks of ``inference.generation._paged_decode_step``, so a
decode step that dispatches them is bit-identical to the unfused step.
They run the port's RMSNorm and paged-attention kernels on CUDA tensors
and those kernels' plain versions on the CPU.

Dispatch differs from the TPU's on purpose. The TPU predicates refuse a
block whose weights do not fit the VMEM budget, which rejects the
attention kernel at LLaMA-7B bf16. The CUDA kernels stream their weights
from device memory, so what they need is shared memory for one pass of 8
normalised rows and the attention scratch (:func:`attn_smem_bytes`,
:func:`mlp_smem_bytes`: the one definition of the kernels' layout sizes,
passed to them at launch) under the card's 227 KB a block. That need
grows with the hidden width, not with the batch: at LLaMA-7B both
kernels are selected for any number of slots.

The composition is the CPU's route only. On CUDA tensors a predicate that
refuses the kernel makes dispatch raise with its reason: the decode step
never gives way to the composition on the card unless the caller asks
for it (``mode="ref"``, or a ``KERNELS.force`` pin).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .registry import KERNELS

__all__ = ["attn_block_ref", "mlp_block_ref", "decode_attn_block_cuda",
           "decode_mlp_block_cuda", "decode_meta", "decode_meta_dims",
           "attn_smem_bytes", "mlp_smem_bytes", "SMEM_LIMIT",
           "resolve_decode_blocks", "resolve_decode_step"]

#: dynamic shared memory one block of an H100 may use (232,448 bytes)
SMEM_LIMIT = 227 * 1024

_fns = {}

_NOT_PORTED_QUANT = "not ported: int8 cache / weight-quant slice"


# ---------------------------------------------------------------------------
# plain versions: the unfused composition, op for op
# ---------------------------------------------------------------------------
def attn_block_ref(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                   block_tables, seq_lens, kv_scales=None, eps=1e-6,
                   residual=True):
    """The attention half of a decode block as the unfused step runs it.

    x [B, D]; nw [D] at x's type; wq [D, H*hd], wk/wv [D, KV*hd],
    wo [H*hd, D]; sin/cos: full rope tables [T, hd/2] f32; pools
    [N, BS, KV, hd]; block_tables [B, MB]; seq_lens [B]: tokens already in
    the pool (the new token goes at position seq_lens). Returns (x + o
    [B, D], or o alone when ``residual`` is False; k_new, v_new
    [B, KV, hd]). Like the JAX version it writes the new token's K/V into
    the pools before attending (in place here); the caller then makes the
    same write, so the pools end equal either way."""
    from .. import rms_norm
    from ..paged_attention import paged_attention_decode, write_to_pool
    from ..rope import apply_rope
    if kv_scales is not None:
        raise NotImplementedError(f"kv_scales: {_NOT_PORTED_QUANT}")
    B, D = x.shape
    _, _, KV, hd = k_pool.shape
    H = wq.shape[1] // hd
    pos_ids = seq_lens[:, None]
    h = rms_norm(x[:, None], nw, eps)[:, 0]
    q = (h @ wq).reshape(B, 1, H, hd)
    k = (h @ wk).reshape(B, 1, KV, hd)
    v = (h @ wv).reshape(B, 1, KV, hd)
    q = apply_rope(q, sin, cos, position_ids=pos_ids)
    k = apply_rope(k, sin, cos, position_ids=pos_ids)
    k_new, v_new = k[:, 0], v[:, 0]
    write_to_pool(k_pool, v_pool, block_tables, seq_lens,
                  k_new.to(k_pool.dtype), v_new.to(v_pool.dtype))
    attn = paged_attention_decode(q[:, 0], k_pool, v_pool, block_tables,
                                  seq_lens + 1)
    o = attn.reshape(B, H * hd).to(x.dtype) @ wo
    return (x + o if residual else o), k_new, v_new


def mlp_block_ref(x, nw, wg, wu, wd, eps=1e-6, residual=True):
    """The MLP half of a decode block as the unfused step runs it:
    x [B, D], nw [D] at x's type, wg/wu [D, F], wd [F, D] ->
    x + down(silu(h @ wg) * (h @ wu)), or the product alone when
    ``residual`` is False."""
    from .. import rms_norm, swiglu
    h = rms_norm(x[:, None], nw, eps)[:, 0]
    o = swiglu(h @ wg, h @ wu) @ wd
    return x + o if residual else o


# ---------------------------------------------------------------------------
# shared-memory layout of the kernels (carved as csrc/block_products.cuh
# describes; the sizes are defined here only, for the prefill kernel too)
# ---------------------------------------------------------------------------
_ROWS = 8            # rows (sequences) a product sums per pass
_WARPS = 8           # warps a block (256 threads)
_MAX_LPR = 8         # lanes per weight row, at most
_PAGES_PER_STEP = 4  # KV pages an attention step streams
_SPLIT_PAGES = 8     # KV pages of one attention work item


def _passes(B):
    return -(-B // _ROWS)


def _layout(D, rows, hd, BS, item):
    """(region, total) bytes: the region holds one pass of normalised rows
    [D][8] (or a staged chunk of a product's operand, or the f32 scratch
    and K/V pages of one attention item of ``rows`` query rows, 0 for
    none: ``attn_scratch_floats`` in csrc/block_products.cuh); then the
    per-warp partial sums and two result tiles of the widest column
    tile."""
    attn = 0
    if rows:
        sb = _PAGES_PER_STEP * BS
        f = 2 * rows * hd + rows * sb + 3 * rows + hd
        attn = -(-f // 4) * 4 * 4 + 2 * sb * hd * item
    region = -(-max(_ROWS * D * item, attn) // 16) * 16
    tc = _MAX_LPR * (16 // item)
    return region, region + (_WARPS + 2) * tc * _ROWS * 4


def attn_smem_bytes(D, H, KV, hd, BS, itemsize) -> int:
    """Dynamic shared memory of one decode_attn_block block: 8 normalised
    rows of width D, or the attention scratch of one work item, whichever
    is larger, plus the products' reduction tiles. Independent of B."""
    return _layout(D, H // KV, hd, BS, itemsize)[1]


def mlp_smem_bytes(D, itemsize) -> int:
    """Dynamic shared memory of one decode_mlp_block block: 8 normalised
    rows of width D plus the reduction tiles. Independent of B."""
    return _layout(D, 0, 0, 0, itemsize)[1]


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------
def _lib_fn(name, nptr, nint, nfloat, source="fused_decode_block"):
    """The C launcher ``name`` of ``csrc/<source>.cu`` with its ctypes
    argtypes: pointers, ints, floats, then the dtype code and the stream."""
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(source)
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_float] * nfloat
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        fn.error_string = lib.cuda_error_string
        _fns[name] = fn
    return fn


def _check_common(name, x, tensors, dtype_of):
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype not in _build.DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for tname, t in tensors.items():
        want = dtype_of.get(tname, x.dtype)
        if t.dtype != want:
            raise TypeError(f"{name}: {tname} is {t.dtype}, needs {want}")
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} is not 16-byte aligned")


def _shape(name, tname, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                         f"needs {tuple(shape)}")


def decode_attn_block_cuda(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                           block_tables, seq_lens, kv_scales=None, eps=1e-6,
                           residual=True):
    """Launch the decode_attn_block kernel (the contract of
    :func:`attn_block_ref`, minus its pool write) on PyTorch's current
    stream. Raises for anything the kernel does not take, and if the
    launch is refused. Never falls back."""
    name = "decode_attn_block_cuda"
    if kv_scales is not None:
        raise NotImplementedError(f"{name}: kv_scales: {_NOT_PORTED_QUANT}")
    _check_common(name, x, {
        "x": x, "nw": nw, "wq": wq, "wk": wk, "wv": wv, "wo": wo,
        "sin": sin, "cos": cos, "k_pool": k_pool, "v_pool": v_pool,
        "block_tables": block_tables, "seq_lens": seq_lens},
        {"sin": torch.float32, "cos": torch.float32,
         "block_tables": torch.int32, "seq_lens": torch.int32})
    B, D = x.shape
    N, BS, KV, hd = k_pool.shape
    H = wq.shape[1] // hd if wq.dim() == 2 else 0
    MB = block_tables.shape[1] if block_tables.dim() == 2 else 0
    item = x.element_size()
    if H < 1 or H % KV:
        raise ValueError(f"{name}: H={H} is not a positive multiple of "
                         f"KV={KV}")
    if (hd * item) % 16 or (D * item) % 16:
        raise ValueError(f"{name}: head_dim {hd} and hidden {D} rows must "
                         "be multiples of 16 bytes (the load width)")
    for tname, t, shp in (("nw", nw, (D,)), ("wq", wq, (D, H * hd)),
                          ("wk", wk, (D, KV * hd)), ("wv", wv, (D, KV * hd)),
                          ("wo", wo, (H * hd, D)),
                          ("v_pool", v_pool, k_pool.shape),
                          ("cos", cos, sin.shape),
                          ("block_tables", block_tables, (B, MB)),
                          ("seq_lens", seq_lens, (B,))):
        _shape(name, tname, t, shp)
    if sin.dim() != 2 or sin.shape[1] != hd // 2:
        raise ValueError(f"{name}: rope tables must be [T, {hd // 2}], got "
                         f"{tuple(sin.shape)}")
    region, smem = _layout(D, H // KV, hd, BS, item)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory a block,"
                         f" over the card's {SMEM_LIMIT}")
    fn = _lib_fn("decode_attn_block", 17, 11, 2)
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        decode_attn_block_cuda.launches += 1
        err = fn(x.data_ptr(), nw.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                 wv.data_ptr(), wo.data_ptr(), sin.data_ptr(),
                 cos.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 x_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 ws_t.data_ptr(), ws_f.data_ptr(), B, D, H, KV, hd, BS,
                 MB, sin.shape[0], int(bool(residual)), region, smem,
                 float(eps),
                 1.0 / math.sqrt(hd), _build.DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("decode_attn_block launch failed: "
                           + fn.error_string(err).decode())
    return x_out, k_new, v_new


def decode_mlp_block_cuda(x, nw, wg, wu, wd, eps=1e-6, residual=True):
    """Launch the decode_mlp_block kernel (the contract of
    :func:`mlp_block_ref`) on PyTorch's current stream. Raises for
    anything the kernel does not take, and if the launch is refused.
    Never falls back."""
    name = "decode_mlp_block_cuda"
    _check_common(name, x, {"x": x, "nw": nw, "wg": wg, "wu": wu, "wd": wd},
                  {})
    B, D = x.shape
    F = wg.shape[1] if wg.dim() == 2 else 0
    item = x.element_size()
    if F < 1 or (F * item) % 16 or (D * item) % 16:
        raise ValueError(f"{name}: hidden {D} and intermediate {F} rows "
                         "must be multiples of 16 bytes (the load width)")
    for tname, t, shp in (("nw", nw, (D,)), ("wg", wg, (D, F)),
                          ("wu", wu, (D, F)), ("wd", wd, (F, D))):
        _shape(name, tname, t, shp)
    region, smem = _layout(D, 0, 0, 0, item)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory a block,"
                         f" over the card's {SMEM_LIMIT}")
    fn = _lib_fn("decode_mlp_block", 7, 6, 1)
    out = torch.empty_like(x)
    # silu(g)*u, k-major rows ([pass][F][8], csrc/fused_decode_block.cu)
    ff_ws = torch.empty(_passes(B) * _ROWS * F, dtype=x.dtype,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        decode_mlp_block_cuda.launches += 1
        err = fn(x.data_ptr(), nw.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                 wd.data_ptr(), out.data_ptr(), ff_ws.data_ptr(), B, D, F,
                 int(bool(residual)), region, smem, float(eps),
                 _build.DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("decode_mlp_block launch failed: "
                           + fn.error_string(err).decode())
    return out


decode_attn_block_cuda.launches = 0
decode_mlp_block_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch metas and predicates
# ---------------------------------------------------------------------------
def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def decode_meta_dims(B, D, H, KV, hd, F, BS, MB, dtype, pool_dtype, quant,
                     weight_dtype=None, device="cuda") -> dict:
    """Static dispatch metadata from raw dims: the one builder of
    everything the ``supports`` predicates read. ``device`` (a device
    type) takes the place of the JAX package's ``interpret``, and the
    card's shared-memory limit the place of its two VMEM budgets."""
    return {
        "B": int(B), "D": int(D), "H": int(H), "KV": int(KV),
        "hd": int(hd), "F": int(F), "BS": int(BS), "MB": int(MB),
        "dtype": _dtype_name(dtype),
        "itemsize": torch.empty((), dtype=dtype).element_size(),
        "pool_dtype": _dtype_name(pool_dtype), "quant": bool(quant),
        "weight_dtype": str(weight_dtype) if weight_dtype
        else _dtype_name(dtype),
        "device": torch.device(device).type,
        "smem_limit": SMEM_LIMIT,
    }


def decode_meta(cfg, B, BS, MB, pool_dtype, quant, weight_dtype=None,
                device="cuda") -> dict:
    """Static dispatch metadata for one decode step of model ``cfg``."""
    return decode_meta_dims(B, cfg.hidden_size, cfg.num_attention_heads,
                            cfg.num_key_value_heads, cfg.head_dim,
                            cfg.intermediate_size, BS, MB, cfg.dtype,
                            pool_dtype, quant, weight_dtype=weight_dtype,
                            device=device)


def _refusal(meta):
    """The reason both kernels refuse ``meta``, or None."""
    if meta["device"] != "cuda":
        return "plain composition on the CPU"
    if meta["quant"] or meta["weight_dtype"] in ("int8", "int4"):
        return _NOT_PORTED_QUANT
    if meta["dtype"] not in ("float32", "bfloat16"):
        return f"dtype {meta['dtype']} is not float32/bfloat16"
    if meta["pool_dtype"] != meta["dtype"]:
        return (f"pool dtype {meta['pool_dtype']} differs from the model "
                f"dtype {meta['dtype']}")
    if (meta["D"] * meta["itemsize"]) % 16:
        return f"hidden {meta['D']} rows not a multiple of 16 bytes"
    return None


def _smem_reason(need, limit):
    if need > limit:
        return False, (f"needs {need} B of shared memory a block > the "
                       f"card's {limit}")
    return True, f"fits shared memory ({need} of {limit} B)"


def _attn_refusal(meta):
    """The reason an attention kernel (decode or prefill) refuses the
    shapes of ``meta`` before its shared memory is counted, or None."""
    why = _refusal(meta)
    if why:
        return why
    if meta["H"] % meta["KV"]:
        return "H not a multiple of KV"
    if (meta["hd"] * meta["itemsize"]) % 16:
        return f"head_dim {meta['hd']} rows not a multiple of 16 bytes"
    return None


def _supports_attn(meta):
    why = _attn_refusal(meta)
    if why:
        return False, why
    return _smem_reason(attn_smem_bytes(meta["D"], meta["H"], meta["KV"],
                                        meta["hd"], meta["BS"],
                                        meta["itemsize"]),
                        meta["smem_limit"])


def _supports_mlp(meta):
    why = _refusal(meta)
    if why:
        return False, why
    if (meta["F"] * meta["itemsize"]) % 16:
        return False, f"intermediate {meta['F']} rows not a multiple of 16 " \
                      "bytes"
    return _smem_reason(mlp_smem_bytes(meta["D"], meta["itemsize"]),
                        meta["smem_limit"])


def _supports_composition(meta):
    if meta["device"] == "cuda":
        return False, ("the composition is the CPU's route: on CUDA the "
                       "hand-written kernel must take the shapes")
    return True, "plain composition on the CPU"


KERNELS.register("decode_attn_block", "cuda_fused", decode_attn_block_cuda,
                 priority=10, supports=_supports_attn)
KERNELS.register("decode_attn_block", "unfused", attn_block_ref, priority=0,
                 supports=_supports_composition)
KERNELS.register("decode_mlp_block", "cuda_fused", decode_mlp_block_cuda,
                 priority=10, supports=_supports_mlp)
KERNELS.register("decode_mlp_block", "unfused", mlp_block_ref, priority=0,
                 supports=_supports_composition)


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
    variants)``. The single-launch ``decode_block_fused`` kernel is not
    ported, so ``block_fn`` is always None, mode "block" raises, and
    ``variants`` is ``{"block": "composed", "attn": ..., "mlp": ...}``."""
    if mode == "block":
        raise NotImplementedError(
            "fused_decode='block': the single-launch decode_block_fused "
            "kernel is not ported yet (ROADMAP B5)")
    a_fn, m_fn, names = resolve_decode_blocks(meta, mode)
    return None, a_fn, m_fn, {"block": "composed", **names}
