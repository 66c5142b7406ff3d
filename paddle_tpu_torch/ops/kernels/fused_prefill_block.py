"""Fused prefill-block kernels: the prefill attention kernel's wrapper, the
plain versions, the dispatch metas and predicates, and the resolvers (port
of ``paddle_tpu/ops/pallas/fused_prefill_block.py``: fp, int8 and int4
weights; fp and int8 pools).

- ``prefill_attn_block`` (:func:`prefill_attn_block_cuda`) replaces
  ``fused_prefill_attn_pallas``: over one chunk of one request, RMSNorm +
  QKV + RoPE + causal attention over the request's paged history and the
  chunk's own K/V + o_proj + residual, in one launch. Its source is
  ``paddle_tpu_torch/csrc/fused_prefill_block.cu`` (CUDA C++ for
  ``sm_90a``, built by :mod:`._build` at the first launch and bound with
  ctypes); that file's header says what bounds it on the H100 and how its
  design follows from it.
- ``prefill_mlp_block`` is the decode MLP kernel (``decode_mlp_block``,
  :func:`.fused_decode_block.decode_mlp_block_cuda`) over the chunk's P
  rows, registered again under the prefill op name, as the JAX package
  registers its Pallas kernel. Its shared memory does not depend on the
  row count, so its predicate is the decode one.

:func:`prefill_attn_block_ref` and :func:`prefill_mlp_block_ref` are the
registry's priority-0 ``"unfused"`` variants: op for op the JAX package's
dense composition (gather the request's pages into a dense view,
``cached_forward``'s layer math with quantized leaves dequantized before
each product, the chunk's K/V written into the view before attending).
:func:`prefill_attn_block_wq_ref` is the kernel's plain version in its
epilogue order for quantized weights (``dot(h, q) * s``, then the cast),
as :func:`.fused_decode_block.attn_block_wq_ref` is for decode.

Over int8 pools (``kv_scales``) the two differ by more than roundoff in
bf16, each true to its JAX counterpart: the JAX composition dequantizes
the history and casts it to the model type before attending, while the
JAX kernel (and this port's) keeps the dequantized history in f32. In
both the chunk's own K/V stay at the model type; only the caller's pool
write quantizes them. As for decode, the composition
is the CPU's route only: on CUDA a predicate that refuses the kernel makes
dispatch raise with its reason. The serving engine runs the fused chunk
only when BOTH ops resolve to the kernels (:func:`prefill_fused_selected`)
and the verbatim unfused chunk otherwise, as the JAX engine does.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build, _launch
from . import fused_decode_block as _fdb
from ._build import DTYPES
from .registry import KERNELS

__all__ = ["prefill_attn_block_ref", "prefill_attn_block_wq_ref",
           "prefill_mlp_block_ref",
           "prefill_attn_block_cuda", "prefill_meta", "prefill_meta_dims",
           "prefill_attn_smem_bytes", "resolve_prefill_blocks",
           "prefill_fused_selected"]

#: query rows of one attention work item; the chunk width P must be a
#: multiple of it (both serving buckets, 32 and 128, are)
BQ = 16


# ---------------------------------------------------------------------------
# plain versions: the dense composition, op for op
# ---------------------------------------------------------------------------
def _prefill_attn(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool, table,
                  pos0, kv_scales, eps, residual, mm, omm, hist_dtype):
    """The dense chunk's attention half with the q/k/v products of ``mm``
    and the o_proj of ``omm`` (both landing in x's type). Over int8 pools
    (``kv_scales``) the gathered history is dequantized in f32 and held
    in ``hist_dtype`` (x's type in the JAX composition, f32 in the
    kernel); the chunk's K/V go into that view at x's type."""
    from .. import rms_norm
    from ..rope import apply_rope
    P, D = x.shape
    _, BS, KV, hd = k_pool.shape
    T = table.shape[0] * BS
    H = _fdb._wq_parts(wq)[0].shape[1] // hd
    if pos0 + P > T:
        raise ValueError(f"chunk rows {pos0}..{pos0 + P - 1} do not fit the "
                         f"table's {T} positions")
    kc = k_pool[table.long()].reshape(T, KV, hd)
    vc = v_pool[table.long()].reshape(T, KV, hd)
    if kv_scales is not None:
        ks, vs = kv_scales
        kc = (kc.float() * ks[None, :, None]).to(hist_dtype)
        vc = (vc.float() * vs[None, :, None]).to(hist_dtype)
    h = rms_norm(x[None], nw, eps)[0]
    q = apply_rope(mm(h, wq).reshape(1, P, H, hd), sin, cos)
    k = apply_rope(mm(h, wk).reshape(1, P, KV, hd), sin, cos)
    v = mm(h, wv).reshape(1, P, KV, hd)
    k_new, v_new = k[0], v[0]
    kc[pos0:pos0 + P] = k_new.to(kc.dtype)
    vc[pos0:pos0 + P] = v_new.to(vc.dtype)
    rep = H // KV
    kk = kc.repeat_interleave(rep, dim=1).float()
    vv = vc.repeat_interleave(rep, dim=1).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("phd,thd->hpt", q[0].float(), kk) * scale
    t_idx = torch.arange(T, device=x.device)[None, None, :]
    q_idx = pos0 + torch.arange(P, device=x.device)[None, :, None]
    scores = scores.masked_fill(t_idx > q_idx, float("-inf"))
    attn = torch.einsum("hpt,thd->phd", torch.softmax(scores, dim=-1), vv)
    o = omm(attn.to(x.dtype).reshape(P, H * hd), wo)
    return (x + o if residual else o), k_new, v_new


def prefill_attn_block_ref(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                           table, pos0, n_valid, kv_scales=None, eps=1e-6,
                           residual=True):
    """The attention half of a prefill-chunk layer as the dense chunk runs
    it.

    x [P, D] (the first ``n_valid`` rows are the prompt); nw [D] at x's
    type; wq [D, H*hd], wk/wv [D, KV*hd], wo [H*hd, D] (tensors or
    quantized leaves, dequantized to x's type before their product);
    sin/cos: the chunk's rope rows [P, hd/2] f32, row i for position
    pos0 + i; pools [N, BS, KV, hd]; table [MB]: the request's READ table;
    pos0: tokens of the request already in the pools; ``kv_scales``:
    (k_scale, v_scale) [KV] f32 for int8 pools, whose gathered history is
    dequantized and cast to x's type (the JAX composition). Gathers the
    request's pages into a dense [MB*BS] view, writes the chunk's K/V into
    it at pos0 and runs causal attention over it. Returns (x + o [P, D],
    or o alone when ``residual`` is False; k_new, v_new [P, KV, hd]). Pays
    full pad work: ``n_valid`` rides only for signature parity."""
    return _prefill_attn(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                         table, pos0, kv_scales, eps, residual, _fdb._deq_mm,
                         _fdb._deq_mm, x.dtype)


def prefill_attn_block_wq_ref(x, nw, wq, wk, wv, wo, sin, cos, k_pool,
                              v_pool, table, pos0, n_valid, kv_scales=None,
                              eps=1e-6, residual=True):
    """:func:`prefill_attn_block_ref`'s contract in prefill_attn_block's
    epilogue order (the JAX ``_prefill_attn_kernel``'s): each product
    ``dot(h, q) * s`` in f32, then cast to x's type (q/k/v before RoPE,
    o before the residual add). Over int8 pools the history is
    dequantized to f32 and stays f32 (the JAX kernel's order); the chunk's
    own K/V stay at x's type. The kernel's plain version for quantized
    weights and int8 pools."""
    return _prefill_attn(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                         table, pos0, kv_scales, eps, residual, _fdb._epi_mm,
                         lambda a, w: _fdb._f32mm(a, w).to(x.dtype),
                         torch.float32)


def prefill_mlp_block_ref(x, nw, wg, wu, wd, eps=1e-6, residual=True):
    """The MLP half over the chunk's rows: the decode MLP composition
    (row count is the only difference; quantized leaves dequantized)."""
    return _fdb.mlp_block_ref(x, nw, wg, wu, wd, eps=eps, residual=residual)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
_SOURCE = "paddle_tpu_torch/csrc/fused_prefill_block.cu"
#: the launcher's ctypes argument codes
CALL = ("prefill_attn_block", _build.c_codes(24, 24, 2))
#: head dim of the tensor-core attention (the source's kHd)
TC_HEAD_DIM = 128
#: the tensor-core body's column tiles of q/k/v and of o_proj (the
#: source's kQkvCols, kOCols)
QKV_COLS, O_COLS = 64, 64


def _grid_query(body):
    def query(dtype, bits, kv_bits, smem):
        fn = _build.c_fn("fused_prefill_block", "prefill_coop_grid",
                         ("i",) * 5)
        return fn(dtype, bits, kv_bits, body, smem)
    return query


def prefill_tc_smem(bits, kv_bits):
    """Shared memory of the tensor-core body (the source's
    ``prefill_tc_smem``): the larger of its product layout (one weight a
    tile, :func:`.fused_decode_block.tile_smem_bytes`) and its attention's:
    the item's Q and two stages of 128 keys' K and V, bf16 [.][136] (a
    history step over int8 pools stages its codes in the same place), and
    over int8 pools each warp's 16 keys' K and V converted to bf16
    [8][2][16][136]."""
    prod = max(_fdb.tile_smem_bytes(_fdb.wclass(bits), 1, c)
               for c in (QKV_COLS, O_COLS))
    step = _fdb._WARPS * 16
    attn = (BQ + 2 * 2 * step + (2 * step if kv_bits else 0)) \
        * (TC_HEAD_DIM + 8) * 2
    return max(prod, attn)


def prefill_body(P, D, H, KV, hd, BS, dt, bits, kv_bits):
    """(body, reason): which body of prefill_attn_block a launch runs, the
    rule its plan records: "tc" (the tensor cores) for bf16 with head dim
    128, D a multiple of 32 and the body's shared memory within the card's
    limit; "cuda_core" otherwise (every f32 launch)."""
    if dt != "bfloat16":
        return "cuda_core", f"{dt}: the tensor-core body is bf16 only"
    if hd != TC_HEAD_DIM:
        return "cuda_core", (f"head dim {hd}: the tensor-core attention "
                             f"takes {TC_HEAD_DIM}")
    if D % 32:
        return "cuda_core", f"D {D} not a multiple of 32 (the tile copies)"
    need = prefill_tc_smem(bits, kv_bits)
    if need > _fdb.SMEM_LIMIT:
        return "cuda_core", (f"the tensor-core body needs {need} B of "
                             "shared memory a block")
    return "tc", "bf16, head dim 128" + (", int8 pools: the history's codes "
                                         "on the tensor cores"
                                         if kv_bits else "")


def prefill_tc_plan(P, D, H, KV, hd, bits, grid):
    """The tensor-core body's plan: row tiles of 128 rows, column tiles of
    wq (q_tiles), wk and wv (kv_tiles each; ``qkv_cols`` columns) and wo
    (o_tiles of ``o_cols``, over H*hd in ``o_parts`` parts:
    :func:`.fused_decode_block.tc_parts` on ``grid``), 128 k a stage in 3
    stages; attention items (16-row query block, query head), 128 keys a
    step."""
    rt, ot = -(-P // _fdb.TC_TILE_ROWS), -(-D // O_COLS)
    nq = H * hd
    chunks = -(-(nq // 2 if bits == 4 else nq)
               // (_fdb.TC_CHUNK_K // 2 if bits == 4 else _fdb.TC_CHUNK_K))
    return {"body": "tc", "row_tiles": rt, "rows_tile": _fdb.TC_TILE_ROWS,
            "qkv_cols": QKV_COLS, "o_cols": O_COLS, "qkv_lpr": 0,
            "q_tiles": -(-nq // QKV_COLS),
            "kv_tiles": -(-KV * hd // QKV_COLS), "o_lpr": 0,
            "o_tiles": ot, "o_parts": _fdb.tc_parts(rt * ot, grid, chunks),
            "k_chunk": _fdb.TC_CHUNK_K, "stages": _fdb.TC_STAGES,
            "key_step": _fdb._WARPS * 16}


@functools.lru_cache(maxsize=512)
def prefill_spec(P, D, H, KV, hd, BS, MB, N, dt, bits, kv_bits, residual,
                 pos0, n_valid, grid, smem, body="cuda_core"):
    """The launch spec of prefill_attn_block: the q/k/v products of the
    real rows by column tiles, the RoPE pass that writes k_new and v_new
    whole, the attention items (query block, KV head) over the paged
    history of ``pos0`` tokens, and o_proj by column tiles into x_out. The
    tensor-core body (``body`` "tc") normalises the real rows first, tiles
    32 columns by rows of 128, and takes (query block, query head)
    attention items."""
    nq, nkv = H * hd, KV * hd
    vec = 16 // _fdb._ITEM[dt]
    tc = body == "tc"
    if tc:
        plan = prefill_tc_plan(P, D, H, KV, hd, bits, grid)
    else:
        plan = _fdb.attn_plan(nq, nkv, D, vec, grid)
        plan["body"] = "cuda_core"
    plan["body_rule"] = prefill_body(P, D, H, KV, hd, BS, dt, bits,
                                     kv_bits)[1]
    op = _fdb._op
    pool_dt = "int8" if kv_bits else dt
    ins = [op("x", (P, D), dt), op("nw", (D,), dt)]
    for name, (k, n) in (("wq", (D, nq)), ("wk", (D, nkv)), ("wv", (D, nkv)),
                         ("wo", (nq, D))):
        shape, wdt = _fdb._stored(k, n, bits)
        ins.append(op(name, shape, wdt or dt))
    if bits:
        ins += [op("sq", (nq,), "float32"), op("sk", (nkv,), "float32"),
                op("sv", (nkv,), "float32"), op("so", (D,), "float32")]
    ins += [op("sin", (P, hd // 2), "float32"),
            op("cos", (P, hd // 2), "float32"),
            op("k_pool", (N, BS, KV, hd), pool_dt, "tokens"),
            op("v_pool", (N, BS, KV, hd), pool_dt, "tokens")]
    if kv_bits:
        ins += [op("k_scale", (KV,), "float32"),
                op("v_scale", (KV,), "float32")]
    ins.append(op("table", (MB,), "int32", "pages"))
    outs = [op("x_out", (P, D), dt), op("k_new", (P, KV, hd), dt),
            op("v_new", (P, KV, hd), dt)]
    kn = D // 2 if bits == 4 else D
    kn_o = nq // 2 if bits == 4 else nq
    tw = plan["qkv_cols"] if tc else plan["qkv_lpr"] * vec
    tq, tk = plan["q_tiles"], plan["kv_tiles"]
    otc = plan["o_cols"] if tc else plan["o_lpr"] * vec
    A, whole = _launch.Access, _launch.whole
    qkv_reads = [] if tc else [whole(ins[0]), whole(ins[1])]
    qkv_reads += [A("wq", (kn, tw), _fdb._col, 0, tq),
                  A("wk", (kn, tw), _fdb._col, tq, tk),
                  A("wv", (kn, tw), _fdb._col, tq + tk, tk)]
    if bits:
        qkv_reads += [A("sq", (tw,), _fdb._vec, 0, tq),
                      A("sk", (tw,), _fdb._vec, tq, tk),
                      A("sv", (tw,), _fdb._vec, tq + tk, tk)]
    names = [o.name for o in ins]
    rope_reads = (whole(ins[names.index("sin")]),
                  whole(ins[names.index("cos")]))
    attn_reads = ()
    if kv_bits:
        attn_reads = (whole(ins[names.index("k_scale")]),
                      whole(ins[names.index("v_scale")]))
    parts = plan.get("o_parts", 1)
    if parts == 1:
        o_reads = [A("wo", (kn_o, otc), _fdb._col)]
    else:
        # items (row tile, part of H*hd, column tile), the column fastest
        ot = plan["o_tiles"]
        o_reads = [A("wo", (_fdb.part_rows(H * hd, parts, bits == 4), otc),
                     lambda i: ((i // ot) % parts, i % ot))]
    if bits:
        o_reads.append(A("so", (otc,), lambda i: (i % plan["o_tiles"],)))
    # attention items: (query block, KV head), or on the tensor cores
    # (query block, query head)
    items = -(-n_valid // BQ) * (H if tc else KV)
    phases = (
        _launch.KernelPhase("qkv", tq + 2 * tk, tuple(qkv_reads)),
        _launch.KernelPhase("rope", 1, rope_reads,
                            (whole(outs[1]), whole(outs[2]))),
        _launch.KernelPhase("attention", items, attn_reads))
    if parts == 1:
        phases += (_launch.KernelPhase(
            "o_proj", plan["o_tiles"], tuple(o_reads),
            (A("x_out", (P, otc), _fdb._col),)),)
    else:
        # the parts' f32 sums, then the combine writes x_out (with the
        # RoPE phase's zeros in the pad rows)
        phases += (_launch.KernelPhase("o_proj", parts * plan["o_tiles"],
                                       tuple(o_reads)),
                   _launch.KernelPhase("combine", 1, (), (whole(outs[0]),)))
    if tc:
        # the real rows normalised once, before the products (x whole, as
        # the CUDA-core body's q/k/v phase reads it: a pad row is read by
        # neither); the row tiles' items repeat the column tiles (the first
        # row tile's shown)
        phases = (_launch.KernelPhase("norm", n_valid,
                                      (whole(ins[0]), whole(ins[1]))),
                  ) + phases
    return _launch.KernelLaunchSpec(
        "prefill_attn_block", "cuda", _SOURCE, (grid,), _fdb._THREADS,
        tuple(ins), tuple(outs), phases, (CALL,), dt,
        blocks_per_sm=_fdb.BOUNDS["prefill_attn_block_tc" if tc
                                  else "prefill_attn_block"],
        cooperative=True, dyn_smem=smem,
        params={"residual": bool(residual), "wbits": bits,
                "kvbits": kv_bits, "pos0": pos0, "n_valid": n_valid,
                "live": (pos0,)}, plan=plan)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------
def prefill_attn_smem_bytes(D, H, KV, hd, BS, itemsize,
                            pool_itemsize=None) -> int:
    """Dynamic shared memory of one prefill_attn_block block: 8 normalised
    rows of width D, or the attention scratch of one work item of
    (H/KV) * BQ query rows, whichever is larger, plus the products'
    reduction tiles (``fused_decode_block._layout``). The staged tiles
    hold history pages in the pool's type and the chunk's own K/V in x's
    type, one after the other, so they take the wider of the two."""
    return _fdb._layout(D, H // KV * BQ, hd, BS, itemsize,
                        max(itemsize, pool_itemsize or itemsize))[1]


def prefill_attn_block_cuda(x, nw, wq, wk, wv, wo, sin, cos, k_pool, v_pool,
                            table, pos0, n_valid, kv_scales=None, eps=1e-6,
                            residual=True):
    """Launch the prefill_attn_block kernel (the contract of
    :func:`prefill_attn_block_wq_ref`, except that rows at or after
    ``n_valid`` come back as zeros) on PyTorch's current stream. Weights
    are tensors of x's type or quantized leaves (int8, or int4 packed
    along the contraction axis); pools of x's type, or int8 with
    ``kv_scales``. ``pos0`` and ``n_valid`` are host ints. Raises for
    anything the kernel does not take, and if the launch is refused.
    Never falls back."""
    name = "prefill_attn_block_cuda"
    pool_dt, kv_bits, ks, vs = _fdb._pools(name, x, k_pool, kv_scales)
    _fdb._check_common(name, x, {
        "x": x, "nw": nw, "sin": sin, "cos": cos, "k_pool": k_pool,
        "v_pool": v_pool, "table": table},
        {"sin": torch.float32, "cos": torch.float32, "k_pool": pool_dt,
         "v_pool": pool_dt, "table": torch.int32})
    P, D = x.shape
    N, BS, KV, hd = k_pool.shape
    H, leaves = _fdb._attn_leaves(x, wq, wk, wv, wo, KV, hd)
    MB = table.shape[0] if table.dim() == 1 else 0
    item = x.element_size()
    if H < 1 or H % KV:
        raise ValueError(f"{name}: H={H} is not a positive multiple of "
                         f"KV={KV}")
    if (hd * item) % 16 or (D * item) % 16 or hd % 16 and kv_bits:
        raise ValueError(f"{name}: head_dim {hd} and hidden {D} rows must "
                         "be multiples of 16 bytes (the load width), in "
                         "x's type and in the pools'")
    if P % BQ:
        raise ValueError(f"{name}: chunk width P={P} is not a multiple of "
                         f"the kernel's {BQ}-row query blocks")
    bits, w, sc = _fdb._weights(name, x, leaves)
    for tname, t, shp in (("nw", nw, (D,)),
                          ("v_pool", v_pool, k_pool.shape),
                          ("sin", sin, (P, hd // 2)),
                          ("cos", cos, (P, hd // 2)), ("table", table, (MB,))):
        _fdb._shape(name, tname, t, shp)
    pos0, n_valid = int(pos0), int(n_valid)
    if not 1 <= n_valid <= P:
        raise ValueError(f"{name}: n_valid={n_valid} outside 1..P={P}")
    if pos0 < 0 or -(-pos0 // BS) > MB:
        raise ValueError(f"{name}: pos0={pos0} needs more than the table's "
                         f"{MB} pages of history")
    dt = _launch.dtype_name(x.dtype)
    body = prefill_body(P, D, H, KV, hd, BS, dt, bits, kv_bits)[0]
    if body == "tc":
        region, smem = 0, prefill_tc_smem(bits, kv_bits)
    else:
        region, smem = _fdb._layout(D, H // KV * BQ, hd, BS, item)
    if smem > _fdb.SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory a block,"
                         f" over the card's {_fdb.SMEM_LIMIT}")
    kernel = "prefill_attn_block_tc" if body == "tc" else "prefill_attn_block"
    grid = _fdb.coop_grid(kernel, x.device, x.dtype, bits, kv_bits, smem,
                          query=_grid_query(int(body == "tc")))
    spec = prefill_spec(P, D, H, KV, hd, BS, MB, N, dt, bits, kv_bits,
                        bool(residual), pos0, n_valid, grid, smem, body)
    x_out = torch.empty_like(x)
    k_new = torch.empty((P, KV, hd), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    # the kernel's workspaces (csrc/fused_prefill_block.cu): the q/k/v
    # projections, the roped q rows, the attention rows (k-major by pass;
    # row-major [P][H*hd] in the tensor-core body, the same size since P
    # is a multiple of 16) and the tensor-core body's normalised rows
    qkv_ws = torch.empty((P, (H + 2 * KV) * hd), dtype=x.dtype,
                         device=x.device)
    q_ws = torch.empty((P, H * hd), dtype=x.dtype, device=x.device)
    attn_ws = torch.empty((_fdb._passes(P) * _fdb._ROWS, H * hd),
                          dtype=x.dtype, device=x.device)
    # the normalised rows [P][D] and o_proj's f32 partial sums
    # [parts][P][D], 16-byte aligned (in x's elements)
    parts = spec.plan.get("o_parts", 1)
    h_ws = (torch.empty(-(-P * D // 8) * 8 + (2 * parts * P * D
                                              if parts > 1 else 0),
                        dtype=x.dtype, device=x.device)
            if body == "tc" else None)
    order = ("wq", "wk", "wv", "wo")
    if not _launch.begin(spec, x.device):
        return x_out, k_new, v_new
    fn = _build.c_fn("fused_prefill_block", *spec.calls[0])
    pl = spec.plan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _fdb._count(prefill_attn_block_cuda, bits, body, kv_bits, residual)
        err = fn(x.data_ptr(), nw.data_ptr(),
                 *(w[k].data_ptr() for k in order),
                 *(_fdb._ptr(sc[k]) for k in order), sin.data_ptr(),
                 cos.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _fdb._ptr(ks), _fdb._ptr(vs), table.data_ptr(),
                 x_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 qkv_ws.data_ptr(), q_ws.data_ptr(), attn_ws.data_ptr(),
                 _fdb._ptr(h_ws), P, D, H, KV, hd, BS, MB, pos0, n_valid, BQ,
                 int(bool(residual)), region, smem, bits, kv_bits, grid,
                 int(body == "tc"), pl.get("row_tiles", 0),
                 pl.get("o_parts", 1), pl["qkv_lpr"],
                 pl["q_tiles"], pl["kv_tiles"], pl["o_lpr"], pl["o_tiles"],
                 float(eps), 1.0 / math.sqrt(hd), DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("prefill_attn_block launch failed: "
                           + fn.error_string(err).decode())
    return x_out, k_new, v_new


# the launches by weight, pool and residual class, and by body: "tc" (the
# tensor cores, bf16) or "cuda_core"
_launch.counted(prefill_attn_block_cuda, weight=_fdb._WEIGHTS,
                pool=_fdb._POOLS, residual=_fdb._RESIDUAL,
                body=("tc", "cuda_core"))


# ---------------------------------------------------------------------------
# dispatch metas and predicates
# ---------------------------------------------------------------------------
def prefill_meta_dims(P, D, H, KV, hd, F, BS, MB, dtype, pool_dtype, quant,
                      weight_dtype=None, device="cuda") -> dict:
    """Static dispatch metadata of one prefill chunk: the keys of
    :func:`.fused_decode_block.decode_meta_dims` with the chunk width
    ``P`` (bucket rows) in place of ``B``."""
    meta = _fdb.decode_meta_dims(P, D, H, KV, hd, F, BS, MB, dtype,
                                 pool_dtype, quant, weight_dtype=weight_dtype,
                                 device=device)
    meta["P"] = meta.pop("B")
    return meta


def prefill_meta(cfg, P, BS, MB, pool_dtype, quant, weight_dtype=None,
                 device="cuda") -> dict:
    """Static dispatch metadata of one prefill chunk of model ``cfg``."""
    return prefill_meta_dims(P, cfg.hidden_size, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.head_dim,
                             cfg.intermediate_size, BS, MB, cfg.dtype,
                             pool_dtype, quant, weight_dtype=weight_dtype,
                             device=device)


def _supports_prefill_attn(meta):
    why = _fdb._attn_refusal(meta)
    if why:
        return False, why
    if meta["P"] % BQ:
        return False, (f"chunk width P={meta['P']} not a multiple of the "
                       f"kernel's {BQ}-row query blocks")
    return _fdb._smem_reason(
        prefill_attn_smem_bytes(meta["D"], meta["H"], meta["KV"], meta["hd"],
                                meta["BS"], meta["itemsize"],
                                meta["pool_itemsize"]),
        meta["smem_limit"], meta)


KERNELS.register("prefill_attn_block", "cuda_fused", prefill_attn_block_cuda,
                 priority=10, supports=_supports_prefill_attn)
KERNELS.register("prefill_attn_block", "unfused", prefill_attn_block_ref,
                 priority=0, supports=_fdb._supports_composition)
KERNELS.register("prefill_mlp_block", "cuda_fused",
                 _fdb.decode_mlp_block_cuda, priority=10,
                 supports=_fdb._supports_mlp)
KERNELS.register("prefill_mlp_block", "unfused", prefill_mlp_block_ref,
                 priority=0, supports=_fdb._supports_composition)
# every prefill_meta_dims key is fixed when a serving engine is built or
# is the bucket's width P, the key a per-bucket chunk program takes (the
# JAX engine's; the port's chunks run eagerly, dispatching per call): the
# DISPATCH_KEY_GAP lint holds the predicates to this declaration
PREFILL_KEY_FIELDS = ("P",) + tuple(k for k in _fdb.DECODE_KEY_FIELDS
                                    if k not in ("B", "tp"))
for _name in ("prefill_attn_block", "prefill_mlp_block"):
    KERNELS.declare_cache_key(_name, PREFILL_KEY_FIELDS,
                              covers=_fdb.DECODE_KEY_COVERS)


def resolve_prefill_blocks(meta: dict, mode="auto"):
    """The two prefill-chunk ops of one bucket. ``mode``: "auto"/True/None
    dispatches through the registry (the CUDA kernels on CUDA, raising
    with the predicate's reason if one refuses; the composition on the
    CPU); "pallas" forces the hand-written kernels (the JAX engine's name
    for the same knob); "ref" forces the composition. Returns (attn_fn,
    mlp_fn, {"attn": name, "mlp": name})."""
    if mode in ("auto", True, None):
        a_name, a_fn = KERNELS.dispatch("prefill_attn_block", meta)
        m_name, m_fn = KERNELS.dispatch("prefill_mlp_block", meta)
    elif mode in ("pallas", "ref"):
        a_name = m_name = "cuda_fused" if mode == "pallas" else "unfused"
        a_fn = KERNELS.variant("prefill_attn_block", a_name).fn
        m_fn = KERNELS.variant("prefill_mlp_block", m_name).fn
    else:
        raise ValueError(f"fused_prefill mode must be auto|pallas|ref, got "
                         f"{mode!r}")
    return a_fn, m_fn, {"attn": a_name, "mlp": m_name}


def prefill_fused_selected(meta: dict, mode) -> bool:
    """Whether a bucket runs the fused, pool-direct chunk: ALL-OR-NOTHING,
    both ops must resolve to the CUDA kernels; otherwise the engine runs
    the verbatim unfused chunk."""
    if not mode or mode == "ref":
        return False
    _, _, names = resolve_prefill_blocks(meta, mode)
    return names["attn"] == names["mlp"] == "cuda_fused"
